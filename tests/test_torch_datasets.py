"""nshmc_tpu_torch's dataset readers and pure-python LMDB parser against the
JAX package's, on files written to tmp_path: the LMDB environments of
tests/test_lmdb_reader.py (one leaf, a two-level tree, an overflow value, a
stale meta page, a bad magic) and image folders, npy stacks, an ImageNet
meta list and an LSUN lmdb of webp images; both packages' readers must give
equal arrays and the same order."""
import io
import struct

import numpy as np
import pytest
from PIL import Image

from nshmc_tpu.utils import datasets as jds
from nshmc_tpu.utils import lmdb_reader as jlr
from nshmc_tpu_torch.utils import datasets as tds
from nshmc_tpu_torch.utils import lmdb_reader as tlr
from test_lmdb_reader import (P_BRANCH, P_INVALID, P_LEAF, P_OVERFLOW, PAGE_HDR, PSIZE,
                              _branch_node, _leaf_node, _meta_page, _node_page, _write_env)


def _single_leaf(tmp_path):
    kv = {b"a": b"alpha", b"bb": b"beta" * 10, b"ccc": b""}
    leaf = _node_page(2, P_LEAF, [_leaf_node(k, v) for k, v in sorted(kv.items())])
    return _write_env(tmp_path, [leaf], root=2, entries=len(kv), depth=1), kv


def _two_level(tmp_path):
    kv = {f"k{i:02d}".encode(): f"v{i}".encode() * 3 for i in range(9)}
    items = sorted(kv.items())
    left = _node_page(3, P_LEAF, [_leaf_node(k, v) for k, v in items[:5]])
    right = _node_page(4, P_LEAF, [_leaf_node(k, v) for k, v in items[5:]])
    branch = _node_page(2, P_BRANCH, [_branch_node(b"", 3), _branch_node(b"k05", 4)])
    return _write_env(tmp_path, [branch, left, right], root=2, entries=9, depth=2), kv


def _overflow(tmp_path):
    big = bytes(range(256)) * 40  # 10240 B -> 3 overflow pages
    n_ov = -(-(len(big) + PAGE_HDR.size) // PSIZE)
    leaf = _node_page(2, P_LEAF, [_leaf_node(b"big", len(big), bigdata_pgno=3),
                                  _leaf_node(b"small", b"x")])
    ov = struct.pack("<QHH", 3, 0, P_OVERFLOW) + struct.pack("<I", n_ov) + big
    ov += b"\0" * (n_ov * PSIZE - len(ov))
    pages = [leaf] + [ov[i * PSIZE:(i + 1) * PSIZE] for i in range(n_ov)]
    return _write_env(tmp_path, pages, root=2, entries=2, depth=1), {b"big": big, b"small": b"x"}


def _stale_meta(tmp_path):
    d = tmp_path / "stale"
    d.mkdir()
    with open(d / "data.mdb", "wb") as f:
        f.write(_meta_page(0, P_INVALID, 0, 0, txnid=0, last_pg=1)
                + _meta_page(1, 2, 1, 1, txnid=5, last_pg=3)
                + _node_page(2, P_LEAF, [_leaf_node(b"k", b"new")]))
    return str(d), {b"k": b"new"}


@pytest.mark.parametrize("make", [_single_leaf, _two_level, _overflow, _stale_meta],
                         ids=["single_leaf", "two_level", "overflow", "stale_meta"])
def test_lmdb_reader_matches_jax(tmp_path, make):
    env, kv = make(tmp_path)
    with tlr.LMDBReader(env) as r, jlr.LMDBReader(env) as j:
        items = list(r.items())
        assert items == list(j.items())
        assert dict(items) == kv and [k for k, _ in items] == sorted(kv)
        assert len(r) == len(j) == len(kv) and r.keys() == j.keys()
        for k, v in kv.items():
            assert r.get(k) == v
        assert r.get(b"absent") is None


def test_lmdb_bad_magic_raises(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    (d / "data.mdb").write_bytes(b"\0" * 8192)
    with pytest.raises(tlr.LMDBError):
        tlr.LMDBReader(str(d))


def _png(path, seed, size):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(path)


def _equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["ffhq", "imagefolder", "celeba_hq", "celeba", "imagenet"])
def test_folder_datasets_match_jax(tmp_path, name):
    root = tmp_path / "imgs"
    (root / "sub").mkdir(parents=True)
    for i in range(3):  # CelebA's 218 x 178 frame, so its crop window fits
        _png(root / ("sub" if i == 1 else "") / f"{i}.png", i, (218, 178))
    ds, ref = tds.get_dataset(name, str(root), 32), jds.get_dataset(name, str(root), 32)
    assert isinstance(ds, tds.FolderDataset) and ds.celeba_crop == (name == "celeba")
    _equal(ds, ref)
    assert ds[0].shape == (32, 32, 3) and 0 <= ds[0].min() and ds[0].max() <= 1
    order = [i for i, _ in tds.iterate(ds, 0, 3, shuffle_seed=7)]
    assert order == [i for i, _ in jds.iterate(ref, 0, 3, shuffle_seed=7)]
    assert [i for i, _ in tds.iterate(ds, 1)] == [1, 2]


def test_imagenet_subset_matches_jax(tmp_path):
    for i in range(2):
        _png(tmp_path / f"n{i}.png", i, (40, 64))
    meta = tmp_path / "val.txt"
    meta.write_text("n1.png 7\n\nn0.png 3\n")
    ds = tds.get_dataset("imagenet", str(tmp_path), 16, meta_file=str(meta))
    _equal(ds, jds.get_dataset("imagenet", str(tmp_path), 16, meta_file=str(meta)))
    assert isinstance(ds, tds.ImageNetSubset) and len(ds) == 2


@pytest.mark.parametrize("layout", ["nchw_uint8", "nhwc_float", "single_hwc"])
def test_npy_dataset_matches_jax(tmp_path, layout):
    rng = np.random.default_rng(0)
    arr = {"nchw_uint8": rng.integers(0, 256, (4, 3, 8, 8), dtype=np.uint8),
           "nhwc_float": rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float64),
           "single_hwc": rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)}[layout]
    path = str(tmp_path / "x.npy")
    np.save(path, arr)
    ds = tds.get_dataset("npy", path)
    _equal(ds, jds.get_dataset("npy", path))
    assert ds[0].shape == (8, 8, 3) and ds[0].max() <= 1.0


def test_lsun_dataset_matches_jax(tmp_path):
    nodes = []
    for i in range(3):
        g = (np.arange(24)[:, None] * 8 + np.arange(16)[None] + i * 7) % 256
        buf = io.BytesIO()
        Image.fromarray(np.stack([g, g // 2, 255 - g], -1).astype(np.uint8)).save(
            buf, format="WEBP", lossless=True)
        nodes.append(_leaf_node(f"img{i}".encode(), buf.getvalue()))
    env = _write_env(tmp_path, [_node_page(2, P_LEAF, nodes)], root=2, entries=3, depth=1)
    ds = tds.get_dataset("lsun", env, image_size=16)
    _equal(ds, jds.get_dataset("lsun", env, image_size=16))
    assert ds[0].shape == (16, 16, 3)


def test_unknown_dataset_and_empty_folder_raise(tmp_path):
    with pytest.raises(ValueError):
        tds.get_dataset("cifar", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tds.FolderDataset(str(tmp_path))


def test_prefetch_keeps_order():
    assert list(tds.prefetch(iter(range(10)), depth=3)) == list(range(10))
    assert list(tds.prefetch(iter([]))) == []
