"""nshmc_tpu_torch's checkpoint registry and FLOP counter: the registry
equals the JAX package's key by key and resolves names the same way, but
never downloads (no socket is opened); `compiled_flops` against the
analytic 2 x multiply-adds on the CPU. The sampler's spans are
tests/test_torch_spans.py's."""
import os
import socket

import pytest
import torch

from nshmc_tpu.utils import ckpt_util as jck
from nshmc_tpu_torch.utils import ckpt_util as tck
from nshmc_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the network was touched")

    for name in ("socket", "create_connection", "getaddrinfo"):
        monkeypatch.setattr(socket, name, refuse)


@pytest.mark.parametrize("table", ["URL_MAP", "CKPT_MAP", "MD5_MAP"])
def test_registry_equals_jax(table):
    assert getattr(tck, table) == getattr(jck, table)
    assert list(getattr(tck, table)) == list(getattr(jck, table))


def test_md5_and_paths_as_jax(tmp_path, no_network):
    f = tmp_path / "blob"
    f.write_bytes(b"nshmc" * 1000)
    assert tck.md5_hash(str(f)) == jck.md5_hash(str(f))
    for name in ("cifar10", "celeba_hq"):  # a mapped file name, and name.ckpt
        path = os.path.join(str(tmp_path), tck.CKPT_MAP.get(name, f"{name}.ckpt"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
        assert tck.get_ckpt_path(name, root=str(tmp_path)) == \
            jck.get_ckpt_path(name, root=str(tmp_path)) == path
    for mod in (tck, jck):
        with pytest.raises(KeyError):
            mod.get_ckpt_path("nope")


def test_never_downloads(tmp_path, no_network):
    """An absent file, or one that fails the MD5 check, raises and writes
    nothing; no socket or name lookup happens."""
    with pytest.raises(RuntimeError, match="egress"):
        tck.get_ckpt_path("lsun_cat", root=str(tmp_path / "absent"))
    assert not (tmp_path / "absent").exists()
    path = tmp_path / tck.CKPT_MAP["ema_cifar10"]
    path.parent.mkdir(parents=True)
    path.write_bytes(b"wrong")
    with pytest.raises(RuntimeError, match="place the checkpoint"):
        tck.get_ckpt_path("ema_cifar10", root=str(tmp_path), check=True)
    assert path.read_bytes() == b"wrong"
    with pytest.raises(RuntimeError):
        tck.download(tck.URL_MAP["celeba_hq"], str(tmp_path / "x.ckpt"))


def test_compiled_flops_is_two_per_multiply_add():
    a, b = torch.ones(4, 5), torch.ones(5, 6)
    assert profiling.compiled_flops(lambda p, q: p @ q, a, b) == 2 * 4 * 5 * 6
    x, w = torch.ones(2, 3, 8, 8), torch.ones(7, 3, 3, 3)
    conv = lambda x, w: torch.nn.functional.conv2d(x, w, padding=1)  # noqa: E731
    assert profiling.compiled_flops(conv, x, w) == 2 * (2 * 7 * 8 * 8) * (3 * 3 * 3)
    assert profiling.compiled_flops(lambda p: p + 1, a) == 0


def test_compiled_flops_counts_an_input_gradient():
    """The HMC gradient (torch.autograd.grad with respect to a leaf input of
    a frozen network) runs under the counter, and its backward adds the
    convolution's input-gradient FLOPs, as many as its forward's."""
    conv = torch.nn.Conv2d(3, 4, 3, padding=1).requires_grad_(False)

    def value_and_grad():
        x = torch.ones(2, 3, 8, 8).requires_grad_(True)
        return torch.autograd.grad(conv(x).square().sum(), x)

    fwd = 2 * (2 * 4 * 8 * 8) * (3 * 3 * 3)
    assert profiling.compiled_flops(value_and_grad) == 2 * fwd
