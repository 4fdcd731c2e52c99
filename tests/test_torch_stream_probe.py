"""The port's memory-system probes against the JAX package's: the four
Pallas probe kernels P1-P4 of scripts/pallas_stream_probe.py (interpret
mode) against the plain versions the port's wrappers take on the CPU, the
two probe scripts' CPU paths, and the GroupNorm formulations of
scripts/membench2.py. Inputs from numpy.

The Pallas kernels and their pallas_call wrappers are closures inside the
script's main() and extra_probes(), so they are taken from its source with
ast and executed with the probe's own sizes bound."""
import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nshmc_tpu_torch.ops import groupnorm as gn
from nshmc_tpu_torch.ops import stream_probe as sp
from nshmc_tpu_torch.scripts import membench2, probe_fault, stream_probe

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, HW, C, RB = 2, 4096, 128, 2048  # grid (2, 2): two batch elements, two row blocks
G = 32
STATS_TOL = stream_probe.TOLERANCES["stats"]  # x max|sum|, per statistic


def _closures(script, names, **bound):
    """The nested functions `names` of scripts/<script>, defined in a
    namespace holding `bound`."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        tree = ast.parse(f.read())
    defs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    ns = {"jax": jax, "jnp": jnp, **bound}
    exec(compile(ast.Module(body=defs, type_ignores=[]), script, "exec"), ns)
    return ns


def _probe_inputs(seed=0):
    """x (bf16, a different mean and spread per channel) as a torch tensor
    and the same values as a JAX array."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(-1, 1, C)
    std = rng.uniform(0.5, 1.5, C)
    x32 = (rng.standard_normal((B, HW, C)) * std + mean).astype(np.float32)
    xt = torch.from_numpy(x32).bfloat16()
    return xt, jnp.asarray(xt.float().numpy(), jnp.bfloat16)  # the same bf16 values


def _affine():
    """The probe's (C,) fp32 scale and bias, which its closures read."""
    rng = np.random.default_rng(10)
    return ((1 + 0.3 * rng.standard_normal(C)).astype(np.float32),
            (0.3 * rng.standard_normal(C)).astype(np.float32))


@pytest.fixture(scope="module")
def probe():
    """The JAX probe's kernels and wrappers at (B, HW, C) = (2, 4096, 128)."""
    scale, bias = _affine()
    return _closures(
        "pallas_stream_probe.py",
        ["stats_kernel", "pallas_stats", "apply_kernel", "pallas_gn", "xla_gn", "xla_stats",
         "touch_kernel", "dma_read", "mxu_stats_kernel", "mxu_stats"],
        pl=pl, pltpu=pltpu, B=B, HW=HW, C=C, RB=RB, G=G, CG=C // G,
        scale=jnp.asarray(scale), bias=jnp.asarray(bias))


def _assert_stats_close(got, ref):
    for s in range(2):  # sum x, sum x^2
        lim = STATS_TOL * np.abs(ref[:, s]).max()
        np.testing.assert_array_less(np.abs(got[:, s] - ref[:, s]), lim + 1e-30)


@pytest.mark.parametrize("kernel,wrapper", [("pallas_stats", sp.probe_stats),
                                            ("mxu_stats", sp.probe_mma_stats)])
def test_stats_match_pallas_probe(probe, kernel, wrapper):
    """P1 (`stats_kernel`) and P4 (`mxu_stats_kernel`): [sum x, sum x^2] per channel."""
    xt, xj = _probe_inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe[kernel](xj))
    got = wrapper(xt)
    assert got.shape == (B, 2, C) and got.dtype == torch.float32
    _assert_stats_close(got.numpy(), ref)
    _assert_stats_close(got.numpy(), np.asarray(probe["xla_stats"](xj)))


def test_gn_forward_matches_pallas_probe(probe):
    """P1 -> group combine -> P2 against the probe's `pallas_gn` (stats
    kernel, the combine at :81-87, `apply_kernel`): within one bf16 ulp +
    2^-12 of every element."""
    xt, xj = _probe_inputs(seed=1)
    scale, bias = _affine()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe["pallas_gn"](xj), np.float32)
    mean_c, inv_c = gn.group_combine(sp.probe_stats(xt), HW)
    got = sp.probe_apply(xt, mean_c, inv_c, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    got = got.float().numpy()
    diff = np.abs(got - ref)
    assert np.all(diff <= 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 2.0**-12), diff.max()
    assert np.mean(diff > 0) < 0.01  # almost every element is equal
    xla = np.asarray(probe["xla_gn"](xj), np.float32)
    assert np.all(np.abs(got - xla) <= 2.0**-7 * np.abs(xla) + 2.0**-12)


def test_touch_matches_pallas_probe(probe):
    """P3 (`touch_kernel`): the row the last block of each batch element's
    grid writes, x[:, R - RB], exactly."""
    xt, xj = _probe_inputs(seed=2)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe["dma_read"](xj))
    got = sp.probe_touch(xt)
    assert got.shape == (B, 1, C) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref[:, 0], xt[:, HW - RB].float().numpy())


def test_square_split_is_exact():
    """P4's sum x^2 on bf16 tensor cores: for every bf16 x with
    2^-56 <= |x| < 2^63 (x^2 and its remainder stay normal numbers),
    hi = bf16(x^2) and lo = bf16(x^2 - hi) are exact, hi + lo == x^2."""
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float()
    x = x[torch.isfinite(x) & (x.abs() >= 2.0**-56) & (x.abs() < 2.0**63)]
    sq = x * x
    hi = sq.bfloat16().float()
    lo = (sq - hi).bfloat16().float()
    assert x.numel() > 30000
    assert torch.equal(hi + lo, sq)


def test_cpu_takes_plain_path_and_counts_no_launch():
    xt, _ = _probe_inputs()
    scale, bias = _affine()
    before = [f.launches for f in sp.KERNELS]
    st = sp.probe_stats(xt)
    torch.testing.assert_close(st, gn.channel_stats_plain(xt), rtol=0, atol=0)
    torch.testing.assert_close(sp.probe_mma_stats(xt), st, rtol=0, atol=0)
    m, i = gn.group_combine(st, HW)
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    assert torch.equal(sp.probe_apply(xt, m, i, sc, bi),
                       gn.normalize_silu_plain(xt, m, i, sc, bi))
    assert torch.equal(sp.probe_touch(xt), sp.touch_plain(xt))
    assert [f.launches for f in sp.KERNELS] == before


@pytest.mark.parametrize("name", ["probe_stats", "probe_apply", "probe_touch",
                                  "probe_mma_stats"])
def test_wrappers_refuse_other_devices(name):
    x = torch.empty(1, RB, 16, dtype=torch.bfloat16, device="meta")
    st = torch.empty(1, 16, device="meta")
    args = (x, st, st, st[0], st[0]) if name == "probe_apply" else (x,)
    with pytest.raises(ValueError, match="device"):
        getattr(sp, name)(*args)


@pytest.mark.parametrize("x,err", [
    (torch.zeros(1, 64, 16), TypeError),                                      # float32
    (torch.zeros(1, 64, 12, dtype=torch.bfloat16), ValueError),              # C % 8
    (torch.zeros(1, 64, 4096, dtype=torch.bfloat16), ValueError),            # C > 2048
    (torch.zeros(1, 16, 64, dtype=torch.bfloat16).transpose(1, 2), ValueError),  # strides
    (torch.zeros(64, 16, dtype=torch.bfloat16), ValueError),                 # not (B, R, C)
])
def test_wrappers_check_inputs(x, err):
    for fn in (sp.probe_stats, sp.probe_mma_stats):
        with pytest.raises(err):
            fn(x)


def test_probe_touch_needs_whole_row_blocks():
    with pytest.raises(ValueError, match="multiple"):
        sp.probe_touch(torch.zeros(1, 3 * RB // 2, 8, dtype=torch.bfloat16))
    x = torch.arange(3 * RB * 8, dtype=torch.float32).reshape(1, 3 * RB, 8).bfloat16()
    assert torch.equal(sp.probe_touch(x), x[:, 2 * RB:2 * RB + 1].float())


def test_probe_fault_drops_only_the_lo_product():
    """The planted fault removes P4's ones . lo product and nothing else."""
    with open(os.path.join(ROOT, "nshmc_tpu_torch", "csrc", "stream_probe.cu")) as f:
        sound = f.read().splitlines(keepends=True)
    faulty = probe_fault.faulty_source().splitlines(keepends=True)
    gone = [ln for ln in sound if ln not in faulty]
    assert gone == [probe_fault.LO_PRODUCT] and len(faulty) == len(sound) - 1
    assert "mma_ones(e, h0, h1" in "".join(faulty)


def test_stream_probe_cpu_run(tmp_path, monkeypatch, capsys):
    """--device cpu checks every kernel, runs every case once, prints null
    times, and writes nothing unless --out is given."""
    monkeypatch.chdir(tmp_path)
    scripts_dir = os.path.dirname(stream_probe.__file__)
    before = sorted(os.listdir(scripts_dir))
    res = stream_probe.main(["--device", "cpu", "--shape", f"{B},{HW},{C}", "--iters", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    checks = {ln["check"]: ln for ln in lines if "check" in ln}
    timed = {ln["case"]: ln for ln in lines if "case" in ln}
    assert set(checks) == {"probe_stats", "probe_mma_stats", "probe_apply", "probe_touch"}
    assert all(c["ok"] for c in checks.values())
    assert {"torch_stats", "k2a_stats", "cuda_stats", "torch_gn_fwd", "kernel_gn_fwd",
            "cuda_gn_fwd", "cuda_dma_read", "cuda_mma_stats"} <= set(timed)
    assert all(v["s_per_iter"] is None and v["eff_gb_s"] is None for v in timed.values())
    assert res["launches"] == {f.__name__: 0 for f in sp.KERNELS}
    assert os.listdir(tmp_path) == [] and sorted(os.listdir(scripts_dir)) == before
    out = tmp_path / "probe.json"
    stream_probe.main(["--device", "cpu", "--shape", "1,2048,64", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["shape"] == [1, 2048, 64] and saved["device"] == "cpu"
    assert set(saved["cases"]) == set(timed)


@pytest.mark.parametrize("script,argv", [(stream_probe, ["--shape", "1,2048,8"]),
                                         (membench2, ["1", "4", "64", "1"]),
                                         (probe_fault, ["--shape", "1,2048,8"])])
def test_probe_scripts_refuse_to_fall_back_to_cpu(script, argv):
    """Without --device cpu a host with no card gets an error, not CPU times."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        script.main(argv)


def test_membench2_cpu_run(capsys):
    res = membench2.main(["1", "16", "64", "1", "--device", "cpu"])
    cases = [json.loads(ln)["case"] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert cases == ["reduce_full", "reduce_spatial", "reduce_dot", "gn_flax_fwd", "gn_chan_fwd",
                     "gn_chan_dot_fwd", "gn_flax_vjp", "gn_chan_vjp", "gn_chan_dot_vjp",
                     "kernel_fwd", "kernel_vjp"]
    assert res["shape"] == [1, 16, 16, 64]
    assert list(res["cases"]) == cases
    assert all(v["s_per_iter"] is None and v["model_gb_s"] is None for v in res["cases"].values())


def _membench_inputs(b=2, r=8, c=64, seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, r, r, c)) * 1.5 + 0.3).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _jax_membench(x, scale, bias):
    b, r, _, c = x.shape
    return _closures("membench2.py", ["gn_flax", "_chan_stats_reduce", "_chan_stats_dot",
                                      "_gn_from_chan", "gn_chan", "gn_chan_dot"],
                     B=b, R=r, C=c, G=G, scale=jnp.asarray(scale), bias=jnp.asarray(bias))


@pytest.mark.parametrize("name", ["gn_flax", "gn_chan", "gn_chan_dot"])
def test_membench2_formulations_match_jax(name):
    """Each formulation's forward and its input gradient of sum(SiLU(GN(x)))
    against the JAX bench's, in fp32; the port's K2 agrees with all of them."""
    x, scale, bias = _membench_inputs()
    jfn = _jax_membench(x, scale, bias)[name]
    ref = np.asarray(jfn(jnp.asarray(x)))
    ref_g = np.asarray(jax.grad(lambda xx: jnp.sum(jfn(xx).astype(jnp.float32)))(jnp.asarray(x)))
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    fn = membench2.FORMULATIONS[name]
    np.testing.assert_allclose(fn(*args).numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(membench2.input_grad(fn, *args).numpy(), ref_g, atol=1e-4)
    np.testing.assert_allclose(membench2.gn_kernel(*args).detach().numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(membench2.input_grad(membench2.gn_kernel, *args).numpy(), ref_g,
                               atol=1e-4)


def test_membench2_channel_sums_match_jax():
    """The reductions behind reduce_spatial and reduce_dot, in fp32."""
    x, scale, bias = _membench_inputs(seed=5)
    ns = _jax_membench(x, scale, bias)
    xt = torch.from_numpy(x)
    for (s, s2), (rs, rs2) in ((membench2.chan_stats_reduce(xt),
                                ns["_chan_stats_reduce"](jnp.asarray(x))),
                               (membench2.chan_stats_dot(xt), ns["_chan_stats_dot"](jnp.asarray(x)))):
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(s2.numpy(), np.asarray(rs2), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(membench2.chan_sum_dot(xt).numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-3)
