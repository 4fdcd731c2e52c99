"""The Stable Diffusion cell's plain reference against the port at tiny
widths on the CPU (the port's plain versions there), one state_dict loaded
strictly into both: the conditional U-Net with linear projections, the KL
decode and its input gradient, the latent loss with its z_0 and gradient,
and a whole tiny run's check at float32 rounding; the useful FLOPs of one
evaluation at the published widths, counted on `meta`; and the K1 sites'
least time."""
import copy
import json
import os

import pytest
import torch

import attn_sites
import cells
import flops
import inputs
import run
from reference import problems
from reference.sd_latent_hmc import CONTEXT_INDEX, Context, kl_spec, sd_unet_spec
from reference.kl import KLDecode
from reference.sd_unet import SDUNet
from systems.sd_latent_hmc import DECODE_PREFIXES

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
TOL = dict(atol=2e-4, rtol=1e-3)  # test_bench_reference.py's: f32 sums in other orders
NAME = "sd21_base.hmc8_inpaint_prompt"
TINY_MODEL = {"linear_start": 0.00085, "linear_end": 0.012, "timesteps": 100, "image_size": 8,
              "channels": 4, "scale_factor": 0.18215, "dtype": "float32",
              "unet": {"image_size": 8, "in_channels": 4, "out_channels": 4,
                       "model_channels": 32, "attention_resolutions": [2, 1],
                       "num_res_blocks": 1, "channel_mult": [1, 2], "num_head_channels": 16,
                       "use_linear_in_transformer": True, "transformer_depth": 1,
                       "context_dim": 32},
              "first_stage": {"double_z": True, "embed_dim": 4, "z_channels": 4,
                              "resolution": 8, "ch": 32, "ch_mult": [1, 2],
                              "num_res_blocks": 1, "attn_resolutions": []}}


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def tiny_cell(chains=4, attempts=(0, 1)) -> cells.Cell:
    config = copy.deepcopy(_json("configs", "sd21_base.json"))
    config.update(dtype="float32", model=copy.deepcopy(TINY_MODEL),
                  data={"image_size": 16, "channels": 3})
    tr = dict(_json("traffic", "hmc8_inpaint_prompt.json"), chains=chains)
    wl = _json("workloads", f"{NAME}.json")
    workload = dict(wl, check={"attempts": list(attempts), "chains": chains, "chunk": 2})
    bench = _json("..", "BENCHMARK.json")
    entry = {"name": NAME, "config": "sd21_base", "traffic": "hmc8_inpaint_prompt", "chips": 1}
    return cells.Cell(name=NAME, entry=entry, workload=workload, traffic=tr, config=config,
                      end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def port_ldm(model=TINY_MODEL, seed=20240917):
    """The port's LDM at the tiny widths, loaded as the system loads it."""
    from nshmc_tpu_torch.cli_latent import build_latent_model

    ldm, _ = build_latent_model({"model": model}, type("O", (), {"ckpt": ""})(), "cpu")
    ldm.unet.load_state_dict(inputs.random_state_dict(inputs.shapes_of(ldm.unet), "cpu", seed, 0))
    dec = {k: v for k, v in inputs.shapes_of(ldm.first_stage).items()
           if k.startswith(DECODE_PREFIXES)}
    ldm.first_stage.load_state_dict(inputs.random_state_dict(dec, "cpu", seed, 1), strict=False)
    return ldm


def test_conditional_unet_with_linear_projections():
    ldm = port_ldm()
    ref = SDUNet(sd_unet_spec(TINY_MODEL))
    assert inputs.shapes_of(ldm.unet) == inputs.shapes_of(ref)
    ref.load_state_dict(ldm.unet.state_dict(), strict=True)
    g = torch.Generator().manual_seed(3)
    z = torch.randn(2, 8, 8, 4, generator=g)
    ctx = torch.randn(1, 5, 32, generator=g)
    t = torch.tensor([750.0, 250.0])
    with torch.no_grad():
        torch.testing.assert_close(ref(z, t, ctx.expand(2, -1, -1)),
                                   ldm.unet(z, t, context=ctx.expand(2, -1, -1)), **TOL)


def test_kl_decode_and_its_input_gradient():
    ldm = port_ldm()
    ref = KLDecode(kl_spec(TINY_MODEL["first_stage"]), TINY_MODEL["scale_factor"])
    ref.load_state_dict({k: v for k, v in ldm.first_stage.state_dict().items()
                         if k.startswith(DECODE_PREFIXES)}, strict=True)
    z = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(4))
    w = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(5))
    outs = []
    for decode in (ref, ldm.decode_first_stage):
        zz = z.clone().requires_grad_(True)
        img = decode(zz)
        outs.append((img.detach(), torch.autograd.grad((img * w).sum(), zz)[0]))
    assert outs[0][0].shape == (2, 16, 16, 3)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **TOL)


def test_latent_loss_z0_and_gradient():
    """The system's loss (the CLI's, its context drawn from the seed) against
    the reference problem's energy, z_0 and z-gradient."""
    from systems import sd_latent_hmc as system

    cell, seed = tiny_cell(chains=2), 31415926535
    prog = system.Program(cell.config, cell.traffic, seed, torch.device("cpu"))
    images = run.Images(cell, seed, torch.device("cpu"), prog.x_shape)
    y0, z = images(0)
    ref = run.reference_problem(cell, seed, torch.device("cpu"), images.op)
    torch.testing.assert_close(ref.context.value(), prog.ldm.model.context, rtol=0, atol=0)
    loss_r, z0_r, _, g_r = ref.value_and_grad(z, y0)
    zz = z.clone().requires_grad_(True)
    loss_p, z0_p = prog.loss_fn(y0)(zz)
    (g_p,) = torch.autograd.grad(loss_p.sum(), zz)
    for a, b in ((loss_r, loss_p), (z0_r, z0_p), (g_r, g_p)):
        torch.testing.assert_close(a, b.detach(), **TOL)


@pytest.mark.parametrize("attempt", [0, 2])
def test_tiny_sd_run_checks_at_rounding(attempt):
    """A whole run (set-up, window, check) of the tiny float32 cell: every
    number of the check at float32 rounding, one HMC attempt of the
    reference against the program's with the same draws."""
    out = run.run_cell(tiny_cell(attempts=(attempt, attempt + 1)), 3141592653589, 0.1, 0,
                       torch.device("cpu"))
    assert out["correct"], out["worst"]
    assert max(out["worst"].values()) < 1e-4, out["worst"]
    w = out["window"]
    assert w.n_evals == 21 * w.attempts and w.nonfinite == 0


def test_tiny_sd_traced_run_counts_k1_sites():
    """A --trace 1 run: the hooks find every `attn1` of the U-Net once a
    DDIM step (3 steps an evaluation), with its heads and head width; on the
    CPU the plain versions count no K1 launch and no span holds CUDA events,
    so neither K1's share nor the decode's device time is read."""
    cell = tiny_cell()
    out = run.run_cell(cell, 27182818284, 0.1, 1, torch.device("cpu"))
    found = attn_sites.LOG.found
    per_forward = sum(1 for n, _ in port_ldm().unet.named_modules() if n.endswith(".attn1"))
    assert len(found) == 3 * per_forward and per_forward > 0
    assert all(c.shape[3] == 16 and c.elem_size == 4 for c in found)
    line = run.result_line(cell, out, 1, torch.device("cpu"))
    assert "k1_roofline_pct" not in line["metrics"] and "decode_fwd_ms" not in line["metrics"]


def test_k1_least_time():
    c = attn_sites.Call((8, 4096, 5, 64), 2)
    byte_s = 4 * 8 * 4096 * 5 * 64 * 2 / 3.35e12
    flop_s = 4 * 8 * 5 * 4096 ** 2 * 64 / 989e12
    assert c.least_s(3.35e12, 989e12) == max(byte_s, flop_s) == flop_s
    log = attn_sites.Log()
    log.runs.extend([(0, 10, 5), (20, 30, 48), (40, 50, 7)])
    assert log.launches_within(15, 35) == 48 and log.launches_within(0, 60) is None


def test_flops_of_one_evaluation_at_published_widths():
    """The reference on `meta`: three eps-net forwards of 8 chains, the KL
    decode at 512^2 and its input gradient: tens of TFLOP."""
    cell = cells.load(NAME)
    fl = flops.per_eval(problems.load(cell.config["system"]), cell.config, cell.traffic,
                        (64, 64, 4))
    print(f"useful TFLOP an evaluation: {fl / 1e12:.3f}")
    assert 30e12 < fl < 80e12


def test_context_rides_the_weights_stream():
    ctx = Context(1024)
    ctx.load_state_dict(inputs.random_state_dict(inputs.shapes_of(ctx), "cpu", 5, CONTEXT_INDEX))
    v = ctx.value()
    assert v.shape == (1, 77, 1024) and abs(float(v.std()) - 1.0) < 0.02


def test_islands_control_rounds_the_float32_islands():
    """islands_in(bfloat16): GroupNorm, LayerNorm and softmax depart from
    their float32 forms by bfloat16 rounding and no more, and the functions
    come back after the block; the problem with `islands` set gives another
    energy than without, and its gradient flows."""
    import torch.nn.functional as F
    from reference import sd_latent_hmc as sd

    g = torch.Generator().manual_seed(9)
    x = 2 * torch.randn(2, 64, 6, 6, generator=g) + 0.5
    w, b = 1 + 0.2 * torch.randn(64, generator=g), 0.2 * torch.randn(64, generator=g)
    tok = torch.randn(2, 5, 64, generator=g)
    want = (F.group_norm(x, 32, w, b, 1e-6), F.layer_norm(tok, (64,), w, b),
            torch.softmax(3 * tok, dim=-1))
    saved = F.group_norm, F.layer_norm, torch.softmax
    with sd.islands_in(torch.bfloat16):
        got = (F.group_norm(x, 32, w, b, 1e-6), F.layer_norm(tok, (64,), w, b),
               torch.softmax(3 * tok, dim=-1))
    assert (F.group_norm, F.layer_norm, torch.softmax) == saved
    for a, ref in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, a.to(torch.bfloat16).float())
        gap = float((a - ref).abs().max() / ref.abs().max())
        assert 0 < gap < 2 ** -5, gap

    cell, seed = tiny_cell(chains=2), 27182818284
    images = run.Images(cell, seed, torch.device("cpu"), (8, 8, 4))
    y0, z = images(0)
    out = []
    for islands in (None, torch.bfloat16):
        ref = run.reference_problem(cell, seed, torch.device("cpu"), images.op, "bfloat16")
        ref.islands = islands
        loss, _, _, grad = ref.value_and_grad(z, y0)
        out.append((loss, grad))
    assert not torch.equal(out[0][0], out[1][0]) and torch.isfinite(out[1][1]).all()
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0.05, atol=0)
