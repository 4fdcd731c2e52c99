"""How `correct` is decided: the plain reference (reference/) follows the
attempt sampled from the window, from the program's own chain state at its
start, with the same momenta and uniforms, on its own float32 trajectory.
Its step size and measurement sigma it works out again from the traffic,
replaying the sampler's schedule over the program's MH decisions of the
image's earlier attempts. These numbers compare the program's outputs with
it (the worst of the chains followed):

  loss_gap   |U_prog - U_ref| / |U_ref| of the energy's data term at the
             attempt's start position (one position for both sides)
  dec_gap    ||d_prog - d_ref|| / ||d_ref|| of the decoded output there (the
             pixel path's x_0 image, the latent path's DDIM-decoded z_0)
  img_typ    median |i_prog - i_ref| / median |i_ref| of the image H reads
             there (the latent path's VQ decode of z_0; the pixel path's
             x_0, its decoded output)
  grad_gap   ||g_prog - g_ref|| / ||g_ref|| of the energy's input gradient
             there
  grad_typ   median |g_prog - g_ref| / median |g_ref| over the chain's
             elements whose reference gradient is not 0 (a clip or a
             stop-gradient leaves the others at exactly 0)
  step1_gap  ||x_1,prog - x_1,ref|| / ||x_1,ref - x_start|| of the first
             full leapfrog step's position, against the reference's
             displacement
  traj_gap   the same of the last leapfrog position x_L
  traj_typ   median |x_L,prog - x_L,ref| / median |x_L,ref - x_start|
  kept_typ   the same of the position the program keeps after its MH
             decision, against the reference's position for that decision
             (x_L,ref on an accept, x_start on a rejection)
  mh_wrong   the chains whose MH decision is not the one that the reference's
             log ratio makes, where that clears log u by MH_MARGIN nats
             plus the gap between the two sides' log ratios; or not the one
             that the program's own recorded trajectory makes (its energies,
             gradients and positions, the momenta rebuilt from the draws),
             where that clears log u by MH_MARGIN

Each number but mh_wrong is the worst of the chains followed, and
`<name>_med` the median chain's (the mean of the two middle chains), steady
where one chain's number jumps on a discrete event that rounding moves (a
DDIM clip or a VQ code picked the other way). A typical gap (`_typ`) is left
alone by the few elements such an event moves. Each number that the cell's
workload file gives a limit is compared (value <= limit); the others are
printed as readings."""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import problems

GAPS = ("loss_gap", "dec_gap", "img_typ", "grad_gap", "grad_typ", "step1_gap", "traj_gap",
        "traj_typ", "kept_typ")
NUMBERS = GAPS + tuple(f"{g}_med" for g in GAPS) + ("mh_wrong",)
MH_MARGIN = 1.0  # nats: the float32 rounding of a log ratio over ~1e5 elements is ~0.01


def chains_to_follow(n_chains: int, n_check: int, seed: int) -> np.ndarray:
    """`n_check` of the chains, drawn from the seed (all where n_check >= n)."""
    import inputs

    if n_check >= n_chains:
        return np.arange(n_chains)
    rng = np.random.default_rng(inputs.sub_seed(seed, "check", 1))
    return np.sort(rng.choice(n_chains, n_check, replace=False))


def sample_attempt(lo: int, hi: int, seed: int) -> int:
    import inputs

    return int(np.random.default_rng(inputs.sub_seed(seed, "check")).integers(lo, hi))


def rel(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per chain ||a - b|| / ||scale||."""
    n = lambda t: t.reshape(t.shape[0], -1).double().norm(dim=1)
    return n(a.double() - b.double()) / n(scale)


def typical(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
            nonzero: bool = False) -> torch.Tensor:
    """Per chain median |a - b| / median |scale| over its elements (with
    `nonzero`, those where scale is not 0)."""
    out = []
    for ai, bi, si in zip(a, b, scale):
        d, s = (ai.double() - bi.double()).abs().flatten(), si.double().abs().flatten()
        if nonzero:
            d, s = d[s != 0], s[s != 0]
        out.append(d.median() / s.median() if len(s) else torch.tensor(math.inf))
    return torch.stack(out)


def numbers(problem: problems.Problem, sample, position: str, idx: np.ndarray,
            n_leapfrog: int, m: float, device) -> tuple[dict, dict]:
    """(the numbers above, readings beside them) for the chains `idx`."""
    sel = torch.as_tensor(idx)
    to = lambda t: t[sel].to(device)
    x_in = sample.state_in[position][sel].to(device)
    eps, sigma_y = (t.to(device) for t in problem.attempt_params(sample.decisions[:, sel]))
    loss0, dec0, img0, g0, x_1, x_l, log_ratio, accept = problems.leapfrog(
        problem, x_in, to(sample.p0), to(sample.u), eps, sigma_y, sample.y0.to(device),
        n_leapfrog, m)
    loss_p = sample.loss[:, sel].to(device)
    x_p = sample.x[:, sel].to(device)
    g_p = sample.grad[:, sel].to(device)
    img_all = sample.img0 if sample.img0 is not None else sample.dec0
    img_p = to(img_all) if img_all.shape[0] == sample.dec0.shape[0] else None
    x_out = sample.state_out[position][sel].to(device)
    accept_p = (sample.state_out["accepted"] - sample.state_in["accepted"])[sel].to(device) > 0
    log_u = torch.log(to(sample.u).double())
    lr_p = problems.trajectory_log_ratio(x_p, loss_p, g_p, to(sample.p0), eps, sigma_y, m)
    lr_gap = (lr_p - log_ratio).abs()
    clear_ref = (torch.clamp(log_ratio, max=0.0) - log_u).abs() > MH_MARGIN + lr_gap
    clear_own = (torch.clamp(lr_p, max=0.0) - log_u).abs() > MH_MARGIN
    wrong = ((clear_ref & (accept_p != accept)) |
             (clear_own & (accept_p != problems.mh_accept(lr_p, to(sample.u)))))
    disp = x_l - x_in.double()
    kept_ref = torch.where(accept_p.view((-1,) + (1,) * (x_in.dim() - 1)), x_l, x_in.double())
    vals = {
        "loss_gap": ((loss_p[0].double() - loss0.double()).abs() / loss0.double().abs()),
        "dec_gap": rel(to(sample.dec0), dec0, dec0),
        "img_typ": (typical(img_p, img0, img0) if img_p is not None and img_p.shape == img0.shape
                    else torch.full((len(idx),), math.inf)),  # an image of another shape
        "grad_gap": rel(g_p[0], g0, g0),
        "grad_typ": typical(g_p[0], g0, g0, nonzero=True),
        "step1_gap": rel(x_p[1], x_1, x_1 - x_in.double()),
        "traj_gap": rel(x_p[n_leapfrog], x_l, disp),
        "traj_typ": typical(x_p[n_leapfrog], x_l, disp),
        "kept_typ": typical(x_out, kept_ref, disp),
    }
    worst = {}
    for k, v in vals.items():
        ok = bool(torch.isfinite(v).all())
        worst[k] = float(v.max()) if ok else math.inf
        worst[f"{k}_med"] = float(v.double().quantile(0.5)) if ok else math.inf
    worst["mh_wrong"] = int(wrong.sum())
    start_exact = bool(torch.equal(x_p[0], x_in))
    if not start_exact:  # the attempt did not start from the chain state it was given
        worst = {k: math.inf for k in worst}
    readings = {
        "chains": [int(i) for i in idx],
        "accept_prog": [bool(a) for a in accept_p.cpu()],
        "accept_ref": [bool(a) for a in accept.cpu()],
        "log_ratio_ref": [float(v) for v in log_ratio.cpu()],
        "log_ratio_prog": [float(v) for v in lr_p.cpu()],
        "log_u": [float(v) for v in log_u.cpu()],
        "eps": [float(v) for v in eps.cpu()],
        "sigma_y": [float(v) for v in sigma_y.cpu()],
        "flips": problem.flips(to(sample.dec0), dec0),
        "loss_ref0": [float(v) for v in loss0.cpu()],
    }
    return worst, readings


def verdict(worst: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: (value, limit)}) over the numbers with a limit."""
    compared = {k: (worst[k], float(limits[k])) for k in NUMBERS if k in limits}
    ok = bool(compared) and all(math.isfinite(v) and v <= lim for v, lim in compared.values())
    return ok, compared
