"""The check fails what it must, at a size a test run holds (tiny cells on
the CPU; the same comparison that decides `correct` on the card):

  - the control: the reference in the next precision below the
    configuration's, put in the program's place (bfloat16 for the latent
    float32 configuration, fp8 operands for the bf16 pixel one);
  - faults planted in the timed path underneath: leapfrog steps that
    leave the position where it was; half of the batch left out, the mean
    of the rest in its place; an answer altered where it is produced (the
    decoded output); an MH step that accepts every proposal. The cells run
    on one card, so there is no exchange between cards to leave out.

Faults are held to the full-size cells' limits (workloads/*.json); the
tiny cells' sound runs read float32 rounding (test_bench_reference.py). An
altered answer is off by 1%."""
import pytest
import torch

import run
import tiny

CPU = torch.device("cpu")
SEED = 2718281828459
TINY_LIMIT = 1e-5


@pytest.mark.parametrize("kind", ["ffhq_adm", "ffhq_ldm"])
def test_control_fails(kind):
    """The cell's compared numbers, each held at TINY_LIMIT: the tiny nets'
    float32 runs read under 3e-6, and their rounding in a lower precision
    stays under the full-size cells' limits."""
    full = tiny.cell(kind)
    cell = tiny.cell(kind, chains=2, limits={k: TINY_LIMIT for k in full.workload["limits"]})
    out = run.run_cell(cell, SEED, 0.1, 0, CPU, control=full.config["control"], sample_attempt=0)
    assert not out["correct"], out["worst"]


def _still(program):
    """The leapfrog steps leave the position where it was (a zero step):
    every evaluation runs, at the attempt's start."""
    import nshmc_tpu_torch.hmc.engine as engine
    import nshmc_tpu_torch.hmc.latent as latent

    for mod in (engine, latent):
        real = mod.leapfrog_propose

        def frozen(loss_fn, x, sigma_y, eps, *a, _real=real, **k):
            return _real(loss_fn, x, sigma_y, eps * 0.0, *a, **k)
        mod.leapfrog_propose = frozen


def _accept(program):
    """The MH step accepts every proposal, whatever its log ratio."""
    import nshmc_tpu_torch.hmc.engine as engine
    import nshmc_tpu_torch.hmc.latent as latent

    for mod in (engine, latent):
        real = mod.leapfrog_propose

        def always(*a, _real=real, **k):
            accept, *rest = _real(*a, **k)
            return (torch.ones_like(accept), *rest)
        mod.leapfrog_propose = always


def _half(program):
    real = program.loss_fn

    def loss_fn(y0, tap=None):
        f = real(y0, tap)

        def g(x):
            n = x.shape[0] // 2
            loss, dec = f(x[:n])
            return (torch.cat([loss, loss.mean().expand(x.shape[0] - n)]),
                    torch.cat([dec, dec.mean(0, keepdim=True).expand(x.shape[0] - n,
                                                                     *dec.shape[1:])]))
        return g
    program.loss_fn = loss_fn


def _altered(program):
    """The decoded output (the sample an accepted proposal keeps) off by 1%
    of its spread where it is produced."""
    real = program.loss_fn

    def loss_fn(y0, tap=None):
        f = real(y0, tap)

        def g(x):
            loss, dec = f(x)
            return loss, dec + 1e-2 * dec.reshape(len(dec), -1).std(1).view(-1, 1, 1, 1)
        return g
    program.loss_fn = loss_fn


FAULTS = [(kind, fault) for kind in ("ffhq_adm", "ffhq_ldm")
          for fault in ("still", "half", "decoded", "accept")]


@pytest.mark.parametrize("kind,fault", FAULTS)
def test_fault_fails(kind, fault, monkeypatch):
    import nshmc_tpu_torch.hmc.engine as engine
    import nshmc_tpu_torch.hmc.latent as latent

    monkeypatch.setattr(engine, "leapfrog_propose", engine.leapfrog_propose)
    monkeypatch.setattr(latent, "leapfrog_propose", latent.leapfrog_propose)
    patch = {"still": _still, "half": _half, "decoded": _altered, "accept": _accept}[fault]
    out = run.run_cell(tiny.cell(kind), SEED, 0.1, 0, CPU, patch=patch)
    assert not out["correct"], (fault, out["worst"])
