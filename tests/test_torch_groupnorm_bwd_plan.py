"""The plan of the one-launch GN+SiLU backward K2c (`ops/groupnorm.py::
bwd_plan`, run by csrc/groupnorm_bwd.cu) and the wrapper's choice between
K2c's two designs (`bwd_design`), on the CPU.

What the port runs: `bwd_plan`'s CTAs cover every (batch, row, channel)
exactly once within Hopper's shared memory and co-residency limits, and
`bwd_design` sends each flagship shape to one design.

Models of the kernel, not checks of it (no CUDA code runs here; the card's
checks are kernel_check's and chip_smoke.py's): `_play_schedule` is a
Python copy of the kernel's per-CTA buffer schedule (two slab buffers a
CTA, TMA boxes on mbarriers, per-unit handoffs), played for every CTA of a
plan, showing that the schedule reads each unit from the buffer fill it
waits for and never deadlocks; `_emulate` is a Python copy of its order of
summation (per-channel slab sums, per-group terms, slabs added in slab
order, a (C,) affine summed over b in batch order), in fp32 on the plain
version's [sum da, sum da * xh], showing that this order stays within
`kernel_check`'s K2c tolerance of the plain version. Both take their
constants from `bwd_plan` only; if csrc/groupnorm_bwd.cu's schedule or order
changes, they must change with it. Inputs from kernel_check.gn_inputs with
a seeded generator."""
import numpy as np
import pytest
import torch

from nshmc_tpu_torch.ops import groupnorm as gn
from nshmc_tpu_torch.scripts import kernel_check as kc

torch.set_num_threads(2)
SMS = 132  # the H100's SMs
DTYPES = {"bf16": 2, "f32": 4}


def _plan_cases():
    shapes = list(dict.fromkeys([*kc.FLAGSHIP_GN_SITES, *kc.GN_SHAPES]))
    return [(s, d) for s in shapes for d in DTYPES]


@pytest.mark.parametrize("shape,dtype", _plan_cases(),
                         ids=[f"{s}-{d}" for s, d in _plan_cases()])
def test_plan_covers_every_element_once_within_the_card(shape, dtype):
    _assert_plan_covers(*shape, DTYPES[dtype])


def _assert_plan_covers(b, r, c, elem, num_groups=gn.NUM_GROUPS):
    p = gn.bwd_plan(b, r, c, elem, SMS, num_groups)
    vec, cg = 16 // elem, c // num_groups
    # the unit's channels: a multiple of the group and of the 16-byte vector,
    # >= 64 bytes a row, a divisor of C
    assert p.ck % cg == 0 and p.ck % vec == 0 and c % p.ck == 0 and p.ck * elem >= 64
    assert p.units == b * (c // p.ck)
    # TMA boxes: <= 256 rows, 128-byte aligned destinations; a slab is whole boxes
    assert 1 <= p.box_rows <= 256 and (p.box_rows * p.ck * elem) % 128 == 0
    assert 1 <= p.n_box <= 8
    # shared memory: the kernel's layout, <= 227 KB a block, ctas_per_sm blocks an SM
    assert p.smem == gn.bwd_smem(vec, elem, p.slab_rows * p.ck)
    assert p.smem <= gn.SMEM_CTA
    assert p.ctas_per_sm * (p.smem + 1024) <= gn.SMEM_SM
    # co-residency: the grid fits the card at ctas_per_sm blocks an SM
    assert p.ctas_per_sm in (1, 2) and p.grid <= SMS * p.ctas_per_sm
    assert 1 <= p.units_in_flight <= p.units
    # slabs partition the rows: every slab non-empty, the last ends at or past R
    assert (p.slabs - 1) * p.slab_rows < r <= p.slabs * p.slab_rows
    # the kernel's work map: CTA i takes slab i % S of units i // S, + Q, ...
    seen = np.zeros((p.units, p.slabs), np.int32)
    for cta in range(p.grid):
        s, q = cta % p.slabs, cta // p.slabs
        seen[q::p.units_in_flight, s] += 1
    assert (seen == 1).all()
    # so with units (b, chunk) partitioning (B, C) and slabs partitioning R,
    # every (b, row, channel) lies in exactly one (unit, slab)
    rows = sum(min(p.slab_rows, r - s * p.slab_rows) for s in range(p.slabs))
    assert rows == r and p.units * p.ck == b * c
    assert p.scratch_floats > 0 and p.counters == 2 * p.units + 2


BATCH1_F32 = [s for _, sites in kc.BATCH1_GN_SITES.values() for s in sites]


@pytest.mark.parametrize("shape", BATCH1_F32, ids=str)
def test_batch1_f32_latent_sites_have_a_design_and_a_plan(shape):
    """The ReSamples' K2c sites in f32 at batch 1: the latent U-Net's (C =
    224 k, 7-56 channels a group) and the VQ decoder's. Each channel chunk
    of whole groups the wrapper cuts a call into (C > 1024) has a design
    that `bwd_design` picks among those that take it; the two-pass one's
    finish kernel holds the batch's group sums, and the one launch's plan
    covers every element once within the card."""
    b, r, c = shape
    n = gn.bwd_channel_chunks(c, gn.NUM_GROUPS, 4)
    w, groups = c // n, gn.NUM_GROUPS // n
    assert w * n == c and w % 8 == 0 and w % groups == 0 and w <= 1024
    designs = gn.bwd_designs(b, r, w, 4, SMS, groups)
    assert designs and gn.bwd_design(b, r, w, 4, SMS, groups) in designs
    if "twopass" in designs:
        assert 8 * b * (w // groups) <= gn._BWD_FINISH_SMEM
    if "one_launch" in designs:
        _assert_plan_covers(b, r, w, 4, groups)
    if c == 224:  # 7 channels a group, the narrowest: units of 28 channels (4 groups)
        assert gn.bwd_plan(b, r, c, 4, SMS).ck == 28


def test_small_units_take_no_handoff_and_the_hot_shape_fills_the_card():
    """A unit of <= 64 KB (the 8^2 and 16^2 sites) stays in one CTA; the
    hot shape's units spread over every SM, two CTAs each, all on one unit
    at a time, and each CTA takes every unit (so its second buffer loads
    unit k + 1 while unit k is reduced and written)."""
    for shape in [(8, 64, 512), (8, 64, 1024), (8, 256, 512), (8, 256, 1024)]:
        assert gn.bwd_plan(*shape, 2, SMS).slabs == 1
    hot = gn.bwd_plan(8, 65536, 128, 2, SMS)
    assert hot.ctas_per_sm == 2 and hot.grid >= 0.95 * 2 * SMS and hot.units_in_flight == 1


def _play_schedule(plan, r):
    """A model of the kernel (see the module note). Play csrc/groupnorm_bwd.cu's per-CTA order of operations for every CTA
    of `plan`, round-robin, and check its bookkeeping: TMA boxes of x and g
    of units 0 and 1 first; for each unit k, every box of x and g it waits
    for is in buffer k % 2 and is that mbarrier's (k // 2)-th fill (the
    parity it waits on); once the reduction has read g, unit k + 2's g goes
    into the freed boxes, and the next unit's constants into the set unit
    k - 1 has left; the handoff (arrive, wait for all S slabs); once dx is
    written, unit k + 2's x. Returns the number of rounds; fails on a
    deadlock (every live CTA waiting)."""
    slabs, q_n, units = plan.slabs, plan.units_in_flight, plan.units
    arrive = [0] * units

    def cta(q, s):
        nk = (units - q + q_n - 1) // q_n if q < units else 0
        rows = min(plan.slab_rows, r - s * plan.slab_rows)
        n_issue = -(-rows // plan.box_rows)
        held, fills, consts = {}, {}, {}

        def load(k, which, i):
            key = (k & 1, which, i)
            assert held.get(key) is None, (q, s, k, which, i)
            held[key] = k
            fills.setdefault(key, []).append(k)

        for k in range(min(nk, 2)):
            for i in range(n_issue):
                load(k, 0, i)
                load(k, 1, i)
        consts[0] = 0
        for k in range(nk):
            assert consts[k & 1] == k
            for i in range(n_issue):
                for which in (0, 1):
                    key = (k & 1, which, i)
                    assert held[key] == k and fills[key].index(k) == k // 2, (q, s, k, key)
            for i in range(n_issue):  # the reduction has read g
                held[(k & 1, 1, i)] = None
                if k + 2 < nk:
                    load(k + 2, 1, i)
            if k + 1 < nk:
                assert consts.get((k + 1) & 1) in (None, k - 1)
                consts[(k + 1) & 1] = k + 1
            u = q + k * q_n
            if slabs > 1:
                arrive[u] += 1
                while arrive[u] < slabs:
                    yield False
            for i in range(n_issue):  # dx is written: x is free
                held[(k & 1, 0, i)] = None
                if k + 2 < nk:
                    load(k + 2, 0, i)
            yield True

    live = [cta(i // slabs, i % slabs) for i in range(plan.grid)]
    rounds = 0
    while live:
        rounds += 1
        moved, still = False, []
        for g in live:
            try:
                moved |= next(g)
                still.append(g)
            except StopIteration:
                moved = True
        assert moved, "deadlock: every live CTA waits at a handoff"
        live = still
    return rounds


@pytest.mark.parametrize("shape,elem,sms", [((8, 65536, 128), 2, SMS), ((8, 16384, 384), 2, SMS),
                                            ((8, 4096, 256), 4, SMS), ((8, 1024, 768), 2, SMS),
                                            ((3, 1000, 96), 2, 8), ((1, 17, 32), 4, SMS)])
def test_pipeline_fills_each_buffer_in_unit_order_and_never_deadlocks(shape, elem, sms):
    plan = gn.bwd_plan(*shape, elem, sms)
    assert _play_schedule(plan, shape[1]) >= -(-plan.units // plan.units_in_flight)


def _emulate(x, g, mean_c, inv_c, scale, bias, plan, groups=gn.NUM_GROUPS):
    """A model of the kernel (see the module note): its order of summation in fp32: per-channel sums of each
    slab, each slab's group terms sum_c gamma_c * (.), slabs added in slab
    order, then dx; the affine gradients are the per-channel slab sums added
    in slab order (and over b in batch order for a (C,) affine)."""
    b, r, c = x.shape
    sc = scale.float().reshape(-1, c).expand(b, c)
    bi = bias.float().reshape(-1, c).expand(b, c)
    xh = (x.float() - mean_c[:, None]) * inv_c[:, None]
    a = xh * sc[:, None] + bi[:, None]
    s = torch.sigmoid(a)
    da = g.float() * s * (1 + a * (1 - s))
    cg, ck, sr = c // groups, plan.ck, plan.slab_rows
    ng, n = ck // cg, r * cg
    dx = torch.empty(b, r, c)
    dbias, dscale = torch.zeros(b, c), torch.zeros(b, c)
    for bb in range(b):
        for j in range(c // ck):
            cs = slice(j * ck, (j + 1) * ck)
            gam = sc[bb, cs]
            k1 = torch.zeros(ng)
            k2 = torch.zeros(ng)
            for sl in range(plan.slabs):
                rs = slice(sl * sr, (sl + 1) * sr)
                s1 = da[bb, rs, cs].sum(0)
                s2 = (da[bb, rs, cs] * xh[bb, rs, cs]).sum(0)
                k1 += (gam * s1).reshape(ng, cg).sum(-1)
                k2 += (gam * s2).reshape(ng, cg).sum(-1)
                dbias[bb, cs] += s1
                dscale[bb, cs] += s2
            k1c = (k1 / n).repeat_interleave(cg)
            k2c = (k2 / n).repeat_interleave(cg)
            dx[bb, :, cs] = inv_c[bb, cs] * (gam * da[bb, :, cs]
                                              - (k1c + xh[bb, :, cs] * k2c))
    if scale.dim() == 1:
        dscale = sum(dscale[i] for i in range(b))
        dbias = sum(dbias[i] for i in range(b))
    return dx.to(x.dtype), dscale, dbias


@pytest.mark.parametrize("shape,sms", [((2, 3000, 64), 8), ((3, 1000, 96), 8),
                                       ((1, 17, 32), 132)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", kc.AFFINE_FORMS)
def test_kernel_summation_order_is_within_tolerance(shape, sms, dtype, form):
    """On a small card (few SMs) the plan cuts each unit into several slabs,
    so the emulation adds slab terms as the kernel's handoff does."""
    gen = torch.Generator().manual_seed(sum(shape) + sms)
    inputs = kc.gn_inputs(shape, dtype, form, gen, torch.device("cpu"))
    plan = gn.bwd_plan(*shape, inputs[0].element_size(), sms)
    if shape[1] > 100:
        assert plan.slabs > 1
    got = _emulate(*inputs, plan)
    res = kc.gn_backward_agreement(got, gn.groupnorm_silu_backward_plain(*inputs))
    assert res["ok"], res


def test_counters_are_zeroed_once_and_grow_on_demand():
    dev = torch.device("cpu")
    gn._bwd_counter_bufs.pop(dev, None)
    first = gn._bwd_counters(dev, 10)
    assert first.numel() >= 4096 and first.dtype == torch.int32 and not first.any()
    assert gn._bwd_counters(dev, 100) is first
    big = gn._bwd_counters(dev, 10000)
    assert big.numel() == 10000 and not big.any()
    gn._bwd_counter_bufs.pop(dev, None)


def test_plan_refuses_what_the_card_cannot_hold():
    with pytest.raises(ValueError):
        gn.bwd_plan(8, 10 ** 9, 128, 2, 1)


@pytest.mark.parametrize("shape", list(kc.FLAGSHIP_GN_SITES), ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_design_is_one_per_shape_by_the_plans_slabs(shape, dtype):
    """The wrapper's design: the one launch where its plan cuts a unit into
    at most BWD_ONE_LAUNCH_MAX_SLABS slabs, the two-pass design where it
    takes more; every flagship shape lies within the two-pass finish
    kernel's shared memory, so the slabs alone decide."""
    b, r, c = shape
    elem = DTYPES[dtype]
    assert 8 * b * (c // gn.NUM_GROUPS) <= 48 * 1024
    slabs = gn.bwd_plan(b, r, c, elem, SMS).slabs
    assert gn.bwd_design(b, r, c, elem, SMS) == (
        "one_launch" if slabs <= gn.BWD_ONE_LAUNCH_MAX_SLABS else "twopass")


def test_design_on_the_h100_at_the_flagships_bf16_shapes():
    """On 132 SMs the one launch takes every bf16 flagship shape up to 64^2
    but (8, 4096, 384), the two-pass design the rest: the picks that were
    the faster in every bf16 case timed on the card (PERF.md section 6)."""
    one = {s for s in kc.FLAGSHIP_GN_SITES if gn.bwd_design(*s, 2, SMS) == "one_launch"}
    assert one == {s for s in kc.FLAGSHIP_GN_SITES
                   if s[1] <= 4096 and s != (8, 4096, 384)}


def test_design_leaves_each_kernel_what_only_it_can_hold():
    # 8 * B * C / 32 bytes of group sums over 48 KB: only the one launch takes it
    assert gn.bwd_design(256, 65536, 1024, 2, SMS) == "one_launch"
    # more rows than one slab a CTA can hold on a one-SM card: no plan
    with pytest.raises(ValueError):
        gn.bwd_plan(8, 10 ** 6, 128, 2, 1)
    assert gn.bwd_design(8, 10 ** 6, 128, 2, 1) == "twopass"
    # C = 544: a group of 17 channels has no chunk of <= 128 channels
    assert gn.bwd_design(1, 64, 544, 2, SMS) == "twopass"
    assert gn.bwd_design(1, 17, 32, 4, SMS) == "one_launch"
