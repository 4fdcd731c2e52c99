"""What K1's design choices cost: variants of the bf16 tensor-core kernel,
timed against the kernel and `scaled_dot_product_attention` on the card.

    python -m nshmc_tpu_torch.scripts.attention_variants

It builds, in a temporary directory, copies of `csrc/attention.cu` that
differ in one line each:
  - `ex2_approx`: the softmax exp as `ex2.approx(x * log2 e)`, one SFU
    instruction, in place of the plain version's `expf` (~8 instructions);
  - `rows32`, `rows16`: 2 or 1 warps per block (32 or 16 query rows) in
    place of 4, for more blocks at small B * H * T;
  - `streamed`: K and V stream through the two-stage ring at every T, in
    place of staying in shared memory up to T = 256;
then, at the flagship's attention shapes (8, 64, 8, 64) and (8, 256, 8, 64)
and the latent U-Net's (8, 1024, 8, 32) in bf16, times the kernel, each copy
and SDPA (device ms per call from CUDA graphs) and holds each to the
plain version with the card check of `scripts/kernel_check.py`. One JSON
line per case. Needs a CUDA card and nvcc; the source tree is not written.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import tempfile

import torch

from ..ops import _build
from ..ops import attention as attn
from . import kernel_check as kc
from ._bench import card, resolve_device, time_s_graph

SHAPES = ((8, 64, 8, 64), (8, 256, 8, 64), (8, 1024, 8, 32))
EXACT_EXP = "__device__ __forceinline__ float softmax_exp(float x) { return expf(x); }"
APPROX_EXP = ('__device__ __forceinline__ float softmax_exp(float x) { float y; '
              'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f)); '
              'return y; }')
WARPS = "constexpr int TC_WARPS = 4;"
VARIANTS = {"ex2_approx": (EXACT_EXP, APPROX_EXP),
            "rows32": (WARPS, "constexpr int TC_WARPS = 2;"),
            "rows16": (WARPS, "constexpr int TC_WARPS = 1;"),
            "streamed": ("constexpr int TC_RES_MAX_T = 256;", "constexpr int TC_RES_MAX_T = 0;")}


def variant_source(name: str) -> str:
    """csrc/attention.cu with the variant's one line replaced."""
    with open(os.path.join(_build.CSRC, "attention.cu")) as f:
        src = f.read()
    old, new = VARIANTS[name]
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the line to replace is not in csrc/attention.cu: {old}")
    return src.replace(old, new)


def build_variant(name: str, tmp: str):
    """The variant's C launcher, compiled in `tmp` with the port's nvcc flags."""
    cu, so = os.path.join(tmp, f"attention_{name}.cu"), os.path.join(tmp, f"attention_{name}.so")
    with open(cu, "w") as f:
        f.write(variant_source(name))
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {name} copy:\n{r.stderr}")
    return attn.declare(ctypes.CDLL(so).nshmc_attention_fwd)


def main() -> list:
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        launchers = {"kernel": None, **{n: build_variant(n, tmp) for n in VARIANTS}}
        for shape in SHAPES:
            q, k, v = kc.qkv_inputs(shape, torch.bfloat16, gen, dev)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = 1e3 * time_s_graph(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, scale=1.0 / math.sqrt(shape[-1])))
            y_plain = attn.attention_plain(q, k, v)
            w = attn.attention_weights_plain(q, k, v.dtype)
            for name, fn in launchers.items():
                run = (lambda: attn.attention_forward(q, k, v)) if fn is None else \
                    (lambda: attn.launch(fn, q, k, v))
                res = kc.bf16_attention_agreement(run(), y_plain, w, v)
                ms = 1e3 * time_s_graph(run)
                rows.append({"variant": name, "shape": list(shape), "ms": ms, "sdpa_ms": sdpa,
                             "ms_over_sdpa": ms / sdpa, "agrees": res["ok"],
                             "frac_differ": res["frac_differ"]})
                print(json.dumps(rows[-1]))
    print(card(dev))
    return rows


if __name__ == "__main__":
    main()
