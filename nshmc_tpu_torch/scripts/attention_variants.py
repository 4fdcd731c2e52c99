"""What K1's design choices cost: variants of its kernels, timed against
the kernel and `scaled_dot_product_attention` on the card.

    python -m nshmc_tpu_torch.scripts.attention_variants [--f32-only]

It builds, in a temporary directory, copies of `csrc/attention.cu` that
differ in a line or two each:
  - `ex2_approx`: the bf16 softmax exp as `ex2.approx(x * log2 e)`, one SFU
    instruction, in place of the plain version's `expf` (~8 instructions);
  - `rows32`, `rows16`: 2 or 1 warps per block (32 or 16 query rows) in
    place of 4, for more blocks at small B * H * T;
  - `streamed`: every T takes the bf16 kernel's long-sequence design (TMA,
    wgmma), in place of the resident one up to T = 256;
  - `long_expf`: the long-sequence design's exp as the plain version's
    `expf`, in place of `ex2.approx` of (s - m) log2 e;
  - `f32_exp2f`: the f32 kernel's exp as the accurate `exp2f` in place of
    `ex2.approx`;
  - `f32_rows16`, `f32_rows32`: a warp takes 16 query rows at every T, or
    32 at every T (ch <= 32), in place of 32 from T = 256 on;
  - two diagnostics that compute wrong results on purpose, to show what a
    part costs: `diag_1xtf32` drops the two lo products of each 3xTF32
    product, `diag_no_split` the K/V split;
and `f32_scalar`, the scalar-FMA f32 kernel that K1 ran in f32 before the
3xTF32 one (two passes, 4 threads a query row, 32-key tiles; its own
source, `SCALAR_F32_SOURCE`). Then, at the flagship's attention shapes
(8, 64, 8, 64) and (8, 256, 8, 64), the latent U-Net's (8, 1024, 8, 32) and
Stable Diffusion's (8, 1024, 10, 64) and (8, 4096, 5, 64) in bf16, and at the five f32 shapes of the paths (the flagship's two, the
latent U-Net's three), it times the kernel, each copy of its dtype, the
plain version and SDPA (device ms per call from CUDA graphs, TF32 off) and
holds each to the plain version with the card check of
`scripts/kernel_check.py`. One JSON line per case. `--f32-only` runs the
f32 cases alone. Needs a CUDA card and nvcc; the source tree is not
written.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

import torch

from ..ops import _build
from ..ops import attention as attn
from . import kernel_check as kc
from ._bench import card, resolve_device, time_s_graph

SHAPES = ((8, 64, 8, 64), (8, 256, 8, 64), (8, 1024, 8, 32), (8, 1024, 10, 64), (8, 4096, 5, 64))
F32_SHAPES = ((8, 64, 8, 64), (8, 256, 8, 64), *kc.LATENT_ATTN_SHAPES)
EXACT_EXP = "__device__ __forceinline__ float softmax_exp(float x) { return expf(x); }"
APPROX_EXP = ('__device__ __forceinline__ float softmax_exp(float x) { float y; '
              'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f)); '
              'return y; }')
WARPS = "constexpr int TC_WARPS = 4;"
LONG_EXP = ("__device__ __forceinline__ float long_exp(float s, float m) "
            "{ return sfu_exp2((s - m) * LOG2E); }")
VARIANTS = {"ex2_approx": (EXACT_EXP, APPROX_EXP),
            "rows32": (WARPS, "constexpr int TC_WARPS = 2;"),
            "rows16": (WARPS, "constexpr int TC_WARPS = 1;"),
            "streamed": ("constexpr int TC_RES_MAX_T = 256;", "constexpr int TC_RES_MAX_T = 0;"),
            "long_expf": (LONG_EXP, "__device__ __forceinline__ float long_exp(float s, float m) "
                                    "{ return expf(s - m); }")}
MT2 = "constexpr int F32_MT2_MIN_T = 256;"
F32_VARIANTS = {"f32_exp2f": ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                              "y = exp2f(x);"),
                "f32_rows16": (MT2, "constexpr int F32_MT2_MIN_T = 1 << 30;"),
                "f32_rows32": (MT2, "constexpr int F32_MT2_MIN_T = 0;"),
                "diag_1xtf32": ("  mma_tf32(d, alo, bh0, bh1);\n  mma_tf32(d, ahi, bl0, bl1);\n", ""),
                "diag_no_split": ("    if (u < CPT) f32_split_chunk<CH>(tile_at(stage, 0), tile_at(stage, 1), scale, u);\n"
                                  "    else f32_split_chunk<CH>(tile_at(stage, 2), tile_at(stage, 3), 1.f, u - CPT);\n",
                                  "")}

# The scalar-FMA f32 kernel K1 ran before the 3xTF32 one, with the
# interface of `nshmc_attention_fwd` (dtype 0 only): one block of 256
# threads per (batch * head, 64-query tile), 4 threads a query row, K and V
# through shared memory in 32-key tiles, two passes over the keys.
SCALAR_F32_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
namespace {
constexpr int BQ = 64, BK = 32, TPR = 4, THREADS = BQ * TPR, KPT = BK / TPR;

template <int CH, int PITCH>
__device__ void load_tile(float (*dst)[PITCH], const float* __restrict__ src, int k0,
                          int t_len, int64_t st, float scale) {
  for (int e = threadIdx.x; e < BK * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    dst[r][c] = k0 + r < t_len ? src[(int64_t)(k0 + r) * st + c] * scale : 0.f;
  }
}

template <int CH>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int t_len, int heads,
                int64_t sb, int64_t st, int64_t sh, float scale) {
  __shared__ float ks[BK][CH + 1];
  __shared__ float vs[BK][CH];
  __shared__ float ws[BQ][BK + 1];
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int qi = blockIdx.x * BQ + row;
  const bool qvalid = qi < t_len;
  const int64_t base = (int64_t)b * sb + (int64_t)h * sh;
  float qr[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) qr[c] = qvalid ? q[base + (int64_t)qi * st + c] * scale : 0.f;
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();
    load_tile<CH, CH + 1>(ks, k + base, k0, t_len, st, scale);
    __syncthreads();
    float s[KPT], tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = sub + TPR * j;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc = fmaf(qr[c], ks[kk][c], acc);
      s[j] = k0 + kk < t_len ? acc : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    if (tmax > -INFINITY) {
      const float mn = fmaxf(m, tmax);
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) add += expf(s[j] - mn);
      l = (m > -INFINITY ? l * expf(m - mn) : 0.f) + add;
      m = mn;
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    l = (m > -INFINITY ? l * expf(m - mn) : 0.f) + (mo > -INFINITY ? lo * expf(mo - mn) : 0.f);
    m = mn;
  }
  float acc[CH / TPR];
#pragma unroll
  for (int i = 0; i < CH / TPR; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();
    load_tile<CH, CH + 1>(ks, k + base, k0, t_len, st, scale);
    load_tile<CH, CH>(vs, v + base, k0, t_len, st, 1.f);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = sub + TPR * j;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) dot = fmaf(qr[c], ks[kk][c], dot);
      ws[row][kk] = k0 + kk < t_len ? expf(dot - m) / l : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float w = ws[row][kk];
#pragma unroll
      for (int i = 0; i < CH / TPR; ++i) acc[i] = fmaf(w, vs[kk][sub + TPR * i], acc[i]);
    }
  }
  if (qvalid) {
    float* ob = o + (((int64_t)b * t_len + qi) * heads + h) * CH;
#pragma unroll
    for (int i = 0; i < CH / TPR; ++i) ob[sub + TPR * i] = acc[i];
  }
}
}  // namespace

extern "C" int nshmc_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int t_len, int heads, int ch,
                                   long long sb, long long st, long long sh, float scale,
                                   void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  const dim3 grid((t_len + BQ - 1) / BQ, B * heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  switch (ch) {
    case 16: attn_fwd_kernel<16><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, t_len, heads, sb, st, sh, scale); break;
    case 32: attn_fwd_kernel<32><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, t_len, heads, sb, st, sh, scale); break;
    case 64: attn_fwd_kernel<64><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, t_len, heads, sb, st, sh, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
"""


def variant_source(name: str) -> str:
    """csrc/attention.cu with the variant's one line replaced, or the old
    scalar f32 kernel's own source."""
    if name == "f32_scalar":
        return SCALAR_F32_SOURCE
    with open(os.path.join(_build.CSRC, "attention.cu")) as f:
        src = f.read()
    old, new = {**VARIANTS, **F32_VARIANTS}[name]
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


def time_cases(shapes, dtype, launchers, gen, dev) -> list:
    """Each launcher (None: the port's kernel through its wrapper) at each
    shape in `dtype`, beside the plain version and SDPA: one record each."""
    rows = []
    for shape in shapes:
        q, k, v = kc.qkv_inputs(shape, dtype, gen, dev)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = 1e3 * time_s_graph(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=1.0 / math.sqrt(shape[-1])))
        plain = 1e3 * time_s_graph(lambda: attn.attention_plain(q, k, v))
        y_plain = attn.attention_plain(q, k, v)
        w = attn.attention_weights_plain(q, k, v.dtype)
        for name, fn in launchers.items():
            run = (lambda: attn.attention_forward(q, k, v)) if fn is None else \
                (lambda: attn.launch(fn, q, k, v))
            y = run()
            if dtype == torch.float32:
                err = float((y - y_plain).abs().max())
                res = {"ok": err <= 1e-4, "max_abs_err": err}
            else:
                res = kc.bf16_attention_agreement(y, y_plain, w, v)
            ms = 1e3 * time_s_graph(run)
            rows.append({"variant": name, "dtype": str(dtype).split(".")[1], "shape": list(shape),
                         "ms": ms, "plain_ms": plain, "sdpa_ms": sdpa, "ms_over_sdpa": ms / sdpa,
                         "agrees": res["ok"], "max_abs_err": res["max_abs_err"],
                         **({"frac_differ": res["frac_differ"]} if "frac_differ" in res else {})})
            print(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> list:
    f32_only = "--f32-only" in (sys.argv[1:] if argv is None else argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        if not f32_only:
            rows += time_cases(SHAPES, torch.bfloat16, {
                "kernel": None, **{n: build_variant(n, tmp) for n in VARIANTS}}, gen, dev)
        rows += time_cases(F32_SHAPES, torch.float32, {
            "kernel": None, **{n: build_variant(n, tmp) for n in (*F32_VARIANTS, "f32_scalar")}},
            gen, dev)
    print(card(dev))
    return rows


if __name__ == "__main__":
    main()
