// GroupNorm + affine + SiLU backward (kernel K2c) for sm_90a.
//
// Replaces the custom-VJP backward `_gn_bwd` (nshmc_tpu/ops/groupnorm.py:150,
// an XLA recompute of `groupnorm_silu_xla` that XLA fuses). For x, g: (B, R, C)
// channels-last, the forward's statistics mean_c, inv_c: (B, C) fp32 and an
// fp32 affine gamma, beta of shape (C,) or (B, C), with G groups and
// N = R * C / G, it computes in fp32:
//
//   xh = (x - mean_c) * inv_c      a = xh * gamma + beta      s = sigmoid(a)
//   da = g * s * (1 + a * (1 - s))
//   dbeta_bc = sum_r da            dgamma_bc = sum_r da * xh
//   k1_bg = sum_{c in g} gamma_bc * dbeta_bc / N     k2_bg = likewise with dgamma
//   dx = inv_c * (gamma * da - (k1 + xh * k2))       -> x's dtype, rounded once
//
// and dgamma / dbeta per (b, c), or summed over b for a (C,) affine.
//
// What bounds it: bytes. The function reads x and g and writes dx: three
// passes over the activation (0.120 ms at (8, 65536, 128) bf16 at 3.35 TB/s).
// The reduction must finish before any dx can be written, and x and g
// (268 MB there) do not fit in shared memory or the 50 MB L2, so this design
// reads them twice: five passes, 0.200 ms. Its arithmetic (an expf and a
// division per element and pass, ~30 fp32 operations) stays below the byte
// time. Design, three launches and no host arithmetic between them:
//   1. `gn_bwd_partial_kernel`, the layout of the stats probe P1
//      (csrc/stream_probe.cu): a (row slab, batch) grid; C / VEC threads cover
//      one row with 16-byte loads (VEC = 8 bf16 or 4 fp32), each thread keeps
//      its channels' mean, inv, gamma, beta in registers and accumulates
//      [sum da, sum da * xh] over its rows with four 16-byte loads in flight;
//      the block reduces its row groups in shared memory and writes one fp32
//      partial per slab.
//   2. `gn_bwd_finish_kernel`, one block per group: a warp per (b, c) adds
//      the slabs, each lane a fixed strided subset and then a fixed shuffle
//      tree (no float atomics, the same bits on every run; the loads of one
//      channel are in flight together), forms dbeta, dgamma, k1 and k2, and
//      writes the affine gradients.
//   3. `gn_bwd_dx_kernel`, the layout of the apply probe P2: a grid-stride
//      loop over rows; a thread keeps its channels' six constants in
//      registers, and each row step is one 16-byte load of x and of g and one
//      16-byte store of dx (two rows per step). expf, not __expf, in sigmoid.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DX_BLOCKS_PER_SM = 4;

// ---- 16 bytes of T as fp32: 8 bf16 or 4 fp32 ----------------------------------

template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& v, float f[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower half holds the lower-address element
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 store(const float f[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& v, float f[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 store(const float f[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// C / VEC threads cover one row, THREADS / (C / VEC) rows per pass; a thread
// keeps the same VEC channels throughout.
template <int VEC> struct RowLayout {
  int cv, rpi, lane_c, r_off;
  __device__ explicit RowLayout(int C) {
    cv = C / VEC;
    rpi = THREADS / cv;
    lane_c = threadIdx.x % cv;
    r_off = threadIdx.x / cv;
  }
  __device__ bool active() const { return r_off < rpi; }
};

// The per-channel constants of the thread's VEC channels of batch element b.
template <int VEC> struct ChanConst {
  float m[VEC], iv[VEC], gm[VEC], bt[VEC];
  __device__ void load(const float* mean, const float* inv, const float* gamma,
                       const float* beta, int affine_sb, int b, int C, int c0) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      m[k] = mean[(int64_t)b * C + c0 + k];
      iv[k] = inv[(int64_t)b * C + c0 + k];
      gm[k] = gamma[(int64_t)b * affine_sb + c0 + k];
      bt[k] = beta[(int64_t)b * affine_sb + c0 + k];
    }
  }
};

// da = g * s * (1 + a * (1 - s)) at one element; returns da, sets xh
__device__ __forceinline__ float silu_grad(float x, float g, float m, float iv, float gm,
                                           float bt, float& xh) {
  xh = (x - m) * iv;
  const float a = xh * gm + bt;
  const float s = 1.f / (1.f + expf(-a));
  return g * s * (1.f + a * (1.f - s));
}

// ---- 1. slab partials [sum da, sum da * xh] per (b, slab, c) ------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_bwd_partial_kernel(const uint4* __restrict__ x, const uint4* __restrict__ g,
                      const float* __restrict__ mean, const float* __restrict__ inv,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      int affine_sb, float* __restrict__ part, int R, int C, int slab_rows,
                      int n_slabs) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float red1[THREADS * 8];  // [row group][channel]: rpi * C <= THREADS * VEC
  __shared__ float red2[THREADS * 8];
  const RowLayout<VEC> L(C);
  const int slab = blockIdx.x, b = blockIdx.y;
  const int r0 = slab * slab_rows, r1 = min(R, r0 + slab_rows);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  if (L.active()) {
    const int c0 = L.lane_c * VEC;
    ChanConst<VEC> cc;
    cc.load(mean, inv, gamma, beta, affine_sb, b, C, c0);
    const int64_t base = (int64_t)b * R * L.cv + L.lane_c;
    auto accumulate = [&](const uint4& xv, const uint4& gv) {
      float xf[VEC], gf[VEC];
      Vec<T>::load(xv, xf);
      Vec<T>::load(gv, gf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float xh;
        const float da = silu_grad(xf[k], gf[k], cc.m[k], cc.iv[k], cc.gm[k], cc.bt[k], xh);
        s1[k] += da;
        s2[k] = fmaf(da, xh, s2[k]);
      }
    };
    int r = r0 + L.r_off;
    for (; r + L.rpi < r1; r += 2 * L.rpi) {  // two rows of x and of g in flight
      const int64_t a0 = base + (int64_t)r * L.cv, a1 = a0 + (int64_t)L.rpi * L.cv;
      const uint4 x0 = __ldg(x + a0), x1 = __ldg(x + a1);
      const uint4 g0 = __ldg(g + a0), g1 = __ldg(g + a1);
      accumulate(x0, g0);
      accumulate(x1, g1);
    }
    if (r < r1) {
      const int64_t a0 = base + (int64_t)r * L.cv;
      accumulate(__ldg(x + a0), __ldg(g + a0));
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red1[L.r_off * C + c0 + k] = s1[k];
      red2[L.r_off * C + c0 + k] = s2[k];
    }
  }
  __syncthreads();
  float* __restrict__ out = part + ((int64_t)b * n_slabs + slab) * 2 * C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float a1 = 0.f, a2 = 0.f;
    for (int q = 0; q < L.rpi; ++q) {
      a1 += red1[q * C + c];
      a2 += red2[q * C + c];
    }
    out[c] = a1;
    out[C + c] = a2;
  }
}

// ---- 2. finish: slab sums, group terms, affine gradients -----------------------------
// One block per group; dynamic shared memory holds dbeta, dgamma of the
// group's (b, c) pairs. coef: (B, 2, G) = [k1, k2].

constexpr int FINISH_THREADS = 256;

__global__ void __launch_bounds__(FINISH_THREADS) gn_bwd_finish_kernel(const float* __restrict__ part,
                                     const float* __restrict__ gamma, int affine_sb,
                                     float* __restrict__ coef, float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int B, int C, int G, int n_slabs,
                                     float n) {
  extern __shared__ float sh[];
  const int grp = blockIdx.x, cg = C / G;
  float* sdb = sh;
  float* sdg = sh + B * cg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int i = warp; i < B * cg; i += n_warps) {
    const int b = i / cg, c = grp * cg + i % cg;
    const float* __restrict__ p = part + (int64_t)b * n_slabs * 2 * C + c;
    float d1 = 0.f, d2 = 0.f;
    for (int s = lane; s < n_slabs; s += 32) {
      d1 += p[(int64_t)s * 2 * C];
      d2 += p[(int64_t)s * 2 * C + C];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      d1 += __shfl_xor_sync(0xffffffffu, d1, off);
      d2 += __shfl_xor_sync(0xffffffffu, d2, off);
    }
    if (lane == 0) {
      sdb[i] = d1;
      sdg[i] = d2;
      if (affine_sb) {
        dbeta[(int64_t)b * C + c] = d1;
        dgamma[(int64_t)b * C + c] = d2;
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float k1 = 0.f, k2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      const float gm = gamma[(int64_t)b * affine_sb + grp * cg + j];
      k1 = fmaf(gm, sdb[b * cg + j], k1);
      k2 = fmaf(gm, sdg[b * cg + j], k2);
    }
    coef[((int64_t)b * 2) * G + grp] = k1 / n;
    coef[((int64_t)b * 2 + 1) * G + grp] = k2 / n;
  }
  if (!affine_sb) {  // a (C,) affine: its gradient sums over the batch
    for (int j = threadIdx.x; j < cg; j += blockDim.x) {
      float d1 = 0.f, d2 = 0.f;
      for (int b = 0; b < B; ++b) {
        d1 += sdb[b * cg + j];
        d2 += sdg[b * cg + j];
      }
      dbeta[grp * cg + j] = d1;
      dgamma[grp * cg + j] = d2;
    }
  }
}

// ---- 3. dx = inv * (gamma * da - (k1 + xh * k2)) ------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_bwd_dx_kernel(const uint4* __restrict__ x, const uint4* __restrict__ g,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 const float* __restrict__ gamma, const float* __restrict__ beta, int affine_sb,
                 const float* __restrict__ coef, uint4* __restrict__ dx, int R, int C, int G) {
  constexpr int VEC = Vec<T>::N;
  const RowLayout<VEC> L(C);
  if (!L.active()) return;
  const int b = blockIdx.y, c0 = L.lane_c * VEC, cg = C / G;
  ChanConst<VEC> cc;
  cc.load(mean, inv, gamma, beta, affine_sb, b, C, c0);
  float k1[VEC], k2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int grp = (c0 + k) / cg;
    k1[k] = coef[((int64_t)b * 2) * G + grp];
    k2[k] = coef[((int64_t)b * 2 + 1) * G + grp];
  }
  auto row = [&](const uint4& xv, const uint4& gv) {
    float xf[VEC], gf[VEC];
    Vec<T>::load(xv, xf);
    Vec<T>::load(gv, gf);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float xh;
      const float da = silu_grad(xf[k], gf[k], cc.m[k], cc.iv[k], cc.gm[k], cc.bt[k], xh);
      xf[k] = cc.iv[k] * (cc.gm[k] * da - (k1[k] + xh * k2[k]));
    }
    return Vec<T>::store(xf);
  };
  const int64_t base = (int64_t)b * R * L.cv + L.lane_c;
  const int stride = gridDim.x * L.rpi;
  int r = blockIdx.x * L.rpi + L.r_off;
  for (; r + stride < R; r += 2 * stride) {  // two rows of x and of g in flight
    const int64_t a0 = base + (int64_t)r * L.cv, a1 = a0 + (int64_t)stride * L.cv;
    const uint4 x0 = __ldg(x + a0), x1 = __ldg(x + a1);
    const uint4 g0 = __ldg(g + a0), g1 = __ldg(g + a1);
    dx[a0] = row(x0, g0);
    dx[a1] = row(x1, g1);
  }
  if (r < R) {
    const int64_t a0 = base + (int64_t)r * L.cv;
    dx[a0] = row(__ldg(x + a0), __ldg(g + a0));
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const float* mean, const float* inv,
                   const float* gamma, const float* beta, int affine_sb, float* part,
                   float* coef, void* dx, float* dgamma, float* dbeta, int B, int R, int C,
                   int G, int slab_rows, cudaStream_t st) {
  constexpr int VEC = Vec<T>::N;
  const int n_slabs = (R + slab_rows - 1) / slab_rows;
  gn_bwd_partial_kernel<T><<<dim3(n_slabs, B), THREADS, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(g), mean, inv, gamma, beta,
      affine_sb, part, R, C, slab_rows, n_slabs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int cg = C / G;
  gn_bwd_finish_kernel<<<G, FINISH_THREADS, 2 * B * cg * sizeof(float), st>>>(
      part, gamma, affine_sb, coef, dgamma, dbeta, B, C, G, n_slabs, (float)R * (float)cg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rpi = THREADS / (C / VEC);
  const int row_steps = (R + rpi - 1) / rpi;
  const int want = (sm_count() * DX_BLOCKS_PER_SM + B - 1) / B;
  gn_bwd_dx_kernel<T><<<dim3(row_steps < want ? row_steps : want, B), THREADS, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(g), mean, inv, gamma, beta,
      affine_sb, coef, static_cast<uint4*>(dx), R, C, G);
  return cudaGetLastError();
}

}  // namespace

// x, g, dx: contiguous (B, R, C), 16-byte aligned, dtype 0 = float32 or
// 1 = bfloat16, C a multiple of 8 and of G with C / VEC <= 256. mean, inv:
// (B, C) fp32. gamma, beta: fp32, (C,) with affine_sb = 0 or (B, C) with
// affine_sb = C; dgamma, dbeta have the same shape. part: fp32 scratch of
// (B, ceil(R / slab_rows), 2, C); coef: fp32 scratch of (B, 2, G). The finish
// kernel takes 8 * B * C / G bytes of shared memory (at most 48 KB).
// Returns the first cudaError_t of the three launches (0 on success).
extern "C" int nshmc_gn_bwd(const void* x, const void* g, const void* mean, const void* inv,
                            const void* gamma, const void* beta, int affine_sb, void* part,
                            void* coef, void* dx, void* dgamma, void* dbeta, int dtype, int B,
                            int R, int C, int G, int slab_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mean);
  const auto* iv = static_cast<const float*>(inv);
  const auto* gm = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  auto* pt = static_cast<float*>(part);
  auto* cf = static_cast<float*>(coef);
  auto* dg = static_cast<float*>(dgamma);
  auto* db = static_cast<float*>(dbeta);
  if (dtype == 0)
    return launch<float>(x, g, m, iv, gm, bt, affine_sb, pt, cf, dx, dg, db, B, R, C, G,
                         slab_rows, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, m, iv, gm, bt, affine_sb, pt, cf, dx, dg, db, B, R, C,
                                 G, slab_rows, st);
  return cudaErrorInvalidValue;
}
