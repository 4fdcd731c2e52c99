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
// What bounds it: bytes, then arithmetic. The function reads x and g and
// writes dx: three passes over the activation (0.120 ms at (8, 65536, 128)
// bf16 at 3.35 TB/s). Its arithmetic is an accurate expf and a division per
// element: evaluated twice per element (once for the sums, once for dx), as
// the two-pass design does, it alone took longer than the five-pass byte
// floor on the card, so the one-launch design evaluates it once and keeps da. The
// reduction over all R rows must finish before any dx can be written, and x
// and g of one batch element (67 MB at (8, 65536, 256)) fit in neither the
// 50 MB L2 nor the ~30 MB of shared memory of all SMs together; a narrower
// piece does.
//
// Two designs; the wrapper (ops/groupnorm.py::bwd_design) takes the one that
// is faster on the card at the call's shape (both timed at the flagship's
// shapes by nshmc_tpu_torch/scripts/groupnorm_bwd_variants.py).
//
// `nshmc_gn_bwd`: ONE launch that reads x and g from device memory once and
// keeps x and da on chip between the reduction and the dx pass.
//   - Unit of work: a (batch element, channel chunk) pair, CK channels wide
//     (a multiple of the group size and of the 16-byte vector, >= 64 bytes of
//     a row). Its R rows are cut into S slabs of whole boxes; one CTA holds
//     one slab: x (rows x CK, x's type) and da (rows x CK, fp32).
//   - Grid: Q * S CTAs, launched cooperatively so that all are resident (a
//     grid that cannot be is refused, never left to spin). CTA (q, s) takes
//     slab s of units q, q + Q, q + 2Q, ... (its units k = 0, 1, ...): Q
//     units are in flight at once, each spread over S CTAs.
//   - Two slab buffers of x and g a CTA, and one of da: unit k is reduced,
//     handed off and written from buffer k % 2 while unit k + 1 lands in the
//     other, so bytes keep moving through the handoff's wait and the
//     arithmetic. Unit k + 2's g goes into buffer k % 2 once unit k's
//     reduction has read it (before the handoff), its x once unit k's dx is
//     written.
//   - Loads: thread 0 issues 3-D TMA box copies of x and of g (CK x box_rows
//     x 1 of (C, R, B), up to 8 boxes of ~128 rows a slab, one mbarrier a
//     box; rows past R come back as zeros). The unit's per-channel mean,
//     inv, gamma, beta go to shared memory while the CTA waits at the
//     previous handoff.
//   - Reduction: da is computed once per element as each box lands, kept in
//     shared memory in fp32, and summed to per-channel fp32
//     [sum da, sum da * xh] (16-byte shared loads, a block reduction in a
//     fixed order), then folded into per-group terms sum_c gamma_c * (.).
//   - Handoff per unit: each CTA writes its slab's terms to global scratch
//     and arrives on the unit's integer counter (atom.acq_rel; the waiter's
//     ld.acquire). Once all S slabs have arrived, every CTA of the unit adds
//     their group terms in slab order, so all get the same bits. With S = 1
//     (the small sites) there is no handoff at all. The counters reset
//     themselves in the kernel: no memset launch.
//   - dx from x and da in shared memory (no second expf), 16-byte streaming
//     global stores.
//   - Affine gradients, off the per-unit path: after its last unit each CTA
//     adds per-channel slab partials in slab order, one warp per value
//     (lanes strided, then a fixed shuffle tree). A (C,) affine sums them
//     over b after one grid barrier, in batch order. No float atomics: the
//     same bits on every run.
//   What it reaches, and what holds it back, is in PERF.md: where a unit
//   spans the whole grid (the 128^2 and 256^2 sites), the per-unit handoff
//   across all CTAs, and a streaming part that moves well under the card's
//   bytes (64-byte row pieces, 16 warps an SM, one unit at a time).
//
// `nshmc_gn_bwd_twopass`: reads x and g twice (five passes, 0.200 ms at the
// hot shape) and evaluates da twice, in three launches and no host arithmetic
// between them:
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
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
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
cudaError_t launch_twopass(const void* x, const void* g, const float* mean, const float* inv,
                           const float* gamma, const float* beta, int affine_sb, float* part,
                           float* coef, void* dx, float* dgamma, float* dbeta, int B, int R,
                           int C, int G, int slab_rows, cudaStream_t st) {
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

// ---- the one-launch design (see the header) ----------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_WARPS = F_THREADS / 32;
constexpr int F_MAX_V = 512;  // values of a unit's reduction: 2 * CK <= 512
constexpr int F_ALIGN = 128;  // TMA box destinations are 128-byte aligned
constexpr int F_MAX_BOX = 8;  // TMA boxes a slab
constexpr int F_BUFS = 2;     // slab buffers a CTA

struct FusedArgs {
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
  int affine_sb;
  const void* g;
  void* dx;
  float* dgamma;
  float* dbeta;
  // scratch, fp32: partc (U, S, 2 CK) per-channel slab sums | partg (U, S, 2 NG)
  // per-group slab terms | affb (B, 2, C) a (C,) affine's per-b gradients.
  // counters, int32: arrive (U) | done (U) | grid barrier (2)
  float* scratch;
  int* counters;
  int B, R, C, G, ck, S, Q, box_rows, n_box;
};

constexpr int F_MAX_CK = F_MAX_V / 4;  // channels a unit
constexpr int F_SMALL_V = 256;  // red3 (<= F_THREADS values) and kk (2 groups' terms <= 2 CK)
// dynamic shared memory of the layout below for slabs of `slab_elems`
// elements of `elem` bytes: alignment slack, two buffers of a slab of x and
// of g, the slab's da in fp32, the block reduction's rows, red3, sums, kk,
// two sets of a unit's per-channel mean, inv, gamma, beta, and an
// mbarrier for each box of x and of g of each buffer
__host__ __device__ constexpr int fused_smem(int vec, int elem, int slab_elems) {
  return F_ALIGN + F_BUFS * 2 * slab_elems * elem + slab_elems * 4 + F_THREADS * vec * 4 +
         (F_MAX_V + 2 * F_SMALL_V) * 4 + F_BUFS * 4 * F_MAX_CK * 4 + F_BUFS * 2 * F_MAX_BOX * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// one 3-D box (channels, rows, batch) of a tensor map into shared memory
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c, int r,
                                        int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(b), "r"(bar)
      : "memory");
}

// *p += v with release and acquire semantics at gpu scope; returns the old value
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// thread 0, after a bar.sync of its CTA: publish the CTA's earlier global
// writes, then add v to *p (the release half of a handoff)
__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// No wait spins forever: one that outlasts ~2^34 cycles (~10 s) traps, and
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void spin_guard(long long start) {
  if (clock64() - start > (1LL << 34)) __trap();
}

// thread 0: wait until *p >= target (the acquire half; a bar.sync after it
// passes what it saw to the CTA)
__device__ __forceinline__ void wait_at_least(const int* p, int target) {
  for (const long long t0 = clock64(); ld_acquire(p) < target; spin_guard(t0)) __nanosleep(32);
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS, 2)
gn_bwd_fused_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tg, const FusedArgs a) {
  constexpr int VEC = Vec<T>::N;
  constexpr int ELEM = sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((F_ALIGN - (smem_addr(smem_raw) & (F_ALIGN - 1))) & (F_ALIGN - 1));
  const int ck = a.ck, S = a.S, Q = a.Q, R = a.R, C = a.C;
  const int cg = C / a.G, ng = ck / cg, nchunks = C / ck, U = a.B * nchunks;
  const int V1 = 2 * ck, V2 = 2 * ng;
  const int box_rows = a.box_rows, SR = box_rows * a.n_box;
  const int box_bytes = box_rows * ck * ELEM, slab_bytes = SR * ck * ELEM;
  // buffer f: x (SR, CK) at base + 2 f slab_bytes, g (SR, CK) right after it
  float* das = reinterpret_cast<float*>(base + F_BUFS * 2 * slab_bytes);  // (SR, CK) fp32
  float* red = das + SR * ck;
  float* red3 = red + F_THREADS * VEC;
  float* sums = red3 + F_SMALL_V;
  float* kk = sums + F_MAX_V;  // [k1 of each group, k2 of each group] of the current unit
  float* cst = kk + F_SMALL_V;  // [unit parity][mean, inv, gamma, beta][channel]
  uint64_t* bars = reinterpret_cast<uint64_t*>(cst + F_BUFS * 4 * F_MAX_CK);  // [buf][x, g][box]

  float* partc = a.scratch;
  float* partg = partc + (int64_t)U * S * V1;
  float* affb = partg + (int64_t)U * S * V2;
  int* arrive = a.counters;
  int* done = arrive + U;
  int* gbar = done + U;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s = blockIdx.x % S, q = blockIdx.x / S;
  const int nk = q < U ? (U - q + Q - 1) / Q : 0;  // this CTA's units: q, q + Q, ...
  const int r_lo = s * SR, rows = min(SR, R - r_lo);
  const int n_issue = (rows + box_rows - 1) / box_rows;  // boxes that start inside the tensor
  const float n = (float)R * (float)cg;
  const int cvk = ck / VEC, rpi = F_THREADS / cvk;  // a thread keeps VEC channels of a row
  const int c_in = (tid % cvk) * VEC, r_off = tid / cvk;
  const bool active = r_off < rpi;
  const int row_v = C / VEC;  // 16-byte vectors per row of dx
  // this thread's first row in box i: rows r_off, r_off + rpi, ... of the slab
  auto first_row = [&](int i) {
    const int r0 = i * box_rows;
    return r0 <= r_off ? r_off : r_off + (r0 - r_off + rpi - 1) / rpi * rpi;
  };
  // which = 0: x, 1: g of this CTA's unit k, in buffer k % 2
  auto slab_of = [&](int k, int which) { return base + ((k & 1) * 2 + which) * slab_bytes; };
  auto bar_of = [&](int k, int which, int i) {
    return smem_addr(&bars[((k & 1) * 2 + which) * F_MAX_BOX + i]);
  };

  // affine gradient value v of unit u: v < ck is dbeta, else dgamma, of channel v % ck
  auto put_affine = [&](int u, int v, float val) {
    const int b = u / nchunks, c = (u % nchunks) * ck + v % ck, which = v / ck;
    if (a.affine_sb)
      (which ? a.dgamma : a.dbeta)[(int64_t)b * C + c] = val;
    else
      affb[((int64_t)b * 2 + which) * C + c] = val;
  };
  // thread 0: the TMA box i of x (which = 0) or g (1) of unit k into its buffer
  auto load_box = [&](int k, int which, int i) {
    const int u = q + k * Q, b = u / nchunks, cb = (u % nchunks) * ck;
    const uint32_t bi = bar_of(k, which, i);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bi), "r"((uint32_t)box_bytes) : "memory");
    // the parameters' own addresses (grid constants)
    tma_box(smem_addr(slab_of(k, which) + i * box_bytes), which ? &tg : &tx, cb,
            r_lo + i * box_rows, b, bi);
  };
  // unit k's mean, inv, gamma, beta of its CK channels into the set k % 2
  // (plain loads: issued where the CTA waits anyway)
  auto load_consts = [&](int k) {
    const int u = q + k * Q, b = u / nchunks, cb = (u % nchunks) * ck;
    for (int t = tid; t < 4 * ck; t += F_THREADS) {
      const int which = t / ck, c = cb + t % ck;
      const float* src = which == 0 ? a.mean : which == 1 ? a.inv : which == 2 ? a.gamma : a.beta;
      const int64_t row = which < 2 ? (int64_t)b * C : (int64_t)b * a.affine_sb;
      cst[((k & 1) * 4 + which) * F_MAX_CK + t % ck] = __ldg(src + row + c);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < F_BUFS * 2 * F_MAX_BOX; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&bars[i]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < min(nk, F_BUFS); ++k)
      for (int i = 0; i < n_issue; ++i) {
        load_box(k, 0, i);
        load_box(k, 1, i);
      }
  if (nk > 0) load_consts(0);
  __syncthreads();

  for (int k = 0; k < nk; ++k) {
    const int u = q + k * Q, b = u / nchunks, cb = (u % nchunks) * ck;
    const T* xs = reinterpret_cast<const T*>(slab_of(k, 0));
    const T* gs = reinterpret_cast<const T*>(slab_of(k, 1));
    const float* cu = cst + (k & 1) * 4 * F_MAX_CK;
    ChanConst<VEC> cc;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      cc.m[j] = cu[c_in + j];
      cc.iv[j] = cu[F_MAX_CK + c_in + j];
      cc.gm[j] = cu[2 * F_MAX_CK + c_in + j];
      cc.bt[j] = cu[3 * F_MAX_CK + c_in + j];
    }
    // gamma of value tid's channel, for the group terms
    const float gv = tid < V1 ? cu[2 * F_MAX_CK + tid % ck] : 0.f;
    const uint32_t parity = (k >> 1) & 1;

    // 1. da once per element, box by box as the boxes land, kept in shared
    //    memory in fp32 for the dx pass, and the slab's [sum da, sum da * xh]
    //    per channel
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
    for (int i = 0; i < n_issue; ++i) {
      for (const long long t0 = clock64(); !mbar_try_wait(bar_of(k, 0, i), parity);)
        spin_guard(t0);
      for (const long long t0 = clock64(); !mbar_try_wait(bar_of(k, 1, i), parity);)
        spin_guard(t0);
      if (!active) continue;
      const int r1 = min(rows, (i + 1) * box_rows);
#pragma unroll 2
      for (int r = first_row(i); r < r1; r += rpi) {
        float xf[VEC], gf[VEC];
        Vec<T>::load(*reinterpret_cast<const uint4*>(xs + r * ck + c_in), xf);
        Vec<T>::load(*reinterpret_cast<const uint4*>(gs + r * ck + c_in), gf);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float xh;
          gf[j] = silu_grad(xf[j], gf[j], cc.m[j], cc.iv[j], cc.gm[j], cc.bt[j], xh);
          s1[j] += gf[j];
          s2[j] = fmaf(gf[j], xh, s2[j]);
        }
        float* dr = das + r * ck + c_in;
#pragma unroll
        for (int j = 0; j < VEC; j += 4)
          *reinterpret_cast<float4*>(dr + j) = make_float4(gf[j], gf[j + 1], gf[j + 2], gf[j + 3]);
      }
    }
    // 2. block reduction in a fixed order: the lanes of a warp that hold the
    //    same channels by a shuffle tree, then the warps in order; where a
    //    row's threads straddle warps, the row groups in two stages. Then
    //    sums = [sum da, sum da * xh, gamma * sum da, gamma * sum da * xh].
    if (32 % cvk == 0 && F_WARPS * V1 <= F_THREADS * VEC) {
      for (int off = cvk; off < 32; off <<= 1) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
          s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
        }
      }
      if (lane < cvk) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          red[warp * V1 + c_in + j] = s1[j];
          red[warp * V1 + ck + c_in + j] = s2[j];
        }
      }
      __syncthreads();
      if (tid < V1) {
        float acc = 0.f;
        for (int w = 0; w < F_WARPS; ++w) acc += red[w * V1 + tid];
        sums[tid] = acc;
        sums[V1 + tid] = gv * acc;
      }
      __syncthreads();
    } else {
      const int nq = max(1, F_THREADS / ck);
      for (int half = 0; half < 2; ++half) {
        if (active) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) red[r_off * ck + c_in + j] = half ? s2[j] : s1[j];
        }
        __syncthreads();
        for (int i = tid; i < ck * nq; i += F_THREADS) {
          const int v = i % ck, qq = i / ck;
          float acc = 0.f;
          for (int rr = qq; rr < rpi; rr += nq) acc += red[rr * ck + v];
          red3[qq * ck + v] = acc;
        }
        __syncthreads();
        for (int v = tid; v < ck; v += F_THREADS) {
          float acc = 0.f;
          for (int qq = 0; qq < nq; ++qq) acc += red3[qq * ck + v];
          sums[half * ck + v] = acc;
        }
        __syncthreads();
      }
      if (tid < V1) sums[V1 + tid] = gv * sums[tid];
      __syncthreads();
    }
    // every thread is done with g of unit k: its buffer takes unit k + 2's g
    // now, ahead of the handoff
    if (tid == 0 && k + F_BUFS < nk) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int i = 0; i < n_issue; ++i) load_box(k + F_BUFS, 1, i);
    }

    // 3. the slab's group terms sum_{c in group} gamma_c * (.), k1's before
    //    k2's; with one slab they are the unit's k1, k2 (times n)
    for (int v = tid; v < V2; v += F_THREADS) {
      const int grp = v % ng, which = v / ng;
      const float* sv = sums + V1 + which * ck + grp * cg;  // gamma_c * (.), the group's
      float acc = 0.f;
      for (int i = 0; i < cg; ++i) acc += sv[i];
      if (S == 1)
        kk[v] = acc / n;
      else
        partg[((int64_t)u * S + s) * V2 + v] = acc;
    }
    for (int v = tid; v < V1; v += F_THREADS) {
      if (S == 1)
        put_affine(u, v, sums[v]);
      else
        partc[((int64_t)u * S + s) * V1 + v] = sums[v];
    }
    __syncthreads();
    // the next unit's constants, loaded while thread 0 is at the handoff
    if (k + 1 < nk) load_consts(k + 1);
    if (S > 1) {
      // 4. handoff: every CTA arrives and waits until all S slabs have,
      //    then adds the unit's group terms in slab order (the same bits in
      //    every CTA). Once every CTA has passed its wait, the last to pass
      //    resets the unit's counters.
      if (tid == 0) {
        atom_add_acq_rel(arrive + u, 1);
        wait_at_least(arrive + u, S);
      }
      __syncthreads();
      const int nq2 = max(1, F_THREADS / V2);
      for (int i = tid; i < V2 * nq2; i += F_THREADS) {
        const int v = i % V2, qq = i / V2;
        const float* p = partg + (int64_t)u * S * V2 + v;
        float acc = 0.f;
#pragma unroll 16
        for (int s2 = qq; s2 < S; s2 += nq2) acc += __ldcg(p + (int64_t)s2 * V2);
        red3[qq * V2 + v] = acc;
      }
      __syncthreads();
      for (int v = tid; v < V2; v += F_THREADS) {
        float acc = 0.f;
        for (int qq = 0; qq < nq2; ++qq) acc += red3[qq * V2 + v];
        kk[v] = acc / n;
      }
      if (tid == 0 && atomicAdd(done + u, 1) == S - 1) {  // all of u are past the wait
        atomicExch(arrive + u, 0);
        atomicExch(done + u, 0);
      }
    }
    __syncthreads();

    // 5. dx from x and da in shared memory (no second transcendental pass);
    //    then x's boxes, once every thread is done with them, take unit
    //    k + 2's
    float k1[VEC], k2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int grp = (c_in + j) / cg;
      k1[j] = kk[grp];
      k2[j] = kk[ng + grp];
    }
    uint4* out = static_cast<uint4*>(a.dx) + ((int64_t)b * R + r_lo) * row_v + (cb + c_in) / VEC;
    if (active) {
#pragma unroll 2
      for (int r = r_off; r < rows; r += rpi) {
        float xf[VEC], da[VEC];
        const float* dr = das + r * ck + c_in;
        Vec<T>::load(*reinterpret_cast<const uint4*>(xs + r * ck + c_in), xf);
#pragma unroll
        for (int j = 0; j < VEC; j += 4) {
          const float4 d4 = *reinterpret_cast<const float4*>(dr + j);
          da[j] = d4.x;
          da[j + 1] = d4.y;
          da[j + 2] = d4.z;
          da[j + 3] = d4.w;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xf[j] - cc.m[j]) * cc.iv[j];
          xf[j] = cc.iv[j] * (cc.gm[j] * da[j] - (k1[j] + xh * k2[j]));
        }
        __stcs(out + (int64_t)r * row_v, Vec<T>::store(xf));
      }
    }
    __syncthreads();  // x, kk, the constants of unit k + 1 and da are free
    if (tid == 0 && k + F_BUFS < nk) {  // x's boxes take unit k + 2's
      // order the CTA's generic reads of x before the async-proxy writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int i = 0; i < n_issue; ++i) load_box(k + F_BUFS, 0, i);
    }
  }

  // 6. affine gradients of this CTA's units from the per-channel slab sums
  //    (S > 1), off the per-unit path: a warp per value, lanes over slabs, a
  //    fixed shuffle tree. This CTA acquired every one of its units' arrivals,
  //    so their partials are visible.
  if (S > 1) {
    for (int i = s * F_WARPS + warp; i < nk * V1; i += S * F_WARPS) {
      const int u = q + (i / V1) * Q, v = i % V1;
      const float* p = partc + (int64_t)u * S * V1 + v;
      float acc = 0.f;
      for (int s2 = lane; s2 < S; s2 += 32) acc += __ldcg(p + (int64_t)s2 * V1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) put_affine(u, v, acc);
    }
  }
  if (!a.affine_sb) {  // a (C,) affine: one grid barrier, then the sum over b in batch order
    __syncthreads();
    if (tid == 0) {
      red_release(gbar, 1);
      wait_at_least(gbar, (int)gridDim.x);
    }
    __syncthreads();
    for (int i = blockIdx.x * F_THREADS + tid; i < 2 * C; i += gridDim.x * F_THREADS) {
      const int which = i / C, c = i % C;
      float acc = 0.f;
      for (int bb = 0; bb < a.B; ++bb) acc += __ldcg(affb + ((int64_t)bb * 2 + which) * C + c);
      (which ? a.dgamma : a.dbeta)[c] = acc;
    }
    if (tid == 0 && atomicAdd(gbar + 1, 1) == (int)gridDim.x - 1) {  // all are past the barrier
      atomicExch(gbar, 0);
      atomicExch(gbar + 1, 0);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &res);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// channels-last (B, R, C) as a 3-D tensor map (C, R, B), boxes of ck x box_rows x 1,
// no swizzle, rows past R read as zeros
template <typename T>
bool make_map(CUtensorMap* map, const void* p, int B, int R, int C, int ck, int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)R * C * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)ck, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return enc(map,
             sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, const_cast<void*>(p), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_fused(const void* x, const FusedArgs& a, int smem_bytes, cudaStream_t st) {
  constexpr int VEC = Vec<T>::N;
  constexpr int ELEM = sizeof(T);
  if (a.G <= 0 || a.C % a.G || a.ck <= 0 || a.C % a.ck || a.ck % (a.C / a.G) || a.ck % VEC ||
      4 * a.ck > F_MAX_V || a.box_rows <= 0 || a.box_rows > 256 ||
      a.n_box > F_MAX_BOX ||
      (a.box_rows * a.ck * ELEM) % F_ALIGN || a.n_box <= 0 || a.S <= 0 || a.Q <= 0 ||
      a.Q > a.B * (a.C / a.ck))
    return cudaErrorInvalidValue;
  const int64_t slab_rows = (int64_t)a.box_rows * a.n_box;
  if ((a.S - 1) * slab_rows >= a.R || a.S * slab_rows < a.R ||
      fused_smem(VEC, ELEM, (int)(slab_rows * a.ck)) != smem_bytes)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tg;
  if (!make_map<T>(&tx, x, a.B, a.R, a.C, a.ck, a.box_rows) ||
      !make_map<T>(&tg, a.g, a.B, a.R, a.C, a.ck, a.box_rows))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gn_bwd_fused_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // all CTAs resident, or the launch fails
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Q * a.S);
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_bwd_fused_kernel<T>, tx, tg, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// x, g, dx: contiguous (B, R, C), 16-byte aligned, dtype 0 = float32 or
// 1 = bfloat16, C a multiple of 8 and of G with C / VEC <= 256. mean, inv:
// (B, C) fp32. gamma, beta: fp32, (C,) with affine_sb = 0 or (B, C) with
// affine_sb = C; dgamma, dbeta have the same shape. part: fp32 scratch of
// (B, ceil(R / slab_rows), 2, C); coef: fp32 scratch of (B, 2, G). The finish
// kernel takes 8 * B * C / G bytes of shared memory (at most 48 KB).
// Returns the first cudaError_t of the three launches (0 on success).
extern "C" int nshmc_gn_bwd_twopass(const void* x, const void* g, const void* mean,
                                    const void* inv, const void* gamma, const void* beta,
                                    int affine_sb, void* part, void* coef, void* dx,
                                    void* dgamma, void* dbeta, int dtype, int B, int R, int C,
                                    int G, int slab_rows, void* stream) {
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
    return launch_twopass<float>(x, g, m, iv, gm, bt, affine_sb, pt, cf, dx, dg, db, B, R, C,
                                 G, slab_rows, st);
  if (dtype == 1)
    return launch_twopass<__nv_bfloat16>(x, g, m, iv, gm, bt, affine_sb, pt, cf, dx, dg, db, B,
                                         R, C, G, slab_rows, st);
  return cudaErrorInvalidValue;
}

// The one-launch design. x, g, dx, mean, inv, gamma, beta, affine_sb, dgamma,
// dbeta, dtype, B, R, C, G as for nshmc_gn_bwd_twopass (C / G channels a
// group). The plan (ops/groupnorm.py::bwd_plan): CK channels a unit, S slabs
// a unit, Q units in flight, slabs of n_box boxes of box_rows rows, and the
// dynamic shared memory it expects (checked here against the kernel's own
// layout). scratch: fp32, U * S * 2 CK / (C / G) + U * S * 2 CK + 2 B C
// floats for U = B * C / CK units (FusedArgs' layout); counters: int32,
// at least 2 * B * C / CK + 2, all 0 before the first call (each call leaves
// them 0). Calls that share `counters` must not run concurrently. Returns a
// cudaError_t (0 on success); a grid that cannot be co-resident is refused
// with cudaErrorCooperativeLaunchTooLarge.
extern "C" int nshmc_gn_bwd(const void* x, const void* g, const void* mean, const void* inv,
                            const void* gamma, const void* beta, int affine_sb, void* dx,
                            void* dgamma, void* dbeta, void* scratch, void* counters, int dtype,
                            int B, int R, int C, int G, int ck, int S, int Q, int box_rows,
                            int n_box, int smem_bytes, void* stream) {
  FusedArgs a{static_cast<const float*>(mean), static_cast<const float*>(inv),
              static_cast<const float*>(gamma), static_cast<const float*>(beta), affine_sb,
              g, dx, static_cast<float*>(dgamma), static_cast<float*>(dbeta),
              static_cast<float*>(scratch), static_cast<int*>(counters), B, R, C, G, ck, S, Q,
              box_rows, n_box};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fused<float>(x, a, smem_bytes, st);
  if (dtype == 1) return launch_fused<__nv_bfloat16>(x, a, smem_bytes, st);
  return cudaErrorInvalidValue;
}
