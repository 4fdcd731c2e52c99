// Fused spatial self-attention forward for the ADM U-Net, sm_90a.
//
// Replaces the Pallas TPU kernel nshmc_tpu/ops/attention.py:44 `_attn_kernel`
// (grid over batch*head, full T x T logits resident in VMEM). It computes
//
//   out[b,t,h,:] = sum_s w[t,s] v[b,s,h,:],
//   w = cast_to_T(softmax_s(sum_c qs[b,t,h,c] ks[b,s,h,c]))   (fp32 softmax)
//   qs = cast_to_T(q * cast_to_T(ch^-1/4)),  ks likewise,
//
// with every rounding placed where the Pallas kernel places it: q and k are
// scaled in their own type, logits and the softmax are fp32, the normalized
// weights are cast to v's type before the PV product, which accumulates in
// fp32.
//
// What bounds it on Hopper: at the flagship shape (B=8, T=256, H=8, ch=64,
// bf16) the function moves 8.4 MB and needs 4.3 GFLOP, so the tensor-core
// bound is ~4 us and the byte bound ~2.5 us. This first version uses no
// tensor cores (scalar fp32 FMAs), so it is bound by its own FMA rate, far
// from either. Design: one block of 256 threads per (batch*head, 64-query
// tile); 4 threads share a query row, each holding the whole scaled q row in
// registers. K and V stream through shared memory in 32-key tiles. Because
// the weights must be normalized before their cast (the Pallas kernel's
// rounding point), the key loop runs twice: pass 1 keeps an online row max
// and denominator, pass 2 recomputes the logits, writes the cast weights to
// shared memory and accumulates w.V. Shared memory stays below the 48 KB
// static limit for every head width dispatched (16, 32, 64). wgmma/TMA are
// later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int TPR = 4;              // threads per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr int KPT = BK / TPR;       // keys per thread per tile

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an fp32 value to T's precision (the identity for T = float)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Load one BK x CH tile of (scaled) keys or values into shared memory as fp32.
// Rows past the sequence end are zero-filled.
template <typename T, int CH, int PITCH>
__device__ __forceinline__ void load_tile(float (*dst)[PITCH], const T* __restrict__ src,
                                          int k0, int t_len, int64_t st, float scale,
                                          bool scaled) {
  for (int e = threadIdx.x; e < BK * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    float val = 0.f;
    if (k0 + r < t_len) {
      val = to_f<T>(src[(int64_t)(k0 + r) * st + c]);
      if (scaled) val = round_to<T>(val * scale);
    }
    dst[r][c] = val;
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int t_len, int heads, int64_t sb, int64_t st,
                int64_t sh, float scale) {
  __shared__ float ks[BK][CH + 1];  // +1: the 4 threads of a row read 4 keys
  __shared__ float vs[BK][CH];
  __shared__ float ws[BQ][BK + 1];

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row = threadIdx.x / TPR;  // query row within the tile
  const int sub = threadIdx.x % TPR;  // which quarter of keys / channels
  const int qi = blockIdx.x * BQ + row;
  const bool qvalid = qi < t_len;
  const int64_t base = (int64_t)b * sb + (int64_t)h * sh;
  const T* __restrict__ kb = k + base;
  const T* __restrict__ vb = v + base;

  float qr[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c)
    qr[c] = qvalid ? round_to<T>(to_f<T>(q[base + (int64_t)qi * st + c]) * scale) : 0.f;

  // ---- pass 1: row max and softmax denominator, online over key tiles ----
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();
    load_tile<T, CH, CH + 1>(ks, kb, k0, t_len, st, scale, true);
    __syncthreads();
    float s[KPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = sub + TPR * j;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc = fmaf(qr[c], ks[kk][c], acc);
      s[j] = (k0 + kk < t_len) ? acc : -INFINITY;
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
  // combine the 4 partial (max, sum) pairs of a row: lanes 4r..4r+3
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    l = (m > -INFINITY ? l * expf(m - mn) : 0.f) + (mo > -INFINITY ? lo * expf(mo - mn) : 0.f);
    m = mn;
  }

  // ---- pass 2: normalized weights, cast to T, times V (fp32 accumulate) ----
  float acc[CH / TPR];
#pragma unroll
  for (int i = 0; i < CH / TPR; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();
    load_tile<T, CH, CH + 1>(ks, kb, k0, t_len, st, scale, true);
    load_tile<T, CH, CH>(vs, vb, k0, t_len, st, 1.f, false);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = sub + TPR * j;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) dot = fmaf(qr[c], ks[kk][c], dot);
      ws[row][kk] = (k0 + kk < t_len) ? round_to<T>(expf(dot - m) / l) : 0.f;
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
    T* __restrict__ ob = o + (((int64_t)b * t_len + qi) * heads + h) * CH;
#pragma unroll
    for (int i = 0; i < CH / TPR; ++i) ob[sub + TPR * i] = from_f<T>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int t_len,
                   int heads, int ch, int64_t sb, int64_t st, int64_t sh, float scale,
                   cudaStream_t stream) {
  const dim3 grid((t_len + BQ - 1) / BQ, B * heads);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (ch) {
    case 16: attn_fwd_kernel<T, 16><<<grid, THREADS, 0, stream>>>(qp, kp, vp, op, t_len, heads, sb, st, sh, scale); break;
    case 32: attn_fwd_kernel<T, 32><<<grid, THREADS, 0, stream>>>(qp, kp, vp, op, t_len, heads, sb, st, sh, scale); break;
    case 64: attn_fwd_kernel<T, 64><<<grid, THREADS, 0, stream>>>(qp, kp, vp, op, t_len, heads, sb, st, sh, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, T, H, ch) with element strides (sb, st, sh, 1), shared by all
// three (they are views of one qkv tensor); o: contiguous (B, T, H, ch).
// dtype: 0 = float32, 1 = bfloat16. scale: ch^-1/4 already rounded to dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int nshmc_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int t_len, int heads, int ch,
                                   long long sb, long long st, long long sh, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, B, t_len, heads, ch, sb, st, sh, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, t_len, heads, ch, sb, st, sh, scale, s);
  return cudaErrorInvalidValue;
}
