// GroupNorm statistics (kernel K2a and the group combine) for sm_90a, in ONE launch.
//
// Replaces the Pallas TPU kernel `_stats_kernel` (nshmc_tpu/ops/groupnorm.py:55,
// per-channel [sum x, sum x^2] in fp32, accumulated across row blocks in grid
// order) together with the O(B*C) XLA group combine that follows it (:104-112).
// For x: (B, R, C) channels-last, bf16 or fp32, G groups of C / G channels and
// N = R * C / G values a group, it writes in fp32:
//
//   sums[b, 0, c] = sum_r x[b, r, c]       sums[b, 1, c] = sum_r x[b, r, c]^2
//   mean_g = S_g / N     var_g = max(S2_g / N - mean_g^2, 0)     inv_g = 1 / sqrt(var_g + eps)
//   mean_c[b, c] = mean_{g(c)}             inv_c[b, c] = inv_{g(c)}
//
// (the clip is flax nn.GroupNorm's: at eps 1e-6 a group with a large mean and a
// tiny spread can round S2 / N - mean^2 below 0, where the rsqrt would be NaN).
//
// What bounds it: bytes. It reads x once (134.2 MB at (8, 65536, 128) bf16,
// 0.0401 ms at 3.35 TB/s; 67.1 MB at the VQ decoder's (8, 4096, 512) f32,
// 0.0200 ms); its outputs are B * 4C floats. Three fp32 operations an element
// are far below the card's rate. So the design keeps many 16-byte loads in
// flight, reads every byte once, and spends no second launch and no host
// arithmetic on the slab sums and the group combine, which at these sizes
// cost more in launches than in bytes.
//
// Design (the layout of the stats probe P1, csrc/stream_probe.cu, plus an
// in-launch finish):
//   - Grid (slab, channel block, batch). A row of C / VEC 16-byte vectors
//     (VEC = 8 bf16 or 4 fp32) is cut into channel blocks of at most 256
//     vectors; the block's threads cover cbv vectors of rpi = 256 / cbv rows
//     at a time. A thread keeps the same VEC channels throughout and adds
//     their x and x^2 in fp32 registers down its rows, UNROLL 16-byte loads in
//     flight. S slabs of R / S rows (rounded down or up) a batch element and
//     channel block (ops/groupnorm.py::stats_plan) give every SM the same
//     number of CTAs, two wherever the rows allow: one wave, in which the
//     compiler may give a thread up to 128 registers (__launch_bounds__ with
//     two blocks an SM), so the loads in flight do not spill.
//   - Each CTA reduces its row groups in shared memory in a fixed order and
//     writes its slab's fp32 partials to scratch, then thread 0 takes a ticket
//     on its batch element's integer counter (__threadfence before the atomic).
//     The CTA that draws the last ticket adds that element's partials in slab
//     order (a float4 column a thread, eight loads in flight), writes the
//     sums, does the group combine (group sums in channel order, IEEE division
//     and rsqrtf) and writes mean_c and inv_c; it then resets the counter to 0,
//     so the buffer is zero for the next launch and for CUDA-graph replays.
//     No CTA waits for another, so no cooperative launch is needed and nothing
//     can deadlock; no float atomics, so which CTA finishes does not change a
//     bit of the result.
// The launcher returns cudaGetLastError(); it allocates nothing: the caller
// passes the outputs, the scratch and the counters. Calls that share the
// counters must not run concurrently.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RED = 2048;    // floats of a row-group reduction: rpi * cbv * VEC <= THREADS * 8
constexpr int MAX_C = 2048;  // the finish keeps 2C sums in the reduction's 2 * RED floats
constexpr int MAX_G = 256;
constexpr int UNROLL = 8;    // 16-byte loads a thread keeps in flight

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
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& v, float f[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& v, float* s, float* s2) {
  constexpr int VEC = Vec<T>::N;
  float f[VEC];
  Vec<T>::load(v, f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s[k] += f[k];
    s2[k] = fmaf(f[k], f[k], s2[k]);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// float4 column j of a batch element's (S, 2C) partials, added in slab order,
// eight loads in flight; read through L2 (__ldcg: other SMs wrote them)
__device__ __forceinline__ float4 sum_slabs(const float4* __restrict__ pb, int n4, int j,
                                            int S) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int k = 0;
  for (; k + 8 <= S; k += 8) {
    float4 p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = __ldcg(pb + (int64_t)(k + u) * n4 + j);
#pragma unroll
    for (int u = 0; u < 8; ++u) add4(acc, p[u]);
  }
  for (; k < S; ++k) add4(acc, __ldcg(pb + (int64_t)k * n4 + j));
  return acc;
}

// x: (B, R, C / VEC) 16-byte vectors. part: (B, S, 2, C) fp32 scratch. sums:
// (B, 2, C); mean_c, inv_c: (B, C). counters: B int32, all 0 on entry and on exit.
// At least two blocks an SM: the compiler may then use up to 128 registers a
// thread, and keeps UNROLL loads in flight without spilling (left to itself it
// took 48 and spilled; scripts/groupnorm_stats_variants.py times both).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
gn_stats_kernel(const uint4* __restrict__ x, float* __restrict__ part, float* __restrict__ sums,
                float* __restrict__ mean_c, float* __restrict__ inv_c, int* __restrict__ counters,
                int R, int C, int G, float eps, int cbv) {
  constexpr int VEC = Vec<T>::N;
  __shared__ __align__(16) float red[2 * RED];  // [sum | sum^2][row group][channel]
  __shared__ float g_mean[MAX_G], g_inv[MAX_G];
  __shared__ int last;
  const int s = blockIdx.x, cb = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int cv = C / VEC;
  const int rpi = THREADS / cbv;
  const int lane = threadIdx.x % cbv, r_off = threadIdx.x / cbv;
  const int v0 = cb * cbv;
  const int width = min(cbv, cv - v0);  // vectors of this channel block
  const int W = width * VEC;            // its channels
  const int r0 = (int)((int64_t)s * R / S), r1 = (int)((int64_t)(s + 1) * R / S);

  // 1. this thread's channels over its rows of the slab, UNROLL loads in flight
  if (r_off < rpi && lane < width) {
    float a[VEC], a2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = a2[k] = 0.f;
    const uint4* __restrict__ xb = x + (int64_t)b * R * cv + v0 + lane;
    int r = r0 + r_off;
    for (; r + (UNROLL - 1) * rpi < r1; r += UNROLL * rpi) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(xb + (int64_t)(r + u * rpi) * cv);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) accumulate<T>(v[u], a, a2);
    }
    for (; r < r1; r += rpi) accumulate<T>(__ldg(xb + (int64_t)r * cv), a, a2);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[r_off * W + lane * VEC + k] = a[k];
      red[RED + r_off * W + lane * VEC + k] = a2[k];
    }
  }
  __syncthreads();

  // 2. the CTA's row groups in order -> its slab's partials
  float* __restrict__ out = part + ((int64_t)b * S + s) * 2 * C + v0 * VEC;
  for (int c = threadIdx.x; c < W; c += THREADS) {
    float t = 0.f, t2 = 0.f;
    for (int g = 0; g < rpi; ++g) {
      t += red[g * W + c];
      t2 += red[RED + g * W + c];
    }
    out[c] = t;
    out[C + c] = t2;
  }
  __threadfence();  // the partials are visible device-wide before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + b, 1) == S * (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other CTAs' partials are read after their tickets

  // 3. the last CTA of batch element b adds its slabs in slab order, one float4
  //    column of the (2, C) partials a thread
  const int n4 = C / 2;
  const float4* __restrict__ pb = reinterpret_cast<const float4*>(part + (int64_t)b * S * 2 * C);
  float4* __restrict__ sb = reinterpret_cast<float4*>(sums + (int64_t)b * 2 * C);
  float4* tot = reinterpret_cast<float4*>(red);
  for (int j = threadIdx.x; j < n4; j += THREADS) {
    const float4 acc = sum_slabs(pb, n4, j, S);
    sb[j] = acc;
    tot[j] = acc;
  }
  __syncthreads();

  // 4. the group combine, in group_combine's order of operations
  const int cg = C / G;
  const float n = (float)R * (float)cg;  // exact: R * cg < 2^24
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float gs = 0.f, gs2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      gs += red[g * cg + k];
      gs2 += red[C + g * cg + k];
    }
    const float m = __fdiv_rn(gs, n);
    const float d = __fsub_rn(__fdiv_rn(gs2, n), __fmul_rn(m, m));
    const float var = d < 0.f ? 0.f : d;  // a NaN stays NaN, as torch.clamp leaves it
    g_mean[g] = m;
    g_inv[g] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    mean_c[(int64_t)b * C + c] = g_mean[c / cg];
    inv_c[(int64_t)b * C + c] = g_inv[c / cg];
  }
  if (threadIdx.x == 0) atomicExch(counters + b, 0);  // every ticket of b is taken
}

template <typename T>
cudaError_t launch(const void* x, float* part, float* sums, float* mean, float* inv,
                   int* counters, int B, int R, int C, int G, float eps, int cbv, int n_cb,
                   int S, cudaStream_t st) {
  gn_stats_kernel<T><<<dim3(S, n_cb, B), THREADS, 0, st>>>(
      static_cast<const uint4*>(x), part, sums, mean, inv, counters, R, C, G, eps, cbv);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (B, R, C), 16-byte aligned, dtype 0 = float32 or 1 = bfloat16,
// C a multiple of 8 and of G, C <= 2048, G <= 256. The plan
// (ops/groupnorm.py::stats_plan): n_cb channel blocks of cbv 16-byte vectors
// (the last may be narrower), S slabs (slab s: rows s R / S to (s + 1) R / S).
// part: fp32 scratch of (B, S, 2, C). sums: (B, 2, C); mean, inv: (B, C),
// fp32. counters: B int32, all 0 (each call leaves them 0). Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for a plan that does not
// cover the call).
extern "C" int nshmc_gn_stats(const void* x, void* part, void* sums, void* mean, void* inv,
                              void* counters, int dtype, int B, int R, int C, int G, float eps,
                              int cbv, int n_cb, int S, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  const int cv = C / vec;
  if ((dtype != 0 && dtype != 1) || B <= 0 || B > 65535 || R <= 0 || C <= 0 || C % 8 ||
      C > MAX_C || G <= 0 || G > MAX_G || C % G || cbv <= 0 || cbv > THREADS || n_cb <= 0 ||
      n_cb > 65535 || (int64_t)cbv * n_cb < cv || (int64_t)cbv * (n_cb - 1) >= cv ||
      S <= 0 || S > R || (int64_t)R * (C / G) >= (1 << 24))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pt = static_cast<float*>(part);
  auto* sm = static_cast<float*>(sums);
  auto* mn = static_cast<float*>(mean);
  auto* iv = static_cast<float*>(inv);
  auto* ct = static_cast<int*>(counters);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, pt, sm, mn, iv, ct, B, R, C, G, eps, cbv, n_cb, S, st);
  return launch<float>(x, pt, sm, mn, iv, ct, B, R, C, G, eps, cbv, n_cb, S, st);
}
