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
// fp32. Because the weights must be normalized before their cast, the key
// loop runs twice: pass 1 keeps an online row max and denominator, pass 2
// recomputes the logits, forms the cast weights and accumulates w.V.
//
// Two kernels, chosen by dtype in the launcher (not by shape, and neither is
// a fallback of the other):
//
// bf16, the main path's type: `attn_fwd_tc_kernel`, on tensor cores.
//   What bounds it: at the flagship shape (B=8, T=256, H=8, ch=64) the
//   function moves 8.4 MB (2.5 us at 3.35 TB/s) and needs 1.07 GFLOP (1.1 us
//   at 989 TFLOP/s): bytes, on paper. The exact rounding costs more than
//   either: the two passes do 1.5x the MMA work, every logit takes an expf
//   in each pass (on the SFU, 16 per clock per SM, and ~6 FP32 instructions
//   each), and at these sizes a block has few tiles to hide load latency
//   behind. At the latent shape (8, 1024, 8, 32) the 134M expf alone take
//   36 us of SFU time.
//   Design: mma.sync m16n8k16 (bf16 in, fp32 accumulate). A block is 4
//   warps, 16 query rows each; the warp's scaled Q fragments stay in
//   registers for both passes. S = Q.K^T reads K by ldmatrix; in pass 2 the
//   fp32 S fragments of two adjacent 8-key tiles become, after exp, the
//   division and the bf16 cast, the A fragment of W.V (the m16n8 C layout is
//   the m16k16 A layout), and V is read by ldmatrix.trans. Row max and sum
//   are kept per lane and combined across the 4 lanes of a row with
//   __shfl_xor_sync. The division e / l uses the row's correctly rounded
//   reciprocal and one FMA correction step (Markstein), which gives the
//   correctly rounded quotient without a divide per element. K and V move by
//   16-byte cp.async copies into shared rows padded to ch + 8 values, so the
//   8 row addresses of every ldmatrix fall in distinct banks; rows past T are
//   zero-filled by the copy and their logits masked to -inf. Each thread
//   scales the K chunks it copied itself (bf16(k * scale), once per tile), so
//   the scaling needs no barrier of its own. Up to T = 256 (the flagship's
//   attention) K and V of the whole sequence stay in shared memory: K is
//   copied and scaled once, V lands during pass 1, and the passes run with
//   no global load and no barrier. Longer sequences stream 64-key tiles
//   through a two-stage ring, the next tile landing while this one computes.
//   Measured (scripts/attention_variants.py): 16- or 32-row blocks are no
//   faster at T = 64, where 4 x 64-row blocks leave half the SMs idle, and
//   slower at T = 256 and 1024; an ex2.approx exp is 16-22% faster but is
//   not the plain version's expf. So the kernel issues, by a count of this
//   code, ~27 instructions per logit, 16 of them for the two expf, and that
//   is what bounds it.
//
// float32, correctness phases only: `attn_fwd_kernel`, scalar fp32 FMAs.
//   Tensor cores would need TF32 for f32 inputs, which breaks the 1e-4 f32
//   tolerance. One block of 256 threads per (batch*head, 64-query tile);
//   4 threads share a query row, each holding the whole scaled q row in
//   registers; K and V stream through shared memory in 32-key tiles. It is
//   bound by its own FMA rate, far from either bound.
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

// ---- bf16 on tensor cores -------------------------------------------------------

constexpr int TC_BK = 64;          // keys per tile
constexpr int TC_WARPS = 4;        // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_RES_MAX_T = 256;  // up to this T, K and V of a (b, h) stay in shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

// d += a . b, one m16n8k16 bf16 product with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two bf16 -> bf16(x * scale) each, fp32 product rounded once
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scale) {
  return pack_bf16(__uint_as_float(w << 16) * scale, __uint_as_float(w & 0xffff0000u) * scale);
}

// exp of a logit minus its row max, as the plain version's softmax takes it
__device__ __forceinline__ float softmax_exp(float x) { return expf(x); }

// One warp's view of the tensor-core kernel: 16 query rows against 64-key
// tiles held in shared memory (rows padded to CH + 8 values).
template <int CH>
struct TcWarp {
  static constexpr int P = CH + 8;      // padded shared row: ldmatrix rows in distinct banks
  static constexpr int NT = TC_BK / 8;  // 8-key n-tiles of S per tile
  static constexpr int KS = CH / 16;    // 16-channel k-steps of Q.K^T
  static constexpr int CT = CH / 8;     // 8-channel n-tiles of O
  using Row = __nv_bfloat16[P];

  int lane, gc;         // lane, and its column pair within a fragment
  uint32_t qa[KS][4];   // scaled Q as m16k16 A fragments
  float m[2], l[2], rl[2];  // rows gr (0) and gr + 8 (1): max, sum, 1 / sum
  float acc[CT][4];

  // S = Qs . Ks^T for the tile at kt (keys k0..k0 + 63); masked keys at -inf
  __device__ __forceinline__ void logits(const Row* kt, int k0, int t_len, float s[NT][4]) const {
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int np = 0; np < NT; np += 2)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // matrices: (keys np*8.., ch kk*16..), (.., ch + 8), (keys + 8, ch), (keys + 8, ch + 8)
        uint32_t bk[4];
        ldmatrix_x4(bk, &kt[np * 8 + (lane & 7) + ((lane >> 4) << 3)]
                           [kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[np], qa[kk], bk[0], bk[1]);
        mma_bf16(s[np + 1], qa[kk], bk[2], bk[3]);
      }
    if (k0 + TC_BK > t_len) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + j * 8 + gc * 2 + (i & 1) >= t_len) s[j][i] = -INFINITY;
    }
  }

  // pass 1: online max and sum per lane, rows gr (i = 0, 1) and gr + 8 (i = 2, 3)
  __device__ __forceinline__ void observe(const float s[NT][4]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
      if (tmax > -INFINITY) {
        const float mn = fmaxf(m[hf], tmax);
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          add += softmax_exp(s[j][2 * hf] - mn) + softmax_exp(s[j][2 * hf + 1] - mn);
        l[hf] = (m[hf] > -INFINITY ? l[hf] * softmax_exp(m[hf] - mn) : 0.f) + add;
        m[hf] = mn;
      }
    }
  }

  // end of pass 1: combine the 4 lanes of each row, and 1 / l
  __device__ __forceinline__ void combine() {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[hf], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[hf], off);
        const float mn = fmaxf(m[hf], mo);
        l[hf] = (m[hf] > -INFINITY ? l[hf] * softmax_exp(m[hf] - mn) : 0.f) +
                (mo > -INFINITY ? lo * softmax_exp(mo - mn) : 0.f);
        m[hf] = mn;
      }
      rl[hf] = 1.f / l[hf];
    }
  }

  // w = bf16(exp(s - m) / l): q = e * rl, then one correction step gives the
  // correctly rounded quotient (rl is the correctly rounded 1 / l)
  __device__ __forceinline__ float weight(float sv, int hf) const {
    const float e = softmax_exp(sv - m[hf]);
    const float qt = e * rl[hf];
    return fmaf(fmaf(-qt, l[hf], e), rl[hf], qt);
  }

  // pass 2: acc += W . V for the tile at vt
  __device__ __forceinline__ void accumulate(const float s[NT][4], const Row* vt) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {  // 16 keys: S n-tiles 2j, 2j + 1 -> one A fragment
      uint32_t a[4];
      a[0] = pack_bf16(weight(s[2 * j][0], 0), weight(s[2 * j][1], 0));
      a[1] = pack_bf16(weight(s[2 * j][2], 1), weight(s[2 * j][3], 1));
      a[2] = pack_bf16(weight(s[2 * j + 1][0], 0), weight(s[2 * j + 1][1], 0));
      a[3] = pack_bf16(weight(s[2 * j + 1][2], 1), weight(s[2 * j + 1][3], 1));
#pragma unroll
      for (int cp = 0; cp < CT; cp += 2) {
        // matrices: (keys 16j.., ch cp*8..), (keys + 8, ch), (keys, ch + 8), (keys + 8, ch + 8)
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &vt[j * 16 + (lane & 15)][cp * 8 + (lane >> 4) * 8]);
        mma_bf16(acc[cp], a, bv[0], bv[1]);
        mma_bf16(acc[cp + 1], a, bv[2], bv[3]);
      }
    }
  }
};

// 16-byte chunks of one 64-key tile of K or V, keys k0.. into dst, and the
// scaling of the chunks a thread copied (its own copies are complete after
// its cp.async wait, so no barrier is needed between the two)
template <int CH>
__device__ __forceinline__ void copy_tile(typename TcWarp<CH>::Row* dst,
                                          const __nv_bfloat16* __restrict__ src, int64_t base,
                                          int k0, int t_len, int64_t st) {
  constexpr int VPR = CH / 8;
  for (int e = threadIdx.x; e < TC_BK * VPR; e += TC_THREADS) {
    const int r = e / VPR, c = (e % VPR) * 8;
    const bool valid = k0 + r < t_len;
    cp_async16(&dst[r][c], src + base + (int64_t)(valid ? k0 + r : 0) * st + c, valid);
  }
}

template <int CH>
__device__ __forceinline__ void scale_tile(typename TcWarp<CH>::Row* dst, float scale) {
  constexpr int VPR = CH / 8;
  for (int e = threadIdx.x; e < TC_BK * VPR; e += TC_THREADS) {
    uint4* p = reinterpret_cast<uint4*>(&dst[e / VPR][(e % VPR) * 8]);
    uint4 w = *p;
    w.x = scale_pair(w.x, scale);
    w.y = scale_pair(w.y, scale);
    w.z = scale_pair(w.z, scale);
    w.w = scale_pair(w.w, scale);
    *p = w;
  }
}

// RES: K and V of the whole (b, h) sequence are copied into shared memory at
// once (V behind K, so V lands during pass 1) and K is scaled once; both
// passes then run with no global load and no barrier. Otherwise K and V
// stream through a two-stage ring, K again in pass 2.
template <int CH, bool RES>
__global__ void __launch_bounds__(TC_THREADS)
attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                   int t_len, int heads, int64_t sb, int64_t st, int64_t sh, float scale) {
  using W = TcWarp<CH>;
  using Row = typename W::Row;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (t_len + TC_BK - 1) / TC_BK;
  Row* ksm = reinterpret_cast<Row*>(smem);                 // RES: n_tiles tiles, else 2 stages
  Row* vsm = ksm + (RES ? n_tiles : 2) * TC_BK;

  W w;
  const int warp = threadIdx.x >> 5;
  w.lane = threadIdx.x & 31;
  w.gc = w.lane & 3;
  const int gr = w.lane >> 2;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int64_t base = (int64_t)b * sb + (int64_t)h * sh;
  const int row0 = (blockIdx.x * TC_WARPS + warp) * 16;

  // a0 (row gr, cols 2gc..), a1 (row gr + 8), a2 (cols + 8), a3 (row gr + 8,
  // cols + 8); rows past T are 0
#pragma unroll
  for (int kk = 0; kk < W::KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + gr + (i & 1) * 8, c = kk * 16 + w.gc * 2 + (i >> 1) * 8;
      w.qa[kk][i] = r < t_len
          ? scale_pair(*reinterpret_cast<const uint32_t*>(q + base + (int64_t)r * st + c), scale)
          : 0u;
    }
  w.m[0] = w.m[1] = -INFINITY;
  w.l[0] = w.l[1] = 0.f;
#pragma unroll
  for (int j = 0; j < W::CT; ++j) w.acc[j][0] = w.acc[j][1] = w.acc[j][2] = w.acc[j][3] = 0.f;
  float s[W::NT][4];

  if constexpr (RES) {
    for (int t = 0; t < n_tiles; ++t) copy_tile<CH>(ksm + t * TC_BK, k, base, t * TC_BK, t_len, st);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) copy_tile<CH>(vsm + t * TC_BK, v, base, t * TC_BK, t_len, st);
    cp_async_commit();
    cp_async_wait<1>();
    for (int t = 0; t < n_tiles; ++t) scale_tile<CH>(ksm + t * TC_BK, scale);
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      w.logits(ksm + t * TC_BK, t * TC_BK, t_len, s);
      w.observe(s);
    }
    w.combine();
    cp_async_wait<0>();
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      w.logits(ksm + t * TC_BK, t * TC_BK, t_len, s);
      w.accumulate(s, vsm + t * TC_BK);
    }
  } else {
    // pass 1 (K) over all tiles, then pass 2 (K and V): step i uses stage i & 1
    const int steps = 2 * n_tiles;
    auto issue = [&](int step) {
      const int stage = (step & 1) * TC_BK;
      const bool pass2 = step >= n_tiles;
      const int k0 = (pass2 ? step - n_tiles : step) * TC_BK;
      copy_tile<CH>(ksm + stage, k, base, k0, t_len, st);
      if (pass2) copy_tile<CH>(vsm + stage, v, base, k0, t_len, st);
      cp_async_commit();
    };
    issue(0);
    for (int step = 0; step < steps; ++step) {
      const int stage = (step & 1) * TC_BK;
      const bool pass2 = step >= n_tiles;
      if (step + 1 < steps) {
        issue(step + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      scale_tile<CH>(ksm + stage, scale);
      __syncthreads();
      const int k0 = (pass2 ? step - n_tiles : step) * TC_BK;
      w.logits(ksm + stage, k0, t_len, s);
      if (!pass2) {
        w.observe(s);
        if (step == n_tiles - 1) w.combine();
      } else {
        w.accumulate(s, vsm + stage);
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + gr + hf * 8;
    if (r < t_len) {
      __nv_bfloat16* ob = o + (((int64_t)b * t_len + r) * heads + h) * CH;
#pragma unroll
      for (int j = 0; j < W::CT; ++j)
        *reinterpret_cast<uint32_t*>(ob + j * 8 + w.gc * 2) =
            pack_bf16(w.acc[j][2 * hf], w.acc[j][2 * hf + 1]);
    }
  }
}

template <int CH, bool RES>
cudaError_t launch_tc_as(dim3 grid, const void* q, const void* k, const void* v,
                         void* o, int t_len, int heads, int64_t sb, int64_t st, int64_t sh,
                         float scale, cudaStream_t stream) {
  constexpr int row_bytes = (CH + 8) * 2;
  const int n_tiles = (t_len + TC_BK - 1) / TC_BK;
  const int smem = 2 * (RES ? n_tiles : 2) * TC_BK * row_bytes;  // K and V areas
  static bool smem_set = false;  // the largest area a kernel can need, set once
  if (!smem_set) {
    const int most = 2 * (RES ? TC_RES_MAX_T / TC_BK : 2) * TC_BK * row_bytes;
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_tc_kernel<CH, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  attn_fwd_tc_kernel<CH, RES><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), t_len, heads, sb,
      st, sh, scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int t_len,
                      int heads, int ch, int64_t sb, int64_t st, int64_t sh, float scale,
                      cudaStream_t stream) {
  const dim3 grid((t_len + 16 * TC_WARPS - 1) / (16 * TC_WARPS), B * heads);
  const bool res = t_len <= TC_RES_MAX_T;
#define NSHMC_TC_CASE(CH)                                                                   \
  case CH:                                                                                  \
    return res ? launch_tc_as<CH, true>(grid, q, k, v, o, t_len, heads, sb, st, sh, scale, \
                                        stream)                                            \
               : launch_tc_as<CH, false>(grid, q, k, v, o, t_len, heads, sb, st, sh, scale, \
                                         stream);
  switch (ch) {
    NSHMC_TC_CASE(16)
    NSHMC_TC_CASE(32)
    NSHMC_TC_CASE(64)
    default: return cudaErrorInvalidValue;
  }
#undef NSHMC_TC_CASE
}

}  // namespace

// q, k, v: (B, T, H, ch) with element strides (sb, st, sh, 1), shared by all
// three (they are views of one qkv tensor); o: contiguous (B, T, H, ch).
// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel; q, k,
// v 16-byte aligned, strides multiples of 8). scale: ch^-1/4 already rounded
// to dtype. Returns the cudaError_t of the launch (0 on success).
extern "C" int nshmc_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int t_len, int heads, int ch,
                                   long long sb, long long st, long long sh, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, B, t_len, heads, ch, sb, st, sh, scale, s);
  if (dtype == 1)
    return launch_tc(q, k, v, o, B, t_len, heads, ch, sb, st, sh, scale, s);
  return cudaErrorInvalidValue;
}
