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
// fp32. In bf16, because the weights must be normalized before their cast,
// the key loop runs twice: pass 1 keeps an online row max and denominator,
// pass 2 recomputes the logits, forms the cast weights and accumulates w.V.
// In f32 the cast is the identity and one pass suffices.
//
// Two kernels, chosen by dtype in the launcher (neither is a fallback of the
// other):
//
// bf16, the main path's type: `attn_fwd_tc_kernel`, on tensor cores, in two
//   designs that the launcher picks by T alone (TC_RES_MAX_T; both instances
//   of the one name, one launch a call, and neither a fallback of the other).
//   What bounds it: the exact rounding costs more than the bytes. The two
//   passes do 1.5x the MMA work of one, every logit takes an exponential in
//   each pass, and pass 2 forms the quotient e / l and its bf16 cast per
//   logit. At the flagship shape (B=8, T=256, H=8, ch=64) the function moves
//   8.4 MB (2.5 us at 3.35 TB/s) and needs 1.07 GFLOP (1.1 us at 989
//   TFLOP/s); at Stable Diffusion's (8, 4096, 5, 64) it needs 257.7 GFLOP of
//   MMA (0.26 ms at 989 TFLOP/s) and 1.34G exponentials (0.36 ms of SFU at 16
//   a clock per SM), against 42 MB (0.013 ms).
//   Row max and sum are kept per lane and combined across the 4 lanes of a
//   row with __shfl_xor_sync. The division e / l uses the row's correctly
//   rounded reciprocal and one FMA correction step (Markstein), which gives
//   the correctly rounded quotient without a divide per element; the fp32 S
//   fragments of two adjacent 8-key blocks become, after exp, the division and
//   the bf16 cast, the A fragment of W.V (the m16n8 C layout is the m16k16 A
//   layout), in both designs.
//
//   T <= TC_RES_MAX_T = 256 (the flagship's attention): mma.sync m16n8k16
//   (bf16 in, fp32 accumulate). A block is 4 warps, 16 query rows each; the
//   warp's scaled Q fragments stay in registers for both passes. S = Q.K^T
//   reads K by ldmatrix, V is read by ldmatrix.trans. K and V of the whole
//   sequence move by 16-byte cp.async copies into shared rows padded to ch +
//   8 values, so the 8 row addresses of every ldmatrix fall in distinct banks;
//   rows past T are zero-filled by the copy and their logits masked to -inf.
//   K is scaled once (bf16(k * scale), each thread its own chunks, so the
//   scaling needs no barrier of its own), V lands during pass 1, and the
//   passes run with no global load and no barrier. The exp is the plain
//   version's expf. Measured on an H100 with one-line variants of this file:
//   16- or 32-row blocks are no faster at T = 64, where 4 x 64-row blocks
//   leave half the SMs idle, and slower at T = 256; an ex2.approx exp is
//   16-22% faster. By a count of this code it issues ~27 instructions per
//   logit, 16 of them for the two expf, and that is what bounds it.
//
//   T > TC_RES_MAX_T (Stable Diffusion's 4096 and 1024 tokens, the latent
//   U-Net's 1024, any ragged T): TMA, wgmma and warp specialisation. A block
//   takes 128 query rows of one (b, h) and 384 threads: warpgroup 0 produces
//   (setmaxnreg 40: warp 0 issues the TMA loads, warps 1-3 scale each K tile
//   in place), warpgroups 1 and 2 consume (setmaxnreg 232), 64 rows each. q,
//   k and v are read through 4-D tensor maps (ch, H, T, B) over their own
//   strides, built at launch and passed by value (so a captured CUDA graph
//   holds them), with the swizzle of a ch-wide row (128, 64 or 32 bytes) that
//   wgmma's descriptors name; rows past T arrive as zeros. Pass 1 streams
//   128-key tiles of K, pass 2 of K and V again, through a ring of 4 stages
//   with mbarriers for the TMA transactions, the scaled K and the consumers'
//   release. K is scaled in shared memory once a tile a pass by one bf16x2
//   multiply a pair (bf16 times a bf16 scale is exact in fp32, so this is
//   scale_pair's rounding), then a proxy fence; Q likewise once a block.
//   Each consumer runs S = Qs.Ks^T as 4 wgmma m64n128k16 (both operands from
//   shared memory), the online max and sum of pass 1, and in pass 2 the
//   weights from S's registers and W.V as 8 wgmma m64nCHk16 with W from
//   registers and V read N-major from the same swizzled tile. The exp of both
//   passes is ex2.approx of (s - m) log2 e: an SFU instruction where expf
//   takes ~7, and the unchanged bf16 check of kernel_check passes at every
//   K1 shape (0.56% of the outputs differ at (8, 4096, 5, 64), 0.49% with
//   expf, which takes 1.4x the time). The two consumers run the same schedule
//   and overlap where the SFU and the tensor cores are each other's only
//   load. Measured against other schedules (H100, PERF.md): consumers
//   taking turns at the tensor cores, pass 2's logits and W.V in one batch,
//   and the next tile's logits issued before this tile's exponentials were
//   each no faster (0.70-1.03 ms against 0.72 at (8, 4096, 5, 64)); 64-key
//   tiles 20% slower; an exponent s log2 e - m log2 e in one FFMA 2-3%
//   faster but twice the flipped weights (1.1%). 0.72 ms at
//   (8, 4096, 5, 64) is 24% of the 0.17 ms operations bound, 0.109 ms at
//   (8, 1024, 10, 64) 20%; what bounds it is the SFU's and the tensor cores'
//   work in turn, with each consumer's exponentials, its products' wait and
//   the other consumer overlapping only in part.
//
// float32, the latent CLI's type: `attn_fwd_f32_kernel`, on tensor cores in
//   3xTF32. What bounds it: at the latent U-Net's (8, 1024, 14, 32) the
//   function needs 4 B H T^2 ch = 15.03 GFLOP. Products accurate to fp32 run
//   on the tensor cores as three TF32 products each (a_hi b_hi + a_hi b_lo +
//   a_lo b_hi), at 495 / 3 = 165 TFLOP/s: 0.0911 ms, against 58.7 MB of bytes,
//   0.0175 ms at 3.35 TB/s, so operations. One TF32 product keeps 10 mantissa
//   bits (a unit-scale logit errs by ~1e-3, which fails the 1e-4 f32 check);
//   the hi/lo split keeps about fp32 accuracy.
//   Design: in f32 the weights' cast to v's type is the identity, so the two
//   passes of the bf16 kernel become one with an online softmax: per key
//   tile a running row max m and denominator l, the accumulator rescaled by
//   exp(m_old - m_new), one division at the end (the same function; only
//   the fp32 rounding order differs). mma.sync m16n8k8 tf32 for S = Qs.Ks^T
//   and for O += P.V, three MMAs each. The warp's scaled Q is split into hi
//   and lo once and kept in registers; each K and V tile is split once, by
//   the threads that copied it (hi in place, lo beside it); P is split in
//   registers after the exp. hi is rounded to nearest by two integer
//   operations on the bits (the cvt.rna.tf32 instruction gives the same
//   value, slower), lo is truncated by one (its error, at most 2^-21 of x,
//   keeps the products at about fp32 accuracy). The m16n8k8 C fragment of S
//   gives a lane (g = lane / 4, t = lane % 4) keys 2t and 2t + 1, where the
//   A fragment of P.V wants k-slots t and t + 4: instead of a shuffle, k-slot
//   t carries key 2t and slot t + 4 key 2t + 1, so a0..a3 = c0, c2, c1, c3,
//   and V's B fragment is read from keys 2t and 2t + 1 (a sum over keys does
//   not see their order). Rows are padded to ch + 4 floats, so the K reads
//   (key g, channel t) and the V reads (keys 2t, 2t + 1, channel g) fall in
//   32 distinct banks. K and V stream by 16-byte cp.async through a
//   three-stage ring of key tiles (64 keys; 32 at ch = 64, for shared
//   memory): while tile i is multiplied, each thread has split its chunks of
//   tile i + 1 just before, with no barrier between, and tile i + 2 lands;
//   one barrier a tile, after the products, guards both stages' next use,
//   and the copy three tiles ahead is issued behind it. Rows past T are
//   zero-filled and their logits masked to -inf. The exp is ex2.approx of
//   (s - m) log2 e, one SFU instruction (f32 has no bf16 rounding midpoint to
//   keep, and the 1e-4 check holds). Blocks are 4 warps; from T = 256 on, at
//   ch <= 32, a warp takes 32 query rows (two m-tiles, so each K and V
//   fragment read from shared memory feeds two products), else 16.
//   What is left: the products themselves. One-line variants of this file,
//   timed on an H100, set the exp and the rows a warp against their
//   alternatives, and two diagnostics dropped the lo products or the split
//   (see PERF.md).
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- bf16 on tensor cores -------------------------------------------------------

constexpr int TC_BK = 64;          // keys per tile
constexpr int TC_WARPS = 4;        // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_RES_MAX_T = 256;  // up to this T, K and V of a (b, h) stay in shared memory

constexpr float LOG2E = 1.4426950408889634f;

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

// K and V of the whole (b, h) sequence (T <= TC_RES_MAX_T) are copied into
// shared memory at once (V behind K, so V lands during pass 1) and K is scaled
// once; both passes then run with no global load and no barrier.
template <int CH>
__global__ void __launch_bounds__(TC_THREADS)
attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                   int t_len, int heads, int64_t sb, int64_t st, int64_t sh, float scale) {
  using W = TcWarp<CH>;
  using Row = typename W::Row;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (t_len + TC_BK - 1) / TC_BK;
  Row* ksm = reinterpret_cast<Row*>(smem);  // n_tiles tiles of K, then of V
  Row* vsm = ksm + n_tiles * TC_BK;

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

// the resident kernel for T <= TC_RES_MAX_T
template <int CH>
cudaError_t launch_res(dim3 grid, const void* q, const void* k, const void* v, void* o,
                       int t_len, int heads, int64_t sb, int64_t st, int64_t sh, float scale,
                       cudaStream_t stream) {
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                 __nv_bfloat16*, int, int, int64_t, int64_t, int64_t, float) =
      attn_fwd_tc_kernel<CH>;
  constexpr int row_bytes = (CH + 8) * 2;
  const int n_tiles = (t_len + TC_BK - 1) / TC_BK;
  const int smem = 2 * n_tiles * TC_BK * row_bytes;  // K and V areas
  static bool smem_set = false;  // the largest area a kernel can need, set once
  if (!smem_set) {
    const int most = 2 * TC_RES_MAX_T * row_bytes;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), t_len, heads, sb,
      st, sh, scale);
  return cudaGetLastError();
}

// ---- bf16 for T > TC_RES_MAX_T: TMA, wgmma, warp-specialised -----------------------

constexpr int WG_ROWS = 64;        // query rows a consumer warpgroup
constexpr int WG_CONSUMERS = 2;    // consumer warpgroups a block: 128 query rows
constexpr int WG_THREADS = 128 * (1 + WG_CONSUMERS);  // the producer warpgroup first
constexpr int WG_BK = 128;         // keys a tile
constexpr int WG_STAGES = 4;       // tiles of K (and of V) in the ring
constexpr int WG_SCALERS = 96;     // the producer warpgroup's warps 1-3 scale each K tile
constexpr int WG_PRODUCER_REGS = 40;
constexpr int WG_CONSUMER_REGS = 232;

// The block's shared memory from a 1024-byte aligned base: the two consumers'
// query rows, the ring's K tiles, its V tiles, then the mbarriers. Rows are CH
// bf16 values (32, 64 or 128 bytes), as TMA writes them with the swizzle of
// that width (rows of 8-row groups XORed in 16-byte chunks), which is the
// layout wgmma's descriptors name; every area starts at a multiple of the
// swizzle's 1024-, 512- or 256-byte repeat.
template <int CH>
struct WgLayout {
  static constexpr int ROW = CH * 2;
  static constexpr int Q_BYTES = WG_ROWS * ROW;  // one consumer's query rows
  static constexpr int TILE = WG_BK * ROW;       // one tile of K or of V
  static constexpr int K_OFF = WG_CONSUMERS * Q_BYTES;
  static constexpr int V_OFF = K_OFF + WG_STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + WG_STAGES * TILE;
  static constexpr int BARS = 1 + 4 * WG_STAGES;  // q_full; k_full, v_full, k_ready, empty a stage
  static constexpr int SMEM = 1024 + BAR_OFF + BARS * 8;  // with the slack to align the base
  static constexpr uint64_t SWIZZLE = CH == 64 ? 1 : CH == 32 ? 2 : 3;  // wgmma's B128, B64, B32
  static constexpr int SBO = 8 * ROW;  // bytes from one 8-row group to the next
  static_assert(Q_BYTES % 1024 == 0 && TILE % 1024 == 0, "areas keep the swizzle's alignment");
};

// The mbarriers of a block's ring: q_full; then k_full, v_full (the TMA
// transactions), k_ready (the scalers' arrivals) and empty (one arrival a
// consumer warp, once the products that read the stage have completed), one
// of each a stage.
struct WgBars {
  uint32_t at;
  __device__ __forceinline__ uint32_t q_full() const { return at; }
  __device__ __forceinline__ uint32_t k_full(int s) const { return at + 8 * (1 + s); }
  __device__ __forceinline__ uint32_t v_full(int s) const { return at + 8 * (1 + WG_STAGES + s); }
  __device__ __forceinline__ uint32_t k_ready(int s) const {
    return at + 8 * (1 + 2 * WG_STAGES + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return at + 8 * (1 + 3 * WG_STAGES + s);
  }
};

// a wgmma shared-memory descriptor: start address, leading-byte offset 16
// (unused: a 16-deep K-major slice and a CH-wide N-major one each lie within
// one swizzle row), stride-byte offset between 8-row groups, swizzle
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (swizzle << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// arrive, and expect `bytes` of TMA transactions before the phase completes
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
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

// until the phase of the given parity has completed; a wait that outlasts
// ~2^34 cycles (~10 s) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (const long long t0 = clock64(); !mbar_try_wait(bar, parity);)
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// one box of a 4-D tensor map (ch, H, T, B) into shared memory
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int h, int t,
                                        int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(t), "r"(b),
         "r"(bar)
      : "memory");
}

// bf16(x * scale) in place over `bytes` of shared memory, 16-byte chunks
// i0, i0 + n, ..., then the async proxy (wgmma, TMA) is ordered after the
// writes. scale is a bf16 value, so the product of two bf16 values is exact
// in fp32 and one bf16x2 multiply (rounded once, to nearest) gives
// scale_pair's bits for a pair in one instruction.
__device__ __forceinline__ void scale_area(unsigned char* p, int bytes, int i0, int n,
                                           float scale) {
  const __nv_bfloat162 s2 = __float2bfloat162_rn(scale);
  for (int e = i0 * 16; e < bytes; e += n * 16) {
    uint4 w = *reinterpret_cast<const uint4*>(p + e);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __hmul2(h[i], s2);
    *reinterpret_cast<uint4*>(p + e) = w;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across the
// fence, commit and wait that bracket it
template <int N>
__device__ __forceinline__ void hold_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma m64nNk16, bf16 in, fp32 accumulators d[N / 2] in the m16n8 C layout of
// each warp's 16 rows, repeated over N / 8 column blocks.
// WgmmaSS: A and B from shared memory, both K-major.
template <int N> struct WgmmaSS;
template <> struct WgmmaSS<128> {
  // d = a . b (acc 0) or d += a . b
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// WgmmaRS: A from 4 registers (the m16k16 A layout), B from shared memory N-major.
template <int N> struct WgmmaRS;
template <> struct WgmmaRS<16> {
  // d += a . b
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct WgmmaRS<32> {
  // d += a . b
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct WgmmaRS<64> {
  // d += a . b
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x on the SFU, subnormal results flushed to 0
__device__ __forceinline__ float sfu_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(s - m) of both passes, as 2^((s - m) log2 e) on the SFU
__device__ __forceinline__ float long_exp(float s, float m) { return sfu_exp2((s - m) * LOG2E); }

// One consumer warpgroup's 64 query rows: each warp holds 16, a lane rows
// g = lane / 4 (hf 0) and g + 8 (hf 1), columns 2 (lane % 4) + 8 j + {0, 1}
// of each 8-wide block j of S and O.
template <int CH>
struct WgRows {
  static constexpr int SREGS = WG_BK / 2;  // S's accumulators: 64 rows x WG_BK keys
  using L = WgLayout<CH>;
  int gc;
  float m[2], l[2], rl[2];  // rows g (0) and g + 8 (1): max, sum, 1 / sum

  // S = Qs . Ks^T for one tile, keys past T at -inf
  __device__ __forceinline__ void logits(float* s, uint32_t q_addr, uint32_t k_addr, int k0,
                                         int t_len) const {
    hold_regs<SREGS>(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk)
      WgmmaSS<WG_BK>::mma(s, wg_desc(q_addr + 32 * kk, L::SBO, L::SWIZZLE),
                          wg_desc(k_addr + 32 * kk, L::SBO, L::SWIZZLE), kk);
    wg_commit_wait();
    hold_regs<SREGS>(s);
    if (k0 + WG_BK > t_len) {  // the ragged last tile
#pragma unroll
      for (int i = 0; i < SREGS; ++i)
        if (k0 + (i >> 2) * 8 + gc * 2 + (i & 1) >= t_len) s[i] = -INFINITY;
    }
  }

  // pass 1: online max and sum per lane
  __device__ __forceinline__ void observe(const float* s) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < SREGS / 4; ++j)
        tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      if (tmax > -INFINITY) {
        const float mn = fmaxf(m[hf], tmax);
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < SREGS / 4; ++j)
          add += long_exp(s[4 * j + 2 * hf], mn) + long_exp(s[4 * j + 2 * hf + 1], mn);
        l[hf] = (m[hf] > -INFINITY ? l[hf] * long_exp(m[hf], mn) : 0.f) + add;
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
        l[hf] = (m[hf] > -INFINITY ? l[hf] * long_exp(m[hf], mn) : 0.f) +
                (mo > -INFINITY ? lo * long_exp(mo, mn) : 0.f);
        m[hf] = mn;
      }
      rl[hf] = 1.f / l[hf];
    }
  }

  // w = bf16(exp(s - m) / l), the correctly rounded quotient (see TcWarp::weight)
  __device__ __forceinline__ float weight(float sv, int hf) const {
    const float e = long_exp(sv, m[hf]);
    const float qt = e * rl[hf];
    return fmaf(fmaf(-qt, l[hf], e), rl[hf], qt);
  }

  // pass 2: acc += W . V for one tile; W's 16-key slice kk is S's blocks 2 kk
  // and 2 kk + 1, which the m16n8 C layout lays out as the m16k16 A layout
  __device__ __forceinline__ void accumulate(float* acc, const float* s, uint32_t v_addr) const {
    uint32_t a[WG_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      const float* c = s + 8 * kk;
      a[kk][0] = pack_bf16(weight(c[0], 0), weight(c[1], 0));
      a[kk][1] = pack_bf16(weight(c[2], 1), weight(c[3], 1));
      a[kk][2] = pack_bf16(weight(c[4], 0), weight(c[5], 0));
      a[kk][3] = pack_bf16(weight(c[6], 1), weight(c[7], 1));
    }
    hold_regs<CH / 2>(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      WgmmaRS<CH>::mma(acc, a[kk], wg_desc(v_addr + kk * 16 * L::ROW, L::SBO, L::SWIZZLE));
    wg_commit_wait();
    hold_regs<CH / 2>(acc);
  }
};

// T > TC_RES_MAX_T. A block takes 128 query rows of one (b, h): warpgroup 0
// produces (warp 0 issues the TMA loads, warps 1-3 scale each K tile in
// place), warpgroups 1 and 2 each run the two passes for 64 of the rows. Pass
// 1 streams the K tiles, pass 2 the K and V tiles again, through the ring of
// WG_STAGES stages.
template <int CH, int BK>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   int t_len, int heads, float scale) {
  static_assert(BK == WG_BK, "one tile width");
  using L = WgLayout<CH>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem + (base - raw);
  const WgBars bars{base + L::BAR_OFF};
  const int n_tiles = (t_len + WG_BK - 1) / WG_BK;
  const int steps = 2 * n_tiles;  // step j: pass 1's tile j, then pass 2's tile j - n
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * WG_CONSUMERS * WG_ROWS;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bars.q_full(), 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.k_ready(s), WG_SCALERS);
      mbar_init(bars.empty(s), 4 * WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(WG_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect(bars.q_full(), WG_CONSUMERS * L::Q_BYTES);
      tma_box(base, &tq, h, q0, b, bars.q_full());
      for (int j = 0; j < steps; ++j) {
        const int s = j % WG_STAGES;
        const bool pass2 = j >= n_tiles;
        const int k0 = (pass2 ? j - n_tiles : j) * WG_BK;
        mbar_wait(bars.empty(s), ((j / WG_STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect(bars.k_full(s), L::TILE);
        tma_box(base + L::K_OFF + s * L::TILE, &tk, h, k0, b, bars.k_full(s));
        if (pass2) {
          mbar_expect(bars.v_full(s), L::TILE);
          tma_box(base + L::V_OFF + s * L::TILE, &tv, h, k0, b, bars.v_full(s));
        }
      }
    } else if (threadIdx.x >= 32) {
      for (int j = 0; j < steps; ++j) {
        const int s = j % WG_STAGES;
        mbar_wait(bars.k_full(s), (j / WG_STAGES) & 1);
        scale_area(sm + L::K_OFF + s * L::TILE, L::TILE, threadIdx.x - 32, WG_SCALERS, scale);
        mbar_arrive(bars.k_ready(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(WG_CONSUMER_REGS));
    const int cw = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const uint32_t q_addr = base + cw * L::Q_BYTES;
    auto k_tile = [&](int s) { return base + L::K_OFF + s * L::TILE; };
    auto v_tile = [&](int s) { return base + L::V_OFF + s * L::TILE; };
    WgRows<CH> r;
    r.gc = lane & 3;
    r.m[0] = r.m[1] = -INFINITY;
    r.l[0] = r.l[1] = 0.f;

    mbar_wait(bars.q_full(), 0);
    scale_area(sm + cw * L::Q_BYTES, L::Q_BYTES, tid, 128, scale);
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");  // this warpgroup's rows

    float s[WgRows<CH>::SREGS];
    for (int j = 0; j < n_tiles; ++j) {  // pass 1
      const int st = j % WG_STAGES;
      mbar_wait(bars.k_ready(st), (j / WG_STAGES) & 1);
      r.logits(s, q_addr, k_tile(st), j * WG_BK, t_len);
      if (lane == 0) mbar_arrive(bars.empty(st));
      r.observe(s);
    }
    r.combine();

    float acc[CH / 2];
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {  // pass 2
      const int j = n_tiles + t, st = j % WG_STAGES;
      mbar_wait(bars.k_ready(st), (j / WG_STAGES) & 1);
      r.logits(s, q_addr, k_tile(st), t * WG_BK, t_len);
      mbar_wait(bars.v_full(st), (t / WG_STAGES) & 1);
      r.accumulate(acc, s, v_tile(st));
      if (lane == 0) mbar_arrive(bars.empty(st));
    }

    const int g = lane >> 2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + cw * WG_ROWS + warp * 16 + g + hf * 8;
      if (row < t_len) {
        __nv_bfloat16* ob = o + (((int64_t)b * t_len + row) * heads + h) * CH;
#pragma unroll
        for (int i = 0; i < CH / 8; ++i)
          *reinterpret_cast<uint32_t*>(ob + i * 8 + r.gc * 2) =
              pack_bf16(acc[4 * i + 2 * hf], acc[4 * i + 2 * hf + 1]);
      }
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

// q, k or v (B, T, H, CH) with element strides (sb, st, sh, 1) as the 4-D
// tensor map (CH, H, T, B), boxes of CH x 1 x rows x 1 with the swizzle of a
// CH-wide row; rows past T read as zeros. No copy: the view's own strides.
template <int CH>
bool make_map(CUtensorMap* map, const void* p, int B, int t_len, int heads, int64_t sb,
              int64_t st, int64_t sh, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)CH, (cuuint64_t)heads, (cuuint64_t)t_len,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CH, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = CH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// the long-sequence kernel for T > TC_RES_MAX_T: three tensor maps built
// here and passed by value, so a captured CUDA graph holds them
template <int CH>
cudaError_t launch_long(const void* q, const void* k, const void* v, void* o, int B, int t_len,
                        int heads, int64_t sb, int64_t st, int64_t sh, float scale,
                        cudaStream_t stream) {
  using L = WgLayout<CH>;
  CUtensorMap mq, mk, mv;
  if (!make_map<CH>(&mq, q, B, t_len, heads, sb, st, sh, WG_CONSUMERS * WG_ROWS) ||
      !make_map<CH>(&mk, k, B, t_len, heads, sb, st, sh, WG_BK) ||
      !make_map<CH>(&mv, v, B, t_len, heads, sb, st, sh, WG_BK))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(attn_fwd_tc_kernel<CH, WG_BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((t_len + WG_CONSUMERS * WG_ROWS - 1) / (WG_CONSUMERS * WG_ROWS), B * heads);
  attn_fwd_tc_kernel<CH, WG_BK><<<grid, WG_THREADS, L::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), t_len, heads, scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int t_len,
                      int heads, int ch, int64_t sb, int64_t st, int64_t sh, float scale,
                      cudaStream_t stream) {
  const dim3 grid((t_len + 16 * TC_WARPS - 1) / (16 * TC_WARPS), B * heads);
#define NSHMC_TC_CASE(CH)                                                                   \
  case CH:                                                                                  \
    return t_len <= TC_RES_MAX_T                                                            \
               ? launch_res<CH>(grid, q, k, v, o, t_len, heads, sb, st, sh, scale, stream)  \
               : launch_long<CH>(q, k, v, o, B, t_len, heads, sb, st, sh, scale, stream);
  switch (ch) {
    NSHMC_TC_CASE(16)
    NSHMC_TC_CASE(32)
    NSHMC_TC_CASE(64)
    default: return cudaErrorInvalidValue;
  }
#undef NSHMC_TC_CASE
}

// ---- float32 on tensor cores, 3xTF32 ---------------------------------------------

constexpr int F32_WARPS = 4;        // 16 query rows each
constexpr int F32_THREADS = 32 * F32_WARPS;

// 2^x, as the softmax takes exp(s - m) = 2^((s - m) log2 e)
__device__ __forceinline__ float f32_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cvt.rna.tf32.f32 (nearest, ties away from 0) as two integer operations on
// the bits: half of the 13 dropped bits' range added to the magnitude, then
// the 13 bits cut; the same value for every finite x and infinity, and
// faster on an H100 than the cvt instruction
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the lo part truncated to TF32: one operation, and its error (2^-10 of lo,
// at most 2^-21 of x) leaves the products at about fp32 accuracy; faster
// on an H100 than rounding it
__device__ __forceinline__ uint32_t tf32_lo(float x) { return __float_as_uint(x) & 0xffffe000u; }

// x = hi + lo to about fp32 accuracy, both TF32; the subtraction is exact
// and kept from contraction
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_lo(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a . b, one m16n8k8 tf32 product with fp32 accumulation
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32, the small products first: a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma_3xtf32(float d[4], const uint32_t ahi[4],
                                           const uint32_t alo[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

template <int CH>
using F32Row = float[CH + 4];  // padded: the fragment reads fall in distinct banks

// keys per tile by head width: 32 at ch = 64, so that 3 stages of K hi/lo
// and V hi/lo take 102 KB and two blocks fit an SM; 64 elsewhere
constexpr int F32_BK_CH64 = 32;
template <int CH> constexpr int f32_bk() { return CH == 64 ? F32_BK_CH64 : 64; }
// from this length on, at ch <= 32, a warp takes two 16-row m-tiles, so
// that each K and V fragment it reads from shared memory feeds two products
constexpr int F32_MT2_MIN_T = 256;
constexpr int F32_STAGES = 3;  // the tile being multiplied, the one being split, one landing

// 16-byte chunks of one BK-key tile of K or V, keys k0.. into dst; rows past
// T are zero-filled. Chunk u of a thread is element threadIdx.x + u * THREADS.
template <int CH, int BK>
__device__ __forceinline__ void f32_copy_tile(F32Row<CH>* dst, const float* __restrict__ src,
                                              int64_t base, int k0, int t_len, int64_t st) {
  constexpr int VPR = CH / 4;
  for (int e = threadIdx.x; e < BK * VPR; e += F32_THREADS) {
    const int r = e / VPR, c = (e % VPR) * 4;
    const bool valid = k0 + r < t_len;
    cp_async16(&dst[r][c], src + base + (int64_t)(valid ? k0 + r : 0) * st + c, valid);
  }
}

// scale and split chunk u of this thread (its own copy, complete after its
// cp.async wait): x * scale rounded once, as the plain version scales K; hi
// in place, lo into `lo`
template <int CH>
__device__ __forceinline__ void f32_split_chunk(F32Row<CH>* hi, F32Row<CH>* lo, float scale,
                                                int u) {
  constexpr int VPR = CH / 4;
  const int e = threadIdx.x + u * F32_THREADS;
  const int r = e / VPR, c = (e % VPR) * 4;
  const float4 x = *reinterpret_cast<const float4*>(&hi[r][c]);
  uint4 h, l;
  split_tf32(x.x * scale, h.x, l.x);
  split_tf32(x.y * scale, h.y, l.y);
  split_tf32(x.z * scale, h.z, l.z);
  split_tf32(x.w * scale, h.w, l.w);
  *reinterpret_cast<uint4*>(&hi[r][c]) = h;
  *reinterpret_cast<uint4*>(&lo[r][c]) = l;
}

// MT: 16-row m-tiles a warp (16 * MT query rows), BK: keys per tile
template <int CH, int BK, int MT>
__global__ void __launch_bounds__(F32_THREADS)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int t_len, int heads,
                    int64_t sb, int64_t st, int64_t sh, float scale) {
  constexpr int KS = CH / 8;           // 8-channel k-steps of Q.K^T
  constexpr int NT = BK / 8;           // 8-key n-tiles of S, k-steps of P.V
  constexpr int CT = CH / 8;           // 8-channel n-tiles of O
  constexpr int NS = F32_STAGES;
  constexpr int CPT = BK * CH / 4 / F32_THREADS;  // 16-byte chunks a thread copies of K (of V)
  static_assert(CPT * F32_THREADS * 4 == BK * CH, "a tile's chunks spread evenly");
  using Row = F32Row<CH>;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s holds K hi, K lo, V hi, V lo at tiles 4 s .. 4 s + 3
  Row* sm = reinterpret_cast<Row*>(smem);
  auto tile_at = [&](int stage, int which) { return sm + (4 * stage + which) * BK; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int64_t base = (int64_t)b * sb + (int64_t)h * sh;
  const int row0 = (blockIdx.x * F32_WARPS + warp) * 16 * MT;
  const int n_tiles = (t_len + BK - 1) / BK;

  auto issue = [&](int tile) {
    const int stage = tile % NS;
    f32_copy_tile<CH, BK>(tile_at(stage, 0), k, base, tile * BK, t_len, st);
    f32_copy_tile<CH, BK>(tile_at(stage, 2), v, base, tile * BK, t_len, st);
    cp_async_commit();
  };
  // split chunk u of 2 CPT (K's, then V's) of the tile in `stage`
  auto split = [&](int stage, int u) {
    if (u < CPT) f32_split_chunk<CH>(tile_at(stage, 0), tile_at(stage, 1), scale, u);
    else f32_split_chunk<CH>(tile_at(stage, 2), tile_at(stage, 3), 1.f, u - CPT);
  };
  for (int tile = 0; tile < NS && tile < n_tiles; ++tile) issue(tile);

  // scaled Q as m16k8 A fragments, split: a0 (row g, ch t), a1 (row g + 8),
  // a2 (ch t + 4), a3 (row g + 8, ch t + 4); rows past T are 0
  uint32_t qhi[MT][KS][4], qlo[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + mt * 16 + g + (i & 1) * 8, c = kk * 8 + t + (i >> 1) * 4;
        const float x = r < t_len ? q[base + (int64_t)r * st + c] * scale : 0.f;
        split_tf32(x, qhi[mt][kk][i], qlo[mt][kk][i]);
      }
  // rows g (0) and g + 8 (1) of each m-tile: running max and denominator
  float m[MT][2], l[MT][2], acc[MT][CT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }

  // tile 0 lands and is split before the loop; in the loop, each thread
  // splits its chunks of tile i + 1 and goes on to tile i's products with no
  // barrier between, and one barrier a tile, after the products, separates
  // both from the next use of their stages
  if (n_tiles > 2) cp_async_wait<2>();
  else if (n_tiles > 1) cp_async_wait<1>();
  else cp_async_wait<0>();
#pragma unroll
  for (int u = 0; u < 2 * CPT; ++u) split(0, u);
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % NS, k0 = tile * BK;
    if (tile + 2 < n_tiles) cp_async_wait<1>();  // tile + 1's chunks of this thread landed
    else cp_async_wait<0>();
    if (tile + 1 < n_tiles) {
#pragma unroll
      for (int u = 0; u < 2 * CPT; ++u) split((tile + 1) % NS, u);
    }
    const Row* khi = tile_at(stage, 0);
    const Row* klo = tile_at(stage, 1);
    const Row* vhi = tile_at(stage, 2);
    const Row* vlo = tile_at(stage, 3);

    // S = Qs . Ks^T: c0 (row g, key 2t), c1 (key 2t + 1), c2, c3 (row g + 8)
    float s[MT][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int key = j * 8 + g, c = kk * 8 + t;
        const uint32_t bh0 = __float_as_uint(khi[key][c]), bh1 = __float_as_uint(khi[key][c + 4]);
        const uint32_t bl0 = __float_as_uint(klo[key][c]), bl1 = __float_as_uint(klo[key][c + 4]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(s[mt][j], qhi[mt][kk], qlo[mt][kk], bh0, bh1, bl0, bl1);
      }
    }
    if (k0 + BK > t_len) {  // the ragged last tile
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + j * 8 + t * 2 + (i & 1) >= t_len) s[mt][j][i] = -INFINITY;
    }

    // online softmax: the tile's row max over the 4 lanes of a row, the
    // rescale of l and O, and P = exp(S - m) in place of S
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          tmax = fmaxf(tmax, fmaxf(s[mt][j][2 * hf], s[mt][j][2 * hf + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float mn = fmaxf(m[mt][hf], tmax);
        const float ml = mn > -INFINITY ? mn * LOG2E : 0.f;  // no row key seen yet: P = 0
        const float alpha = m[mt][hf] > -INFINITY ? f32_exp2(fmaf(m[mt][hf], LOG2E, -ml)) : 0.f;
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = f32_exp2(fmaf(s[mt][j][2 * hf + e], LOG2E, -ml));
            s[mt][j][2 * hf + e] = p;
            add += p;
          }
        l[mt][hf] = fmaf(l[mt][hf], alpha, add);
        m[mt][hf] = mn;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          acc[mt][j][2 * hf] *= alpha;
          acc[mt][j][2 * hf + 1] *= alpha;
        }
      }

    // O += P . V: n-tile j of S is k-step j of P.V, k-slot t carrying key
    // 2t and slot t + 4 key 2t + 1, so a0..a3 = c0, c2, c1, c3
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][j][0], ahi[mt][0], alo[mt][0]);
        split_tf32(s[mt][j][2], ahi[mt][1], alo[mt][1]);
        split_tf32(s[mt][j][1], ahi[mt][2], alo[mt][2]);
        split_tf32(s[mt][j][3], ahi[mt][3], alo[mt][3]);
      }
      const int key = j * 8 + 2 * t;
#pragma unroll
      for (int cn = 0; cn < CT; ++cn) {
        const int c = cn * 8 + g;
        const uint32_t bh0 = __float_as_uint(vhi[key][c]), bh1 = __float_as_uint(vhi[key + 1][c]);
        const uint32_t bl0 = __float_as_uint(vlo[key][c]), bl1 = __float_as_uint(vlo[key + 1][c]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(acc[mt][cn], ahi[mt], alo[mt], bh0, bh1, bl0, bl1);
      }
    }
    // every warp is done with this tile's stage, and tile + 1 is split
    __syncthreads();
    if (tile + NS < n_tiles) issue(tile + NS);  // into this tile's stage
  }

  // l over the 4 lanes of each row, one division, and the store
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lr = l[mt][hf] + __shfl_xor_sync(0xffffffffu, l[mt][hf], 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int r = row0 + mt * 16 + g + hf * 8;
      if (r < t_len) {
        float* ob = o + (((int64_t)b * t_len + r) * heads + h) * CH;
#pragma unroll
        for (int j = 0; j < CT; ++j)
          *reinterpret_cast<float2*>(ob + j * 8 + t * 2) =
              make_float2(acc[mt][j][2 * hf] / lr, acc[mt][j][2 * hf + 1] / lr);
      }
    }
}

template <int CH, int MT>
cudaError_t launch_f32_as(const void* q, const void* k, const void* v, void* o, int B,
                          int t_len, int heads, int64_t sb, int64_t st, int64_t sh, float scale,
                          cudaStream_t stream) {
  constexpr int BK = f32_bk<CH>();
  constexpr int smem = F32_STAGES * 4 * BK * (CH + 4) * 4;  // stages of K hi/lo, V hi/lo
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_f32_kernel<CH, BK, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  constexpr int rows = 16 * MT * F32_WARPS;  // query rows a block
  const dim3 grid((t_len + rows - 1) / rows, B * heads);
  attn_fwd_f32_kernel<CH, BK, MT><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), t_len, heads, sb, st, sh, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int t_len,
                       int heads, int ch, int64_t sb, int64_t st, int64_t sh, float scale,
                       cudaStream_t stream) {
  const bool mt2 = t_len >= F32_MT2_MIN_T;
#define NSHMC_F32_ARGS q, k, v, o, B, t_len, heads, sb, st, sh, scale, stream
  switch (ch) {
    case 16: return mt2 ? launch_f32_as<16, 2>(NSHMC_F32_ARGS) : launch_f32_as<16, 1>(NSHMC_F32_ARGS);
    case 32: return mt2 ? launch_f32_as<32, 2>(NSHMC_F32_ARGS) : launch_f32_as<32, 1>(NSHMC_F32_ARGS);
    case 64: return launch_f32_as<64, 1>(NSHMC_F32_ARGS);  // two m-tiles would not fit the registers
    default: return cudaErrorInvalidValue;
  }
#undef NSHMC_F32_ARGS
}

}  // namespace

// q, k, v: (B, T, H, ch) with element strides (sb, st, sh, 1), shared by all
// three (they are views of one qkv tensor); o: contiguous (B, T, H, ch).
// dtype: 0 = float32 (3xTF32 tensor-core kernel; q, k, v 16-byte aligned,
// strides multiples of 4), 1 = bfloat16 (tensor-core kernels, by T; 16-byte
// aligned, strides multiples of 8). scale: ch^-1/4 already rounded to dtype. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int nshmc_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int t_len, int heads, int ch,
                                   long long sb, long long st, long long sh, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, o, B, t_len, heads, ch, sb, st, sh, scale, s);
  if (dtype == 1)
    return launch_tc(q, k, v, o, B, t_len, heads, ch, sb, st, sh, scale, s);
  return cudaErrorInvalidValue;
}
