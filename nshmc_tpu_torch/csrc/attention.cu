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
//   What is left: the products themselves. scripts/attention_variants.py
//   times the exp and the rows a warp against their alternatives, and two
//   diagnostics that drop the lo products or the split (see PERF.md).
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

// ---- float32 on tensor cores, 3xTF32 ---------------------------------------------

constexpr int F32_WARPS = 4;        // 16 query rows each
constexpr int F32_THREADS = 32 * F32_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

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
// strides multiples of 4), 1 = bfloat16 (tensor-core kernel; 16-byte aligned,
// strides multiples of 8). scale: ch^-1/4 already rounded to dtype. Returns
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
