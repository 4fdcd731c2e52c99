// Memory-system probe kernels for sm_90a (the port of the four Pallas TPU
// kernels of scripts/pallas_stream_probe.py). All four stream a (B, R, C)
// bf16 channels-last activation, the GroupNorm hot shape (8, 65536, 128):
//
//   P1 stats:     part[b, slab, :] = per-channel [sum x, sum x^2] (fp32) of a row slab,
//                 then a second kernel sums the slabs in a fixed order.
//   P2 apply:     y = SiLU((x - mean[b, c]) * inv[b, c] * scale[c] + bias[c]), bf16 out.
//   P3 touch:     every row is copied into shared memory by TMA; out[b, 0, :] = f32(x[b, R - RB, :]).
//   P4 mma stats: the P1 function on tensor cores (mma.sync, ones . x).
//
// All four are bound by bytes: at (8, 65536, 128) bf16 P1, P3 and P4 read
// 134.2 MB (0.0401 ms at 3.35 TB/s) and P2 reads and writes 268.4 MB
// (0.0801 ms); their arithmetic is far below the card's rates. So every
// design below is about keeping enough 16-byte loads in flight, reading each
// byte once, and touching device memory with coalesced rows. Each kernel's
// note says which TPU kernel it replaces.
//
// Every launcher returns the cudaError_t of its launches (0 on success); it
// allocates nothing: the caller passes outputs and scratch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // P1, P2, P4 blocks
constexpr int SLAB_ROWS = 1024;   // rows of one batch element per P1 / P4 block
constexpr int BLOCKS_PER_SM = 8;  // P2's grid: 8 x 256 threads fill an SM

// ---- 8 bf16 channels in one 16-byte vector -----------------------------------

__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower half holds the lower-address element
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Thread layout shared by P1 and P2: C / 8 threads cover one row with 16-byte
// loads (neighbouring threads on neighbouring addresses), and THREADS / (C / 8)
// rows are read per pass. A thread keeps the same 8 channels throughout.
struct RowLayout {
  int cv, rpi, lane_c, r_off;
  __device__ RowLayout(int C) {
    cv = C / 8;
    rpi = THREADS / cv;
    lane_c = threadIdx.x % cv;
    r_off = threadIdx.x / cv;
  }
  __device__ bool active() const { return r_off < rpi; }
};

__device__ __forceinline__ void accumulate(const uint4& v, float s[8], float s2[8]) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] += f[k];
    s2[k] = fmaf(f[k], f[k], s2[k]);
  }
}

// ---- P1: per-channel [sum x, sum x^2] ---------------------------------------------
// Replaces scripts/pallas_stream_probe.py:43 `stats_kernel` (grid (B, R / 2048)
// run in order, an fp32 VMEM accumulator carried across the row blocks).
// Bound: bytes, one read of x (134.2 MB, 0.0401 ms at the probe shape).
// Blocks run in parallel and in no order here, so the grid is (row slab,
// batch): 8 x 64 blocks of 1,024 rows at the probe shape, ~4 per SM. Each
// thread accumulates its 8 channels in fp32 registers over its rows with four
// 16-byte loads in flight, the block reduces its row groups in shared memory
// and writes one fp32 partial per slab; `stats_finish_kernel` adds the slabs
// in slab order. No float atomics, so every run gives the same bits.

__global__ void __launch_bounds__(THREADS)
stats_partial_kernel(const uint4* __restrict__ x, float* __restrict__ part, int R, int C,
                     int n_slabs) {
  __shared__ float red_s[2 * THREADS * 4];  // [row group][channel], rpi * C <= 8 * THREADS
  __shared__ float red_s2[2 * THREADS * 4];
  const RowLayout L(C);
  const int slab = blockIdx.x, b = blockIdx.y;
  const int r0 = slab * SLAB_ROWS, r1 = min(R, r0 + SLAB_ROWS);
  float s[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = s2[k] = 0.f;
  if (L.active()) {
    const uint4* __restrict__ xb = x + (int64_t)b * R * L.cv + L.lane_c;
    int r = r0 + L.r_off;
    for (; r + 3 * L.rpi < r1; r += 4 * L.rpi) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(xb + (int64_t)(r + u * L.rpi) * L.cv);
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate(v[u], s, s2);
    }
    for (; r < r1; r += L.rpi) accumulate(__ldg(xb + (int64_t)r * L.cv), s, s2);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red_s[L.r_off * C + L.lane_c * 8 + k] = s[k];
      red_s2[L.r_off * C + L.lane_c * 8 + k] = s2[k];
    }
  }
  __syncthreads();
  float* __restrict__ out = part + ((int64_t)b * n_slabs + slab) * 2 * C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float a = 0.f, a2 = 0.f;
    for (int g = 0; g < L.rpi; ++g) {
      a += red_s[g * C + c];
      a2 += red_s2[g * C + c];
    }
    out[c] = a;
    out[C + c] = a2;
  }
}

// part: (B, n_slabs, 2, C) -> out: (B, 2, C), summed in slab order (P1 and P4).
__global__ void stats_finish_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int C, int n_slabs) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    const float* __restrict__ p = part + (int64_t)b * n_slabs * 2 * C + i;
    float acc = 0.f;
    for (int s = 0; s < n_slabs; ++s) acc += p[(int64_t)s * 2 * C];
    out[(int64_t)b * 2 * C + i] = acc;
  }
}

// ---- P2: SiLU((x - mean) * inv * scale + bias) ---------------------------------------
// Replaces scripts/pallas_stream_probe.py:73 `apply_kernel`. Bound: bytes,
// one read of x and one write of y (268.4 MB, 0.0801 ms). Elementwise, so
// the TPU's (1, 2048, C) blocks become a grid-stride loop over rows: grid
// (chunks, batch), ~8 blocks of 256 threads per SM. A thread owns 8 channels
// of one batch element, so their mean, inv, scale and bias sit in 32
// registers for the whole loop; each row step is one 16-byte load and one
// 16-byte store. The math is fp32 with expf (not __expf) in the sigmoid, in
// the plain version's order, and the result is rounded to bf16 once.

__global__ void __launch_bounds__(THREADS)
apply_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, const float* __restrict__ mean,
             const float* __restrict__ inv, const float* __restrict__ scale,
             const float* __restrict__ bias, int R, int C) {
  const RowLayout L(C);
  if (!L.active()) return;
  const int b = blockIdx.y, c0 = L.lane_c * 8;
  float m[8], iv[8], sc[8], bi[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m[k] = mean[(int64_t)b * C + c0 + k];
    iv[k] = inv[(int64_t)b * C + c0 + k];
    sc[k] = scale[c0 + k];
    bi[k] = bias[c0 + k];
  }
  const int64_t base = (int64_t)b * R * L.cv + L.lane_c;
  for (int r = blockIdx.x * L.rpi + L.r_off; r < R; r += gridDim.x * L.rpi) {
    const int64_t at = base + (int64_t)r * L.cv;
    float f[8];
    unpack8(__ldg(x + at), f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float t = (f[k] - m[k]) * iv[k];
      t = t * sc[k] + bi[k];
      f[k] = t * (1.f / (1.f + expf(-t)));
    }
    y[at] = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                       pack2(f[6], f[7]));
  }
}

// ---- P3: TMA streaming read ---------------------------------------------------------------
// Replaces scripts/pallas_stream_probe.py:183 `touch_kernel`, whose BlockSpec
// DMAs every (1, 2048, C) block into VMEM while the kernel writes one row: a
// probe of the raw read rate. Bound: bytes, one read of x (0.0401 ms). Here
// the tensor is one contiguous byte range cut into 32 KB chunks of whole
// rows; each block (one per SM, 128 threads) takes a contiguous run of
// chunks and streams them with 1-D TMA bulk copies
// (cp.async.bulk ... mbarrier::complete_tx::bytes) into a ring of 4 x 32 KB
// shared-memory stages, one mbarrier each. One thread issues the copies, so
// no thread spends registers or instructions on addresses, and 128 KB are in
// flight per SM. No arithmetic touches the data: the block whose chunk holds
// row R - RB of batch element b (the last block row the TPU grid writes)
// copies that row out of shared memory as f32. Its GB/s is the card's
// achievable read rate for this access pattern.

constexpr int TMA_STAGES = 4;
constexpr int TMA_STAGE_BYTES = 32768;
constexpr int TMA_THREADS = 128;
constexpr int TMA_SMEM = TMA_STAGES * TMA_STAGE_BYTES + TMA_STAGES * 8;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// thread 0 only: expect `bytes` on `bar`, then copy them global -> shared
__device__ __forceinline__ void tma_load(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(TMA_THREADS)
touch_kernel(const unsigned char* __restrict__ x, float* __restrict__ out, int64_t total_rows,
             int R, int C, int rb, int chunk_rows, int64_t n_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + TMA_STAGES * TMA_STAGE_BYTES);
  const int64_t row_bytes = 2LL * C;
  const int64_t per = n_chunks / gridDim.x, extra = n_chunks % gridDim.x;
  const int64_t k0 = blockIdx.x * per + min64(blockIdx.x, extra);
  const int n = (int)(per + (blockIdx.x < extra ? 1 : 0));

  auto chunk_rows_at = [&](int i) {  // rows of this block's i-th chunk
    return min64(chunk_rows, total_rows - (k0 + i) * chunk_rows);
  };
  auto issue = [&](int i) {
    const int64_t g0 = (k0 + i) * chunk_rows;
    tma_load(smem + (i % TMA_STAGES) * TMA_STAGE_BYTES, x + g0 * row_bytes,
             (uint32_t)(chunk_rows_at(i) * row_bytes), &bars[i % TMA_STAGES]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < TMA_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(&bars[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(n, TMA_STAGES); ++i) issue(i);
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int s = i % TMA_STAGES;
    // the stage's (i / STAGES)-th fill completes its phase of that parity
    while (!mbar_try_wait(&bars[s], (uint32_t)((i / TMA_STAGES) & 1))) {
    }
    const int64_t g0 = (k0 + i) * chunk_rows, rows = chunk_rows_at(i);
    for (int64_t b = g0 / R; b * R < g0 + rows; ++b) {
      const int64_t t = b * R + (R - rb);
      if (t >= g0 && t < g0 + rows) {
        const __nv_bfloat16* row = reinterpret_cast<const __nv_bfloat16*>(
            smem + s * TMA_STAGE_BYTES + (t - g0) * row_bytes);
        for (int c = threadIdx.x; c < C; c += TMA_THREADS)
          out[b * C + c] = __bfloat162float(row[c]);
      }
    }
    __syncthreads();  // every thread is done with stage s before it is refilled
    if (threadIdx.x == 0 && i + TMA_STAGES < n) {
      // order this block's generic-proxy reads of the stage before the async-proxy write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + TMA_STAGES);
    }
  }
}

// ---- P4: stats on tensor cores -------------------------------------------------------------
// Replaces scripts/pallas_stream_probe.py:198 `mxu_stats_kernel`, which gets
// the P1 sums from the matrix unit: ones(8, 2048) . x and ones . (x * x) with
// fp32 accumulation. Bound: bytes, one read of x (0.0401 ms); its 96
// tensor-core operations per element take 0.0065 ms at 989 TFLOP/s.
// Here: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
// A = ones (each 32-bit A register is 0x3F803F80, two bf16 1.0) and B = a 16-row
// x 8-channel tile of x, so every row of D is the tile's column sums (a lane's
// d0, d1 are channels 2 (lane % 4) and 2 (lane % 4) + 1 of the warp's 8). B is
// read with ldmatrix.trans from a shared-memory tile whose rows are padded to
// 144 bytes, so the 8 row addresses of each 8x8 matrix fall in distinct banks.
// sum x^2 stays exact without TF32: x^2 of a bf16 value has at most 16
// significant bits, so hi = bf16(x^2) and lo = bf16(x^2 - hi) are exact (for
// 2^-56 <= |x| < 2^63, where both are normal numbers) and ones . hi + ones . lo
// is the fp32 sum. Each 16-row step starts its products from zero (the lo
// product accumulates onto the hi one) and adds them into fp32 registers, so
// the tensor core's own summation spans only 16 rows. Grid (row slab,
// 64-channel block, batch), 8 warps per block,
// one 8-channel n-tile per warp; the slab partials go through the same
// stats_finish_kernel as P1.

constexpr int MMA_TILE_ROWS = 128;          // rows staged in shared memory per step
constexpr int MMA_CB = 64;                  // channels per block: 8 warps x 8
constexpr int MMA_PITCH = MMA_CB + 8;       // bf16 per shared row (144 bytes)
constexpr uint32_t BF16_ONES = 0x3F803F80u;

__device__ __forceinline__ void mma_ones(float d[4], uint32_t b0, uint32_t b1, float c0,
                                         float c1, float c2, float c3) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(BF16_ONES), "r"(BF16_ONES), "r"(BF16_ONES), "r"(BF16_ONES), "r"(b0), "r"(b1),
        "f"(c0), "f"(c1), "f"(c2), "f"(c3));
}

// two bf16 of x -> the two bf16 pairs hi = bf16(x^2), lo = bf16(x^2 - hi), both exact
__device__ __forceinline__ void split_square(uint32_t v, uint32_t& hi, uint32_t& lo) {
  const float a = __uint_as_float(v << 16), b = __uint_as_float(v & 0xffff0000u);
  const float a2 = a * a, b2 = b * b;  // exact: 16 significant bits at most
  hi = pack2(a2, b2);
  const float ha = __uint_as_float(hi << 16), hb = __uint_as_float(hi & 0xffff0000u);
  lo = pack2(a2 - ha, b2 - hb);
}

__global__ void __launch_bounds__(THREADS)
mma_stats_partial_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ part, int R,
                         int C, int n_slabs) {
  __shared__ __align__(16) __nv_bfloat16 tile[MMA_TILE_ROWS][MMA_PITCH];
  const int slab = blockIdx.x, c_base = blockIdx.y * MMA_CB, b = blockIdx.z;
  const int cw = min(MMA_CB, C - c_base);  // channels of this block, a multiple of 8
  const int vpr = cw / 8;                  // 16-byte vectors per staged row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool has_tile = warp * 8 < cw;
  const int r0 = slab * SLAB_ROWS, r1 = min(R, r0 + SLAB_ROWS);
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;

  for (int rt = r0; rt < r1; rt += MMA_TILE_ROWS) {
    const int nr = min(MMA_TILE_ROWS, r1 - rt);
    __syncthreads();  // the previous tile is consumed
#pragma unroll 4
    for (int e = threadIdx.x; e < MMA_TILE_ROWS * vpr; e += THREADS) {
      const int r = e / vpr, v = e % vpr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);  // rows past the slab add zeros
      if (r < nr)
        val = __ldg(reinterpret_cast<const uint4*>(x + ((int64_t)b * R + rt + r) * C + c_base) + v);
      *reinterpret_cast<uint4*>(&tile[r][v * 8]) = val;
    }
    __syncthreads();
    if (has_tile) {
      const int kend = (nr + 15) & ~15;
      for (int k = 0; k < kend; k += 16) {
        // lanes 0-7 address rows k..k+7 (matrix 0), lanes 8-15 rows k+8..k+15
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(smem_u32(&tile[k + (lane & 15)][warp * 8])));
        uint32_t h0, l0, h1, l1;
        split_square(b0, h0, l0);
        split_square(b1, h1, l1);
        float d[4], e[4];
        mma_ones(d, b0, b1, 0.f, 0.f, 0.f, 0.f);
        s0 += d[0];
        s1 += d[1];
        mma_ones(e, h0, h1, 0.f, 0.f, 0.f, 0.f);
        mma_ones(e, l0, l1, e[0], e[1], e[2], e[3]);
        q0 += e[0];
        q1 += e[1];
      }
    }
  }
  if (has_tile && lane < 4) {
    const int c = c_base + warp * 8 + 2 * lane;
    float* __restrict__ out = part + ((int64_t)b * n_slabs + slab) * 2 * C;
    out[c] = s0;
    out[c + 1] = s1;
    out[C + c] = q0;
    out[C + c + 1] = q1;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

int n_slabs(int R) { return (R + SLAB_ROWS - 1) / SLAB_ROWS; }

}  // namespace

// Shapes: x is a contiguous (B, R, C) bf16 tensor, 16-byte aligned, with C a
// multiple of 8 and at most 2048. `part` is fp32 scratch of
// (B, nshmc_probe_slabs(R), 2, C); `out` of P1 and P4 is (B, 2, C) fp32.

extern "C" int nshmc_probe_slabs(int R) { return n_slabs(R); }

extern "C" int nshmc_probe_stats(const void* x, void* part, void* out, int B, int R, int C,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ns = n_slabs(R);
  stats_partial_kernel<<<dim3(ns, B), THREADS, 0, st>>>(static_cast<const uint4*>(x),
                                                         static_cast<float*>(part), R, C, ns);
  stats_finish_kernel<<<B, 256, 0, st>>>(static_cast<const float*>(part),
                                         static_cast<float*>(out), C, ns);
  return cudaGetLastError();
}

// mean, inv: (B, C) fp32; scale, bias: (C,) fp32; y: like x.
extern "C" int nshmc_probe_apply(const void* x, void* y, const void* mean, const void* inv,
                                 const void* scale, const void* bias, int B, int R, int C,
                                 void* stream) {
  const int rpi = THREADS / (C / 8);
  const int row_steps = (R + rpi - 1) / rpi;
  const int want = (sm_count() * BLOCKS_PER_SM + B - 1) / B;
  const int chunks = row_steps < want ? row_steps : want;
  apply_kernel<<<dim3(chunks, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const float*>(scale),
      static_cast<const float*>(bias), R, C);
  return cudaGetLastError();
}

// out: (B, 1, C) fp32 = x[:, R - rb, :]; R a multiple of rb.
extern "C" int nshmc_probe_touch(const void* x, void* out, int B, int R, int C, int rb,
                                 void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        touch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TMA_SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int chunk_rows = TMA_STAGE_BYTES / (2 * C);
  const int64_t total_rows = (int64_t)B * R;
  const int64_t n_chunks = (total_rows + chunk_rows - 1) / chunk_rows;
  const int64_t sms = sm_count();
  const int grid = (int)(n_chunks < sms ? n_chunks : sms);
  touch_kernel<<<grid, TMA_THREADS, TMA_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<float*>(out), total_rows, R, C, rb,
      chunk_rows, n_chunks);
  return cudaGetLastError();
}

extern "C" int nshmc_probe_mma_stats(const void* x, void* part, void* out, int B, int R, int C,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ns = n_slabs(R);
  mma_stats_partial_kernel<<<dim3(ns, (C + MMA_CB - 1) / MMA_CB, B), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(part), R, C, ns);
  stats_finish_kernel<<<B, 256, 0, st>>>(static_cast<const float*>(part),
                                         static_cast<float*>(out), C, ns);
  return cudaGetLastError();
}
