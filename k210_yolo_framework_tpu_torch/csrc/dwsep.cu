// Fused depthwise-separable block for Hopper (sm_90a): depthwise 3x3 ->
// folded BN -> ReLU -> pointwise 1x1 -> folded BN -> LeakyReLU, stride 1,
// SAME (1-pixel zero halo), eval mode, NHWC in and out.
//
// Replaces the TPU kernel k210_yolo_framework_tpu/ops/dwsep_pallas.py:_kernel
// (reached through fused_dwsep).  The plain PyTorch version of the same block
// is fused_dwsep_reference in k210_yolo_framework_tpu_torch/ops/dwsep_pallas.py.
// The arithmetic is the TPU kernel body's:
//   * the 9 depthwise taps, x.dtype inputs times fp32 dw_k, summed in fp32 in
//     (dy, dx) order from 0 (mul, then add: the build has -fmad=false);
//   * acc * dw_mul + dw_add, ReLU, one rounding to x.dtype;
//   * the pointwise product over C of those x.dtype values with pw_k in
//     x.dtype, accumulated in fp32: in bf16 on the tensor cores (mma.sync,
//     fp32 accumulators), in fp32 by fused multiply-adds on CUDA cores
//     (__fmaf_rn; TF32 would not hold fp32's 2e-5 tolerance);
//   * * pw_mul + pw_add, LeakyReLU(alpha), one rounding to x.dtype.
// The plain version rounds the depthwise conv to x.dtype before the BN and
// casts dw_k to x.dtype (the JAX oracle's way), and sums in another order, so
// the two agree within a tolerance, not bit for bit.
//
// Design.  The TPU kernel walked 28-row chunks of one image through VMEM; on
// the card a block owns a tile of kTile = 64 consecutive pixels of the
// flattened [B*H*W] grid, and the intermediate never leaves the SM.
//
// bf16 (dwsep_mma_kernel, 4 warps, 64 pixels; ptxas and the HMMA count are
// printed by chip_smoke.py):
//   1. depthwise: a thread takes 8 consecutive channels of two pixels of the
//      tile, p and p + 32, which share the weights (dw_k, dw_mul, dw_add as
//      float4).  With C % 8 == 0 and 16-byte aligned pointers each tap is
//      one 16-byte load of x, all 18 started before the arithmetic; a tap
//      outside the image reads the pixel itself and is masked to 0 word by
//      word, and a pair of interior pixels skips the masks (else element by
//      element).  Rows and columns of the tile's pixels come from a table
//      built once per block.  The result is the A operand in shared memory,
//      [kTile][K + 8] bf16 with K = C rounded up to 16: the columns past C
//      and the rows past the last pixel hold zeros, and the 8-element pad
//      makes the row stride an odd multiple of 16 bytes, so ldmatrix's 8
//      row addresses fall in 8 different bank groups.
//   2. pointwise, kMmaTileN = 64 output channels a pass: 32-row chunks of
//      pw_k ([C, Cout] as the caller gives it, Cout contiguous) stream by
//      cp.async through a ring of kStages = 3 slots in one sequence over all
//      passes (two in flight, one __syncthreads a chunk), zero-filled past C
//      and Cout (a zero of A times stale shared memory could be NaN); the
//      first two are started before the depthwise phase.  A fragments by
//      ldmatrix.x4, B fragments by ldmatrix.x4.trans, which turns the
//      K-major chunk into mma's column operand, so pw_k needs no transposed
//      copy.  Each warp owns a 32x32 piece of the 64x64 output: 2x4
//      mma.sync m16n8k16 per 16 of K, fp32 accumulators in registers; n8
//      tiles past Cout are skipped.
//   3. epilogue, from the registers: folded BN and LeakyReLU, one rounding
//      to bf16; the four lanes of a quad swap words by shuffles so that each
//      holds 8 consecutive channels, stored with one 16-byte store when
//      Cout % 8 == 0.
// fp32 (dwsep_simt_kernel, 8 warps): the same tile; the depthwise output is
// kept in fp32 and the product runs on CUDA cores, 64 output channels a
// pass from 32-row chunks of pw_k, a 4x4 block of accumulators per thread.
//
// What bounds it: at B=128 on the served net's nine stride-1 blocks the
// work is bound by bytes on eight and by operations on block_13 (C = Cout =
// 768 at 7x10: 2*C*Cout flops per pixel against 3 KB of traffic).  What
// holds the kernel above that bound (H100; PERF.md, dwsep_phases.py): the
// depthwise phase, whose masks, addressing and unpacking cost more
// instructions than its fp32 mul-then-add, is half of blocks 1-5's time;
// every 64-pixel tile streams all of pw_k from L2; 4-warp blocks with two
// chunks in flight hide neither L2 latency nor the HMMA chains; block_13's
// 140 tiles on 132 SMs put two on eight SMs.  Left for later: wgmma with
// pw_k chunks multicast by TMA across a cluster, a persistent grid that
// overlaps one tile's depthwise phase with another's product and splits the
// last tiles' passes across SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kTile = 64;          // pixels per block, both kernels

// ---- bf16: the product on tensor cores --------------------------------------
constexpr int kMmaThreads = 128;   // 4 warps: 2 (pixel rows) x 2 (channels)
constexpr int kMmaTileN = 64;      // output channels per pass
constexpr int kMmaChunkK = 32;     // rows of pw_k per cp.async stage
constexpr int kStages = 3;         // chunks in the ring (2 in flight)
constexpr int kPad = 8;            // bf16 elements of pad per shared row
constexpr int kLdb = kMmaTileN + kPad;          // B chunk row stride
constexpr int kChunkElems = kMmaChunkK * kLdb;

__host__ __device__ constexpr int round_up16(int c) { return (c + 15) / 16 * 16; }

// Dynamic shared memory of one block: the A tile and the ring of B chunks
// (bf16), or the depthwise tile (fp32).
size_t smem_bytes(bool bf16, int channels) {
  return bf16 ? ((size_t)kTile * (round_up16(channels) + kPad) +
                 (size_t)kStages * kChunkElems) * sizeof(__nv_bfloat16)
              : (size_t)kTile * channels * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows k0 .. k0 + kMmaChunkK - 1 and columns n0 .. n0 + kMmaTileN - 1 of
// pw_k [C, Cout] into dst [kMmaChunkK][kLdb], zeros past C and Cout: by
// cp.async when vec (Cout % 8 == 0, pw_k 16-byte aligned), else element by
// element.
__device__ __forceinline__ void load_b_chunk(__nv_bfloat16* dst,
                                             const __nv_bfloat16* pw_k,
                                             int k0, int n0, int channels,
                                             int cout, bool vec) {
  if (vec) {
    constexpr int kSegs = kMmaTileN / 8;
    for (int i = threadIdx.x; i < kMmaChunkK * kSegs; i += kMmaThreads) {
      const int kk = i / kSegs;
      const int nn = (i - kk * kSegs) * 8;
      const int k = k0 + kk, n = n0 + nn;
      const bool ok = k < channels && n < cout;
      cp_async16(dst + kk * kLdb + nn,
                 ok ? pw_k + (size_t)k * cout + n : pw_k, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int i = threadIdx.x; i < kMmaChunkK * kMmaTileN; i += kMmaThreads) {
      const int kk = i / kMmaTileN;
      const int nn = i - kk * kMmaTileN;
      const int k = k0 + kk, n = n0 + nn;
      dst[kk * kLdb + nn] =
          (k < channels && n < cout) ? pw_k[(size_t)k * cout + n] : zero;
    }
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return u;
}

__device__ __forceinline__ void load8f(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Depthwise 3x3 + folded BN + ReLU of channels c0 .. c0 + 7 at two pixels
// of the tile, a and b, sharing their weights.  hw_a / hw_b: the pixel's
// row and column (row -4 past the last pixel: every tap outside); x_a /
// x_b: its channel c0 in x.  One 16-byte load per tap, all 18 before the
// arithmetic; unless both pixels are interior, a tap outside the image
// reads the pixel itself and is masked to 0 word by word.  C % 8 == 0.
__device__ __forceinline__ void depthwise_pair_vec(
    const __nv_bfloat16* x_a, const __nv_bfloat16* x_b, int2 hw_a, int2 hw_b,
    const float* __restrict__ dw_k, const float* __restrict__ dw_mul,
    const float* __restrict__ dw_add, int height, int width, int channels,
    int c0, float va[8], float vb[8]) {
  const long long row = (long long)width * channels;
  const __nv_bfloat16* xs[2] = {x_a, x_b};
  const int2 hws[2] = {hw_a, hw_b};
  uint4 taps[2][9];   // all 18 loads first, then the arithmetic
  const bool interior = (unsigned)(hw_a.x - 1) < (unsigned)(height - 2) &&
                        (unsigned)(hw_a.y - 1) < (unsigned)(width - 2) &&
                        (unsigned)(hw_b.x - 1) < (unsigned)(height - 2) &&
                        (unsigned)(hw_b.y - 1) < (unsigned)(width - 2);
  if (interior) {   // every tap inside the image: no mask
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        taps[i][t] = __ldg(reinterpret_cast<const uint4*>(
            xs[i] + (t / 3 - 1) * row + (t % 3 - 1) * channels));
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3, dx = t % 3;
        const bool inb = (unsigned)(hws[i].x + dy - 1) < (unsigned)height &&
                         (unsigned)(hws[i].y + dx - 1) < (unsigned)width;
        const __nv_bfloat16* tp = xs[i] + (dy - 1) * row + (dx - 1) * channels;
        uint4 u = __ldg(reinterpret_cast<const uint4*>(inb ? tp : xs[i]));
        const uint32_t m = inb ? 0xffffffffu : 0u;
        u.x &= m; u.y &= m; u.z &= m; u.w &= m;
        taps[i][t] = u;
      }
  }
  float acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    float k[8];
    load8f(dw_k + t * channels + c0, k);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tap[8];
      unpack8(taps[i][t], tap);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] + tap[j] * k[j];
    }
  }
  float m[8], a[8];
  load8f(dw_mul + c0, m);
  load8f(dw_add + c0, a);
  const bool ok_a = hw_a.x >= 0, ok_b = hw_b.x >= 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float ta = acc[0][j] * m[j] + a[j];
    const float tb = acc[1][j] * m[j] + a[j];
    // ReLU; NaN stays NaN, as jnp.maximum
    va[j] = ok_a ? (ta < 0.0f ? 0.0f : ta) : 0.0f;
    vb[j] = ok_b ? (tb < 0.0f ? 0.0f : tb) : 0.0f;
  }
}

// The same for one pixel, element by element: any C, any alignment.
__device__ __forceinline__ void depthwise_one(
    const __nv_bfloat16* __restrict__ x, int2 hw, long long g,
    const float* __restrict__ dw_k, const float* __restrict__ dw_mul,
    const float* __restrict__ dw_add, int height, int width, int channels,
    int c0, float v[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.0f;
  if (hw.x < 0) return;
  const int nc = min(8, channels - c0);
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int hh = hw.x + dy - 1;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ww = hw.y + dx - 1;
      const bool inb = hh >= 0 && hh < height && ww >= 0 && ww < width;
      const float* kp = dw_k + (dy * 3 + dx) * channels + c0;
      const __nv_bfloat16* xp =
          x + (g + (long long)(dy - 1) * width + (dx - 1)) * channels + c0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nc) {
          const float tap = inb ? __bfloat162float(xp[j]) : 0.0f;
          acc[j] = acc[j] + tap * kp[j];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nc) {
      const float t = acc[j] * dw_mul[c0 + j] + dw_add[c0 + j];
      v[j] = t < 0.0f ? 0.0f : t;   // NaN stays NaN, as jnp.maximum
    }
  }
}

__device__ __forceinline__ uint32_t pick4(const uint32_t w[4], int j) {
  return j == 0 ? w[0] : j == 1 ? w[1] : j == 2 ? w[2] : w[3];
}

__global__ void __launch_bounds__(kMmaThreads)
dwsep_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dw_k,
                 const float* __restrict__ dw_mul,
                 const float* __restrict__ dw_add,
                 const __nv_bfloat16* __restrict__ pw_k,
                 const float* __restrict__ pw_mul,
                 const float* __restrict__ pw_add,
                 __nv_bfloat16* __restrict__ out, int height, int width,
                 int channels, int cout, long long pixels, float alpha,
                 int vec_x, int vec_b, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kpad = round_up16(channels);
  const int lda = kpad + kPad;
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTile][lda]
  __nv_bfloat16* b_s = a_s + kTile * lda;   // [kStages][kMmaChunkK][kLdb]
  __shared__ int2 pix_s[kTile];   // row, column of each tile pixel
  const long long p0 = (long long)blockIdx.x * kTile;

  // The chunks of pw_k stream through the ring in one sequence over all
  // passes: chunk q is rows (q % nchunks) * kMmaChunkK of the columns of
  // pass q / nchunks.  The first kStages - 1 are on their way while the
  // depthwise phase runs.
  const int nchunks = (kpad + kMmaChunkK - 1) / kMmaChunkK;
  const int npasses = (cout + kMmaTileN - 1) / kMmaTileN;
  const int total = nchunks * npasses;
  int next_q = 0, next_kc = 0, next_n0 = 0;   // the next chunk to load
  auto load_next = [&]() {
    if (next_q < total)
      load_b_chunk(b_s + (next_q % kStages) * kChunkElems, pw_k,
                   next_kc * kMmaChunkK, next_n0, channels, cout, vec_b);
    cp_async_commit();   // an empty group past the end keeps the count
    ++next_q;
    if (++next_kc == nchunks) {
      next_kc = 0;
      next_n0 += kMmaTileN;
    }
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) load_next();

  if (threadIdx.x < kTile) {
    const long long g = p0 + threadIdx.x;
    int2 v = make_int2(-4, 0);   // past the last pixel: no tap inside
    if (g < pixels) {
      const int r = (int)(g % ((long long)height * width));
      v = make_int2(r / width, r % width);
    }
    pix_s[threadIdx.x] = v;
  }
  __syncthreads();

  // 1. depthwise 3x3 + folded BN + ReLU of the tile's pixels, into a_s;
  // the pad columns C .. K - 1 get zeros
  const int groups = (channels + 7) / 8;
  if (vec_x) {
    for (int idx = threadIdx.x; idx < (kTile / 2) * groups;
         idx += kMmaThreads) {
      const int p = idx / groups;
      const int c0 = (idx - p * groups) * 8;
      const int q = p + kTile / 2;
      const int2 ha = pix_s[p], hb = pix_s[q];
      // a pixel past the last reads (and masks) the tile's first
      const __nv_bfloat16* xa = x + (p0 + (ha.x >= 0 ? p : 0)) * channels + c0;
      const __nv_bfloat16* xb = x + (p0 + (hb.x >= 0 ? q : 0)) * channels + c0;
      float va[8], vb[8];
      depthwise_pair_vec(xa, xb, ha, hb, dw_k, dw_mul, dw_add, height, width,
                         channels, c0, va, vb);
      *reinterpret_cast<uint4*>(a_s + p * lda + c0) = pack8(va);
      *reinterpret_cast<uint4*>(a_s + q * lda + c0) = pack8(vb);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * groups; idx += kMmaThreads) {
      const int p = idx / groups;
      const int c0 = (idx - p * groups) * 8;
      float v[8];
      depthwise_one(x, pix_s[p], p0 + p, dw_k, dw_mul, dw_add, height, width,
                    channels, c0, v);
      *reinterpret_cast<uint4*>(a_s + p * lda + c0) = pack8(v);
    }
  }
  const int pad_groups = kpad / 8 - groups;
  for (int idx = threadIdx.x; idx < kTile * pad_groups; idx += kMmaThreads) {
    const int p = idx / pad_groups;
    const int c0 = (groups + idx - p * pad_groups) * 8;
    *reinterpret_cast<uint4*>(a_s + p * lda + c0) = make_uint4(0, 0, 0, 0);
  }

  // 2. pointwise product on the tensor cores, kMmaTileN channels a pass
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp >> 1, wn = warp & 1;    // the warp's 32x32 piece
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;   // ldmatrix addresses
  const int g8 = lane >> 2, t4 = lane & 3;              // accumulator layout
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  int kc = 0, n0 = 0;
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kStages - 2>();   // chunk q has landed
    // chunk q (and, at q = 0, the A tile) visible to all; every warp is
    // done with chunk q - 1, whose slot the next load refills
    __syncthreads();
    load_next();

    // n8 tiles of this warp that hold output channels
    const int live = min(4, max(0, (cout - n0 - wn * 32 + 7) / 8));
    const __nv_bfloat16* bs = b_s + (q % kStages) * kChunkElems;
    const int steps = min(kMmaChunkK, kpad - kc * kMmaChunkK) / 16;
    if (live > 0) {
#pragma unroll
      for (int s = 0; s < kMmaChunkK / 16; ++s) {
        if (s >= steps) break;
        const int k = kc * kMmaChunkK + s * 16;
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], a_s + (wm * 32 + mi * 16 + lrow) * lda + k + lcol);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bs + (s * 16 + lrow) * kLdb + wn * 32 +
                                   nj * 16 + lcol);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            if (ni < live) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    if (++kc < nchunks) continue;

    // 3. epilogue of the pass, from the registers: folded BN, LeakyReLU,
    // one rounding; the four lanes of a quad swap words so that lane t4
    // holds 8 consecutive channels of n8 tile t4 and stores them at once
    if (live > 0) {
      float m[4][2], ad[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * t4 + e;
          m[ni][e] = n < cout ? pw_mul[n] : 0.0f;
          ad[ni][e] = n < cout ? pw_add[n] : 0.0f;
        }
      const int n = n0 + wn * 32 + t4 * 8;   // this lane's 8 channels
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t wd[4], v[4];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float o0 = acc[mi][ni][2 * half] * m[ni][0] + ad[ni][0];
            float o1 = acc[mi][ni][2 * half + 1] * m[ni][1] + ad[ni][1];
            o0 = o0 > 0.0f ? o0 : alpha * o0;
            o1 = o1 > 0.0f ? o1 : alpha * o1;
            const __nv_bfloat162 h = __floats2bfloat162_rn(o0, o1);
            wd[ni] = *reinterpret_cast<const uint32_t*>(&h);
          }
          // v[j] = word of lane j of the quad for n8 tile t4
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t got =
                __shfl_xor_sync(0xffffffffu, pick4(wd, t4 ^ i), i);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j == (t4 ^ i)) v[j] = got;
          }
          const long long g = p0 + wm * 32 + mi * 16 + g8 + half * 8;
          if (g < pixels && n < cout) {
            __nv_bfloat16* dst = out + (size_t)g * cout + n;
            if (vec_out) {
              *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (n + j < cout)
                  dst[j] = __ushort_as_bfloat16(
                      (unsigned short)(v[j >> 1] >> (16 * (j & 1))));
            }
          }
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    kc = 0;
    n0 += kMmaTileN;
  }
}

// ---- fp32: the product on CUDA cores ----------------------------------------
constexpr int kSimtThreads = 256;
constexpr int kTileN = 64;     // output channels per pass
constexpr int kSimtChunkK = 32;    // rows of pw_k staged per step

__global__ void __launch_bounds__(kSimtThreads)
dwsep_simt_kernel(const float* __restrict__ x, const float* __restrict__ dw_k,
                  const float* __restrict__ dw_mul,
                  const float* __restrict__ dw_add,
                  const float* __restrict__ pw_k,
                  const float* __restrict__ pw_mul,
                  const float* __restrict__ pw_add, float* __restrict__ out,
                  int height, int width, int channels, int cout,
                  long long pixels, float alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* t_s = reinterpret_cast<float*>(smem_raw);      // [kTile][channels]
  __shared__ float pw_s[kSimtChunkK][kTileN];

  const long long p0 = (long long)blockIdx.x * kTile;
  const int hw = height * width;

  // 1. depthwise 3x3 + folded BN + ReLU of the tile's pixels, into t_s
  for (int idx = threadIdx.x; idx < kTile * channels; idx += kSimtThreads) {
    const int p = idx / channels;
    const int c = idx - p * channels;
    const long long g = p0 + p;
    float v = 0.0f;
    if (g < pixels) {
      const int b = (int)(g / hw);
      const int r = (int)(g - (long long)b * hw);
      const int h = r / width;
      const int w = r - h * width;
      const float* xb = x + (size_t)b * hw * channels + c;
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int hh = h + dy - 1;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ww = w + dx - 1;
          const float tap =
              (hh >= 0 && hh < height && ww >= 0 && ww < width)
                  ? xb[((size_t)hh * width + ww) * channels]
                  : 0.0f;
          acc = acc + tap * dw_k[(dy * 3 + dx) * channels + c];
        }
      }
      v = acc * dw_mul[c] + dw_add[c];
      v = v < 0.0f ? 0.0f : v;   // NaN stays NaN, as jnp.maximum
    }
    t_s[idx] = v;
  }
  __syncthreads();

  // 2. pointwise product of the tile with pw_k, 64 output channels a pass
  const int ty = threadIdx.x / 16;   // pixels ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;   // channels n0 + tx + 16*j
  for (int n0 = 0; n0 < cout; n0 += kTileN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < channels; k0 += kSimtChunkK) {
      const int kn = min(kSimtChunkK, channels - k0);
      for (int idx = threadIdx.x; idx < kSimtChunkK * kTileN;
           idx += kSimtThreads) {
        const int kk = idx / kTileN;
        const int nn = idx - kk * kTileN;
        const int n = n0 + nn;
        pw_s[kk][nn] =
            (kk < kn && n < cout) ? pw_k[(size_t)(k0 + kk) * cout + n] : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = t_s[(ty * 4 + i) * channels + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = pw_s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long g = p0 + ty * 4 + i;
      if (g >= pixels) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= cout) continue;
        float o = acc[i][j] * pw_mul[n] + pw_add[n];
        o = o > 0.0f ? o : alpha * o;
        out[(size_t)g * cout + n] = o;
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// Dynamic shared memory one block asks for at `channels` input channels
// (bf16 != 0: the bfloat16 kernel's A tile, K = C rounded up to 16 plus a
// pad of 8, and its B double buffer; else the float32 kernel's tile).
long long dwsep_smem_bytes(int bf16, int channels) {
  return (long long)smem_bytes(bf16 != 0, channels);
}

// The most dynamic shared memory a block may ask for on the current device
// (bf16 != 0: the bfloat16 kernel, else the float32 one).  Returns the
// cudaError_t of the queries.
int dwsep_max_dynamic_smem(int bf16, int* bytes) {
  return bf16 ? max_dynamic_smem(dwsep_mma_kernel, bytes)
              : max_dynamic_smem(dwsep_simt_kernel, bytes);
}

// Launches the kernel on `stream`; x, pw_k and out are bfloat16 when
// bf16 != 0, else float32.  Returns the cudaError_t of the launch.
int dwsep_forward(const void* x, const float* dw_k, const float* dw_mul,
                  const float* dw_add, const void* pw_k, const float* pw_mul,
                  const float* pw_add, void* out, int batch, int height,
                  int width, int channels, int cout, int bf16, float alpha,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long pixels = (long long)batch * height * width;
  const long long blocks = (pixels + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // the default limit (48 KB) counts static and dynamic shared memory
  // together, so opt in to the dynamic size on every launch
  const size_t smem = smem_bytes(bf16 != 0, channels);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(dwsep_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int vec_x = channels % 8 == 0 && aligned16(x) && aligned16(dw_k) &&
                      aligned16(dw_mul) && aligned16(dw_add);
    const int vec_b = cout % 8 == 0 && aligned16(pw_k);
    const int vec_out = cout % 8 == 0 && aligned16(out);
    dwsep_mma_kernel<<<(unsigned)blocks, kMmaThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), dw_k, dw_mul, dw_add,
        static_cast<const __nv_bfloat16*>(pw_k), pw_mul, pw_add,
        static_cast<__nv_bfloat16*>(out), height, width, channels, cout,
        pixels, alpha, vec_x, vec_b, vec_out);
  } else {
    err = cudaFuncSetAttribute(dwsep_simt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dwsep_simt_kernel<<<(unsigned)blocks, kSimtThreads, smem, s>>>(
        static_cast<const float*>(x), dw_k, dw_mul, dw_add,
        static_cast<const float*>(pw_k), pw_mul, pw_add,
        static_cast<float*>(out), height, width, channels, cout, pixels,
        alpha);
  }
  return (int)cudaGetLastError();
}

const char* dwsep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
