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
//     x.dtype, accumulated in fp32 (by fused multiply-adds: __fmaf_rn);
//   * * pw_mul + pw_add, LeakyReLU(alpha), one rounding to x.dtype.
// The plain version rounds the depthwise conv to x.dtype before the BN and
// casts dw_k to x.dtype (the JAX oracle's way), and sums in another order, so
// the two agree within a tolerance, not bit for bit.
//
// Design.  The TPU kernel walked 28-row chunks of one image through VMEM; on
// the card a block owns a tile of kTile consecutive pixels of the flattened
// [B*H*W] grid:
//   1. the block computes the tile's depthwise output for all C channels
//      (threads over (pixel, channel), channels fastest, so the reads of x are
//      coalesced; the 3x3 neighbourhood comes from L1/L2) and keeps it in
//      shared memory in x.dtype: kTile * C values (96 KB at C=768 in bf16);
//   2. it then produces the tile's [kTile, Cout] outputs 64 channels at a
//      time from that tile and 32-row chunks of pw_k staged in shared memory,
//      each thread holding a 4x4 block of fp32 accumulators.
// The intermediate never leaves the SM.  What bounds it on this card: bytes
// for the shallow blocks (C=24: x read and the output written dominate),
// operations for the deep ones (C=768: 2*C*Cout flops per pixel on fp32
// CUDA cores, against cuDNN's bf16 tensor cores).  Tensor cores (wgmma), TMA
// and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // pixels per block
constexpr int kTileN = 64;     // output channels per pass
constexpr int kChunkK = 32;    // rows of pw_k staged per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dwsep_kernel(const T* __restrict__ x, const float* __restrict__ dw_k,
             const float* __restrict__ dw_mul, const float* __restrict__ dw_add,
             const T* __restrict__ pw_k, const float* __restrict__ pw_mul,
             const float* __restrict__ pw_add, T* __restrict__ out,
             int height, int width, int channels, int cout, long long pixels,
             float alpha) {
  extern __shared__ unsigned char smem_raw[];
  T* t_s = reinterpret_cast<T*>(smem_raw);             // [kTile][channels]
  __shared__ float pw_s[kChunkK][kTileN];

  const long long p0 = (long long)blockIdx.x * kTile;
  const int hw = height * width;

  // 1. depthwise 3x3 + folded BN + ReLU of the tile's pixels, into t_s
  for (int idx = threadIdx.x; idx < kTile * channels; idx += kThreads) {
    const int p = idx / channels;
    const int c = idx - p * channels;
    const long long g = p0 + p;
    float v = 0.0f;
    if (g < pixels) {
      const int b = (int)(g / hw);
      const int r = (int)(g - (long long)b * hw);
      const int h = r / width;
      const int w = r - h * width;
      const T* xb = x + (size_t)b * hw * channels + c;
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int hh = h + dy - 1;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ww = w + dx - 1;
          const float tap =
              (hh >= 0 && hh < height && ww >= 0 && ww < width)
                  ? to_float(xb[((size_t)hh * width + ww) * channels])
                  : 0.0f;
          acc = acc + tap * dw_k[(dy * 3 + dx) * channels + c];
        }
      }
      v = acc * dw_mul[c] + dw_add[c];
      v = v < 0.0f ? 0.0f : v;   // NaN stays NaN, as jnp.maximum
    }
    t_s[idx] = from_float<T>(v);
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

    for (int k0 = 0; k0 < channels; k0 += kChunkK) {
      const int kn = min(kChunkK, channels - k0);
      for (int idx = threadIdx.x; idx < kChunkK * kTileN; idx += kThreads) {
        const int kk = idx / kTileN;
        const int nn = idx - kk * kTileN;
        const int n = n0 + nn;
        pw_s[kk][nn] = (kk < kn && n < cout)
                           ? to_float(pw_k[(size_t)(k0 + kk) * cout + n])
                           : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = to_float(t_s[(ty * 4 + i) * channels + k0 + kk]);
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
        out[(size_t)g * cout + n] = from_float<T>(o);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dw_k, const float* dw_mul,
           const float* dw_add, const void* pw_k, const float* pw_mul,
           const float* pw_add, void* out, int batch, int height, int width,
           int channels, int cout, float alpha, cudaStream_t stream) {
  // the default limit (48 KB) counts static and dynamic shared memory
  // together, so opt in to the dynamic size on every launch
  const size_t smem = (size_t)kTile * channels * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      dwsep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long pixels = (long long)batch * height * width;
  const long long blocks = (pixels + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dwsep_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dw_k, dw_mul, dw_add,
      static_cast<const T*>(pw_k), pw_mul, pw_add, static_cast<T*>(out),
      height, width, channels, cout, pixels, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels per block: the kernel keeps kTile * C depthwise outputs in shared
// memory.
int dwsep_tile_pixels() { return kTile; }

// The most dynamic shared memory a block may ask for on the current device
// (bf16 != 0: the bfloat16 kernel, else the float32 one).  Returns the
// cudaError_t of the queries.
int dwsep_max_dynamic_smem(int bf16, int* bytes) {
  return bf16 ? max_dynamic_smem(dwsep_kernel<__nv_bfloat16>, bytes)
              : max_dynamic_smem(dwsep_kernel<float>, bytes);
}

// Launches the kernel on `stream`; x, pw_k and out are bfloat16 when
// bf16 != 0, else float32.  Returns the cudaError_t of the launch.
int dwsep_forward(const void* x, const float* dw_k, const float* dw_mul,
                  const float* dw_add, const void* pw_k, const float* pw_mul,
                  const float* pw_add, void* out, int batch, int height,
                  int width, int channels, int cout, int bf16, float alpha,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, dw_k, dw_mul, dw_add, pw_k, pw_mul,
                                      pw_add, out, batch, height, width,
                                      channels, cout, alpha, s)
              : launch<float>(x, dw_k, dw_mul, dw_add, pw_k, pw_mul, pw_add,
                              out, batch, height, width, channels, cout,
                              alpha, s);
}

const char* dwsep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
