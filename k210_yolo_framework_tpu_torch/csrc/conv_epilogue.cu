// The inference epilogue of a conv for Hopper (sm_90a): BatchNorm on its
// running statistics, the activation, an optional residual add and the store
// in the next conv's dtype, in one pass over the conv's output.
//
// Replaces no TPU kernel: XLA fuses these elementwise steps into the conv on
// the TPU, while eager PyTorch runs each as its own pass over device memory
// (a cast, a subtract, a scale, a shift, the activation, the residual add and
// the next conv's cast).  The plain PyTorch version of the same function is
// conv_epilogue_reference in k210_yolo_framework_tpu_torch/ops/conv_epilogue.py,
// which is BatchNorm.forward's eval arithmetic.  Per element, in its order and
// with its roundings:
//   1. x * s, the per-image post-conv scale, rounded to x's dtype (the stem);
//   2. widen to fp32;
//   3. (x - mean) * mul + bias, three round-to-nearest intrinsics, never a
//      fused multiply-add (the build has -fmad=false besides);
//   4. the activation: ReLU as clamp_min(0) (NaN kept), ReLU6 as clamp(0, 6)
//      (NaN kept), LeakyReLU as x > 0 ? x : x * alpha, in the expressions
//      PyTorch's own CUDA kernels use, so -0, NaN and inf come out alike;
//      Mish (YOLOv4) as x * tanh(softplus(x)) with one exp, e = exp(x):
//      tanh(log(1 + e)) = (e^2 + 2e) / (e^2 + 2e + 2), and x above 20 (NaN
//      and +inf too) passes through, as darknet's softplus threshold does.
//      That is F.mish within a few fp32 ulps, not bit for bit: PyTorch
//      computes tanh(log1p(exp(x))).  Mish runs in a kernel of its own,
//      epilogue_mish_kernel, so that a device trace names it;
//   5. + residual in fp32;
//   6. one rounding to the store dtype (fp32, or x's dtype where every
//      consumer would cast to it first: the same bits as its .to()).
//
// What bounds it: bytes.  Each element is read once in x's dtype (and the
// residual in fp32) and written once in the store dtype; 8 operations an
// element against 4 bytes at least (bf16 in, bf16 out).  Design:
//   * in the channels-last layout the served nets run (C % 8 == 0), a
//     thread takes 8 channels of one pixel: one 16-byte load of bf16 (two
//     of fp32), one 16-byte store of bf16, and the 8 channels' mean, mul
//     and bias as two float4 loads each through the read-only path (L1
//     holds the few KB of constants).  Any other channel count, layout or
//     alignment takes a scalar path, an element a thread;
//   * grid.y walks the images, so the per-image scale is one load a block
//     row and every index inside an image is 32-bit; grid.x gives each image
//     enough blocks for eight blocks of 256 threads an SM in all (two waves
//     at the 60 registers the vector path takes: forcing 32 spills and runs
//     1.9x slower), and a block loops over its image.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kBlocksPerSm = 2048 / kThreads;

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2, kLeaky = 3, kMish = 4 };
enum Layout { kChannelsLast = 0, kScalar = 1 };
enum Type { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round to nearest even, as c10's float -> BFloat16 on CUDA
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 values of T as 16-byte words
template <typename T>
struct Pack {
  static constexpr int kWords = sizeof(T) * kVec / 16;
  uint4 w[kWords];
};

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[kVec]) {
  Pack<T> pk;
#pragma unroll
  for (int k = 0; k < Pack<T>::kWords; ++k)
    pk.w[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
  const T* e = reinterpret_cast<const T*>(pk.w);
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = widen(e[k]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[kVec]) {
  Pack<T> pk;
  T* e = reinterpret_cast<T*>(pk.w);
#pragma unroll
  for (int k = 0; k < kVec; ++k) e[k] = narrow<T>(v[k]);
#pragma unroll
  for (int k = 0; k < Pack<T>::kWords; ++k)
    reinterpret_cast<uint4*>(p)[k] = pk.w[k];
}

// x * tanh(softplus(x)) in fp32 with one exp; NaN, +inf and x > 20 pass
__device__ __forceinline__ float mish(float x) {
  if (!(x <= 20.0f)) return x;
  const float e = expf(x);
  const float n = __fadd_rn(__fmul_rn(e, e), __fmul_rn(2.0f, e));
  return __fmul_rn(x, __fdiv_rn(n, __fadd_rn(n, 2.0f)));
}

// steps 1-4 on one element read as `x` (already widened); kMishAct
// instantiates the Mish kernel, which ignores `act`
template <typename Tin, bool kMishAct>
__device__ __forceinline__ float epilogue(float x, bool scaled, float s,
                                          float mean, float mul, float bias,
                                          int act, float alpha) {
  if (scaled) x = widen(narrow<Tin>(__fmul_rn(x, s)));
  float v = __fsub_rn(x, mean);
  v = __fmul_rn(v, mul);
  v = __fadd_rn(v, bias);
  if (kMishAct) return mish(v);
  switch (act) {
    case kRelu:
      v = isnan(v) ? v : fmaxf(v, 0.0f);
      break;
    case kRelu6:
      v = isnan(v) ? v : fminf(fmaxf(v, 0.0f), 6.0f);
      break;
    case kLeaky:
      v = v > 0.0f ? v : __fmul_rn(v, alpha);
      break;
    default:
      break;
  }
  return v;
}

// the body of both kernels
template <typename Tin, typename Tout, int kLayout, bool kMishAct>
__device__ __forceinline__ void epilogue_body(
    const Tin* __restrict__ x, Tout* __restrict__ out,
    const float* __restrict__ mean, const float* __restrict__ mul,
    const float* __restrict__ bias, const Tin* __restrict__ scale,
    const float* __restrict__ res, int images, uint32_t per_image,
    uint32_t channels, uint32_t inner, int act, float alpha) {
  const bool scaled = scale != nullptr;
  const uint32_t step = gridDim.x * kThreads;
  for (int b = blockIdx.y; b < images; b += gridDim.y) {
    const size_t base = (size_t)b * per_image;
    const float s = scaled ? widen(scale[b]) : 0.0f;
    const Tin* xb = x + base;
    Tout* ob = out + base;
    const float* rb = res ? res + base : nullptr;
    if (kLayout == kScalar) {
      for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < per_image;
           i += step) {
        const uint32_t c = (i / inner) % channels;
        float v = epilogue<Tin, kMishAct>(widen(xb[i]), scaled, s,
                                          __ldg(mean + c), __ldg(mul + c),
                                          __ldg(bias + c), act, alpha);
        if (rb) v = __fadd_rn(v, __ldg(rb + i));
        ob[i] = narrow<Tout>(v);
      }
      continue;
    }
    const uint32_t nvec = per_image / kVec;
    for (uint32_t q = blockIdx.x * kThreads + threadIdx.x; q < nvec;
         q += step) {
      const uint32_t i = q * kVec;
      const uint32_t c0 = i % channels;
      float v[kVec], m[kVec], g[kVec], h[kVec];
      load8(xb + i, v);
      load8(mean + c0, m);
      load8(mul + c0, g);
      load8(bias + c0, h);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        v[k] = epilogue<Tin, kMishAct>(v[k], scaled, s, m[k], g[k], h[k],
                                       act, alpha);
      if (rb) {
        float r[kVec];
        load8(rb + i, r);
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = __fadd_rn(v[k], r[k]);
      }
      store8(ob + i, v);
    }
  }
}

// none, ReLU, ReLU6 and LeakyReLU
template <typename Tin, typename Tout, int kLayout>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                    const float* __restrict__ mean,
                    const float* __restrict__ mul,
                    const float* __restrict__ bias,
                    const Tin* __restrict__ scale,
                    const float* __restrict__ res, int images,
                    uint32_t per_image, uint32_t channels, uint32_t inner,
                    int act, float alpha) {
  epilogue_body<Tin, Tout, kLayout, false>(x, out, mean, mul, bias, scale,
                                           res, images, per_image, channels,
                                           inner, act, alpha);
}

// Mish
template <typename Tin, typename Tout, int kLayout>
__global__ void __launch_bounds__(kThreads)
    epilogue_mish_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                         const float* __restrict__ mean,
                         const float* __restrict__ mul,
                         const float* __restrict__ bias,
                         const Tin* __restrict__ scale,
                         const float* __restrict__ res, int images,
                         uint32_t per_image, uint32_t channels,
                         uint32_t inner, int act, float alpha) {
  epilogue_body<Tin, Tout, kLayout, true>(x, out, mean, mul, bias, scale,
                                          res, images, per_image, channels,
                                          inner, act, alpha);
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, void* out, const float* mean,
                   const float* mul, const float* bias, const void* scale,
                   const float* res, int images, uint32_t per_image,
                   uint32_t channels, uint32_t inner, int layout, int act,
                   float alpha, int sm_count, cudaStream_t stream) {
  const uint32_t per_thread = layout == kScalar ? 1 : kVec;
  const uint32_t work = (per_image / per_thread + kThreads - 1) / kThreads;
  const int rows = images < 65535 ? images : 65535;
  uint32_t cols = (uint32_t)((sm_count * kBlocksPerSm + rows - 1) / rows);
  if (cols > work) cols = work;
  if (cols < 1) cols = 1;
  const dim3 grid(cols, rows);
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* o = static_cast<Tout*>(out);
  const Tin* sc = static_cast<const Tin*>(scale);
  const auto kernel =
      act == kMish ? (layout == kChannelsLast
                          ? epilogue_mish_kernel<Tin, Tout, kChannelsLast>
                          : epilogue_mish_kernel<Tin, Tout, kScalar>)
                   : (layout == kChannelsLast
                          ? epilogue_kernel<Tin, Tout, kChannelsLast>
                          : epilogue_kernel<Tin, Tout, kScalar>);
  kernel<<<grid, kThreads, 0, stream>>>(xi, o, mean, mul, bias, sc, res,
                                        images, per_image, channels, inner,
                                        act, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One epilogue over `images` images of `per_image` elements each, laid out
// with `channels` channels of `inner` contiguous elements (1: channels last)
// and images outermost.  `in_type` is x's (and `scale`'s) dtype, `out_type`
// the store's: kF32 or in_type.  `scale` ([images], x's dtype) and `res`
// (fp32, x's layout) may be null.  `layout` is a Layout the caller checked:
// kChannelsLast needs inner == 1, channels % 8 == 0 and 16-byte aligned
// pointers.  Returns the launch's cudaError_t (0: launched).
int conv_epilogue(const void* x, int in_type, void* out, int out_type,
                  const float* mean, const float* mul, const float* bias,
                  const void* scale, const float* res, int images,
                  uint32_t per_image, uint32_t channels, uint32_t inner,
                  int layout, int act, float alpha, int sm_count,
                  void* stream) {
  if (images <= 0 || per_image == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = out_type == kF32;
  if (out_type != kF32 && out_type != in_type)
    return (int)cudaErrorInvalidValue;
#define EPILOGUE_ARGS                                                        \
  x, out, mean, mul, bias, scale, res, images, per_image, channels, inner, \
      layout, act, alpha, sm_count, st
  switch (in_type) {
    case kF32:
      return (int)launch<float, float>(EPILOGUE_ARGS);
    case kBF16:
      return (int)(wide ? launch<__nv_bfloat16, float>(EPILOGUE_ARGS)
                        : launch<__nv_bfloat16, __nv_bfloat16>(EPILOGUE_ARGS));
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EPILOGUE_ARGS
}

const char* conv_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
