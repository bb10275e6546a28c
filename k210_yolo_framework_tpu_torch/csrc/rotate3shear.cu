// The training augment's 3-shear rotation for Hopper (sm_90a): three launches
// of one two-tap gather kernel, one thread per output element.
//
// Replaces the TPU kernel k210_yolo_framework_tpu/ops/rotate_pallas.py:
// _rot3_kernel.  That kernel held each image's whole fp32 working frame in
// VMEM (288x344x3x4 B = 1.19 MB at 224x320), far above a block's 227 KB of
// shared memory, so this design runs the passes through device memory
// instead:
//   1. Sx over the virtual zero-padded frame: reads the unpadded image
//      [N, H, W, C] in its dtype, writes an fp32 frame [N, hp, wp, C];
//   2. Sy over that frame into a second fp32 frame;
//   3. Sx over the cropped rows and columns only, writing [N, H, W, C] in the
//      image dtype (round to nearest even, as torch's .to() does).
// The TPU kernel's slice sum gives every output two nonzero terms, so each
// output here is
//     (1 - f) * src[x - k] + f * src[x - k - 1]
// in fp32, with k = floor(offset) and the weights rounded to the image dtype
// by the caller (per-line tables, one entry per frame row for Sx and per
// frame column for Sy), and zeros outside the frame.  The mul and add are
// explicit round-to-nearest intrinsics (no contraction), so the result
// matches the plain PyTorch version, rotate_3shear_reference in
// k210_yolo_framework_tpu_torch/ops/rotate_pallas.py, bit for bit.
//
// What bounds it: bytes.  Per image about three frame writes and three frame
// reads (two taps per output, the second mostly from L1/L2) of ~1.2 MB fp32
// each through L2/HBM, against 2 multiplies and 1 add per output: far below
// the card's operations-per-byte line.  A later version fuses the passes over
// row bands held in shared memory, so each frame crosses HBM once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// dst[n, r, c, ch] (dst is [N, rows, cols, C]) is frame position
// (fy, fx) = (r + r0, c + c0).  The frame is src ([N, src_rows, src_cols, C])
// placed at frame offset (s_r0, s_c0), zero elsewhere.  shear_x: the line is
// the frame row fy and the taps read (fy, fx - k) and (fy, fx - k - 1);
// otherwise the line is the frame column fx and the taps read (fy - k, fx)
// and (fy - k - 1, fx).  Tables are [N, lines].
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
shear_kernel(const In* __restrict__ src, Out* __restrict__ dst,
             const int* __restrict__ kt, const float* __restrict__ w0t,
             const float* __restrict__ w1t, int64_t total, int rows, int cols,
             int ch, int src_rows, int src_cols, int s_r0, int s_c0, int r0,
             int c0, int lines, bool shear_x) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int q = (int)(e % ch);
    int64_t t = e / ch;
    const int c = (int)(t % cols);
    t /= cols;
    const int r = (int)(t % rows);
    const int n = (int)(t / rows);
    const int fy = r + r0, fx = c + c0;
    const int64_t line = (int64_t)n * lines + (shear_x ? fy : fx);
    const int k = kt[line];
    // source positions of the two taps, in src coordinates
    int y0 = fy - s_r0, x0 = fx - s_c0, y1 = y0, x1 = x0;
    if (shear_x) {
      x0 -= k;
      x1 = x0 - 1;
    } else {
      y0 -= k;
      y1 = y0 - 1;
    }
    const int64_t img = (int64_t)n * src_rows;
    float a = 0.0f, b = 0.0f;
    if (y0 >= 0 && y0 < src_rows && x0 >= 0 && x0 < src_cols)
      a = load(src, ((img + y0) * src_cols + x0) * ch + q);
    if (y1 >= 0 && y1 < src_rows && x1 >= 0 && x1 < src_cols)
      b = load(src, ((img + y1) * src_cols + x1) * ch + q);
    store(dst, e, __fadd_rn(__fmul_rn(w0t[line], a), __fmul_rn(w1t[line], b)));
  }
}

template <typename In, typename Out>
cudaError_t launch_pass(const In* src, Out* dst, const int* kt,
                        const float* w0t, const float* w1t, int n, int rows,
                        int cols, int ch, int src_rows, int src_cols, int s_r0,
                        int s_c0, int r0, int c0, int lines, bool shear_x,
                        cudaStream_t stream) {
  const int64_t total = (int64_t)n * rows * cols * ch;
  // enough blocks to fill the card several times over; the loop covers
  // the rest
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65536 ? want : 65536);
  shear_kernel<In, Out><<<blocks, kThreads, 0, stream>>>(
      src, dst, kt, w0t, w1t, total, rows, cols, ch, src_rows, src_cols, s_r0,
      s_c0, r0, c0, lines, shear_x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rotate(const T* img, T* out, float* buf1, float* buf2,
                   const int* kx, const float* wx0, const float* wx1,
                   const int* ky, const float* wy0, const float* wy1, int n,
                   int h, int w, int c, int px, int py, int hp, int wp,
                   cudaStream_t stream) {
  // 1. Sx: the image sits at (py, px) in the frame
  cudaError_t err = launch_pass(img, buf1, kx, wx0, wx1, n, hp, wp, c, h, w,
                                py, px, 0, 0, hp, true, stream);
  if (err != cudaSuccess) return err;
  // 2. Sy over the whole frame
  err = launch_pass(buf1, buf2, ky, wy0, wy1, n, hp, wp, c, hp, wp, 0, 0, 0, 0,
                    wp, false, stream);
  if (err != cudaSuccess) return err;
  // 3. Sx over the crop [py, py + h) x [px, px + w) only
  return launch_pass(buf2, out, kx, wx0, wx1, n, h, w, c, hp, wp, 0, 0, py, px,
                     hp, true, stream);
}

}  // namespace

extern "C" {

// Rotates img [n, h, w, c] (fp32 when bf16 == 0, bf16 otherwise) into out
// (same shape and dtype), through the fp32 scratch frames buf1 and buf2
// [n, hp, wp, c].  Tables: kx/wx0/wx1 [n, hp], ky/wy0/wy1 [n, wp].  Launches
// on `stream`; returns the cudaError_t of the launches.
int rotate3shear(const void* img, int bf16, void* out, float* buf1,
                 float* buf2, const int* kx, const float* wx0,
                 const float* wx1, const int* ky, const float* wy0,
                 const float* wy1, int n, int h, int w, int c, int px, int py,
                 int hp, int wp, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)rotate((const __nv_bfloat16*)img, (__nv_bfloat16*)out, buf1,
                       buf2, kx, wx0, wx1, ky, wy0, wy1, n, h, w, c, px, py,
                       hp, wp, s);
  return (int)rotate((const float*)img, (float*)out, buf1, buf2, kx, wx0, wx1,
                     ky, wy0, wy1, n, h, w, c, px, py, hp, wp, s);
}

const char* rotate3shear_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
