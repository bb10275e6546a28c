// Per-class greedy NMS over decoded boxes for Hopper (sm_90a), one thread
// block per (class, image) row.
//
// Replaces the TPU kernel k210_yolo_framework_tpu/ops/nms_pallas.py:_nms_kernel
// (reached through batched_nms_pallas), the NMS stage of the two-stage head
// (ops/decode.decode_outputs -> batched_nms_pallas).  The plain PyTorch version
// of the same function is batched_nms_pallas_reference in
// k210_yolo_framework_tpu_torch/ops/nms_pallas.py.  The selection loop is the
// shared one of greedy_select.cuh, the same as the fused head's; there is no
// transcendental function on this path, so the kernel and the plain version
// agree bit for bit.
//
// What bounds it: not bytes.  The inputs are boxes [B, N, 4] and scores
// [B, N, C] fp32 (12.9 MB at B=128, N=1050, C=20), about 4 us of HBM time at
// 3.35 TB/s.  The bound is the sequential chain of up to max_out block-wide
// argmax reductions of each row, as in the fused head:
//   * the row's N scores and N boxes (5*N floats: 21 KB at N=1050, 88 KB at
//     N=4410) are loaded once into shared memory and stay there;
//   * a class's scores are read with a stride of C floats; the C blocks of
//     one image read the same lines, which L2 serves after the first;
//   * each row leaves its loop on its own once its max is below the
//     threshold.
//
// Inputs : boxes [B, N, 4] fp32 yxyx, scores [B, N, C] fp32, both contiguous.
// Outputs: out_scores [B, C, M] and out_boxes [B, C, M, 4] winner buffers;
//          slot k holds winner k, unfilled slots hold -1e9 and zero boxes.
//          The caller masks slots below the threshold.

#include "greedy_select.cuh"
#include "smem.cuh"

namespace {

using greedy::better;
using greedy::block_argmax;
using greedy::kThreads;
using greedy::kWarps;

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           float* __restrict__ out_scores, float* __restrict__ out_boxes,
           int n, int classes, int max_out, float iou_thresh,
           float score_thresh) {
  extern __shared__ float smem[];
  float* s_score = smem;
  float* s_y0 = smem + n;
  float* s_x0 = smem + 2 * n;
  float* s_y1 = smem + 3 * n;
  float* s_x1 = smem + 4 * n;
  __shared__ float red_v[kWarps + 1];
  __shared__ int red_i[kWarps + 1];

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const float4* bx = reinterpret_cast<const float4*>(boxes + (size_t)b * n * 4);
  const float* sc = scores + (size_t)b * n * classes + c;

  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float4 box = bx[j];
    s_y0[j] = box.x;
    s_x0[j] = box.y;
    s_y1[j] = box.z;
    s_x1[j] = box.w;
    const float s = sc[(size_t)j * classes];
    s_score[j] = s;
    if (better(s, j, best_v, best_i)) { best_v = s; best_i = j; }
  }
  block_argmax(best_v, best_i, red_v, red_i);

  float* os = out_scores + ((size_t)b * classes + c) * max_out;
  float* ob = out_boxes + ((size_t)b * classes + c) * max_out * 4;
  greedy::select_row(s_score, s_y0, s_x0, s_y1, s_x1, n, max_out, iou_thresh,
                     score_thresh, best_v, best_i, red_v, red_i, os, ob);
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block of the kernel may ask for on the
// current device.  Returns the cudaError_t of the queries.
int nms_max_dynamic_smem(int* bytes) {
  return max_dynamic_smem(nms_kernel, bytes);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
int nms_select(const float* boxes, const float* scores, float* out_scores,
               float* out_boxes, int batch, int n, int classes, int max_out,
               float iou_thresh, float score_thresh, void* stream) {
  // the default limit (48 KB) counts static and dynamic shared memory
  // together, so opt in to the dynamic size on every launch
  const size_t smem = (size_t)5 * n * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(classes, batch);
  nms_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      boxes, scores, out_scores, out_boxes, n, classes, max_out, iou_thresh,
      score_thresh);
  return (int)cudaGetLastError();
}

const char* nms_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
