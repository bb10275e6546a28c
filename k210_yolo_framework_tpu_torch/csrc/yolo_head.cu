// Fused YOLO head for Hopper (sm_90a): decode + letterbox inverse + per-class
// greedy NMS, one thread block per (image, group of G classes), one warp per
// class row.  The selection loop is the shared one of greedy_select.cuh.
//
// Replaces the TPU kernel k210_yolo_framework_tpu/ops/yolo_head_pallas.py:_kernel
// together with its selection loop, k210_yolo_framework_tpu/ops/nms_pallas.py:
// greedy_select_loop.  The plain PyTorch version of the same function is
// fused_decode_nms_reference in k210_yolo_framework_tpu_torch/ops/yolo_head_pallas.py;
// every arithmetic step below follows it in the same order, and the build uses
// -fmad=false (no mul+add contraction) and no fast math, so the two agree
// bit for bit wherever the transcendental functions do.
//
// What bounds it: not bytes.  The input is [B, N, 5+C] fp32 logits (about
// 13 MB at B=128, N=1050, C=20).  The bound is each row's chain of up to
// max_out steps, each a pass over the candidates still live
// (greedy_select.cuh).  The block:
//   * decodes each candidate of its image once for its G rows: one thread a
//     candidate computes the box, the letterbox inverse, its area and conf
//     (and, for class_softmax, the max and the class-order sum), writes the
//     box to shared memory and the G class scores into the G rows;
//   * notes, in the same pass and the one barrier after it, whether every
//     box is finite and within +-kTame (the loop's IoU then needs no NaN
//     handling);
//   * after that barrier runs each row in its own warp, with no block
//     barrier in the loop;
//   * a warp past the G rows, or whose class lies past C (when C % G != 0),
//     helps decode and writes nothing.
// With G == C each image's logits are read from HBM once.  At G == 1 the
// row's scores and boxes are compacted together in place (5 floats a
// candidate), which fits the most candidates.  The wrapper picks G
// (ops/nms_pallas.rows_per_block) against the footprint yolo_head_smem_bytes
// and the blocks the batch gives: 20 at B=128 (serving), 5 at B=32 (eval),
// 1 at B=1 on an H100.
//
// Inputs : preds [B, N, E] fp32 (E = 5 + C: tx ty tw th conf cls...),
//          geom  [8, N] fp32 (gx, gy, 1/gw, 1/gh, anchor_w, anchor_h, 1, 0),
//          lbox  [B, 8] fp32 (off_y, off_x, sy, sx, img_h, img_w, 0, 0).
// Outputs: out_scores [B, C, M] and out_boxes [B, C, M, 4] winner buffers;
//          slot k holds winner k, unfilled slots hold -1e9 and zero boxes.
//          The caller masks slots below the threshold.

#include "greedy_select.cuh"
#include "smem.cuh"

namespace {

using greedy::box_area;
using greedy::kMaxRows;
using greedy::kMinWarps;
using greedy::tame_box;
using greedy::nan_max;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kShared>
__global__ void __launch_bounds__(32 * kMaxRows)
yolo_head_kernel(const float* __restrict__ preds,
                 const float* __restrict__ geom,
                 const float* __restrict__ lbox,
                 float* __restrict__ out_scores,
                 float* __restrict__ out_boxes,
                 int n, int classes, int rows, int max_out,
                 float iou_thresh, float score_thresh, int class_softmax) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * rows;
  const int n_rows = min(rows, classes - c0);
  const int e = 5 + classes;
  const float* p_img = preds + (size_t)b * n * e;
  const float* lb = lbox + (size_t)b * 8;
  const float off_y = lb[0], off_x = lb[1];
  const float sy = lb[2], sx = lb[3];
  const float ih = lb[4], iw = lb[5];

  float4* s_box = smem4;
  float* s_more = smem + 4 * n;   // areas (shared) or the row's scores (own)
  float* s_score = kShared ? smem + 5 * n : s_more;

  // decode every candidate of image b once, score it for the G classes
  bool is_tame = true;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* p = p_img + (size_t)j * e;
    const float cx = (sigmoid(p[0]) + geom[j]) * geom[2 * n + j];
    const float cy = (sigmoid(p[1]) + geom[n + j]) * geom[3 * n + j];
    const float bw = expf(p[2]) * geom[4 * n + j];
    const float bh = expf(p[3]) * geom[5 * n + j];
    const float oy = (cy - off_y) * sy;
    const float ox = (cx - off_x) * sx;
    const float oh = bh * sy;
    const float ow = bw * sx;
    const float y0 = (oy - oh * 0.5f) * ih;
    const float x0 = (ox - ow * 0.5f) * iw;
    const float y1 = (oy + oh * 0.5f) * ih;
    const float x1 = (ox + ow * 0.5f) * iw;
    s_box[j] = make_float4(y0, x0, y1, x1);
    if (kShared) s_more[j] = box_area(y0, x0, y1, x1);
    is_tame &= tame_box(y0, x0, y1, x1);
    const float conf = sigmoid(p[4]);
    if (class_softmax) {
      // softmax over the real classes, summed in class order
      float mx = p[5];
      for (int k = 1; k < classes; ++k) mx = nan_max(mx, p[5 + k]);
      float sum = expf(p[5] - mx);
      for (int k = 1; k < classes; ++k) sum = sum + expf(p[5 + k] - mx);
      for (int g = 0; g < n_rows; ++g)
        s_score[g * n + j] = expf(p[5 + c0 + g] - mx) / sum * conf;
    } else {
      for (int g = 0; g < n_rows; ++g)
        s_score[g * n + j] = sigmoid(p[5 + c0 + g]) * conf;
    }
  }
  const bool tame = __syncthreads_and(is_tame);

  const int g = threadIdx.x >> 5;
  if (g >= n_rows) return;
  const int c = c0 + g;
  float* os = out_scores + ((size_t)b * classes + c) * max_out;
  float* ob = out_boxes + ((size_t)b * classes + c) * max_out * 4;
  if (kShared) {
    unsigned short* s_idx =
        reinterpret_cast<unsigned short*>(smem + 5 * n + rows * n);
    const greedy::SharedBoxes row{s_box, s_more, s_score + g * n,
                                  s_idx + g * n};
    greedy::select_row(row, n, tame, max_out, iou_thresh, score_thresh, os,
                       ob);
  } else {
    const greedy::OwnBoxes row{s_box, s_score};
    greedy::select_row(row, n, tame, max_out, iou_thresh, score_thresh, os,
                       ob);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of g class rows of n candidates.
size_t yolo_head_smem_bytes(int n, int g) { return greedy::smem_bytes(n, g); }

// The most class rows a block runs (the `rows` of a launch).
int yolo_head_max_rows() { return kMaxRows; }

// The most dynamic shared memory a block may ask for on the current device,
// the smaller of the two layouts' limits.  Returns the cudaError_t of the
// queries.
int yolo_head_max_dynamic_smem(int* bytes) {
  int own = 0, shared = 0;
  int err = max_dynamic_smem(yolo_head_kernel<false>, &own);
  if (err == 0) err = max_dynamic_smem(yolo_head_kernel<true>, &shared);
  *bytes = own < shared ? own : shared;
  return err;
}

// Blocks of `rows` class rows of n candidates that one SM holds at once on
// the current device (the occupancy calculator's answer).  Returns the
// cudaError_t of the query.
int yolo_head_blocks_per_sm(int n, int rows, int* blocks) {
  const auto kernel =
      rows > 1 ? yolo_head_kernel<true> : yolo_head_kernel<false>;
  const int threads = 32 * (rows > kMinWarps ? rows : kMinWarps);
  const size_t smem = greedy::smem_bytes(n, rows);
  // the calculator holds the size to the kernel's opted-in limit
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem);
}

// Launches the kernel on `stream` with `rows` class rows a block (1 to
// kMaxRows); returns the cudaError_t of the launch.
int yolo_head_decode_nms(const float* preds, const float* geom,
                         const float* lbox, float* out_scores,
                         float* out_boxes, int batch, int n, int classes,
                         int rows, int max_out, float iou_thresh,
                         float score_thresh, int class_softmax, void* stream) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  // the default limit (48 KB) counts static and dynamic shared memory
  // together, so opt in to the dynamic size on every launch
  const size_t smem = greedy::smem_bytes(n, rows);
  const auto kernel =
      rows > 1 ? yolo_head_kernel<true> : yolo_head_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((classes + rows - 1) / rows, batch);
  const int threads = 32 * (rows > kMinWarps ? rows : kMinWarps);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      preds, geom, lbox, out_scores, out_boxes, n, classes, rows, max_out,
      iou_thresh, score_thresh, class_softmax);
  return (int)cudaGetLastError();
}

const char* yolo_head_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
