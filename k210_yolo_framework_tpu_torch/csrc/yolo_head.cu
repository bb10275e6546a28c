// Fused YOLO head for Hopper (sm_90a): decode + letterbox inverse + per-class
// greedy NMS.  In shared memory: one thread block per (image, group of G
// classes), one warp per class row, the selection loop the shared one of
// greedy_select.cuh.  On the global path: a decode kernel, then one block
// per class row selecting in score order (ordered_select.cuh).
//
// Replaces the TPU kernel k210_yolo_framework_tpu/ops/yolo_head_pallas.py:_kernel
// together with its selection loop, k210_yolo_framework_tpu/ops/nms_pallas.py:
// greedy_select_loop.  The plain PyTorch version of the same function is
// fused_decode_nms_reference in k210_yolo_framework_tpu_torch/ops/yolo_head_pallas.py;
// every arithmetic step below follows it in the same order, and the build uses
// -fmad=false (no mul+add contraction) and no fast math, so the two agree
// bit for bit wherever the transcendental functions do.
//
// What bounds it: not bytes.  The input is [B, N, E] fp32 logits (13 MB at
// B=128, N=1050, C=20; 73 MB at B=32, N=22,743).  Where a block holds its
// rows in shared memory (up to 11,622 candidates on an H100: every builder
// below about 448x448), the bound is each row's chain of up to max_out
// steps, each a pass over the candidates still live (greedy_select.cuh),
// and rows there are short.  The block:
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
// Above that (the global path: the darknet53 and CSP nets from 448x448 up)
// a row at the eval settings keeps ~9,700 live candidates, and the step
// loop, run in global scratch, re-tested them at each of its 100 steps, a
// chain of dependent loads in one warp: 18.7 ms a call at B=32 on an H100.
// There the selection runs in score order instead (ordered_select.cuh), in
// two kernels, 0.74 ms:
//   * yolo_head_kernel_decode, one thread a candidate over the whole card:
//     the same decode, the box and area written once to the scratch, and
//     each class score at or above the threshold appended as a 64-bit key
//     (score bits, index) to its row's list, a segment a block, with the
//     row's NaN flag;
//   * yolo_head_kernel_select, one block a row: radix select of the next
//     kCap keys, a sort in shared memory, and a scan that tests each
//     candidate once, against the winners kept before it.
// The two agree with the step loop bit for bit where the threshold is above
// -1e9; at or below it (suppressed candidates stay selectable) and where a
// select block's shared memory cannot hold max_out winners, the wrapper
// runs the step loop in global scratch (greedy::GlobalBoxes,
// yolo_head_scratch_bytes a block).  The wrapper picks the path
// (ops/nms_pallas.greedy_plan, ops/yolo_head_pallas._launch).  Every kernel
// here has yolo_head_kernel in its name.
//
// Inputs : preds [B, N, E] fp32 (E = 5 + C: tx ty tw th conf cls...),
//          geom  [8, N] fp32 (gx, gy, 1/gw, 1/gh, anchor_w, anchor_h, s,
//                -(s - 1) / 2): s is the layer's darknet scale_x_y, 1 (and
//                0) where it has none, which leaves the sigmoid bit for bit,
//                x = (sigmoid(tx) * s - (s - 1) / 2 + gx) / gw,
//          lbox  [B, 8] fp32 (off_y, off_x, sy, sx, img_h, img_w, 0, 0),
//          scratch: null (shared memory) or yolo_head_scratch_bytes(n, G)
//          a block (the step loop's global path) or
//          yolo_head_ordered_scratch_bytes(B, N, C) (the ordered path),
//          16-byte aligned.
// Outputs: out_scores [B, C, M] and out_boxes [B, C, M, 4] winner buffers;
//          slot k holds winner k, unfilled slots hold -1e9 and zero boxes.
//          The caller masks slots below the threshold.

#include "greedy_select.cuh"
#include "ordered_select.cuh"
#include "smem.cuh"

namespace {

using greedy::box_area;
using greedy::kGlobal;
using greedy::kMaxRows;
using greedy::kMinWarps;
using greedy::kOwn;
using greedy::kShared;
using greedy::tame_box;
using greedy::nan_max;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// An image's correct_box factors (lbox row b).
struct Letterbox {
  float off_y, off_x, sy, sx, ih, iw;
  __device__ explicit Letterbox(const float* lb)
      : off_y(lb[0]), off_x(lb[1]), sy(lb[2]), sx(lb[3]), ih(lb[4]),
        iw(lb[5]) {}
};

// Candidate j's box (y0, x0, y1, x1) in the image's pixels, from its logits
// p: the decode, then the letterbox inverse.
__device__ __forceinline__ float4 decode_box(const float* p,
                                             const float* geom, int n, int j,
                                             const Letterbox& lb) {
  const float sxy = geom[6 * n + j], shift = geom[7 * n + j];
  const float cx = (sigmoid(p[0]) * sxy + shift + geom[j]) * geom[2 * n + j];
  const float cy =
      (sigmoid(p[1]) * sxy + shift + geom[n + j]) * geom[3 * n + j];
  const float bw = expf(p[2]) * geom[4 * n + j];
  const float bh = expf(p[3]) * geom[5 * n + j];
  const float oy = (cy - lb.off_y) * lb.sy;
  const float ox = (cx - lb.off_x) * lb.sx;
  const float oh = bh * lb.sy;
  const float ow = bw * lb.sx;
  return make_float4((oy - oh * 0.5f) * lb.ih, (ox - ow * 0.5f) * lb.iw,
                     (oy + oh * 0.5f) * lb.ih, (ox + ow * 0.5f) * lb.iw);
}

// A candidate's class scores from its logits p: sigmoid(cls) * conf, or the
// softmax over the real classes (its sum in class order) times conf.
struct ClassScores {
  const float* p;
  float conf, mx, sum;
  int softmax;

  __device__ ClassScores(const float* p_, int classes, int class_softmax)
      : p(p_), conf(sigmoid(p_[4])), mx(0.0f), sum(0.0f),
        softmax(class_softmax) {
    if (softmax) {
      mx = p[5];
      for (int k = 1; k < classes; ++k) mx = nan_max(mx, p[5 + k]);
      sum = expf(p[5] - mx);
      for (int k = 1; k < classes; ++k) sum = sum + expf(p[5 + k] - mx);
    }
  }
  __device__ float operator()(int c) const {
    return softmax ? expf(p[5 + c] - mx) / sum * conf
                   : sigmoid(p[5 + c]) * conf;
  }
};

// Floats a candidate of the block's own in its global slab: box and area.
constexpr int kGlobalPerCandidate = 5;

template <int kLayout>
__global__ void __launch_bounds__(32 * kMaxRows)
yolo_head_kernel(const float* __restrict__ preds,
                 const float* __restrict__ geom,
                 const float* __restrict__ lbox,
                 float* __restrict__ out_scores,
                 float* __restrict__ out_boxes,
                 float* scratch,   // written and read back: not restrict
                 int n, int classes, int rows, int max_out,
                 float iou_thresh, float score_thresh, int class_softmax) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * rows;
  const int n_rows = min(rows, classes - c0);
  const int e = 5 + classes;
  const float* p_img = preds + (size_t)b * n * e;
  const Letterbox lb(lbox + (size_t)b * 8);

  // the block's arrays: in shared memory at stride n, or in its own slab
  // of the scratch tensor at a 16-byte aligned stride
  const int ns = kLayout == kGlobal ? (int)greedy::global_stride(n) : n;
  float* smem = kLayout == kGlobal
      ? scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x)
                      * greedy::scratch_floats(n, rows, kGlobalPerCandidate)
      : reinterpret_cast<float*>(smem4);
  float4* s_box = reinterpret_cast<float4*>(smem);
  float* s_more = smem + 4 * ns;  // areas (shared, global) or the row's
                                  // scores (own)
  float* s_score = kLayout == kOwn ? s_more : smem + 5 * ns;

  // decode every candidate of image b once, score it for the G classes
  bool is_tame = true;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* p = p_img + (size_t)j * e;
    const float4 box = decode_box(p, geom, n, j, lb);
    s_box[j] = box;
    if (kLayout != kOwn) s_more[j] = box_area(box.x, box.y, box.z, box.w);
    is_tame &= tame_box(box.x, box.y, box.z, box.w);
    const ClassScores cs(p, classes, class_softmax);
    for (int g = 0; g < n_rows; ++g) s_score[g * ns + j] = cs(c0 + g);
  }
  // also orders the decode's writes to the global slab before the loops'
  // reads
  const bool tame = __syncthreads_and(is_tame);

  const int g = threadIdx.x >> 5;
  if (g >= n_rows) return;
  const int c = c0 + g;
  float* os = out_scores + ((size_t)b * classes + c) * max_out;
  float* ob = out_boxes + ((size_t)b * classes + c) * max_out * 4;
  if (kLayout == kGlobal) {
    int* s_idx = reinterpret_cast<int*>(smem + 5 * ns + rows * ns);
    const greedy::GlobalBoxes row{s_box, s_more, s_score + g * ns,
                                  s_idx + g * ns};
    greedy::select_row(row, n, tame, max_out, iou_thresh, score_thresh, os,
                       ob);
  } else if (kLayout == kShared) {
    unsigned short* s_idx =
        reinterpret_cast<unsigned short*>(smem + 5 * ns + rows * ns);
    const greedy::SharedBoxes row{s_box, s_more, s_score + g * ns,
                                  s_idx + g * ns};
    greedy::select_row(row, n, tame, max_out, iou_thresh, score_thresh, os,
                       ob);
  } else {
    const greedy::OwnBoxes row{s_box, s_score};
    greedy::select_row(row, n, tame, max_out, iou_thresh, score_thresh, os,
                       ob);
  }
}

// The kernel of a launch (greedy::pick_kernel).
decltype(&yolo_head_kernel<kOwn>) pick_kernel(int rows, bool global) {
  return greedy::pick_kernel(rows, global, yolo_head_kernel<kOwn>,
                             yolo_head_kernel<kShared>,
                             yolo_head_kernel<kGlobal>);
}

// The ordered path's first kernel: decodes candidate j = blockIdx.x * kSeg
// + threadIdx.x of image blockIdx.y once, writes its box and area to the
// scratch, and appends its key to segment blockIdx.x of each class row
// whose score is at or above the threshold (ordered::append_segment).
__global__ void __launch_bounds__(ordered::kSeg)
yolo_head_kernel_decode(const float* __restrict__ preds,
                        const float* __restrict__ geom,
                        const float* __restrict__ lbox, void* scratch, int n,
                        int classes, float score_thresh, int class_softmax) {
  __shared__ int counts[2 * (ordered::kSeg / 32)];
  const int b = blockIdx.y, seg = blockIdx.x, n_seg = gridDim.x;
  const int j = seg * ordered::kSeg + threadIdx.x;
  const bool valid = j < n;
  const ordered::Scratch sc =
      ordered::scratch_at(scratch, gridDim.y, n, classes);
  const float* p =
      preds + ((size_t)b * n + (valid ? j : 0)) * (5 + classes);
  if (valid) {
    const float4 box = decode_box(p, geom, n, j, Letterbox(lbox + b * 8));
    sc.boxes[(size_t)b * n + j] = box;
    sc.areas[(size_t)b * n + j] = box_area(box.x, box.y, box.z, box.w);
  }
  const ClassScores cs(p, classes, class_softmax);
  for (int c = 0; c < classes; ++c) {
    const float s = valid ? cs(c) : 0.0f;
    const size_t at = ((size_t)b * classes + c) * n_seg + seg;
    ordered::append_segment(sc.keys + at * ordered::kSeg, sc.info + at,
                            valid && s >= score_thresh, valid && s != s, s,
                            j, counts, c & 1);
  }
}

// The ordered path's second kernel: row (image blockIdx.y, class
// blockIdx.x) in score order (ordered::select_row), one block a row.
__global__ void __launch_bounds__(ordered::kThreads)
yolo_head_kernel_select(void* scratch, float* __restrict__ out_scores,
                        float* __restrict__ out_boxes,
                        unsigned long long* tested, int n, int max_out,
                        float iou_thresh) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, classes = gridDim.x;
  const int n_seg = (n + ordered::kSeg - 1) / ordered::kSeg;
  const size_t row = (size_t)b * classes + blockIdx.x;
  const ordered::Scratch sc =
      ordered::scratch_at(scratch, gridDim.y, n, classes);
  ordered::Shared sh;
  sh.keys = reinterpret_cast<ordered::Key*>(smem4);
  sh.wbox = reinterpret_cast<float4*>(sh.keys + ordered::kCap);
  sh.cbox = sh.wbox + max_out;
  sh.warea = reinterpret_cast<float*>(sh.cbox + ordered::kThreads);
  sh.carea = sh.warea + max_out;
  sh.seg_cnt = reinterpret_cast<int*>(sh.carea + ordered::kThreads);
  ordered::select_row(sc.keys + row * n_seg * ordered::kSeg,
                      sc.info + row * n_seg, n_seg, sc.boxes + (size_t)b * n,
                      sc.areas + (size_t)b * n, max_out, iou_thresh,
                      out_scores + row * max_out,
                      out_boxes + row * max_out * 4, tested, sh);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of g class rows of n candidates.
size_t yolo_head_smem_bytes(int n, int g) { return greedy::smem_bytes(n, g); }

// The most class rows a block runs (the `rows` of a launch).
int yolo_head_max_rows() { return kMaxRows; }

// Bytes of global scratch one block of g class rows of n candidates takes
// on the global path (greedy::GlobalBoxes); a multiple of 16.
size_t yolo_head_scratch_bytes(int n, int g) {
  return greedy::scratch_floats(n, g, kGlobalPerCandidate) * sizeof(float);
}

// The most dynamic shared memory a block may ask for on the current device,
// the smaller of the two shared layouts' limits.  Returns the cudaError_t of
// the queries.
int yolo_head_max_dynamic_smem(int* bytes) {
  int own = 0, shared = 0;
  int err = max_dynamic_smem(yolo_head_kernel<kOwn>, &own);
  if (err == 0) err = max_dynamic_smem(yolo_head_kernel<kShared>, &shared);
  *bytes = own < shared ? own : shared;
  return err;
}

// Blocks of `rows` class rows of n candidates that one SM holds at once on
// the current device (the occupancy calculator's answer), on the global
// path where `global`.  Returns the cudaError_t of the query.
int yolo_head_blocks_per_sm(int n, int rows, int global, int* blocks) {
  const auto kernel = pick_kernel(rows, global);
  const int threads = 32 * (rows > kMinWarps ? rows : kMinWarps);
  const size_t smem = global ? 0 : greedy::smem_bytes(n, rows);
  // the calculator holds the size to the kernel's opted-in limit
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem);
}

// Launches the kernel on `stream` with `rows` class rows a block (1 to
// kMaxRows): in shared memory where `scratch` is null, else on the global
// path, block (x, y) in the yolo_head_scratch_bytes(n, rows) bytes at
// scratch + (y * gridDim.x + x) times that.  Returns the cudaError_t of the
// launch.
int yolo_head_decode_nms(const float* preds, const float* geom,
                         const float* lbox, float* out_scores,
                         float* out_boxes, float* scratch, int batch, int n,
                         int classes, int rows, int max_out, float iou_thresh,
                         float score_thresh, int class_softmax, void* stream) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  const bool global = scratch != nullptr;
  // the default limit (48 KB) counts static and dynamic shared memory
  // together, so opt in to the dynamic size on every launch
  const size_t smem = global ? 0 : greedy::smem_bytes(n, rows);
  const auto kernel = pick_kernel(rows, global);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((classes + rows - 1) / rows, batch);
  const int threads = 32 * (rows > kMinWarps ? rows : kMinWarps);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      preds, geom, lbox, out_scores, out_boxes, scratch, n, classes, rows,
      max_out, iou_thresh, score_thresh, class_softmax);
  return (int)cudaGetLastError();
}

// Bytes of global scratch of an ordered launch (ordered::scratch_bytes); a
// multiple of 16.
size_t yolo_head_ordered_scratch_bytes(int batch, int n, int classes) {
  return ordered::align16(ordered::scratch_bytes(batch, n, classes));
}

// Dynamic shared memory of an ordered launch's select block.
size_t yolo_head_ordered_smem_bytes(int n, int max_out) {
  return ordered::smem_bytes((n + ordered::kSeg - 1) / ordered::kSeg,
                             max_out);
}

// The most dynamic shared memory the select kernel may ask for on the
// current device.  Returns the cudaError_t of the queries.
int yolo_head_ordered_max_smem(int* bytes) {
  return max_dynamic_smem(yolo_head_kernel_select, bytes);
}

// Launches the ordered path on `stream`: yolo_head_kernel_decode over
// (ceil(n / kSeg), batch) blocks, then yolo_head_kernel_select over
// (classes, batch), both on the yolo_head_ordered_scratch_bytes(batch, n,
// classes) bytes at `scratch` (16-byte aligned).  Adds each row's scan
// depth to *tested where `tested` is not null.  For a threshold above -1e9
// only (the note of ordered_select.cuh).  Returns the cudaError_t of the
// launches.
int yolo_head_ordered(const float* preds, const float* geom,
                      const float* lbox, float* out_scores, float* out_boxes,
                      void* scratch, unsigned long long* tested, int batch,
                      int n, int classes, int max_out, float iou_thresh,
                      float score_thresh, int class_softmax, void* stream) {
  if (!(score_thresh > greedy::kNeg)) return (int)cudaErrorInvalidValue;
  const size_t smem = yolo_head_ordered_smem_bytes(n, max_out);
  cudaError_t err = cudaFuncSetAttribute(
      yolo_head_kernel_select, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 decode_grid((n + ordered::kSeg - 1) / ordered::kSeg, batch);
  yolo_head_kernel_decode<<<decode_grid, ordered::kSeg, 0, s>>>(
      preds, geom, lbox, scratch, n, classes, score_thresh, class_softmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  yolo_head_kernel_select<<<dim3(classes, batch), ordered::kThreads, smem,
                            s>>>(scratch, out_scores, out_boxes, tested, n,
                                 max_out, iou_thresh);
  return (int)cudaGetLastError();
}

const char* yolo_head_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
