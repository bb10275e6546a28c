// Per-class greedy NMS over decoded boxes for Hopper (sm_90a): one thread
// block per (image, group of G classes), one warp per class row.
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
// 3.35 TB/s.  The bound is each row's chain of up to max_out steps, each a
// pass over the candidates still live (greedy_select.cuh).  The block:
//   * loads the image's N boxes (and their areas) into shared memory once
//     for its G rows, and the G classes' scores as one coalesced [N, G] slab
//     of the [N, C] scores;
//   * notes, in the same pass and the one barrier after it, whether every
//     box is finite and within +-kTame (the loop's IoU then needs no NaN
//     handling);
//   * then runs each row in its own warp, with no block barrier in the loop;
//   * a warp past the G rows, or whose class lies past C (when C % G != 0),
//     helps load and writes nothing.
// At G == 1 the row's scores and boxes are compacted together in place (5
// floats a candidate), which fits the most candidates.  The wrapper picks G
// (ops/nms_pallas.rows_per_block) against the footprint nms_smem_bytes and
// the blocks the batch gives: 20 at B=128, 1 at B=1 on an H100.  Where not
// even G == 1 fits (above 11,622 candidates on an H100), the rows run on
// the global path (greedy::GlobalBoxes): the boxes are read from the input
// itself, and the areas and each row's list go to the block's own slab of
// a global scratch tensor (nms_scratch_bytes a block); the wrapper picks
// that path and its G (ops/nms_pallas.greedy_plan).
//
// Inputs : boxes [B, N, 4] fp32 yxyx, scores [B, N, C] fp32, both contiguous;
//          scratch: null (shared memory) or nms_scratch_bytes(n, G) a block,
//          16-byte aligned (the global path).
// Outputs: out_scores [B, C, M] and out_boxes [B, C, M, 4] winner buffers;
//          slot k holds winner k, unfilled slots hold -1e9 and zero boxes.
//          The caller masks slots below the threshold.

#include "greedy_select.cuh"
#include "smem.cuh"

namespace {

using greedy::box_area;
using greedy::kGlobal;
using greedy::kMaxRows;
using greedy::kMinWarps;
using greedy::kOwn;
using greedy::kShared;
using greedy::tame_box;

// Floats a candidate of the block's own in its global slab: the area (the
// boxes are read from the input).
constexpr int kGlobalPerCandidate = 1;

template <int kLayout>
__global__ void __launch_bounds__(32 * kMaxRows)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           float* __restrict__ out_scores, float* __restrict__ out_boxes,
           float* scratch,   // written and read back: not restrict
           int n, int classes, int rows, int max_out, float iou_thresh,
           float score_thresh) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * rows;
  const int n_rows = min(rows, classes - c0);
  const float4* bx = reinterpret_cast<const float4*>(boxes + (size_t)b * n * 4);
  const float* sc = scores + (size_t)b * n * classes + c0;

  // the block's arrays: in shared memory at stride n (boxes first), or
  // areas and lists in its own slab of the scratch tensor at a 16-byte
  // aligned stride, the boxes staying in the input
  const int ns = kLayout == kGlobal ? (int)greedy::global_stride(n) : n;
  float* smem = reinterpret_cast<float*>(smem4);
  float4* s_box = smem4;
  float* s_more = smem + 4 * ns;  // areas (shared) or the row's scores (own)
  float* s_score = kLayout == kOwn ? s_more : smem + 5 * ns;
  if (kLayout == kGlobal) {
    s_more = scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x)
                           * greedy::scratch_floats(n, rows,
                                                    kGlobalPerCandidate);
    s_score = s_more + ns;
  }
  bool is_tame = true;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float4 box = bx[j];
    if (kLayout != kGlobal) s_box[j] = box;
    if (kLayout != kOwn) s_more[j] = box_area(box.x, box.y, box.z, box.w);
    is_tame &= tame_box(box.x, box.y, box.z, box.w);
  }
  // the G classes' scores, [N, G] of the [N, C] rows, into G rows of N
  for (int e = threadIdx.x; e < n * rows; e += blockDim.x) {
    const int j = e / rows;
    const int g = e - j * rows;
    if (g < n_rows) s_score[g * ns + j] = sc[(size_t)j * classes + g];
  }
  // also orders the writes to the global slab before the loops' reads
  const bool tame = __syncthreads_and(is_tame);

  const int g = threadIdx.x >> 5;
  if (g >= n_rows) return;
  const int c = c0 + g;
  float* os = out_scores + ((size_t)b * classes + c) * max_out;
  float* ob = out_boxes + ((size_t)b * classes + c) * max_out * 4;
  if (kLayout == kGlobal) {
    int* s_idx = reinterpret_cast<int*>(s_score + rows * ns);
    const greedy::GlobalBoxes row{bx, s_more, s_score + g * ns,
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
decltype(&nms_kernel<kOwn>) pick_kernel(int rows, bool global) {
  return greedy::pick_kernel(rows, global, nms_kernel<kOwn>,
                             nms_kernel<kShared>, nms_kernel<kGlobal>);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of g class rows of n candidates.
size_t nms_smem_bytes(int n, int g) { return greedy::smem_bytes(n, g); }

// The most class rows a block runs (the `rows` of a launch).
int nms_max_rows() { return kMaxRows; }

// Bytes of global scratch one block of g class rows of n candidates takes
// on the global path (greedy::GlobalBoxes); a multiple of 16.
size_t nms_scratch_bytes(int n, int g) {
  return greedy::scratch_floats(n, g, kGlobalPerCandidate) * sizeof(float);
}

// The most dynamic shared memory a block may ask for on the current device,
// the smaller of the two shared layouts' limits.  Returns the cudaError_t of
// the queries.
int nms_max_dynamic_smem(int* bytes) {
  int own = 0, shared = 0;
  int err = max_dynamic_smem(nms_kernel<kOwn>, &own);
  if (err == 0) err = max_dynamic_smem(nms_kernel<kShared>, &shared);
  *bytes = own < shared ? own : shared;
  return err;
}

// Launches the kernel on `stream` with `rows` class rows a block (1 to
// kMaxRows): in shared memory where `scratch` is null, else on the global
// path, block (x, y) in the nms_scratch_bytes(n, rows) bytes at scratch +
// (y * gridDim.x + x) times that.  Returns the cudaError_t of the launch.
int nms_select(const float* boxes, const float* scores, float* out_scores,
               float* out_boxes, float* scratch, int batch, int n,
               int classes, int rows, int max_out, float iou_thresh,
               float score_thresh, void* stream) {
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
      boxes, scores, out_scores, out_boxes, scratch, n, classes, rows,
      max_out, iou_thresh, score_thresh);
  return (int)cudaGetLastError();
}

const char* nms_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
