// The training augment's 3-shear rotation for Hopper (sm_90a): one launch,
// one thread block per (image, output tile of TR rows x TC columns), every
// intermediate value in shared memory or registers.
//
// Replaces the TPU kernel k210_yolo_framework_tpu/ops/rotate_pallas.py:
// _rot3_kernel (reached through rotate_3shear_pallas).  The plain PyTorch
// version of the same function is _rotate_plain / rotate_3shear_reference in
// k210_yolo_framework_tpu_torch/ops/rotate_pallas.py.  A centre rotation is
// Sx . Sy . Sx over a zero-padded working frame [hp, wp] holding the image at
// (py, px).  Each pass gives every frame position
//     w0 * src[p - k] + w1 * src[p - k - 1]
// along its line (a frame row for Sx, a frame column for Sy), with the line's
// k, w0 = 1 - f and w1 = f from the caller's tables and zeros outside the
// frame.  Every mul and add is an explicit round-to-nearest intrinsic (no
// contraction) of the plain version's operands, so the result equals it bit
// for bit.
//
// What bounds it: bytes.  The image is read once and the output written once
// (36 MB in bf16 at N=42 224x320x3: 0.011 ms at 3.35 TB/s), against 9
// operations an element.  The TPU kernel held the image's whole fp32 frame in
// VMEM (1.19 MB at 224x320x3); a block's shared memory holds 227 KB, so a
// block keeps only what its tile's outputs reach, and no frame goes to device
// memory:
//   * pass 3 (Sx) reads, for output row fy, pass-2 values at frame columns
//     fx - kx[fy] - {0, 1}.  Over the tile's TR rows kx moves by about
//     tan(5 deg) x TR, so the tile needs W1 = TC + 1 + that many pass-2
//     columns (the staged columns);
//   * pass 2 (Sy) at (fy, c) reads pass-1 values at rows fy - ky[c] - {0, 1}.
//     A thread walks down one staged (column, channel): it computes pass 1
//     at rows fy0 - 1 - ky[c] .. fy0 + TR - 1 - ky[c] from two image taps
//     each (read in the image's dtype; L2 serves the overlap between
//     neighbouring tiles), keeps the last one in a register, and stores
//     pass 2 of each tile row once: TR x W1 x C fp32 values in shared memory;
//   * pass 3 walks down each output (column, channel) and writes it once in
//     the image's dtype (round to nearest even, as torch's .to() does).
// The x tables of every frame row sit in shared memory.  All index math is
// 32-bit and flat along a row (column x C + channel); the only divisions are
// one per block and one per staged (column, channel).  In both walks every
// load is made from a clamped address and selected afterwards, so the
// unrolled loops issue several rows' loads together: the kernel waits on
// memory latency, not bandwidth (phase split in PERF.md).  A pass-2 column
// inside the frame but outside the staged ones (only when the x offsets
// spread more than |theta| <= 10 degrees allows) is computed from the image
// directly by the same arithmetic, so any table gives the plain version's
// result.  The wrapper chooses TR and TC (ops/rotate_pallas.plan_tile)
// against the footprint rotate3shear_smem_bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "smem.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float load(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// One pass's value: w0 * a + w1 * b, each product and the sum rounded once.
__device__ __forceinline__ float blend(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// a - b wrapping around as two's complement: a table may hold any k.
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

struct Geom {
  int h, w, c;          // image
  int px, py, hp, wp;   // frame: pads and size
  int tr, tc, w1;       // tile rows and columns, staged columns
  int tiles_x, tiles_y;
};

// One image's per-line tables: x [hp] (per frame row), y [wp] (per column).
struct Tables {
  const int* kx;
  const float* wx0;
  const float* wx1;
  const int* ky;
  const float* wy0;
  const float* wy1;
};

// The x tables of every frame row, staged in shared memory.
struct RowTables {
  const int* k;
  const float* w0;
  const float* w1;
};

// Pass 1 (Sx) at frame row r of staged column entry j (column c0 + j / C,
// channel j % C), read from the image row; 0 outside the frame.  r may be
// anything: it wraps, and a row outside [0, hp) is 0.  Every load is made
// (from a clamped, valid address) and its value selected afterwards, so an
// unrolled loop issues the loads of several rows together.
template <typename T>
__device__ __forceinline__ float pass1_staged(const T* im, const RowTables& x,
                                              const Geom& g, int r, int c0,
                                              int j) {
  const bool r_in = (unsigned)r < (unsigned)g.hp;
  const int rc = r_in ? r : 0;
  const int y = rc - g.py;
  // image column of tap 0 at staged column 0
  const int xs = wrap_sub(c0 - g.px, x.k[rc]);
  const float w0 = x.w0[rc], w1 = x.w1[rc];
  const int wc = g.w * g.c;
  // taps at image columns xs + j / C and one left of it, with j / C < wp;
  // f = -1 - C puts both outside
  const bool y_in = (unsigned)y < (unsigned)g.h;
  const int f =
      y_in && xs > -g.wp && xs <= g.w ? xs * g.c + j : -1 - g.c;
  const bool a_in = (unsigned)f < (unsigned)wc;
  const bool b_in = (unsigned)(f - g.c) < (unsigned)wc;
  const T* row = im + (y_in ? y : 0) * wc;
  const float a = load(row, a_in ? f : 0), b = load(row, b_in ? f - g.c : 0);
  const float v = blend(w0, a_in ? a : 0.0f, w1, b_in ? b : 0.0f);
  return r_in ? v : 0.0f;
}

// Pass 2 (Sy) at frame row fy, frame flat index fq (column fq / C, inside
// the frame; channel fq % C), from the image: the path of a column the
// block did not stage.  Pass 1 as above, staged column 0 being frame
// column 0.
template <typename T>
__device__ float pass2_at(const T* im, const RowTables& x, const Tables& t,
                          const Geom& g, int fy, int fq) {
  const int col = fq / g.c;
  const int r = wrap_sub(fy, t.ky[col]);
  return blend(t.wy0[col], pass1_staged(im, x, g, r, 0, fq), t.wy1[col],
               pass1_staged(im, x, g, wrap_sub(r, 1), 0, fq));
}

// Three blocks an SM (40 registers a thread): the wrapper plans the tile
// for the shared memory of three (ops/rotate_pallas.BLOCKS_PER_SM).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
rotate_kernel(const T* __restrict__ img, T* __restrict__ out,
              const int* __restrict__ kxt, const float* __restrict__ wx0t,
              const float* __restrict__ wx1t, const int* __restrict__ kyt,
              const float* __restrict__ wy0t, const float* __restrict__ wy1t,
              const Geom g) {
  extern __shared__ float smem[];
  __shared__ int s_c0, s_ncols;

  int b = blockIdx.x;
  const int tx = b % g.tiles_x;
  b /= g.tiles_x;
  const int ty = b % g.tiles_y;
  const int n = b / g.tiles_y;
  const int y0 = ty * g.tr, x0 = tx * g.tc;
  const int rows = min(g.tr, g.h - y0), cols = min(g.tc, g.w - x0);
  const int fy0 = g.py + y0, fx0 = g.px + x0;   // frame position of output 0
  const int wc = g.w * g.c;
  const T* im = img + (size_t)n * g.h * wc;
  T* o = out + (size_t)n * g.h * wc;
  const Tables t{kxt + (size_t)n * g.hp, wx0t + (size_t)n * g.hp,
                 wx1t + (size_t)n * g.hp, kyt + (size_t)n * g.wp,
                 wy0t + (size_t)n * g.wp, wy1t + (size_t)n * g.wp};

  // layout: pass 2 [tr][w1 x c] | the x tables kx, wx0, wx1 [hp]
  float* band = smem;
  float* xw0 = band + g.tr * g.w1 * g.c;
  float* xw1 = xw0 + g.hp;
  int* xk = reinterpret_cast<int*>(xw1 + g.hp);
  const RowTables x{xk, xw0, xw1};
  const int tid = threadIdx.x, lane = tid & 31;

  // 1. the x tables, and the pass-2 columns pass 3 reads
  for (int r = tid; r < g.hp; r += kThreads) {
    xk[r] = t.kx[r];
    xw0[r] = t.wx0[r];
    xw1[r] = t.wx1[r];
  }
  if (tid < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = lane; i < rows; i += 32) {
      const int k = t.kx[fy0 + i];
      lo = min(lo, k);
      hi = max(hi, k);
    }
    for (int s = 16; s > 0; s >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, s));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, s));
    }
    if (lane == 0) {
      // columns fx0 - hi - 1 .. fx0 + cols - 1 - lo, inside the frame
      const long long first = max((long long)fx0 - hi - 1, 0LL);
      const long long last = min((long long)fx0 + cols - 1 - lo,
                                 (long long)g.wp - 1);
      s_c0 = first <= last ? (int)first : 0;
      s_ncols = first <= last ? (int)min(last - first + 1, (long long)g.w1)
                              : 0;
    }
  }
  __syncthreads();
  const int c0 = s_c0, ncc = s_ncols * g.c;

  // 2. passes 1 and 2 down each staged (column, channel) j: pass 1 at frame
  //    rows fy0 - 1 - ky + i, i = 0 .. rows, each computed once and kept in
  //    registers; band[i][j] = pass 2 at frame row fy0 + i from rows i and
  //    i + 1 of that run
  for (int j = tid; j < ncc; j += kThreads) {
    const int col = c0 + j / g.c;
    const float w0 = t.wy0[col], w1 = t.wy1[col];
    const int r0 = wrap_sub(fy0 - 1, t.ky[col]);
    float prev = pass1_staged(im, x, g, r0, c0, j);
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const float cur = pass1_staged(im, x, g, wrap_sub(r0, -(i + 1)), c0, j);
      band[i * ncc + j] = blend(w0, cur, w1, prev);
      prev = cur;
    }
  }
  __syncthreads();

  // 3. pass 3 down each output (column, channel) j of the tile; the
  //    common path loads unconditionally and selects, the rare one (a
  //    pass-2 column in the frame but not staged) reads the image
  const int fwc = g.wp * g.c;
  for (int j = tid; j < cols * g.c; j += kThreads) {
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      // frame column of tap 0 of the row's first output; outside the range
      // below every tap of the row is outside the frame
      const int fc = wrap_sub(fx0, xk[fy0 + i]);
      const bool row_in = fc > -cols && fc <= g.wp;
      const int q = row_in ? (fc - c0) * g.c + j : -2 * g.c;  // tap 0
      const int fq = c0 * g.c + q;                              // in frame
      const bool in0 = row_in && (unsigned)fq < (unsigned)fwc;
      const bool in1 = row_in && (unsigned)(fq - g.c) < (unsigned)fwc;
      const bool st0 = (unsigned)q < (unsigned)ncc;
      const bool st1 = (unsigned)(q - g.c) < (unsigned)ncc;
      const float* line = band + i * ncc;
      float a = line[st0 ? q : 0], bb = line[st1 ? q - g.c : 0];
      a = in0 && st0 ? a : 0.0f;
      bb = in1 && st1 ? bb : 0.0f;
      if ((in0 && !st0) || (in1 && !st1)) {
        if (in0 && !st0) a = pass2_at(im, x, t, g, fy0 + i, fq);
        if (in1 && !st1) bb = pass2_at(im, x, t, g, fy0 + i, fq - g.c);
      }
      store(o, (y0 + i) * wc + x0 * g.c + j,
            blend(xw0[fy0 + i], a, xw1[fy0 + i], bb));
    }
  }
}

template <typename T>
cudaError_t launch(const T* img, T* out, const int* kx, const float* wx0,
                   const float* wx1, const int* ky, const float* wy0,
                   const float* wy1, int n, const Geom& g,
                   cudaStream_t stream) {
  const size_t smem = 4 * ((size_t)g.tr * g.w1 * g.c + 3 * (size_t)g.hp);
  // the default limit (48 KB) counts static and dynamic shared memory
  // together; ask for what this launch uses
  cudaError_t err = cudaFuncSetAttribute(
      rotate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)n * g.tiles_x * g.tiles_y;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  rotate_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      img, out, kx, wx0, wx1, ky, wy0, wy1, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block of `tr` rows with `w1` staged
// columns of `c` channels uses, in a frame of `hp` rows.
size_t rotate3shear_smem_bytes(int tr, int w1, int c, int hp) {
  return 4 * ((size_t)tr * w1 * c + 3 * (size_t)hp);
}

// The most dynamic shared memory a block may ask for on the current device
// while `blocks_per_sm` blocks share an SM.  Returns the cudaError_t of the
// queries.
int rotate3shear_max_dynamic_smem(int blocks_per_sm, int* bytes) {
  int dev = 0, per_sm = 0, reserved = 0, own = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return (int)err;
  // the per-block limit (opt-in less static) of both instantiations
  int limit = 0;
  int e = max_dynamic_smem(rotate_kernel<float>, &limit);
  if (e == 0) e = max_dynamic_smem(rotate_kernel<__nv_bfloat16>, &own);
  if (e != 0) return e;
  limit = limit < own ? limit : own;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, rotate_kernel<float>);
  if (err != cudaSuccess) return (int)err;
  const int shared = per_sm / (blocks_per_sm > 0 ? blocks_per_sm : 1) -
                     reserved - (int)attr.sharedSizeBytes;
  *bytes = shared < limit ? shared : limit;
  return 0;
}

// Rotates img [n, h, w, c] (fp32 when bf16 == 0, bf16 otherwise) into out
// (same shape and dtype).  Tables: kx/wx0/wx1 [n, hp], ky/wy0/wy1 [n, wp].
// Tiles of tr x tc outputs, w1 staged columns (the wrapper's plan).
// Launches on `stream`; returns the cudaError_t of the launch.
int rotate3shear(const void* img, int bf16, void* out, const int* kx,
                 const float* wx0, const float* wx1, const int* ky,
                 const float* wy0, const float* wy1, int n, int h, int w,
                 int c, int px, int py, int hp, int wp, int tr, int tc,
                 int w1, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || tr < 1 || tc < 1 || w1 < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g{h,  w,  c,  px, py, hp, wp, tr, tc, w1, (w + tc - 1) / tc,
               (h + tr - 1) / tr};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)launch((const __nv_bfloat16*)img, (__nv_bfloat16*)out, kx,
                       wx0, wx1, ky, wy0, wy1, n, g, s);
  return (int)launch((const float*)img, (float*)out, kx, wx0, wx1, ky, wy0,
                     wy1, n, g, s);
}

const char* rotate3shear_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
