// Hand-written Hopper (sm_90a) kernels of the device compose fold
// (vfx_image_stitching_tpu_torch/compose/blend.py): the plan's fold of the
// cylindrical images into the final mosaic, one step at a time, over each
// step's column band only.  They replace no TPU kernel: the JAX package's
// fold is XLA ops.  The wrapper, its plain version and the design note live
// in compose/blend.py.  Built into a library of its own, with -fmad=false
// and without --use_fast_math.
//
// Plain C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                      // warps a block
constexpr int kRowsPerWarp = 4;                // rows each warp walks
constexpr int kRows = kWarps * kRowsPerWarp;   // rows a block covers
constexpr unsigned kAll = 0xffffffffu;

// Column occupancy of every image: flags[n * w + c] = 1 where column c of
// image n holds a nonzero byte over its rows and 3 channels.  Block
// (x, y, n): lane j of each warp takes column 32 x + j, the warps rows
// y * kRows + warp * kRowsPerWarp on; a row of a warp is 96 consecutive
// bytes.  Blocks of one column store the same 1, so the flags (zero before
// the launch) need no atomics.  Image 0's flags also mark the mosaic's
// occupancy at its offset ox0 (canvas_occ, zero before the launch).
__global__ void __launch_bounds__(kWarps * 32)
column_occupancy_kernel(const uint8_t* __restrict__ images, int h, int w,
                        uint8_t* __restrict__ flags,
                        uint8_t* __restrict__ canvas_occ, int ox0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int n = blockIdx.z;
  if (c >= w) return;
  const int r0 = blockIdx.y * kRows + warp * kRowsPerWarp;
  const uint8_t* img = images + (size_t)n * h * w * 3;
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    if (r < h) {
      const uint8_t* p = img + ((size_t)r * w + c) * 3;
      acc |= p[0] | p[1] | p[2];
    }
  }
  if (acc) {
    flags[(size_t)n * w + c] = 1;
    if (n == 0) canvas_occ[ox0 + c] = 1;
  }
}

// One fold step: the image (ih, iw, 3) at (oy, x0) of the (hc, wc, 3)
// canvas, whose column band is [x0, x0 + iw).  The arithmetic is the host
// fold's (compose/host.py:_fold_step):
//   * image-only columns (the mosaic's are all zero there) take the image's
//     rows [oy, oy + ih);
//   * overlap columns blend every canvas row, with alpha = the exclusive
//     count of overlap columns left of the column in the band, over
//     overlap_range, in float64 (0 where the range is 0); w_b = (float)
//     alpha, w_a = (float)(1 - alpha); the mosaic and image weights follow
//     `swapped`; two float32 products and their float32 sum, each rounded
//     on its own; clamped to [0, 255] and truncated to uint8;
//   * every other column is left as it is.
// The mosaic's occupancy before the step is occ_in; the kernel writes the
// occupancy after it to occ_out, which the previous launch cleared, and
// clears occ_clear for the next launch (three buffers in turn, so no block
// reads an occupancy another block of the launch writes).  An overlap
// column's occupancy is recomputed from its blended bytes, since the
// truncating cast can zero a column; its blocks store the same 1.
//
// Block (x, y): lane j of each warp takes band column 32 x + j, the warps
// canvas rows y * kRows + warp * kRowsPerWarp on.  Each warp counts the
// overlap columns left of its lanes from the flags with ballot and popc,
// so no block waits on another.
__global__ void __launch_bounds__(kWarps * 32)
fold_step_kernel(const uint8_t* __restrict__ img,
                 const uint8_t* __restrict__ img_occ,
                 uint8_t* __restrict__ canvas, int hc, int wc, int ih, int iw,
                 int oy, int x0, int swapped, double overlap_range,
                 const uint8_t* __restrict__ occ_in,
                 uint8_t* __restrict__ occ_out,
                 uint8_t* __restrict__ occ_clear) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const int nthreads = gridDim.x * gridDim.y * blockDim.x;
  for (int col = block * blockDim.x + threadIdx.x; col < wc; col += nthreads) {
    if (col < x0 || col >= x0 + iw) occ_out[col] = occ_in[col];
    occ_clear[col] = 0;
  }

  const int tile = blockIdx.x * 32;
  const int c = tile + lane;  // band column of this lane
  const bool in_band = c < iw;
  const bool img_has = in_band && img_occ[c] != 0;
  const bool mos_has = in_band && occ_in[x0 + c] != 0;
  const bool overlap = img_has && mos_has;
  int counter = 0;
#pragma unroll 4
  for (int k = 0; k < tile; k += 32) {  // the loads of 4 chunks at once
    const int cc = k + lane;  // < tile <= iw - 1
    counter += __popc(__ballot_sync(
        kAll, img_occ[cc] != 0 && occ_in[x0 + cc] != 0));
  }
  counter += __popc(__ballot_sync(kAll, overlap) & ((1u << lane) - 1u));
  if (blockIdx.y == 0 && warp == 0 && in_band && !overlap)
    occ_out[x0 + c] = (img_has || mos_has) ? 1 : 0;

  // 1: paste the image's rows; 2: blend the whole column
  const int mode = overlap ? 2 : (img_has ? 1 : 0);
  if (__ballot_sync(kAll, mode != 0) == 0) return;
  float w_img = 0.0f, w_mos = 0.0f;
  if (overlap) {
    const double alpha =
        overlap_range != 0.0 ? (double)counter / overlap_range : 0.0;
    const float w_b = (float)alpha;
    const float w_a = (float)(1.0 - alpha);
    w_img = swapped ? w_a : w_b;
    w_mos = swapped ? w_b : w_a;
  }
  // every load of the warp's rows before the first store
  const int r0 = blockIdx.y * kRows + warp * kRowsPerWarp;
  uint8_t iv[kRowsPerWarp][3], mv[kRowsPerWarp][3];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i, ir = r - oy;
    const bool in_img = mode != 0 && r < hc && ir >= 0 && ir < ih;
    const bool blend = mode == 2 && r < hc;
    const uint8_t* p = img + ((size_t)(in_img ? ir : 0) * iw + c) * 3;
    const uint8_t* q = canvas + ((size_t)(blend ? r : 0) * wc + x0 + c) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      iv[i][ch] = in_img ? p[ch] : 0;
      mv[i][ch] = blend ? q[ch] : 0;
    }
  }
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i, ir = r - oy;
    if (r >= hc || mode == 0) continue;
    uint8_t* q = canvas + ((size_t)r * wc + x0 + c) * 3;
    if (mode == 1) {
      if (ir >= 0 && ir < ih) {
        q[0] = iv[i][0];
        q[1] = iv[i][1];
        q[2] = iv[i][2];
      }
      continue;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float out = __fadd_rn(__fmul_rn(w_mos, (float)mv[i][ch]),
                            __fmul_rn(w_img, (float)iv[i][ch]));
      out = fminf(fmaxf(out, 0.0f), 255.0f);
      const uint8_t u = (uint8_t)out;
      q[ch] = u;
      acc |= u;
    }
  }
  if (mode == 2 && acc) occ_out[x0 + c] = 1;
}

}  // namespace

extern "C" {

int compose_column_occupancy(const void* images, int n, int h, int w,
                             void* flags, void* canvas_occ, int ox0,
                             void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + 31) / 32, (h + kRows - 1) / kRows, n);
  column_occupancy_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)images, h, w, (uint8_t*)flags, (uint8_t*)canvas_occ,
      ox0);
  return (int)cudaGetLastError();
}

int compose_fold_step(const void* img, const void* img_occ, void* canvas,
                      int hc, int wc, int ih, int iw, int oy, int x0,
                      int swapped, double overlap_range, const void* occ_in,
                      void* occ_out, void* occ_clear, void* stream) {
  if (ih <= 0 || iw <= 0 || oy < 0 || x0 < 0 || oy + ih > hc || x0 + iw > wc)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((iw + 31) / 32, (hc + kRows - 1) / kRows);
  fold_step_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const uint8_t*)img_occ, (uint8_t*)canvas, hc, wc,
      ih, iw, oy, x0, swapped, overlap_range, (const uint8_t*)occ_in,
      (uint8_t*)occ_out, (uint8_t*)occ_clear);
  return (int)cudaGetLastError();
}

}  // extern "C"
