// Hand-written Hopper (sm_90a) kernels for the SIFT path of the PyTorch port.
//
// Each kernel computes what one Pallas TPU kernel of the JAX package computes
// (vfx_image_stitching_tpu/models/sift/pallas_kernels.py); the wrappers, plain
// versions and design notes live in models/sift/kernels.py.  Built with
// -fmad=false and without --use_fast_math: every float below is one
// correctly rounded IEEE single operation, in the same order as the plain
// PyTorch versions.
//
// Plain C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "newton_step.cuh"

namespace {

using sift::clampi;

// ---------------------------------------------------------------------------
// K1: per-candidate Newton localization (replaces localize_newton_resident).
// One thread per candidate runs sift::newton_walk (newton_step.cuh): compute
// -> store -> converge-check -> move, as localize.newton_step, with a
// per-candidate early exit.  Only the integer lanes are written.
// ---------------------------------------------------------------------------
__global__ void localize_newton_kernel(
    const float* __restrict__ dog, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ ys,
    const int* __restrict__ xs, const int* __restrict__ valid, int k,
    int border, int num_intervals, int max_iters, int* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  int* o = out + (size_t)i * 8;
  if (!valid[i]) {
    for (int c = 0; c < 8; ++c) o[c] = 0;
    return;
  }
  const sift::NewtonState s = sift::newton_walk(
      dog, h, w, border, num_intervals, max_iters, layer[i], ys[i], xs[i]);
  o[0] = s.x;
  o[1] = s.y;
  o[2] = s.l;
  o[3] = s.cx;
  o[4] = s.cy;
  o[5] = s.cl;
  o[6] = s.conv ? 1 : 0;
  o[7] = s.rej ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K2: raw orientation histograms (replaces orientation_histograms_v2).
// One block per keypoint over its (2*half+1)^2 window.  Thread t sums the
// window pixels t, t+T, t+2T, ... into its own column of a shared-memory
// (bins x T) array; the columns are then added in a fixed pairwise tree.
// ---------------------------------------------------------------------------
constexpr int K2_THREADS = 128;
constexpr int K2_MAX_BINS = 36;

__global__ void __launch_bounds__(K2_THREADS) orientation_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ cys,
    const int* __restrict__ cxs, const int* __restrict__ radii,
    const float* __restrict__ wfs, const int* __restrict__ valid, int half,
    int num_bins, float* __restrict__ out) {
  __shared__ float part[K2_MAX_BINS][K2_THREADS];
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  for (int b = 0; b < num_bins; ++b) part[b][t] = 0.0f;

  const int s = 2 * half + 1;
  const int cy = cys[i], cx = cxs[i], rad = radii[i];
  const float wf = wfs[i];
  const bool ok = valid[i] != 0;
  const int sy = clampi(cy - half, 0, max(h, s) - s);
  const int sx = clampi(cx - half, 0, max(w, s) - s);
  const size_t plane = (size_t)layer[i] * h * w;
  const float bin_scale = (float)(num_bins / 360.0);
  if (ok) {
    for (int p = t; p < s * s; p += K2_THREADS) {
      const int row = sy + p / s;
      const int col = sx + p % s;
      const int dy = row - cy, dx = col - cx;
      if (abs(dy) > rad || abs(dx) > rad || row < 1 || row > h - 2 ||
          col < 1 || col > w - 2)
        continue;
      const size_t off = plane + (size_t)row * w + col;
      const float weight = expf(wf * (float)(dy * dy + dx * dx));
      const float contrib = weight * mag[off];
      int bin = __float2int_rn(ang[off] * bin_scale) % num_bins;
      if (bin < 0) bin += num_bins;
      part[bin][t] += contrib;
    }
  }
  __syncthreads();
  for (int stride = K2_THREADS / 2; stride > 0; stride >>= 1) {
    if (t < stride)
      for (int b = 0; b < num_bins; ++b) part[b][t] += part[b][t + stride];
    __syncthreads();
  }
  if (t < num_bins) out[(size_t)i * num_bins + t] = part[t][0];
}

// ---------------------------------------------------------------------------
// K3: descriptor window gather (replaces pair_window_gather).  One block per
// keypoint; consecutive threads copy consecutive columns of a window row.
// ---------------------------------------------------------------------------
constexpr int K3_THREADS = 128;

__global__ void __launch_bounds__(K3_THREADS) pair_gather_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ sys,
    const int* __restrict__ sxs, int s, float* __restrict__ magw,
    float* __restrict__ angw) {
  const int i = blockIdx.x;
  const int sy = sys[i], sx = sxs[i];
  const size_t plane = (size_t)layer[i] * h * w;
  const size_t obase = (size_t)i * s * s;
  for (int p = threadIdx.x; p < s * s; p += K3_THREADS) {
    const int row = sy + p / s;
    const int col = sx + p % s;
    float m = 0.0f, a = 0.0f;
    if (row < h && col < w) {
      const size_t off = plane + (size_t)row * w + col;
      m = mag[off];
      a = ang[off];
    }
    magw[obase + p] = m;
    angw[obase + p] = a;
  }
}

// ---------------------------------------------------------------------------
// K4: raw orientation histograms (replaces orientation_histograms, v1).
// One warp per keypoint, K4_WARPS keypoints per block.  A lane walks the
// samples of (clamped window) x (radius box) x (1..h-2, 1..w-2) with stride
// 32 into its own column of a shared (bins x 32) array; each bin is then
// summed across lanes by an xor butterfly, which leaves the same bits in
// every lane (float addition is commutative).
// ---------------------------------------------------------------------------
constexpr int K4_WARPS = 8;

__global__ void __launch_bounds__(K4_WARPS * 32) orientation_v1_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ cys,
    const int* __restrict__ cxs, const int* __restrict__ radii,
    const float* __restrict__ wfs, const int* __restrict__ valid, int k,
    int half, int num_bins, float* __restrict__ out) {
  __shared__ float part[K4_WARPS][K2_MAX_BINS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * K4_WARPS + warp;
  if (i >= k) return;  // whole warps only; no block-wide barrier below
  float(*acc)[32] = part[warp];
  for (int b = 0; b < num_bins; ++b) acc[b][lane] = 0.0f;

  if (valid[i]) {
    const int s = 2 * half + 1;
    const int cy = cys[i], cx = cxs[i], rad = radii[i];
    const float wf = wfs[i];
    const int sy = clampi(cy - half, 0, max(h, s) - s);
    const int sx = clampi(cx - half, 0, max(w, s) - s);
    const int r_lo = max(max(sy, cy - rad), 1);
    const int r_hi = min(min(sy + s - 1, cy + rad), h - 2);
    const int c_lo = max(max(sx, cx - rad), 1);
    const int c_hi = min(min(sx + s - 1, cx + rad), w - 2);
    const int nc = c_hi - c_lo + 1;
    const int n = (r_hi >= r_lo && nc > 0) ? (r_hi - r_lo + 1) * nc : 0;
    const size_t plane = (size_t)layer[i] * h * w;
    const float bin_scale = (float)(num_bins / 360.0);
    for (int p = lane; p < n; p += 32) {
      const int row = r_lo + p / nc;
      const int col = c_lo + p % nc;
      const int dy = row - cy, dx = col - cx;
      const size_t off = plane + (size_t)row * w + col;
      const float contrib = expf(wf * (float)(dy * dy + dx * dx)) * mag[off];
      int bin = __float2int_rn(ang[off] * bin_scale) % num_bins;
      if (bin < 0) bin += num_bins;
      acc[bin][lane] += contrib;
    }
  }
  for (int b = 0; b < num_bins; ++b) {
    float v = acc[b][lane];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (lane == (b & 31)) out[(size_t)i * num_bins + b] = v;
  }
}

// ---------------------------------------------------------------------------
// K5: raw trilinear descriptor histograms (replaces descriptor_histograms).
// One block per keypoint.  Thread t walks the samples of (clamped S x S
// window) x (|dy|, |dx| <= half_w) x (1..h-2, 1..w-2) with stride K5_THREADS
// and adds each in-bin sample's <= 8 trilinear terms (inner ww x ww cells
// only) to its own column of a shared (n_out x K5_THREADS) array; the
// columns are then added in a fixed pairwise tree.  Per sample the floats
// are those of the plain version, in its order.
// ---------------------------------------------------------------------------
constexpr int K5_THREADS = 128;
constexpr int K5_MAX_OUT = 128;

__global__ void __launch_bounds__(K5_THREADS) descriptor_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ pys,
    const int* __restrict__ pxs, const int* __restrict__ half_ws,
    const float* __restrict__ coss, const float* __restrict__ sins,
    const float* __restrict__ hist_ws, const float* __restrict__ angles,
    const int* __restrict__ valid, int half_cap, int num_bins, int ww,
    float* __restrict__ out) {
  extern __shared__ float part[];  // part[bin * K5_THREADS + thread]
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int n_out = ww * ww * num_bins;
  for (int b = 0; b < n_out; ++b) part[b * K5_THREADS + t] = 0.0f;

  if (valid[i]) {
    const int s = 2 * half_cap + 1;
    const int py = pys[i], px = pxs[i], hw = half_ws[i];
    const int sy = clampi(py - half_cap, 0, max(h, s) - s);
    const int sx = clampi(px - half_cap, 0, max(w, s) - s);
    const int r_lo = max(max(sy, py - hw), 1);
    const int r_hi = min(min(sy + s - 1, py + hw), h - 2);
    const int c_lo = max(max(sx, px - hw), 1);
    const int c_hi = min(min(sx + s - 1, px + hw), w - 2);
    const int nc = c_hi - c_lo + 1;
    const int n = (r_hi >= r_lo && nc > 0) ? (r_hi - r_lo + 1) * nc : 0;
    const float cos_a = coss[i], sin_a = sins[i], hwid = hist_ws[i];
    const float angle = angles[i];
    const float wwf = (float)ww, nbf = (float)num_bins;
    const float offset = (float)(0.5 * ww - 0.5);
    const float weight_mul = (float)(-0.5 / ((0.5 * ww) * (0.5 * ww)));
    const float bin_scale = (float)(num_bins / 360.0);
    const size_t plane = (size_t)layer[i] * h * w;
    for (int p = t; p < n; p += K5_THREADS) {
      const int row = r_lo + p / nc;
      const int col = c_lo + p % nc;
      const float ys = (float)(row - py), xs = (float)(col - px);
      const float r_rot = xs * sin_a + ys * cos_a;
      const float c_rot = xs * cos_a - ys * sin_a;
      const float rq = r_rot / hwid, cq = c_rot / hwid;
      const float r_bin = rq + offset, c_bin = cq + offset;
      if (!(r_bin > -1.0f && r_bin < wwf && c_bin > -1.0f && c_bin < wwf))
        continue;
      const size_t off = plane + (size_t)row * w + col;
      const float wm = expf(weight_mul * (rq * rq + cq * cq)) * mag[off];
      // floor-style mod of a float, as torch.remainder / jnp.mod
      float ob = fmodf((ang[off] - angle) * bin_scale, nbf);
      if (ob < 0.0f) ob += nbf;
      const int r0 = (int)floorf(r_bin), c0 = (int)floorf(c_bin);
      int o0 = (int)floorf(ob) % num_bins;
      if (o0 < 0) o0 += num_bins;
      const int o1 = (o0 + 1) % num_bins;
      const float rf = r_bin - (float)r0;
      const float cf = c_bin - (float)c0;
      const float of = ob - (float)o0;
      const float c1 = wm * rf;
      const float wr[2] = {wm - c1, c1};
      const float wc[2] = {1.0f - cf, cf};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = r0 + a;  // inner row r + 1 of the padded (ww+2) grid
        if (r < 0 || r >= ww) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = c0 + b;
          if (c < 0 || c >= ww) continue;
          const float v = wr[a] * wc[b];
          float* cell = part + (size_t)((r * ww + c) * num_bins) * K5_THREADS + t;
          cell[o0 * K5_THREADS] += v * (1.0f - of);
          cell[o1 * K5_THREADS] += v * of;
        }
      }
    }
  }
  __syncthreads();
  for (int stride = K5_THREADS / 2; stride > 0; stride >>= 1) {
    if (t < stride)
      for (int b = 0; b < n_out; ++b)
        part[b * K5_THREADS + t] += part[b * K5_THREADS + t + stride];
    __syncthreads();
  }
  for (int b = t; b < n_out; b += K5_THREADS)
    out[(size_t)i * n_out + b] = part[b * K5_THREADS];
}

}  // namespace

extern "C" {

int sift_localize_newton(const void* dog, int h, int w, const void* layer,
                         const void* y, const void* x, const void* valid, int k,
                         int border, int num_intervals, int max_iters, void* out,
                         void* stream) {
  const int threads = 64;
  localize_newton_kernel<<<(k + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)dog, h, w, (const int*)layer, (const int*)y, (const int*)x,
      (const int*)valid, k, border, num_intervals, max_iters, (int*)out);
  return (int)cudaGetLastError();
}

int sift_orientation_histograms(const void* mag, const void* ang, int h, int w,
                                const void* layer, const void* cy, const void* cx,
                                const void* radius, const void* wf,
                                const void* valid, int k, int half, int num_bins,
                                void* out, void* stream) {
  if (num_bins < 1 || num_bins > K2_MAX_BINS) return (int)cudaErrorInvalidValue;
  orientation_kernel<<<k, K2_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)mag, (const float*)ang, h, w, (const int*)layer,
      (const int*)cy, (const int*)cx, (const int*)radius, (const float*)wf,
      (const int*)valid, half, num_bins, (float*)out);
  return (int)cudaGetLastError();
}

int sift_pair_window_gather(const void* mag, const void* ang, int h, int w,
                            const void* layer, const void* sy, const void* sx,
                            int k, int s, void* magw, void* angw, void* stream) {
  pair_gather_kernel<<<k, K3_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)mag, (const float*)ang, h, w, (const int*)layer,
      (const int*)sy, (const int*)sx, s, (float*)magw, (float*)angw);
  return (int)cudaGetLastError();
}

int sift_orientation_histograms_v1(const void* mag, const void* ang, int h,
                                   int w, const void* layer, const void* cy,
                                   const void* cx, const void* radius,
                                   const void* wf, const void* valid, int k,
                                   int half, int num_bins, void* out,
                                   void* stream) {
  if (num_bins < 1 || num_bins > K2_MAX_BINS) return (int)cudaErrorInvalidValue;
  orientation_v1_kernel<<<(k + K4_WARPS - 1) / K4_WARPS, K4_WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
      (const float*)mag, (const float*)ang, h, w, (const int*)layer,
      (const int*)cy, (const int*)cx, (const int*)radius, (const float*)wf,
      (const int*)valid, k, half, num_bins, (float*)out);
  return (int)cudaGetLastError();
}

int sift_descriptor_histograms(const void* mag, const void* ang, int h, int w,
                               const void* layer, const void* py, const void* px,
                               const void* half_w, const void* cos_a,
                               const void* sin_a, const void* hist_width,
                               const void* angle, const void* valid, int k,
                               int half_cap, int num_bins, int ww, void* out,
                               void* stream) {
  const int n_out = ww * ww * num_bins;
  if (num_bins < 1 || ww < 1 || n_out > K5_MAX_OUT) return (int)cudaErrorInvalidValue;
  const int smem = n_out * K5_THREADS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      descriptor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  descriptor_kernel<<<k, K5_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)mag, (const float*)ang, h, w, (const int*)layer,
      (const int*)py, (const int*)px, (const int*)half_w, (const float*)cos_a,
      (const float*)sin_a, (const float*)hist_width, (const float*)angle,
      (const int*)valid, half_cap, num_bins, ww, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
