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

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// int32 add that wraps like the plain versions' tensor arithmetic
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// ---------------------------------------------------------------------------
// K1: per-candidate Newton localization (replaces localize_newton_resident).
// One thread per candidate; compute -> store -> converge-check -> move, as
// localize.newton_step, with a per-candidate early exit.
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
  const size_t hw = (size_t)h * w;
  int x = xs[i], y = ys[i], l = layer[i];
  int cx = x, cy = y, cl = l;
  bool conv = false, rej = false;
  for (int t = 0; t < max_iters && !conv && !rej; ++t) {
    const float* base = dog + (size_t)l * hw + (size_t)y * w + x;
    float c[27];
#pragma unroll
    for (int dl = -1; dl <= 1; ++dl)
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
          c[(dl + 1) * 9 + (dy + 1) * 3 + (dx + 1)] =
              base[(ptrdiff_t)dl * (ptrdiff_t)hw + (ptrdiff_t)dy * w + dx] / 255.0f;
#define C(dl, dy, dx) c[((dl) + 1) * 9 + ((dy) + 1) * 3 + ((dx) + 1)]
    // localize._derivatives
    float gx = 0.5f * (C(0, 0, 1) - C(0, 0, -1));
    float gy = 0.5f * (C(0, 1, 0) - C(0, -1, 0));
    float gs = 0.5f * (C(1, 0, 0) - C(-1, 0, 0));
    float v = C(0, 0, 0);
    float dxx = (C(0, 0, 1) - 2.0f * v) + C(0, 0, -1);
    float dyy = (C(0, 1, 0) - 2.0f * v) + C(0, -1, 0);
    float dss = (C(1, 0, 0) - 2.0f * v) + C(-1, 0, 0);
    float dxy = 0.25f * (((C(0, 1, 1) - C(0, 1, -1)) - C(0, -1, 1)) + C(0, -1, -1));
    float dxs = 0.25f * (((C(1, 0, 1) - C(1, 0, -1)) - C(-1, 0, 1)) + C(-1, 0, -1));
    float dys = 0.25f * (((C(1, 1, 0) - C(1, -1, 0)) - C(-1, 1, 0)) + C(-1, -1, 0));
#undef C
    // localize._solve3, same cofactor chain
    float c00 = dyy * dss - dys * dys;
    float c01 = dys * dxs - dxy * dss;
    float c02 = dxy * dys - dyy * dxs;
    float det = (dxx * c00 + dxy * c01) + dxs * c02;
    float c11 = dxx * dss - dxs * dxs;
    float c12 = dxy * dxs - dxx * dys;
    float c22 = dxx * dyy - dxy * dxy;
    float nux = (c00 * gx + c01 * gy) + c02 * gs;
    float nuy = (c01 * gx + c11 * gy) + c12 * gs;
    float nus = (c02 * gx + c12 * gy) + c22 * gs;
    bool ok = fabsf(det) > 1e-30f;
    float ux = ok ? -nux / det : 0.0f;
    float uy = ok ? -nuy / det : 0.0f;
    float us = ok ? -nus / det : 0.0f;

    bool conv_now = fabsf(ux) < 0.5f && fabsf(uy) < 0.5f && fabsf(us) < 0.5f;
    cx = x;
    cy = y;
    cl = l;
    if (!conv_now) {
      // rint (half to even) then a saturating float->int conversion
      int nx = wrap_add(x, __float2int_rn(ux));
      int ny = wrap_add(y, __float2int_rn(uy));
      int nl = wrap_add(l, __float2int_rn(us));
      rej = ny < border || ny >= h - border || nx < border || nx >= w - border ||
            nl < 1 || nl > num_intervals;
      x = clampi(nx, 1, w - 2);
      y = clampi(ny, 1, h - 2);
      l = clampi(nl, 1, num_intervals);
    }
    conv = conv_now;
  }
  o[0] = x;
  o[1] = y;
  o[2] = l;
  o[3] = cx;
  o[4] = cy;
  o[5] = cl;
  o[6] = conv ? 1 : 0;
  o[7] = rej ? 1 : 0;
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

}  // extern "C"
