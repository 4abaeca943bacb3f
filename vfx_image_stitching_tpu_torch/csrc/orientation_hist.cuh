// The orientation-histogram walk of one keypoint, shared by the package's
// two orientation kernels (sift_kernels.cu): K2, which stages each
// keypoint's radius box in shared memory with cp.async, and K4, which
// loads the same samples straight from global memory.  Both run the same
// walk, the same per-sample arithmetic and the same reduction, so they
// differ only in where a sample's two floats come from.
//
// One warp per keypoint.  The samples are the radius box intersected with
// the clamped (2*half+1)^2 window and the interior rows 1..h-2, columns
// 1..w-2, walked as one flattened row-major index with stride 32: a lane
// divides once to find its first sample, then steps by the precomputed
// 32 / nc rows and 32 % nc columns with a single carry.  Each lane adds its
// samples into its own bin column of shared memory, acc[bin * 33 + lane];
// lane j then sums the 32 columns of bins j, j+32, ... in lane order
// (stride 33: the 32 lanes read 32 different banks).  No float atomics,
// so repeated launches give the same bits.  Every float is one correctly
// rounded IEEE single operation (-fmad=false), in the plain version's
// per-sample order (models/sift/kernels.py orientation_histograms_plain).

#pragma once

#include <cuda_runtime.h>

#include "newton_step.cuh"  // clampi

namespace sift {

constexpr int ORIENT_ACC_STRIDE = 33;  // floats between two bins of a lane column
constexpr int ORIENT_MAX_BINS = 128;

// One keypoint's sample set: rows r_lo.., columns c_lo..c_hi (nc of
// them), nr * nc = n samples (n = 0: invalid, or nothing inside).
struct OrientBox {
  int r_lo, c_lo, c_hi, nr, nc, n;
  int cy, cx, layer;
  float wf;
};

__device__ __forceinline__ OrientBox orient_box(int h, int w, int half, int layer,
                                                int cy, int cx, int rad, float wf) {
  OrientBox b;
  const int s = 2 * half + 1;
  const int sy = clampi(cy - half, 0, max(h, s) - s);
  const int sx = clampi(cx - half, 0, max(w, s) - s);
  b.r_lo = max(max(sy, cy - rad), 1);
  const int r_hi = min(min(sy + s - 1, cy + rad), h - 2);
  b.c_lo = max(max(sx, cx - rad), 1);
  b.c_hi = min(min(sx + s - 1, cx + rad), w - 2);
  b.nr = r_hi - b.r_lo + 1;
  b.nc = b.c_hi - b.c_lo + 1;
  b.n = (b.nr > 0 && b.nc > 0) ? b.nr * b.nc : 0;
  b.cy = cy;
  b.cx = cx;
  b.layer = layer;
  b.wf = wf;
  return b;
}

// A thread's walk over a row-major grid `ncols` wide from position
// `lane`, `stride` positions a step (32: a warp per keypoint; the
// descriptor kernels pass 32 times the warps serving one keypoint): one
// division at the start, then steps with a single carry.
struct LaneWalk {
  int row, col, dr, dc, ncols;
  __device__ __forceinline__ LaneWalk(int lane, int ncols_, int stride = 32)
      : ncols(ncols_) {
    dr = stride / ncols;
    dc = stride - dr * ncols;
    row = lane / ncols;
    col = lane - row * ncols;
  }
  __device__ __forceinline__ void step() {
    row += dr;
    col += dc;
    if (col >= ncols) {
      col -= ncols;
      ++row;
    }
  }
};

// rint(ang * nb/360) mod nb for a bin outside 0..nb-1 (floor-style mod,
// as torch.remainder)
__device__ __forceinline__ int orient_wrap_bin(int bin, int nb) {
  bin %= nb;
  return bin < 0 ? bin + nb : bin;
}

// 32-bit shared-window address of p, and a float load / store there.  The
// bin adds go through these because through a generic pointer the compiler
// re-derives the shared window's base (S2R SR_CgaCtaId) inside every add.
__device__ __forceinline__ unsigned orient_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ float orient_lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void orient_sts(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// The lane's samples of box b into its column col (acc + lane), U at a
// time: the U samples' loads (load(rr, cc, row, col, m, a): rr, cc
// relative to the box's first row and column, row, col absolute; a
// position past the box loads the box's first sample instead), then
// their weights exp(wf * (dy^2 + dx^2)) * mag and bins rint(ang * nb/360)
// mod nb, all without a branch, so the U samples' latencies overlap;
// then the adds into the bins in sample order.  The modulo runs only in
// a round where some bin falls outside 0..nb-1: a branch per sample would
// split the round into blocks that issue one sample at a time, and a
// lane's chain, not the card's rates, sets these kernels' time.
template <int U, class Load>
__device__ __forceinline__ void orient_walk(const OrientBox& b, int lane, float* col,
                                            int nb, float bin_scale, Load load) {
  if (b.n == 0) return;
  LaneWalk wk(lane, b.nc);
  const unsigned col_addr = orient_saddr(col);
  for (int p0 = lane; p0 < b.n; p0 += 32 * U) {
    float m[U], a[U];
    int d2[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = p0 + 32 * u < b.n;
      const int rr = in ? wk.row : 0, cc = in ? wk.col : 0;
      const int row = b.r_lo + rr, c = b.c_lo + cc;
      const int dy = row - b.cy, dx = c - b.cx;
      d2[u] = dy * dy + dx * dx;
      load(rr, cc, row, c, m[u], a[u]);
      wk.step();
    }
    float v[U];
    int bin[U];
    bool wrap = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = expf(b.wf * (float)d2[u]) * m[u];
      bin[u] = __float2int_rn(a[u] * bin_scale);
      wrap |= (unsigned)bin[u] >= (unsigned)nb;
    }
    if (wrap) {
#pragma unroll
      for (int u = 0; u < U; ++u) bin[u] = orient_wrap_bin(bin[u], nb);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p0 + 32 * u < b.n) {
        const unsigned ad = col_addr + (unsigned)bin[u] * (ORIENT_ACC_STRIDE * 4);
        orient_sts(ad, orient_lds(ad) + v[u]);
      }
  }
}

// Lane j writes the sums of bins j, j+32, ... over the 32 lane columns,
// taken in lane order, and zeroes what it read.  The caller syncs the warp
// before (the columns are complete) and after (before a next walk writes
// them).
__device__ __forceinline__ void orient_reduce(float* acc, int nb, int lane,
                                              float* __restrict__ out) {
  for (int bin = lane; bin < nb; bin += 32) {
    float* r = acc + bin * ORIENT_ACC_STRIDE;
    float v = r[0];
#pragma unroll 8
    for (int j = 1; j < 32; ++j) v += r[j];
#pragma unroll 8
    for (int j = 0; j < 32; ++j) r[j] = 0.0f;
    out[bin] = v;
  }
}

__device__ __forceinline__ void orient_zero_row(float* __restrict__ out, int nb, int lane) {
  for (int bin = lane; bin < nb; bin += 32) out[bin] = 0.0f;
}

}  // namespace sift
