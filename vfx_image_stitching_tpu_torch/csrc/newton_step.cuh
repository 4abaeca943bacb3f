// The Newton walk of one SIFT localization candidate, shared by the
// package's localization kernel (K1, sift_kernels.cu) and the probe's
// resident kernel that also emits its float lanes (P4, probe_kernels.cu), so
// the two cannot drift apart.  Every float is one correctly rounded IEEE
// single operation (the library is built with -fmad=false), in the order of
// the plain PyTorch versions (models/sift/localize.py newton_step).

#pragma once

#include <cuda_runtime.h>

namespace sift {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// int32 add that wraps like the plain versions' tensor arithmetic
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The float lanes of the last compute, in the JAX probe's lane order.
struct NewtonFloats {
  float ux, uy, us, gx, gy, gs, center, dxx, dyy, dss, dxy, dxs, dys;
};

// Final state of one walk: the cell after the last move (x, y, l), the
// cell of the last compute (cx, cy, cl), converged / rejected, and the
// float lanes of the last compute (all 0 when no step ran).
struct NewtonState {
  int x, y, l, cx, cy, cl;
  bool conv, rej;
  NewtonFloats f;
};

// At most max_iters steps of compute -> store -> converge-check -> move
// from candidate (l0, y0, x0), with the candidate's own early exit.
__device__ __forceinline__ NewtonState newton_walk(
    const float* __restrict__ dog, int h, int w, int border, int num_intervals,
    int max_iters, int l0, int y0, int x0) {
  const size_t hw = (size_t)h * w;
  NewtonState s;
  s.x = s.cx = x0;
  s.y = s.cy = y0;
  s.l = s.cl = l0;
  s.conv = s.rej = false;
  s.f = NewtonFloats{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                     0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < max_iters && !s.conv && !s.rej; ++t) {
    const float* base = dog + (size_t)s.l * hw + (size_t)s.y * w + s.x;
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
    const float gx = 0.5f * (C(0, 0, 1) - C(0, 0, -1));
    const float gy = 0.5f * (C(0, 1, 0) - C(0, -1, 0));
    const float gs = 0.5f * (C(1, 0, 0) - C(-1, 0, 0));
    const float v = C(0, 0, 0);
    const float dxx = (C(0, 0, 1) - 2.0f * v) + C(0, 0, -1);
    const float dyy = (C(0, 1, 0) - 2.0f * v) + C(0, -1, 0);
    const float dss = (C(1, 0, 0) - 2.0f * v) + C(-1, 0, 0);
    const float dxy = 0.25f * (((C(0, 1, 1) - C(0, 1, -1)) - C(0, -1, 1)) + C(0, -1, -1));
    const float dxs = 0.25f * (((C(1, 0, 1) - C(1, 0, -1)) - C(-1, 0, 1)) + C(-1, 0, -1));
    const float dys = 0.25f * (((C(1, 1, 0) - C(1, -1, 0)) - C(-1, 1, 0)) + C(-1, -1, 0));
#undef C
    // localize._solve3, same cofactor chain
    const float c00 = dyy * dss - dys * dys;
    const float c01 = dys * dxs - dxy * dss;
    const float c02 = dxy * dys - dyy * dxs;
    const float det = (dxx * c00 + dxy * c01) + dxs * c02;
    const float c11 = dxx * dss - dxs * dxs;
    const float c12 = dxy * dxs - dxx * dys;
    const float c22 = dxx * dyy - dxy * dxy;
    const float nux = (c00 * gx + c01 * gy) + c02 * gs;
    const float nuy = (c01 * gx + c11 * gy) + c12 * gs;
    const float nus = (c02 * gx + c12 * gy) + c22 * gs;
    const bool ok = fabsf(det) > 1e-30f;
    const float ux = ok ? -nux / det : 0.0f;
    const float uy = ok ? -nuy / det : 0.0f;
    const float us = ok ? -nus / det : 0.0f;
    s.f = NewtonFloats{ux, uy, us, gx, gy, gs, v, dxx, dyy, dss, dxy, dxs, dys};

    const bool conv_now = fabsf(ux) < 0.5f && fabsf(uy) < 0.5f && fabsf(us) < 0.5f;
    s.cx = s.x;
    s.cy = s.y;
    s.cl = s.l;
    if (!conv_now) {
      // rint (half to even) then a saturating float->int conversion
      const int nx = wrap_add(s.x, __float2int_rn(ux));
      const int ny = wrap_add(s.y, __float2int_rn(uy));
      const int nl = wrap_add(s.l, __float2int_rn(us));
      s.rej = ny < border || ny >= h - border || nx < border || nx >= w - border ||
              nl < 1 || nl > num_intervals;
      s.x = clampi(nx, 1, w - 2);
      s.y = clampi(ny, 1, h - 2);
      s.l = clampi(nl, 1, num_intervals);
    }
    s.conv = conv_now;
  }
  return s;
}

}  // namespace sift
