// The Newton walk of one SIFT localization candidate, shared by the
// package's localization kernel (K1, sift_kernels.cu: one warp per
// candidate, newton_walk_warp) and the probe's resident kernel (P4,
// probe_kernels.cu: one thread per candidate, newton_walk).  Both walks
// run the same step (newton_floats, then newton_move), so they cannot
// drift apart.  Every float is one correctly rounded IEEE single operation
// (the library is built with -fmad=false), in the order of the plain
// PyTorch versions (models/sift/localize.py newton_step).

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

// The float lanes of the last compute, in the TPU kernel's lane order.
struct NewtonFloats {
  float ux, uy, us, gx, gy, gs, center, dxx, dyy, dss, dxy, dxs, dys;
};
constexpr int NEWTON_FLOATS = 13;
constexpr int NEWTON_INTS = 8;

// Final state of one walk: the cell after the last move (x, y, l), the
// cell of the last compute (cx, cy, cl), converged / rejected, and the
// float lanes of the last compute (all 0 when no step ran).
struct NewtonState {
  int x, y, l, cx, cy, cl;
  bool conv, rej;
  NewtonFloats f;
};

__device__ __forceinline__ NewtonState newton_start(int l0, int y0, int x0) {
  NewtonState s;
  s.x = s.cx = x0;
  s.y = s.cy = y0;
  s.l = s.cl = l0;
  s.conv = s.rej = false;
  s.f = NewtonFloats{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                     0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  return s;
}

// Offset of cube value j = (dl+1)*9 + (dy+1)*3 + (dx+1) from its center.
__device__ __forceinline__ ptrdiff_t cube_offset(int j, size_t hw, int w) {
  return (ptrdiff_t)(j / 9 - 1) * (ptrdiff_t)hw + (ptrdiff_t)(j / 3 % 3 - 1) * w +
         (j % 3 - 1);
}

// Gradient, Hessian and update of one (values / 255) cube:
// localize._derivatives, then localize._solve3's cofactor chain.
__device__ __forceinline__ NewtonFloats newton_floats(const float (&c)[27]) {
#define C(dl, dy, dx) c[((dl) + 1) * 9 + ((dy) + 1) * 3 + ((dx) + 1)]
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
  return NewtonFloats{ux, uy, us, gx, gy, gs, v, dxx, dyy, dss, dxy, dxs, dys};
}

// Store the compute f at the current cell, converge-check, and move.
__device__ __forceinline__ void newton_move(NewtonState& s, const NewtonFloats& f,
                                            int h, int w, int border,
                                            int num_intervals) {
  s.f = f;
  const bool conv_now = fabsf(f.ux) < 0.5f && fabsf(f.uy) < 0.5f && fabsf(f.us) < 0.5f;
  s.cx = s.x;
  s.cy = s.y;
  s.cl = s.l;
  if (!conv_now) {
    // rint (half to even) then a saturating float->int conversion
    const int nx = wrap_add(s.x, __float2int_rn(f.ux));
    const int ny = wrap_add(s.y, __float2int_rn(f.uy));
    const int nl = wrap_add(s.l, __float2int_rn(f.us));
    s.rej = ny < border || ny >= h - border || nx < border || nx >= w - border ||
            nl < 1 || nl > num_intervals;
    s.x = clampi(nx, 1, w - 2);
    s.y = clampi(ny, 1, h - 2);
    s.l = clampi(nl, 1, num_intervals);
  }
  s.conv = conv_now;
}

// At most max_iters steps of compute -> store -> converge-check -> move
// from candidate (l0, y0, x0), with the candidate's own early exit; one
// thread reads the whole cube.
__device__ __forceinline__ NewtonState newton_walk(
    const float* __restrict__ dog, int h, int w, int border, int num_intervals,
    int max_iters, int l0, int y0, int x0) {
  const size_t hw = (size_t)h * w;
  NewtonState s = newton_start(l0, y0, x0);
  for (int t = 0; t < max_iters && !s.conv && !s.rej; ++t) {
    const float* base = dog + (size_t)s.l * hw + (size_t)s.y * w + s.x;
    float c[27];
#pragma unroll
    for (int j = 0; j < 27; ++j) c[j] = base[cube_offset(j, hw, w)] / 255.0f;
    newton_move(s, newton_floats(c), h, w, border, num_intervals);
  }
  return s;
}

// The same walk for one candidate per warp: lane j < 27 loads and divides
// cube value j, the 27 quotients are broadcast to every lane, and every
// lane runs the same step on them.  So the state, and the early exit, are
// the same in all 32 lanes.  Call with all 32 lanes of the warp.
__device__ __forceinline__ NewtonState newton_walk_warp(
    const float* __restrict__ dog, int h, int w, int border, int num_intervals,
    int max_iters, int l0, int y0, int x0, int lane) {
  const size_t hw = (size_t)h * w;
  const ptrdiff_t my_off = lane < 27 ? cube_offset(lane, hw, w) : 0;
  NewtonState s = newton_start(l0, y0, x0);
  for (int t = 0; t < max_iters && !s.conv && !s.rej; ++t) {
    const float* base = dog + (size_t)s.l * hw + (size_t)s.y * w + s.x;
    const float mine = lane < 27 ? base[my_off] / 255.0f : 0.0f;
    float c[27];
#pragma unroll
    for (int j = 0; j < 27; ++j) c[j] = __shfl_sync(0xffffffffu, mine, j);
    newton_move(s, newton_floats(c), h, w, border, num_intervals);
  }
  return s;
}

// One candidate's output rows: integer lanes x, y, l, cx, cy, cl,
// converged, rejected and the float lanes in NewtonFloats' order.
__device__ __forceinline__ void write_lanes(const NewtonState& s, int* __restrict__ oi,
                                            float* __restrict__ of) {
  oi[0] = s.x;
  oi[1] = s.y;
  oi[2] = s.l;
  oi[3] = s.cx;
  oi[4] = s.cy;
  oi[5] = s.cl;
  oi[6] = s.conv ? 1 : 0;
  oi[7] = s.rej ? 1 : 0;
  const float f[NEWTON_FLOATS] = {s.f.ux,  s.f.uy,  s.f.us,  s.f.gx, s.f.gy,
                                  s.f.gs,  s.f.center, s.f.dxx, s.f.dyy,
                                  s.f.dss, s.f.dxy, s.f.dxs, s.f.dys};
#pragma unroll
  for (int c = 0; c < NEWTON_FLOATS; ++c) of[c] = f[c];
}

__device__ __forceinline__ void write_zero_lanes(int* __restrict__ oi,
                                                 float* __restrict__ of) {
#pragma unroll
  for (int c = 0; c < NEWTON_INTS; ++c) oi[c] = 0;
#pragma unroll
  for (int c = 0; c < NEWTON_FLOATS; ++c) of[c] = 0.0f;
}

}  // namespace sift
