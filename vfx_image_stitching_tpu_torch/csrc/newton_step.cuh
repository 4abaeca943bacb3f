// The Newton walk of one SIFT localization candidate, shared by the
// package's localization kernel (K1, sift_kernels.cu) and the probe's
// resident kernel (P4, probe_kernels.cu): both kernels are localize_rows
// (newton_walk_warp, one warp per candidate, then write_lanes), so they
// cannot drift apart.  Every float is one correctly rounded IEEE single
// operation (the library is built with -fmad=false), in the order of the
// plain PyTorch versions (models/sift/localize.py newton_step).

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
// from candidate (l0, y0, x0), with the candidate's own early exit, one
// candidate per warp: lane j < 27 loads and divides cube value j, the 27
// quotients are broadcast to every lane, and every lane runs the same step
// on them.  So the state, and the early exit, are the same in all 32
// lanes.  Call with all 32 lanes of the warp.
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

// Value c of one candidate's output row, as 32 bits: c < 8 the integer
// lanes x, y, l, cx, cy, cl, converged, rejected; c = 8..20 the float lanes
// in NewtonFloats' order.  newton_start(0, 0, 0) gives the zero row.
__device__ __forceinline__ unsigned lane_bits(const NewtonState& s, int c) {
  const unsigned v[NEWTON_INTS + NEWTON_FLOATS] = {
      (unsigned)s.x, (unsigned)s.y, (unsigned)s.l, (unsigned)s.cx,
      (unsigned)s.cy, (unsigned)s.cl, s.conv ? 1u : 0u, s.rej ? 1u : 0u,
      __float_as_uint(s.f.ux), __float_as_uint(s.f.uy), __float_as_uint(s.f.us),
      __float_as_uint(s.f.gx), __float_as_uint(s.f.gy), __float_as_uint(s.f.gs),
      __float_as_uint(s.f.center), __float_as_uint(s.f.dxx),
      __float_as_uint(s.f.dyy), __float_as_uint(s.f.dss), __float_as_uint(s.f.dxy),
      __float_as_uint(s.f.dxs), __float_as_uint(s.f.dys)};
  unsigned r = 0u;  // a select chain: no local-memory array for a runtime c
#pragma unroll
  for (int j = 0; j < NEWTON_INTS + NEWTON_FLOATS; ++j) r = j == c ? v[j] : r;
  return r;
}

// The row spread over the warp: lane c < 21 writes value c.
__device__ __forceinline__ void write_lanes(const NewtonState& s, int* __restrict__ oi,
                                            float* __restrict__ of, int lane) {
  const unsigned b = lane_bits(s, lane);
  if (lane < NEWTON_INTS)
    oi[lane] = (int)b;
  else if (lane < NEWTON_INTS + NEWTON_FLOATS)
    of[lane - NEWTON_INTS] = __uint_as_float(b);
}

// The body of K1's and P4's kernels, which differ only in their C entry:
// one candidate per warp, NEWTON_WARPS warps a block; valid candidates
// walk, invalid ones get the zero row, and the warp writes the row.
// With img (K1 over a batch of images), candidate i walks the stack of
// image img[i], which starts stack_elems floats after the previous one;
// its layer bounds are that stack's, so a walk never leaves its image.
constexpr int NEWTON_WARPS = 8;

__device__ __forceinline__ void localize_rows(
    const float* __restrict__ dog, int h, int w, const int* __restrict__ layer,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const unsigned char* __restrict__ valid, int k, int border, int num_intervals,
    int max_iters, const int* __restrict__ img, size_t stack_elems,
    int* __restrict__ outi, float* __restrict__ outf) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NEWTON_WARPS + (threadIdx.x >> 5);
  if (i >= k) return;  // whole warps
  const float* stack = img ? dog + (size_t)img[i] * stack_elems : dog;
  const NewtonState s =
      valid[i] ? newton_walk_warp(stack, h, w, border, num_intervals, max_iters,
                                  layer[i], ys[i], xs[i], lane)
               : newton_start(0, 0, 0);
  write_lanes(s, outi + (size_t)i * NEWTON_INTS, outf + (size_t)i * NEWTON_FLOATS,
              lane);
}

}  // namespace sift
