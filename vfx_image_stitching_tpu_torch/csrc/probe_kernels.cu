// Hand-written Hopper (sm_90a) kernels for the port's probe entry points
// (vfx_image_stitching_tpu_torch/probes/): each computes what one Pallas TPU
// kernel of the probe scripts computes (scripts/probe_localize_resident_r4.py,
// scripts/probe_desc_scratch_dot.py).  Wrappers, plain versions and design
// notes live in probes/kernels.py.  Built into the same library as
// sift_kernels.cu, with -fmad=false and without --use_fast_math.
//
// Plain C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "newton_step.cuh"

namespace {

using sift::clampi;

// ---------------------------------------------------------------------------
// P2: sum over the layers of the stack's (8, 128) corner (replaces the
// feas1 kernel).  One block of 1024 threads, one output each; each adds its
// layers in order from 0.0f, as the TPU kernel's acc = acc + dog[l, :8, :128].
// ---------------------------------------------------------------------------
constexpr int P2_ROWS = 8, P2_COLS = 128;

__global__ void __launch_bounds__(P2_ROWS * P2_COLS) feas1_stack_sum_kernel(
    const float* __restrict__ dog, int n_l, int h, int w, float* __restrict__ out) {
  const int t = threadIdx.x;
  const int r = t / P2_COLS, c = t % P2_COLS;
  float acc = 0.0f;
  for (int l = 0; l < n_l; ++l) acc = acc + dog[((size_t)l * h + r) * w + c];
  out[t] = acc;
}

// ---------------------------------------------------------------------------
// P3: per candidate, the sum of its 3x3x3 DoG cube (replaces the feas2
// kernel).  One thread per candidate reads its 27 values through L2 and adds
// them in (dl, dy, dx) order from 0.0f, the probe's own check order.  Each
// index is clamped into the stack (the plain version clamps the same way).
// ---------------------------------------------------------------------------
__global__ void feas2_cube_sums_kernel(
    const float* __restrict__ dog, int n_l, int h, int w,
    const int* __restrict__ ls, const int* __restrict__ ys,
    const int* __restrict__ xs, int k, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int l = ls[i], y = ys[i], x = xs[i];
  float s = 0.0f;
  for (int dl = -1; dl <= 1; ++dl) {
    const size_t plane = (size_t)clampi(l + dl, 0, n_l - 1) * h;
    for (int dy = -1; dy <= 1; ++dy) {
      const size_t row = (plane + clampi(y + dy, 0, h - 1)) * w;
      for (int dx = -1; dx <= 1; ++dx) s = s + dog[row + clampi(x + dx, 0, w - 1)];
    }
  }
  out[i] = s;
}

// ---------------------------------------------------------------------------
// P4: the Newton walk with its integer lanes and the 13 float lanes of the
// last compute (replaces _newton_resident_kernel of the probe).  One thread
// per candidate (sift::newton_walk; K1 runs the same step one warp per
// candidate); invalid candidates get zero rows in both outputs.
// ---------------------------------------------------------------------------
__global__ void localize_resident_r4_kernel(
    const float* __restrict__ dog, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ ys,
    const int* __restrict__ xs, const int* __restrict__ valid, int k,
    int border, int num_intervals, int max_iters, float* __restrict__ outf,
    int* __restrict__ outi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  float* of = outf + (size_t)i * sift::NEWTON_FLOATS;
  int* oi = outi + (size_t)i * sift::NEWTON_INTS;
  if (!valid[i]) {
    sift::write_zero_lanes(oi, of);
    return;
  }
  sift::write_lanes(sift::newton_walk(dog, h, w, border, num_intervals, max_iters,
                                      layer[i], ys[i], xs[i]),
                    oi, of);
}

// ---------------------------------------------------------------------------
// P1: the small bucket's trilinear descriptor histogram as two-hot matrix
// products on the tensor cores (replaces _kernel of desc_scratch_dot).
// One block per keypoint, P1_WARPS warps.  The (16 cells x 8 bins) histogram
// is one m16n8k8 accumulator tile: per step of 8 window samples, A (16 x 8)
// holds each sample's spatial two-hot weight per cell and B (8 x 8) its
// orientation two-hot per bin.  Each warp takes 32-sample tiles in turn:
// every lane evaluates one sample (the probe's arithmetic and order) into
// shared memory, then the warp builds the fragments of four mma steps from
// there.  The warps' tiles are added in warp order at the end: no float
// atomics, so repeated launches give the same bits.
// ---------------------------------------------------------------------------
constexpr int P1_WARPS = 4;
constexpr int P1_HALF = 28;
constexpr int P1_S = 2 * P1_HALF + 1;
constexpr int P1_WW = 4;
constexpr int P1_NB = 8;
constexpr int P1_CELLS = P1_WW * P1_WW;  // 16: the mma's M

// one sample's operands; weights are 0 for a sample the mask drops
struct P1Sample {
  float rw[2];  // c0w at row slot ra, c1 at ra + 1
  float cw[2];  // 1 - cf at col slot ca, cf at ca + 1
  float ow[2];  // 1 - of at bin o0, of at bin o1
  int ra, ca, o0, o1;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the tensor core ignores the low 13 bits
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A[cell][sample]: the spatial two-hot product rv * cv of the probe, rv and
// cv each a sum of two selects of which at most one is non-zero
__device__ __forceinline__ float p1_lhs(const P1Sample& s, int cell) {
  const int pa = cell / P1_WW + 1, pb = cell % P1_WW + 1;
  const float rv = (pa == s.ra ? s.rw[0] : 0.0f) + (pa == s.ra + 1 ? s.rw[1] : 0.0f);
  const float cv = (pb == s.ca ? s.cw[0] : 0.0f) + (pb == s.ca + 1 ? s.cw[1] : 0.0f);
  return rv * cv;
}

// B[sample][bin]: the orientation two-hot
__device__ __forceinline__ float p1_rhs(const P1Sample& s, int bin) {
  return (bin == s.o0 ? s.ow[0] : 0.0f) + (bin == s.o1 ? s.ow[1] : 0.0f);
}

template <bool HIGHEST>
__device__ __forceinline__ void p1_mma(float (&acc)[4], const float (&a)[4],
                                       const float (&b)[2]) {
  uint32_t ab[4], bb[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) ab[e] = to_tf32(a[e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) bb[e] = to_tf32(b[e]);
  if (HIGHEST) {
    // 3xTF32: hi*hi + hi*lo + lo*hi, the small terms first
    uint32_t as[4], bs[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) as[e] = to_tf32(a[e] - __uint_as_float(ab[e]));
#pragma unroll
    for (int e = 0; e < 2; ++e) bs[e] = to_tf32(b[e] - __uint_as_float(bb[e]));
    mma_tf32(acc, as, bb);
    mma_tf32(acc, ab, bs);
  }
  mma_tf32(acc, ab, bb);
}

template <bool HIGHEST>
__global__ void __launch_bounds__(P1_WARPS * 32) desc_scratch_dot_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int hs, int ws,
    const int* __restrict__ layer, const int* __restrict__ pys,
    const int* __restrict__ pxs, const int* __restrict__ half_ws,
    const float* __restrict__ coss, const float* __restrict__ sins,
    const float* __restrict__ hist_ws, const float* __restrict__ angles,
    const int* __restrict__ valid, int img_h, int img_w,
    float* __restrict__ out) {
  __shared__ P1Sample tile[P1_WARPS][32];
  __shared__ float part[P1_WARPS][P1_CELLS * P1_NB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread in group
  const int i = blockIdx.x;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  if (valid[i]) {  // uniform over the block
    const int py = pys[i], px = pxs[i], hw = half_ws[i];
    const int sy = clampi(py - P1_HALF, 0, max(hs, P1_S) - P1_S);
    const int sx = clampi(px - P1_HALF, 0, max(ws, P1_S) - P1_S);
    // the samples inside the window, |dy|, |dx| <= half_w, the image's
    // interior and the stack (past it the probe's padding adds 0)
    const int r_lo = max(max(sy, py - hw), 1);
    const int r_hi = min(min(min(sy + P1_S - 1, py + hw), img_h - 2), hs - 1);
    const int c_lo = max(max(sx, px - hw), 1);
    const int c_hi = min(min(min(sx + P1_S - 1, px + hw), img_w - 2), ws - 1);
    const int nc = c_hi - c_lo + 1;
    const int n = (r_hi >= r_lo && nc > 0) ? (r_hi - r_lo + 1) * nc : 0;
    const float cos_a = coss[i], sin_a = sins[i], hwid = hist_ws[i];
    const float angle = angles[i];
    const float wwf = (float)P1_WW, nbf = (float)P1_NB;
    const float offset = (float)(0.5 * P1_WW - 0.5);
    const float weight_mul = (float)(-0.5 / ((0.5 * P1_WW) * (0.5 * P1_WW)));
    const float bin_scale = (float)(P1_NB / 360.0);
    const size_t plane = (size_t)layer[i] * hs * ws;
    P1Sample* mine = &tile[warp][lane];
    for (int base = warp * 32; base < n; base += P1_WARPS * 32) {
      P1Sample s = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, -8, -8, -8, -8};
      const int p = base + lane;
      if (p < n) {
        const int row = r_lo + p / nc;
        const int col = c_lo + p % nc;
        const float ys = (float)(row - py), xs = (float)(col - px);
        const float r_rot = xs * sin_a + ys * cos_a;
        const float c_rot = xs * cos_a - ys * sin_a;
        const float rq = r_rot / hwid, cq = c_rot / hwid;
        const float r_bin = rq + offset, c_bin = cq + offset;
        if (r_bin > -1.0f && r_bin < wwf && c_bin > -1.0f && c_bin < wwf) {
          const size_t off = plane + (size_t)row * ws + col;
          const float wm = expf(weight_mul * (rq * rq + cq * cq)) * mag[off];
          const float r0b = floorf(r_bin), c0b = floorf(c_bin);
          const float rf = r_bin - r0b, cf = c_bin - c0b;
          const float c1 = wm * rf;
          // floor-style mod of a float, as jnp.mod / torch.remainder
          float ob = fmodf((ang[off] - angle) * bin_scale, nbf);
          if (ob < 0.0f) ob += nbf;
          const float o0 = floorf(ob);
          const float of = ob - o0;
          float o1 = fmodf(o0 + 1.0f, nbf);
          if (o1 < 0.0f) o1 += nbf;
          s.rw[0] = wm - c1;
          s.rw[1] = c1;
          s.cw[0] = 1.0f - cf;
          s.cw[1] = cf;
          s.ow[0] = 1.0f - of;
          s.ow[1] = of;
          s.ra = (int)fminf(fmaxf(r0b + 1.0f, 0.0f), wwf + 1.0f);
          s.ca = (int)fminf(fmaxf(c0b + 1.0f, 0.0f), wwf + 1.0f);
          s.o0 = (int)o0;  // 8 when ob rounds up to 8: then no bin takes 1 - of
          s.o1 = (int)o1;
        }
      }
      *mine = s;
      __syncwarp();
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        const P1Sample& s0 = tile[warp][step * 8 + t];
        const P1Sample& s1 = tile[warp][step * 8 + t + 4];
        // PTX m16n8k8 .tf32 fragments: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
        // a3 (g+8, t+4); b0 (k=t, n=g), b1 (k=t+4, n=g)
        const float a[4] = {p1_lhs(s0, g), p1_lhs(s0, g + 8), p1_lhs(s1, g),
                            p1_lhs(s1, g + 8)};
        const float b[2] = {p1_rhs(s0, g), p1_rhs(s1, g)};
        p1_mma<HIGHEST>(acc, a, b);
      }
      __syncwarp();
    }
  }
  // accumulator fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
  float* tile_acc = part[warp];
  tile_acc[g * P1_NB + 2 * t] = acc[0];
  tile_acc[g * P1_NB + 2 * t + 1] = acc[1];
  tile_acc[(g + 8) * P1_NB + 2 * t] = acc[2];
  tile_acc[(g + 8) * P1_NB + 2 * t + 1] = acc[3];
  __syncthreads();
  for (int e = threadIdx.x; e < P1_CELLS * P1_NB; e += P1_WARPS * 32) {
    float v = part[0][e];
    for (int w2 = 1; w2 < P1_WARPS; ++w2) v = v + part[w2][e];
    out[(size_t)i * P1_CELLS * P1_NB + e] = v;
  }
}

}  // namespace

extern "C" {

int probe_feas1_stack_sum(const void* dog, int n_l, int h, int w, void* out,
                          void* stream) {
  if (h < P2_ROWS || w < P2_COLS) return (int)cudaErrorInvalidValue;
  feas1_stack_sum_kernel<<<1, P2_ROWS * P2_COLS, 0, (cudaStream_t)stream>>>(
      (const float*)dog, n_l, h, w, (float*)out);
  return (int)cudaGetLastError();
}

int probe_feas2_cube_sums(const void* dog, int n_l, int h, int w, const void* l,
                          const void* y, const void* x, int k, void* out,
                          void* stream) {
  const int threads = 128;
  feas2_cube_sums_kernel<<<(k + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)dog, n_l, h, w, (const int*)l, (const int*)y, (const int*)x, k,
      (float*)out);
  return (int)cudaGetLastError();
}

int probe_localize_resident_r4(const void* dog, int h, int w, const void* layer,
                               const void* y, const void* x, const void* valid,
                               int k, int border, int num_intervals,
                               int max_iters, void* outf, void* outi,
                               void* stream) {
  const int threads = 64;
  localize_resident_r4_kernel<<<(k + threads - 1) / threads, threads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)dog, h, w, (const int*)layer, (const int*)y, (const int*)x,
      (const int*)valid, k, border, num_intervals, max_iters, (float*)outf,
      (int*)outi);
  return (int)cudaGetLastError();
}

int probe_desc_scratch_dot(const void* mag, const void* ang, int hs, int ws,
                           const void* layer, const void* py, const void* px,
                           const void* half_w, const void* cos_a,
                           const void* sin_a, const void* hist_width,
                           const void* angle, const void* valid, int k,
                           int img_h, int img_w, int highest, void* out,
                           void* stream) {
  auto kernel = highest ? desc_scratch_dot_kernel<true> : desc_scratch_dot_kernel<false>;
  kernel<<<k, P1_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)mag, (const float*)ang, hs, ws, (const int*)layer,
      (const int*)py, (const int*)px, (const int*)half_w, (const float*)cos_a,
      (const float*)sin_a, (const float*)hist_width, (const float*)angle,
      (const int*)valid, img_h, img_w, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
