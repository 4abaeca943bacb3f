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

#include "descriptor_hist.cuh"
#include "newton_step.cuh"

namespace {

using sift::clampi;

// ---------------------------------------------------------------------------
// P2: sum over the layers of the stack's (8, 128) corner (replaces the
// feas1 kernel).  8 blocks, one per row, of one warp each, so no SM takes
// more than a warp; each thread owns four consecutive columns.  All of a
// thread's layer loads are issued before its first add: NL layers known
// at compile time (1..8), or, for any other count, chunks of
// P2_CHUNK loads each, so every add waits on the one L2 round trip of its
// chunk and not on a load of its own.  Each column's layers are added in
// order from 0.0f, as the TPU kernel's acc = acc + dog[l, :8, :128], so the
// result is the plain version's bit for bit.  Where the base and both
// strides keep every row 16 bytes aligned, a layer's four columns are one
// 16-byte load; otherwise four 4-byte loads (a uniform branch: one kernel).
// ---------------------------------------------------------------------------
constexpr int P2_ROWS = 8, P2_COLS = 128, P2_VEC = 4;
constexpr int P2_THREADS = P2_COLS / P2_VEC;
constexpr int P2_CHUNK = 8;

template <bool VEC>
__device__ __forceinline__ float4 p2_load(const float* p) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <int NL, bool VEC>
__device__ __forceinline__ float4 p2_sum(const float* p, int n_l, long long plane) {
  constexpr int chunk = NL > 0 ? NL : P2_CHUNK;
  const int n = NL > 0 ? NL : n_l;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int l0 = 0; l0 < n; l0 += chunk) {  // one pass when NL > 0
    float4 v[chunk];
#pragma unroll
    for (int j = 0; j < chunk; ++j)
      if (l0 + j < n) v[j] = p2_load<VEC>(p + (l0 + j) * plane);
#pragma unroll
    for (int j = 0; j < chunk; ++j) {
      if (l0 + j < n) {
        acc.x = acc.x + v[j].x;
        acc.y = acc.y + v[j].y;
        acc.z = acc.z + v[j].z;
        acc.w = acc.w + v[j].w;
      }
    }
  }
  return acc;
}

template <int NL>
__global__ void __launch_bounds__(P2_THREADS) feas1_stack_sum_kernel(
    const float* __restrict__ dog, int n_l, long long plane, long long row,
    float* __restrict__ out) {
  const float* p = dog + blockIdx.x * row + threadIdx.x * P2_VEC;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(dog) | (uintptr_t)((plane | row) * sizeof(float))) & 15) == 0;
  reinterpret_cast<float4*>(out)[blockIdx.x * P2_THREADS + threadIdx.x] =
      vec ? p2_sum<NL, true>(p, n_l, plane) : p2_sum<NL, false>(p, n_l, plane);
}

// ---------------------------------------------------------------------------
// P3: per candidate, the sum of its 3x3x3 DoG cube (replaces the feas2
// kernel).  Nine lanes per candidate, three candidates a warp (lanes 27-31
// idle): lane 9g + r loads row r = (dl+1)*3 + (dy+1) of candidate g's
// cube, its three values at dx = -1, 0, 1, so a warp's 81 loads are in
// flight at once.  Lane 9g then gathers the 27 values by shuffles and adds
// them in (dl, dy, dx) order from 0.0f, the probe's own check order (no
// tree, no atomics: float addition does not associate), and the three
// sums of a warp go to three consecutive floats.  P3_WARPS warps a block,
// so the probe's 2048 candidates make 171 blocks, every SM busy.  Each
// index is clamped into the stack (the plain version clamps the same way).
// ---------------------------------------------------------------------------
constexpr int P3_LANES = 9;
constexpr int P3_PER_WARP = 3;
constexpr int P3_WARPS = 4;

__global__ void __launch_bounds__(P3_WARPS * 32) feas2_cube_sums_kernel(
    const float* __restrict__ dog, int n_l, int h, int w,
    const int* __restrict__ ls, const int* __restrict__ ys,
    const int* __restrict__ xs, int k, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g = lane / P3_LANES, r = lane - g * P3_LANES;
  const int i = (blockIdx.x * P3_WARPS + (threadIdx.x >> 5)) * P3_PER_WARP + g;
  const bool live = g < P3_PER_WARP && i < k;
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
  if (live) {
    const int l = clampi(ls[i] + r / 3 - 1, 0, n_l - 1);
    const int y = clampi(ys[i] + r % 3 - 1, 0, h - 1);
    const int x = xs[i];
    const float* row = dog + ((size_t)l * h + y) * w;
    v0 = row[clampi(x - 1, 0, w - 1)];
    v1 = row[clampi(x, 0, w - 1)];
    v2 = row[clampi(x + 1, 0, w - 1)];
  }
  const int src = (live ? g : 0) * P3_LANES;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < P3_LANES; ++j) {
    s = s + __shfl_sync(0xffffffffu, v0, src + j);
    s = s + __shfl_sync(0xffffffffu, v1, src + j);
    s = s + __shfl_sync(0xffffffffu, v2, src + j);
  }
  if (live && r == 0) out[i] = s;
}

// ---------------------------------------------------------------------------
// P4: the Newton walk with its integer lanes and the 13 float lanes of the
// last compute (replaces _newton_resident_kernel of the probe).  K1's body,
// sift::localize_rows: one warp per candidate, NEWTON_WARPS a block (a
// walk's later cubes overlap its first, most likely served by the SM's L1;
// a halo of the stack in shared memory measured slower, PERF.md).  Lane
// c < 21 writes value c of the row; invalid candidates get zero rows.
// Reads the bool mask's bytes, so a call is one device kernel.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(sift::NEWTON_WARPS * 32) localize_resident_r4_kernel(
    const float* __restrict__ dog, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ ys,
    const int* __restrict__ xs, const unsigned char* __restrict__ valid, int k,
    int border, int num_intervals, int max_iters, float* __restrict__ outf,
    int* __restrict__ outi) {
  sift::localize_rows(dog, h, w, layer, ys, xs, valid, k, border, num_intervals,
                      max_iters, nullptr, 0, outi, outf);
}

// ---------------------------------------------------------------------------
// P1: the small bucket's trilinear descriptor histogram as two-hot matrix
// products on the tensor cores (replaces _kernel of desc_scratch_dot).
// One block of P1_WARPS warps per keypoint (so the probe's 512 rows fill
// the card; 4 and 16 measured slower); a row that is invalid or has
// nothing inside writes its zero row and leaves.  The (16 cells x 8 bins)
// histogram is one m16n8k8 accumulator tile per warp: per step of 8
// samples, A (16 x 8) holds each sample's spatial two-hot weight per cell
// and B (8 x 8) its orientation two-hot per bin.  Each warp walks its
// share of the keypoint's samples and queues those that may reach the
// histogram (sift::desc_fill, as K5 does), then takes them 32 at a time:
// each lane evaluates one sample (sift::desc_sample) and, unless all 32
// miss the histogram, writes its operands to the warp's table in shared
// memory, structure of arrays: rows rv[1..4] (the sample's row weight per
// cell row), cv[1..4] (per cell column) and ow[0..7] (per bin), one
// column per lane, rows 36 floats apart, so the 32 lanes' stores and the
// fragment loads each hit 32 banks (or share an address).  Lanes 8j..8j+7
// are mma step j.  Lane (g, t) builds its fragments from 8 loads a step,
// a = rv[row of cell g or g+8] * cv[column of g] of samples t and t + 4,
// b = ow[g] of the same two; a step whose 8 samples all miss (a warp
// ballot) runs no mma.  The warps' tiles are added in warp order: no float
// atomics, so repeated launches give the same bits.
// ---------------------------------------------------------------------------
constexpr int P1_WARPS = 8;
constexpr int P1_HALF = 28;
constexpr int P1_WW = 4;
constexpr int P1_NB = 8;
constexpr int P1_CELLS = P1_WW * P1_WW;  // 16: the mma's M
constexpr int P1_OUT = P1_CELLS * P1_NB;
constexpr int P1_ROW = 36;                      // floats between two table rows
constexpr int P1_TABLE = (2 * P1_WW + P1_NB) * P1_ROW;  // a warp's table
static_assert(sift::DESC_QUEUE >= 32 * (1 + sift::DESC_FILL),
              "a warp's queue holds a batch and one pass of desc_fill");

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

// the probe's two-hot weight at slot p: w0 at slot i, w1 at slot i + 1
__device__ __forceinline__ float p1_two_hot(int p, int i, float w0, float w1) {
  return (p == i ? w0 : 0.0f) + (p == i + 1 ? w1 : 0.0f);
}

template <bool HIGHEST>
__global__ void __launch_bounds__(P1_WARPS * 32) desc_scratch_dot_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int hs, int ws,
    const int* __restrict__ layer, const int* __restrict__ pys,
    const int* __restrict__ pxs, const int* __restrict__ half_ws,
    const float* __restrict__ coss, const float* __restrict__ sins,
    const float* __restrict__ hist_ws, const float* __restrict__ angles,
    const unsigned char* __restrict__ valid, int img_h, int img_w,
    float* __restrict__ out) {
  extern __shared__ float p1_smem[];  // the warps' tables, tiles and queues
  constexpr int n_warps = P1_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread in group
  const int i = blockIdx.x;
  float* orow = out + (size_t)i * P1_OUT;
  const sift::DescBox b =
      valid[i] ? sift::desc_box(hs, ws, img_h, img_w, P1_HALF, pys[i], pxs[i], half_ws[i])
               : sift::desc_empty_box();
  if (b.n == 0) {  // uniform over the block
    for (int e = threadIdx.x; e < P1_OUT; e += blockDim.x) orow[e] = 0.0f;
    return;
  }
  float* table = p1_smem + warp * P1_TABLE;
  float* part = p1_smem + n_warps * P1_TABLE;
  const sift::DescConsts c = sift::desc_consts(P1_WW, P1_NB);
  const sift::DescKey key =
      sift::desc_key(pys[i], pxs[i], coss[i], sins[i], hist_ws[i], angles[i], c);
  const float* mp = mag + (size_t)layer[i] * hs * ws;
  const float* ap = ang + (size_t)layer[i] * hs * ws;
  // this lane's fragment rows: cell rows g/4 + 1 and g/4 + 3, cell
  // column g%4 + 1, bin g; column t (sample t of a step)
  const float* rv_lo = table + (g >> 2) * P1_ROW + t;
  const float* rv_hi = table + ((g >> 2) + 2) * P1_ROW + t;
  const float* cv_g = table + (P1_WW + (g & 3)) * P1_ROW + t;
  const float* ow_g = table + (2 * P1_WW + g) * P1_ROW + t;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int* q = reinterpret_cast<int*>(part + n_warps * P1_OUT) + warp * sift::DESC_QUEUE;
  const unsigned q_addr = sift::orient_saddr(q);
  sift::LaneWalk wk(warp * 32 + lane, b.nc, 32 * n_warps);
  int p0 = warp * 32, head = 0, count = 0;
  for (;;) {
    sift::desc_fill(wk, p0, 32 * n_warps, b, key, lane, q_addr, head, count, 32);
    if (count == 0) break;  // uniform over the warp
    const int n = min(count, 32);
    __syncwarp();
    const bool live = lane < n;
    // any value past the batch
    const int e = __float_as_int(
        sift::orient_lds(q_addr + (unsigned)((head + lane) & (sift::DESC_QUEUE - 1)) * 4u));
    int row, col;
    sift::desc_unpack(live ? e : 0, b, row, col);
    head += n;
    count -= n;
    const unsigned off = (unsigned)(row * ws + col);
    const float m = __ldg(mp + off), a = __ldg(ap + off);
    bool slow = false;
    sift::DescSample s =
        sift::desc_sample<true>(row - key.py, col - key.px, m, a, live, key, c, slow);
    if (slow)
      s = sift::desc_sample<false>(row - key.py, col - key.px, m, a, live, key, c, slow);
    // mma step j takes lanes 8j..8j+7
    const unsigned in_mask = __ballot_sync(0xffffffffu, s.in);
    if (in_mask == 0u) {  // uniform over the warp
      __syncwarp();
      continue;
    }
    int o0, o1;
    float of;
    sift::desc_bins_probe(s.ob, P1_NB, o0, o1, of);
    const int ra = clampi(s.r0 + 1, 0, P1_WW + 1), ca = clampi(s.c0 + 1, 0, P1_WW + 1);
#pragma unroll
    for (int p = 1; p <= P1_WW; ++p) {
      table[(p - 1) * P1_ROW + lane] = p1_two_hot(p, ra, s.rw0, s.rw1);
      table[(P1_WW + p - 1) * P1_ROW + lane] = p1_two_hot(p, ca, s.cw0, s.cw1);
    }
#pragma unroll
    for (int bin = 0; bin < P1_NB; ++bin)
      table[(2 * P1_WW + bin) * P1_ROW + lane] =
          s.in ? (bin == o0 ? 1.0f - of : 0.0f) + (bin == o1 ? of : 0.0f) : 0.0f;
    __syncwarp();
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      if ((in_mask >> (8 * step)) & 0xffu) {
        // PTX m16n8k8 .tf32 fragments: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
        // a3 (g+8, t+4); b0 (k=t, n=g), b1 (k=t+4, n=g)
        const int s0 = 8 * step, s1 = s0 + 4;
        const float av[4] = {rv_lo[s0] * cv_g[s0], rv_hi[s0] * cv_g[s0],
                             rv_lo[s1] * cv_g[s1], rv_hi[s1] * cv_g[s1]};
        const float bv[2] = {ow_g[s0], ow_g[s1]};
        p1_mma<HIGHEST>(acc, av, bv);
      }
    }
    __syncwarp();
  }
  // accumulator fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
  float* tile_acc = part + warp * P1_OUT;
  tile_acc[g * P1_NB + 2 * t] = acc[0];
  tile_acc[g * P1_NB + 2 * t + 1] = acc[1];
  tile_acc[(g + 8) * P1_NB + 2 * t] = acc[2];
  tile_acc[(g + 8) * P1_NB + 2 * t + 1] = acc[3];
  __syncthreads();
  for (int e = threadIdx.x; e < P1_OUT; e += blockDim.x) {
    float v = part[e];
    for (int w2 = 1; w2 < n_warps; ++w2) v = v + part[w2 * P1_OUT + e];
    orow[e] = v;
  }
}

}  // namespace

extern "C" {

int probe_feas1_stack_sum(const void* dog, int n_l, int h, int w, long long plane,
                          long long row, void* out, void* stream) {
  if (n_l < 0 || h < P2_ROWS || w < P2_COLS) return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, int, long long, long long, float*);
  switch (n_l) {
    case 1: kernel = feas1_stack_sum_kernel<1>; break;
    case 2: kernel = feas1_stack_sum_kernel<2>; break;
    case 3: kernel = feas1_stack_sum_kernel<3>; break;
    case 4: kernel = feas1_stack_sum_kernel<4>; break;
    case 5: kernel = feas1_stack_sum_kernel<5>; break;
    case 6: kernel = feas1_stack_sum_kernel<6>; break;
    case 7: kernel = feas1_stack_sum_kernel<7>; break;
    case 8: kernel = feas1_stack_sum_kernel<8>; break;
    default: kernel = feas1_stack_sum_kernel<0>;
  }
  kernel<<<P2_ROWS, P2_THREADS, 0, (cudaStream_t)stream>>>((const float*)dog, n_l, plane,
                                                          row, (float*)out);
  return (int)cudaGetLastError();
}

int probe_feas2_cube_sums(const void* dog, int n_l, int h, int w, const void* l,
                          const void* y, const void* x, int k, void* out,
                          void* stream) {
  const int per_block = P3_WARPS * P3_PER_WARP;
  feas2_cube_sums_kernel<<<(k + per_block - 1) / per_block, P3_WARPS * 32, 0,
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
  localize_resident_r4_kernel<<<(k + sift::NEWTON_WARPS - 1) / sift::NEWTON_WARPS,
                                sift::NEWTON_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)dog, h, w, (const int*)layer, (const int*)y, (const int*)x,
      (const unsigned char*)valid, k, border, num_intervals, max_iters,
      (float*)outf, (int*)outi);
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
  const int smem = P1_WARPS * (P1_TABLE + P1_OUT + sift::DESC_QUEUE) * (int)sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<k, P1_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)mag, (const float*)ang, hs, ws, (const int*)layer,
      (const int*)py, (const int*)px, (const int*)half_w, (const float*)cos_a,
      (const float*)sin_a, (const float*)hist_width, (const float*)angle,
      (const unsigned char*)valid, img_h, img_w, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
