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

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "newton_step.cuh"
#include "orientation_hist.cuh"

namespace {

using sift::clampi;

// ---------------------------------------------------------------------------
// K1: per-candidate Newton localization (replaces localize_newton_resident).
// One warp per candidate, K1_WARPS per block (sift::newton_walk_warp): in
// each step lanes 0-26 load and divide the 27 cube values at once, and
// every lane runs the same step on the broadcast quotients, so the early
// exit is the warp's own.  Lane 0 writes the integer lanes and the 13 float
// lanes of the last compute; invalid candidates get zero rows.  The caller
// passes only the live leading chunks.
// ---------------------------------------------------------------------------
constexpr int K1_WARPS = 8;

__global__ void __launch_bounds__(K1_WARPS * 32) localize_newton_kernel(
    const float* __restrict__ dog, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ ys,
    const int* __restrict__ xs, const unsigned char* __restrict__ valid, int k,
    int border, int num_intervals, int max_iters, int* __restrict__ outi,
    float* __restrict__ outf) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * K1_WARPS + (threadIdx.x >> 5);
  if (i >= k) return;  // whole warps
  int* oi = outi + (size_t)i * sift::NEWTON_INTS;
  float* of = outf + (size_t)i * sift::NEWTON_FLOATS;
  if (!valid[i]) {
    if (lane == 0) sift::write_zero_lanes(oi, of);
    return;
  }
  const sift::NewtonState s = sift::newton_walk_warp(
      dog, h, w, border, num_intervals, max_iters, layer[i], ys[i], xs[i], lane);
  if (lane == 0) sift::write_lanes(s, oi, of);
}

// ---------------------------------------------------------------------------
// K3: descriptor window gather (replaces pair_window_gather).  A persistent
// grid (the SMs x the blocks that fit) walks the keypoints with a stride.
// Per keypoint the block loads an (S, B) box of each stack into shared
// memory: the window's S rows from its clamped start, columns from the
// start rounded down to 4 floats (TMA takes only an innermost coordinate
// that is a multiple of 16 bytes), B = S + 3 rounded up to 4 floats so the
// box covers the window and its rows are multiples of 16 bytes.  The boxes
// are double-buffered: the next keypoint's load is in flight while the
// block stores the current one.
// Loads: TMA (one thread starts a 3-D tensor-map copy per stack that
// completes on an mbarrier; out-of-bounds elements arrive as zeros), or,
// where a tensor map cannot describe the stacks (base not 16-byte aligned
// or W % 4 != 0), 4-byte cp.async by every thread with explicit zeros.
// Stores: each window is one flat range of S*S floats, written as 16-byte
// stores at aligned addresses with a scalar head and tail of <= 3 each.
// The kernel clamps the starts itself and writes sy, sx.  Windows whose two
// stages do not fit in shared memory take the direct stage below.
// ---------------------------------------------------------------------------
constexpr int K3_THREADS = 512;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// shared-memory offset of flat window element p in an (S, B) box
__device__ __forceinline__ int box_off(int p, int s, int bw) {
  const int r = p / s;
  return r * bw + (p - r * s);
}

__device__ __forceinline__ float pick4(const float (&v)[4], int i) {
  return i & 2 ? (i & 1 ? v[3] : v[2]) : (i & 1 ? v[1] : v[0]);
}

// Window i of both outputs from the current boxes (bm, ba: the window's
// first element in each box).
__device__ __forceinline__ void store_windows(const float* __restrict__ bm,
                                              const float* __restrict__ ba,
                                              float* __restrict__ gm,
                                              float* __restrict__ ga, int s, int bw) {
  const int tid = threadIdx.x;
  const int ss = s * s;
  // gm and ga share their alignment (the entry point checks the bases)
  const int head = min((int)(((16u - ((unsigned)(uintptr_t)gm & 15u)) & 15u) >> 2), ss);
  const int n4 = (ss - head) >> 2;
  const int tail = head + 4 * n4;
  if (tid < head) {
    const int o = box_off(tid, s, bw);
    gm[tid] = bm[o];
    ga[tid] = ba[o];
  }
  if (tail + tid < ss) {
    const int o = box_off(tail + tid, s, bw);
    gm[tail + tid] = bm[o];
    ga[tail + tid] = ba[o];
  }
  // Thread t stores elements p0..p0+3 but reads them rotated by g, so the
  // 32 lanes of a warp hit 32 different banks (unrotated, lanes 8 apart
  // would collide 4 ways).
  const int g = (tid >> 3) & 3;
#pragma unroll 2
  for (int q = tid; q < n4; q += K3_THREADS) {
    const int p0 = head + 4 * q;
    float m[4], a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = box_off(p0 + ((j + g) & 3), s, bw);
      m[j] = bm[o];
      a[j] = ba[o];
    }
    // element e sits in slot (e - g) & 3
    *reinterpret_cast<float4*>(gm + p0) = make_float4(
        pick4(m, -g & 3), pick4(m, (1 - g) & 3), pick4(m, (2 - g) & 3), pick4(m, (3 - g) & 3));
    *reinterpret_cast<float4*>(ga + p0) = make_float4(
        pick4(a, -g & 3), pick4(a, (1 - g) & 3), pick4(a, (2 - g) & 3), pick4(a, (3 - g) & 3));
  }
}

// S_T: the window size, or 0 for one given at run time.
template <int S_T, bool TMA>
__global__ void __launch_bounds__(K3_THREADS) pair_gather_kernel(
    __grid_constant__ const CUtensorMap mag_map,
    __grid_constant__ const CUtensorMap ang_map, const float* __restrict__ mag,
    const float* __restrict__ ang, int n_l, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ cys,
    const int* __restrict__ cxs, int k, int s_rt, float* __restrict__ magw,
    float* __restrict__ angw, int* __restrict__ sys, int* __restrict__ sxs) {
  extern __shared__ __align__(128) float k3_smem[];
  const int s = S_T > 0 ? S_T : s_rt;
  const int bw = (s + 6) & ~3;  // box width B
  const int half = s >> 1;
  const int box_pad = (s * bw + 31) & ~31;  // boxes start 128-byte aligned
  // boxes [stage 0 mag, stage 0 ang, stage 1 mag, stage 1 ang], then 2 mbarriers
  uint64_t* bars = reinterpret_cast<uint64_t*>(k3_smem + 4 * box_pad);
  const int row_hi = max(h, s) - s, col_hi = max(w, s) - s;
  const int tid = threadIdx.x;
  const CUtensorMap* mag_desc = &mag_map;
  const CUtensorMap* ang_desc = &ang_map;

  // start the loads of keypoint i's boxes into stage st
  auto load_boxes = [&](int i, int st) {
    const int sy = clampi(sift::wrap_add(cys[i], -half), 0, row_hi);
    const int sx = clampi(sift::wrap_add(cxs[i], -half), 0, col_hi);
    const int l = layer[i];
    float* dm = k3_smem + 2 * st * box_pad;
    float* da = dm + box_pad;
    if constexpr (TMA) {
      if (tid == 0) {
        // order this block's earlier reads of the stage before the async writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(&bars[st], 2u * s * bw * 4u);
        tma_load_3d(dm, mag_desc, &bars[st], sx & ~3, sy, l);
        tma_load_3d(da, ang_desc, &bars[st], sx & ~3, sy, l);
      }
    } else {
      const bool lok = l >= 0 && l < n_l;
      dm += sx & 3;
      da += sx & 3;
      for (int p = tid; p < s * s; p += K3_THREADS) {
        const int r = p / s, c = p - r * s;
        const int o = r * bw + c;
        if (lok && sy + r < h && sx + c < w) {
          const size_t gidx = ((size_t)l * h + (sy + r)) * w + (sx + c);
          cp_async4(dm + o, mag + gidx);
          cp_async4(da + o, ang + gidx);
        } else {
          dm[o] = 0.0f;
          da[o] = 0.0f;
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
  };

  if (TMA && tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if ((int)blockIdx.x < k) load_boxes(blockIdx.x, 0);
  int it = 0;
  const int stride = (int)gridDim.x;
  for (int i = blockIdx.x; i < k; i += stride, ++it) {
    const int st = it & 1;
    if (i + stride < k) {
      load_boxes(i + stride, st ^ 1);
    } else if (!TMA) {
      asm volatile("cp.async.commit_group;" ::: "memory");  // keep one group per step
    }
    if constexpr (TMA) {
      mbar_wait(&bars[st], (uint32_t)(it >> 1) & 1u);
    } else {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      __syncthreads();
    }
    const int sx = clampi(sift::wrap_add(cxs[i], -half), 0, col_hi);
    if (tid == 0) {
      sys[i] = clampi(sift::wrap_add(cys[i], -half), 0, row_hi);
      sxs[i] = sx;
    }
    const size_t obase = (size_t)i * s * s;
    const float* bm = k3_smem + 2 * st * box_pad + (sx & 3);
    store_windows(bm, bm + box_pad, magw + obase, angw + obase, s, bw);
    __syncthreads();  // the stage is free for the load two steps on
  }
}

// ---------------------------------------------------------------------------
// K3's direct stage, for windows whose two double-buffered boxes do not
// fit in a block's shared memory (S > 117): no shared memory; a persistent
// grid walks the keypoints, and each warp copies window rows straight from
// the stacks, with the other stages' clamped starts and zeros past the
// stack.  Row r of window i is the flat output range [r*S, r*S + S): 16-byte
// stores at aligned addresses with a scalar head and tail of <= 3 each.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(K3_THREADS) pair_gather_direct_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int n_l, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ cys,
    const int* __restrict__ cxs, int k, int s, float* __restrict__ magw,
    float* __restrict__ angw, int* __restrict__ sys, int* __restrict__ sxs) {
  constexpr int WARPS = K3_THREADS / 32;
  const int half = s >> 1;
  const int row_hi = max(h, s) - s, col_hi = max(w, s) - s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = blockIdx.x; i < k; i += gridDim.x) {
    const int sy = clampi(sift::wrap_add(cys[i], -half), 0, row_hi);
    const int sx = clampi(sift::wrap_add(cxs[i], -half), 0, col_hi);
    const int l = layer[i];
    if (threadIdx.x == 0) {
      sys[i] = sy;
      sxs[i] = sx;
    }
    // columns of a row that lie inside the stack (0 for a layer outside it)
    const int n_in = (l >= 0 && l < n_l) ? min(s, w - sx) : 0;
    for (int r = warp; r < s; r += WARPS) {
      const size_t o = ((size_t)i * s + r) * s;
      float* gm = magw + o;
      float* ga = angw + o;
      const int cin = sy + r < h ? n_in : 0;
      const size_t g = cin > 0 ? ((size_t)l * h + sy + r) * w + sx : 0;
      const float* rm = mag + g;
      const float* ra = ang + g;
      // gm and ga share their alignment (the entry point checks the bases)
      const int head = min((int)(((16u - ((unsigned)(uintptr_t)gm & 15u)) & 15u) >> 2), s);
      const int n4 = (s - head) >> 2;
      const int tail = head + 4 * n4;
      if (lane < head) {
        gm[lane] = lane < cin ? rm[lane] : 0.0f;
        ga[lane] = lane < cin ? ra[lane] : 0.0f;
      }
      if (tail + lane < s) {
        const int c = tail + lane;
        gm[c] = c < cin ? rm[c] : 0.0f;
        ga[c] = c < cin ? ra[c] : 0.0f;
      }
      for (int q = lane; q < n4; q += 32) {
        const int c0 = head + 4 * q;
        float m[4], a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m[j] = c0 + j < cin ? rm[c0 + j] : 0.0f;
          a[j] = c0 + j < cin ? ra[c0 + j] : 0.0f;
        }
        *reinterpret_cast<float4*>(gm + c0) = make_float4(m[0], m[1], m[2], m[3]);
        *reinterpret_cast<float4*>(ga + c0) = make_float4(a[0], a[1], a[2], a[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: raw orientation histograms (replaces orientation_histograms_v2), and
// K4 (replaces orientation_histograms, v1), which computes the same
// function.  Both run the walk of orientation_hist.cuh: one warp per
// keypoint over its radius box x clamped window x interior, private lane
// bin columns, a fixed-order reduction; invalid rows write zeros and load
// nothing.
// K2: a persistent grid.  Each warp stages its keypoint's box of both
// stacks in its own shared memory with cp.async, double-buffered: the next
// keypoint's copies are in flight while the current box is binned.  16-byte
// copies from the box's first column rounded down to 4 floats where the
// stacks allow them (16-byte aligned base, W % 4 == 0), else 4-byte copies.
// K4: one warp per keypoint, no staging: each lane loads K4_UNROLL samples
// from global memory before it bins any.  K2's entry bins a window whose two
// stages do not fit in a block's shared memory with K4's kernel.
// ---------------------------------------------------------------------------
constexpr int K2_MAX_WARPS = 2;  // warps per block
constexpr int K2_UNROLL = 4;
constexpr int K4_WARPS = 4;
constexpr int K4_UNROLL = 16;
constexpr int SMEM_PER_BLOCK = 232448;  // shared memory a block may opt into (Hopper)

// floats of one staged box: the window's rows, columns from a 4-float
// aligned start (at most S + 3 of them, rounded up to 4)
__host__ __device__ __forceinline__ int k2_box_floats(int half) {
  const int s = 2 * half + 1;
  return s * ((s + 6) & ~3);
}

// floats of one warp's shared memory: two stages of (mag, ang) boxes, then
// the lane bin columns; a multiple of 4 so every warp's boxes are 16-byte
// aligned
__host__ __device__ __forceinline__ int k2_warp_floats(int half, int nb) {
  return (4 * k2_box_floats(half) + nb * sift::ORIENT_ACC_STRIDE + 3) & ~3;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

struct StagedBox {
  sift::OrientBox b;
  int c0, bw;  // first staged column; floats per staged row
};

template <bool VEC>
__global__ void __launch_bounds__(K2_MAX_WARPS * 32) orientation_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ cys,
    const int* __restrict__ cxs, const int* __restrict__ radii,
    const float* __restrict__ wfs, const unsigned char* __restrict__ valid, int k,
    int half, int num_bins, float* __restrict__ out) {
  extern __shared__ __align__(16) float k2_smem[];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int first = blockIdx.x * warps + (threadIdx.x >> 5);
  if (first >= k) return;  // whole warps; no block-wide barrier below
  const int cap = k2_box_floats(half);
  float* stages = k2_smem + (size_t)(threadIdx.x >> 5) * k2_warp_floats(half, num_bins);
  float* acc = stages + 4 * cap;
  for (int bin = 0; bin < num_bins; ++bin) acc[bin * sift::ORIENT_ACC_STRIDE + lane] = 0.0f;
  const float bin_scale = (float)(num_bins / 360.0);
  const int stride = gridDim.x * warps;

  // start the copies of keypoint i's box into stage st: one commit group
  // per lane, empty for a row that loads nothing
  auto stage = [&](int i, int st) {
    StagedBox sb{};
    if (valid[i])
      sb.b = sift::orient_box(h, w, half, layer[i], cys[i], cxs[i], radii[i], wfs[i]);
    if (sb.b.n > 0) {
      float* dm = stages + 2 * st * cap;
      float* da = dm + cap;
      const size_t row0 = ((size_t)sb.b.layer * h + sb.b.r_lo) * w;
      if constexpr (VEC) {
        sb.c0 = sb.b.c_lo & ~3;
        const int nq = ((sb.b.c_hi - sb.c0) >> 2) + 1;  // 16-byte chunks per row
        sb.bw = 4 * nq;
        sift::LaneWalk cw(lane, nq);
        for (int p = lane; p < sb.b.nr * nq; p += 32, cw.step()) {
          const size_t g = row0 + (size_t)cw.row * w + sb.c0 + 4 * cw.col;
          const int o = cw.row * sb.bw + 4 * cw.col;
          cp_async16(dm + o, mag + g);
          cp_async16(da + o, ang + g);
        }
      } else {
        sb.c0 = sb.b.c_lo;
        sb.bw = sb.b.nc;
        sift::LaneWalk cw(lane, sb.b.nc);
        for (int p = lane; p < sb.b.n; p += 32, cw.step()) {
          const size_t g = row0 + (size_t)cw.row * w + sb.c0 + cw.col;
          const int o = cw.row * sb.bw + cw.col;
          cp_async4(dm + o, mag + g);
          cp_async4(da + o, ang + g);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    return sb;
  };

  StagedBox cur = stage(first, 0);
  int it = 0;
  for (int i = first; i < k; i += stride, ++it) {
    const int st = it & 1;
    StagedBox nxt{};
    if (i + stride < k) {
      nxt = stage(i + stride, st ^ 1);
    } else {
      asm volatile("cp.async.commit_group;" ::: "memory");  // keep one group per step
    }
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();  // every lane's copies of the current box are visible
    float* orow = out + (size_t)i * num_bins;
    if (cur.b.n == 0) {
      sift::orient_zero_row(orow, num_bins, lane);
    } else {
      const float* bm = stages + 2 * st * cap + (cur.b.c_lo - cur.c0);
      const float* ba = bm + cap;
      const int bw = cur.bw;
      sift::orient_walk<K2_UNROLL>(
          cur.b, lane, acc + lane, num_bins, bin_scale,
          [&](int rr, int cc, int, int, float& m, float& a) {
            const int o = rr * bw + cc;
            m = bm[o];
            a = ba[o];
          });
      __syncwarp();
      sift::orient_reduce(acc, num_bins, lane, orow);
    }
    __syncwarp();  // the stage and the bins are free for the next keypoints
    cur = nxt;
  }
}

__global__ void __launch_bounds__(K4_WARPS * 32) orientation_v1_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ cys,
    const int* __restrict__ cxs, const int* __restrict__ radii,
    const float* __restrict__ wfs, const unsigned char* __restrict__ valid, int k,
    int half, int num_bins, float* __restrict__ out) {
  extern __shared__ float k4_acc[];  // per warp: its lane bin columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * K4_WARPS + warp;
  if (i >= k) return;  // whole warps only; no block-wide barrier below
  float* orow = out + (size_t)i * num_bins;
  sift::OrientBox b{};
  if (valid[i]) b = sift::orient_box(h, w, half, layer[i], cys[i], cxs[i], radii[i], wfs[i]);
  if (b.n == 0) {
    sift::orient_zero_row(orow, num_bins, lane);
    return;
  }
  float* acc = k4_acc + (size_t)warp * num_bins * sift::ORIENT_ACC_STRIDE;
  for (int bin = 0; bin < num_bins; ++bin) acc[bin * sift::ORIENT_ACC_STRIDE + lane] = 0.0f;
  const size_t plane = (size_t)b.layer * h * w;
  sift::orient_walk<K4_UNROLL>(b, lane, acc + lane, num_bins, (float)(num_bins / 360.0),
                               [&](int, int, int row, int col, float& m, float& a) {
                                 const size_t off = plane + (size_t)row * w + col;
                                 m = __ldg(mag + off);
                                 a = __ldg(ang + off);
                               });
  __syncwarp();
  sift::orient_reduce(acc, num_bins, lane, orow);
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

// ---------------------------------------------------------------------------
// Host side: K3's tensor maps, and the launches of K2, K3 and K4.
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// An (L, H, W) f32 stack as a 3-D tensor map with a (B, S, 1) box.
int make_window_map(CUtensorMap* map, const void* base, int n_l, int h, int w, int s) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n_l};
  const cuuint64_t strides[2] = {(cuuint64_t)w * 4, (cuuint64_t)w * h * 4};
  const cuuint32_t box[3] = {(cuuint32_t)((s + 6) & ~3), (cuuint32_t)s, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                            const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

struct PairGatherArgs {
  const float* mag;
  const float* ang;
  int n_l, h, w;
  const int* layer;
  const int* cy;
  const int* cx;
  int k, s;
  float* magw;
  float* angw;
  int* sy;
  int* sx;
};

// The SMs and the blocks of `kernel` that fit on one; grid = min(want, both)
template <class Kernel>
int persistent_grid(Kernel kernel, int threads, int smem, int want, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = want < sms * per_sm ? want : sms * per_sm;
  return 0;
}

template <int S_T, bool TMA>
int launch_pair_gather(const CUtensorMap& mag_map, const CUtensorMap& ang_map,
                       const PairGatherArgs& a, cudaStream_t stream) {
  auto kernel = pair_gather_kernel<S_T, TMA>;
  const int box_pad = (a.s * ((a.s + 6) & ~3) + 31) & ~31;
  const int smem = 4 * box_pad * (int)sizeof(float) + 2 * (int)sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  const int gerr = persistent_grid(kernel, K3_THREADS, smem, a.k, &grid);
  if (gerr != 0) return gerr;
  kernel<<<grid, K3_THREADS, smem, stream>>>(
      mag_map, ang_map, a.mag, a.ang, a.n_l, a.h, a.w, a.layer, a.cy, a.cx, a.k, a.s,
      a.magw, a.angw, a.sy, a.sx);
  return (int)cudaGetLastError();
}

int launch_pair_gather_direct(const PairGatherArgs& a, cudaStream_t stream) {
  int grid = 0;
  const int err = persistent_grid(pair_gather_direct_kernel, K3_THREADS, 0, a.k, &grid);
  if (err != 0) return err;
  pair_gather_direct_kernel<<<grid, K3_THREADS, 0, stream>>>(
      a.mag, a.ang, a.n_l, a.h, a.w, a.layer, a.cy, a.cx, a.k, a.s, a.magw, a.angw,
      a.sy, a.sx);
  return (int)cudaGetLastError();
}

struct OrientArgs {
  const float* mag;
  const float* ang;
  int h, w;
  const int* layer;
  const int* cy;
  const int* cx;
  const int* radius;
  const float* wf;
  const unsigned char* valid;
  int k, half, num_bins;
  float* out;
};

int launch_orientation_v1(const OrientArgs& a, cudaStream_t stream) {
  const int smem = K4_WARPS * a.num_bins * sift::ORIENT_ACC_STRIDE * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      orientation_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  orientation_v1_kernel<<<(a.k + K4_WARPS - 1) / K4_WARPS, K4_WARPS * 32, smem, stream>>>(
      a.mag, a.ang, a.h, a.w, a.layer, a.cy, a.cx, a.radius, a.wf, a.valid, a.k, a.half,
      a.num_bins, a.out);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_orientation(const OrientArgs& a, cudaStream_t stream) {
  auto kernel = orientation_kernel<VEC>;
  const int warp_bytes = k2_warp_floats(a.half, a.num_bins) * (int)sizeof(float);
  const int warps = K2_MAX_WARPS * warp_bytes <= SMEM_PER_BLOCK ? K2_MAX_WARPS : 1;
  const int smem = warps * warp_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  const int gerr = persistent_grid(kernel, warps * 32, smem, (a.k + warps - 1) / warps, &grid);
  if (gerr != 0) return gerr;
  kernel<<<grid, warps * 32, smem, stream>>>(a.mag, a.ang, a.h, a.w, a.layer, a.cy, a.cx,
                                             a.radius, a.wf, a.valid, a.k, a.half,
                                             a.num_bins, a.out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sift_localize_newton(const void* dog, int h, int w, const void* layer,
                         const void* y, const void* x, const void* valid, int k,
                         int border, int num_intervals, int max_iters, void* outi,
                         void* outf, void* stream) {
  localize_newton_kernel<<<(k + K1_WARPS - 1) / K1_WARPS, K1_WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
      (const float*)dog, h, w, (const int*)layer, (const int*)y, (const int*)x,
      (const unsigned char*)valid, k, border, num_intervals, max_iters, (int*)outi,
      (float*)outf);
  return (int)cudaGetLastError();
}

int sift_orientation_histograms(const void* mag, const void* ang, int h, int w,
                                const void* layer, const void* cy, const void* cx,
                                const void* radius, const void* wf,
                                const void* valid, int k, int half, int num_bins,
                                int load, void* out, void* stream) {
  // load: 0 unstaged (K4's kernel), 1 4-byte cp.async, 2 16-byte cp.async
  if (num_bins < 1 || num_bins > sift::ORIENT_MAX_BINS || half < 0 || load < 0 ||
      load > 2)
    return (int)cudaErrorInvalidValue;
  if (load == 2 && ((((uintptr_t)mag | (uintptr_t)ang) & 15u) || w % 4))
    return (int)cudaErrorInvalidValue;
  if (load > 0 && k2_warp_floats(half, num_bins) * (int)sizeof(float) > SMEM_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  const OrientArgs args{(const float*)mag, (const float*)ang, h, w, (const int*)layer,
                        (const int*)cy, (const int*)cx, (const int*)radius,
                        (const float*)wf, (const unsigned char*)valid, k, half,
                        num_bins, (float*)out};
  const cudaStream_t st = (cudaStream_t)stream;
  if (load == 0) return launch_orientation_v1(args, st);
  return load == 2 ? launch_orientation<true>(args, st) : launch_orientation<false>(args, st);
}

int sift_pair_window_gather(const void* mag, const void* ang, int n_l, int h,
                            int w, const void* layer, const void* cy,
                            const void* cx, int k, int s, int load, void* magw,
                            void* angw, void* sy, void* sx, void* stream) {
  // load: 0 cp.async, 1 TMA, 2 direct (no shared memory)
  if (s < 1 || load < 0 || load > 2 || (((uintptr_t)magw | (uintptr_t)angw) & 15u))
    return (int)cudaErrorInvalidValue;
  const bool use_tma = load == 1;
  CUtensorMap mag_map{}, ang_map{};
  if (use_tma) {
    if ((((uintptr_t)mag | (uintptr_t)ang) & 15u) || w % 4) return (int)cudaErrorInvalidValue;
    int err = make_window_map(&mag_map, mag, n_l, h, w, s);
    if (err == 0) err = make_window_map(&ang_map, ang, n_l, h, w, s);
    if (err != 0) return err;
  }
  const PairGatherArgs args{(const float*)mag, (const float*)ang, n_l, h, w,
                            (const int*)layer, (const int*)cy, (const int*)cx, k, s,
                            (float*)magw, (float*)angw, (int*)sy, (int*)sx};
  const cudaStream_t st = (cudaStream_t)stream;
  if (load == 2) return launch_pair_gather_direct(args, st);
  if (s == 57)
    return use_tma ? launch_pair_gather<57, true>(mag_map, ang_map, args, st)
                   : launch_pair_gather<57, false>(mag_map, ang_map, args, st);
  if (s == 89)
    return use_tma ? launch_pair_gather<89, true>(mag_map, ang_map, args, st)
                   : launch_pair_gather<89, false>(mag_map, ang_map, args, st);
  return use_tma ? launch_pair_gather<0, true>(mag_map, ang_map, args, st)
                 : launch_pair_gather<0, false>(mag_map, ang_map, args, st);
}

int sift_orientation_histograms_v1(const void* mag, const void* ang, int h,
                                   int w, const void* layer, const void* cy,
                                   const void* cx, const void* radius,
                                   const void* wf, const void* valid, int k,
                                   int half, int num_bins, void* out,
                                   void* stream) {
  if (num_bins < 1 || num_bins > sift::ORIENT_MAX_BINS || half < 0)
    return (int)cudaErrorInvalidValue;
  const OrientArgs args{(const float*)mag, (const float*)ang, h, w, (const int*)layer,
                        (const int*)cy, (const int*)cx, (const int*)radius,
                        (const float*)wf, (const unsigned char*)valid, k, half,
                        num_bins, (float*)out};
  return launch_orientation_v1(args, (cudaStream_t)stream);
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
