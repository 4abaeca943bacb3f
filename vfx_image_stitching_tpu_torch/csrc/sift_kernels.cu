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

#include "descriptor_hist.cuh"
#include "newton_step.cuh"
#include "orientation_hist.cuh"

namespace {

using sift::clampi;

// ---------------------------------------------------------------------------
// K1: per-candidate Newton localization (replaces localize_newton_resident).
// sift::localize_rows, P4's body too: one warp per candidate, NEWTON_WARPS
// per block; in each step lanes 0-26 load and divide the 27 cube values at
// once, and every lane runs the same step on the broadcast quotients, so
// the early exit is the warp's own.  Lane c < 21 writes value c of the
// row (the integer lanes, then the 13 float lanes of the last compute);
// invalid candidates get zero rows.  The caller passes only the live
// leading chunks.  Over a batch of images (img non-null) candidate i walks
// image img[i]'s stack, stack_elems floats a stack.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(sift::NEWTON_WARPS * 32) localize_newton_kernel(
    const float* __restrict__ dog, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ ys,
    const int* __restrict__ xs, const unsigned char* __restrict__ valid, int k,
    int border, int num_intervals, int max_iters, const int* __restrict__ img,
    size_t stack_elems, int* __restrict__ outi, float* __restrict__ outf) {
  sift::localize_rows(dog, h, w, layer, ys, xs, valid, k, border, num_intervals,
                      max_iters, img, stack_elems, outi, outf);
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
// One block of K5_WARPS warps (T = K5_THREADS threads) per keypoint (the
// 1, 2 and 8 warp blocks measured slower); a row that is
// invalid or has nothing inside writes its zero row and leaves.  Each warp
// walks its share of the keypoint's samples and queues those that may
// reach the histogram (sift::desc_fill), then takes them 32 * K5_UNROLL
// at a time, K5_UNROLL a lane: the batch's loads, then its samples
// (sift::desc_sample), without a branch; then each sample's 8 trilinear
// terms into the thread's own column of shared memory, acc[o * T + t]
// (every address of a thread lies in bank t % 32).  The 8 terms of one
// sample go to 8 distinct bins (a term of a dropped sample, or of a cell
// outside the inner ww x ww, goes to the column's spare slot n_out, which
// nothing reads), so their 8 loads issue together; a lane's samples follow
// one another.  After one barrier thread t sums output o = t, t + T, ...
// over the T columns (T a power of 2), 16 bytes at a time from column
// 4o on (mod T), in four partial sums: a fixed order, no barrier per
// level, no float atomics, so repeated launches give the same bits.
// WW_T, NB_T: the cells and bins compiled in (the SIFT path's 4 x 8), or
// 0 to take them from the arguments.
// ---------------------------------------------------------------------------
constexpr int K5_WARPS = 4;
constexpr int K5_THREADS = 32 * K5_WARPS;  // a power of 2
constexpr int K5_MAX_OUT = 128;
constexpr int K5_UNROLL = 4;
static_assert(sift::DESC_QUEUE >= 32 * (K5_UNROLL + sift::DESC_FILL),
              "a warp's queue holds a batch and one pass of desc_fill");

// sample s's terms into the column at shared address col: bin o of cell
// (r, c) at col + (r ww + c) cell_bytes + o bin_bytes; the spare slot at
// `spare`
__device__ __forceinline__ void k5_add(const sift::DescSample& s, int ww, int nb,
                                       unsigned col, unsigned bin_bytes,
                                       unsigned cell_bytes, unsigned spare) {
  int o0, o1;
  float of;
  sift::desc_bins_wrap(s.ob, nb, o0, o1, of);
  // one bin (nb == 1) takes both terms: the plain version's (1 - of) + of
  const float w_lo = nb == 1 ? (1.0f - of) + of : 1.0f - of;
  const unsigned base = (unsigned)(s.r0 * ww + s.c0) * cell_bytes;
  const unsigned lo = col + (unsigned)o0 * bin_bytes, hi = col + (unsigned)o1 * bin_bytes;
  unsigned ad[8];
  float tv[8];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const bool ok = s.in && (unsigned)(s.r0 + a) < (unsigned)ww &&
                      (unsigned)(s.c0 + b) < (unsigned)ww;
      const unsigned cell = base + (a * (unsigned)ww + b) * cell_bytes;
      const float v = (a ? s.rw1 : s.rw0) * (b ? s.cw1 : s.cw0);
      const int e = 2 * (2 * a + b);
      ad[e] = ok ? cell + lo : spare;
      ad[e + 1] = ok && nb > 1 ? cell + hi : spare;
      tv[e] = v * w_lo;
      tv[e + 1] = v * of;
    }
  }
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = sift::orient_lds(ad[e]);
#pragma unroll
  for (int e = 0; e < 8; ++e) sift::orient_sts(ad[e], x[e] + tv[e]);
}

template <int WW_T, int NB_T>
__global__ void __launch_bounds__(K5_THREADS) descriptor_kernel(
    const float* __restrict__ mag, const float* __restrict__ ang, int h, int w,
    const int* __restrict__ layer, const int* __restrict__ pys,
    const int* __restrict__ pxs, const int* __restrict__ half_ws,
    const float* __restrict__ coss, const float* __restrict__ sins,
    const float* __restrict__ hist_ws, const float* __restrict__ angles,
    const unsigned char* __restrict__ valid, int half_cap, int num_bins_arg, int ww_arg,
    float* __restrict__ out) {
  // acc[o * T + t], o = 0..n_out (n_out: the spare slot), then the warps' queues
  extern __shared__ float acc[];
  const int ww = WW_T ? WW_T : ww_arg, num_bins = NB_T ? NB_T : num_bins_arg;
  const int i = blockIdx.x;
  constexpr int T = K5_THREADS;
  const int t = threadIdx.x, lane = t & 31;
  const int n_out = ww * ww * num_bins;
  float* orow = out + (size_t)i * n_out;
  // every per-keypoint load at once
  const bool ok = valid[i];
  const int py = pys[i], px = pxs[i], hw = half_ws[i], lyr = layer[i];
  const float cos_a = coss[i], sin_a = sins[i], hwid = hist_ws[i], angle = angles[i];
  const sift::DescBox b =
      ok ? sift::desc_box(h, w, h, w, half_cap, py, px, hw) : sift::desc_empty_box();
  if (b.n == 0) {  // uniform over the block
    for (int o = t; o < n_out; o += T) orow[o] = 0.0f;
    return;
  }
  const int n_acc = (n_out + 1) * T;  // a multiple of 4: T is
  for (int e = t; e < n_acc / 4; e += T)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  int* q = reinterpret_cast<int*>(acc + n_acc) + (t >> 5) * sift::DESC_QUEUE;
  const sift::DescConsts c = sift::desc_consts(ww, num_bins);
  const sift::DescKey key = sift::desc_key(py, px, cos_a, sin_a, hwid, angle, c);
  const float* mp = mag + (size_t)lyr * h * w;
  const float* ap = ang + (size_t)lyr * h * w;
  const unsigned bin_bytes = (unsigned)T * 4u, cell_bytes = (unsigned)num_bins * bin_bytes;
  const unsigned col = sift::orient_saddr(acc + t);
  const unsigned spare = col + (unsigned)n_out * bin_bytes;
  const unsigned q_addr = sift::orient_saddr(q);
  sift::LaneWalk wk(t, b.nc, T);
  int p0 = t & ~31, head = 0, count = 0;
  for (;;) {
    sift::desc_fill(wk, p0, T, b, key, lane, q_addr, head, count, 32 * K5_UNROLL);
    if (count == 0) break;  // uniform over the warp
    const int n = min(count, 32 * K5_UNROLL);
    __syncwarp();
    int row[K5_UNROLL], cc[K5_UNROLL];
    bool live[K5_UNROLL];
#pragma unroll
    for (int u = 0; u < K5_UNROLL; ++u) {
      // every slot is read (one past the batch may hold anything) and
      // then replaced by the box's first sample, without a branch
      live[u] = lane + 32 * u < n;
      const int e = __float_as_int(sift::orient_lds(
          q_addr + (unsigned)((head + lane + 32 * u) & (sift::DESC_QUEUE - 1)) * 4u));
      sift::desc_unpack(live[u] ? e : 0, b, row[u], cc[u]);
    }
    head += n;
    count -= n;
    __syncwarp();
    float m[K5_UNROLL], a[K5_UNROLL];
#pragma unroll
    for (int u = 0; u < K5_UNROLL; ++u) {
      const unsigned off = (unsigned)(row[u] * w + cc[u]);
      m[u] = __ldg(mp + off);
      a[u] = __ldg(ap + off);
    }
    sift::DescSample s[K5_UNROLL];
    bool slow = false;
#pragma unroll
    for (int u = 0; u < K5_UNROLL; ++u)
      s[u] = sift::desc_sample<true>(row[u] - key.py, cc[u] - key.px, m[u], a[u], live[u],
                                     key, c, slow);
    if (slow) {
#pragma unroll
      for (int u = 0; u < K5_UNROLL; ++u)
        s[u] = sift::desc_sample<false>(row[u] - key.py, cc[u] - key.px, m[u], a[u],
                                        live[u], key, c, slow);
    }
#pragma unroll
    for (int u = 0; u < K5_UNROLL; ++u)
      k5_add(s[u], ww, num_bins, col, bin_bytes, cell_bytes, spare);
  }
  __syncthreads();
  for (int o = t; o < n_out; o += T) {
    const float* r = acc + o * T;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int n = 0; n < T; n += 4) {
      // columns n + 4o .. + 3 (mod T, a power of 2): a quarter warp's 8
      // outputs read 8 different groups of 4 banks
      const float4 x = *reinterpret_cast<const float4*>(r + ((n + 4 * o) & (T - 1)));
      v[0] += x.x;
      v[1] += x.y;
      v[2] += x.z;
      v[3] += x.w;
    }
    orow[o] = (v[0] + v[1]) + (v[2] + v[3]);
  }
}

// Every finite float x: the descriptor kernels' remainder mod nb and
// orientation bins (K5's and P1's) against fmodf and integer modulo, their
// floor against floorf where |x| < 2^22, and their division x / b for each
// of the n_b bin widths bs against IEEE division, bit for bit (the path's
// arguments are finite: differences of angles, offsets of integers); also
// their int-float conversions on every int below 2^22 in magnitude.  Adds
// the number of x that differ to bad[0] (remainder, bins, floor and
// conversions) and bad[1] (divisions).
__global__ void descriptor_arith_check_kernel(int nb, const float* __restrict__ bs,
                                              int n_b, unsigned long long* bad) {
  const float nbf = (float)nb;
  const sift::DescConsts c = sift::desc_consts(4, nb);
  unsigned long long n_mod = 0, n_div = 0;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += step) {
    const float x = __uint_as_float((unsigned)i);
    const int v = (int)(unsigned)i;
    bool same = true;
    if (v > -(1 << 22) && v < (1 << 22))
      same = __float_as_uint(sift::desc_i2f(v)) == __float_as_uint((float)v) &&
             sift::desc_f2i((float)v) == v;
    if (isfinite(x)) {
      const float ob = sift::desc_remainder_ref(x, nbf);
      same = same && __float_as_uint(sift::desc_remainder(x, nbf)) == __float_as_uint(ob);
      if (fabsf(x) < 0x1p22f)
        same = same && __float_as_uint(sift::desc_floor(x)) == __float_as_uint(floorf(x));
      int a0, a1, b0, b1;
      float af, bf;
      sift::desc_bins_wrap(ob, nb, a0, a1, af);
      sift::desc_bins_wrap_ref(ob, nb, b0, b1, bf);
      same = same && a0 == b0 && a1 == b1 && __float_as_uint(af) == __float_as_uint(bf);
      sift::desc_bins_probe(ob, nb, a0, a1, af);
      sift::desc_bins_probe_ref(ob, nb, b0, b1, bf);
      same = same && a0 == b0 && a1 == b1 && __float_as_uint(af) == __float_as_uint(bf);
    }
    n_mod += !same;
    bool div_same = true;
    for (int j = 0; j < n_b; ++j) {
      const sift::DescKey k = sift::desc_key(0, 0, 1.0f, 0.0f, bs[j], 0.0f, c);
      bool slow = false;
      float q = sift::desc_div(x, k, slow);
      if (slow) q = x / bs[j];
      div_same = div_same && __float_as_uint(q) == __float_as_uint(x / bs[j]);
    }
    n_div += !div_same;
  }
  if (n_mod) atomicAdd(bad, n_mod);
  if (n_div) atomicAdd(bad + 1, n_div);
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
                         int border, int num_intervals, int max_iters,
                         const void* img, long long stack_elems, void* outi,
                         void* outf, void* stream) {
  // img: each candidate's image in a batch of stacks, or null for one stack
  if (img && stack_elems <= 0) return (int)cudaErrorInvalidValue;
  localize_newton_kernel<<<(k + sift::NEWTON_WARPS - 1) / sift::NEWTON_WARPS,
                           sift::NEWTON_WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
      (const float*)dog, h, w, (const int*)layer, (const int*)y, (const int*)x,
      (const unsigned char*)valid, k, border, num_intervals, max_iters,
      (const int*)img, (size_t)stack_elems, (int*)outi, (float*)outf);
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
  auto kernel = ww == 4 && num_bins == 8 ? descriptor_kernel<4, 8> : descriptor_kernel<0, 0>;
  const int smem =
      ((n_out + 1) * K5_THREADS + K5_WARPS * sift::DESC_QUEUE) * (int)sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<k, K5_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)mag, (const float*)ang, h, w, (const int*)layer,
      (const int*)py, (const int*)px, (const int*)half_w, (const float*)cos_a,
      (const float*)sin_a, (const float*)hist_width, (const float*)angle,
      (const unsigned char*)valid, half_cap, num_bins, ww, (float*)out);
  return (int)cudaGetLastError();
}

int sift_descriptor_arith_check(int num_bins, const void* bin_widths, int n_b, void* bad,
                                void* stream) {
  if (num_bins < 1 || n_b < 0) return (int)cudaErrorInvalidValue;
  descriptor_arith_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      num_bins, (const float*)bin_widths, n_b, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
