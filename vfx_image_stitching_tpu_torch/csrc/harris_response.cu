// Hand-written Hopper (sm_90a) kernel of the Harris corner response
// (vfx_image_stitching_tpu_torch/models/harris.py): gray, gradients, the
// three structure products, their separable Gaussian blur and the response
// R = det - k tr^2 of every pixel of a batch of images, in one launch.  It
// replaces no TPU kernel: the JAX package's Harris is XLA ops.  The wrapper,
// its plain version and the design note live in models/harris.py.  Built
// into a library of its own, with -fmad=false and without --use_fast_math,
// so every multiply and add below is one IEEE float32 rounding in the plain
// version's order, and the outputs are the plain version's bits.
//
// Plain C entry point (loaded with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;      // output columns a block
constexpr int kTileH = 32;      // output rows a block
constexpr int kThreads = 256;
constexpr int kMaxTaps = 63;    // longest blur the shared memory takes
constexpr int kRowsPerJob = 8;  // vertical pass: rows of a column a thread sums
constexpr int kColsPerJob = 4;  // horizontal pass: columns of a row a thread sums

struct Taps {
  float k[kMaxTaps];
};

// Source index of position v on an axis of n under BORDER_REFLECT_101, the
// reflection repeated where the pad exceeds the axis (np.pad's "reflect").
__device__ __forceinline__ int reflect101(int v, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  int m = v % p;
  if (m < 0) m += p;
  return m < n ? m : p - m;
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Row pitches (floats) of the shared-memory windows for a blur of nt taps:
// odd, so the horizontal pass's lanes (8 column strips by 4 rows a warp)
// fall in 32 distinct banks.
__host__ __device__ __forceinline__ int gray_pitch(int nt) {
  return (kTileW + nt + 1) | 1;
}
__host__ __device__ __forceinline__ int grad_pitch(int nt) {
  return (kTileW + nt - 1) | 1;
}

// One block: output tile (y0, x0) of image blockIdx.z.  With R = nt / 2 taps
// left of the centre and nt - 1 - R right of it, the blur of output row y
// reads the product at row reflect101(y - R + t) for tap t, so the block
// needs the products (hence the gradients) over the gradient window, the
// tile widened by R and nt - 1 - R and clipped to the image (every reflected
// index lands in it), and the gray image over that window widened by one
// pixel (the gradients' edge-replicated neighbours).  Phases, one barrier
// between each:
//   1. the row and column maps (reflected index -> window index), and the
//      gray window from the BGR (or gray) bytes: OpenCV's 15-bit fixed point,
//      as an exact float;
//   2. ix = g[x-1] * 1 + g[x+1] * (-1) and iy the same over rows, on the
//      edge-replicated gray, over the gradient window;
//   3. the tile's ix and iy to global memory, and the vertical pass: each
//      thread takes one window column and kRowsPerJob tile rows, loads each
//      (ix, iy) once, forms ix*ix, iy*iy, ix*iy and adds product * tap into
//      each row's three sums in tap order (out = p[t0] * k0, then out = out
//      + p[t] * k_t), so the loads slide over the taps;
//   4. the horizontal pass over the vertical sums the same way, kColsPerJob
//      columns a thread, then det = xx*yy - xy*xy, tr = xx + yy and
//      r = det - k (tr*tr), written to global memory.
// KT > 0 compiles the tap count in (the loops unroll and the taps become
// constant operands); KT == 0 reads it from ktaps.
template <int KT>
__global__ void __launch_bounds__(kThreads)
harris_response_kernel(const uint8_t* __restrict__ src, int h, int w,
                       int channels, const Taps taps, int ktaps, float k,
                       float* __restrict__ ix_out, float* __restrict__ iy_out,
                       float* __restrict__ r_out) {
  const int nt = KT > 0 ? KT : ktaps;
  const int rad = nt / 2;
  const int rad_r = nt - 1 - rad;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int n = blockIdx.z;
  // gradient window [py0, py1) x [px0, px1) and gray window, image coords
  const int py0 = max(0, y0 - rad), py1 = min(h, y0 + kTileH + rad_r);
  const int px0 = max(0, x0 - rad), px1 = min(w, x0 + kTileW + rad_r);
  const int ph = py1 - py0, pw = px1 - px0;
  const int gy0 = max(0, py0 - 1), gy1 = min(h, py1 + 1);
  const int gx0 = max(0, px0 - 1), gx1 = min(w, px1 + 1);
  const int gh = gy1 - gy0, gw = gx1 - gx0;

  const int gpitch = gray_pitch(nt), ppitch = grad_pitch(nt);
  const int vplane = kTileH * ppitch;
  extern __shared__ float smem[];
  float* gray = smem;                                   // (kTileH + nt + 1) rows
  float* gxs = gray + (kTileH + nt + 1) * gpitch;       // (kTileH + nt - 1) rows
  float* gys = gxs + (kTileH + nt - 1) * ppitch;
  float* vs = gys + (kTileH + nt - 1) * ppitch;         // 3 planes of kTileH rows
  int* rowmap = reinterpret_cast<int*>(vs + 3 * vplane);  // kTileH + nt - 1
  int* colmap = rowmap + kTileH + nt - 1;                 // kTileW + nt - 1

  // 1. maps (clamped: rows and columns past the image's last output read
  // some window entry and are never written) and the gray window
  for (int i = threadIdx.x; i < kTileH + nt - 1; i += blockDim.x)
    rowmap[i] = clamp_int(reflect101(y0 - rad + i, h) - py0, 0, ph - 1);
  for (int j = threadIdx.x; j < kTileW + nt - 1; j += blockDim.x)
    colmap[j] = clamp_int(reflect101(x0 - rad + j, w) - px0, 0, pw - 1);
  const uint8_t* img = src + (size_t)n * h * w * channels;
  for (int e = threadIdx.x; e < gh * gw; e += blockDim.x) {
    const int r = e / gw, c = e - r * gw;
    const size_t p = (size_t)(gy0 + r) * w + (gx0 + c);
    int g;
    if (channels == 3) {
      const uint8_t* q = img + p * 3;
      g = (q[0] * 3735 + q[1] * 19235 + q[2] * 9798 + (1 << 14)) >> 15;
    } else {
      g = img[p];
    }
    gray[r * gpitch + c] = (float)g;
  }
  __syncthreads();

  // 2. gradients over the gradient window
  for (int e = threadIdx.x; e < ph * pw; e += blockDim.x) {
    const int pr = e / pw, pc = e - pr * pw;
    const int r = py0 + pr, c = px0 + pc;
    const float* row = gray + (r - gy0) * gpitch;
    const float left = row[max(c - 1, 0) - gx0];
    const float right = row[min(c + 1, w - 1) - gx0];
    const float up = gray[(max(r - 1, 0) - gy0) * gpitch + (c - gx0)];
    const float down = gray[(min(r + 1, h - 1) - gy0) * gpitch + (c - gx0)];
    gxs[pr * ppitch + pc] = __fadd_rn(__fmul_rn(left, 1.0f),
                                      __fmul_rn(right, -1.0f));
    gys[pr * ppitch + pc] = __fadd_rn(__fmul_rn(up, 1.0f),
                                      __fmul_rn(down, -1.0f));
  }
  __syncthreads();

  // 3. the tile's gradients out; the vertical pass into vs
  for (int e = threadIdx.x; e < kTileH * kTileW; e += blockDim.x) {
    const int y = y0 + e / kTileW, x = x0 + e % kTileW;
    if (y < h && x < w) {
      const size_t o = ((size_t)n * h + y) * w + x;
      const int l = (y - py0) * ppitch + (x - px0);
      ix_out[o] = gxs[l];
      iy_out[o] = gys[l];
    }
  }
  for (int job = threadIdx.x; job < (kTileH / kRowsPerJob) * pw;
       job += blockDim.x) {
    const int s0 = job / pw * kRowsPerJob, c = job % pw;
    float acc[kRowsPerJob][3] = {};
#pragma unroll
    for (int i = 0; i < kRowsPerJob + nt - 1; ++i) {
      const int l = rowmap[s0 + i] * ppitch + c;
      const float a = gxs[l], b = gys[l];
      const float pxx = __fmul_rn(a, a), pyy = __fmul_rn(b, b);
      const float pxy = __fmul_rn(a, b);
#pragma unroll
      for (int s = 0; s < kRowsPerJob; ++s) {
        const int t = i - s;
        if (t < 0 || t >= nt) continue;
        const float kt = taps.k[t];
        const float txx = __fmul_rn(pxx, kt), tyy = __fmul_rn(pyy, kt);
        const float txy = __fmul_rn(pxy, kt);
        if (t == 0) {
          acc[s][0] = txx;
          acc[s][1] = tyy;
          acc[s][2] = txy;
        } else {
          acc[s][0] = __fadd_rn(acc[s][0], txx);
          acc[s][1] = __fadd_rn(acc[s][1], tyy);
          acc[s][2] = __fadd_rn(acc[s][2], txy);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kRowsPerJob; ++s) {
      const int l = (s0 + s) * ppitch + c;
      vs[l] = acc[s][0];
      vs[vplane + l] = acc[s][1];
      vs[2 * vplane + l] = acc[s][2];
    }
  }
  __syncthreads();

  // 4. the horizontal pass and the response
  constexpr int kStrips = kTileW / kColsPerJob;
  for (int job = threadIdx.x; job < kTileH * kStrips; job += blockDim.x) {
    const int yl = job / kStrips, xs = job % kStrips * kColsPerJob;
    const int y = y0 + yl;
    if (y >= h) continue;
    const float* row = vs + yl * ppitch;
    float acc[kColsPerJob][3] = {};
#pragma unroll
    for (int j = 0; j < kColsPerJob + nt - 1; ++j) {
      const int l = colmap[xs + j];
      const float a = row[l], b = row[vplane + l], c = row[2 * vplane + l];
#pragma unroll
      for (int s = 0; s < kColsPerJob; ++s) {
        const int t = j - s;
        if (t < 0 || t >= nt) continue;
        const float kt = taps.k[t];
        const float txx = __fmul_rn(a, kt), tyy = __fmul_rn(b, kt);
        const float txy = __fmul_rn(c, kt);
        if (t == 0) {
          acc[s][0] = txx;
          acc[s][1] = tyy;
          acc[s][2] = txy;
        } else {
          acc[s][0] = __fadd_rn(acc[s][0], txx);
          acc[s][1] = __fadd_rn(acc[s][1], tyy);
          acc[s][2] = __fadd_rn(acc[s][2], txy);
        }
      }
    }
    float out[kColsPerJob];
#pragma unroll
    for (int s = 0; s < kColsPerJob; ++s) {
      const float det = __fsub_rn(__fmul_rn(acc[s][0], acc[s][1]),
                                  __fmul_rn(acc[s][2], acc[s][2]));
      const float tr = __fadd_rn(acc[s][0], acc[s][1]);
      out[s] = __fsub_rn(det, __fmul_rn(k, __fmul_rn(tr, tr)));
    }
    const int x = x0 + xs;
    float* dst = r_out + ((size_t)n * h + y) * w + x;
    if ((w & 3) == 0 && x + kColsPerJob <= w) {
      *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2],
                                                    out[3]);
    } else {
#pragma unroll
      for (int s = 0; s < kColsPerJob; ++s)
        if (x + s < w) dst[s] = out[s];
    }
  }
}

}  // namespace

// Dynamic shared memory of a block for a blur of nt taps: the gray window,
// the two gradient windows, the three planes of vertical sums and the maps.
static size_t harris_smem_bytes(int nt) {
  const size_t floats =
      (size_t)(kTileH + nt + 1) * gray_pitch(nt) +
      (size_t)2 * (kTileH + nt - 1) * grad_pitch(nt) +
      (size_t)3 * kTileH * grad_pitch(nt);
  const size_t ints = (size_t)(kTileH + kTileW + 2 * (nt - 1));
  return 4 * (floats + ints);
}

template <int KT>
static int harris_launch(dim3 grid, size_t smem, cudaStream_t stream,
                         const uint8_t* src, int h, int w, int channels,
                         const Taps& taps, int ntaps, float k, float* ix,
                         float* iy, float* r) {
  // above 48 KB a kernel takes dynamic shared memory only once allowed
  const cudaError_t e = cudaFuncSetAttribute(
      harris_response_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  harris_response_kernel<KT><<<grid, kThreads, smem, stream>>>(
      src, h, w, channels, taps, ntaps, k, ix, iy, r);
  return (int)cudaGetLastError();
}

extern "C" {

// ix, iy and r, each (n, h, w) float32, of n images (n, h, w, channels)
// uint8 (channels 3: BGR; 1: gray), with the ntaps float32 blur taps at
// taps (host memory) and the response constant k.
int harris_response(const void* src, int n, int h, int w, int channels,
                    const float* taps, int ntaps, float k, void* ix, void* iy,
                    void* r, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || (channels != 1 && channels != 3) ||
      ntaps < 1 || ntaps > kMaxTaps || n > 65535 ||
      (h + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int i = 0; i < ntaps; ++i) t.k[i] = taps[i];
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  const size_t smem = harris_smem_bytes(ntaps);
  const auto s = (cudaStream_t)stream;
  const auto in = (const uint8_t*)src;
  if (ntaps == 21)  // the reference's 21-px structure blur
    return harris_launch<21>(grid, smem, s, in, h, w, channels, t, ntaps, k,
                             (float*)ix, (float*)iy, (float*)r);
  return harris_launch<0>(grid, smem, s, in, h, w, channels, t, ntaps, k,
                          (float*)ix, (float*)iy, (float*)r);
}

}  // extern "C"
