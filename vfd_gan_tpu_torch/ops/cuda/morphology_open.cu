// Morphological opening (erode, then dilate) of contiguous float32 planes.
//
// Replaces vfd_gan_tpu/ops/pallas/morphology.py::_open_kernel: over planes
// (N, P, Q) it takes a separable 1 x k then k x 1 windowed min with a +inf
// border (erode), then the matching max passes with a -inf border (dilate).
// A border that never wins the min or max is the same as clipping the
// window to the plane, which is what the passes below do.
//
// What bounds it on an H100: bytes.  The arithmetic is 4(k-1) compares per
// element; the traffic is one float32 read and one write per element.  For
// the infer batch (8 x 16 x 128 x 128 elements) that is 2 x 8.4 MB, about
// 5 us at the 3.35 TB/s of an H100 SXM's data sheet (700 W limit), so in
// practice one launch costs more than the work.  The design therefore
// keeps the eroded intermediate out of device memory, as the TPU kernel
// kept it in VMEM: a block stages its plane (or tile) in shared memory
// once, runs all four passes there and writes the result once.  Measured
// on an H100 80GB HBM3 at its 700 W limit (PERF.md): 0.057 ms for that
// batch in the "th" plane against 0.133 ms for the plain PyTorch version.
//
// Two sizes, one kernel:
//  * a plane whose two shared-memory buffers fit in one block (the "th"
//    plane 16 x 128 = 8 KB, the "hw" plane 128 x 128 = 64 KB) is one tile;
//  * a larger plane (e.g. 512 x 512) is cut into kTile x kTile output tiles,
//    each loaded with a 2r halo on every side (r = k / 2).  The erode is
//    then right on the inner r ring around the tile, which is all the
//    dilate reads, so the result is the same function for any plane size.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py with nvcc into a shared
// library with a plain C interface; the Python wrapper is
// vfd_gan_tpu_torch/ops/morphology.py::open_planes_cuda.

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;

template <bool kMin>
__device__ __forceinline__ float pick(float a, float b) {
  return kMin ? fminf(a, b) : fmaxf(a, b);
}

// dst[i][j] = pick over src[i][j-r .. j+r], the window clipped to [0, w).
template <bool kMin>
__device__ void row_pass(const float* src, float* dst, int h, int w, int r) {
  for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
    const int i = idx / w;
    const int j = idx - i * w;
    const int lo = max(j - r, 0);
    const int hi = min(j + r, w - 1);
    const float* row = src + i * w;
    float acc = row[lo];
    for (int c = lo + 1; c <= hi; ++c) acc = pick<kMin>(acc, row[c]);
    dst[idx] = acc;
  }
}

// dst[i][j] = pick over src[i-r .. i+r][j], the window clipped to [0, h).
template <bool kMin>
__device__ void col_pass(const float* src, float* dst, int h, int w, int r) {
  for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
    const int i = idx / w;
    const int j = idx - i * w;
    const int lo = max(i - r, 0);
    const int hi = min(i + r, h - 1);
    float acc = src[lo * w + j];
    for (int c = lo + 1; c <= hi; ++c) acc = pick<kMin>(acc, src[c * w + j]);
    dst[idx] = acc;
  }
}

// grid = (plane, tile row, tile column).  Shared memory holds two buffers
// of the block's region: the tile plus a 2r halo, clipped to the plane.
__global__ void __launch_bounds__(kThreads)
open_kernel(const float* __restrict__ x, float* __restrict__ out,
            int p, int q, int r, int tile_h, int tile_w) {
  extern __shared__ float smem[];
  const long long base = static_cast<long long>(blockIdx.x) * p * q;
  const int y0 = blockIdx.y * tile_h;
  const int x0 = blockIdx.z * tile_w;
  const int ry0 = max(y0 - 2 * r, 0);
  const int rx0 = max(x0 - 2 * r, 0);
  const int h = min(y0 + tile_h + 2 * r, p) - ry0;
  const int w = min(x0 + tile_w + 2 * r, q) - rx0;
  float* a = smem;
  float* b = smem + h * w;

  const float* src = x + base;
  for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
    const int i = idx / w;
    const int j = idx - i * w;
    a[idx] = src[(ry0 + i) * q + rx0 + j];
  }
  __syncthreads();
  row_pass<true>(a, b, h, w, r);
  __syncthreads();
  col_pass<true>(b, a, h, w, r);   // a = eroded region
  __syncthreads();
  row_pass<false>(a, b, h, w, r);
  __syncthreads();

  // Last pass: the column max, for the tile's own elements only, straight
  // to device memory.
  const int th = min(tile_h, p - y0);
  const int tw = min(tile_w, q - x0);
  float* dst = out + base;
  for (int idx = threadIdx.x; idx < th * tw; idx += blockDim.x) {
    const int i = idx / tw;
    const int j = idx - i * tw;
    const int li = y0 + i - ry0;
    const int lj = x0 + j - rx0;
    const int lo = max(li - r, 0);
    const int hi = min(li + r, h - 1);
    float acc = b[lo * w + lj];
    for (int c = lo + 1; c <= hi; ++c) acc = fmaxf(acc, b[c * w + lj]);
    dst[(y0 + i) * q + x0 + j] = acc;
  }
}

vfd::SmemOptin g_optin;

}  // namespace

// Opening of n contiguous float32 planes of p x q with a k x k square
// (k odd).  Launches on `stream` and does not synchronise.  Returns a
// cudaError_t: the launch's own (cudaGetLastError) or the reason it was
// not made.
extern "C" int vfd_morphology_open_f32(const float* x, float* out,
                                       long long n, int p, int q, int k,
                                       void* stream) {
  if (n <= 0 || p <= 0 || q <= 0 || k < 1 || k % 2 == 0 || n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int r = k / 2;
  // the device's opt-in limit, queried and granted to the kernel once per
  // device (launch_common.cuh), not on every call
  int smem_limit = 0;
  const cudaError_t err = g_optin.limit(open_kernel, &smem_limit);
  if (err != cudaSuccess) return err;

  int tile_h = p;
  int tile_w = q;
  if (2LL * p * q * static_cast<long long>(sizeof(float)) > smem_limit) {
    tile_h = kTile;
    tile_w = kTile;
  }
  const long long rh = tile_h + 4LL * r < p ? tile_h + 4LL * r : p;
  const long long rw = tile_w + 4LL * r < q ? tile_w + 4LL * r : q;
  const long long smem = 2 * rh * rw * static_cast<long long>(sizeof(float));
  if (smem > smem_limit) return cudaErrorInvalidValue;   // k too large
  const long long tiles_y = (p + tile_h - 1) / tile_h;
  const long long tiles_x = (q + tile_w - 1) / tile_w;
  if (tiles_y > 65535 || tiles_x > 65535) return cudaErrorInvalidValue;

  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(tiles_y),
                  static_cast<unsigned>(tiles_x));
  open_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                static_cast<cudaStream_t>(stream)>>>(x, out, p, q, r,
                                                     tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}
