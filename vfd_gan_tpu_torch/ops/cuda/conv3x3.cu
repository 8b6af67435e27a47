// 3x3, stride-1, SAME convolution of channel-last float32 frames.
//
// Replaces vfd_gan_tpu/ops/pallas/spatial_conv.py::_conv_kernel: x (N, H,
// W, Cin) by w (3, 3, Cin, Cout) -> (N, H, W, Cout), zero padding of one
// pixel, float32 accumulation.  The TPU kernel ran it as nine
// (H*W, Cin) @ (Cin, Cout) MXU dots over W-shifted views; the backward
// reuses it for dx (flipped, in/out-transposed weights), so this kernel
// serves the forward and dx of vfd_gan_tpu_torch/ops/spatial_conv.py.
//
// What bounds it on an H100: at the ConvLSTM's widths (Cin 3-64, Cout
// 3-64) neither bytes nor the tensor cores; this simple form runs on the
// float32 pipes and is bound by shared-memory traffic.  One block of 256
// threads computes a 16 x 16 output tile of one frame for a slice of
// kCoutTile output channels: per chunk of kCinChunk input channels it
// stages the 18 x 18 halo tile (channel-major, so a warp's reads of one
// channel hit consecutive banks) and the 3 x 3 x chunk x slice weights in
// shared memory; each thread keeps its pixel's kCoutTile sums in registers
// and reads the weights as float4 broadcasts.  Products are summed with
// __fmaf_rn (the library builds with --fmad=false, which the intrinsic
// overrides), in the order chunk -> tap row -> tap column -> channel.
// wgmma, TMA and tensor cores are left to a later redesign.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/spatial_conv.py::conv3x3_cuda.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kHalo = kTile + 2;
constexpr int kThreads = kTile * kTile;
constexpr int kCinChunk = 16;
constexpr int kCoutTile = 16;

// grid = (spatial tiles, Cout slices, frames).
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int h, int wd, int cin, int cout,
               int tiles_x) {
  __shared__ float tile[kCinChunk * kHalo * kHalo];
  __shared__ __align__(16) float wsm[9 * kCinChunk * kCoutTile];

  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCoutTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const float* xf = x + static_cast<long long>(n) * h * wd * cin;

  float acc[kCoutTile];
#pragma unroll
  for (int i = 0; i < kCoutTile; ++i) acc[i] = 0.0f;

  for (int c0 = 0; c0 < cin; c0 += kCinChunk) {
    const int ck = min(kCinChunk, cin - c0);
    // the halo tile of this chunk; the channel runs fastest in device
    // memory, so consecutive threads read consecutive addresses
    for (int idx = threadIdx.x; idx < kHalo * kHalo * ck; idx += kThreads) {
      const int c = idx % ck;
      const int p = idx / ck;
      const int gy = y0 - 1 + p / kHalo;
      const int gx = x0 - 1 + p % kHalo;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
        v = xf[(static_cast<long long>(gy) * wd + gx) * cin + c0 + c];
      tile[c * kHalo * kHalo + p] = v;
    }
    // weights [tap][c][co] of this chunk and slice, zero past Cout
    for (int idx = threadIdx.x; idx < 9 * ck * kCoutTile; idx += kThreads) {
      const int co = idx % kCoutTile;
      const int c = (idx / kCoutTile) % ck;
      const int tap = idx / (kCoutTile * ck);
      float v = 0.0f;
      if (co0 + co < cout)
        v = w[(static_cast<long long>(tap) * cin + c0 + c) * cout + co0 + co];
      wsm[(tap * kCinChunk + c) * kCoutTile + co] = v;
    }
    __syncthreads();

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int tap = ky * 3 + kx;
        const float* trow = tile + (ty + ky) * kHalo + tx + kx;
        for (int c = 0; c < ck; ++c) {
          const float v = trow[c * kHalo * kHalo];
          const float4* wv = reinterpret_cast<const float4*>(
              wsm + (tap * kCinChunk + c) * kCoutTile);
#pragma unroll
          for (int q = 0; q < kCoutTile / 4; ++q) {
            const float4 k4 = wv[q];
            acc[4 * q + 0] = __fmaf_rn(v, k4.x, acc[4 * q + 0]);
            acc[4 * q + 1] = __fmaf_rn(v, k4.y, acc[4 * q + 1]);
            acc[4 * q + 2] = __fmaf_rn(v, k4.z, acc[4 * q + 2]);
            acc[4 * q + 3] = __fmaf_rn(v, k4.w, acc[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = y0 + ty;
  const int ox = x0 + tx;
  if (oy >= h || ox >= wd) return;
  float* dst = out + ((static_cast<long long>(n) * h + oy) * wd + ox) * cout +
               co0;
  const int nco = min(kCoutTile, cout - co0);
#pragma unroll
  for (int i = 0; i < kCoutTile; ++i)
    if (i < nco) dst[i] = acc[i];
}

}  // namespace

// 3x3 stride-1 SAME convolution of n contiguous float32 frames (n, h, w,
// cin) by contiguous weights (3, 3, cin, cout) into out (n, h, w, cout).
// Launches on `stream`, does not synchronise, returns a cudaError_t.
extern "C" int vfd_conv3x3_f32(const float* x, const float* w, float* out,
                               long long n, int h, int wd, int cin, int cout,
                               void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0)
    return cudaErrorInvalidValue;
  const long long tiles_x = (wd + kTile - 1) / kTile;
  const long long tiles = tiles_x * ((h + kTile - 1) / kTile);
  const long long slices = (cout + kCoutTile - 1) / kCoutTile;
  if (tiles > 0x7fffffffLL || slices > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(slices),
                  static_cast<unsigned>(n));
  conv3x3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, h, wd, cin, cout, static_cast<int>(tiles_x));
  return static_cast<int>(cudaGetLastError());
}
