// Bilinear warp of channel-planar float32 fields by a flow field.
//
// Replaces vfd_gan_tpu/ops/pallas/warp.py::_warp_kernel_v5 (and its
// formulations _warp_kernel, _v3, _v4): out[n, c, y, x] = fields[n, c]
// sampled bilinearly at (x + flow[n, 0, y, x], y + flow[n, 1, y, x]), the
// sample point clamped to the image.  The TPU has no per-lane gather, so
// its kernel rewrote the sample as one-hot matmuls over a band of rows and
// clamped |fy| to that band; a GPU thread gathers directly, so this kernel
// is the unclamped XLA-body function (vfd_gan_tpu/ops/flow.py:172-190),
// in float32.
//
// What bounds it on an H100: bytes and gather latency.  Per output pixel a
// thread reads 2 flow values and 4 x C field values, and writes C values:
// at the train step's 64^2 level (240 fields, C = 5) about 4 MB of output
// and 4 MB of reads that mostly hit L1/L2, since a smooth flow keeps the
// four neighbours of adjacent threads adjacent.  One thread per pixel,
// consecutive threads on consecutive x, so the flow reads and the output
// writes are coalesced; the channel loop reuses the four indices.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/warp.py::bilinear_warp_cuda.

#include <cuda_runtime.h>

#include "flow_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ fields, const float* __restrict__ flow,
            float* __restrict__ out, long long n, int c, int h, int w) {
  const long long hw = static_cast<long long>(h) * w;
  const long long total = n * hw;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long f = idx / hw;
    const long long pix = idx - f * hw;
    const int y = static_cast<int>(pix / w);
    const int x = static_cast<int>(pix - static_cast<long long>(y) * w);
    const float* fl = flow + f * 2 * hw;
    const vfd::BilinearTaps taps =
        vfd::bilinear_taps(fl[pix], fl[hw + pix], y, x, h, w);
    const float* src = fields + f * c * hw;
    float* dst = out + f * c * hw;
    for (int ch = 0; ch < c; ++ch)
      dst[ch * hw + pix] = vfd::bilinear(src + ch * hw, taps);
  }
}

}  // namespace

// Warp n fields of c contiguous float32 planes h x w by the (n, 2, h, w)
// flow into `out` (n, c, h, w).  Launches on `stream`, does not
// synchronise, returns a cudaError_t.
extern "C" int vfd_flow_warp_f32(const float* fields, const float* flow,
                                 float* out, long long n, int c, int h, int w,
                                 void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const long long total = n * h * static_cast<long long>(w);
  long long blocks = (total + kThreads - 1) / kThreads;
  // a grid-stride loop past 132 SMs x 16 blocks: enough to fill the card
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  warp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(fields, flow, out, n, c,
                                                     h, w);
  return static_cast<int>(cudaGetLastError());
}
