// Rotate + crop + flip nearest gather of a staged clip triple, with the
// uint8 -> float32 scaling fused in.
//
// Replaces vfd_gan_tpu/ops/pallas/augment.py::_augment_kernel: every output
// pixel of a clip reads its source pixel at the clip's floored source
// coordinates (src_x, src_y), the same for every frame and channel, and
// takes zero outside the S x S source.  The TPU kernel built 0/1 one-hot
// weights and ran the gather as matmuls because a TPU has no per-lane
// gather; a GPU thread loads the byte directly.
//
// Here the three channel-last uint8 streams (data, real, mask), each
// (B, T, S, S, C), are read in place (no concatenated copy) and written as
// float32 (B, T, isize, isize, C) through two 256-entry tables: the video
// table holds v / 255 * 2 - 1, the mask table v / 255, both computed by
// PyTorch on the card with the plain version's own expression, so the
// result is bit-equal to the plain gather followed by the plain scaling.
// A pixel outside the source reads entry 0 (-1 for video, 0 for the mask),
// as the plain version scales its zero fill.
//
// What bounds it on an H100: bytes, and the gather's scattered reads.  At
// the train step (B 8, T 16, S 140, isize 128, C 3 + 3 + 1) it reads up to
// 17.6 MB of bytes and writes 58.7 MB of float32, ~23 us at the 3.35 TB/s
// of an H100 SXM's data sheet.  One thread per (clip, output pixel) reads
// the pixel's two coordinates once and loops over the T frames and the
// C channels of the three streams; neighbouring threads handle neighbouring
// output pixels, so the writes of a warp are contiguous runs and the reads
// fall on nearby source rows.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/augment.py::augment_gather_cuda.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void gather_stream(
    const uint8_t* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ table, long long src_frame, long long dst_frame,
    long long src_off, long long dst_off, bool valid, int t, int c) {
  for (int f = 0; f < t; ++f) {
    const uint8_t* s = src + f * src_frame * c + src_off * c;
    float* d = dst + f * dst_frame * c + dst_off * c;
    for (int ch = 0; ch < c; ++ch) d[ch] = table[valid ? s[ch] : 0];
  }
}

// grid = (pixel blocks, B).  Stream k is (B, T, S, S, c_k) in, (B, T,
// isize, isize, c_k) out.
__global__ void __launch_bounds__(kThreads)
augment_gather_kernel(const uint8_t* __restrict__ data,
                      const uint8_t* __restrict__ real,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ src_x,
                      const float* __restrict__ src_y,
                      const float* __restrict__ video_table,
                      const float* __restrict__ mask_table,
                      float* __restrict__ out_data,
                      float* __restrict__ out_real,
                      float* __restrict__ out_mask, int t, int s, int isize,
                      int cd, int cr, int cm) {
  __shared__ float vtab[256];
  __shared__ float mtab[256];
  vtab[threadIdx.x] = video_table[threadIdx.x];
  mtab[threadIdx.x] = mask_table[threadIdx.x];
  __syncthreads();

  const long long npix = static_cast<long long>(isize) * isize;
  const long long pix = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (pix >= npix) return;
  const long long b = blockIdx.y;
  const float fx = src_x[b * npix + pix];
  const float fy = src_y[b * npix + pix];
  // floored integral floats: the conversion is exact where it matters
  const bool valid = fx >= 0.0f && fx < static_cast<float>(s) &&
                     fy >= 0.0f && fy < static_cast<float>(s);
  const long long sx = valid ? static_cast<long long>(fx) : 0;
  const long long sy = valid ? static_cast<long long>(fy) : 0;
  const long long sframe = static_cast<long long>(s) * s;
  const long long src_off = sy * s + sx;
  const long long clip_src = b * t * sframe;
  const long long clip_dst = b * t * npix;

  gather_stream(data + clip_src * cd, out_data + clip_dst * cd, vtab, sframe,
                npix, src_off, pix, valid, t, cd);
  gather_stream(real + clip_src * cr, out_real + clip_dst * cr, vtab, sframe,
                npix, src_off, pix, valid, t, cr);
  gather_stream(mask + clip_src * cm, out_mask + clip_dst * cm, mtab, sframe,
                npix, src_off, pix, valid, t, cm);
}

}  // namespace

// The gather for b clips of t frames.  All pointers are contiguous: data,
// real and mask uint8 (b, t, s, s, c*); src_x and src_y float32 (b, isize,
// isize); the tables 256 float32 each; the outputs float32 (b, t, isize,
// isize, c*).  Launches on `stream`, does not synchronise, returns a
// cudaError_t.
extern "C" int vfd_augment_gather_u8(const void* data, const void* real,
                                     const void* mask, const float* src_x,
                                     const float* src_y,
                                     const float* video_table,
                                     const float* mask_table, float* out_data,
                                     float* out_real, float* out_mask,
                                     long long b, int t, int s, int isize,
                                     int cd, int cr, int cm, void* stream) {
  if (b <= 0 || b > 65535 || t <= 0 || s <= 0 || isize <= 0 || cd <= 0 ||
      cr <= 0 || cm <= 0)
    return cudaErrorInvalidValue;
  const long long npix = static_cast<long long>(isize) * isize;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  augment_gather_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(real),
      static_cast<const uint8_t*>(mask), src_x, src_y, video_table,
      mask_table, out_data, out_real, out_mask, t, s, isize, cd, cr, cm);
  return static_cast<int>(cudaGetLastError());
}
