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
// What bounds it on an H100: bytes.  At the train step (B 8, T 16, S 140,
// isize 128, C 3 + 3 + 1) it reads up to 17.6 MB of bytes and writes 58.7
// MB of float32, ~23 us at the 3.35 TB/s of an H100 SXM's data sheet: the
// stores are three quarters of the traffic, the gather's scattered byte
// reads are latency.  The design serves both:
//  * grid = (256-pixel chunks of a frame, groups of kFrames frames, B): a
//    thread owns one output pixel of kFrames frames.  It reads its two
//    coordinates once and then starts every byte load of its frames and
//    streams (kFrames x (3 + 3 + 1), unrolled) before it uses any: the
//    loads of a thread are independent and all in flight together.
//  * the scaled values go to a tile in shared memory laid out as the
//    output is, [frame][stream][pixel][channel], and leave it as 16-byte
//    stores: a chunk of 256 pixels x 3 channels is 192 float4 that are
//    contiguous in the output, where a thread's own three values are 12
//    bytes at a 12-byte stride.  A chunk that is not 16-byte aligned (an
//    odd isize) leaves as 4-byte stores, still contiguous.  Streaming
//    stores (st.global.cs) were measured and are 5% slower.
//  * channel counts other than 3 + 3 + 1 take the same body with runtime
//    counts, one frame per block.
// Times on the card: PERF.md section 6, row 5.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/augment.py::augment_gather_cuda.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_common.cuh"

// Timing-only build options (vfd_gan_tpu_torch/tools/kernel_variants.py):
// the frames a block of the 3 + 3 + 1 kernel takes, and streaming stores
// in place of the plain ones.
#ifndef VFD_AUGMENT_FRAMES
#define VFD_AUGMENT_FRAMES 4
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = VFD_AUGMENT_FRAMES;

struct GatherArgs {
  const uint8_t* src[3];      // data, real, mask
  float* dst[3];
  const float* src_x;
  const float* src_y;
  const float* video_table;
  const float* mask_table;
  int t, s, isize;
  int c[3];
};

__device__ __forceinline__ void store4(float4* p, float4 v) {
#ifdef VFD_AUGMENT_STREAM_STORES
  __stcs(p, v);
#else
  *p = v;
#endif
}

template <int C>
__device__ __forceinline__ void load_pixel(const uint8_t* src, long long px,
                                           bool live, uint8_t* v) {
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = live ? src[px * C + ch] : uint8_t{0};
}

template <int C>
__device__ __forceinline__ void stage_pixel(const uint8_t* v,
                                            const float* table, float* dst) {
#pragma unroll
  for (int ch = 0; ch < C; ++ch) dst[ch] = table[v[ch]];
}

// C0, C1, C2: the streams' channel counts, or 0 for runtime counts.  F:
// frames per block.  Dynamic shared memory: the two tables, then F tiles of
// kThreads x (c0 + c1 + c2) floats.
template <int C0, int C1, int C2, int F>
__global__ void __launch_bounds__(kThreads)
augment_gather_kernel(const GatherArgs a) {
  extern __shared__ float4 smem4[];
  float* tables = reinterpret_cast<float*>(smem4);
  float* stage = tables + 512;
  const int tid = threadIdx.x;
  tables[tid] = a.video_table[tid];
  tables[256 + tid] = a.mask_table[tid];

  const int c[3] = {C0 > 0 ? C0 : a.c[0], C1 > 0 ? C1 : a.c[1],
                    C2 > 0 ? C2 : a.c[2]};
  const int csum = c[0] + c[1] + c[2];
  const long long npix = static_cast<long long>(a.isize) * a.isize;
  const long long pix0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int cnt = static_cast<int>(min(static_cast<long long>(kThreads),
                                       npix - pix0));
  const int f0 = blockIdx.y * F;
  const long long b = blockIdx.z;
  const long long sframe = static_cast<long long>(a.s) * a.s;

  bool valid = false;
  long long src_off = 0;
  if (tid < cnt) {
    const float fx = a.src_x[b * npix + pix0 + tid];
    const float fy = a.src_y[b * npix + pix0 + tid];
    // floored integral floats: the conversion is exact where it matters
    valid = fx >= 0.0f && fx < static_cast<float>(a.s) && fy >= 0.0f &&
            fy < static_cast<float>(a.s);
    if (valid)
      src_off = static_cast<long long>(fy) * a.s + static_cast<long long>(fx);
  }
  __syncthreads();                                 // the tables

  if constexpr (C0 > 0) {
    // every load first, then the table reads and the tile
    constexpr int kSum = C0 + C1 + C2;
    uint8_t v[F][kSum];
#pragma unroll
    for (int g = 0; g < F; ++g) {
      const bool live = valid && f0 + g < a.t;
      const long long px = (b * a.t + f0 + g) * sframe + src_off;
      load_pixel<C0>(a.src[0], px, live, v[g]);
      load_pixel<C1>(a.src[1], px, live, v[g] + C0);
      load_pixel<C2>(a.src[2], px, live, v[g] + C0 + C1);
    }
    if (tid < cnt) {
#pragma unroll
      for (int g = 0; g < F; ++g) {
        float* tile = stage + g * kThreads * kSum;
        stage_pixel<C0>(v[g], tables, tile + tid * C0);
        stage_pixel<C1>(v[g] + C0, tables, tile + kThreads * C0 + tid * C1);
        stage_pixel<C2>(v[g] + C0 + C1, tables + 256,
                        tile + kThreads * (C0 + C1) + tid * C2);
      }
    }
  } else if (tid < cnt) {
    for (int g = 0; g < F && f0 + g < a.t; ++g) {
      const long long px = (b * a.t + f0 + g) * sframe + src_off;
      float* tile = stage + g * kThreads * csum;
      for (int k = 0; k < 3; ++k) {
        const float* table = tables + (k == 2 ? 256 : 0);
        const uint8_t* s = a.src[k] + px * c[k];
        for (int ch = 0; ch < c[k]; ++ch)
          tile[tid * c[k] + ch] = table[valid ? s[ch] : 0];
        tile += kThreads * c[k];
      }
    }
  }
  __syncthreads();                                 // the tile

  for (int g = 0; g < F && f0 + g < a.t; ++g) {
    const long long px = (b * a.t + f0 + g) * npix + pix0;
    const float* tile = stage + g * kThreads * csum;
    for (int k = 0; k < 3; ++k) {
      const int n = cnt * c[k];
      float* dst = a.dst[k] + px * c[k];
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (n & 3) == 0) {
        const float4* from = reinterpret_cast<const float4*>(tile);
        float4* to = reinterpret_cast<float4*>(dst);
        for (int i = tid; i < n / 4; i += kThreads) store4(to + i, from[i]);
      } else {
        for (int i = tid; i < n; i += kThreads) dst[i] = tile[i];
      }
      tile += kThreads * c[k];
    }
  }
}

vfd::SmemOptin g_optin_fixed;
vfd::SmemOptin g_optin_any;

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
  const long long chunks = (npix + kThreads - 1) / kThreads;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  GatherArgs a;
  a.src[0] = static_cast<const uint8_t*>(data);
  a.src[1] = static_cast<const uint8_t*>(real);
  a.src[2] = static_cast<const uint8_t*>(mask);
  a.dst[0] = out_data;
  a.dst[1] = out_real;
  a.dst[2] = out_mask;
  a.src_x = src_x;
  a.src_y = src_y;
  a.video_table = video_table;
  a.mask_table = mask_table;
  a.t = t;
  a.s = s;
  a.isize = isize;
  a.c[0] = cd;
  a.c[1] = cr;
  a.c[2] = cm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tile = static_cast<long long>(kThreads) * (cd + cr + cm) *
                         static_cast<long long>(sizeof(float));
  const long long tables = 2 * 256 * static_cast<long long>(sizeof(float));
  // beyond 48 KB a block needs the opt-in, granted once per device
  int smem_limit = 0;
  if (cd == 3 && cr == 3 && cm == 1) {
    const long long groups = (t + kFrames - 1) / kFrames;
    if (groups > 65535) return cudaErrorInvalidValue;
    const cudaError_t err = g_optin_fixed.limit(
        augment_gather_kernel<3, 3, 1, kFrames>, &smem_limit);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(chunks),
                    static_cast<unsigned>(groups), static_cast<unsigned>(b));
    augment_gather_kernel<3, 3, 1, kFrames>
        <<<grid, kThreads, static_cast<size_t>(tables + kFrames * tile),
           st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (t > 65535) return cudaErrorInvalidValue;
  const long long smem = tables + tile;
  const cudaError_t err =
      g_optin_any.limit(augment_gather_kernel<0, 0, 0, 1>, &smem_limit);
  if (err != cudaSuccess) return err;
  if (smem > smem_limit) return cudaErrorInvalidValue;  // too many channels
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(t),
                  static_cast<unsigned>(b));
  augment_gather_kernel<0, 0, 0, 1>
      <<<grid, kThreads, static_cast<size_t>(smem), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
