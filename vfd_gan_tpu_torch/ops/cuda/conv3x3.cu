// 3x3, stride-1, SAME convolution of channel-last float32 frames, as an
// implicit GEMM on the tensor cores with a float32-faithful 3xTF32 split.
//
// Replaces vfd_gan_tpu/ops/pallas/spatial_conv.py::_conv_kernel: x (N, H,
// W, Cin) by w (3, 3, Cin, Cout) -> (N, H, W, Cout), zero padding of one
// pixel, float32 accumulation.  The TPU kernel ran it as nine
// (H*W, Cin) @ (Cin, Cout) MXU dots over W-shifted views; the backward
// reuses it for dx (flipped, in/out-transposed weights), so this kernel
// serves the forward and dx of vfd_gan_tpu_torch/ops/spatial_conv.py.
//
// What bounds it on an H100.  At the ConvLSTM's widths (Cin 3-64, Cout
// 12-64) the float32 pipes (67 TFLOP/s) would bound every shape but Cin =
// 3, whose 64-channel output write bounds it.  So the products go to the
// tensor cores, and each output byte is written once in 16-byte stores.
// There the bound is the larger of the bytes over the memory's rate and
// three tf32 passes over 495 TFLOP/s, which are about equal at these
// widths.  As built, a block's time is its copies and stores plus its
// arithmetic, one after the other (the two blocks of an SM run in step),
// and mma.sync does not reach the tensor cores' peak.  Overlapping the two
// parts is the first thing left to gain.
//
// The design.
// * One block of 8 warps computes an 8 x 32 pixel tile of one frame for
//   ALL output channels (64 per block; wider convs take grid.y slices).
//   Its 10 x 34 halo tile is staged once in shared memory, pixel-major
//   with the channels fastest, together with the launch's weights, by
//   asynchronous copies (cp.async, 16 bytes each for the tile when Cin is
//   a multiple of 4) that are all in flight at once; in chunks of input
//   channels when tile and weights do not fit twice on an SM.  Channels
//   are padded to 8 with zeros in shared memory only.
// * M = 16 consecutive pixels of a row, N = 8 output channels, K = 8
//   input channels of one tap: mma.sync.m16n8k8 (tf32 in, f32 out).  A
//   warp owns one row of the tile: two M tiles by every N tile (64
//   accumulator registers at Cout 64).  mma.sync was taken over wgmma:
//   its fragments come from ordinary shared-memory loads, so the halo
//   tile needs no swizzled K-major copy per tap, and at three passes the
//   tensor-core term (FLOP x 3 / 495 TFLOP/s) is under the byte term
//   already, so wgmma's higher rate would decide nothing.  Row strides of
//   4 (mod 8) floats for pixels and 8 (mod 16) for weight rows keep the
//   fragment loads free of bank conflicts.
// * float32-faithful: a = a_hi + a_lo with a_hi = a rounded to tf32 and
//   a_lo = a - a_hi (exact; the tensor cores read it cut to tf32, which
//   keeps a to 2^-21), the same for b, and a*b ~ a_lo*b_hi + a_hi*b_lo +
//   a_hi*b_hi (small terms first); the dropped a_lo*b_lo is ~2^-22
//   relative.  The tensor cores sum only the three terms of one K
//   step; the running sum is kept by float32 adds (round to nearest),
//   because the tensor cores truncate what they return.  Operands are
//   split as the fragments are read.  A non-finite input gives a
//   non-finite output (inf - inf in the split makes an inf a NaN; so does
//   a finite value within 2^-12 of the largest float32, which rounds up
//   to inf).
// * Cin <= 4 (the ConvLSTM's first input half, K = 27): the taps are
//   packed into K, k = tap * Cin + c, padded to 8 (four K steps instead of
//   nine), over a halo tile stored row-contiguous.
// * The epilogue pairs N tiles so that a thread holds four consecutive
//   channels of a pixel (the weights' columns are permuted in shared
//   memory to match): one float4 store each, 64 contiguous bytes per
//   pixel and instruction.
// * dx: `flip` makes the staging read w[2-ky][2-kx][co][ci], so the
//   backward passes the forward's weights as they are.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/spatial_conv.py::conv3x3_cuda.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "launch_common.cuh"

namespace {

constexpr int kWarps = 8;                 // one output row of the tile each
constexpr int kThreads = kWarps * 32;
constexpr int kTileH = kWarps;
constexpr int kTileW = 32;                // two 16-pixel M tiles per warp
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPix = kHaloH * kHaloW;
constexpr int kMaxNT = 8;                 // N tiles (of 8 channels) per block
constexpr int kPackedCin = 4;             // Cin up to here packs the taps

struct ConvArgs {
  const float* x;
  const float* w;
  float* out;
  int h, wd, cin, cout;
  int tiles_x;
  int kc;        // input channels per staged chunk, a multiple of 8
  int ws;        // floats per weight row in shared memory, 8 mod 16
  int flip;      // dx: read the weights flipped and in/out-transposed
  int vec_in;    // x can be read as float4
  int vec_out;   // out can be written as float4
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Floats per weight row: at least `cols`, and 8 mod 16, so that the four
// K rows and eight columns of a B fragment fall in 32 different banks.
__host__ __device__ inline int weight_stride(int cols) {
  return round_up(cols - 8, 16) + 8;
}

// v = hi + lo exactly: hi is v rounded to tf32 (to nearest, ties away
// from zero, as cvt.rna.tf32.f32 rounds: half of the last kept bit added
// to the bit pattern, the 13 dropped bits cleared), lo the float32 rest,
// of which the tensor cores read the upper 19 bits.  Two integer
// operations and one subtraction: the conversion instruction runs at a
// fraction of their rate, and two of them per operand set the kernel's
// pace when they were used.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a (16 x 8, row-major) * b (8 x 8, column-major), tf32 operands.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b: the first product of a sum, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Asynchronous copies of 4 and 16 bytes from device to shared memory;
// zeros instead when `real` is false (`src` is then not read, but stays
// a valid address).  Completed by stage_wait().
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool real) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(real ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void stage16(float* dst, const float* src,
                                        bool real) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// Where output channel `co` of a block (co = 16 p + 4 q + s) sits among the
// weight columns: N tile 2 p + s / 2, column 2 q + s % 2.  A thread's
// accumulator columns (2 t, 2 t + 1) of the N tiles 2 p and 2 p + 1 are
// then the channels 16 p + 4 t .. + 3.
__device__ __forceinline__ int column_of(int co) {
  return (co & ~15) + ((co & 2) << 2) + ((co >> 1) & 6) + (co & 1);
}

// The halo tile of input channels [c0, c0 + kcur) as tile[pixel][channel]
// with `cs` floats per pixel; zero outside the frame and past Cin.  V
// floats per load.  The (pixel, channel group) of a thread advances by
// kThreads groups per turn without a division.
template <int V>
__device__ __forceinline__ void stage_halo(const ConvArgs& a,
                                           const float* __restrict__ xf,
                                           float* tile, int y0, int x0, int c0,
                                           int kcur, int cs) {
  const int groups = kcur / V;
  int p = threadIdx.x / groups;
  int q = threadIdx.x - p * groups;
  const int dp = kThreads / groups;
  const int dq = kThreads - dp * groups;
  while (p < kHaloPix) {
    const int hy = p / kHaloW;
    const int hx = p - hy * kHaloW;
    const int gy = y0 - 1 + hy;
    const int gx = x0 - 1 + hx;
    const int c = c0 + q * V;
    float* dst = tile + p * cs + q * V;
    const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd &&
                        c < a.cin;
    const float* src =
        inside ? xf + (static_cast<long long>(gy) * a.wd + gx) * a.cin + c
               : xf;
    if constexpr (V == 4)
      stage16(dst, src, inside);
    else
      stage4(dst, src, inside);
    p += dp;
    q += dq;
    if (q >= groups) {
      q -= groups;
      ++p;
    }
  }
}

// The halo tile of a Cin <= 4 frame, row-contiguous: tile[hy][hx * Cin + c]
// with rs = kHaloW * Cin floats per row.
__device__ __forceinline__ void stage_halo_packed(const ConvArgs& a,
                                                  const float* __restrict__ xf,
                                                  float* tile, int y0, int x0,
                                                  int rs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_floats = a.wd * a.cin;
  for (int hy = warp; hy < kHaloH; hy += kWarps) {
    const int gy = y0 - 1 + hy;
    const bool row_in = gy >= 0 && gy < a.h;
    const float* src = xf + static_cast<long long>(gy) * row_floats;
    for (int e = lane; e < rs; e += 32) {
      const int ge = (x0 - 1) * a.cin + e;
      const bool inside = row_in && ge >= 0 && ge < row_floats;
      stage4(tile + hy * rs + e, inside ? src + ge : xf, inside);
    }
  }
}

// Where the weight of input channel ci, tap, output channel co of this
// launch lies.
__device__ __forceinline__ const float* weight_at(const ConvArgs& a, int tap,
                                                  int ci, int co) {
  if (a.flip)
    return a.w + (static_cast<long long>(8 - tap) * a.cout + co) * a.cin + ci;
  return a.w + (static_cast<long long>(tap) * a.cin + ci) * a.cout + co;
}

// Weight rows [tap][c0 .. c0 + kcur) by the block's NT * 8 permuted columns,
// zero past Cin and Cout.  Lanes run along the axis that is contiguous in
// device memory: co forward, ci for dx.
template <int NT>
__device__ __forceinline__ void stage_weights(const ConvArgs& a, float* wsm,
                                              int co0, int c0, int kcur) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int tap = 0; tap < 9; ++tap) {
    float* rows = wsm + tap * kcur * a.ws;
    if (!a.flip) {
      for (int c = warp; c < kcur; c += kWarps)
        for (int col = lane; col < NT * 8; col += 32) {
          const bool real = c0 + c < a.cin && co0 + col < a.cout;
          stage4(rows + c * a.ws + column_of(col),
                 real ? weight_at(a, tap, c0 + c, co0 + col) : a.w, real);
        }
    } else {
      for (int col = warp; col < NT * 8; col += kWarps)
        for (int c = lane; c < kcur; c += 32) {
          const bool real = c0 + c < a.cin && co0 + col < a.cout;
          stage4(rows + c * a.ws + column_of(col),
                 real ? weight_at(a, tap, c0 + c, co0 + col) : a.w, real);
        }
    }
  }
}

// Weight rows k = tap * Cin + c of a Cin <= 4 launch, zero from 9 Cin to kp.
template <int NT>
__device__ __forceinline__ void stage_weights_packed(const ConvArgs& a,
                                                     float* wsm, int co0,
                                                     int kp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = warp; k < kp; k += kWarps) {
    const int tap = k / a.cin;
    const int c = k - tap * a.cin;
    for (int col = lane; col < NT * 8; col += 32) {
      const bool real = tap < 9 && co0 + col < a.cout;
      stage4(wsm + k * a.ws + column_of(col),
             real ? weight_at(a, tap, c, co0 + col) : a.w, real);
    }
  }
}

// One K step of 8 for a warp: both M tiles' A fragments (already split)
// against every N tile; `b` points at this thread's (row t, column g) of
// the step's first weight row.
template <int NT>
__device__ __forceinline__ void mma_step(float (&acc)[2][NT][4],
                                         const uint32_t (&ahi)[2][4],
                                         const uint32_t (&alo)[2][4],
                                         const float* b, int ws) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t bhi[2][2], blo[2][2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      split_tf32(b[(j + jj) * 8], bhi[jj][0], blo[jj][0]);           // k = t
      split_tf32(b[4 * ws + (j + jj) * 8], bhi[jj][1], blo[jj][1]);  // t + 4
    }
    // The three terms of this K step, small ones first, summed on the
    // tensor cores into a partial sum of their own, which the float32
    // pipes then add to the running sum: the tensor cores truncate each
    // sum they return, and over a whole K of hundreds that bias (about
    // half an ulp of the running sum per mma) would be several times the
    // rounding error of a float32 convolution.  The four partial sums of
    // a term are independent, so consecutive mma never wait on each other.
    float part[2][2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma_tf32_first(part[jj][m], alo[m], bhi[jj][0], bhi[jj][1]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma_tf32(part[jj][m], ahi[m], blo[jj][0], blo[jj][1]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma_tf32(part[jj][m], ahi[m], bhi[jj][0], bhi[jj][1]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j + jj][i] += part[jj][m][i];
  }
}

// grid = (spatial tiles, slices of kMaxNT * 8 output channels, frames).
// NT: N tiles per block (even).  PACKED: the Cin <= 4 form.
template <int NT, bool PACKED>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;       // fragment row (pixel) / B column
  const int t = lane & 3;        // fragment K index / accumulator column pair
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * (kMaxNT * 8);
  const int tile_y = blockIdx.x / a.tiles_x;
  const int y0 = tile_y * kTileH;
  const int x0 = (blockIdx.x - tile_y * a.tiles_x) * kTileW;
  const float* xf = a.x + static_cast<long long>(n) * a.h * a.wd * a.cin;

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;

  if constexpr (PACKED) {
    const int rs = kHaloW * a.cin;
    const int k_real = 9 * a.cin;
    const int kp = round_up(k_real, 8);
    float* tile = smem;
    float* wsm = smem + round_up(kHaloH * rs, 4);
    stage_halo_packed(a, xf, tile, y0, x0, rs);
    stage_weights_packed<NT>(a, wsm, co0, kp);
    stage_wait();

    // this thread's pixels: row `warp`, columns g and g + 8 of each M tile
    const float* apix = tile + warp * rs + g * a.cin;
    for (int k0 = 0; k0 < kp; k0 += 8) {
      int off[2];
      bool real[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + t + 4 * i;
        const int tap = k / a.cin;
        const int ky = tap / 3;
        real[i] = k < k_real;
        off[i] = real[i] ? ky * rs + (tap - 3 * ky) * a.cin + (k - tap * a.cin)
                         : 0;
      }
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* p = apix + m * 16 * a.cin;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float lo_row = real[i] ? p[off[i]] : 0.0f;
          const float hi_row = real[i] ? p[8 * a.cin + off[i]] : 0.0f;
          split_tf32(lo_row, ahi[m][2 * i], alo[m][2 * i]);
          split_tf32(hi_row, ahi[m][2 * i + 1], alo[m][2 * i + 1]);
        }
      }
      mma_step<NT>(acc, ahi, alo, wsm + (k0 + t) * a.ws + g, a.ws);
    }
  } else {
    const int cs = a.kc + 4;
    const int cinp = round_up(a.cin, 8);
    float* tile = smem;
    float* wsm = smem + kHaloPix * cs;
    for (int c0 = 0; c0 < cinp; c0 += a.kc) {
      const int kcur = min(a.kc, cinp - c0);
      if (c0 > 0) __syncthreads();     // the last chunk's reads are done
      if (a.vec_in)
        stage_halo<4>(a, xf, tile, y0, x0, c0, kcur, cs);
      else
        stage_halo<1>(a, xf, tile, y0, x0, c0, kcur, cs);
      stage_weights<NT>(a, wsm, co0, c0, kcur);
      stage_wait();

      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3;
        const int kx = tap - 3 * ky;
        // (pixel g of M tile 0 under this tap, channel t)
        const float* apix = tile + ((warp + ky) * kHaloW + kx + g) * cs + t;
        const float* brow = wsm + (tap * kcur + t) * a.ws + g;
        for (int c8 = 0; c8 < kcur; c8 += 8) {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* p = apix + m * 16 * cs + c8;
            split_tf32(p[0], ahi[m][0], alo[m][0]);               // (g, t)
            split_tf32(p[8 * cs], ahi[m][1], alo[m][1]);          // (g+8, t)
            split_tf32(p[4], ahi[m][2], alo[m][2]);               // (g, t+4)
            split_tf32(p[8 * cs + 4], ahi[m][3], alo[m][3]);      // (g+8, t+4)
          }
          mma_step<NT>(acc, ahi, alo, brow + c8 * a.ws, a.ws);
        }
      }
    }
  }

  // accumulator i of an N tile: row g + 8 (i / 2), column 2 t + i % 2
  const int oy = y0 + warp;
  if (oy >= a.h) return;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + m * 16 + g + 8 * half;
      if (ox >= a.wd) continue;
      float* dst = a.out +
          ((static_cast<long long>(n) * a.h + oy) * a.wd + ox) * a.cout;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int co = co0 + 8 * j + 4 * t;
        const float v[4] = {acc[m][j][2 * half], acc[m][j][2 * half + 1],
                            acc[m][j + 1][2 * half],
                            acc[m][j + 1][2 * half + 1]};
        if (a.vec_out && co + 3 < a.cout) {
          *reinterpret_cast<float4*>(dst + co) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (co + i < a.cout) dst[co + i] = v[i];
        }
      }
    }
  }
}

size_t smem_bytes(bool packed, int cin, int kc, int ws) {
  const size_t floats =
      packed ? round_up(kHaloH * kHaloW * cin, 4) +
                   static_cast<size_t>(round_up(9 * cin, 8)) * ws
             : static_cast<size_t>(kHaloPix) * (kc + 4) +
                   static_cast<size_t>(9) * kc * ws;
  return floats * sizeof(float);
}

template <int NT, bool PACKED>
cudaError_t launch(ConvArgs a, long long n, cudaStream_t stream) {
  static vfd::SmemOptin optin;     // one per kernel instantiation
  int limit = 0;
  cudaError_t err = optin.limit(conv3x3_kernel<NT, PACKED>, &limit, true);
  if (err != cudaSuccess) return err;

  a.ws = weight_stride(NT * 8);
  a.kc = round_up(a.cin, 8);
  if (!PACKED) {
    // the largest chunk of input channels that lets two blocks share an
    // SM (each block also takes 1 KB of the SM's own), then even chunks
    const size_t budget = static_cast<size_t>(limit) / 2 - 1024;
    const int cinp = a.kc;
    while (a.kc > 8 && smem_bytes(false, a.cin, a.kc, a.ws) > budget)
      a.kc -= 8;
    const int chunks = (cinp + a.kc - 1) / a.kc;
    a.kc = round_up((cinp + chunks - 1) / chunks, 8);
  }
  const size_t smem = smem_bytes(PACKED, a.cin, a.kc, a.ws);
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;

  const long long tiles_x = (a.wd + kTileW - 1) / kTileW;
  const long long tiles = tiles_x * ((a.h + kTileH - 1) / kTileH);
  const long long slices = (a.cout + kMaxNT * 8 - 1) / (kMaxNT * 8);
  if (tiles > 0x7fffffffLL || slices > 65535) return cudaErrorInvalidValue;
  a.tiles_x = static_cast<int>(tiles_x);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(slices),
                  static_cast<unsigned>(n));
  conv3x3_kernel<NT, PACKED><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_nt(const ConvArgs& a, long long n, cudaStream_t stream) {
  // N tiles per block: Cout padded to 16 (the epilogue pairs them), at
  // most kMaxNT
  const int nt = std::min(round_up(a.cout, 16) / 8, kMaxNT);
  switch (nt) {
    case 2: return launch<2, PACKED>(a, n, stream);
    case 4: return launch<4, PACKED>(a, n, stream);
    case 6: return launch<6, PACKED>(a, n, stream);
    default: return launch<8, PACKED>(a, n, stream);
  }
}

}  // namespace

// 3x3 stride-1 SAME convolution of n contiguous float32 frames (n, h, w,
// cin) into out (n, h, w, cout).  The contiguous weights are (3, 3, cin,
// cout), or with flip != 0 (the input gradient of a convolution by w) w
// (3, 3, cout, cin), read as w[2 - ky][2 - kx][co][ci].  Launches on
// `stream`, does not synchronise, returns a cudaError_t.
extern "C" int vfd_conv3x3_f32(const float* x, const float* w, float* out,
                               long long n, int h, int wd, int cin, int cout,
                               int flip, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0)
    return cudaErrorInvalidValue;
  ConvArgs a = {};
  a.x = x;
  a.w = w;
  a.out = out;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.flip = flip != 0;
  a.vec_in = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_out = cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cin <= kPackedCin ? launch_nt<true>(a, n, s)
                                            : launch_nt<false>(a, n, s));
}
