// 3x3, stride-1, SAME convolution of channel-last frames, as an implicit
// GEMM on the tensor cores: float32 with a float32-faithful 3xTF32 split,
// or bfloat16 in one pass.
//
// Replaces vfd_gan_tpu/ops/pallas/spatial_conv.py::_conv_kernel: x (N, H,
// W, Cin) by w (3, 3, Cin, Cout) -> (N, H, W, Cout), zero padding of one
// pixel, float32 accumulation, the result in the input's dtype.  The TPU
// kernel ran it as nine (H*W, Cin) @ (Cin, Cout) MXU dots over W-shifted
// views; the backward reuses it for dx (flipped, in/out-transposed
// weights), so this kernel serves the forward and dx of
// vfd_gan_tpu_torch/ops/spatial_conv.py.
//
// What bounds it on an H100.  At the ConvLSTM's widths (Cin 3-64, Cout
// 12-64) the float32 pipes (67 TFLOP/s) would bound every shape but Cin =
// 3, whose 64-channel output write bounds it.  So the products go to the
// tensor cores, and each output byte is written once in wide stores.  In
// float32 the bound is then the larger of the bytes over the memory's rate
// and three tf32 passes over 495 TFLOP/s, which are about equal at these
// widths; in bfloat16 the bytes (two per value) against one pass over 989
// TFLOP/s, within a factor of two of each other.  As built, a block's time
// is its copies and stores plus its arithmetic, one after the other (the
// two blocks of an SM run in step), and mma.sync does not reach the tensor
// cores' peak.  Overlapping the two parts is the first thing left to gain.
//
// The design: one kernel body over the two element types.
// * One block of 8 warps computes an 8 x 32 pixel tile of one frame for
//   ALL output channels (64 per block; wider convs take grid.y slices).
//   Its 10 x 34 halo tile is staged once in shared memory, pixel-major
//   with the channels fastest, together with the launch's weights, by
//   asynchronous copies (cp.async, 16 bytes each for the tile when a pixel's
//   channels allow it) that are all in flight at once; in chunks of input
//   channels when tile and weights do not fit twice on an SM.  Channels
//   are padded to the mma's K with zeros in shared memory only.
// * M = 16 consecutive pixels of a row, N = 8 output channels, K input
//   channels of one tap.  A warp owns one row of the tile: two M tiles by
//   every N tile (64 accumulator registers at Cout 64).  mma.sync was taken
//   over wgmma: its fragments come from ordinary shared-memory loads, so
//   the halo tile needs no swizzled K-major copy per tap, and the tensor
//   cores' term is under the byte term already, so wgmma's higher rate
//   would decide nothing.
// * Cin <= 4 (the ConvLSTM's first input half, K = 27): the taps are
//   packed into K, k = tap * Cin + c, padded to the mma's K, over a halo
//   tile stored row-contiguous.
// * dx: `flip` makes the staging read w[2-ky][2-kx][co][ci], so the
//   backward passes the forward's weights as they are.
//
// What the element type decides (a policy each: F32 and BF16 below):
// * float32: mma.sync.m16n8k8 (tf32 in, f32 out), float32-faithful: a =
//   a_hi + a_lo with a_hi = a rounded to tf32 and a_lo = a - a_hi (exact;
//   the tensor cores read it cut to tf32, which keeps a to 2^-21), the same
//   for b, and a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small terms first);
//   the dropped a_lo*b_lo is ~2^-22 relative.  The tensor cores sum only
//   the three terms of one K step; the running sum is kept by float32 adds
//   (round to nearest), because the tensor cores truncate what they return.
//   Operands are split as the fragments are read.  A non-finite input
//   gives a non-finite output (inf - inf in the split makes an inf a NaN;
//   so does a finite value within 2^-12 of the largest float32, which
//   rounds up to inf).  The weights are staged [tap][input channel]
//   [column], row strides of 4 (mod 8) floats for pixels and 8 (mod 16)
//   for weight rows keep the fragment loads free of bank conflicts, and
//   the columns are permuted so that the epilogue holds four consecutive
//   channels of a pixel: one float4 store each.
// * bfloat16: y = round_bf16(sum of x * w), as the JAX package runs
//   _conv_kernel under compute_dtype bfloat16 (spatial_conv.py:50-55, 98):
//   mma.sync.m16n8k16 bf16 x bf16 -> f32, one pass (a bf16 product is
//   exact in float32: no split), one rounding to nearest even at the
//   store.  Cin 12 runs as 16; Cin 3 packs K 27 -> 32.  The weights are
//   staged [tap][column][input channel], tile and weight rows kc + 8
//   values long, so that every fragment register (two consecutive K
//   values) is one 32-bit load and a row stride of 4 (mod 8) words puts a
//   warp's 32 loads in 32 banks; the epilogue stores channel pairs as one
//   32-bit word.  The whole K is summed in the mma accumulator.  The
//   tensor cores truncate the sums they return, which the float32 form has
//   to undo (6.4e-5 of the running sum at K = 576 there, 72 tf32 steps);
//   here K = 576 is 36 steps, and an error of that order is 30 times below
//   bf16's half-ulp of 2^-9 = 2.0e-3: it changes the rounded result only
//   for a sum within that distance of a rounding boundary, by one ulp
//   (measured on the H100: 99.95-99.999% of the outputs equal to float32
//   sums rounded once).  The error is relative to the running sum, not to
//   the result: where the products cancel to near 0 the result is off by
//   more ulps of itself, as any two float32 summation orders are.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/spatial_conv.py::conv3x3_cuda.

#include <cuda_bf16.h>
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

using bf16_bits = uint16_t;               // a bfloat16 value's bits

template <typename T>
struct ConvArgs {
  const T* x;
  const T* w;
  T* out;
  int h, wd, cin, cout;
  int tiles_x;
  int kc;        // input channels per staged chunk, a multiple of the mma's
                 // K (packed: the padded K)
  int cs;        // values per tile pixel (chunked form)
  int ws;        // values per weight row
  int flip;      // dx: read the weights flipped and in/out-transposed
  int vec_in;    // channels per load of x
  int vec_out;   // out can be written in vectors
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// An asynchronous copy of BYTES (4, 8 or 16) from device to shared memory;
// zeros instead when `real` is false (`src` is then not read, but stays a
// valid address).  Completed by stage_wait().
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool real) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(real ? 16 : 0)
                 : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
                 "l"(src), "r"(real ? 8 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(real ? 4 : 0)
                 : "memory");
}

// V values from src to dst, zeros where `real` is false: an asynchronous
// copy where they fill 4 bytes or more, else a load.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src, bool real) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 4)
    copy_async<kBytes>(dst, src, real);
  else
    *dst = real ? __ldg(src) : T(0);
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// The halo tile of input channels [c0, c0 + kcur) as tile[pixel][channel]
// with a.cs values per pixel; zero outside the frame and past Cin.  V
// channels per load.  The (pixel, channel group) of a thread advances by
// kThreads groups per turn without a division.
template <typename T, int V>
__device__ __forceinline__ void stage_halo(const ConvArgs<T>& a,
                                           const T* __restrict__ xf, T* tile,
                                           int y0, int x0, int c0, int kcur) {
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
    const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd &&
                        c < a.cin;
    const T* src =
        inside ? xf + (static_cast<long long>(gy) * a.wd + gx) * a.cin + c
               : xf;
    stage<T, V>(tile + p * a.cs + q * V, src, inside);
    p += dp;
    q += dq;
    if (q >= groups) {
      q -= groups;
      ++p;
    }
  }
}

// The halo tile of a Cin <= 4 frame, row-contiguous: tile[hy][hx * Cin + c]
// with rs = kHaloW * Cin values per row.
template <typename T>
__device__ __forceinline__ void stage_halo_packed(const ConvArgs<T>& a,
                                                  const T* __restrict__ xf,
                                                  T* tile, int y0, int x0,
                                                  int rs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = a.wd * a.cin;
  for (int hy = warp; hy < kHaloH; hy += kWarps) {
    const int gy = y0 - 1 + hy;
    const bool row_in = gy >= 0 && gy < a.h;
    const T* src = xf + static_cast<long long>(gy) * row;
    for (int e = lane; e < rs; e += 32) {
      const int ge = (x0 - 1) * a.cin + e;
      const bool inside = row_in && ge >= 0 && ge < row;
      stage<T, 1>(tile + hy * rs + e, inside ? src + ge : xf, inside);
    }
  }
}

// Where the weight of input channel ci, tap, output channel co of this
// launch lies.
template <typename T>
__device__ __forceinline__ const T* weight_at(const ConvArgs<T>& a, int tap,
                                              int ci, int co) {
  if (a.flip)
    return a.w + (static_cast<long long>(8 - tap) * a.cout + co) * a.cin + ci;
  return a.w + (static_cast<long long>(tap) * a.cin + ci) * a.cout + co;
}

// -- float32: three tf32 passes ----------------------------------------------

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

// Where output channel `co` of a block (co = 16 p + 4 q + s) sits among the
// weight columns: N tile 2 p + s / 2, column 2 q + s % 2.  A thread's
// accumulator columns (2 t, 2 t + 1) of the N tiles 2 p and 2 p + 1 are
// then the channels 16 p + 4 t .. + 3.
__device__ __forceinline__ int column_of(int co) {
  return (co & ~15) + ((co & 2) << 2) + ((co >> 1) & 6) + (co & 1);
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

struct F32 {
  using T = float;
  static constexpr int kK = 8;        // K per mma; channels pad to it

  // Floats per weight row: at least `cols`, and 8 mod 16, so that the four
  // K rows and eight columns of a B fragment fall in 32 different banks;
  // 4 (mod 8) per tile pixel.
  template <int NT>
  static void set_strides(ConvArgs<T>& a) {
    a.ws = round_up(NT * 8 - 8, 16) + 8;
    a.cs = a.kc + 4;
  }

  template <int NT>
  static size_t smem_bytes(bool packed, const ConvArgs<T>& a) {
    const size_t floats =
        packed ? round_up(kHaloH * kHaloW * a.cin, 4) +
                     static_cast<size_t>(a.kc) * a.ws
               : static_cast<size_t>(kHaloPix) * a.cs +
                     static_cast<size_t>(9) * a.kc * a.ws;
    return floats * sizeof(float);
  }

  // Weight rows [tap][c0 .. c0 + kcur) by the block's NT * 8 permuted
  // columns, zero past Cin and Cout.  Lanes run along the axis that is
  // contiguous in device memory: co forward, ci for dx.
  template <int NT>
  static __device__ __forceinline__ void stage_weights(const ConvArgs<T>& a,
                                                       T* wsm, int co0, int c0,
                                                       int kcur) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int tap = 0; tap < 9; ++tap) {
      T* rows = wsm + tap * kcur * a.ws;
      if (!a.flip) {
        for (int c = warp; c < kcur; c += kWarps)
          for (int col = lane; col < NT * 8; col += 32) {
            const bool real = c0 + c < a.cin && co0 + col < a.cout;
            stage<T, 1>(rows + c * a.ws + column_of(col),
                        real ? weight_at(a, tap, c0 + c, co0 + col) : a.w,
                        real);
          }
      } else {
        for (int col = warp; col < NT * 8; col += kWarps)
          for (int c = lane; c < kcur; c += 32) {
            const bool real = c0 + c < a.cin && co0 + col < a.cout;
            stage<T, 1>(rows + c * a.ws + column_of(col),
                        real ? weight_at(a, tap, c0 + c, co0 + col) : a.w,
                        real);
          }
      }
    }
  }

  // Weight rows k = tap * Cin + c of a Cin <= 4 launch, zero from 9 Cin to
  // the padded K.
  template <int NT>
  static __device__ __forceinline__ void stage_weights_packed(
      const ConvArgs<T>& a, T* wsm, int co0) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int k = warp; k < a.kc; k += kWarps) {
      const int tap = k / a.cin;
      const int c = k - tap * a.cin;
      for (int col = lane; col < NT * 8; col += 32) {
        const bool real = tap < 9 && co0 + col < a.cout;
        stage<T, 1>(wsm + k * a.ws + column_of(col),
                    real ? weight_at(a, tap, c, co0 + col) : a.w, real);
      }
    }
  }

  // One K step of the packed form; `apix` is this thread's pixel g of M
  // tile 0 in the tile's row `warp`.
  template <int NT>
  static __device__ __forceinline__ void packed_step(
      float (&acc)[2][NT][4], const ConvArgs<T>& a, const T* apix,
      const T* wsm, int rs, int k0, int g, int t) {
    const int k_real = 9 * a.cin;
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

  // Every K step of one tap over the staged chunk of kcur channels.
  template <int NT>
  static __device__ __forceinline__ void one_tap(float (&acc)[2][NT][4],
                                                 const ConvArgs<T>& a,
                                                 const T* tile, const T* wsm,
                                                 int kcur, int tap, int warp,
                                                 int g, int t) {
    const int ky = tap / 3;
    const int kx = tap - 3 * ky;
    // (pixel g of M tile 0 under this tap, channel t)
    const float* apix = tile + ((warp + ky) * kHaloW + kx + g) * a.cs + t;
    const float* brow = wsm + (tap * kcur + t) * a.ws + g;
    for (int c8 = 0; c8 < kcur; c8 += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* p = apix + m * 16 * a.cs + c8;
        split_tf32(p[0], ahi[m][0], alo[m][0]);                 // (g, t)
        split_tf32(p[8 * a.cs], ahi[m][1], alo[m][1]);          // (g+8, t)
        split_tf32(p[4], ahi[m][2], alo[m][2]);                 // (g, t+4)
        split_tf32(p[8 * a.cs + 4], ahi[m][3], alo[m][3]);      // (g+8, t+4)
      }
      mma_step<NT>(acc, ahi, alo, brow + c8 * a.ws, a.ws);
    }
  }

  // This thread's outputs of pixel `dst` (channel 0 there): N tiles paired,
  // four consecutive channels per store.
  template <int NT>
  static __device__ __forceinline__ void store(const ConvArgs<T>& a,
                                               const float (&acc)[2][NT][4],
                                               T* dst, int m, int half,
                                               int co0, int t) {
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
};

// -- bfloat16: one pass -------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16_bits* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16_bits lo, bf16_bits hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ bf16_bits to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 operands.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct BF16 {
  using T = bf16_bits;
  static constexpr int kK = 16;       // K per mma; channels pad to it

  // Values per tile pixel and per weight row: kc + 8, 4 (mod 8) words.
  template <int NT>
  static void set_strides(ConvArgs<T>& a) {
    a.cs = a.ws = a.kc + 8;
  }

  template <int NT>
  static size_t smem_bytes(bool packed, const ConvArgs<T>& a) {
    const size_t values =
        packed ? round_up(kHaloH * kHaloW * a.cin, 8) +
                     static_cast<size_t>(NT * 8) * a.ws
               : static_cast<size_t>(kHaloPix) * a.cs +
                     static_cast<size_t>(9) * NT * 8 * a.ws;
    return values * sizeof(T);
  }

  // Weight rows [tap][column][c0 .. c0 + kcur), zero past Cin and Cout.
  // Lanes run along the axis that is contiguous in device memory: co
  // forward, ci for dx.
  template <int NT>
  static __device__ __forceinline__ void stage_weights(const ConvArgs<T>& a,
                                                       T* wsm, int co0, int c0,
                                                       int kcur) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int tap = 0; tap < 9; ++tap) {
      T* rows = wsm + tap * NT * 8 * a.ws;
      if (!a.flip) {
        for (int c = warp; c < kcur; c += kWarps)
          for (int col = lane; col < NT * 8; col += 32) {
            const bool real = c0 + c < a.cin && co0 + col < a.cout;
            stage<T, 1>(rows + col * a.ws + c,
                        real ? weight_at(a, tap, c0 + c, co0 + col) : a.w,
                        real);
          }
      } else {
        for (int col = warp; col < NT * 8; col += kWarps)
          for (int c = lane; c < kcur; c += 32) {
            const bool real = c0 + c < a.cin && co0 + col < a.cout;
            stage<T, 1>(rows + col * a.ws + c,
                        real ? weight_at(a, tap, c0 + c, co0 + col) : a.w,
                        real);
          }
      }
    }
  }

  // Weight rows [column][k = tap * Cin + c] of a Cin <= 4 launch, zero
  // from 9 Cin to the padded K.
  template <int NT>
  static __device__ __forceinline__ void stage_weights_packed(
      const ConvArgs<T>& a, T* wsm, int co0) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int col = warp; col < NT * 8; col += kWarps)
      for (int k = lane; k < a.kc; k += 32) {
        const int tap = k / a.cin;
        const bool real = tap < 9 && co0 + col < a.cout;
        stage<T, 1>(wsm + col * a.ws + k,
                    real ? weight_at(a, tap, k - tap * a.cin, co0 + col)
                         : a.w,
                    real);
      }
  }

  // One K step of the packed form: the thread's four K indices are
  // k0 + 2t + {0, 1, 8, 9}.
  template <int NT>
  static __device__ __forceinline__ void packed_step(
      float (&acc)[2][NT][4], const ConvArgs<T>& a, const T* apix,
      const T* wsm, int rs, int k0, int g, int t) {
    const int k_real = 9 * a.cin;
    int off[4];
    bool real[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 2 * t + (i & 1) + 8 * (i >> 1);
      const int tap = k / a.cin;
      const int ky = tap / 3;
      real[i] = k < k_real;
      off[i] = real[i] ? ky * rs + (tap - 3 * ky) * a.cin + (k - tap * a.cin)
                       : 0;
    }
    uint32_t af[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const T* p = apix + m * 16 * a.cin;
      T v[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[0][i] = real[i] ? p[off[i]] : T(0);                 // g
        v[1][i] = real[i] ? p[8 * a.cin + off[i]] : T(0);     // g + 8
      }
      af[m][0] = pack2(v[0][0], v[0][1]);
      af[m][1] = pack2(v[1][0], v[1][1]);
      af[m][2] = pack2(v[0][2], v[0][3]);
      af[m][3] = pack2(v[1][2], v[1][3]);
    }
    const T* b = wsm + g * a.ws + k0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t b0 = ld32(b + j * 8 * a.ws);
      const uint32_t b1 = ld32(b + j * 8 * a.ws + 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[m][j], af[m], b0, b1);
    }
  }

  // Every K step of one tap over the staged chunk of kcur channels.
  template <int NT>
  static __device__ __forceinline__ void one_tap(float (&acc)[2][NT][4],
                                                 const ConvArgs<T>& a,
                                                 const T* tile, const T* wsm,
                                                 int kcur, int tap, int warp,
                                                 int g, int t) {
    const int ky = tap / 3;
    const int kx = tap - 3 * ky;
    // (pixel g of M tile 0 under this tap, channels 2t and 2t + 1)
    const T* apix = tile + ((warp + ky) * kHaloW + kx + g) * a.cs + 2 * t;
    const T* brow = wsm + (tap * NT * 8 + g) * a.ws + 2 * t;
    for (int c16 = 0; c16 < kcur; c16 += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const T* p = apix + m * 16 * a.cs + c16;
        af[m][0] = ld32(p);                   // (g, 2t)
        af[m][1] = ld32(p + 8 * a.cs);        // (g + 8, 2t)
        af[m][2] = ld32(p + 8);               // (g, 2t + 8)
        af[m][3] = ld32(p + 8 * a.cs + 8);    // (g + 8, 2t + 8)
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* bp = brow + j * 8 * a.ws + c16;
        const uint32_t b0 = ld32(bp);         // (k 2t, column g)
        const uint32_t b1 = ld32(bp + 8);     // (k 2t + 8, column g)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_bf16(acc[m][j], af[m], b0, b1);
      }
    }
  }

  // This thread's outputs of pixel `dst` (channel 0 there): a channel pair
  // per N tile, rounded to nearest even, one 32-bit store.
  template <int NT>
  static __device__ __forceinline__ void store(const ConvArgs<T>& a,
                                               const float (&acc)[2][NT][4],
                                               T* dst, int m, int half,
                                               int co0, int t) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int co = co0 + 8 * j + 2 * t;
      const T v0 = to_bf16(acc[m][j][2 * half]);
      const T v1 = to_bf16(acc[m][j][2 * half + 1]);
      if (a.vec_out && co + 1 < a.cout) {
        *reinterpret_cast<uint32_t*>(dst + co) = pack2(v0, v1);
      } else {
        if (co < a.cout) dst[co] = v0;
        if (co + 1 < a.cout) dst[co + 1] = v1;
      }
    }
  }
};

// -- the kernel -----------------------------------------------------------------

// grid = (spatial tiles, slices of kMaxNT * 8 output channels, frames).
// P: the element type's policy.  NT: N tiles per block (even).  PACKED:
// the Cin <= 4 form.
template <typename P, int NT, bool PACKED>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_kernel(ConvArgs<typename P::T> a) {
  using T = typename P::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;       // fragment row (pixel) / B column
  const int t = lane & 3;        // fragment K index / accumulator column pair
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * (kMaxNT * 8);
  const int tile_y = blockIdx.x / a.tiles_x;
  const int y0 = tile_y * kTileH;
  const int x0 = (blockIdx.x - tile_y * a.tiles_x) * kTileW;
  const T* xf = a.x + static_cast<long long>(n) * a.h * a.wd * a.cin;

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;

  if constexpr (PACKED) {
    const int rs = kHaloW * a.cin;
    T* tile = smem;
    T* wsm = smem + round_up(kHaloH * rs, 16 / static_cast<int>(sizeof(T)));
    stage_halo_packed(a, xf, tile, y0, x0, rs);
    P::template stage_weights_packed<NT>(a, wsm, co0);
    stage_wait();

    // this thread's pixels: row `warp`, columns g and g + 8 of each M tile
    const T* apix = tile + warp * rs + g * a.cin;
    for (int k0 = 0; k0 < a.kc; k0 += P::kK)
      P::template packed_step<NT>(acc, a, apix, wsm, rs, k0, g, t);
  } else {
    constexpr int kWide = 16 / static_cast<int>(sizeof(T));
    const int cinp = round_up(a.cin, P::kK);
    T* tile = smem;
    T* wsm = smem + kHaloPix * a.cs;
    for (int c0 = 0; c0 < cinp; c0 += a.kc) {
      const int kcur = min(a.kc, cinp - c0);
      if (c0 > 0) __syncthreads();     // the last chunk's reads are done
      if (a.vec_in == kWide)
        stage_halo<T, kWide>(a, xf, tile, y0, x0, c0, kcur);
      else if (a.vec_in == kWide / 2)
        stage_halo<T, kWide / 2>(a, xf, tile, y0, x0, c0, kcur);
      else
        stage_halo<T, 1>(a, xf, tile, y0, x0, c0, kcur);
      P::template stage_weights<NT>(a, wsm, co0, c0, kcur);
      stage_wait();
      for (int tap = 0; tap < 9; ++tap)
        P::template one_tap<NT>(acc, a, tile, wsm, kcur, tap, warp, g, t);
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
      P::template store<NT>(
          a, acc,
          a.out + ((static_cast<long long>(n) * a.h + oy) * a.wd + ox) *
                      a.cout,
          m, half, co0, t);
    }
  }
}

template <typename P, int NT, bool PACKED>
cudaError_t launch(ConvArgs<typename P::T> a, long long n,
                   cudaStream_t stream) {
  static vfd::SmemOptin optin;     // one per kernel instantiation
  int limit = 0;
  cudaError_t err =
      optin.limit(conv3x3_kernel<P, NT, PACKED>, &limit, true);
  if (err != cudaSuccess) return err;

  if (PACKED) {
    a.kc = round_up(9 * a.cin, P::kK);
    P::template set_strides<NT>(a);
  } else {
    // the largest chunk of input channels that lets two blocks share an
    // SM (each block also takes 1 KB of the SM's own), then even chunks
    const size_t budget = static_cast<size_t>(limit) / 2 - 1024;
    const int cinp = round_up(a.cin, P::kK);
    a.kc = cinp;
    P::template set_strides<NT>(a);
    while (a.kc > P::kK && P::template smem_bytes<NT>(false, a) > budget) {
      a.kc -= P::kK;
      P::template set_strides<NT>(a);
    }
    const int chunks = (cinp + a.kc - 1) / a.kc;
    a.kc = round_up((cinp + chunks - 1) / chunks, P::kK);
    P::template set_strides<NT>(a);
  }
  const size_t smem = P::template smem_bytes<NT>(PACKED, a);
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;

  const long long tiles_x = (a.wd + kTileW - 1) / kTileW;
  const long long tiles = tiles_x * ((a.h + kTileH - 1) / kTileH);
  const long long slices = (a.cout + kMaxNT * 8 - 1) / (kMaxNT * 8);
  if (tiles > 0x7fffffffLL || slices > 65535) return cudaErrorInvalidValue;
  a.tiles_x = static_cast<int>(tiles_x);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(slices),
                  static_cast<unsigned>(n));
  conv3x3_kernel<P, NT, PACKED><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename P, bool PACKED>
cudaError_t launch_nt(const ConvArgs<typename P::T>& a, long long n,
                      cudaStream_t stream) {
  // N tiles per block: Cout padded to 16 (the float32 epilogue pairs
  // them), at most kMaxNT
  const int nt = std::min(round_up(a.cout, 16) / 8, kMaxNT);
  switch (nt) {
    case 2: return launch<P, 2, PACKED>(a, n, stream);
    case 4: return launch<P, 4, PACKED>(a, n, stream);
    case 6: return launch<P, 6, PACKED>(a, n, stream);
    default: return launch<P, 8, PACKED>(a, n, stream);
  }
}

// The launch of either element type: x, w, out as the C entries take them,
// `vec_in` channels per load of x, `vec_out` vector stores.
template <typename P>
int run(const void* x, const void* w, void* out, long long n, int h, int wd,
        int cin, int cout, int flip, int vec_in, bool vec_out,
        void* stream) {
  using T = typename P::T;
  if (n <= 0 || n > 65535 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0)
    return cudaErrorInvalidValue;
  ConvArgs<T> a = {};
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.out = static_cast<T*>(out);
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.flip = flip != 0;
  a.vec_in = vec_in;
  a.vec_out = vec_out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cin <= kPackedCin ? launch_nt<P, true>(a, n, s)
                                            : launch_nt<P, false>(a, n, s));
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
  const bool vec_in = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return run<F32>(x, w, out, n, h, wd, cin, cout, flip, vec_in ? 4 : 1,
                  vec_out, stream);
}

// The bfloat16 form of vfd_conv3x3_f32: x, w and out hold bfloat16 values,
// the same shapes and `flip`; float32 sums, out rounded to nearest even.
extern "C" int vfd_conv3x3_bf16(const void* x, const void* w, void* out,
                                long long n, int h, int wd, int cin, int cout,
                                int flip, void* stream) {
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  const int vec_in = cin % 8 == 0 && xp % 16 == 0  ? 8
                     : cin % 4 == 0 && xp % 8 == 0 ? 4
                                                   : 1;
  const bool vec_out =
      cout % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  return run<BF16>(x, w, out, n, h, wd, cin, cout, flip, vec_in, vec_out,
                   stream);
}
