// The math the flow kernels share: the bilinear warp sample, the build of
// the five normal-equation quantities, the banded box blur and the 2x2
// solve, plus the per-field body of the refine and fused kernels.
//
// The function is the XLA body of vfd_gan_tpu/ops/flow.py::_flow_level
// (flow.py:172-241), which the port's plain PyTorch versions restate:
//  * warp: float32 planes sampled at (x + fx, y + fy), the sample point
//    clamped to [0, W-1] x [0, H-1]; x is interpolated first, then y.  No
//    band clamp on fy (that clamp existed only for the TPU's one-hot
//    matmul formulation).
//  * quantities: float32 elementwise algebra, in the plain version's order.
//  * box blur: the JAX CORR_DTYPE contract.  Each quantity map is rounded
//    to bfloat16, the W pass sums bfloat16 weight x bfloat16 value
//    products in float32, its result is rounded to bfloat16 again, and the
//    H pass sums in float32.  The weights are the bfloat16-rounded entries
//    of the replicate-border banded matrix (vfd_gan_tpu_torch/ops/corr.py
//    ::band_table): row i holds columns i-r .. i+r, so the border entry
//    where clamped taps pile up is bf16(j/k), as in the JAX matrix.
//  * solve: det = g11 g22 - g12^2, clamped to 1e-9 where |det| < 1e-9.
// The library is compiled with --fmad=false, so every product and sum is
// rounded on its own as PyTorch's elementwise kernels round it; only the
// order of the blur's float32 sums can differ from cuBLAS's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vfd {

constexpr int kPolyPlanes = 5;   // bx, by, axx, ayy, axy

struct BilinearTaps {
  int i00, i01, i10, i11;        // flat indices of the four neighbours
  float wx, wy;
};

// The four neighbours of pixel (y, x) displaced by (fx, fy), clamped.
__device__ __forceinline__ BilinearTaps bilinear_taps(float fx, float fy,
                                                      int y, int x, int h,
                                                      int w) {
  const float ys = fminf(fmaxf(static_cast<float>(y) + fy, 0.0f),
                         static_cast<float>(h - 1));
  const float xs = fminf(fmaxf(static_cast<float>(x) + fx, 0.0f),
                         static_cast<float>(w - 1));
  const float y0f = floorf(ys);
  const float x0f = floorf(xs);
  const int y0 = static_cast<int>(y0f);
  const int x0 = static_cast<int>(x0f);
  const int y1 = min(y0 + 1, h - 1);
  const int x1 = min(x0 + 1, w - 1);
  BilinearTaps t;
  t.i00 = y0 * w + x0;
  t.i01 = y0 * w + x1;
  t.i10 = y1 * w + x0;
  t.i11 = y1 * w + x1;
  t.wx = xs - x0f;
  t.wy = ys - y0f;
  return t;
}

__device__ __forceinline__ float bilinear(const float* __restrict__ plane,
                                          const BilinearTaps& t) {
  const float top = __ldg(plane + t.i00) * (1.0f - t.wx)
                    + __ldg(plane + t.i01) * t.wx;
  const float bot = __ldg(plane + t.i10) * (1.0f - t.wx)
                    + __ldg(plane + t.i11) * t.wx;
  return top * (1.0f - t.wy) + bot * t.wy;
}

// The five quantities of one pixel from frame 1's planes p1[c] and frame
// 2's warped planes w2[c] (c = bx, by, axx, ayy, axy) and the flow.
__device__ __forceinline__ void normal_quantities(const float* p1,
                                                  const float* w2, float fx,
                                                  float fy, float* q) {
  const float axx = (p1[2] + w2[2]) * 0.5f;
  const float ayy = (p1[3] + w2[3]) * 0.5f;
  const float axy = ((p1[4] + w2[4]) * 0.5f) * 0.5f;
  const float dbx = (w2[0] - p1[0]) * -0.5f + axx * fx + axy * fy;
  const float dby = (w2[1] - p1[1]) * -0.5f + axy * fx + ayy * fy;
  q[0] = axx * axx + axy * axy;
  q[1] = axy * (axx + ayy);
  q[2] = ayy * ayy + axy * axy;
  q[3] = axx * dbx + axy * dby;
  q[4] = axy * dbx + ayy * dby;
}

__device__ __forceinline__ void solve2x2(const float* g, float* fx,
                                         float* fy) {
  float det = g[0] * g[2] - g[1] * g[1];
  if (fabsf(det) < 1e-9f) det = 1e-9f;
  *fx = (g[2] * g[3] - g[1] * g[4]) / det;
  *fy = (g[0] * g[4] - g[1] * g[3]) / det;
}

// Where one field's scratch lives: the two blur tables always in shared
// memory; the bfloat16 quantity maps Q and the W-pass maps T (5 planes
// each) in shared memory when they fit, else in a global workspace of
// `workspace` bytes per field.
struct FieldPlan {
  size_t smem;
  size_t workspace;
};

inline FieldPlan plan_field(int h, int w, int k, int smem_limit) {
  const size_t tables = sizeof(float) * static_cast<size_t>(h + w) * k;
  const size_t scratch = 2 * kPolyPlanes * static_cast<size_t>(h) * w *
                         sizeof(__nv_bfloat16);
  if (tables + scratch <= static_cast<size_t>(smem_limit))
    return {tables + scratch, 0};
  return {tables, scratch};
}

// One block refines one field for `iters` rounds.  kWarp: stage A warps
// frame 2's planes `p2` by the flow carry (the fused kernel); otherwise
// `p2` already holds the warped planes (the refine kernel, iters = 1).
// Operands are contiguous planes: p1, p2 (N, 5, H, W), flow/out
// (N, 2, H, W); band_h (H, k), band_w (W, k).
//
// Stages of a round, separated by __syncthreads():
//  A. per pixel: warp (or read) the 5 planes, build the 5 quantities,
//     store them rounded to bfloat16 in Q;
//  B. per element of Q: the W pass into T, rounded to bfloat16;
//  C. per pixel: the H pass of the 5 maps of T, the solve, the new flow
//     into `out`, which carries the flow to the next round.
// A thread handles the same pixels in A and C, so the carry it reads in
// A is the one it wrote in C; C reads only T and A writes only Q, so the
// barrier after A is the only one a round needs before the next B.
template <bool kWarp>
__device__ void refine_field(const float* __restrict__ p1,
                             const float* __restrict__ p2,
                             const float* __restrict__ flow,
                             const float* __restrict__ band_h,
                             const float* __restrict__ band_w,
                             float* out, __nv_bfloat16* workspace, int h,
                             int w, int k, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bh = reinterpret_cast<float*>(smem_raw);
  float* bw = bh + h * k;
  const long long hw = static_cast<long long>(h) * w;
  const long long field = blockIdx.x;
  __nv_bfloat16* q = workspace == nullptr
      ? reinterpret_cast<__nv_bfloat16*>(bw + w * k)
      : workspace + field * 2 * kPolyPlanes * hw;
  __nv_bfloat16* t = q + kPolyPlanes * hw;
  p1 += field * kPolyPlanes * hw;
  p2 += field * kPolyPlanes * hw;
  flow += field * 2 * hw;
  out += field * 2 * hw;
  const int r = k / 2;

  for (int i = threadIdx.x; i < h * k; i += blockDim.x) bh[i] = band_h[i];
  for (int i = threadIdx.x; i < w * k; i += blockDim.x) bw[i] = band_w[i];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float* carry = it == 0 ? flow : out;
    for (long long pix = threadIdx.x; pix < hw; pix += blockDim.x) {
      const int y = static_cast<int>(pix / w);
      const int x = static_cast<int>(pix - static_cast<long long>(y) * w);
      const float fx = carry[pix];
      const float fy = carry[hw + pix];
      float a[kPolyPlanes], b[kPolyPlanes], qv[kPolyPlanes];
      if (kWarp) {
        const BilinearTaps taps = bilinear_taps(fx, fy, y, x, h, w);
#pragma unroll
        for (int c = 0; c < kPolyPlanes; ++c)
          b[c] = bilinear(p2 + c * hw, taps);
      } else {
#pragma unroll
        for (int c = 0; c < kPolyPlanes; ++c) b[c] = p2[c * hw + pix];
      }
#pragma unroll
      for (int c = 0; c < kPolyPlanes; ++c) a[c] = p1[c * hw + pix];
      normal_quantities(a, b, fx, fy, qv);
#pragma unroll
      for (int c = 0; c < kPolyPlanes; ++c)
        q[c * hw + pix] = __float2bfloat16_rn(qv[c]);
    }
    __syncthreads();

    // W pass: T[c][y][x] = bf16(sum_d band_w[x][d] * Q[c][y][x + d - r])
    for (long long e = threadIdx.x; e < kPolyPlanes * hw; e += blockDim.x) {
      const long long row0 = (e / w) * w;
      const int x = static_cast<int>(e - row0);
      const float* wt = bw + x * k;
      float acc = 0.0f;
      for (int d = 0; d < k; ++d) {
        const int j = x + d - r;
        if (j >= 0 && j < w)
          acc += wt[d] * __bfloat162float(q[row0 + j]);
      }
      t[e] = __float2bfloat16_rn(acc);
    }
    __syncthreads();

    // H pass and solve
    for (long long pix = threadIdx.x; pix < hw; pix += blockDim.x) {
      const int y = static_cast<int>(pix / w);
      const int x = static_cast<int>(pix - static_cast<long long>(y) * w);
      const float* ht = bh + y * k;
      float g[kPolyPlanes];
#pragma unroll
      for (int c = 0; c < kPolyPlanes; ++c) {
        const __nv_bfloat16* col = t + c * hw + x;
        float acc = 0.0f;
        for (int d = 0; d < k; ++d) {
          const int i = y + d - r;
          if (i >= 0 && i < h)
            acc += ht[d] * __bfloat162float(col[static_cast<long long>(i) * w]);
        }
        g[c] = acc;
      }
      float nfx, nfy;
      solve2x2(g, &nfx, &nfy);
      out[pix] = nfx;
      out[hw + pix] = nfy;
    }
  }
}

// Threads per field block: up to 512, a multiple of 32, no more than the
// plane has pixels (rounded up to a warp).
inline int field_threads(int h, int w) {
  const long long px = static_cast<long long>(h) * w;
  const long long warps = (px + 31) / 32;
  return static_cast<int>(warps >= 16 ? 512 : 32 * warps);
}

// Checks shared by the refine and fused entry points; returns a
// cudaError_t (cudaSuccess when the launch may go ahead).
inline cudaError_t check_field_args(long long n, int h, int w, int k,
                                    bool have_workspace,
                                    const FieldPlan& plan, int smem_limit) {
  if (n <= 0 || n > 0x7fffffffLL || h <= 0 || w <= 0 || k < 1 || k % 2 == 0)
    return cudaErrorInvalidValue;
  if (plan.smem > static_cast<size_t>(smem_limit))
    return cudaErrorInvalidValue;                 // tables alone too large
  if (plan.workspace != 0 && !have_workspace) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace vfd
