// The math the flow kernels share: the bilinear warp sample, the build of
// the five normal-equation quantities, the banded box blur and the 2x2
// solve, plus the per-field body of the refine and fused kernels and the
// host code that launches it.
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
// rounded on its own as PyTorch's elementwise kernels round it.  The two
// blur passes alone use an explicit fused multiply-add: a bfloat16 x
// bfloat16 product is exact in float32, so fma(w, v, acc) rounds once,
// exactly as acc + w * v does, at half the instructions.  Every output
// sums its taps in the order d = 0 .. 14.
//
// How a field is tiled (vfd_gan_tpu_torch/ops/flow_refine.py restates the
// index maps in Python, where the CPU tests reach them):
//  * Q, the bfloat16 quantity maps: the 5 x H rows one after the other at
//    a pitch of round_up(W, 8) + 8, each row's data 8 elements in, all
//    else zero.  The zeros after one row are the zeros before the next, so
//    a W-pass run loads 24 aligned elements (x0 - 8 .. x0 + 15) for its 8
//    outputs x0 .. x0 + 7 without a bounds test, and at that pitch the 16
//    byte loads of 32 lanes on 32 rows fall on distinct banks (W = 64, 32,
//    16, 128).
//  * T, the bfloat16 W-pass maps: 7 zero rows, then per plane H rows and 7
//    zero rows (one plane's lower halo is the next one's upper), then
//    kMaxRows - 1 spare rows; the same pitch.  An H-pass item loads
//    MH + 14 rows of one column, in all five planes, for its MH output
//    rows; the spare rows take the loads of a last item that hangs over
//    the plane's end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_common.cuh"

namespace vfd {

constexpr int kPolyPlanes = 5;   // bx, by, axx, ayy, axy
constexpr int kWin = 15;         // taps of the box blur (winsize)
constexpr int kRad = kWin / 2;
constexpr int kRun = 8;          // outputs of a W-pass run: 16 bytes of bf16
constexpr int kBandPitch = 16;   // floats per band-table row in shared memory
constexpr int kMaxRows = 4;      // most output rows of an H-pass item
constexpr int kSolverThreads = 256;   // most threads of a field's block

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

// One field's bfloat16 scratch, in elements (see the header note).
struct FieldLayout {
  int pitch;     // of a row of Q and of T
  int q_elems;
  int t_elems;
};

__host__ __device__ inline FieldLayout field_layout(int h, int w) {
  FieldLayout l;
  l.pitch = ((w + kRun - 1) / kRun) * kRun + kRun;
  l.q_elems = kPolyPlanes * h * l.pitch + kRun;
  l.t_elems = (kPolyPlanes * (h + kRad) + kRad + kMaxRows - 1) * l.pitch;
  return l;
}

// The two halves of a 32-bit word of two bfloat16 values, as float32.
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The digits (a, b, c) of e = (a * nb + b) * nc + c for e = start,
// start + step, ...: one division pair at the start, none per step.
struct Walk3 {
  int a, b, c;
  int da, db, dc, nb, nc;
  __device__ Walk3(int start, int step, int nb_, int nc_) : nb(nb_), nc(nc_) {
    int rest = start / nc;
    c = start - rest * nc;
    a = rest / nb;
    b = rest - a * nb;
    rest = step / nc;
    dc = step - rest * nc;
    da = rest / nb;
    db = rest - da * nb;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    int carry = c >= nc;
    c -= carry ? nc : 0;
    b += db + carry;
    carry = b >= nb;
    b -= carry ? nb : 0;
    a += da + carry;
  }
};

// Stage A for one pixel: warp frame 2's planes by (fx, fy) (kWarp) or read
// the already-warped ones, build the five quantities, store them rounded
// to bfloat16 in Q.
template <bool kWarp>
__device__ __forceinline__ void store_quantities(
    const float* __restrict__ p1, const float* __restrict__ p2, int hw, int h,
    int w, int y, int x, float fx, float fy, __nv_bfloat16* q, int pitch) {
  const int pix = y * w + x;
  float a[kPolyPlanes], b[kPolyPlanes], qv[kPolyPlanes];
  if (kWarp) {
    const BilinearTaps taps = bilinear_taps(fx, fy, y, x, h, w);
#pragma unroll
    for (int c = 0; c < kPolyPlanes; ++c) b[c] = bilinear(p2 + c * hw, taps);
  } else {
#pragma unroll
    for (int c = 0; c < kPolyPlanes; ++c) b[c] = __ldg(p2 + c * hw + pix);
  }
#pragma unroll
  for (int c = 0; c < kPolyPlanes; ++c) a[c] = __ldg(p1 + c * hw + pix);
  normal_quantities(a, b, fx, fy, qv);
#pragma unroll
  for (int c = 0; c < kPolyPlanes; ++c)
    q[(c * h + y) * pitch + kRun + x] = __float2bfloat16_rn(qv[c]);
}

// One W-pass run: outputs x0 .. x0 + 7 of one row of Q (`src` points at
// the row's padded element x0, i.e. column x0 - 8) into 16 bytes of T.
// kConst: every weight of the run is `cw` (no output within 7 columns of a
// border); else the weights come from the band table `bw`.
template <bool kConst>
__device__ __forceinline__ uint4 blur_w_run(const uint4* src, const float* bw,
                                            int x0, int w, float cw) {
  const uint4 r0 = src[0], r1 = src[1], r2 = src[2];
  const uint32_t words[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                              r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
  float v[3 * kRun];             // columns x0 - 8 .. x0 + 15
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    v[2 * i] = bf16_lo(words[i]);
    v[2 * i + 1] = bf16_hi(words[i]);
  }
  float acc[kRun];
#pragma unroll
  for (int o = 0; o < kRun; ++o) {
    float wt[kBandPitch];
    if (!kConst) {
      const float4* row = reinterpret_cast<const float4*>(
          bw + min(x0 + o, w - 1) * kBandPitch);
#pragma unroll
      for (int i = 0; i < kBandPitch / 4; ++i) {
        const float4 f = row[i];
        wt[4 * i] = f.x;
        wt[4 * i + 1] = f.y;
        wt[4 * i + 2] = f.z;
        wt[4 * i + 3] = f.w;
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < kWin; ++d)
      s = __fmaf_rn(kConst ? cw : wt[d], v[o + d + kRun - kRad], s);
    acc[o] = s;
  }
  return make_uint4(bf16_pair(acc[0], acc[1]), bf16_pair(acc[2], acc[3]),
                    bf16_pair(acc[4], acc[5]), bf16_pair(acc[6], acc[7]));
}

// One H-pass item: the five blurred quantities of MH rows of one column.
// `col` points at the column's element in the first input row (T row y0
// of plane 0, which is image row y0 - 7); `plane` and `pitch` are T's
// plane and row strides in elements.
template <int MH, bool kConst>
__device__ __forceinline__ void blur_h_item(const unsigned short* col,
                                            int plane, int pitch,
                                            const float* bh, int y0, int h,
                                            float cw,
                                            float (&g)[MH][kPolyPlanes]) {
  const float* rows[MH];
#pragma unroll
  for (int o = 0; o < MH; ++o) {
    rows[o] = bh + min(y0 + o, h - 1) * kBandPitch;
#pragma unroll
    for (int c = 0; c < kPolyPlanes; ++c) g[o][c] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < MH + kWin - 1; ++i) {
    float v[kPolyPlanes];
#pragma unroll
    for (int c = 0; c < kPolyPlanes; ++c)
      v[c] = bf16_lo(col[c * plane + i * pitch]);
#pragma unroll
    for (int o = 0; o < MH; ++o) {
      const int d = i - o;
      if (d >= 0 && d < kWin) {
        const float wt = kConst ? cw : rows[o][d];
#pragma unroll
        for (int c = 0; c < kPolyPlanes; ++c)
          g[o][c] = __fmaf_rn(wt, v[c], g[o][c]);
      }
    }
  }
}

// With -DVFD_STAGE_CLOCKS (vfd_gan_tpu_torch/tools/flow_stages.py builds a
// library of its own that way) thread 0 of each of the first
// kClockedBlocks blocks notes the time at every stage boundary: slots 0
// and 15 the device's nanosecond timer at entry and exit, the others the
// SM's cycle counter.  Compiled out otherwise.
#ifdef VFD_STAGE_CLOCKS
constexpr int kClockedBlocks = 1024;
constexpr int kClockSlots = 16;
__device__ unsigned long long g_stage_clock[kClockedBlocks * kClockSlots];
__device__ __forceinline__ void stamp(int slot) {
  if (threadIdx.x == 0 && blockIdx.x < kClockedBlocks) {
    unsigned long long t;
    if (slot == 0 || slot == kClockSlots - 1)
      asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    else
      t = clock64();
    g_stage_clock[blockIdx.x * kClockSlots + slot] = t;
  }
}
#define VFD_STAMP(slot) vfd::stamp(slot)
#else
#define VFD_STAMP(slot)
#endif

// One block refines one field for `iters` rounds.  kWarp: stage A warps
// frame 2's planes `p2` by the flow (the fused kernel); otherwise `p2`
// already holds the warped planes (the refine kernel, iters = 1).  MH: the
// output rows of an H-pass item.  kGlobal: Q and T live in `scratch`
// (global memory, field_layout's elements per field) and not in shared
// memory.  Operands are contiguous planes: p1, p2 (N, 5, H, W), flow/out
// (N, 2, H, W); band_h (H, 15), band_w (W, 15).
//
// Stages, separated by __syncthreads():
//  A. per pixel: warp (or read) the 5 planes, build the 5 quantities into
//     Q.  Round 0 walks the pixels in order; later rounds run inside C.
//  B. the W pass, Q -> T: an item is a run of 8 outputs of one row, its 22
//     inputs loaded once into registers (8 independent sums); lanes run
//     along the rows, so a warp shares its weights (one constant away from
//     the border) and its 16-byte loads and stores meet no bank twice.  In
//     global memory lanes run along a row's runs instead: coalesced.
//  C. the H pass and the solve: an item is MH rows of one column, all
//     five planes at once (5 MH independent sums), lanes along the
//     columns, so that the flow stores and stage A's loads are coalesced.
//     The last round stores the flow; an earlier one keeps it in registers
//     and runs stage A of the next round for its own pixels: C reads only
//     T and A writes only Q.
template <bool kWarp, int MH, bool kGlobal>
__device__ __forceinline__ void refine_field(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const float* __restrict__ flow, const float* __restrict__ band_h,
    const float* __restrict__ band_w, float* __restrict__ out,
    __nv_bfloat16* scratch, int h, int w, int iters) {
  static_assert(MH >= 1 && MH <= kMaxRows, "rows of an H-pass item");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bh = reinterpret_cast<float*>(smem_raw);
  float* bw = bh + h * kBandPitch;
  const FieldLayout lay = field_layout(h, w);
  const int pitch = lay.pitch;
  const int hw = h * w;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const long long field = blockIdx.x;
  __nv_bfloat16* q = kGlobal
      ? scratch + field * (static_cast<long long>(lay.q_elems) + lay.t_elems)
      : reinterpret_cast<__nv_bfloat16*>(bw + w * kBandPitch);
  __nv_bfloat16* t = q + lay.q_elems;
  p1 += field * kPolyPlanes * hw;
  p2 += field * kPolyPlanes * hw;
  flow += field * 2 * hw;
  out += field * 2 * hw;

  VFD_STAMP(0);                              // entry: timer, then cycles
  VFD_STAMP(1);
  // the band tables at a pitch of 16 floats, the 16th zero
  for (int i = tid; i < (h + w) * kBandPitch; i += nthr) {
    const int row = i / kBandPitch, d = i % kBandPitch;
    const float* band = row < h ? band_h + row * kWin
                                : band_w + (row - h) * kWin;
    bh[i] = d < kWin ? band[d] : 0.0f;
  }
  // Q's zeros: the 8 elements before row 0, and from each row's end to
  // the next row's data
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (tid < kRun) q[tid] = zero;
  const int tail = pitch - w;
  for (int i = tid; i < kPolyPlanes * h * tail; i += nthr) {
    const int row = i / tail;
    q[row * pitch + kRun + w + (i - row * tail)] = zero;
  }
  // T's zeros: the 7 rows before each plane and after the last, and the
  // spare rows
  const int vecs = pitch / kRun;             // 16-byte vectors per row
  const int halo_rows = (kPolyPlanes + 1) * kRad + kMaxRows - 1;
  for (int i = tid; i < halo_rows * vecs; i += nthr) {
    const int zr = i / vecs;
    const int row = zr < (kPolyPlanes + 1) * kRad
        ? (zr / kRad) * (h + kRad) + zr % kRad
        : kPolyPlanes * (h + kRad) + zr - kPolyPlanes * kRad;
    reinterpret_cast<uint4*>(t + row * pitch)[i - zr * vecs] =
        make_uint4(0u, 0u, 0u, 0u);
  }

  VFD_STAMP(2);                              // tables and zeros written
  // stage A of round 0
  {
    Walk3 at(tid, nthr, h, w);               // (0, y, x)
    for (int pix = tid; pix < hw; pix += nthr, at.next())
      store_quantities<kWarp>(p1, p2, hw, h, w, at.b, at.c, flow[pix],
                              flow[hw + pix], q, pitch);
  }
  __syncthreads();
  VFD_STAMP(3);                              // stage A of round 0

  const int runs = pitch / kRun - 1;
  const int w_items = runs * kPolyPlanes * h;
  const int h_items = ((h + MH - 1) / MH) * w;
  const int plane = (h + kRad) * pitch;
  for (int it = 0; it < iters; ++it) {
    {
      // lanes along the rows, or, in global memory, along a row's runs
      Walk3 at(tid, nthr, kGlobal ? h : kPolyPlanes, kGlobal ? runs : h);
      for (int e = tid; e < w_items; e += nthr, at.next()) {
        const int x0 = (kGlobal ? at.c : at.a) * kRun;
        const int c = kGlobal ? at.a : at.b, y = kGlobal ? at.b : at.c;
        const uint4* src = reinterpret_cast<const uint4*>(
            q + (c * h + y) * pitch + x0);
        uint4 res;
        if (x0 >= kRad && x0 + kRun - 1 + kRad < w)
          res = blur_w_run<true>(src, bw, x0, w, bw[x0 * kBandPitch + kRad]);
        else
          res = blur_w_run<false>(src, bw, x0, w, 0.0f);
        *reinterpret_cast<uint4*>(
            t + (c * (h + kRad) + kRad + y) * pitch + x0) = res;
      }
    }
    __syncthreads();
    VFD_STAMP(4 + 2 * it);                   // the W pass

    const bool last = !kWarp || it + 1 == iters;
    {
      Walk3 at(tid, nthr, (h + MH - 1) / MH, w);   // (0, row group, x)
      for (int e = tid; e < h_items; e += nthr, at.next()) {
        const int y0 = at.b * MH, xx = at.c;
        const unsigned short* col =
            reinterpret_cast<const unsigned short*>(t) + y0 * pitch + xx;
        float g[MH][kPolyPlanes];
        if (y0 >= kRad && y0 + MH - 1 + kRad < h)
          blur_h_item<MH, true>(col, plane, pitch, bh, y0, h,
                                bh[y0 * kBandPitch + kRad], g);
        else
          blur_h_item<MH, false>(col, plane, pitch, bh, y0, h, 0.0f, g);
#pragma unroll
        for (int o = 0; o < MH; ++o) {
          const int yy = y0 + o;
          if (yy >= h) break;
          float fx, fy;
          solve2x2(g[o], &fx, &fy);
          if (last) {
            out[yy * w + xx] = fx;
            out[hw + yy * w + xx] = fy;
          } else {
            store_quantities<kWarp>(p1, p2, hw, h, w, yy, xx, fx, fy, q,
                                    pitch);
          }
        }
      }
    }
    if (!last) __syncthreads();
    VFD_STAMP(5 + 2 * it);                   // the H pass, solve, next A
  }
  VFD_STAMP(14);
  VFD_STAMP(15);
}

template <bool kWarp, int MH, bool kGlobal>
__global__ void __launch_bounds__(kSolverThreads, 2)
solver_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
              const float* __restrict__ flow,
              const float* __restrict__ band_h,
              const float* __restrict__ band_w, float* __restrict__ out,
              __nv_bfloat16* scratch, int h, int w, int iters) {
  refine_field<kWarp, MH, kGlobal>(p1, p2, flow, band_h, band_w, out, scratch,
                                   h, w, iters);
}

// Where one field's scratch lives and how its block is shaped: the two
// band tables always in shared memory; Q and T there too when they fit,
// else in a global workspace of `workspace` bytes per field.  `rows` is
// the H-pass item's height: the largest of 4, 2, 1 that still gives half
// of the block's threads an item each, so that a small plane is spread
// over more threads with a shorter chain of work each (on an H100, 240
// fields: 4 rows at 64^2 and 32^2, 2 at 16^2 were the fastest).
struct FieldPlan {
  size_t smem;
  size_t workspace;
  int rows;
  int threads;
};

inline FieldPlan plan_field(int h, int w, int smem_limit) {
  const FieldLayout lay = field_layout(h, w);
  const size_t tables = sizeof(float) * static_cast<size_t>(h + w) *
                        kBandPitch;
  const size_t scratch = sizeof(__nv_bfloat16) *
      (static_cast<size_t>(lay.q_elems) + lay.t_elems);
  FieldPlan plan;
  const bool fits = tables + scratch <= static_cast<size_t>(smem_limit);
  plan.smem = fits ? tables + scratch : tables;
  plan.workspace = fits ? 0 : scratch;
  plan.rows = 1;
  for (int rows = kMaxRows; rows > 1 && plan.rows == 1; rows /= 2)
    if (!fits || 2 * w * ((h + rows - 1) / rows) >= kSolverThreads)
      plan.rows = rows;
  // a thread for every item of the richer pass, up to the kernel's bound
  const int h_items = w * ((h + plan.rows - 1) / plan.rows);
  const int w_items = (lay.pitch / kRun - 1) * kPolyPlanes * h;
  const int items = h_items > w_items ? h_items : w_items;
  plan.threads = items >= kSolverThreads ? kSolverThreads
                                         : 32 * ((items + 31) / 32);
  return plan;
}

// The current device's opt-in shared-memory limit per block.
inline cudaError_t smem_limit(int* out) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

template <bool kWarp, int MH, bool kGlobal>
cudaError_t launch_variant(const float* p1, const float* p2,
                           const float* flow, const float* band_h,
                           const float* band_w, float* out, void* workspace,
                           long long n, int h, int w, int iters,
                           const FieldPlan& plan, cudaStream_t stream) {
  static SmemOptin optin;                    // one per kernel variant
  int limit = 0;
  const cudaError_t err = optin.limit(solver_kernel<kWarp, MH, kGlobal>,
                                      &limit, /*prefer_shared=*/true);
  if (err != cudaSuccess) return err;
  solver_kernel<kWarp, MH, kGlobal>
      <<<static_cast<unsigned>(n), plan.threads, plan.smem, stream>>>(
          p1, p2, flow, band_h, band_w, out,
          static_cast<__nv_bfloat16*>(workspace), h, w, iters);
  return cudaGetLastError();
}

// Check the operands, plan the field and launch the variant the plan
// names: the body of both C entry points.  `workspace` holds
// plan.workspace bytes per field when that is non-zero.
template <bool kWarp>
cudaError_t launch_solver(const float* p1, const float* p2,
                          const float* flow, const float* band_h,
                          const float* band_w, float* out, void* workspace,
                          long long n, int h, int w, int k, int iters,
                          void* stream) {
  // the kernels are built for 15 taps; indices inside a field are 32-bit
  if (n <= 0 || n > 0x7fffffffLL || h <= 0 || w <= 0 || k != kWin ||
      iters < 1 || static_cast<long long>(h) * w > (1LL << 27))
    return cudaErrorInvalidValue;
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const FieldPlan plan = plan_field(h, w, limit);
  if (plan.smem > static_cast<size_t>(limit))
    return cudaErrorInvalidValue;                 // tables alone too large
  if (plan.workspace != 0 && workspace == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VFD_LAUNCH(MH, GLOBAL)                                             \
  launch_variant<kWarp, MH, GLOBAL>(p1, p2, flow, band_h, band_w, out,     \
                                    workspace, n, h, w, iters, plan, s)
  if (plan.workspace != 0) return VFD_LAUNCH(4, true);
  if (plan.rows == 4) return VFD_LAUNCH(4, false);
  if (plan.rows == 2) return VFD_LAUNCH(2, false);
  return VFD_LAUNCH(1, false);
#undef VFD_LAUNCH
}

}  // namespace vfd
