// Morphological opening (erode, then dilate) of a float32 tensor in the
// layout it has: a k x k window over two axes (P, Q) of a four-axis view
// (O, P, Q, L) given by its strides, for every outer index o and lane l.
//
// Replaces vfd_gan_tpu/ops/pallas/morphology.py::_open_kernel: a separable
// windowed min with a +inf border (erode), then the matching max with a
// -inf border (dilate).  The TPU kernel took contiguous (N, P, Q) planes,
// so its caller first copied the opening plane of the video to the trailing
// axes.  Here the channel-last (B, T, H, W, C) video is read where it lies:
//  * the "th" plane (the reference's cv2 quirk) is O = B, P = T, Q = H and
//    L = W * C contiguous lanes;
//  * the "hw" plane is O = B * T, P = H, Q = W, L = C;
//  * contiguous (N, P, Q) planes are L = 1.
// The result is written with strides of its own, so it is contiguous in
// the video's layout and nothing is copied before or after the launch.
//
// What bounds it on an H100: bytes.  4(k - 1) compares per element against
// one float32 read and one written: 16.8 MB for the serve batch (8 x 16 x
// 128 x 128 x 1), 5.0 us at the 3.35 TB/s of an H100 SXM's data sheet, so
// the design is about memory transactions and latency, not arithmetic:
//  * A block owns a tile of tp x tq x tl outputs and stages its region
//    (a 2r halo in P and Q, r = k / 2) in shared memory as rows [p][x] with
//    x = q * tl + l: the lanes run fastest, as in memory, so a warp's 32
//    neighbouring x are one 128-byte request wherever L >= 32 or the row
//    (Q, L) is contiguous.
//  * The region is loaded flat by all threads, eight loads in flight per
//    thread: the load is latency, and loads in flight are what hides it.
//    In the four passes one warp owns a row, a barrier between passes.
//  * Where the lanes are contiguous and L, the tile and the strides are
//    multiples of four (the "th" plane), a thread moves four columns at a
//    time: 16-byte loads, shared-memory accesses and stores, one access
//    and one address where there were four, which is what the passes cost.
//  * No division or clipping in the loops: a 2 x rx table made once per
//    block maps x to its input and output offsets (-1 outside the plane);
//    out-of-plane columns hold +inf for the erode and -inf for the dilate,
//    which is the border rule itself; the P window is clamped to the
//    region, a warp-uniform scalar, and a repeated row changes no min or
//    max.  All shared-memory reads are lane-consecutive: no bank conflicts.
//  * min and max are exact, so any pass order and tiling is bit-equal to
//    the plain version (ops/morphology.py::open_planes_plain).
// Times on the card: PERF.md section 6, row 1.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py with nvcc into a shared
// library with a plain C interface; the Python wrapper is
// vfd_gan_tpu_torch/ops/morphology.py::open_planes_cuda.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "launch_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 8;     // loads a thread has in flight
// Shared memory a block may plan for when the tile is chosen here: half of
// an SM's, so that two blocks overlap each other's loads and passes.
constexpr long long kAutoSmemBytes = 108 * 1024;

struct OpenArgs {
  const float* x;
  float* out;
  int p, q, l;                       // sizes of the window axes and lanes
  long long xs_o, xs_p, os_o, os_p;  // strides in elements: outer and P
  int xs_q, xs_l, os_q, os_l;        // ... Q and lanes
  int r;                             // k / 2
  int tp, tq, tl;                    // the tile
  int tiles_p, tiles_q, tiles_l;
  int rp_max, rx_max;                // the region's rows and row length
};

// V floats that move as one: 16-byte shared-memory and device-memory
// accesses where V = 4.
template <int V>
struct alignas(4 * V) Pack {
  float v[V];
};

template <int V, bool kMin>
__device__ __forceinline__ Pack<V> pick(Pack<V> a, const Pack<V>& b) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    a.v[i] = kMin ? fminf(a.v[i], b.v[i]) : fmaxf(a.v[i], b.v[i]);
  return a;
}

template <int V>
__device__ __forceinline__ Pack<V> splat(float f) {
  Pack<V> out;
#pragma unroll
  for (int i = 0; i < V; ++i) out.v[i] = f;
  return out;
}

template <int V>
__device__ __forceinline__ Pack<V> load_global(const float* p) {
  Pack<V> out;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    out.v[0] = t.x;
    out.v[1] = t.y;
    out.v[2] = t.z;
    out.v[3] = t.w;
  } else {
    out.v[0] = __ldg(p);
  }
  return out;
}

template <int V>
__device__ __forceinline__ void store_global(float* p, const Pack<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.v[0], v.v[1], v.v[2],
                                                v.v[3]);
  } else {
    *p = v.v[0];
  }
}

// dst[u] = pick over src[u + d * step], d in [-r, r], for u in [lo, hi).
template <int R, int V, bool kMin>
__device__ __forceinline__ void q_pass(const Pack<V>* src, Pack<V>* dst,
                                       int lo, int hi, int step, int r,
                                       int lane) {
#pragma unroll 2
  for (int u = lo + lane; u < hi; u += 32) {
    const Pack<V>* s = src + u - r * step;
    Pack<V> acc = s[0];
    if (R > 0) {
#pragma unroll
      for (int t = 1; t <= 2 * R; ++t) acc = pick<V, kMin>(acc, s[t * step]);
    } else {
      for (int t = 1; t <= 2 * r; ++t) acc = pick<V, kMin>(acc, s[t * step]);
    }
    dst[u] = acc;
  }
}

// pick over rows p - r .. p + r of `src` (row length rxu) at column u, the
// rows clamped to [0, rp): a repeated row changes nothing.
template <int R, int V, bool kMin>
__device__ __forceinline__ Pack<V> p_window(const Pack<V>* src, int p, int u,
                                            int rxu, int rp, int r) {
  Pack<V> acc = src[max(p - r, 0) * rxu + u];
  if (R > 0) {
#pragma unroll
    for (int t = 1; t <= 2 * R; ++t)
      acc = pick<V, kMin>(
          acc, src[min(max(p - R + t, 0), rp - 1) * rxu + u]);
  } else {
    for (int t = 1; t <= 2 * r; ++t)
      acc = pick<V, kMin>(
          acc, src[min(max(p - r + t, 0), rp - 1) * rxu + u]);
  }
  return acc;
}

// grid.x = O x tiles_p x tiles_q x tiles_l.  R = r when it is 1 or 2 (the
// windows unroll), 0 for any other r.  V = 4 where the lanes are contiguous
// and everything is a multiple of four floats (the entry point checks):
// columns then move four at a time, u = x / 4.
template <int R, int V>
__global__ void __launch_bounds__(kThreads)
open_kernel(const OpenArgs a) {
  extern __shared__ float4 smem4[];
  const int r = R > 0 ? R : a.r;
  int tile = blockIdx.x;
  const int il = tile % a.tiles_l;
  tile /= a.tiles_l;
  const int iq = tile % a.tiles_q;
  tile /= a.tiles_q;
  const int ip = tile % a.tiles_p;
  const long long o = tile / a.tiles_p;
  const int p0 = ip * a.tp;
  const int q0 = iq * a.tq;
  const int l0 = il * a.tl;
  const int tl = min(a.tl, a.l - l0);            // lanes of this tile
  const int rp0 = max(p0 - 2 * r, 0);            // region rows: clipped
  const int rp = min(p0 + a.tp + 2 * r, a.p) - rp0;
  const int rxu = (a.tq + 4 * r) * tl / V;       // region columns: padded
  const int halo = r * tl / V;

  Pack<V>* buf_a = reinterpret_cast<Pack<V>*>(smem4);
  Pack<V>* buf_b = buf_a + a.rp_max * (a.rx_max / V);
  int* x_in = reinterpret_cast<int*>(buf_b + a.rp_max * (a.rx_max / V));
  int* x_out = x_in + a.rx_max / V;

  for (int u = threadIdx.x; u < rxu; u += kThreads) {
    const int qi = u * V / tl;
    const int l = l0 + u * V - qi * tl;
    const int q = q0 - 2 * r + qi;
    const bool inside = q >= 0 && q < a.q;
    x_in[u] = inside ? q * a.xs_q + l * a.xs_l : -1;
    x_out[u] = inside && qi >= 2 * r && qi < 2 * r + a.tq
                   ? q * a.os_q + l * a.os_l : -1;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // load the region, +inf outside the plane.  The threads walk it flat,
  // (row, u) advanced without a division, kLoads loads started before the
  // first is used: what hides the latency of device memory here is loads
  // in flight.
  const float* src = a.x + o * a.xs_o + rp0 * a.xs_p;
  {
    int row = threadIdx.x / rxu;
    int u = threadIdx.x - row * rxu;
    while (row < rp) {
      Pack<V> v[kLoads];
      int at[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        at[i] = row < rp ? row * rxu + u : -1;
        const int off = row < rp ? x_in[u] : -1;
        v[i] = off >= 0 ? load_global<V>(src + row * a.xs_p + off)
                        : splat<V>(INFINITY);
        u += kThreads;
        while (u >= rxu) {
          u -= rxu;
          ++row;
        }
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        if (at[i] >= 0) buf_a[at[i]] = v[i];
    }
  }
  __syncthreads();

  // erode along Q: buf_a -> buf_b
  for (int p = warp; p < rp; p += kWarps)
    q_pass<R, V, true>(buf_a + p * rxu, buf_b + p * rxu, halo, rxu - halo,
                       tl / V, r, lane);
  __syncthreads();

  // erode along P, with -inf outside the plane (the dilate's border):
  // buf_b -> buf_a
  for (int p = warp; p < rp; p += kWarps) {
    Pack<V>* row = buf_a + p * rxu;
#pragma unroll 2
    for (int u = halo + lane; u < rxu - halo; u += 32) {
      const Pack<V> acc = p_window<R, V, true>(buf_b, p, u, rxu, rp, r);
      row[u] = x_in[u] >= 0 ? acc : splat<V>(-INFINITY);
    }
  }
  __syncthreads();

  // dilate along Q: buf_a -> buf_b
  for (int p = warp; p < rp; p += kWarps)
    q_pass<R, V, false>(buf_a + p * rxu, buf_b + p * rxu, 2 * halo,
                        rxu - 2 * halo, tl / V, r, lane);
  __syncthreads();

  // dilate along P for the tile's own rows, straight to device memory
  const int t0 = p0 - rp0;
  const int t1 = t0 + min(a.tp, a.p - p0);
  float* dst = a.out + o * a.os_o + rp0 * a.os_p;
  for (int p = t0 + warp; p < t1; p += kWarps) {
    float* row = dst + p * a.os_p;
#pragma unroll 2
    for (int u = 2 * halo + lane; u < rxu - 2 * halo; u += 32) {
      const int off = x_out[u];
      if (off >= 0)
        store_global<V>(row + off,
                        p_window<R, V, false>(buf_b, p, u, rxu, rp, r));
    }
  }
}

vfd::SmemOptin g_optin[3][2];

template <int R, int V>
cudaError_t launch(const OpenArgs& a, long long blocks, size_t smem,
                   cudaStream_t stream) {
  int smem_limit = 0;
  const cudaError_t err =
      g_optin[R][V == 4].limit(open_kernel<R, V>, &smem_limit);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_limit)) return cudaErrorInvalidValue;
  open_kernel<R, V>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_r(const OpenArgs& a, long long blocks, size_t smem,
                     cudaStream_t stream) {
  if (a.r == 1) return launch<1, V>(a, blocks, smem, stream);
  if (a.r == 2) return launch<2, V>(a, blocks, smem, stream);
  return launch<0, V>(a, blocks, smem, stream);
}

// A stride that keeps 16-byte alignment, or an axis of one element, whose
// stride is never used.
bool by_four(long long n, long long stride) {
  return n == 1 || stride % 4 == 0;
}

long long smem_bytes(long long rp, long long rx) {
  return (2 * rp * rx + 2 * rx) * static_cast<long long>(sizeof(float));
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// Opening with a k x k square (k odd) over the axes P and Q of the float32
// view x[o][p][q][l] at element strides xs, written to out[o][p][q][l] at
// strides os.  tp, tq, tl give the tile of one block; 0 lets this function
// choose.  Launches on `stream` and does not synchronise.  Returns a
// cudaError_t: the launch's own (cudaGetLastError) or the reason it was
// not made.
extern "C" int vfd_morphology_open_f32(
    const float* x, float* out, long long o, int p, int q, int l,
    long long xs_o, long long xs_p, long long xs_q, long long xs_l,
    long long os_o, long long os_p, long long os_q, long long os_l, int k,
    int tp, int tq, int tl, void* stream) {
  if (o <= 0 || p <= 0 || q <= 0 || l <= 0 || k < 1 || k % 2 == 0 ||
      tp < 0 || tq < 0 || tl < 0)
    return cudaErrorInvalidValue;
  const int r = k / 2;
  // the tables hold a row's offsets q * stride + l * stride as 32-bit ints
  const long long kIntMax = 0x7fffffffLL;
  if (q * xs_q + l * xs_l > kIntMax || q * os_q + l * os_l > kIntMax ||
      xs_q < 0 || xs_l < 0 || os_q < 0 || os_l < 0)
    return cudaErrorInvalidValue;

  const bool auto_tp = tp == 0;
  if (tl == 0) tl = l >= 32 ? 32 : l;
  tl = tl < l ? tl : l;
  // few rows where the lanes fill the warps (the "th" plane: T = 16 whole),
  // more where a row is short
  if (auto_tp) tp = tl >= 32 ? 16 : 32;
  tp = tp < p ? tp : p;
  if (tq == 0) {
    // rows of about 1024 columns, the tiles of one size, within the budget
    const long long want = 1024 / tl - 4 * r;
    tq = static_cast<int>(want < 8 ? 8 : want);
    tq = tq < q ? tq : q;
    tq = static_cast<int>(ceil_div(q, ceil_div(q, tq)));
    const auto over = [&]() {
      const long long rp = tp + 4LL * r < p ? tp + 4LL * r : p;
      return smem_bytes(rp, (tq + 4LL * r) * tl) > kAutoSmemBytes;
    };
    while (tq > 1 && over()) {
      const long long next = ceil_div(q, ceil_div(q, tq) + 1);
      tq = static_cast<int>(next < tq ? next : tq - 1);
    }
    while (auto_tp && tp > 1 && over()) tp = (tp + 1) / 2;
  }
  tq = tq < q ? tq : q;

  OpenArgs a;
  a.x = x;
  a.out = out;
  a.p = p;
  a.q = q;
  a.l = l;
  a.xs_o = xs_o;
  a.xs_p = xs_p;
  a.os_o = os_o;
  a.os_p = os_p;
  a.xs_q = static_cast<int>(xs_q);
  a.xs_l = static_cast<int>(xs_l);
  a.os_q = static_cast<int>(os_q);
  a.os_l = static_cast<int>(os_l);
  a.r = r;
  a.tp = tp;
  a.tq = tq;
  a.tl = tl;
  a.tiles_p = static_cast<int>(ceil_div(p, tp));
  a.tiles_q = static_cast<int>(ceil_div(q, tq));
  a.tiles_l = static_cast<int>(ceil_div(l, tl));
  const long long rp = tp + 4LL * r < p ? tp + 4LL * r : p;
  const long long rx = (tq + 4LL * r) * tl;
  if (rp * rx > kIntMax) return cudaErrorInvalidValue;
  a.rp_max = static_cast<int>(rp);
  a.rx_max = static_cast<int>(rx);
  const long long blocks = o * a.tiles_p * a.tiles_q * a.tiles_l;
  if (blocks > kIntMax) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(rp, rx);

  if (smem > kIntMax) return cudaErrorInvalidValue;       // k too large
  // four columns at a time where the lanes are contiguous and every
  // offset a thread forms stays a multiple of four floats
  const bool vec =
      l % 4 == 0 && tl % 4 == 0 && xs_l == 1 && os_l == 1 &&
      by_four(q, xs_q) && by_four(p, xs_p) && by_four(o, xs_o) &&
      by_four(q, os_q) && by_four(p, os_p) && by_four(o, os_o) &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // the shared-memory opt-in is queried and granted once per kernel and
  // device (launch_common.cuh), not on every call
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  return vec ? launch_r<4>(a, blocks, bytes, s)
             : launch_r<1>(a, blocks, bytes, s);
}
