// The whole Farneback refinement loop of one pyramid level in one launch.
//
// Replaces vfd_gan_tpu/ops/pallas/flow_fused.py::_fused_kernel: for each
// field, `iters` rounds of {bilinear-warp frame 2's five polynomial planes
// by the flow carry, build the normal-equation quantities, box-blur them,
// solve the 2x2 system}.  The math is the XLA body of
// vfd_gan_tpu/ops/flow.py::_flow_level and lives in flow_common.cuh,
// shared with flow_refine.cu; unlike the TPU kernel, fy is not clamped to
// a warp band.
//
// What bounds it on an H100: latency and block-level parallelism.  The
// arithmetic is small (about 200 FLOP per pixel per round) and every byte
// after the first round's reads stays on chip, so the cost is the three
// dependent stages per round and the gathers of the warp.  As the TPU
// kernel kept a field in VMEM, one block here takes one field for all
// rounds: the warped values go straight into the quantity build, the
// bfloat16 quantity and W-pass maps sit in shared memory (80 KB at 64^2,
// so two fields per SM and all 240 fields of a train step's level
// resident at once), the flow carry is the block's own slice of `out`,
// and HBM sees p1, p2 and the first flow once.  128^2 planes
// (flow_scale 1.0) keep the maps in a global workspace instead.  Faster
// forms (row tiles over a cluster, TMA loads) are later work.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/flow_fused.py::flow_refine_fused_cuda.

#include <cuda_runtime.h>

#include "flow_common.cuh"
#include "launch_common.cuh"

namespace {

__global__ void __launch_bounds__(512)
fused_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
             const float* __restrict__ flow, const float* __restrict__ band_h,
             const float* __restrict__ band_w, float* out,
             __nv_bfloat16* workspace, int h, int w, int k, int iters) {
  vfd::refine_field<true>(p1, p2, flow, band_h, band_w, out, workspace, h, w,
                          k, iters);
}

vfd::SmemOptin g_optin;

}  // namespace

// Bytes of global workspace one field needs for planes of h x w and a
// k-tap blur on the current device: 0 when the scratch fits in shared
// memory.  Negative (a cudaError_t, negated) on failure.  Both the refine
// and the fused kernel use this layout.
extern "C" long long vfd_flow_workspace_bytes(int h, int w, int k) {
  if (h <= 0 || w <= 0 || k < 1) return -static_cast<long long>(
      cudaErrorInvalidValue);
  int limit = 0;
  const cudaError_t err = g_optin.limit(fused_kernel, &limit);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const vfd::FieldPlan plan = vfd::plan_field(h, w, k, limit);
  if (plan.smem > static_cast<size_t>(limit))
    return -static_cast<long long>(cudaErrorInvalidValue);
  return static_cast<long long>(plan.workspace);
}

// `iters` refinement rounds for n fields of h x w in one launch; see
// vfd_flow_refine_f32 for the operands.
extern "C" int vfd_flow_fused_f32(const float* p1, const float* p2,
                                  const float* flow, const float* band_h,
                                  const float* band_w, float* out,
                                  void* workspace, long long n, int h, int w,
                                  int k, int iters, void* stream) {
  if (iters < 1) return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = g_optin.limit(fused_kernel, &limit);
  if (err != cudaSuccess) return err;
  const vfd::FieldPlan plan = vfd::plan_field(h, w, k, limit);
  err = vfd::check_field_args(n, h, w, k, workspace != nullptr, plan, limit);
  if (err != cudaSuccess) return err;
  fused_kernel<<<static_cast<unsigned>(n), vfd::field_threads(h, w),
                 plan.smem, static_cast<cudaStream_t>(stream)>>>(
      p1, p2, flow, band_h, band_w, out,
      plan.workspace ? static_cast<__nv_bfloat16*>(workspace) : nullptr, h, w,
      k, iters);
  return static_cast<int>(cudaGetLastError());
}
