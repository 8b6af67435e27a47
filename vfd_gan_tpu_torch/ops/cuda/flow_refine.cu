// One Farneback refinement solve from already-warped planes.
//
// Replaces vfd_gan_tpu/ops/pallas/flow_refine.py::_refine_kernel: from
// frame 1's polynomial planes p1, frame 2's planes warped by the flow, w2
// (both (N, 5, H, W)), and the flow (N, 2, H, W), build the five
// normal-equation quantities, box-blur them (winsize k, replicate border,
// the JAX bfloat16-operand contract) and solve the 2x2 system per pixel.
// The math is vfd_gan_tpu/ops/flow.py:216-241 and lives in
// flow_common.cuh, shared with the fused kernel (flow_fused.cu).
//
// What bounds it on an H100: latency, not bytes or FLOPs.  Per pixel it
// reads 12 floats and writes 2; the blur is 2 x 5 x k multiply-adds.  At
// the train step's 64^2 level (240 fields) that is 14 MB and 0.15 GFLOP.
// The TPU kernel kept a field's intermediates in VMEM; here one block
// takes one field and keeps its quantity maps and W-pass maps, bfloat16
// as the contract rounds them anyway, in shared memory (80 KB at 64^2,
// two blocks per SM) or, for planes too large for that (128^2 at
// flow_scale 1.0), in a global workspace that stays mostly in L2.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/flow_refine.py::flow_refine_step_cuda.

#include <cuda_runtime.h>

#include "flow_common.cuh"
#include "launch_common.cuh"

namespace {

__global__ void __launch_bounds__(512)
refine_kernel(const float* __restrict__ p1, const float* __restrict__ w2,
              const float* __restrict__ flow, const float* __restrict__ band_h,
              const float* __restrict__ band_w, float* out,
              __nv_bfloat16* workspace, int h, int w, int k) {
  vfd::refine_field<false>(p1, w2, flow, band_h, band_w, out, workspace, h,
                           w, k, 1);
}

vfd::SmemOptin g_optin;

}  // namespace

// One refinement solve for n fields of h x w.  `workspace` holds
// vfd_flow_workspace_bytes(h, w, k) bytes per field when that is non-zero
// and may be null otherwise.  Launches on `stream`, does not synchronise,
// returns a cudaError_t.
extern "C" int vfd_flow_refine_f32(const float* p1, const float* w2,
                                   const float* flow, const float* band_h,
                                   const float* band_w, float* out,
                                   void* workspace, long long n, int h, int w,
                                   int k, void* stream) {
  int limit = 0;
  cudaError_t err = g_optin.limit(refine_kernel, &limit);
  if (err != cudaSuccess) return err;
  const vfd::FieldPlan plan = vfd::plan_field(h, w, k, limit);
  err = vfd::check_field_args(n, h, w, k, workspace != nullptr, plan, limit);
  if (err != cudaSuccess) return err;
  refine_kernel<<<static_cast<unsigned>(n), vfd::field_threads(h, w),
                  plan.smem, static_cast<cudaStream_t>(stream)>>>(
      p1, w2, flow, band_h, band_w, out,
      plan.workspace ? static_cast<__nv_bfloat16*>(workspace) : nullptr, h, w,
      k);
  return static_cast<int>(cudaGetLastError());
}
