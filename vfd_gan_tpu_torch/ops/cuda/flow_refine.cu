// One Farneback refinement solve from already-warped planes.
//
// Replaces vfd_gan_tpu/ops/pallas/flow_refine.py::_refine_kernel: from
// frame 1's polynomial planes p1, frame 2's planes warped by the flow, w2
// (both (N, 5, H, W)), and the flow (N, 2, H, W), build the five
// normal-equation quantities, box-blur them (winsize 15, replicate border,
// the JAX bfloat16-operand contract) and solve the 2x2 system per pixel.
// The math is vfd_gan_tpu/ops/flow.py:216-241 and lives in
// flow_common.cuh, shared with the fused kernel (flow_fused.cu): this
// kernel is one round of that one without the warp.
//
// What bounds it on an H100: by the function, bytes (12 floats read and 2
// written per pixel, 14 MB at the train step's 240 fields of 64^2, against
// 0.15 GFLOP); in practice the instructions issued around the blur's
// multiply-adds.  The TPU kernel kept a field's intermediates in VMEM;
// here one block takes one field and keeps its quantity maps and W-pass
// maps, bfloat16 as the contract rounds them anyway, in shared memory (two
// blocks per SM at 64^2) or, for planes too large for that (128^2 at
// flow_scale 1.0), in a global workspace that stays mostly in L2.  The
// blur is tiled in registers as flow_fused.cu's header note says: each
// input is loaded once per run of 8 outputs (W pass) or per 4 output rows
// of a column (H pass), the sums of a thread are independent chains, the
// interior weight is a register, and no index inside a field is divided or
// 64-bit.  Reading the 12 input planes is now more than half of the launch
// (vfd_gan_tpu_torch/tools/flow_stages.py): all blocks of a level load,
// then all blur, so the memory idles while they compute.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/flow_refine.py::flow_refine_step_cuda.

#include <cuda_runtime.h>

#include "flow_common.cuh"

// One refinement solve for n fields of h x w.  `workspace` holds
// vfd_flow_workspace_bytes(h, w, k) bytes per field when that is non-zero
// and may be null otherwise.  Launches on `stream`, does not synchronise,
// returns a cudaError_t.
extern "C" int vfd_flow_refine_f32(const float* p1, const float* w2,
                                   const float* flow, const float* band_h,
                                   const float* band_w, float* out,
                                   void* workspace, long long n, int h, int w,
                                   int k, void* stream) {
  return static_cast<int>(vfd::launch_solver<false>(
      p1, w2, flow, band_h, band_w, out, workspace, n, h, w, k, 1, stream));
}

#ifdef VFD_STAGE_CLOCKS
// Copies this kernel's stage clocks (flow_common.cuh) to `dst`:
// 1024 blocks x 16 slots of 8 bytes.  Synchronises.
extern "C" int vfd_flow_refine_stage_clocks(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, vfd::g_stage_clock, sizeof(vfd::g_stage_clock)));
}
#endif
