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
// What bounds it on an H100: instruction issue and the loads of stage A,
// then latency.  Every byte after the first round's reads stays on chip
// (frame planes in L2, maps in shared memory), and the function's
// arithmetic (about 400 operations per pixel and round, three quarters of
// them the blur's multiply-adds) is a few microseconds of the float32 pipes
// at the train step's 240 fields of 64^2; what costs is everything issued
// around those multiply-adds.  So, as the TPU kernel kept a field in VMEM,
// one block keeps one field for all rounds with its bfloat16 quantity and
// W-pass maps in shared memory (107 KB at 64^2: two blocks per SM, all 240
// fields of a level resident in one wave), and the blur is tiled in
// registers: a thread loads the 22 inputs of 8 neighbouring outputs once,
// as three 16-byte words, or the 18 rows under 4 output pixels of a column
// in all five planes, and runs its 8 (or 20) sums side by side, each in the
// plain version's tap order.  Away from the borders the weight is one
// register; the zero rows and columns that frame the maps stand in for
// bounds tests; a thread walks its items by adding digits, with no division
// and no 64-bit index inside a field; and the flow stays in registers from
// one round's solve to the next round's warp.  What is left
// (vfd_gan_tpu_torch/tools/flow_stages.py times the stages): the two blur
// passes with the solve are about a third of the launch at 64^2; the warp
// and the quantities, 27 loads per pixel that go to L2 because the maps
// take the SM's shared memory, are the rest, the first round's, which reads
// the planes from device memory, a third of the launch alone.  Small planes
// (16^2) take fewer rows per thread, so that the chain of dependent stages
// a round consists of is spread over more threads; 128^2 planes (flow_scale
// 1.0) keep the maps in a global workspace (L2 and device memory).  Only
// winsize 15 is built.
//
// Built by vfd_gan_tpu_torch/ops/cuda/__init__.py; the Python wrapper is
// vfd_gan_tpu_torch/ops/flow_fused.py::flow_refine_fused_cuda.

#include <cuda_runtime.h>

#include "flow_common.cuh"

// Bytes of global workspace one field needs for planes of h x w and a
// k-tap blur on the current device: 0 when the scratch fits in shared
// memory.  Negative (a cudaError_t, negated) on failure.  Both the refine
// and the fused kernel use this layout.
extern "C" long long vfd_flow_workspace_bytes(int h, int w, int k) {
  if (h <= 0 || w <= 0 || k != vfd::kWin ||
      static_cast<long long>(h) * w > (1LL << 27))
    return -static_cast<long long>(cudaErrorInvalidValue);
  int limit = 0;
  const cudaError_t err = vfd::smem_limit(&limit);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const vfd::FieldPlan plan = vfd::plan_field(h, w, limit);
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
  return static_cast<int>(vfd::launch_solver<true>(
      p1, p2, flow, band_h, band_w, out, workspace, n, h, w, k, iters,
      stream));
}

#ifdef VFD_STAGE_CLOCKS
// Copies this kernel's stage clocks (flow_common.cuh) to `dst`:
// 1024 blocks x 16 slots of 8 bytes.  Synchronises.
extern "C" int vfd_flow_fused_stage_clocks(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, vfd::g_stage_clock, sizeof(vfd::g_stage_clock)));
}
#endif
