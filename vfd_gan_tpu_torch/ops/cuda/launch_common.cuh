// Host-side helpers shared by the kernels' C entry points.
//
// A block may use more than 48 KB of dynamic shared memory only after
// cudaFuncSetAttribute raises the kernel's limit.  Querying the device and
// setting the attribute costs tens of microseconds of host time, so it is
// done once per (kernel, device): the limit is raised to the device's
// opt-in maximum, which covers every size a later launch asks for.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace vfd {

constexpr int kMaxDevices = 64;

class SmemOptin {
 public:
  // The current device's opt-in shared-memory limit per block, with
  // `kernel` allowed to use all of it.  `prefer_shared` also asks for the
  // largest shared-memory carveout, for a kernel that wants several blocks
  // of tens of KB on one SM.  Returns a cudaError_t.
  template <typename Kernel>
  cudaError_t limit(Kernel kernel, int* out, bool prefer_shared = false) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    if (limit_[device] == 0) {
      int bytes = 0;
      err = cudaDeviceGetAttribute(
          &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      if (prefer_shared) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
      }
      limit_[device] = bytes;
    }
    *out = limit_[device];
    return cudaSuccess;
  }

 private:
  std::mutex mu_;
  int limit_[kMaxDevices] = {};
};

}  // namespace vfd
