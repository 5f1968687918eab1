// Launch settings that CUDA keeps per device.
//
// A kernel's dynamic shared-memory limit (cudaFuncSetAttribute) and the
// SM count belong to the device that is current at the call, so a process
// that launches on several devices sets and reads them on each.  The
// wrappers make the operands' device current around every launcher call
// (kernels/_build.py::on_device).
#pragma once

#include <cuda_runtime.h>

namespace per_device {

constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in
constexpr int kMaxDevices = 64;

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device.  Set on every launch that needs more than the default: the
// setting is per device, and the call costs far less than the launch.
template <typename Kernel>
inline void allow_smem(Kernel kernel, size_t smem) {
  if (smem > kDefaultSmem)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// SM count of the current device, read once a device.
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < kMaxDevices ? sms[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev < kMaxDevices) sms[dev] = n;
  }
  return n;
}

}  // namespace per_device
