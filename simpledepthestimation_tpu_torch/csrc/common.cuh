// What both kernel sources share: read-only loads that convert to float32,
// and the device guard of the C entry points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sde {

// loads through the read-only data path, converted to float32
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Makes `device` current for a launch and restores the caller's device after
// it, so that a wrapper needs no device context of its own (one cudaGetDevice
// in the usual case that it is current already).
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    int cur = 0;
    cudaGetDevice(&cur);
    if (cur != device) {
      cudaSetDevice(device);
      prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace sde
