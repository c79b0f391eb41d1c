// The device of a launch.  The library links its own CUDA runtime and is
// loaded by ctypes, so PyTorch's current device does not reach it: every
// exported launcher takes the ordinal of its tensors' device, makes that
// device current for the launch (cudaSetDevice selects the device's primary
// context, the one PyTorch uses) and gives the caller's device back after.
#pragma once

#include <cuda_runtime.h>

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  // cudaSuccess, or why the device could not be made current
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_;
};
