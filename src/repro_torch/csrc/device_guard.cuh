// device_guard.cuh: the current device of a C entry's scope.
//
// Every C entry launches on the card its tensors live on, which need not be
// the calling thread's current device. DeviceGuard makes `device` current
// for the entry's scope and gives the caller's device back when the scope
// ends, on every return path, the early error returns included: a launch
// on cuda:1 leaves a thread whose current device was 0 on device 0, so
// PyTorch's next `device="cuda"` allocation lands where it did before.
// It calls cudaSetDevice only when the device differs, so a launch on the
// current card costs one cudaGetDevice.
//
// The entries call cudaSetDevice only through this guard
// (tests/test_torch_build.py checks the sources).
#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess, or the error of reading or setting the device (the entry
  // returns it without launching).
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  cudaError_t err_ = cudaSuccess;
  bool restore_ = false;
};
