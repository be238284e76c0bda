// The current-device guard of the slim launch path (utils/launch.py).
//
// An entry on that path takes the card's index from the wrapper instead of
// the wrapper entering `with torch.cuda.device(...)` around the call: the
// guard makes `device` current only when it is not already (one
// thread-local read in the common case) and restores the caller's device
// when the entry returns.  Read the launch's cudaGetLastError() before the
// guard goes out of scope (a `return` expression is evaluated first).

#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : want_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ != cudaSuccess) prev_ = device;  // nothing to restore
    else if (prev_ != device) err_ = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev_ != want_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  // cudaSuccess, or why the device could not be made current
  int error() const { return static_cast<int>(err_); }

 private:
  cudaError_t err_;
  int prev_ = 0;
  int want_ = 0;
};
