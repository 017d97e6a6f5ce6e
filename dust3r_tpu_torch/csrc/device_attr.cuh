// A kernel's dynamic shared memory limit, raised on each device it runs on.
//
// cudaFuncSetAttribute acts on the kernel in the current device's context, so
// a limit raised once per process holds on the first card that launched the
// kernel only: on another card a launch asking for more than 48 KB would be
// refused. A launcher keeps one SmemLimit per kernel (a static of its
// template instance) and calls `raise_on_current_device` before each launch;
// the attribute is set the first time each device ordinal comes by.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace devattr {

class SmemLimit {
 public:
  template <typename Kernel>
  cudaError_t raise_on_current_device(Kernel* kernel, int bytes) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const bool tracked = device >= 0 && device < kMaxDevices;
    if (tracked && done_[device].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && tracked) done_[device].store(true, std::memory_order_release);
    return err;
  }

 private:
  static constexpr int kMaxDevices = 64;  // beyond: set before every launch
  std::atomic<bool> done_[kMaxDevices] = {};
};

}  // namespace devattr
