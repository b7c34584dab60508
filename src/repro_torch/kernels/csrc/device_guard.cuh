// Launch on a given device without paying for cudaSetDevice on every call.
//
// A wrapper is called from PyTorch with tensors on `device`, which is almost
// always the calling thread's current device already. cudaGetDevice reads a
// thread-local value; cudaSetDevice is only made (and undone after the
// launch) when the two differ, so the caller's current device is unchanged.
#pragma once
#include <cuda_runtime.h>

template <typename Launch>
cudaError_t on_device(int device, Launch&& launch) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current == device) return launch();
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaError_t launched = launch();
  err = cudaSetDevice(current);
  return launched != cudaSuccess ? launched : err;
}
