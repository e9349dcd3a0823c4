// Shared by every kernel library of the port: each .cu is built into its own
// shared library with a plain C interface (see kernels/_build.py), and each
// exports the error-string helper the Python wrapper reports failures with.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launchers return the launch's cudaGetLastError() code (0 = enqueued); the
// wrapper raises on anything else. A refused launch never runs, and a later
// synchronize would not report it.
static inline int repro_last_error() {
  return static_cast<int>(cudaGetLastError());
}
