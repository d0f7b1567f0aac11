// Shared by the port's kernels: the launch-error convention of the C
// interface. Every exported launcher returns cudaGetLastError() as an int,
// which the Python wrapper raises on (a refused launch never runs, and
// torch.cuda.synchronize() would not report it).
#pragma once
#include <cuda_runtime.h>

#define MFM_EXPORT extern "C" __attribute__((visibility("default")))

static inline int mfm_last_error() { return static_cast<int>(cudaGetLastError()); }
