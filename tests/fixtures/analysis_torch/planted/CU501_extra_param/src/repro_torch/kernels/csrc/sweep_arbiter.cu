// Good: includes the generated header, spells no shared constant, ceil
// grid (CU502, CU504); the launcher's ABI matches _bind (CU501).
#include <cuda_runtime.h>
#include "sweep_fields.h"

__global__ void sweep_arbiter_kernel(const int* age, const int* hit,
                                     int* score, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) score[i] = min(age[i], AGE_CAP) + (hit[i] ? W_HIT : 0);
}

extern "C" int sweep_arbiter_launch(const int* age, const int* hit,
                                    int* score, int n, int threads, int banks,
                                    void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + threads - 1) / threads;
  sweep_arbiter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      age, hit, score, n);
  return (int)cudaGetLastError();
}

extern "C" const char* sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
