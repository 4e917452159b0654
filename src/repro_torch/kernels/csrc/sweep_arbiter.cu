// sweep_arbiter_kernel - per-(cell, bank) eligibility and packed int32
// arbitration score for one tick of the sweep engine.
//
// Replaces the TPU kernel `_arbiter_kernel` of the JAX package
// (repro/kernels/sweep_arbiter.py). Plain version:
// `arbiter_scores_torch` in repro_torch/kernels/sweep_arbiter.py.
//
// Bound by bytes: ten [G, B] int32 planes and drain [G] are read once
// and one [G, B] plane is written, against a dozen integer operations
// per element. One thread per element of the flat row-major planes, so
// each warp reads and writes whole contiguous 128-byte lines; `occ` may
// be null (the open-loop form: occupancy field 0).
#include <cuda_runtime.h>

#include "sweep_fields.h"
#include "sweep_score.cuh"

__global__ void sweep_arbiter_kernel(
    const int* __restrict__ has_req, const int* __restrict__ head_row,
    const int* __restrict__ head_arrive,
    const int* __restrict__ head_is_write,
    const int* __restrict__ bank_free,
    const int* __restrict__ head_ref_until,
    const int* __restrict__ bank_mid_ref, const int* __restrict__ open_row,
    const int* __restrict__ occ, const int* __restrict__ rank_drain,
    const int* __restrict__ drain, int* __restrict__ score, int t,
    long long n, int B) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long g = i / B;
  bool elig = has_req[i] != 0 && bank_free[i] <= t &&
              head_ref_until[i] <= t && rank_drain[i] == 0;
  int sc = arbiter_score(t, drain[g] != 0 && head_is_write[i] != 0,
                         occ ? occ[i] : 0, head_row[i] == open_row[i],
                         bank_mid_ref[i] != 0, head_arrive[i]);
  score[i] = elig ? sc : -1;
}

extern "C" int sweep_arbiter_launch(
    const int* has_req, const int* head_row, const int* head_arrive,
    const int* head_is_write, const int* bank_free,
    const int* head_ref_until, const int* bank_mid_ref,
    const int* open_row, const int* occ, const int* rank_drain,
    const int* drain, int* score, int t, int G, int B, void* stream) {
  long long n = (long long)G * B;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  sweep_arbiter_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      has_req, head_row, head_arrive, head_is_write, bank_free,
      head_ref_until, bank_mid_ref, open_row, occ, rank_drain, drain,
      score, t, n, B);
  return (int)cudaGetLastError();
}

extern "C" const char* sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
