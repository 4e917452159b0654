// Good: the grid's division is guarded by a `%` check on the same
// operands in the launching function (CU502).
#include <cuda_runtime.h>

template <typename T>
__global__ void flash_kernel(const T* q, const T* k, const T* v, T* out,
                             int Sq, int Skv, int D) {}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int q_blk, void* stream) {
  if (q_blk < 1 || Sq % q_blk != 0) return (int)cudaErrorInvalidValue;
  flash_kernel<T><<<dim3(Sq / q_blk, BH), 256, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sq, 64);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* out, int BH,
                                          int Sq, int q_blk, void* stream) {
  return launch<float>(q, k, v, out, BH, Sq, q_blk, stream);
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           int BH, int Sq, int q_blk,
                                           void* stream) {
  return launch<short>(q, k, v, out, BH, Sq, q_blk, stream);
}
