// Host stand-ins for the CUDA runtime declarations the MRF kernel headers
// use, so that g++ can compile their __host__ __device__ layout code for
// the CPU (tests/test_torch_bf16_engine.py, test_torch_f32_engine.py).
// Declarations only: no kernel is instantiated or run.
#pragma once
#include <cstddef>
#include <cstdint>
#include <cmath>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern uint3 threadIdx, blockIdx, blockDim;
extern dim3 gridDim;
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
uint2 make_uint2(unsigned, unsigned);
uint4 make_uint4(unsigned, unsigned, unsigned, unsigned);
int2 make_int2(int, int);
float2 make_float2(float, float);
float4 make_float4(float, float, float, float);
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int);
cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t);
cudaError_t cudaGetLastError();
void __syncthreads();
template <class T> T __ldg(const T*);
float __fmul_rn(float, float);
float __fadd_rn(float, float);
float __uint_as_float(unsigned);
unsigned __float_as_uint(float);
float __int2float_rn(int);
unsigned __byte_perm(unsigned, unsigned, unsigned);
int min(int, int);
int max(int, int);
size_t __cvta_generic_to_shared(const void*);
int __shfl_sync(unsigned, int, int);
