// A host stand-in for the CUDA runtime and the warp intrinsics that kernels
// B and F (robogym_torch/csrc/cg_full.cu, cg.cu) use, so that their sources
// run on a CPU: one block is 32 std::threads, and every shuffle, vote and
// __syncwarp is a meeting of the 32 at a std::barrier. Float arithmetic is the host's in
// IEEE single precision; compiled with -ffp-contract=off it rounds as the
// card does under nvcc -fmad=false.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct uint3 {
  unsigned x, y, z;
};
extern thread_local uint3 threadIdx, blockIdx;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
typedef void* cudaStream_t;
struct float4 {
  float x, y, z, w;
};

namespace host_warp {
extern std::barrier<>* bar;
extern float xf[32];
extern int xi[32];
template <class T>
inline T exchange(T* slot, T v, int src) {
  slot[threadIdx.x] = v;
  bar->arrive_and_wait();
  const T r = slot[src & 31];
  bar->arrive_and_wait();
  return r;
}
}  // namespace host_warp

inline float __shfl_sync(unsigned, float v, int src) {
  return host_warp::exchange(host_warp::xf, v, src);
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return host_warp::exchange(host_warp::xf, v, (int)threadIdx.x ^ mask);
}
inline bool __any_sync(unsigned, bool p) {
  host_warp::xi[threadIdx.x] = p;
  host_warp::bar->arrive_and_wait();
  bool r = false;
  for (int i = 0; i < 32; ++i) r |= host_warp::xi[i] != 0;
  host_warp::bar->arrive_and_wait();
  return r;
}
inline void __syncwarp() { host_warp::bar->arrive_and_wait(); }
inline void __syncthreads() { host_warp::bar->arrive_and_wait(); }

template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
