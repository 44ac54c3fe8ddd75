// A host stand-in for the CUDA runtime and the warp intrinsics that kernels
// A, B and F (robogym_torch/csrc/spd_inverse.cu, cg_full.cu, cg.cu), the
// hull kernels (hull_sweep.cu) and the box-box kernel (boxbox.cu) use, so
// that their sources run on a CPU: a block is as many std::threads as it
// has threads, all running together; __syncthreads is a meeting of the
// whole block at one std::barrier, and every shuffle, vote and __syncwarp a
// meeting of the warp's 32 at the warp's own barrier, with the warp's own
// exchange arrays. Float arithmetic is the host's in IEEE single
// precision; compiled with -ffp-contract=off it rounds as the card does
// under nvcc -fmad=false.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
// a kernel's static shared array: one for the process, which the blocks,
// run one after another, take in turn
#define __shared__ static

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
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
struct cudaFuncAttributes {
  int numRegs;
};

namespace host_warp {
// a warp's barrier and exchange arrays
struct Warp {
  std::barrier<> bar{32};
  float xf[32];
  int xi[32];
};
// the running thread's warp and block barrier
inline thread_local Warp* warp = nullptr;
inline thread_local std::barrier<>* block = nullptr;
// every lane of the warp still running takes part, whatever the mask names
template <class T>
inline T exchange(T* slot, T v, int src) {
  slot[threadIdx.x & 31] = v;
  warp->bar.arrive_and_wait();
  const T r = slot[src & 31];
  warp->bar.arrive_and_wait();
  return r;
}
}  // namespace host_warp

inline float __shfl_sync(unsigned, float v, int src) {
  return host_warp::exchange(host_warp::warp->xf, v, src);
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return host_warp::exchange(host_warp::warp->xf, v, (int)threadIdx.x ^ mask);
}
inline int __shfl_sync(unsigned, int v, int src) {
  return host_warp::exchange(host_warp::warp->xi, v, src);
}
inline int __shfl_xor_sync(unsigned, int v, int mask) {
  return host_warp::exchange(host_warp::warp->xi, v, (int)threadIdx.x ^ mask);
}
inline bool __any_sync(unsigned, bool p) {
  host_warp::Warp* w = host_warp::warp;
  w->xi[threadIdx.x & 31] = p;
  w->bar.arrive_and_wait();
  bool r = false;
  for (int i = 0; i < 32; ++i) r |= w->xi[i] != 0;
  w->bar.arrive_and_wait();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) { host_warp::warp->bar.arrive_and_wait(); }
// the card's approximate reciprocal and reciprocal root, here rounded
inline float __fdividef(float a, float b) { return a / b; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline void __syncthreads() { host_warp::block->arrive_and_wait(); }

template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, T) {
  a->numRegs = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// stream-ordered allocation: the host's heap, poisoned with NaN
inline cudaError_t cudaMallocAsync(void** p, size_t bytes, cudaStream_t) {
  float* f = new float[(bytes + 3) / 4];
  for (size_t i = 0; i < (bytes + 3) / 4; ++i) f[i] = std::nanf("");
  *p = f;
  return cudaSuccess;
}
inline cudaError_t cudaFreeAsync(void* p, cudaStream_t) {
  delete[] static_cast<float*>(p);
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}

// kernel<<<grid, block, smem, stream>>>(args...) on the host (block a
// multiple of 32): block after block, each block's threads all at once,
// each warp with its own barrier; a thread that returns drops out of its
// warp's barrier and of the block's. The caller provides the shared memory
// (one block's, reused by the next).
template <class K, class... A>
void host_launch(K kernel, unsigned grid, unsigned block, size_t, cudaStream_t, A... args) {
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    std::vector<std::unique_ptr<host_warp::Warp>> warps;
    for (unsigned w = 0; w < block / 32; ++w) warps.push_back(std::make_unique<host_warp::Warp>());
    std::vector<std::thread> threads;
    for (unsigned l = 0; l < block; ++l) {
      threads.emplace_back([&, l] {
        threadIdx = {l, 0, 0};
        blockIdx = {b, 0, 0};
        host_warp::warp = warps[l / 32].get();
        host_warp::block = &bar;
        kernel(args...);
        host_warp::warp->bar.arrive_and_drop();
        bar.arrive_and_drop();
      });
    }
    for (auto& t : threads) t.join();
  }
}
