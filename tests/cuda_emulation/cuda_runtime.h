// The CUDA runtime as far as ops/csrc/flash_simt.cu uses it, emulated on
// the CPU for tests/test_torch_flash_simt.py: a block runs as its threads
// (std::thread) meeting at a barrier for __syncthreads and for each warp
// shuffle (every thread of the kernels reaches each shuffle); blocks run
// one after another; dynamic shared memory is one array.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;

typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

using std::max;
using std::min;

inline std::barrier<>* emu_barrier = nullptr;
inline float emu_lanes[1024];

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float x, int mask) {
  emu_barrier->arrive_and_wait();
  emu_lanes[threadIdx.x] = x;
  emu_barrier->arrive_and_wait();
  const float y = emu_lanes[threadIdx.x ^ mask];
  emu_barrier->arrive_and_wait();
  return y;
}

// `kernel<<<grid, threads, smem, stream>>>(args...)` is rewritten by the
// test to `emu_launch(kernel, grid, threads, smem, stream)(args...)`.
template <class Kernel>
auto emu_launch(Kernel kernel, dim3 grid, int threads, size_t, cudaStream_t) {
  return [=](auto... args) {
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          std::barrier<> bar(threads);
          emu_barrier = &bar;
          std::vector<std::thread> pool;
          for (int t = 0; t < threads; ++t)
            pool.emplace_back([=] {
              threadIdx = dim3(t);
              blockIdx = dim3(x, y, z);
              kernel(args...);
            });
          for (auto& th : pool) th.join();
        }
  };
}
