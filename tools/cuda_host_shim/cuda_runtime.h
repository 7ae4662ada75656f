// Host stand-in for the CUDA runtime, for rehearsing a kernel source of
// control_box_rst_tpu_torch/csrc/ on a machine without a GPU or nvcc.
//
// The .cu file is compiled as host C++ against this header (see build.py
// beside it). A launch runs the blocks one after another; the threads of a
// block are real threads, and the threads of a warp meet at a barrier for
// __syncwarp(), shuffles and votes, so warp-cooperative code runs with the
// synchronisation it asks for (and hangs or reads garbage if it asks for too
// little in a way that matters here: shared memory starts as NaN). Device
// pointers are host pointers. What this cannot show: that nvcc accepts the
// source, how it contracts multiply-adds (here: not at all), or any timing.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <pthread.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)

struct shim_dim3 { unsigned x = 0, y = 0, z = 0; };
extern thread_local shim_dim3 threadIdx, blockIdx, blockDim, gridDim;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct alignas(8) float2 { float x, y; };

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchOutOfResources = 701 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { int numRegs; };
// What the stand-in device reports; a test may shrink them (both are exported)
// to force small blocks and a short persistent grid.
extern "C" int shim_max_smem, shim_sms;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int a, int) {
    *v = (a == cudaDevAttrMaxSharedMemoryPerBlockOptin) ? shim_max_smem : shim_sms;
    return cudaSuccess;
}
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int, size_t) {
    *n = 1;
    return cudaSuccess;
}
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) {
    a->numRegs = -1;
    return cudaSuccess;
}

// ---- warp-level primitives: the 32 threads of a warp meet at a barrier ----
struct ShimWarp { pthread_barrier_t bar; uint32_t xchg[32]; };
extern thread_local ShimWarp* shim_warp;
inline void __syncwarp(unsigned = 0xffffffffu) { pthread_barrier_wait(&shim_warp->bar); }
template <class T> inline T shim_exchange(T v, int src) {
    static_assert(sizeof(T) == 4, "32-bit shuffles only");
    uint32_t bits;
    std::memcpy(&bits, &v, 4);
    shim_warp->xchg[threadIdx.x & 31] = bits;
    __syncwarp();
    bits = shim_warp->xchg[src & 31];
    __syncwarp();
    T out;
    std::memcpy(&out, &bits, 4);
    return out;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int off) {
    return shim_exchange(v, (int)(threadIdx.x & 31) ^ off);
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return shim_exchange(v, src); }
inline int __any_sync(unsigned, int pred) {
    shim_warp->xchg[threadIdx.x & 31] = pred ? 1u : 0u;
    __syncwarp();
    int any = 0;
    for (int i = 0; i < 32; ++i) any |= (int)shim_warp->xchg[i];
    __syncwarp();
    return any;
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }

// kernel<<<grid, block, smem, stream>>>(args...) is rewritten by build.py into
// SHIM_LAUNCH(grid, block, smem, stream, kernel, args...).
void shim_launch(unsigned grid, unsigned block, size_t smem, const std::function<void()>& body);
#define SHIM_LAUNCH(grid, block, smem, stream, fn, ...) \
    shim_launch((grid), (block), (smem), [&]() { fn(__VA_ARGS__); })
