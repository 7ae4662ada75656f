// The launch loop of the host stand-in (see cuda_runtime.h beside it).
#include "cuda_runtime.h"

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

thread_local shim_dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local ShimWarp* shim_warp;
extern "C" {
int shim_max_smem = 232448, shim_sms = 2;
}
// `extern __shared__ float smem[]` of the kernels: one block runs at a time.
alignas(16) float smem[1 << 16];

void shim_launch(unsigned grid, unsigned block, size_t smem_bytes,
                 const std::function<void()>& body) {
    if (smem_bytes > sizeof(smem) || block == 0 || block % 32 != 0) {
        std::fprintf(stderr, "shim_launch: unsupported launch (%u threads, %zu bytes)\n", block,
                     smem_bytes);
        std::abort();
    }
    for (unsigned b = 0; b < grid; ++b) {
        for (size_t i = 0; i < (smem_bytes + 3) / 4; ++i) smem[i] = NAN;  // uninitialised, loudly
        std::vector<ShimWarp> warps(block / 32);
        for (auto& w : warps) pthread_barrier_init(&w.bar, nullptr, 32);
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block; ++t)
            threads.emplace_back([&, t]() {
                threadIdx.x = t;
                blockIdx.x = b;
                blockDim.x = block;
                gridDim.x = grid;
                shim_warp = &warps[t / 32];
                body();
            });
        for (auto& th : threads) th.join();
        for (auto& w : warps) pthread_barrier_destroy(&w.bar);
    }
}
