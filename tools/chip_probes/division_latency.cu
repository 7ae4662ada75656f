// Latency of the float32 operations a substitution chain is made of, and the
// exactness of a quotient built from a reciprocal; see division_latency.py.
#include <cuda_runtime.h>

#include <cstdio>

__device__ __forceinline__ float quotient_twice(float a, float b, float y) {
    float q = a * y;
    float r = fmaf(-b, q, a);
    q = fmaf(r, y, q);
    r = fmaf(-b, q, a);
    return fmaf(r, y, q);
}

__device__ __forceinline__ float quotient_once(float a, float b, float y) {
    const float q = a * y;
    return fmaf(fmaf(-b, q, a), y, q);
}

// One thread, chains of n dependent steps; cyc[i] = cycles of chain i.
__global__ void latency(float a, float b, float zero, int n, float* out, long long* cyc) {
    long long t0 = clock64();
    float v = a;
    for (int i = 0; i < n; ++i) v = fmaf(v, b, 1.0f);
    cyc[0] = clock64() - t0;
    out[0] = v;
    t0 = clock64();
    v = a;
    for (int i = 0; i < n; ++i) v = v / b + 1.0f;
    cyc[1] = clock64() - t0;
    out[1] = v;
    t0 = clock64();
    v = zero;  // a numerator that is exactly zero at every step
    for (int i = 0; i < n; ++i) v = (v / b) * zero;
    cyc[2] = clock64() - t0;
    out[2] = v;
    t0 = clock64();
    v = a;
    for (int i = 0; i < n; ++i) v = sqrtf(v) + b;
    cyc[3] = clock64() - t0;
    out[3] = v;
    t0 = clock64();
    v = a;
    const float y = 1.0f / b;
    for (int i = 0; i < n; ++i) v = quotient_twice(v, b, y) + 1.0f;
    cyc[4] = clock64() - t0;
    out[4] = v;
}

__device__ unsigned mix(unsigned x) {
    x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; x ^= x >> 16;
    return x;
}

// Pseudo-random operand pairs with exponents in [emin, emax]; all-ones and
// all-zeros significands mixed in. Counts where the quotients differ from a / b.
__global__ void exactness(unsigned long long per_thread, int emin, int emax,
                          unsigned long long* bad_twice, unsigned long long* bad_once) {
    const unsigned long long tid = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
    unsigned long long b2 = 0, b1 = 0;
    for (unsigned long long i = 0; i < per_thread; ++i) {
        const unsigned h1 = mix((unsigned)(tid * per_thread + i) * 2u + 1u);
        const unsigned h2 = mix(h1 ^ 0x9e3779b9u), h3 = mix(h2 + 77u);
        unsigned ma = h1 & 0x7fffffu, mb = h2 & 0x7fffffu;
        if ((h3 & 15u) == 0) mb = 0x7fffffu;
        if ((h3 & 15u) == 1) mb = 0;
        if ((h3 & 15u) == 2) ma = 0x7fffffu;
        const unsigned span = (unsigned)(emax - emin + 1);
        const int ea = emin + (int)((h3 >> 4) % span), eb = emin + (int)((h3 >> 12) % span);
        const float a = __uint_as_float(((unsigned)(ea + 127) << 23) | ma | ((h3 >> 31) << 31));
        const float b = __uint_as_float(((unsigned)(eb + 127) << 23) | mb);
        const float y = 1.0f / b, q = a / b;
        if (__float_as_uint(quotient_twice(a, b, y)) != __float_as_uint(q)) ++b2;
        if (__float_as_uint(quotient_once(a, b, y)) != __float_as_uint(q)) ++b1;
    }
    atomicAdd(bad_twice, b2);
    atomicAdd(bad_once, b1);
}

int main() {
    float* out;
    long long* cyc;
    unsigned long long* bad;
    cudaMallocManaged(&out, 64);
    cudaMallocManaged(&cyc, 64);
    cudaMallocManaged(&bad, 64);
    const int n = 100000;
    for (int rep = 0; rep < 2; ++rep) {
        latency<<<1, 1>>>(3.0f, 1.7f, 0.0f, n, out, cyc);
        cudaDeviceSynchronize();
    }
    std::printf("cycles per dependent step, one thread: fma %.1f | division + add %.1f | "
                "division of an exact zero + multiply %.1f | sqrt + add %.1f | "
                "quotient from the reciprocal (two corrections) + add %.1f\n",
                cyc[0] / (double)n, cyc[1] / (double)n, cyc[2] / (double)n, cyc[3] / (double)n,
                cyc[4] / (double)n);
    const int windows[3] = {20, 60, 120};
    for (int w = 0; w < 3; ++w) {
        bad[0] = bad[1] = 0;
        exactness<<<132 * 8, 256>>>(4096, -windows[w], windows[w], bad, bad + 1);
        cudaDeviceSynchronize();
        std::printf("exponents within 2^-%d..2^%d: %llu pairs, quotients that differ from a / b: "
                    "two corrections %llu, one correction %llu (%s)\n",
                    windows[w], windows[w], 132ull * 8 * 256 * 4096, bad[0], bad[1],
                    cudaGetErrorString(cudaGetLastError()));
    }
    return 0;
}
