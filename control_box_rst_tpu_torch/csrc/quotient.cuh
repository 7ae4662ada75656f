// Helpers of a thread that walks a dependent chain out of shared memory:
// the quotient a / b built from the reciprocal of b, and register <-> shared
// memory moves with the widest access. Shared by admm_kernel.cu and
// btridiag_kernel.cu (their shared-memory kernels); include it after
// <cuda_runtime.h>.
//
// The quotient is bit-identical to the division ONLY under the flags the
// sources are built with (ops/cuda/build.py: no -use_fast_math, no
// -prec-div=false, no -ftz=true): it needs 1.0f / b correctly rounded and the
// fmaf chain below evaluated as written. Building with any of those flags
// voids the equality; the card checks it on random operands in every smoke run
// (admm_division_check_launch of admm_kernel.cu).
#pragma once

// a / b, bit for bit what the division gives (round to nearest, the sign of a
// zero included), computed from y = 1.0f / b. The substitutions divide by the
// same pivots in every iteration of a round, and a division on the chain
// costs ~45 cycles -- hundreds where the numerator is exactly zero (a pinned
// row) or not finite (a lane whose factorization broke down), which the
// hardware sends down its slow path. With the correctly rounded reciprocal at
// hand, q = a*y corrected twice by the exact residual r = a - b*q (FMA) is the
// correctly rounded quotient (Markstein): the first correction leaves an
// error far below an ulp, the second one rounds. That holds while nothing
// over- or underflows, hence an exponent window. The caller tests the
// reciprocal once per pivot (reciprocal_ok: y within 2^-60..2^60, or NaN, the
// reciprocal of a NaN pivot, which turns every quotient into the NaN the
// division gives); a chain whose pivots are not all so runs on
// quotient<false>, the division itself. The numerator is tested here: zero,
// infinite or NaN, and a*y is the quotient already; within the window, the
// corrected one is; anything else raises `bad`, and the value returned is
// then not to be used: the caller repeats its step with quotient<false>, so
// one rare branch serves a whole group of quotients and the common path is
// free of branches.
#define DIV_BY_LO 0x1p-60f
#define DIV_BY_HI 0x1p60f
__device__ __forceinline__ bool in_window(float v) {
    return (v >= DIV_BY_LO) && (v <= DIV_BY_HI);
}

__device__ __forceinline__ bool reciprocal_ok(float y) { return in_window(y) || (y != y); }

template <bool FAST>
__device__ __forceinline__ float quotient(float a, float b, float y, bool& bad) {
    if (!FAST) return a / b;
    const float mag = fabsf(a);
    const bool direct = !((mag > 0.0f) && (mag <= 3.402823466e+38f));  // 0, inf, NaN
    bad = bad || !(direct || in_window(mag));
    const float q0 = a * y;  // direct: the quotient itself, sign included
    float r = fmaf(-b, q0, a);
    float q = fmaf(r, y, q0);
    r = fmaf(-b, q, a);
    q = fmaf(r, y, q);
    return direct ? q0 : q;
}

// COUNT floats between registers and shared memory at p + k * COUNT, with the
// widest access COUNT allows (the arrays start 16-byte aligned): a thread on
// a chain pays for the count of its memory accesses, not their width.
template <int COUNT>
__device__ __forceinline__ void load_floats(const float* p, int k, float (&dst)[COUNT]) {
    p += k * COUNT;
    if constexpr (COUNT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < COUNT / 4; ++j) {
            const float4 v = reinterpret_cast<const float4*>(p)[j];
            dst[4 * j] = v.x;
            dst[4 * j + 1] = v.y;
            dst[4 * j + 2] = v.z;
            dst[4 * j + 3] = v.w;
        }
    } else if constexpr (COUNT % 2 == 0) {
#pragma unroll
        for (int j = 0; j < COUNT / 2; ++j) {
            const float2 v = reinterpret_cast<const float2*>(p)[j];
            dst[2 * j] = v.x;
            dst[2 * j + 1] = v.y;
        }
    } else {
#pragma unroll
        for (int j = 0; j < COUNT; ++j) dst[j] = p[j];
    }
}

template <int COUNT>
__device__ __forceinline__ void store_floats(float* p, int k, const float (&src)[COUNT]) {
    p += k * COUNT;
    if constexpr (COUNT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < COUNT / 4; ++j) {
            float4 v;
            v.x = src[4 * j];
            v.y = src[4 * j + 1];
            v.z = src[4 * j + 2];
            v.w = src[4 * j + 3];
            reinterpret_cast<float4*>(p)[j] = v;
        }
    } else if constexpr (COUNT % 2 == 0) {
#pragma unroll
        for (int j = 0; j < COUNT / 2; ++j) {
            float2 v;
            v.x = src[2 * j];
            v.y = src[2 * j + 1];
            reinterpret_cast<float2*>(p)[j] = v;
        }
    } else {
#pragma unroll
        for (int j = 0; j < COUNT; ++j) p[j] = src[j];
    }
}
