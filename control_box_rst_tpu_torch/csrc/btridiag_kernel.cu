// Block-tridiagonal SPD factor-and-solve kernels for NVIDIA Hopper (sm_90a),
// float32.
//
// What this replaces
// ------------------
// The JAX package's two Pallas TPU kernels that compute x = M^-1 b for a batch
// of SPD block-tridiagonal M = tridiag(O', D, O) from D, O, b in one call:
//   btridiag_factor_solve_kernel          <-  control_box_rst_tpu/ops/pallas/
//       btridiag_kernel.py, btridiag_solve_pallas / _factor_solve_kernel:
//       three sweeps over the K stages (factor M = L L', then L z = b, then
//       L' x = z), the factor and z kept in scratch beside the inputs;
//   btridiag_factor_solve_inplace_kernel  <-  control_box_rst_tpu/ops/pallas/
//       btridiag_kernel_v2.py, btridiag_solve_pallas_v2 / _kernel: two sweeps,
//       the forward substitution fused into the factorization sweep and the
//       factor written over D and O.
// Both are built from the same device functions below (Cholesky of an NZ x NZ
// block, L X = O for a block, S -= X'X, L z = r, L' x = r), as the two Pallas
// bodies repeat the same unrolled small-matrix algebra, so they give the same
// bits. The arithmetic follows the Pallas bodies statement by statement:
// only the lower triangle of D is read, the Schur complement subtracts one
// product at a time, the off-diagonal factor is Lo = X', a negative pivot
// gives NaN (sqrtf, no clamp), divisions stay divisions.
//
// What is different from the TPU kernels, on purpose
// --------------------------------------------------
// No tiles of 128 or 1024 lanes padded with identity blocks: a lane is a
// thread, any batch size runs, the ragged edge is masked. The in-place entry
// keeps z in the output array x (the backward sweep overwrites it stage by
// stage) instead of a scratch of its own.
//
// Design
// ------
// One thread per lane; NZ is a compile-time constant (one shared library per
// NZ, -DNZ=..), the stage loops are real loops, a stage's blocks live in
// registers. Per-lane arrays are tile-major, [ceil(B/T)][rows][T] with T = 32
// (a warp is one tile: 32 neighbouring floats per access, one contiguous
// block per warp and array) or T = 1 (batches smaller than a warp: each
// lane's arrays contiguous). The wrapper converts layouts with torch and owns
// every buffer; the kernels allocate nothing and launch on the caller's
// stream.
//
// What bounds it on this card
// ---------------------------
// Per lane 4*(K*NZ^2 + (K-1)*NZ^2 + 2*K*NZ) bytes go in and out (8,096 B at
// K=51, NZ=4) against ~13.8 k float32 operations: 1.7 operations per byte
// where the card needs ~20 to be limited by arithmetic, so bytes bind. But
// the work of a lane is one dependent chain over the stages (the factor of
// stage k needs the factor of stage k-1), and with one thread per lane a
// batch of 32768 is only ~8 warps per SM, so what a launch really waits for
// is latency: every stage is a round trip to memory followed by a chain of
// ~200 dependent operations with a square root and divisions. What the
// design does about it: the inputs of stage k+1 do not depend on stage k, so
// the in-place entry (the one on the solver's path) starts the loads of the
// next stage before it computes and stores the current one, in both sweeps;
// the memory round trip then overlaps the arithmetic instead of preceding
// it. The three-sweep entry writes its factor to scratch buffers that alias
// nothing (__restrict__), moves ~12 KB more per lane, and is the plain form
// of the same algebra. Several threads per lane (one per column of a block)
// and a shared-memory pipeline fed by TMA are the steps after this one.
//
// No -use_fast_math: pivots are divided by and square-rooted.

#include <cuda_runtime.h>

#ifndef NZ
#define NZ 4
#endif
#define NTRI (NZ * (NZ + 1) / 2)
#define TRI(i, j) ((i) * ((i) + 1) / 2 + (j))
#define BLOCK_THREADS 128

// Offset of a lane's first element in a per-lane [rows, B] array kept
// tile-major: element (idx, lane) at ((lane / T) * rows + idx) * T + lane % T.
template <int T>
__device__ __forceinline__ long long lane_offset(long long lane, int rows) {
    return (lane / T) * (long long)rows * T + lane % T;
}

// ---- small-matrix algebra on register blocks (lower triangles only) ----

// L = chol(S): S, L lower. A negative pivot gives NaN, as the reference's sqrt.
__device__ __forceinline__ void chol_block(const float (&S)[NZ][NZ], float (&L)[NZ][NZ]) {
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
        float d = S[j][j];
#pragma unroll
        for (int t = 0; t < j; ++t) d -= L[j][t] * L[j][t];
        const float dj = sqrtf(d);
        L[j][j] = dj;
        const float inv = 1.0f / dj;
#pragma unroll
        for (int i = j + 1; i < NZ; ++i) {
            float s = S[i][j];
#pragma unroll
            for (int t = 0; t < j; ++t) s -= L[i][t] * L[j][t];
            L[i][j] = s * inv;
        }
    }
}

// X = L^-1 Ob (forward substitution, column by column)
__device__ __forceinline__ void solve_lower_block(const float (&L)[NZ][NZ],
                                                  const float (&Ob)[NZ][NZ],
                                                  float (&X)[NZ][NZ]) {
#pragma unroll
    for (int c = 0; c < NZ; ++c) {
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
            float s = Ob[i][c];
#pragma unroll
            for (int t = 0; t < i; ++t) s -= L[i][t] * X[t][c];
            X[i][c] = s / L[i][i];
        }
    }
}

// S -= X'X (lower triangle)
__device__ __forceinline__ void schur_update(float (&S)[NZ][NZ], const float (&X)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float acc = S[i][j];
#pragma unroll
            for (int t = 0; t < NZ; ++t) acc -= X[t][i] * X[t][j];
            S[i][j] = acc;
        }
    }
}

// z = L^-1 r
__device__ __forceinline__ void solve_lower_vec(const float (&L)[NZ][NZ],
                                                const float (&r)[NZ], float (&z)[NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        float s = r[i];
#pragma unroll
        for (int t = 0; t < i; ++t) s -= L[i][t] * z[t];
        z[i] = s / L[i][i];
    }
}

// x = L^-T r
__device__ __forceinline__ void solve_upperT_vec(const float (&L)[NZ][NZ],
                                                 const float (&r)[NZ], float (&x)[NZ]) {
#pragma unroll
    for (int i = NZ - 1; i >= 0; --i) {
        float s = r[i];
#pragma unroll
        for (int t = i + 1; t < NZ; ++t) s -= L[t][i] * x[t];
        x[i] = s / L[i][i];
    }
}

// ---- loads and stores of one stage (p is offset to the lane; T = stride) ----

template <int T>
__device__ __forceinline__ void load_lower(const float* p, int k, float (&S)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) S[i][j] = p[(size_t)((k * NZ + i) * NZ + j) * T];
}

template <int T>
__device__ __forceinline__ void store_lower(float* p, int k, const float (&L)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) p[(size_t)((k * NZ + i) * NZ + j) * T] = L[i][j];
}

template <int T>
__device__ __forceinline__ void load_block(const float* p, int k, float (&A)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j < NZ; ++j) A[i][j] = p[(size_t)((k * NZ + i) * NZ + j) * T];
}

// block k of p := X' (the sub-diagonal factor Lo_k = X')
template <int T>
__device__ __forceinline__ void store_block_transposed(float* p, int k, const float (&X)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j < NZ; ++j) p[(size_t)((k * NZ + i) * NZ + j) * T] = X[j][i];
}

template <int T>
__device__ __forceinline__ void load_packed(const float* p, int k, float (&L)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) L[i][j] = p[(size_t)(k * NTRI + TRI(i, j)) * T];
}

template <int T>
__device__ __forceinline__ void store_packed(float* p, int k, const float (&L)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) p[(size_t)(k * NTRI + TRI(i, j)) * T] = L[i][j];
}

template <int T>
__device__ __forceinline__ void load_vec(const float* p, int k, float (&v)[NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) v[i] = p[(size_t)(k * NZ + i) * T];
}

template <int T>
__device__ __forceinline__ void store_vec(float* p, int k, const float (&v)[NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) p[(size_t)(k * NZ + i) * T] = v[i];
}

// r -= X' zp   (= Lo_{k-1} z_{k-1} with Lo = X')
__device__ __forceinline__ void sub_Xt_vec(float (&r)[NZ], const float (&X)[NZ][NZ],
                                           const float (&zp)[NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        float s = r[i];
#pragma unroll
        for (int t = 0; t < NZ; ++t) s -= X[t][i] * zp[t];
        r[i] = s;
    }
}

// r -= Lo x   (Lo as stored: Lo[i][t])
__device__ __forceinline__ void sub_mat_vec(float (&r)[NZ], const float (&Lo)[NZ][NZ],
                                            const float (&v)[NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        float s = r[i];
#pragma unroll
        for (int t = 0; t < NZ; ++t) s -= Lo[i][t] * v[t];
        r[i] = s;
    }
}

// r -= Lo' x
__device__ __forceinline__ void sub_matT_vec(float (&r)[NZ], const float (&Lo)[NZ][NZ],
                                             const float (&v)[NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        float s = r[i];
#pragma unroll
        for (int t = 0; t < NZ; ++t) s -= Lo[t][i] * v[t];
        r[i] = s;
    }
}

__device__ __forceinline__ void copy_lower(float (&dst)[NZ][NZ], const float (&src)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) dst[i][j] = src[i][j];
}

__device__ __forceinline__ void copy_block(float (&dst)[NZ][NZ], const float (&src)[NZ][NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j < NZ; ++j) dst[i][j] = src[i][j];
}

__device__ __forceinline__ void copy_vec(float (&dst)[NZ], const float (&src)[NZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i) dst[i] = src[i];
}

// Three sweeps: factor into the scratch (Ld packed lower, Lo), forward
// substitution into the scratch z, backward substitution into x. D, O, b are
// read only.
template <int T>
__global__ void __launch_bounds__(BLOCK_THREADS)
btridiag_factor_solve_kernel(const float* __restrict__ D, const float* __restrict__ O,
                             const float* __restrict__ b, float* __restrict__ x,
                             float* __restrict__ Ld, float* __restrict__ Lo,
                             float* __restrict__ z, long long B, int K) {
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    D += lane_offset<T>(lane, K * NZ * NZ);
    O += lane_offset<T>(lane, (K - 1) * NZ * NZ);
    Lo += lane_offset<T>(lane, (K - 1) * NZ * NZ);
    Ld += lane_offset<T>(lane, K * NTRI);
    b += lane_offset<T>(lane, K * NZ);
    z += lane_offset<T>(lane, K * NZ);
    x += lane_offset<T>(lane, K * NZ);

    // ---- sweep 1: M = L L' ----
    {
        float L[NZ][NZ] = {};
        for (int k = 0; k < K; ++k) {
            float S[NZ][NZ];
            load_lower<T>(D, k, S);
            if (k > 0) {
                float Ob[NZ][NZ], X[NZ][NZ];
                load_block<T>(O, k - 1, Ob);
                solve_lower_block(L, Ob, X);
                schur_update(S, X);
                store_block_transposed<T>(Lo, k - 1, X);
            }
            chol_block(S, L);
            store_packed<T>(Ld, k, L);
        }
    }
    // ---- sweep 2: L z = b ----
    float v[NZ] = {};
    for (int k = 0; k < K; ++k) {
        float r[NZ], L[NZ][NZ];
        load_vec<T>(b, k, r);
        load_packed<T>(Ld, k, L);
        if (k > 0) {
            float Lb[NZ][NZ];
            load_block<T>(Lo, k - 1, Lb);
            sub_mat_vec(r, Lb, v);
        }
        solve_lower_vec(L, r, v);
        store_vec<T>(z, k, v);
    }
    // ---- sweep 3: L' x = z (v holds z of the last stage) ----
    for (int k = K - 1; k >= 0; --k) {
        float r[NZ], L[NZ][NZ];
        load_packed<T>(Ld, k, L);
        if (k == K - 1) {
            copy_vec(r, v);
        } else {
            float Lb[NZ][NZ];
            load_vec<T>(z, k, r);
            load_block<T>(Lo, k, Lb);
            sub_matT_vec(r, Lb, v);
        }
        solve_upperT_vec(L, r, v);
        store_vec<T>(x, k, v);
    }
}

// Two sweeps, in place: the forward sweep factors stage k, substitutes it at
// once (L and X are in registers) and writes the factor over D (lower
// triangle) and O; z goes to x, and the backward sweep turns it into the
// solution. Both sweeps load the next stage before they compute and store the
// current one.
template <int T>
__global__ void __launch_bounds__(BLOCK_THREADS)
btridiag_factor_solve_inplace_kernel(float* __restrict__ D, float* __restrict__ O,
                                     const float* __restrict__ b, float* __restrict__ x,
                                     long long B, int K) {
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    D += lane_offset<T>(lane, K * NZ * NZ);
    O += lane_offset<T>(lane, (K - 1) * NZ * NZ);
    b += lane_offset<T>(lane, K * NZ);
    x += lane_offset<T>(lane, K * NZ);

    float L[NZ][NZ] = {};
    float v[NZ] = {};
    // ---- forward: factor + substitute ----
    {
        float Sn[NZ][NZ], On[NZ][NZ] = {}, rn[NZ];
        load_lower<T>(D, 0, Sn);
        load_vec<T>(b, 0, rn);
        for (int k = 0; k < K; ++k) {
            float S[NZ][NZ], Ob[NZ][NZ], r[NZ], X[NZ][NZ];
            copy_lower(S, Sn);
            copy_block(Ob, On);
            copy_vec(r, rn);
            if (k + 1 < K) {
                load_lower<T>(D, k + 1, Sn);
                load_block<T>(O, k, On);
                load_vec<T>(b, k + 1, rn);
            }
            if (k > 0) {
                solve_lower_block(L, Ob, X);
                schur_update(S, X);
                sub_Xt_vec(r, X, v);
            }
            chol_block(S, L);
            solve_lower_vec(L, r, v);
            if (k > 0) store_block_transposed<T>(O, k - 1, X);
            store_lower<T>(D, k, L);
            store_vec<T>(x, k, v);
        }
    }
    // ---- backward: L' x = z (L and v hold the last stage's factor and z) ----
    {
        float r[NZ];
        copy_vec(r, v);
        solve_upperT_vec(L, r, v);
        store_vec<T>(x, K - 1, v);
        float Ln[NZ][NZ], Lbn[NZ][NZ], rn[NZ];
        if (K > 1) {
            load_lower<T>(D, K - 2, Ln);
            load_block<T>(O, K - 2, Lbn);
            load_vec<T>(x, K - 2, rn);
        }
        for (int k = K - 2; k >= 0; --k) {
            float Lb[NZ][NZ];
            copy_lower(L, Ln);
            copy_block(Lb, Lbn);
            copy_vec(r, rn);
            if (k > 0) {
                load_lower<T>(D, k - 1, Ln);
                load_block<T>(O, k - 1, Lbn);
                load_vec<T>(x, k - 1, rn);
            }
            sub_matT_vec(r, Lb, v);
            solve_upperT_vec(L, r, v);
            store_vec<T>(x, k, v);
        }
    }
}

extern "C" {

int btridiag_kernel_nz() { return NZ; }

// p: host array of device pointers to float32 arrays in the lane layout above
// with tile width lane_tile (32 or 1), in this order:
//   0 D [K*NZ*NZ, B]  1 O [(K-1)*NZ*NZ, B]  2 b [K*NZ, B]      (inputs, read only)
//   3 x [K*NZ, B]                                              (output)
//   4 Ld [K*NTRI, B]  5 Lo [(K-1)*NZ*NZ, B]  6 z [K*NZ, B]     (scratch)
// Returns cudaGetLastError() after the launch.
int btridiag_factor_solve_launch(void* const* p, long long B, int K, int lane_tile,
                                 void* stream) {
    if (B <= 0) return 0;
    if (K < 1) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((B + BLOCK_THREADS - 1) / BLOCK_THREADS);
    decltype(&btridiag_factor_solve_kernel<32>) kernel = nullptr;
    if (lane_tile == 32) kernel = btridiag_factor_solve_kernel<32>;
    if (lane_tile == 1) kernel = btridiag_factor_solve_kernel<1>;
    if (!kernel) return (int)cudaErrorInvalidValue;
    kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)p[0], (const float*)p[1], (const float*)p[2], (float*)p[3],
        (float*)p[4], (float*)p[5], (float*)p[6], B, K);
    return (int)cudaGetLastError();
}

// As above without scratch; D and O (p[0], p[1]) are overwritten by the
// factor (lower triangle of each D block, all of O), so the caller hands in
// copies it owns.
int btridiag_factor_solve_inplace_launch(void* const* p, long long B, int K,
                                         int lane_tile, void* stream) {
    if (B <= 0) return 0;
    if (K < 1) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((B + BLOCK_THREADS - 1) / BLOCK_THREADS);
    decltype(&btridiag_factor_solve_inplace_kernel<32>) kernel = nullptr;
    if (lane_tile == 32) kernel = btridiag_factor_solve_inplace_kernel<32>;
    if (lane_tile == 1) kernel = btridiag_factor_solve_inplace_kernel<1>;
    if (!kernel) return (int)cudaErrorInvalidValue;
    kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)p[0], (float*)p[1], (const float*)p[2], (float*)p[3], B, K);
    return (int)cudaGetLastError();
}

}  // extern "C"
