// Block-tridiagonal SPD factor-and-solve kernels for NVIDIA Hopper (sm_90a),
// float32.
//
// What this replaces
// ------------------
// The JAX package's two Pallas TPU kernels that compute x = M^-1 b for a batch
// of SPD block-tridiagonal M = tridiag(O', D, O) from D, O, b in one call:
//   btridiag_factor_solve_kernel  (K3)  <-  control_box_rst_tpu/ops/pallas/
//       btridiag_kernel.py, btridiag_solve_pallas / _factor_solve_kernel:
//       three sweeps over the K stages (factor M = L L', then L z = b, then
//       L' x = z), the factor and z kept in scratch beside the inputs;
//   btridiag_factor_solve_smem_kernel and btridiag_factor_solve_inplace_kernel
//       (K4, two routes)  <-  control_box_rst_tpu/ops/pallas/
//       btridiag_kernel_v2.py, btridiag_solve_pallas_v2 / _kernel: two sweeps,
//       the forward substitution fused into the factorization sweep, the
//       factor kept where the backward sweep finds it without a scratch pass.
// All are built from the same device functions below (Cholesky of an NZ x NZ
// block, L X = O, S -= X'X, L z = r, L' x = r), as the Pallas bodies repeat
// the same unrolled small-matrix algebra. The arithmetic follows the Pallas
// bodies statement by statement: only the lower triangle of D is read, the
// Schur complement subtracts one product at a time, the off-diagonal factor
// is Lo = X', a negative pivot gives NaN (sqrtf, no clamp), divisions stay
// divisions.
//
// What is different from the TPU kernels, on purpose
// --------------------------------------------------
// No tiles of 128 or 1024 lanes padded with identity blocks: any batch size
// runs, the ragged edge is masked. Nothing is written over the caller's D and
// O: "in place" on the TPU meant the factor reused the input tiles in fast
// memory; here the factor has fast memory of its own.
//
// K4, the solvers' route: NZ threads per lane, factor in shared memory
// -------------------------------------------------------------------
// btridiag_factor_solve_smem_kernel reads D, O, b batch-first exactly as the
// caller has them (base pointer and lane stride; stride 0 is a D or O shared
// by all lanes) and writes x batch-first: the wrapper converts no layout and
// allocates nothing but x. A lane is a group of NZ neighbouring threads,
// 32/NZ lanes to a warp, one warp to a block. The factor (per stage one record
// of the diagonal block, packed lower, with the reciprocals of its pivots;
// the sub-diagonal blocks) and z of every stage stay in dynamic shared memory
// between the two sweeps (the table BT_SMEM_LANE_ARRAYS: 6,880 B per lane at
// K=51, NZ=4), so a lane moves its 8,096 bytes of input and output once and
// nothing else.
// Inside a stage the group shares the work where the algebra is parallel:
// thread c solves column c of L X = O (its NZ divisions run beside the other
// columns') and writes it as row c of Lo; the group then reads X back from
// shared memory. What is a chain anyway (Schur complement, Cholesky, the two
// triangular solves) every thread of the group computes for itself from the
// same values: that costs no instruction more than one thread doing it (a
// warp issues once for all its threads), needs no shuffle on the critical
// path, and leaves L, z and x in the registers of every thread that needs
// them next. z lags one stage behind the factor, so its quotients overlap
// the next stage's X solve instead of lengthening the chain. The inputs of
// the next BT_PREFETCH stages are in flight while a stage is computed. The
// substitutions divide by pivots whose reciprocals the Cholesky step has
// anyway, so their quotients are built from those (quotient<> of
// quotient.cuh, bit for bit the division): a division costs ~45 cycles on a chain and ~240 where
// its numerator is zero, infinite or NaN -- and LM hands over systems that
// are not positive definite in float32 (a third of the lanes late in a
// solve), whose lanes are NaN from the first negative pivot on and would
// hold up the seven other lanes of their warp at every stage.
// Tensor cores are not used: the blocks are 4x4 in float32, and TF32 (the
// best a wgmma tile offers) keeps three decimal digits where LM's accept test
// needs seven.
//
// K3, and K4 for shapes whose factor does not fit: one thread per lane
// --------------------------------------------------------------------
// btridiag_factor_solve_kernel (three sweeps, factor in scratch) and
// btridiag_factor_solve_inplace_kernel (two sweeps, factor written over the
// wrapper's copies of D and O, next stage's loads issued before the current
// stage's stores). NZ is a compile-time constant, per-lane arrays are
// tile-major [ceil(B/T)][rows][T] with T = 32 (a warp reads 32 neighbouring
// floats per access) or T = 1 (batches smaller than a warp); the wrapper
// converts layouts with torch and owns every buffer.
//
// What bounds them on this card
// -----------------------------
// Per lane 4*(K*NZ^2 + (K-1)*NZ^2 + 2*K*NZ) bytes go in and out (8,096 B at
// K=51, NZ=4) against ~13.8 k float32 operations: 1.7 operations per byte
// where the card needs ~20 to be limited by arithmetic, so bytes bind on
// paper. But a lane is one dependent chain over the stages (the factor of
// stage k needs the factor of stage k-1: per stage NZ divisions, then NZ
// square roots and NZ more divisions, each waiting for the last), so what a
// launch really waits for is latency, and the cure is lanes in flight. The
// one-thread-per-lane kernels have the whole batch in flight but pay a round
// trip to device memory per stage and, in the wrapper, a transposition of
// 265 MB. The shared-memory route pays neither, and is bound by how many
// lanes the 227 KB of an SM hold (32 at the shapes above, four warps) times
// the latency of a lane's chain: a warp alone on its scheduler is issued an
// instruction every ~3 cycles, a stage is ~350 of them, and the kernel by
// itself is slower than the one-thread-per-lane kernel with its 248 lanes
// per SM in flight (0.52 against 0.31 ms on an H100 at B=32768). What the
// route saves is the wrapper's copies.
//
// No -use_fast_math: pivots are divided by and square-rooted.

#include <cuda_runtime.h>

#include "quotient.cuh"

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

// ===========================================================================
// K4 on the shared-memory route: NZ threads per lane, factor and z on chip
// ===========================================================================

#define BT_SMEM_ALIGN_FLOATS 4  // every sub-array of a lane starts 16-byte aligned
#define BT_LANES_PER_WARP (32 / NZ)
#define BT_PREFETCH 3           // stages whose inputs are in flight
// Floats of a stage's record in Lf: the NTRI entries of the diagonal factor
// (packed lower), then the NZ reciprocals of its pivots.
#define BT_FREC (NTRI + NZ)

// The per-lane arrays in dynamic shared memory, in carve order: X(name, floats)
// with K stages. ops/cuda/btridiag_kernel.py:factor_bytes_per_lane states the
// same sum (the CPU tests parse this table and hold the two together).
#define BT_SMEM_LANE_ARRAYS(X) \
    X(Lf, K * BT_FREC)         /* per stage: diagonal factor packed lower, 1 / pivots */ \
    X(Lo, (K - 1) * NZ * NZ)   /* sub-diagonal factors */ \
    X(z, K * NZ)               /* L^-1 b */

__host__ __device__ inline int bt_round_up(int floats) {
    return (floats + BT_SMEM_ALIGN_FLOATS - 1) / BT_SMEM_ALIGN_FLOATS * BT_SMEM_ALIGN_FLOATS;
}

__host__ __device__ inline int bt_smem_floats_per_lane(int K) {
    int total = 0;
#define BT_COUNT(name, floats) total += bt_round_up(floats);
    BT_SMEM_LANE_ARRAYS(BT_COUNT)
#undef BT_COUNT
    return total;
}

struct FactorSmem {
#define BT_DECLARE(name, floats) float* name;
    BT_SMEM_LANE_ARRAYS(BT_DECLARE)
#undef BT_DECLARE
};

__device__ __forceinline__ FactorSmem bt_carve(float* base, int K) {
    FactorSmem s;
#define BT_TAKE(name, floats) \
    s.name = base;            \
    base += bt_round_up(floats);
    BT_SMEM_LANE_ARRAYS(BT_TAKE)
#undef BT_TAKE
    return s;
}

// sqrtf(d) and 1.0f / dj, value for value, without the hardware's slow path
// where the answer is NaN anyway: LM hands over systems that are not positive
// definite in float32 (a third of the lanes late in a solve), their lanes are
// NaN from the first negative pivot on, and eight lanes share a warp.
__device__ __forceinline__ float pivot_sqrt(float d) {
    return (d > 0.0f) ? sqrtf(d) : ((d == 0.0f) ? d : __int_as_float(0x7fffffff));
}

__device__ __forceinline__ float pivot_reciprocal(float dj) {
    return (dj != dj) ? dj : 1.0f / dj;
}

// L = chol(S) as chol_block, and the reciprocals of its pivots beside it.
__device__ __forceinline__ void chol_block_inv(const float (&S)[NZ][NZ], float (&L)[NZ][NZ],
                                               float (&Linv)[NZ]) {
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
        float d = S[j][j];
#pragma unroll
        for (int t = 0; t < j; ++t) d -= L[j][t] * L[j][t];
        const float dj = pivot_sqrt(d);
        L[j][j] = dj;
        const float inv = pivot_reciprocal(dj);
        Linv[j] = inv;
#pragma unroll
        for (int i = j + 1; i < NZ; ++i) {
            float acc = S[i][j];
#pragma unroll
            for (int t = 0; t < j; ++t) acc -= L[i][t] * L[j][t];
            L[i][j] = acc * inv;
        }
    }
}

// One column of X = L^-1 O and z = L^-1 r, both from the same factor: two
// chains of quotients that wait for L only, so they run beside each other.
template <bool FAST>
__device__ __forceinline__ bool solve_column_and_vec(const float (&L)[NZ][NZ],
                                                     const float (&Linv)[NZ],
                                                     const float (&Oc)[NZ], const float (&r)[NZ],
                                                     float (&Xc)[NZ], float (&z)[NZ]) {
    bool bad = false;
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        float acc = Oc[i], accz = r[i];
#pragma unroll
        for (int t = 0; t < i; ++t) {
            acc -= L[i][t] * Xc[t];
            accz -= L[i][t] * z[t];
        }
        Xc[i] = quotient<FAST>(acc, L[i][i], Linv[i], bad);
        z[i] = quotient<FAST>(accz, L[i][i], Linv[i], bad);
    }
    return bad;
}

// z = L^-1 r
template <bool FAST>
__device__ __forceinline__ bool solve_lower_rec(const float (&L)[NZ][NZ], const float (&Linv)[NZ],
                                                const float (&r)[NZ], float (&z)[NZ]) {
    bool bad = false;
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        float acc = r[i];
#pragma unroll
        for (int t = 0; t < i; ++t) acc -= L[i][t] * z[t];
        z[i] = quotient<FAST>(acc, L[i][i], Linv[i], bad);
    }
    return bad;
}

// x = L^-T r from a stage's record f
template <bool FAST>
__device__ __forceinline__ bool solve_upper_rec(const float (&f)[BT_FREC], const float (&r)[NZ],
                                                float (&x)[NZ]) {
    bool bad = false;
#pragma unroll
    for (int i = NZ - 1; i >= 0; --i) {
        float acc = r[i];
#pragma unroll
        for (int t = i + 1; t < NZ; ++t) acc -= f[TRI(t, i)] * x[t];
        x[i] = quotient<FAST>(acc, f[TRI(i, i)], f[NTRI + i], bad);
    }
    return bad;
}

__device__ __forceinline__ bool reciprocals_ok(const float* y) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < NZ; ++i) ok = ok && reciprocal_ok(y[i]);
    return ok;
}

// Inputs of one stage as a thread of the group holds them: the lower triangle
// of D_k, column c of O_{k-1}, b_k.
struct StageInputs {
    float S[NZ][NZ];
    float Oc[NZ];
    float r[NZ];
};

__device__ __forceinline__ void load_stage_inputs(const float* __restrict__ D,
                                                  const float* __restrict__ O,
                                                  const float* __restrict__ b, int k, int K,
                                                  int c, StageInputs& in) {
    if (k >= K) return;
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) in.S[i][j] = __ldg(D + (size_t)((k * NZ + i) * NZ + j));
#pragma unroll
    for (int i = 0; i < NZ; ++i) in.r[i] = __ldg(b + (size_t)(k * NZ + i));
    if (k > 0) {
#pragma unroll
        for (int i = 0; i < NZ; ++i)
            in.Oc[i] = __ldg(O + (size_t)(((k - 1) * NZ + i) * NZ + c));
    }
}

// v[c] for a thread-dependent c without indexing registers dynamically
__device__ __forceinline__ float pick(const float (&v)[NZ], int c) {
    float out = v[0];
#pragma unroll
    for (int i = 1; i < NZ; ++i) out = (c == i) ? v[i] : out;
    return out;
}

// D, O, b, x: batch-first; lane l's arrays start at D + l * strideD etc.
// (strides in floats; strideD, strideO may be 0), each contiguous.
__global__ void __launch_bounds__(32)
btridiag_factor_solve_smem_kernel(const float* __restrict__ D, const float* __restrict__ O,
                                  const float* __restrict__ b, float* __restrict__ x,
                                  long long B, int K, long long strideD, long long strideO,
                                  long long strideb, int lane_floats) {
    extern __shared__ __align__(16) float smem[];
    const int c = (int)threadIdx.x % NZ;  // the thread's column
    // left-over threads when 32 % NZ != 0 shadow slot 0 and write nothing
    const bool member = (int)threadIdx.x / NZ < BT_LANES_PER_WARP;
    const int grp = member ? (int)threadIdx.x / NZ : 0;  // the lane's slot in the warp
    const bool keeper = member && c == 0;  // writes what the whole group computed
    const long long mine = (long long)blockIdx.x * BT_LANES_PER_WARP + grp;
    const bool active = member && mine < B;
    const long long lane = active ? mine : 0;  // an idle group reads lane 0, writes nothing
    D += lane * strideD;
    O += lane * strideO;
    b += lane * strideb;
    x += lane * (long long)(K * NZ);
    const FactorSmem s = bt_carve(smem + (size_t)grp * lane_floats, K);

    float L[NZ][NZ] = {};  // factor of the previous stage
    float Linv[NZ] = {};   // reciprocals of its pivots
    bool pivots_ok = false;  // ... all inside quotient's window
    float r[NZ] = {};      // b_{k-1} - Lo_{k-2} z_{k-2}: what z_{k-1} is solved from
    float zv[NZ] = {};     // z_{k-1}

    // ---- forward: factor stage k, substitute stage k-1 ----
    StageInputs q[BT_PREFETCH];
#pragma unroll
    for (int u = 0; u < BT_PREFETCH; ++u) load_stage_inputs(D, O, b, u, K, c, q[u]);
    for (int k0 = 0; k0 < K; k0 += BT_PREFETCH) {
#pragma unroll
        for (int u = 0; u < BT_PREFETCH; ++u) {
            const int k = k0 + u;
            if (k < K) {
                float S[NZ][NZ], rk[NZ];
                copy_lower(S, q[u].S);
                copy_vec(rk, q[u].r);
                if (k > 0) {
                    // column c of X = L^-1 O, beside z_{k-1} = L^-1 r
                    float Xc[NZ];
                    if (!pivots_ok || solve_column_and_vec<true>(L, Linv, q[u].Oc, r, Xc, zv))
                        solve_column_and_vec<false>(L, Linv, q[u].Oc, r, Xc, zv);
                    // Lo_{k-1} = X': column c of X is row c of Lo
                    if (member) store_floats(s.Lo + (k - 1) * NZ * NZ, c, Xc);
                    if (keeper) store_floats(s.z, k - 1, zv);
                    __syncwarp();
                    float lo[NZ * NZ], X[NZ][NZ];
                    load_floats(s.Lo, k - 1, lo);
#pragma unroll
                    for (int t = 0; t < NZ; ++t)
#pragma unroll
                        for (int i = 0; i < NZ; ++i) X[t][i] = lo[i * NZ + t];
                    schur_update(S, X);
                    sub_Xt_vec(rk, X, zv);
                }
                // the inputs of stage k are used up: ask for stage k + BT_PREFETCH
                load_stage_inputs(D, O, b, k + BT_PREFETCH, K, c, q[u]);
                chol_block_inv(S, L, Linv);
                pivots_ok = reciprocals_ok(Linv);
                copy_vec(r, rk);
                if (keeper) {
                    float f[BT_FREC];
#pragma unroll
                    for (int i = 0; i < NZ; ++i) {
                        f[NTRI + i] = Linv[i];
#pragma unroll
                        for (int j = 0; j <= i; ++j) f[TRI(i, j)] = L[i][j];
                    }
                    store_floats(s.Lf, k, f);
                }
            }
        }
    }
    // z of the last stage
    if (!pivots_ok || solve_lower_rec<true>(L, Linv, r, zv)) solve_lower_rec<false>(L, Linv, r, zv);

    // ---- backward: L' x = z (every thread of the group, from shared memory) ----
    __syncwarp();  // the records and z of every stage are in shared memory
    float f[BT_FREC], lo[NZ * NZ], xv[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        f[NTRI + i] = Linv[i];
#pragma unroll
        for (int j = 0; j <= i; ++j) f[TRI(i, j)] = L[i][j];
    }
    copy_vec(r, zv);
    if (K > 1) load_floats(s.Lo, K - 2, lo);
    for (int k = K - 1; k >= 0; --k) {
        // the stage below is loaded before this stage's chain of quotients starts
        float fn[BT_FREC], lon[NZ * NZ], rn[NZ];
        if (k > 0) {
            load_floats(s.Lf, k - 1, fn);
            load_floats(s.z, k - 1, rn);
            if (k > 1) load_floats(s.Lo, k - 2, lon);
        }
        if (!reciprocals_ok(f + NTRI) || solve_upper_rec<true>(f, r, xv))
            solve_upper_rec<false>(f, r, xv);
        if (active) x[k * NZ + c] = pick(xv, c);
        if (k > 0) {
            // right-hand side of stage k-1: z_{k-1} - Lo_{k-1}' x_k
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                float acc = rn[i];
#pragma unroll
                for (int t = 0; t < NZ; ++t) acc -= lo[t * NZ + i] * xv[t];
                r[i] = acc;
            }
#pragma unroll
            for (int j = 0; j < BT_FREC; ++j) f[j] = fn[j];
#pragma unroll
            for (int j = 0; j < NZ * NZ; ++j) lo[j] = lon[j];
        }
    }
}

extern "C" {

// Floats of shared memory a lane takes on the shared-memory route; the wrapper
// holds its own formula against this before the first launch.
int btridiag_smem_floats_per_lane(int K) { return bt_smem_floats_per_lane(K); }

// Shared-memory route of K4. p: host array of device pointers to float32
// arrays, batch-first, each lane's array contiguous:
//   0 D [B | 1][K*NZ*NZ]  1 O [B | 1][(K-1)*NZ*NZ]  2 b [B][K*NZ]   (read only)
//   3 x [B][K*NZ] contiguous                                        (output)
// strides: floats between consecutive lanes of D, O, b (0: one copy for all).
// info (4 ints, may be null): 0 dynamic shared memory of a block, bytes
//   1 blocks  2 resident blocks per SM  3 registers per thread.
// Returns the first CUDA error of the attribute calls or cudaGetLastError()
// after the launch.
int btridiag_factor_solve_smem_launch(void* const* p, long long B, int K, long long strideD,
                                      long long strideO, long long strideb, int* info,
                                      void* stream) {
    if (B <= 0) return 0;
    if (K < 1) return (int)cudaErrorInvalidValue;
    const int lane_floats = bt_smem_floats_per_lane(K);
    const int smem_bytes = BT_LANES_PER_WARP * lane_floats * (int)sizeof(float);
    const void* kernel = (const void*)btridiag_factor_solve_smem_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((B + BT_LANES_PER_WARP - 1) / BT_LANES_PER_WARP);
    if (info) {
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, smem_bytes);
        if (err != cudaSuccess) return (int)err;
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return (int)err;
        info[0] = smem_bytes;
        info[1] = (int)grid;
        info[2] = per_sm;
        info[3] = attr.numRegs;
    }
    btridiag_factor_solve_smem_kernel<<<grid, 32, smem_bytes, (cudaStream_t)stream>>>(
        (const float*)p[0], (const float*)p[1], (const float*)p[2], (float*)p[3], B, K,
        strideD, strideO, strideb, lane_floats);
    return (int)cudaGetLastError();
}

}  // extern "C"
