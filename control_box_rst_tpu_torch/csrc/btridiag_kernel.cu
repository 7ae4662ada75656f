// Block-tridiagonal SPD factor-and-solve kernels for NVIDIA Hopper (sm_90a),
// float32.
//
// What this replaces
// ------------------
// The JAX package's two Pallas TPU kernels that compute x = M^-1 b for a batch
// of SPD block-tridiagonal M = tridiag(O', D, O) from D, O, b in one call:
//   btridiag_factor_solve_scratch_kernel  (K3)  <-  control_box_rst_tpu/ops/
//       pallas/btridiag_kernel.py, btridiag_solve_pallas / _factor_solve_kernel:
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
// K4 for shapes whose factor does not fit: one thread per lane
// -----------------------------------------------------------
// btridiag_factor_solve_inplace_kernel (two sweeps, factor written over the
// wrapper's copies of D and O, next stage's loads issued before the current
// stage's stores). NZ is a compile-time constant, per-lane arrays are
// tile-major [ceil(B/T)][rows][T] with T = 32 (a warp reads 32 neighbouring
// floats per access) or T = 1 (batches smaller than a warp); the wrapper
// converts layouts with torch and owns every buffer.
//
// K3: one thread per lane, operands batch-first, factor in a scratch
// ------------------------------------------------------------------
// btridiag_factor_solve_scratch_kernel reads D, O, b batch-first as the
// shared-memory kernel does (base pointer and lane stride, 0 for a D or O
// shared by all lanes) and writes x batch-first: the wrapper converts no
// layout. Every lane has a thread of its own, with registers and no shared
// memory, so the whole batch is in flight at once. A lane's 4x4 block is 64
// contiguous bytes, read as four 16-byte loads issued together (both 32-byte
// sectors used). The factor (diagonal blocks packed lower, sub-diagonal
// blocks) and z go to a scratch the wrapper allocates (table
// K3_SCRATCH_LANE_ARRAYS, 6,056 B per lane at K=51, NZ=4), tile-major by 32
// lanes so that a warp stores and reloads 128 contiguous bytes per element.
// Two sweeps: the factor sweep also solves z, one stage behind, beside X from
// the same factor, and the backward sweep reads factor and z back (a sweep of
// its own for z, as the TPU kernel has, was 15-20 % slower on an H100: 5,240 B
// more per lane). The next stage's loads are in flight while a stage is
// computed, and each asks the L2 for the 128 bytes around it, so that one
// access to device memory brings a lane's next stage too (10 % faster than no
// hint; 256 B and a deeper prefetch were no better). Quotients come from the
// pivots' reciprocals (quotient<>), which the backward sweep recomputes rather
// than stores. tools/chip_probes/k3_variants.py builds and times those choices
// from a copy of this source.
//
// What bounds them on this card
// -----------------------------
// Per lane 4*(K*NZ^2 + (K-1)*NZ^2 + 2*K*NZ) bytes go in and out (8,096 B at
// K=51, NZ=4) against ~13.8 k float32 operations: 1.7 operations per byte
// where the card needs ~20 to be limited by arithmetic, so bytes bind on
// paper. But a lane is one dependent chain over the stages (the factor of
// stage k needs the factor of stage k-1: per stage NZ divisions, then NZ
// square roots and NZ more divisions, each waiting for the last), so what a
// launch waits for is latency unless enough lanes are in flight to cover it.
// The shared-memory route of K4 holds 32 lanes per SM (the 227 KB of an SM at
// the shapes above, four warps); a warp alone on its scheduler is issued an
// instruction every ~3 cycles, a stage is ~350 of them, and the kernel by
// itself is slower than the one-thread-per-lane kernel with its 248 lanes
// per SM in flight (0.52 against 0.31 ms on an H100 at B=32768). What that
// route saves is the wrapper's copies. K3 keeps every lane in flight and
// makes no copy, and pays for it with the scratch: 20,208 B per lane in all,
// 662 MB at B=32768 -- a traffic floor of 0.198 ms at 3.35 TB/s. It takes
// 0.28 ms (2.4 TB/s), where the in-place one-thread-per-lane kernel moves the
// same bytes in 0.22 ms from its tile-major copies: what is left is the
// batch-first operands, read as 64-byte pieces 3 KB apart instead of whole
// 128-byte lines.
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

// One-thread-per-lane route of K4. p: host array of device pointers to
// float32 arrays in the lane layout above with tile width lane_tile (32 or 1):
//   0 D [K*NZ*NZ, B]  1 O [(K-1)*NZ*NZ, B]  2 b [K*NZ, B]  3 x [K*NZ, B]
// D and O are overwritten by the factor (lower triangle of each D block, all
// of O), so the caller hands in copies it owns. Returns cudaGetLastError()
// after the launch.
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

// ===========================================================================
// K3: one thread per lane, operands batch-first, factor in a scratch
// ===========================================================================

#define K3_TILE 32  // lanes of a scratch tile: one warp
// A block of D or O (NZ*NZ floats) and a stage of b or x (NZ floats) move as
// whole 16-byte vectors where NZ allows it; the wrapper then hands over every
// lane's arrays 16-byte aligned.
#define K3_VEC (NZ % 4 == 0)

// The per-lane arrays of the scratch, in carve order: X(name, floats) with K
// stages. The scratch is tile-major, [ceil(B / K3_TILE)][rows][K3_TILE] with
// rows the sum of the table, so a warp's store or load of one element is 128
// contiguous bytes. ops/cuda/btridiag_kernel.py:scratch_bytes_per_lane states
// the same sum (the CPU tests parse this table and hold the two together).
#define K3_SCRATCH_LANE_ARRAYS(X) \
    X(Ld, K * NTRI)            /* diagonal factors, packed lower */ \
    X(Lo, (K - 1) * NZ * NZ)   /* sub-diagonal factors */ \
    X(z, K * NZ)               /* L^-1 b */

__host__ __device__ inline int k3_scratch_floats_per_lane(int K) {
    int total = 0;
#define K3_COUNT(name, floats) total += (floats);
    K3_SCRATCH_LANE_ARRAYS(K3_COUNT)
#undef K3_COUNT
    return total;
}

// A lane's arrays in the scratch: element e of an array at name[e * K3_TILE].
struct LaneScratch {
#define K3_DECLARE(name, floats) float* name;
    K3_SCRATCH_LANE_ARRAYS(K3_DECLARE)
#undef K3_DECLARE
};

__device__ __forceinline__ LaneScratch k3_carve(float* scratch, long long lane, int K) {
    float* base = scratch + lane_offset<K3_TILE>(lane, k3_scratch_floats_per_lane(K));
    LaneScratch s;
#define K3_TAKE(name, floats) \
    s.name = base;            \
    base += (size_t)(floats) * K3_TILE;
    K3_SCRATCH_LANE_ARRAYS(K3_TAKE)
#undef K3_TAKE
    return s;
}

// One 16-byte load of the caller's operands (read only for the whole launch).
// The L2 fetches the 128 bytes around it: a lane's next stage lies right
// behind the one asked for, so one access to device memory brings both.
__device__ __forceinline__ float4 k3_ldg4(const float4* p) {
#if defined(__CUDA_ARCH__)
    float4 v;
    asm("ld.global.nc.L2::128B.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p));
    return v;
#else
    return __ldg(p);
#endif
}

// COUNT consecutive floats of the caller's operands, as 16-byte vectors where
// K3_VEC allows.
template <int COUNT>
__device__ __forceinline__ void k3_load(const float* __restrict__ p, float (&dst)[COUNT]) {
    if constexpr (K3_VEC && COUNT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < COUNT / 4; ++j) {
            const float4 v = k3_ldg4(reinterpret_cast<const float4*>(p) + j);
            dst[4 * j] = v.x;
            dst[4 * j + 1] = v.y;
            dst[4 * j + 2] = v.z;
            dst[4 * j + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < COUNT; ++j) dst[j] = __ldg(p + j);
    }
}

__device__ __forceinline__ void k3_store_x(float* p, const float (&v)[NZ]) {
    if constexpr (K3_VEC) {
#pragma unroll
        for (int j = 0; j < NZ / 4; ++j)
            reinterpret_cast<float4*>(p)[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                                          v[4 * j + 3]);
    } else {
#pragma unroll
        for (int j = 0; j < NZ; ++j) p[j] = v[j];
    }
}

// X = L^-1 Ob (every column) and z = L^-1 r: NZ + 1 chains of quotients that
// wait for L only, interleaved.
template <bool FAST>
__device__ __forceinline__ bool solve_block_and_vec(const float (&L)[NZ][NZ],
                                                    const float (&Linv)[NZ],
                                                    const float (&Ob)[NZ * NZ],
                                                    const float (&r)[NZ], float (&X)[NZ][NZ],
                                                    float (&z)[NZ]) {
    bool bad = false;
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
        for (int c = 0; c < NZ; ++c) {
            float acc = Ob[i * NZ + c];
#pragma unroll
            for (int t = 0; t < i; ++t) acc -= L[i][t] * X[t][c];
            X[i][c] = quotient<FAST>(acc, L[i][i], Linv[i], bad);
        }
        float acc = r[i];
#pragma unroll
        for (int t = 0; t < i; ++t) acc -= L[i][t] * z[t];
        z[i] = quotient<FAST>(acc, L[i][i], Linv[i], bad);
    }
    return bad;
}

// Stage record of the backward sweep: f as solve_upper_rec takes it (the
// diagonal factor packed lower, then the reciprocals of its pivots, which are
// recomputed here rather than stored: four divisions off the chain cost less
// than 16 more bytes per stage each way).
__device__ __forceinline__ void k3_record(const float (&packed)[NTRI], float (&f)[BT_FREC]) {
#pragma unroll
    for (int e = 0; e < NTRI; ++e) f[e] = packed[e];
#pragma unroll
    for (int i = 0; i < NZ; ++i) f[NTRI + i] = pivot_reciprocal(f[TRI(i, i)]);
}

// Inputs of one stage of the factor sweep: D_k (the whole block; its upper
// triangle comes with the vector loads and is never used), O_{k-1} and b_k.
struct K3Stage {
    float D[NZ * NZ];
    float O[NZ * NZ];
    float b[NZ];
};

__device__ __forceinline__ void k3_load_stage(const float* __restrict__ D,
                                              const float* __restrict__ O,
                                              const float* __restrict__ b, int k, int K,
                                              K3Stage& in) {
    if (k >= K) return;
    k3_load(D + (size_t)k * NZ * NZ, in.D);
    k3_load(b + (size_t)k * NZ, in.b);
    if (k > 0) k3_load(O + (size_t)(k - 1) * NZ * NZ, in.O);
}

// What a stage of the backward sweep reads back from the scratch: the
// diagonal factor packed lower, Lo of the interval below it, and z.
struct K3Back {
    float L[NTRI];
    float Lo[NZ][NZ];
    float v[NZ];
};

__device__ __forceinline__ void k3_load_back(const LaneScratch& s, int k, K3Back& in) {
    if (k < 0) return;
#pragma unroll
    for (int e = 0; e < NTRI; ++e) in.L[e] = s.Ld[(size_t)(k * NTRI + e) * K3_TILE];
    load_block<K3_TILE>(s.Lo, k, in.Lo);
    load_vec<K3_TILE>(s.z, k, in.v);
}

// D, O, b, x: batch-first; lane l's arrays start at D + l * strideD etc.
// (strides in floats; strideD, strideO may be 0), each contiguous. scratch:
// tile-major, k3_scratch_floats_per_lane(K) floats per lane.
__global__ void __launch_bounds__(BLOCK_THREADS)
btridiag_factor_solve_scratch_kernel(const float* __restrict__ D, const float* __restrict__ O,
                                     const float* __restrict__ b, float* __restrict__ x,
                                     float* __restrict__ scratch, long long B, int K,
                                     long long strideD, long long strideO, long long strideb) {
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    D += lane * strideD;
    O += lane * strideO;
    b += lane * strideb;
    x += lane * (long long)(K * NZ);
    const LaneScratch s = k3_carve(scratch, lane, K);

    float L[NZ][NZ] = {};  // factor of the previous stage
    float Linv[NZ] = {};   // reciprocals of its pivots
    bool pivots_ok = false;  // ... all inside quotient's window
    float r[NZ] = {};      // b_{k-1} - Lo_{k-2} z_{k-2}: what z_{k-1} is solved from
    float zv[NZ] = {};     // z_{k-1}

    // ---- forward: factor stage k, and z_{k-1} beside X from the same factor ----
    K3Stage in;
    k3_load_stage(D, O, b, 0, K, in);
    for (int k = 0; k < K; ++k) {
        float S[NZ][NZ], rk[NZ];
#pragma unroll
        for (int i = 0; i < NZ; ++i)
#pragma unroll
            for (int j = 0; j <= i; ++j) S[i][j] = in.D[i * NZ + j];
        copy_vec(rk, in.b);
        if (k > 0) {
            float X[NZ][NZ];
            if (!pivots_ok || solve_block_and_vec<true>(L, Linv, in.O, r, X, zv))
                solve_block_and_vec<false>(L, Linv, in.O, r, X, zv);
            store_block_transposed<K3_TILE>(s.Lo, k - 1, X);
            schur_update(S, X);
            store_vec<K3_TILE>(s.z, k - 1, zv);
            sub_Xt_vec(rk, X, zv);
        }
        // the inputs of stage k are used up: ask for stage k + 1
        k3_load_stage(D, O, b, k + 1, K, in);
        chol_block_inv(S, L, Linv);
        pivots_ok = reciprocals_ok(Linv);
        store_packed<K3_TILE>(s.Ld, k, L);
        copy_vec(r, rk);
    }
    // z of the last stage
    if (!pivots_ok || solve_lower_rec<true>(L, Linv, r, zv))
        solve_lower_rec<false>(L, Linv, r, zv);
    store_vec<K3_TILE>(s.z, K - 1, zv);

    // ---- backward: L' x = z (L, Linv, zv hold the last stage's factor and z) ----
    float xv[NZ];
    {
        float f[BT_FREC];
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
            f[NTRI + i] = Linv[i];
#pragma unroll
            for (int j = 0; j <= i; ++j) f[TRI(i, j)] = L[i][j];
        }
        if (!reciprocals_ok(Linv) || solve_upper_rec<true>(f, zv, xv))
            solve_upper_rec<false>(f, zv, xv);
        k3_store_x(x + (size_t)(K - 1) * NZ, xv);
    }
    K3Back back;
    k3_load_back(s, K - 2, back);
    for (int k = K - 2; k >= 0; --k) {
        // right-hand side of stage k: z_k - Lo_k' x_{k+1}
        float f[BT_FREC], rk[NZ];
        k3_record(back.L, f);
        copy_vec(rk, back.v);
        sub_matT_vec(rk, back.Lo, xv);
        k3_load_back(s, k - 1, back);
        if (!reciprocals_ok(f + NTRI) || solve_upper_rec<true>(f, rk, xv))
            solve_upper_rec<false>(f, rk, xv);
        k3_store_x(x + (size_t)k * NZ, xv);
    }
}

extern "C" {

// Floats of scratch a lane takes on K3's kernel; the wrapper holds its own
// formula against this before the first launch.
int btridiag_scratch_floats_per_lane(int K) { return k3_scratch_floats_per_lane(K); }

// K3. p: host array of device pointers to float32 arrays:
//   0 D [B | 1][K*NZ*NZ]  1 O [B | 1][(K-1)*NZ*NZ]  2 b [B][K*NZ]   (batch-first, read only)
//   3 x [B][K*NZ] contiguous                                        (output)
//   4 scratch [ceil(B/32)][btridiag_scratch_floats_per_lane(K)][32]  (the kernel's own)
// strides: floats between consecutive lanes of D, O, b (0: one copy for all).
// Where NZ % 4 == 0 every lane's array must start 16-byte aligned.
// info (4 ints, may be null): 0 blocks  1 threads per block  2 registers per
//   thread  3 resident blocks per SM.
// Returns cudaErrorInvalidValue for misaligned operands, else the first CUDA
// error of the attribute calls or cudaGetLastError() after the launch.
int btridiag_factor_solve_scratch_launch(void* const* p, long long B, int K, long long strideD,
                                         long long strideO, long long strideb, int* info,
                                         void* stream) {
    if (B <= 0) return 0;
    if (K < 1) return (int)cudaErrorInvalidValue;
    if (K3_VEC) {
        for (int i = 0; i < 4; ++i)
            if ((size_t)p[i] % 16 != 0) return (int)cudaErrorInvalidValue;
        if (strideD % 4 || strideO % 4 || strideb % 4) return (int)cudaErrorInvalidValue;
    }
    const unsigned grid = (unsigned)((B + BLOCK_THREADS - 1) / BLOCK_THREADS);
    if (info) {
        const void* kernel = (const void*)btridiag_factor_solve_scratch_kernel;
        int per_sm = 0;
        cudaError_t err =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK_THREADS, 0);
        if (err != cudaSuccess) return (int)err;
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return (int)err;
        info[0] = (int)grid;
        info[1] = BLOCK_THREADS;
        info[2] = attr.numRegs;
        info[3] = per_sm;
    }
    btridiag_factor_solve_scratch_kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)p[0], (const float*)p[1], (const float*)p[2], (float*)p[3], (float*)p[4],
        B, K, strideD, strideO, strideb);
    return (int)cudaGetLastError();
}

}  // extern "C"
