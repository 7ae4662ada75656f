// K3's kernel with its design choices as compile-time knobs, for
// tools/chip_probes/k3_variants.py. The probe splices this text over the K3
// section of control_box_rst_tpu_torch/csrc/btridiag_kernel.cu (everything
// from the K3 banner to the end of the file) in a copy of that source, and
// builds the copy once per choice:
//   K3_SWEEPS    2: z is solved in the factor sweep (what the shipped kernel
//                does); 3: z takes a sweep of its own, as the TPU kernel does;
//   K3_PREFETCH  stages whose loads are in flight while one is computed
//                (the shipped kernel: 1);
//   K3_L2_FETCH  bytes the L2 fetches around a 16-byte operand load, 0 for
//                no hint (the shipped kernel: 128).
// With 2, 1, 128 it is the shipped kernel statement for statement.

#ifndef K3_SWEEPS
#define K3_SWEEPS 2  // 2: z is solved in the factor sweep; 3: z takes a sweep of its own
#endif
#ifndef K3_PREFETCH
#define K3_PREFETCH 1  // stages whose loads are in flight while one is computed
#endif
#ifndef K3_L2_FETCH
#define K3_L2_FETCH 128  // bytes the L2 fetches around a 16-byte operand load (0, 64, 128, 256)
#endif
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

#define K3_STR_(x) #x
#define K3_STR(x) K3_STR_(x)

// One 16-byte load of the caller's operands (read only for the whole launch).
// With K3_L2_FETCH the L2 fetches that many bytes around it: a lane's next
// stages lie right behind the one asked for.
__device__ __forceinline__ float4 k3_ldg4(const float4* p) {
#if defined(__CUDA_ARCH__) && K3_L2_FETCH > 0
    float4 v;
    asm("ld.global.nc.L2::" K3_STR(K3_L2_FETCH) "B.v4.f32 {%0, %1, %2, %3}, [%4];"
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

// X = L^-1 Ob (every column) and, WITH_Z, z = L^-1 r: NZ + 1 chains of
// quotients that wait for L only, interleaved.
template <bool FAST, bool WITH_Z>
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
        if (WITH_Z) {
            float acc = r[i];
#pragma unroll
            for (int t = 0; t < i; ++t) acc -= L[i][t] * z[t];
            z[i] = quotient<FAST>(acc, L[i][i], Linv[i], bad);
        }
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
// triangle comes with the vector loads and is never used), O_{k-1}, and b_k
// where z is solved in this sweep.
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
    if (K3_SWEEPS == 2) k3_load(b + (size_t)k * NZ, in.b);
    if (k > 0) k3_load(O + (size_t)(k - 1) * NZ * NZ, in.O);
}

// What a stage of the z sweep (K3_SWEEPS 3) or of the backward sweep reads
// back from the scratch: the diagonal factor packed lower, Lo of the interval
// beside it, and b (z sweep) or z (backward sweep).
struct K3Back {
    float L[NTRI];
    float Lo[NZ][NZ];
    float v[NZ];
};

// backward: Ld_k, Lo_k, z_k (k >= 0)
__device__ __forceinline__ void k3_load_back(const LaneScratch& s, int k, K3Back& in) {
    if (k < 0) return;
#pragma unroll
    for (int e = 0; e < NTRI; ++e) in.L[e] = s.Ld[(size_t)(k * NTRI + e) * K3_TILE];
    load_block<K3_TILE>(s.Lo, k, in.Lo);
    load_vec<K3_TILE>(s.z, k, in.v);
}

// z sweep: Ld_k, Lo_{k-1}, b_k (k < K)
__device__ __forceinline__ void k3_load_zstage(const LaneScratch& s, const float* __restrict__ b,
                                               int k, int K, K3Back& in) {
    if (k >= K) return;
#pragma unroll
    for (int e = 0; e < NTRI; ++e) in.L[e] = s.Ld[(size_t)(k * NTRI + e) * K3_TILE];
    if (k > 0) load_block<K3_TILE>(s.Lo, k - 1, in.Lo);
    k3_load(b + (size_t)k * NZ, in.v);
}

// D, O, b, x: batch-first; lane l's arrays start at D + l * strideD etc.
// (strides in floats; strideD, strideO may be 0), each contiguous. scratch:
// tile-major, k3_scratch_floats_per_lane(K) floats per lane.
__global__ void __launch_bounds__(BLOCK_THREADS)
btridiag_factor_solve_scratch_kernel(const float* __restrict__ D, const float* __restrict__ O,
                                     const float* __restrict__ b, float* __restrict__ x,
                                     float* __restrict__ scratch, long long B, int K,
                                     long long strideD, long long strideO, long long strideb) {
    constexpr bool FUSED = K3_SWEEPS == 2;
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
    float r[NZ] = {};      // (FUSED) b_{k-1} - Lo_{k-2} z_{k-2}: what z_{k-1} is solved from
    float zv[NZ] = {};     // (FUSED) z_{k-1}

    // ---- forward: factor stage k (FUSED: and z_{k-1}, beside X, from one factor) ----
    {
        K3Stage q[K3_PREFETCH];
#pragma unroll
        for (int u = 0; u < K3_PREFETCH; ++u) k3_load_stage(D, O, b, u, K, q[u]);
        for (int k0 = 0; k0 < K; k0 += K3_PREFETCH) {
#pragma unroll
            for (int u = 0; u < K3_PREFETCH; ++u) {
                const int k = k0 + u;
                if (k < K) {
                    float S[NZ][NZ], rk[NZ];
#pragma unroll
                    for (int i = 0; i < NZ; ++i)
#pragma unroll
                        for (int j = 0; j <= i; ++j) S[i][j] = q[u].D[i * NZ + j];
                    if (FUSED) copy_vec(rk, q[u].b);
                    if (k > 0) {
                        float X[NZ][NZ];
                        if (!pivots_ok ||
                            solve_block_and_vec<true, FUSED>(L, Linv, q[u].O, r, X, zv))
                            solve_block_and_vec<false, FUSED>(L, Linv, q[u].O, r, X, zv);
                        store_block_transposed<K3_TILE>(s.Lo, k - 1, X);
                        schur_update(S, X);
                        if (FUSED) {
                            store_vec<K3_TILE>(s.z, k - 1, zv);
                            sub_Xt_vec(rk, X, zv);
                        }
                    }
                    // the inputs of stage k are used up: ask for stage k + K3_PREFETCH
                    k3_load_stage(D, O, b, k + K3_PREFETCH, K, q[u]);
                    chol_block_inv(S, L, Linv);
                    pivots_ok = reciprocals_ok(Linv);
                    store_packed<K3_TILE>(s.Ld, k, L);
                    if (FUSED) copy_vec(r, rk);
                }
            }
        }
    }
    if (FUSED) {
        // z of the last stage
        if (!pivots_ok || solve_lower_rec<true>(L, Linv, r, zv))
            solve_lower_rec<false>(L, Linv, r, zv);
        store_vec<K3_TILE>(s.z, K - 1, zv);
    } else {
        // ---- L z = b: z_k = L_k^-1 (b_k - Lo_{k-1} z_{k-1}) ----
        K3Back q[K3_PREFETCH];
#pragma unroll
        for (int u = 0; u < K3_PREFETCH; ++u) k3_load_zstage(s, b, u, K, q[u]);
        for (int k0 = 0; k0 < K; k0 += K3_PREFETCH) {
#pragma unroll
            for (int u = 0; u < K3_PREFETCH; ++u) {
                const int k = k0 + u;
                if (k < K) {
                    float f[BT_FREC], rk[NZ];
                    k3_record(q[u].L, f);
                    copy_vec(rk, q[u].v);
                    if (k > 0) sub_mat_vec(rk, q[u].Lo, zv);
                    k3_load_zstage(s, b, k + K3_PREFETCH, K, q[u]);
#pragma unroll
                    for (int i = 0; i < NZ; ++i) {
                        Linv[i] = f[NTRI + i];
#pragma unroll
                        for (int j = 0; j <= i; ++j) L[i][j] = f[TRI(i, j)];
                    }
                    if (!reciprocals_ok(Linv) || solve_lower_rec<true>(L, Linv, rk, zv))
                        solve_lower_rec<false>(L, Linv, rk, zv);
                    store_vec<K3_TILE>(s.z, k, zv);
                }
            }
        }
    }

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
    K3Back q[K3_PREFETCH];
#pragma unroll
    for (int u = 0; u < K3_PREFETCH; ++u) k3_load_back(s, K - 2 - u, q[u]);
    for (int k0 = K - 2; k0 >= 0; k0 -= K3_PREFETCH) {
#pragma unroll
        for (int u = 0; u < K3_PREFETCH; ++u) {
            const int k = k0 - u;
            if (k >= 0) {
                // right-hand side of stage k: z_k - Lo_k' x_{k+1}
                float f[BT_FREC], rk[NZ];
                k3_record(q[u].L, f);
                copy_vec(rk, q[u].v);
                sub_matT_vec(rk, q[u].Lo, xv);
                k3_load_back(s, k - K3_PREFETCH, q[u]);
                if (!reciprocals_ok(f + NTRI) || solve_upper_rec<true>(f, rk, xv))
                    solve_upper_rec<false>(f, rk, xv);
                k3_store_x(x + (size_t)k * NZ, xv);
            }
        }
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
