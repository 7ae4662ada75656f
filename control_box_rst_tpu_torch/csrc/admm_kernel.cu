// Box-QP ADMM kernels for NVIDIA Hopper (sm_90a), float32.
//
// What this replaces
// ------------------
// The JAX package's Pallas TPU kernels in control_box_rst_tpu/ops/pallas/
// admm_kernel.py:
//   boxqp_solve   <-  boxqp_solve_pallas / _solve_kernel  (the whole box-QP
//       solve of one lane: up to n_rounds rounds of {assemble
//       M = Hd + sigma I + rho_eq (J'J, K'K, J'K) + diag(rho_box); block-
//       tridiagonal Cholesky, diagonal factors packed lower; `iters` OSQP
//       iterations with the dynamics z eliminated (z_d = -c); recenter;
//       exit test; per-lane rho rescale})
//   admm_round    <-  admm_round_pallas / _kernel  (one such round at fixed
//       rho, no recentering, no exit)
// The arithmetic follows _round_ops / _solve_kernel statement by statement
// (pin test on the unshifted bounds, clip = min(max(v, lo), hi), one-step-
// lookahead dual residual, scale = sqrt(pr / max(dr, 1e-30)), pr and dr start
// at +inf, `it` counts `iters` per round as a float).
//
// What is different from the TPU kernel, on purpose
// -------------------------------------------------
// Exit semantics. The TPU kernel leaves its round loop when EVERY lane of a
// 1024-lane tile has converged, so finished lanes keep iterating and a lane's
// answer depends on its neighbours. Here a lane stops at its own convergence,
// exactly as the per-lane reference of solvers/stage_qp.py does, and `it` is
// the lane's own count. There are no padding lanes.
//
// Two routes, chosen by the wrapper from the shapes alone
// -------------------------------------------------------
// (1) Lane state in shared memory: boxqp_solve_smem_kernel and
//     admm_round_smem_kernel, the route of every shape whose state fits (the
//     second half of this file). A lane's whole mutable state -- x, z_b, y_b,
//     x_tilde, the shifted g and c, the shifted bounds, the per-row rho, y_d,
//     and the factor (per stage one record of the diagonal block, packed
//     lower, with the reciprocals of its pivots; the sub-diagonal blocks):
//     the table SMEM_LANE_ARRAYS, 13.8 KB at Kst=51, NZ=4, NC=2 -- is loaded
//     once from the caller's batch-first tensors into dynamic shared memory,
//     stays there for every round and iteration, and the results are written
//     back batch-first. Nothing but the accumulated step (one
//     read-modify-write of the output x per round) and the read-only problem
//     data touches device memory in between, so the wrapper copies no operand
//     and allocates no scratch.
//     A lane is served by a TEAM of 16 threads, two lanes per warp (a
//     compile-time constant). What is elementwise -- the right-hand side of the linear system
//     (every term but the coupling to the previous stage), the x / z_b / y
//     updates, the residuals, the recentering, the KKT test -- is done by
//     the whole team, one element per thread and pass, with max-reductions by
//     __shfl_xor_sync (max is order-independent, so pr, dr, stat, feas keep
//     their bits). What is a dependent chain over the stages -- the block
//     factorization and the two substitutions -- is done by the team's first
//     thread out of shared memory, with the same statements in the same order
//     as route (2), so a lane's bits do not depend on the route (as far as
//     the compiler contracts the same multiply-adds). Several lanes per warp
//     put several such chains into one instruction stream: an instruction
//     issued for one lane costs the same as one issued for four.
//     The teams of a warp run their rounds in lock step (every round is the
//     same sequence of phases), a team takes its next lane from an atomic
//     counter at a round boundary, and every exit is uniform over the team:
//     nothing waits for the slowest lane of a group of 32 any more, and a
//     launch ends when the queue is empty. Blocks are persistent: as many
//     warps as the 227 KB of an SM hold (8 warps of 2 lanes at the shapes
//     above), as many blocks as fit the card.
//     Hd, J, K shared by all lanes (an LTI problem) are read through L1 from
//     the one copy; per-lane J and K are copied into the lane's shared memory
//     (+3.2 KB), per-lane Hd is read from device memory once per round.
// (2) One thread per lane, state in device memory: boxqp_solve_kernel and
//     admm_round_kernel, for shapes whose state does not fit in shared memory
//     (long horizons). NZ and NC are compile-time constants, per-lane arrays
//     are tile-major [ceil(B/32)][rows][32] (a warp reads 32 neighbouring
//     floats at every access) and the wrapper converts layouts in and out.
//     Every iteration streams the lane's state from device memory three
//     times: the route is bound by bytes.
//
// What bounds route (1) on this card
// ----------------------------------
// Not bytes: a lane moves its inputs and outputs once (4.7 KB in, 2.9 KB out
// at the shapes above). The work is ~12,500 float32 operations per iteration,
// of which the two substitutions are a chain of 2*Kst stages that no thread
// can start before the previous one ended. What the chain thread pays for is
// its instruction count: a lone thread of a warp gets an issue slot every ~3
// cycles whatever the instruction, so a stage costs that count, not its
// arithmetic. The design therefore spends its effort there: a stage's factor is one 64-byte record plus one 64-byte block,
// read with 128-bit loads into one of two register buffers while the previous
// stage's chain runs (no copies between the buffers); the NZ divisions of a
// stage, each ~45 cycles and hundreds where the numerator is exactly zero (a
// pinned row: the hardware's slow path), are replaced by the same quotient
// built from the pivot's reciprocal, which the factorization has anyway
// (quotient<> of quotient.cuh: bit-identical to the division, checked on the
// card); the checks that guard it are hoisted to once per pivot and round. A
// stage of a substitution is an instruction count of ~75, ~230 cycles; an
// iteration ~30 k cycles of which the chain is 24 k; a factorization ~90 k.
// The card hides that latency only with other lanes, and shared memory
// bounds how many are
// resident (16 per SM): the kernel is bound by the issue slots and latency of
// the chains, i.e. by operations, far below the 67 TFLOP/s the operation
// bound assumes.
//
// Tensor cores (wgmma, mma.sync) are not used: the blocks are 4x4 and 2x4 in
// float32, wgmma takes 64-row tiles in TF32 at best, and TF32's three decimal
// digits would break exit tests that sit at 1e-5 on ill-conditioned systems.
// TMA / cp.async.bulk staging of the next lane's operands is not used either:
// a lane loads 4.7 KB once per ~10^6 cycles of work, and a second buffer
// would cost resident lanes.
//
// No -use_fast_math: the iteration divides by Cholesky pivots and takes
// sqrtf, and the exit tests sit at 1e-5.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "quotient.cuh"

#ifndef NZ
#define NZ 4
#endif
#ifndef NC
#define NC 2
#endif
#define NTRI (NZ * (NZ + 1) / 2)
#define TRI(i, j) ((i) * ((i) + 1) / 2 + (j))
#define BLOCK_THREADS 128
// Lane layout of every per-lane [rows, B] array: tile-major
// [ceil(B/T)][rows][T], element (idx, lane) at
// ((lane / T) * rows + idx) * T + lane % T. The tile width T is a template
// parameter with two instances. T = 32 (batches of at least a warp): a warp
// is one tile, its share of an array is one contiguous block that the stage
// sweeps stream through in order. T = 1 (fewer lanes than a warp, the
// single-solve case): each lane's arrays are contiguous, so the one thread
// walking them finds 32 consecutive elements in every 128-byte line.

// Views of one QP batch; every pointer is offset to the thread's lane before
// use, after which element idx is p[idx * T]. Hd, J and K may instead
// be ONE copy shared by all lanes (shared_hjk: plain [rows] arrays, element
// idx at p[idx]) — the structure of an LTI problem is the same in every lane,
// and a warp reading one address is one transaction.
struct QPView {
    const float* __restrict__ Hd;   // [Kst*NZ*NZ, B] or [Kst*NZ*NZ]
    const float* __restrict__ J;    // [N*NC*NZ, B] or [N*NC*NZ]
    const float* __restrict__ K;    // [N*NC*NZ, B] or [N*NC*NZ]
    const float* __restrict__ dlb;  // [Kst*NZ, B]  unshifted box bounds
    const float* __restrict__ dub;  // [Kst*NZ, B]
    const float* g;                 // [Kst*NZ, B]  (the full solve shifts its copy)
    const float* c;                 // [N*NC, B]
    float* x;                       // [Kst*NZ, B]  state, updated in place
    float* zb;                      // [Kst*NZ, B]
    float* yd;                      // [N*NC, B]
    float* yb;                      // [Kst*NZ, B]
    float* Ld;                      // [Kst*NTRI, B] scratch: packed diagonal factors
    float* Lo;                      // [N*NZ*NZ, B]  scratch: sub-diagonal factors
    float* xt;                      // [Kst*NZ, B]   scratch: x_tilde
    const float* xtot;              // [Kst*NZ, B]   accumulated step (full solve only)
    long long B;
    int Kst;
    int shared_hjk;
};

// Offset of a lane's first element in a per-lane [rows, B] array.
template <int T>
__device__ __forceinline__ long long lane_offset(long long lane, int rows) {
    return (lane / T) * (long long)rows * T + lane % T;
}

template <int T>
__device__ __forceinline__ QPView at_lane(QPView v, long long lane) {
    const int Kst = v.Kst, N = Kst - 1;
    const long long o_hd = v.shared_hjk ? 0 : lane_offset<T>(lane, Kst * NZ * NZ);
    const long long o_jk = v.shared_hjk ? 0 : lane_offset<T>(lane, N * NC * NZ);
    const long long o_st = lane_offset<T>(lane, Kst * NZ);   // stage vectors
    const long long o_iv = lane_offset<T>(lane, N * NC);     // interval vectors
    v.Hd += o_hd; v.J += o_jk; v.K += o_jk; v.dlb += o_st; v.dub += o_st;
    v.g += o_st; v.c += o_iv;
    v.x += o_st; v.zb += o_st; v.yd += o_iv; v.yb += o_st;
    v.Ld += lane_offset<T>(lane, Kst * NTRI);
    v.Lo += lane_offset<T>(lane, N * NZ * NZ);
    v.xt += o_st;
    if (v.xtot) v.xtot += o_st;
    return v;
}

__device__ __forceinline__ float clipf(float val, float lo, float hi) {
    return fminf(fmaxf(val, lo), hi);
}

// One rho-round on the lane's state: assemble M for this rho, factor it, run
// `iters` ADMM iterations in place, return (pr, dr) of the final iterate.
// SHIFT: box bounds are [dlb - xtot, dub - xtot] (the recentered full solve).
template <bool SHIFT, int T>
__device__ void round_ops(const QPView& v, float rho, int iters, float sigma,
                          float alpha, float rho_eq_scale, float& pr_out,
                          float& dr_out) {
    const int Kst = v.Kst;
    const int N = Kst - 1;
    constexpr size_t B = T;  // stride between a lane's elements
    const size_t BH = v.shared_hjk ? 1 : T;  // ... of Hd, J, K
    const float rho_eq = rho * rho_eq_scale;

#define RHO_BOX(idx) ((v.dlb[(idx) * B] == v.dub[(idx) * B]) ? rho_eq : rho)
#define BOX_LO(idx) (SHIFT ? v.dlb[(idx) * B] - v.xtot[(idx) * B] : v.dlb[(idx) * B])
#define BOX_HI(idx) (SHIFT ? v.dub[(idx) * B] - v.xtot[(idx) * B] : v.dub[(idx) * B])

    // ---- assemble + factor M = L L' stage by stage ----
    {
        float L[NZ][NZ];            // diagonal factor of the previous stage
        float Jp[NC][NZ], Kp[NC][NZ];  // J_{k-1}, K_{k-1}
#pragma unroll
        for (int r = 0; r < NC; ++r)
#pragma unroll
            for (int i = 0; i < NZ; ++i) { Jp[r][i] = 0.f; Kp[r][i] = 0.f; }
#pragma unroll
        for (int i = 0; i < NZ; ++i)
#pragma unroll
            for (int j = 0; j < NZ; ++j) L[i][j] = 0.f;

        for (int k = 0; k < Kst; ++k) {
            float Jk[NC][NZ];
            if (k < N) {
#pragma unroll
                for (int r = 0; r < NC; ++r)
#pragma unroll
                    for (int i = 0; i < NZ; ++i)
                        Jk[r][i] = v.J[(size_t)((k * NC + r) * NZ + i) * BH];
            }
            // D_k = Hd_k + sigma I + rho_eq (J_k'J_k [k<N] + K_{k-1}'K_{k-1} [k>0])
            //       + diag(rho_box)   (lower triangle)
            float S[NZ][NZ];
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
#pragma unroll
                for (int j = 0; j <= i; ++j) {
                    float acc = v.Hd[(size_t)((k * NZ + i) * NZ + j) * BH];
                    // rho_eq times the sum over rows, not one product per
                    // row: one rounding of rho_eq, as in the plain version
                    // (twice the roundoff on stiff columns otherwise)
                    if (k < N) {
                        float o = Jk[0][i] * Jk[0][j];
#pragma unroll
                        for (int r = 1; r < NC; ++r) o += Jk[r][i] * Jk[r][j];
                        acc += rho_eq * o;
                    }
                    if (k > 0) {
                        float o = Kp[0][i] * Kp[0][j];
#pragma unroll
                        for (int r = 1; r < NC; ++r) o += Kp[r][i] * Kp[r][j];
                        acc += rho_eq * o;
                    }
                    if (i == j) acc += sigma + RHO_BOX((size_t)(k * NZ + i));
                    S[i][j] = acc;
                }
            }
            if (k > 0) {
                // O_{k-1} = rho_eq J_{k-1}' K_{k-1};  X = Lprev^{-1} O;
                // S = D_k - X'X;  Lo_{k-1} = X'
                float X[NZ][NZ];
#pragma unroll
                for (int cc = 0; cc < NZ; ++cc) {
#pragma unroll
                    for (int i = 0; i < NZ; ++i) {
                        float o = Jp[0][i] * Kp[0][cc];
#pragma unroll
                        for (int r = 1; r < NC; ++r) o += Jp[r][i] * Kp[r][cc];
                        float s = rho_eq * o;
#pragma unroll
                        for (int t = 0; t < i; ++t) s -= L[i][t] * X[t][cc];
                        X[i][cc] = s / L[i][i];
                    }
                }
#pragma unroll
                for (int i = 0; i < NZ; ++i)
#pragma unroll
                    for (int j = 0; j <= i; ++j) {
                        float acc = S[i][j];
#pragma unroll
                        for (int t = 0; t < NZ; ++t) acc -= X[t][i] * X[t][j];
                        S[i][j] = acc;
                    }
#pragma unroll
                for (int i = 0; i < NZ; ++i)
#pragma unroll
                    for (int j = 0; j < NZ; ++j)
                        v.Lo[(size_t)(((k - 1) * NZ + i) * NZ + j) * B] = X[j][i];
            }
            // Cholesky of S into L, stored packed lower
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
#pragma unroll
            for (int i = 0; i < NZ; ++i)
#pragma unroll
                for (int j = 0; j <= i; ++j)
                    v.Ld[(size_t)(k * NTRI + TRI(i, j)) * B] = L[i][j];
            if (k < N) {
#pragma unroll
                for (int r = 0; r < NC; ++r)
#pragma unroll
                    for (int i = 0; i < NZ; ++i) {
                        Jp[r][i] = Jk[r][i];
                        Kp[r][i] = v.K[(size_t)((k * NC + r) * NZ + i) * BH];
                    }
            }
        }
    }

    // ---- ADMM iterations ----
    for (int it = 0; it < iters; ++it) {
        // forward substitution fused with the right-hand side:
        //   rhs = sigma x - g + J'(vd)|_k + K'(vd)|_{k-1} + (rho_b z_b - y_b),
        //   vd[k] = -rho_eq c[k] - y_d[k]
        float z[NZ];     // L^{-1} rhs of the previous stage
        float vdp[NC];   // vd of interval k-1
#pragma unroll
        for (int i = 0; i < NZ; ++i) z[i] = 0.f;
#pragma unroll
        for (int r = 0; r < NC; ++r) vdp[r] = 0.f;
        for (int k = 0; k < Kst; ++k) {
            float rhs[NZ];
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                const size_t idx = (size_t)(k * NZ + i);
                float s = sigma * v.x[idx * B] - v.g[idx * B];
                s += RHO_BOX(idx) * v.zb[idx * B] - v.yb[idx * B];
                rhs[i] = s;
            }
            float vdk[NC];
            if (k < N) {
#pragma unroll
                for (int r = 0; r < NC; ++r) {
                    const size_t ridx = (size_t)(k * NC + r);
                    vdk[r] = -rho_eq * v.c[ridx * B] - v.yd[ridx * B];
#pragma unroll
                    for (int i = 0; i < NZ; ++i)
                        rhs[i] += v.J[(ridx * NZ + i) * BH] * vdk[r];
                }
            }
            if (k > 0) {
#pragma unroll
                for (int r = 0; r < NC; ++r) {
                    const size_t ridx = (size_t)((k - 1) * NC + r);
#pragma unroll
                    for (int i = 0; i < NZ; ++i)
                        rhs[i] += v.K[(ridx * NZ + i) * BH] * vdp[r];
                }
#pragma unroll
                for (int i = 0; i < NZ; ++i) {
                    float s = rhs[i];
#pragma unroll
                    for (int t = 0; t < NZ; ++t)
                        s -= v.Lo[(size_t)(((k - 1) * NZ + i) * NZ + t) * B] * z[t];
                    rhs[i] = s;
                }
            }
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                float s = rhs[i];
#pragma unroll
                for (int t = 0; t < i; ++t)
                    s -= v.Ld[(size_t)(k * NTRI + TRI(i, t)) * B] * z[t];
                z[i] = s / v.Ld[(size_t)(k * NTRI + TRI(i, i)) * B];
            }
#pragma unroll
            for (int i = 0; i < NZ; ++i) v.xt[(size_t)(k * NZ + i) * B] = z[i];
            if (k < N) {
#pragma unroll
                for (int r = 0; r < NC; ++r) vdp[r] = vdk[r];
            }
        }
        // backward substitution (z of the last stage is still in registers)
        float xn[NZ];  // x_tilde of stage k+1
        for (int k = Kst - 1; k >= 0; --k) {
            float rhs[NZ];
            if (k == Kst - 1) {
#pragma unroll
                for (int i = 0; i < NZ; ++i) rhs[i] = z[i];
            } else {
#pragma unroll
                for (int i = 0; i < NZ; ++i) {
                    float s = v.xt[(size_t)(k * NZ + i) * B];
#pragma unroll
                    for (int t = 0; t < NZ; ++t)
                        s -= v.Lo[(size_t)((k * NZ + t) * NZ + i) * B] * xn[t];
                    rhs[i] = s;
                }
            }
#pragma unroll
            for (int i = NZ - 1; i >= 0; --i) {
                float s = rhs[i];
#pragma unroll
                for (int t = i + 1; t < NZ; ++t)
                    s -= v.Ld[(size_t)(k * NTRI + TRI(t, i)) * B] * xn[t];
                xn[i] = s / v.Ld[(size_t)(k * NTRI + TRI(i, i)) * B];
            }
#pragma unroll
            for (int i = 0; i < NZ; ++i) v.xt[(size_t)(k * NZ + i) * B] = xn[i];
        }
        // updates, one pass (xn holds x_tilde of stage 0 here)
        float xc[NZ];
#pragma unroll
        for (int i = 0; i < NZ; ++i) xc[i] = xn[i];
        // Every stage loads all it needs first and stores last: the state
        // arrays may alias as far as the compiler knows, so a load written
        // after a store cannot be moved above it, and interleaving them
        // would cost one memory round trip per element instead of per stage.
        for (int k = 0; k < Kst; ++k) {
            float xo[NZ], zbo[NZ], ybo[NZ], rb[NZ], lo[NZ], hi[NZ];
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                const size_t idx = (size_t)(k * NZ + i);
                xo[i] = v.x[idx * B];
                zbo[i] = v.zb[idx * B];
                ybo[i] = v.yb[idx * B];
                rb[i] = RHO_BOX(idx);
                lo[i] = BOX_LO(idx);
                hi[i] = BOX_HI(idx);
            }
            float x1[NZ], ydn[NC];
            if (k < N) {
#pragma unroll
                for (int i = 0; i < NZ; ++i) x1[i] = v.xt[(size_t)((k + 1) * NZ + i) * B];
#pragma unroll
                for (int r = 0; r < NC; ++r) {
                    const size_t ridx = (size_t)(k * NC + r);
                    float ax = 0.f;
#pragma unroll
                    for (int i = 0; i < NZ; ++i) {
                        ax += v.J[(ridx * NZ + i) * BH] * xc[i];
                        ax += v.K[(ridx * NZ + i) * BH] * x1[i];
                    }
                    const float cr = v.c[ridx * B];
                    const float v_d = alpha * ax + (1.0f - alpha) * (-cr);
                    ydn[r] = v.yd[ridx * B] + rho_eq * (v_d + cr);
                }
            }
            float xnew[NZ], zbn[NZ], ybn[NZ];
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                xnew[i] = alpha * xc[i] + (1.0f - alpha) * xo[i];
                const float v_b = alpha * xc[i] + (1.0f - alpha) * zbo[i];
                zbn[i] = clipf(v_b + ybo[i] / rb[i], lo[i], hi[i]);
                ybn[i] = ybo[i] + rb[i] * (v_b - zbn[i]);
            }
            if (k < N) {
#pragma unroll
                for (int r = 0; r < NC; ++r) v.yd[(size_t)(k * NC + r) * B] = ydn[r];
            }
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                const size_t idx = (size_t)(k * NZ + i);
                v.x[idx * B] = xnew[i];
                v.yb[idx * B] = ybn[i];
                v.zb[idx * B] = zbn[i];
            }
            if (k < N) {
#pragma unroll
                for (int i = 0; i < NZ; ++i) xc[i] = x1[i];
            }
        }
    }

    // ---- residuals, once, on the final iterate (x_tilde is in xt) ----
    float pr = 0.f, dr = 0.f;
    {
        float xc[NZ];
#pragma unroll
        for (int i = 0; i < NZ; ++i) xc[i] = v.xt[(size_t)i * B];
        for (int k = 0; k < Kst; ++k) {
            float x1[NZ];
            if (k < N) {
#pragma unroll
                for (int i = 0; i < NZ; ++i) x1[i] = v.xt[(size_t)((k + 1) * NZ + i) * B];
#pragma unroll
                for (int r = 0; r < NC; ++r) {
                    const size_t ridx = (size_t)(k * NC + r);
                    float ax = 0.f;
#pragma unroll
                    for (int i = 0; i < NZ; ++i) {
                        ax += v.J[(ridx * NZ + i) * BH] * xc[i];
                        ax += v.K[(ridx * NZ + i) * BH] * x1[i];
                    }
                    pr = fmaxf(pr, fabsf(ax + v.c[ridx * B]));
                }
            }
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                const size_t idx = (size_t)(k * NZ + i);
                const float zb = v.zb[idx * B];
                pr = fmaxf(pr, fabsf(xc[i] - zb));
                // dual residual, one-step lookahead: the box z-update the
                // NEXT iteration would make from this iterate
                const float rb = RHO_BOX(idx);
                const float v_b = alpha * xc[i] + (1.0f - alpha) * zb;
                const float z_new =
                    clipf(v_b + v.yb[idx * B] / rb, BOX_LO(idx), BOX_HI(idx));
                dr = fmaxf(dr, fabsf(rb * (z_new - zb)));
            }
            if (k < N) {
#pragma unroll
                for (int i = 0; i < NZ; ++i) xc[i] = x1[i];
            }
        }
    }
    pr_out = pr;
    dr_out = dr;
#undef RHO_BOX
#undef BOX_LO
#undef BOX_HI
}

// K2: one rho-round at fixed per-lane rho.
template <int T>
__global__ void __launch_bounds__(BLOCK_THREADS)
admm_round_kernel(QPView v, const float* __restrict__ rho, float* pr, float* dr,
                  int iters, float sigma, float alpha, float rho_eq_scale) {
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= v.B) return;
    const QPView w = at_lane<T>(v, lane);
    float p, d;
    round_ops<false, T>(w, rho[lane], iters, sigma, alpha, rho_eq_scale, p, d);
    pr[lane] = p;
    dr[lane] = d;
}

// K1: the whole box-QP solve. gs, cs are the lane's own copies of g and c
// (shifted in place by the recentering); xtot accumulates the step and is the
// solution on return (the wrapper zero-fills it).
template <int T>
__global__ void __launch_bounds__(BLOCK_THREADS)
boxqp_solve_kernel(QPView v, float* gs, float* cs, float* xtot,
                   const float* __restrict__ rho0, float* pr_o, float* dr_o,
                   float* it_o, int n_rounds, int iters, float tol, float sigma,
                   float alpha, float rho_eq_scale, float rho_min, float rho_max,
                   float tol_stat, float tol_feas) {
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= v.B) return;
    v.g = gs; v.c = cs; v.xtot = xtot;
    const QPView w = at_lane<T>(v, lane);
    const int Kst = w.Kst, N = Kst - 1;
    gs += lane_offset<T>(lane, Kst * NZ);
    cs += lane_offset<T>(lane, N * NC);
    xtot += lane_offset<T>(lane, Kst * NZ);
    constexpr size_t B = T;
    const size_t BH = w.shared_hjk ? 1 : T;
    const bool use_kkt = (tol_stat > 0.0f) && (tol_feas > 0.0f);

    float rho = rho0[lane];
    float it = 0.f;
    float pr = CUDART_INF_F, dr = CUDART_INF_F;

    for (int rnd = 0; rnd < n_rounds; ++rnd) {
        round_ops<true, T>(w, rho, iters, sigma, alpha, rho_eq_scale, pr, dr);

        // ---- recenter: absorb this round's step into the linear data ----
        {
            float xc[NZ];
#pragma unroll
            for (int i = 0; i < NZ; ++i) xc[i] = w.x[(size_t)i * B];
            // (loads first, stores last, as in the update pass)
            for (int k = 0; k < Kst; ++k) {
                float x1[NZ], csn[NC];
                if (k < N) {
#pragma unroll
                    for (int i = 0; i < NZ; ++i) x1[i] = w.x[(size_t)((k + 1) * NZ + i) * B];
#pragma unroll
                    for (int r = 0; r < NC; ++r) {
                        const size_t ridx = (size_t)(k * NC + r);
                        float ax = 0.f;
#pragma unroll
                        for (int i = 0; i < NZ; ++i) {
                            ax += w.J[(ridx * NZ + i) * BH] * xc[i];
                            ax += w.K[(ridx * NZ + i) * BH] * x1[i];
                        }
                        csn[r] = cs[ridx * B] + ax;
                    }
                }
                float gsn[NZ], xtn[NZ], zbn[NZ];
#pragma unroll
                for (int i = 0; i < NZ; ++i) {
                    const size_t idx = (size_t)(k * NZ + i);
                    float gi = gs[idx * B];
#pragma unroll
                    for (int j = 0; j < NZ; ++j)
                        gi += w.Hd[(size_t)((k * NZ + i) * NZ + j) * BH] * xc[j];
                    gsn[i] = gi;
                    xtn[i] = xtot[idx * B] + xc[i];
                    const float lo = w.dlb[idx * B] - xtn[i];
                    const float hi = w.dub[idx * B] - xtn[i];
                    zbn[i] = fminf(fmaxf(0.f, lo), hi);
                }
                if (k < N) {
#pragma unroll
                    for (int r = 0; r < NC; ++r) cs[(size_t)(k * NC + r) * B] = csn[r];
                }
#pragma unroll
                for (int i = 0; i < NZ; ++i) {
                    const size_t idx = (size_t)(k * NZ + i);
                    gs[idx * B] = gsn[i];
                    xtot[idx * B] = xtn[i];
                    w.zb[idx * B] = zbn[i];
                    w.x[idx * B] = 0.f;
                }
                if (k < N) {
#pragma unroll
                    for (int i = 0; i < NZ; ++i) xc[i] = x1[i];
                }
            }
        }
        // ---- convergence ----
        bool conv = (pr < tol) && (dr < tol);
        if (use_kkt) {
            // exact KKT residuals of the LTI QP at the recentered iterate:
            // stat = |g' + A'y| over free rows, feas = |c'|
            float feas = 0.f, stat = 0.f;
            float ydp[NC];
#pragma unroll
            for (int r = 0; r < NC; ++r) ydp[r] = 0.f;
            for (int k = 0; k < Kst; ++k) {
                float s[NZ];
#pragma unroll
                for (int i = 0; i < NZ; ++i) {
                    const size_t idx = (size_t)(k * NZ + i);
                    s[i] = gs[idx * B] + w.yb[idx * B];
                }
                float ydk[NC];
                if (k < N) {
#pragma unroll
                    for (int r = 0; r < NC; ++r) {
                        const size_t ridx = (size_t)(k * NC + r);
                        feas = fmaxf(feas, fabsf(cs[ridx * B]));
                        ydk[r] = w.yd[ridx * B];
#pragma unroll
                        for (int i = 0; i < NZ; ++i)
                            s[i] += w.J[(ridx * NZ + i) * BH] * ydk[r];
                    }
                }
                if (k > 0) {
#pragma unroll
                    for (int r = 0; r < NC; ++r) {
                        const size_t ridx = (size_t)((k - 1) * NC + r);
#pragma unroll
                        for (int i = 0; i < NZ; ++i)
                            s[i] += w.K[(ridx * NZ + i) * BH] * ydp[r];
                    }
                }
#pragma unroll
                for (int i = 0; i < NZ; ++i) {
                    const size_t idx = (size_t)(k * NZ + i);
                    const bool is_free = w.dlb[idx * B] != w.dub[idx * B];
                    stat = fmaxf(stat, is_free ? fabsf(s[i]) : 0.f);
                }
                if (k < N) {
#pragma unroll
                    for (int r = 0; r < NC; ++r) ydp[r] = ydk[r];
                }
            }
            conv = conv || ((stat < tol_stat) && (feas < tol_feas));
        }
        it += (float)iters;
        if (conv) break;  // rho stays frozen for a converged lane
        const float scale = sqrtf(pr / fmaxf(dr, 1e-30f));
        rho = clipf(rho * clipf(scale, 0.1f, 10.0f), rho_min, rho_max);
    }
    pr_o[lane] = pr;
    dr_o[lane] = dr;
    it_o[lane] = it;
}

static QPView make_view(void* const* p, long long B, int Kst, int shared_hjk) {
    QPView v;
    v.Hd = (const float*)p[0];
    v.J = (const float*)p[1];
    v.K = (const float*)p[2];
    v.g = (const float*)p[3];
    v.c = (const float*)p[4];
    v.dlb = (const float*)p[5];
    v.dub = (const float*)p[6];
    // p[7] is rho
    v.x = (float*)p[8];
    v.zb = (float*)p[9];
    v.yd = (float*)p[10];
    v.yb = (float*)p[11];
    v.Ld = (float*)p[12];
    v.Lo = (float*)p[13];
    v.xt = (float*)p[14];
    v.xtot = nullptr;
    v.B = B;
    v.Kst = Kst;
    v.shared_hjk = shared_hjk;
    return v;
}

extern "C" {

int admm_kernel_nz() { return NZ; }
int admm_kernel_nc() { return NC; }

// p: host array of device pointers to float32 arrays in the lane layout above
// with tile width lane_tile (32 or 1; Hd, J, K plain [rows] arrays when
// shared_hjk != 0), in this order:
//   0 Hd  1 J  2 K  3 g  4 c  5 dlb  6 dub  7 rho [B]
//   8 x  9 zb  10 yd  11 yb   (state, updated in place)
//   12 Ld  13 Lo  14 xt       (scratch)
//   15 pr [B]  16 dr [B]      (outputs)
// Returns cudaGetLastError() after the launch.
int admm_round_launch(void* const* p, long long B, int Kst, int lane_tile,
                      int shared_hjk, int iters, float sigma, float alpha,
                      float rho_eq_scale, void* stream) {
    if (B <= 0) return 0;
    QPView v = make_view(p, B, Kst, shared_hjk);
    const unsigned grid = (unsigned)((B + BLOCK_THREADS - 1) / BLOCK_THREADS);
    decltype(&admm_round_kernel<32>) kernel = nullptr;
    if (lane_tile == 32) kernel = admm_round_kernel<32>;
    if (lane_tile == 1) kernel = admm_round_kernel<1>;
    if (!kernel) return (int)cudaErrorInvalidValue;
    kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        v, (const float*)p[7], (float*)p[15], (float*)p[16], iters, sigma, alpha,
        rho_eq_scale);
    return (int)cudaGetLastError();
}

// As above, with g and c being the lane's own mutable copies (p[3], p[4]), and
//   17 xtot (zero-filled by the caller; the solution on return)  18 it [B]
int boxqp_solve_launch(void* const* p, long long B, int Kst, int lane_tile,
                       int shared_hjk, int n_rounds, int iters, float tol,
                       float sigma, float alpha,
                       float rho_eq_scale, float rho_min, float rho_max,
                       float tol_stat, float tol_feas, void* stream) {
    if (B <= 0) return 0;
    QPView v = make_view(p, B, Kst, shared_hjk);
    const unsigned grid = (unsigned)((B + BLOCK_THREADS - 1) / BLOCK_THREADS);
    decltype(&boxqp_solve_kernel<32>) kernel = nullptr;
    if (lane_tile == 32) kernel = boxqp_solve_kernel<32>;
    if (lane_tile == 1) kernel = boxqp_solve_kernel<1>;
    if (!kernel) return (int)cudaErrorInvalidValue;
    kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        v, (float*)p[3], (float*)p[4], (float*)p[17], (const float*)p[7],
        (float*)p[15], (float*)p[16], (float*)p[18], n_rounds, iters, tol, sigma,
        alpha, rho_eq_scale, rho_min, rho_max, tol_stat, tol_feas);
    return (int)cudaGetLastError();
}

}  // extern "C"

// ===========================================================================
// Route (1): a lane's state in shared memory, a team of threads per lane
// ===========================================================================

#define SMEM_MAX_WARPS 8     // warps of a block (more blocks share an SM instead)
// Threads that serve one lane: 32, 16 or 8, i.e. 1, 2 or 4 lanes per warp. On
// an H100 at the flagship shapes two and four lanes per warp take the same
// time for a batch and one is 1.7x slower; two is quicker on a single lane
// than four. A probe that wants another size builds its own copy with -DTEAM.
#ifndef TEAM
#define TEAM 16
#endif
static_assert(TEAM == 32 || TEAM == 16 || TEAM == 8, "a team is 8, 16 or 32 threads");
#define LANES_PER_WARP (32 / TEAM)
#define SMEM_ALIGN_FLOATS 4  // every sub-array of a lane starts 16-byte aligned
// Floats of a stage's record in Lf: the NTRI entries of the diagonal factor
// (packed lower), then the NZ reciprocals of its pivots, padded to 16 bytes so
// that a stage is read with 128-bit loads.
#define FREC ((NTRI + NZ + 3) / 4 * 4)

// The per-lane arrays in dynamic shared memory, in carve order:
//   X(name, floats, only when Hd/J/K are per lane)
// with Kst stages, N = Kst - 1 intervals. The struct, the size and the
// carve-up below are all generated from this one table, and
// ops/cuda/admm_kernel.py:state_bytes_per_lane states the same sum (the CPU
// tests parse this table and hold the two together).
#define SMEM_LANE_ARRAYS(X) \
    X(x, Kst * NZ, 0)       /* step of this round */ \
    X(zb, Kst * NZ, 0)      /* box splitting variable */ \
    X(yb, Kst * NZ, 0)      /* box dual */ \
    X(xt, Kst * NZ, 0)      /* right-hand side, then x_tilde */ \
    X(gs, Kst * NZ, 0)      /* g, shifted by the recentering */ \
    X(lo, Kst * NZ, 0)      /* dlb - xtot */ \
    X(hi, Kst * NZ, 0)      /* dub - xtot */ \
    X(rb, Kst * NZ, 0)      /* rho of the row: rho_eq on a pin, else rho */ \
    X(cs, N * NC, 0)        /* c, shifted by the recentering */ \
    X(yd, N * NC, 0)        /* dynamics dual */ \
    X(Lf, Kst * FREC, 0)    /* per stage: diagonal factor packed lower, 1 / pivots */ \
    X(Lo, N * NZ * NZ, 0)   /* sub-diagonal factors */ \
    X(Jl, N * NC * NZ, 1)   /* the lane's own J */ \
    X(Kl, N * NC * NZ, 1)   /* the lane's own K */

struct LaneSmem {
#define SMEM_DECLARE(name, floats, per_lane_hjk) float* name;
    SMEM_LANE_ARRAYS(SMEM_DECLARE)
#undef SMEM_DECLARE
};

__host__ __device__ inline int smem_round_up(int floats) {
    return (floats + SMEM_ALIGN_FLOATS - 1) / SMEM_ALIGN_FLOATS * SMEM_ALIGN_FLOATS;
}

__host__ __device__ inline int smem_floats_per_lane(int Kst, int shared_hjk) {
    const int N = Kst - 1;
    int total = 0;
#define SMEM_COUNT(name, floats, per_lane_hjk) \
    if (!(per_lane_hjk) || !shared_hjk) total += smem_round_up(floats);
    SMEM_LANE_ARRAYS(SMEM_COUNT)
#undef SMEM_COUNT
    return total;
}

__device__ __forceinline__ LaneSmem smem_carve(float* base, int Kst, int shared_hjk) {
    const int N = Kst - 1;
    LaneSmem s;
#define SMEM_TAKE(name, floats, per_lane_hjk) \
    s.name = base;                            \
    if (!(per_lane_hjk) || !shared_hjk) base += smem_round_up(floats);
    SMEM_LANE_ARRAYS(SMEM_TAKE)
#undef SMEM_TAKE
    return s;
}

// The caller's batch-first tensors: element idx of lane l at p[l * rows + idx]
// (Hd, J, K: one copy for all lanes when shared_hjk).
struct BatchFirst {
    const float* __restrict__ Hd;   // [B | 1][Kst*NZ*NZ]
    const float* __restrict__ J;    // [B | 1][N*NC*NZ]
    const float* __restrict__ K;    // [B | 1][N*NC*NZ]
    const float* __restrict__ g;    // [B][Kst*NZ]
    const float* __restrict__ c;    // [B][N*NC]
    const float* __restrict__ dlb;  // [B][Kst*NZ]  unshifted box bounds
    const float* __restrict__ dub;  // [B][Kst*NZ]
    const float* __restrict__ rho;  // [B]
    const float* __restrict__ x0;   // [B][Kst*NZ]  warm start
    const float* __restrict__ zb0;  // [B][Kst*NZ]
    const float* __restrict__ yd0;  // [B][N*NC]
    const float* __restrict__ yb0;  // [B][Kst*NZ]
    float* x;                       // [B][Kst*NZ]  outputs
    float* zb;                      // [B][Kst*NZ]
    float* yd;                      // [B][N*NC]
    float* yb;                      // [B][Kst*NZ]
    float* pr;                      // [B]
    float* dr;                      // [B]
    float* it;                      // [B]  (full solve only)
    int* next_lane;                 // zeroed by the caller (full solve only)
    long long B;
    int Kst;
    int shared_hjk;
};

// Read-only data of the lane a team works on.
struct LaneData {
    const float* Hd;   // device memory
    const float* J;    // device memory (shared copy) or the lane's shared memory
    const float* K;
    const float* dlb;  // device memory, unshifted
    const float* dub;
};

__device__ __forceinline__ float team_max(float val) {
#pragma unroll
    for (int off = TEAM / 2; off > 0; off >>= 1)
        val = fmaxf(val, __shfl_xor_sync(0xffffffffu, val, off));
    return val;
}

// One stage of the chains, on registers. f: the stage's record of Lf.

// X = L^-1 O, column by column (O = rho_eq Jp'Kp is formed on the way)
template <bool FAST>
__device__ __forceinline__ bool solve_X(const float (&L)[NZ][NZ], const float (&Linv)[NZ],
                                        const float (&Jp)[NC][NZ], const float (&Kp)[NC][NZ],
                                        float rho_eq, float (&X)[NZ][NZ]) {
    bool bad = false;
    if (FAST) {
#pragma unroll
        for (int i = 0; i < NZ; ++i) bad = bad || !reciprocal_ok(Linv[i]);
    }
#pragma unroll
    for (int cc = 0; cc < NZ; ++cc) {
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
            float o = Jp[0][i] * Kp[0][cc];
#pragma unroll
            for (int r = 1; r < NC; ++r) o += Jp[r][i] * Kp[r][cc];
            float acc = rho_eq * o;
#pragma unroll
            for (int u = 0; u < i; ++u) acc -= L[i][u] * X[u][cc];
            X[i][cc] = quotient<FAST>(acc, L[i][i], Linv[i], bad);
        }
    }
    return bad;
}

// z = L^-1 rhs
template <bool FAST>
__device__ __forceinline__ bool solve_lower(const float (&f)[FREC], const float (&rhs)[NZ],
                                            float (&z)[NZ]) {
    bool bad = false;
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        float acc = rhs[i];
#pragma unroll
        for (int u = 0; u < i; ++u) acc -= f[TRI(i, u)] * z[u];
        z[i] = quotient<FAST>(acc, f[TRI(i, i)], f[NTRI + i], bad);
    }
    return bad;
}

// x = L^-T rhs
template <bool FAST>
__device__ __forceinline__ bool solve_upper(const float (&f)[FREC], const float (&rhs)[NZ],
                                            float (&x)[NZ]) {
    bool bad = false;
#pragma unroll
    for (int i = NZ - 1; i >= 0; --i) {
        float acc = rhs[i];
#pragma unroll
        for (int u = i + 1; u < NZ; ++u) acc -= f[TRI(u, i)] * x[u];
        x[i] = quotient<FAST>(acc, f[TRI(i, i)], f[NTRI + i], bad);
    }
    return bad;
}

// What the chain thread holds of one stage: its record of Lf, the
// sub-diagonal factor that couples it to its neighbour, its right-hand side.
struct ChainStage {
    float f[FREC];
    float lo[NZ * NZ];
    float rhs[NZ];
};

// Forward stage k: z_k = L_k^-1 (rhs_k - Lo_{k-1} z_{k-1}), written over xt_k.
// The next stage is loaded into `nxt` before this stage's chain of quotients
// starts; the caller swaps the two buffers.
template <bool FAST>
__device__ __forceinline__ void forward_stage(const LaneSmem& s, int k, int Kst, ChainStage& cur,
                                              ChainStage& nxt, float (&z)[NZ]) {
    if (k + 1 < Kst) {
        load_floats(s.Lf, k + 1, nxt.f);
        load_floats(s.Lo, k, nxt.lo);
        load_floats(s.xt, k + 1, nxt.rhs);
    }
    // (stage 0: lo = 0 and z = 0, and rhs - 0*0 is rhs to the bit)
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
        float acc = cur.rhs[i];
#pragma unroll
        for (int u = 0; u < NZ; ++u) acc -= cur.lo[i * NZ + u] * z[u];
        cur.rhs[i] = acc;
    }
    if (FAST) {
        if (solve_lower<true>(cur.f, cur.rhs, z)) solve_lower<false>(cur.f, cur.rhs, z);
    } else {
        solve_lower<false>(cur.f, cur.rhs, z);
    }
    store_floats(s.xt, k, z);
}

// Backward stage k: x_k = L_k^-T rhs_k over xt_k, then the right-hand side of
// stage k-1, z_{k-1} - Lo_{k-1}' x_k, into `nxt` (loaded before the chain).
template <bool FAST>
__device__ __forceinline__ void backward_stage(const LaneSmem& s, int k, ChainStage& cur,
                                               ChainStage& nxt, float (&xn)[NZ]) {
    if (k > 0) {
        load_floats(s.Lf, k - 1, nxt.f);
        load_floats(s.xt, k - 1, nxt.rhs);
        if (k > 1) load_floats(s.Lo, k - 2, nxt.lo);
    }
    if (FAST) {
        if (solve_upper<true>(cur.f, cur.rhs, xn)) solve_upper<false>(cur.f, cur.rhs, xn);
    } else {
        solve_upper<false>(cur.f, cur.rhs, xn);
    }
    store_floats(s.xt, k, xn);
    if (k > 0) {
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
            float acc = nxt.rhs[i];
#pragma unroll
            for (int u = 0; u < NZ; ++u) acc -= cur.lo[u * NZ + i] * xn[u];
            nxt.rhs[i] = acc;
        }
    }
}

// The backward sweep from the last stage down; `top` holds the last stage's
// record, z its forward solution.
template <bool FAST>
__device__ __forceinline__ void backward_sweep(const LaneSmem& s, int Kst, ChainStage& top,
                                               ChainStage& other, const float (&z)[NZ]) {
    float xn[NZ];  // x_tilde of stage k+1
#pragma unroll
    for (int i = 0; i < NZ; ++i) top.rhs[i] = z[i];
    if (Kst > 1) load_floats(s.Lo, Kst - 2, top.lo);
    int k = Kst - 1;
    for (; k >= 1; k -= 2) {
        backward_stage<FAST>(s, k, top, other, xn);
        backward_stage<FAST>(s, k - 1, other, top, xn);
    }
    if (k == 0) backward_stage<FAST>(s, 0, top, other, xn);
}

// The two substitutions of one ADMM iteration, in place in xt: the chain, run
// by one thread. Two register buffers take turns as "this stage" and "next
// stage", so nothing is copied between them.
template <bool FAST>
__device__ __forceinline__ void chain_sweeps(const LaneSmem& s, int Kst) {
    ChainStage a, b;
    float z[NZ];  // L^-1 rhs of the previous stage
#pragma unroll
    for (int i = 0; i < NZ; ++i) z[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NZ * NZ; ++j) a.lo[j] = 0.f;
    load_floats(s.Lf, 0, a.f);
    load_floats(s.xt, 0, a.rhs);
    int k = 0;
    for (; k + 1 < Kst; k += 2) {
        forward_stage<FAST>(s, k, Kst, a, b, z);
        forward_stage<FAST>(s, k + 1, Kst, b, a, z);
    }
    if (k < Kst) {  // an odd number of stages: the last one is in a
        forward_stage<FAST>(s, k, Kst, a, b, z);
        backward_sweep<FAST>(s, Kst, a, b, z);
    } else {
        backward_sweep<FAST>(s, Kst, b, a, z);
    }
}

// Load lane `lane` into the team's shared memory (all threads of the team;
// the caller synchronises afterwards).
__device__ __forceinline__ LaneData smem_load_lane(const BatchFirst& p, const LaneSmem& s,
                                                   long long lane, int t) {
    const int Kst = p.Kst, N = Kst - 1, n = Kst * NZ, m = N * NC;
    const float* g = p.g + lane * n;
    const float* dlb = p.dlb + lane * n;
    const float* dub = p.dub + lane * n;
    const float* x0 = p.x0 + lane * n;
    const float* zb0 = p.zb0 + lane * n;
    const float* yb0 = p.yb0 + lane * n;
    for (int e = t; e < n; e += TEAM) {
        s.gs[e] = g[e];
        s.lo[e] = dlb[e];
        s.hi[e] = dub[e];
        s.x[e] = x0[e];
        s.zb[e] = zb0[e];
        s.yb[e] = yb0[e];
    }
    const float* c = p.c + lane * m;
    const float* yd0 = p.yd0 + lane * m;
    for (int q = t; q < m; q += TEAM) {
        s.cs[q] = c[q];
        s.yd[q] = yd0[q];
    }
    LaneData d;
    d.dlb = dlb;
    d.dub = dub;
    if (p.shared_hjk) {
        d.Hd = p.Hd;
        d.J = p.J;
        d.K = p.K;
    } else {
        d.Hd = p.Hd + lane * (long long)(Kst * NZ * NZ);
        const float* J = p.J + lane * (long long)(m * NZ);
        const float* K = p.K + lane * (long long)(m * NZ);
        for (int e = t; e < m * NZ; e += TEAM) {
            s.Jl[e] = J[e];
            s.Kl[e] = K[e];
        }
        d.J = s.Jl;
        d.K = s.Kl;
    }
    return d;
}

// One rho-round on the lane state in shared memory: per-row rho, assemble and
// factor M, `iters` ADMM iterations, (pr, dr) of the final iterate (uniform
// over the team). The box bounds are s.lo, s.hi as they stand. Called by all
// 32 threads of the warp together; t = the thread's index in its team.
__device__ void smem_round(const LaneSmem& s, const LaneData& d, int Kst, int t,
                           float rho, int iters, float sigma, float alpha,
                           float rho_eq_scale, float& pr_out, float& dr_out) {
    const int N = Kst - 1, n = Kst * NZ, m = N * NC;
    const float rho_eq = rho * rho_eq_scale;
    const float rho_inv = 1.0f / rho, rho_eq_inv = 1.0f / rho_eq;
    const bool rho_ok = reciprocal_ok(rho_inv) && reciprocal_ok(rho_eq_inv);
    const float* __restrict__ J = d.J;
    const float* __restrict__ K = d.K;

    // ---- per-row rho: the pin test is on the unshifted bounds ----
    for (int e = t; e < n; e += TEAM) s.rb[e] = (d.dlb[e] == d.dub[e]) ? rho_eq : rho;
    __syncwarp();

    // ---- assemble + factor M = L L' stage by stage (the chain: one thread) ----
    bool pivots_ok = true;  // every 1 / pivot fit for quotient<true> (chain thread only)
    if (t == 0) {
        const float* __restrict__ Hd = d.Hd;
        float L[NZ][NZ];               // diagonal factor of the previous stage
        float Linv[NZ];                // 1 / L[i][i]
        float Jp[NC][NZ], Kp[NC][NZ];  // J_{k-1}, K_{k-1}
#pragma unroll
        for (int r = 0; r < NC; ++r)
#pragma unroll
            for (int i = 0; i < NZ; ++i) { Jp[r][i] = 0.f; Kp[r][i] = 0.f; }
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
            Linv[i] = 0.f;
#pragma unroll
            for (int j = 0; j < NZ; ++j) L[i][j] = 0.f;
        }

        for (int k = 0; k < Kst; ++k) {
            // everything the stage reads is asked for before its chain starts
            float Jk[NC][NZ], Kk[NC][NZ], Hk[NZ][NZ], rbk[NZ];
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                rbk[i] = s.rb[k * NZ + i];
#pragma unroll
                for (int j = 0; j <= i; ++j) Hk[i][j] = Hd[(k * NZ + i) * NZ + j];
            }
            if (k < N) {
#pragma unroll
                for (int r = 0; r < NC; ++r)
#pragma unroll
                    for (int i = 0; i < NZ; ++i) {
                        Jk[r][i] = J[(k * NC + r) * NZ + i];
                        Kk[r][i] = K[(k * NC + r) * NZ + i];
                    }
            }
            // D_k = Hd_k + sigma I + rho_eq (J_k'J_k [k<N] + K_{k-1}'K_{k-1} [k>0])
            //       + diag(rho_box)   (lower triangle)
            float S[NZ][NZ];
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
#pragma unroll
                for (int j = 0; j <= i; ++j) {
                    float acc = Hk[i][j];
                    // rho_eq times the sum over rows (one rounding of rho_eq,
                    // as in the plain version and the one-thread-per-lane
                    // kernels)
                    if (k < N) {
                        float o = Jk[0][i] * Jk[0][j];
#pragma unroll
                        for (int r = 1; r < NC; ++r) o += Jk[r][i] * Jk[r][j];
                        acc += rho_eq * o;
                    }
                    if (k > 0) {
                        float o = Kp[0][i] * Kp[0][j];
#pragma unroll
                        for (int r = 1; r < NC; ++r) o += Kp[r][i] * Kp[r][j];
                        acc += rho_eq * o;
                    }
                    if (i == j) acc += sigma + rbk[i];
                    S[i][j] = acc;
                }
            }
            if (k > 0) {
                // O_{k-1} = rho_eq J_{k-1}' K_{k-1};  X = Lprev^{-1} O;
                // S = D_k - X'X;  Lo_{k-1} = X'
                float X[NZ][NZ];
                if (solve_X<true>(L, Linv, Jp, Kp, rho_eq, X))
                    solve_X<false>(L, Linv, Jp, Kp, rho_eq, X);
#pragma unroll
                for (int i = 0; i < NZ; ++i)
#pragma unroll
                    for (int j = 0; j <= i; ++j) {
                        float acc = S[i][j];
#pragma unroll
                        for (int u = 0; u < NZ; ++u) acc -= X[u][i] * X[u][j];
                        S[i][j] = acc;
                    }
                float lo[NZ * NZ];
#pragma unroll
                for (int i = 0; i < NZ; ++i)
#pragma unroll
                    for (int j = 0; j < NZ; ++j) lo[i * NZ + j] = X[j][i];
                store_floats(s.Lo, k - 1, lo);
            }
            // Cholesky of S into L, stored packed lower beside 1 / pivot
#pragma unroll
            for (int j = 0; j < NZ; ++j) {
                float dd = S[j][j];
#pragma unroll
                for (int u = 0; u < j; ++u) dd -= L[j][u] * L[j][u];
                const float dj = sqrtf(dd);
                L[j][j] = dj;
                const float inv = 1.0f / dj;
                Linv[j] = inv;
                pivots_ok = pivots_ok && reciprocal_ok(inv);
#pragma unroll
                for (int i = j + 1; i < NZ; ++i) {
                    float acc = S[i][j];
#pragma unroll
                    for (int u = 0; u < j; ++u) acc -= L[i][u] * L[j][u];
                    L[i][j] = acc * inv;
                }
            }
            float f[FREC] = {};
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                f[NTRI + i] = Linv[i];
#pragma unroll
                for (int j = 0; j <= i; ++j) f[TRI(i, j)] = L[i][j];
            }
            store_floats(s.Lf, k, f);
            if (k < N) {
#pragma unroll
                for (int r = 0; r < NC; ++r)
#pragma unroll
                    for (int i = 0; i < NZ; ++i) {
                        Jp[r][i] = Jk[r][i];
                        Kp[r][i] = Kk[r][i];
                    }
            }
        }
    }
    __syncwarp();

    // ---- ADMM iterations ----
    for (int itn = 0; itn < iters; ++itn) {
        // right-hand side, every term but the coupling to the previous stage:
        //   rhs = sigma x - g + (rho_b z_b - y_b) + J'(vd)|_k + K'(vd)|_{k-1},
        //   vd[k] = -rho_eq c[k] - y_d[k]
        for (int e = t; e < n; e += TEAM) {
            const int k = e / NZ, i = e - k * NZ;
            float acc = sigma * s.x[e] - s.gs[e];
            acc += s.rb[e] * s.zb[e] - s.yb[e];
            if (k < N) {
#pragma unroll
                for (int r = 0; r < NC; ++r) {
                    const int q = k * NC + r;
                    const float vd = -rho_eq * s.cs[q] - s.yd[q];
                    acc += J[q * NZ + i] * vd;
                }
            }
            if (k > 0) {
#pragma unroll
                for (int r = 0; r < NC; ++r) {
                    const int q = (k - 1) * NC + r;
                    const float vd = -rho_eq * s.cs[q] - s.yd[q];
                    acc += K[q * NZ + i] * vd;
                }
            }
            s.xt[e] = acc;
        }
        __syncwarp();
        // the two substitutions, in place in xt (the chain: one thread)
        if (t == 0) {
            if (pivots_ok) chain_sweeps<true>(s, Kst);
            else chain_sweeps<false>(s, Kst);
        }
        __syncwarp();
        // updates: y_d by interval row, then x, z_b, y_b by element
        for (int q = t; q < m; q += TEAM) {
            const int k = q / NC;
            float ax = 0.f;
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                ax += J[q * NZ + i] * s.xt[k * NZ + i];
                ax += K[q * NZ + i] * s.xt[(k + 1) * NZ + i];
            }
            const float cr = s.cs[q];
            const float v_d = alpha * ax + (1.0f - alpha) * (-cr);
            s.yd[q] = s.yd[q] + rho_eq * (v_d + cr);
        }
        for (int e = t; e < n; e += TEAM) {
            const float xc = s.xt[e], zbo = s.zb[e], ybo = s.yb[e], rb = s.rb[e];
            s.x[e] = alpha * xc + (1.0f - alpha) * s.x[e];
            const float v_b = alpha * xc + (1.0f - alpha) * zbo;
            const float rbi = (rb == rho_eq) ? rho_eq_inv : rho_inv;
            bool bad = !rho_ok;
            float yr = quotient<true>(ybo, rb, rbi, bad);
            if (bad) yr = ybo / rb;
            const float zbn = clipf(v_b + yr, s.lo[e], s.hi[e]);
            s.yb[e] = ybo + rb * (v_b - zbn);
            s.zb[e] = zbn;
        }
        __syncwarp();
    }

    // ---- residuals, once, on the final iterate (x_tilde is in xt) ----
    float pr = 0.f, dr = 0.f;
    for (int q = t; q < m; q += TEAM) {
        const int k = q / NC;
        float ax = 0.f;
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
            ax += J[q * NZ + i] * s.xt[k * NZ + i];
            ax += K[q * NZ + i] * s.xt[(k + 1) * NZ + i];
        }
        pr = fmaxf(pr, fabsf(ax + s.cs[q]));
    }
    for (int e = t; e < n; e += TEAM) {
        const float xc = s.xt[e], zb = s.zb[e], rb = s.rb[e], yb = s.yb[e];
        pr = fmaxf(pr, fabsf(xc - zb));
        // dual residual, one-step lookahead: the box z-update the NEXT
        // iteration would make from this iterate
        const float v_b = alpha * xc + (1.0f - alpha) * zb;
        const float rbi = (rb == rho_eq) ? rho_eq_inv : rho_inv;
        bool bad = !rho_ok;
        float yr = quotient<true>(yb, rb, rbi, bad);
        if (bad) yr = yb / rb;
        const float z_new = clipf(v_b + yr, s.lo[e], s.hi[e]);
        dr = fmaxf(dr, fabsf(rb * (z_new - zb)));
    }
    pr_out = team_max(pr);
    dr_out = team_max(dr);
}

// Slot of the thread's team in the block's shared memory, and its index in
// the team.
__device__ __forceinline__ int smem_slot(int& t) {
    const int in_warp = threadIdx.x & 31;
    t = in_warp % TEAM;
    return (threadIdx.x / 32) * (32 / TEAM) + in_warp / TEAM;
}

// K2 on route (1): one rho-round at fixed per-lane rho; slot i of block b
// takes lane b * slots + i.
__global__ void __launch_bounds__(SMEM_MAX_WARPS * 32)
admm_round_smem_kernel(BatchFirst p, int lane_floats, int iters, float sigma,
                       float alpha, float rho_eq_scale) {
    extern __shared__ __align__(16) float smem[];
    int t;
    const int slot = smem_slot(t);
    const int slots = (blockDim.x / 32) * (32 / TEAM);
    const long long mine = (long long)blockIdx.x * slots + slot;
    const bool active = mine < p.B;
    const long long lane = active ? mine : 0;  // an idle team reads lane 0, writes nothing
    const int Kst = p.Kst, n = Kst * NZ, m = (Kst - 1) * NC;
    const LaneSmem s = smem_carve(smem + (size_t)slot * lane_floats, Kst, p.shared_hjk);
    const LaneData d = smem_load_lane(p, s, lane, t);
    __syncwarp();
    float pr, dr;
    smem_round(s, d, Kst, t, p.rho[lane], iters, sigma, alpha, rho_eq_scale, pr, dr);
    if (!active) return;
    for (int e = t; e < n; e += TEAM) {
        p.x[lane * n + e] = s.x[e];
        p.zb[lane * n + e] = s.zb[e];
        p.yb[lane * n + e] = s.yb[e];
    }
    for (int q = t; q < m; q += TEAM) p.yd[lane * m + q] = s.yd[q];
    if (t == 0) {
        p.pr[lane] = pr;
        p.dr[lane] = dr;
    }
}

// K1 on route (1): the whole box-QP solve. Persistent blocks; the teams of a
// warp run their rounds in lock step, and a team whose lane is done takes the
// next one from p.next_lane at the round boundary. p.x accumulates the step
// (the solution on return).
__global__ void __launch_bounds__(SMEM_MAX_WARPS * 32)
boxqp_solve_smem_kernel(BatchFirst p, int lane_floats, int n_rounds, int iters,
                        float tol, float sigma, float alpha, float rho_eq_scale,
                        float rho_min, float rho_max, float tol_stat, float tol_feas) {
    extern __shared__ __align__(16) float smem[];
    int t;
    const int slot = smem_slot(t);
    const int leader = ((threadIdx.x & 31) / TEAM) * TEAM;  // of the team, in the warp
    const int Kst = p.Kst, N = Kst - 1, n = Kst * NZ, m = N * NC;
    const LaneSmem s = smem_carve(smem + (size_t)slot * lane_floats, Kst, p.shared_hjk);
    const bool use_kkt = (tol_stat > 0.0f) && (tol_feas > 0.0f);

    bool need = true;     // the team wants a lane
    bool active = false;  // the team has one
    long long lane = 0;
    LaneData d;
    float rho = 0.f, it = 0.f;
    int rnd = 0;

    for (;;) {
        // ---- round boundary: a team without work takes the next lane ----
        int next = 0;
        if (need && t == 0) next = atomicAdd(p.next_lane, 1);
        next = __shfl_sync(0xffffffffu, next, leader);
        if (need) {
            active = next < p.B;
            lane = active ? next : 0;  // an idle team reads lane 0, writes nothing
            d = smem_load_lane(p, s, lane, t);
            rho = p.rho[lane];
            it = 0.f;
            rnd = 0;
            need = false;
        }
        __syncwarp();
        if (!__any_sync(0xffffffffu, active)) break;

        float pr, dr;
        smem_round(s, d, Kst, t, rho, iters, sigma, alpha, rho_eq_scale, pr, dr);

        // ---- recenter: absorb this round's step into the linear data ----
        const float* __restrict__ J = d.J;
        const float* __restrict__ K = d.K;
        float feas = 0.f, stat = 0.f;
        for (int q = t; q < m; q += TEAM) {
            const int k = q / NC;
            float ax = 0.f;
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                ax += J[q * NZ + i] * s.x[k * NZ + i];
                ax += K[q * NZ + i] * s.x[(k + 1) * NZ + i];
            }
            const float csn = s.cs[q] + ax;
            s.cs[q] = csn;
            feas = fmaxf(feas, fabsf(csn));
        }
        for (int e = t; e < n; e += TEAM) {
            const int k = e / NZ;
            float gi = s.gs[e];
#pragma unroll
            for (int j = 0; j < NZ; ++j) gi += d.Hd[e * NZ + j] * s.x[k * NZ + j];
            s.gs[e] = gi;
        }
        __syncwarp();  // every read of x is done before x is cleared
        float* xtot = p.x + lane * n;
        for (int e = t; e < n; e += TEAM) {
            const int k = e / NZ, i = e - k * NZ;
            const float dlb = d.dlb[e], dub = d.dub[e];
            const float xtn = ((rnd > 0 && active) ? xtot[e] : 0.f) + s.x[e];
            if (active) xtot[e] = xtn;
            const float lo = dlb - xtn, hi = dub - xtn;
            s.lo[e] = lo;
            s.hi[e] = hi;
            s.zb[e] = fminf(fmaxf(0.f, lo), hi);
            s.x[e] = 0.f;
            if (use_kkt) {
                // exact KKT residuals of the LTI QP at the recentered iterate:
                // stat = |g' + A'y| over free rows, feas = |c'|
                float acc = s.gs[e] + s.yb[e];
                if (k < N) {
#pragma unroll
                    for (int r = 0; r < NC; ++r) {
                        const int q = k * NC + r;
                        acc += J[q * NZ + i] * s.yd[q];
                    }
                }
                if (k > 0) {
#pragma unroll
                    for (int r = 0; r < NC; ++r) {
                        const int q = (k - 1) * NC + r;
                        acc += K[q * NZ + i] * s.yd[q];
                    }
                }
                stat = fmaxf(stat, (dlb != dub) ? fabsf(acc) : 0.f);
            }
        }
        // ---- convergence (uniform over the team) ----
        bool conv = (pr < tol) && (dr < tol);
        if (use_kkt) {
            feas = team_max(feas);
            stat = team_max(stat);
            conv = conv || ((stat < tol_stat) && (feas < tol_feas));
        }
        __syncwarp();
        if (active) {
            it += (float)iters;
            ++rnd;
            if (conv || rnd == n_rounds) {
                // done: x is already in p.x; hand back the rest
                for (int e = t; e < n; e += TEAM) {
                    p.zb[lane * n + e] = s.zb[e];
                    p.yb[lane * n + e] = s.yb[e];
                }
                for (int q = t; q < m; q += TEAM) p.yd[lane * m + q] = s.yd[q];
                if (t == 0) {
                    p.pr[lane] = pr;
                    p.dr[lane] = dr;
                    p.it[lane] = it;
                }
                need = true;
            } else {
                const float scale = sqrtf(pr / fmaxf(dr, 1e-30f));
                rho = clipf(rho * clipf(scale, 0.1f, 10.0f), rho_min, rho_max);
            }
        }
        // the next round, or the next lane's load, overwrites what the team's
        // threads have just read
        __syncwarp();
    }
}

static BatchFirst make_batch_first(void* const* p, long long B, int Kst, int shared_hjk) {
    BatchFirst v;
    v.Hd = (const float*)p[0];
    v.J = (const float*)p[1];
    v.K = (const float*)p[2];
    v.g = (const float*)p[3];
    v.c = (const float*)p[4];
    v.dlb = (const float*)p[5];
    v.dub = (const float*)p[6];
    v.rho = (const float*)p[7];
    v.x0 = (const float*)p[8];
    v.zb0 = (const float*)p[9];
    v.yd0 = (const float*)p[10];
    v.yb0 = (const float*)p[11];
    v.x = (float*)p[12];
    v.zb = (float*)p[13];
    v.yd = (float*)p[14];
    v.yb = (float*)p[15];
    v.pr = (float*)p[16];
    v.dr = (float*)p[17];
    v.it = nullptr;
    v.next_lane = nullptr;
    v.B = B;
    v.Kst = Kst;
    v.shared_hjk = shared_hjk;
    return v;
}

// Launch shape of a route-(1) kernel: as many warps per block as the block's
// shared memory holds (at most SMEM_MAX_WARPS, and no more than the batch
// needs), and, for the persistent kernel, as many blocks as the card keeps
// resident. info (6 ints, may be null) reports what was chosen:
//   0 warps per block  1 dynamic shared memory of a block, bytes
//   2 blocks  3 resident blocks per SM  4 registers per thread  5 SMs
static cudaError_t smem_launch_shape(const void* kernel, long long B, int lane_floats,
                                     bool persistent, int* warps, int* smem_bytes,
                                     unsigned* grid, int* info) {
    int dev = 0, max_smem = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long warp_bytes = (long long)LANES_PER_WARP * lane_floats * (long long)sizeof(float);
    long long w = max_smem / warp_bytes;
    if (w < 1) return cudaErrorInvalidValue;  // the shape rule of the wrapper excludes this
    const long long needed = (B + LANES_PER_WARP - 1) / LANES_PER_WARP;
    if (w > SMEM_MAX_WARPS) w = SMEM_MAX_WARPS;
    if (w > needed) w = needed;
    *warps = (int)w;
    *smem_bytes = (int)(w * warp_bytes);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, *warps * 32, *smem_bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    long long blocks = (needed + w - 1) / w;
    if (persistent && blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
    *grid = (unsigned)blocks;
    if (info) {
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return err;
        info[0] = *warps;
        info[1] = *smem_bytes;
        info[2] = (int)blocks;
        info[3] = per_sm;
        info[4] = attr.numRegs;
        info[5] = sms;
    }
    return cudaSuccess;
}

extern "C" {

// Floats of shared memory a lane takes on route (1); the wrapper holds its own
// formula against this before the first launch.
int admm_smem_floats_per_lane(int Kst, int shared_hjk) {
    return smem_floats_per_lane(Kst, shared_hjk);
}

// Route (1). p: host array of device pointers to float32 arrays, batch-first
// and contiguous as the caller has them (Hd, J, K one copy when shared_hjk):
//   0 Hd  1 J  2 K  3 g  4 c  5 dlb  6 dub  7 rho [B]
//   8 x  9 zb  10 yd  11 yb            (warm start, read only)
//   12 x  13 zb  14 yd  15 yb  16 pr [B]  17 dr [B]   (outputs)
// Returns the first CUDA error of the attribute
// calls or cudaGetLastError() after the launch.
int admm_round_smem_launch(void* const* p, long long B, int Kst, int shared_hjk, int iters,
                           float sigma, float alpha, float rho_eq_scale, int* info,
                           void* stream) {
    if (B <= 0) return 0;
    const BatchFirst v = make_batch_first(p, B, Kst, shared_hjk);
    const int lane_floats = smem_floats_per_lane(Kst, shared_hjk);
    int warps = 0, smem_bytes = 0;
    unsigned grid = 0;
    const cudaError_t err = smem_launch_shape((const void*)admm_round_smem_kernel, B, lane_floats,
                                              false, &warps, &smem_bytes, &grid, info);
    if (err != cudaSuccess) return (int)err;
    admm_round_smem_kernel<<<grid, warps * 32, smem_bytes, (cudaStream_t)stream>>>(
        v, lane_floats, iters, sigma, alpha, rho_eq_scale);
    return (int)cudaGetLastError();
}

// As above, and
//   18 it [B] (output)  19 next_lane (one int32, zeroed by the caller)
// p[12] accumulates the step and is the solution on return.
int boxqp_solve_smem_launch(void* const* p, long long B, int Kst, int shared_hjk,
                            int n_rounds, int iters, float tol, float sigma, float alpha, float rho_eq_scale, float rho_min,
                            float rho_max, float tol_stat, float tol_feas, int* info,
                            void* stream) {
    if (B <= 0) return 0;
    BatchFirst v = make_batch_first(p, B, Kst, shared_hjk);
    v.it = (float*)p[18];
    v.next_lane = (int*)p[19];
    const int lane_floats = smem_floats_per_lane(Kst, shared_hjk);
    int warps = 0, smem_bytes = 0;
    unsigned grid = 0;
    const cudaError_t err = smem_launch_shape((const void*)boxqp_solve_smem_kernel, B, lane_floats,
                                              true, &warps, &smem_bytes, &grid, info);
    if (err != cudaSuccess) return (int)err;
    boxqp_solve_smem_kernel<<<grid, warps * 32, smem_bytes, (cudaStream_t)stream>>>(
        v, lane_floats, n_rounds, iters, tol, sigma, alpha, rho_eq_scale, rho_min,
        rho_max, tol_stat, tol_feas);
    return (int)cudaGetLastError();
}

}  // extern "C"

// out[i] = 1 where quotient<true> (with its fallback) and a[i] / b[i] differ in a bit
// (two NaNs count as equal), else 0.
__global__ void division_check_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                      int* __restrict__ out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float q = a[i] / b[i];
    const float y = 1.0f / b[i];
    bool bad = !reciprocal_ok(y);
    float f = quotient<true>(a[i], b[i], y, bad);
    if (bad) f = quotient<false>(a[i], b[i], y, bad);
    const bool same = (__float_as_uint(q) == __float_as_uint(f)) || (q != q && f != f);
    out[i] = same ? 0 : 1;
}

extern "C" int admm_division_check_launch(const void* a, const void* b, void* out, long long n,
                                          void* stream) {
    if (n <= 0) return 0;
    const unsigned grid = (unsigned)((n + 255) / 256);
    division_check_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (int*)out, n);
    return (int)cudaGetLastError();
}
