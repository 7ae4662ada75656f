// Box-QP ADMM kernels for NVIDIA Hopper (sm_90a), float32.
//
// What this replaces
// ------------------
// The JAX package's Pallas TPU kernels in control_box_rst_tpu/ops/pallas/
// admm_kernel.py:
//   boxqp_solve_kernel  <-  boxqp_solve_pallas / _solve_kernel  (the whole
//       box-QP solve of one lane: up to n_rounds rounds of {assemble
//       M = Hd + sigma I + rho_eq (J'J, K'K, J'K) + diag(rho_box); block-
//       tridiagonal Cholesky, diagonal factors packed lower; `iters` OSQP
//       iterations with the dynamics z eliminated (z_d = -c); recenter;
//       exit test; per-lane rho rescale})
//   admm_round_kernel   <-  admm_round_pallas / _kernel  (one such round at
//       fixed rho, no recentering, no exit)
// Both share the device function round_ops below, as the Pallas kernels share
// _round_ops. The arithmetic follows _round_ops / _solve_kernel statement by
// statement (pin test on the unshifted bounds, bounds shifted by xtot on the
// fly, clip = min(max(v, lo), hi), one-step-lookahead dual residual,
// scale = sqrt(pr / max(dr, 1e-30)), pr and dr start at +inf, `it` counts
// `iters` per round as a float).
//
// What is different from the TPU kernel, on purpose
// -------------------------------------------------
// Exit semantics. The TPU kernel leaves its round loop when EVERY lane of a
// 1024-lane tile has converged, so finished lanes keep iterating and a lane's
// answer depends on its neighbours. Here a lane is a thread: it stops at its
// own convergence (the thread breaks out of its loop), exactly as the
// per-lane reference of solvers/stage_qp.py does, and `it` is the lane's own
// count. There are no padding lanes: the ragged edge is masked.
//
// Design
// ------
// One thread per lane. NZ and NC are compile-time constants (one shared
// library per (NZ, NC), built on demand with -DNZ=.. -DNC=..), the stage loops
// are real loops, and the [NZ][NZ] blocks of the factorization live in
// registers. Per-lane arrays are tile-major, [ceil(B/32)][rows][32]: a warp is
// one tile, its 32 threads read 32 neighbouring floats (one 128-byte line) at
// every access, and its share of each array is one contiguous block that a
// stage sweep streams through in order. Hd, J and K can be one copy shared by
// all lanes (an LTI problem has the same structure in every lane). The wrapper
// converts layouts in and out with torch and allocates the scratch (Ld, Lo,
// xt, xtot); the kernel allocates nothing and launches on the caller's stream.
//
// What bounds it on this card
// ---------------------------
// Per lane the mutable state is 6*Kst*NZ + 2*N*NC + Kst*NZ(NZ+1)/2 + N*NZ^2
// floats and the read-only data another ~Kst*NZ^2 + 2*N*NC*NZ + 4*Kst*NZ; at
// Kst=51, NZ=4, NC=2 that is ~20 KB, which neither registers nor a useful
// share of the 227 KB of shared memory can hold for enough threads, so the
// state lives in device memory. One ADMM iteration sweeps it three times
// (forward substitution fused with the right-hand side, backward
// substitution, updates): counted from the loops below, ~8,600 floats
// (~34 KB; ~7,000 with Hd, J, K shared) moved per lane and iteration against
// ~12,500 float32 operations, i.e. ~0.4 operations per byte where the card
// needs ~20 to be limited by arithmetic. At B=32768 the working set
// (~0.65 GB) is far beyond the 50 MB L2, so each sweep streams from device
// memory: the kernel is bound by bytes. What the design does about it: the
// coalesced, per-warp-contiguous layout makes every byte that is moved a
// useful one; each sweep touches an array once (the right-hand side is never
// materialised, z/vd/L of the neighbouring stage are carried in registers,
// the three update loops of the reference are one pass); every stage of a
// sweep issues all its loads before its first store, so a stage costs one
// memory round trip, not one per element; lane-invariant Hd, J, K are read as
// warp-wide broadcasts of one copy. Keeping a tile of lanes resident in
// shared memory or L2 across iterations (several threads per lane, TMA
// staging), and keeping a warp's lanes from waiting for its slowest one, are
// the steps after this one.
//
// No -use_fast_math: the iteration divides by Cholesky pivots and takes
// sqrtf, and the exit tests sit at 1e-5.

#include <cuda_runtime.h>
#include <math_constants.h>

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
                    if (k < N) {
#pragma unroll
                        for (int r = 0; r < NC; ++r)
                            acc += rho_eq * Jk[r][i] * Jk[r][j];
                    }
                    if (k > 0) {
#pragma unroll
                        for (int r = 0; r < NC; ++r)
                            acc += rho_eq * Kp[r][i] * Kp[r][j];
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
