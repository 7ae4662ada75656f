#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's paths on the card — the config-1 batched MPC solve by SQP
(H=50 double integrator, B=32768 lanes, float32) through
``make_batched_solver``, the same batch by Levenberg-Marquardt through
``make_batched_lm_solver``, the nonlinear SQP solves of config 2 (Van der Pol,
multiple shooting, H=20) and config 3 (time-optimal double integrator, H=20, a
dt tied across the intervals) at B=4096 through ``make_batched_solver``, the
closed loop of config 5 (4096 rollouts of 20 MPC steps of the config-1 OCP
against the simulated double integrator) through ``make_batched_closed_loop``,
and config 4 (the time-optimal double integrator on the non-uniform
multiple-shooting grid, a free dt per interval) open loop at B=4096 and under
MPC with the RedundantControls grid adaptation (4096 rollouts of 25 steps,
every lane its own active horizon), and the interior-point paths (config 1 by
``make_batched_ip_solver`` at B=32768, the constrained double integrator by
IP, SQP and LM at B=4096, config 5 under the IP controller), config 6
(Van der Pol, Hermite-Simpson, open loop on the compressed and on the
uncompressed grid, and under MPC), move blocking on config 1, the Kalman /
dual-mode closed loop of ``examples/config5_kalman_dual_mode.yaml``,
block cyclic reduction in the plain ADMM, and the port's config loader and
master CLI on the six example YAMLs, a batched config 1, the loader's IP and
LM solvers and the twelve systems of the model zoo, the gRPC master service
(config 1's YAML served in this process and by ``master --serve``), the
real-time loop (config 1's controller at wall-clock rate against a threaded
plant, B=1) and the device mesh (config 1 and a sharded config-5 sweep over
one rank and over two ranks that share the card) — after building
every CUDA kernel of those paths from the sources in this
checkout and holding each kernel against its plain PyTorch version on the same
inputs. There is no CPU path: without a CUDA device the script exits non-zero
and prints no result. Any phase that fails raises, and the run fails with it.

Phases
  1 device   require CUDA; card name and power limit (nvidia-smi)
  2 build    compile csrc/*.cu with nvcc, one process per library (the
             box-QP source for (nz, nc) = (4, 2), (4, 3), (6, 4), (5, 2)
             and (5, 3), the
             block-tridiagonal source for nz = 4 and for nz = 2), started
             together (seconds); -Xptxas -v reports registers and spills
  3 kernels  box-QP ADMM kernels vs plain version at flagship shapes (Kst=51,
             nz=4, nc=2): the reciprocal-based quotient of the kernels against
             the division, bit for bit, on random operands; 256 lanes of
             well-conditioned random QPs against the stated tolerances (B=1,
             B=8 and per-lane Hd/J/K give the same bits; so do B=1 and B=8
             through the one-thread-per-lane kernels), 256 lanes of
             config-1 QPs built by the port against the float64 plain version,
             a horizon too long for shared memory (Kst=1001: the shape rule
             picks the one-thread-per-lane kernels), then the main path's
             batch for the production exits, the warm-started round of the
             outer SQP iteration, the shared-memory kernels against the
             one-thread-per-lane kernels on the same inputs, times and
             roofline bounds.
             The box-QP solve kernel at the nonlinear paths' shapes: the QPs
             of config 2's and config 3's first outer SQP iteration at
             B=4096 (Kst=21, nc=2 and 3, Hd/J/K per lane, two rounds, no KKT
             exit) against the float64 plain version (as close as the
             float32 plain version), per-lane rounds within one of the plain
             version, B=1 and B=8 through both routes give the first lanes'
             bits; wrapper and kernel-alone times, bounds, launch shape.
             Block-tridiagonal factor-and-solve kernels (K3: one thread per
             lane, factor in a scratch; K4: factor kept on chip) vs plain
             version at K=51, nz=4, B=32768: random SPD systems (atol 5e-6),
             the damped Gauss-Newton systems of LM's first and of a late
             iteration on the config-1 batch (as close to the float64 plain
             version as the float32 plain version), B=1, B=8 (every kernel,
             the one-thread-per-lane in-place kernel included) and a batch
             not divisible by 32, D and O broadcast, lanes a stride apart,
             the caller's D and O untouched, K=1001, the kernels against each
             other, wrapper and kernel-alone times on random and on LM's
             systems, bounds and the dense library call as a yardstick.
             The same two kernels built for nz = 2 (the interior-point
             solver's Schur systems: K=50 stages of 2x2 blocks, 16 lanes a
             warp, B=32768): random SPD systems (atol 5e-6), IP's own Schur
             systems of config 1's first and 8th lock-step iteration (as
             close to the float64 plain version as the float32 plain
             version), B=1, 8 and 1000 give the first lanes' bits, K3 against
             K4, times, bound, launch shape, the dense library call.
             The box-QP solve kernel built for (nz, nc) = (6, 4) (phase
             kernels_nz6: config 6 on the uncompressed Hermite-Simpson grid):
             the quotient on 2^24 pairs; random QPs at Kst=21, Hd/J/K per
             lane, four fixed rounds against the float32 plain version (5x
             the flagship tolerances), B=1 and 8 the first lanes' bits on
             both routes; the uncompressed first-iteration QPs of the
             config-6 batch (B=4096) held as configs 2 and 3's are, B=1000
             the first lanes' bits; route, shared memory, registers and
             spills, times, bound; its own entry in the kernels line.
             The same for the (5, 2) and (5, 3) builds (phase kernels_nz5:
             the master zoo's parallel integrators and free-space rocket):
             the quotient; random QPs at Kst=21 as for (6, 4), both routes
             against the float32 plain version; the zoo system's own
             first-iteration QPs at B=4096 around its x0 against the float64
             plain version (as close as the float32 plain version), rounds
             within one, B=1 and 8 the first lanes' bits; registers, spills,
             times, bound; an entry each in the kernels line
  4 main     the batched SQP solve; gates: converged fraction >= 0.99, max
             |U - U_oracle| <= 1e-3 on the first 64 lanes (f64 oracle golden
             file), kernel launch counter > 0; solves/s, mean SQP iterations,
             peak device memory, p99 of 50 single solves
  5 lm       the batched LM solve through the in-place kernel; gates:
             converged fraction >= 0.99, launch counter > 0, and on the first
             64 lanes U and chi2 as close to the f64 LM golden file as the
             reference's own float32 LM (stored in that file); then the same
             batch through K3 (inplace=False), held to the same gates
             (float32 LM is path-dependent: a bit of difference in a step can
             flip an accept test, so the two passes are not held to each
             other; their difference is reported)
  6 nonlinear  configs 2 and 3 at B=4096; gates: converged fraction >= 0.99,
             the box-QP kernel launched once per lock-step SQP iteration
             (launches == the largest iteration count > 0), config 2 max
             |U - U_oracle| <= 1e-3 on the 48 lanes of the f64 oracle golden
             file, config 3 max |T - 2 sqrt(d)| <= 1e-3 on every lane;
             solves/s (best of 3 batches), SQP iterations, peak device
             memory, p50 / p99 of 20 single solves of each
  7 closed_loop  config 5 at B=4096, T=20 (``entry.rollouts``); gates (the
             reference's scenario benchmark): usable-step fraction >= 0.99,
             max |u_fused - u_plain| <= 1e-3 on the same batch (plain =
             backend 'plain', no kernel); ``make_batched_closed_loop`` runs
             the step graphs there (``sim/step_graphs.py``): in a
             torch.profiler trace of its run the box-QP kernel (shared-memory
             route only) launched once per step for the warm-started one-shot
             solve and once per lock-step outer SQP iteration, at least once
             (launches == the sum over steps of max(lock-step SQP
             iterations, 2) > 0 == the port's ``sqp.lockstep_iters``), one
             replayed step a step; the kernel against its plain version on
             the one-shot QPs of step 5 of the same graphs (shifted warm
             start, nonzero warm duals, one shared copy of Hd/J/K; as close to
             the float64 plain version as the float32 plain version, rounds
             within one); rollouts/s and MPC steps/s (best of 3 batches),
             outer SQP iterations per step, mean |x_T|, peak device memory,
             p50 / p99 of one controller step at B=1; then 5 steps under the
             LM controller (LMConfig(max_iter=60)): the in-place
             block-tridiagonal kernel launched once per lock-step LM
             iteration, every u finite, usable fraction reported
  7b closed_loop_graph  the step graphs against the eager loop on three
             seeds of the benchmark's ``rollouts_b4096_t20`` initial states
             and at B = 1 and 1000: x_true, u, ok and every info tensor equal
             bit for bit; in a torch.profiler trace of each, K1 launches ==
             the lock-step SQP iterations (the graphs: one-shot and one loop
             trip every step, and the trips after them), replayed steps and
             trips after the first graph from the port's counters; capture
             s, ms per batch both ways (``--closed-loop-only``: the build,
             phases 7 and 7b and the master's config-1 batch, their lines)
  8 nonuniform  config 4 (``entry.nonuniform_ms_timeopt``, N=10, Kst=11) at
             B=4096 by ``sqp_solve``: converged >= 0.99, max |T - 2 sqrt(d)|
             <= 1e-3 on every lane (T = sum of the dt_k), K1 launches == the
             lock-step SQP iterations; solves/s (best of 3), SQP iterations,
             peak memory, p50 / p99 of 20 single solves. The case-9
             controller (``entry.nonuniform_ms_timeopt_adaptive``: N=15,
             Kst=16, RedundantControls, n_active_init=10, no shift) for 4096
             rollouts of 25 steps (lane 0 from [1.5, 0]): K1 at every step
             once per lock-step SQP iteration, Hd/J/K per lane on every call;
             lane 0 meets the golden test's contract; the usable-step
             fraction of the first 64 rollouts no lower than the JAX
             package's own float32 run of them; rollouts/s, an n_active
             histogram by step, B=1 step p50 / p99; the same batch by
             ``backend='plain'`` over the first 2 steps (equal n_active
             share and max |u_fused - u_plain| there, reported). K1 against its plain version on
             config 4's first-iteration QPs (Kst=11) and on the QPs of
             adaptive step 8 (Kst=16, lanes of mixed horizons, identity-chain
             rows checked), held as on configs 2 and 3
  9 ip       config 1 by IP (``entry.flagship_ip``, B=32768): converged >=
             0.99, max |U - U_oracle| <= 1e-3 on the 64 golden lanes, K4 (nz=2)
             launches == the lock-step IP iterations; solves/s (best of 3),
             IP iterations, peak memory, B=1 p50 / p99 (20 calls). The
             constrained double integrator (``entry.constrained_di``: x2 >=
             -0.9 and x_N = 0 as general rows, N=25, B=4096, d ~ U(-2, 2)
             from default_rng(6)): by IP (converged >= 0.99, min x2 >= -0.9
             - 1e-5 on every lane, max |x_N| <= 1e-4, max |U - U_oracle|
             <= 1e-3 on the 64 lanes of its float64 golden file, K4 nz=2
             launches == lock-step iterations, K4 on its nz=2 shared-memory
             kernel at 16 lanes a warp), by IP once more through
             ``make_batched_ip_solver(inplace=False)`` (K3 launches ==
             lock-step iterations, converged >= 0.99, the U gate), by SQP
             through the plain ADMM (the same quality gates, no kernel
             launched), by LM (K4 nz=4 launches == lock-step iterations, U
             finite; converged fraction and the worst violation reported);
             then K3 and K4 against the float64 plain version on the
             systems these solves hand them (IP's Schur systems, nz=2,
             K=25; LM's, nz=4, K=26; the first and a late iteration of
             each), as close as the float32 plain version. Config 5 under
             the IP controller (``entry.rollouts_ip``, 4096 rollouts of 5
             steps): K4 nz=2 launches == the sum over steps of the lock-step
             IP iterations, u finite and |u| <= 1 + 1e-6, usable fraction of
             the first 64 rollouts no lower than the JAX package's own
             float32 run; max |u_ip - u_sqp| against config 5's SQP rollout
             reported
 10 grids    config 6 open loop (``entry.hermite_simpson`` and
             ``hermite_simpson_unc``, N=20, B=4096, x0 ~ U(-1.5, 1.5)^2
             from default_rng(60), lane 0 at [1, 0.5]): converged >= 0.99,
             K1 launches == the lock-step SQP iterations (Hd/J/K per lane;
             the uncompressed grid through the (6, 4) build), max |U -
             U_oracle| <= 1e-3 on the 48 lanes of
             tests/golden/torch_hs_vdp_oracle_N20.npz, the uncompressed U
             within 1e-3 of the compressed U on every lane; move blocking on
             config 1 (``entry.move_blocking``: ten blocks of 5, B=32768):
             one one-shot K1 launch on shared Hd/J/K at nc = 3 plus the
             outer iterations (== lock-step), converged >= 0.99, controls
             equal inside each block to 1e-6, objective >= config 1's
             unblocked objective - 1e-5 lane by lane; solves/s (best of 3),
             SQP iterations, B=1 p50 / p99 (20 calls)
 11 hs_closed_loop  config 6 under MPC (``entry.rollouts_hs``, 4096
             rollouts of 40 steps): K1 at every step == its lock-step SQP
             iterations, Hd/J/K per lane; u finite; usable fraction of the
             first 64 rollouts >= the JAX package's own float32 run
             (``tools/config6_calibration.py``); max |u_fused - u_plain| <=
             1e-3 over the first 10 steps, and over all 40 steps of the
             first 256 rollouts (plain = backend 'plain'); rollouts/s, B=1
             step p50 / p99
 12 dual_mode  ``entry.kalman_dual_mode`` (the config-5 YAML: N=30, T=60,
             4096 rollouts, first-state output with noise 0.02 from a seeded
             generator, Kalman filter, MPC -> LQR in x'x <= 0.09, latched):
             K1 at every step on one hoisted Hd/J/K (== sum of the lock-step
             SQP iterations), the switch contract on every lane and step, u
             finite, |u| - 1 on MPC steps <= twice the JAX package's own
             float32 value (the fused path leaves the box by ~3e-5 in
             float32 in both packages); the same batch noise-free: every
             lane local at the end with |x_T| < 5e-2
 13 bcr      the constrained double integrator by SQP through the plain
             ADMM with linsolver='bcr' against 'scan' at B=4096 (scan's run
             is the ip phase's) and B=1: max |U_bcr - U_scan| <= 1e-4,
             converged >= 0.99, no kernel launched; times
 14 master   the config loader and the master CLI (``core/config.py``,
             ``master.py``): the six example YAMLs at their own settings
             through ``master.main`` in this process (config 5 twice: with
             its output noise, held to the switch contract and the box gate;
             with noise 0), each with K1 launches == the lock-step SQP
             iterations > 0, the exported controls == the run's, the
             usable-step fraction >= the JAX package's own float32 run's,
             and the controls and states within max(2 x the reference's own
             float32 distance, 1e-3) of the float64 golden
             (tests/golden/torch_master_examples.npz, tools/master_golden.py)
             on the steps before the reference's float32 run parts from it
             (config 4: step 2; where the port's parts is reported); config
             1 as ``benchmark_varying_x0`` over a 64 x 64 grid (4096
             rollouts of 70 steps; usable >= 0.99, K1 == lock-step, max
             |u_fused - u_plain| <= 1e-3 over the first 10 steps, plain =
             backend 'plain' with linsolver 'bcr'; rollouts/s, MPC steps/s,
             best of 3); config 1 by IP and by LM (10 steps, K4 ==
             lock-step, u finite, IP's |u| <= 1 + 1e-6) and an increasing-N
             sweep; one open loop of each of the twelve registered systems
             (tests/golden/torch_master_zoo.npz: U within max(2 x the
             reference's own float32 distance, 1e-3) of the converged float64
             golden; K1 through its (4, 2), (5, 2), (5, 3) and (6, 4) builds);
             every run's K1 launches by build, from the wrapper's own
             per-build counts, summing to its total
 15 serve    config 1's YAML (70 steps, f32, B=1) served on the card: the
             port's ``MasterServer`` behind ``grpc.server`` on localhost:0 in
             this process, the port's ``MasterClient``: ping, set_config,
             verify_config, available_signals, performTask; gates: the stream
             holds master/progress 0.0 then 1.0 and every signal of an
             in-process ``run_experiment`` of the YAML within 1e-6, K1
             launches == the lock-step SQP iterations > 0; then ``python -m
             control_box_rst_tpu_torch.master --serve localhost:0 --config
             <yaml>`` as a subprocess (port from its first line, the same
             gates but the launches, which another process makes), and
             ``stop`` (ok() false, then restored); wall, messages, bytes on
             the wire. The transport (gRPC) is decided before the phase and
             printed on a line of its own
 16 realtime config 1's YAML controller (f32, K1 on the hoisted Hd/J/K)
             through ``run_realtime_closed_loop`` at dt 0.1 for 3 s against a
             ``SimulatedPlantThreaded`` of its plant (sim_dt 0.005, on the
             card), logged by the native ``SignalWriter``; gates: the native
             runtime built, 30 steps and 30 records, none dropped, |x_T| <
             |x_0|, |u| <= 1 + 1e-6, K1 launches == the SQP iterations of
             every controller call > 0; overruns of the loop and of the
             plant thread, solve mean / p99 beside the closed_loop phase's
             B=1 step p99, what ``set_realtime_priority`` returned (reported)
 17 mesh     the device mesh (``parallel/mesh.py``): (a) one rank in this
             process, ``make_mesh()`` on the card (nccl), config 1's main
             batch through ``make_batched_solver(mesh=)``: U == the main
             phase's U bit for bit, K1 launches == the lock-step SQP
             iterations > 0, the four outputs Shard(0) DTensors over the
             one-rank mesh, converged >= 0.99, max |U - U_oracle| <= 1e-3,
             solves/s beside the main phase's (the wrapper's overhead); (b)
             MESH_RANKS ranks spawned on the one card (gloo: NCCL refuses
             two ranks on one GPU) under one timeout: the main
             batch split over them, gathered U == the unsharded U bit for
             bit, each rank's K1 launches == its lock-step SQP iterations >
             0; ``benchmark_varying_initial_state(mesh=)`` over a 64 x 64
             grid of config 5 with state noise (5 steps) == the unsharded
             sweep on every field, lane by lane; ``entry.dryrun_multichip``
             in every rank. One card: the mechanics, not scaling
 18 result   one JSON line with every kernel's record, then the contract line

Output: progress lines (with ``--profile`` a ``{"profile": ...}`` line with
the device time by kernel and the hand-written kernels launch by launch, a
``{"kernels_alone_ms": ...}`` line with K1 and K2 on both routes and K4's
one-thread-per-lane route by themselves, and a ``{"profile_nonlinear": ...}``
line: one traced batch of configs 2 and 3, with the eager kernels per SQP
iteration, a ``{"profile_closed_loop": ...}`` line: one traced rollout
batch, with its device idle share and the eager kernels per MPC step, and a
``{"profile_nonuniform": ...}`` line: one traced config-4 batch and 5 traced
steps of its adaptive rollouts), then a ``{"main": ...}`` line, a ``{"lm":
...}`` line, a ``{"nonlinear": ...}`` line, a ``{"closed_loop": ...}`` line,
a ``{"closed_loop_graph": ...}`` line, a ``{"nonuniform": ...}`` line, an ``{"ip": ...}`` line (``--profile``
adds ``profile_ip``: one traced config-1 and constrained-DI IP batch, eager
kernels per IP iteration, and ``profile_grids``: one traced batch of each
path of phases 10-12), ``{"grids": ...}``, ``{"hs_closed_loop": ...}``,
``{"dual_mode": ...}``, ``{"bcr": ...}``, ``{"master": ...}``, ``{"serve":
...}`` and ``{"realtime": ...}`` and ``{"mesh": ...}`` lines (``--profile`` adds
``profile_realtime``: 10 steps of the real-time controller at B=1 back to
back under ``utils.profiling.device_trace``, with its device idle share and
eager kernels per MPC step), the nvidia-smi line, a
``{"kernels": [...]}``
line (per kernel the contract's keys and, where a kernel was redesigned,
``earlier_ms`` / ``vs_earlier``: the kernel it replaced on the same inputs,
and ``launch``: route, shared memory per lane, resident lanes per SM,
registers per thread; the box-QP solve kernel adds ``launches_by_path`` (with ``serve_config1``, ``realtime_config1``,
``mesh_config1`` and each mesh rank's ``mesh_rank<r>_{config1,sweep,dryrun}``) and
``shapes``, its records at the nonlinear paths' shapes, on the closed
loop's step-5 QPs, at config 4's two horizons and on the uncompressed
config-6 QPs; ``boxqp_solve[nz6_nc4]``, ``boxqp_solve[nz5_nc2]`` and
``boxqp_solve[nz5_nc3]`` are the other builds' own entries (launches: those
at that build, on the uncompressed grid's path and the master's zoo); the
(4, 2) / (4, 3) entry's ``launches`` are the rest of the total,
``launches_all_builds``); the in-place block-tridiagonal kernel adds
``launches_by_path``: LM on config 1, the LM closed loop, config 1 by IP, the
constrained double integrator by IP and by LM, the IP controller; K3 its
``inplace=False`` LM and IP passes; both add ``nz2``, their record at the IP
Schur systems' shape, and ``held_on_paths``, their errors on the constrained
double integrator's own systems), and as the last
line ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.
"""
from __future__ import annotations

import argparse
import copy
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

GOLDEN = ROOT / "tests" / "golden" / "torch_flagship_oracle_N50.npz"
LM_GOLDEN = ROOT / "tests" / "golden" / "torch_lm_oracle_N50.npz"
VDP_GOLDEN = ROOT / "tests" / "golden" / "torch_vdp_ms_oracle_N20.npz"
BATCH = 32768      # lanes of the main paths
SMALL_BATCH = 256  # lanes of the tolerance checks
KERNEL_REPS = 3    # launches per kernel timing
TRIALS, REPS = 3, 2  # SQP path: best of TRIALS windows of REPS solves
LM_TRIALS = 2      # LM path: best of LM_TRIALS single batches
LM_LATE_ITERATION = 15  # the "late" LM iteration whose linear system is checked
LONG_KST = 1001   # a horizon whose lane state does not fit shared memory
LONG_BATCH = 128  # lanes of the long-horizon checks
NL_BATCH = 4096    # lanes of the nonlinear paths (configs 2 and 3)
NL_TRIALS = 3      # nonlinear paths: best of NL_TRIALS single batches
NL_SINGLE = 20     # single solves of each nonlinear config for its p50 / p99
CL_BATCH = 4096    # rollouts of the closed-loop path (config 5)
CL_TRIALS = 3      # closed loop: best of CL_TRIALS rollout batches
CL_CHECK_STEP = 5  # the MPC step whose warm-started one-shot QPs K1 is held to
CL_LM_STEPS = 5    # steps of the closed loop under the LM controller
CLG_SEEDS = (11, 12, 13)  # seeds of rollouts_b4096_t20's initial states, step graphs vs eager
CLG_TRIALS = 3     # step graphs vs eager: best of CLG_TRIALS rollout batches each way
NU_BATCH = 4096    # lanes, and rollouts, of config 4
NU_TRIALS = 3      # config 4 open loop: best of NU_TRIALS single batches
NU_CL_TRIALS = 1   # config 4 closed loop: best of the counted and NU_CL_TRIALS more batches
NU_SINGLE = 20     # single config-4 solves for the open loop's p50 / p99
NU_CHECK_STEP = 8  # the adaptive MPC step whose QPs (mixed horizons) K1 is held to
NU_PLAIN_STEPS = 4   # steps of config 4's rollouts also run by the plain backend
IP_TRIALS = 3      # config 1 by IP: best of IP_TRIALS single batches
IP_SINGLE = 20     # single config-1 IP solves for its p50 / p99
IP_LATE_ITERATION = 8  # the "late" IP iteration whose Schur systems are checked
DI_BATCH = 4096    # lanes of the constrained double integrator
DI_DT = 0.25       # its pinned dt, carried by the initial guess
DI_GOLDEN = ROOT / "tests" / "golden" / "torch_constrained_di_oracle_N25.npz"
IP_CL_BATCH = 4096  # rollouts of config 5 under the IP controller
IP_CL_STEPS = 5     # its steps
HS_BATCH = 4096     # lanes of config 6 open loop (compressed and uncompressed grid)
HS_TRIALS = 3       # config 6 open loop and move blocking: best of HS_TRIALS batches
HS_SINGLE = 20      # single solves of each grid path for its p50 / p99
HS_GOLDEN = ROOT / "tests" / "golden" / "torch_hs_vdp_oracle_N20.npz"
MB_BATCH = 32768    # lanes of move blocking (config 1's main batch)
BLOCK_TOL = 1e-6    # move blocking: controls equal inside a block
HS_CL_BATCH = 4096  # rollouts of config 6 under MPC
HS_CL_PLAIN_STEPS = 10  # steps of that batch also run by the plain backend
HS_CL_PLAIN_LANES = 256  # rollouts of that batch run by the plain backend over more steps
# the steps of those rollouts: all 40 (the plain backend's Python loop costs
# the same for 256 rollouts as for 4096, ~2.8 s a step on the card)
HS_CL_PLAIN_ALL_STEPS = 40
HS_CL_REF_LANES = 64
# the JAX package's own float32 run of config 6's first 64 rollouts
# (tools/config6_calibration.py, PERF.md §2)
HS_CL_REF_USABLE = 1.0
DM_BATCH = 4096     # rollouts of the Kalman / dual-mode closed loop
DM_SEED = 5         # seed of the generator the output noise is drawn from
# the largest |u| - 1 on the steps where MPC acts in the JAX package's own
# float32 run of the dual-mode closed loop (first 64 rollouts, noise off,
# the fused path's per-lane reference; tools/config6_calibration.py): ADMM
# leaves the box by up to this much in float32, in both packages alike
DM_REF_BOX = 2.765655517578125e-05
DM_BOX_GATE = max(1e-6, 2.0 * DM_REF_BOX)
BCR_TOL = 1e-4      # max |U_bcr - U_scan|
# the JAX package's own float32 run of those rollouts (tools/ip_calibration.py):
# the usable-step fraction of the first 64, which the port's may not fall below
IP_CL_REF_LANES, IP_CL_REF_USABLE = 64, 1.0
# the JAX package's own float32 run of config 4's adaptive closed loop on the
# first 64 rollouts (tools/config4_calibration.py --closed-loop): their
# usable-step fraction, which the port's first 64 rollouts may not fall below
NU_REF_LANES, NU_REF_USABLE = 64, 0.9475
CONV_GATE = 0.99
ERR_GATE = 1e-3
# published peaks of one H100 SXM (NVIDIA data sheet): the roofline yardstick
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# kernel-vs-plain tolerances of a fixed-work round: float32 roundoff of two
# orderings of the same recurrences, amplified by rho_eq = 1e3 in the duals
# (the bounds the JAX package uses for its kernel vs its XLA path)
X_TOL = dict(rtol=2e-4, atol=2e-5)
DUAL_TOL = dict(rtol=2e-3, atol=3e-3)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def assert_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
        worst = float((err - bound).max())
        raise AssertionError(
            f"{name}: kernel and plain version disagree (max abs err "
            f"{float(err.max()):.3e}, worst excess over bound {worst:.3e}, "
            f"rtol={rtol}, atol={atol})"
        )
    return float(err.max())


def config1_qps(ocp, x0s, step=None, y_d=None, y_b=None):
    """The stage QPs of an SQP linearization of config 1 for a batch of
    initial states, in the kernels' argument order: the first one from a cold
    start, or, given ``step`` (the previous QP's solution) and its duals, the
    one the outer SQP loop builds next, warm-started from those duals."""
    from control_box_rst_tpu_torch.ocp.problem import Trajectory

    dtype, dev = x0s.dtype, x0s.device
    B = x0s.shape[0]
    N, nz, nc = ocp.N, ocp.nz, ocp.nc
    o = ocp.replace(bc=ocp.bc.replace(x0=x0s))
    traj0 = o.apply_boundary(
        Trajectory.linear_interp(x0s, o.refs.xref[-1], N, o.nu, 0.1)
    )
    W0 = o.pack(traj0)
    free = 1.0 - o.fixed_mask().to(dtype)
    if step is not None:
        W0 = W0 + step * free
    lb, ub = o.w_bounds()
    lb, ub = torch.clamp(lb, min=-1e8), torch.clamp(ub, max=1e8)
    W_ref = torch.zeros_like(W0[0])
    W_ref[:, o.nx:] = o.pack(traj0)[0, :, o.nx:]
    J, K, _ = o.interval_jacobians(W_ref)
    Hd = o.cost_hessian_blocks(W_ref) * free[:, None, :] * free[:, :, None]
    zero = torch.zeros_like(W0)
    ex = lambda a: a.expand((B,) + tuple(a.shape))
    dlb = torch.where(free > 0, lb - W0, zero)
    dub = torch.where(free > 0, ub - W0, zero)
    return [
        ex(Hd), ex(J * free[:-1, None, :]), ex(K * free[1:, None, :]),
        o.cost_gradient(W0) * free, o.interval_residuals(W0), dlb, dub,
        torch.ones(B, dtype=dtype, device=dev),  # rho of the flagship config
        zero, torch.minimum(torch.maximum(zero, dlb), dub),
        y_d if y_d is not None else torch.zeros((B, N, nc), dtype=dtype, device=dev),
        y_b if y_b is not None else zero,
    ]


def random_qps(B, Kst, nz, nc, rho, device):
    """Well-conditioned random box QPs at the kernels' shapes (the QPs of the
    JAX package's own kernel test, batched), made from a seed with numpy."""
    rng = np.random.default_rng(0)
    N = Kst - 1
    A = rng.standard_normal((B, Kst, nz, nz)) * 0.3
    Hd = np.einsum("bkij,bklj->bkil", A, A) + 2.0 * np.eye(nz)
    g = rng.standard_normal((B, Kst, nz))
    J = rng.standard_normal((B, N, nc, nz)) * 0.5
    K = rng.standard_normal((B, N, nc, nz)) * 0.5
    c = rng.standard_normal((B, N, nc)) * 0.1
    dlb = np.full((B, Kst, nz), -0.7)
    dub = np.full((B, Kst, nz), 0.7)
    dlb[:, 0, :2] = dub[:, 0, :2] = 0.0  # pins, like the fixed x0
    dlb[:, -1, -1] = dub[:, -1, -1] = 0.0
    z = np.zeros((B, Kst, nz))
    arrs = [Hd, J, K, g, c, dlb, dub, np.full((B,), rho), z,
            np.clip(z, dlb, dub), np.zeros((B, N, nc)), z]
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrs]


def as_f64(args):
    return [a.double() for a in args]


def k1_launches_by_build(ak, label):
    """K1's launches since the last reset by (nz, nc) build, as
    ``{"<nz>x<nc>": n}``, from the wrapper's own per-build counts; raises
    unless they sum to its total."""
    by = {f"{nz}x{nc}": n for (name, nz, nc), n in sorted(ak.LAUNCHES_BY_SHAPE.items())
          if name == "boxqp_solve"}
    if sum(by.values()) != ak.LAUNCHES["boxqp_solve"]:
        raise AssertionError(f"{label}: K1 launches by build {by} do not sum to "
                             f"{ak.LAUNCHES['boxqp_solve']}")
    return by


def all_equal(outs_a, outs_b) -> bool:
    return all(torch.equal(a, b) for a, b in zip(outs_a, outs_b))


def check_quotient(ak, nz: int, nc: int, n: int = 1 << 24) -> int:
    """The kernels' quotient from a reciprocal against the division itself, bit
    for bit, on `n` operand pairs from a seed: mantissas uniform, exponents
    uniform in 2^-100..2^100 (inside and outside the fast window), with zeros
    of both signs, infinities and NaNs mixed in, and divisors also negative,
    zero, subnormal. Returns the number of pairs checked; raises on the first
    difference."""
    g = torch.Generator(device="cuda").manual_seed(0)
    def operands():
        mant = 1.0 + torch.rand(n, generator=g, device="cuda")
        expo = torch.randint(-100, 101, (n,), generator=g, device="cuda").float()
        sign = torch.where(torch.rand(n, generator=g, device="cuda") < 0.5, -1.0, 1.0)
        return sign * mant * torch.exp2(expo)
    a, b = operands(), operands().abs()
    special = torch.tensor(
        [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-42, -1e-42, 3.0, -1.5],
        device="cuda")
    a[: special.numel() * 64] = special.repeat(64)
    b[-special.numel() * 64:] = special.repeat_interleave(64)
    a[-special.numel() * 64:] = special.repeat(64)
    bad = ak.division_mismatches(a, b, nz, nc)
    torch.cuda.synchronize()
    n_bad = int(bad.sum())
    if n_bad:
        i = int(bad.nonzero()[0])
        raise AssertionError(
            f"quotient from the reciprocal differs from the division on {n_bad} of {n} "
            f"pairs, first a={float(a[i])!r} b={float(b[i])!r}")
    return n


def assert_as_close_as_plain(name, kern, plain, truth, slack=2.0, floor=1e-5):
    """The kernel may be as far from the float64 result as the float32 plain
    version is (times `slack`, plus `floor`), and no farther."""
    e_k = float((kern.double() - truth).abs().max())
    e_p = float((plain.double() - truth).abs().max())
    if not (e_k <= slack * e_p + floor) or not bool(torch.isfinite(kern).all()):
        raise AssertionError(
            f"{name}: kernel is {e_k:.3e} from the float64 plain version, the "
            f"float32 plain version {e_p:.3e} (allowed {slack} x + {floor})"
        )
    return e_k, e_p


def phase_kernels(ocp, cfg, x0s_all, small_b: int, reps: int):
    """Each kernel against its plain version; returns the kernels' records.

    Two kinds of inputs at the flagship shapes. On well-conditioned random QPs
    kernel and float32 plain version must agree within X_TOL / DUAL_TOL. On
    the config-1 QPs themselves M = Hd + sigma I + rho_eq A'A is ill-
    conditioned (rho_eq J'J ~ 1e3 * (1/dt)^2 against R = 0.2), so ONE
    non-recentered float32 round carries ~1e-3 of amplified roundoff whatever
    the order of operations: there the yardstick is the float64 plain version,
    and the kernel must be as close to it as the float32 plain version is.
    """
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

    qp = cfg.qp
    base = dict(sigma=qp.sigma, alpha=qp.alpha, rho_eq_scale=qp.rho_eq_scale)
    solve_kw = dict(base, rho_min=qp.rho_min, rho_max=qp.rho_max)
    iters = qp.iters_per_round
    n_rounds = max(1, -(-(cfg.max_iter * qp.max_iter) // iters))
    prod_kw = dict(
        solve_kw, n_rounds=n_rounds, iters=iters, tol=qp.tol,
        tol_stat=cfg.tol_stat, tol_feas=cfg.tol_feas,
    )
    fixed_kw = dict(solve_kw, n_rounds=4, iters=iters, tol=0.0)
    x5 = {k: 5 * v for k, v in X_TOL.items()}
    d5 = {k: 5 * v for k, v in DUAL_TOL.items()}
    Kst, nz, nc = ocp.N + 1, ocp.nz, ocp.nc
    errs = {}
    info = lambda name: dict(ak.LAUNCH_INFO[name])

    def expect_route(name, route):
        if info(name).get("route") != route:
            raise AssertionError(f"{name}: expected route {route!r}, took {info(name)}")

    # ---- the quotient the shared-memory kernels build from a reciprocal ----
    errs["quotient_pairs_bit_equal"] = check_quotient(ak, nz, nc)

    # ---- random QPs, 256 lanes: kernel vs float32 plain version ----
    args = random_qps(small_b, Kst, nz, nc, 0.1, x0s_all.device)
    for it_n in (1, iters):
        out_k = ak.admm_round(*args, iters=it_n, **base)
        out_p = ak.admm_round_plain(*args, iters=it_n, **base)
        torch.cuda.synchronize()
        e = assert_close(f"admm_round iters={it_n} x", out_k[0], out_p[0], **X_TOL)
        assert_close(f"admm_round iters={it_n} z_b", out_k[1], out_p[1], **X_TOL)
        assert_close(f"admm_round iters={it_n} y_d", out_k[2], out_p[2], **DUAL_TOL)
        assert_close(f"admm_round iters={it_n} y_b", out_k[3], out_p[3], **DUAL_TOL)
        assert_close(f"admm_round iters={it_n} pr", out_k[4], out_p[4], rtol=1e-2, atol=1e-4)
        errs[f"random/admm_round_iters{it_n}_x"] = e
        # the one-thread-per-lane kernel (the route of long horizons), and its
        # instance for fewer lanes than a warp: the same bits
        out_t = ak.admm_round(*args, iters=it_n, **base, route="thread")
        out_8 = ak.admm_round(*[a[:8] for a in args], iters=it_n, **base, route="thread")
        torch.cuda.synchronize()
        if info("admm_round").get("lane_tile") != 1:
            raise AssertionError(f"admm_round B=8 thread route took {info('admm_round')}")
        assert_close(f"admm_round iters={it_n} thread x", out_t[0], out_p[0], **X_TOL)
        assert_close(f"admm_round iters={it_n} thread y_d", out_t[2], out_p[2], **DUAL_TOL)
        if not all_equal(out_8, [o[:8] for o in out_t]):
            raise AssertionError("admm_round thread route: B=8 disagrees with the first lanes")
    # full solve, exits disabled: 4 rounds of fixed work, bounds loosened x5
    # (four rounds of adapted rho compound the roundoff of one)
    out_k = ak.boxqp_solve(*args, **fixed_kw)
    out_p = ak.boxqp_solve_plain(*args, **fixed_kw)
    torch.cuda.synchronize()
    errs["random/boxqp_solve_fixed4_x"] = assert_close(
        "boxqp_solve fixed x", out_k[0], out_p[0], **x5)
    assert_close("boxqp_solve fixed y_d", out_k[2], out_p[2], **d5)
    assert_close("boxqp_solve fixed y_b", out_k[3], out_p[3], **d5)
    if not bool((out_k[6] == 4 * iters).all()):
        raise AssertionError("boxqp_solve with exits disabled must run every round")
    expect_route("boxqp_solve", "smem")
    # a lane's arithmetic does not depend on the batch around it, so neither do
    # its bits: B = 1, B = 8 and a batch that leaves teams without a lane
    for n in (1, 8, small_b - 56):
        out_n = ak.boxqp_solve(*[a[:n] for a in args], **fixed_kw)
        torch.cuda.synchronize()
        if not all_equal(out_n, [o[:n] for o in out_k]):
            raise AssertionError(f"boxqp_solve: B={n} disagrees with the first lanes of B={small_b}")
    # ... and a batch of 1000 (teams queue for lanes; a ragged last warp)
    big = random_qps(1000, Kst, nz, nc, 0.1, x0s_all.device)
    out_big = ak.boxqp_solve(*big, **fixed_kw)
    out_sub = ak.boxqp_solve(*[a[:300] for a in big], **fixed_kw)
    torch.cuda.synchronize()
    if not all_equal(out_sub, [o[:300] for o in out_big]):
        raise AssertionError("boxqp_solve: B=300 disagrees with the first lanes of B=1000")
    errs["random/boxqp_solve_fixed4_B1000_x"] = assert_close(
        "boxqp_solve B=1000 fixed x", out_big[0], ak.boxqp_solve_plain(*big, **fixed_kw)[0], **x5)
    del big, out_big, out_sub
    # the one-thread-per-lane kernels run the same statements in the same
    # order; reported, not gated (the compiler contracts FMAs as it sees fit)
    out_t = ak.boxqp_solve(*args, **fixed_kw, route="thread")
    torch.cuda.synchronize()
    expect_route("boxqp_solve", "thread")
    errs["random/boxqp_solve_fixed4_smem_vs_thread_x"] = assert_close(
        "boxqp_solve smem vs thread x", out_k[0], out_t[0], **x5)
    errs["random/boxqp_solve_fixed4_smem_bit_equal_thread"] = all_equal(out_k, out_t)
    assert_close("boxqp_solve thread route x", out_t[0], out_p[0], **x5)
    assert_close("boxqp_solve thread route y_d", out_t[2], out_p[2], **d5)
    # ... and their instance for fewer lanes than a warp (what a long horizon
    # takes at B < 32) gives the bits of the full batch's first lanes
    for n in (1, 8):
        out_n = ak.boxqp_solve(*[a[:n] for a in args], **fixed_kw, route="thread")
        torch.cuda.synchronize()
        if info("boxqp_solve").get("lane_tile") != 1:
            raise AssertionError(f"boxqp_solve B={n} thread route took {info('boxqp_solve')}")
        if not all_equal(out_n, [o[:n] for o in out_t]):
            raise AssertionError(f"boxqp_solve thread route: B={n} disagrees with the first lanes")

    # ---- config-1 QPs, 256 lanes: float64 plain version as the yardstick ----
    args = config1_qps(ocp, x0s_all[:small_b])
    for it_n in (1, iters):
        out_k = ak.admm_round(*args, iters=it_n, **base)
        out_p = ak.admm_round_plain(*args, iters=it_n, **base)
        out_d = ak.admm_round_plain(*as_f64(args), iters=it_n, **base)
        torch.cuda.synchronize()
        for i, nm in ((0, "x"), (2, "y_d"), (3, "y_b")):
            e_k, e_p = assert_as_close_as_plain(
                f"config1 admm_round iters={it_n} {nm}", out_k[i], out_p[i], out_d[i])
            errs[f"config1/admm_round_iters{it_n}_{nm}"] = [e_k, e_p]
    out_k = ak.boxqp_solve(*args, **fixed_kw)
    out_p = ak.boxqp_solve_plain(*args, **fixed_kw)
    out_d = ak.boxqp_solve_plain(*as_f64(args), **fixed_kw)
    torch.cuda.synchronize()
    for i, nm in ((0, "x"), (2, "y_d"), (3, "y_b")):
        # after 4 recentered rounds both float32 versions sit at their noise
        # level (~1e-5); a ratio of two noise-level numbers says little, so
        # the floor is 1e-4 here
        e_k, e_p = assert_as_close_as_plain(
            f"config1 boxqp_solve fixed {nm}", out_k[i], out_p[i], out_d[i], floor=1e-4)
        errs[f"config1/boxqp_solve_fixed4_{nm}"] = [e_k, e_p]
    # Hd, J, K of config 1 are broadcast views, which the kernels read as one
    # shared copy; one copy per lane must give the same bits
    shared_info = info("boxqp_solve")
    out_c = ak.boxqp_solve(*[a.contiguous() for a in args], **fixed_kw)
    torch.cuda.synchronize()
    if not shared_info["shared_hjk"] or info("boxqp_solve")["shared_hjk"]:
        raise AssertionError("boxqp_solve: broadcast Hd/J/K must be passed once, copies per lane")
    if not all_equal(out_k, out_c):
        raise AssertionError("boxqp_solve: shared and per-lane Hd/J/K disagree")
    errs["per_lane_hjk_smem_bytes_per_lane"] = info("boxqp_solve")["smem_bytes_per_lane"]

    # ---- the shape rule: a horizon whose state does not fit shared memory ----
    # takes the one-thread-per-lane kernels (no route is named here)
    if ak.solve_route(LONG_KST, nz, nc, False) != "thread" or ak.solve_route(Kst, nz, nc, False) != "smem":
        raise AssertionError("the shape rule does not separate Kst=51 from Kst=1001")
    long_args = random_qps(LONG_BATCH, LONG_KST, nz, nc, 0.1, x0s_all.device)
    long_kw = dict(solve_kw, n_rounds=2, iters=3, tol=0.0)
    out_k = ak.boxqp_solve(*long_args, **long_kw)
    torch.cuda.synchronize()
    expect_route("boxqp_solve", "thread")
    out_p = ak.boxqp_solve_plain(*long_args, **long_kw)
    errs[f"random/boxqp_solve_Kst{LONG_KST}_x"] = assert_close(
        f"boxqp_solve Kst={LONG_KST} x", out_k[0], out_p[0], **x5)
    assert_close(f"boxqp_solve Kst={LONG_KST} y_d", out_k[2], out_p[2], **d5)
    out_k = ak.admm_round(*long_args, iters=3, **base)
    torch.cuda.synchronize()
    expect_route("admm_round", "thread")
    out_p = ak.admm_round_plain(*long_args, iters=3, **base)
    assert_close(f"admm_round Kst={LONG_KST} x", out_k[0], out_p[0], **X_TOL)
    del long_args, out_k, out_p
    log(f"kernels[{small_b} lanes]: " + json.dumps(errs))

    # ---- the main path's batch: production exits, times, bounds ----
    # The exit tests compare float32 residuals at their noise floor with the
    # tolerances, so a lane near a threshold at a round boundary leaves one
    # round earlier or later depending on rounding (FMA contraction in the
    # kernel, none in the plain version). Gates: every lane within one round
    # of the plain version, at least 90 % on the same round, and the kernel's
    # solution as close to a tight float64 solve as the plain version's.
    B = x0s_all.shape[0]
    args = config1_qps(ocp, x0s_all)
    records = []

    out_k = ak.boxqp_solve(*args, **prod_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = ak.boxqp_solve_plain(*args, **prod_kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    tight = dict(prod_kw, n_rounds=40, tol=1e-9, tol_stat=1e-9, tol_feas=1e-10)
    truth = ak.boxqp_solve_plain(*as_f64(args), **tight)[0]
    e_k, e_p = assert_as_close_as_plain(
        f"boxqp_solve B={B} production exits x", out_k[0], out_p[0], truth, slack=1.5, floor=1e-4)
    dx = float((out_k[0] - out_p[0]).abs().max())
    d_rounds = (out_k[6] - out_p[6]).abs() / iters
    same_it = float((d_rounds == 0).float().mean())
    if not bool((d_rounds <= 1).all()) or same_it < 0.90:
        raise AssertionError(
            f"boxqp_solve B={B}: per-lane rounds differ from the plain version "
            f"by up to {float(d_rounds.max())}, equal on {same_it:.4f} of lanes"
        )
    if not (dx <= 3e-3):
        raise AssertionError(f"boxqp_solve B={B}: max |dx| kernel vs plain {dx:.3e} > 3e-3")
    expect_route("boxqp_solve", "smem")
    k1_info = info("boxqp_solve")
    # the shared-memory kernel against the one-thread-per-lane kernel it
    # replaced on this path, same inputs, in turns inside this run
    out_t = ak.boxqp_solve(*args, **prod_kw, route="thread")
    torch.cuda.synchronize()
    vs_earlier = dict(
        max_abs_dx=float((out_k[0] - out_t[0]).abs().max()),
        same_it_frac=float((out_k[6] == out_t[6]).float().mean()),
        bit_equal=all_equal(out_k, out_t),
    )
    run = {r: (lambda r=r: ak.boxqp_solve(*args, **prod_kw, route=r)) for r in ak.ROUTES}
    t_thread = time_ms(run["thread"], reps)
    ms = time_ms(run["smem"], reps)
    ms = min(ms, time_ms(run["smem"], reps))
    earlier_ms = min(t_thread, time_ms(run["thread"], reps))
    one = [a[:1] for a in args]
    b1_ms = {r: time_ms(lambda r=r: ak.boxqp_solve(*one, **prod_kw, route=r), 20) for r in ak.ROUTES}
    del out_t
    rounds = float((out_k[6] / iters).sum())  # rounds this run's data needed
    ops = rounds * ak.solve_flops_per_round(Kst, nz, nc, iters, True)
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    t_bytes = ak.io_bytes(Kst, nz, nc, B, True, shared_hjk=True) / PEAK_BYTES_PER_S * 1e3
    records.append(dict(
        name="boxqp_solve", route="cuda",
        source="control_box_rst_tpu_torch/csrc/admm_kernel.cu",
        replaces="control_box_rst_tpu/ops/pallas/admm_kernel.py:483",
        launches=0, max_abs_err=dx, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, on_main_path=True, batch=B,
        earlier_ms=earlier_ms, vs_earlier=vs_earlier, launch=k1_info,
        single_lane_ms=b1_ms["smem"],
        earlier_single_lane_ms=b1_ms["thread"],
        err_vs_f64=e_k, plain_err_vs_f64=e_p,
        same_it_frac=same_it, mean_rounds=rounds / B,
        max_rounds=float(out_k[6].max()) / iters,
        rounds_hist=torch.bincount((out_k[6] / iters).long()).tolist(),
        plain_mean_rounds=float(out_p[6].mean()) / iters,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
    ))

    # the main path's second launch: an outer SQP iteration calls the same
    # kernel for one round without the KKT exit, warm-started from the first
    # solve's duals. The step of a lane that has nearly converged is at the
    # float32 noise level, so the yardstick is again the float64 plain version.
    warm_args = config1_qps(ocp, x0s_all, step=out_k[0], y_d=out_k[2], y_b=out_k[3])
    warm_kw = dict(
        solve_kw, n_rounds=max(1, -(-qp.max_iter // iters)), iters=iters,
        tol=qp.tol, tol_stat=0.0, tol_feas=0.0,
    )
    w_k = ak.boxqp_solve(*warm_args, **warm_kw)
    w_p = ak.boxqp_solve_plain(*warm_args, **warm_kw)
    w_d = ak.boxqp_solve_plain(*as_f64(warm_args), **warm_kw)
    torch.cuda.synchronize()
    warm_errs = {}
    for i, nm in ((0, "x"), (2, "y_d"), (3, "y_b")):
        warm_errs[nm] = assert_as_close_as_plain(
            f"boxqp_solve B={B} warm round {nm}", w_k[i], w_p[i], w_d[i], floor=2e-5)
    d_rounds = (w_k[6] - w_p[6]).abs() / iters
    if not bool((d_rounds <= 1).all()) or float((d_rounds == 0).float().mean()) < 0.90:
        raise AssertionError(
            f"boxqp_solve B={B} warm round: per-lane rounds differ from the "
            f"plain version by up to {float(d_rounds.max())}")
    records[0]["warm_round_err_vs_f64"] = warm_errs
    records[0]["warm_round_max_abs_err"] = float((w_k[0] - w_p[0]).abs().max())
    records[0]["warm_round_ms"] = time_ms(lambda: ak.boxqp_solve(*warm_args, **warm_kw), reps)
    records[0]["earlier_warm_round_ms"] = time_ms(
        lambda: ak.boxqp_solve(*warm_args, **warm_kw, route="thread"), reps)
    del warm_args, w_k, w_p, w_d

    out_k = ak.admm_round(*args, iters=iters, **base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = ak.admm_round_plain(*args, iters=iters, **base)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out_d = ak.admm_round_plain(*as_f64(args), iters=iters, **base)
    e_k, e_p = assert_as_close_as_plain(
        f"admm_round B={B} x", out_k[0], out_p[0], out_d[0])
    assert_as_close_as_plain(f"admm_round B={B} y_d", out_k[2], out_p[2], out_d[2])
    assert_as_close_as_plain(f"admm_round B={B} y_b", out_k[3], out_p[3], out_d[3])
    expect_route("admm_round", "smem")
    k2_info = info("admm_round")
    out_t = ak.admm_round(*args, iters=iters, **base, route="thread")
    torch.cuda.synchronize()
    vs_earlier = dict(
        max_abs_dx=float((out_k[0] - out_t[0]).abs().max()), bit_equal=all_equal(out_k, out_t))
    earlier_ms = time_ms(lambda: ak.admm_round(*args, iters=iters, **base, route="thread"), reps)
    ms = time_ms(lambda: ak.admm_round(*args, iters=iters, **base), reps)
    t_ops = B * ak.round_flops(Kst, nz, nc, iters) / PEAK_FP32_PER_S * 1e3
    t_bytes = ak.io_bytes(Kst, nz, nc, B, False, shared_hjk=True) / PEAK_BYTES_PER_S * 1e3
    records.append(dict(
        name="admm_round", route="cuda",
        source="control_box_rst_tpu_torch/csrc/admm_kernel.cu",
        replaces="control_box_rst_tpu/ops/pallas/admm_kernel.py:602",
        launches=0, max_abs_err=float((out_k[0] - out_p[0]).abs().max()),
        ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, on_main_path=False, batch=B,
        earlier_ms=earlier_ms, vs_earlier=vs_earlier, launch=k2_info,
        err_vs_f64=e_k, plain_err_vs_f64=e_p,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
    ))
    return records


def random_spd_systems(B, K, nz, device):
    """Well-conditioned random SPD block-tridiagonal systems (the systems of
    the JAX package's own kernel test, batched), made from a seed with numpy."""
    rng = np.random.default_rng(3)
    D = rng.standard_normal((B, K, nz, nz), dtype=np.float32)
    D = D @ D.transpose(0, 1, 3, 2) + 10 * np.eye(nz, dtype=np.float32)
    O = 0.3 * rng.standard_normal((B, K - 1, nz, nz), dtype=np.float32)
    b = rng.standard_normal((B, K, nz), dtype=np.float32)
    return [torch.as_tensor(a, device=device) for a in (D, O, b)]


def lm_systems(ocp, cfg, x0s, iterations):
    """The damped Gauss-Newton systems (Dmu, O, g) that the LM solve of the
    config-1 batch hands to the block-tridiagonal kernel at the given
    iterations (0 = the first), each lane with its own mu and weights."""
    from control_box_rst_tpu_torch.ocp.problem import Trajectory
    from control_box_rst_tpu_torch.solvers.lm import LMProblem, freeze_inactive

    o = ocp.replace(bc=ocp.bc.replace(x0=x0s))
    traj0 = o.apply_boundary(
        Trajectory.linear_interp(x0s, o.refs.xref[-1], o.N, o.nu, 0.1))
    prob = LMProblem(o, cfg, x0s.dtype)
    state = prob.init_state(o.pack(traj0))
    out = {}
    for it in range(max(iterations) + 1):
        if it in iterations:
            Dmu, _, O, g, _ = prob.damped_system(state)
            out[it] = (Dmu, O, g)
        state = freeze_inactive(prob.cond(state), prob.iteration(state), state)
    return out


def dense_library_ms(D, O, b, x_ref, reps):
    """Milliseconds of the one PyTorch call that computes the same function:
    Cholesky factor and solve of the dense [B, K*nz, K*nz] assembly (assembly
    not timed). Tried at the full batch and halved until it fits in memory;
    returns (ms, batch timed). A yardstick only: the port never calls it."""
    K, nz = D.shape[1], D.shape[2]
    n = K * nz
    B = D.shape[0]
    while B >= 1:
        try:
            M = torch.zeros((B, n, n), dtype=D.dtype, device=D.device)
            for k in range(K):
                sl = slice(k * nz, (k + 1) * nz)
                M[:, sl, sl] = D[:B, k]
                if k < K - 1:
                    nx = slice((k + 1) * nz, (k + 2) * nz)
                    M[:, sl, nx] = O[:B, k]
                    M[:, nx, sl] = O[:B, k].transpose(-1, -2)
            rhs = b[:B].reshape(B, n, 1)
            call = lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(M))
            x = call().reshape(B, K, nz)
            err = float((x - x_ref[:B]).abs().max())
            if not err <= 5e-5:
                raise AssertionError(f"dense library solve disagrees with the kernel: {err:.3e}")
            ms = time_ms(call, reps)
            del M, x
            torch.cuda.empty_cache()
            return ms, B
        except torch.cuda.OutOfMemoryError:
            M = x = None
            torch.cuda.empty_cache()
            B //= 2
    raise RuntimeError("the dense library solve fits at no batch size")


def kernels_alone_ms(calls, reps: int):
    """Device milliseconds per launch of the hand-written kernel each call
    launches, by itself: ``calls`` maps label -> (fn, kernel-name tag);
    torch.profiler over ``reps`` calls after a warm-up, the device time of the
    kernels whose name holds the tag over the launches the profiler recorded
    (it may record fewer than were made, and once recorded none: then the
    label gets None, "not measured", and a line says so). A diagnostic, not a
    gate: the wrappers' times come from CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, (fn, tag) in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if tag in e.key]
        launches = sum(e.count for e in events)
        out[label] = sum(e.device_time_total for e in events) / 1e3 / launches if launches else None
        if not launches:
            log(f"{label}: the profiler recorded no launch of {tag}; kernel-alone time not measured")
    return out


def phase_btridiag_kernels(ocp, lm_cfg, x0s_all, reps: int):
    """The block-tridiagonal factor-and-solve kernels against their plain
    version; returns their records (K3 first). The in-place solve takes its
    shared-memory kernel at these shapes; the one-thread-per-lane kernel it
    replaced there is run beside it under its route's name.

    On well-conditioned random SPD systems kernel and float32 plain version
    must agree to atol 5e-6 (the bound of the JAX package's own kernel test).
    LM's own systems J'J + mu I are badly conditioned once the penalty weights
    have grown (x10 per stall), so there the yardstick is the float64 plain
    version: the kernel must be as close to it as the float32 plain version is
    (slack 2x + 1e-5), on the lanes where all three are finite; a system that
    is not positive definite in float32 gives NaN in its lane on either side,
    and the kernel may not lose more lanes to that than the plain version
    (+5 % of its count, +0.1 % of the batch: a pivot at the rounding level
    falls on either side of zero).
    """
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk

    B, K, nz = x0s_all.shape[0], ocp.N + 1, ocp.nz
    dev = x0s_all.device
    solve = {
        "btridiag_factor_solve": lambda D, O, b: bk.btridiag_factor_solve(D, O, b, inplace=False),
        "btridiag_factor_solve_inplace": lambda D, O, b: bk.btridiag_factor_solve(D, O, b, inplace=True),
    }
    errs = {}

    # ---- (i) random SPD systems, full batch ----
    D, O, b = random_spd_systems(B, K, nz, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_plain = bk.btridiag_factor_solve_plain(D, O, b)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    x_kern, max_err = {}, {}
    for name, fn in solve.items():
        x_kern[name] = fn(D, O, b)
        torch.cuda.synchronize()
        max_err[name] = assert_close(f"{name} random SPD", x_kern[name], x_plain, rtol=0.0, atol=5e-6)
    # ---- (iv) the two kernels against each other ----
    d34 = float((x_kern["btridiag_factor_solve"] - x_kern["btridiag_factor_solve_inplace"]).abs().max())
    if not d34 <= 1e-6:
        raise AssertionError(f"the two block-tridiagonal kernels differ by {d34:.3e} > 1e-6")
    errs["random/k3_vs_k4"] = d34
    errs["random/k3_bit_equal_k4"] = torch.equal(
        x_kern["btridiag_factor_solve"], x_kern["btridiag_factor_solve_inplace"])
    name3, name4 = "btridiag_factor_solve", "btridiag_factor_solve_inplace"
    k3_info = dict(bk.LAUNCH_INFO[name3])
    if k3_info.get("route") != "scratch":
        raise AssertionError(f"{name3}: expected K3's scratch kernel, took {k3_info}")
    k4_info = dict(bk.LAUNCH_INFO[name4])
    if k4_info.get("route") != "smem" or bk.solve_route(K, nz) != "smem":
        raise AssertionError(f"{name4}: expected the shared-memory route, took {k4_info}")
    # ---- the shared-memory kernel against the one it replaced on this path ----
    x_thread = bk.btridiag_factor_solve(D, O, b, route="thread")
    torch.cuda.synchronize()
    if bk.LAUNCH_INFO[name4].get("route") != "thread":
        raise AssertionError(f"{name4}: route='thread' took {bk.LAUNCH_INFO[name4]}")
    assert_close(f"{name4} thread route", x_thread, x_plain, rtol=0.0, atol=5e-6)
    vs_earlier = dict(
        max_abs_dx=float((x_kern[name4] - x_thread).abs().max()),
        bit_equal=torch.equal(x_kern[name4], x_thread))
    # ---- (iii) B = 1 (the other layout instance) and a ragged last tile ----
    by_route = dict(solve)
    by_route[f"{name4}_thread"] = lambda D, O, b: bk.btridiag_factor_solve(D, O, b, route="thread")
    x_kern[f"{name4}_thread"] = x_thread
    for n in (1, 8, 1000):
        for name, fn in by_route.items():
            x_n = fn(D[:n], O[:n], b[:n])
            torch.cuda.synchronize()
            if not torch.equal(x_n, x_kern[name][:n]):
                if name == name3:  # one code path for a lane, whatever the batch
                    raise AssertionError(f"{name3}: B={n} disagrees with the first lanes")
                errs[f"random/{name}_B{n}"] = assert_close(
                    f"{name} B={n}", x_n, x_plain[:n], rtol=0.0, atol=5e-6)
        if n < 32 and bk.LAUNCH_INFO[name4] != dict(route="thread", lane_tile=1):
            raise AssertionError(f"{name4} B={n} thread route took {bk.LAUNCH_INFO[name4]}")
    del x_thread, x_kern[f"{name4}_thread"]
    # D and O broadcast over the batch (stride 0) are taken as they are
    De, Oe = D[0].expand(D[:64].shape), O[0].expand(O[:64].shape)
    x_want = bk.btridiag_factor_solve_plain(De, Oe, b[:64])
    for name, fn in solve.items():
        x_b = fn(De, Oe, b[:64])
        torch.cuda.synchronize()
        errs[f"random/{name}_broadcast_DO"] = assert_close(
            f"{name} broadcast D/O", x_b, x_want, rtol=0.0, atol=5e-6)
    # the caller's D and O are not written by any kernel
    D_before, O_before = D[:64].clone(), O[:64].clone()
    for label, fn in [(f"{name4} route {r}", lambda D, O, b, r=r: bk.btridiag_factor_solve(
            D, O, b, route=r)) for r in bk.ROUTES] + [(name3, solve[name3])]:
        fn(D[:64], O[:64], b[:64])
        torch.cuda.synchronize()
        if not torch.equal(D[:64], D_before) or not torch.equal(O[:64], O_before):
            raise AssertionError(f"{label} wrote to the caller's D or O")
    # lanes a stride apart (every other lane of the batch), taken as they are
    for name, fn in solve.items():
        x_s = fn(D[:128:2], O[:128:2], b[:128:2])
        torch.cuda.synchronize()
        if not torch.equal(x_s, x_kern[name][:128:2]):
            raise AssertionError(f"{name}: strided lanes disagree with the same lanes of the batch")
    # ---- a long horizon: K4's shape rule picks its one-thread-per-lane
    # kernel, K3 has one kernel for every shape ----
    if bk.solve_route(LONG_KST, nz) != "thread":
        raise AssertionError(f"the shape rule keeps K={LONG_KST} in shared memory")
    Dl, Ol, bl = random_spd_systems(LONG_BATCH, LONG_KST, nz, dev)
    x_lp = bk.btridiag_factor_solve_plain(Dl, Ol, bl)
    for name, fn in solve.items():
        x_l = fn(Dl, Ol, bl)
        torch.cuda.synchronize()
        want_route = "thread" if name == name4 else "scratch"
        if bk.LAUNCH_INFO[name].get("route") != want_route:
            raise AssertionError(f"{name} K={LONG_KST}: took {bk.LAUNCH_INFO[name]}")
        errs[f"random/{name}_K{LONG_KST}"] = assert_close(
            f"{name} K={LONG_KST}", x_l, x_lp, rtol=0.0, atol=5e-6)
    del Dl, Ol, bl, x_l, x_lp

    # ---- times, bounds, library yardstick (random systems, full batch) ----
    ms = {name: time_ms(lambda fn=fn: fn(D, O, b), reps) for name, fn in solve.items()}
    earlier_ms = time_ms(lambda: bk.btridiag_factor_solve(D, O, b, route="thread"), reps)
    for name, fn in solve.items():
        ms[name] = min(ms[name], time_ms(lambda fn=fn: fn(D, O, b), reps))
    earlier_ms = min(earlier_ms, time_ms(
        lambda: bk.btridiag_factor_solve(D, O, b, route="thread"), reps))
    tags = {name3: "btridiag_factor_solve_scratch_kernel",
            name4: "btridiag_factor_solve_smem_kernel"}
    alone = kernels_alone_ms({name: (lambda fn=fn: fn(D, O, b), tags[name])
                              for name, fn in solve.items()}, reps)
    lib_ms, lib_B = dense_library_ms(D, O, b, x_kern["btridiag_factor_solve_inplace"], 2)
    t_bytes = bk.io_bytes(K, nz, B) / PEAK_BYTES_PER_S * 1e3
    t_ops = B * bk.factor_solve_flops(K, nz) / PEAK_FP32_PER_S * 1e3
    del D, O, b, x_plain, x_kern

    # ---- (ii) LM's own systems on the config-1 batch ----
    systems = lm_systems(ocp, lm_cfg, x0s_all, (0, LM_LATE_ITERATION))
    lm_errs = {name: {} for name in solve}
    lm_ms = {name: {} for name in solve}
    for it, (Dmu, O, g) in systems.items():
        x_p = bk.btridiag_factor_solve_plain(Dmu, O, g)
        x_d = bk.btridiag_factor_solve_plain(Dmu.double(), O.double(), g.double())
        fin = lambda x: torch.isfinite(x).all(dim=2).all(dim=1)
        for name, fn in solve.items():
            x_k = fn(Dmu, O, g)
            torch.cuda.synchronize()
            lost_k, lost_p = int((~fin(x_k)).sum()), int((~fin(x_p)).sum())
            if lost_k > 1.05 * lost_p + B // 1000:
                raise AssertionError(
                    f"{name} LM iteration {it}: {lost_k} non-finite lanes, the plain version {lost_p}")
            ok = fin(x_k) & fin(x_p) & fin(x_d)
            e_k, e_p = assert_as_close_as_plain(
                f"{name} LM iteration {it}", x_k[ok], x_p[ok], x_d[ok])
            lm_errs[name][f"it{it}"] = dict(
                err_vs_f64=e_k, plain_err_vs_f64=e_p, x_max=float(x_d[ok].abs().max()),
                nonfinite_lanes=lost_k, plain_nonfinite_lanes=lost_p)
            # times on LM's own systems (a third of the lanes NaN late in a solve)
            lm_ms[name][f"it{it}"] = dict(
                ms=time_ms(lambda fn=fn: fn(Dmu, O, g), reps),
                alone_ms=kernels_alone_ms({name: (lambda fn=fn: fn(Dmu, O, g), tags[name])},
                                          reps)[name])
    # K3's own traffic floor (two sweeps): inputs and x once, the scratch
    # written once and read back once
    design_floor_ms = B * (bk.io_bytes(K, nz, 1) + 2 * bk.scratch_bytes_per_lane(K, nz)) \
        / PEAK_BYTES_PER_S * 1e3
    log(f"btridiag kernels[{B} lanes]: " + json.dumps(
        {**errs, "k3_design_floor_ms": design_floor_ms, "lm_systems": lm_errs}))

    replaces = {
        "btridiag_factor_solve": "control_box_rst_tpu/ops/pallas/btridiag_kernel.py:194",
        "btridiag_factor_solve_inplace": "control_box_rst_tpu/ops/pallas/btridiag_kernel_v2.py:147",
    }
    records = [dict(
        name=name, route="cuda",
        source="control_box_rst_tpu_torch/csrc/btridiag_kernel.cu",
        replaces=replaces[name], launches=0, max_abs_err=max_err[name],
        ms=ms[name], alone_ms=alone[name], plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_ms, library_batch=lib_B, on_main_path=True, batch=B,
        earlier_ms=None, launch=k3_info,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        k3_vs_k4=d34, lm_systems=lm_errs[name], lm_systems_ms=lm_ms[name],
    ) for name in solve]
    records[1].update(earlier_ms=earlier_ms, vs_earlier=vs_earlier, launch=k4_info)
    return records


def nonlinear_problems():
    """Configs 2 and 3 as the nonlinear phases take them: name -> (ocp, cfg,
    initial dt of the straight-line guess, initial states [NL_BATCH, 2]
    float32). Config 2 x0 ~ U(-1.5, 1.5)^2 from seed 1, config 3 x0 = [d, 0]
    with d ~ U(0.5, 2) from seed 2 (the reference's bench rows)."""
    from control_box_rst_tpu_torch.entry import time_optimal, vdp_ms

    x0_vdp = np.random.default_rng(1).uniform(-1.5, 1.5, (NL_BATCH, 2)).astype(np.float32)
    d = np.random.default_rng(2).uniform(0.5, 2.0, (NL_BATCH,)).astype(np.float32)
    x0_to = np.stack([d, np.zeros_like(d)], axis=1)
    return {
        "vdp_ms": (*vdp_ms(N=20), 0.1, x0_vdp),
        "time_optimal": (*time_optimal(N=20), 0.12, x0_to),
    }


def first_iteration_qps(ocp, cfg, dt_init, x0s):
    """The box QPs that the outer SQP loop hands the kernel's wrapper in its
    first iteration, for every lane of ``x0s``, and the wrapper's keyword
    arguments: caught at the wrapper during a solve of one SQP iteration
    through ``make_batched_solver``."""
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    caught, real = [], ak.boxqp_solve

    def catch(*args, **kw):
        caught.append((args, kw))
        return real(*args, **kw)

    ak.boxqp_solve = catch
    try:
        make_batched_solver(ocp, cfg.replace(max_iter=1), dt_init=dt_init,
                            device=x0s.device)(x0s)
    finally:
        ak.boxqp_solve = real
    if len(caught) != 1:
        raise AssertionError(f"one SQP iteration made {len(caught)} box-QP calls")
    return list(caught[0][0]), caught[0][1]


def k1_qp_record(name, args, kw, reps: int, shared_hjk: bool = False,
                 rounds_vs_f64: bool = False):
    """K1 against its plain version on QPs with Hd/J/K per lane (or, with
    ``shared_hjk``, one copy broadcast over the batch), production exits.
    Gates: as close to the float64 plain version as the float32 plain
    version (slack 2x + 1e-4), per-lane rounds within one of the plain
    version, B=1 and B=8 give the first lanes' bits through both routes.
    With ``rounds_vs_f64`` (QPs whose exit tolerance is at float32's floor,
    where the float32 plain version's own rounds part from the float64
    one's by more than one) the rounds are held to the float64 plain
    version instead: the kernel's largest per-lane distance from its rounds
    no more than the float32 plain version's + 1, the mean distance no more
    than twice its + 0.05. Returns the record of these shapes."""
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

    B, Kst, nz = args[0].shape[:3]
    nc, iters = args[1].shape[2], kw["iters"]
    if ak._lane_invariant(*args[:3]) != shared_hjk:
        raise AssertionError(f"{name}: Hd/J/K reached the kernel "
                             f"{'per lane' if shared_hjk else 'as one shared copy'}")
    out_k = ak.boxqp_solve(*args, **kw)
    torch.cuda.synchronize()
    launch = dict(ak.LAUNCH_INFO["boxqp_solve"])
    if launch.get("route") != "smem" or bool(launch.get("shared_hjk")) != shared_hjk:
        raise AssertionError(f"{name}: expected the shared-memory route, shared Hd/J/K "
                             f"{shared_hjk}, took {launch}")
    t0 = time.perf_counter()
    out_p = ak.boxqp_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out_d = ak.boxqp_solve_plain(*as_f64(args), **kw)
    errs = {}
    for i, nm in ((0, "x"), (2, "y_d"), (3, "y_b")):
        errs[nm] = assert_as_close_as_plain(
            f"boxqp_solve {name} B={B} {nm}", out_k[i], out_p[i], out_d[i], floor=1e-4)
    d_rounds = (out_k[6] - out_p[6]).abs() / iters
    rounds_rec = {}
    if rounds_vs_f64:
        k_d = (out_k[6] - out_d[6]).abs() / iters
        p_d = (out_p[6] - out_d[6]).abs() / iters
        rounds_rec = dict(rounds_vs_f64_max=float(k_d.max()), plain_rounds_vs_f64_max=float(p_d.max()),
                          rounds_vs_f64_mean=float(k_d.mean()),
                          plain_rounds_vs_f64_mean=float(p_d.mean()),
                          f64_mean_rounds=float((out_d[6] / iters).mean()),
                          plain_mean_rounds=float((out_p[6] / iters).mean()))
        if not (float(k_d.max()) <= float(p_d.max()) + 1
                and float(k_d.mean()) <= 2 * float(p_d.mean()) + 0.05):
            raise AssertionError(f"boxqp_solve {name}: rounds against the float64 plain "
                                 f"version's {json.dumps(rounds_rec)}")
    elif not bool((d_rounds <= 1).all()):
        raise AssertionError(
            f"boxqp_solve {name}: per-lane rounds differ from the plain version by up "
            f"to {float(d_rounds.max())}")
    # the one-thread-per-lane kernels on the same QPs, and B = 1, 8 through
    # both routes: the first lanes' bits
    out_t = ak.boxqp_solve(*args, **kw, route="thread")
    torch.cuda.synchronize()
    e_t, _ = assert_as_close_as_plain(
        f"boxqp_solve {name} thread route x", out_t[0], out_p[0], out_d[0], floor=1e-4)
    for route, full in (("smem", out_k), ("thread", out_t)):
        for n in (1, 8):
            out_n = ak.boxqp_solve(*[a[:n] for a in args], **kw, route=route)
            torch.cuda.synchronize()
            if not all_equal(out_n, [o[:n] for o in full]):
                raise AssertionError(
                    f"boxqp_solve {name} route {route}: B={n} disagrees with the first lanes")
    call = lambda: ak.boxqp_solve(*args, **kw)
    ms = min(time_ms(call, reps), time_ms(call, reps))
    alone = kernels_alone_ms({name: (call, "boxqp_solve_smem_kernel")}, reps)[name]
    rounds = float((out_k[6] / iters).sum())  # rounds this run's data needed
    t_ops = rounds * ak.solve_flops_per_round(Kst, nz, nc, iters, False) / PEAK_FP32_PER_S * 1e3
    t_bytes = ak.io_bytes(Kst, nz, nc, B, True, shared_hjk=shared_hjk) / PEAK_BYTES_PER_S * 1e3
    return dict(
        Kst=Kst, nz=nz, nc=nc, batch=B, per_lane_hjk=not shared_hjk, n_rounds=kw["n_rounds"],
        iters=iters, ms=ms, alone_ms=alone, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        max_abs_err=float((out_k[0] - out_p[0]).abs().max()),
        err_vs_f64={k: v[0] for k, v in errs.items()},
        plain_err_vs_f64={k: v[1] for k, v in errs.items()},
        thread_route_err_vs_f64=e_t,
        same_it_frac=float((d_rounds == 0).float().mean()),
        mean_rounds=rounds / B, launch=launch, **rounds_rec,
    )


def phase_nonlinear_kernels(problems, reps: int):
    """K1 against its plain version at the shapes of the nonlinear paths: the
    QPs of config 2's and config 3's first outer SQP iteration at B=4096
    (Kst=21, nc=2 and 3, Hd/J/K per lane), production exits (two rounds, no
    KKT exit), held as ``k1_qp_record`` holds them. Returns name -> the
    record of these shapes."""
    out = {}
    for name, (ocp, cfg, dt0, x0s_np) in problems.items():
        args, kw = first_iteration_qps(ocp, cfg, dt0, torch.as_tensor(x0s_np, device="cuda"))
        out[name] = k1_qp_record(name, args, kw, reps)
        del args
    log("kernels[nonlinear shapes]: " + json.dumps(out))
    return out


def phase_nonlinear(problems, trials: int, n_single: int):
    """The batched SQP solves of configs 2 and 3 at B=4096 through
    ``make_batched_solver``, every QP of every SQP iteration through K1.
    Gates: converged fraction >= 0.99; K1 launched once per lock-step SQP
    iteration (launches == the largest iteration count, > 0); config 2 max
    |U - U_oracle| <= 1e-3 on the 48 lanes of the float64 oracle golden file;
    config 3 max |T - 2 sqrt(d)| <= 1e-3 over every lane (T = the objective,
    the sum of the dt_k). Returns (launches, records, solvers) by config."""
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    launches, recs, solvers = {}, {}, {}
    for name, (ocp, cfg, dt0, x0s_np) in problems.items():
        solver = make_batched_solver(ocp, cfg, dt_init=dt0)  # device=None: the card
        solvers[name] = solver
        B = x0s_np.shape[0]
        x0s = torch.as_tensor(x0s_np, device="cuda")
        solver(x0s[:256])  # warm-up
        torch.cuda.synchronize()

        torch.cuda.reset_peak_memory_stats()
        ak.reset_launch_counts()
        U, obj, status, iters = solver(x0s)
        torch.cuda.synchronize()
        n_launch = ak.LAUNCHES["boxqp_solve"]
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        route = dict(ak.LAUNCH_INFO["boxqp_solve"])

        if U.shape != (B, ocp.N, ocp.nu) or not bool(torch.isfinite(U).all()):
            raise AssertionError(f"{name}: U has shape {tuple(U.shape)} or non-finite values")
        if not bool(torch.isfinite(obj).all()):
            raise AssertionError(f"{name}: non-finite objective")
        lock_step = int(iters.max())
        log(f"{name}: boxqp_solve launched {n_launch} time(s) in {lock_step} lock-step "
            f"SQP iterations, last launch {route}")
        if n_launch <= 0 or n_launch != lock_step:
            raise AssertionError(
                f"{name}: {n_launch} boxqp_solve launches for {lock_step} lock-step SQP iterations")
        if route.get("route") != "smem" or route.get("shared_hjk"):
            raise AssertionError(f"{name}: boxqp_solve took {route}, not per-lane shared memory")
        conv = float((status == 1).float().mean())
        quality = {}
        if name == "vdp_ms":
            gold = np.load(VDP_GOLDEN)
            n_g = gold["U"].shape[0]
            if not np.array_equal(gold["x0s"], x0s_np[:n_g]):
                raise AssertionError("config-2 golden file was made for other initial states")
            err = float(np.max(np.abs(U[:n_g].double().cpu().numpy() - gold["U"])))
            quality = dict(max_u_err_vs_f64_oracle=err, oracle_lanes=n_g)
        else:
            t_star = 2.0 * np.sqrt(x0s_np[:, 0].astype(np.float64))
            err = float(np.max(np.abs(obj.double().cpu().numpy() - t_star)))
            quality = dict(max_tstar_err_vs_analytic=err, lanes=B)
        if conv < CONV_GATE:
            raise AssertionError(f"{name}: converged_frac {conv:.4f} < {CONV_GATE}")
        if not (err <= ERR_GATE):
            raise AssertionError(f"{name}: quality gate {quality} > {ERR_GATE}")

        best = float("inf")
        for _ in range(trials):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver(x0s)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        rec = dict(
            batch=B, solves_per_s=B / best, batch_solve_ms=best * 1e3,
            converged_frac=conv, mean_sqp_iters=float(iters.float().mean()),
            max_sqp_iters=lock_step, boxqp_solve_launches=n_launch,
            kernel_route=route, peak_device_memory_gib=peak_gb, **quality,
        )
        if n_single:
            x0_1 = x0s[:1]
            solver(x0_1)
            torch.cuda.synchronize()
            lats = []
            for _ in range(n_single):
                t0 = time.perf_counter()
                solver(x0_1)
                torch.cuda.synchronize()
                lats.append(time.perf_counter() - t0)
            rec.update(
                p50_single_solve_ms=float(np.percentile(np.asarray(lats), 50) * 1e3),
                p99_single_solve_ms=float(np.percentile(np.asarray(lats), 99) * 1e3),
                single_solves=n_single,
            )
        recs[name] = rec
        launches[name] = n_launch
    return launches, recs, solvers


def nonuniform_x0s():
    """Config 4's initial states x0 = [d, 0], d ~ U(0.5, 2) from
    ``default_rng(4)``, float32 [NU_BATCH, 2]."""
    d = np.random.default_rng(4).uniform(0.5, 2.0, (NU_BATCH,)).astype(np.float32)
    return np.stack([d, np.zeros_like(d)], axis=1)


def nonuniform_open_loop_solver(ocp, cfg):
    """Config 4's batched open-loop solve: ``sqp_solve`` on a batch of
    initial states from the straight line with dt = 0.1 (the golden test's
    guess), the QP backend resolved for float32 on the card. Returns fn
    x0s [B, 2] -> SQPResult (the plan's dts with it: T is their sum)."""
    from control_box_rst_tpu_torch.ocp.problem import Trajectory
    from control_box_rst_tpu_torch.solvers.sqp import resolve_qp_backend, sqp_solve

    cfg = resolve_qp_backend(cfg, ocp.ng, "cuda", torch.float32)

    def solve(x0s):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0s))
        return sqp_solve(o, Trajectory.linear_interp(x0s, ocp.bc.xf, ocp.N, ocp.nu, 0.1), cfg)

    return solve


def phase_nonuniform_open_loop(x0s_np, trials: int, n_single: int):
    """Config 4 open loop (``entry.nonuniform_ms_timeopt``, N=10, Kst=11) at
    B=4096 through K1 with Hd/J/K per lane. Gates: converged fraction >=
    0.99; max |T - 2 sqrt(d)| <= 1e-3 over every lane (T = the sum of the
    dt_k); K1 launched once per lock-step SQP iteration (launches == the
    largest iteration count > 0). Returns (launches, record, solver)."""
    from control_box_rst_tpu_torch.entry import nonuniform_ms_timeopt
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

    ocp, cfg = nonuniform_ms_timeopt()  # device=None: the card
    solve = nonuniform_open_loop_solver(ocp, cfg)
    B = x0s_np.shape[0]
    x0s = torch.as_tensor(x0s_np, device="cuda")
    solve(x0s[:256])  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ak.reset_launch_counts()
    res = solve(x0s)
    torch.cuda.synchronize()
    n_launch = ak.LAUNCHES["boxqp_solve"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    route = dict(ak.LAUNCH_INFO["boxqp_solve"])
    dts = res.traj.dts
    if dts.shape != (B, ocp.N) or not bool(torch.isfinite(res.W).all()):
        raise AssertionError(f"config 4: dts have shape {tuple(dts.shape)} or W is not finite")
    lock_step = int(res.iterations.max())
    log(f"config 4: boxqp_solve launched {n_launch} time(s) in {lock_step} lock-step SQP "
        f"iterations, last launch {route}")
    if n_launch <= 0 or n_launch != lock_step:
        raise AssertionError(
            f"config 4: {n_launch} boxqp_solve launches for {lock_step} lock-step SQP iterations")
    if route.get("route") != "smem" or route.get("shared_hjk"):
        raise AssertionError(f"config 4: boxqp_solve took {route}, not per-lane shared memory")
    conv = float((res.status == 1).float().mean())
    T = dts.double().sum(dim=1).cpu().numpy()
    t_err = float(np.max(np.abs(T - 2.0 * np.sqrt(x0s_np[:, 0].astype(np.float64)))))
    if conv < CONV_GATE:
        raise AssertionError(f"config 4: converged_frac {conv:.4f} < {CONV_GATE}")
    if not (t_err <= ERR_GATE):
        raise AssertionError(f"config 4: max |T - 2 sqrt(d)| {t_err:.3e} > {ERR_GATE}")

    best = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    solve(x0s[:1])
    lats = []
    for _ in range(n_single):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(x0s[:1])
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
    rec = dict(
        batch=B, solves_per_s=B / best, batch_solve_ms=best * 1e3, converged_frac=conv,
        max_tstar_err_vs_analytic=t_err, mean_sqp_iters=float(res.iterations.float().mean()),
        max_sqp_iters=lock_step, boxqp_solve_launches=n_launch, kernel_route=route,
        peak_device_memory_gib=peak_gb,
        p50_single_solve_ms=float(np.percentile(np.asarray(lats), 50) * 1e3),
        p99_single_solve_ms=float(np.percentile(np.asarray(lats), 99) * 1e3),
        single_solves=n_single,
    )
    return n_launch, rec, solve


def catch_steps_and_boxqp_calls(ak, steps: int, keep_step: int):
    """Patch the controller's step and K1's wrapper to count, per MPC step,
    the K1 calls, those with Hd/J/K per lane and their horizons, and keep
    the arguments of the first call of step ``keep_step``. Returns (record,
    restore)."""
    from control_box_rst_tpu_torch.control import PredictiveController

    rec = dict(step=-1, by_step=[0] * steps, per_lane_hjk_calls=0, kst=set(), kept=None)
    real_step, real_k1 = PredictiveController.step, ak.boxqp_solve

    def step(self, *args, **kw):
        rec["step"] += 1
        return real_step(self, *args, **kw)

    def k1(*args, **kw):
        k = rec["step"]
        rec["by_step"][k] += 1
        rec["per_lane_hjk_calls"] += int(not ak._lane_invariant(*args[:3]))
        rec["kst"].add(int(args[0].shape[1]))
        if k == keep_step and rec["kept"] is None:
            rec["kept"] = (list(args), dict(kw))
        return real_k1(*args, **kw)

    PredictiveController.step, ak.boxqp_solve = step, k1

    def restore():
        PredictiveController.step, ak.boxqp_solve = real_step, real_k1

    return rec, restore


def phase_nonuniform_closed_loop(x0s_np, trials: int):
    """Config 4 under MPC with the RedundantControls adaptation
    (``entry.nonuniform_ms_timeopt_adaptive``: N=15, Kst=16, n_active_init=10,
    no shift) through ``make_batched_closed_loop``: B=4096 rollouts of 25
    steps of 0.1, lane 0 from [1.5, 0] (the golden's), every lane its own
    active horizon, every SQP iteration through K1 with Hd/J/K per lane.
    Gates: K1 launched at every step, once per lock-step SQP iteration, with
    Hd/J/K per lane and Kst=16 on every call; lane 0 meets the golden test's
    contract (n_active[0] >= 8, n_active[10:] <= 5, u[:6] < -0.99, |x_24,pos| <
    2e-2); the usable-step fraction of the first 64 rollouts is no lower than
    the JAX package's own float32 run of them. Returns (launches, record, the
    QPs of step NU_CHECK_STEP, what ``phase_nonuniform_vs_plain`` takes)."""
    from control_box_rst_tpu_torch.entry import nonuniform_ms_timeopt_adaptive
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_closed_loop

    ctrl, plant, T, dt = nonuniform_ms_timeopt_adaptive()  # device=None: the card
    N = ctrl.ocp.N
    x0s_np = x0s_np.copy()
    x0s_np[0] = [1.5, 0.0]
    B = x0s_np.shape[0]
    x0s = torch.as_tensor(x0s_np, device="cuda")
    if ctrl.sqp_cfg.qp.backend != "fused" or ctrl.hoisted != (None, None, None):
        raise AssertionError("config 4 closed loop: expected the fused backend and nothing hoisted")
    roll = make_batched_closed_loop(ctrl, plant, T, dt)

    torch.cuda.reset_peak_memory_stats()
    calls, restore = catch_steps_and_boxqp_calls(ak, T, NU_CHECK_STEP)
    ak.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        res = roll(x0s)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        n_launch = ak.LAUNCHES["boxqp_solve"]
    finally:
        restore()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    route = dict(ak.LAUNCH_INFO["boxqp_solve"])
    u, ok, n_act = res.u, res.ok, res.info["n_active"]
    if u.shape != (B, T, 1) or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"config 4 closed loop: u has shape {tuple(u.shape)} or non-finite values")
    if n_act.shape != (B, T) or not bool(((n_act >= 2) & (n_act <= N)).all()):
        raise AssertionError("config 4 closed loop: n_active out of [n_min, N]")
    lock_step = res.info["sqp_iters"].amax(dim=0).tolist()  # [T]
    log(f"config 4 closed loop: boxqp_solve launched {n_launch} time(s), by step "
        f"{calls['by_step']}, lock-step SQP iterations {lock_step}, last launch {route}")
    if n_launch != sum(calls["by_step"]) or calls["by_step"] != lock_step \
            or min(calls["by_step"]) <= 0:
        raise AssertionError(
            f"config 4 closed loop: boxqp_solve launches by step {calls['by_step']}, "
            f"lock-step SQP iterations {lock_step}")
    if calls["per_lane_hjk_calls"] != n_launch or calls["kst"] != {N + 1} \
            or route.get("route") != "smem" or route.get("shared_hjk"):
        raise AssertionError(
            f"config 4 closed loop: {calls['per_lane_hjk_calls']} of {n_launch} calls with "
            f"per-lane Hd/J/K, horizons {calls['kst']}, last {route}")
    n0, u0, x0_24 = n_act[0].tolist(), u[0, :, 0].tolist(), float(res.x_true[0, 24, 0])
    contract = dict(n_active_0=n0[0] >= 8, n_active_10_on=max(n0[10:]) <= 5,
                    bang_braking=max(u0[:6]) < -0.99, arrival=abs(x0_24) < 2e-2)
    log(f"config 4 closed loop lane 0: n_active {n0}, u[:6] {u0[:6]}, x_24,pos {x0_24:.4e}")
    if not all(contract.values()):
        raise AssertionError(f"config 4 closed loop: lane 0 misses the golden contract {contract}")
    usable = float(ok.float().mean())
    usable_ref_lanes = float(ok[:NU_REF_LANES].float().mean())
    if usable_ref_lanes < NU_REF_USABLE:
        raise AssertionError(
            f"config 4 closed loop: usable-step fraction of the first {NU_REF_LANES} rollouts "
            f"{usable_ref_lanes:.4f} < the reference's float32 {NU_REF_USABLE}")
    # step NU_CHECK_STEP's QPs: lanes of different horizons in one launch,
    # and an inactive interval reached the kernel as an identity chain
    args = calls["kept"][0]
    n_k = n_act[:, NU_CHECK_STEP].to(torch.int64)
    J_first_inactive = torch.take_along_dim(
        args[1], n_k.clamp(max=N - 1)[:, None, None, None], dim=1)[:, 0, :, :2]
    chain = (J_first_inactive == -torch.eye(2, device="cuda")).all(dim=(1, 2)) | (n_k == N)
    if len(set(n_k.tolist())) < 2 or not bool(chain.all()):
        raise AssertionError(
            f"config 4 closed loop: step {NU_CHECK_STEP} horizons {sorted(set(n_k.tolist()))}, "
            f"identity-chain rows on {int(chain.sum())} of {B} lanes")

    best = first_s
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        roll(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)

    # one controller step at B = 1, over the T steps of lane 0's rollout
    def single_rollout():
        x = x0s[:1]
        carry = ctrl.init_carry(x)
        lats = []
        for k in range(T):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, out = ctrl.step(carry, x, k * dt, dt)
            torch.cuda.synchronize()
            lats.append(time.perf_counter() - t0)
            x = plant.step(x, torch.where(out.ok[:, None], out.u, torch.zeros_like(out.u)), dt)
        return np.asarray(lats)

    lats = single_rollout()

    hist = [torch.bincount(n_act[:, k].to(torch.int64), minlength=N + 1).tolist() for k in range(T)]
    rec = dict(
        batch=B, t_steps=T, dt=dt, n_grid=N, rollouts_per_s=B / best, mpc_steps_per_s=B * T / best,
        rollout_batch_ms=best * 1e3, first_rollout_batch_ms=first_s * 1e3,
        usable_step_frac=usable, usable_step_frac_first_lanes=usable_ref_lanes,
        reference_usable_step_frac_first_lanes=NU_REF_USABLE, reference_lanes=NU_REF_LANES,
        boxqp_solve_launches=n_launch, boxqp_solve_launches_by_step=calls["by_step"],
        mean_sqp_iters_per_lane_step=float(res.info["sqp_iters"].float().mean()),
        n_active_hist_by_step=hist, lane0=dict(n_active=n0, u_first6=u0[:6], x24_pos=x0_24),
        mean_abs_final_pos=float(res.x_true[:, -1, 0].abs().mean()),
        kernel_route=route, peak_device_memory_gib=peak_gb,
        p50_single_step_ms=float(np.percentile(lats, 50) * 1e3),
        p99_single_step_ms=float(np.percentile(lats, 99) * 1e3), single_steps=T,
    )
    return n_launch, rec, calls["kept"], (ctrl, plant, x0s, u, n_act)


def phase_nonuniform_vs_plain(ctrl, plant, x0s, u, n_act):
    """The batch of ``phase_nonuniform_closed_loop`` through ``backend='plain'``
    for its first NU_PLAIN_STEPS steps (no kernel: ~1 s of eager launches per
    SQP iteration, 612 s for all 25 steps on an H100, 173 s for 10, 75 s for 4, so the
    depth is cut and it runs last): the share of lane-steps on which both
    backends chose the same active horizon, and max |u_fused - u_plain| on
    those, reported."""
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_closed_loop

    T = NU_PLAIN_STEPS
    u, n_act = u[:, :T], n_act[:, :T]
    plain_ctrl = ctrl.replace(cfg=ctrl.cfg.replace(qp=ctrl.cfg.qp.replace(backend="plain")))
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    res_p = make_batched_closed_loop(plain_ctrl, plant, T, 0.1)(x0s)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if ak.LAUNCHES["boxqp_solve"]:
        raise AssertionError("config 4 closed loop: the plain backend launched the box-QP kernel")
    same_n = n_act == res_p.info["n_active"]
    u_dev = float(torch.where(same_n[..., None], (u - res_p.u).abs(), torch.zeros_like(u)).max())
    log(f"config 4 closed loop: n_active equal to the plain backend's on "
        f"{float(same_n.float().mean()):.4f} of lane-steps, max |u_fused - u_plain| there {u_dev:.3e}")
    return dict(t_steps=T, rollout_batch_s=plain_s,
                usable_step_frac=float(res_p.ok.float().mean()),
                same_n_active_frac=float(same_n.float().mean()),
                max_u_dev_on_same_n_active=u_dev)


def phase_nonuniform_kernels(ocp_cfg, x0s_np, kept, reps: int):
    """K1 against its plain version (``k1_qp_record``) on config 4's
    first-iteration QPs (Kst=11, B=4096) and on the QPs of one adaptive
    closed-loop step (Kst=16, lanes of mixed horizons). Returns name -> the
    record of these shapes."""
    ocp, cfg = ocp_cfg
    args, kw = first_iteration_qps(ocp, cfg, 0.1, torch.as_tensor(x0s_np, device="cuda"))
    out = {"nonuniform_ms_timeopt": k1_qp_record("nonuniform_ms_timeopt", args, kw, reps)}
    del args
    out["nonuniform_adaptive_step"] = dict(
        k1_qp_record("nonuniform_adaptive_step", *kept, reps), step=NU_CHECK_STEP)
    log("kernels[config 4 shapes]: " + json.dumps(out))
    return out


def phase_main(ocp, cfg, x0s_np, trials: int, reps: int):
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    solver = make_batched_solver(ocp, cfg, dt_init=0.1)  # device=None: the card
    B = x0s_np.shape[0]
    x0s = torch.as_tensor(x0s_np, device="cuda")
    solver(x0s[:256])  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ak.reset_launch_counts()
    U, obj, status, iters = solver(x0s)
    torch.cuda.synchronize()
    launches = dict(ak.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    if U.shape != (B, ocp.N, ocp.nu) or not bool(torch.isfinite(U).all()):
        raise AssertionError(f"main path: U has shape {tuple(U.shape)} or non-finite values")
    if not bool(torch.isfinite(obj).all()):
        raise AssertionError("main path: non-finite objective")
    conv = float((status == 1).float().mean())
    gold = np.load(GOLDEN)
    n_g = gold["U"].shape[0]
    if not np.array_equal(gold["x0s"], x0s_np[:n_g]):
        raise AssertionError("golden file was made for other initial states")
    u_err = float(np.max(np.abs(U[:n_g].double().cpu().numpy() - gold["U"])))
    if launches["boxqp_solve"] <= 0:
        raise AssertionError("main path did not launch the boxqp_solve kernel")
    route = dict(ak.LAUNCH_INFO["boxqp_solve"])
    log(f"main path: boxqp_solve launched {launches['boxqp_solve']} time(s), last launch {route}")
    if route.get("route") != "smem":
        raise AssertionError(f"main path: boxqp_solve took {route}, not the shared-memory kernel")
    if conv < CONV_GATE:
        raise AssertionError(f"converged_frac {conv:.4f} < {CONV_GATE}")
    if not (u_err <= ERR_GATE):
        raise AssertionError(f"max |U - U_oracle| {u_err:.3e} > {ERR_GATE}")

    best = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            solver(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)

    x0_1 = x0s[:1]
    solver(x0_1)
    torch.cuda.synchronize()
    lats = []
    for _ in range(50):
        t0 = time.perf_counter()
        solver(x0_1)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)

    return launches, U.cpu(), dict(
        batch=B, solves_per_s=B * reps / best, batch_solve_ms=best / reps * 1e3,
        converged_frac=conv, max_u_err_vs_f64_oracle=u_err,
        mean_sqp_iters=float(iters.float().mean()),
        max_sqp_iters=int(iters.max()),
        launches=launches, kernel_route=route["route"], peak_device_memory_gib=peak_gb,
        p99_single_solve_ms=float(np.percentile(np.asarray(lats), 99) * 1e3),
        p50_single_solve_ms=float(np.percentile(np.asarray(lats), 50) * 1e3),
    )


def traced(run):
    """``run()`` under torch.profiler (CPU and CUDA), the card idle before
    it. A CUDA graph's replay runs no Python, so K1's wrapper does not see
    its launches; the device trace does. Returns (the result, K1's launches
    in the trace by kernel name, the port's counters of the session)."""
    from torch.profiler import ProfilerActivity, profile

    from control_box_rst_tpu_torch.utils.profiling import last_record

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    k1 = {}
    for e in prof.events():
        if e.device_type == cuda and not getattr(e, "is_user_annotation", False) \
                and "boxqp_solve" in e.name:
            name = e.name.split("(")[0][:60]
            k1[name] = k1.get(name, 0) + 1
    return out, k1, last_record().counters()


def catch_boxqp_calls(ak, keep_call: int = -1):
    """Patch K1's wrapper to record, per call, whether it is a one-shot solve
    (the in-kernel KKT exit on: ``tol_stat`` > 0) and whether Hd/J/K reached
    it as one shared copy; the arguments of the one-shot call number
    ``keep_call`` are kept. Returns (record, restore)."""
    rec = dict(one_shot=0, outer=0, per_lane_hjk_calls=0, kept=None)
    real = ak.boxqp_solve

    def catch(*args, **kw):
        one_shot = kw.get("tol_stat", 0.0) > 0.0
        if one_shot and rec["one_shot"] == keep_call:
            rec["kept"] = (list(args), dict(kw))
        rec["one_shot" if one_shot else "outer"] += 1
        rec["per_lane_hjk_calls"] += int(not ak._lane_invariant(*args[:3]))
        return real(*args, **kw)

    ak.boxqp_solve = catch

    def restore():
        ak.boxqp_solve = real

    return rec, restore


def closed_loop_step_kernel(args, kw, reps: int):
    """K1 against its plain version on the warm-started one-shot QPs of one
    MPC step of the rollout batch (shifted W, nonzero warm duals, shared
    Hd/J/K, production exits): as close to the float64 plain version as the
    float32 plain version (slack 2x + 1e-4, as on the nonlinear paths' QPs),
    per-lane rounds within one of the plain version. Returns the record of
    this shape."""
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

    B, Kst, nz = args[3].shape
    nc, iters = args[1].shape[-2], kw["iters"]
    if not ak._lane_invariant(*args[:3]):
        raise AssertionError("closed loop: Hd/J/K reached the kernel per lane")
    if not float(args[10].abs().max()) > 0.0:
        raise AssertionError("closed loop: the one-shot QP was not warm-started from nonzero duals")
    out_k = ak.boxqp_solve(*args, **kw)
    torch.cuda.synchronize()
    launch = dict(ak.LAUNCH_INFO["boxqp_solve"])
    if launch.get("route") != "smem" or not launch.get("shared_hjk"):
        raise AssertionError(f"closed loop step QPs: expected shared memory, shared Hd/J/K, took {launch}")
    t0 = time.perf_counter()
    out_p = ak.boxqp_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out_d = ak.boxqp_solve_plain(*as_f64(args), **kw)
    errs = {}
    for i, nm in ((0, "x"), (2, "y_d"), (3, "y_b")):
        errs[nm] = assert_as_close_as_plain(
            f"boxqp_solve closed-loop step {CL_CHECK_STEP} {nm}", out_k[i], out_p[i], out_d[i],
            floor=1e-4)
    d_rounds = (out_k[6] - out_p[6]).abs() / iters
    if not bool((d_rounds <= 1).all()):
        raise AssertionError(
            f"boxqp_solve closed-loop step {CL_CHECK_STEP}: per-lane rounds differ from the "
            f"plain version by up to {float(d_rounds.max())}")
    call = lambda: ak.boxqp_solve(*args, **kw)
    ms = min(time_ms(call, reps), time_ms(call, reps))
    alone = kernels_alone_ms({"step": (call, "boxqp_solve_smem_kernel")}, reps)["step"]
    rounds = float((out_k[6] / iters).sum())  # rounds this run's data needed
    t_ops = rounds * ak.solve_flops_per_round(Kst, nz, nc, iters, True) / PEAK_FP32_PER_S * 1e3
    t_bytes = ak.io_bytes(Kst, nz, nc, B, True, shared_hjk=True) / PEAK_BYTES_PER_S * 1e3
    return dict(
        step=CL_CHECK_STEP, Kst=Kst, nz=nz, nc=nc, batch=B, per_lane_hjk=False,
        n_rounds=kw["n_rounds"], iters=iters, ms=ms, alone_ms=alone, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        max_abs_err=float((out_k[0] - out_p[0]).abs().max()),
        err_vs_f64={k: v[0] for k, v in errs.items()},
        plain_err_vs_f64={k: v[1] for k, v in errs.items()},
        same_it_frac=float((d_rounds == 0).float().mean()),
        mean_rounds=rounds / B, max_rounds=float(out_k[6].max()) / iters,
        warm_y_d_max=float(args[10].abs().max()), launch=launch,
    )


def phase_closed_loop(x0s_np, trials: int, reps: int):
    """Config 5: B rollouts of T MPC steps of the config-1 OCP against the
    simulated double integrator through ``make_batched_closed_loop``, which
    replays them from the step graphs (``sim/step_graphs.py``): every
    step's warm-started one-shot QP and every lock-step outer SQP iteration
    through K1 with one shared copy of Hd/J/K. Gates (the reference's,
    ``bench_scaling.py``): usable-step fraction >= 0.99; max |u_fused -
    u_plain| <= 1e-3 on the same batch (plain = ``backend='plain'``, the
    eager loop). In the device trace of the run (``traced``): K1 launches,
    all by its shared-memory kernel, == sum over steps of (1 one-shot + the
    step's lock-step outer iterations, at least the one trip the graphs
    always run) > 0 == the port's ``sqp.lockstep_iters``, T replayed steps.
    Then K1 on the one-shot QPs of step CL_CHECK_STEP of the same graphs
    against its plain version, and the closed loop under the LM controller
    for CL_LM_STEPS steps (K4 once per lock-step LM iteration, finite u).
    Returns (K1 launches, K4 launches, record, record of K1 at the step's
    shape, the rollout function)."""
    from control_box_rst_tpu_torch.control import PredictiveController
    from control_box_rst_tpu_torch.entry import flagship_lm, rollouts
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
    from control_box_rst_tpu_torch.parallel import make_batched_closed_loop
    from control_box_rst_tpu_torch.sim.step_graphs import StepGraphs, graph_engages
    from control_box_rst_tpu_torch.utils.tree import tree_to

    ctrl, plant, T, dt = rollouts(N=50)  # device=None: the card
    plant = tree_to(plant, "cuda", torch.float32)
    B = x0s_np.shape[0]
    x0s = torch.as_tensor(x0s_np, device="cuda")
    roll = make_batched_closed_loop(ctrl, plant, T, dt)
    if ctrl.sqp_cfg.qp.backend != "fused" or ctrl.hoisted.Jm is None or ctrl.hoisted.Jm.dim() != 3:
        raise AssertionError("closed loop: expected the fused backend and one hoisted J/K/Hd")
    if not graph_engages(ctrl, plant, None, "cuda"):
        raise AssertionError("closed loop: config 5 does not take the step graphs")
    roll(x0s)  # warm-up: the step graphs of the batch are captured here
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    res, k1, counters = traced(lambda: roll(x0s))
    n_launch = sum(k1.values())
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    u, ok, sqp_iters = res.u, res.ok, res.info["sqp_iters"]
    if u.shape != (B, T, 1) or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"closed loop: u has shape {tuple(u.shape)} or non-finite values")
    if res.x_true.shape != (B, T + 1, 2) or not bool(torch.isfinite(res.x_true).all()):
        raise AssertionError("closed loop: x_true has the wrong shape or non-finite values")
    lock_step = sqp_iters.amax(dim=0)  # [T]: 1 one-shot + the step's outer iterations
    # the graphs run the one-shot and one loop trip every step, then the
    # trips the loop's test asks for
    want = int(torch.clamp(lock_step, min=2).sum())
    replayed = counters.get("closed_loop.graph_steps", 0)
    log(f"closed loop: the device trace holds {n_launch} box-QP launches {k1} for {T} steps, "
        f"lock-step SQP iterations {lock_step.tolist()}, the port counted "
        f"{counters.get('sqp.lockstep_iters')} and {replayed} replayed steps")
    if n_launch <= 0 or n_launch != want or counters.get("sqp.lockstep_iters") != want \
            or replayed != T or any("boxqp_solve_smem_kernel" not in k for k in k1):
        raise AssertionError(
            f"closed loop: {n_launch} box-QP launches {k1} in the device trace, expected {want} = "
            f"sum over {T} steps of max(lock-step SQP iterations, 2) by the shared-memory kernel; "
            f"counters {counters}")
    usable = float(ok.float().mean())
    if usable < CONV_GATE:
        raise AssertionError(f"closed loop: usable-step fraction {usable:.4f} < {CONV_GATE}")

    # the same batch through the plain backend (no kernel): the reference's
    # fused-vs-XLA gate
    plain_ctrl = ctrl.replace(cfg=ctrl.cfg.replace(qp=ctrl.cfg.qp.replace(backend="plain")))
    roll_plain = make_batched_closed_loop(plain_ctrl, plant, T, dt)
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    res_p = roll_plain(x0s)
    torch.cuda.synchronize()
    plain_rollout_s = time.perf_counter() - t0
    if ak.LAUNCHES["boxqp_solve"]:
        raise AssertionError("closed loop: the plain backend launched the box-QP kernel")
    u_dev = float((u - res_p.u).abs().max())
    lane_dev = (u - res_p.u).abs().amax(dim=(1, 2))
    log(f"closed loop: max |u_fused - u_plain| {u_dev:.3e} (lanes above 1e-4: "
        f"{int((lane_dev > 1e-4).sum())}), plain usable {float(res_p.ok.float().mean()):.4f}")
    if not (u_dev <= ERR_GATE):
        raise AssertionError(f"closed loop: max |u_fused - u_plain| {u_dev:.3e} > {ERR_GATE}")

    # the one-shot QPs of step CL_CHECK_STEP as the step graphs give them to
    # K1: the graphs' inputs after CL_CHECK_STEP replayed steps, through the
    # eager step (the same code)
    graphs = StepGraphs(ctrl, plant, B, dt)
    graphs.run(x0s, CL_CHECK_STEP)
    carry = type(graphs.carry)(*(t.clone() for t in graphs.carry))
    calls, restore = catch_boxqp_calls(ak, keep_call=0)
    try:
        ctrl.step(carry, graphs.x.clone(), CL_CHECK_STEP * dt, dt)
        torch.cuda.synchronize()
    finally:
        restore()
    del graphs, carry
    if calls["per_lane_hjk_calls"] or calls["kept"] is None:
        raise AssertionError(f"closed loop step {CL_CHECK_STEP}: {calls['per_lane_hjk_calls']} "
                             "calls with per-lane Hd/J/K, or no one-shot call")
    step_rec = closed_loop_step_kernel(*calls["kept"], reps)
    del calls

    best = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        roll(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)

    # one controller step at B = 1, over the T steps of one rollout
    def single_rollout():
        x = x0s[:1]
        carry = ctrl.init_carry(x)
        lats = []
        for k in range(T):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, out = ctrl.step(carry, x, k * dt, dt)
            torch.cuda.synchronize()
            lats.append(time.perf_counter() - t0)
            x = plant.step(x, torch.where(out.ok[:, None], out.u, torch.zeros_like(out.u)), dt)
        return np.asarray(lats)

    single_rollout()
    lats = single_rollout()

    # the LM controller (K4 once per lock-step LM iteration)
    lm_ocp, lm_cfg = flagship_lm(N=50)
    lm_ctrl = PredictiveController(nx=2, nu=1, ocp=lm_ocp, dt=dt, solver="lm", lm_cfg=lm_cfg)
    roll_lm = make_batched_closed_loop(lm_ctrl, plant, CL_LM_STEPS, dt)
    roll_lm(x0s[:256])
    torch.cuda.synchronize()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    res_lm = roll_lm(x0s)
    torch.cuda.synchronize()
    lm_s = time.perf_counter() - t0
    lm_launches = dict(bk.LAUNCHES)
    lm_lock = res_lm.info["sqp_iters"].amax(dim=0)
    log(f"closed loop (LM): btridiag_factor_solve_inplace launched "
        f"{lm_launches['btridiag_factor_solve_inplace']} time(s) for lock-step LM iterations "
        f"{lm_lock.tolist()}")
    if lm_launches["btridiag_factor_solve_inplace"] != int(lm_lock.sum()) \
            or lm_launches["btridiag_factor_solve_inplace"] <= 0 or lm_launches["btridiag_factor_solve"]:
        raise AssertionError(f"closed loop (LM): launches {lm_launches}, lock-step {lm_lock.tolist()}")
    if not bool(torch.isfinite(res_lm.u).all()):
        raise AssertionError("closed loop (LM): non-finite u")

    outer = (sqp_iters - 1).float()
    rec = dict(
        batch=B, t_steps=T, dt=dt, rollouts_per_s=B / best, mpc_steps_per_s=B * T / best,
        rollout_batch_ms=best * 1e3, usable_step_frac=usable, max_u_dev_vs_plain=u_dev,
        plain_usable_step_frac=float(res_p.ok.float().mean()), plain_rollout_s=plain_rollout_s,
        boxqp_solve_launches=n_launch, boxqp_solve_launches_by_kernel=k1,
        replayed_steps=replayed, eager_trips=counters.get("closed_loop.eager_trips", 0),
        lock_step_sqp_iters=lock_step.tolist(),
        mean_outer_sqp_iters_per_step=float(outer.mean()),
        max_outer_sqp_iters_per_step=int(outer.max()),
        mean_final_state_norm=float(res.x_true[:, -1].norm(dim=-1).mean()),
        kernel_route=step_rec["launch"], peak_device_memory_gib=peak_gb,
        p50_single_step_ms=float(np.percentile(lats, 50) * 1e3),
        p99_single_step_ms=float(np.percentile(lats, 99) * 1e3), single_steps=T,
        lm=dict(
            t_steps=CL_LM_STEPS, rollout_batch_ms=lm_s * 1e3,
            usable_step_frac=float(res_lm.ok.float().mean()),
            btridiag_factor_solve_inplace_launches=lm_launches["btridiag_factor_solve_inplace"],
            lock_step_lm_iters=lm_lock.tolist(),
            mean_lm_iters=float(res_lm.info["sqp_iters"].float().mean()),
            mean_final_state_norm=float(res_lm.x_true[:, -1].norm(dim=-1).mean()),
        ),
    )
    return n_launch, lm_launches["btridiag_factor_solve_inplace"], rec, step_rec, roll


def phase_closed_loop_graph():
    """Config 5's rollouts (the benchmark's ``rollouts_b4096_t20``: three
    seeds of its initial states, and B = 1 and 1000) through the step
    graphs of ``make_batched_closed_loop`` against the eager loop
    (``run_closed_loop``) on the same controller: ``x_true``, ``u``, ``ok``
    and every ``info`` tensor equal bit for bit. In the device trace of each
    (``traced``), K1 launches = the lock-step SQP iterations: of the eager
    loop, and of the graphs (the one-shot and one loop trip a step, and the
    trips run after them); the port's counters give the replayed steps and
    those trips. ms per batch both ways, untraced (best of CLG_TRIALS).
    Returns the record."""
    from control_box_rst_tpu_torch.entry import rollouts
    from control_box_rst_tpu_torch.sim import run_closed_loop
    from control_box_rst_tpu_torch.sim.step_graphs import StepGraphs, graph_engages
    from control_box_rst_tpu_torch.utils.tree import tree_to
    from perfbench import spec
    from perfbench.generator import InitialStates

    ctrl, plant, T, dt = rollouts(N=50)  # device=None: the card
    plant = tree_to(plant, "cuda", torch.float32)
    if not graph_engages(ctrl, plant, None, "cuda"):
        raise AssertionError("closed loop graph: config 5 does not take the step graphs")
    traffic = spec.load_json(ROOT / "perfbench" / "traffic" / "rollouts_b4096_t20.json")
    B = traffic["batch"]
    cases = [(f"seed{seed}", InitialStates(traffic, seed, stream=0).draw(B)) for seed in CLG_SEEDS]
    cases += [(f"B{b}", InitialStates(traffic, CLG_SEEDS[0], stream=3).draw(b)) for b in (1, 1000)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rec = {}
    for name, x0 in cases:
        x0 = x0.to("cuda")
        b = x0.shape[0]
        t0 = time.perf_counter()
        graphs = StepGraphs(ctrl, plant, b, dt)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        eager = lambda: run_closed_loop(plant, ctrl, x0, T, dt)
        graphed = lambda: graphs.run(x0, T)
        ref, k1_eager, _ = traced(eager)
        got, k1_graph, counters = traced(graphed)
        lock = ref.info["sqp_iters"].amax(dim=0)  # [T] lock-step iterations of the eager loop
        want_graph = int(torch.clamp(lock, min=2).sum())
        want_trips = int(torch.clamp(lock - 2, min=0).sum())
        replays = counters.get("closed_loop.graph_steps", 0)
        trips = counters.get("closed_loop.eager_trips", 0)
        diff = [k for k in ("x_true", "u", "ok")
                if not torch.equal(getattr(ref, k), getattr(got, k))]
        diff += [f"info.{k}" for k in ref.info if not torch.equal(ref.info[k], got.info[k])]
        if sorted(ref.info) != sorted(got.info):
            diff.append("info keys")
        eager_ms = min(timed(eager) for _ in range(CLG_TRIALS))
        graph_ms = min(timed(graphed) for _ in range(CLG_TRIALS))
        rec[name] = dict(
            batch=b, t_steps=T, bit_equal=not diff, differs=diff, captures=1,
            capture_s=capture_s, replays=replays, eager_trips=trips,
            k1_launches_graph=sum(k1_graph.values()), lock_step_graph=want_graph,
            k1_launches_eager=sum(k1_eager.values()), lock_step_eager=int(lock.sum()),
            k1_kernels=sorted(set(k1_graph) | set(k1_eager)),
            eager_ms=eager_ms, graph_ms=graph_ms, speedup=eager_ms / graph_ms,
            usable_step_frac=float(got.ok.float().mean()))
        log(f"closed loop graph {name}: " + json.dumps(rec[name]))
        if diff or rec[name]["k1_launches_graph"] != want_graph \
                or rec[name]["k1_launches_eager"] != int(lock.sum()) \
                or replays != T or trips != want_trips:
            raise AssertionError(f"closed loop graph {name}: {rec[name]}")
        del graphs, ref, got
        torch.cuda.empty_cache()
    return rec


def lm_quality(label, U, chi2, x0s_np):
    """The LM gate against the float64 golden file (see ``phase_lm``): returns
    the quality record of one pass, raises where it misses the gate."""
    gold = np.load(LM_GOLDEN)
    n_g = gold["U"].shape[0]
    if not np.array_equal(gold["x0s"], x0s_np[:n_g]):
        raise AssertionError("LM golden file was made for other initial states")
    lane_err = lambda u: np.abs(u - gold["U"]).max(axis=(1, 2))
    chi_gap = lambda c: np.abs(c - gold["chi2"]) / (1.0 + gold["chi2"])
    e_port, e_ref = lane_err(U[:n_g].double().cpu().numpy()), lane_err(gold["U_f32"])
    c_port, c_ref = chi_gap(chi2[:n_g].double().cpu().numpy()), chi_gap(gold["chi2_f32"])
    c_port = c_port[np.isfinite(c_port)]  # inf: a lane whose weights grew last
    quality = dict(
        u_err_median=float(np.median(e_port)), u_err_mean=float(e_port.mean()),
        u_err_max=float(e_port.max()), lanes_above_1e3=int((e_port > 1e-3).sum()),
        ref_f32_u_err_median=float(np.median(e_ref)), ref_f32_u_err_mean=float(e_ref.mean()),
        ref_f32_u_err_max=float(e_ref.max()), ref_f32_lanes_above_1e3=int((e_ref > 1e-3).sum()),
        chi2_gap_mean=float(c_port.mean()), chi2_gap_max=float(c_port.max()),
        ref_f32_chi2_gap_mean=float(c_ref.mean()), ref_f32_chi2_gap_max=float(c_ref.max()),
    )
    log(f"lm quality vs f64 golden ({label}): " + json.dumps(quality))
    for key in ("u_err_mean", "u_err_max", "chi2_gap_mean", "chi2_gap_max"):
        if not quality[key] <= 2.0 * quality["ref_f32_" + key] + 1e-3:
            raise AssertionError(
                f"LM ({label}) {key} {quality[key]:.3e} > 2 x the reference's float32 "
                f"{quality['ref_f32_' + key]:.3e} + 1e-3")
    if not quality["u_err_median"] <= ERR_GATE:
        raise AssertionError(
            f"LM ({label}) median |U - U_golden| {quality['u_err_median']:.3e} > {ERR_GATE}")
    return quality


def phase_lm(ocp, cfg, x0s_np, trials: int):
    """The batched LM solve of config 1 through the in-place kernel, then once
    more through K3 (``inplace=False``); returns the launch counts of the two
    runs and the record of the ``{"lm": ...}`` line.

    Gates. The float64 LM of the reference is the golden file; but float32 LM
    does not reproduce float64 LM lane by lane in ANY implementation: its
    accept and stall tests sit below float32 resolution near the solution, a
    stall at an infeasible point multiplies the penalty weights by 10, and
    the weights a lane ends with decide its answer. The reference's own
    float32 solve of the golden lanes (in the file) is up to 0.46 from its
    float64 solve. So the port's float32 solve on the card is held to being as
    close to the float64 golden as the reference's float32 solve is: mean and
    max over the golden lanes of the per-lane max |U - U_golden|, and of the
    relative chi2 gap, each <= 2x the reference's + 1e-3; the median |U| error
    <= 1e-3 outright.
    """
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
    from control_box_rst_tpu_torch.parallel import make_batched_lm_solver

    solver = make_batched_lm_solver(ocp, cfg, dt_init=0.1)  # device=None: the card
    B = x0s_np.shape[0]
    x0s = torch.as_tensor(x0s_np, device="cuda")
    solver(x0s[:256])  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    U, chi2, status, iters, feas = solver(x0s)
    torch.cuda.synchronize()
    best = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    if U.shape != (B, ocp.N, ocp.nu) or not bool(torch.isfinite(U).all()):
        raise AssertionError(f"LM path: U has shape {tuple(U.shape)} or non-finite values")
    conv = float((status == 1).float().mean())
    if launches["btridiag_factor_solve_inplace"] <= 0 or launches["btridiag_factor_solve"] != 0:
        raise AssertionError(f"LM path: unexpected kernel launches {launches}")
    route = dict(bk.LAUNCH_INFO["btridiag_factor_solve_inplace"])
    log(f"LM path: btridiag_factor_solve_inplace launched "
        f"{launches['btridiag_factor_solve_inplace']} time(s), last launch {route}")
    if route.get("route") != "smem":
        raise AssertionError(f"LM path: the in-place solve took {route}, not the shared-memory kernel")
    if conv < CONV_GATE:
        raise AssertionError(f"LM converged_frac {conv:.4f} < {CONV_GATE}")

    quality = lm_quality("in place", U, chi2, x0s_np)

    for _ in range(trials - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)

    # the same batch through K3, held to the same gates.
    # The two passes are not held to each other: float32 LM is path-dependent
    # (one bit in a step can flip an accept or stall test, and the penalty
    # weights a lane ends with decide its answer), so what is promised is the
    # quality of each; their difference is reported.
    solver3 = make_batched_lm_solver(ocp, cfg, dt_init=0.1, inplace=False)
    bk.reset_launch_counts()
    U3, chi2_3, status3, iters3, _ = solver3(x0s)
    torch.cuda.synchronize()
    launches3 = dict(bk.LAUNCHES)
    if launches3["btridiag_factor_solve"] <= 0 or launches3["btridiag_factor_solve_inplace"] != 0:
        raise AssertionError(f"LM path (K3): unexpected kernel launches {launches3}")
    if not bool(torch.isfinite(U3).all()):
        raise AssertionError("LM path (K3): non-finite U")
    conv3 = float((status3 == 1).float().mean())
    if conv3 < CONV_GATE:
        raise AssertionError(f"LM (K3) converged_frac {conv3:.4f} < {CONV_GATE}")
    quality3 = lm_quality("K3", U3, chi2_3, x0s_np)
    du3 = float((U3 - U).abs().max())
    same_status3 = float((status3 == status).float().mean())
    same_iters3 = float((iters3 == iters).float().mean())
    log(f"lm, K3 vs K4: max |dU| {du3:.3e}, status equal on "
        f"{same_status3:.5f} of lanes, iterations equal on {same_iters3:.5f}")

    x0_1 = x0s[:1]
    solver(x0_1)
    torch.cuda.synchronize()
    lats = []
    for _ in range(20):
        t0 = time.perf_counter()
        solver(x0_1)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)

    counts = {
        "btridiag_factor_solve_inplace": launches["btridiag_factor_solve_inplace"],
        "btridiag_factor_solve": launches3["btridiag_factor_solve"],
    }
    return counts, dict(
        batch=B, solves_per_s=B / best, batch_solve_ms=best * 1e3,
        converged_frac=conv, mean_lm_iters=float(iters.float().mean()),
        max_lm_iters=int(iters.max()), max_feas_res=float(feas.max()),
        launches=counts, kernel_route=route["route"], max_du_k3_vs_k4=du3,
        status_equal_frac_k3_vs_k4=same_status3,
        iters_equal_frac_k3_vs_k4=same_iters3,
        converged_frac_k3=conv3,
        k3_u_err_median=quality3["u_err_median"],
        k3_u_err_mean=quality3["u_err_mean"],
        k3_u_err_max=quality3["u_err_max"],
        peak_device_memory_gib=peak_gb, **quality,
        p50_single_solve_ms=float(np.percentile(np.asarray(lats), 50) * 1e3),
        p99_single_solve_ms=float(np.percentile(np.asarray(lats), 99) * 1e3),
    )


def profile_kernels_alone(ocp, cfg, x0s_all):
    """The kernels that no phase times by itself, alone under torch.profiler
    at the main paths' shapes: K1 (production exits) and K2 on both routes
    on the config-1 QPs, K4's one-thread-per-lane route on random SPD systems
    (K3 and K4's shared-memory kernel are timed alone in every run by
    ``phase_btridiag_kernels``). Returns label -> milliseconds per launch
    (over 3 calls each)."""
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk

    qp = cfg.qp
    base = dict(sigma=qp.sigma, alpha=qp.alpha, rho_eq_scale=qp.rho_eq_scale)
    iters = qp.iters_per_round
    prod_kw = dict(
        base, rho_min=qp.rho_min, rho_max=qp.rho_max, iters=iters, tol=qp.tol,
        n_rounds=max(1, -(-(cfg.max_iter * qp.max_iter) // iters)),
        tol_stat=cfg.tol_stat, tol_feas=cfg.tol_feas)
    args = config1_qps(ocp, x0s_all)
    D, O, b = random_spd_systems(x0s_all.shape[0], ocp.N + 1, ocp.nz, x0s_all.device)
    calls = {}
    for r in ak.ROUTES:
        calls[f"boxqp_solve route={r}"] = (
            lambda r=r: ak.boxqp_solve(*args, **prod_kw, route=r), "boxqp_solve")
        calls[f"admm_round route={r}"] = (
            lambda r=r: ak.admm_round(*args, iters=iters, **base, route=r), "admm_round")
    calls["btridiag_factor_solve_inplace route=thread"] = (
        lambda: bk.btridiag_factor_solve(D, O, b, route="thread"),
        "btridiag_factor_solve_inplace_kernel")
    return kernels_alone_ms(calls, 3)


def profile_record(prof, wall_ms, top: int = 14):
    """What a finished ``torch.profiler`` run saw over ``wall_ms`` of wall
    time: device time by kernel name, the hand-written kernels launch by
    launch (kernel-alone times), and the share of the wall time the device
    sat idle. The program's layer spans (``record_function`` ranges) show on
    the device's timeline as user annotations: they are not device work and
    are left out."""
    cuda = torch.autograd.DeviceType.CUDA

    def device_work(e):
        return e.device_type == cuda and not getattr(e, "is_user_annotation", False)

    rows = [
        (e.key, e.device_time_total / 1e3, e.count)
        for e in prof.key_averages() if e.device_time_total > 0 and device_work(e)
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    # the hand-written kernels launch by launch, in launch order
    ours = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if device_work(e) and any(
                tag in e.name for tag in ("boxqp_solve", "admm_round", "btridiag_factor_solve")):
            ours.setdefault(e.name.split("(")[0][:60], []).append(e.device_time_total / 1e3)
    own = {
        name: dict(launches=len(t), mean_ms=sum(t) / len(t), min_ms=min(t), max_ms=max(t),
                   each_ms=t if len(t) <= 4 else None)
        for name, t in ours.items()}
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        n_device_kernels=int(sum(r[2] for r in rows)),
        own_kernels=own,
        top=[dict(name=r[0][:60], ms=r[1], calls=r[2]) for r in rows[:top]],
    )


def phase_profile(solvers, x0s_np, top: int = 14):
    """torch.profiler over one batched solve of each main path and one single
    SQP solve: device time by kernel name, the hand-written kernels launch by
    launch (kernel-alone times), and the share of the wall time the device
    sat idle. ``solvers``: label -> (solver, number of lanes)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, (solver, lanes) in solvers.items():
        x = torch.as_tensor(x0s_np[:lanes], device="cuda")
        solver(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solver(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out[label] = profile_record(prof, wall_ms, top)
    return out


# --------------------------------------------------------------------------
# the interior-point paths (config 1 by IP, the constrained double
# integrator by IP / SQP / LM, config 5 under the IP controller) and the
# block-tridiagonal kernels at nz = 2 (IP's nc x nc Schur systems)
# --------------------------------------------------------------------------

def constrained_di_x0s(n: int = DI_BATCH) -> np.ndarray:
    """The constrained double integrator's batch: x0 = [d, 0], d ~ U(-2, 2)
    from ``default_rng(6)``, lane 0 at d = 2 (the golden file's lanes)."""
    d = np.random.default_rng(6).uniform(-2.0, 2.0, size=DI_BATCH)
    d[0] = 2.0
    return np.stack([d, np.zeros(DI_BATCH)], axis=1).astype(np.float32)[:n]


def btridiag_systems(mod, run, calls):
    """The systems (D, O, b) that a solver module hands to the
    block-tridiagonal kernel (``mod.btridiag_factor_solve``, one call per
    lock-step iteration) at the given calls (0 = the first) while ``run()``
    solves: a catch on the solver's call, which still launches its kernel."""
    real, kept, n = mod.btridiag_factor_solve, {}, [0]

    def catch(D, O, b, inplace=True):
        if n[0] in calls:
            kept[n[0]] = (D.clone(), O.clone(), b.clone())
        n[0] += 1
        return real(D, O, b, inplace=inplace)

    mod.btridiag_factor_solve = catch
    try:
        run()
    finally:
        mod.btridiag_factor_solve = real
    torch.cuda.synchronize()
    if sorted(kept) != sorted(calls):
        raise AssertionError(f"the solve stopped after {n[0]} calls, before call {max(calls)}")
    return kept


def hold_btridiag_on_systems(label, systems, nz, lost_ok=False, reps=0):
    """K3 and K4 on a solver's own systems ({iteration: (D, O, b)}) against
    the plain version: each kernel as close to the float64 plain version as
    the float32 plain version is (slack 2x + 1e-5), K3 on its scratch route,
    K4 on its shared-memory route with 32 / nz lanes a warp. Every lane must
    be finite, but where ``lost_ok`` (LM's systems J'J + mu I, badly
    conditioned once the penalty weights have grown): there a system that is
    not positive definite in float32 gives NaN in its lane on either side,
    the kernel may lose no more lanes than the plain version (+5 % of its
    count, +0.1 % of the batch), and the others are compared. With ``reps``
    each call is also timed. Returns ({kernel: {"it<k>": errors}},
    {kernel: {"it<k>": ms}})."""
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk

    name3, name4 = "btridiag_factor_solve", "btridiag_factor_solve_inplace"
    solve = {
        name3: lambda D, O, b: bk.btridiag_factor_solve(D, O, b, inplace=False),
        name4: lambda D, O, b: bk.btridiag_factor_solve(D, O, b, inplace=True),
    }
    fin = lambda x: torch.isfinite(x).all(dim=2).all(dim=1)
    errs = {name: {} for name in solve}
    ms = {name: {} for name in solve}
    for it, (D, O, b) in systems.items():
        B, K = b.shape[:2]
        if b.shape[2] != nz:
            raise AssertionError(f"{label}: systems of nz={b.shape[2]}, expected {nz}")
        x_p = bk.btridiag_factor_solve_plain(D, O, b)
        x_d = bk.btridiag_factor_solve_plain(D.double(), O.double(), b.double())
        for name, fn in solve.items():
            x_k = fn(D, O, b)
            torch.cuda.synchronize()
            info = bk.LAUNCH_INFO[name]
            if name == name3 and info.get("route") != "scratch":
                raise AssertionError(f"{label}: {name3} took {info}, not K3's scratch kernel")
            if name == name4 and (info.get("route") != "smem"
                                  or info.get("lanes_per_warp") != 32 // nz):
                raise AssertionError(f"{label}: {name4} took {info}, not the nz={nz} "
                                     "shared-memory kernel")
            lost_k, lost_p = int((~fin(x_k)).sum()), int((~fin(x_p)).sum())
            ok = fin(x_k) & fin(x_p) & fin(x_d) if lost_ok else torch.ones_like(fin(x_k))
            if lost_ok and lost_k > 1.05 * lost_p + B // 1000:
                raise AssertionError(
                    f"{label} {name} iteration {it}: {lost_k} non-finite lanes, "
                    f"the plain version {lost_p}")
            e_k, e_p = assert_as_close_as_plain(
                f"{label} {name} nz={nz} K={K} iteration {it}", x_k[ok], x_p[ok], x_d[ok])
            errs[name][f"it{it}"] = dict(err_vs_f64=e_k, plain_err_vs_f64=e_p,
                                         x_max=float(x_d[ok].abs().max()))
            if lost_ok:
                errs[name][f"it{it}"].update(nonfinite_lanes=lost_k, plain_nonfinite_lanes=lost_p)
            if reps:
                ms[name][f"it{it}"] = time_ms(lambda fn=fn: fn(D, O, b), reps)
    log(f"{label}: K3/K4 nz={nz} on the solver's own systems: {json.dumps(errs)}")
    return errs, ms


def phase_btridiag_nz2_kernels(ocp, ip_cfg, x0s_all, reps: int):
    """K3 and K4 built for nz = 2 (the IP solver's Schur systems at config
    1's shape: K = 50 stages of 2 x 2 blocks, B = 32768) against their plain
    version: random SPD systems (atol 5e-6); IP's own Schur systems at its
    first and a late lock-step iteration, as close to the float64 plain
    version as the float32 plain version; B = 1, 8 and 1000 (not a multiple
    of the 16 lanes of a warp) give the first lanes' bits; the two kernels
    bit for bit; times (wrapper, kernel alone), bound, launch shape and the
    dense library call as a yardstick. Returns name -> record at nz = 2."""
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk

    B, K, nz = x0s_all.shape[0], ocp.N, ocp.nc
    dev = x0s_all.device
    name3, name4 = "btridiag_factor_solve", "btridiag_factor_solve_inplace"
    solve = {
        name3: lambda D, O, b: bk.btridiag_factor_solve(D, O, b, inplace=False),
        name4: lambda D, O, b: bk.btridiag_factor_solve(D, O, b, inplace=True),
    }
    if bk.solve_route(K, nz) != "smem" or bk.lanes_per_warp(nz) != 16:
        raise AssertionError(f"nz={nz}, K={K}: expected the shared-memory route, 16 lanes a warp")
    D, O, b = random_spd_systems(B, K, nz, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_plain = bk.btridiag_factor_solve_plain(D, O, b)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    x_kern, max_err, info = {}, {}, {}
    for name, fn in solve.items():
        x_kern[name] = fn(D, O, b)
        torch.cuda.synchronize()
        info[name] = dict(bk.LAUNCH_INFO[name])
        max_err[name] = assert_close(f"{name} nz={nz} random SPD", x_kern[name], x_plain,
                                     rtol=0.0, atol=5e-6)
    if info[name3].get("route") != "scratch" or info[name4].get("route") != "smem":
        raise AssertionError(f"nz={nz}: routes {info}")
    bit_equal = torch.equal(x_kern[name3], x_kern[name4])
    d34 = float((x_kern[name3] - x_kern[name4]).abs().max())
    if not d34 <= 1e-6:
        raise AssertionError(f"nz={nz}: the two kernels differ by {d34:.3e}")
    for n in (1, 8, 1000):
        for name, fn in solve.items():
            x_n = fn(D[:n], O[:n], b[:n])
            torch.cuda.synchronize()
            if not torch.equal(x_n, x_kern[name][:n]):
                raise AssertionError(f"{name} nz={nz}: B={n} disagrees with the first lanes")
    ms = {name: time_ms(lambda fn=fn: fn(D, O, b), reps) for name, fn in solve.items()}
    tags = {name3: "btridiag_factor_solve_scratch_kernel",
            name4: "btridiag_factor_solve_smem_kernel"}
    alone = kernels_alone_ms({name: (lambda fn=fn: fn(D, O, b), tags[name])
                              for name, fn in solve.items()}, reps)
    lib_ms, lib_B = dense_library_ms(D, O, b, x_kern[name4], 2)
    t_bytes = bk.io_bytes(K, nz, B) / PEAK_BYTES_PER_S * 1e3
    t_ops = B * bk.factor_solve_flops(K, nz) / PEAK_FP32_PER_S * 1e3
    del D, O, b, x_plain, x_kern

    # IP's own Schur systems on the config-1 batch
    from control_box_rst_tpu_torch.ocp.problem import Trajectory
    from control_box_rst_tpu_torch.solvers import ip as ip_mod

    o = ocp.replace(bc=ocp.bc.replace(x0=x0s_all))
    traj0 = Trajectory.linear_interp(x0s_all, o.refs.xref[-1], o.N, o.nu, 0.1)
    systems = btridiag_systems(
        ip_mod, lambda: ip_mod.ip_solve(o, traj0, ip_cfg), (0, IP_LATE_ITERATION))
    ip_errs, ip_ms = hold_btridiag_on_systems(
        f"config 1 IP Schur systems [{B} lanes]", systems, nz, reps=reps)
    del systems
    log(f"btridiag kernels nz={nz} [{B} lanes, K={K}]: " + json.dumps(
        dict(max_err=max_err, k3_vs_k4=d34, bit_equal=bit_equal, ip_systems=ip_errs)))
    return {name: dict(
        nz=nz, K=K, batch=B, max_abs_err=max_err[name], ms=ms[name], alone_ms=alone[name],
        plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops, library_ms=lib_ms, library_batch=lib_B,
        launch=info[name], k3_vs_k4=d34, k3_bit_equal_k4=bit_equal,
        ip_systems=ip_errs[name], ip_systems_ms=ip_ms[name],
    ) for name in solve}


def _lock_step_launches(bk, label, want):
    got = dict(bk.LAUNCHES)
    log(f"{label}: btridiag launches {got}, lock-step iterations {want}")
    if got["btridiag_factor_solve_inplace"] != want or want <= 0 or got["btridiag_factor_solve"]:
        raise AssertionError(f"{label}: launches {got}, expected {want} = the lock-step "
                             "iterations of K4's in-place solve and none of K3")
    return want


def _constrained_quality(label, X, U, status, gold, gates=True):
    """The constrained double integrator's gates: converged fraction, the
    state row on every lane, x_N = 0, U against the float64 golden lanes."""
    n_g = gold["U"].shape[0]
    rec = dict(
        converged_frac=float((status == 1).float().mean()),
        min_x2=float(X[..., 1].min()), max_abs_xN=float(X[:, -1].abs().max()),
        max_u_err_vs_f64_oracle=float(np.abs(U[:n_g].double().cpu().numpy() - gold["U"]).max()),
        finite=bool(torch.isfinite(U).all()),
    )
    log(f"constrained DI ({label}): " + json.dumps(rec))
    if gates:
        for key, ok in (("converged_frac", rec["converged_frac"] >= CONV_GATE),
                        ("min_x2", rec["min_x2"] >= -0.9 - 1e-5),
                        ("max_abs_xN", rec["max_abs_xN"] <= 1e-4),
                        ("max_u_err_vs_f64_oracle", rec["max_u_err_vs_f64_oracle"] <= ERR_GATE),
                        ("finite", rec["finite"])):
            if not ok:
                raise AssertionError(f"constrained DI ({label}): {key} {rec[key]} misses its gate")
    return rec


def phase_ip(x0s_np, trials: int, n_single: int):
    """The interior-point paths on the card. Returns (K4 launches by path,
    K3 launches by path, K3/K4 held on the constrained DI's own systems by
    path, the record of the ``{"ip": ...}`` line, the solvers for
    ``--profile``)."""
    from control_box_rst_tpu_torch.entry import constrained_di, flagship_ip, rollouts, rollouts_ip
    from control_box_rst_tpu_torch.ocp.problem import Trajectory
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
    from control_box_rst_tpu_torch.parallel import (
        make_batched_closed_loop,
        make_batched_ip_solver,
    )
    from control_box_rst_tpu_torch.solvers import ip_solve, lm_solve, sqp_solve
    from control_box_rst_tpu_torch.solvers.sqp import resolve_qp_backend

    launches, rec = {}, {}
    # ---- config 1 by IP (B = 32768) ----
    ocp, cfg = flagship_ip(N=50)  # device=None: the card
    solver = make_batched_ip_solver(ocp, cfg, dt_init=0.1)
    B = x0s_np.shape[0]
    x0s = torch.as_tensor(x0s_np, device="cuda")
    solver(x0s[:256])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    U, obj, status, iters = solver(x0s)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches["ip_config1"] = _lock_step_launches(bk, "config 1 by IP", int(iters.max()))
    # the lanes that ran to the iteration cap, for the float32 witness of
    # tools/ip_f32_witness.py
    capped = torch.nonzero(iters >= cfg.max_iter).flatten().tolist()
    k4_info = dict(bk.LAUNCH_INFO["btridiag_factor_solve_inplace"])
    if k4_info.get("route") != "smem" or k4_info.get("lanes_per_warp") != 16:
        raise AssertionError(f"config 1 by IP: K4 took {k4_info}, not the nz=2 shared-memory kernel")
    if U.shape != (B, ocp.N, ocp.nu) or not bool(torch.isfinite(U).all()):
        raise AssertionError("config 1 by IP: U has the wrong shape or non-finite values")
    conv = float((status == 1).float().mean())
    gold = np.load(GOLDEN)
    n_g = gold["U"].shape[0]
    u_err = float(np.abs(U[:n_g].double().cpu().numpy() - gold["U"]).max())
    log(f"config 1 by IP: converged {conv:.5f}, max |U - U_oracle| {u_err:.3e}, "
        f"iterations mean {float(iters.float().mean()):.2f} max {int(iters.max())}")
    if conv < CONV_GATE:
        raise AssertionError(f"config 1 by IP: converged_frac {conv:.4f} < {CONV_GATE}")
    if not u_err <= ERR_GATE:
        raise AssertionError(f"config 1 by IP: max |U - U_oracle| {u_err:.3e} > {ERR_GATE}")
    best = first_s
    for _ in range(trials - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    lats = []
    for _ in range(n_single + 1):
        t0 = time.perf_counter()
        solver(x0s[:1])
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
    lats = np.asarray(lats[1:])
    rec["config1"] = dict(
        batch=B, solves_per_s=B / best, batch_solve_ms=best * 1e3, converged_frac=conv,
        max_u_err_vs_f64_oracle=u_err, mean_ip_iters=float(iters.float().mean()),
        max_ip_iters=int(iters.max()), capped_lanes=capped,
        k4_launches=launches["ip_config1"], kernel_launch=k4_info,
        peak_device_memory_gib=peak_gb, ip_config=dict(tol=cfg.tol, max_iter=cfg.max_iter),
        p50_single_solve_ms=float(np.percentile(lats, 50) * 1e3),
        p99_single_solve_ms=float(np.percentile(lats, 99) * 1e3),
    )

    # ---- the constrained double integrator (B = 4096) by IP, SQP, LM ----
    di, sqp_cfg, lm_cfg, di_ip_cfg = constrained_di()
    di_x0s_np = constrained_di_x0s()
    di_gold = np.load(DI_GOLDEN)
    if not np.array_equal(di_gold["x0s"], di_x0s_np[:di_gold["x0s"].shape[0]]):
        raise AssertionError("constrained DI golden file was made for other initial states")
    xd = torch.as_tensor(di_x0s_np, device="cuda")
    o = di.replace(bc=di.bc.replace(x0=xd))
    traj0 = Trajectory.linear_interp(xd, torch.zeros(2, device="cuda"), di.N, di.nu, DI_DT)
    di_rec = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ip_solve(o.replace(bc=o.bc.replace(x0=xd[:64])), traj0.replace(X=traj0.X[:64]), di_ip_cfg)
    bk.reset_launch_counts()
    r, s = timed(lambda: ip_solve(o, traj0, di_ip_cfg))
    launches["ip_constrained_di"] = _lock_step_launches(
        bk, "constrained DI by IP", int(r.iterations.max()))
    k4_di = dict(bk.LAUNCH_INFO["btridiag_factor_solve_inplace"])
    if k4_di.get("route") != "smem" or k4_di.get("lanes_per_warp") != 16:
        raise AssertionError(f"constrained DI by IP: K4 took {k4_di}, not the nz=2 shared-memory kernel")
    worst = torch.argsort(r.iterations, descending=True)[:16]
    di_rec["ip"] = dict(
        _constrained_quality("IP", r.traj.X, r.traj.U, r.status, di_gold),
        solves_per_s=DI_BATCH / s, batch_solve_ms=s * 1e3,
        mean_ip_iters=float(r.iterations.float().mean()), max_ip_iters=int(r.iterations.max()),
        most_iterations=dict(lanes=worst.tolist(), iterations=r.iterations[worst].tolist()),
        k4_launches=launches["ip_constrained_di"], kernel_launch=k4_di,
        ip_config=dict(tol=di_ip_cfg.tol, max_iter=di_ip_cfg.max_iter))
    u_ip = r.traj.U

    # the same solve asked for K3 (inplace=False), through the batched entry point
    di_ip_k3 = make_batched_ip_solver(di, di_ip_cfg, dt_init=DI_DT, inplace=False)
    bk.reset_launch_counts()
    U3, _, st3, it3 = di_ip_k3(xd)
    torch.cuda.synchronize()
    got = dict(bk.LAUNCHES)
    k3_lock = int(it3.max())
    if got["btridiag_factor_solve"] != k3_lock or k3_lock <= 0 or got["btridiag_factor_solve_inplace"]:
        raise AssertionError(f"constrained DI by IP, inplace=False: launches {got}, "
                             f"expected {k3_lock} = the lock-step iterations of K3 and none of K4")
    k3_di = dict(bk.LAUNCH_INFO["btridiag_factor_solve"])
    if k3_di.get("route") != "scratch":
        raise AssertionError(f"constrained DI by IP, inplace=False: K3 took {k3_di}")
    k3_paths = {"ip_constrained_di_inplace_false": k3_lock}
    n_g = di_gold["U"].shape[0]
    di_rec["ip_inplace_false"] = dict(
        converged_frac=float((st3 == 1).float().mean()),
        max_u_err_vs_f64_oracle=float(np.abs(U3[:n_g].double().cpu().numpy() - di_gold["U"]).max()),
        k3_launches=k3_lock, max_u_k3_vs_k4=float((U3 - u_ip).abs().max()), kernel_launch=k3_di)
    log(f"constrained DI by IP, inplace=False: {json.dumps(di_rec['ip_inplace_false'])}")
    if di_rec["ip_inplace_false"]["converged_frac"] < CONV_GATE \
            or not di_rec["ip_inplace_false"]["max_u_err_vs_f64_oracle"] <= ERR_GATE \
            or not bool(torch.isfinite(U3).all()):
        raise AssertionError("constrained DI by IP, inplace=False: misses the IP gates")

    scfg = resolve_qp_backend(sqp_cfg, di.ng, "cuda", torch.float32)
    if scfg.qp.backend != "plain":
        raise AssertionError(f"constrained DI by SQP: backend {scfg.qp.backend}, expected 'plain'")
    ak.reset_launch_counts()
    bk.reset_launch_counts()
    r, s = timed(lambda: sqp_solve(o, traj0, scfg))
    if any(ak.LAUNCHES.values()) or any(bk.LAUNCHES.values()):
        raise AssertionError(f"constrained DI by SQP launched {ak.LAUNCHES} {bk.LAUNCHES}: "
                             "the path is the plain ADMM")
    sqp_scan = (r.traj.U, s)
    di_rec["sqp"] = dict(
        _constrained_quality("SQP", r.traj.X, r.traj.U, r.status, di_gold),
        solves_per_s=DI_BATCH / s, batch_solve_ms=s * 1e3, qp_backend="plain",
        boxqp_solve_launches=0, mean_sqp_iters=float(r.iterations.float().mean()),
        max_sqp_iters=int(r.iterations.max()),
        max_u_ip_vs_sqp=float((u_ip - r.traj.U).abs().max()))

    lm_solve(o.replace(bc=o.bc.replace(x0=xd[:64])), traj0.replace(X=traj0.X[:64]), lm_cfg)
    bk.reset_launch_counts()
    r, s = timed(lambda: lm_solve(o, traj0, lm_cfg))
    got = dict(bk.LAUNCHES)
    lm_lock = int(r.iterations.max())
    if got["btridiag_factor_solve_inplace"] != lm_lock or lm_lock <= 0 or got["btridiag_factor_solve"]:
        raise AssertionError(f"constrained DI by LM: launches {got}, lock-step {lm_lock}")
    if bk.LAUNCH_INFO["btridiag_factor_solve_inplace"].get("lanes_per_warp") != 8:
        raise AssertionError("constrained DI by LM: K4 was not the nz=4 build")
    launches["lm_constrained_di"] = lm_lock
    lm_info = dict(bk.LAUNCH_INFO["btridiag_factor_solve_inplace"])
    if not bool(torch.isfinite(r.traj.U).all()):
        raise AssertionError("constrained DI by LM: non-finite U")
    di_rec["lm"] = dict(
        _constrained_quality("LM", r.traj.X, r.traj.U, r.status, di_gold, gates=False),
        max_x2_violation=float(torch.clamp(-0.9 - r.traj.X[..., 1], min=0.0).max()),
        solves_per_s=DI_BATCH / s, batch_solve_ms=s * 1e3,
        mean_lm_iters=float(r.iterations.float().mean()), max_lm_iters=lm_lock,
        k4_launches=lm_lock, kernel_launch=lm_info)

    # K3 and K4 held against the plain version on the systems these solves
    # hand them: IP's Schur systems (nz=2, K=25), LM's damped Gauss-Newton
    # systems (nz=4, K=26), each at the first and a late iteration
    from control_box_rst_tpu_torch.solvers import ip as ip_mod
    from control_box_rst_tpu_torch.solvers import lm as lm_mod

    held = {}
    held["ip_constrained_di"], _ = hold_btridiag_on_systems(
        f"constrained DI IP Schur systems [{DI_BATCH} lanes]",
        btridiag_systems(ip_mod, lambda: ip_solve(o, traj0, di_ip_cfg), (0, IP_LATE_ITERATION)),
        di.nc)
    held["lm_constrained_di"], _ = hold_btridiag_on_systems(
        f"constrained DI LM systems [{DI_BATCH} lanes]",
        btridiag_systems(lm_mod, lambda: lm_solve(o, traj0, lm_cfg), (0, LM_LATE_ITERATION)),
        di.nz, lost_ok=True)
    rec["constrained_di"] = dict(batch=DI_BATCH, **di_rec)

    # ---- config 5 under the IP controller (B = 4096 rollouts) ----
    ctrl, plant, _, dt = rollouts_ip(N=50)
    roll = make_batched_closed_loop(ctrl, plant, IP_CL_STEPS, dt)
    xc = x0s[:IP_CL_BATCH]
    roll(xc[:256])
    torch.cuda.synchronize()
    bk.reset_launch_counts()
    res, s = timed(lambda: roll(xc))
    lock = res.info["sqp_iters"].amax(dim=0)
    launches["ip_controller"] = _lock_step_launches(bk, "IP controller", int(lock.sum()))
    u = res.u
    if not bool(torch.isfinite(u).all()) or not float(u.abs().max()) <= 1.0 + 1e-6:
        raise AssertionError(f"IP controller: u non-finite or beyond the bound ({float(u.abs().max())})")
    usable = float(res.ok.float().mean())
    usable_ref = float(res.ok[:IP_CL_REF_LANES].float().mean())
    if usable_ref < IP_CL_REF_USABLE:
        raise AssertionError(f"IP controller: usable fraction of the first {IP_CL_REF_LANES} "
                             f"rollouts {usable_ref:.4f} < the reference's {IP_CL_REF_USABLE}")
    sctrl, splant, _, _ = rollouts(N=50)
    res_s = make_batched_closed_loop(sctrl, splant, IP_CL_STEPS, dt)(xc)
    torch.cuda.synchronize()
    rec["controller"] = dict(
        batch=IP_CL_BATCH, t_steps=IP_CL_STEPS, rollout_batch_ms=s * 1e3,
        rollouts_per_s=IP_CL_BATCH / s, mpc_steps_per_s=IP_CL_BATCH * IP_CL_STEPS / s,
        usable_step_frac=usable, usable_step_frac_first64=usable_ref,
        k4_launches=launches["ip_controller"], lock_step_ip_iters=lock.tolist(),
        mean_ip_iters=float(res.info["sqp_iters"].float().mean()),
        max_u_ip_vs_sqp=float((u - res_s.u).abs().max()),
        mean_final_state_norm=float(res.x_true[:, -1].norm(dim=-1).mean()),
    )
    log(f"IP controller: {json.dumps(rec['controller'])}")
    di_ip = make_batched_ip_solver(di, di_ip_cfg, dt_init=DI_DT)
    return (launches, k3_paths, held, rec,
            dict(config1_ip=(solver, B), constrained_di_ip=(di_ip, DI_BATCH)), sqp_scan)



# --------------------------------------------------------------------------
# the other grids and the LQR family (configs 6 and 5's YAML, move blocking,
# block cyclic reduction)
# --------------------------------------------------------------------------

def hs_x0s(n: int) -> np.ndarray:
    """The first n of config 6's 4096 initial states: x0 ~ U(-1.5, 1.5)² from
    ``default_rng(60)``, lane 0 at the YAML's [1, 0.5]
    (``tools/hs_vdp_oracle_golden.py``); float32."""
    x0s = np.random.default_rng(60).uniform(-1.5, 1.5, size=(4096, 2)).astype(np.float32)
    x0s[0] = [1.0, 0.5]
    return x0s[:n]


def dual_mode_x0s(n: int) -> np.ndarray:
    """The first n of the dual-mode phase's 4096 initial states: x0 = [p, v],
    p ~ U(-1.5, 1.5), v ~ U(-0.5, 0.5) from ``default_rng(50)``, lane 0 at the
    YAML's [1, 0] (``tools/config6_calibration.py``); float32."""
    rng = np.random.default_rng(50)
    x0s = np.stack([rng.uniform(-1.5, 1.5, 4096), rng.uniform(-0.5, 0.5, 4096)],
                   axis=1).astype(np.float32)
    x0s[0] = [1.0, 0.0]
    return x0s[:n]


def _b1_latencies(solver, x0, n):
    solver(x0)
    torch.cuda.synchronize()
    lats = []
    for _ in range(n):
        t0 = time.perf_counter()
        solver(x0)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
    return dict(p50_single_solve_ms=float(np.percentile(lats, 50) * 1e3),
                p99_single_solve_ms=float(np.percentile(lats, 99) * 1e3), single_solves=n)


def _best_of(fn, trials):
    best = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_kernels_nz6(reps: int):
    """K1 built for (nz, nc) = (6, 4): config 6 on the uncompressed
    Hermite-Simpson grid (the midpoint states in the stage vector, their
    interpolation rows among the interval rows). The quotient against the
    division on 2^24 pairs; random QPs at Kst=21 with Hd/J/K per lane (four
    rounds of fixed work against the float32 plain version, x and duals at
    5x the flagship tolerances; B=1, 8 and 1000 give the first lanes' bits,
    so does the one-thread-per-lane route); the HS-unc first-iteration QPs
    of the chip batch (B=4096) as ``k1_qp_record`` holds them, and B =
    1000 the first lanes' bits there. Records the route, shared memory,
    resident lanes, registers and spills (``-Xptxas -v``), times and the
    bound."""
    from control_box_rst_tpu_torch.entry import hermite_simpson_unc
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import build

    ocp, cfg = hermite_simpson_unc(N=20)
    Kst, nz, nc = ocp.N + 1, ocp.nz, ocp.nc
    if (Kst, nz, nc) != (21, 6, 4):
        raise AssertionError(f"HS-unc: expected Kst 21, nz 6, nc 4, got {(Kst, nz, nc)}")
    rec = dict(Kst=Kst, nz=nz, nc=nc)
    lib = build.library_path(*ak.build_spec(nz, nc)).name
    report = build.ptxas_report(build.BUILD_OUTPUT.get(lib, ""))
    rec["ptxas"] = {k: v for k, v in report.items() if "boxqp_solve" in k or "admm_round" in k}
    rec["quotient_pairs_bit_equal"] = check_quotient(ak, nz, nc)
    qp = cfg.qp
    fixed_kw = dict(sigma=qp.sigma, alpha=qp.alpha, rho_eq_scale=qp.rho_eq_scale,
                    rho_min=qp.rho_min, rho_max=qp.rho_max, n_rounds=4,
                    iters=qp.iters_per_round, tol=0.0)
    x5 = {k: 5 * v for k, v in X_TOL.items()}
    d5 = {k: 5 * v for k, v in DUAL_TOL.items()}
    args = random_qps(1000, Kst, nz, nc, 0.1, "cuda")
    out_k = ak.boxqp_solve(*args, **fixed_kw)
    torch.cuda.synchronize()
    launch = dict(ak.LAUNCH_INFO["boxqp_solve"])
    if launch.get("route") != "smem" or launch.get("shared_hjk"):
        raise AssertionError(f"K1 (6, 4): expected the shared-memory route, per-lane Hd/J/K, took {launch}")
    out_p = ak.boxqp_solve_plain(*args, **fixed_kw)
    rec["random_fixed4_x"] = assert_close("K1 (6, 4) random x", out_k[0], out_p[0], **x5)
    assert_close("K1 (6, 4) random y_d", out_k[2], out_p[2], **d5)
    assert_close("K1 (6, 4) random y_b", out_k[3], out_p[3], **d5)
    for n in (1, 8):
        for route in ("smem", "thread"):
            full = out_k if route == "smem" else ak.boxqp_solve(*args, **fixed_kw, route="thread")
            out_n = ak.boxqp_solve(*[a[:n] for a in args], **fixed_kw, route=route)
            torch.cuda.synchronize()
            if not all_equal(out_n, [o[:n] for o in full]):
                raise AssertionError(f"K1 (6, 4) random, route {route}: B={n} disagrees with the first lanes")
    out_t = ak.boxqp_solve(*args, **fixed_kw, route="thread")
    torch.cuda.synchronize()
    assert_close("K1 (6, 4) random thread route x", out_t[0], out_p[0], **x5)
    rec["random_smem_bit_equal_thread"] = all_equal(out_k, out_t)
    del args, out_k, out_p, out_t
    x0s = torch.as_tensor(hs_x0s(HS_BATCH), device="cuda")
    args, kw = first_iteration_qps(ocp, cfg, 0.1, x0s)
    rec.update(k1_qp_record("hermite_simpson_unc", args, kw, reps))
    full = ak.boxqp_solve(*args, **kw)
    sub = ak.boxqp_solve(*[a[:1000] for a in args], **kw)
    torch.cuda.synchronize()
    if not all_equal(sub, [o[:1000] for o in full]):
        raise AssertionError("K1 (6, 4) on HS-unc QPs: B=1000 disagrees with the first lanes")
    rec["smem_bytes_per_lane"] = ak.state_bytes_per_lane(Kst, nz, nc, False)
    log(json.dumps({"kernels_nz6": rec}))
    return rec


def phase_kernels_nz5(reps: int):
    """K1 built for (nz, nc) = (5, 2) and (5, 3), the builds that only the
    master's zoo launches (ZOO_K1_BUILDS: the parallel integrators, two
    states and two controls; the free-space rocket, three states). Per
    build: the quotient against the division on 2^24 pairs; random QPs at
    Kst=21 with Hd/J/K per lane (four rounds of fixed work against the
    float32 plain version, x and duals at 5x the flagship tolerances; B=1
    and 8 give the first lanes' bits on both routes, and the routes agree
    with the plain version); the zoo system's own OCP (its config in the
    zoo golden, through the loader) and the QPs of its first SQP iteration
    at ZOO_K1_BATCH initial states around the config's x0 (lane 0: that x0)
    held as ``k1_qp_record`` holds them (Hd/J/K as the batch hands them:
    one hoisted copy for the linear parallel integrators): as close to the
    float64 plain version as the float32 plain version, B=1 and 8 the first
    lanes' bits, times and bound; their rounds against the float64 plain
    version's (``rounds_vs_f64``: the zoo's qp_tol 1e-7 is at float32's
    floor, and on the rocket's QPs the float32 plain version itself takes
    two rounds more than the float64 one on some lanes). Records registers and spills
    (``-Xptxas -v``). Returns the records by (nz, nc)."""
    from control_box_rst_tpu_torch.core import config as tc
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import build

    gold = np.load(MASTER_ZOO_GOLDEN)
    x5 = {k: 5 * v for k, v in X_TOL.items()}
    d5 = {k: 5 * v for k, v in DUAL_TOL.items()}
    out = {}
    for (nz, nc), system in ZOO_K1_BUILDS.items():
        label = f"K1 ({nz}, {nc})"
        cfg = json.loads(str(gold[f"{system}/config"]))
        ctrl, _ = tc.build_controller(cfg)  # float32 on the card
        ocp = ctrl.ocp
        Kst = ocp.N + 1
        if (Kst, ocp.nz, ocp.nc) != (21, nz, nc):
            raise AssertionError(f"{label}: {system} gives Kst {Kst}, nz {ocp.nz}, nc {ocp.nc}")
        rec = dict(system=system, Kst=Kst, nz=nz, nc=nc)
        lib = build.library_path(*ak.build_spec(nz, nc)).name
        report = build.ptxas_report(build.BUILD_OUTPUT.get(lib, ""))
        rec["ptxas"] = {k: v for k, v in report.items() if "boxqp_solve" in k or "admm_round" in k}
        rec["quotient_pairs_bit_equal"] = check_quotient(ak, nz, nc)
        qp = ctrl.cfg.qp
        fixed_kw = dict(sigma=qp.sigma, alpha=qp.alpha, rho_eq_scale=qp.rho_eq_scale,
                        rho_min=qp.rho_min, rho_max=qp.rho_max, n_rounds=4,
                        iters=qp.iters_per_round, tol=0.0)
        args = random_qps(1000, Kst, nz, nc, 0.1, "cuda")
        out_k = ak.boxqp_solve(*args, **fixed_kw)
        torch.cuda.synchronize()
        launch = dict(ak.LAUNCH_INFO["boxqp_solve"])
        if launch.get("route") != "smem" or launch.get("shared_hjk"):
            raise AssertionError(f"{label}: expected the shared-memory route, per-lane Hd/J/K, took {launch}")
        out_t = ak.boxqp_solve(*args, **fixed_kw, route="thread")
        out_p = ak.boxqp_solve_plain(*args, **fixed_kw)
        for route, out_r in (("smem", out_k), ("thread", out_t)):
            rec[f"random_fixed4_x_{route}"] = assert_close(
                f"{label} random {route} x", out_r[0], out_p[0], **x5)
            assert_close(f"{label} random {route} y_d", out_r[2], out_p[2], **d5)
            assert_close(f"{label} random {route} y_b", out_r[3], out_p[3], **d5)
            for n in (1, 8):
                out_n = ak.boxqp_solve(*[a[:n] for a in args], **fixed_kw, route=route)
                torch.cuda.synchronize()
                if not all_equal(out_n, [o[:n] for o in out_r]):
                    raise AssertionError(f"{label} random, route {route}: B={n} disagrees with "
                                         "the first lanes")
        del args, out_k, out_p, out_t
        rng = np.random.default_rng(10 * nz + nc)
        x0 = np.asarray(cfg["x0"], dtype=np.float32)
        x0s = x0 + rng.uniform(-0.25, 0.25, (ZOO_K1_BATCH, x0.size)).astype(np.float32)
        x0s[0] = x0
        args, kw = first_iteration_qps(ocp, ctrl.cfg, float(cfg["experiment"]["dt"]),
                                       torch.as_tensor(x0s, device="cuda"))
        # a linear system's batch hoists one copy of Hd/J/K (the zoo's run at
        # B=1 takes either form: the random QPs above hold the per-lane one)
        shared = ak._lane_invariant(*args[:3])
        rec.update(k1_qp_record(f"zoo_{system}", args, kw, reps, shared_hjk=shared,
                                rounds_vs_f64=True))
        rec["smem_bytes_per_lane"] = ak.state_bytes_per_lane(Kst, nz, nc, shared)
        log(json.dumps({f"kernels_nz{nz}_nc{nc}": rec}))
        out[nz, nc] = rec
    return out


def _open_loop_record(name, solver, x0s, trials, n_single, ak, per_lane_hjk):
    """One batched open-loop solve of a grid phase: K1 launches == the
    lock-step SQP iterations, converged >= 0.99, U finite; solves/s (best of
    ``trials``), SQP iterations, B=1 p50 / p99. Returns (record, U, obj,
    status, K1 launches, the K1 calls of the counted run by kind)."""
    B = x0s.shape[0]
    solver(x0s[:256])
    torch.cuda.synchronize()
    calls, restore = catch_boxqp_calls(ak)
    ak.reset_launch_counts()
    try:
        U, obj, status, iters = solver(x0s)
        torch.cuda.synchronize()
        n_launch = ak.LAUNCHES["boxqp_solve"]
        by_build = k1_launches_by_build(ak, name)
    finally:
        restore()
    route = dict(ak.LAUNCH_INFO["boxqp_solve"])
    lock = int(iters.max())
    log(f"{name}: boxqp_solve launched {n_launch} time(s) in {lock} lock-step SQP iterations, "
        f"last launch {route}")
    if not bool(torch.isfinite(U).all()) or not bool(torch.isfinite(obj).all()):
        raise AssertionError(f"{name}: non-finite U or objective")
    if n_launch <= 0 or n_launch != lock:
        raise AssertionError(f"{name}: {n_launch} boxqp_solve launches for {lock} lock-step SQP iterations")
    if route.get("route") != "smem" or bool(route.get("shared_hjk")) == per_lane_hjk:
        raise AssertionError(f"{name}: boxqp_solve took {route}")
    conv = float((status == 1).float().mean())
    if conv < CONV_GATE:
        raise AssertionError(f"{name}: converged_frac {conv:.4f} < {CONV_GATE}")
    best = _best_of(lambda: solver(x0s), trials)
    rec = dict(batch=B, solves_per_s=B / best, batch_solve_ms=best * 1e3, converged_frac=conv,
               mean_sqp_iters=float(iters.float().mean()), max_sqp_iters=lock,
               boxqp_solve_launches=n_launch, boxqp_solve_launches_by_build=by_build,
               kernel_route=route, boxqp_solve_calls=dict(one_shot=calls["one_shot"], outer=calls["outer"],
                                      per_lane_hjk=calls["per_lane_hjk_calls"]),
               **_b1_latencies(solver, x0s[:1], n_single))
    return rec, U, obj, status, n_launch


def phase_grids(x0s_main_np, trials: int, n_single: int):
    """Config 6 open loop (``entry.hermite_simpson``, N=20, B=4096) on the
    compressed and on the uncompressed Hermite-Simpson grid (the latter
    through K1's (6, 4) build), and move blocking on config 1
    (``entry.move_blocking``, ten blocks of 5, B=32768, the main batch).
    Gates: converged >= 0.99, K1 launches == lock-step SQP iterations > 0;
    config 6: max |U - U_oracle| <= 1e-3 on the 48 lanes of the float64
    golden, HS-unc's U within 1e-3 of HS's on every lane; move blocking: the
    one-shot on one shared copy of Hd/J/K at nc 3, controls equal inside each
    block to 1e-6 on every lane, objective >= config 1's unblocked objective
    - 1e-5 lane by lane. Returns (K1 launches by path, record, the batched
    solvers by path)."""
    from control_box_rst_tpu_torch.entry import (
        flagship,
        hermite_simpson,
        hermite_simpson_unc,
        move_blocking,
    )
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    gold = np.load(HS_GOLDEN)
    n_g = gold["U"].shape[0]
    x0s_np = hs_x0s(HS_BATCH)
    if not np.array_equal(gold["x0s"], x0s_np[:n_g]):
        raise AssertionError("config-6 golden file was made for other initial states")
    x0s = torch.as_tensor(x0s_np, device="cuda")
    launches, recs, Us, solvers = {}, {}, {}, {}
    for path, build_ocp in (("hs_config6", hermite_simpson), ("hs_unc_config6", hermite_simpson_unc)):
        ocp, cfg = build_ocp(N=20)
        solver = solvers[path] = make_batched_solver(ocp, cfg, dt_init=0.1)  # device=None: the card
        rec, U, _, _, n = _open_loop_record(path, solver, x0s, trials, n_single, ak, True)
        if rec["boxqp_solve_calls"]["per_lane_hjk"] != n:
            raise AssertionError(f"{path}: K1 calls {rec['boxqp_solve_calls']}: Hd/J/K not per lane")
        err = float(np.abs(U[:n_g].double().cpu().numpy() - gold["U"]).max())
        rec.update(nz=ocp.nz, nc=ocp.nc, max_u_err_vs_f64_oracle=err, oracle_lanes=n_g)
        if not err <= ERR_GATE:
            raise AssertionError(f"{path}: max |U - U_oracle| {err:.3e} > {ERR_GATE}")
        if rec["kernel_route"].get("smem_bytes_per_lane") != ak.state_bytes_per_lane(21, ocp.nz, ocp.nc, False):
            raise AssertionError(f"{path}: K1 took {rec['kernel_route']}")
        launches[path], recs[path], Us[path] = n, rec, U
    d_unc = float((Us["hs_unc_config6"] - Us["hs_config6"]).abs().max())
    recs["hs_unc_config6"]["max_u_vs_hs"] = d_unc
    if not d_unc <= ERR_GATE:
        raise AssertionError(f"HS-unc: max |U_unc - U_hs| {d_unc:.3e} > {ERR_GATE}")
    del Us

    # move blocking on config 1: the one-shot through the nc = 3 build
    ocp, cfg = move_blocking(N=50)
    x0s = torch.as_tensor(x0s_main_np[:MB_BATCH], device="cuda")
    solver = solvers["move_blocking_config1"] = make_batched_solver(ocp, cfg, dt_init=0.1)
    rec, U, obj, status, n = _open_loop_record(
        "move_blocking_config1", solver, x0s, trials, n_single, ak, False)
    calls = rec["boxqp_solve_calls"]
    if calls["per_lane_hjk"] or calls["one_shot"] != 1 or calls["one_shot"] + calls["outer"] != n:
        raise AssertionError(f"move blocking: K1 calls {calls}: expected one one-shot solve and "
                             "the outer iterations, all on shared Hd/J/K")
    Ub = U[..., 0].reshape(U.shape[0], 10, ocp.N // 10)
    spread = (Ub - Ub[..., :1]).abs().amax(dim=(1, 2))
    free_ocp, free_cfg = flagship(N=50)
    _, obj_free, st_free, _ = make_batched_solver(free_ocp, free_cfg, dt_init=0.1)(x0s)
    torch.cuda.synchronize()
    gap = obj.double() - obj_free.double()
    rec.update(nz=ocp.nz, nc=ocp.nc, blocks=10, max_in_block_spread=float(spread.max()),
               min_objective_gap_vs_unblocked=float(gap.min()),
               mean_objective_gap_vs_unblocked=float(gap.mean()),
               unblocked_converged_frac=float((st_free == 1).float().mean()))
    log(f"move blocking: {json.dumps(rec)}")
    if not float(spread.max()) <= BLOCK_TOL:
        raise AssertionError(f"move blocking: controls differ inside a block by {float(spread.max()):.3e}")
    if not float(gap.min()) >= -1e-5:
        raise AssertionError(f"move blocking: objective below the unblocked one by {-float(gap.min()):.3e}")
    launches["move_blocking_config1"] = n
    recs["move_blocking_config1"] = rec
    return launches, recs, solvers


def phase_hs_closed_loop():
    """Config 6 under MPC (``entry.rollouts_hs``: 10 SQP iterations a step)
    for HS_CL_BATCH rollouts of 40 steps against the simulated Van der Pol,
    through ``make_batched_closed_loop``. Gates: K1 at every step == that
    step's lock-step SQP iterations > 0, Hd/J/K per lane on every call;
    every u finite; the usable-step fraction of the first 64 rollouts no
    lower than the JAX package's own float32 run of them
    (``tools/config6_calibration.py``); max |u_fused - u_plain| <= 1e-3 over
    the first HS_CL_PLAIN_STEPS steps of the same batch and over the first
    HS_CL_PLAIN_ALL_STEPS steps of its first HS_CL_PLAIN_LANES rollouts (plain =
    ``backend='plain'``). Returns (K1 launches, record)."""
    from control_box_rst_tpu_torch.entry import rollouts_hs
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_closed_loop

    ctrl, plant, T, dt = rollouts_hs(N=20)
    x0s = torch.as_tensor(hs_x0s(HS_CL_BATCH), device="cuda")
    if ctrl.hoisted.Jm is not None or ctrl.sqp_cfg.qp.backend != "fused":
        raise AssertionError("config 6 closed loop: expected nothing hoisted, the fused backend")
    make_batched_closed_loop(ctrl, plant, 2, dt)(x0s[:256])  # warm-up
    roll = make_batched_closed_loop(ctrl, plant, T, dt)
    calls, restore = catch_steps_and_boxqp_calls(ak, T, keep_step=-2)
    ak.reset_launch_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = roll(x0s)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        n_launch = ak.LAUNCHES["boxqp_solve"]
    finally:
        restore()
    lock = res.info["sqp_iters"].amax(dim=0)
    log(f"config 6 closed loop: boxqp_solve launched {n_launch} time(s), by step "
        f"{calls['by_step']}, lock-step SQP iterations {lock.tolist()}")
    if calls["by_step"] != lock.tolist() or n_launch != int(lock.sum()) or n_launch <= 0 \
            or min(calls["by_step"]) <= 0:
        raise AssertionError("config 6 closed loop: K1 launches by step differ from the lock-step "
                             "SQP iterations")
    if calls["per_lane_hjk_calls"] != n_launch or calls["kst"] != {21}:
        raise AssertionError(f"config 6 closed loop: K1 calls {calls['per_lane_hjk_calls']} per lane "
                             f"of {n_launch}, horizons {calls['kst']}")
    if not bool(torch.isfinite(res.u).all()) or not bool(torch.isfinite(res.x_true).all()):
        raise AssertionError("config 6 closed loop: non-finite u or x")
    usable_ref = float(res.ok[:HS_CL_REF_LANES].float().mean())
    if usable_ref < HS_CL_REF_USABLE:
        raise AssertionError(f"config 6 closed loop: usable fraction of the first {HS_CL_REF_LANES} "
                             f"rollouts {usable_ref:.4f} < the reference's {HS_CL_REF_USABLE}")
    plain_ctrl = ctrl.replace(cfg=ctrl.cfg.replace(qp=ctrl.cfg.qp.replace(backend="plain")))
    ak.reset_launch_counts()
    t1 = time.perf_counter()
    res_p = make_batched_closed_loop(plain_ctrl, plant, HS_CL_PLAIN_STEPS, dt)(x0s)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    if ak.LAUNCHES["boxqp_solve"]:
        raise AssertionError("config 6 closed loop: the plain backend launched K1")
    u_dev = float((res.u[:, :HS_CL_PLAIN_STEPS] - res_p.u).abs().max())
    if not u_dev <= ERR_GATE:
        raise AssertionError(f"config 6 closed loop: max |u_fused - u_plain| {u_dev:.3e} > {ERR_GATE}")
    # the warm-started later steps too, on the first rollouts
    t1 = time.perf_counter()
    T_all = HS_CL_PLAIN_ALL_STEPS
    res_q = make_batched_closed_loop(plain_ctrl, plant, T_all, dt)(x0s[:HS_CL_PLAIN_LANES])
    torch.cuda.synchronize()
    plain_all_s = time.perf_counter() - t1
    if ak.LAUNCHES["boxqp_solve"]:
        raise AssertionError("config 6 closed loop: the plain backend launched K1")
    u_dev_all = float((res.u[:HS_CL_PLAIN_LANES, :T_all] - res_q.u).abs().max())
    if not u_dev_all <= ERR_GATE:
        raise AssertionError(f"config 6 closed loop: max |u_fused - u_plain| over {T_all} steps of "
                             f"the first {HS_CL_PLAIN_LANES} rollouts {u_dev_all:.3e} > {ERR_GATE}")

    x1 = x0s[:1]
    c1 = ctrl.init_carry(x1)
    lats = []
    for k in range(T):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c1, out = ctrl.step(c1, x1, k * dt, dt)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t2)
        x1 = plant.step(x1, torch.where(out.ok[:, None], out.u, torch.zeros_like(out.u)), dt)
    rec = dict(
        batch=HS_CL_BATCH, t_steps=T, dt=dt, rollouts_per_s=HS_CL_BATCH / s,
        mpc_steps_per_s=HS_CL_BATCH * T / s, rollout_batch_ms=s * 1e3,
        usable_step_frac=float(res.ok.float().mean()), usable_step_frac_first64=usable_ref,
        boxqp_solve_launches=n_launch, lock_step_sqp_iters=lock.tolist(),
        mean_sqp_iters=float(res.info["sqp_iters"].float().mean()),
        max_u_dev_vs_plain=u_dev, plain_steps=HS_CL_PLAIN_STEPS, plain_rollout_s=plain_s,
        max_u_dev_vs_plain_all_steps=u_dev_all, plain_all_steps_lanes=HS_CL_PLAIN_LANES,
        plain_all_steps=T_all,
        plain_all_steps_rollout_s=plain_all_s,
        mean_final_state_norm=float(res.x_true[:, -1].norm(dim=-1).mean()),
        p50_single_step_ms=float(np.percentile(lats, 50) * 1e3),
        p99_single_step_ms=float(np.percentile(lats, 99) * 1e3),
        kernel_route=dict(ak.LAUNCH_INFO["boxqp_solve"]),
    )
    log(json.dumps({"hs_closed_loop": rec}))
    return n_launch, rec


def _switch_contract(label, res, S, gamma):
    """local_active = (x̂ᵀ S x̂ ≤ γ), latched once entered, on every lane and
    step."""
    xo = res.x_observed
    inside = torch.einsum("btI,IJ,btJ->bt", xo, S, xo) <= gamma
    want = torch.cummax(inside.to(torch.int32), dim=1).values.bool()
    if not torch.equal(res.info["local_active"], want):
        bad = int((res.info["local_active"] != want).sum())
        raise AssertionError(f"{label}: local_active breaks the latched switch contract on {bad} lane-steps")


def phase_dual_mode():
    """Config 5 of ``examples/config5_kalman_dual_mode.yaml``
    (``entry.kalman_dual_mode``: N=30, T=60, the first state measured with
    noise of std 0.02 from a seeded ``torch.Generator``, a steady-state
    Kalman filter, MPC handing over to an LQR inside xᵀx ≤ 0.09, latched)
    for DM_BATCH rollouts through ``make_batched_closed_loop``. Gates: K1 at
    every step on one hoisted copy of Hd/J/K (launches == the sum over steps
    of the lock-step SQP iterations > 0, no call with per-lane Hd/J/K); the
    switch contract on every lane and step; u finite; on the steps where MPC
    acts |u| - 1 <= DM_BOX_GATE (twice the JAX package's own float32 run,
    ``tools/config6_calibration.py``); a noise-free copy of the batch: every
    lane in the local mode at the end with |x_T| < 5e-2, the contract, the
    box gate. Returns (K1 launches, record)."""
    from control_box_rst_tpu_torch.entry import kalman_dual_mode
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_closed_loop

    ctrl, plant, T, dt, obs = kalman_dual_mode(N=30)
    x0s = torch.as_tensor(dual_mode_x0s(DM_BATCH), device="cuda")
    mpc = ctrl.global_controller
    if mpc.hoisted.Jm is None or mpc.hoisted.Jm.dim() != 3 or mpc.sqp_cfg.qp.backend != "fused":
        raise AssertionError("dual mode: expected one hoisted J/K/Hd and the fused backend")
    make_batched_closed_loop(ctrl, plant, 2, dt, observer=obs)(
        x0s[:256], generator=torch.Generator(device="cuda").manual_seed(0))  # warm-up
    roll = make_batched_closed_loop(ctrl, plant, T, dt, observer=obs)
    S, gamma = ctrl.S, ctrl.gamma
    out = {}
    for label, noisy in (("noisy", True), ("noise_free", False)):
        gen = torch.Generator(device="cuda").manual_seed(DM_SEED)
        r = roll if noisy else make_batched_closed_loop(
            ctrl, plant.replace(output_noise=None), T, dt, observer=obs)
        calls, restore = catch_boxqp_calls(ak)
        ak.reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = r(x0s, generator=gen)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            n_launch = ak.LAUNCHES["boxqp_solve"]
        finally:
            restore()
        lock = res.info["sqp_iters"].amax(dim=0)
        if n_launch <= 0 or n_launch != int(lock.sum()) or calls["one_shot"] != T \
                or calls["per_lane_hjk_calls"]:
            raise AssertionError(f"dual mode ({label}): {n_launch} K1 launches, calls {calls}, "
                                 f"lock-step {lock.tolist()}")
        _switch_contract(f"dual mode ({label})", res, S, gamma)
        if not bool(torch.isfinite(res.u).all()):
            raise AssertionError(f"dual mode ({label}): non-finite u")
        la = res.info["local_active"]
        over = (res.u[..., 0].abs() - 1.0)[~la]
        over_max = float(over.max()) if over.numel() else -1.0
        over64 = (res.u[:64, :, 0].abs() - 1.0)[~la[:64]]
        over64_max = float(over64.max()) if over64.numel() else -1.0
        if not over_max <= DM_BOX_GATE:
            raise AssertionError(f"dual mode ({label}): |u| - 1 = {over_max:.3e} on an MPC step "
                                 f"> {DM_BOX_GATE:.3e}")
        x_T = res.x_true[:, -1].norm(dim=-1)
        first = torch.where(la.any(dim=1), la.to(torch.int8).argmax(dim=1), torch.full_like(x_T, T, dtype=torch.int64))
        out[label] = dict(
            batch=DM_BATCH, t_steps=T, rollouts_per_s=DM_BATCH / s, rollout_batch_ms=s * 1e3,
            boxqp_solve_launches=n_launch, one_shot_calls=calls["one_shot"],
            outer_calls=calls["outer"], lock_step_sqp_iters=lock.tolist(),
            local_at_end_frac=float(la[:, -1].float().mean()),
            mean_switch_step=float(first.float().mean()),
            local_step_frac=float(la.float().mean()), usable_step_frac=float(res.ok.float().mean()),
            max_u_over_box_on_mpc_steps=over_max, max_u_over_box_first64=over64_max,
            max_final_state_norm=float(x_T.max()), mean_final_state_norm=float(x_T.mean()),
            max_u_on_local_steps=float(res.u[la].abs().max()) if bool(la.any()) else 0.0,
        )
        if not noisy:
            if not bool(la[:, -1].all()) or not float(x_T.max()) < 5e-2:
                raise AssertionError(f"dual mode (noise free): local at the end on "
                                     f"{float(la[:, -1].float().mean()):.4f} of lanes, max |x_T| "
                                     f"{float(x_T.max()):.3e}")
        else:
            noise = (res.y[..., 0] - res.x_true[:, :-1, 0]).std()
            out[label]["output_noise_std"] = float(noise)
        log(f"dual mode ({label}): {json.dumps(out[label])}")
    out["box_gate"] = DM_BOX_GATE
    return out["noisy"]["boxqp_solve_launches"], out


def phase_bcr(u_scan, scan_s):
    """Block cyclic reduction in the plain ADMM: the constrained double
    integrator by SQP (``entry.constrained_di``, general rows, so the plain
    ADMM), ``linsolver='bcr'`` against 'scan' at B=4096 (scan's solve is the
    ip phase's, ``u_scan`` in ``scan_s`` seconds) and at B=1 (lane 0). Gates:
    max |U_bcr - U_scan| <= 1e-4 at both sizes, converged >= 0.99, no kernel
    launched. Returns the record."""
    from control_box_rst_tpu_torch.entry import constrained_di
    from control_box_rst_tpu_torch.ocp.problem import Trajectory
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
    from control_box_rst_tpu_torch.solvers import sqp_solve
    from control_box_rst_tpu_torch.solvers.sqp import resolve_qp_backend

    di, sqp_cfg, _, _ = constrained_di()
    scfg = resolve_qp_backend(sqp_cfg, di.ng, "cuda", torch.float32)
    cfgs = {ls: scfg.replace(qp=scfg.qp.replace(linsolver=ls)) for ls in ("scan", "bcr")}
    xd = torch.as_tensor(constrained_di_x0s(), device="cuda")

    def solve(x, ls):
        o = di.replace(bc=di.bc.replace(x0=x))
        traj0 = Trajectory.linear_interp(x, torch.zeros(2, device="cuda"), di.N, di.nu, DI_DT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = sqp_solve(o, traj0, cfgs[ls])
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    ak.reset_launch_counts()
    bk.reset_launch_counts()
    r_bcr, bcr_s = solve(xd, "bcr")
    r1 = {ls: solve(xd[:1], ls) for ls in ("scan", "bcr")}
    if any(ak.LAUNCHES.values()) or any(bk.LAUNCHES.values()):
        raise AssertionError(f"bcr: a kernel was launched ({ak.LAUNCHES}, {bk.LAUNCHES})")
    d_batch = float((r_bcr.traj.U - u_scan).abs().max())
    d_one = float((r1["bcr"][0].traj.U - r1["scan"][0].traj.U).abs().max())
    conv = float((r_bcr.status == 1).float().mean())
    rec = dict(batch=DI_BATCH, scan_batch_ms=scan_s * 1e3, bcr_batch_ms=bcr_s * 1e3,
               scan_single_ms=r1["scan"][1] * 1e3, bcr_single_ms=r1["bcr"][1] * 1e3,
               max_u_bcr_vs_scan=d_batch, max_u_bcr_vs_scan_single=d_one,
               bcr_converged_frac=conv, bcr_max_sqp_iters=int(r_bcr.iterations.max()))
    log(json.dumps({"bcr": rec}))
    if not (d_batch <= BCR_TOL and d_one <= BCR_TOL):
        raise AssertionError(f"bcr: max |U_bcr - U_scan| {d_batch:.3e} (B={DI_BATCH}), "
                             f"{d_one:.3e} (B=1) > {BCR_TOL}")
    if conv < CONV_GATE:
        raise AssertionError(f"bcr: converged_frac {conv:.4f} < {CONV_GATE}")
    return rec


def profile_new_paths(grid_solvers, x0s_main_np):
    """``phase_profile`` of one batch of each path of this slice: config 6
    open loop on both grids and move blocking (eager kernels per lock-step
    SQP iteration), 5 steps of config 6 under MPC and 10 steps of the
    Kalman / dual-mode loop (eager kernels per MPC step)."""
    from control_box_rst_tpu_torch.entry import kalman_dual_mode, rollouts_hs
    from control_box_rst_tpu_torch.parallel import make_batched_closed_loop

    hs = hs_x0s(HS_BATCH)
    prof = phase_profile({k: (v, HS_BATCH) for k, v in grid_solvers.items() if k != "move_blocking_config1"}, hs)
    prof.update(phase_profile(
        {"move_blocking_config1": (grid_solvers["move_blocking_config1"], MB_BATCH)}, x0s_main_np))
    ctrl, plant, _, dt = rollouts_hs(N=20)
    prof.update(phase_profile(
        {"hs_closed_loop_5_steps": (make_batched_closed_loop(ctrl, plant, 5, dt), HS_CL_BATCH)}, hs))
    ctrl, plant, _, dt, obs = kalman_dual_mode(N=30)
    prof.update(phase_profile(
        {"dual_mode_10_steps": (make_batched_closed_loop(ctrl, plant, 10, dt, observer=obs), DM_BATCH)},
        dual_mode_x0s(DM_BATCH)))
    for name, p in prof.items():
        k1 = [v for k, v in p["own_kernels"].items() if "boxqp_solve" in k]
        if len(k1) != 1:
            raise AssertionError(f"{name}: the profiler saw {list(p['own_kernels'])}")
        p["k1_launches"] = k1[0]["launches"]
        steps = 5 if name.startswith("hs_closed") else 10 if name.startswith("dual") else None
        per = steps or k1[0]["launches"]
        p["eager_kernels_per_" + ("mpc_step" if steps else "sqp_iteration")] = (
            p["n_device_kernels"] - k1[0]["launches"]) / per
    return prof


def k1_build_record(rec, launches):
    """The kernels-line entry of one of K1's other builds ((6, 4), (5, 2),
    (5, 3)) from its kernel-phase record."""
    nz, nc = rec["nz"], rec["nc"]
    return dict(
        name=f"boxqp_solve[nz{nz}_nc{nc}]", route="cuda",
        source="control_box_rst_tpu_torch/csrc/admm_kernel.cu",
        replaces="control_box_rst_tpu/ops/pallas/admm_kernel.py:483",
        launches=launches, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
        plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        library_ms=None, on_main_path=True, batch=rec["batch"], Kst=rec["Kst"], nz=nz, nc=nc,
        alone_ms=rec["alone_ms"], launch=rec["launch"], ptxas=rec["ptxas"],
        err_vs_f64=rec["err_vs_f64"], plain_err_vs_f64=rec["plain_err_vs_f64"],
        same_it_frac=rec["same_it_frac"], mean_rounds=rec["mean_rounds"],
        smem_bytes_per_lane=rec["smem_bytes_per_lane"],
    )

# --------------------------------------------------------------------------
# phase master: the config loader and the master CLI
# --------------------------------------------------------------------------

MASTER_EXAMPLES = {
    "config1": "config1_double_integrator.yaml",
    "config2": "config2_van_der_pol_ms.yaml",
    "config3": "config3_time_optimal.yaml",
    "config4": "config4_nonuniform_time_optimal.yaml",
    "config5": "config5_kalman_dual_mode.yaml",         # with its output noise
    "config5_noise0": "config5_kalman_dual_mode.yaml",  # noise set to 0: against the golden
    "config6": "config6_hermite_simpson.yaml",
}
MASTER_GOLDEN = ROOT / "tests" / "golden" / "torch_master_examples.npz"
MASTER_SOLVERS_GOLDEN = ROOT / "tests" / "golden" / "torch_master_solvers.npz"
MASTER_ZOO_GOLDEN = ROOT / "tests" / "golden" / "torch_master_zoo.npz"
MASTER_GRID = 64         # x01 x x02 points of the batched config-1 run: 4096 rollouts
MASTER_BATCH_TRIALS = 3  # the batched run: best of MASTER_BATCH_TRIALS
MASTER_PLAIN_STEPS = 10  # steps of the batched run also run by the plain backend
MASTER_SOLVER_STEPS = 10  # steps of config 1 by IP and by LM
MASTER_PART_TOL = 0.05   # a control this far from the golden's is another decision
                         # (tools/master_golden.py's PART_TOL)
MASTER_GATE_FLOOR = 1e-3  # the golden gate: max(2 x the reference's own float32, this)
# the box-QP builds that only the loader's zoo launches, and its system that
# launches each: the parallel integrators (two controls: nz 5, nc 2) and the
# free-space rocket (three states: nz 5, nc 3)
ZOO_K1_BUILDS = {(5, 2): "parallel_integrators", (5, 3): "free_space_rocket"}
ZOO_K1_BATCH = 4096  # lanes of those systems' first-iteration QPs in the kernel phase


def catch_master_run():
    """Patch what a master run goes through, to read it back: the solves'
    lock-step iterations by kind (sqp, ip, lm; the benchmarks' timed SQP
    solves included) and call by call (``iters``), the SQP statuses, and the results the run records (the ClosedLoopResult of a closed loop, the
    ControlOutput of an open loop). Returns (record, restore)."""
    from control_box_rst_tpu_torch import sim
    from control_box_rst_tpu_torch.control import predictive
    from control_box_rst_tpu_torch.sim import benchmarks

    rec = dict(sqp=0, ip=0, lm=0, calls=0, status=[], feas=[], results=[], iters=[])
    patched = []

    def wrap(mod, name, fn):
        real = getattr(mod, name)
        patched.append((mod, name, real))
        setattr(mod, name, fn(real))

    def solve(kind):
        def make(real):
            def run(*args, **kw):
                res = real(*args, **kw)
                rec[kind] += int(res.iterations.max())
                rec["iters"].append(int(res.iterations.max()))
                rec["calls"] += 1
                if kind == "sqp":
                    rec["status"].append(int(res.status.reshape(-1)[0]))
                rec["feas"].append(float(res.feas_res.max()))
                return res
            return run
        return make

    def keep(real):
        def run(*args, **kw):
            out = real(*args, **kw)
            rec["results"].append(out)
            return out
        return run

    for kind in ("sqp", "ip", "lm"):
        wrap(predictive, f"{kind}_solve", solve(kind))
    wrap(benchmarks, "sqp_solve", solve("sqp"))
    for name in ("run_closed_loop", "run_open_loop"):
        wrap(sim, name, keep)
    wrap(benchmarks, "benchmark_varying_initial_state", keep)

    def restore():
        for mod, name, real in reversed(patched):
            setattr(mod, name, real)

    return rec, restore


def _read_tsv(path: pathlib.Path) -> np.ndarray:
    return np.loadtxt(path, delimiter="\t", ndmin=2)


def _golden_distance(label, u, x, gold, key, gates=True):
    """max |u − u_golden| and |x − x_golden| over the steps before the
    reference's own float32 run parts from its float64 one, the gates
    max(2 x the reference's own float32 distance, MASTER_GATE_FLOOR) on both,
    and the first step at which the port's float32 controls part from the
    golden's (reported)."""
    u64, x64 = gold[f"{key}/u"], gold[f"{key}/x"]
    if u.shape != u64.shape or x.shape != x64.shape:
        raise AssertionError(f"{label}: shapes {u.shape}, {x.shape} against the golden's "
                             f"{u64.shape}, {x64.shape}")
    part = int(gold[f"{key}/part_step"])
    du = np.abs(u - u64).reshape(len(u), -1).max(axis=1)
    dx = np.abs(x - x64).reshape(len(x), -1).max(axis=1)
    parted = np.nonzero(du > MASTER_PART_TOL)[0]
    gate_u = max(2.0 * float(gold[f"{key}/ref_f32_u"]), MASTER_GATE_FLOOR)
    gate_x = max(2.0 * float(gold[f"{key}/ref_f32_x"]), MASTER_GATE_FLOOR)
    out = dict(
        gated_steps=part, ref_part_step=part,
        port_part_step=int(parted[0]) if parted.size else len(u),
        max_u_err=float(du[:part].max()) if part else 0.0,
        max_x_err=float(dx[:part + 1].max()),
        gate_u=gate_u, gate_x=gate_x,
        ref_f32_u=float(gold[f"{key}/ref_f32_u"]), ref_f32_x=float(gold[f"{key}/ref_f32_x"]),
        max_u_err_all_steps=float(du.max()), max_x_err_all_steps=float(dx.max()),
    )
    if gates and not (out["max_u_err"] <= gate_u and out["max_x_err"] <= gate_x):
        raise AssertionError(f"{label}: {json.dumps(out)} misses the golden gate")
    return out


def _master_example(name, tmp, gold):
    """One example YAML through ``master.main`` (in this process, so that
    the launch counters and the catch see it). Returns its record."""
    import yaml

    from control_box_rst_tpu_torch import master
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk

    path = ROOT / "examples" / MASTER_EXAMPLES[name]
    cfg = yaml.safe_load(path.read_text())
    if name == "config5_noise0":
        cfg["plant"]["noise"] = {"output_std": 0.0}
        path = tmp / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
    out = tmp / name
    calls, restore = catch_master_run()
    ak.reset_launch_counts()
    bk.reset_launch_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = master.main(["--config", str(path), "--out", str(out), "--format", "tsv"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = ak.LAUNCHES["boxqp_solve"]
        by_build = k1_launches_by_build(ak, f"master {name}")
    finally:
        restore()
    if rc != 0 or len(calls["results"]) != 1:
        raise AssertionError(f"master {name}: rc {rc}, {len(calls['results'])} recorded runs")
    open_loop = cfg["experiment"].get("task") == "open_loop"
    if open_loop:
        res, _ = calls["results"][0]  # one unbatched solve: no batch dim
        u, x = res.u_seq, res.x_seq
        steps, usable = 1, float(res.ok.float().mean())
        tsv_u = _read_tsv(out / "signals" / "planned_controls.tsv")[:, 1:]
    else:
        res = calls["results"][0]
        u, x = res.u[0], res.x_true[0]
        steps, usable = int(u.shape[0]), float(res.ok.float().mean())
        tsv_u = _read_tsv(out / "signals" / "applied_controls.tsv")[:, 1:]
        if int(res.info["sqp_iters"].sum()) != calls["sqp"]:
            raise AssertionError(f"master {name}: the recorded sqp_iters sum to "
                                 f"{int(res.info['sqp_iters'].sum())}, the solves to {calls['sqp']}")
    u, x = u.double().cpu().numpy(), x.double().cpu().numpy()
    if not (np.isfinite(u).all() and np.isfinite(x).all()):
        raise AssertionError(f"master {name}: non-finite controls or states")
    if not np.allclose(tsv_u, u, rtol=1e-7, atol=1e-9):
        raise AssertionError(f"master {name}: the exported controls are not the run's")
    if k1 <= 0 or k1 != calls["sqp"]:
        raise AssertionError(f"master {name}: {k1} K1 launches, lock-step SQP iterations "
                             f"{calls['sqp']}")
    rec = dict(wall_s=wall, steps=steps, mpc_steps_per_s=steps / wall, boxqp_solve_launches=k1,
               lock_step_sqp_iterations=calls["sqp"], usable_step_frac=usable,
               boxqp_solve_launches_by_build=by_build,
               files=sorted(p.name for p in (out / "signals").iterdir()))
    if name in ("config5", "config5_noise0"):
        S = torch.eye(2, device="cuda")
        _switch_contract(f"master {name}", res, S, 0.09)
        la = res.info["local_active"][0]
        over = (res.u[0, :, 0].abs() - 1.0)[~la]
        rec["max_u_over_box_on_mpc_steps"] = float(over.max()) if over.numel() else -1.0
        rec["switch_step"] = int(la.to(torch.int8).argmax()) if bool(la.any()) else steps
        if not rec["max_u_over_box_on_mpc_steps"] <= DM_BOX_GATE:
            raise AssertionError(f"master {name}: |u| - 1 = {rec['max_u_over_box_on_mpc_steps']:.3e}"
                                 f" on an MPC step > {DM_BOX_GATE:.3e}")
    if name != "config5":
        rec["golden"] = _golden_distance(f"master {name}", u, x, gold, name)
        if not open_loop:
            # no lower than the reference's own float32 run of the YAML
            ref = float(gold[f"{name}/ref_f32_usable"])
            rec["ref_f32_usable_step_frac"] = ref
            if usable < ref:
                raise AssertionError(f"master {name}: usable-step fraction {usable} < the "
                                     f"reference's own float32 run's {ref}")
    log(f"master {name}: {json.dumps(rec)}")
    return rec


def _batched_config1(tmp):
    """Config 1's YAML as ``benchmark_varying_x0`` over a MASTER_GRID² grid
    of initial states in [-1, 1]²: MASTER_GRID² rollouts of 70 steps of the
    YAML's H=50 OCP, through ``run_experiment``; gates: K1 launches == the
    sum of the lock-step SQP iterations > 0 (through the step graphs, which
    this loop takes: in the device trace of the first run (``traced``), at
    least two a step, the one-shot and one loop trip, and two more in the
    capture's warm-up; no solve through ``sqp_solve``), usable-step
    fraction >= 0.99,
    max |u_fused - u_plain| <= 1e-3 over the first MASTER_PLAIN_STEPS steps
    (plain = the same controller with backend 'plain', linsolver 'bcr')."""
    import yaml

    from control_box_rst_tpu_torch.core import config as tc
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.sim.benchmarks import benchmark_varying_initial_state
    from control_box_rst_tpu_torch.sim.step_graphs import graph_engages

    cfg = yaml.safe_load((ROOT / "examples" / MASTER_EXAMPLES["config1"]).read_text())
    grid = np.linspace(-1.0, 1.0, MASTER_GRID).tolist()
    T = int(cfg["experiment"]["T_steps"])
    cfg["experiment"] = {"task": "benchmark_varying_x0", "T_steps": T, "dt": 0.1,
                         "benchmark": {"x01": grid, "x02": grid}}
    B = MASTER_GRID * MASTER_GRID
    ctrl, system = tc.build_controller(cfg)
    plant = tc.build_plant(cfg, system)
    graphed = graph_engages(ctrl, plant, None, "cuda")
    calls, restore = catch_master_run()
    ak.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        rec_sig, k1_trace, _ = traced(lambda: tc.run_experiment(cfg))
        first_s = time.perf_counter() - t0
        by_build = k1_launches_by_build(ak, "master batch")
    finally:
        restore()
    k1 = sum(k1_trace.values())
    res, x0s = calls["results"][0]
    lock = res.info["sqp_iters"].amax(dim=0)
    if graphed:
        # the wrapper counts the calls of the warm-up and the capture; a
        # replay's launches show only in the device trace
        if len(by_build) != 1:
            raise AssertionError(f"master batch: K1 builds {by_build}")
        by_build = {b: k1 for b in by_build}
        want = 2 + int(torch.clamp(lock, min=2).sum())
    else:
        want = int(lock.sum())
    if k1 <= 0 or k1 != want or calls["sqp"] != (0 if graphed else k1):
        raise AssertionError(f"master batch: {k1} K1 launches {k1_trace}, lock-step "
                             f"{lock.tolist()}, solves {calls['sqp']}, step graphs {graphed}")
    if res.u.shape != (B, T, 1) or not bool(torch.isfinite(res.u).all()):
        raise AssertionError(f"master batch: u {tuple(res.u.shape)} or non-finite")
    if rec_sig.get("benchmark/controls")["matrices"][0].shape != (B, T, 1):
        raise AssertionError("master batch: the recorded controls have the wrong shape")
    usable = float(res.ok.float().mean())
    if usable < CONV_GATE:
        raise AssertionError(f"master batch: usable-step fraction {usable:.4f} < {CONV_GATE}")
    best = min(first_s, _best_of(lambda: tc.run_experiment(cfg), MASTER_BATCH_TRIALS - 1))
    # the same rollouts' first steps by the plain backend (no kernel), its
    # block-tridiagonal solves by cyclic reduction: the plain ADMM's stage
    # loop ('scan') took 346 s for these 10 steps on the card (8 SQP
    # iterations of 200 ADMM iterations a step, eager kernels)
    plain = ctrl.replace(cfg=ctrl.cfg.replace(
        qp=ctrl.cfg.qp.replace(backend="plain", linsolver="bcr")))
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    res_p, _ = benchmark_varying_initial_state(plant, plain, grid, grid, MASTER_PLAIN_STEPS, 0.1)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if ak.LAUNCHES["boxqp_solve"]:
        raise AssertionError("master batch: the plain backend launched the box-QP kernel")
    dev = float((res.u[:, :MASTER_PLAIN_STEPS] - res_p.u).abs().max())
    if not dev <= ERR_GATE:
        raise AssertionError(f"master batch: max |u_fused - u_plain| {dev:.3e} > {ERR_GATE}")
    x_T = res.x_true[:, -1].norm(dim=-1)
    out = dict(batch=B, t_steps=T, rollouts_per_s=B / best, mpc_steps_per_s=B * T / best,
               rollout_batch_s=best, first_batch_s=first_s, boxqp_solve_launches=k1,
               boxqp_solve_launches_by_build=by_build, step_graphs=graphed,
               lock_step_sqp_iters=lock.tolist(), mean_sqp_iters=float(res.info["sqp_iters"].float().mean()),
               usable_step_frac=usable, max_u_fused_vs_plain=dev, plain_steps=MASTER_PLAIN_STEPS,
               plain_s=plain_s, mean_final_state_norm=float(x_T.mean()),
               max_final_state_norm=float(x_T.max()))
    log(f"master batch: {json.dumps(out)}")
    return out


def _master_solvers(tmp, gold):
    """Config 1's YAML with ``solver: {type: ip}`` and ``{type: lm}``,
    MASTER_SOLVER_STEPS steps at B=1 through ``run_experiment``: K4 launches
    == the lock-step iterations > 0, u finite, IP's |u| <= 1 + 1e-6; the
    distance to the golden reported beside the reference's own float32's.
    Then one ``benchmark_increasing_n`` task (N 10, 20, 40), reported."""
    import yaml

    from control_box_rst_tpu_torch.core import config as tc
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk

    base = yaml.safe_load((ROOT / "examples" / MASTER_EXAMPLES["config1"]).read_text())
    out = {}
    for kind in ("ip", "lm"):
        cfg = copy.deepcopy(base)
        cfg["experiment"]["T_steps"] = MASTER_SOLVER_STEPS
        cfg["solver"] = {"type": kind}
        calls, restore = catch_master_run()
        bk.reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tc.run_experiment(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k4 = bk.LAUNCHES["btridiag_factor_solve_inplace"]
        finally:
            restore()
        res = calls["results"][0]
        u, x = res.u[0].double().cpu().numpy(), res.x_true[0].double().cpu().numpy()
        if k4 <= 0 or k4 != calls[kind] or int(res.info["sqp_iters"].sum()) != calls[kind]:
            raise AssertionError(f"master {kind}: {k4} K4 launches, lock-step {calls[kind]}")
        if not np.isfinite(u).all():
            raise AssertionError(f"master {kind}: non-finite u")
        if kind == "ip" and not float(np.abs(u).max()) <= 1.0 + 1e-6:
            raise AssertionError(f"master ip: |u| = {float(np.abs(u).max())} > 1 + 1e-6")
        out[kind] = dict(
            wall_s=wall, steps=MASTER_SOLVER_STEPS, mpc_steps_per_s=MASTER_SOLVER_STEPS / wall,
            btridiag_factor_solve_inplace_launches=k4, lock_step_iterations=calls[kind],
            usable_step_frac=float(res.ok.float().mean()), max_abs_u=float(np.abs(u).max()),
            golden=_golden_distance(f"master {kind}", u, x, gold, f"config1_{kind}", gates=False))
        log(f"master {kind}: {json.dumps(out[kind])}")
    cfg = copy.deepcopy(base)
    cfg["experiment"] = {"task": "benchmark_increasing_n", "dt": 0.1,
                         "benchmark": {"N_values": [10, 20, 40]}}
    calls, restore = catch_master_run()
    ak.reset_launch_counts()
    try:
        rec = tc.run_experiment(cfg)
        torch.cuda.synchronize()
        k1 = ak.LAUNCHES["boxqp_solve"]
        by_build = k1_launches_by_build(ak, "master increasing N")
    finally:
        restore()
    if k1 <= 0 or k1 != calls["sqp"]:
        raise AssertionError(f"master increasing N: {k1} K1 launches, lock-step {calls['sqp']}")
    get = lambda n: rec.get(f"benchmark/{n}")["matrices"][0].tolist()
    out["increasing_n"] = dict(n_values=get("n_values"), solve_times_s=get("solve_times"),
                               objectives=get("objectives"), status=get("status"),
                               boxqp_solve_launches=k1,
                               boxqp_solve_launches_by_build=by_build)
    log(f"master increasing N: {json.dumps(out['increasing_n'])}")
    return out


def _master_zoo():
    """One open-loop task of each of the twelve registered systems through
    ``run_experiment`` (the configs stored in the zoo golden): U finite;
    where the reference's float64 solve converged, |U - U_golden| <=
    max(2 x the reference's own float32 distance, MASTER_GATE_FLOOR); the
    SQP status, iterations and K1 launches (== the iterations) reported."""
    from control_box_rst_tpu_torch.core import config as tc
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

    gold = np.load(MASTER_ZOO_GOLDEN)
    names = sorted({k.split("/")[0] for k in gold.files})
    out = {}
    for name in names:
        cfg = json.loads(str(gold[f"{name}/config"]))
        calls, restore = catch_master_run()
        ak.reset_launch_counts()
        try:
            rec = tc.run_experiment(cfg)
            torch.cuda.synchronize()
            k1 = ak.LAUNCHES["boxqp_solve"]
            by_build = k1_launches_by_build(ak, f"master zoo {name}")
        finally:
            restore()
        U = np.asarray(rec.get("planned_controls")["values"], dtype=np.float64)
        X = np.asarray(rec.get("planned_states")["values"], dtype=np.float64)
        if not (np.isfinite(U).all() and np.isfinite(X).all()):
            raise AssertionError(f"master zoo {name}: non-finite U or X")
        if k1 <= 0 or k1 != calls["sqp"]:
            raise AssertionError(f"master zoo {name}: {k1} K1 launches, lock-step {calls['sqp']}")
        converged = bool(gold[f"{name}/converged"])
        err = float(np.abs(U - gold[f"{name}/u"]).max())
        gate = max(2.0 * float(gold[f"{name}/ref_f32_u"]), MASTER_GATE_FLOOR)
        out[name] = dict(status=calls["status"][0], sqp_iterations=calls["sqp"],
                         feas_res=calls["feas"][0], boxqp_solve_launches=k1,
                         boxqp_solve_launches_by_build=by_build,
                         max_u_err=err, gate=gate if converged else None,
                         ref_f32_u=float(gold[f"{name}/ref_f32_u"]))
        if converged and not err <= gate:
            raise AssertionError(f"master zoo {name}: |U - U_golden| {err:.3e} > {gate:.3e}")
    log(f"master zoo: {json.dumps(out)}")
    return out


def phase_master():
    """The config loader and the master CLI (``core/config.py``,
    ``master.py``) on the card, float32: (1) the six example YAMLs at their
    own settings through ``master.main``, config 5 twice (with its noise:
    the switch contract and the box gate; with noise 0: the golden), each
    against the float64 golden of ``tools/master_golden.py`` on the steps
    before the reference's own float32 run parts from it; (2) config 1 as a
    batch of 4096 rollouts; (3) config 1 by IP and by LM, and a horizon
    sweep; (4) the twelve systems of the zoo. Returns (K1 launches by path,
    K4 launches by path, K1 launches by path and build, record). Every example's
    usable-step fraction is no lower than the reference's own float32 run's
    (stored in the golden)."""
    import tempfile

    gold = np.load(MASTER_GOLDEN)
    solvers_gold = np.load(MASTER_SOLVERS_GOLDEN)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        examples = {name: _master_example(name, tmp, gold) for name in MASTER_EXAMPLES}
        examples_s = time.perf_counter() - t_phase
        batch = _batched_config1(tmp)
        solvers = _master_solvers(tmp, solvers_gold)
    zoo = _master_zoo()
    runs = {f"master_{n}": r for n, r in examples.items()}
    runs.update(master_batch_config1=batch, master_increasing_n=solvers["increasing_n"],
                **{f"master_zoo_{n}": r for n, r in zoo.items()})
    k1_paths, k1_builds = {}, {}
    for name, r in runs.items():
        path = "master_zoo" if name.startswith("master_zoo_") else name
        k1_paths[path] = k1_paths.get(path, 0) + r["boxqp_solve_launches"]
        builds = k1_builds.setdefault(path, {})
        for b, n in r["boxqp_solve_launches_by_build"].items():
            builds[b] = builds.get(b, 0) + n
    k4_paths = {f"master_{k}": solvers[k]["btridiag_factor_solve_inplace_launches"]
                for k in ("ip", "lm")}
    rec = dict(examples=examples, examples_s=examples_s, batch=batch, solvers=solvers, zoo=zoo,
               phase_s=time.perf_counter() - t_phase)
    return k1_paths, k4_paths, k1_builds, rec


# --------------------------------------------------------------------------
# phases serve and realtime: the gRPC master service and the real-time loop
# --------------------------------------------------------------------------

SERVE_YAML = ROOT / "examples" / "config1_double_integrator.yaml"
SERVE_TOL = 1e-6       # streamed values against the in-process run
SERVE_START_S = 180    # master --serve: seconds to its first line
RT_SIM_DT = 0.005      # the threaded plant's period
RT_DURATION_S = 3.0    # the real-time loop: 30 steps at the YAML's dt of 0.1
RT_PROFILE_STEPS = 10  # --profile: B=1 steps of the real-time controller


def serve_transport() -> str:
    """How the serve phase talks to the master, decided before the phase:
    gRPC needs both ``grpc`` and ``google.protobuf`` (``comm`` imports
    both); the run fails here, by name, on a machine that lacks one."""
    import importlib.util

    missing = [m for m in ("grpc", "google.protobuf") if importlib.util.find_spec(m) is None]
    if missing:
        raise AssertionError(f"serve: {missing} not importable here; the gRPC master needs them")
    import google.protobuf
    import grpc

    return f"grpc (grpc {grpc.__version__}, protobuf {google.protobuf.__version__})"


def _stream(stream):
    """Drain a performTask stream: (store as ``MasterClient.perform_task``
    builds it, the master/progress values in order, messages, bytes)."""
    from control_box_rst_tpu_torch.comm.service import merge_signal, proto_to_signal

    store, progress, n_msgs, n_bytes = {}, [], 0, 0
    for msg in stream:
        n_msgs += 1
        n_bytes += msg.ByteSize()
        name, sig = proto_to_signal(msg)
        if name == "master/progress":
            progress.append(float(msg.values[0]))
        merge_signal(store, name, sig)
    return store, progress, n_msgs, n_bytes


def _store_distance(label, store, ref):
    """The streamed store against the recorder of an in-process run: every
    signal name of the run plus master/progress, the same kinds and shapes;
    returns the largest distance of values, times and matrices."""
    names = set(ref.names())
    if set(store) != names | {"master/progress"}:
        raise AssertionError(f"{label}: streamed {sorted(store)}, the run has {sorted(names)}")
    worst = 0.0
    for name in sorted(names):
        want, got = ref.get(name), store[name]
        if got["kind"] != want["kind"]:
            raise AssertionError(f"{label}: {name} is {got['kind']}, the run's {want['kind']}")
        pairs = [(got[k], want[k]) for k in ("values", "times") if k in want]
        pairs += list(zip(got.get("matrices", []), want.get("matrices", [])))
        for g, w in pairs:
            g, w = np.asarray(g, dtype=np.float64), np.asarray(w, dtype=np.float64)
            if g.shape != w.shape:
                raise AssertionError(f"{label}: {name} has shape {g.shape}, the run's {w.shape}")
            if g.size:
                worst = max(worst, float(np.abs(g - w).max()))
    return worst


def _serve_cli(ref):
    """``python -m control_box_rst_tpu_torch.master --serve localhost:0
    --config <config 1's YAML>`` as a subprocess on the card: its port from
    its first line, ping, performTask held to the in-process run; the
    process is terminated whatever happens."""
    import re
    import select
    import tempfile

    from control_box_rst_tpu_torch.comm import MasterClient

    with tempfile.TemporaryFile("w+", dir=ROOT / "build") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "control_box_rst_tpu_torch.master", "--serve", "localhost:0",
             "--config", str(SERVE_YAML)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            t0 = time.perf_counter()
            ready, _, _ = select.select([proc.stdout], [], [], SERVE_START_S)
            line = proc.stdout.readline() if ready else ""
            m = re.fullmatch(r"corbo_tpu master listening on localhost:(\d+)\n", line)
            if not m:
                err.seek(0)
                raise AssertionError(f"master --serve: first line {line!r}, rc {proc.poll()}, "
                                     f"stderr {err.read()[-2000:]}")
            start_s = time.perf_counter() - t0
            client = MasterClient(f"localhost:{m.group(1)}")
            try:
                if not client.ping():
                    raise AssertionError("master --serve: no answer to ping")
                t0 = time.perf_counter()
                store, progress, n_msgs, n_bytes = _stream(client.perform_task_stream())
                wall = time.perf_counter() - t0
            finally:
                client.close()
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)
    dist = _store_distance("master --serve", store, ref)
    if progress != [0.0, 1.0] or not dist <= SERVE_TOL:
        raise AssertionError(f"master --serve: progress {progress}, distance {dist:.3e}")
    return dict(start_s=start_s, perform_task_wall_s=wall, messages=n_msgs, wire_bytes=n_bytes,
                max_abs_dist_vs_run=dist,
                boxqp_solve_launches="not countable: another process")


def phase_serve(transport: str):
    """Config 1's YAML (70 steps, float32, B=1) served on the card: the
    port's ``MasterServer`` behind ``grpc.server`` on localhost:0 in this
    process and the port's ``MasterClient``: ping, set_config,
    verify_config, available_signals (the closed loop's names),
    performTask. Gates: the stream holds master/progress 0.0 then 1.0 and
    every signal of an in-process ``run_experiment(load_config(yaml),
    device="cuda")`` within SERVE_TOL; K1 launches during performTask ==
    the lock-step SQP iterations > 0. Then ``master --serve`` as a
    subprocess by the same gates (launches excepted), and ``stop``: ok()
    false, restored. Returns (K1 launches, K1 launches by build, record)."""
    from concurrent import futures

    import grpc
    import yaml

    from control_box_rst_tpu_torch.comm import MasterClient, MasterServer
    from control_box_rst_tpu_torch.core import config as tc
    from control_box_rst_tpu_torch.core.console import ok, set_ok
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

    ref = tc.run_experiment(tc.load_config(SERVE_YAML), device="cuda")
    torch.cuda.synchronize()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    master = MasterServer()  # device None: the card
    server.add_generic_rpc_handlers((master.grpc_handler(),))
    port = server.add_insecure_port("localhost:0")
    server.start()
    client = MasterClient(f"localhost:{port}")
    try:
        if not client.ping():
            raise AssertionError("serve: no answer to ping")
        st = client.set_config(yaml.safe_load(SERVE_YAML.read_text()))
        verified, text = client.verify_config()
        if not st.ok or not verified:
            raise AssertionError(f"serve: set_config {st.text!r}, verify_config {text!r}")
        avail = client.available_signals()
        closed = ("plant_output", "observed_states", "applied_controls", "plant_states")
        if not set(closed) <= set(avail):
            raise AssertionError(f"serve: available signals {sorted(avail)}")
        calls, restore = catch_master_run()
        ak.reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            store, progress, n_msgs, n_bytes = _stream(client.perform_task_stream())
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            k1 = ak.LAUNCHES["boxqp_solve"]
            by_build = k1_launches_by_build(ak, "serve")
        finally:
            restore()
        dist = _store_distance("serve", store, ref)
        res = calls["results"]
        if progress != [0.0, 1.0] or not dist <= SERVE_TOL or len(res) != 1:
            raise AssertionError(f"serve: progress {progress}, distance {dist:.3e}, "
                                 f"{len(res)} recorded runs")
        if int(res[0].info["sqp_iters"].sum()) != calls["sqp"] or k1 <= 0 or k1 != calls["sqp"]:
            raise AssertionError(f"serve: {k1} K1 launches, lock-step SQP iterations "
                                 f"{calls['sqp']}, recorded {int(res[0].info['sqp_iters'].sum())}")
        cli = _serve_cli(ref)
        try:
            client.stop()
            stopped = not ok()
        finally:
            set_ok(True)
        if not stopped:
            raise AssertionError("serve: stop left console.ok() true")
    finally:
        client.close()
        server.stop(grace=None)
    steps = int(store["applied_controls"]["values"].shape[0])
    rec = dict(transport=transport, steps=steps, perform_task_wall_s=wall,
               mpc_steps_per_s=steps / wall, messages=n_msgs, wire_bytes=n_bytes, signals=len(store),
               max_abs_dist_vs_run=dist, progress=progress, boxqp_solve_launches=k1,
               lock_step_sqp_iterations=calls["sqp"], boxqp_solve_launches_by_build=by_build,
               stop_cleared_ok=stopped, cli=cli)
    log(f"serve: {json.dumps(rec)}")
    return k1, by_build, rec


def phase_realtime(b1_step_p99_ms):
    """Config 1's YAML controller (``build_controller`` on the card, float32:
    SQP, K1 on the hoisted Hd/J/K) driving a ``SimulatedPlantThreaded`` of
    the YAML's plant (sim_dt RT_SIM_DT, on the card) through
    ``run_realtime_closed_loop`` at the YAML's dt for RT_DURATION_S, logged by
    the native ``SignalWriter``; ``PhaseTimer`` around a first controller
    call and the loop. Gates: the native runtime built; 30 steps, 30
    records, none dropped; the final |x| below the initial; every |u| <= 1 +
    1e-6; K1 launches == the SQP iterations of every controller call (the
    loop's warm-up call and its steps) > 0. Overruns are wall-clock and
    host-dependent: reported. Returns (K1 launches, by build, record,
    controller)."""
    import tempfile
    import threading

    from control_box_rst_tpu_torch import native
    from control_box_rst_tpu_torch.core import config as tc
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.sim import SimulatedPlantThreaded
    from control_box_rst_tpu_torch.sim.realtime import run_realtime_closed_loop
    from control_box_rst_tpu_torch.utils.profiling import PhaseTimer

    if not native.native_available():
        raise AssertionError("realtime: the native runtime did not build (g++)")
    cfg = tc.load_config(SERVE_YAML)
    dt = float(cfg["experiment"]["dt"])
    ctrl, system = tc.build_controller(cfg)  # the card, float32
    if ctrl.sqp_cfg.qp.backend != "fused" or ctrl.hoisted.Jm is None:
        raise AssertionError("realtime: expected the fused backend on one hoisted J/K/Hd")
    plant = tc.build_plant(cfg, system)
    x0 = np.asarray(cfg["x0"], dtype=np.float64)
    # from a helper thread: the answer, without changing this thread's policy
    prio = []
    t = threading.Thread(target=lambda: prio.append(native.set_realtime_priority(10)))
    t.start()
    t.join()
    timer = PhaseTimer()
    x = torch.as_tensor(x0, dtype=torch.float32, device="cuda")[None]
    with timer.phase("first_controller_call"):
        ctrl.step(ctrl.init_carry(x), x, 0.0, dt)[1].u.cpu()
    th = SimulatedPlantThreaded(plant, x0, sim_dt=RT_SIM_DT)  # the card, float32
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log_path = str(pathlib.Path(tmp) / "realtime_config1.bin")
        calls, restore = catch_master_run()
        ak.reset_launch_counts()
        try:
            with th:
                with timer.phase("loop"):
                    stats = run_realtime_closed_loop(ctrl, th.read_output, th.write_control, x0,
                                                     dt, RT_DURATION_S, log_path=log_path)
                x_final = th.state()
            torch.cuda.synchronize()
            k1 = ak.LAUNCHES["boxqp_solve"]
            by_build = k1_launches_by_build(ak, "realtime")
        finally:
            restore()
        ts, vals = native.read_signal_log(log_path)
    u = vals[:, 2:]
    steps_iters = calls["iters"][1:]  # the first call is the loop's warm-up
    rec = dict(
        native_available=True, steps=stats["steps"], dt=dt, sim_dt=RT_SIM_DT, records=len(ts),
        log_dropped=stats["log_dropped"], overruns=stats["overruns"],
        solve_time_mean_ms=stats["solve_time_mean_s"] * 1e3,
        solve_time_p99_ms=stats["solve_time_p99_s"] * 1e3,
        closed_loop_b1_step_p99_ms=b1_step_p99_ms, wall_s=stats["wall_s"],
        plant_thread_overruns=th.rate.overruns,
        plant_thread_periods=int(round(stats["wall_s"] / RT_SIM_DT)),
        set_realtime_priority=prio[0], x0_norm=float(np.linalg.norm(x0)),
        final_x_norm=float(np.linalg.norm(x_final)), max_abs_u=float(np.abs(u).max()),
        boxqp_solve_launches=k1, sqp_iterations_by_step=steps_iters,
        warm_up_sqp_iterations=calls["iters"][0], boxqp_solve_launches_by_build=by_build,
        phases=timer.summary(),
    )
    log(f"realtime: {json.dumps(rec)}")
    if stats["steps"] != 30 or len(ts) != 30 or stats["log_dropped"]:
        raise AssertionError(f"realtime: {stats['steps']} steps, {len(ts)} records, "
                             f"{stats['log_dropped']} dropped")
    if not rec["final_x_norm"] < rec["x0_norm"] or not rec["max_abs_u"] <= 1.0 + 1e-6:
        raise AssertionError(f"realtime: |x_T| {rec['final_x_norm']}, max |u| {rec['max_abs_u']}")
    if k1 <= 0 or k1 != sum(calls["iters"]) or len(calls["iters"]) != 31:
        raise AssertionError(f"realtime: {k1} K1 launches, SQP iterations {calls['iters']}")
    return k1, by_build, rec, ctrl


def profile_realtime(ctrl, logdir):
    """RT_PROFILE_STEPS steps of the real-time controller at B=1, back to
    back (no rate), each as ``run_realtime_closed_loop`` makes it (x[None]
    to the card, the step, u to the host) against the YAML's plant stepped
    on the host in float64, under ``utils.profiling.device_trace`` (a Chrome
    trace under ``logdir``): the device idle share and the eager kernels per
    MPC step besides K1."""
    from control_box_rst_tpu_torch.core import config as tc
    from control_box_rst_tpu_torch.utils.profiling import device_trace

    cfg = tc.load_config(SERVE_YAML)
    dt = float(cfg["experiment"]["dt"])
    _, system = tc.build_controller(cfg, dtype=torch.float64, device="cpu")
    plant = tc.build_plant(cfg, system, dtype=torch.float64, device="cpu")
    x0 = torch.as_tensor(cfg["x0"], dtype=torch.float64)[None]

    def steps():
        x, carry = x0, ctrl.init_carry(x0.to("cuda", torch.float32))
        for k in range(RT_PROFILE_STEPS):
            carry, out = ctrl.step(carry, x.to("cuda", torch.float32), k * dt, dt)
            x = plant.step(x, out.u.to("cpu", torch.float64), dt)
        return x

    steps()
    torch.cuda.synchronize()
    with device_trace(logdir) as prof:
        t0 = time.perf_counter()
        steps()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rec = profile_record(prof, wall_ms)
    k1 = [v for k, v in rec["own_kernels"].items() if "boxqp_solve" in k]
    if len(k1) != 1:
        raise AssertionError(f"realtime profile: the profiler saw {list(rec['own_kernels'])}")
    rec.update(mpc_steps=RT_PROFILE_STEPS, sqp_iterations=k1[0]["launches"],
               eager_kernels_per_mpc_step=(rec["n_device_kernels"] - k1[0]["launches"])
               / RT_PROFILE_STEPS,
               step_ms=wall_ms / RT_PROFILE_STEPS)
    return rec


MESH_RANKS = 2          # ranks that share the one card in part (b)
MESH_GRID = 64          # the sharded sweep: a 64 x 64 grid of x0, 4096 rollouts
MESH_STEPS = 5          # its MPC steps
MESH_NOISE_STD = 0.01   # its plant's state noise, from a generator seeded with MESH_SEED
MESH_SEED = 11
MESH_RANK_TIMEOUT_S = 300  # part (b): all ranks, CUDA context and library loads included
MESH_SWEEP_FIELDS = ("ts", "x_true", "y", "x_observed", "u", "ok")


def mesh_sweep(mesh=None):
    """``benchmark_varying_initial_state`` on config 5's controller and plant
    (``entry.rollouts``, the closed_loop phase's) with state noise, over the
    MESH_GRID x MESH_GRID grid of x0 in [-1, 1]^2 for MESH_STEPS steps, on
    the card, the generator seeded with MESH_SEED; sharded over ``mesh``
    when one is given. Returns (the result's fields as numpy arrays of this
    rank's lanes or of the whole batch, the call's wall seconds, construction
    included, K1 launches)."""
    from control_box_rst_tpu_torch.entry import rollouts
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.sim import GaussianNoise
    from control_box_rst_tpu_torch.sim.benchmarks import benchmark_varying_initial_state

    ctrl, plant, _, dt = rollouts(N=50)
    plant = plant.replace(state_noise=GaussianNoise(std=MESH_NOISE_STD))
    grid = np.linspace(-1.0, 1.0, MESH_GRID)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(MESH_SEED)
    torch.cuda.synchronize()
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    res, _ = benchmark_varying_initial_state(plant, ctrl, grid, grid, MESH_STEPS, dt,
                                             mesh=mesh, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = ak.LAUNCHES["boxqp_solve"]
    fields = {f: getattr(res, f) for f in MESH_SWEEP_FIELDS}
    fields.update({f"info.{k}": v for k, v in res.info.items()})
    return fields, wall, k1


def mesh_rank(rank: int, x0s_np):
    """One rank of part (b) of the mesh phase (``spawn_ranks`` made its
    process group): config 1's main batch sharded over the ranks through
    ``make_batched_solver(mesh=)`` (a warm-up on the first lanes, then the
    counted batch), gathered (``gather_batch``); the sharded sweep
    (``mesh_sweep``); ``entry.dryrun_multichip``. Returns this rank's
    counts and times; rank 0 also the gathered arrays."""
    import torch.distributed as dist

    from control_box_rst_tpu_torch.entry import dryrun_multichip, flagship
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import (
        batch_sharding,
        make_batched_solver,
        make_mesh,
        shard_batch,
    )
    from control_box_rst_tpu_torch.parallel.mesh import gather_batch, mesh_device

    mesh = make_mesh()  # the card
    world = mesh.size()
    ocp, cfg = flagship(N=50, device=mesh_device(mesh))
    solver = make_batched_solver(ocp, cfg, dt_init=0.1, mesh=mesh)
    solver(x0s_np[:256 * world])  # warm-up: library loads
    x0s = shard_batch(x0s_np, mesh)
    torch.cuda.synchronize()
    dist.barrier()
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    U, obj, status, iters = solver(x0s)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k1 = ak.LAUNCHES["boxqp_solve"]
    lock_step = int(iters.to_local().max())
    placements_ok = all(
        tuple(o.placements) == batch_sharding(mesh) and o.to_local().shape[0] == o.shape[0] // world
        for o in (U, obj, status, iters))
    t0 = time.perf_counter()
    U_full, status_full = gather_batch((U, status))
    gather_s = time.perf_counter() - t0
    dist.barrier()
    sweep, sweep_s, sweep_k1 = mesh_sweep(mesh)
    sweep = gather_batch(sweep)
    ak.reset_launch_counts()
    dryrun_multichip(world)
    dryrun_k1 = ak.LAUNCHES["boxqp_solve"]
    rec = dict(
        rank=rank, world=world, backend=dist.get_backend(), card=str(
            torch.cuda.get_device_properties(torch.cuda.current_device()).uuid),
        local_lanes=int(U.to_local().shape[0]), placements_ok=placements_ok,
        solve_s=solve_s, solves_per_s=U.to_local().shape[0] / solve_s, k1_config1=k1,
        lock_step_sqp_iterations=lock_step, gather_s=gather_s,
        sweep_s=sweep_s, sweep_rollouts_per_s=MESH_GRID ** 2 / sweep_s, k1_sweep=sweep_k1,
        k1_dryrun=dryrun_k1)
    if rank == 0:
        rec["U"], rec["status"] = U_full.cpu().numpy(), status_full.cpu().numpy()
        rec["sweep"] = {k: v.cpu().numpy() for k, v in sweep.items()}
    return rec


def phase_mesh(ocp, cfg, x0s_np, U_main, main_rec):
    """The device mesh (``parallel/mesh.py``, ``make_batched_solver(mesh=)``,
    ``benchmark_varying_initial_state(mesh=)``, ``entry.dryrun_multichip``).
    (a) One rank in this process: ``make_mesh()`` on the card (nccl), config
    1's main batch through ``make_batched_solver(mesh=)``; gates: U equals
    the main phase's U bit for bit, K1 launches == the lock-step SQP
    iterations > 0, the four outputs ``Shard(0)`` DTensors over the
    one-rank mesh, converged >= 0.99 and max |U - U_oracle| <= 1e-3; the
    group is destroyed after. (b) MESH_RANKS ranks that share the card
    (gloo), spawned under one timeout (MESH_RANK_TIMEOUT_S): the main batch
    split over them, gathered U == the unsharded U bit for bit, each rank's
    K1 launches > 0 and == its lock-step SQP iterations; the sharded sweep
    of ``mesh_sweep`` == the unsharded sweep lane by lane, every field,
    noise included, each rank's K1 launches > 0; ``dryrun_multichip``.
    Returns (K1 launches by path, record)."""
    import torch.distributed as dist

    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import batch_sharding, make_batched_solver, make_mesh
    from control_box_rst_tpu_torch.parallel.mesh import spawn_ranks
    from torch.distributed.tensor import DTensor

    t_phase = time.perf_counter()
    # ---- (a) one rank, in process ----
    t0 = time.perf_counter()
    mesh = make_mesh()
    solver = make_batched_solver(ocp, cfg, dt_init=0.1, mesh=mesh)
    x0s = torch.as_tensor(x0s_np, device="cuda")
    solver(x0s[:256])  # warm-up
    torch.cuda.synchronize()
    ak.reset_launch_counts()
    outs = solver(x0s)
    torch.cuda.synchronize()
    k1_a = ak.LAUNCHES["boxqp_solve"]
    U, obj, status, iters = outs
    if not all(isinstance(o, DTensor) and tuple(o.placements) == batch_sharding(mesh)
               and o.device_mesh.size() == 1 and o.to_local().shape[0] == x0s_np.shape[0]
               for o in outs):
        raise AssertionError("mesh (a): the outputs are not Shard(0) DTensors over one rank")
    U_a = U.to_local()
    same_bits = bool(torch.equal(U_a.cpu(), U_main))
    lock_step = int(iters.to_local().max())
    conv = float((status.to_local() == 1).float().mean())
    gold = np.load(GOLDEN)
    u_err = float(np.max(np.abs(U_a[:gold["U"].shape[0]].double().cpu().numpy() - gold["U"])))
    best = float("inf")
    for _ in range(TRIALS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(REPS):
            solver(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t1)
    one = dict(backend=dist.get_backend(), world=dist.get_world_size(),
               solves_per_s=x0s_np.shape[0] * REPS / best,
               main_phase_solves_per_s=main_rec["solves_per_s"], k1_launches=k1_a,
               lock_step_sqp_iterations=lock_step, bit_equal_to_main=same_bits,
               converged_frac=conv, max_u_err_vs_f64_oracle=u_err)
    dist.destroy_process_group()
    one["wall_s"] = time.perf_counter() - t0
    log(f"mesh (a): {json.dumps(one)}")
    if not same_bits:
        raise AssertionError(
            f"mesh (a): U differs from the main phase's by {float((U_a.cpu() - U_main).abs().max())}")
    if k1_a <= 0 or k1_a != lock_step:
        raise AssertionError(f"mesh (a): {k1_a} K1 launches, lock-step SQP iterations {lock_step}")
    if conv < CONV_GATE or not u_err <= ERR_GATE:
        raise AssertionError(f"mesh (a): converged {conv}, max |U - U_oracle| {u_err}")

    # ---- (b) MESH_RANKS ranks sharing the card, gloo ----
    ref, ref_s, ref_k1 = mesh_sweep()
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    t0 = time.perf_counter()
    ranks = spawn_ranks(mesh_rank, MESH_RANKS, args=(x0s_np,), timeout_s=MESH_RANK_TIMEOUT_S)
    wall_b = time.perf_counter() - t0
    r0 = ranks[0]
    U_b = r0.pop("U")
    status_b = r0.pop("status")
    sweep = r0.pop("sweep")
    sweep_diff = {k: float(np.max(np.abs(sweep[k].astype(np.float64) - ref[k].astype(np.float64))))
                  for k in ref}
    sweep_equal = {k: bool(np.array_equal(sweep[k], ref[k])) for k in ref}
    two = dict(
        wall_s=wall_b, world=MESH_RANKS, backend=r0["backend"],
        distinct_cards=len({r["card"] for r in ranks}),
        gather="c10d all_gather of the CUDA shards (parallel.mesh.gather_batch)",
        bit_equal_to_main=bool(np.array_equal(U_b, U_main.numpy())),
        max_abs_u_diff_vs_main=float(np.max(np.abs(U_b - U_main.numpy()))),
        converged_frac=float((status_b == 1).mean()),
        sweep_rollouts=MESH_GRID ** 2, sweep_steps=MESH_STEPS,
        sweep_unsharded_rollouts_per_s=MESH_GRID ** 2 / ref_s, sweep_unsharded_k1=ref_k1,
        sweep_fields_bit_equal=sweep_equal, sweep_max_abs_diff=sweep_diff,
        ranks=[{k: v for k, v in r.items() if k != "card"} for r in ranks])
    log(f"mesh (b): {json.dumps(two)}")
    for r in ranks:
        if r["backend"] != "gloo" or r["world"] != MESH_RANKS or not r["placements_ok"]:
            raise AssertionError(f"mesh (b): rank {r['rank']}: {r}")
        if r["k1_config1"] <= 0 or r["k1_config1"] != r["lock_step_sqp_iterations"]:
            raise AssertionError(f"mesh (b): rank {r['rank']}: {r['k1_config1']} K1 launches, "
                                 f"lock-step SQP iterations {r['lock_step_sqp_iterations']}")
        if r["k1_sweep"] <= 0 or r["k1_dryrun"] <= 0:
            raise AssertionError(f"mesh (b): rank {r['rank']}: K1 launches {r}")
    if not two["bit_equal_to_main"]:
        raise AssertionError(f"mesh (b): gathered U differs by {two['max_abs_u_diff_vs_main']}")
    if not all(sweep_equal.values()):
        raise AssertionError(f"mesh (b): sharded sweep differs from the unsharded: {sweep_diff}")
    rec = {"one_rank": one, "two_ranks": two, "phase_s": time.perf_counter() - t_phase}
    k1_paths = {"mesh_config1": k1_a}
    for r in ranks:
        k1_paths.update({f"mesh_rank{r['rank']}_config1": r["k1_config1"],
                         f"mesh_rank{r['rank']}_sweep": r["k1_sweep"],
                         f"mesh_rank{r['rank']}_dryrun": r["k1_dryrun"]})
    return k1_paths, rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one batched solve of each main path, one single "
                         "solve, and every kernel by itself with torch.profiler")
    ap.add_argument("--skip-main", action="store_true",
                    help="stop after the kernel phase (no result line)")
    ap.add_argument("--closed-loop-only", action="store_true",
                    help="after the build, run only the closed_loop and closed_loop_graph "
                         "phases and the master's config-1 batch, and print their lines")
    opts = ap.parse_args()

    # ---- 1 device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device present", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from control_box_rst_tpu_torch.entry import (
        flagship,
        flagship_ip,
        flagship_lm,
        hermite_simpson_unc,
        move_blocking,
        nonuniform_ms_timeopt,
    )
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
    from control_box_rst_tpu_torch.ops.cuda import build

    # wall seconds of each phase since the previous stamp
    phase_s, last = {}, [time.perf_counter()]

    def stamp(name):
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    # ---- 2 build ----
    ocp, cfg = flagship(N=50)
    _, lm_cfg = flagship_lm(N=50)
    problems = nonlinear_problems()
    t0 = time.perf_counter()
    grid_ocps = [hermite_simpson_unc(N=20)[0], move_blocking(N=50)[0]]
    shapes = sorted({(ocp.nz, ocp.nc)} | {(p[0].nz, p[0].nc) for p in problems.values()}
                    | {(o.nz, o.nc) for o in grid_ocps} | set(ZOO_K1_BUILDS))
    libs = build.build_all(
        [ak.build_spec(nz, nc) for nz, nc in shapes]
        + [bk.build_spec(ocp.nz), bk.build_spec(ocp.nc)], verbose=True)
    log(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s")
    stamp("build")

    rng = np.random.default_rng(0)
    x0s_np = rng.uniform(-1.0, 1.0, size=(BATCH, 2)).astype(np.float32)
    if opts.closed_loop_only:
        cl_rec = phase_closed_loop(x0s_np[:CL_BATCH], CL_TRIALS, KERNEL_REPS)[2]
        stamp("closed_loop")
        clg_rec = phase_closed_loop_graph()
        stamp("closed_loop_graph")
        import tempfile

        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            batch_rec = _batched_config1(pathlib.Path(tmp))
        stamp("master_batch")
        log(json.dumps({"closed_loop": cl_rec}))
        log(json.dumps({"closed_loop_graph": clg_rec}))
        log(json.dumps({"master_batch": batch_rec}))
        log(json.dumps({"phase_seconds": phase_s}))
        return 0

    # ---- 3 kernels ----
    ocp_dev = ocp.to(device="cuda", dtype=torch.float32)
    x0s_dev = torch.as_tensor(x0s_np, device="cuda")
    records = phase_kernels(ocp_dev, cfg, x0s_dev, SMALL_BATCH, KERNEL_REPS)
    records[0]["shapes"] = phase_nonlinear_kernels(problems, KERNEL_REPS)
    records += phase_btridiag_kernels(ocp_dev, lm_cfg, x0s_dev, KERNEL_REPS)
    ip_ocp, ip_cfg = flagship_ip(N=50)
    nz2 = phase_btridiag_nz2_kernels(ip_ocp, ip_cfg, x0s_dev, KERNEL_REPS)
    for r in records:
        if r["name"] in nz2:
            r["nz2"] = nz2[r["name"]]
    nz6 = phase_kernels_nz6(KERNEL_REPS)
    records[0]["shapes"]["hermite_simpson_unc"] = nz6
    k1_builds = {(6, 4): nz6, **phase_kernels_nz5(KERNEL_REPS)}
    stamp("kernels")
    if opts.skip_main:
        log(json.dumps({"kernels": records}))
        return 3

    # ---- 4 main path (SQP), 5 LM path, 6 nonlinear paths ----
    launches, U_main, main_rec = phase_main(ocp, cfg, x0s_np, TRIALS, REPS)
    stamp("main")
    lm_launches, lm_rec = phase_lm(ocp, lm_cfg, x0s_np, LM_TRIALS)
    stamp("lm")
    nl_launches, nl_rec, nl_solvers = phase_nonlinear(problems, NL_TRIALS, NL_SINGLE)
    stamp("nonlinear")
    cl_k1, cl_k4, cl_rec, cl_step_rec, cl_roll = phase_closed_loop(
        x0s_np[:CL_BATCH], CL_TRIALS, KERNEL_REPS)
    records[0]["shapes"]["closed_loop"] = cl_step_rec
    stamp("closed_loop")
    clg_rec = phase_closed_loop_graph()
    stamp("closed_loop_graph")
    # ---- config 4: open loop, adaptive closed loop, K1 at their shapes ----
    nu_x0s = nonuniform_x0s()
    nu_ol_k1, nu_ol_rec, nu_solve = phase_nonuniform_open_loop(nu_x0s, NU_TRIALS, NU_SINGLE)
    stamp("nonuniform_open_loop")
    nu_cl_k1, nu_cl_rec, nu_kept, nu_cl = phase_nonuniform_closed_loop(nu_x0s, NU_CL_TRIALS)
    stamp("nonuniform_closed_loop")
    records[0]["shapes"].update(
        phase_nonuniform_kernels(nonuniform_ms_timeopt(), nu_x0s, nu_kept, KERNEL_REPS))
    del nu_kept
    stamp("nonuniform_kernels")
    # ---- the interior-point paths ----
    ip_launches, ip_k3, ip_held, ip_rec, ip_solvers, sqp_scan = phase_ip(
        x0s_np, IP_TRIALS, IP_SINGLE)
    stamp("ip")
    # ---- the other grids, config 6 under MPC, the Kalman / dual-mode loop, bcr ----
    grid_launches, grid_rec, grid_solvers = phase_grids(x0s_np, HS_TRIALS, HS_SINGLE)
    stamp("grids")
    hs_cl_k1, hs_cl_rec = phase_hs_closed_loop()
    stamp("hs_closed_loop")
    dm_k1, dm_rec = phase_dual_mode()
    stamp("dual_mode")
    bcr_rec = phase_bcr(*sqp_scan)
    del sqp_scan
    stamp("bcr")
    # ---- the config loader and the master CLI ----
    master_k1, master_k4, master_builds, master_rec = phase_master()
    stamp("master")
    # ---- the gRPC master service and the real-time loop (B=1) ----
    transport = serve_transport()
    log(f"serve transport: {transport}")
    serve_k1, serve_builds, serve_rec = phase_serve(transport)
    stamp("serve")
    rt_k1, rt_builds, rt_rec, rt_ctrl = phase_realtime(cl_rec["p99_single_step_ms"])
    stamp("realtime")
    # ---- the device mesh: one rank in process, two ranks sharing the card ----
    mesh_k1, mesh_rec = phase_mesh(ocp, cfg, x0s_np, U_main, main_rec)
    del U_main
    stamp("mesh")
    # each count from its own path's run; K1 and K4 carry one count per path
    k1_paths = {"sqp_config1": launches["boxqp_solve"], **nl_launches, "closed_loop": cl_k1,
                "nonuniform_open_loop": nu_ol_k1, "nonuniform_closed_loop": nu_cl_k1,
                **grid_launches, "hs_closed_loop": hs_cl_k1, "dual_mode_kalman": dm_k1,
                **master_k1, "serve_config1": serve_k1, "realtime_config1": rt_k1, **mesh_k1}
    k4_paths = {"lm_config1": lm_launches["btridiag_factor_solve_inplace"], "closed_loop_lm": cl_k4,
                **ip_launches, **master_k4}
    k3_paths = {"lm_config1_inplace_false": lm_launches["btridiag_factor_solve"], **ip_k3}
    launches = {**launches, **lm_launches, "boxqp_solve": sum(k1_paths.values()),
                "btridiag_factor_solve_inplace": sum(k4_paths.values()),
                "btridiag_factor_solve": sum(k3_paths.values())}
    for r in records:
        if r["name"] == "btridiag_factor_solve_inplace":
            r["launches_by_path"] = k4_paths
        if r["name"] == "btridiag_factor_solve":
            r["launches_by_path"] = k3_paths
        if r["name"] in ("btridiag_factor_solve", "btridiag_factor_solve_inplace"):
            r["held_on_paths"] = {path: errs[r["name"]] for path, errs in ip_held.items()}
    for r in records:
        r["launches"] = launches[r["name"]]
    if min(k1_paths.values()) <= 0:
        raise AssertionError(f"boxqp_solve was not launched by every path: {k1_paths}")
    # K1's other builds, each with its own entry and the launches at that
    # build, by the wrapper's per-build counts of the paths that reach them:
    # (6, 4) the uncompressed grid and the zoo's cart-pole, (5, 2) and (5, 3)
    # the zoo; the (4, 2) / (4, 3) entry keeps the rest of the total
    builds_by_path = {p: r["boxqp_solve_launches_by_build"] for p, r in grid_rec.items()}
    builds_by_path.update(master_builds, serve_config1=serve_builds, realtime_config1=rt_builds)
    own = {f"{nz}x{nc}" for nz, nc in k1_builds}
    records[0]["launches_all_builds"] = launches["boxqp_solve"]
    records[0]["launches_by_path"] = {
        p: n - sum(m for b, m in builds_by_path.get(p, {}).items() if b in own)
        for p, n in k1_paths.items()}
    records[0]["launches"] = sum(records[0]["launches_by_path"].values())
    for i, ((nz, nc), rec) in enumerate(k1_builds.items()):
        by_path = {p: b[f"{nz}x{nc}"] for p, b in builds_by_path.items() if b.get(f"{nz}x{nc}")}
        records.insert(1 + i, k1_build_record(rec, sum(by_path.values())))
        records[1 + i]["launches_by_path"] = by_path
    if sum(r["launches"] for r in records[:1 + len(k1_builds)]) != launches["boxqp_solve"]:
        raise AssertionError("K1's launches by build do not sum to its total")
    for r in records:
        if r["on_main_path"] and r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was not launched by its main path")

    if opts.profile:
        from control_box_rst_tpu_torch.parallel import (
            make_batched_lm_solver,
            make_batched_solver,
        )

        sqp = make_batched_solver(ocp, cfg, dt_init=0.1)
        lm = make_batched_lm_solver(ocp, lm_cfg, dt_init=0.1)
        lm3 = make_batched_lm_solver(ocp, lm_cfg, dt_init=0.1, inplace=False)
        log(json.dumps({"profile": phase_profile(
            {"batch": (sqp, BATCH), "single": (sqp, 1), "lm_batch": (lm, BATCH),
             "lm_batch_k3": (lm3, BATCH)},
            x0s_np)}))
        log(json.dumps({"kernels_alone_ms": profile_kernels_alone(ocp_dev, cfg, x0s_dev)}))
        nl_prof = {}
        for name, solver in nl_solvers.items():
            prof = phase_profile({name: (solver, NL_BATCH)}, problems[name][3])[name]
            k1 = [v for k, v in prof["own_kernels"].items() if "boxqp_solve" in k]
            if len(k1) != 1:
                raise AssertionError(f"{name}: the profiler saw {list(prof['own_kernels'])}")
            prof["sqp_iterations"] = k1[0]["launches"]
            prof["eager_kernels_per_sqp_iteration"] = (
                prof["n_device_kernels"] - k1[0]["launches"]) / k1[0]["launches"]
            nl_prof[name] = prof
        log(json.dumps({"profile_nonlinear": nl_prof}))
        prof = phase_profile({"closed_loop": (cl_roll, CL_BATCH)}, x0s_np)["closed_loop"]
        k1 = [v for k, v in prof["own_kernels"].items() if "boxqp_solve" in k]
        if len(k1) != 1:
            raise AssertionError(f"closed loop: the profiler saw {list(prof['own_kernels'])}")
        prof["mpc_steps"] = cl_rec["t_steps"]
        prof["eager_kernels_per_mpc_step"] = (
            prof["n_device_kernels"] - k1[0]["launches"]) / cl_rec["t_steps"]
        log(json.dumps({"profile_closed_loop": prof}))
        from control_box_rst_tpu_torch.parallel import make_batched_closed_loop

        nu_prof = phase_profile(
            {"open_loop": (nu_solve, NU_BATCH),
             "closed_loop_5_steps": (make_batched_closed_loop(*nu_cl[:2], 5, 0.1), NU_BATCH)},
            nu_x0s)
        for name, prof in nu_prof.items():
            k1 = [v for k, v in prof["own_kernels"].items() if "boxqp_solve" in k]
            if len(k1) != 1:
                raise AssertionError(f"config 4 {name}: the profiler saw {list(prof['own_kernels'])}")
            prof["sqp_iterations"] = k1[0]["launches"]
            prof["eager_kernels_per_sqp_iteration"] = (
                prof["n_device_kernels"] - k1[0]["launches"]) / k1[0]["launches"]
        log(json.dumps({"profile_nonuniform": nu_prof}))
        ip_prof = phase_profile({"config1_ip": ip_solvers["config1_ip"]}, x0s_np)
        ip_prof.update(phase_profile(
            {"constrained_di_ip": ip_solvers["constrained_di_ip"]}, constrained_di_x0s()))
        for name, prof in ip_prof.items():
            k4 = [v for k, v in prof["own_kernels"].items() if "btridiag_factor_solve" in k]
            if len(k4) != 1:
                raise AssertionError(f"{name}: the profiler saw {list(prof['own_kernels'])}")
            prof["ip_iterations"] = k4[0]["launches"]
            prof["eager_kernels_per_ip_iteration"] = (
                prof["n_device_kernels"] - k4[0]["launches"]) / k4[0]["launches"]
        log(json.dumps({"profile_ip": ip_prof}))
        log(json.dumps({"profile_grids": profile_new_paths(grid_solvers, x0s_np)}))
        log(json.dumps({"profile_realtime": profile_realtime(
            rt_ctrl, str(ROOT / "build" / "traces"))}))
        stamp("profile")

    # ---- 7 result ----
    log(json.dumps({"main": main_rec}))
    log(json.dumps({"lm": lm_rec}))
    log(json.dumps({"nonlinear": nl_rec}))
    log(json.dumps({"closed_loop": cl_rec}))
    log(json.dumps({"closed_loop_graph": clg_rec}))
    log(json.dumps({"ip": ip_rec}))
    log(json.dumps({"grids": grid_rec}))
    log(json.dumps({"hs_closed_loop": hs_cl_rec}))
    log(json.dumps({"dual_mode": dm_rec}))
    log(json.dumps({"bcr": bcr_rec}))
    log(json.dumps({"master": master_rec}))
    log(json.dumps({"serve": serve_rec}))
    log(json.dumps({"realtime": rt_rec}))
    log(json.dumps({"mesh": mesh_rec}))
    # last: the config-4 batch by the plain backend (see its docstring)
    nu_cl_rec["plain"] = phase_nonuniform_vs_plain(*nu_cl)
    stamp("nonuniform_vs_plain")
    log(json.dumps({"phase_seconds": phase_s}))
    log(json.dumps({"nonuniform": {"open_loop": nu_ol_rec, "closed_loop": nu_cl_rec}}))
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
