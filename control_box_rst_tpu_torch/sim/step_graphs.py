"""One MPC step of a batch of closed loops, replayed from two CUDA graphs.

``run_closed_loop`` steps a batch in a Python loop that dispatches some 700
small kernels a step (the controller's shift and warm start, the SQP
one-shot and loop trip, the transcription's evaluations, K1's call, the
plant's RK4) while the card waits for most of them. Where the step's shapes
are fixed and its only data-dependent host decision is the SQP loop's test
(``graph_engages``), ``StepGraphs`` runs the step as two graphs and one test:

  A  the controller's ``step_prefix`` and ``sqp_begin`` (the one-shot, K1,
     and one loop trip whatever the loop's test says);
  the test on the host (``sqp_rest``, inside ``sqp.wait``): where a lane
     needs more trips they run eagerly on A's outputs and are written back
     into them;
  B  ``sqp_finish``, the controller's ``step_suffix`` and the plant's step,
     which writes the next carry and state into A's inputs.

The graphs hold the eager code, so the rollouts are ``run_closed_loop``'s
bit for bit. On the CPU the same object calls the two parts directly. A
step runs inside the ``controller.step`` and ``plant.step`` spans;
``sqp_rest`` counts the solve's ``sqp.*`` counters, ``closed_loop.graph_steps``
the steps and ``closed_loop.eager_trips`` the trips run after A. A replay
runs no Python: K1's wrapper counts the calls of the warm-up and the
capture, not the launches of a replay, which only a device trace shows.
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.control.predictive import PredictiveController, solved_by_sqp
from control_box_rst_tpu_torch.sim.closed_loop import ClosedLoopResult, stack_steps
from control_box_rst_tpu_torch.sim.observer import NoObserver
from control_box_rst_tpu_torch.solvers.sqp import (
    one_shot_applies,
    resolve_qp_backend,
    sqp_begin,
    sqp_finish,
    sqp_rest,
)
from control_box_rst_tpu_torch.utils.profiling import count, span


def graph_engages(controller, plant, observer, device) -> bool:
    """Whether the closed loop of ``controller`` against ``plant`` on
    ``device`` (``make_batched_closed_loop``'s arguments) runs from
    ``StepGraphs``: on the card, a ``PredictiveController`` solving by SQP
    once a step, with no grid adaptation, whose solve starts with the
    one-shot (``sqp.one_shot_applies`` at the QP backend the device
    resolves); the state measured and a plant without noise. Everything
    else steps eagerly."""
    if torch.device(device).type != "cuda" or not isinstance(controller, PredictiveController):
        return False
    c = controller
    if c.solver != "sqp" or c.adaptation is not None or c.num_ocp_iterations != 1:
        return False
    if not one_shot_applies(c.ocp, resolve_qp_backend(c.cfg, c.ocp.ng, device, c.dtype)):
        return False
    noise = (getattr(plant, k, None) for k in ("state_noise", "output_noise", "input_noise"))
    return ((observer is None or isinstance(observer, NoObserver))
            and getattr(plant, "output_kind", None) == "full"
            and all(n is None for n in noise))


class StepGraphs:
    """The closed-loop step of B lanes of ``controller`` against ``plant``
    over an interval ``dt``, as the two parts of the module docstring,
    captured here on the card (the warm-up and the captures are set-up)."""

    def __init__(self, controller: PredictiveController, plant, B: int, dt: float):
        self.ctrl, self.plant, self.dt, self.B = controller, plant, dt, B
        dev, dtype = controller.device, controller.dtype
        # A's inputs, which B writes: the measured state and the carry
        self.x = torch.zeros((B, controller.ocp.nx), dtype=dtype, device=dev)
        self.carry = controller.init_carry(self.x)
        # made here: a tensor made from a number inside a capture copies
        # from the host
        self.dt_tensor = torch.tensor(dt, dtype=dtype, device=dev)
        self._a, self._b = self._part_a, self._part_b
        if dev.type == "cuda":
            self._capture()

    # -- the two parts ---------------------------------------------------
    def _part_a(self) -> None:
        ctrl = self.ctrl
        ocp, self.n_active, warm = ctrl.step_prefix(self.carry, self.x)
        self.ctx, self.state, self.more = sqp_begin(
            ocp, ocp.unpack(warm.W), ctrl.sqp_cfg, warm, ctrl.hoisted)

    def _part_b(self) -> None:
        carry, out = self.ctrl.step_suffix(
            self.n_active, solved_by_sqp(sqp_finish(self.ctx, self.state)))
        # failure → zero controls
        u = torch.where(out.ok[..., None], out.u, torch.zeros_like(out.u))
        x = self.plant.step(self.x, u, self.dt_tensor)
        for buf, new in zip(self.carry, carry):
            if new is not buf:
                buf.copy_(new)
        self.x.copy_(x)
        self.out = (self.x, u, out.ok, out.info)

    def _capture(self) -> None:
        """Warm both parts up on a side stream, then capture them, B in A's
        memory pool (they replay in that order)."""
        dev = self.x.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._part_a()
            self._part_b()
        torch.cuda.current_stream(dev).wait_stream(side)
        a, b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(a):
            self._part_a()
        with torch.cuda.graph(b, pool=a.pool()):
            self._part_b()
        self._a, self._b = a.replay, b.replay

    # -- a step and a run --------------------------------------------------
    def step(self):
        """One step of every lane; returns copies of (x after the step, u,
        ok, info)."""
        count("closed_loop.graph_steps")
        with span("controller.step"):
            self._a()
            s, trips = sqp_rest(self.ctx, self.state, self.more)
            if trips:
                for buf, new in zip(self.state, s):
                    buf.copy_(new)
            count("closed_loop.eager_trips", trips)
        with span("plant.step"):
            self._b()
        x, u, ok, info = self.out
        return x.clone(), u.clone(), ok.clone(), {k: v.clone() for k, v in info.items()}

    def run(self, x0s: torch.Tensor, T_steps: int) -> ClosedLoopResult:
        """T_steps of every lane from x0s [B, nx]: ``run_closed_loop``'s
        result for a measured state and a noise-free plant."""
        for buf, v in zip(self.carry, self.ctrl.init_carry(x0s)):
            buf.copy_(v)
        self.x.copy_(x0s)
        xs, us, oks, infos = [x0s], [], [], []
        for _ in range(T_steps):
            x, u, ok, info = self.step()
            xs.append(x)
            us.append(u)
            oks.append(ok)
            infos.append(info)
        return stack_steps(0.0, self.dt, xs, xs[:-1], xs[:-1], us, oks, infos)
