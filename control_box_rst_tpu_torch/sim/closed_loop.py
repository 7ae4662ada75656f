"""Closed-loop control task, batch-first.

Counterpart of the JAX package's ``sim/closed_loop.py``. There the whole
closed loop is one ``lax.scan`` and batched rollouts are its ``vmap``; here it
is a Python loop over the steps {plant output → observe → (predict) →
controller step → integrate the plant} in which every operation acts on the
whole batch of lanes. The per-step results stay on the device and are
stacked once at the end; the loop itself copies nothing to the host.

Failure handling as in the reference: a lane whose controller step is not
``ok`` applies zero controls over the interval.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from control_box_rst_tpu_torch.sim.observer import NoObserver
from control_box_rst_tpu_torch.sim.plant import SimulatedPlant


class ClosedLoopResult(NamedTuple):
    """Stacked per-step signals, batch-first (time is the second dim); an
    unbatched run has no batch dim."""

    ts: torch.Tensor        # [B, T] step start times
    x_true: torch.Tensor    # [B, T+1, nx] plant states (initial included)
    y: torch.Tensor         # [B, T, ny] plant outputs
    x_observed: torch.Tensor  # [B, T, nx]
    u: torch.Tensor         # [B, T, nu] applied controls
    ok: torch.Tensor        # [B, T] controller success
    info: dict              # controller diagnostics, each [B, T, …]


def _generator(generator, device) -> torch.Generator:
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


def _apply_sequence(plant, x, out, dt, substeps: int, generator):
    """Integrate every lane across one sampling interval in ``substeps``
    equal substeps, each under the planned control active at its midpoint
    on the lane's own plan time base (t_plan [B, H+1] from the plan's dts)."""
    H = out.u_seq.shape[-2]
    dts_plan = out.info.get("dts")
    if dts_plan is None:
        dts_plan = torch.full(out.u_seq.shape[:-1], dt, dtype=x.dtype, device=x.device)
    zero = torch.zeros(dts_plan.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    t_plan = torch.cat([zero, torch.cumsum(dts_plan, dim=-1)], dim=-1).contiguous()
    sub_dt = dt / substeps
    ok = out.ok[..., None]
    for i in range(substeps):
        tau = torch.full(zero.shape, (i + 0.5) * sub_dt, dtype=x.dtype, device=x.device)
        idx = torch.clamp(torch.searchsorted(t_plan, tau, right=True) - 1, 0, H - 1)
        u_i = torch.take_along_dim(out.u_seq, idx[..., None], dim=-2)[..., 0, :]
        x = plant.step(x, torch.where(ok, u_i, torch.zeros_like(u_i)), sub_dt, generator)
    return x


def run_closed_loop(
    plant: SimulatedPlant,
    controller,
    x0: torch.Tensor,
    T_steps: int,
    dt: float,
    observer=None,
    generator: Optional[torch.Generator] = None,
    t0: float = 0.0,
    apply_sequence_substeps: int = 0,
    predictor=None,
) -> ClosedLoopResult:
    """Simulate T_steps of {output → observe → control → integrate} for a
    batch of plants, x0 [B, nx] (or one plant, x0 [nx]).

    apply_sequence_substeps = 0: apply u0 zero-order-hold over the sampling
    interval. > 0: apply the controller's planned sequence (u_seq on its own
    dts time base) across the interval in that many substeps — what a
    time-optimal plan whose dt is shorter than the sampling time needs.

    predictor: optional ``OneStepPredictor`` — propagates the observed state
    by one interval under the previously applied control before solving.

    generator: the ``torch.Generator`` noisy plants draw from (on x0's
    device); ``None`` means one seeded with 0."""
    if observer is None:
        observer = NoObserver()
    unbatched = x0.dim() == 1
    x = x0[None] if unbatched else x0
    B = x.shape[0]
    generator = _generator(generator, x.device)

    ctrl_carry = controller.init_carry(x)
    obs_carry = observer.init_carry(x)
    u_prev = torch.zeros((B, plant.system.nu), dtype=x.dtype, device=x.device)
    xs, ys, xhats, us, oks, infos = [x], [], [], [], [], []
    for k in range(T_steps):
        t = t0 + k * dt
        y = plant.output(x, generator)
        # the observer predicts with the control applied over the PREVIOUS
        # interval
        obs_carry, x_hat = observer.observe(obs_carry, y, u_prev, dt)
        if predictor is not None:
            x_hat = predictor.predict_single(x_hat, u_prev, dt)
        ctrl_carry, out = controller.step(ctrl_carry, x_hat, t, dt)
        # failure → zero controls
        u = torch.where(out.ok[..., None], out.u, torch.zeros_like(out.u))
        if apply_sequence_substeps <= 0:
            x = plant.step(x, u, dt, generator)
        else:
            x = _apply_sequence(plant, x, out, dt, apply_sequence_substeps, generator)
        xs.append(x)
        ys.append(y)
        xhats.append(x_hat)
        us.append(u)
        oks.append(out.ok)
        infos.append(out.info)
        u_prev = u

    stack = lambda seq: torch.stack(seq, dim=1)
    ts = t0 + dt * torch.arange(T_steps, dtype=x.dtype, device=x.device)
    res = ClosedLoopResult(
        ts=ts.expand(B, T_steps), x_true=stack(xs), y=stack(ys),
        x_observed=stack(xhats), u=stack(us), ok=stack(oks),
        # keys sorted, as the reference's lax.scan returns a dict
        info={key: stack([i[key] for i in infos]) for key in sorted(infos[0] if infos else {})},
    )
    if unbatched:
        res = ClosedLoopResult(
            *(a[0] for a in res[:-1]), info={k: v[0] for k, v in res.info.items()})
    return res


def run_open_loop(
    plant: SimulatedPlant,
    controller,
    x0: torch.Tensor,
    dt: float,
    generator: Optional[torch.Generator] = None,
):
    """One controller solve, then roll the plant along the planned controls
    (on the plan's own dts). Returns (ControlOutput, x_rollout [B, H+1, nx]);
    x0 [B, nx] or [nx] (then nothing carries a batch dim)."""
    unbatched = x0.dim() == 1
    x = x0[None] if unbatched else x0
    generator = _generator(generator, x.device)
    carry = controller.init_carry(x)
    _, out = controller.step(carry, x, 0.0, dt)
    H = out.u_seq.shape[-2]
    dts = out.info.get("dts")
    if dts is None:
        dts = torch.full(out.u_seq.shape[:-1], dt, dtype=x.dtype, device=x.device)
    xs = [x]
    for i in range(H):
        xs.append(plant.step(xs[-1], out.u_seq[..., i, :], dts[..., i], generator))
    x_rollout = torch.stack(xs, dim=-2)
    if unbatched:
        out = type(out)(
            *(a[0] for a in out[:-1]), info={k: v[0] for k, v in out.info.items()})
        x_rollout = x_rollout[0]
    return out, x_rollout
