"""Grid adaptation strategies on a fixed-size grid, batch-first.

Counterpart of the JAX package's ``ocp/adaptation.py``. A grid of N
intervals never changes shape: adaptation changes each lane's *active
interval count* ``n_active`` ≤ N (the tail intervals are masked off in the
transcription, see ``ocp/transcribe.py``) and resamples or regathers the lane's
trajectory W = [x; u; dt] stages to match.

Every function takes a batch of lanes — W [..., N+1, nz], ``n_active`` [...]
int — and makes one decision per lane with ``torch.where`` and per-lane
gathers (``take_along_dim``); nothing branches in Python on a tensor value,
so every lane of a batch can carry its own horizon.
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.utils.tree import plain_dataclass


def stage_mask_from_n(n_active, N: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[..., N] 1.0 on the first ``n_active`` intervals of every lane
    (``n_active`` [...] or a number)."""
    n = torch.as_tensor(n_active, device=device)
    return (torch.arange(N, device=n.device) < n[..., None]).to(dtype)


def _gather_rows(W: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """W [..., S, nz] rows ``idx`` [..., M] of every lane → [..., M, nz]."""
    return torch.take_along_dim(W, idx[..., None], dim=-2)


def resample_W(W: torch.Tensor, nx: int, nu: int, n_old, n_new, N: int) -> torch.Tensor:
    """Resample every lane's active portion of W onto ``n_new`` uniform
    intervals of the same total time T: states interpolated linearly in
    time, controls held (zero-order hold), dt = T / n_new on the active
    intervals and 0 on the rest. W [..., N+1, nz], ``n_old`` / ``n_new``
    [...] ints."""
    dtype, dev = W.dtype, W.device
    lead = W.shape[:-2]
    n_old = torch.as_tensor(n_old, device=dev).expand(lead)
    n_new = torch.as_tensor(n_new, device=dev).expand(lead)
    dts = W[..., :-1, nx + nu]
    dts_act = dts * stage_mask_from_n(n_old, N, dtype, dev)
    # cumulative stage times of the old grid; the tail holds T, summed in
    # order, as the reference's reduction of a short row sums it (the new
    # times meet the old knots in ties, and which side of a tie a time falls
    # on picks the control it holds)
    t_old = torch.cat([dts_act.new_zeros(lead + (1,)), torch.cumsum(dts_act, dim=-1)], dim=-1)
    T = t_old[..., -1]
    # new uniform times: i·T/n_new for i ≤ n_new, then T
    dt_new = T / torch.clamp(n_new, min=1).to(dtype)
    i = torch.arange(N + 1, dtype=dtype, device=dev)
    t_new = torch.minimum(i, n_new[..., None].to(dtype)) * dt_new[..., None]
    # interval of the old grid holding each new time (the same index for
    # the state interpolation and the zero-order hold)
    idx = torch.clamp(
        torch.searchsorted(t_old.contiguous(), t_new.contiguous(), right=True) - 1, 0, N - 1)
    t0 = torch.take_along_dim(t_old, idx, dim=-1)
    t1 = torch.take_along_dim(t_old, idx + 1, dim=-1)
    span = t1 > t0
    w = torch.where(span, (t_new - t0) / torch.where(span, t1 - t0, torch.ones_like(t0)),
                    torch.zeros_like(t0))
    X0 = _gather_rows(W[..., :nx], idx)
    X1 = _gather_rows(W[..., :nx], idx + 1)
    X_new = X0 + w[..., None] * (X1 - X0)
    U_new = _gather_rows(W[..., nx:nx + nu], idx[..., :-1])
    new_mask = stage_mask_from_n(n_new, N, dtype, dev)
    dts_new = torch.where(new_mask > 0, dt_new[..., None], torch.zeros_like(new_mask))
    return torch.cat([
        X_new,
        torch.cat([U_new, U_new.new_zeros(lead + (1, nu))], dim=-2),
        torch.cat([dts_new, dts_new.new_zeros(lead + (1,))], dim=-1)[..., None],
    ], dim=-1)


def _mean_active_dt(W, n_active, nx: int, nu: int, N: int) -> torch.Tensor:
    dts = W[..., :-1, nx + nu]
    mask = stage_mask_from_n(n_active, N, W.dtype, W.device)
    return (dts * mask).sum(dim=-1) / torch.clamp(n_active, min=1).to(W.dtype)


@plain_dataclass
class GridAdaptation:
    """Base: no adaptation. ``n_max`` = 0 means the grid's N."""

    n_min: int = 2
    n_max: int = 0

    def adapt(self, W, n_active, nx: int, nu: int, N: int, feas=None):
        """(W, n_active) of the next solve for every lane."""
        return W, n_active


@plain_dataclass
class TimeBasedSingleStep(GridAdaptation):
    """Grow or shrink each lane's horizon by one interval when its mean
    active dt leaves the hysteresis band around ``dt_ref``; resample."""

    dt_ref: float = 0.1
    dt_hyst_ratio: float = 0.1

    def adapt(self, W, n_active, nx: int, nu: int, N: int, feas=None):
        n_max = self.n_max or N
        dt = _mean_active_dt(W, n_active, nx, nu, N)
        grow = (dt > self.dt_ref * (1.0 + self.dt_hyst_ratio)) & (n_active < n_max)
        shrink = (dt < self.dt_ref * (1.0 - self.dt_hyst_ratio)) & (n_active > self.n_min)
        n_new = torch.where(grow, n_active + 1, torch.where(shrink, n_active - 1, n_active))
        return resample_W(W, nx, nu, n_active, n_new, N), n_new


@plain_dataclass
class TimeBasedAggressiveEstimate(GridAdaptation):
    """n_new = round(n · dt / dt_ref) clipped to [n_min, n_max], unless the
    mean active dt is inside the hysteresis band; resample."""

    dt_ref: float = 0.1
    dt_hyst_ratio: float = 0.1

    def adapt(self, W, n_active, nx: int, nu: int, N: int, feas=None):
        n_max = self.n_max or N
        dt = _mean_active_dt(W, n_active, nx, nu, N)
        within = (dt >= self.dt_ref * (1.0 - self.dt_hyst_ratio)) & (
            dt <= self.dt_ref * (1.0 + self.dt_hyst_ratio))
        est = torch.round(n_active.to(W.dtype) * dt / self.dt_ref).to(n_active.dtype)
        n_new = torch.where(within, n_active, torch.clamp(est, self.n_min, n_max))
        return resample_W(W, nx, nu, n_active, n_new, N), n_new


@plain_dataclass
class SimpleShrinkingHorizon(GridAdaptation):
    """One interval fewer per step, down to ``n_min``; resample."""

    def adapt(self, W, n_active, nx: int, nu: int, N: int, feas=None):
        n_new = torch.clamp(n_active - 1, min=self.n_min)
        return resample_W(W, nx, nu, n_active, n_new, N), n_new


@plain_dataclass
class GrowOnInfeasibility(GridAdaptation):
    """One interval more after a solve whose constraint violation ``feas``
    [...] (the previous step's) is above ``feas_tol``. The newly active
    interval takes the last active interval's control and dt; its state rows
    already hold the terminal state through the inactive identity chain.
    Without ``feas`` nothing changes."""

    feas_tol: float = 1e-3

    def adapt(self, W, n_active, nx: int, nu: int, N: int, feas=None):
        if feas is None:
            return W, n_active
        n_max = self.n_max or N
        grow = (feas > self.feas_tol) & (n_active < n_max)
        k_new = torch.clamp(n_active, max=N - 1).to(torch.int64)[..., None]
        k_last = torch.clamp(n_active - 1, min=0).to(torch.int64)[..., None]
        row_new = _gather_rows(W, k_new)  # [..., 1, nz]
        row_last = _gather_rows(W, k_last)
        row = torch.cat([row_new[..., :nx], row_last[..., nx:]], dim=-1)
        row = torch.where(grow[..., None, None], row, row_new)
        W_new = W.clone()
        W_new.scatter_(-2, k_new[..., None].expand(row.shape), row)
        return W_new, torch.where(grow, n_active + 1, n_active)


@plain_dataclass
class RedundantControls(GridAdaptation):
    """Non-uniform grid refinement, one structural change per lane and call.
    Interval k < n−1 is redundant when its successor's control is within
    ``epsilon`` (componentwise) or its dt has collapsed (< 1e-6). Fewer than
    ``backup`` redundant intervals: split the largest active dt (midpoint
    state, halved dt, the control repeated); more: merge the first redundant
    interval with its successor (dts summed)."""

    epsilon: float = 0.1
    backup: int = 1

    def adapt(self, W, n_active, nx: int, nu: int, N: int, feas=None):
        n_max = self.n_max or N
        dev, idt = W.device, nx + nu
        dts = W[..., :-1, idt]
        U = W[..., :-1, nx:idt]
        n = n_active[..., None]
        k = torch.arange(N, device=dev)
        act_pair = k < n - 1
        du = (torch.roll(U, -1, dims=-2) - U).abs().amax(dim=-1)
        redundant = act_pair & ((du <= self.epsilon) | (dts < 1e-6))
        n_red = redundant.to(torch.int32).sum(dim=-1)
        need_split = (n_red < self.backup) & (n_active < n_max)
        need_merge = (n_red > self.backup) & (n_active > self.n_min)

        src = torch.arange(N + 1, device=dev)
        # split: stages after k_split move right by one, the midpoint state
        # goes in after k_split, and both halves take half its dt
        dts_act = torch.where(k < n, dts, torch.full_like(dts, -torch.inf))
        k_split = dts_act.argmax(dim=-1, keepdim=True)  # the first largest
        w_k = _gather_rows(W, k_split)[..., 0, :]
        w_k1 = _gather_rows(W, k_split + 1)[..., 0, :]
        half = 0.5 * w_k[..., idt:]
        W_s = _gather_rows(W, torch.where(src <= k_split, src, src - 1))
        W_s[..., idt] = torch.where(src == k_split, half, W_s[..., idt])
        mid = torch.cat([0.5 * (w_k[..., :nx] + w_k1[..., :nx]), w_k[..., nx:idt], half], dim=-1)
        W_s = torch.where((src == k_split + 1)[..., None], mid[..., None, :], W_s)
        # merge: the first redundant interval absorbs its successor's dt, the
        # stages after it move left by one (stage N is repeated)
        # the first True, 0 when there is none (argmax takes no bool; it
        # returns the first maximal index)
        k_merge = redundant.to(torch.int8).argmax(dim=-1, keepdim=True)
        merged_dt = _gather_rows(W, k_merge)[..., 0, idt:] + _gather_rows(W, k_merge + 1)[..., 0, idt:]
        W_m = _gather_rows(W, torch.where(src <= k_merge, src, torch.clamp(src + 1, max=N)))
        W_m[..., idt] = torch.where(src == k_merge, merged_dt, W_m[..., idt])

        s2, m2 = need_split[..., None, None], need_merge[..., None, None]
        W_new = torch.where(s2, W_s, torch.where(m2, W_m, W))
        n_new = torch.where(need_split, n_active + 1,
                            torch.where(need_merge, n_active - 1, n_active))
        return W_new, n_new
