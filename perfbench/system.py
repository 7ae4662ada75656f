"""The system under test: the port (``control_box_rst_tpu_torch``), built
through its public entry points from a configuration file, and what the
benchmark reads of it (K1's launch counter, and the shapes of K1's launches
while a trace runs).

Two ways a traffic mix drives it, by the mix's ``kind``:

- ``sweep``: ``make_batched_solver(*entry.<builder>(N))``, one call a batch;
- ``rollouts``: ``make_batched_closed_loop(*entry.<controller_builder>(N))``.

Every result a caller gets is on the host: a batch is complete when its
answers are, as a sweep's user collects them.
"""
from __future__ import annotations

import contextlib

import torch


def _close(a, b) -> bool:
    return torch.allclose(torch.as_tensor(a, dtype=torch.float64).cpu(),
                          torch.as_tensor(b, dtype=torch.float64).cpu(), rtol=1e-6, atol=1e-6)


def verify(ocp, config: dict) -> None:
    """Raise where the program's OCP is not the configuration file's."""
    grid, cost = config["grid"], config["cost"]
    terms = {type(c).__name__: c for c in getattr(ocp.cost, "costs", (ocp.cost,))}
    checks = {
        "N": ocp.N == grid["N"],
        "system": type(ocp.system).__name__ == config["system"]["class"],
        "scheme": (ocp.grid.kind, ocp.grid.fd_scheme if ocp.grid.kind == "fd"
                   else ocp.grid.integrator) == (grid["kind"], grid["scheme"]),
        "dt": _close(ocp.bounds.dt_lb, grid["dt"]) and _close(ocp.bounds.dt_ub, grid["dt"]),
        "u_bounds": _close(ocp.bounds.u_lb, config["u_bounds"][0])
        and _close(ocp.bounds.u_ub, config["u_bounds"][1]),
        "Q": _close(terms["QuadraticFormCost"].Q, cost["Q"]),
        "R": _close(terms["QuadraticFormCost"].R, cost["R"]),
        "Qf": _close(terms["QuadraticFinalStateCost"].Qf, cost["Qf"]),
        "dtype": str(ocp.bounds.u_lb.dtype) == f"torch.{config['dtype']}",
    }
    if ocp.grid.kind == "ms":
        checks["substeps"] = ocp.grid.integrator_substeps == grid.get("substeps", 1)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise ValueError(f"the program's OCP differs from {config['name']}.json in {bad}")
    if torch.backends.cuda.matmul.allow_tf32 != config["tf32"]:
        raise ValueError("the program's TF32 setting is not the configuration's")


class System:
    """The port, built for one cell on ``device``."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from control_box_rst_tpu_torch import entry
        from control_box_rst_tpu_torch.ops.cuda import admm_kernel
        from control_box_rst_tpu_torch.parallel import (
            make_batched_closed_loop,
            make_batched_solver,
        )

        self._k1 = admm_kernel
        self.kind = traffic["kind"]
        self.device = device
        N, dt = config["grid"]["N"], config["grid"]["dt"]
        if self.kind == "sweep":
            ocp, cfg = getattr(entry, config["builder"])(N, device=device)
            verify(ocp, config)
            self._solve = make_batched_solver(ocp, cfg, dt_init=dt, device=device)
            return
        ctrl, plant, _, ctrl_dt = getattr(entry, config["controller_builder"])(N, device=device)
        verify(ctrl.ocp, config)
        if ctrl_dt != dt:
            raise ValueError(f"the controller steps {ctrl_dt}, the configuration {dt}")
        if self.kind != "rollouts":
            raise KeyError(f"unknown traffic kind {self.kind!r}")
        self._rollout = make_batched_closed_loop(ctrl, plant, traffic["steps"], dt, device=device)

    # -- the two ways in -------------------------------------------------
    def solve(self, x0):
        """A batch of cold-start solves: (U [B, N, nu], status [B]) on the host."""
        U, _, status, _ = self._solve(x0.to(self.device))
        return U.cpu(), status.cpu()

    def rollout(self, x0):
        """A batch of closed loops: (u [B, T, nu], x [B, T+1, nx], ok [B, T])."""
        res = self._rollout(x0.to(self.device))
        return res.u.cpu(), res.x_true.cpu(), res.ok.cpu()

    # -- what is read of it ------------------------------------------------
    def k1_launches(self) -> int:
        return self._k1.LAUNCHES["boxqp_solve"]

    @contextlib.contextmanager
    def k1_shapes(self, into: list):
        """Inside the block, append each K1 launch's shapes to ``into``."""
        mod, real = self._k1, self._k1.boxqp_solve

        def recorded(Hd, J, K, *args, **kw):
            into.append(dict(
                B=Hd.shape[0], Kst=Hd.shape[1], nz=Hd.shape[2], nc=J.shape[2],
                iters=kw["iters"], use_kkt=kw.get("tol_stat", 0.0) > 0.0,
                shared_hjk=all(a.stride(0) == 0 for a in (Hd, J, K))))
            return real(Hd, J, K, *args, **kw)

        mod.boxqp_solve = recorded
        try:
            yield
        finally:
            mod.boxqp_solve = real
