"""How ``correct`` is decided: the answers the timed path produced for the
sampled lanes, held against the plain reference (``reference/``) run once the
window has closed, in float64, from the same initial states.

The numbers compared, each against its limit in ``limits/<workload>.json``:

    u_gap   sweep: max over the sampled lanes and stages of |U - U_ref|;
            closed loops: max over the sampled rollouts and steps of the
            applied |u - u_ref|, the reference running its own closed loop
    x_gap   closed loops: max over the same of the plant state |x - x_ref|
    failed_share  the window's answers that did not succeed (a lane whose
            status is not converged, a closed-loop step that is not usable,
            or an answer that is not finite) over all its answers: every
            answer, not only the sampled ones

An answer that is not finite reads +inf. The control (``control.py``) puts
the reference, computed in float32 with TF32 products, in the program's
place and reads the same numbers.
"""
from __future__ import annotations

import math
import sys

import torch

from perfbench.reference import problem, solve

BLOCK = 4096  # lanes the reference solves at once


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max()) if d.numel() else 0.0


def reference(config: dict, kind: str, x0: torch.Tensor, steps: int, device,
              dtype=torch.float64, tf32: bool = False) -> dict:
    """The reference's answers for the initial states x0 [n, nx], in blocks."""
    p = problem.build(config, dtype, device)
    out = {}
    with solve.precision(tf32):
        for i in range(0, x0.shape[0], BLOCK):
            x = x0[i:i + BLOCK].to(device=device, dtype=dtype)
            if kind == "sweep":
                U, ok = solve.solve(p, x)
                part = dict(U=U.cpu(), converged=ok.cpu())
            else:
                u, xs, ok = solve.closed_loop(p, x, steps)
                part = dict(u=u.cpu(), x=xs.cpu(), converged=ok.all(-1).cpu())
            for k, v in part.items():
                out.setdefault(k, []).append(v)
    return {k: torch.cat(v) for k, v in out.items()}


def numbers(answers: dict, ref: dict, kind: str) -> dict:
    """The compared numbers of a sample's answers against the reference's."""
    if kind == "sweep":
        return {"u_gap": _gap(answers["U"], ref["U"])}
    return {"u_gap": _gap(answers["u"], ref["u"]), "x_gap": _gap(answers["x"], ref["x"])}


def judge(config: dict, kind: str, sample: dict, steps: int, limits: dict, device,
          failed: int, attempted: int):
    """(correct, {name: {"value", "limit"}}) of a window's sample and of its
    ``failed`` answers out of ``attempted``; the reference's own lanes that
    did not converge are named on stderr and make it not correct."""
    ref = reference(config, kind, sample["x0"], steps, device)
    bad = int((~ref["converged"]).sum())
    if bad:
        print(f"check: the reference did not converge on {bad} sampled lanes",
              file=sys.stderr)
    got = numbers(sample, ref, kind)
    got["failed_share"] = failed / attempted if attempted else math.inf
    # JSON has no infinity: an answer that is not finite reads "inf"
    table = {k: {"value": v if math.isfinite(v) else "inf", "limit": limits[k]}
             for k, v in got.items()}
    correct = bad == 0 and all(v <= limits[k] for k, v in got.items())
    return correct, table
