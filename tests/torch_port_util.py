"""Shared helpers of the tests/test_torch_*.py files: the same numpy inputs,
made from a seed, go to the JAX package and to its PyTorch port.

The two packages share no objects; what crosses is numpy (``np.asarray`` of
the JAX side, ``control_box_rst_tpu_torch.convert`` on the port's side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from control_box_rst_tpu.models import DoubleIntegratorContinuous, VanDerPolOscillator
from control_box_rst_tpu.ocp import (
    Bounds,
    CompositeCost,
    MinimumTime,
    QuadraticFinalStateCost,
    QuadraticFormCost,
    finite_differences_grid,
    transcribe,
)
from control_box_rst_tpu.solvers import QPConfig, SQPConfig, StageQP

from control_box_rst_tpu_torch import convert

TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def to_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cast_tree(tree, dtype):
    """Cast every floating leaf of a JAX pytree (the x64 test configuration
    makes f64 arrays by default; the f32 production path must be asked for)."""
    return jax.tree.map(
        lambda a: a.astype(dtype)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        tree,
    )


def jax_flagship(N, dtype, cost_integration="left_sum", integral=False):
    """The config-1 OCP and solver settings of the JAX package, as
    ``__graft_entry__._flagship`` builds them, cast to ``dtype``."""
    grid = finite_differences_grid(
        N, fd_scheme="crank_nicolson", cost_integration=cost_integration
    )
    cost = CompositeCost(
        costs=(
            QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1), integral=integral),
            QuadraticFinalStateCost(Qf=10.0 * jnp.eye(2)),
        ),
        integral=integral,
    )
    bounds = Bounds.unbounded(2, 1).with_u(-1.0, 1.0).with_dt(0.1, 0.1)
    ocp = transcribe(
        DoubleIntegratorContinuous(), grid, cost, bounds=bounds, x0=jnp.zeros(2)
    )
    cfg = SQPConfig(
        max_iter=16,
        qp=QPConfig(max_iter=12, iters_per_round=12, rho=1.0, tol=1e-5),
        tol_stat=1e-4,
        tol_feas=1e-5,
    )
    return cast_tree(ocp, dtype), cfg


def jax_vdp_ms(N, dtype):
    """The config-2 OCP and solver settings of the JAX package
    (``__graft_entry__._vdp_ms``), cast to ``dtype``."""
    from __graft_entry__ import _vdp_ms

    ocp, cfg = _vdp_ms(N)
    return cast_tree(ocp, dtype), cfg


def jax_time_optimal(N, dtype):
    """The config-3 OCP and solver settings of the JAX package
    (``__graft_entry__._time_optimal``), cast to ``dtype``."""
    from __graft_entry__ import _time_optimal

    ocp, cfg = _time_optimal(N)
    return cast_tree(ocp, dtype), cfg


def _grid_bounds_spec(ocp):
    """Every key of ``convert.ocp_from_numpy`` but the cost's."""
    opt = lambda a: None if a is None else np.asarray(a)
    sys_ = ocp.system
    if isinstance(sys_, VanDerPolOscillator):
        system = dict(system="van_der_pol", a=float(sys_.a))
    else:
        system = dict(system="serial_integrators",
                      time_constant=float(sys_.time_constant))
    return dict(
        N=ocp.grid.N, nx=ocp.nx, nu=ocp.nu, **system,
        grid_kind=ocp.grid.kind, fd_scheme=ocp.grid.fd_scheme,
        integrator=ocp.grid.integrator,
        integrator_substeps=ocp.grid.integrator_substeps,
        cost_integration=ocp.grid.cost_integration, dt_mode=ocp.grid.dt_mode,
        x_lb=np.asarray(ocp.bounds.x_lb), x_ub=np.asarray(ocp.bounds.x_ub),
        u_lb=np.asarray(ocp.bounds.u_lb), u_ub=np.asarray(ocp.bounds.u_ub),
        dt_lb=np.asarray(ocp.bounds.dt_lb), dt_ub=np.asarray(ocp.bounds.dt_ub),
        xref=np.asarray(ocp.refs.xref), uref=np.asarray(ocp.refs.uref),
        x0=np.asarray(ocp.bc.x0), xf=opt(ocp.bc.xf), xf_fixed=opt(ocp.bc.xf_fixed),
        stage_mask=np.asarray(ocp.stage_mask),
    )


def spec_from_jax_ocp(ocp):
    """numpy dict of a JAX TranscribedOCP of the ported kinds — a serial
    integrator chain or Van der Pol; FD or multiple-shooting grid, dt pinned
    or tied; a quadratic stage cost (alone or composed with a quadratic
    terminal cost) or ``MinimumTime`` — the form ``convert.ocp_from_numpy``
    reads."""
    if isinstance(ocp.cost, MinimumTime):
        cost = dict(cost="minimum_time", weight=float(ocp.cost.weight),
                    lsq_form=bool(ocp.cost.lsq_form))
    else:
        form, final = ocp.cost.costs if hasattr(ocp.cost, "costs") else (ocp.cost, None)
        cost = dict(cost="quadratic", lsq_form=bool(form.lsq_form),
                    Q=np.asarray(form.Q), R=np.asarray(form.R),
                    Qf=None if final is None else np.asarray(final.Qf))
    return dict(_grid_bounds_spec(ocp), cost_integral=bool(ocp.cost.integral), **cost)


def torch_ocp_like(jax_ocp, dtype_name):
    return convert.ocp_from_numpy(
        spec_from_jax_ocp(jax_ocp), dtype=TORCH_DTYPES[dtype_name], device="cpu"
    )


def random_qp_np(seed, Kst=9, NZ=4, NC=2):
    """The random box QP of tests/test_admm_pallas.py as a numpy dict."""
    rng = np.random.default_rng(seed)
    N = Kst - 1
    A = rng.standard_normal((Kst, NZ, NZ)) * 0.3
    Hd = np.einsum("kij,klj->kil", A, A) + 2.0 * np.eye(NZ)
    g = rng.standard_normal((Kst, NZ))
    J = rng.standard_normal((N, NC, NZ)) * 0.5
    K = rng.standard_normal((N, NC, NZ)) * 0.5
    c = rng.standard_normal((N, NC)) * 0.1
    dlb = np.full((Kst, NZ), -0.7)
    dub = np.full((Kst, NZ), 0.7)
    # pin a few rows (dlb == dub == 0), like fixed x0 / dummy stage vars
    dlb[0, :2] = dub[0, :2] = 0.0
    dlb[-1, -1] = dub[-1, -1] = 0.0
    return dict(
        Hd=Hd, g=g, J=J, K=K, c=c, G=np.zeros((Kst, 0, NZ)),
        gl=np.zeros((Kst, 0)), gu=np.zeros((Kst, 0)), dlb=dlb, dub=dub,
    )


def random_qp_batch_np(seeds, **kw):
    qps = [random_qp_np(s, **kw) for s in seeds]
    return {k: np.stack([q[k] for q in qps]) for k in qps[0]}


def jax_stage_qp(d, dtype):
    return StageQP(**{k: jnp.asarray(v, dtype) for k, v in d.items()})


KERNEL_ARG_ORDER = ("Hd", "J", "K", "g", "c", "dlb", "dub")


def kernel_args_np(d, rho, np_dtype):
    """Reference-order operands of the round / solve functions with the cold
    start x = 0, z_b = clip(0, dlb, dub), y = 0."""
    B, Kst, NZ = d["g"].shape
    N, NC = d["c"].shape[1:]
    zeros = np.zeros((B, Kst, NZ))
    args = [d[k] for k in KERNEL_ARG_ORDER] + [
        np.full((B,), rho), zeros, np.clip(zeros, d["dlb"], d["dub"]),
        np.zeros((B, N, NC)), zeros,
    ]
    return [np.asarray(a, np_dtype) for a in args]


def obj_spec(obj, **override):
    """numpy spec of a JAX cost or constraint object — ``kind`` (the class
    name) and its fields, nested objects as specs — as
    ``convert.cost_from_numpy`` / ``constraint_from_numpy`` read it.
    Callables are left out; ``override`` supplies the port's own (and any
    other field)."""
    import dataclasses

    d = {"kind": type(obj).__name__}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or callable(v):
            continue
        if f.name == "costs":
            v = [obj_spec(c) for c in v]
        elif f.name == "constraint":
            v = obj_spec(v)
        elif isinstance(v, tuple):
            v = tuple(int(i) for i in v)
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        d[f.name] = v
    d.update(override)
    return d


def ocp_spec(ocp, stage_con=None, term_con=None):
    """``spec_from_jax_ocp`` for any cost the port carries (``cost_spec``),
    with the general rows' constraint specs (``obj_spec``, the port's
    callables given there)."""
    return dict(_grid_bounds_spec(ocp), cost_spec=obj_spec(ocp.cost),
                stage_con=stage_con, term_con=term_con)
