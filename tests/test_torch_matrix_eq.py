"""PyTorch port vs JAX package and scipy: ``ops/matrix_eq.py`` and
``ocp/costs.py:riccati_terminal_cost``, in float64.

- CARE (sign iteration) and DARE (doubling) on seeded random systems against
  scipy's ``solve_continuous_are`` / ``solve_discrete_are`` (1e-8, as
  tests/test_matrix_eq.py holds the JAX functions) and against the JAX
  functions (1e-9); a batch of systems against each system alone (1e-12).
- The LQR gains, the Lyapunov and Sylvester solvers, controllability and
  observability against the JAX functions (1e-9; ranks equal) and the
  equations' residuals (1e-10); the ordered Schur decomposition equals the
  reference's (both are scipy on the host).
- ``riccati_terminal_cost`` of the double integrator (CARE) and of a
  discrete-time system (DARE) against the JAX one (1e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from control_box_rst_tpu.ocp import costs as jcosts
from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
from control_box_rst_tpu.models import FunctionalDynamics as JaxFD
from control_box_rst_tpu.ops import matrix_eq as jme
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous as TorchDI
from control_box_rst_tpu_torch.models.base import FunctionalDynamics as TorchFD
from control_box_rst_tpu_torch.ocp import costs as tcosts
from control_box_rst_tpu_torch.ops import matrix_eq as tme

from torch_port_util import to_np

torch.set_num_threads(1)
SCIPY_TOL = 1e-8
JAX_TOL = 1e-9
RES_TOL = 1e-10


def _system(n, m, seed, discrete=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if discrete:
        A = A / (np.max(np.abs(np.linalg.eigvals(A))) + 0.2)
    return A, rng.standard_normal((n, m))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("kind", ["care", "dare"])
@pytest.mark.parametrize("n,m", [(2, 1), (4, 2), (6, 3)])
def test_riccati_matches_scipy_and_jax(kind, n, m):
    A, B = _system(n, m, seed=10 * n + m, discrete=kind == "dare")
    Q, R = 2.0 * np.eye(n), 0.5 * np.eye(m)
    port = {"care": tme.solve_care, "dare": tme.solve_dare}[kind]
    ref = {"care": jme.solve_care, "dare": jme.solve_dare}[kind]
    sp = {"care": scipy.linalg.solve_continuous_are,
          "dare": scipy.linalg.solve_discrete_are}[kind]
    X = to_np(port(*_t(A, B, Q, R)))
    np.testing.assert_allclose(X, sp(A, B, Q, R), rtol=SCIPY_TOL, atol=SCIPY_TOL)
    want = jax.jit(ref)(*map(jnp.asarray, (A, B, Q, R)))
    np.testing.assert_allclose(X, np.asarray(want), rtol=JAX_TOL, atol=JAX_TOL)
    # batch-first: a batch of three systems, each as it is alone
    sys3 = [_system(n, m, seed=s, discrete=kind == "dare") for s in (1, 2, 3)]
    As, Bs = (torch.as_tensor(np.stack(a)) for a in zip(*sys3))
    Xb = port(As, Bs, torch.as_tensor(Q), torch.as_tensor(R))
    for i, (Ai, Bi) in enumerate(sys3):
        np.testing.assert_allclose(to_np(Xb[i]), to_np(port(*_t(Ai, Bi, Q, R))),
                                   rtol=1e-12, atol=1e-12)


def test_lqr_gains_match_jax():
    A = np.array([[0.0, 1.0], [0.5, -0.2]])
    B = np.array([[0.0], [1.0]])
    Q, R = np.eye(2), np.eye(1)
    K = to_np(tme.lqr_gain_continuous(*_t(A, B, Q, R)))
    np.testing.assert_allclose(K, np.asarray(jax.jit(jme.lqr_gain_continuous)(A, B, Q, R)),
                               rtol=JAX_TOL, atol=JAX_TOL)
    assert np.all(np.linalg.eigvals(A - B @ K).real < 0)
    Ad, Bd = np.eye(2) + 0.1 * A, 0.1 * B
    Kd = to_np(tme.lqr_gain_discrete(*_t(Ad, Bd, Q, R)))
    np.testing.assert_allclose(Kd, np.asarray(jax.jit(jme.lqr_gain_discrete)(Ad, Bd, Q, R)),
                               rtol=JAX_TOL, atol=JAX_TOL)
    assert np.all(np.abs(np.linalg.eigvals(Ad - Bd @ Kd)) < 1.0)


@pytest.mark.parametrize("name", ["lyapunov_continuous", "lyapunov_discrete",
                                  "sylvester_continuous", "sylvester_discrete"])
def test_lyapunov_sylvester_match_jax(name):
    rng = np.random.default_rng(7)
    if name.startswith("lyapunov"):
        A = (rng.standard_normal((3, 3)) - 3 * np.eye(3) if name.endswith("continuous")
             else 0.3 * rng.standard_normal((3, 3)))
        args = (A, np.eye(3) + 0.1 * np.ones((3, 3)))
    else:
        cont = name.endswith("continuous")
        A = rng.standard_normal((3, 3)) - 3 * np.eye(3) if cont else 0.3 * rng.standard_normal((3, 3))
        B = rng.standard_normal((2, 2)) - 3 * np.eye(2) if cont else 0.3 * rng.standard_normal((2, 2))
        args = (A, B, rng.standard_normal((3, 2)))
    X = to_np(getattr(tme, "solve_" + name)(*_t(*args)))
    want = np.asarray(jax.jit(getattr(jme, "solve_" + name))(*map(jnp.asarray, args)))
    np.testing.assert_allclose(X, want, rtol=JAX_TOL, atol=JAX_TOL)
    A = args[0]
    res = {"lyapunov_continuous": lambda: A.T @ X + X @ A + args[1],
           "lyapunov_discrete": lambda: A.T @ X @ A - X + args[1],
           "sylvester_continuous": lambda: A @ X + X @ args[1] + args[2],
           "sylvester_discrete": lambda: A @ X @ args[1] - X + args[2]}[name]()
    assert np.max(np.abs(res)) < RES_TOL


@pytest.mark.parametrize("select", ["lhp", "iuc", None])
def test_schur_ordered_matches_jax(select):
    A = np.random.default_rng(3).standard_normal((4, 4))
    T, Qm = tme.schur_ordered(torch.as_tensor(A), select)
    Tj, Qj = jme.schur_ordered(A, select)
    np.testing.assert_array_equal(T, Tj)
    np.testing.assert_array_equal(Qm, Qj)
    np.testing.assert_allclose(Qm @ T @ Qm.T, A, atol=1e-12)


def test_controllability_observability_match_jax():
    A = np.array([[0.0, 1.0], [0.0, 0.0]])
    B, C = np.array([[0.0], [1.0]]), np.array([[1.0, 0.0]])
    np.testing.assert_allclose(to_np(tme.controllability_matrix(*_t(A, B))),
                               np.asarray(jme.controllability_matrix(A, B)), atol=1e-15)
    np.testing.assert_allclose(to_np(tme.observability_matrix(*_t(A, C))),
                               np.asarray(jme.observability_matrix(A, C)), atol=1e-15)
    for port, ref, args in (
        (tme.is_controllable, jme.is_controllable, (A, B)),
        (tme.is_controllable, jme.is_controllable, (np.diag([1.0, 2.0]), np.array([[1.0], [0.0]]))),
        (tme.is_observable, jme.is_observable, (A, C)),
        (tme.is_observable, jme.is_observable, (A, np.array([[0.0, 1.0]]))),
    ):
        ok, rank = port(*_t(*args))
        ok_j, rank_j = ref(*args)
        assert bool(ok) == bool(ok_j) and int(rank) == int(rank_j)


@pytest.mark.parametrize("kind", ["continuous", "discrete"])
def test_riccati_terminal_cost_matches_jax(kind):
    Q, R = np.diag([1.0, 2.0]), np.array([[0.3]])
    xref, uref = np.array([0.2, -0.1]), np.array([0.05])
    if kind == "continuous":
        sys_t, sys_j = TorchDI(), JaxDI()
    else:
        A = np.array([[1.0, 0.1], [-0.05, 0.98]])
        Bm = np.array([[0.005], [0.1]])
        sys_t = TorchFD(nx=2, nu=1, continuous_time=False,
                        fn=lambda x, u: x @ torch.as_tensor(A).T + u @ torch.as_tensor(Bm).T)
        sys_j = JaxFD(nx=2, nu=1, continuous_time=False,
                      fn=lambda x, u: jnp.asarray(A) @ x + jnp.asarray(Bm) @ u)
    got = tcosts.riccati_terminal_cost(sys_t, torch.as_tensor(xref), torch.as_tensor(uref),
                                       torch.as_tensor(Q), torch.as_tensor(R))
    want = jax.jit(lambda: jcosts.riccati_terminal_cost(
        sys_j, jnp.asarray(xref), jnp.asarray(uref), jnp.asarray(Q), jnp.asarray(R)).Qf)()
    assert isinstance(got, tcosts.QuadraticFinalStateCost)
    np.testing.assert_allclose(to_np(got.Qf), np.asarray(want), rtol=JAX_TOL, atol=JAX_TOL)
