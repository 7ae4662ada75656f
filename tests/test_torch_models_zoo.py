"""The port's model zoo against the JAX package's (``models/benchmark.py``,
``models/base.py:check_dimensions``, ``models/outputs.py``), float64 on the
CPU.

- Each of the twelve registered systems, built through each package's own
  factory from the same name and parameters: f(x, u), ``linear_A`` and
  ``linear_B`` on 64 seeded random (x, u), within 1e-12; the port's model on
  the whole batch at once against the reference's per sample.
- ``check_dimensions`` passes on every default-built system, and raises on a
  model whose output has the wrong shape, in both packages.
- The four output maps on the same states, within 1e-12.
- The registries: the same system and integrator names, and two separate
  registries (a registration in one package is not seen by the other).
- ``convert.system_from_numpy`` builds the same models from a numpy spec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.core.factory import Factory as JaxFactory
from control_box_rst_tpu import models as jm
from control_box_rst_tpu.models import outputs as jout

from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch import models as tm
from control_box_rst_tpu_torch.core.factory import Factory as TorchFactory
from control_box_rst_tpu_torch.models import outputs as tout

TOL = 1e-12
LANES = 64

# name → (params of both factories, or the matrices of linear_state_space)
SYSTEMS = {
    "serial_integrators": {"nx": 3, "nu": 1, "time_constant": 2.0},
    "parallel_integrators": {"nx": 2, "nu": 2, "time_constant": 3.0},
    "linear_state_space": None,
    "double_integrator_discrete": {"dt": 0.1},
    "van_der_pol": {"a": 2.0},
    "duffing": {"damping": 0.3, "spring_alpha": -1.0, "spring_beta": 0.5},
    "free_space_rocket": {},
    "simple_pendulum": {"rho": 0.05},
    "massless_pendulum": {"omega0": 1.7},
    "cart_pole": {"mc": 1.2, "mp": 0.25},
    "toy_example": {"mu": 0.4},
    "artsteins_circle": {},
}


def _pair(name, rng):
    """The same system in both packages."""
    if name == "linear_state_space":
        A, B = rng.standard_normal((3, 3)), rng.standard_normal((3, 2))
        return (jm.LinearStateSpaceModel.from_matrices(A, B),
                tm.LinearStateSpaceModel.from_matrices(A, B))
    import control_box_rst_tpu_torch.models.benchmark  # noqa: F401 (registers)

    p = SYSTEMS[name]
    return JaxFactory.create("system", name, **p), TorchFactory.create("system", name, **p)


def _samples(sys_, rng):
    x = rng.uniform(-1.0, 1.0, size=(LANES, sys_.nx))
    if sys_.nx == 3 and type(sys_).__name__ == "FreeSpaceRocket":
        x[:, 2] = rng.uniform(0.5, 1.5, size=LANES)  # the mass stays positive
    return x, rng.uniform(-1.0, 1.0, size=(LANES, sys_.nu))


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_system_matches_jax(name):
    rng = np.random.default_rng(list(SYSTEMS).index(name))
    js, ts = _pair(name, rng)
    assert (ts.nx, ts.nu, ts.continuous_time, ts.is_linear) == (
        js.nx, js.nu, js.continuous_time, js.is_linear)
    x, u = _samples(js, rng)
    want = np.asarray(jax.vmap(js)(jnp.asarray(x), jnp.asarray(u)))
    got = ts(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    A_j = np.asarray(jax.vmap(js.linear_A)(jnp.asarray(x), jnp.asarray(u)))
    B_j = np.asarray(jax.vmap(js.linear_B)(jnp.asarray(x), jnp.asarray(u)))
    for i in range(LANES):
        xi, ui = torch.as_tensor(x[i]), torch.as_tensor(u[i])
        np.testing.assert_allclose(ts.linear_A(xi, ui).numpy(), A_j[i], rtol=0, atol=TOL)
        np.testing.assert_allclose(ts.linear_B(xi, ui).numpy(), B_j[i], rtol=0, atol=TOL)
    # check_dimensions passes on the default-built system in both packages
    jm.check_dimensions(js)
    tm.check_dimensions(ts)


def test_check_dimensions_refuses_a_wrong_output():
    bad_j = jm.FunctionalDynamics(nx=2, nu=1, fn=lambda x, u: x[:1])
    bad_t = tm.FunctionalDynamics(nx=2, nu=1, fn=lambda x, u: x[..., :1])
    with pytest.raises(ValueError, match="FunctionalDynamics"):
        jm.check_dimensions(bad_j)
    with pytest.raises(ValueError, match="FunctionalDynamics"):
        tm.check_dimensions(bad_t)
    for cls in tm.ALL_BENCHMARK_SYSTEMS:
        if cls is not tm.LinearStateSpaceModel:
            tm.check_dimensions(cls())


def test_outputs_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((LANES, 3))
    C = rng.standard_normal((2, 3))
    pairs = [
        (jout.FullStateSystemOutput(3), tout.FullStateSystemOutput(3)),
        (jout.SystemOutput(ny=3), tout.SystemOutput(ny=3)),
        (jout.FirstStateSystemOutput(), tout.FirstStateSystemOutput()),
        (jout.LinearStateSystemOutput.from_matrix(C), tout.LinearStateSystemOutput.from_matrix(C)),
    ]
    for jo, to in pairs:
        assert to.ny == jo.ny
        want = np.asarray(jax.vmap(jo)(jnp.asarray(x)))
        np.testing.assert_allclose(to(torch.as_tensor(x)).numpy(), want, rtol=0, atol=TOL)


def test_registries_are_separate_and_name_the_same_components():
    import control_box_rst_tpu.models.benchmark  # noqa: F401
    import control_box_rst_tpu.ops.integrators  # noqa: F401
    import control_box_rst_tpu_torch.models.benchmark  # noqa: F401
    import control_box_rst_tpu_torch.ops.integrators  # noqa: F401

    for category in ("system", "integrator"):
        assert list(TorchFactory.names(category)) == list(JaxFactory.names(category))
    assert TorchFactory is not JaxFactory
    assert TorchFactory._registries is not JaxFactory._registries
    TorchFactory.register("system", "_port_only", tm.SerialIntegratorSystem)
    try:
        assert TorchFactory.has("system", "_port_only")
        assert not JaxFactory.has("system", "_port_only")
        with pytest.raises(KeyError, match="_port_only"):
            JaxFactory.create("system", "_port_only")
    finally:
        del TorchFactory._registries["system"]["_port_only"]
    with pytest.raises(KeyError, match="no_such_system"):
        TorchFactory.create("system", "no_such_system")


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_system_from_numpy(name):
    rng = np.random.default_rng(11)
    js, ts = _pair(name, rng)
    spec = {"system": name, "nx": js.nx, "nu": js.nu}
    if name == "linear_state_space":
        spec.update(A=np.asarray(js.A), B=np.asarray(js.B))
    else:
        spec.update(SYSTEMS[name])
    cs = convert.system_from_numpy(spec, dtype=torch.float64, device="cpu")
    assert type(cs) is type(ts)
    x, u = _samples(js, rng)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(cs(xt, ut).numpy(), ts(xt, ut).numpy(), rtol=0, atol=TOL)
