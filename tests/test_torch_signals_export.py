"""The port's signal recorder, exporters, time series, references and
environment check (``core/{signals,export,time_series,reference}.py``,
``sim/environment.py``) against the JAX package's, float64 on the CPU.

- The same signals recorded in both packages' ``SignalRecorder``
  (measurements, time series, indexed values, matrices, and a closed-loop
  result through ``record_closed_loop``): the same names; ``export_tsv``
  writes the same file names and the same rows (as text: the same number of
  columns, every number within 1e-12); ``export_yaml`` the same tree.
  The port's recorder squeezes a batch of one rollout and refuses a larger
  batch.
- ``TimeSeries.value_at`` for both interpolation and both extrapolation
  modes, inside, between, on and outside the knots (1e-12); the transforms
  and ``TimeSeriesSequence``.
- The references and ``sample_references`` (1e-12).
- ``Environment.verify`` on consistent and inconsistent bundles: the same
  verdict and the same messages.
YAML is PyYAML in both packages (it is installed beside the card too), so
there is no reader of the port's own to hold to ``yaml.safe_load``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from control_box_rst_tpu.core import export as jexp
from control_box_rst_tpu.core import reference as jref
from control_box_rst_tpu.core import signals as jsig
from control_box_rst_tpu.core import time_series as jts
from control_box_rst_tpu.sim.closed_loop import ClosedLoopResult as JResult

from control_box_rst_tpu_torch.core import export as texp
from control_box_rst_tpu_torch.core import reference as tref
from control_box_rst_tpu_torch.core import signals as tsig
from control_box_rst_tpu_torch.core import time_series as tts
from control_box_rst_tpu_torch.sim.closed_loop import ClosedLoopResult as TResult

TOL = 1e-12


def _closed_loop_arrays(T=6, nx=2, nu=1, N=4, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        ts=0.1 * np.arange(T), x_true=rng.standard_normal((T + 1, nx)),
        y=rng.standard_normal((T, 1)), x_observed=rng.standard_normal((T, nx)),
        u=rng.standard_normal((T, nu)), ok=np.ones(T, bool),
        info={"objective": rng.standard_normal(T), "sqp_iters": np.arange(T) % 3,
              "dts": np.full((T, N), 0.1), "u_seq": rng.standard_normal((T, N, nu))},
    )


def _fill(mod, rec, arrays, port):
    rec.add_measurement("controller/u", 0.0, [1.0])
    rec.add_measurement("controller/u", 0.1, [2.5])
    rec.add_time_series("plant/x", [0.0, 0.1, 0.2], [[1.0, 0.0], [0.9, -0.1], [0.7, -1 / 3]])
    rec.add_indexed_values("solver/iterations", 3, [1.0, 2.0])
    rec.add_indexed_values("solver/iterations", 5, [4.0, 1e-10])
    rec.add_matrix("benchmark/grid", np.arange(6.0).reshape(3, 2) / 7.0)
    rec.add_matrix("benchmark/grid", np.ones((3, 2)))
    rec.add_time_series("scalar", [0.0, 1.0], [np.pi, np.e])
    if port:
        t = {k: torch.as_tensor(v) for k, v in arrays.items() if k != "info"}
        res = TResult(info={k: torch.as_tensor(v) for k, v in arrays["info"].items()}, **t)
    else:
        res = JResult(**arrays)
    rec.record_closed_loop(res, prefix="loop/")


def _tsv_rows(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            out[name] = [line.rstrip("\n").split("\t") for line in f]
    return out


def test_recorder_and_exports_match_jax(tmp_path):
    arrays = _closed_loop_arrays()
    jrec, trec = jsig.SignalRecorder(), tsig.SignalRecorder()
    _fill(jsig, jrec, arrays, port=False)
    _fill(tsig, trec, arrays, port=True)
    assert list(trec.names()) == list(jrec.names())
    # the 3-dim info entry (u_seq) is left out by both
    assert "loop/controller/u_seq" not in list(trec.names())
    assert "loop/controller/dts" in list(trec.names())
    for name in jrec.names():
        js, ts_ = jrec.get(name), trec.get(name)
        assert ts_["kind"] == js["kind"]
        for key in ("times", "values", "indices", "matrices"):
            assert (key in ts_) == (key in js)
            if key in js:
                np.testing.assert_allclose(np.asarray(ts_[key], float), np.asarray(js[key], float),
                                           rtol=0, atol=TOL)
    jexp.export_tsv(jrec, str(tmp_path / "j"))
    texp.export_tsv(trec, str(tmp_path / "t"))
    jrows, trows = _tsv_rows(tmp_path / "j"), _tsv_rows(tmp_path / "t")
    assert sorted(trows) == sorted(jrows)
    for name in jrows:
        assert len(trows[name]) == len(jrows[name]), name
        for tr, jr in zip(trows[name], jrows[name]):
            assert len(tr) == len(jr), name
            np.testing.assert_allclose(np.asarray(tr, float), np.asarray(jr, float),
                                       rtol=0, atol=TOL)
    jexp.export_yaml(jrec, str(tmp_path / "j.yaml"))
    texp.export_yaml(trec, str(tmp_path / "t.yaml"))
    with open(tmp_path / "j.yaml") as f:
        jtree = yaml.safe_load(f)
    with open(tmp_path / "t.yaml") as f:
        ttree = yaml.safe_load(f)
    assert ttree == jtree


def test_recorder_squeezes_one_lane_and_refuses_a_batch():
    arrays = _closed_loop_arrays()
    batched = {k: torch.as_tensor(v)[None] for k, v in arrays.items() if k != "info"}
    info = {k: torch.as_tensor(v)[None] for k, v in arrays["info"].items()}
    one, ref = tsig.SignalRecorder(), tsig.SignalRecorder()
    one.record_closed_loop(TResult(info=info, **batched))
    ref.record_closed_loop(JResult(**arrays))
    assert list(one.names()) == list(ref.names())
    for name in ref.names():
        np.testing.assert_array_equal(one.get(name)["values"], ref.get(name)["values"])
    two = {k: torch.cat([v, v]) for k, v in batched.items()}
    with pytest.raises(ValueError, match="batch of 2"):
        tsig.SignalRecorder().record_closed_loop(
            TResult(info={k: torch.cat([v, v]) for k, v in info.items()}, **two))


@pytest.mark.parametrize("interpolation", ["linear", "zero_order_hold"])
@pytest.mark.parametrize("extrapolation", ["hold", "linear"])
def test_time_series_value_at_matches_jax(interpolation, extrapolation):
    rng = np.random.default_rng(3)
    times = np.cumsum(rng.uniform(0.1, 0.5, size=7)) - 0.2
    values = rng.standard_normal((7, 3))
    probes = np.concatenate([times, 0.5 * (times[1:] + times[:-1]),
                             [times[0] - 0.3, times[-1] + 0.4, times[-1] + 2.0]])
    js = jts.TimeSeries.from_arrays(times, values)
    ts_ = tts.TimeSeries.from_arrays(times, values)
    want = np.stack([np.asarray(js.value_at(t, interpolation, extrapolation)) for t in probes])
    got = ts_.value_at(torch.as_tensor(probes), interpolation, extrapolation).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for t in probes[:3]:  # one Python number at a time
        np.testing.assert_allclose(ts_.value_at(float(t), interpolation, extrapolation).numpy(),
                                   np.asarray(js.value_at(t, interpolation, extrapolation)),
                                   rtol=0, atol=TOL)


def test_time_series_reference_cases_and_transforms():
    ts_ = tts.TimeSeries.from_arrays([0.0, 1.0, 2.0], [[0.0], [10.0], [20.0]])
    assert float(ts_.value_at(0.5)[0]) == pytest.approx(5.0)
    assert float(ts_.value_at(0.5, interpolation="zero_order_hold")[0]) == 0.0
    assert float(ts_.value_at(3.0)[0]) == pytest.approx(20.0)
    assert float(ts_.value_at(3.0, extrapolation="linear")[0]) == pytest.approx(30.0)
    assert float(ts_.value_at(-1.0)[0]) == 0.0
    one = tts.TimeSeries.from_arrays([2.0], [[4.0]])
    jone = jts.TimeSeries.from_arrays([2.0], [[4.0]])
    for t in (1.0, 2.0, 3.0):
        np.testing.assert_allclose(one.value_at(t, extrapolation="linear").numpy(),
                                   np.asarray(jone.value_at(t, extrapolation="linear")))
    ts2 = tts.TimeSeries.from_arrays([1.0, 2.0], [[1.0, 2.0], [3.0, 4.0]])
    assert float(ts2.normalized_time().times[0]) == 0.0
    np.testing.assert_allclose(ts2.mean().numpy(), [2.0, 3.0])
    np.testing.assert_allclose(ts2.final().numpy(), [3.0, 4.0])
    assert ts2.sliced(1, 2).n == 1 and ts2.dim == 2
    seq = tts.TimeSeriesSequence.stack([ts2, ts2.shifted(1.0)])
    assert seq.n_series == 2
    assert float(seq.series(1).times[0]) == 2.0
    t_np, v_np = ts2.to_numpy()
    np.testing.assert_array_equal(v_np, [[1.0, 2.0], [3.0, 4.0]])


def test_references_match_jax():
    dts = np.array([0.5, 0.25, 0.4, 0.1])
    dts_t = torch.as_tensor(dts)
    value = np.array([1.0, -1.0])
    pairs = [
        (jref.StaticReference(dim=2, value=jnp.asarray(value)),
         tref.StaticReference(dim=2, value=torch.as_tensor(value))),
        (jref.ZeroReference(2), tref.ZeroReference(2)),
        (jref.SineReferenceTrajectory(dim=2, amplitude=2.0, omega=np.pi, phase=0.3, offset=1.0),
         tref.SineReferenceTrajectory(dim=2, amplitude=2.0, omega=np.pi, phase=0.3, offset=1.0)),
    ]
    series = ([0.0, 0.6, 1.5], [[0.0], [1.0], [-2.0]])
    for interp in ("linear", "zero_order_hold"):
        pairs.append((
            jref.DiscreteTimeReferenceTrajectory(
                dim=1, series=jts.TimeSeries.from_arrays(*series), interpolation=interp),
            tref.DiscreteTimeReferenceTrajectory(
                dim=1, series=tts.TimeSeries.from_arrays(*series), interpolation=interp)))
    for jr, tr in pairs:
        np.testing.assert_allclose(tr.value_at(0.7).numpy(), np.asarray(jr.value_at(0.7)),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(tr.stage_values(0.2, dts_t).numpy(),
                                   np.asarray(jr.stage_values(0.2, jnp.asarray(dts))),
                                   rtol=0, atol=TOL)
    for (jx, tx), (ju, tu) in [(pairs[0], pairs[3]), (pairs[2], pairs[1])]:
        jrefs = jref.sample_references(jx, ju, 0.1, jnp.asarray(dts))
        trefs = tref.sample_references(tx, tu, 0.1, dts_t)
        assert trefs.xref.shape == jrefs.xref.shape and trefs.uref.shape == jrefs.uref.shape
        np.testing.assert_allclose(trefs.xref.numpy(), np.asarray(jrefs.xref), rtol=0, atol=TOL)
        np.testing.assert_allclose(trefs.uref.numpy(), np.asarray(jrefs.uref), rtol=0, atol=TOL)


def test_environment_verify_matches_jax():
    from control_box_rst_tpu.control import LqrController as JLqr
    from control_box_rst_tpu.models import DoubleIntegratorContinuous as JDI
    from control_box_rst_tpu.sim import SimulatedPlant as JPlant
    from control_box_rst_tpu.sim.environment import Environment as JEnv

    from control_box_rst_tpu_torch.control import LqrController as TLqr
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous as TDI
    from control_box_rst_tpu_torch.models import SerialIntegratorSystem as TSerial
    from control_box_rst_tpu_torch.sim import SimulatedPlant as TPlant
    from control_box_rst_tpu_torch.sim.environment import Environment as TEnv
    from control_box_rst_tpu.models import SerialIntegratorSystem as JSerial

    jl = JLqr.from_system(JDI(), jnp.eye(2), jnp.eye(1))
    tl = TLqr.from_system(TDI(), np.eye(2), np.eye(1), dtype=torch.float64, device="cpu")
    cases = [
        (JPlant(system=JDI()), TPlant(system=TDI())),
        (JPlant(system=JDI(), output_kind="first"), TPlant(system=TDI(), output_kind="first")),
        (JPlant(system=JSerial(nx=3, nu=1)), TPlant(system=TSerial(nx=3, nu=1))),
    ]
    for jp, tp in cases:
        assert TEnv(tl, tp).verify() == JEnv(jl, jp).verify()
    ok, issues = TEnv(tl, cases[2][1]).verify()
    assert not ok and any("nx=2" in i for i in issues)
