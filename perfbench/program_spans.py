"""What the port records of its own layers while a profiler session runs:
the spans and counters of ``control_box_rst_tpu_torch.utils.profiling``. A
run's one profiler session is its traced units, so the port's last record
is theirs. Host times come from the spans' self times (a span's duration
less what its child spans cover)."""


def read():
    """(spans, counters) of the port's last record: per span name its
    ``count``, ``total_s`` and ``self_s``, per counter its total. ``None``
    where the port keeps no such record or it holds no span."""
    try:
        from control_box_rst_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_record", None)
    if last is None:
        return None
    record = last()
    spans = record.summary()
    return (spans, record.counters()) if spans else None


def self_s(spans: dict, keep) -> float:
    """Σ self seconds of the spans whose names ``keep`` accepts."""
    return sum(v["self_s"] for name, v in spans.items() if keep(name))


def per_iteration_ms(keep):
    """Σ self ms of the spans ``keep`` accepts per lock-step SQP iteration
    (the port's ``sqp.lockstep_iters``: the one-shot and every loop trip)."""
    got = read()
    if got is None:
        return None
    spans, counters = got
    iters = counters.get("sqp.lockstep_iters", 0)
    if not iters or not any(keep(name) for name in spans):
        return None
    return 1e3 * self_s(spans, keep) / iters
