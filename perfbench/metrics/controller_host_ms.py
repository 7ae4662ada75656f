"""Host time of the controller layer per closed-loop step of the traced
units, in ms (one step of the whole batch counts once): the self time of the
port's ``entry.rollout`` (the closed loop around the steps), ``controller.step``
(shift, x0 row, warm start, the call into SQP) and ``plant.step`` spans."""
from perfbench import program_spans

NAMES = ("entry.rollout", "controller.step", "plant.step")


def read(record):
    got = program_spans.read()
    if got is None or not record.traced_steps or "controller.step" not in got[0]:
        return None
    return 1e3 * program_spans.self_s(got[0], NAMES.__contains__) / record.traced_steps
