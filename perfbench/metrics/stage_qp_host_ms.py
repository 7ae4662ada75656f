"""Host time of the stage-QP layer per lock-step SQP iteration, in ms: the
self time of the port's ``stage_qp.*`` spans and of ``k1.launch`` (the
host side of the box-QP kernel's call) over its ``sqp.lockstep_iters``
counter."""
from perfbench import program_spans


def read(record):
    return program_spans.per_iteration_ms(
        lambda name: name.startswith("stage_qp.") or name == "k1.launch")
