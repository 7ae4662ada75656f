"""Host time of the SQP layer per lock-step SQP iteration, in ms: the self
time of the port's ``sqp.*`` spans (the solve, the one-shot, the loop's
iterations and line searches) but ``sqp.wait``, the host blocked on the
device, over its ``sqp.lockstep_iters`` counter."""
from perfbench import program_spans


def read(record):
    return program_spans.per_iteration_ms(
        lambda name: name.startswith("sqp.") and name != "sqp.wait")
