"""Host time of the transcription layer per lock-step SQP iteration, in ms:
the self time of the port's ``transcription.*`` spans (residuals,
Jacobians, cost gradient, Hessian blocks and objective, wherever the solver
calls them) over its ``sqp.lockstep_iters`` counter."""
from perfbench import program_spans


def read(record):
    return program_spans.per_iteration_ms(lambda name: name.startswith("transcription."))
