"""Device kernels launched per closed-loop step of the traced units (one
step of the whole batch counts once)."""


def read(record):
    if record.kind == "sweep" or not record.traced_steps or not record.n_kernels:
        return None
    return record.n_kernels / record.traced_steps
