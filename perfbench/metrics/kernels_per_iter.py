"""Device kernels launched per lock-step SQP iteration in the traced
batches: the profiler's kernel count over K1's launches in them."""


def read(record):
    if not record.traced_k1_launches or not record.n_kernels:
        return None
    return record.n_kernels / record.traced_k1_launches
