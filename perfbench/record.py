"""What a per-layer reader (``metrics/<name>.py``: ``read(record)`` returning
a number, or ``None`` where it finds nothing to read) is given by a
``--trace 1`` run."""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Record:
    kind: str                 # the mix's kind: sweep | rollouts
    # the traced units (``tracing.py``): profiler, CPU and CUDA
    window_s: float           # their wall time
    busy_s: float             # union of device-operation intervals in it
    n_kernels: int            # device kernels in it (copies and sets apart)
    k1_s: List[float]         # device time of each K1 launch in it, in order
    k1_shapes: List[dict]     # each K1 launch's shapes (``system.k1_shapes``)
    traced_units: int
    traced_steps: int         # closed-loop steps of the traced units (1 a batch)
    traced_k1_launches: int   # K1 launches in them (the wrapper's counter)
    # the whole window
    units: int
    k1_launches: int
