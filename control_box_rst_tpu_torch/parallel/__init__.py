from control_box_rst_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from control_box_rst_tpu_torch.parallel.sharded_solve import (
    make_batched_closed_loop,
    make_batched_ip_solver,
    make_batched_lm_solver,
    make_batched_solver,
)

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch", "pad_to_multiple",
           "make_batched_solver", "make_batched_lm_solver", "make_batched_ip_solver",
           "make_batched_closed_loop"]
