from control_box_rst_tpu_torch.parallel.sharded_solve import (
    make_batched_closed_loop,
    make_batched_ip_solver,
    make_batched_lm_solver,
    make_batched_solver,
)

__all__ = ["make_batched_solver", "make_batched_lm_solver", "make_batched_ip_solver",
           "make_batched_closed_loop"]
