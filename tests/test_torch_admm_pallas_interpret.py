"""PyTorch port vs the JAX package's Pallas kernel itself, in interpret mode.

``admm_round_plain`` (the plain version of the port's CUDA round kernel)
against ``admm_round_pallas(…, interpret=True)`` at Kst=9, B=4, float32, at
the JAX package's own kernel-test tolerances (x rtol 2e-4 / atol 2e-5, duals
rtol 2e-3 / atol 3e-3).

Kept to ONE case, in a file of its own: the interpreted kernel pads the batch
to 1024 lanes and takes about a minute and a half on the CPU whatever the
iteration count. For the same reason the full-solve Pallas kernel
(``boxqp_solve_pallas``) is not interpreted here: the port's full solve is
held against the per-lane reference ``_make_fused_solve(...)[1]`` under
``jax.vmap`` instead (tests/test_torch_admm_kernel.py), which is the
semantics the port follows — a lane stops at its own convergence, where the
TPU kernel stops per 1024-lane tile.
"""
import jax.numpy as jnp
import numpy as np
import torch

from control_box_rst_tpu.ops.pallas.admm_kernel import admm_round_pallas
from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

from torch_port_util import kernel_args_np, random_qp_batch_np, to_np

torch.set_num_threads(1)
X_TOL = dict(rtol=2e-4, atol=2e-5)
DUAL_TOL = dict(rtol=2e-3, atol=3e-3)
RES_TOL = dict(rtol=1e-2, atol=1e-4)
BASE = dict(sigma=1e-6, alpha=1.6, rho_eq_scale=1e3)


def test_admm_round_plain_vs_pallas_interpret():
    a = kernel_args_np(random_qp_batch_np((10, 11, 12, 13)), 0.1, np.float32)
    out_j = admm_round_pallas(*(jnp.asarray(x) for x in a), iters=7, interpret=True, **BASE)
    out_t = ak.admm_round_plain(*(torch.from_numpy(x) for x in a), iters=7, **BASE)
    for i, tol in ((0, X_TOL), (1, X_TOL), (2, DUAL_TOL), (3, DUAL_TOL),
                   (4, RES_TOL), (5, RES_TOL)):
        np.testing.assert_allclose(to_np(out_t[i]), np.asarray(out_j[i]), **tol)
