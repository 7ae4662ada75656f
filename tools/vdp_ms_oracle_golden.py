"""Golden file of config 2 (Van der Pol, multiple shooting, H=20): the JAX
package's float64 oracle on the first lanes of the batch that
``chip_smoke.py`` solves.

Usage:  python tools/vdp_ms_oracle_golden.py OUT.npz [n_lanes]

  OUT.npz: x0s [n, 2] float32 — the first ``n_lanes`` (default 48) of
           numpy ``default_rng(1).uniform(-1.5, 1.5)`` over 4096 lanes;
           U [n, 20, 1] float64, obj [n], converged [n] — what
           ``tools/oracle_solve.py IN OUT vdp_ms`` (unmodified, run as a
           subprocess on the CPU) returns for them.

``tests/golden/torch_vdp_ms_oracle_N20.npz`` is this tool's output for the
defaults.
"""
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH = 4096


def main(out_path: str, n_lanes: int = 48) -> None:
    rng = np.random.default_rng(1)
    x0s = rng.uniform(-1.5, 1.5, size=(BATCH, 2)).astype(np.float32)[:n_lanes]
    with tempfile.TemporaryDirectory() as tmp:
        in_p, out_p = pathlib.Path(tmp) / "in.npz", pathlib.Path(tmp) / "out.npz"
        np.savez(in_p, x0s=x0s)
        subprocess.run(
            [sys.executable, str(ROOT / "tools" / "oracle_solve.py"), str(in_p),
             str(out_p), "vdp_ms"],
            check=True,
        )
        oracle = dict(np.load(out_p))
    np.savez(out_path, x0s=x0s, **oracle)


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
