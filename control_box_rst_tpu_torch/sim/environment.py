"""Environment: the {controller, observer, plant} bundle with dimension
checks.

Counterpart of the JAX package's ``sim/environment.py``: ``verify()`` checks
that the controller, plant and observer dimensions agree before a task
runs.
"""
from __future__ import annotations

from typing import List, Tuple

from control_box_rst_tpu_torch.sim.observer import NoObserver
from control_box_rst_tpu_torch.sim.plant import SimulatedPlant


class Environment:
    def __init__(self, controller, plant: SimulatedPlant, observer=None):
        self.controller = controller
        self.plant = plant
        self.observer = observer or NoObserver()

    def verify(self) -> Tuple[bool, List[str]]:
        """(ok, the issues found): controller vs plant dims, a passthrough
        observer on a plant whose output is not the full state, OCP vs plant
        dims."""
        issues: List[str] = []
        c, p = self.controller, self.plant
        if getattr(c, "nu", None) and c.nu != p.system.nu:
            issues.append(
                f"controller nu={c.nu} != plant nu={p.system.nu}"
            )
        if getattr(c, "nx", None) and c.nx != p.system.nx:
            issues.append(
                f"controller nx={c.nx} != plant nx={p.system.nx}"
            )
        if isinstance(self.observer, NoObserver) and p.ny != p.system.nx:
            issues.append(
                "NoObserver requires full-state plant output "
                f"(ny={p.ny} != nx={p.system.nx})"
            )
        ocp = getattr(c, "ocp", None)
        if ocp is not None:
            if ocp.nx != p.system.nx or ocp.nu != p.system.nu:
                issues.append(
                    f"OCP dims ({ocp.nx},{ocp.nu}) != plant "
                    f"({p.system.nx},{p.system.nu})"
                )
        return (not issues), issues
