"""Host time of the interior-point layer per lock-step IP iteration, in ms:
the self time of the port's ``ip.*`` spans (the solve's set-up and its
loop's own arithmetic, the Newton system, the line search) but ``ip.wait``,
the host blocked on the device, and of ``k4.launch`` (the host side of the
Schur solve's call), over its ``ip.lockstep_iters`` counter."""
from perfbench import program_spans


def _ip(name):
    return (name.startswith("ip.") and name != "ip.wait") or name == "k4.launch"


def read(record):
    got = program_spans.read()
    if got is None or "ip.solve" not in got[0]:
        return None
    spans, counters = got
    iters = counters.get("ip.lockstep_iters", 0)
    if not iters:
        return None
    return 1e3 * program_spans.self_s(spans, _ip) / iters
