"""Share of the traced closed-loop steps that the port replayed from its
step graphs, in %: the port's ``closed_loop.graph_steps`` over those and its
``closed_loop.eager_steps`` (the steps of the eager loop). Nothing where the
port counts neither."""
from perfbench import program_spans


def read(record):
    got = program_spans.read()
    if got is None:
        return None
    counters = got[1]
    graph = counters.get("closed_loop.graph_steps", 0)
    eager = counters.get("closed_loop.eager_steps", 0)
    if not graph + eager:
        return None
    return 100.0 * graph / (graph + eager)
