"""The system's ``mdvit.cp.*`` spans a step in the host-traced window: one
a collective call (halo exchanges, row and workspace gathers, all-reduces),
forward and backward."""
from portbench.program_spans import program_spans

PREFIX = "mdvit.cp."


def read(w):
    n = sum(e.name.startswith(PREFIX) for e in program_spans(w))
    return n / w.work if n else None
