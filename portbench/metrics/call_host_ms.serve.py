"""The median host ms of a serving call, the system's ``mdvit.serve``
span, in the host-traced window: the issue of a call's launches, which
decides whether the host paces the card."""
from portbench.program_spans import host_ms


def read(w):
    return host_ms(w, "mdvit.serve")
