"""% of the host-traced window's device-idle time in gaps that began while
the system's ``mdvit.optimizer`` span was the innermost open program span (a
share of the idle, comparable between versions of the system, not with the
untraced pace)."""
from portbench.program_spans import idle_share


def read(w):
    return idle_share(w, "mdvit.optimizer")
