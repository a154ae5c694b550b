"""Device ms a step of the ops launched inside the system's ``mdvit.cp.reduce``
spans (on any thread: the backward's collectives are issued by the autograd
engine's), the collective's kernel and the copies around it. An NCCL
kernel's time includes its wait for the slowest rank."""
from portbench.program_spans import device_ms


def read(w):
    return device_ms(w, "mdvit.cp.reduce")
