"""Device ms a step of the ops whose host launch fell inside one of the
system's ``mdvit.backward`` spans (the autograd pulls), on any thread: the
autograd engine issues the CUDA backward from a worker thread."""
from portbench.program_spans import device_ms


def read(w):
    return device_ms(w, "mdvit.backward")
