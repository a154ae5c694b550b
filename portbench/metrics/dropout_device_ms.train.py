"""Device ms a step of the ops launched inside the system's
``mdvit.dropout`` spans: each dropout's, DropPath's and Dropout2d's mask
hashing, compare and apply in the forward (the backward's mask multiply
falls in the pulls)."""
from portbench.program_spans import device_ms


def read(w):
    return device_ms(w, "mdvit.dropout")
