"""Device ms a step of the ops launched inside the system's ``mdvit.data``
spans: the gather of the batch from the stores and its augmentation, the
noise's hashing included."""
from portbench.program_spans import device_ms


def read(w):
    return device_ms(w, "mdvit.data")
