"""Kernel A (``mdvit::factorized_attention``): its least time by FLOPs or
bytes over the device time it took, %."""
from portbench.trace import roofline_pct

OPS = ("mdvit::factorized_attention",)


def read(w):
    return roofline_pct(w, OPS)
