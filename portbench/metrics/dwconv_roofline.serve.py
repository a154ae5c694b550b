"""Kernels B and C (``mdvit::cpe_conv``, ``mdvit::crpe_conv``): their least
time by FLOPs or bytes over the device time they took, %."""
from portbench.trace import roofline_pct

OPS = ("mdvit::cpe_conv", "mdvit::crpe_conv")


def read(w):
    return roofline_pct(w, OPS)
