"""Kernels B, C, B′, C′ (``mdvit::cpe_conv``, ``mdvit::crpe_conv`` and their
``_bwd``): their least time by FLOPs or bytes over the device time they
took, %."""
from portbench.trace import roofline_pct

OPS = ("mdvit::cpe_conv", "mdvit::crpe_conv", "mdvit::cpe_conv_bwd", "mdvit::crpe_conv_bwd")


def read(w):
    return roofline_pct(w, OPS)
