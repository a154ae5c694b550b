"""Kernels A and A′ (``mdvit::factorized_attention``, ``…_bwd``): their
least time by FLOPs or bytes over the device time they took, %."""
from portbench.trace import roofline_pct

OPS = ("mdvit::factorized_attention", "mdvit::factorized_attention_bwd")


def read(w):
    return roofline_pct(w, OPS)
