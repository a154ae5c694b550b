"""Kernels A and A′ split around their workspace gather under context
parallelism (``mdvit::factorized_attention_partials``, ``…_apply``,
``…_bwd_partials``, ``…_bwd_apply``): their least time by FLOPs or bytes
over the device time they took, %."""
from portbench.trace import roofline_pct

OPS = ("mdvit::factorized_attention_partials", "mdvit::factorized_attention_apply",
       "mdvit::factorized_attention_bwd_partials", "mdvit::factorized_attention_bwd_apply")


def read(w):
    return roofline_pct(w, OPS)
