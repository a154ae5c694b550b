"""``mdvit::factorized_attention_bwd_partials(q, k, v, g, ch)``: q, k, v, g
(B, N, C) → the fp32 workspace (B·heads, S·P) of one rank's chunks, each
[m_s, l_s, T_s, D_s]. Per value: the chunk's max, subtract, exp and sum (4),
T_s += e·v and D_s += qᵀg (2·ch each). Reads q, k, v, g, writes the
workspace."""
from portbench.counts.factorized_attention_partials import workspace_floats


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    b, n, c = shapes[0]
    ch = args[4]
    return (float(b * n * c * (4 * ch + 4)),
            float(4 * b * n * c * elem_bytes + 4 * workspace_floats(b, n, c, ch, True)))
