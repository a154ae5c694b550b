"""``mdvit::factorized_attention(q, k, v, ch, scale)``: q, k, v (B, N, C),
C = heads·ch → scale·q_h·(softmax_N(k_h)ᵀ v_h) (B, N, C). Per value of k:
the softmax's max, subtract, exp, sum and divide (5); KᵀV and Q·T
2·ch each; the scale 1. Reads q, k, v, writes the output."""


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    b, n, c = shapes[0]
    ch = args[3]
    return float(b * n * c * (4 * ch + 6)), float(4 * b * n * c * elem_bytes)
