"""``mdvit::factorized_attention_bwd(q, k, v, g, ch, scale)`` → (dq, dk, dv),
each (B, N, C): the softmax again (5 a value), T = ksᵀv, dT = qᵀg,
dq = g·Tᵀ, dv = ks·dT, dks = v·dTᵀ (2·ch a value each), dk =
ks ⊙ (dks − Σ_N ks ⊙ dks) (4) and the two scales (2). Reads q, k, v, g,
writes dq, dk, dv."""


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    b, n, c = shapes[0]
    ch = args[4]
    return float(b * n * c * (10 * ch + 11)), float(7 * b * n * c * elem_bytes)
