"""``mdvit::factorized_attention_bwd_apply(k, v, g, ws, ch, scale)`` → (dq,
dk, dv), each (B, N, C), from the gathered fp32 workspace: the fold (2 a
workspace value); per value ks = exp(k − M)/L (3), dq = scale·g·Tᵀ (2·ch +
1), dv = ks·dT and dks = v·dTᵀ (2·ch each), dk = ks ⊙ (dks − inner) (2).
Reads k, v, g and the whole gathered workspace, writes dq, dk, dv."""
import math


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    b, n, c = shapes[0]
    ch = args[4]
    ws = math.prod(shapes[3])
    return (float(b * n * c * (6 * ch + 6) + 2 * ws),
            float(6 * b * n * c * elem_bytes + 4 * ws))
