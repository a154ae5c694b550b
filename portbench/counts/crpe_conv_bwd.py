"""``mdvit::crpe_conv_bwd(q, v, w, b, g)`` → (dq, dv, [dw; db] (K²+1, C)
fp32): dq = g ⊙ (conv(v) + b) (2·K² + 2 a value), u = g ⊙ q (1), dv =
conv(u, w turned) (2·K²), dw = Σ v·u (2·K²), db = Σ u (1). Reads q, v, w, b,
g, writes dq, dv and the fp32 dw, db."""


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    bb, h, w, c = shapes[0]
    k = shapes[2][0]
    vals = bb * h * w * c
    return (float(vals * (6 * k * k + 4)),
            float((5 * vals + k * k * c + c) * elem_bytes + (k * k + 1) * c * 4))
