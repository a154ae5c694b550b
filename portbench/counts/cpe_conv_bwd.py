"""``mdvit::cpe_conv_bwd(x, w, g)`` → (dx, [dw; db] (K²+1, C) fp32): dx =
conv(g, w turned) + g (2·K² + 1 a value), dw = Σ x·g over the batch and
space (2·K²), db = Σ g (1). Reads x, w, g, writes dx and the fp32 dw, db."""


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    bb, h, w, c = shapes[0]
    k = shapes[1][0]
    vals = bb * h * w * c
    return (float(vals * (4 * k * k + 2)),
            float((3 * vals + k * k * c) * elem_bytes + (k * k + 1) * c * 4))
