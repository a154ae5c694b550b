"""``mdvit::crpe_conv(q, v, w, b)``: q, v (B, H, W, C), w (K, K, C), b (C,)
→ q ⊙ (depthwise conv(v) + b): 2·K² a value for the taps, 2 for the bias
and the gate. Reads q, v, w, b, writes the output."""


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    bb, h, w, c = shapes[0]
    k = shapes[2][0]
    vals = bb * h * w * c
    return float(vals * (2 * k * k + 2)), float((3 * vals + k * k * c + c) * elem_bytes)
