"""``mdvit::cpe_conv(x, w, b)``: x (B, H, W, C), w (K, K, C), b (C,) →
depthwise conv(x) + b + x: 2·K² a value for the taps, 2 for the bias and
the residual. Reads x, w, b, writes the output."""


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    bb, h, w, c = shapes[0]
    k = shapes[1][0]
    vals = bb * h * w * c
    return float(vals * (2 * k * k + 2)), float((2 * vals + k * k * c + c) * elem_bytes)
