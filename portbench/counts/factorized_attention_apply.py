"""``mdvit::factorized_attention_apply(q, ws, ch, scale)``: q (B, N, C), ws
the gathered fp32 workspace of every rank's partials → scale·q_h·T_h (B, N,
C). The fold scales and adds each workspace value (2 a value); Q·T 2·ch and
the scale 1 a value of q. Reads q and the whole gathered workspace, writes
the output."""
import math


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    b, n, c = shapes[0]
    ch = args[2]
    ws = math.prod(shapes[1])
    return (float(b * n * c * (2 * ch + 1) + 2 * ws),
            float(2 * b * n * c * elem_bytes + 4 * ws))
