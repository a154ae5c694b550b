"""``mdvit::factorized_attention_partials(k, v, ch)``: k, v (B, N, C), C =
heads·ch → the fp32 workspace (B·heads, S·P) of one rank's chunks, S = ⌈N /
rows⌉, each [m_s, l_s, T_s]. Per value of k: the chunk's max, subtract, exp
and sum (4), T_s += e·v (2·ch). Reads k, v, writes the workspace.

The workspace is counted in a layout fixed here, not read from the system
under test, so that a change of the system's layout moves the roofline
against the same bytes: the head width padded to the next of ``BUCKETS``
(W), N cut into chunks of ``ROWS[W]`` token rows (``FWD_ROWS[W]`` forward),
P = 2·W + W² values a chunk forward (m_s, l_s, T_s), 2·W + 2·W² backward
(and D_s): the system's layout as this count was written."""

BUCKETS = (8, 12, 16, 20, 24, 28, 32, 36, 40, 48, 64)
ROWS = {8: 256, 12: 192, 16: 128, 20: 128, 24: 96, 28: 80, 32: 64, 36: 64, 40: 64, 48: 48,
        64: 32}
FWD_ROWS = {**ROWS, 64: 64}


def workspace_floats(b: int, n: int, c: int, ch: int, grad: bool) -> int:
    w = next(x for x in BUCKETS if x >= ch)
    rows = (ROWS if grad else FWD_ROWS)[w]
    return b * (c // ch) * -(-n // rows) * (2 * w + (2 if grad else 1) * w * w)


def count(shapes, args, elem_bytes: int) -> tuple[float, float]:
    b, n, c = shapes[0]
    ch = args[2]
    return (float(b * n * c * (2 * ch + 4)),
            float(2 * b * n * c * elem_bytes + 4 * workspace_floats(b, n, c, ch, False)))
