"""The FLOP and byte counts of the custom ops, against hand counts at one
shape each."""
from __future__ import annotations

from portbench.counts import counter


def test_factorized_attention():
    # B=2, N=64, C=16 (2 heads of ch 8): per value 4·8 + 6 = 38
    assert counter("mdvit::factorized_attention")([[2, 64, 16]] * 3 + [[], []],
                                                  [None] * 3 + [8, 0.35], 4) == (
        2 * 64 * 16 * 38.0, 4 * 2 * 64 * 16 * 4.0)


def test_factorized_attention_bwd():
    assert counter("mdvit::factorized_attention_bwd")([[2, 64, 16]] * 4 + [[], []],
                                                      [None] * 4 + [8, 0.35], 4) == (
        2 * 64 * 16 * 91.0, 7 * 2 * 64 * 16 * 4.0)


def test_cpe_conv():
    # x (1, 4, 4, 8), w (3, 3, 8): 128 values · (18 + 2); x, out, w, b
    assert counter("mdvit::cpe_conv")([[1, 4, 4, 8], [3, 3, 8], [8]], [None] * 3, 4) == (
        128 * 20.0, (2 * 128 + 72 + 8) * 4.0)


def test_cpe_conv_bwd():
    assert counter("mdvit::cpe_conv_bwd")([[1, 4, 4, 8], [3, 3, 8], [1, 4, 4, 8]],
                                          [None] * 3, 4) == (
        128 * 38.0, (3 * 128 + 72) * 4.0 + 10 * 8 * 4)


def test_crpe_conv():
    assert counter("mdvit::crpe_conv")([[1, 4, 4, 8], [1, 4, 4, 8], [7, 7, 8], [8]],
                                       [None] * 4, 2) == (
        128 * 100.0, (3 * 128 + 392 + 8) * 2.0)


def test_crpe_conv_bwd():
    assert counter("mdvit::crpe_conv_bwd")([[1, 4, 4, 8], [1, 4, 4, 8], [7, 7, 8], [8],
                                            [1, 4, 4, 8]], [None] * 5, 4) == (
        128 * 298.0, (5 * 128 + 392 + 8) * 4.0 + 50 * 8 * 4)
