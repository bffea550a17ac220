"""The DP kernel's work, counted from its inputs, against a hand count."""

from portbench.harness import k1work


def test_hand_count():
    # two real items of 100 and 300 query bases, one padding row; L 512,
    # T 768, W 64: steps 100 + 767 and 300 + 767 (both under S = 1279)
    cells, ops, nbytes = k1work.call_work([100, 0, 300], 512, 768, 64, "none", False, True)
    assert cells == (867 + 1067) * 64
    assert ops == cells * (33 + 15)
    assert nbytes == 2 * (512 + 768 + 12) + 4 * 1279 + 2 * 12 + 2 * cells


def test_quality_and_matrix_add_operations():
    c, o, b = k1work.call_work([2000], 2048, 2304, 256, "single", True, False, knots_per_item=68)
    assert c == (2000 + 2304 - 1) * 256
    assert o == c * (33 + 12 + 2)
    assert b == 2048 + 2304 + 12 + 2048 + 4 * 68 + 12
    assert k1work.call_work([10], 16, 32, 32, "dual", False, False)[1] == 41 * 32 * (33 + 14)
