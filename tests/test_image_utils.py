"""Unit tests for the golden comparison helper (no rendering).

``golden_diff_ok`` compares a render against a golden image; the
edge-flip mode exists for negative-material scenes that route through
the per-backend XLA fallback, where knife-edge hit/miss pixels may
legitimately flip between a CPU golden and an accelerator render."""

import numpy as np

from rt_rs_tpu.utils.image import golden_diff_ok


def _golden():
    g = np.zeros((8, 8, 3), np.uint8)
    g[:4] = [200, 90, 90]  # bright top half, hard edge at row 4
    return g


def test_strict_equal_passes():
    g = _golden()
    ok, detail = golden_diff_ok(g, g)
    assert ok and "max 0" in detail


def test_rounding_jitter_passes_strict():
    g = _golden()
    img = g.copy()
    img[0, 0] = [202, 92, 88]  # +-2 on one pixel
    assert golden_diff_ok(img, g)[0]


def test_edge_flip_rejected_without_flag():
    g = _golden()
    img = g.copy()
    img[3, 5] = 0  # boundary pixel flips to the dark side
    ok, _ = golden_diff_ok(img, g)
    assert not ok


def test_edge_flip_accepted_with_flag():
    g = _golden()
    img = g.copy()
    img[3, 5] = 0  # neighbor row 4 is exactly this value -> real edge
    ok, detail = golden_diff_ok(
        img, g, allow_edge_flips=True, edge_px_frac=0.05
    )
    assert ok and "edge flips OK" in detail


def test_interior_divergence_rejected_even_with_flag():
    g = _golden()
    img = g.copy()
    img[1, 5] = 0  # interior of the bright region: no neighbor matches
    ok, detail = golden_diff_ok(
        img, g, allow_edge_flips=True, edge_px_frac=0.05
    )
    assert not ok and "non-edge" in detail


def test_wrong_color_on_edge_rejected():
    g = _golden()
    img = g.copy()
    img[3, 5] = [0, 255, 0]  # on the edge but matches neither side
    assert not golden_diff_ok(
        img, g, allow_edge_flips=True, edge_px_frac=0.05
    )[0]


def test_flip_budget_enforced():
    g = _golden()
    img = g.copy()
    img[3] = 0  # whole boundary row flips: 8/64 px >> budget
    ok, detail = golden_diff_ok(
        img, g, allow_edge_flips=True, edge_px_frac=0.05
    )
    assert not ok and "over budget" in detail
