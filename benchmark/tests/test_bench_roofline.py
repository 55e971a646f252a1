"""The frozen flat-sweep arithmetic against hand counts."""

import pytest

from harness import roofline


def test_sweep_bound_by_hand():
    # 1000 rays against 2 spheres, 1 rect and 1 triangle, in 3 launches
    b = roofline.sweep_bound(1000, 3, {"spheres": 2, "rects": 1,
                                       "triangles": 1})
    flops = 1000 * (2 * 17 + 6 + 38)
    nbytes = 1000 * 178 + 3 * (2 * 20 + 36 + 104)
    assert b["flops"] == flops and b["bytes"] == nbytes
    assert b["bound_s"] == pytest.approx(max(flops / 67e12, nbytes / 3.35e12))
    assert b["bound_by"] == "bytes"


def test_scene500_sweep_is_bound_by_operations():
    b = roofline.sweep_bound(71_471_853, 506, {"spheres": 1005, "rects": 0,
                                               "triangles": 0})
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(71_471_853 * 1005 * 17 / 67e12)
