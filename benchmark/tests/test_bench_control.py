"""The control, the reference computed in bfloat16 in the program's
place, comes out not correct at a size a test run holds. (On the card
the control runs at each cell's own size: ``benchmark/control.py``.)"""

import pytest
import torch

from conftest import ROOT


@pytest.mark.parametrize("kind,passes", [("pt", 0), ("nee", 0), ("gather", 0),
                                         ("iter", 12)])
def test_control_fails(tiny, kind, passes):
    import control
    root, name = tiny(kind)
    out = control.control(name, 99, passes, torch.bfloat16, "cpu",
                          root=root, data_root=ROOT)
    assert out["fails"], out
