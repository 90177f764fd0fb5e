"""The harness on the card at a size a test run holds: a sound run of each
tiny cell through the kernels is correct, and the control fails. Marked
`cuda`; each test decides in the `cuda` fixture whether a card is here.

    python -m pytest -p no:cacheprovider gebench/tests -m cuda
"""

from __future__ import annotations

import pytest

from gebench import control, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.rand", "tiny.admix"])
def test_tiny_cell_on_card(cuda, tiny, cell):
    res = run.run_cell(run.load_cell(tiny, cell), 21, 0.01, False,
                       device=cuda, work=tiny / "work", log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_control_fails_on_card(cuda, tiny):
    (res,) = control.readings(run.load_cell(tiny, "tiny.rand"), [22],
                              device=cuda, work=tiny / "work")
    assert not res["correct"], res
