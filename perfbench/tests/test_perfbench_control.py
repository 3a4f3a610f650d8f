"""The control on the card: the program with TF32 on in its float32
matmuls (the next precision down from what the configurations state)
fails each cell's check, where the program as it is passes it.  At the
cell's own size the same readings come from ``perfbench/calibrate.py``;
here the tracks are seconds long."""

import pytest

from perfbench import calibrate

CELLS = {
    "song44k.process_wav16": "code_mismatch_pct",
    "longform96k.master": "rel_rms_error",
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_fails_and_the_program_passes(card, tiny, name):
    cell = tiny(name)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        sound = calibrate.readings(cell, seed, False, "cuda")["checks"]
        control = calibrate.readings(cell, seed, True, "cuda")["checks"]
        assert all(sound[k] <= cell.limits[k] for k in cell.limits), sound
        assert control[CELLS[name]] > cell.limits[CELLS[name]], control
