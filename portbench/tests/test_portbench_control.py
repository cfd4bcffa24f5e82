"""The check's control on the card at a test size: the reference computed
in TF32 in the program's place reads not correct by the runs' own
comparison against a cell's limits, and so does a fault (half of each
batch left out) in a training cell, while the program reads correct. At
the cells' own size ``portbench/control.py`` gives the same verdicts (its
exit code), as run on the card for the limits' files."""
import json

import pytest

from portbench import control

CELLS = ("tiny_lowrank.tiny_train_flat", "tiny_lowrank.tiny_serve_orbit")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, tiny_root, capsys, cell):
    variants = "tf32,half_batch" if "train" in cell else "tf32"
    assert control.main(["--workload", cell, "--seeds", "11,12,13",
                         "--variants", variants, "--frames", "4"],
                        root=tiny_root, device=card) == 0
    for line in capsys.readouterr().out.strip().splitlines():
        row = json.loads(line)
        assert row["program"]["correct"], row
        assert not any(row[v]["correct"] for v in variants.split(",")), row
