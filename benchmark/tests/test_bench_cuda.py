"""The tiny cells on the card, through the port's kernels (cuda-marked;
skips without a card): a sound run comes out correct and traced, with the
launch counts the roofline assumes, and the control does not."""

import time

import pytest

from benchmark import control, harness, manifest, program
from tiny import write_root


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-musicldm.inpaint-dps", "tiny-audioldm2-music.generate-cfg"])
def test_tiny_cell_on_the_card(card, tmp_path, name):
    root = tmp_path
    write_root(root)
    spec = manifest.load(name, root)
    r = harness.run_cell(spec, 2 ** 31 + 17, 3.0, True, card, time.perf_counter(), program)
    assert r["correct"], r["checks"]
    assert r["summary"]["busy_s"] > 0 and r["summary"]["acts"]
    numbers = control.control_readings(spec, 2 ** 31 + 18, card)["numbers"]
    assert any(v > spec["limits"][k] for k, v in numbers.items()), numbers
