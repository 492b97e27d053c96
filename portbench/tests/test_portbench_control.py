"""The control on the card: the program with TF32 on, the nearest
precision below the configurations' float32, must come out not correct
in every cell, at the cell's own size (run on the card:
``python -m pytest --noconftest -m gpu portbench/tests``)."""

import pytest

from portbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


CELLS = ["mnist40.train", "cifar10.train", "mnist40.serve.bulk"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    from portbench import calibrate

    limits = harness.cell_files(cell)[4]
    for control in (None, "tf32"):
        got = calibrate.readings(cell, 2 ** 31 + 21, 2.0, control=control)
        nums = got["control" if control else "program"]
        checks = [(n, v, limits[n]) for n, v in nums.items()]
        assert harness.is_correct(checks) == (control is None), checks
