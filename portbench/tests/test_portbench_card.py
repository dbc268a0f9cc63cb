"""The cells on a card, briefly: each one-card cell (the parked grid's
too) runs a short window and must come out correct. Skipped without a
card; on the card's machine: ``python -m pytest portbench/tests -q -m
cuda``."""

import time

import pytest

from portbench.harness.report import run_cell
from portbench.tests.tiny_cells import find_any


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train_utk128", "train_cacd256",
                                  "grid_utk128"])
def test_cell_on_the_card(card, name):
    line, checks = run_cell(find_any(name), 2 ** 31 + 77, 2.0, False,
                            time.time())
    assert line["correct"], checks
    assert line["device"]["platform"] == "gpu"
