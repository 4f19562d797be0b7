"""The lower-precision control comes out not correct where the program
passes: the plain reference computed in float8 (the precision below the
configurations' bf16) put in the program's place, read by the cells' own
numbers and limits, at CPU size with the weights in bf16. On the card at
the cells' sizes: ``test_perfbench_card.py`` and ``calibrate.py seeds
--control fp8``."""

import time

import pytest

import run as runmod
import tiny

SEED = 2 ** 31 + 21


@pytest.mark.parametrize("name", ["mistral-7b.chat-prefix",
                                  "mistral-7b.batch-decode",
                                  "mixtral-8x7b.train-8k"])
def test_control_fails_the_check_the_program_passes(name):
    sizes = dict(tiny.sizes(name), dtype="bfloat16")
    cell = tiny.cell(name)
    record = runmod.run_cell(cell, SEED, 4.0, False, "cpu",
                             time.perf_counter(), config_overrides=sizes,
                             control="fp8")
    check = record["check"]
    assert check["correct"] is True, check["numbers"]
    limits = cell.traffic["check"]
    control = check["control"]
    if "max_gap_logit" in control:
        assert control["max_gap_logit"] > limits["max_gap_logit"]
    else:
        assert any(n["value"] > n["limit"] for n in control["numbers"])
