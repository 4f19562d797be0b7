"""The check comes out false when the timed path is broken: each cell is
driven at CPU size past the harness's look for a chip, with one fault of
those the cell can have planted where the port produces its answer, and
once sound. One chip, so no cell has an exchange between chips to leave
out."""

import time

import pytest

import calibrate
import run as runmod
import tiny


def _run(name, fault=None, control=None):
    cell = tiny.cell(name)
    return runmod.run_cell(cell, 2 ** 31 + 21, 4.0, False, "cpu",
                           time.perf_counter(),
                           config_overrides=tiny.sizes(name),
                           fault=fault, control=control)


@pytest.mark.parametrize("name", ["mistral-7b.chat-prefix",
                                  "mistral-7b.batch-decode"])
def test_serving_check_catches_an_altered_token(name):
    sound = _run(name)
    assert sound["check"]["correct"] is True
    broken = _run(name, fault=calibrate._faults("altered_token"))
    assert broken["check"]["correct"] is False
    gap = broken["check"]["numbers"][0]
    assert gap["name"] == "max_gap_logit" and gap["value"] > gap["limit"]


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_training_check_catches_a_broken_step(fault):
    broken = _run("mixtral-8x7b.train-8k", fault=calibrate._faults(fault))
    assert broken["check"]["correct"] is False


def test_training_check_passes_a_sound_run():
    sound = _run("mixtral-8x7b.train-8k")
    assert sound["check"]["correct"] is True, sound["check"]
