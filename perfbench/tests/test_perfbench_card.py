"""On the card, at the cells' own sizes: a sound run of each serving cell
is correct, and the lower-precision control (the reference in float8 in
the program's place) is not. Each test decides inside itself whether
there is a card."""

import time

import pytest

import run as runmod
import tiny


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    runmod._environment()
    from mlrun_tpu_torch.utils import compile_cache

    compile_cache.configure(str(runmod.CACHE / "kernels"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mistral-7b.chat-prefix",
                                  "mistral-7b.batch-decode"])
def test_control_fails_where_the_program_passes(name):
    _card()
    cell = tiny.full_cell(name)
    record = runmod.run_cell(cell, 2 ** 31 + 99, 30.0, False, "cuda",
                             time.perf_counter(), control="fp8")
    check = record["check"]
    assert check["correct"] is True, check["numbers"]
    limit = cell.traffic["check"]["max_gap_logit"]
    assert check["control"]["max_gap_logit"] > limit
