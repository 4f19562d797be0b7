"""The sharded checkpoint and the resume directive (item 7, first half):
two gloo ranks on {"fsdp": 2} (tests/torch_ranks.py) save the DTensor
train state through ``torch.distributed.checkpoint`` every 2 steps; a
fresh Trainer resumes from step 2 by the environment directive and its
steps 3-4 equal the uninterrupted run's bit for bit. Without a
directive, or with one naming a step that is not there, a fit starts
fresh (the reference's ``_maybe_resume``). ``restore_params`` and
``evaluate`` read the sharded checkpoint in one process. Everything here
is exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.common import runtimes_constants as jconstants
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.training import checkpoint as jcheckpoint
from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.training import CheckpointManager
from mlrun_tpu_torch.training import checkpoint as tcheckpoint
from mlrun_tpu_torch.training import data as tdata
from tests.torch_ranks import run_ranks


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    init = jax.tree.map(np.asarray, jllama.init_params(
        jllama.tiny_llama(dtype=jnp.float32), jax.random.PRNGKey(0)))
    stream = tdata.synthetic_token_stream(4, 32, 512, seed=5)
    batches = [next(stream) for _ in range(4)]
    directory = str(tmp_path_factory.mktemp("sharded") / "ck")
    ranks = run_ranks("sharded_checkpoint", 2,
                      tmp_path_factory.mktemp("ranks"), init=init,
                      batches=batches, ckpt_dir=directory)
    return directory, batches, ranks


def test_resume_by_directive_is_bit_equal(resumed):
    _, _, ranks = resumed
    for out in ranks:
        assert out["saved"] == [2, 4]
        run = out["resumed"]
        assert run["step"] == 4 and run["steps_logged"] == [3, 4]
        assert run["losses"] == out["uninterrupted"][2:]
        # the restore is checkpoint badput, the first dispatch after it
        # re_warm (a resumed run's build), as the reference attributes them
        assert {"checkpoint", "re_warm"} <= set(run["goodput"]["badput"])
    assert ranks[0]["uninterrupted"] == ranks[1]["uninterrupted"]


@pytest.mark.parametrize("case", ["no_directive", "bad_step"])
def test_no_directive_and_a_missing_step_start_fresh(resumed, case):
    """No directive: no restore. A directive naming step 99: the restore
    fails, a warning is logged and the run starts from step 0."""
    for out in resumed[2]:
        run = out[case]
        assert run["step"] == 1 and run["steps_logged"] == [1]
        assert run["losses"] == out["uninterrupted"][:1]
        assert ("re_warm" in run["goodput"]["badput"]) is (
            case == "bad_step")


def test_restore_params_and_evaluate_read_the_sharded_checkpoint(resumed):
    """In one process, no group: the params of step 4 come back whole and
    bit-equal to the ranks' gathered params; ``evaluate`` on them equals a
    direct ``loss_fn``."""
    directory, _, ranks = resumed
    manager = CheckpointManager(directory)
    assert manager.latest_step() == 4
    assert sorted(os.listdir(os.path.join(directory, "4")))[0] == \
        tcheckpoint.DCP_METADATA
    params = manager.restore_params()
    flat = dict(_leaves(params))
    for path, value in _leaves(ranks[0]["params"]):
        np.testing.assert_array_equal(flat[path].numpy(), value)
    config = tllama.tiny_llama(dtype=torch.float32)
    results = tauto.evaluate(model="tiny", model_overrides={
        "dtype": torch.float32}, checkpoint_dir=directory, batch_size=2,
        seq_len=32, steps=2, seed=9, device="cpu")
    stream = tdata.synthetic_token_stream(2, 32, 512, seed=9)
    direct = []
    with torch.no_grad():
        for _ in range(2):
            tokens, targets = tdata.to_device(next(stream), "cpu")
            direct.append(float(tllama.loss_fn(
                config, params_from_numpy(ranks[0]["params"], "cpu"),
                tokens, targets)[1]["loss"]))
    assert results["eval_loss"] == sum(direct) / 2


@pytest.mark.parametrize("env", [{}, {"path": "/ck"},
                                 {"path": "/ck", "step": "7"},
                                 {"path": "/ck", "step": "seven"},
                                 {"step": "3"}])
def test_resume_directive_reads_the_reference_environment(monkeypatch, env):
    assert (tcheckpoint.RESUME_CHECKPOINT_ENV,
            tcheckpoint.RESUME_STEP_ENV) == (
        jconstants.RESUME_CHECKPOINT_ENV, jconstants.RESUME_STEP_ENV)
    for name, key in ((tcheckpoint.RESUME_CHECKPOINT_ENV, "path"),
                      (tcheckpoint.RESUME_STEP_ENV, "step")):
        if key in env:
            monkeypatch.setenv(name, env[key])
        else:
            monkeypatch.delenv(name, raising=False)
    assert tcheckpoint.resume_directive() == jcheckpoint.resume_directive()
