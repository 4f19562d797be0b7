"""The port's ``auto_trainer.evaluate`` and trainer interface
(``apply_mlrun`` / ``TorchTrainerInterface``) against the JAX package's
on the CPU. Each package evaluates from a checkpoint its own
``CheckpointManager`` wrote after the same two training steps from the
same converted tiny float32 init.

Bounds: ``eval_loss`` and ``eval_accuracy`` within 1e-4 relative (the
training parity bound of ``tests/test_torch_training.py``), the token
count equal.

The reference's ``evaluate`` restores only a checkpoint of the form
``{"params", "opt_state": None, "step"}``; the port's also reads the
params of a full train-state checkpoint, as ``train`` writes it (a
departure kept on purpose, ROADMAP.md queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.frameworks.jax import auto_trainer as jauto
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.training import CheckpointManager
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain
from tests.torch_registries import registries_left_as_found  # noqa: F401

RUN_REL_TOL = 1e-4
EVAL = dict(model="tiny", batch_size=2, seq_len=32, steps=3, seed=4,
            mesh_shape={"fsdp": 1})


def _trained(tmp_path) -> tuple:
    """Two steps of both Trainers from the reference's init: (the
    reference's Trainer, the port's)."""
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jt = jtrain.Trainer(jcfg, jtrain.TrainConfig(learning_rate=1e-2,
                                                 warmup_steps=1,
                                                 mesh_shape={"fsdp": 1}))
    jt.init(0)
    tt = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                        ttrain.TrainConfig(learning_rate=1e-2,
                                           warmup_steps=1), device="cpu")
    tt.init(params=params_from_numpy(jax.tree.map(np.asarray,
                                                  jt.state.params), "cpu"))
    jt.fit(jdata.synthetic_token_stream(2, 32, 512, seed=1), 2)
    tt.fit(tdata.synthetic_token_stream(2, 32, 512, seed=1), 2)
    return jt, tt


def _jax_save(directory, state):
    from mlrun_tpu.training import CheckpointManager as JManager

    manager = JManager(directory)
    manager.save(2, state, force=True)
    manager.wait()
    manager.close()
    return directory


def test_evaluate_from_checkpoints_matches_reference(tmp_path):
    """Each package restores the trained params from a checkpoint of the
    form the reference's ``evaluate`` restores (``{"params", "opt_state":
    None, "step"}``) written by its own manager."""
    jt, tt = _trained(tmp_path)
    jdir = _jax_save(str(tmp_path / "j"), {"params": jt.state.params,
                                           "opt_state": None, "step": 2})
    tdir = str(tmp_path / "t")
    CheckpointManager(tdir).save(2, {"params": tt.state.params,
                                     "opt_state": None, "step": 2})
    ref = jauto.evaluate(model_overrides={"dtype": jnp.float32,
                                          "attention_impl": "reference"},
                         checkpoint_dir=jdir, **EVAL)
    ours = tauto.evaluate(model_overrides={"dtype": torch.float32},
                          checkpoint_dir=tdir, device="cpu", **EVAL)
    assert set(ours) == set(ref) == {"eval_loss", "eval_accuracy",
                                     "eval_tokens"}
    assert ours["eval_tokens"] == ref["eval_tokens"] == 64.0
    for key in ("eval_loss", "eval_accuracy"):
        assert abs(ours[key] - ref[key]) <= RUN_REL_TOL * max(abs(ref[key]),
                                                             1.0), key
    # the restored params, not a fresh draw from the seed
    fresh = tauto.evaluate(model_overrides={"dtype": torch.float32},
                           device="cpu", **EVAL)
    assert fresh["eval_loss"] != ours["eval_loss"]


def test_evaluate_reads_a_train_checkpoint_where_the_reference_raises(
        tmp_path):
    """A departure kept on purpose: the port's ``evaluate`` reads the
    params of a full train-state checkpoint (what ``train`` writes) and
    gives what it gives on the params-only form; the reference's raises
    there (orbax refuses the ``opt_state: None`` restore item against the
    saved optimizer state)."""
    jt, tt = _trained(tmp_path)
    jdir = _jax_save(str(tmp_path / "j"), jt.state)
    with pytest.raises(ValueError, match="do not match"):
        jauto.evaluate(model_overrides={"dtype": jnp.float32,
                                        "attention_impl": "reference"},
                       checkpoint_dir=jdir, **EVAL)
    full, params_only = str(tmp_path / "full"), str(tmp_path / "params")
    CheckpointManager(full).save(2, tt.state)
    CheckpointManager(params_only).save(2, {"params": tt.state.params,
                                            "opt_state": None, "step": 2})
    a, b = (tauto.evaluate(model_overrides={"dtype": torch.float32},
                           checkpoint_dir=d, device="cpu", **EVAL)
            for d in (full, params_only))
    assert a == b


def test_evaluate_reads_the_params_alone(tmp_path, monkeypatch):
    """A train-state checkpoint keeps its params in a file of their own:
    ``evaluate`` loads that file and never the optimizer state, while a
    full ``restore`` still gives back params and moments bit for bit."""
    _, tt = _trained(tmp_path)
    manager = CheckpointManager(str(tmp_path / "ck"))
    manager.save(2, tt.state)
    assert sorted(p.name for p in (tmp_path / "ck" / "2").iterdir()) == [
        "params.pt", "state.pt"]
    loaded, load = [], torch.load
    monkeypatch.setattr(torch, "load", lambda path, *a, **kw: (
        loaded.append(str(path).rsplit("/", 1)[-1]), load(path, *a, **kw))[1])
    tauto.evaluate(model_overrides={"dtype": torch.float32},
                   checkpoint_dir=str(tmp_path / "ck"), device="cpu", **EVAL)
    assert loaded == ["params.pt"]
    restored = manager.restore(tt.state)
    for state in ("params", "mu", "nu"):
        got = ttrain.tree_leaves({"params": restored.params,
                                  **vars(restored.opt_state)}[state])
        want = ttrain.tree_leaves({"params": tt.state.params,
                                   **vars(tt.state.opt_state)}[state])
        assert len(got) == len(want) > 0
        assert all(torch.equal(g, w) for g, w in zip(got, want)), state
    assert restored.step == tt.state.step


def test_evaluate_logs_results_and_refuses_a_mesh():
    logged = {}

    class Context:
        def log_results(self, results):
            logged.update(results)

    out = tauto.evaluate(context=Context(), model="tiny", batch_size=2,
                         seq_len=16, steps=1, device="cpu")
    assert logged == out and np.isfinite(out["eval_loss"])
    # a data x fsdp mesh landed with item 7's first half (evaluated over
    # gloo ranks in tests/test_torch_parallel.py); one process has one
    # device for it, and no group is joined before that is known
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tauto.evaluate(model="tiny", mesh_shape={"data": 2}, device="cpu")


def test_evaluate_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tauto.evaluate(model="tiny", steps=1)


class _Context:
    def __init__(self):
        self.calls = []

    def log_metrics(self, metrics, step=None):
        self.calls.append(("log_metrics", metrics, step))

    def log_model(self, key, **kwargs):
        self.calls.append(("log_model", key, kwargs))
        return key


def test_trainer_interface_forwards_like_reference(tmp_path):
    """``apply_mlrun`` wraps a context: metrics and the model (as a
    ``torch`` framework model at the checkpoint directory) are forwarded
    as the reference's interface forwards them (``jax``); without a
    context both are no-ops."""
    contexts = [_Context(), _Context()]
    for module, context in zip((jauto, tauto), contexts):
        interface = module.apply_mlrun(context=context, model_name="llama",
                                       tag="v1")
        interface.log_metrics({"loss": 1.5}, step=3)
        assert interface.log_model(
            checkpoint_dir=str(tmp_path), metrics={"loss": 1.5},
            parameters={"steps": 3}) == "llama"
    (jm, jmodel), (tm, tmodel) = (c.calls for c in contexts)
    assert tm == jm == ("log_metrics", {"loss": 1.5}, 3)
    assert jmodel[2].pop("framework") == "jax"
    assert tmodel[2].pop("framework") == "torch"
    assert tmodel == jmodel
    assert tmodel[2]["model_dir"] == tmodel[2]["target_path"] == str(tmp_path)
    assert isinstance(tauto.apply_mlrun(), tauto.TorchTrainerInterface)
    assert tauto.apply_mlrun().log_model(str(tmp_path)) is None
