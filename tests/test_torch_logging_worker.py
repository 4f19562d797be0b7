"""Which process logs, and the artifact plans: the port's
``execution.is_logging_worker`` on the env cases of the reference's
``tests/test_execution.py::test_is_logging_worker_rank`` with torchrun's
``RANK`` added; a 2-rank gloo ``Trainer.fit`` with
``MetricsLoggingCallback`` and ``EvalPlanCallback`` over a context without
``is_logging_worker``, where only rank 0 logs; and ``EvalPlanCallback``
with ``ConfusionMatrixPlan`` on both packages (the reference's
``tests/test_callbacks.py::test_eval_plan_callback_produces_epoch_artifacts``):
the same artifact keys and the same confusion-matrix numbers (image bytes
are not compared).

Bounds: keys, counts and confusion matrices equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlrun_tpu.frameworks import _common as jcommon
from mlrun_tpu.models import llama as jllama
from mlrun_tpu_torch import execution as texec
from mlrun_tpu_torch.frameworks import _common as tcommon
from mlrun_tpu_torch.training import data as tdata
from tests.torch_ranks import run_ranks

ENVS = ("RANK", "MLT_WORKER_RANK", "JAX_PROCESS_INDEX", "TPU_WORKER_ID")


@pytest.fixture(autouse=True)
def _no_rank_env(monkeypatch):
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)


@pytest.mark.parametrize("env,value,want", [
    ("RANK", "1", False), ("RANK", "0", True),
    ("MLT_WORKER_RANK", "1", False), ("MLT_WORKER_RANK", "0", True),
    ("MLT_WORKER_RANK", "0:3", True), ("MLT_WORKER_RANK", "", True),
    (None, None, True)])
def test_is_logging_worker_rank(monkeypatch, env, value, want):
    if env is not None:
        monkeypatch.setenv(env, value)
    assert texec.is_logging_worker() is want


def test_rank_env_wins_and_the_context_decides_first(monkeypatch):
    """torchrun's global RANK outranks a per-pod index; a context with its
    own is_logging_worker is asked instead."""
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("MLT_WORKER_RANK", "0")
    assert not texec.is_logging_worker()

    class Ctx:
        def is_logging_worker(self):
            return True

    assert texec.logging_worker(Ctx())
    assert not texec.logging_worker(object())


def test_two_rank_fit_logs_from_rank_zero_only(tmp_path):
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    init = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    stream = tdata.synthetic_token_stream(4, 16, 512, seed=1)
    batches = [tuple(np.asarray(x) for x in next(stream)) for _ in range(4)]
    y_true = np.array([0, 1, 1, 0, 1, 0])
    y_pred = np.array([0, 1, 0, 0, 1, 1])
    first, second = run_ranks("logging_worker", 2, tmp_path, init=init,
                              batches=batches, y_true=y_true, y_pred=y_pred)
    assert first["worker"] and not second["worker"]
    assert second["metrics"] == [] and second["artifacts"] == []
    # two fit log points and two epoch ends
    assert len(first["metrics"]) == 4
    assert first["artifacts"] == ["confusion_matrix-epoch0",
                                  "confusion_matrix-epoch1",
                                  "confusion_matrix"]
    assert not first["jax_imported"] and not second["jax_imported"]


class _Context:
    def __init__(self):
        self.artifacts = []

    def is_logging_worker(self):
        return True

    def log_artifact(self, key, **kw):
        self.artifacts.append(key)


def test_eval_plan_callback_matches_the_reference(monkeypatch):
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    import sklearn.metrics
    from sklearn.linear_model import LogisticRegression

    matrices = []
    confusion = sklearn.metrics.confusion_matrix

    def recording(*args, **kwargs):
        matrices.append(confusion(*args, **kwargs))
        return matrices[-1]

    monkeypatch.setattr(sklearn.metrics, "confusion_matrix", recording)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3))
    y = (x.sum(axis=1) > 0).astype(int)
    model = LogisticRegression().fit(x, y)
    keys = []
    for pkg in (jcommon, tcommon):
        context = _Context()
        callback = pkg.EvalPlanCallback(lambda m: (y, m.predict(x)),
                                        plans=[pkg.ConfusionMatrixPlan()],
                                        x=x)
        hooks = pkg.CallbackList([callback], context=context, model=model)
        hooks.on_epoch_end(0, {})
        hooks.on_train_end({})
        keys.append(context.artifacts)
    assert keys[1] == keys[0] == ["confusion_matrix-epoch0",
                                  "confusion_matrix"]
    assert len(matrices) == 4
    for want, got in zip(matrices[:2], matrices[2:]):
        np.testing.assert_array_equal(got, want)
