"""Pipeline parallelism (item 7, entry 2): the port's GPipe stages
(mlrun_tpu_torch/parallel/pipeline.py) against the JAX package's. Gloo
ranks (tests/torch_ranks.py ``pipeline``) train a 4-layer tiny float32
model with ``pipeline_stages=2``, 2 microbatches and ``grad_accum=2`` on
``{"pipe": 2}`` and ``{"data": 2, "pipe": 2}``, from the reference
Trainer's init on the same sub-mesh of the 8 virtual CPU devices
(tests/conftest.py), on the same batches; the reference's refusals raise
its errors on the port. In one process the stages run in the GPipe order
through an in-process link, against the unpipelined loss.

Tolerances (tests/test_torch_parallel.py's): per-step loss,
accuracy and grad norm 1e-4 relative (``RUN_REL_TOL``), params after 3
steps 1e-4 absolute (``PARAM_TOL``); the in-process stages' loss and
gradients against ``loss_fn`` 1e-5 of each tensor's largest element
(float32 summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.parallel import mesh as jmesh
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.parallel import pipeline as tpipe
from mlrun_tpu_torch.training import TrainConfig, Trainer
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training.train import tree_leaves
from tests.torch_ranks import run_ranks

RUN_REL_TOL = 1e-4
PARAM_TOL = 1e-4
STAGES_TOL = 1e-5
STEPS = 3
SHAPES = {"pipe=2": {"pipe": 2}, "data=2,pipe=2": {"data": 2, "pipe": 2}}
TRAIN = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
             weight_decay=0.1, pipeline_stages=2, pipeline_microbatches=2,
             grad_accum=2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def _merged(params):
    """A stage-split tree ([P, L/P, ...] layers) with its layers stacked
    back to [L, ...]."""
    out = dict(params)
    out["layers"] = {k: v.reshape((-1,) + v.shape[2:])
                     for k, v in params["layers"].items()}
    return out


def _config():
    return jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference",
                             n_layers=4)


def _reference(shape):
    jt = jtrain.Trainer(_config(), jtrain.TrainConfig(**TRAIN),
                        mesh=jmesh.make_mesh(shape))
    jt.init(0)
    init = jax.tree.map(np.asarray, jt.state.params)
    jt.fit(jdata.synthetic_token_stream(8, 32, 512, seed=1), STEPS,
           log_every=1, prefetch=0, defer_metrics=False)
    return jt, _merged(init)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    stream = tdata.synthetic_token_stream(8, 32, 512, seed=1)
    batches = [next(stream) for _ in range(STEPS)]
    refs = {key: _reference(shape) for key, shape in SHAPES.items()}
    init = refs["pipe=2"][1]
    for (_, a), (_, b) in zip(_leaves(init),
                              _leaves(refs["data=2,pipe=2"][1])):
        np.testing.assert_array_equal(a, b)
    ranks = run_ranks("pipeline", 4, tmp_path_factory.mktemp("pp"),
                      init=init, batches=batches)
    return refs, ranks


def _runs_of(ranks, key):
    return [out[key] for out in ranks if key in out]


@pytest.mark.parametrize("key", SHAPES)
def test_losses_and_norms_match_reference(runs, key):
    refs, ranks = runs
    jt = refs[key][0]
    outs = _runs_of(ranks, key)
    assert len(outs) == (2 if key == "pipe=2" else 4)
    for out in outs:
        assert [m["step"] for m in out["history"]] == [1, 2, 3]
        for jm, tm in zip(jt.metrics_history, out["history"]):
            for name in ("loss", "accuracy", "grad_norm"):
                assert abs(jm[name] - tm[name]) <= RUN_REL_TOL * max(
                    abs(jm[name]), 1e-6), (name, jm[name], tm[name])


@pytest.mark.parametrize("key", SHAPES)
def test_params_match_reference(runs, key):
    refs, ranks = runs
    ref = dict(_leaves(_merged(jax.tree.map(np.asarray,
                                             refs[key][0].state.params))))
    for out in _runs_of(ranks, key):
        ours = dict(_leaves(_merged(out["params"])))
        assert ours.keys() == ref.keys()
        for path, value in ours.items():
            assert np.abs(value - ref[path]).max() <= PARAM_TOL, path


@pytest.mark.parametrize("key", SHAPES)
def test_each_pipe_rank_holds_its_stage(runs, key):
    """A pipe rank's local layers are its stage's [1, L/P, ...] slice of
    the reference's stage-split tree; the rest is replicated."""
    refs, ranks = runs
    ref = jax.tree.map(np.asarray, refs[key][0].state.params)
    pipe_axis = list(SHAPES[key]).index("pipe")
    for out in _runs_of(ranks, key):
        stage = out["coordinate"][pipe_axis]
        for name, shard in out["shards"]["layers"].items():
            assert shard.shape == (1, 2) + ref["layers"][name].shape[2:]
            want = ref["layers"][name][stage:stage + 1]
            assert np.abs(shard - want).max() <= PARAM_TOL, name
        assert out["shards"]["embedding"].shape == (512, 128)


def test_refusals_raise_the_reference_errors(runs):
    """No pipe axis, LoRA, custom rules and an fsdp axis raise the
    reference's ValueErrors with its messages, on every rank."""
    _, ranks = runs
    cases = {"no pipe axis": ({"fsdp": 4}, {}, None),
             "lora": ({"data": 2, "pipe": 2}, {"lora_rank": 4}, None),
             "rules": ({"data": 2, "pipe": 2}, {}, [(r".*", ())]),
             "fsdp": ({"fsdp": 2, "pipe": 2}, {}, None)}
    for key, (shape, extra, rules) in cases.items():
        with pytest.raises(ValueError) as err:
            jtrain.Trainer(_config(), jtrain.TrainConfig(**dict(
                TRAIN, **extra)), mesh=jmesh.make_mesh(shape), rules=rules)
        want = str(err.value)
        if key == "no pipe axis":   # the mesh dicts print differently
            want = want.split(" (mesh:")[0]
        for out in ranks:
            assert out["refusals"][key].startswith(want), key
    # without any mesh the port refuses before joining a group
    with pytest.raises(ValueError, match="needs a 'pipe' mesh axis"):
        Trainer(tllama.tiny_llama(), TrainConfig(pipeline_stages=2),
                device="cpu")


def test_ranks_import_no_jax(runs):
    assert not any(out["jax_imported"] for out in runs[1])


def test_stages_in_process_match_the_unpipelined_loss():
    """Four stages of one layer each, 4 microbatches, run in one process
    in the GPipe order through a LocalLink: the whole batch's mean loss
    and every leaf's gradient equal ``loss_fn`` without a pipeline; each
    stage's layer gradients are its slice of the full ones."""
    jparams = jax.tree.map(np.asarray, jllama.init_params(
        _config(), jax.random.PRNGKey(2)))
    config = tllama.tiny_llama(dtype=torch.float32, n_layers=4)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, 512, (8, 16), dtype=np.int32))
    targets = torch.from_numpy(rng.integers(0, 512, (8, 16),
                                            dtype=np.int32))
    full = params_from_numpy(jparams, "cpu")
    for leaf in tree_leaves(full):
        leaf.requires_grad_(True)
    loss, _ = tllama.loss_fn(config, full, tokens, targets)
    loss.backward()
    n = 4
    split = tpipe.split_layers_for_stages(
        {k: v.detach() for k, v in full["layers"].items()}, n)
    link = tpipe.LocalLink()
    stages, views = [], []
    for p in range(n):
        view = {k: v.detach().clone().requires_grad_(True)
                for k, v in full.items() if k != "layers"}
        view["layers"] = {k: v[p].clone().requires_grad_(True)
                          for k, v in split.items()}
        views.append(view)
        stages.append(tpipe.Stage(config, view, tokens, targets, p, n, 4,
                                  link))
    tpipe.run_in_process(stages, 4)
    assert link.handoffs == 2 * (n - 1) * 4
    sums = sum(stage.sums() for stage in stages)
    got = sums[0] / sums[2]

    def close(a, b):
        return (a - b).abs().max().item() <= STAGES_TOL * max(
            1.0, b.abs().max().item())

    assert close(got, loss.detach())
    for p, view in enumerate(views):
        for name, leaf in view["layers"].items():
            want = full["layers"][name].grad.reshape(
                (n, -1) + leaf.shape[1:])[p]
            assert close(leaf.grad, want), (p, name)
    embedding = views[0]["embedding"].grad + views[-1]["embedding"].grad
    assert close(embedding, full["embedding"].grad)
    assert views[1]["embedding"].grad is None
    assert close(views[-1]["final_norm_scale"].grad,
                 full["final_norm_scale"].grad)
