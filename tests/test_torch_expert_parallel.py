"""Expert parallelism (item 7, entry 4): MoE training on an ``expert``
mesh axis (models/moe.py ``ExpertParallel``, training/train.py's MoE
mesh step) against the JAX package. Four gloo ranks
(tests/torch_ranks.py) train the tiny float32 MoE (4 experts, top 2)
from the reference Trainer's init on ``{"expert": 2, "fsdp": 2}``,
``{"expert": 4}`` and ``{"data": 2, "fsdp": 2}``, the reference Trainer
on the same mesh of 4 of the 8 virtual CPU devices (tests/conftest.py),
on the same batches.

Tolerances (tests/test_torch_parallel.py's): per-step ``loss``,
``ce_loss``, ``aux_loss``, ``accuracy`` and ``grad_norm`` 1e-4 relative
(``RUN_REL_TOL``), params after 3 steps 1e-4 absolute (``PARAM_TOL``): the
expert group sums its ranks' partial outputs and the batch's parts sum
their gradients in another order than XLA. The batch routes differently
on its two halves: the mean of the halves' own aux losses misses the
global one by far more than the bound (``test_the_batch_splits_the_aux_loss``),
so a step averaging each rank's own aux would fail.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.models import moe as jmoe
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.models import moe as tmoe
from mlrun_tpu_torch.parallel import sharding as tsharding
from mlrun_tpu_torch.training import data as tdata
from tests.torch_ranks import MOE_SHAPES, run_ranks
from tests.torch_registries import registries_left_as_found  # noqa: F401

RUN_REL_TOL = 1e-4
PARAM_TOL = 1e-4
STEPS = 3
BATCH, SEQ = 8, 32
TRAIN = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
             weight_decay=0.1, moe_experts=4, moe_top_k=2)
KEYS = ("loss", "ce_loss", "aux_loss", "accuracy", "grad_norm")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def _key(shape):
    return ",".join(f"{a}={n}" for a, n in shape.items())


def _reference(shape):
    jt = jtrain.Trainer(jllama.tiny_llama(dtype=jnp.float32,
                                          attention_impl="reference"),
                        jtrain.TrainConfig(**dict(TRAIN, mesh_shape=shape)))
    jt.init(0)
    init = jax.tree.map(np.asarray, jt.state.params)
    jt.fit(jdata.synthetic_token_stream(BATCH, SEQ, 512, seed=1), STEPS,
           log_every=1, prefetch=0, defer_metrics=False)
    return jt, init


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape key: (reference Trainer, the ranks' results)}, every shape
    from the same reference init (seed 0)."""
    stream = tdata.synthetic_token_stream(BATCH, SEQ, 512, seed=1)
    batches = [next(stream) for _ in range(STEPS)]
    refs = {_key(shape): _reference(shape) for shape in MOE_SHAPES}
    init = refs[_key(MOE_SHAPES[0])][1]
    ranks = run_ranks("expert_parallel", 4, tmp_path_factory.mktemp("ep"),
                      init=init, batches=batches)
    return {key: (jt, [dict(r[key], jax_imported=r["jax_imported"])
                       for r in ranks])
            for key, (jt, _) in refs.items()} | {"init": init,
                                                  "batches": batches,
                                                  "ranks": ranks}


@pytest.mark.parametrize("shape", MOE_SHAPES, ids=_key)
def test_moe_steps_match_reference(runs, shape):
    """ce_loss and aux_loss (and the loss, accuracy and grad norm) of
    every step on every rank match the reference Trainer's."""
    jt, ranks = runs[_key(shape)]
    assert len(ranks) == math.prod(shape.values())
    for out in ranks:
        assert not out["jax_imported"]
        assert [m["step"] for m in out["history"]] == [1, 2, 3]
        for jm, tm in zip(jt.metrics_history, out["history"]):
            for key in KEYS:
                assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * max(
                    abs(jm[key]), 1e-6), (key, jm[key], tm[key])


@pytest.mark.parametrize("shape", MOE_SHAPES, ids=_key)
def test_moe_params_match_reference(runs, shape):
    jt, ranks = runs[_key(shape)]
    ref = dict(_leaves(jax.tree.map(np.asarray, jt.state.params)))
    for out in ranks:
        ours = dict(_leaves(out["params"]))
        assert ours.keys() == ref.keys()
        for path, value in ours.items():
            assert np.abs(value - ref[path]).max() <= PARAM_TOL, path


@pytest.mark.parametrize("shape", MOE_SHAPES, ids=_key)
def test_each_rank_holds_only_its_experts(runs, shape):
    """On an expert axis of n a rank's expert leaves hold E / n experts
    (each split further over fsdp as the rules say), and its shard is the
    reference's shard on the device at its coordinate."""
    jt, ranks = runs[_key(shape)]
    n = shape.get("expert", 1)
    fsdp = shape.get("fsdp", 1)
    leaves = dict(_leaves(jt.state.params))
    devices = jt.mesh.devices
    for rank, out in enumerate(ranks):
        for name, local in out["expert_shapes"].items():
            full = leaves[f"layers/{name}"].shape
            assert local[1] == full[1] // n, (name, local)
            split = 2 if name != "experts_down" else 3
            assert local[split] == full[split] // fsdp, (name, local)
        coordinate = tuple(out["coordinate"])
        device = devices[coordinate]
        for path, shard in _leaves(out["shards"]):
            ref = next(s for s in leaves[path].addressable_shards
                       if s.device == device)
            ref = np.asarray(ref.data, np.float32)
            assert shard.shape == ref.shape, path
            assert np.abs(shard - ref).max() <= PARAM_TOL, path


def test_auto_trainer_trains_moe_on_an_expert_axis(runs):
    """The tpujob handler's contract (the reference's
    test_auto_trainer_moe_experts) on {"expert": 2, "fsdp": 2}: finite
    metrics with the MoE keys, the same on every rank."""
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto

    ref = jauto.train(model="tiny", model_overrides={
        "attention_impl": "reference", "remat": False}, batch_size=4,
        seq_len=32, steps=2, moe_experts=4, moe_top_k=2, log_every=1)
    outs = [dict(r["auto_trainer"]) for r in runs["ranks"]]
    assert set(outs[0]) == set(ref)
    assert {"aux_loss", "ce_loss"} <= set(outs[0])
    for out in outs:
        assert out["step"] == 2.0
        assert np.isfinite(out["loss"]) and np.isfinite(out["aux_loss"])
        assert out["loss"] == outs[0]["loss"]


def test_the_batch_splits_the_aux_loss(runs):
    """The premise of the aux test: at the init and first batch the mean
    of the two batch halves' own aux losses (what a step averaging each
    rank's aux would report) misses the global batch's by more than 100x
    RUN_REL_TOL, in the reference."""
    cfg = jmoe.MoEConfig(**{**jllama.tiny_llama(
        dtype=jnp.float32, attention_impl="reference").__dict__,
        "n_experts": 4, "top_k": 2})
    params = jax.tree.map(jnp.asarray, runs["init"])
    tokens, targets = runs["batches"][0]

    def aux(rows):
        return float(jmoe.loss_fn(cfg, params, tokens[rows],
                                  targets[rows])[1]["aux_loss"])

    whole = aux(slice(None))
    halves = (aux(slice(0, BATCH // 2)) + aux(slice(BATCH // 2, None))) / 2
    assert abs(halves - whole) > 100 * RUN_REL_TOL * whole, (halves, whole)


def test_moe_rules_match_reference():
    """MOE_RULES / make_moe_rules are the reference's, and the port places
    the experts on the expert axis by them."""
    assert tmoe.MOE_RULES == jmoe.MOE_RULES
    assert tmoe.make_moe_rules() == [tuple(r) for r in jmoe.make_moe_rules()]
    spec = tsharding.spec_for_path("layers/experts_gate",
                                   tmoe.make_moe_rules(), ndim=4)
    assert spec == (None, "expert", "fsdp", "tensor")
    assert tsharding._filter_spec_to_mesh(
        spec, {"expert": 2, "fsdp": 1}) == (None, "expert")
