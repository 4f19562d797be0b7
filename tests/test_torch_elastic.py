"""Elastic training (item 7, entry 3): the port's ElasticGuard,
Trainer.reshard and fit(elastic_guard=) against the JAX package's closed
loop (tests/test_elastic_training.py). Four gloo ranks in two slices
(tests/torch_ranks.py ``elastic``) train the tiny float32 model on
``{"data": 2, "fsdp": 2}``; the ``train.slice_fail`` chaos point fails
slice 1 at the 5th poll and revives it at the 8th, after a checkpoint of
step 2. The reference runs the same loop on 4 of the 8 virtual CPU
devices (tests/conftest.py) in two slices, from the same init and
batches.

Tolerances (tests/test_torch_parallel.py's): losses and grad norms 1e-4 relative
(``RUN_REL_TOL``), params 1e-4 absolute (``PARAM_TOL``). Within the port
the degraded steps are bit-equal to a fresh run restored from the same
checkpoint on the survivors' mesh, a carried reshard keeps every bit,
and DCP restores across world sizes are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlrun_tpu.chaos import chaos as jchaos
from mlrun_tpu.chaos import fail_nth as jfail_nth
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.parallel import mesh as jmesh
from mlrun_tpu.training import CheckpointManager as JCheckpointManager
from mlrun_tpu.training import ElasticGuard as JElasticGuard
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.training import ElasticGuard
from mlrun_tpu_torch.training import data as tdata
from tests.torch_ranks import run_ranks
from tests.torch_registries import registries_left_as_found  # noqa: F401

RUN_REL_TOL = 1e-4
PARAM_TOL = 1e-4
WORLD_SIZES = [4, 4, 4, 4, 2, 2, 2, 4, 4, 4]
STEPS = [1, 2, 3, 4, 3, 4, 5, 6, 7, 8]
CHAIN = ["train.slice_fail", "train.reshard", "train.slice_join",
         "train.grow"]

pytestmark = pytest.mark.chaos


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's closed loop on 4 devices in 2 slices, and the
    port's four ranks from its init on the same 10 batches."""
    devices = jax.devices()[:4]
    jt = jtrain.Trainer(
        jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference"),
        jtrain.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                           total_steps=5, weight_decay=0.1),
        mesh=jmesh.make_mesh({"data": 2, "fsdp": 2}, devices=devices))
    jt.init(0)
    init = jax.tree.map(np.asarray, jt.state.params)
    stream = tdata.synthetic_token_stream(8, 32, 512, seed=1)
    batches = [next(stream) for _ in range(10)]
    directory = tmp_path_factory.mktemp("elastic")
    manager = JCheckpointManager(str(directory / "reference"))

    def save_at_2(step, metrics, tr):
        if int(tr.state.step) == 2:
            manager.save(2, tr.state, force=True)
            manager.wait()

    guard = JElasticGuard(devices=devices, num_slices=2)
    with jchaos.inject("train.slice_fail", jfail_nth(5),
                       action=lambda p, ctx: ctx["box"].__setitem__(
                           "fail", 1)), \
            jchaos.inject("train.slice_fail", jfail_nth(8),
                          action=lambda p, ctx: ctx["box"].__setitem__(
                              "join", 1)):
        jt.fit(iter(batches), 10, log_every=1, callbacks=[save_at_2],
               checkpoint_manager=manager, elastic_guard=guard, prefetch=0)
    manager.close()
    ranks = run_ranks("elastic", 4, directory, init=init, batches=batches,
                      ckpt_dir=str(directory / "port"))
    return jt, ranks


def test_history_world_sizes_and_steps(runs):
    """The survivors log every step, restored to step 2 at the failure;
    the failed slice's ranks sit out the three degraded steps and resume
    with the carried state."""
    jt, ranks = runs
    assert [h["world_size"] for h in jt.metrics_history] == WORLD_SIZES
    assert [h["step"] for h in jt.metrics_history] == STEPS
    for rank, out in enumerate(ranks):
        history = out["history"]
        kept = range(10) if rank < 2 else [0, 1, 2, 3, 7, 8, 9]
        assert [h["world_size"] for h in history] == \
            [WORLD_SIZES[i] for i in kept]
        assert [h["step"] for h in history] == [STEPS[i] for i in kept]
        assert out["last"] == {"world_size": 4, "step": 8}
        assert out["mesh"] == {"data": 2, "fsdp": 2}
        for i, h in zip(kept, history):
            jm = jt.metrics_history[i]
            for key in ("loss", "grad_norm"):
                assert abs(jm[key] - h[key]) <= RUN_REL_TOL * jm[key], \
                    (i, key)


def test_params_after_grow_match_reference(runs):
    jt, ranks = runs
    ref = dict(_leaves(jax.tree.map(np.asarray, jt.state.params)))
    for out in ranks:
        for path, value in _leaves(out["params"]):
            assert np.abs(value - ref[path]).max() <= PARAM_TOL, path


def test_flight_chain_dump_and_goodput(runs):
    _, ranks = runs
    for rank, out in enumerate(ranks):
        events = out["events"]
        assert [e["kind"] for e in events
                if e["kind"] != "train.reshard_warm"] == CHAIN
        by_kind = {e["kind"]: e for e in events}
        assert by_kind["train.slice_fail"]["survivors"] == 2
        assert by_kind["train.slice_fail"]["survivor_ranks"] == [0, 1]
        reshard = by_kind["train.reshard"]
        assert (reshard["decision"], reshard["world_from"],
                reshard["world_to"]) == ("restore_checkpoint", 4, 2)
        assert reshard["restored_step"] == (2 if rank < 2 else None)
        grow = by_kind["train.grow"]
        assert (grow["decision"], grow["world_to"]) == \
            ("carry_live_state", 4)
        assert [e["loop_step"] for e in events
                if e["kind"] == "train.reshard_warm"] == \
            ([4, 7] if rank < 2 else [7])
        assert out["dump"]["reason"] == "slice-preemption"
        assert out["dump"]["survivors"] == [0, 1]
        assert out["dump"]["decision"] == "restore_checkpoint"
        summary = out["goodput"]
        assert summary["badput"]["reshard"] > 0
        assert summary["badput"]["degraded"] > 0
        assert summary["goodput_s"] + summary["badput_s"] == \
            pytest.approx(summary["wall_s"], abs=0.1)


def test_degraded_steps_equal_a_fresh_run_at_world_size_2(runs):
    """A fresh trainer on the survivors' mesh, restored from the same
    checkpoint and fed the same batches, gives the degraded steps'
    losses bit for bit."""
    _, ranks = runs
    for out in ranks[:2]:
        assert [h["loss"] for h in out["history"][4:7]] == out["fresh"]
    assert all("fresh" not in out for out in ranks[2:])


def test_reshard_without_a_checkpoint_carries_the_live_state(runs):
    _, ranks = runs
    for rank, out in enumerate(ranks):
        carry = out["carry"]
        assert carry["info"] == {"decision": "carry_live_state",
                                 "world_from": 4, "world_to": 2}
        assert carry["mesh"] == {"data": 1, "fsdp": 2}
        if rank < 2:
            for (path, a), (_, b) in zip(_leaves(carry["before"]),
                                         _leaves(carry["after"])):
                np.testing.assert_array_equal(a, b, path)
        else:
            assert "after" not in carry


@pytest.mark.parametrize("key", ["4to2", "2to4"])
def test_dcp_restore_across_world_sizes(runs, key):
    """A checkpoint written by 4 ranks restores on 2, one written by 2
    restores on 4: params and moments value-identical, step and count
    kept."""
    _, ranks = runs
    saved = ranks[0][key]["saved"]
    loaders = [out[key]["restored"] for out in ranks
               if "restored" in out[key]]
    assert [r["world"] for r in loaders] == ([2, 2] if key == "4to2"
                                             else [4] * 4)
    for restored in loaders:
        assert (restored["step"], restored["count"]) == (2, 2)
        for tree in ("params", "mu"):
            for (path, a), (_, b) in zip(_leaves(saved[tree]),
                                         _leaves(restored[tree])):
                np.testing.assert_array_equal(a, b, path)


def test_ranks_import_no_jax(runs):
    assert not any(out["jax_imported"] for out in runs[1])


def test_elastic_guard_partition_events_and_bounds():
    """The reference's guard contract over ranks."""
    guard = ElasticGuard(ranks=range(8), num_slices=2)
    assert guard.num_slices == 2 and guard.ranks == list(range(8))
    assert guard.lost_fraction() == 0.0
    guard.fail_slice(1)
    assert guard.degraded and guard.failed_slices == [1]
    assert guard.ranks == [0, 1, 2, 3]
    assert guard.lost_fraction() == pytest.approx(0.5)
    event = guard.poll()
    assert (event.kind, event.slice_index, event.ranks) == \
        ("fail", 1, (0, 1, 2, 3))
    assert guard.poll() is None
    guard.fail_slice(1)
    assert guard.poll() is None
    with pytest.raises(ValueError):
        guard.fail_slice(0)
    with pytest.raises(ValueError):
        guard.fail_slice(7)
    guard.join_slice(1)
    event = guard.poll()
    assert (event.kind, event.slice_index) == ("join", 1)
    assert len(event.ranks) == 8
    with pytest.raises(ValueError):
        ElasticGuard(ranks=range(5), num_slices=2)
