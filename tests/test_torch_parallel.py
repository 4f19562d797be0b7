"""Training on many devices (item 7, first half): the port's meshes and
sharding rules (mlrun_tpu_torch.parallel) against the JAX package's, and
four gloo ranks on {"data": 2, "fsdp": 2} (tests/torch_ranks.py) against
the reference Trainer on 4 of the 8 virtual CPU devices
(tests/conftest.py), tiny float32 model, the same init and batches.

Tolerances (the port's, tests/test_torch_training.py): per-step loss and
grad_norm 1e-4 relative (``RUN_REL_TOL``), params after 3 steps 1e-4
absolute (``PARAM_TOL``); the two sides differ in summation order only
(the port averages four ranks' gradients, XLA reduces one global batch).
Specs and placements are exact; a size-1 mesh is bit-equal to no mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.parallel import mesh as jmesh
from mlrun_tpu.parallel import sharding as jsharding
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models import lora as tlora
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.parallel import mesh as tmesh
from mlrun_tpu_torch.parallel import sharding as tsharding
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain
from tests.torch_ranks import run_ranks
from tests.torch_registries import registries_left_as_found  # noqa: F401

RUN_REL_TOL = 1e-4
PARAM_TOL = 1e-4
SHAPE = {"data": 2, "fsdp": 2}
STEPS = 3


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def _train_cfg(cls, **kw):
    base = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                weight_decay=0.1)
    base.update(kw)
    return cls(**base)


# -- rules and meshes -----------------------------------------------------------

def test_spec_for_path_matches_reference_on_every_leaf(cpu_mesh8):
    """Every leaf of the tiny params and of a LoRA adapter gets the
    reference's spec, raw and filtered to {"data": 2, "fsdp": 2,
    "tensor": 2}."""
    jcfg = jllama.tiny_llama()
    jparams = jax.tree.map(np.asarray,
                           jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jparams, "cpu")
    tree = {"params": tparams, "lora": tlora.init_lora(
        tllama.tiny_llama(), torch.Generator().manual_seed(0), 4, 8.0)}
    jtree = {"params": jparams,
             "lora": jax.tree.map(np.asarray, {
                 k: {kk: vv.detach().numpy() for kk, vv in v.items()}
                 for k, v in tree["lora"].items()})}
    shape = dict(cpu_mesh8.shape)
    ours = dict(_leaves(tsharding.tree_pspecs(tree, shape)))
    ref = dict(_leaves(jax.tree.map(
        tuple, jsharding.tree_pspecs(jtree, cpu_mesh8),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    assert ours.keys() == ref.keys() and len(ours) == 23
    for path, spec in ours.items():
        assert spec == ref[path], path
        leaf = dict(_leaves(tree))[path]
        assert tsharding.spec_for_path(path, ndim=leaf.dim()) == tuple(
            jsharding.spec_for_path(path, ndim=leaf.dim())), path
    # a user rule first, as the reference's ShardingRules.add
    rule = (r".*wq.*", (None, None, "fsdp"))
    ours = tsharding.ShardingRules().add(*rule).pspecs(tree, shape)
    ref = jsharding.ShardingRules().add(*rule).pspecs(jtree, cpu_mesh8)
    assert ours["params"]["layers"]["wq"] == tuple(
        ref["params"]["layers"]["wq"]) == (None, None, "fsdp")


@pytest.mark.parametrize("shape", [{"data": 2}, {"data": 1, "fsdp": 4},
                                   {"data": 2, "fsdp": 2, "tensor": 2}])
def test_placements_and_batch_spec_follow_the_specs(shape):
    """Per mesh axis, Shard(d) where the filtered spec names it at dim d,
    Replicate elsewhere; the batch over the data-ish axes, as the
    reference's ``batch_spec``."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = tuple(shape)

    jm = jmesh.make_mesh(shape)
    spec = tsharding._filter_spec_to_mesh(
        tsharding.spec_for_path("layers/wq", ndim=3), shape)
    placements = tsharding.placements_for(spec, Mesh)
    for axis, placement in zip(shape, placements):
        dims = [d for d, entry in enumerate(spec) if entry == axis]
        assert placement == (Shard(dims[0]) if dims else Replicate())

    # jax writes a one-axis tuple as the axis name
    def norm(spec):
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)

    for seq_axis in (None, "seq"):
        assert norm(tsharding.batch_spec(shape, seq_axis)) == tuple(
            jsharding.batch_spec(jm, seq_axis))


@pytest.mark.parametrize("shape,n", [({"data": -1, "fsdp": 2}, 8),
                                     ({"fsdp": 4}, 4), ({"data": 3}, 4),
                                     ({"data": -1, "seq": -1}, 4)])
def test_mesh_config_and_refit_match_reference(shape, n):
    def outcome(fn):
        try:
            return fn()
        except ValueError as exc:
            return type(exc)
    assert outcome(lambda: tmesh.MeshConfig(shape).resolve(n)) == outcome(
        lambda: jmesh.MeshConfig(shape).resolve(n))
    full = {a: (2 if s == -1 else s) for a, s in shape.items()}
    for devices in (2, 4, 6):
        assert outcome(lambda: tmesh.refit_shape(full, devices)) == outcome(
            lambda: jmesh.refit_shape(full, devices))


@pytest.fixture()
def world_of_one():
    """A world-size-1 gloo group of this process, left as found."""
    existed = dist.is_initialized()
    yield
    if dist.is_initialized() and not existed:
        dist.destroy_process_group()


def test_a_size_1_mesh_takes_the_sharded_path_bit_equal(world_of_one):
    """``mesh_shape={"data": 1, "fsdp": 1}`` joins a world-size-1 group
    and shards the state as DTensors (gathered for the step, gradients
    reduced back); its losses, norms and params equal the plain
    Trainer's bit for bit."""
    from torch.distributed.tensor import DTensor

    init = jax.tree.map(np.asarray, jllama.init_params(
        jllama.tiny_llama(dtype=jnp.float32), jax.random.PRNGKey(0)))
    runs = []
    for shape in (None, {"data": 1, "fsdp": 1}):
        trainer = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                                 _train_cfg(ttrain.TrainConfig,
                                            mesh_shape=shape), device="cpu")
        trainer.init(params=params_from_numpy(init, "cpu"))
        trainer.fit(tdata.synthetic_token_stream(4, 32, 512, seed=1), 3,
                    log_every=1, prefetch=0, defer_metrics=False)
        runs.append(trainer)
    plain, sharded = runs
    assert sharded.mesh is not None and tmesh.mesh_info(sharded.mesh) == {
        "axis_names": ["data", "fsdp"], "shape": {"data": 1, "fsdp": 1},
        "n_devices": 1, "devices": "cpu"}
    assert tmesh.mesh_info(tmesh.local_mesh(device="cpu"))["shape"] == {
        "data": 1}
    assert all(isinstance(leaf, DTensor)
               for leaf in ttrain.tree_leaves(sharded.state.params))
    for a, b in zip(plain.metrics_history, sharded.metrics_history):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    for a, b in zip(ttrain.tree_leaves(plain.state.params),
                    ttrain.tree_leaves(sharded.state.params)):
        assert torch.equal(a.detach(), b.full_tensor())


# -- four ranks against the reference Trainer -------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference Trainer on {"data": 2, "fsdp": 2} for STEPS steps,
    and the port's four ranks (tests/torch_ranks.py data_fsdp) from its
    init on the same batches."""
    jt = jtrain.Trainer(jllama.tiny_llama(dtype=jnp.float32,
                                          attention_impl="reference"),
                        _train_cfg(jtrain.TrainConfig, mesh_shape=SHAPE))
    jt.init(0)
    init = jax.tree.map(np.asarray, jt.state.params)
    stream = tdata.synthetic_token_stream(8, 32, 512, seed=1)
    batches = [next(stream) for _ in range(STEPS)]
    jt.fit(jdata.synthetic_token_stream(8, 32, 512, seed=1), STEPS,
           log_every=1, prefetch=0, defer_metrics=False)
    directory = tmp_path_factory.mktemp("ranks")
    ranks = run_ranks("data_fsdp", 4, directory, init=init, batches=batches,
                      ckpt_dir=str(directory / "preempted"))
    return jt, init, ranks


def test_four_ranks_match_reference_losses_and_norms(four_ranks):
    jt, _, ranks = four_ranks
    for out in ranks:
        assert [m["step"] for m in out["history"]] == [1, 2, 3]
        for jm, tm in zip(jt.metrics_history, out["history"]):
            for key in ("loss", "grad_norm", "accuracy", "tokens"):
                assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * max(
                    abs(jm[key]), 1e-6), key


def test_four_ranks_match_reference_params(four_ranks):
    jt, _, ranks = four_ranks
    ref = dict(_leaves(jax.tree.map(np.asarray, jt.state.params)))
    for out in ranks:
        ours = dict(_leaves(out["params"]))
        assert ours.keys() == ref.keys()
        for path, value in ours.items():
            assert np.abs(value - ref[path]).max() <= PARAM_TOL, path


def test_each_rank_holds_its_slice_of_the_reference_params(four_ranks):
    """Rank r sits at mesh coordinate (r // 2, r % 2); its local shard of
    every leaf is the reference's shard on the device at that
    coordinate of its mesh (same shape, values within PARAM_TOL)."""
    jt, _, ranks = four_ranks
    devices = jt.mesh.devices
    leaves = dict(_leaves(jt.state.params))
    for rank, out in enumerate(ranks):
        assert tuple(out["coordinate"]) == (rank // 2, rank % 2)
        device = devices[rank // 2, rank % 2]
        for path, shard in _leaves(out["shards"]):
            ref = next(s for s in leaves[path].addressable_shards
                       if s.device == device)
            ref = np.asarray(ref.data, np.float32)
            assert shard.shape == ref.shape, path
            assert np.abs(shard - ref).max() <= PARAM_TOL, path
    # the rules shard something on each axis: wq's embed dim over fsdp
    assert ranks[0]["shards"]["layers"]["wq"].shape == (2, 64, 128)


def test_make_loss_step_on_a_mesh_matches_the_plain_step(four_ranks):
    """``make_loss_step(mesh=)`` (the families' step builder): two steps
    of the four-rank step against the same step without a mesh on the
    whole batch."""
    _, _, ranks = four_ranks
    for out in ranks:
        plain, mesh = out["loss_step"]["plain"], out["loss_step"]["mesh"]
        for (loss_a, norm_a), (loss_b, norm_b) in zip(plain["losses"],
                                                      mesh["losses"]):
            assert abs(loss_a - loss_b) <= RUN_REL_TOL * abs(loss_a)
            assert abs(norm_a - norm_b) <= RUN_REL_TOL * abs(norm_a)
        for (path, a), (_, b) in zip(_leaves(plain["params"]),
                                     _leaves(mesh["params"])):
            assert np.abs(a - b).max() <= PARAM_TOL, path


def test_an_early_stop_on_one_rank_stops_every_rank(four_ranks):
    """Rank 1 alone votes to stop at step 0 (off the log points, log_every
    2): every rank stops at the log point, after step 2."""
    _, _, ranks = four_ranks
    assert [out["stopped"] for out in ranks] == [
        {"step": 2, "stopped_early": True}] * 4


def test_a_preemption_on_one_rank_checkpoints_every_rank_at_one_step(
        four_ranks):
    """SIGTERM latched on rank 2 alone, during step 1: the latch is agreed
    across the ranks before step 2, so every rank takes the collective
    save of step 2 and returns ``preempted`` (a rank left stepping would
    wait in the step's collectives until the rank limit kills it)."""
    _, _, ranks = four_ranks
    assert [out["preempted"] for out in ranks] == [
        {"step": 2, "preempted": True, "latched": rank == 2, "saved": [2]}
        for rank in range(4)]


def test_evaluate_over_the_mesh_matches_one_device(four_ranks):
    _, _, ranks = four_ranks
    for out in ranks:
        plain, mesh = out["evaluate"]["plain"], out["evaluate"]["mesh"]
        assert plain.keys() == mesh.keys()
        assert mesh["eval_tokens"] == plain["eval_tokens"]
        for key in ("eval_loss", "eval_accuracy"):
            assert abs(plain[key] - mesh[key]) <= 1e-5, key


def test_ranks_import_no_jax(four_ranks):
    assert not any(out["jax_imported"] for out in four_ranks[2])
