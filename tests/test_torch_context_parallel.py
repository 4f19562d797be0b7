"""Context parallelism (item 7, first half): the port's ring and Ulysses
attention (ops/ring_attention.py, ops/ulysses.py) inside the Llama loss
(models/llama_cp.py) on four gloo ranks (tests/torch_ranks.py), against
the JAX package's ``make_context_parallel_loss`` on 4 of the 8 virtual
CPU devices: {"seq": 4} and {"data": 2, "seq": 2}, tiny float32 model,
tokens [2, 64]. Also the Trainer's context-parallel step against the
reference Trainer's, LoRA, the reference's validations, and the ring's
hop schedule run in one process against the flash over the whole
sequence.

Tolerances (float32): losses and gradients 1e-5 absolute (the port's
``TOL``), Trainer runs 1e-4 relative per step and 1e-4 absolute on the
params (``RUN_REL_TOL`` / ``PARAM_TOL``) — tighter than the reference's
own context-parallel tests (2e-3 / 2e-2 in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.models.llama_cp import make_context_parallel_loss
from mlrun_tpu.models.lora import init_lora
from mlrun_tpu.parallel.mesh import make_mesh
from mlrun_tpu.training import TrainConfig as JTrainConfig
from mlrun_tpu.training import Trainer as JTrainer
from mlrun_tpu.training import data as jdata
from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.ops import attention as tattn
from mlrun_tpu_torch.ops import ring_attention as tring
from mlrun_tpu_torch.training import TrainConfig, Trainer
from mlrun_tpu_torch.training import data as tdata
from tests.torch_ranks import CP_CASES, run_ranks

TOL = 1e-5
RUN_REL_TOL = 1e-4
PARAM_TOL = 1e-4
STEPS = 3


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def _train_kw():
    return dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                weight_decay=0.1)


@pytest.fixture(scope="module")
def cp_run(tmp_path_factory):
    """The reference's loss and gradients in every case, its LoRA
    gradients, a 3-step context-parallel reference Trainer; the port's
    four ranks on the same inputs."""
    cfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    targets = rng.integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    lora = init_lora(cfg, jax.random.PRNGKey(3), rank=4, alpha=8.0)

    def reference(shape, impl, adapter=None):
        loss = make_context_parallel_loss(
            cfg, make_mesh(shape), "seq", impl,
            data_axes=("data",) if "data" in shape else None)
        if adapter is None:
            fn = lambda p: loss(p, tokens, targets)  # noqa: E731
            (value, metrics), grads = jax.value_and_grad(
                fn, has_aux=True)(params)
        else:
            fn = lambda lo: loss(params, tokens, targets, lora=lo)  # noqa
            (value, metrics), grads = jax.value_and_grad(
                fn, has_aux=True)(adapter)
        return {"loss": float(value), "tokens": float(metrics["tokens"]),
                "grads": [np.asarray(g, np.float32)
                          for g in jax.tree_util.tree_leaves(grads)]}

    refs = [reference(shape, impl) for shape, impl in CP_CASES]
    lora_ref = reference({"seq": 4}, "ring", adapter=lora)

    jt = JTrainer(cfg, JTrainConfig(context_parallel="ring", seq_axis="seq",
                                    **_train_kw()),
                  mesh=make_mesh({"seq": 4}))
    jt.init(0)
    init = jax.tree.map(np.asarray, jt.state.params)
    jt.fit(jdata.synthetic_token_stream(4, 64, 512, seed=2), STEPS,
           log_every=1, prefetch=0, defer_metrics=False)
    stream = tdata.synthetic_token_stream(4, 64, 512, seed=2)
    ranks = run_ranks(
        "context_parallel", 4, tmp_path_factory.mktemp("cp"),
        init=jax.tree.map(np.asarray, params),
        lora=jax.tree.map(np.asarray, lora), tokens=tokens, targets=targets,
        batches=[next(stream) for _ in range(STEPS)], trainer_init=init)
    return refs, lora_ref, jt, ranks


@pytest.mark.parametrize("case", range(len(CP_CASES)),
                         ids=[f"{impl}-{'x'.join(map(str, s.values()))}"
                              for s, impl in CP_CASES])
def test_cp_loss_and_grads_match_reference(cp_run, case):
    refs, _, _, ranks = cp_run
    ref = refs[case]
    for out in ranks:
        ours = out["cases"][case]
        assert abs(ours["loss"] - ref["loss"]) <= TOL
        assert ours["tokens"] == ref["tokens"] == 128
        assert len(ours["grads"]) == len(ref["grads"])
        for a, b in zip(ours["grads"], ref["grads"]):
            assert np.abs(a - b).max() <= TOL


def test_cp_lora_grads_match_reference(cp_run):
    """The reference's ``test_cp_lora_parity`` case: the adapter's
    gradients through the ring on {"seq": 4}."""
    _, ref, _, ranks = cp_run
    for out in ranks:
        assert abs(out["lora"]["loss"] - ref["loss"]) <= TOL
        for a, b in zip(out["lora"]["grads"], ref["grads"]):
            assert np.abs(a - b).max() <= TOL


def test_trainer_context_parallel_matches_reference_trainer(cp_run):
    _, _, jt, ranks = cp_run
    ref_params = dict(_leaves(jax.tree.map(np.asarray, jt.state.params)))
    for out in ranks:
        history = out["trainer"]["history"]
        assert [m["step"] for m in history] == [1, 2, 3]
        for jm, tm in zip(jt.metrics_history, history):
            assert abs(jm["loss"] - tm["loss"]) <= RUN_REL_TOL * abs(
                jm["loss"])
        for path, value in _leaves(out["trainer"]["params"]):
            assert np.abs(value - ref_params[path]).max() <= PARAM_TOL, path


def test_cp_lora_with_accum_trains_the_adapter_only(cp_run):
    """The reference's ``test_trainer_cp_lora_with_accum`` on {"data": 2,
    "seq": 2}: the base stays bit-equal, the adapter moves."""
    for out in cp_run[3]:
        run = out["lora_accum"]
        assert np.isfinite(run["loss"])
        for (_, a), (_, b) in zip(_leaves(run["base"][0]),
                                  _leaves(run["base"][1])):
            np.testing.assert_array_equal(a, b)
        assert any(np.abs(a - b).max() > 0 for (_, a), (_, b) in zip(
            _leaves(run["lora"][0]), _leaves(run["lora"][1])))


def test_ranks_import_no_jax(cp_run):
    assert not any(out["jax_imported"] for out in cp_run[3])


@pytest.mark.parametrize("shape,match", [({"fsdp": 4}, "axis"),
                                         ({"fsdp": 2, "seq": 4},
                                          "cannot combine")])
def test_cp_validations_raise_the_reference_errors(shape, match):
    """Checked on the mesh's shape before any process group is joined."""
    with pytest.raises(ValueError, match=match):
        JTrainer(jllama.tiny_llama(), JTrainConfig(
            context_parallel="ring", seq_axis="seq"), mesh=make_mesh(shape))
    with pytest.raises(ValueError, match=match):
        Trainer(tllama.tiny_llama(), TrainConfig(
            context_parallel="ring", seq_axis="seq", mesh_shape=shape),
            device="cpu")


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_ring_hop_schedule_equals_the_full_flash(monkeypatch, kv_heads):
    """Every rank's hops of 4 shards of 16, run in ring order in one
    process, against flash_fwd_plain / flash_bwd_plain over all 64
    positions: o and lse, then dq/dk/dv with the ring's global o and lse;
    10 forward and 10 backward hops (rank r runs r + 1)."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = tring._flash_fwd_op, tring._flash_bwd_op

    def count_fwd(*args):
        counts["fwd"] += 1
        return fwd(*args)

    def count_bwd(*args):
        counts["bwd"] += 1
        return bwd(*args)

    monkeypatch.setattr(tring, "_flash_fwd_op", count_fwd)
    monkeypatch.setattr(tring, "_flash_bwd_op", count_bwd)
    gen = torch.Generator().manual_seed(0)
    q, g = (torch.randn(1, 64, 4, 16, generator=gen) for _ in range(2))
    k, v = (torch.randn(1, 64, kv_heads, 16, generator=gen)
            for _ in range(2))
    shards = [list(t.split(16, dim=1)) for t in (q, k, v, g)]
    outs = tring.ring_hops_fwd(*shards[:3])
    o = torch.cat([o for o, _ in outs], dim=1)
    lse = torch.cat([lse for _, lse in outs], dim=2)
    o_ref, lse_ref = tattn.flash_fwd_plain(q, k, v, causal=True)
    assert (o - o_ref).abs().max() <= TOL
    assert (lse - lse_ref).abs().max() <= TOL
    dqs, dks, dvs = tring.ring_hops_bwd(
        *shards[:3], [o for o, _ in outs], [lse for _, lse in outs],
        shards[3])
    refs = tattn.flash_bwd_plain(q, k, v, o, lse, g, causal=True)
    for got, ref in zip((dqs, dks, dvs), refs):
        assert (torch.cat(got, dim=1) - ref).abs().max() <= TOL
    assert counts == {"fwd": 10, "bwd": 10}


@pytest.fixture()
def world_of_one():
    existed = dist.is_initialized()
    yield
    if dist.is_initialized() and not existed:
        dist.destroy_process_group()


def test_auto_trainer_trains_context_parallel(world_of_one):
    """``train(context_parallel="ring")`` no longer raises: on a one-rank
    ``seq`` mesh its loss is the plain loss (the ring is one diagonal
    hop), and it trains."""
    common = dict(model="tiny", model_overrides={"dtype": torch.float32},
                  batch_size=2, seq_len=32, steps=2, log_every=1,
                  warmup=False, device="cpu")
    ring = tauto.train(context_parallel="ring", mesh_shape={"seq": 1},
                       **common)
    plain = tauto.train(**common)
    assert ring["step"] == plain["step"] == 2.0
    assert abs(ring["loss"] - plain["loss"]) <= RUN_REL_TOL * plain["loss"]
