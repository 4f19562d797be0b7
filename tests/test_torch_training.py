"""The port's training path (mlrun_tpu_torch.training, the loss of
models/llama.py, the torch auto-trainer) against the JAX package on the
CPU, at ``tiny_llama`` size in float32. Inputs come from numpy seeds; the
JAX trainer runs on a 1-device mesh.

Tolerances (float32; the two sides differ only in summation order):
- losses and accuracies 1e-5 absolute (O(1) values);
- gradients 1e-5 absolute (O(1e-2..1) values);
- a 5-step training run: per-step loss and grad_norm within 1e-4
  relative, final params within 1e-4 absolute (measured: 1e-7 relative
  and 4e-6) — five AdamW steps at lr 1e-2 amplify round-off a little;
- optimizer pieces 1e-6 relative.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from mlrun_tpu_torch.ops import attention as tattn
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain
from tests.torch_registries import registries_left_as_found  # noqa: F401

# the package re-exports an ``mfu`` function under the submodule's name
tmfu = importlib.import_module("mlrun_tpu_torch.training.mfu")

TOL = 1e-5
RUN_REL_TOL = 1e-4
PARAM_TOL = 1e-4


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    else:
        yield prefix.rstrip("."), tree


def _assert_trees_close(jtree, ttree, tol):
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert jl.keys() == tl.keys()
    for key, arr in jl.items():
        other = tl[key]
        if isinstance(other, torch.Tensor):
            other = other.detach().float().numpy()
        diff = np.abs(np.asarray(arr, np.float32) - other).max()
        assert diff <= tol, f"{key}: max abs diff {diff} > {tol}"


def _models(seed=0, **jax_overrides):
    """The reference's tiny f32 model and its params, converted."""
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference",
                             **jax_overrides)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _grad_tree(params):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad
            for k, v in params.items()}


def _port_loss_and_grads(cfg, params, tokens, targets, **kw):
    params = ttrain.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                             params)
    loss, metrics = tllama.loss_fn(cfg, params, torch.from_numpy(tokens),
                                   torch.from_numpy(targets), **kw)
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _grad_tree(params))


# -- loss ----------------------------------------------------------------------

@pytest.mark.parametrize("seq,chunk", [(32, 0), (32, 8), (27, 8), (27, 512)])
def test_loss_and_grads_match_reference(seq, chunk):
    """``loss_fn`` — full logits (chunk 0) and ``chunked_ce`` (chunks of 8,
    27 tokens padding to a chunk multiple, and one chunk larger than the
    sequence) — against the reference's: loss, accuracy, token count and
    every parameter's gradient."""
    jcfg, jparams, tcfg, tparams = _models(seed=1)
    tokens = _tokens((2, seq), seed=2)
    targets = _tokens((2, seq), seed=3)
    mask = (np.random.default_rng(4).random((2, seq)) > 0.2).astype(
        np.float32)

    def jloss(p):
        return jllama.loss_fn(jcfg, p, jnp.asarray(tokens),
                              jnp.asarray(targets), mask=jnp.asarray(mask),
                              loss_chunk=chunk)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tl, tm, tg = _port_loss_and_grads(tcfg, tparams, tokens, targets,
                                      mask=torch.from_numpy(mask),
                                      loss_chunk=chunk)
    assert abs(float(jl) - float(tl)) <= TOL
    for key in ("loss", "accuracy", "tokens"):
        assert abs(float(jm[key]) - float(tm[key])) <= TOL, key
    _assert_trees_close(jg, tg, TOL)


def test_chunked_ce_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, 16), np.float32)
    head = rng.standard_normal((16, 40), np.float32)
    targets = rng.integers(0, 40, (2, 21), dtype=np.int32)
    j = jllama.chunked_ce(jnp.asarray(x), jnp.asarray(head),
                          jnp.asarray(targets), chunk=8)
    t = tllama.chunked_ce(torch.from_numpy(x), torch.from_numpy(head),
                          torch.from_numpy(targets), chunk=8)
    for a, b in zip(j, t):
        assert abs(float(a) - float(b)) <= TOL
    assert float(t[2]) == 42.0


def test_bf16_head_gradient_takes_the_float32_cotangent():
    """The bf16 head product with a float32 result (``_LogitsF32``, the
    CUDA path of ``logits_f32``) differentiates as the reference's
    ``preferred_element_type=f32`` einsum does, with the float32 logit
    gradient: both sides round nearly the same float32 product to bf16,
    so at least 99% of the gradient elements are bit-identical and none
    is off by half a bf16 ulp of the largest one (2**-8 of it). Rounding
    the cotangent to bf16 first matches only ~58% of them, and is off by
    ~1.5 such half-ulps."""
    rng = np.random.default_rng(12)
    n, e, vocab = 64, 128, 1000
    x = jnp.asarray(rng.standard_normal((n, e), np.float32) * 0.5,
                    jnp.bfloat16)
    head = jnp.asarray(rng.standard_normal((e, vocab), np.float32)
                       * e ** -0.5, jnp.bfloat16)
    g = rng.standard_normal((n, vocab), np.float32) * 1e-3
    logits, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "nd,dv->nv", a, b, preferred_element_type=jnp.float32), x, head)
    refs = [np.asarray(r.astype(jnp.float32)) for r in vjp(jnp.asarray(g))]

    def to_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16).requires_grad_(True)

    tx, thead = to_torch(x), to_torch(head)
    out = tllama._LogitsF32.apply(tx, thead)
    assert out.dtype == torch.float32
    assert np.abs(out.detach().numpy() - np.asarray(logits)).max() <= TOL
    grads = torch.autograd.grad(out, (tx, thead), torch.from_numpy(g))
    for name, got, ref in zip(("x", "head"), grads, refs):
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        identical = float((got == ref).mean())
        assert identical >= 0.99, f"d{name}: {identical} bit-identical"
        worst = np.abs(got - ref).max() / np.abs(ref).max()
        assert worst <= 2.0 ** -8, f"d{name}: {worst} of the largest"


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_remat_policies_same_loss_and_grads(impl, monkeypatch):
    """The three remat policies (and no remat) give the same loss and
    grads; ``save_attn`` keeps the flash forward's outputs, so the
    backward does not run it again (one forward per layer, not two)."""
    _, _, tcfg, tparams = _models(seed=6)
    tokens, targets = _tokens((2, 32), seed=7), _tokens((2, 32), seed=8)
    calls = []
    plain = tattn.flash_fwd_plain

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_fwd_plain", counting)
    results = {}
    for policy in (None, "nothing", "save_attn", "dots"):
        cfg = dataclasses.replace(tcfg, attention_impl=impl,
                                  remat=policy is not None,
                                  remat_policy=policy or "nothing")
        calls.clear()
        loss, _, grads = _port_loss_and_grads(cfg, tparams, tokens, targets,
                                              loss_chunk=16)
        results[policy] = (float(loss), grads, len(calls))
    base_loss, base_grads, _ = results[None]
    for policy, (loss, grads, n_fwd) in results.items():
        assert abs(loss - base_loss) <= 1e-6, policy
        jtree = ttrain.tree_map(lambda t: t.numpy(), base_grads)
        _assert_trees_close(jtree, grads, 1e-6)
    if impl == "auto":
        n_layers = tcfg.n_layers
        assert results[None][2] == n_layers
        assert results["nothing"][2] == 2 * n_layers
        assert results["save_attn"][2] == n_layers
    with pytest.raises(ValueError, match="unknown remat_policy"):
        _port_loss_and_grads(dataclasses.replace(tcfg, remat=True,
                                                 remat_policy="bogus"),
                             tparams, tokens, targets)


def test_flops_per_token_matches_reference():
    for name in ("llama3-8b", "llama3-1b", "tiny"):
        jcfg = {"llama3-8b": jllama.llama3_8b, "llama3-1b": jllama.llama3_1b,
                "tiny": jllama.tiny_llama}[name]()
        tcfg = tllama.MODEL_PRESETS[name]()
        assert tcfg.flops_per_token(2048) == jcfg.flops_per_token(2048)
        assert tcfg.remat == jcfg.remat
        assert tcfg.remat_policy == jcfg.remat_policy


def test_params_to_numpy_reverses_the_converter():
    _, jparams, _, tparams = _models(seed=9)
    back = params_to_numpy(tparams)
    _assert_trees_close(jax.tree.map(np.asarray, jparams), back, 0.0)
    bf16 = params_from_numpy(back, "cpu", dtype=torch.bfloat16)
    assert params_to_numpy(bf16)["embedding"].dtype == np.float32


# -- optimizer -----------------------------------------------------------------

def _random_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3), np.float32) * scale,
            "b": {"c": rng.standard_normal((7,), np.float32) * scale,
                  "d": rng.standard_normal((2, 2, 2), np.float32) * scale}}


def test_schedule_matches_optax():
    for warmup, total in ((3, 10), (0, 5), (10, 4)):
        cfg = ttrain.TrainConfig(learning_rate=3e-3, warmup_steps=warmup,
                                 total_steps=total)
        ours = ttrain.make_optimizer(cfg).schedule
        ref = optax.warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, warmup, max(total, warmup + 1))
        for count in range(total + 3):
            assert abs(ours(count) - float(ref(count))) <= \
                1e-6 * cfg.learning_rate, (warmup, total, count)
    # the first update's lr is the schedule at count 0: 0 under warmup
    assert ttrain.make_optimizer(ttrain.TrainConfig()).schedule(0) == 0.0


@pytest.mark.parametrize("scale,weight_decay", [(1.0, 0.0), (0.01, 0.1)])
def test_adamw_updates_match_optax(scale, weight_decay):
    """Three updates of the reference's optax chain (clip_by_global_norm
    1.0 — triggered at scale 1, not at scale 0.01 — then adamw) against
    the port's, on a random tree; grad_norm is the norm before clipping."""
    cfg = ttrain.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                             total_steps=4, weight_decay=weight_decay)
    joptim = jtrain.make_optimizer(cfg)
    params_np = _random_tree(0)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = joptim.init(jparams)
    toptim = ttrain.make_optimizer(cfg)
    tparams = params_from_numpy(params_np, "cpu")
    tstate = toptim.init(tparams)
    for step in range(3):
        grads_np = _random_tree(step + 1, scale)
        jgrads = jax.tree.map(jnp.asarray, grads_np)
        updates, jstate = joptim.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        g_norm = toptim.update(
            ttrain.tree_leaves(params_from_numpy(grads_np, "cpu")), tstate,
            tparams)
        ref_norm = float(optax.global_norm(jgrads))
        assert abs(float(g_norm) - ref_norm) <= 1e-6 * ref_norm
        assert (ref_norm >= 1.0) == (scale == 1.0)
        _assert_trees_close(jparams, tparams, 1e-6)
    assert tstate.count == 3
    _assert_trees_close(jstate[1][0].mu, tstate.mu, 1e-6)
    _assert_trees_close(jstate[1][0].nu, tstate.nu, 1e-6)


# -- trainer -------------------------------------------------------------------

def _train_cfg(cls, **kw):
    base = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                weight_decay=0.1)
    base.update(kw)
    return cls(**base)


def test_trainer_matches_reference_trainer():
    """Five steps of the port's Trainer from the reference's converted
    init, on the same synthetic_token_stream batches, against the JAX
    Trainer on a 1-device mesh: per-step loss and grad_norm, and the
    final params through the reverse converter."""
    from mlrun_tpu.training import Trainer as JTrainer

    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jt = JTrainer(jcfg, _train_cfg(jtrain.TrainConfig,
                                   mesh_shape={"fsdp": 1}))
    jt.init(0)
    init = jax.tree.map(np.asarray, jt.state.params)
    tt = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                        _train_cfg(ttrain.TrainConfig), device="cpu")
    tt.init(params=params_from_numpy(init, "cpu"))
    jt.fit(jdata.synthetic_token_stream(4, 32, 512, seed=1), 5, log_every=1,
           prefetch=0, defer_metrics=False)
    last = tt.fit(tdata.synthetic_token_stream(4, 32, 512, seed=1), 5,
                  log_every=1, prefetch=0, defer_metrics=False)
    assert len(tt.metrics_history) == 5 and last["step"] == 5
    for jm, tm in zip(jt.metrics_history, tt.metrics_history):
        assert jm["step"] == tm["step"]
        for key in ("loss", "grad_norm"):
            assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * abs(jm[key]), key
    _assert_trees_close(jax.tree.map(np.asarray, jt.state.params),
                        params_to_numpy(tt.state.params), PARAM_TOL)


def _port_trainer(**kw):
    trainer = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                             _train_cfg(ttrain.TrainConfig, **kw),
                             device="cpu")
    trainer.init(0)
    return trainer


def test_grad_accum_equals_single_batch():
    """grad_accum=2 averages two half-batch gradients: the same update as
    the whole batch at once (the mean loss is over equal-size halves)."""
    runs = []
    for accum in (1, 2):
        trainer = _port_trainer(grad_accum=accum)
        trainer.fit(tdata.synthetic_token_stream(4, 16, 512, seed=2), 3,
                    log_every=1, prefetch=0, defer_metrics=False)
        runs.append(trainer)
    a, b = (r.metrics_history for r in runs)
    for ma, mb in zip(a, b):
        assert abs(ma["grad_norm"] - mb["grad_norm"]) <= \
            RUN_REL_TOL * ma["grad_norm"]
    _assert_trees_close(params_to_numpy(runs[0].state.params),
                        runs[1].state.params, PARAM_TOL)
    with pytest.raises(ValueError, match="grad_accum=3"):
        _port_trainer(grad_accum=3).train_step(*next(
            tdata.synthetic_token_stream(4, 8, 512)))


def test_fit_prefetch_and_deferred_metrics_match_sync_path():
    """The prefetch stage and deferred metric reads change when values
    are read, not what they are: the same history as the plain loop, one
    entry per log point, and bare callables fire at log points."""
    plain = _port_trainer()
    plain.fit(tdata.synthetic_token_stream(2, 16, 512, seed=3), 4,
              log_every=2, prefetch=0, defer_metrics=False)
    piped = _port_trainer()
    piped.fit(tdata.synthetic_token_stream(2, 16, 512, seed=3), 4,
              log_every=2, prefetch=2, defer_metrics=True)
    seen = []
    cb = _port_trainer()
    cb.fit(tdata.synthetic_token_stream(2, 16, 512, seed=3), 4, log_every=2,
           prefetch=2, callbacks=[lambda s, m, t: seen.append((s, m["loss"]))])
    for run in (piped, cb):
        assert [m["step"] for m in run.metrics_history] == [2, 4]
        for a, b in zip(plain.metrics_history, run.metrics_history):
            assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert [s for s, _ in seen] == [1, 3]


def test_unported_options_raise_not_implemented():
    """Item 7 landed whole: expert parallelism and LoRA on a ``tensor``
    axis raise no NotImplementedError any more (gloo parity in
    tests/test_torch_expert_parallel.py and
    tests/test_torch_sharded_steps.py), nor does any other reference
    trainer mesh option (tests/test_torch_{parallel,context_parallel,
    tensor_parallel,pipeline,elastic}.py); in one process a multi-rank
    mesh raises the reference's errors before any group exists."""
    for kw, n in (({"moe_experts": 4, "mesh_shape": {"expert": 4}}, 4),
                  ({"lora_rank": 4, "mesh_shape": {"tensor": 2}}, 2)):
        with pytest.raises(ValueError, match=f"needs {n} devices, have 1"):
            ttrain.Trainer(tllama.tiny_llama(), ttrain.TrainConfig(**kw),
                           device="cpu")
    for shape in ({"data": 2}, {"tensor": 2}):
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            ttrain.Trainer(tllama.tiny_llama(),
                           ttrain.TrainConfig(mesh_shape=shape),
                           device="cpu")
    with pytest.raises(ValueError, match="needs a 'seq' axis"):
        ttrain.Trainer(tllama.tiny_llama(),
                       ttrain.TrainConfig(context_parallel="ring"),
                       device="cpu")
    with pytest.raises(ValueError, match="needs a 'pipe' mesh axis"):
        ttrain.Trainer(tllama.tiny_llama(),
                       ttrain.TrainConfig(pipeline_stages=2), device="cpu")
    trainer = _port_trainer()
    # structured callbacks landed with item 10 (tests/test_torch_callbacks.py
    # holds them against the reference); an object that is neither a
    # Callback nor callable is refused as the reference refuses it
    stream = tdata.synthetic_token_stream(2, 8, 512)
    with pytest.raises(TypeError, match="neither a Callback nor callable"):
        trainer.fit(stream, 1, callbacks=[object()])
    # an elastic guard needs a trainer on a mesh to reshard
    from mlrun_tpu_torch.chaos import chaos, fail_nth
    from mlrun_tpu_torch.training import ElasticGuard

    guard = ElasticGuard(ranks=range(2), num_slices=2)
    with chaos.inject("train.slice_fail", fail_nth(1),
                      action=lambda p, ctx: ctx["box"].__setitem__("fail",
                                                                   1)):
        with pytest.raises(ValueError, match="sharded mesh"):
            trainer.fit(stream, 1, elastic_guard=guard)


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.Trainer(tllama.tiny_llama())


def test_checkpoint_round_trip_and_preemption_exit(tmp_path):
    from mlrun_tpu_torch.training import CheckpointManager, PreemptionGuard

    trainer = _port_trainer()
    trainer.fit(tdata.synthetic_token_stream(2, 8, 512, seed=4), 2,
                log_every=1, prefetch=0)
    manager = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    guard = PreemptionGuard()
    guard.request()
    out = trainer.fit(tdata.synthetic_token_stream(2, 8, 512, seed=5), 3,
                      checkpoint_manager=manager, preemption_guard=guard)
    assert out["preempted"] is True and out["step"] == 2
    assert manager.latest_step() == 2
    fresh = _port_trainer()
    restored = manager.restore(fresh.state)
    assert restored.step == 2 and restored.opt_state.count == 2
    _assert_trees_close(params_to_numpy(trainer.state.params),
                        restored.params, 0.0)
    _assert_trees_close(params_to_numpy(trainer.state.opt_state.nu),
                        restored.opt_state.nu, 0.0)
    assert all(leaf.requires_grad
               for leaf in ttrain.tree_leaves(restored.params))
    for step in (3, 4, 5):
        manager.save(step, trainer.state)
    assert sorted(int(p.name) for p in (tmp_path / "ck").iterdir()) == [4, 5]


# -- data, mfu, auto-trainer ---------------------------------------------------

def test_token_streams_match_reference():
    for make_j, make_t in (
            (lambda: jdata.synthetic_token_stream(3, 9, 100, seed=7),
             lambda: tdata.synthetic_token_stream(3, 9, 100, seed=7)),
            (lambda: jdata.array_token_stream(np.arange(200), 2, 8, seed=3),
             lambda: tdata.array_token_stream(np.arange(200), 2, 8, seed=3))):
        js, ts = make_j(), make_t()
        for _ in range(15):
            for a, b in zip(next(js), next(ts)):
                np.testing.assert_array_equal(a, b)


def test_device_prefetch_is_ordered_and_error_transparent():
    def stream():
        yield from tdata.synthetic_token_stream(2, 4, 50, seed=1)

    ref = tdata.synthetic_token_stream(2, 4, 50, seed=1)
    with tdata.DevicePrefetchIterator(stream(), device="cpu", depth=2) as it:
        for _ in range(5):
            tok, tgt = next(it)
            want = next(ref)
            assert tok.dtype == torch.int32
            np.testing.assert_array_equal(tok.numpy(), want[0])
            np.testing.assert_array_equal(tgt.numpy(), want[1])

    def failing():
        yield np.zeros((1, 2), np.int32), np.zeros((1, 2), np.int32)
        raise OSError("bad shard")

    it = tdata.DevicePrefetchIterator(failing(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="bad shard"):
        next(it)
    it.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_chaos_prefetch_error_reaches_consumer_in_position(pkg):
    """tests/test_train_pipeline.py's contract on both packages (ROADMAP
    3.11): an error armed at ``train.prefetch`` for the third batch
    reaches the consumer after the first two, at that batch's place."""
    if pkg == "jax":
        from mlrun_tpu.chaos import chaos, fail_nth

        prefetch = jdata.DevicePrefetchIterator
    else:
        from mlrun_tpu_torch.chaos import chaos, fail_nth

        def prefetch(stream, depth):
            return tdata.DevicePrefetchIterator(stream, device="cpu",
                                                depth=depth)

    batches = [(np.full((1, 2), i, np.int32),) * 2 for i in range(5)]
    with chaos.inject("train.prefetch", fail_nth(3),
                      error=RuntimeError("poisoned batch")):
        with prefetch(iter(batches), depth=2) as it:
            assert int(next(it)[0][0, 0]) == 0
            assert int(next(it)[0][0, 0]) == 1
            with pytest.raises(RuntimeError, match="poisoned"):
                next(it)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_preemption_mid_prefetch_drains_without_deadlock(pkg):
    """tests/test_train_pipeline.py's contract on both packages (ROADMAP
    3.11): with every prefetched batch delayed at ``train.prefetch`` and
    the guard latched before the first step, a 50-step fit returns
    preempted, promptly, without waiting on a full prefetch queue."""
    import time

    if pkg == "jax":
        from mlrun_tpu.chaos import chaos
        from mlrun_tpu.training import TrainConfig, Trainer
        from mlrun_tpu.training.preemption import PreemptionGuard

        trainer = Trainer(jllama.tiny_llama(attention_impl="reference",
                                            remat=False),
                          TrainConfig(mesh_shape={"fsdp": 1}))
        trainer.init(0)
        stream = jdata.synthetic_token_stream(
            4, 32, trainer.model_config.vocab_size)
    else:
        from mlrun_tpu_torch.chaos import chaos
        from mlrun_tpu_torch.training import PreemptionGuard

        trainer = _port_trainer()
        stream = tdata.synthetic_token_stream(
            4, 32, trainer.model_config.vocab_size)
    guard = PreemptionGuard()
    guard.request()   # latched before the first step
    with chaos.inject("train.prefetch", delay=0.05):
        started = time.time()
        out = trainer.fit(stream, steps=50, log_every=1,
                          preemption_guard=guard, prefetch=2)
        elapsed = time.time() - started
    assert out["preempted"] is True
    assert elapsed < 30   # returned promptly, not after 50 steps of input


def test_peak_flops_table(monkeypatch):
    assert tmfu.chip_peak_flops("cpu") == tmfu.PEAK_FLOPS["cpu"]
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", 756e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, n=name: n)
        assert tmfu.chip_peak_flops("cuda") == peak
    assert tmfu.mfu(1000.0, 1e8, device="cpu") == pytest.approx(0.1)


def test_auto_trainer_returns_the_reference_metric_keys(tmp_path):
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto
    from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto

    assert tauto.MODEL_PRESETS.keys() == jauto.MODEL_PRESETS.keys()
    ref = jauto.train(model="tiny", steps=3, batch_size=8, seq_len=16,
                      log_every=1)
    ours = tauto.train(model="tiny", steps=3, batch_size=8, seq_len=16,
                       log_every=1, device="cpu",
                       checkpoint_dir=str(tmp_path / "ck"))
    assert set(ours) == set(ref)
    assert ours["step"] == 3.0 and np.isfinite(ours["loss"])
    # a second run resumes from the saved step
    again = tauto.train(model="tiny", steps=1, batch_size=8, seq_len=16,
                        device="cpu", checkpoint_dir=str(tmp_path / "ck"))
    assert again["step"] == 4.0
    # text datasets landed with item 10 (tests/test_torch_tokenizer.py);
    # one without a tokenizer is refused as the reference refuses it
    with pytest.raises(ValueError, match="need a tokenizer= id"):
        tauto.train(model="tiny", dataset="corpus.txt", device="cpu")
