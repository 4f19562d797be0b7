"""The port's MoE family (mlrun_tpu_torch/models/moe.py) and MoE training
through the port's Trainer against the JAX package on the CPU, at
``tiny_moe`` size in float32 with TF32 off. Params are the reference's
``init_params`` converted with ``params_from_numpy``; inputs come from
numpy seeds; the JAX trainer runs on a one-device mesh.

The reference's ``_moe_mlp`` keeps its dispatch and combine masks to
itself, so the tests read them from its two one-hot products
(``bsec,bsm->ebcm`` and ``bsec,ebcm->bsm``) by swapping the module's
``jnp`` for a recording proxy while it runs eagerly.

Tolerances (the Llama parity tests'): logits 1e-4 absolute; losses,
metrics and gradients 1e-5; the dispatch mask exactly (0/1: which
(token, choice) landed in which slot), the combine mask 1e-6 (it carries
the float gates); a 3-step run 1e-4 relative.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.models import moe as jmoe
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models import moe as tmoe
from mlrun_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain

tmfu = importlib.import_module("mlrun_tpu_torch.training.mfu")

LOGIT_TOL = 1e-4
TOL = 1e-5
COMBINE_TOL = 1e-6
RUN_REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


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


def _models(seed=0, **overrides):
    jcfg = jmoe.tiny_moe(dtype=jnp.float32, attention_impl="reference",
                         **overrides)
    jparams = jmoe.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = tmoe.tiny_moe(dtype=torch.float32, **overrides)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


class _RecordingJnp:
    """``jax.numpy`` with ``einsum`` recording its operands by subscript."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, subscripts, *operands, **kwargs):
        self.calls[subscripts] = [np.asarray(o) for o in operands]
        return jnp.einsum(subscripts, *operands, **kwargs)


def _reference_moe_mlp(monkeypatch, jcfg, x, lp):
    """(out, aux, dispatch, combine) of the reference's ``_moe_mlp``."""
    recorder = _RecordingJnp()
    with monkeypatch.context() as patch:
        patch.setattr(jmoe, "jnp", recorder)
        out, aux = jmoe._moe_mlp(jcfg, jnp.asarray(x), lp)
    return (np.asarray(out), float(aux),
            recorder.calls["bsec,bsm->ebcm"][0],
            recorder.calls["bsec,ebcm->bsm"][0])


@pytest.mark.parametrize("case", ["routed", "drops", "zero_router"])
def test_moe_mlp_dispatch_and_output_match_reference(case, monkeypatch):
    """``_moe_mlp`` on one layer: the output and aux loss, the dispatch
    mask bit for bit and the combine mask. ``drops``: capacity factor
    0.25 (capacity 2 of 16 tokens a choice) drops most (token, choice)
    pairs, as the reference's ``test_expert_capacity_drops_gracefully``;
    ``zero_router``: every expert has probability 1/E, every token ties,
    and the reference picks experts 0 and 1."""
    overrides = {"capacity_factor": 0.25} if case == "drops" else {}
    jcfg, jparams, tcfg, tparams = _models(seed=1, **overrides)
    lp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tlp = {k: v[0] for k, v in tparams["layers"].items()}
    if case == "zero_router":
        lp = dict(lp, router=jnp.zeros_like(lp["router"]))
        tlp = dict(tlp, router=torch.zeros_like(tlp["router"]))
    x = np.random.default_rng(2).standard_normal((2, 16, 128)).astype(
        np.float32)
    out, aux, dispatch, combine = _reference_moe_mlp(monkeypatch, jcfg, x,
                                                     lp)
    t_dispatch, t_combine, _ = tmoe.route(tcfg, torch.from_numpy(x),
                                          tlp["router"])
    t_out, t_aux = tmoe._moe_mlp(tcfg, torch.from_numpy(x), tlp)
    np.testing.assert_array_equal(t_dispatch.numpy(), dispatch)
    assert np.abs(t_combine.numpy() - combine).max() <= COMBINE_TOL
    assert np.abs(t_out.numpy() - out).max() <= TOL
    assert abs(float(t_aux) - aux) <= TOL
    kept = dispatch.sum() / (2 * 16 * tcfg.top_k)
    if case == "drops":
        assert kept < 0.5 and np.isfinite(t_out.numpy()).all()
    if case == "zero_router":
        # experts 0 and 1 take every token's two choices, up to capacity
        assert dispatch[:, :, 2:].sum() == 0
        assert dispatch[:, :, :2].sum() == 2 * 2 * tcfg.capacity(16)
    else:
        assert kept > 0


def test_forward_logits_and_aux_match_reference():
    jcfg, jparams, tcfg, tparams = _models(seed=3)
    tokens = _tokens((2, 24), seed=4)
    jl, ja = jmoe.forward(jcfg, jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, ta = tmoe.forward(tcfg, tparams, torch.from_numpy(tokens))
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= LOGIT_TOL
    assert abs(float(ja) - float(ta)) <= TOL


def _grad_tree(params):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad
            for k, v in params.items()}


@pytest.mark.parametrize("chunk,remat", [(0, False), (8, False), (0, True)])
def test_loss_metrics_and_grads_match_reference(chunk, remat):
    """``loss_fn`` on the full-logits path and the chunked head (the metric
    surface of the reference's ``test_loss_metric_surface_chunk_parity``),
    with a target mask: loss, ce_loss, aux_loss, accuracy and the gradient
    of every leaf against ``jax.grad``; per-layer remat changes nothing."""
    jcfg, jparams, tcfg, tparams = _models(seed=5)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    tokens, targets = _tokens((2, 20), seed=6), _tokens((2, 20), seed=7)
    mask = (np.random.default_rng(8).random((2, 20)) > 0.2).astype(
        np.float32)

    def jloss(p):
        return jmoe.loss_fn(jcfg, p, jnp.asarray(tokens),
                            jnp.asarray(targets), mask=jnp.asarray(mask),
                            loss_chunk=chunk)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = ttrain.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), tparams)
    tl, tm = tmoe.loss_fn(tcfg, tparams, torch.from_numpy(tokens),
                          torch.from_numpy(targets),
                          mask=torch.from_numpy(mask), loss_chunk=chunk)
    tl.backward()
    assert set(tm) == set(jm) == {"loss", "ce_loss", "aux_loss", "accuracy"}
    for key in jm:
        assert abs(float(jm[key]) - tm[key].item()) <= TOL, key
    _assert_trees_close(jg, _grad_tree(tparams), TOL)


def test_param_count_and_flops_match_reference():
    for name in ("tiny_moe", "mixtral_8x7b_like"):
        jcfg, tcfg = getattr(jmoe, name)(), getattr(tmoe, name)()
        assert tcfg.param_count() == jcfg.param_count()
        for seq in (16, 2048):
            assert tcfg.flops_per_token(seq) == jcfg.flops_per_token(seq)
    tcfg = tmoe.tiny_moe(dtype=torch.float32)
    params = tmoe.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in ttrain.tree_leaves(params)) \
        == tcfg.param_count()
    assert params["layers"]["router"].dtype == torch.float32
    # active FLOPs: a token's top-2 experts and the router on top of the
    # dense backbone with one MLP (never all eight experts)
    mixtral = tmoe.mixtral_8x7b_like(n_layers=2)
    dense = tllama.LlamaConfig(**{
        f.name: getattr(mixtral, f.name)
        for f in dataclasses.fields(tllama.LlamaConfig)})
    e, m = mixtral.embed_dim, mixtral.mlp_dim
    extra = 6.0 * mixtral.n_layers * ((mixtral.top_k - 1) * 3 * e * m
                                      + e * mixtral.n_experts)
    assert mixtral.flops_per_token(2048) == pytest.approx(
        dense.flops_per_token(2048) + extra, rel=1e-12)


def _train_cfg(cls, **kw):
    base = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3,
                weight_decay=0.1, moe_experts=4, loss_chunk=0)
    base.update(kw)
    return cls(**base)


def test_trainer_fit_with_moe_experts_matches_reference_trainer():
    """Three steps of the port's Trainer with ``moe_experts=4`` from the
    reference's converted init, on the same synthetic batches, against
    the JAX Trainer on a one-device ``expert`` x ``fsdp`` mesh: per-step
    loss, aux_loss and grad_norm, and the final params. ``fit``'s MFU
    reads the resolved MoEConfig's active FLOPs."""
    from mlrun_tpu.training import Trainer as JTrainer

    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jt = JTrainer(jcfg, _train_cfg(jtrain.TrainConfig,
                                   mesh_shape={"expert": 1, "fsdp": 1}))
    jt.init(0)
    assert isinstance(jt.model_config, jmoe.MoEConfig)
    init = jax.tree.map(np.asarray, jt.state.params)
    tt = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                        _train_cfg(ttrain.TrainConfig), device="cpu")
    assert isinstance(tt.model_config, tmoe.MoEConfig)
    assert tt.model_config.n_experts == 4 and tt.model_config.top_k == 2
    tt.init(params=params_from_numpy(init, "cpu"))
    jt.fit(jdata.synthetic_token_stream(4, 16, 512, seed=1), 3, log_every=1,
           prefetch=0, defer_metrics=False)
    tt.fit(tdata.synthetic_token_stream(4, 16, 512, seed=1), 3, log_every=1,
           prefetch=0, defer_metrics=False)
    assert len(tt.metrics_history) == 3
    for jm, tm in zip(jt.metrics_history, tt.metrics_history):
        assert jm["step"] == tm["step"]
        for key in ("loss", "aux_loss", "grad_norm"):
            assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * abs(jm[key]), key
        flops = tt.model_config.flops_per_token(16)
        assert tm["mfu"] == pytest.approx(tmfu.mfu(
            tm["tokens_per_sec"], flops, device="cpu"))
    _assert_trees_close(jax.tree.map(np.asarray, jt.state.params),
                        params_to_numpy(tt.state.params), RUN_REL_TOL)


@pytest.fixture()
def world_of_one():
    """A world-size-1 gloo group of this process, left as found."""
    import torch.distributed as dist

    existed = dist.is_initialized()
    yield
    if dist.is_initialized() and not existed:
        dist.destroy_process_group()


def test_moe_rejects_lora_and_context_parallel_like_reference(world_of_one):
    """MoE with LoRA or context parallelism raises the reference's
    ValueError. Expert parallelism landed (multi-rank parity in
    tests/test_torch_expert_parallel.py): in one process an expert axis
    of 2 raises the mesh's "needs 2 devices" ValueError before any group
    exists, and a size-1 ``{"expert": 1, "fsdp": 1}`` mesh trains
    bit-equal to no mesh, the experts placed by ``make_moe_rules``."""
    for kw, match in (({"lora_rank": 4}, "lora_rank"),
                      ({"context_parallel": "ring"}, "context_parallel")):
        with pytest.raises(ValueError, match=match):
            ttrain.Trainer(tllama.tiny_llama(),
                           ttrain.TrainConfig(moe_experts=4, **kw),
                           device="cpu")
        with pytest.raises(ValueError, match=match):
            jtrain.make_train_step(
                jllama.tiny_llama(), jtrain.TrainConfig(moe_experts=4, **kw),
                None, None)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        ttrain.Trainer(tllama.tiny_llama(), ttrain.TrainConfig(
            moe_experts=4, mesh_shape={"expert": 2}), device="cpu")
    from torch.distributed.tensor import DTensor, Shard

    runs = {}
    for shape in (None, {"expert": 1, "fsdp": 1}):
        trainer = ttrain.Trainer(
            tllama.tiny_llama(dtype=torch.float32), ttrain.TrainConfig(
                moe_experts=4, mesh_shape=shape, learning_rate=1e-2,
                warmup_steps=1, total_steps=2), device="cpu")
        trainer.init(0)
        trainer.fit(tdata.synthetic_token_stream(2, 16, 512, seed=1), 2,
                    log_every=1, prefetch=0, defer_metrics=False)
        runs[shape is None] = [(m["loss"], m["aux_loss"], m["grad_norm"])
                               for m in trainer.metrics_history]
    gate = trainer.state.params["layers"]["experts_gate"]
    assert isinstance(gate, DTensor)
    assert trainer._rules() == tmoe.make_moe_rules()
    assert not any(isinstance(p, Shard) for p in gate.placements)
    assert runs[True] == runs[False]


def test_auto_trainer_trains_moe():
    """The tpujob handler's contract with ``moe_experts``: the reference's
    one-device mesh default, an MoE model through Trainer.fit, the
    reference's metric keys."""
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto
    from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto

    ref = jauto.train(model="tiny", steps=3, batch_size=4, seq_len=16,
                      log_every=1, moe_experts=4)
    ours = tauto.train(model="tiny", steps=3, batch_size=4, seq_len=16,
                       log_every=1, moe_experts=4, device="cpu")
    assert set(ours) == set(ref)
    assert {"aux_loss", "ce_loss"} <= set(ours)
    assert ours["step"] == 3.0 and np.isfinite(ours["loss"])


def test_no_item_7_is_left_in_the_port():
    """Item 7 (training on many GPUs) has landed: no ``not_ported`` call
    names it, ``PORT_QUEUE`` no longer lists it, and the options that
    raised it (expert parallelism, LoRA on a ``tensor`` axis, the
    families' sharded steps, ``shardings=``) take their ported paths."""
    import ast
    import inspect
    from pathlib import Path

    from mlrun_tpu_torch.frameworks import huggingface as thf
    from mlrun_tpu_torch.serving.resilience import PORT_QUEUE

    assert 7 not in PORT_QUEUE and set(PORT_QUEUE) == {14}
    root = Path(__file__).resolve().parents[1] / "mlrun_tpu_torch"
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "not_ported":
                item = node.args[1]
                assert not (isinstance(item, ast.Constant)
                            and item.value == 7), f"{path}:{node.lineno}"
    assert "not_ported" not in inspect.getsource(
        thf.load_hf_weights_into_llama)


def test_no_item_9_is_left_in_the_port():
    """Item 9 (the other model families) has landed: no ``not_ported``
    call names it and ``PORT_QUEUE`` no longer lists it."""
    import ast
    from pathlib import Path

    from mlrun_tpu_torch.serving.resilience import PORT_QUEUE

    assert 9 not in PORT_QUEUE
    root = Path(__file__).resolve().parents[1] / "mlrun_tpu_torch"
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "not_ported":
                item = node.args[1]
                assert not (isinstance(item, ast.Constant)
                            and item.value == 9), f"{path}:{node.lineno}"


def test_converter_carries_the_moe_tree():
    """``params_from_numpy`` / ``params_to_numpy`` carry the reference's
    MoE tree (``layers`` with the float32 router and the ``[L, E, ...]`` experts) across unchanged: bf16 leaves stay bf16 (exactly,
    through float32), float32 leaves float32, an int32 leaf int32."""
    tree = jax.tree.map(np.asarray, jmoe.init_params(jmoe.tiny_moe(), jax.random.PRNGKey(0)))
    tree["step"] = np.arange(3, dtype=np.int32)
    ported = params_from_numpy(tree, "cpu")
    assert ported.keys() == tree.keys()
    for (name, arr), (_, tensor) in zip(_leaves(tree), _leaves(ported)):
        kind = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int32": torch.int32}[arr.dtype.name]
        assert tensor.dtype == kind and tuple(tensor.shape) == arr.shape, \
            name
    back = params_to_numpy(ported)
    for (name, arr), (_, out) in zip(_leaves(tree), _leaves(back)):
        np.testing.assert_array_equal(out, arr.astype(out.dtype), name)
