"""mlrun_tpu_torch's LoRA pieces against mlrun_tpu's on the CPU, at
``tiny_llama`` size in float32 (TF32 plays no part on the CPU): the
adapter module (models/lora.py: validation, merging, parameter counts),
the serving delta (``_lora_delta`` over a three-slot bank with mixed row
ids), the prefill forward with an adapter bank (cold and in the paged
prefix-hit form, every target), and LoRA training through ``Trainer``
(the loss and gradients of ``loss_fn``, five steps against the JAX
Trainer, the checkpoint and the auto-trainer). Adapters are drawn by the
JAX package and converted (``models/convert.params_from_numpy``).

Tolerances (float32; the two sides differ only in summation order):
- merged weights, the delta: 1e-6 absolute (O(1e-1) values; a rank-4
  reduction, measured 4.2e-7);
- a projection ``h @ w + delta``: the float32 accumulation bound over its
  reduction length, computed per element in the test (``_proj_bound``):
  each side's sum of ``d_in`` products is within ``d_in * 2**-24 *
  (|h| @ |w|)`` of the exact one, so the two within twice that, plus the
  delta's 1e-6 and the final add's rounding (``2**-24`` of the result on
  each side). At ``d_in = d_ffn = 256`` (``w_down``) summation order
  alone gives 1.9e-6, above any fixed 1e-6; the bound is 2.4e-4 there
  and the measured diffs sit below 0.7% of it, while a wrong weight,
  layer or row misses it by orders of magnitude;
- prefill logits with a bank: 1e-5 absolute (O(1) logits, two layers;
  measured 3e-6);
- LoRA gradients 1e-5 absolute; a 5-step run: per-step loss and
  grad_norm within 1e-4 relative, the final adapter within 1e-4
  absolute, as tests/test_torch_training.py holds full fine-tuning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.models import lora as jlora
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu.serving.adapters import AdapterBank as JBank
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models import lora as tlora
from mlrun_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving.adapters import AdapterBank as TBank
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain
from tests.torch_registries import registries_left_as_found  # noqa: F401

MERGE_TOL = 1e-6
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-5
RUN_REL_TOL = 1e-4
PARAM_TOL = 1e-4
ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
PAGE, MAX_LEN = 16, 64


def _convert(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(j, t, tol):
    if isinstance(t, torch.Tensor):
        t = t.detach().float().numpy()
    diff = np.abs(np.asarray(j, np.float32) - t)
    assert (diff <= tol).all(), \
        f"max abs diff {diff.max()}, worst share of its bound " \
        f"{float((diff / tol).max())}"


def _proj_bound(h: np.ndarray, w: np.ndarray, proj: np.ndarray):
    """Per-element float32 bound on two implementations of ``h @ w +
    delta`` that differ only in summation order: twice one side's
    accumulation bound over ``d_in`` terms, the delta's MERGE_TOL and
    each side's rounding of the final add."""
    u = 2.0 ** -24
    magnitude = np.abs(h) @ np.abs(np.asarray(w, np.float32))
    return (2 * h.shape[-1] * u * magnitude + MERGE_TOL
            + 2 * u * np.abs(proj))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    else:
        yield prefix.rstrip("."), tree


def _trees_close(jtree, ttree, tol):
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert jl.keys() == tl.keys()
    for key, arr in jl.items():
        _close(arr, tl[key], tol)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    return jcfg, jparams, tcfg, _convert(jparams)


def _jadapter(jcfg, seed, targets=jlora.DEFAULT_TARGETS, rank=4):
    return jlora.init_lora_nonzero(jcfg, jax.random.PRNGKey(seed),
                                   rank=rank, alpha=8.0, targets=targets)


# -- models/lora.py -----------------------------------------------------------

def _bad_trees(lora, other_cfg_lora):
    """Named mismatches, each given as (tree, validate_lora kwargs) from a
    well-formed ``lora`` (numpy leaves) — the checks of the reference's
    ``validate_lora``. A ``config`` / ``base`` kwarg of None stands for
    each package's own config / params."""
    def edit(target, **parts):
        out = {t: dict(a) for t, a in lora.items()}
        out[target] = dict(out[target], **parts)
        return out

    wq = lora["wq"]
    missing = {t: dict(a) for t, a in lora.items()}
    del missing["wk"]["scaling"]
    return {
        "empty": ({}, {}),
        "missing_key": (missing, {}),
        "wrong_ranks": (edit("wq", scaling=wq["scaling"][:, None]), {}),
        "layer_counts": (edit("wv", lora_b=lora["wv"]["lora_b"][:1]), {}),
        "factor_rank": (edit("wk", lora_b=lora["wk"]["lora_b"][:, :2]), {}),
        "transposed_b": (edit("wq", lora_b=np.swapaxes(wq["lora_b"], 1, 2)),
                         {}),
        "target_rank": (edit("wo", lora_a=lora["wo"]["lora_a"][..., :2],
                             lora_b=lora["wo"]["lora_b"][:, :2]), {}),
        "not_allowed": (lora, {"targets": ("wq", "wk")}),
        "unknown_target": ({"nope": wq}, {"config": None}),
        "other_config": (other_cfg_lora, {"config": None}),
        "no_base_projection": ({"nope": wq}, {"base": None}),
        "base_shape": (other_cfg_lora, {"base": None}),
        "required_rank": (lora, {"rank": 8}),
    }


BAD_CASES = ("empty", "missing_key", "wrong_ranks", "layer_counts",
             "factor_rank", "transposed_b", "target_rank", "not_allowed",
             "unknown_target", "other_config", "no_base_projection",
             "base_shape", "required_rank")


@pytest.mark.parametrize("case", BAD_CASES)
def test_validate_lora_raises_where_the_reference_raises(models, case):
    """Every mismatch the reference's ``validate_lora`` rejects, the
    port's rejects too, with its own ``LoraShapeError`` (a ValueError);
    the well-formed tree passes both with the same rank."""
    jcfg, jparams, tcfg, tparams = models
    lora = jax.tree.map(np.asarray, _jadapter(jcfg, 1))
    other = jllama.tiny_llama(embed_dim=64, n_heads=2, head_dim=32,
                              mlp_dim=128)
    other_lora = jax.tree.map(np.asarray, _jadapter(other, 2))
    tree, kwargs = _bad_trees(lora, other_lora)[case]
    jkw = {k: {"config": jcfg, "base": jparams}.get(k, v) if v is None
           else v for k, v in kwargs.items()}
    tkw = {k: {"config": tcfg, "base": tparams}.get(k, v) if v is None
           else v for k, v in kwargs.items()}
    with pytest.raises(jlora.LoraShapeError):
        jlora.validate_lora(jax.tree.map(jnp.asarray, tree), **jkw)
    with pytest.raises(tlora.LoraShapeError) as err:
        tlora.validate_lora(_convert(tree) if tree else tree, **tkw)
    assert isinstance(err.value, ValueError)
    assert tlora.validate_lora(_convert(lora), config=tcfg, base=tparams,
                               rank=4) == jlora.validate_lora(
        lora, config=jcfg, base=jparams, rank=4) == 4


@pytest.mark.parametrize("targets", [jlora.DEFAULT_TARGETS, ALL_TARGETS])
def test_merge_lora_matches_reference(models, targets):
    """``merge_lora`` (float32 add, cast back) gives the reference's
    merged weights; untouched weights are shared, not copied."""
    jcfg, jparams, tcfg, tparams = models
    jl = _jadapter(jcfg, 3, targets)
    jmerged = jlora.merge_lora(jparams, jl)
    tmerged = tlora.merge_lora(tparams, _convert(jl))
    _trees_close(jax.tree.map(np.asarray, jmerged), tmerged, MERGE_TOL)
    assert tmerged["embedding"] is tparams["embedding"]
    for name in set(tparams["layers"]) - set(targets):
        assert tmerged["layers"][name] is tparams["layers"][name]


def test_merge_lora_bf16_casts_back_once():
    """bf16 base weights: the sum is taken in float32 and rounded to bf16
    once (the reference's ``astype`` order), checked against numpy."""
    cfg = tllama.tiny_llama()
    gen = torch.Generator().manual_seed(0)
    params = tllama.init_params(cfg, gen, "cpu")
    lora = tlora.init_lora_nonzero(cfg, gen, rank=2, alpha=4.0)
    merged = tlora.merge_lora(params, lora)
    base = params["layers"]["wq"].float().numpy()
    a, b = lora["wq"]["lora_a"].numpy(), lora["wq"]["lora_b"].numpy()
    want = base + np.einsum("lir,lro->lio", a, b) * 2.0
    got = merged["layers"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(want).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("rank,targets", [(4, jlora.DEFAULT_TARGETS),
                                          (8, ("wq", "w_gate", "w_down")),
                                          (16, ALL_TARGETS)])
def test_lora_param_count_matches_reference(models, rank, targets):
    jcfg, _, tcfg, _ = models
    gen = torch.Generator().manual_seed(rank)
    lora = tlora.init_lora(tcfg, gen, rank=rank, targets=targets)
    actual = sum(int(a["lora_a"].numel() + a["lora_b"].numel())
                 for a in lora.values())
    assert tlora.lora_param_count(tcfg, rank, targets) == actual == \
        jlora.lora_param_count(jcfg, rank, targets)


def test_init_lora_follows_the_reference_init(models):
    """A ~ normal / sqrt(in), B = 0, scaling alpha / rank per layer, all
    float32 (the reference's distributions; its draws come from
    jax.random, the port's from a torch.Generator). ``init_lora_nonzero``
    gives B a random factor of the requested scale, and repeats per
    seed."""
    _, _, tcfg, _ = models
    lora = tlora.init_lora(tcfg, torch.Generator().manual_seed(0), rank=8,
                           alpha=16.0)
    assert set(lora) == set(tlora.DEFAULT_TARGETS)
    for target, parts in lora.items():
        d_in, d_out = tlora._PROJ_DIMS[target](tcfg)
        assert parts["lora_a"].shape == (tcfg.n_layers, d_in, 8)
        assert parts["lora_b"].shape == (tcfg.n_layers, 8, d_out)
        assert all(t.dtype == torch.float32 for t in parts.values())
        assert not parts["lora_b"].any()
        assert torch.equal(parts["scaling"], torch.full((tcfg.n_layers,),
                                                        2.0))
        std = float(parts["lora_a"].std() * d_in ** 0.5)
        assert 0.9 < std < 1.1
    assert tlora.lora_rank(lora) == 8
    again = [tlora.init_lora_nonzero(tcfg, torch.Generator().manual_seed(5),
                                     rank=2, b_scale=0.01)
             for _ in range(2)]
    b = again[0]["wv"]["lora_b"]
    assert torch.equal(b, again[1]["wv"]["lora_b"])
    assert 0.005 < float(b.std()) < 0.02
    with pytest.raises(ValueError, match="unknown lora target"):
        tlora.init_lora(tcfg, torch.Generator(), targets=("nope",))
    with pytest.raises(tlora.LoraShapeError):
        tlora.lora_rank({})


# -- the serving delta --------------------------------------------------------

def _banks(jcfg, tcfg, targets, seeds=(1, 2)):
    """A three-slot bank (base + two adapters) in both packages."""
    jbank = JBank(jcfg, len(seeds), 4, targets)
    tbank = TBank(tcfg, len(seeds), 4, targets)
    for slot, seed in enumerate(seeds, start=1):
        adapter = _jadapter(jcfg, seed, targets)
        jbank.load_slot(slot, adapter)
        tbank.load_slot(slot, _convert(adapter))
    return jbank, tbank


@pytest.mark.parametrize("target", ALL_TARGETS)
def test_lora_delta_matches_reference(models, target):
    """``_lora_delta`` on a bank with three slots and mixed row ids (base
    rows give a zero delta) against the reference's; the forwards' fused
    form (``_proj`` over rows gathered once by ``_lora_rows``) against
    the reference's projection, the float32 base product plus that
    delta."""
    jcfg, jparams, tcfg, tparams = models
    jbank, tbank = _banks(jcfg, tcfg, ALL_TARGETS)
    d_in, _ = tlora._PROJ_DIMS[target](tcfg)
    h = np.random.default_rng(7).standard_normal((4, 3, d_in)).astype(
        np.float32)
    ids = np.array([2, 0, 1, 2], np.int32)
    rows = tllm._lora_rows(tbank.tensors, torch.from_numpy(ids))
    for layer in range(jcfg.n_layers):
        want = jllm._lora_delta(jnp.asarray(h), jbank.tensors[target], layer,
                                jnp.asarray(ids))
        got = tllm._lora_delta(torch.from_numpy(h), tbank.tensors[target],
                               layer, torch.from_numpy(ids))
        _close(want, got, MERGE_TOL)
        assert not got[1].any()
        w = jparams["layers"][target][layer]
        want_proj = jnp.einsum("bse,eh->bsh", jnp.asarray(h), w) + want
        got_proj = tllm._proj(torch.from_numpy(h),
                              tparams["layers"][target][layer], rows,
                              target, layer)
        _close(want_proj, got_proj,
               _proj_bound(h, w, np.asarray(want_proj)))


@pytest.mark.parametrize("prefix", ["cold", "prefix_hit"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_with_cache_lora_matches_reference(models, prefix, impl):
    """The prefill forward with a bank of all seven targets, two rows on
    different adapters (cold) or one adapted row whose 32-token prefix is
    attended in place in pool pages (the prefix-hit form), against the
    reference's logits; the adapted rows move their logits."""
    jcfg, jparams, tcfg, tparams = models
    jbank, tbank = _banks(jcfg, tcfg, ALL_TARGETS)
    rng = np.random.default_rng(11)
    if prefix == "cold":
        toks = rng.integers(1, 512, (2, 20)).astype(np.int32)
        ids = np.array([2, 1], np.int32)
        jlog, _ = jllm._forward_with_cache(
            jcfg, jparams, jnp.asarray(toks),
            jllm.init_kv_cache(jcfg, 2, MAX_LEN), lora=jbank.tensors,
            adapter_ids=jnp.asarray(ids), attn_impl=impl)
        tlog, _ = tllm._forward_with_cache(
            tcfg, tparams, torch.from_numpy(toks).long(),
            tllm.init_kv_cache(tcfg, 2, MAX_LEN, device="cpu"),
            lora=tbank.tensors, adapter_ids=torch.from_numpy(ids),
            attn_impl=impl)
        plain, _ = tllm._forward_with_cache(
            tcfg, tparams, torch.from_numpy(toks).long(),
            tllm.init_kv_cache(tcfg, 2, MAX_LEN, device="cpu"),
            attn_impl=impl)
    else:
        base, prompt = 32, rng.integers(1, 512, 40).astype(np.int32)
        ids = np.array([1], np.int32)
        page_ids = np.full((MAX_LEN // PAGE,), -1, np.int32)
        page_ids[:2] = [3, 1]
        # the prefix's KV under the same adapter, scattered into pages
        _, jsmall = jllm._forward_with_cache(
            jcfg, jparams, jnp.asarray(prompt[None, :base]),
            jllm.init_kv_cache(jcfg, 1, MAX_LEN), lora=jbank.tensors,
            adapter_ids=jnp.asarray(ids))
        jpool = jpaged.insert_prompt_pages(
            jpaged.init_paged_pool(jcfg, 9, PAGE), jsmall,
            jnp.asarray(page_ids), PAGE)
        tpool = tpaged.init_paged_pool(tcfg, 9, PAGE, device="cpu")
        for name in ("k", "v"):
            tpool[name].copy_(torch.from_numpy(np.array(jpool[name])))
        jcache = jllm.init_kv_cache(jcfg, 1, MAX_LEN)
        jcache["pos"] = jnp.full((1,), base, jnp.int32)
        jlog, _ = jllm._forward_with_cache(
            jcfg, jparams, jnp.asarray(prompt[None, base:]), jcache,
            lora=jbank.tensors, adapter_ids=jnp.asarray(ids),
            prefix_kv={"k": jpool["k"], "v": jpool["v"],
                       "page_ids": jnp.asarray(page_ids),
                       "base": jnp.int32(base)},
            attn_impl=impl, page_size=PAGE)

        def port(lora_kw):
            cache = tllm.init_kv_cache(tcfg, 1, MAX_LEN, device="cpu")
            cache["pos"].fill_(base)
            return tllm._forward_with_cache(
                tcfg, tparams, torch.from_numpy(prompt[None, base:]).long(),
                cache, prefix_kv={"k": tpool["k"], "v": tpool["v"],
                                  "page_ids": torch.from_numpy(page_ids),
                                  "base": base},
                attn_impl=impl, page_size=PAGE, **lora_kw)[0]

        tlog = port({"lora": tbank.tensors,
                     "adapter_ids": torch.from_numpy(ids)})
        plain = port({})
    _close(jlog, tlog, LOGIT_TOL)
    assert float((tlog - plain).abs().max()) > 100 * LOGIT_TOL


def test_base_rows_of_a_bank_match_the_plain_forward(models):
    """Slot-0 rows on a bank take the float32-product form and equal the
    plain forward's logits within float32 rounding (bits may differ by
    the products' accumulation)."""
    _, _, tcfg, tparams = models
    tbank = TBank(tcfg, 1, 2, ("wq",))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, 512, (1, 12))).long()
    with_bank, _ = tllm._forward_with_cache(
        tcfg, tparams, toks, tllm.init_kv_cache(tcfg, 1, MAX_LEN,
                                                device="cpu"),
        lora=tbank.tensors, adapter_ids=torch.zeros(1, dtype=torch.int32))
    plain, _ = tllm._forward_with_cache(
        tcfg, tparams, toks, tllm.init_kv_cache(tcfg, 1, MAX_LEN,
                                                device="cpu"))
    assert float((with_bank - plain).abs().max()) <= LOGIT_TOL


# -- LoRA training ------------------------------------------------------------

def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("remat", [False, True])
def test_lora_loss_and_grads_match_reference(models, chunk, remat):
    """``loss_fn(lora=)`` on a frozen base: the loss and every adapter
    leaf's gradient (scaling included, as the reference trains it)
    against ``jax.grad`` over the adapter; per-layer checkpointing must
    see the adapter's factors as inputs, so remat changes nothing."""
    import dataclasses

    jcfg, jparams, tcfg, tparams = models
    tcfg = dataclasses.replace(tcfg, remat=remat)
    jl = _jadapter(jcfg, 4, ALL_TARGETS)
    tokens, targets = _tokens((2, 24), 5), _tokens((2, 24), 6)

    def jloss(lora):
        return jllama.loss_fn(jcfg, jparams, jnp.asarray(tokens),
                              jnp.asarray(targets), lora=lora,
                              loss_chunk=chunk)

    (jv, _), jg = jax.value_and_grad(jloss, has_aux=True)(jl)
    tl = ttrain.tree_map(lambda t: t.requires_grad_(True), _convert(jl))
    tv, _ = tllama.loss_fn(tcfg, tparams, torch.from_numpy(tokens),
                           torch.from_numpy(targets), loss_chunk=chunk,
                           lora=tl)
    tv.backward()
    assert abs(float(jv) - float(tv.detach())) <= GRAD_TOL
    _trees_close(jax.tree.map(np.asarray, jg),
                 ttrain.tree_map(lambda t: t.grad, tl), GRAD_TOL)
    assert all(p.grad is None for p in ttrain.tree_leaves(tparams))


def _train_cfg(cls, **kw):
    base = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                weight_decay=0.1, lora_rank=4, lora_alpha=8.0)
    base.update(kw)
    return cls(**base)


def test_lora_trainer_matches_reference_trainer():
    """Five LoRA steps of the port's Trainer from the reference's
    converted params and adapter init, on the same batches, against the
    JAX Trainer: per-step loss and grad_norm, and the final adapter. The
    base params stay bit-identical and B moves off zero."""
    from mlrun_tpu.training import Trainer as JTrainer

    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jt = JTrainer(jcfg, _train_cfg(jtrain.TrainConfig,
                                   mesh_shape={"fsdp": 1}))
    jt.init(0)
    params = _convert(jt.state.params)
    before = [leaf.clone() for leaf in ttrain.tree_leaves(params)]
    tt = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                        _train_cfg(ttrain.TrainConfig), device="cpu")
    tt.init(params=params, lora=_convert(jt.state.lora))
    jt.fit(jdata.synthetic_token_stream(4, 32, 512, seed=1), 5, log_every=1,
           prefetch=0, defer_metrics=False)
    tt.fit(tdata.synthetic_token_stream(4, 32, 512, seed=1), 5, log_every=1,
           prefetch=0, defer_metrics=False)
    assert len(tt.metrics_history) == 5
    for jm, tm in zip(jt.metrics_history, tt.metrics_history):
        for key in ("loss", "grad_norm"):
            assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * abs(jm[key]), key
    _trees_close(jax.tree.map(np.asarray, jt.state.lora),
                 params_to_numpy(tt.state.lora), PARAM_TOL)
    after = ttrain.tree_leaves(tt.state.params)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not any(leaf.requires_grad for leaf in after)
    assert float(tt.state.lora["wq"]["lora_b"].detach().abs().max()) > 0
    assert tt.state.opt_state.count == 5
    assert ttrain.tree_leaves(tt.state.opt_state.mu)[0].shape == \
        ttrain.tree_leaves(tt.state.lora)[0].shape


def test_lora_checkpoint_round_trip(tmp_path):
    """A LoRA state saves and restores its adapter and moments; the
    restored adapter requires grad, the base does not."""
    from mlrun_tpu_torch.training import CheckpointManager

    trainer = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                             _train_cfg(ttrain.TrainConfig), device="cpu")
    trainer.init(0)
    trainer.fit(tdata.synthetic_token_stream(2, 8, 512, seed=4), 2,
                log_every=1, prefetch=0)
    manager = CheckpointManager(str(tmp_path / "ck"))
    manager.save(2, trainer.state)
    fresh = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                           _train_cfg(ttrain.TrainConfig), device="cpu")
    fresh.init(1)
    restored = manager.restore(fresh.state)
    assert restored.step == 2 and restored.opt_state.count == 2
    _trees_close(params_to_numpy(trainer.state.lora), restored.lora, 0.0)
    _trees_close(params_to_numpy(trainer.state.opt_state.mu),
                 restored.opt_state.mu, 0.0)
    assert all(leaf.requires_grad
               for leaf in ttrain.tree_leaves(restored.lora))
    assert not any(leaf.requires_grad
                   for leaf in ttrain.tree_leaves(restored.params))
    fresh.state = restored
    fresh.fit(tdata.synthetic_token_stream(2, 8, 512, seed=5), 1,
              log_every=1, prefetch=0)
    assert fresh.state.step == 3


def test_auto_trainer_trains_lora(tmp_path):
    """``auto_trainer.train(lora_rank=...)`` runs a LoRA fine-tune end to
    end and checkpoints the adapter."""
    from mlrun_tpu_torch.frameworks.torch import auto_trainer
    from mlrun_tpu_torch.training import CheckpointManager

    metrics = auto_trainer.train(model="tiny", steps=3, batch_size=2,
                                 seq_len=16, lora_rank=2, lora_alpha=4.0,
                                 log_every=1, device="cpu",
                                 checkpoint_dir=str(tmp_path / "ck"))
    assert metrics["step"] == 3.0 and np.isfinite(metrics["loss"])
    manager = CheckpointManager(str(tmp_path / "ck"))
    tree = torch.load(tmp_path / "ck" / "3" / "state.pt", weights_only=False)
    assert manager.latest_step() == 3
    assert tree["lora"]["wq"]["lora_a"].shape[-1] == 2
