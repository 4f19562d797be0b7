"""The plain reference against the port's outputs at tiny sizes on the
CPU, in float32: the dense forward, the served tokens of the paged engine
(the reference's cache-free decode), the MoE loss and gradients with
capacity drops."""

import numpy as np
import pytest
import torch

import models
from reference import dense, moe


def _dense_config():
    return {"name": "t", "family": "dense", "vocab_size": 512,
            "num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "intermediate_size": 128, "rope_theta": 1e6,
            "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
            "torch_dtype": "float32"}


def test_dense_logits_match_the_port():
    from mlrun_tpu_torch.models import llama

    conf = _dense_config()
    s = models.sizes(conf)
    params = models.make_params(s, 3, "cpu")
    tokens = torch.randint(0, 512, (1, 300), generator=torch.Generator()
                           .manual_seed(0))
    port = llama.forward(models.port_config(conf), params, tokens)[0]
    ref = dense.logits(s, params, tokens[0].tolist(), list(range(300)))
    assert torch.allclose(port, ref, atol=2e-4, rtol=1e-4)


def test_paged_engine_tokens_have_no_gap_under_the_reference():
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    conf = _dense_config()
    s = models.sizes(conf)
    params = models.make_params(s, 4, "cpu")
    engine = PagedContinuousBatchingEngine(
        models.port_config(conf), params, max_len=512, slots=4,
        page_size=16, device="cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 64).tolist()
    prompts = [shared + rng.integers(0, 512, n).tolist()
               for n in (20, 70, 5)] + [rng.integers(0, 512, 90).tolist()]
    try:
        # the first warms the prefix cache, the rest hit it or miss
        outs = [engine.generate(prompts[0], 24)]
        outs += [f.result(timeout=120) for f in
                 [engine.submit(p, 24) for p in prompts[1:]]]
        assert engine.stats["prefix_hits"] >= 2
    finally:
        engine.stop()
    for prompt, (tokens, _) in zip(prompts, outs):
        got = dense.served_gaps(s, params, prompt, tokens)
        assert got["tokens"] == 24
        assert got["max_gap"] < 1e-4


@pytest.mark.parametrize("capacity", [1.25, 0.5])
def test_moe_loss_and_gradients_match_the_port(capacity):
    from mlrun_tpu_torch.models import moe as port_moe

    conf = dict(_dense_config(), family="moe", intermediate_size=96,
                num_local_experts=4, num_experts_per_tok=2,
                router_aux_loss_coef=0.02,
                departures={"moe_capacity_factor": capacity})
    s = models.sizes(conf)
    params = models.make_params(s, 5, "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 512, (2, 64), generator=gen)
    targets = torch.randint(0, 512, (2, 64), generator=gen)
    leaves = {k: v.requires_grad_(True) for k, v in _flat(params).items()}
    cfg = models.port_config(conf, remat=False)
    loss, _ = port_moe.loss_fn(cfg, params, tokens, targets, loss_chunk=32)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    ref_p = {k: v.detach().clone().requires_grad_(True)
             for k, v in leaves.items()}
    ref_loss = moe.loss(s, ref_p, tokens, targets)
    ref_grads = torch.autograd.grad(ref_loss, list(ref_p.values()))
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 1e-5
    for key, g, r in zip(leaves, grads, ref_grads):
        assert torch.allclose(g, r, atol=1e-6, rtol=1e-4), key
    if capacity < 1:
        h = torch.randn(128, 64, generator=gen)
        _, _, keep, _ = moe.route(s, h, params["layers"]["router"][0]
                                  .detach(), 64)
        assert not bool(keep.all())


def test_bf16_witness_rounds_operands_and_gradients():
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(4, 8, generator=gen, requires_grad=True)
    b = torch.randn(8, 5, generator=gen)
    out = dense.matmul(a, b, "bf16")
    want = (a.detach().bfloat16().float() @ b.bfloat16().float())
    assert torch.equal(out, want.bfloat16().float())
    out.backward(torch.full_like(out, 1.0 + 2 ** -12))
    assert torch.equal(a.grad, (torch.ones(4, 5) @ b.bfloat16().float().T)
                       .bfloat16().float())


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 1.125, 448.0]])
    got = dense.fp8_round(x, -1)
    assert got.tolist() == [[1.0, 1.0, 1.125, 448.0]]


def _flat(params, prefix=""):
    out = {}
    for key in sorted(params):
        value = params[key]
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out
