"""The port's HuggingFace adapter (mlrun_tpu_torch.frameworks.huggingface)
against the JAX package's on the CPU: checkpoints written by
``transformers`` into ``tmp_path`` (nothing is downloaded), loaded by
both packages' ``load_hf_weights_into_llama``; ``LLMModelServer(hf_model=)``
on both; ``HuggingFaceModelServer`` on a tiny local pipeline model.

Bounds:
- loaded leaves bit-equal (float32 and the default bf16, compared as
  16/32-bit patterns), config fields equal;
- the port's forward against the HF model at the reference test's bound
  (``tests/test_frameworks.py``: same argmax, max abs logit gap < 2e-2);
- greedy tokens equal, after a top-2 margin above 1e-3 at every step.

The reference reads safetensors through ``safe_open(framework="np")``;
the port parses the format itself (no ``safetensors`` or ``ml_dtypes``
needed), BF16 included.
"""

import dataclasses
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from mlrun_tpu.frameworks import huggingface as jhf
from mlrun_tpu_torch.frameworks import huggingface as thf
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.serving import llm as tllm
from tests.torch_registries import registries_left_as_found  # noqa: F401

CONFIG_FIELDS = ("vocab_size", "n_layers", "embed_dim", "n_heads",
                 "n_kv_heads", "head_dim", "mlp_dim", "rope_theta",
                 "norm_eps", "tie_embeddings")
LOGIT_TOL = 2e-2
MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """Every path in this module is local: make any hub lookup fail fast
    instead of reaching for the network."""
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as tf_hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(tf_hub, "_is_offline_mode", True)


def _hf_model(tie=False, seed=0):
    config = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=tie,
        rope_theta=500000.0, rms_norm_eps=1e-5,
        # wider than HF's 0.02 draw: logits far enough apart that greedy
        # streams hold no near-ties
        initializer_range=0.2)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(config).eval()


def _save(model, directory, layout):
    if layout == "sharded":
        model.save_pretrained(directory, max_shard_size="100KB")
        assert os.path.exists(os.path.join(directory,
                                           "model.safetensors.index.json"))
    elif layout == "single":
        model.save_pretrained(directory)
        assert os.path.exists(os.path.join(directory, "model.safetensors"))
    else:
        model.save_pretrained(directory, safe_serialization=False)
        assert any(name.startswith("pytorch_model")
                   for name in os.listdir(directory))
    return str(directory)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    else:
        yield prefix.rstrip("."), tree


def _bits(array) -> np.ndarray:
    """A leaf's raw bit patterns (uint16 for bf16, uint32 for float32)."""
    if isinstance(array, torch.Tensor):
        array = array.detach()
        if array.dtype == torch.bfloat16:
            return array.view(torch.int16).numpy().view(np.uint16)
        return array.numpy().view(np.uint32)
    array = np.asarray(array)
    return array.view(np.uint16 if array.dtype.itemsize == 2
                      else np.uint32)


def _assert_bit_equal(jparams, tparams):
    jl, tl = dict(_leaves(jparams)), dict(_leaves(tparams))
    assert jl.keys() == tl.keys()
    for key, value in jl.items():
        want, got = _bits(value), _bits(tl[key])
        assert want.shape == got.shape, key
        assert np.array_equal(want, got), key


def _assert_configs_equal(jcfg, tcfg):
    for field in CONFIG_FIELDS:
        assert getattr(jcfg, field) == getattr(tcfg, field), field


@pytest.mark.parametrize("layout,tie", [("sharded", False), ("single", False),
                                        ("bin", False), ("sharded", True),
                                        ("single", True)])
@pytest.mark.parametrize("precision", ["float32", "bf16"])
def test_loader_matches_reference_bit_for_bit(tmp_path, monkeypatch, layout,
                                              tie, precision):
    """Each checkpoint layout, tied and untied: the config and every leaf
    as the reference loads them, and the torch model is never built."""
    directory = _save(_hf_model(tie), tmp_path, layout)
    monkeypatch.setattr(
        transformers.AutoModelForCausalLM, "from_pretrained",
        lambda *a, **k: (_ for _ in ()).throw(AssertionError(
            "the loader must stream, not instantiate the torch model")))
    jdtype = jnp.float32 if precision == "float32" else None
    tdtype = torch.float32 if precision == "float32" else None
    jcfg, jparams = jhf.load_hf_weights_into_llama(directory, dtype=jdtype)
    tcfg, tparams = thf.load_hf_weights_into_llama(directory, dtype=tdtype,
                                                   device="cpu")
    _assert_configs_equal(jcfg, tcfg)
    assert ("lm_head" in tparams) is (not tie)
    want_dtype = torch.float32 if tdtype else torch.bfloat16
    assert all(leaf.dtype == want_dtype and leaf.device.type == "cpu"
               for _, leaf in _leaves(tparams))
    _assert_bit_equal(jparams, tparams)


def test_missing_config_fields_take_autoconfig_defaults(tmp_path):
    """A config.json without rope_theta / rms_norm_eps / num_key_value_heads
    / head_dim / tie_word_embeddings gives AutoConfig's Llama defaults in
    both packages: 10000.0 and 1e-6, not the Llama-3 values."""
    directory = _save(_hf_model(), tmp_path, "single")
    path = os.path.join(directory, "config.json")
    with open(path) as fp:
        raw = json.load(fp)
    for key in ("rope_theta", "rms_norm_eps", "num_key_value_heads",
                "head_dim", "tie_word_embeddings"):
        raw.pop(key, None)
    with open(path, "w") as fp:
        json.dump(raw, fp)
    jcfg, _ = jhf.load_hf_weights_into_llama(directory)
    tcfg = thf.llama_config_from_hf(directory)
    _assert_configs_equal(jcfg, tcfg)
    assert (tcfg.rope_theta, tcfg.norm_eps) == (10000.0, 1e-6)
    assert tcfg.n_kv_heads == tcfg.n_heads == 4
    assert tcfg.head_dim == 16 and tcfg.tie_embeddings is False


def test_safetensors_reader_matches_the_safetensors_package(tmp_path):
    """F32, F16 and BF16 tensors (and an empty one) read bit for bit as
    ``safetensors.torch.load_file`` reads them; an unsupported dtype
    raises with its name."""
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(3)
    tensors = {
        "f32": torch.randn(5, 7, generator=gen),
        "f16": torch.randn(3, 4, 2, generator=gen).half(),
        "bf16": torch.randn(11, generator=gen).bfloat16(),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want = load_file(path)
    reader = thf.SafetensorsFile(path)
    assert sorted(reader.keys()) == sorted(want)
    for name, tensor in want.items():
        got = reader.get(name)
        assert got.dtype == tensor.dtype and got.shape == tensor.shape
        assert got.reshape(-1).view(torch.uint8).equal(
            tensor.reshape(-1).view(torch.uint8)), name
    save_file({"ids": torch.arange(4, dtype=torch.int64)},
              str(tmp_path / "i.safetensors"))
    with pytest.raises(TypeError, match="I64"):
        thf.SafetensorsFile(str(tmp_path / "i.safetensors")).get("ids")


def test_bf16_checkpoint_loads_bit_equal_in_both_packages(tmp_path):
    """A BF16 safetensors checkpoint (as real Llama-3 checkpoints are):
    each of the port's leaves is the HF weight's bits transposed to
    ``[in, out]``, and the reference loads the same bits (its numpy reader
    understands bfloat16 once ``ml_dtypes`` is imported, which its loader
    does through ``import jax``)."""
    model = _hf_model().to(torch.bfloat16)
    directory = _save(model, tmp_path, "single")
    _, params = thf.load_hf_weights_into_llama(directory, device="cpu")
    state = model.state_dict()
    pairs = [(params["embedding"], state["model.embed_tokens.weight"]),
             (params["lm_head"], state["lm_head.weight"].t()),
             (params["final_norm_scale"], state["model.norm.weight"])]
    for i in range(2):
        pairs += [
            (params["layers"]["wq"][i],
             state[f"model.layers.{i}.self_attn.q_proj.weight"].t()),
            (params["layers"]["w_down"][i],
             state[f"model.layers.{i}.mlp.down_proj.weight"].t()),
            (params["layers"]["attn_norm_scale"][i],
             state[f"model.layers.{i}.input_layernorm.weight"])]
    for got, want in pairs:
        assert np.array_equal(_bits(got), _bits(want.contiguous()))
    _, jparams = jhf.load_hf_weights_into_llama(directory)
    _assert_bit_equal(jparams, params)


def test_shardings_need_many_devices_and_the_device_defaults_to_cuda(
        tmp_path):
    """``shardings=`` (the port's ``tree_shardings`` placements) places
    every leaf as a DTensor as it is read: on a size-1 mesh each one
    holds the device load's bits (several ranks: the gloo test in
    tests/test_torch_sharded_steps.py); a node of None keeps its leaf
    plain. Without a card the default device raises."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mlrun_tpu_torch.parallel.mesh import make_mesh
    from mlrun_tpu_torch.parallel.sharding import tree_shardings

    directory = _save(_hf_model(), tmp_path, "single")
    existed = dist.is_initialized()
    try:
        _, plain = thf.load_hf_weights_into_llama(directory, device="cpu")
        shardings = tree_shardings(plain, make_mesh({"fsdp": 1}, "cpu"))
        shardings["embedding"] = None
        _, placed = thf.load_hf_weights_into_llama(
            directory, device="cpu", shardings=shardings)
    finally:
        if dist.is_initialized() and not existed:
            dist.destroy_process_group()
    assert not isinstance(placed["embedding"], DTensor)
    assert isinstance(placed["layers"]["wq"], DTensor)
    for (name, a), (_, b) in zip(_leaves(placed), _leaves(plain)):
        a = a.to_local() if isinstance(a, DTensor) else a
        assert torch.equal(a, b), name
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thf.load_hf_weights_into_llama(directory)


def test_port_forward_matches_the_hf_model(tmp_path):
    """The reference test's forward parity on the port: the loaded params
    in float32 through ``models.llama.forward`` against the HF model."""
    model = _hf_model()
    directory = _save(model, tmp_path, "sharded")
    config, params = thf.load_hf_weights_into_llama(
        directory, dtype=torch.float32, device="cpu")
    config = dataclasses.replace(config, dtype=torch.float32,
                                 attention_impl="reference", remat=False)
    tokens = np.array([[1, 5, 9, 12, 77, 3]], dtype=np.int64)
    with torch.no_grad():
        ours = tllama.forward(config, params, torch.from_numpy(tokens))
        theirs = model(torch.from_numpy(tokens)).logits
    assert torch.equal(ours.argmax(-1), theirs.argmax(-1))
    assert float((ours - theirs).abs().max()) < LOGIT_TOL


# -- LLMModelServer(hf_model=) -------------------------------------------------

class _Event:
    def __init__(self, body, path="/v2/models/m/infer"):
        self.body = body
        self.path = path


def _float32_loaders(monkeypatch):
    """Both packages' servers load the checkpoint through their own
    loader, in float32 (plain attention on the reference), so greedy
    tokens compare without bf16 rounding; returns the device each port
    load was asked for."""
    jload, tload = (jhf.load_hf_weights_into_llama,
                    thf.load_hf_weights_into_llama)
    devices = []

    def jax_f32(path, **kw):
        config, params = jload(path, dtype=jnp.float32)
        return dataclasses.replace(config, dtype=jnp.float32,
                                   attention_impl="reference"), params

    def port_f32(path, device=None, **kw):
        devices.append(str(device))
        config, params = tload(path, dtype=torch.float32, device=device)
        return dataclasses.replace(config, dtype=torch.float32), params

    monkeypatch.setattr(jhf, "load_hf_weights_into_llama", jax_f32)
    monkeypatch.setattr(thf, "load_hf_weights_into_llama", port_f32)
    return devices


def _min_margin(config, params, prompt, generated) -> float:
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    with torch.no_grad():
        logits = tllama.forward(config, params, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


@pytest.mark.parametrize("engine", [
    {"continuous_batching": True},
    {"continuous_batching": True, "paged": True, "page_size": 8},
])
def test_hf_model_server_greedy_matches_reference(tmp_path, monkeypatch,
                                                  engine):
    from mlrun_tpu.serving.llm import LLMModelServer as JServer

    directory = _save(_hf_model(), tmp_path, "sharded")
    devices = _float32_loaders(monkeypatch)
    common = dict(name="m", hf_model=directory, max_len=64,
                  max_new_tokens=6, warmup=False, **engine)
    jserver = JServer(**common)
    tserver = tllm.LLMModelServer(device="cpu", **common)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, n).tolist() for n in (9, 20, 4)]
    try:
        jserver.post_init()
        tserver.post_init()
        assert jserver.ready and tserver.ready, tserver.error
        want = jserver.do_event(_Event({"inputs": prompts})).body["outputs"]
        got = tserver.do_event(_Event({"inputs": prompts})).body["outputs"]
        config, params = tserver.engine.config, tserver.engine.params
    finally:
        for server in (jserver, tserver):
            if server.engine is not None:
                server.engine.stop()
    assert devices == ["cpu"]
    assert config.vocab_size == 128 and config.rope_theta == 500000.0
    _assert_bit_equal(jhf.load_hf_weights_into_llama(directory)[1], params)
    for prompt, tokens in zip(prompts, want):
        assert _min_margin(config, params, prompt, tokens) > MARGIN
    assert got == want
    assert [len(t) for t in got] == [6, 6, 6]


def test_hf_model_server_loads_the_checkpoint_as_the_reference(tmp_path):
    """Unpatched: the server's load reads the checkpoint through the
    port's loader onto its device in the default bf16, every engine leaf
    bit-equal to the reference loader's, and serves it."""
    directory = _save(_hf_model(tie=True), tmp_path, "sharded")
    server = tllm.LLMModelServer(
        name="m", hf_model=directory, continuous_batching=True, paged=True,
        max_len=64, page_size=8, max_new_tokens=3, warmup=False,
        device="cpu")
    try:
        server.post_init()
        assert server.ready, server.error
        out = server.do_event(_Event({"inputs": [[5, 9, 2, 77]]}))
        engine = server.engine
    finally:
        server.close()
    jcfg, jparams = jhf.load_hf_weights_into_llama(directory)
    _assert_configs_equal(jcfg, engine.config)
    assert engine.config.dtype == torch.bfloat16
    _assert_bit_equal(jparams, engine.params)
    tokens = out.body["outputs"][0]
    assert len(tokens) == 3 and all(0 <= t < 128 for t in tokens)


# -- HuggingFaceModelServer ----------------------------------------------------

def _pipeline_dir(tmp_path) -> str:
    """A tiny text-classification model and its tokenizer, saved together
    (``tokenizers``-built word-level vocabulary, random BERT weights)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["[UNK]", "[PAD]", "good", "bad", "movie", "plot", "very",
             "dull", "great", "the"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]")
    torch.manual_seed(1)
    model = transformers.BertForSequenceClassification(
        transformers.BertConfig(vocab_size=len(words), hidden_size=16,
                                num_hidden_layers=1, num_attention_heads=2,
                                intermediate_size=32, num_labels=2,
                                max_position_embeddings=32))
    directory = str(tmp_path / "clf")
    model.save_pretrained(directory)
    fast.save_pretrained(directory)
    return directory


def test_huggingface_model_server_matches_reference(tmp_path):
    directory = _pipeline_dir(tmp_path)
    body = {"inputs": ["good movie", "the plot very dull", "great"]}
    outputs = []
    for cls, kw in ((jhf.HuggingFaceModelServer, {}),
                    (thf.HuggingFaceModelServer, {"device": "cpu"})):
        server = cls(name="clf", task="text-classification",
                     model_name=directory, **kw)
        server.post_init()
        assert server.ready, server.error
        outputs.append(server.do_event(_Event(dict(body))).body["outputs"])
    want, got = outputs
    assert len(got) == 3 and got == want
    assert all(row[0]["label"] in ("LABEL_0", "LABEL_1") for row in got)


def test_huggingface_model_server_runs_on_cuda_by_default(tmp_path,
                                                          monkeypatch):
    """Its pipeline is built on the GPU unless the caller asks for the
    CPU, and without a card the server refuses to start."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thf.HuggingFaceModelServer(name="clf", model_name=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = {}
    fake = types.ModuleType("transformers")
    fake.pipeline = lambda task, **kw: built.update(task=task, **kw)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    server = thf.HuggingFaceModelServer(name="clf",
                                        model_name=str(tmp_path))
    server.load()
    assert built["device"] == torch.device("cuda")
    assert built["model"] == str(tmp_path)
