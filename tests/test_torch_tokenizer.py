"""Tokenizers on the port's two main paths against the JAX package on the
CPU: ``LLMModelServer(tokenizer=)`` string inputs (encoded, served,
decoded), ``training.data.text_file_stream`` and ``auto_trainer.train(
dataset=<text file>, tokenizer=<dir>)``. The tokenizer is built with
``tokenizers`` (a word-level vocabulary ``w0``..``w511`` covering the
tiny preset's 512 ids, so every generated id decodes and re-encodes) and
saved into ``tmp_path`` as a ``PreTrainedTokenizerFast``; nothing is
downloaded.

Bounds: greedy tokens and decoded strings equal (after a top-2 margin
above 1e-3 at every step); stream batches bit-equal; a 3-step training
run's per-step loss and grad_norm within 1e-4 relative (the bound of
``tests/test_torch_training.py``).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.frameworks.jax import auto_trainer as jauto
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.training import data as jdata
from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain

VOCAB = 512
MARGIN = 1e-3
RUN_REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """Every tokenizer here is a local directory: any hub lookup fails
    fast instead of reaching for the network."""
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as tf_hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(tf_hub, "_is_offline_mode", True)


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory) -> str:
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({f"w{i}": i for i in range(VOCAB)},
                                     unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    directory = str(tmp_path_factory.mktemp("tok"))
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="w0").save_pretrained(directory)
    return directory


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    return jcfg, tcfg, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu")


def _text(seed: int, n: int) -> str:
    ids = np.random.default_rng(seed).integers(1, VOCAB, n)
    return " ".join(f"w{i}" for i in ids)


class _Event:
    def __init__(self, body, path="/v2/models/m/infer"):
        self.body = body
        self.path = path


def _servers(models, monkeypatch, **kwargs):
    """Both packages' servers on the tiny preset in float32 with the same
    weights (the port's draw replaced by the converted reference
    params)."""
    from mlrun_tpu.serving.llm import LLMModelServer as JServer

    jcfg, tcfg, tparams = models
    monkeypatch.setitem(jauto.MODEL_PRESETS, "tiny", lambda: jcfg)
    monkeypatch.setitem(tllama.MODEL_PRESETS, "tiny", lambda: tcfg)
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, generator, device: tparams)
    common = dict(name="m", model_preset="tiny", max_len=128,
                  max_new_tokens=6, warmup=False, **kwargs)
    return JServer(**common), tllm.LLMModelServer(device="cpu", **common)


def _stop(*servers):
    for server in servers:
        if server.engine is not None and server.continuous_batching:
            server.engine.stop()


def _min_margin(tcfg, tparams, prompt, generated) -> float:
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    with torch.no_grad():
        logits = tllama.forward(tcfg, tparams, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


@pytest.mark.parametrize("engine", [
    {},
    {"continuous_batching": True, "paged": True, "page_size": 8},
])
def test_string_inputs_match_reference(models, monkeypatch, tokenizer_dir,
                                       engine):
    """String inputs, alone and mixed with token-id inputs: each string is
    encoded by the tokenizer and its output decoded to a string; id
    inputs come back as ids; both as the reference serves them."""
    jserver, tserver = _servers(models, monkeypatch, tokenizer=tokenizer_dir,
                                **engine)
    strings = [_text(1, 12), _text(2, 30)]
    mixed = [_text(3, 7), np.random.default_rng(4).integers(
        1, VOCAB, 9).tolist(), _text(5, 20)]
    try:
        want = [jserver.do_event(_Event({"inputs": body})).body["outputs"]
                for body in (strings, mixed)]
        got = [tserver.do_event(_Event({"inputs": body})).body["outputs"]
               for body in (strings, mixed)]
    finally:
        _stop(jserver, tserver)
    _, tcfg, tparams = models
    tok = tserver._tokenizer
    for body, outs in zip((strings, mixed), want):
        for item, out in zip(body, outs):
            prompt = tok(item)["input_ids"] if isinstance(item, str) \
                else item
            tokens = tok(out)["input_ids"] if isinstance(out, str) else out
            assert len(tokens) == 6
            assert _min_margin(tcfg, tparams, prompt, tokens) > MARGIN
    assert got == want
    assert [type(o) for o in got[1]] == [str, list, str]


def test_string_without_tokenizer_raises_like_reference(models, monkeypatch):
    jserver, tserver = _servers(models, monkeypatch)
    messages = []
    try:
        for server in (jserver, tserver):
            with pytest.raises(ValueError) as err:
                server.do_event(_Event({"inputs": ["w1 w2 w3"]}))
            messages.append(str(err.value))
    finally:
        _stop(jserver, tserver)
    assert messages[0] == messages[1] == \
        "string inputs need a tokenizer= class arg"


def _text_file(tmp_path, n=400) -> str:
    path = tmp_path / "corpus.txt"
    path.write_text(_text(7, n))
    return str(path)


def test_text_file_stream_matches_reference(tmp_path, tokenizer_dir):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer_dir)
    path = _text_file(tmp_path)
    js = jdata.text_file_stream(path, tok, 3, 16, seed=2)
    ts = tdata.text_file_stream(path, tok, 3, 16, seed=2)
    for _ in range(12):
        for a, b in zip(next(js), next(ts)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


class _Context:
    """A duck-typed run context that records what a run logs."""

    def __init__(self):
        self.metrics, self.results = [], {}

    def log_metrics(self, metrics, step=None):
        self.metrics.append(dict(metrics))

    def log_result(self, key, value):
        self.results[key] = value

    def log_results(self, results):
        self.results.update(results)

    def is_logging_worker(self):
        return True


def _same_init(monkeypatch):
    """The port's Trainer starts from the reference Trainer's init on a
    one-device mesh (tiny, float32, seed 0)."""
    from mlrun_tpu.training import TrainConfig as JTrainConfig
    from mlrun_tpu.training import Trainer as JTrainer

    jt = JTrainer(jllama.tiny_llama(dtype=jnp.float32,
                                    attention_impl="reference"),
                  JTrainConfig(mesh_shape={"fsdp": 1}))
    jt.init(0)
    init = jax.tree.map(np.asarray, jt.state.params)
    original = ttrain.Trainer.init

    def init_from_reference(self, seed=0, params=None, lora=None):
        return original(self, seed, params=params_from_numpy(init, "cpu"))

    monkeypatch.setattr(ttrain.Trainer, "init", init_from_reference)


def test_train_on_a_text_file_matches_reference(tmp_path, monkeypatch,
                                                tokenizer_dir):
    path = _text_file(tmp_path)
    _same_init(monkeypatch)
    common = dict(model="tiny", dataset=path, tokenizer=tokenizer_dir,
                  batch_size=2, seq_len=16, steps=3, log_every=1,
                  learning_rate=1e-2, mesh_shape={"fsdp": 1})
    jctx, tctx = _Context(), _Context()
    ref = jauto.train(context=jctx, model_overrides={
        "dtype": jnp.float32, "attention_impl": "reference"}, **common)
    ours = tauto.train(context=tctx, model_overrides={"dtype": torch.float32},
                       device="cpu", **common)
    assert set(ours) == set(ref) and ours["step"] == 3.0
    assert [m["step"] for m in tctx.metrics] == [1, 2, 3]
    for jm, tm in zip(jctx.metrics, tctx.metrics):
        for key in ("loss", "grad_norm"):
            assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * abs(jm[key]), key


def test_text_dataset_needs_a_tokenizer_in_both(tmp_path):
    path = _text_file(tmp_path)
    for train, kw in ((jauto.train, {}), (tauto.train, {"device": "cpu"})):
        with pytest.raises(ValueError, match="need a tokenizer= id"):
            train(model="tiny", dataset=path, batch_size=2, seq_len=16,
                  steps=1, mesh_shape={"fsdp": 1}, **kw)


def test_dataset_url_is_not_ported(tmp_path, monkeypatch):
    """Fault 3.4: a datastore url never reaches ``np.load`` as a path.
    Since item 10's entry 5 it resolves through the port's datastore: a
    ``file://`` url trains exactly like its bare path, and an ``s3://``
    url reaches the fsspec object store (item 10's tail), whose read
    needs ``s3fs`` (hidden here: nothing is fetched)."""
    path = tmp_path / "tokens.npy"
    np.save(path, np.arange(400, dtype=np.int32))
    runs = [tauto.train(model="tiny", dataset=dataset, batch_size=2,
                        seq_len=16, steps=1, device="cpu", warmup=False)
            for dataset in (str(path), f"file://{path}")]
    assert runs[0]["loss"] == runs[1]["loss"]
    monkeypatch.setitem(sys.modules, "s3fs", None)
    with pytest.raises(ImportError, match="s3fs"):
        tauto.train(model="tiny", dataset="s3://bucket/tokens.npy",
                    batch_size=2, seq_len=16, steps=1, device="cpu",
                    warmup=False)
