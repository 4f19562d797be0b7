"""The port's datastore urls (mlrun_tpu_torch.datastore, item 10's entry
5) against the JAX package's: the ``file://`` and ``memory://`` stores on
the same files, a ``file://`` tokens dataset through ``train``, adapters
over ``file://`` urls across the two packages, ``get_model`` (a
``store://`` uri through the run db among them), and the object stores
the port refuses (ROADMAP.md item 10's tail).

Tolerances: the ``train`` losses at the port's ``RUN_REL_TOL`` 1e-4
relative (tests/test_torch_training.py); everything else is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu import datastore as jds
from mlrun_tpu.frameworks.jax import auto_trainer as jauto
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.serving import adapters as jadapters
from mlrun_tpu_torch import datastore as tds
from mlrun_tpu_torch.chaos import chaos as tchaos
from mlrun_tpu_torch.chaos import fail_nth
from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import adapters as tadapters
from mlrun_tpu_torch.serving.v2_serving import V2ModelServer
from mlrun_tpu_torch.training import train as ttrain
from tests.torch_registries import registries_left_as_found  # noqa: F401

RUN_REL_TOL = 1e-4


@pytest.mark.parametrize("url", [
    "file:///tmp/a/b.npy", "file://relative/x.txt", "/abs/path.bin",
    "rel/path", "memory://bucket/key", "s3://bucket/dir/obj",
    "https://host:8080/p?q=1", "store://artifacts/proj/key"])
def test_parse_url_matches_reference(url):
    assert tds.parse_url(url) == jds.parse_url(url)


@pytest.mark.parametrize("kind", ["file_url", "bare_path", "memory"])
def test_stores_match_reference(tmp_path, kind):
    """put / get (whole, offset, size) / stat / exists / listdir / local /
    delete on the same keys through both packages' ``store_manager``. On
    the file system each package reads what the other wrote; each
    package's ``memory://`` store is its own process-wide dict."""
    parent = {"memory": f"memory://bucket/{tmp_path.name}",
              "file_url": f"file://{tmp_path / 'data'}",
              "bare_path": str(tmp_path / "data")}[kind]

    def url(name):
        return f"{parent}/{name}"

    payload = np.arange(100, dtype=np.int32).tobytes()
    tds.store_manager.object(url=url("t.bin")).put(payload)
    jds.store_manager.object(url=url("j.bin")).put(payload)
    pairs = ([("t.bin", tds.store_manager), ("j.bin", jds.store_manager)]
             if kind == "memory" else
             [(name, manager) for name in ("t.bin", "j.bin")
              for manager in (tds.store_manager, jds.store_manager)])
    for name, manager in pairs:
        item = manager.object(url=url(name))
        assert item.get() == payload
        assert item.get(size=8, offset=4) == payload[4:12]
        assert item.stat().size == len(payload) and item.exists()
        with open(item.local(), "rb") as fp:
            assert fp.read() == payload
    listed = [sorted(m.object(url=parent).listdir())
              for m in (tds.store_manager, jds.store_manager)]
    if kind == "memory":
        assert "t.bin" in listed[0] and "j.bin" in listed[1]
    else:
        assert listed[0] == listed[1] and {"t.bin", "j.bin"} <= set(
            listed[0])
    tds.store_manager.object(url=url("t.bin")).delete()
    assert not tds.store_manager.object(url=url("t.bin")).exists()
    assert jds.store_manager.object(url=url("j.bin")).exists()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dataitem_contract(tmp_path, pkg):
    """tests/test_api_parity.py::test_dataitem_contract on both packages
    (ROADMAP 3.9): ``open``, the store's kind, ``get_artifact_type``,
    ``ls``, ``upload`` and ``remove_local``; then the store's ``url``,
    ``rm`` and ``_get_secret_or_env`` and the item's ``artifact_url`` on
    the ``memory://`` store."""
    store_manager = {"jax": jds, "port": tds}[pkg].store_manager
    src = tmp_path / "data.txt"
    src.write_text("hello")
    item = store_manager.object(url=str(src))
    with item.open("r") as f:
        assert f.read() == "hello"
    assert item.store.kind == "file"
    assert item.get_artifact_type() is None
    dir_item = store_manager.object(url=str(tmp_path))
    assert "data.txt" in dir_item.ls()
    src2 = tmp_path / "new.txt"
    src2.write_text("payload")
    target = store_manager.object(url=str(tmp_path / "uploaded.txt"))
    target.upload(str(src2))
    assert (tmp_path / "uploaded.txt").read_text() == "payload"
    target.remove_local()  # no-op for file store, must not raise

    url = f"memory://bucket/{tmp_path.name}/m.bin"
    memory = store_manager.object(url=url)
    memory.upload(str(src2))
    with memory.open("rb") as f:
        assert f.read() == b"payload"
    memory.remove_local()
    store = memory.store
    assert (store.using_bucket, memory.artifact_url, memory.url) == (
        False, url, url)
    assert store.url(f"/{tmp_path.name}/m.bin") == url
    assert item.store.url(str(src)) == str(src)
    store.rm(memory._path)
    assert not memory.exists()
    store._secrets["MLT_DS_KEY"] = "from-secrets"
    assert store._get_secret_or_env("MLT_DS_KEY") == "from-secrets"
    assert store._get_secret_or_env("MLT_DS_NONE", "d") == "d"
    memory.show()


def test_datastore_fault_points_fire():
    """``datastore.read`` / ``datastore.write`` arm through the port's
    own chaos registry, as the reference's DataItem fires them."""
    item = tds.store_manager.object(url="memory://chaos/key")
    with tchaos.inject("datastore.write", fail_nth(1),
                       error=OSError("write refused")):
        with pytest.raises(OSError, match="write refused"):
            item.put(b"x")
    item.put(b"x")
    with tchaos.inject("datastore.read", fail_nth(1),
                       error=OSError("read refused")):
        with pytest.raises(OSError, match="read refused"):
            item.get()
    assert item.get() == b"x"


@pytest.mark.parametrize("url", [
    "s3://bucket/tokens.npy", "gs://bucket/t.npy", "az://c/t.npy",
    "https://host/t.npy", "redis://host/key", "store://models/p/m",
    "ds://profile/key"])
def test_unported_schemes_raise_item_10(url, tmp_path):
    """The object stores raise item 10 (its tail). ``store://`` and
    ``ds://`` resolve through the run db since the run stack landed: here
    to an artifact and a profile on s3, whose store then raises."""
    from mlrun_tpu_torch.db import SQLiteRunDB

    scheme = url.split("://")[0]
    manager = tds.StoreManager()
    if scheme in ("store", "ds"):
        db = SQLiteRunDB(str(tmp_path / "db.sqlite"),
                         logs_dir=str(tmp_path / "logs"))
        db.store_artifact("m", {"kind": "model", "spec": {
            "target_path": "s3://bucket/m"}}, project="p")
        db.store_datastore_profile({"name": "profile", "type": "s3",
                                    "fields": {"bucket": "bucket"}})
        manager.set(db=db)
        scheme = "s3"
    with pytest.raises(NotImplementedError, match="item 10") as err:
        manager.object(url=url)
    assert f"'{scheme}://'" in str(err.value)


def _same_init(monkeypatch):
    """The port's Trainer starts from the reference Trainer's init."""
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


class _Context:
    def __init__(self):
        self.metrics = []

    def log_metrics(self, metrics, step=None):
        self.metrics.append(dict(metrics))

    def log_result(self, key, value):
        pass

    def log_results(self, results):
        pass


def test_train_on_a_file_url_npy_matches_reference(tmp_path, monkeypatch):
    """``train(dataset="file://<tokens>.npy")`` in both packages from the
    same init: the same batches, so the same per-step loss and norm."""
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(7).integers(0, 512, 4000,
                                                     dtype=np.int32))
    _same_init(monkeypatch)
    common = dict(model="tiny", dataset=f"file://{path}", batch_size=2,
                  seq_len=16, steps=3, log_every=1, learning_rate=1e-2,
                  warmup=False)
    jctx, tctx = _Context(), _Context()
    jauto.train(context=jctx, mesh_shape={"fsdp": 1}, model_overrides={
        "dtype": jnp.float32, "attention_impl": "reference"}, **common)
    tauto.train(context=tctx, model_overrides={"dtype": torch.float32},
                device="cpu", **common)
    assert [m["step"] for m in tctx.metrics] == [1, 2, 3]
    for jm, tm in zip(jctx.metrics, tctx.metrics):
        for key in ("loss", "grad_norm"):
            assert abs(jm[key] - tm[key]) <= RUN_REL_TOL * abs(jm[key]), key


def _adapter_tree(seed):
    rng = np.random.default_rng(seed)
    return {target: {"lora_a": rng.standard_normal((2, 16, 4)).astype(
                         np.float32),
                     "lora_b": rng.standard_normal((2, 4, 16)).astype(
                         np.float32),
                     "scaling": np.full(2, 0.5, np.float32)}
            for target in ("wq", "wv")}


def test_adapters_cross_packages_over_file_urls(tmp_path):
    """An adapter written by one package at a ``file://`` url reads back
    bit-equal in the other."""
    def url(name):
        return f"file://{tmp_path / name}"

    trees = {"t": _adapter_tree(1), "j": _adapter_tree(2)}
    tadapters.save_adapter(url("t.npz"), trees["t"])
    jadapters.save_adapter(url("j.npz"), trees["j"])
    for loaded, tree in ((jadapters.load_adapter(url("t.npz")), trees["t"]),
                         (tadapters.load_adapter(url("j.npz")), trees["j"])):
        assert set(loaded) == set(tree)
        for target, parts in tree.items():
            for key in ("lora_a", "lora_b", "scaling"):
                np.testing.assert_array_equal(loaded[target][key],
                                              np.asarray(parts[key]))


def test_get_model_over_a_directory_a_file_and_a_url(tmp_path):
    """``V2ModelServer.get_model`` against the reference's ``get_model``:
    a directory's entry with the suffix, a file, and a ``file://`` url."""
    from mlrun_tpu.artifacts.model import get_model as jget_model

    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "weights.npz").write_bytes(b"weights")
    for path, suffix in ((str(model_dir), ".npz"),
                         (str(model_dir / "weights.npz"), ""),
                         (f"file://{model_dir / 'weights.npz'}", "")):
        server = V2ModelServer(name="m", model_path=path)
        local, extra = server.get_model(suffix)
        ref_local, ref_spec, ref_extra = jget_model(path, suffix)
        assert (local, extra, server.model_spec) == (ref_local, ref_extra,
                                                     ref_spec)
        with open(local, "rb") as fp:
            assert fp.read() == b"weights"
    with pytest.raises(FileNotFoundError, match="no model file"):
        V2ModelServer(model_path=str(model_dir)).get_model(".pt")
    # a store:// uri resolves through the run db to the artifact's
    # target and its ModelArtifact spec, as the reference's get_model does
    from mlrun_tpu.db import set_run_db as jset_run_db
    from mlrun_tpu_torch.db import SQLiteRunDB, set_run_db

    db = SQLiteRunDB(str(tmp_path / "db.sqlite"),
                     logs_dir=str(tmp_path / "logs"))
    db.store_artifact("m", {"kind": "model", "spec": {
        "target_path": str(model_dir), "model_file": "weights.npz",
        "extra_data": {"k": "v"}}}, project="p")
    set_run_db(db)
    jset_run_db(db)
    try:
        server = V2ModelServer(model_path="store://models/p/m")
        local, extra = server.get_model()
        ref_local, ref_spec, ref_extra = jget_model("store://models/p/m")
    finally:
        set_run_db(None)
        jset_run_db(None)
        tds.store_manager._db = None
    assert (local, extra) == (ref_local, ref_extra) == (
        str(model_dir / "weights.npz"), {"k": "v"})
    assert server.model_spec.to_dict() == ref_spec.to_dict()
    assert type(server.model_spec).__name__ == "ModelArtifact"
