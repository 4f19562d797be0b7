"""The port's packagers (mlrun_tpu_torch.package) against mlrun_tpu's on
the CPU: the same values go through both managers with one recording
context — results equal, ``.npy`` / ``.npz`` contents equal, the same
unpackaging instructions — and torch tensors (float32 and bfloat16) and a
port param tree round-trip bit for bit, bfloat16 without ``ml_dtypes``.
Also the contracts of the reference's ``tests/test_packagers.py`` that
need no run objects: ``test_reduce_hint_variants``,
``test_dataclass_roundtrip_with_hint``,
``test_unpackaging_instructions_no_hint_roundtrip``,
``test_unpackaging_instruction_module_allowlist`` and the families' round
trips, through the port's ``ContextHandler`` on a duck-typed context.

Bounds: every compared value and array bit-equal.
"""

import dataclasses
import datetime
import pathlib
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from mlrun_tpu.package import PackagersManager as JManager
from mlrun_tpu_torch.datastore import DataItem, store_manager
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.package import ContextHandler, PackagersManager
from mlrun_tpu_torch.package.packagers import torch_packagers as tpk
from mlrun_tpu_torch.package.type_hints import reduce_hint


class _Context:
    """Records results and stores artifacts by key (local file copies or
    bodies, with their unpackaging instructions)."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.results, self.artifacts = {}, {}

    def log_result(self, key, value):
        self.results[key] = value

    def log_artifact(self, key, local_path="", body=None, format="",
                     unpackaging_instructions=None, **kw):
        target = self.root / f"{key}.{format or 'bin'}"
        if local_path:
            target = self.root / (key + pathlib.Path(local_path).suffix)
            if pathlib.Path(local_path).is_file():
                target.write_bytes(pathlib.Path(local_path).read_bytes())
            else:
                target = pathlib.Path(local_path)
        else:
            target.write_bytes(body if isinstance(body, bytes)
                               else str(body).encode())
        self.artifacts[key] = (str(target), unpackaging_instructions or {})

    def log_dataset(self, key, df=None, format="parquet", **kw):
        path = self.root / f"{key}.{format}"
        getattr(df, f"to_{format}")(path)
        self.artifacts[key] = (str(path), kw.get("unpackaging_instructions"))

    def log_model(self, key, body=None, **kw):
        self.results[f"model:{key}"] = body

    def item(self, key):
        """The stored artifact as a DataItem carrying its instructions."""
        path, instructions = self.artifacts[key]
        store, subpath = store_manager.get_or_create_store(path)
        return DataItem(key, store, subpath, url=path, meta={
            "spec": {"unpackaging_instructions": instructions}})


@dataclasses.dataclass
class TrainParams:
    lr: float
    steps: int
    name: str


@dataclasses.dataclass
class Nested:
    params: TrainParams
    tag: str


VALUES = {
    "score": 0.5, "meta": {"k": 1}, "arr": np.arange(6).reshape(2, 3),
    "npdict": {"layer0": np.ones((2, 2)), "layer1": np.zeros(3)},
    "nplist": [np.arange(2), np.arange(3)],
    "when": datetime.datetime(2026, 7, 29, 12, 0), "blob": b"\x00\x01",
    "scalar": np.float32(0.25), "tup": (1, 2, 3), "cfg": Nested(
        TrainParams(0.1, 5, "a"), "v1"), "frame": pd.DataFrame({"a": [1, 2]}),
}


def _pack_all(manager, root) -> _Context:
    context = _Context(root)
    for key, value in VALUES.items():
        manager.pack(context, value, {"key": key})
    return context


def test_both_managers_log_the_same(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _pack_all(JManager(), tmp_path / "j")
    got = _pack_all(PackagersManager(), tmp_path / "t")
    assert got.results == want.results
    assert set(got.artifacts) == set(want.artifacts)
    for key, (path, instructions) in got.artifacts.items():
        ref_path, ref_instructions = want.artifacts[key]
        assert instructions["packager"] == ref_instructions["packager"]
        assert instructions["object_type"].rsplit(".", 1)[-1] == \
            ref_instructions["object_type"].rsplit(".", 1)[-1]
        if path.endswith((".npy", ".npz")):
            a, b = np.load(path), np.load(ref_path)
            if path.endswith(".npz"):
                assert a.files == b.files
                for name in a.files:
                    np.testing.assert_array_equal(a[name], b[name])
            else:
                np.testing.assert_array_equal(a, b)
        elif path.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(path),
                                          pd.read_parquet(ref_path))
        else:
            assert pathlib.Path(path).read_bytes() == \
                pathlib.Path(ref_path).read_bytes()


def _bits(tensor):
    return tensor.view(torch.int16) if tensor.dtype == torch.bfloat16 \
        else tensor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_tensor_round_trips_bit_for_bit(tmp_path, monkeypatch, dtype):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # not importable
    tensor = (torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
              * 100).to(dtype)
    context = _Context(tmp_path)
    PackagersManager().pack(context, tensor, {"key": "t"})
    path, instructions = context.artifacts["t"]
    assert path.endswith(".npy")
    assert instructions["packager"] == "TorchTensorPackager"
    back = PackagersManager().unpack(context.item("t"), torch.Tensor)
    assert back.dtype == dtype and back.shape == tensor.shape
    assert torch.equal(_bits(back), _bits(tensor))
    # and a hint-free consumer gets the tensor back from the instructions
    again = PackagersManager().unpack(context.item("t"), None)
    assert torch.equal(_bits(again), _bits(tensor))


def test_scalar_tensor_is_a_result(tmp_path):
    context = _Context(tmp_path)
    PackagersManager().pack(context, torch.tensor(1.5, dtype=torch.bfloat16),
                            {"key": "s"})
    assert context.results == {"s": 1.5}


def test_param_tree_round_trips_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    params = tllama.init_params(tllama.tiny_llama(dtype=torch.bfloat16),
                                torch.Generator().manual_seed(0), "cpu")
    context = _Context(tmp_path)
    PackagersManager().pack(context, params, {"key": "params"})
    path, instructions = context.artifacts["params"]
    assert instructions["packager"] == "TorchTreePackager"
    flat = tpk.flatten_tree(params)
    with np.load(path) as stored:
        assert sorted(stored.files) == sorted(flat)
        some = next(n for n in flat if flat[n].dtype == torch.bfloat16)
        assert stored[some].dtype.names == ("bfloat16",)
    back = tpk.TorchTreePackager().unpack(context.item("params"), dict)
    got = tpk.flatten_tree(back)
    assert sorted(got) == sorted(flat)
    for name, leaf in flat.items():
        assert got[name].dtype == leaf.dtype
        assert torch.equal(_bits(got[name]), _bits(leaf)), name


def test_reduce_hint_variants():
    from typing import Any, Dict, List, Optional, Union

    assert reduce_hint(int) == [int]
    assert reduce_hint(Optional[str]) == [str]
    assert set(reduce_hint(Union[int, float])) == {int, float}
    assert reduce_hint(List[int]) == [list]
    assert reduce_hint(Dict[str, int]) == [dict]
    assert reduce_hint("pandas.DataFrame") == [pd.DataFrame]
    assert reduce_hint("np.ndarray") == [np.ndarray]
    assert reduce_hint("torch.Tensor") == [torch.Tensor]
    assert reduce_hint("nonexistent.module.T") == []
    assert reduce_hint(None) == [] and reduce_hint(Any) == []


def _handler_run(handler, tmp_path, returns=None, inputs=None, **params):
    handler_io = ContextHandler()
    context = _Context(tmp_path)
    kwargs = handler_io.parse_inputs(handler, context, parameters=params,
                                     inputs=inputs)
    handler_io.package_results(context, handler(**kwargs), returns)
    return context


def test_dataclass_roundtrip_with_hint(tmp_path):
    produced = _handler_run(lambda context: Nested(
        TrainParams(lr=0.1, steps=5, name="a"), "v1"), tmp_path,
        returns=["cfg"])
    assert "cfg" in produced.artifacts

    def consumer(context, cfg: Nested):
        assert isinstance(cfg, Nested)
        assert isinstance(cfg.params, TrainParams)
        context.log_result("lr", cfg.params.lr)

    consumed = _handler_run(consumer, tmp_path,
                            inputs={"cfg": produced.item("cfg")})
    assert consumed.results["lr"] == 0.1


def test_unpackaging_instructions_no_hint_roundtrip(tmp_path):
    produced = _handler_run(lambda context: TrainParams(0.2, 7, "b"),
                            tmp_path, returns=["cfg"])
    instructions = produced.artifacts["cfg"][1]
    assert instructions["packager"] == "DataclassPackager"
    assert instructions["object_type"].endswith("TrainParams")

    def consumer(context, cfg):  # NO type hint
        assert type(cfg).__name__ == "TrainParams"
        context.log_result("steps", cfg.steps)

    consumed = _handler_run(consumer, tmp_path,
                            inputs={"cfg": produced.item("cfg")})
    assert consumed.results["steps"] == 7


def test_families_roundtrip(tmp_path):
    blob = tmp_path / "weights.bin"
    blob.write_bytes(b"\x00\x01\x02")
    produced = _handler_run(
        lambda context: (blob, b"payload",
                         datetime.datetime(2026, 7, 29, 12, 0), (1, 2, 3),
                         {"x", "y"}, pd.DataFrame({"x": [1, 2, 3]}),
                         np.arange(5), torch.arange(4.0)),
        tmp_path, returns=["path", "raw", "when", "tup:artifact",
                           "labels:artifact", "frame", "arr", "ten"])
    assert produced.results["when"] == "2026-07-29T12:00:00"

    def consumer(context, path: pathlib.Path, raw: bytes, tup: tuple,
                 labels: set, frame: pd.DataFrame, arr: "np.ndarray",
                 ten: torch.Tensor):
        assert isinstance(path, pathlib.Path) and path.exists()
        assert raw == b"payload"
        assert tup == (1, 2, 3) and labels == {"x", "y"}
        assert len(frame) == 3 and int(arr.sum()) == 10
        assert torch.equal(ten, torch.arange(4.0))
        context.log_result("ok", 1)

    names = ("path", "raw", "tup", "labels", "frame", "arr", "ten")
    consumed = _handler_run(consumer, tmp_path, inputs={
        name: produced.item(name) for name in names})
    assert consumed.results["ok"] == 1


def test_unpackaging_instruction_module_allowlist():
    from mlrun_tpu_torch.package.packagers_manager import _resolve_type

    sys.modules.pop("xmlrpc.client", None)
    sys.modules.pop("xmlrpc", None)
    assert _resolve_type("xmlrpc.client.ServerProxy", trusted=False) is None
    assert "xmlrpc" not in sys.modules
    assert _resolve_type("int", trusted=False) is int
    assert _resolve_type("pandas.DataFrame", trusted=False) is pd.DataFrame
    assert _resolve_type("mlrun_tpu_torch.package.PackagersManager",
                         trusted=False) is PackagersManager
    assert _resolve_type("xmlrpc.client.ServerProxy", trusted=True) \
        is not None
    sys.modules.pop("xmlrpc.client", None)
    sys.modules.pop("xmlrpc", None)

    class Item:
        kind = "file"
        meta = {"spec": {"unpackaging_instructions": {
            "object_type": "xmlrpc.client.ServerProxy",
            "packager": "Anything"}}}

    item = Item()
    assert PackagersManager().unpack(item, hint=None) is item
    assert "xmlrpc" not in sys.modules


def test_reference_reads_the_bf16_tag_as_raw_bits(tmp_path):
    """The departure: the reference's loader sees a bf16 leaf as the
    structured 16-bit patterns, which carry the tensor's exact bits."""
    tensor = torch.tensor([1.0, -2.5, 3.25], dtype=torch.bfloat16)
    context = _Context(tmp_path)
    PackagersManager().pack(context, {"w": tensor}, {"key": "tree"})
    loaded = dict(np.load(context.artifacts["tree"][0]))
    assert loaded["w"].dtype.names == ("bfloat16",)
    np.testing.assert_array_equal(loaded["w"]["bfloat16"],
                                  tensor.view(torch.int16).numpy()
                                  .view(np.uint16))
