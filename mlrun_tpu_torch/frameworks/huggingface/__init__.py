"""HuggingFace adapter — counterpart of
``mlrun_tpu/frameworks/huggingface/__init__.py``.

``load_hf_weights_into_llama`` maps an HF Llama checkpoint directory into
the port's stacked param tree, tensor by tensor, without instantiating the
torch model, so fine-tunes and servers start from real weights.
Safetensors files are read by the port itself (``SafetensorsFile``: the
8-byte header length, the JSON header, the raw bytes viewed in place) so
that BF16 tensors load: the reference reads through
``safetensors.safe_open(framework="np")``, which has no bfloat16.
``HuggingFaceModelServer`` runs a ``transformers`` pipeline, on the GPU
unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ...models.llama import LlamaConfig
from ...parallel.sharding import local_part
from ...utils import logger

# safetensors dtype codes the reader views; any other raises with its name
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16}

# transformers' LlamaConfig defaults, which AutoConfig fills in for keys a
# config.json of model_type llama leaves out
HF_LLAMA_DEFAULTS = {
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False,
}


class SafetensorsFile:
    """One ``.safetensors`` file: the header parsed up front, each tensor
    mapped from disk only when asked for (``np.memmap`` of its byte range,
    released with the tensor), so host memory holds one tensor at a
    time."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fp:
            (length,) = struct.unpack("<Q", fp.read(8))
            header = json.loads(fp.read(length))
        header.pop("__metadata__", None)
        self.header: dict = header
        self.data_start = 8 + length

    def keys(self) -> list:
        return list(self.header)

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` in its stored dtype, a view of the mapped
        file (copy it before the mapping goes)."""
        info = self.header[name]
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise TypeError(
                f"safetensors dtype {info['dtype']} of {name} is not "
                f"supported (have {sorted(SAFETENSORS_DTYPES)})")
        shape = tuple(int(n) for n in info["shape"])
        begin, end = (int(n) for n in info["data_offsets"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if end - begin != nbytes:
            raise ValueError(f"{name}: {end - begin} bytes in {self.path} "
                             f"for shape {shape} of {info['dtype']}")
        if nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        # copy-on-write: a writable view without touching the file
        raw = np.memmap(self.path, dtype=np.uint8, mode="c",
                        offset=self.data_start + begin, shape=(nbytes,))
        return torch.from_numpy(raw).view(dtype).reshape(shape)


class _CheckpointReader:
    """Tensor-by-tensor access to an HF checkpoint directory without
    instantiating the torch model: safetensors, one file or sharded through
    ``model.safetensors.index.json``, read lazily per file; pytorch
    ``.bin`` through a torch mmap load. Peak host memory is one tensor."""

    def __init__(self, directory: str):
        self.directory = directory
        self._file_of: dict[str, str] = {}
        self._handles: dict[str, SafetensorsFile] = {}
        self._bin_state: dict = {}

        st_index = os.path.join(directory, "model.safetensors.index.json")
        st_single = os.path.join(directory, "model.safetensors")
        bin_index = os.path.join(directory, "pytorch_model.bin.index.json")
        bin_single = os.path.join(directory, "pytorch_model.bin")
        if os.path.exists(st_index):
            with open(st_index) as fp:
                self._file_of = dict(json.load(fp)["weight_map"])
            self._kind = "safetensors"
        elif os.path.exists(st_single):
            self._file_of = {k: "model.safetensors"
                             for k in self._safetensors(
                                 "model.safetensors").keys()}
            self._kind = "safetensors"
        elif os.path.exists(bin_index):
            with open(bin_index) as fp:
                self._file_of = dict(json.load(fp)["weight_map"])
            self._kind = "bin"
        elif os.path.exists(bin_single):
            self._kind = "bin"
        else:
            raise FileNotFoundError(
                f"no model.safetensors[.index.json] or pytorch_model.bin"
                f"[.index.json] under {directory}")

    def _safetensors(self, fname: str) -> SafetensorsFile:
        handle = self._handles.get(fname)
        if handle is None:
            handle = SafetensorsFile(os.path.join(self.directory, fname))
            self._handles[fname] = handle
        return handle

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` on the host, in its stored dtype."""
        if self._kind == "safetensors":
            return self._safetensors(self._file_of[name]).get(name)
        fname = self._file_of.get(name, "pytorch_model.bin")
        state = self._bin_state.get(fname)
        if state is None:
            # mmap keeps tensors on disk until they are read
            state = torch.load(os.path.join(self.directory, fname),
                               map_location="cpu", mmap=True,
                               weights_only=True)
            self._bin_state[fname] = state
        return state[name]

    def close(self):
        self._handles.clear()
        self._bin_state.clear()


def _resolve_checkpoint_dir(model_name_or_path: str) -> str:
    """A local directory as is; anything else is a hub id, fetched through
    ``huggingface_hub.snapshot_download`` (serving weights and configs
    only)."""
    if os.path.isdir(model_name_or_path):
        return model_name_or_path
    from huggingface_hub import snapshot_download

    # a bare snapshot would also pull the duplicate original/*.pth weights
    return snapshot_download(
        model_name_or_path,
        allow_patterns=["*.safetensors", "*.safetensors.index.json",
                        "*.bin", "*.bin.index.json", "*.json", "*.model",
                        "tokenizer*"],
        ignore_patterns=["original/*", "*.pth", "*.gguf"])


def llama_config_from_hf(directory: str) -> LlamaConfig:
    """The port's LlamaConfig from ``config.json``, read with ``json``;
    keys it leaves out take transformers' Llama defaults, as
    ``AutoConfig`` gives them (so ``rope_theta`` 10000.0 and
    ``rms_norm_eps`` 1e-6, not the Llama-3 values of LlamaConfig).
    ``rope_scaling`` is ignored, as in the reference."""
    with open(os.path.join(directory, "config.json")) as fp:
        raw = json.load(fp)
    hf = {key: raw[key] if raw.get(key) is not None else default
          for key, default in HF_LLAMA_DEFAULTS.items()}
    heads = int(hf["num_attention_heads"])
    return LlamaConfig(
        vocab_size=int(hf["vocab_size"]),
        n_layers=int(hf["num_hidden_layers"]),
        embed_dim=int(hf["hidden_size"]),
        n_heads=heads,
        n_kv_heads=int(raw.get("num_key_value_heads") or heads),
        head_dim=int(raw.get("head_dim")
                     or int(hf["hidden_size"]) // heads),
        mlp_dim=int(hf["intermediate_size"]),
        rope_theta=float(hf["rope_theta"]),
        norm_eps=float(hf["rms_norm_eps"]),
        tie_embeddings=bool(hf["tie_word_embeddings"]),
    )


def load_hf_weights_into_llama(model_name_or_path: str, config=None,
                               dtype=None, device=None, shardings=None):
    """Load an HF Llama-family checkpoint into ``(LlamaConfig, params)``.

    Streams the checkpoint tensor by tensor (never instantiates the torch
    model): each stacked leaf is allocated on ``device`` (default: the
    GPU) in the target dtype (``dtype``, else the config's) and filled one
    layer at a time, torch's ``[out, in]`` transposed to the port's
    ``[in, out]``, so host memory holds one source tensor. ``lm_head`` is
    read only when the embeddings are untied. ``shardings`` (a tree like
    the params of ``parallel.sharding.tree_shardings`` placements, each
    carrying its mesh; a leaf's node may be None) places each leaf as a
    DTensor as it is read: the rank keeps its part of each source tensor
    (its layers of a stacked leaf), so no rank holds a whole leaf."""
    from ...serving.llm import default_device

    device = default_device(device)
    directory = _resolve_checkpoint_dir(model_name_or_path)
    config = config or llama_config_from_hf(directory)
    dtype = dtype or config.dtype
    reader = _CheckpointReader(directory)

    def fetch(name: str, transpose: bool) -> torch.Tensor:
        # the stored bytes go to the device as they are; the transpose
        # and the cast to ``dtype`` run there
        tensor = reader.get(name).to(device)
        return tensor.t() if transpose else tensor

    def placement(path: tuple):
        node = shardings
        for key in path:
            if node is None:
                break
            node = node[key]
        return node

    def placed(out: torch.Tensor, where) -> torch.Tensor:
        if where is None:
            return out
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(out, where.mesh, tuple(where))

    def leaf(name: str, path: tuple, transpose=False) -> torch.Tensor:
        tensor = fetch(name, transpose)
        where = placement(path)
        if where is not None:
            tensor = local_part(tensor, where.mesh, tuple(where))
        out = torch.empty(tensor.shape, dtype=dtype, device=device)
        out.copy_(tensor)
        return placed(out, where)

    def stacked(fmt: str, path: tuple, transpose=True) -> torch.Tensor:
        where = placement(path)
        layers, per_layer = range(config.n_layers), None
        if where is not None:
            layers, per_layer = _layer_part(config.n_layers, where)
        out = None
        for i, layer_index in enumerate(layers):
            tensor = fetch(fmt.format(layer_index), transpose)
            if per_layer is not None:
                tensor = local_part(tensor, where.mesh, per_layer)
            if out is None:
                out = torch.empty((len(layers),) + tuple(tensor.shape),
                                  dtype=dtype, device=device)
            out[i].copy_(tensor)
            del tensor
        return placed(out, where)

    layer = "model.layers.{}."

    def layer_leaf(name: str, fmt: str, transpose=True) -> torch.Tensor:
        return stacked(layer + fmt, ("layers", name), transpose)

    try:
        params = {
            "embedding": leaf("model.embed_tokens.weight", ("embedding",)),
            "layers": {
                "attn_norm_scale": layer_leaf(
                    "attn_norm_scale", "input_layernorm.weight", False),
                "wq": layer_leaf("wq", "self_attn.q_proj.weight"),
                "wk": layer_leaf("wk", "self_attn.k_proj.weight"),
                "wv": layer_leaf("wv", "self_attn.v_proj.weight"),
                "wo": layer_leaf("wo", "self_attn.o_proj.weight"),
                "mlp_norm_scale": layer_leaf(
                    "mlp_norm_scale", "post_attention_layernorm.weight",
                    False),
                "w_gate": layer_leaf("w_gate", "mlp.gate_proj.weight"),
                "w_up": layer_leaf("w_up", "mlp.up_proj.weight"),
                "w_down": layer_leaf("w_down", "mlp.down_proj.weight"),
            },
            "final_norm_scale": leaf("model.norm.weight",
                                     ("final_norm_scale",)),
        }
        if not config.tie_embeddings:
            params["lm_head"] = leaf("lm_head.weight", ("lm_head",),
                                     transpose=True)
    finally:
        reader.close()
    logger.info("streamed HF checkpoint", model=model_name_or_path,
                layers=config.n_layers, device=str(device))
    return config, params


def _layer_part(n_layers: int, where) -> tuple:
    """(the layers a rank holds of a stacked leaf placed by ``where``, the
    placements of one layer's tensor): a ``Shard(0)`` cuts the layers in
    mesh-axis order, as ``parallel.sharding.local_part`` cuts a tensor."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, lo, count = where.mesh, 0, n_layers
    coordinate = mesh.get_coordinate()
    per_layer = []
    for axis, p in enumerate(where):
        if isinstance(p, Shard) and p.dim == 0:
            count //= mesh.size(axis)
            lo += coordinate[axis] * count
            per_layer.append(Replicate())
        else:
            per_layer.append(Shard(p.dim - 1) if isinstance(p, Shard) else p)
    return range(lo, lo + count), tuple(per_layer)


class HuggingFaceModelServer:
    """Serving-graph step wrapping a ``transformers`` pipeline (the
    reference's ``HuggingFaceModelServer``), run on the GPU unless
    ``device="cpu"`` is passed; ``LLMModelServer`` with ``hf_model=``
    serves a Llama checkpoint on the port's kernels."""

    def __new__(cls, *args, **kwargs):
        from ...serving.llm import default_device
        from ...serving.v2_serving import V2ModelServer

        class _Server(V2ModelServer):
            def __init__(self, *a, task: str = "text-classification",
                         model_name: str | None = None, device=None, **kw):
                super().__init__(*a, **kw)
                self.task = task
                self.hf_model_name = model_name
                self.device = default_device(device)

            def load(self):
                from transformers import pipeline

                self.model = pipeline(
                    self.task, model=self.hf_model_name or None,
                    device=self.device)

            def predict(self, request):
                return [self.model(item) for item in request["inputs"]]

        return _Server(*args, **kwargs)
