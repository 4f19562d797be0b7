"""The port's native token-shard loader (mlrun_tpu_torch/training/data.py
``TokenShardLoader`` on its own copy of the C++ source,
``mlrun_tpu_torch/csrc/data_loader.cpp``, built with g++ at first use by
``ops/_build.build_host``): the seven contracts of the reference's
tests/test_data_loader.py on the port, and batch-for-batch equality with
the reference's ``TokenShardLoader`` for the same shards and seed. The
reference's library is built from its own source into the test's
temporary directory and passed as ``lib_path=``. Exact comparisons
throughout (integer tokens)."""

import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mlrun_tpu_torch.ops import _build
from mlrun_tpu_torch.training.data import TokenShardLoader, device_prefetch

ROOT = Path(__file__).resolve().parents[1]


def _write_shard(path, tokens, dtype=np.int32):
    np.asarray(tokens, dtype=dtype).tofile(path)


def test_loader_covers_all_windows_once_per_epoch(tmp_path):
    seq = 4
    # 2 shards x 5 windows x (seq+1) tokens, each window tagged by its id
    paths = []
    for s in range(2):
        tokens = []
        for w in range(5):
            tokens.extend([(s * 5 + w)] * (seq + 1))
        p = tmp_path / f"shard{s}.bin"
        _write_shard(p, tokens)
        paths.append(str(p))
    # workers=1: several workers stage the epoch boundary in any order
    with TokenShardLoader(paths, batch_size=2, seq_len=seq, seed=7,
                          workers=1) as loader:
        assert loader.total_tokens == 2 * 5 * (seq + 1)
        seen = []
        for _ in range(5):
            tokens, targets = next(loader)
            assert tokens.shape == (2, seq) and targets.shape == (2, seq)
            assert tokens.dtype == np.int32
            assert (tokens == targets).all()
            seen.extend(tokens[:, 0].tolist())
        assert sorted(seen) == list(range(10))


def test_loader_shuffles_differently_across_epochs(tmp_path):
    seq = 2
    tokens = []
    for w in range(64):
        tokens.extend([w] * (seq + 1))
    p = tmp_path / "shard.bin"
    _write_shard(p, tokens)
    orders = []
    with TokenShardLoader(str(p), batch_size=8, seq_len=seq, seed=3,
                          workers=1) as loader:
        for _ in range(2):
            epoch_order = []
            for _ in range(8):
                toks, _t = next(loader)
                epoch_order.extend(toks[:, 0].tolist())
            orders.append(epoch_order)
    assert sorted(orders[0]) == sorted(orders[1]) == list(range(64))
    assert orders[0] != orders[1]
    assert orders[0] != list(range(64))


def test_loader_uint16_and_lm_shift(tmp_path):
    seq = 3
    p = tmp_path / "shard.bin"
    _write_shard(p, np.arange(seq + 1), dtype=np.uint16)
    with TokenShardLoader(str(p), batch_size=1, seq_len=seq,
                          dtype="uint16") as loader:
        tokens, targets = next(loader)
    assert tokens.tolist() == [[0, 1, 2]]
    assert targets.tolist() == [[1, 2, 3]]


def test_loader_rejects_bad_input(tmp_path):
    p = tmp_path / "tiny.bin"
    _write_shard(p, [1, 2])  # shorter than seq+1
    with pytest.raises(RuntimeError):
        TokenShardLoader(str(p), batch_size=1, seq_len=8)
    with pytest.raises(FileNotFoundError):
        TokenShardLoader(str(tmp_path / "missing.bin"), 1, 2)
    with pytest.raises(ValueError, match="int32|uint16"):
        TokenShardLoader(str(p), batch_size=1, seq_len=1, dtype="int8")


def test_loader_stats_ring_occupancy_and_waits(tmp_path):
    seq = 4
    tokens = []
    for w in range(64):
        tokens.extend([w] * (seq + 1))
    p = tmp_path / "shard.bin"
    _write_shard(p, tokens)
    with TokenShardLoader(str(p), batch_size=2, seq_len=seq, seed=1,
                          workers=1, queue_depth=2) as loader:
        deadline = time.time() + 5
        while time.time() < deadline:
            stats = loader.stats()
            if stats["ring_occupancy"] >= 2 and \
                    stats["producer_waits"] >= 1:
                break           # ring full AND the worker blocked on it
            time.sleep(0.01)
        assert stats["queue_depth"] == 2
        assert stats["ring_occupancy"] == 2
        assert stats["producer_waits"] >= 1
        for _ in range(4):
            next(loader)
        stats = loader.stats()
        assert stats["batches"] == 4
        assert stats["epochs"] == loader.epoch


def test_loader_stats_surface_on_metrics_registry(tmp_path):
    from mlrun_tpu_torch.obs import REGISTRY

    seq = 2
    p = tmp_path / "shard.bin"
    _write_shard(p, list(range(12 * (seq + 1))))
    loader = TokenShardLoader(str(p), batch_size=1, seq_len=seq, workers=1)
    try:
        next(loader)
        text = REGISTRY.render()
        label = f'loader="{loader._obs_name}"'
        assert "mlt_train_loader_ring_occupancy{" in text
        assert label in text
        assert "mlt_train_loader_events_total{" in text
        assert f'{label},event="batches"' in text
    finally:
        loader.close()
    text = REGISTRY.render()
    assert f'loader="{loader._obs_name}"' not in text


def test_device_prefetch_preserves_order():
    batches = [(np.full((1, 2), i, np.int32),
                np.full((1, 2), i + 100, np.int32)) for i in range(5)]
    out = list(device_prefetch(iter(batches), device="cpu", depth=2))
    assert len(out) == 5
    for i, (tokens, targets) in enumerate(out):
        assert isinstance(tokens, torch.Tensor)
        assert tokens.dtype == torch.int32
        assert int(tokens[0, 0]) == i
        assert int(targets[0, 0]) == i + 100


@pytest.fixture(scope="module")
def reference_lib(tmp_path_factory):
    """The reference's loader built from its own source into a temporary
    directory (never by make in its package's directory)."""
    lib = tmp_path_factory.mktemp("reflib") / "libmlt_data.so"
    proc = subprocess.run(
        ["g++", *_build.HOST_FLAGS, "-o", str(lib),
         str(ROOT / "native" / "data_loader.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return str(lib)


@pytest.mark.parametrize("dtype", ["int32", "uint16"])
def test_batches_equal_the_reference_loader(tmp_path, reference_lib, dtype):
    """Two shards of random tokens, 3 epochs' worth of batches (the
    epoch reshuffles included), workers=1: every batch, total_tokens and
    epoch equal the reference loader's."""
    from mlrun_tpu.training.data import TokenShardLoader as JLoader

    rng = np.random.default_rng(5)
    limit = 60000 if dtype == "uint16" else 2 ** 31 - 1
    paths = []
    for s, n in enumerate((997, 613)):
        p = tmp_path / f"shard{s}.bin"
        _write_shard(p, rng.integers(0, limit, n), dtype=np.dtype(dtype))
        paths.append(str(p))
    kw = dict(batch_size=4, seq_len=16, dtype=dtype, seed=11, workers=1,
              queue_depth=3)
    with TokenShardLoader(paths, **kw) as ours, \
            JLoader(paths, lib_path=reference_lib, **kw) as ref:
        assert ours.total_tokens == ref.total_tokens
        for _ in range(3 * (997 + 613) // (17 * 4)):
            (a, b), (c, d) = next(ours), next(ref)
            assert a.dtype == c.dtype == np.int32
            assert np.array_equal(a, c) and np.array_equal(b, d)
        assert ours.epoch == ref.epoch >= 2


def test_loader_builds_from_the_port_copy_and_the_env_overrides(
        tmp_path, monkeypatch, reference_lib):
    """The default library is the port's own build of csrc/data_loader.cpp
    under build/host/; MLT_DATA_LOADER_LIB names another."""
    from mlrun_tpu_torch.training import data as tdata

    monkeypatch.delenv("MLT_DATA_LOADER_LIB", raising=False)
    built = Path(tdata._native_lib_path())
    assert built.parent.parent == _build.HOST_BUILD_ROOT
    assert built.name == "libmlt_data.so" and built.exists()
    monkeypatch.setenv("MLT_DATA_LOADER_LIB", reference_lib)
    assert tdata._native_lib_path() == reference_lib
