"""The port's kernel-build cache (mlrun_tpu_torch.utils.compile_cache,
the counterpart of mlrun_tpu.utils.compile_cache): ``configure`` re-roots
both build directories of ``ops/_build.py`` and ``disable`` puts them
back; ``COMPILE_CACHE_ENV`` (the reference's name) reaches
``configure_from_mlconf`` and ``Trainer``; the g++ loader library builds
under the cache dir and a second process reuses it unchanged; the kernel
build key holds the toolkit's identity and the card's arch, and a process
without nvcc loads the library built for the same sources, flags and arch
(nvcc stands in for a recorder here: the CPU has none). A library already
loaded stays loaded when the cache is re-pointed.

Bounds: paths, hashes and file identities equal or different as stated.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mlrun_tpu.common.runtimes_constants import \
    COMPILE_CACHE_ENV as REFERENCE_ENV
from mlrun_tpu_torch.config import COMPILE_CACHE_ENV
from mlrun_tpu_torch.ops import _build
from mlrun_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _restore(monkeypatch):
    monkeypatch.delenv(COMPILE_CACHE_ENV, raising=False)
    yield
    compile_cache.disable()


def test_configure_reroots_both_builds_and_disable_restores(tmp_path):
    kernels, host = _build.BUILD_ROOT, _build.HOST_BUILD_ROOT
    assert compile_cache.configure("") is None
    assert compile_cache.configure(str(tmp_path)) == str(tmp_path)
    assert compile_cache.configured_dir() == str(tmp_path)
    assert _build.BUILD_ROOT == tmp_path / "kernels"
    assert _build.HOST_BUILD_ROOT == tmp_path / "host"
    compile_cache.disable()
    assert compile_cache.configured_dir() is None
    assert (_build.BUILD_ROOT, _build.HOST_BUILD_ROOT) == (kernels, host)


def test_env_reaches_configure_from_mlconf_and_the_trainer(tmp_path,
                                                          monkeypatch):
    from mlrun_tpu_torch.models.llama import tiny_llama
    from mlrun_tpu_torch.training import Trainer

    assert COMPILE_CACHE_ENV == REFERENCE_ENV
    assert compile_cache.configure_from_mlconf() is None
    monkeypatch.setenv(COMPILE_CACHE_ENV, str(tmp_path / "a"))
    assert compile_cache.configure_from_mlconf() == str(tmp_path / "a")
    monkeypatch.setenv(COMPILE_CACHE_ENV, str(tmp_path / "b"))
    Trainer(tiny_llama(dtype=torch.float32), device="cpu")
    assert compile_cache.configured_dir() == str(tmp_path / "b")


def test_host_build_lands_in_the_cache_and_a_second_process_reuses_it(
        tmp_path):
    from mlrun_tpu_torch.training import data as tdata

    compile_cache.configure(str(tmp_path))
    built = Path(tdata._native_lib_path())
    assert built.parent.parent == tmp_path / "host" and built.exists()
    before = built.stat()
    code = ("from mlrun_tpu_torch.utils import compile_cache\n"
            "compile_cache.configure_from_mlconf()\n"
            "from mlrun_tpu_torch.training import data\n"
            "print(data._native_lib_path())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               **{COMPILE_CACHE_ENV: str(tmp_path)})
    env.pop("MLT_DATA_LOADER_LIB", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(built)
    after = built.stat()
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                  before.st_mtime_ns)


class _FakeNvcc:
    """Stands in for nvcc: ``--version`` prints ``identity``; compile and
    link commands create their outputs."""

    def __init__(self):
        self.identity = "Cuda compilation tools, release 12.4, V12.4.131"
        self.compiles = 0

    def __call__(self, cmd):
        if "--version" in cmd:
            return self.identity
        self.compiles += "-c" in cmd
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return "ptxas info"


def test_kernel_key_holds_toolkit_and_arch_and_no_nvcc_loads(tmp_path,
                                                              monkeypatch):
    nvcc = _FakeNvcc()
    monkeypatch.setattr(_build, "_run", nvcc)
    monkeypatch.setattr(_build, "_toolkits", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(_build, "card_arch", lambda: "sm_90")
    compile_cache.configure(str(tmp_path))
    first = _build.build()
    assert first.parent.parent == tmp_path / "kernels"
    assert nvcc.compiles == len(_build.sources())
    assert _build.build() == first and nvcc.compiles == len(_build.sources())

    # another toolkit: another key, another build
    nvcc.identity = "Cuda compilation tools, release 12.8, V12.8.93"
    monkeypatch.setattr(_build, "_toolkits", {})
    second = _build.build()
    assert second.parent != first.parent
    assert _build._source_hash("a", "sm_90") != \
        _build._source_hash("b", "sm_90")
    assert _build._source_hash("a", "sm_90") != \
        _build._source_hash("a", "sm_100")

    # no nvcc: the newest library for these sources, flags and arch
    def missing():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", missing)
    os.utime(first, (1, 1))
    assert _build.build() == second
    monkeypatch.setattr(_build, "card_arch", lambda: "sm_100")
    with pytest.raises(_build.KernelBuildError):
        _build.build()


def test_a_loaded_library_is_kept_when_the_cache_moves(tmp_path,
                                                        monkeypatch):
    loaded = object()
    monkeypatch.setattr(_build._state, "lib", loaded)
    compile_cache.configure(str(tmp_path / "x"))
    assert _build.library() is loaded
    assert _build.BUILD_ROOT == tmp_path / "x" / "kernels"
