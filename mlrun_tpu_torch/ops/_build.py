"""Build and bind the hand-written CUDA kernels of ``mlrun_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per
source, all started together, then one link) into a single shared library
with a plain C interface, loaded with :mod:`ctypes`. PyTorch's headers are
never included, which keeps the build to seconds. The library lands under
``build/kernels/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources, the flags, the toolkit
(``nvcc --version``) and the card's arch, so it is built at first use and
rebuilt whenever one of them changes. ``utils/compile_cache.configure``
re-roots :data:`BUILD_ROOT` and :data:`HOST_BUILD_ROOT` under a persistent
directory; a process with no ``nvcc`` then loads the library built there
for the same sources, flags and arch.

Importing this module needs neither ``nvcc`` nor a GPU: the build runs the
first time a wrapper is handed a CUDA tensor (or :func:`library` is called).

Host code (``csrc/*.cpp``: the token-shard loader) takes a route of its
own, :func:`build_host`: one ``g++`` call into ``build/host/<hash>/``, so
it builds wherever a C++ compiler is, with or without a GPU.

Every wrapper passes its launch's return code to :func:`check_launch`,
which raises on an error and otherwise counts the launch;
:func:`launch_counts` / :func:`reset_launch_counts` let a run show which
kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libmlt_kernels.so"
HOST_BUILD_ROOT = BUILD_ROOT.parent / "host"
HOST_FLAGS = ("-O2", "-std=c++17", "-pthread", "-shared", "-fPIC")
# a host program (csrc/log_collector.cpp's daemon): the same flags, linked
# as an executable
HOST_EXE_FLAGS = ("-O2", "-std=c++17", "-pthread")

# dtype codes shared with csrc/common.cuh (float16: csrc/rms_norm.cu only)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
FLOAT16_CODE = 2
# kernel names, one counter each
KERNELS = ("paged_decode", "flash_fwd_cached", "paged_prefill", "flash_fwd",
           "flash_bwd", "paged_decode_int8", "paged_prefill_int8",
           "paged_verify", "paged_verify_int8", "flash_v1", "rms_norm",
           "grad_sqnorm", "adamw")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "mlt_paged_decode": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _F, _P],
    "mlt_flash_fwd_cached": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _F, _P],
    "mlt_paged_prefill": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _F, _P],
    "mlt_paged_decode_int8": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "mlt_paged_prefill_int8": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _F, _P],
    "mlt_paged_verify": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "mlt_flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                      _P],
    "mlt_flash_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, _I, _I, _F, _P],
    "mlt_rms_norm": [_I, _I, _P, _P, _P, _I, _I, _F, _P],
    "mlt_grad_sqnorm_scratch": [_I],
    "mlt_grad_sqnorm": [_I, _P, _P, _P, _P, _I, _P, _I, _F, _P],
    "mlt_adamw": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F,
                  _F, _F, _F, _I, _F, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its log."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error (or a refused argument)."""


class _State:
    """Process-wide library handle, build record and launch counters (one
    set per process, like the CUDA context they belong to)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib = None
        self.lib_path = None
        self.launches = dict.fromkeys(KERNELS, 0)


_state = _State()


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _sources_digest() -> str:
    """Hash of the flags and every kernel source."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()


def _source_hash(toolkit: str, arch: str) -> str:
    """The build directory's name: the sources and flags, the toolkit's
    identity and the card's arch."""
    digest = hashlib.sha256(_sources_digest().encode())
    digest.update(toolkit.encode())
    digest.update(arch.encode())
    return digest.hexdigest()[:16]


_toolkits: dict = {}


def toolkit_identity(nvcc: str) -> str:
    """``nvcc --version``'s text (cached per path): two toolkits never
    share a build directory."""
    if nvcc not in _toolkits:
        _toolkits[nvcc] = _run([nvcc, "--version"]).strip()
    return _toolkits[nvcc]


def card_arch() -> str:
    """``sm_<major><minor>`` of the current CUDA device ('' without one)."""
    import torch

    if not torch.cuda.is_available():
        return ""
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


KEY_NAME = "build.key"


def _prebuilt(arch: str):
    """Without nvcc: the newest finished library under :data:`BUILD_ROOT`
    whose key names these sources, flags and arch (any toolkit — this
    process has none to tell apart), else None."""
    want = f"{_sources_digest()} {arch}"
    found = []
    for key in BUILD_ROOT.glob(f"*/{KEY_NAME}"):
        lib_path = key.parent / LIB_NAME
        if lib_path.exists() and \
                key.read_text().split("\n", 1)[0] == want:
            found.append(lib_path)
    return max(found, key=lambda p: p.stat().st_mtime) if found else None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (the toolkit PyTorch itself would use), else
    ``nvcc`` on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "mlrun_tpu_torch CUDA kernels are built from source at first use")
    return found


def _run(cmd: list) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelBuildError(f"{' '.join(cmd)} failed:\n{log}")
    return log


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link one library; returns
    its path. A finished build for the same sources, flags, toolkit and
    arch is reused; with no nvcc, one for the same sources, flags and arch
    (:func:`_prebuilt`)."""
    arch = card_arch()
    try:
        nvcc = find_nvcc()
    except KernelBuildError:
        prebuilt = _prebuilt(arch)
        if prebuilt is None:
            raise
        return prebuilt
    toolkit = toolkit_identity(nvcc)
    out_dir = BUILD_ROOT / _source_hash(toolkit, arch)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    objects = [out_dir / (src.stem + ".o") for src in sources()]
    compile_cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                     "-o", str(obj)] for src, obj in zip(sources(), objects)]
    with ThreadPoolExecutor(max_workers=len(compile_cmds)) as pool:
        logs = list(pool.map(_run, compile_cmds))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    logs.append(_run([nvcc, "-shared", "-gencode",
                      "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                      *map(str, objects)]))
    (out_dir / "build.log").write_text("\n".join(logs))
    (out_dir / KEY_NAME).write_text(
        f"{_sources_digest()} {arch}\n{toolkit}\n")
    os.replace(tmp, lib_path)  # atomic: a reader never sees a partial .so
    return lib_path


def build_host(source, lib_name: str, executable: bool = False) -> Path:
    """Compile one host C++ ``source`` into the shared library
    ``lib_name`` (or, with ``executable``, the program ``lib_name``) with
    ``g++`` (``$CXX`` when set) and :data:`HOST_FLAGS` (or
    :data:`HOST_EXE_FLAGS`); returns its path. A finished build of the
    same source and flags is reused."""
    source = Path(source)
    flags = HOST_EXE_FLAGS if executable else HOST_FLAGS
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(source.read_bytes())
    out_dir = HOST_BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / lib_name
    if lib_path.exists():
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise KernelBuildError(
            f"no C++ compiler (g++ or $CXX) to build {source.name}")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib_name}.{os.getpid()}.tmp"
    log = _run([cxx, *flags, "-o", str(tmp), str(source)])
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, lib_path)  # atomic: a reader never sees a partial file
    return lib_path


def library():
    """The bound kernel library, built on first call. It stays loaded for
    the process: re-rooting the build afterwards does not swap it."""
    with _state.lock:
        if _state.lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _state.lib = lib
            _state.lib_path = path
        return _state.lib


def build_log() -> str:
    """nvcc's log of the loaded library's build (ptxas registers, shared
    memory and spills per kernel); call after :func:`library`."""
    return (_state.lib_path.parent / "build.log").read_text()


# the bf16 kernels that run on the tensor cores (csrc/flash_fwd_tc.cu,
# csrc/flash_bwd_tc.cu, the bf16 body of csrc/paged_prefill.cu):
# substrings of their symbols
TENSOR_CORE_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                       "flash_bwd_dkdv_tc_kernel", "paged_prefill_tc_kernel",
                       "paged_verify_tc_kernel")
_MMA_OPCODES = ("HMMA", "HGMMA")


def tensor_core_counts(sass: str) -> dict:
    """Tensor-core instructions (``HMMA``/``HGMMA``) per kernel symbol in
    the text of ``cuobjdump -sass``."""
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            current = line.split("Function : ", 1)[1].strip()
            counts.setdefault(current, 0)
        elif current is not None and any(op in line for op in _MMA_OPCODES):
            counts[current] += 1
    return counts


def library_sass() -> str:
    """``cuobjdump -sass`` of the loaded library (call after
    :func:`library`); cuobjdump sits beside nvcc in the toolkit."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    return _run([str(cuobjdump), "-sass", str(_state.lib_path)])


def ptxas_spills(log: str) -> dict:
    """Bytes of spill stores per kernel symbol from ptxas' ``-v`` report
    (``Function properties for <symbol>`` then ``N bytes spill stores``)."""
    spills, current = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            current = line.split("Function properties for ", 1)[1].strip()
        elif current is not None and "bytes spill stores" in line:
            before = line.split("bytes spill stores")[0].split(",")[-1]
            spills[current] = int(before.split()[0])
            current = None
    return spills


def dtype_code(tensor) -> int:
    code = DTYPE_CODES.get(str(tensor.dtype))
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got "
                        f"{tensor.dtype}")
    return code


def check_launch(name: str, err: int):
    """Raise on a failed launch; otherwise count it."""
    if err != 0:
        what = ("argument refused by the kernel" if err < 0
                else f"CUDA error {err}")
        raise KernelLaunchError(f"{name}: {what}")
    with _state.lock:
        _state.launches[name] += 1


def launch_counts() -> dict:
    with _state.lock:
        return dict(_state.launches)


def reset_launch_counts():
    with _state.lock:
        for name in _state.launches:
            _state.launches[name] = 0


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
