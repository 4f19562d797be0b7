"""The build report parsers of ``mlrun_tpu_torch/ops/_build.py`` on the
CPU: chip_smoke.py's build phase reads with them that every bf16 flash
kernel holds tensor-core instructions and spills nothing."""

import pytest

from mlrun_tpu_torch.ops import _build

SASS = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi64ELb1EEEvPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   LDSM.16.M88.4 R8, [R2] ;
        /*0110*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
        /*0120*/                   HMMA.16816.F32.BF16 R16, R4, R10, R16 ;
		Function : _ZN12_GLOBAL__N_123flash_fwd_cached_kernelIfLi64ELb1EEEvPKT_
        /*0100*/                   FFMA R1, R2, R3, R1 ;
		Function : _ZN12_GLOBAL__N_124flash_bwd_dkdv_tc_kernelILi64EEEvPK13__nv_bfloat16
        /*0300*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
"""

PTXAS = """
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
ptxas info    : Function properties for _Z3barPf
    112 bytes stack frame, 140 bytes spill stores, 140 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_tensor_core_counts_per_symbol():
    counts = _build.tensor_core_counts(SASS)
    fwd = "_ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi64ELb1EEEvPK13__nv_bfloat16"
    fma = "_ZN12_GLOBAL__N_123flash_fwd_cached_kernelIfLi64ELb1EEEvPKT_"
    bwd = ("_ZN12_GLOBAL__N_124flash_bwd_dkdv_tc_kernelILi64EEEvPK13"
           "__nv_bfloat16")
    assert counts == {fwd: 2, fma: 0, bwd: 1}
    tc = [n for n in counts if any(k in n for k in _build.TENSOR_CORE_KERNELS)]
    assert sorted(tc) == sorted([fwd, bwd])


@pytest.mark.parametrize("text,expected", [
    (PTXAS, {"_Z3fooPf": 0, "_Z3barPf": 140}),
    ("", {}),
])
def test_ptxas_spills_per_symbol(text, expected):
    assert _build.ptxas_spills(text) == expected


def _package_data() -> dict:
    """``setup.py``'s ``package_data`` literal, read with ``ast`` (the
    script is not run)."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / "setup.py")
                     .read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "package_data":
            return ast.literal_eval(node.value)
    raise AssertionError("setup.py has no package_data")


def test_package_data_ships_every_source_the_port_builds(monkeypatch):
    """A pip-installed port holds every file ``ops/_build.py`` compiles or
    includes (the kernel sources, their headers, the C++ sources that
    ``build_host`` compiles: the token-shard loader's library and the log
    collector's daemon) and every hub function yaml it ships (ROADMAP
    3.12)."""
    from fnmatch import fnmatch
    from pathlib import Path

    from mlrun_tpu_torch.training import data
    from mlrun_tpu_torch.utils import log_collector

    root = Path(_build.__file__).resolve().parents[1]
    globs = _package_data()["mlrun_tpu_torch"]
    host = []
    monkeypatch.delenv("MLT_DATA_LOADER_LIB", raising=False)
    monkeypatch.setattr(_build, "build_host",
                        lambda source, name, executable=False:
                        host.append(Path(source)))
    monkeypatch.setattr(log_collector, "binary_path",
                        lambda: str(root / "no-such-daemon"))
    data._native_lib_path()
    log_collector.build_binary()
    hub = sorted(root.glob("hub_functions/*/function.yaml"))
    files = sorted(set(_build.sources()) | set(_build.CSRC.glob("*.cu*"))
                   | set(host) | set(hub))
    assert [p.name for p in host] == ["data_loader.cpp",
                                      "log_collector.cpp"]
    assert len(hub) == 6
    missing = [str(f.relative_to(root)) for f in files
               if not any(fnmatch(str(f.relative_to(root)), g)
                          for g in globs)]
    assert not missing, f"not in package_data: {missing}"
