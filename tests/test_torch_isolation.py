"""The port package stands alone: nothing under mlrun_tpu_torch/ (nor the
chip smoke script and the port's profile scripts) imports JAX or the
reference package, and importing the serving and training paths pulls
neither into the process."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mlrun_tpu")
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "mlrun_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py", "scripts/profile_torch_serving.py",
       "scripts/profile_torch_training.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax_or_reference(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = sorted({m for m in _imported_roots(tree) if m in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_serving_import_pulls_in_no_jax_or_reference():
    code = (
        "import sys\n"
        "import mlrun_tpu_torch.serving.paged, mlrun_tpu_torch.serving.llm\n"
        "import mlrun_tpu_torch.models.convert\n"
        "import mlrun_tpu_torch.training.train\n"
        "import mlrun_tpu_torch.frameworks.torch.auto_trainer\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in %r)\n"
        "print(','.join(bad))\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"
