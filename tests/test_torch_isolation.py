"""The port package stands alone: nothing under mlrun_tpu_torch/ (its obs/,
chaos/ and common/ copies, the engine fleet, the canary router, the
health scorer, the model families, the structured callbacks, the
HuggingFace loader, the datastore, the meshes and sharding, ring and
Ulysses attention, the goodput ledger, tensor parallelism, the pipeline
stages and the elastic guard included, nor the chip smoke
script
and the port's profile scripts) imports JAX or the reference package, and
importing the serving, fleet, telemetry, model, training, datastore and
parallel paths pulls neither into the process. The multi-rank test
helper (tests/torch_ranks.py), whose ranks run the port alone, is held to
the same rule."""

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
    + ["chip_smoke.py", "tests/torch_ranks.py",
       "scripts/profile_torch_serving.py",
       "scripts/profile_torch_training.py", "scripts/time_paged_kernels.py"]


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
        "import mlrun_tpu_torch.serving.speculative\n"
        "import mlrun_tpu_torch.serving.kv_tier\n"
        "import mlrun_tpu_torch.serving.fleet, mlrun_tpu_torch.serving.canary\n"
        "import mlrun_tpu_torch.serving.v2_serving\n"
        "import mlrun_tpu_torch.obs.health, mlrun_tpu_torch.common.retry\n"
        "import mlrun_tpu_torch.obs, mlrun_tpu_torch.chaos\n"
        "import mlrun_tpu_torch.models.convert\n"
        "import mlrun_tpu_torch.training.train\n"
        "import mlrun_tpu_torch.models.moe, mlrun_tpu_torch.models.bert\n"
        "import mlrun_tpu_torch.models.vit, mlrun_tpu_torch.models.t5\n"
        "import mlrun_tpu_torch.frameworks.torch.auto_trainer\n"
        "import mlrun_tpu_torch.frameworks._common.callbacks\n"
        "import mlrun_tpu_torch.frameworks.huggingface\n"
        "import mlrun_tpu_torch.training.data\n"
        "import mlrun_tpu_torch.datastore, mlrun_tpu_torch.artifacts.model\n"
        "import mlrun_tpu_torch.parallel.mesh\n"
        "import mlrun_tpu_torch.parallel.sharding\n"
        "import mlrun_tpu_torch.ops.ring_attention\n"
        "import mlrun_tpu_torch.ops.ulysses, mlrun_tpu_torch.models.llama_cp\n"
        "import mlrun_tpu_torch.obs.goodput\n"
        "import mlrun_tpu_torch.training.checkpoint\n"
        "import mlrun_tpu_torch.parallel.tensor\n"
        "import mlrun_tpu_torch.parallel.pipeline\n"
        "import mlrun_tpu_torch.training.elastic\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in %r)\n"
        "print(','.join(bad))\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"
