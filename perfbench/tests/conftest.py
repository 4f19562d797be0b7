"""The benchmark's own tests: the harness's modules and the reference are
imported from ``perfbench/`` (put on the path here), never the JAX
package. Run them from the root of the checkout:

    python -m pytest perfbench/tests -q

Tests marked ``cuda`` need an NVIDIA card and skip without one; each
decides inside the test.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU, skips without one")
