"""torch on one intra-op thread for a test module of many small ops.

Under the suite's parallel workers (``-n 6`` on an 8-core machine),
torch's default of one intra-op thread per core oversubscribes the cores:
a module whose time goes to many small ops (a tiny model's decode loops,
a tile-by-tile emulation) then runs tens of times slower than alone
(tests/test_torch_dense.py's LLMEngine tests 40-80x, the flash numerics
emulation about 45x, in a six-worker run of the whole suite). Their
results do not depend on the thread count.

Import the fixture into a test module to arm it there::

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module; the count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
