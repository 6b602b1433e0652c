"""The harness's tests import the port from `src/` and the harness as the
package `portbench`.  A test worker may also have run the JAX package's
tests, which the benchmark's process never does: the JAX modules are
hidden from `sys.modules` while a test here runs, so that the harness's
own look for them sees this test's modules only.  The runs here are tiny:
they take one host thread, so that a loaded test machine slows them
least."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


@pytest.fixture(autouse=True)
def _hide_jax_modules(monkeypatch):
    from portbench import harness
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN_MODULES:
            monkeypatch.delitem(sys.modules, name)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
