"""A fixture for the port's parity tests, which run the JAX reference in
the test process: free the XLA executables compiled so far when a test
module ends.

Each compiled XLA:CPU executable holds memory maps of its code, and JAX
keeps every executable it compiled in its caches.  A pytest-xdist worker
runs many modules in one process, so the maps add up:
``tests/test_alt_p2p.py`` alone leaves about 37,000 and
``tests/test_torch_distributed_v2.py`` about 30,000.  Past the Linux
default ``vm.max_map_count`` of 65,530 the next compile cannot map its
code and segfaults, which takes the worker and its test down.  A port
module imports :func:`release_compiled` (an autouse fixture), and at its
end ``jax.clear_caches()`` lets every executable compiled in the process
go, the reference's included.
"""
import gc

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def release_compiled():
    yield
    jax.clear_caches()
    gc.collect()
