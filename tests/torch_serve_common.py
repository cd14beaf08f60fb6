"""Shared inputs and checks of the serving-plane and tuner parity tests
(``tests/test_torch_{registry,scheduler,router,routed,sssp_service,tune,
sharded_tier}.py``).

Graphs come from the reference's generators and are carried into the
port with ``convert.from_reference``, so both packages serve
byte-identical graphs.  Devices are ``[torch.device("cpu")] * k`` where
the reference's tests repeat ``jax.devices()[0]``.
"""
import functools

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import repro.data.generators as rgen
from repro_torch import convert
from test_torch_graph import ref_arrays

CPU = torch.device("cpu")

# the normalized metrics that the logical counters decide (the physical
# ones, n_tiles_* and n_invocations, count the blocked layout's work)
LOGICAL_KEYS = ("nFrontier", "nSync", "nTrav", "nTrav_push", "nTrav_pull",
                "n_steps", "n_rounds", "n_relax", "n_updates", "n_pruned",
                "reachable")


@pytest.fixture
def gloo_one(tmp_path):
    """A gloo process group of world size 1 in this process: the sharded
    tier at one rank (import the fixture into a test module to use it)."""
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    yield
    tdist.destroy_process_group()


def cpus(k: int = 2) -> list:
    """``k`` scheduler entries on the one CPU device."""
    return [CPU] * k


@functools.lru_cache(maxsize=None)
def graph(kind: str, *args, **kw):
    """``(reference HostGraph, port HostGraph)`` of
    ``repro.data.generators.<kind>(*args, **kw)``."""
    rg = getattr(rgen, kind)(*args, **kw)
    return rg, convert.from_reference(ref_arrays(rg), "cpu")


def port(kind: str, *args, **kw):
    return graph(kind, *args, **kw)[1]


def same_answer(a, b, what="") -> None:
    """Two ``QueryResult``s (either package) hold the same answer: dist
    bitwise, parent, the logical metrics and the kind's extras."""
    assert np.array_equal(np.asarray(a.dist, np.float32).view(np.int32),
                          np.asarray(b.dist, np.float32).view(np.int32)), what
    assert np.array_equal(np.asarray(a.parent), np.asarray(b.parent)), what
    assert {k: a.metrics[k] for k in LOGICAL_KEYS} \
        == {k: b.metrics[k] for k in LOGICAL_KEYS}, what
    assert (a.distance is None) == (b.distance is None), what
    if a.distance is not None:
        assert np.float32(a.distance).tobytes() \
            == np.float32(b.distance).tobytes(), what
    assert a.path == b.path, what
    assert a.nearest == b.nearest, what


def same_batch(port_out, ref_out, what="") -> None:
    """``run_batch`` outputs of both packages: dist bitwise, parent, and
    every logical counter per slot."""
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS
    pd, pp, pm = port_out
    rd, rp, rm = ref_out
    assert np.array_equal(pd.numpy().view(np.int32),
                          np.asarray(rd).view(np.int32)), what
    assert np.array_equal(pp.numpy(), np.asarray(rp)), what
    for f in LOGICAL_METRIC_FIELDS:
        assert np.array_equal(getattr(pm, f).numpy(),
                              np.asarray(getattr(rm, f))), (what, f)
