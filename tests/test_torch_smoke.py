"""``chip_smoke.py``'s checks that need no card.

A profiled pass (``lm_profile``, ``recsys_profile``) reads the device time
by kernel from ``torch.profiler``.  A trace that recorded no CUDA kernel
once passed as 0 device ms; ``chip_smoke.trace_kernels`` now fails such a
pass, naming it.  Here a real CPU-only trace (which holds no CUDA kernel)
must fail, and a trace with CUDA entries must give exactly those.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def test_profiled_pass_without_a_kernel_fails():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).cumsum(0)
    events = prof.key_averages()
    assert len(events) > 0               # the pass was traced, on the host
    with pytest.raises(AssertionError,
                       match="recsys_profile retrieval_scores: .*no CUDA"):
        chip_smoke.trace_kernels(events, "recsys_profile retrieval_scores")


def test_trace_kernels_gives_the_cuda_entries():
    event = lambda key, kind: SimpleNamespace(key=key, device_type=kind)
    events = [event("aten::mm", DeviceType.CPU),
              event("bag_kernel", DeviceType.CUDA),
              event("cudaLaunchKernel", DeviceType.CPU),
              event("flash_fwd_tc", DeviceType.CUDA)]
    kern = chip_smoke.trace_kernels(events, "lm_profile prefill")
    assert [e.key for e in kern] == ["bag_kernel", "flash_fwd_tc"]
    with pytest.raises(AssertionError, match="lm_profile decode"):
        chip_smoke.trace_kernels(events[::2], "lm_profile decode")
