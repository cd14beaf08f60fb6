"""The transformer on DTensors (``act_placements``, the MoE experts per
rank, the decode step over a cache split by rows and positions) against
the one-device port on the same inputs, over four gloo ranks on a
(2, 2) ``data`` x ``model`` mesh on the CPU.

Each case of ``tests/torch_ranks_common.py::LM_CASES`` (qwen3 with its
sequence split over ``model``, deepseek-moe's expert parallelism and
granite-moe's expert-TP fallback, smoke configs in float32) runs with
the placements of ``parallel/sharding.py``'s rules: the forward's
logits and aux loss, then prefill and two decode steps over a cache
placed by ``lm_cache_specs(shard_seq=True)``.  Every rank's results
equal the one-device ``forward``/``prefill``/``decode_step`` within
1e-5 of each tensor's largest magnitude (the split matmuls and the
split softmax add in another order; measured: below 1.2e-6), and the
cache positions exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import transformer as T
from torch_ranks_common import LM_CACHE, LM_CASES, lm_case, shared_ranks

RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, worker_id):
    return shared_ranks(4, tmp_path_factory, worker_id, "lm")


def _one_device(arch):
    cfg, params, tokens, steps = lm_case(arch)
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        logits, aux = T.forward(cfg, params, tok, attn="plain")
        out = {"logits": logits, "aux": torch.as_tensor(aux)}
        cache, out["prefill"] = T.prefill(cfg, params, tok, LM_CACHE,
                                          attn="plain")
        for j, st in enumerate(steps):
            out[f"decode{j}"], cache = T.decode_step(
                cfg, params, cache, torch.from_numpy(st), attn="plain")
    out.update({f"cache_{k}": v for k, v in cache.items()})
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("arch", list(LM_CASES))
def test_sharded_lm_matches_one_device(arch, ranks):
    want = _one_device(arch)
    for rank, r in enumerate(ranks):
        got = {k.split("/", 1)[1]: v for k, v in r.items()
               if k.startswith(arch + "/")}
        assert set(got) == set(want), rank
        assert want["cache_pos"].dtype == np.int32
        for key, g in got.items():
            w = want[key]
            if key == "aux":        # a dense model's is the Python 0.0
                g, w = g.astype(np.float64), w.astype(np.float64)
            assert g.shape == w.shape and g.dtype == w.dtype, (rank, key)
            np.testing.assert_allclose(
                g, w, rtol=0, atol=RTOL * max(np.abs(w).max(), 1e-30),
                err_msg=f"rank {rank} {arch} {key}")
