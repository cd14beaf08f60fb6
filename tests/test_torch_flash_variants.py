"""The flash kernel's four designs and the split-KV decode's algebra, on
the CPU.

``ops.variant`` names the design that serves a call on the card:
``"tc"`` (bf16 tensor cores, prefill), ``"split"`` (split-KV decode),
``"split_tc"`` (split-KV on the tensor cores, 9 to 63 rows) or
``"simt"`` (f32 on the CUDA cores); ``ops.split_count`` sizes the decode
splits.  ``flash_attention_split_ref`` states the split design as plain
torch, chunk partials ``(m, l, acc)`` merged in chunk order, and is held
against the dense plain version and the JAX package's
``flash_attention_ref`` at 1e-6 in float32: chunking changes only the
order of the f32 sums.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attn.ops import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attn import ops
from repro_torch.models.transformer import ring_positions
from release_xla import release_compiled  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,d,rows,want", [
    (torch.bfloat16, 128, 2 * 2048, "tc"),    # qwen3-0.6b prefill, S = 2048
    (torch.bfloat16, 128, 2 * 256, "tc"),     # the shortest padded prompt
    (torch.bfloat16, 64, 64, "tc"),           # one warpgroup's rows
    (torch.bfloat16, 128, 2, "split"),        # qwen3-0.6b decode: S = 1
    (torch.float32, 128, 2, "split"),
    (torch.bfloat16, 16, 8, "split"),
    (torch.float32, 128, 2 * 2048, "simt"),   # f32 keeps its 2e-5
    (torch.bfloat16, 16, 4096, "simt"),
    (torch.bfloat16, 32, 4096, "simt"),
    (torch.bfloat16, 128, 63, "split_tc"),    # below one warpgroup's rows
    (torch.bfloat16, 128, 9, "split_tc"),
    (torch.bfloat16, 128, 48, "split_tc"),    # granite-34b decode (MQA)
    (torch.float32, 128, 48, "simt"),         # f32 keeps its 2e-5
    (torch.bfloat16, 32, 48, "simt"),         # no wgmma head width
], ids=lambda x: str(x).replace("torch.", ""))
def test_variant_picks_the_design(dtype, d, rows, want):
    assert ops.variant(dtype, d, rows) == want
    assert want in ops.VARIANTS


@pytest.mark.parametrize("b,kv,t,sms,want", [
    (8, 8, 4096, 132, 4),       # the serving decode: 256 blocks, 2 per SM
    (1, 8, 4096, 132, 32),      # one slot: 32 chunks of 128 keys
    (1, 8, 300, 132, 3),        # capped by SPLIT_MIN_KEYS
    (64, 8, 4096, 132, 1),      # more heads than SMs: no split
    (2, 1, 0, 132, 1),          # an empty cache still gets one chunk
    (4, 1, 512, 132, 4),        # granite-34b's decode in split's chunks
])
def test_split_count(b, kv, t, sms, want):
    assert ops.split_count(b, kv, t, sms) == want


@pytest.mark.parametrize("b,kv,t,sms,want", [
    (4, 1, 512, 132, 8),        # granite-34b's decode: one tile a chunk
    (4, 1, 4096, 132, 64),      # a long cache: two blocks per SM
    (1, 1, 100, 132, 2),        # a chunk is whole tiles of 64 keys
])
def test_split_count_split_tc(b, kv, t, sms, want):
    assert ops.split_count(b, kv, t, sms, ops.SPLIT_TC_MIN_KEYS) == want


def _inputs(rng, b, s, kv, hg, d, t):
    f = lambda *shape: torch.from_numpy(rng.normal(0, 1, shape).astype(
        np.float32))
    return f(b, s, kv, hg, d), f(b, t, kv, d), f(b, t, kv, d)


@pytest.mark.parametrize("n_split", [1, 3, 8])
@pytest.mark.parametrize("kind", ["arange", "padded", "ring", "window",
                                  "empty-chunks", "query-chunk"])
def test_split_ref_matches_plain_version(kind, n_split):
    rng = np.random.default_rng(len(kind))
    b, kv, hg, d, t = 3, 2, 2, 32, 300
    s, window = (4, 0) if kind == "query-chunk" else (1, 0)
    q, k, v = _inputs(rng, b, s, kv, hg, d, t)
    pos = torch.from_numpy(rng.integers(0, 2 * t, b).astype(np.int32))
    q_pos, k_pos = pos[:, None], None
    if kind == "padded":        # -1 keys, and a row that sees none at all
        k_pos = torch.arange(t, dtype=torch.int32).expand(b, t).clone()
        k_pos[:, torch.from_numpy(rng.integers(0, t, t // 3))] = -1
        k_pos[1] = -1
    elif kind == "ring":
        k_pos = ring_positions(pos, t)
    elif kind == "window":
        window = 31
    elif kind == "empty-chunks":  # 1..10 visible keys: chunks past them
        q_pos = torch.tensor([[5], [0], [9]], dtype=torch.int32)
    elif kind == "query-chunk":   # rows at 300..303 over keys 0..299
        q_pos = (300 + torch.arange(s, dtype=torch.int32)).expand(b, s)
    kw = dict(causal=True, window=window)
    got = ops.flash_attention_split_ref(q, k, v, q_pos, k_pos,
                                        n_split=n_split, **kw)
    want = ops.flash_attention_pos_ref(q, k, v, q_pos, k_pos, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)
    if kind == "padded":
        assert torch.equal(got[1], torch.zeros_like(got[1]))


@pytest.mark.parametrize("n_split", [1, 3, 8])
@pytest.mark.parametrize("causal,window,s,t", [
    (True, 0, 37, 37), (True, 9, 37, 37), (False, 0, 1, 50),
    (False, 13, 5, 40),
])
def test_split_ref_matches_reference(causal, window, s, t, n_split):
    # the reference's [B, H, S, D] form (queries at 0..S-1, keys at
    # 0..T-1), 8 query heads over 2 KV heads
    rng = np.random.default_rng(s * t + window)
    b, h, h_kv, d = 2, 8, 2, 16
    q = rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, h_kv, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, h_kv, t, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    q5 = tq.unflatten(1, (h_kv, h // h_kv)).permute(0, 3, 1, 2, 4)
    got = ops.flash_attention_split_ref(
        q5, tk.transpose(1, 2), tv.transpose(1, 2), causal=causal,
        window=window, n_split=n_split)
    got = got.permute(0, 2, 3, 1, 4).reshape(b, h, s, d)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
