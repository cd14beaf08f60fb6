"""Flash attention of the port against the JAX package, on the CPU.

The port's wrapper sends CPU tensors to its plain version (f32 inside),
so these tests hold ``repro_torch.kernels.flash_attn`` against the
reference's Pallas kernel (``interpret=True``, as its own tests run it),
its ``ref.py``, and the model's ``_sdpa_blockwise`` / ``_sdpa_dense`` on
the same numpy-seeded inputs.  Tolerances are the reference kernel
tests': 2e-5 in float32, 2e-2 in bfloat16 (every side is f32 inside and
rounds only its output).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attn.ops import (flash_attention as jax_flash,
                                          flash_attention_ref as jax_ref)
from repro.models import transformer as JT
from repro_torch.kernels.flash_attn import ops
from repro_torch.models.transformer import ring_positions
from release_xla import release_compiled  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 4, 2, 200, 32), (1, 8, 8, 130, 64), (2, 2, 1, 64, 128),
    (1, 4, 4, 257, 16),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 31),
                                           (False, 0)])
def test_flash_attention_matches_reference_kernel(b, h, hkv, s, d, causal,
                                                  window):
    rng = np.random.default_rng(s + d)
    jq, tq = _both(rng.normal(0, 1, (b, h, s, d)).astype(np.float32))
    jk, tk = _both(rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32))
    jv, tv = _both(rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32))
    before = ops.LAUNCHES.flash_attention
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert ops.LAUNCHES.flash_attention == before   # CPU: the plain version
    assert out.shape == tq.shape and out.dtype == torch.float32
    kernel = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=64, block_k=64, interpret=True)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    for want in (kernel, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_flash_attention_dtypes(dtype, tol):
    rng = np.random.default_rng(9)
    shapes = [(1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)]
    arrays = [rng.normal(0, 1, sh).astype(np.float32) for sh in shapes]
    jax_in = [jnp.asarray(a).astype(dtype) for a in arrays]
    torch_in = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in jax_in]    # the same rounded values
    out = ops.flash_attention(*torch_in, causal=True)
    assert out.dtype == getattr(torch, dtype)
    for want in (jax_flash(*jax_in, causal=True, interpret=True),
                 jax_ref(*jax_in, causal=True)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def _lm_cfg(window):
    return JT.LMConfig(name="attn-t", n_layers=1, d_model=64, n_heads=8,
                       n_kv=2, d_ff=64, vocab=32, head_dim=32,
                       attn_window=window, dtype=jnp.float32)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("kind", ["padded", "ring", "chunk"])
def test_position_form_matches_model_attention(window, kind):
    # the model path's call: q [B,S,KV,HG,D] over keys at explicit
    # positions; padded = -1 keys (never attended), ring = a ring buffer's
    # positions (negative in lap 0), chunk = a query chunk at offset 300
    # over a causal prefix
    rng = np.random.default_rng(len(kind) + window)
    b, kv, hg, d = 3, 2, 4, 32
    s, t = (1, 96) if kind == "ring" else (70, 400)
    if kind == "padded":
        q_pos = np.tile(np.arange(300, 300 + s, dtype=np.int32), (b, 1))
        t_pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
        t_pos[rng.random((b, t)) < 0.3] = -1
    elif kind == "ring":
        pos = np.array([5, 96 + 40, 3 * 96 + 95], np.int32)
        q_pos = pos[:, None]
        t_pos = ring_positions(torch.from_numpy(pos), t).numpy()
    else:
        q_pos = np.tile(np.arange(300, 300 + s, dtype=np.int32), (b, 1))
        t_pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jq, tq = _both(rng.normal(0, 1, (b, s, kv, hg, d)).astype(np.float32))
    jk, tk = _both(rng.normal(0, 1, (b, t, kv, d)).astype(np.float32))
    jv, tv = _both(rng.normal(0, 1, (b, t, kv, d)).astype(np.float32))
    jqp, tqp = _both(q_pos)
    jtp, ttp = _both(t_pos)
    cfg = _lm_cfg(window)
    out = ops.flash_attention_pos(tq, tk, tv, tqp, ttp, causal=True,
                                  window=window).numpy()
    want = JT._sdpa_blockwise(cfg, jq, jk, jv, jqp, jtp, True, block_q=32,
                              block_k=64)
    np.testing.assert_allclose(out, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    if (t_pos >= 0).all():      # the dense path has no position >= 0 test
        for causal in (True, False):
            out = ops.flash_attention_pos(tq, tk, tv, tqp, ttp,
                                          causal=causal,
                                          window=window).numpy()
            want = JT._sdpa_dense(cfg, jq, jk, jv, jqp, jtp, causal)
            np.testing.assert_allclose(out, np.asarray(want), rtol=F32_TOL,
                                       atol=F32_TOL)


def test_position_form_defaults_are_the_kernel_function():
    # q_pos = k_pos = None is the reference kernel's own function (keys at
    # 0..T-1); a row with no visible key gives 0
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(0, 1, (2, 50, 2, 2, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (2, 50, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (2, 50, 2, 16)).astype(np.float32))
    ar = torch.arange(50, dtype=torch.int32).expand(2, 50)
    for window in (0, 7):
        a = ops.flash_attention_pos(q, k, v, causal=True, window=window)
        b_ = ops.flash_attention_pos(q, k, v, ar, ar, causal=True,
                                     window=window)
        assert torch.equal(a, b_)
    none_visible = ops.flash_attention_pos(q, k, v, ar - 100, ar,
                                           causal=True)
    assert torch.equal(none_visible, torch.zeros_like(none_visible))
