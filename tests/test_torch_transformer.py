"""The port's LM against the JAX package, on the CPU.

Parameters are drawn by the reference's ``init_params`` and carried into
the port with ``lm_params_from_reference``; tokens come from numpy.  The
port runs its plain attention (``attn="plain"``, the reference's own
paths translated op for op) and, where named, the flash kernel's plain
version (``attn="flash"``, f32 inside); the reference runs under
``jax.jit``, as its serving engine runs it.  Tolerances: float32 at rtol
1e-4, atol 1e-5 (XLA and torch round ``rsqrt`` and the sums of the matrix
products differently), with atol 5e-5 for the keys of the 1460-token
prompt (XLA's fused ``cos``/``sin`` at angles up to 1460 rad differ from
its own unfused ones by up to 1.8e-5 there; torch agrees with the unfused
ones to 5e-7); bfloat16 at a max |difference| of 2e-2
of the reference's largest |value| (both sides round every product to
bf16, XLA after a fused chain of element-wise ops and torch after each
op: on the smoke model each side lies about 1.5% of that scale from a
float32 run of the same bf16 weights, and the two about 1.2% apart).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import qwen3_0_6b as jax_qwen, qwen3_0_6b_swa as jax_swa
from repro.models import transformer as JT
from repro_torch.configs import qwen3_0_6b, qwen3_0_6b_swa
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import transformer as T
from release_xla import release_compiled  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
F32_LONG = dict(rtol=1e-4, atol=5e-5)
BF16 = dict(of_scale=2e-2)

ARCHS = {"qwen3-0.6b": (jax_qwen, qwen3_0_6b),
         "qwen3-0.6b-swa": (jax_swa, qwen3_0_6b_swa)}


def _flatten(params) -> dict:
    out = {}
    for key, val in params.items():
        if key == "layers":
            out.update({f"layers/{n}": np.asarray(a, np.float32)
                        for n, a in val.items()})
        else:
            out[key] = np.asarray(val, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _models(arch, dtype="float32"):
    jmod, tmod = ARCHS[arch]
    jcfg = jmod.smoke_config()
    tcfg = tmod.smoke_config()
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_reference(_flatten(jparams), tcfg.dtype,
                                       "cpu")
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def _jax(jcfg):
    """The reference's entry points for ``jcfg``, jitted."""
    return dict(
        forward=jax.jit(lambda p, t: JT.forward(jcfg, p, t)),
        prefill=jax.jit(lambda p, t, s_cache, chunks: JT.prefill(
            jcfg, p, t, s_cache, batch_chunks=chunks),
            static_argnums=(2, 3)),
        decode=jax.jit(lambda p, c, t: JT.decode_step(jcfg, p, c, t)))


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if "of_scale" in tol:
        gap = np.abs(got - want).max()
        assert gap <= tol["of_scale"] * np.abs(want).max(), \
            (gap, np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, **tol)


def _tokens(rng, vocab, b, s):
    t = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


def test_config_and_param_count_match_reference():
    for arch, (jmod, tmod) in ARCHS.items():
        jc, tc = jmod.make_config(), tmod.make_config()
        assert tc.param_count() == jc.param_count(), arch
        assert (tc.hd, tc.n_layers, tc.vocab, tc.attn_window) == \
            (jc.hd, jc.n_layers, jc.vocab, jc.attn_window)
        assert tc.dtype == torch.bfloat16
    jcfg, jparams, tcfg, tparams = _models("qwen3-0.6b")
    n = sum(t.numel() for t in tparams["layers"].values()) + sum(
        t.numel() for k, t in tparams.items() if k != "layers")
    assert n == tcfg.param_count() == jcfg.param_count()


def test_init_params_shapes_and_scales():
    cfg = qwen3_0_6b.smoke_config()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    jparams = JT.init_params(jax_qwen.smoke_config(), jax.random.PRNGKey(0))
    flat = _flatten(jparams)
    for key, a in flat.items():
        head, _, name = key.partition("/")
        t = params["layers"][name] if name else params[head]
        assert tuple(t.shape) == a.shape and t.dtype == cfg.dtype, key
        # same distribution: the standard deviations agree within 15%
        if a.std() > 0:
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.15, key
        else:
            assert torch.equal(t, torch.ones_like(t)), key


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_forward_matches_reference(arch, attn):
    jcfg, jparams, tcfg, tparams = _models(arch)
    jt, tt = _tokens(np.random.default_rng(0), tcfg.vocab, 2, 24)
    want, _ = _jax(jcfg)["forward"](jparams, jt)
    got, aux = T.forward(tcfg, tparams, tt, attn=attn)
    assert got.shape == (2, 24, tcfg.vocab) and aux == 0.0
    _close(got, want, F32)


def test_forward_matches_reference_bf16():
    jcfg, jparams, tcfg, tparams = _models("qwen3-0.6b", "bfloat16")
    jt, tt = _tokens(np.random.default_rng(1), tcfg.vocab, 2, 24)
    want, _ = _jax(jcfg)["forward"](jparams, jt)
    got, _ = T.forward(tcfg, tparams, tt)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_prefill_blockwise_matches_reference(arch, attn):
    # S = 1460 > 1448: s * t > 2**21, the reference's blockwise branch
    jcfg, jparams, tcfg, tparams = _models(arch)
    jt, tt = _tokens(np.random.default_rng(2), tcfg.vocab, 1, 1460)
    jcache, jlog = _jax(jcfg)["prefill"](jparams, jt, 1472, 1)
    tcache, tlog = T.prefill(tcfg, tparams, tt, 1472, attn=attn)
    _close(tlog, jlog, F32)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], F32_LONG)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def _decode_both(jcfg, jparams, tcfg, tparams, prompt_len, s_cache, steps,
                 attn, tol=F32, batch=2, batch_chunks=1):
    rng = np.random.default_rng(prompt_len + s_cache)
    jt, tt = _tokens(rng, tcfg.vocab, batch, prompt_len)
    jcache, jlog = _jax(jcfg)["prefill"](jparams, jt, s_cache, batch_chunks)
    tcache, tlog = T.prefill(tcfg, tparams, tt, s_cache,
                             batch_chunks=batch_chunks, attn=attn)
    _close(tlog, jlog, tol)
    for _ in range(steps):
        tok = rng.integers(0, tcfg.vocab, batch).astype(np.int32)
        jlog, jcache = _jax(jcfg)["decode"](jparams, jcache, jnp.asarray(tok))
        tlog, tcache = T.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(tok.astype(np.int64)),
                                     attn=attn)
        _close(tlog, jlog, tol)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], tol)
        assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    return tcache


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_decode_steps_match_reference(arch, attn):
    jcfg, jparams, tcfg, tparams = _models(arch)
    _decode_both(jcfg, jparams, tcfg, tparams, prompt_len=12, s_cache=32,
                 steps=6, attn=attn, batch=4, batch_chunks=2)


@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_decode_swa_ring_buffer_matches_reference(attn):
    # s_cache == attn_window (8): the cache is a ring, written at pos % 8;
    # 14 steps from pos 5 wrap it twice
    jcfg, jparams, tcfg, tparams = _models("qwen3-0.6b-swa")
    assert tcfg.attn_window == 8
    cache = _decode_both(jcfg, jparams, tcfg, tparams, prompt_len=5,
                         s_cache=8, steps=14, attn=attn)
    assert cache["pos"].tolist() == [19, 19]


@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_decode_past_the_cache_matches_reference(attn):
    # a full-attention cache of 8 slots decoded to pos 13: the reference's
    # scatter drops the writes past the cache, the port must not fail
    jcfg, jparams, tcfg, tparams = _models("qwen3-0.6b")
    cache = _decode_both(jcfg, jparams, tcfg, tparams, prompt_len=6,
                         s_cache=8, steps=8, attn=attn)
    assert cache["pos"].tolist() == [14, 14]


def test_decode_bf16_matches_reference():
    jcfg, jparams, tcfg, tparams = _models("qwen3-0.6b", "bfloat16")
    _decode_both(jcfg, jparams, tcfg, tparams, prompt_len=10, s_cache=16,
                 steps=3, attn="plain", tol=BF16)


def test_plain_attention_paths_match_reference():
    # the port's _sdpa_dense / _sdpa_blockwise / _sdpa_decode against the
    # reference's on the same inputs, with padded (-1) key positions
    rng = np.random.default_rng(5)
    jcfg = JT.LMConfig(name="a", n_layers=1, d_model=32, n_heads=4, n_kv=2,
                       d_ff=32, vocab=8, head_dim=16, attn_window=50,
                       dtype=jnp.float32)
    tcfg = T.LMConfig(name="a", n_layers=1, d_model=32, n_heads=4, n_kv=2,
                      d_ff=32, vocab=8, head_dim=16, attn_window=50,
                      dtype=torch.float32)
    b, s, t = 2, 90, 300
    arr = lambda *sh: rng.normal(0, 1, sh).astype(np.float32)
    q, k, v = arr(b, s, 2, 2, 16), arr(b, t, 2, 16), arr(b, t, 2, 16)
    qp = np.tile(np.arange(200, 200 + s, dtype=np.int32), (b, 1))
    tp = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    tp[:, ::7] = -1
    J = lambda *a: [jnp.asarray(x) for x in a]
    P = lambda *a: [torch.from_numpy(x) for x in a]
    want = JT._sdpa_blockwise(jcfg, *J(q, k, v, qp, tp), True, 32, 64)
    _close(T._sdpa_blockwise(tcfg, *P(q, k, v, qp, tp), True, 32, 64), want,
           F32)
    tp_pos = np.abs(tp)
    want = JT._sdpa_dense(jcfg, *J(q, k, v, qp, tp_pos), True)
    _close(T._sdpa_dense(tcfg, *P(q, k, v, qp, tp_pos), True), want, F32)
    pos = np.array([150, 299], np.int32)
    got = T._sdpa_decode(tcfg, *P(q[:, :1], k, v, pos, tp))
    # the reference's decode attention is inline; its blockwise path with
    # one query at pos computes the same function
    want = JT._sdpa_blockwise(jcfg, *J(q[:, :1], k, v, pos[:, None], tp),
                              True)
    _close(got, want, F32)


def test_attn_choice_is_explicit():
    assert T.resolve_attn(None, "cpu") == "plain"
    assert T.resolve_attn(None, "cuda") == "flash"
    assert T.resolve_attn("flash", "cpu") == "flash"
    with pytest.raises(ValueError):
        T.resolve_attn("sdpa", "cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", F32),
                                       ("bfloat16", BF16)])
def test_layers_match_reference(dtype, tol):
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(6)
    arr = lambda *sh: rng.normal(0, 1, sh).astype(np.float32)
    x, w = arr(3, 40, 4, 32), arr(32)
    wg, wu, wd = arr(32, 48) * 0.2, arr(32, 48) * 0.2, arr(48, 32) * 0.2
    pos = rng.integers(0, 5000, (3, 40)).astype(np.int32)
    J = lambda a: jnp.asarray(a).astype(dtype)
    P = lambda a: torch.from_numpy(np.array(J(a).astype(jnp.float32))).to(
        getattr(torch, dtype))
    _close(TL.rope_freqs(32, 1e6), JL.rope_freqs(32, 1e6), F32)
    _close(TL.rms_norm(P(x), P(w)), JL.rms_norm(J(x), J(w)), tol)
    _close(TL.apply_rope(P(x), torch.from_numpy(pos), 1e6),
           JL.apply_rope(J(x), jnp.asarray(pos), 1e6), tol)
    _close(TL.swiglu(P(x), P(wg), P(wu), P(wd)),
           JL.swiglu(J(x), J(wg), J(wu), J(wd)), tol)
    _close(TL.gelu_mlp(P(x), P(wu), P(wd)), JL.gelu_mlp(J(x), J(wu), J(wd)),
           tol)


def test_init_cache_runs_on_the_card_unless_asked():
    # like every entry point of the port: no device means the card, and
    # without one that raises instead of allocating on the CPU
    cfg = qwen3_0_6b.smoke_config()
    if torch.cuda.is_available():
        assert T.init_cache(cfg, 1, 8)["k"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_cache(cfg, 1, 8)
    cache = T.init_cache(cfg, 1, 8, "cpu")
    assert cache["k"].device.type == "cpu"
    assert cache["k"].shape == (cfg.n_layers, 1, 8, cfg.n_kv, cfg.hd)
    assert cache["pos"].dtype == torch.int32


def test_lm_params_from_reference_needs_a_device():
    flat = {"embed": np.ones((4, 2), np.float32)}
    with pytest.raises(TypeError):
        lm_params_from_reference(flat, torch.float32)
    assert lm_params_from_reference(flat, torch.float32, "cpu")[
        "embed"].device.type == "cpu"
