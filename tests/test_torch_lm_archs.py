"""The four LMs of the substrate's last slice (phi4-mini-3.8b,
granite-34b, deepseek-moe-16b, granite-moe-3b-a800m) against the JAX
package, on the CPU.

Each runs its ``smoke_config()`` in float32 with the reference's
``init_params`` carried over by ``lm_params_from_reference``: forward
(plain attention and the flash kernel's plain version), prefill and
decode steps (greedy tokens identical at every step) and the serving
engine (every request's tokens identical).  Tolerance: float32 at rtol
1e-4, atol 1e-5, as ``tests/test_torch_transformer.py``.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as jget
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine
from release_xla import release_compiled  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("phi4-mini-3.8b", "granite-34b", "deepseek-moe-16b",
         "granite-moe-3b-a800m")


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
def _models(arch):
    jcfg = jget(arch).smoke_config()
    tcfg = configs.get(arch).smoke_config()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_reference(_flatten(jparams), tcfg.dtype, "cpu")
    return jcfg, jparams, tcfg, tparams


def _close(got, want, tol=F32):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _tokens(rng, vocab, b, s):
    t = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    jmod, tmod = jget(arch), configs.get(arch)
    jc, tc = jmod.make_config(), tmod.make_config()
    fields = ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
              "hd", "mlp", "qk_norm", "rope_theta", "moe", "n_experts",
              "top_k", "n_shared", "capacity_factor", "aux_loss_coef",
              "attn_window", "tied_embed", "seq_shard", "remat")
    assert [getattr(tc, f) for f in fields] == \
        [getattr(jc, f) for f in fields]
    assert tc.param_count() == jc.param_count()
    assert tc.dtype == torch.bfloat16
    assert tmod.MICROBATCHES == jmod.MICROBATCHES
    assert getattr(tmod, "PREFILL_CHUNKS", None) == \
        getattr(jmod, "PREFILL_CHUNKS", None)
    js, ts = jmod.smoke_config(), tmod.smoke_config()
    assert [getattr(ts, f) for f in fields] == \
        [getattr(js, f) for f in fields] and ts.dtype == torch.float32
    assert tmod.SHAPES == jmod.SHAPES


@pytest.mark.parametrize("attn", ["plain", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, attn):
    jcfg, jparams, tcfg, tparams = _models(arch)
    jt, tt = _tokens(np.random.default_rng(0), tcfg.vocab, 2, 24)
    want, want_aux = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(jparams,
                                                                  jt)
    got, aux = T.forward(tcfg, tparams, tt, attn=attn)
    assert got.shape == (2, 24, tcfg.vocab)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    assert (float(aux) > 0) == tcfg.moe


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    # batch 4 prefilled in 2 chunks, then 6 greedy decode steps
    jcfg, jparams, tcfg, tparams = _models(arch)
    prefill = jax.jit(lambda p, t: JT.prefill(jcfg, p, t, 32,
                                              batch_chunks=2))
    decode = jax.jit(lambda p, c, t: JT.decode_step(jcfg, p, c, t))
    jt, tt = _tokens(np.random.default_rng(1), tcfg.vocab, 4, 12)
    jcache, jlog = prefill(jparams, jt)
    tcache, tlog = T.prefill(tcfg, tparams, tt, 32, batch_chunks=2,
                             attn="plain")
    for _ in range(6):
        _close(tlog, jlog)
        tok = torch.argmax(tlog, -1)
        assert tok.tolist() == np.asarray(jnp.argmax(jlog, -1)).tolist()
        jlog, jcache = decode(jparams, jcache, jnp.asarray(tok.numpy(),
                                                           jnp.int32))
        tlog, tcache = T.decode_step(tcfg, tparams, tcache, tok,
                                     attn="flash")
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
    _close(tlog, jlog)
    assert tcache["pos"].tolist() == [18] * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab, rng.integers(4, 14)).astype(
        np.int32) for _ in range(5)]
    kw = dict(max_batch=3, s_cache=48, prompt_pad=8)
    outs = []
    for engine, req in ((JEngine(jcfg, jparams, **kw), JRequest),
                        (ServeEngine(tcfg, tparams, **kw), Request)):
        reqs = [req(rid=i, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run()
        outs.append([r.out for r in reqs])
    assert outs[1] == outs[0]
    assert all(len(o) == 5 for o in outs[1])
