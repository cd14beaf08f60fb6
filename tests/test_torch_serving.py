"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the same requests with the same parameters (the
reference's ``init_params``, carried over with
``lm_params_from_reference``) and the same slot, admission and greedy
argmax rules: the tokens of every request must be identical.  The
configuration is ``tests/test_serving.py``'s.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine
from release_xla import release_compiled  # noqa: F401


def _configs(window=0):
    kw = dict(name="serve-t", n_layers=2, d_model=64, n_heads=4, n_kv=2,
              d_ff=96, vocab=97, head_dim=16, attn_window=window)
    return (JT.LMConfig(**kw, dtype=jnp.float32),
            T.LMConfig(**kw, dtype=torch.float32))


def _params(jcfg, tcfg):
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v, np.float32) for k, v in jparams.items()
            if k != "layers"}
    flat.update({f"layers/{k}": np.asarray(v, np.float32)
                 for k, v in jparams["layers"].items()})
    return jparams, lm_params_from_reference(flat, tcfg.dtype, "cpu")


def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        engine.submit(r)
    steps = engine.run()
    return [r.out for r in reqs], steps


@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_engine_tokens_match_reference(attn):
    jcfg, tcfg = _configs()
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 97, rng.integers(4, 12)).astype(np.int32)
               for _ in range(5)]
    kw = dict(max_batch=3, s_cache=64, prompt_pad=8)
    want, jsteps = _serve(JEngine(jcfg, jparams, **kw), JRequest, prompts,
                          [6] * 5)
    engine = ServeEngine(tcfg, tparams, attn=attn, **kw)
    got, steps = _serve(engine, Request, prompts, [6] * 5)
    assert engine.attn == attn
    assert got == want and steps == jsteps
    assert all(len(o) == 6 for o in got)


@pytest.mark.parametrize("window", [0, 24], ids=["full", "ring"])
def test_engine_past_the_cache_matches_reference(window):
    # slots left idle keep decoding, so their positions run past the
    # 24-slot cache (the reference drops those writes; with window 24 the
    # cache is a ring); short and long requests mixed, more requests
    # than slots
    jcfg, tcfg = _configs(window)
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, rng.integers(3, 17)).astype(np.int32)
               for _ in range(6)]
    max_new = [2, 12, 3, 15, 1, 9]
    kw = dict(max_batch=2, s_cache=24, prompt_pad=8)
    want, _ = _serve(JEngine(jcfg, jparams, **kw), JRequest, prompts,
                     max_new)
    engine = ServeEngine(tcfg, tparams, **kw)
    got, _ = _serve(engine, Request, prompts, max_new)
    assert got == want
    assert [len(o) for o in got] == [max(n, 2) for n in max_new]
    assert int(engine.cache["pos"].max()) > 24
