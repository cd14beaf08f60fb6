"""The port's MIND serving path, config and recsys stream against the JAX
reference, on the CPU.

MIND runs on ``smoke_config()`` with the reference's ``init_params(cfg,
PRNGKey(0))`` carried over by ``convert.mind_params_from_reference``, on
``RecsysStream`` batches.  Parity is by tolerance, not bitwise: the
routing logits start at ``sin(l * (1 + k))``, and torch's f32 ``sin``
differs from XLA's by an ulp on some entries (7 of the 200 at L = 50,
K = 4), and the einsums sum in another order.  Interests are held at
rtol 1e-5 with an absolute floor of 1e-5 of their largest magnitude;
scores likewise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mind as jconfig
from repro.data.synthetic import RecsysStream as JStream
from repro.models.recsys import mind as jmind
from repro_torch import configs, convert
from repro_torch.data.synthetic import RecsysStream
from repro_torch.models.recsys import mind as tmind
from release_xla import release_compiled  # noqa: F401

RTOL, ATOL_OF_SCALE = 1e-5, 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_SCALE * scale)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfig.smoke_config()
    jparams = jmind.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get("mind").smoke_config()
    params = convert.mind_params_from_reference(
        {k: np.asarray(a) for k, a in jparams.items()}, "cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("step,batch", [(0, 16), (3, 64)])
def test_serve_interests_match_reference(smoke, step, batch):
    jcfg, jparams, cfg, params = smoke
    b = RecsysStream(cfg.n_items, cfg.hist_len, seed=0).batch(step, batch)
    want = jmind.serve_interests(jcfg, jparams,
                                 {k: jnp.asarray(v) for k, v in b.items()})
    got = tmind.serve_interests(cfg, params, b)
    _close(got.numpy(), want)
    norms = got.norm(dim=-1)
    assert got.shape == (batch, cfg.n_interests, cfg.embed_dim)
    assert bool((norms < 1).all())              # squash keeps them inside


def test_serve_interests_hist_len_50_sin_watch_point(smoke):
    """MIND's published history length, where torch's ``sin`` and XLA's
    differ on a few routing-logit entries: still within tolerance."""
    jcfg, jparams, cfg, params = smoke
    jcfg = dataclasses.replace(jcfg, hist_len=50)
    cfg = dataclasses.replace(cfg, hist_len=50)
    b = RecsysStream(cfg.n_items, 50, seed=0).batch(1, 32)
    want = jmind.serve_interests(jcfg, jparams,
                                 {k: jnp.asarray(v) for k, v in b.items()})
    _close(tmind.serve_interests(cfg, params, b).numpy(), want)


def test_retrieval_scores_match_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    b = RecsysStream(cfg.n_items, cfg.hist_len, seed=0).batch(0, 4)
    interests = tmind.serve_interests(cfg, params, b)[0]
    cand = np.random.default_rng(1).integers(0, cfg.n_items, 500).astype(
        np.int32)
    cand[:3] = [-1, -cfg.n_items, 3]           # wrap
    got = tmind.retrieval_scores(cfg, params, interests, cand)
    want = jmind.retrieval_scores(jcfg, jparams,
                                  jnp.asarray(interests.numpy()),
                                  jnp.asarray(cand))
    assert got.dtype == torch.float32 and got.shape == (500,)
    _close(got.numpy(), want)
    # an id outside [-V, V) scores NaN in both
    bad = np.array([cfg.n_items, 5, -cfg.n_items - 1], np.int32)
    got = tmind.retrieval_scores(cfg, params, interests, bad).numpy()
    want = np.asarray(jmind.retrieval_scores(
        jcfg, jparams, jnp.asarray(interests.numpy()), jnp.asarray(bad)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).tolist() == [True, False, True]


def test_out_of_range_history_ids_follow_reference(smoke):
    """A masked-in id outside [-V, V) makes the user's interests NaN in
    both; masked out, it changes nothing."""
    jcfg, jparams, cfg, params = smoke
    b = RecsysStream(cfg.n_items, cfg.hist_len, seed=0).batch(2, 4)
    b["hist"][0, 0] = cfg.n_items              # masked in (slot 0)
    b["hist"][1, -1] = 2 * cfg.n_items
    b["hist_mask"][1, -1] = False              # masked out
    b["hist"][2, 1] = -1                       # wraps
    got = tmind.serve_interests(cfg, params, b).numpy()
    want = np.asarray(jmind.serve_interests(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in b.items()}))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).all() and np.isfinite(got[1:]).all()
    _close(got[1:], want[1:])


def test_recsys_stream_matches_reference():
    for n_items, hist_len, seed, step, batch in ((1000, 10, 0, 0, 16),
                                                 (10_000_000, 50, 0, 3, 64),
                                                 (77, 7, 5, 2, 9)):
        got = RecsysStream(n_items, hist_len, seed=seed).batch(step, batch)
        want = JStream(n_items, hist_len, seed=seed).batch(step, batch)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_init_params_shapes_and_dtypes(smoke):
    jcfg, jparams, cfg, _ = smoke
    params = tmind.init_params(cfg, torch.Generator().manual_seed(0))
    assert params.keys() == jparams.keys()
    for k, a in jparams.items():
        assert tuple(params[k].shape) == a.shape, k
        assert params[k].dtype == torch.float32 and a.dtype == jnp.float32
    # the reference's distributions: normal * 0.02, and a truncated
    # normal over sqrt(fan-in)
    assert abs(float(params["item_embed"].std()) - 0.02) < 0.001
    assert float(params["s_map"].abs().max()) <= 2 / cfg.embed_dim ** 0.5


def test_config_matches_reference():
    port = configs.get("mind")
    assert port.FAMILY == jconfig.FAMILY
    assert port.SHAPES == jconfig.SHAPES
    assert port.SKIP_SHAPES == jconfig.SKIP_SHAPES
    assert port.MICROBATCHES == jconfig.MICROBATCHES
    for make in ("make_config", "smoke_config"):
        got = dataclasses.asdict(getattr(port, make)())
        want = dataclasses.asdict(getattr(jconfig, make)())
        assert got.pop("dtype") == torch.float32
        assert want.pop("dtype") == jnp.float32
        assert got == want, make


def test_mind_params_from_reference_needs_a_device():
    arrays = {"item_embed": np.ones((4, 2), np.float32),
              "s_map": np.eye(2, dtype=np.float32)}
    with pytest.raises(TypeError):
        convert.mind_params_from_reference(arrays)
    params = convert.mind_params_from_reference(arrays, "cpu")
    assert params["s_map"].device.type == "cpu"
