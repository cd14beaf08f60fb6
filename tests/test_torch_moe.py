"""The port's MoE block against the JAX package, on the CPU.

Both MoE smoke configurations (deepseek-moe-16b: 8 experts, top-6, 2
shared; granite-moe-3b-a800m: 5 experts, top-3, none shared) run layer
0 of the reference's ``init_params`` (carried over with
``lm_params_from_reference``) on the same seeded tokens, at the
configured capacity and at a capacity factor of 0.3, where capacity
drops token-choices.  ``y`` and ``aux`` are held at float32's rtol 1e-4,
atol 1e-5; the routing (the reference's lines recomputed in JAX: top-k,
the stable sort by expert, ranks and ``keep``) exactly, on every token
whose k-th and (k+1)-th probabilities are more than 1e-6 apart
(relative), with the near-ties counted and reported, never re-seeded
away.  The combine adds each token's rows from zero in ascending expert
order, as the reference's ``segment_sum`` does: a case whose f32 sum
depends on that order holds it bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as jget
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import transformer as T
from release_xla import release_compiled  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
MOE = ("deepseek-moe-16b", "granite-moe-3b-a800m")
NEAR_TIE = 1e-6


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
def _models(arch, capacity_factor=None):
    jcfg = jget(arch).smoke_config()
    tcfg = configs.get(arch).smoke_config()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_reference(_flatten(jparams), tcfg.dtype, "cpu")
    return jcfg, jparams, tcfg, tparams


def _reference_route(jcfg, lp, xt):
    """The reference ``moe_block``'s routing lines, as it computes them."""
    t = xt.shape[0]
    e, k = jcfg.n_experts, jcfg.top_k
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), lp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = max(int(t * k / e * jcfg.capacity_factor), 8)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = jnp.searchsorted(se, se, side="left")
    rank = jnp.arange(t * k, dtype=jnp.int32) - first
    return dict(probs=np.asarray(probs), idx=np.asarray(idx), cap=cap,
                keep=np.asarray(rank < cap), se=np.asarray(se),
                rank=np.asarray(rank))


def _near_ties(probs, k):
    top = -np.sort(-probs, axis=-1)
    return (top[:, k - 1] - top[:, k]) <= NEAR_TIE * top[:, k - 1]


@pytest.mark.parametrize("capacity", [None, 0.3], ids=["cap", "drops"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch, capacity):
    jcfg, jparams, tcfg, tparams = _models(arch, capacity)
    jlp = {k: v[0] for k, v in jparams["layers"].items()}
    tlp = T._layer(tparams, 0)
    x = np.random.default_rng(3).normal(0, 1, (2, 24, tcfg.d_model)).astype(
        np.float32)
    want_y, want_aux = jax.jit(lambda lp, x: JT.moe_block(jcfg, lp, x))(
        jlp, jnp.asarray(x))
    got_y, got_aux = T.moe_block(tcfg, tlp, torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **F32)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **F32)

    ref = _reference_route(jcfg, jlp, jnp.asarray(x.reshape(-1,
                                                            tcfg.d_model)))
    r = T.moe_route(tcfg, tlp, torch.from_numpy(x.reshape(-1, tcfg.d_model)))
    near = _near_ties(ref["probs"], tcfg.top_k)
    print(f"{arch} capacity {capacity}: {int(near.sum())} near-ties of "
          f"{near.size} tokens")
    assert r.cap == ref["cap"]
    np.testing.assert_array_equal(r.idx.numpy()[~near], ref["idx"][~near])
    if not near.any():
        np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
        np.testing.assert_array_equal(r.se.numpy(), ref["se"])
        np.testing.assert_array_equal(r.rank.numpy(), ref["rank"])
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (capacity is not None), dropped


def test_moe_top_k_ties_take_the_lower_expert():
    # jax.lax.top_k's order on equal probabilities: the lower index first
    cfg = T.LMConfig(name="tie", n_layers=1, d_model=4, n_heads=1, n_kv=1,
                     d_ff=4, vocab=8, moe=True, n_experts=6, top_k=3,
                     dtype=torch.float32)
    router = torch.zeros(4, 6)
    router[0, 4] = router[0, 1] = 1.0        # experts 1 and 4 tie on top
    xt = torch.tensor([[1.0, 0, 0, 0], [0, 0, 0, 0]])
    r = T.moe_route(cfg, {"router": router}, xt)
    assert r.idx.tolist() == [[1, 4, 0], [0, 1, 2]]
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xt.numpy()) @
                                           jnp.asarray(router.numpy())), 3)
    assert np.asarray(jidx).tolist() == r.idx.tolist()


def test_moe_combine_adds_in_ascending_expert_order():
    # token 0 chose experts 2, 1, 0 (gate order); its rows are 1, 1e8 and
    # -1e8 for experts 0, 1, 2: from zero in ascending expert order the
    # f32 sum is (1 + 1e8) - 1e8 = 0, in choice order (-1e8 + 1e8) + 1 = 1
    idx = np.array([[2, 1, 0], [0, 2, 1]])
    t, k = idx.shape
    vals = np.array([1.0, 1e8, -1e8], np.float32)
    flat_e = idx.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    se, st = flat_e[order], order // k
    y_tok = np.stack([vals[se] * (1 + j) for j in range(3)], 1).astype(
        np.float32)                                  # [T*k, 3]
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(y_tok),
                                          jnp.asarray(st), num_segments=t))
    got = T.moe_combine(torch.from_numpy(y_tok), torch.from_numpy(order),
                        t, k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0.0 and got[1, 0] == 0.0
    choice = np.float32(np.float32(np.float32(0) + vals[2]) + vals[1]) \
        + vals[0]
    assert choice == 1.0                             # order matters here


def test_moe_router_stays_float32():
    # T1: the reference keeps the router in f32 and routes in f32; the
    # converted and the port's own bf16 parameters must too
    jcfg, jparams, _, _ = _models("deepseek-moe-16b")
    bf = dataclasses.replace(configs.get("deepseek-moe-16b").smoke_config(),
                             dtype=torch.bfloat16)
    for params in (lm_params_from_reference(_flatten(jparams),
                                            torch.bfloat16, "cpu"),
                   T.init_params(bf, torch.Generator().manual_seed(0))):
        assert params["layers"]["router"].dtype == torch.float32
        assert params["layers"]["e_up"].dtype == torch.bfloat16
        assert params["embed"].dtype == torch.bfloat16
        y, aux = T.moe_block(bf, T._layer(params, 0), torch.ones(
            (1, 5, bf.d_model), dtype=torch.bfloat16))
        assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    lp = T._layer(params, 0)
    lp["router"] = lp["router"].to(torch.bfloat16)
    with pytest.raises(RuntimeError):
        T.moe_block(bf, lp, torch.ones((1, 5, bf.d_model),
                                       dtype=torch.bfloat16))


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_params_shapes_and_scales(arch):
    jcfg, jparams, tcfg, _ = _models(arch)
    params = T.init_params(tcfg, torch.Generator().manual_seed(0))
    for key, a in _flatten(jparams).items():
        head, _, name = key.partition("/")
        t = params["layers"][name] if name else params[head]
        assert tuple(t.shape) == a.shape, key
        assert t.dtype == (torch.float32 if name == "router"
                           else tcfg.dtype), key
        if a.std() > 0:
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.15, key
        else:
            assert torch.equal(t, torch.ones_like(t)), key
    assert set(params["layers"]) == set(jparams["layers"])
    n = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    assert n == tcfg.param_count() == jcfg.param_count()
