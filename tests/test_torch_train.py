"""The port's LM and MIND training against the JAX package, on the CPU:
``layer_norm`` and ``softmax_cross_entropy``, ``loss_fn`` and its
gradients for every LM smoke config (remat on and off), AdamW and SGD,
the schedule, the jitted train steps of the reference against the
port's, microbatch accumulation, ``LMTokenStream`` and MIND's
``label_aware_attention`` and ``train_loss``.

Parameters are the reference's ``init_params`` carried over by
``convert``.  Tolerances: the loss at rtol 1e-5; every gradient leaf at
rtol 1e-4 with an absolute floor of 1e-5 of that leaf's largest
magnitude; the optimizers' parameters, moments and master weights at
rtol 1e-6; after a train step, parameters within an absolute 2·lr per
step taken (Adam's step is about ±lr per component, and a near-zero
gradient component may flip its sign between XLA and torch); MIND at
``tests/test_torch_mind.py``'s rtol 1e-5, atol 1e-5 of the scale.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as jget
from repro.data.synthetic import LMTokenStream as JTokens
from repro.data.synthetic import RecsysStream as JStream
from repro.models import layers as JL, transformer as JT
from repro.models.recsys import mind as jmind
from repro.train import loop as jloop, optimizer as jopt
from repro_torch import configs, convert
from repro_torch.data.synthetic import LMTokenStream, RecsysStream
from repro_torch.kernels.flash_attn import ops as fops
from repro_torch.models import layers as TL, transformer as T
from repro_torch.models.recsys import mind as tmind
from repro_torch.train import loop, optimizer as opt
from repro_torch.train.tree import leaves
from release_xla import release_compiled  # noqa: F401

LM_ARCHS = ("qwen3-0.6b", "qwen3-0.6b-swa", "phi4-mini-3.8b", "granite-34b",
            "deepseek-moe-16b", "granite-moe-3b-a800m")
GRAD_RTOL, GRAD_ATOL_OF_SCALE = 1e-4, 1e-5


def _flatten(params) -> dict:
    out = {}
    for key, val in params.items():
        if key == "layers":
            out.update({f"layers/{n}": np.asarray(a, np.float32)
                        for n, a in val.items()})
        else:
            out[key] = np.asarray(val, np.float32)
    return out


def _np(tree):
    """A nested dict of tensors or jax arrays as float64-free numpy."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy() if tree.is_floating_point() \
            else tree.numpy()
    return np.asarray(tree, np.float32) if jnp.issubdtype(
        tree.dtype, jnp.floating) else np.asarray(tree)


def _pairs(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    else:
        yield path, got, want


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jget(arch).smoke_config()
    tcfg = configs.get(arch).smoke_config()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_reference(_flatten(jparams), tcfg.dtype,
                                               "cpu")
    return jcfg, jparams, tcfg, tparams


def _grads_close(got, want):
    for path, g, w in _pairs(_np(got), _np(want)):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_SCALE * scale,
                                   err_msg=path)


def test_layer_norm_and_cross_entropy_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2, (3, 7, 40)).astype(np.float32)
    w, b = rng.normal(1, 0.1, 40).astype(np.float32), \
        rng.normal(0, 0.1, 40).astype(np.float32)
    np.testing.assert_allclose(
        TL.layer_norm(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(JL.layer_norm(*map(jnp.asarray, (x, w, b)))),
        rtol=1e-5, atol=1e-6)
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    for z in (0.0, 1e-4):
        np.testing.assert_allclose(
            TL.softmax_cross_entropy(torch.from_numpy(x),
                                     torch.from_numpy(labels), z).numpy(),
            np.asarray(JL.softmax_cross_entropy(jnp.asarray(x),
                                                jnp.asarray(labels), z)),
            rtol=1e-5, atol=1e-6)
    got = TL.softmax_cross_entropy(torch.from_numpy(x).to(torch.bfloat16),
                                   torch.from_numpy(labels))
    assert got.dtype == torch.float32           # f32 logsumexp


@pytest.mark.parametrize("arch,masked", [
    *((a, False) for a in LM_ARCHS), ("qwen3-0.6b", True),
    ("deepseek-moe-16b", True)])
def test_loss_and_gradients_match_reference(arch, masked):
    jcfg, jparams, tcfg, tparams = _models(arch)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, tcfg.vocab, (2, 20)).astype(np.int32)
    batch = {"tokens": tok}
    if masked:
        batch["mask"] = rng.random((2, 20)) < 0.7
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = loop.value_and_grad(
        lambda p, b: T.loss_fn(tcfg, p, b), tparams,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=1e-5, atol=1e-7)
    _grads_close(grads, jgrads)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_remat_gives_the_same_gradients(arch):
    _, _, tcfg, tparams = _models(arch)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (2, 16)))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = loop.value_and_grad(
            lambda p, b: T.loss_fn(cfg, p, b), tparams, {"tokens": tok})
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(leaves(out[True][2]), leaves(out[False][2])):
        assert torch.equal(a, b)


def _opt_inputs(seed=3):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (2, 3, 4)}}

    def draw(sh, scale):
        if isinstance(sh, dict):
            return {k: draw(v, scale) for k, v in sh.items()}
        return (rng.normal(0, scale, sh)).astype(np.float32)
    return draw(shapes, 1.0), draw(shapes, 0.3), draw(shapes, 0.1), \
        draw(shapes, 0.01)


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _assert_tree(got, want, rtol=1e-6, atol=0.0):
    for path, g, w in _pairs(_np(got), _np(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("master,clip", [(True, 1.0), (False, 0.5),
                                         (True, 0.0)])
def test_adamw_update_matches_reference(master, clip):
    p, g, m, v = _opt_inputs()
    v = _tree(np.abs, v)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip,
               master_weights=master)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    J, P = (lambda t: _tree(jnp.asarray, t)), \
        (lambda t: _tree(torch.from_numpy, t))
    jstate = jopt.adamw_init(J(p), jcfg)
    tstate = opt.adamw_init(P(p), tcfg)
    jstate.update(m=J(m), v=J(v), step=jnp.int32(4))
    tstate.update(m=P(m), v=P(v), step=torch.tensor(4, dtype=torch.int32))
    assert ("master" in tstate) == master
    for _ in range(2):
        jp, jstate, jmet = jopt.adamw_update(J(p), J(g), jstate, jcfg)
        tp, tstate, tmet = opt.adamw_update(P(p), P(g), tstate, tcfg)
        _assert_tree(tp, jp)
        for key in ("m", "v") + (("master",) if master else ()):
            _assert_tree(tstate[key], jstate[key])
        assert int(tstate["step"]) == int(jstate["step"])
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-6)
        p = _tree(lambda x: x.numpy(), tp)


def test_sgd_update_matches_reference():
    p, g, mom, _ = _opt_inputs(4)
    J, P = (lambda t: _tree(jnp.asarray, t)), \
        (lambda t: _tree(torch.from_numpy, t))
    for clip in (0.0, 0.5):
        jcfg = jopt.SGDConfig(lr=0.05, momentum=0.8, clip_norm=clip)
        tcfg = opt.SGDConfig(lr=0.05, momentum=0.8, clip_norm=clip)
        jstate = dict(jopt.sgd_init(J(p), jcfg), mom=J(mom))
        tstate = dict(opt.sgd_init(P(p), tcfg), mom=P(mom))
        jp, jstate, jmet = jopt.sgd_update(J(p), J(g), jstate, jcfg)
        tp, tstate, tmet = opt.sgd_update(P(p), P(g), tstate, tcfg)
        _assert_tree(tp, jp)
        _assert_tree(tstate["mom"], jstate["mom"])
        assert int(tstate["step"]) == int(jstate["step"]) == 1
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)


def test_schedule_matches_reference_at_every_step():
    for kw in (dict(lr=3e-4, warmup_steps=10, total_steps=50),
               dict(lr=1.0, warmup_steps=0, total_steps=7, min_lr_frac=0.0)):
        jcfg, tcfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
        steps = np.arange(0, 61, dtype=np.int32)
        want = np.asarray(jopt.schedule(jcfg, jnp.asarray(steps)))
        got = opt.schedule(tcfg, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        assert float(opt.schedule(tcfg, 3)) == pytest.approx(
            float(want[3]), rel=1e-6)


def _train_both(jstep, tstep, jstate, tstate, batches, lr_of, n_params):
    """Run both steps over ``batches``; after each, the losses at rtol
    1e-5 and the parameters within 2·lr per step taken so far."""
    budget = 0.0
    for i, b in enumerate(batches):
        jp, jo, jm = jstep(*jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(*tstate, b)
        jstate, tstate = (jp, jo), (tp, to)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        budget += 2 * lr_of(i + 1)
        moved = 0
        for path, g, w in _pairs(_np(tp), _np(jp)):
            assert np.abs(g - w).max() <= budget, (i, path)
            moved += g.size
        assert moved == n_params
    return jstate, tstate


@pytest.mark.parametrize("microbatches", [1, 2])
def test_lm_train_steps_match_reference(microbatches):
    jcfg, jparams, tcfg, tparams = _models("qwen3-0.6b")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jo, to = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jstep = jax.jit(jloop.make_lm_train_step(jcfg, jo,
                                             microbatches=microbatches))
    tstep = loop.make_lm_train_step(tcfg, to, microbatches=microbatches)
    stream = LMTokenStream(tcfg.vocab, seed=0)
    batches = [{"tokens": stream.batch(i, 4, 16)} for i in range(3)]
    _train_both(jstep, tstep, (jparams, jopt.adamw_init(jparams, jo)),
                (tparams, opt.adamw_init(tparams, to)), batches,
                lambda s: float(opt.schedule(to, s)), tcfg.param_count())


def test_microbatches_agree_with_one_batch():
    # two halves of equal size: the mean of their means is the mean
    _, _, cfg, tparams = _models("phi4-mini-3.8b")
    tok = torch.from_numpy(LMTokenStream(cfg.vocab, seed=1).batch(0, 4, 12))
    fn = lambda p, b: T.loss_fn(cfg, p, b)
    one = loop._accumulate(fn, tparams, {"tokens": tok}, 1)
    two = loop._accumulate(fn, tparams, {"tokens": tok}, 2)
    assert float(two[0]) == pytest.approx(float(one[0]), rel=1e-5)
    for a, b in zip(leaves(two[2]), leaves(one[2])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
    with pytest.raises(ValueError, match="equal"):
        loop._accumulate(fn, tparams, {"tokens": tok[:3]}, 2)


def test_lm_token_stream_is_byte_identical():
    for vocab, seed, step, b, s in ((256, 0, 0, 4, 16), (151936, 3, 17, 8,
                                                         512),
                                    (255, 1, 2, 3, 7)):
        got = LMTokenStream(vocab, seed).batch(step, b, s)
        want = JTokens(vocab, seed).batch(step, b, s)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@functools.lru_cache(maxsize=None)
def _mind():
    jcfg = jget("mind").smoke_config()
    jparams = jmind.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get("mind").smoke_config()
    params = convert.mind_params_from_reference(
        {k: np.asarray(a) for k, a in jparams.items()}, "cpu")
    return jcfg, jparams, cfg, params


def _mind_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_mind_label_aware_attention_and_loss_match_reference():
    jcfg, jparams, cfg, params = _mind()
    b = RecsysStream(cfg.n_items, cfg.hist_len, seed=0).batch(2, 32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rng = np.random.default_rng(5)
    u = rng.normal(0, 0.3, (32, cfg.n_interests, cfg.embed_dim)).astype(
        np.float32)
    e = rng.normal(0, 0.3, (32, cfg.embed_dim)).astype(np.float32)
    _mind_close(tmind.label_aware_attention(cfg, torch.from_numpy(u),
                                            torch.from_numpy(e)),
                jmind.label_aware_attention(jcfg, jnp.asarray(u),
                                            jnp.asarray(e)))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmind.train_loss(jcfg, p, jb), has_aux=True)(jparams)
    loss, metrics, grads = loop.value_and_grad(
        lambda p, bb: tmind.train_loss(cfg, p, bb), params, b)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(metrics["loss"]) == float(loss)
    for k in ("item_embed", "s_map"):
        _mind_close(grads[k].numpy(), jg[k])


def test_mind_train_steps_match_reference():
    jcfg, jparams, cfg, params = _mind()
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, master_weights=False)
    jo, to = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    stream = JStream(cfg.n_items, cfg.hist_len, seed=0)
    batches = [stream.batch(i, 16) for i in range(3)]
    _train_both(jax.jit(jloop.make_mind_train_step(jcfg, jo)),
                loop.make_mind_train_step(cfg, to),
                (jparams, jopt.adamw_init(jparams, jo)),
                (params, opt.adamw_init(params, to)), batches,
                lambda s: float(opt.schedule(to, s)),
                cfg.n_items * cfg.embed_dim + cfg.embed_dim ** 2)


def test_flash_kernel_refuses_a_call_that_needs_its_gradient():
    # T4: the CUDA path's first step, run on CPU tensors as a stub of the
    # card's: under grad mode an input that requires grad is refused
    # before anything is launched
    q = torch.zeros(1, 4, 1, 1, 16, requires_grad=True)
    k = v = torch.zeros(1, 4, 1, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        fops._flash_cuda(q, k, v, None, None, torch.empty_like(q), True, 0)
    with torch.no_grad():
        fops._refuse_grad(q, k, v)
    fops._refuse_grad(q.detach(), k, v)
    # the plain version on the CPU is differentiable
    out = fops.flash_attention_pos(q, k, v)
    out.sum().backward()
    assert q.grad is not None and fops.LAUNCHES.flash_attention == 0
