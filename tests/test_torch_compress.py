"""The port's gradient compression (``repro_torch.parallel.compress``)
against the reference's, on the CPU.

``quantize``/``dequantize`` are bitwise the reference's on seeded
inputs; the reference's own error-feedback test passes on the port; and
``compressed_psum``/``compressed_tree_psum`` over 2 and 4 gloo ranks
(child processes, ``tests/torch_ranks_common.py``) equal the reference's formula evaluated on the same
per-rank inputs with the reference's ``quantize``: the int32 sum of the
payloads times the mean scale over the rank count, bitwise for a sum of
the scales within 1 ulp of f32 of the reference's (gloo adds the ranks'
scales in an order of its own), and each rank's residual bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.parallel import compress as jc
from repro_torch.parallel import compress as tc
from release_xla import release_compiled  # noqa: F401
from torch_ranks_common import TREE, compress_case, shared_ranks

SHAPES = ((1000,), (7, 33), (2, 3, 5), (1,))


_case = compress_case


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bitwise(shape, bits):
    for seed, scale in ((0, 0.1), (1, 3e-7), (2, 50.0)):
        x = _case(seed, shape, scale)
        jq, js = jc.quantize(jnp.asarray(x), bits)
        tq, ts = tc.quantize(torch.from_numpy(x), bits)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.dtype == torch.float32
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            tc.dequantize(tq, ts).numpy().view(np.int32),
            np.asarray(jc.dequantize(jq, js)).view(np.int32))
    zq, zs = tc.quantize(torch.zeros(shape))         # all zero: scale floor
    assert float(zs) == np.float32(1e-12) and not zq.any()


def test_gradient_compression_error_feedback():
    """The reference's test (tests/test_train_substrate.py) on the port."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 0.1, (1000,)).astype(np.float32))
    q, scale = tc.quantize(g)
    deq = tc.dequantize(q, scale)
    assert float(torch.max(torch.abs(deq - g))) <= float(scale) * 0.51
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(50):
        q, scale = tc.quantize(g + err)
        deq = tc.dequantize(q, scale)
        err = (g + err) - deq
        acc = acc + deq
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(),
                               atol=float(scale))


def _ref_psum(grads, errors=None):
    """The reference's arithmetic over the ranks' inputs: its quantize on
    each rank, the int32 payload sum, the mean scale over the count.
    Returns the results for the scale sum in rank order and one ulp
    either side of it, and each rank's residual."""
    qs, scales, res = [], [], []
    for r, g in enumerate(grads):
        x = jnp.asarray(g) + (0 if errors is None else jnp.asarray(errors[r]))
        q, s = jc.quantize(x)
        qs.append(np.asarray(q, np.int32))
        scales.append(np.float32(s))
        res.append(np.asarray(x - jc.dequantize(q, s)))
    total = np.sum(qs, axis=0, dtype=np.int32).astype(np.float32)
    n = np.float32(len(grads))
    sum_scale = np.float32(0)
    for s in scales:
        sum_scale = np.float32(sum_scale + s)
    outs = []
    for ss in (np.nextafter(sum_scale, np.float32(-np.inf)), sum_scale,
               np.nextafter(sum_scale, np.float32(np.inf))):
        outs.append((total * np.float32(ss / n) / n).astype(np.float32))
    return outs, res


def _matches(got, candidates):
    assert any(np.array_equal(got.view(np.int32), c.view(np.int32))
               for c in candidates), (got[:4], candidates[1][:4])


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_over_gloo(world, tmp_path_factory, worker_id):
    out = shared_ranks(world, tmp_path_factory, worker_id, "compress")
    g = [_case(100 + r, (257,)) for r in range(world)]
    e = [_case(200 + r, (257,), 1e-3) for r in range(world)]
    for key_m, key_e, errs in (("mean", "err", e), ("mean0", "err0", None)):
        mean, res = _ref_psum(g, errs)
        for r in range(world):
            _matches(out[r][key_m], mean)
            np.testing.assert_array_equal(out[r][key_e].view(np.int32),
                                          res[r].view(np.int32))
    for key, (seed, shape, scale) in TREE.items():
        mean, res = _ref_psum([_case(seed + r, shape, scale)
                               for r in range(world)])
        for r in range(world):
            _matches(out[r][key], mean)
        if key == "tw":
            for r in range(world):
                np.testing.assert_array_equal(out[r]["ew"], res[r])
            mean2, _ = _ref_psum([_case(seed + r, shape, scale)
                                  for r in range(world)], res)
            for r in range(world):
                _matches(out[r]["tw2"], mean2)
