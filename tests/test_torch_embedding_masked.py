"""The masked entry of the port's embedding_bag (its plain version, which
the wrapper runs on CPU tensors) and the recsys layer built on it, against
the JAX reference's ``embedding_bag_batched``, on the CPU.

A masked-out lookup adds nothing, whatever its row holds, as the
reference's ``where(mask, row, 0)``; the layer once added ``row(0) * 0``
for it, NaN when row 0 is not finite.  On finite tables the masked entry
is bitwise the weighted entry fed the old ids and 0/1 weights
(``bag_inputs``).  Values are compared with the reference at the file's
``TOL`` (the sum runs in lookup order, the reference's ``sum(-2)`` in
XLA's), NaN and inf positions exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recsys import embedding as jemb
from repro_torch.kernels.embedding_bag import ops, ref
from repro_torch.models.recsys import embedding as temb
from release_xla import release_compiled  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _same_bits(got, want):
    """Bitwise equal, NaN where the other is NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                       want.masked_fill(nan, 0).view(torch.int32))


def _vs_reference(table, ids, mask, mode):
    """The port's layer and the reference's on the same arrays: NaN and inf
    at the same places, the rest within TOL.  Returns the port's."""
    got = temb.embedding_bag_batched(
        torch.from_numpy(table), torch.from_numpy(ids),
        None if mask is None else torch.from_numpy(mask), mode=mode).numpy()
    want = np.asarray(jemb.embedding_bag_batched(
        jnp.asarray(table), jnp.asarray(ids),
        None if mask is None else jnp.asarray(mask), mode=mode))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    return got


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_masked_out_lookups_add_nothing_to_a_non_finite_table(mode):
    """inf and NaN in row 0 and in row 7, which only masked-out lookups
    reach: a bag is NaN (or inf) exactly where the reference's is, and a
    bag whose masked-out lookups point at those rows stays finite."""
    rng = np.random.default_rng(50)
    v, d = 10, 8
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    table[0, 3], table[0, 5] = np.inf, np.nan
    table[7, 1], table[7, 2] = -np.inf, np.nan
    ids = rng.integers(1, v, (6, 4)).astype(np.int32)
    ids[ids == 7] = 8
    mask = np.ones((6, 4), bool)
    mask[1, 2:] = False                     # masked-out tail (was row 0)
    ids[2, 1], mask[2, 1] = 7, False        # the non-finite row, masked out
    ids[3, 0] = 0                           # row 0 masked in: inf and NaN
    ids[4, 3] = 2 * v                       # masked in, outside [-V, V)
    mask[5] = False                         # nothing masked in: 0
    ids[5, :2] = (0, 7)
    got = _vs_reference(table, ids, mask, mode)
    assert np.isfinite(got[[0, 1, 2]]).all()
    assert np.isnan(got[3, 5]) and np.isinf(got[3, 3])
    assert np.isfinite(np.delete(got[3], [3, 5])).all()
    assert np.isnan(got[4]).all() and not got[5].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_masked_entry_is_the_weighted_entry_on_finite_tables(dtype, mode):
    """Bitwise against ``embedding_bag_ref(table, *bag_inputs(...))`` on a
    finite table with -0.0 entries, a row of -0.0 at 0, a row of +0.0 and
    two rows that cancel (their sum is +0, never -0), with masked-out
    lookups, masked-in ids outside [-V, V) and wrapping ids."""
    rng = np.random.default_rng(51)
    v, d, b, l = 12, 16, 40, 9
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    table[rng.random((v, d)) < 0.2] = -0.0
    table[0] = -0.0
    table[3] = 0.0
    table[5] = -table[4]
    ids = rng.integers(-v - 2, v + 2, (b, l)).astype(np.int32)
    ids[rng.random((b, l)) < 0.3] = 0
    ids[:4, :2] = (4, 5)
    mask = rng.random((b, l)) < 0.7
    mask[:4, :2] = True
    mask[0, 2:] = False                     # row 4 + row 5 only: +0
    mask[6] = False
    mask[7], ids[7, 0], mask[7, 0] = False, 0, True   # the -0 row only: +0
    t = torch.from_numpy(table).to(dtype)
    i = torch.from_numpy(ids)
    for m in (torch.from_numpy(mask), None):
        got = ref.embedding_bag_masked_ref(t, i, m, mode=mode)
        _same_bits(got, ref.embedding_bag_ref(
            t, *temb.bag_inputs(v, i, m), mode=mode))
    got = ref.embedding_bag_masked_ref(t, i, torch.from_numpy(mask),
                                       mode=mode)
    for bag in (0, 6, 7):
        assert not got[bag].any() and not torch.signbit(got[bag]).any()


def test_masked_plain_version_is_a_sum_in_lookup_order():
    """Bitwise against float32 numpy doing the entry's rule: from +0, add
    each masked-in row in order, count it; mean divides by max(count,
    1e-9); a masked-in id outside [-V, V) makes the bag NaN."""
    rng = np.random.default_rng(52)
    v, d, b, l = 30, 8, 9, 7
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    ids = rng.integers(-v, v, (b, l)).astype(np.int32)
    ids[2, 3] = v
    mask = rng.random((b, l)) < 0.6
    mask[2, 3] = True
    for mode in ("sum", "mean"):
        acc = np.zeros((b, d), np.float32)
        cnt = np.zeros((b, 1), np.float32)
        for bag in range(b):
            for i in range(l):
                r = ids[bag, i] + (v if ids[bag, i] < 0 else 0)
                if mask[bag, i] and 0 <= r < v:
                    acc[bag] = acc[bag] + table[r]
                    cnt[bag] += 1
        if mode == "mean":
            acc = acc / np.maximum(cnt, np.float32(1e-9))
        acc[2] = np.nan
        got = ops.embedding_bag_masked(
            torch.from_numpy(table), torch.from_numpy(ids),
            torch.from_numpy(mask), mode=mode)
        _same_bits(got, torch.from_numpy(acc))


@pytest.mark.parametrize("v,d,b,l", [(64, 16, 4, 3), (300, 32, 8, 7),
                                     (1000, 64, 2, 20), (50, 8, 33, 1),
                                     (200, 128, 5, 65)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_masked_layer_matches_reference(v, d, b, l, mode):
    """Random ids (some outside [-V, V)) under a random mask, and without
    one, against the reference layer."""
    rng = np.random.default_rng(v + l)
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    ids[rng.random((b, l)) < 0.05] = -1
    ids[rng.random((b, l)) < 0.02] = v
    mask = rng.random((b, l)) < 0.75
    for m in (mask, None):
        _vs_reference(table, ids, m, mode)


def test_layer_calls_the_masked_entry_once(monkeypatch):
    """On the CPU the layer is one call of the masked entry's plain version
    and never the weighted one's."""
    calls = {"masked": 0, "weighted": 0}

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(ops, "embedding_bag_masked_ref",
                        counted("masked", ops.embedding_bag_masked_ref))
    monkeypatch.setattr(ops, "embedding_bag_ref",
                        counted("weighted", ops.embedding_bag_ref))
    rng = np.random.default_rng(53)
    table = torch.from_numpy(rng.normal(0, 1, (20, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 20, (5, 6)).astype(np.int32))
    temb.embedding_bag_batched(table, ids, ids > 3, mode="mean")
    temb.embedding_bag_batched(table, ids.long())
    assert calls == {"masked": 2, "weighted": 0}
    assert ops.LAUNCHES.embedding_bag_masked == 0


def test_masked_wrapper_refuses_what_the_kernel_does_not_take():
    table = torch.zeros((10, 16))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    mask = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(TypeError, match="mask must be torch.bool"):
        ops.embedding_bag_masked(table, ids, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="do not match"):
        ops.embedding_bag_masked(table, ids, mask[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag_masked(table, ids,
                                 torch.ones((3, 2), dtype=torch.bool).t())
    with pytest.raises(TypeError, match="int32"):
        ops.embedding_bag_masked(table, ids.long(), mask)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.embedding_bag_masked(torch.zeros((10, 6)), ids, mask)
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag_masked(table, ids, mask, mode="max")
    empty = ops.embedding_bag_masked(table, ids[:0], mask[:0], mode="mean")
    assert empty.shape == (0, 16) and empty.dtype == torch.float32
    none = ops.embedding_bag_masked(table, torch.zeros((4, 0),
                                                       dtype=torch.int32),
                                    mode="mean")
    assert none.shape == (4, 16) and not none.any()
