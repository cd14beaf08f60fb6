"""The port's embedding_bag (kernel wrapper and plain version) and recsys
embedding layer against the JAX reference, on the CPU.

Inputs come from numpy seeds and go to both packages as the same arrays.
The wrapper on CPU tensors runs the kernel's plain version
(``kernels/embedding_bag/ref.py``): a sum in lookup order, which the
reference's Pallas kernel (run here in interpret mode, as
``tests/test_kernels.py`` runs it) and its ``einsum`` oracle need not
match bit for bit, so those comparisons are at rtol/atol 1e-5, the
reference's own kernel tolerance.  Ids outside ``[0, V)`` are compared
exactly: which row each entry point reads, or NaN.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as jax_kernel
from repro.kernels.embedding_bag.ops import embedding_bag_ref as jax_oracle
from repro.models.recsys import embedding as jemb
from repro_torch.kernels.embedding_bag import ops
from repro_torch.models.recsys import embedding as temb
from release_xla import release_compiled  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(v, d, b, l, weighted, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32) if weighted else None
    return table, ids, w


def _port(table, ids, w, mode):
    t = lambda a: None if a is None else torch.from_numpy(a)
    return ops.embedding_bag(t(table), t(ids), t(w), mode=mode).numpy()


def _jax(fn, table, ids, w, mode):
    j = lambda a: None if a is None else jnp.asarray(a)
    return np.asarray(fn(j(table), j(ids), j(w), mode=mode))


# the 24 cases of tests/test_kernels.py::test_embedding_bag_shapes
@pytest.mark.parametrize("v,d,b,l", [(64, 16, 4, 3), (300, 32, 8, 7),
                                     (1000, 64, 2, 20)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_version_matches_reference_kernel(v, d, b, l, mode, weighted):
    table, ids, w = _case(v, d, b, l, weighted, seed=v + l)
    got = _port(table, ids, w, mode)
    assert got.dtype == np.float32 and got.shape == (b, d)
    np.testing.assert_allclose(got, _jax(jax_kernel, table, ids, w, mode),
                               **TOL)
    np.testing.assert_allclose(got, _jax(jax_oracle, table, ids, w, mode),
                               **TOL)


def test_plain_version_is_a_sum_in_lookup_order():
    """Bitwise against float32 numpy doing the kernel's arithmetic: from
    0, ``acc + row * w`` per lookup, then one divide by max(sum w, 1e-9)."""
    table, ids, w = _case(300, 32, 8, 7, True, seed=11)
    for mode in ("sum", "mean"):
        acc = np.zeros((8, 32), np.float32)
        ws = np.zeros((8, 1), np.float32)
        for i in range(7):
            acc = acc + table[ids[:, i]] * w[:, i:i + 1]
            ws = ws + w[:, i:i + 1]
        if mode == "mean":
            acc = acc / np.maximum(ws, np.float32(1e-9))
        assert _port(table, ids, w, mode).tobytes() == acc.tobytes()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_version_edge_bags(mode):
    """L = 1, and a bag whose weights are all 0 (its mean is 0, not NaN)."""
    table, ids, w = _case(64, 16, 4, 1, True, seed=3)
    np.testing.assert_allclose(_port(table, ids, w, mode),
                               _jax(jax_kernel, table, ids, w, mode), **TOL)
    table, ids, w = _case(64, 16, 3, 5, True, seed=4)
    w[1] = 0.0
    got = _port(table, ids, w, mode)
    assert not got[1].any()
    np.testing.assert_allclose(got, _jax(jax_kernel, table, ids, w, mode),
                               **TOL)


def test_plain_version_bf16_table():
    rng = np.random.default_rng(8)
    table = rng.normal(0, 1, (100, 32)).astype(np.float32)
    ids = rng.integers(0, 100, (6, 9)).astype(np.int32)
    t_bf = torch.from_numpy(table).to(torch.bfloat16)
    exact = t_bf.float().numpy()          # the bf16 values, widened exactly
    for mode in ("sum", "mean"):
        got = ops.embedding_bag(t_bf, torch.from_numpy(ids), mode=mode)
        assert got.dtype == torch.float32
        want = np.asarray(jax_kernel(jnp.asarray(exact, jnp.bfloat16),
                                     jnp.asarray(ids), mode=mode))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert got.numpy().tobytes() == _port(exact, ids, None,
                                              mode).tobytes()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_out_of_range_ids_follow_the_reference_kernel(mode):
    """-1 and -V wrap to id + V; V and 2V (and below -V) clamp into
    [0, V-1], as the Pallas kernel reads them in interpret mode."""
    v = 40
    table, _, w = _case(v, 16, 5, 4, True, seed=21)
    ids = np.array([[-1, 0, 3, -v], [v, 2 * v, 1, -1], [-v - 1, 5, 6, 7],
                    [2 ** 31 - 1, -2 ** 31, v - 1, 0], [-v, v, -1, 2 * v]],
                   np.int32)
    got = _port(table, ids, w, mode)
    assert np.isfinite(got).all()
    want = _jax(jax_kernel, table, ids, w, mode)
    np.testing.assert_allclose(got, want, **TOL)
    rows = np.where(ids < 0, ids.astype(np.int64) + v, ids).clip(0, v - 1)
    assert _port(table, rows.astype(np.int32), w, mode).tobytes() == \
        got.tobytes()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    table = torch.zeros((10, 16))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.embedding_bag(torch.zeros((10, 6)), ids)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.embedding_bag(torch.zeros((10, 12), dtype=torch.bfloat16), ids)
    with pytest.raises(TypeError, match="int32"):
        ops.embedding_bag(table, ids.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.embedding_bag(table.double(), ids)
    with pytest.raises(ValueError, match="do not match"):
        ops.embedding_bag(table, ids, torch.ones((2, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag(torch.zeros((16, 10)).t(), ids)
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag(table, ids, mode="max")
    empty = ops.embedding_bag(table, torch.zeros((0, 3), dtype=torch.int32))
    assert empty.shape == (0, 16) and empty.dtype == torch.float32
    assert ops.LAUNCHES.embedding_bag == 0        # CPU calls never launch


# --- the embedding layer -------------------------------------------------

def _same_or_both_nan(got, want, **tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), **tol)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_batched_layer_matches_reference(mode, masked):
    rng = np.random.default_rng(30)
    v, d, b, l = 200, 32, 7, 9
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    mask = rng.random((b, l)) < 0.7 if masked else None
    if masked:
        mask[2] = False                   # an all-masked bag: 0 either way
    got = temb.embedding_bag_batched(
        torch.from_numpy(table), torch.from_numpy(ids),
        None if mask is None else torch.from_numpy(mask), mode=mode)
    want = jemb.embedding_bag_batched(
        jnp.asarray(table), jnp.asarray(ids),
        None if mask is None else jnp.asarray(mask), mode=mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        assert not got[2].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_batched_layer_out_of_range_ids(mode):
    """Ids -1 and -V wrap; V and 2V give the reference's NaN row, which
    makes the bag NaN where the lookup is masked in and nothing where it
    is masked out."""
    v = 50
    rng = np.random.default_rng(31)
    table = rng.normal(0, 1, (v, 16)).astype(np.float32)
    ids = np.array([[-1, 2, 3], [-v, 4, 5], [v, 6, 7], [2 * v, 8, 9],
                    [v, -1, 1], [-v - 1, 0, 0], [1, 2, 2 * v]], np.int32)
    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1], [1, 0, 1], [0, 1, 1],
                     [0, 1, 1], [1, 1, 1]], bool)
    for m in (mask, None):
        got = temb.embedding_bag_batched(
            torch.from_numpy(table), torch.from_numpy(ids),
            None if m is None else torch.from_numpy(m), mode=mode)
        want = jemb.embedding_bag_batched(
            jnp.asarray(table), jnp.asarray(ids),
            None if m is None else jnp.asarray(m), mode=mode)
        _same_or_both_nan(got.numpy(), want, **TOL)
    nan_bags = np.isnan(got.numpy()).any(1)   # no mask: every OOB counts
    assert nan_bags.tolist() == [False, False, True, True, True, True, True]


def test_bag_inputs_carry_the_reference_semantics():
    ids = torch.tensor([[-1, 4, 10, -11]], dtype=torch.int32)
    mask = torch.tensor([[True, False, True, False]])
    kid, w = temb.bag_inputs(10, ids, mask)
    assert kid.tolist() == [[9, 0, 0, 0]] and kid.dtype == torch.int32
    assert w[0, 0] == 1 and w[0, 1] == 0 and w[0, 3] == 0
    assert torch.isnan(w[0, 2])


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ragged_layer_matches_reference(mode, weighted):
    """Unsorted bag ids, an empty bag (3), ids -1, -V, V and 2V (wrap or
    NaN), and bag ids -1 and n_bags (dropped, as segment_sum drops them)."""
    v, d, n_bags = 60, 16, 6
    rng = np.random.default_rng(40)
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    ids = rng.integers(0, v, 30).astype(np.int32)
    bag_ids = rng.choice([0, 1, 2, 4, 5], 30).astype(np.int32)
    ids[:4] = [-1, -v, v, 2 * v]
    bag_ids[:4] = [0, 1, 2, 2]
    bag_ids[4:6] = [-1, n_bags]
    w = rng.random(30).astype(np.float32) if weighted else None
    got = temb.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(bag_ids), n_bags,
        None if w is None else torch.from_numpy(w), mode=mode)
    want = jemb.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bag_ids), n_bags,
        None if w is None else jnp.asarray(w), mode=mode)
    _same_or_both_nan(got.numpy(), want, **TOL)
    assert np.isnan(got.numpy()[2]).all() and not got[3].any()
    assert np.isfinite(got.numpy()[[0, 1, 4, 5]]).all()


def test_take_rows_is_jnp_take():
    v = 8
    table = np.arange(v * 4, dtype=np.float32).reshape(v, 4)
    ids = np.array([[-1, -v, v, 2 * v], [-v - 1, 0, 7, 3]], np.int32)
    got = temb.take_rows(torch.from_numpy(table), torch.from_numpy(ids))
    want = jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0)
    _same_or_both_nan(got.numpy(), want, rtol=0, atol=0)
