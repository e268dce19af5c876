"""Port primitives vs the JAX package: lex search, sparse table, bitsets.

Same numpy inputs through the JAX function (CPU, jitted) and the port's
plain torch version; every output is an integer or bool array, so the
tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import bitset as jbits
from foundationdb_tpu.ops import lex as jlex
from foundationdb_tpu.ops import rmq as jrmq
from foundationdb_tpu_torch.ops import bitset as tbits
from foundationdb_tpu_torch.ops import lex as tlex
from foundationdb_tpu_torch.ops import rmq as trmq

I32MAX = np.iinfo(np.int32).max
NEG = -(2**31) + 1

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)


def sorted_rows(rng, n, w, n_pad):
    """Sorted [n + n_pad, W] int32 rows with ties and INT32_MAX padding."""
    rows = rng.integers(-3, 4, size=(n, w)).astype(np.int32)
    rows = rows[np.lexsort(rows.T[::-1])]
    pad = np.full((n_pad, w), I32MAX, np.int32)
    return np.concatenate([rows, pad])


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_words(w, side):
    rng = np.random.default_rng(10 + w)
    keys = sorted_rows(rng, 37, w, 5)
    q = np.concatenate([rng.integers(-4, 5, size=(60, w)).astype(np.int32),
                        keys[::3], np.full((2, w), I32MAX, np.int32)])
    want = np.asarray(jax.jit(jlex.searchsorted_words, static_argnums=2)(
        keys, q, side))
    got = tlex.searchsorted_words(torch.from_numpy(keys), torch.from_numpy(q),
                                  side).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_words_fp(side):
    rng = np.random.default_rng(3)
    keys = sorted_rows(rng, 50, 4, 3)
    q = np.concatenate([rng.integers(-4, 5, size=(40, 4)).astype(np.int32),
                        keys])
    want = np.asarray(jax.jit(jlex.searchsorted_words_fp, static_argnums=2)(
        keys, q, side))
    got = tlex.searchsorted_words_fp(torch.from_numpy(keys),
                                     torch.from_numpy(q), side).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 17, 100])
def test_sparse_table_and_range_max(n):
    rng = np.random.default_rng(n)
    v = rng.integers(-50, 50, size=n).astype(np.int32)
    v[rng.random(n) < 0.2] = NEG
    st_j = np.asarray(jax.jit(jrmq.sparse_table)(v))
    st_t = trmq.sparse_table(torch.from_numpy(v)).numpy()
    assert st_t.tobytes() == st_j.tobytes() and st_t.shape == st_j.shape
    lo = rng.integers(0, n, size=200).astype(np.int32)
    hi = rng.integers(0, n + 1, size=200).astype(np.int32)  # some empty
    want = np.asarray(jax.jit(jrmq.range_max, static_argnums=3)(
        jnp.asarray(st_j), lo, hi, NEG))
    got = trmq.range_max(torch.from_numpy(st_t), torch.from_numpy(lo),
                         torch.from_numpy(hi), NEG).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[hi <= lo] == NEG).all()


def test_floor_log2_matches_clz():
    x = np.array([1, 2, 3, 4, 7, 8, 1023, 1024, 2**30, 2**31 - 1], np.int32)
    want = 31 - np.asarray(jrmq._clz32(jnp.asarray(x)))
    np.testing.assert_array_equal(
        trmq.floor_log2(torch.from_numpy(x)).numpy(), want)


def test_bitset_pack_unpack_or_matvec():
    rng = np.random.default_rng(5)
    m = rng.random((7, 96)) < 0.4
    m[:, 31] = True  # the sign bit of every first word
    pj = np.asarray(jbits.pack_bits_u32(jnp.asarray(m)))
    pt = tbits.pack_bits_u32(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(pt.view(np.uint32), pj)
    np.testing.assert_array_equal(
        tbits.unpack_bits_u32(torch.from_numpy(pt), 96).numpy(),
        np.asarray(jbits.unpack_bits_u32(jnp.asarray(pj), 96)))
    vec = rng.random(96) < 0.1
    vj = np.asarray(jbits.pack_bits_u32(jnp.asarray(vec)))
    vt = tbits.pack_bits_u32(torch.from_numpy(vec))
    np.testing.assert_array_equal(
        tbits.or_matvec_u32(torch.from_numpy(pt), vt).numpy(),
        np.asarray(jbits.or_matvec_u32(jnp.asarray(pj), jnp.asarray(vj))))
