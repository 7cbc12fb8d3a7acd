"""Parity of the port's threefry PRNG, key-based inits and move tables with
JAX (CPU).

``mcqueens_torch.core.rng`` reproduces ``jax.random`` (threefry2x32,
partitionable mode) from its uint32 arithmetic; ``core.init`` draws the
scan samplers' initial states from it and ``core.tables`` scores and
applies their moves.  Inputs come from numpy seeds.  Tolerance: none, every
word, state and delta is compared bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcqueens.core import energy as jenergy
from mcqueens.core import init as jinit
from mcqueens.core import rng as jrng
from mcqueens.core import tables as jtables
from mcqueens_torch.core import energy, init, rng, tables
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

SEEDS = np.array([0, 1, 42, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 123456789],
                 dtype=np.uint32)


def _key_data(keys):
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def _jkeys(seeds=SEEDS):
    return jrng.chain_keys_from_seeds(seeds)


def _tkeys(seeds=SEEDS):
    return rng.chain_keys_from_seeds(seeds)


def test_key_and_chain_keys():
    np.testing.assert_array_equal(_tkeys().numpy(), _key_data(_jkeys()))
    for s in SEEDS[:3]:
        np.testing.assert_array_equal(
            rng.key(s).numpy(), _key_data(jax.random.key(s)))
    np.testing.assert_array_equal(
        rng.chain_keys_from_seeds(np.arange(5) + 7).numpy(),
        _key_data(jrng.chain_keys(7, 5)))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_split(n):
    want = jax.vmap(lambda k: jax.random.split(k, n))(_jkeys())
    np.testing.assert_array_equal(rng.split(_tkeys(), n).numpy(),
                                  _key_data(want))


@pytest.mark.parametrize("data", [0, 1, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1,
                                  2 ** 31 - 2, 2 ** 31 - 1])
def test_fold_in_and_step_key(data):
    want = jax.vmap(lambda k: jax.random.fold_in(k, data))(_jkeys())
    np.testing.assert_array_equal(rng.fold_in(_tkeys(), data).numpy(),
                                  _key_data(want))
    np.testing.assert_array_equal(
        rng.step_key(_tkeys(), torch.tensor(data)).numpy(),
        _key_data(jax.vmap(lambda k: jrng.step_key(k, data))(_jkeys())))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 3, 5)])
def test_random_bits(shape):
    want = jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(
        _jkeys())
    np.testing.assert_array_equal(rng.random_bits(_tkeys(), shape).numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 2), (0, 4), (0, 5), (0, 15),
                                   (0, 1728), (0, 3375), (0, 70000),
                                   (3, 2 ** 31 - 1), (5, 5)])
def test_randint(lo, hi):
    """Spans 1, 2, N-1, N and N^3, one past 2^16 (the multiplier wraps to
    0) and an empty range (JAX returns minval)."""
    want = jax.vmap(lambda k: jax.random.randint(k, (6,), lo, hi,
                                                 jnp.int32))(_jkeys())
    got = rng.randint(_tkeys(), (6,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_tensor_maxval():
    """One call with a per-value range equals separate JAX calls."""
    keys = rng.split(_tkeys(), 3)
    got = rng.randint(keys, (), 0, torch.tensor([6, 6, 5]))
    jk = jax.vmap(lambda k: jax.random.split(k, 3))(_jkeys())
    for m, span in enumerate((6, 6, 5)):
        want = jax.vmap(lambda k: jax.random.randint(k, (), 0, span,
                                                     jnp.int32))(jk[:, m])
        np.testing.assert_array_equal(got[:, m].numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(), (7,), (4, 4)])
def test_uniform(shape):
    want = jax.vmap(lambda k: jax.random.uniform(k, shape))(_jkeys())
    got = rng.uniform(_tkeys(), shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 8, 27, 1000, 1625, 1626, 1728, 3375])
def test_permutation(n):
    """One sort round up to n = 1625, two from 1626 (JAX's count)."""
    want = jax.vmap(lambda k: jax.random.permutation(k, n))(_jkeys()[:3])
    np.testing.assert_array_equal(rng.permutation(_tkeys()[:3], n).numpy(),
                                  np.asarray(want))


def test_int32_words_round_trip():
    words = rng.split(_tkeys(), 4)
    bits = rng.as_int32(words)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  words.numpy().astype(np.uint32))
    assert torch.equal(rng.from_int32(bits), words)


# -- inits --------------------------------------------------------------


@pytest.mark.parametrize("N,mode", [(5, "random"), (6, "latin"),
                                    (11, "klarner"), (6, "klarner"),
                                    (8, "klarner"), (2, "random")])
def test_board_init(N, mode):
    """klarner at gcd(N, 210) = 1 (N=11) and the fallback core (N=6, 8)."""
    want = jax.vmap(lambda k: jinit.board_init(k, N, mode))(_jkeys())
    got = init.board_init(_tkeys(), N, mode)
    assert got.dtype == torch.int32 and got.shape == (len(SEEDS), N, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("N,mode,Q", [(3, "random", None), (5, "random", 13),
                                      (12, "random", 144), (2, "random", 7),
                                      (6, "latin", None),
                                      (11, "klarner", None),
                                      (6, "klarner", None),
                                      (12, "klarner", None)])
def test_full3d_init(N, mode, Q):
    """random draws a permutation of the N^3 cells (two sort rounds at
    N=12); the klarner fallback (N=6, 12) ranks uniforms, stably."""
    keys = _jkeys()[:4]
    jq, jocc = jax.vmap(lambda k: jinit.full3d_init(k, N, mode, Q=Q))(keys)
    q, occ = init.full3d_init(_tkeys()[:4], N, mode, Q=Q)
    assert q.dtype == torch.int32 and occ.dtype == torch.bool
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_init_guards():
    with pytest.raises(ValueError, match="Q = N"):
        init.full3d_init(_tkeys(), 4, "latin", Q=5)
    with pytest.raises(ValueError, match="Unknown init_mode"):
        init.board_init(_tkeys(), 4, "bogus")


# -- move tables and conflict scans ---------------------------------------


def _boards(N, C, seed):
    return np.random.default_rng(seed).integers(0, N, size=(C, N, N))


@pytest.mark.parametrize("N", [2, 5, 8])
def test_board_delta_e_and_apply_move(N):
    rs = np.random.default_rng(N)
    h = _boards(N, 16, N).astype(np.int32)
    i, j = rs.integers(0, N, 16), rs.integers(0, N, 16)
    old = h[np.arange(16), i, j]
    new = (old + 1 + rs.integers(0, N - 1, 16)) % N
    acc = rs.random(16) < 0.5
    jt = jax.vmap(jtables.build_board_table)(jnp.asarray(h))
    jd, jio, jin = jax.vmap(
        lambda t, a, b, c, d: jtables.board_delta_e(t, a, b, c, d, N))(
        jt, *(jnp.asarray(x, jnp.int32) for x in (i, j, old, new)))
    tt = tables.build_board_table(torch.from_numpy(h))
    d, io, inew = tables.board_delta_e(
        tt, *(torch.from_numpy(x.astype(np.int32)) for x in (i, j, old, new)),
        N)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(io.numpy(), np.asarray(jio))
    np.testing.assert_array_equal(inew.numpy(), np.asarray(jin))
    want = jax.vmap(jtables.apply_move)(jt, jio, jin, jnp.asarray(acc))
    got = tables.apply_move(tt, io, inew, torch.from_numpy(acc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the naive scan, batched over boards, gives the same deltas
    hb = torch.from_numpy(h)
    ij = [torch.from_numpy(x.astype(np.int32)) for x in (i, j)]
    new_t, old_t = (torch.from_numpy(x.astype(np.int32)) for x in (new, old))
    naive = (energy.board_conflicts(hb, *ij, new_t)
             - energy.board_conflicts(hb, *ij, old_t))
    np.testing.assert_array_equal(naive.numpy(), np.asarray(jd))
    want_c = jax.vmap(jenergy.board_conflicts)(
        jnp.asarray(h), jnp.asarray(i), jnp.asarray(j), jnp.asarray(new))
    np.testing.assert_array_equal(
        energy.board_conflicts(hb, *ij, new_t).numpy(), np.asarray(want_c))


@pytest.mark.parametrize("N,Q", [(3, 9), (4, 16), (5, 13)])
def test_full3d_delta_e_and_apply_move(N, Q):
    """Moves between distinct cells, old attacking new included: the
    overlapping line updates accumulate."""
    rs = np.random.default_rng(Q)
    C = 24
    cells = np.stack([rs.permutation(N ** 3)[:Q + 1] for _ in range(C)])
    q = np.stack([cells // (N * N), cells // N % N, cells % N], -1).astype(
        np.int32)
    queens, new = q[:, :Q], q[:, Q]
    mover = rs.integers(0, Q, C)
    old = queens[np.arange(C), mover]
    acc = rs.random(C) < 0.7
    jt = jax.vmap(lambda x: jtables.build_full3d_table(x, N))(
        jnp.asarray(queens))
    jd, jio, jin = jax.vmap(lambda t, o, n: jtables.full3d_delta_e(
        t, (o[0], o[1], o[2]), (n[0], n[1], n[2]), N))(
        jt, jnp.asarray(old), jnp.asarray(new))
    tt = tables.build_full3d_table(torch.from_numpy(queens), N)
    to, tn = torch.from_numpy(old), torch.from_numpy(new)
    d, io, inew = tables.full3d_delta_e(tt, to.unbind(1), tn.unbind(1), N)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    want = jax.vmap(jtables.apply_move)(jt, jio, jin, jnp.asarray(acc))
    got = tables.apply_move(tt, io, inew, torch.from_numpy(acc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tq, tm = torch.from_numpy(queens), torch.from_numpy(mover)
    naive = (energy.full3d_conflicts(tq, tm, tn.unbind(1))
             - energy.full3d_conflicts(tq, tm, to.unbind(1)))
    np.testing.assert_array_equal(naive.numpy(), np.asarray(jd))
    want_c = jax.vmap(lambda x, m, p: jenergy.full3d_conflicts(
        x, m, (p[0], p[1], p[2])))(jnp.asarray(queens), jnp.asarray(mover),
                                    jnp.asarray(new))
    np.testing.assert_array_equal(
        energy.full3d_conflicts(tq, tm, tn.unbind(1)).numpy(),
        np.asarray(want_c))
