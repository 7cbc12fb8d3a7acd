"""Parity of the port's foundation modules with the JAX package (CPU).

Inputs are made with numpy from a seed and fed to both packages.  Tolerance
is none (bitwise / exact integer equality) everywhere except the exp, log
and cos schedules, whose float32 values may differ by up to 2 ulp because
torch's and XLA's transcendental functions round differently (ROADMAP.md
queue 3).
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.core import energy as jenergy
from mcqueens.core import fastinit as jfastinit
from mcqueens.core import schedules as jschedules
from mcqueens.core import tables as jtables
from mcqueens.kernels import prng as jprng
from mcqueens.kernels import sizing as jsizing
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import energy, fastinit, schedules, tables
from mcqueens_torch.core.init import _klarner_core_m
from mcqueens_torch.kernels import prng, sizing
from mcqueens_torch.kernels.board_shared import block_size, padded_chains
from tests import _oracle


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    """Drop the process's compiled JAX executables before and after each
    port test module that uses JAX (the others import this fixture).  Every
    live XLA:CPU executable keeps memory maps: a module such as
    test_torch_chain.py adds ~13000 to its process, and an xdist worker
    that runs several such modules can reach the kernel's vm.max_map_count
    (65530), where XLA:CPU segfaults and the worker's test fails.  The
    persistent compile cache (tests/conftest.py) keeps the recompiles
    cheap; tests/test_tempering.py clears the same way.  It also resets
    Pallas interpret mode's shared state, which an interpret-mode kernel
    that raised leaves behind and which would fail the next module's
    kernels of another device count."""
    reset_interpret_mode()
    yield
    reset_interpret_mode()


def reset_interpret_mode():
    """Drop compiled executables, wait for in-flight interpret-mode
    callbacks (a failure among them belongs to the test that launched
    them) and reset the interpreter's shared state."""
    jax.clear_caches()
    try:
        jax.effects_barrier()
    except jax.errors.JaxRuntimeError:
        pass
    pltpu.reset_tpu_interpret_mode_state()

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _words(n=10000, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.integers(I32_MIN, I32_MAX, size=n, endpoint=True, dtype=np.int64)
    w[:6] = [I32_MIN, I32_MAX, -1, 0, 1, I32_MIN + 1]
    return w.astype(np.int32)


def _eq(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


@pytest.mark.parametrize("fn", ["_shr", "lowbias32", "chain_streams",
                                "words_from_base", "uniform01"])
def test_prng_unary_bitwise(fn):
    w = _words()
    t_out, j_out = (getattr(prng, fn), getattr(jprng, fn))
    if fn == "_shr":
        for k in (1, 7, 15, 16, 31):
            _eq(t_out(torch.from_numpy(w), k), j_out(jnp.asarray(w), k))
        return
    t_res = t_out(torch.from_numpy(w))
    j_res = j_out(jnp.asarray(w))
    if isinstance(t_res, tuple):
        for a, b in zip(t_res, j_res):
            _eq(a, b)
    else:
        _eq(t_res, j_res)


@pytest.mark.parametrize("step", [0, 1, 12345, 2 ** 24 + 1, I32_MAX,
                                  I32_MIN, -7])
def test_prng_step_keyed_bitwise(step):
    w = _words(seed=1)
    g = torch.from_numpy(w)
    jg = jnp.asarray(w)
    _eq(prng.step_base(g, step), jprng.step_base(jg, jnp.int32(step)))
    for a, b in zip(prng.step_words(g, step),
                    jprng.step_words(jg, jnp.int32(step))):
        _eq(a, b)
    # a tensor step counter wraps like the int one
    _eq(prng.step_base(g, torch.tensor(step, dtype=torch.int32)),
        jprng.step_base(jg, jnp.int32(step)))
    _eq(prng.word_from_base(g, step), jprng.word_from_base(jg,
                                                           jnp.int32(step)))
    lanes = np.arange(-64, 64, dtype=np.int32)
    _eq(prng.chain_ids(step, torch.from_numpy(lanes)),
        jprng.chain_ids(jnp.int32(step), jnp.asarray(lanes)))


@pytest.mark.parametrize("N", [5, 11, 12, 16])
@pytest.mark.parametrize("mode", ["random", "latin", "klarner"])
def test_board_init_batch_bitwise(N, mode):
    rng = np.random.default_rng(N)
    seeds = rng.integers(0, 2 ** 32, size=37, dtype=np.uint64).astype(
        np.uint32)
    seeds[:3] = [0, 2 ** 32 - 1, 42]
    want = np.asarray(jfastinit.board_init_batch(seeds, N, mode))
    got = fastinit.board_init_batch(
        torch.from_numpy(seeds.view(np.int32)), N, mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("salt", [0, 1, 2])
def test_uniform_ints_bitwise(salt):
    seeds = np.arange(2 ** 32 - 20, 2 ** 32, dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jfastinit.uniform_ints(seeds, (3, 7), 11, salt=salt))
    got = fastinit.uniform_ints(torch.from_numpy(seeds.view(np.int32)),
                                (3, 7), 11, salt=salt)
    np.testing.assert_array_equal(got.numpy(), want)


def test_klarner_core_m_matches():
    from mcqueens.core.init import _klarner_core_m as j_core_m

    for N in range(2, 40):
        assert _klarner_core_m(N) == j_core_m(N)


def _steps(n):
    base = [0, 1, 2, n - 2, n - 1, n, n + 1, 2 ** 24 - 1, 2 ** 24,
            2 ** 24 + 1, 2 ** 24 + 3, 2 ** 25 + 7, 123456789, I32_MAX]
    grid = np.linspace(0, n + 10, 997).astype(np.int64)
    return np.unique(np.clip(np.concatenate([base, grid]), 0,
                             I32_MAX)).astype(np.int32)


@pytest.mark.parametrize("n", [2, 400, 50000, 2 ** 24, 50_000_000])
@pytest.mark.parametrize("kind", schedules.SCHEDULE_TYPES)
def test_schedule_float32_parity(kind, n):
    kw = dict(beta_const=2.5, beta_start=0.7, beta_end=4.2)
    steps = _steps(n)
    want = np.asarray(jschedules.build_schedule(kind, n, **kw)(
        jnp.asarray(steps).astype(jnp.float32)))
    got = schedules.build_schedule(kind, n, **kw)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    got = got.numpy()
    if kind in ("constant", "linear_annealing"):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32))
        assert ulps.max() <= 2, (kind, n, int(ulps.max()))


def test_schedule_guards_and_labels():
    with pytest.raises(ValueError):
        schedules.build_schedule("cubic", 10)
    with pytest.raises(ValueError):
        schedules.build_schedule("constant", 10)
    with pytest.raises(ValueError):
        schedules.build_schedule("linear_annealing", 10, beta_start=1.0)
    for kind in schedules.SCHEDULE_TYPES:
        kw = dict(beta_const=1.5, beta_start=1.0, beta_end=3.0)
        assert (schedules.build_schedule(kind, 9, **kw).desc
                == jschedules.build_schedule(kind, 9, **kw).desc)
        assert (schedules.build_schedule(kind, 9, **kw).label
                == jschedules.build_schedule(kind, 9, **kw).label)
    s = schedules.schedule_from_params({"type": "constant",
                                        "beta_const": 2.0}, 5)
    assert s == schedules.Schedule("constant", 5, beta_const=2.0)


def test_sizing_matches_grid():
    for rows in (1, 7, 5 * 8 * 5, 5 * 16 * 16, 5 * 24 * 24, 5 * 40 * 40,
                 10 ** 6):
        for default in (128, 2048, 4096):
            cap = sizing.block_cap(rows, default)
            assert cap == jsizing.block_cap(rows, default)
            for n in (1, 127, 128, 129, 383, 384, 2047, 2048, 4096, 32768):
                assert sizing.block_size(n, cap) == jsizing.block_size(n,
                                                                       cap)


@pytest.mark.parametrize("N", [3, 5, 16, 21, 22, 24, 30])
def test_board_shared_block_size_matches(N):
    from mcqueens.kernels import board_shared as jbs

    spec = ChainSpec(N=N, n_steps=10,
                     schedule=schedules.build_schedule("constant", 10,
                                                       beta_const=1.0),
                     kernel="pallas_shared")
    jspec = JaxSpec(N=N, n_steps=10,
                    schedule=jschedules.build_schedule("constant", 10,
                                                       beta_const=1.0),
                    kernel="pallas_shared")
    for n in (1, 10, 129, 384, 4096, 32768):
        assert block_size(n, spec) == jbs.block_size(n, jspec)
        assert padded_chains(n, spec) == jbs.padded_chains(n, jspec)
        assert block_size(n) == jbs.block_size(n)


def _spec(**kw):
    base = dict(N=5, n_steps=100,
                schedule=schedules.build_schedule("constant", 100,
                                                  beta_const=1.0))
    base.update(kw)
    return ChainSpec(**base)


@pytest.mark.parametrize("bad", [
    dict(kernel="cuda"), dict(mcmc_type="board3"), dict(init_mode="zeros"),
    dict(history_stride=0), dict(N=1),
    dict(mcmc_type="full_3d", N=3, Q=27),
    dict(n_steps=2 ** 31 // 100 + 1, n_bins=100),
])
def test_chain_spec_guards_raise(bad):
    with pytest.raises(ValueError):
        _spec(**bad)


def test_chain_spec_properties():
    s = _spec(n_steps=2 ** 31 // 100 - 1, history_stride=7)
    assert s.n_outer == -(-s.n_steps // 7)
    assert s.n_history_points == s.n_outer + 1
    assert _spec(N=4).q_eff == 16 and _spec(Q=9).q_eff == 9


@pytest.mark.parametrize("N", [3, 5, 8])
def test_board_energy_matches_jax_and_oracle(N):
    rng = np.random.default_rng(100 + N)
    boards = rng.integers(0, N, size=(12, N, N)).astype(np.int32)
    got_batch = energy.board_energy(torch.from_numpy(boards))
    for b, board in enumerate(boards):
        want = int(jenergy.board_energy(jnp.asarray(board)))
        assert want == _oracle.board_energy(board)
        assert int(energy.board_energy(torch.from_numpy(board))) == want
        assert int(got_batch[b]) == want


def test_attacks_full3d_matches_jax():
    rng = np.random.default_rng(7)
    p = rng.integers(0, 6, size=(3, 500)).astype(np.int32)
    q = rng.integers(0, 6, size=(3, 500)).astype(np.int32)
    for board_mode in (False, True):
        got = energy.attacks(tuple(torch.from_numpy(x) for x in p),
                             tuple(torch.from_numpy(x) for x in q),
                             board_mode=board_mode)
        want = jenergy.attacks(tuple(jnp.asarray(x) for x in p),
                               tuple(jnp.asarray(x) for x in q),
                               board_mode=board_mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("full3d", [False, True])
def test_line_indices_match(full3d):
    N = 7
    rng = np.random.default_rng(3)
    ijk = rng.integers(0, N, size=(3, 64)).astype(np.int32)
    got = tables.line_indices(*(torch.from_numpy(x) for x in ijk), N,
                              full3d=full3d)
    want = jtables.line_indices(*(jnp.asarray(x) for x in ijk), N,
                                full3d=full3d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tables.table_size(N, full3d) == jtables.table_size(N, full3d)
    assert tables.family_offsets(N, full3d) == jtables.family_offsets(
        N, full3d)


@pytest.mark.parametrize("N,chunk", [(4, 8192), (6, 5), (16, 7)])
def test_batch_energies_match_jax_and_oracle(N, chunk):
    rng = np.random.default_rng(N)
    boards = rng.integers(0, N, size=(17, N, N)).astype(np.int32)

    def tfn(h):
        return tables.table_energy(tables.build_board_table(h))

    def jfn(h):
        return jtables.table_energy(jtables.build_board_table(h))

    # The port's chunking against the JAX package's unchunked energies.
    got = tables.batch_energies(torch.from_numpy(boards), tfn, chunk=chunk)
    want = np.asarray(jtables.batch_energies(jnp.asarray(boards), jfn))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(0, 17, 4):
        assert int(got[b]) == _oracle.board_energy(boards[b])
    table = tables.build_board_table(torch.from_numpy(boards[0]))
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(jtables.build_board_table(
            jnp.asarray(boards[0]))))


def test_port_never_imports_jax():
    # Only modules the import adds count, whatever the interpreter preloads.
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import mcqueens_torch, mcqueens_torch.cli.competition\n"
        "import mcqueens_torch.dist.runner, mcqueens_torch.kernels._build\n"
        "import mcqueens_torch.search.tempering\n"
        "import mcqueens_torch.kernels.full3d_shared\n"
        "import mcqueens_torch.kernels.probes, mcqueens_torch.tools\n"
        "import mcqueens_torch.tools.roofline\n"
        "import mcqueens_torch.tools.probe_full3d_cap\n"
        "import mcqueens_torch.tools.probe_full3d_alternatives\n"
        "import mcqueens_torch.tools.probe_swar_sweep\n"
        "import mcqueens_torch.kernels.probes_mem\n"
        "import mcqueens_torch.tools.probe_gather\n"
        "import mcqueens_torch.tools.probe_slice\n"
        "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m.startswith('mcqueens.') "
        "or m == 'tools' or m.startswith('tools.'))\n"
        "assert not bad, bad\n"
    )
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr


def test_klarner_init_is_optimal():
    # gcd(N, 210) == 1 boards are attack-free: the table energy is exactly 0.
    for N in (11, 13):
        h = fastinit.board_init_batch(torch.zeros(2, dtype=torch.int32), N,
                                      "klarner")
        e = tables.table_energy(tables.build_board_table(h))
        assert e.tolist() == [0, 0]
    assert math.gcd(12, 210) != 1  # N=12 takes the core + random path
