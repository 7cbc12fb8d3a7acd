"""Chain sharding (``mcqueens_torch.dist.mesh``) against the JAX package's
8-device CPU mesh (``tests/conftest.py``).

The port's CPU mesh repeats the one CPU device (``[cpu] * n``), its
counterpart of ``jax_num_cpu_devices=n``; the kernels' plain-torch twins run
each shard.  Every case of the JAX package's mesh tests (``test_dist.py``,
``test_pallas.py``, ``test_shared_kernel.py``, ``test_full3d_shared.py``,
``test_tempering.py``) is run in both packages and compared in every
``ChainResult`` field, carry field and ``ys`` row; the port's sharded run is
also held against its own unsharded run, at the same block for the
shared-site samplers.  Beside them: the padding rule over a grid of chain
and device counts, global block seeds, checkpoint resume under a mesh (and
its npz against the JAX package's), ``throughput_of``'s device count, the
CLIs' and configs' mesh.  Tolerance: none, except the float32 mean of
``global_best_stats`` (``rel=1e-6``, as ``tests/test_dist.py``).
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.core import schedules as jschedules
from mcqueens.dist import mesh as jmesh
from mcqueens.dist import runner as jrunner
from mcqueens.kernels import board_shared as jbs
from mcqueens.kernels import full3d_pallas as jf3p
from mcqueens.kernels import full3d_shared as jf3s
from mcqueens.kernels import metropolis_pallas as jmp
from mcqueens.search import tempering as jtempering
from mcqueens.utils import checkpoint as jcheckpoint
from mcqueens_torch.chain import board as board_chain
from mcqueens_torch.chain import full3d as full3d_chain
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import competition
from mcqueens_torch.cli import experiments as exp_cli
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import mesh
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import (board_shared, full3d_pallas,
                                    full3d_shared, metropolis_pallas)
from mcqueens_torch.kernels.carry import carry_to_numpy
from mcqueens_torch.search import tempering
from mcqueens_torch.utils import profiling
from mcqueens_torch.utils.checkpoint import Checkpointer
from tests.test_torch_checkpoint import RESULT_FIELDS, Killed, KilledAfter
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

CPU = torch.device("cpu")
LIN = dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)
CONST = dict(sched_type="constant", beta_const=1.0)
MODULES = {"pallas_shared-board": board_shared,
           "pallas_shared-full_3d": full3d_shared,
           "pallas-board": metropolis_pallas,
           "pallas-full_3d": full3d_pallas,
           "tables-board": board_chain, "naive-board": board_chain,
           "tables-full_3d": full3d_chain, "naive-full_3d": full3d_chain}


def cpu_mesh(n):
    return mesh.make_mesh([CPU] * n)


def sharded_segments(mp, mod, name="run_segment", before=None):
    """Record each sharded segment a search runs, as ``[shards, start]``:
    the shard carries ``mesh.run_sharded`` gets and the start chunk each
    shard's ``mod.<name>`` gets.  ``before(seen)`` runs ahead of each
    segment (a test's kill)."""
    seen, run_sharded, segment = [], mesh.run_sharded, getattr(mod, name)

    def sharded(fn, shards, *args):
        if before is not None:
            before(seen)
        seen.append([shards, None])
        return run_sharded(fn, shards, *args)

    def per_shard(carry, *args):
        seen[-1][1] = args[-3]  # (..., start_outer, spec, n_outer)
        return segment(carry, *args)

    mp.setattr(mesh, "run_sharded", sharded)
    mp.setattr(mod, name, per_shard)
    return seen


def jax_mesh(n):
    return jmesh.make_mesh(jax.devices()[:n])


def _specs(sched=LIN, **kw):
    kw = {"N": 5, "n_steps": 300, "init_mode": "random",
          "mcmc_type": "board", **kw}
    n = kw["n_steps"]
    return (JaxSpec(schedule=jschedules.build_schedule(n_steps=n, **sched),
                    **kw),
            ChainSpec(schedule=schedules.build_schedule(n_steps=n, **sched),
                      **kw))


def _same_results(want, got):
    for name in RESULT_FIELDS:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name


def _jax_run(seeds, jspec, n_dev=None, **kw):
    with pltpu.force_tpu_interpret_mode():
        return jrunner.run_chains(
            seeds, jspec, mesh=None if n_dev is None else jax_mesh(n_dev),
            **kw)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


# --- the mesh itself -------------------------------------------------------

def test_make_mesh_and_mesh_for():
    assert cpu_mesh(3) == (CPU, CPU, CPU)
    assert mesh.make_mesh(["cpu"]) == (CPU,)
    assert mesh.mesh_for("cpu") == (CPU,)
    assert mesh.mesh_for("cpu", 4) == (CPU,) * 4
    assert mesh.distinct(cpu_mesh(8)) == (CPU,)
    with pytest.raises(ValueError, match="at least one device"):
        mesh.make_mesh([])
    with pytest.raises(ValueError, match="a mesh of 0 devices"):
        mesh.mesh_for("cpu", 0)
    with pytest.raises(ValueError, match="disagree"):
        mesh.check_mesh(cpu_mesh(2), "cuda")
    if not torch.cuda.is_available():
        # No CPU fallback: the default mesh is the visible cards.
        with pytest.raises(RuntimeError, match="is_available"):
            mesh.make_mesh()
        with pytest.raises(RuntimeError, match="is_available"):
            mesh.mesh_for("cuda")


@pytest.mark.parametrize("kernel_type", [
    "pallas_shared-board", "pallas_shared-full_3d", "pallas-board",
    "pallas-full_3d"])
def test_pad_seeds_to_blocks_matches_jax(kernel_type):
    """Over chain counts 1-4100 and 1-8 devices, with each sampler's block
    rule at two widths: the same padded seeds and block as the JAX
    package's."""
    kernel, mcmc_type = kernel_type.split("-")
    jmod = {"pallas_shared-board": jbs, "pallas_shared-full_3d": jf3s,
            "pallas-board": jmp, "pallas-full_3d": jf3p}[kernel_type]
    mod = MODULES[kernel_type]
    for N in (5, 40):
        q = {"Q": 20} if mcmc_type == "full_3d" else {}
        jspec, spec = _specs(N=N, kernel=kernel, mcmc_type=mcmc_type, **q)
        for n_dev in range(1, 9):
            jm, m = jax_mesh(n_dev), cpu_mesh(n_dev)
            for n in (1, 7, 10, 127, 129, 300, 1000, 2049, 4100):
                seeds = 3 + np.arange(n, dtype=np.uint32)
                want = jmesh.pad_seeds_to_blocks(
                    seeds, jm, lambda c: jmod.block_size(c, jspec))
                got = mesh.pad_seeds_to_blocks(
                    seeds, m, lambda c: mod.block_size(c, spec))
                np.testing.assert_array_equal(got[0], want[0])
                assert got[0].dtype == want[0].dtype == np.uint32
                assert got[1] == want[1]
                assert (mesh.pad_chains(n, m)
                        == jmesh.pad_chains(n, jm))
    # Follow-on seeds wrap in uint32, as the JAX package's do.
    top = np.array([2 ** 32 - 2], np.uint32)
    got, _ = mesh.pad_seeds_to_blocks(top, cpu_mesh(2), lambda c: 128)
    np.testing.assert_array_equal(got[:3], [2 ** 32 - 2, 2 ** 32 - 1, 0])


def test_shard_and_gather_chains():
    """Blocks split by blocks, chains by chains, ``None`` stays ``None``,
    and gathering inverts sharding."""
    _, spec = _specs(kernel="pallas_shared")
    carry = board_shared.init_carry_batch(np.arange(512, dtype=np.uint32),
                                          spec, block=128, device=CPU)
    shards = mesh.shard_chains(carry, cpu_mesh(4))
    assert len(shards) == 4
    for s in shards:
        assert s.block_seeds.shape == (1, 1)
        assert s.heights.shape == (128, 25)
    back = carry_to_numpy(mesh.gather_chains(shards))
    for name, want in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    keys = runner.rng_mod.chain_keys_from_seeds(np.arange(8), CPU)
    _, nspec = _specs(kernel="naive")
    scan = board_chain.init_carry_batch(keys, nspec, device=CPU)
    parts = mesh.shard_chains(scan, cpu_mesh(2))
    assert parts[0].table is None and parts[1].step_base.shape == (4, 2)
    assert mesh.gather_chains(parts).table is None
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_chains(carry, cpu_mesh(3))


@pytest.mark.parametrize("kernel_type", ["pallas_shared-board",
                                         "pallas_shared-full_3d"])
def test_block_seeds_are_global(kernel_type, monkeypatch):
    """The runner builds the whole carry once and splits it, so shard s's
    blocks keep the seeds ``int32(seeds[0]) + 7919 * b`` of their global
    index b.  Carries initialised shard by shard would restart b at 0 from
    the shard's first seed; they differ here, and so do their runs."""
    kernel, mcmc_type = kernel_type.split("-")
    q = {"Q": 12, "N": 4} if mcmc_type == "full_3d" else {}
    _, spec = _specs(kernel=kernel, mcmc_type=mcmc_type, n_steps=100,
                     history_stride=50, **q)
    mod = MODULES[kernel_type]
    seeds = 40 + np.arange(512, dtype=np.uint32)
    with monkeypatch.context() as mp:
        seen = sharded_segments(mp, mod)
        got = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(4))
    block_seeds = torch.cat([s.block_seeds for s in seen[0][0]]).reshape(-1)
    np.testing.assert_array_equal(block_seeds.numpy(),
                                  40 + 7919 * np.arange(4))
    # Separately initialised shards: other block seeds, other trajectories.
    parts = [mod.init_carry_batch(p, spec, block=128, device=CPU)
             for p in np.split(seeds, 4)]
    assert [int(p.block_seeds[0, 0]) for p in parts] == [40, 168, 296, 424]
    ys = torch.cat([mod.run_segment(p, 0, spec, spec.n_outer)[1]
                    for p in parts], dim=1).numpy()
    assert not np.array_equal(ys.T, got.energy_history[:, 1:])
    whole = mod.init_carry_batch(seeds, spec, block=128, device=CPU)
    _, want = mod.run_segment(whole, 0, spec, spec.n_outer)
    np.testing.assert_array_equal(want.numpy().T, got.energy_history[:, 1:])


# --- tests/test_dist.py ------------------------------------------------------

@pytest.mark.parametrize("kernel_type", ["tables-board", "naive-board",
                                         "tables-full_3d"])
def test_scan_sharded_equals_unsharded_and_jax(kernel_type):
    """tests/test_dist.py:74 for both scan kernels and both state kinds: the
    8-shard run equals the unsharded one and the JAX 8-device run."""
    kernel, mcmc_type = kernel_type.split("-")
    q = {"Q": 9, "N": 4} if mcmc_type == "full_3d" else {}
    jspec, spec = _specs(kernel=kernel, mcmc_type=mcmc_type, **q)
    seeds = np.arange(16, dtype=np.uint32)
    want = _jax_run(seeds, jspec, 8)
    got = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(8))
    _same_results(want, got)
    _same_results(runner.run_chains(seeds, spec, device="cpu"), got)


def test_sharded_run_pads_nondivisible_chain_count():
    """tests/test_dist.py:88: 10 chains over 8 shards are padded to 16 and
    sliced back; config.yaml's 10 chains, with and without warm starts."""
    jspec, spec = _specs(kernel="tables")
    seeds = np.arange(10, dtype=np.uint32)
    got = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(8))
    assert got.n_runs == 10
    _same_results(_jax_run(seeds, jspec, 8), got)
    _same_results(runner.run_chains(seeds, spec, device="cpu"), got)
    warm = np.random.default_rng(5).integers(0, 5, (10, 5, 5)).astype(
        np.int32)
    got = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(8),
                            initial_states=warm)
    _same_results(_jax_run(seeds, jspec, 8, initial_states=warm), got)


def test_submesh_equivalence():
    """tests/test_dist.py:97: a 2-shard mesh gives the 8-shard mesh's
    chains, and the JAX 2-device mesh's."""
    jspec, spec = _specs(kernel="tables")
    seeds = np.arange(8, dtype=np.uint32)
    a = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(2))
    b = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(8))
    _same_results(a, b)
    _same_results(_jax_run(seeds, jspec, 2), a)


def test_global_best_stats():
    """tests/test_dist.py:108, on the whole rows and on shard rows."""
    jspec, spec = _specs(kernel="tables")
    seeds = np.arange(8, dtype=np.uint32)
    res = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(8))
    jres = _jax_run(seeds, jspec, 8)
    jmin, jarg, jmean = jax.jit(jmesh.global_best_stats)(
        jres.best_energy, jres.final_energy)
    for args in ((res.best_energy, res.final_energy),
                 (mesh.shard_chains(torch.from_numpy(res.best_energy),
                                    cpu_mesh(4)),
                  mesh.shard_chains(torch.from_numpy(res.final_energy),
                                    cpu_mesh(4)))):
        gmin, gargmin, mean_e = mesh.global_best_stats(*args)
        assert gmin == res.best_energy.min() == int(jmin)
        assert gargmin == int(jarg)
        assert res.best_energy[gargmin] == gmin
        assert mean_e.dtype == np.float32
        assert float(mean_e) == pytest.approx(res.final_energy.mean(),
                                              rel=1e-6)
        assert float(mean_e) == pytest.approx(float(jmean), rel=1e-6)
    # Ties go to the first chain holding the minimum, across shards.
    best = [torch.tensor([3, 1]), torch.tensor([1, 0, 0])]
    assert mesh.global_best_stats(best, [torch.zeros(5)])[:2] == (0, 3)


# --- the Pallas samplers ---------------------------------------------------

@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_per_chain_sharded_matches_jax_and_unsharded(mcmc_type):
    """tests/test_pallas.py:165 for both per-chain samplers: a 2-shard run
    (its block sized from one shard's share) equals the unsharded run and
    the JAX 2-device run; 10 warm-started chains over 4 shards too (padded
    to 12 by repeating the last warm start)."""
    q = {"Q": 12, "N": 4} if mcmc_type == "full_3d" else {}
    jspec, spec = _specs(kernel="pallas", mcmc_type=mcmc_type, n_steps=200,
                         history_stride=50, **q)
    seeds = np.arange(16, dtype=np.uint32)
    got = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(2))
    _same_results(_jax_run(seeds, jspec, 2), got)
    _same_results(runner.run_chains(seeds, spec, device="cpu"), got)
    seeds = 7 + np.arange(10, dtype=np.uint32)
    rs = np.random.default_rng(1)
    if mcmc_type == "board":
        starts = rs.integers(0, spec.N, (10, spec.N, spec.N)).astype(np.int32)
    else:
        cells = np.stack([rs.permutation(64)[:12] for _ in range(10)])
        starts = np.stack([cells // 16, cells // 4 % 4, cells % 4],
                          axis=-1).astype(np.int32)
    got = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(4),
                            initial_states=starts)
    _same_results(_jax_run(seeds, jspec, 4, initial_states=starts), got)
    _same_results(runner.run_chains(seeds, spec, device="cpu",
                                    initial_states=starts), got)


def test_board_shared_sharded_matches_same_block_layout():
    """tests/test_shared_kernel.py:153: 256 chains over 2 shards run at
    128-chain blocks, as an unsharded run forced to 128-chain blocks and the
    JAX 2-device run."""
    jspec, spec = _specs(kernel="pallas_shared", n_steps=200,
                         history_stride=100)
    seeds = np.arange(256, dtype=np.uint32)
    got = runner.run_chains(seeds, spec, device="cpu", mesh=cpu_mesh(2))
    _same_results(_jax_run(seeds, jspec, 2), got)
    carry = board_shared.init_carry_batch(seeds, spec, block=128, device=CPU)
    carry, ys = board_shared.run_segment(carry, 0, spec, 2)
    np.testing.assert_array_equal(got.final_energy,
                                  carry.energy.reshape(-1).numpy())
    np.testing.assert_array_equal(got.energy_history[:, 1:], ys.numpy().T)
    # The unsharded run blocks all 256 chains together: another result.
    assert not np.array_equal(
        runner.run_chains(seeds, spec, device="cpu").energy_history,
        got.energy_history)


def test_full3d_shared_sharded_matches_unsharded_and_jax():
    """tests/test_full3d_shared.py:122: 8 shards of block_size(1) chains,
    run_segment shard by shard (mesh.run_sharded) on the split carry against
    run_segment on the whole one and against the JAX package's sharded
    segment, every carry field."""
    n_dev, per_dev = 8, full3d_shared.block_size(1)
    jspec, spec = _specs(kernel="pallas_shared", mcmc_type="full_3d",
                         n_steps=150, history_stride=50)
    seeds = np.arange(n_dev * per_dev, dtype=np.uint32)
    with pltpu.force_tpu_interpret_mode():
        jcarry = jf3s.init_carry_batch(seeds, jspec, block=per_dev)
        jcarry, jys = jf3s.run_segment_sharded(
            jmesh.shard_chains(jcarry, jax_mesh(n_dev)), np.int32(0), jspec,
            jspec.n_outer, jax_mesh(n_dev))
    carry = full3d_shared.init_carry_batch(seeds, spec, block=per_dev,
                                           device=CPU)
    a, ys_a = full3d_shared.run_segment(carry, 0, spec, spec.n_outer)
    m = cpu_mesh(n_dev)
    shards, ys_b = mesh.run_sharded(
        lambda c: full3d_shared.run_segment(c, 0, spec, spec.n_outer),
        mesh.shard_chains(carry, m), m)
    b = mesh.gather_chains(shards)
    np.testing.assert_array_equal(ys_b.numpy(), ys_a.numpy())
    np.testing.assert_array_equal(ys_b.numpy(), np.asarray(jys))
    want = {k: np.asarray(v) for k, v in jcarry._asdict().items()}
    for name, got in carry_to_numpy(b).items():
        np.testing.assert_array_equal(got, carry_to_numpy(a)[name],
                                      err_msg=name)
        np.testing.assert_array_equal(got, want[name], err_msg=name)


@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_tempered_sharded_matches_unsharded_and_jax(mcmc_type):
    """tests/test_tempering.py:266 for both shared-site samplers: 8 chains
    over 8 shards (1024 padded) equal the unsharded search and the JAX
    8-device search in every output; the exchange stays keyed by global
    group id."""
    q = {"Q": 12, "N": 4} if mcmc_type == "full_3d" else {}
    jspec, spec = _specs(CONST, kernel="pallas_shared", mcmc_type=mcmc_type,
                         n_steps=200, history_stride=50, **q)
    seeds = np.arange(8, dtype=np.uint32)
    ladder = tempering.geometric_ladder(0.5, 3.0, 4)
    with pltpu.force_tpu_interpret_mode():
        want = jtempering.run_tempered(seeds, jspec, ladder, swap_seed=3,
                                       mesh=jax_mesh(8), record_betas=True)
    got = tempering.run_tempered(seeds, spec, ladder, device="cpu",
                                 swap_seed=3, mesh=cpu_mesh(8),
                                 record_betas=True)
    plain = tempering.run_tempered(seeds, spec, ladder, device="cpu",
                                   swap_seed=3, record_betas=True)
    assert set(got) == set(want)
    for key in want:
        if key in ("wall_time", "proposals"):
            continue
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
        np.testing.assert_array_equal(got[key], plain[key], err_msg=key)
    assert got["proposals"] == int(want["proposals"])  # 1024 chains' worth


def test_tempered_refuses_groups_across_shards():
    """A block that is not a multiple of the ladder length would split a
    ladder group between two shards (tempering.py:197-201)."""
    jspec, spec = _specs(CONST, kernel="pallas_shared", n_steps=100,
                         history_stride=50)
    ladder = tempering.geometric_ladder(0.5, 3.0, 3)
    seeds = np.arange(6, dtype=np.uint32)
    with pytest.raises(ValueError, match="ladder groups must not straddle"):
        jtempering.run_tempered(seeds, jspec, ladder, mesh=jax_mesh(2))
    with pytest.raises(ValueError, match="ladder groups must not straddle"):
        tempering.run_tempered(seeds, spec, ladder, device="cpu",
                               mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="disagree"):
        tempering.run_tempered(seeds, spec, ladder, device="cpu",
                               mesh=["cuda:0"])


# --- checkpoints, throughput, entry points --------------------------------

class JaxKilledAfter(jcheckpoint.Checkpointer):
    def save(self, carry, segments_done, chunks, **kw):
        super().save(carry, segments_done, chunks, **kw)
        if segments_done == 2:
            raise Killed()


@pytest.mark.parametrize("kernel", ["tables", "pallas_shared"])
def test_sharded_resume_and_files_match_jax(kernel, tmp_path, monkeypatch):
    """A 4-shard run killed after 2 of 4 segments resumes (only segments 2
    and 3 run) and equals the uninterrupted sharded run; its npz holds the
    whole carry in shard order and equals the JAX 4-device run's in every
    array but ``fingerprint``, and so do the history chunks."""
    jspec, spec = _specs(kernel=kernel, n_steps=200, history_stride=50)
    seeds = 3 + np.arange(10, dtype=np.uint32)
    m = cpu_mesh(4)
    want = runner.run_chains(seeds, spec, device="cpu", mesh=m)
    ck = KilledAfter(str(tmp_path / "torch"), kill_at=2, min_segments=4)
    with pytest.raises(Killed):
        runner.run_chains(seeds, spec, device="cpu", mesh=m, checkpointer=ck)
    jck = JaxKilledAfter(str(tmp_path / "jax"), min_segments=4)
    with pytest.raises(Killed):
        _jax_run(seeds, jspec, 4, checkpointer=jck)
    with np.load(jck.path) as jz, np.load(ck.path) as z:
        assert sorted(z.files) == sorted(jz.files)
        for key in jz.files:
            if key != "fingerprint":
                assert z[key].dtype == jz[key].dtype, key
                np.testing.assert_array_equal(z[key], jz[key], err_msg=key)
        fp, jfp = str(z["fingerprint"]), str(jz["fingerprint"])
    for i in range(2):
        np.testing.assert_array_equal(np.load(ck.chunk_path(i, fp)),
                                      np.load(jck.chunk_path(i, jfp)))
    mod = MODULES[f"{kernel}-board"]
    seen = sharded_segments(monkeypatch, mod)
    got = runner.run_chains(seeds, spec, device="cpu", mesh=m,
                            checkpointer=Checkpointer(str(tmp_path / "torch"),
                                                      min_segments=4))
    starts = [start for _, start in seen]
    assert starts == [2, 3]
    _same_results(want, got)


def test_tempered_sharded_resume(tmp_path, monkeypatch):
    """A tempered 8-shard search killed after 2 rounds resumes from its
    checkpoint (carry gathered in shard order, betas) and equals the
    uninterrupted one."""
    _, spec = _specs(CONST, kernel="pallas_shared", n_steps=200,
                     history_stride=50)
    seeds = np.arange(8, dtype=np.uint32)
    ladder = tempering.geometric_ladder(0.5, 3.0, 4)
    kw = dict(device="cpu", swap_seed=5, mesh=cpu_mesh(8))
    want = tempering.run_tempered(seeds, spec, ladder, **kw)
    def dying(seen):
        if len(seen) == 2:
            raise Killed()

    ck = Checkpointer(str(tmp_path), tag="pt")
    with monkeypatch.context() as mp:
        seen = sharded_segments(mp, board_shared, "run_segment_tempered",
                                dying)
        with pytest.raises(Killed):
            tempering.run_tempered(seeds, spec, ladder, checkpointer=ck,
                                   **kw)
    calls = [start for _, start in seen]
    assert calls == [0, 1]
    with monkeypatch.context() as mp:
        seen = sharded_segments(mp, board_shared, "run_segment_tempered")
        got = tempering.run_tempered(seeds, spec, ladder, checkpointer=ck,
                                     **kw)
    calls = [start for _, start in seen]
    assert calls == [2, 3]
    with np.load(ck.path) as z:
        assert z["carry_energy"].shape == (1024, 1)
    for key in want:
        if key != "wall_time":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_throughput_divides_by_the_devices_used():
    """throughput_of divides by the distinct devices of the run: one for a
    CPU mesh of any size, two for a mesh over two cards."""
    _, spec = _specs(kernel="tables", n_steps=50)
    res = runner.run_chains(np.arange(4, dtype=np.uint32), spec,
                            device="cpu", mesh=cpu_mesh(4))
    assert res.devices == ("cpu",)
    report = profiling.throughput_of(res)
    assert report.n_devices == 1
    assert report.moves_per_sec_per_chip == report.moves_per_sec
    plain = runner.run_chains(np.arange(4, dtype=np.uint32), spec,
                              device="cpu")
    assert plain.devices == ("cpu",)
    two = runner.ChainResult(**{**vars(res),
                                "devices": ("cuda:0", "cuda:1")})
    assert profiling.throughput_of(two).n_devices == 2
    assert profiling.throughput_of(two, n_devices=4).n_devices == 4
    with pytest.raises(ValueError, match="disagree"):
        runner.run_chains(np.arange(4, dtype=np.uint32), spec, device="cpu",
                          mesh=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        mesh.make_mesh(["cpu", "meta"])


def test_experiments_tpu_mesh_shards_on_the_cpu(tmp_path, monkeypatch):
    """tpu.mesh: n on --device cpu runs n shards of the CPU (recorded at
    each sharded segment), ``true`` one, and the sweep's CSV equals the
    JAX CLI's with the same config on its n-device mesh; --mesh overrides
    tpu.mesh with every device (one CPU shard)."""
    from mcqueens.cli import experiments as jexp_cli

    raw = {
        "experiment_type": "beta_start_end_pairs",
        "common": {"n_steps": 200, "n_runs": 5, "verbose": False,
                   "initialization": "random", "mcmc_type": "board",
                   "early_stop_patience": None,
                   "betta_scheduling": {"type": "linear_annealing",
                                        "base_seed": 7},
                   "output_path": "figures/pairs.png"},
        "beta_start_end_pairs": {"N": 5, "beta_start_ends": [[0.5, 3.0]]},
        "tpu": {"kernel": "pallas", "history_stride": 50, "mesh": 4},
    }
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    seen = sharded_segments(monkeypatch, metropolis_pallas)
    pytest.importorskip("matplotlib")
    pytest.importorskip("pandas")
    _cli(exp_cli.main, ["--config", str(cfg), "--outdir",
                        str(tmp_path / "torch"), "--device", "cpu"])
    shards = [len(parts) for parts, _ in seen]
    assert shards and set(shards) == {4}
    with pltpu.force_tpu_interpret_mode():
        _cli(jexp_cli.main, ["--config", str(cfg), "--outdir",
                             str(tmp_path / "jax")])
    got = sorted((tmp_path / "torch").rglob("*.csv"))
    want = sorted((tmp_path / "jax").rglob("*.csv"))
    assert [p.name for p in got] == [p.name for p in want] and got
    for g, w in zip(got, want):
        assert g.read_text() == w.read_text(), g.name
    seen.clear()
    _cli(exp_cli.main, ["--config", str(cfg), "--outdir",
                        str(tmp_path / "all"), "--device", "cpu", "--mesh"])
    shards = [len(parts) for parts, _ in seen]
    assert shards and set(shards) == {1}


def test_competition_mesh_on_the_cpu_is_one_shard(tmp_path):
    """--mesh on --device cpu: a mesh of one shard (torch sees one CPU), so
    the printed energies and the export equal the run without it."""
    argv = ["--n", "5", "--n-runs", "10", "--n-steps", "200",
            "--history-stride", "50", "--kernel", "pallas", "--device",
            "cpu"]
    a = _cli(competition.main, argv + ["--outdir", str(tmp_path / "a")])
    b = _cli(competition.main, argv + ["--mesh", "--outdir",
                                       str(tmp_path / "b")])
    assert ([x for x in a.splitlines() if "proposals in" not in x][:-1]
            == [x for x in b.splitlines() if "proposals in" not in x][:-1])
    (pa,) = (tmp_path / "a" / "competition_results").glob("*.txt")
    (pb,) = (tmp_path / "b" / "competition_results").glob("*.txt")
    assert pa.read_text() == pb.read_text()
    assert "/chip on 1)" in b


def test_port_mesh_imports_no_jax():
    """dist/mesh.py imports neither jax nor the JAX package."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import mcqueens_torch.dist.mesh, mcqueens_torch.dist.runner\n"
            "assert 'jax' not in sys.modules, 'jax'\n"
            "assert not any(m == 'mcqueens' or m.startswith('mcqueens.')\n"
            "               for m in sys.modules)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
