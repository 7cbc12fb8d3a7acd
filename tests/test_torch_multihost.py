"""Several processes (``mcqueens_torch.dist.mesh.init_distributed``, a mesh
that spans them, ``python -m mcqueens_torch.tools.check_multihost``) on the
CPU.

Each case spawns real OS processes joined in a ``gloo`` group over
``localhost``, each owning its own shards of the one CPU device, runs the
board ``tables`` scan's twin on its shards and gathers across the process
boundary.  Every process's JSON must agree, and ``final_energy``, min and
sum must equal the JAX package's one-process ``runner.run_chains`` of the
same seeds bitwise (tolerance none), also where the chains need padding
across processes (10 chains over 3 processes).  Beside it: a bad or
unreachable coordinator raises within its timeout, a second
``init_distributed`` in a group of one is a no-op and one of another size
or rank raises, and ``run_chains``, ``run_tempered``, both CLIs' ``--mesh``
and the configs' ``tpu.mesh`` refuse a mesh with another process's shards
(``ValueError``), as the JAX package's runner does.  The slow-marked
``tests/test_multihost.py`` runs the JAX tool itself.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import yaml

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import mesh
from mcqueens_torch.dist import runner
from mcqueens_torch.search import tempering

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# Spawned processes: one thread each (several run at once) and no other
# process's coordinator.
ENV = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
PROCESS_TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv_of, n_procs):
    """Run ``argv_of(port, rank)`` for every rank at once; returns their
    outputs.  A port taken between choosing and binding it is retried once
    on another."""
    for attempt in range(2):
        port = _free_port()
        procs = [subprocess.Popen(argv_of(port, r), cwd=REPO, env=ENV,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(n_procs)]
        try:
            logs = [p.communicate(timeout=PROCESS_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if all(p.returncode == 0 for p in procs):
            return logs
        if attempt == 0 and any("address already in use" in log.lower()
                                for log in logs):
            continue
        raise AssertionError("\n---\n".join(logs))


def _jax_run_chains(n, n_steps, n_chains):
    """The JAX package's one-process run of the tool's chains."""
    from mcqueens.chain.spec import ChainSpec as JaxSpec
    from mcqueens.core.schedules import build_schedule
    from mcqueens.dist import runner as jrunner

    spec = JaxSpec(N=n, n_steps=n_steps,
                   schedule=build_schedule("linear_annealing", n_steps,
                                           beta_start=0.5, beta_end=3.0),
                   init_mode="random", mcmc_type="board", kernel="tables",
                   history_stride=n_steps)
    return jrunner.run_chains(np.arange(n_chains, dtype=np.uint32), spec)


@pytest.mark.parametrize("n_procs,shards,n_chains", [
    (2, 4, 8),    # the JAX tool's case: 2 processes x 4 devices
    (3, 1, 10),   # 10 chains padded to 12 across 3 processes
], ids=["2x4-8chains", "3x1-10chains-padded"])
def test_processes_match_one_process_run(tmp_path, n_procs, shards,
                                         n_chains):
    n, n_steps = 5, 500
    outs = [tmp_path / f"mh{r}.json" for r in range(n_procs)]
    _spawn(lambda port, r: [
        sys.executable, "-m", "mcqueens_torch.tools.check_multihost",
        "--device", "cpu", "--local-shards", str(shards),
        "--coordinator", f"localhost:{port}",
        "--num-processes", str(n_procs), "--process-id", str(r),
        "--out", str(outs[r]), "--n", str(n), "--n-steps", str(n_steps),
        "--n-chains", str(n_chains), "--timeout", "60"], n_procs)
    results = [json.loads(p.read_text()) for p in outs]
    keys = ("final_energy", "min_energy", "sum_energy", "n_devices",
            "n_processes")
    for r, res in enumerate(results):
        assert res["process_id"] == r
        assert res["n_processes"] == n_procs
        assert res["n_devices"] == n_procs * shards
        assert res["n_local_devices"] == shards
        assert {k: res[k] for k in keys} == {k: results[0][k] for k in keys}
        assert len(res["seconds"]["shards"]) == shards

    want = _jax_run_chains(n, n_steps, n_chains)
    np.testing.assert_array_equal(
        np.asarray(results[0]["final_energy"]), want.final_energy)
    assert results[0]["min_energy"] == int(want.final_energy.min())
    assert results[0]["sum_energy"] == int(want.final_energy.sum())
    # and the port's own one-process runner
    spec = ChainSpec(N=n, n_steps=n_steps,
                     schedule=schedules.build_schedule(
                         "linear_annealing", n_steps, beta_start=0.5,
                         beta_end=3.0),
                     init_mode="random", mcmc_type="board", kernel="tables",
                     history_stride=n_steps)
    got = runner.run_chains(np.arange(n_chains, dtype=np.uint32), spec,
                            device="cpu")
    np.testing.assert_array_equal(got.final_energy, want.final_energy)


def test_init_distributed_raises_on_real_failure():
    """Misconfiguration must abort loudly, not continue single-host; the
    dotted host is refused without a name lookup."""
    with pytest.raises(ValueError):
        mesh.init_distributed(
            coordinator_address="256.0.0.1:1",  # invalid address
            num_processes=2,
            process_id=0,
            initialization_timeout=2,
            local_devices=["cpu"],
        )
    for bad in ("localhost", "localhost:0", "localhost:x"):
        with pytest.raises(ValueError, match="host:port"):
            mesh.init_distributed(coordinator_address=bad, num_processes=1,
                                  process_id=0, local_devices=["cpu"])
    with pytest.raises(ValueError, match="process_id 2 of 2"):
        mesh.init_distributed(coordinator_address="localhost:1",
                              num_processes=2, process_id=2,
                              local_devices=["cpu"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("rank", [0, 1], ids=["no-client", "no-store"])
def test_init_distributed_times_out_alone(rank):
    """One process of two: as rank 0 nobody joins its store, as rank 1
    nobody listens at the address.  Either raises within its 2 s timeout
    (the subprocess's own limit keeps a hung store from eating the run)."""
    code = textwrap.dedent(f"""
        from mcqueens_torch.dist import mesh
        mesh.init_distributed(coordinator_address="localhost:{_free_port()}",
                              num_processes=2, process_id={rank},
                              initialization_timeout=2,
                              local_devices=["cpu"])
        """)
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=60)
    took = time.monotonic() - t0
    assert p.returncode != 0
    assert "Error" in p.stderr.splitlines()[-1], p.stderr[-2000:]
    assert took < 30, took


@pytest.fixture
def group_of_one():
    """A real gloo group of one process over localhost, left afterwards."""
    mesh.init_distributed(coordinator_address=f"localhost:{_free_port()}",
                          num_processes=1, process_id=0,
                          initialization_timeout=30,
                          local_devices=["cpu", "cpu"])
    try:
        yield
    finally:
        mesh.shutdown_distributed()
    assert not torch.distributed.is_initialized()
    assert mesh.process_count() == 1


def test_init_distributed_second_call(group_of_one):
    """A second call of the same size and rank changes nothing; another
    size or rank, or other local devices, raise."""
    first = mesh.make_mesh()
    assert isinstance(first, mesh.ProcessMesh)
    assert first == (CPU, CPU) and first.owners == (0, 0)
    mesh.init_distributed(coordinator_address="localhost:1",
                          num_processes=1, process_id=0)
    mesh.init_distributed(coordinator_address="localhost:1",
                          num_processes=1, process_id=0,
                          local_devices=["cpu", "cpu"])
    assert mesh.make_mesh() is first
    assert (mesh.process_index(), mesh.process_count(), mesh.device_count(),
            mesh.local_device_count()) == (0, 1, 2, 2)
    for n_procs, pid in ((2, 0), (2, 1)):
        with pytest.raises(RuntimeError, match="initialised with 1"):
            mesh.init_distributed(coordinator_address="localhost:1",
                                  num_processes=n_procs, process_id=pid)
    with pytest.raises(ValueError, match="differ"):
        mesh.init_distributed(coordinator_address="localhost:1",
                              num_processes=1, process_id=0,
                              local_devices=["cpu"])
    assert torch.distributed.is_initialized()
    assert mesh.make_mesh() is first


def test_mesh_of_own_shards_runs_as_a_tuple(group_of_one):
    """In a group of one, the global mesh (all this process's shards) and
    ``--mesh``'s run like the same devices as a plain tuple: bitwise."""
    spec = ChainSpec(N=5, n_steps=200, history_stride=50, kernel="pallas",
                     schedule=schedules.build_schedule(
                         "linear_annealing", 200, beta_start=0.5,
                         beta_end=3.0), init_mode="random")
    seeds = np.arange(7, dtype=np.uint32)
    assert mesh.mesh_for("cpu") == (CPU, CPU)
    assert mesh.mesh_for("cpu", 1) == (CPU,)
    a = runner.run_chains(seeds, spec, device="cpu", mesh=mesh.make_mesh())
    b = runner.run_chains(seeds, spec, device="cpu", mesh=(CPU, CPU))
    for field in ("final_energy", "best_energy", "energy_history",
                  "final_state", "accept_bins"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("rank", [0, 1])
def test_runner_and_tempering_refuse_another_process_shards(rank):
    spans = mesh.ProcessMesh([CPU] * 4, (0, 0, 1, 1), rank)
    assert mesh.pad_chains(10, spans) == 12
    assert spans.local_shards() == ((0, 1) if rank == 0 else (2, 3))
    board = ChainSpec(N=5, n_steps=64, history_stride=32,
                      kernel="pallas_shared",
                      schedule=schedules.build_schedule(
                          "constant", 64, beta_const=1.0),
                      init_mode="random")
    seeds = np.arange(8, dtype=np.uint32)
    with pytest.raises(ValueError, match=f"shards of process.*process "
                                         f"{rank}"):
        runner.run_chains(seeds, board, device="cpu", mesh=spans)
    with pytest.raises(ValueError, match="shards of process"):
        tempering.run_tempered(seeds, board, np.array([1.0, 2.0]),
                               device="cpu", mesh=spans)
    with pytest.raises(ValueError, match="shards of process"):
        mesh.check_mesh(spans[1:3], "cpu")
    # the part this process owns alone is a mesh like any other
    own = spans[:2] if rank == 0 else spans[2:]
    assert mesh.check_mesh(own, "cpu") == (CPU, CPU)


REFUSAL_WORKER = textwrap.dedent("""
    import json, sys
    from mcqueens_torch.dist import mesh
    addr, rank, cfg_path, outdir = sys.argv[1:5]
    mesh.init_distributed(coordinator_address=addr, num_processes=2,
                          process_id=int(rank), initialization_timeout=60,
                          local_devices=["cpu", "cpu"])
    from mcqueens_torch.cli import competition, experiments
    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.experiments.config import load_config

    def refused(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    m = mesh.make_mesh()
    out = {"mesh": [str(d) for d in m], "owners": list(m.owners),
           "counts": [mesh.process_index(), mesh.process_count(),
                      mesh.device_count(), mesh.local_device_count()]}
    board = ["--n", "5", "--n-runs", "8", "--n-steps", "64",
             "--history-stride", "32", "--device", "cpu", "--outdir", outdir,
             "--mesh"]
    out["competition"] = refused(lambda: competition.main(board))
    out["competition tempered"] = refused(lambda: competition.main(
        board + ["--kernel", "pallas_shared", "--tempering", "4"]))
    out["experiments"] = refused(lambda: experiments.main(
        ["--config", cfg_path, "--outdir", outdir, "--device", "cpu",
         "--mesh"]))
    for n in (True, 3, 2):
        cfg = load_config(cfg_path)
        cfg.tpu.mesh = n
        out[f"tpu.mesh {n}"] = refused(lambda: drivers.run_from_config(
            cfg, outdir=outdir, device="cpu", plot=False))
    mesh.shutdown_distributed()
    print("RESULT " + json.dumps(out))
    """)


def test_clis_and_configs_refuse_a_mesh_across_processes(tmp_path):
    """Two real processes, two CPU shards each: ``--mesh`` of both CLIs
    (the tempered search too) and ``tpu.mesh: true`` or ``3`` span both
    processes and are refused in each; ``tpu.mesh: 2`` (process 0's two
    shards, as JAX's ``jax.devices()[:2]``) runs in process 0 and is
    refused in process 1."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "experiment_type": "beta_start_end_pairs",
        "common": {"n_steps": 64, "n_runs": 4, "verbose": False,
                   "initialization": "random", "mcmc_type": "board",
                   "early_stop_patience": None,
                   "betta_scheduling": {"type": "linear_annealing",
                                        "base_seed": 7},
                   "output_path": "figures/pairs.png"},
        "beta_start_end_pairs": {"N": 5, "beta_start_ends": [[0.5, 3.0]]},
        "tpu": {"kernel": "pallas", "history_stride": 32},
    }))
    logs = _spawn(lambda port, r: [
        sys.executable, "-c", REFUSAL_WORKER, f"localhost:{port}", str(r),
        str(cfg), str(tmp_path / f"out{r}")], 2)
    for rank, log in enumerate(logs):
        (line,) = [x for x in log.splitlines() if x.startswith("RESULT ")]
        out = json.loads(line[len("RESULT "):])
        assert out["mesh"] == ["cpu"] * 4 and out["owners"] == [0, 0, 1, 1]
        assert out["counts"] == [rank, 2, 4, 2]
        for what in ("competition", "competition tempered", "experiments",
                     "tpu.mesh True", "tpu.mesh 3"):
            assert out[what] and "shards of process" in out[what], (
                rank, what, out[what])
        if rank == 0:
            assert out["tpu.mesh 2"] is None
        else:
            assert "shards of process(es) [0]" in out["tpu.mesh 2"]
