"""The port's mover-hold and large-N probes (``mcqueens_torch.tools.
probe_hold``, ``probe_largeN``) on the CPU, at tiny sizes.

Their rates on the CPU are the plain-torch twins' and are never written
under a device metric's name; their exactness and oracle checks are the
same as on the card.  The large-N block sizes are held to the JAX
package's ``board_shared.block_size``.
"""

import json

import numpy as np
import pytest

from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.core.schedules import build_schedule as jbuild_schedule
from mcqueens.kernels import board_shared as jboard_shared
from mcqueens_torch import bench, tools
from mcqueens_torch.core.energy import board_energy, full3d_energy
from mcqueens_torch.kernels import board_shared, full3d_shared
from mcqueens_torch.tools import probe_hold, probe_largeN


def _last_json(text):
    return json.loads(text.strip().splitlines()[-3])


@pytest.mark.parametrize("hold,seg", [(8, 40), (16, 1024), (32, 1024)])
def test_probe_hold_on_the_cpu(hold, seg, tmp_path, capsys):
    out = tmp_path / "hold.json"
    assert probe_hold.main(["--device", "cpu", "--hold", str(hold), "--n",
                            "4", "--chains", "16", "--seg", str(seg),
                            "--seconds", "0.01", "--json", str(out)]) == 0
    assert full3d_shared._HOLD == 8  # restored
    line = _last_json(capsys.readouterr().out)
    assert line["hold"] == hold and line["energy_exact"] is True
    assert line["steps"] >= seg and line["steps"] % seg == 0
    assert line["moves_per_s_cpu"] > 0 and "moves_per_s_chip" not in line
    saved = json.loads(out.read_text())
    assert saved["device"] == "cpu" and saved["instances"] == []
    assert saved["nvidia_smi_name_power_limit"] == "not measured"


@pytest.mark.parametrize("argv", [["--hold", "12"],
                                  ["--hold", "16", "--seg", "44"],
                                  ["--hold", "32", "--seg", "1023"]])
def test_probe_hold_refuses(argv):
    with pytest.raises(SystemExit) as exc:
        probe_hold.main(["--device", "cpu"] + argv)
    assert exc.value.code == 2
    assert full3d_shared._HOLD == 8


def test_probe_hold_exactness_catches_a_wrong_energy(monkeypatch, capsys,
                                                     tmp_path):
    """The invariant is a real check: an oracle that disagrees by one makes
    ``energy_exact`` false."""
    monkeypatch.setattr(probe_hold, "full3d_energy",
                        lambda q: full3d_energy(q) + 1)
    probe_hold.main(["--device", "cpu", "--n", "4", "--chains", "16",
                     "--seg", "16", "--seconds", "0.01", "--json",
                     str(tmp_path / "h.json")])
    assert _last_json(capsys.readouterr().out)["energy_exact"] is False


def test_probe_largeN_quick_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "largeN.json"
    assert probe_largeN.main(["--quick", "--device", "cpu", "--seconds",
                              "0.01", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    final = json.loads(text.split("FINAL ", 1)[1].splitlines()[0])
    assert set(final) == {"N24", "N32"}
    for row in final.values():
        assert row["oracle_checked"] is True and row["chains"] == 64
        assert row["moves_per_s_cpu"] > 0
        assert "moves_per_s_per_chip" not in row
    assert json.loads(out.read_text())["sizes"] == final


def test_probe_largeN_oracle_catches_a_wrong_energy(monkeypatch):
    monkeypatch.setattr(probe_largeN, "board_energy",
                        lambda h: board_energy(h) + 1)
    spec = bench.bench_spec(6, 16, "pallas_shared")
    with pytest.raises(AssertionError, match="oracle"):
        probe_largeN._oracle(spec, 16, tools.device("cpu"))


@pytest.mark.parametrize("N,chains,block", [(24, 16640, 1664),
                                            (32, 17920, 896)])
def test_large_n_blocks_match_jax(N, chains, block):
    assert (N, chains) in probe_largeN.SIZES
    jspec = JaxSpec(N=N, n_steps=2 ** 24,
                    schedule=jbuild_schedule("linear_annealing", 2 ** 24,
                                             beta_start=1.0, beta_end=5.0),
                    init_mode="random", mcmc_type="board",
                    kernel="pallas_shared", history_stride=8192)
    spec = bench.bench_spec(N, probe_largeN.SEG, "pallas_shared")
    got = board_shared.block_size(chains, spec)
    assert got == jboard_shared.block_size(chains, jspec) == block
    assert chains % got == 0


@pytest.mark.parametrize("tool,argv", [
    (probe_hold, ["--device", "cpu"]),
    (probe_largeN, ["--quick", "--device", "cpu"])])
@pytest.mark.parametrize("where", ["artifacts/probe.json",
                                   "artifacts/qmax/probe.json"])
def test_tools_refuse_the_tpu_artifacts(tool, argv, where):
    with pytest.raises(ValueError, match="TPU"):
        tool.main(argv + ["--json", str(tools.REPO / where)])
    assert not (tools.REPO / where).exists()


def test_default_outputs_lie_under_artifacts_h100(monkeypatch):
    """Without ``--json`` each tool writes under ``artifacts/h100/``."""
    written = []
    monkeypatch.setattr(tools, "write_json",
                        lambda path, out: written.append(path))
    monkeypatch.setattr(probe_hold, "_probe",
                        lambda args, dev: ({"hold": args.hold}, []))
    monkeypatch.setattr(bench, "_measure", lambda *a, **kw: 1.0)
    monkeypatch.setattr(probe_largeN, "_oracle", lambda *a: None)
    probe_hold.main(["--device", "cpu", "--hold", "16", "--seg", "2048"])
    probe_largeN.main(["--device", "cpu"])
    assert written == [tools.H100_ARTIFACTS / "probe_hold_h16.json",
                       tools.H100_ARTIFACTS / "probe_largeN.json"]
    assert np.all([p.parent == tools.H100_ARTIFACTS for p in written])
