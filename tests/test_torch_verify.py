"""The invariant battery ``python -m mcqueens_torch.tools.verify_gpu`` on
the CPU.

``--device cpu --quick`` runs all six checks on the kernels' twins (check
3 holds them bitwise to the host emulation of the card's ``.cu`` sources)
and must pass each, write ``smoke_mode`` and list its cuts.  Each check
must also fail when one result it reads is corrupted (an energy, a board,
a carry field), so none passes vacuously.  Without CUDA and without
``--device cpu`` the tool raises, and it refuses to write into the TPU's
``artifacts/``.  No JAX: the twins are held to the JAX kernels elsewhere.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import (board_shared, full3d_pallas,
                                    host_emulation)
from mcqueens_torch.tools import verify_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_QUICK = verify_gpu.Battery(torch.device("cpu"), verify_gpu.QUICK)


@pytest.fixture(scope="module")
def emulation():
    if host_emulation.compiler() is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    host_emulation.load()


def test_cpu_battery_passes(tmp_path, emulation):
    path = tmp_path / "VERIFY_GPU.json"
    assert verify_gpu.main(["--device", "cpu", "--quick", "--json",
                            str(path)]) == 0
    out = json.loads(path.read_text())
    assert out["ok"] is True and out["smoke_mode"] is True
    assert out["platform"] == "cpu"
    assert list(out["checks"]) == [name for name, _ in verify_gpu.CHECKS]
    assert len(out["checks"]) == 6 and "card_vs_twin_streams" in out["checks"]
    for name, res in out["checks"].items():
        assert res["status"] == "pass", (name, res["detail"])
        assert res["seconds"] >= 0
    # Each cut is listed, with the JAX tool's size beside it.
    assert out["quick_cuts"]["scale_chains"] == [65536, 256]
    assert set(out["quick_cuts"]) == {
        f.name for f in dataclasses.fields(verify_gpu.Sizes)}
    # The twins and the emulation launch nothing on a card.
    assert not any(out["launches"].values())


def _corrupt_run_chains(monkeypatch, edit):
    real = runner.run_chains

    def corrupted(seeds, spec, **kw):
        res = real(seeds, spec, **kw)
        edit(res, spec)
        return res

    monkeypatch.setattr(runner, "run_chains", corrupted)


def _naive_board(res, spec):
    if spec.kernel == "naive":
        res.final_state[0, 0, 0] = (res.final_state[0, 0, 0] + 1) % spec.N


def _last_pair_best(res, spec):
    if (spec.kernel, spec.mcmc_type) == verify_gpu.PAIRS[-1]:
        res.best_energy[0] += 1


def _klarner_best(res, spec):
    res.best_energy[-1] = 1


def corrupt_tables_equals_naive(monkeypatch):
    _corrupt_run_chains(monkeypatch, _naive_board)
    return "differ in final_state"


def corrupt_incremental_vs_oracle(monkeypatch):
    _corrupt_run_chains(monkeypatch, _last_pair_best)
    return "pallas_shared/full_3d chain 0 best"


def corrupt_card_vs_twin_streams(monkeypatch):
    real = full3d_pallas.launch_segment

    def corrupted(lib, st, *args, **kw):
        lay = real(lib, st, *args, **kw)
        st.no_improve[3] += 1
        return lay

    monkeypatch.setattr(full3d_pallas, "launch_segment", corrupted)
    return "pallas(full_3d): carry field no_improve differs"


def corrupt_klarner_zero(monkeypatch):
    _corrupt_run_chains(monkeypatch, _klarner_best)
    return "best energies [0, 0, 0, 1]"


def corrupt_recover_best_heights(monkeypatch):
    real = board_shared.recover_best_heights

    def corrupted(carry, spec, **kw):
        rec = real(carry, spec, **kw)
        rec[5, 2, 3] = (rec[5, 2, 3] + 1) % spec.N
        return rec

    monkeypatch.setattr(board_shared, "recover_best_heights", corrupted)
    return "differ on 1 chains"


def corrupt_init_energy_at_scale(monkeypatch):
    real = board_shared.init_carry_batch

    def corrupted(seeds, spec, *args, initial_states=None, **kw):
        carry = real(seeds, spec, *args, initial_states=initial_states, **kw)
        if initial_states is not None:
            carry.energy[-1] += 1
        return carry

    monkeypatch.setattr(board_shared, "init_carry_batch", corrupted)
    return "warm energies in"


CORRUPTIONS = {
    "tables_equals_naive": corrupt_tables_equals_naive,
    "incremental_vs_oracle": corrupt_incremental_vs_oracle,
    "card_vs_twin_streams": corrupt_card_vs_twin_streams,
    "klarner_zero": corrupt_klarner_zero,
    "recover_best_heights": corrupt_recover_best_heights,
    "init_energy_at_scale": corrupt_init_energy_at_scale,
}


@pytest.mark.parametrize("name,check", verify_gpu.CHECKS,
                         ids=[name for name, _ in verify_gpu.CHECKS])
def test_each_check_fails_on_a_corrupted_result(monkeypatch, emulation, name,
                                                check):
    want = CORRUPTIONS[name](monkeypatch)
    res = verify_gpu.run_check(check, CPU_QUICK)
    assert res["status"] == "fail"
    assert want in res["detail"], res["detail"]


def test_main_exits_1_when_a_check_fails(tmp_path, monkeypatch, emulation):
    corrupt_klarner_zero(monkeypatch)
    path = tmp_path / "v.json"
    monkeypatch.setattr(verify_gpu, "CHECKS", [
        c for c in verify_gpu.CHECKS if c[0] == "klarner_zero"])
    assert verify_gpu.main(["--device", "cpu", "--quick", "--json",
                            str(path)]) == 1
    out = json.loads(path.read_text())
    assert out["ok"] is False
    assert out["checks"]["klarner_zero"]["status"] == "fail"


def test_no_cuda_raises_and_the_tpu_artifacts_are_refused(tmp_path):
    if not torch.cuda.is_available():
        # No fallback to a CPU run: the default device is the card.
        with pytest.raises(RuntimeError, match="is_available"):
            verify_gpu.main(["--json", str(tmp_path / "v.json")])
        assert not (tmp_path / "v.json").exists()
    tpu = os.path.join(REPO, "artifacts", "VERIFY_GPU.json")
    with pytest.raises(ValueError, match="TPU's results"):
        verify_gpu.main(["--device", "cpu", "--quick", "--json", tpu])
    assert not os.path.exists(tpu)
    assert str(verify_gpu.DEFAULT_JSON).endswith(
        os.path.join("artifacts", "h100", "VERIFY_GPU.json"))


def test_tools_import_no_jax():
    """verify_gpu and check_multihost import neither jax, the JAX package
    nor the tests."""
    code = ("import sys\n"
            "import mcqueens_torch.tools.verify_gpu\n"
            "import mcqueens_torch.tools.check_multihost\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(\n"
            "       ('jax.', 'mcqueens.', 'tests')) or m == 'mcqueens']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
