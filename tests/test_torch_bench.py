"""The port's bench (``python -m mcqueens_torch.bench``) against the JAX
package's ``bench.py`` configuration (CPU).

For each ``--kernel`` the port's ``_setup`` and the JAX carry built as
``bench.py`` builds it (the same ``ChainSpec`` and seeds, written out here:
importing ``bench`` turns on JAX's compile cache) run two one-chunk
``run_segment`` calls; the carries must be equal bitwise after each.  The
JAX Pallas kernels run in interpret mode.  Then the CLI: one JSON line with
the port's keys, and no key that divides by another chip's numbers.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcqueens.chain import board as jboard
from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.core import rng as jrng
from mcqueens.core.schedules import build_schedule as jbuild_schedule
from mcqueens.kernels import board_shared as jboard_shared
from mcqueens.kernels import metropolis_pallas as jmetropolis
from mcqueens_torch import bench
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

KERNEL_MODULES = {"pallas_shared": "mcqueens_torch.kernels.board_shared",
                  "pallas": "mcqueens_torch.kernels.metropolis_pallas",
                  "tables": "mcqueens_torch.chain.board",
                  "naive": "mcqueens_torch.chain.board"}
DROPPED = ("vs_baseline", "chains_4096_vs_baseline", "vs_best_round",
           "regression")


def _jax_setup(n, chains, segment_steps, kernel, horizon=bench.HORIZON):
    """``bench.py:113-136`` written out."""
    spec = JaxSpec(
        N=n, n_steps=horizon,
        schedule=jbuild_schedule("linear_annealing", horizon,
                                 beta_start=1.0, beta_end=5.0),
        init_mode="random", mcmc_type="board", kernel=kernel,
        history_stride=segment_steps)
    seeds = np.arange(chains, dtype=np.uint32)
    if kernel == "pallas_shared":
        return jboard_shared, spec, jboard_shared.init_carry_batch(seeds,
                                                                   spec)
    if kernel == "pallas":
        return jmetropolis, spec, jmetropolis.init_carry_batch(seeds, spec)
    return jboard, spec, jboard.init_carry_batch(
        jrng.chain_keys_from_seeds(seeds), spec)


def _assert_same_carry(want, got):
    for name, w in want._asdict().items():
        g = getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        if name == "step_base":
            w = jax.random.key_data(w)
        g = g.cpu().numpy()
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype),
                                      err_msg=name)


@pytest.mark.parametrize("n,chains,steps", [(5, 16, 32), (6, 8, 64)])
@pytest.mark.parametrize("kernel", bench.KERNELS)
def test_setup_and_two_segments_match_jax(kernel, n, chains, steps):
    mod, spec, carry = bench._setup(n, chains, steps, kernel, device="cpu")
    assert mod.__name__ == KERNEL_MODULES[kernel]
    assert (spec.N, spec.n_steps, spec.history_stride, spec.kernel) == (
        n, 2 ** 24, steps, kernel)
    assert carry.device == torch.device("cpu")
    jmod, jspec, jcarry = _jax_setup(n, chains, steps, kernel)
    _assert_same_carry(jcarry, carry)
    with pltpu.force_tpu_interpret_mode():
        for seg in range(2):
            jcarry, jys = jmod.run_segment(jcarry, np.int32(seg), jspec, 1)
            carry, ys = mod.run_segment(carry, seg, spec, 1)
            _assert_same_carry(jcarry, carry)
            np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))


@pytest.mark.parametrize("kernel", bench.KERNELS)
def test_main_prints_the_ported_keys(kernel, capsys):
    assert bench.main(["--device", "cpu", "--n", "5", "--chains", "16",
                       "--segment-steps", "8", "--target-seconds", "0.01",
                       "--kernel", kernel]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert set(record) == {"metric", "value", "unit", "chains_4096_value"}
    assert not set(DROPPED) & set(record)
    # a CPU run's rate is never named a device metric
    assert record["metric"] == (f"proposed moves/sec on the CPU (board N=5, "
                                f"16 chains, {kernel} kernel)")
    assert record["unit"] == "moves/s/cpu"
    assert record["value"] > 0 and record["chains_4096_value"] > 0


def test_quick_and_4096_chains_print_no_second_rate(capsys, monkeypatch):
    """``--quick`` sets 1024 chains, 2048-step chunks and a 1 s budget, and
    neither it nor a 4096-chain run measures the 4096-chain rate again."""
    calls = []
    monkeypatch.setattr(bench, "_measure",
                        lambda *a, **kw: calls.append((a, kw)) or 1.0)
    bench.main(["--quick", "--device", "cpu"])
    bench.main(["--chains", "4096", "--device", "cpu"])
    assert calls == [((16, 1024, 2048, 1.0, "pallas_shared"),
                      {"device": "cpu"}),
                     ((16, 4096, 32768, 5.0, "pallas_shared"),
                      {"device": "cpu"})]
    for line in capsys.readouterr().out.strip().splitlines():
        assert set(json.loads(line)) == {"metric", "value", "unit"}


def test_bin_guard_raises_as_jax_does(monkeypatch):
    """A horizon whose n_steps * n_bins passes 2^31 is refused by both
    ChainSpecs with the same message."""
    with pytest.raises(ValueError) as want:
        _jax_setup(5, 8, 16, "pallas", horizon=2 ** 25)
    monkeypatch.setattr(bench, "HORIZON", 2 ** 25)
    with pytest.raises(ValueError) as got:
        bench._setup(5, 8, 16, "pallas", device="cpu")
    assert str(got.value) == str(want.value)
    assert "n_steps * n_bins must fit in int32" in str(got.value)


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py runs the bench there")
    with pytest.raises(RuntimeError, match="cuda"):
        bench._measure(5, 8, 16, 0.01, "pallas_shared")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--n", "5", "--chains", "8", "--segment-steps", "16"])
