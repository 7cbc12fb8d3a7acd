"""The measurement probes of the port against the JAX tools' Pallas probes.

Each JAX tool times its Pallas kernel through a ``_sync`` helper that
receives the kernel's output; under Pallas interpret mode the tests record
that output and compare it bitwise with the port's plain-torch twin
(``mcqueens_torch/kernels/probes.py``) on the same numpy-made input.  The
CUDA kernels themselves run only on the card (``chip_smoke.py``).  The
port's tools run here on ``device="cpu"`` at tiny sizes.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcqueens_torch import tools
from mcqueens_torch.kernels import probes
from mcqueens_torch.tools import (probe_full3d_alternatives,
                                  probe_full3d_cap, probe_swar_sweep,
                                  roofline)
from tests._oracle import pair_attacks
from tests.test_torch_foundations import release_jax_executables  # noqa: F401


@pytest.fixture
def jax_output(monkeypatch):
    """``run(module, fn, *args)``: call a JAX tool's timing function in
    interpret mode and return the first array its ``_sync`` received (the
    kernel's output)."""
    def run(module, fn, *args, **kw):
        got = []

        def record(x):
            got.append(np.asarray(x))
            return got[-1]

        monkeypatch.setattr(module, "_sync", record)
        with pltpu.force_tpu_interpret_mode():
            fn(*args, **kw)
        return got[0]

    return run


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind", probes.TEST_KINDS)
def test_attack_test_matches_jax(jax_output, kind, k):
    import tools.probe_full3d_alternatives as alt

    want = jax_output(alt, alt._test_rate, kind, n_iter=3, reps=1, k=k)
    x = torch.from_numpy(np.full((8, 1024), 70, np.int32))
    got = probes.attack_test(x, kind, n_iter=3, k=k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", probes.OPS)
def test_op_chain_matches_jax(jax_output, op):
    import tools.probe_full3d_alternatives as alt

    want = jax_output(alt, alt._op_rate, op, 4, 1, 4)
    x = torch.from_numpy(np.full((8, 1024), 3, np.int32))
    got = probes.op_chain(x, op, n_iter=4, k=4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Q", [16, 32])
@pytest.mark.parametrize("kind", probes.SWEEP_KINDS)
def test_sweep_matches_jax(jax_output, kind, Q):
    import tools.probe_swar_sweep as sw

    want = jax_output(sw, sw._sweep_time, kind, Q, C=256, n_chunks=4,
                      reps=1)
    planes = probe_swar_sweep.sweep_planes(kind, Q, 256)
    got = probes.sweep(*map(torch.from_numpy, planes), kind, n_chunks=4)
    assert got.shape == (1, 256)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("independent", [True, False])
def test_vpu_doubling_matches_jax(jax_output, independent):
    import tools.roofline as rl

    want = jax_output(rl, rl.vpu_ns_per_vreg, independent)
    got = probes.vpu_doubling(torch.ones((8, 1024), dtype=torch.int32),
                              independent)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want.any()  # 32 doublings wrap every int32 to 0


@pytest.mark.parametrize("independent,n_iter,k,inner", [
    (True, 1, 8, 3), (True, 2, 4, 5), (True, 1, 1, 31), (False, 1, 2, 7),
    (False, 3, 1, 4),
    # every instance in both modes at an odd inner (the kernel's last
    # doubling outside its loop over pairs), and 19 (9 pairs, the last)
    (True, 3, 1, 5), (True, 3, 4, 5), (True, 3, 8, 5), (True, 1, 8, 19),
    (False, 1, 1, 3), (False, 1, 4, 3), (False, 1, 8, 3), (False, 1, 1, 19)])
def test_vpu_doubling_closed_form(independent, n_iter, k, inner):
    # Before 32 doublings: sum over the accumulators of
    # (x + i) * 2^(doublings) mod 2^32.
    rs = np.random.default_rng(n_iter * 100 + k * 10 + inner)
    x = rs.integers(-2 ** 31, 2 ** 31, size=(4, 64)).astype(np.int32)
    got = probes.vpu_doubling(torch.from_numpy(x), independent,
                              n_iter=n_iter, k=k, inner=inner).numpy()
    n_acc, its = (k, n_iter) if independent else (1, n_iter * k)
    want = sum((x.astype(np.int64) + i) * 2 ** (its * inner)
               for i in range(n_acc)) % 2 ** 32
    np.testing.assert_array_equal(got.astype(np.int64) % 2 ** 32, want)


def test_op_chain_closed_form():
    # One add chain: x + n * x, with the low bit set after each add.
    x = np.arange(1, 65, dtype=np.int32).reshape(2, 32)
    got = probes.op_chain(torch.from_numpy(x), "add", n_iter=2, k=1, u=3)
    a = x.astype(np.int64)
    for _ in range(6):
        a = (a + x) | 1
    np.testing.assert_array_equal(got.numpy(), a)


def test_scores_match_oracle():
    # The port's packed and production predicates against the brute-force
    # attack oracle, two queens per packed lane (tests/test_probe_swar.py's
    # check of the JAX functions).
    rng = np.random.default_rng(7)
    N, M = 16, 400
    qa = rng.integers(0, N, size=(M, 2, 3))
    c = rng.integers(0, N, size=(M, 3))
    packed = (qa[:, 0] | (qa[:, 1] << 16)).astype(np.int64)
    bias = ((64 - c) * 0x10001).astype(np.int64)
    rows = [torch.from_numpy((packed[:, a] + bias[:, a]).astype(np.int32))
            for a in range(3)]
    att, occ = (t.numpy() for t in probe_swar_sweep.swar_scores(*rows))
    d = qa[:, 0] - c
    prod = probe_swar_sweep.prod_scores(
        *[torch.from_numpy(d[:, a].astype(np.int32)) for a in range(3)]
    ).numpy()
    for idx in range(M):
        t = tuple(c[idx])
        for half in (0, 1):
            q = tuple(qa[idx, half])
            want_att = 1 if (q == t or pair_attacks(q, t)) else 0
            assert (att[idx] >> (16 * half)) & 0xFFFF == want_att, (q, t)
            assert (occ[idx] >> (16 * half)) & 0xFFFF == (q == t), (q, t)
        q0 = tuple(qa[idx, 0])
        want = (1 if (q0 == t or pair_attacks(q0, t)) else 0) + (
            (1 << 16) if q0 == t else 0)
        assert prod[idx] == want, (q0, t)


def test_sweep_hash_matches_jax_hash():
    # The sweep's inlined lowbias32, its first shift arithmetic, at chunk
    # indices whose hash input has bit 31 set.
    import jax.numpy as jnp

    xs = np.array([0, 1, 0x7F4A7C15, 0x7FFFFFFF, -5, -2 ** 31, 123456789],
                  np.int64)
    x = jnp.asarray(xs.astype(np.int32))
    x = x ^ (x >> 16)
    x = x * jnp.int32(np.int32(np.uint32(0x7FEB352D)))
    x = x ^ ((x >> 15) & jnp.int32(0x1FFFF))
    x = x * jnp.int32(np.int32(np.uint32(0x846CA68B)))
    x = x ^ ((x >> 16) & jnp.int32(0xFFFF))
    assert [probes.hash32(int(v)) for v in xs] == np.asarray(x).tolist()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.ones((8, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        probes.vpu_doubling(x.to(torch.int64))
    with pytest.raises(ValueError, match="2\\^31"):
        probes.vpu_doubling(x, False, n_iter=2 ** 26, k=8, inner=4)
    with pytest.raises(ValueError):
        probes.attack_test(x, "production", k=3)
    with pytest.raises(ValueError):
        probes.attack_test(x, "other")
    with pytest.raises(ValueError):
        probes.op_chain(x.t(), "add")
    with pytest.raises(ValueError):
        probes.sweep(x, x, x[:4], "production")
    # Neither cpu nor cuda: no twin, no kernel.
    with pytest.raises(ValueError):
        probes.op_chain(torch.ones((8, 16), dtype=torch.int32,
                                   device="meta"), "mul")


@pytest.mark.parametrize("fn,counts", [
    (lambda x, k: probes.vpu_doubling(x, True, n_iter=1, k=k), probes.VPU_KS),
    (lambda x, k: probes.attack_test(x, "nomul", n_iter=1, k=k),
     probes.TEST_KS),
    (lambda x, k: probes.op_chain(x, "add", n_iter=1, k=k), probes.OP_KS)])
def test_each_kernel_takes_only_its_instances(fn, counts):
    # The CUDA kernels hold one template instance per accumulator count the
    # tools launch; the wrappers refuse any other count on every device.
    x = torch.ones((8, 16), dtype=torch.int32)
    for k in (1, 2, 4, 8, 16, 32):
        if k in counts:
            assert fn(x, k).shape == x.shape
        else:
            with pytest.raises(ValueError, match=f"k={k}"):
                fn(x, k)


def test_twins_count_no_launch():
    before = dict(probes.LAUNCHES)
    x = torch.ones((8, 16), dtype=torch.int32)
    probes.vpu_doubling(x, n_iter=1)
    probes.attack_test(x, "swar", n_iter=1)
    probes.op_chain(x, "mul", n_iter=1)
    probes.sweep(x, x, x, "production", n_chunks=1)
    assert probes.LAUNCHES == before


def _rate_ok(v):
    return math.isfinite(v) and v > 0


@pytest.mark.parametrize("row", range(7))
def test_kernel_moves_per_sec_on_cpu(row):
    label, kernel, mcmc_type, _, _ = roofline.table(False)[row]
    rate = roofline.kernel_moves_per_sec(kernel, mcmc_type, 64, 16,
                                         seconds=0.0, device="cpu")
    assert _rate_ok(rate), label


def test_roofline_micro_on_cpu():
    assert _rate_ok(roofline.hbm_bandwidth_gbs(True, device="cpu"))
    assert _rate_ok(roofline.launch_overhead_us(device="cpu"))
    assert _rate_ok(roofline.column_add_ms(True, device="cpu"))
    for independent in (True, False):
        assert _rate_ok(roofline.vpu_ns_per_vreg(
            independent, width=64, n_iter=2, reps=1, device="cpu"))


def test_full3d_cap_on_cpu():
    us, rate = probe_full3d_cap.kernel_block_step_us(16, chains=64, seg=16,
                                                     seconds=0.0,
                                                     device="cpu")
    assert _rate_ok(us) and _rate_ok(rate)
    rs = np.random.default_rng(3)
    qs, ts = [32, 64, 128, 256, 384], rs.random(5)
    A = np.stack([np.ones(5), np.asarray(qs, float)], axis=1)
    want = np.linalg.lstsq(A, ts, rcond=None)[0]
    np.testing.assert_allclose(probe_full3d_cap._fit(qs, ts), want,
                               rtol=0, atol=0)


def test_full3d_cap_segment_slopes():
    qs, ts = [32, 64, 128, 256], [0.1, 0.2, 0.5, 1.5]
    got = probe_full3d_cap._segments(qs, ts)
    assert list(got) == ["32-64", "64-128", "128-256"]
    np.testing.assert_allclose(list(got.values()),
                               np.diff(ts) / np.diff(qs), rtol=1e-15)
    # on a straight line every segment has the line's slope
    line = probe_full3d_cap._segments(qs, [0.5 + 0.01 * q for q in qs])
    np.testing.assert_allclose(list(line.values()), 0.01, rtol=1e-12)


def test_alternatives_and_sweep_on_cpu():
    for kind in probes.TEST_KINDS:
        rates = probe_full3d_alternatives._test_rate(
            kind, n_iter=2, reps=2, k=4, width=64, device="cpu")
        assert len(rates) == 2 and all(map(_rate_ok, rates))
    for op in probes.OPS:
        assert _rate_ok(probe_full3d_alternatives._op_rate(
            op, 2, 1, 4, width=64, device="cpu"))
    assert all(map(_rate_ok, probe_full3d_alternatives.mxu_onehot_rate(
        Q=8, C=64, L=8, reps=1, device="cpu")))
    for kind in probes.SWEEP_KINDS:
        times = probe_swar_sweep._sweep_time(kind, 16, C=64, n_chunks=2,
                                             reps=1, width=128, device="cpu")
        assert all(map(_rate_ok, times))
    with pytest.raises(ValueError):
        probe_swar_sweep._sweep_time("swar", 16, C=64, n_chunks=1, reps=1,
                                     width=100, device="cpu")


@pytest.mark.parametrize("module", [roofline, probe_full3d_cap,
                                    probe_full3d_alternatives,
                                    probe_swar_sweep])
def test_tools_default_to_the_card_and_keep_off_tpu_files(module, tmp_path,
                                                          monkeypatch):
    # --device defaults to cuda: with no card the tool refuses to run (no
    # CPU fallback).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--quick", "--json", str(tmp_path / "out.json")])
    # The TPU's results in artifacts/ are neither read nor written.
    tpu = Path(tools.REPO) / "artifacts" / "probe_full3d_cap.json"
    with pytest.raises(ValueError, match="TPU"):
        module.main(["--quick", "--device", "cpu", "--json", str(tpu)])
    with pytest.raises(ValueError, match="TPU"):
        tools.input_path(tpu)
    assert tools.output_path(tools.H100_ARTIFACTS / "x.json").parent == (
        tools.H100_ARTIFACTS)


def test_alternatives_main_on_cpu(tmp_path, monkeypatch):
    # The whole tool at a tiny width: the issue-bound section needs the
    # card and says so; the rates are positive.
    monkeypatch.setattr(tools, "ALU_WIDTH", 16)
    monkeypatch.setattr(probe_full3d_alternatives, "_op_rate",
                        lambda op, **kw: {"add": 1.0, "mul": 2.0}[op])
    monkeypatch.setattr(probe_full3d_alternatives, "mxu_onehot_rate",
                        lambda **kw: (1.0, 3.0))
    real = probe_full3d_alternatives._test_rate
    monkeypatch.setattr(
        probe_full3d_alternatives, "_test_rate",
        lambda kind, n_iter, k, reps, device: real(
            kind, n_iter=1, k=k, reps=reps, device=device))
    out = tmp_path / "alt.json"
    assert probe_full3d_alternatives.main(
        ["--quick", "--device", "cpu", "--json", str(out)]) == 0
    import json

    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["card"] is None
    assert res["int32_issue_bound"].startswith("not measured")
    assert res["mul_vs_add"] == 2.0 and res["onehot_slowdown"] == 3.0
    for kind in probes.TEST_KINDS:
        assert _rate_ok(res[f"{kind}_test_ns_per_1024_queens"])
