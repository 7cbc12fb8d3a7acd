"""The gather and slice probes of the port against the JAX tools' Pallas
probes.

Neither JAX tool hands its kernel's output to a hook, but each reads it
back through its module's ``np.asarray`` first: the tests swap the module's
``np`` for a proxy that records what ``asarray`` receives, run the JAX
function in Pallas interpret mode, and compare the first recorded array
bitwise with the port's plain-torch twin (``kernels/probes_mem.py``) on the
same numpy-made input.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).  The TPU's hardware PRNG has no stream to match
(interpret mode returns zeros for it), so the port's PRNG draws are held
against ``mcqueens.kernels.prng`` and ``jax.random`` instead.
"""

import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcqueens_torch import tools
from mcqueens_torch.kernels import probes, probes_mem
from mcqueens_torch.tools import probe_gather, probe_slice
from tests.test_torch_foundations import release_jax_executables  # noqa: F401


class _RecordingNumpy:
    """numpy, with every ``asarray`` result recorded."""

    def __init__(self):
        self.got = []

    def asarray(self, a, *args, **kw):
        self.got.append(np.asarray(a, *args, **kw))
        return self.got[-1]

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture
def jax_output(monkeypatch):
    """``run(module, fn, *args)``: call a JAX tool's function in interpret
    mode and return the first array its module's ``np.asarray`` received
    (the kernel's output)."""
    def run(module, fn, *args, **kw):
        rec = _RecordingNumpy()
        monkeypatch.setattr(module, "np", rec)
        with pltpu.force_tpu_interpret_mode():
            fn(*args, **kw)
        monkeypatch.setattr(module, "np", np)
        return rec.got[0]

    return run


def _jg():
    import tools.probe_gather as jg

    return jg


def _js():
    import tools.probe_slice as js

    return js


def _arange(S, L):
    return np.arange(S * L, dtype=np.int32).reshape(S, L)


def _index(seed, hi, shape):
    return np.random.default_rng(seed).integers(0, hi, size=shape,
                                                dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- 5a, 5b: the gather -------------------------------------------------------

@pytest.mark.parametrize("S,L,axis", [
    (8, 128, 1), (8, 256, 1), (64, 128, 1), (256, 512, 1),
    (8, 128, 0), (32, 128, 0), (256, 128, 0), (256, 1024, 0)])
def test_gather_matches_jax(jax_output, S, L, axis):
    jg = _jg()
    want = jax_output(jg, jg.gather_correct, S, L, axis)
    idx = _index(0, L if axis == 1 else S, (S, L))
    got = probes_mem.gather(_t(_arange(S, L)), _t(idx), axis)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert probe_gather.gather_correct(S, L, axis, device="cpu") == "correct"


@pytest.mark.parametrize("S,L,K,axis", [(8, 256, 64, 1), (256, 128, 64, 0)])
def test_gather_narrow_matches_jax(jax_output, S, L, K, axis):
    jg = _jg()
    want = jax_output(jg, jg.gather_narrow_idx, S, L, K, axis)
    shape, hi = ((S, K), L) if axis == 1 else ((K, L), S)
    got = probes_mem.gather(_t(_arange(S, L)), _t(_index(1, hi, shape)),
                            axis)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert probe_gather.gather_narrow_idx(S, L, K, axis,
                                          device="cpu") == "correct"


# -- 5c: the gather chain -----------------------------------------------------

@pytest.mark.parametrize("S,L,axis", [(8, 128, 1), (64, 256, 1),
                                      (32, 128, 0)])
def test_gather_chain_matches_jax(jax_output, S, L, axis):
    jg = _jg()
    want = jax_output(jg, jg.gather_cost, S, L, axis, n_iter=3)
    idx = _index(2, L if axis == 1 else S, (S, L))
    got = probes_mem.gather_chain(_t(_arange(S, L) % 7), _t(idx), axis,
                                  n_iter=3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
def test_gather_chain_is_repeated_gather(axis):
    # Random words and a ragged last tile: n steps of the chain are n
    # gathers, each plus one, with int32 wrap-around.
    rs = np.random.default_rng(5)
    S, L = (40, 100) if axis == 1 else (300, 45)
    x = rs.integers(-2 ** 31, 2 ** 31, size=(S, L)).astype(np.int32)
    idx = _index(6, L if axis == 1 else S, (S, L))
    want = x.astype(np.int64)
    for _ in range(4):
        want = (np.take_along_axis(want, idx, axis) + 1) % 2 ** 32
    got = probes_mem.gather_chain(_t(x), _t(idx), axis, n_iter=4)
    np.testing.assert_array_equal(got.numpy().astype(np.int64) % 2 ** 32,
                                  want)


@pytest.mark.parametrize("S,L,axis,want", [
    (8, 128, 1, (8, 128, 4)), (64, 256, 1, (4, 256, 4)),
    (4224, 256, 1, (4, 256, 4)), (256, 1024, 0, (256, 32, 32)),
    (32, 128, 0, (32, 32, 4)), (8, 128, 0, (8, 32, 1)),
    (9000, 64, 0, None), (8, 9000, 1, None)])
def test_gather_chain_tiles(S, L, axis, want):
    # Whole rows on axis 1 (up to 1024 words a tile), a 32-column strip of
    # all rows on axis 0; a segment past the 8192-word tile is refused.
    if want is None:
        with pytest.raises(ValueError, match="does not fit"):
            probes_mem.chain_tile(S, L, axis)
    else:
        assert probes_mem.chain_tile(S, L, axis) == want


# -- 5d, 5h, 5i: kernel A -----------------------------------------------------

@pytest.mark.parametrize("S,L,n_iter", [(8, 128, 3), (16, 256, 40)])
def test_add_cost_matches_jax(jax_output, S, L, n_iter):
    jg = _jg()
    want = jax_output(jg, jg.add_cost, S, L, n_iter=n_iter)
    got = probes.vpu_doubling(torch.ones((S, L), dtype=torch.int32), False,
                              n_iter=1, k=1, inner=n_iter)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,C,n_iter,k", [
    (1, 128, 3, 1), (8, 128, 5, 1), (128, 8, 2, 1),
    # kernel A's dependent mode: one chain, k iterations of an odd inner
    (8, 128, 3, 4), (8, 128, 3, 8)])
def test_pass_cost_matches_jax(jax_output, S, C, n_iter, k):
    js = _js()
    want = jax_output(js, js.pass_cost, S, C, n_iter=n_iter * k)
    got = probes.vpu_doubling(torch.ones((S, C), dtype=torch.int32), False,
                              n_iter=1, k=k, inner=n_iter)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,C,n_iter,k", [(8, 128, 3, 8), (16, 128, 2, 4),
                                          (8, 128, 5, 1), (8, 128, 5, 4)])
def test_independent_pass_cost_matches_jax(jax_output, S, C, n_iter, k):
    js = _js()
    want = jax_output(js, js.independent_pass_cost, S, C, n_iter=n_iter,
                      k=k)
    got = probes.vpu_doubling(torch.ones((S, C), dtype=torch.int32), True,
                              n_iter=1, k=k, inner=n_iter)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == sum((1 + i) << n_iter for i in range(k))).all()


def test_pass_wrappers_are_kernel_a():
    # Random words: kernel A with every doubling in its inner loop (the
    # tools' split) gives the JAX loops' words, one doubling a step: x << n,
    # and for k chains the sum of (x + i) << n, mod 2^32.
    x = np.random.default_rng(8).integers(-2 ** 31, 2 ** 31,
                                          size=(4, 64)).astype(np.int32)
    x64 = x.astype(np.int64)
    for n, k in ((7, 1), (5, 8), (31, 4)):
        want = sum((x64 + i) << n for i in range(k)) % 2 ** 32
        got = probes.vpu_doubling(_t(x), k > 1, n_iter=1, k=k, inner=n)
        np.testing.assert_array_equal(got.numpy().astype(np.int64) % 2 ** 32,
                                      want)
        np.testing.assert_array_equal(
            got.numpy(), probes.vpu_doubling(_t(x), k > 1, n_iter=n, k=k,
                                             inner=1).numpy())


# -- 5e, 5f: the slice copy ---------------------------------------------------

@pytest.mark.parametrize("S,offset", [(256, 16), (256, 8), (256, 12),
                                      (496, 240)])
def test_slice_load_matches_jax(jax_output, S, offset):
    js = _js()
    want = jax_output(js, js.dyn_sublane_load, S, 128, 16, offset)
    off = torch.tensor([offset], dtype=torch.int32)
    got = probes_mem.slice_load(_t(_arange(S, 128)), off, 16)
    assert got.shape == (16, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert probe_slice.dyn_sublane_load(S, 128, 16, offset,
                                        device="cpu") == "correct"


def test_slice_store_matches_jax(jax_output):
    js = _js()
    want = jax_output(js, js.dyn_sublane_store, 256, 128, 16, 48)
    off = torch.tensor([48], dtype=torch.int32)
    got = probes_mem.slice_store(_t(_arange(256, 128)), off, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert probe_slice.dyn_sublane_store(256, 128, 16, 48,
                                         device="cpu") == "correct"


# -- 5g: the slice loop -------------------------------------------------------

def _slice_loop_closed_form(S, C, width, n_iter):
    # Row r holds the sum of t + 1 over the steps whose slice covers it.
    out = np.zeros((S, C), np.int64)
    for r in range(S):
        out[r] = sum(t + 1 for t in range(n_iter)
                     if 16 * t % S <= r < 16 * t % S + width)
    return out % 2 ** 32


@pytest.mark.parametrize("S,width,n_iter", [(64, 16, 7), (48, 16, 5),
                                            (40, 8, 11)])
def test_slice_loop_matches_jax(jax_output, S, width, n_iter):
    # Each run wraps S: the offsets come round to row 0 (and at S=40 the
    # 16-row step lands on rows 8 and 24 too).
    js = _js()
    want = jax_output(js, js.dyn_slice_loop_cost, S, 128, width,
                      n_iter=n_iter)
    got = probes_mem.slice_loop(torch.zeros((S, 128), dtype=torch.int32),
                                width, n_iter=n_iter)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want.astype(np.int64) % 2 ** 32,
        _slice_loop_closed_form(S, 128, width, n_iter))


def test_slice_loop_closed_form_long_run():
    # The tool's shape at a few hundred steps, against the closed form.
    got = probes_mem.slice_loop(torch.zeros((256, 8), dtype=torch.int32), 16,
                                n_iter=300)
    np.testing.assert_array_equal(got.numpy().astype(np.int64) % 2 ** 32,
                                  _slice_loop_closed_form(256, 8, 16, 300))
    assert probes_mem.slice_offsets(256, 300) == list(range(0, 256, 16))
    assert probes_mem.slice_offsets(40, 100) == [0, 8, 16, 24, 32]


# -- 5j: the reduce -----------------------------------------------------------

# Row counts at both of the kernel's instances' edges: in registers up to 64
# rows, the staged strip above.
REDUCE_ROWS = [1, 8, 63, 64, 65]


@pytest.mark.parametrize("S", REDUCE_ROWS)
def test_sublane_reduce_matches_jax(jax_output, S):
    js = _js()
    want = jax_output(js, js.sublane_reduce_cost, S, 128, n_iter=3)
    got = probes_mem.sublane_reduce(torch.ones((S, 128), dtype=torch.int32),
                                    n_iter=3)
    assert got.shape == (1, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == S + S * S + S ** 3).all()  # 584 at S = 8


@pytest.mark.parametrize("S", REDUCE_ROWS + [24])
def test_sublane_reduce_closed_form(S):
    # acc <- sum(x) + S * acc per column, mod 2^32, on random words.
    rs = np.random.default_rng(9 + S)
    C = 40
    x = rs.integers(-2 ** 31, 2 ** 31, size=(S, C)).astype(np.int32)
    acc = np.zeros(C, np.int64)
    col = x.astype(np.int64).sum(0)
    for _ in range(6):
        acc = (col + S * acc) % 2 ** 32
    got = probes_mem.sublane_reduce(_t(x), n_iter=6)
    np.testing.assert_array_equal(got.numpy()[0].astype(np.int64) % 2 ** 32,
                                  acc)


def test_reduce_instance_by_rows():
    # The launcher's template instance: S itself while the column fits the
    # registers, 0 (the staged strip) above, up to the largest S a block's
    # shared memory takes.
    assert [probes_mem.reduce_instance(S) for S in range(1, 65)] == list(
        range(1, 65))
    assert probes_mem.REDUCE_REG_ROWS == 64
    for S in (65, 256, 448):
        assert probes_mem.reduce_instance(S) == 0
        probes_mem._check_strip(torch.zeros((S, 8), dtype=torch.int32),
                                probes_mem.REDUCE_COLS)


# -- 5k: the PRNG draws -------------------------------------------------------

def test_jax_prng_probe_is_zeros_in_interpret_mode(jax_output):
    # The TPU's hardware generator is stubbed to zeros when interpreted:
    # there is no stream for the port to match.
    js = _js()
    want = jax_output(js, js.prng_cost, 2, 128, n_iter=3)
    assert want.shape == (2, 128) and not want.any()


@pytest.mark.parametrize("shape,n_iter", [((2, 128), 3), ((3, 5), 11)])
def test_prng_lowbias32_matches_jax_prng(monkeypatch, shape, n_iter):
    from mcqueens.kernels import prng as jprng

    # A small twin block, so the draws span several blocks of steps.
    monkeypatch.setattr(probes_mem, "_TWIN_BLOCK_WORDS", 2 * math.prod(shape))
    g = jprng.chain_streams(jnp.arange(math.prod(shape), dtype=jnp.int32)
                            + 7)
    acc = jnp.zeros_like(g)
    for t in range(n_iter):
        w0, w1 = jprng.step_words(g, jnp.int32(9 + t))
        acc = acc + w0 + w1
    got = probes_mem.prng_draws(shape, "lowbias32", n_iter=n_iter,
                                device="cpu")
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(acc))


@pytest.mark.parametrize("shape,n_iter", [((2, 128), 3), ((3, 5), 11)])
def test_prng_threefry_matches_jax_random(monkeypatch, shape, n_iter):
    monkeypatch.setattr(probes_mem, "_TWIN_BLOCK_WORDS", 2 * math.prod(shape))
    acc = jnp.zeros(shape, jnp.uint32)
    for t in range(n_iter):
        k = jax.random.fold_in(jax.random.key(7), 9 + t)
        acc = acc + jax.random.bits(k, shape)
    got = probes_mem.prng_draws(shape, "threefry", n_iter=n_iter,
                                device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(acc).view(np.int32))


# -- refusals, counts, tools --------------------------------------------------

def _drop_failed_tokens():
    """Wait for the process's ordered-effect tokens and drop them, and reset
    the interpreter's shared state.  JAX threads interpret-mode callbacks
    through one such token a thread, and a kernel whose callback raised
    leaves it failed and its simulated memory uncleared: every later
    interpret-mode kernel in the process (an xdist worker's next test
    files) would then fail, with that kernel's IndexError or, on another
    device count, at the interpreter's shared-memory check."""
    from jax._src import dispatch

    try:
        jax.effects_barrier()
    except jax.errors.JaxRuntimeError:
        pass  # the refusal the caller has already asserted
    dispatch.runtime_tokens.clear()
    pltpu.reset_tpu_interpret_mode_state()


def test_out_of_range_slices_are_refused_by_both(jax_output):
    # JAX: an out-of-range pl.ds raises in interpret mode (no clamping).
    js = _js()
    try:
        with pytest.raises(Exception, match="Out-of-bounds"):
            jax_output(js, js.dyn_sublane_load, 256, 128, 16, 250)
        with pytest.raises(Exception, match="Out-of-bounds"):
            jax_output(js, js.dyn_slice_loop_cost, 64, 128, 24, n_iter=7)
    finally:
        _drop_failed_tokens()
    x = _t(_arange(256, 128))
    for o in (250, -1):
        off = torch.tensor([o], dtype=torch.int32)
        with pytest.raises(ValueError, match="rows"):
            probes_mem.slice_load(x, off, 16)
        with pytest.raises(ValueError, match="rows"):
            probes_mem.slice_store(x, off, 16)
    with pytest.raises(ValueError, match="runs past"):
        probes_mem.slice_loop(torch.zeros((64, 128), dtype=torch.int32), 24,
                              n_iter=7)
    # the same width is taken while no step reaches the last offsets
    probes_mem.slice_loop(torch.zeros((64, 128), dtype=torch.int32), 24,
                          n_iter=3)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = _t(_arange(8, 16))
    idx = _t(_index(0, 16, (8, 16)))
    bad = idx.clone()
    bad[3, 4] = 16
    with pytest.raises(ValueError, match="index"):
        probes_mem.gather(x, bad, 1)
    bad[3, 4] = -1
    with pytest.raises(ValueError, match="index"):
        probes_mem.gather_chain(x, bad, 1, n_iter=1)
    with pytest.raises(ValueError, match="index"):
        probes_mem.gather(x, idx, 0)  # values up to 15 on an 8-row axis
    with pytest.raises(ValueError):
        probes_mem.gather(x.long(), idx, 1)
    with pytest.raises(ValueError):
        probes_mem.gather(x, idx[:4], 1)  # axis 1 wants (S, K)
    with pytest.raises(ValueError):
        probes_mem.gather(x, idx, 2)
    with pytest.raises(ValueError):
        probes_mem.slice_load(x, torch.tensor([0]), 4)  # an int64 offset
    with pytest.raises(ValueError):
        probes_mem.sublane_reduce(x.to(torch.int16), n_iter=1)
    with pytest.raises(ValueError, match="shared memory"):
        probes_mem.slice_loop(torch.zeros((2000, 4), dtype=torch.int32), 16,
                              n_iter=1)
    with pytest.raises(ValueError, match="k=3"):
        probes.vpu_doubling(x, True, n_iter=1, k=3, inner=1)
    with pytest.raises(ValueError, match="n_iter"):
        probes_mem.gather_chain(x, idx, 1, n_iter=-1)
    with pytest.raises(ValueError, match="mode"):
        probes_mem.prng_draws((2, 4), "philox", n_iter=1, device="cpu")
    # Neither cpu nor cuda: no twin, no kernel.
    with pytest.raises(ValueError):
        probes_mem.sublane_reduce(torch.ones((8, 16), dtype=torch.int32,
                                             device="meta"), n_iter=1)


def test_twins_count_no_launch():
    before = dict(probes_mem.LAUNCHES), dict(probes.LAUNCHES)
    x = _t(_arange(8, 32))
    idx = _t(_index(0, 32, (8, 32)))
    off = torch.tensor([2], dtype=torch.int32)
    probes_mem.gather(x, idx, 1)
    probes_mem.gather_chain(x, idx, 1, n_iter=2)
    probes.vpu_doubling(x, False, n_iter=1, k=1, inner=2)
    probes.vpu_doubling(x, True, n_iter=1, k=8, inner=2)
    probes_mem.slice_load(x, off, 4)
    probes_mem.slice_store(x, off, 4)
    probes_mem.slice_loop(x, 4, n_iter=2)
    probes_mem.sublane_reduce(x, n_iter=2)
    for mode in probes_mem.PRNG_MODES:
        probes_mem.prng_draws((2, 8), mode, n_iter=2, device="cpu")
    assert (dict(probes_mem.LAUNCHES), dict(probes.LAUNCHES)) == before


def _rate_ok(v):
    return math.isfinite(v) and v > 0


def test_cost_probes_on_cpu():
    nums = [probe_gather.gather_cost(8, 64, 1, n_iter=2, reps=1,
                                     device="cpu")[1],
            probe_gather.gather_cost(16, 32, 0, n_iter=2, reps=1,
                                     device="cpu")[1],
            probe_gather.add_cost(8, 64, n_iter=3, reps=1, device="cpu")[1],
            probe_slice.dyn_slice_loop_cost(64, 32, 16, n_iter=5, reps=1,
                                            device="cpu")[1],
            probe_slice.pass_cost(8, 64, n_iter=3, reps=1, device="cpu")[1],
            probe_slice.independent_pass_cost(8, 64, n_iter=3, reps=1,
                                              device="cpu")[1],
            probe_slice.sublane_reduce_cost(8, 64, n_iter=3, reps=1,
                                            device="cpu")[1]]
    for n in nums:
        assert _rate_ok(n["ns_per_1024_words"]), n
    text, n = probe_slice.prng_cost(2, 64, n_iter=2, reps=1, device="cpu")
    assert "not the TPU's hardware PRNG" in text
    for mode in probes_mem.PRNG_MODES:
        assert _rate_ok(n[f"{mode}_ns_per_1024_words"])


@pytest.mark.parametrize("module", [probe_gather, probe_slice])
def test_tools_main_on_cpu(module, tmp_path, monkeypatch, capsys):
    # The whole tool with small card-filling shapes and trip counts: the
    # JAX tool's probe lines in its order, every probe OK.
    monkeypatch.setattr(tools, "TIMING_THREADS", 2048)
    monkeypatch.setattr(tools, "ALU_WIDTH", 256)
    monkeypatch.setattr(tools, "ONE_PASS_WORDS", 32768)
    for name in ("LOOP_N_ITER", "REDUCE_N_ITER", "PRNG_N_ITER"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, 64)
    out = tmp_path / "out.json"
    assert module.main(["--quick", "--device", "cpu", "--json",
                        str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["card"] is None
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("PROBE ")]
    names = [ln[6:].split(": ", 1)[0] for ln in lines]
    assert names == list(res["probes"])
    assert all(p["status"] == "OK" for p in res["probes"].values()), lines
    jax_names = [n for n in names if "[fills the card]" not in n]
    jax_tool = {probe_gather: _jg, probe_slice: _js}[module]()
    want = re.findall(r'probe\("([^"]+)"',
                      Path(jax_tool.__file__).read_text())
    assert len(want) == {probe_gather: 14, probe_slice: 16}[module]
    assert jax_names == want


@pytest.mark.parametrize("module", [probe_gather, probe_slice])
def test_tools_default_to_the_card_and_keep_off_tpu_files(module, tmp_path,
                                                          monkeypatch):
    # --device defaults to cuda: with no card the tool refuses to run (no
    # CPU fallback).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--quick", "--json", str(tmp_path / "out.json")])
    # The TPU's results in artifacts/ are never written.
    name = module.__name__.rsplit(".", 1)[1]
    tpu = Path(tools.REPO) / "artifacts" / f"{name}.json"
    with pytest.raises(ValueError, match="TPU"):
        module.main(["--quick", "--device", "cpu", "--json", str(tpu)])
