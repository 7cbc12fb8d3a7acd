"""The gather chain and the PRNG draws, run as host C++, against their twins.

``kernels/csrc/probe_gather.cu`` and ``probe_slice.cu`` are CUDA only; on a
machine without a card :mod:`mcqueens_torch.kernels.host_emulation` builds
them with g++ against ``kernels/emu/cuda_runtime.h`` (a fiber per CUDA
thread released in a seeded pseudo-random order, the warp intrinsics,
shared-memory atomics and ``__syncthreads`` over barriers, shared memory
filled with 0xA5 so that a slot read before it is written shows), and
``probes_mem.launch_chain`` / ``launch_prng`` run them on CPU tensors.
Every case must equal the plain-torch twin (``gather_chain_reference``,
``prng_draws_reference``) bitwise, in both of the emulator's shared-memory
models: ``ordered`` (a store is seen at once) and ``delayed`` (only
``__syncwarp`` and ``__syncthreads`` make one thread's stores visible to
another, and racing stores fail the launch).  The gather chain's bank
schedule, which its axis-1 prologue builds from the index, is read back
and held to its invariants.  Skips only when g++ is absent.  No JAX: the
twins are held to the JAX kernels by ``tests/test_torch_probes_mem.py``.
"""

import numpy as np
import pytest
import torch

from mcqueens_torch.kernels import host_emulation, probes_mem


@pytest.fixture(scope="module")
def lib():
    if host_emulation.compiler() is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    return host_emulation.load()


@pytest.fixture(params=["ordered", "delayed"])
def memory(request, monkeypatch):
    """The emulator's shared-memory model for the test's launches."""
    monkeypatch.setenv("MCQ_EMU_MEMORY", request.param)
    return request.param


def _words(rs, shape):
    return torch.from_numpy(rs.integers(-2 ** 31, 2 ** 31, shape).astype(
        np.int32))


def _index(kind, S, L, axis, seed=4):
    """An int32 index of ``kind``: random, or one that defeats a bank
    schedule (every element gathering one word, every source in one bank,
    the identity, a permutation of each row)."""
    rs = np.random.default_rng(seed)
    n_src = L if axis == 1 else S
    if kind == "random":
        a = rs.integers(0, n_src, (S, L))
    elif kind == "all zeros":
        a = np.zeros((S, L))
    elif kind == "one bank":
        a = 32 * rs.integers(0, max(1, n_src // 32), (S, L))
    elif kind == "identity":
        a = (np.broadcast_to(np.arange(L), (S, L)) if axis == 1
             else np.broadcast_to(np.arange(S)[:, None], (S, L)))
    else:  # a permutation of each row (axis 1) or column (axis 0)
        a = (np.stack([rs.permutation(L) for _ in range(S)]) if axis == 1
             else np.stack([rs.permutation(S) for _ in range(L)], 1))
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _chain(lib, x, idx, axis, n_iter, schedule=False):
    """The emulated chain's words, and its schedule on axis 1 if asked."""
    S, L = x.shape
    rows, cols, e = probes_mem.chain_tile(S, L, axis)
    sched = None
    if schedule:
        sched = torch.empty((-(-S // rows), probes_mem.chain_instructions(e),
                             32), dtype=torch.int32)
    out = torch.empty_like(x)
    probes_mem.launch_chain(lib, x, idx, out, axis, n_iter=n_iter,
                            schedule=sched)
    return out, sched


# -- the gather chain ---------------------------------------------------------

# (S, L, axis): whole rows on axis 1 (tiles of 4, 4, 8, 16 elements a
# thread, ragged last tiles), strips on axis 0 (32 and 4)
SHAPES = [(8, 128, 1), (64, 256, 1), (40, 100, 1), (6, 400, 1),
          (5, 2000, 1), (3, 4000, 1), (300, 45, 0), (32, 128, 0)]


@pytest.mark.parametrize("S,L,axis", SHAPES)
def test_gather_chain_matches_twin(lib, memory, S, L, axis):
    rs = np.random.default_rng(S * L + axis)
    x, idx = _words(rs, (S, L)), _index("random", S, L, axis)
    got, _ = _chain(lib, x, idx, axis, n_iter=5)
    assert torch.equal(got, probes_mem.gather_chain_reference(x, idx, axis,
                                                               n_iter=5))


@pytest.mark.parametrize("kind", ["all zeros", "one bank", "identity",
                                  "permutation"])
@pytest.mark.parametrize("S,L,axis", [(16, 256, 1), (3, 4000, 1),
                                      (32, 128, 0)])
def test_gather_chain_adversarial_indices(lib, memory, kind, S, L, axis):
    rs = np.random.default_rng(3)
    x, idx = _words(rs, (S, L)), _index(kind, S, L, axis)
    got, _ = _chain(lib, x, idx, axis, n_iter=5)
    assert torch.equal(got, probes_mem.gather_chain_reference(x, idx, axis,
                                                               n_iter=5))


@pytest.mark.parametrize("S,L,axis,e", [(1, 200, 1, 1), (1, 500, 1, 2),
                                        (2, 8000, 1, 32), (8, 96, 0, 1)])
def test_gather_chain_every_instance(lib, memory, S, L, axis, e):
    # the instances the shapes above do not reach
    assert probes_mem.chain_tile(S, L, axis)[2] == e
    rs = np.random.default_rng(e)
    x, idx = _words(rs, (S, L)), _index("random", S, L, axis)
    got, _ = _chain(lib, x, idx, axis, n_iter=4)
    assert torch.equal(got, probes_mem.gather_chain_reference(x, idx, axis,
                                                               n_iter=4))


@pytest.mark.parametrize("n_iter", [0, 1, 2, 7])
@pytest.mark.parametrize("axis", [0, 1])
def test_gather_chain_step_counts(lib, n_iter, axis):
    # the axis-1 loop runs two steps a trip: odd counts end off it
    rs = np.random.default_rng(n_iter)
    x, idx = _words(rs, (24, 128)), _index("random", 24, 128, axis)
    got, _ = _chain(lib, x, idx, axis, n_iter=n_iter)
    assert torch.equal(got, probes_mem.gather_chain_reference(
        x, idx, axis, n_iter=n_iter))


def _schedule_stats(sched, S, L):
    """(elements placed per tile word, lanes whose store bank is not the
    lane, load conflicts, instructions a 256-word row) of a schedule."""
    sc = sched.numpy().view(np.uint32)
    live = sc != 0xFFFFFFFF
    src, own = sc & 0xFFFF, sc >> 16
    rows, _, _ = probes_mem.chain_tile(S, L, 1)
    placed = []
    for b in range(sc.shape[0]):
        T = min(rows, S - b * rows) * L
        got = np.sort(own[b][live[b]])
        # every tile word's position, once: the positions are a layout of
        # the T words, so T distinct values below 32 * ceil(T / 32)
        placed.append(len(got) == T and len(np.unique(got)) == T
                      and got.max() < 32 * -(-T // 32))
    lanes = np.broadcast_to(np.arange(32), sc.shape)
    wrong_bank = int(((own % 32 != lanes) & live).sum())
    conflicts = 0
    for blk, lv in zip(src, live):
        for ins, m in zip(blk, lv):
            if m.any():
                u = np.unique(ins[m])
                conflicts += int(np.bincount(u % 32, minlength=32).max()) - 1
    instr = int(live.any(-1).sum())
    return all(placed), wrong_bank, conflicts, instr * 256 / (S * L)


@pytest.mark.parametrize("kind", ["random", "all zeros", "one bank",
                                  "identity", "permutation"])
@pytest.mark.parametrize("S,L", [(16, 256), (3, 4000), (40, 100)])
def test_gather_chain_schedule_invariants(lib, kind, S, L):
    # Every element placed once; each lane stores to its own bank; no two
    # distinct words loaded from one bank by one instruction for these
    # indices (the fallback that allows it is not reached).
    x, idx = torch.zeros((S, L), dtype=torch.int32), _index(kind, S, L, 1)
    _, sched = _chain(lib, x, idx, 1, n_iter=1, schedule=True)
    placed, wrong_bank, conflicts, _ = _schedule_stats(sched, S, L)
    assert placed and wrong_bank == 0 and conflicts == 0


def test_gather_chain_schedule_packs_random_rows(lib):
    # At the gather tool's row width the schedule takes under 10
    # instructions a 256-word row (8 with no conflict; the parent's order
    # took 8 whose loads conflicted, ~3.2 wavefronts each).
    S, L = 64, 256
    x, idx = torch.zeros((S, L), dtype=torch.int32), _index("random", S, L, 1)
    _, sched = _chain(lib, x, idx, 1, n_iter=1, schedule=True)
    _, _, conflicts, per_row = _schedule_stats(sched, S, L)
    assert conflicts == 0 and 8 <= per_row < 10


@pytest.mark.parametrize("S,L,want", [(8, 128, (8, 128, 4)),
                                      (64, 256, (4, 256, 4)),
                                      (4224, 256, (4, 256, 4)),
                                      (3, 200, (3, 200, 4)),
                                      (1, 200, (1, 200, 1)),
                                      (5, 2000, (1, 2000, 8))])
def test_chain_tile_takes_rows_up_to_1024_words(S, L, want):
    assert probes_mem.chain_tile(S, L, 1) == want


# -- the PRNG draws ------------------------------------------------------------

# (shape, n_iter, step0): a step count that is not a multiple of the key
# chunk (128 steps), ragged word counts (not a multiple of the 512 words a
# block draws), steps wrapping past 2^32, no step at all
PRNG_CASES = [((2, 1024), 130, 9), ((3, 333), 257, 9), ((1, 1000), 1, 9),
              ((7, 51), 40, 2 ** 32 - 17), ((5, 77), 3, 2 ** 32 - 1),
              ((2, 8), 0, 9)]


@pytest.mark.parametrize("shape,n_iter,step0", PRNG_CASES)
@pytest.mark.parametrize("mode", probes_mem.PRNG_MODES)
def test_prng_draws_match_twin(lib, memory, mode, shape, n_iter, step0):
    got = torch.empty(shape, dtype=torch.int32)
    probes_mem.launch_prng(lib, got, mode, n_iter=n_iter, step0=step0)
    want = probes_mem.prng_draws_reference(shape, mode, n_iter=n_iter,
                                           device="cpu", step0=step0)
    assert torch.equal(got, want)


def test_prng_wrapper_passes_step0():
    # the public wrapper on the CPU is the twin, from the step it is given
    a = probes_mem.prng_draws((2, 8), "threefry", n_iter=3, device="cpu",
                              step0=2 ** 32 - 1)
    b = probes_mem.prng_draws_reference((2, 8), "threefry", n_iter=3,
                                        device="cpu", step0=2 ** 32 - 1)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="step0"):
        probes_mem.prng_draws((2, 8), "threefry", n_iter=1, device="cpu",
                              step0=2 ** 32)


# -- the variants pair_scan_slice.py times beside the committed kernels --------

def _variant_sets():
    import pair_scan_slice as pss

    return {"probe_gather.cu": {**pss.GATHER_VARIANTS,
                                **pss.GATHER_PROLOGUE_VARIANTS},
            "probe_slice.cu": pss.PRNG_VARIANTS,
            "probe_alu.cu": pss.VPU_VARIANTS}


@pytest.mark.parametrize("source", ["probe_gather.cu", "probe_slice.cu",
                                    "probe_alu.cu"])
def test_variants_compile_as_host_cpp(source):
    # Each variant's text substitutions find their lines in the committed
    # source, and the result parses (g++ against the emulation header), so
    # that --only gather_variants, prng_variants and vpu_variants build on
    # the card.
    import subprocess

    import pair_scan_slice as pss
    from mcqueens_torch.kernels import _build

    texts = pss.variant_sources(source, _variant_sets()[source])
    assert texts["committed"] == (_build._PKG / "csrc" / source).read_text()
    if host_emulation.compiler() is None or source == "probe_alu.cu":
        return  # probe_alu.cu's PTX has no host form
    for name, text in texts.items():
        proc = subprocess.run(
            [host_emulation.compiler(), "-std=c++20", "-fsyntax-only", "-w",
             f"-I{host_emulation.EMU_DIR}", f"-I{_build._PKG / 'csrc'}",
             "-x", "c++", "-"], input=host_emulation.translate(text),
            capture_output=True, text=True)
        assert proc.returncode == 0, f"{name}: {proc.stderr[:2000]}"
