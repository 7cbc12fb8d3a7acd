"""The samplers' shared segment layer (``mcqueens_torch.kernels.segment``)
and the port's layering (CPU, no JAX).

Every sampler launches through ``segment.launch``: off the card it checks
its arguments first and then refuses the state, counting nothing.  The
kernels and chain layers import nothing of the layers above them, and the
launch path lives in ``segment.py`` alone.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from mcqueens_torch.chain import board as board_chain
from mcqueens_torch.chain import full3d as full3d_chain
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import rng
from mcqueens_torch.core.schedules import build_schedule, chunk_betas
from mcqueens_torch.kernels import (board_shared, full3d_pallas,
                                    full3d_shared, metropolis_pallas, segment)

PKG = pathlib.Path(segment.__file__).resolve().parents[1]
LOWER = sorted((PKG / "kernels").glob("*.py")) + sorted(
    (PKG / "chain").glob("*.py"))
HIGHER = ("mcqueens_torch.dist", "mcqueens_torch.search",
          "mcqueens_torch.experiments")
SAMPLERS = {"board_shared": board_shared, "full3d_shared": full3d_shared,
            "metropolis_pallas": metropolis_pallas,
            "full3d_pallas": full3d_pallas, "chain.board": board_chain,
            "chain.full3d": full3d_chain}
SEEDS = np.arange(8, dtype=np.uint32)


def _imports(path):
    """Every module name an ``import`` or ``from`` of ``path`` names,
    ``from a import b`` as both ``a`` and ``a.b``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", LOWER, ids=lambda p: f"{p.parent.name}."
                         f"{p.stem}")
def test_kernels_and_chain_import_no_higher_layer(path):
    bad = [m for m in _imports(path)
           if any(m == h or m.startswith(h + ".") for h in HIGHER)]
    assert not bad, bad


def test_launch_path_lives_in_segment_alone():
    """The stream, the SM count and the library are read in one place."""
    for mod in SAMPLERS.values():
        text = pathlib.Path(mod.__file__).read_text()
        for needle in ("current_stream", "multi_processor_count",
                       "load_library()", "run_segment_sharded"):
            assert needle not in text, (mod.__name__, needle)
    text = pathlib.Path(segment.__file__).read_text()
    for needle in ("current_stream", "multi_processor_count",
                   "load_library()"):
        assert text.count(needle) == 1, needle


def _state(name):
    """A CPU working state of sampler ``name`` (N=5), its spec and the
    arguments of one launch ahead of its betas."""
    mod = SAMPLERS[name]
    full = "full3d" in name
    kernel = ("tables" if name.startswith("chain") else
              "pallas_shared" if name.endswith("shared") else "pallas")
    spec = ChainSpec(N=5, n_steps=20, kernel=kernel,
                     mcmc_type="full_3d" if full else "board",
                     history_stride=10, Q=13 if full else None,
                     schedule=build_schedule("linear_annealing", 20,
                                             beta_start=0.5, beta_end=3.0))
    seeds = rng.chain_keys_from_seeds(SEEDS) if kernel == "tables" else SEEDS
    st = mod.segment_state(mod.init_carry_batch(seeds, spec, device="cpu"))
    if kernel == "tables":
        ys = torch.empty((1, st.energy.shape[0]), dtype=torch.int32)
        return mod, st, spec, (ys, 0, 1)
    return mod, st, spec, (0, 10)


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_launch_off_the_card_checks_arguments_then_refuses(name):
    """``segment_cuda`` of CPU state: a bad beta is the error it names, a
    good launch is refused for its device, and neither counts."""
    mod, st, spec, head = _state(name)
    before = mod.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="beta"):
        mod.segment_cuda(st, *head, spec, torch.zeros(11))
    beta = chunk_betas(spec.schedule, 0, 10, "cpu")
    with pytest.raises(ValueError, match="not a CUDA device"):
        mod.segment_cuda(st, *head, spec, beta)
    assert mod.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_launch_reads_the_sampler_when_called(name, monkeypatch):
    """``run_segment`` reaches the sampler's twin as the module holds it at
    the call: one launch a chunk, or one a segment of a scan sampler."""
    mod, _, spec, _ = _state(name)
    scan = name.startswith("chain")
    seeds = rng.chain_keys_from_seeds(SEEDS) if scan else SEEDS
    carry = mod.init_carry_batch(seeds, spec, device="cpu")
    calls, twin = [], mod.segment_reference

    def counted(*args, **kw):
        # (start_outer, n_outer) of a scan segment, (step0, n_inner) of a
        # chunk.
        calls.append(args[2:4] if scan else args[1:3])
        return twin(*args, **kw)

    monkeypatch.setattr(mod, "segment_reference", counted)
    _, ys = mod.run_segment(carry, 0, spec, spec.n_outer)
    assert ys.shape == (spec.n_outer, carry.energy.shape[0])
    assert calls == ([(0, 2)] if scan else [(0, 10), (10, 10)])
