"""mcqueens_torch — the PyTorch / CUDA port of :mod:`mcqueens`.

The JAX package stays the reference; this package mirrors its module names so
each counterpart is easy to find, and reproduces all four of its samplers
(``tables``/``naive`` scans, ``pallas`` per-chain, ``pallas_shared``
shared-site; boards and full-3D placements, plain or parallel-tempered) bit
for bit: the same seeds, keys, block partition and streams give the same
trajectories, best states, bins and histories.  It imports ``torch`` and
numpy, never ``jax``.

Layers (bottom-up):
    core/     energy oracle, count tables, schedules, JAX's threefry PRNG,
              key-based and hash-based init
    chain/    ChainSpec, the tables/naive scan samplers with their
              hand-written CUDA kernels (kernels/csrc/), run statistics
    kernels/  counter PRNG, block sizing, the carries, and the per-chain and
              shared-site board and full-3D samplers with their hand-written
              CUDA kernels (csrc/)
    search/   parallel tempering (replica exchange)
    dist/     run_chains / run_experiment on one device
    experiments/  config-driven experiment drivers, plots and CSVs
    cli/      the competition and experiments CLIs
    utils/    throughput reporting

Every function that allocates takes an explicit ``device``; the CPU path is
the kernels' plain-torch twins and is taken only when ``device="cpu"`` is
asked for.
"""

__version__ = "0.1.0"
