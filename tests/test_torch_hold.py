"""The shared-site full-3D sampler at mover holds 16 and 32 (CPU).

``tools/probe_hold.py`` varies the hold by patching
``mcqueens.kernels.full3d_shared._HOLD``; the port's counterpart is
``mcqueens_torch.kernels.full3d_shared._HOLD``, read at each launch by the
twin and the CUDA launcher.  Here both are patched together, and the
port's twin must equal the JAX kernel (interpret mode) bitwise in every
``ChainResult`` field.  The JAX kernel skips the held chunks of launches
under 1024 steps at holds above 8, so the case launches 1024 steps at a
time (1100 steps: the second launch stops 76 steps in); the port refuses
shorter launches at those holds.  The compiled JAX segment is cached on
``(spec, n_inner)``, not on the hold, so the caches are cleared around
each patch.
"""

import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.core import schedules as jschedules
from mcqueens.dist import runner as jrunner
from mcqueens.kernels import full3d_shared as jf3s
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import schedules
from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import full3d_shared
from tests.test_torch_foundations import release_jax_executables  # noqa: F401
from tests.test_torch_full3d_shared import RESULT_FIELDS, SEEDS

LINEAR = dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)


def _specs(n_bins, n_steps=1100, stride=1024):
    kw = dict(N=5, Q=13, n_steps=n_steps, history_stride=stride,
              n_bins=n_bins, init_mode="random", mcmc_type="full_3d",
              kernel="pallas_shared")
    return (JaxSpec(schedule=jschedules.build_schedule(n_steps=n_steps,
                                                       **LINEAR), **kw),
            ChainSpec(schedule=schedules.build_schedule(n_steps=n_steps,
                                                        **LINEAR), **kw))


@pytest.fixture
def patch_hold(monkeypatch):
    """Set both packages' hold; clear JAX's compiled segments around it."""
    def patch(h):
        jax.clear_caches()
        monkeypatch.setattr(jf3s, "_HOLD", h)
        monkeypatch.setattr(full3d_shared, "_HOLD", h)

    yield patch
    jax.clear_caches()


# 100 bins: 11 steps a bin, fewer than the JAX kernel's 32-step groups, its
# exact-bin path; 10 bins: 110 steps a bin, its split path.
@pytest.mark.parametrize("n_bins", [100, 10])
@pytest.mark.parametrize("hold", [16, 32])
def test_twin_equals_jax_at_long_holds(patch_hold, hold, n_bins):
    jspec, spec = _specs(n_bins)
    patch_hold(hold)
    with pltpu.force_tpu_interpret_mode():
        want = jrunner.run_chains(SEEDS, jspec)
    got = runner.run_chains(SEEDS, spec, device="cpu")
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # every active step of every chain counted
    assert (got.total_bins.sum(axis=1) == spec.n_steps).all()


def test_holds_change_the_trajectory(patch_hold):
    """The hold is not ignored: another hold draws other movers."""
    _, spec = _specs(100)
    finals = []
    for h in (8, 16, 32):
        patch_hold(h)
        finals.append(runner.run_chains(SEEDS, spec,
                                        device="cpu").final_state)
    assert not np.array_equal(finals[0], finals[1])
    assert not np.array_equal(finals[1], finals[2])


@pytest.mark.parametrize("hold,n_inner,match", [
    (16, 44, "at least 1024"), (32, 1023, "at least 1024"),
    (12, 1024, "must be one of"), (4, 1024, "must be one of")])
def test_refused_holds(patch_hold, hold, n_inner, match):
    """A hold outside (8, 16, 32), and a hold above 8 on a launch of fewer
    than 1024 steps, raise in the twin and in the launcher alike (before
    any kernel library is touched)."""
    _, spec = _specs(100, n_steps=4096, stride=n_inner)
    patch_hold(hold)
    carry = full3d_shared.init_carry_batch(SEEDS, spec, device="cpu")
    st = full3d_shared.segment_state(carry)
    beta = chunk_betas(spec.schedule, 0, n_inner, "cpu")
    with pytest.raises(ValueError, match=match):
        full3d_shared.segment_reference(st, 0, n_inner, spec, beta)
    with pytest.raises(ValueError, match=match):
        full3d_shared.launch_segment(None, st, 0, n_inner, spec, beta,
                                     n_sm=2)
    with pytest.raises(ValueError, match=match):
        full3d_shared.run_segment(carry, 0, spec, 1)


def test_hold_8_takes_short_launches(patch_hold):
    """Hold 8, the default, takes any launch length."""
    patch_hold(8)
    assert full3d_shared.hold(1) == 8
    patch_hold(16)
    assert full3d_shared.hold(1024) == 16
