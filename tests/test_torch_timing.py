"""The port's slope timer (``utils/timing.py``) against the JAX package's.

The four cases of ``tests/test_timing.py`` run through both modules, and a
property holds the two estimators equal field for field on random timing
lists with spikes.
"""

from __future__ import annotations

import dataclasses

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from video_vae_tpu.utils import timing as jax_timing
from video_vae_tpu_torch.utils import timing as port_timing

MODULES = pytest.mark.parametrize("timing", [jax_timing, port_timing], ids=["jax", "port"])


def _feeder(values):
    it = iter(values)
    return lambda: next(it)


@MODULES
def test_clean_slopes_recovered_exactly(timing):
    est = timing.robust_slope(_feeder([2.05] * 5), _feeder([2.55] * 5), 1, 11, repeats=5)
    assert abs(est.per_step - 0.05) < 1e-12
    assert est.outliers == []
    assert est.spread < 1e-12


@MODULES
def test_single_hiccup_does_not_set_the_estimate(timing):
    shorts = [2.05, 2.05, 3.55, 2.05, 2.05]
    est = timing.robust_slope(_feeder(shorts), _feeder([2.55] * 5), 1, 11, repeats=5)
    assert abs(est.per_step - 0.05) < 1e-12
    assert est.outliers == [2]
    assert min(est.slopes) < 0  # a min-of-slopes estimator would have recorded this


@MODULES
def test_repeats_floor_is_five(timing):
    est = timing.robust_slope(_feeder([1.0] * 5), _feeder([1.5] * 5), 1, 11, repeats=2)
    assert len(est.slopes) == 5


@MODULES
def test_all_noisy_falls_back_to_full_set(timing):
    shorts = [1.0, 5.0, 9.0, 2.0, 7.0]
    longs = [11.0, 3.0, 14.0, 8.0, 2.0]
    est = timing.robust_slope(_feeder(shorts), _feeder(longs), 1, 11, repeats=5)
    assert est.outliers == []
    assert est.per_step == (8.0 - 5.0) / 10.0  # medians: 8.0 and 5.0


@st.composite
def timings(draw):
    """(repeats, shorts, longs, k pair): steady chains with a few spikes."""
    repeats = draw(st.integers(5, 9))
    k_short, k_long = draw(st.sampled_from([(1, 11), (2, 6)]))
    base = draw(st.floats(1e-3, 5.0))
    step = draw(st.floats(1e-4, 0.5))

    def chain(k):
        noise = st.floats(-0.05, 0.05)
        spike = st.one_of(st.just(0.0), st.just(0.0), st.floats(0.5, 20.0))
        return [(base + k * step) * (1 + draw(noise)) + draw(spike) for _ in range(repeats)]

    return repeats, chain(k_short), chain(k_long), k_short, k_long


@settings(max_examples=200, deadline=None)
@given(timings())
def test_port_estimate_equals_jax(case):
    repeats, shorts, longs, k_short, k_long = case
    jax_est = jax_timing.robust_slope(_feeder(shorts), _feeder(longs), k_short, k_long, repeats=repeats)
    port_est = port_timing.robust_slope(_feeder(shorts), _feeder(longs), k_short, k_long, repeats=repeats)
    assert dataclasses.asdict(port_est) == dataclasses.asdict(jax_est)
    assert port_est.spread == jax_est.spread
    assert port_est.summary() == jax_est.summary()
