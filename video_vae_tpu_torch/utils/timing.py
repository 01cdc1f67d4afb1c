"""The slope timer: per-step time from two chain lengths, robust to a bad repeat.

Counterpart of the JAX package's ``utils/timing.py``. A timed chain of ``k``
steps costs ``c + k · per_step``, where ``c`` (launch, synchronisation,
clock reads) does not depend on ``k``; the per-step time is the slope
between two chain lengths, (t_long − t_short) / (k_long − k_short). The
estimate is taken from the medians of the raw short and long timings over
at least 5 repeats, so that one anomalous repeat on either side of the
subtraction does not set it; the per-repeat slopes and their spread are
kept as evidence, and repeats whose raw timings disagree with the rest are
flagged.

On a CUDA card a timed chain must end in ``torch.cuda.synchronize()`` (or a
wait on a recorded event) before it reads the clock: kernels launch
asynchronously, so a chain timed without it measures the host's enqueueing.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class SlopeEstimate:
    """Per-step time estimate plus the evidence behind it."""

    per_step: float  # robust estimate: slope of median timings (seconds/step)
    slopes: List[float]  # per-repeat slopes, for spread inspection
    t_shorts: List[float]
    t_longs: List[float]
    outliers: List[int] = field(default_factory=list)  # repeat indices flagged

    @property
    def spread(self) -> float:
        """Max - min of the per-repeat slopes (seconds/step)."""
        return max(self.slopes) - min(self.slopes) if self.slopes else 0.0

    def summary(self) -> str:
        parts = [
            f"per-step {self.per_step * 1e3:.2f} ms (median of {len(self.slopes)} repeats)",
            f"slopes {[round(s * 1e3, 2) for s in self.slopes]} ms",
            f"spread {self.spread * 1e3:.2f} ms",
        ]
        if self.outliers:
            parts.append(f"inconsistent repeats discarded: {self.outliers}")
        return ", ".join(parts)


def robust_slope(
    time_short: Callable[[], float],
    time_long: Callable[[], float],
    k_short: int,
    k_long: int,
    repeats: int = 5,
) -> SlopeEstimate:
    """Run >=5 (t_short, t_long) repeats and return the median-based slope.

    ``time_short`` / ``time_long`` execute one timed chain of the respective
    length and return wall seconds. Repeats whose raw timing deviates from the
    across-repeat median by more than max(20%, 3x the median absolute
    deviation) on either chain length are excluded from the estimate (but kept
    in the record for the printed evidence); if fewer than 3 repeats would be
    left, all are kept.
    """
    repeats = max(repeats, 5)
    t_shorts = []
    t_longs = []
    for _ in range(repeats):
        t_shorts.append(time_short())
        t_longs.append(time_long())

    def flag(xs: List[float]) -> set:
        med = statistics.median(xs)
        mad = statistics.median([abs(x - med) for x in xs])
        tol = max(0.2 * med, 3.0 * mad)
        return {i for i, x in enumerate(xs) if abs(x - med) > tol}

    bad = sorted(flag(t_shorts) | flag(t_longs))
    keep = [i for i in range(repeats) if i not in bad]
    if len(keep) < 3:  # too aggressive: fall back to using everything
        keep, bad = list(range(repeats)), []

    denom = k_long - k_short
    slopes = [(t_longs[i] - t_shorts[i]) / denom for i in range(repeats)]
    per_step = (
        statistics.median([t_longs[i] for i in keep]) - statistics.median([t_shorts[i] for i in keep])
    ) / denom
    return SlopeEstimate(
        per_step=per_step,
        slopes=slopes,
        t_shorts=t_shorts,
        t_longs=t_longs,
        outliers=bad,
    )
