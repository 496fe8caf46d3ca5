"""The one traffic generator: a closed loop of design sweeps.

A mix file (traffic/<mix>.json) gives the members of a sweep, the band of
inlet temperatures around the configuration's base, how many members of
each sweep the integrator records in full for the check, and the
lockstep's options. Each sweep draws fresh inlet temperatures
T0 = base + U(-band, band) per member, rounded to float32 so that the
program and the reference integrate the same numbers, and a fresh sample
of members to record. The same seed gives the same sweeps.
"""

from __future__ import annotations

import numpy as np


def rng(seed, stream=0):
    """A NumPy generator for one stream of a run's seed (any whole
    number; the streams of one seed are independent)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


class Sweeps:
    """Sweep after sweep of one cell: next() gives (T0 (B,) float64,
    recorded member indices (P,) sorted)."""

    def __init__(self, seed, mix, config, stream=0):
        self.members = int(mix["members"])
        self.recorded = min(int(mix["recorded_per_sweep"]), self.members)
        self.base = float(config["t_base_K"])
        self.band = float(mix["t0_band_K"])
        self.rng = rng(seed, stream)

    def next(self):
        u = self.rng.random(self.members)
        t0 = (self.base + self.band * (2.0 * u - 1.0)).astype(np.float32)
        idx = np.sort(self.rng.choice(self.members, size=self.recorded,
                                      replace=False))
        return t0.astype(np.float64), idx
