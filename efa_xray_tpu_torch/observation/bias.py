"""Per-obtype observation bias estimation and correction.

Copy of ``efa_xray_tpu/observation/bias.py`` (``BiasCorrection`` :42): a
host-side NumPy estimator with a JSON state, which touches no tensor.  For
each observation type it keeps an exponential moving average of the mean
prior innovation ``d = y - H(x_b)`` over assimilable, QC-passing obs;
:meth:`BiasCorrection.correct` subtracts the current estimate from the ob
values before assimilation.  The per-row variant is the cycling
harness's ``adaptive_bias`` (``models/cycling.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np


@dataclasses.dataclass
class BiasCorrection:
    """Cycle-persistent per-obtype innovation-bias estimator.

    Parameters
    ----------
    alpha:
        EMA learning rate per update in (0, 1].  ``alpha=1`` trusts the
        latest cycle's mean innovation outright; small values average over
        ~1/alpha cycles (operational practice: slow adaptation so weather
        signal does not alias into the bias estimate).
    min_count:
        Minimum number of usable obs of a type in one update before that
        cycle's sample moves the estimate (noisy one-ob "means" are
        skipped).
    biases / counts:
        Current estimates (mapping obtype -> bias in ob units) and total
        obs counts that produced them.  Usually left to default and filled
        by :meth:`update`.
    """

    alpha: float = 0.2
    min_count: int = 2
    biases: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if self.min_count < 1:
            raise ValueError("min_count must be >= 1")

    # ------------------------------------------------------------------
    # estimation
    def update(self, batch) -> Dict[str, float]:
        """Learn from one assimilation's prior diagnostics.

        ``batch`` must carry ``prior_mean`` (the filter records it for
        every ob, assimilated or not, matching the reference's per-ob
        slots ``efa_xray/assimilation/ensrf.py:66-70``).  Prefer the
        FORECAST-prior estimate (``Assimilation.compute_ob_priors`` before
        the update) — the operational O-B convention; the serial EnSRF's
        recorded diagnostics are *sequential* per-ob priors, whose later
        innovations are already shrunk by earlier (biased) obs and so
        underestimate a constant bias.  Obs that were not flagged for
        assimilation, were QC-rejected as innovation outliers, or have
        non-finite innovations are excluded.
        Returns the per-obtype mean innovations of THIS update (before
        smoothing) for diagnostics.
        """
        if batch.prior_mean is None:
            raise ValueError(
                "batch has no prior_mean diagnostics; run the filter (or "
                "compute_ob_priors) before BiasCorrection.update"
            )
        innov = np.asarray(batch.values, dtype=np.float64) - np.asarray(
            batch.prior_mean, dtype=np.float64
        )
        usable = np.asarray(batch.assimilate_flags, dtype=bool) & np.isfinite(innov)
        if batch.qc_outlier is not None:
            usable &= ~np.asarray(batch.qc_outlier, dtype=bool)

        sample_means: Dict[str, float] = {}
        obtypes = np.asarray(batch.obtypes, dtype=object)
        for obtype in dict.fromkeys(batch.obtypes):  # stable unique order
            sel = usable & (obtypes == obtype)
            n = int(sel.sum())
            if n < self.min_count:
                continue
            mean_d = float(innov[sel].mean())
            sample_means[obtype] = mean_d
            prev = self.biases.get(obtype, 0.0)
            # First sighting of a type starts at the sample mean rather
            # than EMA-ing from the arbitrary 0 prior.
            if obtype not in self.counts:
                self.biases[obtype] = mean_d
            else:
                self.biases[obtype] = (1.0 - self.alpha) * prev + self.alpha * mean_d
            self.counts[obtype] = self.counts.get(obtype, 0) + n
        return sample_means

    # ------------------------------------------------------------------
    # application
    def correct(self, batch):
        """Return a copy of ``batch`` with the current bias estimate
        subtracted from the values (types without an estimate unchanged).
        The input batch is not modified."""
        offsets = np.asarray(
            [self.biases.get(t, 0.0) for t in batch.obtypes], dtype=np.float64
        )
        return dataclasses.replace(
            batch, values=np.asarray(batch.values, dtype=np.float64) - offsets
        )

    def offset_for(self, obtype: str) -> float:
        """Current bias estimate for one type (0 when unknown)."""
        return float(self.biases.get(obtype, 0.0))

    # ------------------------------------------------------------------
    # persistence (cycling resume)
    def to_dict(self) -> dict:
        return {
            "alpha": self.alpha,
            "min_count": self.min_count,
            "biases": dict(self.biases),
            "counts": {k: int(v) for k, v in self.counts.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BiasCorrection":
        return cls(
            alpha=float(d.get("alpha", 0.2)),
            min_count=int(d.get("min_count", 2)),
            biases={str(k): float(v) for k, v in d.get("biases", {}).items()},
            counts={str(k): int(v) for k, v in d.get("counts", {}).items()},
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "BiasCorrection":
        with open(path) as f:
            return cls.from_dict(json.load(f))
