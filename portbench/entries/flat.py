"""Entry ``flat``: the array-level route that ``CyclingHarness`` and each
mesh shard take, ``FlatRoute(config, device, max_radius_km).solve(...)``,
over a flat state (rows with coordinates).

Each update restores the prior into the working buffers by a device copy
(the body kernels update them in place), takes the obs priors as the
state at the obs' rows (a flat state's nearest-point operator) and solves
the tail and the body.  The update's answer: the posterior of the
sampled rows, the obs' posterior and the per-ob diagnostics.
"""

from __future__ import annotations

import torch

from efa_xray_tpu_torch.assimilation.ensrf import FlatRoute
from efa_xray_tpu_torch.assimilation.ensrf_core import ObsArrays
from efa_xray_tpu_torch.config import FilterConfig

F32 = torch.float32


class Entry:
    def __init__(self, inputs, fields: dict, device):
        self.route = FlatRoute(FilterConfig(**fields), device,
                               max_radius_km=float(
                                   inputs.config["obs"]["radius_km"]))
        self.bm0, self.bp0 = inputs.prior()
        self.bm = torch.empty_like(self.bm0)
        self.bp = torch.empty_like(self.bp0)
        self.lat, self.lon = inputs.row_lat, inputs.row_lon
        self.rows = inputs.ob_rows
        self.values = inputs.values.to(F32)
        self.obs = ObsArrays(
            values=self.values[0], errors=inputs.errors.to(F32),
            lats=inputs.ob_lat.to(F32), lons=inputs.ob_lon.to(F32),
            radii=inputs.radii.to(F32),
            assim=torch.ones(inputs.nobs, dtype=torch.bool, device=device))

    def update(self, k: int):
        self.bm.copy_(self.bm0)
        self.bp.copy_(self.bp0)
        obs = self.obs._replace(values=self.values[k % len(self.values)])
        return self.route.solve(self.bm, self.bp, self.bm[self.rows],
                                self.bp[self.rows], self.lat, self.lon, obs)

    @staticmethod
    def answer(out, sample) -> dict:
        bm, bp, tm, tp, diags = out
        return dict(state_mean=bm[sample], state_perts=bp[sample],
                    obs_mean=tm.clone(), obs_perts=tp.clone(),
                    **{k: v.clone() for k, v in diags._asdict().items()})

    def close(self):
        self.__dict__.clear()
