"""Entry ``api``: the public ``EnSRF(state, batch, config=...,
device=...).update()`` on a gridded ``EnsembleState``: the path of every
``EnSRF.update()`` a user calls, the CLI's ``assimilate`` and each
``CyclingHarness`` analysis.

Set-up builds the state once from the prior drawn on the card and an
``ObservationBatch`` of the network; each update is a new filter on a
copy of that batch with the update's values (a user's next cycle with
the same stations), so the forward-operator taps come from the
program's cache after the warm-up.  The update's answer: the posterior
of the sampled grid points (mean over members and perturbations) and
the per-ob diagnostics that ``update()`` returns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from efa_xray_tpu_torch.assimilation.ensrf import EnSRF
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.utils import timeutil

F64 = torch.float64


class Entry:
    def __init__(self, inputs, fields: dict, device):
        cfg = inputs.config
        self.device = torch.device(device)
        self.config = FilterConfig(**fields)
        lat1d, lon1d = inputs.grid
        lon, lat = np.meshgrid(lon1d, lat1d)
        times = np.array([np.datetime64(cfg["time"])])
        self.nmems = inputs.nmems
        self.state = EnsembleState.from_vardict(
            {cfg["var"]: inputs.prior()},
            {"validtime": times, "lat": lat, "lon": lon,
             "mem": np.arange(inputs.nmems)}, device=self.device)
        no = inputs.nobs
        self.values = inputs.values.cpu().numpy()
        self.template = ObservationBatch(
            values=self.values[0], errors=inputs.errors.cpu().numpy(),
            lats=inputs.ob_lat.cpu().numpy(),
            lons=inputs.ob_lon.cpu().numpy(),
            times_s=timeutil.to_epoch_seconds(np.repeat(times, no)),
            obtypes=[cfg["var"]] * no,
            localize_radius=inputs.radii.cpu().numpy(),
            assimilate_flags=np.ones(no, dtype=bool),
            verts=np.full(no, np.nan), descriptions=[None] * no)

    def update(self, k: int):
        batch = dataclasses.replace(
            self.template, values=self.values[k % len(self.values)])
        return EnSRF(self.state, batch, config=self.config,
                     device=self.device, verbose=False).update()

    def answer(self, out, sample) -> dict:
        post, obs = out
        x = post.data.reshape(-1, self.nmems)[sample].to(F64)
        mean = x.mean(1)
        diag = {k: torch.as_tensor(getattr(obs, k))
                for k in ("prior_mean", "prior_var", "post_mean",
                          "post_var", "assimilated")}
        return dict(state_mean=mean, state_perts=x - mean[:, None], **diag)

    def close(self):
        self.__dict__.clear()
