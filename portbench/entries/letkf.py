"""Entry ``letkf``: the LETKF's route, ``letkf_core.letkf_update(...)``,
over a flat state (rows with coordinates): what ``LETKF.update()``,
``CyclingHarness(solver="letkf")`` and every shard of
``letkf_update_sharded`` call.

Its keywords come from the ``FilterConfig`` exactly as ``LETKF.update``
builds them (``ngrid``, ``patch_size``, ``k_obs``, ``localize``,
``sqrt_method``, ``ns_iters``, ``chunk``, ``topk_method``, ``unbiased``,
``solve_precision``; horizontal localization, no varloc).  Each update
takes the obs priors as the state at the obs' rows (a flat state's
nearest-point operator) and the update's obs values.  The route writes
its posterior into tensors of its own and never into the prior, so no
copy restores the prior between updates.  The update's answer: the
posterior of the sampled rows, the obs' posterior and the per-ob
diagnostics.

The cell's control (``cells/letkf-c7.json``) names, under
``reference_products``, a precision below the configuration's float32
(``"tf32"``, ``"bf16"``): the plain reference computed in it then takes
the program's place (``update`` issues nothing, ``answer`` is the
reference's at that precision), since the route has no precision below
float32 to switch on.
"""

from __future__ import annotations

import torch

from efa_xray_tpu_torch.assimilation import letkf_core
from efa_xray_tpu_torch.assimilation.ensrf_core import ObsArrays
from efa_xray_tpu_torch.config import FilterConfig
from portbench import spec

F32 = torch.float32


# The control's field: the precision of the reference in the program's
# place.
REFERENCE_PRODUCTS = "reference_products"


class Entry:
    def __init__(self, inputs, fields: dict, device):
        fields = dict(fields)
        self.products = fields.pop(REFERENCE_PRODUCTS, None)
        if self.products is not None:
            self.inputs = inputs
            self.reference = spec.load_module("reference",
                                              inputs.config["reference"])
            if self.products not in self.reference.PRODUCTS[1:]:
                raise ValueError(f"{REFERENCE_PRODUCTS} {self.products!r} "
                                 f"is not one of "
                                 f"{self.reference.PRODUCTS[1:]}")
            return
        cfg = FilterConfig(**fields)
        # The reference analyses the configuration's patches, neighbour
        # count and variance convention: the filter's must be those.
        want = dict(letkf_patch_size=inputs.config["letkf_patch_size"],
                    letkf_k_obs=inputs.config["letkf_k_obs"],
                    unbiased_variance=inputs.config.get("unbiased_variance",
                                                        False))
        for key, value in want.items():
            if getattr(cfg, key) != value:
                raise ValueError(f"{key} {getattr(cfg, key)!r} is not the "
                                 f"configuration's {value!r}")
        self.kw = dict(ngrid=inputs.nstate, patch_size=cfg.letkf_patch_size,
                       k_obs=cfg.letkf_k_obs, localize=cfg.localize,
                       sqrt_method=cfg.letkf_sqrt,
                       ns_iters=cfg.letkf_ns_iters, chunk=cfg.letkf_chunk,
                       topk_method=cfg.letkf_topk,
                       unbiased=cfg.unbiased_variance,
                       solve_precision=cfg.letkf_solve_precision)
        self.bm, self.bp = inputs.prior()
        self.lat, self.lon = inputs.row_lat, inputs.row_lon
        self.rows = inputs.ob_rows
        self.values = inputs.values.to(F32)
        self.obs = ObsArrays(
            values=self.values[0], errors=inputs.errors.to(F32),
            lats=inputs.ob_lat.to(F32), lons=inputs.ob_lon.to(F32),
            radii=inputs.radii.to(F32),
            assim=torch.ones(inputs.nobs, dtype=torch.bool, device=device))

    def update(self, k: int):
        if self.products is not None:
            return k
        obs = self.obs._replace(values=self.values[k % len(self.values)])
        return letkf_core.letkf_update(
            self.bm, self.bp, self.bm[self.rows], self.bp[self.rows],
            self.lat, self.lon, obs, **self.kw)

    def answer(self, out, sample) -> dict:
        if self.products is not None:
            return self.reference.expected(self.inputs, out, sample,
                                           products=self.products)
        bm, bp, tm, tp, diags = out
        return dict(state_mean=bm[sample], state_perts=bp[sample],
                    obs_mean=tm.clone(), obs_perts=tp.clone(),
                    **{k: v.clone() for k, v in diags._asdict().items()})

    def close(self):
        self.__dict__.clear()
