"""The traffic generator: a cell's inputs, drawn from ``--seed``.

It reads a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``).  The state and the obs network come from
the generator of the configuration's ``kind``,
``portbench/generators/<kind>.py``, found by name; the obs values, one
set of ``value_sets`` for each update of the window (reused in turn past
that many updates), are drawn here for every kind.  Everything is drawn
on the device, in a few large calls.

Each quantity has a generator of its own, seeded from ``--seed`` and the
quantity's name, so the same seed gives the same inputs and any quantity
can be drawn again alone (the reference draws the prior again after the
window instead of keeping a copy).

A key that selects what is drawn is acted on or refused: each generator
lists under ``CHOICES`` the values it implements of the configuration's
selectors, and the configuration's ``localization`` and ``dtype`` must be
those of the traffic's filter.  A later deployment that needs another
value adds a generator of its own kind.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

F32 = torch.float32
F64 = torch.float64
# The obs network of every update; the only one implemented.
NETWORKS = ("fixed",)


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for quantity ``name`` of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), zlib.crc32(
        name.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def gen(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, name))


def stratified(count: int, lo: float, hi: float, g, device):
    """One uniform draw in each of ``count`` equal bands of [lo, hi)."""
    u = torch.rand(count, generator=g, device=device, dtype=F64)
    return lo + (hi - lo) * (torch.arange(count, device=device,
                                          dtype=F64) + u) / count


@dataclasses.dataclass
class Inputs:
    """What one run hands to the program and to the reference."""

    config: dict
    seed: int
    device: torch.device
    nstate: int
    nmems: int
    nobs: int
    row_lat: torch.Tensor  # [N] float32, the state rows' coordinates
    row_lon: torch.Tensor
    ob_lat: torch.Tensor  # [No] float64
    ob_lon: torch.Tensor
    errors: torch.Tensor  # [No] float64, error variance
    radii: torch.Tensor  # [No] float64, Gaspari-Cohn halfwidth, km
    values: torch.Tensor  # [value_sets, No] float64
    ob_rows: torch.Tensor | None = None  # [No] int64: obs at state rows
    grid: tuple | None = None  # (lat1d, lon1d) float64 NumPy axes

    def prior(self):
        """The prior, drawn again from the seed: ``field [1, ny, nx, M]``
        for a grid, ``(bm [N], bp [N, M])`` for rows."""
        return generator(self.config).prior(self.config, self.seed,
                                            self.device)

    def value_set(self, k: int) -> torch.Tensor:
        return self.values[k % self.values.shape[0]]


def generator(config: dict):
    from portbench import spec

    return spec.load_module("generators", config["kind"])


def _lookup(d: dict, dotted: str):
    for part in dotted.split("."):
        d = d[part]
    return d


def check_keys(config: dict, traffic: dict, choices: dict) -> None:
    """Refuse a configuration or traffic mix whose selectors ask for
    what is not implemented."""
    wants = {f"config {k}": (_lookup(config, k), v)
             for k, v in choices.items()}
    wants["traffic network"] = (traffic["network"], NETWORKS)
    for key in ("localization", "dtype"):
        wants[f"config {key}"] = (config[key], (traffic["filter"][key],))
    for name, (value, allowed) in wants.items():
        if value not in allowed:
            raise ValueError(f"{name} {value!r} is not implemented here "
                             f"(implemented: {list(allowed)})")


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    device = torch.device(device)
    kind = generator(config)
    check_keys(config, traffic, kind.CHOICES)
    fields = kind.make(config, seed, device)
    nobs = int(config["obs"]["count"])
    vals = traffic["obs_values"]
    gv = gen(seed, "values", device)
    values = vals["mean"] + vals["sd"] * torch.randn(
        int(traffic["value_sets"]), nobs, generator=gv, device=device,
        dtype=F64)
    if vals.get("dtype") == "float32":
        # An entry that takes float32 values gets exactly these.
        values = values.to(F32).to(F64)
    ob = config["obs"]
    return Inputs(
        config=config, seed=seed, device=device, nmems=int(config["nmems"]),
        nobs=nobs, values=values,
        errors=torch.full((nobs,), float(ob["error_var"]), dtype=F64,
                          device=device),
        radii=torch.full((nobs,), float(ob["radius_km"]), dtype=F64,
                         device=device), **fields)
