"""Two-dimensional Lorenz-96 on a lat-lon grid, the gridded cycling testbed.

Counterpart of ``efa_xray_tpu/models/l96_2d.py``: ``tendency`` :38,
``integrate`` :50 (RK4, here a Python loop over steps), ``spinup_ensemble``
:68, ``grid_latlon`` :93 and ``make_flat_forecast`` :106.  Each latitude
row runs the classic zonal L96 dynamics, coupled across rows by meridional
diffusion ``kappa (X[j+1] - 2 X[j] + X[j-1])`` with insulated north and
south edges.  The random draws of ``spinup_ensemble`` come from an
explicit ``torch.Generator``; JAX's PRNG is not reproduced, so parity with
the JAX package means the same trajectory from the same initial arrays.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from efa_xray_tpu_torch.state.ensemble import default_device


def tendency(x, forcing: float = 8.0, kappa: float = 1.0):
    """dX/dt on a ``[..., ny, nx]`` state: per-row zonal L96 plus
    meridional diffusion (Neumann edges)."""
    zonal = ((torch.roll(x, -1, dims=-1) - torch.roll(x, 2, dims=-1))
             * torch.roll(x, 1, dims=-1) - x + forcing)
    up = torch.cat([x[..., 1:2, :], x[..., :-1, :]], dim=-2)
    down = torch.cat([x[..., 1:, :], x[..., -2:-1, :]], dim=-2)
    return zonal + kappa * (up - 2.0 * x + down)


def integrate(x0, dt: float = 0.05, nsteps: int = 1, forcing: float = 8.0,
              kappa: float = 1.0):
    """RK4 for ``nsteps`` steps on ``[..., ny, nx]`` states (members as
    leading axes broadcast elementwise)."""
    x = x0
    for _ in range(nsteps):
        k1 = tendency(x, forcing, kappa)
        k2 = tendency(x + 0.5 * dt * k1, forcing, kappa)
        k3 = tendency(x + 0.5 * dt * k2, forcing, kappa)
        k4 = tendency(x + dt * k3, forcing, kappa)
        x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def spinup_ensemble(ny: int = 8, nx: int = 32, nmems: int = 20,
                    seed: int = 0, dt: float = 0.05,
                    spinup_steps: int = 400, forcing: float = 8.0,
                    kappa: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    device=None, dtype=torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(truth [ny, nx], ensemble [nmems, ny, nx])`` on the attractor, on
    ``device`` (the card unless given).  Draws from ``generator``, or from
    a new one seeded with ``seed``."""
    device = default_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=generator,
                                       device=device, dtype=dtype)
    truth = forcing + 0.5 * randn(ny, nx)
    truth = integrate(truth, dt=dt, nsteps=spinup_steps, forcing=forcing,
                      kappa=kappa)
    ens = truth[None] + 1.0 * randn(nmems, ny, nx)
    ens = integrate(ens, dt=dt, nsteps=spinup_steps // 4, forcing=forcing,
                    kappa=kappa)
    return truth, ens


def grid_latlon(ny: int, nx: int, lat_max: float = 60.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """2-D ``(lat, lon)`` arrays ``[ny, nx]`` for the model grid: ``ny``
    latitudes in ``[-lat_max, lat_max]`` (no pole rows), periodic
    longitudes."""
    lat1 = np.linspace(-lat_max, lat_max, ny)
    lon1 = np.arange(nx) * (360.0 / nx)
    lon, lat = np.meshgrid(lon1, lat1)
    return lat, lon


def make_flat_forecast(ny: int, nx: int, dt: float = 0.05, nsteps: int = 4,
                       forcing: float = 8.0, kappa: float = 1.0) -> Callable:
    """Forecast callable on flat states (``[nvars]`` truth or ``[nmems,
    nvars]`` ensembles, ``nvars = ny * nx`` in C order)."""

    def forecast(flat):
        grid = flat.reshape(flat.shape[:-1] + (ny, nx))
        out = integrate(grid, dt=dt, nsteps=nsteps, forcing=forcing,
                        kappa=kappa)
        return out.reshape(flat.shape)

    return forecast
