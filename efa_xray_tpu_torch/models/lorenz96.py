"""Lorenz-96 toy dynamical model for cycling-DA integration tests.

Counterpart of ``efa_xray_tpu/models/lorenz96.py``: ``tendency`` :20,
``integrate`` :28 (RK4, here a Python loop over steps where the JAX
package scans), ``spinup_ensemble`` :45 and ``fake_latlon`` :61.  The
random draws of ``spinup_ensemble`` come from an explicit
``torch.Generator``; JAX's PRNG is not reproduced, so parity with the JAX
package means the same trajectory from the same initial arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from efa_xray_tpu_torch.state.ensemble import default_device


def tendency(x, forcing: float = 8.0):
    """dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F (cyclic)."""
    return ((torch.roll(x, -1, dims=-1) - torch.roll(x, 2, dims=-1))
            * torch.roll(x, 1, dims=-1) - x + forcing)


def integrate(x0, dt: float = 0.05, nsteps: int = 1, forcing: float = 8.0):
    """RK4 for ``nsteps`` steps; members as leading axes broadcast
    elementwise."""
    x = x0
    for _ in range(nsteps):
        k1 = tendency(x, forcing)
        k2 = tendency(x + 0.5 * dt * k1, forcing)
        k3 = tendency(x + 0.5 * dt * k2, forcing)
        k4 = tendency(x + dt * k3, forcing)
        x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def spinup_ensemble(nvars: int = 40, nmems: int = 20, seed: int = 0,
                    dt: float = 0.05, spinup_steps: int = 400,
                    forcing: float = 8.0,
                    generator: Optional[torch.Generator] = None,
                    device=None, dtype=torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(truth [nvars], ensemble [nmems, nvars])`` on the attractor, on
    ``device`` (the card unless given).  Draws from ``generator``, or from
    a new one seeded with ``seed``."""
    device = default_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=generator,
                                       device=device, dtype=dtype)
    truth = forcing + 0.5 * randn(nvars)
    truth = integrate(truth, dt=dt, nsteps=spinup_steps, forcing=forcing)
    ens = truth[None, :] + 1.0 * randn(nmems, nvars)
    ens = integrate(ens, dt=dt, nsteps=spinup_steps // 4, forcing=forcing)
    return truth, ens


def fake_latlon(nvars: int) -> Tuple[np.ndarray, np.ndarray]:
    """The cyclic L96 variables evenly around the equator, so that the
    great-circle machinery (localization, nearest points) applies."""
    lons = np.linspace(0.0, 360.0, nvars, endpoint=False)
    lats = np.zeros(nvars)
    return lats, lons
