"""Rotating shallow-water model on a beta-plane channel (eta, u, v).

Counterpart of ``efa_xray_tpu/models/swe.py``: ``SWEParams`` :52,
``jet_profile`` :69, the centred differences :87-108, ``tendency`` :111,
``integrate`` :154 (RK4, here a Python loop over steps where the JAX
package scans), ``initial_state`` :177, ``spinup_ensemble`` :192 and the
flat-state adapters ``pack`` :228, ``unpack`` :236, ``grid_latlon`` :247,
``var_rows`` :262 and ``make_flat_forecast`` :269 for
:class:`~efa_xray_tpu_torch.models.cycling.CyclingHarness`.

The model is the JAX package's: the vector-invariant nonlinear
shallow-water equations on a collocated grid, periodic in x with free-slip
walls in y, relaxed toward a barotropically unstable balanced jet, with
del^4 hyperdiffusion; nondimensional units (dx = dy = 1, g = 1, H0 = 10).
States are dicts of tensors ``[..., ny, nx]``; member axes lead and
broadcast.  Parity with the JAX package means the same trajectory from
the same initial arrays: ``initial_state`` draws its noise from NumPy's
``default_rng`` as the JAX package does, and ``spinup_ensemble`` its
member perturbations from an explicit ``torch.Generator``.

Each RK4 step is four tendencies of dozens of small torch operations, so
a spin-up of thousands of steps is bound by kernel launches on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from efa_xray_tpu_torch.state.ensemble import _torch_dtype, default_device


class SWEParams(NamedTuple):
    """Physical and numerical configuration."""

    g: float = 1.0
    h0: float = 10.0
    f0: float = 0.5
    beta: float = 3e-3
    u0: float = 2.0      # jet maximum
    sigma: float = 2.0   # jet half-width (grid units)
    tau: float = 200.0   # relaxation timescale toward the jet
    nu4: float = 3e-2    # hyperdiffusion coefficient
    dt: float = 0.05


DEFAULT = SWEParams()
VAR_ORDER = ("eta", "u", "v")


def jet_profile(ny: int, p: SWEParams = DEFAULT
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Balanced jet ``(u_jet [ny], eta_jet [ny], f [ny])`` (NumPy float64):
    eta_jet integrates ``g d(eta)/dy = -f u_jet`` by the trapezoid rule and
    is centred to zero mean."""
    y = np.arange(ny, dtype=np.float64)
    yc = 0.5 * (ny - 1)
    f = p.f0 + p.beta * (y - yc)
    u = p.u0 / np.cosh((y - yc) / p.sigma) ** 2
    deta = -f * u / p.g
    eta = np.concatenate([[0.0], np.cumsum(0.5 * (deta[1:] + deta[:-1]))])
    eta -= eta.mean()
    return u, eta, f


def _pad_y(a, parity: int):
    """One ghost row on each wall (axis -2): parity +1 reflects, -1
    antireflects."""
    return torch.cat([parity * a[..., 1:2, :], a, parity * a[..., -2:-1, :]],
                     dim=-2)


def _ddx(a):
    return 0.5 * (torch.roll(a, -1, dims=-1) - torch.roll(a, 1, dims=-1))


def _ddy(a, parity: int):
    p = _pad_y(a, parity)
    return 0.5 * (p[..., 2:, :] - p[..., :-2, :])


def _lap(a, parity: int):
    p = _pad_y(a, parity)
    ddy = p[..., 2:, :] - 2.0 * a + p[..., :-2, :]
    ddx = torch.roll(a, -1, dims=-1) - 2.0 * a + torch.roll(a, 1, dims=-1)
    return ddx + ddy


def _jet_tensors(ny: int, p: SWEParams, like: torch.Tensor):
    u_jet, eta_jet, f = jet_profile(ny, p)
    t = lambda x: torch.as_tensor(x, dtype=like.dtype,
                                  device=like.device)[:, None]
    return t(f), t(u_jet), t(eta_jet)


def tendency(state: Dict[str, torch.Tensor], ny: int,
             p: SWEParams = DEFAULT, jet=None) -> Dict[str, torch.Tensor]:
    """d(state)/dt for ``{"eta", "u", "v"}`` tensors ``[..., ny, nx]``, in
    the vector-invariant form ``du/dt = (f + zeta) v - dB/dx``, ``dv/dt =
    -(f + zeta) u - dB/dy`` with ``zeta = dv/dx - du/dy`` and ``B = g eta +
    (u^2 + v^2) / 2``, the mass flux for eta, Newtonian relaxation toward
    the jet and del^4 hyperdiffusion.  ``jet``: the ``(f, u_jet,
    eta_jet)`` column tensors, built from ``p`` when None."""
    eta, u, v = state["eta"], state["u"], state["v"]
    fj, uj, ej = _jet_tensors(ny, p, eta) if jet is None else jet
    zeta = _ddx(v) - _ddy(u, +1)
    bern = p.g * eta + 0.5 * (u * u + v * v)
    du = ((fj + zeta) * v - _ddx(bern)
          + (uj - u) / p.tau - p.nu4 * _lap(_lap(u, +1), +1))
    dv = (-(fj + zeta) * u - _ddy(bern, +1)
          + (0.0 - v) / p.tau - p.nu4 * _lap(_lap(v, -1), -1))
    depth = p.h0 + eta
    deta = (-_ddx(depth * u) - _ddy(depth * v, -1)
            + (ej - eta) / p.tau - p.nu4 * _lap(_lap(eta, +1), +1))
    return {"eta": deta, "u": du, "v": dv}


def integrate(state: Dict[str, torch.Tensor], ny: int, nsteps: int = 1,
              p: SWEParams = DEFAULT) -> Dict[str, torch.Tensor]:
    """RK4 for ``nsteps`` steps; member axes broadcast elementwise."""
    dt = p.dt
    s = dict(state)
    jet = _jet_tensors(ny, p, s["eta"])

    def add(a, b, c):
        return {k: a[k] + c * b[k] for k in a}

    for _ in range(nsteps):
        k1 = tendency(s, ny, p, jet)
        k2 = tendency(add(s, k1, 0.5 * dt), ny, p, jet)
        k3 = tendency(add(s, k2, 0.5 * dt), ny, p, jet)
        k4 = tendency(add(s, k3, dt), ny, p, jet)
        s = {k: s[k] + (dt / 6.0) * (k1[k] + 2 * k2[k] + 2 * k3[k] + k4[k])
             for k in s}
    return s


def initial_state(ny: int, nx: int, seed: int = 0, noise: float = 0.05,
                  p: SWEParams = DEFAULT, device=None,
                  dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Balanced jet plus small eta noise from NumPy's ``default_rng(seed)``
    (the JAX package's draws), on ``device`` (the card unless given)."""
    device = default_device(device)
    u_jet, eta_jet, _ = jet_profile(ny, p)
    rng = np.random.default_rng(seed)
    eta = np.tile(eta_jet[:, None], (1, nx)) + noise * rng.standard_normal(
        (ny, nx))
    u = np.tile(u_jet[:, None], (1, nx))
    v = np.zeros((ny, nx))
    t = lambda x: torch.as_tensor(x, dtype=_torch_dtype(dtype),
                                  device=device)
    return {"eta": t(eta), "u": t(u), "v": t(v)}


def spinup_ensemble(ny: int = 32, nx: int = 64, nmems: int = 20,
                    seed: int = 0, spinup_steps: int = 6000,
                    member_steps: int = 800, p: SWEParams = DEFAULT,
                    generator: Optional[torch.Generator] = None,
                    device=None, dtype=torch.float32
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """``(truth, ensemble)`` dicts on the eddying attractor: truth fields
    ``[ny, nx]``, ensemble fields ``[nmems, ny, nx]``.  Members are the
    truth plus small noise (0.05 on eta, 0.02 on the winds) from
    ``generator`` (or a new one seeded with ``seed + 1``), integrated
    ``member_steps``."""
    device = default_device(device)
    dtype = _torch_dtype(dtype)
    truth = initial_state(ny, nx, seed=seed, p=p, device=device, dtype=dtype)
    truth = integrate(truth, ny, nsteps=spinup_steps, p=p)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed + 1)
    ens = {k: truth[k][None] + (0.05 if k == "eta" else 0.02) * torch.randn(
        (nmems, ny, nx), generator=generator, device=device, dtype=dtype)
        for k in VAR_ORDER}
    ens = integrate(ens, ny, nsteps=member_steps, p=p)
    return truth, ens


# Flat-state adapters for CyclingHarness: rows in (eta, u, v) blocks, each
# C-order over (y, x), as EnsembleState.to_vect orders (var, y, x).


def pack(state: Dict[str, torch.Tensor], ny: int, nx: int) -> torch.Tensor:
    """Dict -> flat ``[..., 3 ny nx]``."""
    return torch.cat([state[k].reshape(state[k].shape[:-2] + (ny * nx,))
                      for k in VAR_ORDER], dim=-1)


def unpack(flat: torch.Tensor, ny: int, nx: int) -> Dict[str, torch.Tensor]:
    """Flat ``[..., 3 ny nx]`` -> dict of ``[..., ny, nx]``."""
    n = ny * nx
    return {k: flat[..., i * n:(i + 1) * n].reshape(flat.shape[:-1] + (ny, nx))
            for i, k in enumerate(VAR_ORDER)}


def grid_latlon(ny: int, nx: int, lat_max: float = 55.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row ``(lats, lons)`` ``[3 ny nx]``: the channel mapped to
    +-``lat_max`` and once around in longitude, tiled once per variable."""
    lat1 = np.linspace(-lat_max, lat_max, ny)
    lon1 = np.arange(nx) * (360.0 / nx)
    lon, lat = np.meshgrid(lon1, lat1)
    return (np.tile(lat.ravel(), len(VAR_ORDER)),
            np.tile(lon.ravel(), len(VAR_ORDER)))


def var_rows(var: str, ny: int, nx: int, stride: int = 1) -> np.ndarray:
    """Flat-state rows of ``var`` at every ``stride``-th grid point: the
    identity-pick observation rows for the harness."""
    base = VAR_ORDER.index(var) * ny * nx
    return base + np.arange(0, ny * nx, stride)


def make_flat_forecast(ny: int, nx: int, nsteps: int = 20,
                       p: SWEParams = DEFAULT) -> Callable:
    """Forecast callable on flat states (tensors) for the harness."""

    def forecast(flat):
        return pack(integrate(unpack(flat, ny, nx), ny, nsteps=nsteps, p=p),
                    ny, nx)

    return forecast
