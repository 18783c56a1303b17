"""EnsembleState: the ensemble as one dense torch tensor plus its structure.

Counterpart of ``efa_xray_tpu/state/ensemble.py``: ``from_vardict`` :59,
``from_vect`` :152, the size accessors :159-181, ``to_vect`` :208 (row
order (var, time, y, x), members last), ``ensemble_mean`` :218 and
``ensemble_perts`` :223.  Selection
(``sel``/``isel``), arithmetic, sharding and netCDF I/O are not ported yet.

The data lives in ONE tensor ``[nvars, ntimes, ny, nx, nmems]`` on one
device, the card unless the caller asks for another;
:class:`~efa_xray_tpu_torch.state.structure.StateStructure` holds the host
metadata.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from efa_xray_tpu_torch.state.structure import StateMeta, StateStructure

_COORD_NAMES = ("validtime", "lat", "lon", "mem", "x", "y", "location")


def default_device(device=None) -> torch.device:
    """``device``, or the card when it is None.  Without a card a missing
    ``device`` raises: the CPU is used only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def _unwrap(v):
    """xarray-style ``(dims, array)`` tuples -> the array."""
    if isinstance(v, tuple) and len(v) == 2 and isinstance(
            v[0], (str, tuple, list)):
        return v[1]
    return v


class EnsembleState:
    """Dense ensemble state: ``data[var, time, y, x, member]`` + structure."""

    def __init__(self, data: torch.Tensor, structure: StateStructure):
        self.data = data
        self.structure = structure

    @classmethod
    def from_vardict(cls, vardict: Dict, coorddict: Dict, dtype=None,
                     device=None, attrs: Optional[Dict] = None,
                     var_attrs: Optional[Dict] = None) -> "EnsembleState":
        """Build from xarray-style variable/coordinate dicts (reference
        ``efa_xray/state/ensemble.py:25-36``).

        ``vardict``: ``{name: array}`` (or ``(dims, array)``) with shape
        ``(ntimes, ny, nx, nmems)`` or ``(ntimes, nloc, nmems)``; arrays
        may be NumPy arrays or tensors.  ``coorddict`` holds ``validtime``,
        ``lat``, ``lon`` and optionally ``mem``; other entries are kept as
        extra coordinates.  ``dtype`` defaults to float32 (a string such
        as ``"float64"`` or a torch dtype).  ``device`` defaults to the
        card, for NumPy arrays and tensors alike; without a card it must
        be given (``device="cpu"``).
        """
        times = _unwrap(coorddict["validtime"])
        lat = np.asarray(_unwrap(coorddict["lat"]))
        lon = np.asarray(_unwrap(coorddict["lon"]))
        mems = coorddict.get("mem")

        names = [k for k in vardict if k not in _COORD_NAMES]
        if not names:
            raise ValueError("vardict contains no state variables")
        fields = []
        for name in names:
            arr = _unwrap(vardict[name])
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.array(arr))
            if arr.ndim == 3:  # (T, nloc, M) -> (T, nloc, 1, M)
                arr = arr[:, :, None, :]
            if arr.ndim != 4:
                raise ValueError(
                    f"Variable {name!r} must be (time, y, x, mem) or "
                    f"(time, loc, mem); got shape {tuple(arr.shape)}")
            fields.append(arr)
        nmems = fields[0].shape[-1] if mems is None else len(mems)

        extra = {}
        for cname, cval in coorddict.items():
            if cname in _COORD_NAMES:
                continue
            if isinstance(cval, tuple) and len(cval) == 2 and isinstance(
                    cval[0], (str, tuple, list)):
                cdims = (cval[0],) if isinstance(cval[0], str) else tuple(cval[0])
                carr = np.asarray(cval[1])
            else:
                carr = np.asarray(cval)
                cdims = tuple(f"{cname}_dim{i}" for i in range(carr.ndim))
            extra[cname] = (cdims, carr, {})
        meta = None
        if attrs or var_attrs or extra:
            meta = StateMeta(
                attrs=dict(attrs or {}),
                var_attrs={k: dict(v) for k, v in (var_attrs or {}).items()},
                coords=extra)
        structure = StateStructure.build(names, times, lat, lon, nmems,
                                         meta=meta)
        device = default_device(device)
        dtype = _torch_dtype(dtype or "float32")
        data = torch.stack([f.to(device=device, dtype=dtype) for f in fields])
        if tuple(data.shape) != structure.shape:
            raise ValueError(
                f"Variable shapes {tuple(data.shape[1:])} inconsistent with "
                f"coords {structure.shape[1:]}")
        return cls(data, structure)

    @classmethod
    def from_vect(cls, vect, structure: StateStructure) -> "EnsembleState":
        """Inverse of :meth:`to_vect`: ``[nstate, nmems]`` -> state."""
        return cls(vect.reshape(structure.shape), structure)

    # --- reference-compatible size accessors (methods, not properties) ----
    def nmems(self) -> int:
        return self.structure.nmems

    def ny(self) -> int:
        return self.structure.ny

    def nx(self) -> int:
        return self.structure.nx

    def ntimes(self) -> int:
        return self.structure.ntimes

    def vars(self) -> list:
        return list(self.structure.var_names)

    def nvars(self) -> int:
        return self.structure.nvars

    def nstate(self) -> int:
        return self.structure.nstate

    def shape(self) -> Tuple[int, ...]:
        return self.structure.shape

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __getitem__(self, name: str):
        """One variable's dense block ``[time, y, x, mem]``."""
        return self.data[self.structure.var_index(name)]

    def to_vect(self) -> torch.Tensor:
        """``[nstate, nmems]`` in (var, time, y, x) row order (a view)."""
        s = self.structure
        return self.data.reshape(s.nstate, s.nmems)

    def update_from_vect(self, vect) -> "EnsembleState":
        return EnsembleState.from_vect(vect, self.structure)

    def ensemble_mean(self) -> torch.Tensor:
        """Mean over members -> ``[nvars, ntimes, ny, nx]``."""
        return self.data.mean(dim=-1)

    def ensemble_perts(self) -> "EnsembleState":
        """Perturbations from the ensemble mean, same shape as the state."""
        return EnsembleState(self.data - self.ensemble_mean()[..., None],
                             self.structure)

    def ensemble_times(self) -> np.ndarray:
        return self.structure.times64()

    def replace_data(self, data) -> "EnsembleState":
        return EnsembleState(data, self.structure)

    def to(self, device=None, dtype=None) -> "EnsembleState":
        return EnsembleState(self.data.to(device=device, dtype=dtype),
                             self.structure)

    def __repr__(self):
        s = self.structure
        return (f"EnsembleState(vars={list(s.var_names)}, ntimes={s.ntimes}, "
                f"grid={s.ny}x{s.nx}, nmems={s.nmems}, dtype={self.data.dtype}, "
                f"device={self.data.device})")


def _torch_dtype(dtype) -> torch.dtype:
    """``"float32"`` / ``np.float64`` / ``torch.float32`` -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)
