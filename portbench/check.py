"""The comparison that decides ``correct``.

Each gap compares the program's answer to one update with the
reference's, as a share of what that update changed, so that a number
reads alike at any scale.  Which parts an answer has, the change each is
measured against and which parts make up each compared number are the
reference's to say (``portbench/reference/<name>.py``: ``SCALES``,
``NUMBERS``, ``EXACT``; the EnSRF's are its state rows' posterior, the
per-ob diagnostics and the obs' final posterior).  A part the entry does
not return is left out; a non-finite answer reads ``inf``.  The limits
sit in the cell's file (``portbench/cells/<cell>.json``, key
``limits``), one for each compared number.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def _rms(x) -> float:
    return float(torch.sqrt(torch.mean(x.to(F64) ** 2)))


def _gap(got, want, scale: float) -> float:
    got = got.to(F64)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    if scale == 0.0:
        return 0.0 if bool(torch.equal(got, want.to(F64))) else math.inf
    return float((got - want.to(F64)).abs().max()) / scale


def names(ref) -> tuple:
    """The compared numbers of reference module ``ref``."""
    return tuple(ref.NUMBERS) + tuple(ref.EXACT)


def parts(got: dict, want: dict, ref) -> dict:
    """Every gap of one update: ``got`` the program's answer, ``want``
    the reference's (``ref.expected``)."""
    dev = next(iter(want.values())).device
    got = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}
    out = {k: _gap(got[k], want[k], _rms(want[a] - want[b]))
           for k, (a, b) in ref.SCALES.items() if k in got}
    for n, k in ref.EXACT.items():
        out[n] = int((torch.as_tensor(got[k]).to(dev).to(want[k].dtype)
                      != want[k]).sum())
    return out


def numbers(readings: list, ref) -> dict:
    """The compared numbers over the checked updates' :func:`parts`."""
    if not readings:
        return {n: math.inf for n in names(ref)}
    out = {n: max(r[k] for r in readings for k in ks if k in r)
           for n, ks in ref.NUMBERS.items()}
    out.update({n: max(r[n] for r in readings) for n in ref.EXACT})
    return out


def verdict(nums: dict, limits: dict) -> bool:
    return all(nums[n] <= limits[n] for n in nums)
