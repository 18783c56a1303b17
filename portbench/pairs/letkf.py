"""Pair counter ``letkf``: the units of one LETKF update, as the traffic
mix's filter lays them out in chunks (``letkf_core.letkf_update``).

A unit is one local analysis: a patch of ``letkf_patch_size`` rows of
the body, or an ob (the obs-space posterior).  The body's patches are
padded to whole chunks of ``min(letkf_chunk, patches)`` units and the
obs to whole chunks of ``min(letkf_chunk, No)``; the padding is solved
too.  Each unit solves over ``k = min(letkf_k_obs, No)`` obs; each chunk
is one LG and one NS launch on the card.  The apply writes every row of
the body once and every ob's posterior once.

The distinct obs whose rows a chunk gathers are counted by a plain
selection (``reference/letkf_local.py``'s geometry, float32 dots, top-k).
A padding unit of the body has a zero centroid and every dot a zero,
``-0.0`` for an ob whose three coordinates are negative: it takes the
first ``k`` obs in the order the filter ranks them, ``+0.0`` above
``-0.0``, ties to the lower index.  A padding unit of the obs space has
its selection padded with zeros: it takes ob 0 alone.  Only the byte
counts read them.
"""

from __future__ import annotations

import torch

from portbench import spec

F32 = torch.float32


def _dots(p, obs):
    return (p[:, None, 0] * obs[None, :, 0] + p[:, None, 1] * obs[None, :, 1]
            + p[:, None, 2] * obs[None, :, 2]).to(F32)


def _distinct(units, obs, k: int, real: int, chunk: int,
              padding) -> int:
    """Summed over chunks of ``chunk`` units (the first ``real`` real, the
    rest padding, which selects the obs ``padding``): the distinct obs the
    chunk's units select."""
    total = torch.zeros((), dtype=torch.int64, device=obs.device)
    for c in range(-(-real // chunk)):
        p = units[c * chunk:min((c + 1) * chunk, real)]
        take = torch.zeros(obs.shape[0], dtype=torch.bool,
                           device=obs.device)
        take[torch.topk(_dots(p, obs), k, dim=1).indices.reshape(-1)] = True
        if p.shape[0] < chunk:
            take[padding] = True
        total += take.sum()
    return int(total)


def count(inputs, fields: dict) -> dict:
    """Units of one update of the run ``inputs`` under the ``FilterConfig``
    fields ``fields``: padded to whole chunks, body and obs apart, with
    the sizes the kernels' counts need."""
    ref = spec.load_module("reference", "letkf_local")
    ps = int(fields.get("letkf_patch_size", 1))
    k = min(int(fields.get("letkf_k_obs", 64)), inputs.nobs)
    chunk = int(fields.get("letkf_chunk", 512))
    dtype = getattr(torch, fields.get("dtype", "float32"))
    n, no = inputs.nstate, inputs.nobs
    npatch = -(-n // ps)
    bc, oc = min(chunk, npatch), min(chunk, no)
    body_chunks, obs_chunks = -(-npatch // bc), -(-no // oc)
    obs = ref.unit_vectors(inputs.ob_lat, inputs.ob_lon, dtype)
    cen = ref.centroids(ref.unit_vectors(inputs.row_lat, inputs.row_lon,
                                         dtype), ps)
    zero = torch.signbit(_dots(torch.zeros_like(obs[:1]), obs)[0])
    body_padding = torch.sort(zero.to(torch.int8), stable=True).indices[:k]
    gathered = (_distinct(cen, obs, k, npatch, bc, body_padding)
                + _distinct(obs, obs, k, no, oc, torch.zeros_like(
                    body_padding[:1])))
    return dict(nmems=inputs.nmems, nstate=n, nobs=no, patch_size=ps, k=k,
                body_units=body_chunks * bc, obs_units=obs_chunks * oc,
                units=body_chunks * bc + obs_chunks * oc,
                body_chunks=body_chunks, obs_chunks=obs_chunks,
                chunks=body_chunks + obs_chunks, rows=n + no,
                gathered_rows=gathered)
