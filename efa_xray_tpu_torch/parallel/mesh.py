"""Device-mesh helpers.

Counterpart of ``efa_xray_tpu/parallel/mesh.py``: ``STATE_AXIS``,
``make_mesh`` :24, ``pad_to_multiple`` :31, ``pad_rows`` :35 and
``shard_state_array`` :44.

The JAX package shards the flattened state over a ``jax.sharding.Mesh``
and replicates the observation-space tail; its sharded update issues no
collective (``parallel/sharded.py``).  So the port needs no
``torch.distributed`` and no process group: a :class:`Mesh` is a list of
torch devices driven from one process, as the JAX mesh is driven from one
controller.  A device may repeat in the list (``[cpu] * 8``, ``[cuda:0] *
4``): the port's stand-in for XLA's forced host device count, which runs
the split, the padding, each shard's solve and the gather on one device.
Several processes or nodes would need ``torch.distributed``, which the
JAX package does not use either.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

STATE_AXIS = "state"


class Mesh:
    """A 1-D mesh: ``devices`` (a list of ``torch.device``, repeats
    allowed), ``axis_names`` and ``shape[axis_name]``, the attributes of
    ``jax.sharding.Mesh`` that the sharded drivers read."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = (
            STATE_AXIS,)):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1:
            raise ValueError("the mesh is 1-D: one axis name")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices without repeats, in first-seen order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self):
        return (f"Mesh(devices={[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = STATE_AXIS) -> Mesh:
    """A 1-D mesh over the given devices, or over every visible CUDA device
    when None.  Without a card and without ``devices`` it raises: the CPU
    is used only when the caller lists it."""
    if devices is None:
        from efa_xray_tpu_torch.state.ensemble import default_device

        default_device()  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis_name,))


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_rows(arr: torch.Tensor, target_rows: int,
             fill=0.0) -> torch.Tensor:
    """Pad the leading (state-row) dimension up to ``target_rows`` with
    ``fill``; ``arr`` itself when nothing is missing."""
    pad = target_rows - arr.shape[0]
    if pad == 0:
        return arr
    return F.pad(arr, [0, 0] * (arr.ndim - 1) + [0, pad], value=fill)


def shard_state_array(data: torch.Tensor, mesh: Mesh,
                      axis_name: str = STATE_AXIS):
    """Split a dense ``[vars, times, y, x, mems]`` state tensor (or a flat
    ``[nstate, nmems]`` one) over the mesh along the first state dimension
    that the mesh size divides, preferring y, then x, then time, then var,
    as the JAX rule picks it.  A torch tensor cannot span devices, so this
    returns ``(chunks, axis)``: one chunk per mesh device, on that device,
    and the axis they split; ``axis`` None and whole copies when no
    dimension divides (replication).  The sharded drivers do their own
    padded flat-row split either way: this is a placement convenience."""
    ndev = mesh.shape[axis_name]
    candidates = [0] if data.ndim == 2 else [2, 3, 1, 0]
    for axis in candidates:
        if axis < data.ndim and data.shape[axis] % ndev == 0:
            parts = torch.chunk(data, ndev, dim=axis)
            return [p.to(d) for p, d in zip(parts, mesh.devices)], axis
    return [data.to(d) for d in mesh.devices], None
