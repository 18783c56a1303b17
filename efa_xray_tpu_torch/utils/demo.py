"""Shared plumbing for demo scripts.

Counterpart of ``efa_xray_tpu/utils/demo.py``, whose ``add_platform_arg``
/ ``apply_platform`` pin JAX to the CPU for demo-scale problems on a
remote-compile TPU.  The port has no compile round trip, and its entry
points run on the card unless the caller asks for the CPU, so a demo here
takes a ``--device`` option instead: :func:`add_device_arg` adds it and
:func:`apply_device` resolves it, raising without a card unless ``cpu``
was asked for.
"""

from __future__ import annotations


def add_device_arg(ap) -> None:
    """Add the common ``--device`` option to an argparse parser."""
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device of the demo's tensors (default cuda: the card; "
        "without one pass --device cpu)",
    )


def apply_device(args):
    """The ``torch.device`` that ``args.device`` names: ``cuda`` (the
    default) raises without a card rather than run on the CPU."""
    from efa_xray_tpu_torch.state.ensemble import default_device

    device = getattr(args, "device", "cuda")
    return default_device(None if device == "cuda" else device)
