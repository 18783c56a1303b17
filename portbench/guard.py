"""The check that a run loaded neither JAX nor the JAX package.

Compares the top-level name of each loaded module (the part before the
first dot) whole: ``efa_xray_tpu_torch`` begins with ``efa_xray_tpu``
and is the port, not the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "efa_xray_tpu"})


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)
