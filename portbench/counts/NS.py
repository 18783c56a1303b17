"""Work of NS, the LETKF's Newton-Schulz inverse square root with its exit
test on the card (``csrc/newton_schulz.cu``, one launch a chunk), over the
units of one update (``portbench/pairs/letkf.py``, padding included).

Per unit, at ``ITERATIONS`` iterations: three ``M x M`` products an
iteration (``Z Y``, ``Y T``, ``T Z``: ``6 M^3`` operations) and the end's
two products with a vector and the scaling (``4 M^2``); ``A`` and ``b``
read, ``W`` and ``wbar`` written once, float32.  The exit rule stops
each launch where its chunk has converged, so the work is counted at a
fixed number of iterations: what the rule takes at config 7.
"""

from portbench import work

KERNEL = "ns_smem_kernel"
# Iterations the exit rule takes at config 7 (letkf4m): the mean over
# every chunk of the cell's updates, letkf_core.ns_counts()'s iterations
# over its calls read after the window, on an H100 (80GB HBM3, 700 W):
# 184,732 over 16,704 launches on three seeds, 11.05-11.07 each, at most
# 12 in a chunk.
ITERATIONS = 11.06


def ops_bytes(p: dict):
    m, units = p["nmems"], p["units"]
    return (units * (6 * ITERATIONS * m ** 3 + 4 * m * m),
            units * (2 * m * m + 2 * m) * work.F4)
