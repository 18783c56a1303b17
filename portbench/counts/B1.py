"""Work of B1, the tail's panel solve (``csrc/tail_solve.cu``): the pairs
of two obs in one panel (``portbench/work.py``,
``portbench/pairs/ensrf.py``)."""

from portbench import work

KERNEL = "tail_solve_kernel"


def ops_bytes(p: dict):
    return p["panel_pairs"] * work.ops_per_pair(p["nmems"]), \
        work.panel_bytes(p)
