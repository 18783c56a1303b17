"""Work of B4, the blocked body kernel with exact haversine weights
(``csrc/ensrf_grid.cu``, one launch an obs block) on its two uses in an
update: the tail apply out of panel and the body (``portbench/work.py``).
B3 shares the kernel: no cell that counts B4 may run B3."""

from portbench import work

KERNEL = "grid_body_kernel"


def ops_bytes(p: dict):
    return ((p["tail_pairs"] + p["body_pairs"]) * work.ops_per_pair(
        p["nmems"]), work.apply_bytes(p))
