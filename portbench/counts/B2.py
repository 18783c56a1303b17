"""Work of B2, the fused body kernel with culling (``csrc/ensrf_fused.cu``)
on its two uses in an update: the tail apply out of panel and the body
(``portbench/work.py``)."""

from portbench import work

KERNEL = "fused_body_kernel"


def ops_bytes(p: dict):
    return ((p["tail_pairs"] + p["body_pairs"]) * work.ops_per_pair(
        p["nmems"]), work.apply_bytes(p))
