"""Work of LG, the LETKF chunk's local weights, ``A`` and ``b`` in one
launch (``csrc/letkf_gram.cu``), over the units of one update
(``portbench/pairs/letkf.py``, padding included).

Operations per (unit, selected ob): the symmetric Gram's ``M (M + 1)``
(one triangle of ``A`` and its diagonal, a multiply and an add each),
the right-hand side's ``2 M`` and 60 for the weight (the chordal dot,
the polynomial arccos, Gaspari-Cohn, ``1 / R``).  Bytes: the rows of
``ye`` and of the 32-byte obs table that a chunk gathers (each distinct
ob once a chunk), each unit's indices and centroid read, and ``A`` (both
triangles) and ``b`` written, float32.
"""

from portbench import work

KERNEL = "lg_gram_kernel"
WEIGHT_OPS = 60
TABLE_BYTES = 32
INDEX_BYTES = 8


def ops_bytes(p: dict):
    m, k, units = p["nmems"], p["k"], p["units"]
    ops = units * k * (m * (m + 1) + 2 * m + WEIGHT_OPS)
    nbytes = (p["gathered_rows"] * (m * work.F4 + TABLE_BYTES)
              + units * (k * INDEX_BYTES + 3 * work.F4
                         + (m * m + m) * work.F4))
    return ops, nbytes
