"""B1_roofline: percent of its roofline that B1
(``portbench/counts/B1.py``) reaches over the traced window."""

from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "B1")
