"""B4_roofline: percent of its roofline that B4
(``portbench/counts/B4.py``) reaches over the traced window."""

from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "B4")
