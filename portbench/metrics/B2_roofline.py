"""B2_roofline: percent of its roofline that B2
(``portbench/counts/B2.py``) reaches over the traced window."""

from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "B2")
