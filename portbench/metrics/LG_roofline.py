"""LG_roofline: percent of its roofline that LG
(``portbench/counts/LG.py``) reaches over the traced window."""

from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "LG")
