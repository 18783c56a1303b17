"""NS_roofline: percent of its roofline that NS
(``portbench/counts/NS.py``) reaches over the traced window."""

from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "NS")
