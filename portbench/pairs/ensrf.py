"""Pair counter ``ensrf``: the work of one serial EnSRF update, as the
traffic mix's filter splits it between the tail and the body
(``portbench/work.py`` defines the pair and its operations and bytes).

The tail's panels are runs of ``tail_panel`` consecutive obs; the panel
solve (B1) takes the pairs of two obs in one panel, the tail apply (B2 or
B4) the pairs of an ob and an ob prior outside its panel, the body (B2 or
B4) the pairs of an ob and a state row.
"""

from __future__ import annotations

from portbench.work import reach_counts


def count(inputs, fields: dict) -> dict:
    """Pairs within reach of one update of the run ``inputs`` under the
    ``FilterConfig`` fields ``fields``: in the tail's panels, in the tail
    outside them, and in the body; with the sizes the byte counts need."""
    panel = int(fields["tail_panel"])
    lat, lon, r = inputs.ob_lat, inputs.ob_lon, inputs.radii
    tail = reach_counts(lat, lon, lat, lon, r)
    body = reach_counts(inputs.row_lat, inputs.row_lon, lat, lon, r)
    in_panel = 0
    sizes = []
    for s in range(0, inputs.nobs, panel):
        sl = slice(s, s + panel)
        in_panel += int(reach_counts(lat[sl], lon[sl], lat[sl], lon[sl],
                                     r[sl]).sum())
        sizes.append(min(panel, inputs.nobs - s))
    return dict(nmems=inputs.nmems, nobs=inputs.nobs, nstate=inputs.nstate,
                panel_sizes=sizes, panel_pairs=in_panel,
                tail_pairs=int(tail.sum()) - in_panel,
                body_pairs=int(body.sum()))
