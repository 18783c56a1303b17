"""Coastline overlays without a geo toolkit.

Copy of ``efa_xray_tpu/utils/coastlines.py`` (NumPy only); the rest of
this docstring is the JAX module's.

The reference draws coastlines/countries through Basemap
(``efa_xray/observation/observation.py:109-111``); neither Basemap nor
cartopy is a dependency, so maps drawn by
:meth:`Observation.map_localization` would otherwise have no geographic
context at all.  This module provides two substitutes:

* a **built-in, orientation-grade world outline**
  (:data:`COARSE_WORLD_LONLAT`): hand-digitized continental outlines at
  roughly 3-8 degree fidelity.  It is deliberately coarse — enough to
  tell "that localization blob sits over the North Atlantic", not for
  publication cartography;
* :func:`load_segments` for **user-supplied polylines** (``.npz``/
  ``.npy``/``.csv``/``.txt``), e.g. Natural Earth coastlines exported
  once on a machine that has cartopy:

  >>> # elsewhere: np.savez("ne110.npz", lonlat=my_nan_separated_lonlat)
  >>> ob.map_localization(state, coastlines="ne110.npz")

Segment format everywhere: a float ``(N, 2)`` array of ``(lon, lat)``
vertices in degrees, with ``NaN`` rows separating disconnected
polylines (the matplotlib convention — one ``plot`` call draws all
segments).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "COARSE_WORLD_LONLAT",
    "load_segments",
    "wrap_segments",
    "draw_coastlines",
]


def _seg(*pts):
    """One polyline + trailing NaN separator."""
    return list(pts) + [(np.nan, np.nan)]


# Hand-digitized ~3-8 degree outlines (lon in [-180, 180], lat degrees).
# Interior seas (Baltic, Black, Caspian, Hudson Bay, Persian Gulf) and
# small islands are intentionally omitted at this fidelity.
_WORLD = (
    # Americas: Pacific coast south, around Cape Horn, Atlantic coast
    # north, Gulf of Mexico, US/Canada east coast, Arctic coast west.
    _seg((-168, 66), (-165, 60), (-158, 58), (-152, 60), (-145, 60),
         (-135, 57), (-130, 54), (-125, 48), (-124, 43), (-120, 34),
         (-117, 32), (-110, 23), (-105, 20), (-96, 16), (-92, 14),
         (-85, 11), (-79, 9), (-77, 4), (-80, -3), (-81, -6),
         (-76, -14), (-70, -18), (-70, -30), (-73, -38), (-74, -46),
         (-72, -52), (-68, -55), (-65, -55), (-65, -47), (-62, -40),
         (-57, -36), (-52, -32), (-48, -27), (-42, -23), (-39, -17),
         (-35, -9), (-37, -5), (-44, -3), (-50, 0), (-52, 4),
         (-60, 8), (-64, 10), (-72, 12), (-75, 10), (-77, 8),
         (-82, 9), (-83, 11), (-87, 13), (-88, 16), (-87, 21),
         (-90, 21), (-91, 19), (-97, 20), (-97, 26), (-94, 29),
         (-90, 29), (-84, 30), (-83, 28), (-81, 25), (-80, 27),
         (-81, 31), (-76, 35), (-74, 39), (-70, 42), (-66, 44),
         (-60, 47), (-56, 50), (-56, 52), (-60, 55), (-62, 58),
         (-66, 62), (-75, 62), (-82, 65), (-90, 68), (-105, 68),
         (-115, 69), (-128, 70), (-140, 70), (-156, 71), (-162, 69),
         (-166, 66), (-168, 66)),
    # Greenland
    _seg((-45, 60), (-52, 64), (-54, 69), (-58, 75), (-68, 78),
         (-58, 81), (-40, 83), (-22, 80), (-22, 75), (-30, 69),
         (-40, 63), (-45, 60)),
    # Africa
    _seg((-10, 31), (-6, 35), (0, 37), (10, 37), (11, 34), (15, 32),
         (25, 32), (32, 31), (33, 28), (36, 22), (39, 16), (43, 11.5),
         (48, 11), (51, 12), (51, 10), (46, 2), (41, -3), (39, -8),
         (36, -15), (35, -22), (33, -27), (27, -33), (20, -35),
         (17, -33), (14, -26), (12, -18), (13, -10), (9, -2), (9, 4),
         (6, 6), (0, 6), (-5, 5), (-8, 5), (-13, 8), (-17, 13),
         (-17, 16), (-16, 20), (-15, 24), (-13, 27), (-10, 31)),
    # Eurasia, Mediterranean to Bering (split at the dateline).
    _seg((-9, 43), (-9, 38), (-6, 36), (-2, 37), (0, 39), (3, 42),
         (7, 44), (12, 44), (14, 42), (16, 40), (18, 40), (20, 40),
         (22, 37), (23, 38), (26, 40), (29, 41), (30, 36), (33, 36),
         (36, 36), (36, 34), (35, 32), (34, 31), (32, 30), (33, 28),
         (35, 28), (38, 24), (41, 19), (43, 15), (45, 13), (49, 14),
         (53, 17), (59, 23), (62, 25), (66, 25), (68, 23), (72, 21),
         (73, 16), (76, 12), (77, 8), (80, 13), (82, 16), (86, 20),
         (89, 22), (92, 20), (94, 18), (94, 16), (97, 12), (98, 8),
         (100, 3), (104, 2), (101, 7), (100, 13), (105, 9), (107, 10),
         (109, 12), (109, 16), (106, 20), (108, 22), (110, 21),
         (114, 22), (117, 23), (120, 26), (121, 30), (120, 34),
         (119, 38), (122, 40), (124, 40), (125, 38), (126, 35),
         (129, 35), (129, 38), (131, 42.5), (135, 44), (138, 47),
         (137, 51), (138, 54), (143, 59), (147, 60), (153, 59),
         (156, 51), (158, 53), (160, 56), (163, 60), (166, 62),
         (170, 64), (175, 65), (180, 65.5)),
    _seg((-180, 65.5), (-175, 66.5), (-170, 66.5), (-173, 67.5),
         (-180, 68.3)),
    _seg((180, 68.3), (170, 70), (160, 71), (150, 72), (140, 72.5),
         (130, 72), (120, 73), (110, 74), (103, 77.5), (95, 76),
         (85, 73), (75, 72.5), (68, 69), (60, 69), (50, 68.5),
         (44, 67), (40, 66), (33, 67), (30, 70), (25, 71), (18, 70),
         (12, 65), (5, 62), (6, 59), (8, 57), (8, 55), (5, 53),
         (3, 51), (0, 50), (-2, 48), (-4, 48), (-1, 46), (-2, 44),
         (-9, 43)),
    # British Isles
    _seg((-5, 50), (1, 51), (2, 53), (0, 53), (-2, 56), (-4, 58),
         (-5, 58), (-6, 56), (-5, 54), (-5, 53), (-5, 50)),
    _seg((-6, 52), (-10, 52), (-10, 54), (-8, 55), (-6, 54), (-6, 52)),
    # Japan
    _seg((130, 31), (132, 34), (136, 34.5), (140, 35.5), (141, 39),
         (140, 42), (143, 42), (145, 43.5), (142, 45.5), (140, 43.5)),
    # Maritime continent
    _seg((95, 5.5), (102, -1), (106, -6), (100, 0), (95, 5.5)),  # Sumatra
    _seg((105, -6), (110, -7), (114, -8)),  # Java
    _seg((109, 2), (110, -2), (114, -4), (118, -1), (119, 1),
         (117, 7), (113, 6), (109, 2)),  # Borneo
    _seg((131, -1), (138, -2), (141, -3), (146, -6), (150, -10),
         (147, -9), (143, -8), (139, -8), (135, -4), (131, -1)),  # New Guinea
    # Australia
    _seg((114, -22), (113, -26), (115, -34), (119, -35), (124, -33),
         (130, -32), (138, -35), (140, -38), (147, -39), (150, -37),
         (153, -32), (153, -27), (150, -22), (146, -19), (143, -14),
         (142, -11), (141, -12), (138, -17), (136, -12), (132, -11),
         (126, -14), (122, -18), (114, -22)),
    # Madagascar
    _seg((44, -25), (47, -25), (50, -16), (49, -12), (44, -20),
         (44, -25)),
    # New Zealand
    _seg((173, -34.5), (176, -38), (175, -41.5), (173, -39.5),
         (173, -34.5)),
    _seg((174, -41), (171, -42), (167, -46.5), (169, -46.8),
         (172, -43.5), (174, -41)),
    # Antarctica (open polyline across the map)
    _seg((-180, -72), (-150, -76), (-120, -74), (-95, -73), (-75, -70),
         (-62, -64), (-60, -70), (-45, -75), (-30, -72), (-10, -70),
         (0, -70), (20, -70), (45, -67), (70, -68), (90, -66),
         (110, -66), (135, -66), (160, -70), (180, -72)),
)

COARSE_WORLD_LONLAT = np.asarray(
    [p for seg in _WORLD for p in seg], dtype=np.float64
)


def load_segments(path: str) -> np.ndarray:
    """Load NaN-separated ``(N, 2)`` lon/lat polylines from a file.

    * ``.npz`` — uses key ``"lonlat"`` if present, else the first array;
    * ``.npy`` — the array itself;
    * ``.csv``/``.txt`` — two comma/whitespace-separated columns
      ``lon, lat``; blank lines (or non-numeric rows, e.g. a header)
      become segment breaks.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as z:
            key = "lonlat" if "lonlat" in z.files else z.files[0]
            arr = np.asarray(z[key], dtype=np.float64)
    elif ext == ".npy":
        arr = np.asarray(np.load(path), dtype=np.float64)
    else:
        rows = []
        with open(path) as f:
            for line in f:
                parts = line.replace(",", " ").split()
                if len(parts) < 2:
                    rows.append((np.nan, np.nan))
                    continue
                try:
                    rows.append((float(parts[0]), float(parts[1])))
                except ValueError:
                    rows.append((np.nan, np.nan))
        arr = np.asarray(rows, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(
            f"coastline file {path!r} must yield an (N, 2) lon/lat array, "
            f"got shape {arr.shape}"
        )
    return arr


def wrap_segments(lonlat: np.ndarray, lon360: bool = False) -> np.ndarray:
    """Wrap segment longitudes to the grid's convention and re-break
    polylines that the wrap makes jump across the seam.

    ``lon360=False`` wraps to ``[-180, 180)``; ``True`` to ``[0, 360)``.
    Any consecutive vertex pair more than 180 degrees apart after
    wrapping gets a NaN break inserted, so the seam never draws a line
    across the whole map.
    """
    lonlat = np.asarray(lonlat, dtype=np.float64)
    lon = lonlat[:, 0].copy()
    lat = lonlat[:, 1]
    lon = np.mod(lon, 360.0) if lon360 else np.mod(lon + 180.0, 360.0) - 180.0
    jump = np.abs(np.diff(lon)) > 180.0
    finite = np.isfinite(lon[:-1]) & np.isfinite(lon[1:])
    breaks = np.nonzero(jump & finite)[0] + 1
    if breaks.size == 0:
        return np.column_stack([lon, lat])
    out = np.insert(
        np.column_stack([lon, lat]), breaks,
        np.array([[np.nan, np.nan]]), axis=0,
    )
    return out


def draw_coastlines(ax, segments=None, projection=None, lon360=False,
                    **plot_kw):
    """Draw coastline polylines on ``ax``.

    ``segments``: ``None`` (built-in coarse world outline), a path (see
    :func:`load_segments`), or an ``(N, 2)`` lon/lat array.
    ``projection``: the same optional callable ``(lon, lat) -> (x, y)``
    that :meth:`EnsembleState.project_coordinates` takes; applied
    NaN-safely per vertex.  ``lon360`` matches grids whose longitudes
    run 0-360.  Returns the ``Line2D`` list from ``ax.plot``.
    """
    if segments is None:
        lonlat = COARSE_WORLD_LONLAT
    elif isinstance(segments, (str, os.PathLike)):
        lonlat = load_segments(os.fspath(segments))
    else:
        lonlat = np.asarray(segments, dtype=np.float64)
        if lonlat.ndim != 2 or lonlat.shape[1] != 2:
            raise ValueError(
                f"coastline segments must be (N, 2) lon/lat, got "
                f"{lonlat.shape}"
            )
    if projection is None:
        lonlat = wrap_segments(lonlat, lon360=lon360)
        x, y = lonlat[:, 0], lonlat[:, 1]
    else:
        lon, lat = lonlat[:, 0], lonlat[:, 1]
        ok = np.isfinite(lon) & np.isfinite(lat)
        x = np.full(lon.shape, np.nan)
        y = np.full(lat.shape, np.nan)
        px, py = projection(lon[ok], lat[ok])
        x[ok], y[ok] = np.asarray(px, float), np.asarray(py, float)
    plot_kw.setdefault("color", "0.25")
    plot_kw.setdefault("linewidth", 0.7)
    plot_kw.setdefault("zorder", 3)
    return ax.plot(x, y, **plot_kw)
