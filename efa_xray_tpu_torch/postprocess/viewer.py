"""Interactive assimilation viewer.

Live twin of the reference notebook's ipywidgets viewer
(``efa_demo.ipynb`` cells 14-16): sliders for observation count,
observation error and inflation re-run the square-root assimilation of a
point-forecast trajectory and redraw the spaghetti + variance panels.

Works in three modes, picked automatically by :func:`assimilation_viewer`:

* **ipywidgets** (notebook with ipywidgets installed): ``interact`` sliders;
* **matplotlib.widgets** (any GUI backend): in-figure sliders;
* **headless** (Agg): programmatic ``viewer.update(...)`` + ``save(path)``.

Slider moves are shape-stable by construction: the observation batch is
always built at ``max_obs`` and the count slider only toggles
``assimilate_this`` flags.

Counterpart of ``efa_xray_tpu/postprocess/viewer.py`` (``_run_point_efa``
:26, ``AssimilationViewer`` :74, ``assimilation_viewer`` :166): the point
assimilation runs the port's ``EnSRF`` on ``device`` (the card unless the
caller names another), and matplotlib is taken lazily.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _run_point_efa(data, var, n_obs, ob_error, inflation, max_obs, seed=0,
                   device=None):
    """Assimilate the first ``n_obs`` lead times of a point forecast.

    Returns ``(times, prior [nt, M], post [nt, M], ob_times, ob_values)``.
    The trajectory is the state vector (EFA): later lead times adjust
    through time covariances, exactly the demo's ``enkf`` (cell 11).
    """
    from efa_xray_tpu_torch import EnSRF, EnsembleState, Observation
    from efa_xray_tpu_torch.interop import to_host

    arr = data[var]  # [nt, nens]
    times = data["times"]
    state = EnsembleState.from_vardict(
        {var: arr[:, None, :]},
        {
            "validtime": times,
            "lat": np.asarray([data["lat"]]),
            "lon": np.asarray([data["lon"]]),
            "mem": np.arange(arr.shape[1]),
        },
        device=device,
    )
    rng = np.random.default_rng(seed)
    truth_like = arr.mean(axis=1)
    obs = [
        Observation(
            value=float(truth_like[i] - 1.5 + rng.normal(0, 0.3)),
            obtype=var,
            time=times[i],
            error=float(ob_error),
            lat=data["lat"],
            lon=data["lon"],
            assimilate_this=(i < n_obs),  # count slider = flag toggle only
            localize_radius=None,
        )
        for i in range(max_obs)
    ]
    filt = EnSRF(state, obs, inflation=(inflation if inflation != 1.0 else None),
                 verbose=False, loc=False)
    post, _ = filt.update()
    prior_arr = to_host(state[var])[:, 0, 0, :]
    post_arr = to_host(post[var])[:, 0, 0, :]
    used = [o for o in obs if o.assimilate_this]
    return (times, prior_arr, post_arr,
            np.asarray([o.time for o in used]),
            np.asarray([o.value for o in used]))


class AssimilationViewer:
    """Figure + state for the interactive demo; backend-agnostic core."""

    def __init__(self, data=None, var=None, n_obs=5, ob_error=1.0,
                 inflation=1.0, max_obs: Optional[int] = None, seed=0,
                 make_sliders: bool = False, device=None):
        import matplotlib.pyplot as plt

        self.device = device
        if data is None:
            from efa_xray_tpu_torch.utils.demo_data import get_ensemble_point

            var = var or "Temperature_height_above_ground_ens"
            data = get_ensemble_point(variables=[var], seed=3)
        self.data, self.var, self.seed = data, var, seed
        self.max_obs = max_obs or min(8, len(data["times"]))
        self.params = dict(n_obs=int(n_obs), ob_error=float(ob_error),
                           inflation=float(inflation))

        self.fig, self.axes = plt.subplots(1, 2, figsize=(12, 5), sharex=True)
        if make_sliders:
            self._make_sliders()
        self._draw()

    # -- core ---------------------------------------------------------------
    def update(self, n_obs=None, ob_error=None, inflation=None):
        """Re-run the assimilation with new parameters and redraw."""
        if n_obs is not None:
            self.params["n_obs"] = int(n_obs)
        if ob_error is not None:
            self.params["ob_error"] = float(ob_error)
        if inflation is not None:
            self.params["inflation"] = float(inflation)
        self._draw()

    def _draw(self):
        p = self.params
        times, prior, post, ot, ov = _run_point_efa(
            self.data, self.var, p["n_obs"], p["ob_error"], p["inflation"],
            self.max_obs, self.seed, self.device,
        )
        self.result = dict(times=times, prior=prior, post=post)
        ax0, ax1 = self.axes
        for ax in (ax0, ax1):
            ax.clear()
        ax0.plot(times, prior, color="silver", alpha=0.5, lw=0.8)
        ax0.plot(times, post, color="steelblue", alpha=0.5, lw=0.8)
        ax0.plot(times, prior.mean(1), "k--", lw=2, label="prior mean")
        ax0.plot(times, post.mean(1), color="navy", lw=2, label="post mean")
        if len(ot):
            ax0.scatter(ot, ov, color="crimson", zorder=5, label="obs")
        ax0.set_title(
            f"EFA: {p['n_obs']} obs, R={p['ob_error']:.2f}, "
            f"inflation={p['inflation']:.2f}"
        )
        ax0.set_ylabel("T [K]")
        ax0.legend(loc="upper left", fontsize=8)
        ax1.plot(times, prior.var(axis=1), "k--", label="prior var")
        ax1.plot(times, post.var(axis=1), color="navy", label="post var")
        ax1.set_title("Ensemble variance by lead time")
        ax1.legend(fontsize=8)
        self.fig.autofmt_xdate()
        self.fig.canvas.draw_idle()

    def save(self, path, dpi=110):
        self.fig.savefig(path, dpi=dpi)

    # -- matplotlib-widgets mode ---------------------------------------------
    def _make_sliders(self):
        from matplotlib.widgets import Slider

        self.fig.subplots_adjust(bottom=0.28)
        defs = [
            ("n_obs", 0, self.max_obs, self.params["n_obs"], 1),
            ("ob_error", 0.05, 4.0, self.params["ob_error"], None),
            ("inflation", 1.0, 2.5, self.params["inflation"], None),
        ]
        self._sliders = {}
        for i, (name, lo, hi, v0, step) in enumerate(defs):
            ax = self.fig.add_axes([0.15, 0.14 - 0.05 * i, 0.6, 0.03])
            s = Slider(ax, name, lo, hi, valinit=v0, valstep=step)
            s.on_changed(lambda _v, n=name: self.update(**{n: self._sliders[n].val}))
            self._sliders[name] = s


def assimilation_viewer(**kwargs):
    """Launch the viewer in the best available mode (see module docstring).

    In a notebook with ipywidgets this returns the ``interact`` handle; in
    a script it returns an :class:`AssimilationViewer` (with live sliders
    when the matplotlib backend is interactive)."""
    def _in_ipython_kernel() -> bool:
        try:
            from IPython import get_ipython

            ip = get_ipython()
            return ip is not None and type(ip).__name__ == "ZMQInteractiveShell"
        except ImportError:
            return False

    if _in_ipython_kernel():
        try:  # notebook path, matching the reference's ipywidgets cells
            from ipywidgets import interact
            import ipywidgets as widgets

            viewer = AssimilationViewer(**kwargs)
            return interact(
                viewer.update,
                n_obs=widgets.IntSlider(min=0, max=viewer.max_obs,
                                        value=viewer.params["n_obs"]),
                ob_error=widgets.FloatSlider(min=0.05, max=4.0, step=0.05,
                                             value=viewer.params["ob_error"]),
                inflation=widgets.FloatSlider(min=1.0, max=2.5, step=0.05,
                                              value=viewer.params["inflation"]),
            )
        except ImportError:
            pass
    import matplotlib

    interactive = matplotlib.get_backend().lower() not in ("agg", "pdf", "svg")
    return AssimilationViewer(make_sliders=interactive, **kwargs)
