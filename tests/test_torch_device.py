"""The port's entry points place their tensors on the card unless the
caller asks for another device; without a card and without
``device="cpu"`` they raise rather than carry on quietly on the CPU.  The
kernel wrappers make the tensors' device current around each C entry,
which sets its attributes on, and launches onto, the current device."""

import contextlib
import os
import tempfile
import types

import numpy as np
import pytest
import torch

from efa_xray_tpu_torch import AdaptiveInflation, EnsembleState, cli, interop
from efa_xray_tpu_torch.assimilation import ensrf_core
from efa_xray_tpu_torch.models import swe
from efa_xray_tpu_torch.models.cycling import CyclingHarness
from efa_xray_tpu_torch.ops import (
    _build,
    ensrf_fused,
    ensrf_grid,
    precision_probe,
    tail_solve,
)
from efa_xray_tpu_torch.state.ensemble import default_device
from efa_xray_tpu_torch.utils import demo_data, ncio


def _fields():
    rng = np.random.default_rng(0)
    times = np.array([np.datetime64("2026-08-01T00")])
    lon, lat = np.meshgrid(np.linspace(0, 20, 5), np.linspace(30, 40, 4))
    data = {"T2m": rng.normal(280, 3, (1, 4, 5, 6))}
    return data, {"validtime": times, "lat": lat, "lon": lon}


def _obs_kw():
    return dict(values=np.ones(3), errors=np.ones(3), lats=np.zeros(3),
                lons=np.zeros(3), radii=np.full(3, 500.0),
                assim=np.ones(3, bool))


def _tail_kw():
    z = np.zeros(3)
    return dict(ye=np.zeros((3, 2)), gain_coef=z, sqrt_coef=z, tail_mean=z,
                tail_perts=np.zeros((3, 2)), prior_mean=z, prior_var=z,
                post_mean=z, post_var=z, assimilated=np.ones(3, bool))


def _with_state_file(fn):
    """``fn(path)`` on a small state file in a temporary directory."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.nc")
        EnsembleState.from_vardict(*_fields(), device="cpu").save_to_disk(
            path)
        return fn(path)


def _cli_info(**kw):
    argv = ["--device", kw["device"]] if kw else []
    return _with_state_file(
        lambda p: (cli.main(["info", "--state", p] + argv),))


_ENTRY_POINTS = {
    "from_vardict numpy": lambda **kw: EnsembleState.from_vardict(
        *_fields(), **kw),
    "from_vardict tensors": lambda **kw: EnsembleState.from_vardict(
        {k: torch.from_numpy(v) for k, v in _fields()[0].items()},
        _fields()[1], **kw),
    "state_from_numpy": lambda **kw: interop.state_from_numpy(*_fields(),
                                                              **kw),
    "obs_arrays_from_numpy": lambda **kw: interop.obs_arrays_from_numpy(
        **_obs_kw(), **kw),
    "tail_solution_from_numpy": lambda **kw:
        interop.tail_solution_from_numpy(**_tail_kw(), **kw),
    "precision_probe.probe": lambda **kw: precision_probe.probe(
        n=16, k=16, time_n=16, reps=1, **kw),
    "CyclingHarness": lambda **kw: (CyclingHarness(
        forecast=lambda x: x, state_lats=np.zeros(3),
        state_lons=np.arange(3.0), **kw)._tensor(np.zeros((2, 3))),),
    "swe.initial_state": lambda **kw: tuple(
        swe.initial_state(4, 8, **kw).values()),
    "swe.spinup_ensemble": lambda **kw: tuple(swe.spinup_ensemble(
        ny=4, nx=8, nmems=2, spinup_steps=1, member_steps=1, **kw)[1].values()),
    "fields_from_numpy": lambda **kw: tuple(interop.fields_from_numpy(
        _fields()[0], **kw).values()),
    "flat_ensemble_from_numpy": lambda **kw: (
        interop.flat_ensemble_from_numpy(np.zeros((2, 3)), **kw),),
    "from_netcdf": lambda **kw: _with_state_file(
        lambda p: EnsembleState.from_netcdf(p, **kw)),
    "ncio.read_state": lambda **kw: _with_state_file(
        lambda p: ncio.read_state(p, **kw)),
    "demo_data.gefs_like_state": lambda **kw: demo_data.gefs_like_state(
        ntimes=1, ny=3, nx=4, nmems=2, **kw)[0],
    "cli.main": _cli_info,
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_without_a_card_no_device_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_device_cpu_runs_on_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = _ENTRY_POINTS[name](device="cpu")
    tensors = {
        EnsembleState: lambda o: [o.data],
        dict: lambda o: [],
    }.get(type(out), lambda o: [t for t in o if isinstance(t, torch.Tensor)])
    for t in tensors(out):
        assert t.device.type == "cpu"


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_adaptive_inflation_from_fields_defaults_to_the_card(monkeypatch):
    """``AdaptiveInflation.from_fields`` updates on the card unless asked
    for another device; ``interop.adaptive_inflation_from_numpy`` keeps
    passing the state's device."""
    state = EnsembleState.from_vardict(*_fields(), device="cpu")
    fields = {"T2m": np.ones((1, 4, 5))}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AdaptiveInflation.from_fields(state.structure, fields, fields)
    adapt = AdaptiveInflation.from_fields(state.structure, fields, fields,
                                          device="cpu")
    assert adapt.device == torch.device("cpu")
    assert interop.adaptive_inflation_from_numpy(
        state, fields, fields).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert AdaptiveInflation.from_fields(
        state.structure, fields, fields).device == torch.device("cuda")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: P's wrapper checks it."""

    @property
    def is_cuda(self):
        return True


def _launch(wrapper):
    """Call ``wrapper``'s CUDA entry on small float32 CPU tensors (the
    fake library below never reads them)."""
    f = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    if wrapper == "B1":
        tail_solve.tail_panel_solve_cuda(
            f(8), f(8, 4), f(8), torch.ones(8), torch.ones(8, dtype=bool))
    elif wrapper == "B2":
        ensrf_fused.fused_apply_cuda(
            f(32), f(32, 4), f(4, 32), f(1, 8, 4), f(1, 8, 8),
            f(1, len(ensrf_fused.TABLE_ROWS), 8), None, 32, True, False,
            False)
    elif wrapper in ("B3", "B4"):
        ensrf_grid.grid_apply_cuda(wrapper, f(32), f(32, 4), f(1, 8, 16),
                                   None, f(1, 8, 4), f(1, 8, 8), f(1, 2, 8),
                                   vt=2)
    elif wrapper == "occupancy":
        ensrf_grid.ctas_per_sm_on_card(64, 8, 4, device=torch.device("cpu"))
    else:
        a = f(16, 16).as_subclass(_OnCard)
        precision_probe.mm_cuda(a, a, "ieee")


def _keep_counts(monkeypatch):
    """The launch counters come back as they were: other tests read
    them."""
    for mod, names in ((tail_solve, ("launches", "hybrid_launches")),
                       (ensrf_fused, ("launches", "hybrid_launches")),
                       (ensrf_grid, ("b3_launches", "b4_launches",
                                     "b4e_launches")),
                       (precision_probe, ("launches",))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(precision_probe, "launches_by_mode",
                        dict(precision_probe.launches_by_mode))
    monkeypatch.setattr(ensrf_grid, "b4_weight_source",
                        dict(ensrf_grid.b4_weight_source))
    for mod in (ensrf_fused, ensrf_grid):
        monkeypatch.setattr(mod, "launches_by_mode",
                            {k: dict(v) for k, v in
                             mod.launches_by_mode.items()})


@pytest.mark.parametrize("wrapper", ["B1", "B2", "B3", "B4", "occupancy",
                                     "P"])
def test_kernel_wrappers_enter_the_tensors_device(wrapper, monkeypatch):
    """Each wrapper calls its C entry with the tensors' device current
    (``torch.cuda.device`` entered, not yet left), so that a launch on a
    second card sets its attributes on, and runs on, that card."""
    current = []
    calls = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, list(current)))
                return 2 if name == "efa_grid_ctas_per_sm" else 0
            return entry

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    monkeypatch.setattr(_build, "lib", lambda: Library())
    _keep_counts(monkeypatch)
    _launch(wrapper)
    assert len(calls) == 1 and not current
    assert calls[0][1] == [torch.device("cpu")], calls


@pytest.mark.parametrize("config,enkf", [("default", False),
                                         ("default", True),
                                         ("fast_geometry", False),
                                         ("unlocalized", False),
                                         ("default, VT > 1", False)])
def test_b4_block_reaches_the_entry_with_its_weight_source(config, enkf,
                                                           monkeypatch):
    """A default-config B4 (and B4e) block of ``blocked_body`` on the card
    reaches ``efa_grid_launch`` with a null ``w`` and the geometry
    pointers; a ``fast_geometry`` block, or one over VT > 1 groups, with
    ``w`` and no geometry, an unlocalized one with neither;
    ``b4_weight_source`` counts each launch by its source."""
    calls = []

    class Library:
        def efa_grid_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    monkeypatch.setattr(_build, "lib", lambda: Library())
    _keep_counts(monkeypatch)
    before = dict(ensrf_grid.b4_weight_source)
    f = lambda *shape: torch.rand(shape, dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(
                                      len(shape))).as_subclass(_OnCard)
    rows, b, m = 40, 8, 4
    vt = 2 if config == "default, VT > 1" else 1
    tail = ensrf_core.TailSolution(ye=f(b, m), gain_coef=f(b),
                                   sqrt_coef=f(b), tail_mean=None,
                                   tail_perts=None, diags=None)
    obs = ensrf_core.ObsArrays(
        values=f(b), errors=f(b), lats=90.0 * f(b), lons=360.0 * f(b),
        radii=1000.0 + f(b), assim=torch.ones(b, dtype=torch.bool))
    ensrf_grid.blocked_body(
        f(rows), f(rows, m), 90.0 * f(rows), 360.0 * f(rows), tail, obs,
        localize=config != "unlocalized",
        fast_geometry=config == "fast_geometry", block_size=b,
        ngrid=rows // vt, apply_rows=f(b, m) if enkf else None)
    assert len(calls) == 1
    args = calls[0]
    w, pgeo, ogeo = args[2], args[8], args[9]
    source = {"default": "kernel", "fast_geometry": "w",
              "unlocalized": "none", "default, VT > 1": "w"}[config]
    assert (w is not None) == (source == "w")
    assert (pgeo is not None) == (ogeo is not None) == (source == "kernel")
    assert (args[5] is not None) == enkf  # B4e's apply rows
    assert args[10:13] == (vt, rows // vt, m)  # VT, G, M
    counted = {k: v - before[k]
               for k, v in ensrf_grid.b4_weight_source.items()}
    assert counted == {k: int(k == source) for k in counted}
