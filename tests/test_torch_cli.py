"""The port's CLI against the JAX package's: the same input files through
``efa_xray_tpu.cli.main`` and ``efa_xray_tpu_torch.cli.main([...,
"--device", "cpu"])``, each run in a directory of its own holding the
same inputs, must print the same lines and write the same posterior
netCDF, posterior obs, stats CSV, target CSV and bias JSON (float64,
1e-9).  The EnKF gets the JAX package's draws; ``--mesh`` runs the JAX
CLI on its 8 CPU devices and the port's on ``[cpu]``.  Also the
``FilterConfig.load`` repair (a config file the JAX package wrote), the
refusals (a CPU-less default device), ``--mxu-bf16`` and
``--matmul-precision`` (which ran into a refusal until the product modes
were ported) and the mirror of the CLI defaults on the port's
``FilterConfig``."""

import dataclasses
import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu import cli as jcli
from efa_xray_tpu.assimilation import enkf as jenkf
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.utils import ncio as jncio
from efa_xray_tpu_torch import cli as tcli
from efa_xray_tpu_torch.assimilation import enkf as tenkf
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.utils import ncio
from test_cli import _write_obs_csv

TOL = 1e-9


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's EnKF draws the JAX package's table for its seed."""
    def draw(seed, errors, nmems, scale=True):
        return torch.from_numpy(np.array(jenkf.draw_ob_perturbations(
            jax.random.PRNGKey(seed), jnp.asarray(errors.numpy()), nmems,
            scale=scale)))
    monkeypatch.setattr(tenkf, "draw_ob_perturbations", draw)


def _inputs(tmp_path, nvars=1, nobs=8, seed=8):
    """``tmp_path/in``: the prior state (written by the JAX package), an
    obs CSV and an obs netCDF file."""
    d = tmp_path / "in"
    d.mkdir()
    state = make_demo_state(nvars=nvars, ny=6, nx=8, nmems=16, seed=seed)
    state.save_to_disk(str(d / "prior.nc"))
    _write_obs_csv(str(d / "obs.csv"), state, nobs=nobs, seed=seed + 1)
    jncio.write_obs(str(d / "obs.nc"), JBatch.coerce(make_demo_obs(
        state, nobs=nobs, seed=seed + 2, radius=900.0)))
    return state


def _run_both(tmp_path, monkeypatch, capsys, argv, warns=None):
    """``argv`` (relative paths) through both CLIs, each in a directory
    holding a copy of ``tmp_path/in``; returns the printed lines."""
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        d = tmp_path / name
        shutil.copytree(tmp_path / "in", d, dirs_exist_ok=True)
        monkeypatch.chdir(d)
        if warns is not None and name == "torch":
            with pytest.warns(UserWarning, match=warns):
                assert main(argv + extra) == 0
        else:
            assert main(argv + extra) == 0
        out[name] = capsys.readouterr().out
    return out


def _same_nc(tmp_path, name):
    """Both packages' files ``name``: same dims, variables, dtypes and
    attrs; floats within 1e-9."""
    a = ncio.read_dataset(str(tmp_path / "jax" / name))
    b = ncio.read_dataset(str(tmp_path / "torch" / name))
    assert a.dims == b.dims
    assert list(a.variables) == list(b.variables)
    for k in a.variables:
        assert a.var_dims(k) == b.var_dims(k), k
        x, y = a[k], b[k]
        assert x.dtype == y.dtype, k
        if x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=TOL, atol=TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)
    assert a.attrs.keys() == b.attrs.keys()
    for k in a.attrs:
        np.testing.assert_array_equal(b.attrs[k], a.attrs[k])
    assert a.var_attrs == b.var_attrs


def _same_csv(tmp_path, name):
    a = pd.read_csv(tmp_path / "jax" / name)
    b = pd.read_csv(tmp_path / "torch" / name)
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in a.columns:
        if pd.api.types.is_float_dtype(a[c]):
            np.testing.assert_allclose(b[c].to_numpy(), a[c].to_numpy(),
                                       rtol=TOL, atol=TOL, err_msg=c)
        else:
            assert b[c].tolist() == a[c].tolist(), c


_OUT = ["--out", "post.nc", "--stats", "stats.csv", "--obs-out",
        "obs_post.nc", "--dtype", "float64"]

_CASES = {
    "ensrf blocked": (["--obs", "obs.csv", "--inflation", "1.05",
                       "--radius", "2000", "--bias-file", "bias.json"], {},
                      "bias correction: T2m="),
    "ensrf serial": (["--obs", "obs.csv", "--method", "serial",
                      "--radius", "2000"], {}, "assimilated 7/8"),
    "ensrf fast geometry, rtps, outlier check": (
        ["--obs", "obs.nc", "--fast-geometry", "--rtps", "0.5",
         "--outlier-threshold", "1.5", "--outlier-action", "inflate"], {},
        "R-inflated"),
    "ensrf thinned, superobbed, var-loc": (
        ["--obs", "obs.nc", "--thin-km", "100", "--superob-deg", "2.0",
         "--var-loc", "T2m:T1_2m=0.5", "--sort-spatial"], {"nvars": 2},
        "superobbed"),
    "letkf": (["--obs", "obs.csv", "--solver", "letkf", "--inflation",
               "1.05", "--radius", "2000", "--rtpp", "0.3"], {},
              "assimilated 7/8"),
    "enkf": (["--obs", "obs.nc", "--solver", "enkf", "--seed", "3",
              "--sort-spatial"], {}, "assimilated 8/8"),
    # --mesh: the JAX CLI on its 8 CPU devices, the port's on [cpu]
    "ensrf mesh": (["--obs", "obs.csv", "--radius", "2000", "--mesh",
                    "--fast-geometry"], {}, "assimilated 7/8"),
    "letkf mesh": (["--obs", "obs.nc", "--solver", "letkf", "--mesh"], {},
                   "assimilated 8/8"),
    "enkf mesh": (["--obs", "obs.csv", "--solver", "enkf", "--seed", "5",
                   "--radius", "2000", "--mesh"], {}, "assimilated 7/8"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_assimilate_matches_jax(case, tmp_path, monkeypatch, capsys,
                                jax_draws):
    args, inputs, expect = _CASES[case]
    _inputs(tmp_path, **inputs)
    out = _run_both(tmp_path, monkeypatch, capsys,
                    ["assimilate", "--state", "prior.nc"] + args + _OUT)
    assert out["torch"] == out["jax"]
    assert expect in out["torch"], out["torch"]
    _same_nc(tmp_path, "post.nc")
    _same_nc(tmp_path, "obs_post.nc")
    _same_csv(tmp_path, "stats.csv")
    if "--bias-file" in args:
        jb = json.loads((tmp_path / "jax" / "bias.json").read_text())
        tb = json.loads((tmp_path / "torch" / "bias.json").read_text())
        assert jb.keys() == tb.keys() and jb["biases"].keys()
        for t in jb["biases"]:
            assert tb["biases"][t] == pytest.approx(jb["biases"][t],
                                                    rel=TOL, abs=TOL)
        assert {k: tb[k] for k in tb if k != "biases"} == \
            {k: jb[k] for k in jb if k != "biases"}


def test_config_file_written_by_jax(tmp_path, monkeypatch, capsys):
    """``--config`` with a file the JAX package saved, naming TPU-only
    fields: the port drops them with a warning and computes what the
    JAX CLI computes; an explicit flag overrides the file in both."""
    _inputs(tmp_path)
    JConfig(outlier_threshold=1.2, use_pallas=False, small_host=False,
            dtype="float64", block_size=3).save(
                str(tmp_path / "in" / "cfg.json"))
    out = _run_both(tmp_path, monkeypatch, capsys,
                    ["assimilate", "--state", "prior.nc", "--obs", "obs.csv",
                     "--config", "cfg.json", "--radius", "2000",
                     "--rtpp", "0.4"] + _OUT,
                    warns="small_host, use_pallas")
    assert out["torch"] == out["jax"]
    assert "outlier check (t=1.2) rejected" in out["torch"]
    _same_nc(tmp_path, "post.nc")
    _same_csv(tmp_path, "stats.csv")


def test_info_verify_and_target_match_jax(tmp_path, monkeypatch, capsys):
    """``info``, ``verify`` (on the posterior obs file and on the raw CSV)
    and ``target`` (ranking and greedy, with a lat/lon box metric)."""
    _inputs(tmp_path, nobs=12)
    _run_both(tmp_path, monkeypatch, capsys,
              ["assimilate", "--state", "prior.nc", "--obs", "obs.csv",
               "--radius", "2000"] + _OUT)
    for d in ("jax", "torch"):
        for f in ("post.nc", "obs_post.nc"):
            shutil.copy(tmp_path / d / f, tmp_path / "in" / f"{d}_{f}")
    # Both CLIs read the JAX CLI's posterior files from here on.
    runs = [
        ["info", "--state", "prior.nc"],
        ["verify", "--prior", "prior.nc", "--post", "jax_post.nc", "--obs",
         "jax_obs_post.nc", "--stats", "verify.csv"],
        ["verify", "--prior", "prior.nc", "--post", "jax_post.nc", "--obs",
         "obs.csv"],
        ["target", "--state", "prior.nc", "--obs", "obs.csv", "--out",
         "rank.csv", "--metric-time-index", "-1", "--metric-lat-range",
         "43", "49", "--metric-lon-range", "232", "242"],
        ["target", "--state", "prior.nc", "--obs", "obs.csv", "--out",
         "net.csv", "--metric-time-index", "-1", "--nselect", "4"],
    ]
    printed = []
    for argv in runs:
        out = _run_both(tmp_path, monkeypatch, capsys, argv)
        assert out["torch"] == out["jax"], argv
        printed.append(out["torch"])
    assert "members    : 16" in printed[0]
    assert "Desroziers consistency" in printed[1]
    assert "using the assimilate_this flags" in printed[2]
    for name in ("verify.csv", "rank.csv", "net.csv"):
        _same_csv(tmp_path, name)
    rank = pd.read_csv(tmp_path / "torch" / "rank.csv")
    assert len(rank) == 12 and rank["qc_ok"].all()


def test_posterior_files_cross_read(tmp_path, monkeypatch, capsys):
    """The port reads the JAX CLI's posterior and the JAX package reads
    the port's, each equal to what its writer meant."""
    _inputs(tmp_path)
    _run_both(tmp_path, monkeypatch, capsys,
              ["assimilate", "--state", "prior.nc", "--obs", "obs.csv",
               "--radius", "2000"] + _OUT)
    from efa_xray_tpu.state.ensemble import EnsembleState as JState
    from efa_xray_tpu_torch import EnsembleState

    j = JState.from_netcdf(str(tmp_path / "torch" / "post.nc"),
                           dtype="float64")
    t = EnsembleState.from_netcdf(str(tmp_path / "jax" / "post.nc"),
                                  dtype="float64", device="cpu")
    np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data),
                               rtol=TOL, atol=TOL)
    assert t.structure == EnsembleState.from_netcdf(
        str(tmp_path / "torch" / "post.nc"), dtype="float64",
        device="cpu").structure


def test_refusals(tmp_path, monkeypatch, capsys):
    """``--mxu-bf16`` and ``--matmul-precision bfloat16``, refused until
    the product modes were ported, run and write the JAX CLI's files (a
    float64 update on the CPU: fp32 products in both packages); bad
    inputs and a CPU-less default device still refuse."""
    _inputs(tmp_path)
    base = ["assimilate", "--state", "prior.nc", "--obs", "obs.csv", "--out",
            "post.nc", "--device", "cpu"]
    for flag in (["--mxu-bf16"], ["--matmul-precision", "bfloat16"]):
        out = _run_both(tmp_path, monkeypatch, capsys,
                        base[:-2] + flag + _OUT)
        assert out["torch"] == out["jax"], flag
        for name in ("post.nc", "obs_post.nc"):
            _same_nc(tmp_path, name)
        _same_csv(tmp_path, "stats.csv")
    monkeypatch.chdir(tmp_path / "in")
    (tmp_path / "in" / "bad.csv").write_text("foo,bar\n1,2\n")
    with pytest.raises(SystemExit):
        tcli.main(base[:3] + ["--obs", "bad.csv", "--out", "x.nc",
                              "--device", "cpu"])
    (tmp_path / "in" / "empty.csv").write_text("value,lat,lon,time,obtype\n")
    with pytest.raises(SystemExit):
        tcli.main(base[:3] + ["--obs", "empty.csv", "--out", "x.nc",
                              "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcli.main(base + ["--var-loc", "junk"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (base[:-2], ["info", "--state", "prior.nc"]):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tcli.main(argv)


def test_cli_defaults_mirror_the_config():
    """(g): every tuning flag's default is the port's FilterConfig
    default, field for field, so --config files are overridden only by
    flags given explicitly."""
    args = tcli.build_parser().parse_args(
        ["assimilate", "--state", "a", "--obs", "b", "--out", "c"])
    defaults = {f.name: f.default for f in dataclasses.fields(FilterConfig)}
    kw = tcli.config_kwargs(args)
    assert set(kw) <= set(defaults)
    assert {k: defaults[k] for k in kw} == kw
    assert args.device == "cuda"


# --- FilterConfig.load: files of either package ---------------------------


def test_config_load_reads_a_jax_file_and_drops_tpu_fields(tmp_path):
    path = str(tmp_path / "cfg.json")
    JConfig(fast_geometry=True, use_pallas=False, tail_pallas=False,
            pallas_tile=256, small_host_threshold=10,
            outlier_threshold=3.0).save(path)
    with pytest.warns(UserWarning) as rec:
        cfg = FilterConfig.load(path)
    assert len(rec) == 1
    msg = str(rec[0].message)
    for name in ("pallas_tile", "small_host_threshold", "tail_pallas",
                 "use_pallas"):
        assert name in msg
    assert cfg.fast_geometry and cfg.outlier_threshold == 3.0
    # a port file the JAX package reads back field for field
    FilterConfig(method="serial", variable_localization={("A", "B"): 0.0},
                 rtps_alpha=0.2).save(path)
    back = JConfig.load(path)
    assert back.method == "serial" and back.rtps_alpha == 0.2
    assert back.variable_localization == {"A:B": 0.0}


@pytest.mark.parametrize("mxu_bf16", [True, False])
def test_config_load_mxu_bf16(mxu_bf16, tmp_path):
    """``mxu_bf16`` is a field of the port's config (the B2, B2h and B3
    products in bf16): ``load`` keeps it in either state, where ``true``
    raised and ``false`` was dropped with a warning before the product
    modes were ported, and the port's file carries it back to the JAX
    package."""
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump({"mxu_bf16": mxu_bf16, "fast_geometry": True}, f)
    cfg = FilterConfig.load(path)
    assert cfg.mxu_bf16 is mxu_bf16 and cfg.fast_geometry
    cfg.save(path)
    assert JConfig.load(path).mxu_bf16 is mxu_bf16
    # the JAX package's own file with the knob set: only its route field
    # is dropped
    JConfig(fast_geometry=True, use_pallas=False, mxu_bf16=mxu_bf16).save(
        path)
    with pytest.warns(UserWarning, match="use_pallas") as rec:
        cfg = FilterConfig.load(path)
    assert "dropped FilterConfig field(s) use_pallas:" in str(rec[0].message)
    assert cfg.mxu_bf16 is mxu_bf16 and cfg.fast_geometry


def test_config_load_typo_still_raises(tmp_path):
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump({"outlier_treshold": 3.0, "use_pallas": True}, f)
    with pytest.raises(ValueError, match="outlier_treshold"):
        FilterConfig.load(path)
    with open(path, "w") as f:
        json.dump([1, 2], f)
    with pytest.raises(ValueError, match="JSON object"):
        FilterConfig.load(path)
