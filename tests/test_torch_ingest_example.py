"""The port's real-data file-ingest walkthrough
(``efa_xray_tpu_torch/examples/real_data_ingest.py``) must run end to end
on the CPU: netCDF on disk -> EnsembleState -> CLI assimilate ->
posterior + stats, with metadata preserved (the mirror of
``tests/test_ingest_example.py``); and it matches the JAX package's
script (``examples/real_data_ingest.py``) file for file, with the
conventions of ``tests/test_torch_examples.py``.
"""

import io

import numpy as np
import pandas as pd

from efa_xray_tpu_torch.examples import real_data_ingest
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from test_torch_examples import (
    _close,
    _run_jax,
    _run_port,
    _same_table,
    _same_text,
)


def test_real_data_ingest_walkthrough(tmp_path):
    rc = real_data_ingest.main(["--workdir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    # artifacts exist and the posterior kept its metadata
    post = EnsembleState.from_netcdf(str(tmp_path / "posterior.nc"),
                                     device="cpu")
    assert post.var_attrs["T2M"]["units"] == "K"
    assert "fhour" in post.extra_coords
    np.testing.assert_array_equal(post.extra_coords["fhour"][1],
                                  np.arange(8) * 6.0)
    prior = EnsembleState.from_netcdf(str(tmp_path / "gefs_like_prior.nc"),
                                      device="cpu")
    # analysis actually moved the state
    assert not np.allclose(post.data.numpy(), prior.data.numpy())


def test_real_data_ingest_matches_jax(monkeypatch, capsys, tmp_path):
    """The whole walkthrough in both packages, files included: the
    posterior files, the statistics CSV and the printed lines (the work
    directory masked); then the port's in-process ``run`` (no netCDF)
    against its file walkthrough."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    rc, jout = _run_jax(monkeypatch, capsys, "real_data_ingest",
                        ["--workdir", str(jdir)])
    assert rc == 0
    rc, pout, _ = _run_port(monkeypatch, capsys, "real_data_ingest",
                            ["--workdir", str(pdir)])
    assert rc == 0
    _same_text(jout.replace(str(jdir), "<workdir>"),
               pout.replace(str(pdir), "<workdir>"))
    for name in ("gefs_like_prior.nc", "posterior.nc"):
        got = EnsembleState.from_netcdf(str(pdir / name), device="cpu")
        want = EnsembleState.from_netcdf(str(jdir / name), device="cpu")
        _close(got.data, want.data, 32, name)
        assert got.var_attrs == want.var_attrs and got.attrs == want.attrs
    assert (pdir / "stations.csv").read_text() == (
        jdir / "stations.csv").read_text()
    stats = pd.read_csv(pdir / "stats.csv")
    _same_table(stats, pd.read_csv(jdir / "stats.csv"), 32, "stats.csv")

    args = real_data_ingest.parse_args(
        ["--device", "cpu", "--workdir", str(tmp_path / "memory")])
    res = real_data_ingest.run(args, real_data_ingest.inputs(args))
    written = pd.read_csv(io.StringIO(res["stats"].to_csv(index=False)))
    _same_table(written, stats, 32, "in-process stats")
    post = EnsembleState.from_netcdf(str(pdir / "posterior.nc"), device="cpu")
    _close(res["post"].data, post.data, 32, "in-process posterior")
