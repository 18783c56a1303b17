"""LG (the LETKF chunk's local precision, Gram and right-hand side) and the
chunk loop built on it, against the JAX package on the CPU.

LG's plain version (``ops/letkf_gram.py``) is held against the JAX
package's own weights and einsums (its ``one`` closures in
``solve_patch_weights`` and ``_analyze_body_chunked``, rebuilt here from
its localization functions), and the rebuilt chunk loop against
``solve_patch_weights`` and ``letkf_update`` (``_analyze_body_chunked``)
in five cases: horizontal, vertical, varloc, unlocalized and a padded last
chunk, with top-k exact and host.  Float64 at 1e-9; float32 at the f32
kernel gate, rtol 2e-5 / atol 2e-4 (``tests/test_pallas_kernel.py``'s, the
gate ``chip_smoke.py`` holds every kernel to: ``test_torch_letkf.py``
itself compares in float64 only).  Then the wrappers of LG and NS: they
refuse what their kernels do not take before any launch, and count one
launch a chunk and a solve whatever the iterations."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.assimilation import letkf_core as jl
from efa_xray_tpu.observation import localization as jloc
from efa_xray_tpu_torch.assimilation import letkf_core as tl
from efa_xray_tpu_torch.ops import letkf_gram as lg
from efa_xray_tpu_torch.ops import newton_schulz as ns
from test_torch_letkf import _close, _solve_inputs, _toy

F32 = dict(rtol=2e-5, atol=2e-4)
CASES = ("horizontal", "vertical", "varloc", "unlocalized", "padded")


def _case_kw(case, extra):
    if case == "vertical":
        return {k: extra[k] for k in ("patch_verts", "obs_verts",
                                      "obs_vert_radii")}
    if case == "varloc":
        return {k: extra[k] for k in ("varloc", "obs_var", "patch_var")}
    return {}


def _jax_gram(arrays, idx, localize, kw):
    """``(A, b)`` of every patch as the JAX package's ``one`` forms them,
    from its own localization functions."""
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    ii = jnp.asarray(idx)
    ye = j["ye"]
    nens = ye.shape[1]
    yl = ye[ii]
    a = j["rinv"][ii]
    if localize:
        rho = jloc.chordal_gc_weights(j["patch_xyz"][:, None, :],
                                      j["obs_xyz"][ii], j["obs_radii"][ii])
        if "patch_verts" in kw:
            rho = rho * jloc.gaspari_cohn(
                jnp.abs(jnp.asarray(kw["patch_verts"])[:, None]
                        - jnp.asarray(kw["obs_verts"])[ii]),
                jnp.asarray(kw["obs_vert_radii"])[ii])
        a = a * rho
    if "varloc" in kw:
        vl = jnp.asarray(kw["varloc"])
        a = a * jnp.take_along_axis(vl.T[jnp.asarray(kw["patch_var"])],
                                    jnp.asarray(kw["obs_var"])[ii], axis=1)
    ya = yl * a[..., None]
    amat = (nens - 1) * jnp.eye(nens) + jnp.einsum("ckm,ckn->cmn", ya, yl)
    b = jnp.einsum("ckm,ck->cm", ya, j["innov"][ii])
    return np.asarray(amat), np.asarray(b)


@pytest.mark.parametrize("case", CASES[:4])
def test_lg_plain_matches_the_jax_weights_and_gram(case):
    """LG's plain version is the JAX package's ``a``, ``A`` and ``b``."""
    arrays, idx, extra = _solve_inputs()
    kw = _case_kw(case, extra)
    localize = case != "unlocalized"
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    amat, b = lg.local_gram_plain(
        t["ye"], t["innov"], t["rinv"], t["obs_xyz"], t["obs_radii"],
        t["patch_xyz"], torch.from_numpy(idx), localize=localize,
        pv=(torch.from_numpy(kw["patch_verts"]) if "patch_verts" in kw
            else None),
        obs_verts=(torch.from_numpy(kw["obs_verts"]) if "obs_verts" in kw
                   else None),
        obs_vert_radii=(torch.from_numpy(kw["obs_vert_radii"])
                        if "obs_vert_radii" in kw else None),
        vlm_t=(torch.from_numpy(kw["varloc"]).T if "varloc" in kw else None),
        uv=torch.from_numpy(kw["patch_var"]) if "patch_var" in kw else None,
        obs_var=torch.from_numpy(kw["obs_var"]) if "obs_var" in kw else None)
    want = _jax_gram(arrays, idx, localize, kw)
    _close(amat, want[0])
    _close(b, want[1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("sqrt", ["newton_schulz", "eigh"])
@pytest.mark.parametrize("case", CASES)
def test_solve_patch_weights_matches_jax(case, sqrt, dtype):
    """The rebuilt chunk loop (LG's plain version, then the solve) in
    ``solve_patch_weights``: chunks of 5 over 20 patches, and over 23 (the
    last chunk padded)."""
    arrays, idx, extra = _solve_inputs(npatch=23 if case == "padded"
                                       else 20)
    chunk = 5
    kw = _case_kw(case, extra)
    np_dt = np.dtype(dtype)
    args = [arrays[k].astype(np_dt) for k in (
        "ye", "innov", "rinv", "obs_xyz", "obs_radii", "patch_xyz")] + [idx]
    kw = {k: (v.astype(np_dt) if v.dtype.kind == "f" else v)
          for k, v in kw.items()}
    localize = case != "unlocalized"
    want = jl.solve_patch_weights(
        *[jnp.asarray(a) for a in args], localize=localize, sqrt_method=sqrt,
        chunk=chunk, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tl.solve_patch_weights(
        *[torch.from_numpy(a) for a in args], localize=localize,
        sqrt_method=sqrt, chunk=chunk,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.wbar.dtype == getattr(torch, dtype)
    if dtype == "float64":
        _close(got.wbar, want.wbar)
        _close(got.transform, want.transform)
    else:
        np.testing.assert_allclose(got.wbar.numpy(), np.asarray(want.wbar),
                                   **F32)
        np.testing.assert_allclose(got.transform.numpy(),
                                   np.asarray(want.transform), **F32)


def _update_case(case, dtype):
    """``(jargs, targs, kw)`` of one ``letkf_update`` case."""
    ngrid, vt = 60, 2
    jargs, targs, _ = _toy(ngrid=ngrid, vt=vt, nmems=12, nobs=9, seed=3,
                           radius=2500.0)
    kw = dict(k_obs=5, patch_size=2, chunk=8)
    if case == "padded":
        kw.update(patch_size=4, chunk=4)  # 15 patches: the last chunk of 4
    if case == "unlocalized":
        kw.update(localize=False)
    if case == "vertical":
        rng = np.random.default_rng(5)
        verts = rng.uniform(300, 900, 9)
        body = np.repeat([500.0, 850.0], ngrid)
        for args, arr in ((jargs, jnp.asarray), (targs, torch.from_numpy)):
            args[6] = args[6]._replace(verts=arr(verts),
                                       vert_radii=arr(np.full(9, 250.0)))
        kw.update(vertical=True)
        kw["body_vert"] = body
    if case == "varloc":
        rng = np.random.default_rng(9)
        kw.update(varloc=rng.uniform(0, 1, (vt + 1, vt)),
                  ob_var=rng.integers(0, vt, 9), group_var=np.arange(vt))
    cast = (lambda x: x) if dtype == "float64" else (
        lambda x: x.astype(np.float32))
    jargs = [jnp.asarray(cast(np.asarray(a))) for a in jargs[:6]] + [
        jargs[6]._replace(**{f: jnp.asarray(cast(np.asarray(v)))
                             for f, v in jargs[6]._asdict().items()
                             if v is not None and np.asarray(v).dtype.kind
                             == "f"})]
    targs = [torch.from_numpy(cast(a.numpy())) for a in targs[:6]] + [
        targs[6]._replace(**{f: torch.from_numpy(cast(v.numpy()))
                             for f, v in targs[6]._asdict().items()
                             if v is not None and v.is_floating_point()})]
    return jargs, targs, kw


def _host_selection(targs, kw):
    """The certified candidates of the toy's grid (``sel_cand``,
    ``sel_mask``, ``sel_group``)."""
    cand, mask, group = tl.host_select_candidates(
        targs[4].double().numpy(), targs[5].double().numpy(), 60,
        kw["patch_size"], targs[6].lats.double().numpy(),
        targs[6].lons.double().numpy(), kw["k_obs"], chunk=kw["chunk"])
    return cand, mask, group


UPDATE_CASES = [(c, t) for c in CASES for t in ("exact", "host")
                if t == "exact" or c in ("horizontal", "padded")]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case,topk", UPDATE_CASES)
def test_letkf_update_matches_jax(case, topk, dtype):
    """The rebuilt chunk loop through ``letkf_update``: the body sweep
    (``_analyze_body_chunked``) and the obs-space solve
    (``solve_patch_weights``), top-k exact and host."""
    jargs, targs, kw = _update_case(case, dtype)
    jkw, tkw = dict(kw), dict(kw)
    for name in ("body_vert", "varloc", "ob_var", "group_var"):
        if name in kw:
            v = kw[name]
            if v.dtype.kind == "f" and dtype == "float32":
                v = v.astype(np.float32)
            jkw[name], tkw[name] = jnp.asarray(v), torch.from_numpy(v)
    if topk == "host":
        cand, mask, group = _host_selection(targs, kw)
        jkw.update(topk_method="host", sel_cand=jnp.asarray(cand),
                   sel_mask=jnp.asarray(mask), sel_group=group)
        tkw.update(topk_method="host", sel_cand=torch.from_numpy(cand),
                   sel_mask=torch.from_numpy(mask), sel_group=group)
    want = jl.letkf_update(*jargs, ngrid=60, **jkw)
    got = tl.letkf_update(*targs, ngrid=60, **tkw)
    for i in range(4):
        if dtype == "float64":
            _close(got[i], want[i])
        else:
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                       **F32)
    if case == "vertical":
        assert kw["vertical"]


def test_chunk_solver_reuses_its_buffers_only_when_asked():
    """The sweep's solver writes every chunk into the same outputs (each
    chunk is applied before the next is solved); the obs-space solve keeps
    each chunk's weights."""
    arrays, idx, _ = _solve_inputs()
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    ii = torch.from_numpy(idx)
    kw = dict(localize=True, sqrt_method="newton_schulz", ns_iters=30)
    fresh = tl._ChunkSolver(t["ye"], t["innov"], t["rinv"], t["obs_xyz"],
                            t["obs_radii"], **kw)
    assert fresh.bufs is None and not fresh.kernel and fresh.table is None
    reused = tl._ChunkSolver(t["ye"], t["innov"], t["rinv"], t["obs_xyz"],
                             t["obs_radii"], reuse=True, **kw)
    for s in (slice(0, 5), slice(5, 10)):
        a = fresh(t["patch_xyz"][s], ii[s])
        b = reused(t["patch_xyz"][s], ii[s])
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert reused.bufs == {}  # the plain route allocates as it goes


def test_obs_table_packs_one_row_an_ob():
    arrays, _, extra = _solve_inputs()
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tab = lg.obs_table(t["obs_xyz"], t["obs_radii"], t["rinv"], t["innov"])
    assert tab.dtype == torch.float32 and tuple(tab.shape) == (30, 8)
    np.testing.assert_array_equal(tab[:, 6:].numpy(), 0.0)
    np.testing.assert_array_equal(
        tab[:, 5].numpy(), arrays["innov"].astype(np.float32))
    tab = lg.obs_table(t["obs_xyz"], t["obs_radii"], t["rinv"], t["innov"],
                       torch.from_numpy(extra["obs_verts"]),
                       torch.from_numpy(extra["obs_vert_radii"]))
    np.testing.assert_array_equal(
        tab[:, 6].numpy(), extra["obs_verts"].astype(np.float32))


@pytest.fixture
def no_library(monkeypatch):
    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(lg._build, "lib", no_build)
    monkeypatch.setattr(ns._build, "lib", no_build)


def test_lg_wrapper_refuses_before_building(no_library, monkeypatch):
    """LG's wrapper raises on a CPU tensor and on float64 before it asks
    for the library (at 257 members for the device alone); past that check
    an ensemble of 257 or 1024 members is planned: the C call gets it as
    given, with outputs of its size."""
    before = lg.launches
    for m, dtype in ((8, torch.float32), (8, torch.float64),
                     (257, torch.float32)):
        ye = torch.zeros((10, m), dtype=dtype)
        tab = torch.zeros((10, 8))
        with pytest.raises(ValueError, match="on a CUDA device"):
            lg.local_gram_cuda(ye, tab, torch.zeros((4, 3)),
                               torch.zeros((4, 3), dtype=torch.int64))
    assert lg.launches == before
    fake = _FakeLib()
    monkeypatch.setattr(lg._build, "lib", lambda: fake)
    monkeypatch.setattr(lg, "launches", lg.launches)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(lg, "check", lambda ye: None)
    for m in (257, 1024):
        amat, b = lg.local_gram_cuda(torch.zeros((10, m)), tab,
                                     torch.zeros((4, 3)),
                                     torch.zeros((4, 3), dtype=torch.int64))
        assert tuple(amat.shape) == (4, m, m) and tuple(b.shape) == (4, m)
        (name, args), = fake.calls[-1:]
        assert name == "efa_letkf_gram" and args[11:15] == (4, 3, m, 1)


def test_ns_solve_refuses_before_building(no_library, monkeypatch):
    """NS's ``solve`` raises on a CPU tensor and on float64 before it asks
    for the library (at 257 members for the device alone); past that
    check 257 and 1024 members are planned: the work buffer and the C call
    take the ensemble as given."""
    before = ns.launches
    for a in (torch.eye(4, dtype=torch.float64)[None], torch.eye(4)[None],
              torch.eye(257)[None]):
        with pytest.raises(ValueError, match="on a CUDA device"):
            ns.solve(a, 30, b=torch.zeros(a.shape[:2], dtype=a.dtype))
    assert ns.launches == before
    fake = _FakeLib()
    monkeypatch.setattr(ns._build, "lib", lambda: fake)
    monkeypatch.setattr(ns, "launches", ns.launches)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(ns, "check", lambda a, b=None: None)
    for m in (257, 1024):
        a = torch.eye(m)[None]
        ns.solve(a, 30, b=torch.zeros((1, m)))
        assert fake.calls[-2] == ("efa_ns_work_floats", (1, m))
        assert fake.calls[-1][0] == "efa_newton_schulz"
        assert fake.calls[-1][1][9:12] == (1, m, 30)


class _FakeLib:
    """Stands in for the kernel library: records each C call's arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA path on CPU tensors: a fake library, no device
    switch, a null stream, and no device check."""
    fake = _FakeLib()
    for mod in (lg, ns):
        monkeypatch.setattr(mod._build, "lib", lambda: fake)
        # The fake launches leave the modules' counts as they found them.
        monkeypatch.setattr(mod, "launches", mod.launches)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(ns, "check", lambda a, b=None: None)
    monkeypatch.setattr(lg, "check", lambda ye: None)
    return fake


@pytest.mark.parametrize("m", [1, 40, 80, 136, 137, 200, 256])
def test_ns_launches_once_a_solve_whatever_the_iterations(fake_card, m):
    """NS is one cooperative launch a solve: its count grows by
    ``LAUNCHES_PER_SOLVE`` (1) a solve at every width and cap (the
    previous design: 2 + the cap, twice the cap past 136 members), and
    its work buffer is the size the library's ``efa_ns_work_floats`` asks
    for."""
    assert ns.LAUNCHES_PER_SOLVE == 1
    a = torch.eye(m).expand(3, m, m).contiguous()
    b = torch.zeros((3, m))
    for iters in (0, 7, 30):
        before = ns.launches
        fake_card.calls.clear()
        ns.solve(a, iters, b=b, scale=2.0, wbar_out=torch.empty_like(b))
        assert ns.launches - before == ns.LAUNCHES_PER_SOLVE
        assert fake_card.calls[0] == ("efa_ns_work_floats", (3, m))
        (name, args), = fake_card.calls[1:]
        assert name == "efa_newton_schulz"
        assert args[3] is not None and args[9:12] == (3, m, iters)
        assert args[14] == np.float32(2.0)
    with pytest.raises(ValueError, match="outputs"):
        ns.solve(a, 30, out=torch.empty((3, m, m), dtype=torch.float64))
    ws = {}
    ns.solve(a, 30, ws=ws)
    assert fake_card.calls[-1][1][3] is None  # no wbar without b
    assert ws["work"].numel() == 0  # the fake library's answer
    assert ws["scratch"].numel() == 32 and ws["scratch"].dtype == torch.int32


def test_lg_launches_once_a_chunk(fake_card):
    """LG is one launch a chunk; the C call gets the chunk's shape, the
    vertical and varloc operands only where given."""
    ye = torch.zeros((10, 12))
    tab = torch.zeros((10, 8))
    px, ii = torch.zeros((4, 3)), torch.zeros((4, 5), dtype=torch.int64)
    before = lg.launches
    amat, b = lg.local_gram_cuda(ye, tab, px, ii)
    assert lg.launches - before == lg.LAUNCHES_PER_CHUNK == 1
    assert tuple(amat.shape) == (4, 12, 12) and tuple(b.shape) == (4, 12)
    (name, args), = fake_card.calls
    assert name == "efa_letkf_gram"
    assert args[2] is None and args[3] is None and args[6] is None
    assert args[11:15] == (4, 5, 12, 1)
    lg.local_gram_cuda(ye, tab, px, ii, localize=False,
                       pv=torch.zeros(4), vlm_t=torch.zeros((2, 3)),
                       uv=torch.zeros(4, dtype=torch.int64),
                       obs_var=torch.zeros(10, dtype=torch.int64))
    _, args = fake_card.calls[-1]
    assert args[4] == 3 and args[6] is not None and args[14] == 0
    with pytest.raises(ValueError, match="together"):
        lg.local_gram_cuda(ye, tab, px, ii, vlm_t=torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="int64"):
        lg.local_gram_cuda(ye, tab, px, ii.int())
    with pytest.raises(ValueError, match="outputs"):
        lg.local_gram_cuda(ye, tab, px, ii, amat=torch.empty((4, 12, 11)))


def test_ns_smem_bytes_splits_the_variants_at_136():
    """The shared memory of the shared-memory variant (Y, Z and T, rows
    padded by 4 floats): widths padded to 4, to 8 past 128, and every width
    up to 136 fits a CTA beside the kernel's 1 KiB of static tables, where
    the device-memory variant takes over."""
    assert ns.smem_bytes(80) == 3 * 80 * 84 * 4
    assert ns.smem_bytes(30) == 3 * 32 * 36 * 4
    assert ns.smem_bytes(129) == 3 * 136 * 140 * 4
    for m in range(1, 257):
        assert (ns.smem_bytes(m) + 1024 <= ns.MAX_SMEM_BYTES) == (m <= 136)
