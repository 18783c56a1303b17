"""Every ensemble and every block the JAX package runs is planned for the
card (ROADMAP queue C, fault C5), on the CPU.

Each kernel's CUDA wrapper runs on CPU tensors against a library that
records its C calls (no card, no build), and the plan it hands the kernel,
the tile, the cluster, the member slice and the sub-block, is read from
the call and held against the card: 227 KB (232,448 B) a CTA and an SM's
228 KB for the CTAs planned on it, with the 1 KB the system keeps for
each.  The JAX kernels have no member bound and take any block
(``efa_xray_tpu/ops/tiling.py`` sizes the tile from the ensemble); the
shapes here run from 2 to 1024 members and blocks of 1 to 2048 obs.  A
second test pins the plans of the shapes the kernels always took: the
tile, the whole block and every member, as before.
"""

import contextlib
import types

import pytest
import torch

from efa_xray_tpu_torch.ops import (
    ensrf_fused,
    ensrf_grid,
    letkf_gram,
    newton_schulz,
    tail_solve,
)

MAX_CTA = 232448  # shared memory a CTA may use
SM_BYTES = 233472  # an SM's shared memory
CTA_RESERVED = 1024  # what the system keeps of it for each CTA
MEMBERS = (2, 30, 80, 128, 256, 257, 300, 512, 1024)
BLOCKS = (1, 8, 64, 128, 256, 512, 1024, 2048)
BODY = [(k, m) for k in ("B2", "B2h", "B3", "B4")
        for m in ("ieee", "tf32", "bf16")] + [("B2e", "ieee"),
                                              ("B4e", "ieee")]
ROWS = 64


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda`` (LG's and NS's wrappers check
    it)."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def library(monkeypatch):
    """The wrappers' CUDA path on CPU tensors: a library that records each
    C call and returns success, no device switch, a null stream; the
    launch counts come back as they were."""
    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    for mod in (tail_solve, ensrf_fused, ensrf_grid, letkf_gram,
                newton_schulz):
        monkeypatch.setattr(mod._build, "lib", lambda: Library())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=None))
    for mod, names in ((tail_solve, ("launches", "hybrid_launches",
                                     "enkf_launches")),
                       (ensrf_fused, ("launches", "hybrid_launches",
                                      "enkf_launches")),
                       (ensrf_grid, ("b3_launches", "b4_launches",
                                     "b4e_launches")),
                       (letkf_gram, ("launches",)),
                       (newton_schulz, ("launches",))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    for mod in (ensrf_fused, ensrf_grid):
        monkeypatch.setattr(mod, "launches_by_mode",
                            {k: dict(v)
                             for k, v in mod.launches_by_mode.items()})
    return calls


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _body_plan(kernel, mode, bsz, m, calls):
    """Run ``kernel``'s wrapper over one block of ``bsz`` obs at ``m``
    members; returns ``(tile, sub-block, member slice, blocks launched)``
    as its C call hands them to the kernel."""
    enkf = kernel.endswith("e")
    z = _zeros(1, bsz, m) if enkf else None
    if kernel.startswith("B2"):
        hybrid = kernel == "B2h"
        ntab = len(ensrf_fused.TABLE_ROWS) + (
            len(ensrf_fused.HYBRID_ROWS) if hybrid else 0)
        tile = ensrf_fused.pick_tile(bsz, m, hybrid, mode)
        bits = (torch.full((-(-ROWS // tile), 1), -1, dtype=torch.int32)
                if -(-bsz // ensrf_fused.PANEL) <= 32 else None)
        ensrf_fused.fused_apply_cuda(
            _zeros(ROWS), _zeros(ROWS, m), _zeros(5 if hybrid else 4, ROWS),
            _zeros(1, bsz, m), _zeros(1, bsz, bsz), _zeros(1, ntab, bsz),
            bits, tile, True, False, False, hybrid, False, mode, z_b=z)
        (name, a), = calls
        assert name == "efa_fused_launch"
        # M, its slice, the sub-block, the blocks and the tile.
        at = (9, 10, 11, 12, 13)
    else:
        entry = "B4" if enkf else kernel
        ensrf_grid.grid_apply_cuda(
            entry, _zeros(ROWS), _zeros(ROWS, m), _zeros(1, bsz, ROWS),
            None, _zeros(1, bsz, m), _zeros(1, bsz, bsz), _zeros(1, 2, bsz),
            1, precision=mode, z_b=z)
        (name, a), = calls
        assert name == "efa_grid_launch"
        at = (12, 13, 14, 15, 16)
    got = [a[i] for i in at]
    assert got[0] == m
    return got[4], got[2], got[1], got[3]


@pytest.mark.parametrize("kernel,mode", BODY)
@pytest.mark.parametrize("bsz", BLOCKS)
@pytest.mark.parametrize("m", MEMBERS)
def test_body_plan_fits_the_card(library, kernel, mode, bsz, m):
    """B2, B2h, B2e, B3, B4 and B4e take every ensemble and every block:
    the plan the wrapper hands the kernel (the whole block, or sub-blocks
    of it in order, which cover it; every member, or slices of 32 or a
    multiple) fits a CTA, and the CTAs it plans on an SM fit it."""
    tile, sub, mslice, nb = _body_plan(kernel, mode, bsz, m, library)
    assert tile in (32, 64)
    assert sub <= bsz and nb * sub >= bsz and (nb - 1) * sub < bsz
    assert sub == bsz or sub % 8 == 0
    assert mslice == m or (mslice % 32 == 0 and mslice < m)
    if kernel.startswith("B2"):
        smem = ensrf_fused.smem_bytes(tile, sub, mslice, kernel == "B2h",
                                      mode)
        ctas = 2 if smem <= ensrf_fused.TWO_CTA_SMEM_BYTES else 1
    else:
        smem = ensrf_grid.smem_bytes(tile, sub, mslice, mode)
        ctas = ensrf_grid.ctas_per_sm(tile, sub, mslice, mode)
    assert smem <= MAX_CTA
    assert ctas >= 1 and ctas * (smem + CTA_RESERVED) <= SM_BYTES


@pytest.mark.parametrize("kind", ["B1", "B1h", "B1e"])
@pytest.mark.parametrize("p", [256, 512, 1024])
@pytest.mark.parametrize("m", MEMBERS)
def test_tail_plan_fits_the_card(library, kind, p, m):
    """B1, B1h and B1e take every ensemble at every panel the JAX package
    takes to its kernel: the cluster the wrapper hands the kernel holds
    the slab's shares in shared memory, or the slab stays in device memory
    with a scratch ring, and a CTA's shared memory fits either way."""
    hybrid, enkf = kind == "B1h", kind == "B1e"
    x = _zeros(p, m)
    kw = {}
    if hybrid:
        kw = dict(alpha=0.5, sigma=_zeros(p), static_gc=_zeros(p, p))
    if enkf:
        kw = dict(eps=_zeros(p, m))
    tail_solve.tail_panel_solve_cuda(x[:, 0], x, x[:, 0], x[:, 0],
                                     x[:, 0] > 0, **kw)
    (name, a), = library
    assert name == "efa_tail_launch"
    pp, mm, sub, c, ring = a[11], a[12], a[14], a[15], a[9]
    assert mm == m and pp % (sub * c) == 0 and p <= pp < p + sub * c
    assert c in tail_solve.CLUSTERS
    fits = tail_solve.smem_bytes(pp // c, m, sub, hybrid, enkf) <= MAX_CTA
    assert (ring is None) == fits
    smem = (tail_solve.smem_bytes(pp // c, m, sub, hybrid, enkf) if fits
            else tail_solve.smem_bytes(pp // c, m, sub, hybrid, enkf,
                                       device_slab=True))
    assert smem <= MAX_CTA and smem + CTA_RESERVED <= SM_BYTES


@pytest.mark.parametrize("kernel", ["LG", "NS"])
@pytest.mark.parametrize("m", MEMBERS)
def test_letkf_plan_fits_the_card(library, kernel, m):
    """LG and NS take every ensemble: the wrapper hands the kernel the
    ensemble as given, and a CTA's shared memory at it fits (LG: one CTA
    a unit up to 256 members, 128 x 128 blocks of A past it; NS: Y, Z and
    T in shared memory up to 136 members, in device memory past it)."""
    if kernel == "LG":
        ye = _zeros(10, m).as_subclass(_OnCard)
        letkf_gram.local_gram_cuda(ye, _zeros(10, 8), _zeros(4, 3),
                                   torch.zeros((4, 3), dtype=torch.int64))
        (name, a), = library
        assert name == "efa_letkf_gram" and a[13] == m
        smem = letkf_gram.smem_bytes(m)
    else:
        a3 = _zeros(2, m, m).as_subclass(_OnCard)
        newton_schulz.solve(a3, 30, b=_zeros(2, m).as_subclass(_OnCard))
        assert library[0] == ("efa_ns_work_floats", (2, m))
        (name, a), = library[1:]
        assert name == "efa_newton_schulz" and a[9:12] == (2, m, 30)
        smem = newton_schulz.launch_smem_bytes(m)
    assert smem <= MAX_CTA and smem + CTA_RESERVED <= SM_BYTES


# The shapes the kernels took before any ensemble and block ran, as the
# tests of their tiles pinned them: B2 (test_torch_ensrf_fused.py and
# test_torch_mode_tiles.py), B3/B4 (test_torch_mode_tiles.py) and B1
# (test_torch_tail_solve.py).
B2_TAKEN = [(128, 30), (128, 80), (128, 100), (128, 256), (64, 80),
            (100, 200)]
GRID_TAKEN = [(b, m) for b in (8, 50, 128, 200)
              for m in (12, 30, 50, 80, 128, 256)]
B1_TAKEN = [(1024, 80), (512, 256), (1024, 256)]


@pytest.mark.parametrize("mode", ["ieee", "tf32", "bf16"])
def test_shapes_taken_before_keep_their_plan(mode):
    """Every shape the kernels took before keeps its launch: the tile of
    ``pick_tile``, the whole block and every member (B2, B2h, B3, B4), the
    cluster of the slab in shared memory (B1, B1h)."""
    for hybrid in (False, True):
        for bsz, m in B2_TAKEN:
            assert ensrf_fused.plan(bsz, m, hybrid, mode) == (
                ensrf_fused.pick_tile(bsz, m, hybrid, mode), bsz, m)
    for bsz, m in GRID_TAKEN:
        if (bsz, m) == (200, 256):
            continue  # the one shape whose whole block fits no tile
        assert ensrf_grid.plan(bsz, m, mode) == (
            ensrf_grid.pick_tile(bsz, m, mode), bsz, m)
    for p, m in B1_TAKEN:
        for sub in tail_solve.SUBS:
            for hybrid in (False, True):
                c = tail_solve.pick_cluster(p, m, sub, hybrid)
                assert c == tail_solve.MIN_CLUSTER
                assert not tail_solve.in_device_memory(p, m, sub, c, hybrid)
