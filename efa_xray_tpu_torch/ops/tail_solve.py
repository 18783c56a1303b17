"""B1, B1h and B1e: serial solve of one observation-space tail panel.

Counterpart of ``efa_xray_tpu/ops/tail_solve_pallas.py``
(``tail_panel_solve_pallas`` :161, kernel ``_make_tail_solve_kernel`` :46).
:func:`tail_panel_solve` launches the CUDA kernel of
``efa_xray_tpu_torch/csrc/tail_solve.cu`` on CUDA tensors and runs
:func:`tail_panel_solve_plain`, the same computation in plain torch, on CPU
tensors.  Outputs mean exactly what ``ensrf_core.tail_scan`` gives on the
panel when ``weights[i, j]`` is ob i's localization weight at panel row j
(chordal or haversine Gaspari-Cohn, times the vertical and cross-variable
factors), with the post-update diagnostics in closed form: row i right
after ob i is ``(1 - beta kmat_i) ye``.

B1h, the hybrid instantiation (``alpha < 1``, as B2h is B2's), adds the
static column of ``tail_scan``: ``varye = alpha varye_ens + (1 - alpha)
sigma_i^2``, ``kmat_j = alpha kmat_ens_j + (1 - alpha) sigma_j sigma_i
static_gc[i, j] / kdenom``, the ensemble coefficients scaled by ``alpha``,
and two more outputs, the static-column scalars ``static_gain`` and
``static_sqrt``.

B1e, the stochastic EnKF's instantiation (``eps`` given), solves
``enkf.enkf_tail_scan`` on the panel: each ob's full gain (no beta) is
applied to its departure row ``z_i = ye - eps[i]``, ``sqrt_coef = scale``,
the posterior variance is the updated row's own, and the ``z`` rows are a
tenth output.  The JAX package runs that scan as a ``lax.scan``, with no
Pallas kernel.

The kernel's design (its source's header says more).  What bounds a serial
panel solve on one SM is the chain of steps, not arithmetic: one thread
per row takes three CTA barriers and a warp-0 reduction per ob, and
streams the whole [P, M] slab through shared memory twice per ob.  The
kernel solves sub-panels of ``sub`` obs (8; 16 in a timing build)
instead: one warp runs the serial problem on the sub-panel's own rows in
registers and shuffles, and every other row takes one rank-``sub`` update
(``_block_recurrence`` of ``ensrf_core`` inside the panel).  The rows are
dealt over a thread-block cluster of 1, 2, 4 or 8 CTAs (8 unless the
caller asks: :func:`pick_cluster`); the owner of a sub-panel writes its
``ye`` rows, Gram matrix and coefficients into every CTA's shared memory.
Any panel up to ``MAX_PANEL`` obs runs at any ensemble: past 256 members
the warp's solve takes its sums over chunks of 256 members, and where no
cluster holds its shares of the slab (:func:`in_device_memory`) the rows
stay in device memory, each CTA's own, and the sub-panel's rows, Gram
matrix and coefficients go through a scratch ring there
(:func:`ring_floats`) instead of into every CTA.
:func:`tail_panel_solve_subpanel_plain` mirrors that order of operations
in plain torch (the tests hold it against the serial plain version).
:func:`smem_bytes` mirrors the kernel's ``make_layout``.
"""

from __future__ import annotations

import threading

import torch

from efa_xray_tpu_torch.assimilation.ensrf_core import _pad
from efa_xray_tpu_torch.ops import _build

# Launches of the CUDA kernel (not of the plain version), pure ensemble
# (B1), hybrid (B1h) and stochastic EnKF (B1e).
launches = 0
hybrid_launches = 0
enkf_launches = 0
# Guards the counters against launches from several threads.
_count_lock = threading.Lock()

# Largest dynamic shared memory a CTA may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448
# Largest panel the kernel takes: the JAX package's panel bound
# (``ensrf_core.py:659``).
MAX_PANEL = 1024
# Sub-panel widths the kernel's source has, the one the library is built
# for (16 only in a build with -DEFA_TAIL_SUB16=1, which chip_smoke.py
# --steps times: slower than 8 at every shape measured), and the cluster
# sizes it launches (csrc/tail_solve.cu).
SUBS = (8, 16)
DEFAULT_SUB = 8
CLUSTERS = (1, 2, 4, 8)
# Smallest cluster the wrapper picks: the rows of a panel that fits one
# CTA are still dealt over this many CTAs (at 512 x 80 on the card, 8 CTAs
# took 1.00 ms against 1.30-1.37 ms on one; PERF.md section 6).
MIN_CLUSTER = 8
# Per-ob scalars the sub-panel's owner writes for the rank update: gain,
# sqrt_coef and the two static-column scalars (kCoef).
COEF_ROWS = 4
SLOTS = 2


def _check_hybrid(alpha, sigma, static_gc, eps=None):
    hybrid = alpha < 1.0
    if hybrid and (sigma is None or static_gc is None):
        raise ValueError("B1h (alpha < 1) needs sigma and static_gc")
    if hybrid and eps is not None:
        raise ValueError("B1e (eps) does not combine with hybrid covariance")
    return hybrid


def tail_panel_solve_plain(tail_mean, tail_perts, values, errors, assim,
                           weights=None, unbiased: bool = False,
                           alpha: float = 1.0, sigma=None, static_gc=None,
                           eps=None):
    """Plain-torch B1, serial: ``(tm, tp, ye, gain, sqrt, pm, pv, om,
    ov)``, and with ``alpha < 1`` (B1h) also ``(static_gain,
    static_sqrt)``, with ``eps [P, M]`` (B1e) also the departure rows
    ``z``.  ``weights[i, j]`` is the weight of ob i at panel row j (None =
    no localization); ``sigma [P]`` the static std of each row,
    ``static_gc[i, j]`` the static correlation of ob i with row j."""
    p, m = tail_perts.shape
    dtype = tail_perts.dtype
    hybrid = _check_hybrid(alpha, sigma, static_gc, eps)
    enkf = eps is not None
    vden = (m - 1) if unbiased else m
    tm = tail_mean.to(dtype).clone()
    tp = tail_perts.clone()
    vals = values.to(dtype)
    errs = errors.to(dtype)
    f_all = assim.to(dtype)
    if hybrid:
        sig = sigma.to(dtype)
        gc = static_gc.to(dtype)
    if enkf:
        eps = eps.to(dtype)
    nan = torch.full((), float("nan"), dtype=dtype, device=tp.device)
    outs = [[] for _ in range(9)]
    zs = []
    for i in range(p):
        ye = tp[i].clone()
        mye = tm[i]
        mu = torch.sum(ye) / m
        var_ens = torch.sum((ye - mu) ** 2) / vden
        varye = var_ens
        if hybrid:
            varye = alpha * var_ens + (1.0 - alpha) * sig[i] * sig[i]
        innov = vals[i] - mye
        kdenom = varye + errs[i]
        scale = 1.0 / (kdenom * (m - 1))
        # B1e applies the full gain to the departure row.
        beta = 1.0 if enkf else 1.0 / (1.0 + torch.sqrt(errs[i] / kdenom))
        z = ye - eps[i] if enkf else ye
        kcov = tp @ ye
        kmat = (kcov * weights[i] if weights is not None else kcov) * scale
        ens = 1.0
        if hybrid:
            kmat = alpha * kmat + (1.0 - alpha) * sig * sig[i] * gc[i] / kdenom
            ens = alpha
        f = f_all[i]
        tm = tm + (f * innov) * kmat
        tp = tp - ((f * beta) * kmat)[:, None] * z[None, :]
        k_i = kmat[i]
        a = assim[i]
        if enkf:
            post = tp[i] - torch.sum(tp[i]) / m
            post_var = torch.sum(post * post) / vden
            zs.append(z)
        else:
            shrink = 1.0 - beta * k_i
            post_var = shrink * shrink * var_ens
        s_base = ((1.0 - alpha) * sig[i] / kdenom) if hybrid else 0.0
        for out, v in zip(outs, (
                ye, ens * f * innov * scale, ens * f * beta * scale, mye,
                varye, torch.where(a, mye + k_i * innov, nan),
                torch.where(a, post_var, nan),
                f * s_base * innov, f * s_base * beta)):
            out.append(v)
    st = torch.stack
    res = (tm, tp, *(st(o) for o in outs[:7]))
    if enkf:
        return res + (st(zs),)
    return res + (st(outs[7]), st(outs[8])) if hybrid else res


def tail_panel_solve_subpanel_plain(tail_mean, tail_perts, values, errors,
                                    assim, weights=None,
                                    unbiased: bool = False,
                                    alpha: float = 1.0, sigma=None,
                                    static_gc=None, eps=None,
                                    sub: int = DEFAULT_SUB):
    """Plain-torch B1 in the kernel's order of operations: per sub-panel
    of ``sub`` obs, the serial solve on the sub-panel's own rows, then one
    rank-``sub`` update of every other row (``D0 = X Y^T``, a forward
    substitution against ``G = Y Y^T``, ``xm += U gain``, ``X -= V Y``;
    B1e: ``G = Z Y^T`` and ``X -= V Z``).  Same inputs and returns as
    :func:`tail_panel_solve_plain`."""
    p, m = tail_perts.shape
    dtype = tail_perts.dtype
    hybrid = _check_hybrid(alpha, sigma, static_gc, eps)
    tm = tail_mean.to(dtype).clone()
    tp = tail_perts.clone()
    sig = sigma.to(dtype) if hybrid else None
    gc = static_gc.to(dtype) if hybrid else None
    rows = torch.arange(p, device=tp.device)
    parts = []
    for i0 in range(0, p, sub):
        i1 = min(p, i0 + sub)
        own = slice(i0, i1)
        w_own = None if weights is None else weights[own, own]
        hkw = (dict(alpha=alpha, sigma=sig[own], static_gc=gc[own, own])
               if hybrid else {})
        if eps is not None:
            hkw = dict(eps=eps[own])
        res = tail_panel_solve_plain(tm[own], tp[own], values[own],
                                     errors[own], assim[own], w_own,
                                     unbiased, **hkw)
        tm[own], tp[own] = res[0], res[1]
        parts.append(res[2:])
        ye, gain, sqrtc = res[2], res[3], res[4]
        arows = ye if eps is None else res[9]
        other = (rows < i0) | (rows >= i1)
        x = tp[other]
        d0 = x @ ye.T
        gram = arows @ ye.T
        u = torch.zeros_like(d0)
        v = torch.zeros_like(d0)
        mean = torch.zeros_like(tm[other])
        for t in range(i1 - i0):
            d = d0[:, t] - v[:, :t] @ gram[:t, t]
            u[:, t] = d if weights is None else weights[i0 + t, other] * d
            v[:, t] = sqrtc[t] * u[:, t]
            mean = mean + gain[t] * u[:, t]
            if hybrid:
                col = sig[other] * gc[i0 + t, other]
                v[:, t] = v[:, t] + res[10][t] * col
                mean = mean + res[9][t] * col
        tm[other] = tm[other] + mean
        tp[other] = x - v @ arows
    return (tm, tp) + tuple(torch.cat([q[k] for q in parts])
                            for k in range(len(parts[0])))


def smem_bytes(rows: int, m: int, sub: int = DEFAULT_SUB,
               hybrid: bool = False, enkf: bool = False,
               device_slab: bool = False) -> int:
    """Shared memory of one CTA that owns ``rows`` rows of the panel
    (mirrors ``make_layout`` in ``csrc/tail_solve.cu``): the weight ring
    (and B1h's static ring), the sub-panel's ``ye`` rows (and B1e's ``z``
    rows), Gram matrix and coefficients (two slots each), the rows at an
    odd stride, and the per-row mean, value, error, flag (and sigma);
    ``device_slab``: the rings and the rows in device memory instead."""
    h = int(bool(hybrid))
    e = int(bool(enkf))
    per_row = SLOTS * sub * rows * (1 + h) + rows * (4 + h)
    if device_slab:
        return 4 * per_row
    return 4 * (per_row + SLOTS * m * sub * (1 + e) + SLOTS * sub * sub
                + SLOTS * COEF_ROWS * sub + rows * (m | 1))


def in_device_memory(p: int, m: int, sub: int, cluster: int,
                     hybrid: bool = False, enkf: bool = False) -> bool:
    """Whether the kernel keeps the slab of a padded panel of ``p`` obs in
    device memory: its shares do not fit a CTA of ``cluster``."""
    return (smem_bytes(p // cluster, m, sub, hybrid, enkf)
            > MAX_SMEM_BYTES)


def ring_floats(m: int, sub: int = DEFAULT_SUB, enkf: bool = False) -> int:
    """Floats of the device scratch ring of a launch whose slab is in
    device memory: two slots of the sub-panel's rows (and B1e's ``z``
    rows), Gram matrix and coefficients (the ring offsets of
    ``make_layout`` in ``csrc/tail_solve.cu``)."""
    return SLOTS * (m * sub * (2 if enkf else 1) + sub * sub
                    + COEF_ROWS * sub)


def padded_panel(p: int, sub: int, cluster: int) -> int:
    """The panel the kernel runs: ``p`` rounded up to whole sub-panels in
    every CTA of the cluster (padded obs are not assimilated)."""
    unit = sub * cluster
    return -(-p // unit) * unit


def pick_cluster(p: int, m: int, sub: int = DEFAULT_SUB,
                 hybrid: bool = False, enkf: bool = False) -> int:
    """CTAs the panel's rows are dealt over: the smallest cluster of
    ``CLUSTERS``, from ``MIN_CLUSTER`` on, whose CTAs' shares of the slab
    fit in shared memory, else the largest (the slab then stays in device
    memory).  Raises ``ValueError`` beyond ``MAX_PANEL`` obs or below 2
    members."""
    if sub not in SUBS:
        raise ValueError(f"B1 sub-panels are {SUBS} obs wide, not {sub}")
    if not 1 <= p <= MAX_PANEL:
        raise ValueError(f"B1 takes panels of 1 to {MAX_PANEL} obs, not {p}")
    if m < 2:
        raise ValueError(f"B1 takes 2 members or more, not {m}")
    fit = [c for c in CLUSTERS if c >= MIN_CLUSTER
           and not in_device_memory(padded_panel(p, sub, c), m, sub, c,
                                    hybrid, enkf)]
    return fit[0] if fit else CLUSTERS[-1]


def _pad_square(x, n):
    if n == 0:
        return x
    return torch.nn.functional.pad(x, (0, n, 0, n))


def _aligned(t):
    """Contiguous, with a 16-byte-aligned start (the kernel copies the
    weight rows 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def tail_panel_solve_cuda(tail_mean, tail_perts, values, errors, assim,
                          weights=None, unbiased: bool = False,
                          alpha: float = 1.0, sigma=None, static_gc=None,
                          eps=None, sub: int = DEFAULT_SUB, cluster=None):
    """Launch B1 (B1h with ``alpha < 1``, B1e with ``eps``) on CUDA tensors
    (float32); same returns as the plain version.  ``cluster`` overrides
    :func:`pick_cluster`.  Raises on a shape the kernel does not take,
    before any launch."""
    p, m = tail_perts.shape
    dev = tail_perts.device
    f32 = torch.float32
    hybrid = _check_hybrid(alpha, sigma, static_gc, eps)
    enkf = eps is not None
    if enkf and sub != DEFAULT_SUB:
        raise ValueError(f"B1e runs sub-panels of {DEFAULT_SUB} obs only")
    c = pick_cluster(p, m, sub, hybrid, enkf) if cluster is None else cluster
    if c not in CLUSTERS:
        raise ValueError(f"B1 clusters are {CLUSTERS} CTAs, not {c}")
    pp = padded_panel(p, sub, c)
    device_slab = in_device_memory(pp, m, sub, c, hybrid, enkf)
    if device_slab and sub != DEFAULT_SUB:
        raise ValueError(f"B1 keeps a slab in device memory at sub-panels "
                         f"of {DEFAULT_SUB} obs only")
    ins = [tail_mean, tail_perts, values, errors]
    ins += [t for t in (weights, sigma, static_gc, eps) if t is not None]
    for t in ins:
        if t.device != dev or t.dtype != f32:
            raise ValueError("B1 takes float32 tensors on one CUDA device")
    for t in (weights, static_gc):
        if t is not None and t.shape != (p, p):
            raise ValueError("B1 weights and static_gc must be [P, P]")
    for t in (tail_mean, values, errors, assim, sigma):
        if t is not None and t.shape != (p,):
            raise ValueError("B1 per-ob inputs must be [P]")
    if enkf and eps.shape != (p, m):
        raise ValueError("B1e's eps must be [P, M]")
    pad = pp - p
    tm_in = _pad(tail_mean, pad).contiguous()
    tp_in = _pad(tail_perts, pad).contiguous()
    vals = _pad(values, pad).contiguous()
    errs = _pad(errors, pad, 1.0).contiguous()
    am = _pad(assim.to(device=dev, dtype=torch.uint8), pad, 0).contiguous()
    w = None if weights is None else _aligned(_pad_square(weights, pad))
    sig = gc = None
    if hybrid:
        sig = _pad(sigma, pad).contiguous()
        gc = _aligned(_pad_square(static_gc, pad))
    tm = torch.empty(pp, dtype=f32, device=dev)
    tp = torch.empty((pp, m), dtype=f32, device=dev)
    ye = torch.empty((pp, m), dtype=f32, device=dev)
    vec = [torch.empty(pp, dtype=f32, device=dev)
           for _ in range(8 if hybrid else 6)]
    ptr = lambda t: None if t is None else t.data_ptr()
    e_in = _pad(eps, pad).contiguous() if enkf else None
    z = torch.empty((pp, m), dtype=f32, device=dev) if enkf else None
    ring = (torch.empty(ring_floats(m, sub, enkf), dtype=f32, device=dev)
            if device_slab else None)
    # The C entry sets its attributes on, and launches onto, the current
    # device: make it the tensors' one.
    with torch.cuda.device(dev):
        err = _build.lib().efa_tail_launch(
            tm_in.data_ptr(), tp_in.data_ptr(), vals.data_ptr(),
            errs.data_ptr(), am.data_ptr(), ptr(w), ptr(gc), ptr(sig),
            ptr(e_in), ptr(ring), float(alpha), pp, m, int(bool(unbiased)),
            sub, c, tm.data_ptr(), tp.data_ptr(), ye.data_ptr(), ptr(z),
            *(v.data_ptr() for v in vec[:6]),
            *(ptr(v) for v in (vec[6:] if hybrid else (None, None))),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kind = "B1e" if enkf else "B1h" if hybrid else "B1"
    _build.check(err, f"{kind} tail_solve launch")
    _count(kind)
    if enkf:
        return tuple(t[:p] for t in (tm, tp, ye, *vec, z))
    return tuple(t[:p] for t in (tm, tp, ye, *vec))


def _count(kind: str) -> None:
    """One launch of ``kind``: "B1", "B1h" or "B1e"."""
    global launches, hybrid_launches, enkf_launches
    with _count_lock:
        if kind == "B1h":
            hybrid_launches += 1
        elif kind == "B1e":
            enkf_launches += 1
        else:
            launches += 1


def tail_panel_solve(tail_mean, tail_perts, values, errors, assim,
                     weights=None, unbiased: bool = False,
                     alpha: float = 1.0, sigma=None, static_gc=None,
                     eps=None):
    """B1/B1h/B1e dispatch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    args = (tail_mean, tail_perts, values, errors, assim, weights, unbiased,
            alpha, sigma, static_gc, eps)
    if tail_perts.is_cuda:
        return tail_panel_solve_cuda(*args)
    if tail_perts.device.type != "cpu":
        raise ValueError(f"B1 runs on CUDA or CPU, not {tail_perts.device}")
    return tail_panel_solve_plain(*args)
