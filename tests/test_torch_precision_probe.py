"""P, the precision probe: the port's plain modes against the JAX package's
probe kernel (``benchmarks/precision_probe.py``) run in interpret mode on
the CPU, the TF32 rounding on hand-computed values, and the dispatch and
argument checks of the CUDA launcher."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from efa_xray_tpu_torch.ops import precision_probe as pp
from efa_xray_tpu_torch.ops.precision import round_tf32

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 products of K = 64 terms of unit-normal entries (sums ~8) in another
# summation order.
ATOL, RTOL = 1e-4, 1e-5


def _jax_probe_module():
    spec = importlib.util.spec_from_file_location(
        "precision_probe_bench",
        os.path.join(_ROOT, "benchmarks", "precision_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n=48, k=64, m=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((k, m)).astype(np.float32))


@pytest.mark.parametrize("port_mode,jax_mode", [("ieee", "highest"),
                                                ("bf16", "bf16")])
def test_plain_modes_match_jax_probe_kernel(port_mode, jax_mode):
    """The JAX probe's own kernel in interpret mode: ``"highest"`` is a
    true f32 product there and ``"bf16"`` rounds its inputs to bf16, as
    the port's ``"ieee"`` and ``"bf16"`` do."""
    a, b = _inputs()
    kernel = _jax_probe_module()._make_kernel(jax_mode)
    want = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((a.shape[0], b.shape[1]),
                                               jnp.float32),
        interpret=True)(jnp.asarray(a), jnp.asarray(b))
    got = pp.mm_plain(torch.from_numpy(a), torch.from_numpy(b), port_mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bf16_plain_differs_from_ieee():
    a, b = (torch.from_numpy(x) for x in _inputs(seed=1))
    gap = (pp.mm_plain(a, b, "bf16") - pp.mm_plain(a, b, "ieee")).abs().max()
    assert float(gap) > 1e-2  # bf16 keeps 8 mantissa bits


def test_round_tf32_by_hand():
    """10 mantissa bits, to nearest, ties away from zero (``cvt.rna``)."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11,           # tie: away from zero
                      -(1.0 + 2.0 ** -11),         # tie, negative
                      1.0 + 2.0 ** -11 - 2.0 ** -23,  # just below the tie
                      1.0 + 3 * 2.0 ** -11,        # tie above an odd ulp
                      3.0 * 2.0 ** -20 * (1.0 + 2.0 ** -12),  # under tie
                      1.0, 0.0, float("inf"), float("-inf")],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp,
                         3.0 * 2.0 ** -20, 1.0, 0.0, float("inf"),
                         float("-inf")], dtype=torch.float32)
    got = round_tf32(x)
    assert torch.equal(got, want)
    assert torch.isnan(round_tf32(torch.tensor([float("nan")]))).all()
    # The low 13 mantissa bits are clear on every finite output.
    r = round_tf32(torch.randn(1000))
    assert not (r.view(torch.int32) & 0x1FFF).any()


def test_tf32_plain_is_the_product_of_rounded_inputs():
    a, b = (torch.from_numpy(x) for x in _inputs(seed=2))
    got = pp.mm_plain(a, b, "tf32")
    want = round_tf32(a) @ round_tf32(b)
    assert torch.equal(got, want)
    ieee = pp.mm_plain(a, b, "ieee")
    assert 1e-5 < float((got - ieee).abs().max()) < 1e-1


def test_mm_on_cpu_runs_the_plain_version():
    a, b = (torch.from_numpy(x) for x in _inputs(n=16, k=32, m=16, seed=3))
    before = pp.launches
    for mode in pp.MODES:
        assert torch.equal(pp.mm(a, b, mode), pp.mm_plain(a, b, mode))
    assert pp.launches == before == 0
    with pytest.raises(ValueError, match="unknown mode"):
        pp.mm(a, b, "fp8")
    with pytest.raises(ValueError, match="P takes"):
        pp.mm(a, a, "ieee")  # [16, 32] @ [16, 32]


def test_cuda_launcher_refuses_cpu_tensors_and_ragged_sizes():
    a, b = (torch.from_numpy(x) for x in _inputs(n=16, k=32, m=16))
    with pytest.raises(ValueError, match="CUDA"):
        pp.mm_cuda(a, b, "tf32")
    ragged = torch.zeros(24, 32)
    with pytest.raises(ValueError, match="multiples of 16"):
        pp.mm_cuda(ragged, b, "tf32")
    with pytest.raises(ValueError, match="multiples of 16"):
        pp.mm_cuda(a, torch.zeros(32, 20), "bf16")
    assert pp.launches == 0


def test_probe_on_cpu_orders_the_modes():
    """``probe`` on the CPU (plain versions): the error against the
    float64 oracle grows as the inputs lose mantissa bits."""
    res = pp.probe(n=64, k=64, time_n=32, reps=1, device="cpu")
    errs = [res[f"{m}_rms_err_over_scale"] for m in pp.MODES]
    assert errs[0] < 1e-6 < errs[1] < errs[2] < 1e-2
    assert not any(res[f"{x}_equals_{y}_bitwise"]
                   for x, y in (("ieee", "tf32"), ("ieee", "bf16"),
                                ("tf32", "bf16")))
    assert all(res[f"{m}_32_seconds"] > 0 for m in pp.MODES)
    assert res["device"] == "cpu"


@pytest.mark.parametrize("n,k,m", [(16, 16, 16), (48, 64, 32),
                                   (528, 144, 272), (144, 16, 400)])
def test_mm_on_cpu_accepts_every_multiple_of_16(n, k, m):
    """Square or not: the kernel masks its edge tiles, so the wrapper asks
    for multiples of ``TILE`` = 16 and nothing more."""
    assert pp.TILE == 16
    a, b = (torch.from_numpy(x) for x in _inputs(n=n, k=k, m=m, seed=4))
    for mode in pp.MODES:
        got = pp.mm(a, b, mode)
        assert got.shape == (n, m)
        assert torch.equal(got, pp.mm_plain(a, b, mode))
    assert pp.launches == 0


@pytest.mark.parametrize("n,k,m,want", [
    (16, 16, 16, ((128, 64), (128, 64))),
    (528, 144, 272, ((640, 192), (384, 192))),
    (1024, 1024, 1024, ((1024, 1024), (1024, 1024))),
])
def test_scratch_shapes_pad_rows_to_128_and_k_to_64(n, k, m, want):
    """The rounded copies the tensor-core modes read: A as [n, k] and B
    transposed to [m, k], both padded so that the kernel's tiles need no
    masks (``kRowPad``, ``kKPad`` in ``csrc/precision_probe.cu``)."""
    assert pp.scratch_shapes(n, k, m) == want
    with open(os.path.join(_ROOT, "efa_xray_tpu_torch", "csrc",
                           "precision_probe.cu")) as f:
        src = f.read()
    assert f"kRowPad = {pp.ROW_PAD};" in src
    assert f"kKPad = {pp.K_PAD};" in src
    assert f"kSizeMultiple = {pp.TILE};" in src


def test_cuda_launcher_refuses_empty_sizes_and_unknown_variants():
    a, b = (torch.from_numpy(x) for x in _inputs(n=16, k=32, m=16))
    with pytest.raises(ValueError, match="multiples of 16"):
        pp.mm_cuda(torch.zeros(0, 32), b, "ieee")
    # The kernel picks its tile from the sizes: the launcher takes no
    # variant, and no mode but the three.
    with pytest.raises(TypeError):
        pp.mm_cuda(a, b, "tf32", variant="64x64")
    with pytest.raises(ValueError, match="unknown mode"):
        pp.mm_cuda(a, b, "fp16")
    assert pp.launches == 0
