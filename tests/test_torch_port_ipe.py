"""nerf_hugs_torch's integrated positional encoding wrapper (ops/ipe.py).

On CPU tensors the wrapper is the eager composition core/coord.py::
integrated_pos_enc followed by the cast PosEncMLP makes, and launches
nothing. The gradient kernel's closed form, written in plain torch, is held
against autograd through the eager composition at every (d, L) the
Mip-NeRF 360 configs give. The CUDA kernels themselves are held against
the plain versions, bit for bit at those (d, L) in both compute dtypes on
arguments on both sides of the 100 pi range-reduction cap, large enough
for the fmod, and not finite, by the `cuda`-marked tests here (skipped
without a GPU) and by chip_smoke.py at the train cell's shapes.
"""

import importlib.util
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch's threads)
from nerf_hugs_torch.core import coord, geopoly
from nerf_hugs_torch.ops import ipe
from nerf_hugs_torch.utils import trace

REPO = pathlib.Path(__file__).resolve().parents[1]
CAP = np.float32(100.0 * math.pi)
# (basis, min_deg, max_deg): icosahedron/2 (d = 21) at the default 12
# degrees and at 16, octahedron/1 (d = 3) at 16 (llff, blender) and 12.
SHAPES = [(("icosahedron", 2), 0, 12), (("icosahedron", 2), 0, 16),
          (("octahedron", 1), 0, 16), (("octahedron", 1), 0, 12)]
DTYPES = [torch.float32, torch.bfloat16]
# The gradient's tolerance, relative to its largest entry: both sides are
# fp32, summing the same terms in another order.
GRAD_RTOL = 1e-5


def shape_id(shape):
    (name, sub), lo, hi = shape
    return f"{name}{sub}-deg{lo}-{hi}"


def make_inputs(basis_key, min_deg, max_deg, seed, rows=37,
                finite_only=False):
    """Lifted means and variances [rows, d]: random ones through the basis,
    then, overwriting entries, arguments mean * 2^l just below, at and just
    above +-100 pi, far above it (fmod), zeros, and unless `finite_only`
    infinities and NaN."""
    rs = np.random.RandomState(seed)
    basis = torch.from_numpy(np.ascontiguousarray(
        geopoly.generate_basis(*basis_key).T).astype(np.float32))
    d = basis.shape[1]
    pts = torch.from_numpy(rs.uniform(-4, 4, (rows, 3)).astype(np.float32))
    a = torch.from_numpy(rs.randn(rows, 3, 3).astype(np.float32)) * 0.05
    cov = a @ a.transpose(-1, -2)
    mean, var = coord.lift_and_diagonalize(pts, cov, basis)
    mean, var = mean.contiguous().clone(), var.contiguous().clone()
    flat_m, flat_v = mean.view(-1), var.view(-1)
    special = []
    for deg in range(min_deg, max_deg):
        at = np.float32(CAP / np.float32(2.0 ** deg))
        for x in (at, np.nextafter(at, np.float32(0)),
                  np.nextafter(at, np.float32(np.inf))):
            special += [x, -x]
    special += [np.float32(1e6), np.float32(-7.7e3), np.float32(3e30),
                np.float32(0.0), np.float32(-0.0)]
    if not finite_only:
        special += [np.float32(np.inf), np.float32(-np.inf),
                    np.float32(np.nan)]
    idx = rs.choice(flat_m.numel(), len(special), replace=False)
    flat_m[torch.from_numpy(idx)] = torch.tensor(np.array(special))
    if not finite_only:
        idx = rs.choice(flat_v.numel(), 3, replace=False)
        flat_v[torch.from_numpy(idx)] = torch.tensor(
            [np.inf, np.nan, 0.0], dtype=torch.float32)
    return mean, var


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, except that any NaN equals any NaN (the casts may
    write different NaN payloads)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return bool(torch.equal(nan_a, nan_b) and torch.equal(
        a.masked_fill(nan_a, 0).view(ints),
        b.masked_fill(nan_b, 0).view(ints)))


def test_plain_version_is_the_eager_composition_cast():
    """The CPU dispatch: the wrapper returns the composition PosEncMLP
    made before, in the compute dtype. The kernel's bits are held to it by
    test_kernels_match_plain_versions at every (d, L) and dtype, on the
    cap's edges, inf and NaN."""
    mean, var = make_inputs(("icosahedron", 2), 0, 12, seed=12)
    got = ipe.integrated_pos_enc(mean, var, 0, 12, torch.bfloat16)
    assert got.shape == (mean.shape[0], 2 * 12 * 21)
    assert got.dtype == torch.bfloat16
    assert same_bits(got, coord.integrated_pos_enc(mean, var, 0, 12).to(
        torch.bfloat16))


def test_plain_version_keeps_leading_dims():
    mean, var = make_inputs(("icosahedron", 2), 0, 12, seed=3, rows=24)
    got = ipe.integrated_pos_enc(mean.view(4, 6, 21), var.view(4, 6, 21), 0,
                                 12, torch.bfloat16)
    assert got.shape == (4, 6, 504)
    assert same_bits(got.view(24, 504), ipe.integrated_pos_enc(
        mean, var, 0, 12, torch.bfloat16))


def test_launch_counters_do_not_move_on_the_cpu():
    mean, var = make_inputs(("icosahedron", 2), 0, 12, seed=5,
                            finite_only=True)
    mean.requires_grad_(True)
    var.requires_grad_(True)
    before = trace.counters()
    out = ipe.integrated_pos_enc(mean, var, 0, 12, torch.bfloat16)
    out.float().sum().backward()
    after = trace.counters()
    assert mean.grad is not None and var.grad is not None
    for name in ("ipe.launches", "ipe_bwd.launches"):
        assert after.get(name, 0) == before.get(name, 0)


def global_symbols() -> list:
    src = (REPO / "nerf_hugs_torch" / "csrc" / "ipe.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)", src)


def load_devtrace():
    spec = importlib.util.spec_from_file_location(
        "devtrace_for_ipe_test", REPO / "benchmark" / "devtrace.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_kernel_symbols_stay_in_the_elementwise_class():
    """The benchmark puts a kernel's device time in `elementwise_ms.train`
    unless its name matches one of these classes; the encoding's kernels
    stay there, where the eager passes they replace were counted."""
    devtrace = load_devtrace()
    names = global_symbols()
    assert names == ["ipe_fwd_kernel", "ipe_bwd_kernel"]
    # As the profiler names an instantiation.
    shown = [f"void (anonymous namespace)::{n}<{t}>(float const*, "
             f"float const*, {t}*, long, int, int, int)"
             for n in names for t in ("float", "__nv_bfloat16")]
    for pattern in (devtrace.GEMM, devtrace.SORT, devtrace.REDUCE,
                    devtrace.ADAM, devtrace.COPY, devtrace.HASHGRID_FWD,
                    devtrace.HASHGRID_BWD):
        for name in shown:
            assert not re.search(pattern, name, re.I), (pattern, name)


@pytest.mark.parametrize("grad_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_closed_form_gradient_matches_autograd(shape, grad_dtype):
    basis_key, lo, hi = shape
    mean, var = make_inputs(basis_key, lo, hi, seed=11 + hi,
                            finite_only=True)
    d = mean.shape[-1]
    rs = np.random.RandomState(hi)
    g = torch.from_numpy(rs.randn(mean.shape[0], 2 * (hi - lo) * d).astype(
        np.float32)).to(grad_dtype)
    m, v = mean.clone().requires_grad_(True), var.clone().requires_grad_(True)
    out = coord.integrated_pos_enc(m, v, lo, hi).to(grad_dtype)
    out.backward(g)
    got_m, got_v = ipe.integrated_pos_enc_grad_plain(mean, var, g, lo, hi)
    for got, want in ((got_m, m.grad), (got_v, v.grad)):
        assert got.shape == want.shape and got.dtype == torch.float32
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= GRAD_RTOL * scale


def test_kernel_argument_checks_raise():
    mean, var = make_inputs(("octahedron", 1), 0, 16, seed=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ipe.ipe_fwd(mean, var, 0, 16, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ipe.ipe_bwd(mean, var, torch.zeros(mean.shape[0], 96), 0, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_kernels_match_plain_versions(cuda, shape, dtype):
    basis_key, lo, hi = shape
    mean, var = make_inputs(basis_key, lo, hi, seed=hi, rows=1029)
    mean, var = mean.to(cuda), var.to(cuda)
    before = trace.counters().get("ipe.launches", 0)
    got = ipe.integrated_pos_enc(mean, var, lo, hi, dtype)
    want = ipe.integrated_pos_enc_plain(mean, var, lo, hi, dtype)
    torch.cuda.synchronize()
    assert same_bits(got, want)
    assert trace.counters()["ipe.launches"] == before + 1

    fm, fv = make_inputs(basis_key, lo, hi, seed=hi + 1, rows=1029,
                         finite_only=True)
    m = fm.to(cuda).requires_grad_(True)
    v = fv.to(cuda).requires_grad_(True)
    g = torch.randn(m.shape[0], got.shape[1], device=cuda).to(dtype)
    ipe.integrated_pos_enc(m, v, lo, hi, dtype).backward(g)
    want_m, want_v = ipe.integrated_pos_enc_grad_plain(m.detach(),
                                                       v.detach(), g, lo, hi)
    for got_g, want_g in ((m.grad, want_m), (v.grad, want_v)):
        scale = float(want_g.abs().max())
        assert float((got_g - want_g).abs().max()) <= GRAD_RTOL * scale
