"""nerf_hugs_torch's planar accumulate and its microbenchmark against the
JAX tool tools/bench_fwd_copies.py.

The JAX side runs the tool's Pallas `_accum_kernel` in interpret mode on
the CPU, with the tool's own BlockSpecs, and its XLA candidates; the port
runs the plain version, which `planar_accum` takes for CPU tensors. The
CUDA kernel itself is held against the plain version by the `cuda`-marked
test here (skips without a GPU) and by chip_smoke.py at n = 2^21.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import torch_port_util  # noqa: F401  (pins torch's threads)
from nerf_hugs_torch.ops import accum
from nerf_hugs_torch.tools import bench_fwd_copies as tbench

REPO = pathlib.Path(__file__).resolve().parents[1]
# The tool's own tolerance (tools/bench_fwd_copies.py:218): the candidates
# sum the same fp32 products, rounded at different places.
TOL = dict(rtol=1e-5, atol=1e-5)
N = 9            # a small dense level: C = 729 rows
BLOCK = 1024     # the JAX tool's block


def load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_fwd_copies", REPO / "tools" / "bench_fwd_copies.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jbench = load_jax_tool()


def make_inputs(n, seed):
    rs = np.random.RandomState(seed)
    C = N ** 3
    tab2 = rs.randn(C, 2 * accum.F).astype(np.float32)
    idx = rs.randint(0, C, (4, n)).astype(np.int32)
    w = rs.rand(8, n).astype(np.float32)
    return tab2, idx, w


def jax_rebuilds(tab2):
    """The JAX tool's build4 and build8, which it defines inside main()."""
    t2 = jnp.asarray(tab2)
    t4 = jnp.concatenate([t2, jnp.roll(t2, -N, axis=0)], axis=-1)
    return t4, jnp.concatenate([t4, jnp.roll(t4, -N * N, axis=0)], axis=-1)


def pallas_accum_interpret(vals, w):
    """The tool's `pallas_accum` after its gathers, run in interpret mode
    with the tool's BlockSpecs."""
    n = w.shape[1]
    vspec = pl.BlockSpec((BLOCK, 2 * jbench.F), lambda i: (i, 0))
    wspec = pl.BlockSpec((8, BLOCK), lambda i: (0, i))
    return pl.pallas_call(
        jbench._accum_kernel, grid=(n // BLOCK,),
        in_specs=[vspec] * 4 + [wspec],
        out_specs=pl.BlockSpec((BLOCK, jbench.F), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, jbench.F), jnp.float32),
        interpret=True)(*vals, w)


def test_plain_accumulate_matches_jax_kernel_and_planar():
    tab2, idx, w = make_inputs(2 * BLOCK, 0)
    vals = [tab2[idx[c]] for c in range(4)]
    want_kernel = np.asarray(pallas_accum_interpret(
        [jnp.asarray(v) for v in vals], jnp.asarray(w)))
    want_planar = np.asarray(jbench.planar(jnp.asarray(tab2),
                                           jnp.asarray(idx), jnp.asarray(w)))
    got = accum.planar_accum(*[torch.from_numpy(v) for v in vals],
                             torch.from_numpy(w))
    assert got.shape == (2 * BLOCK, accum.F) and got.dtype == torch.float32
    torch.testing.assert_close(
        got, accum.planar_accum_plain(*[torch.from_numpy(v) for v in vals],
                                      torch.from_numpy(w)), rtol=0, atol=0)
    for want in (want_kernel, want_planar):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ragged_n_matches_planar():
    n = 2 * BLOCK + 5   # the Pallas grid needs n % 1024 == 0; the port not
    tab2, idx, w = make_inputs(n, 1)
    want = np.asarray(jbench.planar(jnp.asarray(tab2), jnp.asarray(idx),
                                    jnp.asarray(w)))
    got = tbench.pallas_accum(torch.from_numpy(tab2), torch.from_numpy(idx),
                              torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["planar", "transposed", "pallas_accum",
                                  "quad", "oct_pack", "mxu_transpose"])
def test_candidate_matches_jax_twin(name):
    tab2, idx, w = make_inputs(2 * BLOCK, 2)
    tab4, tab8 = (np.array(t) for t in jax_rebuilds(tab2))
    args = {"quad": (tab4, idx[:2], w), "oct_pack": (tab8, idx[0], w)}.get(
        name, (tab2, idx, w))
    if name == "pallas_accum":   # needs a TPU; its twin is interpret mode
        want = pallas_accum_interpret(
            [jnp.asarray(tab2)[jnp.asarray(idx[c])] for c in range(4)],
            jnp.asarray(w))
    else:
        want = getattr(jbench, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tbench, name)(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["build4", "build8"])
def test_table_rebuild_matches_jax_exactly(name):
    tab2, _, _ = make_inputs(8, 3)
    want = jax_rebuilds(tab2)[name == "build8"]
    got = getattr(tbench, name)(torch.from_numpy(tab2), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cli_on_the_cpu_prints_one_block_per_size(capsys):
    report = tbench.main(["11", "--all", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    headers = [line for line in out if line.startswith("--- C=")]
    assert headers == [f"--- C={n ** 3} rows (N={n}), n=2048 samples "
                       "(4 paired descriptors each) on cpu ---"
                       for n in tbench.SIZES]
    names = {"A_planar", "C_pallas_accum", "D_quad_32B", "O_oct_64B",
             "rebuild4_only", "rebuild8_only", "B_transposed_gather",
             "E_mxu_deinterleave", "C_accum_kernel_only"}
    assert sorted(report) == list(tbench.SIZES)
    for results in report.values():
        assert set(results) == names
        assert all(v > 0 for v in results.values())
    assert sum(line.split()[0] in names and line.endswith("M desc/s")
               for line in out) == len(names) * len(tbench.SIZES)


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["11"])


def test_kernel_argument_checks_raise():
    n = 40
    vs = [torch.zeros(n, 4) for _ in range(4)]
    wide = torch.zeros(8, n + 3)
    assert accum._check_kernel_args(vs, wide[:, 1:n + 1]) == n
    with pytest.raises(ValueError, match="float32"):
        accum._check_kernel_args(vs[:3] + [vs[3].double()], wide[:, :n])
    with pytest.raises(ValueError, match="v2 must be"):
        accum._check_kernel_args(vs[:2] + [torch.zeros(n, 6), vs[3]],
                                 wide[:, :n])
    with pytest.raises(ValueError, match="v1 must be"):
        accum._check_kernel_args(
            [vs[0], torch.zeros(4, n).t()] + vs[2:], wide[:, :n])
    with pytest.raises(ValueError, match="16-byte"):
        misaligned = torch.zeros(n * 4 + 1)[1:].view(n, 4)
        accum._check_kernel_args([misaligned] + vs[1:], wide[:, :n])
    with pytest.raises(ValueError, match="w must be"):
        accum._check_kernel_args(vs, torch.zeros(7, n))
    with pytest.raises(ValueError, match="w must be"):
        accum._check_kernel_args(vs, torch.zeros(n, 8).t())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_version(cuda):
    n = 3 * 1024 + 7
    tab2, idx, w = make_inputs(n + 4, 4)
    vals = [torch.from_numpy(tab2[idx[c]]).to(cuda) for c in range(4)]
    wt = torch.from_numpy(w).to(cuda)
    before = accum.planar_accum.launches
    # A ragged span: rows 1..n of each input, w's columns 1..n as a view.
    sub = [v[1:n + 1] for v in vals]
    got = accum.planar_accum(*sub, wt[:, 1:n + 1])
    torch.cuda.synchronize()
    want = accum.planar_accum_plain(*sub, wt[:, 1:n + 1])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert accum.planar_accum.launches == before + 1
    with pytest.raises(ValueError, match="one device"):
        accum.planar_accum(*vals[:3], vals[3].cpu(), wt[:, :n + 4])
