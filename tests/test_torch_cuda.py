"""
PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, at small and edge shapes, and the
paths on CUDA (ANM plane traces, ANM covariance and PRS, GNM ensemble,
single structures, the spectral pipelines, the matrix-free modes and CG
solves over the pair CSR, the tabulated families on all of them, patch
overlays, single structures past 4,096 atoms) against the float64
engines, each with the launch counts of its own kernels.

Marked ``cuda``: every test skips without an NVIDIA GPU.  This file
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch (skip the JAX test configuration there)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: 1e-5 of max|x| for the assembly, the
stitch, the bisection and the matrix-free applies, 1e-6 relative for the
pair CSR's constants (its pairs exactly), 2e-5 absolute for unit-scale
panels, 1e-4 of max|x| for the float32 paths against float64;
eigenvectors by their residuals (5e-4 of the matrix norm after
refinement, a median of 1e-3 of the band's norm straight from inverse
iteration) and orthonormality (1e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly, assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import matfree  # noqa: E402
from springcraft_tpu_torch.ops import rigid, spd_linalg, spectrum  # noqa: E402
from springcraft_tpu_torch.parallel import pipeline  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _coords(b, n, seed, spread=6.0):
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * spread).astype(np.float32)
    return base[None] + 0.05 * rng.randn(b, n, 3).astype(np.float32)


def _rel(got, ref):
    diff = (got.double() - ref.double()).abs().max()
    return float(diff / ref.double().abs().max())


def _spd_panels(count, pb, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(count, pb, pb)
    a = a @ a.transpose(0, 2, 1) / pb + 0.5 * np.eye(pb)
    d = 1.0 / np.sqrt(np.diagonal(a, axis1=1, axis2=2))
    return (a * d[:, :, None] * d[:, None, :]).astype(np.float32)


def _planes_of(h):
    """K1's planes ``(9, B, n, n)`` as they are, K5's xyz-layout
    Hessians ``(B, 3n, 3n)`` as the same planes."""
    if h.ndim == 4:
        return h
    b, m, _ = h.shape
    n = m // 3
    return h.reshape(b, 3, n, 3, n).permute(1, 3, 0, 2, 4).reshape(
        9, b, n, n)


def _assert_hessian_parts(got, ref):
    """K1 or K5 output `got` against the plain version's `ref`: the
    off-diagonal entries (atoms p != q) bit for bit (the same
    ``(g d_a) d_e``); each diagonal entry the negated float64 sum of its
    row's off-diagonal entries in `got` itself, and the plain version's
    diagonal, within 1e-6 of max|ref| (the row sums in another order).
    One plane at a time: at n = 8,192 a plane is 268 MB."""
    got, ref = _planes_of(got), _planes_of(ref)
    n = ref.shape[-1]
    off = ~torch.eye(n, dtype=torch.bool, device=ref.device)
    tol = 1e-6 * float(ref.abs().max())
    for g, r in zip(got, ref):
        assert torch.equal(g[:, off], r[:, off])
        diag = torch.diagonal(g, dim1=-2, dim2=-1).double()
        row_sums = g.double().masked_fill_(~off, 0.0).sum(dim=-1)
        assert float((diag + row_sums).abs().max()) <= tol
        assert float((diag - torch.diagonal(r, dim1=-2, dim2=-1).double())
                     .abs().max()) <= tol


def _unaligned(coords):
    """`coords` copied into storage that starts 4 bytes past a 16-byte
    boundary: the assembly kernels then read it 4 bytes at a time."""
    shifted = torch.empty(coords.numel() + 1, device=coords.device)[1:] \
        .view_as(coords)
    return shifted.copy_(coords)


@pytest.mark.parametrize("kind,cutoff", [("invariant", 7.0),
                                         ("hinsen", 7.0), ("hinsen", None),
                                         ("pfenm", 7.0)])
@pytest.mark.parametrize("b,n", [(3, 41), (2, 300), (1, 5), (2, 298),
                                 (2, 299)])
def test_hessian_planes_kernel(cuda, kind, cutoff, b, n):
    """n % 4 != 0: the planes' rows start 0-3 columns before a 16-byte
    boundary, and at odd n and B the nine planes' boundaries differ."""
    params = getattr(sct, f"{kind}_params")(cutoff)
    coords = torch.as_tensor(_coords(b, n, seed=n), device=cuda)
    before = assembly_kernels.hessian_planes_ensemble.launches
    got = assembly_kernels.hessian_planes_ensemble(coords, params)
    assert assembly_kernels.hessian_planes_ensemble.launches == before + 1
    ref = assembly.hessian_planes_plain(coords, params)
    torch.cuda.synchronize()
    assert got.shape == (9, b, n, n) and got.device == coords.device
    assert _rel(got, ref) <= 1e-5
    _assert_hessian_parts(got, ref)
    _assert_hessian_parts(assembly_kernels.hessian_planes_ensemble(
        _unaligned(coords), params), ref)


def _assert_kirchhoff_parts(got, ref):
    """Off-diagonal entries bit for bit (the same ``-k``), the diagonal
    (the row sum, in another order) within 1e-6 of max|ref|."""
    n = ref.shape[-1]
    off = ~torch.eye(n, dtype=torch.bool, device=ref.device)
    assert torch.equal(got[:, off], ref[:, off])
    diag = torch.diagonal(got, dim1=-2, dim2=-1)
    ref_diag = torch.diagonal(ref, dim1=-2, dim2=-1)
    assert float((diag.double() - ref_diag.double()).abs().max()) \
        <= 1e-6 * float(ref.double().abs().max())


@pytest.mark.parametrize("kind,cutoff", [("invariant", 7.0),
                                         ("hinsen", None), ("pfenm", 7.0)])
@pytest.mark.parametrize("b,n", [(3, 41), (2, 300), (1, 5), (1, 1776),
                                 (2, 1777), (1, 8192), (2, 298), (2, 299)])
def test_kirchhoff_and_hessian_xyz_kernels(cuda, kind, cutoff, b, n):
    """n % 4 != 0 takes the kernels' 4-byte stores of the columns before
    a row's first 16-byte boundary and after its last group (and in the
    xyz layout, where a row's three segments start on different
    boundaries, 8- and 4-byte stores of the groups); 1,776 and 8,192 are
    the single structures of their paths."""
    params = getattr(sct, f"{kind}_params")(cutoff)
    coords = torch.as_tensor(_coords(b, n, seed=n), device=cuda)
    for wrapper, plain in (
            (assembly_kernels.kirchhoff_ensemble, assembly.kirchhoff_plain),
            (assembly_kernels.hessian_xyz_ensemble,
             assembly.hessian_xyz_plain)):
        before = wrapper.launches
        got = wrapper(coords, params)
        assert wrapper.launches == before + 1
        ref = plain(coords, params)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.device == coords.device
        assert _rel(got, ref) <= 1e-5, wrapper.__name__
        if wrapper is assembly_kernels.kirchhoff_ensemble:
            _assert_kirchhoff_parts(got, ref)
        else:
            _assert_hessian_parts(got, ref)
        del got, ref
    # coordinates that start 4 bytes past a 16-byte boundary: the kernels
    # read them 4 bytes at a time
    shifted = _unaligned(coords)
    _assert_kirchhoff_parts(assembly_kernels.kirchhoff_ensemble(shifted,
                                                                params),
                            assembly.kirchhoff_plain(coords, params))
    _assert_hessian_parts(assembly_kernels.hessian_xyz_ensemble(shifted,
                                                                params),
                          assembly.hessian_xyz_plain(coords, params))


def ordered_regularize_stitch(planes, scale_h, ts, mp):
    """The regularize/stitch as its kernel orders the float32 arithmetic,
    over tensors: the rank-6 sum in k order, each product and each sum
    rounded on its own, then ``(h sr) sc + rank``; identity on the pad.
    (``regularize_stitch_plain`` sums the rank-6 term with a matmul.)"""
    batch, m = scale_h.shape
    rank = ts[:, :, None, 0] * ts[:, None, :, 0]
    for k in range(1, 6):
        rank = rank + ts[:, :, None, k] * ts[:, None, :, k]
    reg = (assembly.planes_to_xyz(planes) * scale_h[:, :, None]
           * scale_h[:, None, :] + rank)
    out = torch.zeros((batch, mp, mp), dtype=reg.dtype, device=reg.device)
    out[:, :m, :m] = reg
    idx = torch.arange(m, mp, device=reg.device)
    out[:, idx, idx] = 1.0
    return out


def _stitch_case(cuda, b, n, with_masses, seed):
    coords = torch.as_tensor(_coords(b, n, seed=seed), device=cuda)
    planes = assembly.hessian_planes_plain(coords, sct.invariant_params(7.0))
    masses = torch.linspace(0.8, 2.5, n, device=cuda) if with_masses \
        else None
    bases = rigid.rigid_modes_anm(coords, masses=masses)
    _, _, scale_h, ts = rigid.stitch_inputs(planes, bases, masses=masses)
    return planes, scale_h, ts


@pytest.mark.parametrize("n", [7, 41, 100, 300])
@pytest.mark.parametrize("larger_mp", [False, True])
@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("with_masses", [False, True])
def test_regularize_stitch_kernel(cuda, n, larger_mp, b, with_masses):
    """K2 equals the ordered reference bit for bit and the plain version
    within 1e-6 of max: n = 7 and 41 put column groups across plane
    boundaries and across the 3n edge, 100 and 300 take the 16-byte
    loads; the larger mp (136 more, past one column tile at n = 300)
    widens the pad."""
    planes, scale_h, ts = _stitch_case(cuda, b, n, with_masses, seed=n)
    mp = spd_linalg.padded_size(3 * n) + (136 if larger_mp else 0)
    before = assembly_kernels.regularize_stitch.launches
    got = assembly_kernels.regularize_stitch(planes, scale_h, ts, mp)
    assert assembly_kernels.regularize_stitch.launches == before + 1
    ref = ordered_regularize_stitch(planes, scale_h, ts, mp)
    plain = assembly_kernels.regularize_stitch_plain(planes, scale_h, ts, mp)
    torch.cuda.synchronize()
    assert got.shape == (b, mp, mp)
    assert torch.equal(got, ref)
    assert _rel(got, plain) <= 1e-6


def test_regularize_stitch_kernel_on_unaligned_planes(cuda):
    """Planes that start 4 bytes past a 16-byte boundary take the
    column-by-column loads, with the same bits."""
    planes, scale_h, ts = _stitch_case(cuda, 3, 100, True, seed=2)
    shifted = torch.empty(planes.numel() + 1, device=cuda)[1:].view(
        planes.shape).copy_(planes)
    assert shifted.data_ptr() % 16 != 0
    mp = spd_linalg.padded_size(300)
    got = assembly_kernels.regularize_stitch(shifted, scale_h, ts, mp)
    assert torch.equal(got, ordered_regularize_stitch(planes, scale_h, ts,
                                                      mp))


@pytest.mark.parametrize("count", [1, 3, 128, 2048])
@pytest.mark.parametrize("pb", [8, 16, 24, 32, 40, 48, 56, 64])
def test_panel_inverse_kernel(cuda, pb, count):
    """K3 equals the plain version and K9 bit for bit at every panel
    size and at one, a few, the main path's 128 and many panels."""
    panels = torch.as_tensor(_spd_panels(count, pb, seed=pb + count),
                             device=cuda)
    before = spd_linalg.panel_inverse_batched.launches
    got = spd_linalg.panel_inverse_batched(panels, shrink_block=8)
    assert spd_linalg.panel_inverse_batched.launches == before + 1
    ref = spd_linalg.panel_inverse_plain(panels)
    full = spd_linalg.panel_inverse_full(panels)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got, full)
    upper = torch.triu(got, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))


@pytest.mark.parametrize("count", [1, 3, 128])
@pytest.mark.parametrize("pb", list(range(72, 129, 8)))
def test_panel_inverse_kernels_past_64_rows(cuda, pb, count):
    """K3 and K9 at the leaves of ``block`` 72-128: both equal the plain
    version and each other bit for bit, each counting its launch."""
    panels = torch.as_tensor(_spd_panels(count, pb, seed=pb + count),
                             device=cuda)
    before = (spd_linalg.panel_inverse_batched.launches,
              spd_linalg.panel_inverse_full.launches)
    got = spd_linalg.panel_inverse_batched(panels, shrink_block=8)
    full = spd_linalg.panel_inverse_batched(panels)
    assert (spd_linalg.panel_inverse_batched.launches,
            spd_linalg.panel_inverse_full.launches) == (before[0] + 1,
                                                        before[1] + 1)
    ref = spd_linalg.panel_inverse_plain(panels)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(full, ref)
    upper = torch.triu(got, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))
    eye = torch.eye(pb, device=cuda, dtype=torch.float64)
    p64, g64 = panels.double(), got.double()
    assert float((g64 @ p64 @ g64.mT - eye).abs().max()) <= 1e-4


def test_panel_inverse_kernel_on_a_chunk_leaf(cuda):
    """The first leaf of a trace chunk's factor input (equilibrated,
    regularized, 300 residues in a 34 A cube at 13 A), the panels the
    main path gives K3, and their first one alone."""
    coords = torch.as_tensor(_coords(8, 300, seed=11, spread=34.0),
                             device=cuda)
    planes = assembly_kernels.hessian_planes_ensemble(
        coords, sct.invariant_params(13.0))
    _, _, scale_h, ts = rigid.stitch_inputs(planes,
                                            rigid.rigid_modes_anm(coords))
    reg = assembly_kernels.regularize_stitch(planes, scale_h, ts,
                                             spd_linalg.padded_size(900))
    leaf = reg[:, :spd_linalg.LEAF, :spd_linalg.LEAF].contiguous()
    for panels in (leaf, leaf[:1].contiguous()):
        got = spd_linalg.panel_inverse_batched(panels, shrink_block=8)
        assert torch.equal(got, spd_linalg.panel_inverse_plain(panels))
        assert torch.equal(got, spd_linalg.panel_inverse_full(panels))


@pytest.mark.parametrize("pb", [16, 64, 128])
def test_panel_inverse_kernel_on_offset_panels(cuda, pb):
    """K3 moves a row's slots as vector accesses: contiguous panels that
    start one float past a 16-byte boundary are refused before any
    launch; a view from a later panel of a batch is aligned and taken."""
    panels = torch.as_tensor(_spd_panels(3, pb, seed=pb), device=cuda)
    shifted = torch.empty(panels.numel() + 1, device=cuda)[1:].view(
        panels.shape).copy_(panels)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    before = spd_linalg.panel_inverse_batched.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        spd_linalg.panel_inverse_batched(shifted, shrink_block=8)
    assert spd_linalg.panel_inverse_batched.launches == before
    later = panels[1:]
    assert later.storage_offset() > 0
    assert torch.equal(spd_linalg.panel_inverse_batched(later,
                                                        shrink_block=8),
                       spd_linalg.panel_inverse_plain(later))


@pytest.mark.parametrize("pb", [8, 40, 64, 72, 128])
def test_panel_inverse_kernel_breakdown_is_not_finite(cuda, pb):
    panels = _spd_panels(3, pb, seed=1)
    panels[1, 5, 5] = -1.0
    for shrink_block in (8, None):
        got = spd_linalg.panel_inverse_batched(
            torch.as_tensor(panels, device=cuda), shrink_block=shrink_block)
        assert not bool(torch.isfinite(got[1]).all())
        assert bool(torch.isfinite(got[0]).all())
        assert bool(torch.isfinite(got[2]).all())


def test_kernels_refuse_what_they_do_not_take(cuda):
    coords = torch.as_tensor(_coords(2, 10, seed=0), device=cuda)
    params = sct.invariant_params(7.0)
    with pytest.raises(TypeError, match="float32"):
        assembly_kernels.hessian_planes_ensemble(coords.double(), params)
    with pytest.raises(ValueError, match="contiguous"):
        assembly_kernels.hessian_planes_ensemble(
            coords.transpose(0, 1).contiguous().transpose(0, 1), params)
    with pytest.raises(ValueError, match="device"):
        assembly_kernels.regularize_stitch(
            torch.zeros(9, 2, 10, 10, device=cuda), torch.ones(2, 30),
            torch.zeros(2, 30, 6, device=cuda), 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        assembly_kernels.regularize_stitch(
            torch.zeros(9, 2, 10, 10, device=cuda),
            torch.ones(2, 30, device=cuda),
            torch.zeros(2, 30, 6, device=cuda), 34)
    with pytest.raises(TypeError, match="float32"):
        spd_linalg.panel_inverse_batched(
            torch.eye(16, device=cuda, dtype=torch.float64).expand(2, 16,
                                                                  16),
            shrink_block=8)
    with pytest.raises(ValueError, match="exceeds"):
        spd_linalg.panel_inverse_batched(
            torch.eye(136, device=cuda).expand(2, 136, 136).contiguous(),
            shrink_block=8)
    with pytest.raises(TypeError, match="float32"):
        sct.ensemble_anm_fluctuations(coords, params, inverse="blocked",
                                      dtype=torch.float64)
    for wrapper in (assembly_kernels.kirchhoff_ensemble,
                    assembly_kernels.hessian_xyz_ensemble):
        with pytest.raises(TypeError, match="float32"):
            wrapper(coords.double(), params)
        with pytest.raises(ValueError, match="exceeds"):
            wrapper(torch.zeros(65536, 2, 3, device=cuda), params)


@pytest.mark.parametrize("with_masses", [False, True])
def test_slice_on_cuda(cuda, with_masses):
    coords = _coords(4, 100, seed=3, spread=34.0 * (1 / 3) ** (1 / 3))
    masses = (np.linspace(0.8, 2.5, 100).astype(np.float32)
              if with_masses else None)
    params = sct.invariant_params(13.0)
    wrappers = sct.kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    got = sct.ensemble_anm_fluctuations(coords, params, masses=masses,
                                        inverse="blocked",
                                        with_covariance=False, device="cuda")
    _check_launches(wrappers, before, TRACE_PATH_KERNELS)
    chunked = sct.ensemble_anm_fluctuations(
        coords, params, masses=masses, inverse="blocked",
        with_covariance=False, chunk=2, device="cuda")
    ref = sct.ensemble_anm_fluctuations(
        coords.astype(np.float64), params,
        masses=None if masses is None else masses.astype(np.float64),
        inverse="cho_solve", with_covariance=False, dtype=torch.float64,
        device="cuda")
    cpu = sct.ensemble_anm_fluctuations(coords, params, masses=masses,
                                        inverse="blocked",
                                        with_covariance=False, device="cpu")
    for key in ("msf", "bfactor", "dcc"):
        assert got[key].device.type == "cuda"
        assert _rel(got[key], ref[key]) <= 1e-4, key
        assert _rel(got[key], cpu[key].to(cuda)) <= 1e-4, key
        assert _rel(chunked[key], got[key]) <= 1e-6, key


#: Kernels each path launches; the others stay at their count.
TRACE_PATH_KERNELS = {"hessian_planes", "regularize_stitch", "panel_inverse"}
PATHS = {
    "anm_covariance": TRACE_PATH_KERNELS,
    "gnm_ensemble": {"kirchhoff", "panel_inverse"},
    "anm_single": {"hessian_xyz"},
    "gnm_single": {"kirchhoff"},
}


def _check_launches(wrappers, before, kernels):
    for name, w in wrappers.items():
        if name in kernels:
            assert w.launches > before[name], name
        else:
            assert w.launches == before[name], name


def _run_path(path, coords, masses, params, dtype, device):
    engine = "blocked" if dtype == torch.float32 else "cho_solve"
    if path == "anm_covariance":
        return sct.ensemble_anm_fluctuations(
            coords, params, masses=masses, inverse=engine,
            with_covariance=True, with_prs=True, dtype=dtype, device=device)
    if path == "gnm_ensemble":
        return sct.ensemble_gnm_fluctuations(
            coords, params, masses=masses, inverse=engine, dtype=dtype,
            device=device)
    fn = sct.anm_fluctuations if path == "anm_single" else \
        sct.gnm_fluctuations
    kwargs = {"with_prs": True} if path == "anm_single" else {}
    return fn(coords[0], params, masses=masses, dtype=dtype, device=device,
              **kwargs)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("with_masses", [False, True])
def test_covariance_paths_on_cuda(cuda, path, with_masses):
    coords = _coords(4, 100, seed=5, spread=34.0 * (1 / 3) ** (1 / 3))
    masses = (np.linspace(0.8, 2.5, 100).astype(np.float32)
              if with_masses else None)
    params = sct.invariant_params(13.0)
    wrappers = sct.kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    got = _run_path(path, coords, masses, params, torch.float32, "cuda")
    torch.cuda.synchronize()
    _check_launches(wrappers, before, PATHS[path])
    ref = _run_path(path, coords.astype(np.float64), None if masses is None
                    else masses.astype(np.float64), params, torch.float64,
                    "cuda")
    cpu = _run_path(path, coords, masses, params, torch.float32, "cpu")
    assert set(got) == set(ref) == set(cpu)
    for key in got:
        assert got[key].device.type == "cuda"
        assert bool(torch.isfinite(got[key]).all()), key
        assert _rel(got[key], ref[key]) <= 1e-4, key
        assert _rel(got[key], cpu[key].to(cuda)) <= 1e-4, key


# ---------------------------------------------------------------------------
# The banded eigensolver kernels (K10, K11) and the spectral paths
# ---------------------------------------------------------------------------


def _band_diags(b, n, w, device, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(b, n, n, generator=gen)
    return spectrum.band_reduce((a + a.transpose(1, 2)).to(device) / 2,
                                w - 1)


def _dense_band(diags):
    b, w, n = diags.shape
    band = torch.zeros((b, n, n), dtype=diags.dtype, device=diags.device)
    for d in range(w):
        idx = torch.arange(n - d, device=diags.device)
        band[:, idx, idx + d] = diags[:, d, :n - d]
        band[:, idx + d, idx] = diags[:, d, :n - d]
    return band


@pytest.mark.parametrize("w", [2, 5, 9])
@pytest.mark.parametrize("b,n", [(3, 40), (2, 130)])
def test_banded_bisect_kernel(cuda, w, b, n):
    diags = _band_diags(b, n, w, cuda, seed=n + w)
    feed, lo, hi = spectrum.bisect_inputs(diags)
    before = spectrum.banded_bisect.launches
    got = spectrum.banded_bisect(feed, lo, hi, 40)
    assert spectrum.banded_bisect.launches == before + 1
    ref = spectrum.banded_bisect_plain(feed, lo, hi, 40)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    exact = torch.linalg.eigvalsh(_dense_band(diags.double()))
    assert _rel(got, exact) <= 1e-5


def test_banded_bisect_kernel_reads_device_memory_past_shared(cuda):
    """A feed over the per-block shared-memory limit (n = 6500 at w = 9)
    is read from device memory."""
    n = 6500
    diags = torch.zeros(1, 9, n, device=cuda)
    diags[:, 0] = torch.linspace(-3.0, 3.0, n, device=cuda)
    diags[:, 1:] = 0.1 * torch.randn(1, 8, n, device=cuda,
                                     generator=torch.Generator(cuda)
                                     .manual_seed(0))
    got = spectrum.banded_bisect(*spectrum.bisect_inputs(diags), 40)
    exact = torch.linalg.eigvalsh(_dense_band(diags.double()))
    assert _rel(got, exact) <= 1e-5


def test_banded_kernels_stage_a_feed_past_48_kb(cuda):
    """A feed between the 48 KB default and the opt-in limit (n = 1500 at
    w = 9, 54 KB) is staged in shared memory raised per kernel: both
    kernels against their plain versions (the bisection over 16 halvings,
    the inverse iteration on 15 shifts across the spectrum)."""
    n = 1500
    diags = torch.zeros(1, 9, n, device=cuda)
    diags[:, 0] = torch.linspace(-3.0, 3.0, n, device=cuda)
    diags[:, 1:] = 0.1 * torch.randn(1, 8, n, device=cuda,
                                     generator=torch.Generator(cuda)
                                     .manual_seed(1))
    feed, lo, hi = spectrum.bisect_inputs(diags)
    got = spectrum.banded_bisect(feed, lo, hi, 16)
    ref = spectrum.banded_bisect_plain(feed, lo, hi, 16)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    vals = spectrum.banded_bisect(feed, lo, hi, 40)
    exact = torch.linalg.eigvalsh(_dense_band(diags.double()))
    assert _rel(vals, exact) <= 1e-5
    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)
    cols = slice(0, n, 100)
    pick = shifts[:, cols].contiguous()
    x = spectrum.banded_eigvec(feed, pick, 0, floor, 2, 1.0)
    x_plain = spectrum.banded_eigvec_plain(feed, pick, 0, floor, 2, 1.0)
    torch.cuda.synchronize()
    assert x.shape == (1, n, 15) and bool(torch.isfinite(x).all())
    overlap = (x * x_plain).sum(dim=1).abs()
    assert float(overlap.min()) >= 1 - 1e-3
    band = _dense_band(diags)
    res = torch.linalg.vector_norm(band @ x - x * vals[:, None, cols], dim=1)
    assert float(res.max()) <= 1e-4 * float(vals.abs().max())


@pytest.mark.parametrize("w", [2, 5, 9])
@pytest.mark.parametrize("b,n", [(3, 40), (2, 300)])
def test_banded_eigvec_kernel(cuda, w, b, n):
    diags = _band_diags(b, n, w, cuda, seed=n + w)
    vals = spectrum.banded_bisect(*spectrum.bisect_inputs(diags), 40)
    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)
    before = spectrum.banded_eigvec.launches
    got = spectrum.banded_eigvec(feed, shifts, 0, floor, 2, 1.0)
    assert spectrum.banded_eigvec.launches == before + 1
    ref = spectrum.banded_eigvec_plain(feed, shifts, 0, floor, 2, 1.0)
    torch.cuda.synchronize()
    assert got.shape == (b, n, n) and bool(torch.isfinite(got).all())
    band = _dense_band(diags)
    norm = vals.abs().amax(dim=1)[:, None]
    for u in (got, ref):
        res = torch.linalg.vector_norm(band @ u - u * vals[:, None, :],
                                       dim=1) / norm
        assert float(res.median()) <= 1e-3
    gaps = torch.diff(vals, dim=1)
    apart = torch.minimum(gaps[:, :-1], gaps[:, 1:]) > 1e-2 * norm
    overlap = (got * ref).sum(dim=1).abs()[:, 1:-1][apart]
    assert float(overlap.min()) >= 1 - 1e-3


@pytest.mark.parametrize("w", [2, 5, 9])
def test_banded_bisect_kernel_stops_early_exactly(cuda, w):
    """At 48 halvings nearly every eigenvalue reaches float32 resolution
    and leaves its halving loop early: the kernel against its plain version
    at 48 halvings and against float64 eigvalsh."""
    diags = _band_diags(2, 130, w, cuda, seed=7 * w)
    feed, lo, hi = spectrum.bisect_inputs(diags)
    got = spectrum.banded_bisect(feed, lo, hi, 48)
    ref = spectrum.banded_bisect_plain(feed, lo, hi, 48)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    exact = torch.linalg.eigvalsh(_dense_band(diags.double()))
    assert _rel(got, exact) <= 1e-5


@pytest.mark.parametrize("levels", [3, 2, 1])
def test_banded_bisect_kernel_at_each_multisection_depth(cuda, levels):
    """Each depth the wrapper can pick on this card, against the plain
    version on a batch of (B, 9, 64) bands, B the smallest batch that takes
    `levels`: at 13 halvings, 6 from the shared tree and 7 in rounds of
    `levels` (two full rounds and a partial one at depth 3, three and a
    partial one at depth 2; a wrong step there moves a result by 2^-13 of
    the span, far past the tolerance), and at 47, past float32 resolution,
    where the early stop ends every loop.  Then a single band matrix just
    large enough for `levels` against float64 LAPACK eigenvalues of the
    band at 40 halvings (its plain loop over the rows would take seconds
    a halving)."""
    linalg = pytest.importorskip("scipy.linalg")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    batch = {3: 1, 2: -(-8 * sms // 7), 1: 4 * sms}[levels]
    assert spectrum._bisect_levels(batch, 64, sms) == levels
    diags = _band_diags(batch, 64, 9, cuda, seed=levels)
    feed, lo, hi = spectrum.bisect_inputs(diags)
    for halvings in (13, 47):
        got = spectrum.banded_bisect(feed, lo, hi, halvings)
        ref = spectrum.banded_bisect_plain(feed, lo, hi, halvings)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 1e-5, halvings

    per_warp = 32 // (2 ** levels - 1)
    n = {3: 200, 2: 8 * sms * per_warp, 1: 8 * sms * per_warp}[levels]
    assert spectrum._bisect_levels(1, n, sms) == levels
    w = {3: 9, 2: 3, 1: 2}[levels]
    gen = torch.Generator(cuda).manual_seed(levels)
    diags = torch.zeros(1, w, n, device=cuda)
    diags[:, 0] = torch.linspace(-3.0, 3.0, n, device=cuda)
    diags[:, 1:] = 0.1 * torch.randn(1, w - 1, n, device=cuda,
                                     generator=gen)
    vals = spectrum.banded_bisect(*spectrum.bisect_inputs(diags), 40)
    # band_reduce's diagonals are LAPACK's lower band storage
    exact = linalg.eigvals_banded(diags[0].double().cpu().numpy(),
                                  lower=True)
    assert _rel(vals, torch.from_numpy(exact)[None].to(cuda)) <= 1e-5


def _eigvec_against_plain(diags, vals, cols):
    """K11 on the shifts of columns `cols` against its plain version
    (overlap on eigenvalues at least a quarter of the mean spacing from
    both neighbours) and by its band residuals."""
    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)
    pick = shifts[:, cols].contiguous()
    before = spectrum.banded_eigvec.launches
    x = spectrum.banded_eigvec(feed, pick, 0, floor, 2, 1.0)
    assert spectrum.banded_eigvec.launches == before + 1
    x_plain = spectrum.banded_eigvec_plain(feed, pick, 0, floor, 2, 1.0)
    torch.cuda.synchronize()
    b, n = diags.shape[0], diags.shape[-1]
    assert x.shape == (b, n, pick.shape[1]) and bool(torch.isfinite(x).all())
    picked = vals[:, cols]
    norm = vals.abs().amax(dim=1)[:, None]
    for u in (x, x_plain):
        res = torch.linalg.vector_norm(
            torch.bmm(_dense_band(diags), u) - u * picked[:, None, :],
            dim=1) / norm
        assert float(res.median()) <= 1e-3
        assert float(res.max()) <= 1e-4
    gaps = torch.diff(vals, dim=1)
    big = torch.full_like(vals[:, :1], float("inf"))
    gap = torch.minimum(torch.cat([big, gaps], 1), torch.cat([gaps, big], 1))
    spacing = (vals[:, -1:] - vals[:, :1]) / n
    apart = (gap > 0.25 * spacing)[:, cols]
    assert bool(apart.any())
    overlap = (x * x_plain).sum(dim=1).abs()[apart]
    assert float(overlap.min()) >= 1 - 1e-3


@pytest.mark.parametrize("n,step", [(41, 1), (130, 1), (300, 1),
                                    (1500, 10)])
def test_banded_eigvec_kernel_on_ragged_segments(cuda, n, step):
    """n not a multiple of the kernel's 8-row segments and a shift count
    not a multiple of its 256-shift blocks (41, 130, 300 and 150 shifts);
    at n = 1500 the feed is staged as float32 beside the segment store."""
    gen = torch.Generator(cuda).manual_seed(n)
    diags = torch.zeros(2, 9, n, device=cuda)
    diags[:, 0] = torch.linspace(-3.0, 3.0, n, device=cuda)
    diags[:, 1:] = 0.1 * torch.randn(2, 8, n, device=cuda, generator=gen)
    vals = spectrum.banded_bisect(*spectrum.bisect_inputs(diags), 40)
    _eigvec_against_plain(diags, vals, slice(0, n, step))


def test_banded_eigvec_kernel_reads_device_memory_past_shared(cuda):
    """A feed over what the segment store leaves of the per-block shared
    memory (n = 6500 at w = 9) is read from device memory: eight shifts
    across the spectrum against the plain version."""
    n = 6500
    diags = torch.zeros(1, 9, n, device=cuda)
    diags[:, 0] = torch.linspace(-3.0, 3.0, n, device=cuda)
    diags[:, 1:] = 0.1 * torch.randn(1, 8, n, device=cuda,
                                     generator=torch.Generator(cuda)
                                     .manual_seed(0))
    vals = spectrum.banded_bisect(*spectrum.bisect_inputs(diags), 40)
    _eigvec_against_plain(diags, vals, slice(17, n, 811))


def test_banded_kernels_refuse_what_they_do_not_take(cuda):
    diags = _band_diags(2, 30, 9, cuda, seed=0)
    feed, lo, hi = spectrum.bisect_inputs(diags)
    with pytest.raises(TypeError, match="float32"):
        spectrum.banded_bisect(feed.double(), lo.double(), hi.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        spectrum.banded_bisect(feed.transpose(1, 2).contiguous()
                               .transpose(1, 2), lo, hi, 8)
    wide = _band_diags(2, 30, 11, cuda, seed=0)
    with pytest.raises(ValueError, match="exceeds"):
        spectrum.banded_bisect(*spectrum.bisect_inputs(wide), 8)
    vals = spectrum.banded_bisect(feed, lo, hi, 40)
    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)
    with pytest.raises(TypeError, match="float32"):
        spectrum.banded_eigvec(feed, shifts.double(), 0, floor, 2, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        spectrum.banded_eigvec(feed, shifts.t().contiguous().t(), 0, floor,
                               2, 1.0)
    with pytest.raises(ValueError, match="device"):
        spectrum.banded_eigvec(feed, shifts.cpu(), 0, floor, 2, 1.0)


def test_banded_kernel_route(cuda):
    """Float32 with bandwidth <= 8 launches the kernels; float64 and wider
    bands take the plain versions."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(2, 60, 60, generator=gen)
    a = ((a + a.transpose(1, 2)) / 2).to(cuda)
    wrappers = sct.kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    vals = spectrum.eigvalsh_banded(a, bandwidth=8)
    _check_launches(wrappers, before, {"banded_bisect"})
    before = {k: w.launches for k, w in wrappers.items()}
    vals_full, vecs = spectrum.eigh_banded(a, bandwidth=4)
    _check_launches(wrappers, before, {"banded_bisect", "banded_eigvec"})
    exact = torch.linalg.eigvalsh(a.double())
    assert _rel(vals, exact) <= 1e-5 and _rel(vals_full, exact) <= 1e-5
    before = {k: w.launches for k, w in wrappers.items()}
    spectrum.eigh_banded(a.double(), bandwidth=8)
    spectrum.eigvalsh_banded(a, bandwidth=12)
    _check_launches(wrappers, before, set())


#: Kernels of each spectral path (chip_smoke.py's PATH_KERNELS).
SPECTRAL_PATHS = {
    "ensemble_anm_spectral": {"hessian_xyz", "panel_inverse",
                              "banded_bisect"},
    "ensemble_anm_banded": {"hessian_xyz", "banded_bisect", "banded_eigvec"},
    "ensemble_gnm_spectral": {"kirchhoff", "panel_inverse", "banded_bisect"},
    "ensemble_gnm_banded": {"kirchhoff", "banded_bisect", "banded_eigvec"},
    "anm_spectral": {"hessian_xyz", "banded_bisect"},
    "gnm_spectral": {"kirchhoff", "banded_bisect"},
}


@pytest.mark.parametrize("path", sorted(SPECTRAL_PATHS))
def test_spectral_paths_on_cuda(cuda, path):
    coords = _coords(4, 100, seed=7, spread=34.0 * (1 / 3) ** (1 / 3))
    params = sct.invariant_params(13.0)
    model = "anm" if "anm" in path else "gnm"
    n_trivial = 6 if model == "anm" else 1
    kwargs = {"n_modes": 5} if path.endswith("_spectral") \
        and path != "gnm_spectral" else {}
    if "banded" in path:
        kwargs["with_dcc"] = True
    x = coords if path.startswith("ensemble") else coords[0]
    wrappers = sct.kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    got = getattr(sct, path)(x, params, device="cuda", **kwargs)
    torch.cuda.synchronize()
    _check_launches(wrappers, before, SPECTRAL_PATHS[path])
    cpu = getattr(sct, path)(x, params, device="cpu", **kwargs)
    x64 = torch.as_tensor(coords if path.startswith("ensemble")
                          else coords[:1], dtype=torch.float64, device=cuda)
    eig = getattr(sct, f"ensemble_{model}")(x64, params, with_dcc=True,
                                            dtype=torch.float64)
    cov = getattr(sct, f"ensemble_{model}_fluctuations")(
        x64, params, inverse="cho_solve", dtype=torch.float64)
    ref = {**eig, **cov}
    build = (pipeline._build_hessians_batched if model == "anm"
             else pipeline._build_kirchhoffs_batched)
    matrices = build(x64, params, None)
    if not path.startswith("ensemble"):
        got = {key: value[None] for key, value in got.items()}
        cpu = {key: value[None] for key, value in cpu.items()}
    assert set(got) == set(cpu)
    norm = ref["eig_values"].abs().amax(dim=-1)
    for key, value in got.items():
        assert value.device.type == cuda.type
        assert bool(torch.isfinite(value).all()), key
        if key.endswith("_vectors"):
            vals = got["eig_values" if key == "eig_vectors"
                       else "mode_values"].double()
            u = value.double().transpose(-1, -2)
            res = torch.linalg.vector_norm(matrices @ u - u * vals[:, None],
                                           dim=-2) / norm[:, None]
            assert float(res.max()) <= 5e-4, key
            eye = torch.eye(u.shape[-1], dtype=u.dtype, device=cuda)
            assert float((value.double() @ u - eye).abs().max()) <= 1e-3
        elif key == "mode_values":
            lowest = ref["eig_values"][:, n_trivial:n_trivial + 5]
            assert float((value.double() - lowest).abs().max()
                         / norm.max()) <= 1e-4
        elif key == "frequencies":
            assert _rel(value[:, n_trivial:],
                        ref[key][:, n_trivial:]) <= 1e-4
        else:
            assert _rel(value, ref[key]) <= 1e-4, key
            assert _rel(value, cpu[key].to(cuda)) <= 1e-4, key


# ---------------------------------------------------------------------------
# The matrix-free kernels (K12, K13, K14) and paths
# ---------------------------------------------------------------------------


def _protein_blob(n, seed):
    """Random atoms at the JAX benchmark's protein density
    (``bench.py:131``, 300 residues in a 34 A cube)."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3) * 34.0 * (n / 300) ** (1 / 3)).astype(np.float32)


def _sorted_layout(n, seed, cutoff=13.0, tile=256):
    coord = _protein_blob(n, seed)
    perm = matfree.spatial_sort_permutation(coord)
    nbr, counts = matfree.tile_neighbor_lists(coord[perm], cutoff, tile)
    return coord[perm], perm.astype(np.int32), nbr, counts


@pytest.mark.parametrize("k", [1, 5, 48, 130])
@pytest.mark.parametrize("n", [257, 1000])
@pytest.mark.parametrize("wrapper", ["hessian_apply_dense",
                                     "hessian_apply_sparse",
                                     "kirchhoff_apply_sparse"])
def test_matfree_kernels(cuda, wrapper, n, k):
    """Each kernel against its plain version on the same CUDA tensors at
    ragged n (a padded last tile), the sparse kernels on a Morton-sorted
    layout with original ids; 1e-5 of max|y|."""
    coord, ids, nbr, counts = _sorted_layout(n, seed=n + k)
    node = wrapper == "kirchhoff_apply_sparse"
    params = (sct.pfenm_params(None) if wrapper == "hessian_apply_dense"
              else sct.invariant_params(13.0))
    x = torch.as_tensor(np.random.RandomState(k).randn(
        n if node else 3 * n, k).astype(np.float32), device=cuda)
    c = torch.as_tensor(coord, device=cuda)
    fn = getattr(matfree, wrapper)
    wrappers = sct.kernel_wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    if wrapper == "hessian_apply_dense":
        got = fn(c, x, params)
        ref = matfree.hessian_apply_dense_plain(c, x, params)
    else:
        got = fn(c, x, params, nbr, counts, ids)
        csr = matfree.tile_csr(nbr, counts, ids, n, 256, cuda)
        plain = (matfree.kirchhoff_apply_sparse_plain if node
                 else matfree.hessian_apply_sparse_plain)
        ref = plain(c, x, params, csr, 256)
    torch.cuda.synchronize()
    # a sparse apply builds the pair CSR, then gathers over it
    grew = {name: w.launches - before[name] for name, w in wrappers.items()}
    assert grew == {name: int(name == wrapper or (
        name == "pair_csr" and wrapper != "hessian_apply_dense"))
        for name in wrappers}
    assert got.shape == x.shape and got.device == c.device
    assert _rel(got, ref) <= 1e-5
    # the sparse kernels agree with the row-blocked operator in float64
    if wrapper == "hessian_apply_sparse":
        exact = matfree.hessian_apply(c.double(), x.double(), params,
                                      dtype=torch.float64)
        assert _rel(got, exact) <= 1e-5


@pytest.mark.parametrize("tile", [16, 100])
def test_matfree_kernels_take_other_tiles(cuda, tile):
    """Tiles that are not a multiple of the kernels' 32-row blocks."""
    coord, ids, nbr, counts = _sorted_layout(300, seed=tile, cutoff=9.0,
                                             tile=tile)
    params = sct.hinsen_params(9.0)
    c = torch.as_tensor(coord, device=cuda)
    for node in (False, True):
        x = torch.randn(300 if node else 900, 7, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(tile))
        fn = (matfree.kirchhoff_apply_sparse if node
              else matfree.hessian_apply_sparse)
        got = fn(c, x, params, nbr, counts, ids, tile=tile)
        ref = fn(c.cpu(), x.cpu(), params, nbr, counts, ids, tile=tile)
        torch.cuda.synchronize()
        assert _rel(got, ref.to(cuda)) <= 1e-5


def _dense_family(family, n):
    if family == "sd_enm":
        return _table_params("sd_enm", _ca_atoms(n, seed=n, chains=3))
    if family == "invariant":
        return sct.invariant_params(13.0)
    return sct.pfenm_params(None)


@pytest.mark.parametrize("k", [1, 4, 24, 48, 50, 96])
@pytest.mark.parametrize("family", ["pfenm", "invariant", "sd_enm"])
def test_dense_apply_kernel_at_every_column_layout(cuda, family, k):
    """K12 against its plain version at n = 1000 (a ragged last block of
    rows and tile of atoms) for every column layout (k = 1, 4: 16 columns
    a block; 24: 32; 48: 48; 50: 64; 96: two chunks of 48), 1e-5 of
    max|y|; two applies give the same bits; an unaligned X takes the
    4-byte copies."""
    n = 1000
    params = _dense_family(family, n)
    c = torch.as_tensor(_protein_blob(n, seed=k), device=cuda)
    x = torch.as_tensor(np.random.RandomState(k).randn(3 * n, k).astype(
        np.float32), device=cuda)
    ref = matfree.hessian_apply_dense_plain(c, x, params)
    store = torch.zeros(x.numel() + 1, device=cuda)
    shifted = store[1:].view_as(x)
    shifted.copy_(x)
    fn = matfree.hessian_apply_dense
    before = fn.launches, fn.table_launches
    got = fn(c, x, params)
    again = fn(c, x, params)
    table = params.kind == "table_compact"
    assert (fn.launches, fn.table_launches) == (before[0] + 2,
                                                before[1] + 2 * table)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, ref) <= 1e-5
    assert _rel(fn(c, shifted, params), ref) <= 1e-5


@pytest.mark.parametrize("family", ["invariant", "sd_enm"])
def test_dense_apply_kernel_and_the_pair_csr_pass_the_same_pairs(cuda,
                                                                 family):
    """Under a cutoff K12 (every pair tested on every apply) equals K13
    over the pair CSR (the pairs the build's walk passed) within 1e-5 of
    max|y|: both call the same pair test, so they keep the same pairs."""
    n = 2000
    params = _dense_family(family, n)
    cutoff = float(np.sqrt(params.cutoff_sq))
    coord, _, nbr, counts = _sorted_layout(n, seed=7, cutoff=cutoff)
    c = torch.as_tensor(coord, device=cuda)
    x = torch.as_tensor(np.random.RandomState(3).randn(3 * n, 48).astype(
        np.float32), device=cuda)
    # ids = slots: the sorted order is the structure's own order here
    csr = matfree.tile_csr(nbr, counts, None, n, 256, cuda)
    pairs = matfree.pair_csr(c, params, csr, 256)
    gathered = matfree._apply_pairs(matfree.hessian_apply_sparse, c, x, pairs)
    dense = matfree.hessian_apply_dense(c, x, params)
    torch.cuda.synchronize()
    assert pairs.slots.numel() > 0
    assert _rel(dense, gathered) <= 1e-5


def test_matfree_kernels_refuse_what_they_do_not_take(cuda):
    coord, ids, nbr, counts = _sorted_layout(300, seed=0)
    c = torch.as_tensor(coord, device=cuda)
    params = sct.invariant_params(13.0)
    x = torch.zeros(900, 4, device=cuda)
    for fn, args, vec in (
            (matfree.hessian_apply_sparse, (nbr, counts, ids), x),
            (matfree.hessian_apply_dense, (), x),
            (matfree.kirchhoff_apply_sparse, (nbr, counts, ids), x[:300])):
        with pytest.raises(TypeError, match="float32"):
            fn(c, vec, params, *args, dtype=torch.float64)
        with pytest.raises(ValueError, match="contiguous"):
            fn(c, vec.t().contiguous().t(), params, *args)
        with pytest.raises(ValueError, match="device"):
            fn(c, vec.cpu(), params, *args)


def _pair_layout(n, seed, params, tile=256):
    """Sorted coordinates on the card, the tile CSR with original ids and
    `params` in the sorted order."""
    coord, ids, nbr, counts = _sorted_layout(
        n, seed, cutoff=float(np.sqrt(params.cutoff_sq)), tile=tile)
    if params.kind == "table_compact":
        params = params.permuted(ids)
    return (torch.as_tensor(coord, device="cuda"), params,
            matfree.tile_csr(nbr, counts, ids, n, tile, "cuda"))


def _assert_same_pairs(got, ref):
    """The build kernel's pair CSR against the plain one: the same rows
    and slots in the same order, constants within 1e-6 relative."""
    assert torch.equal(got.row_ptr, ref.row_ptr)
    assert torch.equal(got.slots, ref.slots)
    assert got.k.dtype == torch.float32
    assert bool(((got.k - ref.k).abs() <= 1e-6 * ref.k.abs()).all())


@pytest.mark.parametrize("n,tile", [(257, 256), (1000, 256), (300, 16),
                                    (300, 100)])
@pytest.mark.parametrize("family", ["invariant", "hinsen", "sd_enm"])
def test_pair_csr_kernel(cuda, family, n, tile):
    """The build kernel (both branches) against its plain version on the
    same CUDA tensors, in Morton order with original ids; counted once
    per build, through the table branch for ``table_compact``."""
    if family == "sd_enm":
        params = _table_params("sd_enm", _ca_atoms(n, seed=n, chains=3))
    else:
        params = getattr(sct, f"{family}_params")(13.0)
    c, params, csr = _pair_layout(n, n + tile, params, tile)
    build = matfree.pair_csr
    before = build.launches, build.table_launches
    got = build(c, params, csr, tile)
    table = params.kind == "table_compact"
    assert (build.launches, build.table_launches) == (before[0] + 1,
                                                      before[1] + table)
    ref = matfree.pair_csr_plain(c, params, csr, tile)
    torch.cuda.synchronize()
    assert got.slots.numel() > 0
    _assert_same_pairs(got, ref)
    # the same inputs give the same list bit for bit
    again = build(c, params, csr, tile)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_pair_csr_kernel_on_the_cutoff_and_a_split_bond(cuda):
    """sdENM pairs exactly on the first edge and on the cutoff (16.5) are
    in the list with the constants of the bins the edges close, a pair
    just past the cutoff is not, and a bonded pair whose atoms sit in
    different tiles takes the bonded table; the analytic branch keeps
    the pair on the cutoff too."""
    n, tile = 40, 16
    atoms = _ca_atoms(n, seed=1, chains=1)
    atoms.res_id = np.arange(1, n + 1)
    params = sct.TabulatedForceField.sd_enm(atoms).to_compact_params()
    coord = np.zeros((n, 3), dtype=np.float32)
    coord[:, 0] = [0.0, 0.25, 2.0, 4.0, 16.75] + [40.0 + 3.8 * i
                                                  for i in range(n - 5)]
    perm = np.array([0] + list(range(2, n)) + [1])
    nbr = np.tile(np.arange(3, dtype=np.int32), (3, 1))
    csr = matfree.tile_csr(nbr, np.full(3, 3, np.int32),
                           perm.astype(np.int32), n, tile, cuda)
    c = torch.as_tensor(coord[perm], device=cuda)
    slot = np.argsort(perm)
    t = params.type_idx
    for family in (params.permuted(perm), sct.invariant_params(16.5)):
        got = matfree.pair_csr(c, family, csr, tile)
        _assert_same_pairs(got, matfree.pair_csr_plain(c, family, csr, tile))
        row_ptr, slots, k = (v.cpu().numpy() for v in got)

        def constant(i, j):
            row = slots[row_ptr[slot[i]]:row_ptr[slot[i] + 1]]
            found = np.flatnonzero(row == slot[j])
            return k[row_ptr[slot[i]] + found[0]] if len(found) else None

        assert constant(0, 4) is None                    # 16.75 > 16.5
        if family.kind == "table_compact":
            assert constant(0, 3) == params.intra_table[t[0], t[3], 0]
            assert constant(1, 4) == params.intra_table[t[1], t[4], 25]
            assert constant(0, 1) == params.bonded_table[t[0], t[1], 0]
            assert constant(1, 2) == params.bonded_table[t[1], t[2], 0]
        else:
            assert constant(1, 4) == constant(4, 1) == 1.0


@pytest.mark.parametrize("k", [1, 5, 24, 48, 130])
@pytest.mark.parametrize("n", [257, 1000])
@pytest.mark.parametrize("wrapper", ["hessian_apply_sparse",
                                     "kirchhoff_apply_sparse"])
def test_gather_applies_over_the_pair_csr(cuda, wrapper, n, k):
    """K13 and K14 over the built list against both plain versions on the
    same CUDA tensors (the sum over the same list, and the tile walk of
    the TPU kernels' arithmetic), 1e-5 of max|y|, at every lane layout
    the widths give (k = 130 takes three column chunks); two applies give
    the same bits."""
    params = sct.invariant_params(13.0)
    c, params, csr = _pair_layout(n, n + k, params)
    pairs = matfree.pair_csr(c, params, csr, 256)
    fn = getattr(matfree, wrapper)
    node = wrapper == "kirchhoff_apply_sparse"
    x = torch.as_tensor(np.random.RandomState(k).randn(
        n if node else 3 * n, k).astype(np.float32), device=cuda)
    before = fn.launches
    got = matfree._apply_pairs(fn, c, x, pairs)
    again = matfree._apply_pairs(fn, c, x, pairs)
    assert fn.launches == before + 2
    over_list = (matfree.kirchhoff_apply_pair_csr_plain if node
                 else matfree.hessian_apply_pair_csr_plain)(c, x, pairs)
    walk = (matfree.kirchhoff_apply_sparse_plain if node
            else matfree.hessian_apply_sparse_plain)(c, x, params, csr, 256)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, over_list) <= 1e-5
    assert _rel(got, walk) <= 1e-5
    # an unaligned X takes the scalar loads
    if k % 4 == 0:
        store = torch.zeros(x.numel() + 1, device=cuda)
        shifted = store[1:].view_as(x)
        shifted.copy_(x)
        assert _rel(matfree._apply_pairs(fn, c, shifted, pairs),
                    over_list) <= 1e-5


def test_gather_applies_refuse_what_they_do_not_take(cuda):
    params = sct.invariant_params(13.0)
    c, params, csr = _pair_layout(300, 0, params)
    pairs = matfree.pair_csr(c, params, csr, 256)
    other, _, other_csr = _pair_layout(200, 0, params)
    for fn, rows in ((matfree.hessian_apply_sparse, 900),
                     (matfree.kirchhoff_apply_sparse, 300)):
        x = torch.zeros(rows, 4, device=cuda)
        with pytest.raises(TypeError, match="float64"):
            matfree._apply_pairs(fn, c.double(), x.double(), pairs)
        with pytest.raises(ValueError, match="contiguous"):
            matfree._apply_pairs(fn, c, x.t().contiguous().t(), pairs)
        with pytest.raises(ValueError, match="device"):
            matfree._apply_pairs(fn, c, x.cpu(), pairs)
        with pytest.raises(ValueError, match="does not fit 300 atoms"):
            matfree._apply_pairs(fn, c, x, matfree.pair_csr(
                other, params, other_csr, 256))
    with pytest.raises(TypeError, match="float32"):
        matfree.pair_csr(c.double(), params, csr, 256)
    with pytest.raises(ValueError, match="device"):
        matfree.pair_csr(c.cpu(), params, csr, 256)
    with pytest.raises(ValueError, match="does not describe 300 atoms"):
        matfree.pair_csr(c, params, other_csr, 256)


#: matrix-free path -> the kernels it must launch (the block-sparse paths
#: build the pair CSR once, then gather over it)
MATFREE_PATHS = {
    "modes": {"pair_csr", "hessian_apply_sparse"},
    "modes_dense": {"hessian_apply_dense"},
    "modes_gnm": {"pair_csr", "kirchhoff_apply_sparse"},
    "solve": {"pair_csr", "hessian_apply_sparse"},
    "solve_gnm": {"pair_csr", "kirchhoff_apply_sparse"},
}


def _matfree_path(path, coord, device, dtype):
    kw = dict(device=device, dtype=dtype)
    params = sct.invariant_params(13.0)
    if path == "modes":
        return sct.lowest_modes_matfree(coord, params, 5, degree=48,
                                        n_outer=12, tol=2e-4, **kw)[:2]
    if path == "modes_dense":
        return sct.lowest_modes_matfree(coord, sct.pfenm_params(None), 5,
                                        degree=48, n_outer=12, tol=2e-4,
                                        **kw)[:2]
    if path == "modes_gnm":
        return sct.lowest_modes_matfree_gnm(coord, params, 5, degree=48,
                                            n_outer=12, tol=2e-4, **kw)[:2]
    if path == "solve":
        return sct.dcc_rows_matfree(coord, params, [0, 100, 200],
                                    norm=False, **kw)[:1]
    return sct.dcc_rows_matfree_gnm(coord, params, [0, 100, 200],
                                    norm=False, **kw)[:1]


@pytest.mark.parametrize("path", sorted(MATFREE_PATHS))
def test_matfree_paths_on_cuda(cuda, path):
    """Each float32 path launches its kernels and no other (the pair CSR
    once per solver call), and agrees with the float64 plain route on the
    card: eigenvalues to 1e-4
    relative, eigenvectors by subspace overlap above 1 - 1e-4, CG rows to
    1e-3 of max (float32 CG to a relative residual of 1e-6)."""
    coord = _protein_blob(600, seed=11)
    wrappers = sct.kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    got = _matfree_path(path, coord, "cuda", torch.float32)
    torch.cuda.synchronize()
    _check_launches(wrappers, before, MATFREE_PATHS[path])
    if "pair_csr" in MATFREE_PATHS[path]:
        assert wrappers["pair_csr"].launches == before["pair_csr"] + 1
    ref = _matfree_path(path, coord.astype(np.float64), "cuda",
                        torch.float64)
    assert got[0].device.type == "cuda"
    if path.startswith("modes"):
        vals, vecs = got
        assert float(((vals.double() - ref[0]).abs() / ref[0]).max()) <= 1e-4
        overlap = torch.linalg.matrix_norm(vecs.double() @ ref[1].T, ord=-2)
        assert float(overlap) >= 1 - 1e-4
    else:
        assert _rel(got[0], ref[0]) <= 1e-3


# ---------------------------------------------------------------------------
# Tabulated families (the assembly kernels' table branch), the
# coordinates-to-factor-input kernel, the panel Cholesky and full-window
# panel inverse kernels
# ---------------------------------------------------------------------------

_AA = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
       "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")


def _ca_atoms(n, seed, chains=2, spread=None):
    """Random CA trace of `chains` chains with one numbering gap."""
    rng = np.random.RandomState(seed)
    atoms = sct.AtomArray(n)
    spread = 34.0 * (n / 300) ** (1 / 3) if spread is None else spread
    atoms.coord = (rng.rand(n, 3) * spread).astype(np.float32)
    atoms.atom_name = np.full(n, "CA")
    atoms.element = np.full(n, "C")
    atoms.chain_id = np.array(["ABCD"[i * chains // n] for i in range(n)])
    res_id = np.arange(1, n + 1)
    res_id[n // 3:] += 2                      # a gap: no bond across it
    atoms.res_id = res_id
    atoms.res_name = np.array(_AA)[rng.randint(0, 20, n)]
    return atoms


def _table_params(maker, atoms):
    if maker == "no_cutoff":
        rng = np.random.RandomState(5)
        intra, inter = rng.rand(20, 20) + 0.5, rng.rand(20, 20) + 0.5
        ff = sct.TabulatedForceField(atoms, 7.5, intra + intra.T,
                                     inter + inter.T, None)
    else:
        ff = getattr(sct.TabulatedForceField, maker)(atoms)
    return ff.to_compact_params()


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm", "d_enm", "no_cutoff"])
@pytest.mark.parametrize("b,n", [(3, 41), (2, 300), (1, 5), (1, 1776),
                                 (1, 3100), (2, 1777), (1, 8192)])
def test_table_branch_of_the_assembly_kernels(cuda, maker, b, n):
    """n = 3100 once staged 49.7 KB (coordinates, codes, edges) in K1 and
    K5, past the default 48 KB of shared memory; n % 4 != 0 takes the
    kernels' narrower stores; 8,192 is their largest path."""
    atoms = _ca_atoms(n, seed=n)
    params = _table_params(maker, atoms)
    rng = np.random.RandomState(n)
    coords = torch.as_tensor(
        atoms.coord[None] + 0.3 * rng.randn(b, n, 3).astype(np.float32),
        device=cuda)
    for wrapper, plain in (
            (assembly_kernels.hessian_planes_ensemble,
             assembly.hessian_planes_plain),
            (assembly_kernels.kirchhoff_ensemble, assembly.kirchhoff_plain),
            (assembly_kernels.hessian_xyz_ensemble,
             assembly.hessian_xyz_plain)):
        before = wrapper.launches, wrapper.table_launches
        got = wrapper(coords, params)
        assert (wrapper.launches, wrapper.table_launches) == (
            before[0] + 1, before[1] + 1)
        ref = plain(coords, params)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.device == coords.device
        assert _rel(got, ref) <= 1e-5, wrapper.__name__
        if wrapper is not assembly_kernels.kirchhoff_ensemble:
            _assert_hessian_parts(got, ref)
        del got, ref
    # same table entries pair for pair: the off-diagonal Kirchhoff
    # entries are the table's own values, so they agree bit for bit
    _assert_kirchhoff_parts(assembly_kernels.kirchhoff_ensemble(coords,
                                                                params),
                            assembly.kirchhoff_plain(coords, params))


def test_table_branch_on_a_bin_edge(cuda):
    """Distances exactly on sdENM's first edge (4.0) and its last (16.5,
    the cutoff) stay in the bin the edge closes; neighbours in the array
    are bonded."""
    atoms = _ca_atoms(20, seed=1, chains=1)
    atoms.res_id = np.arange(1, 21)
    params = sct.TabulatedForceField.sd_enm(atoms).to_compact_params()
    coord = np.zeros((1, 20, 3), dtype=np.float32)
    coord[0, :, 0] = [0.0, 0.25, 2.0, 4.0, 16.75] + [20.0 + 3.8 * i
                                                      for i in range(15)]
    got = assembly_kernels.kirchhoff_ensemble(
        torch.as_tensor(coord, device=cuda), params)[0].cpu().numpy()
    t = params.type_idx
    assert got[0, 3] == -params.intra_table[t[0], t[3], 0]
    assert got[1, 4] == -params.intra_table[t[1], t[4], 25]
    assert got[0, 4] == 0.0
    assert got[0, 1] == -params.bonded_table[t[0], t[1], 0]


def test_table_kernels_refuse_what_they_do_not_take(cuda):
    atoms = _ca_atoms(30, seed=2)
    ff = sct.TabulatedForceField.e_anm(atoms)
    coords = torch.as_tensor(atoms.coord[None], device=cuda)
    with pytest.raises(ValueError, match="no kernel"):
        assembly_kernels.kirchhoff_ensemble(coords, ff.to_params())
    with pytest.raises(ValueError, match="built for 30 atoms"):
        assembly_kernels.hessian_planes_ensemble(
            coords[:, :20].contiguous(), ff.to_compact_params())
    scale_h = torch.ones(1, 90, device=cuda)
    ts = torch.zeros(1, 90, 6, device=cuda)
    row_sums = torch.zeros(1, 30, 9, device=cuda)
    with pytest.raises(ValueError, match="analytic"):
        assembly_kernels.assembly_stitch(coords, ff.to_compact_params(),
                                         scale_h, ts, 128, row_sums)
    with pytest.raises(TypeError, match="float32"):
        assembly_kernels.assembly_stitch(coords.double(),
                                         sct.invariant_params(7.0),
                                         scale_h.double(), ts.double(), 128,
                                         row_sums.double())
    with pytest.raises(ValueError, match="exceeds"):
        assembly_kernels.assembly_stitch(
            torch.zeros(1, 2049, 3, device=cuda), sct.invariant_params(7.0),
            torch.ones(1, 6147, device=cuda),
            torch.zeros(1, 6147, 6, device=cuda), 6272,
            torch.zeros(1, 2049, 9, device=cuda))
    with pytest.raises(ValueError, match="exceeds"):
        assembly_kernels.assembly_row_sums(
            torch.zeros(1, 2049, 3, device=cuda), sct.invariant_params(7.0))
    with pytest.raises(ValueError, match="multiple of 4"):
        assembly_kernels.assembly_stitch(
            coords, sct.invariant_params(7.0), scale_h, ts, 126, row_sums)
    with pytest.raises(TypeError, match="float32"):
        assembly_kernels.assembly_stitch(
            coords, sct.invariant_params(7.0), scale_h, ts, 128,
            torch.zeros(1, 30, 9, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="exceeds"):
        spd_linalg.panel_cholesky(
            torch.eye(136, device=cuda).expand(2, 136, 136).contiguous())
    with pytest.raises(ValueError, match="exceeds"):
        spd_linalg.panel_inverse_full(
            torch.eye(136, device=cuda).expand(2, 136, 136).contiguous())


@pytest.mark.parametrize("kind,cutoff", [("invariant", 7.0),
                                         ("hinsen", None), ("pfenm", 7.0)])
@pytest.mark.parametrize("b,n,mp", [(3, 41, 128), (2, 32, 96),
                                    (2, 100, 384), (1, 5, 16),
                                    (1, 300, 1024), (2, 30, 512),
                                    (1, 2047, 6144), (1, 2048, 6144)])
@pytest.mark.parametrize("with_masses", [False, True])
def test_assembly_stitch_kernel(cuda, kind, cutoff, b, n, mp, with_masses):
    """Both passes against the plain version: n % 4 != 0 (the store
    pass's per-column instance), n = 2048 (196 KB of staged column side,
    the opt-in), one conformer, mp far past 3 n (pad columns)."""
    params = getattr(sct, f"{kind}_params")(cutoff)
    coords = torch.as_tensor(_coords(b, n, seed=n), device=cuda)
    masses = torch.linspace(0.8, 2.5, n, device=cuda) if with_masses \
        else None
    bases = rigid.rigid_modes_anm(coords, masses=masses)
    _, _, scale_h, ts = rigid._stitch_inputs_from_diag(
        rigid._hessian_diag_xyz_batched(coords, params), bases, masses)
    before = (assembly_kernels.assembly_stitch.launches,
              assembly_kernels.assembly_stitch.row_sum_launches)
    row_sums = assembly_kernels.assembly_row_sums(coords, params)
    got = assembly_kernels.assembly_stitch(coords, params, scale_h, ts, mp,
                                           row_sums)
    assert (assembly_kernels.assembly_stitch.launches,
            assembly_kernels.assembly_stitch.row_sum_launches) == (
                before[0] + 1, before[1] + 1)
    ref = assembly_kernels.assembly_stitch_plain(coords, params, scale_h,
                                                 ts, mp)
    torch.cuda.synchronize()
    assert got.shape == (b, mp, mp)
    assert _rel(got, ref) <= 1e-5
    assert torch.equal(got[:, 3 * n:, :], ref[:, 3 * n:, :])
    assert torch.equal(got[:, :, 3 * n:], ref[:, :, 3 * n:])
    # the store pass is deterministic, and the plain version handed the
    # same row sums agrees as closely
    again = assembly_kernels.assembly_stitch(coords, params, scale_h, ts, mp,
                                             row_sums)
    assert torch.equal(again, got)
    assert _rel(got, assembly_kernels.assembly_stitch_plain(
        coords, params, scale_h, ts, mp, row_sums)) <= 1e-5
    del ref, again
    # and the two-kernel route it fuses
    two = assembly_kernels.regularize_stitch(
        assembly_kernels.hessian_planes_ensemble(coords, params), scale_h,
        ts, mp)
    assert _rel(got, two) <= 1e-5


@pytest.mark.parametrize("kind,cutoff", [("invariant", 7.0),
                                         ("hinsen", None), ("pfenm", 7.0)])
@pytest.mark.parametrize("b,n", [(3, 41), (128, 300), (1, 5), (1, 2048)])
def test_assembly_row_sums_kernel(cuda, kind, cutoff, b, n):
    """The first pass of K7 against its plain version: the nine diagonal
    superelements in another summation order, 1e-5 of max as the
    assembly."""
    params = getattr(sct, f"{kind}_params")(cutoff)
    coords = torch.as_tensor(_coords(b, n, seed=n), device=cuda)
    before = assembly_kernels.assembly_stitch.row_sum_launches
    got = assembly_kernels.assembly_row_sums(coords, params)
    assert assembly_kernels.assembly_stitch.row_sum_launches == before + 1
    ref = assembly_kernels.assembly_row_sums_plain(coords, params)
    torch.cuda.synchronize()
    assert got.shape == (b, n, 9) and got.device == coords.device
    assert _rel(got, ref) <= 1e-5
    assert _rel(rigid._diagonal_of_row_sums(got),
                rigid._hessian_diag_xyz_batched(coords, params)) <= 1e-5


@pytest.mark.parametrize("pb", [8, 16, 64, 128])
def test_panel_cholesky_kernel(cuda, pb):
    """pb = 128 holds 66 KB of shared memory: the opt-in branch."""
    panels = torch.as_tensor(_spd_panels(5, pb, seed=pb), device=cuda)
    before = spd_linalg.panel_cholesky.launches
    got = spd_linalg.panel_cholesky(panels)
    assert spd_linalg.panel_cholesky.launches == before + 1
    ref = spd_linalg.panel_cholesky_plain(panels)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 2e-5
    assert float((got - torch.linalg.cholesky(panels.double())
                  ).abs().max()) <= 2e-5
    upper = torch.triu(got, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))
    l, w = sct.panel_cholesky_batched(panels)
    assert torch.equal(l, got)
    eye = torch.eye(pb, device=cuda, dtype=torch.float64)
    assert float((w.double() @ l.double() - eye).abs().max()) <= 1e-4


def test_panel_cholesky_kernel_breakdown_is_not_finite(cuda):
    panels = _spd_panels(3, 64, seed=1)
    panels[1, 5, 5] = -1.0
    got = spd_linalg.panel_cholesky(torch.as_tensor(panels, device=cuda))
    assert not bool(torch.isfinite(got[1]).all())
    assert bool(torch.isfinite(got[0]).all())
    assert bool(torch.isfinite(got[2]).all())


@pytest.mark.parametrize("pb", [8, 16, 24, 32, 64])
def test_panel_inverse_full_kernel_equals_the_shrink_kernel(cuda, pb):
    """K9 equals K3 and the plain version bit for bit (128 panels at
    pb = 64, the main path's shape); a non-SPD panel gives a non-finite
    output."""
    panels = torch.as_tensor(_spd_panels(128 if pb == 64 else 5, pb,
                                         seed=pb), device=cuda)
    shrink = sct.panel_inverse_batched(panels, shrink_block=8)
    ref = spd_linalg.panel_inverse_plain(panels)
    before = (spd_linalg.panel_inverse_full.launches,
              spd_linalg.panel_inverse_batched.launches)
    got = sct.panel_inverse_batched(panels, shrink_block=None)
    assert (spd_linalg.panel_inverse_full.launches,
            spd_linalg.panel_inverse_batched.launches) == (before[0] + 1,
                                                           before[1])
    torch.cuda.synchronize()
    assert torch.equal(got, shrink)
    assert torch.equal(got, ref)
    bad = panels.clone()
    bad[1, 5, 5] = -1.0
    out = spd_linalg.panel_inverse_full(bad)
    assert not bool(torch.isfinite(out[1]).all())
    assert bool(torch.isfinite(out[0]).all())


def test_spd_inverse_blocked_on_cuda(cuda):
    a = torch.as_tensor(_spd_panels(4, 300, seed=3), device=cuda)
    before = spd_linalg.panel_inverse_batched.launches
    inv = sct.spd_inverse_blocked(a)
    assert spd_linalg.panel_inverse_batched.launches > before
    assert inv.shape == (4, 300, 300)
    assert _rel(inv, torch.linalg.inv(a.double())) <= 1e-4


def _check_launches(wrappers, before, expected, table=()):
    for name, wrapper in wrappers.items():
        grew = wrapper.launches > before[name]
        assert grew == (name in expected), name
    for name in table:
        assert wrappers[name].table_launches > 0, name


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm"])
def test_tabulated_slice_on_cuda(cuda, maker):
    atoms = _ca_atoms(100, seed=7)
    ff = getattr(sct.TabulatedForceField, maker)(atoms)
    rng = np.random.RandomState(0)
    coords = atoms.coord[None] + 0.05 * rng.randn(4, 100, 3).astype(
        np.float32)
    masses = np.linspace(0.8, 2.5, 100).astype(np.float32)
    wrappers = sct.kernel_wrappers()
    for name in ("hessian_planes", "hessian_xyz", "kirchhoff"):
        wrappers[name].table_launches = 0

    def snapshot():
        return {name: w.launches for name, w in wrappers.items()}

    before = snapshot()
    got = sct.ensemble_anm_fluctuations(coords, ff, masses=masses,
                                        with_prs=True, chunk=2)
    _check_launches(wrappers, before, {"hessian_planes", "regularize_stitch",
                                       "panel_inverse"}, ("hessian_planes",))
    ref = sct.ensemble_anm_fluctuations(
        coords.astype(np.float64), ff, masses=masses.astype(np.float64),
        with_prs=True, inverse="cho_solve", dtype=torch.float64)
    for key in ref:
        assert got[key].device.type == "cuda"
        assert _rel(got[key], ref[key]) <= 1e-4, key

    before = snapshot()
    got = sct.ensemble_gnm_fluctuations(coords, ff, masses=masses)
    _check_launches(wrappers, before, {"kirchhoff", "panel_inverse"},
                    ("kirchhoff",))
    ref = sct.ensemble_gnm_fluctuations(
        coords.astype(np.float64), ff, masses=masses.astype(np.float64),
        inverse="cho_solve", dtype=torch.float64)
    for key in ref:
        assert _rel(got[key], ref[key]) <= 1e-4, key

    before = snapshot()
    got = sct.anm_fluctuations(coords[0], ff, with_prs=True)
    _check_launches(wrappers, before, {"hessian_xyz"}, ("hessian_xyz",))
    ref = sct.anm_fluctuations(coords[0].astype(np.float64), ff,
                               with_prs=True, dtype=torch.float64)
    for key in ref:
        assert _rel(got[key], ref[key]) <= 1e-4, key

    # table_pair: no kernel in either package, plain assembly on the card
    before = snapshot()
    got = sct.ensemble_anm_fluctuations(coords, ff.to_params(),
                                        with_covariance=False)
    _check_launches(wrappers, before, {"panel_inverse"})
    same = sct.ensemble_anm_fluctuations(coords, ff, with_covariance=False)
    for key in same:
        assert _rel(got[key], same[key]) <= 1e-4, key


@pytest.mark.parametrize("kind,cutoff", [("invariant", 13.0),
                                         ("hinsen", None)])
@pytest.mark.parametrize("with_masses", [False, True])
def test_direct_prep_on_cuda(cuda, kind, cutoff, with_masses):
    params = getattr(sct, f"{kind}_params")(cutoff)
    coords = _coords(4, 100, seed=3, spread=34.0 * (1 / 3) ** (1 / 3))
    masses = (np.linspace(0.8, 2.5, 100).astype(np.float32)
              if with_masses else None)
    wrappers = sct.kernel_wrappers()
    for options in ({"with_covariance": False}, {"with_prs": True}):
        before = {name: w.launches for name, w in wrappers.items()}
        got = sct.ensemble_anm_fluctuations(coords, params, masses=masses,
                                            prep="direct", chunk=2,
                                            **options)
        _check_launches(wrappers, before, {"assembly_stitch",
                                           "panel_inverse"})
        planes = sct.ensemble_anm_fluctuations(coords, params, masses=masses,
                                               prep="planes", **options)
        ref = sct.ensemble_anm_fluctuations(
            coords.astype(np.float64), params,
            masses=None if masses is None else masses.astype(np.float64),
            inverse="cho_solve", dtype=torch.float64, **options)
        for key in ref:
            assert _rel(got[key], planes[key]) <= 1e-4, key
            assert _rel(got[key], ref[key]) <= 1e-4, key


# ---------------------------------------------------------------------------
# The table branch of the matrix-free kernels, the assembly kernels past
# 4,096 atoms, patch overlays
# ---------------------------------------------------------------------------

def _sorted_table_layout(n, seed, maker="sd_enm", chains=2, tile=256):
    """A tabulated family on a Morton-sorted layout: sorted coordinates,
    the parameters in the sorted order, original ids, neighbour lists."""
    atoms = _ca_atoms(n, seed, chains=chains)
    params = _table_params(maker, atoms)
    perm = matfree.spatial_sort_permutation(atoms.coord)
    cutoff = np.sqrt(params.cutoff_sq) if params.has_cutoff else 1e9
    nbr, counts = matfree.tile_neighbor_lists(atoms.coord[perm], cutoff,
                                              tile)
    return (atoms.coord[perm], params, params.permuted(perm),
            perm.astype(np.int32), nbr, counts)


@pytest.mark.parametrize("k", [1, 48, 70])
@pytest.mark.parametrize("n,tile", [(257, 256), (1000, 256), (300, 16)])
@pytest.mark.parametrize("maker", ["sd_enm", "e_anm", "no_cutoff"])
def test_table_branch_of_the_matfree_kernels(cuda, maker, n, tile, k):
    """K13 and K14 in Morton order (codes by slot, bonded pairs by original
    id: array neighbours land in different tiles) and K12 in atom order,
    each against its plain version on the same CUDA tensors, the pair-CSR
    build and K12 counted as table launches; K13 also against the float64
    row-blocked operator in the original order."""
    coord, params, sorted_params, ids, nbr, counts = _sorted_table_layout(
        n, seed=n + k, maker=maker, tile=tile)
    c = torch.as_tensor(coord, device=cuda)
    rng = np.random.RandomState(k)
    x3 = torch.as_tensor(rng.randn(3 * n, k).astype(np.float32), device=cuda)
    x1 = torch.as_tensor(rng.randn(n, k).astype(np.float32), device=cuda)
    csr = matfree.tile_csr(nbr, counts, ids, n, tile, cuda)
    build = matfree.pair_csr
    for fn, plain, x in (
            (matfree.hessian_apply_sparse,
             matfree.hessian_apply_sparse_plain, x3),
            (matfree.kirchhoff_apply_sparse,
             matfree.kirchhoff_apply_sparse_plain, x1)):
        before = fn.launches, build.launches, build.table_launches
        got = fn(c, x, sorted_params, nbr, counts, ids, tile=tile)
        # the table branch is the build's; the gather reads the constants
        assert (fn.launches, build.launches, build.table_launches) == (
            before[0] + 1, before[1] + 1, before[2] + 1)
        ref = plain(c, x, sorted_params, csr, tile)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 1e-5, fn.__name__
    inv = np.argsort(ids)
    original = torch.as_tensor(coord[inv], device=cuda)
    rows = np.concatenate([a * n + inv for a in range(3)])
    exact = matfree.hessian_apply(original.double(), x3[rows].double(),
                                  params, dtype=torch.float64)
    got = matfree.hessian_apply_sparse(c, x3, sorted_params, nbr, counts,
                                       ids, tile=tile)
    assert _rel(got[rows], exact) <= 1e-5
    if tile == 256:
        before = matfree.hessian_apply_dense.table_launches
        got = matfree.hessian_apply_dense(original, x3[rows], params)
        assert matfree.hessian_apply_dense.table_launches == before + 1
        ref = matfree.hessian_apply_dense_plain(original, x3[rows], params)
        assert _rel(got, ref) <= 1e-5
        assert _rel(got, exact) <= 1e-5


def test_matfree_table_branch_on_a_bin_edge_and_a_split_bond(cuda):
    """Pairs exactly on sdENM's first edge (4.0) and on its last (16.5,
    the cutoff) stay in the bin the edge closes, and a bonded pair whose
    atoms sit in different tiles takes the bonded table: K @ e_j reads
    single constants back."""
    n, tile = 40, 16
    atoms = _ca_atoms(n, seed=1, chains=1)
    atoms.res_id = np.arange(1, n + 1)
    params = sct.TabulatedForceField.sd_enm(atoms).to_compact_params()
    coord = np.zeros((n, 3), dtype=np.float32)
    coord[:, 0] = [0.0, 0.25, 2.0, 4.0, 16.75] + [40.0 + 3.8 * i
                                                  for i in range(n - 5)]
    # slots: atom 1 moves to the far end, so the bonded pair (0, 1) and the
    # cutoff pair (1, 4) straddle tiles
    perm = np.array([0] + list(range(2, n)) + [1])
    nbr = np.tile(np.arange(3, dtype=np.int32), (3, 1))
    counts = np.full(3, 3, np.int32)
    eye = torch.eye(n, device=cuda)
    got = matfree.kirchhoff_apply_sparse(
        torch.as_tensor(coord[perm], device=cuda), eye,
        params.permuted(perm), nbr, counts, perm.astype(np.int32),
        tile=tile).cpu().numpy()
    slot = np.argsort(perm)
    t = params.type_idx
    assert got[slot[0], slot[3]] == -params.intra_table[t[0], t[3], 0]
    assert got[slot[1], slot[4]] == -params.intra_table[t[1], t[4], 25]
    assert got[slot[0], slot[4]] == 0.0
    assert got[slot[0], slot[1]] == -params.bonded_table[t[0], t[1], 0]
    assert got[slot[1], slot[2]] == -params.bonded_table[t[1], t[2], 0]


def test_matfree_table_kernels_refuse_what_they_do_not_take(cuda):
    atoms = _ca_atoms(300, seed=2)
    ff = sct.TabulatedForceField.e_anm(atoms)
    c = torch.as_tensor(atoms.coord, device=cuda)
    x = torch.zeros(900, 4, device=cuda)
    nbr, counts = matfree.tile_neighbor_lists(atoms.coord, 13.0, 256)
    with pytest.raises(ValueError, match="table_pair"):
        matfree.hessian_apply_sparse(c, x, ff.to_params(), nbr, counts)
    with pytest.raises(ValueError, match="table_pair"):
        sct.lowest_modes_matfree(atoms.coord, ff.to_params(), 3)
    params = ff.to_compact_params()
    with pytest.raises(TypeError, match="float32"):
        matfree.hessian_apply_dense(c, x, params, dtype=torch.float64)
    with pytest.raises(ValueError, match="built for 300 atoms"):
        matfree.hessian_apply_dense(c[:200].contiguous(), x[:600], params)
    many = params.replace(edges_sq=tuple(float(i + 1) for i in range(65)),
                          n_bins=65, **{
        f: np.zeros((20, 20, 65), np.float32)
        for f in ("intra_table", "inter_table", "bonded_table")})
    with pytest.raises(ValueError, match="at most 64 bin edges"):
        matfree.hessian_apply_dense(c, x, many)


@pytest.mark.parametrize("n", [4096, 4097, 8192])
@pytest.mark.parametrize("maker", [None, "sd_enm"])
def test_assembly_kernels_tile_past_4096_atoms(cuda, n, maker):
    """One structure on both sides of the size where the assembly kernels
    once stopped staging a whole conformer and walked column tiles (they
    now read column atoms from device memory at any size): K1, K5 and K6
    against their plain versions, both families."""
    if maker is None:
        params = sct.invariant_params(13.0)
        coord = _protein_blob(n, seed=n)
    else:
        # compact parameters straight from the tables: the force-field
        # object would hold an (n, n, 26) table
        small = _table_params(maker, _ca_atoms(40, seed=3))
        rng = np.random.RandomState(n)
        chain = (np.arange(n) * 3 // n).astype(np.int32)
        params = small.replace(
            type_idx=rng.randint(0, 20, n).astype(np.int32),
            chain_code=chain,
            bonded_next=np.concatenate([chain[:-1] == chain[1:], [False]]))
        coord = _protein_blob(n, seed=n)
    c = torch.as_tensor(coord[None], device=cuda)
    for wrapper, plain in (
            (assembly_kernels.kirchhoff_ensemble, assembly.kirchhoff_plain),
            (assembly_kernels.hessian_xyz_ensemble,
             assembly.hessian_xyz_plain),
            (assembly_kernels.hessian_planes_ensemble,
             assembly.hessian_planes_plain)):
        before = wrapper.table_launches
        got = wrapper(c, params)
        assert wrapper.table_launches == before + (maker is not None)
        ref = plain(c, params)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 1e-5, wrapper.__name__
        if wrapper is assembly_kernels.kirchhoff_ensemble:
            off = ~torch.eye(n, dtype=torch.bool, device=cuda)
            assert torch.equal(got[0][off], ref[0][off])
        else:
            _assert_hessian_parts(got, ref)
        del got, ref
        torch.cuda.empty_cache()


def _patch(coord, cutoff, seed=0):
    """A patch on `coord`: one atom shut down and re-attached to its six
    nearest neighbours, two pairs off, two pairs on beyond the cutoff."""
    rng = np.random.RandomState(seed)
    picks = rng.permutation(len(coord))[:5]
    shut, others = picks[0], picks[1:]

    def distances(atom):
        d = np.linalg.norm(coord - coord[atom], axis=1)
        d[shut] = 0.0
        return d

    on = [(shut, q) for q in np.argsort(
        np.linalg.norm(coord - coord[shut], axis=1))[1:7]]
    off = []
    for atom in others[:2]:
        d = distances(atom)
        inside = np.flatnonzero((d > 0) & (d <= 0.8 * cutoff))
        off.append((atom, inside[np.argmax(d[inside])]))
    for atom in others[2:]:
        far = np.flatnonzero(distances(atom) > 1.05 * cutoff)
        if len(far):
            on.append((atom, far[0]))
    return dict(contact_shutdown=[shut], contact_pair_off=np.asarray(off),
                contact_pair_on=np.asarray(on),
                force_constants=rng.uniform(0.5, 2.0, len(on)))


@pytest.mark.parametrize("maker", [None, "e_anm"])
def test_overlays_on_the_dense_paths_on_cuda(cuda, maker):
    """The kernels assemble the base family and the sparse correction
    follows: the corrected matrices against the dense plain route with the
    overlay, and the float32 paths against float64 ``cho_solve``, with the
    launches of their own kernels (dense Hessians, never planes).  eANM,
    not sdENM: a re-attached atom on springs of order one beside sdENM's
    bonded constant of 1085 leaves the float32 covariance of this
    100-atom blob 2.9e-4 off float64."""
    atoms = _ca_atoms(100, seed=7)
    inner = (sct.InvariantForceField(13.0) if maker is None
             else getattr(sct.TabulatedForceField, maker)(atoms))
    cutoff = 13.0 if maker is None else float(inner.cutoff_distance)
    patch = _patch(atoms.coord, cutoff)
    params = sct.PatchedForceField(inner, **patch).to_params(natoms=100)
    if maker is not None:
        params = inner.to_compact_params().replace(overlays=params.overlays)
    rng = np.random.RandomState(0)
    coords = atoms.coord[None] + 0.05 * rng.randn(4, 100, 3).astype(
        np.float32)
    c = torch.as_tensor(coords, device=cuda)
    for wrapper, plain in (
            (assembly_kernels.kirchhoff_ensemble, assembly.kirchhoff_plain),
            (assembly_kernels.hessian_xyz_ensemble,
             assembly.hessian_xyz_plain)):
        got, ref = wrapper(c, params), plain(c, params)
        assert _rel(got, ref) <= 1e-5, wrapper.__name__
        assert _rel(wrapper(c, sct.strip_overlays(params)), ref) > 1e-3
    with pytest.raises(ValueError, match="no patch overlays"):
        assembly_kernels.hessian_planes_ensemble(c, params)

    wrappers = sct.kernel_wrappers()
    table = ("hessian_xyz",) if maker else ()
    for prep in ("planes", "direct"):
        before = {name: w.launches for name, w in wrappers.items()}
        got = sct.ensemble_anm_fluctuations(coords, params, with_prs=True,
                                            chunk=2, prep=prep)
        _check_launches(wrappers, before, {"hessian_xyz", "panel_inverse"},
                        table)
        ref = sct.ensemble_anm_fluctuations(
            coords.astype(np.float64), params, with_prs=True,
            inverse="cho_solve", dtype=torch.float64)
        for key in ref:
            assert _rel(got[key], ref[key]) <= 1e-4, key
    before = {name: w.launches for name, w in wrappers.items()}
    got = sct.ensemble_gnm_fluctuations(coords, params)
    _check_launches(wrappers, before, {"kirchhoff", "panel_inverse"},
                    ("kirchhoff",) if maker else ())
    ref = sct.ensemble_gnm_fluctuations(
        coords.astype(np.float64), params, inverse="cho_solve",
        dtype=torch.float64)
    for key in ref:
        assert _rel(got[key], ref[key]) <= 1e-4, key
    before = {name: w.launches for name, w in wrappers.items()}
    got = sct.anm_fluctuations(coords[0], params, with_prs=True)
    _check_launches(wrappers, before, {"hessian_xyz"}, table)
    ref = sct.anm_fluctuations(coords[0].astype(np.float64), params,
                               with_prs=True, dtype=torch.float64)
    for key in ref:
        assert _rel(got[key], ref[key]) <= 1e-4, key


@pytest.mark.parametrize("maker", [None, "sd_enm"])
def test_overlays_on_the_matfree_paths_on_cuda(cuda, maker):
    """Operators and solvers with an overlay in Morton order on the card,
    against the float64 dense assembly with the same overlay."""
    n = 600
    atoms = _ca_atoms(n, seed=11)
    if maker is None:
        base, cutoff = sct.invariant_params(13.0), 13.0
    else:
        base = _table_params(maker, atoms)
        cutoff = float(np.sqrt(base.cutoff_sq))
    overlay = sct.PatchedForceField(
        sct.InvariantForceField(1.0), **_patch(atoms.coord, cutoff)
    ).to_params(natoms=n).overlays[0]
    params = base.replace(overlays=(overlay,))
    c64 = torch.as_tensor(atoms.coord[None], dtype=torch.float64,
                          device=cuda)
    h64 = pipeline._build_hessians_batched(c64, params, None)[0]
    k64 = pipeline._build_kirchhoffs_batched(c64, params, None)[0]
    x = torch.randn(3 * n, 5, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    wrappers = sct.kernel_wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    vals, _, _ = sct.lowest_modes_matfree(atoms.coord, params, 5, degree=48,
                                          n_outer=16, tol=2e-4)
    _check_launches(wrappers, before, {"hessian_apply_sparse", "pair_csr"},
                    ("pair_csr",) if maker else ())
    ref = torch.linalg.eigvalsh(h64)[6:11]
    assert float(((vals.double() - ref).abs() / ref).max()) <= 1e-4
    vals, _, _ = sct.lowest_modes_matfree_gnm(atoms.coord, params, 5,
                                              degree=48, n_outer=16,
                                              tol=2e-4)
    ref = torch.linalg.eigvalsh(k64)[1:6]
    assert float(((vals.double() - ref).abs() / ref).max()) <= 1e-4
    # the dense-grid kernel with the correction behind it
    got = matfree.hessian_apply_dense(
        torch.as_tensor(atoms.coord, device=cuda), x, params)
    assert _rel(got, h64 @ x.double()) <= 1e-5
    # without the overlay the operator is another one
    base_apply = matfree.hessian_apply_dense(
        torch.as_tensor(atoms.coord, device=cuda), x, base)
    assert _rel(base_apply, h64 @ x.double()) > 1e-3


def test_use_pallas_false_is_refused_on_cuda(cuda):
    """``use_pallas=False`` asks for the plain versions, which are for the
    CPU: on CUDA the entry points and the matrix-free solvers raise
    before any launch; the other values run the kernels."""
    coords = torch.as_tensor(_coords(2, 30, seed=5), device=cuda)
    params = sct.invariant_params(7.0)
    wrappers = sct.kernel_wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    for call in (
            lambda: sct.ensemble_anm_fluctuations(coords, params,
                                                  use_pallas=False),
            lambda: sct.gnm_fluctuations(coords[0], params,
                                         use_pallas=False),
            lambda: sct.anm_spectral(coords[0], params, use_pallas=False),
            lambda: sct.lowest_modes_matfree(coords[0], params, 3,
                                             use_pallas=False),
            lambda: sct.covariance_solve_matfree_gnm(
                coords[0], params, torch.ones(30, device=cuda),
                use_pallas=False)):
        with pytest.raises(ValueError, match="for the CPU"):
            call()
    assert all(w.launches == before[name] for name, w in wrappers.items())
    for value in ("auto", None, True):
        out = sct.ensemble_anm_fluctuations(coords, params,
                                            use_pallas=value)
        assert out["msf"].device.type == "cuda"
    assert wrappers["panel_inverse"].launches > before["panel_inverse"]


@pytest.mark.parametrize("engine", ["auto", "invfactor", "chol"])
def test_lowest_modes_anm_on_cuda(cuda, engine):
    """The lowest modes of a 300-residue structure in float32 on the card
    (``"auto"`` takes ``"invfactor"``: K3 at the inverse factor's
    leaves) against float64 ``eigh``, then refined in float64 on the
    card to 1e-6 relative."""
    coord = torch.as_tensor(_coords(1, 300, seed=8, spread=34.0)[0],
                            device=cuda)
    params = sct.invariant_params(13.0)
    h = assembly_kernels.hessian_xyz_ensemble(coord[None], params)[0]
    before = spd_linalg.panel_inverse_batched.launches
    vals, vecs = sct.lowest_modes_anm(h, coord, 14, engine=engine)
    launched = spd_linalg.panel_inverse_batched.launches > before
    assert launched == (engine != "chol")
    h64 = assembly.hessian_matrix(coord.double(), params, layout="xyz")
    ref = torch.linalg.eigvalsh(h64)
    norm = float(ref.abs().max())
    assert float((vals[:10].double() - ref[6:16]).abs().max()) <= 1e-4 * norm
    u = vecs[:10].double()
    res = torch.linalg.vector_norm(h64 @ u.T - u.T * vals[:10].double(),
                                   dim=0)
    assert float(res.max()) <= 5e-4 * norm
    theta, refined, _ = sct.refine_modes_f64(coord, params, vecs)
    assert refined.dtype == torch.float64 and refined.device.type == "cuda"
    assert float(((theta[:10] - ref[6:16]).abs() / ref[6:16]).max()) <= 1e-6


# ---------------------------------------------------------------------------
# K8 redesigned (the state in registers, 16-byte accesses) and the
# reference-compatible model API on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 5, 128])
@pytest.mark.parametrize("pb", [8, 16, 64, 72, 128])
def test_panel_cholesky_kernel_is_its_plain_version_bit_for_bit(cuda, pb,
                                                                count):
    """One warp a panel at pb 8, 8 rows a warp above; 1, 2 or 4 slots a
    lane (pb 72: 4, the last lanes idle)."""
    panels = torch.as_tensor(_spd_panels(count, pb, seed=pb + count),
                             device=cuda)
    before = spd_linalg.panel_cholesky.launches
    got = spd_linalg.panel_cholesky(panels)
    assert spd_linalg.panel_cholesky.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, spd_linalg.panel_cholesky_plain(panels))
    upper = torch.triu(got, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))


@pytest.mark.parametrize("pb", [16, 64, 128])
def test_panel_cholesky_kernel_on_offset_panels(cuda, pb):
    """K8 moves the panel in 16-byte accesses: contiguous panels that
    start one float past a 16-byte boundary are refused before any
    launch; a view from a later panel of a batch is aligned and taken."""
    panels = torch.as_tensor(_spd_panels(3, pb, seed=pb), device=cuda)
    shifted = torch.empty(panels.numel() + 1, device=cuda)[1:].view(
        panels.shape).copy_(panels)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    before = spd_linalg.panel_cholesky.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        spd_linalg.panel_cholesky(shifted)
    assert spd_linalg.panel_cholesky.launches == before
    later = panels[1:]
    assert later.storage_offset() > 0
    assert torch.equal(spd_linalg.panel_cholesky(later),
                       spd_linalg.panel_cholesky_plain(later))


def _model_ca(n=None):
    import os

    atoms = sct.load_structure(os.path.join(
        os.path.dirname(os.path.realpath(__file__)), "data",
        "1l2y.pdb" if n is None else "7cal.pdb"), model=1)
    ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
    return ca if n is None else ca[:n]


def _model_rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("model", ["ANM", "GNM"])
def test_model_api_on_cuda_matches_the_cpu(cuda, model):
    """The model API on the card in float64 against the same model on the
    CPU (1l2y): eigenvalues within 1e-10 of max|lambda|, the
    covariance-derived outputs within 1e-8 of max|x|, the interaction
    matrices within 1e-12."""
    ca = _model_ca()
    n = ca.array_length()
    if model == "ANM":
        def make(device):
            return sct.ANM(ca, sct.TabulatedForceField.e_anm(ca),
                           masses=True, device=device)
    else:
        def make(device):
            return sct.GNM(ca, sct.InvariantForceField(7.0), device=device)
    card, host = make(cuda), make("cpu")
    assert card._device.type == "cuda"
    vals, ref = card.eigen()[0], host.eigen()[0]
    assert np.abs(vals - ref).max() <= 1e-10 * np.abs(ref).max()
    force = np.random.RandomState(0).randn(n, 3)
    outputs = [lambda m: m.covariance, lambda m: m.mean_square_fluctuation(),
               lambda m: m.bfactor(), lambda m: m.dcc(),
               lambda m: m.dcc(mode_subset=np.arange(8, 20))]
    if model == "ANM":
        outputs += [lambda m: m.prs_effector_sensor()[0],
                    lambda m: m.prs_effector_sensor()[1],
                    lambda m: m.linear_response(force)]
    for get in outputs:
        got = get(card)
        assert isinstance(got, np.ndarray)
        assert _model_rel(got, get(host)) <= 1e-8
    compute = sct.compute_hessian if model == "ANM" else \
        sct.compute_kirchhoff
    field = sct.InvariantForceField(7.0)
    matrix, pairs = compute(ca.coord, field, device=cuda)
    ref_matrix, ref_pairs = compute(ca.coord, field, device="cpu")
    assert _model_rel(matrix, ref_matrix) <= 1e-12
    np.testing.assert_array_equal(pairs, ref_pairs)


def test_model_squared_distances_match_the_host(cuda):
    """The float32 squared distances that decide the solve's cutoff are
    the host's bit for bit on the card (7cal's CA trace)."""
    from springcraft_tpu_torch.ops.ffparams import pairwise_sq_distance

    c = torch.as_tensor(_model_ca(1776).coord, dtype=torch.float32)
    assert torch.equal(pairwise_sq_distance(c.to(cuda))[1].cpu(),
                       pairwise_sq_distance(c)[1])


def flip_cutoff(ca):
    """A cutoff that puts one pair of `ca` inside it by its float32
    coordinates and outside it by its float64 ones: the float32 squared
    distance of the first pair past 40 A^2 that float32 rounding
    shortens."""
    import math

    from springcraft_tpu_torch.ops.ffparams import pairwise_sq_distance

    c64 = torch.as_tensor(ca.coord, dtype=torch.float64)
    s64 = pairwise_sq_distance(c64)[1]
    s32 = pairwise_sq_distance(c64.float())[1]
    i, j = torch.nonzero(torch.triu((s32.double() < s64) & (s64 > 40),
                                    1))[0]
    cutoff = math.sqrt(float(s32[i, j]))
    flipped = (s64 <= cutoff ** 2) != (s32 <= np.float32(cutoff ** 2))
    assert int(flipped.sum()) == 2
    return cutoff


@pytest.mark.parametrize("model, trivial", [("ANM", 6), ("GNM", 1)])
def test_model_lowest_modes_solve_the_float64_pairs(cuda, model, trivial):
    """On a cutoff that float32 coordinates put one pair of 1l2y inside
    and float64 ones outside, ``lowest_modes(5, refine=True)`` on the
    card meets the dense float64 eigenvalues to 1e-6."""
    ca = _model_ca()
    m = getattr(sct, model)(ca, sct.InvariantForceField(flip_cutoff(ca)),
                            device=cuda)
    dense = m.eigen()[0][trivial:trivial + 5]
    vals, _, res = m.lowest_modes(5, refine=True)
    assert np.abs(vals - dense).max() / np.abs(dense).max() <= 1e-6
    assert res.max() <= 1e-4


def test_model_api_launches_its_kernels(cuda):
    """``ANM.lowest_modes`` reaches K3 (the ``"invfactor"`` engine) and,
    matrix-free, the pair CSR and K13; ``ANM.linear_response(
    matrix_free=True)`` K13; the GNM twins K3 and K14.  The refined
    eigenvalues match the dense float64 spectrum to 1e-6."""
    from springcraft_tpu_torch.ops import matfree as tmatfree

    ca = _model_ca(120)
    wrappers = sct.kernel_wrappers()
    anm = sct.ANM(ca, sct.TabulatedForceField.e_anm(ca), masses=True,
                  device=cuda)
    gnm = sct.GNM(ca, sct.InvariantForceField(7.0), device=cuda)
    force = np.random.RandomState(3).randn(120, 3)
    for model, call, kernels in (
            (anm, lambda: anm.lowest_modes(5, refine=True),
             ("panel_inverse",)),
            (anm, lambda: anm.lowest_modes(5, matrix_free=True,
                                           refine=True),
             ("pair_csr", "hessian_apply_sparse")),
            (anm, lambda: anm.linear_response(force, matrix_free=True),
             ("pair_csr", "hessian_apply_sparse")),
            (gnm, lambda: gnm.lowest_modes(5, refine=True),
             ("panel_inverse",)),
            (gnm, lambda: gnm.lowest_modes(5, matrix_free=True,
                                           refine=True),
             ("pair_csr", "kirchhoff_apply_sparse"))):
        before = {name: wrappers[name].launches for name in kernels}
        out = call()
        torch.cuda.synchronize()
        for name in kernels:
            assert wrappers[name].launches > before[name], name
        if isinstance(out, tuple):
            trivial = 6 if model is anm else 1
            dense = model.eigen()[0][trivial:trivial + 5]
            assert np.abs(out[0] - dense).max() / np.abs(dense).max() <= 1e-6
        else:
            assert _model_rel(out, anm.linear_response(force)) <= 1e-4
    assert tmatfree.hessian_apply_sparse.launches > 0


# ---------------------------------------------------------------------------
# The second matrix-free slice: the estimators and the degree passes over
# the pair CSR on the kernel route
# ---------------------------------------------------------------------------

def _blob_modes(coord, k, gnm=False):
    """The `k` lowest non-trivial float64 modes of `coord` under the
    invariant field (13 A) from a dense ``eigh`` on the CPU, xyz layout."""
    c = torch.as_tensor(coord, dtype=torch.float64)
    params = sct.invariant_params(13.0)
    if gnm:
        vals, vecs = torch.linalg.eigh(assembly.kirchhoff_matrix(c, params))
        return vals[1:1 + k].numpy(), vecs[:, 1:1 + k].T.numpy().copy()
    vals, vecs = torch.linalg.eigh(assembly.hessian_matrix(c, params,
                                                           layout="xyz"))
    return vals[6:6 + k].numpy(), vecs[:, 6:6 + k].T.numpy().copy()


#: estimator -> (its arguments after (coord, params) from (modes, GNM
#: modes, prs_diag), its keywords, its float outputs); "_deflated" adds
#: the modes as the control variate
ESTIMATORS = {
    "effector_sensor_matfree": (lambda md, gm, pd: ([0, 250, 599],),
                                lambda md, gm, pd: dict(prs_diag=pd), 2),
    "prs_diag_stochastic": (lambda md, gm, pd: (md,), None, 2),
    "msf_stochastic": (lambda md, gm, pd: (md,), None, 2),
    "msf_stochastic_gnm": (lambda md, gm, pd: (gm,), None, 2),
    "effector_sensor_stochastic": (lambda md, gm, pd: (pd,), None, 4),
    "effector_sensor_stochastic_deflated": (
        lambda md, gm, pd: (pd,), lambda md, gm, pd: dict(modes=md), 4),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_matfree_estimators_on_cuda_match_the_cpu(cuda, name):
    """Each CG-based estimator on the kernel route (float32 on the card:
    the pair CSR once, then K13 or K14) against the port's own float64
    answer on the CPU at the same seed: 1e-3 of max|x| (float32 CG to a
    relative residual of 1e-6), as the CG rows of
    ``test_matfree_paths_on_cuda``."""
    coord = _protein_blob(600, seed=11)
    modes = _blob_modes(coord, 6)
    prs_diag = matfree.prs_diag_from_modes(*modes, device="cpu").numpy()
    make_args, make_kwargs, n_out = ESTIMATORS[name]
    inputs = (modes, _blob_modes(coord, 6, gnm=True), prs_diag)
    args = make_args(*inputs)
    kwargs = ({} if make_kwargs is None else make_kwargs(*inputs))
    fn = getattr(matfree, name.replace("_deflated", ""))
    if name != "effector_sensor_matfree":
        kwargs.update(probes=16, seed=7)
    params = sct.invariant_params(13.0)
    wrappers = sct.kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    got = fn(coord, params, *args, **kwargs)
    torch.cuda.synchronize()
    gather = ("kirchhoff_apply_sparse" if name.endswith("_gnm")
              else "hessian_apply_sparse")
    _check_launches(wrappers, before, {"pair_csr", gather})
    assert wrappers["pair_csr"].launches == before["pair_csr"] + 1
    ref = fn(coord.astype(np.float64), params, *args, dtype=torch.float64,
             device="cpu", **kwargs)
    for i in range(n_out):
        assert got[i].device.type == "cuda"
        assert got[i].dtype == torch.float64
        assert _rel(got[i].cpu(), ref[i]) <= 1e-3, i


def test_kernel_route_reads_the_degrees_off_the_pair_csr(cuda, monkeypatch):
    """On the kernel route no solver enters the O(n^2) row-block pass: the
    Gershgorin bound, the block-Jacobi diagonal and the degree come off
    the pair CSR (with masses and with an overlay); the dense-grid route
    (``sparse=False``) still takes the row blocks."""
    atoms = _ca_atoms(600, seed=11)
    coord = atoms.coord
    params = sct.invariant_params(13.0)
    patched = params.replace(overlays=sct.PatchedForceField(
        sct.InvariantForceField(1.0), **_patch(coord, 13.0)
    ).to_params(natoms=600).overlays)
    masses = np.linspace(0.8, 2.5, 600).astype(np.float32)

    def refuse(*args, **kwargs):
        raise AssertionError("the O(n^2) row-block pass ran")

    monkeypatch.setattr(matfree, "_row_blocks", refuse)
    rhs = np.random.RandomState(2).randn(3 * 600, 3).astype(np.float32)
    for p in (params, patched):
        for m in (None, masses):
            outputs = (
                sct.lowest_modes_matfree(coord, p, 4, masses=m, degree=48,
                                         n_outer=4)[:2]
                + sct.lowest_modes_matfree_gnm(coord, p, 4, masses=m,
                                               degree=48, n_outer=4)[:2]
                + sct.covariance_solve_matfree(coord, p, rhs, masses=m)[:1]
                + sct.covariance_solve_matfree_gnm(coord, p, rhs[:600],
                                                   masses=m)[:1])
            assert all(bool(torch.isfinite(x).all()) for x in outputs)
    with pytest.raises(AssertionError, match="row-block pass ran"):
        sct.covariance_solve_matfree(coord, params, rhs, sparse=False)


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("family", ["invariant", "sd_enm", "patched"])
def test_pair_csr_degree_passes_on_cuda(cuda, family, masses):
    """The degree passes off the kernel's pair CSR (float64 sums, rounded
    once) against the O(n^2) plain passes in float32 on the card, back in
    atom order: 1e-6 of max; the overlay's delta added after the CSR
    sums."""
    n = 600
    atoms = _ca_atoms(n, seed=11)
    params = (_table_params("sd_enm", atoms) if family == "sd_enm"
              else sct.invariant_params(13.0))
    if family == "patched":
        params = params.replace(overlays=sct.PatchedForceField(
            sct.InvariantForceField(1.0), **_patch(atoms.coord, 13.0)
        ).to_params(natoms=n).overlays)
    c = torch.as_tensor(atoms.coord, device=cuda)
    m = (torch.linspace(0.8, 2.5, n, device=cuda) if masses else None)
    setup = matfree._sparse_setup(c, params, m, 256, True)
    inv = torch.as_tensor(np.argsort(setup.perm), device=cuda)
    args = (setup.coord, setup.params, setup.pairs)
    got = matfree._pair_degree_bound(*args, setup.masses, setup.csr.ids)
    ref = matfree.hessian_degree_bound(c, params, masses=m)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(ref)) <= 1e-6 * float(ref)
    if masses:
        return
    got = matfree._pair_diag_blocks(*args, setup.csr.ids)[inv]
    assert _rel(got, matfree.hessian_diag_blocks(c, params)) <= 1e-6
    got = matfree._pair_degree(*args, setup.csr.ids)[inv]
    assert _rel(got, matfree.kirchhoff_degree(c, params)) <= 1e-6


# ---------------------------------------------------------------------------
# The JAX kernel modules' public names and the mega-assembly north star
# ---------------------------------------------------------------------------

def _chip_smoke():
    """``chip_smoke.py`` as a module: its ``make_ca_atoms`` draws the JAX
    benchmark's structures bit for bit (tests/test_torch_mega.py)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_under_test", os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sd_enm_system(n, seed, device):
    atoms = _chip_smoke().make_ca_atoms(n, seed=seed)
    params = sct.TabulatedForceField.sd_enm(atoms).to_compact_params()
    return torch.as_tensor(atoms.coord, device=device), params


def test_kernel_names_launch_their_wrappers(cuda):
    """Each JAX kernel-module name launches its kernel on CUDA tensors and
    matches the wrapper's plain version."""
    from springcraft_tpu_torch.ops import pallas_kernels

    coord, params = _sd_enm_system(3000, 2, cuda)
    wrappers = sct.kernel_wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    h = pallas_kernels.hessian_pallas(coord, params)
    _assert_hessian_parts(h[None], assembly.hessian_xyz_plain(coord[None],
                                                              params))
    k = pallas_kernels.kirchhoff_pallas(coord, params)
    _assert_kirchhoff_parts(k[None], assembly.kirchhoff_plain(coord[None],
                                                              params))
    small, small_params = _sd_enm_system(300, 3, cuda)
    coords = torch.stack([small, small + 0.1]).contiguous()
    planes = pallas_kernels.hessian_pallas_ensemble(coords, small_params,
                                                    raw_planes=True)
    _assert_hessian_parts(torch.stack(planes),
                          assembly.hessian_planes_plain(coords, small_params))
    _assert_kirchhoff_parts(
        pallas_kernels.kirchhoff_pallas_ensemble(coords, small_params),
        assembly.kirchhoff_plain(coords, small_params))
    x = torch.randn(3 * 3000, 8, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    assert _rel(matfree.hessian_apply_pallas(coord, x, params),
                matfree.hessian_apply_dense_plain(coord, x, params)) <= 1e-5
    perm = matfree.spatial_sort_permutation(coord.cpu().numpy())
    sorted_coord = coord[torch.as_tensor(perm, device=cuda)]
    nbr, counts = matfree.tile_neighbor_lists(sorted_coord.cpu().numpy(),
                                              float(np.sqrt(params.cutoff_sq)),
                                              256)
    ids = perm.astype(np.int32)
    got = matfree.hessian_apply_pallas_sparse(sorted_coord, x, params, nbr,
                                              counts, orig_ids=ids)
    csr = matfree.tile_csr(nbr, counts, ids, 3000, 256, cuda)
    assert _rel(got, matfree.hessian_apply_sparse_plain(
        sorted_coord, x, params, csr, 256)) <= 1e-5
    got = matfree.kirchhoff_apply_pallas_sparse(sorted_coord, x[:3000],
                                                params, nbr, counts,
                                                orig_ids=ids)
    assert _rel(got, matfree.kirchhoff_apply_sparse_plain(
        sorted_coord, x[:3000], params, csr, 256)) <= 1e-5
    diags = spectrum.band_reduce(h[:900, :900].contiguous()[None], 8)
    feed, lo, hi = spectrum.bisect_inputs(diags)
    assert _rel(spectrum.banded_eigenvalues_pallas(diags),
                spectrum.banded_bisect_plain(feed, lo, hi, 40)) <= 1e-5
    torch.cuda.synchronize()
    launched = {name: w.launches - before[name]
                for name, w in wrappers.items()}
    for name in ("hessian_xyz", "kirchhoff", "hessian_planes",
                 "hessian_apply_dense", "pair_csr", "hessian_apply_sparse",
                 "kirchhoff_apply_sparse", "banded_bisect"):
        assert launched[name] > 0, name


def test_north_star_chain_on_cuda(cuda):
    """The north star's chain at 3,000 sdENM atoms: K5 through
    ``hessian_pallas``, 20 (+4) modes by ``lowest_modes_anm`` (``"chol"``
    past 8,192 dimensions), their residuals, the float64 refinement on the
    card, against float64 ``eigvalsh`` of the plain float64 Hessian."""
    from springcraft_tpu_torch.ops import modes, pallas_kernels

    coord, params = _sd_enm_system(3000, 2, cuda)
    h = pallas_kernels.hessian_pallas(coord, params)
    vals, vecs = modes.lowest_modes_anm(h, coord, 24)
    res = modes.mode_residuals(h, vals, vecs)
    theta, refined, refined_res = modes.refine_modes_f64(coord, params, vecs,
                                                         layout="xyz")
    truth = torch.linalg.eigvalsh(assembly.hessian_matrix(
        coord.double(), params, layout="xyz"))
    norm = float(truth[-1])
    assert float((res[:20].double() * vals[:20].double()).max()) \
        <= 5e-4 * norm
    assert float((vals[:20].double() - truth[6:26]).abs().max()) \
        <= 1e-4 * norm
    assert refined.dtype == torch.float64 and refined.device.type == "cuda"
    assert float(((theta[:20] - truth[6:26]).abs() / truth[6:26]).max()) \
        <= 1e-6
    assert bool(torch.isfinite(refined_res).all())


def test_pinv_diagonal_matches_the_golden_on_cuda(cuda):
    """The all-mode MSF at 20,736 dimensions (float32, K5 through
    ``hessian_pallas``, ``pinv_diagonal(block_size=1296)``) against the
    committed float64 golden, relative RMSE 1e-3."""
    import os

    from springcraft_tpu_torch.ops import pallas_kernels

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "data", "golden_mega_msf_20736.npz"))
    n = int(golden["n_res"])
    coord, params = _sd_enm_system(n, int(golden["seed"]), cuda)
    h = pallas_kernels.hessian_pallas(coord, params)
    diag = rigid.pinv_diagonal(h, rigid.rigid_modes_anm(coord, layout="xyz"),
                               block_size=1296, donate=True)
    del h
    msf = diag.double().reshape(3, n).sum(dim=0).cpu().numpy()
    truth = np.asarray(golden["msf"])
    err = np.sqrt(np.mean((msf - truth) ** 2) / np.mean(truth ** 2))
    assert err <= 1e-3


# ---------------------------------------------------------------------------
# The elastic loop and the model files on the card
# ---------------------------------------------------------------------------

class _Interrupted(Exception):
    """A non-device exception that ends a solve."""


@pytest.mark.parametrize("gnm", [False, True], ids=["anm", "gnm"])
def test_checkpointed_solve_resumes_bit_for_bit_on_cuda(cuda, tmp_path,
                                                        gnm):
    """3,000 atoms on the kernel route (pair CSR, K13 / K14): a solve
    interrupted after outer iteration 2 resumes from its snapshot and
    returns the uninterrupted modes bit for bit, the snapshot holding the
    block x as float32 and the cutoff a as a Python float."""
    from springcraft_tpu_torch.utils import elastic

    coord = _chip_smoke().matfree_coord(3000)
    params = sct.invariant_params(13.0)
    solver = sct.lowest_modes_matfree_gnm if gnm else sct.lowest_modes_matfree
    options = dict(degree=48, n_outer=5)
    wrappers = sct.kernel_wrappers()
    name = "kirchhoff_apply_sparse" if gnm else "hessian_apply_sparse"
    before = wrappers[name].launches
    plain = solver(coord, params, 8, **options)
    assert wrappers[name].launches > before
    path = str(tmp_path / "modes.npz")
    original, calls = matfree._chebfsi_outer, []

    def outer(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise _Interrupted
        return original(*args, **kwargs)

    matfree._chebfsi_outer = outer
    try:
        with pytest.raises(_Interrupted):
            solver(coord, params, 8, checkpoint=path, **options)
    finally:
        matfree._chebfsi_outer = original
    iteration, state = elastic.LoopCheckpoint(path).load()
    assert iteration == 2
    assert state["x"].dtype == np.float32
    assert state["x"].shape == ((1 if gnm else 3) * 3000, 48)
    assert state["a"].dtype == np.float64
    got = solver(coord, params, 8, checkpoint=path, **options)
    for a, b in zip(got, plain):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert not (tmp_path / "modes.npz").exists()


def test_loop_checkpoint_of_cuda_tensors(cuda, tmp_path):
    from springcraft_tpu_torch.utils import elastic

    x = torch.randn(300, 48, device=cuda)
    state = {"x": x, "a": 0.25, "theta": torch.arange(4.0, device=cuda)}
    ckpt = elastic.LoopCheckpoint(tmp_path / "s.npz")
    ckpt.save(7, state)
    iteration, loaded = ckpt.load()
    assert iteration == 7
    assert np.array_equal(loaded["x"], x.cpu().numpy())
    assert float(loaded["a"]) == 0.25
    assert np.array_equal(loaded["theta"], [0.0, 1.0, 2.0, 3.0])


def test_probe_device_on_cuda(cuda):
    from springcraft_tpu_torch.utils import elastic

    elastic.probe_device(timeout=60.0)
    elastic.probe_device(timeout=60.0, device=cuda)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: injected transient failure")
        return torch.ones(3, device=cuda).sum()

    assert float(elastic.retry_on_failure(flaky, retries=1, wait=0.0)) == 3.0
    assert len(calls) == 2


def test_model_file_round_trip_on_cuda(cuda, tmp_path):
    """``save_model`` fetches the card's float64 matrices, ``load_model``
    puts them back on the card; the restored GNM's observables are the
    saved model's bit for bit, and it refuses to rebuild without a force
    field."""
    from springcraft_tpu_torch import io as sio

    ca = _chip_smoke().make_ca_atoms(300, seed=3)
    gnm = sct.GNM(ca, sct.InvariantForceField(7.0))
    _ = gnm.covariance
    sio.save_model(tmp_path / "gnm.npz", gnm)
    restored = sio.load_model(tmp_path / "gnm.npz")
    assert restored._covariance.device.type == "cuda"
    assert np.array_equal(restored.mean_square_fluctuation(),
                          gnm.mean_square_fluctuation())
    assert np.array_equal(restored.dcc(), gnm.dcc())
    with pytest.raises(RuntimeError, match="force_field="):
        restored.lowest_modes(4, matrix_free=True)


# ---------------------------------------------------------------------------
# The multi-device layer: K12 over a row range, the sharded paths on meshes
# over cuda:0 (one entry, and four with the row axis 2), and a mesh over two
# cards
# ---------------------------------------------------------------------------

def _k12_case(cuda, n=1000, k=48, family="pfenm"):
    rng = np.random.RandomState(21)
    c = torch.as_tensor(rng.rand(n, 3) * 60.0, dtype=torch.float32,
                        device=cuda)
    x = torch.as_tensor(rng.randn(3 * n, k), dtype=torch.float32,
                        device=cuda)
    params = (sct.pfenm_params(None) if family == "pfenm"
              else sct.invariant_params(13.0))
    return c, x, params


@pytest.mark.parametrize("family", ["pfenm", "invariant"])
@pytest.mark.parametrize("start, rows", [(0, 250), (13, 300), (990, 10),
                                         (31, 33), (0, 1000), (500, 0)])
def test_k12_row_range_matches_plain_and_full_call(cuda, family, start,
                                                   rows):
    """K12 over a row range: bit for bit the same rows of the full
    launch, and within 1e-5 of max of its plain version's."""
    c, x, params = _k12_case(cuda, family=family)
    full = matfree.hessian_apply_dense(c, x, params)
    before = matfree.hessian_apply_dense.launches
    part = matfree._launch_dense(c, x, params, 256, start, rows)
    assert matfree.hessian_apply_dense.launches == before + 1
    want = full.reshape(3, 1000, -1)[:, start:start + rows].reshape(-1, 48)
    assert torch.equal(part, want)
    if rows:
        plain = matfree.hessian_apply_dense_plain(c, x, params,
                                                  row_start=start,
                                                  n_rows=rows)
        assert _rel(part, plain) <= 1e-5


@pytest.mark.parametrize("k", [1, 7, 48, 100])
def test_k12_row_range_column_widths(cuda, k):
    """Odd widths (4-byte copies), 48 and two column chunks."""
    c, x, params = _k12_case(cuda, n=333, k=k, family="invariant")
    full = matfree.hessian_apply_dense(c, x, params)
    part = matfree._launch_dense(c, x, params, 256, 45, 111)
    assert torch.equal(part, full.reshape(3, 333, k)[:, 45:156]
                       .reshape(-1, k))


def test_k12_full_range_is_the_full_call(cuda):
    """The full range through the row-range entry is the wrapper's call,
    byte for byte (one SHA-256)."""
    import hashlib

    c, x, params = _k12_case(cuda)
    full = matfree.hessian_apply_dense(c, x, params)
    ranged = matfree._launch_dense(c, x, params, 256, 0, 1000)
    digest = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
              for t in (full, ranged)]
    assert digest[0] == digest[1]


def _cuda_meshes():
    from springcraft_tpu_torch import parallel

    card = torch.device("cuda", 0)
    return {"one": parallel.make_mesh(1, devices=[card]),
            "four": parallel.make_mesh(4, row_axis=2, devices=[card] * 4)}


@pytest.mark.parametrize("mesh_name", ["one", "four"])
def test_sharded_paths_on_cuda(cuda, mesh_name):
    """Every sharded path on a mesh over cuda:0, float32 on the kernels,
    against the unsharded call or the float64 engine, with its kernels'
    launches."""
    from springcraft_tpu_torch import parallel

    mesh = _cuda_meshes()[mesh_name]
    coords = _coords(8, 40, 5, spread=10.0)
    params = sct.invariant_params(9.0)

    def launched(fn, *names):
        wrappers = sct.kernel_wrappers()
        before = {name: wrappers[name].launches for name in names}
        out = fn()
        torch.cuda.synchronize()
        for name in names:
            assert wrappers[name].launches > before[name], name
        return out

    got = launched(lambda: parallel.sharded_ensemble_anm_fluctuations(
        coords, params, mesh, inverse="blocked", with_covariance=False,
        use_pallas=True), "hessian_planes", "regularize_stitch",
        "panel_inverse")
    ref = pipeline.ensemble_anm_fluctuations(
        coords, params, inverse="blocked", with_covariance=False)
    for key in ref:
        assert got[key].device == mesh.flat[0]
        assert _rel(got[key], ref[key]) <= 1e-6, key
    launched(lambda: parallel.sharded_ensemble_anm(coords, params, mesh),
             "hessian_xyz")
    launched(lambda: parallel.sharded_ensemble_gnm(coords, params, mesh),
             "kirchhoff")
    launched(lambda: parallel.sharded_ensemble_anm_banded(
        coords, params, mesh, bandwidth=4), "banded_bisect",
        "banded_eigvec")
    launched(lambda: parallel.sharded_ensemble_gnm_banded(
        coords, params, mesh, bandwidth=4), "banded_bisect")
    mean = launched(lambda: parallel.ensemble_mean_msf(coords, params,
                                                       mesh), "hessian_xyz")
    assert mean.shape == (40,)

    coord = coords[0]
    c64 = torch.as_tensor(coord, dtype=torch.float64, device=cuda)
    x = torch.randn(120, 6, device=cuda)
    y = launched(lambda: parallel.sharded_hessian_apply(coord, x, params,
                                                        mesh),
                 "hessian_apply_dense")
    assert torch.equal(y, matfree.hessian_apply_dense(
        torch.as_tensor(coord, device=cuda), x, params))
    y64 = parallel.sharded_hessian_apply(coord, x.double(), params, mesh,
                                         dtype=torch.float64)
    assert _rel(y64, matfree.hessian_apply(c64, x.double(), params,
                                           dtype=torch.float64)) <= 1e-12
    vals, vecs, res = launched(lambda: parallel.sharded_lowest_modes_matfree(
        coord, params, mesh, 4, degree=48, n_outer=8, oversample=8),
        "hessian_apply_dense")
    ref_vals, _, _ = sct.lowest_modes_matfree(
        coord, params, 4, degree=48, n_outer=8, oversample=8, sparse=False)
    assert torch.equal(vals, ref_vals)

    hessian = parallel.sharded_hessian(coord, params, mesh,
                                       dtype=torch.float64)
    assert all(s.device == mesh.flat[0] for s in hessian.shards)
    dense = hessian.full().cpu().numpy()
    truth = np.linalg.eigvalsh(dense)
    vals, _ = parallel.sharded_lowest_modes(coord, params, mesh, 4,
                                            dtype=torch.float64,
                                            n_iter=300)
    assert np.allclose(vals.cpu().numpy(), truth[6:10], rtol=1e-6)
    pinv = np.linalg.pinv(dense, hermitian=True, rcond=1e-6)
    cov = parallel.sharded_covariance(coord, params, mesh,
                                      dtype=torch.float64)
    assert np.allclose(cov.full().cpu().numpy(), pinv, atol=1e-8)
    cov = parallel.sharded_covariance_blocked(coord, params, mesh, block=24,
                                              dtype=torch.float64)
    assert np.allclose(cov.full().cpu().numpy(), pinv, atol=1e-8)
    msf = parallel.sharded_all_mode_msf(coord, params, mesh, block=24,
                                        dtype=torch.float64)["msf"]
    assert np.allclose(msf.cpu().numpy(), np.einsum(
        "iaia->i", pinv.reshape(40, 3, 40, 3)), atol=1e-8)
    out = parallel.sharded_anm_pipeline(coord, params, mesh,
                                        dtype=torch.float64)
    assert np.allclose(out["eig_values"].cpu().numpy(), truth, atol=1e-9)


def test_mesh_over_two_cards():
    """A mesh over cuda:0 and cuda:1: shards on both cards, copies between
    them explicit, the results on the first card and equal to the one-card
    mesh's."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from springcraft_tpu_torch import parallel

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    two = parallel.make_mesh(2, row_axis=2, devices=cards)
    one = parallel.make_mesh(2, row_axis=2, devices=cards[:1] * 2)
    coords = _coords(4, 40, 5, spread=10.0)
    params = sct.invariant_params(9.0)
    got = parallel.sharded_ensemble_anm_fluctuations(
        coords, params, two, inverse="blocked", with_covariance=False)
    ref = parallel.sharded_ensemble_anm_fluctuations(
        coords, params, one, inverse="blocked", with_covariance=False)
    for key in ref:
        assert got[key].device == cards[0]
        assert torch.equal(got[key], ref[key]), key
    hessian = parallel.sharded_hessian(coords[0], params, two)
    assert [s.device for s in hessian.shards] == cards
    x = torch.randn(120, 6, device=cards[0])
    assert torch.equal(
        parallel.sharded_hessian_apply(coords[0], x, params, two),
        parallel.sharded_hessian_apply(coords[0], x, params, one))
    msf = parallel.sharded_all_mode_msf(coords[0], params, two, block=24,
                                        dtype=torch.float64)["msf"]
    ref = parallel.sharded_all_mode_msf(coords[0], params, one, block=24,
                                        dtype=torch.float64)["msf"]
    assert msf.device == cards[0] and torch.allclose(msf, ref, atol=1e-12)


def test_make_mesh_defaults_to_every_card(cuda):
    from springcraft_tpu_torch import parallel

    mesh = parallel.make_mesh()
    assert mesh.size == torch.cuda.device_count()
    assert all(dev.type == "cuda" for dev in mesh.flat)


# ---------------------------------------------------------------------------
# The port's examples (examples_torch/) on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script", [
    "basic_nma", "normal_mode", "analysis_gallery", "mode_arrows_3d",
    "checkpoint_resume", "ensemble_nma", "mega_assembly",
    "matrix_free_modes", "perturbation_scan", "stochastic_observables"])
def test_example_on_the_card_matches_its_cpu_run(cuda, script, tmp_path,
                                                 monkeypatch):
    """Each port example at its default size with ``--device cuda`` runs
    to its end and gives its ``--device cpu`` run's globals at
    ``chip_smoke.EXAMPLE_GLOBALS``' tolerances, launching the kernels of
    its path in ``chip_smoke.PATH_KERNELS``."""
    import sys

    smoke = _chip_smoke()
    path = smoke.example_script(script)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    wrappers = sct.kernel_wrappers()
    runs = {}
    for device in ("cuda", "cpu"):
        (tmp_path / device).mkdir()
        monkeypatch.chdir(tmp_path / device)
        before = {name: w.launches for name, w in wrappers.items()}
        runs[device] = smoke.example_globals(
            script, smoke.run_example(path, ["--device", device]))
        if device == "cuda":
            for name in smoke.PATH_KERNELS[f"example_{script}"]:
                assert wrappers[name].launches > before[name], name
    smoke.compare_example(script, runs["cuda"], runs["cpu"])
    if script in smoke.EXAMPLE_PDBS:
        name = smoke.EXAMPLE_PDBS[script]
        smoke.compare_pdb(name, str(tmp_path / "cuda" / name),
                          str(tmp_path / "cpu" / name),
                          runs["cpu"]["ca_coord"])


# ---------------------------------------------------------------------------
# The refinement on the network K5 assembled
# ---------------------------------------------------------------------------

def test_refinement_of_k5_modes_is_on_k5s_network(cuda):
    """An sdENM structure with a pair astride a bin edge and one astride
    the cutoff (in float32 and float64): K5 on the card, float32
    ``lowest_modes_anm`` and ``refine_modes_f64`` from the float32
    coordinates, within 1e-9 of float64 ``eigvalsh`` of the float32
    network; from float64 coordinates, the float64 network's refinement,
    at least 1e-3 off it."""
    from springcraft_tpu_torch.ops import pallas_kernels
    from tests.test_torch_network_rule import (K, edge_system,
                                               network_hessian)

    c32, params = edge_system()
    coord = c32.to(cuda)
    h = pallas_kernels.hessian_pallas(coord, params)
    _, vecs = sct.lowest_modes_anm(h, coord, K)
    truth = torch.linalg.eigvalsh(network_hessian(c32, params,
                                                  torch.float32))[6:K + 4]
    for method in ("sparse", "dense"):
        theta = sct.refine_modes_f64(coord, params, vecs, method=method,
                                     block=16)[0]
        assert theta.device.type == "cuda"
        assert _rel(theta[:K - 2].cpu(), truth) <= 1e-9
    old = sct.refine_modes_f64(coord.double(), params, vecs)[0]
    assert _rel(old[:K - 2].cpu(), truth) >= 1e-3
