"""
Two-stage banded symmetric eigensolver.

Counterpart of ``springcraft_tpu/ops/spectrum.py:182-1501``:

1. **Full -> band reduction** (:func:`band_reduce`,
   :func:`band_reduce_with_reflectors`): per ``b``-column panel a compact-WY
   Householder QR of the below-band block and a symmetric rank-``2b``
   trailing update, ``group`` panels sharing one compound update, the
   sweep bucketed on the shrinking trailing view.  The JAX package's
   bucket, group and Householder sign rules are kept, so both packages
   produce the same band diagonals, not only the same eigenvalues.
2. **Eigenvalues by Sturm bisection** on the banded LDL^t inertia count
   (:func:`banded_eigenvalues`): kernel ``csrc/banded_bisect.cu`` behind
   :func:`banded_bisect`, plain version :func:`banded_bisect_plain`.
3. **Eigenvectors by inverse iteration** with separated shifts and a
   windowed Gram-Schmidt sweep (:func:`banded_eigenvectors`): kernel
   ``csrc/banded_eigvec.cu`` behind :func:`banded_eigvec`, plain version
   :func:`banded_eigvec_plain`.
4. **Back-transform and refinement** (:func:`back_transform`, two
   perturbative polish rounds and a windowed Rayleigh-Ritz), assembled in
   :func:`eigh_banded`; :func:`eigvalsh_banded` stops after step 2.

The JAX package's other public names are here too:
:func:`banded_eigenvalues_pallas` (step 2 through the kernel wrapper
alone), :func:`eigh_banded_staged` (one matrix, the same solve) and the
legacy rank-2 path :func:`tridiagonalize`, :func:`tridiagonal_eigenvalues`
and :func:`eigvalsh_sturm` (``spectrum.py:70-180``), plain torch, as the
JAX package has no kernel there.

Everything is batched natively over a leading dimension.  The kernels
take float32 band matrices of bandwidth at most 8 (the JAX package's
rule for its Pallas kernels, ``spectrum.py:1333, 1467``): such inputs go
through the wrappers, which launch on CUDA and run the plain versions on
the CPU; every other input (float64, wider bands) takes the plain
versions directly.  The products stay ``torch.matmul`` with TF32 off,
the QRs and the small ``eigh``s ``torch.linalg``, as the JAX package
left them to XLA.

The kernels and their plain versions share one band layout, the *feed*
of :func:`band_feed`: ``feed[:, p, i] = A[i - b + p, i]`` for
``p < w = b + 1`` over ``n + w`` columns, the last ``w`` zero.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.config import check_use_pallas

__all__ = [
    "MAX_KERNEL_BANDWIDTH",
    "band_reduce",
    "band_reduce_with_reflectors",
    "back_transform",
    "band_feed",
    "bisect_inputs",
    "eigvec_inputs",
    "eigvec_checkpoint_len",
    "banded_bisect",
    "banded_bisect_plain",
    "banded_eigenvalues",
    "banded_eigvec",
    "banded_eigvec_plain",
    "banded_eigenvectors",
    "eigvalsh_banded",
    "eigh_banded",
    "banded_eigenvalues_pallas",
    "eigh_banded_staged",
    "tridiagonalize",
    "tridiagonal_eigenvalues",
    "eigvalsh_sturm",
]

#: Widest band the kernels take (their window is a template of w = b + 1).
MAX_KERNEL_BANDWIDTH = 8
#: Pivot floor of the Sturm count: only signs matter there.
_TINY = 1e-30


def _mt(x):
    return x.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Full -> band reduction
# ---------------------------------------------------------------------------


def _panel_qr(panel, start_row, b):
    """Compact-WY Householder QR of the below-band block of a batch of
    panels ``(B, rows, b)``: rows from ``start_row + j`` down in column
    ``j``.  Returns ``(v, t)``, unit Householder vectors ``(B, rows, b)``
    (zero above their pivot) and the upper-triangular ``(B, b, b)`` with
    ``H_0 ... H_{b-1} = I - V T V^T`` (``spectrum.py:182-240``; the
    head's sign rule of ``:215-216`` fixes the band's signs)."""
    batch, rows, _ = panel.shape
    p = panel.clone()
    v = panel.new_zeros((batch, rows, b))
    t = panel.new_zeros((batch, b, b))
    for j in range(b):
        pivot = start_row + j
        if pivot < rows:
            x = p[:, pivot:, j]
            alpha = torch.where(x[:, 0] < 0, 1.0, -1.0) * torch.sqrt(
                (x * x).sum(-1))
            vj = x.clone()
            vj[:, 0] = x[:, 0] - alpha
            v_norm = torch.sqrt((vj * vj).sum(-1))
            safe = v_norm > _TINY
            vj = torch.where(safe[:, None],
                             vj / torch.where(safe, v_norm, 1.0)[:, None],
                             0.0)
            rest = p[:, pivot:, j + 1:]
            proj = (vj[:, None, :] @ rest)                 # (B, 1, b-j-1)
            p[:, pivot:, j + 1:] = rest - 2.0 * vj[:, :, None] * proj
            v[:, pivot:, j] = vj
        if j:
            vtv = _mt(v[:, :, :j]) @ v[:, :, j:j + 1]       # (B, j, 1)
            t[:, :j, j] = -2.0 * (t[:, :j, :j] @ vtv)[..., 0]
        t[:, j, j] = 2.0
    return v, t


def _band_panel_update(tr, v, t):
    """Symmetric compact-WY rank-``2b`` update ``A - W V^T - V W^T`` of a
    batch of trailing blocks (``spectrum.py:243-256``)."""
    y = tr @ (v @ t)
    s = _mt(t) @ (_mt(v) @ y)
    w = y - 0.5 * (v @ s)
    return tr - torch.cat([w, v], -1) @ _mt(torch.cat([v, w], -1))


def _compound_panel_group(tr, first_col, b, g):
    """`g` consecutive panels against the group-start matrix, each
    corrected by the group's accumulated ``(V, W)``, then one compound
    rank-``2 b g`` trailing update (``spectrum.py:259-301``).  Returns
    ``(tr_updated, [(v, t), ...])``."""
    vs, ws, vts = [], [], []
    for k in range(g):
        cc = first_col + k * b
        panel = tr[:, :, cc:cc + b]
        if vs:
            vv = torch.cat(vs, -1)
            ww = torch.cat(ws, -1)
            vc = vv[:, cc:cc + b, :]
            wc = ww[:, cc:cc + b, :]
            panel = panel - ww @ _mt(vc) - vv @ _mt(wc)
        v, tmat = _panel_qr(panel, cc + b, b)
        vt = v @ tmat
        y = tr @ vt
        if vs:
            y = y - ww @ (_mt(vv) @ vt) - vv @ (_mt(ww) @ vt)
        s = _mt(tmat) @ (_mt(v) @ y)
        w = y - 0.5 * (v @ s)
        vs.append(v)
        ws.append(w)
        vts.append((v, tmat))
    wv = torch.cat(ws + vs, -1)
    vw = torch.cat(vs + ws, -1)
    return tr - wv @ _mt(vw), vts


def _resolve_bucket(bucket, n):
    """About 8 128-aligned trailing-view buckets (``spectrum.py:304-311``);
    ``None`` or ``0`` keeps one full-size sweep."""
    if bucket == "auto":
        return max(128, -(-((n + 7) // 8) // 128) * 128)
    if bucket is None or bucket <= 0:
        return n
    return int(bucket)


def _band_reduce(matrix, bandwidth, bucket, group, with_reflectors):
    """Shared body of :func:`band_reduce` and
    :func:`band_reduce_with_reflectors` (``spectrum.py:314-405,
    423-507``) on a batch ``(B, n, n)``."""
    a = matrix
    batch, n = a.shape[0], a.shape[-1]
    b = int(bandwidth)
    if b < 1:
        raise ValueError("bandwidth must be >= 1")
    bucket = _resolve_bucket(bucket, n)
    g = max(1, int(group))
    n_panels = max(0, -(-(n - b - 1) // b))
    if with_reflectors:
        v_all = a.new_zeros((batch, n_panels, n, b))
        t_all = a.new_zeros((batch, n_panels, b, b))

    def record(kk, v, t, r0):
        if with_reflectors:
            v_all[:, kk, r0:] = v
            t_all[:, kk] = t

    parts = [[] for _ in range(b + 1)]
    trail = a
    r0 = 0      # rows/cols above r0 are final and sliced off
    k = 0
    while k < n_panels:
        k_end = min(n_panels, -(-(r0 + bucket) // b))
        n_groups = (k_end - k) // g if g > 1 else 0
        for _ in range(n_groups):
            trail, vts = _compound_panel_group(trail, k * b - r0, b, g)
            for kk, (v, t) in enumerate(vts, start=k):
                record(kk, v, t, r0)
            k += g
        for kk in range(k, k_end):
            v, t = _panel_qr(trail[:, :, kk * b - r0:kk * b - r0 + b],
                             kk * b - r0 + b, b)
            trail = _band_panel_update(trail, v, t)
            record(kk, v, t, r0)
        k = k_end
        if k < n_panels:
            # rows [r0, r0 + bucket) saw their last panel: keep their
            # band and shrink the working view
            for d in range(b + 1):
                parts[d].append(torch.diagonal(
                    trail[:, :bucket, :bucket + b], offset=d, dim1=-2,
                    dim2=-1))
            trail = trail[:, bucket:, bucket:]
            r0 += bucket
    for d in range(b + 1):
        parts[d].append(torch.cat([
            torch.diagonal(trail, offset=d, dim1=-2, dim2=-1),
            a.new_zeros((batch, d))], -1))
    diags = torch.stack([torch.cat(p, -1) for p in parts], dim=1)
    if with_reflectors:
        return diags, v_all, t_all
    return diags


def _batched(matrix):
    if matrix.ndim not in (2, 3) or matrix.shape[-1] != matrix.shape[-2]:
        raise ValueError(f"expected (n, n) or (B, n, n), got "
                         f"{tuple(matrix.shape)}")
    return matrix[None] if matrix.ndim == 2 else matrix, matrix.ndim == 2


def band_reduce(matrix, bandwidth, bucket="auto", group=8):
    """
    Band diagonals ``(..., bandwidth + 1, n)`` of symmetric ``(n, n)`` or
    ``(B, n, n)`` matrices after blocked two-sided Householder reduction
    (eigenvalue-preserving): ``diags[..., d, i] = A_band[i, i + d]``,
    zero-padded at the tail.

    `bucket` bounds the trailing view (``"auto"``: about 8 buckets;
    ``None``: one full-size sweep); `group` panels share one compound
    trailing update.  Both change only the summation order.
    """
    a, squeeze = _batched(matrix)
    diags = _band_reduce(a, bandwidth, bucket, group, False)
    return diags[0] if squeeze else diags


def band_reduce_with_reflectors(matrix, bandwidth, bucket="auto", group=8):
    """
    :func:`band_reduce` that also returns the compact-WY panel reflectors
    for :func:`back_transform`: ``(diags, v_all, t_all)`` with
    ``v_all`` ``(..., n_panels, n, bandwidth)`` (zero above each panel's
    first reflected row) and ``t_all`` ``(..., n_panels, bandwidth,
    bandwidth)``, ``Q_k = I - V_k T_k V_k^T``.
    """
    a, squeeze = _batched(matrix)
    out = _band_reduce(a, bandwidth, bucket, group, True)
    return tuple(x[0] for x in out) if squeeze else out


def back_transform(v_all, t_all, u):
    """Band-space vectors to the original space, ``u <- Q_1 ... Q_L u``,
    last panel first (``spectrum.py:510-528``); `u` is ``(..., n, k)``.
    Panel ``k``'s vectors vanish above row ``(k + 1) b``, so each product
    runs over the rows below (only exact zeros are skipped)."""
    n_panels, _, b = v_all.shape[-3:]
    u = u.clone()
    for k in reversed(range(n_panels)):
        r = (k + 1) * b
        v = v_all[..., k, r:, :]
        u_r = u[..., r:, :]
        u_r -= v @ (t_all[..., k, :, :] @ (_mt(v) @ u_r))
    return u


# ---------------------------------------------------------------------------
# Sturm bisection (K10)
# ---------------------------------------------------------------------------


def _gershgorin_bounds(diags):
    """Gershgorin interval ``(lo, hi)``, each ``(B,)``, of band matrices
    ``(B, w, n)`` (``spectrum.py:408-420``)."""
    _, w, n = diags.shape
    radius = torch.zeros_like(diags[:, 0])
    for d in range(1, w):
        off = diags[:, d, :n - d].abs()
        radius[:, :n - d] += off
        radius[:, d:] += off
    lo = (diags[:, 0] - radius).amin(dim=1)
    hi = (diags[:, 0] + radius).amax(dim=1)
    return lo, hi


def band_feed(diags):
    """The kernels' band layout ``(B, w, n + w)`` of band diagonals
    ``(B, w, n)``: ``feed[:, p, i] = A[i - b + p, i]``, zero outside the
    band and on the ``w`` pad columns (``spectrum.py:646-665`` as the
    Pallas kernels lay it out, ``:922-932``)."""
    batch, w, n = diags.shape
    b = w - 1
    rows = []
    for p in range(w):
        d = b - p
        rows.append(torch.cat([diags.new_zeros((batch, d)),
                               diags[:, d, :n - d],
                               diags.new_zeros((batch, w))], -1))
    return torch.stack(rows, dim=1).contiguous()


def _tri(p, q):
    """Slot of window entry ``(p, q)``, ``p <= q``: the upper triangle
    column by column, so the last column's ``w`` entries come last."""
    return q * (q + 1) // 2 + p


class _Window:
    """The sliding ``(w, w)`` Schur-complement window of the banded LDL^t
    recurrence (``spectrum.py:577-638``), batched over ``(B, S)`` shifts
    and carried as its upper triangle (``w (w + 1) / 2`` slots, the
    kernels' register layout).  Step ``i`` eliminates pivot ``(0, 0)``
    and appends band column ``i + w``: ``new[p, q] = old[p + 1, q + 1] -
    l[p + 1] old[0, q + 1]`` with ``l = old[0, :] / pivot``, in the
    kernels' order of operations (a reciprocal, then products)."""

    def __init__(self, feed, shifts):
        w = feed.shape[1]
        self.feed = feed
        dev = feed.device
        qs = [q for q in range(w) for _ in range(q + 1)]
        ps = [p for q in range(w) for p in range(q + 1)]
        # initial window: A[p, q] (= feed[p - q + b, q]) minus the shift
        # on the diagonal, the same values as the w warm-up appends
        init = feed[:, [p - q + w - 1 for p, q in zip(ps, qs)], qs]
        diag = torch.tensor([p == q for p, q in zip(ps, qs)], device=dev)
        self.tri = init[:, None, :] - torch.where(diag, shifts[..., None],
                                                  0.0)
        self.row0 = torch.tensor([_tri(0, q) for q in range(w)], device=dev)
        inner = [(p, q) for q in range(w - 1) for p in range(q + 1)]
        self.src = torch.tensor([_tri(p + 1, q + 1) for p, q in inner],
                                device=dev)
        self.lp = torch.tensor([p + 1 for p, _ in inner], device=dev)
        self.lq = torch.tensor([q + 1 for _, q in inner], device=dev)
        # the appended column's shift: on its diagonal entry only
        self.col_shift = torch.where(torch.arange(w, device=dev) == w - 1,
                                     shifts[..., None], 0.0)

    def pivot(self):
        return self.tri[..., 0]

    def eliminate(self, inv_pivot, col):
        """Eliminate with ``1 / pivot`` = `inv_pivot` ``(B, S)`` and
        append band column `col`; returns ``l`` ``(B, S, w - 1)``."""
        r = self.tri[..., self.row0]                      # (B, S, w)
        lr = r * inv_pivot[..., None]
        inner = self.tri[..., self.src] - lr[..., self.lp] * r[..., self.lq]
        new = self.feed[:, None, :, col] - self.col_shift
        self.tri = torch.cat([inner, new], -1)
        return lr[..., 1:]


def _clamp_pivot(pivot, floor):
    return torch.where(pivot.abs() < floor,
                       torch.where(pivot < 0, -floor, floor), pivot)


def _check_feed(name, feed):
    if feed.ndim != 3 or feed.shape[-1] <= feed.shape[1]:
        raise ValueError(f"{name}: feed must be (B, w, n + w), got "
                         f"{tuple(feed.shape)}")
    return feed.shape[0], feed.shape[1], feed.shape[-1] - feed.shape[1]


def banded_bisect_plain(feed, lo, hi, n_iter):
    """Plain version of :func:`banded_bisect`: ``n_iter`` halvings of
    ``[lo, hi]`` for every eigenvalue index, each a full Sturm count
    (number of negative pivots of ``B - mid I``, pivot floor 1e-30) over
    the band (``spectrum.py:531-638``).  The count runs in float64 for
    any input: the elimination does not pivot, and float32 pivots flip
    signs under its element growth (a float32 count put eigenvalues of
    N=300 ANM Hessians 1.4e-3 of the largest away from float64 ``eigh``);
    the interval stays in the input's dtype."""
    batch, w, n = _check_feed("banded_bisect_plain", feed)
    targets = torch.arange(n, device=feed.device)
    lo = lo[:, None].expand(batch, n)
    hi = hi[:, None].expand(batch, n)
    feed64 = feed.double()
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        win = _Window(feed64, mid.double())
        counts = torch.zeros((batch, n), dtype=torch.int32,
                             device=feed.device)
        for i in range(n):
            pivot = win.pivot()
            counts += pivot < 0
            win.eliminate(1.0 / _clamp_pivot(pivot, _TINY), i + w)
        go_up = counts <= targets
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    return 0.5 * (lo + hi)


def banded_bisect(feed, lo, hi, n_iter):
    """
    All ``n`` eigenvalues (ascending) of a batch of band matrices by
    Sturm-count bisection: the kernel ``csrc/banded_bisect.cu`` on CUDA,
    :func:`banded_bisect_plain` on the CPU.

    Parameters
    ----------
    feed : Tensor, shape=(B, w, n + w)
        :func:`band_feed` of the band diagonals, ``w <= 9`` on CUDA.
    lo, hi : Tensor, shape=(B,)
        Interval holding each matrix's spectrum.
    n_iter : int
        Halvings.

    Returns
    -------
    Tensor, shape=(B, n)
    """
    batch, w, n = _check_feed("banded_bisect", feed)
    if _build.route("banded_bisect", feed, lo, hi) == "cpu":
        return banded_bisect_plain(feed, lo, hi, n_iter)
    _build.require_cuda_f32("banded_bisect", feed=feed, lo=lo, hi=hi)
    _check_kernel_limits("banded_bisect", batch, w)
    out = torch.empty((batch, n), dtype=torch.float32, device=feed.device)
    # the Sturm counts of the kernel's shared tree of first halvings
    # (floor(log2 n) levels, fewer than n nodes)
    counts = torch.empty((batch, n), dtype=torch.int32, device=feed.device)
    sms = torch.cuda.get_device_properties(feed.device).multi_processor_count
    _build.launch("sc_banded_bisect", feed.device, feed.data_ptr(),
                  lo.data_ptr(), hi.data_ptr(), counts.data_ptr(),
                  out.data_ptr(), batch, n, w, int(n_iter),
                  _bisect_levels(batch, n, sms))
    banded_bisect.launches += 1
    return out


banded_bisect.launches = 0


def _bisect_levels(batch, n, sms):
    """Halvings an eigenvalue takes at once in the bisection kernel
    (multisection: ``2**k - 1`` lanes count at the mids of its next ``k``
    halvings): the smallest ``k`` in 1..3 that gives a launch of `batch`
    matrices of `n` eigenvalues at least two warps for each of the four
    warp schedulers of each of the device's `sms` multiprocessors, else
    3.  Large batches take 1; single structures up to about 10,500 rows
    take 3."""
    for k in (1, 2):
        per_warp = 32 // (2 ** k - 1)
        if batch * -(-n // per_warp) >= 8 * sms:
            return k
    return 3


_MAX_GRID_Y = 65535


def _check_kernel_limits(name, batch, w):
    if w - 1 > MAX_KERNEL_BANDWIDTH or batch > _MAX_GRID_Y:
        raise ValueError(f"{name}: (B, bandwidth) = ({batch}, {w - 1}) "
                         f"exceeds the kernel's limits (B <= {_MAX_GRID_Y},"
                         f" bandwidth <= {MAX_KERNEL_BANDWIDTH})")


def _kernel_route(diags):
    """Whether the kernel wrappers take these band diagonals: float32 and
    bandwidth at most 8, decided before the call (the JAX package's
    rule); the wrappers then launch on CUDA or run their plain versions
    on the CPU."""
    return (diags.dtype == torch.float32
            and diags.shape[-2] - 1 <= MAX_KERNEL_BANDWIDTH)


def bisect_inputs(diags):
    """``(feed, lo, hi)`` for :func:`banded_bisect` from band diagonals
    ``(B, w, n)``: the feed and each matrix's Gershgorin interval."""
    lo, hi = _gershgorin_bounds(diags)
    return band_feed(diags), lo.contiguous(), hi.contiguous()


def banded_eigenvalues(diags, n_iter=40):
    """All eigenvalues (ascending) of band matrices given as diagonals
    ``(w, n)`` or ``(B, w, n)`` by bisection from their Gershgorin
    interval (``spectrum.py:531-574``, and the Pallas route's dispatch
    ``:1333``): through :func:`banded_bisect` where
    :func:`_kernel_route` takes the diagonals, else
    :func:`banded_bisect_plain`; 40 halvings reach float32 resolution."""
    squeeze = diags.ndim == 2
    d = diags[None] if squeeze else diags
    fn = banded_bisect if _kernel_route(d) else banded_bisect_plain
    out = fn(*bisect_inputs(d), n_iter)
    return out[0] if squeeze else out


def eigvalsh_banded(matrix, bandwidth=8, n_iter=40):
    """
    Eigenvalues (ascending) of symmetric ``(n, n)`` or ``(B, n, n)``
    matrices by band reduction and banded Sturm bisection
    (``spectrum.py:1316-1342``).  Float32 with ``bandwidth <= 8`` runs
    the bisection kernel on CUDA.
    """
    a, squeeze = _batched(matrix)
    if a.shape[-1] <= bandwidth + 1:
        vals = torch.linalg.eigvalsh(a)
    else:
        vals = banded_eigenvalues(
            _band_reduce(a, bandwidth, "auto", 8, False), n_iter)
    return vals[0] if squeeze else vals


# ---------------------------------------------------------------------------
# Inverse iteration (K11)
# ---------------------------------------------------------------------------


def _separate_shifts(eigvals, sep):
    """Strictly increasing shifts ``s_i = max(lam_i, s_{i-1} + sep)``, a
    running max (``spectrum.py:761-767``)."""
    idx = torch.arange(eigvals.shape[-1], dtype=eigvals.dtype,
                       device=eigvals.device)
    return torch.cummax(eigvals - sep * idx, dim=-1).values + sep * idx


def _banded_factorize(feed, shifts, pivot_floor):
    """LDL^t factors of ``B - s I`` for a ``(B, S)`` plane of shifts
    (``spectrum.py:668-724``): pivots ``d`` ``(n, B, S)`` and ``l``
    ``(n, B, S, w - 1)``, ``l[j, ..., p] = L[j + 1 + p, j]``.  Pivots
    are clamped to ``pivot_floor`` ``(B,)`` in magnitude."""
    _, w, n = _check_feed("_banded_factorize", feed)
    floor = pivot_floor[:, None]
    win = _Window(feed, shifts)
    d, l = [], []
    for i in range(n):
        safe = _clamp_pivot(win.pivot(), floor)
        d.append(safe)
        l.append(win.eliminate(1.0 / safe, i + w))
    return torch.stack(d), torch.stack(l)


def _start_vector(n, idx, seed, dtype, device):
    """``cos(0.7 i + seed + 2.347 idx + 0.9 i idx / n) + 1e-3`` ``(n, S)``:
    a distinct start per shift, so the resolvent of a degenerate cluster
    does not map every start onto one direction.  The JAX package's
    ``cos(0.7 i + seed + 2.347 idx) + 1e-3`` (``spectrum.py:858-860,
    1058``) spans only three dimensions (``cos``, ``sin`` and the
    constant), so a cluster of more than three eigenvalues — the six
    rigid-body modes of every ANM Hessian — gets at most three independent
    vectors and Gram-Schmidt fills the others with noise that corrupts
    the next columns of its window; the ``i idx`` term varies the
    frequency with the shift and makes the starts independent."""
    i = torch.arange(n, dtype=dtype, device=device)[:, None]
    idx = idx[None, :]
    return torch.cos(0.7 * i + seed + 2.347 * idx + 0.9 * (i * idx) / n) \
        + 1e-3


def _banded_solve(d, l, rhs):
    """``(L D L^t) x = rhs`` for factors of :func:`_banded_factorize`
    and ``rhs`` ``(n, B, S)``; returns ``x`` and ``sum(x^2)`` ``(B, S)``
    (``spectrum.py:727-758``, in the kernel's order: forward sweep,
    diagonal, backward sweep)."""
    n, _, _, bw = l.shape
    acc = rhs.new_zeros(rhs.shape[1:] + (bw,))
    z = []
    for i in range(n):
        z_i = rhs[i] - acc[..., 0]
        acc = torch.cat([acc[..., 1:], torch.zeros_like(acc[..., :1])], -1)
        acc = acc + l[i] * z_i[..., None]
        z.append(z_i)
    xwin = torch.zeros_like(acc)
    sumsq = torch.zeros_like(rhs[0])
    x = [None] * n
    for i in reversed(range(n)):
        x_i = z[i] / d[i] - (l[i] * xwin).sum(-1)
        xwin = torch.cat([x_i[..., None], xwin[..., :-1]], -1)
        sumsq = sumsq + x_i * x_i
        x[i] = x_i
    return torch.stack(x), sumsq


def banded_eigvec_plain(feed, shifts, idx0, pivot_floor, n_solves, seed):
    """Plain version of :func:`banded_eigvec` (the XLA path of
    ``spectrum.py:1050-1070`` in the kernel's order of operations):
    factor ``B - s I`` per shift, then `n_solves` solves from the start
    vector, each normalized by its running sum of squares.  Factors and
    solves run in float64 for any input, the result comes back in the
    input's dtype: in float32 the unpivoted factorization's element growth
    left about 0.5% of the vectors of N=300 ANM Hessians with band
    residuals near 5e-4 ``||B||`` whatever the number of solves, a few of
    which the refinement could not repair."""
    batch, _, n = _check_feed("banded_eigvec_plain", feed)
    d, l = _banded_factorize(feed.double(), shifts.double(),
                             pivot_floor.double())
    idx = torch.arange(idx0, idx0 + shifts.shape[-1], dtype=torch.float64,
                       device=feed.device)
    rhs = _start_vector(n, idx, seed, torch.float64, feed.device)[:, None, :]
    rhs = rhs.expand((n,) + shifts.shape)
    for _ in range(n_solves):
        x, sumsq = _banded_solve(d, l, rhs)
        rhs = x / torch.sqrt(torch.clamp(sumsq, min=1e-30))
    return rhs.permute(1, 0, 2).to(feed.dtype).contiguous()


def banded_eigvec(feed, shifts, idx0, pivot_floor, n_solves, seed):
    """
    Unit eigenvector estimates of a batch of band matrices, one per
    shift, by shifted LDL^t factorization and `n_solves` inverse-
    iteration sweeps: the kernel ``csrc/banded_eigvec.cu`` on CUDA,
    :func:`banded_eigvec_plain` on the CPU.  Not orthogonalized.

    Parameters
    ----------
    feed : Tensor, shape=(B, w, n + w)
        :func:`band_feed` of the band diagonals, ``w <= 9`` on CUDA.
    shifts : Tensor, shape=(B, S)
        Separated shifts (:func:`_separate_shifts`).
    idx0 : int
        Global index of the first shift (seeds the start vectors).
    pivot_floor : Tensor, shape=(B,)
        Pivot magnitude floor of each matrix.
    n_solves : int
    seed : float

    Returns
    -------
    Tensor, shape=(B, n, S)
    """
    batch, w, n = _check_feed("banded_eigvec", feed)
    if shifts.ndim != 2 or shifts.shape[0] != batch \
            or tuple(pivot_floor.shape) != (batch,):
        raise ValueError(f"banded_eigvec: shifts must be ({batch}, S) and "
                         f"pivot_floor ({batch},), got "
                         f"{tuple(shifts.shape)} and "
                         f"{tuple(pivot_floor.shape)}")
    if _build.route("banded_eigvec", feed, shifts, pivot_floor) == "cpu":
        return banded_eigvec_plain(feed, shifts, idx0, pivot_floor,
                                   n_solves, seed)
    _build.require_cuda_f32("banded_eigvec", feed=feed, shifts=shifts,
                            pivot_floor=pivot_floor)
    _check_kernel_limits("banded_eigvec", batch, w)
    s = shifts.shape[1]
    # per-shift float64 scratch in device memory, shift-minor ([.][shift])
    # so that a warp's loads coalesce: the factorization's window
    # checkpoints and the iterate; the caller bounds S (shift_chunk)
    held = eigvec_checkpoint_len(n, w)
    checkpoints = torch.empty((batch, held, s), dtype=torch.float64,
                              device=feed.device)
    x_scratch = torch.empty((batch, n, s), dtype=torch.float64,
                            device=feed.device)
    out = torch.empty((batch, n, s), dtype=torch.float32, device=feed.device)
    _build.launch("sc_banded_eigvec", feed.device, feed.data_ptr(),
                  shifts.data_ptr(), pivot_floor.data_ptr(),
                  checkpoints.data_ptr(), held, x_scratch.data_ptr(),
                  out.data_ptr(), batch, n, w, s, int(idx0), int(n_solves),
                  float(seed))
    banded_eigvec.launches += 1
    return out


banded_eigvec.launches = 0

def eigvec_checkpoint_len(n, w):
    """Doubles of window checkpoints :func:`banded_eigvec`'s kernel keeps
    a (matrix, shift): the window but its last column, ``w (w - 1) / 2``
    doubles, at the first of every 8 rows (``kSegment`` in
    ``csrc/banded_eigvec.cu``, whose entry refuses a shorter buffer)."""
    return -(-n // 8) * (w * (w - 1) // 2)


def eigvec_inputs(diags, eigvals):
    """``(feed, shifts, pivot_floor, sep)`` for :func:`banded_eigvec` from
    band diagonals ``(B, w, n)`` and ascending eigenvalues ``(B, n_ev)``:
    shifts separated by ``sep = 100 eps span`` ``(B, 1)`` and the pivot
    floor ``span eps`` ``(B,)`` of each matrix's Gershgorin span."""
    eps = torch.finfo(diags.dtype).eps
    lo, hi = _gershgorin_bounds(diags)
    span = hi - lo
    sep = (span * (100.0 * eps))[:, None]
    shifts = _separate_shifts(eigvals.to(diags.dtype), sep)
    return band_feed(diags), shifts, (span * eps).contiguous(), sep


def _windowed_mgs(x, window):
    """Gram-Schmidt of the columns of ``x`` ``(B, n, n_ev)`` in
    eigenvalue order, each against the `window` columns before it, two
    passes (``spectrum.py:1095-1119``).  The window is the finished
    columns themselves."""
    n_ev = x.shape[-1]
    cw = max(1, min(int(window), n_ev))
    u = torch.empty_like(x)
    for i in range(n_ev):
        x_i = x[..., i:i + 1]
        prev = u[..., max(0, i - cw):i]
        for _ in range(2):
            x_i = x_i - prev @ (_mt(prev) @ x_i)
        u[..., i:i + 1] = x_i / torch.clamp(
            torch.linalg.vector_norm(x_i, dim=-2, keepdim=True), min=1e-30)
    return u


def banded_eigenvectors(diags, eigvals, n_solves=2, shift_chunk=256,
                        window=8, seed=1):
    """
    Eigenvectors of band matrices at the given eigenvalues by factored
    inverse iteration with shifts separated by ``100 eps span``, then a
    windowed Gram-Schmidt sweep (``spectrum.py:970-1092``).

    Float32 with bandwidth at most 8 goes through :func:`banded_eigvec`
    (the kernel on CUDA); other inputs take its plain version.  Both
    clamp pivots at ``span * eps`` of each matrix (the JAX package's
    Pallas route; its XLA route uses the batch's largest span, ``:1040``),
    so kernel and plain version compute the same thing; both factor in
    float64 (the kernel with fused multiply-adds).  Shifts go in chunks of
    `shift_chunk`, which bounds the kernel's scratch (the factorization's
    window every 8 rows and the iterate) at
    ``B shift_chunk (w (w - 1) / 16 + 1) n`` doubles (1.3 GB at
    ``(128, 900)``, ``w = 9``).  From ``n >= 2048`` columns that come out
    non-finite (element growth of the unpivoted LDL^t) are
    solved again with shifts moved by ``5 sep``, and then replaced by
    their start vector (``:1042-1083``).

    Parameters
    ----------
    diags : Tensor, shape=(w, n) or (B, w, n)
    eigvals : Tensor, shape=(n_ev,) or (B, n_ev), ascending

    Returns
    -------
    Tensor, shape=([B,] n, n_ev), unit columns in the order of `eigvals`.
    """
    squeeze = diags.ndim == 2
    if squeeze:
        diags, eigvals = diags[None], eigvals[None]
    n, n_ev = diags.shape[-1], eigvals.shape[-1]
    feed, shifts, pivot_floor, sep = eigvec_inputs(diags, eigvals)
    fn = banded_eigvec if _kernel_route(diags) else banded_eigvec_plain
    chunk = max(1, min(int(shift_chunk), n_ev))
    rescue = n >= 2048
    parts = []
    for c0 in range(0, n_ev, chunk):
        sh = shifts[:, c0:c0 + chunk].contiguous()
        x = fn(feed, sh, c0, pivot_floor, n_solves, seed)
        if rescue:
            x = _rescue(fn, x, feed, sh, c0, pivot_floor, n_solves, seed,
                        sep)
        parts.append(x)
    u = _windowed_mgs(torch.cat(parts, -1), window)
    return u[0] if squeeze else u


def _rescue(fn, x, feed, shifts, idx0, pivot_floor, n_solves, seed, sep):
    """Non-finite columns of `x` solved again with jittered shifts, and
    those still non-finite replaced by their normalized start vector."""
    bad = ~torch.isfinite(x).all(dim=-2, keepdim=True)
    if not bool(bad.any()):
        return x
    x = torch.where(bad, fn(feed, (shifts + 5.0 * sep).contiguous(), idx0,
                            pivot_floor, n_solves, seed), x)
    still = ~torch.isfinite(x).all(dim=-2, keepdim=True)
    idx = torch.arange(idx0, idx0 + shifts.shape[-1], dtype=x.dtype,
                       device=x.device)
    x0 = _start_vector(x.shape[-2], idx, seed, x.dtype, x.device)
    x0 = x0 / torch.linalg.vector_norm(x0, dim=0, keepdim=True)
    return torch.where(still, x0, x)


# ---------------------------------------------------------------------------
# Refinement and the full eigensystem
# ---------------------------------------------------------------------------


def _perturbative_polish(a, u, vals, min_gap):
    """First-order removal of the contamination of ``u_i`` by ``u_j``,
    ``C[j, i] / (l_j - l_i)`` with ``C = U^T (A U - U diag(vals))``, where
    the gap exceeds `min_gap` ``(B,)``; columns whose correction has norm
    above 0.5 are left alone (``spectrum.py:1345-1371``)."""
    r = a @ u - u * vals[..., None, :]
    c = _mt(u) @ r
    denom = vals[..., :, None] - vals[..., None, :]
    coef = torch.where(denom.abs() > min_gap[..., None, None],
                       c / torch.where(denom == 0, 1.0, denom), 0.0)
    coef_norm = torch.linalg.vector_norm(coef, dim=-2, keepdim=True)
    coef = coef * (coef_norm <= 0.5)
    u = u - u @ coef
    return u / torch.clamp(torch.linalg.vector_norm(u, dim=-2, keepdim=True),
                           min=1e-30)


def _window_refine(a, u, vals, window):
    """Windowed Rayleigh-Ritz of an approximate eigensystem ``u`` ``(B,
    n, n)``: two passes of per-window QR, projection and small ``eigh``,
    the second offset by half a window, so that every adjacent pair
    shares a window; then ascending order (``spectrum.py:1374-1424``)."""
    batch, n = a.shape[0], a.shape[-1]
    w = min(window, n)
    n_main = (n // w) * w

    def refine_block(ub):
        # ub (B, nw, n, w): orthonormalize, project, diagonalize
        nw = ub.shape[1]
        q, _ = torch.linalg.qr(ub)
        aq = a @ q.permute(0, 2, 1, 3).reshape(batch, n, nw * w)
        aq = aq.reshape(batch, n, nw, w).permute(0, 2, 1, 3)
        s = _mt(q) @ aq
        theta, v = torch.linalg.eigh((s + _mt(s)) / 2)
        return q @ v, theta

    def one_pass(u, vals, offset):
        # windows start at `offset`; the wrap window pairs the two ends
        # of the spectrum, which Rayleigh-Ritz leaves as they were
        perm = (torch.arange(n, device=u.device) + offset) % n
        inv = torch.argsort(perm)
        u, vals = u[..., perm], vals[..., perm]
        ub = u[..., :n_main].reshape(batch, n, n_main // w, w)
        ub, theta = refine_block(ub.permute(0, 2, 1, 3))
        u = torch.cat([ub.permute(0, 2, 1, 3).reshape(batch, n, n_main),
                       u[..., n_main:]], -1)
        vals = torch.cat([theta.reshape(batch, n_main), vals[..., n_main:]],
                         -1)
        if n_main != n:
            # the remainder: one window over the last w columns
            tail, theta_t = refine_block(u[:, None, :, n - w:])
            u = torch.cat([u[..., :n - w], tail[:, 0]], -1)
            vals = torch.cat([vals[..., :n - w], theta_t[:, 0]], -1)
        return u[..., inv], vals[..., inv]

    u, vals = one_pass(u, vals, 0)
    u, vals = one_pass(u, vals, w // 2)
    order = torch.argsort(vals, dim=-1, stable=True)
    return (torch.gather(u, -1, order[:, None, :].expand_as(u)),
            torch.gather(vals, -1, order))


def eigh_banded(matrix, bandwidth=8, n_iter=40, n_solves=2,
                shift_chunk=256, window=8):
    """
    Full eigensystem of symmetric ``(n, n)`` or ``(B, n, n)`` matrices by
    the two-stage solver (``spectrum.py:1432-1501``): band reduction with
    reflectors, eigenvalues by bisection, band-space eigenvectors by
    inverse iteration, back-transform, two perturbative polish rounds
    (gap ``0.01 span``) and a windowed Rayleigh-Ritz of width
    ``max(32, window)``.  Float32 with ``bandwidth <= 8`` runs both
    kernels on CUDA.

    Returns
    -------
    vals : Tensor, shape=([B,] n), ascending
    vecs : Tensor, shape=([B,] n, n), modes in rows
    """
    a, squeeze = _batched(matrix)
    n = a.shape[-1]
    if n <= bandwidth + 1:
        vals, vecs = torch.linalg.eigh(a)
    else:
        diags, v_all, t_all = _band_reduce(a, bandwidth, "auto", 8, True)
        vals = banded_eigenvalues(diags, n_iter)
        u = banded_eigenvectors(diags, vals, n_solves=n_solves,
                                shift_chunk=shift_chunk, window=window)
        u = back_transform(v_all, t_all, u)
        min_gap = 0.01 * (vals[:, -1] - vals[:, 0])
        u = _perturbative_polish(a, u, vals, min_gap)
        u = _perturbative_polish(a, u, vals, min_gap)
        vecs, vals = _window_refine(a, u, vals, max(32, window))
    vecs = _mt(vecs)
    return (vals[0], vecs[0]) if squeeze else (vals, vecs)


# ---------------------------------------------------------------------------
# The JAX package's other public names
# ---------------------------------------------------------------------------


def banded_eigenvalues_pallas(diags, n_iter=40):
    """All eigenvalues (ascending) of band matrices given as diagonals
    ``(w, n)`` or ``(B, w, n)``, always through the bisection wrapper
    :func:`banded_bisect`: K10 on CUDA (float32, bandwidth at most 8, or
    it raises), its plain version on the CPU (``spectrum.py:1242``).  The
    TPU plans ``interpret=``, ``vmem_budget=`` and ``unroll=`` are not
    carried over."""
    squeeze = diags.ndim == 2
    d = diags[None] if squeeze else diags
    out = banded_bisect(*bisect_inputs(d), n_iter)
    return out[0] if squeeze else out


def eigh_banded_staged(matrix, bandwidth=8, n_iter=40, use_pallas=None,
                       n_solves=2, shift_chunk=256, window=8):
    """:func:`eigh_banded` of one ``(n, n)`` matrix
    (``spectrum.py:1556``).  The JAX package splits the solve into four
    device programs for its TPU compiler; eager torch runs the same
    stages in one call.  `use_pallas` as the entry points read it
    (``False`` asks for the plain versions, for the CPU).  Returns
    ``(eig_values, modes in rows)``."""
    if matrix.ndim != 2:
        raise ValueError("eigh_banded_staged takes a single (n, n) "
                         "matrix; use eigh_banded for batches")
    check_use_pallas(use_pallas, matrix.device)
    return eigh_banded(matrix, bandwidth=bandwidth, n_iter=n_iter,
                       n_solves=n_solves, shift_chunk=shift_chunk,
                       window=window)


def tridiagonalize(matrix):
    """Householder reduction of a symmetric ``(n, n)`` matrix to
    tridiagonal form by ``n - 2`` rank-2 updates (``spectrum.py:70-108``,
    the same reflector signs).  Returns ``(diag (n,), offdiag (n - 1,))``."""
    a = matrix
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for k in range(n - 2):
        x = torch.where(idx > k, a[:, k], zero)
        norm_x = torch.sqrt(torch.sum(x * x))
        head = x[k + 1]
        alpha = -torch.sign(torch.where(head == 0, 1.0, head)) * norm_x
        v = torch.where(idx == k + 1, x - alpha, x)
        v_norm = torch.sqrt(torch.sum(v * v))
        # skip the update where the column is already reduced
        safe = v_norm > _TINY
        v = torch.where(safe, v / torch.where(safe, v_norm, 1.0), zero)
        u = a @ v
        gamma = v @ u
        a = (a - 2.0 * torch.outer(v, u) - 2.0 * torch.outer(u, v)
             + 4.0 * gamma * torch.outer(v, v))
    return torch.diagonal(a), torch.diagonal(a, offset=1)


def _sturm_counts(diag, offdiag, shifts):
    """Eigenvalues of the tridiagonal matrix below each shift, by the
    LDL^t recurrence, for a vector of shifts (``spectrum.py:111-135``)."""
    e2 = torch.cat([torch.zeros(1, dtype=diag.dtype, device=diag.device),
                    offdiag * offdiag])
    tiny = torch.tensor(_TINY, dtype=diag.dtype, device=diag.device)
    q = diag[0] - shifts
    count = (q < 0).to(torch.int32)
    for i in range(1, diag.shape[0]):
        q_safe = torch.where(q.abs() < tiny, torch.where(q < 0, -tiny, tiny),
                             q)
        q = (diag[i] - shifts) - e2[i] / q_safe
        count += q < 0
    return count


def tridiagonal_eigenvalues(diag, offdiag, n_iter=45):
    """All eigenvalues (ascending) of a symmetric tridiagonal matrix by
    `n_iter` halvings of its Gershgorin interval for every eigenvalue at
    once (``spectrum.py:138-165``)."""
    n = diag.shape[0]
    zero = torch.zeros(1, dtype=diag.dtype, device=diag.device)
    e_pad = torch.cat([zero, offdiag.abs(), zero])
    radius = e_pad[:-1] + e_pad[1:]
    lo = torch.min(diag - radius).expand(n)
    hi = torch.max(diag + radius).expand(n)
    targets = torch.arange(n, dtype=torch.int32, device=diag.device)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        # count <= j: eigenvalue j lies at or above mid
        go_up = _sturm_counts(diag, offdiag, mid) <= targets
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    return 0.5 * (lo + hi)


def eigvalsh_sturm(matrix, n_iter=45):
    """Eigenvalues (ascending) of a symmetric ``(n, n)`` or ``(B, n, n)``
    matrix by :func:`tridiagonalize` and :func:`tridiagonal_eigenvalues`,
    without eigenvectors (``spectrum.py:168-179``)."""
    if matrix.ndim == 2:
        return tridiagonal_eigenvalues(*tridiagonalize(matrix),
                                       n_iter=n_iter)
    return torch.stack([eigvalsh_sturm(m, n_iter=n_iter) for m in matrix])
