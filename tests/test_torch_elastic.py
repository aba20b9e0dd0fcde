"""
PyTorch port, the elastic loop (``utils/elastic.py``) and the long solvers
that run through it: each case of ``tests/test_elastic.py`` against the
port's module (exception classification with torch's error types, the
liveness probe, retry, the atomic snapshots, the resumable loop),
snapshots written by one package and loaded by the other, and
``lowest_modes_matfree[_gnm]`` and ``lowest_modes_shift_invert_staged``
with ``checkpoint=`` and ``retries=`` against the JAX package's calls.

Tolerances: the elastic solves of the port equal its plain solves bit for
bit, and a solve interrupted at an outer iteration and resumed from its
snapshot equals the uninterrupted one bit for bit; against the JAX
package, float32 Chebyshev eigenvalues to 1e-6 relative (the bound of
``tests/test_elastic.py`` between the JAX package's own elastic and
plain calls) and float64 shift-invert eigenvalues to 1e-8 relative with
subspace projectors to 1e-6 (``tests/test_torch_modes.py``).
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from springcraft_tpu.ops import assembly as jassembly  # noqa: E402
from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import matfree as jmatfree  # noqa: E402
from springcraft_tpu.ops import modes as jmodes  # noqa: E402
from springcraft_tpu.ops import rigid as jrigid  # noqa: E402
from springcraft_tpu.utils import elastic as jelastic  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import matfree, modes  # noqa: E402
from springcraft_tpu_torch.utils import elastic  # noqa: E402


class _FakeXlaRuntimeError(Exception):
    pass


_FakeXlaRuntimeError.__name__ = "XlaRuntimeError"


class _Interrupted(Exception):
    """A non-device exception that ends a solve."""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the solvers run many small products and
    decompositions, and under pytest-xdist every worker's OpenMP pool
    would spin on all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Classification, probe, retry (tests/test_elastic.py:26-83)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc, expected", [
    (_FakeXlaRuntimeError("boom"), True),
    (RuntimeError("rpc UNAVAILABLE: x"), True),
    (RuntimeError("socket closed"), True),
    (elastic.DeviceProbeTimeout("probe timed out"), True),
    (torch.AcceleratorError("CUDA error: an illegal memory access was "
                            "encountered"), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (RuntimeError("sc_hessian_apply_pairs: CUDA error 719: unspecified "
                  "launch failure"), True),
    (ValueError("bad shape"), False),
    (TypeError("UNAVAILABLE"), False),
    (AssertionError("UNAVAILABLE"), False),
    (KeyError("INTERNAL"), False),
    (IndexError("CUDA error"), False),
    (AttributeError("CUDA error"), False),
    (NameError("CUDA error"), False),
    (RuntimeError("an ordinary bug"), False),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException) else "")
def test_is_device_failure_classification(exc, expected):
    assert elastic.is_device_failure(exc) is expected


def test_out_of_memory_is_not_a_device_failure():
    """The decision: running out of device memory is not retried.  The
    caching allocator has released its free blocks and retried before it
    raises, so the same step fails again after any wait; the JAX package
    retries an XLA ``RESOURCE_EXHAUSTED`` (its type, ``XlaRuntimeError``,
    is a device failure), the port does not."""
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB (INTERNAL allocator)")
    assert isinstance(oom, RuntimeError)
    assert not elastic.is_device_failure(oom)
    assert jelastic.is_device_failure(
        _FakeXlaRuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        raise oom

    with pytest.raises(torch.OutOfMemoryError):
        elastic.retry_on_failure(step, retries=3, wait=0.0, probe=False)
    assert calls["n"] == 1


def test_probe_device_passes_on_live_backend():
    elastic.probe_device(timeout=120.0, device="cpu")


def test_probe_device_default_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        elastic.probe_device(timeout=5.0)


def test_probe_device_times_out(monkeypatch):
    release = threading.Event()
    original = torch.arange

    def hang(*args, **kwargs):
        release.wait(10.0)
        return original(*args, **kwargs)

    monkeypatch.setattr(torch, "arange", hang)
    try:
        with pytest.raises(elastic.DeviceProbeTimeout):
            elastic.probe_device(timeout=0.05, device="cpu")
    finally:
        release.set()
    assert elastic.is_device_failure(elastic.DeviceProbeTimeout("x"))


def test_probe_device_reraises_and_checks_the_sum(monkeypatch):
    def broken(*args, **kwargs):
        raise torch.AcceleratorError("CUDA error: device lost")

    monkeypatch.setattr(torch, "arange", broken)
    with pytest.raises(torch.AcceleratorError):
        elastic.probe_device(timeout=5.0, device="cpu")
    monkeypatch.setattr(torch, "arange",
                        lambda *a, **k: torch.ones(8, **{
                            key: v for key, v in k.items()
                            if key == "device"}))
    with pytest.raises(RuntimeError, match="expected 28.0"):
        elastic.probe_device(timeout=5.0, device="cpu")


@pytest.mark.parametrize("probe", [False, "cpu", torch.device("cpu")])
def test_retry_recovers_from_transient_failure(probe):
    calls = {"n": 0}
    retried = []

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.AcceleratorError("CUDA error: relay dropped")
        return 42

    out = elastic.retry_on_failure(
        flaky, retries=2, wait=0.0, probe=probe,
        on_retry=lambda attempt, exc: retried.append(attempt))
    assert out == 42
    assert calls["n"] == 2
    assert retried == [1]


def test_retry_passes_arguments_and_waits():
    t0 = time.perf_counter()
    calls = []

    def flaky(a, b=0):
        calls.append((a, b))
        if len(calls) == 1:
            raise _FakeXlaRuntimeError("transient")
        return a + b

    assert elastic.retry_on_failure(flaky, 2, b=3, retries=1, wait=0.2,
                                    probe=False) == 5
    assert calls == [(2, 3), (2, 3)]
    assert time.perf_counter() - t0 >= 0.2


def test_retry_gives_up_after_budget():
    def dead():
        raise _FakeXlaRuntimeError("still down")

    with pytest.raises(_FakeXlaRuntimeError):
        elastic.retry_on_failure(dead, retries=2, wait=0.0, probe=False)


def test_retry_does_not_mask_real_bugs():
    calls = {"n": 0}

    def buggy():
        calls["n"] += 1
        raise ValueError("a real bug")

    with pytest.raises(ValueError):
        elastic.retry_on_failure(buggy, retries=5, wait=0.0, probe=False)
    assert calls["n"] == 1


# ---------------------------------------------------------------------------
# Snapshots and the resumable loop (tests/test_elastic.py:86-168)
# ---------------------------------------------------------------------------

def test_loop_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "state.npz"
    ckpt = elastic.LoopCheckpoint(path, every=2)
    assert ckpt.load() is None
    state = {"x": np.arange(6.0).reshape(2, 3), "a": np.float32(0.25)}
    ckpt.save(3, state)
    iteration, loaded = ckpt.load()
    assert iteration == 3
    np.testing.assert_array_equal(loaded["x"], state["x"])
    assert loaded["a"] == np.float32(0.25)
    ckpt.clear()
    assert ckpt.load() is None
    with pytest.raises(ValueError):
        ckpt.save(0, {"__iteration__": np.zeros(1)})
    with pytest.raises(ValueError):
        elastic.LoopCheckpoint(path, every=0)


def test_loop_checkpoint_saves_tensors(tmp_path):
    """Tensors (a CUDA tensor alike, ``.cpu()`` first) and Python floats
    keep their dtype and bits; the temp file is gone after the save."""
    path = tmp_path / "state.npz"
    x = torch.randn(5, 4, dtype=torch.float32, requires_grad=True)
    state = {"x": x, "a": 0.1 + 0.2, "res": torch.full((3,), float("inf"))}
    elastic.LoopCheckpoint(path).save(2, state)
    assert sorted(os.listdir(tmp_path)) == ["state.npz"]
    iteration, loaded = elastic.LoopCheckpoint(path).load()
    assert iteration == 2
    assert loaded["x"].dtype == np.float32
    assert np.array_equal(loaded["x"], x.detach().numpy())
    assert loaded["a"].dtype == np.float64 and float(loaded["a"]) == 0.1 + 0.2
    assert np.isinf(loaded["res"]).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshots_cross_between_packages(tmp_path, writer):
    """A snapshot written by either package loads in the other: the same
    keys, ``__iteration__`` and ``.npz`` layout."""
    path = tmp_path / "state.npz"
    state = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
             "a": np.float64(1.25), "theta": np.zeros(4, np.float32)}
    save, load = ((elastic, jelastic) if writer == "port"
                  else (jelastic, elastic))
    save.LoopCheckpoint(path).save(5, {
        k: (torch.from_numpy(v) if writer == "port" and v.ndim else v)
        for k, v in state.items()})
    iteration, loaded = load.LoopCheckpoint(path).load()
    assert iteration == 5 and sorted(loaded) == sorted(state)
    for key, value in state.items():
        assert loaded[key].dtype == value.dtype
        assert np.array_equal(loaded[key], value)


def _counting_step(log):
    def step(i, state):
        log.append(i)
        return {"acc": state["acc"] + (i + 1)}
    return step


def test_resumable_loop_plain():
    log = []
    state, done = elastic.resumable_loop(
        _counting_step(log), {"acc": np.float64(0.0)}, 5, probe=False)
    assert done == 5
    assert float(state["acc"]) == 15.0
    assert log == [0, 1, 2, 3, 4]


def test_resumable_loop_early_stop():
    log = []
    state, done = elastic.resumable_loop(
        _counting_step(log), {"acc": np.float64(0.0)}, 100,
        stop=lambda st: float(st["acc"]) >= 6.0, probe=False)
    assert done == 3
    assert log == [0, 1, 2]


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_resumable_loop_resumes_from_snapshot(tmp_path, resumer):
    """The port's loop dies at iteration 3; the port's (or the JAX
    package's) loop resumes at 3 from its snapshot."""
    path = str(tmp_path / "loop.npz")
    log1 = []

    def dying_step(i, state):
        if i == 3:
            raise KeyboardInterrupt  # simulated hard crash
        log1.append(i)
        return {"acc": state["acc"] + (i + 1)}

    with pytest.raises(KeyboardInterrupt):
        elastic.resumable_loop(
            dying_step, {"acc": np.float64(0.0)}, 6,
            checkpoint=elastic.LoopCheckpoint(path, every=1), probe=False)
    assert log1 == [0, 1, 2]

    module = elastic if resumer == "port" else jelastic
    log2 = []
    state, done = module.resumable_loop(
        _counting_step(log2), {"acc": np.float64(0.0)}, 6,
        checkpoint=module.LoopCheckpoint(path, every=1), probe=False)
    assert log2 == [3, 4, 5]
    assert done == 6
    assert float(state["acc"]) == 21.0  # 1+2+3 resumed + 4+5+6
    assert elastic.LoopCheckpoint(path).load() is None


def test_resumable_loop_snapshots_every_k(tmp_path):
    path = tmp_path / "loop.npz"
    seen = []

    def step(i, state):
        if i == 5:
            seen.append(elastic.LoopCheckpoint(path).load()[0])
            raise _Interrupted
        return {"acc": state["acc"] + 1.0}

    with pytest.raises(_Interrupted):
        elastic.resumable_loop(step, {"acc": 0.0}, 8,
                               checkpoint=elastic.LoopCheckpoint(path, 2),
                               probe=False)
    assert seen == [4]


def test_resumable_loop_refuses_a_snapshot_past_its_end(tmp_path):
    """The loop never snapshots its last iteration, so a snapshot at
    iteration >= n_steps is another loop's: refused, and left on disk."""
    path = str(tmp_path / "loop.npz")
    elastic.LoopCheckpoint(path).save(6, {"acc": np.float64(9.0)})
    log = []
    with pytest.raises(ValueError, match="another call"):
        elastic.resumable_loop(_counting_step(log), {"acc": np.float64(0.0)},
                               6, checkpoint=path, probe=False)
    assert log == []
    assert elastic.LoopCheckpoint(path).load()[0] == 6


def test_resumable_loop_retries_device_failure():
    fails = {"armed": True}

    def step(i, state):
        if i == 2 and fails["armed"]:
            fails["armed"] = False
            raise _FakeXlaRuntimeError("transient")
        return {"acc": state["acc"] + 1.0}

    state, done = elastic.resumable_loop(
        step, {"acc": np.float64(0.0)}, 4, retries=1, wait=0.0,
        probe=False)
    assert done == 4
    assert float(state["acc"]) == 4.0


# ---------------------------------------------------------------------------
# The solvers (tests/test_elastic.py:171-201)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_cloud():
    rng = np.random.RandomState(11)
    return (rng.rand(90, 3) * 12.0).astype(np.float64)


def _equal(got, ref):
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def test_lowest_modes_checkpoint_matches_plain(small_cloud, tmp_path):
    """``tests/test_elastic.py::test_lowest_modes_checkpoint_matches_plain``
    in both packages: the port's elastic call equals its plain call bit
    for bit and the JAX package's elastic call to 1e-6."""
    kwargs = dict(k=4, degree=24, n_outer=4, use_pallas=False,
                  sparse=False, seed=3)
    path = str(tmp_path / "modes.npz")
    plain = sct.lowest_modes_matfree(small_cloud, sct.invariant_params(8.0),
                                     device="cpu", **kwargs)
    got = sct.lowest_modes_matfree(small_cloud, sct.invariant_params(8.0),
                                   device="cpu", checkpoint=path, retries=1,
                                   **kwargs)
    assert _equal(got, plain)
    assert not os.path.exists(path)
    ref = jmatfree.lowest_modes_matfree(small_cloud, jff.invariant_params(8.0),
                                        checkpoint=path, retries=1, **kwargs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.abs(got[1].numpy()),
                               np.abs(np.asarray(ref[1])), rtol=1e-4,
                               atol=1e-5)


def test_lowest_modes_gnm_elastic_path(small_cloud):
    kwargs = dict(k=3, degree=24, n_outer=3, use_pallas=False,
                  sparse=False, seed=5)
    plain = sct.lowest_modes_matfree_gnm(
        small_cloud, sct.invariant_params(8.0), device="cpu", **kwargs)
    got = sct.lowest_modes_matfree_gnm(
        small_cloud, sct.invariant_params(8.0), device="cpu", retries=2,
        **kwargs)
    assert _equal(got, plain)
    ref = jmatfree.lowest_modes_matfree_gnm(
        small_cloud, jff.invariant_params(8.0), retries=2, **kwargs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("gnm", [False, True], ids=["anm", "gnm"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_interrupted_solve_resumes_bit_for_bit(small_cloud, tmp_path, gnm,
                                               sparse, dtype):
    """Interrupted after outer iteration 2 by a non-device exception, the
    snapshot on disk holds the loop carry as the loop carries it; the
    same call made again runs the remaining iterations only and returns
    the uninterrupted result bit for bit, then removes the snapshot."""
    solver = sct.lowest_modes_matfree_gnm if gnm else sct.lowest_modes_matfree
    options = dict(degree=16, n_outer=5, seed=2, sparse=sparse, tile=16,
                   dtype=dtype, device="cpu")
    params = sct.invariant_params(8.0)
    plain = solver(small_cloud, params, 3, **options)
    path = str(tmp_path / "modes.npz")
    original = matfree._chebfsi_outer
    calls = []

    def outer(*args, **kwargs):
        calls.append(args[3])  # the filter cutoff a
        if len(calls) == 3:
            raise _Interrupted
        return original(*args, **kwargs)

    matfree._chebfsi_outer = outer
    try:
        with pytest.raises(_Interrupted):
            solver(small_cloud, params, 3, checkpoint=path, **options)
    finally:
        matfree._chebfsi_outer = original
    iteration, state = elastic.LoopCheckpoint(path).load()
    p = state["x"].shape[1]
    assert iteration == 2 and p == 3 + 8
    assert state["x"].dtype == state["theta"].dtype == state["res"].dtype \
        == {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    assert state["a"].dtype == np.float64 and state["a"].shape == ()
    assert float(state["a"]) == calls[2]  # the third call's cutoff, exact
    resumed_calls = []

    def counted(*args, **kwargs):
        resumed_calls.append(1)
        return original(*args, **kwargs)

    matfree._chebfsi_outer = counted
    try:
        got = solver(small_cloud, params, 3, checkpoint=path, **options)
    finally:
        matfree._chebfsi_outer = original
    assert len(resumed_calls) == 3
    assert _equal(got, plain)
    assert not os.path.exists(path)


@pytest.mark.parametrize("snapshot", ["columns", "rows", "dtype",
                                      "iteration"])
def test_solve_refuses_another_calls_snapshot(small_cloud, tmp_path,
                                              snapshot):
    """A snapshot whose block has other columns (another k), rows (other
    atoms) or dtype, or whose iteration is not below `n_outer`, belongs to
    another call: the solve raises and leaves the file alone."""
    m, p = 3 * len(small_cloud), 3 + 8
    shape = {"columns": (m, p + 1), "rows": (m - 3, p)}.get(snapshot,
                                                           (m, p))
    dtype = np.float64 if snapshot == "dtype" else np.float32
    path = str(tmp_path / "modes.npz")
    elastic.LoopCheckpoint(path).save(
        4 if snapshot == "iteration" else 1,
        {"x": np.ones(shape, dtype), "a": 1.0,
         "theta": np.ones(p, dtype), "res": np.ones(3, dtype)})
    with pytest.raises(ValueError, match="another call"):
        sct.lowest_modes_matfree(small_cloud, sct.invariant_params(8.0), 3,
                                 degree=16, n_outer=4, checkpoint=path,
                                 device="cpu")
    assert elastic.LoopCheckpoint(path).load()[1]["x"].shape == shape


def test_retried_solve_equals_the_plain_one(small_cloud, monkeypatch):
    """One injected device failure in outer iteration 1: the iteration is
    retried (probe on the coordinates' device) and the result is the
    plain one."""
    params = sct.invariant_params(8.0)
    options = dict(degree=16, n_outer=4, seed=2, device="cpu")
    plain = sct.lowest_modes_matfree(small_cloud, params, 3, **options)
    original = matfree._chebfsi_outer
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise torch.AcceleratorError("CUDA error: launch failure")
        return original(*args, **kwargs)

    waits = []
    monkeypatch.setattr(matfree, "_chebfsi_outer", flaky)
    monkeypatch.setattr(elastic.time, "sleep", waits.append)
    got = sct.lowest_modes_matfree(small_cloud, params, 3, retries=1,
                                   **options)
    monkeypatch.undo()
    assert waits == [5.0]
    assert len(calls) == 5
    assert _equal(got, plain)


def test_a_resumed_jax_snapshot_continues_in_the_port(small_cloud, tmp_path):
    """A JAX snapshot of the same float64 call (x, a, theta, res after
    two outer iterations) resumed by the port finishes as the JAX call
    does, to the JAX package's elastic tolerance."""
    kwargs = dict(k=3, degree=16, n_outer=4, use_pallas=False,
                  sparse=False, seed=4)
    path = str(tmp_path / "modes.npz")
    original = jmatfree._chebfsi_outer
    calls = []

    def dying(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise _Interrupted
        return original(*args, **kwargs)

    jmatfree._chebfsi_outer = dying
    try:
        with pytest.raises(_Interrupted):
            jmatfree.lowest_modes_matfree(
                small_cloud, jff.invariant_params(8.0), checkpoint=path,
                dtype=np.float64, **kwargs)
    finally:
        jmatfree._chebfsi_outer = original
    assert elastic.LoopCheckpoint(path).load()[0] == 2
    ref = jmatfree.lowest_modes_matfree(small_cloud, jff.invariant_params(8.0),
                                        dtype=np.float64, **kwargs)
    got = sct.lowest_modes_matfree(small_cloud, sct.invariant_params(8.0),
                                   checkpoint=path, dtype=torch.float64,
                                   device="cpu", **kwargs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-10)
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# The staged shift-invert
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hessian(small_cloud):
    h = np.asarray(jassembly.hessian_matrix(
        small_cloud, jff.invariant_params(8.0), np, dtype=np.float64,
        layout="xyz"))
    return h, np.asarray(jrigid.rigid_modes_anm(small_cloud))


def _projector_distance(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(torch.as_tensor(b).double())
    return np.max(np.abs(a.T @ a - b.T @ b))


@pytest.mark.parametrize("k", [4, 8])
def test_staged_shift_invert_with_checkpoint_matches_jax(hessian, tmp_path,
                                                         k):
    """The JAX function starts from its host QR, the port from the
    ``"chol"`` engine's block: both run to convergence (60 steps; at the
    default 24 the eighth mode is still 3e-7 apart) and agree there."""
    h, t = hessian
    path = str(tmp_path / "si.npz")
    ref = jmodes.lowest_modes_shift_invert_staged(
        h, t, k=k, n_iter=60, checkpoint=path, retries=1)
    got = modes.lowest_modes_shift_invert_staged(
        torch.from_numpy(h.copy()), torch.from_numpy(t.copy()), k=k,
        n_iter=60, checkpoint=path, retries=1)
    assert got[1].shape == (k, 270)
    assert np.max(np.abs(got[0].numpy() - np.asarray(ref[0]))
                  / np.abs(np.asarray(ref[0]))) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6
    assert np.max(np.abs(got[0].numpy() - np.linalg.eigvalsh(h)[6:6 + k])
                  / np.linalg.eigvalsh(h)[6:6 + k]) <= 1e-8
    assert not os.path.exists(path)


def test_staged_shift_invert_resumes_bit_for_bit(hessian, tmp_path):
    h, t = hessian
    H, T = torch.from_numpy(h.copy()), torch.from_numpy(t.copy())
    chol = modes.lowest_modes_shift_invert(H, T, k=4, engine="chol")
    path = str(tmp_path / "si.npz")
    original = modes._shift_invert_step
    calls = []

    def step(*args):
        calls.append(1)
        if len(calls) == 6 and armed:
            raise _Interrupted
        return original(*args)

    armed = True
    modes._shift_invert_step = step
    try:
        with pytest.raises(_Interrupted):
            modes.lowest_modes_shift_invert_staged(H, T, k=4,
                                                   checkpoint=path)
        assert elastic.LoopCheckpoint(path).load()[0] == 5
        armed = False
        calls.clear()
        got = modes.lowest_modes_shift_invert_staged(H, T, k=4,
                                                     checkpoint=path)
    finally:
        modes._shift_invert_step = original
    assert len(calls) == 24 - 5
    assert torch.equal(got[0], chol[0]) and torch.equal(got[1], chol[1])
    assert not os.path.exists(path)


def test_staged_shift_invert_refuses_another_calls_snapshot(hessian,
                                                            tmp_path):
    """A subspace of another width (another k) is refused, not resumed."""
    h, t = hessian
    path = str(tmp_path / "si.npz")
    elastic.LoopCheckpoint(path).save(3, {"x": np.ones((270, 4 + 8))})
    with pytest.raises(ValueError, match="another call"):
        modes.lowest_modes_shift_invert_staged(
            torch.from_numpy(h.copy()), torch.from_numpy(t.copy()), k=5,
            checkpoint=path)
    assert os.path.exists(path)


def test_staged_shift_invert_retries_each_stage(hessian):
    """A device failure in the factor, in a step and in the finish: each
    retried once (wait 0), the result the chol engine's."""
    h, t = hessian
    H, T = torch.from_numpy(h.copy()), torch.from_numpy(t.copy())
    chol = modes.lowest_modes_shift_invert(H, T, k=4, engine="chol")
    armed = {"factor": True, "step": True, "finish": True}
    originals = {"factor": sct.ops.rigid._cholesky_factor,
                 "step": modes._shift_invert_step,
                 "finish": modes._shift_invert_finish}

    def flaky(name):
        def call(*args):
            if armed[name]:
                armed[name] = False
                raise RuntimeError(f"CUDA error: injected in {name}")
            return originals[name](*args)
        return call

    sct.ops.rigid._cholesky_factor = flaky("factor")
    modes._shift_invert_step = flaky("step")
    modes._shift_invert_finish = flaky("finish")
    try:
        got = modes.lowest_modes_shift_invert_staged(H, T, k=4, wait=0.0)
    finally:
        sct.ops.rigid._cholesky_factor = originals["factor"]
        modes._shift_invert_step = originals["step"]
        modes._shift_invert_finish = originals["finish"]
    assert not any(armed.values())
    assert torch.equal(got[0], chol[0]) and torch.equal(got[1], chol[1])
    with pytest.raises(RuntimeError, match="CUDA error"):
        armed["factor"] = True
        sct.ops.rigid._cholesky_factor = flaky("factor")
        try:
            modes.lowest_modes_shift_invert_staged(H, T, k=4, retries=0)
        finally:
            sct.ops.rigid._cholesky_factor = originals["factor"]


def test_staged_default_retries_is_two():
    """The JAX function's default (the port took 0 while it had no
    elastic loop)."""
    import inspect

    for fn in (modes.lowest_modes_shift_invert_staged,
               jmodes.lowest_modes_shift_invert_staged):
        assert inspect.signature(fn).parameters["retries"].default == 2
