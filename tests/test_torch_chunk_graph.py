"""
PyTorch port, the chunk loop of the two ensemble fluctuation entry points
on a CUDA graph (``parallel/pipeline.py`` ``_run_graphed``).

On the card (marked ``cuda``, skipped without an NVIDIA GPU): each graphed
call against the eager loop (``_run_chunked``, the loop the other entry
points run) bit for bit over several chunks, the kernel wrappers counting
the eager and the captured chunk and ``replayed_launches`` the rest; one
capture and ``chunks - 2`` replays a multi-chunk call; a recapture
whenever the force field, the shapes, the options or the TF32 setting
change; a single-chunk call keeps the eager loop; a call on a second
card (skipped with one) captures on that card, beside the first card's
graph.

On the CPU: the graphed loop never engages, and its bookkeeping (eager
first chunk, capture, replays, launch counters, copied outputs, the key)
is held with a stand-in for the CUDA graph.

This file imports neither JAX nor the JAX package::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_chunk_graph.py
"""

import contextlib
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.parallel import pipeline  # noqa: E402

CHUNK = 4
CHUNKS = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_graphs():
    """Each test starts without a chunk graph and with TF32 off, and
    leaves none behind."""
    pipeline._CHUNK_GRAPHS.clear()
    yield
    pipeline._CHUNK_GRAPHS.clear()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _coords(b, n, seed):
    # protein-like density, connected at a 13 A cutoff
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * 34.0 * (n / 300) ** (1 / 3)).astype(np.float32)
    return base[None] + 0.3 * rng.randn(b, n, 3).astype(np.float32)


def _masses(n):
    return np.linspace(0.8, 2.5, n).astype(np.float32)


def _sdenm(n):
    atoms = sct.AtomArray(n)
    atoms.coord = _coords(1, n, 3)[0]
    atoms.atom_name = np.full(n, "CA")
    atoms.element = np.full(n, "C")
    atoms.chain_id = np.full(n, "A")
    atoms.res_id = np.arange(1, n + 1)
    atoms.res_name = np.array(["ALA", "GLY", "LEU", "SER"] * n)[:n]
    return sct.TabulatedForceField.sd_enm(atoms).to_compact_params()


def _anm(params=None, masses=None, **options):
    def call(coords, device, chunk=CHUNK):
        return sct.ensemble_anm_fluctuations(
            coords, params or sct.invariant_params(13.0), masses=masses,
            inverse="blocked", chunk=chunk, device=device, **options)
    return call


def _gnm(coords, device, chunk=CHUNK):
    return sct.ensemble_gnm_fluctuations(
        coords, sct.invariant_params(13.0), inverse="blocked", chunk=chunk,
        device=device)


def _cases(n):
    return {
        "anm-traces": _anm(with_covariance=False),
        "anm-cov-prs": _anm(with_covariance=True, with_prs=True),
        "anm-masses": _anm(masses=_masses(n), with_covariance=False),
        "anm-cov-masses": _anm(masses=_masses(n), with_covariance=True),
        "anm-sdenm": _anm(params=_sdenm(n), with_covariance=False),
        "gnm": _gnm,
    }


#: 3n = 120 and n = 40 are the factor's padded sizes; at 100 it pads both
#: (3n = 300 to 384 in the stitch kernel, n = 100 to 104 in
#: ``_regularize_equilibrated``, which keeps the GNM eager)
N, PADDED = 40, 100
CASES = _cases(N)


def _counts():
    return {(name, counter): getattr(wrapper, counter)
            for name, wrapper in sct.kernel_wrappers().items()
            for counter in vars(wrapper) if counter.endswith("launches")}


def _counted(call, *args, **kwargs):
    """``call``'s outputs, synchronized, and the kernel launches it
    added."""
    before = _counts()
    out = call(*args, **kwargs)
    if any(v.is_cuda for v in out.values()):
        torch.cuda.synchronize()
    after = _counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def _eager(call, *args, **kwargs):
    """``call`` through the eager loop alone."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "_graphs_apply", lambda *args: False)
        return _counted(call, *args, **kwargs)


def _graphs():
    return pipeline._run_graphed.captures, pipeline._run_graphed.replays


def _graphed(call, *args, **kwargs):
    """``call``'s outputs, synchronized, the launches the kernel wrappers
    counted and those its replays added to ``replayed_launches``."""
    before = dict(pipeline._run_graphed.replayed_launches)
    out, launches = _counted(call, *args, **kwargs)
    after = pipeline._run_graphed.replayed_launches
    return out, launches, {k: after[k] - before.get(k, 0) for k in after
                           if after[k] != before.get(k, 0)}


def _share(launches, chunks):
    return {k: v * chunks // CHUNKS for k, v in launches.items()}


def _assert_equal(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        assert torch.isfinite(ref[key]).all(), key
        assert torch.equal(got[key], ref[key]), key


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case, n", [(case, N) for case in sorted(CASES)]
                         + [(case, PADDED) for case in sorted(CASES)
                            if case != "gnm"])
def test_graphed_chunks_equal_the_eager_loop(cuda, case, n):
    call = _cases(n)[case]
    coords = torch.as_tensor(_coords(CHUNK * CHUNKS, n, 11), device=cuda)
    ref, eager_launches = _eager(call, coords, cuda)
    captures, replays = _graphs()
    got, launches, replayed = _graphed(call, coords, cuda)
    _assert_equal(got, ref)
    assert _graphs() == (captures + 1, replays + CHUNKS - 2)
    # the wrappers count the eager and the captured chunk, the replays
    # the rest
    assert eager_launches and launches == _share(eager_launches, 2)
    assert replayed == _share(eager_launches, CHUNKS - 2)
    # a later call replays every chunk, on other conformers
    other = torch.as_tensor(_coords(CHUNK * CHUNKS, n, 12), device=cuda)
    ref, eager_launches = _eager(call, other, cuda)
    got, launches, replayed = _graphed(call, other, cuda)
    _assert_equal(got, ref)
    assert _graphs() == (captures + 1, replays + 2 * CHUNKS - 2)
    assert launches == {} and replayed == eager_launches


def _tf32_on():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["params", "shape", "chunk", "options",
                                    "masses", "tf32"])
def test_a_change_recaptures(cuda, change):
    coords = torch.as_tensor(_coords(CHUNK * CHUNKS, N, 21), device=cuda)
    first = _anm(with_covariance=False)
    first(coords, cuda)
    call, setup, chunk = first, None, CHUNK
    if change == "params":
        call = _anm(params=sct.invariant_params(11.0), with_covariance=False)
    elif change == "shape":
        coords = torch.as_tensor(_coords(CHUNK * CHUNKS, N + 4, 21),
                                 device=cuda)
    elif change == "chunk":
        chunk = 2 * CHUNK
        coords = torch.as_tensor(_coords(chunk * 3, N, 21), device=cuda)
    elif change == "options":
        call = _anm(with_covariance=False, with_dcc=False)
    elif change == "masses":
        call = _anm(masses=_masses(N), with_covariance=False)
    else:
        setup = _tf32_on
    if setup is not None:
        setup()
    ref, _ = _eager(call, coords, cuda, chunk=chunk)
    captures, _ = _graphs()
    got, _ = _counted(call, coords, cuda, chunk=chunk)
    _assert_equal(got, ref)
    assert _graphs()[0] == captures + 1
    assert list(pipeline._CHUNK_GRAPHS) == [
        ("ensemble_anm_fluctuations", cuda.index or 0)]


@pytest.mark.cuda
def test_tf32_changes_the_answer(cuda):
    """The TF32 case above shows a recapture only if TF32 moves the
    bits of this problem."""
    coords = torch.as_tensor(_coords(CHUNK, N, 21), device=cuda)
    call = _anm(with_covariance=False)
    off, _ = _eager(call, coords, cuda)
    _tf32_on()
    on, _ = _eager(call, coords, cuda)
    assert not torch.equal(off["msf"], on["msf"])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [CHUNK, None])
def test_a_single_chunk_call_keeps_the_eager_loop(cuda, chunk):
    call = _anm(with_covariance=True, with_prs=True)
    before = _graphs()
    for seed in (31, 32, 33):
        coords = torch.as_tensor(_coords(CHUNK, N, seed), device=cuda)
        ref, eager_launches = _eager(call, coords, cuda, chunk=chunk)
        got, launches = _counted(call, coords, cuda, chunk=chunk)
        _assert_equal(got, ref)
        assert launches == eager_launches
    assert _graphs() == before and not pipeline._CHUNK_GRAPHS


@pytest.mark.cuda
def test_a_padded_gnm_keeps_the_eager_loop(cuda):
    coords = torch.as_tensor(_coords(CHUNK * CHUNKS, PADDED, 13),
                             device=cuda)
    ref, eager_launches = _eager(_gnm, coords, cuda)
    before = _graphs()
    got, launches = _counted(_gnm, coords, cuda)
    _assert_equal(got, ref)
    assert launches == eager_launches
    assert _graphs() == before and not pipeline._CHUNK_GRAPHS


@pytest.mark.cuda
def test_graphed_chunks_on_a_second_card(cuda):
    """A call on cuda:1 while cuda:0 is current captures on cuda:1 (a
    graph captured on another card's stream would be empty and replay
    nothing), and keeps its graph beside cuda:0's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (torch.cuda.device_count() < 2)")
    call = CASES["anm-cov-prs"]
    cards = [torch.device("cuda", i) for i in (1, 0, 1)]
    captures, replays = _graphs()
    for seed, card in enumerate(cards):
        assert torch.cuda.current_device() == 0
        coords = torch.as_tensor(_coords(CHUNK * CHUNKS, N, 80 + seed),
                                 device=card)
        ref, eager_launches = _eager(call, coords, card)
        got, launches, replayed = _graphed(call, coords, card)
        _assert_equal(got, ref)
        assert all(value.device == card for value in got.values())
        assert {k: launches.get(k, 0) + replayed.get(k, 0)
                for k in eager_launches} == eager_launches
    assert _graphs() == (captures + 2, replays + 3 * CHUNKS - 4)
    assert set(pipeline._CHUNK_GRAPHS) == {
        ("ensemble_anm_fluctuations", 0), ("ensemble_anm_fluctuations", 1)}


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_never_engages_off_cuda(monkeypatch, case):
    coords = _coords(CHUNK * 3, N, 41)
    ref, ref_launches = _eager(CASES[case], coords, "cpu")
    monkeypatch.setattr(pipeline, "_run_graphed", None)
    got, launches = _counted(CASES[case], coords, "cpu")
    _assert_equal(got, ref)
    assert launches == ref_launches == {}
    assert not pipeline._CHUNK_GRAPHS


OTHERS = {
    "ensemble_anm": {},
    "ensemble_gnm": {},
    "ensemble_anm_banded": {"n_iter_bisect": 24},
    "ensemble_gnm_banded": {"n_iter_bisect": 24},
    "ensemble_anm_spectral": {"n_iter_bisect": 24},
    "ensemble_gnm_spectral": {"n_iter_bisect": 24},
}


@pytest.mark.parametrize("name", sorted(OTHERS))
def test_other_entry_points_keep_the_eager_loop(monkeypatch, name):
    """The six other chunked entry points: `_run_chunked` a call, the
    graphed loop never, and each chunk's outputs those of a call on the
    chunk alone."""
    entry = getattr(sct, name)
    coords = _coords(4, 10, 43)
    params = sct.invariant_params(13.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of tiny ops in the banded solver
    try:
        halves = [entry(coords[i:i + 2], params, device="cpu",
                        **OTHERS[name]) for i in (0, 2)]
        calls = []
        real = pipeline._run_chunked
        monkeypatch.setattr(pipeline, "_run_chunked",
                            lambda *a: calls.append(a[2]) or real(*a))
        monkeypatch.setattr(pipeline, "_run_graphed", None)
        got = entry(coords, params, device="cpu", chunk=2, **OTHERS[name])
    finally:
        torch.set_num_threads(threads)
    assert calls == [2]
    _assert_equal(got, {key: torch.cat([h[key] for h in halves])
                        for key in halves[0]})


class _StandInGraph:
    """Records what ``_capture`` runs and runs it again on ``replay``, as
    a CUDA graph would on its static tensors."""

    live = []
    capturing = None

    def __init__(self):
        self.work = None
        _StandInGraph.live.append(self)

    def replay(self):
        self.work()


def _stand_in_run(coords, masses):
    """A chunk: its outputs from `coords` and `masses`, a launch counted
    on a kernel wrapper; while capturing, it leaves the work to redo on
    the stand-in graph's replay."""
    wrapper = sct.kernel_wrappers()["panel_inverse"]
    scale = 1.0 if masses is None else masses.sum()
    out = {"msf": coords.sum(-1) * scale, "dcc": coords.flip(0) * scale}
    wrapper.launches += 1
    if _StandInGraph.capturing is not None:
        def work():
            s = 1.0 if masses is None else masses.sum()
            out["msf"].copy_(coords.sum(-1) * s)
            out["dcc"].copy_(coords.flip(0) * s)
        _StandInGraph.capturing.work = work
    return out


@contextlib.contextmanager
def _stand_in_capture(graph, stream=None, capture_error_mode=None):
    _StandInGraph.capturing = graph
    try:
        yield
    finally:
        _StandInGraph.capturing = None


@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA graph, its capture and the device, stream and stream
    guards the graphed loop takes, as stand-ins that run on the CPU."""
    _StandInGraph.live, _StandInGraph.capturing = [], None
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    return _StandInGraph


def _stand_in_call(coords, masses=None, chunk=CHUNK, options=(),
                   params=None):
    return pipeline._run_graphed(_stand_in_run, coords, masses, chunk,
                                 "entry", params or sct.invariant_params(
                                     13.0), options)


def _stand_in_ref(coords, masses=None, chunk=CHUNK):
    return pipeline._run_chunked(lambda c: _stand_in_run(c, masses),
                                 coords, chunk)


def test_graphed_loop_bookkeeping(stand_in):
    wrapper = sct.kernel_wrappers()["panel_inverse"]
    coords = torch.as_tensor(_coords(CHUNK * CHUNKS, 6, 51))
    captures, replays = _graphs()
    launches = wrapper.launches
    replayed = pipeline._run_graphed.replayed_launches.get(
        ("panel_inverse", "launches"), 0)
    got = _stand_in_call(coords)
    assert _graphs() == (captures + 1, replays + CHUNKS - 2)
    # the wrapper counts the eager chunk and the capture, not a replay
    assert wrapper.launches - launches == 2
    assert pipeline._run_graphed.replayed_launches[
        ("panel_inverse", "launches")] - replayed == CHUNKS - 2
    _assert_equal(got, _stand_in_ref(coords))
    masses = torch.linspace(1.0, 2.0, 6)
    for seed in (52, 53):
        coords = torch.as_tensor(_coords(CHUNK * CHUNKS, 6, seed))
        _assert_equal(_stand_in_call(coords, masses),
                      _stand_in_ref(coords, masses))
    # masses in the key: one eager chunk, one capture, then replays
    assert _graphs() == (captures + 2, replays + 3 * CHUNKS - 4)
    assert len(stand_in.live) == 2
    assert list(pipeline._CHUNK_GRAPHS) == [("entry", None)]


def test_outputs_are_copied_out_of_the_graph(stand_in):
    inputs = [torch.as_tensor(_coords(CHUNK * 3, 6, seed))
              for seed in range(4)]
    outs = [_stand_in_call(c) for c in inputs]
    assert _graphs()[1] >= 2
    graph = pipeline._CHUNK_GRAPHS[("entry", None)]
    for coords, got in zip(inputs, outs):
        _assert_equal(got, _stand_in_ref(coords))
        assert all(got[k].data_ptr() != graph.out[k].data_ptr() for k in got)


@pytest.mark.parametrize("params, n, graphable", [
    (sct.invariant_params(13.0), N, True),
    (sct.invariant_params(13.0), 384, True),
    (sct.invariant_params(13.0), PADDED, False),
    (sct.invariant_params(13.0), 300, False),
    (sct.hinsen_params(), 64, True),
])
def test_a_gnm_graphs_only_at_the_factors_size(params, n, graphable):
    assert pipeline._gnm_graphable(params, n) is graphable


def test_a_gnm_of_plain_assembly_is_not_graphed():
    params = types.SimpleNamespace(kind="table_pair", overlays=())
    assert not pipeline._gnm_graphable(params, N)


@pytest.mark.parametrize("batch, chunk, device, dtype, inverse, applies", [
    (12, 4, "cuda", torch.float32, "blocked", True),
    (4, 4, "cuda", torch.float32, "blocked", False),
    (12, None, "cuda", torch.float32, "blocked", False),
    (12, 4, "cpu", torch.float32, "blocked", False),
    (12, 4, "cuda", torch.float64, "blocked", False),
    (12, 4, "cuda", torch.float32, "cho_solve", False),
])
def test_graphs_apply_to_several_blocked_cuda_chunks(batch, chunk, device,
                                                     dtype, inverse,
                                                     applies):
    coords = types.SimpleNamespace(shape=(batch, N, 3), dtype=dtype,
                                   device=torch.device(device, 0))
    assert pipeline._graphs_apply(coords, inverse, chunk) is applies


def test_concurrent_calls_share_the_graph_safely(stand_in):
    """More threads than cores call the graphed loop at once, with a
    short switch interval: each gets its own conformers' answers, though
    all share one graph's static tensors."""
    inputs = [torch.as_tensor(_coords(CHUNK * 3, 6, 70 + i))
              for i in range(16)]
    refs = [_stand_in_ref(c) for c in inputs]
    _stand_in_call(inputs[0])
    results = {}

    def work(i):
        for _ in range(4):
            results[i] = _stand_in_call(inputs[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, ref in enumerate(refs):
        _assert_equal(results[i], ref)


def test_a_failed_capture_leaves_no_graph(stand_in):
    coords = torch.as_tensor(_coords(CHUNK * 3, 6, 61))

    def failing(c, m):
        if stand_in.capturing is not None:
            raise RuntimeError("not capturable")
        return _stand_in_run(c, m)

    with pytest.raises(RuntimeError, match="not capturable"):
        pipeline._run_graphed(failing, coords, None, CHUNK, "entry",
                              sct.invariant_params(13.0), ())
    assert ("entry", None) not in pipeline._CHUNK_GRAPHS


def _key(**changes):
    args = dict(entry="ensemble_anm_fluctuations", shape=(4, 40, 3),
                dtype=torch.float32, device=torch.device("cpu"), stream=None,
                params=sct.invariant_params(13.0), with_masses=False,
                options=(False, True, False, "planes", 4))
    args.update(changes)
    return pipeline._graph_key(**args)[0]


@pytest.mark.parametrize("change", [
    {"entry": "ensemble_gnm_fluctuations"},
    {"shape": (8, 40, 3)},
    {"shape": (4, 44, 3)},
    {"dtype": torch.float64},
    {"device": torch.device("cuda", 0)},
    {"device": torch.device("cuda", 1)},
    {"stream": 94011},
    {"params": sct.invariant_params(12.0)},
    {"params": sct.hinsen_params()},
    {"params": _sdenm(40)},
    {"with_masses": True},
    {"options": (True, True, False, "planes", 4)},
    {"options": (False, False, False, "planes", 4)},
    {"options": (True, True, True, "planes", 4)},
    {"options": (False, True, False, "direct", 4)},
    {"options": (False, True, False, "planes", 8)},
    "tf32",
    "matmul_precision",
    "linalg_library",
])
def test_the_key_names_what_the_graph_bakes_in(monkeypatch, change):
    base = _key()
    assert _key() == base
    if change == "tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        assert _key() != base
    elif change == "matmul_precision":
        torch.set_float32_matmul_precision("high")
        try:
            assert _key() != base
        finally:
            torch.set_float32_matmul_precision("highest")
    elif change == "linalg_library":
        monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library",
                            lambda: "magma")
        assert _key() != base
    else:
        assert _key(**change) != base


def test_the_key_tells_two_tabulated_fields_apart():
    """Two sdENM fields of one size share their scalars; the key tells
    them apart by their device tables, which the graph holds alive."""
    one, two = _sdenm(40), _sdenm(40)
    assert one._scalars() == two._scalars()
    assert _key(params=one) == _key(params=one)
    assert _key(params=two) != _key(params=one)
    _, refs = pipeline._graph_key(
        "e", (4, 40, 3), torch.float32, torch.device("cpu"), None, one,
        False, ())
    assert refs == (one.device_tables("cpu", torch.float32),)
