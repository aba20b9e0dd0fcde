"""
PyTorch port, the structure files: the mmCIF reader (``structure/cif.py``),
the BinaryCIF reader (``structure/bcif.py``: MessagePack and the seven
codecs), ``load_structure`` / ``load_ensemble`` dispatching by suffix,
and ``write_pdb`` (``structure/pdb.py``), each held against the JAX
package on the same files, synthesized into ``tmp_path`` as
``tests/test_structure.py`` and ``tests/test_bcif.py`` synthesize them,
and the writers of ``chip_smoke.py``'s large-structure phase.

Tolerances: none.  Both packages parse the same text and bytes with
numpy, so AtomArrays are compared annotation by annotation (dtype and
values) and coordinates bit for bit; ``write_pdb`` files byte for byte.
The port's ``write_pdb`` refuses what PDB's fixed columns cannot hold
(more than 99,999 atoms, residue IDs outside -999..9999, chain IDs of
two characters, atom names past four, residue names past three), where
the JAX package's widens or cuts a field.
"""

import gzip
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.structure import bcif as jbcif  # noqa: E402
from springcraft_tpu.structure import cif as jcif  # noqa: E402
from springcraft_tpu.structure import pdb as jpdb  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.structure import bcif as tbcif  # noqa: E402
from springcraft_tpu_torch.structure import cif as tcif  # noqa: E402
from springcraft_tpu_torch.structure import pdb as tpdb  # noqa: E402

from .test_bcif import (_synthetic_doc, byte_array, column,  # noqa: E402
                        delta, fixed_point, integer_packing, make_bcif,
                        run_length, string_array)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
ANNOTATIONS = ("chain_id", "res_id", "res_name", "atom_name", "element",
               "hetero")


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` as a module (its mmCIF and BinaryCIF writers)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same_atoms(got, ref):
    """Two AtomArrays equal annotation by annotation, coordinates bit for
    bit."""
    assert got.array_length() == ref.array_length()
    assert sorted(got._annot) == sorted(ref._annot)
    assert got.coord.dtype == ref.coord.dtype == np.float32
    assert np.array_equal(got.coord, ref.coord)
    for name in ANNOTATIONS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def _load_both(path, model=None):
    return (sct.load_structure(str(path), model=model),
            sc.structure.load_structure(str(path), model=model))


def _ensemble_both(path):
    (ta, tc), (ja, jc) = (tpdb.load_ensemble(str(path)),
                          jpdb.load_ensemble(str(path)))
    assert_same_atoms(ta, ja)
    assert tc.dtype == jc.dtype and np.array_equal(tc, jc)
    return tc


# ---------------------------------------------------------------------------
# mmCIF text (tests/test_structure.py)
# ---------------------------------------------------------------------------

MMCIF_TWO_MODELS = """data_test
#
loop_
_atom_site.group_PDB
_atom_site.id
_atom_site.type_symbol
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.auth_asym_id
_atom_site.auth_seq_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
_atom_site.pdbx_PDB_model_num
ATOM 1 N N ASN A 1 -8.901 4.127 -0.555 1
ATOM 2 C CA ASN A 1 -8.608 3.135 -1.618 1
ATOM 3 C CA LEU A 2 -4.923 4.002 -2.452 1
HETATM 4 O O HOH A 3 1.000 2.000 3.000 1
ATOM 1 N N ASN A 1 -8.001 4.127 -0.555 2
ATOM 2 C CA ASN A 1 -8.008 3.135 -1.618 2
ATOM 3 C CA LEU A 2 -4.023 4.002 -2.452 2
HETATM 4 O O HOH A 3 1.100 2.000 3.000 2
#
"""

MMCIF_PRIMED_ALTLOC = """data_t
loop_
_atom_site.group_PDB
_atom_site.id
_atom_site.type_symbol
_atom_site.label_atom_id
_atom_site.label_alt_id
_atom_site.label_comp_id
_atom_site.auth_asym_id
_atom_site.auth_seq_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
ATOM 1 C C1' . DA A 1 1.0 2.0 3.0
ATOM 2 C CA B ASN A 2 4.0 0.0 0.0
ATOM 3 C CA A ASN A 2 5.0 0.0 0.0
ATOM 4 N N . ASN A 2 6.0 0.0 0.0
#
"""

MMCIF_ENSEMBLE = """data_t
loop_
_atom_site.group_PDB
_atom_site.id
_atom_site.type_symbol
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.auth_asym_id
_atom_site.auth_seq_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
_atom_site.pdbx_PDB_model_num
ATOM 1 C CA ASN A 1 1.0 0.0 0.0 1
ATOM 2 C CA LEU A 2 2.0 0.0 0.0 1
ATOM 1 C CA ASN A 1 1.5 0.0 0.0 2
ATOM 2 C CA LEU A 2 2.5 0.0 0.0 2
#
"""

MMCIF_MULTILINE = """data_test
_struct.title
;A title that spans
multiple lines, with loop_ and _tag-looking content
;
#
loop_
_atom_site.group_PDB
_atom_site.type_symbol
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.auth_asym_id
_atom_site.auth_seq_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
ATOM N N ASN A 1
 -8.901 4.127 -0.555
ATOM C CA
;ASN
;
 A 1 -8.608 3.135 -1.618
ATOM C CA LEU A 2 -4.923 4.002 -2.452
#
"""

#: Label columns only (no auth_*), quoted values, a comment line: the
#: reader falls back to the label columns.
MMCIF_LABELS_QUOTED = """data_q
loop_
_atom_site.group_PDB
_atom_site.type_symbol
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.label_asym_id
_atom_site.label_seq_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
# a comment inside the loop
ATOM C "C5'" DG B 7 1.5 -2.25 3.125
ATOM O 'O2 X' DG B ? 0.5 0.25 -1.0
HETATM ZN ZN ZN C . 9.0 9.0 9.0
#
"""

MMCIF_TEXTS = {"two_models": MMCIF_TWO_MODELS,
               "primed_altloc": MMCIF_PRIMED_ALTLOC,
               "ensemble": MMCIF_ENSEMBLE, "multiline": MMCIF_MULTILINE,
               "labels_quoted": MMCIF_LABELS_QUOTED}


@pytest.mark.parametrize("suffix", [".cif", ".cif.gz", ".mmcif"])
@pytest.mark.parametrize("text", sorted(MMCIF_TEXTS))
def test_mmcif_reads_as_jax(tmp_path, text, suffix):
    path = tmp_path / f"x{suffix}"
    raw = MMCIF_TEXTS[text].encode()
    path.write_bytes(gzip.compress(raw) if suffix.endswith(".gz") else raw)
    got, ref = _load_both(path)
    assert_same_atoms(got, ref)
    if suffix != ".mmcif":  # load_ensemble takes .cif and .cif.gz
        _ensemble_both(path)
    assert (tcif.CIFFile.read(path).get_model_count()
            == jcif.CIFFile.read(path).get_model_count())


def test_mmcif_reader(tmp_path):
    """``tests/test_structure.py::test_mmcif_reader`` on the port, and
    each model against the JAX package's."""
    path = tmp_path / "test.cif"
    path.write_text(MMCIF_TWO_MODELS)
    cif = sct.structure.CIFFile.read(path)
    assert cif.get_model_count() == 2
    atoms = sct.structure.load_structure_cif(path, model=1)
    assert atoms.array_length() == 4
    assert atoms.res_name[1] == "ASN" and atoms.atom_name[1] == "CA"
    assert atoms.chain_id[0] == "A" and atoms.hetero[3]
    assert np.allclose(atoms.coord[1], [-8.608, 3.135, -1.618], atol=1e-4)
    for model in (1, 2):
        assert_same_atoms(tcif.load_structure_cif(path, model=model),
                          jcif.load_structure_cif(path, model=model))
        assert_same_atoms(cif.get_structure(model=model),
                          jcif.CIFFile.read(path).get_structure(model=model))
    assert sct.load_structure(str(path)).array_length() == 4
    with pytest.raises(IndexError):
        tcif.load_structure_cif(path, model=3)


def test_cif_primed_names_and_altloc(tmp_path):
    path = tmp_path / "t.cif"
    path.write_text(MMCIF_PRIMED_ALTLOC)
    atoms = tcif.load_structure_cif(path)
    assert atoms.array_length() == 3
    assert atoms.atom_name[0] == "C1'"
    assert atoms.coord[1][0] == 4.0  # altloc B (first ID) kept


def test_load_ensemble_cif(tmp_path):
    path = tmp_path / "ens.cif"
    path.write_text(MMCIF_ENSEMBLE)
    coords = _ensemble_both(path)
    assert coords.shape == (2, 2, 3) and coords[1, 0, 0] == 1.5


def test_cif_multiline_and_wrapped_rows(tmp_path):
    path = tmp_path / "multi.cif"
    path.write_text(MMCIF_MULTILINE)
    atoms = tcif.load_structure_cif(path)
    assert list(atoms.res_name) == ["ASN", "ASN", "LEU"]
    assert np.allclose(atoms.coord[1], [-8.608, 3.135, -1.618])


@pytest.mark.parametrize("text, match", [
    ("data_x\n_struct.title\n;never closed\n", "Unterminated"),
    ("data_x\nloop_\n_atom_site.Cartn_x\n_atom_site.Cartn_y\n1.0\n",
     "Incomplete"),
    ("data_x\nloop_\n_atom_site.Cartn_x\n1.0 2.0\n", "values for"),
])
def test_cif_malformed_errors(tmp_path, text, match):
    path = tmp_path / "bad.cif"
    path.write_text(text)
    for module in (tcif, jcif):
        with pytest.raises(ValueError, match=match):
            module.CIFFile.read(path)


@pytest.mark.parametrize("text", [
    "data_x\nloop_\n_atom_site.label_atom_id\n_atom_site.Cartn_x\nCA 1.0\n",
    "data_x\nloop_\n_cell.length_a\n1.0\n",
])
def test_cif_missing_columns_errors(tmp_path, text):
    path = tmp_path / "bad.cif"
    path.write_text(text)
    for module in (tcif, jcif):
        with pytest.raises((ValueError, IndexError)):
            module.load_structure_cif(path)


@pytest.mark.parametrize("line", [
    "ATOM 1 C CA ALA A 1 1.0 2.0 3.0",
    "ATOM 1 C C1' DA A 1 1.0 2.0 3.0",
    "ATOM 1 C 'C1 X' DA A 1 1.0 2.0 3.0",
    'ATOM 1 C "O5\'" DA "B C" 1 1.0 2.0 3.0',
    "ATOM 1 C it's ALA A 1 'a'b' 2.0 3.0",
    "  lead   and   trail  ",
])
def test_tokenize_matches_jax(line):
    assert tcif._tokenize(line) == jcif._tokenize(line)


@pytest.mark.parametrize("name", ["nonexistent.bcif", "nonexistent.cif",
                                  "nonexistent.bcif.gz"])
def test_cif_suffixes_dispatch_to_the_readers(name):
    """``.bcif`` and ``.cif`` go to their readers, not the PDB parser
    (``tests/test_structure.py::test_bcif_dispatches_to_binary_reader``)."""
    with pytest.raises(FileNotFoundError):
        sct.load_structure(name)
    with pytest.raises(FileNotFoundError):
        tpdb.load_ensemble(name)


# ---------------------------------------------------------------------------
# BinaryCIF (tests/test_bcif.py)
# ---------------------------------------------------------------------------

def _codec_cases():
    rng = np.random.RandomState(0)
    floats = rng.randn(40) * 123.0
    ints = np.cumsum(rng.randint(0, 3, 50)) + 7
    res_id = np.repeat(np.arange(1, 21), 4)
    diffs = np.diff(res_id, prepend=int(res_id[0]))
    diffs[0] = 0
    data, enc = run_length(diffs)
    return {
        "fixed_point": fixed_point(floats, factor=1000),
        "delta": delta(ints, "i1"),
        "run_length": run_length(np.repeat([4, 9, 4], [5, 2, 7])),
        "integer_packing": integer_packing(
            np.asarray([0, 127, 128, -129, 300, -5, 1000]), byte_count=1),
        "integer_packing_2": integer_packing(
            np.asarray([0, 32767, -40000, 70000, 5]), byte_count=2),
        "unsigned_packing": (np.asarray([255, 44, 255, 255, 3, 7], np.uint8)
                             .tobytes(),
                             [{"kind": "IntegerPacking", "byteCount": 1,
                               "isUnsigned": True, "srcSize": 3},
                              {"kind": "ByteArray", "type": 4}]),
        "string_array": string_array(["CA", "CB", "CA", "N", ""]),
        "delta_run_length": (data, [{"kind": "Delta",
                                     "origin": int(res_id[0]),
                                     "srcType": 3}] + enc),
        "interval_quantization": (
            np.asarray([0, 3, 7, 10], "<i4").tobytes(),
            [{"kind": "IntervalQuantization", "min": -2.0, "max": 8.0,
              "numSteps": 11, "srcType": 33},
             {"kind": "ByteArray", "type": 3}]),
        "float32": byte_array(rng.randn(9), "f4"),
        "float64": byte_array(rng.randn(9), "f8"),
        "uint16": byte_array([0, 65535, 7], "u2"),
        "int16": byte_array([-32768, 32767, 0], "i2"),
        "uint32": byte_array([0, 2**32 - 1], "u4"),
    }


@pytest.mark.parametrize("case", sorted(_codec_cases()))
def test_decode_data_matches_jax(case):
    data, encodings = _codec_cases()[case]
    got = tbcif._decode_data(data, encodings)
    ref = jbcif._decode_data(data, encodings)
    assert np.asarray(got).dtype == np.asarray(ref).dtype
    assert np.array_equal(got, ref)


def test_codec_round_trips():
    """``tests/test_bcif.py::test_codec_round_trips`` through the port's
    ``_decode_data``."""
    cases = _codec_cases()
    rng = np.random.RandomState(0)
    floats = rng.randn(40) * 123.0
    ints = np.cumsum(rng.randint(0, 3, 50)) + 7
    assert np.allclose(tbcif._decode_data(*cases["fixed_point"]),
                       np.round(floats * 1000) / 1000)
    assert np.array_equal(tbcif._decode_data(*cases["delta"]), ints)
    assert np.array_equal(tbcif._decode_data(*cases["run_length"]),
                          np.repeat([4, 9, 4], [5, 2, 7]))
    assert np.array_equal(tbcif._decode_data(*cases["integer_packing"]),
                          [0, 127, 128, -129, 300, -5, 1000])
    assert np.array_equal(tbcif._decode_data(*cases["unsigned_packing"]),
                          [299, 513, 7])
    assert list(tbcif._decode_data(*cases["string_array"])) == [
        "CA", "CB", "CA", "N", ""]
    assert np.array_equal(tbcif._decode_data(*cases["delta_run_length"]),
                          np.repeat(np.arange(1, 21), 4))
    assert np.allclose(tbcif._decode_data(*cases["interval_quantization"]),
                       [-2.0, 1.0, 5.0, 8.0])


@pytest.mark.parametrize("enc, match", [
    ([{"kind": "Bogus"}], "Unknown BinaryCIF encoding"),
    ([{"kind": "ByteArray", "type": 99}], "Unknown ByteArray type"),
    ([{"kind": "IntegerPacking", "byteCount": 1, "isUnsigned": False,
       "srcSize": 5}, {"kind": "ByteArray", "type": 1}], "IntegerPacking"),
])
def test_decode_data_errors(enc, match):
    for module in (tbcif, jbcif):
        with pytest.raises(ValueError, match=match):
            module._decode_data(b"\x01\x02", enc)


@pytest.mark.parametrize("obj", [
    {"a": [1, -3, 2**40, -2**40, 1.5, True, False, None, "x", b"\x00\x01"]},
    list(range(20)), "é" * 40, -32, 127, -(2**63),
])
def test_msgpack_pack_and_unpack_match_jax(obj):
    packed = tbcif._pack(obj)
    assert packed == jbcif._pack(obj)
    assert tbcif._unpack(packed)[0] == jbcif._unpack(packed)[0] == obj


@pytest.mark.parametrize("raw", [
    b"\xcc\xff", b"\xcd\x01\x00", b"\xce\x00\x01\x00\x00",
    b"\xd0\x80", b"\xd1\x80\x00", b"\xd2\xff\xff\xff\xfe",
    b"\xca\x3f\xc0\x00\x00", b"\xcb\x3f\xf8\x00\x00\x00\x00\x00\x00",
    b"\xa3abc", b"\xd9\x02hi", b"\xc4\x02\x00\x01", b"\xc5\x00\x01\x07",
    b"\x92\x01\xc0", b"\xdc\x00\x01\xc3", b"\x81\xa1k\x05",
    b"\xde\x00\x01\xa1k\xc2", b"\xf0",
])
def test_msgpack_unpack_forms_match_jax(raw):
    """Every MessagePack form the reader decodes (the encoder writes
    only the widest ones)."""
    assert tbcif._unpack(raw) == jbcif._unpack(raw)


def test_msgpack_unsupported_byte_errors():
    for module in (tbcif, jbcif):
        with pytest.raises(ValueError, match="MessagePack"):
            module._unpack(b"\xc1")
    with pytest.raises(TypeError):
        tbcif._pack(object())


@pytest.mark.parametrize("suffix", [".bcif", ".bcif.gz"])
@pytest.mark.parametrize("model", [None, 1, 2])
def test_load_structure_bcif_matches_jax(tmp_path, suffix, model):
    doc, coords, res_id, names = _synthetic_doc()
    path = tmp_path / f"test{suffix}"
    path.write_bytes(gzip.compress(doc) if suffix.endswith(".gz") else doc)
    got, ref = _load_both(path, model=model)
    assert_same_atoms(got, ref)
    first = 0 if model in (None, 1) else 8
    assert np.allclose(got.coord, np.round(coords[first:first + 8] * 1000)
                       / 1000, atol=1e-6)
    assert list(got.res_id) == list(res_id[:8])
    assert list(got.res_name) == names[first:first + 8]


def test_load_ensemble_bcif(tmp_path):
    doc, coords, _, _ = _synthetic_doc(n_res=6, n_models=3)
    path = tmp_path / "multi.bcif"
    path.write_bytes(doc)
    batch = _ensemble_both(path)
    assert batch.shape == (3, 6, 3)
    assert np.allclose(batch.reshape(-1, 3), np.round(coords * 1000) / 1000,
                       atol=1e-4)


def test_bcif_matches_text_cif_loader(tmp_path):
    """``tests/test_bcif.py::test_bcif_matches_text_cif_loader``: the same
    structure through the port's .bcif and .cif paths loads identically,
    and as the JAX package loads it."""
    doc, coords, res_id, names = _synthetic_doc(n_res=8, n_models=1)
    (tmp_path / "x.bcif").write_bytes(doc)
    lines = ["data_TEST", "loop_"] + [f"_atom_site.{c}" for c in (
        "group_PDB", "type_symbol", "label_atom_id", "label_comp_id",
        "label_asym_id", "label_seq_id", "label_alt_id", "Cartn_x",
        "Cartn_y", "Cartn_z", "pdbx_PDB_model_num")]
    q = np.round(coords * 1000) / 1000
    for i in range(8):
        lines.append(f"ATOM C CA {names[i]} A {res_id[i]} . {q[i, 0]:.3f} "
                     f"{q[i, 1]:.3f} {q[i, 2]:.3f} 1")
    (tmp_path / "x.cif").write_text("\n".join(lines) + "\n")
    a, ja = _load_both(tmp_path / "x.bcif")
    b, jb = _load_both(tmp_path / "x.cif")
    assert_same_atoms(a, ja)
    assert_same_atoms(b, jb)
    assert np.allclose(a.coord, b.coord, atol=1e-5)
    for name in ("chain_id", "res_id", "res_name", "atom_name", "element"):
        assert list(getattr(a, name)) == list(getattr(b, name))


@pytest.mark.parametrize("mask", [[0] * 4, [1, 2, 0, 1], [2] * 4])
def test_bcif_mask_semantics_match_jax(tmp_path, mask):
    """``.``/``?`` masks: a masked altloc or residue number reads as the
    text reader reads ``.`` and ``?``."""
    n = 4
    cols = [
        column("label_atom_id", string_array(["CA"] * n)),
        column("label_comp_id", string_array(["ALA", "GLY", "SER", "LYS"])),
        column("label_seq_id", delta([1, 2, 3, 4], "i1"), mask=mask),
        column("label_alt_id", string_array(["A", "B", "A", "A"]),
               mask=mask),
        column("Cartn_x", fixed_point([1.0, 2.0, 3.0, 4.0])),
        column("Cartn_y", fixed_point([0.0] * n)),
        column("Cartn_z", fixed_point([0.0] * n)),
    ]
    path = tmp_path / "mask.bcif"
    path.write_bytes(make_bcif(cols, n))
    got, ref = _load_both(path)
    assert_same_atoms(got, ref)
    t_cols = tbcif.read_bcif_as_cif(str(path))._cols
    j_cols = jbcif.read_bcif_as_cif(str(path))._cols
    for a, b in zip(t_cols, j_cols):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bcif_without_atom_site_errors(tmp_path):
    doc = tbcif._pack({"version": "0.3.0", "encoder": "t", "dataBlocks": [
        {"header": "X", "categories": [
            {"name": "_cell", "rowCount": 1, "columns": []}]}]})
    path = tmp_path / "bad.bcif"
    path.write_bytes(doc)
    with pytest.raises(ValueError, match="atom_site"):
        tbcif.read_bcif_as_cif(str(path))


def test_bcif_row_count_mismatch_errors(tmp_path):
    path = tmp_path / "short.bcif"
    path.write_bytes(make_bcif([column("Cartn_x", fixed_point([1.0]))], 2))
    for module in (tbcif, jbcif):
        with pytest.raises(ValueError, match="rows"):
            module.read_bcif_as_cif(str(path))


# ---------------------------------------------------------------------------
# Structures PDB cannot hold, through chip_smoke.py's writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["cif", "cif.gz", "bcif", "bcif.gz"])
@pytest.mark.parametrize("models", [1, 3])
def test_large_structure_writers_read_back(chip_smoke, tmp_path, fmt,
                                           models):
    """``chip_smoke.large_structure`` at a small size — residue IDs past
    9,999, a two-character chain — through its mmCIF and BinaryCIF
    writers: both packages read the written annotations and coordinates
    (bit for bit against each other, within a float32 rounding of the
    written values), every model."""
    atoms, drawn, written = chip_smoke.large_structure(
        20_010, chains=("A", "AA"))
    assert atoms.res_id.max() == 10_005
    rng = np.random.RandomState(5)
    # model 1 as drawn, the others shifted
    shifts = np.round(rng.randn(models, 1, 3), 3)
    shifts[0] = 0.0
    traj = written[None] + shifts
    path = tmp_path / f"large.{fmt}"
    writer = (chip_smoke.write_bcif if fmt.startswith("bcif")
              else chip_smoke.write_mmcif)
    writer(path, atoms, coord_models=traj)
    got, ref = _load_both(path)
    assert_same_atoms(got, ref)
    for name in ("chain_id", "res_id", "res_name", "atom_name", "element"):
        assert np.array_equal(getattr(got, name), getattr(atoms, name))
    spacing = np.spacing(np.float32(np.abs(traj).max()))
    assert np.abs(got.coord - traj[0]).max() <= spacing / 2
    assert np.abs(written - drawn).max() <= 5e-4 + 1e-12
    coords = _ensemble_both(path)
    assert coords.shape == (models, 20_010, 3)
    assert np.abs(coords - traj).max() <= spacing / 2


def test_large_structure_formats_agree(chip_smoke, tmp_path):
    atoms, _, _ = chip_smoke.large_structure(4_000)
    chip_smoke.write_mmcif(tmp_path / "x.cif.gz", atoms)
    chip_smoke.write_bcif(tmp_path / "x.bcif", atoms)
    a = sct.load_structure(str(tmp_path / "x.cif.gz"))
    b = sct.load_structure(str(tmp_path / "x.bcif"))
    assert_same_atoms(a, b)
    assert list(np.unique(a.chain_id)) == ["A", "AA", "B", "C"]


# ---------------------------------------------------------------------------
# write_pdb
# ---------------------------------------------------------------------------

def _ca_1l2y(load):
    atoms = load(os.path.join(DATA, "1l2y.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


@pytest.fixture(scope="module")
def both_1l2y():
    return (sct.load_structure(os.path.join(DATA, "1l2y.pdb"), model=1),
            sc.structure.load_structure(os.path.join(DATA, "1l2y.pdb"),
                                        model=1))


@pytest.mark.parametrize("which", ["all_atoms", "ca", "ca_trajectory",
                                   "hetero"])
def test_write_pdb_bytes_match_jax(tmp_path, both_1l2y, which):
    """Byte for byte the JAX package's file: 1l2y (all 304 atoms and the
    CA trace), a 5-model trajectory, HETATM records."""
    tatoms, jatoms = both_1l2y
    if which != "all_atoms":
        tatoms = tatoms[(tatoms.atom_name == "CA")
                        & (tatoms.element == "C")]
        jatoms = jatoms[(jatoms.atom_name == "CA")
                        & (jatoms.element == "C")]
    models = None
    if which == "ca_trajectory":
        rng = np.random.RandomState(0)
        models = tatoms.coord[None] + 0.2 * rng.randn(
            5, tatoms.array_length(), 3).astype(np.float32)
    if which == "hetero":
        tatoms, jatoms = tatoms.copy(), jatoms.copy()
        for atoms in (tatoms, jatoms):
            atoms.hetero[::3] = True
    tpdb.write_pdb(tmp_path / "t.pdb", tatoms, coord_models=models)
    jpdb.write_pdb(tmp_path / "j.pdb", jatoms, coord_models=models)
    assert (tmp_path / "t.pdb").read_bytes() == \
        (tmp_path / "j.pdb").read_bytes()
    if models is not None:
        coords = _ensemble_both(tmp_path / "t.pdb")
        assert np.allclose(coords, models, atol=1e-3)


def test_write_pdb_roundtrip(tmp_path, both_1l2y):
    ca = _ca_1l2y(sct.load_structure)
    path = tmp_path / "out.pdb"
    sct.structure.write_pdb(path, ca)
    back = sct.load_structure(path)
    assert back.array_length() == ca.array_length()
    assert np.allclose(back.coord, ca.coord, atol=1e-3)
    assert np.all(back.res_name == ca.res_name)
    assert np.all(back.chain_id == ca.chain_id)


def _edge(tmp_path, field, value, n=3):
    atoms = sct.structure.AtomArray(n)
    atoms.coord = np.zeros((n, 3), np.float32)
    atoms.chain_id = np.full(n, "A")
    atoms.res_id = np.arange(1, n + 1)
    atoms.res_name = np.full(n, "GLY")
    atoms.atom_name = np.full(n, "CA")
    atoms.element = np.full(n, "C")
    if field is not None:
        values = getattr(atoms, field).copy()
        if values.dtype.kind == "U":
            values = values.astype(object)
        values[-1] = value
        setattr(atoms, field, np.array(list(values)))
    return atoms


@pytest.mark.parametrize("field, value", [
    ("res_id", 9999), ("res_id", -999), ("chain_id", "Z"),
    ("chain_id", ""), ("atom_name", "OXT1"), ("atom_name", "N"),
    ("res_name", "HOH"), ("res_name", "A"),
])
def test_write_pdb_edge_values_match_jax(tmp_path, field, value):
    """At PDB's limits the port writes the JAX package's bytes."""
    atoms = _edge(tmp_path, field, value)
    jatoms = sc.structure.AtomArray(3)
    jatoms.coord = atoms.coord
    for name in ("chain_id", "res_id", "res_name", "atom_name", "element"):
        setattr(jatoms, name, getattr(atoms, name))
    tpdb.write_pdb(tmp_path / "t.pdb", atoms)
    jpdb.write_pdb(tmp_path / "j.pdb", jatoms)
    assert (tmp_path / "t.pdb").read_bytes() == \
        (tmp_path / "j.pdb").read_bytes()


@pytest.mark.parametrize("field, value, match", [
    ("res_id", 10_000, "residue IDs"), ("res_id", -1000, "residue IDs"),
    ("chain_id", "AA", "chain IDs"), ("atom_name", "CA123", "atom names"),
    ("res_name", "GLYX", "residue names"),
])
def test_write_pdb_refuses_what_pdb_cannot_hold(tmp_path, field, value,
                                                match):
    atoms = _edge(tmp_path, field, value)
    with pytest.raises(ValueError, match=match):
        tpdb.write_pdb(tmp_path / "x.pdb", atoms)
    assert not (tmp_path / "x.pdb").exists()


def test_write_pdb_refuses_more_than_99999_atoms(tmp_path):
    atoms = _edge(tmp_path, None, None, n=100_000)
    atoms.res_id = np.arange(100_000) % 9999 + 1
    with pytest.raises(ValueError, match="99,999"):
        tpdb.write_pdb(tmp_path / "x.pdb", atoms)
    assert not (tmp_path / "x.pdb").exists()


def test_write_pdb_rejects_out_of_range_coords(tmp_path):
    ca = _ca_1l2y(sct.load_structure)
    ca.coord = ca.coord + np.float32(20000.0)
    with pytest.raises(ValueError, match="fixed-column"):
        tpdb.write_pdb(tmp_path / "big.pdb", ca)
