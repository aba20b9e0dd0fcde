"""
BinaryCIF (.bcif) reader.

BinaryCIF is the PDB's compact binary serialization of mmCIF: a
MessagePack document whose category columns are byte arrays wrapped in
a chain of integer codecs (Delta, RunLength, IntegerPacking,
FixedPoint, StringArray, ...).  The reference delegates structure I/O
to biotite (which reads ``.bcif`` via its own codec layer); here the
format is decoded with a self-contained MessagePack parser plus the
BinaryCIF codec chain — no third-party dependency — and the decoded
``atom_site`` category is adapted onto :class:`~.cif.CIFFile`, so model
selection, altloc handling and AtomArray construction are shared with
the text mmCIF path.

This is the port's own copy of ``springcraft_tpu/structure/bcif.py``
(importing that package would import ``jax``).

Spec: https://github.com/molstar/BinaryCIF (v0.3).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from .cif import CIFFile

__all__ = ["read_bcif_as_cif", "load_structure_bcif"]


# ---------------------------------------------------------------------------
# MessagePack (decode + a minimal encoder for fixture tooling/tests)
# ---------------------------------------------------------------------------

def _unpack(buf, pos=0):
    """Decode one MessagePack object; returns (object, next_pos)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7F:                                     # positive fixint
        return b, pos
    if b >= 0xE0:                                     # negative fixint
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        ln = b & 0x1F
        return bytes(buf[pos:pos + ln]).decode("utf-8"), pos + ln
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in (0xC4, 0xC5, 0xC6):                       # bin 8/16/32
        size = {0xC4: 1, 0xC5: 2, 0xC6: 4}[b]
        ln = int.from_bytes(buf[pos:pos + size], "big")
        pos += size
        return bytes(buf[pos:pos + ln]), pos + ln
    if b == 0xCA:
        return struct.unpack_from(">f", buf, pos)[0], pos + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if b in (0xCC, 0xCD, 0xCE, 0xCF):                 # uint 8/16/32/64
        size = 1 << (b - 0xCC)
        return int.from_bytes(buf[pos:pos + size], "big"), pos + size
    if b in (0xD0, 0xD1, 0xD2, 0xD3):                 # int 8/16/32/64
        size = 1 << (b - 0xD0)
        return int.from_bytes(buf[pos:pos + size], "big",
                              signed=True), pos + size
    if b in (0xD9, 0xDA, 0xDB):                       # str 8/16/32
        size = {0xD9: 1, 0xDA: 2, 0xDB: 4}[b]
        ln = int.from_bytes(buf[pos:pos + size], "big")
        pos += size
        return bytes(buf[pos:pos + ln]).decode("utf-8"), pos + ln
    if b in (0xDC, 0xDD):                             # array 16/32
        size = 2 if b == 0xDC else 4
        ln = int.from_bytes(buf[pos:pos + size], "big")
        return _unpack_array(buf, pos + size, ln)
    if b in (0xDE, 0xDF):                             # map 16/32
        size = 2 if b == 0xDE else 4
        ln = int.from_bytes(buf[pos:pos + size], "big")
        return _unpack_map(buf, pos + size, ln)
    raise ValueError(f"Unsupported MessagePack type byte 0x{b:02x}")


def _unpack_array(buf, pos, ln):
    out = []
    for _ in range(ln):
        item, pos = _unpack(buf, pos)
        out.append(item)
    return out, pos


def _unpack_map(buf, pos, ln):
    out = {}
    for _ in range(ln):
        key, pos = _unpack(buf, pos)
        val, pos = _unpack(buf, pos)
        out[key] = val
    return out, pos


def _pack(obj, out=None):
    """Minimal MessagePack encoder (dict/list/str/bytes/int/float/bool/
    None) — enough to author BinaryCIF fixtures; the reader above is the
    production path."""
    if out is None:
        out = bytearray()
        _pack(obj, out)
        return bytes(out)
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj >= 0:
            out.append(0xCF)
            out += obj.to_bytes(8, "big")
        else:
            out.append(0xD3)
            out += obj.to_bytes(8, "big", signed=True)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(0xDB)
        out += len(raw).to_bytes(4, "big")
        out += raw
    elif isinstance(obj, (bytes, bytearray, np.void)):
        raw = bytes(obj)
        out.append(0xC6)
        out += len(raw).to_bytes(4, "big")
        out += raw
    elif isinstance(obj, (list, tuple)):
        out.append(0xDD)
        out += len(obj).to_bytes(4, "big")
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(0xDF)
        out += len(obj).to_bytes(4, "big")
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    else:
        raise TypeError(f"Cannot pack {type(obj).__name__}")
    return out


# ---------------------------------------------------------------------------
# BinaryCIF codec chain
# ---------------------------------------------------------------------------

_BYTE_ARRAY_TYPES = {
    1: np.int8, 2: np.int16, 3: np.int32,
    4: np.uint8, 5: np.uint16, 6: np.uint32,
    32: np.float32, 33: np.float64,
}


def _decode_data(data, encodings):
    """Apply the encoding chain in reverse (decode order)."""
    for enc in reversed(encodings):
        kind = enc["kind"]
        if kind == "ByteArray":
            dtype = _BYTE_ARRAY_TYPES.get(enc["type"])
            if dtype is None:
                raise ValueError(f"Unknown ByteArray type {enc['type']}")
            data = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder(
                "<")).astype(dtype)
        elif kind == "FixedPoint":
            data = np.asarray(data, dtype=np.float64) / enc["factor"]
        elif kind == "IntervalQuantization":
            lo, hi = enc["min"], enc["max"]
            steps = enc["numSteps"]
            delta = (hi - lo) / (steps - 1) if steps > 1 else 0.0
            data = lo + np.asarray(data, dtype=np.float64) * delta
        elif kind == "RunLength":
            arr = np.asarray(data)
            values = arr[0::2]
            counts = arr[1::2]
            data = np.repeat(values, counts).astype(np.int64)
        elif kind == "Delta":
            data = np.cumsum(np.asarray(data, dtype=np.int64))
            data += enc.get("origin", 0)
        elif kind == "IntegerPacking":
            data = _decode_integer_packing(np.asarray(data), enc)
        elif kind == "StringArray":
            indices = _decode_data(data, enc["dataEncoding"])
            offsets = _decode_data(enc["offsets"],
                                   enc["offsetEncoding"])
            sdata = enc["stringData"]
            strings = [
                sdata[int(offsets[i]):int(offsets[i + 1])]
                for i in range(len(offsets) - 1)
            ]
            data = np.asarray(
                ["" if i < 0 else strings[int(i)] for i in indices],
                dtype=object,
            )
        else:
            raise ValueError(f"Unknown BinaryCIF encoding kind {kind!r}")
    return data


def _decode_integer_packing(packed, enc):
    """Unpack upper-limit packed integers: runs of +/- limit accumulate
    into the next non-limit value."""
    byte_count = enc["byteCount"]
    if enc.get("isUnsigned"):
        upper = (1 << (8 * byte_count)) - 1
        lower = None
    else:
        upper = (1 << (8 * byte_count - 1)) - 1
        lower = -(1 << (8 * byte_count - 1))
    out = np.empty(enc["srcSize"], dtype=np.int64)
    i = 0
    acc = 0
    for v in packed.astype(np.int64):
        acc += v
        if v == upper or (lower is not None and v == lower):
            continue
        out[i] = acc
        acc = 0
        i += 1
    if i != enc["srcSize"]:
        raise ValueError(
            f"IntegerPacking produced {i} values, expected "
            f"{enc['srcSize']}")
    return out


def _column_values(column, row_count):
    """Decode one column to a NumPy array, keeping numeric columns
    numeric (vectorized — no per-cell Python loops).  Mask semantics
    ('.' = not specified, '?' = unknown) force a string representation
    only where a mask is actually present."""
    values = np.asarray(_decode_data(column["data"]["data"],
                                     column["data"]["encoding"]))
    if len(values) != row_count:
        raise ValueError(
            f"Column {column.get('name')!r} has {len(values)} rows, "
            f"expected {row_count}")
    mask_obj = column.get("mask")
    if mask_obj:
        mask = np.asarray(
            _decode_data(mask_obj["data"], mask_obj["encoding"]))
        if (mask != 0).any():
            values = values.astype(str).astype(object)
            values[mask == 1] = "."
            values[mask == 2] = "?"
    return values


def read_bcif_as_cif(path):
    """Parse a BinaryCIF file and return its ``atom_site`` category as a
    :class:`~.cif.CIFFile` (shared model/altloc/AtomArray logic)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        buf = f.read()
    doc, _ = _unpack(memoryview(buf))
    blocks = doc.get("dataBlocks") or []
    for block in blocks:
        for category in block.get("categories", []):
            if category.get("name", "").lower() != "_atom_site":
                continue
            row_count = category["rowCount"]
            columns = []
            cols = []
            for column in category.get("columns", []):
                columns.append(column["name"])
                cols.append(_column_values(column, row_count))
            return CIFFile.from_columns(columns, cols)
    raise ValueError("No atom_site category found in BinaryCIF file")


def load_structure_bcif(path, model=None):
    from .cif import get_structure_cif

    return get_structure_cif(read_bcif_as_cif(path), model=model)
