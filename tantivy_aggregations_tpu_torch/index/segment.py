"""Immutable segments and their on-disk column format.

TPU-native analog of tantivy's segment + fast-field storage (SURVEY.md §2.2
T2/T4/T5/T8/T10). A segment is a struct-of-arrays:

- numeric single-valued field: `values` [max_doc] in the user dtype
  (u64/i64/f64; date stored as u64 micros); a missing value is the type's
  default (0 / 0 / 0.0) per SURVEY.md §A.3.
- numeric multi-valued field: CSR — `offsets` u64? no: u32 [max_doc+1] +
  flat `values`.
- keyword field (single or multi): always CSR over a segment-local sorted
  term table; `values` are u32 local ordinals (lexicographic order), a doc
  with no value simply has an empty CSR row.
- `alive`: bool [max_doc] delete bitset (None == all alive).

On disk each segment is a directory of raw little-endian arrays plus a JSON
meta file — deliberately trivial so the single-core C++ baseline
(baseline_cpp/) can mmap the same files. Persistence is the engine's
"checkpoint/resume" story (SURVEY.md §5): commits write segments; reopening
an index resumes from them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..schema import Cardinality, FieldType, Schema

_NUMERIC_DTYPE = {
    FieldType.U64: np.uint64,
    FieldType.I64: np.int64,
    FieldType.F64: np.float64,
    FieldType.DATE: np.uint64,
}


@dataclass
class SegmentFieldData:
    """Columnar data for one field in one segment."""

    values: np.ndarray  # numeric user dtype, or u32 local ords for keyword
    offsets: Optional[np.ndarray] = None  # u32 [max_doc+1] CSR (multi/keyword)
    terms: Optional[List[str]] = None  # sorted segment-local term table


@dataclass
class Segment:
    id: str
    max_doc: int
    fields: Dict[str, SegmentFieldData]
    alive: Optional[np.ndarray] = None  # bool [max_doc]; None = all alive

    @property
    def num_alive(self) -> int:
        if self.alive is None:
            return self.max_doc
        return int(self.alive.sum())

    def alive_mask(self) -> np.ndarray:
        if self.alive is None:
            return np.ones(self.max_doc, dtype=bool)
        return self.alive


def numeric_dtype(ftype: FieldType):
    return _NUMERIC_DTYPE[ftype]


# ---------------------------------------------------------------------------
# Disk IO
# ---------------------------------------------------------------------------

def write_segment(seg: Segment, schema: Schema, dirpath: str) -> None:
    os.makedirs(dirpath, exist_ok=True)
    meta = {"id": seg.id, "max_doc": seg.max_doc, "fields": {}}
    for name, fd in seg.fields.items():
        entry = schema.field(name)
        finfo = {"type": entry.type.value,
                 "cardinality": entry.cardinality.value,
                 "num_values": int(fd.values.shape[0])}
        fd.values.tofile(os.path.join(dirpath, f"{name}.values.bin"))
        if fd.offsets is not None:
            finfo["csr"] = True
            fd.offsets.astype(np.uint32).tofile(
                os.path.join(dirpath, f"{name}.offsets.bin"))
        if fd.terms is not None:
            finfo["num_terms"] = len(fd.terms)
            terms = fd.terms
            if entry.type == FieldType.BYTES:
                # bytes terms round-trip through JSON via latin-1 (a
                # bijection between bytes 0..255 and U+0000..U+00FF)
                finfo["bytes_terms"] = True
                terms = [t.decode("latin-1") for t in terms]
            with open(os.path.join(dirpath, f"{name}.terms.json"), "w") as f:
                json.dump(terms, f, ensure_ascii=False)
        meta["fields"][name] = finfo
    if seg.alive is not None:
        seg.alive.astype(np.uint8).tofile(os.path.join(dirpath, "alive.bin"))
        meta["has_deletes"] = True
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)


def read_segment(dirpath: str, schema: Schema) -> Segment:
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    max_doc = int(meta["max_doc"])
    fields: Dict[str, SegmentFieldData] = {}
    for name, finfo in meta["fields"].items():
        entry = schema.field(name)
        if entry.type.is_stringy:
            values = np.fromfile(os.path.join(dirpath, f"{name}.values.bin"),
                                 dtype=np.uint32)
            offsets = np.fromfile(os.path.join(dirpath, f"{name}.offsets.bin"),
                                  dtype=np.uint32)
            with open(os.path.join(dirpath, f"{name}.terms.json")) as f:
                terms = json.load(f)
            if finfo.get("bytes_terms"):
                terms = [t.encode("latin-1") for t in terms]
            fields[name] = SegmentFieldData(values, offsets, terms)
        else:
            dtype = numeric_dtype(entry.type)
            values = np.fromfile(os.path.join(dirpath, f"{name}.values.bin"),
                                 dtype=dtype)
            offsets = None
            if finfo.get("csr"):
                offsets = np.fromfile(
                    os.path.join(dirpath, f"{name}.offsets.bin"),
                    dtype=np.uint32)
            fields[name] = SegmentFieldData(values, offsets, None)
    alive = None
    alive_path = os.path.join(dirpath, "alive.bin")
    if meta.get("has_deletes") and os.path.exists(alive_path):
        alive = np.fromfile(alive_path, dtype=np.uint8).astype(bool)
    return Segment(meta["id"], max_doc, fields, alive)
