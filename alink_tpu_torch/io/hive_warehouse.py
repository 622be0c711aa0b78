"""Hive warehouse-layout reader and writer (the serverless half of the
connector).

Counterpart: ``alink_tpu/io/hive_warehouse.py``. The reference connector
(connectors/connector-hive: HiveDB.java, HiveBatchSource.java) reads a
Hive table's warehouse files: partitioned ``k=v`` directory trees of
^A-delimited text, pruned by a ``partitions`` spec (HiveSourceParams:
"/" separates levels, "," alternative specs, e.g.
``ds=20190729/dt=12,ds=20190730``), and writes static partitions
(HiveDB.java:135-178; partition columns appended as STRING). This module
is that file layer: the layout ``<root>/<db>.db/<table>/<k>=<v>/.../
part-*`` with Hive's text SerDe defaults (field delimiter ``\\x01``,
NULL as ``\\N``, backslash escapes). The schema rides a
``.alink.schema`` sidecar written by ``write_table`` or is passed by the
caller. The files are byte for byte the JAX package's. Host only.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Dict, List, Optional, Tuple

from ..common.mtable import MTable
from ..common.types import AlinkTypes, TableSchema

FIELD_DELIM = "\x01"   # Hive LazySimpleSerDe default
NULL_TOKEN = "\\N"
SCHEMA_SIDECAR = ".alink.schema"

# LazySimpleSerDe-style backslash escaping (Hive's ESCAPED BY '\\'):
# without it a ^A, newline, or literal "\N" inside a STRING cell silently
# shifts/splits/nulls fields on read-back.
_ESCAPES = [("\\", "\\\\"), (FIELD_DELIM, "\\" + FIELD_DELIM),
            ("\n", "\\n"), ("\r", "\\r")]


def _escape_cell(s: str) -> str:
    for raw, esc in _ESCAPES:
        s = s.replace(raw, esc)
    return s


def _split_line(line: str) -> List[str]:
    """Split on unescaped FIELD_DELIM. Cells still carry the escape
    placeholders — resolve with ``_finish_cell`` — so NULL detection can
    happen before unescaping (a literal backslash+N cell arrives here as
    placeholder+N and is distinguishable from a genuine ``\\N`` NULL)."""
    line = line.replace("\\\\", "\x00")
    line = line.replace("\\" + FIELD_DELIM, "\x02")
    return line.split(FIELD_DELIM)


def _finish_cell(c: str) -> Optional[str]:
    if c == NULL_TOKEN:
        return None
    return (c.replace("\x02", FIELD_DELIM).replace("\\n", "\n")
            .replace("\\r", "\r").replace("\x00", "\\"))


def parse_partition_spec(spec: str) -> Dict[str, str]:
    """``"ds=20190729/dt=12"`` -> {"ds": "20190729", "dt": "12"}."""
    out: Dict[str, str] = {}
    for level in spec.strip().strip("/").split("/"):
        if not level:
            continue
        if "=" not in level:
            raise ValueError(f"partition level {level!r} is not k=v "
                             f"(spec {spec!r})")
        k, v = level.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def parse_partitions_param(partitions: Optional[str]) -> List[Dict[str, str]]:
    """The source ``partitions`` param: comma-separated alternative specs
    (reference HiveSourceParams.PARTITIONS). Empty/None -> no pruning."""
    if not partitions or not partitions.strip():
        return []
    return [parse_partition_spec(alt) for alt in partitions.split(",")]


def _spec_matches(spec: Dict[str, str],
                  alternatives: List[Dict[str, str]]) -> bool:
    if not alternatives:
        return True
    return any(all(spec.get(k) == v for k, v in alt.items())
               for alt in alternatives)


class HiveWarehouse:
    """A Hive warehouse directory: ``<root>/<db>.db/<table>/...``
    (``default`` database tables live directly under ``<root>``)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def table_dir(self, table: str, db: str = "default") -> str:
        base = self.root if db == "default" else os.path.join(
            self.root, f"{db}.db")
        return os.path.join(base, table)

    def list_tables(self, db: str = "default") -> List[str]:
        base = self.root if db == "default" else os.path.join(
            self.root, f"{db}.db")
        if not os.path.isdir(base):
            return []
        return sorted(d for d in os.listdir(base)
                      if os.path.isdir(os.path.join(base, d))
                      and not d.endswith(".db"))

    # -- read ------------------------------------------------------------
    def _walk_partitions(self, table_dir: str) \
            -> List[Tuple[Dict[str, str], List[str]]]:
        """[(partition_spec, data_files)] — spec {} for unpartitioned."""
        out = []

        def rec(d: str, spec: Dict[str, str]):
            files, subparts = [], []
            for name in sorted(os.listdir(d)):
                p = os.path.join(d, name)
                if os.path.isdir(p) and "=" in name:
                    subparts.append((p, name))
                elif os.path.isfile(p) and not name.startswith((".", "_")):
                    files.append(p)
            if subparts:
                for p, name in subparts:
                    k, v = name.split("=", 1)
                    rec(p, {**spec, k: v})
            if files or not subparts:
                out.append((spec, files))

        rec(table_dir, {})
        return out

    def read_schema(self, table: str, db: str = "default") \
            -> Optional[TableSchema]:
        sidecar = os.path.join(self.table_dir(table, db), SCHEMA_SIDECAR)
        if os.path.isfile(sidecar):
            with open(sidecar, "r", encoding="utf-8") as f:
                return TableSchema.parse(f.read().strip())
        return None

    def read_table(self, table: str, db: str = "default",
                   schema: Optional[TableSchema] = None,
                   partitions: Optional[str] = None) -> MTable:
        """Partition-pruned read; partition columns appended as STRING."""
        tdir = self.table_dir(table, db)
        if not os.path.isdir(tdir):
            raise FileNotFoundError(f"hive table dir not found: {tdir}")
        schema = schema or self.read_schema(table, db)
        if schema is None:
            raise ValueError(
                f"no schema for hive table {db}.{table}: pass schema_str= "
                f"(none found at {os.path.join(tdir, SCHEMA_SIDECAR)})")
        alts = parse_partitions_param(partitions)
        parts = [(spec, files) for spec, files in self._walk_partitions(tdir)
                 if _spec_matches(spec, alts)]
        if alts and not any(files for _, files in parts):
            raise ValueError(f"partitions {partitions!r} matched nothing "
                             f"under {tdir}")
        # partition columns, in first-seen directory order
        pcols: List[str] = []
        for spec, _ in parts:
            for k in spec:
                if k not in pcols:
                    pcols.append(k)
        from .csv import _parse_cell
        rows = []
        for spec, files in parts:
            pvals = tuple(spec.get(k) for k in pcols)
            for path in files:
                with open(path, "r", encoding="utf-8") as f:
                    for line in f:
                        line = line.rstrip("\n")
                        if not line:
                            continue
                        cells = _split_line(line)
                        vals = []
                        for j, t in enumerate(schema.types):
                            raw = cells[j] if j < len(cells) else None
                            s = _finish_cell(raw) if raw is not None else None
                            vals.append(_parse_cell(s, t)
                                        if s is not None else None)
                        rows.append(tuple(vals) + pvals)
        out_schema = TableSchema(
            list(schema.names) + pcols,
            list(schema.types) + [AlinkTypes.STRING] * len(pcols))
        return MTable(rows, out_schema)

    # -- write -----------------------------------------------------------
    def write_table(self, table: str, mt: MTable, db: str = "default",
                    partition: Optional[str] = None,
                    overwrite: bool = False) -> None:
        """Hive-text write; ``partition`` is a static spec ``k=v/k2=v2``
        (reference HiveSinkParams.PARTITION) selecting the target dir."""
        tdir = self.table_dir(table, db)
        spec = parse_partition_spec(partition) if partition else {}
        dest = tdir
        for k, v in spec.items():
            dest = os.path.join(dest, f"{k}={v}")
        if overwrite and os.path.isdir(dest):
            shutil.rmtree(dest)
        os.makedirs(dest, exist_ok=True)
        sidecar = os.path.join(tdir, SCHEMA_SIDECAR)
        schema_line = ", ".join(f"{n} {t}" for n, t in
                                zip(mt.schema.names, mt.schema.types))
        if os.path.isfile(sidecar):
            with open(sidecar, "r", encoding="utf-8") as f:
                existing = f.read().strip()
            if existing.lower() != schema_line.lower():
                raise ValueError(
                    f"schema mismatch writing {db}.{table}: table has "
                    f"[{existing}], input is [{schema_line}]")
        else:
            with open(sidecar, "w", encoding="utf-8") as f:
                f.write(schema_line + "\n")
        seq = len(glob.glob(os.path.join(dest, "part-*")))
        out_path = os.path.join(dest, f"part-{seq:05d}")
        from ..common.vector import VectorUtil
        with open(out_path, "w", encoding="utf-8") as f:
            for row in mt.rows():
                cells = []
                for v, t in zip(row, mt.schema.types):
                    if v is None:
                        cells.append(NULL_TOKEN)
                    elif AlinkTypes.is_vector(t):
                        cells.append(_escape_cell(
                            VectorUtil.to_string(VectorUtil.parse(v))))
                    else:
                        cells.append(_escape_cell(str(v)))
                f.write(FIELD_DELIM.join(cells) + "\n")
