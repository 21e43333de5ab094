"""Streaming graph converters: SNAP / Matrix Market / METIS -> Vite (port
of ``cuvite_tpu/workloads/convert.py``, numpy only).

The reference application clusters real graphs that external converters
write in its binary format.  Each reader here streams edges in bounded
chunks, and one pipeline turns any edge-chunk stream into a Vite CSR
file with memory O(num_vertices + chunk), never O(num_edges):

  pass 0  spool the raw (src, dst, w) chunks to a temporary binary file,
          tracking the id range (and the distinct ids when relabeling);
  pass 1  re-read the spool and count each vertex's degree -> offsets;
  pass 2  re-read the spool and scatter each record to its place in the
          file through per-vertex cursors (``io/vite.ViteStreamWriter``);
  pass 3  canonicalize: sort each row's records by tail id, so that one
          logical graph always gives the same bytes whatever the input's
          edge order or chunking (the tests pin the bytes against the
          reference's converter).

Formats
-------
* SNAP edge list (``.txt`` / ``.txt.gz``): ``u v [w]`` a line, ``#``
  comments; each undirected edge listed once -> symmetrized on write.
* Matrix Market (``.mtx``): ``coordinate`` ``pattern|real|integer``;
  ``symmetric`` entries are symmetrized, ``general`` is taken as a
  directed adjacency that already holds both directions.
* METIS (``.graph``/``.metis``): header ``nv ne [fmt [ncon]]``; the
  adjacency lists already hold both directions -> written as they are.

Self-loops are stored once (the ``Graph.from_edges`` convention);
duplicate input edges stay parallel records, which the engines coalesce
per sweep, so multigraphs are legal input.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import tempfile
from typing import Iterable, Iterator

import numpy as np

from cuvite_tpu_torch.io.vite import ViteStreamWriter

DEFAULT_CHUNK_EDGES = 1 << 22

_SPOOL_DTYPE = np.dtype([("src", "<i8"), ("dst", "<i8"), ("w", "<f8")])


@dataclasses.dataclass
class ConvertStats:
    """What the conversion did (also the provenance record's payload)."""

    out_path: str
    fmt: str
    num_vertices: int
    num_edges: int          # directed records in the Vite file
    input_edges: int        # edge entries read from the source
    self_loops: int
    relabeled: bool
    bits64: bool
    symmetrized: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ParsedSource:
    """An opened input: its edge-chunk iterator plus the per-format
    conversion policy the pipeline should apply."""

    chunks: Iterable
    fmt: str
    symmetrize: bool
    relabel: str                    # "auto" | "none" | "dense"
    num_vertices: int | None = None  # known from a header, else None


# ---------------------------------------------------------------------------
# Chunked text readers


def _text_blocks(path: str, block_bytes: int = 8 << 20) -> Iterator[bytes]:
    """Newline-aligned byte blocks from a text or gzip file."""
    opener = gzip.open if path.endswith(".gz") else open
    rem = b""
    with opener(path, "rb") as f:
        while True:
            buf = f.read(block_bytes)
            if not buf:
                break
            buf = rem + buf
            nl = buf.rfind(b"\n")
            if nl < 0:
                rem = buf
                continue
            yield buf[: nl + 1]
            rem = buf[nl + 1:]
    if rem:
        yield rem + b"\n"


def _strip_comments(block: bytes, markers: tuple = (b"#", b"%")) -> bytes:
    if not any(m in block for m in markers):
        return block
    keep = [ln for ln in block.split(b"\n")
            if ln and not ln.lstrip().startswith(markers)]
    return b"\n".join(keep)


def snap_edge_chunks(path: str) -> Iterator[tuple]:
    """SNAP edge list: ``u v`` or ``u v w`` per line, '#'/'%' comments."""
    ncols = None
    for block in _text_blocks(path):
        block = _strip_comments(block)
        tokens = block.split()
        if not tokens:
            continue
        if ncols is None:
            first_line = block.lstrip().split(b"\n", 1)[0]
            ncols = len(first_line.split())
            if ncols not in (2, 3):
                raise ValueError(
                    f"{path}: expected 2 or 3 columns, found {ncols}")
        if len(tokens) % ncols:
            raise ValueError(f"{path}: ragged edge line "
                             f"({len(tokens)} tokens % {ncols} columns)")
        arr = np.array(tokens)
        cols = arr.reshape(-1, ncols)
        src = cols[:, 0].astype(np.int64)
        dst = cols[:, 1].astype(np.int64)
        w = cols[:, 2].astype(np.float64) if ncols == 3 else None
        yield src, dst, w


def _mtx_header(path: str) -> tuple:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        header = f.readline().split()
        if len(header) < 5 or header[0] != b"%%MatrixMarket":
            raise ValueError(f"{path}: not a MatrixMarket file")
        obj, fmt, field, symm = (t.decode().lower() for t in header[1:5])
        if obj != "matrix" or fmt != "coordinate":
            raise ValueError(f"{path}: only 'matrix coordinate' supported "
                             f"(got '{obj} {fmt}')")
        if field not in ("pattern", "real", "integer"):
            raise ValueError(f"{path}: unsupported field '{field}'")
        if symm not in ("general", "symmetric"):
            raise ValueError(f"{path}: unsupported symmetry '{symm}'")
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: missing size line")
            if line.lstrip().startswith(b"%") or not line.strip():
                continue
            nrows, ncols_, nnz = (int(t) for t in line.split()[:3])
            break
    if nrows != ncols_:
        raise ValueError(f"{path}: adjacency matrix must be square "
                         f"({nrows}x{ncols_})")
    return field, symm, nrows, nnz


def mtx_edge_chunks(path: str) -> Iterator[tuple]:
    """MatrixMarket coordinate entries (1-based ids shifted to 0-based)."""
    field, _symm, _n, _nnz = _mtx_header(path)
    ncols = 2 if field == "pattern" else 3
    past_header = False
    for block in _text_blocks(path):
        lines = [ln for ln in block.split(b"\n")
                 if ln and not ln.lstrip().startswith(b"%")]
        if not past_header and lines:
            lines = lines[1:]  # the size line
            past_header = True
        if not lines:
            continue
        tokens = b" ".join(lines).split()
        if len(tokens) % ncols:
            raise ValueError(f"{path}: ragged coordinate line")
        cols = np.array(tokens).reshape(-1, ncols)
        src = cols[:, 0].astype(np.int64) - 1
        dst = cols[:, 1].astype(np.int64) - 1
        w = cols[:, 2].astype(np.float64) if ncols == 3 else None
        yield src, dst, w


def metis_edge_chunks(path: str,
                      chunk_edges: int = DEFAULT_CHUNK_EDGES,
                      block_bytes: int = 8 << 20) -> Iterator[tuple]:
    """METIS adjacency lines (both directions already present, 1-based)."""
    header = None
    vertex = 0
    srcs: list = []
    dsts: list = []
    ws: list = []
    n_acc = 0

    def flush():
        nonlocal srcs, dsts, ws, n_acc
        out = (np.array(srcs, dtype=np.int64),
               np.array(dsts, dtype=np.int64),
               np.array(ws, dtype=np.float64) if has_ew else None)
        srcs, dsts, ws, n_acc = [], [], [], 0
        return out

    for block in _text_blocks(path, block_bytes):
        # Every block ends with b"\n" (_text_blocks guarantees it), so
        # split() leaves a PHANTOM empty tail that is a block-boundary
        # artifact, not a file line — dropping it matters here because a
        # genuinely blank line IS meaningful (an isolated vertex).
        for raw in block.split(b"\n")[:-1]:
            line = raw.strip()
            if line.startswith(b"%"):
                continue
            if header is None:
                if not line:
                    continue
                toks = line.split()
                nv, _ne = int(toks[0]), int(toks[1])
                fmt = toks[2].decode() if len(toks) > 2 else "0"
                ncon = int(toks[3]) if len(toks) > 3 else (
                    1 if len(fmt) >= 2 and fmt[-2] == "1" else 0)
                fmt = fmt.zfill(3)
                has_vsize = fmt[0] == "1"
                has_vw = fmt[1] == "1"
                has_ew = fmt[2] == "1"
                skip = (1 if has_vsize else 0) + (ncon if has_vw else 0)
                header = (nv, skip, has_ew)
                continue
            # Every non-comment line after the header is one vertex's
            # adjacency — INCLUDING blank lines (an isolated vertex).
            if vertex >= header[0]:
                if line:
                    raise ValueError(f"{path}: more adjacency lines than "
                                     f"the header's nv={header[0]}")
                continue
            toks = line.split()[header[1]:]
            if has_ew:
                if len(toks) % 2:
                    raise ValueError(
                        f"{path}: vertex {vertex + 1} has an odd "
                        "neighbor/weight token count")
                nbrs = toks[0::2]
                wts = toks[1::2]
            else:
                nbrs, wts = toks, ()
            for k, t in enumerate(nbrs):
                srcs.append(vertex)
                dsts.append(int(t) - 1)
                if has_ew:
                    ws.append(float(wts[k]))
            n_acc += len(nbrs)
            vertex += 1
            if n_acc >= chunk_edges:
                yield flush()
    if header is None:
        raise ValueError(f"{path}: empty METIS file")
    if vertex != header[0]:
        raise ValueError(f"{path}: {vertex} adjacency lines for "
                         f"nv={header[0]}")
    if n_acc or vertex:
        out = flush()
        if len(out[0]):
            yield out


def _metis_num_vertices(path: str) -> int:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if line and not line.startswith(b"%"):
                return int(line.split()[0])
    raise ValueError(f"{path}: empty METIS file")


FORMATS = ("snap", "mtx", "metis")


def detect_format(path: str) -> str:
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext == ".mtx":
        return "mtx"
    if ext in (".graph", ".metis"):
        return "metis"
    return "snap"


def open_source(path: str, fmt: str = "auto") -> ParsedSource:
    """Open an input file as a chunked edge source with its conversion
    policy (symmetrization, relabeling, known vertex count)."""
    if fmt == "auto":
        fmt = detect_format(path)
    if fmt == "snap":
        return ParsedSource(chunks=snap_edge_chunks(path), fmt="snap",
                            symmetrize=True, relabel="auto")
    if fmt == "mtx":
        _field, symm, n, _nnz = _mtx_header(path)
        # 'general' adjacency already carries both directions; writing
        # it symmetrized would double every edge.
        return ParsedSource(chunks=mtx_edge_chunks(path), fmt="mtx",
                            symmetrize=(symm == "symmetric"),
                            relabel="none", num_vertices=n)
    if fmt == "metis":
        return ParsedSource(chunks=metis_edge_chunks(path), fmt="metis",
                            symmetrize=False, relabel="none",
                            num_vertices=_metis_num_vertices(path))
    raise ValueError(f"unknown format {fmt!r} (choose from {FORMATS})")


# ---------------------------------------------------------------------------
# The shared two-pass (spool -> degrees -> scatter -> canonicalize) pipeline


def _spool_chunks(chunks, spool_path: str, collect_ids: bool):
    """Pass 0: write raw records; return (n, max_id, min_id, uniq_ids)."""
    n = 0
    max_id = -1
    min_id = np.iinfo(np.int64).max
    uniq = np.zeros(0, dtype=np.int64)
    with open(spool_path, "wb") as spool:
        for src, dst, w in chunks:
            src = np.asarray(src, dtype=np.int64)
            dst = np.asarray(dst, dtype=np.int64)
            if len(src) != len(dst):
                raise ValueError("src/dst length mismatch")
            if not len(src):
                continue
            rec = np.empty(len(src), dtype=_SPOOL_DTYPE)
            rec["src"] = src
            rec["dst"] = dst
            rec["w"] = 1.0 if w is None else np.asarray(w, dtype=np.float64)
            rec.tofile(spool)
            n += len(src)
            max_id = max(max_id, int(src.max()), int(dst.max()))
            min_id = min(min_id, int(src.min()), int(dst.min()))
            if collect_ids:
                uniq = np.union1d(uniq, np.unique(
                    np.concatenate([src, dst])))
    return n, max_id, min_id, uniq


def _read_spool(spool_path: str, n: int, chunk: int) -> Iterator[np.ndarray]:
    mm = np.memmap(spool_path, dtype=_SPOOL_DTYPE, mode="r", shape=(n,))
    for lo in range(0, n, chunk):
        yield np.array(mm[lo: lo + chunk])
    del mm


def _scatter_positions(rows: np.ndarray, cursor: np.ndarray) -> np.ndarray:
    """Final-file positions for this chunk's rows, advancing ``cursor``
    (each row's records land at consecutive positions, chunk order)."""
    order = np.argsort(rows, kind="stable")
    r_sorted = rows[order]
    # rank of each record within its row-run
    run_start = np.zeros(len(r_sorted), dtype=np.int64)
    new_run = np.ones(len(r_sorted), dtype=bool)
    new_run[1:] = r_sorted[1:] != r_sorted[:-1]
    run_ids = np.cumsum(new_run) - 1
    first_idx = np.flatnonzero(new_run)
    rank = np.arange(len(r_sorted), dtype=np.int64) - first_idx[run_ids]
    pos_sorted = cursor[r_sorted] + rank
    uniq_rows = r_sorted[new_run]
    counts = np.diff(np.append(first_idx, len(r_sorted)))
    # Advancing the caller's cursor is the contract: it is the per-row
    # fill state carried across spool chunks.
    cursor[uniq_rows] += counts  # graftlint: disable=R005
    pos = np.empty(len(rows), dtype=np.int64)
    pos[order] = pos_sorted
    return pos


def _canonicalize_rows(writer: ViteStreamWriter, offsets: np.ndarray,
                       chunk_edges: int) -> None:
    """Pass 3: sort each row's records by tail id, block by block."""
    nv = len(offsets) - 1
    row = 0
    while row < nv:
        end = int(np.searchsorted(offsets, offsets[row] + chunk_edges,
                                  side="left"))
        end = max(end, row + 1)
        end = min(end, nv)
        lo, hi = int(offsets[row]), int(offsets[end])
        if hi > lo:
            rec = writer.read_edges(lo, hi)
            rows = np.repeat(np.arange(row, end, dtype=np.int64),
                             np.diff(offsets[row:end + 1]))
            order = np.lexsort((rec["tail"], rows))
            writer.write_edges(lo, rec["tail"][order], rec["weight"][order])
        row = end


def edges_to_vite(
    chunks: Iterable,
    out_path: str,
    *,
    bits64: bool = False,
    symmetrize: bool = True,
    num_vertices: int | None = None,
    relabel: str = "auto",
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    tmp_dir: str | None = None,
    fmt: str = "edges",
) -> ConvertStats:
    """Stream an edge-chunk iterable into a canonical Vite CSR file.

    ``relabel``: "none" keeps ids as given (requires them in
    [0, num_vertices)); "dense" always maps distinct ids to [0, n);
    "auto" relabels only when the id space has gaps.
    """
    tmp_dir = tmp_dir or os.path.dirname(os.path.abspath(out_path))
    fd, spool_path = tempfile.mkstemp(suffix=".spool", dir=tmp_dir)
    os.close(fd)
    try:
        collect = relabel in ("auto", "dense")
        n_in, max_id, min_id, uniq = _spool_chunks(chunks, spool_path,
                                                   collect)
        if n_in == 0:
            raise ValueError("input contains no edges")
        if min_id < 0:
            raise ValueError(f"negative vertex id {min_id} in input")
        id_map = None
        if relabel == "dense" or (relabel == "auto"
                                  and max_id + 1 != len(uniq)):
            id_map = uniq  # position = new id, via searchsorted
            nv = len(uniq)
        else:
            nv = max_id + 1
        if num_vertices is not None:
            if id_map is None and num_vertices < nv:
                raise ValueError(
                    f"vertex id {max_id} >= declared count {num_vertices}")
            if id_map is None:
                nv = num_vertices  # headers may declare isolated tail ids

        def mapped(rec):
            s, d = rec["src"], rec["dst"]
            if id_map is not None:
                s = np.searchsorted(id_map, s)
                d = np.searchsorted(id_map, d)
            return s, d, rec["w"]

        # Pass 1: degrees.
        deg = np.zeros(nv, dtype=np.int64)
        n_self = 0
        for rec in _read_spool(spool_path, n_in, chunk_edges):
            s, d, _ = mapped(rec)
            np.add.at(deg, s, 1)
            if symmetrize:
                fwd = s != d
                np.add.at(deg, d[fwd], 1)
                n_self += int(len(s) - fwd.sum())
            else:
                n_self += int((s == d).sum())
        ne = int(deg.sum())
        offsets = np.zeros(nv + 1, dtype=np.int64)
        np.cumsum(deg, out=offsets[1:])
        del deg

        # Pass 2: scatter records through per-row cursors.
        writer = ViteStreamWriter(out_path, nv, ne, bits64=bits64)
        writer.write_offsets(offsets)
        cursor = offsets[:-1].copy()
        for rec in _read_spool(spool_path, n_in, chunk_edges):
            s, d, w = mapped(rec)
            if symmetrize:
                fwd = s != d
                rows = np.concatenate([s, d[fwd]])
                tails = np.concatenate([d, s[fwd]])
                ws = np.concatenate([w, w[fwd]])
            else:
                rows, tails, ws = s, d, w
            pos = _scatter_positions(rows, cursor)
            writer.write_edges(pos, tails, ws)
        if not np.array_equal(cursor, offsets[1:]):
            raise AssertionError("scatter did not fill every CSR slot")

        # Pass 3: canonical per-row tail order.
        _canonicalize_rows(writer, offsets, chunk_edges)
        writer.close()
        return ConvertStats(
            out_path=out_path, fmt=fmt, num_vertices=nv, num_edges=ne,
            input_edges=n_in, self_loops=n_self,
            relabeled=id_map is not None, bits64=bits64,
            symmetrized=symmetrize,
        )
    finally:
        os.unlink(spool_path)


def convert(path: str, out_path: str, fmt: str = "auto",
            bits64: bool = False, symmetrize: str = "auto",
            relabel: str | None = None,
            chunk_edges: int = DEFAULT_CHUNK_EDGES) -> ConvertStats:
    """Convert a SNAP/MTX/METIS file to Vite binary (see module doc)."""
    src = open_source(path, fmt)
    sym = src.symmetrize if symmetrize == "auto" else (symmetrize == "yes")
    stats = edges_to_vite(
        src.chunks, out_path, bits64=bits64, symmetrize=sym,
        num_vertices=src.num_vertices,
        relabel=relabel if relabel is not None else src.relabel,
        chunk_edges=chunk_edges, fmt=src.fmt,
    )
    return stats
