"""The dataset catalogue, ``fetch`` and provenance (port of
``cuvite_tpu/workloads/registry.py``).

The three benchmark-family datasets of the reference (com-Orkut,
Friendster, uk-2007) are listed with their published vertex and edge
counts; ``fetch`` downloads one, verifies its checksum, decompresses it
and converts it to a Vite file in one streamed flow.  This module is the
only one of the package that opens a network connection (``urllib``
only), and every download it makes is checksummed.

Offline fallback: when the download fails (no network),
``fetch(..., offline_fallback=True)`` synthesizes a power-law stand-in
with planted communities at a bounded edge count (``workloads/synth.py``,
the same bytes as the reference's stand-in) and says so in the
provenance record, so the workloads never wait on connectivity.

Checksum policy: an entry whose ``sha256`` is None is trusted on first
use -- the streamed digest is printed and recorded in the provenance so
that it can be pinned; an entry with a pinned digest fails hard on a
mismatch and deletes the download.

The width envelope (``EDGE_FACTOR``, ``RMAT_SCALE_MAX``,
``rmat_scale_law``, ``synth_scale_law``, ``max_workload``) is the
reference's, field for field: the width audit reads it from here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import tarfile
import time

from cuvite_tpu_torch.workloads.convert import convert
from cuvite_tpu_torch.workloads.synth import synthesize, write_provenance

DOWNLOAD_TIMEOUT_S = 120
_BLOCK = 4 << 20

# Published stats: SNAP (com-Orkut / com-Friendster) and LAW/SuiteSparse
# (uk-2007-05).  ``edges`` is the UNDIRECTED published count; the Vite
# file stores ~2x directed records.
@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    url: str
    fmt: str                  # converter format of the decompressed file
    num_vertices: int
    num_edges_undirected: int
    sha256: str | None = None  # None => trust-on-first-use (recorded)
    ground_truth_url: str | None = None
    synth_edges: int = 1 << 27  # offline stand-in size (directed records)
    bits64: bool = False
    # Declared width envelope: the most vertices and directed edges any
    # slab built from this dataset may carry, which a width audit derives
    # its boundary shapes from.  Default: the published counts; a dataset
    # whose pipeline renumbers or expands ids declares the larger bound.
    max_nv: int | None = None
    max_ne: int | None = None

    @property
    def num_edges_directed(self) -> int:
        return 2 * self.num_edges_undirected

    @property
    def width_nv(self) -> int:
        return self.max_nv if self.max_nv is not None else self.num_vertices

    @property
    def width_ne(self) -> int:
        return self.max_ne if self.max_ne is not None \
            else self.num_edges_directed


DATASETS: dict = {
    d.name: d for d in (
        Dataset(
            name="com-orkut",
            url="https://snap.stanford.edu/data/bigdata/communities/"
                "com-orkut.ungraph.txt.gz",
            fmt="snap",
            num_vertices=3_072_441,
            num_edges_undirected=117_185_083,
            max_nv=3_072_441,
            max_ne=234_370_166,
            ground_truth_url="https://snap.stanford.edu/data/bigdata/"
                             "communities/com-orkut.all.cmty.txt.gz",
            synth_edges=1 << 27,
        ),
        Dataset(
            name="friendster",
            url="https://snap.stanford.edu/data/bigdata/communities/"
                "com-friendster.ungraph.txt.gz",
            fmt="snap",
            num_vertices=65_608_366,
            num_edges_undirected=1_806_067_135,
            max_nv=65_608_366,
            max_ne=3_612_134_270,
            ground_truth_url="https://snap.stanford.edu/data/bigdata/"
                             "communities/com-friendster.all.cmty.txt.gz",
            synth_edges=1 << 27,
            bits64=True,
        ),
        Dataset(
            name="uk-2007",
            url="https://suitesparse-collection-website.herokuapp.com/"
                "MM/LAW/uk-2007-05.tar.gz",
            fmt="mtx",
            num_vertices=105_896_555,
            num_edges_undirected=3_738_733_648 // 2,
            max_nv=105_896_555,
            max_ne=3_738_733_648,
            synth_edges=1 << 27,
            bits64=True,
        ),
    )
}

# Relative tolerance for the expected |V|/|E| envelope after conversion
# (relabeling drops isolated ids; published counts sometimes exclude
# self-loops): generous enough for bookkeeping drift, tight enough to
# catch a truncated download or a broken converter.
SIZE_ENVELOPE_REL = 0.02


# ---------------------------------------------------------------------------
# Declared width envelope: the single source a width audit derives every
# boundary shape from.

# The synth/R-MAT scale ladder tops out at scale 28 (the billion-edge
# target): nv = 2^28, ne = EDGE_FACTOR * 2^28 = 2^32 directed records
# under the synth layout law below.
RMAT_SCALE_MAX = 28
# workloads/synth.SynthSpec's default mean directed degree (the layout
# law is nv = max(64, edges // edge_factor), synth.py::_layout);
# ``edges`` counts DIRECTED records, the repo's slab-row convention.
EDGE_FACTOR = 16

# Serving batch-ladder ceiling (== max(core.batch.BATCH_SIZES), restated
# here so that the fetch module never imports the device stack).
BATCH_MAX = 64


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def rmat_scale_law(scale: int, edge_factor: int = EDGE_FACTOR) -> tuple:
    """R-MAT/synth scale -> (nv, ne_directed): nv = 2^scale and
    ne = edge_factor * 2^scale directed records — the inverse of the
    synth layout law (nv = edges // edge_factor), so a scale-s stand-in
    synthesized at this ne lands exactly on 2^s vertices."""
    nv = 1 << scale
    return nv, edge_factor * nv


def synth_scale_law(edges: int, edge_factor: int = EDGE_FACTOR) -> tuple:
    """Directed edge count -> (nv, ne_directed) under the synth layout
    law (workloads/synth.py::_layout): nv = max(64, edges //
    edge_factor)."""
    return max(64, int(edges) // int(edge_factor)), int(edges)


def max_workload() -> dict:
    """The registry's declared max workload, in the width-symbol
    vocabulary of the reference's width audit (``analysis/widthcheck.py``
    pins its MAX_WORKLOAD copy against this dict):

    * ``nv_pad``/``nv_total`` — pow2 padding of the largest declared
      vertex space (scale-28 R-MAT's 2^28 tops uk-2007's 105.9 M);
    * ``ne_pad`` — pow2 padding of the largest declared directed edge
      count (Friendster's 3.61 B and the scale-28 law's 2^32 both pad
      to 2^32);
    * ``two_m`` — total-weight ceiling, 2 * ne_pad (headroom for small
      integer weights over the unit-weight mass);
    * ``kbits``/``sbits`` — the packed-sort budget at that vertex space
      (key_bound = nv_pad, src_bound = nv_pad + 1: ops/segment.py);
    * ``B`` — the serving batch-ladder ceiling.
    """
    nv_max = max([d.width_nv for d in DATASETS.values()]
                 + [rmat_scale_law(RMAT_SCALE_MAX)[0]])
    ne_max = max([d.width_ne for d in DATASETS.values()]
                 + [rmat_scale_law(RMAT_SCALE_MAX)[1]])
    nv_pad = _next_pow2(nv_max)
    ne_pad = _next_pow2(ne_max)
    return {
        "nv_pad": nv_pad,
        "nv_total": nv_pad,
        "ne_pad": ne_pad,
        "two_m": 2 * ne_pad,
        "kbits": max(nv_pad - 1, 1).bit_length(),
        "sbits": max(nv_pad, 1).bit_length(),
        "B": BATCH_MAX,
    }


def _verify_checksum(name: str, digest: str, expected: str | None,
                     path: str) -> None:
    """Pinned digest mismatch deletes the artifact and raises; an
    unpinned (TOFU) digest is reported for later pinning."""
    if expected is None:
        print(f"# {name}: sha256 UNPINNED (trust-on-first-use) — computed "
              f"{digest}; pin it in workloads/registry.py", file=sys.stderr)
        return
    if digest != expected:
        os.unlink(path)
        raise ValueError(
            f"{name}: sha256 mismatch (expected {expected}, got {digest}); "
            "partial download deleted")


def _download(url: str, dest: str, timeout: int = DOWNLOAD_TIMEOUT_S) -> str:
    """Stream ``url`` to ``dest`` computing sha256 on the fly; returns
    the hex digest.  (urllib only: see the module note.)"""
    import urllib.request

    h = hashlib.sha256()
    part = dest + ".part"
    req = urllib.request.Request(url, headers={"User-Agent": "cuvite-tpu"})
    with urllib.request.urlopen(req, timeout=timeout) as resp, \
            open(part, "wb") as out:
        while True:
            buf = resp.read(_BLOCK)
            if not buf:
                break
            h.update(buf)
            out.write(buf)
    os.replace(part, dest)
    return h.hexdigest()


def _extract_payload(archive: str, dest_dir: str, fmt: str) -> str:
    """Resolve the converter's input file from a download: a .tar.gz is
    extracted (largest member matching the format's extension); a plain
    .gz passes through (the text readers stream gzip natively)."""
    if archive.endswith(".tar.gz") or archive.endswith(".tgz"):
        want = {"mtx": ".mtx", "metis": ".graph", "snap": ".txt"}[fmt]
        with tarfile.open(archive, "r:gz") as tf:
            members = [m for m in tf.getmembers()
                       if m.isfile() and m.name.endswith(want)]
            if not members:
                raise ValueError(f"{archive}: no *{want} member")
            member = max(members, key=lambda m: m.size)
            base = os.path.basename(member.name)
            out = os.path.join(dest_dir, base)
            with tf.extractfile(member) as src, open(out, "wb") as dst:
                while True:
                    buf = src.read(_BLOCK)
                    if not buf:
                        break
                    dst.write(buf)
        return out
    return archive


def _check_size_envelope(ds: Dataset, nv: int, ne: int) -> list:
    problems = []
    for label, got, want in (("num_vertices", nv, ds.num_vertices),
                             ("num_edges(directed)", ne,
                              ds.num_edges_directed)):
        if abs(got - want) > SIZE_ENVELOPE_REL * want:
            problems.append(f"{label}: got {got}, expected ~{want} "
                            f"(±{SIZE_ENVELOPE_REL:.0%})")
    return problems


def fetch(name: str, dest_dir: str, offline_fallback: bool = True,
          timeout: int = DOWNLOAD_TIMEOUT_S, synth_edges: int | None = None,
          keep_download: bool = False) -> dict:
    """Materialize dataset ``name`` as ``<dest_dir>/<name>.vite``.

    Downloads + verifies + converts when the network answers; otherwise
    (with ``offline_fallback``) synthesizes a stand-in of
    ``synth_edges`` directed edges and records that provenance honestly.
    Returns the provenance payload.
    """
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r} "
                       f"(choose from {sorted(DATASETS)})")
    ds = DATASETS[name]
    os.makedirs(dest_dir, exist_ok=True)
    out_path = os.path.join(dest_dir, f"{name}.vite")
    archive = os.path.join(dest_dir, os.path.basename(ds.url))
    try:
        digest = _download(ds.url, archive, timeout=timeout)
    except Exception as e:  # URLError, socket.timeout, HTTP errors...
        if not offline_fallback:
            raise
        edges = int(synth_edges if synth_edges is not None
                    else min(ds.num_edges_directed, ds.synth_edges))
        print(f"# {name}: network fetch failed ({type(e).__name__}: {e}); "
              f"synthesizing an offline stand-in at {edges} directed edges",
              file=sys.stderr)
        # Stable per-dataset seed (NOT Python's hash(): that is
        # PYTHONHASHSEED-randomized per process, and the stand-in must
        # be byte-reproducible across runs for golden envelopes).
        seed = int.from_bytes(
            hashlib.sha256(name.encode()).digest()[:4], "big")
        payload = synthesize(
            out_path, edges=edges, profile="powerlaw",
            seed=seed, bits64=ds.bits64,
            provenance_extra={
                "source": "offline-synthesized",
                "stands_in_for": name,
                "fetch_error": f"{type(e).__name__}: {e}",
                "dataset_expected": {
                    "num_vertices": ds.num_vertices,
                    "num_edges_directed": ds.num_edges_directed,
                },
            })
        return payload

    _verify_checksum(name, digest, ds.sha256, archive)
    payload_file = _extract_payload(archive, dest_dir, ds.fmt)
    stats = convert(payload_file, out_path, fmt=ds.fmt, bits64=ds.bits64)
    problems = _check_size_envelope(ds, stats.num_vertices,
                                    stats.num_edges)
    if problems:
        raise ValueError(f"{name}: converted size outside the published "
                         f"envelope: {'; '.join(problems)}")
    if not keep_download and payload_file != archive:
        os.unlink(payload_file)
    if not keep_download:
        os.unlink(archive)
    payload = {
        "source": "fetched",
        "dataset": name,
        "url": ds.url,
        "sha256": digest,
        "sha256_pinned": ds.sha256 is not None,
        "result": stats.to_dict(),
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    write_provenance(out_path, payload)
    return payload


def load_provenance(vite_path: str) -> dict | None:
    path = vite_path + ".provenance.json"
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)
