"""Offline workload synthesizer: power-law degrees and planted overlapping
communities (port of ``cuvite_tpu/workloads/synth.py:66-257, 371-475``).

Every random draw is a counter-based splitmix64 hash of (seed, index), so
an (edges, seed, profile) triple always gives the same graph, and the
graphs and ground-truth files are byte-identical to the reference's.

Model (the LFR ingredients, vectorized):
  * vertex degree draws d_i ~ dmin * u^(-1/(alpha-1)), capped, scaled
    exactly to the requested total;
  * community sizes from a second power law; vertices assigned to
    contiguous ranges; a deterministic ``overlap`` fraction of vertices
    holds a second membership (their edges split between the two);
  * each draw is intra-community with probability 1-mu (a uniform member
    of one of the vertex's communities), else a uniform global target;
    self-draws are dropped, parallel edges kept (multigraph-legal).

:func:`synthesize_graph` returns the graph in memory (duplicates
coalesced), the serving tenants' generator.  :func:`synthesize` writes the
Vite file (each undirected draw in both directions, parallel records kept,
each row's records in tail order), the ground truth (LFR ``vertex
community``, 1-based) to ``<out>.truth`` and the provenance, with the
file's sha256, to ``<out>.provenance.json``.  The reference streams the
file through its converter in chunks of bounded memory; the port builds
it in memory, which holds the same bytes, and has no converter.

:func:`churn_batches` (``:258-370``) draws the deterministic insert/delete
stream of the streaming bench against a base graph; :func:`write_churn`
writes it beside a Vite file as ``<out>.churn.npz`` with its provenance,
and :func:`load_churn` reads it back.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time

import numpy as np

from cuvite_tpu_torch.utils.rng import splitmix64, u01

PROFILES = ("powerlaw",)

# Edges per chunk of the draw stream (the reference converter's default);
# every draw is a pure hash of its global index, so chunking never
# changes the edge set.
DEFAULT_CHUNK_EDGES = 1 << 22

# Stream tags: every hash stream is splitmix64(seed * STRIDE + tag + index)
# with a distinct tag so streams never collide across uses.
_T_DEGREE = 0x01 << 56
_T_CSIZE = 0x02 << 56
_T_OVERLAP = 0x03 << 56
_T_ALT = 0x04 << 56
_T_MIX = 0x05 << 56
_T_PICK = 0x06 << 56
_T_INTRA = 0x07 << 56
_T_INTER = 0x08 << 56
_T_MANY = 0x09 << 56
# Churn streams: delete ranks, insert endpoints, insert weights -- distinct
# tags so a churn stream never collides with the base synthesis draws of
# the same seed.
_T_CHURN_DEL = 0x0A << 56
_T_CHURN_INS = 0x0B << 56
_T_CHURN_W = 0x0C << 56
_STRIDE = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def _stream_base(tag: int, seed: int) -> np.uint64:
    """Per-(seed, tag) stream offset; the multiply wraps mod 2^64 by
    design (computed in Python ints so numpy stays warning-free)."""
    return np.uint64((seed * _STRIDE + tag) & _MASK64)


def _hash_u01(tag: int, idx: np.ndarray, seed: int) -> np.ndarray:
    return u01(splitmix64(_stream_base(tag, seed) + idx.astype(np.uint64)))


def _exact_counts(weights: np.ndarray, total: int) -> np.ndarray:
    """Integer counts proportional to ``weights`` summing to exactly
    ``total`` (cumulative rounding: deterministic, order-stable)."""
    cum = np.cumsum(weights, dtype=np.float64)
    cum *= total / cum[-1]
    bounds = np.floor(cum + 0.5).astype(np.int64)
    counts = np.diff(np.concatenate([[0], bounds]))
    counts[-1] += total - bounds[-1]
    return counts


@dataclasses.dataclass
class SynthSpec:
    """Resolved synthesizer parameters (recorded in provenance)."""

    profile: str
    edges: int           # target directed records in the Vite file
    seed: int
    alpha: float         # degree power-law exponent
    mu: float            # inter-community mixing fraction
    dmin: int
    edge_factor: int     # mean directed degree -> nv = edges / edge_factor
    comm_min: int
    comm_beta: float     # community-size power-law exponent
    overlap: float       # fraction of vertices with a second membership
    bits64: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _community_layout(nv: int, spec: SynthSpec):
    """Community sizes from a power law covering exactly nv vertices.
    Returns (bounds[nc+1], sizes[nc])."""
    cmax = max(spec.comm_min + 1, nv // 16 or 1)
    sizes = []
    covered = 0
    batch = 0
    while covered < nv:
        idx = np.arange(batch * 4096, (batch + 1) * 4096, dtype=np.int64)
        u = _hash_u01(_T_CSIZE, idx, spec.seed)
        s = np.minimum(
            (spec.comm_min * np.power(1.0 - u, -1.0 / (spec.comm_beta - 1.0))
             ).astype(np.int64), cmax)
        sizes.append(s)
        covered += int(s.sum())
        batch += 1
    sizes = np.concatenate(sizes)
    cut = int(np.searchsorted(np.cumsum(sizes), nv, side="left")) + 1
    sizes = sizes[:cut]
    sizes[-1] -= int(sizes.sum()) - nv  # trim the last community to fit
    if sizes[-1] <= 0:  # merge a degenerate tail into its neighbor
        sizes = sizes[:-1]
        sizes[-1] += nv - int(sizes.sum())
    bounds = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=bounds[1:])
    return bounds, sizes


def _edge_chunk_stream(nv: int, draws: np.ndarray, bounds: np.ndarray,
                       spec: SynthSpec, chunk_edges: int):
    """Yield (src, dst, None) chunks; every value is a pure hash of its
    global draw index, so chunking never changes the edge set."""
    nc = len(bounds) - 1
    comm_of = np.empty(nv, dtype=np.int64)
    for c in range(nc):
        comm_of[bounds[c]:bounds[c + 1]] = c
    # Second membership for a deterministic `overlap` fraction.
    vidx = np.arange(nv, dtype=np.int64)
    has_alt = _hash_u01(_T_OVERLAP, vidx, spec.seed) < spec.overlap
    alt_pick = splitmix64(_stream_base(_T_ALT, spec.seed)
                          + vidx.astype(np.uint64))
    alt_of = ((comm_of + 1 + (alt_pick % np.uint64(max(nc - 1, 1)))
               .astype(np.int64)) % nc) if nc > 1 else comm_of.copy()
    alt_of = np.where(has_alt, alt_of, comm_of)

    cum = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(draws, out=cum[1:])
    lo_v = 0
    while lo_v < nv:
        hi_v = int(np.searchsorted(cum, cum[lo_v] + chunk_edges,
                                   side="left"))
        hi_v = min(max(hi_v, lo_v + 1), nv)
        src = np.repeat(np.arange(lo_v, hi_v, dtype=np.int64),
                        draws[lo_v:hi_v])
        if not len(src):
            lo_v = hi_v
            continue
        gidx = np.arange(int(cum[lo_v]), int(cum[hi_v]), dtype=np.int64)
        intra = _hash_u01(_T_MIX, gidx, spec.seed) >= spec.mu
        use_alt = _hash_u01(_T_PICK, gidx, spec.seed) < 0.5
        comm = np.where(use_alt, alt_of[src], comm_of[src])
        clo = bounds[comm]
        csz = (bounds[comm + 1] - clo).astype(np.uint64)
        h_in = splitmix64(_stream_base(_T_INTRA, spec.seed)
                          + gidx.astype(np.uint64))
        t_in = clo + (h_in % np.maximum(csz, 1)).astype(np.int64)
        h_out = splitmix64(_stream_base(_T_INTER, spec.seed)
                           + gidx.astype(np.uint64))
        t_out = (h_out % np.uint64(nv)).astype(np.int64)
        dst = np.where(intra, t_in, t_out)
        keep = src != dst
        yield src[keep], dst[keep], None
        lo_v = hi_v


def _sha256_file(path: str, block: int = 8 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(block)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def write_provenance(out_path: str, payload: dict) -> str:
    path = out_path + ".provenance.json"
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def many_seed(seed: int, index: int) -> int:
    """Per-graph seed of a ``--many`` set: splitmix64 of (seed, index) on
    its own stream tag, so graph k is deterministic, independent of the
    set size, and never collides with the base generator's streams."""
    return int(splitmix64(_stream_base(_T_MANY, seed)
                          + np.uint64(index))) & ((1 << 62) - 1)


def _layout(edges: int, spec: SynthSpec, seed: int):
    """Shared degree/community layout of one synthesized graph."""
    n_pairs = edges // 2
    nv = max(64, edges // spec.edge_factor)
    dmax = max(spec.dmin * 4, int(np.sqrt(nv) * 4))
    vidx = np.arange(nv, dtype=np.int64)
    u = _hash_u01(_T_DEGREE, vidx, seed)
    wdeg = spec.dmin * np.power(1.0 - u, -1.0 / (spec.alpha - 1.0))
    wdeg = np.minimum(wdeg, dmax)
    draws = _exact_counts(wdeg, n_pairs)
    bounds, sizes = _community_layout(nv, spec)
    return nv, draws, bounds, sizes


def _spec(profile: str, edges: int, seed: int, bits64: bool, **kw):
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r} "
                         f"(choose from {PROFILES})")
    edges = int(edges)
    if edges < 4:
        raise ValueError("need at least 4 directed edges")
    return SynthSpec(profile=profile, edges=edges, seed=seed, bits64=bits64,
                     **kw)


def _draw_edges(nv, draws, bounds, spec, chunk_edges) -> tuple:
    srcs, dsts = [], []
    for s, d, _w in _edge_chunk_stream(nv, draws, bounds, spec,
                                       chunk_edges):
        srcs.append(s)
        dsts.append(d)
    src = np.concatenate(srcs) if srcs else np.zeros(0, dtype=np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, dtype=np.int64)
    return src, dst


def synthesize_graph(edges: int, seed: int = 1, profile: str = "powerlaw",
                     alpha: float = 2.3, mu: float = 0.25, dmin: int = 2,
                     edge_factor: int = 16, comm_min: int = 16,
                     comm_beta: float = 1.8, overlap: float = 0.05):
    """In-memory variant of :func:`synthesize`: the same draw streams as a
    ``core.graph.Graph`` (symmetrized, duplicates coalesced)."""
    from cuvite_tpu_torch.core.graph import Graph

    spec = _spec(profile, edges, seed, False, alpha=alpha, mu=mu, dmin=dmin,
                 edge_factor=edge_factor, comm_min=comm_min,
                 comm_beta=comm_beta, overlap=overlap)
    nv, draws, bounds, _sizes = _layout(spec.edges, spec, seed)
    src, dst = _draw_edges(nv, draws, bounds, spec, DEFAULT_CHUNK_EDGES)
    return Graph.from_edges(nv, src, dst, symmetrize=True)


def churn_batches(graph, *, frac: float, seed: int = 1,
                  batches: int = 1) -> list:
    """Deterministic insert/delete churn stream against a base graph:
    the offline workload of the streaming warm-start bench.

    Each batch deletes ``frac`` of the base graph's undirected pairs and
    inserts as many fresh hash-drawn pairs with small dyadic integer
    weights (1..8, inside the exactness domain of the device coalesce,
    so a delta and a rebuild stay bit-equal).  Every draw is a splitmix64
    hash of (seed, index) on churn-only stream tags: the batch list is a
    pure function of (graph, frac, seed, batches).  Deletes are sampled
    without replacement ACROSS batches (rank order of one hash stream
    over the base pairs), so batch k's deletes still exist when it is
    applied; inserts may touch any pair, including one another's --
    duplicate inserts coalesce by weight sum, exactly like the rebuild
    oracle.

    Returns a list of ``batches`` dicts with int64/f64 numpy arrays
    ``{ins_src, ins_dst, ins_w, del_src, del_dst}`` (one undirected
    record per pair; ``stream.DeltaBatch.from_edits`` symmetrizes).
    """
    frac = float(frac)
    batches = int(batches)
    if not 0.0 < frac < 1.0:
        raise ValueError("--churn fraction must be in (0, 1)")
    if batches < 1:
        raise ValueError("churn needs at least one batch")
    nv = graph.num_vertices
    deg = np.diff(graph.offsets)
    src_all = np.repeat(np.arange(nv, dtype=np.int64), deg)
    dst_all = np.asarray(graph.tails, dtype=np.int64)
    canon = src_all <= dst_all  # one record per undirected pair
    psrc, pdst = src_all[canon], dst_all[canon]
    n_pairs = len(psrc)
    n_churn = max(1, int(round(frac * n_pairs)))
    if batches * n_churn > n_pairs:
        raise ValueError(
            f"churn of {batches} x {n_churn} pairs exceeds the base "
            f"graph's {n_pairs} undirected pairs; lower --churn or "
            "--churn-batches")
    pidx = np.arange(n_pairs, dtype=np.int64)
    rank = np.argsort(splitmix64(_stream_base(_T_CHURN_DEL, seed)
                                 + pidx.astype(np.uint64)),
                      kind="stable")
    out = []
    for b in range(batches):
        dsel = rank[b * n_churn:(b + 1) * n_churn]
        # Fresh endpoints: oversample, drop self-draws, keep the first
        # n_churn -- deterministic in the draw index.
        need, have, lo = n_churn, [], 0
        while need > 0:
            gidx = np.arange(lo, lo + 2 * need + 4, dtype=np.int64) \
                + np.int64(b) * np.int64(8 * (n_churn + 1))
            hu = splitmix64(_stream_base(_T_CHURN_INS, seed)
                            + (2 * gidx).astype(np.uint64))
            hv = splitmix64(_stream_base(_T_CHURN_INS, seed)
                            + (2 * gidx + 1).astype(np.uint64))
            iu = (hu % np.uint64(nv)).astype(np.int64)
            iv = (hv % np.uint64(nv)).astype(np.int64)
            keep = iu != iv
            have.append(np.stack([iu[keep], iv[keep],
                                  gidx[keep]], axis=1))
            need = n_churn - sum(len(h) for h in have)
            lo += len(gidx)
        ins = np.concatenate(have)[:n_churn]
        hw = splitmix64(_stream_base(_T_CHURN_W, seed)
                        + ins[:, 2].astype(np.uint64))
        ins_w = 1.0 + (hw % np.uint64(8)).astype(np.float64)
        out.append({
            "ins_src": ins[:, 0].copy(), "ins_dst": ins[:, 1].copy(),
            "ins_w": ins_w,
            "del_src": psrc[dsel].copy(), "del_dst": pdst[dsel].copy(),
        })
    return out


def write_churn(out_path: str, graph, *, frac: float, seed: int = 1,
                batches: int = 1) -> dict:
    """Materialize :func:`churn_batches` next to a synthesized Vite file:
    ``<out>.churn.npz`` holds the batch arrays
    (``{ins_src,ins_dst,ins_w,del_src,del_dst}_<k>``);
    ``<out>.churn.provenance.json`` records the churn seed and fraction
    and the npz sha256, so the warm-start bench is reproducible
    offline."""
    bs = churn_batches(graph, frac=frac, seed=seed, batches=batches)
    npz_path = out_path + ".churn.npz"
    arrays = {}
    for k, b in enumerate(bs):
        for key, arr in b.items():
            arrays[f"{key}_{k}"] = arr
    np.savez(npz_path, **arrays)
    payload = {
        "source": "churn",
        "base": out_path,
        "churn_seed": int(seed),
        "churn_frac": float(frac),
        "batches": int(batches),
        "pairs_deleted_each": int(len(bs[0]["del_src"])),
        "pairs_inserted_each": int(len(bs[0]["ins_src"])),
        "sha256": _sha256_file(npz_path),
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    write_provenance(out_path + ".churn", payload)
    return payload


def load_churn(out_path: str) -> list:
    """Read ``<out>.churn.npz`` back into the churn_batches shape."""
    keys = ("ins_src", "ins_dst", "ins_w", "del_src", "del_dst")
    with np.load(out_path + ".churn.npz") as z:
        n = max(int(name.rsplit("_", 1)[1]) for name in z.files) + 1
        return [{k: z[f"{k}_{b}"] for k in keys} for b in range(n)]


def synthesize_many(out_prefix: str, count: int, edges: int, seed: int = 1,
                    write_truth: bool = True, **kw) -> dict:
    """K graphs in one call: graph k is :func:`synthesize` under
    ``many_seed(seed, k)``, written to ``<out_prefix>_<k>.vite``, with one
    provenance file for the set at ``<out_prefix>.many.provenance.json``."""
    count = int(count)
    if count < 1:
        raise ValueError("--many needs a positive graph count")
    members = []
    for k in range(count):
        sk = many_seed(seed, k)
        path = f"{out_prefix}_{k:04d}.vite"
        payload = synthesize(
            path, edges, seed=sk, write_truth=write_truth,
            provenance_extra={"many": {"base_seed": seed, "index": k,
                                       "count": count}},
            **kw)
        members.append({"path": path, "seed": sk,
                        "sha256": payload["sha256"],
                        "result": payload["result"]})
    set_payload = {
        "source": "synthesized-many",
        "count": count,
        "base_seed": seed,
        "edges_each": int(edges),
        "graphs": members,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    write_provenance(out_prefix + ".many", set_payload)
    return set_payload


def _write_vite_records(out_path: str, nv: int, src: np.ndarray,
                        dst: np.ndarray, bits64: bool) -> int:
    """Each draw (u, v) as the records u -> v and v -> u, weight 1, each
    row's records in tail order, as the reference's converter writes them
    (``workloads/convert.py::edges_to_vite``, relabel 'none').  Returns
    the record count."""
    fwd = src != dst
    rows = np.concatenate([src, dst[fwd]])
    tails = np.concatenate([dst, src[fwd]])
    order = np.lexsort((tails, rows))
    counts = np.bincount(rows, minlength=nv)
    offsets = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    elem = np.dtype("<i8") if bits64 else np.dtype("<i4")
    rec = np.empty(len(rows), dtype=[("tail", elem),
                                     ("weight", "<f8" if bits64 else "<f4")])
    rec["tail"] = tails[order]
    rec["weight"] = 1.0
    ne = len(rows)
    if not bits64 and (nv > np.iinfo(np.int32).max
                       or ne > np.iinfo(np.int32).max):
        raise ValueError(f"nv={nv} / ne={ne} overflow the 32-bit Vite "
                         "layout; pass bits64=True")
    with open(out_path, "wb") as f:
        np.array([nv, ne], dtype=elem).tofile(f)
        offsets.astype(elem).tofile(f)
        rec.tofile(f)
    return ne


def synthesize(
    out_path: str,
    edges: int,
    profile: str = "powerlaw",
    seed: int = 1,
    alpha: float = 2.3,
    mu: float = 0.25,
    dmin: int = 2,
    edge_factor: int = 16,
    comm_min: int = 16,
    comm_beta: float = 1.8,
    overlap: float = 0.05,
    bits64: bool = False,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    write_truth: bool = True,
    provenance_extra: dict | None = None,
) -> dict:
    """Synthesize a power-law community graph as a Vite file.

    ``edges`` is the target number of directed records in the file; the
    realized count is slightly lower (self-draws dropped).  Returns the
    provenance payload (also written to ``<out>.provenance.json``)."""
    spec = _spec(profile, edges, seed, bits64, alpha=alpha, mu=mu,
                 dmin=dmin, edge_factor=edge_factor, comm_min=comm_min,
                 comm_beta=comm_beta, overlap=overlap)
    nv, draws, bounds, sizes = _layout(spec.edges, spec, seed)
    vidx = np.arange(nv, dtype=np.int64)
    src, dst = _draw_edges(nv, draws, bounds, spec, chunk_edges)
    if not len(src):
        raise ValueError("input contains no edges")
    ne = _write_vite_records(out_path, nv, src, dst, bits64)
    result = {
        "out_path": out_path, "fmt": f"synth:{profile}",
        "num_vertices": nv, "num_edges": ne, "input_edges": int(len(src)),
        "self_loops": int((src == dst).sum()), "relabeled": False,
        "bits64": bits64, "symmetrized": True,
    }

    truth_path = None
    if write_truth:
        truth_path = out_path + ".truth"
        comm_of = np.searchsorted(bounds, vidx, side="right") - 1
        cols = np.stack([vidx + 1, comm_of + 1], axis=1)
        np.savetxt(truth_path, cols, fmt="%d")

    payload = {
        "source": "synthesized",
        "spec": spec.to_dict(),
        "result": result,
        "num_communities_planted": int(len(sizes)),
        "degree_draw_total": int(draws.sum()),
        "sha256": _sha256_file(out_path),
        "truth_path": truth_path,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if provenance_extra:
        payload.update(provenance_extra)
    write_provenance(out_path, payload)
    return payload
