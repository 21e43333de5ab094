"""Batched multi-tenant slab packing (port of ``cuvite_tpu/core/batch.py``).

Serving many small graphs at once: every graph canonicalizes to a pow2
slab class ``(nv_pad, ne_pad)`` under the single-shard floors, and B graphs
of one class stack on a leading batch axis, which the batched engine
(``louvain/batched.py``) runs as one batch.  The batch size pads to a
small pow2 ladder (``BATCH_SIZES``); padding rows are all-padding slabs
(every edge slot ``src == nv_pad``, weight 0, no real vertex, constant 0)
and are dropped at unpack.

What does not carry over, by design:

- The reference pads plans and batch sizes so that a serving queue
  compiles few programs per class; eager PyTorch has no compile key.  The
  ladder, the classes and ``bucket_shape`` are kept because the serving
  layer bins jobs by them and because a pinned shape must still refuse a
  batch that does not fit it.
- The reference refuses wide-policy (f64-weight) graphs under
  ``jax_enable_x64``, where its per-graph drivers would keep f64.  The
  port's device path is int32/f32 for every graph, batched or not, so a
  batch changes no graph's types and there is nothing to refuse.
- ``batch_bucket_plans`` keeps each tenant's host ``BucketPlan`` as it is
  and folds them into one device plan over the batch's B * nv_pad
  vertices (``BatchedBucketPlan.fold``); the reference pads every tenant
  to a common [B, rows, width] geometry.  The geometry (``BucketShape``)
  is still computed, pinned and checked as the reference does, from the
  rows' degrees (``batch_bucket_shape``), also where the batched engine
  builds phase 0's plan on the device and no host plan exists.

Sub-row packing (``SubRowLayout``, ``pack_subrows``, ``unpack_subrows``):
2^k graphs of a small class ride one row of an exactly 2^k times larger
class, each in its own fence interval of vertex ids and edge slots.  The
arrays are the reference's, slab for slab; the batched engine runs a
packed batch as a fold of its sub-rows (``louvain/batched.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuvite_tpu_torch.core.types import next_pow2
from cuvite_tpu_torch.louvain.bucketed import (
    DEFAULT_BUCKETS,
    BucketPlan,
    fold_plans,
)

# Slab-class floors of the reference's single-shard per-graph drivers, so
# a graph lands in the same class whether it is served batched or alone.
MIN_NV_PAD = 4096
MIN_NE_PAD = 16384

# Widest folded id space of a batch (``fold_slab``): tenant b's vertex v
# is b * nv_pad + v, and the padding id b * nv_pad, in int32.
FOLD_ID_MAX = (1 << 31) - 1

# The batch-size ladder: B pads to the smallest member >= n_jobs (counts
# above the top rung pad to the next pow2).
BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64)

# The batched engines (semantics in louvain/batched.py).
BATCH_ENGINES = ("fused", "bucketed")


def slab_class_of(graph) -> tuple:
    """The pow2 slab class ``(nv_pad, ne_pad)`` of a graph under the
    single-shard floors: the serving queue's binning key.  Host
    arithmetic only."""
    return (
        max(next_pow2(max(graph.num_vertices, 1)), MIN_NV_PAD),
        max(next_pow2(max(graph.num_edges, 1)), MIN_NE_PAD),
    )


def batch_pad(n_jobs: int) -> int:
    """Smallest BATCH_SIZES rung >= n_jobs (pow2 beyond the ladder)."""
    if n_jobs < 1:
        raise ValueError("need at least one job")
    for b in BATCH_SIZES:
        if n_jobs <= b:
            return b
    return next_pow2(n_jobs)


@dataclasses.dataclass
class BatchedSlab:
    """B same-class single-shard slabs stacked on a leading batch axis.

    Each row is a graph's CSR slab: src ascending with padding
    ``src == nv_pad`` at the tail, dst pad 0, w pad 0.  Original ids are
    the padded ids, so labels unpack by a prefix slice.  Rows in
    ``[n_jobs, b_pad)`` are batch padding."""

    src: np.ndarray        # [b_pad, ne_pad] int32
    dst: np.ndarray        # [b_pad, ne_pad] int32
    w: np.ndarray          # [b_pad, ne_pad] float32
    real_mask: np.ndarray  # [b_pad, nv_pad] bool (all-false on pad rows)
    constant: np.ndarray   # [b_pad] float32 1/(2m) per graph (0 on pad rows)
    row_valid: np.ndarray  # [b_pad] bool
    nv_real: np.ndarray    # [b_pad] int64 real vertex counts (0 on pad)
    ne_real: np.ndarray    # [b_pad] int64 real directed edge counts
    tw2: np.ndarray        # [b_pad] float64 total weight (2m) per graph
    nv_pad: int
    ne_pad: int
    n_jobs: int

    @property
    def b_pad(self) -> int:
        return int(self.src.shape[0])

    @property
    def slab_class(self) -> tuple:
        return (self.nv_pad, self.ne_pad)

    @property
    def pack_util(self) -> float:
        """Fraction of batch rows carrying a real job."""
        return self.n_jobs / self.b_pad


def batch_slabs(graphs, *, b_pad: int | None = None,
                slab_class: tuple | None = None) -> BatchedSlab:
    """Stack B same-class graphs into one :class:`BatchedSlab`.

    Every graph must have the same :func:`slab_class_of` (mixed classes
    raise) unless ``slab_class`` pins an explicit pow2 class that every
    graph pads up into (one too big for it raises).  ``b_pad`` pads the
    batch axis (default :func:`batch_pad`)."""
    if not graphs:
        raise ValueError("batch_slabs: empty graph list")
    classes = {slab_class_of(g) for g in graphs}
    if slab_class is not None:
        nv_pad, ne_pad = slab_class
        too_big = [c for c in sorted(classes)
                   if c[0] > nv_pad or c[1] > ne_pad]
        if too_big:
            raise ValueError(
                f"batch_slabs: graphs of classes {too_big} do not fit "
                f"the pinned slab class {tuple(slab_class)}")
    elif len(classes) > 1:
        raise ValueError(
            f"batch_slabs: mixed slab classes {sorted(classes)} -- bin "
            "jobs by slab_class_of before packing, or pin a common class "
            "via slab_class=")
    else:
        nv_pad, ne_pad = classes.pop()
    n = len(graphs)
    bp = batch_pad(n) if b_pad is None else int(b_pad)
    if bp < n:
        raise ValueError(f"b_pad={bp} < {n} jobs")

    src = np.full((bp, ne_pad), nv_pad, dtype=np.int32)
    dst = np.zeros((bp, ne_pad), dtype=np.int32)
    w = np.zeros((bp, ne_pad), dtype=np.float32)
    real_mask = np.zeros((bp, nv_pad), dtype=bool)
    constant = np.zeros(bp, dtype=np.float32)
    row_valid = np.zeros(bp, dtype=bool)
    nv_real = np.zeros(bp, dtype=np.int64)
    ne_real = np.zeros(bp, dtype=np.int64)
    tw2 = np.zeros(bp, dtype=np.float64)

    for i, g in enumerate(graphs):
        nv, ne = g.num_vertices, g.num_edges
        src[i, :ne] = np.repeat(np.arange(nv, dtype=np.int32), g.degrees())
        dst[i, :ne] = g.tails
        w[i, :ne] = g.weights
        real_mask[i, :nv] = True
        t2 = g.total_edge_weight_twice()
        if t2 <= 0:
            raise ValueError(
                f"batch_slabs: graph {i} has no edge weight (edgeless "
                "graphs are answered inline by louvain_many, not here)")
        constant[i] = np.float32(1.0 / t2)
        row_valid[i] = True
        nv_real[i] = nv
        ne_real[i] = ne
        tw2[i] = t2

    return BatchedSlab(
        src=src, dst=dst, w=w, real_mask=real_mask, constant=constant,
        row_valid=row_valid, nv_real=nv_real, ne_real=ne_real, tw2=tw2,
        nv_pad=nv_pad, ne_pad=ne_pad, n_jobs=n,
    )


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """Geometry of a batch's bucket plans: the widths kept, each width's
    common padded row count (pow2) and the heavy-residual pad."""

    widths: tuple    # kept bucket widths, ascending
    rows: tuple      # per-width common padded row count (pow2)
    heavy_pad: int   # heavy-residual slab length (pow2, >= 8)

    def fits(self, other: "BucketShape") -> bool:
        """True when every requirement of ``other`` fits inside self."""
        mine = dict(zip(self.widths, self.rows))
        return (all(w in mine and r <= mine[w]
                    for w, r in zip(other.widths, other.rows))
                and other.heavy_pad <= self.heavy_pad)


def union_shapes(a: BucketShape, b: BucketShape) -> BucketShape:
    """The smallest geometry covering both ``a`` and ``b`` (union of kept
    widths, per-width max rows, max heavy pad)."""
    rows: dict = {}
    for shape in (a, b):
        for w, r in zip(shape.widths, shape.rows):
            rows[w] = max(rows.get(w, 0), r)
    ws = tuple(sorted(rows))
    return BucketShape(widths=ws, rows=tuple(rows[w] for w in ws),
                       heavy_pad=max(a.heavy_pad, b.heavy_pad))


@dataclasses.dataclass
class BatchedBucketPlan:
    """Each batch row's host ``BucketPlan`` (pad rows: the empty plan),
    with the batch's geometry.  :meth:`fold` turns them into one plan over
    the batch's folded id space."""

    plans: list              # list[BucketPlan], one per batch row
    shape: BucketShape
    nv_pad: int

    def fold(self) -> BucketPlan:
        """One ``BucketPlan`` over ``b_pad * nv_pad`` vertices: row b's
        vertex v is ``b * nv_pad + v`` (``louvain.bucketed.fold_plans``)."""
        return fold_plans(self.plans, self.nv_pad)


def _plan_shape_req(deg: np.ndarray, widths: tuple) -> tuple:
    """(per-width padded row counts, heavy_pad) that ``BucketPlan.build``
    gives for a vertex-degree vector: the slab-free derivation behind
    :func:`bucket_shape_for`, pinned to the built plans' geometry by
    test."""
    widths_arr = np.asarray(widths, dtype=np.int64)
    rows = np.zeros(len(widths), dtype=np.int64)
    prev = 0
    for k, width in enumerate(widths):
        nb = int(np.count_nonzero((deg > prev) & (deg <= width)))
        prev = width
        if nb:
            rows[k] = 1 << int(nb - 1).bit_length() if nb > 1 else 1
    n_h = int(deg[deg > widths_arr[-1]].sum())
    heavy_pad = max(int(2 ** np.ceil(np.log2(max(n_h, 1)))), 8) if n_h else 8
    return rows, heavy_pad


def _shape_of_degrees(degs, widths: tuple) -> BucketShape:
    """The smallest :class:`BucketShape` covering the plans of every
    vertex-degree vector in ``degs`` (:func:`_plan_shape_req`)."""
    rows = np.zeros(len(widths), dtype=np.int64)
    heavy_pad = 8
    for deg in degs:
        r, h = _plan_shape_req(deg, widths)
        rows = np.maximum(rows, r)
        heavy_pad = max(heavy_pad, h)
    kept = rows > 0
    return BucketShape(
        widths=tuple(int(w) for w, k in zip(widths, kept) if k),
        rows=tuple(int(r) for r in rows[kept]),
        heavy_pad=int(heavy_pad),
    )


def bucket_shape_for(graphs, widths: tuple | None = None) -> BucketShape:
    """The common :class:`BucketShape` covering every graph of a job set,
    from vertex degrees alone (no slab or plan is built)."""
    widths = DEFAULT_BUCKETS if widths is None else tuple(widths)
    return _shape_of_degrees(
        (np.asarray(g.degrees(), dtype=np.int64) for g in graphs), widths)


def batch_bucket_shape(batch: BatchedSlab,
                       shape: BucketShape | None = None,
                       degs: list | None = None) -> BucketShape:
    """The batch's plan geometry, from its rows' vertex degrees (``degs``,
    else a bincount of each row's real rows): kept widths, per-width max
    padded rows, max heavy pad.  ``shape`` pins a geometry, which is
    returned; a batch needing a width, row count or heavy pad the shape
    lacks raises."""
    if degs is None:
        nv = batch.nv_pad
        degs = [np.bincount(batch.src[i], minlength=nv + 1)[:nv]
                for i in range(batch.b_pad)]
    need = _shape_of_degrees(degs, DEFAULT_BUCKETS)
    if shape is None:
        return need
    if not shape.fits(need):
        raise ValueError(
            f"batch needs geometry {need} which does not fit the pinned "
            f"shape {shape} -- pin a shape covering the whole job set "
            "(core.batch.bucket_shape_for)")
    return shape


def batch_bucket_plans(batch: BatchedSlab,
                       shape: BucketShape | None = None
                       ) -> BatchedBucketPlan:
    """One host :class:`BucketPlan` per batch row, and the batch's
    geometry (:func:`batch_bucket_shape` over the plans' degrees).
    ``shape`` pins a geometry; a batch needing a width, row count or heavy
    pad the shape lacks raises."""
    nv = batch.nv_pad
    plans = [BucketPlan.build(batch.src[i], batch.dst[i], batch.w[i],
                              nv_local=nv)
             for i in range(batch.b_pad)]
    shape = batch_bucket_shape(batch, shape, degs=[p.deg for p in plans])
    return BatchedBucketPlan(plans=plans, shape=shape, nv_pad=nv)


def fold_slab(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, *,
              nv_pad: int) -> tuple:
    """A batch's ``[B, ne_pad]`` slab (padding src == nv_pad) as one slab
    over ``B * nv_pad`` folded vertices: tenant b's vertex v is
    b * nv_pad + v, padding rows src == B * nv_pad.  Real rows stay in
    ascending folded order when each tenant's are ascending."""
    b = src.shape[0]
    if b * nv_pad > FOLD_ID_MAX:
        raise ValueError(
            f"fold_slab: {b} tenants of {nv_pad} vertices fold past "
            f"FOLD_ID_MAX = {FOLD_ID_MAX}: the int32 folded ids would wrap; "
            "split the batch")
    base = torch.arange(b, device=src.device)[:, None] * nv_pad
    src_f = torch.where(src < nv_pad, src + base, b * nv_pad)
    return (src_f.to(torch.int32).reshape(-1),  # graftlint: width-ok=folded ids <= b * nv_pad <= FOLD_ID_MAX (the raise above)
            (dst + base).to(torch.int32).reshape(-1), w.reshape(-1))  # graftlint: width-ok=folded ids < b * nv_pad <= FOLD_ID_MAX (the raise above)


@dataclasses.dataclass(frozen=True)
class SubRowLayout:
    """The sub-row geometry of a packed row: ``n_sub`` sub-rows of the
    class ``sub_class`` in one row of ``row_class``."""

    n_sub: int        # pow2 >= 2 sub-rows per packed row
    sub_class: tuple  # (nv_sub, ne_sub): the small class being packed

    def __post_init__(self):
        n = self.n_sub
        if n < 2 or (n & (n - 1)):
            raise ValueError(f"SubRowLayout: n_sub={n} must be a pow2 >= 2")

    @property
    def nv_sub(self) -> int:
        return int(self.sub_class[0])

    @property
    def ne_sub(self) -> int:
        return int(self.sub_class[1])

    @property
    def row_class(self) -> tuple:
        """The packed row's slab class: ``n_sub`` times the sub class in
        both dimensions."""
        return (self.n_sub * self.nv_sub, self.n_sub * self.ne_sub)

    def vertex_offset(self, s: int) -> int:
        return s * self.nv_sub

    def edge_offset(self, s: int) -> int:
        return s * self.ne_sub

    def vertex_fences(self) -> tuple:
        """The ``n_sub + 1`` vertex-id seams; sub-row ``s`` owns the ids
        ``[fences[s], fences[s+1])``, and its community ids stay inside
        them at every phase."""
        return tuple(s * self.nv_sub for s in range(self.n_sub + 1))


def subrow_layout_for(sub_class: tuple,
                      row_class: tuple) -> SubRowLayout | None:
    """The layout packing ``sub_class`` rows into ``row_class`` rows, or
    None unless the classes are an exact pow2 ratio >= 2 in both
    dimensions."""
    nv_s, ne_s = sub_class
    nv_r, ne_r = row_class
    if nv_s <= 0 or ne_s <= 0 or nv_r % nv_s or ne_r % ne_s:
        return None
    n = nv_r // nv_s
    if n < 2 or (n & (n - 1)) or ne_r // ne_s != n:
        return None
    return SubRowLayout(n_sub=n, sub_class=(int(nv_s), int(ne_s)))


@dataclasses.dataclass
class PackedSubRows:
    """B packed rows of ``layout.row_class``, each holding up to
    ``layout.n_sub`` small-class graphs at the layout's offsets.

    The slab follows :class:`BatchedSlab` at the row class (src padding
    == row nv_pad, dst and w padding 0); everything per graph is
    ``[b_pad, n_sub]``.  Job j sits at ``(j // n_sub, j % n_sub)``."""

    src: np.ndarray        # [b_pad, ne_pad] int32 (row class)
    dst: np.ndarray        # [b_pad, ne_pad] int32
    w: np.ndarray          # [b_pad, ne_pad] float32
    real_mask: np.ndarray  # [b_pad, nv_pad] bool
    constants: np.ndarray  # [b_pad, n_sub] f32 1/(2m) (0 on empty ones)
    sub_valid: np.ndarray  # [b_pad, n_sub] bool
    nv_real: np.ndarray    # [b_pad, n_sub] int64
    ne_real: np.ndarray    # [b_pad, n_sub] int64
    tw2: np.ndarray        # [b_pad, n_sub] float64
    layout: SubRowLayout
    n_jobs: int

    @property
    def b_pad(self) -> int:
        return int(self.src.shape[0])

    @property
    def nv_pad(self) -> int:
        return int(self.layout.row_class[0])

    @property
    def ne_pad(self) -> int:
        return int(self.layout.row_class[1])

    @property
    def slab_class(self) -> tuple:
        return self.layout.row_class

    @property
    def row_valid(self) -> np.ndarray:
        return self.sub_valid.any(axis=1)

    @property
    def pack_util(self) -> float:
        """Fraction of batch rows carrying at least one real job."""
        return float(self.row_valid.sum()) / max(self.b_pad, 1)

    @property
    def subrow_util(self) -> float:
        """Real graphs over the batch's sub-row capacity."""
        return self.n_jobs / max(self.b_pad * self.layout.n_sub, 1)


def pack_subrows(graphs, layout: SubRowLayout, *,
                 b_pad: int | None = None) -> PackedSubRows:
    """Pack small-class graphs into sub-rows of ``layout.row_class`` rows
    (job j -> row ``j // n_sub``, sub-row ``j % n_sub``).

    Every graph must fit ``layout.sub_class``.  Each sub-row is the
    graph's own single-shard slab at the sub class, its vertex ids
    shifted by ``vertex_offset(s)`` and its padding rows renamed to the
    row's sentinel (src == row nv_pad)."""
    if not graphs:
        raise ValueError("pack_subrows: empty graph list")
    nv_sub, ne_sub = layout.sub_class
    nv_pad, ne_pad = layout.row_class
    n_sub = layout.n_sub
    too_big = [c for c in sorted({slab_class_of(g) for g in graphs})
               if c[0] > nv_sub or c[1] > ne_sub]
    if too_big:
        raise ValueError(
            f"pack_subrows: graphs of classes {too_big} do not fit the "
            f"sub class {layout.sub_class}")

    n = len(graphs)
    rows = -(-n // n_sub)
    bp = batch_pad(rows) if b_pad is None else int(b_pad)
    if bp < rows:
        raise ValueError(f"pack_subrows: b_pad={bp} < {rows} packed rows")
    src = np.full((bp, ne_pad), nv_pad, dtype=np.int32)
    dst = np.zeros((bp, ne_pad), dtype=np.int32)
    w = np.zeros((bp, ne_pad), dtype=np.float32)
    real_mask = np.zeros((bp, nv_pad), dtype=bool)
    constants = np.zeros((bp, n_sub), dtype=np.float32)
    sub_valid = np.zeros((bp, n_sub), dtype=bool)
    nv_real = np.zeros((bp, n_sub), dtype=np.int64)
    ne_real = np.zeros((bp, n_sub), dtype=np.int64)
    tw2 = np.zeros((bp, n_sub), dtype=np.float64)

    for j, g in enumerate(graphs):
        i, s = j // n_sub, j % n_sub
        nv, ne = g.num_vertices, g.num_edges
        voff, eoff = layout.vertex_offset(s), layout.edge_offset(s)
        # Real edges shift into the sub-row's fence interval; the
        # sub-row's padding keeps the row sentinel and dst = w = 0.
        src[i, eoff:eoff + ne] = np.repeat(
            np.arange(nv, dtype=np.int32), g.degrees()) + np.int32(voff)
        dst[i, eoff:eoff + ne] = g.tails.astype(np.int32) + np.int32(voff)
        w[i, eoff:eoff + ne] = g.weights
        real_mask[i, voff:voff + nv] = True
        t2 = g.total_edge_weight_twice()
        if t2 <= 0:
            raise ValueError(
                f"pack_subrows: graph {j} has no edge weight (edgeless "
                "graphs are answered inline, as in louvain_many)")
        constants[i, s] = np.float32(1.0 / t2)
        sub_valid[i, s] = True
        nv_real[i, s] = nv
        ne_real[i, s] = ne
        tw2[i, s] = t2

    return PackedSubRows(
        src=src, dst=dst, w=w, real_mask=real_mask, constants=constants,
        sub_valid=sub_valid, nv_real=nv_real, ne_real=ne_real, tw2=tw2,
        layout=layout, n_jobs=n,
    )


def unpack_subrows(packed: PackedSubRows, comm_all: np.ndarray,
                   prev_mod: np.ndarray) -> list:
    """Each job's ``(labels int64 [nv_real], Q)`` from a packed run's
    final state: ``comm_all`` [b_pad, nv_pad] composed labels at the
    pack-time offsets and ``prev_mod`` [b_pad, n_sub] per-sub-row Q.
    A job's labels are its sub-row's slice minus the vertex offset."""
    out = []
    lay = packed.layout
    for j in range(packed.n_jobs):
        i, s = j // lay.n_sub, j % lay.n_sub
        voff = lay.vertex_offset(s)
        nv = int(packed.nv_real[i, s])
        labels = np.asarray(
            comm_all[i, voff:voff + nv], dtype=np.int64) - voff
        out.append((labels, float(prev_mod[i, s])))
    return out
