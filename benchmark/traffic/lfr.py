"""The LFR benchmark graph (Lancichinetti, Fortunato and Radicchi, Phys.
Rev. E 78, 046110, 2008, section II), vectorized in NumPy.

For N vertices, average degree <k>, maximum degree kmax, exponents tau1
(degrees) and tau2 (community sizes), mixing mu and community sizes in
[smin, smax]:

1. degrees from a power law of exponent tau1 on [kmin, kmax], kmin solved
   so that the mean is <k>, rounded stochastically to integers;
2. community sizes from a power law of exponent tau2 on [smin, smax],
   drawn until they cover N;
3. each vertex's internal degree is (1 - mu) of its degree (rounded
   stochastically); vertices are dealt to communities at random, then a
   vertex whose internal degree does not fit its community (k_in > s - 1)
   swaps with a random vertex of a community large enough that fits its
   own, as the paper's homeless vertices move until each has a home;
4. each community is wired by the configuration model on its members'
   internal degrees, and the external half-edges by a configuration model
   over the whole graph; a pair that is a self-loop, repeats an edge, or
   (external) joins one community, is rewired with a random pair of the
   same group, for a few rounds, and any still left is erased;
5. the vertex ids are permuted, and the edges handed over in a drawn order
   and with drawn directions, each undirected edge once.

Graph k of a run's pool comes from ``seeds.graph_seed(seed, k)``: the run's
seed draws every graph.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.traffic.seeds import graph_seed

REWIRE_ROUNDS = 8


def _power_mean(lo: float, hi: float, tau: float) -> float:
    """Mean of the density proportional to x^-tau on [lo, hi]."""
    def integral(p):               # integral of x^p over [lo, hi]
        if abs(p + 1.0) < 1e-12:
            return math.log(hi / lo)
        return (hi ** (p + 1.0) - lo ** (p + 1.0)) / (p + 1.0)
    return integral(1.0 - tau) / integral(-tau)


def solve_kmin(mean: float, kmax: float, tau: float) -> float:
    """The lower end of the degree power law whose mean is ``mean``."""
    lo, hi = 1e-9, float(kmax)
    if not _power_mean(lo, kmax, tau) < mean < kmax:
        raise ValueError(f"no power law on [k, {kmax}] has mean {mean}")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _power_mean(mid, kmax, tau) < mean:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def power_draw(rng, n: int, lo: float, hi: float, tau: float) -> np.ndarray:
    """``n`` draws of the density proportional to x^-tau on [lo, hi]."""
    u = rng.random(n)
    if abs(tau - 1.0) < 1e-12:
        return lo * (hi / lo) ** u
    a, b = lo ** (1.0 - tau), hi ** (1.0 - tau)
    return (a + u * (b - a)) ** (1.0 / (1.0 - tau))


def stochastic_round(rng, x: np.ndarray) -> np.ndarray:
    base = np.floor(x)
    return (base + (rng.random(len(x)) < x - base)).astype(np.int64)


def community_sizes(rng, n: int, smin: int, smax: int,
                    tau2: float) -> np.ndarray:
    """Sizes in [smin, smax] that sum to ``n``."""
    sizes = np.zeros(0, dtype=np.int64)
    while sizes.sum() < n:
        more = np.floor(power_draw(rng, max(n // smin, 16), smin, smax + 1,
                                   tau2)).astype(np.int64)
        sizes = np.concatenate([sizes, np.minimum(more, smax)])
    cut = int(np.searchsorted(np.cumsum(sizes), n)) + 1
    sizes = sizes[:cut]
    rest = n - int(sizes[:-1].sum())
    if rest >= smin:
        sizes[-1] = rest
        return sizes
    # Too little for a community of its own: one vertex at a time to a
    # random community below smax.
    sizes = sizes[:-1]
    for _ in range(rest):
        sizes[rng.choice(np.flatnonzero(sizes < smax))] += 1
    return sizes


def assign(rng, k_in: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Community of each vertex, with k_in <= size - 1 wherever the sizes
    allow it.  A vertex left over has its internal degree cut to fit."""
    n = len(k_in)
    comm = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    cap = sizes - 1
    for _ in range(64):
        bad = np.flatnonzero(k_in > cap[comm])
        if len(bad) == 0:
            break
        # Each homeless vertex draws a vertex of a community large enough.
        target = rng.integers(0, n, size=len(bad) * 4)
        src = np.repeat(bad, 4)
        ok = ((k_in[src] <= cap[comm[target]])
              & (k_in[target] <= cap[comm[src]]))
        src, target = src[ok], target[ok]
        # One swap a vertex, on either side.
        _, first = np.unique(src, return_index=True)
        src, target = src[first], target[first]
        _, first = np.unique(target, return_index=True)
        src, target = src[first], target[first]
        keep = ~np.isin(target, src)
        src, target = src[keep], target[keep]
        comm[src], comm[target] = comm[target], comm[src].copy()
    np.minimum(k_in, cap[comm], out=k_in)
    return comm


def _bad_pairs(a: np.ndarray, b: np.ndarray, n: int,
               comm: np.ndarray | None) -> np.ndarray:
    """Pairs that are self-loops, repeat another pair (all but one of
    each repeated edge), or (with ``comm``) join one community."""
    key = np.minimum(a, b) * n + np.maximum(a, b)
    order = np.argsort(key)
    ks = key[order]
    bad = np.zeros(len(a), dtype=bool)
    bad[order[1:][ks[1:] == ks[:-1]]] = True
    bad |= a == b
    if comm is not None:
        bad |= comm[a] == comm[b]
    return bad


def _shuffle_within(rng, group: np.ndarray) -> np.ndarray:
    """An order that sorts by ``group`` and shuffles inside each group."""
    return np.argsort((group << 32)
                      | rng.integers(0, 1 << 32, size=len(group)))


def pair_stubs(rng, group: np.ndarray, node: np.ndarray, n: int,
               comm: np.ndarray | None = None) -> tuple:
    """The configuration model inside each group: half-edges ``node`` of
    group ``group`` (an even count a group) paired at random.  Bad pairs
    are rewired with a random pair of their group for
    ``REWIRE_ROUNDS`` rounds; those still bad are erased."""
    order = _shuffle_within(rng, group)
    group, node = group[order], node[order]
    a, b, g = node[0::2].copy(), node[1::2].copy(), group[0::2]
    starts = np.searchsorted(g, g, side="left")
    ends = np.searchsorted(g, g, side="right")
    for _ in range(REWIRE_ROUNDS):
        bad = np.flatnonzero(_bad_pairs(a, b, n, comm))
        if len(bad) == 0:
            break
        other = starts[bad] + np.floor(
            rng.random(len(bad)) * (ends[bad] - starts[bad])).astype(np.int64)
        free = np.unique(np.concatenate([bad, other]))
        stubs_g = np.concatenate([g[free], g[free]])
        stubs_n = np.concatenate([a[free], b[free]])
        stubs_n = stubs_n[_shuffle_within(rng, stubs_g)]
        # ``free`` is sorted, so are its groups: the re-paired stubs go
        # back to the same groups' slots.
        a[free], b[free] = stubs_n[0::2], stubs_n[1::2]
    keep = ~_bad_pairs(a, b, n, comm)
    return a[keep], b[keep]


def _even_per_group(rng, group: np.ndarray, count: np.ndarray) -> None:
    """Drop one half-edge from each group whose total is odd, from a
    random vertex of the group that has one (in place on ``count``)."""
    tot = np.bincount(group, weights=count, minlength=group.max() + 1)
    for g in np.flatnonzero(tot.astype(np.int64) % 2):
        members = np.flatnonzero((group == g) & (count > 0))
        count[rng.choice(members)] -= 1


def planted(rng, cfg: dict) -> tuple:
    """(nv, src, dst, comm) int64 of one graph before its vertex ids are
    permuted: each undirected edge once, ``comm`` each vertex's
    community."""
    n = int(cfg["vertices"])
    kmax, tau1, mu = int(cfg["max_degree"]), float(cfg["tau1"]), \
        float(cfg["mu"])
    kmin = solve_kmin(float(cfg["average_degree"]), kmax, tau1)
    deg = np.minimum(stochastic_round(
        rng, power_draw(rng, n, kmin, kmax, tau1)), kmax)
    deg = np.maximum(deg, 1)
    k_in = stochastic_round(rng, (1.0 - mu) * deg)
    sizes = community_sizes(rng, n, int(cfg["min_community"]),
                            int(cfg["max_community"]), float(cfg["tau2"]))
    comm = assign(rng, k_in, sizes)
    k_out = deg - k_in
    _even_per_group(rng, comm, k_in)
    _even_per_group(rng, np.zeros(n, dtype=np.int64), k_out)
    vid = np.arange(n, dtype=np.int64)
    ia, ib = pair_stubs(rng, np.repeat(comm, k_in), np.repeat(vid, k_in), n)
    ea, eb = pair_stubs(rng, np.zeros(int(k_out.sum()), dtype=np.int64),
                        np.repeat(vid, k_out), n, comm)
    return n, np.concatenate([ia, ea]), np.concatenate([ib, eb]), comm


def lfr_graph(cfg: dict, seed: int) -> tuple:
    """(nv, src, dst) int64 of one graph, its vertex ids permuted, its
    edges in a drawn order and with drawn directions."""
    rng = np.random.default_rng(seed)
    n, src, dst, _ = planted(rng, cfg)
    perm = rng.permutation(n)
    order = rng.permutation(len(src))
    flip = rng.random(len(src)) < 0.5
    src, dst = perm[src][order], perm[dst][order]
    return n, np.where(flip, dst, src), np.where(flip, src, dst)


def generate_pool(cfg: dict, count: int, seed: int) -> list:
    """``count`` graphs [(nv, src, dst)], graph k drawn from
    ``graph_seed(seed, k)``."""
    return [lfr_graph(cfg, graph_seed(seed, k)) for k in range(count)]
