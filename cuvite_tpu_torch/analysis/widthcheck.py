"""Tier 6 (static half) -- index-width and overflow analysis of the port
(R026-R028; port of ``cuvite_tpu/analysis/widthcheck.py``).

The largest declared workloads (Friendster's 1.8 B undirected edges,
R-MAT scale 28) put the directed slab and 2m past 2^31.  The port keeps
vertex ids, community ids and slab rows in int32 and widens where a
value can pass 2^31 (run ids, compaction counts and the packed sort key
are int64; Q is summed in f64).  A silent int32 wrap in a cumsum, a
degree sum or a packed key gives wrong labels, not a crash.  This module
is the static half; ``analysis/widthaudit.py`` runs the dynamic half
(W001-W003) over the real entries.

**The interval model.**  A small forward abstract interpreter runs over
every function of the device-path modules (``ops/``, ``coarsen/``,
``louvain/``, ``kernels/``, ``core/``).  Each value carries
``(bound, extent, int32, wide)``:

* ``bound`` -- a symbolic upper bound on the VALUE, a JSON expression
  tree over the workload symbols (``nv_pad``, ``ne_pad``, ``nv_total``,
  ``kbits``, ``sbits``, ``B``, ``two_m``);
* ``extent`` -- a symbolic upper bound on the tensor LENGTH (the number
  of addends a reduction over it accumulates);
* ``int32`` -- the value demonstrably flows through an int32 dtype:
  ``dtype=torch.int32``, ``.int()``, ``.to(torch.int32)``,
  ``.astype(np.int32)``, ``torch.tensor(..., dtype=torch.int32)``;
* ``wide`` -- the value demonstrably flows through int64 (``.long()``,
  ``.to(torch.int64)``, ``dtype=torch.int64``).

**Torch's reductions.**  ``torch.cumsum``, ``.sum()`` and
``torch.bincount`` of an int32 tensor return int64 unless
``dtype=torch.int32`` is passed (numpy's do the same), so a reduction
accumulates in int32 only under that ``dtype=`` or when its result is
cast to int32 at once (``torch.cumsum(m, 0).int()``): the cast wraps
just the same, and is recorded as the reduction site.  ``x << k`` keeps
its operand's dtype.

**The symbol table.**  Bounds are seeded from names, the code's real
contract surface: parameters called ``nv_pad``/``nc``/``num_segments``
bound at ``nv_pad``, ``ne_pad`` at ``ne_pad``, edge-slab tensors
(``src``/``dst``/``ckey``/``w``...) get extent ``ne_pad`` and vertex-id
bound ``nv_pad``, per-vertex tensors (``comm``/``vdeg``/``lab``...) get
extent ``nv_pad``.  Unknown names stay unknown: a bounded false negative,
never a false positive.

**Eligibility predicates refine the bounds.**  A leading
``if ne_pad > SLAB_NE_MAX: raise`` guard refines the symbol's bound for
the rest of the function, and so does a call of a module helper whose
body opens with that guard on its parameter (``_check_slab(ne, ...)``
in ``ops/segment.py``).  A packing site is TIED to its guard when an
enclosing ``if`` predicate, or a prologue ``if ...: raise`` /
``if ...: return`` that routes the ineligible shapes away before it,
mentions the bit-budget names (one level of assignment expanded).  The
rules:

* **R026** -- int32-typed arithmetic whose symbolic bound exceeds
  2^31 - 1 at the registry's declared max workload (:data:`MAX_WORKLOAD`,
  pinned against ``workloads/registry.max_workload()`` by tier-1),
  unless guarded by an eligibility predicate or carrying
  ``# graftlint: width-ok=<reason>`` (the closed inventory,
  ``python -m cuvite_tpu_torch.tools.width_audit --inventory``).
* **R027** -- bit-packing sites (a shifted field or-ed into a key)
  whose bit budget is not provably tied to the guard gating them.  An
  int64 pack is held to 2^63 - 1, any other to 2^31 - 1; an unknown
  bound fails closed.
* **R028** -- ``cumsum``/``sum``/``bincount`` reductions over
  ``ne_pad``-extent tensors accumulating in int32 (above): the
  run-id/compaction-offset class.

Facts ride the tier-2 summary (and so the incremental lint cache) under
the ``"width"`` key; the dynamic W00x results are never cached.  Stdlib
only, like the other static tiers.
"""

from __future__ import annotations

import ast
import re

from cuvite_tpu_torch.analysis.engine import Finding, SourceFile, dotted, register

WIDTH_SUMMARY_VERSION = 1

INT32_MAX = (1 << 31) - 1
INT64_MAX = (1 << 63) - 1

# The registry's declared max workload, in symbols (tier-1 pins this
# dict == workloads/registry.max_workload(); the static tier itself
# stays stdlib-only so linting never imports torch/numpy):
#   nv_pad/nv_total — R-MAT scale-28 vertex space (2^28 ids, already
#     pow2 so padding is the identity; Friendster pads to 2^27);
#   ne_pad — the directed edge slab ceiling (Friendster's 3.61 B
#     directed rows and the scale-28 synth law's 16 * 2^28 both pad to
#     2^32);
#   two_m — total directed weight mass ceiling (unit weights make it
#     ne_pad; 2^33 leaves headroom for small integer weights);
#   kbits/sbits — the packed-sort bit budget at that vertex space
#     (key_bound = nv_pad -> 28 bits, src_bound = nv_pad + 1 -> 29);
#   B — the serving batch-ladder ceiling (core/batch.BATCH_SIZES).
MAX_WORKLOAD = {
    "nv_pad": 1 << 28,
    "nv_total": 1 << 28,
    "ne_pad": 1 << 32,
    "two_m": 1 << 33,
    "kbits": 28,
    "sbits": 29,
    "B": 64,
}

# Device-path modules the interpreter runs over (everything traced onto
# the chip plus the host-side plan/batch math that feeds it).  The
# serve/, obs/, comm/ and workloads/ layers hold no index arithmetic at
# slab extent.
WIDTH_PATH_PREFIXES = (
    "cuvite_tpu_torch/ops/",
    "cuvite_tpu_torch/coarsen/",
    "cuvite_tpu_torch/louvain/",
    "cuvite_tpu_torch/kernels/",
    "cuvite_tpu_torch/core/",
)

_WIDTH_OK_RE = re.compile(r"#\s*graftlint:\s*width-ok\s*=\s*(.+?)\s*$")

# Parameter names whose VALUE is bounded by a workload symbol.
PARAM_BOUND_SYMBOLS = {
    "nv_pad": "nv_pad",
    "nv_total": "nv_total",
    "nc": "nv_pad",
    "num_segments": "nv_pad",
    "ne_pad": "ne_pad",
    "kbits": "kbits",
    "sbits": "sbits",
    "key_bound": "nv_pad",
    "src_bound": "nv_pad",
    "id_bound": "nv_pad",
    "sentinel": "nv_pad",
    "b": "B",
}

# Array parameter names -> (value-bound symbol or None, extent symbol).
# Suffixed spellings (src_s, w_s, dst2) normalize to the base name.
ARRAY_PARAM_SYMBOLS = {
    "src": ("nv_pad", "ne_pad"),
    "dst": ("nv_pad", "ne_pad"),
    "ckey": ("nv_pad", "ne_pad"),
    "w": (None, "ne_pad"),
    "weights": (None, "ne_pad"),
    "starts": (None, "ne_pad"),
    "emit": (None, "ne_pad"),
    "comm": ("nv_pad", "nv_pad"),
    "labels": ("nv_pad", "nv_pad"),
    "lab": ("nv_pad", "nv_pad"),
    "vdeg": (None, "nv_pad"),
    "deg": (None, "nv_pad"),
    "present": (None, "nv_pad"),
    "sizes": ("nv_pad", "nv_pad"),
}

_REDUCTION_CALLS = {"cumsum", "cumulative_sum", "sum", "bincount"}
_MINMAX_CALLS = {"minimum", "min", "maximum", "max"}
_ALLOC_CALLS = {"zeros", "ones", "full", "empty"}
_LIKE_CALLS = {"zeros_like", "ones_like", "full_like", "empty_like"}
# Methods that keep a tensor's values and length (views, copies, clamps).
_PASS_METHODS = {"reshape", "ravel", "flatten", "copy", "clip", "clamp",
                 "view", "contiguous", "clone", "squeeze", "unsqueeze",
                 "expand", "detach", "masked_fill", "masked_fill_"}
_INT32_NAMES = ("int32", "int16", "int8", "uint32", "uint16", "uint8")
_INT64_NAMES = ("int64", "long", "uint64")

_SITE_PRIORITY = {"arith": 0, "reduction": 1, "pack": 2}

_DIGITS = "0123456789"


# ---------------------------------------------------------------------------
# Symbolic expressions: JSON-serializable nested lists.
#   ["n", 7]  ["s", "ne_pad"]  ["+", a, b]  ["*", a, b]  ["min", a, b]
#   ["max", a, b]  ["<<", a, k]  [">>", a, k]  ["bits", a]
# All values are assumed non-negative (ids, counts, offsets), which is
# what makes + an upper bound for | and the left operand one for -.


def _n(v) -> list:
    return ["n", int(v)]


def _s(name: str) -> list:
    return ["s", name]


def sym_eval(expr, env: dict):
    """Evaluate a bound expression at ``env``; None when any symbol is
    unknown (the bounded-false-negative answer)."""
    if expr is None:
        return None
    tag = expr[0]
    if tag == "n":
        return int(expr[1])
    if tag == "s":
        v = env.get(expr[1])
        return None if v is None else int(v)
    args = [sym_eval(a, env) for a in expr[1:]]
    if any(a is None for a in args):
        return None
    if tag == "+":
        return sum(args)
    if tag == "*":
        p = 1
        for a in args:
            p *= a
        return p
    if tag == "min":
        return min(args)
    if tag == "max":
        return max(args)
    if tag == "<<":
        return args[0] * (2 ** max(args[1], 0))
    if tag == ">>":
        return args[0] // (2 ** max(args[1], 0))
    if tag == "bits":
        return max(args[0], 1).bit_length()
    return None


def sym_symbols(expr) -> set:
    """The workload symbols an expression mentions."""
    out: set = set()
    if not isinstance(expr, list) or not expr:
        return out
    if expr[0] == "s":
        out.add(expr[1])
        return out
    for sub in expr[1:]:
        if isinstance(sub, list):
            out |= sym_symbols(sub)
    return out


def sym_render(expr) -> str:
    """Human form for findings: ``(nv_pad << kbits) + nv_pad``."""
    if expr is None:
        return "?"
    tag = expr[0]
    if tag == "n":
        return str(expr[1])
    if tag == "s":
        return str(expr[1])
    args = [sym_render(a) for a in expr[1:]]
    if tag == "bits":
        return f"bits({args[0]})"
    if tag in ("min", "max"):
        return f"{tag}({', '.join(args)})"
    return "(" + f" {tag} ".join(args) + ")"


class AVal:
    """One abstract value: (symbolic value bound, symbolic extent,
    int32-typed flag, int64-typed flag).  ``None`` bound/extent means
    unknown."""

    __slots__ = ("bound", "extent", "int32", "wide")

    def __init__(self, bound=None, extent=None, int32=False, wide=False):
        self.bound = bound
        self.extent = extent
        self.int32 = bool(int32)
        self.wide = bool(wide) and not self.int32


_UNKNOWN = AVal()


def _max_bound(a, b):
    if a is None or b is None:
        return None
    return ["max", a, b]


def _sum_bound(a, b):
    if a is None or b is None:
        return None
    return ["+", a, b]


def _first_extent(*vals):
    for v in vals:
        if v is not None and v.extent is not None:
            return v.extent
    return None


def _last(name: str | None) -> str:
    return name.split(".")[-1] if name else ""


def _dtype_last(node: ast.AST | None) -> str:
    if node is None:
        return ""
    name = dotted(node)
    if name is None and isinstance(node, ast.Constant) \
            and isinstance(node.value, str):
        name = node.value
    if not name:
        return ""
    if name == "torch.int":
        return "int32"          # torch.int is int32
    return name.split(".")[-1]


def _is_int32_dtype_expr(node: ast.AST | None) -> bool:
    """Does a dtype expression demonstrably denote a 32-bit-or-narrower
    integer (torch.int32 / torch.int / np.int32 / "int32" / int16/int8
    variants)?"""
    return _dtype_last(node) in _INT32_NAMES


def _is_int64_dtype_expr(node: ast.AST | None) -> bool:
    """torch.int64 / torch.long / np.int64 / "int64"."""
    return _dtype_last(node) in _INT64_NAMES


def _width_ok_lines(sf: SourceFile) -> dict:
    """{lineno: reason} for every ``# graftlint: width-ok=`` pragma
    (real comment tokens, the replicated-ok discipline)."""
    out: dict = {}
    for lineno, comment in sf._iter_comments():
        if "width-ok" not in comment:
            continue
        m = _WIDTH_OK_RE.search(comment)
        if m:
            out[lineno] = m.group(1)
    return out


def _module_int_consts(sf: SourceFile) -> dict:
    """Module-level ``NAME = <int expr>`` constants, with shift/arith
    folding (``SLAB_NE_MAX = 1 << 30``) — the raise-guard ceilings."""
    out: dict = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = _const_int(node.value, out)
            if v is not None:
                out[node.targets[0].id] = v
    return out


def _const_int(node: ast.AST, consts: dict):
    """Fold an int-constant expression (Constant / module const Name /
    +-*<< BinOp over those); None when not statically an int."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, int) \
            and not isinstance(node.value, bool) else None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.BinOp):
        lo = _const_int(node.left, consts)
        hi = _const_int(node.right, consts)
        if lo is None or hi is None:
            return None
        if isinstance(node.op, ast.LShift):
            return lo << hi
        if isinstance(node.op, ast.Add):
            return lo + hi
        if isinstance(node.op, ast.Sub):
            return lo - hi
        if isinstance(node.op, ast.Mult):
            return lo * hi
        if isinstance(node.op, ast.Pow) and 0 <= hi <= 64:
            return lo ** hi
    return None


def _is_module_receiver(node: ast.AST) -> bool:
    """Does ``node`` name a module (``torch.cumsum(x)`` is a function of
    x, ``x.cumsum(0)`` a method of x)?"""
    name = dotted(node)
    return bool(name) and name.split(".")[0] in ("torch", "np", "numpy")


def _cast_of(attr: str, node: ast.Call, kwargs: dict) -> str | None:
    """What a method call does to its receiver's dtype: "int32", "wide"
    (int64), "float", "keep" (``.to(device)``, ``.to(x.dtype)``), or None
    for a method that is no cast."""
    if attr == "int":
        return "int32"
    if attr == "long":
        return "wide"
    if attr in ("float", "double", "half", "bfloat16", "bool"):
        return "float"
    if attr not in ("to", "astype", "type"):
        return None
    dtypes = [a for a in node.args if _dtype_last(a)] \
        + ([kwargs["dtype"]] if "dtype" in kwargs else [])
    for d in dtypes:
        if _is_int32_dtype_expr(d):
            return "int32"
        if _is_int64_dtype_expr(d):
            return "wide"
        if _dtype_last(d).startswith(("float", "bool", "double", "half")):
            return "float"
    return "keep"


def _module_raise_guards(sf: SourceFile, consts: dict) -> dict:
    """{function name: (parameter index, ceiling)} for the module's
    top-level helpers whose body opens (after a docstring) with
    ``if PARAM > CEIL: raise`` -- a guard every caller inherits."""
    out: dict = {}
    for fn in sf.tree.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        body = fn.body
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(getattr(body[0], "value", None),
                               ast.Constant):
            body = body[1:]
        if not body or not isinstance(body[0], ast.If):
            continue
        st = body[0]
        test = st.test
        if not (len(st.body) == 1 and isinstance(st.body[0], ast.Raise)
                and isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.Gt, ast.GtE))
                and isinstance(test.left, ast.Name)):
            continue
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        if test.left.id not in params:
            continue
        ceil = _const_int(test.comparators[0], consts)
        if ceil is None:
            continue
        if isinstance(test.ops[0], ast.GtE):
            ceil -= 1
        out[fn.name] = (params.index(test.left.id), ceil)
    return out


def _seed_aval(name: str) -> AVal | None:
    key = name if name in PARAM_BOUND_SYMBOLS \
        or name in ARRAY_PARAM_SYMBOLS \
        else name.split("_")[0].rstrip(_DIGITS)
    if key in PARAM_BOUND_SYMBOLS:
        return AVal(bound=_s(PARAM_BOUND_SYMBOLS[key]))
    if key in ARRAY_PARAM_SYMBOLS:
        bsym, esym = ARRAY_PARAM_SYMBOLS[key]
        return AVal(bound=_s(bsym) if bsym else None, extent=_s(esym))
    return None


def _names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# ---------------------------------------------------------------------------
# The per-function interpreter.


class _FnInterp:
    """Forward abstract interpretation of ONE function body, recording
    width hazard sites.  Statements are walked in order; ``if X: raise``
    prologue guards refine symbol bounds for the remainder; enclosing
    ``if`` predicates stack onto every recorded site."""

    def __init__(self, sf: SourceFile, info, consts: dict,
                 width_ok: dict, sites: list, helpers: dict | None = None):
        self.sf = sf
        self.info = info
        self.consts = consts
        self.width_ok = width_ok
        self.sites = sites
        self.helpers = helpers or {}
        self.env: dict = {}
        self.refined: dict = {}
        self.guards: list = []
        # ``if P: raise`` / ``if P: return fallback(...)`` before a site:
        # the rest of the block runs only where P is false, so P gates
        # the packs after it (R027's tie; never R026/R028's guard).
        self.prologue: list = []
        self.assign_text: dict = {}
        self.bitlen_bases: dict = {}
        for p in info.params:
            seeded = _seed_aval(p)
            if seeded is not None:
                self.env[p] = seeded
        # Pre-pass: one-level guard expansion text and bit_length
        # derivation bases ("kbits = max(key_bound - 1, 1).bit_length()"
        # -> kbits derives from key_bound).
        for node in ast.walk(info.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
                try:
                    self.assign_text[tgt] = ast.unparse(node.value)
                except Exception:
                    pass
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == "bit_length":
                        self.bitlen_bases.setdefault(tgt, set()).update(
                            _names_in(sub.func.value))

    # -- recording ----------------------------------------------------

    def _record(self, node: ast.AST, kind: str, bound, *, extent=None,
                shift=(), int32=False, wide=False):
        line = getattr(node, "lineno", 1)
        site = {
            "fn": self.info.name,
            "line": line,
            "snippet": self.sf.line(line),
            "kind": kind,
            "bound": bound,
            "extent": extent,
            "shift": sorted(shift),
            "guards": list(self.guards),
            "tied": self._tied(shift) if kind == "pack" else False,
            "refined": dict(self.refined),
            "width_ok": self.width_ok.get(line),
            "int32": bool(int32),
            "wide": bool(wide) and not int32,
        }
        for i, prev in enumerate(self.sites):
            if prev["line"] == line and prev["fn"] == self.info.name:
                # One site a line: the higher-priority kind, and of one
                # kind the wider bound (``(x.int() * n).int()`` keeps the
                # product, not the cast of x).
                pk, nk = _SITE_PRIORITY[prev["kind"]], _SITE_PRIORITY[kind]
                if nk > pk or (nk == pk and _wider(site, prev)):
                    self.sites[i] = site
                return
        self.sites.append(site)

    def _tied(self, shift_names) -> bool:
        """Is a pack's bit budget provably tied to a gating predicate?
        True when an enclosing guard (one-level expanded) mentions a
        shift-amount name, one of its ``bit_length`` base names, or any
        ``bit_length`` call — or when a prologue raise-guard already
        refined a symbol the shift amount derives from."""
        names = set(shift_names)
        for nm in list(names):
            names |= self.bitlen_bases.get(nm, set())
        texts = []
        for g in self.guards + self.prologue:
            texts.append(g)
            for nm in _names_in_text(g):
                if nm in self.assign_text:
                    texts.append(self.assign_text[nm])
        for t in texts:
            if "bit_length" in t:
                return True
            toks = _names_in_text(t)
            if toks & names:
                return True
        for nm in names:
            seeded = self.env.get(nm) or _seed_aval(nm)
            if seeded is not None and seeded.bound is not None:
                if sym_symbols(seeded.bound) & set(self.refined):
                    return True
        return False

    # -- statements ---------------------------------------------------

    def run(self):
        self._stmts(self.info.node.body)

    def _stmts(self, body):
        depth = len(self.prologue)
        try:
            self._body(body)
        finally:
            del self.prologue[depth:]

    def _body(self, body):
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs get their own pass
            if isinstance(st, ast.If):
                self._if(st)
            elif isinstance(st, (ast.For, ast.While)):
                if isinstance(st, ast.For):
                    self._assign_target(st.target, self._eval(st.iter))
                else:
                    self._eval(st.test)
                self._stmts(st.body)
                self._stmts(st.orelse)
            elif isinstance(st, ast.With):
                self._stmts(st.body)
            elif isinstance(st, ast.Try):
                self._stmts(st.body)
                for h in st.handlers:
                    self._stmts(h.body)
                self._stmts(st.orelse)
                self._stmts(st.finalbody)
            elif isinstance(st, ast.Assign):
                val = self._eval(st.value)
                for t in st.targets:
                    self._assign_target(t, val, value_node=st.value)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                self._assign_target(st.target, self._eval(st.value))
            elif isinstance(st, ast.AugAssign):
                self._eval(st.value)
                if isinstance(st.target, ast.Name):
                    self.env[st.target.id] = _UNKNOWN
            elif isinstance(st, (ast.Expr, ast.Return)):
                if getattr(st, "value", None) is not None:
                    self._eval(st.value)
            elif isinstance(st, ast.Assert):
                self._eval(st.test)

    def _if(self, st: ast.If):
        # Prologue fail-loud guard: ``if SYM > CEIL: raise`` refines the
        # symbol's bound for everything after it (the SLAB_NE_MAX
        # eligibility-predicate shape).
        exits = bool(st.body) and isinstance(st.body[-1],
                                             (ast.Raise, ast.Return))
        if len(st.body) == 1 and isinstance(st.body[0], ast.Raise) \
                and not st.orelse and self._refine_from(st.test):
            return
        try:
            gtext = ast.unparse(st.test)
        except Exception:
            gtext = "<guard>"
        self._eval(st.test)
        self.guards.append(gtext)
        self._stmts(st.body)
        self.guards.pop()
        self._stmts(st.orelse)
        if exits and not st.orelse:
            self.prologue.append(gtext)

    def _refine_from(self, test: ast.AST) -> bool:
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.Gt, ast.GtE))
                and isinstance(test.left, ast.Name)):
            return False
        ceil = _const_int(test.comparators[0], self.consts)
        if ceil is None:
            return False
        if isinstance(test.ops[0], ast.GtE):
            ceil -= 1
        name = test.left.id
        aval = self.env.get(name) or _seed_aval(name)
        sym = None
        if aval is not None and aval.bound is not None \
                and aval.bound[0] == "s":
            sym = aval.bound[1]
        elif name in MAX_WORKLOAD:
            sym = name
        if sym is None:
            return False
        prev = self.refined.get(sym)
        self.refined[sym] = ceil if prev is None else min(prev, ceil)
        return True

    def _assign_target(self, target, val: AVal, value_node=None):
        if isinstance(target, ast.Name):
            if (val is _UNKNOWN or (val.bound is None
                                    and val.extent is None)):
                # Unknown RHS into a contract-named local adopts the
                # symbol (``nv_pad = acc.shape[0]`` keeps its meaning).
                seeded = _seed_aval(target.id)
                if seeded is not None and target.id in PARAM_BOUND_SYMBOLS:
                    self.env[target.id] = seeded
                    return
            self.env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            parts = None
            if isinstance(value_node, (ast.Tuple, ast.List)) \
                    and len(value_node.elts) == len(target.elts):
                parts = [self._eval(e) for e in value_node.elts]
            for i, t in enumerate(target.elts):
                if isinstance(t, ast.Name):
                    self.env[t.id] = parts[i] if parts is not None \
                        else AVal(extent=val.extent)

    # -- expressions --------------------------------------------------

    def _eval(self, node: ast.AST) -> AVal:
        if node is None:
            return _UNKNOWN
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return AVal(bound=_n(1))
            if isinstance(node.value, int):
                return AVal(bound=_n(abs(node.value)))
            return _UNKNOWN
        if isinstance(node, ast.Name):
            got = self.env.get(node.id)
            if got is not None:
                return got
            if node.id in self.consts:
                return AVal(bound=_n(self.consts[node.id]))
            seeded = _seed_aval(node.id)
            return seeded if seeded is not None else _UNKNOWN
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self._eval(v)
            return AVal(bound=_n(1),
                        extent=_first_extent(*[self._eval(v)
                                               for v in node.values]))
        if isinstance(node, ast.Compare):
            left = self._eval(node.left)
            rights = [self._eval(c) for c in node.comparators]
            return AVal(bound=_n(1),
                        extent=_first_extent(left, *rights))
        if isinstance(node, ast.UnaryOp):
            inner = self._eval(node.operand)
            if isinstance(node.op, ast.Invert):
                return AVal(bound=_n(1) if inner.bound == _n(1) else None,
                            extent=inner.extent, int32=inner.int32)
            return AVal(bound=inner.bound, extent=inner.extent,
                        int32=inner.int32)
        if isinstance(node, ast.IfExp):
            self._eval(node.test)
            a, b = self._eval(node.body), self._eval(node.orelse)
            return AVal(bound=_max_bound(a.bound, b.bound),
                        extent=_first_extent(a, b),
                        int32=a.int32 or b.int32)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Subscript):
            return self._subscript(node)
        if isinstance(node, ast.Attribute):
            base = self._eval(node.value)
            if node.attr in ("T", "real", "imag"):
                return base
            return _UNKNOWN
        if isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                self._eval(e)
            return _UNKNOWN
        if isinstance(node, ast.Starred):
            return self._eval(node.value)
        return _UNKNOWN

    def _binop(self, node: ast.BinOp) -> AVal:
        a = self._eval(node.left)
        b = self._eval(node.right)
        int32 = a.int32 or b.int32
        wide = a.wide or b.wide
        extent = _first_extent(a, b)
        op = node.op
        bound = None
        shift_names: set = set()
        kind = "arith"
        if isinstance(op, ast.Add):
            bound = _sum_bound(a.bound, b.bound)
        elif isinstance(op, ast.Sub):
            c = _const_int(node.right, self.consts)
            if c is not None and a.bound is not None:
                bound = ["+", a.bound, _n(-c)]
            else:
                bound = a.bound
        elif isinstance(op, ast.Mult):
            bound = None if a.bound is None or b.bound is None \
                else ["*", a.bound, b.bound]
        elif isinstance(op, (ast.FloorDiv, ast.Div, ast.Mod)):
            bound = a.bound
        elif isinstance(op, ast.LShift):
            # A bare shift is NOT a pack: the `1 << bit_length()` pow2
            # padding idiom (next_pow2, pow2_floor, tree-sum padding,
            # mesh-size caps) shifts a constant 1, and shift-based
            # scaling never re-enters a packed field on its own.  Only a
            # BitOr that COMBINES a shifted field (below) records a pack
            # site; an int32 bare shift still falls through to the
            # generic arith record so R026 sees genuine overflow.
            if a.bound is not None and b.bound is not None:
                bound = ["<<", a.bound, b.bound]
        elif isinstance(op, ast.BitOr):
            bound = _sum_bound(a.bound, b.bound)  # a|b <= a+b, a,b >= 0
            for side in (node.left, node.right):
                for sub in ast.walk(side):
                    if isinstance(sub, ast.BinOp) \
                            and isinstance(sub.op, ast.LShift):
                        shift_names |= _names_in(sub.right)
                        kind = "pack"
        elif isinstance(op, ast.BitAnd):
            if a.bound is not None and b.bound is not None:
                bound = ["min", a.bound, b.bound]
            else:
                bound = a.bound if a.bound is not None else b.bound
        elif isinstance(op, ast.RShift):
            # `idx >> kbits` strips the low field off a flat key: the
            # bound genuinely shrinks, and keeping it symbolic lets the
            # nv_pad*nv_pad >> kbits domain cancel at evaluation.
            if a.bound is not None and b.bound is not None:
                bound = [">>", a.bound, b.bound]
            else:
                bound = a.bound
        out = AVal(bound=bound, extent=extent, int32=int32, wide=wide)
        if kind == "pack":
            self._record(node, "pack", bound, extent=extent,
                         shift=shift_names, int32=int32, wide=wide)
        elif int32 and bound is not None and sym_symbols(bound):
            self._record(node, "arith", bound, extent=extent, int32=True)
        return out

    def _subscript(self, node: ast.Subscript) -> AVal:
        # X.shape[i] -> the extent of X as a VALUE bound.
        if isinstance(node.value, ast.Attribute) \
                and node.value.attr == "shape":
            base = self._eval(node.value.value)
            return AVal(bound=base.extent)
        base = self._eval(node.value)
        self._eval(node.slice)
        return AVal(bound=base.bound, extent=base.extent, int32=base.int32,
                    wide=base.wide)

    def _call(self, node: ast.Call) -> AVal:
        name = dotted(node.func)
        last = _last(name)
        kwargs = {kw.arg: kw.value for kw in node.keywords if kw.arg}

        # A helper of this module that opens with a raise-guard on a
        # parameter (``_check_slab(w_s.shape[0], ...)``) refines the
        # argument's symbol for the rest of the caller.
        helper = self.helpers.get(name) if isinstance(node.func, ast.Name) \
            else None
        if helper is not None:
            idx, ceil = helper
            if idx < len(node.args):
                got = self._eval(node.args[idx])
                if got.bound is not None and got.bound[0] == "s":
                    prev = self.refined.get(got.bound[1])
                    self.refined[got.bound[1]] = ceil if prev is None \
                        else min(prev, ceil)

        # Method-style calls on a tensor (not a module function such as
        # torch.cumsum): casts, views, reductions, gathers.
        if isinstance(node.func, ast.Attribute) \
                and not _is_module_receiver(node.func.value):
            out = self._method(node, node.func.attr, node.func.value,
                               kwargs)
            if out is not None:
                return out

        args = [self._eval(a) for a in node.args]
        for v in kwargs.values():
            self._eval(v)

        if last in _REDUCTION_CALLS and args:
            return self._reduction(node, last, args[0], kwargs)
        if last in ("int", "abs", "round"):
            return args[0] if args else _UNKNOWN
        if last in _INT32_NAMES and name != last:
            # np.int32(x): a scalar cast
            out = AVal(bound=args[0].bound if args else None,
                       extent=args[0].extent if args else None,
                       int32=True)
            if out.bound is not None and sym_symbols(out.bound):
                self._record(node, "arith", out.bound,
                             extent=out.extent, int32=True)
            return out
        if last in _MINMAX_CALLS and args:
            bounds = [a.bound for a in args]
            if any(b is None for b in bounds):
                merged = None if last in ("max", "maximum") else \
                    next((b for b in bounds if b is not None), None)
            else:
                tag = "min" if last in ("min", "minimum") else "max"
                merged = [tag] + bounds if len(bounds) > 1 else bounds[0]
            return AVal(bound=merged, extent=_first_extent(*args),
                        int32=any(a.int32 for a in args),
                        wide=any(a.wide for a in args))
        dtype = kwargs.get("dtype")
        if last == "arange":
            bound = args[-1].bound if len(node.args) == 1 else (
                args[1].bound if len(args) > 1 else None)
            is32 = _is_int32_dtype_expr(dtype)
            out = AVal(bound=bound, extent=bound, int32=is32,
                       wide=dtype is None or _is_int64_dtype_expr(dtype))
            if is32 and bound is not None and sym_symbols(bound):
                self._record(node, "arith", bound, extent=bound,
                             int32=True)
            return out
        if last == "tensor" or last == "asarray":
            base = args[0] if args else _UNKNOWN
            is32 = _is_int32_dtype_expr(dtype)
            out = AVal(bound=base.bound, extent=base.extent, int32=is32,
                       wide=_is_int64_dtype_expr(dtype))
            if is32 and base.bound is not None \
                    and sym_symbols(base.bound):
                self._record(node, "arith", base.bound,
                             extent=base.extent, int32=True)
            return out
        if last in _ALLOC_CALLS:
            extent = self._shape_extent(node.args[0]) if node.args \
                else None
            is32 = any(_is_int32_dtype_expr(a) for a in node.args[1:]) \
                or _is_int32_dtype_expr(dtype)
            fill = args[1].bound if last == "full" and len(args) > 1 \
                else _n(1 if last == "ones" else 0)
            return AVal(bound=fill, extent=extent, int32=is32,
                        wide=_is_int64_dtype_expr(dtype))
        if last in _LIKE_CALLS and args:
            fill = args[1].bound if last == "full_like" and len(args) > 1 \
                else _n(1 if last == "ones_like" else 0)
            is32 = _is_int32_dtype_expr(dtype) or (
                dtype is None and args[0].int32)
            return AVal(bound=fill, extent=args[0].extent, int32=is32,
                        wide=_is_int64_dtype_expr(dtype) or (
                            dtype is None and args[0].wide))
        if last == "where" and len(args) >= 3:
            return AVal(bound=_max_bound(args[1].bound, args[2].bound),
                        extent=_first_extent(*args),
                        int32=args[1].int32 or args[2].int32,
                        wide=args[1].wide or args[2].wide)
        if last in ("take", "take_along_axis", "gather", "index_select") \
                and args:
            return AVal(bound=args[0].bound,
                        extent=args[-1].extent if len(args) > 1
                        else args[0].extent,
                        int32=args[0].int32, wide=args[0].wide)
        if last in ("concatenate", "cat"):
            return AVal(extent=_first_extent(*args))
        # Unknown call: propagate the widest argument extent (the sorted
        # copies / run masks keep their slab extent through helpers).
        return AVal(extent=_first_extent(*args))

    def _method(self, node: ast.Call, attr: str, recv_node: ast.AST,
                kwargs: dict) -> AVal | None:
        """``x.attr(...)`` on a tensor or array; None falls through to
        the generic call handling."""
        cast = _cast_of(attr, node, kwargs)
        if cast is not None:
            recv = self._eval(recv_node)
            for a in node.args:
                self._eval(a)
            if cast == "keep":
                return AVal(bound=recv.bound, extent=recv.extent,
                            int32=recv.int32, wide=recv.wide)
            if cast != "int32":
                return AVal(bound=recv.bound, extent=recv.extent,
                            wide=cast == "wide")
            out = AVal(bound=recv.bound, extent=recv.extent, int32=True)
            if recv.bound is not None and sym_symbols(recv.bound):
                red = self._reduced_input(recv_node)
                if red is not None:
                    # An int32 cast of an integer reduction wraps as an
                    # int32 accumulator would: the reduction's site.
                    self._record(node, "reduction", recv.bound,
                                 extent=red.extent, int32=True)
                else:
                    self._record(node, "arith", recv.bound,
                                 extent=recv.extent, int32=True)
            return out
        if attr == "bit_length":
            recv = self._eval(recv_node)
            bound = None if recv.bound is None else ["bits", recv.bound]
            return AVal(bound=bound)
        if attr in _PASS_METHODS:
            recv = self._eval(recv_node)
            for a in node.args:
                self._eval(a)
            return AVal(bound=recv.bound, extent=recv.extent,
                        int32=recv.int32, wide=recv.wide)
        if attr in _REDUCTION_CALLS:
            recv = self._eval(recv_node)
            for a in node.args:
                self._eval(a)
            return self._reduction(node, attr, recv, kwargs)
        if attr in ("gather", "index_select", "take"):
            recv = self._eval(recv_node)
            args = [self._eval(a) for a in node.args]
            return AVal(bound=recv.bound,
                        extent=args[-1].extent if args else recv.extent,
                        int32=recv.int32, wide=recv.wide)
        if attr == "item":
            return AVal(bound=self._eval(recv_node).bound)
        return None

    def _reduced_input(self, node: ast.AST) -> AVal | None:
        """The reduced operand's value when ``node`` is an integer
        reduction call (``torch.cumsum(m, 0)``, ``m.sum()``), else
        None."""
        if not isinstance(node, ast.Call):
            return None
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _REDUCTION_CALLS:
            if _is_module_receiver(node.func.value):
                return self._eval(node.args[0]) if node.args else None
            return self._eval(node.func.value)
        return None

    def _shape_extent(self, shape_node: ast.AST):
        if isinstance(shape_node, (ast.Tuple, ast.List)):
            bounds = []
            for e in shape_node.elts:
                b = self._eval(e).bound
                if b is None:
                    return None
                bounds.append(b)
            if not bounds:
                return None
            out = bounds[0]
            for b in bounds[1:]:
                out = ["*", out, b]
            return out
        return self._eval(shape_node).bound

    def _reduction(self, node: ast.Call, op: str, inp: AVal,
                   kwargs: dict) -> AVal:
        # torch and numpy widen integer cumsum/sum/bincount to int64; only
        # dtype=int32 keeps the accumulator narrow (an int32 cast of the
        # result is recorded by the cast, _method).
        is32 = _is_int32_dtype_expr(kwargs.get("dtype"))
        if op == "bincount":
            # counts are bounded by the number of addends
            bound = inp.extent
            extent = None
            ml = kwargs.get("minlength")
            if ml is not None:
                extent = self._eval(ml).bound
            if kwargs.get("weights") is not None:
                is32 = False  # weighted bincount accumulates the weights
        else:
            per = inp.bound if inp.bound is not None else _n(1)
            bound = None if inp.extent is None else ["*", inp.extent, per]
            extent = inp.extent if op in ("cumsum", "cumulative_sum") \
                else None
        out = AVal(bound=bound, extent=extent, int32=is32, wide=not is32)
        if is32 and bound is not None and sym_symbols(bound):
            self._record(node, "reduction", bound, extent=inp.extent,
                         int32=True)
        return out


def _wider(a: dict, b: dict) -> bool:
    """Does site ``a``'s bound exceed ``b``'s at the max workload?"""
    va = sym_eval(a["bound"], dict(MAX_WORKLOAD, **a["refined"]))
    vb = sym_eval(b["bound"], dict(MAX_WORKLOAD, **b["refined"]))
    return va is not None and (vb is None or va > vb)


def _names_in_text(text: str) -> set:
    return set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", text))


# ---------------------------------------------------------------------------
# Summary + inventory.


def width_summary(sf: SourceFile) -> dict:
    """The JSON-serializable width facts of one file; rides the tier-2
    summary under the ``"width"`` key.  Non-device-path files carry an
    empty site list (the serve/obs/comm layers hold no slab-extent
    index arithmetic)."""
    if not sf.rel.startswith(WIDTH_PATH_PREFIXES):
        return {"version": WIDTH_SUMMARY_VERSION, "sites": []}
    consts = _module_int_consts(sf)
    width_ok = _width_ok_lines(sf)
    helpers = _module_raise_guards(sf, consts)
    sites: list = []
    for info in sf.functions:
        try:
            _FnInterp(sf, info, consts, width_ok, sites, helpers).run()
        except RecursionError:
            continue
    sites.sort(key=lambda s: (s["line"], s["fn"]))
    return {"version": WIDTH_SUMMARY_VERSION, "sites": sites}


def width_inventory(summaries) -> list:
    """Every ``width-ok``-annotated site in the summary set:
    [{rel, line, fn, kind, bound, reason, snippet}] — the closed,
    justified inventory of deliberate 32-bit choices
    (``python -m cuvite_tpu_torch.tools.width_audit --inventory``
    prints it)."""
    out = []
    for s in summaries:
        width = (s or {}).get("width") or {}
        for site in width.get("sites", ()):
            if site.get("width_ok"):
                out.append({
                    "rel": s["rel"], "line": site["line"],
                    "fn": site["fn"], "kind": site["kind"],
                    "bound": sym_render(site["bound"]),
                    "reason": site["width_ok"],
                    "snippet": site["snippet"],
                })
    return sorted(out, key=lambda d: (d["rel"], d["line"]))


# ---------------------------------------------------------------------------
# Rules.

from cuvite_tpu_torch.analysis.callgraph import ProjectRule  # noqa: E402


def _site_env(site: dict) -> dict:
    env = dict(MAX_WORKLOAD)
    env.update(site.get("refined") or {})
    return env


def _guarded(site: dict) -> bool:
    """Is the site inside a predicate that mentions one of the symbols
    its bound depends on (an eligibility guard)?"""
    syms = sym_symbols(site["bound"]) | sym_symbols(site.get("extent"))
    if not syms:
        return False
    for g in site.get("guards", ()):
        if _names_in_text(g) & syms:
            return True
    return False


def _wfind(rule, summary, site, message) -> Finding:
    return Finding(rule=rule.id, severity=rule.severity,
                   path=summary["rel"], line=site["line"],
                   message=message, snippet=site["snippet"])


def _width_sites(project):
    for summary in project.summaries:
        width = summary.get("width") or {}
        for site in width.get("sites", ()):
            if site.get("width_ok"):
                continue
            yield summary, site


@register
class Int32BoundOverflow(ProjectRule):
    id = "R026"
    severity = "high"
    title = "int32 index arithmetic whose symbolic bound exceeds " \
            "2^31-1 at the declared max workload"

    def check_project(self, project):
        for summary, site in _width_sites(project):
            if site["kind"] == "pack" or not site.get("int32"):
                continue
            if site["kind"] == "reduction" \
                    and "ne_pad" in sym_symbols(site.get("extent")):
                continue  # R028's partition
            val = sym_eval(site["bound"], _site_env(site))
            if val is None or val <= INT32_MAX:
                continue
            if _guarded(site):
                continue
            yield _wfind(
                self, summary, site,
                f"int32-typed value in '{site['fn']}' is bounded by "
                f"{sym_render(site['bound'])} = {val} at the registry's "
                f"declared max workload (> 2^31-1 = {INT32_MAX}): a "
                "silent wraparound here produces wrong labels, not a "
                "crash.  Guard it with an eligibility predicate (the "
                "SLAB_NE_MAX raise-guard shape), widen the dtype, or "
                "justify with '# graftlint: width-ok=<reason>' on this "
                "line (the annotation feeds the closed width inventory, "
                "python -m cuvite_tpu_torch.tools.width_audit "
                "--inventory)")


@register
class UntiedBitPack(ProjectRule):
    id = "R027"
    severity = "high"
    title = "bit-packing site whose bit budget is not provably tied " \
            "to the guard predicate gating it"

    def check_project(self, project):
        for summary, site in _width_sites(project):
            if site["kind"] != "pack" or site.get("tied"):
                continue
            val = sym_eval(site["bound"], _site_env(site))
            limit = INT64_MAX if site.get("wide") else INT32_MAX
            if val is not None and val <= limit:
                continue  # provably fits even unguarded
            shown = sym_render(site["bound"])
            at = "unknown" if val is None else str(val)
            yield _wfind(
                self, summary, site,
                f"packed key in '{site['fn']}' (budget "
                f"{shown}, {at} at max workload) is not tied to any "
                "gating predicate: nothing proves the shifted field "
                "cannot bleed into (or past) the sign bit — the "
                "segment.py contract is 'pack ONLY under a predicate "
                "that bounds the bit budget' (kbits + sbits <= 31).  "
                "Gate it on the packing bit width, bound the id space "
                "with a fail-loud raise-guard, or justify with "
                "'# graftlint: width-ok=<reason>'")


@register
class Int32SlabReduction(ProjectRule):
    id = "R028"
    severity = "high"
    title = "cumsum/sum/bincount over an ne_pad-extent array " \
            "accumulating in int32"

    def check_project(self, project):
        for summary, site in _width_sites(project):
            if site["kind"] != "reduction" or not site.get("int32"):
                continue
            if "ne_pad" not in sym_symbols(site.get("extent")):
                continue
            val = sym_eval(site["bound"], _site_env(site))
            if val is None or val <= INT32_MAX:
                continue
            if _guarded(site):
                continue
            yield _wfind(
                self, summary, site,
                f"int32 reduction in '{site['fn']}' accumulates over an "
                f"edge-slab extent ({sym_render(site.get('extent'))}); "
                f"its bound {sym_render(site['bound'])} = {val} clears "
                f"2^31-1 at the declared max workload.  The run-id/"
                "compaction-offset class: at a 2^32-row slab the cumsum "
                "of a MASK already wraps.  Bound the slab with the "
                "SLAB_NE_MAX raise-guard (ops/segment.py), accumulate "
                "wider, or justify with '# graftlint: "
                "width-ok=<reason>'")
