"""graftlint per-file rule set for the port (port of
``cuvite_tpu/analysis/rules.py``): R001, R003-R010, R012-R016, R022 and
R029.  R017-R025 live in the project-tier modules.

Each rule keeps the reference's id, severity and hazard; its torch form
reads the port's idioms:

  * R001 host reads (``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``torch.nonzero``, ``float/int/bool`` of a tensor
    reduction, ``torch.cuda.synchronize``) in a function reached from a
    device-path root (``engine.DEVICE_PATH_ROOTS``), where the reference
    read ``@jax.jit``;
  * R003 ``torch.int64``/``torch.float64`` (and their aliases) in
    ``louvain/``, ``kernels/``, ``ops/``;
  * R004 the ``torch.distributed`` collectives and ``multihost``'s host
    wrappers under a rank-dependent or fallible branch;
  * R005 in-place torch ops (``x.add_``, ``index_put_``, ``out=``) on an
    argument, beside the reference's numpy forms;
  * R010 ``.cpu()``/``.tolist()``/``.numpy()``/``torch.nonzero`` in
    ``louvain/`` and ``coarsen/``;
  * R012 a ``perf_counter`` window that launches CUDA work and closes
    without ``torch.cuda.synchronize``, an event's or stream's
    ``synchronize`` or a host read;
  * R013 ``torch.sort``/``argsort`` in ``coarsen/`` or ``kernels/``;
  * R014 its upload half (``to_device``, ``.to(device)``,
    ``torch.as_tensor(..., device=)`` per job in a serve loop);
  * R029 in-place torch writes (``index_put_``, ``copy_``, ...) in
    ``stream/`` and ``serve/`` outside ``stream/delta.py``, where the
    reference read ``.at[].set``.

Dropped, with no torch form: R002 (jit recompile traps: the port has no
jit) and R011 (Pallas BlockSpec literals: the port has no Pallas); the
jit/vmap half of R014 and the donation half of R029 go with them.

Rules are heuristic by design: they trade completeness for a near-zero
false-positive rate on idiomatic code, and every remaining intentional
violation is handled by an inline ``# graftlint: disable=R###`` with a
justification, or by the port's baseline.
"""

from __future__ import annotations

import ast

from cuvite_tpu_torch.analysis.engine import Rule, dotted, register

PKG = "cuvite_tpu_torch/"

# Directories whose modules run (or build tensors for) the device path.
DEVICE_PATH_PREFIXES = (
    PKG + "louvain/",
    PKG + "kernels/",
    PKG + "ops/",
)

# Rules dropped from the reference's catalogue, with the reason each has
# no torch form (printed by --list-rules).
DROPPED_RULES = {
    "R002": "jit recompile trap: dropped, the port has no jit (no traced "
            "arguments, no static_argnums, no compile cache keyed on "
            "them)",
    "R011": "Pallas BlockSpec literal: dropped, the port has no Pallas "
            "(its kernels are CUDA C++ built by nvcc, their launch "
            "geometry lives in kernels/csrc)",
}

# Host reads that must not appear in code a device-path root reaches:
# each one blocks the host on the device (or copies a tensor to it).
HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
HOST_SYNC_CALLS = {"torch.nonzero", "torch.argwhere",
                   "torch.cuda.synchronize"}
# float/int/bool of a tensor: the argument must read as a tensor
# expression (a torch call or a reduction method), so that float(nv)
# of a host number stays clean.
HOST_CAST_CALLS = {"float", "int", "bool"}
TENSOR_REDUCTIONS = {"sum", "max", "min", "any", "all", "mean", "prod",
                     "amax", "amin", "argmax", "argmin", "count_nonzero",
                     "norm", "dot"}

# Host-side collective wrappers (comm/multihost.py) and the
# torch.distributed collectives they wrap, plus new_group (every rank
# must create every group, in one order): every rank must reach these
# in the same order.
COLLECTIVE_NAMES = {
    "process_allgather", "allgather_varlen", "allreduce_sum_host",
    "allreduce_max_host", "gather_global", "broadcast_one_to_all",
    "sync_global_devices", "broadcast_host_local_array", "barrier",
}
DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "barrier", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "gather", "scatter", "new_group",
    "monitored_barrier",
}
DIST_PREFIXES = ("dist.", "torch.distributed.")

# Condition calls that are uniform across ranks by construction, so
# branching on them cannot diverge collective order.
UNIFORM_CONDITION_CALLS = {
    "is_distributed", "len", "isinstance", "issubclass", "bool", "int",
    "process_count", "hasattr", "get_world_size", "world_size",
    "is_initialized", "is_available",
}
# Names whose value differs between ranks.
RANK_NAMES = ("process_index", "process_id", "rank", "get_rank",
              "local_rank")


def _in_device_path(sf) -> bool:
    return sf.rel.startswith(DEVICE_PATH_PREFIXES)


def _nodes_of_function(sf, info):
    """Nodes lexically inside ``info``'s body but not inside a nested
    def (those belong to the nested function)."""
    return sf.nodes_of(info)


_HOST_CONSTRUCTORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}


def _tensorish(node: ast.AST) -> bool:
    """An expression that reads as a tensor: a torch.* call or a
    reduction method (``x.sum()``)."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func) or ""
    if name in _HOST_CONSTRUCTORS \
            and not any(kw.arg == "device" for kw in node.keywords):
        return False  # a tensor made on the host from a host value
    if name.startswith("torch.") and not name.startswith("torch.cuda."):
        return True
    return isinstance(node.func, ast.Attribute) \
        and node.func.attr in TENSOR_REDUCTIONS


def host_sync_label(node: ast.Call, casts: bool = True) -> str | None:
    """The host-read label of a call (R001's set; tier 2 drops the
    casts), else None."""
    name = dotted(node.func)
    if name in HOST_SYNC_CALLS:
        return f"{name}()"
    if casts and name in HOST_CAST_CALLS and node.args \
            and _tensorish(node.args[0]):
        return f"{name}(<tensor>)"
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in HOST_SYNC_ATTRS and not node.args:
            return f".{attr}()"
        if attr == "to" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "cpu":
            return ".to('cpu')"
    return None


@register
class HostSyncOnDevicePath(Rule):
    id = "R001"
    severity = "high"
    title = "host read in a function reached from a device-path root " \
            "(engine.DEVICE_PATH_ROOTS)"

    def check(self, sf):
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            info = sf.enclosing_function(node)
            if info is None or not info.device_reachable:
                continue
            label = host_sync_label(node)
            if label is None:
                continue
            yield self.finding(
                sf, node,
                f"{label} in '{info.qualname}' (reached from a device-"
                "path root, the functions the sweep loop calls once a "
                "sweep): blocks the host on the device every sweep; "
                "return the value as a tensor and let the loop's one "
                "host read a sweep take it")


_T64_ATTRS = {"torch.int64", "torch.float64", "torch.uint64",
              "torch.long", "torch.double"}


@register
class DtypeWidthDrift(Rule):
    id = "R003"
    severity = "medium"
    title = "64-bit torch dtype in a 32-bit device-path module"

    def check(self, sf):
        if not _in_device_path(sf):
            return
        for node in sf.walk():
            if isinstance(node, ast.Attribute) and dotted(node) in _T64_ATTRS:
                yield self.finding(
                    sf, node,
                    f"{dotted(node)} in a device-path module: ids and "
                    "weights stay 32-bit on the device (int32 ids, f32 "
                    "weights, the kernels' types); a 64-bit tensor pays "
                    "2x memory and bandwidth.  The port's exact sums (Q, "
                    "comm_deg64) are f64 on purpose and carry an inline "
                    "'# graftlint: disable=R003' with the reason.  "
                    "(.long() index widening for torch's gather/scatter "
                    "ops is transient and not flagged.)")


def _condition_is_divergent(test: ast.expr) -> str | None:
    """Why a branch condition can differ between ranks, or None.

    Divergent: references a rank (``process_index``, ``rank``,
    ``get_rank``...), or contains any call other than the known
    rank-uniform predicates (a call result is runtime data the linter
    cannot prove replicated)."""
    for n in ast.walk(test):
        name = dotted(n) if isinstance(n, (ast.Name, ast.Attribute)) else None
        if name and name.split(".")[-1] in RANK_NAMES:
            return f"condition references {name}"
        if isinstance(n, ast.Call):
            cname = dotted(n.func) or "<expr>"
            if cname.split(".")[-1] not in UNIFORM_CONDITION_CALLS \
                    and cname not in UNIFORM_CONDITION_CALLS:
                return f"condition depends on {cname}(...)"
    return None


def is_host_collective(fname: str) -> bool:
    """A torch.distributed collective (``dist.all_reduce``...) or one of
    multihost's host wrappers: R004's set.  The port's per-shard list
    collectives (comm/collectives.py) are R024's."""
    last = fname.split(".")[-1]
    if fname.startswith(DIST_PREFIXES):
        return last in DIST_COLLECTIVES
    return last in COLLECTIVE_NAMES


@register
class CollectiveOrderDivergence(Rule):
    id = "R004"
    severity = "high"
    title = "collective call under a data-dependent or fallible branch"

    def check(self, sf):
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func) or ""
            if not fname or not is_host_collective(fname):
                continue
            info = sf.enclosing_function(node)
            boundary = info.node if info is not None else None
            child = node
            for anc in sf.ancestors(node):
                if anc is boundary:
                    break
                if isinstance(anc, ast.Try):
                    yield self.finding(
                        sf, node,
                        f"collective {fname}() inside a try block: an "
                        "exception on one rank skips its remaining "
                        "collectives while peers block in them — "
                        "deadlock, not an error message; hoist the "
                        "collective out or convert the failure into a "
                        "value every rank agrees on")
                    break
                if isinstance(anc, (ast.If, ast.While)) \
                        and child is not anc.test:
                    why = _condition_is_divergent(anc.test)
                    if why:
                        yield self.finding(
                            sf, node,
                            f"collective {fname}() under a branch that "
                            f"may differ between ranks ({why}): ranks "
                            "disagreeing on whether to issue a "
                            "collective (or to create a group) is the "
                            "canonical multi-rank deadlock; make the "
                            "condition a replicated value or issue the "
                            "collective unconditionally")
                        break
                child = anc


_INPLACE_METHODS = {"fill", "sort", "resize", "partition", "put", "setfield"}
# torch's in-place methods on a tensor argument.
TORCH_INPLACE_METHODS = {
    "add_", "sub_", "mul_", "div_", "copy_", "zero_", "fill_", "clamp_",
    "index_add_", "index_copy_", "index_fill_", "index_put_", "put_",
    "scatter_", "scatter_add_", "scatter_reduce_", "masked_fill_",
    "masked_scatter_", "neg_", "abs_", "floor_", "ceil_", "round_",
    "bitwise_and_", "bitwise_or_", "bitwise_xor_", "clamp_min_",
    "clamp_max_", "pow_", "sqrt_", "exp_", "log_", "relu_", "sigmoid_",
    "addcmul_", "addcdiv_", "lerp_", "uniform_", "normal_", "random_",
    "resize_", "t_", "transpose_", "squeeze_", "unsqueeze_", "set_",
}


@register
class CallerBufferMutation(Rule):
    id = "R005"
    severity = "medium"
    title = "mutation of a caller-owned buffer argument"

    def check(self, sf):
        for info in sf.functions:
            params = {p for p in info.params
                      if p not in ("self", "cls")
                      and not p.endswith("_ref")}
            if not params:
                continue
            for node in _nodes_of_function(sf, info):
                yield from self._check_node(sf, info, params, node)

    def _check_node(self, sf, info, params, node):
        def is_param(expr):
            return isinstance(expr, ast.Name) and expr.id in params

        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) \
                        and tgt.attr == "writeable" \
                        and isinstance(tgt.value, ast.Attribute) \
                        and tgt.value.attr == "flags" \
                        and is_param(tgt.value.value):
                    yield self.finding(
                        sf, node,
                        f"'{info.name}' flips writeable on its argument "
                        f"'{tgt.value.value.id}': the caller's buffer "
                        "changes behaviour behind its back — document "
                        "the contract and freeze the base chain, or "
                        "copy instead")
                elif isinstance(tgt, ast.Subscript) and is_param(tgt.value):
                    yield self.finding(
                        sf, node,
                        f"'{info.name}' writes in place into its "
                        f"argument '{tgt.value.id}': callers retaining "
                        "the array observe the mutation (and zero-copy "
                        "device aliases of it go stale)")
        elif isinstance(node, ast.AugAssign):
            tgt = node.target
            if isinstance(tgt, ast.Subscript) and is_param(tgt.value):
                yield self.finding(
                    sf, node,
                    f"'{info.name}' updates its argument "
                    f"'{tgt.value.id}' in place")
        elif isinstance(node, ast.Call):
            fname = dotted(node.func) or ""
            if fname in ("np.copyto", "numpy.copyto") and node.args \
                    and is_param(node.args[0]):
                yield self.finding(
                    sf, node,
                    f"'{info.name}' np.copyto()s into its argument "
                    f"'{node.args[0].id}'")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _INPLACE_METHODS \
                    and is_param(node.func.value):
                yield self.finding(
                    sf, node,
                    f"'{info.name}' calls .{node.func.attr}() on its "
                    f"argument '{node.func.value.id}' (in-place)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in TORCH_INPLACE_METHODS \
                    and is_param(node.func.value):
                yield self.finding(
                    sf, node,
                    f"'{info.name}' calls .{node.func.attr}() on its "
                    f"argument '{node.func.value.id}' (torch in-place): "
                    "the caller's tensor changes under it")
            else:
                for kw in node.keywords:
                    if kw.arg == "out" and is_param(kw.value):
                        yield self.finding(
                            sf, node,
                            f"'{info.name}' writes {fname or 'a call'}"
                            f"(out={kw.value.id}) into its argument "
                            f"'{kw.value.id}'")


_MOD_NAME = ("mod", "modularity", "q")
_SUM_CALLS = {"segment_sum", "sum"}
# Markers of the exact path in the assigned expression: an f64 sum
# (``.double()``, ``dtype=torch.float64``, a ``*64`` table such as
# ``comm_deg64``) is the port's exact path, the H100 summing in real f64.
_EXACT_MARKERS = ("double", "float64", "exactsum")


def _is_mod_name(name: str) -> bool:
    low = name.lower()
    if "modularity" in low:
        return True
    parts = low.split("_")
    return parts[0] in _MOD_NAME or parts[-1] in _MOD_NAME


@register
class InexactModularityReduction(Rule):
    id = "R006"
    severity = "medium"
    title = "f32 reduction feeding a modularity accumulator"

    def check(self, sf):
        if not (sf.rel.startswith(PKG + "louvain/")
                or sf.rel.startswith(PKG + "evaluate/")):
            return
        for node in sf.walk():
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if not any(_is_mod_name(n) for n in names):
                continue
            sub = ast.dump(node.value)
            if any(m in sub for m in _EXACT_MARKERS) or any(
                    isinstance(n, ast.Name) and n.id.endswith("64")
                    for n in ast.walk(node.value)):
                continue  # already on the exact (f64) path
            info = sf.enclosing_function(node)
            if info is not None and any(
                    "accum" in p or p == "adt" for p in info.params):
                continue  # dtype-policy-aware: width chosen by caller
            for call in ast.walk(node.value):
                if not isinstance(call, ast.Call):
                    continue
                fname = dotted(call.func) or (
                    call.func.attr if isinstance(call.func, ast.Attribute)
                    else "")
                if fname.split(".")[-1] in _SUM_CALLS:
                    yield self.finding(
                        sf, node,
                        f"modularity accumulator '{names[0]}' fed by "
                        f"{fname.split('.')[-1]}() without the exact "
                        "path: f32 tree sums lose ~log2(n)*2^-24 "
                        "relative — enough to flip the 1e-6 convergence "
                        "test at scale; sum in f64 (.double() / "
                        "dtype=torch.float64), as the port's Q does")
                    break


_SUBPROCESS_BLOCKING = {
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
}
# The port's drivers, and the scripts at the repo root that start
# children on the card.
TOOLS_SCOPE = (PKG + "tools/",)
TOOLS_FILES = ("chip_smoke.py", "kernel_ab.py")


def _root_script(rel: str, names) -> bool:
    """``rel`` is one of the repo-root scripts ``names``: at the root, or
    one directory down (a file argument outside the repo resolves against
    its grandparent, ``<tree>/chip_smoke.py``)."""
    return rel in names or (rel.count("/") == 1
                            and rel.split("/", 1)[1] in names)


def in_tools_scope(rel: str) -> bool:
    return rel.startswith(TOOLS_SCOPE) or _root_script(rel, TOOLS_FILES)


@register
class SubprocessNoTimeout(Rule):
    id = "R007"
    severity = "high"
    title = "blocking subprocess call without a timeout in the port's " \
            "drivers (tools/, chip_smoke.py, kernel_ab.py)"

    def check(self, sf):
        if not in_tools_scope(sf.rel):
            return
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if fname not in _SUBPROCESS_BLOCKING:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue  # **kwargs may carry a timeout: cannot prove
            yield self.finding(
                sf, node,
                f"{fname}() without timeout=: a hung child (a card "
                "that never answers, a rank waiting on a peer) wedges "
                "the whole run forever; pass a generous timeout and "
                "handle TimeoutExpired loudly")


_EMPTYISH = (None, "", "0")


def _env_get_polarity(sf, call: ast.Call, test: ast.expr):
    """How the env-get GATES ``test``: True — the branch cannot be taken
    unless the variable is set to an opt-in value; False — the branch
    cannot be taken WHILE it is set; None — cannot prove either (the
    reference's rule, unchanged)."""
    defaults = list(call.args[1:2]) + [
        kw.value for kw in call.keywords if kw.arg == "default"]
    for d in defaults:
        if not (isinstance(d, ast.Constant) and d.value in _EMPTYISH):
            return None  # truthy (or unprovable) default: true while unset
    positive = True
    if call is test:
        return positive
    child = call
    for anc in sf.ancestors(call):
        if isinstance(anc, ast.UnaryOp) and isinstance(anc.op, ast.Not):
            positive = not positive
        elif isinstance(anc, ast.Compare):
            if not (anc.comparators and child is anc.left
                    and isinstance(anc.comparators[0], ast.Constant)):
                return None  # yoda/chained forms: cannot prove gating
            op, cmp_ = anc.ops[0], anc.comparators[0]
            emptyish = cmp_.value in _EMPTYISH
            if isinstance(op, (ast.Eq, ast.Is)):
                positive ^= emptyish
            elif isinstance(op, (ast.NotEq, ast.IsNot)):
                positive ^= not emptyish
            else:
                return None
        elif isinstance(anc, ast.BoolOp):
            if not isinstance(anc.op, ast.And):
                return None  # an `or` arm bypasses the env var
        else:
            return None  # wrapped in a call/ifexp/...: cannot prove
        child = anc
        if anc is test:
            break
    return positive


def _opt_in_gated(sf, node) -> bool:
    """True if an ancestor ``if`` gates ``node`` on an os.environ.get /
    os.getenv whose polarity matches the branch holding ``node`` (the
    reference's rule, unchanged)."""
    prev = node
    for anc in sf.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        if isinstance(anc, ast.If) and prev is not anc.test:
            in_body = any(prev is s for s in anc.body)
            in_orelse = any(prev is s for s in anc.orelse)
            for n in ast.walk(anc.test):
                if isinstance(n, ast.Call):
                    cname = dotted(n.func) or ""
                    if cname not in ("os.environ.get", "os.getenv") \
                            and not cname.endswith("environ.get"):
                        continue
                    pol = _env_get_polarity(sf, n, anc.test)
                    if (in_body and pol is True) \
                            or (in_orelse and pol is False):
                        return True
        prev = anc
    return False


# Process-global torch state a test module must not change at import
# time (module scope): it leaks into every later test in the worker.
_TORCH_GLOBAL_CALLS = {"torch.set_num_threads", "torch.manual_seed",
                       "torch.set_default_dtype",
                       "torch.set_default_device",
                       "torch.use_deterministic_algorithms"}


def in_tests_scope(rel: str) -> bool:
    """The port's test files: tests/test_torch_*.py."""
    base = rel.rsplit("/", 1)[-1]
    return rel.startswith("tests/") and base.startswith("test_torch_")


@register
class HostGlobalTestSideEffect(Rule):
    id = "R008"
    severity = "high"
    title = "host-global side effect in the port's tests without " \
            "opt-in gating"

    def check(self, sf):
        if not in_tests_scope(sf.rel):
            return
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if fname == "open":
                target = node.args[0] if node.args else None
                mode = None
                if len(node.args) > 1:
                    mode = node.args[1]
                for kw in node.keywords:
                    if kw.arg == "mode":
                        mode = kw.value
                if not (isinstance(target, ast.Constant)
                        and isinstance(target.value, str)
                        and target.value.startswith("/proc/sys")):
                    continue
                if not (isinstance(mode, ast.Constant)
                        and isinstance(mode.value, str)
                        and any(c in mode.value for c in "wa+")):
                    continue
                if _opt_in_gated(sf, node):
                    continue
                yield self.finding(
                    sf, node,
                    f"sysctl write ({target.value}) in a test fixture "
                    "without an opt-in env gate: a HOST-GLOBAL knob "
                    "silently changed for everything else on the "
                    "machine; gate it on an explicit CUVITE_*=1 opt-in "
                    "and restore the prior value at session finish")
            elif fname == "os.putenv":
                if _opt_in_gated(sf, node):
                    continue
                yield self.finding(
                    sf, node,
                    "os.putenv() in tests bypasses os.environ "
                    "bookkeeping (leaks into every child, invisible to "
                    "os.environ readers); assign os.environ[...] "
                    "through monkeypatch instead, or gate behind an "
                    "opt-in")
            elif fname in _TORCH_GLOBAL_CALLS \
                    and sf.enclosing_function(node) is None:
                yield self.finding(
                    sf, node,
                    f"{fname}() at a test module's top level changes "
                    "process-global torch state for every later test "
                    "in the worker (xdist runs many modules in one "
                    "process); set it in a fixture that restores it "
                    "(one_torch_thread), or seed a torch.Generator")


# The ONE module allowed to open network connections: the workloads
# dataset registry's fetch path (which must checksum what it downloads).
NETWORK_ALLOWED_FILE = PKG + "workloads/registry.py"

_NET_CALL_NAMES = {
    "urlopen", "urlretrieve",
    "socket.create_connection", "ftplib.FTP",
    "http.client.HTTPConnection", "http.client.HTTPSConnection",
}
_NET_CALL_PREFIXES = ("urllib.request.", "requests.")

_CHECKSUM_MARKERS = ("sha256", "sha512", "sha1", "md5", "blake2",
                     "checksum", "verify")

_SUBPROCESS_ANY = _SUBPROCESS_BLOCKING | {"subprocess.Popen"}
_DOWNLOADER_TOOLS = {"curl", "wget", "aria2c", "scp", "rsync"}


def _is_net_call(name: str | None) -> bool:
    if not name:
        return False
    return (name in _NET_CALL_NAMES
            or name.split(".")[-1] in ("urlopen", "urlretrieve")
            or name.startswith(_NET_CALL_PREFIXES))


def _subprocess_downloader(node: ast.Call) -> str | None:
    if not node.args:
        return None
    arg = node.args[0]
    cands = []
    if isinstance(arg, (ast.List, ast.Tuple)):
        cands = [el.value for el in arg.elts
                 if isinstance(el, ast.Constant) and isinstance(el.value, str)]
    elif isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        cands = arg.value.split()
    for c in cands:
        base = c.rsplit("/", 1)[-1]
        if base in _DOWNLOADER_TOOLS:
            return base
    return None


@register
class NetworkOutsideRegistry(Rule):
    id = "R009"
    severity = "high"
    title = "network call outside the workloads fetch path, or a " \
            "download without checksum verification"

    def check(self, sf):
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if _is_net_call(fname):
                if sf.rel != NETWORK_ALLOWED_FILE:
                    yield self.finding(
                        sf, node,
                        f"network call {fname}() outside "
                        f"{NETWORK_ALLOWED_FILE}: dataset fetches live in "
                        "the registry (offline rigs must fall back to the "
                        "synthesizer, and every download must be "
                        "checksum-verified there)")
                    continue
                info = sf.enclosing_function(node)
                calls = info.calls if info is not None else set()
                if not any(any(m in c.lower() for m in _CHECKSUM_MARKERS)
                           for c in calls):
                    yield self.finding(
                        sf, node,
                        f"download via {fname}() without checksum "
                        "verification in the same function: a truncated "
                        "or tampered artifact would convert silently; "
                        "hash the stream (hashlib.sha256) and verify "
                        "before use")
            elif dotted(node.func) in _SUBPROCESS_ANY:
                tool = _subprocess_downloader(node)
                if tool is not None:
                    yield self.finding(
                        sf, node,
                        f"subprocess download via '{tool}': shelling out "
                        "skips the registry's checksum verification and "
                        "offline fallback; use "
                        "cuvite_tpu_torch.workloads.registry.fetch instead")


# Modules that carry device-resident phase-transition state (the slab the
# device coarsener keeps on the card across phases).  A stray host
# materialization here re-introduces the O(E) PCIe round-trip the device
# coarsener exists to remove.
PHASE_TRANSITION_PREFIXES = (
    PKG + "louvain/",
    PKG + "coarsen/",
)

# Calls that pull a device tensor to the host: torch.nonzero by name,
# and the tensor methods below with no argument.
_HOST_PULL_CALLS = {"torch.nonzero", "torch.argwhere"}
_HOST_PULL_ATTRS = {"cpu", "tolist", "numpy"}


def host_pull_label(node: ast.Call) -> str | None:
    """R010's classification of one call, shared with tier 2's R018."""
    name = dotted(node.func)
    if name in _HOST_PULL_CALLS:
        return f"{name}()"
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _HOST_PULL_ATTRS and not node.args:
            return f".{attr}()"
        if attr == "to" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "cpu":
            return ".to('cpu')"
    return None


@register
class DeviceArrayHostPull(Rule):
    id = "R010"
    severity = "medium"
    title = "device->host pull of a device-resident tensor in " \
            "phase-transition code"

    def check(self, sf):
        if not sf.rel.startswith(PHASE_TRANSITION_PREFIXES):
            return
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            label = host_pull_label(node)
            if label is None:
                continue
            yield self.finding(
                sf, node,
                f"{label} in a phase-transition module: a device->host "
                "pull here puts O(E)/O(V) bytes back on the PCIe path "
                "the device-resident coarsening removed; keep the slab "
                "on the card.  Scalar/stat reads, the one host read a "
                "sweep and THE final label gather are the allowed "
                "exceptions — carry an inline '# graftlint: "
                "disable=R010' with a justification")


# ---------------------------------------------------------------------------
# R012: unsynced timing windows.  CUDA launches are asynchronous: a
# perf_counter window that launches device work and closes without
# waiting for it records launch latency, not execution time.

TIMING_SCOPE = (PKG + "tools/",)
TIMING_FILES = (PKG + "workloads/bench.py", "chip_smoke.py",
                "kernel_ab.py")
_PERF_COUNTER_CALLS = {"time.perf_counter", "perf_counter"}
# Evidence the window waits for the card (or reads a value back, which
# blocks just as hard).
_TIMING_SYNC_CALLS = {
    "float", "int", "bool",
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
    "torch.cuda.synchronize", "torch.nonzero",
}
_TIMING_SYNC_ATTRS = {"synchronize", "item", "tolist", "cpu", "numpy",
                      "elapsed_time"}
# Direct device-launch evidence.  Conservative by design: torch ops and
# explicit uploads, and the port's kernel wrappers by name.  Calls into
# opaque callables (louvain_phases, a passed-in fn) are NOT flagged —
# the callee may sync internally.
_DISPATCH_PREFIXES = ("torch.",)
_NOT_DISPATCH = ("torch.cuda.", "torch.device", "torch.from_numpy",
                 "torch.get_num_threads", "torch.set_num_threads",
                 "torch.manual_seed", "torch.Generator", "torch.profiler",
                 "torch.no_grad", "torch.inference_mode",
                 "torch.distributed.")
KERNEL_WRAPPERS = {"row_argmax", "row_argmax_sized", "heavy_argmax",
                   "seg_coalesce", "seg_coalesce_batched",
                   "row_argmax_batched", "heavy_argmax_batched"}


def _is_dispatch(c: ast.Call) -> str | None:
    fname = dotted(c.func) or ""
    if fname.startswith(_DISPATCH_PREFIXES) \
            and not fname.startswith(_NOT_DISPATCH):
        return fname
    last = fname.split(".")[-1]
    if last in KERNEL_WRAPPERS:
        return fname
    if isinstance(c.func, ast.Attribute) and c.func.attr == "cuda":
        return ".cuda()"
    if isinstance(c.func, ast.Attribute) and _upload_call(c):
        return ".to(device)"
    return None


@register
class UnsyncedTimingWindow(Rule):
    id = "R012"
    severity = "medium"
    title = "perf_counter timing window closes without waiting for the " \
            "card"

    def check(self, sf):
        if not (sf.rel.startswith(TIMING_SCOPE)
                or _root_script(sf.rel, TIMING_FILES)):
            return
        opens: dict = {}    # (scope id, var name) -> [linenos]
        closes: list = []   # (scope, var name, BinOp node)
        calls: dict = {}    # scope id -> [Call nodes]
        for node in sf.walk():
            scope = sf.enclosing_function(node)
            key = id(scope)
            if isinstance(node, ast.Call):
                calls.setdefault(key, []).append(node)
                continue
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and dotted(node.value.func) in _PERF_COUNTER_CALLS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        opens.setdefault((key, t.id), []).append(
                            node.lineno)
            elif isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.Sub) \
                    and isinstance(node.left, ast.Call) \
                    and dotted(node.left.func) in _PERF_COUNTER_CALLS \
                    and isinstance(node.right, ast.Name):
                closes.append((key, node.right.id, node))
        for key, var, close in closes:
            begins = [ln for ln in opens.get((key, var), ())
                      if ln < close.lineno]
            if not begins:
                continue  # window opened elsewhere (param, outer scope)
            begin = max(begins)
            inside = [c for c in calls.get(key, ())
                      if begin < c.lineno < close.lineno]
            dispatch = None
            last_dispatch_ln = None
            sync_lns = []
            for c in inside:
                fname = dotted(c.func) or ""
                if fname in _TIMING_SYNC_CALLS or (
                        isinstance(c.func, ast.Attribute)
                        and c.func.attr in _TIMING_SYNC_ATTRS):
                    sync_lns.append(getattr(c, "end_lineno", None)
                                    or c.lineno)
                    continue
                d = _is_dispatch(c)
                if d:
                    dispatch = dispatch or d
                    if last_dispatch_ln is None \
                            or c.lineno > last_dispatch_ln:
                        last_dispatch_ln = c.lineno
            synced = dispatch is not None and any(
                ln >= last_dispatch_ln for ln in sync_lns)
            if dispatch and not synced:
                yield self.finding(
                    sf, close,
                    f"timing window ({var} opened line {begin}) times "
                    f"the device launch '{dispatch}' but closes without "
                    "waiting for the card (torch.cuda.synchronize / an "
                    "event's synchronize / a readback): CUDA launches "
                    "are asynchronous, so this records launch latency, "
                    "not execution time")


# ---------------------------------------------------------------------------
# R013: full-slab sorts outside the coalesce chokepoint.  The ONLY
# sanctioned full-slab sort of the coalesce is ops/segment.py
# (coalesced_runs / coalesced_runs_batched: the sort engine), whose
# engagement the bench reports as coverage; a new direct sort in
# coarsen/ or kernels/ bypasses the dense seg_coalesce kernel and the
# coverage accounting.

_SLAB_SORT_SCOPE = (
    PKG + "coarsen/",
    PKG + "kernels/",
)
_SLAB_SORT_CALLS = {"torch.sort", "torch.argsort", "torch.msort"}


@register
class SlabSortOutsideChokepoint(Rule):
    id = "R013"
    severity = "high"
    title = "full-slab device sort in coarsen/ or kernels/ outside the " \
            "coalesce chokepoint (ops/segment.coalesced_runs)"

    def check(self, sf):
        if not sf.rel.startswith(_SLAB_SORT_SCOPE):
            return
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if fname in _SLAB_SORT_CALLS:
                yield self.finding(
                    sf, node,
                    f"{fname}() in a coarsen/kernel module: full-slab "
                    "sorts live ONLY behind ops/segment.coalesced_runs "
                    "(the sort engine, whose engagement the bench "
                    "reports as coverage); route through it — or carry "
                    "an inline '# graftlint: disable=R013' with a "
                    "justification for a genuinely non-slab sort")


# ---------------------------------------------------------------------------
# R014 (upload half) and R015: per-job amortization traps in serving
# loops.  The batched serving win rests on ONE device placement and ONE
# plan build per packed batch; a per-job upload or plan build inside a
# serve/ loop silently erases it without changing any result.

_SERVE_SCOPE = (PKG + "serve/",)
_PACKER_SCOPE = (PKG + "louvain/batched.py", PKG + "core/batch.py")
_PACKER_FUNC_PREFIXES = ("pack_", "prepare_", "unpack_")


def _serve_loop_calls(sf, match):
    """(node, fname) for every call ``match`` accepts lexically inside a
    for/while loop of a serve/ module, or of a packer-path function
    (pack_*/prepare_*/unpack_* in the batched driver and slab packer)
    — the shared traversal of R014 and R015."""
    in_serve = sf.rel.startswith(_SERVE_SCOPE)
    if not in_serve and sf.rel not in _PACKER_SCOPE:
        return
    seen: set = set()
    for loop in sf.walk():
        if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            continue
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            fname = match(node)
            if fname:
                if not in_serve:
                    info = sf.enclosing_function(node)
                    if info is None or not info.name.startswith(
                            _PACKER_FUNC_PREFIXES):
                        continue
                seen.add(id(node))
                yield node, fname


def _upload_call(node: ast.Call) -> str | None:
    fname = dotted(node.func) or ""
    if fname in ("to_device", "upload.to_device"):
        return fname
    if fname in ("torch.as_tensor", "torch.tensor") \
            and any(kw.arg == "device" for kw in node.keywords):
        return fname
    if isinstance(node.func, ast.Attribute) and node.func.attr == "to" \
            and (node.args or any(kw.arg == "device"
                                  for kw in node.keywords)):
        arg = node.args[0] if node.args else None
        if isinstance(arg, ast.Attribute) and arg.attr.startswith(
                ("int", "float", "bool", "uint")):
            return None  # .to(torch.int32): a cast, not an upload
        if isinstance(arg, ast.Constant) and arg.value == "cpu":
            return None  # a download (R010's), not an upload
        return ".to(device)"
    return None


@register
class ServeLoopUploadTrap(Rule):
    id = "R014"
    severity = "high"
    title = "per-job device upload inside a serve/ queue loop"

    def check(self, sf):
        for node, fname in _serve_loop_calls(sf, _upload_call):
            yield self.finding(
                sf, node,
                f"{fname}() inside a serve/ queue loop re-uploads per "
                "job: the batched serving contract is ONE device "
                "placement per packed batch (prepare_batch uploads the "
                "stacked slab once); hoist it out of the loop, or "
                "justify with an inline '# graftlint: disable=R014'")


_PLAN_BUILD_CALLS = {
    "BucketPlan.build", "bucketed.BucketPlan.build",
    "build_stacked_plans", "bucketed.build_stacked_plans",
    "batch_bucket_plans", "batch.batch_bucket_plans",
}


@register
class ServeLoopPlanTrap(Rule):
    id = "R015"
    severity = "high"
    title = "bucket-plan construction inside a serve/ dispatch loop " \
            "(planning belongs at pack time)"

    def check(self, sf):
        def match(node):
            fname = dotted(node.func)
            return fname if fname in _PLAN_BUILD_CALLS else None

        for node, fname in _serve_loop_calls(sf, match):
            yield self.finding(
                sf, node,
                f"{fname}() inside a serve/ dispatch loop builds "
                "bucket plans per job: planning belongs at PACK "
                "time — one batch_bucket_plans call per packed "
                "batch (louvain/batched.py) — and coarse-phase "
                "re-planning belongs ON DEVICE (coarsen/rebin.py, "
                "the sanctioned in-loop re-binner); hoist the host "
                "plan construction out of the loop, or justify "
                "with an inline '# graftlint: disable=R015'")


# ---------------------------------------------------------------------------
# R016: direct wall-clock reads in serve/ outside the injectable-clock
# plumbing (serve/clock.py); time.perf_counter busy-timing stays allowed.

_SERVE_CLOCK_MODULE = PKG + "serve/clock.py"
_WALL_CLOCK_CALLS = {"time.monotonic", "time.time", "monotonic"}


@register
class ServeThreadingOutsideSeam(Rule):
    id = "R022"
    severity = "high"
    title = "threading primitive constructed directly in serve/ " \
            "outside the sync seam"

    # The seam module itself is the ONE sanctioned construction site.
    _SEAM = PKG + "serve/sync.py"
    _PRIMS = ("Thread", "Lock", "RLock", "Event", "Condition",
              "Semaphore", "BoundedSemaphore", "Barrier")

    def check(self, sf):
        # Every lock/event/thread the serving layer creates must come
        # from serve/sync.py's factories, the seam the concurrency
        # checker's cooperative scheduler installs itself behind.
        if not sf.rel.startswith(_SERVE_SCOPE) or sf.rel == self._SEAM:
            return
        aliases = {"threading"}
        bare: set = set()
        for node in sf.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "threading":
                        aliases.add(a.asname or "threading")
            elif isinstance(node, ast.ImportFrom) \
                    and node.module == "threading":
                for a in node.names:
                    if a.name in self._PRIMS:
                        bare.add(a.asname or a.name)
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if fname is None:
                continue
            hit = None
            if "." in fname:
                mod, _, attr = fname.rpartition(".")
                if mod in aliases and attr in self._PRIMS:
                    hit = fname
            elif fname in bare:
                hit = fname
            if hit is None:
                continue
            yield self.finding(
                sf, node,
                f"{hit}() constructed directly in a serve/ module: "
                "serve/ synchronization primitives must come from the "
                "serve/sync.py factories (sync.Lock/RLock/Event/"
                "Condition/Thread) so the concurrency checker's "
                "cooperative scheduler can serialize, replay and "
                "race-check them; use the seam, or justify with an "
                "inline '# graftlint: disable=R022'")


@register
class ServeWallClockOutsidePlumbing(Rule):
    id = "R016"
    severity = "high"
    title = "direct wall-clock read in serve/ outside the " \
            "injectable-clock plumbing"

    def check(self, sf):
        if not sf.rel.startswith(_SERVE_SCOPE) \
                or sf.rel == _SERVE_CLOCK_MODULE:
            return
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if fname in _WALL_CLOCK_CALLS:
                yield self.finding(
                    sf, node,
                    f"{fname}() read directly in a serve/ module: "
                    "serving deadlines must run on the INJECTABLE "
                    "clock (serve/clock.py plumbing, threaded as the "
                    "clock=/sleep= parameters) or they become "
                    "untestable without real sleeps; call the injected "
                    "clock instead (time.perf_counter busy-timing is "
                    "allowlisted, and a reference like "
                    "clock=time.monotonic as a DEFAULT is fine — only "
                    "direct calls are flagged)")


# ---------------------------------------------------------------------------
# R029: resident-slab mutation outside the apply_delta_slab chokepoint.
# A StreamSession keeps its slab RESIDENT on the card between delta
# batches, and the stream pool hands the same tensors to every later
# request, so they are live references, not scratch.  Every edit goes
# through stream/delta.py::apply_delta_slab; an in-place torch write in
# stream/ or serve/ elsewhere forks the canonical form the
# delta-vs-rebuild bit-equality tests pin.

_STREAM_SLAB_SCOPE = (
    PKG + "stream/",
    PKG + "serve/",
)
_STREAM_SLAB_CHOKEPOINT = PKG + "stream/delta.py"
SLAB_WRITE_METHODS = {
    "index_put_", "index_copy_", "index_add_", "index_fill_", "copy_",
    "scatter_", "scatter_add_", "scatter_reduce_", "masked_fill_",
    "masked_scatter_", "put_", "fill_", "zero_",
}


@register
class ResidentSlabMutationOutsideChokepoint(Rule):
    id = "R029"
    severity = "high"
    title = "resident-slab mutation in stream//serve/ outside the " \
            "apply_delta_slab chokepoint"

    def check(self, sf):
        if not sf.rel.startswith(_STREAM_SLAB_SCOPE) \
                or sf.rel == _STREAM_SLAB_CHOKEPOINT:
            return
        for node in sf.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in SLAB_WRITE_METHODS):
                continue
            what = f".{node.func.attr}()"
            yield self.finding(
                sf, node,
                f"{what} in a stream//serve/ module: resident slabs "
                "are edited ONLY through stream/delta.py::"
                "apply_delta_slab (retire + append + re-coalesce) so "
                "the canonical form the delta-vs-rebuild bit-equality "
                "tests pin cannot fork, and the tensor the pool still "
                "holds never changes under a reader; route the edit "
                "through the chokepoint, or justify a genuinely "
                "non-slab write with an inline "
                "'# graftlint: disable=R029'")
