"""Incremental lint cache: per-file findings + tier-2 summaries keyed
on (content sha256, rules-set version) (port of
``cuvite_tpu/analysis/cache.py``).

The port's self-lint runs in tier-1 and in the smoke; reparsing ~120
unchanged files each time is pure tax.  The cache stores, per
repo-relative path, the file's content hash, the per-file findings it
produced, and its :func:`~cuvite_tpu_torch.analysis.callgraph.summarize`
dict — so a warm run re-parses only changed files and still runs the
project tiers over the full (cached) summary set.  A hit is
bit-identical to a cold run by construction: findings round-trip
through their dataclass fields and the project tiers always recompute
from summaries (tests/test_torch_analysis.py pins this).

Invalidation is content-based on BOTH sides of the key:

  * the file's sha256 — any edit misses;
  * :func:`rules_version` — the sha256 of every source file of the
    analysis package itself, so editing a rule, the engine, or this
    module invalidates the whole cache without anyone remembering to
    bump a counter.

The cache file is advisory: a missing, corrupt, or version-skewed file
degrades to a cold run, and writes go through a temp file + rename so
a crashed run cannot leave a torn JSON behind.  Entries untouched by
the current run are KEPT (a subset run must not evict the full-tree
warm set) up to a generous cap; growth is bounded
by the path population, and a rules-version bump resets the file.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os

CACHE_VERSION = 1

# The default location (repo-relative), created on first use, under the
# git-ignored build/ directory: never committed, never under tools/.
DEFAULT_CACHE_REL = os.path.join("build", ".graftlint_cache.json")


@functools.lru_cache(maxsize=1)
def rules_version() -> str:
    """sha256 over the analysis package's own sources (sorted), so any
    rule/engine edit invalidates every cached entry."""
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for name in sorted(os.listdir(pkg_dir)):
        if not name.endswith(".py"):
            continue
        h.update(name.encode())
        with open(os.path.join(pkg_dir, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def content_sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


class LintCache:
    """Load-once / save-once JSON cache (see module docstring)."""

    def __init__(self, path: str):
        self.path = path
        self.entries: dict = {}
        self._touched: set = set()
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return
        if not isinstance(data, dict) \
                or data.get("version") != CACHE_VERSION \
                or data.get("rules_version") != rules_version():
            return
        ents = data.get("entries")
        if isinstance(ents, dict):
            self.entries = ents

    def get(self, rel: str, sha: str):
        """(findings-as-dicts, summary) on a hit, else None."""
        ent = self.entries.get(rel)
        if not ent or ent.get("sha") != sha:
            return None
        self._touched.add(rel)
        return ent.get("findings", []), ent.get("summary")

    def put(self, rel: str, sha: str, findings, summary) -> None:
        self.entries[rel] = {
            "sha": sha,
            "findings": [f if isinstance(f, dict) else dataclasses.asdict(f)
                         for f in findings],
            "summary": summary,
        }
        self._touched.add(rel)
        self._dirty = True

    # Hard cap on entry count: untouched entries are evicted first once
    # crossed (renames/deletions accumulate dead keys VERY slowly, so
    # this mostly never fires).
    MAX_ENTRIES = 4096

    def save(self) -> None:
        """Write back (atomically); untouched entries survive (subset
        runs must not evict the warm full-tree set).  Silent on failure
        — the cache is an optimization, never a reason to fail a
        lint."""
        if not self._dirty:
            return
        if len(self.entries) > self.MAX_ENTRIES:
            for rel in sorted(set(self.entries) - self._touched):
                if len(self.entries) <= self.MAX_ENTRIES:
                    break
                del self.entries[rel]
        payload = {
            "version": CACHE_VERSION,
            "rules_version": rules_version(),
            "entries": self.entries,
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, sort_keys=True)
                fh.write("\n")
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
