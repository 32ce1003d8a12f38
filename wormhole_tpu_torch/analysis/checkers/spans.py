"""WH-SPAN: every span name declared once in the central span table.

The step ledger folds trace spans into wall-time buckets by name; a
renamed instrumentation site silently falls out of its bucket. Rules:
every literal (or literal-prefixed) span name resolves through
``SPAN_TABLE`` (exact entry, ``prefix*`` pattern, ``eval_`` fold,
``_stall`` rule, or the ``<feed>:<stage>`` stage rule), and the table
itself is declared exactly once with no duplicate keys.
"""

from __future__ import annotations

import ast
import re

from wormhole_tpu_torch.analysis.engine import PACKAGE, Checker, FileContext

# literal (or `pfx + "literal"`) first args to Timer.scope — the timer
# relays the name into the trace sink verbatim (modulo the prefix,
# which instrumentation only uses for the eval_ fold)
_SCOPE_PAT = re.compile(
    r"\.scope\(\s*(?:\w+\s*\+\s*)?" + r"['\"]([^'\"]+)['\"]")
# literal span/complete/stage names
_SPAN_LIT_PAT = re.compile(
    r"trace\.(?:span|complete|stage)" + r"\(\s*['\"]([^'\"]+)['\"]")
# f-string span/complete names with a literal prefix before the first
# placeholder — the prefix must match a `prefix*` table pattern
_SPAN_FPAT = re.compile(
    r"trace\.(?:span|complete)" + r"\(\s*f['\"]([^'\"{}]+)\{")

_TABLE_NAME = "SPAN_TABLE"
_LEDGER_REL = f"{PACKAGE}/obs/ledger.py"


def _table_assigns(tree, rel: str):
    """Yield (site, keys, dups) for each SPAN_TABLE assignment."""
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == _TABLE_NAME
                   for t in targets):
            continue
        keys, dups = [], []
        val = node.value
        if isinstance(val, ast.Dict):
            seen = set()
            for k in val.keys:
                if isinstance(k, ast.Constant) \
                        and isinstance(k.value, str):
                    if k.value in seen:
                        dups.append(k.value)
                    seen.add(k.value)
                    keys.append(k.value)
        yield f"{rel}:{node.lineno}", keys, dups


def _sites_in_text(text: str, rel: str, sites: dict) -> None:
    for pat, is_prefix in ((_SCOPE_PAT, False),
                           (_SPAN_LIT_PAT, False),
                           (_SPAN_FPAT, True)):
        for m in pat.finditer(text):
            ln = text.count("\n", 0, m.start()) + 1
            sites.setdefault((m.group(1), is_prefix),
                             []).append(f"{rel}:{ln}")


def _resolves(name: str, is_prefix: bool, keys: list) -> bool:
    """Mirror of obs.ledger.span_bucket's matching rules, against the
    AST-extracted table (so synthetic test trees lint standalone)."""
    if is_prefix:
        # an f-string prefix matches any * pattern on the same stem
        return any(k.endswith("*")
                   and (k[:-1].startswith(name) or name.startswith(k[:-1]))
                   for k in keys)
    if name in keys:
        return True
    if name.startswith("eval_"):
        return _resolves(name[5:], False, keys)
    if name.endswith("_stall"):
        return True
    if any(k.endswith("*") and name.startswith(k[:-1]) for k in keys):
        return True
    if ":" in name:
        return name.rsplit(":", 1)[1] in keys
    return False


class SpanChecker(Checker):
    name = "spans"
    code = "WH-SPAN"

    def __init__(self, root: str) -> None:
        super().__init__(root)
        self.keys: list = []
        self.dups: list = []
        self.decl_sites: list = []
        self.sites: dict = {}

    def visit(self, ctx: FileContext) -> None:
        _sites_in_text(ctx.raw, ctx.rel, self.sites)
        if _TABLE_NAME not in ctx.raw:
            return           # cheap gate before the shared parse
        tree = ctx.tree
        if tree is None:
            return
        for site, keys, dups in _table_assigns(tree, ctx.rel):
            self.decl_sites.append(site)
            self.keys.extend(keys)
            self.dups.extend(dups)

    def finish(self) -> None:
        if len(self.decl_sites) != 1:
            self.report(_LEDGER_REL, None,
                        f"SPAN_TABLE declared at {len(self.decl_sites)} "
                        f"sites (want exactly 1): "
                        f"{', '.join(self.decl_sites) or 'none'}")
        for k in self.dups:
            self.report(_LEDGER_REL, None, f"duplicate SPAN_TABLE key {k!r}")
        missing = {name: where
                   for (name, is_prefix), where in sorted(self.sites.items())
                   if not _resolves(name, is_prefix, self.keys)}
        for name, where in sorted(missing.items()):
            rel, ln = where[0].rsplit(":", 1)
            self.report(rel, int(ln),
                        f"span name {name!r} used but not declared in "
                        f"SPAN_TABLE ({', '.join(where)})")

    def ok_line(self) -> str:
        n_sites = sum(len(w) for w in self.sites.values())
        return (f"{self.name}: OK ({n_sites} instrumentation sites "
                f"resolve through {len(self.keys)} table entries)")
