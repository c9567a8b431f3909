"""cakelint core: findings, checker protocol, AST driver.

The repo's load-bearing invariants — one engine owner, declared metric
series, lock discipline, trace-pure jitted bodies, deadline-bounded wire
reads — live in CHANGES.md prose and reviewer memory. This package turns
them into AST checks that gate CI (``make lint``), the same role Clang's
thread-safety annotations and TSan play for C++ servers.

Architecture: one driver parses every file once into a :class:`Module`
(AST with parent links + source lines), then hands each module to every
registered :class:`Checker`. Checkers are per-module visitors with an
optional :meth:`Checker.finalize` pass over the whole module set for
cross-file invariants (e.g. "every MsgType has a send arm somewhere").
Findings carry ``file:line:col``, a checker id, a message, a fix hint,
and a stable ``key`` so baselines survive unrelated line drift.

Suppression: a finding whose source line (or the line above it) carries
``cakelint: ignore[CK-ID]`` (or a bare ``cakelint: ignore``) is dropped —
the escape hatch for a justified one-off that doesn't warrant a
baseline entry.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import tokenize
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]

# Scan surface: the port's package and the card check script. Tests are
# deliberately out — they exercise invariant-breaking paths on purpose
# (chaos faults, lock races, raw engine drives).
DEFAULT_ROOTS = ("cake_tpu_torch", "chip_smoke.py")

# _build: what the kernel build leaves under ops/kernels
_SKIP_DIRS = {"__pycache__", ".git", "native", "_build"}

# sentinel for "no suppression comment on this line" (a bare ignore
# comment parses to None-ids, so None cannot also mean absence)
_NO_IGNORE = object()


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation at a source location."""

    checker: str  # checker id, e.g. "CK-METRIC"
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    hint: str = ""
    # Stable identity for baselines: (checker, path, key) — key defaults
    # to the message, but checkers set something line-independent (a
    # series name, "BatchGenerator.step", "MsgType.X:send") so a baseline
    # entry survives edits elsewhere in the file.
    key: str = ""

    @property
    def baseline_key(self) -> tuple[str, str, str]:
        return (self.checker, self.path, self.key or self.message)

    def to_dict(self) -> dict:
        return {
            "checker": self.checker,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
            "key": self.key or self.message,
        }

    def render(self) -> str:
        s = (f"{self.path}:{self.line}:{self.col}: {self.checker} "
             f"{self.message}")
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s

    def sort_key(self):
        return (self.path, self.line, self.col, self.checker)


class Module:
    """One parsed source file: AST with parent links + raw lines."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        add_parents(self.tree)
        self._comments: dict[int, str] | None = None

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def comment_at(self, lineno: int) -> str:
        """The REAL comment token on ``lineno`` ('' if none), from one
        lazy tokenize pass — so a ``#`` inside a string literal can
        neither suppress nor read as a suppression comment."""
        if self._comments is None:
            comments: dict[int, str] = {}
            try:
                for tok in tokenize.generate_tokens(
                        io.StringIO(self.source).readline):
                    if tok.type == tokenize.COMMENT:
                        comments[tok.start[0]] = tok.string
            except tokenize.TokenError:
                pass  # already ast-parsed; truncated trailer at worst
            self._comments = comments
        return self._comments.get(lineno, "")

    def suppression_line(self, finding: Finding) -> int | None:
        """Line number of the ``cakelint: ignore[ID]`` comment covering
        this finding (its own line or the line above — the
        comment-only-line idiom), or None."""
        for ln in (finding.line, finding.line - 1):
            ids = self.ignore_at(ln)
            if ids is _NO_IGNORE:
                continue
            if ids is None or finding.checker in ids:
                return ln
        return None

    def suppressed(self, finding: Finding) -> bool:
        return self.suppression_line(finding) is not None

    def ignore_at(self, lineno: int):
        """Parse a suppression comment on ``lineno``: returns the
        ``_NO_IGNORE`` sentinel when there is none, else the listed
        checker ids (or None for a bare id-less ignore). The marker must
        sit inside the line's actual comment token — prose mentions in
        docstrings or string literals don't suppress."""
        text = self.comment_at(lineno)
        if "cakelint: ignore" not in text:
            return _NO_IGNORE
        mark = text.split("cakelint: ignore", 1)[1]
        if not mark.startswith("["):  # bare ignore: every checker
            return None
        return [i.strip() for i in mark[1:].split("]", 1)[0].split(",")]

    def ignore_comments(self):
        """Every suppression comment in the file: ``[(line, ids|None)]``
        (ids None = bare ignore)."""
        out = []
        for ln, text in enumerate(self.lines, start=1):
            parsed = self.ignore_at(ln)
            if parsed is not _NO_IGNORE:
                out.append((ln, parsed))
        return out


class Checker:
    """Base checker. Subclasses set ``id``/``name``/``description`` and
    implement :meth:`check_module` (per-file) and/or :meth:`finalize`
    (after every module has been seen — cross-file invariants)."""

    id = "CK-BASE"
    name = "base"
    description = ""

    def check_module(self, mod: Module):
        return ()

    def finalize(self, mods: list[Module]):
        return ()

    # -- convenience for subclasses --------------------------------------
    def finding(self, mod: Module, node: ast.AST, message: str,
                hint: str = "", key: str = "") -> Finding:
        return Finding(
            checker=self.id, path=mod.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message, hint=hint, key=key,
        )


# -- AST helpers (shared by every checker) -------------------------------

def add_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.cakelint_parent = node  # type: ignore[attr-defined]


def parent(node: ast.AST):
    return getattr(node, "cakelint_parent", None)


def ancestors(node: ast.AST):
    n = parent(node)
    while n is not None:
        yield n
        n = parent(n)


def attr_chain(node: ast.AST) -> list[str]:
    """``self._cond.notify`` -> ["self", "_cond", "notify"]; empty list
    for anything that isn't a pure Name/Attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def call_name(call: ast.Call) -> str:
    """Last name of the called thing ("" if unresolvable)."""
    chain = attr_chain(call.func)
    return chain[-1] if chain else ""


def literal_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def fstring_pattern(node: ast.AST) -> str | None:
    """Reduce an f-string to a catalog pattern: every interpolated field
    becomes ``*`` (``f"seg{i}.ms"`` -> ``"seg*.ms"``)."""
    if not isinstance(node, ast.JoinedStr):
        return None
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(str(v.value))
        elif isinstance(v, ast.FormattedValue):
            parts.append("*")
        else:
            return None
    return "".join(parts)


def const_dict(node: ast.AST) -> dict[str, str] | None:
    """A ``{"attr": "lock"}`` literal as a plain dict (None otherwise)."""
    if not isinstance(node, ast.Dict):
        return None
    out: dict[str, str] = {}
    for k, v in zip(node.keys, node.values):
        ks, vs = literal_str(k) if k else None, literal_str(v)
        if ks is None or vs is None:
            return None
        out[ks] = vs
    return out


def enclosing_function(node: ast.AST):
    for a in ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return a
    return None


def statement_of(node: ast.AST) -> ast.stmt | None:
    """The nearest enclosing statement node."""
    cur: ast.AST | None = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = parent(cur)
    return cur  # type: ignore[return-value]


def contains_name(node: ast.AST, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node)
    )


# -- driver --------------------------------------------------------------

def iter_py_files(roots, repo_root: Path):
    for root in roots:
        p = Path(root)
        if not p.is_absolute():
            p = repo_root / p
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    yield f


def load_modules(roots=None, repo_root: Path | None = None):
    """Parse the scan surface. Returns (modules, parse_findings) — a
    syntactically broken file is itself a finding, not a crash."""
    repo_root = repo_root or REPO_ROOT
    roots = roots or DEFAULT_ROOTS
    mods: list[Module] = []
    findings: list[Finding] = []
    for f in iter_py_files(roots, repo_root):
        try:
            rel = f.resolve().relative_to(repo_root).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            mods.append(Module(f, rel, f.read_text()))
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                checker="CK-PARSE", path=rel,
                line=getattr(e, "lineno", 1) or 1, col=0,
                message=f"file does not parse: {e.__class__.__name__}: {e}",
                key="parse",
            ))
    return mods, findings


def is_full_scan(roots, repo_root: Path | None = None) -> bool:
    """Cross-file (finalize) checks need the whole tree in view:
    'MsgType.X is never sent anywhere' is meaningless when 'anywhere'
    is one file or one subpackage. Full = the default surface (no
    explicit roots) or a root that IS the repo root. Partial scans also
    skip stale-baseline judgement — they cannot tell 'fixed' from
    'not re-checked'."""
    if roots is None:
        return True
    repo_root = (repo_root or REPO_ROOT).resolve()
    for r in roots:
        p = Path(r)
        if not p.is_absolute():
            p = repo_root / p
        try:
            if p.resolve() == repo_root:
                return True
        except OSError:
            continue
    return False


def check_modules(mods, checkers, full: bool = True, parse_findings=(),
                  unused_out: list | None = None):
    """Run ``checkers`` over an already-parsed module list (one walk of
    the tree feeds both the checkers and any caller that needs the
    scanned-path set). ``full=False`` skips cross-file ``finalize``
    passes. Returns sorted findings with suppressions applied.

    With ``unused_out`` (a list), suppression comments that suppressed
    NOTHING this run are appended as ``{"path", "line", "ids"}`` dicts —
    the in-source twin of a stale baseline entry. Callers pass it only
    on full scans with every checker enabled: a subset run cannot tell
    "nothing to suppress" from "the suppressing checker didn't run"."""
    findings = list(parse_findings)
    by_rel = {m.rel: m for m in mods}
    for checker in checkers:
        for mod in mods:
            findings.extend(checker.check_module(mod))
        if full:
            findings.extend(checker.finalize(mods))
    kept = []
    hits: set[tuple[str, int]] = set()
    for f in findings:
        mod = by_rel.get(f.path)
        if mod is not None:
            ln = mod.suppression_line(f)
            if ln is not None:
                hits.add((f.path, ln))
                continue
        kept.append(f)
    if unused_out is not None:
        for mod in mods:
            for ln, ids in mod.ignore_comments():
                if (mod.rel, ln) not in hits:
                    unused_out.append(
                        {"path": mod.rel, "line": ln, "ids": ids})
    return sorted(kept, key=Finding.sort_key)


def run_checkers(checkers, roots=None, repo_root: Path | None = None):
    """Parse the scan surface and run ``checkers`` over it. Cross-file
    ``finalize`` passes are skipped on file-scoped scans (see
    :func:`is_full_scan`)."""
    mods, parse_findings = load_modules(roots, repo_root)
    return check_modules(mods, checkers, is_full_scan(roots, repo_root),
                         parse_findings)
