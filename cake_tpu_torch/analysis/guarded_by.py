"""CK-LOCK: ``_GUARDED_BY`` lock-discipline annotations, enforced.

Clang's ``GUARDED_BY`` for this tree: a class (or module) declares which
attributes its lock protects, and this checker verifies every touch of a
guarded attribute happens lexically inside ``with self.<lock>:`` (or
``with <lock>:`` for module globals). The annotation is a plain class
attribute, so it documents the threading contract at the top of the
class AND makes it machine-checked::

    class Scheduler:
        _GUARDED_BY = {"_queue": "_cond", "_by_sid": "_cond"}

Escape hatches, each an explicit reviewable convention:

- ``__init__``/``__new__`` are exempt (construction happens-before any
  sharing);
- a method named ``*_locked`` asserts "caller holds the lock" — the same
  contract the scheduler already encodes in ``_expire_queued_locked``;
- ``cakelint: ignore[CK-LOCK]`` on the line for single-site exceptions
  (e.g. a deliberate lock-free atomic read).

The checker is lexical, not a race detector: it cannot see a lock held
by a caller (hence ``*_locked``) and does not model aliasing. What it
does catch is the class of bug that bit ``Scheduler._deliver``/``_retire``
— a shared dict read off-thread without the condition lock — the moment
it is written, not when a soak test flakes.
"""

from __future__ import annotations

import ast

from cake_tpu_torch.analysis import core


class GuardedByChecker(core.Checker):
    id = "CK-LOCK"
    name = "guarded-by"
    description = ("attributes in a _GUARDED_BY map may only be touched "
                   "inside `with <lock>:` blocks")

    def check_module(self, mod: core.Module):
        # class-level maps: self.<attr> guarded by self.<lock>
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                guarded = self._guarded_map(node.body)
                if guarded:
                    yield from self._check_class(mod, node, guarded)
        # module-level map: bare globals guarded by a module lock
        guarded = self._guarded_map(mod.tree.body)
        if guarded:
            yield from self._check_globals(mod, guarded)

    @staticmethod
    def _guarded_map(body) -> dict[str, str]:
        for stmt in body:
            if (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "_GUARDED_BY"):
                return core.const_dict(stmt.value) or {}
        return {}

    # -- class attrs ------------------------------------------------------
    def _check_class(self, mod, cls: ast.ClassDef, guarded: dict[str, str]):
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in ("__init__", "__new__"):
                continue
            if item.name.endswith("_locked"):
                continue  # contract: caller holds the lock
            for node in ast.walk(item):
                if not (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"
                        and node.attr in guarded):
                    continue
                lock = guarded[node.attr]
                if self._under_lock(node, ("self", lock)):
                    continue
                yield self.finding(
                    mod, node,
                    f"'self.{node.attr}' is _GUARDED_BY 'self.{lock}' but "
                    f"touched outside `with self.{lock}:` "
                    f"(in {cls.name}.{item.name})",
                    hint=f"wrap the access in `with self.{lock}:`, or name "
                         "the method *_locked if every caller already "
                         "holds it",
                    key=f"{cls.name}.{item.name}:{node.attr}",
                )

    # -- module globals ----------------------------------------------------
    def _check_globals(self, mod, guarded: dict[str, str]):
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Name) and node.id in guarded):
                continue
            fn = core.enclosing_function(node)
            if fn is None:
                continue  # module top level: import-time init, single thread
            if self._is_local(fn, node.id):
                continue  # a local that shadows the guarded global
            lock = guarded[node.id]
            if self._under_lock(node, (lock,)):
                continue
            yield self.finding(
                mod, node,
                f"global '{node.id}' is _GUARDED_BY '{lock}' but touched "
                f"outside `with {lock}:` "
                f"(in {getattr(fn, 'name', '<lambda>')})",
                hint=f"wrap the access in `with {lock}:`",
                key=f"{getattr(fn, 'name', '<lambda>')}:{node.id}",
            )

    @staticmethod
    def _is_local(fn, name: str) -> bool:
        """True if ``name`` is a local binding inside ``fn`` (param or
        assignment target) with no ``global`` declaration — Python scoping
        makes every use a local then, not a touch of the guarded global."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Global) and name in node.names:
                return False
        args = fn.args
        params = [*args.posonlyargs, *args.args, *args.kwonlyargs]
        if args.vararg:
            params.append(args.vararg)
        if args.kwarg:
            params.append(args.kwarg)
        if any(a.arg == name for a in params):
            return True
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and node.id == name and isinstance(
                    node.ctx, ast.Store):
                return True
        return False

    @staticmethod
    def _under_lock(node: ast.AST, lock_chain: tuple[str, ...]) -> bool:
        want = list(lock_chain)
        for anc in core.ancestors(node):
            if not isinstance(anc, ast.With):
                continue
            for item in anc.items:
                if core.attr_chain(item.context_expr) == want:
                    return True
        return False
