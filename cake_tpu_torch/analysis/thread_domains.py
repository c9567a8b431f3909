"""CK-THREAD: declared thread domains — who may call into whom.

The Rust reference leans on ``Send``/``Sync``: the compiler knows which
values may cross threads. This tree's substitute is *declared thread
domains*, generalizing CK-ENGINE's single hard-coded rule ("only the
scheduler drives the engine") into annotations any class or module can
carry:

- ``_THREAD_DOMAIN = "engine"`` on a class (or module): its code runs
  on — and its methods may only be called from — that domain's thread.
  ``"any"`` documents a thread-safe type (internally locked) and imposes
  nothing.
- ``_THREAD_SAFE = ("submit", ...)`` on a domain-annotated class: the
  declared **crossing points** — methods callable from any domain
  because they hand work across the boundary safely (the scheduler's
  inbox + condition variable, a session's event queue, an internally
  locked read). Their bodies are checked AS "any"-domain code: a
  crossing point that itself pokes domain state is exactly the bug.
- ``_THREAD_OF = {"start": "engine"}``: per-method domain override for
  mixed classes (``Scheduler.start`` primes the engine happens-before
  the engine thread exists, so it counts as engine-domain code).
- ``_THREAD_ALIASES = ("engine",)``: conventional handle names
  instances travel under, beyond the constructor-taint pass (the
  scheduler's ``self.engine`` arrives as a parameter, not a
  construction).

A finding is a call from code lexically owned by domain A to a method of
a class owned by domain B (B not ``"any"``, A ≠ B) whose receiver is
recognizably such an instance (``self`` inside the class, a declared
alias, or a name/attr bound from the class's constructor anywhere in the
tree — scope-insensitive on purpose, same philosophy as CK-ENGINE), and
that is not a declared crossing: not in the callee's ``_THREAD_SAFE``,
and not made under ``with <lock>:`` for a lock named in the caller
class/module's ``_GUARDED_BY`` map. Unannotated caller code (the check
script, the CLI's single-threaded setup) is not checked — CK-ENGINE still
covers raw engine drives there.

The runtime twin (``CAKE_THREAD_STRICT=1``,
:mod:`cake_tpu_torch.runtime.threadcheck`) stamps the engine thread at
scheduler start and asserts membership in the annotated mutators, so
this static model is validated against real execution by the
serve/kvpool/disagg suites.

Dunder methods are exempt in both directions (construction and protocol
hooks happen-before sharing, the same rule CK-LOCK applies to
``__init__``).
"""

from __future__ import annotations

import ast
import dataclasses

from cake_tpu_torch.analysis import core

ANY = "any"


def _is_dunder(name: str) -> bool:
    return name.startswith("__") and name.endswith("__")


@dataclasses.dataclass
class _ClassInfo:
    name: str
    rel: str
    node: ast.ClassDef
    domain: str
    safe: frozenset
    of: dict
    aliases: tuple
    methods: frozenset
    guard_locks: frozenset

    def method_domain(self, meth: str) -> str:
        if meth in self.safe:
            return ANY
        return self.of.get(meth, self.domain)


def _tuple_of_strs(node) -> tuple[str, ...]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            s = core.literal_str(e)
            if s is None:
                return ()
            out.append(s)
        return tuple(out)
    return ()


def _class_assigns(body) -> dict[str, ast.AST]:
    out = {}
    for stmt in body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            out[stmt.targets[0].id] = stmt.value
    return out


class ThreadDomainChecker(core.Checker):
    id = "CK-THREAD"
    name = "thread-domains"
    description = ("calls cross a declared _THREAD_DOMAIN boundary only "
                   "through _THREAD_SAFE crossing points or _GUARDED_BY "
                   "locks")

    # -- collection --------------------------------------------------------
    def _collect(self, mods):
        classes: dict[str, list[_ClassInfo]] = {}
        module_domain: dict[str, str] = {}
        module_locks: dict[str, frozenset] = {}
        for mod in mods:
            tops = _class_assigns(mod.tree.body)
            dom = core.literal_str(tops.get("_THREAD_DOMAIN", ast.Pass()))
            if dom:
                module_domain[mod.rel] = dom
            guard = core.const_dict(tops.get("_GUARDED_BY", ast.Pass()))
            module_locks[mod.rel] = frozenset((guard or {}).values())
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                a = _class_assigns(node.body)
                cdom = core.literal_str(a.get("_THREAD_DOMAIN", ast.Pass()))
                if not cdom:
                    continue
                cguard = core.const_dict(a.get("_GUARDED_BY", ast.Pass()))
                of_raw = core.const_dict(a.get("_THREAD_OF", ast.Pass()))
                info = _ClassInfo(
                    name=node.name, rel=mod.rel, node=node, domain=cdom,
                    safe=frozenset(_tuple_of_strs(
                        a.get("_THREAD_SAFE", ast.Pass()))),
                    of=of_raw or {},
                    aliases=_tuple_of_strs(a.get("_THREAD_ALIASES",
                                                 ast.Pass())),
                    methods=frozenset(
                        s.name for s in node.body
                        if isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))),
                    guard_locks=frozenset((cguard or {}).values()),
                )
                classes.setdefault(node.name, []).append(info)
        return classes, module_domain, module_locks

    @staticmethod
    def _handles(mods, classes):
        """Receiver names instances of annotated classes travel under:
        declared aliases + names/attrs bound from a constructor call
        anywhere in the tree (scope-insensitive on purpose — a shadowing
        false positive is cheap next to a missed cross-domain call)."""
        handles: dict[str, set[str]] = {}

        def add(name, cls):
            handles.setdefault(name, set()).add(cls)

        for infos in classes.values():
            for info in infos:
                for alias in info.aliases:
                    add(alias, info.name)
        for mod in mods:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                if not (isinstance(v, ast.Call)
                        and core.call_name(v) in classes):
                    continue
                cls = core.call_name(v)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        add(t.id, cls)
                    elif isinstance(t, ast.Attribute):
                        add(t.attr, cls)
        return handles

    # -- caller resolution -------------------------------------------------
    @staticmethod
    def _caller_context(node, mod, classes, module_domain):
        """(domain, scope_name, caller_info|None) for the code lexically
        containing ``node``; domain None = unannotated (not checked)."""
        meth = None
        for anc in core.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                meth = anc
            elif isinstance(anc, ast.ClassDef):
                if meth is not None and _is_dunder(meth.name):
                    # dunder exemption regardless of class annotation:
                    # construction/protocol hooks happen-before sharing
                    # (real dunders only — a name-mangled __helper is a
                    # private method, not a protocol hook)
                    return None, meth.name, None
                infos = [i for i in classes.get(anc.name, ())
                         if i.rel == mod.rel and i.node is anc]
                if infos and meth is not None:
                    info = infos[0]
                    return (info.method_domain(meth.name),
                            f"{info.name}.{meth.name}", info)
                # unannotated class: keep walking (a nested handler class
                # inherits the enclosing module/function domain)
        dom = module_domain.get(mod.rel)
        name = getattr(meth, "name", "<module>") if meth is not None \
            else "<module>"
        return dom, name, None

    @staticmethod
    def _under_declared_lock(node, caller_info, module_locks, mod) -> bool:
        locks = set(module_locks.get(mod.rel, ()))
        if caller_info is not None:
            locks |= set(caller_info.guard_locks)
        if not locks:
            return False
        for anc in core.ancestors(node):
            if not isinstance(anc, ast.With):
                continue
            for item in anc.items:
                chain = core.attr_chain(item.context_expr)
                if chain and chain[-1] in locks:
                    return True
        return False

    # -- the pass ----------------------------------------------------------
    def finalize(self, mods):
        classes, module_domain, module_locks = self._collect(mods)
        if not classes:
            return
        handles = self._handles(mods, classes)
        # method name -> [(info, domain)] for non-any-domain methods
        callee: dict[str, list] = {}
        for infos in classes.values():
            for info in infos:
                for meth in info.methods:
                    if _is_dunder(meth):
                        continue
                    dom = info.method_domain(meth)
                    if dom != ANY:
                        callee.setdefault(meth, []).append((info, dom))
        for mod in mods:
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                meth = node.func.attr
                if meth not in callee:
                    continue
                chain = core.attr_chain(node.func.value)
                if not chain:
                    continue
                recv = chain[-1]
                caller_dom, scope, caller_info = self._caller_context(
                    node, mod, classes, module_domain)
                if caller_dom is None:
                    continue
                # resolve the callee: `self` binds to the enclosing class
                # only; any other receiver matches via handles/aliases
                if recv == "self" and len(chain) == 1:
                    cands = [(i, d) for i, d in callee[meth]
                             if caller_info is not None
                             and i.name == caller_info.name]
                else:
                    cands = [(i, d) for i, d in callee[meth]
                             if recv in handles and i.name in handles[recv]]
                if not cands:
                    continue
                doms = {d for _, d in cands}
                if caller_dom in doms:
                    continue  # same-domain (or ambiguous toward same)
                if self._under_declared_lock(node, caller_info,
                                             module_locks, mod):
                    continue
                info, dom = cands[0]
                yield self.finding(
                    mod, node,
                    f"call into thread domain '{dom}' "
                    f"('{'.'.join(chain)}.{meth}()' -> {info.name}) from "
                    f"'{caller_dom}' code in {scope}",
                    hint="cross domains only through declared crossing "
                         "points: a _THREAD_SAFE method on the owner "
                         "(inbox/queue hand-off), or a lock named in "
                         "_GUARDED_BY — or annotate the method "
                         "thread-safe if it truly is",
                    key=f"{info.name}.{meth}:{scope}",
                )
