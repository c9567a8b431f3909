"""CK-JIT: bodies that PyTorch captures or compiles must be host-pure.

The JAX package's checker guards ``jax.jit`` bodies, which run once at
trace time. The port's counterparts are the bodies PyTorch records or
compiles and then replays without running their Python again:

- a CUDA graph capture: the body of ``with torch.cuda.graph(g):``, the
  statements between ``g.capture_begin()`` and ``g.capture_end()``, and
  the callables handed to ``torch.cuda.make_graphed_callables``;
- ``torch.compile``: a function handed to it (directly, through
  ``partial(...)``, as a lambda) or decorated with it;
- ``torch.autograd.Function.forward`` of a custom autograd function.

A host-side effect there — ``time.perf_counter()``, ``random.random()``,
a registry counter, a ``print`` — runs once, at capture (or at a graph
break it forces under ``torch.compile``), so a replayed step times
nothing, draws the same "random" number and counts one step. A host sync
— ``.item()``, ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize()`` —
is illegal inside a capture and breaks a compiled graph in two. Flagged:

- ``time.*``, ``datetime.*``, ``random.*``, ``np.random.*``;
- ``print``, ``logging.*`` and ``log.*``/``logger.*`` calls;
- metrics-registry calls (``obs_metrics.*``; ``.inc()``/``.observe()``/
  ``.set()`` on module-level ALL_CAPS instruments);
- ``.item()``, ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize()``.

Resolution is one module deep (a Name argument resolves to a function
defined in the same file); helpers it calls are not recursed into.
"""

from __future__ import annotations

import ast

from cake_tpu_torch.analysis import core

_IMPURE_ROOTS = {"time", "random", "datetime", "logging"}
_LOGGER_NAMES = {"log", "logger"}
_METRIC_MODULES = {"obs_metrics", "_metrics", "metrics"}
_INSTRUMENT_METHODS = {"inc", "observe", "set"}
# methods that wait for the card (any receiver)
_SYNC_METHODS = {"item", "cpu", "tolist"}


def _is_compile(node: ast.AST) -> bool:
    """``torch.compile`` as a callee (a bare ``compile`` is Python's
    builtin)."""
    chain = core.attr_chain(node)
    return chain == ["torch", "compile"]


def _is_graph_ctx(node: ast.AST) -> bool:
    """``torch.cuda.graph(g)`` / ``cuda.graph(g)`` as a with item."""
    if not isinstance(node, ast.Call):
        return False
    chain = core.attr_chain(node.func)
    return chain[-2:] == ["cuda", "graph"]


def _is_graphed_callables(call: ast.Call) -> bool:
    return core.attr_chain(call.func)[-1:] == ["make_graphed_callables"]


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        chain = core.attr_chain(base)
        if chain[-2:] == ["autograd", "Function"] or chain == ["Function"]:
            return True
    return False


class TracePurityChecker(core.Checker):
    id = "CK-JIT"
    name = "trace-purity"
    description = ("bodies captured into a CUDA graph, compiled by "
                   "torch.compile or run as an autograd Function's forward "
                   "must not call host effects (time, random, print, "
                   "logging, metrics) or wait for the card (.item(), "
                   ".cpu(), .tolist(), torch.cuda.synchronize())")

    def check_module(self, mod: core.Module):
        defs = self._defs_by_name(mod.tree)
        targets: dict[int, tuple[ast.AST, str, str]] = {}

        def add(node, via: str, name: str):
            if node is not None:
                targets.setdefault(id(node), (node, via, name))

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                if _is_compile(node.func) and node.args:
                    fn = self._resolve(node.args[0], defs)
                    add(fn, "torch.compile", self._fn_name(fn))
                elif _is_graphed_callables(node) and node.args:
                    first = node.args[0]
                    items = first.elts if isinstance(
                        first, (ast.Tuple, ast.List)) else [first]
                    for item in items:
                        fn = self._resolve(item, defs)
                        add(fn, "make_graphed_callables",
                            self._fn_name(fn))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(self._decorator_compiles(d)
                       for d in node.decorator_list):
                    add(node, "torch.compile", node.name)
            elif isinstance(node, ast.ClassDef) \
                    and _is_autograd_function(node):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) \
                            and item.name == "forward":
                        add(item, "autograd.Function",
                            f"{node.name}.forward")
            elif isinstance(node, ast.With):
                if any(_is_graph_ctx(i.context_expr) for i in node.items):
                    add(node, "torch.cuda.graph", "<graph capture>")
        for captured in self._capture_spans(mod.tree):
            add(captured[0], "capture_begin", "<graph capture>")
        for node, via, name in targets.values():
            yield from self._check_body(mod, node, via, name)

    # -- resolution --------------------------------------------------------
    @staticmethod
    def _defs_by_name(tree) -> dict[str, ast.AST]:
        return {
            n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

    @staticmethod
    def _fn_name(fn) -> str:
        return getattr(fn, "name", "<lambda>")

    def _resolve(self, arg: ast.AST, defs) -> ast.AST | None:
        if isinstance(arg, ast.Lambda):
            return arg
        if isinstance(arg, ast.Name):
            return defs.get(arg.id)
        if isinstance(arg, ast.Call):
            if "partial" in core.call_name(arg) and arg.args:
                return self._resolve(arg.args[0], defs)
            if _is_compile(arg.func) and arg.args:
                return self._resolve(arg.args[0], defs)
        return None

    @staticmethod
    def _decorator_compiles(dec: ast.AST) -> bool:
        if isinstance(dec, ast.Call):
            if "partial" in core.call_name(dec) and dec.args:
                return _is_compile(dec.args[0])
            return _is_compile(dec.func)
        return _is_compile(dec)

    @staticmethod
    def _capture_spans(tree):
        """``(first, statements)`` of each run of statements between
        ``g.capture_begin()`` and ``g.capture_end()`` in one block."""
        for node in ast.walk(tree):
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if not isinstance(block, list):
                    continue
                start = None
                for i, stmt in enumerate(block):
                    call = stmt.value if isinstance(stmt, ast.Expr) else None
                    meth = core.call_name(call) if isinstance(
                        call, ast.Call) else ""
                    if meth == "capture_begin":
                        start = i
                    elif meth == "capture_end" and start is not None:
                        span = block[start + 1:i]
                        if span:
                            holder = ast.Module(body=span, type_ignores=[])
                            yield holder, span
                        start = None

    # -- purity walk -------------------------------------------------------
    def _check_body(self, mod, node, via: str, name: str):
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            impure = self._impurity(call)
            if impure is None:
                continue
            yield self.finding(
                mod, call,
                f"host call '{impure}' inside '{name}', which is captured "
                f"or compiled (via {via}) — it runs at capture, not at "
                "each replay, or waits for the card",
                hint="hoist the effect to the host-side caller (record "
                     "around the replay), and keep values on the card "
                     "inside the body",
                key=f"{name}:{impure}",
            )

    @staticmethod
    def _impurity(call: ast.Call) -> str | None:
        chain = core.attr_chain(call.func)
        if not chain:
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _SYNC_METHODS:
                return f".{call.func.attr}"  # x[0].item()
            return None
        root, last = chain[0], chain[-1]
        dotted = ".".join(chain)
        if chain == ["print"]:
            return "print"
        if chain[-3:] == ["torch", "cuda", "synchronize"] or \
                chain == ["cuda", "synchronize"]:
            return dotted
        if len(chain) > 1 and last in _SYNC_METHODS:
            return f".{last}"
        if root in _IMPURE_ROOTS and len(chain) > 1:
            return dotted
        if root in _LOGGER_NAMES and len(chain) == 2 and last in (
                "debug", "info", "warning", "error", "exception", "critical",
                "log"):
            return dotted
        if root in ("np", "numpy") and len(chain) > 2 and chain[1] == "random":
            return dotted
        if root in _METRIC_MODULES and len(chain) > 1:
            return dotted
        if (last in _INSTRUMENT_METHODS and len(chain) == 2
                and root.isupper()):
            return dotted  # module-level instrument: REJECTED.inc()
        return None
