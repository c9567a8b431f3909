"""CK-METRIC: every metric series name must be declared in the catalog.

The registry is get-or-create by string key, so a typo'd name silently
forks a series (``wire.byte_out`` next to ``wire.bytes_out``, each
half-populated). This checker pins every series-name **literal** at an
instrument call site — ``counter("…")`` / ``gauge`` / ``histogram``
factories and the ``Counter``/``Gauge``/``Histogram`` constructors — to
an entry in :mod:`cake_tpu_torch.obs.catalog`. F-string names (the per-segment
and per-worker families) are reduced to ``*`` patterns and must match a
declared ``DYNAMIC`` pattern verbatim. A series name the checker cannot
see through at all (a variable) is flagged too: an unverifiable name is
exactly how forks sneak in.
"""

from __future__ import annotations

import ast

from cake_tpu_torch.analysis import core
from cake_tpu_torch.obs import catalog

_FACTORIES = {"counter", "gauge", "histogram"}
_CONSTRUCTORS = {"Counter", "Gauge", "Histogram"}

# Files that legitimately handle series names as data, not as series:
# the registry itself (its factories take `name` as a parameter) and the
# catalog declarations.
_EXEMPT = {"cake_tpu_torch/obs/metrics.py",
           "cake_tpu_torch/obs/catalog.py"}


class MetricsCatalogChecker(core.Checker):
    id = "CK-METRIC"
    name = "metrics-catalog"
    description = ("every counter/gauge/histogram series name literal is "
                   "declared in cake_tpu_torch/obs/catalog.py")

    def check_module(self, mod: core.Module):
        if mod.rel in _EXEMPT or mod.rel.startswith(
                "cake_tpu_torch/analysis/"):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = core.call_name(node)
            if fn in _CONSTRUCTORS:
                # constructors must look metrics-shaped: either imported
                # via a metrics module alias (obs_metrics.Histogram) or
                # called with a dotted series-name literal — bare
                # Counter() from collections etc. stays out of scope
                chain = core.attr_chain(node.func)
                rooted = len(chain) > 1 and "metric" in chain[0].lower()
                if not rooted and not self._dotted_literal(node):
                    continue
            elif fn not in _FACTORIES:
                continue
            arg = self._name_arg(node)
            if arg is None:
                continue  # name-less constructor (anonymous instrument)
            yield from self._check_name(mod, node, arg)

    @staticmethod
    def _name_arg(call: ast.Call):
        """The series-name argument: first positional, or the ``name=``
        keyword (a kwarg spelling must not bypass the gate)."""
        if call.args:
            return call.args[0]
        for kw in call.keywords:
            if kw.arg == "name":
                return kw.value
        return None

    @classmethod
    def _dotted_literal(cls, call: ast.Call) -> bool:
        arg = cls._name_arg(call)
        s = core.literal_str(arg) if arg is not None else None
        return bool(s and "." in s)

    def _check_name(self, mod, call, arg):
        lit = core.literal_str(arg)
        if lit is not None:
            if not catalog.is_declared(lit):
                yield self.finding(
                    mod, call,
                    f"metric series '{lit}' is not declared in "
                    "cake_tpu_torch/obs/catalog.py",
                    hint="add it to catalog.SERIES (or fix the typo — a "
                         "near-miss name forks the series silently)",
                    key=lit,
                )
            return
        pat = core.fstring_pattern(arg)
        if pat is not None:
            if pat not in catalog.DYNAMIC:
                yield self.finding(
                    mod, call,
                    f"dynamic metric series pattern '{pat}' is not declared "
                    "in catalog.DYNAMIC",
                    hint="declare the family pattern (one '*' per "
                         "interpolated field) in "
                         "cake_tpu_torch/obs/catalog.py",
                    key=pat,
                )
            return
        fn = core.enclosing_function(call)
        where = getattr(fn, "name", "<module>") if fn is not None \
            else "<module>"
        yield self.finding(
            mod, call,
            "metric series name is not a literal — the catalog cannot "
            "verify it",
            hint="pass a string literal or f-string; route computed names "
                 "through a declared DYNAMIC family",
            key=f"non-literal:{where}",
        )
