"""CK-ENGINE: the scheduler is the only caller of the engine. Ever.

``BatchGenerator`` mutates device state on every ``step()``; the serving
plane is safe only because exactly one thread — the scheduler's engine
thread — ever calls its mutating surface, while HTTP handlers talk to
sessions. That ownership line is stated in serve/scheduler.py's docstring
and nowhere else; this checker enforces it: outside the allowed owners,
no code may call a mutating engine method (``step``/``enqueue``/
``finish``/``set_prompts``/``drain``/``warm_admission``) on anything that
is an engine — a variable bound from a ``BatchGenerator``/
``SingleStreamEngine``/``MeshEngine`` construction, or any ``.engine``
attribute (the conventional name the scheduler and CLI use for the
handle).

Deliberate direct drives (``chip_smoke.py`` checks the raw engine on
the card without a serving plane) are grandfathered in the committed
baseline with a justification each.
"""

from __future__ import annotations

import ast

from cake_tpu_torch.analysis import core

MUTATING = {"step", "enqueue", "finish", "set_prompts", "drain",
            "warm_admission"}

# the port's engines: the batch engine, the one-slot facade over the wire
# master, and rank 0's handle on a mesh's engine
ENGINE_CONSTRUCTORS = {"BatchGenerator", "SingleStreamEngine", "MeshEngine"}

# The owners: the scheduler (the one runtime caller), the engine
# implementations themselves (internal self-calls), and the facades.
ALLOWED = {
    "cake_tpu_torch/serve/scheduler.py",
    "cake_tpu_torch/runtime/batch_generator.py",
    "cake_tpu_torch/serve/engine.py",
    "cake_tpu_torch/serve/mesh.py",
}


class EngineOwnershipChecker(core.Checker):
    id = "CK-ENGINE"
    name = "engine-ownership"
    description = ("only serve/scheduler.py (and the engine modules "
                   "themselves) may call mutating BatchGenerator methods")

    def check_module(self, mod: core.Module):
        if mod.rel in ALLOWED:
            return
        tainted = self._engine_names(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            meth = node.func.attr
            if meth not in MUTATING:
                continue
            recv = node.func.value
            chain = core.attr_chain(recv)
            is_engine = bool(chain) and (
                chain[-1] == "engine" or chain[-1] in tainted
                or (len(chain) == 1 and chain[0] in tainted)
            )
            if not is_engine:
                continue
            yield self.finding(
                mod, node,
                f"mutating engine call '.{meth}()' outside the scheduler "
                f"(receiver '{'.'.join(chain)}')",
                hint="the engine has ONE owner — route work through "
                     "serve.scheduler.Scheduler (submit/cancel), or "
                     "baseline a deliberate direct drive with a "
                     "justification",
                key=f"BatchGenerator.{meth}",
            )

    @staticmethod
    def _engine_names(mod: core.Module) -> set[str]:
        """Names bound (anywhere in the module) from an engine
        construction: ``gen = BatchGenerator(...)`` and rebindings of the
        same name. Scope-insensitive on purpose — a shadowing false
        positive is cheap next to a missed engine drive."""
        tainted: set[str] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            if not (isinstance(value, ast.Call)
                    and core.call_name(value) in ENGINE_CONSTRUCTORS):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    tainted.add(tgt.id)
        return tainted
