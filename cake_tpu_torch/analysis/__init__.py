"""cakelint for the PyTorch/CUDA port: project-specific static analysis
that gates CI (a copy of ``cake_tpu/analysis`` pointed at the port; the
port imports nothing of the JAX package).

``python -m cake_tpu_torch.analysis --baseline analysis-baseline-torch.json``
runs every registered checker over the port's package and
``chip_smoke.py``, and exits nonzero on any finding not grandfathered by
the baseline. See ``core.py`` for the framework, the sibling modules for
the checkers (CK-JIT, :mod:`.trace_purity`, in its PyTorch form: CUDA
graph captures, ``torch.compile`` and autograd Functions), and README
"Static analysis" for the workflow (baseline, suppressions, adding a
checker).
"""

from __future__ import annotations

from cake_tpu_torch.analysis.core import (  # noqa: F401
    DEFAULT_ROOTS,
    REPO_ROOT,
    Checker,
    Finding,
    Module,
    run_checkers,
)
from cake_tpu_torch.analysis.claims import ClaimChecker
from cake_tpu_torch.analysis.engine_ownership import EngineOwnershipChecker
from cake_tpu_torch.analysis.guarded_by import GuardedByChecker
from cake_tpu_torch.analysis.metrics_catalog import MetricsCatalogChecker
from cake_tpu_torch.analysis.thread_domains import ThreadDomainChecker
from cake_tpu_torch.analysis.trace_purity import TracePurityChecker
from cake_tpu_torch.analysis.wire_safety import WireSafetyChecker

ALL_CHECKERS = (
    MetricsCatalogChecker,
    EngineOwnershipChecker,
    GuardedByChecker,
    TracePurityChecker,
    WireSafetyChecker,
    ClaimChecker,
    ThreadDomainChecker,
)


def default_checkers() -> list[Checker]:
    return [cls() for cls in ALL_CHECKERS]


def run(roots=None, checkers=None, repo_root=None) -> list[Finding]:
    """Run (a subset of) the suite; returns raw findings (no baseline)."""
    return run_checkers(checkers or default_checkers(), roots=roots,
                        repo_root=repo_root)
