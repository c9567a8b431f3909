"""Observability of the port (copies of ``cake_tpu/obs``): the metrics
registry and its catalog, spans, the flight recorder, the engine
profiling plane, request traces and the status page. Stdlib only at
import."""

from __future__ import annotations

from cake_tpu_torch.obs import flight


def flush_artifacts() -> None:
    """Flush the flight recorder's buffered records now (the serving
    command line calls it on its drain path)."""
    flight.recorder().flush()
