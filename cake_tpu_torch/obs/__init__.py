"""Observability of the port (copies of ``cake_tpu/obs``): the metrics
registry and its catalog, spans, the flight recorder, the engine
profiling plane, request traces and the status page. Stdlib only at
import.

CLI surface: ``--trace PATH``, ``--metrics-out PATH``, ``--flight-log
PATH``, ``--prof-sample N``, ``--status-port``/``--status-bind``.
"""

from __future__ import annotations

import logging

from cake_tpu_torch.obs import flight  # noqa: F401
from cake_tpu_torch.obs.metrics import registry  # noqa: F401
from cake_tpu_torch.obs.trace import span, tracer  # noqa: F401

# -- artifact durability ------------------------------------------------------
#
# The command line writes its observability artifacts on the clean exit
# path; these hooks also land them for a SIGTERM'd or SIGINT'd run: flush on
# the signal (then chain to the previous handler, so the exit is unchanged)
# and at exit as the backstop for sys.exit paths.

_flush_state = {"metrics_out": None, "installed": False, "prev": {}}


def flush_artifacts() -> None:
    """Flush every enabled observability sink now (idempotent; safe from a
    signal handler: the flight and metrics locks it takes are reentrant)."""
    flight.recorder().flush()
    path = _flush_state["metrics_out"]
    if path:
        try:
            registry().dump_json(path)
        except OSError as e:
            logging.getLogger("cake_tpu_torch.obs").error(
                "metrics flush to %s failed: %s", path, e)


def _flush_handler(signum, frame):
    try:
        flush_artifacts()
    except Exception:  # noqa: BLE001 — never block the signal chain
        logging.getLogger("cake_tpu_torch.obs").exception(
            "artifact flush failed")
    import os
    import signal as _signal

    prev = _flush_state["prev"].get(signum, _signal.SIG_DFL)
    if callable(prev):
        prev(signum, frame)
    elif prev != _signal.SIG_IGN:
        # re-deliver under the default disposition: the process still dies
        # of the signal (exit code 128+n), with its artifacts on disk
        _signal.signal(signum, _signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_flush_handlers(metrics_out: str | None = None) -> None:
    """Arm SIGTERM/SIGINT and atexit artifact flushing (the command line's
    entry; safe to call again, e.g. in-process, to re-point
    ``metrics_out``)."""
    import atexit
    import signal as _signal

    _flush_state["metrics_out"] = metrics_out
    if _flush_state["installed"]:
        return
    _flush_state["installed"] = True
    atexit.register(flush_artifacts)
    for signum in (_signal.SIGTERM, _signal.SIGINT):
        try:
            prev = _signal.getsignal(signum)
            _signal.signal(signum, _flush_handler)
            _flush_state["prev"][signum] = prev
        except ValueError:  # not the main thread: atexit still covers exit
            pass
