"""Embeddable worker API (port of ``cake_tpu/embed.py``).

One call turns the calling process into a worker serving its
topology-assigned layers, as the reference's iOS worker export does:

- Python: :func:`start_worker` (blocking) or :func:`spawn_worker` (a
  background thread; returns a handle with ``.shutdown()``).
- C: ``cake_start_worker(name, model_path, topology_path, address)`` and
  ``cake_start_worker_opts(..., options_json)`` of
  ``cake_tpu_torch/native/cake_embed.cc``, a shim that embeds (or joins)
  the Python interpreter and calls :func:`start_worker`. It is built at
  first use by ``ops/kernels/build.py build_shim`` (``g++`` with Python's
  include and link flags) into ``cake_tpu_torch/_build/``.

The worker runs on the CUDA card unless ``device="cpu"`` is passed. A
bundle written by ``tools/split_model.py`` holds only its worker's
layers; a pre-quantized one loads at the tier its tensors carry when no
``quantize`` is given. The default address is the reference's
``0.0.0.0:10128``.
"""

from __future__ import annotations

import json
import logging
import signal
import threading

log = logging.getLogger("cake_tpu_torch.embed")

DEFAULT_ADDRESS = "0.0.0.0:10128"


def _build_worker(name: str, model_path: str, topology_path: str,
                  address: str = DEFAULT_ADDRESS, quantize: str | None = None,
                  max_seq: int | None = None, kv_quant: str | None = None,
                  device=None):
    from pathlib import Path

    from cake_tpu_torch.models.config import LlamaConfig
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.runtime.worker import Worker
    from cake_tpu_torch.utils.device import resolve_device
    from cake_tpu_torch.utils.weights import (
        is_prequantized,
        load_llama_params,
        load_safetensors_index,
    )

    dev = resolve_device(device)
    config = LlamaConfig.from_hf_json(Path(model_path) / "config.json")
    topology = Topology.from_path(topology_path)
    if quantize is None:
        quantize = is_prequantized(load_safetensors_index(model_path))

    def loader(lo, hi):
        return load_llama_params(
            model_path, config.num_hidden_layers, dtype=config.dtype,
            device=dev, quantize=quantize, layer_range=(lo, hi),
            layers_only=True)["layers"]

    return Worker(name, config, topology, loader, address=address,
                  max_seq=max_seq, kv_quant=kv_quant, device=dev)


class WorkerHandle:
    """A running background worker; ``port`` is the bound port (useful when
    the address asked for port 0) and ``shutdown()`` stops serving."""

    def __init__(self, worker, thread: threading.Thread):
        self._worker = worker
        self._thread = thread
        self.port: int = worker.port

    def shutdown(self, timeout: float = 5.0) -> None:
        self._worker.shutdown()
        self._thread.join(timeout=timeout)


def serve_until_signal(worker) -> int:
    """Serve ``worker`` until SIGTERM or SIGINT (when called on the main
    thread; elsewhere until the accept loop ends), then shut it down;
    returns 0, or 1 if the accept loop died on its own."""
    if threading.current_thread() is not threading.main_thread():
        worker.serve_forever()
        return 0
    stop = threading.Event()

    def on_signal(signum, frame):
        log.info("signal %d: worker %s stopping", signum, worker.name)
        stop.set()

    prev = {s: signal.signal(s, on_signal)
            for s in (signal.SIGTERM, signal.SIGINT)}
    thread = worker.serve_in_background()
    try:
        # the accept loop runs in its own thread: a blocked accept would
        # otherwise keep the handler from running
        while not stop.wait(0.5):
            if not thread.is_alive():
                log.error("worker %s: the accept loop ended", worker.name)
                return 1
        return 0
    finally:
        worker.shutdown()
        for s, h in prev.items():
            if h is not None:  # None: a handler set outside Python
                signal.signal(s, h)


def start_worker(name: str, model_path: str, topology_path: str,
                 address: str = DEFAULT_ADDRESS,
                 quantize: str | None = None, max_seq: int | None = None,
                 kv_quant: str | None = None, device=None) -> int:
    """Run a worker in the calling thread until SIGTERM or SIGINT (the
    reference export's blocking contract); returns 0 after a clean
    stop."""
    worker = _build_worker(name, model_path, topology_path, address,
                           quantize, max_seq, kv_quant, device)
    log.info("embedded worker '%s' serving on port %d", name, worker.port)
    return serve_until_signal(worker)


def start_worker_opts(name: str, model_path: str, topology_path: str,
                      address: str, options: str) -> int:
    """:func:`start_worker` with its keyword options as a JSON object (the
    C shim's ``cake_start_worker_opts``), e.g. ``{"kv_quant": "int8",
    "max_seq": 128}``."""
    return start_worker(name, model_path, topology_path,
                        address or DEFAULT_ADDRESS,
                        **json.loads(options or "{}"))


def spawn_worker(name: str, model_path: str, topology_path: str,
                 address: str = DEFAULT_ADDRESS,
                 quantize: str | None = None, max_seq: int | None = None,
                 kv_quant: str | None = None, device=None) -> WorkerHandle:
    """Start a worker on a background thread and return a handle."""
    worker = _build_worker(name, model_path, topology_path, address,
                           quantize, max_seq, kv_quant, device)
    thread = worker.serve_in_background()
    return WorkerHandle(worker, thread)
