"""Device choice for the port's entry points.

Every entry point runs on the CUDA card unless its caller asks for the CPU.
Without a card and without that request it raises: nothing slides onto the
CPU on its own.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); ``"cpu"`` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--cpu on the "
            "command line) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA card ``device`` (``cuda``
    without an index: the current card)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None
                     else index)


class HostCopy:
    """A device tensor's copy to the host, queued on the current stream
    when made and waited for on its own event. ``tensor.cpu()`` (or
    ``tolist()``) waits for everything queued on the stream, so a block
    dispatched after the copy would hold it up; this one waits only for
    the work queued before it. A CPU tensor is copied at once (it may be a
    decode graph's static output, which the next dispatch overwrites)."""

    def __init__(self, tensor: torch.Tensor):
        self._event = None
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor.clone()

    def numpy(self):
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
