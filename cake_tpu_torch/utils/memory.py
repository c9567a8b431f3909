"""Process and card memory reporting (port of ``memory_report`` in
``cake_tpu/utils/memory.py``)."""

from __future__ import annotations

import resource


def rss_bytes() -> int:
    """Peak resident set size of this process (linux: ru_maxrss is KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} PiB"


def memory_report() -> str:
    """The host's peak RSS and, once the card is in use, the bytes the
    caching allocator holds there: allocated to tensors, and reserved."""
    import torch

    parts = [f"rss {human_bytes(rss_bytes())}"]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        parts.append(
            f"card allocated {human_bytes(torch.cuda.memory_allocated())}, "
            f"reserved {human_bytes(torch.cuda.memory_reserved())}")
    return ", ".join(parts)
