"""Public per-card hardware specs (port of ``cake_tpu/utils/chips.py``;
one copy: ``chip_smoke.py`` and the tools read their roofline
denominators from here, so a correction can never leave one caller's
bound stale).

Source: NVIDIA's H100 SXM data sheet (HBM3 at 3.35 TB/s, a dense bf16
tensor-core rate of 989 TFLOP/s). The rows are keyed on a substring of
``torch.cuda.get_device_name()`` ("NVIDIA H100 80GB HBM3"). They feed
DENOMINATORS (a weights-bound step time = bytes / rate; a share of the
bound) and are never presented as measurements. The card's memory size is
read from the card itself (:func:`hbm_bytes`).
"""

from __future__ import annotations

import torch

# device-name substring -> HBM GB/s
HBM_GBPS = {"h100": 3350.0}
# device-name substring -> dense bf16 peak TFLOP/s
PEAK_TFLOPS = {"h100": 989.0}

# the H100's, in the units the kernel bounds use
PEAK_BYTES_PER_S = HBM_GBPS["h100"] * 1e9
PEAK_BF16_FLOPS = PEAK_TFLOPS["h100"] * 1e12


def device_name(device=None) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (``"cpu"`` for a CPU
    device, or when no card is there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def device_spec(device, table: dict, default: float) -> float:
    """Look up a spec by substring match on the device's name."""
    name = device_name(device).lower()
    for k, v in table.items():
        if k in name:
            return v
    return default


def hbm_gbps(device=None) -> float:
    return device_spec(device, HBM_GBPS, HBM_GBPS["h100"])


def hbm_bytes(device=None) -> int:
    """The card's memory in bytes, as the card reports it."""
    return torch.cuda.get_device_properties(
        torch.device("cuda" if device is None else device)).total_memory
