"""Linear products (port of ``cake_tpu/ops/quant.py:489-506``).

Only plain weights ``[in, out]`` are ported in this slice; ``x @ w`` is a
plain ``torch.matmul``, as the JAX package leaves it to XLA. Quantized
linears (int8 and packed int4, with their two kernels) arrive with the next
slice of the port.
"""

from __future__ import annotations

import torch


def _plain(w) -> torch.Tensor:
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"quantized linear weights ({type(w).__name__}) are not ported "
            "yet: int8/int4 linears and their kernels come with the next "
            "slice of the PyTorch port")
    return w


def out_features(w) -> int:
    """Output width of a linear weight ``[in, out]``."""
    return _plain(w).shape[-1]


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``: the one dispatch point every linear in the model routes
    through."""
    return x @ _plain(w)
