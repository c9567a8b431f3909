"""cake-tpu on PyTorch and CUDA: the port of :mod:`cake_tpu` to one NVIDIA
Hopper card (H100).

The package mirrors the JAX package's module layout so each module's
counterpart is easy to find (``cake_tpu_torch/ops/rope.py`` ports
``cake_tpu/ops/rope.py``). Plain tensor code is eager PyTorch; every Pallas
kernel of the JAX package on the ported path is a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use. The package imports
neither ``jax`` nor anything of ``cake_tpu``.

Importing it is cheap: no kernel is built and no device is touched until an
entry point runs.
"""

__version__ = "0.1.0"
