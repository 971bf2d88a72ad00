"""PyTorch and CUDA port of ``eigen_lstm_tpu`` for an NVIDIA H100.

The serving path (held-out bits/char and sampling) runs here; its two
recurrence kernels are CUDA C++ under ``csrc/``. The JAX package beside
this one is the reference the tests hold the port against.
"""

from .config import ModelConfig

__all__ = ["ModelConfig"]
