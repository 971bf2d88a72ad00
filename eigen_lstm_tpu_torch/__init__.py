"""PyTorch and CUDA port of ``eigen_lstm_tpu`` for an NVIDIA H100.

Serving (held-out bits/char and sampling), single-card training, and
tensor-, data- and sequence-parallel training and their two-axis meshes
(``parallel/``) run here; every kernel of those paths is CUDA C++ under
``csrc/``. The JAX package beside this one is the reference the tests
hold the port against.
"""

from .config import ModelConfig

__all__ = ["ModelConfig"]
