"""Typed configuration of the PyTorch port, field for field the JAX package's
``ModelConfig`` (``eigen_lstm_tpu/config.py``) so that one checkpoint and one
set of flags describe the same model in both packages.

``ModelConfig``, ``DataConfig`` and ``TrainConfig`` carry the JAX
package's fields with the same defaults and meanings. ``MeshConfig`` is
the JAX one with the model axis of ``--tp`` and the seq axis of ``--sp``
beside its data axis (``parallel/mesh.py:init_mesh``). Pipeline
parallelism is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture and numerics of the stacked char-LSTM LM. The field
    comments of the JAX ``ModelConfig`` apply unchanged."""

    vocab: int = 256
    hidden: int = 512
    num_layers: int = 1
    cell_variant: str = "reference"   # "reference" | "standard"
    loss_mode: str = "last"           # "last" | "all"
    loss_base: str = "e"              # "e" | "2"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"    # "bfloat16": bf16-rounded matmul inputs
    init_std: float = 0.01
    forget_bias: float = 1.0
    embedding_mode: str = "auto"      # "auto" | "gather" | "onehot"
    remat: bool = False
    residual_dtype: str = "float32"   # storage type of the h/c/g sequences
    scan_chunk: int = 0
    tie_embeddings: bool = False
    dropout: float = 0.0
    seed: int = 0

    def __post_init__(self):
        checks = (
            ("cell_variant", self.cell_variant in ("reference", "standard")),
            ("loss_mode", self.loss_mode in ("last", "all")),
            ("loss_base", self.loss_base in ("e", "2")),
            ("embedding_mode",
             self.embedding_mode in ("auto", "gather", "onehot")),
            ("dropout", 0.0 <= self.dropout < 1.0),
            ("param_dtype", self.param_dtype in _DTYPES),
            ("compute_dtype", self.compute_dtype in _DTYPES),
            ("residual_dtype", self.residual_dtype in _DTYPES),
        )
        for name, ok in checks:
            if not ok:
                raise ValueError(f"bad {name}: {getattr(self, name)!r}")

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def rdtype(self) -> torch.dtype:
        """Storage type of the kernels' h/c/g sequences; float64 throughout
        in the float64 oracle configuration."""
        if self.compute_dtype == "float64":
            return torch.float64
        return _DTYPES[self.residual_dtype]

    @property
    def adtype(self) -> torch.dtype:
        """Accumulation and elementwise type: float32 everywhere except the
        float64 oracle configuration."""
        return torch.float64 if self.param_dtype == "float64" else torch.float32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Corpus and batching: B stream cursors over the corpus, windows of S
    bytes advanced by ``stride`` (None: S, segment mode with the state
    carried), EOF wrap with the stream's state reset to N(0, reset_std)."""

    path: str = "data/alice29.txt"
    train_percent: float = 0.95
    batch: int = 128
    seq: int = 100
    stride: Optional[int] = None
    carry_state: bool = True
    reset_std: float = 0.0

    @property
    def effective_stride(self) -> int:
        return self.seq if self.stride is None else self.stride


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization and schedule: Adagrad, optional global-norm clipping,
    lr = 0 for ``warmup_steps`` (while the accumulators still fill), an
    optional cyclic decay after it, the non-finite skip, and the host
    cadence of logs, evals, samples and checkpoints."""

    lr: float = 0.1
    adagrad_eps: float = 1e-10
    clip_norm: Optional[float] = None
    warmup_steps: int = 0
    lr_cycle_steps: int = 0
    lr_cycle_min_frac: float = 0.1
    skip_nonfinite: bool = True
    steps: int = 10_000
    log_every: int = 100
    eval_every_s: float = 60.0
    eval_chars: int = 100_000
    sample_chars: int = 1000
    checkpoint_dir: Optional[str] = None
    superstep: int = 50
    pp_chunks: int = 4   # --pp: the window's sequence chunks; --sp: the batch's
    crosscheck_every: Optional[int] = None   # in supersteps
    gradcheck_every: Optional[int] = None    # in supersteps
    gradcheck_samples: int = 20
    keep_snapshots: bool = False
    seed: int = 1234


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The process mesh of ``parallel/mesh.py:init_mesh``: ``num_devices``
    data rows (the JAX ``MeshConfig``'s field; None: no data axis), by
    ``seq_devices`` seq columns (``--sp``; None: no seq axis), by
    ``stage_devices`` stage columns (``--pp``; None: no stage axis) or by
    ``model_devices`` model columns (``--tp``; None: no model axis). A seq
    axis with a model axis has no data axis (``--sp N --tp M``: N seq rows
    by M model columns); a stage axis goes alone or beside a data axis.
    The axes are "data", "seq", "stage" and "model", as in the JAX meshes;
    the JAX ``data_axis`` name has no counterpart."""

    num_devices: Optional[int] = 1
    model_devices: Optional[int] = None
    seq_devices: Optional[int] = None
    stage_devices: Optional[int] = None
