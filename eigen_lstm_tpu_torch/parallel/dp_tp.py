"""Training on a data x model ``ProcessMesh`` (``--dp N --tp M``): data
parallelism composed with gate-sharded tensor parallelism, the port's
``eigen_lstm_tpu/parallel/dp_tp.py``.

The streams and cursors are split over the data axis, as in
``parallel/dp.py``; the weights, their accumulators and the hidden state
over the model axis, as in ``parallel/tp.py``. Rank (d, m) holds h and c
as (L, B/N, H/M). Each step runs ``tp_loss_and_grads`` on the row's
streams over its model group, then averages the loss, the bits and the
gradients over its data group: the objective is the global mean loss, so
the gradients are the globally averaged ones (``dp_tp.py:89-96``), and the
non-finite skip reads that global loss. Adagrad's global norm sums over
the model axis with by counted once.

The dropout key folds in the data rank only, so the M model shards of a
row draw one mask over the full hidden stream (``dp_tp.py:79-87``); the
reset noise folds in both ranks (the trainer seeds its generator). The TP
family is chosen on the per-data-shard batch with ``allow_per_step=False``
(``ops/dispatch.py:select_tp_backend``), as the JAX trainer chooses it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DataConfig, ModelConfig, TrainConfig
from ..models import lstm as model
from ..train import trainer as trainer_mod
from . import dp as dp_mod
from . import mesh as mesh_mod
from . import tp as tp_mod


def dp_tp_train_step(state, x, t, mcfg: ModelConfig, dcfg: DataConfig,
                     tcfg: TrainConfig, length: int,
                     generator: Optional[torch.Generator],
                     data: mesh_mod.AxisGroup, tp: tp_mod.TPPlan):
    """One step of rank (``data.rank``, ``tp.rank``) on its row's windows
    (x, t), each (S, B/N), and its shards (the TP family runs the
    recurrence). Returns (state, (mean bits, grad norm))."""
    dkey = (dp_mod.data_key(model.step_key(tcfg.seed, state.step), data.rank)
            if mcfg.dropout > 0.0 else None)
    loss, (h2, c2), bits, grads = tp_mod.tp_loss_and_grads(
        state.params, x, t, state.h, state.c, mcfg, tp.group, tp.backend,
        dkey, tp.plain)
    *leaves, loss, bits = dp_mod.pmean(model.tensors(grads) + [loss, bits],
                                       data)
    grads = model.like(grads, leaves)
    if tcfg.skip_nonfinite:
        grads, h2, c2 = trainer_mod.skip_nonfinite(loss, grads, h2, c2, state)
    return trainer_mod.finish_step(state, h2, c2, grads, bits, dcfg, tcfg,
                                   length, generator, **tp.norm_kw(mcfg))
