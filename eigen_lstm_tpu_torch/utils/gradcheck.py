"""Finite-difference gradient checking, the port's
``eigen_lstm_tpu/utils/gradcheck.py``: the reference's oracle.

Central differences at +-1e-5, two loss evaluations per sampled entry;
up to ``samples_per_tensor`` entries a tensor, drawn with
``np.random.default_rng(seed).choice`` tensor by tensor in checkpoint
order, so that one seed samples the same entries as the JAX function;
relative error |a - n| / (|a| + |n|), passing at max <= 1e-1 and mean
<= 1e-3. Run it in float64: below that the differences are roundoff.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..models.lstm import LSTMParams, like, tensors


class GradCheckResult(NamedTuple):
    max_rel_err: float
    mean_rel_err: float
    n_checked: int

    @property
    def passed(self) -> bool:
        return self.max_rel_err <= 1e-1 and self.mean_rel_err <= 1e-3


def check_gradients(
    loss_of_params: Callable[[LSTMParams], torch.Tensor],
    params: LSTMParams,
    analytic_grads: LSTMParams,
    samples_per_tensor: int = 100,
    delta: float = 1e-5,
    seed: int = 0,
    floor: float = 0.0,
    rel_floor: float = 0.0,
) -> Dict[str, GradCheckResult]:
    """``analytic_grads`` against central differences of
    ``loss_of_params``, a result per tensor keyed as the JAX function keys
    it (``.layers[0].W`` ... ``.by``). An entry with |a| + |n| at or below
    ``max(floor, rel_floor * max|analytic of its tensor|)`` counts as zero
    error: deep stacks and trained models hold entries whose central
    differences are truncation noise."""
    rng = np.random.default_rng(seed)
    names = [name[len("params"):] for name, _ in params.named_tensors()]
    base = tensors(params)
    results: Dict[str, GradCheckResult] = {}
    for i, (name, leaf, g) in enumerate(zip(names, base,
                                            tensors(analytic_grads))):
        leaf_np = leaf.detach().cpu().double().numpy()
        g_np = g.detach().cpu().double().numpy()
        size = leaf_np.size
        if size <= samples_per_tensor:
            idxs = np.arange(size)
        else:
            idxs = rng.choice(size, size=samples_per_tensor, replace=False)
        leaf_floor = max(floor, rel_floor * float(np.abs(g_np).max()))

        def loss_at(idx, v):
            perturbed = leaf_np.copy()
            perturbed.flat[idx] = v
            leaves = list(base)
            leaves[i] = torch.from_numpy(perturbed).to(leaf.dtype).to(leaf.device)
            with torch.no_grad():
                return float(loss_of_params(like(params, leaves)))

        rel_errs = []
        for idx in idxs:
            orig = leaf_np.flat[idx]
            numeric = (loss_at(idx, orig + delta)
                       - loss_at(idx, orig - delta)) / (2.0 * delta)
            analytic = g_np.flat[idx]
            denom = abs(analytic) + abs(numeric)
            rel_errs.append(0.0 if denom <= leaf_floor
                            else abs(analytic - numeric) / denom)
        rel_errs = np.asarray(rel_errs)
        results[name] = GradCheckResult(float(rel_errs.max()),
                                        float(rel_errs.mean()), len(idxs))
    return results
