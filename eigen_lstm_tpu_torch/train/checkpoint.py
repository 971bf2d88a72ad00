"""npz checkpoints in the JAX package's format, read and written
(``eigen_lstm_tpu/train/checkpoint.py``): one uncompressed ``.npz`` with
the parameters under ``params.layers[i].W``, ``.U``, ``.b``, ``params.Why``
and ``params.by``, the Adagrad accumulators under the same names with the
prefix ``opt``, the stream state ``data/positions``, ``data/stream_h`` and
``data/stream_c``, the raw PRNG key ``data/rng_key`` and ``meta/json``
(the step and model shape). A checkpoint of either package loads in the
other.

The JAX key has no counterpart in torch: the port reads it and does not use
it, and writes the raw ``jax.random.PRNGKey(seed)`` of its trainer's seed so
that a JAX restore finds a key. The port's own random streams are
``torch.Generator``s, which a checkpoint does not hold.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.lstm import LayerParams, LSTMParams


def _expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    n, m = cfg.hidden, cfg.vocab
    shapes = {}
    for i in range(cfg.num_layers):
        in_dim = n if (i == 0 and cfg.tie_embeddings) else (m if i == 0 else n)
        shapes[f"params.layers[{i}].W"] = (in_dim, 4 * n)
        shapes[f"params.layers[{i}].U"] = (n, 4 * n)
        shapes[f"params.layers[{i}].b"] = (4 * n,)
    shapes["params.Why"] = (n, m)
    shapes["params.by"] = (m,)
    return shapes


def params_from_numpy(
    arrays: Dict[str, np.ndarray], cfg: ModelConfig, device="cuda"
) -> LSTMParams:
    """Parameters from ``{npz key: array}``, checked against ``cfg``'s
    shapes and cast to its param type on ``device``. This is how the JAX
    package's weights cross into the port."""
    tensors = {}
    for key, shape in _expected_shapes(cfg).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing tensor {key}")
        arr = np.asarray(arrays[key])
        if arr.shape != shape:
            raise ValueError(
                f"checkpoint shape mismatch for {key}: {arr.shape} vs {shape}"
            )
        tensors[key] = torch.tensor(arr, dtype=cfg.pdtype, device=device)
    layers = tuple(
        LayerParams(*(tensors[f"params.layers[{i}].{name}"]
                      for name in ("W", "U", "b")))
        for i in range(cfg.num_layers)
    )
    return LSTMParams(layers, tensors["params.Why"], tensors["params.by"])


def load_params(path: str, cfg: ModelConfig, device="cuda") -> LSTMParams:
    """Parameters of the npz checkpoint at ``path``; the other entries are
    not read."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in _expected_shapes(cfg) if k in z.files}
    return params_from_numpy(arrays, cfg, device)


def _tensors(params: LSTMParams, prefix: str) -> Dict[str, np.ndarray]:
    return {prefix + key[len("params"):]: t.detach().cpu().numpy()
            for key, t in params.named_tensors()}


def save_checkpoint(
    path: str,
    params: LSTMParams,
    opt_state: LSTMParams,
    step: int,
    positions=None,
    stream_h=None,
    stream_c=None,
    rng_key: Optional[np.ndarray] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Atomic save (a temporary file, then a rename) of the full training
    state, uncompressed."""
    payload: Dict[str, np.ndarray] = {}
    payload.update(_tensors(params, "params"))
    payload.update(_tensors(opt_state, "opt"))
    for name, x in (("positions", positions), ("stream_h", stream_h),
                    ("stream_c", stream_c)):
        if x is not None:
            payload[f"data/{name}"] = (x.detach().cpu().numpy()
                                       if torch.is_tensor(x) else np.asarray(x))
    if rng_key is not None:
        payload["data/rng_key"] = np.asarray(rng_key, np.uint32)
    payload["meta/json"] = np.frombuffer(
        json.dumps({"step": int(step), **(meta or {})}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, cfg: ModelConfig, device="cuda"
                    ) -> Tuple[LSTMParams, LSTMParams, int, Dict[str, Any]]:
    """(params, opt_state, step, extras) of a checkpoint, on ``device``.
    ``extras`` holds ``meta`` and, where present, ``positions`` (int32),
    ``stream_h``, ``stream_c`` (tensors on ``device``) and ``rng_key`` (the
    raw JAX key, unused)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    params = params_from_numpy(arrays, cfg, device)
    opt = params_from_numpy(
        {"params" + k[len("opt"):]: v for k, v in arrays.items()
         if k.startswith("opt")}, cfg, device)
    meta = json.loads(bytes(arrays["meta/json"]).decode())
    extras: Dict[str, Any] = {"meta": meta}
    if "data/positions" in arrays:
        extras["positions"] = torch.from_numpy(
            arrays["data/positions"].astype(np.int32)).to(device)
    for name in ("stream_h", "stream_c"):
        if f"data/{name}" in arrays:
            extras[name] = torch.tensor(arrays[f"data/{name}"],
                                        dtype=cfg.pdtype, device=device)
    if "data/rng_key" in arrays:
        extras["rng_key"] = arrays["data/rng_key"]
    return params, opt, int(meta["step"]), extras
