"""Command line of the PyTorch port: ``eval`` and ``sample`` of a checkpoint,
with the JAX CLI's model and data flags (``eigen_lstm_tpu/cli.py``).

Usage:
  python -m eigen_lstm_tpu_torch.cli eval   --ckpt ckpt.npz --data PATH [--device cuda]
  python -m eigen_lstm_tpu_torch.cli sample --ckpt ckpt.npz --data PATH [--length 1000]

``eval`` prints ``{"test_bpc": ...}`` as the JAX CLI does. ``train`` and
``bench`` are not ported yet and exit with a message saying so.
"""

from __future__ import annotations

import argparse
import json
import sys

NOT_PORTED = ("train", "bench")


def _add_args(p: argparse.ArgumentParser):
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--cell", choices=["reference", "standard"], default="reference")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="matmul compute dtype (params stay fp32)")
    p.add_argument("--residual-dtype", choices=["auto", "float32", "bfloat16"],
                   default="auto",
                   help="storage dtype of the h/c/g sequences. auto: bfloat16 "
                        "under --dtype bfloat16 when hidden >= 2048, as the "
                        "JAX CLI resolves it at its default window")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", required=True, help="byte corpus path")
    p.add_argument("--train-percent", type=float, default=0.95)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="eigen_lstm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_eval = sub.add_parser("eval", help="bits/char on the held-out split")
    _add_args(p_eval)
    p_eval.add_argument("--eval-chars", type=int, default=100000)
    p_eval.set_defaults(fn=cmd_eval)
    p_sample = sub.add_parser("sample", help="generate text from a checkpoint")
    _add_args(p_sample)
    p_sample.add_argument("--length", type=int, default=1000)
    p_sample.add_argument("--temperature", type=float, default=1.0)
    p_sample.set_defaults(fn=cmd_sample)
    for name in NOT_PORTED:
        sub.add_parser(name, help="not ported yet", add_help=False)
    return ap


def _configs(args):
    from .config import DataConfig, ModelConfig

    residual = args.residual_dtype
    if residual == "auto":
        residual = (
            "bfloat16" if args.dtype == "bfloat16" and args.hidden >= 2048
            else "float32"
        )
    mcfg = ModelConfig(
        vocab=args.vocab, hidden=args.hidden, num_layers=args.layers,
        cell_variant=args.cell, compute_dtype=args.dtype,
        residual_dtype=residual, seed=args.seed,
    )
    return mcfg, DataConfig(path=args.data, train_percent=args.train_percent)


def _load(args):
    from .train.checkpoint import load_params

    mcfg, dcfg = _configs(args)
    return mcfg, dcfg, load_params(args.ckpt, mcfg, args.device)


def cmd_eval(args):
    from .data.corpus import rawread, split
    from .ops.dispatch import select_cell_fn
    from .train.evaluator import evaluate_bpc

    mcfg, dcfg, params = _load(args)
    _, test = split(rawread(dcfg.path), dcfg.train_percent)
    eval_batch = 16
    cell_fn = select_cell_fn("auto", mcfg, eval_batch, args.device)
    bpc = evaluate_bpc(params, test, mcfg, eval_batch=eval_batch,
                       max_chars=args.eval_chars, cell_fn=cell_fn)
    print(json.dumps({"test_bpc": bpc}), flush=True)


def cmd_sample(args):
    import torch

    from .models.sampler import sample_text

    mcfg, _, params = _load(args)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    print(sample_text(params, mcfg, gen, args.length,
                      temperature=args.temperature), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        raise SystemExit(
            f"eigen_lstm_tpu_torch: '{argv[0]}' is not ported yet; "
            f"use python -m eigen_lstm_tpu.cli {argv[0]}"
        )
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
