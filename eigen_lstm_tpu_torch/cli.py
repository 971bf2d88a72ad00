"""Command line of the PyTorch port, with the JAX CLI's commands and flags
(``eigen_lstm_tpu/cli.py``) for what the port runs.

Usage:
  python -m eigen_lstm_tpu_torch.cli train  --data PATH [--hidden 512 --batch 128 ...]
  python -m eigen_lstm_tpu_torch.cli bench  --data PATH [--hidden 512 ...]
  python -m eigen_lstm_tpu_torch.cli eval   --ckpt ckpt.npz --data PATH
  python -m eigen_lstm_tpu_torch.cli sample --ckpt ckpt.npz --data PATH [--length 1000]

Every command runs on the card (``--device cuda``) unless ``--device cpu``
asks for the CPU. ``eval`` prints ``{"test_bpc": ...}`` and ``bench`` one
JSON line, as the JAX CLI does. ``train --profile DIR`` traces five
supersteps after a warm-up one with ``torch.profiler`` and writes the trace
and a table of device time by kernel into DIR. ``train --crosscheck K``
holds the kernels' loss and gradient norm against the model's own loop
every K supersteps, ``--gradcheck`` runs the finite-difference check once
before training and ``--gradcheck-every K`` every K supersteps.
``train --tp N`` trains tensor-parallel over N devices, ``train --dp N``
data-parallel, ``train --sp N`` sequence-pipelined (the window in N time
segments, the batch in ``--pp-chunks`` microchunks), ``train --pp N``
pipeline-parallel (the layers in N stages, the window's sequence in
``--pp-chunks`` chunks), and two of them together (``--dp N --tp M``,
``--dp N --sp M``, ``--sp N --tp M``, ``--dp N --pp M``) on an N x M mesh,
one process a device (``torchrun --nproc_per_node N*M`` for more than one;
on one card, or on the CPU, one process needs no launcher). A mesh trains
on the resident corpus unless ``--stream-data`` asks for streaming, as the
JAX CLI does; one device streams unless ``--resident-data`` is given.
``--gradcheck`` and ``--gradcheck-every`` run under a mesh on the
canonical state; ``--crosscheck`` runs on one device only. ``bench`` over
several devices and ``bench --profile`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--cell", choices=["reference", "standard"], default="reference")
    p.add_argument("--loss-mode", choices=["last", "all"], default="all")
    p.add_argument("--loss-base", choices=["e", "2"], default="e")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="matmul compute dtype (params stay fp32)")
    p.add_argument("--residual-dtype", choices=["auto", "float32", "bfloat16"],
                   default="auto",
                   help="storage dtype of the h/c/g sequences. auto: bfloat16 "
                        "under --dtype bfloat16 when hidden >= 2048 or "
                        "seq >= 512, as the JAX CLI resolves it")
    p.add_argument("--forget-bias", type=float, default=1.0)
    p.add_argument("--scan-chunk", type=int, default=0,
                   help="rematerialise the recurrence in chunks of this many "
                        "steps in the backward (must divide --seq; 0 = off): "
                        "only one chunk's residuals are held at a time")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout rate of each layer's output stream, between "
                        "the layers and before the head (training only), "
                        "fused into the recurrence kernels")
    p.add_argument("--tie-embeddings", action="store_true",
                   help="share the head's Why^T as the input embedding "
                        "(layer 0 gets an (N, 4N) projection)")
    p.add_argument("--embedding", choices=["auto", "gather", "onehot"],
                   default="auto")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=["auto", "cuda", "plain"],
                   default="auto",
                   help="auto: the kernels on the card, their plain "
                        "versions on the CPU")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def _add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--data", required=True, help="byte corpus path")
    p.add_argument("--train-percent", type=float, default=0.95)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seq", type=int, default=100)
    p.add_argument("--stride", type=int, default=None,
                   help="cursor stride (default: seq, segment mode)")
    p.add_argument("--no-carry", action="store_true",
                   help="reset h/c each window instead of carrying")
    p.add_argument("--reset-std", type=float, default=0.0)
    p.add_argument("--stream-data", dest="stream_data", action="store_true",
                   default=None,
                   help="keep the corpus on the host and feed windows per "
                        "superstep (the default on one device; a mesh "
                        "defaults to the resident corpus)")
    p.add_argument("--resident-data", dest="stream_data", action="store_false",
                   help="copy the corpus to the device and gather windows there")


def _add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--lr", type=float, default=None,
                   help="default: 0.1 below hidden 512, 0.02 for one layer "
                        "below 1024, else 0.005 (the JAX CLI's ladder)")
    p.add_argument("--adagrad-eps", type=float, default=1e-10)
    p.add_argument("--clip-norm", type=float, default=None)
    p.add_argument("--warmup", type=int, default=None,
                   help="lr = 0 steps while Adagrad's m accumulates; default "
                        "min(50*seq, steps//10)")
    p.add_argument("--lr-cycle-steps", type=int, default=0)
    p.add_argument("--lr-cycle-min-frac", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--epochs", type=float, default=None)
    p.add_argument("--superstep", type=int, default=50)
    p.add_argument("--log-every", type=int, default=500)
    p.add_argument("--eval-every-s", type=float, default=60.0)
    p.add_argument("--eval-chars", type=int, default=100000)
    p.add_argument("--sample-chars", type=int, default=1000)
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--results", type=str, default=None,
                   help="JSONL results-table path")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint (of either package) to resume; a "
                        "saved cursor outside --data's corpus is replaced "
                        "by a fresh one, with a reset stream state, and "
                        "the run says so")
    p.add_argument("--keep-snapshots", action="store_true")
    p.add_argument("--gradcheck", action="store_true",
                   help="train: a finite-difference gradient check before "
                        "training")
    p.add_argument("--gradcheck-every", type=int, default=None, metavar="K",
                   help="every K supersteps, the finite-difference check of "
                        "the live training point (float64 shadow on the CPU "
                        "unless the model is float64)")
    p.add_argument("--crosscheck", type=int, default=None, metavar="K",
                   help="every K supersteps, the kernels' loss and gradient "
                        "norm against the model's own loop at the live "
                        "training point")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="train: trace five supersteps with torch.profiler "
                        "into DIR (bench: not ported yet)")
    p.add_argument("--tp", type=int, default=None, metavar="N",
                   help="train: tensor-parallel over N devices (gate-sharded "
                        "weights; --hidden must divide by N), one process a "
                        "device: torchrun --nproc_per_node N for N > 1")
    p.add_argument("--dp", type=int, default=None, metavar="N",
                   help="train: data-parallel over N devices (the batch "
                        "split into N shards; with --tp M an N x M mesh), "
                        "one process a device: torchrun --nproc_per_node "
                        "N*M for more than one")
    p.add_argument("--sp", type=int, default=None, metavar="N",
                   help="sequence-pipeline the BPTT window over N devices "
                        "(time segments, batch microchunks of --pp-chunks; "
                        "parallel/sp.py)")
    p.add_argument("--pp", type=int, default=None, metavar="N",
                   help="train: pipeline-parallel over N devices (layer "
                        "blocks over stages, --layers must divide by N; "
                        "the window's sequence in --pp-chunks chunks; with "
                        "--dp M an M x N mesh), one process a device: "
                        "torchrun --nproc_per_node N for N > 1")
    p.add_argument("--pp-chunks", type=int, default=4,
                   help="pipeline chunks: under --pp the window's sequence "
                        "(must divide --seq), under --sp the batch (must "
                        "divide it)")


def _configs(args):
    """(ModelConfig, DataConfig, TrainConfig) from the flags, with the JAX
    CLI's resolution of the residual type, lr, warm-up and seed. Every
    subcommand takes the model, data and train flags, as in the JAX CLI."""
    from .config import DataConfig, ModelConfig, TrainConfig

    residual = args.residual_dtype
    if residual == "auto":
        residual = ("bfloat16" if args.dtype == "bfloat16"
                    and (args.hidden >= 2048 or args.seq >= 512) else "float32")
    mcfg = ModelConfig(
        vocab=args.vocab, hidden=args.hidden, num_layers=args.layers,
        cell_variant=args.cell, loss_mode=args.loss_mode,
        loss_base=args.loss_base, compute_dtype=args.dtype,
        residual_dtype=residual, forget_bias=args.forget_bias,
        embedding_mode=args.embedding, dropout=args.dropout,
        tie_embeddings=args.tie_embeddings, seed=args.seed,
        scan_chunk=args.scan_chunk,
    )
    dcfg = DataConfig(
        path=args.data, train_percent=args.train_percent, batch=args.batch,
        seq=args.seq, stride=args.stride, carry_state=not args.no_carry,
        reset_std=args.reset_std,
    )
    lr = args.lr
    if lr is None:
        lr = (0.1 if args.hidden < 512
              else 0.02 if args.hidden < 1024 and args.layers == 1 else 0.005)
    warmup = args.warmup
    if warmup is None:
        warmup = (50 * args.seq if args.epochs
                  else min(50 * args.seq, args.steps // 10))
    tcfg = TrainConfig(
        lr=lr, adagrad_eps=args.adagrad_eps, clip_norm=args.clip_norm,
        warmup_steps=warmup, lr_cycle_steps=args.lr_cycle_steps,
        lr_cycle_min_frac=args.lr_cycle_min_frac, steps=args.steps,
        superstep=args.superstep, log_every=args.log_every,
        eval_every_s=args.eval_every_s, eval_chars=args.eval_chars,
        sample_chars=args.sample_chars, checkpoint_dir=args.ckpt_dir,
        keep_snapshots=args.keep_snapshots, crosscheck_every=args.crosscheck,
        gradcheck_every=args.gradcheck_every, pp_chunks=args.pp_chunks,
        seed=args.seed + 1,
    )
    return mcfg, dcfg, tcfg


def _load(args):
    from .train.checkpoint import load_params

    mcfg, dcfg, _ = _configs(args)
    return mcfg, dcfg, load_params(args.ckpt, mcfg, args.device)


def _parallel_flags(args):
    """The JAX CLI's rules for combining the parallel flags, with its
    messages (``eigen_lstm_tpu/cli.py:263-266``), then refuses
    ``--crosscheck`` under a mesh."""
    if args.pp and (args.tp or args.sp):
        raise SystemExit("--pp combines only with --dp")
    if sum(map(bool, (args.dp, args.tp, args.sp, args.pp))) > 2:
        raise SystemExit("at most two parallel axes may be combined")
    if (args.dp or args.tp or args.sp or args.pp) and args.crosscheck:
        raise SystemExit("--crosscheck with --dp, --tp, --sp or --pp: it runs "
                         "on one device only (the JAX trainer skips it under "
                         "a mesh)")


def _make_trainer(args):
    import numpy as np

    from .config import MeshConfig
    from .data import corpus as corpus_mod
    from .data import streaming as streaming_mod
    from .ops.dispatch import select_cell_fn
    from .parallel.mesh import init_mesh, init_tp_group
    from .train.trainer import Trainer

    _parallel_flags(args)
    mcfg, dcfg, tcfg = _configs(args)
    mesh, device = None, args.device
    if args.dp or args.sp or args.pp:
        mesh = init_mesh(MeshConfig(num_devices=args.dp, model_devices=args.tp,
                                    seq_devices=args.sp, stage_devices=args.pp),
                         args.device)
        axes = [f"{n} {name}" for n, name in ((args.dp, "data"),
                                               (args.sp, "seq"),
                                               (args.pp, "stage"),
                                               (args.tp, "model")) if n]
        print(f"2-D mesh: {' x '.join(axes)} devices" if len(axes) == 2
              else f"data-parallel over {args.dp} devices" if args.dp
              else f"sequence-pipelined over {args.sp} time segments"
              if args.sp else f"pipeline-parallel over {args.pp} stages",
              flush=True)
    elif args.tp:
        mesh = init_tp_group(args.tp, args.device)
        print(f"tensor-parallel over {args.tp} devices", flush=True)
    if mesh is not None:
        device = mesh.device
    print("data: " + ("streamed from the host" if args.stream_data
                      else "resident on the device"), flush=True)
    try:
        if args.stream_data:
            train, test = corpus_mod.split(
                streaming_mod.load_corpus_mmap(dcfg.path), dcfg.train_percent)
            test = np.asarray(test)
        else:
            train, test = corpus_mod.load_dataset(dcfg)
        cell_fn = select_cell_fn(args.backend, mcfg, dcfg.batch, device)
        trainer = Trainer(mcfg, dcfg, tcfg, train, test, cell_fn=cell_fn,
                          results_path=args.results,
                          streaming=args.stream_data, device=device, mesh=mesh)
        if args.resume:
            trainer.restore(args.resume)
            print(f"resumed from {args.resume} at step {trainer.step}",
                  flush=True)
    except BaseException:
        if mesh is not None:
            mesh.close(failed=True)
        raise
    return trainer


def profile_supersteps(trainer, out_dir: str, supersteps: int = 5) -> str:
    """One warm-up superstep, then ``supersteps`` under ``torch.profiler``
    (the card's kernels too when the trainer is on it). Writes
    ``trace.json`` and ``kernels.txt`` (time by kernel) into ``out_dir``
    and returns the table."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = trainer.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    trainer.run(steps=trainer.tcfg.superstep, quiet=True)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        trainer.run(steps=supersteps * trainer.tcfg.superstep, quiet=True)
        sync()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    key = "self_device_time_total" if on_card else "self_cpu_time_total"
    table = prof.key_averages().table(sort_by=key, row_limit=30)
    with open(os.path.join(out_dir, "kernels.txt"), "w") as f:
        f.write(table)
    return table


def cmd_train(args):
    trainer = _make_trainer(args)
    try:
        _train(args, trainer)
    except BaseException:
        # no collective on the way out: a peer may be inside a kernel or
        # a collective that this rank will never join
        if trainer.mesh is not None:
            trainer.mesh.close(failed=True)
        raise
    if trainer.mesh is not None:
        trainer.mesh.close()


def _train(args, trainer):
    if args.gradcheck:
        trainer.gradcheck(samples_per_tensor=50)
    if args.profile:
        print(profile_supersteps(trainer, args.profile), flush=True)
        print(f"profile trace written to {args.profile}", flush=True)
    steps = args.steps
    if args.epochs:
        chars_per_step = trainer.dcfg.batch * trainer.dcfg.effective_stride
        steps = max(1, int(args.epochs * len(trainer.train_np) / chars_per_step))
        print(f"--epochs {args.epochs} -> {steps} steps", flush=True)
    trainer.run(steps)
    if trainer.test_np is not None and len(trainer.test_np) > 1:
        print(f"final test bpc: {trainer.evaluate():.4f}", flush=True)
    if args.ckpt_dir:
        trainer.save(f"{args.ckpt_dir}/ckpt.npz")
        print(f"saved {args.ckpt_dir}/ckpt.npz", flush=True)
    if args.sample_chars:
        print("--- sample ---", flush=True)
        print(trainer.sample(args.sample_chars), flush=True)


def cmd_bench(args):
    from .bench import run_benchmark

    if args.profile:
        raise SystemExit("eigen_lstm_tpu_torch: bench --profile is not "
                         "ported yet; use train --profile")
    if args.tp or args.dp or args.sp or args.pp:
        raise SystemExit("eigen_lstm_tpu_torch: bench over several devices "
                         "is not ported yet; use train --dp or --tp")
    print(json.dumps(run_benchmark(args)), flush=True)


def cmd_eval(args):
    from .data.corpus import rawread, split
    from .ops.dispatch import select_cell_fn
    from .train.evaluator import evaluate_bpc

    mcfg, dcfg, params = _load(args)
    _, test = split(rawread(dcfg.path), dcfg.train_percent)
    eval_batch = 16
    cell_fn = select_cell_fn(args.backend, mcfg, eval_batch, args.device)
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


class _Parser(argparse.ArgumentParser):
    """Resolves ``--stream-data``'s default once the flags are read: the
    resident corpus under a mesh, streaming on one device
    (``eigen_lstm_tpu/cli.py:240-246``)."""

    def parse_known_args(self, args=None, namespace=None):
        ns, rest = super().parse_known_args(args, namespace)
        if getattr(ns, "stream_data", False) is None:
            ns.stream_data = not (ns.dp or ns.tp or ns.sp or ns.pp)
        return ns, rest


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's subcommands, each with the model, data and train flags
    (a flag that only training reads is accepted and ignored by ``eval``
    and ``sample``, as in the JAX package)."""
    ap = _Parser(prog="eigen_lstm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="train a char-LSTM LM")
    p_bench = sub.add_parser("bench", help="training throughput benchmark")
    p_eval = sub.add_parser("eval", help="bits/char on the held-out split")
    p_sample = sub.add_parser("sample", help="generate text from a checkpoint")
    for p in (p_train, p_bench, p_eval, p_sample):
        _add_model_args(p)
        _add_data_args(p)
        _add_train_args(p)
    p_train.set_defaults(fn=cmd_train)
    p_bench.add_argument("--bench-steps", type=int, default=200)
    p_bench.add_argument("--warmup-steps", type=int, default=20)
    p_bench.set_defaults(fn=cmd_bench)
    p_eval.add_argument("--ckpt", required=True)
    p_eval.set_defaults(fn=cmd_eval)
    p_sample.add_argument("--ckpt", required=True)
    p_sample.add_argument("--length", type=int, default=1000)
    p_sample.add_argument("--temperature", type=float, default=1.0)
    p_sample.set_defaults(fn=cmd_sample)
    return ap


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    args.fn(args)


if __name__ == "__main__":
    main()
