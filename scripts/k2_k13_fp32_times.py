"""K2 and K13 under fp32 compute on the card, in whichever design the
tree's plans choose, and the flagship's fp32 ``--tp 1`` window, which runs
K13 768 times: run it in two trees in one call (a parent unpacked with
``git archive`` and this one, in the order parent, change, change, parent)
to compare their designs on one card.

    python3 scripts/k2_k13_fp32_times.py [OUT.json]

From the root of the repository: the package is the one on PYTHONPATH
(``PYTHONPATH=chip_tree/parent`` for a parent's ``eigen_lstm_tpu_torch``
unpacked there), else the repository's own; the weights come from the
committed checkpoints, the rest from seeds:

* K2 (``cuda_cell.scan_layer``) at 6e's layer shapes (S 100, B 128, N 512,
  the 1x512 checkpoint's U, residuals as training takes them) and at the
  eval shapes (S 128, B 16, N 1024, the flagship's layer-1 U, no
  residuals): ms a call (median of 5 CUDA-event windows of 5 calls), its
  launches a call, the bound (``chip_smoke.py:bound``'s formula) and one
  cuDNN ``nn.LSTM`` call over the same window (TF32 off);
* K13 (``cuda_tp_cell.tp_step_fwd``) at the flagship's shard of D = 1, 2,
  4 (B 128, N 1024; the flagship's layer-1 weights permuted for D): ms a
  call of the wrapper (U cast already, 50 calls a window) and its
  launches;
* the flagship's fp32 TP window (``tp_loss_and_grads``, the per-step
  family, 3 layers x 256 steps, dropout 0.35 on one card at ``--tp 1``):
  the median of 3 synchronised calls on the host clock, and K13's launches
  in one.

Prints one JSON line with the card's name and power limit (and writes it
to OUT.json when given). Needs a CUDA card and ``nvcc``.
"""
import json
import statistics
import subprocess
import sys
import time

import torch

FLAGSHIP = "artifacts/flagship_drop/ckpt_best.npz"
H512 = "artifacts/bible_h512/ckpt.npz"
CORPUS = "data/cantrbry/bible.txt"
HBM_BYTES_PER_S, FP32_OPS = 3.35e12, 67e12


def _ms(fn, reps, windows=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _bound(s, b, n, train):
    """K2's least time in fp32, ms: U + the xw stream + h0, c0 + h_seq, hT,
    cT (and c_seq, g_seq in training) once, or 2 S B N 4N flops."""
    nbytes = 4 * (n * 4 * n + s * b * 4 * n + 4 * b * n + s * b * n
                  + (5 * s * b * n if train else 0))
    ops = 2 * s * b * n * 4 * n
    return max(1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS)


def _cudnn_ms(n, x, h0, c0):
    lstm = torch.nn.LSTM(n, n).cuda()
    lstm.flatten_parameters()
    with torch.no_grad():
        return _ms(lambda: lstm(x, (h0[None], c0[None])), reps=5)


def k2_times(gen):
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.models.lstm import LayerParams
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    out = {}
    for label, path, layer_i, layers, s, b, train in (
            ("6e layer (S 100, B 128, N 512)", H512, 0, 1, 100, 128, True),
            ("eval (S 128, B 16, N 1024)", FLAGSHIP, 1, 3, 128, 16, False)):
        n = 512 if path == H512 else 1024
        cfg = ModelConfig(hidden=n, num_layers=max(layers, 2),
                          compute_dtype="float32", residual_dtype="float32")
        src = load_params(path, ModelConfig(hidden=n, num_layers=layers,
                                            compute_dtype="float32"), "cuda")
        U = src.layers[layer_i].U
        rand = lambda *shape, sd: (torch.randn(*shape, generator=gen) * sd).cuda()
        layer = LayerParams(rand(n, 4 * n, sd=0.05), U, rand(4 * n, sd=0.1))
        x = torch.tanh(rand(s, b, n, sd=1.0))
        xw = x @ layer.W + layer.b
        h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
        call = lambda: cuda_cell.scan_layer(layer, xw, h0, c0, cfg,
                                            residuals=train)
        before = cuda_cell.scan_layer.launches
        call()
        launches = cuda_cell.scan_layer.launches - before
        out[label] = dict(ms=_ms(call, reps=5), launches=launches,
                          bound_ms=_bound(s, b, n, train),
                          cudnn_ms=_cudnn_ms(n, x, h0, c0))
    return out


def k13_times(gen):
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tc
    from eigen_lstm_tpu_torch.parallel.tp import permute_params_for_tp
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    cfg = ModelConfig(hidden=1024, num_layers=3, compute_dtype="float32")
    flag = load_params(FLAGSHIP, cfg, "cuda")
    b, n = 128, 1024
    out = {}
    for d in (1, 2, 4):
        nd = n // d
        layer = permute_params_for_tp(flag, d).layers[1]
        U = layer.U[:, :4 * nd].contiguous()
        h = torch.tanh(torch.randn(b, n, generator=gen) * 0.5).cuda()
        xw = (torch.randn(b, 4 * nd, generator=gen) * 0.5).cuda() + layer.b[:4 * nd]
        c = (torch.randn(b, nd, generator=gen) * 0.3).cuda()
        before = tc.tp_step_fwd.launches
        tc.tp_step_fwd(U, xw, h, c, cfg)
        launches = tc.tp_step_fwd.launches - before
        out[f"D={d}"] = dict(ms=_ms(lambda: tc.tp_step_fwd(U, xw, h, c, cfg), reps=50),
                             launches=launches)
    return out


def tp_window(gen):
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.data.corpus import make_windows, rawread, split
    from eigen_lstm_tpu_torch.models.lstm import step_key
    from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tc
    from eigen_lstm_tpu_torch.parallel import mesh
    from eigen_lstm_tpu_torch.parallel import tp as tp_mod
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint

    s, b = 256, 128
    cfg = ModelConfig(hidden=1024, num_layers=3, compute_dtype="float32",
                      residual_dtype="float32", loss_mode="all", dropout=0.35)
    train = split(rawread(CORPUS), 0.95)[0]
    pos = torch.randint(0, len(train) - s - 1, (b,), generator=gen,
                        dtype=torch.int32).cuda()
    x, t = make_windows(torch.from_numpy(train).cuda(), pos, s)
    group = mesh.init_tp_group(1, "cuda")
    try:
        params, _, _, extras = load_checkpoint(FLAGSHIP, cfg, "cuda")
        shard = tp_mod.shard_params(params, cfg, group.rank, group.size)
        h, c = (extras[k][:, :b] for k in ("stream_h", "stream_c"))
        key = step_key(1235, 785000)
        call = lambda: tp_mod.tp_loss_and_grads(shard, x, t, h, c, cfg, group,
                                                "pallas", key)
        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            before = tc.tp_step_fwd.launches
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches = tc.tp_step_fwd.launches - before
        return dict(ms=statistics.median(times), k13_launches=launches)
    finally:
        group.close()


def main(out=None):
    sys.path.append(".")   # after PYTHONPATH: a parent's package comes first
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    from eigen_lstm_tpu_torch.ops import _build

    _build.load_library()
    gen = torch.Generator().manual_seed(29)
    res = dict(card=smi, package=_build.CSRC, k2=k2_times(gen), k13=k13_times(gen),
               tp_window_fp32=tp_window(gen))
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
