"""K10's fp32 persistent design in a checkout of the port, on the card:
the bits of its outputs and its time, for an A/B of two checkouts; and
the bits of the fp32 persistent designs that share its code, K9's forward
(``lstm_tiled_f32.cuh``'s window) and K6's reverse launch at groups of 4
blocks (``lstm_bwd_f32.cuh`` at N = 512).

    python3 scripts/k10_fp32_ab.py ROOT OUT.json
        runs ROOT's ``eigen_lstm_tpu_torch.ops.cuda_cell_tiled.tiled_bwd``
        under fp32 compute at the flagship's training shapes (S 256, N
        1024) on inputs made from a seed, in 8 cases (B 128 and 32, fp32
        and bf16 residuals, dropout 0 and 0.35), and writes the sha256 of
        each case's dg, dc0 and dh0 and its launches; in the same cases the
        sha256 of K9's outputs (``tiled_scan_layer`` with its residuals, N
        1024) and of K6's (``cuda_cell_bwd.scan_layer_bwd``, S 100, N 512);
        at B 128, fp32 residuals and no dropout also the median of 10 whole
        calls and of 10 launches of K10's C launcher alone (CUDA events);
    python3 scripts/k10_fp32_ab.py --compare A.json B.json
        prints which cases give the same bits and the times side by side;
        exits 1 if any case differs.

Run each checkout in a process of its own and both in one call to the card
(A B B A), so that the times compare. Needs a CUDA card and ``nvcc``.
"""
import hashlib
import json
import os
import statistics
import sys


def compare(path_a, path_b):
    a, b = (json.load(open(p)) for p in (path_a, path_b))
    diff = [k for k in a["bits"] if a["bits"][k] != b["bits"].get(k)]
    print(f"{len(a['bits']) - len(diff)} cases give the same bits, "
          f"{len(diff)} differ: {diff}")
    for key in ("whole_ms", "launcher_ms"):
        print(f"{key}: {a[key]:.4f} ({a['launcher']}) against {b[key]:.4f} "
              f"({b['launcher']})")
    return 1 if diff else 0


def run(root, out):
    sys.path.insert(0, root)
    import torch

    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.models.lstm import LayerParams
    from eigen_lstm_tpu_torch.ops import _build, cuda_cell_bwd
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

    if not ct.__file__.startswith(root):
        raise SystemExit(f"imported {ct.__file__}, not ROOT's")
    # the launcher K10's fp32 design calls: its own in checkouts from
    # before it took K6's kernel, K6's since
    name = ("tiled_bwd_f32_launch" if "tiled_bwd_f32_launch" in _build.SIGNATURES
            else "lstm_bwd_f32_launch")
    s, n = 256, 1024
    res = {"launcher": name, "bits": {}}
    for b in (128, 32):
        for residual in ("float32", "bfloat16"):
            for drop in (None, (0.35, -1234567)):
                cfg = ModelConfig(hidden=n, compute_dtype="float32",
                                  residual_dtype=residual, loss_mode="all")
                gen = torch.Generator().manual_seed(26)
                r = lambda *sh: torch.randn(*sh, generator=gen)
                U = (r(n, 4 * n) * 0.3 / (n / 16) ** 0.5).cuda()
                pre = r(s, b, 4 * n)
                g = torch.cat([torch.sigmoid(pre[..., :3 * n]),
                               torch.tanh(pre[..., 3 * n:])], -1).cuda()
                c, c0 = (r(s, b, n) * 0.5).cuda(), (r(b, n) * 0.5).cuda()
                dh = (r(s, b, n) * 1e-3).cuda()
                dhT, dcT = (r(b, n) * 1e-3).cuda(), (r(b, n) * 1e-3).cuda()
                dh0 = torch.empty(b, n, device="cuda")
                call = lambda: ct.tiled_bwd(U, g, c, c0, dh, dhT, dcT, cfg,
                                            dropout=drop, dh0_out=dh0)
                before = ct.tiled_bwd.launches
                dg, dc = call()
                torch.cuda.synchronize()
                key = f"B {b}, {residual} residuals, dropout {drop is not None}"
                # bf16 residuals hashed through their exact fp32 values
                sha = lambda xs: [hashlib.sha256(
                    (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
                    .tobytes()).hexdigest() for x in xs]
                res["bits"][key] = sha((dg, dc, dh0)) + [ct.tiled_bwd.launches - before]
                layer = LayerParams(torch.zeros(1, 4 * n, device="cuda"), U,
                                    torch.zeros(4 * n, device="cuda"))
                xw = (r(s, b, 4 * n) * 0.5).cuda()
                k9 = ct.tiled_scan_layer(layer, xw, c0, c0, cfg, residuals=True,
                                         dropout=drop)
                res["bits"]["K9 " + key] = sha([k9[0], *k9[1], *k9[2:]])
                m = 512
                cfg6 = ModelConfig(hidden=m, compute_dtype="float32",
                                   residual_dtype=residual, loss_mode="all")
                seqs = [x[:100, :, :m].contiguous() for x in (g, c, c, dh)]
                seqs[0] = g[:100, :, :4 * m].contiguous()
                k6 = cuda_cell_bwd.scan_layer_bwd(
                    U[:m, :4 * m].contiguous(), seqs[0], seqs[1], seqs[2],
                    c0[:, :m].contiguous(), c0[:, :m].contiguous(), seqs[3],
                    dhT[:, :m].contiguous(), dcT[:, :m].contiguous(), cfg6,
                    dropout=drop)
                torch.cuda.synchronize()
                res["bits"]["K6 " + key] = sha(k6)
                if (b, residual, drop) == (128, "float32", None):
                    res.update(times(torch, call, _build.load_library(), name))
    json.dump(res, open(out, "w"), indent=1)
    print(f"{root}: {len(res['bits'])} cases; whole call {res['whole_ms']:.4f} "
          f"ms, {name} alone {res['launcher_ms']:.4f} ms")


def times(torch, call, lib, name, reps=10):
    """Medians of ``reps`` whole calls and of ``reps`` launches of the C
    launcher ``name`` alone within calls, CUDA events, after 3 warm-ups."""
    event = lambda: torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    whole = []
    for _ in range(reps):
        e0, e1 = event(), event()
        e0.record()
        call()
        e1.record()
        torch.cuda.synchronize()
        whole.append(e0.elapsed_time(e1))
    real, pairs = getattr(lib, name), []

    def timed(*args):
        e0, e1 = event(), event()
        e0.record()
        err = real(*args)
        e1.record()
        pairs.append((e0, e1))
        return err

    setattr(lib, name, timed)
    try:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    finally:
        setattr(lib, name, real)
    return {"whole_ms": statistics.median(whole),
            "launcher_ms": statistics.median(a.elapsed_time(b) for a, b in pairs)}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare"] and len(sys.argv) == 4:
        sys.exit(compare(*sys.argv[2:]))
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    run(os.path.abspath(sys.argv[1]), sys.argv[2])
