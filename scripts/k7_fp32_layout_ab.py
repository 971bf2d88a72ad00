"""K7's fp32 persistent design in its two weight layouts, on the card: the
products reading every phase's rows packed tile by tile (``Wt``, what
``ops/cuda_sampler.generate`` passes: a block streams one contiguous span)
against the same products reading W's and Why's rows in place (a null
``Wt``: a block streams 32 bytes of each gate row, the rows 16 KB apart).

    python3 scripts/k7_fp32_layout_ab.py [OUT.json]

The flagship's weights (``artifacts/flagship_drop/ckpt_best.npz``, 3 x
1024, fp32 compute), a state and first tokens made from a seed, 1000
tokens at T = 0.7, B = 1 (gemv) and B = 128 (the FFMA product), each
layout launched through ``gen_persist_f32_launch`` with the plan's layout;
the two layouts must give the same ids and state bit for bit (one sum
order); then the median of 3 CUDA-event windows of one call each, in the
order packed, in place, in place, packed. Prints one JSON line with the
card's name and power limit (and writes it to OUT.json when given). Needs a
CUDA card and ``nvcc``; run from the root of the repository.
"""
import json
import statistics
import subprocess
import sys

import torch

FLAGSHIP = "artifacts/flagship_drop/ckpt_best.npz"
TOKENS = 1000


class _InPlace:
    """Stands for the packed rows in ``cuda_sampler._launch``: its null
    pointer makes the launcher read the rows in place."""

    def data_ptr(self):
        return None


def _ms(fn, windows=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(out=None):
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.ops import cuda_sampler as cs
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cfg = ModelConfig(hidden=1024, num_layers=3, compute_dtype="float32")
    params = load_params(FLAGSHIP, cfg, "cuda")
    packed_rows = cs.tile_weights
    layouts = {"packed": packed_rows, "in_place": lambda *a: _InPlace()}
    res = {"card": smi, "tokens": TOKENS}
    for b in (1, 128):
        gen = torch.Generator().manual_seed(b)
        h0 = (torch.randn(3, b, 1024, generator=gen) * 0.3).cuda()
        c0 = (torch.randn(3, b, 1024, generator=gen) * 0.3).cuda()
        first = torch.randint(0, 256, (b,), generator=gen).cuda()
        lay = cs.device_gen_plan(cfg, b)
        outs, times = {}, {k: [] for k in layouts}

        def call(name):
            cs.tile_weights = layouts[name]
            try:
                return cs.generate(params, cfg, -123456789, first, h0, c0,
                                   TOKENS, 0.7)
            finally:
                cs.tile_weights = packed_rows

        for name in layouts:
            before = cs.generate.persistent_launches
            outs[name] = call(name)
            if cs.generate.persistent_launches != before + 1:
                raise SystemExit(f"B = {b}, {name}: not one persistent launch")
        same = all(torch.equal(x, y) for x, y in zip(
            (outs["packed"][0], *outs["packed"][1]),
            (outs["in_place"][0], *outs["in_place"][1])))
        for name in ("packed", "in_place", "in_place", "packed"):
            times[name].append(_ms(lambda: call(name)))
        res[f"B{b}"] = {"design": lay.design, "same_bits": same,
                        **{f"{k}_ms": v for k, v in times.items()}}
        if not same:
            print(json.dumps(res), flush=True)
            raise SystemExit(f"B = {b}: the two layouts give other bits")
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    sys.path.insert(0, ".")
    main(*sys.argv[1:2])
