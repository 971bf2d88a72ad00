"""The training loop, as ``eigen_lstm_tpu/train/trainer.py`` runs it on one
device: K-step supersteps of (loss and gradients through ``loss_fn``, the
non-finite skip, the cursor advance with the wrap reset of (h, c), Adagrad),
with the host reading the metrics once per superstep at most, and a
wall-clock cadence of eval, checkpoint and sample.

PyTorch runs eagerly, so a superstep is a Python loop of K steps whose
kernels queue on the card; nothing in it waits for the device. The step
counter and the lr schedule live on the host (the schedule is a function
of the step alone); the cursors, the stream state and the metrics stay on
the device. In streamed mode (``data/streaming.py``) the next superstep's
windows are built and copied while the current one runs.

With ``ModelConfig.dropout > 0`` each step's dropout key is
``models.lstm.step_key(TrainConfig.seed, step)``: derived, not drawn from
the generator of the reset noise, so a resumed run draws the masks of a
straight one (the JAX trainer's ``fold_in(key, step)``).

The live checks of the JAX trainer run on the same cadence, in
supersteps: ``crosscheck`` holds the loss and gradient norm of the kernels
against the model's own loop at the current windows, ``gradcheck`` the
backward against finite differences in float64 (``utils/gradcheck.py``).

Tensor parallelism (``mesh`` a ``parallel.mesh.AxisGroup``, the JAX
``make_tp_superstep``, ``tp.py:301-448``):
each rank holds its shards of the permuted parameters and accumulators and
of the stream state (L, B, nd), reads the same windows as every other rank,
and updates its own shards; the global norm counts by once. Data
parallelism (``mesh`` a ``parallel.mesh.ProcessMesh`` without a model
axis, ``parallel/dp.py``) splits the streams over the data axis and
averages the gradients; with a model axis (``parallel/dp_tp.py``) each row
of the mesh runs tensor parallelism on its streams. Sequence pipelining
(a ``ProcessMesh`` with a seq axis, ``parallel/sp.py``) cuts each window
into time segments over the seq axis, alone, beside a data axis (each
data shard pipelines its streams) or beside a model axis (each segment
runs tensor parallelism). Pipeline parallelism (a ``ProcessMesh`` with a
stage axis, ``parallel/pp.py``) holds a block of layers on each stage and
pipelines the window's sequence chunks through them, alone or beside a
data axis (each data shard pipelines its streams; every stage of a shard
reads the shard's whole batch). The wrap reset's noise comes from a
generator seeded with the shard's data, model and stage ranks folded in,
as the JAX supersteps fold in ``axis_index``; the seq rank is not folded
in (the state is the same on every segment), so under ``--sp`` alone the
noise is the single device's stream. Checkpoints, eval, samples and
``gradcheck`` work on the canonical state (gathered, then unpermuted or
unstacked), so a mesh's checkpoint is an ordinary one; rank 0 writes it.
``crosscheck`` runs on one device only, as in the JAX trainer.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DataConfig, ModelConfig, TrainConfig
from ..data import corpus as corpus_mod
from ..data import streaming as streaming_mod
from ..models import lstm as model
from ..models import sampler as sampler_mod
from ..ops import cell as cell_ops
from ..parallel import mesh as mesh_mod
from ..parallel import tp as tp_mod
from . import checkpoint as ckpt_mod
from . import evaluator as eval_mod
from . import metrics as metrics_mod
from . import optimizer as opt_mod


@dataclasses.dataclass
class TrainState:
    """Parameters, Adagrad accumulators, the (L, B, N) stream state, the
    (B,) int32 cursors (on the device) and the global step (on the host)."""

    params: model.LSTMParams
    m: model.LSTMParams
    h: torch.Tensor
    c: torch.Tensor
    positions: torch.Tensor
    step: int


def loss_and_grads(params, x, t, h, c, mcfg: ModelConfig, cell_fn=None,
                   dropout_key=None):
    """``loss_fn`` and its gradient in every parameter: (loss, (hL, cL),
    mean bits, grads), all detached."""
    leaves = [p.detach().requires_grad_() for p in opt_mod.tensors(params)]
    with torch.enable_grad():
        loss, ((h2, c2), bits) = model.loss_fn(
            opt_mod.like(params, leaves), x, t, h, c, mcfg, cell_fn,
            dropout_key)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), (h2.detach(), c2.detach()), bits.detach(),
            opt_mod.like(params, grads))


def skip_nonfinite(loss, grads, h2, c2, state: TrainState):
    """A non-finite ``loss`` zeroes the gradients and keeps the pre-step
    stream state, so one bad step cannot poison the streams until they
    wrap: (grads, h2, c2)."""
    finite = torch.isfinite(loss)
    grads = opt_mod.like(grads, (torch.where(finite, g, torch.zeros_like(g))
                                 for g in opt_mod.tensors(grads)))
    h2 = torch.where(finite, h2, state.h.to(h2.dtype))
    c2 = torch.where(finite, c2, state.c.to(c2.dtype))
    return grads, h2, c2


def finish_step(state: TrainState, h2, c2, grads, bits, dcfg: DataConfig,
                tcfg: TrainConfig, length: int,
                generator: Optional[torch.Generator] = None, **norm_kw
                ) -> Tuple[TrainState, Tuple[torch.Tensor, torch.Tensor]]:
    """The step after the gradients: the cursor advance with the wrap reset
    of (h, c) (noise from ``generator`` when ``dcfg.reset_std > 0``), then
    clipping and Adagrad (``norm_kw``: the global norm's group and
    replicated mask under TP). Returns (state, (bits, grad norm))."""
    newpos, wrapped = corpus_mod.advance_positions(
        state.positions, dcfg.effective_stride, length, dcfg.seq)
    if dcfg.carry_state:
        mask = wrapped[None, :, None]
        if dcfg.reset_std > 0.0:
            rh = torch.randn(h2.shape, generator=generator, device=h2.device)
            rc = torch.randn(c2.shape, generator=generator, device=c2.device)
            rh, rc = (rh * dcfg.reset_std).to(h2.dtype), (rc * dcfg.reset_std).to(c2.dtype)
        else:
            rh, rc = torch.zeros_like(h2), torch.zeros_like(c2)
        h2 = torch.where(mask, rh, h2)
        c2 = torch.where(mask, rc, c2)
    else:
        h2, c2 = torch.zeros_like(state.h), torch.zeros_like(state.c)
    params, m, gnorm = opt_mod.apply_updates(state.params, grads, state.m,
                                             state.step, tcfg, **norm_kw)
    return TrainState(params, m, h2, c2, newpos, state.step + 1), (bits, gnorm)


def train_step(state: TrainState, x, t, mcfg: ModelConfig, dcfg: DataConfig,
               tcfg: TrainConfig, length: int, cell_fn=None,
               generator: Optional[torch.Generator] = None,
               tp: Optional[tp_mod.TPPlan] = None
               ) -> Tuple[TrainState, Tuple[torch.Tensor, torch.Tensor]]:
    """One step on the windows (x, t): returns (state, (bits, grad norm)).
    ``generator`` draws the reset noise when ``dcfg.reset_std > 0``.
    ``tp``: the step of one rank of tensor parallelism, on its shards
    (``cell_fn`` is then not read)."""
    dkey = (model.step_key(tcfg.seed, state.step) if mcfg.dropout > 0.0
            else None)
    if tp is None:
        loss, (h2, c2), bits, grads = loss_and_grads(
            state.params, x, t, state.h, state.c, mcfg, cell_fn, dkey)
        norm_kw = {}
    else:
        loss, (h2, c2), bits, grads = tp_mod.tp_loss_and_grads(
            state.params, x, t, state.h, state.c, mcfg, tp.group, tp.backend,
            dkey, tp.plain)
        norm_kw = tp.norm_kw(mcfg)
    if tcfg.skip_nonfinite:
        grads, h2, c2 = skip_nonfinite(loss, grads, h2, c2, state)
    return finish_step(state, h2, c2, grads, bits, dcfg, tcfg, length,
                       generator, **norm_kw)


def _metrics(bits, gnorms) -> Dict[str, torch.Tensor]:
    bits, gnorms = torch.stack(bits), torch.stack(gnorms)
    return {"bits": bits, "bits_mean": bits.mean(), "bits_last": bits[-1],
            "gnorm_mean": gnorms.mean(), "gnorm_max": gnorms.max()}


class Trainer:
    """The host-side loop: the superstep, the timed eval / sample /
    checkpoint cadence and the results table, on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(
        self,
        mcfg: ModelConfig,
        dcfg: DataConfig,
        tcfg: TrainConfig,
        train_data: np.ndarray,
        test_data: Optional[np.ndarray] = None,
        cell_fn=None,
        results_path: Optional[str] = None,
        mesh=None,
        streaming: bool = False,
        device="cuda",
    ):
        """``cell_fn``: ``ops.dispatch.select_cell_fn``'s kernels (or their
        plain versions), or None for the model's own loop. ``streaming``
        keeps the corpus on the host and feeds windows per superstep.
        ``mesh``: a ``parallel.mesh.AxisGroup``, the model axis of tensor
        parallelism, or a ``parallel.mesh.ProcessMesh``, data parallelism
        alone or with a model axis, sequence pipelining alone or with a
        data or a model axis, or pipeline parallelism alone or with a data
        axis (the module docstring); the TP family is the one
        ``ops.dispatch.select_tp_backend`` picks at (config, the batch of a
        data shard, the model axis's size, cell_fn, device), and beside a
        seq axis the torch-op scan, as the JAX ``tp_sp`` mesh takes its
        XLA scan. Pipeline parallelism trains through the torch-op scan as
        the JAX stage mesh trains through its XLA scan; ``cell_fn`` then
        serves the eval. Any other mesh is refused."""
        self.tp = self.dp = self.sp = self.pp = None
        model_axis = None
        if isinstance(mesh, mesh_mod.ProcessMesh):
            self.dp, model_axis = mesh.data, mesh.model
            self.sp, self.pp = mesh.seq, mesh.stage
            if self.pp is not None:
                from ..parallel import pp as pp_mod

                pp_mod.check_shapes(mcfg, dcfg, tcfg, self.pp.size,
                                    None if self.dp is None else self.dp.size)
            elif self.sp is not None:
                from ..parallel import sp as sp_mod

                sp_mod.check_shapes(
                    mcfg, dcfg, tcfg, self.sp.size,
                    None if self.dp is None else self.dp.size,
                    None if model_axis is None else model_axis.size)
            else:
                from ..parallel import dp as dp_mod

                dp_mod.local_batch(dcfg, self.dp,
                                   "devices" if model_axis is None else "")
        elif isinstance(mesh, mesh_mod.AxisGroup):
            model_axis = mesh
        elif mesh is not None:
            raise NotImplementedError(
                f"mesh training over a {type(mesh).__name__}: a mesh is a "
                f"parallel.mesh.AxisGroup or ProcessMesh")
        self.mesh = mesh
        if model_axis is not None:
            from ..ops.dispatch import select_tp_backend

            backend = "xla" if self.sp is not None else select_tp_backend(
                mcfg, dcfg.batch // self.n_data, model_axis.size, cell_fn,
                device, allow_per_step=self.dp is None)
            self.tp = tp_mod.TPPlan(model_axis, backend,
                                    bool(getattr(cell_fn, "plain", False)))
        self.mcfg, self.dcfg, self.tcfg = mcfg, dcfg, tcfg
        self.device = torch.device(device)
        self.train_np = train_data
        self.test_np = test_data
        self.cell_fn = cell_fn
        self.length = int(len(train_data))
        # reset noise and sampling draw from this device generator
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        # the reset noise of a shard: its data rank, then its model or
        # stage rank, folded into the seed
        seed = tcfg.seed
        folded = [a for a in (self.dp, self.tp and self.tp.group, self.pp)
                  if a is not None]
        for axis in folded:
            seed = cell_ops.hash32(cell_ops.hash32(seed)
                                   ^ cell_ops.hash32(axis.rank))
        self.noise = (torch.Generator(device=self.device).manual_seed(seed)
                      if folded else self.generator)
        self._best_bpc = None
        self._next_windows = None
        self.crosscheck_failures = 0
        self.gradcheck_failures = 0
        if streaming:
            self.corpus = None
            # a data shard is fed its own streams' windows
            self.feeder = streaming_mod.WindowFeeder(
                train_data, dataclasses.replace(
                    dcfg, batch=dcfg.batch // self.n_data),
                tcfg.superstep, device=self.device)
        else:
            self.corpus = torch.tensor(np.asarray(train_data),
                                       dtype=torch.uint8, device=self.device)
            self.feeder = None
        self.meter = metrics_mod.ThroughputMeter(mcfg, self.device.type)
        self.table = metrics_mod.ResultsTable(results_path)
        self.state = self._init_state()
        if self.feeder is not None:
            self.feeder.set_positions(self.state.positions.cpu().numpy())
        self.last_metrics: Dict[str, float] = {}

    def _init_state(self) -> TrainState:
        gen = torch.Generator().manual_seed(self.tcfg.seed)
        params = model.init_params(self.mcfg, gen, self.device)
        h, c = model.init_state(self.mcfg, self.dcfg.batch, self.device,
                                self.dcfg.reset_std, self.generator)
        positions = corpus_mod.init_positions(
            gen, self.dcfg.batch, self.length, self.dcfg.seq).to(self.device)
        return self._sharded(TrainState(params, opt_mod.adagrad_init(params),
                                        h, c, positions, 0))

    @property
    def n_data(self) -> int:
        """The data axis's size: 1 without data parallelism."""
        return 1 if self.dp is None else self.dp.size

    @property
    def rank(self) -> int:
        """This process's rank in the run (0 on one device)."""
        return 0 if self.mesh is None else self.mesh.rank

    def _sharded(self, state: TrainState) -> TrainState:
        """A canonical state as this trainer holds it: under TP this rank's
        shards of the permuted params and accumulators and of (h, c) along
        the hidden units; under PP the stage's layers of the stage-stacked
        params and accumulators and of (h, c); under DP its streams of
        (h, c) and the cursors."""
        if self.tp is not None:
            rank, size = self.tp.rank, self.tp.size
            shard = lambda p: tp_mod.shard_params(p, self.mcfg, rank, size)
            nd = self.mcfg.hidden // size
            cut = lambda x: x[..., rank * nd:(rank + 1) * nd].contiguous()
            state = TrainState(shard(state.params), shard(state.m),
                               cut(state.h), cut(state.c), state.positions,
                               state.step)
        if self.pp is not None:
            from ..parallel import pp as pp_mod

            state = pp_mod.shard_state(state, self.mcfg, self.pp)
        if self.dp is not None:
            from ..parallel import dp as dp_mod

            state = dp_mod.shard_state(state, self.dp)
        return state

    def canonical_state(self) -> TrainState:
        """The state of a single-device trainer: every shard gathered, the
        parameters unpermuted or unstacked (all ranks take part)."""
        st = self.state
        if self.dp is not None:
            from ..parallel import dp as dp_mod

            st = dp_mod.gather_state(st, self.dp)
        if self.pp is not None:
            from ..parallel import pp as pp_mod

            return pp_mod.gather_state(st, self.mcfg, self.pp)
        if self.tp is None:
            return st
        g = self.tp.group
        return TrainState(self._params(),
                          tp_mod.unshard_params(st.m, self.mcfg, g),
                          mesh_mod.all_gather(st.h, 2, g),
                          mesh_mod.all_gather(st.c, 2, g), st.positions,
                          st.step)

    @property
    def step(self) -> int:
        return self.state.step

    def chars_per_superstep(self) -> int:
        return self.dcfg.batch * self.dcfg.effective_stride * self.tcfg.superstep

    def superstep(self, state: TrainState, windows: Optional[torch.Tensor] = None):
        """K steps from ``state``: the windows gathered on the device from
        the resident corpus, or taken from ``windows`` (K, S+1, B).
        Returns (state, metrics), the metrics on the device."""
        from ..parallel import dp as dp_mod
        from ..parallel import dp_tp as dp_tp_mod
        from ..parallel import pp as pp_mod
        from ..parallel import sp as sp_mod

        steps = self.tcfg.superstep if windows is None else windows.shape[0]
        win = None if windows is None else windows.to(torch.int32)
        bits, gnorms = [], []
        for k in range(steps):
            if win is None:
                x, t = corpus_mod.make_windows(self.corpus, state.positions,
                                               self.dcfg.seq)
            else:
                x, t = win[k, :-1], win[k, 1:]
            args = (state, x, t, self.mcfg, self.dcfg, self.tcfg, self.length)
            if self.pp is not None:
                state, (b, g) = pp_mod.pp_train_step(*args, self.noise,
                                                     self.pp, self.dp)
            elif self.sp is not None:
                state, (b, g) = sp_mod.sp_train_step(
                    *args, self.cell_fn, self.noise, self.sp, self.dp, self.tp)
            elif self.dp is None:
                state, (b, g) = train_step(*args, self.cell_fn, self.noise,
                                           self.tp)
            elif self.tp is None:
                state, (b, g) = dp_mod.dp_train_step(*args, self.cell_fn,
                                                     self.noise, self.dp)
            else:
                state, (b, g) = dp_tp_mod.dp_tp_train_step(
                    *args, self.noise, self.dp, self.tp)
            bits.append(b)
            gnorms.append(g)
        return state, _metrics(bits, gnorms)

    def dispatch_superstep(self):
        """One superstep from the current state. Streamed, the next batch
        is built and copied right after this one is queued, so the host
        work overlaps the card's."""
        if self.feeder is None:
            return self.superstep(self.state)
        if self._next_windows is None:
            self._next_windows = self.feeder.next_device_batch()
        out = self.superstep(self.state, self._next_windows)
        self._next_windows = self.feeder.next_device_batch()
        return out

    def run(self, steps: Optional[int] = None,
            on_report: Optional[Callable[[Dict[str, float]], None]] = None,
            quiet: bool = False) -> Dict[str, float]:
        """Train ``steps`` steps (rounded up to supersteps). The metrics are
        read back at the log cadence, once per superstep at most."""
        total = steps if steps is not None else self.tcfg.steps
        n_super = max(1, -(-total // self.tcfg.superstep))
        timer = metrics_mod.Timer()
        eval_timer = metrics_mod.Timer()
        chars_done = 0
        gmax_window = None
        log_every = max(1, self.tcfg.log_every // self.tcfg.superstep)
        for k in range(n_super):
            self.state, metrics = self.dispatch_superstep()
            chars_done += self.chars_per_superstep()
            # running max since the last log line, kept on the device
            g = metrics["gnorm_max"]
            gmax_window = g if gmax_window is None else torch.maximum(gmax_window, g)
            if (k + 1) % log_every == 0 or k == n_super - 1:
                bits = float(metrics["bits_mean"])
                gmax = float(gmax_window)
                gmax_window = None
                cps, gflops, mfu = self.meter.rates(chars_done, timer.elapsed())
                self.last_metrics = {
                    "step": float(self.step), "train_bpc": bits,
                    "gnorm_max": gmax, "chars_per_sec": cps,
                    "gflops": gflops, "mfu": mfu,
                }
                if not quiet:
                    eta = timer.elapsed() / (k + 1) * (n_super - k - 1)
                    print(f"step {self.step:>8d}  bpc {bits:6.3f}  "
                          f"gmax {gmax:7.2f}  {cps:,.0f} chars/s  "
                          f"{gflops:,.0f} GF/s  mfu {mfu:5.1%}  eta {eta:,.0f}s",
                          flush=True)
                if on_report:
                    on_report(self.last_metrics)
            if (self.tcfg.crosscheck_every and self.cell_fn is not None
                    and self.mesh is None
                    and (k + 1) % self.tcfg.crosscheck_every == 0):
                self.crosscheck(quiet=quiet)
            if (self.tcfg.gradcheck_every
                    and (k + 1) % self.tcfg.gradcheck_every == 0):
                # mid-run, entries ~1e8x below a tensor's gradient scale
                # are truncation noise (utils/gradcheck.py's rel_floor)
                self.gradcheck(samples_per_tensor=self.tcfg.gradcheck_samples,
                               quiet=quiet, rel_floor=1e-4)
            if (self.test_np is not None and len(self.test_np) > 1
                    and eval_timer.elapsed() >= self.tcfg.eval_every_s):
                if "train_bpc" not in self.last_metrics:
                    self.last_metrics["train_bpc"] = float(metrics["bits_mean"])
                self.report_eval(timer.elapsed(), chars_done, quiet=quiet)
                eval_timer.start()
        return self.last_metrics

    def _current_windows(self, positions: Optional[torch.Tensor] = None):
        """(x, t), each (S, B) int32 on the device, at ``positions`` (the
        current cursors by default): the next step's windows."""
        pos = self.state.positions if positions is None else positions
        if self.corpus is not None:
            return corpus_mod.make_windows(self.corpus, pos, self.dcfg.seq)
        win = torch.from_numpy(self.feeder.build(
            pos.cpu().numpy())).to(self.device, torch.int32)
        return win[:-1], win[1:]

    def crosscheck(self, tol: Optional[float] = None, quiet: bool = False):
        """The loss and the gradients' global norm at the current windows
        and state, computed two ways on the trainer's device: through the
        trainer's ``cell_fn`` (the kernels) and through the model's own
        loop (``cell_fn=None``, ``models.lstm._scan_layer``, the
        counterpart of the JAX package's XLA scan, its oracle), without
        dropout (the JAX ``crosscheck``). Only this check runs the plain
        loop on the card. A relative difference above ``tol`` (2e-2 in
        bf16, 1e-3 otherwise) is counted in ``crosscheck_failures``, not
        raised. Returns both values and the differences. One device only:
        the JAX trainer skips it under a mesh (``trainer.py:593``)."""
        if self.mesh is not None:
            raise NotImplementedError(
                "crosscheck under a mesh: it runs on one device only, as the "
                "JAX trainer skips it under a mesh")
        if tol is None:
            tol = 2e-2 if self.mcfg.compute_dtype == "bfloat16" else 1e-3
        x, t = self._current_windows()
        st = self.state
        vals = []
        for cell_fn in (self.cell_fn, None):
            loss, _, _, grads = loss_and_grads(st.params, x, t, st.h, st.c,
                                               self.mcfg, cell_fn)
            vals.append((float(loss), float(opt_mod.global_norm(grads))))
        (l_k, g_k), (l_p, g_p) = vals
        dl = abs(l_k - l_p) / max(abs(l_p), 1e-12)
        dg = abs(g_k - g_p) / max(abs(g_p), 1e-12)
        ok = dl <= tol and dg <= tol
        if not ok:
            self.crosscheck_failures += 1
        if not quiet:
            print(f"[crosscheck] step {self.step} loss kernels {l_k:.6f} "
                  f"plain {l_p:.6f} (Δ{dl:.2e})  gnorm kernels {g_k:.4f} "
                  f"plain {g_p:.4f} (Δ{dg:.2e})  "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
        return {"loss_kernels": l_k, "loss_plain": l_p, "rel_loss": dl,
                "gnorm_kernels": g_k, "gnorm_plain": g_p, "rel_gnorm": dg,
                "ok": ok}

    def gradcheck(self, samples_per_tensor: int = 100, quiet: bool = False,
                  check_seq: int = 16, check_batch: int = 8,
                  rel_floor: float = 0.0) -> bool:
        """Central differences against the backward at the current point,
        on the first ``check_seq`` steps and ``check_batch`` streams of the
        current windows (the JAX ``gradcheck``), at the canonical state
        under any mesh (every rank takes part in the gathers and computes
        the same check). A float64 config on one device or under DP checks
        the live backward, its ``cell_fn``'s. Every other case (another
        config, or TP or PP, which train through another function, the JAX
        trainer's rule) checks a float64 shadow without dropout, on the
        host CPU, through the
        model's own loop: the live kernels are held to that path by
        ``crosscheck``. A failing tensor is counted in
        ``gradcheck_failures`` and printed; under a mesh a failure on any
        rank counts on every rank. Returns whether all passed."""
        from ..utils import gradcheck as gc

        st = self.state if self.mesh is None else self.canonical_state()
        x, t = self._current_windows(st.positions)
        s = min(check_seq, int(x.shape[0]))
        b = min(check_batch, int(x.shape[1]))
        x, t = x[:s, :b], t[:s, :b]
        h, c = st.h[:, :b], st.c[:, :b]
        params, cfg, cell_fn = st.params, self.mcfg, self.cell_fn
        if (cfg.param_dtype != "float64" or self.tp is not None
                or self.pp is not None):
            cfg = dataclasses.replace(
                cfg, param_dtype="float64", compute_dtype="float64",
                residual_dtype="float64", dropout=0.0)
            cpu64 = lambda a: a.detach().to("cpu", torch.float64)
            params = opt_mod.like(params, map(cpu64, opt_mod.tensors(params)))
            h, c, x, t, cell_fn = cpu64(h), cpu64(c), x.cpu(), t.cpu(), None

        def scalar_loss(p):
            return model.loss_fn(p, x, t, h, c, cfg, cell_fn)[0]

        grads = loss_and_grads(params, x, t, h, c, cfg, cell_fn)[3]
        results = gc.check_gradients(scalar_loss, params, grads,
                                     samples_per_tensor=samples_per_tensor,
                                     rel_floor=rel_floor)
        ok = all(r.passed for r in results.values())
        if self.mesh is not None:
            ok = mesh_mod.all_true(ok, self.device)
        if not ok:
            self.gradcheck_failures += 1
        for name, r in results.items():
            if not quiet or not r.passed:
                print(f"[gradcheck] step {self.step} {name:30s} "
                      f"max {r.max_rel_err:.2e} mean {r.mean_rel_err:.2e} "
                      f"({r.n_checked} samples) "
                      f"{'ok' if r.passed else 'FAIL'}", flush=True)
        return ok

    def _best_test_bpc(self) -> float:
        """Best held-out bpc of ``ckpt_best.npz``, seeded from the file's
        metadata so that a resumed run keeps a better earlier snapshot."""
        if self._best_bpc is None:
            self._best_bpc = float("inf")
            path = (os.path.join(self.tcfg.checkpoint_dir, "ckpt_best.npz")
                    if self.tcfg.checkpoint_dir else None)
            if path and os.path.exists(path):
                with np.load(path) as z:
                    meta = json.loads(bytes(z["meta/json"]).decode())
                self._best_bpc = float(meta.get("test_bpc", "inf"))
        return self._best_bpc

    def report_eval(self, wall_s: float, chars_done: int, quiet: bool = False):
        """Held-out eval, a results row, and with a checkpoint directory the
        rolling checkpoint, the best one, snapshots and a sample."""
        test_bpc = self.evaluate()
        cps, gflops, mfu = self.meter.rates(chars_done, wall_s)
        row = metrics_mod.ResultRow(
            idx=len(self.table.rows), step=self.step,
            chars_trained=chars_done, wall_s=wall_s,
            train_bpc=self.last_metrics.get("train_bpc", float("nan")),
            test_bpc=test_bpc, gflops=gflops, chars_per_sec=cps, mfu=mfu,
        )
        self.table.append(row)
        if not quiet:
            print(f"[eval] step {self.step} test bpc {test_bpc:.3f} "
                  f"(train {row.train_bpc:.3f})", flush=True)
        d = self.tcfg.checkpoint_dir
        if d:
            self.save(os.path.join(d, "ckpt.npz"))
            if self.tcfg.keep_snapshots:
                self.save(os.path.join(d, f"ckpt_step{self.step}.npz"),
                          extra_meta={"test_bpc": float(test_bpc)})
            if test_bpc < self._best_test_bpc():
                self._best_bpc = test_bpc
                self.save(os.path.join(d, "ckpt_best.npz"),
                          extra_meta={"test_bpc": float(test_bpc)})
            if self.tcfg.sample_chars:
                with open(os.path.join(d, f"sample_step{self.step}.txt"), "w") as f:
                    f.write(self.sample(self.tcfg.sample_chars))
        return row

    def _params(self) -> model.LSTMParams:
        """The canonical parameters (gathered under TP and PP, all ranks
        taking part)."""
        if self.pp is not None:
            from ..parallel import pp as pp_mod

            return pp_mod.pp_params_to(
                pp_mod.gather_params(self.state.params, self.pp), self.mcfg)
        return (self.state.params if self.tp is None else
                tp_mod.unshard_params(self.state.params, self.mcfg,
                                      self.tp.group))

    def sample(self, length: Optional[int] = None, temperature: float = 1.0) -> str:
        with torch.no_grad():
            return sampler_mod.sample_text(
                self._params(), self.mcfg, self.generator,
                length or self.tcfg.sample_chars, temperature=temperature)

    def evaluate(self, max_chars: Optional[int] = None) -> float:
        if self.test_np is None:
            raise ValueError("no test split configured")
        with torch.no_grad():
            return eval_mod.evaluate_bpc(
                self._params(), self.test_np, self.mcfg,
                max_chars=max_chars or self.tcfg.eval_chars,
                cell_fn=self.cell_fn)

    def save(self, path: str, extra_meta: Optional[Dict] = None):
        """The checkpoint of the canonical state (under a mesh gathered on
        every rank and written by rank 0)."""
        st = self.canonical_state()
        if self.rank != 0:
            return
        ckpt_mod.save_checkpoint(
            path, st.params, st.m, self.step,
            positions=st.positions, stream_h=st.h,
            stream_c=st.c,
            rng_key=np.array([0, self.tcfg.seed & 0xFFFFFFFF], np.uint32),
            meta={"hidden": self.mcfg.hidden,
                  "num_layers": self.mcfg.num_layers, **(extra_meta or {})},
        )

    def restore(self, path: str):
        """The full state of a checkpoint of either package; its JAX key is
        not used. A stream whose saved cursor lies outside this corpus (the
        checkpoint trained on another one) takes this trainer's fresh
        cursor and a reset state, as at a wrap, and says so: the JAX
        package's gather would clamp such a cursor without a word."""
        params, m, step, extras = ckpt_mod.load_checkpoint(path, self.mcfg,
                                                           self.device)
        now = self.canonical_state()
        h = extras.get("stream_h", now.h)
        c = extras.get("stream_c", now.c)
        pos = extras.get("positions", now.positions)
        if pos.shape != now.positions.shape or h.shape != now.h.shape:
            raise ValueError(
                f"{path} holds {tuple(pos.shape)} cursors and a "
                f"{tuple(h.shape)} stream state; this trainer runs "
                f"{tuple(now.h.shape)} (layers, batch, hidden)")
        limit = corpus_mod.corpus_limit(self.length, self.dcfg.seq)
        outside = (pos < 0) | (pos > limit)
        if bool(outside.any()):
            print(f"restore: {int(outside.sum())} of {len(pos)} cursors of "
                  f"{path} lie outside this corpus ({self.length} bytes): "
                  f"those streams take fresh cursors and a reset state",
                  flush=True)
            pos = torch.where(outside, now.positions, pos)
            mask = outside[None, :, None]
            h = torch.where(mask, now.h, h)
            c = torch.where(mask, now.c, c)
        self.state = self._sharded(TrainState(params, m, h, c, pos, step))
        if self.feeder is not None:
            self.feeder.set_positions(self.state.positions.cpu().numpy())
            self._next_windows = None
