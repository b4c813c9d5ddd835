"""Stage-1 (super-resolution) training harness.

Counterpart of the JAX package's ``train/sr_trainer.py``: AdamW with the
warmup-cosine epoch schedule, the masked flow-matching loss with its
per-step statistics, full generative validation (dopri5 by default) with
NN-space and raw-energy MSE, best-3 + last checkpointing keyed on
``val/loss_raw``, resume, the non-finite-loss abort with per-layer
diagnostics, a JSONL metrics sink.

Differences a caller sees:
  * ``device`` is explicit and defaults to ``cuda``; asking for ``cuda`` on a
    machine without one raises.  Only ``device="cpu"`` runs on the CPU.
  * ``dtype`` is the compute dtype (``torch.bfloat16`` for the production
    setting); parameters, gradients and optimizer state stay fp32.
  * noise and times come from a ``torch.Generator`` seeded from ``seed``, or
    are passed to ``train_step`` (the tests feed the JAX package's draws).
  * ``n_event_displays > 0`` turns on the live validation plots at each
    evaluation (analysis/live.py): event displays of the first validation
    batch, the event and cell residual plots, and the event residuals'
    summary scalars in the returned metrics.  Without matplotlib such a
    config raises when the trainer is built.
  * ``packed: true`` packs the training events once into rows of
    ``pack_s`` cells (``pack_rows`` rows a batch; an event longer than a row
    raises, training has no bucketed mop-up), permutes the batch order per
    epoch, and trains through the packed attention kernels; validation stays
    bucketed.
  * data parallelism (the JAX trainer's ``data`` mesh) over a process group:
    ``mesh`` (parallel/mesh.py, one ``data`` axis; by default the whole world
    when a process group is up, none otherwise).  Every rank runs the same
    batcher on the same seed, batch sizes (and ``pack_rows``) are multiples of
    the group size, each rank takes its block of each global batch's events
    (or packed rows) and reads and collates only those, and the noise and
    times are drawn for the global batch from the one seeded generator and cut
    to the rank's rows.  The loss is this rank's squared error over the GLOBAL
    cell count and gradients are SUMMED over the group, so a step at n ranks
    computes the single-device step (``DistributedDataParallel``'s mean of
    per-rank means would not wherever shards hold different cell counts);
    clipping and accumulation act on the summed gradients.  Rank 0 alone
    writes metrics and checkpoints; a resume loads on every rank.
    Validation is split too: its batches are multiples of the group size,
    each rank samples its block of rows from the global batch's noise (drawn
    from the one generator, which so stays in step on every rank), dopri5's
    error norms span every rank's rows, the errors and counts are summed
    over the group, and with the live plots rank 0 alone draws them from the
    global batch's predictions gathered to it.

The optimizer mirrors the JAX package's optax chain exactly
(``clip_by_global_norm`` -> ``scale_by_adam`` -> ``add_decayed_weights`` ->
``scale(-1)``, times the epoch's learning rate, inside ``MultiSteps`` when
``grad_accum_steps > 1``), in fp32, with the bias corrections computed in
fp32 as optax computes them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_threshold
from ..data.bucketing import BucketBatcher
from ..data.packing import PackedBatch, aligned_len, collate_packed, pack_events
from ..data.prefetch import BatchPrefetcher
from ..data.sr_dataset import MODEL_BATCH_KEYS, SupResEvents, collate
from ..flow.cfm import flow_matching_loss, sample_location_and_conditional_flow
from ..flow.sampling import generate_samples
from ..inference.sr import batch_to_device, resolve_device
from ..models.flow_model import FlowModel
from ..models.init_policies import apply_init_policies
from ..ops.flash_packed import SEG_ALIGN
from ..parallel.comm import all_gather, all_reduce_grads, all_reduce_sum, broadcast_object
from ..parallel.mesh import DATA, Mesh, make_mesh, shard_batch, shard_rows
from ..tools.convert import init_params_jax_layout, params_from_jax
from ..transforms import TargetTransform
from .checkpoint import CheckpointManager
from .metrics import MetricsLogger, NullMetrics
from .schedule import schedule_from_config

VAL_BATCH_KEYS = MODEL_BATCH_KEYS + ("e_proxy_raw", "e_truth_raw")


def _f32(x: float) -> float:
    """``x`` rounded to fp32 (what a JAX fp32 scalar holds)."""
    return float(np.float32(x))


class AdamW:
    """The JAX trainer's optax chain over a list of fp32 parameters.

    Per applied step: optional ``clip_by_global_norm`` (``g / norm * max``
    unless ``norm < max``; no epsilon, unlike ``clip_grad_norm_``), Adam
    moments with the bias corrections of optax (b1 0.9, b2 0.999, eps 1e-8
    added to the corrected square root), decoupled weight decay on every
    parameter, then ``p -= lr * update``.  With ``accum_steps > 1`` the
    gradients of ``accum_steps`` calls are averaged (optax ``MultiSteps``'s
    running mean) and the update is applied on the last of them.
    """

    def __init__(self, params: List[torch.Tensor], weight_decay: float = 0.01, clip_norm: Optional[float] = None,
                 accum_steps: int = 0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.wd, self.clip = float(weight_decay), (float(clip_norm) if clip_norm else None)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.accum_steps = int(accum_steps or 0)
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in params] if self.accum_steps > 1 else None
        self.mini_step = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> bool:
        """One call per train step; returns whether the parameters moved."""
        grads = [g.float() for g in grads]
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.clip is not None:
            norm = global_norm(grads)
            if not bool(norm < self.clip):
                grads = [g / norm * self.clip for g in grads]
        self.count += 1
        bc1 = _f32(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = _f32(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - self.b2))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.wd))
        torch._foreach_mul_(upd, _f32(lr))
        torch._foreach_sub_(self.params, upd)
        return True

    def state_dict(self) -> dict:
        out = {"count": torch.tensor(self.count), "mini_step": torch.tensor(self.mini_step),
               "mu": list(self.mu), "nu": list(self.nu)}
        if self.acc is not None:
            out["acc"] = list(self.acc)
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        for dst, src in ((self.mu, sd["mu"]), (self.nu, sd["nu"]), (self.acc, sd.get("acc"))):
            if dst is not None:
                for d, s in zip(dst, src):
                    d.copy_(s)


def global_norm(ts: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax ``global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in ts))


class DataParallel:
    """A trainer's data-parallel side: the ``data`` group of a mesh (or none,
    one process), its size and this rank's place, and whether this rank
    writes metrics and checkpoints (rank 0)."""

    def __init__(self, mesh: Optional[Mesh]):
        if mesh is None and dist.is_initialized():
            mesh = make_mesh()
        if mesh is not None and mesh.names != (DATA,):
            raise ValueError(f"the trainers take a mesh with one data axis, not {mesh.names}")
        self.mesh = mesh
        self.group = mesh.group(DATA) if mesh is not None else None
        self.size = mesh.size(DATA) if mesh is not None else 1
        self.index = mesh.index(DATA) if mesh is not None else 0
        self.writer = mesh is None or self.index == 0

    def shard(self, host_batch: dict) -> dict:
        """This rank's rows of a global host batch."""
        return host_batch if self.mesh is None else shard_batch(host_batch, self.mesh)

    def rows(self, x):
        """This rank's rows of a global tensor."""
        return x if self.mesh is None else shard_rows(x, self.size, self.index)

    def take(self, items):
        """This rank's block of a global batch's items (its event indices or
        packed rows), taken before they are collated: a rank reads and
        collates only its own rows, which come out as the global batch's."""
        if self.mesh is None:
            return items
        if len(items) % self.size:
            raise ValueError(f"{len(items)} batch rows do not split into {self.size} equal shards")
        w = len(items) // self.size
        return items[self.index * w:(self.index + 1) * w]

    def sum_grads(self, grads):
        return grads if self.group is None else all_reduce_grads(list(grads), self.group)


class SRTrainer:
    def __init__(
        self,
        config_mv: dict,
        config_t: dict,
        run_dir: str = "runs/sr",
        seed: int = 0,
        dtype=None,
        device="cuda",
        params: Optional[Dict[str, torch.Tensor]] = None,
        attn_impl: str = "auto",
        mesh: Optional[Mesh] = None,
    ):
        """``params``: a reference-layout state dict (``tools/convert.py``) to
        start from; default a seeded random init with the config's init
        policies.  ``attn_impl``: the attention path ('auto' = the flash
        kernels on CUDA, the dense formulation on the CPU; 'flash';
        'einsum').  ``mesh``: the data-parallel mesh (see the module
        docstring)."""
        ct = config_t
        if int(ct.get("n_event_displays", 0) or 0) > 0:
            try:
                import matplotlib  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "n_event_displays > 0 draws the live validation plots with matplotlib, which does not "
                    "import here; install it or set n_event_displays: 0"
                ) from e
        self.config_mv, self.config_t, self.run_dir = config_mv, config_t, run_dir
        self.device = resolve_device(device)
        self.dp = DataParallel(mesh)
        # the geometry embedder and every plain fp32 product run in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        fm_cfg = config_mv["flow_model"]
        self.model = FlowModel(
            fm_cfg, attn_impl=attn_impl, dtype=dtype, remat=bool(ct.get("remat", False)),
            # training opt-in for the fused DiT layer kernels (differentiable
            # through a plain recompute backward)
            fused_prologue=bool(ct.get("fused_prologue", False)),
        )
        if params is None:
            self.model.load_reference_state_dict(params_from_jax(init_params_jax_layout(fm_cfg, seed=seed), fm_cfg))
            policies = fm_cfg.get("init_weights", {}) or {}
            sd = apply_init_policies(self.model.state_dict(), policies, torch.Generator().manual_seed(seed + 1))
            self.model.load_state_dict(sd)
        else:
            self.model.load_reference_state_dict(params)
        self.model.to(self.device).float()
        # eval mode throughout: the deterministic forward of the JAX loss
        # (dropout off; every shipped config has dropout 0)
        self.model.eval()
        self._params = [p for _, p in self.model.named_parameters()]

        self.sigma_min = float(fm_cfg["sigma_min"])
        self.n_steps = int(fm_cfg["n_steps"])
        self.target_transform = TargetTransform.from_config(config_mv["target_transform"])
        self.opt = AdamW(
            self._params, weight_decay=float(ct.get("weight_decay", 0.01)), clip_norm=ct.get("grad_clip_norm"),
            accum_steps=int(ct.get("grad_accum_steps", 0) or 0),
        )
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.epoch = 0
        self.global_step = 0

        self.lr_fn = schedule_from_config(ct)
        self.metrics = MetricsLogger(run_dir) if self.dp.writer else NullMetrics()
        self.metrics.snapshot_source({"model_and_var": config_mv, "train": config_t})
        self.ckpt: Optional[CheckpointManager] = None

    # ------------------------------------------------------------------
    def _device_batch(self, host_batch, keys=MODEL_BATCH_KEYS) -> dict:
        """The model's keys of a host batch on the device (and ``seg`` for a
        packed one)."""
        if "seg" in host_batch:
            keys = keys + ("seg",)
        return batch_to_device(host_batch, self.device, keys)

    def _batcher(self, ds: SupResEvents, split: str, seed: int) -> BucketBatcher:
        ct = self.config_t
        budget = None
        if ct.get("use_sampler", False):
            budget = resolve_threshold(ct.get(f"n_sq_sum_threshold_{split}"))
        return BucketBatcher(
            ds.cell_count_high,
            quantum=int(ct.get("bucket_quantum", 128)),
            cost_budget=budget,
            max_batch_size=int(ct.get(f"batch_size_{split}", 32)),
            shuffle=(split == "train"),
            seed=seed,
            batch_multiple_of=self.dp.size,
        )

    # ------------------------------------------------------------------
    def _global_draws(self, target, t=None, x0=None):
        """The noise and times the single-device step draws for the global
        batch (x0 first, then t, as ``sample_location_and_conditional_flow``
        draws them), cut to this rank's rows."""
        B = target.shape[0] * self.dp.size
        if x0 is None:
            x0 = self.dp.rows(torch.randn((B,) + tuple(target.shape[1:]), generator=self.generator,
                                          device=target.device, dtype=torch.float32))
        if t is None:
            t = self.dp.rows(torch.rand((B,), generator=self.generator, device=target.device, dtype=torch.float32))
        return t, x0

    def loss_and_grads(self, batch: dict, t=None, x0=None):
        """Forward (deterministic), loss and its gradients w.r.t. every
        parameter, in ``named_parameters`` order.  Returns (loss, stats,
        grads); nothing is read back to the host.  Under data parallelism
        ``batch``, ``t`` and ``x0`` are this rank's rows, and the loss, the
        statistics and the summed gradients are the global batch's."""
        if self.dp.group is not None:
            t, x0 = self._global_draws(batch["target"], t, x0)
        t, xt, ut = sample_location_and_conditional_flow(
            batch["target"], self.sigma_min, t=t, x0=x0, generator=self.generator
        )
        vt = self.model(batch, xt, t)
        loss, stats = flow_matching_loss(vt, ut, batch["q_mask"], group=self.dp.group)
        grads = self.dp.sum_grads(torch.autograd.grad(loss, self._params))
        return stats["loss_mean"], stats, grads

    def train_step(self, batch: dict, t=None, x0=None, lr: Optional[float] = None) -> dict:
        """One optimizer step on a device batch (``MODEL_BATCH_KEYS``).
        ``t`` (B,) and ``x0`` (the target's shape) default to draws from the
        trainer's generator; ``lr`` to the current epoch's.  Returns the
        step's statistics as 0-dim tensors: the loss, ``grad_norm`` (before
        clipping), the finite-loss flag ``nonfinite`` and the flow-matching
        statistics."""
        lr = self.lr_fn(self.epoch) if lr is None else lr
        loss, stats, grads = self.loss_and_grads(batch, t=t, x0=x0)
        grad_norm = global_norm(grads)
        self.opt.step(list(grads), lr)
        self.global_step += 1
        # the reference aborts on a non-finite loss; the flag is read once
        # per epoch, so no step waits for the device
        stats["nonfinite"] = (~torch.isfinite(loss)).float()
        stats["loss"] = loss
        stats["grad_norm"] = grad_norm
        return {k: v.detach() for k, v in stats.items()}

    def state(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.opt.state_dict()}

    def load_state(self, state: dict):
        self.model.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt_state"])

    # ------------------------------------------------------------------
    def fit(
        self,
        train_ds: Optional[SupResEvents] = None,
        val_ds: Optional[SupResEvents] = None,
        num_epochs: Optional[int] = None,
        resume: bool = False,
    ):
        ct = self.config_t
        if train_ds is None:
            train_ds = SupResEvents(
                ct["train_path"], self.config_mv, reduce_ds=ct.get("reduce_ds_train", -1),
                one_event_train=ct.get("one_event_train", False), one_event_idx=ct.get("one_event_idx", 0),
            )
        if val_ds is None and ct.get("val_path"):
            val_ds = SupResEvents(
                ct["val_path"], self.config_mv, make_low=True, reduce_ds=ct.get("reduce_ds_val", -1),
                one_event_train=ct.get("one_event_train", False), one_event_idx=ct.get("one_event_idx", 0),
            )

        self.ckpt = CheckpointManager(
            os.path.join(self.run_dir, "checkpoints"), monitor="val/loss_raw",
            configs={"config_mv": self.config_mv, "config_t": self.config_t} if self.dp.writer else None,
        )
        if resume:
            try:
                self.load_state(self.ckpt.restore(which="last", map_location=self.device))
                self.epoch = (self.ckpt.latest_step() or 0) + 1
            except FileNotFoundError:
                pass  # nothing to resume from: a fresh start

        num_epochs = num_epochs or int(ct["num_epochs"])
        eval_every = int(ct.get("eval_every_n_epoch", 1))
        num_workers = int(ct.get("num_workers", 2))
        # preprocessed-event cache: host RAM for per-epoch CPU; off for
        # datasets that do not fit
        cache_events = bool(ct.get("cache_events", True))
        train_cache: Dict[int, object] = {}

        def event(i):
            if not cache_events:
                return train_ds.get_event(i)
            ev = train_cache.get(i)
            if ev is None:
                ev = train_cache[i] = train_ds.get_event(i)
            return ev

        def prepare(item):
            """Host-side batch prep, in the prefetch thread pool."""
            idxs, bucket = item
            return collate([event(i) if i >= 0 else None for i in self.dp.take(idxs)], bucket.pad_n)

        # packed training (`packed: true`): the layout is packed once (first-fit
        # decreasing is deterministic) and the batch order permuted per epoch
        packed = bool(ct.get("packed", False))
        if packed:
            pack_s, pack_rows = int(ct.get("pack_s", 5120)), int(ct.get("pack_rows", 8))
            if pack_rows < 1 or pack_rows % self.dp.size:
                raise ValueError(f"pack_rows={pack_rows} must be a positive multiple of the data-parallel "
                                 f"size ({self.dp.size})")
            counts = np.asarray(train_ds.cell_count_high)
            n_over = int(sum(aligned_len(int(c)) > pack_s for c in counts))
            if n_over:
                raise ValueError(f"{n_over} events exceed pack_s={pack_s} after {SEG_ALIGN}-cell alignment; "
                                 "raise pack_s (training has no bucketed mop-up)")
            pack_layouts = pack_events(counts, S=pack_s, rows_per_batch=pack_rows)

            def prepare_packed(lay):
                lay = PackedBatch(self.dp.take(lay.rows))
                return collate_packed({i: event(i) for row in lay.rows for i, _, _ in row}, lay, S=pack_s)

        profile_epoch = self.epoch if ct.get("profile") else None

        for epoch in range(self.epoch, num_epochs):
            self.epoch = epoch
            lr = self.lr_fn(epoch)
            t_ep = time.time()
            ep_stats: Dict[str, torch.Tensor] = {}
            n_batches, last_hb = 0, None
            if epoch == profile_epoch:
                self.metrics.start_profile(self.device)
            if packed:
                order = np.random.default_rng(epoch).permutation(len(pack_layouts))
                batches = BatchPrefetcher([pack_layouts[i] for i in order], prepare_packed, num_workers=num_workers)
            else:
                batches = BatchPrefetcher(self._batcher(train_ds, "train", seed=epoch), prepare,
                                          num_workers=num_workers)
            for hb in batches:
                stats = self.train_step(self._device_batch(hb), lr=lr)
                n_batches += 1
                last_hb = hb
                for k, v in stats.items():
                    ep_stats[k] = ep_stats.get(k, 0.0) + v
            ep = {f"train/{k}": float(v) / max(n_batches, 1) for k, v in ep_stats.items()}
            ep["lr"] = lr
            ep["train/epoch_s"] = time.time() - t_ep
            ep["train/n_batches"] = n_batches
            if epoch == profile_epoch:
                self.metrics.stop_profile()

            if ep.get("train/nonfinite", 0) > 0:
                # the reference's non-finite abort: re-run the last batch's
                # forward with per-layer statistics before stopping
                diag = self._dump_nonfinite_diagnostics(last_hb, epoch)
                self.metrics.log_scalars({"fatal_nonfinite_loss": 1.0}, step=epoch)
                raise FloatingPointError(f"non-finite training loss at epoch {epoch}; diagnostics at {diag}")

            if val_ds is not None and (epoch % eval_every == 0 or epoch == num_epochs - 1):
                make_plots = int(ct.get("n_event_displays", 0) or 0) > 0
                ep.update(self.evaluate(val_ds, make_plots=make_plots, epoch=epoch))

            self.metrics.log_scalars(ep, step=epoch)
            if self.dp.writer:
                self.ckpt.save(epoch, self.state(), ep)
            self.epoch = epoch + 1
        return self

    # ------------------------------------------------------------------
    def _dump_nonfinite_diagnostics(self, host_batch, epoch: int) -> str:
        """Per-layer statistics on the non-finite-loss trip: parameter
        statistics and, from one forward of the last batch with forward
        hooks, the activations of every module (non-finite parameters
        persist, so the last batch localises the first offending module)."""
        from ..models.summary import activation_summary, param_summary

        report = {"epoch": epoch, "params": param_summary(self.model.state_dict())}
        try:
            batch = self._device_batch(host_batch)
            t, xt, _ = sample_location_and_conditional_flow(batch["target"], self.sigma_min, generator=self.generator)
            report["activations"] = activation_summary(self.model, lambda: self.model(batch, xt, t))
        except Exception as e:  # the report must never mask the abort that follows
            report["activation_capture_error"] = f"{type(e).__name__}: {str(e)[:500]}"
        path = os.path.join(self.run_dir, "nonfinite_diagnostics.json")
        if self.dp.writer:
            with open(path, "w") as fp:
                json.dump(report, fp, indent=2, default=str)
        return path

    # ------------------------------------------------------------------
    def evaluate(self, val_ds: SupResEvents, n_steps: Optional[int] = None, make_plots: bool = False,
                 epoch: int = 0) -> Dict[str, float]:
        """Full generative validation: sample every validation event with
        ``val_ode_method`` (default dopri5) and report the node-count
        weighted mean squared error in NN space and in raw energy.  With
        ``make_plots``, the live plots of the JAX trainer: event displays of
        the first batch's first ``n_event_displays`` events, the event and
        cell residual plots (figures under ``<run_dir>/figures``), and the
        event residuals' summary scalars (``res_event/*``) in the result.
        Under data parallelism each rank samples its rows of every batch
        (module docstring); the result is the global batch's on every rank,
        and the plots are rank 0's."""
        method = self.config_t.get("val_ode_method", "dopri5")
        n_steps = n_steps or self.n_steps
        n_displays = int(self.config_t.get("n_event_displays", 0) or 0) if make_plots else 0
        group = self.dp.group
        # dopri5's norms span the ranks' rows; one rank needs no collective
        pg = group if self.dp.size > 1 else None
        perf_live = None
        if make_plots and self.dp.writer:
            import matplotlib

            matplotlib.use("Agg")  # files only, as the PF trainer's plots
            from ..analysis.live import PerformanceCOCOALive

            perf_live = PerformanceCOCOALive(int(self.config_mv.get("res_factor", 2)))
        tot_nn = tot_raw = tot_n = 0.0
        first_batch = True
        for idxs, bucket in self._batcher(val_ds, "val", seed=0):
            events = [val_ds.get_event(i) if i >= 0 else None for i in self.dp.take(idxs)]
            hb = collate(events, bucket.pad_n, with_low=make_plots)
            batch = self._device_batch(hb, VAL_BATCH_KEYS)
            x0 = self._val_x0(batch["e_proxy"]) if group is not None else None
            pred = generate_samples(
                lambda b, x, t: self.model(b, x, t), batch, n_steps=n_steps, method=method,
                generator=self.generator, x0=x0, pg=pg,
            )
            with torch.no_grad():
                m = batch["q_mask"][..., None].float()
                se_nn = ((pred - batch["target"]) ** 2 * m).sum()
                e_pred_raw = self.target_transform.inverse(pred, batch["e_proxy_raw"])
                se_raw = ((e_pred_raw - batch["e_truth_raw"]) ** 2 * m).sum()
                sums = torch.stack([se_nn, se_raw, m.sum()])
                if group is not None:
                    sums = all_reduce_sum(sums, group)
            tot_nn += float(sums[0])
            tot_raw += float(sums[1])
            tot_n += float(sums[2].clamp_min(1.0))
            if make_plots:
                if group is not None:  # the global batch's, in row order, for rank 0
                    pred, e_pred_raw = all_gather(pred, group, 0), all_gather(e_pred_raw, group, 0)
                    if perf_live is not None:
                        events = [val_ds.get_event(i) if i >= 0 else None for i in idxs]
                        hb = collate(events, bucket.pad_n, with_low=True)
                if perf_live is not None:
                    e_pred_np = e_pred_raw.float().cpu().numpy()
                    perf_live.update(hb, e_pred_np)
                    if first_batch and n_displays > 0:
                        self._event_displays(hb, events[:n_displays], pred.float().cpu().numpy(), e_pred_np)
                first_batch = False

        extra = {}
        if perf_live is not None and perf_live.n_events:
            import matplotlib.pyplot as plt

            fig, summ = perf_live.plot_residual_event()
            self.metrics.log_figure(fig, "residual_event_energy")
            plt.close(fig)
            extra.update(summ)
            fig = perf_live.plot_residual_cell()
            self.metrics.log_figure(fig, "residual_cell_energy")
            plt.close(fig)
        if group is not None and make_plots:  # the summary scalars on every rank
            extra = broadcast_object(extra, group)
        n = max(tot_n, 1.0)
        return {"val/loss": tot_nn / n, "val/loss_raw": tot_raw / n, **extra}

    def _val_x0(self, e_proxy):
        """The sampler's start for the global validation batch, drawn as the
        single-process sampler draws it, cut to this rank's rows."""
        shape = (e_proxy.shape[0] * self.dp.size,) + tuple(e_proxy.shape[1:])
        x0 = torch.randn(shape, generator=self.generator, device=e_proxy.device, dtype=torch.float32)
        return self.dp.rows(x0.to(e_proxy.dtype))

    def _event_displays(self, hb, events, pred, e_pred_raw):
        """One event display figure (``ED_<i>``) per real event of the batch."""
        import matplotlib.pyplot as plt

        from ..analysis.live import event_display_figure

        for p_i, ev in enumerate(events):
            if ev is None:
                continue
            m = hb["q_mask"][p_i]
            fig = event_display_figure({
                "eta_raw": hb["eta_raw"][p_i, m, 0],
                "phi": hb["phi"][p_i, m, 0],
                "layer": hb["layer"][p_i, m, 0],
                "target": hb["target"][p_i, m, 0],
                "e_truth_raw": hb["e_truth_raw"][p_i, m, 0] * 1e3,
                "pred": pred[p_i, m, 0],
                "e_pred_raw": e_pred_raw[p_i, m, 0] * 1e3,
            })
            self.metrics.log_figure(fig, f"ED_{p_i}")
            plt.close(fig)
