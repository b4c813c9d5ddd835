"""Stage-2 (particle-flow) training harness.

Counterpart of the JAX package's ``train/pf_trainer.py``: loss =
``card_loss_weight`` x cross-entropy of the cardinality + the Hungarian-matched
set loss (incidence KL with ``loss_on_inc_wts: true``, else the kinematics
variant), every batch mean over real events only; global-norm gradient
clipping, AdamW and the warm-start cosine epoch schedule (the optax chain of
``SRTrainer``); best-3 + last checkpoints keyed on ``val_loss_to_optimize_on``;
resume; validation with the cardinality accuracy and, with
``epoch_end_plots``, the confusion matrix and the matched residual histograms
(matplotlib imported only then).

Differences a caller sees:
  * ``device`` is explicit and defaults to ``cuda``; asking for ``cuda`` on a
    machine without one raises.  Only ``device="cpu"`` runs on the CPU.
  * ``dtype`` is the compute dtype (None = fp32, the default; bf16 optional);
    parameters, gradients and optimizer state stay fp32.
  * ``params``: a reference-layout state dict (tools/convert.py) to start
    from; default a seeded random init with the config's init policies.
  * data parallelism over a process group (``mesh``), as ``SRTrainer``'s
    (train/sr_trainer.py): every rank reads and collates only its rows of
    each global batch,
    the random particle slots' noise is drawn for the global batch and cut
    to the rank's rows, every per-event mean divides by the GLOBAL count of
    real events, and gradients are summed over the group; rank 0 alone
    writes metrics and checkpoints.  Validation is split the same way: each
    rank runs its rows of every batch (its slots' noise cut from the global
    draw), the losses are summed over the group, the cardinality and
    residual lists gathered in the global batch's row order, and rank 0
    alone draws the plots.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import resolve_threshold
from ..data.bucketing import BucketBatcher
from ..data.pf_dataset import PflowEvents, collate_pf
from ..data.prefetch import BatchPrefetcher
from ..inference.pf import pf_batch_to_device
from ..inference.sr import resolve_device
from ..losses.set2set import set_to_set_incidence_loss, set_to_set_kinematics_loss
from ..models.init_policies import apply_init_policies
from ..models.pf.model_pf import SAPF
from ..parallel.comm import all_reduce_sum, gather_object
from ..parallel.mesh import Mesh
from ..tools.convert import init_pf_params_jax_layout, pf_params_from_jax
from ..transforms import build_var_transforms
from .checkpoint import CheckpointManager
from .metrics import MetricsLogger, NullMetrics
from .schedule import schedule_from_config
from .sr_trainer import AdamW, DataParallel, global_norm


def cross_entropy_int_labels(logits, labels, event_mask=None, n_events=None):
    """Per-event cross-entropy averaged over real events only (divided by
    ``n_events`` in place of this batch's count where given)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    if event_mask is None:
        return ce.mean()
    w = event_mask.to(ce.dtype)
    return (ce * w).sum() / (w.sum() if n_events is None else n_events).clamp_min(1.0)


def _interleave(per_rank: list) -> list:
    """Per-rank lists of per-batch items -> one list, batch by batch and
    within a batch rank by rank: the global batches' row order."""
    return [item for batch in zip(*per_rank) for item in batch]


class PFTrainer:
    def __init__(
        self,
        config_mv: dict,
        config_t: dict,
        run_dir: str = "runs/pf",
        seed: int = 0,
        dtype=None,
        device="cuda",
        params: Optional[Dict[str, torch.Tensor]] = None,
        attn_impl: str = "auto",
        mesh: Optional[Mesh] = None,
    ):
        ct = config_t
        self.config_mv, self.config_t, self.run_dir = config_mv, config_t, run_dir
        self.device = resolve_device(device)
        self.dp = DataParallel(mesh)
        # cell_init_0 and every plain fp32 product run in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        pf_cfg = config_mv["pf_model"]
        self.max_part = int(pf_cfg["max_particles"])
        self.transforms = build_var_transforms(config_mv["var_transform"])
        self.model = SAPF(pf_cfg, transforms=self.transforms, dtype=dtype, attn_impl=attn_impl)
        if params is None:
            self.model.load_reference_state_dict(pf_params_from_jax(init_pf_params_jax_layout(pf_cfg, seed=seed),
                                                                    pf_cfg))
            sd = apply_init_policies(self.model.state_dict(), pf_cfg.get("init_weights", {}) or {},
                                     torch.Generator().manual_seed(seed + 1))
            self.model.load_state_dict(sd)
        else:
            self.model.load_reference_state_dict(params)
        self.model.to(self.device).float().eval()  # deterministic forward (dropout 0 in every config)
        self._params = [p for _, p in self.model.named_parameters()]
        self.loss_on_inc = bool(ct.get("loss_on_inc_wts", False))
        self.card_weight = float(ct.get("card_loss_weight", 1.0))
        self.opt = AdamW(self._params, weight_decay=float(ct.get("weight_decay", 0.01)),
                         clip_norm=float(ct.get("grad_clip_norm", 1.0)))
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.epoch = 0
        self.global_step = 0
        self.lr_fn = schedule_from_config(ct)
        self.metrics = MetricsLogger(run_dir) if self.dp.writer else NullMetrics()
        self.metrics.snapshot_source({"model_and_var": config_mv, "train": config_t})
        self.ckpt: Optional[CheckpointManager] = None

    # ------------------------------------------------------------------
    def compute_loss(self, pred, batch, group=None):
        """(loss, logs, assign); batch means over real events (cell_mask.any).
        With a data-parallel ``group`` the means divide by the real events of
        the whole group's batch: the result is this rank's share."""
        card_logits, kin_pred, inc_weights = pred
        event_mask = batch["cell_mask"].any(dim=-1)
        n_events = None
        if group is not None:
            n_events = all_reduce_sum(event_mask.to(torch.float32).sum(), group)
        loss = 0.0
        logs: Dict[str, torch.Tensor] = {}
        if card_logits is not None:
            card_loss = self.card_weight * cross_entropy_int_labels(card_logits, batch["cardinality"], event_mask,
                                                                    n_events)
            loss = loss + card_loss
            logs["card_loss"] = card_loss
        assign = None
        if kin_pred is not None:
            if self.loss_on_inc:
                set_loss, comps, assign = set_to_set_incidence_loss(inc_weights, batch, kin_pred, event_mask,
                                                                    n_events)
                logs["inc_loss"] = set_loss
            else:
                set_loss, comps, assign = set_to_set_kinematics_loss(kin_pred, batch, self.config_t, event_mask,
                                                                     n_events)
                logs["kin_loss"] = set_loss
            loss = loss + set_loss
            logs.update(comps)
        logs["loss"] = loss
        return loss, logs, assign

    def _global_noise(self, batch):
        """The random slots' noise the single-device step draws for the global
        batch, cut to this rank's rows (None where the slots are not
        random)."""
        kp = self.model.kinematics_predictor
        if kp is None or kp.init_type != "random":
            return None
        B = batch["cell_mask"].shape[0] * self.dp.size
        return self.dp.rows(torch.randn((B, kp.max_part, kp.h_dim), generator=self.generator, device=self.device))

    def loss_and_grads(self, batch: dict, noise=None):
        """Loss, its logs and the gradients w.r.t. every parameter (in
        ``named_parameters`` order).  ``noise``: the random slots' draws.
        Under data parallelism ``batch`` and ``noise`` are this rank's rows,
        and the loss, the logs and the summed gradients are the global
        batch's."""
        if self.dp.group is not None and noise is None:
            noise = self._global_noise(batch)
        pred = self.model(batch, noise=noise, generator=self.generator)
        loss, logs, _ = self.compute_loss(pred, batch, group=self.dp.group)
        grads = self.dp.sum_grads(torch.autograd.grad(loss, self._params))
        if self.dp.group is not None:
            keys = list(logs)
            logs = dict(zip(keys, all_reduce_sum(torch.stack([logs[k].detach().float() for k in keys]),
                                                 self.dp.group)))
        return logs["loss"], logs, grads

    def train_step(self, batch: dict, lr: Optional[float] = None, noise=None) -> dict:
        """One optimizer step on a device batch; returns the step's logs as
        0-dim tensors (and ``grad_norm`` before clipping)."""
        lr = self.lr_fn(self.epoch) if lr is None else lr
        _, logs, grads = self.loss_and_grads(batch, noise=noise)
        logs["grad_norm"] = global_norm(grads)
        self.opt.step(list(grads), lr)
        self.global_step += 1
        return {k: v.detach() for k, v in logs.items()}

    def state(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.opt.state_dict()}

    def load_state(self, state: dict):
        self.model.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt_state"])

    # ------------------------------------------------------------------
    def _dataset(self, split: str) -> PflowEvents:
        ct = self.config_t
        return PflowEvents(
            ct[f"{split}_glob_arg"], config_mv=self.config_mv,
            energy_threshold=float(ct.get("energy_threshold", 0.0)), reduce_ds=int(ct.get(f"reduce_ds_{split}", -1)),
            res=ct.get("resolution", "low"), drop_single_part_events=bool(ct.get("drop_single_part_events", False)),
            load_incidence=self.loss_on_inc,
        )

    def _batcher(self, ds: PflowEvents, split: str, seed: int) -> BucketBatcher:
        ct = self.config_t
        budget = resolve_threshold(ct.get(f"n_sq_sum_threshold_{split}")) if ct.get("use_sampler", False) else None
        return BucketBatcher(ds.cell_count, quantum=int(ct.get("bucket_quantum", 128)), cost_budget=budget,
                             max_batch_size=int(ct.get(f"batch_size_{split}", 32)), shuffle=(split == "train"),
                             seed=seed, batch_multiple_of=self.dp.size)

    def fit(self, train_ds: Optional[PflowEvents] = None, val_ds: Optional[PflowEvents] = None,
            num_epochs: Optional[int] = None, resume: bool = False):
        ct = self.config_t
        train_ds = train_ds or self._dataset("train")
        if val_ds is None and ct.get("val_glob_arg"):
            val_ds = self._dataset("val")
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, "checkpoints"), monitor="val_loss_to_optimize_on",
                                      configs={"config_mv": self.config_mv, "config_t": self.config_t}
                                      if self.dp.writer else None)
        if resume:
            try:
                self.load_state(self.ckpt.restore(which="last", map_location=self.device))
                self.epoch = (self.ckpt.latest_step() or 0) + 1
            except FileNotFoundError:
                pass  # nothing to resume from: a fresh start

        num_epochs = num_epochs or int(ct["num_epochs"])
        eval_every = int(ct.get("eval_every_n_epoch", 1))
        cache: Dict[int, dict] = {}
        cache_events = bool(ct.get("cache_events", True))

        def prepare(item):
            idxs, bucket = item
            idxs = self.dp.take(idxs)  # this rank's events only
            if cache_events:
                events = [(cache.setdefault(i, train_ds.get_event(i)) if i >= 0 else None) for i in idxs]
            else:
                events = [train_ds.get_event(i) if i >= 0 else None for i in idxs]
            # the incidence key from the dataset, not the shard: a shard of
            # fillers alone must carry it where the others do
            return collate_pf(events, bucket.pad_n, self.max_part,
                              with_incidence=getattr(train_ds, "load_incidence", None))

        profile_epoch = self.epoch if ct.get("profile") else None
        for epoch in range(self.epoch, num_epochs):
            self.epoch = epoch
            lr = self.lr_fn(epoch)
            t0 = time.time()
            sums: Dict[str, torch.Tensor] = {}
            n_b = 0
            if epoch == profile_epoch:
                self.metrics.start_profile(self.device)
            for hb in BatchPrefetcher(self._batcher(train_ds, "train", seed=epoch), prepare,
                                      num_workers=int(ct.get("num_workers", 2))):
                logs = self.train_step(pf_batch_to_device(hb, self.device), lr=lr)
                n_b += 1
                for k, v in logs.items():
                    sums[k] = sums.get(k, 0.0) + v
            ep = {f"train/{k}": float(v) / max(n_b, 1) for k, v in sums.items()}
            ep["lr"] = lr
            ep["train/epoch_s"] = time.time() - t0
            ep["train/n_batches"] = n_b
            if epoch == profile_epoch:
                self.metrics.stop_profile()
            if val_ds is not None and (epoch % eval_every == 0 or epoch == num_epochs - 1):
                ep.update(self.evaluate(val_ds, make_plots=bool(ct.get("epoch_end_plots", True))))
            self.metrics.log_scalars(ep, step=epoch)
            if self.dp.writer:
                self.ckpt.save(epoch, self.state(), ep)
            self.epoch = epoch + 1
        return self

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, val_ds: PflowEvents, make_plots: bool = False) -> Dict[str, float]:
        """Validation losses (batch means), the cardinality accuracy, and with
        ``make_plots`` the confusion matrix and the matched residual
        histograms.  Under data parallelism each rank runs its rows of every
        batch (module docstring); the result is the global batch's on every
        rank."""
        group = self.dp.group
        sums: Dict[str, float] = {}
        n_b = 0
        # per batch: this rank's (cardinality truth, prediction) and residuals
        card: list = []
        kin_res: list = []
        for idxs, bucket in self._batcher(val_ds, "val", seed=0):
            idxs = self.dp.take(idxs)
            events = [val_ds.get_event(i) if i >= 0 else None for i in idxs]
            # the incidence key from the dataset: a rank's rows may be fillers alone
            hb = collate_pf(events, bucket.pad_n, self.max_part, with_incidence=getattr(val_ds, "load_incidence", None))
            batch = pf_batch_to_device(hb, self.device)
            noise = self._global_noise(batch) if group is not None else None
            card_logits, kin_pred, inc = pred = self.model(batch, noise=noise, generator=self.generator)
            _, logs, assign = self.compute_loss(pred, batch, group=group)
            if group is not None:  # this rank's shares -> the global batch's
                keys = list(logs)
                logs = dict(zip(keys, all_reduce_sum(torch.stack([logs[k].float() for k in keys]), group)))
            real = idxs >= 0
            n_b += 1
            for k, v in logs.items():
                sums[f"val/{k}"] = sums.get(f"val/{k}", 0.0) + float(v)
            sums["val_loss_to_optimize_on"] = sums.get("val_loss_to_optimize_on", 0.0) + float(logs["loss"])
            if card_logits is not None:
                card.append((hb["cardinality"][real], torch.argmax(card_logits, dim=-1).cpu().numpy()[real]))
            if make_plots and kin_pred is not None and assign is not None:
                kin_res.append(self._residuals(hb, kin_pred, assign, real))
        if group is not None:  # every rank's lists, in the global batches' row order
            card, kin_res = (_interleave(gather_object(x, group)) for x in (card, kin_res))
        res = {k: v / max(n_b, 1) for k, v in sums.items()}
        if card:
            t, p = (np.concatenate(x) for x in zip(*card))
            res["val/card_accuracy"] = float((t == p).mean())
            if make_plots and self.dp.writer:
                self._plot_cardinality_confusion(t, p)
        if make_plots and self.dp.writer and kin_res:
            self._plot_kinematics_residuals({k: np.hstack([r[k] for r in kin_res]) for k in kin_res[0]})
        return res

    def _residuals(self, hb, kin_pred, assign, real) -> Dict[str, np.ndarray]:
        """Matched raw-space residuals of a batch's real particles; the
        energy against the full particle energy, as the reference plots it."""
        tr = self.transforms
        rows = torch.arange(kin_pred.shape[0], device=kin_pred.device)[:, None]
        km = kin_pred[rows, assign].float().cpu().numpy()
        pm = hb["part_mask"] & real[:, None]
        dphi = hb["part_phi"][pm] - km[..., 2][pm]
        return {"pt": hb["part_pt_raw"][pm] - np.asarray(tr["pt"].inverse(km[..., 0]))[pm],
                "eta": hb["part_eta_raw"][pm] - np.asarray(tr["eta"].inverse(km[..., 1]))[pm],
                "phi": (dphi + np.pi) % (2 * np.pi) - np.pi,
                "e": hb["part_e_raw"][pm] - np.asarray(tr["e"].inverse(km[..., 3]))[pm]}

    def _plot_cardinality_confusion(self, truth, pred):
        """Confusion-matrix heatmap of the cardinality."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n = self.max_part + 1
        cm = np.zeros((n, n), int)
        for t, p in zip(truth, pred):
            cm[min(int(p), n - 1), min(int(t), n - 1)] += 1
        fig, ax = plt.subplots(figsize=(6, 5), dpi=100)
        im = ax.imshow(cm, cmap="Blues")
        for i in range(n):
            for j in range(n):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center", fontsize=8)
        ax.set_xlabel("truth cardinality")
        ax.set_ylabel("pred cardinality")
        fig.colorbar(im, ax=ax)
        self.metrics.log_figure(fig, "cardinality")
        plt.close(fig)

    def _plot_kinematics_residuals(self, res: Dict[str, np.ndarray]):
        """Residual histograms with mu/sigma/median/IQR labels."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, len(res), figsize=(4 * len(res), 3.5), dpi=100)
        for ax, (name, r) in zip(np.atleast_1d(axes), res.items()):
            if r.size == 0:
                continue
            lo, hi = np.percentile(r, [3, 97])
            bins = np.linspace(lo, hi if hi > lo else lo + 1, 60)
            ax.hist(r, bins=bins, histtype="stepfilled", color="cornflowerblue", ec="k", lw=0.5)
            iqr = np.subtract(*np.percentile(r, [75, 25]))
            ax.set_title(rf"$\mu$={r.mean():.2f}, $\sigma$={r.std():.2f}" f"\nmed={np.median(r):.2f}, IQR={iqr:.2f}",
                         fontsize=9)
            ax.set_xlabel(f"{name} (truth - pred)")
        fig.tight_layout()
        self.metrics.log_figure(fig, "kinematics")
        plt.close(fig)
