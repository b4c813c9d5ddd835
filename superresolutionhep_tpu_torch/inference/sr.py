"""Stage-1 inference runner: ensemble ODE sampling.

Counterpart of the JAX package's ``inference/sr.py``: the model/parameter
set-up, the first-batch gate of the no-max attention kernel, the ensemble
sampler with store-index capture, and the file-driven ``run_pred`` over
bucketed batches or segment-packed rows (``packed: true``; events too long
for a packed row go through the bucketed path), writing the three output
trees.

Differences a caller sees:
  * ``device`` is explicit and defaults to ``cuda``; asking for ``cuda`` on a
    machine without one raises.  Only ``device="cpu"`` runs on the CPU.
  * wherever the JAX package takes a YAML path (``model.config_path_mv`` /
    ``model.config_path_t``) an already-loaded mapping may be given instead
    (``model.config_mv`` / ``model.config_t``).
  * ``params`` is a reference-layout ``state_dict`` (tools/convert.py); by
    default it is read from ``model.checkpoint_path``, a checkpoint of the
    port's trainer or a Flax ``.msgpack`` blob such as
    ``saved_checkpoints/closure_sr/params.msgpack``
    (train/checkpoint.py::load_reference_params).
  * noise comes from a ``torch.Generator`` on the device seeded from
    ``inf_dict["seed"]``, or from an injected callable
    ``noise(batch_index, shape) -> x0`` (the tests feed the JAX package's
    draws).  As in the JAX package, the batch index restarts at 0 for the
    bucketed pass that follows the packed one.
  * ``predict`` is ``run_pred`` without the file IO: it takes a
    ``SupResEvents`` and returns the three trees.
"""

from __future__ import annotations

import os
import sys
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import load_yaml
from ..data import root_io
from ..data.bucketing import BucketBatcher
from ..data.jagged import JaggedArray
from ..data.packing import aligned_len, collate_packed, pack_events
from ..data.sr_dataset import MODEL_BATCH_KEYS, SupResEvents, collate
from ..flow.ode import FIXED_STEP_METHODS, MULTISTEP_METHODS
from ..flow.sampling import generate_ensemble
from ..models.flow_model import FlowModel
from ..models.precision import cast_params_for_inference
from ..ops.flash_attention import nomax_selfcheck
from ..train.checkpoint import load_reference_params
from ..transforms import TargetTransform

PACKED_BATCH_KEYS = MODEL_BATCH_KEYS + ("seg",)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device that is not there raises
    (no entry point carries on on the CPU because it found no GPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _config(model_cfg: dict, key: str):
    loaded = model_cfg.get(f"config_{key}")
    if loaded is not None:
        return loaded
    return load_yaml(model_cfg[f"config_path_{key}"])


def batch_to_device(host_batch: dict, device, keys) -> dict:
    """The ``keys`` of a numpy batch (data/sr_dataset.py::collate) as tensors
    on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(host_batch[k])).to(device) for k in keys}


class SRInference:
    def __init__(self, inf_cfg: dict, params=None, device="cuda"):
        self.inf_cfg = inf_cfg
        self.device = resolve_device(device)
        # the geometry embedder and every plain-PyTorch fp32 product run in
        # full fp32: TF32 keeps ~3 decimal digits, less than the eta pitch needs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mcfg = inf_cfg["model"]
        self.config_mv = _config(mcfg, "mv")
        self.config_t = _config(mcfg, "t")
        # opt-in bf16 compute (`model.dtype: bfloat16`): dense stack in bf16,
        # geometry embedder kept fp32 (models/precision.py).  Default fp32.
        dtype_name = str(mcfg.get("dtype", "") or "")
        self.dtype = torch.bfloat16 if dtype_name in ("bfloat16", "bf16") else None
        # opt-in inference fast path: clipped no-max softmax kernel, validated
        # against the robust kernel on the first batch of every run
        self.fast_softmax = bool(mcfg.get("fast_softmax", False))
        self._nomax_validated = False
        self.nomax_selfcheck_passed = None  # outcome of the first-batch gate
        self.target_transform = TargetTransform.from_config(self.config_mv["target_transform"])

        flow_cfg = self.config_mv["flow_model"]
        if params is None:
            params = load_reference_params(mcfg["checkpoint_path"], flow_cfg, "sr")

        self.model = FlowModel(flow_cfg).to(self.device)
        self.model.load_reference_state_dict(params)
        if self.dtype is not None:
            cast_params_for_inference(self.model, self.dtype)
        self.model.eval().requires_grad_(False)
        # the fast model also fuses the DiT attention prologue and MLP
        # half-layer; the robust model stays fully unfused, so the first-batch
        # selfcheck validates the fused kernels together with the no-max
        # softmax against the reference path.  Both share one set of tensors.
        self.model_fast = None
        if self.fast_softmax:
            self.model_fast = FlowModel(
                flow_cfg, attn_impl="flash_nomax", fused_prologue=bool(mcfg.get("fused_prologue", True))
            )
            self.model_fast.load_state_dict(self.model.state_dict(), assign=True)
            self.model_fast.eval().requires_grad_(False)

        n_steps = int(mcfg["n_steps"])
        self.n_steps = n_steps
        ts_used = np.linspace(0, 1, n_steps)
        n_store = int(mcfg.get("n_steps_to_store", 0))
        self.ts_to_store: List[float] = []
        self.ts_to_store_idx: List[int] = []
        if n_store:
            for t in np.linspace(0, 1, n_store + 1)[:-1]:
                idx = int(np.argmin(np.abs(ts_used - t)))
                self.ts_to_store.append(float(ts_used[idx]))
                self.ts_to_store_idx.append(idx)

        # selective trajectory capture: only the stored intermediate steps +
        # the final state are kept
        self.store_set = sorted(set(self.ts_to_store_idx) | {n_steps - 1})
        self.store_pos = {idx: i for i, idx in enumerate(self.store_set)}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _validate_nomax(self, batch) -> bool:
        """First-batch gate for the no-max kernel: one model eval at t=0.5
        through both attention variants must agree (exact iff the logits
        respect the clip bounds — proven, not assumed)."""
        x = torch.zeros_like(batch["e_proxy"])
        t = torch.full((batch["eta"].shape[0],), 0.5, dtype=torch.float32, device=x.device)
        ok = nomax_selfcheck(lambda b: self.model(b, x, t), lambda b: self.model_fast(b, x, t), batch)
        self.nomax_selfcheck_passed = ok
        if not ok:
            warnings.warn(
                "fast_softmax: no-max kernel failed the first-batch selfcheck "
                "(attention logits outside the clip bounds for this checkpoint); "
                "using the robust online-softmax kernel instead",
                stacklevel=2,
            )
        return ok

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _gen(self, batch, generator, n_ensemble: int, n_steps: int, method: str, fast: bool = False, x0=None):
        """Ensemble trajectories at the stored grid positions:
        (E, len(store_set), B, N, 1).  Fixed-step and multistep methods keep
        only those states; an adaptive one returns its whole trajectory, cut
        down here."""
        model = self.model_fast if fast else self.model
        store = self.store_set if (method in FIXED_STEP_METHODS or method in MULTISTEP_METHODS) else None
        out = generate_ensemble(
            model, batch, n_ensemble=n_ensemble, n_steps=n_steps, method=method,
            ret_seq=True, store_indices=store, generator=generator, x0=x0,
        )
        return out if store is not None else out[:, self.store_set]

    # ------------------------------------------------------------------
    def run_pred(self, inf_dict: dict, noise: Optional[Callable] = None) -> str:
        """Read ``truth_path``, predict every event (``predict``) and write the
        three trees to ``pred_path``."""
        ds = SupResEvents(
            inf_dict["truth_path"], self.config_mv, make_low=True, make_particles=True,
            entry_start=int(inf_dict.get("entry_start", 0)),
            reduce_ds=int(inf_dict["n_events"]) if inf_dict.get("n_events") else -1,
            one_event_train=self.config_t.get("one_event_train", False),
            one_event_idx=self.config_t.get("one_event_idx", 0),
        )
        trees = self.predict(ds, inf_dict, noise=noise)
        pred_path = inf_dict["pred_path"]
        os.makedirs(os.path.dirname(os.path.abspath(pred_path)), exist_ok=True)
        root_io.write_trees(pred_path, trees)
        return pred_path

    def predict(self, ds: SupResEvents, inf_dict: dict, noise: Optional[Callable] = None) -> Dict[str, dict]:
        """Ensemble predictions of every event of ``ds`` (with low-resolution
        cells and particles) as the three output trees, rows in event-index
        order.  ``inf_dict``: ``n_ensemble``, ``ode_method``, ``seed``,
        ``batch_size``, ``tail_shrink``, ``packed``/``pack_s``/``pack_rows``
        (default: the model config's), ``save_ensemble_components``,
        ``store_energy_incidence``, ``max_particles``."""
        mcfg = self.inf_cfg["model"]
        n_ensemble = int(inf_dict.get("n_ensemble", 1))
        method = inf_dict.get("ode_method", self.config_t.get("val_ode_method", "dopri5"))
        store_comp = bool(inf_dict.get("save_ensemble_components", False)
                          or inf_dict.get("store_ensemble_components", False))
        fill_kw = dict(n_ensemble=n_ensemble, store_comp=store_comp,
                       store_inc=bool(inf_dict.get("store_energy_incidence", False)),
                       max_particles=int(inf_dict.get("max_particles", 0)))
        low_z, high_z, part_z = self._empty_trees(**fill_kw)
        generator = None
        if noise is None:
            generator = torch.Generator(device=self.device).manual_seed(int(inf_dict.get("seed", 0)))
        positions: List[int] = []  # event index of each filled row

        def sample(batch, bi):
            if self.fast_softmax and not self._nomax_validated:
                self.fast_softmax = self._validate_nomax(batch)
                self._nomax_validated = True
            x0 = None
            if noise is not None:
                x0 = torch.as_tensor(noise(bi, (n_ensemble, *batch["e_proxy"].shape)), dtype=torch.float32,
                                     device=self.device)
            traj = self._gen(batch, generator, n_ensemble=n_ensemble, n_steps=self.n_steps, method=method,
                             fast=self.fast_softmax, x0=x0)
            return traj.float().cpu().numpy()  # (E, T, B, N, 1)

        counts = np.asarray(ds.cell_count_high, np.int64)
        bucketed = np.arange(len(ds))
        # segment-packed rows (`packed: true`): one shape for the whole run,
        # 128-cell alignment padding, the packed attention kernels
        if bool(inf_dict.get("packed", mcfg.get("packed", False))):
            pack_s = int(inf_dict.get("pack_s", mcfg.get("pack_s", 5120)))
            pack_rows = int(inf_dict.get("pack_rows", mcfg.get("pack_rows", 8)))
            fits = np.array([aligned_len(int(n)) <= pack_s for n in counts], bool)
            bucketed, sub = np.nonzero(~fits)[0], np.nonzero(fits)[0]
            if bucketed.size:
                print(f"[packed] {bucketed.size} event(s) exceed pack_s={pack_s} after alignment; "
                      "routing them through the bucketed path", file=sys.stderr)
            for bi, lay in enumerate(pack_events(counts[sub], S=pack_s, rows_per_batch=pack_rows)):
                # layout index -> event, fetched once for collate and unpack
                events = {i: ds.get_event(int(sub[i])) for row in lay.rows for i, _, _ in row}
                batch = batch_to_device(collate_packed(events, lay, S=pack_s), self.device, PACKED_BATCH_KEYS)
                traj = sample(batch, bi)
                for row_i, row in enumerate(lay.rows):
                    for ev_idx, off, n in sorted(row, key=lambda r: r[1]):
                        ev = events[ev_idx]
                        self._fill_event(ev, traj[:, :, row_i, off: off + n, 0], low_z, high_z, part_z, **fill_kw)
                        positions.append(ev.idx)

        if bucketed.size:
            batcher = BucketBatcher(
                counts[bucketed], quantum=int(self.config_t.get("bucket_quantum", 128)),
                max_batch_size=int(inf_dict.get("batch_size", 32)), shuffle=False,
                tail_shrink=inf_dict.get("tail_shrink", "exact"),
            )
            # the batch index restarts at 0 here, as in the JAX package
            for bi, (idxs, bucket) in enumerate(batcher):
                events = [ds.get_event(int(bucketed[i])) if i >= 0 else None for i in idxs]
                batch = batch_to_device(collate(events, bucket.pad_n), self.device, MODEL_BATCH_KEYS)
                traj = sample(batch, bi)
                for slot, ev in enumerate(events):
                    if ev is not None:
                        self._fill_event(ev, traj[:, :, slot, :, 0], low_z, high_z, part_z, **fill_kw)
                        positions.append(ev.idx)

        order = np.argsort(np.asarray(positions, np.int64), kind="stable")
        return {name: {k: JaggedArray.from_list([v[i] for i in order]) for k, v in zd.items()}
                for name, zd in (("Low_Tree", low_z), ("High_Tree", high_z), ("Particle_Tree", part_z))}

    def _empty_trees(self, *, n_ensemble, store_comp, store_inc, max_particles):
        """The branch lists of the three output trees (the reference's schema)."""
        low_z: Dict[str, list] = {k: [] for k in ["eta_raw", "phi", "layer", "e_meas_raw"]}
        high_z: Dict[str, list] = {
            k: [] for k in ["eta_raw", "phi", "layer", "e_proxy", "e_truth_raw", "e_proxy_raw", "e_pred_raw",
                            "e_pred_avg_raw", "raw_nn_cond", "raw_nn_target", "raw_nn_pred"]
        }
        for t in self.ts_to_store:
            for stem in ("e_pred_raw", "e_pred_avg_raw", "raw_nn_pred"):
                high_z[f"{stem}_{t:.2f}"] = []
        if n_ensemble > 1 and store_comp:
            for ci in range(n_ensemble):
                high_z[f"e_pred_raw_comp_{ci}"] = []
                high_z[f"raw_nn_pred_comp_{ci}"] = []
                for t in self.ts_to_store:
                    high_z[f"e_pred_raw_{t:.2f}_comp_{ci}"] = []
                    high_z[f"raw_nn_pred_{t:.2f}_comp_{ci}"] = []
        part_z: Dict[str, list] = {
            k: [] for k in ["particle_pt", "particle_eta", "particle_phi", "particle_e", "particle_pdgid",
                            "particle_dep_e"]
        }
        if store_inc:
            for pi in range(max_particles):
                low_z[f"e_part_{pi}"] = []
                high_z[f"e_part_{pi}"] = []
        return low_z, high_z, part_z

    # ------------------------------------------------------------------
    def _fill_event(self, ev, traj, low_z, high_z, part_z, *, n_ensemble, store_comp, store_inc, max_particles):
        """traj: (E, T, N_pad) numpy ensemble trajectories for one event."""
        n_high = len(ev.high["eta_raw"])
        n_low = len(ev.low["eta_raw"])
        tt = self.target_transform
        proxy_raw = ev.high["e_proxy_raw"]

        low_z["eta_raw"].append(ev.low["eta_raw"])
        low_z["phi"].append(ev.low["phi"])
        low_z["layer"].append(ev.low["layer"].astype(np.float32))
        low_z["e_meas_raw"].append(ev.low["e_meas_raw"] * 1e3)

        high_z["eta_raw"].append(ev.high["eta_raw"])
        high_z["phi"].append(ev.high["phi"])
        high_z["layer"].append(ev.high["layer"].astype(np.float32))
        high_z["e_truth_raw"].append(ev.high["e_truth_raw"] * 1e3)
        high_z["e_proxy"].append(ev.high["e_proxy"])
        high_z["e_proxy_raw"].append(proxy_raw * 1e3)
        high_z["raw_nn_cond"].append(ev.high["e_proxy"])
        high_z["raw_nn_target"].append(ev.high["target"])

        comp_final = traj[:, self.store_pos[self.n_steps - 1], :n_high]  # (E, N)
        avg_final = comp_final.mean(axis=0)
        high_z["raw_nn_pred"].append(avg_final)

        # avg-then-unscale
        high_z["e_pred_avg_raw"].append(np.asarray(tt.inverse(avg_final, proxy_raw)) * 1e3)
        # unscale-then-avg
        comp_raw_final = np.stack([np.asarray(tt.inverse(c, proxy_raw)) for c in comp_final])
        high_z["e_pred_raw"].append(comp_raw_final.mean(axis=0) * 1e3)

        for t, ts_i in zip(self.ts_to_store, self.ts_to_store_idx):
            comp_t = traj[:, self.store_pos[ts_i], :n_high]
            avg_t = comp_t.mean(axis=0)
            high_z[f"raw_nn_pred_{t:.2f}"].append(avg_t)
            high_z[f"e_pred_avg_raw_{t:.2f}"].append(np.asarray(tt.inverse(avg_t, proxy_raw)) * 1e3)
            comp_raw_t = np.stack([np.asarray(tt.inverse(c, proxy_raw)) for c in comp_t])
            high_z[f"e_pred_raw_{t:.2f}"].append(comp_raw_t.mean(axis=0) * 1e3)
            if n_ensemble > 1 and store_comp:
                for ci in range(n_ensemble):
                    high_z[f"e_pred_raw_{t:.2f}_comp_{ci}"].append(comp_raw_t[ci] * 1e3)
                    high_z[f"raw_nn_pred_{t:.2f}_comp_{ci}"].append(comp_t[ci])
        if n_ensemble > 1 and store_comp:
            for ci in range(n_ensemble):
                high_z[f"e_pred_raw_comp_{ci}"].append(comp_raw_final[ci] * 1e3)
                high_z[f"raw_nn_pred_comp_{ci}"].append(comp_final[ci])

        part_z["particle_pt"].append(ev.particles["pt"])
        part_z["particle_eta"].append(ev.particles["eta"])
        part_z["particle_phi"].append(ev.particles["phi"])
        part_z["particle_e"].append(ev.particles["e"])
        part_z["particle_pdgid"].append(ev.particles["pdgid"].astype(np.float32))
        part_z["particle_dep_e"].append(ev.particles["dep_e"])

        if store_inc:
            n_part = ev.high_e_part.shape[1]
            for pi in range(max_particles):
                if pi < n_part:
                    low_z[f"e_part_{pi}"].append(ev.low_e_part[:, pi])
                    high_z[f"e_part_{pi}"].append(ev.high_e_part[:, pi])
                else:
                    low_z[f"e_part_{pi}"].append(np.zeros(n_low, np.float32))
                    high_z[f"e_part_{pi}"].append(np.zeros(n_high, np.float32))

    # ------------------------------------------------------------------
    def get_output_path(self, inf_dict: dict) -> str:
        # beside the saved config pair, or under the working directory when
        # the configs were passed as loaded mappings
        outputdir = os.path.join(os.path.dirname(self.inf_cfg["model"].get("config_path_mv") or ""), "inference")
        if inf_dict.get("dir_flag"):
            outputdir = os.path.join(outputdir, inf_dict["dir_flag"])
        Path(outputdir).mkdir(parents=True, exist_ok=True)
        stem = os.path.basename(inf_dict["truth_path"]).rsplit(".", 1)[0]
        ext = ".h5" if str(inf_dict["truth_path"]).endswith((".h5", ".hdf5")) else ".root"
        return os.path.join(outputdir, f"{stem}_pred{ext}")
