"""Stage-2 inference runner: particle predictions -> ``Particle_Tree``.

Counterpart of the JAX package's ``inference/pf.py``: the PF model with the
predicted cardinality gating the particle slots, per bucketed batch a forward
pass, the argmax cardinality and the Hungarian alignment of the predictions
to the truth order (the set loss computed for its assignment only), all on
the device; then the reference's branch schema: truth and Hungarian-matched
predicted kinematics in raw space over the truth particles, truth and
predicted cardinality, the event index and, with ``store_inc_wt``, the
per-particle incidence weights over the valid cells.

Differences a caller sees:
  * ``device`` is explicit and defaults to ``cuda``; asking for ``cuda`` on a
    machine without one raises.  Only ``device="cpu"`` runs on the CPU.
  * ``model.config_mv`` / ``model.config_t`` may be loaded mappings in place
    of ``model.config_path_mv`` / ``model.config_path_t``.
  * ``params`` is a reference-layout ``state_dict`` (tools/convert.py); by
    default it is read from ``model.checkpoint_path``, a checkpoint of the
    port's PF trainer or a Flax ``.msgpack`` blob such as
    ``saved_checkpoints/closure_pf/params.msgpack``
    (train/checkpoint.py::load_reference_params).
  * random slots (``init_particles.type: random``) take their noise from an
    injected callable ``noise(batch_index, shape)``, the counterpart of the
    JAX package's ``fold_in(PRNGKey(0), batch_index)``, or else from a
    ``torch.Generator`` seeded from ``inf_dict["seed"]``.
  * ``predict`` is ``run_pred`` without the file IO: it takes a
    ``PflowEvents`` and returns ``{"Particle_Tree": ...}``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data import root_io
from ..data.bucketing import BucketBatcher
from ..data.jagged import JaggedArray
from ..data.pf_dataset import PflowEvents, collate_pf
from ..losses.set2set import set_to_set_incidence_loss, set_to_set_kinematics_loss
from ..models.pf.model_pf import SAPF
from ..train.checkpoint import load_reference_params
from ..transforms import build_var_transforms
from .sr import _config, resolve_device

KIN_BRANCHES = ("truth_pt_raw", "truth_eta_raw", "truth_phi", "truth_e_raw", "truth_dep_e_raw",
                "pred_pt_raw", "pred_eta_raw", "pred_phi", "pred_e_raw")


def pf_batch_to_device(host_batch: dict, device) -> dict:
    """The arrays of a ``collate_pf`` batch (``idx`` aside) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host_batch.items()
            if isinstance(v, np.ndarray) and k != "idx"}


class PFInference:
    def __init__(self, inf_cfg: dict, params=None, device="cuda"):
        self.inf_cfg = inf_cfg
        self.device = resolve_device(device)
        # cell_init_0 and every plain fp32 product run in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mcfg = inf_cfg["model"]
        self.config_mv = _config(mcfg, "mv")
        self.config_t = _config(mcfg, "t")
        pf_cfg = self.config_mv["pf_model"]
        self.max_part = int(pf_cfg["max_particles"])
        self.transforms = build_var_transforms(self.config_mv["var_transform"])
        # fused DiT prologue in the encoder (the JAX package's default); at the
        # published width it is the unfused equivalent (fused_qkv_ok fails)
        self.model = SAPF(pf_cfg, transforms=self.transforms, inference=True,
                          fused_prologue=bool(mcfg.get("fused_prologue", True)))
        if params is None:
            params = load_reference_params(mcfg["checkpoint_path"], pf_cfg, "pf")
        self.model.load_reference_state_dict(params)
        self.model.to(self.device).eval().requires_grad_(False)
        self.loss_on_inc = bool(self.config_t.get("loss_on_inc_wts", False))

    @torch.no_grad()
    def forward(self, batch: dict, noise=None, generator=None):
        """One device batch: (predicted cardinality (B,), kinematics matched to
        the truth order (B, P, 4), incidence weights in the same order
        (B, P, N) or None)."""
        logits, kin_pred, inc_weights = self.model(batch, noise=noise, generator=generator)
        n_pred = torch.argmax(logits, dim=-1)
        if self.loss_on_inc:
            _, _, assign = set_to_set_incidence_loss(inc_weights, batch, kin_pred)
        else:
            _, _, assign = set_to_set_kinematics_loss(kin_pred, batch, self.config_t)
        rows = torch.arange(kin_pred.shape[0], device=kin_pred.device)[:, None]
        return n_pred, kin_pred[rows, assign], (inc_weights[rows, assign] if inc_weights is not None else None)

    def dataset(self, glob_arg: str, reduce_ds: int = -1) -> PflowEvents:
        """The ``PflowEvents`` of the configured resolution and energy cut."""
        return PflowEvents(glob_arg, config_mv=self.config_mv,
                           energy_threshold=float(self.config_t.get("energy_threshold", 0.0)), reduce_ds=reduce_ds,
                           res=self.config_t.get("resolution", "low"), load_incidence=self.loss_on_inc)

    def run_pred(self, inf_dict: dict, noise: Optional[Callable] = None) -> str:
        """Read ``glob_arg``, predict every event and write ``pred_path``."""
        ds = self.dataset(inf_dict["glob_arg"], reduce_ds=int(inf_dict.get("reduce_ds", -1)))
        trees = self.predict(ds, inf_dict, noise=noise)
        pred_path = inf_dict["pred_path"]
        os.makedirs(os.path.dirname(os.path.abspath(pred_path)), exist_ok=True)
        root_io.write_trees(pred_path, trees)
        return pred_path

    def predict(self, ds: PflowEvents, inf_dict: dict, noise: Optional[Callable] = None) -> Dict[str, dict]:
        """Predictions of every event of ``ds`` as ``{"Particle_Tree": ...}``,
        rows in event-index order.  ``inf_dict``: ``store_inc_wt``,
        ``seed`` (random slots without ``noise``)."""
        store_inc = bool(inf_dict.get("store_inc_wt", False))
        tr = self.transforms
        out: Dict[str, list] = {k: [] for k in KIN_BRANCHES}
        card_truth, card_pred, card_idx = [], [], []
        cell_out: Dict[str, list] = {f"pred_inc_wt_{pi}": [] for pi in range(self.max_part)} if store_inc else {}
        generator = None
        if noise is None:
            generator = torch.Generator(device=self.device).manual_seed(int(inf_dict.get("seed", 0)))
        h_dim = int(self.config_mv["pf_model"]["h_dim"])

        batcher = BucketBatcher(ds.cell_count, quantum=int(self.config_t.get("bucket_quantum", 128)),
                                max_batch_size=int(self.inf_cfg.get("batch_size", 32)), shuffle=False)
        results = {}
        for bi, (idxs, bucket) in enumerate(batcher):
            events = [ds.get_event(i) if i >= 0 else None for i in idxs]
            hb = collate_pf(events, bucket.pad_n, self.max_part)
            x = None
            if noise is not None:
                x = torch.as_tensor(np.asarray(noise(bi, (len(idxs), self.max_part, h_dim))), dtype=torch.float32,
                                    device=self.device)
            n_pred, kin_m, inc_m = self.forward(pf_batch_to_device(hb, self.device), noise=x, generator=generator)
            n_pred, kin_m = n_pred.cpu().numpy(), kin_m.float().cpu().numpy()
            inc_m = inc_m.float().cpu().numpy() if inc_m is not None else None
            for slot, (i, ev) in enumerate(zip(idxs, events)):
                if ev is not None:
                    results[int(i)] = (ev, int(n_pred[slot]), kin_m[slot], None if inc_m is None else inc_m[slot],
                                       hb["cell_mask"][slot])

        for i in sorted(results):
            ev, n_pred_i, kin_i, inc_i, cmask = results[i]
            n_true = min(ev["n_particles"], self.max_part)
            card_truth.append(n_true)
            card_pred.append(n_pred_i)
            card_idx.append(i)
            out["truth_pt_raw"].append(ev["part_pt_raw"][:n_true])
            out["truth_eta_raw"].append(ev["part_eta_raw"][:n_true])
            out["truth_phi"].append(ev["part_phi"][:n_true])
            out["truth_e_raw"].append(ev["part_e_raw"][:n_true])
            out["truth_dep_e_raw"].append(ev["part_dep_e_raw"][:n_true])
            out["pred_pt_raw"].append(np.asarray(tr["pt"].inverse(kin_i[:n_true, 0]), np.float32))
            out["pred_eta_raw"].append(np.asarray(tr["eta"].inverse(kin_i[:n_true, 1]), np.float32))
            out["pred_phi"].append(kin_i[:n_true, 2].astype(np.float32))
            out["pred_e_raw"].append(np.asarray(tr["e"].inverse(kin_i[:n_true, 3]), np.float32))
            if store_inc and inc_i is not None:
                for pi in range(self.max_part):
                    cell_out[f"pred_inc_wt_{pi}"].append(inc_i[pi, np.asarray(cmask)].astype(np.float32))

        tree = {k: JaggedArray.from_list(v) for k, v in out.items()}
        tree["truth_card"] = np.asarray(card_truth, np.int32)
        tree["pred_card"] = np.asarray(card_pred, np.int32)
        tree["idx"] = np.asarray(card_idx, np.int64)
        for k, v in cell_out.items():
            tree[k] = JaggedArray.from_list(v)
        return {"Particle_Tree": tree}
