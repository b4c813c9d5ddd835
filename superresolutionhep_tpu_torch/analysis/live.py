"""Live (in-training) validation plots.

The port's own copy of the JAX package's ``analysis/live.py`` (numpy, and
matplotlib imported inside the plotting function):
  * :func:`event_display_figure` — per-layer panels comparing truth/pred in
    raw MeV and NN space for one event;
  * :class:`PerformanceCOCOALive` — a PerformanceCOCOA that accumulates from
    in-memory validation batches instead of files, reusing the offline
    residual-plot methods.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .performance import PerformanceCOCOA


def event_display_figure(pl_dict: Dict[str, np.ndarray], fig=None):
    """pl_dict keys: eta_raw, phi, layer, target, e_truth_raw, pred,
    e_pred_raw — 1D arrays over one event's valid HR cells."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure(figsize=(16.5, 7.5), dpi=100, tight_layout=True)
    layers = np.asarray(pl_dict["layer"]).astype(int).ravel()
    eta = np.asarray(pl_dict["eta_raw"]).ravel()
    phi = np.asarray(pl_dict["phi"]).ravel()
    panels = [
        ("E truth [MeV]", np.asarray(pl_dict["e_truth_raw"]).ravel()),
        ("E pred [MeV]", np.asarray(pl_dict["e_pred_raw"]).ravel()),
        ("E pred - truth", np.asarray(pl_dict["e_pred_raw"]).ravel() - np.asarray(pl_dict["e_truth_raw"]).ravel()),
        ("NN target", np.asarray(pl_dict["target"]).ravel()),
        ("NN pred", np.asarray(pl_dict["pred"]).ravel()),
    ]
    for L in range(3):
        sel = layers == L
        for c, (name, vals) in enumerate(panels):
            ax = fig.add_subplot(3, len(panels), L * len(panels) + c + 1)
            if sel.sum():
                sc = ax.scatter(eta[sel], phi[sel], c=vals[sel], s=12, marker="s", cmap="viridis")
                fig.colorbar(sc, ax=ax, fraction=0.046)
            ax.set_title(f"L{L} {name}", fontsize=7)
            ax.tick_params(labelsize=6)
    return fig


class PerformanceCOCOALive(PerformanceCOCOA):
    """Accumulates validation batches; exposes the offline plot methods."""

    def __init__(self, res_factor: int, cmap: str = "viridis"):
        # bypass the file-loading constructor (live accumulation instead)
        from .performance import HIGH_GRAN

        self.res_factor = res_factor
        self.high_gran = list(HIGH_GRAN)
        self.low_gran = [g // res_factor for g in HIGH_GRAN]
        self.cmap = cmap
        self.reset()

    def reset(self):
        self.n_events = 0
        self.low_phi: List[np.ndarray] = []
        self.low_layer: List[np.ndarray] = []
        self.low_eta: List[np.ndarray] = []
        self.low_e_measured: List[np.ndarray] = []
        self.high_phi: List[np.ndarray] = []
        self.high_layer: List[np.ndarray] = []
        self.high_eta: List[np.ndarray] = []
        self.high_e_truth: List[np.ndarray] = []
        self.high_e_pred: List[np.ndarray] = []
        self.high_e_pred_raw_comp = {}
        self.high_e_pred_step = {}
        self.high_raw_nn_pred_step = {}

    def update(self, host_batch: Dict[str, np.ndarray], e_pred_raw: np.ndarray):
        """host_batch: the collated numpy batch (with_low=True); e_pred_raw:
        (B, N, 1) raw-GeV predictions for the HR cells."""
        q = np.asarray(host_batch["q_mask"])
        lq = np.asarray(host_batch.get("low_q_mask", q))
        B = q.shape[0]
        for i in range(B):
            if not q[i].any():
                continue  # bucket filler slot
            m, lm = q[i], lq[i]
            self.high_phi.append(host_batch["phi"][i, m, 0])
            self.high_layer.append(host_batch["layer"][i, m, 0])
            self.high_eta.append(host_batch["eta_raw"][i, m, 0])
            self.high_e_truth.append(host_batch["e_truth_raw"][i, m, 0] * 1e3)
            self.high_e_pred.append(np.asarray(e_pred_raw)[i, m, 0] * 1e3)
            if "low_e_meas_raw" in host_batch:
                self.low_phi.append(host_batch["low_phi"][i, lm, 0])
                self.low_layer.append(host_batch["low_layer"][i, lm, 0])
                self.low_eta.append(host_batch["low_eta_raw"][i, lm, 0])
                self.low_e_measured.append(host_batch["low_e_meas_raw"][i, lm, 0] * 1e3)
            else:  # no LR info collated: mirror HR truth so plots still work
                self.low_phi.append(self.high_phi[-1])
                self.low_layer.append(self.high_layer[-1])
                self.low_eta.append(self.high_eta[-1])
                self.low_e_measured.append(self.high_e_truth[-1])
            self.n_events += 1
