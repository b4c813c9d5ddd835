"""Stage-1 (super-resolution) event pipeline.

Capability mirror of the reference ``SupResDataset`` / ``collate_graphs`` /
``collate_graphs_plus`` (dataset.py:13-410) with identical preprocessing
semantics, on the host in numpy (PyTorch port: same arrays bit for bit):

  * whole-file load into jagged numpy buffers (the reference also loads the
    whole uproot file into RAM, dataset.py:51-57);
  * per-event math is vectorised numpy on the host — HR reorder via
    ``high_cell_to_low_cell_edge`` (dataset.py:92,120-127), MeV->GeV (:75-76),
    per-event conditional energy scaling fitted on the LR cells (:199-212),
    proxy energy by ``repeat_interleave(res_factor^2)`` (:222-226),
    logit-ratio target (:232-233), electron x2 incidence correction
    (:252-256), ECAL layer<3 cut applied last (:278-283);
  * batches are padded to *bucketed static shapes* (see bucketing.py) instead
    of per-batch dynamic max, producing the same key set as the reference
    collate functions (minus python objects: the per-event transform is
    carried as mean/std arrays, not an object).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from ..transforms import TargetTransform, VarTransform, build_var_transforms
from . import root_io

CELL_VARS = ["cell_eta", "cell_phi", "cell_layer", "cell_e", "cell_x", "cell_y", "cell_z"]
PART_VARS = [
    "particle_pt",
    "particle_eta",
    "particle_phi",
    "particle_e",
    "particle_pdgid",
    "particle_dep_energy",
]
N_ECAL_LAYERS = 3


@dataclasses.dataclass
class SupResEvent:
    """One preprocessed event (ECAL cells only, HR reordered)."""

    high: Dict[str, np.ndarray]
    low: Dict[str, np.ndarray]
    particles: Optional[Dict[str, np.ndarray]]
    high_e_part: Optional[np.ndarray]  # (n_high_ecal, n_part)
    low_e_part: Optional[np.ndarray]  # (n_low_ecal, n_part)
    cond_params: Dict[str, float]  # fitted per-event energy-transform stats
    idx: int
    edges: Optional[tuple] = None  # (src, dst) predefined HR adjacency, post-cut indexing


class SupResEvents:
    """Loads a file and preprocesses events on demand."""

    def __init__(
        self,
        filename: str,
        config_mv: dict,
        make_low: bool = False,
        make_particles: bool = False,
        entry_start: int = 0,
        reduce_ds: float = -1,
        one_event_train: bool = False,
        one_event_idx: int = 0,
    ):
        self.config_mv = config_mv
        self.res_factor = int(config_mv["res_factor"])
        self.make_low = make_low
        self.make_particles = make_particles
        self.one_event_train = one_event_train
        self.one_event_idx = one_event_idx

        n_total = root_io.num_entries(filename, "Low_Tree")
        n = n_total - entry_start
        if reduce_ds != -1:
            n = int(n_total * reduce_ds) if reduce_ds < 1 else min(int(reduce_ds), n)
        entry_stop = entry_start + n
        self.n_events = n

        low_branches = CELL_VARS + ["high_cell_to_low_cell_edge"]
        if config_mv.get("graph_building") == "predefined":
            low_branches += ["cell_to_cell_edge_start_high", "cell_to_cell_edge_end_high"]
        if make_particles:
            low_branches += PART_VARS
        self.low_tree = root_io.read_tree(filename, "Low_Tree", low_branches, entry_start, entry_stop)
        high_branches = list(CELL_VARS)
        if config_mv.get("graph_building") == "predefined":
            high_branches += ["cell_to_cell_edge_start_high", "cell_to_cell_edge_end_high"]
        if make_particles:
            high_branches += ["particle_to_node_idx", "particle_to_node_weight"]
        self.high_tree = root_io.read_tree(filename, "High_Tree", high_branches, entry_start, entry_stop)

        self._finish_setup()

    def _finish_setup(self):
        config_mv, n = self.config_mv, self.n_events
        self.var_transforms = build_var_transforms(config_mv["var_transform"])
        self.target_transform = TargetTransform.from_config(config_mv["target_transform"])
        # template for the per-event conditional energy transform (stats refit
        # per event, dataset.py:199-212)
        self.cond_template: VarTransform = self.var_transforms["e"]

        # ECAL cell counts drive bucketing (post layer<3 cut)
        self.cell_count_high = [
            int((self.high_tree["cell_layer"][i] < N_ECAL_LAYERS).sum()) for i in range(n)
        ]
        self.cell_count_low = [
            int((self.low_tree["cell_layer"][i] < N_ECAL_LAYERS).sum()) for i in range(n)
        ]

    @classmethod
    def from_trees(cls, low_tree, high_tree, config_mv, make_low=False, make_particles=False):
        """In-memory constructor: the trees are dicts of per-event arrays
        under the same branch names ``root_io.read_tree`` returns.  The
        online-serving fast path — skips the request's HDF5 round-trip
        (measured ~55-90 ms/event of host overhead, BASELINE.md round-4)."""
        self = cls.__new__(cls)
        self.config_mv = config_mv
        self.res_factor = int(config_mv["res_factor"])
        self.make_low = make_low
        self.make_particles = make_particles
        self.one_event_train = False
        self.one_event_idx = 0
        self.low_tree, self.high_tree = low_tree, high_tree
        self.n_events = len(low_tree["cell_eta"])
        self._finish_setup()
        return self

    def __len__(self):
        return self.n_events

    def get_event(self, idx: int) -> SupResEvent:
        if self.one_event_train:
            idx = self.one_event_idx

        lt, ht = self.low_tree, self.high_tree
        reorder = lt["high_cell_to_low_cell_edge"][idx].astype(np.int64)

        low = {
            "eta_raw": lt["cell_eta"][idx].astype(np.float32),
            "phi": lt["cell_phi"][idx].astype(np.float32),
            "layer": lt["cell_layer"][idx].astype(np.int32),
            "e_meas_raw": (lt["cell_e"][idx] * 1.0e-3).astype(np.float32),  # MeV->GeV
        }
        low["cosphi"] = np.cos(low["phi"])
        low["sinphi"] = np.sin(low["phi"])

        high = {
            "eta_raw": ht["cell_eta"][idx][reorder].astype(np.float32),
            "phi": ht["cell_phi"][idx][reorder].astype(np.float32),
            "layer": ht["cell_layer"][idx][reorder].astype(np.int32),
            "e_truth_raw": (ht["cell_e"][idx][reorder] * 1.0e-3).astype(np.float32),
            "x_raw": ht["cell_x"][idx][reorder].astype(np.float32),
            "y_raw": ht["cell_y"][idx][reorder].astype(np.float32),
            "z_raw": ht["cell_z"][idx][reorder].astype(np.float32),
        }
        high["cosphi"] = np.cos(high["phi"])
        high["sinphi"] = np.sin(high["phi"])

        # static variable transforms
        high["eta"] = np.asarray(self.var_transforms["eta"].forward(high["eta_raw"]), np.float32)
        if self.make_low:
            low["eta"] = np.asarray(self.var_transforms["eta"].forward(low["eta_raw"]), np.float32)

        # per-event conditional energy transform fitted on LR measured cells
        cond = self.cond_template.fit(low["e_meas_raw"])
        cond_params = {
            k: float(getattr(cond, k))
            for k in ("mean", "std", "min", "max")
            if getattr(cond, k) is not None
        }

        high["e_truth"] = np.asarray(cond.forward(high["e_truth_raw"]), np.float32)
        if self.make_low:
            low["e_meas"] = np.asarray(cond.forward(low["e_meas_raw"]), np.float32)

        rf2 = self.res_factor**2
        high["e_proxy_raw"] = np.repeat(low["e_meas_raw"], rf2).astype(np.float32)
        high["e_proxy"] = np.asarray(cond.forward(high["e_proxy_raw"]), np.float32)
        high["target"] = np.asarray(
            self.target_transform.forward(high["e_truth_raw"], high["e_proxy_raw"]), np.float32
        )

        particles = None
        high_e_part = low_e_part = None
        n_high = len(high["eta_raw"])
        n_low = len(low["eta_raw"])
        if self.make_particles:
            particles = {
                "pt": lt["particle_pt"][idx].astype(np.float32),
                "eta": lt["particle_eta"][idx].astype(np.float32),
                "phi": lt["particle_phi"][idx].astype(np.float32),
                "e": lt["particle_e"][idx].astype(np.float32),
                "pdgid": lt["particle_pdgid"][idx].astype(np.int32),
            }
            n_part = len(particles["pt"])
            p2n_idx = ht["particle_to_node_idx"][idx]
            p2n_wt = ht["particle_to_node_weight"][idx]
            dep_e = lt["particle_dep_energy"][idx].astype(np.float32)

            weight = np.zeros((n_high, n_part), np.float32)
            for pi in range(n_part):
                # electrons stored attenuated; reader doubles them (dataset.py:252)
                inv_att = 2.0 if abs(int(particles["pdgid"][pi])) == 11 else 1.0
                ci = np.asarray(p2n_idx[pi], np.int64)
                cw = np.asarray(p2n_wt[pi], np.float32)
                keep = ci < n_high
                weight[ci[keep], pi] = cw[keep] * inv_att
            weight = weight[reorder]
            energy = weight * dep_e[None, :]
            high_e_part = energy
            low_e_part = energy.reshape(n_low, rf2, n_part).sum(axis=1)
            # particle deposited energy over ECAL cells only (dataset.py:275)
            particles["dep_e"] = energy[high["layer"] < N_ECAL_LAYERS].sum(axis=0)

        # predefined HR adjacency (graph_building: predefined,
        # dataset.py:144-147): file edge indices remapped through the reorder
        # so they address the reordered node layout, then through the ECAL cut
        edges = None
        if self.config_mv.get("graph_building") == "predefined" and "cell_to_cell_edge_start_high" in ht:
            inv_reorder = np.argsort(reorder)
            src = inv_reorder[ht["cell_to_cell_edge_start_high"][idx].astype(np.int64)]
            dst = inv_reorder[ht["cell_to_cell_edge_end_high"][idx].astype(np.int64)]

        # ECAL cut last (dataset.py:278-283)
        hm = high["layer"] < N_ECAL_LAYERS
        lm = low["layer"] < N_ECAL_LAYERS
        if self.config_mv.get("graph_building") == "predefined" and "cell_to_cell_edge_start_high" in ht:
            new_index = np.cumsum(hm) - 1  # old idx -> new idx for kept cells
            keep = hm[src] & hm[dst]
            edges = (new_index[src[keep]], new_index[dst[keep]])
        high = {k: v[hm] for k, v in high.items()}
        low = {k: v[lm] for k, v in low.items()}
        if high_e_part is not None:
            high_e_part = high_e_part[hm]
            low_e_part = low_e_part[lm]

        return SupResEvent(high, low, particles, high_e_part, low_e_part, cond_params, idx, edges)


HIGH_KEYS_F32 = [
    "eta",
    "phi",
    "cosphi",
    "sinphi",
    "e_truth",
    "e_proxy",
    "eta_raw",
    "e_truth_raw",
    "e_proxy_raw",
    "target",
]
LOW_KEYS_F32 = ["eta_raw", "phi", "cosphi", "sinphi", "e_meas_raw"]


def collate(
    events: Sequence[Optional[SupResEvent]],
    pad_n: int,
    with_low: bool = False,
    pad_n_low: Optional[int] = None,
    with_edge_mask: bool = False,
) -> Dict[str, np.ndarray]:
    """Pad a list of events (None == filler slot) to a fixed-shape batch.

    Produces the key set of collate_graphs/_plus (dataset.py:294-410) with
    (B,N,1) features and (B,N) q_mask; particle lists stay jagged python
    lists exactly like the reference's ``collate_graphs_plus`` (:393-408).
    """
    B = len(events)
    out: Dict[str, np.ndarray] = {}
    for k in HIGH_KEYS_F32:
        out[k] = np.zeros((B, pad_n, 1), np.float32)
    out["layer"] = np.zeros((B, pad_n, 1), np.int32)
    out["q_mask"] = np.zeros((B, pad_n), bool)
    out["cond_mean"] = np.zeros((B, 1), np.float32)
    out["cond_std"] = np.ones((B, 1), np.float32)
    out["idx"] = np.full((B,), -1, np.int64)

    for i, ev in enumerate(events):
        if ev is None:
            continue
        n = len(ev.high["eta"])
        if n > pad_n:
            raise ValueError(f"event has {n} cells > pad_n {pad_n}")
        for k in HIGH_KEYS_F32:
            out[k][i, :n, 0] = ev.high[k]
        out["layer"][i, :n, 0] = ev.high["layer"]
        out["q_mask"][i, :n] = True
        out["cond_mean"][i, 0] = ev.cond_params.get("mean", 0.0)
        out["cond_std"][i, 0] = ev.cond_params.get("std", 1.0)
        out["idx"][i] = ev.idx

    if with_edge_mask:
        # (B, N, N) adjacency (dataset.py:314,336-337): predefined edges when
        # present, else all-to-all among valid cells; feeds the model's
        # ``attn_valid`` hook (the reference stores but never consumes it,
        # models/flow_model.py:234)
        em = np.zeros((B, pad_n, pad_n), bool)
        for i, ev in enumerate(events):
            if ev is None:
                continue
            if ev.edges is not None:
                em[i, ev.edges[0], ev.edges[1]] = True
            else:
                n = len(ev.high["eta"])
                em[i, :n, :n] = True
        out["edge_mask"] = em

    if with_low:
        pl = pad_n_low if pad_n_low is not None else pad_n
        for k in LOW_KEYS_F32:
            out[f"low_{k}"] = np.zeros((B, pl, 1), np.float32)
        out["low_layer"] = np.zeros((B, pl, 1), np.int32)
        out["low_q_mask"] = np.zeros((B, pl), bool)
        for i, ev in enumerate(events):
            if ev is None:
                continue
            n = len(ev.low["eta_raw"])
            for k in LOW_KEYS_F32:
                out[f"low_{k}"][i, :n, 0] = ev.low[k]
            out["low_layer"][i, :n, 0] = ev.low["layer"]
            out["low_q_mask"][i, :n] = True

        if any(ev is not None and ev.particles is not None for ev in events):
            out["particle_pt"] = [ev.particles["pt"] if ev else np.zeros(0, np.float32) for ev in events]
            out["particle_eta"] = [ev.particles["eta"] if ev else np.zeros(0, np.float32) for ev in events]
            out["particle_phi"] = [ev.particles["phi"] if ev else np.zeros(0, np.float32) for ev in events]
            out["particle_e"] = [ev.particles["e"] if ev else np.zeros(0, np.float32) for ev in events]
            out["particle_pdgid"] = [
                ev.particles["pdgid"] if ev else np.zeros(0, np.int32) for ev in events
            ]
            out["particle_dep_e"] = [
                ev.particles["dep_e"] if ev else np.zeros(0, np.float32) for ev in events
            ]
            out["high_e_part"] = [ev.high_e_part if ev else None for ev in events]
            out["low_e_part"] = [ev.low_e_part if ev else None for ev in events]

    return out


MODEL_BATCH_KEYS = ("eta", "cosphi", "sinphi", "layer", "e_proxy", "q_mask", "target")


def model_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Subset of the collated batch consumed by the jitted model step."""
    return {k: batch[k] for k in MODEL_BATCH_KEYS}
