"""Stage-2 (particle-flow) event pipeline.

Counterpart of the JAX package's ``data/pf_dataset.py``: reads the chunked
stage-1 inference outputs (sorted by their entry-start index), the cells from
``Low_Tree``/``e_meas_raw`` or ``High_Tree``/``e_pred_raw`` per the resolution,
with the strict per-cell MeV energy cut ``e > energy_threshold``, the
particles, optionally the per-particle incidence columns ``e_part_i`` and
optionally without single-particle events; per event the pt/e/eta transforms,
the pdgid -> class map {+-11: 1, 22: 0} and the row-normalised incidence
matrix.  ``collate_pf`` pads cells to a bucket length and particles to
``max_particles``.

``PflowEvents.from_trees`` builds the same events from trees in memory (the
output of the port's ``SRInference.predict``), so that the two stages chain
without a file in between.
"""

from __future__ import annotations

from glob import glob
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..transforms import build_var_transforms
from . import root_io

PDGID_TO_CLASS = {-11: 1, 11: 1, 22: 0}
PARTICLE_BRANCHES = (("pt", "particle_pt"), ("e", "particle_e"), ("eta", "particle_eta"), ("phi", "particle_phi"),
                     ("pdgid", "particle_pdgid"), ("dep_e", "particle_dep_e"))


def sorted_chunk_files(glob_arg: str) -> List[str]:
    files = glob(glob_arg)
    try:
        files.sort(key=lambda x: int(x.split("_")[-2]))
    except (ValueError, IndexError):
        files.sort()
    return files


def _cell_tree_names(res: str):
    return ("High_Tree", "e_pred_raw") if res == "high" else ("Low_Tree", "e_meas_raw")


class PflowEvents:
    def __init__(
        self,
        glob_arg: Optional[str],
        config_mv: dict,
        reduce_ds: int = -1,
        energy_threshold: float = 0.0,
        res: str = "low",
        drop_single_part_events: bool = False,
        load_incidence: bool = False,
    ):
        self._setup(config_mv, load_incidence)
        if glob_arg is None:
            return
        tree_name, e_branch = _cell_tree_names(res)
        branches = [e_branch, "eta_raw", "phi", "layer"]
        if load_incidence:
            branches += [f"e_part_{i}" for i in range(self.max_part)]
        for path in sorted_chunk_files(glob_arg):
            tree = root_io.read_tree(path, tree_name, branches)
            ptree = root_io.read_tree(path, "Particle_Tree", [b for _, b in PARTICLE_BRANCHES])
            if not self._ingest(tree, ptree, e_branch, reduce_ds, energy_threshold):
                break
        self._finish(drop_single_part_events)

    @classmethod
    def from_trees(cls, trees: Mapping[str, Mapping], config_mv: dict, reduce_ds: int = -1,
                   energy_threshold: float = 0.0, res: str = "low", drop_single_part_events: bool = False,
                   load_incidence: bool = False) -> "PflowEvents":
        """In-memory constructor: ``trees`` maps tree names to branches of
        per-event arrays, as ``SRInference.predict`` returns them (the
        ``store_energy_incidence`` branches ``e_part_i`` for the incidence)."""
        self = cls(None, config_mv, load_incidence=load_incidence)
        tree_name, e_branch = _cell_tree_names(res)
        self._ingest(trees[tree_name], trees["Particle_Tree"], e_branch, reduce_ds, energy_threshold)
        self._finish(drop_single_part_events)
        return self

    def _setup(self, config_mv, load_incidence):
        self.config_mv = config_mv
        self.max_part = int(config_mv["pf_model"]["max_particles"])
        self.load_incidence = load_incidence
        self.transforms = build_var_transforms(config_mv["var_transform"])
        self.cells: Dict[str, list] = {k: [] for k in ["e", "eta", "phi", "layer"]}
        self.incidence: List[np.ndarray] = []
        self.parts: Dict[str, list] = {k: [] for k, _ in PARTICLE_BRANCHES}
        self.n_events = 0

    def _ingest(self, tree, ptree, e_branch, reduce_ds, energy_threshold) -> bool:
        """Append the events of one cell tree and its particle tree; False
        once ``reduce_ds`` events are in."""
        for i in range(len(tree["layer"])):
            if reduce_ds != -1 and self.n_events >= reduce_ds:
                return False
            e = np.asarray(tree[e_branch][i], np.float32)
            keep = e > energy_threshold  # MeV cut
            self.cells["e"].append(e[keep])
            self.cells["eta"].append(np.asarray(tree["eta_raw"][i], np.float32)[keep])
            self.cells["phi"].append(np.asarray(tree["phi"][i], np.float32)[keep])
            self.cells["layer"].append(np.asarray(tree["layer"][i], np.int32)[keep])
            if self.load_incidence:
                self.incidence.append(np.stack(
                    [np.asarray(tree[f"e_part_{p}"][i], np.float32)[keep] for p in range(self.max_part)], axis=1))
            for k, b in PARTICLE_BRANCHES:
                self.parts[k].append(np.asarray(ptree[b][i]))
            self.n_events += 1
        return not (reduce_ds != -1 and self.n_events >= reduce_ds)

    def _finish(self, drop_single_part_events):
        if drop_single_part_events:
            keep_idx = [i for i in range(self.n_events) if len(self.parts["e"][i]) > 1]
            self.cells = {k: [v[i] for i in keep_idx] for k, v in self.cells.items()}
            self.parts = {k: [v[i] for i in keep_idx] for k, v in self.parts.items()}
            if self.load_incidence:
                self.incidence = [self.incidence[i] for i in keep_idx]
            self.n_events = len(keep_idx)
        self.cell_count = [len(x) for x in self.cells["e"]]

    def __len__(self):
        return self.n_events

    def get_event(self, idx: int) -> dict:
        tr = self.transforms
        c_e_raw = self.cells["e"][idx]
        c_eta_raw = self.cells["eta"][idx]
        c_phi = self.cells["phi"][idx]
        pdgid = self.parts["pdgid"][idx].astype(np.int64)
        ev = {
            "cell_e_raw": c_e_raw,
            "cell_eta_raw": c_eta_raw,
            "cell_phi": c_phi,
            "cell_cosphi": np.cos(c_phi),
            "cell_sinphi": np.sin(c_phi),
            "cell_layer": self.cells["layer"][idx],
            "cell_e": np.asarray(tr["e"].forward(c_e_raw), np.float32),
            "cell_eta": np.asarray(tr["eta"].forward(c_eta_raw), np.float32),
            "part_pt_raw": self.parts["pt"][idx].astype(np.float32),
            "part_e_raw": self.parts["e"][idx].astype(np.float32),
            "part_eta_raw": self.parts["eta"][idx].astype(np.float32),
            "part_dep_e_raw": self.parts["dep_e"][idx].astype(np.float32),
            "part_phi": self.parts["phi"][idx].astype(np.float32),
            "part_class": np.array([PDGID_TO_CLASS[int(x)] for x in pdgid], np.int32),
        }
        ev["part_pt"] = np.asarray(tr["pt"].forward(ev["part_pt_raw"]), np.float32)
        ev["part_e"] = np.asarray(tr["e"].forward(ev["part_e_raw"]), np.float32)
        ev["part_eta"] = np.asarray(tr["eta"].forward(ev["part_eta_raw"]), np.float32)
        ev["part_dep_e"] = np.asarray(tr["e"].forward(ev["part_dep_e_raw"]), np.float32)
        ev["n_particles"] = len(ev["part_e_raw"])
        if self.load_incidence:
            energy = self.incidence[idx]  # (n_cells, max_part)
            row_sum = energy.sum(axis=1, keepdims=True)
            row_sum[row_sum == 0] = 1.0
            ev["incidence_matrix"] = energy / row_sum
        return ev


CELL_F32 = ["cell_e", "cell_eta", "cell_phi", "cell_cosphi", "cell_sinphi", "cell_e_raw", "cell_eta_raw"]
PART_F32 = ["part_pt", "part_e", "part_eta", "part_phi", "part_dep_e", "part_pt_raw", "part_e_raw", "part_eta_raw",
            "part_dep_e_raw"]


def collate_pf(events: Sequence[Optional[dict]], pad_n: int, max_part: int,
               with_incidence: Optional[bool] = None) -> Dict[str, np.ndarray]:
    """Pad ``events`` (None = a filler slot) to ``pad_n`` cells and
    ``max_part`` particles: the batch dict of numpy arrays (``idx`` -1).
    ``incidence_matrix`` is made where ``with_incidence`` says, by default
    where any event has one."""
    B = len(events)
    out: Dict[str, np.ndarray] = {}
    for k in CELL_F32:
        out[k] = np.zeros((B, pad_n), np.float32)
    out["cell_layer"] = np.zeros((B, pad_n), np.int32)
    out["cell_mask"] = np.zeros((B, pad_n), bool)
    for k in PART_F32:
        out[k] = np.zeros((B, max_part), np.float32)
    out["part_class"] = np.zeros((B, max_part), np.int32)
    out["part_mask"] = np.zeros((B, max_part), bool)
    out["cardinality"] = np.zeros((B,), np.int32)
    out["idx"] = np.full((B,), -1, np.int64)

    has_inc = with_incidence
    if has_inc is None:
        has_inc = any(ev is not None and "incidence_matrix" in ev for ev in events)
    if has_inc:
        out["incidence_matrix"] = np.zeros((B, pad_n, max_part), np.float32)

    for i, ev in enumerate(events):
        if ev is None:
            continue
        n = len(ev["cell_e"])
        if n > pad_n:
            raise ValueError(f"event has {n} cells > pad_n {pad_n}")
        for k in CELL_F32:
            out[k][i, :n] = ev[k]
        out["cell_layer"][i, :n] = ev["cell_layer"]
        out["cell_mask"][i, :n] = True
        np_ = min(ev["n_particles"], max_part)
        for k in PART_F32:
            out[k][i, :np_] = ev[k][:np_]
        out["part_class"][i, :np_] = ev["part_class"][:np_]
        out["part_mask"][i, :np_] = True
        out["cardinality"][i] = np_
        if has_inc and "incidence_matrix" in ev:
            out["incidence_matrix"][i, :n, :] = ev["incidence_matrix"][:, :max_part]
    return out
