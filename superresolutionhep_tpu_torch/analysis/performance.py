"""Offline analysis of SR and PF inference outputs.

The port's own copy of the JAX package's
``analysis/performance.py`` (numpy, and matplotlib imported inside each plot
method): re-reads the inference event files through the port's HDF5 reader
(``data/root_io.py``: LR/HR geometry, truth/pred/proxy energies, NN-space
branches, per-timestep and per-ensemble-component branches), recomputes
ensemble averages, and exposes the residual and event-display plots as
methods; ``PFPerformanceCOCOA`` joins the PF outputs (LR-PF and HR-PF) by the
``idx`` branch with a truth-consistency check and adds the PF event displays,
the truth incidence, the cardinality confusion and the kinematic residuals.

Hard-coded per-layer eta granularities: high = [256,256,128,64,64,32],
low = high / res_factor.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data import root_io
from .util import mean_std_iqr_label, robust_bins

HIGH_GRAN = [256, 256, 128, 64, 64, 32]


def _jag_list(branch) -> List[np.ndarray]:
    if hasattr(branch, "to_list"):
        return branch.to_list()
    return [np.asarray(x) for x in branch]


class PerformanceCOCOA:
    def __init__(self, inference_path, res_factor, cmap="viridis", entry_stop=None, max_comp=-1):
        self.res_factor = res_factor
        if res_factor not in (2, 4):
            raise ValueError("res_factor must be 2 or 4")
        self.high_gran = HIGH_GRAN
        self.low_gran = [g // res_factor for g in HIGH_GRAN]
        self.cmap = cmap

        low = root_io.read_tree(inference_path, "Low_Tree", None, 0, entry_stop)
        high = root_io.read_tree(inference_path, "High_Tree", None, 0, entry_stop)

        self.low_phi = _jag_list(low["phi"])
        self.low_layer = _jag_list(low["layer"])
        self.low_eta = _jag_list(low["eta_raw"])
        self.low_e_measured = _jag_list(low["e_meas_raw"])
        self.n_events = len(self.low_phi)

        self.high_phi = _jag_list(high["phi"])
        self.high_layer = _jag_list(high["layer"])
        self.high_eta = _jag_list(high["eta_raw"])
        self.high_e_truth = _jag_list(high["e_truth_raw"])
        self.high_e_pred_direct = _jag_list(high["e_pred_raw"])
        self.high_e_proxy = _jag_list(high["e_proxy_raw"])
        self.high_raw_nn_cond = _jag_list(high["raw_nn_cond"])
        self.high_raw_nn_target = _jag_list(high["raw_nn_target"])
        self.high_raw_nn_pred = _jag_list(high["raw_nn_pred"])

        self.high_e_pred_step: Dict[str, list] = {}
        self.high_raw_nn_pred_step: Dict[str, list] = {}
        self.high_e_pred_raw_comp: Dict[str, list] = {}
        for br in high:
            if "e_pred_raw_comp" in br:
                self.high_e_pred_raw_comp[br] = _jag_list(high[br])
            elif "e_pred_raw_" in br and "comp" not in br:
                self.high_e_pred_step[br] = _jag_list(high[br])
            elif "raw_nn_pred_" in br and "comp" not in br:
                self.high_raw_nn_pred_step[br] = _jag_list(high[br])

        # ensemble average recomputed from components when present; the
        # file-level average is kept as ``high_e_pred_direct``
        if self.high_e_pred_raw_comp:
            keys = sorted(self.high_e_pred_raw_comp)
            if max_comp > 0:
                keys = keys[:max_comp]
            self.high_e_pred = [
                np.mean([self.high_e_pred_raw_comp[k][i] for k in keys], axis=0)
                for i in range(self.n_events)
            ]
        else:
            self.high_e_pred = self.high_e_pred_direct

    # ------------------------------------------------------------------
    def compute_ensemble_average(self, n: int) -> List[np.ndarray]:
        keys = sorted(self.high_e_pred_raw_comp)[:n]
        return [
            np.mean([self.high_e_pred_raw_comp[k][i] for k in keys], axis=0)
            for i in range(self.n_events)
        ]

    # ------------------------------------------------------------------
    def _layer_sums(self, pred=None):
        """Per-event energy sums per ECAL layer and overall, for LR-measured,
        HR-truth and HR-pred."""
        pred = pred if pred is not None else self.high_e_pred
        out = {k: {L: [] for L in [0, 1, 2, "all"]} for k in ["low_meas", "high_truth", "high_pred"]}
        for i in range(self.n_events):
            for L in range(3):
                out["low_meas"][L].append(self.low_e_measured[i][self.low_layer[i] == L].sum())
                out["high_truth"][L].append(self.high_e_truth[i][self.high_layer[i] == L].sum())
                out["high_pred"][L].append(np.asarray(pred[i])[self.high_layer[i] == L].sum())
            out["low_meas"]["all"].append(self.low_e_measured[i].sum())
            out["high_truth"]["all"].append(self.high_e_truth[i].sum())
            out["high_pred"]["all"].append(np.asarray(pred[i]).sum())
        return {k: {L: np.asarray(v) for L, v in d.items()} for k, d in out.items()}

    def plot_residual_event(self, dir=None, truth_e_range=None, pred=None):
        """Event-sum residual histograms per ECAL layer, absolute and
        relative, LR-meas vs HR-pred against HR truth. Returns (fig, summary_dict)."""
        import matplotlib.pyplot as plt

        sums = self._layer_sums(pred)
        if truth_e_range is not None:
            for L in [0, 1, 2, "all"]:
                m = (sums["high_truth"][L] > truth_e_range[0]) & (
                    sums["high_truth"][L] < truth_e_range[1]
                )
                for k in sums:
                    sums[k][L] = sums[k][L][m]

        fig, axes = plt.subplots(2, 4, figsize=(16, 8), dpi=120)
        summary = {}
        for col, L in enumerate(["all", 0, 1, 2]):
            truth = sums["high_truth"][L]
            meas_res = sums["low_meas"][L] - truth
            pred_res = sums["high_pred"][L] - truth
            title = "All layers" if L == "all" else f"ECAL{L + 1}"

            ax = axes[0, col]
            bins = robust_bins(meas_res, pred_res)
            lbl_m, _ = mean_std_iqr_label(meas_res, 1)
            lbl_p, stats = mean_std_iqr_label(pred_res, 1)
            ax.hist(meas_res, bins=bins, histtype="stepfilled", alpha=0.8, color="cornflowerblue", label=f"LR meas {lbl_m}")
            ax.hist(pred_res, bins=bins, histtype="step", ec="r", label=f"HR pred {lbl_p}")
            ax.set_xlabel(r"$E_X - E_{truth}$ [MeV]")
            ax.set_title(title)
            ax.legend(fontsize=6)
            if L == "all":
                summary["res_event/pred_mean"], summary["res_event/pred_std"], summary["res_event/pred_iqr"] = stats

            ax = axes[1, col]
            with np.errstate(divide="ignore", invalid="ignore"):
                r_m = meas_res / truth
                r_p = pred_res / truth
            r_m, r_p = r_m[np.isfinite(r_m)], r_p[np.isfinite(r_p)]
            bins = robust_bins(r_m, r_p)
            lbl_m, _ = mean_std_iqr_label(r_m)
            lbl_p, stats = mean_std_iqr_label(r_p)
            ax.hist(r_m, bins=bins, histtype="stepfilled", alpha=0.8, color="cornflowerblue", label=f"LR meas {lbl_m}")
            ax.hist(r_p, bins=bins, histtype="step", ec="r", label=f"HR pred {lbl_p}")
            ax.set_xlabel(r"$(E_X - E_{truth}) / E_{truth}$")
            ax.legend(fontsize=6)
            if L == "all":
                summary["res_event/pred_rel_mean"], summary["res_event/pred_rel_std"], summary["res_event/pred_rel_iqr"] = stats
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/residual_event.png")
        return fig, summary

    def plot_residual_cell(self, dir=None, pred=None):
        """Per-cell residuals per ECAL layer."""
        import matplotlib.pyplot as plt

        pred = pred if pred is not None else self.high_e_pred
        fig, axes = plt.subplots(2, 4, figsize=(16, 8), dpi=120)
        for col, L in enumerate(["all", 0, 1, 2]):
            res, rel = [], []
            for i in range(self.n_events):
                sel = slice(None) if L == "all" else (self.high_layer[i] == L)
                t = self.high_e_truth[i][sel]
                p = np.asarray(pred[i])[sel]
                res.append(p - t)
                with np.errstate(divide="ignore", invalid="ignore"):
                    r = (p - t) / t
                rel.append(r[np.isfinite(r)])
            res = np.hstack(res) if res else np.zeros(0)
            rel = np.hstack(rel) if rel else np.zeros(0)
            title = "All layers" if L == "all" else f"ECAL{L + 1}"

            ax = axes[0, col]
            bins = robust_bins(res)
            lbl, _ = mean_std_iqr_label(res, 1)
            ax.hist(res, bins=bins, histtype="stepfilled", color="cornflowerblue", label=lbl)
            ax.set_xlabel(r"$E_{pred} - E_{truth}$ [MeV] (cell)")
            ax.set_title(title)
            ax.legend(fontsize=6)

            ax = axes[1, col]
            bins = robust_bins(rel)
            lbl, _ = mean_std_iqr_label(rel)
            ax.hist(rel, bins=bins, histtype="stepfilled", color="cornflowerblue", label=lbl)
            ax.set_xlabel(r"$(E_{pred} - E_{truth}) / E_{truth}$ (cell)")
            ax.legend(fontsize=6)
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/residual_cell.png")
        return fig

    def plot_residual_cell_for_one_event(self, ev_i: int = 0, dir=None, pred=None):
        """Per-cell residuals of a single event (plot_summaries.py variant)."""
        import matplotlib.pyplot as plt

        pred = pred if pred is not None else self.high_e_pred
        t = self.high_e_truth[ev_i]
        p = np.asarray(pred[ev_i])
        fig, axes = plt.subplots(1, 2, figsize=(9, 4), dpi=110)
        res = p - t
        from .util import mean_std_iqr_label

        lbl, _ = mean_std_iqr_label(res, 1)
        axes[0].hist(res, bins=robust_bins(res), histtype="stepfilled", color="cornflowerblue", label=lbl)
        axes[0].set_xlabel(r"$E_{pred} - E_{truth}$ [MeV]")
        axes[0].legend(fontsize=7)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = res / t
        rel = rel[np.isfinite(rel)]
        lbl, _ = mean_std_iqr_label(rel)
        axes[1].hist(rel, bins=robust_bins(rel), histtype="stepfilled", color="cornflowerblue", label=lbl)
        axes[1].set_xlabel(r"$(E_{pred} - E_{truth}) / E_{truth}$")
        axes[1].legend(fontsize=7)
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/residual_cell_ev{ev_i}.png")
        return fig

    def plot_evolution_raw_nn_dist(self, dir=None, max_events: int = 200):
        """Distribution of the NN-space prediction at each stored ODE time
        across events (plot_event_displays.py NN-space evolution variant)."""
        import matplotlib.pyplot as plt

        step_keys = sorted(self.high_raw_nn_pred_step)
        series = [("cond", self.high_raw_nn_cond), ("target", self.high_raw_nn_target)]
        series += [(k, self.high_raw_nn_pred_step[k]) for k in step_keys]
        series.append(("pred", self.high_raw_nn_pred))
        fig, ax = plt.subplots(figsize=(8, 5), dpi=110)
        for name, rows in series:
            flat = np.hstack([np.asarray(r) for r in rows[:max_events]])
            ax.hist(flat, bins=60, histtype="step", density=True, label=name)
        ax.legend(fontsize=7)
        ax.set_xlabel("NN-space value")
        if dir:
            fig.savefig(f"{dir}/evolution_nn_dist.png")
        return fig

    # ------------------------------------------------------------------
    def _bin_image(self, eta, phi, layer, values, L, high=True):
        """eta-phi 2D histogram for one layer at that layer's granularity;
        also usable as the binning self-check."""
        gran = (self.high_gran if high else self.low_gran)[L]
        eta_edges = np.linspace(-3, 3, gran + 1)
        phi_edges = np.linspace(-np.pi, np.pi, gran + 1)
        sel = layer == L
        img, _, _ = np.histogram2d(
            eta[sel], phi[sel], bins=[eta_edges, phi_edges], weights=values[sel]
        )
        counts, _, _ = np.histogram2d(eta[sel], phi[sel], bins=[eta_edges, phi_edges])
        return img, counts

    def check_binning(self, ev_i: int) -> bool:
        """True iff no eta-phi bin receives more than one cell — i.e. the
        granularity constants match the data (plot_evolution check)."""
        for L in range(3):
            _, counts = self._bin_image(
                self.high_eta[ev_i], self.high_phi[ev_i], self.high_layer[ev_i],
                self.high_e_truth[ev_i], L,
            )
            if counts.max(initial=0) > 1:
                return False
        return True

    def plot_evolution(self, ev_i: int = 0, dir=None, check_binning: bool = False):
        """Event display: LR measured / HR truth / HR pred plus the stored
        ODE-time snapshots, per ECAL layer."""
        import matplotlib.pyplot as plt

        if check_binning and not self.check_binning(ev_i):
            raise AssertionError("granularity constants do not match the data")

        step_keys = sorted(self.high_e_pred_step)
        cols = 3 + len(step_keys)
        fig, axes = plt.subplots(3, cols, figsize=(3 * cols, 9), dpi=100)
        for L in range(3):
            panels = [
                ("LR meas", self.low_eta[ev_i], self.low_phi[ev_i], self.low_layer[ev_i], self.low_e_measured[ev_i], False),
                ("HR truth", self.high_eta[ev_i], self.high_phi[ev_i], self.high_layer[ev_i], self.high_e_truth[ev_i], True),
            ]
            for k in step_keys:
                panels.append((k, self.high_eta[ev_i], self.high_phi[ev_i], self.high_layer[ev_i], np.asarray(self.high_e_pred_step[k][ev_i]), True))
            panels.append(("HR pred", self.high_eta[ev_i], self.high_phi[ev_i], self.high_layer[ev_i], np.asarray(self.high_e_pred[ev_i]), True))
            for c, (name, eta, phi, layer, vals, high) in enumerate(panels):
                img, _ = self._bin_image(eta, phi, layer, vals, L, high)
                ax = axes[L, c]
                nz = np.nonzero(img)
                if nz[0].size:
                    e0, e1 = nz[0].min(), nz[0].max() + 1
                    p0, p1 = nz[1].min(), nz[1].max() + 1
                    ax.imshow(img[e0:e1, p0:p1].T, origin="lower", cmap=self.cmap, aspect="auto")
                ax.set_title(f"L{L} {name}", fontsize=7)
                ax.set_xticks([])
                ax.set_yticks([])
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/evolution_ev{ev_i}.png")
        return fig

    def plot_evolution_raw_nn(self, ev_i: int = 0, dir=None):
        """NN-space evolution panels."""
        import matplotlib.pyplot as plt

        step_keys = sorted(self.high_raw_nn_pred_step)
        series = [("cond", self.high_raw_nn_cond[ev_i]), ("target", self.high_raw_nn_target[ev_i])]
        series += [(k, self.high_raw_nn_pred_step[k][ev_i]) for k in step_keys]
        series.append(("pred", self.high_raw_nn_pred[ev_i]))
        fig, axes = plt.subplots(1, len(series), figsize=(3 * len(series), 3), dpi=100)
        for ax, (name, vals) in zip(np.atleast_1d(axes), series):
            ax.hist(np.asarray(vals), bins=40, histtype="stepfilled", color="cornflowerblue")
            ax.set_title(name, fontsize=8)
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/evolution_nn_ev{ev_i}.png")
        return fig

    # ------------------------------------------------------------------
    def _sum_by_layer(self, rows, layers):
        """Per-event sums for each ECAL layer key (0,1,2,'all')."""
        out = {L: np.empty(self.n_events) for L in [0, 1, 2, "all"]}
        for i in range(self.n_events):
            v = np.asarray(rows[i])
            lay = layers[i]
            for L in range(3):
                out[L][i] = v[lay == L].sum()
            out["all"][i] = v.sum()
        return out

    def plot_residual_event_ens(self, dir=None, truth_e_range=None):
        """Event-sum residuals (absolute and relative) per ECAL layer and
        overall, overlaying every ensemble component (filled, faint) against
        LR-measured, the recomputed ensemble average and the file-level
        direct average."""
        import matplotlib.pyplot as plt

        truth = self._sum_by_layer(self.high_e_truth, self.high_layer)
        meas = self._sum_by_layer(self.low_e_measured, self.low_layer)
        pred = self._sum_by_layer(self.high_e_pred, self.high_layer)
        direct = self._sum_by_layer(self.high_e_pred_direct, self.high_layer)
        comps = {
            k: self._sum_by_layer(v, self.high_layer)
            for k, v in sorted(self.high_e_pred_raw_comp.items())
        }

        fig, axes = plt.subplots(2, 4, figsize=(16, 8), dpi=120)
        for col, L in enumerate(["all", 0, 1, 2]):
            t = truth[L]
            sel = np.ones(t.size, bool)
            if truth_e_range is not None:
                sel = (t > truth_e_range[0]) & (t < truth_e_range[1])
            series = [
                ("LR meas", meas[L][sel] - t[sel], dict(histtype="stepfilled", alpha=0.8, color="cornflowerblue")),
                ("HR pred", pred[L][sel] - t[sel], dict(histtype="step", ec="r")),
                ("HR direct", direct[L][sel] - t[sel], dict(histtype="step", ec="g")),
            ]
            comp_res = [(c[L][sel] - t[sel]) for c in comps.values()]
            title = "All layers" if L == "all" else f"ECAL{L + 1}"
            if truth_e_range is not None:
                title += f" ({truth_e_range[0]:g} < E < {truth_e_range[1]:g})"

            ax = axes[0, col]
            bins = robust_bins(*[s[1] for s in series])
            for r in comp_res:
                ax.hist(r, bins=bins, histtype="stepfilled", alpha=0.25, zorder=5)
            for name, r, style in series:
                lbl, _ = mean_std_iqr_label(r, 1)
                ax.hist(r, bins=bins, label=f"{name} {lbl}", zorder=10, **style)
            ax.set_xlabel(r"$E_X - E_{truth}$ [MeV]")
            ax.set_title(title)
            ax.legend(fontsize=6)
            ax.grid(True)

            ax = axes[1, col]
            with np.errstate(divide="ignore", invalid="ignore"):
                rel_series = [(n, (r / t[sel])[np.isfinite(r / t[sel])], s) for n, r, s in series]
                rel_comps = [(r / t[sel])[np.isfinite(r / t[sel])] for r in comp_res]
            bins = robust_bins(*[s[1] for s in rel_series])
            for r in rel_comps:
                ax.hist(r, bins=bins, histtype="stepfilled", alpha=0.25, zorder=5)
            for name, r, style in rel_series:
                lbl, _ = mean_std_iqr_label(r)
                ax.hist(r, bins=bins, label=f"{name} {lbl}", zorder=10, **style)
            ax.set_xlabel(r"$(E_X - E_{truth}) / E_{truth}$")
            ax.legend(fontsize=6)
            ax.grid(True)
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/residual_event_ensemble.png")
        return fig

    def plot_ensemble_size_comparison(self, ens_avg_dict=None, sizes=(2, 5, 10), dir=None):
        """Residual width vs ensemble size, overall and per ECAL layer.  Accepts a precomputed
        ``{size: [per-event arrays]}`` dict (the reference's call style) or
        computes the averages from the stored components via ``sizes``."""
        import matplotlib.pyplot as plt

        if ens_avg_dict is None:
            usable = [n for n in sizes if n <= len(self.high_e_pred_raw_comp)]
            ens_avg_dict = {n: self.compute_ensemble_average(n) for n in usable}

        truth = self._sum_by_layer(self.high_e_truth, self.high_layer)
        fig, axes = plt.subplots(1, 4, figsize=(18, 4), dpi=120)
        widths_all = {}
        for col, L in enumerate(["all", 0, 1, 2]):
            ns, iqrs, means = [], [], []
            for n, avg in sorted(ens_avg_dict.items()):
                p = self._sum_by_layer(avg, self.high_layer)[L]
                with np.errstate(divide="ignore", invalid="ignore"):
                    r = (p - truth[L]) / truth[L]
                r = r[np.isfinite(r)]
                _, (mean, std, iqr) = mean_std_iqr_label(r)
                ns.append(n)
                iqrs.append(iqr)
                means.append(mean)
            ax = axes[col]
            ax.plot(ns, iqrs, "o-", label="IQR")
            ax.plot(ns, means, "s--", label="mean")
            ax.set_xlabel("ensemble size")
            ax.set_ylabel("event-sum relative residual")
            ax.set_title("All layers" if L == "all" else f"ECAL{L + 1}")
            ax.legend(fontsize=7)
            ax.grid(True)
            if L == "all":
                widths_all = dict(zip(ns, iqrs))
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/ensemble_size.png")
        return fig, widths_all


class PFPerformanceCOCOA(PerformanceCOCOA):
    """Joins the SR inference file with LR-PF and HR-PF outputs by the
    ``idx`` branch: PF rows may come in any order (the reference writes them
    in batch order), so every PF branch is put back in event order by
    ``argsort(idx)`` before the join."""

    PF_COLORS = np.array(
        [(201, 58, 64), (242, 207, 1), (0, 152, 75), (101, 172, 228), (56, 34, 132), (160, 194, 56)]
    ) / 255.0

    def __init__(self, inference_path, lr_pf_path, hr_pf_path, res_factor, cmap="viridis"):
        super().__init__(inference_path, res_factor, cmap)

        def load_pf(path):
            tree = root_io.read_tree(path, "Particle_Tree")
            inc_keys = [k for k in tree if "pred_inc_wt_" in k]
            idx = np.asarray(tree["idx"])
            remap = np.argsort(idx)  # row order -> event order
            out = {"max_part": len(inc_keys)}
            for k in ["truth_pt_raw", "truth_eta_raw", "truth_phi", "truth_e_raw", "truth_dep_e_raw",
                      "pred_pt_raw", "pred_eta_raw", "pred_phi", "pred_e_raw"]:
                rows = _jag_list(tree[k])
                out[k] = [rows[i] for i in remap]
            for k in inc_keys:
                rows = _jag_list(tree[k])
                pi = int(k.split("_")[-1])
                out.setdefault("inc_wt", {})[pi] = [rows[i] for i in remap]
            out["pred_card"] = np.asarray(tree["pred_card"])[remap]
            out["truth_card"] = np.asarray(tree["truth_card"])[remap]
            return out

        lr, hr = load_pf(lr_pf_path), load_pf(hr_pf_path)
        self.max_part = lr["max_part"]

        # truth consistency between the LR-PF and HR-PF files
        for k in ["truth_pt_raw", "truth_eta_raw", "truth_phi", "truth_e_raw", "truth_dep_e_raw"]:
            if not np.allclose(np.hstack(lr[k]), np.hstack(hr[k])):
                raise ValueError(f"LR/HR truth mismatch in {k}")

        self.truth_part_pt = lr["truth_pt_raw"]
        self.truth_part_eta = lr["truth_eta_raw"]
        self.truth_part_phi = lr["truth_phi"]
        self.truth_part_e = lr["truth_e_raw"]
        self.truth_part_dep_e = lr["truth_dep_e_raw"]

        self.low_part_pt, self.low_part_eta = lr["pred_pt_raw"], lr["pred_eta_raw"]
        self.low_part_phi, self.low_part_e = lr["pred_phi"], lr["pred_e_raw"]
        self.high_part_pt, self.high_part_eta = hr["pred_pt_raw"], hr["pred_eta_raw"]
        self.high_part_phi, self.high_part_e = hr["pred_phi"], hr["pred_e_raw"]
        self.inc_wt_lr_pf = lr.get("inc_wt", {})
        self.inc_wt_hr_pf = hr.get("inc_wt", {})

        self.pf_colors = self.PF_COLORS[: max(self.max_part, 1)]
        self.truth_cardinality = np.array([len(x) for x in self.truth_part_pt])
        self.low_cardinality = lr["pred_card"]
        self.high_cardinality = hr["pred_card"]

    # ------------------------------------------------------------------
    PF_E_CUT = 1.0  # MeV — the PF dataset's cell threshold; incidence rows
    # exist only for cells above it (data/pf_dataset.py), so all coloring
    # maps through this cut

    def get_rgb(self, res, ev_i, argmax=False, threshold=0.0):
        """Per-cell RGB as the incidence-weight mixture over particle colors,
        for the threshold-cut cell subset.

        ``argmax`` hard-assigns each cell to its dominant particle (the v2
        display); ``threshold`` whitens cells whose total incidence falls
        below it (the incidence-threshold panels).  ``res`` is 'lr' or 'hr'.
        Returns (n_cut_cells, 3) or None when the stored incidence rows do
        not align with the threshold-cut cells (the reference skips such
        events)."""
        inc = self.inc_wt_lr_pf if res == "lr" else self.inc_wt_hr_pf
        if not inc:
            return None
        rows = [np.asarray(inc[pi][ev_i]) for pi in sorted(inc)]
        if len({r.shape[0] for r in rows}) != 1:
            return None  # ragged incidence rows across particles: skip event
        w = np.stack(rows, axis=-1)
        # the PF dataset cut uses e_meas_raw (LR) / e_pred_raw, the file-level
        # direct average (data/pf_dataset.py), not the recomputed comp average
        e = self._pf_cut_energy(res, ev_i)
        if w.shape[0] != int((e > self.PF_E_CUT).sum()):
            return None
        if argmax:
            hard = np.zeros_like(w)
            hard[np.arange(w.shape[0]), w.argmax(-1)] = 1.0
            w = hard
        total = w.sum(-1, keepdims=True)
        rgb = (w @ self.pf_colors[: w.shape[1]]) / np.maximum(total, 1e-12)
        rgb = np.clip(rgb, 0, 1)
        rgb[total[:, 0] < threshold] = 1.0  # below-threshold cells -> white
        return rgb

    def _pf_cut_energy(self, res, ev_i):
        return (
            self.low_e_measured[ev_i]
            if res == "lr"
            else np.asarray(self.high_e_pred_direct[ev_i])
        )

    def _pf_color_image(self, res, ev_i, L, rgb):
        """White background image at the layer granularity with the
        threshold-cut cells painted by ``rgb`` (imshow convention: phi rows,
        eta cols)."""
        gran = (self.low_gran if res == "lr" else self.high_gran)[L]
        eta_edges = np.linspace(-3, 3, gran + 1)
        phi_edges = np.linspace(-np.pi, np.pi, gran + 1)
        if res == "lr":
            eta, phi, layer = self.low_eta[ev_i], self.low_phi[ev_i], self.low_layer[ev_i]
        else:
            eta, phi, layer = self.high_eta[ev_i], self.high_phi[ev_i], self.high_layer[ev_i]
        e = self._pf_cut_energy(res, ev_i)
        img = np.ones((gran, gran, 3))
        cut = e > self.PF_E_CUT
        sel = (layer == L)[cut]
        ie = np.clip(np.digitize(eta[cut][sel], eta_edges) - 1, 0, gran - 1)
        ip = np.clip(np.digitize(phi[cut][sel], phi_edges) - 1, 0, gran - 1)
        img[ip, ie] = rgb[sel]
        return img, (eta_edges[0], eta_edges[-1], phi_edges[0], phi_edges[-1])

    def _pf_energy_panel(self, ax, res, ev_i, L, values, vmin, vmax, cmap):
        gran = (self.low_gran if res == "lr" else self.high_gran)[L]
        eta = self.low_eta[ev_i] if res == "lr" else self.high_eta[ev_i]
        phi = self.low_phi[ev_i] if res == "lr" else self.high_phi[ev_i]
        layer = self.low_layer[ev_i] if res == "lr" else self.high_layer[ev_i]
        sel = layer == L
        return ax.hist2d(
            eta[sel], phi[sel], weights=np.log1p(np.clip(values[sel], 0, None)),
            bins=[np.linspace(-3, 3, gran + 1), np.linspace(-np.pi, np.pi, gran + 1)],
            cmap=cmap, vmin=vmin, vmax=vmax,
        )[3]

    def _event_window(self, ev_i, pad=0.15):
        eta = np.concatenate([self.low_eta[ev_i], self.high_eta[ev_i]])
        phi = np.concatenate([self.low_phi[ev_i], self.high_phi[ev_i]])
        return (
            (eta.min() - pad, eta.max() + pad),
            (phi.min() - pad, phi.max() + pad),
        )

    def _particle_legend(self, fig_or_ax, n, fontsize=10):
        from matplotlib.lines import Line2D

        handles = [
            Line2D([0], [0], marker="o", color="w", markerfacecolor=self.pf_colors[pi],
                   markersize=12, label=f"Particle {pi + 1}")
            for pi in range(n)
        ]
        fig_or_ax.legend(handles=handles, loc="upper right", frameon=False, fontsize=fontsize)

    def plot_pf_event_display(self, ev_i: int = 0, dir=None, argmax=False, inc_threshold=0.0):
        """Main PF event display: per ECAL
        layer, [LR measured energy | LR PFlow coloring] next to [HR predicted
        energy | HR PFlow coloring], with a log(E+1) colorbar, per-particle
        legend, truth particle positions, and the shared event eta-phi
        window.  ``argmax=True`` is the v2 hard-assignment display;
        ``inc_threshold`` whitens weakly-assigned cells."""
        import matplotlib.pyplot as plt

        rgb_lr = self.get_rgb("lr", ev_i, argmax=argmax, threshold=inc_threshold)
        rgb_hr = self.get_rgb("hr", ev_i, argmax=argmax, threshold=inc_threshold)
        if rgb_lr is None or rgb_hr is None:
            return None  # incidence rows misaligned with the e-cut cells

        cmap = plt.get_cmap("plasma_r").copy()
        cmap.set_under("white")
        all_e = np.concatenate(
            [self.low_e_measured[ev_i], self.high_e_truth[ev_i], np.asarray(self.high_e_pred[ev_i])]
        )
        vmin, vmax = 1e-3, float(np.log1p(np.clip(all_e, 0, None)).max())
        (xlo, xhi), (ylo, yhi) = self._event_window(ev_i)

        fig, axes = plt.subplots(3, 4, figsize=(17, 11), dpi=120)
        for L in range(3):
            im = self._pf_energy_panel(axes[L, 0], "lr", ev_i, L, self.low_e_measured[ev_i], vmin, vmax, cmap)
            axes[L, 0].set_ylabel(f"ECAL{L + 1}\n$\\phi$", fontsize=11)
            img, extent = self._pf_color_image("lr", ev_i, L, rgb_lr)
            axes[L, 1].imshow(img, extent=extent, origin="lower", aspect="auto")
            self._pf_energy_panel(axes[L, 2], "hr", ev_i, L, np.asarray(self.high_e_pred[ev_i]), vmin, vmax, cmap)
            img, extent = self._pf_color_image("hr", ev_i, L, rgb_hr)
            axes[L, 3].imshow(img, extent=extent, origin="lower", aspect="auto")
            for c, title in enumerate(["LR Energy (meas)", "LR PFlow", "HR Energy (pred)", "HR PFlow"]):
                ax = axes[L, c]
                if L == 0:
                    ax.set_title(title, fontsize=12)
                ax.set_xlim(xlo, xhi)
                ax.set_ylim(ylo, yhi)
                ax.set_xlabel(r"$\eta$", fontsize=10)
            for c in (1, 3):  # truth positions on the PF panels
                for pi in range(len(self.truth_part_eta[ev_i])):
                    axes[L, c].plot(
                        self.truth_part_eta[ev_i][pi], self.truth_part_phi[ev_i][pi],
                        "x", color="k", markersize=9, markeredgewidth=2,
                    )
        cbar = fig.colorbar(im, ax=axes[:, 0], location="left", shrink=0.8, pad=0.12)
        cbar.set_label(r"$\ln(E + 1)$", fontsize=12)
        self._particle_legend(fig, min(self.max_part, len(self.pf_colors)))
        if dir:
            tag = "_argmax" if argmax else ""
            fig.savefig(f"{dir}/ED{tag}_{ev_i}.png")
        return fig

    def plot_pf_event_display_v2(self, ev_i: int = 0, dir=None):
        """Hard-assignment (argmax) variant of the main display."""
        return self.plot_pf_event_display(ev_i, dir=dir, argmax=True)

    def plot_pf_event_display_old(self, ev_i: int = 0, dir=None, verbose=False):
        """Wide diagnostic display: per
        ECAL layer [LR meas E | HR truth E | HR pred E | PF LR | PF HR |
        PF LR argmax | PF HR argmax] with per-panel sum/peak annotations."""
        import matplotlib.pyplot as plt

        rgb = {
            (res, am): self.get_rgb(res, ev_i, argmax=am)
            for res in ("lr", "hr") for am in (False, True)
        }
        if any(v is None for v in rgb.values()):
            return None

        cmap = plt.get_cmap("plasma_r").copy()
        cmap.set_under("white")
        all_e = np.concatenate(
            [self.low_e_measured[ev_i], self.high_e_truth[ev_i], np.asarray(self.high_e_pred[ev_i])]
        )
        vmin, vmax = 1e-3, float(np.log1p(np.clip(all_e, 0, None)).max())
        (xlo, xhi), (ylo, yhi) = self._event_window(ev_i)

        def annot(ax, vals):
            if vals.size:
                ax.text(0.03, 0.82, f"sum = {vals.sum():.0f} MeV\npeak = {vals.max():.0f} MeV",
                        transform=ax.transAxes, fontsize=6)

        fig, axes = plt.subplots(3, 7, figsize=(24, 9), dpi=110)
        fig.suptitle(f"Event {ev_i}", fontsize=14)
        for L in range(3):
            self._pf_energy_panel(axes[L, 0], "lr", ev_i, L, self.low_e_measured[ev_i], vmin, vmax, cmap)
            annot(axes[L, 0], self.low_e_measured[ev_i][self.low_layer[ev_i] == L])
            self._pf_energy_panel(axes[L, 1], "hr", ev_i, L, self.high_e_truth[ev_i], vmin, vmax, cmap)
            annot(axes[L, 1], self.high_e_truth[ev_i][self.high_layer[ev_i] == L])
            self._pf_energy_panel(axes[L, 2], "hr", ev_i, L, np.asarray(self.high_e_pred[ev_i]), vmin, vmax, cmap)
            annot(axes[L, 2], np.asarray(self.high_e_pred[ev_i])[self.high_layer[ev_i] == L])
            for c, (res, am) in enumerate([("lr", False), ("hr", False), ("lr", True), ("hr", True)]):
                img, extent = self._pf_color_image(res, ev_i, L, rgb[(res, am)])
                axes[L, 3 + c].imshow(img, extent=extent, origin="lower", aspect="auto")
            for c, title in enumerate(
                ["LR (meas E)", "HR (truth E)", "HR (pred E)", "PF (LR)", "PF (HR)", "PF (LR) argmax", "PF (HR) argmax"]
            ):
                ax = axes[L, c]
                if L == 0:
                    ax.set_title(title, fontsize=9)
                ax.set_xlim(xlo, xhi)
                ax.set_ylim(ylo, yhi)
        if verbose:
            print(f"event {ev_i}")
            print("truth_part_dep_e [GeV]:", np.asarray(self.truth_part_dep_e[ev_i]) * 1e-3)
            print("low_part_e [GeV]:", np.asarray(self.low_part_e[ev_i]) * 1e-3)
            print("high_part_e [GeV]:", np.asarray(self.high_part_e[ev_i]) * 1e-3)
            print("truth/low/high part_eta:", self.truth_part_eta[ev_i], self.low_part_eta[ev_i], self.high_part_eta[ev_i])
            print("truth/low/high part_phi:", self.truth_part_phi[ev_i], self.low_part_phi[ev_i], self.high_part_phi[ev_i])
        if dir:
            fig.savefig(f"{dir}/ED_wide_{ev_i}.png")
        return fig

    def plot_pf_event_display_grid(self, ev_indices, dir=None, res="hr", argmax=False):
        """Multi-event grid of PF colorings, one row per event, one column
        per ECAL layer (the reference notebook loops plot_pf_event_display
        over events; this gives the side-by-side overview)."""
        import matplotlib.pyplot as plt

        rows = []
        for ev_i in ev_indices:
            rgb = self.get_rgb(res, ev_i, argmax=argmax)
            if rgb is not None:
                rows.append((ev_i, rgb))
        if not rows:
            return None
        fig, axes = plt.subplots(len(rows), 3, figsize=(10, 3 * len(rows)), dpi=110, squeeze=False)
        for r, (ev_i, rgb) in enumerate(rows):
            (xlo, xhi), (ylo, yhi) = self._event_window(ev_i)
            for L in range(3):
                img, extent = self._pf_color_image(res, ev_i, L, rgb)
                ax = axes[r, L]
                ax.imshow(img, extent=extent, origin="lower", aspect="auto")
                ax.set_xlim(xlo, xhi)
                ax.set_ylim(ylo, yhi)
                ax.set_title(f"ev {ev_i} ECAL{L + 1}", fontsize=8)
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/ED_grid_{res}.png")
        return fig

    def load_truth_incidence(self, truth_path, ev_i):
        """Row-normalised truth incidence weights over the SR-file HR cell
        rows (ECAL, LR-grouped order) for one event, from the original
        dataset file's particle_to_node_idx/weight — the same construction
        data/pf_dataset.py uses.  Returns (n_hr_ecal_cells, n_particles)."""
        hi = root_io.read_tree(
            truth_path, "High_Tree",
            ["cell_e", "cell_layer", "particle_to_node_idx", "particle_to_node_weight"],
            ev_i, ev_i + 1,
        )
        lo = root_io.read_tree(truth_path, "Low_Tree", ["high_cell_to_low_cell_edge"], ev_i, ev_i + 1)
        order = np.asarray(lo["high_cell_to_low_cell_edge"][0], int)
        layer = np.asarray(hi["cell_layer"][0])[order]
        ecal_rows = np.nonzero(layer < 3)[0]  # LR-grouped rows kept by the SR cut
        row_of = np.full(order.size, -1, int)
        row_of[ecal_rows] = np.arange(ecal_rows.size)
        pos = np.full(order.size, -1, int)
        pos[order] = np.arange(order.size)  # original slot -> LR-grouped row
        n_part = len(hi["particle_to_node_idx"][0])
        w = np.zeros((ecal_rows.size, n_part))
        for pi in range(n_part):
            idxs = np.asarray(hi["particle_to_node_idx"][0][pi], int)
            wts = np.asarray(hi["particle_to_node_weight"][0][pi], float)
            rows = row_of[pos[idxs]]
            ok = rows >= 0
            np.add.at(w, (rows[ok], pi), wts[ok])
        row_tot = w.sum(-1, keepdims=True)
        return w / np.maximum(row_tot, 1e-12)

    def plot_incidence_truth_vs_pred(self, ev_i, truth_path, dir=None):
        """Truth vs predicted incidence comparison for one event: per ECAL
        layer, cells colored by the truth incidence mixture next to the
        predicted mixture, plus a per-particle weight scatter."""
        import matplotlib.pyplot as plt

        pred = self.get_rgb("hr", ev_i)
        if pred is None:
            return None
        # restrict the truth incidence to the PF-threshold cells, using the
        # same direct-average energy cut the PF file was built with
        keep = self._pf_cut_energy("hr", ev_i) > self.PF_E_CUT
        w_true = self.load_truth_incidence(truth_path, ev_i)[keep]
        inc = self.inc_wt_hr_pf
        w_pred = np.stack([np.asarray(inc[pi][ev_i]) for pi in sorted(inc)], axis=-1)
        if w_true.shape[0] != w_pred.shape[0]:
            return None
        n_part = min(w_true.shape[1], w_pred.shape[1])
        rgb_true = np.clip(w_true[:, :n_part] @ self.pf_colors[:n_part], 0, 1)

        (xlo, xhi), (ylo, yhi) = self._event_window(ev_i)
        fig, axes = plt.subplots(3, 3, figsize=(13, 10), dpi=110)
        for L in range(3):
            img, extent = self._pf_color_image("hr", ev_i, L, rgb_true)
            axes[L, 0].imshow(img, extent=extent, origin="lower", aspect="auto")
            img, extent = self._pf_color_image("hr", ev_i, L, pred)
            axes[L, 1].imshow(img, extent=extent, origin="lower", aspect="auto")
            for c, title in enumerate(["truth incidence", "pred incidence"]):
                ax = axes[L, c]
                if L == 0:
                    ax.set_title(title, fontsize=11)
                ax.set_xlim(xlo, xhi)
                ax.set_ylim(ylo, yhi)
                ax.set_ylabel(f"ECAL{L + 1}")
            ax = axes[L, 2]
            for pi in range(n_part):
                ax.plot(w_true[:, pi], w_pred[:, pi], ".", ms=2, color=self.pf_colors[pi], alpha=0.5)
            ax.plot([0, 1], [0, 1], "k--", lw=0.5)
            ax.set_xlabel("truth weight")
            ax.set_ylabel("pred weight")
        self._particle_legend(fig, n_part)
        fig.tight_layout()
        if dir:
            fig.savefig(f"{dir}/incidence_truth_vs_pred_{ev_i}.png")
        return fig

    def cardinality_confusion(self):
        """(LR, HR) confusion matrices pred x truth."""
        n = self.max_part + 1
        out = []
        for pred in [self.low_cardinality, self.high_cardinality]:
            cm = np.zeros((n, n), int)
            for t, p in zip(self.truth_cardinality, pred):
                cm[min(p, n - 1), min(t, n - 1)] += 1
            out.append(cm)
        return tuple(out)

    def kinematic_residuals(self):
        """Matched truth-pred residuals for pt/eta/phi/e, LR and HR."""
        res = {}
        for tag, (pt, eta, phi, e) in {
            "lr": (self.low_part_pt, self.low_part_eta, self.low_part_phi, self.low_part_e),
            "hr": (self.high_part_pt, self.high_part_eta, self.high_part_phi, self.high_part_e),
        }.items():
            for name, pred, truth in [
                ("pt", pt, self.truth_part_pt),
                ("eta", eta, self.truth_part_eta),
                ("phi", phi, self.truth_part_phi),
                ("e", e, self.truth_part_e),
            ]:
                diffs = []
                for i in range(len(truth)):
                    k = min(len(truth[i]), len(pred[i]))
                    d = np.asarray(truth[i][:k]) - np.asarray(pred[i][:k])
                    if name == "phi":
                        d = (d + np.pi) % (2 * np.pi) - np.pi
                    diffs.append(d)
                res[f"{tag}_{name}"] = np.hstack(diffs) if diffs else np.zeros(0)
        return res
