"""Offline analysis of SR inference outputs.

The port's own copy of the SR part of the JAX package's
``analysis/performance.py`` (numpy, and matplotlib imported inside each plot
method): re-reads the inference event files through the port's HDF5 reader
(``data/root_io.py``: LR/HR geometry, truth/pred/proxy energies, NN-space
branches, per-timestep and per-ensemble-component branches), recomputes
ensemble averages, and exposes the residual and event-display plots as
methods.  The PF analysis class (``PFPerformanceCOCOA``) is not ported yet.

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
