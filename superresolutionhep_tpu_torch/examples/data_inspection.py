"""Dataset inspection (counterpart of notebooks/data_inspection/*): cell
count / energy / cardinality distributions of an SR input file.

  python -m superresolutionhep_tpu_torch.examples.data_inspection --file data/single_e/train.h5 --out plots/
"""

import argparse
import os

import numpy as np

from ..data import root_io


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--file", "-f", required=True)
    ap.add_argument("--out", "-o", default="plots")
    args = ap.parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.out, exist_ok=True)

    low = root_io.read_tree(args.file, "Low_Tree", ["cell_e", "cell_layer", "particle_pt", "particle_pdgid"])
    high = root_io.read_tree(args.file, "High_Tree", ["cell_e", "cell_layer"])

    fig, axes = plt.subplots(1, 4, figsize=(18, 4), dpi=110)

    n_low = low["cell_e"].counts
    n_high = high["cell_e"].counts
    axes[0].hist([n_low, n_high], bins=30, label=["LR", "HR"], histtype="step")
    axes[0].set_xlabel("cells / event")
    axes[0].legend()

    axes[1].hist(np.log10(np.maximum(low["cell_e"].flat, 1e-3)), bins=60, histtype="stepfilled", color="cornflowerblue")
    axes[1].set_xlabel("log10 LR cell E [MeV]")

    card = low["particle_pt"].counts
    axes[2].hist(card, bins=np.arange(card.max() + 2) - 0.5, histtype="stepfilled", color="cornflowerblue")
    axes[2].set_xlabel("particle cardinality")

    pdg = np.abs(low["particle_pdgid"].flat)
    axes[3].hist(pdg, bins=np.arange(25) - 0.5, histtype="stepfilled", color="cornflowerblue")
    axes[3].set_xlabel("|pdgid|")

    fig.tight_layout()
    path = os.path.join(args.out, "data_inspection.png")
    fig.savefig(path)
    print(f"wrote {path} ({len(n_low)} events)")


if __name__ == "__main__":
    main()
