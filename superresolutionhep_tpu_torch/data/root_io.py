"""Event-file IO with the reference's ROOT tree schema.

The reference reads/writes ROOT files via uproot/awkward
(dataset.py:26-95, inference.py:291-310).  This module keeps the exact same
logical schema — named trees (``Low_Tree``/``High_Tree``/``Particle_Tree``)
of jagged branches — in the pure-HDF5 container (``.h5``/``.hdf5``) that
stores each branch as flat + offsets datasets; the layout is self-describing
(``<tree>/<branch>/{flat,offsets[,inner_offsets]}``) and identical to the
one the JAX package writes, so files move between the two.  ``h5py`` is
imported inside the functions: nothing on the device path needs it.  The
uproot backend is not ported yet; ``.root`` paths raise.

All host-side code in this framework goes through :func:`read_tree` /
:func:`write_trees` and never touches a backend directly.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import numpy as np

from .jagged import Jagged2Array, JaggedArray

Branch = Union[np.ndarray, JaggedArray, Jagged2Array]


def _is_h5(path: str) -> bool:
    return str(path).endswith((".h5", ".hdf5"))


# ---------------------------------------------------------------------------
# HDF5 backend
# ---------------------------------------------------------------------------


def _h5_write(path, trees: Mapping[str, Mapping[str, Branch]]):
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["format"] = "superresolutionhep_tpu/v1"
        for tree_name, branches in trees.items():
            tg = f.create_group(tree_name)
            for name, arr in branches.items():
                bg = tg.create_group(name)
                if isinstance(arr, Jagged2Array):
                    bg.attrs["kind"] = "jagged2"
                    bg.create_dataset("flat", data=arr.flat)
                    bg.create_dataset("inner_offsets", data=arr.inner_offsets)
                    bg.create_dataset("offsets", data=arr.outer_offsets)
                elif isinstance(arr, JaggedArray):
                    bg.attrs["kind"] = "jagged"
                    bg.create_dataset("flat", data=arr.flat)
                    bg.create_dataset("offsets", data=arr.offsets)
                else:
                    bg.attrs["kind"] = "flat"
                    bg.create_dataset("flat", data=np.asarray(arr))


def _h5_read_tree(path, tree: str, branches=None, entry_start=0, entry_stop=None):
    import h5py

    out: Dict[str, Branch] = {}
    with h5py.File(path, "r") as f:
        tg = f[tree]
        names = branches if branches is not None else list(tg.keys())
        for name in names:
            bg = tg[name]
            kind = bg.attrs["kind"]
            if kind == "flat":
                data = bg["flat"][entry_start:entry_stop]
                out[name] = data
            elif kind == "jagged":
                offsets = bg["offsets"][:]
                stop = len(offsets) - 1 if entry_stop is None else entry_stop
                sel = offsets[entry_start : stop + 1]
                flat = bg["flat"][sel[0] : sel[-1]]
                out[name] = JaggedArray(flat, sel - sel[0])
            elif kind == "jagged2":
                outer = bg["offsets"][:]
                stop = len(outer) - 1 if entry_stop is None else entry_stop
                osel = outer[entry_start : stop + 1]
                inner = bg["inner_offsets"][osel[0] : osel[-1] + 1]
                flat = bg["flat"][inner[0] : inner[-1]]
                out[name] = Jagged2Array(flat, inner - inner[0], osel - osel[0])
            else:  # pragma: no cover
                raise ValueError(f"unknown branch kind {kind!r}")
    return out


def _h5_num_entries(path, tree):
    import h5py

    with h5py.File(path, "r") as f:
        tg = f[tree]
        first = tg[next(iter(tg.keys()))]
        if first.attrs["kind"] == "flat":
            return len(first["flat"])
        return len(first["offsets"]) - 1


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _require_h5(path, verb: str):
    if not _is_h5(path):
        raise RuntimeError(
            f"cannot {verb} {path!r}: only the .h5 container format is supported here"
        )


def read_tree(path, tree: str, branches: Sequence[str] | None = None, entry_start: int = 0, entry_stop=None):
    _require_h5(path, "read")
    return _h5_read_tree(path, tree, branches, entry_start, entry_stop)


def write_trees(path, trees: Mapping[str, Mapping[str, Branch]]):
    _require_h5(path, "write")
    return _h5_write(path, trees)


def num_entries(path, tree: str) -> int:
    _require_h5(path, "read")
    return _h5_num_entries(path, tree)
