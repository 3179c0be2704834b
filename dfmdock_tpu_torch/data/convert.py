"""Preprocessed complexes: the npz reader, and the converter of the
reference's torch_geometric `.pt` complexes to npz (mirrors
`dfmdock_tpu/data/convert.py`).

A reference `.pt` (the DB5 test set, DIPS) pickles a HeteroData with
`receptor` / `ligand` node stores: x [L, 1280] ESM2-650M per-residue
representations, pos [L, 3, 3] N/CA/C backbone, seq (str).  torch_geometric
is not needed: unpickling finds stub classes registered under its module
paths (`_install_pyg_stubs`).  A `.pt` is unpickled, so convert only files
you trust.

npz schema (one file per complex):
  rec_x [R,1280] f32, rec_pos [R,3,3] f32, rec_seq str
  lig_x [L,1280] f32, lig_pos [L,3,3] f32, lig_seq str

  python -m dfmdock_tpu_torch.data.convert --src DIR_OF_PT --dst data/db5_npz
"""
from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np
import torch


class _Store(dict):
    """A torch_geometric storage: its pickled state is a dict whose
    '_mapping' holds the attributes."""

    def __setstate__(self, state):
        self.update(state if isinstance(state, dict) else state.__dict__)


class _HeteroData:
    def __setstate__(self, state):
        self.__dict__.update(state)


PYG_MODULES = ("torch_geometric", "torch_geometric.data", "torch_geometric.data.hetero_data",
               "torch_geometric.data.data", "torch_geometric.data.storage")


def pyg_stub_modules() -> dict:
    """{module name: module} of the stub classes, each class registered
    under the name torch_geometric gives it (so a stub object pickles as a
    torch_geometric one, and unpickles back into the stub)."""
    mods = {name: types.ModuleType(name) for name in PYG_MODULES}

    def register(module, name, base):
        cls = type(name, (base,), {"__module__": module})
        setattr(mods[module], name, cls)

    register("torch_geometric.data.hetero_data", "HeteroData", _HeteroData)
    register("torch_geometric.data.data", "Data", _HeteroData)
    for name in ("BaseStorage", "NodeStorage", "EdgeStorage", "GlobalStorage"):
        register("torch_geometric.data.storage", name, _Store)
    return mods


def _install_pyg_stubs():
    """Register the stubs unless a torch_geometric (the real package, or the
    JAX package's stubs) is already imported; load_pt_complex reads either."""
    if "torch_geometric" not in sys.modules:
        sys.modules.update(pyg_stub_modules())


def _mapping(store) -> dict:
    """The attribute mapping of a node store, whichever classes unpickled it."""
    return store["_mapping"] if isinstance(store, dict) else store._mapping


def load_pt_complex(path: str) -> dict:
    """One reference .pt complex as numpy arrays and strings."""
    _install_pyg_stubs()
    data = torch.load(path, weights_only=False, map_location="cpu")
    stores = data._node_store_dict
    out = {}
    for chain, prefix in (("receptor", "rec"), ("ligand", "lig")):
        m = _mapping(stores[chain])
        out[f"{prefix}_x"] = m["x"].numpy().astype(np.float32)
        out[f"{prefix}_pos"] = m["pos"].numpy().astype(np.float32)
        out[f"{prefix}_seq"] = m["seq"]
    return out


def convert_file(pt_path: str, npz_path: str):
    """One reference .pt complex -> one npz."""
    d = load_pt_complex(pt_path)
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    np.savez_compressed(npz_path, rec_x=d["rec_x"], rec_pos=d["rec_pos"],
                        rec_seq=np.str_(d["rec_seq"]), lig_x=d["lig_x"],
                        lig_pos=d["lig_pos"], lig_seq=np.str_(d["lig_seq"]))


def load_npz_complex(path: str) -> dict:
    with np.load(path) as z:
        return {
            "rec_x": z["rec_x"],
            "rec_pos": z["rec_pos"],
            "rec_seq": str(z["rec_seq"]),
            "lig_x": z["lig_x"],
            "lig_pos": z["lig_pos"],
            "lig_seq": str(z["lig_seq"]),
        }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", required=True, help="directory of reference .pt complexes")
    ap.add_argument("--dst", default="data/db5_npz")
    args = ap.parse_args(argv)
    os.makedirs(args.dst, exist_ok=True)
    for f in sorted(f for f in os.listdir(args.src) if f.endswith(".pt")):
        out = os.path.join(args.dst, f[: -len(".pt")] + ".npz")
        convert_file(os.path.join(args.src, f), out)
        print(f"{f} -> {out}")
    # carry the split list over, keeping the ids that were converted
    src_list = os.path.join(args.src, "test.txt")
    if os.path.exists(src_list):
        with open(src_list) as fh:
            ids = [line.strip() for line in fh if line.strip()]
        kept = [i for i in ids if os.path.exists(os.path.join(args.dst, i + ".npz"))]
        with open(os.path.join(args.dst, "test.txt"), "w") as fh:
            fh.write("\n".join(kept) + "\n")


if __name__ == "__main__":
    main()
