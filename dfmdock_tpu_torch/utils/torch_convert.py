"""Reference PyTorch Lightning checkpoints -> the port's state_dict (the
port of `dfmdock_tpu/utils/torch_convert.py`).

The reference nets' state_dict names are mapped onto the JAX package's
parameter tree (the map below, copied from the JAX package), flattened to
its "/"-joined paths and passed through the port's parameter bridge
(params.to_state_dict), so `ScoreNet` and `DFMDockModel` load the result
with every key matched.  Linear weights keep torch's [out, in] layout end
to end (the tree holds them transposed, as the JAX package does, and the
bridge transposes them back); the frozen Fourier buffer `t_embed.0.W` is
copied verbatim.

state_dict name map (mlsb lineage, reference score_net_mlsb.py:249-341 and
egnn.py:31-93; all under the Lightning prefix `net.`):

  single_embed.weight                  -> single_embed.w (T)
  spatial_embed.weight                 -> spatial_embed.w (T)
  positional_embed.weight              -> positional_embed.w (T)
  network.EGNN_{i}.egcl.edge_mlp.{0,2}.{weight,bias} -> egnn[i].edge_mlp.{l0,l1}
  network.EGNN_{i}.egcl.node_mlp.0     -> egnn[i].node_mlp.l0
  network.EGNN_{i}.egcl.node_mlp.1.{weight,bias,mean_scale} -> node_mlp.gn.{g,b,mean_scale}
  network.EGNN_{i}.egcl.node_mlp.3     -> egnn[i].node_mlp.l1
  network.EGNN_{i}.egcl.att_mlp.0      -> egnn[i].att_mlp.l0
  network.EGNN_{i}.egcl.coord_mlp.{0,2} -> egnn[i].coord_mlp.{l0,l1} (last layer)
  to_energy.{0,1,3}                    -> to_energy.{l0,ln,l1}
  to_ires.{0,2,4}                      -> to_ires.{l0,l1,l2}
  t_embed.0.W / t_embed.1.weight       -> t_embed.{W, l0}
  tr_scale.{0,1,4} / rot_scale.{0,1,4} -> tr_scale/rot_scale.{l0,ln,l1}

The DFMDock lineage (egnn_net.py) adds to_force/to_dist/to_confidence with
the same {0,1,3} Sequential layout, and no coord_mlp.
"""
from __future__ import annotations

import numpy as np
import torch

from dfmdock_tpu_torch.params import to_state_dict


def _lin(sd, name, bias=True):
    p = {"w": np.ascontiguousarray(np.asarray(sd[f"{name}.weight"]).T)}
    if bias:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _ln(sd, name):
    return {"g": np.asarray(sd[f"{name}.weight"]), "b": np.asarray(sd[f"{name}.bias"])}


def _gn(sd, name):
    return {
        "g": np.asarray(sd[f"{name}.weight"]),
        "b": np.asarray(sd[f"{name}.bias"]),
        "mean_scale": np.asarray(sd[f"{name}.mean_scale"]),
    }


def _pair_head(sd, name):
    return {"l0": _lin(sd, f"{name}.0", bias=False), "ln": _ln(sd, f"{name}.1"),
            "l1": _lin(sd, f"{name}.3", bias=False)}


def _scale_mlp(sd, name):
    return {"l0": _lin(sd, f"{name}.0", bias=False), "ln": _ln(sd, f"{name}.1"),
            "l1": _lin(sd, f"{name}.4", bias=False)}


def _egcl(sd, prefix, update_coords):
    p = {
        "edge_mlp": {
            "l0": _lin(sd, f"{prefix}.edge_mlp.0"),
            "l1": _lin(sd, f"{prefix}.edge_mlp.2"),
        },
        "node_mlp": {
            "l0": _lin(sd, f"{prefix}.node_mlp.0"),
            "gn": _gn(sd, f"{prefix}.node_mlp.1"),
            "l1": _lin(sd, f"{prefix}.node_mlp.3"),
        },
        "att_mlp": {"l0": _lin(sd, f"{prefix}.att_mlp.0")},
    }
    if update_coords:
        p["coord_mlp"] = {
            "l0": _lin(sd, f"{prefix}.coord_mlp.0"),
            "l1": _lin(sd, f"{prefix}.coord_mlp.2", bias=False),
        }
    return p


def _common(sd, g):
    return {
        "single_embed": _lin(sd, g("single_embed"), bias=False),
        "spatial_embed": _lin(sd, g("spatial_embed"), bias=False),
        "positional_embed": _lin(sd, g("positional_embed"), bias=False),
        "to_energy": _pair_head(sd, g("to_energy")),
        "to_ires": {
            "l0": _lin(sd, g("to_ires.0")),
            "l1": _lin(sd, g("to_ires.2")),
            "l2": _lin(sd, g("to_ires.4")),
        },
        "t_embed": {
            "W": np.asarray(sd[g("t_embed.0.W")]),
            "l0": _lin(sd, g("t_embed.1"), bias=False),
        },
        "tr_scale": _scale_mlp(sd, g("tr_scale")),
        "rot_scale": _scale_mlp(sd, g("rot_scale")),
    }


def convert_score_net(sd: dict, depth: int = 6, prefix: str = "") -> dict:
    """mlsb Score_Net state_dict -> the ScoreNet parameter tree (numpy leaves)."""
    g = lambda n: prefix + n
    params = _common(sd, g)
    params["egnn"] = [_egcl(sd, g(f"network.EGNN_{i}.egcl"), update_coords=(i == depth - 1))
                      for i in range(depth)]
    return params


def convert_egnn_net(sd: dict, depth: int = 6, prefix: str = "") -> dict:
    """DFMDock-lineage EGNN_Net state_dict -> the EGNNNet parameter tree."""
    g = lambda n: prefix + n
    params = _common(sd, g)
    params["egnn"] = [_egcl(sd, g(f"network.EGNN_{i}.egcl"), update_coords=False)
                      for i in range(depth)]
    for head in ("to_force", "to_dist", "to_confidence"):
        params[head] = _pair_head(sd, g(head))
    return params


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts and lists -> {"a/b/0/w": leaf}: the JAX package's flat
    paths, which params.to_state_dict maps."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def load_lightning_checkpoint(path: str, lineage: str = "mlsb"):
    """Load a reference Lightning .ckpt: (state_dict for the port's ScoreNet
    (mlsb) or DFMDockModel (dfmdock), hyper_parameters dict).

    The weights sit under 'state_dict' with the LightningModule prefix
    'net.'; the depth is the checkpoint's own `model.depth` (6 when absent).
    The file is unpickled in full (weights_only=False: it carries
    hyperparameter objects the safe loader refuses), so load only
    checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() for k, v in ckpt["state_dict"].items() if k.startswith("net.")}
    hparams = dict(ckpt.get("hyper_parameters", {}))
    try:
        depth = int(hparams["model"]["depth"])
    except (KeyError, TypeError, ValueError):
        depth = 6
    conv = convert_score_net if lineage == "mlsb" else convert_egnn_net
    return to_state_dict(flatten(conv(sd, depth=depth, prefix="net."))), hparams
