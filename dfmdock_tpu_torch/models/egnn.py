"""E(n)-equivariant graph convolution layers on [P, N, K] slot tensors.

Mirrors `dfmdock_tpu/models/egnn.py`: every node owns K neighbour slots, so
messages are [P, N, K, C] tensors and aggregation is a masked sum over K.
Two forward paths share the parameters:

- `egnn_apply`: the eager formulation (`--exact`, and training), in float32
  or with the JAX package's bf16 products (`dtype`), against which the
  kernels are held;
- `egnn_apply_fused`: the inference path through `ops/fused_egcl`, which
  reads the per-step edge table of `ops/edge_table` (built by the edge_table
  kernel, or by `build_edge_table_unfused` with that kernel off), in
  float32 or, with `dtype` bfloat16, at the JAX package's Pallas route's
  precision (its `egnn_apply_fused(dtype=)` and kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dfmdock_tpu_torch.features.positional import relpos_bin_at
from dfmdock_tpu_torch.features.sixd import (
    gather_rows,
    sixd_bins_at,
    spatial_embed_from_bins,
    table_rows,
)
from dfmdock_tpu_torch.models.modules import GraphNorm, linear
from dfmdock_tpu_torch.ops.edge_table import build_edge_table, edge_bins, edge_geometry
from dfmdock_tpu_torch.ops.fused_egcl import fused_edge_layer, prepare_layer, rounding


class EGCL(nn.Module):
    """One E_GCL layer (reference egnn.py E_GCL); only the last layer of the
    stack owns `coord_mlp` and moves coordinates."""

    def __init__(self, node_dim: int, edge_dim: int, update_coords: bool):
        super().__init__()
        c = node_dim
        self.edge_mlp = nn.ModuleDict({
            "l0": nn.Linear(2 * c + 1 + edge_dim, c),
            "l1": nn.Linear(c, c),
        })
        self.node_mlp = nn.ModuleDict({
            "l0": nn.Linear(2 * c, c),
            "gn": GraphNorm(c),
            "l1": nn.Linear(c, c),
        })
        self.att_mlp = nn.ModuleDict({"l0": nn.Linear(c, 1)})
        self.coord_mlp = (
            nn.ModuleDict({"l0": nn.Linear(c, c), "l1": nn.Linear(c, 1, bias=False)})
            if update_coords else None
        )

    def edge_weights(self):
        """The first edge-MLP weight split by input rows ([in, out] each):
        h_i, h_j, radial, edge_attr."""
        c = self.node_mlp["l1"].weight.shape[0]
        w0 = self.edge_mlp["l0"].weight.t()
        return w0[:c], w0[c : 2 * c], w0[2 * c], w0[2 * c + 1 :]

    def node_update(self, h, agg_m, node_mask, dtype=None):
        l0, l1 = self.node_mlp["l0"], self.node_mlp["l1"]
        o = linear(torch.cat([h, agg_m], -1), l0.weight, l0.bias, dtype)
        o = self.node_mlp["gn"](o, node_mask)
        return h + linear(F.silu(o), l1.weight, l1.bias, dtype)

    def forward(self, h, coord, idx, edge_mask, edge_attr, node_mask, lig_mask,
                *, normalize: bool, coord_clamp: float = 2.0, dtype=None):
        """Eager E_GCL.  h [P, N, C], coord [P, N, 3], idx / edge_mask
        [P, N, K], edge_attr [P, N, K, E], node_mask [N] bool, lig_mask [N]
        float.  `dtype` (bfloat16) casts the products the JAX package's
        `egcl_apply` casts (`modules.linear`); the radial row and the coord
        MLP's last Linear stay float32, as there.  Returns (h', coord')."""
        coord_diff = coord[..., :, None, :] - gather_rows(coord, idx.long())
        radial = (coord_diff * coord_diff).sum(-1, keepdim=True)
        if normalize:
            coord_diff = coord_diff / (torch.sqrt(radial + 1e-8) + 1.0)

        # the first Linear over concat[h_i, h_j, radial, e_attr], split by
        # weight rows so the [.., 2C+1+E] concat never materializes
        w_hi, w_hj, w_r, w_e = self.edge_weights()
        l1, att = self.edge_mlp["l1"], self.att_mlp["l0"]
        pre = (
            linear(h, w_hi.t(), dtype=dtype)[..., :, None, :]
            + gather_rows(linear(h, w_hj.t(), dtype=dtype), idx.long())
            + radial * w_r
            + linear(edge_attr, w_e.t(), dtype=dtype)
            + self.edge_mlp["l0"].bias
        )
        m = F.silu(linear(F.silu(pre), l1.weight, l1.bias, dtype))
        m = m * torch.sigmoid(linear(m, att.weight, att.bias, dtype))
        m = m * edge_mask[..., None]

        new_coord = coord
        if self.coord_mlp is not None:
            c0 = self.coord_mlp["l0"]
            w = self.coord_mlp["l1"](F.silu(linear(m, c0.weight, c0.bias, dtype)))
            w = w.clamp(-coord_clamp, coord_clamp)
            trans = coord_diff * w * edge_mask[..., None]
            count = edge_mask.sum(-1, keepdim=True).clamp(min=1.0)
            new_coord = coord + (trans.sum(-2) / count) * lig_mask[:, None]
        return self.node_update(h, m.sum(-2), node_mask, dtype), new_coord


def egnn_apply(layers, h, coord, idx, edge_mask, edge_attr, node_mask, lig_mask, *,
               normalize: bool, dtype=None):
    for layer in layers:
        h, coord = layer(h, coord, idx, edge_mask, edge_attr, node_mask, lig_mask,
                         normalize=normalize, dtype=dtype)
    return h, coord


def build_edge_table_unfused(idx, pos, res_id, asym_id, *, normalize: bool):
    """The edge table with the edge_table kernel off (the JAX package's
    `build_edge_table_xla` route): ebin from the edge_bins kernel, egeo from
    plain PyTorch geometry.  Arguments and layout as `build_edge_table`."""
    return (edge_bins(idx, pos, res_id, asym_id),
            edge_geometry(idx, pos, normalize=normalize))


def edge_stack(c, layers, spatial_w, positional_w, batch, pos, h, idx, edge_mask,
               lig_valid, fused: bool | None = None, dtype=None):
    """The EGCL stack of a score network over the selected edges, on the
    route its config `c` names: the edge table (`c.edge_table_kernel`: one
    kernel, else its bins-only mode and torch geometry) and ops/fused_egcl
    with `c.use_pallas` (or `fused`, where given); else the eager layers
    (training takes these: the kernels are inference-only).  On either
    route the products are cast to `dtype` where given, as the JAX
    package's.  layers: the EGCL modules; spatial_w [100, E] / positional_w
    [66, E]: the embed tables.  pos [P, N, 3, 3], h [P, N, C] -> (h, CA
    coordinates after the stack)."""
    node_mask = batch["node_mask"]
    ca = pos[..., 1, :]
    if (c.use_pallas if fused is None else fused):
        build = build_edge_table if c.edge_table_kernel else build_edge_table_unfused
        ebin, egeo = build(idx, pos.contiguous(), batch["res_id"], batch["asym_id"],
                           normalize=c.normalize)
        return egnn_apply_fused(layers, spatial_w, positional_w, h, ca, idx, edge_mask,
                                ebin, egeo, node_mask, lig_valid, dtype)
    rp = relpos_bin_at(batch["res_id"], batch["asym_id"], idx)
    db, ob, tb, pb = sixd_bins_at(pos.detach(), idx)
    edge_attr = spatial_embed_from_bins(spatial_w, db, ob, tb, pb) + table_rows(positional_w, rp)
    return egnn_apply(layers, h, ca, idx, edge_mask, edge_attr, node_mask, lig_valid,
                      normalize=c.normalize, dtype=dtype)


def fused_weights(layer, spatial_w, positional_w, dtype=None, kernel=False):
    """One layer's step-invariant operands on the fused route: the rounded
    projections W_hi / W_hj, w_r, the tables T_sp = spatial_w @ W_e and
    T_p = positional_w @ W_e, W_l1 and W_c0 transposed, and with `kernel`
    their kernel-side form (ops/fused_egcl.prepare_layer).  Under no_grad
    they are built once per set of weights and kept on the layer, keyed on
    each parameter's storage and version (an in-place update rebuilds
    them); with gradients on they are built in the call.  They are never
    built while a CUDA graph is being captured (a warm-up builds them)."""
    coord = layer.coord_mlp is not None
    params = (layer.edge_mlp["l0"].weight, layer.edge_mlp["l1"].weight, spatial_w,
              positional_w) + ((layer.coord_mlp["l0"].weight,) if coord else ())
    key = (dtype, kernel, tuple((t.data_ptr(), t.device, t._version) for t in params))
    cached = getattr(layer, "_fused_weights", None)
    if cached is not None and cached[0] == key and not torch.is_grad_enabled():
        return cached[1]
    if (not torch.is_grad_enabled() and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        # tensors made under capture are only computed by a replay: an eager
        # call before it would read them unwritten
        raise RuntimeError("fused_weights: the prepared weights would be built inside a "
                           "CUDA graph capture; build them first, in the capture's warm-up "
                           "(sampler/graph.py runs one step and the final forward eagerly)")
    rn = rounding(dtype)
    w_hi, w_hj, w_r, w_e = layer.edge_weights()
    w = {"w_hi": rn(w_hi), "w_hj": rn(w_hj), "w_r": w_r.contiguous(),
         "t_sp": (spatial_w @ w_e).contiguous(), "t_p": (positional_w @ w_e).contiguous(),
         "w_l1": layer.edge_mlp["l1"].weight.t().contiguous(),
         "w_c0": layer.coord_mlp["l0"].weight.t().contiguous() if coord else None}
    w["kernel"] = (prepare_layer(w["t_sp"], w["t_p"], w["w_l1"], w["w_c0"], dtype)
                   if kernel else None)
    if not torch.is_grad_enabled():
        layer._fused_weights = (key, w)
    return w


def egnn_apply_fused(layers, spatial_w, positional_w, h, coord, idx, edge_mask,
                     ebin, egeo, node_mask, lig_mask, dtype=None):
    """The EGCL stack over the fused edge pipeline.

    spatial_w [100, E] and positional_w [66, E] are the embed tables; idx /
    edge_mask the selected edges, ebin / egeo the step's edge table.
    `dtype` (bfloat16) casts what the JAX package's `egnn_apply_fused`
    casts: the a and B projections and the node MLP (`modules.linear`),
    the embed tables (their float32 product with W_e rounded), and
    ops/fused_egcl's products (its single-pass mode, which reads B as bf16:
    rounded here, once per layer).  The weights' step-invariant forms come
    from `fused_weights`.  Inference only."""
    rn = rounding(dtype)
    kernel = h.device.type == "cuda"
    for layer in layers:
        w = fused_weights(layer, spatial_w, positional_w, dtype, kernel)
        h_in = rn(h)
        a = h_in @ w["w_hi"] + layer.edge_mlp["l0"].bias
        B = h_in @ w["w_hj"]
        if dtype is not None:
            B = B.to(dtype)
        l1, att = layer.edge_mlp["l1"], layer.att_mlp["l0"]
        coord_params = None
        if layer.coord_mlp is not None:
            c0, c1 = layer.coord_mlp["l0"], layer.coord_mlp["l1"]
            coord_params = (w["w_c0"], c0.bias, c1.weight[0])
        out = fused_edge_layer(
            idx, edge_mask, ebin, egeo, a.contiguous(), B.contiguous(), w["t_sp"], w["t_p"],
            w["w_r"], w["w_l1"], l1.bias, att.weight[0], att.bias, coord_params, dtype,
            prepared=w["kernel"],
        )
        if coord_params is None:
            agg_m = out
        else:
            agg_m, trans_sum = out
            count = edge_mask.sum(-1, keepdim=True).clamp(min=1.0)
            coord = coord + (trans_sum / count) * lig_mask[:, None]
        h = layer.node_update(h, agg_m, node_mask, dtype)
    return h, coord
