"""ScoreNet: the mlsb-lineage score network, predict path, batched over poses.

Mirrors `dfmdock_tpu/models/score_net.py` (`ScoreNet.apply(predict=True)`):
poses ride a leading [P] dimension and share one padded complex (receptor
rows, ligand rows, padding; `node_mask` marks valid rows, `lig_mask` valid
ligand rows).  Per forward:

  center on the ligand CA centroid -> CA distances -> select_edges ->
  6 EGCL layers (last one moves ligand CAs) -> tr/rot scores via `_rescale`
  [-> energy head over receptor x ligand pairs in row chunks, ires, clashes]

Edge selection goes through ops/select_topk on every path.  With
`cfg.use_pallas` the rest of the forward runs through the CUDA kernels: the
edge table (ops/edge_table: the whole table, or with `edge_table_kernel`
off its bins alone), the EGCL stack (ops/fused_egcl) and the energy head
(ops/energy_head); otherwise through the eager path.  On both routes
`cfg.compute_dtype` "bfloat16" casts the products the JAX package casts
(`modules.compute_dtype`, `modules.linear`): the embedding, the EGCL
projections and node MLP, ops/fused_egcl's products (its single-pass mode)
and the energy head's halves.  `ModelConfig.fast()` computes so, as the JAX
package's; `fast(compute_dtype="float32")` is the float32 kernel route.

Batch (tensors on the model's device): h0 [N, C] or x [N, F], node_mask [N]
bool, lig_mask [N] f32, res_id / asym_id [N] int32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dfmdock_tpu_torch.config import ModelConfig
from dfmdock_tpu_torch.data.batching import ENERGY_ROW_CHUNK
from dfmdock_tpu_torch.features.positional import NUM_RELPOS_CLASSES
from dfmdock_tpu_torch.features.sixd import SPATIAL_DIM, pairwise_ca_dist
from dfmdock_tpu_torch.models.edges import select_edges
from dfmdock_tpu_torch.models.egnn import EGCL, edge_stack
from dfmdock_tpu_torch.models.modules import (
    LN_EPS,
    TimeEmbed,
    compute_dtype,
    dropout,
    init_weights,
    linear,
    pair_energy_rows,
    time_tensor,
)
from dfmdock_tpu_torch.ops.energy_head import fused_energy, fused_energy_plain


class ScaleMLP(nn.Module):
    """score = unit(vec) * softplus(MLP([|vec|, t_emb]))."""

    def __init__(self, inner_dim: int):
        super().__init__()
        self.l0 = nn.Linear(inner_dim + 1, inner_dim, bias=False)
        self.ln = nn.LayerNorm(inner_dim, eps=LN_EPS)
        self.l1 = nn.Linear(inner_dim, 1, bias=False)

    def forward(self, vec: torch.Tensor, t_emb: torch.Tensor, drop: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """vec [P, 1, 3], t_emb [1 or P, inner] -> [P, 1, 3]; `drop` is the
        dropout rate after the LayerNorm (train mode), its mask drawn from
        `generator`."""
        norm = torch.sqrt((vec * vec).sum(-1, keepdim=True) + 1e-24)
        inp = torch.cat([norm, t_emb[:, None, :].expand(vec.shape[0], 1, -1)], -1)
        y = self.l1(F.silu(dropout(self.ln(self.l0(inp)), drop, generator)))
        return vec / (norm + 1e-6) * F.softplus(y)


def pose_scores(net, r, f, n_lig, t, drop: float = 0.0, generator=None) -> dict:
    """tr / rot scores from a force f [P, N, 3] (zero off the ligand) on the
    CAs r [P, N, 3]: the force and its torque summed, over n_lig, through
    the net's scale MLPs (`drop`: their dropout rate in training).
    Returns tr_score, rot_score [P, 1, 3] and f."""
    t_emb = net.t_embed(time_tensor(t, f.device))
    tr_pred = f.sum(-2, keepdim=True) / n_lig
    rot_pred = torch.linalg.cross(r, f, dim=-1).sum(-2, keepdim=True) / n_lig
    return {"tr_score": net.tr_scale(tr_pred, t_emb, drop, generator),
            "rot_score": net.rot_scale(rot_pred, t_emb, drop, generator), "f": f}


class ScoreNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = c = cfg
        self.single_embed = nn.Linear(c.lm_embed_dim, c.node_dim, bias=False)
        # [bins, edge_dim] lookup tables == Linear(bins -> edge_dim) weights
        self.spatial_embed = nn.Linear(SPATIAL_DIM, c.edge_dim, bias=False)
        self.positional_embed = nn.Linear(NUM_RELPOS_CLASSES, c.edge_dim, bias=False)
        self.egnn = nn.ModuleList(
            EGCL(c.node_dim, c.edge_dim, update_coords=(i == c.depth - 1))
            for i in range(c.depth)
        )
        self.to_energy = nn.ModuleDict({
            "l0": nn.Linear(2 * c.node_dim, c.node_dim, bias=False),
            "ln": nn.LayerNorm(c.node_dim, eps=LN_EPS),
            "l1": nn.Linear(c.node_dim, 1, bias=False),
        })
        self.to_ires = nn.ModuleDict({
            "l0": nn.Linear(c.node_dim, 2 * c.node_dim),
            "l1": nn.Linear(2 * c.node_dim, 2 * c.node_dim),
            "l2": nn.Linear(2 * c.node_dim, 1),
        })
        self.t_embed = TimeEmbed(c.inner_dim)
        self.tr_scale = ScaleMLP(c.inner_dim)
        self.rot_scale = ScaleMLP(c.inner_dim)

    def init_weights(self, generator: torch.Generator):
        init_weights(self, generator)
        return self

    def embed_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """h0 = single_embed(x); static across steps and poses, so the
        sampler computes it once per complex and passes batch['h0'].  Its
        product is cast as the forwards' (`compute_dtype`)."""
        return linear(x, self.single_embed.weight, dtype=compute_dtype(self.cfg))

    def prepare(self, batch: dict, static: bool = True) -> dict:
        """`batch` with what a sample's forwards share, made once a sample
        (inside a captured one): h0 (`static` is EGNNNet's)."""
        if "h0" in batch:
            return dict(batch)
        return {**batch, "h0": self.embed_nodes(batch["x"])}

    def forward(self, batch: dict, pos: torch.Tensor, t, *, generator=None,
                gumbel=None, edges=None, scores_only: bool = False) -> dict:
        """Predict-path forward.

        pos [P, N, 3, 3]; t a float in [0, 1], or a [P] tensor with one t
        per pose.  Edge sampling draws its
        Gumbel noise from `generator`, or takes `gumbel` [P, N, N], or the
        whole neighbour set `edges` = (idx, edge_mask) [P, N, K].

        Returns tr_score / rot_score [P, 1, 3] and f [P, N, 3]; unless
        `scores_only`, also energy [P], ires [P, N, 1], num_clashes [P]."""
        c = self.cfg
        node_mask, lig_mask = batch["node_mask"], batch["lig_mask"]
        valid = node_mask.to(torch.float32)
        lig_valid = lig_mask * valid
        rec_valid = (1.0 - lig_mask) * valid
        n_lig = lig_valid.sum().clamp(min=1.0)
        p, n = pos.shape[:2]

        if c.center_in_net:
            center = (pos[..., 1, :] * lig_valid[:, None]).sum(-2) / n_lig
            pos = pos - center[:, None, None, :]

        h0 = batch["h0"] if "h0" in batch else self.embed_nodes(batch["x"])
        h = h0.expand(p, n, h0.shape[-1])
        ca = pos[..., 1, :]
        dist = pairwise_ca_dist(pos)
        if edges is None:
            edges = select_edges(dist, node_mask, c.knn, c.sample_size,
                                 generator=generator, gumbel=gumbel)
        idx, edge_mask = edges
        h, coord_out = edge_stack(
            c, self.egnn, self.spatial_embed.weight.t(), self.positional_embed.weight.t(),
            batch, pos, h, idx, edge_mask, lig_valid, dtype=compute_dtype(c))

        # force from the coordinate update of ligand CAs -> tr/rot scores
        out = pose_scores(self, ca, (coord_out - ca) * lig_valid[:, None], n_lig, t)
        if scores_only:
            return out

        pair_valid = rec_valid[:, None] * lig_valid[None, :]
        out["energy"] = self._energy(h, pair_valid * (dist < c.cut_off))
        out["ires"] = self._ires(h)
        out["num_clashes"] = (pair_valid * (dist <= 3.0)).sum((-2, -1)).to(torch.int32)
        return out

    def apply_train(self, batch: dict, pos: torch.Tensor, t, *, generator=None,
                    gumbel=None, edges=None, dedx: bool = False,
                    return_energy: bool = False) -> dict | torch.Tensor:
        """Training forward (the JAX package's `apply(train=True)`): the
        eager path whatever `cfg.use_pallas` says (the kernels are
        inference-only on both sides), its products cast as
        `cfg.compute_dtype` says, dropout in the scale MLPs, the energy head
        in row chunks under activation checkpointing (the chunks draw
        nothing, so no RNG state is kept: a captured step may not read it).

        pos [P, N, 3, 3] and t (a float or a tensor) as `forward`; the edge
        noise, injected Gumbel noise or edges as there, the dropout masks
        from `generator`.  Returns tr_score, rot_score, f, energy, ires and,
        with `dedx`, dedx = -dE/dpos on the ligand CAs [P, N, 3], built so
        that a loss on it differentiates again (second order); with
        `return_energy` only the energy [P].

        dedx follows the JAX package's explicit chain rule: one backward
        through the backbone (pos -> h) from dE/dh, and dE/dh from the
        energy head's row chunks, each chunk's gradient written out by
        `pair_energy_rows` and recomputed under checkpointing, so the
        second-order backward holds one [chunk, N, C] pair block at a time
        and never the stack of all of them."""
        c = self.cfg
        node_mask, lig_mask = batch["node_mask"], batch["lig_mask"]
        valid = node_mask.to(torch.float32)
        lig_valid = lig_mask * valid
        rec_valid = (1.0 - lig_mask) * valid
        n_lig = lig_valid.sum().clamp(min=1.0)
        p, n = pos.shape[:2]
        if c.center_in_net:
            center = (pos[..., 1, :] * lig_valid[:, None]).sum(-2) / n_lig
            pos = pos - center.detach()[:, None, None, :]
        if dedx:
            pos = pos.detach().requires_grad_(True)
        dtype = compute_dtype(c)

        h = self.embed_nodes(batch["x"]).expand(p, n, -1)
        ca = pos[..., 1, :]
        dist = pairwise_ca_dist(pos).detach()
        if edges is None:
            edges = select_edges(dist, node_mask, c.knn, c.sample_size,
                                 generator=generator, gumbel=gumbel)
        idx, edge_mask = edges
        h, coord_out = edge_stack(
            c, self.egnn, self.spatial_embed.weight.t(), self.positional_embed.weight.t(),
            batch, pos, h, idx, edge_mask, lig_valid, fused=False, dtype=dtype)

        pair_mask = rec_valid[:, None] * lig_valid[None, :] * (dist < c.cut_off)
        if dedx:
            energy, g_h = self._energy_and_grad_h(h, pair_mask, dtype)
            (dpos,) = torch.autograd.grad(h, pos, g_h, create_graph=True)
        else:
            energy = self._energy_train(h, pair_mask, dtype)
        if return_energy:
            return energy

        r = ca.detach()
        out = pose_scores(self, r, (coord_out - r) * lig_valid[:, None], n_lig, t,
                          c.dropout, generator)
        out.update(energy=energy, ires=self._ires(h))
        if dedx:
            out["dedx"] = -dpos[..., 1, :] * lig_valid[:, None]
        return out

    def _energy_halves(self, h, dtype=None):
        """hr, hl [P, N, C] (the first Linear's h_i / h_j halves, their
        products cast to `dtype`) and the head's (LayerNorm weight, bias,
        last Linear's row)."""
        c = h.shape[-1]
        w = self.to_energy["l0"].weight  # [C, 2C]: h_i / h_j halves
        ln = self.to_energy["ln"]
        return (linear(h, w[:, :c], dtype=dtype), linear(h, w[:, c:], dtype=dtype),
                (ln.weight, ln.bias, self.to_energy["l1"].weight[0]))

    def _energy_train(self, h, pair_mask, dtype=None):
        """The energy [P] of `_energy` in row chunks, each recomputed in the
        backward (checkpointing) instead of keeping its [chunk, N, C]
        intermediates; the products cast to `dtype` where given."""
        hr, hl, head = self._energy_halves(h, dtype)
        chunk = min(ENERGY_ROW_CHUNK, h.shape[-2])
        num = sum(checkpoint(pair_energy_rows, hr[:, s : s + chunk], hl,
                             pair_mask[:, s : s + chunk], *head, dtype=dtype,
                             use_reentrant=False,
                             preserve_rng_state=False)
                  for s in range(0, h.shape[-2], chunk))
        return num / (pair_mask.sum((-2, -1)) + 1e-6)

    def _energy_and_grad_h(self, h, pair_mask, dtype=None):
        """The energy [P] and dE/dh [P, N, C]: each row chunk's gradient
        with respect to hr and hl taken inside its checkpointed region,
        then back through the first Linear's two halves in float32, as the
        JAX package's `_energy_and_grad_h` (its `g_hr @ w[:C].T`) whatever
        the compute dtype."""
        hr, hl, head = self._energy_halves(h, dtype)
        n, chunk = h.shape[-2], min(ENERGY_ROW_CHUNK, h.shape[-2])
        nums, g_hr, g_hl = [], [], 0.0
        for s in range(0, n, chunk):
            num_c, g_hr_c, g_hl_c, _ = checkpoint(
                pair_energy_rows, hr[:, s : s + chunk], hl, pair_mask[:, s : s + chunk],
                *head, None, None, True, dtype=dtype, use_reentrant=False,
                preserve_rng_state=False)
            nums.append(num_c)
            g_hr.append(g_hr_c)
            g_hl = g_hl + g_hl_c
        den = (pair_mask.sum((-2, -1)) + 1e-6)
        w = self.to_energy["l0"].weight
        c = h.shape[-1]
        g_h = (torch.cat(g_hr, -2) @ w[:, :c] + g_hl @ w[:, c:]) / den[:, None, None]
        return sum(nums) / den, g_h

    def _energy(self, h: torch.Tensor, pair_mask: torch.Tensor) -> torch.Tensor:
        """Masked mean of MLP(concat[h_i, h_j]) over receptor x ligand pairs,
        the first Linear split into its h_i / h_j halves; the kernel path
        through ops/energy_head, the eager path through its plain version
        (row chunks: [P, N, N, C] never materializes).  h [P, N, C],
        pair_mask [P, N, N] -> [P].  With bf16 products the halves are cast
        (`_energy_halves`), and on the eager route the training forward's
        chunks compute the rest, its last product cast too; the kernel
        route's ops/energy_head ports the JAX package's float32 Pallas head."""
        dtype = compute_dtype(self.cfg)
        if dtype is not None and not self.cfg.use_pallas:
            return self._energy_train(h, pair_mask, dtype)
        if dtype is None:
            c = h.shape[-1]
            w = self.to_energy["l0"].weight  # [C, 2C]: h_i / h_j halves
            hr = torch.matmul(h, w[:, :c].t())
            hl = torch.matmul(h, w[:, c:].t())
        else:
            hr, hl, _ = self._energy_halves(h, dtype)
        ln = self.to_energy["ln"]
        energy = fused_energy if self.cfg.use_pallas else fused_energy_plain
        return energy(hr.contiguous(), hl.contiguous(), pair_mask.contiguous(),
                      ln.weight, ln.bias, self.to_energy["l1"].weight[0])

    def _ires(self, h: torch.Tensor) -> torch.Tensor:
        p = self.to_ires
        return p["l2"](F.silu(p["l1"](F.silu(p["l0"](h)))))
