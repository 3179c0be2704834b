"""EGNNNet: the DFMDock-lineage score network, predict path, batched over poses.

Mirrors `dfmdock_tpu/models/egnn_net.py` (`EGNNNet.apply(predict=True)`) on
the port's pose batches: poses ride a leading [P] dimension and share one
padded complex, as in `score_net.ScoreNet`.  Against the mlsb ScoreNet:

- the EGNN never moves coordinates: all `depth` layers are agg-only (no
  `coord_mlp`), so the kernel path runs only ops/fused_egcl's agg kernel;
- the force comes from a per-pair scalar head over receptor x ligand pairs,
  f_j = sum_i unit(ca_i - ca_j) * MLP([h_i, h_j, D_ij]) over receptor rows
  i, divided by the receptor count with agg="mean";
- pair heads for the energy (masked to D < cut_off) and the confidence
  logit, the node-level interface head `to_ires`; the distogram head
  `to_dist` runs in training only, where its loss is computed inside the
  row-chunk loop (`apply_train(gt_dist=...)`).

The pair heads run over one row-chunked scan, each head's first Linear
pre-split into h_i W[:C] + h_j W[C:2C] + D W[2C], so [P, R, L, C] never
materializes.  The scan covers receptor rows x ligand columns only: every
other pair of the JAX scan over all N x N is masked to exactly 0, so the
sums are the same up to their order (the JAX scan adds 64-row chunks of
all N rows; here 64-row chunks of the receptor rows).  The rows come as
index lists (`pair_rows`), whose lengths `torch.nonzero` reads from the
device (a host sync), or in their static form, which a sample on the
capturing device (CUDA) makes once (`prepare`, as h0, inside a captured
sample; the CPU's eager samples take the exact lists): every row in one order,
receptor rows first and then ligand rows, with the two validity masks.
Its shapes are the padded N's, so one captured sample serves every complex
of a bucket; its scan takes the pairs whose column comes at or after the
row chunk's first row in that order (every receptor x ligand pair, as a
ligand row sorts after every receptor row), about N^2 / 2 pairs, the rest
masked to 0.  D and the cutoff masks are the CA distances of the
(detached) input pose.

The net does not centre its input; `dfmdock.DFMDockModel` does.

`apply_train` is the training forward (the JAX package's `apply(train=True)`
with `_core`'s scan over all N rows, masked to receptor x ligand pairs):
eager, the node embedding and the EGNN's products cast as
`cfg.compute_dtype` says (the pair heads stay float32, as in the JAX
package; the predict forward casts alike on either route, the kernel
route's ops/fused_egcl in its single-pass bf16 mode), dropout in
the scale MLPs, the pair heads and the distogram
loss in checkpointed row chunks, and dedx = -dE/dpos through the explicit
chain rule of `ScoreNet.apply_train`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dfmdock_tpu_torch.config import ModelConfig
from dfmdock_tpu_torch.features.positional import NUM_RELPOS_CLASSES
from dfmdock_tpu_torch.features.sixd import SPATIAL_DIM, pairwise_ca_dist
from dfmdock_tpu_torch.models.edges import select_edges
from dfmdock_tpu_torch.models.egnn import EGCL, edge_stack
from dfmdock_tpu_torch.models.modules import (
    LN_EPS,
    TimeEmbed,
    compute_dtype,
    init_weights,
    linear,
    pair_energy_rows,
)
from dfmdock_tpu_torch.models.score_net import ScaleMLP, pose_scores

ROW_CHUNK = 64
NUM_DIST_BINS = 64  # distogram head


def pair_rows(batch: dict, static: bool = False):
    """(rec_idx [R], lig_idx [L]): the valid receptor and ligand rows of a
    padded complex, in ascending order; torch.nonzero reads their counts
    from the device (a host sync).  With `static`, (order [N], order, rec
    [N], lig [N]): every row, the valid receptor rows first, then the valid
    ligand rows, then the rest, each group ascending, as both lists, and the
    receptor and ligand masks in that order (float32), made without a host
    sync."""
    valid = batch["node_mask"].to(torch.float32)
    lig = batch["lig_mask"] * valid
    rec = (1.0 - batch["lig_mask"]) * valid
    if not static:
        return torch.nonzero(rec > 0).squeeze(-1), torch.nonzero(lig > 0).squeeze(-1)
    group = torch.where(rec > 0, 0, torch.where(lig > 0, 1, 2))
    order = torch.argsort(group, stable=True)
    return order, order, rec[order], lig[order]


class PairHead(nn.Module):
    """MLP over the interaction [h_i, h_j, D_ij] (2C + 1 inputs)."""

    def __init__(self, node_dim: int, out_dim: int):
        super().__init__()
        self.l0 = nn.Linear(2 * node_dim + 1, node_dim, bias=False)
        self.ln = nn.LayerNorm(node_dim, eps=LN_EPS)
        self.l1 = nn.Linear(node_dim, out_dim, bias=False)

    def split(self, h_i: torch.Tensor, h_j: torch.Tensor):
        """The first Linear's h_i and h_j parts: (h_i W[:C], h_j W[C:2C])."""
        c = h_i.shape[-1]
        w = self.l0.weight  # [C, 2C + 1]
        return h_i @ w[:, :c].t(), h_j @ w[:, c : 2 * c].t()

    def forward(self, pre: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """pre [..., C] = the split parts summed, d [...] the distance."""
        y = pre + d[..., None] * self.l0.weight[:, -1]
        return self.l1(F.silu(self.ln(y)))


class EGNNNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = c = cfg
        self.single_embed = nn.Linear(c.lm_embed_dim, c.node_dim, bias=False)
        self.spatial_embed = nn.Linear(SPATIAL_DIM, c.edge_dim, bias=False)
        self.positional_embed = nn.Linear(NUM_RELPOS_CLASSES, c.edge_dim, bias=False)
        self.egnn = nn.ModuleList(
            EGCL(c.node_dim, c.edge_dim, update_coords=False) for _ in range(c.depth))
        self.to_energy = PairHead(c.node_dim, 1)
        self.to_force = PairHead(c.node_dim, 1)
        self.to_dist = PairHead(c.node_dim, NUM_DIST_BINS)
        self.to_confidence = PairHead(c.node_dim, 1)
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
        """h0 = single_embed(x); the sampler hoists it (batch['h0']).  Its
        product is cast as the forwards' (`compute_dtype`)."""
        return linear(x, self.single_embed.weight, dtype=compute_dtype(self.cfg))

    def prepare(self, batch: dict, static: bool = True) -> dict:
        """`batch` with what a sample's forwards share, made once a sample
        (inside a captured one): h0 and the pair rows, in their static form
        where the sample may be captured (`static`; the samplers ask for it
        on the device they capture on, eager samples there included, so
        that the two are bit-equal), else the exact lists."""
        batch = dict(batch)
        if "h0" not in batch:
            batch["h0"] = self.embed_nodes(batch["x"])
        if "pair_rows" not in batch:
            batch["pair_rows"] = pair_rows(batch, static=static)
        return batch

    def forward(self, batch: dict, pos: torch.Tensor, t, *, generator=None,
                gumbel=None, edges=None, scores_only: bool = False) -> dict:
        """Predict-path forward, the contract of `ScoreNet.forward`.

        pos [P, N, 3, 3]; t a float, or a [P] tensor with one t per pose;
        edges from `generator`, injected Gumbel noise `gumbel` [P, N, N] or
        the neighbour set `edges` = (idx, edge_mask) [P, N, K].

        Returns tr_score / rot_score [P, 1, 3] and f [P, N, 3]; unless
        `scores_only` (then only the force head runs), also energy [P],
        ires_logits [P, N, 1], confidence_logits [P], num_clashes [P]."""
        c = self.cfg
        node_mask, lig_mask = batch["node_mask"], batch["lig_mask"]
        valid = node_mask.to(torch.float32)
        lig_valid = lig_mask * valid
        rec_valid = (1.0 - lig_mask) * valid
        p, n = pos.shape[:2]

        h0 = batch["h0"] if "h0" in batch else self.embed_nodes(batch["x"])
        h = h0.expand(p, n, h0.shape[-1])
        ca = pos[..., 1, :]
        dist = pairwise_ca_dist(pos)
        if edges is None:
            edges = select_edges(dist, node_mask, c.knn, c.sample_size,
                                 generator=generator, gumbel=gumbel)
        idx, edge_mask = edges
        h, _ = edge_stack(
            c, self.egnn, self.spatial_embed.weight.t(), self.positional_embed.weight.t(),
            batch, pos, h, idx, edge_mask, lig_valid, dtype=compute_dtype(c))

        rows = batch["pair_rows"] if "pair_rows" in batch else pair_rows(batch)
        rec_idx, lig_idx, *masks = rows
        heads = self._pair_heads(h, ca, dist, rec_idx, lig_idx,
                                 rec_valid.sum() * lig_valid.sum(), scores_only, masks or None)
        if c.agg == "mean":
            f = heads["f"] / rec_valid.sum().clamp(min=1.0)
            n_lig = lig_valid.sum().clamp(min=1.0)
        else:
            f, n_lig = heads["f"], 1.0
        out = pose_scores(self, ca, f, n_lig, t)
        if scores_only:
            return out
        e_num, e_den = heads["energy"]
        out["energy"] = e_num / e_den.clamp(min=1.0) if c.agg == "mean" else e_num
        c_num, c_den = heads["confidence"]
        out["confidence_logits"] = c_num / c_den.clamp(min=1.0)
        out["ires_logits"] = self._ires(h)
        out["num_clashes"] = heads["num_clashes"]
        return out

    def apply_train(self, batch: dict, pos: torch.Tensor, t, *, generator=None,
                    gumbel=None, edges=None, dedx: bool = False,
                    return_energy: bool = False, gt_dist=None) -> dict | torch.Tensor:
        """Training forward; the contract of `ScoreNet.apply_train`, on
        coordinates the caller has centred.  `gt_dist` [P, N, N] (the
        ground-truth CA distances) adds the masked distogram cross-entropy
        as `dist_loss`.  Returns tr_score, rot_score, f, energy,
        ires_logits, confidence_logits (and dist_loss, dedx), or with
        `return_energy` the energy [P] alone.  D and the cutoff masks are
        detached from the coordinates, as in the reference, so dedx flows
        through the EGNN's coordinate use only."""
        c = self.cfg
        node_mask, lig_mask = batch["node_mask"], batch["lig_mask"]
        valid = node_mask.to(torch.float32)
        lig_valid = lig_mask * valid
        rec_valid = (1.0 - lig_mask) * valid
        p, n = pos.shape[:2]
        if dedx:
            pos = pos.detach().requires_grad_(True)
        h = self.embed_nodes(batch["x"]).expand(p, n, -1)
        ca = pos[..., 1, :]
        dist = pairwise_ca_dist(pos).detach()
        if edges is None:
            edges = select_edges(dist, node_mask, c.knn, c.sample_size,
                                 generator=generator, gumbel=gumbel)
        idx, edge_mask = edges
        h, _ = edge_stack(
            c, self.egnn, self.spatial_embed.weight.t(), self.positional_embed.weight.t(),
            batch, pos, h, idx, edge_mask, lig_valid, fused=False,
            dtype=compute_dtype(c))

        pair_valid = rec_valid[:, None] * lig_valid[None, :]
        energy_mask = pair_valid * (dist < c.cut_off)
        e_den = (energy_mask.sum((-2, -1)).clamp(min=1.0)[:, None, None] if c.agg == "mean"
                 else torch.ones(1, 1, 1, device=h.device))
        if dedx:
            e_num, g_h = self._energy_and_grad_h(h, dist, energy_mask)
            energy = e_num / e_den[:, 0, 0]
            (dpos,) = torch.autograd.grad(h, pos, g_h / e_den, create_graph=True)
        heads = self._pair_heads_train(h, ca, dist, pair_valid, energy_mask, gt_dist,
                                       energy=not dedx, only_energy=return_energy)
        if not dedx:
            energy = heads["e_num"] / e_den[:, 0, 0]
        if return_energy:
            return energy

        den = pair_valid.sum().clamp(min=1.0)
        if c.agg == "mean":
            f = heads["f"] / rec_valid.sum().clamp(min=1.0) * lig_valid[:, None]
            n_lig = lig_valid.sum().clamp(min=1.0)
        else:
            f, n_lig = heads["f"] * lig_valid[:, None], 1.0
        out = pose_scores(self, ca.detach(), f, n_lig, t, c.dropout, generator)
        out.update(energy=energy, ires_logits=self._ires(h),
                   confidence_logits=heads["c_num"] / den)
        if gt_dist is not None:
            out["dist_loss"] = heads["d_num"] / den
        if dedx:
            out["dedx"] = -dpos[..., 1, :] * lig_valid[:, None]
        return out

    def _pair_heads_train(self, h, ca, dist, pair_valid, energy_mask, gt_dist, energy,
                          only_energy):
        """The pair heads over all N x N pairs in ROW_CHUNK-row chunks, each
        chunk recomputed in the backward (checkpointing): the force summed
        over receptor rows f [P, N, 3], and the masked sums e_num (with
        `energy`), c_num and d_num (with gt_dist) [P].  `only_energy`
        evaluates the energy head alone."""
        heads = {"energy": self.to_energy} if only_energy else {
            "force": self.to_force, "confidence": self.to_confidence,
            **({"energy": self.to_energy} if energy else {}),
            **({"dist": self.to_dist} if gt_dist is not None else {})}
        parts = {k: head.split(h, h) for k, head in heads.items()}
        bounds = torch.linspace(3.25, 50.75, NUM_DIST_BINS - 1, device=h.device) ** 2

        def rows(s, d_c, em_c, pv_c, ca_c, gt_c, parts):
            pre = {k: v[0][:, s : s + d_c.shape[-2], None, :] + v[1][:, None]
                   for k, v in parts.items()}
            out = {}
            if "energy" in heads:
                out["e_num"] = (self.to_energy(pre["energy"], d_c)[..., 0] * em_c).sum((-2, -1))
            if only_energy:
                return out
            fs = self.to_force(pre["force"], d_c)  # [P, c, N, 1]
            vec = ca_c[:, :, None, :] - ca[:, None, :, :]  # rec_i - lig_j
            unit = vec / torch.sqrt((vec * vec).sum(-1, keepdim=True).clamp(min=1e-12))
            out["f"] = (unit * fs * pv_c[..., None]).sum(-3)
            out["c_num"] = (self.to_confidence(pre["confidence"], d_c)[..., 0]
                            * pv_c).sum((-2, -1))
            if gt_c is not None:
                logits = self.to_dist(pre["dist"], d_c)  # [P, c, N, 64]
                true_bins = (gt_c[..., None] ** 2 > bounds).sum(-1)
                ce = -torch.log_softmax(logits, -1).gather(-1, true_bins[..., None])[..., 0]
                out["d_num"] = (ce * pv_c).sum((-2, -1))
            return out

        total = {}
        n = h.shape[-2]
        for s in range(0, n, ROW_CHUNK):
            e = slice(s, s + ROW_CHUNK)
            gt_c = None if gt_dist is None else gt_dist[:, e]
            # the chunks draw nothing: no RNG state to keep (a captured step
            # may not read it)
            out = checkpoint(rows, s, dist[:, e], energy_mask[:, e], pair_valid[e],
                             ca[:, e], gt_c, parts, use_reentrant=False,
                             preserve_rng_state=False)
            for k, v in out.items():
                total[k] = total[k] + v if k in total else v
        return total

    def _energy_and_grad_h(self, h, dist, energy_mask):
        """The energy head's masked sum [P] and its gradient with respect to
        h [P, N, C]: each row chunk's gradient taken inside its checkpointed
        region (`pair_energy_rows`), then back through the first Linear's
        h_i / h_j parts (JAX `_energy_and_grads`; D is detached, so its
        gradient is not needed)."""
        head = self.to_energy
        c = h.shape[-1]
        w = head.l0.weight  # [C, 2C + 1]
        eh_i, eh_j = head.split(h, h)
        args = (head.ln.weight, head.ln.bias, head.l1.weight[0])
        nums, g_i, g_j = [], [], 0.0
        for s in range(0, h.shape[-2], ROW_CHUNK):
            e = slice(s, s + ROW_CHUNK)
            num_c, g_i_c, g_j_c, _ = checkpoint(
                pair_energy_rows, eh_i[:, e], eh_j, energy_mask[:, e], *args,
                dist[:, e], w[:, -1], True, use_reentrant=False,
                preserve_rng_state=False)
            nums.append(num_c)
            g_i.append(g_i_c)
            g_j = g_j + g_j_c
        g_h = torch.cat(g_i, -2) @ w[:, :c] + g_j @ w[:, c : 2 * c]
        return sum(nums), g_h

    def _pair_heads(self, h, ca, dist, rec_idx, lig_idx, n_pairs, scores_only, masks=None):
        """The pair heads over receptor rows x ligand columns (`pair_rows`),
        in chunks of ROW_CHUNK rows; n_pairs the pairs' count (a 0-d
        tensor).  With `masks` (the static form's (rec, lig); both lists the
        one order) a chunk of rows i0.. takes the columns i0.., each pair
        masked to receptor x ligand.  Returns f [P, N, 3] (the force summed
        over receptor rows, on ligand rows; 0 elsewhere) and, unless
        `scores_only`, the energy's masked sum and count [P], the
        confidence's sum [P] and count, and num_clashes [P]."""
        static = masks is not None
        p, n = h.shape[:2]
        h_l, ca_l = h[:, lig_idx], ca[:, lig_idx]
        d_rl = dist[:, rec_idx][:, :, lig_idx]  # [P, R, L]
        heads = [self.to_force] + ([] if scores_only else [self.to_energy, self.to_confidence])
        parts = [head.split(h[:, rec_idx], h_l) for head in heads]
        f_acc = h.new_zeros(p, lig_idx.numel(), 3)
        e_num = h.new_zeros(p)
        e_den = h.new_zeros(p)
        c_num = h.new_zeros(p)
        for i0 in range(0, rec_idx.numel(), ROW_CHUNK):
            r = slice(i0, i0 + ROW_CHUNK)
            c = slice(i0 if static else 0, None)
            mask = masks[0][r, None] * masks[1][None, c] if static else 1.0  # [chunk, L]
            d_c = d_rl[:, r, c]  # [P, chunk, L]
            pre = lambda k: parts[k][0][:, r, None, :] + parts[k][1][:, None, c, :]
            fs = self.to_force(pre(0), d_c)  # [P, chunk, L, 1]
            vec = ca[:, rec_idx[r], None, :] - ca_l[:, None, c, :]  # rec_i - lig_j
            unit = vec / torch.sqrt((vec * vec).sum(-1, keepdim=True).clamp(min=1e-12))
            if static:
                f_acc[:, c] += (unit * (fs * mask[..., None])).sum(1)
            else:
                f_acc = f_acc + (unit * fs).sum(1)
            if not scores_only:
                em = (d_c < self.cfg.cut_off).to(h.dtype) * mask
                e_num = e_num + (self.to_energy(pre(1), d_c)[..., 0] * em).sum((-2, -1))
                e_den = e_den + em.sum((-2, -1))
                c_num = c_num + (self.to_confidence(pre(2), d_c)[..., 0] * mask).sum((-2, -1))
        f = h.new_zeros(p, n, 3)
        f[:, lig_idx] = f_acc
        out = {"f": f}
        if not scores_only:
            clash = d_rl <= 3.0
            if static:
                clash = clash & (masks[0][:, None] * masks[1][None, :] > 0)
            out["energy"] = (e_num, e_den)
            out["confidence"] = (c_num, n_pairs)
            out["num_clashes"] = clash.sum((-2, -1)).to(torch.int32)
        return out

    def _ires(self, h: torch.Tensor) -> torch.Tensor:
        p = self.to_ires
        return p["l2"](F.silu(p["l1"](F.silu(p["l0"](h)))))
