"""The DFMDock predict path's pair heads in three forms on a CUDA card.

    python3 scripts/torch_pair_heads_probe.py   # one CUDA card, ~1 min

- `receptor x ligand`: the port's form (`EGNNNet._pair_heads` over the
  batch's receptor and ligand row lists, `egnn_net.pair_rows`);
- `static`: the samplers' form (`pair_rows(batch, static=True)`: every
  row, receptor rows first, with the validity masks; a chunk of rows takes
  the columns from its own first row on, N^2 / 2 pairs);
- `masked N x N`: the JAX package's form (`dfmdock_tpu/models/egnn_net.py`,
  its predict scan): every row against every column in chunks of 64 rows,
  the pairs that are not receptor x ligand masked to 0.

Both on the trained weights (`ckpts/db5_holdout_dfmdock/weights.npz`),
chip_smoke's P poses of 1AVX at its native pose, the EGNN's output h
stood in by seeded values: the CUDA-event time of each (chip_smoke's
`time_ms`), and each one's outputs within rel 1e-5 of the first's (the
masked forms add pairs that are 0).
"""
from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dfmdock_tpu_torch.cli.common import load_model  # noqa: E402
from dfmdock_tpu_torch.config import DFMDockConfig  # noqa: E402
from dfmdock_tpu_torch.data.convert import load_npz_complex  # noqa: E402
from dfmdock_tpu_torch.data.dataset import batch_to_tensors, complex_to_batch  # noqa: E402
from dfmdock_tpu_torch.features.sixd import pairwise_ca_dist  # noqa: E402
from dfmdock_tpu_torch.models.egnn_net import ROW_CHUNK, pair_rows  # noqa: E402

REL = 1e-5


def masked_pair_heads(net, h, ca, dist, rec, lig):
    """The pair heads over all N x N pairs in chunks of ROW_CHUNK rows,
    under the receptor x ligand mask rec_i * lig_j (rec / lig [N] float):
    the outputs of `EGNNNet._pair_heads` (with scores_only False)."""
    p, n = h.shape[:2]
    pv = rec[:, None] * lig[None, :]
    heads = [net.to_force, net.to_energy, net.to_confidence]
    parts = [head.split(h, h) for head in heads]
    f = h.new_zeros(p, n, 3)
    e_num, e_den, c_num = h.new_zeros(p), h.new_zeros(p), h.new_zeros(p)
    for i0 in range(0, n, ROW_CHUNK):
        rows = slice(i0, i0 + ROW_CHUNK)
        d_c, pv_c = dist[:, rows], pv[rows]
        pre = lambda k: parts[k][0][:, rows, None, :] + parts[k][1][:, None, :, :]
        vec = ca[:, rows, None, :] - ca[:, None, :, :]
        unit = vec / torch.sqrt((vec * vec).sum(-1, keepdim=True).clamp(min=1e-12))
        f = f + (unit * net.to_force(pre(0), d_c) * pv_c[..., None]).sum(1)
        em = (d_c < net.cfg.cut_off).to(h.dtype) * pv_c
        e_num = e_num + (net.to_energy(pre(1), d_c)[..., 0] * em).sum((-2, -1))
        e_den = e_den + em.sum((-2, -1))
        c_num = c_num + (net.to_confidence(pre(2), d_c)[..., 0] * pv_c).sum((-2, -1))
    return {"f": f, "energy": (e_num, e_den), "confidence": (c_num, pv.sum()),
            "num_clashes": ((dist <= 3.0) * pv).sum((-2, -1)).to(torch.int32)}


def main(reps=10):
    if not torch.cuda.is_available():
        print("torch_pair_heads_probe: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.device_phase()
    device = torch.device("cuda")
    cfg = DFMDockConfig(model=cs.FAST_F32)
    net = load_model(cs.DFMDOCK_NPZ, cfg, device, lineage="dfmdock")
    batch = batch_to_tensors(complex_to_batch(load_npz_complex(cs.NPZ)), device)
    n = batch["pos"].shape[0]
    gen = torch.Generator(device).manual_seed(0)
    h = torch.randn(cs.P, n, cfg.model.node_dim, generator=gen, device=device)
    pos = batch["pos"][None].expand(cs.P, -1, -1, -1)
    ca, dist = pos[..., 1, :], pairwise_ca_dist(pos)
    valid = batch["node_mask"].float()
    lig = batch["lig_mask"] * valid
    rec = (1.0 - batch["lig_mask"]) * valid
    rec_idx, lig_idx = pair_rows(batch)
    forms = {"receptor x ligand": lambda: net._pair_heads(h, ca, dist, rec_idx, lig_idx,
                                                          rec.sum() * lig.sum(), False),
             "masked N x N": lambda: masked_pair_heads(net, h, ca, dist, rec, lig)}
    order, _, rec_s, lig_s = pair_rows(batch, static=True)
    forms["static"] = lambda: net._pair_heads(h, ca, dist, order, order, rec.sum() * lig.sum(),
                                              False, (rec_s, lig_s))
    outs, ms = {}, {}
    with torch.no_grad():
        for name, run in forms.items():
            outs[name] = run()
            ms[name] = cs.time_ms(run, reps=3, inner=reps)
    ref = outs["receptor x ligand"]
    for name, out in outs.items():
        for k in ref:
            for x, y in zip(*((v,) if torch.is_tensor(v) else v for v in (out[k], ref[k]))):
                if (x.double() - y.double()).abs().max() > REL * y.double().abs().max():
                    raise AssertionError(f"pair heads: {k} of the {name} form differs")
    cs.log(f"# DFMDock pair heads (P={cs.P}, 1AVX, N={n}, trained weights, outputs within "
           f"rel {REL}): receptor x ligand ({rec_idx.numel()} x {lig_idx.numel()}) "
           f"{ms['receptor x ligand']:.3f} ms, masked N x N ({n} x {n}) "
           f"{ms['masked N x N']:.3f} ms, ratio "
           f"{ms['masked N x N'] / ms['receptor x ligand']:.2f}; static ({n} rows, "
           f"N^2 / 2 pairs) {ms['static']:.3f} ms, ratio "
           f"{ms['static'] / ms['receptor x ligand']:.2f}; card {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
