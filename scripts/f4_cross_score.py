"""ROADMAP F4, one step: does the DFMDock lineage's pick-mean gap lie in the
ranking (the energies) or in the sampling (the final poses)?

    python3 scripts/f4_cross_score.py --side jax --out-dir DIR        # CPU, imports JAX
    python3 scripts/f4_cross_score.py --side port-cuda --out-dir DIR  # a CUDA card
    python3 scripts/f4_cross_score.py --score DIR                     # CPU, imports JAX

The sides write the final poses of the DFMDock training-set sweep (1AVX,
1ZHI, 2SNI, 4POU; 40 poses, 40-step EM, seed 5, the 128-residue bucket):
- `jax`: the JAX package's sweep with the record's settings (bfloat16
  compute, no Pallas, each complex the key eval_train.csv's run gave it:
  scripts/dfmdock_witness.py's jax-bf16 side), from the orbax step;
- `port-cuda`: the port's sweep through the kernels (cli/sweep.py's loop
  and generator), from weights.npz.
Each writes DIR/{side}_{id}.npz: pos [P, N, 3, 3], the sweep's own energy
[P] and DockQ [P].

`--score` scores both pose sets with both nets in float32 at t = eps: the
JAX package's EGNNNet (f32 XLA, the orbax step) and the port's DFMDockModel
(eager f32 on the CPU, weights.npz), on the same edges: one select_edges
draw per complex and pose set, injected into both.  It prints, per complex
and pose set, the largest energy difference between the two nets relative
to the largest energy, and the pick mean of each (pose set, scorer) pair.
The JAX side takes ~25 min on the CPU; the scoring a few minutes.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

CKPT = os.path.join(ROOT, "ckpts", "db5_holdout_dfmdock")
DATA = os.path.join(ROOT, "data", "db5_npz")
IDS = ("1AVX", "1ZHI", "2SNI", "4POU")  # the record sweep's ids, in its order
SEED, POSES, STEPS, BUCKET, EPS_T = 5, 40, 40, 128, 1e-3


def jax_side(out_dir):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dfmdock_tpu.cli.common import build_sampler, dock_complex, load_model, make_runner
    from dfmdock_tpu.config import DFMDockConfig, ModelConfig, SamplerConfig
    from dfmdock_tpu.data.batching import round_up
    from dfmdock_tpu.data.dataset import NPZDataset

    cfg = DFMDockConfig(model=ModelConfig(compute_dtype="bfloat16"),
                        sampler=SamplerConfig(num_steps=STEPS))
    net, params = load_model(os.path.join(CKPT, "last"), cfg, lineage="dfmdock")
    sampler = build_sampler(net, cfg)
    run_fn = make_runner(sampler, POSES)
    ds = NPZDataset(DATA)
    key = jax.random.PRNGKey(SEED)
    for cid in IDS:
        key, sub = jax.random.split(key)
        raw = ds.load_raw(ds.ids.index(cid))
        n = raw["rec_x"].shape[0] + raw["lig_x"].shape[0]
        recs, results, _ = dock_complex(sampler, params, raw, sub, POSES,
                                        native=(raw["rec_pos"], raw["lig_pos"]),
                                        pad_to=round_up(n, BUCKET), run_fn=run_fn)
        save(out_dir, "jax", cid, np.asarray(results["pos"]), recs)


def port_side(out_dir):
    import torch

    from dfmdock_tpu_torch.cli.common import build_sampler, dock_complex, load_model
    from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, SamplerConfig
    from dfmdock_tpu_torch.data.batching import round_up
    from dfmdock_tpu_torch.data.dataset import NPZDataset

    device = torch.device("cuda")
    cfg = DFMDockConfig(model=ModelConfig.fast(compute_dtype="float32"),
                        sampler=SamplerConfig(num_steps=STEPS))
    net = load_model(os.path.join(CKPT, "weights.npz"), cfg, device, lineage="dfmdock")
    sampler = build_sampler(net, cfg)
    ds = NPZDataset(DATA)
    generator = torch.Generator(device).manual_seed(SEED)  # as cli/sweep.py
    for cid in IDS:
        raw = ds.load_raw(ds.ids.index(cid))
        n = raw["rec_x"].shape[0] + raw["lig_x"].shape[0]
        recs, results, _ = dock_complex(sampler, raw, generator, POSES, device,
                                        native=(raw["rec_pos"], raw["lig_pos"]),
                                        pad_to=round_up(n, BUCKET))
        save(out_dir, "port-cuda", cid, results["pos"], recs)


def save(out_dir, side, cid, pos, recs):
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{side}_{cid}.npz"), pos=pos,
             energy=np.array([r["energy"] for r in recs]),
             dockq=np.array([r["DockQ"] for r in recs]))
    print(f"{side} {cid}: mean DockQ {np.mean([r['DockQ'] for r in recs]):.4f}", flush=True)


def score(out_dir):
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    import dfmdock_tpu.models.egnn_net as jax_egnn_net
    from dfmdock_tpu.cli.common import load_model as jax_load_model
    from dfmdock_tpu.config import DFMDockConfig as JaxConfig
    from dfmdock_tpu_torch.cli.common import load_model
    from dfmdock_tpu_torch.config import DFMDockConfig
    from dfmdock_tpu_torch.data.dataset import NPZDataset, batch_to_tensors, complex_to_batch
    from dfmdock_tpu_torch.features.sixd import pairwise_ca_dist
    from dfmdock_tpu_torch.models.edges import select_edges

    jnet, params = jax_load_model(os.path.join(CKPT, "last"), JaxConfig(), lineage="dfmdock")
    pnet = load_model(os.path.join(CKPT, "weights.npz"), DFMDockConfig(), torch.device("cpu"),
                      lineage="dfmdock")
    edges = {}

    def patched(*args, **kwargs):
        return edges["now"]

    jax_egnn_net.select_edges_dispatch = patched

    @jax.jit
    def jax_energy(batch, idx, mask):
        edges["now"] = (idx, mask)  # read while tracing
        return jnet.apply(params, batch, jax.random.PRNGKey(0), predict=True)["energy"]

    ds = NPZDataset(DATA)
    sides = sorted({os.path.basename(p).split("_")[0]
                    for p in glob.glob(os.path.join(out_dir, "*_*.npz"))})
    picks = {}
    for side in sides:
        for cid in IDS:
            z = np.load(os.path.join(out_dir, f"{side}_{cid}.npz"))
            pos = torch.from_numpy(z["pos"]).float()
            raw = ds.load_raw(ds.ids.index(cid))
            b_np = complex_to_batch(raw, pad_to=pos.shape[1])
            batch = batch_to_tensors(b_np, torch.device("cpu"))
            gen = torch.Generator().manual_seed(SEED)
            idx, mask = select_edges(pairwise_ca_dist(pos), batch["node_mask"], generator=gen)
            with torch.no_grad():
                e_port = pnet(batch, pos, EPS_T, edges=(idx, mask))["energy"].numpy()
            e_jax = np.array([float(jax_energy(
                {**{k: jnp.asarray(v) for k, v in b_np.items()}, "pos": jnp.asarray(z["pos"][i]),
                 "t": jnp.float32(EPS_T)}, jnp.asarray(idx[i].numpy()), jnp.asarray(mask[i].numpy())))
                for i in range(pos.shape[0])])
            rel = np.abs(e_port - e_jax).max() / np.abs(e_jax).max()
            dq = z["dockq"]
            row = {"sweep": dq[np.argmin(z["energy"])], "jax": dq[np.argmin(e_jax)],
                   "port": dq[np.argmin(e_port)]}
            for k, v in row.items():
                picks.setdefault((side, k), []).append(v)
            same = int(np.argmin(e_jax) == np.argmin(e_port))
            print(f"{side} poses, {cid}: energy rel diff port vs JAX {rel:.3e}; picks by the "
                  f"sweep's energy {row['sweep']:.3f}, JAX f32 {row['jax']:.3f}, port f32 "
                  f"{row['port']:.3f} (same pose {bool(same)}); mean DockQ {dq.mean():.4f}",
                  flush=True)
    for (side, scorer), v in sorted(picks.items()):
        print(f"pick mean, {side} poses ranked by the {scorer} energy: {np.mean(v):.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--side", choices=["jax", "port-cuda"])
    ap.add_argument("--out-dir")
    ap.add_argument("--score", metavar="DIR")
    args = ap.parse_args(argv)
    if args.score:
        score(args.score)
    elif args.side == "jax":
        jax_side(args.out_dir)
    elif args.side == "port-cuda":
        port_side(args.out_dir)
    else:
        ap.error("give --side or --score")


if __name__ == "__main__":
    main()
