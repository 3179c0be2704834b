"""Dock one preprocessed complex: the port of `python -m dfmdock_tpu.cli.dock --npz`.

All poses run batched through the reverse SDE; the minimum-energy pose is
written as a PDB and every pose's metrics as a CSV row.

  python -m dfmdock_tpu_torch.cli.dock --npz data/db5_npz/1AVX.npz --num-samples 16

By default the EGCL stack runs through the CUDA kernels on `cuda`;
`--exact` selects the eager float32 path and `--device cpu` the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dfmdock_tpu_torch.cli.common import (
    build_sampler,
    dock_complex,
    load_model,
    resolve_device,
    write_csv,
)
from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, SamplerConfig
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.data.pdb_io import get_full_coords, save_pdb
from dfmdock_tpu_torch.sampler import EMSampler


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--npz", required=True, help="preprocessed complex npz")
    ap.add_argument("--ckpt", default=None,
                    help="weights as a flat-dict .npz (params.py); default: "
                         "seeded random weights")
    ap.add_argument("--out-dir", default="./out")
    ap.add_argument("--out-csv", default="metrics.csv")
    ap.add_argument("--num-samples", type=int, default=16)
    ap.add_argument("--num-steps", type=int, default=40)
    ap.add_argument("--tr-noise-scale", type=float, default=0.5)
    ap.add_argument("--rot-noise-scale", type=float, default=0.5)
    ap.add_argument("--noise-annealing", action="store_true")
    ap.add_argument("--ode", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--write-all-poses", action="store_true")
    ap.add_argument("--exact", action="store_true",
                    help="eager float32 path (default: the CUDA kernels)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = DFMDockConfig(
        model=ModelConfig() if args.exact else ModelConfig.fast(),
        sampler=SamplerConfig(
            num_steps=args.num_steps,
            tr_noise_scale=args.tr_noise_scale,
            rot_noise_scale=args.rot_noise_scale,
            noise_annealing=args.noise_annealing,
            ode=args.ode,
        ),
    )
    sampler = build_sampler(load_model(args.ckpt, cfg, device), cfg)
    os.makedirs(args.out_dir, exist_ok=True)

    job = load_npz_complex(args.npz)
    job["id"] = os.path.splitext(os.path.basename(args.npz))[0]
    generator = torch.Generator(device).manual_seed(args.seed)
    rows, results, (R, L) = dock_complex(
        sampler, job, generator, args.num_samples, device,
        native=(job["rec_pos"], job["lig_pos"]),
    )
    best = EMSampler.rank_by_energy({"energy": torch.from_numpy(results["energy"])})
    pos = results["pos"]
    for i in range(args.num_samples) if args.write_all_poses else [best]:
        coords = np.concatenate([pos[i, :R], pos[i, R : R + L]])
        save_pdb(os.path.join(args.out_dir, f"{job['id']}_{i}.pdb"),
                 get_full_coords(coords), job["rec_seq"] + job["lig_seq"], delim=R - 1)
    print(f"{job['id']}: best pose {best} energy {rows[best]['energy']:.4f} "
          f"DockQ {rows[best]['DockQ']:.3f}")
    write_csv(os.path.join(args.out_dir, args.out_csv), rows)
    print(f"wrote {os.path.join(args.out_dir, args.out_csv)}")
    return rows


if __name__ == "__main__":
    main()
