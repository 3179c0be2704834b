"""Dock complexes: the port of `python -m dfmdock_tpu.cli.dock`.

Inputs: a preprocessed --npz complex (it carries its ESM embeddings), two
PDB files (--pdb REC LIG; ESM2 from a locally cached HuggingFace model, or
zeros with --one-hot-only), or a --csv of (id, input1, input2) rows, each a
npz (input2 unused) or a PDB pair.  All poses of a complex run batched
through the reverse SDE; its best pose is written as a PDB and every pose's
metrics (DockQ against the input structure) as a CSV row.  With
--picard-iters the probability-flow ODE is solved by Picard iteration
(sampler/picard.py).  Poses are ranked by their final energy, or
(--rank-by) by the mean over --energy-draws edge-sampling draws of energy,
icons or snorm, or by the learned linear re-ranker over a grid of those
scores (ckpts/db5_cv/reranker.md).

  python -m dfmdock_tpu_torch.cli.dock --npz data/db5_npz/1AVX.npz --num-samples 16
  python -m dfmdock_tpu_torch.cli.dock --pdb rec.pdb lig.pdb --one-hot-only
  python -m dfmdock_tpu_torch.cli.dock --csv pairs.csv --out-dir out/
  python -m dfmdock_tpu_torch.cli.dock --npz data/db5_npz/1AVX.npz --rank-by reranker
  python -m dfmdock_tpu_torch.cli.dock --npz data/db5_npz/1AVX.npz \
      --ckpt ckpts/db5_demo/weights.npz --num-samples 1 --picard-iters 10
  python -m dfmdock_tpu_torch.cli.dock --npz data/db5_npz/1AVX.npz --dp
  python -m dfmdock_tpu_torch.cli.dock --npz data/db5_npz/1QA9.npz --dp \
      --device cpu --world-size 2 --num-samples 4

By default the forward runs through the CUDA kernels on `cuda` in bf16
(`ModelConfig.fast()`, the JAX dock's default); `--exact` selects the eager
float32 path and `--device cpu` the CPU.  `main(argv,
model=ModelConfig.fast(compute_dtype="float32"))` runs the float32 kernel
route.
`--dp` splits the poses over the ranks of torch.distributed
(parallel/mesh.py): one NCCL rank per visible GPU, or `--world-size` gloo
ranks on the CPU (the JAX package's counterpart is
XLA_FLAGS=--xla_force_host_platform_device_count=N); rank 0 writes every
output, and at one rank the run is bit-equal to the plain dock.
"""
from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
import torch

from dfmdock_tpu_torch.cli.common import (
    add_dp_arguments,
    build_sampler,
    check_dp_samples,
    dock_complex,
    load_model,
    make_runner,
    resolve_device,
    write_csv,
)
from dfmdock_tpu_torch.cli.sweep import _multi_draw_scores
from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, SamplerConfig
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.data.esm import BACKENDS, ESM_DIM
from dfmdock_tpu_torch.data.pdb_io import get_full_coords, parse_pdb, save_pdb
from dfmdock_tpu_torch.sampler import EMSampler, PicardSampler
from dfmdock_tpu_torch.sampler.graph import SampleGraphs

DEFAULT_RERANKER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "ckpts", "db5_cv", "reranker_weights.json")


def load_inputs(args, device) -> list[dict]:
    """The raw complexes of --npz, --pdb or --csv, in order."""
    if args.npz:
        return [_complex_from_npz(os.path.splitext(os.path.basename(args.npz))[0], args.npz)]
    if args.pdb:
        return [_complex_from_pdbs("complex", args.pdb[0], args.pdb[1], args, device)]
    jobs = []
    with open(args.csv) as f:
        for row in csv.reader(f):
            cid, p1, p2 = row[0], row[1], row[2]
            jobs.append(_complex_from_npz(cid, p1) if p1.endswith(".npz")
                        else _complex_from_pdbs(cid, p1, p2, args, device))
    return jobs


def _complex_from_npz(cid, path):
    d = load_npz_complex(path)
    d["id"] = cid
    return d


def _complex_from_pdbs(cid, rec_pdb, lig_pdb, args, device):
    """A raw complex from two PDB files; the ESM columns are zeros under
    --one-hot-only (so the trained 1301-wide models still load), else the
    provider's embeddings."""
    rec, lig = parse_pdb(rec_pdb), parse_pdb(lig_pdb)
    if args.one_hot_only:
        rec_x = np.zeros((len(rec.seq), ESM_DIM), np.float32)
        lig_x = np.zeros((len(lig.seq), ESM_DIM), np.float32)
    else:
        from dfmdock_tpu_torch.data.esm import get_provider

        esm = get_provider(args.esm_backend, device)
        rec_x, lig_x = esm.embed(rec.seq), esm.embed(lig.seq)
    return {"id": cid, "rec_x": rec_x, "rec_pos": rec.bb_coords, "rec_seq": rec.seq,
            "lig_x": lig_x, "lig_pos": lig.bb_coords, "lig_seq": lig.seq}


def _reranker_scores(net, raw, results, rows, weights_path, k_draws, seed, device,
                     graphs=None):
    """Score every pose with the learned linear re-ranker (higher = better).

    The feature matrix is the (family, t) grid of K-draw mean scores named
    in the weights JSON (e.g. ``energy_t1em05_mean``) plus ``num_clashes``,
    z-scored within this complex, then dotted with the fitted weights; the t
    of each feature is parsed back from its name, as the JAX CLI does.
    `graphs` keeps the draws' captured graphs (_multi_draw_scores)."""
    with open(weights_path) as f:
        spec = json.load(f)
    feats, w = spec["features"], np.asarray(spec["weights"], np.float64)
    pos_all = results["pos"]
    n_poses, pad_to = int(pos_all.shape[0]), int(pos_all.shape[1])
    per_t = {}  # t -> {energy/icons/snorm: [P]}
    X = np.zeros((n_poses, len(feats)), np.float64)
    for j, name in enumerate(feats):
        if name == "num_clashes":
            X[:, j] = [r["num_clashes"] for r in rows]
            continue
        fam, rest = name.split("_t", 1)
        if not rest.endswith("_mean") or fam not in ("energy", "icons", "snorm"):
            raise ValueError(f"unsupported reranker feature {name!r}: the CLI "
                             "computes *_t*_mean grids and num_clashes")
        t = float(rest[: -len("_mean")].replace("m", "-"))
        if t not in per_t:
            per_t[t] = _multi_draw_scores(net, raw, pos_all, pad_to, k_draws, seed,
                                          device, t_eval=t, graphs=graphs)
        X[:, j] = per_t[t][fam]
    mu, sd = X.mean(0), X.std(0)
    Xz = (X - mu) / np.where(sd > 1e-12, sd, 1.0)
    return Xz @ w


def main(argv=None, model: ModelConfig | None = None) -> list[dict]:
    """Parse `argv` and run.  `model` is the config of the kernel route
    (default `ModelConfig.fast()`, bf16 as the JAX package's; a caller
    passes `fast(compute_dtype="float32")` for the float32 kernel route);
    `--exact` takes `ModelConfig()` whatever it says."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--npz", help="preprocessed complex npz")
    src.add_argument("--pdb", nargs=2, metavar=("REC", "LIG"), help="two PDB files")
    src.add_argument("--csv", help="CSV of (id, input1, input2) rows: a npz, or a "
                                   "receptor and a ligand PDB")
    ap.add_argument("--ckpt", default=None,
                    help="weights as a flat-dict .npz (params.py); default: "
                         "seeded random weights")
    ap.add_argument("--out-dir", default="./out")
    ap.add_argument("--out-csv", default="metrics.csv")
    ap.add_argument("--num-samples", type=int, default=16)
    ap.add_argument("--num-steps", type=int, default=40)
    ap.add_argument("--tr-noise-scale", type=float, default=0.5)
    ap.add_argument("--rot-noise-scale", type=float, default=0.5)
    ap.add_argument("--use-clash-force", action="store_true")
    ap.add_argument("--noise-annealing", action="store_true")
    ap.add_argument("--ode", action="store_true")
    ap.add_argument("--integrator", choices=["em", "heun"], default="em",
                    help="heun: 2nd-order probability-flow ODE (implies --ode)")
    ap.add_argument("--picard-iters", type=int, default=0,
                    help="latency mode: solve the probability-flow ODE by K "
                         "parallel-in-time Picard iterations, each one forward "
                         "over all num-steps x num-samples poses, instead of "
                         "num-steps sequential forwards (implies --ode)")
    ap.add_argument("--one-hot-only", action="store_true",
                    help="PDB inputs: zeros in the ESM columns instead of ESM2 "
                         "embeddings (for a model trained without ESM)")
    ap.add_argument("--esm-backend", choices=BACKENDS, default="auto",
                    help="ESM2 for PDB inputs: 'torch' = the port's ESM2 on "
                         "--device (the JAX package's 'jax'), 'hf' = "
                         "transformers' EsmModel, 'auto' = torch, else hf; "
                         "both read the locally cached HF weights")
    ap.add_argument("--energy-draws", type=int, default=1,
                    help="> 1: rank by the mean energy over K independent "
                         "edge-sampling draws")
    ap.add_argument("--rank-by", choices=["energy", "icons", "snorm", "reranker"],
                    default="energy",
                    help="pose-ranking key: energy, icons (interface "
                         "self-consistency) or snorm (score magnitude), all "
                         "lower = better, or reranker: the learned linear "
                         "combination of t-grid energy/icons/snorm features "
                         "(higher = better; ckpts/db5_cv/reranker.md)")
    ap.add_argument("--reranker-weights", default=DEFAULT_RERANKER,
                    help="feature/weight JSON of scripts/fit_reranker.py "
                         "(used by --rank-by reranker)")
    ap.add_argument("--reranker-draws", type=int, default=4,
                    help="edge-sampling draws per t of the reranker features "
                         "(4 = what the committed weights were fit with)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--write-all-poses", action="store_true")
    ap.add_argument("--exact", action="store_true",
                    help="eager float32 path (default: the CUDA kernels)")
    ap.add_argument("--device", default="cuda")
    add_dp_arguments(ap)
    args = ap.parse_args(argv)
    check_dp_samples(ap, args)
    if args.picard_iters > 0:
        if args.dp:
            ap.error("--picard-iters does not support --dp pose sharding")
        if args.integrator != "em":
            ap.error("--picard-iters is its own scheme; drop --integrator")
        # each pose holds num-steps states and every iteration runs num-steps
        # x num-samples poses through one forward: a latency mode for P ~ 1
        if args.num_samples > 4:
            ap.error(f"--picard-iters is a single-pose latency mode; --num-samples "
                     f"{args.num_samples} > 4 would batch {args.num_samples} full "
                     f"[T, N, 3, 3] Picard states. Use the default sampler for "
                     f"throughput.")

    device = resolve_device(args.device)
    if args.dp:
        from dfmdock_tpu_torch.parallel import launch

        return launch(_run, device, args.world_size, (args, model))
    return _run(None, args, model)


def _run(world, args, model=None) -> list[dict]:
    """The dock on this process's device; under --dp one rank of `world`,
    of which rank 0 alone ranks the poses and writes."""
    device = resolve_device(args.device) if world is None else world.device
    main_rank = world is None or world.main
    cfg = DFMDockConfig(
        model=ModelConfig() if args.exact else model or ModelConfig.fast(),
        sampler=SamplerConfig(
            num_steps=args.num_steps,
            tr_noise_scale=args.tr_noise_scale,
            rot_noise_scale=args.rot_noise_scale,
            use_clash_force=args.use_clash_force,
            noise_annealing=args.noise_annealing,
            ode=args.ode or args.integrator == "heun" or args.picard_iters > 0,
            integrator=args.integrator,
        ),
    )
    net = load_model(args.ckpt, cfg, device)
    sampler = build_sampler(net, cfg)
    if args.picard_iters > 0:
        sampler = PicardSampler(net, sampler.r3, sampler.so3, cfg.sampler,
                                num_iters=args.picard_iters)
    run_fn = make_runner(sampler, args.num_samples, world)
    if main_rank:
        os.makedirs(args.out_dir, exist_ok=True)

    generator = torch.Generator(device).manual_seed(args.seed)
    draws = SampleGraphs()  # the ranking draws' graphs, one per (P, N, t) of the run
    all_rows = []
    for job in load_inputs(args, device):
        rows, results, (R, L) = dock_complex(
            sampler, job, generator, args.num_samples, device,
            native=(job["rec_pos"], job["lig_pos"]), run_fn=run_fn,
        )
        if main_rank:
            _rank_and_write(args, cfg, net, job, rows, results, (R, L), device, draws)
        all_rows.extend(rows)
    if main_rank:
        write_csv(os.path.join(args.out_dir, args.out_csv), all_rows)
        print(f"wrote {os.path.join(args.out_dir, args.out_csv)}")
    return all_rows


def _rank_and_write(args, cfg, net, job, rows, results, sizes, device, draws=None):
    """Rank one complex's docked poses and write its best (or every) pose;
    `draws` keeps the ranking draws' captured graphs."""
    R, L = sizes
    if args.rank_by == "reranker":
        scores = _reranker_scores(net, job, results, rows, args.reranker_weights,
                                  args.reranker_draws, args.seed, device, draws)
        for i, r in enumerate(rows):
            r["rerank_score"] = float(scores[i])
        best = int(np.argmax(scores))  # reranker: higher = better
    elif args.energy_draws > 1 or args.rank_by != "energy":
        scores = _multi_draw_scores(net, job, results["pos"], int(results["pos"].shape[1]),
                                    args.energy_draws, args.seed, device,
                                    t_eval=cfg.sampler.eps, graphs=draws)
        for i, r in enumerate(rows):
            if args.energy_draws > 1:
                r["energy_first_draw"] = r["energy"]
                r["energy"] = float(scores["energy"][i])
            r["icons"] = float(scores["icons"][i])
            r["snorm"] = float(scores["snorm"][i])
        best = int(np.argmin(scores[args.rank_by]))
    else:
        best = EMSampler.rank_by_energy({"energy": torch.from_numpy(results["energy"])})
    pos = results["pos"]
    for i in range(args.num_samples) if args.write_all_poses else [best]:
        coords = np.concatenate([pos[i, :R], pos[i, R : R + L]])
        save_pdb(os.path.join(args.out_dir, f"{job['id']}_{i}.pdb"),
                 get_full_coords(coords), job["rec_seq"] + job["lig_seq"], delim=R - 1)
    print(f"{job['id']}: best pose {best} energy {rows[best]['energy']:.4f} "
          f"DockQ {rows[best]['DockQ']:.3f}")
    return rows


if __name__ == "__main__":
    main()
