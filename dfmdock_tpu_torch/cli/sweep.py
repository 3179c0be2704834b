"""Dock every complex of a dataset: the port of `python -m dfmdock_tpu.cli.sweep`.

N sampled poses per complex over an npz dataset (default: the bundled DB5
set) into one DockQ/energy CSV, with optional final-pose PDBs, trajectory
PDBs of pose 0 and the ground-truth energy probe (inference_mlsb.py:219-227).
The sweep is re-entrant: complexes already in the CSV are skipped with
--resume.

  python -m dfmdock_tpu_torch.cli.sweep --ids 1AVX,7CEI --num-samples 16
  python -m dfmdock_tpu_torch.cli.sweep --lineage dfmdock \
      --ckpt ckpts/db5_holdout_dfmdock/weights.npz --num-samples 40 --seed 5

--lineage picks the score network: mlsb (ScoreNet) or dfmdock (the DFMDock
lineage, DFMDockModel).  By default the forward runs through the CUDA
kernels on `cuda` in bf16 (`ModelConfig.fast()`, the JAX sweep's default);
`--exact` selects the eager float32 path and `--device cpu` the CPU.
`main(argv, model=ModelConfig.fast(compute_dtype="float32"))` runs the
float32 kernel route.  `--dp` splits each complex's poses over the ranks of
torch.distributed (one NCCL rank per visible GPU, or `--world-size` gloo
ranks on the CPU); rank 0 writes the CSV and the PDBs.
"""
from __future__ import annotations

import argparse
import csv
import functools
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
)
from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, SamplerConfig
from dfmdock_tpu_torch.data.batching import round_up
from dfmdock_tpu_torch.data.dataset import NPZDataset, batch_to_tensors, complex_to_batch
from dfmdock_tpu_torch.data.pdb_io import get_full_coords, save_pdb, save_trajectory
from dfmdock_tpu_torch.eval import compute_metrics
from dfmdock_tpu_torch.sampler.em import sample_batch
from dfmdock_tpu_torch.sampler.graph import SampleGraphs
from dfmdock_tpu_torch.train.losses import _bce_logits, interface_labels

# seeds of the ranking draws: draw k of a run seeded s uses
# DRAW_SEED_BASE + s * DRAW_SEED_STRIDE + k
DRAW_SEED_BASE, DRAW_SEED_STRIDE = 99, 1_000_003


def main(argv=None, model: ModelConfig | None = None) -> list[dict]:
    """Parse `argv` and run.  `model` is the config of the kernel route
    (default `ModelConfig.fast()`, bf16 as the JAX package's; a caller
    passes `fast(compute_dtype="float32")` for the float32 kernel route);
    `--exact` takes `ModelConfig()` whatever it says."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default="data/db5_npz")
    ap.add_argument("--ckpt", default=None,
                    help="weights as a flat-dict .npz (params.py); default: "
                         "seeded random weights")
    ap.add_argument("--out-csv", default="csv_files/sweep.csv")
    ap.add_argument("--out-pdb-dir", default=None, help="write every pose's PDB here")
    ap.add_argument("--out-trj-dir", default=None,
                    help="write the trajectory PDB of pose 0 here")
    ap.add_argument("--num-samples", type=int, default=1)
    ap.add_argument("--num-steps", type=int, default=40)
    ap.add_argument("--tr-noise-scale", type=float, default=0.5)
    ap.add_argument("--rot-noise-scale", type=float, default=0.5)
    ap.add_argument("--ode", action="store_true")
    ap.add_argument("--integrator", choices=["em", "heun"], default="em",
                    help="heun: 2nd-order probability-flow ODE (implies --ode)")
    ap.add_argument("--use-clash-force", action="store_true")
    ap.add_argument("--gt-energy", action="store_true",
                    help="evaluate the ground-truth pose energy only")
    ap.add_argument("--energy-draws", type=int, default=1,
                    help="> 1: each pose's energy is the mean over K "
                         "independent edge-sampling draws")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--ids", default=None,
                    help="comma-separated complex ids to run (e.g. a held-out split)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--bucket", type=int, default=128,
                    help="pad N up to multiples of this")
    ap.add_argument("--lineage", choices=["mlsb", "dfmdock"], default="mlsb")
    ap.add_argument("--exact", action="store_true",
                    help="eager float32 path (default: the CUDA kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_dp_arguments(ap)
    args = ap.parse_args(argv)
    check_dp_samples(ap, args)
    if args.lineage == "dfmdock" and args.energy_draws > 1:
        # the JAX sweep's ranking draws read out["ires"], which the DFMDock
        # lineage does not return (it returns "ires_logits"): that
        # combination cannot run in the reference, so the port refuses it
        ap.error("--energy-draws > 1 is not available with --lineage dfmdock: the "
                 "reference's ranking draws read the interface logits under the mlsb "
                 "name ('ires'), which the DFMDock lineage does not return")

    device = resolve_device(args.device)
    if args.dp:
        from dfmdock_tpu_torch.parallel import launch

        return launch(_run, device, args.world_size, (args, model))
    return _run(None, args, model)


def _run(world, args, model=None) -> list[dict]:
    """The sweep on this process's device; under --dp one rank of `world`.
    Every rank walks the same complexes and makes the same shared draws
    (start poses, the ground-truth probe, pose 0's trajectory run), so the
    generator seeded by --seed stays alike on every rank; rank 0 alone
    scores the ranking draws and writes."""
    device = resolve_device(args.device) if world is None else world.device
    main_rank = world is None or world.main
    cfg = DFMDockConfig(
        model=ModelConfig() if args.exact else model or ModelConfig.fast(),
        sampler=SamplerConfig(
            num_steps=args.num_steps,
            tr_noise_scale=args.tr_noise_scale,
            rot_noise_scale=args.rot_noise_scale,
            use_clash_force=args.use_clash_force,
            ode=args.ode or args.integrator == "heun",
            integrator=args.integrator,
        ),
    )
    net = load_model(args.ckpt, cfg, device, lineage=args.lineage)
    sampler = build_sampler(net, cfg)
    run_fn = make_runner(sampler, args.num_samples, world)
    draws = SampleGraphs()  # the ranking draws' graphs, one per (P, N, t) of the run
    ds = NPZDataset(args.data_dir)
    # --ids filters the whole dataset; --limit truncates afterwards
    ids = ds.ids
    if args.ids:
        want = {s.strip() for s in args.ids.split(",") if s.strip()}
        missing = sorted(want - set(ds.ids))
        if missing:
            raise SystemExit(f"--ids not in dataset: {missing}")
        ids = [i for i in ids if i in want]
    if args.limit:
        ids = ids[: args.limit]

    done, rows = set(), []
    if args.resume and os.path.exists(args.out_csv):
        with open(args.out_csv) as f:
            for row in csv.DictReader(f):
                rows.append(row)
                done.add(row["id"])

    generator = torch.Generator(device).manual_seed(args.seed)
    for n_done, cid in enumerate(ids):
        if cid in done:
            continue
        raw = ds.load_raw(ds.ids.index(cid))
        native = (raw["rec_pos"], raw["lig_pos"])
        if args.gt_energy:
            batch = batch_to_tensors(complex_to_batch(raw), device)
            with torch.no_grad():
                out = net(batch, batch["pos"][None], 1e-5, generator=generator)
            rec = {"id": cid}
            rec.update(compute_metrics(native, native))
            rec["energy"] = float(out["energy"][0])
            rec["num_clashes"] = int(out["num_clashes"][0])
            rows.append(rec)
        else:
            n = raw["rec_x"].shape[0] + raw["lig_x"].shape[0]
            pad_to = round_up(n, args.bucket)
            recs, results, (R, L) = dock_complex(
                sampler, raw, generator, args.num_samples, device, native=native,
                pad_to=pad_to, run_fn=run_fn,
            )
            if args.energy_draws > 1 and main_rank:
                e = _multi_draw_scores(net, raw, results["pos"], pad_to,
                                       args.energy_draws, args.seed, device,
                                       t_eval=cfg.sampler.eps, graphs=draws)["energy"]
                for i, r in enumerate(recs):
                    r["energy_first_draw"] = r["energy"]
                    r["energy"] = float(e[i])
            rows.extend(recs)
            pos = results["pos"]
            if args.out_pdb_dir and main_rank:
                os.makedirs(args.out_pdb_dir, exist_ok=True)
                for i in range(args.num_samples):
                    coords = np.concatenate([pos[i, :R], pos[i, R : R + L]])
                    save_pdb(os.path.join(args.out_pdb_dir, f"{cid}_p{i}.pdb"),
                             get_full_coords(coords), raw["rec_seq"] + raw["lig_seq"],
                             delim=R - 1)
            if args.out_trj_dir:
                os.makedirs(args.out_trj_dir, exist_ok=True)
                # pose 0 again, recording its trajectory
                batch = batch_to_tensors(complex_to_batch(raw), device)
                one = sampler.sample(batch, 1, generator, record_trajectory=True)
                traj = one["trajectory"][0].cpu().numpy()
                if main_rank:
                    save_trajectory(os.path.join(args.out_trj_dir, f"{cid}_p0.pdb"),
                                    [t[:R] for t in traj], [t[R : R + L] for t in traj],
                                    raw["rec_seq"], raw["lig_seq"])
        if main_rank:
            print(f"[{n_done + 1}/{len(ids)}] {cid} done")
            _write(args.out_csv, rows)

    if main_rank:
        _write(args.out_csv, rows)
        print(f"wrote {args.out_csv} ({len(rows)} rows)")
    return rows


@torch.no_grad()
def _multi_draw_scores(net, raw, pos_all, pad_to, k_draws, seed, device, t_eval=1e-3,
                       graphs=None, capture=None):
    """Mean ranking scores over k independent edge-sampling draws, all poses
    batched in each draw's full forward: energy (the reference's key), icons
    (interface self-consistency BCE) and snorm (predicted score magnitude),
    each [P] float64 and lower-is-better.  Draw k of a run seeded `seed`
    draws its edges from its own generator, seeded DRAW_SEED_BASE + seed *
    DRAW_SEED_STRIDE + k (the JAX package's fold_in keys), so the scores do
    not depend on what ran before.  On CUDA a draw is the replay of one
    captured graph per (pose count, N, t_eval) of `graphs` (a SampleGraphs
    that the caller's loop keeps; by default one for this call), drawing
    from the draw's generator (`capture` as EMSampler.sample's)."""
    batch = batch_to_tensors(complex_to_batch(raw, pad_to=pad_to), device)
    pos = torch.as_tensor(np.asarray(pos_all), dtype=torch.float32, device=device)
    inputs = {"batch": sample_batch(batch), "pos": pos}
    graphs = graphs or SampleGraphs()
    body = functools.partial(_draw_scores, net, t_eval=t_eval,
                             static=graphs.capture_device(pos.device))
    acc = {k: np.zeros(pos.shape[0], np.float64) for k in ("energy", "icons", "snorm")}
    for k in range(k_draws):
        gen = torch.Generator(device).manual_seed(DRAW_SEED_BASE + seed * DRAW_SEED_STRIDE + k)
        out = graphs.run(net, ("draw", t_eval), inputs, body, gen, capture)
        for name in acc:
            acc[name] += out[name].double().cpu().numpy()
    return {k: v / k_draws for k, v in acc.items()}


def _draw_scores(net, inputs, generator, t_eval, static, warmup=False):
    """One ranking draw's scores ([P] each) of the poses of `inputs` (a
    draw is one forward: its warm-up form is the same)."""
    batch, pos = net.prepare(inputs["batch"], static), inputs["pos"]
    labels = interface_labels(pos, batch["lig_mask"], batch["node_mask"])
    out = net(batch, pos, t_eval, generator=generator)
    icons = _bce_logits(out["ires"], labels, batch["node_mask"])
    snorm = (out["tr_score"].square().sum((-2, -1)).sqrt()
             + out["rot_score"].square().sum((-2, -1)).sqrt())
    return {"energy": out["energy"], "icons": icons, "snorm": snorm}


def _write(path, rows):
    """The sweep CSV: columns in the JAX sweep's order, id first, then by name."""
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys = sorted({k for r in rows for k in r}, key=lambda k: (k != "id", k))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow(r)


if __name__ == "__main__":
    main()
