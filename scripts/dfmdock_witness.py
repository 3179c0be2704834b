"""A second witness for the DFMDock lineage's docking quality, on the CPU.

    python3 scripts/dfmdock_witness.py [--ids 4POU] [--seeds 5,6,7,8]
        [--num-samples 40] [--num-steps 40] [--sides jax-bf16,jax-f32,port]

The DFMDock lineage's trained weights (ckpts/db5_holdout_dfmdock) are swept
on the complexes they were trained on by three samplers, each with the
protocol of the JAX record eval_train.csv (40-step EM, min-energy ranking,
the 128-residue bucket):
- `jax-bf16`: the JAX package's sweep with the model settings the record was
  made with (compute_dtype bfloat16, no Pallas: the DFMDock lineage had no
  kernel path then), from the orbax step.  Each complex gets the key the
  record's sweep gave it (PRNGKey(seed) split once per complex, in the
  record's order), so seed 5 repeats the record's draws;
- `jax-f32`: the same in float32 (the JAX sweep's --exact);
- `port`: dfmdock_tpu_torch's sweep, --exact on the CPU, from weights.npz;
- `port-cuda`: the same sweep through the kernels on a CUDA card, on the
  float32 kernel route (`ModelConfig.fast(compute_dtype="float32")`);
- `port-cuda-bf16`: the sweep CLI's default on the card, the kernel route
  in bf16 (`ModelConfig.fast()`), the JAX package's own precision;
- `port-cuda-bf16-jax-draws`: the `port-cuda-bf16` sweep with the JAX
  record's own start poses and SDE noise injected (`place_pose`,
  `EMSampler.sample(noise=)`), read from the file that
  scripts/export_jax_draws.py writes for seeds 5-30; the edges' Gumbel
  noise stays the port's own (the card generator seeded by --seed, as the
  sweep's);
- `port-exact-cuda`: the `port` side's eager float32 path on a CUDA card
  (TF32 off): the CPU side's arithmetic in another summation order, without
  the kernels;
- `port-cuda-cpu-draws`, `port-exact-cuda-cpu-draws`: the two CUDA sides
  with every random draw made on a CPU torch.Generator, in the order the
  `port` side draws them, and moved to the card: the start poses and the
  SDE noise through `EMSampler.sample(init=, noise=)`, the Gumbel noise of
  the edges through the net's `gumbel=` on each forward (`CPUDraws`).  The
  draws are then the `port` side's own at the same seed, so what differs
  from it is the card's rounding alone.
The CUDA sides need a card; without JAX installed, run them alone.  The
port sides also take other weights (`--ckpt`, their runs named SIDE@TAG by
`--tag`) and the four held-out complexes (`eval_holdout.csv`).
Prints one line per run and side: each complex's mean DockQ over all poses,
its best and its min-energy pick, then the means of each side over all runs
beside the record (eval_train.csv, made on a TPU v5e).  `--summarize DIR`
reads the per-pose CSVs of earlier runs (`--out-dir DIR`) and prints each
side and seed over all the complexes it covers, then for every two sides
that share seeds the per-seed mean DockQ and pick mean of both and their
paired difference with its standard error; with `--spread TAG,...` (port
runs of one training protocol, swept as `--sides port-cuda --tag TAG`) and
several DIRs (the training and held-out sweeps) it also prints each run's
mean DockQ and pick mean on each set, their mean m and sample sd s over
the runs, and how many s the JAX-trained model (tag `jax`) lies from m
(ROADMAP F7's rule: inside if within m +- 2s).  Imports JAX; it is
not part of the port.  A 40-pose sweep of 4POU takes minutes per side.
"""
from __future__ import annotations

import argparse
import csv
import os
import re
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CKPT = os.path.join(ROOT, "ckpts", "db5_holdout_dfmdock")
RECORD = os.path.join(CKPT, "eval_train.csv")
HOLDOUT_RECORD = os.path.join(CKPT, "eval_holdout.csv")
DATA = os.path.join(ROOT, "data", "db5_npz")
RECORD_ORDER = ("1AVX", "1ZHI", "2SNI", "4POU")  # the record sweep's ids, in order
HOLDOUT_ORDER = ("1QA9", "7CEI", "2SIC", "1JPS")  # held out of training (eval_holdout.csv)
BUCKET = 128


def record_groups():
    """The JAX record's sweeps: the training set and the held-out set."""
    out = {}
    for path in (RECORD, HOLDOUT_RECORD):
        with open(path) as f:
            out.update(groups_of(csv.DictReader(f)))
    return out


def groups_of(rows):
    """{complex id: [poses, 2] array of (DockQ, energy)}."""
    out = {}
    for r in rows:
        out.setdefault(r["id"], []).append((float(r["DockQ"]), float(r["energy"])))
    return {k: np.array(v) for k, v in out.items()}


def jax_side(ids, seed, num_samples, num_steps, dtype):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dfmdock_tpu.cli.common import build_sampler, dock_complex, load_model, make_runner
    from dfmdock_tpu.config import DFMDockConfig, ModelConfig, SamplerConfig
    from dfmdock_tpu.data.batching import round_up
    from dfmdock_tpu.data.dataset import NPZDataset

    cfg = DFMDockConfig(model=ModelConfig(compute_dtype=dtype),
                        sampler=SamplerConfig(num_steps=num_steps))
    net, params = load_model(os.path.join(CKPT, "last"), cfg, lineage="dfmdock")
    sampler = build_sampler(net, cfg)
    run_fn = make_runner(sampler, num_samples)
    ds = NPZDataset(DATA)
    key, rows = jax.random.PRNGKey(seed), []
    for cid in RECORD_ORDER:
        key, sub = jax.random.split(key)
        if cid not in ids:
            continue
        raw = ds.load_raw(ds.ids.index(cid))
        n = raw["rec_x"].shape[0] + raw["lig_x"].shape[0]
        recs, _, _ = dock_complex(sampler, params, raw, sub, num_samples,
                                  native=(raw["rec_pos"], raw["lig_pos"]),
                                  pad_to=round_up(n, BUCKET), run_fn=run_fn)
        rows += [dict(r, id=cid) for r in recs]
    return groups_of(rows)


PORT_ROUTES = {"port": ["--device", "cpu", "--exact"], "port-cuda": ["--device", "cuda"],
               "port-cuda-bf16": ["--device", "cuda"],
               "port-exact-cuda": ["--device", "cuda", "--exact"]}
# the kernel route's config where a side names one (else the sweep's default)
PORT_MODELS = {"port-cuda": dict(compute_dtype="float32")}
JAX_DRAWS = os.path.join(CKPT, "jax_draws.npz")


CPU_DRAW_SIDES = {"port-cuda-cpu-draws": False, "port-exact-cuda-cpu-draws": True}
JAX_DRAWS_SIDE = "port-cuda-bf16-jax-draws"


class CPUDraws:
    """The net of a sampler whose every forward takes its Gumbel noise, and
    each of the first `num_steps` forwards then the step's SDE noise (z_rot,
    z_tr), from the CPU generator `generator`, in the order the sampler
    draws them on the CPU; `noise` holds the SDE noise as the two lists that
    `EMSampler.sample(noise=)` indexes by step.  Its draws are Python work
    in each forward, which a replayed graph would not run: its samples run
    eagerly (capture=False)."""

    def __init__(self, net, generator, num_steps):
        self.net, self.generator, self.num_steps = net, generator, num_steps
        self.noise = ([], [])

    def prepare(self, batch, static):
        return self.net.prepare(batch, static)

    def __call__(self, batch, pos, t, generator=None, scores_only=False):
        import torch

        from dfmdock_tpu_torch.models.edges import sample_gumbel

        p, n = pos.shape[:2]
        gumbel = sample_gumbel((p, n, n), self.generator, "cpu").to(pos.device)
        out = self.net(batch, pos, t, gumbel=gumbel, scores_only=scores_only)
        if len(self.noise[0]) < self.num_steps:
            for z in self.noise:
                z.append(torch.randn((p, 1, 3), generator=self.generator).to(pos.device))
        return out


def port_cpu_draws_side(ids, seed, num_samples, num_steps, exact, device="cuda"):
    """The sweep of `port_side` on the card (the kernel route, or with
    `exact` the eager one), every draw made on one CPU generator seeded by
    `seed`, as the `port` side's.  With `device` "cpu" and `exact` it is
    the `port` side itself, draw for draw (a check of the draws' order)."""
    import torch

    from dfmdock_tpu_torch.cli.common import build_sampler, dock_complex, load_model
    from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, SamplerConfig
    from dfmdock_tpu_torch.data.batching import round_up
    from dfmdock_tpu_torch.data.dataset import NPZDataset, batch_to_tensors, complex_to_batch
    from dfmdock_tpu_torch.sampler.em import randomize_pose

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DFMDockConfig(model=ModelConfig() if exact else ModelConfig.fast(compute_dtype="float32"),
                        sampler=SamplerConfig(num_steps=num_steps))
    device = torch.device(device)
    net = load_model(os.path.join(CKPT, "weights.npz"), cfg, device, lineage="dfmdock")
    generator = torch.Generator().manual_seed(seed)
    ds, rows = NPZDataset(DATA), []
    for cid in (i for i in ds.ids if i in ids):
        raw = ds.load_raw(ds.ids.index(cid))
        n = raw["rec_x"].shape[0] + raw["lig_x"].shape[0]
        pad_to = round_up(n, BUCKET)
        host = batch_to_tensors(complex_to_batch(raw, pad_to=pad_to), torch.device("cpu"))
        init = tuple(a.to(device) for a in randomize_pose(
            generator, host["pos"], host["lig_mask"], host["node_mask"], cfg.sampler,
            num_samples))
        draws = CPUDraws(net, generator, num_steps)
        sampler = build_sampler(draws, cfg)
        recs, _, _ = dock_complex(
            sampler, raw, None, num_samples, device, native=(raw["rec_pos"], raw["lig_pos"]),
            pad_to=pad_to, run_fn=lambda b, g: sampler.sample(
                b, num_samples, None, init=init, noise=draws.noise, capture=False))
        rows += recs
    return groups_of(rows)


def jax_draws_side(ids, seed, num_samples, num_steps, device="cuda"):
    """The sweep of `port-cuda-bf16` (the kernel route at bf16) with the JAX
    record's start poses and SDE noise at `seed` (export_jax_draws.py's
    file): each complex's draws are the ones the record's key gives it, the
    Gumbel noise of the edges comes from one generator seeded by `seed` on
    `device`, as the sweep's."""
    import torch

    from dfmdock_tpu_torch.cli.common import build_sampler, dock_complex, load_model
    from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, SamplerConfig
    from dfmdock_tpu_torch.data.batching import round_up
    from dfmdock_tpu_torch.data.dataset import NPZDataset, batch_to_tensors, complex_to_batch
    from dfmdock_tpu_torch.sampler.em import place_pose

    draws = np.load(JAX_DRAWS)
    cfg = DFMDockConfig(model=ModelConfig.fast(), sampler=SamplerConfig(num_steps=num_steps))
    device = torch.device(device)
    sampler = build_sampler(load_model(os.path.join(CKPT, "weights.npz"), cfg, device,
                                       lineage="dfmdock"), cfg)
    generator = torch.Generator(device).manual_seed(seed)
    ds, rows = NPZDataset(DATA), []
    for cid in (i for i in ds.ids if i in ids):
        d = {k: torch.from_numpy(draws[f"s{seed}/{cid}/{k}"]).to(device)
             for k in ("quat", "tr", "z_rot", "z_tr")}
        saved = (d["quat"].shape[0], d["z_rot"].shape[0])
        if num_samples > saved[0] or num_steps > saved[1]:
            raise SystemExit(f"{JAX_DRAWS} holds {saved[0]} poses x {saved[1]} steps, fewer "
                             f"than {num_samples} x {num_steps}")
        # the first poses and steps (the record's draws only at 40 x 40)
        d = {"quat": d["quat"][:num_samples], "tr": d["tr"][:num_samples],
             "z_rot": d["z_rot"][:num_steps, :num_samples],
             "z_tr": d["z_tr"][:num_steps, :num_samples]}
        raw = ds.load_raw(ds.ids.index(cid))
        n = raw["rec_x"].shape[0] + raw["lig_x"].shape[0]
        pad_to = round_up(n, BUCKET)
        batch = batch_to_tensors(complex_to_batch(raw, pad_to=pad_to), device)
        init = place_pose(batch["pos"], batch["lig_mask"], batch["node_mask"], cfg.sampler,
                          d["quat"], d["tr"])
        recs, _, _ = dock_complex(
            sampler, raw, generator, num_samples, device,
            native=(raw["rec_pos"], raw["lig_pos"]), pad_to=pad_to,
            run_fn=lambda b, g: sampler.sample(b, num_samples, g, init=init,
                                               noise=(d["z_rot"], d["z_tr"])))
        rows += recs
    return groups_of(rows)


def port_side(ids, seed, num_samples, num_steps, side, weights=None):
    import torch

    from dfmdock_tpu_torch.cli import sweep
    from dfmdock_tpu_torch.config import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    route = PORT_ROUTES[side]
    model = ModelConfig.fast(**PORT_MODELS[side]) if side in PORT_MODELS else None
    with tempfile.TemporaryDirectory() as tmp:
        rows = sweep.main(["--lineage", "dfmdock", "--ckpt",
                           weights or os.path.join(CKPT, "weights.npz"),
                           "--data-dir", DATA, "--ids", ",".join(ids), "--num-samples",
                           str(num_samples), "--num-steps", str(num_steps), "--seed",
                           str(seed), "--out-csv", os.path.join(tmp, "sweep.csv")] + route,
                          model)
    return groups_of(rows)


def stats(g):
    """(mean DockQ, best, min-energy pick) of one complex's poses."""
    return g[:, 0].mean(), g[:, 0].max(), g[np.argmin(g[:, 1]), 0]


def fmt(groups):
    return "; ".join("{} mean {:.4f} best {:.4f} pick {:.4f}".format(k, *stats(g))
                     for k, g in sorted(groups.items()))


def overall(groups):
    """The sweep's numbers over several complexes: mean DockQ over all
    poses, best-of mean, min-energy-pick mean, acceptable+ picks (>= 0.23)."""
    st = [stats(g) for g in groups.values()]
    return (np.concatenate([g[:, 0] for g in groups.values()]).mean(),
            np.mean([x[1] for x in st]), np.mean([x[2] for x in st]),
            sum(x[2] >= 0.23 for x in st))


def rank_corr(g):
    """Spearman correlation of one complex's poses' DockQ and energy
    (negative where lower energy marks better poses)."""
    r = np.argsort(np.argsort(g, 0), 0).astype(np.float64)
    return np.corrcoef(r[:, 0], r[:, 1])[0, 1]


def read_runs(out_dirs):
    """{side: {seed: {complex id: [poses, 2] (DockQ, energy)}}} of the
    per-pose CSVs that --out-dir wrote into each of `out_dirs`."""
    runs = {}
    for out_dir in out_dirs:
        for name in sorted(os.listdir(out_dir)):
            side, seed = re.fullmatch(r"(.+)_seed(\d+)_[\w-]+\.csv", name).groups()
            with open(os.path.join(out_dir, name)) as f:
                runs.setdefault(side, {}).setdefault(int(seed), {}).update(
                    groups_of(csv.DictReader(f)))
    return runs


def side_numbers(by_seed, ids):
    """(mean DockQ, pick mean, seeds) of one side over the complexes `ids`:
    each the mean over the seeds that cover all of them."""
    seeds = [sd for sd, g in sorted(by_seed.items()) if set(ids) <= set(g)]
    per = np.array([overall({k: by_seed[sd][k] for k in ids})[:3] for sd in seeds])
    return (per[:, 0].mean(), per[:, 2].mean(), seeds) if seeds else None


SPREAD_SETS = {"training": RECORD_ORDER, "held-out": HOLDOUT_ORDER}


def spread(runs, tags, reference, prefix="port-cuda@"):
    """How far port-trained models of one protocol scatter, and where the
    reference model lies among them (ROADMAP F7).  `runs` as read_runs;
    `tags`: the runs whose spread is measured, as SIDE@TAG sides named
    `prefix` + tag; `reference`: the tag of the model held against it.  For
    each set of SPREAD_SETS, each tag's (and every other `prefix` side's)
    mean DockQ and pick mean over its seeds; over the `tags` present, the
    mean m and sample sd s of both numbers; the reference's distance from m
    in s, and whether it lies within m +- 2s.  Prints it and returns
    {set: {"runs": {tag: (mean, pick, seeds)}, "m": (mean, pick), "s": (mean,
    pick), "reference": (mean, pick), "z": (mean, pick), "inside": bool}}."""
    out = {}
    others = sorted(side[len(prefix):] for side in runs if side.startswith(prefix))
    for name, ids in SPREAD_SETS.items():
        nums = {t: side_numbers(runs[prefix + t], ids) for t in others}
        nums = {t: v for t, v in nums.items() if v is not None}
        for t, (mean, pick, seeds) in nums.items():
            role = ("reference" if t == reference else "in the spread" if t in tags
                    else "beside it")
            print(f"# spread, {name} set: {prefix}{t} ({role}): mean {mean:.4f}, pick mean "
                  f"{pick:.4f} over seeds {seeds[0]}-{seeds[-1]} ({len(seeds)})")
        counted = [t for t in tags if t in nums]
        if len(counted) < 2 or reference not in nums:
            print(f"# spread, {name} set: {len(counted)} of the runs and "
                  f"{'the' if reference in nums else 'no'} reference: nothing to compare")
            continue
        vals = np.array([nums[t][:2] for t in counted])
        m, s = vals.mean(0), vals.std(0, ddof=1)
        ref = np.array(nums[reference][:2])
        z = (ref - m) / s
        inside = bool(np.all(np.abs(ref - m) <= 2 * s))
        out[name] = {"runs": {t: nums[t] for t in counted}, "m": tuple(m), "s": tuple(s),
                     "reference": tuple(ref), "z": tuple(z), "inside": inside}
        print(f"# spread, {name} set, over {len(counted)} runs ({', '.join(counted)}): mean "
              f"DockQ m {m[0]:.4f} s {s[0]:.4f}, pick mean m {m[1]:.4f} s {s[1]:.4f}; "
              f"{prefix}{reference}: mean {ref[0]:.4f} ({z[0]:+.2f} s), pick mean {ref[1]:.4f} "
              f"({z[1]:+.2f} s): {'inside' if inside else 'outside'} m +- 2s")
    return out


def summarize(out_dirs, tags=()):
    """For each of `out_dirs`, each side and seed over the complexes it
    covers and every paired difference; then with `tags` the spread of
    those runs over all the directories, against the JAX-trained weights
    (spread)."""
    for out_dir in out_dirs:
        summarize_dir(read_runs([out_dir]))
    if tags:
        spread(read_runs(out_dirs), tags, "jax")
    return 0


def summarize_dir(runs):
    line = "mean {:.4f}, best mean {:.4f}, pick mean {:.4f}, acceptable+ picks {}"
    for side, by_seed in sorted(runs.items()):
        for ids in sorted({tuple(sorted(g)) for g in by_seed.values()}):
            record = {k: g for k, g in record_groups().items() if k in ids}
            print(f"# {','.join(ids)}: JAX record (v5e) " + line.format(*overall(record)))
            seeds = [sd for sd, g in sorted(by_seed.items()) if tuple(sorted(g)) == ids]
            for sd in seeds:
                print(f"# {','.join(ids)}: {side}, seed {sd}: "
                      + line.format(*overall(by_seed[sd])))
            means = np.array([overall(by_seed[sd])[:3] for sd in seeds])
            corr = "; ".join(f"{k} {np.mean([rank_corr(by_seed[sd][k]) for sd in seeds]):.3f}"
                             f" (record {rank_corr(record[k]):.3f})" for k in ids)
            print(f"# {','.join(ids)}: {side} over seeds {seeds}: mean {means[:, 0].mean():.4f} "
                  f"(seed to seed sd {means[:, 0].std(ddof=1) if len(seeds) > 1 else 0:.4f}), "
                  f"pick mean {means[:, 2].mean():.4f} (sd "
                  f"{means[:, 2].std(ddof=1) if len(seeds) > 1 else 0:.4f}); energy-DockQ "
                  f"rank correlation by complex, mean over seeds: {corr}")
    names = sorted(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            paired(a, runs[a], b, runs[b])


def paired(side_a, by_seed_a, side_b, by_seed_b):
    """Per seed the mean DockQ and pick mean of two sides over the same
    complexes, and their paired difference (a - b, same seed): its mean,
    standard error (sd / sqrt(seeds)) and the mean over that error."""
    seeds = sorted(sd for sd in set(by_seed_a) & set(by_seed_b)
                   if sorted(by_seed_a[sd]) == sorted(by_seed_b[sd]))
    if len(seeds) < 2:
        return
    a = np.array([overall(by_seed_a[sd])[:3] for sd in seeds])[:, [0, 2]]
    b = np.array([overall(by_seed_b[sd])[:3] for sd in seeds])[:, [0, 2]]
    for sd, x, y in zip(seeds, a, b):
        print(f"# paired, seed {sd}: {side_a} mean {x[0]:.4f} pick {x[1]:.4f}; {side_b} "
              f"mean {y[0]:.4f} pick {y[1]:.4f}; difference {x[0] - y[0]:+.4f} / "
              f"{x[1] - y[1]:+.4f}")
    diff = a - b
    se = diff.std(0, ddof=1) / np.sqrt(len(seeds))
    print(f"# paired over {len(seeds)} seeds ({seeds[0]}-{seeds[-1]}): {side_a} - {side_b}: "
          f"mean DockQ {diff[:, 0].mean():+.4f} (se {se[0]:.4f}, {diff[:, 0].mean() / se[0]:+.2f} "
          f"se), pick mean {diff[:, 1].mean():+.4f} (se {se[1]:.4f}, "
          f"{diff[:, 1].mean() / se[1]:+.2f} se)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ids", default="4POU")
    ap.add_argument("--seeds", default="5,6,7,8")
    ap.add_argument("--num-samples", type=int, default=40)
    ap.add_argument("--num-steps", type=int, default=40)
    ap.add_argument("--sides", default="jax-bf16,jax-f32,port")
    ap.add_argument("--ckpt", default=None,
                    help="the port sides' weights (a weights.npz; default the JAX record's, "
                         "ckpts/db5_holdout_dfmdock/weights.npz)")
    ap.add_argument("--tag", default="",
                    help="appended to the side names as SIDE@TAG, so that --summarize "
                         "pairs runs of other weights")
    ap.add_argument("--out-dir", default=None,
                    help="write each run's per-pose DockQ and energy here as CSV")
    ap.add_argument("--summarize", default=None, nargs="+", metavar="DIR",
                    help="run nothing: read the CSVs that --out-dir wrote into each DIR "
                         "(runs of one side and seed may be split over several calls) and "
                         "print each side and seed over the complexes it covers")
    ap.add_argument("--spread", default="", metavar="TAG,...",
                    help="with --summarize: the port-cuda@TAG runs whose spread is "
                         "measured (training and held-out mean and pick, their mean m and "
                         "sd s) and where the JAX-trained weights (tag jax) lie from m, in s")
    args = ap.parse_args(argv)
    if args.summarize:
        return summarize(args.summarize, [t for t in args.spread.split(",") if t])
    ids = [s for s in args.ids.split(",") if s]
    sides = args.sides.split(",")
    port_only = all(s in PORT_ROUTES for s in sides)
    allowed = RECORD_ORDER + HOLDOUT_ORDER if port_only else RECORD_ORDER
    if not set(ids) <= set(allowed):
        ap.error(f"--ids must be among {allowed} (the held-out ones on the port sides "
                 f"{', '.join(PORT_ROUTES)} alone)")
    if args.ckpt and not port_only:
        ap.error(f"--ckpt applies to the port sides {', '.join(PORT_ROUTES)} alone")
    if not set(sides) <= {"jax-bf16", "jax-f32", *PORT_ROUTES, *CPU_DRAW_SIDES, JAX_DRAWS_SIDE}:
        ap.error(f"--sides takes jax-bf16, jax-f32, {', '.join(PORT_ROUTES)}, "
                 f"{', '.join(CPU_DRAW_SIDES)} and {JAX_DRAWS_SIDE}")
    record = {k: g for k, g in record_groups().items() if k in ids}
    print(f"# JAX record (v5e): {fmt(record)}", flush=True)
    runs = {s: [] for s in sides}
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in sides:
            t0 = time.perf_counter()
            if side == JAX_DRAWS_SIDE:
                g = jax_draws_side(ids, seed, args.num_samples, args.num_steps)
            elif side in CPU_DRAW_SIDES:
                g = port_cpu_draws_side(ids, seed, args.num_samples, args.num_steps,
                                        CPU_DRAW_SIDES[side])
            elif side.startswith("port"):
                g = port_side(ids, seed, args.num_samples, args.num_steps, side, args.ckpt)
            else:
                g = jax_side(ids, seed, args.num_samples, args.num_steps,
                             {"jax-bf16": "bfloat16", "jax-f32": "float32"}[side])
            runs[side].append(g)
            label = f"{side}@{args.tag}" if args.tag else side
            if args.out_dir:
                os.makedirs(args.out_dir, exist_ok=True)
                name = f"{label}_seed{seed}_{'-'.join(ids)}.csv"
                with open(os.path.join(args.out_dir, name), "w") as f:
                    f.write("id,index,DockQ,energy\n")
                    for k, a in sorted(g.items()):
                        f.writelines(f"{k},{i},{float(d)!r},{float(e)!r}\n"
                                     for i, (d, e) in enumerate(a))
            print(f"# {label}, seed {seed}: {fmt(g)} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    for side, gs in runs.items():
        per = "; ".join(
            f"{k} mean {np.mean([stats(g[k])[0] for g in gs]):.4f} "
            f"pick {np.mean([stats(g[k])[2] for g in gs]):.4f}" for k in ids)
        print(f"# {side} over {len(gs)} seeds: {per}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
