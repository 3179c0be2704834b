"""The port's training path on the CPU, against the JAX package where the two
can be held equal.

- host data path: crop_complex, make_training_batch and build_pool are
  bit-equal to JAX's for equal `np.random.RandomState` seeds;
- optimizer: two AdamW steps with t_embed.W frozen equal optax's
  multi_transform steps on the same gradients: each array's change within
  rel 1e-4 of optax's (optax rounds the bias corrections 1 - 0.999^t in
  float32, 1.3e-5 off at t = 1), plus one float32 rounding of the weight;
- the training forward of both lineages (dedx, the distogram loss) against
  JAX's apply(train=True), within rel 1e-4, on deterministic edges and with
  JAX's gathers exact (see tests/test_torch_losses.py);
- the IGSO3 angle sampler against its density (Kolmogorov-Smirnov);
- the training CLI: 2 epochs on 2 small complexes, its config.yaml as JAX
  writes it, the saved weights resumed and docked, --no-pool, 2 epochs at
  --compute-dtype bfloat16 (and one --dp step of it at 2 gloo ranks), and
  --dp's refusal of --batch-size 1.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch
import yaml

from _torch_parity import configs, jax_batch, jax_flat, padded, port_batch, port_net
from dfmdock_tpu.config import DFMDockConfig as JaxDFMDockConfig
from dfmdock_tpu.config import ExperimentConfig as JaxExperimentConfig
from dfmdock_tpu.config import ModelConfig as JaxModelConfig
from dfmdock_tpu.data import crop as jax_crop
from dfmdock_tpu.data.dataset import NPZDataset as JaxNPZDataset
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.models.egnn_net import EGNNNet as JaxEGNNNet
from dfmdock_tpu.train import pool as jax_pool
from dfmdock_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dfmdock_tpu_torch.cli import dock, train
from dfmdock_tpu_torch.cli.common import load_model
from dfmdock_tpu_torch.config import DFMDockConfig, ExperimentConfig, SO3Config
from dfmdock_tpu_torch.data import crop
from dfmdock_tpu_torch.data.dataset import NPZDataset
from dfmdock_tpu_torch.diffusion import SO3Diffuser
from dfmdock_tpu_torch.models import EGNNNet
from dfmdock_tpu_torch.params import load_npz, to_state_dict
from dfmdock_tpu_torch.train import pool
from dfmdock_tpu_torch.train.trainer import make_optimizer

FWD_REL = 1e-4
ADAM_REL = 1e-4
SMALL_IDS = ("1QA9", "7CEI")


@pytest.fixture
def exact_gather(monkeypatch):
    import dfmdock_tpu.ops.gather as gather

    monkeypatch.setattr(gather, "gather_rows", lambda src, idx: jnp.take(src, idx, axis=0))


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    for cid in SMALL_IDS:
        shutil.copy(f"data/db5_npz/{cid}.npz", d / f"{cid}.npz")
    return str(d)


def assert_equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("spatial", [True, False])
def test_crop_matches_jax(spatial):
    raw = NPZDataset("data/db5_npz").load_raw(0)
    args = (raw["rec_x"], raw["lig_x"], raw["rec_pos"], raw["lig_pos"], 150)
    for seed in range(4):
        got = crop.crop_complex(*args, np.random.RandomState(seed), use_spatial=spatial)
        want = jax_crop.crop_complex(*args, np.random.RandomState(seed), use_spatial=spatial)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_training_batch_and_pool_match_jax(small_data):
    ds, jds = NPZDataset(small_data), JaxNPZDataset(small_data)
    assert ds.ids == jds.ids
    raw, jraw = ds.load_raw(1), jds.load_raw(1)
    for seed in range(3):
        assert_equal_dicts(
            pool.make_training_batch(raw, 128, 128, np.random.RandomState(seed)),
            jax_pool.make_training_batch(jraw, 128, 128, np.random.RandomState(seed)))
    assert_equal_dicts(
        pool.build_pool(ds, [0, 1], 192, 192, np.random.RandomState(7), variants=2),
        jax_pool.build_pool(jds, [0, 1], 192, 192, np.random.RandomState(7), variants=2))
    rng_a, rng_b = np.random.RandomState(3), np.random.RandomState(3)
    np.testing.assert_array_equal(pool.np_random_rotation(rng_a),
                                  jax_pool.np_random_rotation(rng_b))


def test_adamw_step_matches_optax():
    jcfg, pcfg = configs()
    params = JaxScoreNet(jcfg).init(jax.random.PRNGKey(0))
    net = port_net(pcfg, params)
    p0 = {k: v.clone() for k, v in net.state_dict().items()}
    w0 = net.t_embed.W.clone()
    kw = dict(lr=1e-3, weight_decay=0.05)
    jopt = jax_make_optimizer(params, JaxExperimentConfig(**kw))
    state = jopt.init(params)
    opt = make_optimizer(net, ExperimentConfig(**kw))
    rng = np.random.RandomState(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        g = to_state_dict(jax_flat(grads))
        for name, p in net.named_parameters():
            p.grad = g[name].clone()
        opt.step()
    want = to_state_dict(jax_flat(params))
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        err = (got[k] - want[k]).abs().max().item()
        step = (want[k] - p0[k]).abs().max().item()
        ulp = torch.finfo(torch.float32).eps * want[k].abs().max().item()
        assert err <= ADAM_REL * step + ulp, (k, err, step)
    assert torch.equal(net.t_embed.W, w0)  # frozen on both sides
    np.testing.assert_array_equal(want["t_embed.W"].numpy(), w0.numpy())


@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_training_forward_matches_jax(lineage, exact_gather):
    jcfg, pcfg = configs(sample_size=0)
    batch = padded(40, 30, seed=5)
    if lineage == "mlsb":
        jnet = JaxScoreNet(jcfg)
        params = jnet.init(jax.random.PRNGKey(2))
        pnet = port_net(pcfg, params)
        keys = ("tr_score", "rot_score", "f", "energy", "ires", "dedx")
        gt = None
    else:
        jnet = JaxEGNNNet(jcfg)
        params = jnet.init(jax.random.PRNGKey(2))
        pnet = EGNNNet(pcfg)
        pnet.load_state_dict(to_state_dict(jax_flat(params)))
        keys = ("tr_score", "rot_score", "f", "energy", "ires_logits", "confidence_logits",
                "dist_loss", "dedx")
        ca = batch["pos"][:, 1]
        gt = np.sqrt(np.maximum(((ca[:, None] - ca[None]) ** 2).sum(-1), 1e-12))
    kw = {} if gt is None else {"gt_dist": jnp.asarray(gt)}
    want = jnet.apply(params, jax_batch(batch, 0.3), jax.random.PRNGKey(0), train=True, **kw)
    pkw = {} if gt is None else {"gt_dist": torch.from_numpy(gt)[None].float()}
    got = pnet.apply_train(port_batch(batch), torch.from_numpy(batch["pos"])[None],
                           torch.tensor(0.3), dedx=True, **pkw)
    for k in keys:
        w = np.asarray(want[k], np.float64)
        g = got[k].detach().double().numpy().reshape(w.shape)
        assert np.isfinite(g).all(), k
        assert np.abs(g - w).max() <= FWD_REL * np.abs(w).max() + 1e-7, k
    e_only = pnet.apply_train(port_batch(batch), torch.from_numpy(batch["pos"])[None],
                              torch.tensor(0.3), return_energy=True)
    assert float(e_only[0].detach()) == pytest.approx(float(got["energy"][0].detach()), rel=1e-6)


@pytest.mark.parametrize("t", [0.05, 0.3, 0.8])
def test_igso3_angle_sampler_follows_density(t):
    so3 = SO3Diffuser(SO3Config())
    g = torch.Generator().manual_seed(int(t * 100))
    angles = so3.sample_igso3(g, torch.tensor(t), 20000).double().numpy()
    i = so3.t_to_idx(t)
    omega, pdf = so3.tables.discrete_omega, so3.tables.pdf[i]
    cdf = np.cumsum(pdf) / pdf.sum()  # the density, integrated on its grid
    stat = scipy.stats.kstest(angles, lambda x: np.interp(x, omega, cdf))
    assert stat.pvalue > 1e-3, stat
    rot = so3.sample(g, torch.tensor(t), 20000)
    axes = rot / rot.norm(dim=-1, keepdim=True)
    assert axes.mean(0).abs().max() < 0.03  # uniform axes


def test_cli_train_saves_resumes_and_docks(small_data, tmp_path):
    ck = str(tmp_path / "ck")
    common = ["--data-dir", small_data, "--crop-size", "64", "--device", "cpu",
              "--log-every", "1", "--pool-variants", "1", "--ckpt-dir", ck]
    out = train.main(common + ["--epochs", "2", "--grad-energy", "--use-contrastive-loss",
                               "--save-every", "1", "--metrics-json", str(tmp_path / "m.jsonl")])
    assert out["steps"] == 4 and len(out["rows"]) == 4
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    with open(tmp_path / "m.jsonl") as f:
        assert len(f.readlines()) == 4
    assert os.path.exists(os.path.join(ck, "epoch0", "weights.npz"))
    with open(os.path.join(ck, "config.yaml")) as f:
        written = yaml.safe_load(f)
    jax_cfg = JaxDFMDockConfig(
        model=JaxModelConfig(compute_dtype="float32"),
        experiment=JaxExperimentConfig(grad_energy=True, use_contrastive_loss=True))
    assert written == dataclasses.asdict(jax_cfg)

    weights = os.path.join(ck, "weights.npz")
    trained = load_model(weights, DFMDockConfig(), torch.device("cpu"))
    for k, v in out["net"].state_dict().items():
        assert torch.equal(trained.state_dict()[k], v), k
    resumed = train.main(common[:-1] + [str(tmp_path / "ck2"), "--epochs", "0",
                                        "--resume", weights])
    for k, v in load_npz(weights).items():
        assert torch.equal(resumed["net"].state_dict()[k], v), k
    rows = dock.main(["--npz", f"data/db5_npz/{SMALL_IDS[0]}.npz", "--ckpt", weights,
                      "--device", "cpu", "--num-samples", "2", "--num-steps", "2",
                      "--out-dir", str(tmp_path / "dock")])
    assert len(rows) == 2 and all(np.isfinite(r["energy"]) for r in rows)


def test_cli_train_dfmdock_no_pool(small_data, tmp_path):
    out = train.main(["--data-dir", small_data, "--crop-size", "64", "--device", "cpu",
                      "--lineage", "dfmdock", "--no-pool", "--epochs", "1", "--log-every", "1",
                      "--grad-energy", "--use-dist-loss", "--use-confidence-loss",
                      "--ckpt-dir", str(tmp_path / "ck")])
    assert out["steps"] == 2
    assert {"dist_loss", "conf_loss", "l_rmsd"} <= set(out["rows"][0])
    load_model(str(tmp_path / "ck" / "weights.npz"), DFMDockConfig(), torch.device("cpu"),
               lineage="dfmdock")


def test_dispatch_chunk_matches_jax():
    from dfmdock_tpu.cli.train import dispatch_chunk as jax_dispatch_chunk

    for args in [(e, n, k, r, v) for e in range(0, 30, 3) for n in (7, 30) for k in (1, 4, 10)
                 for r in (0, 5, 25) for v in (0, 6) if e < n]:
        assert train.dispatch_chunk(*args) == jax_dispatch_chunk(*args), args


@pytest.mark.parametrize("flags", [["--dp"]])
def test_cli_train_refuses_unported_options(flags, capsys):
    """--dp refuses the default --batch-size 1 as the JAX package does
    (tests/test_torch_parallel.py)."""
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu"] + flags)
    assert "--dp requires --batch-size" in capsys.readouterr().err


def test_cli_train_bf16(small_data, tmp_path):
    """2 epochs at --compute-dtype bfloat16 (mlsb, the second-order energy
    term): finite metrics, config.yaml as the JAX CLI writes it, and the
    saved weights load for a float32 dock as for a bfloat16 one."""
    ck = str(tmp_path / "ck")
    out = train.main(["--data-dir", small_data, "--crop-size", "64", "--device", "cpu",
                      "--log-every", "1", "--pool-variants", "1", "--epochs", "2",
                      "--grad-energy", "--compute-dtype", "bfloat16", "--ckpt-dir", ck])
    assert out["steps"] == 4
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    assert out["net"].cfg.compute_dtype == "bfloat16"
    with open(os.path.join(ck, "config.yaml")) as f:
        written = yaml.safe_load(f)
    jax_cfg = JaxDFMDockConfig(model=JaxModelConfig(compute_dtype="bfloat16"),
                               experiment=JaxExperimentConfig(grad_energy=True))
    assert written == dataclasses.asdict(jax_cfg)
    trained = load_model(os.path.join(ck, "weights.npz"), DFMDockConfig(), torch.device("cpu"))
    for k, v in out["net"].state_dict().items():
        assert torch.equal(trained.state_dict()[k], v), k


def test_cli_train_bf16_dp_two_ranks(small_data, tmp_path):
    """--dp at bfloat16 over two gloo ranks: one step of the two complexes
    of the DFMDock lineage, finite, rank 0 saving."""
    ck = str(tmp_path / "ck")
    out = train.main(["--data-dir", small_data, "--crop-size", "64", "--device", "cpu",
                      "--lineage", "dfmdock", "--grad-energy", "--log-every", "1",
                      "--pool-variants", "1", "--epochs", "1", "--batch-size", "2", "--dp",
                      "--world-size", "2", "--compute-dtype", "bfloat16", "--ckpt-dir", ck])
    assert out["steps"] == 1
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    with open(os.path.join(ck, "config.yaml")) as f:
        assert yaml.safe_load(f)["model"]["compute_dtype"] == "bfloat16"
    load_model(os.path.join(ck, "weights.npz"), DFMDockConfig(), torch.device("cpu"),
               lineage="dfmdock")


def test_trainer_fit_and_evaluate(tmp_path):
    """Trainer.fit steps over the batches and keeps the last and the best
    weights; evaluate averages the loss terms and leaves the weights."""
    from dfmdock_tpu_torch.diffusion import R3Diffuser
    from dfmdock_tpu_torch.config import R3Config
    from dfmdock_tpu_torch.models import ScoreNet
    from dfmdock_tpu_torch.train.losses import loss_fn
    from dfmdock_tpu_torch.train.trainer import Trainer

    _, pcfg = configs()
    net = ScoreNet(pcfg).init_weights(torch.Generator().manual_seed(0))
    batches = [port_batch(padded(40, 30, seed=s)) for s in (1, 2)]
    trainer = Trainer(net, R3Diffuser(R3Config()), SO3Diffuser(SO3Config()),
                      ExperimentConfig(grad_energy=True), loss_fn, ckpt_dir=str(tmp_path))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    logged = []
    trainer.fit(batches, torch.Generator().manual_seed(1), num_epochs=2, val_batches=batches[:1],
                log_every=1, log_fn=logged.append)
    assert [m["step"] for m in logged] == [1, 2, 3, 4]
    assert not torch.equal(net.single_embed.weight, before["single_embed.weight"])
    assert torch.equal(net.t_embed.W, before["t_embed.W"])
    assert os.path.exists(tmp_path / "weights.npz") and os.path.exists(tmp_path / "best" / "weights.npz")
    after = {k: v.clone() for k, v in net.state_dict().items()}
    val = trainer.evaluate(batches, torch.Generator().manual_seed(2))
    assert set(val) == {"tr_loss", "rot_loss", "ec_loss", "el_loss", "ires_loss", "loss"}
    assert all(np.isfinite(v) for v in val.values())
    for k, v in net.state_dict().items():
        assert torch.equal(v, after[k]), k
