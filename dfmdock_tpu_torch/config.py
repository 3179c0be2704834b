"""Typed configuration, field for field the JAX package's `dfmdock_tpu/config.py`.

The dataclasses carry the same fields and defaults, so `dataclasses.asdict`
of a config here equals that of its JAX counterpart, and the same YAML files
load into both.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Score network hyperparameters (reference configs/model/score_model_mlsb.yaml)."""

    lm_embed_dim: int = 1301          # 1280 ESM2-650M + 21 one-hot
    positional_embed_dim: int = 66    # AF2-multimer relpos (clip +-32 + cross-chain class)
    spatial_embed_dim: int = 100      # 40 dist + 24 omega + 24 theta + 12 phi bins
    node_dim: int = 256
    edge_dim: int = 128
    inner_dim: int = 128
    depth: int = 6
    dropout: float = 0.1
    cut_off: float = 20.0             # energy-head pair mask cutoff (Angstrom)
    normalize: bool = True            # EGNN coord_diff normalization
    agg: str = "mean"                 # energy/force aggregation (DFMDock lineage)
    # Edge selection: 20 nearest neighbours (self included) + 40 samples by 1/d^3.
    knn: int = 20
    sample_size: int = 40
    # "bfloat16": each cast Linear rounds its input and weight to bf16 and
    # multiplies with a float32 result, as the JAX package's
    # modules.linear(dtype) (models/modules.linear, compute_dtype).  Every
    # forward honours it: training (apply_train), the eager predict route,
    # and the kernel route (use_pallas), where ops/fused_egcl runs its
    # single-pass bf16 mode, the JAX Pallas kernel's precision.  fast()
    # computes so, as the JAX package's fast(); fast(compute_dtype=
    # "float32") is the float32 kernel route.
    compute_dtype: str = "float32"
    # Inference path through the hand-written CUDA kernels (ops/edge_table.py,
    # ops/fused_egcl.py, ops/energy_head.py).  Off = the eager float32 path
    # (`--exact`).
    use_pallas: bool = False
    # With use_pallas: the edge table in one kernel (ops/edge_table
    # build_edge_table); off = its bins-only mode (edge_bins) plus plain
    # torch geometry, the JAX package's XLA-built table.
    edge_table_kernel: bool = False
    # Kept for equality with the JAX config.  The port has one selection:
    # ops/select_topk on every path (ties to the lower index, as the JAX
    # package's select_edges and select_topk_fused).
    select_kernel: bool = False
    # Center on the ligand-CA centroid inside the net (mlsb lineage).
    center_in_net: bool = True

    @property
    def edges_per_node(self) -> int:
        return self.knn + self.sample_size

    @classmethod
    def fast(cls, **overrides) -> "ModelConfig":
        """The default inference config of the dock CLI: the kernel path in
        bf16, as the JAX package's (`compute_dtype="float32"` for the
        float32 kernel route)."""
        kw = dict(
            compute_dtype="bfloat16", use_pallas=True, edge_table_kernel=True
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class R3Config:
    """Translation VE-SDE (reference r3_diffuser.py)."""

    min_sigma: float = 0.1
    max_sigma: float = 30.0


@dataclasses.dataclass(frozen=True)
class SO3Config:
    """IGSO3 VE-SDE (reference so3_diffuser.py)."""

    num_omega: int = 1000
    num_sigma: int = 1000
    min_sigma: float = 0.1
    max_sigma: float = 1.5
    schedule: str = "logarithmic"
    cache_dir: str = ".cache/igso3"
    use_cached_score: bool = False
    expansion_L: int = 1000


@dataclasses.dataclass(frozen=True)
class DiffuserConfig:
    r3: R3Config = dataclasses.field(default_factory=R3Config)
    so3: SO3Config = dataclasses.field(default_factory=SO3Config)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Training flags (train/losses.py, train/dfmdock_losses.py, train/trainer.py)."""

    lr: float = 1e-4
    weight_decay: float = 0.0
    perturb_tr: bool = True
    perturb_rot: bool = True
    separate_energy_loss: bool = True
    separate_tr_loss: bool = True
    separate_rot_loss: bool = True
    use_interface_loss: bool = True
    grad_energy: bool = False
    use_contrastive_loss: bool = False
    contrastive_weight: float = 1.0
    contrastive_margin: float = 0.0
    contrastive_t_max: float = 0.0
    contrastive_negatives: int = 1
    contrastive_clash_negatives: int = 0
    crop_size: int = 1200
    use_confidence_loss: bool = False
    use_dist_loss: bool = False


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Reverse-SDE sampling (reference inference_base.py, configs/inference.yaml)."""

    num_steps: int = 40
    eps: float = 1e-3
    tr_noise_scale: float = 0.5
    rot_noise_scale: float = 0.5
    use_clash_force: bool = False
    noise_annealing: bool = False
    ode: bool = False
    perturb_tr: bool = True
    perturb_rot: bool = True
    # pose randomization: uniform SO(3) rotation + N(0, 30 A) translation
    init_tr_sigma: float = 30.0
    # 'ca' = ligand-CA centroid, 'bb' = all-backbone-atom mean
    center_mode: str = "ca"
    # 'em' = Euler-Maruyama; 'heun' = second-order Heun on the
    # probability-flow ODE (needs ode=True)
    integrator: str = "em"


@dataclasses.dataclass(frozen=True)
class DFMDockConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffuser: DiffuserConfig = dataclasses.field(default_factory=DiffuserConfig)
    experiment: ExperimentConfig = dataclasses.field(default_factory=ExperimentConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)


_SUBCONFIGS = {
    "model": ModelConfig, "r3": R3Config, "so3": SO3Config,
    "diffuser": DiffuserConfig, "experiment": ExperimentConfig,
    "sampler": SamplerConfig,
}


def _build(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue  # tolerate extra keys (e.g. Hydra _target_)
        sub = _SUBCONFIGS.get(k)
        kwargs[k] = _build(sub, v) if (sub and isinstance(v, dict)) else v
    return cls(**kwargs)


def to_yaml(cfg: DFMDockConfig, path: str):
    """Write a config as the JAX package writes it (`dataclasses.asdict`,
    keys in field order)."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)


def from_yaml(path: str) -> DFMDockConfig:
    """Load a config YAML in the JAX package's layout."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    raw.pop("_target_", None)
    return _build(DFMDockConfig, raw)

