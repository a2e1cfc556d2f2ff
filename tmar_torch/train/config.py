"""Training configuration (the counterpart of ``tmar.train.config``): the
same dataclasses, field for field, loadable from YAML with
``section.key=value`` overrides.  The port's own copies of the three recipe
files are under ``tmar_torch/configs`` (``config_path`` finds them).

Two model fields keep the JAX package's names and mean "use the CUDA
kernels" here: ``use_pallas_attention`` and ``attn_backward`` (``"pallas"``
= the training form, whose attention, FFN and n-gram kernels have backward
kernels; ``"auto"``, the default, = the training form's kernels under
autograd and the whole-block inference kernels without grad; ``"xla"`` =
``"auto"`` with the attention's backward by the plain recompute).
``use_pallas_attention: false`` takes ``"auto"``.  ``xla_window_merge``
and ``remat`` are read and have no effect in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import os

from tmar_torch.losses import LossWeights

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def config_path(name: str) -> str:
    """The path of one of the package's recipe files, e.g.
    ``config_path("train_syndeeplesion.yaml")``."""
    return os.path.join(CONFIG_DIR, name)


@dataclasses.dataclass
class ModelConfig:
    arch: str = "ngswin"  # ngswin | redcnn | transformer | bafresnet
    ngrams: Tuple[int, ...] = (2, 2, 2, 2)
    in_chans: int = 1
    embed_dim: int = 64
    depths: Tuple[int, ...] = (6, 4, 4)
    num_heads: Tuple[int, ...] = (6, 4, 4)
    dec_dim: int = 64
    dec_depths: int = 6
    dec_num_heads: int = 6
    window_size: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    use_pallas_attention: bool = False
    # "auto" = the training form's kernels under autograd, the inference
    # form's (forward-only whole-block kernels) without; "pallas" = the
    # training form (kernels with hand-written backward kernels); "xla" =
    # "auto" with the attention backward by the plain recompute
    attn_backward: str = "auto"
    xla_window_merge: bool = False  # no effect in the port
    remat: bool = False             # no effect in the port


@dataclasses.dataclass
class DiscConfig:
    base_channels: int = 64
    num_layers: int = 5
    num_scales: int = 3          # B1 ablation: 1
    use_sn: bool = True          # B2 ablation: False
    kind: str = "multiscale"     # "multiscale" | "dcgan" | "conditional"
    # batch each loss's real+fake D applications into ONE pass (2 instead of
    # 4 per step).  Exact without SN; with SN it halves the power iterations
    # per step.  See make_train_step.
    fused_pairs: bool = False


@dataclasses.dataclass
class OptimConfig:
    # TTUR: lrD = 2 * lrG (reference train_combined.py:98-100)
    lr_g: float = 1e-4
    lr_d: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    grad_clip: Optional[float] = None
    # LR schedule applied to BOTH optimizers:
    # "none" | "cosine" | "step_half" | "multistep"
    schedule: str = "none"
    warmup_steps: int = 0            # cosine warmup
    min_lr: float = 0.0              # cosine floor
    schedule_step_size: int = 1000   # step_half period
    milestones: Tuple[int, ...] = () # multistep boundaries
    gamma: float = 0.5               # multistep decay factor
    # BEiT-style layer-wise LR decay on the GENERATOR; None = off
    llrd_decay: Optional[float] = None
    # one multi-tensor Adam update (train/schedules.py: build_optimizer)
    fused_update: bool = False
    # Exponential moving average of the GENERATOR params.  0.0 = off; typical
    # 0.999.  When on, validation selects the EMA weights.
    ema_decay: float = 0.0


@dataclasses.dataclass
class RadonConfig:
    enabled: bool = True
    num_angles: int = 180
    # precision of the projection products in the TRAINING physics loss:
    # "highest" (full float32), "high" or "default" (TF32 allowed on the
    # card; ops/radon.py).  The loss compares two projections by the same
    # operator, so reduced precision perturbs only the λ_phys=0.02 term.
    precision: str = "highest"


@dataclasses.dataclass
class ParallelConfig:
    """Device layout of the train step over one process per device
    (``tmar_torch.core.mesh``): ``dp`` replicates both networks and averages
    their gradients (the canonical layout), ``fsdp`` shards both with FSDP2,
    ``tp`` Megatron-splits the generator's blocks over ``model_parallel``
    ranks and needs the plain attention path (``use_pallas_attention:
    false``), as in the JAX package."""

    mode: str = "dp"            # "dp" | "tp" | "fsdp"
    model_parallel: int = 1     # model-axis size (tp only; must divide n_devices)


@dataclasses.dataclass
class DataConfig:
    # "syndeeplesion" | "spineweb" | "synthetic" | "synthetic_cache"
    dataset: str = "synthetic"
    cache_dir: str = ""          # synthetic_cache location (default: tmp)
    cache_slices: int = 512      # synthetic_cache: distinct 416² slices
    root: str = ""
    spineweb_artifact: str = ""
    spineweb_clean: str = ""
    patch_size: int = 128
    batch_size: int = 4
    samples_per_epoch: int = 16000
    num_workers: int = 2
    seed: int = 999


@dataclasses.dataclass
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    disc: DiscConfig = dataclasses.field(default_factory=DiscConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    loss: LossWeights = dataclasses.field(default_factory=LossWeights)
    radon: RadonConfig = dataclasses.field(default_factory=RadonConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    num_epochs: int = 100
    val_every_n_epochs: int = 5
    checkpoint_every_n_epochs: int = 1
    keep_last_n: int = 3
    seed: int = 999
    run_dir: str = "runs"
    run_name: Optional[str] = None
    n_devices: Optional[int] = None   # default: all
    bf16: bool = True
    log_every: int = 50
    variant: str = "full"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _build(cls, data: Dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        f = fields[k]
        sub_cls = None
        if f.default_factory is not dataclasses.MISSING:
            proto = f.default_factory()
            if dataclasses.is_dataclass(proto):
                sub_cls = type(proto)
        if sub_cls is not None and isinstance(v, dict):
            kwargs[k] = _build(sub_cls, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> TrainConfig:
    """Load a TrainConfig from YAML (with `section.key=value` overrides)."""
    data: Dict[str, Any] = {}
    if path:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = _build(TrainConfig, data)
    for key, value in (overrides or {}).items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown override {key!r}")
        if isinstance(value, list):
            value = tuple(value)  # same list→tuple rule as the YAML path
        # object.__setattr__ also works for frozen dataclasses (LossWeights)
        object.__setattr__(obj, leaf, value)
    return cfg
