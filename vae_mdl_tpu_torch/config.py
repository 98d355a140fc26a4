"""Dataclass configs, field for field the JAX package's ``vae_mdl_tpu/config.py``.

The configs are pure data and carry no framework, but ``vae_mdl_tpu``
imports jax on any subpackage import, so the port keeps its own copy.
``tests/test_torch_config.py`` holds the two copies equal.

One field reads differently here: ``ModelConfig.use_pallas`` selects the
hand-written CUDA kernels instead of the Pallas ones. ``None`` = auto (the
kernel for CUDA tensors, the plain PyTorch version for CPU tensors),
``True`` = the kernel (CPU tensors raise), ``False`` = the plain version.
``MeshConfig`` counts ranks (one process per device) where the JAX one
counts devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# (features, kernel, stride, transpose, activation)
ConvLayer = Tuple[int, int, int, bool, str]


def conv(features: int, kernel: int, stride: int, activation: str = "relu") -> ConvLayer:
    return (features, kernel, stride, False, activation)


def deconv(features: int, kernel: int, stride: int, activation: str = "relu") -> ConvLayer:
    return (features, kernel, stride, True, activation)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    kind: str = "conv"  # "mlp" | "conv"
    # mlp
    n_hidden: int = 200
    activation: str = "tanh"
    std_transform: str = "exp"
    # conv
    conv_layers: Tuple[ConvLayer, ...] = ()
    n_glu: int = 0
    glu_features: int = 64
    glu_activation: str = "relu"


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    kind: str = "conv"  # "mlp" | "conv"
    # mlp
    n_hidden: int = 200
    activation: str = "tanh"
    # conv
    base_size: Tuple[int, int, int] = (4, 4, 128)
    pre_layers: Tuple[ConvLayer, ...] = ()
    conv_layers: Tuple[ConvLayer, ...] = ()
    n_glu: int = 0
    glu_features: int = 64
    glu_activation: str = "relu"
    fc_activation: str = "relu"
    # emit >= this many likelihood-head channels and slice to the real count
    # (0 = exact head; no zoo entry sets it)
    head_pad: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model01"
    image_shape: Tuple[int, int, int] = (28, 28, 1)
    n_latent: int = 100
    n_samples: int = 5  # importance samples k during training
    likelihood: str = "bernoulli"  # bernoulli | gaussian | dl | mdl
    bound_logstd: bool = False
    n_mix: int = 5
    # stochastic depth: 1 = models 01-05; 2 = model06
    n_stochastic: int = 1
    mlp_hidden: int = 100
    mlp_activation: str = "gelu"
    latent_sizes: Tuple[int, ...] = ()  # defaults to (n_latent,) * n_stochastic
    encoder: EncoderConfig = EncoderConfig()
    decoder: DecoderConfig = DecoderConfig()
    compute_dtype: str = "float32"  # "bfloat16" for the conv/matmul body
    # hand-written CUDA likelihood kernels: None = auto (kernel for CUDA
    # tensors, plain version for CPU tensors); True = kernel; False = plain
    use_pallas: Optional[bool] = None
    # dtype of the decoder-head -> likelihood boundary tensor (mdl only);
    # the likelihood math itself always runs float32. None = float32.
    likelihood_io_dtype: Optional[str] = None
    beta: float = 1.0
    objective: str = "iwae"  # "iwae" | "elbo" | "iwae_dreg"
    free_bits: float = 0.0

    def __post_init__(self):
        if self.likelihood_io_dtype is not None:
            if self.likelihood_io_dtype not in ("bfloat16", "float32", "float16"):
                raise ValueError(
                    "likelihood_io_dtype must be one of 'bfloat16', "
                    "'float32', 'float16' or None; got "
                    f"{self.likelihood_io_dtype!r}")
            if self.likelihood != "mdl":
                raise ValueError(
                    "likelihood_io_dtype only applies to the 'mdl' "
                    "likelihood (it quantizes the MoDL head->kernel "
                    f"boundary tensor); likelihood={self.likelihood!r} "
                    "would silently ignore it")

    def latents(self) -> Tuple[int, ...]:
        return self.latent_sizes or (self.n_latent,) * self.n_stochastic


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "mnist"  # mnist | svhn_cropped | cifar10 | celeba | synthetic
    data_dir: Optional[str] = None
    batch_size: int = 128
    val_batch_size: int = 500
    dynamic_binarization: bool = True  # mnist only
    augment_flip: bool = False
    strict: bool = False
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_updates: int = 1_000_000
    eval_interval: int = 1000
    learning_rate: float = 1e-3
    lr_staircase: bool = True
    lr_staircase_base: int = 7000
    lr_staircase_levels: int = 8
    lr_warmup_steps: int = 0
    beta_warmup_steps: int = 0
    optimizer: str = "adam"  # "adam" | "adam_keras" | "adamax"
    grad_accum_steps: int = 1
    grad_clip_norm: float = 0.0
    grad_skip_threshold: float = 0.0
    steps_per_call: int = 1
    device_dataset: bool = False
    seed: int = 0
    checkpoint_dir: str = "./saved_models"
    log_dir: str = "/tmp/tensorboard"
    resume: bool = True
    snapshot_interval: int = 0
    max_snapshots: int = 3
    ema_decay: float = 0.0
    report_images: bool = True
    n_eval_samples: int = 5000  # importance samples for the final eval


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The rank mesh (``parallel.mesh.make_mesh``): ``data`` shards the
    batch, ``sample`` the importance samples of the evaluation, ``model``
    the wide layers' output channels (tensor parallelism,
    ``parallel/tensor.py``)."""

    data: int = -1  # -1: every rank not on sample or model
    sample: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
