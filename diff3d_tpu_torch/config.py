"""Typed configuration of the port (counterpart: ``diff3d_tpu/config.py``).

An own copy of the model, diffusion, train and data settings the sampling
and training slices act on, with the JAX package's values.  Left out until
a slice acts on them: ``remat`` / ``remat_policy`` (srn128);
``attn_impl`` / ``attn_impl_levels`` and ``kernels`` (the port runs one
implementation per device, see :mod:`diff3d_tpu_torch.ops.dispatch`);
``eval_every``, ``ckpt_mode`` / ``ckpt_async``; and the mesh / serving
sections.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """X-UNet hyperparameters (reference ``xunet.py:355-366``).

    ``attn_levels`` are depth levels (0..num_resolutions), the middle
    block being level ``num_resolutions``.
    """

    H: int = 128
    W: int = 128
    ch: int = 256
    ch_mult: Sequence[int] = (1, 2, 2, 4)
    emb_ch: int = 1024
    num_res_blocks: int = 3
    attn_levels: Sequence[int] = (2, 3, 4)
    attn_heads: int = 4
    dropout: float = 0.1
    use_pos_emb: bool = True
    use_ref_pose_emb: bool = True
    logsnr_clip: float = 20.0
    dtype: str = "bfloat16"        # compute dtype; params stay float32

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    def validate(self) -> None:
        down = 2 ** (len(self.ch_mult) - 1)
        if self.H % down or self.W % down:
            raise ValueError(
                f"H={self.H}, W={self.W} must be divisible by {down} "
                f"(len(ch_mult)-1 downsamplings)")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"dtype={self.dtype!r} not in ('bfloat16', 'float32')")
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(f"dropout={self.dropout} not in [0, 1]")


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Continuous-time logSNR-parameterised VP diffusion (reference
    ``train.py:30-177``)."""

    logsnr_min: float = -20.0
    logsnr_max: float = 20.0
    cond_prob: float = 0.1           # CFG dropout probability
    loss_type: str = "l2"            # 'l1' | 'l2' | 'huber'
    timesteps: int = 256
    guidance_weights: Sequence[float] = (0, 1, 2, 3, 4, 5, 6, 7)
    clip_x0: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer settings: Adam betas (0.9, 0.99), peak lr 1e-4 with linear
    warmup over the first 10M examples, global batch 128, EMA half-life
    500K examples (the paper config the JAX package carries)."""

    lr: float = 1e-4
    betas: Sequence[float] = (0.9, 0.99)
    warmup_examples: int = 10_000_000   # linear warmup over examples
    global_batch: int = 128
    max_steps: int = 100_000
    ckpt_every: int = 50
    log_every: int = 50
    ema_halflife_examples: int = 500_000
    # Each optimizer step runs `accum_steps` microbatches of
    # global_batch / accum_steps examples, gradients and loss averaged.
    accum_steps: int = 1
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    grad_clip: float = 0.0              # global-norm clip; 0 disables


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """SRN dataset settings (image size, the seeded 90/10 split)."""

    imgsize: int = 64
    split_seed: int = 0
    train_fraction: float = 0.9


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def validate(self) -> None:
        self.model.validate()
        if self.diffusion.loss_type not in ("l1", "l2", "huber"):
            raise ValueError(f"loss_type={self.diffusion.loss_type!r} not "
                             "in ('l1', 'l2', 'huber')")
        if self.train.accum_steps < 1 \
                or self.train.global_batch % self.train.accum_steps:
            raise ValueError(
                f"global_batch ({self.train.global_batch}) must be "
                f"divisible by accum_steps ({self.train.accum_steps})")
        if self.model.logsnr_clip != self.diffusion.logsnr_max:
            raise ValueError(
                f"model.logsnr_clip ({self.model.logsnr_clip}) must equal "
                f"diffusion.logsnr_max ({self.diffusion.logsnr_max})")


def srn64_config() -> Config:
    """``XUNet(H=64, W=64, ch=128)``, the configuration every reference
    entry point runs (train.py:229, sampling.py:51)."""
    return Config(model=ModelConfig(H=64, W=64, ch=128))


def srn128_config() -> Config:
    """The paper's full-resolution configuration."""
    return Config(model=ModelConfig(H=128, W=128, ch=256))


def test_config(imgsize: int = 16, ch: int = 8,
                shallow: bool = False) -> Config:
    """Tiny configuration for unit tests, the same as the JAX package's
    ``test_config`` in every field the port carries."""
    model_kw = dict(H=imgsize, W=imgsize, ch=ch, emb_ch=32,
                    num_res_blocks=1, dropout=0.0, dtype="float32")
    if shallow:
        model_kw.update(ch_mult=(1, 2), attn_levels=(1, 2))
    return Config(model=ModelConfig(**model_kw),
                  diffusion=DiffusionConfig(timesteps=4),
                  train=TrainConfig(global_batch=8, warmup_examples=1024,
                                    max_steps=4, ckpt_every=2, log_every=1),
                  data=DataConfig(imgsize=imgsize))
