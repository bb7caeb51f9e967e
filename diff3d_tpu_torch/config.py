"""Typed configuration of the port (counterpart: ``diff3d_tpu/config.py``).

An own copy of the model and diffusion settings the sampling slice acts
on.  Left out until a slice acts on them: ``dropout``, ``remat`` /
``remat_policy``, ``cond_prob`` and ``loss_type`` (training);
``attn_impl`` / ``attn_impl_levels`` and ``kernels`` (the port runs one
implementation per device, see :mod:`diff3d_tpu_torch.ops.dispatch`);
and the train / data / mesh / serving sections.
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


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Continuous-time logSNR-parameterised VP diffusion (reference
    ``train.py:30-177``)."""

    logsnr_min: float = -20.0
    logsnr_max: float = 20.0
    timesteps: int = 256
    guidance_weights: Sequence[float] = (0, 1, 2, 3, 4, 5, 6, 7)
    clip_x0: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)

    def validate(self) -> None:
        self.model.validate()
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
                    num_res_blocks=1, dtype="float32")
    if shallow:
        model_kw.update(ch_mult=(1, 2), attn_levels=(1, 2))
    return Config(model=ModelConfig(**model_kw),
                  diffusion=DiffusionConfig(timesteps=4))
