"""Typed configuration of the port (counterpart: ``diff3d_tpu/config.py``).

An own copy of the model, diffusion, train, data and serving settings the
ported slices act on, with the JAX package's values.  Left out until a
slice acts on them: ``attn_impl`` / ``attn_impl_levels`` and ``kernels``
(the port runs one implementation per device, see
:mod:`diff3d_tpu_torch.ops.dispatch`) and the serving fields of the cross-process fleet (heartbeats, the
transport's frame ceiling).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

REMAT_POLICIES = ("nothing", "dots")


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
    # Recompute each UNet block in the backward (``torch.utils.checkpoint``)
    # instead of keeping its activations: 'nothing' keeps only the block's
    # input, 'dots' also keeps every convolution and matrix-product output.
    remat: bool = False
    remat_policy: str = "nothing"  # 'nothing' | 'dots'

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
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy={self.remat_policy!r} not in "
                f"{REMAT_POLICIES}")
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
    # Validation-loss cadence in steps (0 disables): with a val loader
    # attached (``Trainer.val_loader``), the EMA weights are scored on a
    # held-out batch every ``eval_every`` steps and at the last step.
    eval_every: int = 0
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    # "full" (exact resume), "ema_bf16" (the bf16 EMA only: eval weights
    # and a warm restart) or "full_sliced" (exact resume, one file per
    # tensor, committed by a rename); None follows the directory's marker
    # ("full" on a fresh directory).  See train/checkpoint.py.
    ckpt_mode: Optional[str] = None
    # full_sliced only: snapshot on the training thread, write the files
    # from a background thread.  False writes them synchronously.
    ckpt_async: bool = True
    grad_clip: float = 0.0              # global-norm clip; 0 disables


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """SRN dataset settings (image size, the seeded 90/10 split)."""

    imgsize: int = 64
    split_seed: int = 0
    train_fraction: float = 0.9


#: Parameter placements the port takes.
PARAM_SHARDINGS = ("replicated", "fsdp", "tp", "fsdp+tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The process mesh (reference ``diff3d_tpu/config.py:186-215``): a
    ``(data, model)`` grid of ranks.  ``param_sharding`` places the
    parameters, Adam's moments and the EMA: ``'replicated'`` keeps a whole
    copy on every rank and all-reduces the gradients (DDP); ``'fsdp'``
    shards each parameter's largest divisible dim over the data axis
    (FSDP2); ``'tp'`` splits them Megatron-style over the model axis;
    ``'fsdp+tp'`` does both.  ``context_parallel`` splits the
    activations' image rows over the model axis (``model_parallel > 1``)
    with the ``replicated`` placement; :meth:`validate` refuses it with
    the other placements until ROADMAP A10b."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1           # -1: every rank
    model_parallel: int = 1
    param_sharding: str = "replicated"
    context_parallel: bool = False

    def validate(self) -> None:
        if self.context_parallel and self.model_parallel <= 1:
            raise ValueError(
                "context_parallel shards the spatial axis over the model "
                f"axis, but model_parallel={self.model_parallel} makes "
                "that a no-op — set model_parallel > 1")
        if self.param_sharding not in PARAM_SHARDINGS:
            raise ValueError(f"param_sharding={self.param_sharding!r} not "
                             f"in {PARAM_SHARDINGS}")
        if self.context_parallel and self.param_sharding != "replicated":
            why = ("FSDP2's replicate dim averages the gradients over the "
                   "model axis, and context parallelism needs their sum"
                   if self.param_sharding == "fsdp" else
                   "the model axis then carries the channel blocks, and "
                   "splitting both rows and channels over it is not "
                   "ported")
            raise ValueError(
                f"context_parallel=True with param_sharding="
                f"{self.param_sharding!r}: {why} (ROADMAP A10b); context "
                "parallelism takes the 'replicated' placement")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The inference service (:mod:`diff3d_tpu_torch.serving`), with the
    JAX package's defaults.

    Concurrent requests are microbatched into fixed-shape device batches
    (bucketed by image size and record capacity) and admitted between
    view steps (continuous batching at view granularity).
    """

    host: str = "127.0.0.1"
    port: int = 8080
    # Submissions beyond this many pending requests are rejected (HTTP
    # 429), never queued without bound.
    max_queue: int = 64
    # Lane ceiling per bucket; the engine pads the active set up to the
    # next power of two <= max_batch (one captured graph per lane count).
    max_batch: int = 8
    # Microbatch flush deadline after the first request of a bucket.
    max_wait_ms: float = 50.0
    # Per-request deadline (queue wait + compute).
    default_timeout_s: float = 300.0
    # LRU result cache entries keyed by request content (0 disables).
    result_cache_entries: int = 32
    # Per-request view ceiling (bounds the record capacity).
    max_views: int = 16
    # Stuck-step watchdog: a view step older than this fails its
    # in-flight requests with a typed retryable error and degrades the
    # engine; 0 disables it.
    watchdog_timeout_s: float = 600.0
    # Attempts per view step (1 = no retry) and the base backoff.
    step_retry_attempts: int = 2
    step_retry_backoff_s: float = 0.2
    # Consecutive clean steps that bring `degraded` back to `ok`.
    degraded_recovery_steps: int = 3
    # Advisory wait on typed retryable rejections (HTTP Retry-After).
    retry_after_s: float = 5.0
    # Watchdog respawns of a dead engine loop before failing fast.
    engine_max_restarts: int = 3
    # In-process engine replicas behind the fleet router's front door
    # (1 = single-replica ServingService, no router).  Each replica owns
    # its weights, samplers, graphs, scheduler and engine; sessions pin
    # to replicas.
    replicas: int = 1
    # Cross-process fleet (serving/transport.py): probe each worker every
    # `interval`; a worker silent past `timeout` is marked dead (its
    # sticky sessions get SessionLost, exactly like an in-process kill).
    heartbeat_interval_s: float = 0.25
    heartbeat_timeout_s: float = 3.0
    # Transport frame-size ceiling (a garbage length prefix must not
    # demand gigabytes of buffer).
    max_frame_bytes: int = 1 << 30

    def validate(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch={self.max_batch} must be >= 1")
        if self.max_queue < 1:
            raise ValueError(f"max_queue={self.max_queue} must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms={self.max_wait_ms} must be >= 0")
        if self.default_timeout_s <= 0:
            raise ValueError(
                f"default_timeout_s={self.default_timeout_s} must be > 0")
        if self.max_views < 2:
            raise ValueError(
                f"max_views={self.max_views} must be >= 2 (one "
                "conditioning view + one target)")
        if self.watchdog_timeout_s < 0:
            raise ValueError(
                f"watchdog_timeout_s={self.watchdog_timeout_s} must be "
                ">= 0 (0 disables)")
        if self.step_retry_attempts < 1:
            raise ValueError(
                f"step_retry_attempts={self.step_retry_attempts} must be "
                ">= 1 (1 = no retry)")
        if self.step_retry_backoff_s < 0:
            raise ValueError(
                f"step_retry_backoff_s={self.step_retry_backoff_s} must "
                "be >= 0")
        if self.degraded_recovery_steps < 1:
            raise ValueError(
                f"degraded_recovery_steps={self.degraded_recovery_steps} "
                "must be >= 1")
        if self.retry_after_s <= 0:
            raise ValueError(
                f"retry_after_s={self.retry_after_s} must be > 0")
        if self.engine_max_restarts < 0:
            raise ValueError(
                f"engine_max_restarts={self.engine_max_restarts} must be "
                ">= 0")
        if self.replicas < 1:
            raise ValueError(f"replicas={self.replicas} must be >= 1")
        if self.heartbeat_interval_s <= 0:
            raise ValueError(
                f"heartbeat_interval_s={self.heartbeat_interval_s} must "
                "be > 0")
        if self.heartbeat_timeout_s <= self.heartbeat_interval_s:
            raise ValueError(
                f"heartbeat_timeout_s={self.heartbeat_timeout_s} must "
                f"exceed heartbeat_interval_s={self.heartbeat_interval_s} "
                "(a single missed probe must not kill a replica)")
        if self.max_frame_bytes < (1 << 16):
            raise ValueError(
                f"max_frame_bytes={self.max_frame_bytes} must be >= 64 KiB "
                "(a single 8x8 view frame already needs ~1 KiB of JSON)")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    serving: ServingConfig = dataclasses.field(
        default_factory=ServingConfig)

    def validate(self) -> None:
        self.model.validate()
        self.serving.validate()
        self.mesh.validate()
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
    """The paper's full-resolution configuration, with every UNet block
    rematerialised (its activations at global batch 128 do not fit the
    card otherwise)."""
    return Config(model=ModelConfig(H=128, W=128, ch=256, remat=True))


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
