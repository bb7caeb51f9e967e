"""diff3d_tpu_torch — the PyTorch/CUDA port of ``diff3d_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``diff3d_tpu`` stays the reference; this package grows
beside it slice by slice, keeping its layout and module names so each
module's counterpart is found at the same path.  It imports ``torch``,
numpy and the standard library only — never ``jax``, ``flax`` or
``diff3d_tpu``.  Every Pallas kernel of the reference on a ported path
becomes a hand-written CUDA C++ kernel under ``ops/csrc/``, built with
``nvcc`` at first use.

Entry points (:func:`diff3d_tpu_torch.models.build_model`,
:class:`diff3d_tpu_torch.sampling.Sampler`,
:class:`diff3d_tpu_torch.train.Trainer`, ``cli/sample_cli.py``,
``cli/train_cli.py``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without an explicit device they
raise.
"""

__version__ = "0.1.0"

from diff3d_tpu_torch.config import (Config, DataConfig, DiffusionConfig,
                                     ModelConfig, TrainConfig, srn64_config,
                                     srn128_config, test_config)

__all__ = ["Config", "DataConfig", "DiffusionConfig", "ModelConfig",
           "TrainConfig", "srn64_config", "srn128_config", "test_config"]
