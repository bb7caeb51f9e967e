"""VGG16 fc2 features for FID from a local weights file (counterpart:
``diff3d_tpu/evaluation/features.py``).

No pretrained weights are in the repository, so the extractor takes a
torchvision-format VGG16 ``state_dict`` saved as ``.pth`` / ``.pt`` or as
an ``.npz`` with the same key names (``features.{i}.weight``,
``classifier.{i}.weight``, ...).  The architecture is inferred from the
key names and shapes -- conv widths, pool placement (index gaps in the
``features.*`` numbering) and input resolution (from ``classifier.0``'s
fan-in) -- so the same code runs the real 224x224 VGG16 and tiny test
networks.  The feature is the 4096-d "fc2" embedding, ``classifier.3``
after ReLU; numbers through it are labelled ``fid``, the random-embedding
fallback's ``fid_randfeat``.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diff3d_tpu_torch.evaluation.parity import resize_bilinear

# ImageNet normalisation (torchvision's), applied to [0, 1] inputs.
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torchvision-style state dict from ``.npz`` or ``.pth`` / ``.pt``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):  # a whole module was saved
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _vgg_spec(sd: Dict[str, np.ndarray]
              ) -> Tuple[List[Tuple[int, bool]], int]:
    """``([(features_index, pool_after), ...], input_hw)`` from
    torchvision VGG key names: a gap of 3 between conv indices is
    conv -> ReLU -> MaxPool, a gap of 2 conv -> ReLU; the last conv is
    followed by a pool; the input size solves ``classifier.0`` fan-in =
    C_last * s * s with s = hw / 2^n_pools."""
    idxs = sorted(int(m.group(1)) for k in sd
                  if (m := re.fullmatch(r"features\.(\d+)\.weight", k)))
    if not idxs or "classifier.0.weight" not in sd:
        raise ValueError(
            "weights are not a torchvision-style VGG state dict "
            f"(conv indices {idxs}, keys {sorted(sd)[:5]}...)")
    convs = [(a, b - a == 3) for a, b in zip(idxs, idxs[1:])]
    convs.append((idxs[-1], True))
    n_pools = sum(p for _, p in convs)
    c_last = sd[f"features.{idxs[-1]}.weight"].shape[0]
    fan_in = sd["classifier.0.weight"].shape[1]
    s2, rem = divmod(fan_in, c_last)
    s = int(round(np.sqrt(s2)))
    if rem or s * s != s2:
        raise ValueError(
            f"classifier.0 fan-in {fan_in} is not c_last*s^2 (c={c_last})")
    return convs, s * (2 ** n_pools)


def vgg16_feature_fn(weights_path: str
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``[B, H, W, 3]`` in [-1, 1] -> ``[B, 4096]`` fc2 features, from a
    local VGG16 weights file (see the module docstring).  Runs in float32
    on the images' device (TF32 off)."""
    sd = load_state_dict(weights_path)
    convs, input_hw = _vgg_spec(sd)
    params = {k: torch.as_tensor(np.asarray(v, np.float32))
              for k, v in sd.items()
              if k.startswith(("features.", "classifier."))}
    mean = torch.as_tensor(_IMAGENET_MEAN)
    std = torch.as_tensor(_IMAGENET_STD)
    on = {}

    def feats(imgs) -> torch.Tensor:
        x = torch.as_tensor(imgs).float()
        dev = x.device
        if on.get("device") != dev:
            on.update({k: v.to(dev) for k, v in params.items()})
            on["device"] = dev
        B = x.shape[0]
        x = resize_bilinear((x + 1.0) / 2.0, (input_hw, input_hw))
        x = ((x - mean.to(dev)) / std.to(dev)).permute(0, 3, 1, 2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for i, pool_after in convs:
                x = F.relu(F.conv2d(x, on[f"features.{i}.weight"],
                                    on[f"features.{i}.bias"], padding=1))
                if pool_after:
                    x = F.max_pool2d(x, 2, 2)
        x = x.reshape(B, -1)          # NCHW flatten, torchvision's order
        x = F.relu(F.linear(x, on["classifier.0.weight"],
                            on["classifier.0.bias"]))
        return F.relu(F.linear(x, on["classifier.3.weight"],
                               on["classifier.3.bias"]))

    return feats


def resolve_feature_fn(weights_path=None):
    """``(feature_fn, label)``: the VGG16 extractor labelled ``'fid'`` when
    a weights file is given, else the seeded random embedding labelled
    ``'fid_randfeat'`` (:func:`~diff3d_tpu_torch.evaluation.fid.
    default_feature_fn`)."""
    from diff3d_tpu_torch.evaluation.fid import default_feature_fn

    if weights_path:
        if not os.path.exists(weights_path):
            raise FileNotFoundError(
                f"--feature_weights {weights_path} does not exist")
        return vgg16_feature_fn(weights_path), "fid"
    return default_feature_fn(), "fid_randfeat"
