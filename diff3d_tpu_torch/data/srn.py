"""SRN object views for the sampler (counterpart:
``diff3d_tpu/data/srn.py:81-149``).

An own copy of the pose / intrinsics readers and the PIL decode (BOX
resampling, [-1, 1], first 3 channels).  PIL is imported where an image
is decoded, not at module import.  The native C++ decoder and the training
dataset come with the training slice.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def load_pose(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``pose/<view>.txt`` holds a flat 4x4 world-from-camera matrix;
    returns ``(R [3,3], T [3])``."""
    mat = np.loadtxt(path).reshape(4, 4)
    return mat[:3, :3], mat[:3, 3]


def load_intrinsics(path: str) -> np.ndarray:
    """``intrinsics/<view>.txt`` holds a flat 3x3 K."""
    return np.loadtxt(path).reshape(3, 3)


def decode_image(img, imgsize: int) -> np.ndarray:
    """PIL image -> ``[s, s, 3] float32`` in [-1, 1]: BOX (area-average)
    resize, grayscale promoted, alpha dropped."""
    from PIL import Image

    if img.size != (imgsize, imgsize):
        img = img.resize((imgsize, imgsize), Image.BOX)
    arr = np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr[..., :3]


def load_view_image(path: str, imgsize: int) -> np.ndarray:
    """One view png -> ``[s, s, 3] float32`` in [-1, 1]."""
    from PIL import Image

    with Image.open(path) as img:
        return decode_image(img, imgsize)


def load_object_views(object_dir: str, imgsize: int = 64
                      ) -> Dict[str, np.ndarray]:
    """Every view of one SRN object dir (``rgb/ pose/ intrinsics/``):
    ``imgs [V, s, s, 3]``, ``R [V, 3, 3]``, ``T [V, 3]`` and the first
    view's ``K [3, 3]``, all float32."""
    rgb = os.path.join(object_dir, "rgb")
    views = sorted(f for f in os.listdir(rgb) if f.endswith(".png"))
    if not views:
        raise FileNotFoundError(f"no views under {rgb}")
    imgs = np.stack([load_view_image(os.path.join(rgb, v), imgsize)
                     for v in views])
    Rs, Ts = [], []
    for v in views:
        R, T = load_pose(os.path.join(object_dir, "pose", v[:-4] + ".txt"))
        Rs.append(R.astype(np.float32))
        Ts.append(T.astype(np.float32))
    K = load_intrinsics(os.path.join(object_dir, "intrinsics",
                                     views[0][:-4] + ".txt"))
    return {"imgs": imgs, "R": np.stack(Rs), "T": np.stack(Ts),
            "K": K.astype(np.float32)}
