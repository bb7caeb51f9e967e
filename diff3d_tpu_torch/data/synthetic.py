"""Procedural stand-in dataset with the sample contract of
:class:`diff3d_tpu_torch.data.srn.SRNDataset` (counterpart:
``diff3d_tpu/data/synthetic.py::SyntheticDataset``).

Lets the trainer run with no SRN data.  Cameras sit on a sphere looking
at the origin with SRN-like intrinsics, and images are a deterministic
function of the object id and view angle (a shaded gradient), so two
views of one "object" are consistent enough to overfit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _look_at(cam_pos: np.ndarray) -> np.ndarray:
    """World-from-camera rotation for a camera at ``cam_pos`` looking at
    the origin (OpenCV convention: +z forward, +y down)."""
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=1)


class SyntheticDataset:
    """``sample(idx, rng)`` matches :class:`SRNDataset`'s contract:
    ``imgs [V, s, s, 3]`` f32 in [-1, 1], ``R [V, 3, 3]``, ``T [V, 3]``,
    ``K [3, 3]``."""

    def __init__(self, num_objects: int = 8, num_views: int = 16,
                 imgsize: int = 16, seed: int = 0, sample_views: int = 2):
        self.num_objects = num_objects
        self.num_views = num_views
        self.imgsize = imgsize
        self.sample_views = sample_views
        self.ids = list(range(num_objects))
        s = imgsize
        self.K = np.array([[s * 1.2, 0.0, s / 2],
                           [0.0, s * 1.2, s / 2],
                           [0.0, 0.0, 1.0]], np.float32)
        rng = np.random.default_rng(seed)
        self._phases = rng.uniform(0, 2 * np.pi, size=(num_objects, 3))

    def __len__(self) -> int:
        return self.num_objects

    def _view(self, obj: int, view: int):
        theta = 2 * np.pi * view / self.num_views
        phi = 0.3 + 0.2 * np.sin(self._phases[obj, 0] + view)
        r = 2.0
        cam = r * np.array([np.cos(theta) * np.cos(phi),
                            np.sin(theta) * np.cos(phi),
                            np.sin(phi)], np.float32)
        R = _look_at(cam).astype(np.float32)
        s = self.imgsize
        yy, xx = np.meshgrid(np.linspace(-1, 1, s), np.linspace(-1, 1, s),
                             indexing="ij")
        ph = self._phases[obj]
        img = np.stack([np.sin(3 * xx + theta + ph[0]),
                        np.cos(2 * yy - theta + ph[1]),
                        np.sin(xx * yy + ph[2] + phi)], axis=-1)
        return img.astype(np.float32), R, cam

    def sample(self, idx: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
        views = rng.choice(self.num_views, size=self.sample_views,
                           replace=False)
        imgs, Rs, Ts = zip(*(self._view(idx, v) for v in views))
        return {"imgs": np.stack(imgs), "R": np.stack(Rs),
                "T": np.stack(Ts), "K": self.K}

    def all_views(self, obj: int) -> Dict[str, np.ndarray]:
        imgs, Rs, Ts = zip(*(self._view(obj, v)
                             for v in range(self.num_views)))
        return {"imgs": np.stack(imgs), "R": np.stack(Rs),
                "T": np.stack(Ts), "K": self.K}
