"""Procedural stand-in datasets with the sample contract of
:class:`diff3d_tpu_torch.data.srn.SRNDataset` (counterpart:
``diff3d_tpu/data/synthetic.py``): :class:`SyntheticDataset` and the
ray-traced :class:`SyntheticScenesDataset`.

Lets the trainer run with no SRN data.  Cameras sit on a sphere looking
at the origin with SRN-like intrinsics, and images are a deterministic
function of the object id and view angle (a shaded gradient), so two
views of one "object" are consistent enough to overfit.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def _rays_np(R: np.ndarray, t: np.ndarray, K: np.ndarray, H: int, W: int):
    """Numpy rays with the model's pixel-centre, world-from-camera
    convention (:func:`diff3d_tpu_torch.geometry.pinhole_rays`): origins
    ``[H, W, 3]`` at ``t`` and unit directions ``[H, W, 3]``."""
    u = np.arange(W, dtype=np.float64) + 0.5
    v = np.arange(H, dtype=np.float64) + 0.5
    uu, vv = np.meshgrid(u, v)
    px = np.stack([uu, vv, np.ones_like(uu)], axis=-1)        # [H, W, 3]
    dir_cam = np.einsum("ij,hwj->hwi", np.linalg.inv(K), px)
    dirs = np.einsum("ij,hwj->hwi", R, dir_cam)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pos = np.broadcast_to(t, dirs.shape)
    return pos, dirs


def render_spheres(pos: np.ndarray, dirs: np.ndarray,
                   centers: np.ndarray, radii: np.ndarray,
                   colors: np.ndarray) -> np.ndarray:
    """Lambertian-shaded ray-traced spheres; returns ``[H, W, 3]`` in
    [-1, 1].  The nearest positive ray-sphere intersection wins; misses
    get a view-direction gradient background."""
    oc = pos[None] - centers[:, None, None]                   # [S, H, W, 3]
    b = 2.0 * np.einsum("shwc,hwc->shw", oc, dirs)
    c = np.einsum("shwc,shwc->shw", oc, oc) - radii[:, None, None] ** 2
    disc = b * b - 4.0 * c
    hit = disc > 0
    t_hit = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0,
                     np.inf)
    t_hit = np.where(t_hit > 1e-6, t_hit, np.inf)             # behind cam
    nearest = np.argmin(t_hit, axis=0)                        # [H, W]
    depth = np.take_along_axis(t_hit, nearest[None], axis=0)[0]
    any_hit = np.isfinite(depth)
    depth = np.where(any_hit, depth, 1.0)     # keep the miss math finite

    p = pos + depth[..., None] * dirs                         # hit points
    n = p - centers[nearest]
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    light = np.array([0.577, 0.577, 0.577])
    lam = 0.35 + 0.65 * np.clip(n @ light, 0.0, 1.0)
    col = colors[nearest] * lam[..., None]

    bg = np.stack([0.15 * dirs[..., 2] - 0.55,
                   0.15 * dirs[..., 2] - 0.45,
                   0.25 * dirs[..., 2] - 0.35], axis=-1)
    img = np.where(any_hit[..., None], col, bg)
    return np.clip(img, -1.0, 1.0).astype(np.float32)


class SyntheticScenesDataset:
    """A true-3D procedural dataset (counterpart:
    ``diff3d_tpu/data/synthetic.py::SyntheticScenesDataset``): each
    object is a few coloured spheres, and its views are ray-traced renders
    through the pinhole geometry the model conditions on, so novel-view
    synthesis on it is the real task at toy scale.  Same ``sample`` /
    ``all_views`` contract as :class:`SyntheticDataset`.

    Each object draws from its own generator keyed ``(seed, obj)``, so
    object i's scene does not depend on ``num_objects``: evaluation sets
    of different sizes score the same scenes.  A view is a pure function
    of ``(object, view)``, so each is rendered once and kept
    (``num_objects * num_views`` images): re-rendering every sampled view
    on the host would set the pace of a small-batch run (``PERF.md``)."""

    def __init__(self, num_objects: int = 16, num_views: int = 24,
                 imgsize: int = 64, seed: int = 0, sample_views: int = 2,
                 spheres_per_object: int = 4):
        self.num_objects = num_objects
        self.num_views = num_views
        self.imgsize = imgsize
        self.sample_views = sample_views
        self.ids = list(range(num_objects))
        s = imgsize
        self.K = np.array([[s * 1.2, 0.0, s / 2],
                           [0.0, s * 1.2, s / 2],
                           [0.0, 0.0, 1.0]], np.float32)
        n_sph = spheres_per_object
        per_obj = [np.random.default_rng((seed, i))
                   for i in range(num_objects)]
        self._centers = np.stack(
            [r.uniform(-0.55, 0.55, (n_sph, 3)) for r in per_obj])
        self._radii = np.stack(
            [r.uniform(0.18, 0.4, n_sph) for r in per_obj])
        self._colors = np.stack(
            [r.uniform(-0.2, 1.0, (n_sph, 3)) for r in per_obj])
        self._phase = np.array([r.uniform(0, 2 * np.pi) for r in per_obj])
        self._views: Dict[Tuple[int, int], tuple] = {}

    def __len__(self) -> int:
        return self.num_objects

    def _view(self, obj: int, view: int):
        got = self._views.get((obj, view))
        if got is None:
            got = self._views[obj, view] = self._render(obj, view)
        return got

    def _render(self, obj: int, view: int):
        theta = 2 * np.pi * view / self.num_views + self._phase[obj]
        phi = 0.25 + 0.2 * np.sin(self._phase[obj] + 2.1 * view)
        cam = 2.6 * np.array([np.cos(theta) * np.cos(phi),
                              np.sin(theta) * np.cos(phi),
                              np.sin(phi)])
        R = _look_at(cam)
        pos, dirs = _rays_np(R, cam, self.K.astype(np.float64),
                             self.imgsize, self.imgsize)
        img = render_spheres(pos, dirs, self._centers[obj],
                             self._radii[obj], self._colors[obj])
        return img, R.astype(np.float32), cam.astype(np.float32)

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
