"""Camera-path generators for orbit videos (counterpart:
``diff3d_tpu/trajectory/paths.py``, an own copy).

Every generator returns ``(R, T)`` with ``R [n, 3, 3]`` world-from-camera
rotations and ``T [n, 3]`` camera positions — the exact convention of
``geometry/rays.py::pinhole_rays`` (OpenCV axes: +z forward, +y down;
ray origin = ``T``, ray direction = ``R @ K^-1 [u, v, 1]``) and of
``data/synthetic.py::_look_at`` of this package, so a generated path
slots straight into an ``all_views``-style dict next to any SRN-like
intrinsics ``K``.

Everything here is host-side float32 numpy: paths are a few hundred
3x3 matrices at most, computed once per request.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["look_at", "orbit_path", "spiral_path", "keyframe_path",
           "path_from_spec", "trajectory_views", "PATH_KINDS"]

#: Path kinds the JSON spec grammar accepts.
PATH_KINDS = ("orbit", "spiral", "keyframes")


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World-from-camera rotation for a camera at ``eye`` looking at
    ``target`` (OpenCV convention: +z forward, +y down).

    Columns are ``[right, down, forward]``: ``forward`` points at the
    target, ``right = forward x up`` (so "up" in the image is world
    ``up``), ``down`` completes the right-handed frame — det is +1 by
    construction.  When the view direction is within ~8 degrees of
    ``up`` the fallback up-vector (0, 1, 0) keeps the cross products
    non-degenerate (same fallback as ``data/synthetic.py::_look_at``).
    """
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    norm = np.linalg.norm(fwd)
    if norm < 1e-9:
        raise ValueError(f"look_at: eye {eye} coincides with target")
    fwd = fwd / norm
    up = np.asarray(up, np.float64)
    up = up / np.linalg.norm(up)
    if abs(fwd @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=1).astype(np.float32)


def _poses_from_eyes(eyes: np.ndarray,
                     targets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    R = np.stack([look_at(e, t) for e, t in zip(eyes, targets)])
    return R.astype(np.float32), eyes.astype(np.float32)


def orbit_path(n_frames: int, radius: float = 2.0,
               elevation_deg: float = 20.0,
               target=(0.0, 0.0, 0.0),
               azimuth0_deg: float = 0.0,
               full_turns: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Circular orbit around ``target`` at constant radius/elevation.

    ``n_frames`` azimuths are spaced evenly over ``full_turns`` turns
    WITHOUT the duplicated endpoint, so a one-turn orbit is seamless as
    a looping video: the (virtual) frame ``n_frames`` coincides with
    frame 0 — the closure property the pose-math tests pin.
    """
    if n_frames < 1:
        raise ValueError(f"n_frames={n_frames} must be >= 1")
    if radius <= 0:
        raise ValueError(f"radius={radius} must be > 0")
    target = np.asarray(target, np.float64)
    az = (np.deg2rad(azimuth0_deg)
          + 2.0 * np.pi * full_turns * np.arange(n_frames) / n_frames)
    el = np.deg2rad(elevation_deg) * np.ones(n_frames)
    eyes = target + radius * np.stack(
        [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)],
        axis=-1)
    return _poses_from_eyes(eyes, np.broadcast_to(target, eyes.shape))


def spiral_path(n_frames: int, radius: float = 2.0,
                elevation_start_deg: float = -10.0,
                elevation_end_deg: float = 45.0,
                target=(0.0, 0.0, 0.0),
                azimuth0_deg: float = 0.0,
                full_turns: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Orbit whose elevation sweeps linearly start -> end across the
    path — the classic turntable-with-rise qualitative shot."""
    if n_frames < 1:
        raise ValueError(f"n_frames={n_frames} must be >= 1")
    if radius <= 0:
        raise ValueError(f"radius={radius} must be > 0")
    target = np.asarray(target, np.float64)
    az = (np.deg2rad(azimuth0_deg)
          + 2.0 * np.pi * full_turns * np.arange(n_frames) / n_frames)
    frac = (np.arange(n_frames) / max(1, n_frames - 1)
            if n_frames > 1 else np.zeros(1))
    el = np.deg2rad(elevation_start_deg
                    + (elevation_end_deg - elevation_start_deg) * frac)
    # Clamp away from the poles so look_at never degenerates.
    el = np.clip(el, np.deg2rad(-80.0), np.deg2rad(80.0))
    eyes = target + radius * np.stack(
        [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)],
        axis=-1)
    return _poses_from_eyes(eyes, np.broadcast_to(target, eyes.shape))


def keyframe_path(keyframes: Sequence, n_frames: int,
                  targets: Optional[Sequence] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Piecewise-linear look-at path through camera-position keyframes.

    ``keyframes`` is ``[k, 3]`` camera positions (k >= 2); ``targets``
    is ``[k, 3]`` per-keyframe look-at targets (default: origin for
    all).  Positions and targets interpolate linearly on a uniform
    parameter; each interpolated pose is re-orthonormalised through
    :func:`look_at`, so the output is exactly SO(3) even though the
    interpolation itself is Euclidean.
    """
    eyes_k = np.asarray(keyframes, np.float64)
    if eyes_k.ndim != 2 or eyes_k.shape[-1] != 3 or eyes_k.shape[0] < 2:
        raise ValueError(
            f"keyframes must be [k>=2, 3], got {eyes_k.shape}")
    if targets is None:
        tgts_k = np.zeros_like(eyes_k)
    else:
        tgts_k = np.asarray(targets, np.float64)
        if tgts_k.shape != eyes_k.shape:
            raise ValueError(
                f"targets shape {tgts_k.shape} != keyframes "
                f"{eyes_k.shape}")
    if n_frames < 1:
        raise ValueError(f"n_frames={n_frames} must be >= 1")
    if np.any(np.linalg.norm(eyes_k - tgts_k, axis=-1) < 1e-6):
        raise ValueError("a keyframe eye coincides with its target")
    u = (np.arange(n_frames) / max(1, n_frames - 1)
         if n_frames > 1 else np.zeros(1)) * (eyes_k.shape[0] - 1)
    i0 = np.minimum(u.astype(np.int64), eyes_k.shape[0] - 2)
    w = (u - i0)[:, None]
    eyes = (1.0 - w) * eyes_k[i0] + w * eyes_k[i0 + 1]
    tgts = (1.0 - w) * tgts_k[i0] + w * tgts_k[i0 + 1]
    return _poses_from_eyes(eyes, tgts)


def path_from_spec(spec: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Build a path from a JSON-shaped spec.

    ``{"kind": "orbit"|"spiral"|"keyframes", "frames": N, ...}`` — the
    remaining keys are the keyword arguments of the matching generator
    (``radius``, ``elevation_deg``, ``target``, ``azimuth0_deg``,
    ``full_turns``, ``elevation_start_deg``/``elevation_end_deg``,
    ``keyframes``/``targets``).  Unknown kinds and unknown keys raise
    ``ValueError``, so a typo is an error, not a silent default.
    """
    if not isinstance(spec, dict):
        raise ValueError(f"path spec must be an object, got {type(spec)}")
    spec = dict(spec)
    kind = spec.pop("kind", None)
    if kind not in PATH_KINDS:
        raise ValueError(
            f"path kind {kind!r} not in {PATH_KINDS}")
    frames = spec.pop("frames", None)
    if frames is None:
        raise ValueError("path spec must carry 'frames'")
    frames = int(frames)
    fns = {"orbit": orbit_path, "spiral": spiral_path,
           "keyframes": keyframe_path}
    fn = fns[kind]
    if kind == "keyframes":
        keyframes = spec.pop("keyframes", None)
        if keyframes is None:
            raise ValueError("keyframes path spec must carry 'keyframes'")
        kwargs = {"targets": spec.pop("targets", None)}
        args = (keyframes, frames)
    else:
        kwargs, args = {}, (frames,)
    allowed = {"orbit": {"radius", "elevation_deg", "target",
                         "azimuth0_deg", "full_turns"},
               "spiral": {"radius", "elevation_start_deg",
                          "elevation_end_deg", "target", "azimuth0_deg",
                          "full_turns"},
               "keyframes": set()}[kind]
    unknown = set(spec) - allowed
    if unknown:
        raise ValueError(
            f"unknown {kind} path keys {sorted(unknown)} "
            f"(allowed: {sorted(allowed)})")
    kwargs.update(spec)
    return fn(*args, **kwargs)


def trajectory_views(cond_img: np.ndarray, cond_R: np.ndarray,
                     cond_T: np.ndarray, K: np.ndarray,
                     path_R: np.ndarray, path_T: np.ndarray) -> dict:
    """Assemble the ``all_views``-style dict for a trajectory request:
    view 0 is the conditioning view (its image is the only one
    consumed), views 1.. are the path poses to synthesise.  The
    returned dict plugs straight into ``Sampler.synthesize``."""
    cond_img = np.asarray(cond_img, np.float32)
    if cond_img.ndim == 3:
        cond_img = cond_img[None]
    if cond_img.ndim != 4 or cond_img.shape[-1] != 3:
        raise ValueError(
            f"cond_img must be [H, W, 3] or [1, H, W, 3], got "
            f"{cond_img.shape}")
    R = np.concatenate([np.asarray(cond_R, np.float32)[None],
                        np.asarray(path_R, np.float32)], axis=0)
    T = np.concatenate([np.asarray(cond_T, np.float32)[None],
                        np.asarray(path_T, np.float32)], axis=0)
    return {"imgs": cond_img[:1], "R": R, "T": T,
            "K": np.asarray(K, np.float32)}
