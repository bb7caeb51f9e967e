"""SRN Cars/Chairs data: object views for the sampler and the two-view
training dataset (counterpart: ``diff3d_tpu/data/srn.py:41-204``).

An own copy of the index (``build_index``: the reference pickle, or a
glob of ``<path>/<obj>/rgb/*.png``), the seeded 90/10 split, the pose /
intrinsics readers and the two image decoders: the native C++ one
(:mod:`diff3d_tpu_torch.native`, built on first use), taken when it is
available unless ``use_native=False``, and the PIL one (BOX resampling,
[-1, 1], first 3 channels) otherwise.  The two differ by up to a few
uint8 steps (PIL resizes in uint8 fixed point); ``native.available()``
tells which one ran.  PIL is imported where an image is decoded, not at
module import.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from diff3d_tpu_torch import native


def build_index(path: str, picklefile: Optional[str] = None,
                save: bool = False) -> Dict[str, List[str]]:
    """Load or regenerate the object-id -> view-filename index: the
    ``picklefile`` when it exists (the reference format, a dict of id ->
    png basenames), else a glob of ``<path>/<obj>/rgb/*.png``, optionally
    saved back to ``picklefile``."""
    if picklefile and os.path.exists(picklefile):
        with open(picklefile, "rb") as f:
            return pickle.load(f)
    index: Dict[str, List[str]] = {}
    for obj in sorted(os.listdir(path)):
        rgb = os.path.join(path, obj, "rgb")
        if not os.path.isdir(rgb):
            continue
        views = sorted(f for f in os.listdir(rgb) if f.endswith(".png"))
        if views:
            index[obj] = views
    if not index:
        raise FileNotFoundError(f"no SRN objects under {path}")
    if save and picklefile:
        os.makedirs(os.path.dirname(picklefile) or ".", exist_ok=True)
        with open(picklefile, "wb") as f:
            pickle.dump(index, f)
    return index


def split_ids(ids: Sequence[str], split: str, seed: int = 0,
              train_fraction: float = 0.9) -> List[str]:
    """The reference split: seed the stdlib RNG, shuffle the sorted ids,
    first ``train_fraction`` train, the rest val."""
    allthevid = sorted(ids)
    rng = random.Random(seed)
    rng.shuffle(allthevid)
    cut = int(len(allthevid) * train_fraction)
    return allthevid[:cut] if split == "train" else allthevid[cut:]


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


def _have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def load_view_image(path: str, imgsize: int,
                    use_native: bool = True) -> np.ndarray:
    """One view png -> ``[s, s, 3] float32`` in [-1, 1], through the native
    decoder when it is available (ctypes releases the GIL for the call, so
    loader threads decode in parallel), else through PIL."""
    if use_native and native.available():
        return native.decode_image(path, imgsize)
    if not _have_pil():
        raise RuntimeError("neither the native decoder nor PIL is available")
    from PIL import Image

    with Image.open(path) as img:
        return decode_image(img, imgsize)


def decode_view_batch(paths: Sequence[str], imgsize: int,
                      use_native: bool = True) -> np.ndarray:
    """``[N, s, s, 3]`` for N view pngs: one call into the shared native
    worker pool (GIL-free, in parallel) when it is available, else a PIL
    loop."""
    if use_native:
        pool = native.shared_pool()
        if pool is not None:
            return pool.decode_batch(list(paths), imgsize)
    return np.stack([load_view_image(p, imgsize, use_native=False)
                     for p in paths])


def load_object_views(object_dir: str, imgsize: int = 64
                      ) -> Dict[str, np.ndarray]:
    """Every view of one SRN object dir (``rgb/ pose/ intrinsics/``):
    ``imgs [V, s, s, 3]``, ``R [V, 3, 3]``, ``T [V, 3]`` and the first
    view's ``K [3, 3]``, all float32."""
    rgb = os.path.join(object_dir, "rgb")
    views = sorted(f for f in os.listdir(rgb) if f.endswith(".png"))
    if not views:
        raise FileNotFoundError(f"no views under {rgb}")
    imgs = decode_view_batch([os.path.join(rgb, v) for v in views], imgsize)
    Rs, Ts = [], []
    for v in views:
        R, T = load_pose(os.path.join(object_dir, "pose", v[:-4] + ".txt"))
        Rs.append(R.astype(np.float32))
        Ts.append(T.astype(np.float32))
    K = load_intrinsics(os.path.join(object_dir, "intrinsics",
                                     views[0][:-4] + ".txt"))
    return {"imgs": imgs, "R": np.stack(Rs), "T": np.stack(Ts),
            "K": K.astype(np.float32)}


class SRNDataset:
    """Map-style two-view dataset over SRN objects: ``sample(idx, rng)``
    returns ``imgs [V, s, s, 3]`` f32 in [-1, 1], ``R [V, 3, 3]``,
    ``T [V, 3]`` and the object's first view's ``K [3, 3]``, all f32, for
    ``V = num_views`` views drawn without replacement.  ``use_native``:
    decode through the native pool when it is available."""

    def __init__(self, split: str, path: str,
                 picklefile: Optional[str] = None, imgsize: int = 64,
                 split_seed: int = 0, train_fraction: float = 0.9,
                 num_views: int = 2, use_native: bool = True):
        if not _have_pil() and not (use_native and native.available()):
            raise RuntimeError("PIL required for SRNDataset image loading")
        self.path = path
        self.imgsize = imgsize
        self.num_views = num_views
        self.use_native = use_native
        self.index = build_index(path, picklefile)
        self.ids = split_ids(list(self.index.keys()), split, split_seed,
                             train_fraction)
        if not self.ids:
            raise ValueError(f"empty split {split!r}")

    def __len__(self) -> int:
        return len(self.ids)

    def _load_views(self, obj: str, names: Sequence[str]
                    ) -> Dict[str, np.ndarray]:
        imgs = decode_view_batch(
            [os.path.join(self.path, obj, "rgb", v) for v in names],
            self.imgsize, use_native=self.use_native)
        Rs, Ts = zip(*(load_pose(
            os.path.join(self.path, obj, "pose", v[:-4] + ".txt"))
            for v in names))
        K = load_intrinsics(os.path.join(
            self.path, obj, "intrinsics", self.index[obj][0][:-4] + ".txt"))
        return {"imgs": imgs.astype(np.float32),
                "R": np.stack(Rs).astype(np.float32),
                "T": np.stack(Ts).astype(np.float32),
                "K": K.astype(np.float32)}

    def all_views(self, obj: str) -> Dict[str, np.ndarray]:
        """Every view of one object (what ``eval_cli`` scores on)."""
        return self._load_views(obj, self.index[obj])

    def sample(self, idx: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
        obj = self.ids[idx]
        views = self.index[obj]
        chosen = rng.choice(len(views), size=self.num_views, replace=False)
        return self._load_views(obj, [views[i] for i in chosen])
