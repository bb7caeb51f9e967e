"""The port's native PNG decoder (``diff3d_tpu_torch/native``) and the SRN
reader on it (``diff3d_tpu_torch/data/srn.py``), against the JAX
package's native decoder (``diff3d_tpu.native``) on the CPU.

Every comparison is bit-identical (``assert_array_equal``): RGB, RGBA
(binary and fractional alpha), grayscale, 16-bit, palette, integer and
fractional resize factors, no resize, the worker pool, the error codes,
and ``SRNDataset`` / ``load_object_views`` on the native path.  Where
``g++`` or libpng's headers are missing, the decoder tests skip; the PIL
fallback is checked either way.
"""

import os

import numpy as np
import pytest
from PIL import Image

from diff3d_tpu import native as jnative
from diff3d_tpu.data import srn as jsrn
from diff3d_tpu_torch import native
from diff3d_tpu_torch.data import srn as psrn

needs_native = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason="native decoder unavailable (g++ or png.h missing)")


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(0)
    out = {}
    for name, mode, shape in (("rgb", "RGB", (128, 128, 3)),
                              ("rgba", "RGBA", (128, 128, 4)),
                              ("rgba_soft", "RGBA", (96, 96, 4)),
                              ("gray", "L", (128, 128)),
                              ("small", "RGB", (17, 23, 3))):
        arr = rng.randint(0, 256, shape, np.uint8)
        if name == "rgba":
            arr[..., 3] = np.where(rng.rand(*shape[:2]) > 0.3, 255, 0)
        p = str(tmp / f"{name}.png")
        Image.fromarray(arr, mode).save(p)
        out[name] = p
    wide = rng.randint(0, 65536, (64, 64), np.uint16)
    out["gray16"] = str(tmp / "gray16.png")
    Image.fromarray(wide).save(out["gray16"])
    pal = Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)
                          ).convert("P", palette=Image.ADAPTIVE)
    out["palette"] = str(tmp / "palette.png")
    pal.save(out["palette"])
    out["bad"] = str(tmp / "bad.png")
    with open(out["bad"], "wb") as f:
        f.write(b"not a png at all")
    return out


@needs_native
@pytest.mark.parametrize("name", ["rgb", "rgba", "rgba_soft", "gray",
                                  "gray16", "palette", "small"])
@pytest.mark.parametrize("size", [64, 48, 8])
def test_decode_is_bit_identical_to_the_jax_packages(pngs, name, size):
    """Integer (128 -> 64, 8), fractional (128 -> 48, 96 -> 64, 17x23 ->
    any) and no-op (64 -> 64) resizes of every colour type."""
    got = native.decode_image(pngs[name], size)
    want = jnative.decode_image(pngs[name], size)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -1.0 and got.max() <= 1.0


@needs_native
def test_pool_is_bit_identical_to_the_jax_packages(pngs):
    paths = [pngs[k] for k in ("rgb", "rgba", "gray", "small")] * 3
    pool, jpool = native.DecoderPool(4), jnative.DecoderPool(4)
    try:
        got = pool.decode_batch(paths, 32)
        np.testing.assert_array_equal(got, jpool.decode_batch(paths, 32))
        assert got.shape == (12, 32, 32, 3)
        np.testing.assert_array_equal(got[0], native.decode_image(
            paths[0], 32))
        assert native.shared_pool() is native.shared_pool()
        with pytest.raises(IOError, match="batch decode failed"):
            pool.decode_batch([pngs["rgb"], pngs["bad"]], 32)
    finally:
        pool.close()
        jpool.close()


@needs_native
def test_error_codes_match_the_jax_packages(pngs):
    for path, what in (("/nonexistent/file.png", "cannot open file"),
                       (pngs["bad"], "not a PNG")):
        with pytest.raises(IOError) as got:
            native.decode_image(path, 64)
        with pytest.raises(IOError) as want:
            jnative.decode_image(path, 64)
        assert str(got.value) == str(want.value)
        assert str(got.value).startswith(what)
    with pytest.raises(IOError, match="bad arguments"):
        native.decode_image(pngs["rgb"], 0)


def test_the_library_builds_under_build_native_from_the_ports_source():
    lib = native._lib_path()
    assert lib.parent == native.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "native")
    assert not list(native._SRC.parent.glob("*.so"))
    ref = open(os.path.join(os.path.dirname(jnative.__file__),
                            "decoder.cpp")).read()
    own = native._SRC.read_text()
    body = own[own.index("#include <png.h>"):]
    assert body == ref[ref.index("#include <png.h>"):]


def test_a_failed_build_reports_its_error_line(tmp_path, monkeypatch):
    bad = tmp_path / "decoder.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    lib = native._lib_path()
    err = native._build(lib)
    assert "no_such_header_here.h" in err and "error" in err
    assert not lib.exists()
    assert not list((tmp_path / "out").glob("*.tmp"))


# --- the SRN reader on the native path, and the PIL fallback -------------


def _srn_tree(root, n_objects=4, n_views=3, size=16, seed=5):
    rng = np.random.default_rng(seed)
    for o in range(n_objects):
        obj = root / f"obj{o:03d}"
        for sub in ("rgb", "pose", "intrinsics"):
            (obj / sub).mkdir(parents=True)
        for v in range(n_views):
            name = f"{v:06d}"
            arr = rng.integers(0, 256, (size, size, 4), dtype=np.uint8)
            arr[..., 3] = np.where(arr[..., 3] > 80, 255, 0)
            Image.fromarray(arr, "RGBA").save(obj / "rgb" / f"{name}.png")
            pose = np.eye(4)
            pose[:3, :4] = rng.standard_normal((3, 4))
            np.savetxt(obj / "pose" / f"{name}.txt", pose.reshape(1, 16))
            np.savetxt(obj / "intrinsics" / f"{name}.txt",
                       np.array([[19.2, 0, 8], [0, 19.2, 8],
                                 [0, 0, 1]]).reshape(1, 9))
    return root


@pytest.mark.parametrize("use_native", [True, False])
def test_srn_dataset_matches_the_jax_packages(tmp_path, use_native):
    """``sample`` and ``all_views`` (which ``eval_cli`` scores SRN data
    with) on each decode path, bit for bit."""
    root = _srn_tree(tmp_path / "srn")
    kw = dict(imgsize=8, train_fraction=1.0, use_native=use_native)
    port = psrn.SRNDataset("train", str(root), **kw)
    ref = jsrn.SRNDataset("train", str(root), **kw)
    assert port.ids == ref.ids
    for idx in range(len(ref)):
        a = port.sample(idx, np.random.default_rng(idx))
        b = ref.sample(idx, np.random.default_rng(idx))
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = port.all_views(ref.ids[1]), ref.all_views(ref.ids[1])
    assert a["imgs"].shape == (3, 8, 8, 3)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    obj = str(root / ref.ids[2])
    a, b = psrn.load_object_views(obj, 8), jsrn.load_object_views(obj, 8)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_pil_fallback_when_the_decoder_is_unavailable(tmp_path, pngs,
                                                      monkeypatch):
    """Without the native runtime every reader takes the PIL path, as the
    JAX package's does."""
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    got = psrn.load_view_image(pngs["rgb"], 64)
    want = jsrn.load_view_image(pngs["rgb"], 64, use_native=False)
    np.testing.assert_array_equal(got, want)
    batch = psrn.decode_view_batch([pngs["rgba"], pngs["gray"]], 32)
    want = jsrn.decode_view_batch([pngs["rgba"], pngs["gray"]], 32,
                                  use_native=False)
    np.testing.assert_array_equal(batch, want)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode_image(pngs["rgb"], 8)
