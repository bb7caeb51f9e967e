"""The port's evaluation path against the JAX package: the ray-traced
scenes dataset, image metrics, FID, matched-seed parity, reprojection
consistency, camera paths, and ``cli/eval_cli.py`` end to end on the CPU.

Tolerances: the dataset and the camera paths exactly (the same numpy
code); everything computed in float32 -- PSNR, SSIM, features, the FID
statistics and distance, the parity records -- within 1e-5 (relative
where the values are large), the same arithmetic in another summation
order.  The port's random FID embedding is drawn from a torch generator,
so its default weights differ from the JAX package's; the tests hand
the JAX package's weights to the port's feature function.
"""

import json
import math
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu.data import synthetic as jsynth  # noqa: E402
from diff3d_tpu.evaluation import consistency as jcons  # noqa: E402
from diff3d_tpu.evaluation import features as jfeat  # noqa: E402
from diff3d_tpu.evaluation import fid as jfid  # noqa: E402
from diff3d_tpu.evaluation import metrics as jmetrics  # noqa: E402
from diff3d_tpu.evaluation import parity as jparity  # noqa: E402
from diff3d_tpu.trajectory import paths as jpaths  # noqa: E402
from diff3d_tpu_torch.cli import eval_cli, train_cli  # noqa: E402
from diff3d_tpu_torch.data import synthetic as psynth  # noqa: E402
from diff3d_tpu_torch.evaluation import consistency as pcons  # noqa: E402
from diff3d_tpu_torch.evaluation import features as pfeat  # noqa: E402
from diff3d_tpu_torch.evaluation import fid as pfid  # noqa: E402
from diff3d_tpu_torch.evaluation import metrics as pmetrics  # noqa: E402
from diff3d_tpu_torch.evaluation import parity as pparity  # noqa: E402
from diff3d_tpu_torch.trajectory import paths as ppaths  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


from _torch_port_threads import one_thread  # noqa: E402,F401


@pytest.mark.parametrize("seed,size", [(0, 16), (1, 16), (0, 24), (1, 24)])
def test_synthetic_scenes_match_the_jax_package(seed, size):
    port = psynth.SyntheticScenesDataset(num_objects=3, num_views=5,
                                         imgsize=size, seed=seed)
    ref = jsynth.SyntheticScenesDataset(num_objects=3, num_views=5,
                                        imgsize=size, seed=seed)
    assert port.ids == ref.ids and len(port) == len(ref)
    for obj in port.ids:
        a, b = port.all_views(obj), ref.all_views(obj)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        a = port.sample(obj, np.random.default_rng(obj))
        b = ref.sample(obj, np.random.default_rng(obj))
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(3, 16, 16, 3), (2, 2, 11, 20, 3),
                                   (1, 40, 33, 3)])
def test_psnr_and_ssim_match_the_jax_package(shape):
    a = _images(shape, 0)
    b = np.clip(a + 0.2 * _images(shape, 1), -1, 1)
    for fn in ("psnr", "ssim"):
        got = getattr(pmetrics, fn)(a, b).numpy()
        want = np.asarray(getattr(jmetrics, fn)(a, b))
        assert got.shape == want.shape == shape[:-3]
        np.testing.assert_allclose(got, want, **TOL)
    # identical images: the MSE floor keeps PSNR finite
    np.testing.assert_allclose(pmetrics.psnr(a, a).numpy(),
                               np.asarray(jmetrics.psnr(a, a)), **TOL)


def _jax_randfeat_weights(C, dim=256, seed=0):
    """The JAX package's random-embedding weights, drawn as
    ``fid.default_feature_fn`` draws them."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    w = jax.random.normal(k1, (4, 4, C, dim)) / np.sqrt(4 * 4 * C)
    p = jax.random.normal(k2, (2 * dim, dim)) / np.sqrt(2 * dim)
    return np.asarray(w), np.asarray(p)


def test_fid_matches_the_jax_package_given_its_weights():
    """``default_feature_fn`` with the JAX package's weights,
    ``gaussian_stats`` over two batches and ``fid_from_stats``."""
    real = [_images((5, 16, 16, 3), s) for s in (2, 3)]
    gen = [np.clip(r + 0.3 * _images(r.shape, 9), -1, 1) for r in real]
    weights = _jax_randfeat_weights(3)
    pf = pfid.default_feature_fn(weights=weights)
    jf = jfid.default_feature_fn()
    np.testing.assert_allclose(pf(real[0]).numpy(),
                               np.asarray(jf(real[0])), **TOL)
    ps = [pfid.gaussian_stats(x, pf) for x in (real, gen)]
    js = [jfid.gaussian_stats(x, jf) for x in (real, gen)]
    for a, b in zip(ps, js):
        assert a.n == b.n == 10
        np.testing.assert_allclose(a.mu, b.mu, **TOL)
        np.testing.assert_allclose(a.cov, b.cov, **TOL)
    got, want = pfid.fid_from_stats(*ps), jfid.fid_from_stats(*js)
    assert math.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the distance itself, on the same statistics: the same numpy code
    assert pfid.frechet_distance(*js) == jfid.frechet_distance(*js)


def test_default_feature_fn_is_seeded():
    x = _images((4, 16, 16, 3), 4)
    a = pfid.default_feature_fn(seed=3)(x)
    assert torch.equal(a, pfid.default_feature_fn(seed=3)(x))
    assert not torch.equal(a, pfid.default_feature_fn(seed=4)(x))
    assert a.shape == (4, 256)


def _tiny_vgg(path):
    """A VGG-layout state dict: conv 0, conv 2 (pool after: gap 3), conv 5
    (the last: pool after), classifier 0 and 3; 8x8 input."""
    rng = np.random.default_rng(6)

    def n(*s):
        return (0.3 * rng.standard_normal(s)).astype(np.float32)

    sd = {"features.0.weight": n(4, 3, 3, 3), "features.0.bias": n(4),
          "features.2.weight": n(6, 4, 3, 3), "features.2.bias": n(6),
          "features.5.weight": n(8, 6, 3, 3), "features.5.bias": n(8),
          "classifier.0.weight": n(16, 8 * 2 * 2),
          "classifier.0.bias": n(16),
          "classifier.3.weight": n(12, 16), "classifier.3.bias": n(12)}
    if path.endswith(".npz"):
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("ext", [".npz", ".pt"])
def test_vgg_features_match_the_jax_package(tmp_path, ext):
    """The architecture inferred from the key names (pools from the index
    gaps, the input size from classifier.0's fan-in), at a size that is
    resized down (antialiased) and one resized up."""
    path = _tiny_vgg(str(tmp_path / f"vgg{ext}"))
    assert pfeat._vgg_spec(pfeat.load_state_dict(path)) == \
        jfeat._vgg_spec(jfeat.load_state_dict(path)) == \
        ([(0, False), (2, True), (5, True)], 8)
    pf, jf = pfeat.vgg16_feature_fn(path), jfeat.vgg16_feature_fn(path)
    for shape in ((3, 20, 20, 3), (2, 6, 6, 3)):
        x = _images(shape, 7)
        got, want = pf(x).numpy(), np.asarray(jf(x))
        assert got.shape == want.shape == (shape[0], 12)
        np.testing.assert_allclose(got, want, **TOL)
    fn, label = pfeat.resolve_feature_fn(path)
    assert label == "fid"
    assert pfeat.resolve_feature_fn(None)[1] == "fid_randfeat"
    with pytest.raises(FileNotFoundError):
        pfeat.resolve_feature_fn(str(tmp_path / "missing.pt"))


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)),    # up
                                     ((16, 16), (8, 8)),    # down
                                     ((10, 12), (16, 7))])  # non-integer
def test_resize_matches_jax_image_resize(src, dst):
    """``jax.image.resize(method="bilinear")``: half-pixel centres and an
    antialiased triangle filter when it downsamples."""
    g = _images((2, 3) + src + (3,), 8)
    np.testing.assert_allclose(pparity._resize_to(g, dst),
                               jparity._resize_to(g, dst), **TOL)


def test_matched_seed_and_cascade_parity_match_the_jax_package():
    oracle = [_images((2, 3, 16, 16, 3), s) for s in (10, 11)]
    gens = [np.clip(o + 0.1 * _images(o.shape, 12), -1, 1) for o in oracle]
    drafts = [_images((2, 3, 8, 8, 3), s) for s in (13, 14)]
    for w in (0, 2):
        got = pparity.matched_seed_parity(gens, oracle, w_index=w)
        want = jparity.matched_seed_parity(gens, oracle, w_index=w)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    # the oracle against itself: PSNR capped, not infinite
    assert pparity.matched_seed_parity(oracle, oracle)["psnr"] == \
        pparity.PSNR_CAP
    got = pparity.cascade_parity(drafts, gens, oracle, w_index=1)
    want = jparity.cascade_parity(drafts, gens, oracle, w_index=1)
    assert got.keys() == want.keys()
    for part in ("draft", "refined"):
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       atol=1e-3)
    with pytest.raises(ValueError, match="resolution"):
        pparity.matched_seed_parity(drafts, oracle)


def _all_paths(mod):
    return {
        "orbit": mod.orbit_path(5, radius=2.5, elevation_deg=25.0,
                                target=(0.1, 0.0, 0.2), azimuth0_deg=30.0,
                                full_turns=0.5),
        "spiral": mod.spiral_path(6, elevation_start_deg=-20.0,
                                  elevation_end_deg=70.0),
        "keyframes": mod.keyframe_path([[2, 0, 1], [0, 2, 1], [-2, 0, 0.5]],
                                       7, targets=[[0, 0, 0]] * 3),
        "spec_orbit": mod.path_from_spec({"kind": "orbit", "frames": 4,
                                          "radius": 3.0}),
        "spec_spiral": mod.path_from_spec({"kind": "spiral", "frames": 3}),
        "spec_keyframes": mod.path_from_spec(
            {"kind": "keyframes", "frames": 4,
             "keyframes": [[1, 1, 1], [2, -1, 0.5]]}),
        "one_frame": mod.orbit_path(1),
    }


def test_camera_paths_match_the_jax_package():
    assert ppaths.PATH_KINDS == jpaths.PATH_KINDS
    got, want = _all_paths(ppaths), _all_paths(jpaths)
    for name in want:
        for a, b in zip(got[name], want[name]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(ppaths.look_at([0, 0, 3]),
                                  jpaths.look_at([0, 0, 3]))
    R, T = want["orbit"]
    img = _images((8, 8, 3), 15)
    tv, jv = (m.trajectory_views(img, R[0], T[0], np.eye(3), R, T)
              for m in (ppaths, jpaths))
    for k in jv:
        np.testing.assert_array_equal(tv[k], jv[k])
    for bad in ({"kind": "zoom", "frames": 3}, {"kind": "orbit"},
                {"kind": "orbit", "frames": 3, "radus": 2}):
        with pytest.raises(ValueError):
            ppaths.path_from_spec(bad)


def test_reprojection_consistency_matches_the_jax_package():
    ds = psynth.SyntheticScenesDataset(num_objects=1, num_views=8,
                                       imgsize=16)
    v = ds.all_views(0)
    R, T = ppaths.orbit_path(4, radius=2.6, elevation_deg=15.0)
    frames = np.stack([v["imgs"][i] for i in range(4)])
    for kw in ({}, {"pairs": [(0, 2), (3, 1)]}):
        got = pcons.reprojection_consistency(frames, R, T, v["K"], **kw)
        want = jcons.reprojection_consistency(frames, R, T, v["K"], **kw)
        assert got == want
    H = pcons.plane_homography(v["K"], R[0], T[0], R[1], T[1])
    np.testing.assert_allclose(
        H, jcons.plane_homography(v["K"], R[0], T[0], R[1], T[1]), **TOL)


# The keys of the JAX package's eval_cli JSON line under --w_select,
# --parity_objects and --orbit with the random embedding
# (diff3d_tpu/cli/eval_cli.py:498-512, 530-534, 548-562, 619-628).
REFERENCE_KEYS = {
    "checkpoint_step", "objects", "views", "psnr",
    "psnr_copy_view0_baseline", "psnr_obj_mean", "psnr_obj_std",
    "psnr_margin_mean", "psnr_margin_std", "objects_above_baseline", "ssim",
    "fid_randfeat", "per_object", "psnr_per_w", "w_index", "timesteps",
    "sampler", "sampler_steps", "sampler_parity", "w_selected",
    "w_select_objects", "psnr_w_selected", "psnr_margin_mean_w_selected",
    "psnr_margin_std_w_selected", "objects_above_baseline_w_selected",
    "ssim_w_selected", "fid_randfeat_w_selected", "per_object_w_selected",
    "orbit_consistency"}


def _last_line(path):
    return json.loads(open(path).read().strip().splitlines()[-1])


def test_eval_cli_end_to_end_on_cpu(tmp_path):
    """A 2-step port checkpoint scored on synthetic scenes: the reference's
    keys; a second run re-synthesises nothing and prints the same line; a
    lost object is re-synthesised to the same line; a record made under
    other settings is refused (mirrors ``tests/test_cli.py:80-135``)."""
    wd = str(tmp_path / "train")
    train_cli.main(["--device", "cpu", "--synthetic", "--config", "test",
                    "--steps", "2", "--num_workers", "0", "--workdir", wd])
    out = str(tmp_path / "eval.jsonl")
    argv = ["--device", "cpu", "--model", os.path.join(wd, "checkpoints"),
            "--synthetic_scenes", "--config", "test", "--objects", "2",
            "--w_select", "1", "--steps", "4", "--sampler", "ddim",
            "--sampler_steps", "2", "--parity_objects", "1", "--orbit", "3",
            "--max_views", "3", "--out", out]
    eval_cli.main(argv)
    rec1 = _last_line(out)
    assert set(rec1) == REFERENCE_KEYS
    assert rec1["checkpoint_step"] == 2 and rec1["objects"] == 2
    assert rec1["w_select_objects"] == ["2"]
    assert 0 <= rec1["w_selected"] < len(rec1["psnr_per_w"]) == 8
    assert rec1["sampler_parity"]["oracle"] == "ancestral:4"
    assert rec1["sampler_parity"]["sampler"] == "ddim:2"
    assert rec1["orbit_consistency"]["frames"] == 3
    for k in ("psnr", "ssim", "fid_randfeat"):
        assert math.isfinite(rec1[k])
    objdir = out + ".objdir"
    npzs = sorted(f for f in os.listdir(objdir) if f.endswith(".npz"))
    assert npzs == ["obj_s2_0.npz", "obj_s2_1.npz", "obj_s2_2.npz"]
    stamps = {f: os.path.getmtime(os.path.join(objdir, f)) for f in npzs}

    eval_cli.main(argv)                     # nothing to synthesise
    assert _last_line(out) == rec1
    assert {f: os.path.getmtime(os.path.join(objdir, f))
            for f in npzs} == stamps
    progress = open(os.path.join(objdir, "progress.jsonl")).read()
    assert len(progress.splitlines()) == 3

    os.remove(os.path.join(objdir, "obj_s2_1.npz"))   # a lost object
    eval_cli.main(argv)
    assert _last_line(out) == rec1
    assert os.path.getmtime(os.path.join(objdir, "obj_s2_0.npz")) == \
        stamps["obj_s2_0.npz"]

    other = list(argv)
    other[other.index("--steps") + 1] = "8"
    with pytest.raises(SystemExit, match="different settings"):
        eval_cli.main(other)


def test_eval_records_share_the_jax_layout_and_refuse_its_streams(tmp_path):
    """A record written by the JAX package's ``_save_object_record`` is
    read through the same npz layout, and refused by the port's
    ``"rng": "torch"`` stamp: generations from ``jax.random`` streams are
    another protocol."""
    from diff3d_tpu.cli import eval_cli as jeval

    meta = {"model": "/m", "dataset": "scenes:1", "checkpoint_step": 5,
            "timesteps": 4, "sampler": "ancestral", "sampler_steps": 4,
            "seed": 0, "max_views": 3, "H": 16,
            "guidance_weights": [float(w) for w in range(8)]}
    gen = _images((2, 8, 16, 16, 3), 16)
    jeval._save_object_record(str(tmp_path), 0, gen, meta)
    assert os.listdir(tmp_path) == ["obj_s5_0.npz"]
    got, ok = eval_cli._load_object_record(str(tmp_path), 0, meta)
    assert ok and got.dtype == np.float16
    np.testing.assert_array_equal(got, gen.astype(np.float16))
    with pytest.raises(SystemExit, match="different settings"):
        eval_cli._load_object_record(str(tmp_path), 0,
                                     dict(meta, rng="torch"))
    # and the port's own record is the same layout, read by the JAX reader
    eval_cli._save_object_record(str(tmp_path), 1, gen, meta)
    got, ok = jeval._load_object_record(str(tmp_path), 1, meta)
    assert ok
    np.testing.assert_array_equal(got, gen.astype(np.float16))


def test_eval_cli_rejects_bad_flags(tmp_path):
    with pytest.raises(SystemExit):
        eval_cli.main(["--device", "cpu", "--model", str(tmp_path)])
    with pytest.raises(SystemExit):
        eval_cli.main(["--device", "cpu", "--model", str(tmp_path),
                       "--synthetic_scenes", "--orbit", "1"])
    with pytest.raises(SystemExit):      # --mesh is taken, object_batch 0 not
        eval_cli.main(["--device", "cpu", "--model", str(tmp_path),
                       "--synthetic_scenes", "--mesh",
                       "--object_batch", "0"])
