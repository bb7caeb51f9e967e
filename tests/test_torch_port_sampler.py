"""The port's sampling side (``diffusion/core.py``, ``sampling/runtime.py``,
``cli/sample_cli.py``) against the JAX package's.

``jax.random`` and ``torch.Generator`` never agree, so the JAX key stream
of a view (``core.py:387-400, 445-478``: init noise, conditioning indices,
uncond frames, step noise) is computed here and replayed into the port's
injectable draws.

Tolerances: the schedule and the step rules 1e-6 (float32, the same
operations); the whole loops 1e-5 — the first step divides by
alpha ~ 4.5e-5 at logsnr -20, which turns a 1e-9 difference of eps into
~1e-5 of an unclipped x0 pixel; most pixels are clipped to +-1 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.diffusion import core as jcore  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.sampling import Sampler as JSampler  # noqa: E402
from diff3d_tpu_torch.cli import sample_cli  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.convert import load_flax_params  # noqa: E402
from diff3d_tpu_torch.diffusion import core as tcore  # noqa: E402
from diff3d_tpu_torch.models import build_model  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler, record_capacity  # noqa: E402


from _torch_port_threads import one_thread  # noqa: E402,F401


class ReplayDraws:
    """The port's draw interface, answered from arrays made elsewhere."""

    def __init__(self, init_noise, cond_idx, x_uncond, step_noise):
        self._init, self._idx = init_noise, cond_idx
        self._x = list(x_uncond)
        self._noise = list(step_noise)

    def init_noise(self, shape, device):
        assert tuple(shape) == self._init.shape
        return torch.tensor(self._init, device=device)

    def cond_idx(self, n_steps, record_len, device):
        assert n_steps == len(self._idx)
        return torch.tensor(self._idx, dtype=torch.long, device=device)

    def x_uncond(self, shape, device):
        return torch.tensor(self._x.pop(0), device=device)

    def step_noise(self, shape, device):
        return torch.tensor(self._noise.pop(0), device=device)


def jax_view_draws(rng, shape, n_steps, record_len):
    """``(rng', draws)``: the draws ``diffusion/core.py::sample_view``
    takes from the per-object carry ``rng`` for one view."""
    rng, k = jax.random.split(rng)
    r, k_init, k_idx = jax.random.split(k, 3)
    init = np.asarray(jax.random.normal(k_init, shape))
    idx = np.asarray(jax.random.randint(k_idx, (n_steps,), 0, record_len))
    xs, noise = [], []
    for _ in range(n_steps):
        r, k_x, k_noise = jax.random.split(r, 3)
        xs.append(np.asarray(jax.random.normal(k_x, shape)))
        noise.append(np.asarray(jax.random.normal(k_noise, shape)))
    return rng, ReplayDraws(init, idx, xs, noise)


@pytest.mark.parametrize("timesteps,steps", [(256, None), (256, 64),
                                             (4, 2)])
def test_schedule_matches_jax(timesteps, steps):
    jts = np.asarray(jcore.sample_schedule_ts(steps, timesteps=timesteps))
    tts = tcore.sample_schedule_ts(steps, timesteps=timesteps)
    np.testing.assert_array_equal(tts.numpy(), jts)
    ref = np.asarray(jcore.logsnr_schedule_cosine(jnp.asarray(jts)))
    out = tcore.logsnr_schedule_cosine(tts).numpy()
    assert out[0] == pytest.approx(-20.0, abs=1e-2)   # f32 near the pole
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    a, s = tcore.alpha_sigma(tts)
    ja, js = jcore.alpha_sigma(jnp.asarray(jts))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("steps,start_t", [(8, 1.0), (8, 0.5), (4, 0.25),
                                           (256, 0.75)])
def test_start_t_truncation_matches_jax(steps, start_t):
    jts = np.asarray(jcore.sample_schedule_ts(steps, timesteps=256,
                                              start_t=start_t))
    tts = tcore.sample_schedule_ts(steps, timesteps=256, start_t=start_t)
    np.testing.assert_array_equal(tts.numpy(), jts)
    assert tcore.schedule_start_index(steps, start_t, timesteps=256) == \
        jcore.schedule_start_index(steps, start_t, timesteps=256)


@pytest.mark.parametrize("kw", [dict(steps=3), dict(steps=0),
                                dict(steps=8, start_t=0.3),
                                dict(steps=8, start_t=0.0)])
def test_schedule_errors_match_jax(kw):
    for mod in (jcore, tcore):
        with pytest.raises(mod.ScheduleError):
            mod.sample_schedule_ts(kw["steps"], timesteps=256,
                                   start_t=kw.get("start_t"))
    assert issubclass(tcore.ScheduleError, ValueError)


@pytest.mark.parametrize("i", [0, 1, 128, 255])
def test_step_rules_match_jax(i):
    ts = np.asarray(jcore.sample_schedule_ts(None, timesteps=256))
    ls = np.asarray(jcore.logsnr_schedule_cosine(jnp.asarray(ts)))
    rng = np.random.default_rng(i)
    eps_c, eps_u, z = (rng.standard_normal((8, 4, 4, 3)).astype(np.float32)
                       for _ in range(3))
    w = np.arange(8, dtype=np.float32)
    jargs = [jnp.asarray(a) for a in (eps_c, eps_u, z)] + [
        jnp.asarray(ls[i]), jnp.asarray(ls[i + 1]), jnp.asarray(w)]
    targs = [torch.from_numpy(a) for a in (eps_c, eps_u, z)] + [
        torch.tensor(ls[i]), torch.tensor(ls[i + 1]), torch.from_numpy(w)]
    for clip in (True, False):
        jm, jv = jcore.p_mean_variance(*jargs, clip_x0=clip)
        tm, tv = tcore.p_mean_variance(*targs, clip_x0=clip)
        scale = 1.0 + float(np.abs(np.asarray(jm)).max())
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-7)
        jd = np.asarray(jcore.ddim_step(*jargs, clip_x0=clip))
        td = tcore.ddim_step(*targs, clip_x0=clip).numpy()
        np.testing.assert_allclose(td, jd, rtol=1e-6,
                                   atol=1e-6 * (1 + np.abs(jd).max()))


def _jax_denoiser(batch, mask):
    m = mask[:, None, None, None]
    ls = batch["logsnr"][:, 1][:, None, None, None]
    pose = (batch["R"][:, 1, 0, 0] + batch["t"][:, 0, 2])[:, None, None,
                                                           None]
    return (jnp.tanh(0.5 * batch["z"] + 0.3 * batch["x"] * m + 0.01 * ls
                     + 0.1 * pose) + 0.1 * batch["cam_dirs"][:, 0])


def _torch_denoiser(batch, mask):
    m = mask[:, None, None, None]
    ls = batch["logsnr"][:, 1][:, None, None, None]
    pose = (batch["R"][:, 1, 0, 0] + batch["t"][:, 0, 2])[:, None, None,
                                                           None]
    return (torch.tanh(0.5 * batch["z"] + 0.3 * batch["x"] * m + 0.01 * ls
                       + 0.1 * pose) + 0.1 * batch["cam_dirs"][:, 0])


def _record(capacity=4, valid=2, B=8, H=6, seed=0):
    rng = np.random.default_rng(seed)
    imgs = np.zeros((capacity, B, H, H, 3), np.float32)
    imgs[:valid] = rng.uniform(-1, 1, (valid, B, H, H, 3))
    q, _ = np.linalg.qr(rng.normal(size=(capacity, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    T = rng.normal(0, 1.3, (capacity, 3)).astype(np.float32)
    K = np.array([[7.0, 0, 3], [0, 7.0, 3], [0, 0, 1]], np.float32)
    return imgs, R, T, K


@pytest.mark.parametrize("kind", ["ancestral", "ddim"])
def test_sample_view_replays_jax_key_stream(kind):
    """The whole reverse loop with an analytic denoiser written in both
    frameworks; the JAX key stream is replayed into the port's draws."""
    imgs, R, T, K = _record()
    B, H, record_len, timesteps = 8, 6, 2, 16
    w = np.arange(B, dtype=np.float32)
    key = jax.random.PRNGKey(3)
    ref, ref_rec, ref_len, _ = jcore.sample_view(
        _jax_denoiser, record_imgs=jnp.asarray(imgs),
        record_R=jnp.asarray(R), record_T=jnp.asarray(T),
        record_len=jnp.int32(record_len), K=jnp.asarray(K),
        w=jnp.asarray(w), rng=key, timesteps=timesteps, sampler_kind=kind)
    _, draws = jax_view_draws(key, (B, H, H, 3), timesteps, record_len)
    rec = torch.from_numpy(imgs.copy())
    out, rec, n = tcore.sample_view(
        _torch_denoiser, record_imgs=rec, record_R=torch.from_numpy(R),
        record_T=torch.from_numpy(T), record_len=record_len,
        K=torch.from_numpy(K), w=torch.from_numpy(w), draws=draws,
        timesteps=timesteps, sampler_kind=kind)
    assert n == int(ref_len) == record_len + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref_rec), atol=1e-5,
                               rtol=1e-5)


def test_conditioning_draw_and_target_pose():
    """Trap: conditioning indices lie in [0, record_len) and the target
    pose is the record's entry ``record_len`` (``core.py:324-331, 400``)."""
    imgs, R, T, K = _record(capacity=8, valid=3)
    seen = []

    def den(batch, mask):
        seen.append((batch["R"][:, 0].clone(), batch["R"][:, 1].clone()))
        return torch.zeros_like(batch["z"])

    tcore.sample_view(den, record_imgs=torch.from_numpy(imgs),
                      record_R=torch.from_numpy(R),
                      record_T=torch.from_numpy(T), record_len=3,
                      K=torch.from_numpy(K), w=torch.zeros(8),
                      draws=tcore.Draws(torch.Generator().manual_seed(0)),
                      timesteps=32)
    assert len(seen) == 32
    for cond, target in seen:
        assert torch.equal(target, torch.from_numpy(R[3]).expand(16, 3, 3))
        assert any(torch.equal(cond[0], torch.from_numpy(R[j]))
                   for j in range(3))


def test_final_step_guard_returns_the_mean():
    """Trap: ``logsnr_next == 0`` returns the posterior mean with no noise
    (``core.py:482``)."""
    imgs, R, T, K = _record(capacity=2, valid=1)
    z = torch.from_numpy(imgs[0] * 0.5)
    huge = [np.full(imgs[0].shape, 1e6, np.float32)]
    draws = ReplayDraws(None, None, [np.zeros_like(imgs[0])], huge)
    xs = (torch.tensor([1.0]), torch.tensor([0.0]), torch.tensor([0]))
    kw = dict(record_imgs=torch.from_numpy(imgs),
              record_R=torch.from_numpy(R), record_T=torch.from_numpy(T),
              target_R=torch.from_numpy(R[1]),
              target_T=torch.from_numpy(T[1]), K=torch.from_numpy(K),
              w=torch.zeros(8), logsnr_max=20.0, clip_x0=True)
    out = tcore.sample_loop_scan(
        lambda b, m: torch.zeros_like(b["z"]), z, xs, draws=draws, **kw)
    mean, _ = tcore.p_mean_variance(torch.zeros_like(z), torch.zeros_like(z),
                                    z, xs[0][0], xs[1][0], torch.zeros(8))
    assert torch.equal(out, mean)


def _views(n, H, seed=7):
    rng = np.random.default_rng(seed)
    _, R, T, K = _record(capacity=n, valid=0, H=H, seed=seed)
    return {"imgs": rng.uniform(-1, 1, (n, H, H, 3)).astype(np.float32),
            "R": R, "T": T, "K": K}


def test_synthesize_matches_jax_sampler():
    """``Sampler.synthesize`` with the converted tiny X-UNet, three views
    (two generated, each on the 4-step grid), against the JAX
    ``Sampler.synthesize`` given the same key stream; 1e-5 (see the
    module docstring for the first step's 1/alpha)."""
    jcfg = jax_tiny_config(imgsize=8, ch=8)
    pcfg = port_tiny_config(imgsize=8, ch=8)
    views = _views(3, 8)
    jm = JXUNet(jcfg.model)
    B = len(jcfg.diffusion.guidance_weights)
    batch = {"x": np.zeros((2 * B, 8, 8, 3), np.float32),
             "z": np.zeros((2 * B, 8, 8, 3), np.float32),
             "logsnr": np.zeros((2 * B, 2), np.float32),
             "R": np.zeros((2 * B, 2, 3, 3), np.float32),
             "t": np.zeros((2 * B, 2, 3), np.float32),
             "K": np.tile(views["K"], (2 * B, 1, 1))}
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch, cond_mask=np.ones(2 * B, bool)))
    rng = np.random.default_rng(8)
    flat = {k: (0.08 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in flatten_dict(shapes["params"], sep="/").items()}
    key = jax.random.PRNGKey(11)
    ref = JSampler(jm, unflatten_dict(flat, sep="/"), jcfg).synthesize(
        views, key)

    model = build_model(pcfg.model, device="cpu")
    load_flax_params(model, flat)
    draws = []
    carry = key
    for view in (1, 2):
        carry, d = jax_view_draws(carry, (B, 8, 8, 3),
                                  jcfg.diffusion.timesteps, view)
        draws.append(d)
    out = Sampler(model, pcfg, device="cpu").synthesize(views, draws=draws)
    assert out.shape == ref.shape == (2, B, 8, 8, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_synthesize_with_a_generator_writes_the_reference_layout(tmp_path):
    cfg = port_tiny_config(imgsize=8, ch=8)
    sampler = Sampler(build_model(cfg.model, device="cpu"), cfg,
                      device="cpu")
    views = _views(4, 8)
    out = sampler.synthesize(views, torch.Generator().manual_seed(0),
                             out_dir=str(tmp_path), max_views=3)
    assert out.shape == (2, 8, 8, 8, 3) and np.isfinite(out).all()
    for step in (1, 2):
        assert (tmp_path / str(step) / "gt.png").exists()
        assert (tmp_path / str(step) / "7.png").exists()
    again = sampler.synthesize(views, torch.Generator().manual_seed(0),
                               max_views=3)
    np.testing.assert_array_equal(out, again)
    assert record_capacity(3) == 4 and record_capacity(5) == 8
    with pytest.raises(ValueError):
        record_capacity(1)
    with pytest.raises(ValueError, match="steps"):
        Sampler(sampler.model, cfg, device="cpu", steps=3)


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch,
                                                       tmp_path):
    """Without CUDA and without an explicit device, the entry points
    raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_tiny_config(imgsize=8, ch=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg.model)
    model = build_model(cfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Sampler(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_cli.main(["--model", str(tmp_path / "m.pt"), "--target",
                         str(tmp_path), "--config", "test"])


def _srn_object(root, n=3, size=20, seed=9):
    """A tiny SRN object dir: ``rgb/*.png``, ``pose/*.txt`` (flat 4x4),
    ``intrinsics/*.txt`` (flat 3x3)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    _, R, T, _ = _record(capacity=n, valid=0, seed=seed)
    for sub in ("rgb", "pose", "intrinsics"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        name = f"{i:06d}"
        Image.fromarray(rng.integers(0, 256, (size, size, 4),
                                     dtype=np.uint8)).save(
            root / "rgb" / f"{name}.png")
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = R[i], T[i]
        np.savetxt(root / "pose" / f"{name}.txt", pose.reshape(1, 16))
        np.savetxt(root / "intrinsics" / f"{name}.txt",
                   np.array([[21.0, 0, 10], [0, 21.0, 10], [0, 0, 1]])
                   .reshape(1, 9))
    return root


def test_load_object_views_matches_jax(tmp_path):
    """The port's own copy of the SRN readers against the JAX package's,
    exactly: ``load_object_views`` decodes through the native decoder
    where both packages have it (PIL otherwise, in both), and the PIL path
    (BOX decode, [-1, 1], alpha dropped) matches the JAX package's PIL
    path."""
    from diff3d_tpu.data import srn as jsrn
    from diff3d_tpu_torch.data import load_object_views
    from diff3d_tpu_torch.data import srn as psrn

    obj = _srn_object(tmp_path / "obj")
    ref = jsrn.load_object_views(str(obj), 8)
    out = load_object_views(str(obj), 8)
    assert out["imgs"].shape == (3, 8, 8, 3)
    for k in ("imgs", "R", "T", "K"):
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], ref[k])
    paths = sorted(str(f) for f in (obj / "rgb").iterdir())
    np.testing.assert_array_equal(
        psrn.decode_view_batch(paths, 8, use_native=False),
        jsrn.decode_view_batch(paths, 8, use_native=False))


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_sample_cli_on_the_cpu(tmp_path, fmt):
    """``sample_cli`` end to end with ``--device cpu``: a port state dict
    or a Flax ``.npz``, writing ``{out}/{step}/{gt,0..7}.png``."""
    obj = _srn_object(tmp_path / "obj", size=16)
    pcfg = port_tiny_config()
    if fmt == "pt":
        weights = tmp_path / "model.pt"
        torch.save(build_model(pcfg.model, device="cpu", seed=3)
                   .state_dict(), weights)
    else:
        jm = JXUNet(jax_tiny_config().model)
        B = 2
        batch = {"x": np.zeros((B, 16, 16, 3), np.float32),
                 "z": np.zeros((B, 16, 16, 3), np.float32),
                 "logsnr": np.zeros((B, 2), np.float32),
                 "R": np.zeros((B, 2, 3, 3), np.float32),
                 "t": np.zeros((B, 2, 3), np.float32),
                 "K": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))}
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), batch, cond_mask=np.ones(B, bool)))
        weights = tmp_path / "params.npz"
        np.savez(weights, **{
            k: np.full(s.shape, 0.01, np.float32)
            for k, s in flatten_dict(shapes["params"], sep="/").items()})
    out = tmp_path / "sampling"
    sample_cli.main(["--model", str(weights), "--target", str(obj),
                     "--out", str(out), "--config", "test",
                     "--device", "cpu", "--max_views", "2"])
    assert (out / "1" / "gt.png").exists()
    assert (out / "1" / "7.png").exists()
    assert not (out / "2").exists()
