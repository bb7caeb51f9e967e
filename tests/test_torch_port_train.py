"""The port's training slice (``diff3d_tpu_torch/{diffusion,models,data,
train,cli}``) on the CPU, against the JAX package.

Every input comes from a numpy seed; ``jax.random`` draws are replayed into
the port through injectable draws (:class:`TrainDraws`-like objects).  The
JAX side runs its plain XLA path in float32 (``test_config``), the port
its plain versions, whose backward passes are the explicit formulas of the
Pallas kernels (the autograd Functions on CPU tensors).

Tolerances, float32, each relative to 1 + the largest magnitude compared
unless said otherwise: the loss with a fixed denoiser 1e-6; one whole
train step 1e-4 for the loss, grad_norm and lr, and per leaf relative to
that leaf's largest magnitude for the updated parameters, Adam's moments
and the EMA (the same arithmetic summed in another order through the
model and its backward); schedules 1e-7; Flax dropout 1e-5 (one
ResnetBlock); checkpoints and resume bit-exact.
"""

import dataclasses
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.data import InfiniteLoader as JLoader  # noqa: E402
from diff3d_tpu.data import SyntheticDataset as JSynthetic  # noqa: E402
from diff3d_tpu.diffusion import p_losses as j_p_losses  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.models import layers as jlayers  # noqa: E402
from diff3d_tpu.train import state as jstate  # noqa: E402
from diff3d_tpu.train.step import make_train_step as j_make_train_step  # noqa: E402
from diff3d_tpu_torch.cli import train_cli  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.convert import (convert_params,  # noqa: E402
                                      load_flax_params,
                                      load_flax_train_state)
from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset  # noqa: E402
from diff3d_tpu_torch.data import prefetch_to_device  # noqa: E402
from diff3d_tpu_torch.diffusion import LOSS_TYPES, p_losses  # noqa: E402
from diff3d_tpu_torch.models import XUNet  # noqa: E402
from diff3d_tpu_torch.models import init_params as init_model  # noqa: E402
from diff3d_tpu_torch.models import layers as tlayers  # noqa: E402
from diff3d_tpu_torch.train import (CheckpointManager, Trainer,  # noqa: E402
                                    create_train_state, ema_decay_per_step,
                                    make_train_step, warmup_schedule)

H = 8


from _torch_port_threads import one_thread  # noqa: E402,F401


def _cfgs(**train_kw):
    """(JAX, port) ``test_config(imgsize=8, shallow=True)`` with the same
    train overrides."""
    j = jax_tiny_config(imgsize=H, ch=8, shallow=True)
    p = port_tiny_config(imgsize=H, ch=8, shallow=True)
    return (dataclasses.replace(j, train=dataclasses.replace(j.train,
                                                             **train_kw)),
            dataclasses.replace(p, train=dataclasses.replace(p.train,
                                                             **train_kw)))


def _batch(B=8, seed=0):
    ds = JSynthetic(num_objects=3, num_views=5, imgsize=H, seed=seed)
    return next(JLoader(ds, B, seed=seed, num_workers=0))


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _close(port, ref, tol, scale=None):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    mag = float(np.abs(ref).max()) if scale is None else scale
    err = float(np.abs(port - ref).max())
    assert err <= tol * mag, (err, mag)


class Replay:
    """The four draws of one JAX ``p_losses`` call, replayed."""

    generator = None

    def __init__(self, rng, n):
        k_t, k_noise, k_mask, k_x = jax.random.split(rng, 4)
        shape = (n, H, H, 3)
        self._t = np.array(jax.random.uniform(k_t, (n,)))
        self._noise = np.array(jax.random.normal(k_noise, shape))
        self._u = np.array(jax.random.uniform(k_mask, (n,)))
        self._x = np.array(jax.random.normal(k_x, shape))

    def t(self, n, device):
        return torch.from_numpy(self._t)

    def noise(self, shape, device):
        return torch.from_numpy(self._noise)

    def cond_u(self, n, device):
        return torch.from_numpy(self._u)

    def x_noise(self, shape, device):
        return torch.from_numpy(self._x)


def _step_replays(rng, step, B, accum):
    """The draws ``diff3d_tpu/train/step.py`` takes at ``step``: the key is
    folded with the step (and the microbatch index), then split off the
    dropout key, then split in four by ``p_losses``."""
    r = jax.random.fold_in(rng, step)
    keys = ([r] if accum == 1 else
            [jax.random.fold_in(r, i) for i in range(accum)])
    return [Replay(jax.random.split(k)[0], B // accum) for k in keys]


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_p_losses_matches_jax_with_replayed_draws(loss_type):
    """A fixed denoiser that reads every model input (x, z, logsnr,
    cond_mask, the poses), so the loss sees each draw: t, the noise, the
    CFG mask at cond_prob 0.5 and the replacement frames."""
    b = _batch(B=6, seed=1)
    imgs = b["imgs"].astype(np.float32) / 127.5 - 1.0
    rng = jax.random.PRNGKey(3)

    def denoise(np_like, batch, mask):
        m = mask[:, None, None, None]
        return (0.5 * batch["z"] + 0.3 * batch["x"] * m
                + 0.01 * batch["logsnr"][:, 1, None, None, None]
                + 0.1 * batch["R"][:, 1, 0, 0, None, None, None]
                + 0.1 * batch["t"][:, 0, 0, None, None, None]
                + 0.1 * batch["K"][:, 0, 0, None, None, None] / H)

    kw = dict(cond_prob=0.5, loss_type=loss_type)
    ref = j_p_losses(lambda bt, m: denoise(jnp, bt, m), jnp.asarray(imgs),
                     jnp.asarray(b["R"]), jnp.asarray(b["T"]),
                     jnp.asarray(b["K"]), rng, **kw)
    tb = _torch_batch(b)
    got = p_losses(lambda bt, m: denoise(torch, bt, m),
                   torch.from_numpy(imgs), tb["R"], tb["T"], tb["K"],
                   Replay(rng, 6), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, ref, 1e-6, scale=1 + abs(float(ref)))
    mask = Replay(rng, 6)._u > 0.5
    assert mask.any() and not mask.all()     # both CFG branches taken


def test_warmup_schedule_and_ema_decay_match_jax():
    for kw in (dict(global_batch=8, warmup_examples=1024),
               dict(global_batch=128, warmup_examples=100)):
        jcfg, pcfg = _cfgs(**kw)
        jsched = jstate.warmup_schedule(jcfg.train)
        psched = warmup_schedule(pcfg.train)
        for step in (0, 1, 5, 127, 128, 10_000, 1_000_000):
            _close(psched(step), float(jsched(step)), 1e-7,
                   scale=jcfg.train.lr)
        assert ema_decay_per_step(pcfg.train) == pytest.approx(
            jstate.ema_decay_per_step(jcfg.train), rel=1e-12)
    _, pcfg = _cfgs(ema_halflife_examples=0)
    assert ema_decay_per_step(pcfg.train) == 0.0


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_resnet_block_dropout_matches_flax(rate):
    """Rates 0 and 1 are deterministic in both frameworks; at rate 1 the
    block is conv2's bias plus the skip, which pins dropout after the
    FiLM'd GroupNorm and before conv2 (``diff3d_tpu/models/layers.py:186``)."""
    B, F, C, E = 2, 2, 16, 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, F, H, H, C)).astype(np.float32)
    emb = rng.standard_normal((B, F, H, H, E)).astype(np.float32)
    jm = jlayers.ResnetBlock(C, rate, kernels="xla")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, emb,
                                            True))["params"]
    flat = {k: (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in sorted(flatten_dict(shapes, sep="/").items())}
    ref = np.asarray(jm.apply({"params": unflatten_dict(flat, sep="/")}, x,
                              emb, False,
                              rngs={"dropout": jax.random.PRNGKey(1)}))
    pm = tlayers.ResnetBlock(C, C, E, dropout=rate).train()
    load_flax_params(pm, flat)
    with torch.no_grad():
        out = pm(torch.from_numpy(x.reshape(B * F, H, H, C)),
                 torch.from_numpy(emb.reshape(B * F, H, H, E)),
                 torch.Generator().manual_seed(0)).numpy()
    _close(out.reshape(ref.shape), ref, 1e-5, scale=1 + np.abs(ref).max())


def test_dropout_is_off_in_eval_and_needs_a_generator_in_train():
    h = torch.randn(4, 8, 8, 16)
    assert torch.equal(tlayers.dropout(h, 0.5, False, None), h)
    with pytest.raises(ValueError, match="Generator"):
        tlayers.dropout(h, 0.5, True, None)
    out = tlayers.dropout(h, 0.5, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert 0.3 < float(kept.float().mean()) < 0.7
    assert torch.allclose(out[kept], 2 * h[kept])


def test_loader_matches_jax_and_seeks():
    kw = dict(num_objects=4, num_views=6, imgsize=H, seed=2)
    j = JLoader(JSynthetic(**kw), 5, seed=7, num_workers=0, start_step=3)
    p = InfiniteLoader(SyntheticDataset(**kw), 5, seed=7, num_workers=2,
                       start_step=3)
    later = InfiniteLoader(SyntheticDataset(**kw), 5, seed=7,
                           num_workers=0, start_step=5)
    for step in (3, 4, 5):
        a, b = next(j), next(p)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    c = next(later)                         # seeked straight to step 5
    for k in c:
        np.testing.assert_array_equal(b[k], c[k])
    p.close()
    pre = prefetch_to_device(later, "cpu", depth=2)
    d = next(pre)                           # step 6, as torch tensors
    for k, v in JLoader(JSynthetic(**kw), 5, seed=7, num_workers=0,
                        start_step=6).__next__().items():
        assert torch.equal(d[k], torch.from_numpy(v))
    pre.close()


# --- one train step against diff3d_tpu.train.step.make_train_step -------


def _random_tree(shapes_flat, rng, scale):
    return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in shapes_flat.items()}


def _find(tree, cls):
    return [s for s in jax.tree.leaves(
        tree, is_leaf=lambda s: isinstance(s, cls)) if isinstance(s, cls)]


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2clip"])
def jax_step(request):
    """A mid-training JAX TrainState (random params, EMA and Adam moments;
    Adam count 7, schedule count 8, step 9), one JAX train step from it,
    and the batch: shared by the assertions of one accumulation setting.
    accum 2 also clips (grad_clip below the gradient norm)."""
    accum = request.param
    kw = dict(lr=0.1, accum_steps=accum,
              grad_clip=0.05 if accum == 2 else 0.0)
    jcfg, pcfg = _cfgs(**kw)
    b = _batch(B=8, seed=4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    model = JXUNet(jcfg.model)
    dummy = {"x": np.zeros((1, H, H, 3), np.float32),
             "z": np.zeros((1, H, H, 3), np.float32),
             "logsnr": np.zeros((1, 2), np.float32),
             "R": np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3)),
             "t": np.zeros((1, 2, 3), np.float32),
             "K": np.broadcast_to(np.eye(3, dtype=np.float32), (1, 3, 3))}
    shapes = flatten_dict(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), dummy, cond_mask=np.ones(1, bool)))["params"],
        sep="/")
    rng = np.random.default_rng(5)
    flat = _random_tree(shapes, rng, 0.08)
    ema = {k: v + (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in flat.items()}
    mu = _random_tree(shapes, rng, 0.01)
    nu = {k: (v * v + 1e-6).astype(np.float32)
          for k, v in _random_tree(shapes, rng, 0.01).items()}
    params = unflatten_dict(flat, sep="/")
    st = jstate.create_train_state(params, jcfg.train)
    tree = lambda d: unflatten_dict(  # noqa: E731
        {k: jnp.asarray(v) for k, v in d.items()}, sep="/")
    opt_state = jax.tree.map(
        lambda s: (s._replace(count=jnp.int32(7), mu=tree(mu), nu=tree(nu))
                   if isinstance(s, optax.ScaleByAdamState) else
                   s._replace(count=jnp.int32(8))
                   if isinstance(s, optax.ScaleByScheduleState) else s),
        st.opt_state, is_leaf=lambda s: isinstance(
            s, (optax.ScaleByAdamState, optax.ScaleByScheduleState)))
    st = st.replace(step=jnp.int32(9), opt_state=opt_state,
                    ema_params=tree(ema))
    key = jax.random.PRNGKey(11)
    new, metrics = j_make_train_step(model, jcfg, env=None,
                                     donate=False)(st, jb, key)
    carry = dict(params=flat, ema_params=ema, mu=mu, nu=nu, adam_count=7,
                 schedule_count=8, step=9)
    replays = _step_replays(key, 9, 8, accum)
    return pcfg, b, carry, replays, new, jax.device_get(metrics)


def _port_step(pcfg, b, carry, replays):
    model = XUNet(pcfg.model)
    state = create_train_state(model, pcfg.train)
    load_flax_train_state(state, **carry)
    metrics = make_train_step(pcfg)(state, _torch_batch(b), draws=replays)
    return state, metrics


def test_train_step_matches_jax(jax_step):
    pcfg, b, carry, replays, new, jm = jax_step
    state, m = _port_step(pcfg, b, carry, replays)
    assert state.step == int(new.step) == 10
    for name in ("loss", "grad_norm", "lr"):
        _close(float(m[name]), float(jm[name]), 1e-4,
               scale=1 + abs(float(jm[name])))
    adam = _find(new.opt_state, optax.ScaleByAdamState)[0]
    model = state.model
    want = {"param": convert_params(flatten_dict(jax.device_get(new.params),
                                                 sep="/"), model),
            "ema": convert_params(flatten_dict(
                jax.device_get(new.ema_params), sep="/"), model),
            "mu": convert_params(flatten_dict(jax.device_get(adam.mu),
                                              sep="/"), model),
            "nu": convert_params(flatten_dict(jax.device_get(adam.nu),
                                              sep="/"), model)}
    for name, p in model.named_parameters():
        opt = state.optimizer.state[p]
        got = {"param": p.detach(), "ema": state.ema[name],
               "mu": opt["exp_avg"], "nu": opt["exp_avg_sq"]}
        for kind in got:
            _close(got[kind].numpy(), want[kind][name].numpy(), 1e-4)
        assert float(opt["step"]) == int(adam.count) == 8
    # The update moved the parameters by far more than the tolerance.
    delta = max(float((p.detach() - convert_params(carry["params"], model)
                       [n]).abs().max()) for n, p in model.named_parameters())
    assert delta > 1e-3


# --- checkpoints, the Trainer and the CLI ---------------------------------


def _port_state(pcfg, seed=0):
    model = XUNet(pcfg.model)
    init_model(model, torch.Generator().manual_seed(seed),
               randomize_zero_init=True)
    return create_train_state(model.train(), pcfg.train)


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.items()},
            [{k: (v.clone() if torch.is_tensor(v) else v)
              for k, v in s.items()}
             for s in state.optimizer.state.values()],
            state.scheduler.last_epoch, state.step)


def _assert_same(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert len(a[2]) == len(b[2])
    for s, t in zip(a[2], b[2]):
        for k in s:
            assert torch.equal(s[k], t[k]), k
    assert a[3:] == b[3:]


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """2 steps, save, restore into a fresh state, 2 more steps == 4 steps
    straight; the draws come from the (seed, step) generators."""
    _, pcfg = _cfgs(lr=0.01, warmup_examples=16, accum_steps=2)
    loader = InfiniteLoader(SyntheticDataset(num_objects=4, num_views=6,
                                             imgsize=H), 8, num_workers=0)
    batches = [_torch_batch(loader.batch(s)) for s in range(4)]
    step = make_train_step(pcfg)

    straight = _port_state(pcfg)
    for s in range(4):
        step(straight, batches[s])

    first = _port_state(pcfg)
    for s in range(2):
        step(first, batches[s])
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    assert ckpt.save(first) and not ckpt.save(first)
    resumed = _port_state(pcfg, seed=1)           # other weights entirely
    assert ckpt.restore(resumed) == 2
    _assert_same(_snapshot(resumed), _snapshot(first))
    for s in range(2, 4):
        step(resumed, batches[s])
    _assert_same(_snapshot(resumed), _snapshot(straight))
    for s in (3, 4):
        resumed.step = s
        ckpt.save(resumed)
    assert ckpt.steps() == [3, 4] and ckpt.latest_step() == 4


def test_trainer_runs_and_resumes(tmp_path):
    _, pcfg = _cfgs(max_steps=3, ckpt_every=2, log_every=1)
    ds = SyntheticDataset(num_objects=4, num_views=6, imgsize=H)

    def trainer(transfer):
        t = Trainer(pcfg, workdir=str(tmp_path), transfer=transfer,
                    device="cpu")
        t.loader = prefetch_to_device(
            InfiniteLoader(ds, 8, num_workers=0, start_step=t.state.step),
            "cpu")
        return t

    t = trainer(False)
    t.train()
    t.loader.close()
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert set(r) == {"step", "loss", "lr", "grad_norm", "steps_per_sec",
                          "examples_per_sec", "wall_s"}
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
    assert t.ckpt.steps() == [2, 3]
    again = trainer(True)
    assert again.state.step == 3
    _assert_same(_snapshot(again.state), _snapshot(t.state))
    again.loader.close()


def test_trainer_halts_on_nonfinite_loss_and_saves_on_error(tmp_path):
    _, pcfg = _cfgs(max_steps=3, ckpt_every=0, log_every=1)
    ds = SyntheticDataset(num_objects=4, num_views=6, imgsize=H)
    b = _torch_batch(InfiniteLoader(ds, 8, num_workers=0).batch(0))
    t = Trainer(pcfg, workdir=str(tmp_path / "nan"), device="cpu")
    t.loader = iter([dict(b, T=torch.full_like(b["T"], float("nan")))])
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        t.train()
    assert t.ckpt.steps() == []                   # nothing poisoned saved
    t = Trainer(pcfg, workdir=str(tmp_path / "dry"), device="cpu")
    t.loader = iter([b])                          # runs dry after a step
    with pytest.raises(StopIteration):
        t.train()
    assert t.ckpt.steps() == [1]                  # emergency checkpoint


def _srn_tree(root, n_objects=12, n_views=4, size=12, seed=3):
    """A tiny SRN split dir: ``<obj>/{rgb,pose,intrinsics}/`` per object,
    RGBA pngs of random bytes, random poses, SRN-like K."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for o in range(n_objects):
        obj = root / f"obj{o:03d}"
        for sub in ("rgb", "pose", "intrinsics"):
            (obj / sub).mkdir(parents=True)
        for v in range(n_views):
            name = f"{v:06d}"
            Image.fromarray(rng.integers(0, 256, (size, size, 4),
                                         dtype=np.uint8)).save(
                obj / "rgb" / f"{name}.png")
            pose = np.eye(4)
            pose[:3, :4] = rng.standard_normal((3, 4))
            np.savetxt(obj / "pose" / f"{name}.txt", pose.reshape(1, 16))
            np.savetxt(obj / "intrinsics" / f"{name}.txt",
                       np.array([[1.2 * size, 0, size / 2],
                                 [0, 1.2 * size, size / 2],
                                 [0, 0, 1]]).reshape(1, 9))
    return root


def test_srn_dataset_matches_jax(tmp_path):
    """The index, the seeded split and ``SRNDataset.sample`` against the
    JAX package's, exactly, for the same numpy generator, on the native
    decode path (PIL in both where the decoder cannot build) and on the
    PIL path; the index pickle round-trips."""
    from diff3d_tpu.data import srn as jsrn
    from diff3d_tpu_torch.data import srn as psrn

    root = _srn_tree(tmp_path / "cars_train")
    pkl = str(tmp_path / "index.pkl")
    index = psrn.build_index(str(root), pkl, save=True)
    assert index == jsrn.build_index(str(root))
    assert psrn.build_index(str(tmp_path / "absent"), pkl) == index
    for split in ("train", "val"):
        assert psrn.split_ids(list(index), split, seed=1) \
            == jsrn.split_ids(list(index), split, seed=1)
    kw = dict(imgsize=8, split_seed=1)
    for use_native in (True, False):
        port = psrn.SRNDataset("train", str(root), use_native=use_native,
                               **kw)
        ref = jsrn.SRNDataset("train", str(root), use_native=use_native,
                              **kw)
        assert len(port) == len(ref) == 10
        for idx in (0, 7):
            a = port.sample(idx, np.random.default_rng(idx))
            b = ref.sample(idx, np.random.default_rng(idx))
            assert a["imgs"].shape == (2, 8, 8, 3)
            for k in b:
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("data", ["synthetic", "srn"])
def test_train_cli_on_cpu(tmp_path, data):
    args = (["--synthetic"] if data == "synthetic" else
            ["--train_data", str(_srn_tree(tmp_path / "srn", size=16))])
    train_cli.main(["--device", "cpu", "--config", "test", "--steps", "2",
                    "--num_workers", "2", "--workdir", str(tmp_path)] + args)
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert (tmp_path / "checkpoints" / "ckpt_2.pt").exists()
    trainer = train_cli.build_trainer(train_cli.build_parser().parse_args(
        ["--device", "cpu", "--config", "test", "--num_workers", "0",
         "--remat", "--remat_policy", "dots", "--workdir",
         str(tmp_path / "remat")] + args))
    trainer.loader.close()
    model_cfg = trainer.state.model.cfg
    assert model_cfg.remat and model_cfg.remat_policy == "dots"
    with pytest.raises(SystemExit, match="A10b"):   # not ported yet
        train_cli.main(["--device", "cpu", "--model_parallel", "2",
                        "--context_parallel", "--param_sharding", "fsdp"])
    # Lifted: without a process group of 2 ranks the mesh is refused.
    with pytest.raises(SystemExit, match="a mesh spans every rank"):
        train_cli.main(["--device", "cpu", "--config", "test",
                        "--model_parallel", "2", "--context_parallel",
                        "--workdir", str(tmp_path / "cp")])
