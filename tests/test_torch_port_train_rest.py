"""The rest of the port's training on the CPU, against the JAX package: the
``permute`` val loader, in-training evaluation, the preemption handler,
the step retry and ``train_cli``'s val sets (``diff3d_tpu_torch/{data/
loader.py, train/trainer.py, train/step.py, testing/faults.py,
cli/train_cli.py}``).

Tolerances: the permute stream (indices and batches) equal to the JAX
package's; the val loss on Flax parameters carried into the port, with
the JAX eval draws replayed, within 1e-4 relative in float32 of
``diff3d_tpu.train.Trainer._eval_step``; every train-state comparison
(with and without evaluation, across a preemption and resume, with a
retried step) bit-exact.  The model is ``test_config(imgsize=8, ch=8,
shallow=True)`` on one torch thread; most of the file's time is the JAX
trainer's import and one compile of its eval step.
"""

import dataclasses
import json
import os
import signal
import time
import types

import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.data import InfiniteLoader as JLoader  # noqa: E402
from diff3d_tpu.data import SyntheticDataset as JSynthetic  # noqa: E402
from diff3d_tpu_torch.cli import train_cli  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.convert import convert_params  # noqa: E402
from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset  # noqa: E402
from diff3d_tpu_torch.testing import (FaultInjected, FaultInjector,  # noqa: E402
                                      wrap_iter)
from diff3d_tpu_torch.train import Trainer, ema_decay_per_step  # noqa: E402
from diff3d_tpu_torch.train import trainer as trainer_mod  # noqa: E402

H = 8


from _torch_port_threads import one_thread  # noqa: E402,F401


def _cfg(jax_side=False, **train_kw):
    make = jax_tiny_config if jax_side else port_tiny_config
    c = make(imgsize=H, ch=8, shallow=True)
    return dataclasses.replace(c, train=dataclasses.replace(c.train,
                                                            **train_kw))


def _ds(seed=0):
    return SyntheticDataset(num_objects=4, num_views=6, imgsize=H, seed=seed)


def _loader(start=0, seed=0):
    """The train batches from ``start`` on, as CPU tensors."""
    inner = InfiniteLoader(_ds(), 8, seed=seed, num_workers=0,
                           start_step=start)
    return ({k: torch.from_numpy(v) for k, v in b.items()} for b in inner)


def _trainer(tmp, cfg, transfer=False):
    t = Trainer(cfg, workdir=str(tmp), transfer=transfer, device="cpu")
    t.loader = _loader(t.state.step)
    return t


def _snapshot(state):
    out = {f"p.{k}": v.clone() for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in state.ema.items()})
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam.{i}.{k}": (v.clone() if torch.is_tensor(v)
                                      else torch.tensor(v))
                    for k, v in st.items()})
    out["step"] = torch.tensor(state.step)
    out["sched"] = torch.tensor(state.scheduler.last_epoch)
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ[:5]


def _records(tmp):
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


# --- the permute val loader ------------------------------------------------


class _Recorder:
    def __init__(self, ds):
        self.ds, self.idxs = ds, []

    def __len__(self):
        return len(self.ds)

    def sample(self, idx, rng):
        self.idxs.append(idx)
        return self.ds.sample(idx, rng)


def test_permute_stream_equals_the_jax_loaders():
    """3 epochs of a 10-object set in batches of 4 (epochs straddle
    batches): the same indices and batches as
    ``diff3d_tpu.data.InfiniteLoader(sample_mode="permute")``, every object
    once per epoch, and a ``start_step`` seek lands on the same batch."""
    kw = dict(num_objects=10, num_views=3, imgsize=H, seed=2)
    jrec, prec = _Recorder(JSynthetic(**kw)), _Recorder(SyntheticDataset(**kw))
    j = JLoader(jrec, 4, seed=5, num_workers=0, sample_mode="permute")
    p = InfiniteLoader(prec, 4, seed=5, num_workers=2, sample_mode="permute")
    batches = []
    for _ in range(8):                      # 32 draws: 3 epochs and more
        a, b = next(j), next(p)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        batches.append(b)
    assert prec.idxs == jrec.idxs
    for e in range(3):
        assert sorted(prec.idxs[10 * e:10 * (e + 1)]) == list(range(10))
    assert prec.idxs[:10] != prec.idxs[10:20]
    p.close()
    seeked = InfiniteLoader(SyntheticDataset(**kw), 4, seed=5,
                            num_workers=0, start_step=6,
                            sample_mode="permute")
    for k, v in next(seeked).items():
        np.testing.assert_array_equal(v, batches[6][k])
    with pytest.raises(ValueError, match="sample_mode"):
        InfiniteLoader(SyntheticDataset(**kw), 4, sample_mode="sorted")


def test_permute_keeps_four_epochs_of_permutations():
    p = InfiniteLoader(SyntheticDataset(num_objects=3, num_views=3,
                                        imgsize=H), 3, num_workers=0,
                       sample_mode="permute")
    for s in range(7):
        p.batch(s)
    assert sorted(p._perm_cache) == [3, 4, 5, 6]


# --- the val loss against diff3d_tpu.train.Trainer._eval_step --------------


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


def test_eval_step_matches_jax(tmp_path):
    """Random EMA weights (not the parameters), carried into the port by
    ``convert/from_jax.py``; the reference's eval key
    ``fold_in(fold_in(rng, step), 0xE7A1)`` split in four and replayed;
    dropout on in the port's config, off in its evaluation; cond_prob 0.5
    so both CFG branches are taken."""
    from diff3d_tpu.models import XUNet as JXUNet
    from diff3d_tpu.parallel import make_mesh
    from diff3d_tpu.train import Trainer as JTrainer

    jcfg, pcfg = [dataclasses.replace(
        c, diffusion=dataclasses.replace(c.diffusion, cond_prob=0.5))
        for c in (_cfg(True), _cfg())]
    # Dropout in the port's training config: its eval must turn it off
    # (the JAX eval is deterministic by construction).
    pcfg = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, dropout=0.5))
    # The reference method on a bare instance: _eval_step reads cfg, env,
    # model, _eval_fn and the state's ema_params only (no parameter init,
    # no checkpoint manager to build).
    jt = object.__new__(JTrainer)
    jt.cfg, jt.env, jt.model = jcfg, make_mesh(jcfg.mesh), JXUNet(jcfg.model)
    jt._eval_fn, jt.rng = None, jax.random.PRNGKey(jcfg.train.seed)
    dummy = {"x": np.zeros((1, H, H, 3), np.float32),
             "z": np.zeros((1, H, H, 3), np.float32),
             "logsnr": np.zeros((1, 2), np.float32),
             "R": np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3)),
             "t": np.zeros((1, 2, 3), np.float32),
             "K": np.broadcast_to(np.eye(3, dtype=np.float32), (1, 3, 3))}
    shapes = flatten_dict(jax.eval_shape(lambda: jt.model.init(
        jax.random.PRNGKey(0), dummy, cond_mask=np.ones(1, bool)))["params"],
        sep="/")
    rng = np.random.default_rng(3)
    ema = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in shapes.items()}
    jstate = types.SimpleNamespace(ema_params=unflatten_dict(
        {k: jax.numpy.asarray(v) for k, v in ema.items()}, sep="/"))
    b = next(JLoader(JSynthetic(num_objects=3, num_views=4, imgsize=H,
                                seed=1), 8, seed=1, num_workers=0))
    batch = {k: b[k] for k in ("imgs", "R", "T", "K")}
    step = 7
    key = jax.random.fold_in(jax.random.fold_in(jt.rng, step), 0xE7A1)
    want = float(jt._eval_step(jstate, batch, key))

    pt = Trainer(pcfg, workdir=str(tmp_path / "port"), device="cpu")
    before = _snapshot(pt.state)
    with torch.no_grad():
        for name, v in convert_params(ema, pt.state.model).items():
            pt.state.ema[name].copy_(v)
    got = float(pt._eval_step(pt.state, batch, Replay(key, 8)))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    assert pt.state.model.training
    for name, p in pt.state.model.named_parameters():   # untouched
        assert torch.equal(p, before[f"p.{name}"])
    # The parameters are not the EMA: scoring them would differ.
    raw = float(pt._eval_step(
        types.SimpleNamespace(model=pt.state.model,
                              ema=dict(pt.state.model.named_parameters())),
        batch, Replay(key, 8)))
    assert abs(raw - want) > 1e-3 * abs(want)


def test_eval_draws_are_keyed_on_seed_step_and_the_eval_tag(tmp_path):
    t = Trainer(_cfg(), workdir=str(tmp_path), device="cpu")
    a = t.eval_draws(4).noise((2, 3), "cpu")
    b = t.eval_draws(4).noise((2, 3), "cpu")
    c = t.eval_draws(5).noise((2, 3), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    from diff3d_tpu_torch.train.step import step_seed

    train = torch.Generator().manual_seed(step_seed(0, 4))
    assert not torch.equal(a, torch.randn((2, 3), generator=train))


# --- eval in the loop: cadence, and no effect on training -------------------


def test_val_loss_cadence_and_eval_does_not_perturb_training(tmp_path):
    """``eval_every=2`` over 5 steps logs ``val_loss`` at 2, 4 and the last
    step (the JAX package's rule, ``diff3d_tpu/train/trainer.py:390``); the
    state after 5 steps is bit-identical to the run without evaluation."""
    cfg = _cfg(max_steps=5, ckpt_every=0, log_every=1)
    with_eval = _trainer(tmp_path / "eval",
                         dataclasses.replace(cfg, train=dataclasses.replace(
                             cfg.train, eval_every=2)))
    with_eval.val_loader = InfiniteLoader(_ds(seed=1), 8, seed=1,
                                          num_workers=0,
                                          sample_mode="permute")
    with_eval.train()
    plain = _trainer(tmp_path / "plain", cfg)
    plain.val_loader = with_eval.val_loader      # eval_every 0: unused
    plain.train()
    _assert_same(_snapshot(with_eval.state), _snapshot(plain.state))
    recs = _records(tmp_path / "eval")
    vals = [r for r in recs if "val_loss" in r]
    assert [r["step"] for r in vals] == [2, 4, 5]
    assert all(set(r) == {"step", "val_loss"} and np.isfinite(r["val_loss"])
               for r in vals)
    assert not any("val_loss" in r for r in _records(tmp_path / "plain"))
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4, 5]


def test_profile_steps_trace_the_window(tmp_path):
    """``train(profile_steps=(1, 3))`` writes one ``torch.profiler`` trace
    of steps 2-3 into ``<workdir>/profile``."""
    t = _trainer(tmp_path, _cfg(max_steps=4, ckpt_every=0, log_every=0))
    t.train(profile_steps=(1, 3))
    (trace,) = (tmp_path / "profile").iterdir()
    assert trace.name == "trace_1_3.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)
    assert t.state.step == 4


def test_changed_ema_halflife_takes_effect_on_resume(tmp_path):
    cfg = _cfg(max_steps=2, ckpt_every=2, log_every=0)
    _trainer(tmp_path, cfg).train()
    cfg2 = _cfg(max_steps=3, ckpt_every=0, log_every=0,
                ema_halflife_examples=64)
    t = _trainer(tmp_path, cfg2, transfer=True)
    assert t.state.step == 2
    ema = {k: v.clone() for k, v in t.state.ema.items()}
    t.train()
    d = ema_decay_per_step(cfg2.train)
    assert d != ema_decay_per_step(cfg.train)
    for name, p in t.state.model.named_parameters():
        want = ema[name].mul_(d).add_(p.detach(), alpha=1.0 - d)
        assert torch.equal(t.state.ema[name], want), name


# --- preemption -------------------------------------------------------------


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The uninterrupted 6-step run that the preempted ones are held to."""
    t = _trainer(tmp_path_factory.mktemp("straight"),
                 _cfg(max_steps=6, ckpt_every=100, log_every=1))
    t.train()
    return _snapshot(t.state)


@pytest.mark.parametrize("mode", ["full", "full_sliced"])
def test_sigterm_stops_at_the_exact_step_and_resumes_bit_exact(
        tmp_path, straight, mode):
    """A real SIGTERM through ``wrap_iter`` at the 4th batch: ``train()``
    returns at step 4 with that step durable on disk (the async writer
    waited for in ``full_sliced``), the handler uninstalls, and a resumed
    trainer reaches step 6 bit-identical to the uninterrupted run."""
    cfg = _cfg(max_steps=6, ckpt_every=100, log_every=1, ckpt_mode=mode)
    prev = signal.getsignal(signal.SIGTERM)
    t = _trainer(tmp_path, cfg)
    inj = FaultInjector(seed=0)
    inj.add("loader.next", kind="sigterm", at_calls=(4,))
    t.loader = wrap_iter(t.loader, inj, "loader.next")
    uninstall = t.install_preemption_handler()
    try:
        state = t.train()
    finally:
        uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    assert state.step == 4 and t.preempt_observed_step == 4
    assert t.ckpt.latest_step() == 4 and inj.fired["loader.next"] == 1
    again = _trainer(tmp_path, cfg, transfer=True)
    assert again.state.step == 4
    again.train()
    _assert_same(_snapshot(again.state), straight)


def test_preemption_does_not_rewrite_the_periodic_checkpoint(tmp_path):
    t = _trainer(tmp_path, _cfg(max_steps=6, ckpt_every=2, log_every=0))
    saves = []
    inner = t.ckpt.save

    def save(state, force=False):
        saves.append((state.step, force))
        return inner(state, force=force)

    t.ckpt.save = save
    t.loader = wrap_iter(t.loader, inj := FaultInjector(),
                         "loader.next")
    inj.add("loader.next", kind="sigterm", at_calls=(2,))
    uninstall = t.install_preemption_handler()
    try:
        t.train()
    finally:
        uninstall()
    assert t.preempt_observed_step == 2
    assert saves == [(2, False)] and t.ckpt.steps() == [2]


def test_nan_at_the_preemption_save_raises(tmp_path):
    """With no log or checkpoint cadence nothing else checks the step, so
    the preemption save checks it itself and saves nothing poisoned."""
    t = _trainer(tmp_path, _cfg(max_steps=6, ckpt_every=0, log_every=0))
    b = next(_loader())
    t.loader = iter([dict(b, T=torch.full_like(b["T"], float("nan")))])
    t._preempted.set()
    with pytest.raises(FloatingPointError, match="at preemption"):
        t.train()
    assert t.ckpt.steps() == []


def test_sigint_stops_gracefully(tmp_path):
    """A real SIGINT at the 2nd batch: no KeyboardInterrupt, the run stops
    at step 2 with that step saved."""
    t = _trainer(tmp_path, _cfg(max_steps=6, ckpt_every=100, log_every=0))
    inner, n = t.loader, [0]

    class Interrupting:
        def __next__(self):
            n[0] += 1
            if n[0] == 2:
                os.kill(os.getpid(), signal.SIGINT)
            return next(inner)

    t.loader = Interrupting()
    prev = signal.getsignal(signal.SIGINT)
    uninstall = t.install_preemption_handler()
    try:
        t.train()
    finally:
        uninstall()
    assert signal.getsignal(signal.SIGINT) is prev
    assert t.preempt_observed_step == 2 and t.ckpt.steps() == [2]


def test_uninstall_leaves_a_later_handler_alone(tmp_path):
    t = Trainer(_cfg(), workdir=str(tmp_path), device="cpu")
    prev_int = signal.getsignal(signal.SIGINT)
    prev_term = signal.getsignal(signal.SIGTERM)
    uninstall = t.install_preemption_handler()

    def foreign(signum, frame):            # never fired
        pass

    try:
        signal.signal(signal.SIGTERM, foreign)
        uninstall()
        assert signal.getsignal(signal.SIGTERM) is foreign
        assert signal.getsignal(signal.SIGINT) is prev_int
        uninstall()                         # a second call does nothing
        assert signal.getsignal(signal.SIGTERM) is foreign
    finally:
        signal.signal(signal.SIGTERM, prev_term)


def test_install_is_idempotent_and_the_handler_not_reentrant(tmp_path):
    """A second install returns the same uninstaller; a signal arriving
    while the handler runs only sets the flag; a delivery chains the
    previous handler once; a real SIGTERM sets the flag."""
    t = Trainer(_cfg(), workdir=str(tmp_path), device="cpu")
    prev_term = signal.getsignal(signal.SIGTERM)
    chained = []
    signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    try:
        uninstall = t.install_preemption_handler()
        assert t.install_preemption_handler() is uninstall
        handler = signal.getsignal(signal.SIGTERM)
        t._in_handler = True
        try:
            handler(signal.SIGTERM, None)
        finally:
            t._in_handler = False
        assert t._preempted.is_set() and chained == []
        t._preempted.clear()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not t._preempted.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert t._preempted.is_set() and chained == [signal.SIGTERM]
        assert t._in_handler is False
        uninstall()
        again = t.install_preemption_handler()
        assert again is not uninstall
        again()
    finally:
        signal.signal(signal.SIGTERM, prev_term)


# --- the step retry ---------------------------------------------------------


def _no_sleep_retry(t):
    t.step_fn.retry = dataclasses.replace(trainer_mod._STEP_RETRY,
                                          sleep=lambda s: None)


def test_transient_step_error_is_retried_bit_exact(tmp_path):
    """A transient error in the 2nd microbatch of step 2 (accum 2: the
    first microbatch's gradients already summed): the retried step, and
    the run, end bit-identical to the run without the fault."""
    cfg = _cfg(max_steps=3, ckpt_every=0, log_every=0, accum_steps=2)
    clean = _trainer(tmp_path / "clean", cfg)
    clean.train()
    t = _trainer(tmp_path / "fault", cfg)
    _no_sleep_retry(t)
    inj = FaultInjector()
    inj.add("model", at_calls=(4,))
    t.state.model.forward = inj.wrap("model", t.state.model.forward)
    t.train()
    assert inj.fired["model"] == 1 and t.state.step == 3
    _assert_same(_snapshot(t.state), _snapshot(clean.state))


def test_sticky_cuda_error_is_not_retried(tmp_path):
    t = _trainer(tmp_path, _cfg(max_steps=3, ckpt_every=0, log_every=0))
    _no_sleep_retry(t)
    inj = FaultInjector()
    inj.add("model", at_calls=(2,), exc=lambda: FaultInjected(
        "CUDA error: an illegal memory access was encountered"))
    t.state.model.forward = inj.wrap("model", t.state.model.forward)
    with pytest.raises(FaultInjected, match="illegal memory access"):
        t.train()
    assert inj.calls["model"] == 2            # tried once, not retried
    assert t.ckpt.steps() == [1]              # the emergency checkpoint


# --- train_cli: the val sets against the JAX package's CLI ------------------


def _srn_tree(root, n_objects=12, n_views=3, size=8, seed=3):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for o in range(n_objects):
        obj = root / f"obj{o:03d}"
        for sub in ("rgb", "pose", "intrinsics"):
            (obj / sub).mkdir(parents=True)
        for v in range(n_views):
            name = f"{v:06d}"
            Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                         dtype=np.uint8)).save(
                obj / "rgb" / f"{name}.png")
            pose = np.eye(4)
            pose[:3, :4] = rng.standard_normal((3, 4))
            np.savetxt(obj / "pose" / f"{name}.txt", pose.reshape(1, 16))
            np.savetxt(obj / "intrinsics" / f"{name}.txt",
                       np.array([[9.6, 0, 4], [0, 9.6, 4],
                                 [0, 0, 1]]).reshape(1, 9))
    return root


def _jax_cli_val_loader(monkeypatch, argv):
    """The val loader ``diff3d_tpu.cli.train_cli.main`` attaches, with its
    Trainer replaced by a stand-in that records instead of training."""
    import diff3d_tpu.data as jdata
    import diff3d_tpu.train as jtrain
    from diff3d_tpu.cli import train_cli as jcli

    got = []

    class Stub:
        def __init__(self, cfg, env=None, workdir=".", transfer=False):
            self.state = types.SimpleNamespace(step=0)
            self.val_loader = None

        def install_preemption_handler(self):
            return lambda: None

        def train(self):
            got.append(self)

    monkeypatch.setattr(jtrain, "Trainer", Stub)
    monkeypatch.setattr(jdata, "prefetch_to_device", lambda it, *a, **k: it)
    jcli.main(argv)
    return got[0].val_loader


@pytest.mark.parametrize("data", ["scenes", "synthetic", "val_data",
                                  "val_split", "no_eval"])
def test_train_cli_val_sets_match_the_jax_cli(tmp_path, monkeypatch, data):
    """``--eval_every`` / ``--val_data`` pick the JAX CLI's val set (the
    same object ids), seed (the train seed + 1), batch and ``permute``
    mode, so both score the same first val batch."""
    argv = ["--config", "test", "--imgsize", str(H), "--num_workers", "0",
            "--eval_every", "2", "--workdir", str(tmp_path / "w")]
    if data == "scenes":
        argv += ["--synthetic_scenes", "--scene_objects", "4"]
    elif data == "synthetic":
        argv += ["--synthetic"]
    else:
        argv += ["--train_data", str(_srn_tree(tmp_path / "train"))]
        if data == "val_data":
            argv += ["--val_data", str(_srn_tree(tmp_path / "val",
                                                 n_objects=3, seed=4))]
        if data == "no_eval":
            argv[argv.index("--eval_every") + 1] = "0"
    ref = _jax_cli_val_loader(monkeypatch, argv)
    port = train_cli.build_trainer(train_cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    port.loader.close()
    if data == "no_eval":
        assert ref is None and port.val_loader is None
        return
    val = port.val_loader
    assert val.dataset.ids == ref.dataset.ids
    assert (val.seed, val.batch_size, val.sample_mode) == (
        ref.seed, ref.batch_size, ref.sample_mode) == (1, 8, "permute")
    assert val._pool is None
    a, b = val.batch(0), ref._batch(0)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_train_cli_still_refuses_the_parallel_flags():
    """``--context_parallel`` with a sharded placement stays refused,
    naming ROADMAP A10b (the tensor- and context-parallel flags are
    lifted: ``--model_parallel``, ``--param_sharding tp`` and
    ``--context_parallel --model_parallel 2`` pass;
    ``test_torch_port_tp.py`` and ``test_torch_port_cp.py`` train under
    them); a flag value the parser does not take still exits."""
    p = train_cli.build_parser()
    for argv in (["--model_parallel", "2"], ["--param_sharding", "tp"],
                 ["--context_parallel", "--model_parallel", "2"]):
        train_cli.refuse_unported(p.parse_args(argv))
    for argv in (["--context_parallel", "--param_sharding", "tp"],
                 ["--context_parallel", "--model_parallel", "2",
                  "--param_sharding", "fsdp"]):
        with pytest.raises(SystemExit, match="A10b"):
            train_cli.refuse_unported(p.parse_args(argv))
    for argv in (["--elastic", "2"], ["--param_sharding", "2"],
                 ["--attn_impl", "einsum"]):
        with pytest.raises(SystemExit):
            p.parse_args(argv)
