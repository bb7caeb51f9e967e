"""The port's progressive distillation (``diff3d_tpu_torch/train/
distill.py``) on the CPU, against the JAX package's
(``diff3d_tpu/train/distill.py``).

* ``distill_schedule`` on the cases of ``tests/test_ddim.py``.
* One distill step of the tiny shallow model in float32 against
  ``make_distill_step``, the JAX draws (``randint`` and ``normal`` from
  ``fold_in(rng, step)``) replayed through :class:`DistillDraws`: loss
  within 1e-5 relative, gradient norm and lr within 1e-5 relative, and
  the updated parameters, EMA and Adam's first moments within 1e-4
  relative L2 over all of them (the same arithmetic summed in other
  orders through the model and its backward), from a mid-training state.
* The two-round smoke of ``tests/test_ddim.py`` on the port: a
  ``full_sliced`` checkpoint per round, restored bit for bit; the weights
  changed; a 1-step DDIM sampler on them is finite.
* The structure the card's CUDA graph depends on, eagerly: ``distill``
  (one step object for every round, the state reset in place by
  ``start_round``) against rounds that each build a fresh model, state
  and step, bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.train import distill_schedule as j_distill_schedule  # noqa: E402
from diff3d_tpu.train import make_distill_step as j_make_distill_step  # noqa: E402
from diff3d_tpu.train import state as jstate  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.convert import (convert_params,  # noqa: E402
                                      load_flax_params,
                                      load_flax_train_state)
from diff3d_tpu_torch.data import SyntheticDataset  # noqa: E402
from diff3d_tpu_torch.models import XUNet, build_model  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.train import (CheckpointManager,  # noqa: E402
                                    create_train_state, distill,
                                    distill_schedule, make_distill_step,
                                    start_round)

H = 8


from _torch_port_threads import one_thread  # noqa: E402,F401


def _cfgs(**train_kw):
    j = jax_tiny_config(imgsize=H, ch=8, shallow=True)
    p = port_tiny_config(imgsize=H, ch=8, shallow=True)
    return (dataclasses.replace(j, train=dataclasses.replace(j.train,
                                                             **train_kw)),
            dataclasses.replace(p, train=dataclasses.replace(p.train,
                                                             **train_kw)))


def _np_batch(B, seed):
    r = np.random.RandomState(seed)
    K = np.array([[H * 1.2, 0, H / 2], [0, H * 1.2, H / 2], [0, 0, 1]],
                 np.float32)
    q, _ = np.linalg.qr(r.normal(size=(B, 2, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    return {"imgs": r.randint(0, 256, (B, 2, H, H, 3)).astype(np.uint8),
            "R": R, "T": r.randn(B, 2, 3).astype(np.float32),
            "K": np.broadcast_to(K, (B, 3, 3)).copy()}


def _torch_batches(B=2, seed=0):
    s = seed
    while True:
        yield {k: torch.from_numpy(v) for k, v in _np_batch(B, s).items()}
        s += 1


@pytest.mark.parametrize("args,want", [((256, 256, 16), [128, 64, 32, 16]),
                                       ((4, 4, 1), [2, 1]),
                                       ((4, 3, 1), "divide"),
                                       ((256, 256, 24), "divide"),
                                       ((16, 16, 3), "divide")])
def test_distill_schedule_matches_jax(args, want):
    if isinstance(want, list):
        assert distill_schedule(*args) == j_distill_schedule(*args) == want
        return
    with pytest.raises(ValueError, match=want) as port:
        distill_schedule(*args)
    with pytest.raises(ValueError) as ref:
        j_distill_schedule(*args)
    assert str(port.value) == str(ref.value)


class Replay:
    """JAX's draws of one distill step: ``i`` as ``u = (i - 0.5) / k``,
    and the noise."""

    generator = None

    def __init__(self, i, noise, k):
        self._u = ((i.astype(np.float32) - 0.5) / k).astype(np.float32)
        self._noise = noise

    def u(self, n, device):
        return torch.from_numpy(self._u)

    def noise(self, shape, device):
        return torch.from_numpy(self._noise)


def _rel_l2(got, want):
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    return (num / sum(float((w ** 2).sum()) for w in want)) ** 0.5


def test_one_distill_step_matches_jax():
    """From a mid-training state (Adam's count 7, the schedule's 8, step
    9): Adam's first update from zero moments takes each gradient's sign
    at full lr, and the gradients of an ``i = k`` sample (``x^`` scaled by
    1/alpha_t ~ 2e4) carry float32 cancellation errors of the size of the
    smallest of them, which a sign cannot absorb; accumulated moments
    can.  The gradient norm (~1e7) is far above the clip."""
    B, K, STEP = 8, 2, 9
    kw = dict(lr=0.1, warmup_examples=128, ema_halflife_examples=16,
              grad_clip=1.0)
    jcfg, pcfg = _cfgs(**kw)
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

    def rand(scale):
        return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in shapes.items()}

    teacher = rand(0.08)
    student = {k: v + d for (k, v), d in zip(teacher.items(),
                                             rand(0.01).values())}
    ema = {k: v + d for (k, v), d in zip(student.items(),
                                         rand(0.01).values())}
    mu = rand(0.01)
    nu = {k: (v * v + 1e-6).astype(np.float32) for k, v in rand(0.01).items()}
    tree = lambda d: unflatten_dict(  # noqa: E731
        {k: jnp.asarray(v) for k, v in d.items()}, sep="/")
    st = jstate.create_train_state(tree(student), jcfg.train)
    opt_state = jax.tree.map(
        lambda s: (s._replace(count=jnp.int32(7), mu=tree(mu), nu=tree(nu))
                   if isinstance(s, optax.ScaleByAdamState) else
                   s._replace(count=jnp.int32(8))
                   if isinstance(s, optax.ScaleByScheduleState) else s),
        st.opt_state, is_leaf=lambda s: isinstance(
            s, (optax.ScaleByAdamState, optax.ScaleByScheduleState)))
    st = st.replace(step=jnp.int32(STEP), opt_state=opt_state,
                    ema_params=tree(ema))
    b = _np_batch(B, seed=4)
    key = jax.random.PRNGKey(11)
    new, jm = j_make_distill_step(model, jcfg, env=None, donate=False)(
        st, tree(teacher), {k: jnp.asarray(v) for k, v in b.items()}, key,
        jnp.asarray(K, jnp.int32))
    jm = jax.device_get(jm)
    # The step's draws (distill.py:89-109): fold the step in, split.
    k_i, k_noise = jax.random.split(jax.random.fold_in(key, STEP))
    i = np.asarray(jax.random.randint(k_i, (B,), 1, K + 1))
    noise = np.array(jax.random.normal(k_noise, (B, H, H, 3)))
    assert (i == K).any() and (i < K).any()   # alpha_t ~ 4.5e-5 included

    pm = XUNet(pcfg.model)
    state = create_train_state(pm, pcfg.train)
    load_flax_train_state(state, params=student, ema_params=ema, mu=mu,
                          nu=nu, adam_count=7, schedule_count=8, step=STEP)
    pt = XUNet(pcfg.model).eval().requires_grad_(False)
    load_flax_params(pt, teacher)
    m = make_distill_step(pcfg)(
        state, pt, {k: torch.from_numpy(v) for k, v in b.items()}, K,
        draws=Replay(i, noise, K))
    assert state.step == int(new.step) == STEP + 1
    for name in ("distill_loss", "grad_norm", "lr"):
        ref = float(jm[name])
        assert abs(float(m[name]) - ref) <= 1e-5 * abs(ref), (name, ref)
    assert float(jm["grad_norm"]) > kw["grad_clip"]        # clipping acts
    names = [n for n, _ in pm.named_parameters()]
    got_p = dict(pm.named_parameters())
    adam = [s for s in jax.tree.leaves(
        new.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    for got, tree_ in ((lambda n: got_p[n].detach(), new.params),
                       (lambda n: state.ema[n], new.ema_params),
                       (lambda n: state.optimizer.state[got_p[n]]["exp_avg"],
                        adam.mu)):
        want = convert_params(flatten_dict(jax.device_get(tree_), sep="/"),
                              pm)
        assert _rel_l2([got(n) for n in names],
                       [want[n] for n in names]) <= 1e-4
    start = convert_params(student, pm)
    assert _rel_l2([got_p[n].detach() for n in names],
                   [start[n] for n in names]) > 1e-3      # it moved


def _teacher(cfg, seed):
    m = build_model(cfg.model, "cpu", seed=seed, randomize_zero_init=True)
    return {k: v.detach().clone() for k, v in m.named_parameters()}


def test_distill_two_rounds_smoke(tmp_path):
    """4 -> 2 -> 1 on the shallow tiny model: both rounds run, each lands
    a full_sliced checkpoint that restores bit for bit (the last round's
    is the returned EMA), and the 1-step student drives a finite DDIM
    sampler."""
    _, cfg = _cfgs(lr=0.01, warmup_examples=16)
    params = _teacher(cfg, 0)
    model = XUNet(cfg.model)
    final, history = distill(model, cfg, params, _torch_batches(),
                             final_steps=1, round_steps=2,
                             workdir=str(tmp_path), log_every=0)
    assert [h["student_steps"] for h in history] == [2, 1]
    for h in history:
        assert np.isfinite(h["final_loss"])
        ckpt = tmp_path / f"steps_{h['student_steps']}"
        assert h["checkpoint"] == str(ckpt)
        marker = json.loads((ckpt / "ckpt_format.json").read_text())
        assert marker["mode"] == "full_sliced"
        assert (ckpt / "2").is_dir()             # round_steps saved step
    assert any(not torch.equal(final[k], params[k]) for k in params)
    restored = create_train_state(XUNet(cfg.model), cfg.train)
    assert CheckpointManager(str(tmp_path / "steps_1")).restore(
        restored) == 2
    assert all(torch.equal(restored.ema[k], final[k]) for k in final)

    sampler_model = XUNet(cfg.model)
    load = dict(sampler_model.named_parameters())
    with torch.no_grad():
        for k, v in final.items():
            load[k].copy_(v)
    ds = SyntheticDataset(num_objects=1, num_views=3, imgsize=H)
    out = Sampler(sampler_model, cfg, device="cpu", sampler_kind="ddim",
                  steps=1).synthesize(ds.all_views(0),
                                      torch.Generator().manual_seed(2),
                                      max_views=3)
    assert out.shape[0] == 2 and np.isfinite(out).all()


def test_in_place_rounds_match_fresh_rounds():
    """The card's one-graph design, eagerly: ``distill`` reuses one step
    object and resets the state in place at each round; rounds that each
    start from a fresh model, ``create_train_state`` and step give the
    same losses, gradient norms and EMA bit for bit."""
    _, cfg = _cfgs(lr=0.01, warmup_examples=16, grad_clip=0.5)
    params = _teacher(cfg, 1)
    steps_per_round = 2
    final, history = distill(XUNet(cfg.model), cfg, params,
                             _torch_batches(seed=3), start_steps=4,
                             final_steps=1, round_steps=steps_per_round,
                             log_every=0)

    batches = _torch_batches(seed=3)
    teacher_w = params
    losses = []
    for k in (2, 1):
        teacher = XUNet(cfg.model).eval().requires_grad_(False)
        tparams = dict(teacher.named_parameters())
        student = XUNet(cfg.model)
        with torch.no_grad():
            for n, p in student.named_parameters():
                p.copy_(teacher_w[n])
                tparams[n].copy_(teacher_w[n])
        state = create_train_state(student.eval(), cfg.train)
        step = make_distill_step(cfg)
        for _ in range(steps_per_round):
            m = step(state, teacher, next(batches), k)
        losses.append(float(m["distill_loss"]))
        teacher_w = {n: v.clone() for n, v in state.ema.items()}
    assert [h["final_loss"] for h in history] == losses
    assert all(torch.equal(final[n], teacher_w[n]) for n in final)

    # start_round on a used state == a fresh state of the teacher.
    teacher = XUNet(cfg.model).eval()
    with torch.no_grad():
        for n, p in teacher.named_parameters():
            p.copy_(params[n])
    fresh = create_train_state(XUNet(cfg.model), cfg.train)
    start_round(fresh, teacher)
    used = state
    start_round(used, teacher)
    assert used.step == 0 and used.scheduler.last_epoch == 0
    assert used.optimizer.param_groups[0]["lr"] \
        == fresh.optimizer.param_groups[0]["lr"]
    for st in used.optimizer.state.values():
        assert all(not t.any() for t in st.values())
    for n, p in used.model.named_parameters():
        assert torch.equal(p, dict(fresh.model.named_parameters())[n])
        assert torch.equal(used.ema[n], fresh.ema[n])
