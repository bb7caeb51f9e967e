"""The port's train step as two bodies (micro, update) and the repaired
train -> sample path, on the CPU.

* The split step (``train/step.py``: ``micro_step`` x ``accum_steps``,
  then ``update_step``), run eagerly, against the port's previous
  ``make_train_step``, kept here verbatim: bit-identical over 3 steps.
* ``train_cli`` -> ``sample_cli`` through a checkpoint directory and one
  ``ckpt_<step>.pt``: the sampler gets the checkpoint's EMA weights, or
  its raw ones under ``--raw_params``; plain state dicts and Flax
  ``.npz`` files still load; the width flags build the same
  ``ModelConfig`` as the JAX package's ``cli/_common.py``.

The CUDA-graph half of the step is held against this eager path on the
card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import argparse
import dataclasses

import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu.cli import _common as jcommon  # noqa: E402
from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu_torch.cli import _common, sample_cli, train_cli  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset  # noqa: E402
from diff3d_tpu_torch.data.images import dequantize  # noqa: E402
from diff3d_tpu_torch.diffusion import TrainDraws, p_losses  # noqa: E402
from diff3d_tpu_torch.models import XUNet, build_model  # noqa: E402
from diff3d_tpu_torch.models import init_params as init_model  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.train import (CheckpointManager, Trainer,  # noqa: E402
                                    create_train_state, ema_decay_per_step,
                                    make_train_step, warmup_schedule)
from diff3d_tpu_torch.train.step import step_seed  # noqa: E402
from test_torch_port_sampler import _srn_object  # noqa: E402

H = 8


from _torch_port_threads import one_thread  # noqa: E402,F401


def _parent_make_train_step(cfg):
    """The port's train step before it was split into micro and update
    bodies, verbatim."""
    tcfg, dcfg = cfg.train, cfg.diffusion
    accum = tcfg.accum_steps
    sched = warmup_schedule(tcfg)
    decay = ema_decay_per_step(tcfg)

    def step(state, batch, draws=None):
        model = state.model
        model.train()
        names, params = zip(*model.named_parameters())
        imgs = dequantize(batch["imgs"])
        B = imgs.shape[0]
        mb = B // accum
        if draws is None:
            gen = torch.Generator(imgs.device).manual_seed(
                step_seed(tcfg.seed, state.step))
            draws = [TrainDraws(gen)] * accum
        state.optimizer.zero_grad(set_to_none=True)
        total = None
        for i, d in enumerate(draws):
            sl = slice(i * mb, (i + 1) * mb)
            gen = getattr(d, "generator", None)

            def denoise(model_batch, cond_mask, gen=gen):
                return model(model_batch, cond_mask, generator=gen)

            loss = p_losses(
                denoise, imgs[sl], batch["R"][sl], batch["T"][sl],
                batch["K"][sl], d, cond_prob=dcfg.cond_prob,
                loss_type=dcfg.loss_type, logsnr_min=dcfg.logsnr_min,
                logsnr_max=dcfg.logsnr_max)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
            total = total / accum
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if tcfg.grad_clip > 0:
            torch._foreach_mul_(grads, torch.where(
                grad_norm < tcfg.grad_clip, 1.0, tcfg.grad_clip / grad_norm))
        lr = sched(state.step)
        state.optimizer.step()
        state.scheduler.step()
        with torch.no_grad():
            ema = [state.ema[n] for n in names]
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, [p.detach() for p in params],
                                alpha=1.0 - decay)
        state.step += 1
        return {"loss": total, "lr": lr, "grad_norm": grad_norm}

    return step


def _cfg(**train_kw):
    p = port_tiny_config(imgsize=H, ch=8, shallow=True)
    return dataclasses.replace(p, train=dataclasses.replace(p.train,
                                                            **train_kw))


def _state(pcfg, seed=0):
    model = XUNet(pcfg.model)
    init_model(model, torch.Generator().manual_seed(seed),
               randomize_zero_init=True)
    return create_train_state(model.train(), pcfg.train)


def _tensors(state):
    out = {f"p.{k}": v for k, v in state.model.named_parameters()}
    out.update({f"g.{k}": v.grad for k, v in state.model.named_parameters()})
    out.update({f"ema.{k}": v for k, v in state.ema.items()})
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("accum,clip", [(1, 0.0), (2, 0.05)],
                         ids=["accum1", "accum2clip"])
def test_split_step_is_bit_identical_to_the_parent_step(accum, clip):
    """Three steps from one state, each with its (seed, step) generator
    feeding the loss draws and dropout: losses, gradient norms, lrs,
    parameters, gradients, Adam's state and the EMA all equal."""
    pcfg = _cfg(accum_steps=accum, grad_clip=clip, lr=0.01,
                warmup_examples=16)
    loader = InfiniteLoader(SyntheticDataset(num_objects=4, num_views=6,
                                             imgsize=H), 8, num_workers=0)
    batches = [{k: torch.from_numpy(v) for k, v in loader.batch(s).items()}
               for s in range(3)]
    new, old = _state(pcfg), _state(pcfg)
    split, parent = make_train_step(pcfg), _parent_make_train_step(pcfg)
    clipped = False
    for batch in batches:
        got, want = split(new, batch), parent(old, batch)
        assert torch.equal(got["loss"], want["loss"])
        assert torch.equal(got["grad_norm"], want["grad_norm"])
        assert got["lr"] == want["lr"]
        clipped |= clip > 0 and float(want["grad_norm"]) > clip
    assert new.step == old.step == 3
    assert clipped or clip == 0
    a, b = _tensors(new), _tensors(old)
    assert a.keys() == b.keys() and len(a) > 40
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cuda_graphs_on_the_cpu_raise(tmp_path):
    pcfg = _cfg()
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        Trainer(pcfg, workdir=str(tmp_path), device="cpu", cuda_graphs=True)
    t = Trainer(pcfg, workdir=str(tmp_path), device="cpu")
    assert not t.step_fn.cuda_graphs and t.step_fn.graphs is None


def test_restore_keeps_the_optimizer_kind(tmp_path):
    """A checkpoint written by a plain Adam restores into a ``capturable``
    one (the card's) as capturable, with its lr a tensor and its step
    counts float32, and the other way round."""
    pcfg = _cfg(lr=0.01, warmup_examples=16)
    plain = _state(pcfg)
    make_train_step(pcfg)(plain, {k: torch.from_numpy(v) for k, v in
                                  InfiniteLoader(SyntheticDataset(
                                      num_objects=4, num_views=6,
                                      imgsize=H), 8, num_workers=0)
                                  .batch(0).items()})
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(plain)
    other = _state(pcfg, seed=1)
    group = other.optimizer.param_groups[0]
    group["capturable"] = True
    assert ckpt.restore(other) == 1
    group = other.optimizer.param_groups[0]
    assert group["capturable"] is True
    assert torch.is_tensor(group["lr"]) and float(group["lr"]) == float(
        np.float32(plain.optimizer.param_groups[0]["lr"]))
    st = next(iter(other.optimizer.state.values()))
    assert st["step"].dtype == torch.float32 and float(st["step"]) == 1.0
    ckpt.save(other, force=True)
    back = _state(pcfg, seed=2)
    ckpt.restore(back)
    assert not back.optimizer.param_groups[0]["capturable"]
    assert isinstance(back.optimizer.param_groups[0]["lr"], float)


# --- train -> sample --------------------------------------------------------

WIDTH = ["--ch", "8", "--num_res_blocks", "1"]


def test_train_cli_then_sample_cli_samples_with_the_ema(tmp_path,
                                                        monkeypatch):
    """A narrow model trained by ``train_cli`` (width flags), sampled by
    ``sample_cli`` with the same flags from its checkpoint directory and
    from its ``ckpt_2.pt``: the EMA weights by default, the raw ones under
    ``--raw_params``."""
    work = tmp_path / "run"
    train_cli.main(["--device", "cpu", "--config", "test", "--synthetic",
                    "--steps", "2", "--num_workers", "0", "--workdir",
                    str(work), "--warmup_examples", "16",
                    "--ema_halflife_examples", "32"] + WIDTH)
    ckdir = work / "checkpoints"
    saved = torch.load(ckdir / "ckpt_2.pt", weights_only=True)
    assert saved["step"] == 2
    assert any(not torch.equal(saved["ema"][k], saved["model"][k])
               for k in saved["ema"])
    seen = []
    synthesize = Sampler.synthesize

    def spy(self, *args, **kwargs):
        seen.append({k: p.detach().clone()
                     for k, p in self.model.named_parameters()})
        return synthesize(self, *args, **kwargs)

    monkeypatch.setattr(Sampler, "synthesize", spy)
    obj = _srn_object(tmp_path / "obj", size=16)
    for i, (model, raw) in enumerate(((ckdir, False),
                                      (ckdir / "ckpt_2.pt", False),
                                      (ckdir / "ckpt_2.pt", True),
                                      (ckdir, True))):
        out = tmp_path / f"out{i}"
        sample_cli.main(["--model", str(model), "--target", str(obj),
                         "--out", str(out), "--config", "test", "--device",
                         "cpu", "--max_views", "2"] + WIDTH
                        + (["--raw_params"] if raw else []))
        assert (out / "1" / "7.png").exists()
        want = saved["model"] if raw else saved["ema"]
        assert seen[-1].keys() == saved["ema"].keys()
        for k, t in seen[-1].items():
            assert torch.equal(t, want[k]), (model, raw, k)
    with pytest.raises(SystemExit):        # 3 does not divide the 4 steps
        sample_cli.main(["--model", str(ckdir), "--target", str(obj),
                         "--config", "test", "--device", "cpu",
                         "--scan_chunks", "3"] + WIDTH)


def test_load_eval_params_takes_state_dicts_and_npz(tmp_path):
    cfg = port_tiny_config()
    src = build_model(cfg.model, device="cpu", seed=3)
    torch.save(src.state_dict(), tmp_path / "m.pt")
    for raw in (False, True):
        dst = build_model(cfg.model, device="cpu", seed=4)
        assert _common.load_eval_params(str(tmp_path / "m.pt"), dst,
                                        raw) is None
        for k, v in src.state_dict().items():
            assert torch.equal(dst.state_dict()[k], v), k

    jm = JXUNet(jax_tiny_config().model)
    batch = {"x": np.zeros((2, 16, 16, 3), np.float32),
             "z": np.zeros((2, 16, 16, 3), np.float32),
             "logsnr": np.zeros((2, 2), np.float32),
             "R": np.zeros((2, 2, 3, 3), np.float32),
             "t": np.zeros((2, 2, 3), np.float32),
             "K": np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))}
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch, cond_mask=np.ones(2, bool)))
    np.savez(tmp_path / "p.npz", **{
        k: np.full(s.shape, 0.01, np.float32)
        for k, s in flatten_dict(shapes["params"], sep="/").items()})
    dst = build_model(cfg.model, device="cpu", seed=4)
    assert _common.load_eval_params(str(tmp_path / "p.npz"), dst,
                                    False) is None
    assert all(torch.all(p == 0.01) for p in dst.parameters())
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        _common.load_eval_params(str(tmp_path / "empty"), dst, False)


@pytest.mark.parametrize("flags", [
    [], ["--ch", "16"],
    ["--ch", "16", "--emb_ch", "32", "--num_res_blocks", "1",
     "--imgsize", "32"]])
def test_width_flags_build_the_jax_model_config(flags):
    """``train_cli`` and ``sample_cli`` take the width flags as the JAX
    package's ``cli/_common.py`` does."""
    jp = argparse.ArgumentParser()
    jcommon.add_model_width_args(jp)
    jcfg = jcommon.apply_model_width_overrides(jax_tiny_config(),
                                               jp.parse_args(flags))
    for cli, extra in ((train_cli, []),
                       (sample_cli, ["--model", "m", "--target", "t"])):
        pcfg = cli.config_from_args(cli.build_parser().parse_args(
            ["--config", "test"] + extra + flags))
        for field in ("ch", "emb_ch", "num_res_blocks", "H", "W"):
            assert getattr(pcfg.model, field) == getattr(jcfg.model, field)
