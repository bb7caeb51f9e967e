"""The port's checkpoint modes (``diff3d_tpu_torch/train/checkpoint.py``,
counterpart ``diff3d_tpu/train/checkpoint.py``) on the CPU.

* ``full`` and ``full_sliced`` (synchronous and asynchronous): 2 steps,
  save, restore into a state with other weights, 2 more steps == 4 steps
  straight, bit for bit; ``keep`` prunes.
* ``ema_bf16``: ``{step, ema}`` in bfloat16; it loads as eval weights
  (``restore_ema``, ``load_eval_params``), refuses ``restore()`` and raw
  weights, and a ``Trainer`` with ``transfer=True`` warm-restarts from it.
* The ``ckpt_format.json`` marker: an unmarked directory is ``full``; a
  mode that disagrees with the marker, or relabels a directory of full
  checkpoints, is refused.
* The restore preflight: a checkpoint of another width raises
  ``CheckpointMismatchError`` naming the tensor, expected and found
  shapes and the step, before anything is copied.
* Asynchronous writes: ``wait_until_finished`` is the durability
  barrier, and a write that failed is raised by the next call.
* The ``Trainer`` (``train_cli --ckpt_mode full_sliced``) resumes from
  its sliced checkpoints.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu_torch.cli import _common, train_cli  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset  # noqa: E402
from diff3d_tpu_torch.data import prefetch_to_device  # noqa: E402
from diff3d_tpu_torch.models import XUNet  # noqa: E402
from diff3d_tpu_torch.models import init_params as init_model  # noqa: E402
from diff3d_tpu_torch.runtime import RetryPolicy  # noqa: E402
from diff3d_tpu_torch.train import (CheckpointManager,  # noqa: E402
                                    CheckpointMismatchError, Trainer,
                                    create_train_state, make_train_step)
from diff3d_tpu_torch.train import checkpoint as ckpt_mod  # noqa: E402

H = 8


from _torch_port_threads import one_thread  # noqa: E402,F401


def _cfg(**train_kw):
    c = port_tiny_config(imgsize=H, ch=8, shallow=True)
    return dataclasses.replace(c, train=dataclasses.replace(
        c.train, **dict(dict(lr=0.01, warmup_examples=16), **train_kw)))


def _state(cfg, seed=0):
    model = XUNet(cfg.model)
    init_model(model, torch.Generator().manual_seed(seed),
               randomize_zero_init=True)
    return create_train_state(model.train(), cfg.train)


def _batches(n):
    loader = InfiniteLoader(SyntheticDataset(num_objects=4, num_views=6,
                                             imgsize=H), 8, num_workers=0)
    return [{k: torch.from_numpy(v) for k, v in loader.batch(s).items()}
            for s in range(n)]


def _tensors(state):
    out = {f"model.{k}": v.clone()
           for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in state.ema.items()})
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam.{i}.{k}": v.clone() for k, v in st.items()})
    return out, state.scheduler.last_epoch, state.step, \
        state.optimizer.param_groups[0]["lr"]


def _assert_same(a, b):
    assert a[0].keys() == b[0].keys()
    differ = [k for k in a[0] if not torch.equal(a[0][k], b[0][k])]
    assert not differ, differ[:5]
    assert a[1:] == b[1:]


@pytest.mark.parametrize("mode,async_writes", [("full", False),
                                               ("full_sliced", False),
                                               ("full_sliced", True)])
def test_exact_resume(tmp_path, mode, async_writes):
    cfg = _cfg()
    batches = _batches(4)
    step = make_train_step(cfg)
    straight = _state(cfg)
    for b in batches:
        step(straight, b)
    first = _state(cfg)
    for b in batches[:2]:
        step(first, b)
    mgr = CheckpointManager(str(tmp_path / "c"), keep=2, mode=mode,
                            async_writes=async_writes)
    assert mgr.save(first) and not mgr.save(first)
    mgr.wait_until_finished()
    assert mgr.steps() == [2]
    assert (mode == "full") != os.path.exists(tmp_path / "c" /
                                              "ckpt_format.json")
    resumed = _state(cfg, seed=1)                 # other weights entirely
    ids = {k: v.data_ptr() for k, v in resumed.ema.items()}
    assert CheckpointManager(str(tmp_path / "c")).restore(resumed) == 2
    assert {k: v.data_ptr() for k, v in resumed.ema.items()} == ids
    _assert_same(_tensors(resumed), _tensors(first))
    for b in batches[2:]:
        step(resumed, b)
    _assert_same(_tensors(resumed), _tensors(straight))
    for s in (3, 4):
        resumed.step = s
        mgr.save(resumed)
    mgr.wait_until_finished()
    mgr.close()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4


def test_sliced_restore_into_used_state_copies_in_place(tmp_path):
    """A step-0 checkpoint (no Adam state yet) restored into a state that
    has taken steps: the moments are zeroed where they are, every address
    kept."""
    cfg = _cfg()
    fresh = _state(cfg)
    mgr = CheckpointManager(str(tmp_path), mode="full_sliced",
                            async_writes=False)
    mgr.save(fresh)
    used = _state(cfg, seed=2)
    make_train_step(cfg)(used, _batches(1)[0])
    ptrs = [t.data_ptr() for _, t in ckpt_mod.state_leaves(used)]
    assert mgr.restore(used) == 0
    assert [t.data_ptr() for _, t in ckpt_mod.state_leaves(used)] == ptrs
    for st in used.optimizer.state.values():
        assert all(not t.any() for t in st.values())
    assert used.scheduler.last_epoch == 0
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(used.model.state_dict()[k], v)


def test_ema_bf16_loads_as_eval_weights_and_warm_restarts(tmp_path):
    cfg = _cfg(max_steps=2, ckpt_every=2, log_every=1, ckpt_mode="ema_bf16")
    ds = SyntheticDataset(num_objects=4, num_views=6, imgsize=H)
    t = Trainer(cfg, workdir=str(tmp_path), device="cpu")
    t.loader = iter(_batches(2))
    t.train()
    ckdir = str(tmp_path / "checkpoints")
    marker = json.loads(open(os.path.join(ckdir, "ckpt_format.json")).read())
    assert marker == {"mode": "ema_bf16"}
    saved = torch.load(os.path.join(ckdir, "ckpt_2.pt"), weights_only=True)
    assert set(saved) == {"ema", "step"} and saved["step"] == 2
    assert all(v.dtype == torch.bfloat16 for v in saved["ema"].values())
    want = {k: v.to(torch.bfloat16).float() for k, v in t.state.ema.items()}

    model = XUNet(cfg.model)
    assert _common.load_eval_params(ckdir, model, False) == 2
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k])
    with pytest.raises(ValueError, match="no raw"):
        _common.load_eval_params(ckdir, model, True)
    with pytest.raises(ValueError, match="restore_ema"):
        CheckpointManager(ckdir).restore(_state(cfg))

    warm = Trainer(cfg, workdir=str(tmp_path), transfer=True, device="cpu")
    assert warm.state.step == 2 and warm.state.scheduler.last_epoch == 2
    assert not warm.state.optimizer.state          # Adam starts at zero
    for k, p in warm.state.model.named_parameters():
        assert torch.equal(p.detach(), want[k])
        assert torch.equal(warm.state.ema[k], want[k])
    warm.loader = prefetch_to_device(
        InfiniteLoader(ds, 8, num_workers=0, start_step=2), "cpu")
    warm.train(max_steps=3)
    warm.loader.close()
    assert warm.state.step == 3


def test_marker_and_mode_conflicts(tmp_path):
    cfg = _cfg()
    full = CheckpointManager(str(tmp_path / "full"))
    assert full.mode == "full"
    full.save(_state(cfg))
    assert not os.path.exists(tmp_path / "full" / "ckpt_format.json")
    with pytest.raises(ValueError, match="refusing to relabel"):
        CheckpointManager(str(tmp_path / "full"), mode="full_sliced")
    CheckpointManager(str(tmp_path / "s"), mode="full_sliced")
    assert CheckpointManager(str(tmp_path / "s")).mode == "full_sliced"
    with pytest.raises(ValueError, match="marked mode='full_sliced'"):
        CheckpointManager(str(tmp_path / "s"), mode="full")
    with pytest.raises(ValueError, match="not in"):
        CheckpointManager(str(tmp_path / "x"), mode="orbax")


@pytest.mark.parametrize("mode", ["full", "full_sliced", "ema_bf16"])
def test_preflight_names_the_mismatched_tensor(tmp_path, mode):
    small = _state(_cfg())
    make_train_step(_cfg())(small, _batches(1)[0])
    mgr = CheckpointManager(str(tmp_path), mode=mode, async_writes=False)
    mgr.save(small)
    wide_cfg = dataclasses.replace(_cfg(), model=dataclasses.replace(
        _cfg().model, ch=16))
    wide = _state(wide_cfg)
    before = {k: v.clone() for k, v in wide.ema.items()}
    with pytest.raises(CheckpointMismatchError) as e:
        if mode == "ema_bf16":
            mgr.restore_ema(wide.ema)
        else:
            mgr.restore(wide)
    err = e.value
    assert err.step == 1 and err.leaf in str(err)
    assert err.expected != err.found and err.leaf.split(".")[0] in (
        "model", "ema", "adam")
    assert all(torch.equal(before[k], v) for k, v in wide.ema.items())
    # A tensor that is missing is named as such.
    if mode == "full_sliced":
        with open(os.path.join(mgr.path(1), "sliced_manifest.json")) as f:
            manifest = json.load(f)
        manifest["leaves"][0]["name"] = "model.gone"
        with open(os.path.join(mgr.path(1), "sliced_manifest.json"),
                  "w") as f:
            json.dump(manifest, f)
        with pytest.raises(CheckpointMismatchError, match="no tensor") as e:
            mgr.restore(_state(_cfg()))
        assert e.value.found is None


def test_async_errors_surface_at_the_next_call(tmp_path, monkeypatch):
    cfg = _cfg()
    state = _state(cfg)
    no_retry = RetryPolicy(max_attempts=2, base_delay_s=0.0, jitter=0.0,
                           sleep=lambda s: None)
    mgr = CheckpointManager(str(tmp_path), mode="full_sliced",
                            async_writes=True, write_retry=no_retry)
    real = np.save
    calls = []

    def failing(path, arr):
        calls.append(path)
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "save", failing)
    assert mgr.save(state)                     # accepted, written later
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()
    assert len(calls) == 2                     # the policy's two attempts
    mgr.wait_until_finished()                  # raised once, then clear
    state.step = 1
    assert mgr.save(state)
    mgr._queue.join()                          # the writer has failed
    state.step = 2
    with pytest.raises(OSError, match="disk full"):
        mgr.save(state)                        # the next call raises it
    monkeypatch.setattr(ckpt_mod.np, "save", real)
    assert mgr.save(state)
    mgr.wait_until_finished()
    mgr.close()
    assert mgr.steps() == [2]                  # nothing half-written


def test_trainer_resumes_from_sliced_checkpoints(tmp_path):
    argv = ["--device", "cpu", "--config", "test", "--synthetic",
            "--num_workers", "0", "--workdir", str(tmp_path),
            "--ckpt_mode", "full_sliced", "--ckpt_every", "2"]
    train_cli.main(argv + ["--steps", "3"])
    ckdir = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckdir)) == ["2", "3", "ckpt_format.json"]
    first = train_cli.build_trainer(train_cli.build_parser().parse_args(
        argv + ["--transfer"]))
    first.loader.close()
    assert first.state.step == 3
    with pytest.raises(SystemExit):
        train_cli.build_parser().parse_args(argv + ["--ckpt_mode", "orbax"])
    args = train_cli.build_parser().parse_args(argv + ["--no-ckpt_async"])
    assert train_cli.config_from_args(args).train.ckpt_async is False
