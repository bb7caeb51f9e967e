"""The port's reference-checkpoint conversion (``diff3d_tpu_torch/convert/
torch_ckpt.py``, ``cli/convert_cli.py``) on the CPU, against the JAX
package's (``diff3d_tpu/convert/torch_ckpt.py``).

* Random weights of ``tests/_torch_xunet.py::TXUNet`` (the reference's
  composition in torch) at ``test_config``: JAX ``convert_state_dict`` ->
  the port's ``from_jax`` on one side, the port's ``convert_state_dict``
  on the other: bit-identical state dicts.
* The converted port forward against ``TXUNet``'s, 1e-4 absolute and
  relative in float32, as ``tests/test_torch_parity.py`` holds the JAX
  package.
* ``expected_torch_state`` and ``verify_state_dict`` give the JAX
  package's key set and reports (a dropped key, an extra key, a changed
  shape, a ``module.`` prefix).
* ``convert_cli`` end to end: ``--verify`` writes nothing and a mutated
  file exits non-zero; the conversion keeps the step, puts the schedule
  at it, starts Adam at zero moments, seeds the EMA with the weights; and
  ``sample_cli`` and ``train_cli --transfer`` load the result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from _torch_xunet import TXUNet  # noqa: E402
from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.convert.torch_ckpt import convert_state_dict as j_convert  # noqa: E402
from diff3d_tpu.convert.torch_ckpt import expected_torch_state as j_expected  # noqa: E402
from diff3d_tpu.convert.torch_ckpt import verify_state_dict as j_verify  # noqa: E402
from diff3d_tpu.geometry import pinhole_rays  # noqa: E402
from diff3d_tpu_torch.cli import convert_cli, sample_cli, train_cli  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.convert import (convert_params,  # noqa: E402
                                      convert_state_dict,
                                      expected_torch_state,
                                      load_torch_checkpoint,
                                      verify_state_dict)
from diff3d_tpu_torch.models import XUNet  # noqa: E402
from diff3d_tpu_torch.train import warmup_schedule  # noqa: E402
from test_torch_port_sampler import _srn_object  # noqa: E402


from _torch_port_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def reference():
    """A randomised ``TXUNet`` at ``test_config(imgsize=16, ch=8)`` (every
    parameter, the zero-initialised convs too) and its state dict."""
    cfg = jax_tiny_config(imgsize=16, ch=8).model
    torch.manual_seed(0)
    tm = TXUNet(cfg).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.08)
    return tm, {k: v.clone() for k, v in tm.state_dict().items()}


def test_torch_ckpt_is_bit_identical_to_jax_then_from_jax(reference):
    _, sd = reference
    jcfg = jax_tiny_config(imgsize=16, ch=8).model
    pcfg = port_tiny_config(imgsize=16, ch=8).model
    via_jax = convert_params(flatten_dict(j_convert(sd, jcfg), sep="/"),
                             XUNet(pcfg))
    direct = convert_state_dict(sd, pcfg)
    assert direct.keys() == via_jax.keys() == XUNet(pcfg).state_dict().keys()
    for k in direct:
        assert direct[k].dtype == via_jax[k].dtype == torch.float32
        assert torch.equal(direct[k], via_jax[k]), k
    # The DataParallel prefix is stripped; numpy values convert the same.
    prefixed = {f"module.{k}": v.numpy() for k, v in sd.items()}
    again = convert_state_dict(prefixed, pcfg)
    assert all(torch.equal(again[k], direct[k]) for k in direct)
    with pytest.raises(KeyError, match="extra"):
        convert_state_dict(dict(sd, stray=torch.zeros(1)), pcfg)


def test_converted_forward_matches_the_reference_composition(reference):
    tm, sd = reference
    cfg = port_tiny_config(imgsize=16, ch=8).model
    B, H, W = 2, cfg.H, cfg.W
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.normal(size=(B, 2, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    t = rng.normal(0, 1.5, (B, 2, 3)).astype(np.float32)
    K = np.broadcast_to(np.array([[19.0, 0, 8], [0, 19.0, 8], [0, 0, 1]],
                                 np.float32), (B, 3, 3)).copy()
    batch = {"x": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
             "z": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
             "logsnr": np.stack([np.full(B, 20.0), rng.uniform(-20, 20, B)],
                                1).astype(np.float32),
             "R": R, "t": t, "K": K}
    cond_mask = np.array([True, False])            # both CFG branches
    pos, dirs = pinhole_rays(jnp.asarray(R), jnp.asarray(t),
                             jnp.asarray(K)[:, None], H, W)
    with torch.no_grad():
        ref = tm({"x": torch.from_numpy(batch["x"]).permute(0, 3, 1, 2),
                  "z": torch.from_numpy(batch["z"]).permute(0, 3, 1, 2),
                  "logsnr": torch.from_numpy(batch["logsnr"])},
                 torch.from_numpy(np.asarray(pos).copy()),
                 torch.from_numpy(np.asarray(dirs).copy()),
                 torch.from_numpy(cond_mask)).permute(0, 2, 3, 1)
        model = XUNet(cfg).eval()
        model.load_state_dict(convert_state_dict(sd, cfg))
        out = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    torch.from_numpy(cond_mask))
    assert out.shape == ref.shape == (B, H, W, 3)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_verify_reports_match_jax(reference):
    _, sd = reference
    jcfg = jax_tiny_config(imgsize=16, ch=8).model
    pcfg = port_tiny_config(imgsize=16, ch=8).model
    assert expected_torch_state(pcfg) == j_expected(jcfg)
    keys = sorted(sd)
    dropped = {k: v for k, v in sd.items() if k != keys[3]}
    extra = {f"module.{k}": v for k, v in sd.items()}
    extra["module.unused.weight"] = torch.zeros(2)
    reshaped = dict(sd)
    reshaped[keys[7]] = torch.zeros(tuple(sd[keys[7]].shape) + (2,))
    assert not any(verify_state_dict(sd, pcfg).values())
    for bad in (dropped, extra, reshaped):
        got = verify_state_dict(bad, pcfg)
        assert got == j_verify(bad, jcfg)
        assert any(got.values())


def _write_pt(path, sd, step, prefix=""):
    torch.save({"model": {prefix + k: v for k, v in sd.items()},
                "optim": {}, "step": step}, path)
    return str(path)


def test_convert_cli_end_to_end(reference, tmp_path):
    _, sd = reference
    pt = _write_pt(tmp_path / "latest.pt", sd, 1234, prefix="module.")
    out = tmp_path / "work" / "checkpoints"
    base = ["--torch_ckpt", pt, "--out", str(out), "--config", "test",
            "--device", "cpu"]
    convert_cli.main(base + ["--verify"])
    assert not out.exists()                         # a dry run
    bad = dict(sd)
    bad.pop(sorted(sd)[0])
    bad[sorted(sd)[5]] = torch.zeros(3)
    with pytest.raises(SystemExit) as e:
        convert_cli.main(["--torch_ckpt", _write_pt(tmp_path / "bad.pt", bad,
                                                    1), "--out",
                          str(tmp_path / "never"), "--config", "test",
                          "--device", "cpu"])
    assert e.value.code not in (0, None) and "1 missing" in str(e.value)
    assert not (tmp_path / "never").exists()

    convert_cli.main(base)
    saved = torch.load(out / "ckpt_1234.pt", weights_only=True)
    want, step = load_torch_checkpoint(pt, port_tiny_config().model)
    assert saved["step"] == step == 1234
    assert saved["sched"]["last_epoch"] == 1234
    assert saved["optim"]["state"] == {}            # Adam at zero moments
    assert saved["optim"]["param_groups"][0]["lr"] == pytest.approx(
        warmup_schedule(port_tiny_config().train)(1234))
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v)
        assert torch.equal(saved["ema"][k], v)

    convert_cli.main(base + ["--step", "7", "--out", str(tmp_path / "s7")])
    assert (tmp_path / "s7" / "ckpt_7.pt").exists()

    # sample_cli loads it (its EMA), and train_cli --transfer resumes it.
    obj = _srn_object(tmp_path / "obj", size=16)
    sample_cli.main(["--model", str(out), "--target", str(obj), "--out",
                     str(tmp_path / "samples"), "--config", "test",
                     "--device", "cpu", "--max_views", "2", "--steps", "2",
                     "--sampler", "ddim"])
    assert (tmp_path / "samples" / "1" / "7.png").exists()
    trainer = train_cli.build_trainer(train_cli.build_parser().parse_args(
        ["--device", "cpu", "--config", "test", "--synthetic", "--transfer",
         "--num_workers", "0", "--steps", "1235", "--workdir",
         str(tmp_path / "work")]))
    try:
        state = trainer.state
        assert state.step == 1234 and state.scheduler.last_epoch == 1234
        for k, p in state.model.named_parameters():
            assert torch.equal(p.detach(), want[k])
        trainer.train()
    finally:
        trainer.loader.close()
    assert trainer.state.step == 1235
