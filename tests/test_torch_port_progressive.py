"""The port's progressive resolution transfer (``diff3d_tpu_torch/convert/
progressive.py``, ``train_cli --init_from / --init_res``) on the CPU,
against the JAX package's (``diff3d_tpu/convert/progressive.py``).

* ``adapt_params_resolution`` against ``jax.image.resize(...,
  "bilinear")`` on a random ``pos_emb [H, W, 144]``: up 16 -> 32 within
  1e-6 absolute (the same weights: half-pixel centres, the edge tap
  renormalised); down 32 -> 16 within 1e-6 absolute (both antialias with
  the triangle filter widened by the scale, renormalised at the edges).
  Every other tensor passes through as it is.
* ``check_resolution_compatible``: another width or depth raises, naming
  the first mismatched tensor.
* ``train_cli --init_from`` seeds the parameters and the EMA from a 8x8
  checkpoint into a 16x16 trainer, in place (every address kept), and is
  skipped after a ``--transfer`` resume past step 0.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu_torch.cli import train_cli  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.convert import (adapt_params_resolution,  # noqa: E402
                                      check_resolution_compatible,
                                      init_student_from_teacher)
from diff3d_tpu_torch.models import XUNet  # noqa: E402
from diff3d_tpu_torch.models import build_model  # noqa: E402
from diff3d_tpu_torch.train import CheckpointManager  # noqa: E402

POS = "conditioningprocessor.pos_emb"


from _torch_port_threads import one_thread  # noqa: E402,F401


@pytest.mark.parametrize("src,dst", [(16, 32), (32, 16), (16, 8)])
def test_adapt_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(src + dst)
    pe = rng.standard_normal((src, src, 144)).astype(np.float32)
    other = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    got = adapt_params_resolution({POS: torch.from_numpy(pe), "x": other},
                                  (dst, dst))
    want = np.asarray(jax.image.resize(pe, (dst, dst, 144), "bilinear"))
    assert got[POS].shape == (dst, dst, 144)
    np.testing.assert_allclose(got[POS].numpy(), want, atol=1e-6, rtol=0)
    assert got["x"] is other
    same = adapt_params_resolution({POS: got[POS]}, (dst, dst))
    assert same[POS] is got[POS]                 # nothing to resize
    with pytest.raises(KeyError, match="conditioningprocessor"):
        adapt_params_resolution({"exp_avg": other}, (dst, dst))


def _params(**model_kw):
    cfg = port_tiny_config(imgsize=8)
    model = build_model(dataclasses.replace(cfg.model, **model_kw), "cpu")
    return {k: v.detach() for k, v in model.named_parameters()}


def test_check_resolution_compatible_names_the_mismatch():
    small = _params()
    up = init_student_from_teacher(small, (16, 16))
    assert up[POS].shape == (16, 16, 144)
    assert all(up[k] is not small[k] and torch.equal(up[k], small[k])
               for k in small if k != POS)
    check_resolution_compatible(up, _params(H=16, W=16))
    with pytest.raises(ValueError,
                       match=r"shape mismatch at conditioningprocessor\."
                             r"Dense_0\.weight: source \(32, 32\) vs "
                             r"target \(64, 64\)"):
        check_resolution_compatible(up, _params(H=16, W=16, emb_ch=64))
    with pytest.raises(ValueError,
                       match=r"tree mismatch: missing=\[.down_0_1\."):
        check_resolution_compatible(up, _params(H=16, W=16,
                                                num_res_blocks=2))


def test_train_cli_init_from_seeds_in_place(tmp_path, caplog):
    small = tmp_path / "small"
    train_cli.main(["--device", "cpu", "--config", "test", "--imgsize", "8",
                    "--synthetic", "--steps", "1", "--num_workers", "0",
                    "--workdir", str(small)])
    src = XUNet(port_tiny_config(imgsize=8).model)
    assert CheckpointManager(str(small / "checkpoints")).restore_ema(
        dict(src.named_parameters())) == 1
    want = adapt_params_resolution(
        {k: v.detach() for k, v in src.named_parameters()}, (16, 16))

    argv = ["--device", "cpu", "--config", "test", "--synthetic",
            "--num_workers", "0", "--steps", "1", "--workdir",
            str(tmp_path / "big")]
    trainer = train_cli.build_trainer(train_cli.build_parser().parse_args(
        argv))
    trainer.loader.close()
    ptrs = ([p.data_ptr() for p in trainer.state.model.parameters()]
            + [t.data_ptr() for t in trainer.state.ema.values()])
    train_cli.seed_from_checkpoint(trainer, str(small / "checkpoints"), 8)
    assert ptrs == ([p.data_ptr() for p in trainer.state.model.parameters()]
                    + [t.data_ptr() for t in trainer.state.ema.values()])
    for k, p in trainer.state.model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
        assert torch.equal(trainer.state.ema[k], want[k]), k

    seeded = argv + ["--init_from", str(small / "checkpoints"),
                     "--init_res", "8"]
    train_cli.main(seeded)                         # one step from the seed
    with caplog.at_level(logging.INFO):
        again = train_cli.build_trainer(train_cli.build_parser().parse_args(
            seeded + ["--transfer"]))
    again.loader.close()
    assert again.state.step == 1
    assert "SKIPPED" in caplog.text
