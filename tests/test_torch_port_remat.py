"""Rematerialisation in the port (``ModelConfig.remat`` / ``remat_policy``,
``diff3d_tpu_torch/models/xunet.py``) and the configurations that set it,
against the JAX package.

Tolerances: the configs field for field (exact); the tiny X-UNet with
remat under "dots" against the JAX package's (jitted, f32) at rel. L2
1e-4, forward and the gradients of mean(out^2) -- the whole-model limit
of the port's other model tests; remat on against remat off in the port
bit for bit (``torch.equal``): the recompute runs the same ops on the
same inputs, and the dropout masks come from the generator's replayed
state.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu_torch import config as pconfig  # noqa: E402
from diff3d_tpu_torch.cli import train_cli  # noqa: E402
from diff3d_tpu_torch.convert import (convert_params,  # noqa: E402
                                      load_flax_params)
from diff3d_tpu_torch.models import build_model, xunet  # noqa: E402


from _torch_port_threads import one_thread  # noqa: E402,F401


def _fields_equal(port, ref, where):
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _fields_equal(a, b, f"{where}.{f.name}")
        else:
            if isinstance(a, (list, tuple)):
                a, b = list(a), list(b)
            assert a == b, (f"{where}.{f.name}", a, b)


@pytest.mark.parametrize("name", ["srn64_config", "srn128_config",
                                  "test_config"])
def test_configs_match_the_jax_package(name):
    """Every field the port carries, remat and remat_policy included: the
    port's srn128_config rematerialises every block, as the reference's
    does (``diff3d_tpu/config.py:371-374``)."""
    _fields_equal(getattr(pconfig, name)(), getattr(jconfig, name)(), name)
    if name == "srn128_config":
        assert pconfig.srn128_config().model.remat


def test_remat_policy_is_validated():
    bad = dataclasses.replace(pconfig.srn64_config().model,
                              remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        bad.validate()


def _batch(B, H, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(B, 2, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    K = np.broadcast_to(np.array([[19.0, 0, H / 2], [0, 19.0, H / 2],
                                  [0, 0, 1]], np.float32), (B, 3, 3))
    return {
        "x": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "z": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "logsnr": np.stack([np.full(B, 20.0), rng.uniform(-20, 20, B)],
                           1).astype(np.float32),
        "R": R, "t": rng.normal(0, 1.5, (B, 2, 3)).astype(np.float32),
        "K": np.array(K),
    }


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_remat_model_matches_the_jax_package():
    """The tiny X-UNet (``test_config``, dropout 0, f32) with remat under
    "dots": the JAX package's jitted forward and ``jax.grad`` of
    mean(out^2) against the port's in ``train()`` mode, where its blocks
    are rematerialised; the port's weights carried from the Flax tree."""
    jcfg = dataclasses.replace(jconfig.test_config().model, remat=True,
                               remat_policy="dots")
    pcfg = dataclasses.replace(pconfig.test_config().model, remat=True,
                               remat_policy="dots")
    batch = _batch(2, 16, seed=3)
    mask = np.array([True, False])
    shapes = jax.eval_shape(lambda: JXUNet(jcfg).init(
        jax.random.PRNGKey(0), batch, cond_mask=mask))["params"]
    rng = np.random.default_rng(5)
    flat = {k: (0.08 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in sorted(flatten_dict(shapes, sep="/").items())}
    params = unflatten_dict(flat, sep="/")

    def loss(p):
        out = JXUNet(jcfg).apply({"params": p}, batch, cond_mask=mask)
        return jnp.mean(out ** 2), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = convert_params(jax.tree.map(np.array, grads),
                          build_model(pcfg, device="cpu"))

    model = build_model(pcfg, device="cpu").train()
    load_flax_params(model, flat)
    out = model({k: torch.from_numpy(v) for k, v in batch.items()},
                torch.from_numpy(mask))
    torch.mean(out ** 2).backward()
    assert _rel_l2(out.detach().numpy(), ref) <= 1e-4
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    num = sum(float(np.sum((got[k] - want[k].numpy()) ** 2)) for k in got)
    den = sum(float(np.sum(want[k].numpy() ** 2)) for k in got)
    assert (num / den) ** 0.5 <= 1e-4
    for k in got:
        assert _rel_l2(got[k], want[k].numpy()) <= 1e-3 or \
            np.abs(want[k].numpy()).max() < 1e-6, k


def _port_step(policy, remat=True, dropout=0.1, seed=7):
    """One loss and backward of the tiny X-UNet with dropout, from one
    generator seed: ``(loss, grads, generator state after, conv calls in
    the backward)``."""
    cfg = dataclasses.replace(pconfig.test_config().model, dropout=dropout,
                              remat=remat, remat_policy=policy)
    model = build_model(cfg, device="cpu", seed=0,
                        randomize_zero_init=True).train()
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 16, 11).items()}
    gen = torch.Generator().manual_seed(seed)
    out = model(batch, torch.tensor([True, False]), generator=gen)
    loss = torch.mean(out ** 2)
    convs = []

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                convs.append(1)
            return func(*args, **(kwargs or {}))

    with Count():
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, grads, gen.get_state(), len(convs)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_is_bit_identical_to_no_remat(policy):
    """Dropout 0.1 from one generator seed: loss, every gradient and the
    generator's state after the step equal a run without remat bit for
    bit.  Under "nothing" the backward recomputes the blocks' forward
    convolutions; under "dots" it keeps them, so it runs no more
    convolutions than a run without remat."""
    loss0, grads0, state0, convs0 = _port_step(policy, remat=False)
    loss, grads, state, convs = _port_step(policy)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert torch.equal(state, state0)
    if policy == "nothing":
        assert convs > convs0
    else:
        assert convs == convs0


def test_remat_without_the_mask_carry_draws_other_masks(monkeypatch):
    """With the dropout masks no longer drawn before the block and carried
    into the recompute, the recompute draws new masks from the generator
    and the gradients differ: the bit-identity test above can fail."""
    loss0, grads0, state0, _ = _port_step("nothing", remat=False)
    monkeypatch.setattr(xunet, "_draw_dropout", lambda *a: (None, None))
    loss, grads, state, _ = _port_step("nothing")
    assert torch.equal(loss, loss0)            # the forward is the same
    assert not all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert not torch.equal(state, state0)      # the recompute drew again


def test_dropout_mask_bits_round_trip():
    keep = torch.rand(2, 3, 5, 8, generator=torch.Generator().manual_seed(
        0)) < 0.9
    bits = xunet._pack_bits(keep)
    assert bits.dtype == torch.uint8 and bits.numel() == keep.numel() // 8
    assert torch.equal(xunet._unpack_bits(bits, keep.shape), keep)
    odd = keep[..., :7]
    assert xunet._pack_bits(odd) is odd


def test_remat_is_off_in_eval_and_without_autograd():
    """The sampler's path (``eval()``, no autograd) runs the blocks as
    they are: no checkpoint, the same bits as a model without remat."""
    cfg = dataclasses.replace(pconfig.test_config().model, remat=True)
    calls = []
    real = xunet.remat_call

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 16, 12).items()}
    mask = torch.tensor([True, False])
    on = build_model(cfg, device="cpu", randomize_zero_init=True)
    off = build_model(dataclasses.replace(cfg, remat=False), device="cpu",
                      randomize_zero_init=True)
    xunet.remat_call = spy
    try:
        with torch.inference_mode():
            a = on(batch, mask)
        with torch.no_grad():
            on.train()(batch, mask)
    finally:
        xunet.remat_call = real
    with torch.inference_mode():
        b = off(batch, mask)
    assert not calls
    assert torch.equal(a, b)


def test_train_cli_remat_dots_and_synthetic_scenes(tmp_path):
    """``--remat --remat_policy dots`` builds a trainer whose model
    rematerialises under "dots"; with ``--synthetic_scenes`` it takes two
    steps on the CPU and writes a checkpoint."""
    args = train_cli.build_parser().parse_args(
        ["--device", "cpu", "--config", "test", "--synthetic_scenes",
         "--scene_objects", "4", "--steps", "2", "--num_workers", "0",
         "--remat", "--remat_policy", "dots", "--workdir", str(tmp_path)])
    trainer = train_cli.build_trainer(args)
    try:
        cfg = trainer.state.model.cfg
        assert cfg.remat and cfg.remat_policy == "dots"
        trainer.train()
    finally:
        trainer.loader.close()
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert (tmp_path / "checkpoints" / "ckpt_2.pt").exists()
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--synthetic",
                        "--synthetic_scenes"])


def test_remat_train_step_leaves_no_garbage():
    """``torch.utils.checkpoint``'s frames leave reference cycles that
    hold a microbatch's activations until Python collects them; the train
    step collects them after each rematerialised microbatch (and a CUDA
    graph capture before it starts), so no activation outlives its
    step."""
    import gc

    from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset
    from diff3d_tpu_torch.train import create_train_state, make_train_step

    cfg = pconfig.test_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=True, dropout=0.1),
        train=dataclasses.replace(cfg.train, accum_steps=2))
    state = create_train_state(build_model(cfg.model, "cpu").train(),
                               cfg.train)
    step = make_train_step(cfg)
    loader = InfiniteLoader(SyntheticDataset(num_objects=4, num_views=6,
                                             imgsize=16), 8, num_workers=0)
    batch = {k: torch.from_numpy(v) for k, v in loader.batch(0).items()}
    step(state, batch)
    gc.collect()
    gc.disable()
    try:
        step(state, batch)
        assert gc.collect() == 0
    finally:
        gc.enable()
