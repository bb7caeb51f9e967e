"""The port's model (``diff3d_tpu_torch/models``) against the JAX
package's Flax modules, with every Flax leaf randomised (zero-initialised
convs included: zeros would hide a carry fault) and carried by
``diff3d_tpu_torch/convert/from_jax.py``.  The JAX side runs
``kernels="xla"`` in float32, the port its plain versions on the CPU.

Tolerances, float32: blocks 1e-5 (the pose embeddings 1e-5 of their own
scale) and the whole X-UNet 1e-4 — the same arithmetic in another
summation order, chained through ~40 layers in the whole model.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.models import conditioning as jcond  # noqa: E402
from diff3d_tpu.models import layers as jlayers  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.convert import convert_params, load_flax_params  # noqa: E402
from diff3d_tpu_torch.models import XUNet, build_model  # noqa: E402
from diff3d_tpu_torch.models import conditioning as tcond  # noqa: E402
from diff3d_tpu_torch.models import layers as tlayers  # noqa: E402


from _torch_port_threads import one_thread  # noqa: E402,F401


def random_flax_params(module: nn.Module, *args, seed=0, scale=0.3,
                       **kwargs):
    """``{'a/b/c': float32 array}`` with ``module``'s parameter shapes,
    every leaf drawn from a seeded normal."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, **kwargs))["params"]
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in sorted(flatten_dict(shapes, sep="/").items())}


def flax_apply(module, flat, *args, **kwargs):
    params = unflatten_dict(flat, sep="/")
    return np.asarray(jax.jit(lambda p, *a: module.apply(
        {"params": p}, *a, **kwargs))(params, *args))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("cin,resample", [(16, None), (32, "down"),
                                          (32, "up")])
def test_resnet_block_with_film_matches_flax(cin, resample):
    """GN->SiLU->conv->GN->FiLM->conv (+ skip projection when channels
    change), /sqrt(2), average-pool / nearest resampling."""
    B, F, H, W, C, E = 2, 2, 8, 8, 32, 24
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, F, H, W, cin)).astype(np.float32)
    emb = rng.standard_normal((B, F, H, W, E)).astype(np.float32)
    jm = jlayers.ResnetBlock(C, 0.0, resample=resample, kernels="xla")
    flat = random_flax_params(jm, x, emb, True)
    ref = flax_apply(jm, flat, x, emb, True)
    pm = tlayers.ResnetBlock(cin, C, E, resample=resample)
    load_flax_params(pm, flat)
    with torch.no_grad():
        out = pm(t(x.reshape(B * F, H, W, cin)),
                 t(emb.reshape(B * F, H, W, E))).numpy()
    np.testing.assert_allclose(out.reshape(ref.shape), ref, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("attn_type", ["self", "cross"])
def test_attn_block_matches_flax(attn_type):
    """Trap: cross attention rolls the frames by -1 and both frames share
    one AttnLayer (``layers.py:247-258``)."""
    B, F, H, W, C = 2, 2, 4, 4, 32
    x = np.random.default_rng(2).standard_normal(
        (B, F, H, W, C)).astype(np.float32)
    jm = jlayers.AttnBlock(attn_type, num_heads=4, attn_impl="xla",
                           kernels="xla")
    flat = random_flax_params(jm, x)
    ref = flax_apply(jm, flat, x)
    pm = tlayers.AttnBlock(attn_type, C, num_heads=4)
    load_flax_params(pm, flat)
    with torch.no_grad():
        out = pm(t(x.reshape(B * F, H, W, C)), F).numpy()
        swapped = pm(t(x[:, ::-1].reshape(B * F, H, W, C)), F).numpy()
    np.testing.assert_allclose(out.reshape(ref.shape), ref, atol=1e-5,
                               rtol=1e-5)
    # Swapping the frames swaps the outputs (one shared layer per frame).
    np.testing.assert_allclose(
        swapped.reshape(ref.shape)[:, ::-1], ref, atol=1e-5, rtol=1e-5)


def test_resampling_matches_flax():
    x = np.random.default_rng(3).standard_normal(
        (2, 2, 4, 6, 5)).astype(np.float32)
    up = np.asarray(jlayers.nearest_neighbor_upsample(jnp.asarray(x)))
    down = np.asarray(jlayers.avgpool_downsample(jnp.asarray(x)))
    tx = t(x.reshape(4, 4, 6, 5))
    np.testing.assert_array_equal(
        tlayers.nearest_neighbor_upsample(tx).numpy().reshape(up.shape), up)
    np.testing.assert_allclose(
        tlayers.avgpool_downsample(tx).numpy().reshape(down.shape), down,
        atol=1e-6)


def _batch(B, H, seed=4):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(B, 2, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    K = np.broadcast_to(np.array([[19.0, 0, H / 2], [0, 19.0, H / 2],
                                  [0, 0, 1]], np.float32), (B, 3, 3))
    return {
        "x": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "z": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "logsnr": np.stack([np.full(B, 20.0), rng.uniform(-25, 25, B)],
                           1).astype(np.float32),
        "R": R, "t": rng.normal(0, 1.5, (B, 2, 3)).astype(np.float32),
        "K": np.array(K),
    }


def test_conditioning_processor_matches_flax():
    """Trap: the level convs pad 1 at stride 2^i, not SAME
    (``conditioning.py:119-125``); logsnr is clipped to +-20.  The pose
    embeddings sum 3*3*144 products per output, so they are held to
    1e-5 of their own scale."""
    B, H, E, levels = 2, 16, 32, 4
    batch = _batch(B, H)
    mask = np.array([True, False])
    jm = jcond.ConditioningProcessor(emb_ch=E, H=H, W=H,
                                     num_resolutions=levels)
    flat = random_flax_params(jm, batch, mask)
    params = unflatten_dict(flat, sep="/")
    ref_emb, ref_pose = jax.jit(lambda p, b, m: jm.apply(
        {"params": p}, b, m))(params, batch, mask)
    pm = tcond.ConditioningProcessor(E, H, H, levels)
    load_flax_params(pm, flat)
    tb = {k: t(v) for k, v in batch.items()}
    with torch.no_grad():
        emb, pose = pm(tb, torch.from_numpy(mask))
        cam = tcond.pinhole_rays_cam(tb["K"][:, None], H, H)
        _, pose_hoisted = pm(dict(tb, cam_dirs=cam), torch.from_numpy(mask))
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb), atol=1e-5,
                               rtol=1e-5)
    assert len(pose) == levels
    for i in range(levels):
        r = np.asarray(ref_pose[i])
        assert r.shape == (B, 2, H >> i, H >> i, E)
        np.testing.assert_allclose(pose[i].numpy().reshape(r.shape), r,
                                   atol=1e-5 * (1 + np.abs(r).max()),
                                   rtol=0)
        assert torch.equal(pose[i], pose_hoisted[i])


def _xunet_flat(cfg, batch, mask):
    return random_flax_params(JXUNet(cfg), batch, cond_mask=mask, seed=5,
                              scale=0.08)


def test_whole_xunet_matches_flax():
    """The full 4-level X-UNet at ``test_config()``, f32, <= 1e-4.  Traps
    covered end to end: the up path concatenates ``[h, skip]``, the head
    keeps frame 1, residuals divide by sqrt(2)."""
    jcfg = jax_tiny_config(imgsize=16, ch=8).model
    pcfg = port_tiny_config(imgsize=16, ch=8).model
    batch = _batch(2, 16, seed=6)
    mask = np.array([True, False])
    flat = _xunet_flat(jcfg, batch, mask)
    jm = JXUNet(jcfg)
    ref = flax_apply(jm, flat, batch, cond_mask=mask)
    pm = build_model(pcfg, device="cpu")
    load_flax_params(pm, flat)
    with torch.no_grad():
        out = pm({k: t(v) for k, v in batch.items()},
                 torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_converter_is_total():
    """Every Flax leaf is consumed once and every port parameter set once;
    a missing, extra or misshapen leaf raises and names the key."""
    jcfg = jax_tiny_config(imgsize=8, ch=8).model
    batch = _batch(1, 8)
    flat = random_flax_params(JXUNet(jcfg), batch,
                              cond_mask=np.array([True]))
    pm = XUNet(port_tiny_config(imgsize=8, ch=8).model)
    sd = convert_params(flat, pm)
    assert set(sd) == set(pm.state_dict()) and len(sd) == len(flat)
    conv = "down_0_0/resnetblock/conv1/kernel"
    np.testing.assert_array_equal(
        sd["down_0_0.resnetblock.conv1.weight"].numpy(),
        flat[conv].transpose(3, 2, 0, 1))
    gn = "up_1_0/resnetblock/FrameGroupNorm_1/GroupNorm_0/scale"
    np.testing.assert_array_equal(
        sd["up_1_0.resnetblock.FrameGroupNorm_1.weight"].numpy(), flat[gn])
    dense = "middle/attnblock_cross/attn/q_proj/kernel"
    np.testing.assert_array_equal(
        sd["middle.attnblock_cross.attn.q_proj.weight"].numpy(),
        flat[dense].T)

    missing = dict(flat)
    del missing[conv]
    with pytest.raises(KeyError, match="down_0_0.resnetblock.conv1.weight"):
        convert_params(missing, pm)
    extra = dict(flat, **{"down_0_0/resnetblock/conv9/kernel":
                          flat[conv]})
    with pytest.raises(KeyError, match="conv9"):
        convert_params(extra, pm)
    bad = dict(flat, **{conv: flat[conv][..., :1]})
    with pytest.raises(ValueError, match="shape"):
        convert_params(bad, pm)
    unknown = dict(flat, **{"stem_conv/mystery": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="mystery"):
        convert_params(unknown, pm)


def test_set_kernels_routes_every_site():
    """``set_kernels`` flips every GroupNorm and attention site; on CPU
    tensors both routes are the plain versions, so outputs are equal."""
    model = build_model(port_tiny_config(imgsize=8, ch=8).model,
                        device="cpu", seed=1, randomize_zero_init=True)
    batch = {k: t(v) for k, v in _batch(2, 8, seed=2).items()}
    mask = torch.tensor([True, False])
    sites = [m for m in model.modules()
             if isinstance(m, (tlayers.FrameGroupNorm, tlayers.AttnLayer))]
    assert sites and all(m.kernels == "cuda" for m in sites)
    with torch.no_grad():
        out = model(batch, mask)
        tlayers.set_kernels(model, "torch")
        assert all(m.kernels == "torch" for m in sites)
        assert torch.equal(model(batch, mask), out)
    with pytest.raises(ValueError):
        tlayers.set_kernels(model, "pallas")
