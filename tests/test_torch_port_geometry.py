"""The port's geometry (``diff3d_tpu_torch/geometry``) against the JAX
package's: positional encodings and the two pinhole-ray stages.  Inputs are
made with numpy from a seed and go through both frameworks.

Tolerances: the rays are float32 products of a 3x3 inverse and a 3-term
sum (1e-6).  The encodings take sines of float32 arguments up to ~2e4
(DDPM, x1000 scaling) and 2^15 (NeRF degree 15); both frameworks form the
same argument bits, and the sines then agree to an ulp of the result, so
they are held to 1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu import geometry as jgeo  # noqa: E402
from diff3d_tpu_torch import geometry as tgeo  # noqa: E402


def _K(B):
    K = np.array([[65.625, 0, 32.0], [0, 65.625, 32.0], [0, 0, 1]],
                 np.float32)
    rng = np.random.default_rng(0)
    Ks = np.broadcast_to(K, (B, 3, 3)).copy()
    Ks[:, :2, 2] += rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    return Ks


def _poses(B, F, seed=1):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(B, F, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    t = rng.normal(0, 1.5, (B, F, 3)).astype(np.float32)
    return R, t


@pytest.mark.parametrize("emb_ch,max_time", [(32, 1.0), (1024, 1.0),
                                             (64, 1000.0)])
def test_posenc_ddpm_matches_jax(emb_ch, max_time):
    x = np.random.default_rng(2).uniform(-20, 20, (3, 2)).astype(
        np.float32)
    ref = np.asarray(jgeo.posenc_ddpm(jnp.asarray(x), emb_ch,
                                      max_time=max_time))
    out = tgeo.posenc_ddpm(torch.from_numpy(x), emb_ch,
                           max_time=max_time).numpy()
    assert out.shape == ref.shape == (3, 2, emb_ch)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("min_deg,max_deg", [(0, 15), (0, 8), (3, 3)])
def test_posenc_nerf_matches_jax(min_deg, max_deg):
    x = np.random.default_rng(3).uniform(-1.5, 1.5, (2, 4, 5, 3)).astype(
        np.float32)
    ref = np.asarray(jgeo.posenc_nerf(jnp.asarray(x), min_deg, max_deg))
    out = tgeo.posenc_nerf(torch.from_numpy(x), min_deg, max_deg).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # The input passes through unchanged in the first channels.
    np.testing.assert_array_equal(out[..., :3], x)


def test_pinhole_rays_cam_matches_jax():
    K = _K(3)[:, None]                                  # [B, 1, 3, 3]
    ref = np.asarray(jgeo.pinhole_rays_cam(jnp.asarray(K), 8, 12))
    out = tgeo.pinhole_rays_cam(torch.from_numpy(K), 8, 12).numpy()
    assert out.shape == ref.shape == (3, 1, 8, 12, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
def test_pinhole_rays_world_matches_jax(normalize):
    B, F, H, W = 3, 2, 8, 12
    R, t = _poses(B, F)
    dir_cam = np.array(jgeo.pinhole_rays_cam(jnp.asarray(_K(B)[:, None]),
                                              H, W))
    pos_r, dir_r = jgeo.pinhole_rays_world(jnp.asarray(R), jnp.asarray(t),
                                           jnp.asarray(dir_cam),
                                           normalize=normalize)
    pos, dirs = tgeo.pinhole_rays_world(torch.from_numpy(R),
                                        torch.from_numpy(t),
                                        torch.from_numpy(dir_cam),
                                        normalize=normalize)
    assert pos.shape == dirs.shape == (B, F, H, W, 3)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_r))
    np.testing.assert_allclose(dirs.numpy(), np.asarray(dir_r), rtol=1e-6,
                               atol=1e-6)


def test_pinhole_rays_is_the_two_stages_composed():
    B, F, H, W = 2, 2, 6, 6
    R, t = _poses(B, F, seed=4)
    K = torch.from_numpy(_K(B)[:, None])
    pos, dirs = tgeo.pinhole_rays(torch.from_numpy(R), torch.from_numpy(t),
                                  K, H, W)
    pos2, dirs2 = tgeo.pinhole_rays_world(
        torch.from_numpy(R), torch.from_numpy(t),
        tgeo.pinhole_rays_cam(K, H, W))
    assert torch.equal(pos, pos2) and torch.equal(dirs, dirs2)
    ref_pos, ref_dir = jgeo.pinhole_rays(jnp.asarray(R), jnp.asarray(t),
                                         jnp.asarray(K.numpy()), H, W)
    np.testing.assert_allclose(dirs.numpy(), np.asarray(ref_dir), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
