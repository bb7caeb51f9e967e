"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without CUDA; the file
imports neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_port_cuda.py

Tolerances, as in ``chip_smoke.py``: f32 1e-5 and bf16 one bf16 ulp
(2^-7), each relative to 1 + the output's largest magnitude (the kernel
and the plain version compute in f32 and round once, summing in other
orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.models import build_model  # noqa: E402
from diff3d_tpu_torch.models.layers import set_kernels  # noqa: E402
from diff3d_tpu_torch.ops import cuda_attention, cuda_film  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _close(out, ref, dtype):
    mag = float(ref.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[dtype] * (1 + mag), (err, mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film,silu", [(False, False), (False, True),
                                       (True, False), (True, True)])
@pytest.mark.parametrize("shape", [(4, 300, 256, 32), (2, 1000, 144, 24),
                                   (32, 64, 1024, 32)])
def test_fused_groupnorm_matches_plain(cuda, shape, film, silu, dtype):
    N, L, C, G = shape
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((N, L, C)), dtype=dtype,
                     device=cuda)
    gamma = torch.tensor(rng.standard_normal(C), dtype=torch.float32,
                         device=cuda)
    beta = torch.tensor(rng.standard_normal(C), dtype=torch.float32,
                        device=cuda)
    kw = dict(num_groups=G, silu=silu)
    if film:           # the two halves of one Dense output: strided views
        e = torch.tensor(0.3 * rng.standard_normal((N, L, 2 * C)),
                         dtype=dtype, device=cuda)
        kw.update(scale=e[..., :C], shift=e[..., C:])
    before = cuda_film.fused_groupnorm.launches
    out = cuda_film.fused_groupnorm(x, gamma, beta, **kw)
    assert cuda_film.fused_groupnorm.launches == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    _close(out, cuda_film.groupnorm_reference(x, gamma, beta, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 100, 70, 4, 64), (1, 256, 256, 2, 256),
                                   (2, 64, 64, 3, 160), (1, 33, 200, 1, 8)])
def test_flash_attention_matches_plain(cuda, shape, dtype):
    B, Lq, Lk, H, D = shape
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(B, L, H * D, generator=g, device=cuda).to(dtype)
               .view(B, L, H, D) for L in (Lq, Lk, Lk))
    before = cuda_attention.flash_attention.launches
    out = cuda_attention.flash_attention(q, k, v)
    assert cuda_attention.flash_attention.launches == before + 1
    assert out.shape == (B, Lq, H, D)
    _close(out, cuda_attention.attention_reference(q, k, v), dtype)


def test_unsupported_operands_raise(cuda):
    x = torch.zeros(2, 8, 64, device=cuda)
    one, zero = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        cuda_film.fused_groupnorm(x, one, zero, num_groups=24)
    with pytest.raises(ValueError):
        cuda_film.fused_groupnorm(x.half(), one, zero, num_groups=32)
    q = torch.zeros(1, 8, 1, 320, device=cuda)
    with pytest.raises(ValueError):
        cuda_attention.flash_attention(q, q, q)


def test_model_kernel_path_matches_plain_path(cuda):
    """The tiny X-UNet in bf16 on the card: the kernel path against the
    plain path (``set_kernels(model, "torch")``), relative L2 3e-2 as in
    chip_smoke."""
    import dataclasses

    cfg = port_tiny_config(imgsize=16, ch=32).model
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = build_model(cfg, cuda, seed=0, randomize_zero_init=True)
    rng = np.random.default_rng(2)
    B = 4
    batch = {
        "x": rng.uniform(-1, 1, (B, 16, 16, 3)),
        "z": rng.standard_normal((B, 16, 16, 3)),
        "logsnr": np.stack([np.full(B, 20.0), rng.uniform(-20, 20, B)], 1),
        "R": np.broadcast_to(np.eye(3), (B, 2, 3, 3)),
        "t": rng.normal(0, 1.3, (B, 2, 3)),
        "K": np.broadcast_to(np.array([[19.0, 0, 8], [0, 19.0, 8],
                                       [0, 0, 1]]), (B, 3, 3)),
    }
    batch = {k: torch.tensor(np.array(v), dtype=torch.float32, device=cuda)
             for k, v in batch.items()}
    mask = torch.tensor([True, True, False, False], device=cuda)
    with torch.inference_mode():
        before = (cuda_film.fused_groupnorm.launches,
                  cuda_attention.flash_attention.launches)
        out = model(batch, mask)
        assert cuda_film.fused_groupnorm.launches > before[0]
        assert cuda_attention.flash_attention.launches > before[1]
        set_kernels(model, "torch")
        ref = model(batch, mask)
    assert torch.isfinite(out).all()
    assert float((out - ref).norm() / ref.norm()) <= 3e-2
