"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without CUDA; the file
imports neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_port_cuda.py

Tolerances, as in ``chip_smoke.py``: f32 1e-5 and bf16 one bf16 ulp
(2^-7), each relative to 1 + the output's largest magnitude (the kernel
and the plain version compute in f32 and round once, summing in other
orders).  Backward outputs that are sums over a whole axis (dgamma /
dbeta over N*L, dq / dk / dv over L*D products with the cancelling
``dP - delta`` factor) are held to 1e-4 in f32.
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
SUM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _close(out, ref, dtype, tol=TOL):
    mag = float(ref.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol[dtype] * (1 + mag), (err, mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film,silu", [(False, False), (False, True),
                                       (True, False), (True, True)])
@pytest.mark.parametrize("shape", [(4, 300, 256, 32), (2, 1000, 144, 24),
                                   (32, 64, 1024, 32),
                                   # group counts above 1024 (G <= C)
                                   (2, 64, 2048, 2048), (1, 16, 4096, 4096)])
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


def _gn_forward_inputs(cuda, N, L, C, dtype, pad=0):
    """x, gamma, beta and the FiLM halves; x and the halves are views
    ``pad`` elements into their buffers (``pad`` 2: not 16-byte aligned,
    so the kernel takes element loads)."""
    gen = torch.Generator(cuda).manual_seed(5)

    def buf(*s):
        return torch.randn(*s[:-1], s[-1] + pad, generator=gen,
                           device=cuda).to(dtype)[..., pad:]

    x = buf(N, L, C).add_(0.5)                    # in place: keeps the view
    e = buf(N, L, 2 * C).mul_(0.3)
    gamma = 1 + 0.2 * torch.randn(C, generator=gen, device=cuda)
    beta = 0.2 * torch.randn(C, generator=gen, device=cuda)
    return x, gamma, beta, e[..., :C], e[..., C:]


def _check_gn_forward(got, x, gamma, beta, scale, shift, G, silu, dtype,
                      save_stats):
    out, stats = got if save_stats else (got, None)
    kw = dict(scale=scale, shift=shift) if scale is not None else {}
    assert out.dtype == dtype and out.is_contiguous()
    _close(out, cuda_film.groupnorm_reference(x, gamma, beta, num_groups=G,
                                              silu=silu, **kw), dtype)
    if save_stats:
        assert stats.shape == (2, x.shape[0], G)
        _close(stats, cuda_film.groupnorm_stats_reference(x, G),
               torch.float32)


@pytest.mark.parametrize("save_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film,silu", [(False, False), (False, True),
                                       (True, False), (True, True)])
@pytest.mark.parametrize("plan", [(1, 300, False), (2, 150, True),
                                  (4, 75, True), (4, 75, False),
                                  (8, 38, True), (8, 64, True),
                                  (16, 19, True), (16, 19, False)])
def test_groupnorm_forward_plans_agree(cuda, plan, film, silu, dtype,
                                       save_stats):
    """Every cluster size and both ways of taking x (kept in shared memory
    or re-read from L2) give the plain version's output and statistics;
    (8, 64) leaves three of the eight CTAs without rows, (8, 38) gives the
    last CTA fewer rows than the others."""
    x, gamma, beta, sc, sh = _gn_forward_inputs(cuda, 3, 300, 256, dtype)
    sc, sh = (sc, sh) if film else (None, None)
    got = cuda_film.launch(cuda_film.build.library("film"), x, gamma, beta,
                           sc, sh, num_groups=32, silu=silu, stream=None,
                           save_stats=save_stats, plan=plan)
    _check_gn_forward(got, x, gamma, beta, sc, sh, 32, silu, dtype,
                      save_stats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_forward_takes_unaligned_views(cuda, dtype):
    """x and the FiLM halves 2 elements into their buffers: not 16-byte
    aligned, so the kernel takes element loads; one launch per call."""
    x, gamma, beta, sc, sh = _gn_forward_inputs(cuda, 2, 1000, 128, dtype,
                                                pad=2)
    assert x.data_ptr() % 16 != 0 and sc.data_ptr() % 16 != 0
    for silu in (False, True):
        before = cuda_film.fused_groupnorm.launches
        out = cuda_film.fused_groupnorm(x, gamma, beta, num_groups=32,
                                        scale=sc, shift=sh, silu=silu)
        assert cuda_film.fused_groupnorm.launches == before + 1
        _check_gn_forward(out, x, gamma, beta, sc, sh, 32, silu, dtype,
                          False)


@pytest.mark.parametrize("shape", [(8, 4096, 128, 32), (8, 64, 512, 32),
                                   (1, 16, 4096, 4096)])
def test_groupnorm_forward_is_bit_identical_run_to_run(cuda, shape):
    """The cluster kernel's rank-ordered exchange uses no float atomics:
    two launches give the same output and statistics bit for bit."""
    N, L, C, G = shape
    x, gamma, beta, sc, sh = _gn_forward_inputs(cuda, N, L, C,
                                                torch.bfloat16)
    runs = [cuda_film.launch(cuda_film.build.library("film"), x, gamma,
                             beta, sc, sh, num_groups=G, silu=True,
                             stream=None, save_stats=True)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("N", [32, 256])
def test_groupnorm_forward_plans_fit_the_card(cuda, N, film):
    """``forward_plan`` at the srn64 sites (N = 32 sampler frames, 256
    train frames) picks plans whose clusters the card can hold
    (``cudaOccupancyMaxActiveClusters`` > 0), in both dtypes."""
    lib = cuda_film.build.library("film")
    for L, C in [(4096, 128), (4096, 256), (4096, 384), (1024, 256),
                 (1024, 512), (256, 256), (256, 768), (64, 512),
                 (64, 1024)]:
        for dtype in (torch.bfloat16, torch.float32):
            plan = cuda_film.forward_plan(N, L, C, 32, dtype.itemsize, film)
            assert cuda_film.max_active_clusters(
                lib, L, C, 32, plan, dtype, film, True) > 0, (L, C, plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 100, 70, 4, 64), (1, 256, 256, 2, 256),
                                   (2, 64, 64, 3, 160), (1, 33, 200, 1, 8),
                                   # tile edges (64 rows, 64 / 32 keys),
                                   # Lq != Lk, rows of 72 bytes (D = 36)
                                   (2, 63, 65, 2, 64), (1, 129, 127, 2, 128),
                                   (2, 65, 63, 3, 36), (1, 127, 129, 1, 256),
                                   # 256 < D <= 512: the CUDA-core kernels
                                   (2, 40, 33, 2, 320), (1, 33, 70, 2, 512)])
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


# srn64 training sites at a 2-example microbatch (N = 4), odd shapes, and
# the cluster kernel's edges: L not a multiple of the cluster (4095 rows
# over 16 CTAs), N = 1, C = 4096 at G = 32 and G = 2048.
GN_BWD_SHAPES = [(4, 4096, 128, 32), (4, 256, 512, 32), (4, 64, 1024, 32),
                 (2, 1000, 144, 24), (3, 7, 96, 32), (2, 4095, 128, 32),
                 (1, 4096, 128, 32), (2, 40, 4096, 32), (1, 9, 4096, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film,silu", [(False, False), (False, True),
                                       (True, False), (True, True)])
@pytest.mark.parametrize("shape", GN_BWD_SHAPES)
def test_groupnorm_backward_matches_plain(cuda, shape, film, silu, dtype):
    N, L, C, G = shape
    rng = np.random.default_rng(3)

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=cuda)

    x = t(rng.standard_normal((N, L, C)))
    gamma = t(1 + 0.2 * rng.standard_normal(C), torch.float32)
    beta = t(0.2 * rng.standard_normal(C), torch.float32)
    scale = shift = None
    if film:           # the two halves of one Dense output: strided views
        e = t(0.3 * rng.standard_normal((N, L, 2 * C)))
        scale, shift = e[..., :C], e[..., C:]
    g = t(rng.standard_normal((N, L, C)))
    out, stats = cuda_film.launch(
        cuda_film.build.library("film"), x, gamma, beta, scale, shift,
        num_groups=G, silu=silu, stream=None, save_stats=True)
    _close(stats, cuda_film.groupnorm_stats_reference(x, G), torch.float32)
    before = cuda_film.groupnorm_backward.launches
    got = cuda_film.groupnorm_backward(x, g, gamma, beta, scale, shift, stats,
                                       num_groups=G, silu=silu)
    assert cuda_film.groupnorm_backward.launches == before + 1
    want = cuda_film.groupnorm_backward_reference(
        x, g, gamma, beta, scale, shift, stats, num_groups=G, silu=silu)
    for name, a, b in zip(("dx", "dscale", "dshift", "dgamma", "dbeta"),
                          got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _close(a, b, dtype if name not in ("dgamma", "dbeta")
               else torch.float32, SUM_TOL if name in ("dgamma", "dbeta")
               else TOL)


def _gn_backward_inputs(cuda, N, L, C, G, dtype, pad=0):
    """x, g, gamma, beta, scale, shift and the forward's statistics; x, g
    and the FiLM halves are views ``pad`` elements into their buffers
    (``pad`` 2: 4-byte aligned in bf16, 8-byte in f32, so not for the
    kernel's 16-byte loads: element loads)."""
    gen = torch.Generator(cuda).manual_seed(9)

    def buf(*s):
        return torch.randn(*s[:-1], s[-1] + pad, generator=gen,
                           device=cuda).to(dtype)[..., pad:]

    x, g = buf(N, L, C), buf(N, L, C)
    e = buf(N, L, 2 * C).mul_(0.3)                # in place: keeps the view
    gamma = 1 + 0.2 * torch.randn(C, generator=gen, device=cuda)
    beta = 0.2 * torch.randn(C, generator=gen, device=cuda)
    stats = cuda_film.groupnorm_stats_reference(x, G).contiguous()
    return x, g, gamma, beta, e[..., :C], e[..., C:], stats


def _check_gn_backward(got, want, dtype):
    for name, a, b in zip(("dx", "dscale", "dshift", "dgamma", "dbeta"),
                          got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in ("dgamma", "dbeta"):
            _close(a, b, torch.float32, SUM_TOL)
        else:
            _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", [(1, 300, False), (4, 75, True),
                                  (4, 75, False), (16, 19, True),
                                  (16, 19, False), (8, 64, True)])
def test_groupnorm_backward_plans_agree(cuda, plan, dtype):
    """Every cluster size and both ways of taking x and g (kept in shared
    memory or re-read) give the plain version's result; (8, 64) leaves
    three of the eight CTAs without rows.  (One CTA cannot keep all 300
    rows: 300 x 256 x 2 tensors do not fit its shared memory.)"""
    x, g, gamma, beta, sc, sh, stats = _gn_backward_inputs(
        cuda, 3, 300, 256, 32, dtype)
    got = cuda_film.launch_backward(
        cuda_film.build.library("film"), x, g, gamma, beta, sc, sh, stats,
        num_groups=32, silu=True, stream=None, plan=plan)
    want = cuda_film.groupnorm_backward_reference(
        x, g, gamma, beta, sc, sh, stats, num_groups=32, silu=True)
    _check_gn_backward(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_backward_takes_unaligned_views(cuda, dtype):
    """x, g and the FiLM halves 2 elements into their buffers: not 16-byte
    aligned, so the kernel takes element loads."""
    x, g, gamma, beta, sc, sh, stats = _gn_backward_inputs(
        cuda, 2, 1000, 128, 32, dtype, pad=2)
    assert x.data_ptr() % 16 != 0
    got = cuda_film.groupnorm_backward(x, g, gamma, beta, sc, sh, stats,
                                       num_groups=32, silu=True)
    want = cuda_film.groupnorm_backward_reference(
        x, g, gamma, beta, sc, sh, stats, num_groups=32, silu=True)
    _check_gn_backward(got, want, dtype)


@pytest.mark.parametrize("shape", [(8, 4096, 128, 32), (8, 64, 512, 32)])
def test_groupnorm_backward_is_bit_identical_run_to_run(cuda, shape):
    """The cluster kernel's rank-ordered exchange and the fixed-order
    dgamma / dbeta fold use no float atomics: two launches agree bit for
    bit."""
    x, g, gamma, beta, sc, sh, stats = _gn_backward_inputs(
        cuda, *shape, torch.bfloat16)
    runs = [cuda_film.groupnorm_backward(x, g, gamma, beta, sc, sh, stats,
                                         num_groups=shape[3], silu=True)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# srn64 training sites (2-example microbatch: B = 4), srn128's, odd shapes.
ATTN_BWD_SHAPES = [(4, 256, 256, 4, 64), (4, 64, 64, 4, 128),
                   (2, 1024, 1024, 4, 128), (2, 256, 256, 4, 256),
                   (2, 100, 70, 2, 64), (1, 33, 200, 1, 8),
                   (2, 64, 64, 3, 160), (2, 63, 65, 2, 64),
                   (1, 129, 127, 2, 128), (2, 65, 63, 3, 36),
                   (1, 127, 129, 1, 256),
                   # 256 < D <= 512: the CUDA-core kernels in both dtypes
                   (1, 40, 33, 2, 320), (1, 33, 70, 1, 512)]


@pytest.mark.parametrize("glse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_BWD_SHAPES)
def test_attention_lse_and_backward_match_plain(cuda, shape, dtype, glse):
    B, Lq, Lk, H, D = shape
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn(B, L, H * D, generator=g, device=cuda).to(dtype)
               .view(B, L, H, D) for L in (Lq, Lk, Lk))
    with torch.no_grad():
        o, lse = cuda_attention.flash_attention_lse(q, k, v)
    o_ref, lse_ref = cuda_attention.attention_lse_reference(q, k, v)
    _close(o, o_ref, dtype)
    assert lse.shape == (B, Lq, H) and lse.dtype == torch.float32
    _close(lse, lse_ref.transpose(1, 2), torch.float32)
    lse = lse.transpose(1, 2).contiguous()                  # [B, H, Lq]
    do = torch.randn(B, Lq, H, D, generator=g, device=cuda).to(dtype)
    gl = (torch.randn(B, H, Lq, generator=g, device=cuda) if glse
          else None)
    before = (cuda_attention.attention_backward_dkdv.launches,
              cuda_attention.attention_backward_dq.launches)
    got = cuda_attention.attention_backward(q, k, v, o, lse, do, gl)
    assert (cuda_attention.attention_backward_dkdv.launches,
            cuda_attention.attention_backward_dq.launches) == (
                before[0] + 1, before[1] + 1)
    want = cuda_attention.attention_backward_reference(q, k, v, o, lse, do,
                                                       gl)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype and a.is_contiguous()
        _close(a, b, dtype, SUM_TOL)


def _bf16_attention_inputs(cuda, shape, pad=0):
    """bf16 q, k, v, dO as [B, L, H, D] views of [B, L, H*D + pad]
    buffers starting ``pad`` elements in (``pad`` 4: 8-byte aligned)."""
    B, Lq, Lk, H, D = shape
    g = torch.Generator(cuda).manual_seed(5)
    return [torch.randn(B, L, H * D + pad, generator=g, device=cuda)
            .to(torch.bfloat16)[..., pad:].unflatten(-1, (H, D))
            for L in (Lq, Lk, Lk, Lq)]


@pytest.mark.parametrize("shape", [(2, 256, 256, 4, 64), (2, 64, 64, 4, 128),
                                   (1, 100, 70, 2, 256)])
def test_bf16_attention_kernels_are_bit_identical_run_to_run(cuda, shape):
    """The tensor-core forward (with lse), dK/dV and dQ kernels use no
    float atomics: two launches on the same inputs agree bit for bit."""
    q, k, v, do = _bf16_attention_inputs(cuda, shape)
    with torch.no_grad():
        runs = [cuda_attention.flash_attention_lse(q, k, v) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    lse = runs[0][1].transpose(1, 2).contiguous()
    grads = [cuda_attention.attention_backward_dkdv(q, k, v, runs[0][0], lse,
                                                    do) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    dqs = [cuda_attention.attention_backward_dq(q, k, v, runs[0][0], lse, do,
                                                grads[0][2])
           for _ in range(2)]
    assert torch.equal(*dqs)


@pytest.mark.parametrize("shape", [(2, 100, 70, 2, 64), (1, 65, 129, 2, 128)])
def test_bf16_attention_kernels_take_unaligned_views(cuda, shape):
    """Views whose base is 8-byte but not 16-byte aligned take the kernels'
    element-by-element loads (no 16-byte cp.async) and still match."""
    q, k, v, do = _bf16_attention_inputs(cuda, shape, pad=4)
    assert q.data_ptr() % 16 != 0
    with torch.no_grad():
        o, lse = cuda_attention.flash_attention_lse(q, k, v)
    o_ref, lse_ref = cuda_attention.attention_lse_reference(q, k, v)
    _close(o, o_ref, torch.bfloat16)
    _close(lse, lse_ref.transpose(1, 2), torch.float32)
    lse = lse.transpose(1, 2).contiguous()
    dk, dv, delta = cuda_attention.attention_backward_dkdv(q, k, v, o, lse,
                                                           do)
    dq = cuda_attention.attention_backward_dq(q, k, v, o, lse, do, delta)
    want = cuda_attention.attention_backward_reference(q, k, v, o, lse, do)
    _close(dq, want[0], torch.bfloat16, SUM_TOL)
    _close(dk, want[1], torch.bfloat16, SUM_TOL)
    _close(dv, want[2], torch.bfloat16, SUM_TOL)


def test_unsupported_operands_raise(cuda):
    x = torch.zeros(2, 8, 64, device=cuda)
    one, zero = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        cuda_film.fused_groupnorm(x, one, zero, num_groups=24)
    with pytest.raises(ValueError):
        cuda_film.fused_groupnorm(x.half(), one, zero, num_groups=32)
    q = torch.zeros(1, 8, 1, 640, device=cuda)       # D > 512
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


def test_inference_takes_no_residuals(cuda):
    """Under inference_mode the forwards take the Pallas primal's path:
    no autograd node, no statistics / lse."""
    x = torch.randn(2, 64, 64, device=cuda, requires_grad=True)
    one, zero = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    q = torch.randn(2, 64, 2, 32, device=cuda, requires_grad=True)
    with torch.inference_mode():
        assert cuda_film.fused_groupnorm(x, one, zero,
                                         num_groups=32).grad_fn is None
        assert cuda_attention.flash_attention(q, q, q).grad_fn is None
    assert cuda_film.fused_groupnorm(x, one, zero,
                                     num_groups=32).grad_fn is not None
    assert cuda_attention.flash_attention(q, q, q).grad_fn is not None


def _tiny_training_inputs(cuda):
    """The tiny X-UNet's config and one seeded batch, cond mask and
    regression target at 16^2, on the card."""
    cfg = port_tiny_config(imgsize=16, ch=32).model
    rng = np.random.default_rng(4)
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
    mask = torch.tensor([True, True, False, True], device=cuda)
    target = torch.tensor(rng.standard_normal((B, 16, 16, 3)),
                          dtype=torch.float32, device=cuda)
    return cfg, batch, mask, target


def _loss_and_grads(model, batch, mask, target):
    """The l2 loss of one forward and every parameter's gradient (f32
    copies), with cuDNN's TF32 off so f32 convolutions are f32."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model.zero_grad(set_to_none=True)
        loss = ((model(batch, mask).float() - target) ** 2).mean()
        loss.backward()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return float(loss), [None if p.grad is None else p.grad.float().clone()
                         for p in model.parameters()]


def _rel_l2(got, want):
    """Relative L2 distance over all parameter gradients together."""
    num = sum(float((a - b).norm() ** 2) for a, b in zip(got, want))
    return (num / sum(float(b.norm() ** 2) for b in want)) ** 0.5


def _backward_launches():
    return (cuda_film.groupnorm_backward.launches,
            cuda_attention.attention_backward_dkdv.launches,
            cuda_attention.attention_backward_dq.launches)


def test_model_gradients_kernel_path_match_plain_path(cuda):
    """The gradients of the tiny X-UNet through the kernels (every
    GroupNorm and attention site's backward a kernel) against the plain
    path.  In f32 with TF32 off, so the two paths differ only in summation
    order: relative L2 over all parameter gradients <= 1e-4, loss 1e-5.  A
    kernel output cut from the graph would leave the parameters upstream
    of it without gradient, an O(1) error.  (bf16: the next test.)"""
    cfg, batch, mask, target = _tiny_training_inputs(cuda)
    model = build_model(cfg, cuda, seed=0, randomize_zero_init=True).train()
    before = _backward_launches()
    loss, got = _loss_and_grads(model, batch, mask, target)
    assert all(a > b for a, b in zip(_backward_launches(), before))
    set_kernels(model, "torch")
    loss_ref, want = _loss_and_grads(model, batch, mask, target)
    assert all(g is not None for g in got)
    assert _rel_l2(got, want) <= 1e-4, _rel_l2(got, want)
    assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref)


def test_model_gradients_bf16_kernel_path_within_bf16_noise(cuda):
    """The same tiny X-UNet in bf16: kernel path, plain path, and the f32
    plain path from the same weights.  At this width bf16 rounding alone
    moves the gradients by ~14% (the bf16 plain path's own distance from
    f32, ``noise``: 0.138 on an H100), so the kernel path is held to 0.1
    relative L2 from the plain path (read: 0.068) and to no farther from
    f32 than 1.25 x noise (read: 1.0 x).  Prints the three distances."""
    import dataclasses
    import json

    cfg, batch, mask, target = _tiny_training_inputs(cuda)
    m32 = build_model(cfg, cuda, seed=0, randomize_zero_init=True).train()
    m16 = build_model(dataclasses.replace(cfg, dtype="bfloat16"), cuda,
                      seed=0, randomize_zero_init=True).train()
    m16.load_state_dict(m32.state_dict())
    set_kernels(m32, "torch")
    _, g32 = _loss_and_grads(m32, batch, mask, target)
    before = _backward_launches()
    loss_k, gk = _loss_and_grads(m16, batch, mask, target)
    assert all(a > b for a, b in zip(_backward_launches(), before))
    set_kernels(m16, "torch")
    loss_p, gp = _loss_and_grads(m16, batch, mask, target)
    dist = {"kernel_vs_plain": _rel_l2(gk, gp), "noise": _rel_l2(gp, g32),
            "kernel_vs_f32": _rel_l2(gk, g32),
            "loss_rel": abs(loss_k - loss_p) / abs(loss_p)}
    print(json.dumps({"bf16_tiny_grad_distances": dist}))
    assert dist["kernel_vs_plain"] <= 0.1, dist
    assert dist["kernel_vs_f32"] <= 1.25 * dist["noise"], dist
    assert dist["loss_rel"] <= 1e-2, dist
