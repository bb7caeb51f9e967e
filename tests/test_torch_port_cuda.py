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


# --- the sampler's reverse step and the train step as CUDA graphs ----------


def _tiny_bf16(cuda, model_kw=None, **train_kw):
    """The tiny X-UNet's config in bf16 (as srn64 computes) with model and
    train overrides, and its model from seed 0 on the card."""
    import dataclasses

    cfg = port_tiny_config(imgsize=16, ch=32)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16",
                                       **(model_kw or {})),
        train=dataclasses.replace(cfg.train, **train_kw))
    return cfg, build_model(cfg.model, cuda, seed=0,
                            randomize_zero_init=True)


def _orbit_object(n_views, seed, H=16):
    """``n_views`` cameras on a circle looking at the origin, a K, and
    smooth random images."""
    rng = np.random.default_rng(seed)
    Rs, Ts = [], []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views + seed
        pos = np.array([1.3 * np.cos(a), 1.3 * np.sin(a), 0.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        Rs.append(np.stack([right, np.cross(fwd, right), fwd], axis=1))
        Ts.append(pos)
    imgs = np.repeat(np.repeat(rng.uniform(-1, 1, (n_views, H // 4, H // 4,
                                                   3)), 4, 1), 4, 2)
    K = np.array([[H * 1.1, 0, H / 2], [0, H * 1.1, H / 2], [0, 0, 1]])
    return {"imgs": imgs.astype(np.float32),
            "R": np.stack(Rs).astype(np.float32),
            "T": np.stack(Ts).astype(np.float32),
            "K": K.astype(np.float32)}


def test_sampler_graph_is_bit_identical_to_eager(cuda):
    """``synthesize`` (one object, two segments per view) and
    ``synthesize_many`` (two objects) with the reverse step replayed as a
    CUDA graph against the eager step, from generators with the same
    seeds: bit for bit.  The graphs hold both kernels and were
    replayed."""
    from diff3d_tpu_torch.graphs import graph_launches
    from diff3d_tpu_torch.sampling import Sampler

    cfg, model = _tiny_bf16(cuda)
    views = [_orbit_object(3, 1), _orbit_object(3, 2)]
    runs = {}
    for graphs in (False, True):
        s = Sampler(model, cfg, device=cuda, scan_chunks=2,
                    cuda_graphs=graphs)
        one = s.synthesize(views[0], torch.Generator(cuda).manual_seed(3))
        many = s.synthesize_many(views, [torch.Generator(cuda).manual_seed(4),
                                         torch.Generator(cuda).manual_seed(5)])
        runs[graphs] = (one, many, s)
    assert np.isfinite(runs[True][0]).all()
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(runs[True][1], runs[False][1])
    s = runs[True][2]
    assert s.cuda_graphs and not runs[False][2].graphs
    assert sorted(k[0] for k in s.graphs) == [1, 2]     # N = 1 and N = 2
    steps = s.model_calls_per_view
    for g in s.graphs.values():                # 2 views, 1 eager warm-up
        assert g.replays == 2 * steps - 1
        assert g.captured["fused_groupnorm"] > 0
        assert g.captured["flash_attention"] > 0
    ran = graph_launches(s.graphs.values())
    assert ran["fused_groupnorm"] == sum(
        g.captured["fused_groupnorm"] * g.replays for g in s.graphs.values())


def _train_run(cuda, cfg, graphs, steps):
    """``steps`` train steps of the tiny bf16 model from seed 0 on seeded
    synthetic batches: the metrics, the final tensors, and the step."""
    from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset
    from diff3d_tpu_torch.train import create_train_state, make_train_step

    model = build_model(cfg.model, cuda, seed=0, randomize_zero_init=True)
    state = create_train_state(model.train(), cfg.train)
    step = make_train_step(cfg, cuda_graphs=graphs)
    loader = InfiniteLoader(SyntheticDataset(num_objects=4, num_views=6,
                                             imgsize=16),
                            cfg.train.global_batch, num_workers=0)
    metrics = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).to(cuda)
                 for k, v in loader.batch(s).items()}
        m = step(state, batch)
        metrics.append((m["loss"].clone(), m["grad_norm"].clone(), m["lr"]))
    tensors = {f"p.{k}": v.detach().clone()
               for k, v in state.model.named_parameters()}
    tensors.update({f"ema.{k}": v.clone() for k, v in state.ema.items()})
    for i, st in enumerate(state.optimizer.state.values()):
        tensors.update({f"adam.{i}.{k}": v.clone() for k, v in st.items()})
    return metrics, tensors, step


@pytest.mark.parametrize("accum", [1, 2])
def test_train_graph_is_bit_identical_to_eager(cuda, accum):
    """Four steps of the tiny bf16 model as CUDA graphs (the first eager,
    then micro x accum and update replayed) against four eager steps from
    the same state and (seed, step) generators: losses, gradient norms,
    parameters, Adam's state and the EMA bit for bit (cuDNN
    deterministic, as ``train_cli`` sets it)."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, _ = _tiny_bf16(cuda, global_batch=8, accum_steps=accum,
                            lr=0.01, warmup_examples=16,
                            grad_clip=0.05 if accum == 2 else 0.0)
        got, got_t, step = _train_run(cuda, cfg, True, 4)
        want, want_t, eager = _train_run(cuda, cfg, False, 4)
    finally:
        torch.backends.cudnn.deterministic = det
    assert eager.graphs is None
    micro, update = step.graphs
    assert micro.replays == 3 * accum and update.replays == 3
    for name in ("fused_groupnorm", "groupnorm_backward", "flash_attention",
                 "attention_backward_dkdv", "attention_backward_dq"):
        assert micro.captured[name] > 0, name
    for (la, ga, lra), (lb, gb, lrb) in zip(got, want):
        assert torch.equal(la, lb) and torch.equal(ga, gb) and lra == lrb
    assert got_t.keys() == want_t.keys()
    differ = [k for k in got_t if not torch.equal(got_t[k], want_t[k])]
    assert not differ, differ[:5]


def test_graph_trainer_resume_is_bit_exact(cuda, tmp_path):
    """A Trainer on the graph path checkpoints at step 2; a fresh Trainer
    restores it (its step runs eagerly, then recaptures) and takes step
    3, which equals the first Trainer's replayed step 3 bit for bit."""
    from diff3d_tpu_torch.data import (InfiniteLoader, SyntheticDataset,
                                       prefetch_to_device)
    from diff3d_tpu_torch.train import Trainer

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, _ = _tiny_bf16(cuda, global_batch=8, warmup_examples=16,
                            max_steps=3, ckpt_every=2)
        ds = SyntheticDataset(num_objects=4, num_views=6, imgsize=16)

        def trainer(transfer):
            t = Trainer(cfg, workdir=str(tmp_path), transfer=transfer,
                        device=cuda)
            t.loader = prefetch_to_device(
                InfiniteLoader(ds, 8, num_workers=0,
                               start_step=t.state.step), cuda)
            return t

        first = trainer(False)
        first.train(max_steps=2)
        second = trainer(True)
        assert second.state.step == 2
        first.train()
        second.train()
        first.loader.close()
        second.loader.close()
    finally:
        torch.backends.cudnn.deterministic = det
    assert first.step_fn.graphs is not None
    assert second.step_fn.graphs is not None
    a = dict(first.state.model.state_dict())
    b = dict(second.state.model.state_dict())
    a.update({f"ema.{k}": v for k, v in first.state.ema.items()})
    b.update({f"ema.{k}": v for k, v in second.state.ema.items()})
    assert not [k for k in a if not torch.equal(a[k], b[k])]


def _bit_identical_runs(cuda, runs):
    """``runs()`` with cuDNN's deterministic algorithms, as ``train_cli``
    sets them."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return runs()
    finally:
        torch.backends.cudnn.deterministic = det


def _assert_same_run(got, want):
    (got_m, got_t), (want_m, want_t) = got, want
    for (la, ga, lra), (lb, gb, lrb) in zip(got_m, want_m):
        assert torch.equal(la, lb) and torch.equal(ga, gb) and lra == lrb
    assert got_t.keys() == want_t.keys()
    differ = [k for k in got_t if not torch.equal(got_t[k], want_t[k])]
    assert not differ, differ[:5]


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("accum", [1, 2])
def test_remat_train_graph_is_bit_identical_to_eager(cuda, policy, accum):
    """The tiny bf16 model with every block rematerialised and dropout
    0.1: four steps as CUDA graphs (the recompute, with its generator
    replay, inside the captured backward) against four eager steps, bit
    for bit.  The captured micro graph launches more forward kernels than
    the same model's without remat: one more forward per block."""
    remat = dict(remat=True, remat_policy=policy, dropout=0.1)
    kw = dict(global_batch=8, accum_steps=accum, lr=0.01,
              warmup_examples=16)
    cfg, _ = _tiny_bf16(cuda, model_kw=remat, **kw)
    plain_cfg, _ = _tiny_bf16(cuda, model_kw=dict(dropout=0.1), **kw)

    def runs():
        return (_train_run(cuda, cfg, True, 4),
                _train_run(cuda, cfg, False, 4),
                _train_run(cuda, plain_cfg, True, 2))

    (gm, gt, step), (em, et, _), (_, _, plain) = _bit_identical_runs(
        cuda, runs)
    _assert_same_run((gm, gt), (em, et))
    micro = step.graphs[0]
    assert micro.replays == 3 * accum
    for name in ("fused_groupnorm", "flash_attention"):
        assert micro.captured[name] > plain.graphs[0].captured[name], name
    for name in ("groupnorm_backward", "attention_backward_dkdv",
                 "attention_backward_dq"):
        assert micro.captured[name] == plain.graphs[0].captured[name], name


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_matches_no_remat_on_card(cuda, policy):
    """Three eager steps of the tiny bf16 model with dropout 0.1, remat on
    against remat off, from the same seeds: losses, gradient norms,
    parameters, Adam's state and the EMA bit for bit."""
    kw = dict(global_batch=8, accum_steps=2, lr=0.01, warmup_examples=16)
    on, _ = _tiny_bf16(cuda, model_kw=dict(remat=True, remat_policy=policy,
                                           dropout=0.1), **kw)
    off, _ = _tiny_bf16(cuda, model_kw=dict(dropout=0.1), **kw)
    got, want = _bit_identical_runs(cuda, lambda: (
        _train_run(cuda, on, False, 3), _train_run(cuda, off, False, 3)))
    _assert_same_run(got[:2], want[:2])


def _srn128_sites():
    """Every GroupNorm site ``(L, C, G, film, silu)`` and attention site
    ``(L, heads, D)`` of the srn128 X-UNet, from a forward on the meta
    device (no memory, no kernels)."""
    from diff3d_tpu_torch.config import srn128_config
    from diff3d_tpu_torch.models.layers import AttnLayer, FrameGroupNorm
    from diff3d_tpu_torch.models.xunet import XUNet

    cfg = srn128_config().model
    with torch.device("meta"):
        model = XUNet(cfg).eval()
    B, H = 1, cfg.H
    shapes = dict(x=(B, H, H, 3), z=(B, H, H, 3), logsnr=(B, 2),
                  R=(B, 2, 3, 3), t=(B, 2, 3), K=(B, 3, 3))
    batch = {k: torch.zeros(v, device="meta") for k, v in shapes.items()}
    gn, attn = set(), set()

    def gn_hook(mod, args, kwargs, out):
        _, h, w, C = args[0].shape
        film = len(args) > 1 or kwargs.get("scale") is not None
        gn.add((h * w, C, mod.num_groups, film, mod.silu))

    def attn_hook(mod, args, out):
        q, _ = args
        attn.add((q.shape[1], mod.num_heads, q.shape[2] // mod.num_heads))

    for m in model.modules():
        if isinstance(m, FrameGroupNorm):
            m.register_forward_hook(gn_hook, with_kwargs=True)
        elif isinstance(m, AttnLayer):
            m.register_forward_hook(attn_hook)
    with torch.no_grad():
        model(batch, torch.zeros(B, dtype=torch.bool, device="meta"))
    return sorted(gn), sorted(attn)


SRN128_N = (32, 64)     # the sampler step's GroupNorm N; a train microbatch's


def test_srn128_groupnorm_sites_match_plain(cuda):
    """At every srn128 GroupNorm site, in bf16, with the sampler step's N
    and a training microbatch's: the forward (with ``save_stats``) and
    the backward kernels against their plain versions, and the sites'
    cluster plans fit the card."""
    from diff3d_tpu_torch.ops import build

    gn_sites, _ = _srn128_sites()
    assert len(gn_sites) >= 15
    lib = build.library("film")
    dt = torch.bfloat16
    for N in SRN128_N:
        for si, (L, C, G, film, silu) in enumerate(gn_sites):
            g = torch.Generator(cuda).manual_seed(si)
            x = torch.randn(N, L, C, generator=g, device=cuda).to(dt)
            gamma = 1 + 0.1 * torch.randn(C, generator=g, device=cuda)
            beta = 0.1 * torch.randn(C, generator=g, device=cuda)
            kw = dict(num_groups=G, silu=silu)
            sc = sh = None
            if film:
                e = (0.3 * torch.randn(N, L, 2 * C, generator=g,
                                       device=cuda)).to(dt)
                sc, sh = e[..., :C], e[..., C:]
                kw.update(scale=sc, shift=sh)
            plan = cuda_film.forward_plan(N, L, C, G, 2, film)
            assert cuda_film.max_active_clusters(
                lib, L, C, G, plan, dt, film, silu) > 0, (N, L, C, plan)
            ref_stats = cuda_film.groupnorm_stats_reference(x, G)
            _close(cuda_film.fused_groupnorm(x, gamma, beta, **kw),
                   cuda_film.groupnorm_reference(x, gamma, beta, **kw), dt)
            out, stats = cuda_film.launch(lib, x, gamma, beta, sc, sh,
                                          num_groups=G, silu=silu,
                                          stream=None, save_stats=True)
            _close(out, cuda_film.groupnorm_reference(
                x, gamma, beta, stats=ref_stats, **kw), dt)
            _close(stats, ref_stats, torch.float32)
            dy = torch.randn(N, L, C, generator=g, device=cuda).to(dt)
            args = (x, dy, gamma, beta, sc, sh, stats)
            got = cuda_film.groupnorm_backward(*args, num_groups=G,
                                               silu=silu)
            want = cuda_film.groupnorm_backward_reference(
                *args, num_groups=G, silu=silu)
            for name, a, b in zip(("dx", "dscale", "dshift", "dgamma",
                                   "dbeta"), got, want):
                if b is None:
                    continue
                if name in ("dgamma", "dbeta"):
                    _close(a, b, torch.float32, SUM_TOL)
                else:
                    _close(a, b, dt)
            del x, dy, out, got, want


def test_srn128_attention_sites_match_plain(cuda):
    """At every srn128 attention site (L 1024 at D 128, L 256 at D 256)
    with the sampler step's batch-heads (2B x 2 frames) and a training
    microbatch's, in bf16: the forward, the lse forward and the backward
    kernels against their plain versions."""
    _, attn_sites = _srn128_sites()
    assert attn_sites == [(256, 4, 256), (1024, 4, 128)]
    dt = torch.bfloat16
    for N in SRN128_N:
        for si, (L, H, D) in enumerate(attn_sites):
            g = torch.Generator(cuda).manual_seed(10 + si)
            q, k, v = (torch.randn(N, L, H, D, generator=g,
                                   device=cuda).to(dt) for _ in range(3))
            _close(cuda_attention.flash_attention(q, k, v),
                   cuda_attention.attention_reference(q, k, v), dt)
            o, lse = cuda_attention.flash_attention_lse(q, k, v)
            o_ref, lse_ref = cuda_attention.attention_lse_reference(q, k, v)
            _close(o, o_ref, dt)
            _close(lse, lse_ref.transpose(1, 2), torch.float32)
            do = torch.randn(N, L, H, D, generator=g, device=cuda).to(dt)
            lse_bhl = lse.transpose(1, 2).contiguous()
            dk, dv, delta = cuda_attention.attention_backward_dkdv(
                q, k, v, o, lse_bhl, do)
            dq = cuda_attention.attention_backward_dq(q, k, v, o, lse_bhl,
                                                      do, delta)
            want = cuda_attention.attention_backward_reference(
                q, k, v, o, lse_bhl, do)
            for a, b in zip((dq, dk, dv), want):
                _close(a, b, dt)


# ---- distillation and sliced checkpoints on the card ----------------------


def _distill_batches(cuda, B, H=16, start=0):
    from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset

    loader = InfiniteLoader(SyntheticDataset(num_objects=4, num_views=6,
                                             imgsize=H), B, num_workers=0)
    s = start
    while True:
        yield {k: torch.from_numpy(v).to(cuda)
               for k, v in loader.batch(s).items()}
        s += 1


def _distill_run(cuda, cfg, teacher, graphs):
    """Two rounds (k = 2, 1) of 2 steps of the tiny bf16 model: per-step
    metrics, the returned EMA, and the step."""
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import distill, make_distill_step

    inner = make_distill_step(cfg, cuda_graphs=graphs)
    metrics = []

    def step(state, t, batch, k):
        m = inner(state, t, batch, k)
        metrics.append((m["distill_loss"].clone(), m["grad_norm"].clone(),
                        m["lr"]))
        return m

    final, _ = distill(XUNet(cfg.model).to(cuda), cfg, teacher,
                       _distill_batches(cuda, cfg.train.global_batch),
                       start_steps=4, final_steps=1, round_steps=2,
                       log_every=0, step_fn=step)
    return metrics, final, inner


def test_distill_graph_is_bit_identical_to_eager(cuda):
    """``distill`` with one CUDA graph for every round (the first step
    eager, then captured; round 2 replays it with k = 1 and the state
    reset in place) against the eager step: losses, gradient norms and the
    final EMA bit for bit.  The graph holds all five kernels."""
    cfg, model = _tiny_bf16(cuda, global_batch=4, lr=0.01,
                            warmup_examples=8, grad_clip=0.5)
    teacher = {k: v.detach().clone() for k, v in model.named_parameters()}
    (gm, gf, step), (em, ef, eager) = _bit_identical_runs(
        cuda, lambda: (_distill_run(cuda, cfg, teacher, True),
                       _distill_run(cuda, cfg, teacher, False)))
    assert eager.graph is None and step.graph.replays == 3
    for name in ("fused_groupnorm", "groupnorm_backward", "flash_attention",
                 "attention_backward_dkdv", "attention_backward_dq"):
        assert step.graph.captured[name] > 0, name
    for (la, ga, lra), (lb, gb, lrb) in zip(gm, em):
        assert torch.equal(la, lb) and torch.equal(ga, gb) and lra == lrb
    assert all(torch.isfinite(m[0]) for m in gm)
    assert not [k for k in gf if not torch.equal(gf[k], ef[k])]
    assert any(not torch.equal(gf[k], teacher[k]) for k in teacher)


def test_distill_loss_kernel_path_matches_plain_path(cuda):
    """One distill step of the tiny model in f32 (TF32 off), student and
    teacher through the kernels and through the plain versions, the same
    draws: the loss within 1e-5 relative, the gradients within 1e-4
    relative L2 (summation order only), with samples at i = k, where x^ is
    eps^'s error scaled by 1/alpha_t ~ 2e4."""
    import dataclasses

    from diff3d_tpu_torch.train import (DistillDraws, create_train_state,
                                        make_distill_step)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = port_tiny_config(imgsize=16, ch=32)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch=8))
    batch = next(_distill_batches(cuda, 8))
    out = {}
    try:
        for impl in ("cuda", "torch"):
            student = build_model(cfg.model, cuda, seed=0,
                                  randomize_zero_init=True)
            teacher = build_model(cfg.model, cuda, seed=1,
                                  randomize_zero_init=True)
            teacher.requires_grad_(False)
            set_kernels(student, impl)
            set_kernels(teacher, impl)
            state = create_train_state(student, cfg.train)
            m = make_distill_step(cfg)(
                state, teacher, batch, 2,
                draws=DistillDraws(torch.Generator(cuda).manual_seed(3)))
            out[impl] = (float(m["distill_loss"]),
                         [p.grad.detach().clone()
                          for p in student.parameters()])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    u = torch.rand(8, generator=torch.Generator(cuda).manual_seed(3),
                   device=cuda)
    assert bool((torch.floor(u * 2) + 1 == 2).any())
    (lk, gk), (lp, gp) = out["cuda"], out["torch"]
    assert abs(lk - lp) <= 1e-5 * abs(lp), (lk, lp)
    assert _rel_l2(gk, gp) <= 1e-4, _rel_l2(gk, gp)


def test_full_sliced_async_round_trip_of_card_tensors(cuda, tmp_path):
    """A state on the card after two graph-path train steps, saved
    ``full_sliced`` with the asynchronous writer, restored into a fresh
    state on the card: every tensor (capturable Adam's step counters on
    the card too) bit for bit, in place, and the next step of both is the
    same (cuDNN deterministic, as ``train_cli`` sets it)."""
    _bit_identical_runs(cuda, lambda: _sliced_round_trip(cuda, tmp_path))


def _sliced_round_trip(cuda, tmp_path):
    from diff3d_tpu_torch.train import (CheckpointManager,
                                        create_train_state, make_train_step)
    from diff3d_tpu_torch.train.checkpoint import state_leaves

    cfg, model = _tiny_bf16(cuda, global_batch=8, lr=0.01,
                            warmup_examples=16)
    batches = _distill_batches(cuda, 8)
    step = make_train_step(cfg, cuda_graphs=True)
    state = create_train_state(model.train(), cfg.train)
    for _ in range(2):
        step(state, next(batches))
    mgr = CheckpointManager(str(tmp_path), mode="full_sliced",
                            async_writes=True)
    assert mgr.save(state)
    mgr.wait_until_finished()
    mgr.close()
    fresh = create_train_state(
        build_model(cfg.model, cuda, seed=5).train(), cfg.train)
    make_train_step(cfg)(fresh, next(_distill_batches(cuda, 8, start=7)))
    ptrs = [t.data_ptr() for _, t in state_leaves(fresh)]
    assert CheckpointManager(str(tmp_path)).restore(fresh) == 2
    assert [t.data_ptr() for _, t in state_leaves(fresh)] == ptrs
    a, b = dict(state_leaves(state)), dict(state_leaves(fresh))
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].device == a[k].device and torch.equal(a[k], b[k]), k
    batch = next(batches)
    m1 = step(state, batch)
    m2 = make_train_step(cfg, cuda_graphs=True)(fresh, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])


# ---- the single-engine service on the card --------------------------------


def _served(svc, payloads, timeout=300.0):
    """Submit ``payloads`` before the engine starts (so they run as one
    batch), start it, and return their results."""
    reqs = [svc.submit(p) for p in payloads]
    svc.start(serve_http=False)
    return [r.result(timeout=timeout) for r in reqs]


def _serving_setup(cuda, **serving):
    import dataclasses

    from diff3d_tpu_torch.config import ServingConfig
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.serving import ServingService

    cfg, model = _tiny_bf16(cuda)
    cfg = dataclasses.replace(cfg, serving=ServingConfig(
        port=0, max_batch=4, max_wait_ms=0.0, **serving))
    svc = ServingService(Sampler(model, cfg, device=cuda), cfg)
    return cfg, model, svc


def _serving_payload(seed, n_views=3):
    v = _orbit_object(n_views, seed)
    return {"views": {k: a.tolist() for k, a in v.items()}, "seed": seed,
            "n_views": n_views}


def test_served_views_are_synthesize_many_over_the_same_lanes(cuda):
    """Three requests served as 4 lanes (one padding lane) on the graph
    path: each bit for bit ``synthesize_many`` over the three objects
    plus a fourth repeating object 0 under another seed; the served
    graph holds both kernels and was replayed."""
    cfg, model, svc = _serving_setup(cuda)
    seeds = (0, 1, 2)
    try:
        outs = _served(svc, [_serving_payload(s) for s in seeds])
    finally:
        svc.stop()
    sampler = svc.engine.sampler
    views = [_orbit_object(3, s) for s in seeds]
    ref = sampler.synthesize_many(
        views + [views[0]],
        [torch.Generator(cuda).manual_seed(s) for s in (0, 1, 2, 77)])
    for n in range(3):
        assert np.isfinite(outs[n]).all()
        np.testing.assert_array_equal(outs[n], ref[n])
    (graph,) = sampler.graphs.values()
    assert graph.replays > 0 and graph.captured["fused_groupnorm"] > 0
    assert graph.captured["flash_attention"] > 0
    stats = svc.engine.programs.stats(include_memory=True)
    (prog,) = stats["programs"].values()
    assert prog["peak_bytes"] > 0 and prog["argument_bytes"] > 0


def test_served_swap_copies_in_place_without_a_recapture(cuda):
    """A swap between requests: the same graphs, the parameters at the
    same addresses, other views; swapping back restores the first views
    bit for bit."""
    cfg, model, svc = _serving_setup(cuda)
    p = _serving_payload(3)
    ptrs = {k: t.data_ptr() for k, t in model.named_parameters()}
    orig = {k: t.clone() for k, t in model.state_dict().items()}
    try:
        (base,) = _served(svc, [p])
        graphs = dict(svc.engine.sampler.graphs)
        svc.registry.swap({k: t + 0.05 for k, t in orig.items()}, "v1")
        swapped = svc.submit(p).result(timeout=300.0)
        svc.registry.swap(orig, "v2")
        again = svc.submit(p).result(timeout=300.0)
    finally:
        svc.stop()
    assert not np.array_equal(swapped, base)
    np.testing.assert_array_equal(again, base)
    assert svc.engine.sampler.graphs == graphs
    assert {k: t.data_ptr() for k, t in model.named_parameters()} == ptrs


def test_graphs_share_one_pool_and_replay_out_of_order(cuda):
    """Several (lanes, capacity) keys captured into one memory pool, then
    replayed in another order than their capture, against a sampler that
    gives each graph a pool of its own: bit for bit."""
    from diff3d_tpu_torch.diffusion import Draws
    from diff3d_tpu_torch.sampling import Sampler

    cfg, model = _tiny_bf16(cuda)
    shared = Sampler(model, cfg, device=cuda)
    shared.graph_pool = torch.cuda.graph_pool_handle()
    own = Sampler(model, cfg, device=cuda)
    B = len(cfg.diffusion.guidance_weights)
    keys = [(1, 2), (4, 4), (2, 8), (4, 2)]

    def step(sampler, N, cap, seed):
        rng = np.random.default_rng(seed)
        objs = [_orbit_object(cap, seed + n) for n in range(N)]
        rec = np.zeros((N, cap, B, 16, 16, 3), np.float32)
        rec[:, 0] = rng.uniform(-1, 1, (N, B, 16, 16, 3))

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=cuda)

        out, _, _ = sampler.step_many(
            t(rec), t([o["R"] for o in objs]), t([o["T"] for o in objs]),
            [1] * N, t([o["K"] for o in objs]),
            [Draws(torch.Generator(cuda).manual_seed(seed + n))
             for n in range(N)])
        return out.cpu().numpy()

    order = keys + keys[::-1] + [keys[1], keys[3], keys[0], keys[2]]
    for i, (N, cap) in enumerate(order):
        a = step(shared, N, cap, 10 * i)
        b = step(own, N, cap, 10 * i)
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
    assert len(shared.graphs) == len(keys)
    pools = {g.pool() for g in shared.graphs.values()}
    assert len(pools) == 1
    assert len({g.pool() for g in own.graphs.values()}) == len(keys)


# ---- the fleet and cascades on the card -------------------------------------


def test_fleet_replicas_first_captures_overlap_each_bit_identical(cuda):
    """Two replicas of a fleet, each with two requests queued before
    either engine starts, so both meet their first use (an eager step
    and a capture) at the same time: every replica captures graphs of
    its own into a pool of its own, and each replica's views are bit for
    bit those of a lone service over the same weights and payloads."""
    import copy
    import dataclasses

    from diff3d_tpu_torch.config import ServingConfig
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.serving import FleetService, ServingService
    from diff3d_tpu_torch.serving.server import build_request

    cfg, model = _tiny_bf16(cuda)
    cfg = dataclasses.replace(cfg, serving=ServingConfig(
        port=0, max_batch=2, max_wait_ms=0.0, replicas=2))
    lone_model = copy.deepcopy(model)
    fleet = FleetService.build(Sampler(model, cfg, device=cuda), cfg)
    seeds = {"r0": (0, 1), "r1": (2, 3)}
    reqs = {rep.name: [rep.submit(build_request(_serving_payload(s), cfg))
                       for s in seeds[rep.name]] for rep in fleet.replicas}
    fleet.start(serve_http=False)
    try:
        got = {n: [r.result(timeout=300.0) for r in rs]
               for n, rs in reqs.items()}
    finally:
        fleet.stop()
    graphs = [list(rep.engine.sampler.graphs.values())
              for rep in fleet.replicas]
    assert all(len(g) == 1 and g[0].replays > 0 for g in graphs)
    assert graphs[0][0].pool() != graphs[1][0].pool()
    for name, ss in seeds.items():
        svc = ServingService(Sampler(lone_model, cfg, device=cuda), cfg)
        want = _served(svc, [_serving_payload(s) for s in ss])
        svc.stop()
        for a, b in zip(got[name], want):
            assert np.isfinite(a).all()
            np.testing.assert_array_equal(a, b)


def test_served_cascade_swap_refreshes_the_draft_in_place(cuda):
    """A swap between served cascades: the draft's ``pos_emb`` and every
    weight keep their addresses, no graph is captured again, the views
    change and equal an offline cascade over the swapped weights, and
    swapping back restores the first views bit for bit."""
    import dataclasses

    from diff3d_tpu_torch.cascade import CascadePlan, CascadeSampler
    from diff3d_tpu_torch.config import ServingConfig
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.serving import ServingService

    cfg, model = _tiny_bf16(cuda)
    cfg = dataclasses.replace(cfg, serving=ServingConfig(
        port=0, max_batch=2, max_wait_ms=0.0))
    plan = CascadePlan.parse("draft=8:ddim:2,refine=16:ancestral:4@t0.5")
    casc = CascadeSampler(model, cfg, plan, device=cuda)
    svc = ServingService(Sampler(model, cfg, device=cuda), cfg,
                         cascade=casc).start(serve_http=False)
    payload = _serving_payload(7)

    def ptrs():
        return {(m, k): p.data_ptr() for m, mod in (
            ("draft", casc.draft.model), ("refine", casc.refine.model))
            for k, p in mod.named_parameters()}

    try:
        base = svc.submit_cascade(payload).result(timeout=300.0)
        before, graphs = ptrs(), (dict(casc.draft.graphs),
                                  dict(casc.refine.graphs))
        orig = {k: t.clone() for k, t in model.state_dict().items()}
        svc.registry.swap({k: t + 0.05 for k, t in orig.items()}, "v1")
        swapped = svc.submit_cascade(payload).result(timeout=300.0)
        assert ptrs() == before
        assert (dict(casc.draft.graphs), dict(casc.refine.graphs)) == graphs
        ref_model = build_model(cfg.model, cuda)
        ref_model.load_state_dict({k: t + 0.05 for k, t in orig.items()})
        ref = CascadeSampler(ref_model, cfg, plan, device=cuda)
        want = ref.synthesize_cascade(_orbit_object(3, 7), seed=7)
        np.testing.assert_array_equal(swapped, want["refined"])
        svc.registry.swap(orig, "v2")
        again = svc.submit_cascade(payload).result(timeout=300.0)
    finally:
        svc.stop()
    assert not np.array_equal(swapped, base)
    np.testing.assert_array_equal(again, base)
    assert all(g.replays > 0 for g in graphs[0].values())
    assert all(g.replays > 0 for g in graphs[1].values())


# ---- split statistics (context parallelism) ----------------------------

SPLIT_SHAPES = [(4, 300, 256, 32), (3, 70, 384, 32), (2, 64, 96, 3),
                (2, 40, 1024, 4)]


def _split_inputs(cuda, N, L, C, dtype, pad=0):
    x, gamma, beta, scale, shift = _gn_forward_inputs(cuda, N, L, C, dtype,
                                                      pad)
    gen = torch.Generator(cuda).manual_seed(11)
    g = torch.randn(N, L, C + pad, generator=gen, device=cuda).to(dtype)
    return x, g[..., pad:], gamma, beta, scale, shift


@pytest.mark.parametrize("pad", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film,silu", [(False, False), (False, True),
                                       (True, False), (True, True)])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_groupnorm_entry_points_match_plain(cuda, shape, film, silu,
                                                  dtype, pad):
    """(a)-(d) of the split statistics against their plain versions, on a
    rank holding half the rows of a 2-rank image (the sums passed in are
    this rank's doubled, standing for the other rank's)."""
    N, L, C, G = shape
    x, g, gamma, beta, scale, shift = _split_inputs(cuda, N, L, C, dtype,
                                                    pad)
    if not film:
        scale = shift = None
    f = cuda_film
    counts = {k: getattr(f, k).launches for k in (
        "groupnorm_partial_sums", "groupnorm_apply_sums",
        "groupnorm_backward_partial_sums", "groupnorm_backward_apply_sums")}
    sums = f.groupnorm_partial_sums(x, num_groups=G)
    want = f.groupnorm_partial_sums_reference(x, G)
    assert sums.dtype == torch.float64 and sums.shape == (2, N, G)
    torch.testing.assert_close(sums, want, rtol=1e-12, atol=1e-9)
    total = 2 * sums
    out, stats = f.groupnorm_apply_sums(x, gamma, beta, scale, shift, total,
                                        length=2 * L, num_groups=G,
                                        silu=silu)
    rout, rstats = f.groupnorm_apply_sums_reference(
        x, gamma, beta, scale, shift, total, length=2 * L, num_groups=G,
        silu=silu)
    _close(stats, rstats, torch.float32)
    _close(out, rout, dtype)
    bsums, dgamma, dbeta = f.groupnorm_backward_partial_sums(
        x, g, gamma, beta, scale, shift, stats, num_groups=G, silu=silu)
    rb = f.groupnorm_backward_partial_sums_reference(
        x, g, gamma, beta, scale, shift, stats, num_groups=G, silu=silu)
    for a, b in zip((bsums, dgamma, dbeta), rb):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        _close(a, b, torch.float32, SUM_TOL)
    got = f.groupnorm_backward_apply_sums(
        x, g, gamma, beta, scale, shift, stats, 2 * bsums, length=2 * L,
        num_groups=G, silu=silu)
    ref = f.groupnorm_backward_apply_sums_reference(
        x, g, gamma, beta, scale, shift, stats, 2 * bsums, length=2 * L,
        num_groups=G, silu=silu)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, dtype)
    assert all(getattr(f, k).launches == v + 1 for k, v in counts.items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_groupnorm_halves_equal_the_unsplit_kernel(cuda, dtype):
    """Two row halves through (a), summed, then (b) each: the statistics
    and the output equal the unsplit cluster kernel's on the whole rows
    (statistics bit for bit in f32, the output within one rounding)."""
    N, L, C, G = 4, 512, 256, 32
    x, _, gamma, beta, scale, shift = _split_inputs(cuda, N, L, C, dtype)
    whole, wstats = cuda_film.launch(
        cuda_film.build.library("film"), x, gamma, beta, scale, shift,
        num_groups=G, silu=True, stream=None, save_stats=True)
    halves = [x[:, :L // 2], x[:, L // 2:]]
    sums = sum(cuda_film.groupnorm_partial_sums(h, num_groups=G)
               for h in halves)
    outs = []
    for i, h in enumerate(halves):
        rows = slice(i * L // 2, (i + 1) * L // 2)
        out, stats = cuda_film.groupnorm_apply_sums(
            h, gamma, beta, scale[:, rows], shift[:, rows], sums, length=L,
            num_groups=G, silu=True)
        _close(stats, wstats, torch.float32)
        outs.append(out)
    _close(torch.cat(outs, dim=1), whole, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_groupnorm_is_bit_identical_run_to_run(cuda, dtype):
    N, L, C, G = 16, 2048, 128, 32
    x, g, gamma, beta, scale, shift = _split_inputs(cuda, N, L, C, dtype)
    f = cuda_film

    def run():
        sums = f.groupnorm_partial_sums(x, num_groups=G)
        out, stats = f.groupnorm_apply_sums(x, gamma, beta, scale, shift,
                                            2 * sums, length=2 * L,
                                            num_groups=G, silu=True)
        bs = f.groupnorm_backward_partial_sums(
            x, g, gamma, beta, scale, shift, stats, num_groups=G, silu=True)
        dx = f.groupnorm_backward_apply_sums(
            x, g, gamma, beta, scale, shift, stats, 2 * bs[0], length=2 * L,
            num_groups=G, silu=True)
        return [sums, out, stats, *bs, *dx]

    a, b = run(), run()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_split_groupnorm_refuses_wide_groups(cuda):
    x = torch.zeros(1, 4, 1024, device=cuda)
    with pytest.raises(ValueError):
        cuda_film.groupnorm_partial_sums(x, num_groups=2)


def _op_cases(cuda, dtype):
    """Every dispatcher op (``ops/library.py``) with operands on the card,
    its plain version's outputs on the same operands, and the wrapper
    whose launch count it adds to."""
    f, a = cuda_film, cuda_attention
    N, L, C, G = 4, 300, 256, 32
    x, g, gamma, beta, sc, sh = _split_inputs(cuda, N, L, C, dtype)
    stats = f.groupnorm_stats_reference(x, G)
    sums = f.groupnorm_partial_sums_reference(x, G)
    bsums = f.groupnorm_backward_partial_sums_reference(
        x, g, gamma, beta, sc, sh, stats, num_groups=G, silu=True)[0]
    kw = dict(num_groups=G, silu=True)
    B, Lq, Lk, H, D = 2, 96, 80, 4, 64
    gen = torch.Generator(cuda).manual_seed(12)

    def r(*s):
        return torch.randn(s, generator=gen, device=cuda).to(dtype)

    q, k, v, do = r(B, Lq, H, D), r(B, Lk, H, D), r(B, Lk, H, D), \
        r(B, Lq, H, D)
    s = 0.125
    o, lse = a.attention_lse_reference(q, k, v, s)
    glse = torch.randn((B, H, Lq), generator=gen, device=cuda)
    # The ops take the wrappers' checked operands: [B, H, Lq] rows
    # contiguous.
    delta = a.attention_delta_reference(o, do, glse).contiguous()
    dq, dk, dv = a._backward_reference(q, k, v, lse, do, delta, s)
    gb = f.groupnorm_backward_reference(x, g, gamma, beta, sc, sh, stats,
                                        **kw)
    return {
        "gn_forward": ((x, gamma, beta, sc, sh, G, True),
                       f.groupnorm_reference(x, gamma, beta, scale=sc,
                                             shift=sh, **kw),
                       "fused_groupnorm"),
        "gn_forward_stats": ((x, gamma, beta, None, None, G, False),
                             (f.groupnorm_reference(
                                 x, gamma, beta, num_groups=G, stats=stats),
                              stats), "fused_groupnorm"),
        "gn_backward": ((x, g, gamma, beta, sc, sh, stats, G, True),
                        [gb[0], gb[3], gb[4], gb[1], gb[2]],
                        "groupnorm_backward"),
        "gn_split_sums": ((x, G), sums, "groupnorm_partial_sums"),
        "gn_split_apply": ((x, gamma, beta, sc, sh, sums, L, G, True),
                           f.groupnorm_apply_sums_reference(
                               x, gamma, beta, sc, sh, sums, length=L, **kw),
                           "groupnorm_apply_sums"),
        "gn_split_backward_sums": (
            (x, g, gamma, beta, sc, sh, stats, G, True),
            f.groupnorm_backward_partial_sums_reference(
                x, g, gamma, beta, sc, sh, stats, **kw),
            "groupnorm_backward_partial_sums"),
        "gn_split_backward_apply": (
            (x, g, gamma, beta, sc, sh, stats, bsums, L, G, True),
            f.groupnorm_backward_apply_sums_reference(
                x, g, gamma, beta, sc, sh, stats, bsums, length=L, **kw),
            "groupnorm_backward_apply_sums"),
        "flash_forward": ((q, k, v, s), a.attention_reference(q, k, v, s),
                          "flash_attention"),
        "flash_forward_lse": ((q, k, v, s), (o, lse), "flash_attention"),
        "flash_backward_dkdv": ((q, k, v, o, lse, do, glse, s),
                                (a._rounded(q, dk), a._rounded(q, dv),
                                 delta), "attention_backward_dkdv"),
        "flash_backward_dq": ((q, k, v, o, lse, do, delta, s),
                              a._rounded(q, dq), "attention_backward_dq"),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["gn_forward", "gn_forward_stats",
                                "gn_backward", "gn_split_sums",
                                "gn_split_apply", "gn_split_backward_sums",
                                "gn_split_backward_apply", "flash_forward",
                                "flash_forward_lse", "flash_backward_dkdv",
                                "flash_backward_dq"])
def test_each_op_launches_its_kernel_and_matches_plain(cuda, op, dtype):
    """Each op called through the dispatcher on card tensors: its CUDA
    implementation (the kernel, one launch on its wrapper's count)
    against the plain version (f32 1e-5, bf16 one ulp; sums 1e-4), and
    one node in a trace on fake CUDA tensors."""
    from diff3d_tpu_torch.analysis import ir
    from diff3d_tpu_torch.ops import KERNEL_WRAPPERS, library

    args, want, wrapper = _op_cases(cuda, dtype)[op]
    before = KERNEL_WRAPPERS[wrapper].launches
    got = library.OPS[op](*args)
    assert KERNEL_WRAPPERS[wrapper].launches == before + 1
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    sums = ("flash_backward_dkdv", "flash_backward_dq",
            "gn_split_backward_sums")
    for u, w in zip(got, want):
        assert u.is_cuda and u.shape == w.shape and u.dtype == w.dtype
        if u.dtype == torch.float64:
            torch.testing.assert_close(u, w, rtol=1e-12, atol=1e-9)
        else:
            _close(u, w, u.dtype,
                   SUM_TOL if u.dim() <= 1 or op in sums else TOL)
    tr = ir.Tracer(cuda)
    fake = [tr.mode.from_tensor(t) if torch.is_tensor(t) else t
            for t in args]
    gm = tr.trace(lambda: library.OPS[op](*fake))
    nodes = [n for n in gm.graph.nodes
             if library.op_name(n.target) == op]
    assert len(nodes) == 1
    assert KERNEL_WRAPPERS[wrapper].launches == before + 1
