"""The cluster GroupNorm forward's plan and order of folds, on the CPU.

``diff3d_tpu_torch/ops/csrc/film.cu``'s ``gn_fwd_cluster_kernel`` runs one
thread-block cluster of ``cluster`` CTAs per sample; CTA ``rank`` takes
rows ``[rank * R, (rank + 1) * R)`` (R = ``rows_per_cta``; the last CTAs
may get fewer rows or none).  In a CTA, lane row group ``ry`` (of RY =
256 / min(C / W, 256), W channels a lane: 8 bf16 or 4 f32) sums x and
x^2 over rows ``r0 + ry, r0 + ry + RY, ...``; the row groups fold in order
to channels, the channels in channel order to groups, and after
``cluster.sync()`` every CTA adds the group partials of all CTAs in rank
order (distributed shared memory).  Then mean = sum / (L * C / G), var =
E[x^2] - mean^2 clamped at 0, rstd = rsqrt(var + 1e-5).
:func:`cluster_stats_model` repeats that decomposition in plain PyTorch
and is held, for every cluster size, against ``groupnorm_stats_reference``
and against the Pallas forward's statistics in interpret mode, with the
tolerances of ``tests/test_torch_port_ops.py`` (statistics f32 1e-5; the
output from those statistics f32 1e-5, bf16 one bf16 ulp, each relative to
1 + the largest magnitude).  :func:`cuda_film.forward_plan` is checked to
cover every row within the kernel's shared-memory limits, and to return
the plans ``PERF.md`` records at the srn64 sites.  The kernel itself runs
on the card (``tests/test_torch_port_cuda.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu.ops import pallas_film as j_pallas_film  # noqa: E402
from diff3d_tpu_torch.ops import cuda_film  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (N, L, C, G): rows that no cluster size divides; groups of 6 channels
# that a lane's 8 bf16 channels straddle.
SHAPES = [(2, 255, 128, 32), (1, 100, 144, 24)]


from _torch_port_threads import one_thread  # noqa: E402,F401


def _in_order(parts):
    """Sum a list of tensors left to right."""
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def cluster_stats_model(x, num_groups, cluster):
    """``[2, N, G]`` (mean, rstd) by the cluster kernel's decomposition:
    per-lane row-group sums, folded in order to channels, channels to
    groups in channel order, CTAs in rank order."""
    N, L, C = x.shape
    G, gs = num_groups, C // num_groups
    W = 16 // x.element_size()
    RY = cuda_film.FWD_THREADS // min(C // W, cuda_film.FWD_THREADS)
    rows = -(-L // cluster)
    xf = x.float()
    s1, s2 = [], []
    for rank in range(cluster):
        r0 = min(L, rank * rows)
        r1 = min(L, r0 + rows)
        csum = _in_order([xf[:, r0 + ry:r1:RY].sum(1) for ry in range(RY)])
        csq = _in_order([(xf * xf)[:, r0 + ry:r1:RY].sum(1)
                         for ry in range(RY)])
        s1.append(_in_order([csum.reshape(N, G, gs)[..., k]
                             for k in range(gs)]))
        s2.append(_in_order([csq.reshape(N, G, gs)[..., k]
                             for k in range(gs)]))
    count = float(L * gs)
    mean = _in_order(s1) / count
    var = torch.clamp(_in_order(s2) / count - mean * mean, min=0.0)
    return torch.stack([mean, torch.rsqrt(var + cuda_film.EPS)])


def _inputs(shape, dtype):
    N, L, C, G = shape
    rng = np.random.default_rng(N + L + C)
    x = (rng.standard_normal((N, L, C)) + 0.5).astype(np.float32)
    gamma = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(C)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), gamma, beta


@functools.lru_cache(maxsize=None)
def _pallas(shape, dtype):
    """The Pallas forward in interpret mode with ``save_stats``: its
    output and its group statistics ``[2, N, G]`` (each group's value
    read from its first channel)."""
    N, L, C, G = shape
    x, gamma, beta = _inputs(shape, dtype)
    out, mean, rstd = j_pallas_film._fwd_call(
        jnp.asarray(x.float().numpy(), JNP[dtype]), jnp.asarray(gamma),
        jnp.asarray(beta), None, None, num_groups=G, film=False, silu=True,
        interpret=True, save_stats=True)
    gs = C // G
    stats = np.stack([np.asarray(mean)[:, 0, 0:C:gs],
                      np.asarray(rstd)[:, 0, 0:C:gs]])
    return (torch.from_numpy(np.array(out.astype(jnp.float32))),
            torch.from_numpy(stats))


def _close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * (1 + float(want.float().abs().max())), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=["C128", "C144G24"])
def test_cluster_fold_order_matches_reference_and_pallas(shape, cluster,
                                                         dtype):
    N, L, C, G = shape
    x, gamma, beta = _inputs(shape, dtype)
    stats = cluster_stats_model(x, G, cluster)
    assert stats.shape == (2, N, G) and stats.dtype == torch.float32
    _close(stats, cuda_film.groupnorm_stats_reference(x, G), 1e-5)
    p_out, p_stats = _pallas(shape, dtype)
    _close(stats, p_stats, 1e-5)
    out = cuda_film.groupnorm_reference(
        x, torch.from_numpy(gamma), torch.from_numpy(beta), num_groups=G,
        silu=True, stats=stats)
    assert out.dtype == dtype
    _close(out, p_out, TOL[dtype])


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("C,G", [(128, 32), (144, 24), (512, 32),
                                 (4096, 4096)])
@pytest.mark.parametrize("N,L", [(32, 4096), (32, 64), (2, 1000), (1, 7),
                                 (64, 256), (256, 4096), (1, 1)])
def test_forward_plan_covers_every_row(N, L, C, G, itemsize, film):
    """Every row belongs to one CTA of at most 16; a plan that keeps x on
    chip fits it beside the fold buffers in the 227 KB (232,448 bytes) a
    block may use, which ``film.cu`` checks; the fold buffers alone fit
    it too."""
    cs, rows, onchip = cuda_film.forward_plan(N, L, C, G, itemsize, film)
    assert cs in (1, 2, 4, 8, 16)
    assert rows == -(-L // cs) and cs * rows >= L
    aux = cuda_film._fwd_aux_bytes(C, G, itemsize)
    assert aux <= cuda_film.SMEM_MAX
    if onchip:
        assert aux + rows * C * itemsize <= cuda_film.SMEM_MAX


def test_forward_plan_at_the_srn64_sites():
    """The bf16 srn64 plans ``PERF.md`` records.  Train step (N = 256
    frames): one CTA per sample, re-reading x from L2; at FiLM sites
    clusters that leave a CTA at most 128 KB of x.  Sampler step (N =
    32): clusters of 4, or of 16 where a CTA would stream more than 128
    KB of x, keeping it on chip where two CTAs share an SM."""
    plan = cuda_film.forward_plan
    for L, C in [(4096, 128), (4096, 384), (1024, 256), (256, 768),
                 (64, 512)]:
        assert plan(256, L, C, 32, 2, False) == (1, L, False)
    assert plan(256, 4096, 128, 32, 2, True) == (8, 512, False)
    assert plan(256, 1024, 256, 32, 2, True) == (4, 256, False)
    assert plan(256, 256, 256, 32, 2, True) == (1, 256, False)
    assert plan(32, 64, 512, 32, 2, False) == (4, 16, False)
    assert plan(32, 256, 256, 32, 2, True) == (4, 64, False)
    assert plan(32, 1024, 256, 32, 2, False) == (4, 256, False)
    assert plan(32, 1024, 384, 32, 2, False) == (16, 64, True)
    assert plan(32, 4096, 128, 32, 2, True) == (16, 256, True)
    assert plan(32, 4096, 256, 32, 2, False) == (16, 256, False)
