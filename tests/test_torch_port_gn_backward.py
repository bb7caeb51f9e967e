"""The cluster GroupNorm backward's plan and order of folds, on the CPU.

``diff3d_tpu_torch/ops/csrc/film.cu``'s ``gn_bwd_cluster_kernel`` runs one
thread-block cluster of ``cluster`` CTAs per sample; CTA ``rank`` takes
rows ``[rank * R, (rank + 1) * R)`` (R = ``rows_per_cta``; the last CTAs
may get fewer rows or none).  Each CTA sums its rows per channel, folds
channels to groups in channel order, and after ``cluster.sync()`` every
CTA adds the group partials of all CTAs in rank order (distributed shared
memory); the per-channel dgamma / dbeta partials fold over the cluster in
rank order into ``[N, C]``, then ``gn_bwd_param_kernel`` folds 16 row
groups of samples (n = k, k + 16, ...) and adds the 16 partials in order.
:func:`cluster_backward_model` repeats that decomposition in plain
PyTorch and is held against ``groupnorm_backward_reference`` with
``chip_smoke.py``'s tolerances (dx, dscale, dshift: f32 1e-5, bf16 2^-7;
dgamma / dbeta 1e-4; each times 1 + max|ref|), at edge shapes: L not a
multiple of the cluster, idle CTAs, N = 1, C = 4096 at G = 32 and 2048.
:func:`cuda_film.backward_plan` is checked to cover every row within the
kernel's limits.  The kernel itself runs on the card
(``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

from diff3d_tpu_torch.ops import cuda_film

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SUM_TOL = 1e-4


from _torch_port_threads import one_thread  # noqa: E402,F401


def _in_order(parts):
    """Sum a list of tensors left to right."""
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def cluster_backward_model(x, g, gamma, beta, scale, shift, stats, *,
                           num_groups, silu, plan):
    """``(dx, dscale, dshift, dgamma, dbeta)`` by the cluster kernel's
    decomposition: per-CTA row sums, channel-to-group folds in channel
    order, rank-ordered sums over the cluster, the fold over N in 16 row
    groups.  The element chain is the reference's, in f32."""
    cs, rows, _ = plan
    N, L, C = x.shape
    G, gs = num_groups, C // num_groups
    mean = cuda_film._per_channel(stats[0], C)
    rstd = cuda_film._per_channel(stats[1], C)
    xhat = (x.float() - mean) * rstd
    y_gn = xhat * gamma + beta
    film = scale is not None
    sc1 = 1.0 + scale.float() if film else None
    y = y_gn * sc1 + shift.float() if film else y_gn
    dy_f = g.float()
    if silu:
        sig = torch.sigmoid(y)
        dy_f = dy_f * (sig * (1.0 + y * (1.0 - sig)))
    dy_gn = dy_f * sc1 if film else dy_f
    dxhat = dy_gn * gamma

    s1, s2, cdg, cdb = [], [], [], []
    for rank in range(cs):
        r0 = min(L, rank * rows)
        r1 = min(L, r0 + rows)
        rs = slice(r0, r1)
        c1 = dxhat[:, rs].sum(1).reshape(N, G, gs)
        c2 = (dxhat * xhat)[:, rs].sum(1).reshape(N, G, gs)
        s1.append(_in_order([c1[..., k] for k in range(gs)]))
        s2.append(_in_order([c2[..., k] for k in range(gs)]))
        cdg.append((dy_gn * xhat)[:, rs].sum(1))
        cdb.append(dy_gn[:, rs].sum(1))
    count = float(L * gs)
    m1 = cuda_film._per_channel(_in_order(s1) / count, C)
    m2 = cuda_film._per_channel(_in_order(s2) / count, C)
    dx = rstd * (dxhat - m1 - xhat * m2)
    pdg, pdb = _in_order(cdg), _in_order(cdb)               # [N, C]
    dgamma = _in_order([pdg[k::16].sum(0) for k in range(min(16, N))])
    dbeta = _in_order([pdb[k::16].sum(0) for k in range(min(16, N))])
    if film:
        return (dx.to(x.dtype), (dy_f * y_gn).to(scale.dtype),
                dy_f.to(shift.dtype), dgamma, dbeta)
    return dx.to(x.dtype), None, None, dgamma, dbeta


def _inputs(N, L, C, G, film, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=torch.float32).to(dt)

    x = t(rng.standard_normal((N, L, C)))
    gamma = t(1 + 0.2 * rng.standard_normal(C), torch.float32)
    beta = t(0.2 * rng.standard_normal(C), torch.float32)
    scale = shift = None
    if film:                      # the two halves of one Dense output
        e = t(0.3 * rng.standard_normal((N, L, 2 * C)))
        scale, shift = e[..., :C], e[..., C:]
    g = t(rng.standard_normal((N, L, C)))
    return x, g, gamma, beta, scale, shift


# (N, L, C, G, plan or None for backward_plan's): L not a multiple of the
# cluster, a cluster with idle CTAs, N = 1 (a single cluster), C = 4096.
CASES = [(2, 255, 128, 32, (16, 16, True)),
         (3, 37, 64, 8, (4, 10, False)),
         (1, 5, 64, 32, (4, 2, True)),
         (1, 300, 256, 32, None),
         (2, 13, 4096, 32, None),
         (1, 9, 4096, 2048, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film,silu", [(False, True), (True, False),
                                       (True, True)])
@pytest.mark.parametrize("case", CASES)
def test_cluster_fold_order_matches_reference(case, film, silu, dtype):
    N, L, C, G, plan = case
    plan = plan or cuda_film.backward_plan(N, L, C, G, dtype.itemsize)
    x, g, gamma, beta, scale, shift = _inputs(N, L, C, G, film, dtype,
                                              seed=N + L + C)
    stats = cuda_film.groupnorm_stats_reference(x, G)
    got = cluster_backward_model(x, g, gamma, beta, scale, shift, stats,
                                 num_groups=G, silu=silu, plan=plan)
    want = cuda_film.groupnorm_backward_reference(
        x, g, gamma, beta, scale, shift, stats, num_groups=G, silu=silu)
    for name, a, b in zip(("dx", "dscale", "dshift", "dgamma", "dbeta"),
                          got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        tol = SUM_TOL if name in ("dgamma", "dbeta") else TOL[dtype]
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * (1 + float(b.float().abs().max())), (name, err)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("N,L,C,G", [
    (256, 4096, 128, 32), (256, 1024, 256, 32), (256, 256, 256, 32),
    (256, 64, 512, 32), (256, 64, 1024, 32), (1, 4096, 128, 32),
    (1, 7, 96, 32), (2, 4095, 128, 32), (1, 1, 4096, 4096),
    (3, 13, 4096, 2048), (32, 16384, 128, 32)])
def test_backward_plan_covers_every_row(N, L, C, G, itemsize):
    """Every row belongs to one CTA of at most 16; a plan that keeps x and
    g on chip leaves room for a second CTA on the SM, with the fold
    buffers; the fold buffers alone fit the 227 KB (232,448 bytes) a
    block may use, which ``film.cu`` checks."""
    cs, rows, onchip = cuda_film.backward_plan(N, L, C, G, itemsize)
    assert cs in (1, 2, 4, 8, 16)
    assert rows == -(-L // cs) and cs * rows >= L
    aux = 4 * ((4 * C + 2 * G + cuda_film.BWD_THREADS * (16 // itemsize)
                + 3) // 4 * 4)
    if onchip:
        assert aux + 2 * rows * C * itemsize <= cuda_film.SMEM_TWO_PER_SM
    assert aux <= 232448


def test_backward_plan_at_the_srn64_train_sites():
    """The bf16 srn64 train step (N = 256 frames): the 32^2 and smaller
    levels keep their rows on chip at two CTAs per SM; the 64^2 level's
    rows do not fit that (131 KB a CTA at 16 CTAs), so clusters of 8
    re-read x and g."""
    plan = cuda_film.backward_plan
    assert plan(256, 4096, 128, 32, 2) == (8, 512, False)
    assert plan(256, 1024, 256, 32, 2) == (16, 64, True)
    assert plan(256, 1024, 512, 32, 2) == (8, 128, False)
    assert plan(256, 256, 256, 32, 2) == (4, 64, True)
    assert plan(256, 64, 512, 32, 2) == (2, 32, True)
    assert plan(256, 4096, 128, 32, 4) == (8, 512, False)
