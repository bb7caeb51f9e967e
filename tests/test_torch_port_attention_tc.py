"""The tolerance budget of the bf16 tensor-core attention kernels, on the CPU.

``diff3d_tpu_torch/ops/csrc/attention.cu`` computes the bf16 forward
(``flash_fwd_mma_kernel``), dK/dV (``flash_bwd_dkdv_mma_kernel``) and dQ
(``flash_bwd_dq_mma_kernel``) with ``mma.sync`` bf16 products.  The
forward keeps the Pallas kernel's f32 P (``pallas_attention.py:144-148``)
by feeding ``P V`` three bf16 parts of P whose sum is the f32 P; the
dK/dV kernel rounds P^T and dS^T to bf16 before ``dV = P^T dO`` and ``dK
= dS^T Q``, and the dQ kernel rounds dS to bf16 before ``dQ = dS K``, as
FlashAttention-2 does.  The models below repeat those numerics in plain
PyTorch -- an online softmax over the kernel's key tiles in f32, the row
sum over the f32 P, f32 sums over the key tiles -- and hold them against
the plain versions with exactly ``chip_smoke.py``'s bf16 tolerances: o,
dq, dk and dv within 2^-7 * (1 + max|ref|), lse within 1e-5 * (1 +
max|ref|).  So the card checks can hold the kernels to those limits
unloosened.
"""

import numpy as np
import pytest
import torch

from diff3d_tpu_torch.ops import cuda_attention

BF16_TOL = 2.0 ** -7
F32_TOL = 1e-5
# srn64's sites (B=2), srn128's (B=1), ragged L and Lq != Lk.
SHAPES = [(2, 256, 256, 4, 64), (2, 64, 64, 4, 128),
          (1, 1024, 1024, 4, 128), (1, 256, 256, 4, 256),
          (1, 200, 200, 2, 32), (1, 96, 160, 2, 64)]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, kept in f32."""
    return t.to(torch.bfloat16).float()


def _split3(t: torch.Tensor):
    """Three bf16 parts (kept in f32) whose sum is ``t``: each the next 8
    significant bits of what the ones before left."""
    parts = []
    for _ in range(3):
        parts.append(_bf16(t))
        t = t - parts[-1]
    return parts


def _heads(*ts):
    """f32 ``[B, H, L, D]`` views of ``[B, L, H, D]`` tensors."""
    return [t.float().transpose(1, 2) for t in ts]


def forward_model(q, k, v, scale):
    """The tensor-core forward's numerics: over key tiles of 64 (32 at
    D > 128), f32 scores, running max and sum, the row sum over the f32 P,
    ``P V`` as three products of P's bf16 parts; l == 0 -> 1.  Returns
    ``(o [B, Lq, H, D] bf16, lse [B, H, Lq] f32)``."""
    B, Lq, H, D = q.shape
    bk = 64 if D <= 128 else 32
    qf, kf, vf = _heads(q, k, v)
    m = torch.full((B, H, Lq, 1), -1e30)
    l = torch.zeros(B, H, Lq, 1)
    acc = torch.zeros(B, H, Lq, D)
    for k0 in range(0, k.shape[1], bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for part in _split3(p):
            acc = acc + part @ vf[:, :, k0:k0 + bk]
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / l).transpose(1, 2).to(q.dtype)
    return o, (m + torch.log(l)).squeeze(-1)


def dkdv_model(q, k, v, o, lse, do, glse, scale):
    """The tensor-core dK/dV's numerics: P^T = exp(S^T * scale - lse) and
    dS^T = P^T (dP^T - delta) * scale in f32, each rounded to bf16 before
    its product; f32 sums.  delta is the unchanged pre-pass's."""
    delta = cuda_attention.attention_delta_reference(o, do, glse)
    qf, kf, vf, dof = _heads(q, k, v, do)
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * scale
    dk = _bf16(ds).transpose(-1, -2) @ qf
    dv = _bf16(p).transpose(-1, -2) @ dof
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dk, dv))


def dq_model(q, k, v, o, lse, do, glse, scale):
    """The tensor-core dQ's numerics: over key tiles of 64 (32 at D > 64),
    P = exp(S * scale - lse) and dS = P (dP - delta) * scale in f32, dS
    rounded to bf16 before ``dS K``, the tiles' products summed in f32.
    delta is the pre-pass's (from dK/dV's call)."""
    delta = cuda_attention.attention_delta_reference(o, do, glse)
    qf, kf, vf, dof = _heads(q, k, v, do)
    bk = 64 if q.shape[-1] <= 64 else 32
    dq = torch.zeros_like(qf)
    for k0 in range(0, k.shape[1], bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        p = torch.exp(qf @ kt.transpose(-1, -2) * scale - lse[..., None])
        ds = p * (dof @ vt.transpose(-1, -2) - delta[..., None]) * scale
        dq = dq + _bf16(ds) @ kt
    return dq.transpose(1, 2).to(q.dtype)


def _ratio(got, want, tol):
    """max |got - want| over tol * (1 + max|want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err / (tol * (1.0 + float(want.float().abs().max())))


@pytest.mark.parametrize("glse_on", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_tensor_core_numerics_fit_the_card_tolerances(shape, glse_on):
    B, Lq, Lk, H, D = shape
    rng = np.random.default_rng(sum(shape))

    def bf16(*dims):
        return torch.tensor(rng.standard_normal(dims),
                            dtype=torch.float32).to(torch.bfloat16)

    q, k, v = bf16(B, Lq, H, D), bf16(B, Lk, H, D), bf16(B, Lk, H, D)
    do = bf16(B, Lq, H, D)
    glse = (torch.tensor(rng.standard_normal((B, H, Lq)),
                         dtype=torch.float32) if glse_on else None)
    scale = D ** -0.5

    o, lse = forward_model(q, k, v, scale)
    o_ref, lse_ref = cuda_attention.attention_lse_reference(q, k, v, scale)
    assert o.dtype == torch.bfloat16 and o.shape == o_ref.shape
    assert _ratio(o, o_ref, BF16_TOL) <= 1.0
    assert _ratio(lse, lse_ref, F32_TOL) <= 1.0

    # As on the card: the reference backward from the kernel's own o / lse.
    dk, dv = dkdv_model(q, k, v, o, lse, do, glse, scale)
    _, dk_ref, dv_ref = cuda_attention.attention_backward_reference(
        q, k, v, o, lse, do, glse, scale)
    assert _ratio(dk, dk_ref, BF16_TOL) <= 1.0
    assert _ratio(dv, dv_ref, BF16_TOL) <= 1.0


@pytest.mark.parametrize("glse_on", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_tensor_core_dq_numerics_fit_the_card_tolerances(shape, glse_on):
    """The dQ kernel's bf16 dS, from the kernel forward's own o / lse as
    on the card, against ``attention_backward_reference``'s dq."""
    B, Lq, Lk, H, D = shape
    rng = np.random.default_rng(sum(shape) + 1)

    def bf16(*dims):
        return torch.tensor(rng.standard_normal(dims),
                            dtype=torch.float32).to(torch.bfloat16)

    q, k, v = bf16(B, Lq, H, D), bf16(B, Lk, H, D), bf16(B, Lk, H, D)
    do = bf16(B, Lq, H, D)
    glse = (torch.tensor(rng.standard_normal((B, H, Lq)),
                         dtype=torch.float32) if glse_on else None)
    scale = D ** -0.5
    o, lse = forward_model(q, k, v, scale)
    dq = dq_model(q, k, v, o, lse, do, glse, scale)
    dq_ref = cuda_attention.attention_backward_reference(
        q, k, v, o, lse, do, glse, scale)[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == dq_ref.shape
    assert _ratio(dq, dq_ref, BF16_TOL) <= 1.0


def test_three_bf16_parts_carry_f32_precision():
    """The forward's split of P: three bf16 parts sum back to P within a
    few f32 ulps, where one bf16 part is ~2^-9 off."""
    p = torch.rand(4096, dtype=torch.float32)
    parts = _split3(p)
    assert all(torch.equal(_bf16(x), x) for x in parts)
    assert float(((parts[0] + parts[1] + parts[2]) - p).abs().max()) \
        <= 4 * 2.0 ** -24
    assert float((parts[0] - p).abs().max()) > 2.0 ** -12

