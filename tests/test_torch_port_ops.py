"""The port's kernel modules (``diff3d_tpu_torch/ops``) on the CPU.

The plain PyTorch version beside each CUDA kernel is held against the JAX
package's Pallas kernel (run in interpret mode, as its own tests run it)
and against its plain XLA composition, on the same numpy-made inputs.
The CUDA kernels themselves run only on the card:
``tests/test_torch_port_cuda.py`` holds them against their plain versions
there, and ``chip_smoke.py`` does so at the sampler's shapes.

Tolerances: f32 1e-5 (the same f32 arithmetic, summed in another order);
bf16 against the Pallas kernel one bf16 ulp at the output's magnitude
(both round once at the output, from f32 results that agree to ~1e-6);
bf16 against ``xla_groupnorm``, which rounds to bf16 after the affine, the
Pallas tests' own 2e-2 of the output scale.  Backward outputs, each
relative to 1 + its largest magnitude: f32 1e-5 (dgamma / dbeta, sums
over N*L, 1e-4); bf16 two bf16 ulps (both round once, but from f32 values
whose inputs -- the bf16 forward output o of attention, the statistics --
may already differ by one rounding).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu.ops.pallas_attention import flash_attention as j_flash  # noqa: E402
from diff3d_tpu.ops.pallas_attention import flash_attention_lse as j_flash_lse  # noqa: E402
from diff3d_tpu.ops import pallas_attention as j_pallas_attention  # noqa: E402
from diff3d_tpu.ops import pallas_film as j_pallas_film  # noqa: E402
from diff3d_tpu.ops.pallas_film import fused_groupnorm as j_fused  # noqa: E402
from diff3d_tpu.ops.pallas_film import xla_groupnorm  # noqa: E402
from diff3d_tpu_torch.ops import attention as t_attention  # noqa: E402
from diff3d_tpu_torch.ops import cuda_attention, cuda_film, dispatch  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
GN_SHAPES = [(2, 64, 96, 32), (1, 100, 144, 24)]   # (N, L, C, groups)
MODES = ["gn", "gn_silu", "gn_film", "gn_film_silu"]


from _torch_port_threads import one_thread  # noqa: E402,F401


def _gn_inputs(shape, film, seed=0):
    rng = np.random.RandomState(seed)
    N, L, C, G = shape
    x = rng.randn(N, L, C).astype(np.float32)
    gamma = rng.randn(C).astype(np.float32)
    beta = rng.randn(C).astype(np.float32)
    ss = (0.3 * rng.randn(2, N, L, C)).astype(np.float32) if film else None
    return x, gamma, beta, ss


def _both(shape, mode, dtype):
    """(port plain version, Pallas interpret, xla) outputs as f32 numpy."""
    film, silu = "film" in mode, "silu" in mode
    x, gamma, beta, ss = _gn_inputs(shape, film)
    G = shape[3]
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    jkw = dict(num_groups=G, silu=silu)
    tkw = dict(num_groups=G, silu=silu)
    if film:
        jkw.update(scale=jnp.asarray(ss[0], jd), shift=jnp.asarray(ss[1], jd))
        tkw.update(scale=torch.from_numpy(ss[0]).to(td),
                   shift=torch.from_numpy(ss[1]).to(td))
    jx = jnp.asarray(x, jd)
    pallas = j_fused(jx, jnp.asarray(gamma), jnp.asarray(beta),
                     interpret=True, **jkw)
    xla = xla_groupnorm(jx, jnp.asarray(gamma), jnp.asarray(beta), **jkw)
    port = cuda_film.groupnorm_reference(
        torch.from_numpy(x).to(td), torch.from_numpy(gamma),
        torch.from_numpy(beta), **tkw)
    assert port.dtype == td and port.shape == tuple(shape[:3])
    return (port.float().numpy(), np.asarray(pallas.astype(jnp.float32)),
            np.asarray(xla.astype(jnp.float32)))


@pytest.mark.parametrize("shape", GN_SHAPES, ids=["C96", "C144G24"])
@pytest.mark.parametrize("mode", MODES)
def test_groupnorm_plain_matches_pallas_and_xla_f32(shape, mode):
    port, pallas, xla = _both(shape, mode, "f32")
    np.testing.assert_allclose(port, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port, xla, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_groupnorm_plain_follows_pallas_bf16_semantics(mode):
    """bf16: the port rounds once at the output, as the Pallas kernel
    does (``pallas_film.py:212-220``), not after the affine as the xla
    path does (``layers.py:109-115``)."""
    port, pallas, xla = _both(GN_SHAPES[0], mode, "bf16")
    mag = float(np.abs(pallas).max())
    np.testing.assert_allclose(port, pallas, atol=2.0 ** -7 * (1 + mag),
                               rtol=0)
    np.testing.assert_allclose(port / (1 + mag), xla / (1 + mag), atol=2e-2)


def test_groupnorm_eps_and_clamped_variance():
    """Trap: eps is 1e-5 and the variance is E[x^2] - mean^2 clamped at
    0 (``pallas_film.py:149-161``).  A constant group normalises to exact
    zeros, so the output is beta; a zero-mean group of spread 1e-3
    (variance ~1e-6) tells 1e-5 from Flax's default 1e-6."""
    C, G = 8, 2
    x = torch.zeros(1, 16, C)
    x[..., :4] = 3.0                                  # constant group 0
    x[..., 4:] = 1e-3 * torch.randn(
        1, 16, 4, generator=torch.Generator().manual_seed(0))
    gamma, beta = torch.ones(C), torch.arange(C, dtype=torch.float32)
    out = cuda_film.groupnorm_reference(x, gamma, beta, num_groups=G)
    assert torch.equal(out[..., :4], beta[:4].expand(1, 16, 4))
    g1 = x[..., 4:].double()
    var = g1.var(unbiased=False)
    for eps, close in ((1e-5, True), (1e-6, False)):
        want = (g1 - g1.mean()) / torch.sqrt(var + eps) + beta[4:].double()
        assert torch.allclose(out[..., 4:].double(), want, atol=1e-3) \
            == close


def test_groupnorm_wrapper_on_cpu_is_the_plain_version():
    x, gamma, beta, ss = _gn_inputs((2, 30, 64, 32), film=True)
    e = torch.from_numpy(np.concatenate([ss[0], ss[1]], -1))
    kw = dict(num_groups=32, scale=e[..., :64], shift=e[..., 64:],
              silu=True)                           # strided FiLM halves
    before = cuda_film.fused_groupnorm.launches
    args = (torch.from_numpy(x), torch.from_numpy(gamma),
            torch.from_numpy(beta))
    out = cuda_film.fused_groupnorm(*args, **kw)
    assert torch.equal(out, cuda_film.groupnorm_reference(*args, **kw))
    assert cuda_film.fused_groupnorm.launches == before   # no launch
    with pytest.raises(ValueError, match="together"):
        cuda_film.fused_groupnorm(*args, num_groups=32, scale=kw["scale"])


def test_groupnorm_supports():
    ok = torch.zeros(2, 16, 64)
    assert cuda_film.supports(ok, num_groups=32)
    assert not cuda_film.supports(ok, num_groups=24)          # 64 % 24
    assert not cuda_film.supports(ok.half(), num_groups=32)
    assert not cuda_film.supports(torch.zeros(2, 16, 8192), num_groups=32)
    assert not cuda_film.supports(ok.transpose(1, 2), num_groups=16)
    assert cuda_film.supports(torch.zeros(2, 16, 128)[..., :64],
                              num_groups=32)                  # row stride
    # Any group count that divides C <= 4096, as pallas_film.supports.
    wide = torch.zeros(1, 4, 2048)
    assert cuda_film.supports(wide, num_groups=2048)
    assert j_pallas_film.supports(jnp.zeros((1, 4, 2048)), num_groups=2048)
    assert cuda_film.supports(torch.zeros(1, 4, 4096), num_groups=4096)


ATTN_SHAPES = [(1, 64, 64, 2, 64), (1, 96, 160, 2, 64), (1, 64, 64, 1, 160)]


def _qkv(shape, seed=0):
    rng = np.random.RandomState(seed)
    B, Lq, Lk, H, D = shape
    return (rng.randn(B, Lq, H, D).astype(np.float32),
            rng.randn(B, Lk, H, D).astype(np.float32),
            rng.randn(B, Lk, H, D).astype(np.float32))


@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=["square", "cross", "D160"])
def test_attention_plain_matches_pallas_and_xla(shape):
    q, k, v = _qkv(shape)
    port = cuda_attention.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v))).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(j_flash(jq, jk, jv, interpret=True))
    xla = np.asarray(jax.nn.dot_product_attention(jq, jk, jv))
    assert port.shape == pallas.shape == (shape[0], shape[1], shape[3],
                                          shape[4])
    np.testing.assert_allclose(port, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port, xla, atol=1e-5, rtol=1e-5)


def test_attention_bf16_rounds_once():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(ATTN_SHAPES[1], seed=1))
    out = cuda_attention.attention_reference(q, k, v)
    assert out.dtype == torch.bfloat16
    f32 = cuda_attention.attention_reference(q.float(), k.float(),
                                             v.float())
    assert torch.equal(out, f32.bfloat16())


def test_attention_wrapper_and_heads_on_cpu():
    B, L, H, D = 2, 24, 4, 8
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, L, H * D, generator=g) for _ in range(3))
    before = cuda_attention.flash_attention.launches
    out = t_attention.multi_head_attention(q, k, v, H)
    assert cuda_attention.flash_attention.launches == before
    ref = cuda_attention.attention_reference(
        q.view(B, L, H, D), k.view(B, L, H, D), v.view(B, L, H, D))
    assert torch.equal(out, ref.reshape(B, L, H * D))
    # Heads are independent: head 0 alone gives the same first D columns.
    one = cuda_attention.attention_reference(
        *(t[..., :D].reshape(B, L, 1, D) for t in (q, k, v)))
    torch.testing.assert_close(out[..., :D], one.reshape(B, L, D))


def test_attention_supports():
    """The kernels take the Pallas kernel's head dims: D <= 512
    (``pallas_attention.MAX_D``)."""
    q = torch.zeros(1, 8, 2, 64)
    assert cuda_attention.supports(q, q, q)
    assert not cuda_attention.supports(q, q.half(), q)
    assert cuda_attention.MAX_D == j_pallas_attention.MAX_D == 512
    for D in (320, 512):
        wide = torch.zeros(1, 8, 1, D)
        assert cuda_attention.supports(wide, wide, wide)
    big = torch.zeros(1, 8, 1, 640)
    assert not cuda_attention.supports(big, big, big)          # D > 512
    assert not cuda_attention.supports(q, torch.zeros(1, 8, 4, 32),
                                       torch.zeros(1, 8, 4, 32))


def test_dispatch_resolves_by_request_and_device():
    x = torch.zeros(2, 16, 64)
    cuda = dispatch.resolve("groupnorm", "cuda", x, num_groups=32)
    plain = dispatch.resolve("groupnorm", "torch", x, num_groups=32)
    assert cuda.fn is cuda_film.fused_groupnorm
    assert plain.fn is cuda_film.groupnorm_reference
    # An operand the kernel rejects is still fine on the CPU.
    assert dispatch.resolve("groupnorm", "cuda", x.half(),
                            num_groups=32) is cuda
    q = torch.zeros(1, 8, 2, 16)
    assert dispatch.resolve("sdpa", "cuda", q, q, q).fn \
        is cuda_attention.flash_attention
    with pytest.raises(ValueError, match="not in"):
        dispatch.resolve("groupnorm", "pallas", x, num_groups=32)
    with pytest.raises(KeyError):
        dispatch.resolve("nope", "cuda", x)


def _rel_close(port, ref, tol):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = float(np.abs(port - ref).max())
    assert err <= tol * (1 + float(np.abs(ref).max())), err


def _gn_vjp(shape, mode, dtype, seed=1):
    """``(port, pallas)`` backward outputs ``(dx, dgamma, dbeta, dscale,
    dshift)`` for one upstream gradient: the port's plain backward from
    its own statistics, and ``jax.vjp`` of the Pallas kernel (interpret
    mode)."""
    film, silu = "film" in mode, "silu" in mode
    x, gamma, beta, ss = _gn_inputs(shape, film, seed)
    G = shape[3]
    g = np.random.RandomState(seed + 7).randn(*shape[:3]).astype(np.float32)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    jx, jg = jnp.asarray(x, jd), jnp.asarray(g, jd)
    jss = ([jnp.asarray(ss[0], jd), jnp.asarray(ss[1], jd)] if film
           else [])

    def f(x, gamma, beta, *scale_shift):
        kw = dict(scale=scale_shift[0], shift=scale_shift[1]) if film else {}
        return j_fused(x, gamma, beta, num_groups=G, silu=silu,
                       interpret=True, **kw)

    _, vjp = jax.vjp(f, jx, jnp.asarray(gamma), jnp.asarray(beta), *jss)
    pallas = vjp(jg)
    tx = torch.from_numpy(x).to(td)
    tss = ([torch.from_numpy(ss[0]).to(td), torch.from_numpy(ss[1]).to(td)]
           if film else [None, None])
    dx, dscale, dshift, dgamma, dbeta = cuda_film.groupnorm_backward_reference(
        tx, torch.from_numpy(g).to(td), torch.from_numpy(gamma),
        torch.from_numpy(beta), *tss,
        cuda_film.groupnorm_stats_reference(tx, G), num_groups=G, silu=silu)
    port = [dx, dgamma, dbeta] + ([dscale, dshift] if film else [])
    assert dx.dtype == td and dgamma.dtype == torch.float32
    return ([t.float().numpy() for t in port],
            [np.asarray(t.astype(jnp.float32)) for t in pallas])


@pytest.mark.parametrize("shape", GN_SHAPES, ids=["C96", "C144G24"])
@pytest.mark.parametrize("mode", MODES)
def test_groupnorm_backward_plain_matches_pallas_vjp_f32(shape, mode):
    port, pallas = _gn_vjp(shape, mode, "f32")
    for i, (a, b) in enumerate(zip(port, pallas)):
        _rel_close(a, b, 1e-4 if i in (1, 2) else 1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_groupnorm_backward_plain_matches_pallas_vjp_bf16(mode):
    port, pallas = _gn_vjp(GN_SHAPES[0], mode, "bf16")
    for i, (a, b) in enumerate(zip(port, pallas)):
        _rel_close(a, b, 1e-4 if i in (1, 2) else 2.0 ** -6)


@pytest.mark.parametrize("film,silu", [(False, False), (True, True)])
def test_groupnorm_autograd_fn_on_cpu_matches_plain_autograd(film, silu):
    """The autograd Function on CPU tensors (plain forward, explicit plain
    backward) against torch autograd of the plain forward."""
    N, L, C, G = 2, 30, 64, 8
    x, gamma, beta, ss = _gn_inputs((N, L, C, G), film, seed=4)
    e = torch.from_numpy(np.concatenate([ss[0], ss[1]], -1)) if film \
        else None

    def run(fn):
        ins = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
        if film:
            ins.append(e.clone().requires_grad_())
        kw = dict(scale=ins[3][..., :C], shift=ins[3][..., C:]) if film \
            else {}
        out = fn(*ins[:3], num_groups=G, silu=silu, **kw)
        g = torch.from_numpy(np.random.RandomState(5).randn(N, L, C)
                             .astype(np.float32))
        return out, torch.autograd.grad(out, ins, g)

    out, grads = run(cuda_film.fused_groupnorm)
    assert out.grad_fn is not None \
        and "FusedGroupNorm" in type(out.grad_fn).__name__
    ref, ref_grads = run(cuda_film.groupnorm_reference)
    assert torch.equal(out, ref)
    for a, b in zip(grads, ref_grads):
        _rel_close(a.numpy(), b.numpy(), 1e-5)


def _attn_vjp(shape, dtype, glse_on, seed=2):
    q, k, v = _qkv(shape, seed)
    B, Lq, Lk, H, D = shape
    rng = np.random.RandomState(seed + 9)
    do = rng.randn(B, Lq, H, D).astype(np.float32)
    gl = (rng.randn(B, Lq, H).astype(np.float32) if glse_on
          else np.zeros((B, Lq, H), np.float32))
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    (jo, jlse), vjp = jax.vjp(
        lambda q, k, v: j_flash_lse(q, k, v, interpret=True),
        *(jnp.asarray(a, jd) for a in (q, k, v)))
    pallas = vjp((jnp.asarray(do, jd), jnp.asarray(gl)))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    o, lse = cuda_attention.attention_lse_reference(tq, tk, tv)
    grads = cuda_attention.attention_backward_reference(
        tq, tk, tv, o, lse, torch.from_numpy(do).to(td),
        torch.from_numpy(gl).transpose(1, 2).contiguous() if glse_on
        else None)
    port = [o, lse.transpose(1, 2)] + list(grads)
    ref = [jo, jlse] + list(pallas)
    return ([t.float().numpy() for t in port],
            [np.asarray(t.astype(jnp.float32)) for t in ref])


@pytest.mark.parametrize("glse_on", [False, True], ids=["o", "o+lse"])
@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=["square", "cross", "D160"])
def test_attention_lse_and_backward_plain_match_pallas_f32(shape, glse_on):
    """The forward's (o, lse) and (dq, dk, dv) against ``jax.vjp`` of the
    Pallas ``flash_attention_lse`` (interpret mode), with and without a
    non-zero lse cotangent (``tests/test_pallas_attention.py:77``)."""
    port, pallas = _attn_vjp(shape, "f32", glse_on)
    for a, b in zip(port, pallas):
        _rel_close(a, b, 1e-5)


@pytest.mark.parametrize("glse_on", [False, True], ids=["o", "o+lse"])
def test_attention_plain_matches_pallas_at_wide_head_dim(glse_on):
    """D = 384, inside the Pallas domain (D <= 512) and above the
    tensor-core kernels' 256: the plain forward's (o, lse) and the plain
    backward against ``jax.vjp`` of the Pallas kernel in interpret mode."""
    port, pallas = _attn_vjp((1, 24, 40, 2, 384), "f32", glse_on)
    for a, b in zip(port, pallas):
        _rel_close(a, b, 1e-5)


def test_attention_backward_plain_matches_pallas_bf16():
    port, pallas = _attn_vjp(ATTN_SHAPES[1], "bf16", True)
    for i, (a, b) in enumerate(zip(port, pallas)):
        _rel_close(a, b, 1e-5 if i == 1 else 2.0 ** -6)


def test_attention_autograd_fn_on_cpu_matches_plain_autograd():
    """``flash_attention`` / ``flash_attention_lse`` on CPU tensors under
    autograd (plain forward, explicit plain backward) against torch
    autograd of the plain forward, both cotangents flowing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(ATTN_SHAPES[1], seed=6))
    rng = np.random.RandomState(8)
    do = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    gl = torch.from_numpy(rng.randn(*q.shape[:3]).astype(np.float32))

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        outs, cots = fn(*ins)
        return outs, torch.autograd.grad(outs, ins, cots)

    def lse_ref(q, k, v):
        o, lse = cuda_attention.attention_lse_reference(q, k, v)
        return (o, lse.transpose(1, 2)), (do, gl)

    for fn, ref in (
            (lambda q, k, v: (cuda_attention.flash_attention_lse(q, k, v),
                              (do, gl)), lse_ref),
            (lambda q, k, v: ((cuda_attention.flash_attention(q, k, v),),
                              (do,)),
             lambda q, k, v: ((cuda_attention.attention_reference(q, k, v),),
                              (do,)))):
        outs, got = grads(fn)
        assert outs[0].grad_fn is not None \
            and "FlashAttention" in type(outs[0].grad_fn).__name__
        _, want = grads(ref)
        for a, b in zip(got, want):
            _rel_close(a.numpy(), b.numpy(), 1e-5)


@pytest.mark.parametrize("glse_on", [False, True], ids=["o", "o+lse"])
def test_attention_backward_parts_on_cpu_are_the_plain_version(glse_on):
    """On CPU tensors the dK/dV wrapper (with its delta) and the dQ wrapper
    are the plain backward, exactly, and launch nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(ATTN_SHAPES[1], seed=3))
    rng = np.random.RandomState(5)
    do = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    gl = (torch.from_numpy(rng.randn(q.shape[0], q.shape[2], q.shape[1])
                           .astype(np.float32)) if glse_on else None)
    o, lse = cuda_attention.attention_lse_reference(q, k, v)
    before = (cuda_attention.attention_backward_dkdv.launches,
              cuda_attention.attention_backward_dq.launches)
    dk, dv, delta = cuda_attention.attention_backward_dkdv(q, k, v, o, lse,
                                                           do, gl)
    dq = cuda_attention.attention_backward_dq(q, k, v, o, lse, do, delta)
    assert (cuda_attention.attention_backward_dkdv.launches,
            cuda_attention.attention_backward_dq.launches) == before
    want_delta = (do * o).sum(-1).transpose(1, 2)
    if glse_on:
        want_delta = want_delta - gl
    assert torch.equal(delta, want_delta)
    want = cuda_attention.attention_backward_reference(q, k, v, o, lse, do,
                                                       gl)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_holds_zero_unsuppressed_lockcheck_findings():
    """The JAX package's concurrency analyzer over the whole port: every
    guarded field read under its lock, no callback under a lock, ...; a
    suppression carries its reason in the source."""
    from diff3d_tpu.analysis.lockcheck import lockcheck_paths

    live = [f for f in lockcheck_paths([str(REPO / "diff3d_tpu_torch")])
            if not f.suppressed]
    assert not live, "unsuppressed lockcheck findings:\n" + "\n".join(
        f.render() for f in live)


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((REPO / "diff3d_tpu_torch").rglob("*.py"))
    assert {"mesh.py", "multihost.py", "ring_attention.py", "tensor.py",
            "context.py"} <= {
        p.name for p in files if p.parent.name == "parallel"}
    # The spawned ranks of the parallel tests import only the port.
    files += [REPO / "chip_smoke.py",
              REPO / "tests" / "_torch_port_parallel_worker.py",
              REPO / "tests" / "_torch_port_tp_worker.py",
              REPO / "tests" / "_torch_port_cp_worker.py",
              REPO / "tests" / "_torch_port_distill_worker.py",
              REPO / "tests" / "_torch_port_serving_mesh_worker.py",
              REPO / "tests" / "_torch_port_serving_mesh_fleet_worker.py",
              REPO / "tools" / "serve_nan_witness.py",
              REPO / "tools" / "chip_smoke_parallel_phases.py"]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                "diff3d_tpu"), (path, mod)
