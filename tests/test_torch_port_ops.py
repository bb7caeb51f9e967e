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
Pallas tests' own 2e-2 of the output scale.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu.ops.pallas_attention import flash_attention as j_flash  # noqa: E402
from diff3d_tpu.ops.pallas_film import fused_groupnorm as j_fused  # noqa: E402
from diff3d_tpu.ops.pallas_film import xla_groupnorm  # noqa: E402
from diff3d_tpu_torch.ops import attention as t_attention  # noqa: E402
from diff3d_tpu_torch.ops import cuda_attention, cuda_film, dispatch  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
GN_SHAPES = [(2, 64, 96, 32), (1, 100, 144, 24)]   # (N, L, C, groups)
MODES = ["gn", "gn_silu", "gn_film", "gn_film_silu"]


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


@pytest.mark.parametrize("N,L", [(32, 4096), (32, 64), (2, 1000), (1, 7),
                                 (64, 256)])
def test_groupnorm_launch_shape_covers_every_row(N, L):
    splits, rows_per_split, rows_per_block = cuda_film.launch_shape(N, L)
    assert splits >= 1 and rows_per_split >= 1
    assert (splits - 1) * rows_per_split < L <= splits * rows_per_split
    assert rows_per_block in (8, 32)
    assert N * splits >= min(4 * 132, N * -(-L // 32))


def test_groupnorm_supports():
    ok = torch.zeros(2, 16, 64)
    assert cuda_film.supports(ok, num_groups=32)
    assert not cuda_film.supports(ok, num_groups=24)          # 64 % 24
    assert not cuda_film.supports(ok.half(), num_groups=32)
    assert not cuda_film.supports(torch.zeros(2, 16, 8192), num_groups=32)
    assert not cuda_film.supports(ok.transpose(1, 2), num_groups=16)
    assert cuda_film.supports(torch.zeros(2, 16, 128)[..., :64],
                              num_groups=32)                  # row stride


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
    q = torch.zeros(1, 8, 2, 64)
    assert cuda_attention.supports(q, q, q)
    assert not cuda_attention.supports(q, q.half(), q)
    big = torch.zeros(1, 8, 1, 320)
    assert not cuda_attention.supports(big, big, big)          # D > 256
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


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((REPO / "diff3d_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                "diff3d_tpu"), (path, mod)
