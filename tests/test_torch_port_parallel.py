"""The port's parallel layer (``diff3d_tpu_torch/parallel/``) held against
the JAX package's (``diff3d_tpu/parallel/``) on the CPU.

The mesh config field for field; the ``fsdp`` placement of every leaf of
the test-size X-UNet against ``diff3d_tpu.parallel.param_sharding`` on 2
of the conftest's virtual devices, through the port's kernel permutation;
``topology_summary``; the per-host train and ``permute`` val streams
against the JAX ``InfiniteLoader(host_id, num_hosts)`` (exact); the
transient-error markers of ``torch.distributed``; and, from one spawned
group of 2 gloo ranks (``_torch_port_parallel_worker.attention``), ring
and Ulysses attention, values and gradients, against the JAX package's
``ring_sdpa`` / ``ulysses_sdpa`` in ``shard_map`` (``impl="einsum"``) and
against unsharded plain attention, and the ``AttnLayer`` with ``ring:`` /
``ulysses:`` cores against the unsharded layer, at 1e-5 in f32.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict
from jax.sharding import Mesh, PartitionSpec as P

torch = pytest.importorskip("torch")

import _torch_port_parallel_worker as worker  # noqa: E402
from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.data import InfiniteLoader as JLoader  # noqa: E402
from diff3d_tpu.data import SyntheticDataset as JSynthetic  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from diff3d_tpu.parallel import param_sharding as j_param_sharding  # noqa: E402
from diff3d_tpu.parallel import ring_sdpa as j_ring_sdpa  # noqa: E402
from diff3d_tpu.parallel import shard_map  # noqa: E402
from diff3d_tpu.parallel import ulysses_sdpa as j_ulysses_sdpa  # noqa: E402
from diff3d_tpu_torch import config as pconfig  # noqa: E402
from diff3d_tpu_torch.convert.from_jax import port_key  # noqa: E402
from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset  # noqa: E402
from diff3d_tpu_torch.models.layers import AttnLayer  # noqa: E402
from diff3d_tpu_torch.ops.cuda_attention import attention_reference  # noqa: E402
from diff3d_tpu_torch.parallel import (fsdp_dim, make_mesh,  # noqa: E402
                                       maybe_initialize_distributed)
from diff3d_tpu_torch.parallel import ring_attention  # noqa: E402
from diff3d_tpu_torch.parallel.mesh import flax_dims  # noqa: E402
from diff3d_tpu_torch.parallel.multihost import launch_env  # noqa: E402
from diff3d_tpu_torch.runtime.retry import (RetryBudget,  # noqa: E402
                                            is_transient_backend_error)
from diff3d_tpu_torch.testing.distributed import spawn  # noqa: E402
from diff3d_tpu_torch.train.step import GradSync  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


from _torch_port_threads import one_thread  # noqa: E402,F401


# ---- the mesh config ------------------------------------------------

def test_mesh_config_matches_the_jax_package_field_for_field():
    ref = [(f.name, f.default) for f in
           dataclasses.fields(jconfig.MeshConfig)]
    got = [(f.name, f.default) for f in
           dataclasses.fields(pconfig.MeshConfig)]
    assert got == ref
    for make in ("srn64_config", "srn128_config", "test_config"):
        assert dataclasses.asdict(getattr(pconfig, make)().mesh) == \
            dataclasses.asdict(getattr(jconfig, make)().mesh)


# The tensor- and context-parallel cases (``why`` None) were refusals
# until the model axis and the row split were ported; their ids are kept.
@pytest.mark.parametrize("kw,why", [
    (dict(context_parallel=True), "model_parallel > 1"),
    (dict(param_sharding="tp"), None),
    (dict(param_sharding="fsdp+tp"), None),
    (dict(model_parallel=2), None),
    (dict(model_parallel=2, context_parallel=True), None),
    (dict(param_sharding="zero3"), "not in"),
    (dict(model_parallel=2, context_parallel=True, param_sharding="fsdp"),
     "A10b"),
    (dict(model_parallel=2, context_parallel=True, param_sharding="tp"),
     "A10b"),
    (dict(model_parallel=2, context_parallel=True,
          param_sharding="fsdp+tp"), "A10b"),
], ids=["kw0-model_parallel > 1", "kw1-A10b", "kw2-A10b", "kw3-A10b",
        "kw4-A10b", "kw5-not in", "kw6-cp-fsdp-A10b", "kw7-cp-tp-A10b",
        "kw8-cp-fsdp+tp-A10b"])
def test_mesh_config_refusals(kw, why):
    """The ``tp`` / ``fsdp+tp`` placements, a model axis and context
    parallelism over it validate, as they do in the JAX package; context
    parallelism with a sharded placement stays refused, naming ROADMAP
    A10b."""
    cfg = dataclasses.replace(pconfig.test_config(),
                              mesh=pconfig.MeshConfig(**kw))
    if why is None:
        cfg.validate()
        dataclasses.replace(jax_tiny_config(),
                            mesh=jconfig.MeshConfig(**kw)).validate()
        return
    with pytest.raises(ValueError, match=why):
        cfg.validate()
    if kw == dict(context_parallel=True):      # the JAX package's check
        jcfg = dataclasses.replace(jax_tiny_config(),
                                   mesh=jconfig.MeshConfig(**kw))
        with pytest.raises(ValueError, match="model_parallel > 1"):
            jcfg.validate()


# ---- the fsdp placement ---------------------------------------------

@pytest.fixture(scope="module")
def flax_shapes():
    """``{Flax path: shape}`` of the test-size X-UNet's parameters."""
    jcfg = jax_tiny_config()
    H = jcfg.model.H
    dummy = {"x": np.zeros((1, H, H, 3), np.float32),
             "z": np.zeros((1, H, H, 3), np.float32),
             "logsnr": np.zeros((1, 2), np.float32),
             "R": np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3)),
             "t": np.zeros((1, 2, 3), np.float32),
             "K": np.broadcast_to(np.eye(3, dtype=np.float32), (1, 3, 3))}
    tree = jax.eval_shape(lambda: JXUNet(jcfg.model).init(
        jax.random.PRNGKey(0), dummy, cond_mask=np.ones(1, bool)))
    return {k: tuple(v.shape) for k, v in
            flatten_dict(tree["params"], sep="/").items()}


def _port_dim(path: str, shape: tuple, j: int) -> int:
    """The port dim that Flax dim ``j`` of leaf ``path`` becomes, found by
    carrying a probe through the converter (``convert/from_jax.py``): the
    leaf holds its index along dim ``j``."""
    probe = np.arange(shape[j], dtype=np.float32).reshape(
        [-1 if d == j else 1 for d in range(len(shape))])
    _, t = port_key(path, np.broadcast_to(probe, shape).copy())
    varies = [d for d in range(t.dim()) if t.shape[d] == shape[j]
              and not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
    assert len(varies) == 1, (path, shape, j)
    return varies[0]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_placement_of_every_leaf_matches_the_jax_package(flax_shapes,
                                                               n):
    """Each leaf's sharded dim: the JAX package's ``param_sharding`` on
    ``n`` virtual devices, carried through the converter's kernel
    permutation, equals the port's ``fsdp_dim`` on the port's shape."""
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1),
                ("data", "model"))
    sharded = 0
    for path, shape in flax_shapes.items():
        name, tensor = port_key(path, np.zeros(shape, np.float32))
        spec = tuple(j_param_sharding(mesh, shape, "data").spec)
        want = next((i for i, s in enumerate(spec) if s == "data"), None)
        if want is not None:
            assert flax_dims(name, tensor.shape)[want] == \
                _port_dim(path, shape, want)
            want = _port_dim(path, shape, want)
            sharded += 1
        assert fsdp_dim(name, tensor.shape, n) == want, (path, shape)
    assert sharded > 0


def test_spec_table_follows_the_policy(flax_shapes):
    model_names = {port_key(p, np.zeros(s, np.float32))[0]
                   for p, s in flax_shapes.items()}
    from diff3d_tpu_torch.models import XUNet

    model = XUNet(pconfig.test_config().model)
    table = make_mesh(pconfig.MeshConfig()).param_spec_table(model)
    assert set(table) == model_names
    assert set(table.values()) == {"()"}      # one process: replicated


def test_topology_summary_has_the_jax_packages_keys():
    ref = j_make_mesh(jconfig.MeshConfig(), devices=jax.devices()[:2])
    got = make_mesh(pconfig.MeshConfig()).topology_summary()
    assert sorted(got) == sorted(ref.topology_summary())
    assert got == {"axes": {"data": 1, "model": 1}, "n_devices": 1,
                   "n_processes": 1, "param_sharding": "replicated"}


def test_make_mesh_refuses_more_ranks_than_there_are():
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(pconfig.MeshConfig(data_parallel=2))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        j_make_mesh(jconfig.MeshConfig(data_parallel=2),
                    devices=jax.devices()[:1])


def test_make_mesh_spans_every_rank(ranks):
    assert [r["data_ranks"] for r in ranks] == [0, 1]
    assert "spans every rank of the group" in ranks[0]["partial_mesh"]


def test_one_process_brings_up_no_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert launch_env() is None
    assert maybe_initialize_distributed(device="cpu") is False
    assert launch_env({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": "29500"}) == {
        "rank": 1, "world_size": 2, "local_rank": 1,
        "init_method": "tcp://127.0.0.1:29500"}


# ---- the per-host streams -------------------------------------------

@pytest.mark.parametrize("mode", ["iid", "permute"])
@pytest.mark.parametrize("hosts", [2, 4])
def test_per_host_streams_match_the_jax_loader(mode, hosts):
    """Each host's batches equal the JAX loader's for the same (host_id,
    num_hosts), exactly, and the hosts' slices concatenate to the one-host
    global batch."""
    per = 8 // hosts
    port_ds = SyntheticDataset(num_objects=5, num_views=4, imgsize=8)
    ref_ds = JSynthetic(num_objects=5, num_views=4, imgsize=8)
    whole = InfiniteLoader(port_ds, 8, seed=3, num_workers=0,
                           sample_mode=mode, start_step=1)
    for step in (1, 2):
        parts = []
        for h in range(hosts):
            got = InfiniteLoader(port_ds, per, seed=3, host_id=h,
                                 num_hosts=hosts, num_workers=0,
                                 sample_mode=mode).batch(step)
            want = JLoader(ref_ds, per, seed=3, host_id=h, num_hosts=hosts,
                           num_workers=0, sample_mode=mode)._batch(step)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            parts.append(got)
        full = next(whole)
        for k in full:
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), full[k])


def test_loader_refuses_a_host_outside_the_hosts():
    ds = SyntheticDataset(num_objects=2, num_views=2, imgsize=8)
    with pytest.raises(ValueError, match="host_id"):
        InfiniteLoader(ds, 2, host_id=2, num_hosts=2, num_workers=0)


# ---- retry markers --------------------------------------------------

@pytest.mark.parametrize("exc,transient", [
    (RuntimeError("NCCL error: remote process exited or there was a "
                  "network error, NCCL version 2.21.5 ncclRemoteError"),
     True),
    (RuntimeError("NCCL error in: ProcessGroupNCCL.cpp: unhandled system "
                  "error (ncclSystemError)"), True),
    (RuntimeError("NCCL error: internal check failed "
                  "(ncclInternalError)"), False),
    (RuntimeError("NCCL error: invalid usage (ncclInvalidUsage)"), False),
    (RuntimeError("[c10d] The client socket has timed out after 600s "
                  "while trying to connect to (127.0.0.1, 29500)"), True),
    (RuntimeError("Connection closed by peer [127.0.0.1]:43121"), True),
    (RuntimeError("Connection reset by peer"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered; "
                  "NCCL ncclRemoteError"), False),
    (ValueError("bad shape"), False),
])
def test_distributed_fault_markers(exc, transient):
    assert is_transient_backend_error(exc) is transient


def test_rendezvous_and_store_errors_are_transient():
    import torch.distributed as dist

    for cls in (dist.DistNetworkError, dist.DistStoreError):
        assert is_transient_backend_error(cls("store down"))


def test_retry_budget_semantics():
    b = RetryBudget(2)
    assert b.remaining == 2
    assert b.spend() is True
    assert b.remaining == 1
    assert b.spend() is False
    b.reset()
    assert b.remaining == 2
    with pytest.raises(ValueError):
        RetryBudget(0)


# ---- ring and Ulysses at 2 ranks ------------------------------------

@pytest.fixture(scope="module")
def ranks():
    return spawn("_torch_port_parallel_worker:attention", 2)


def _global(ranks, name, i):
    return np.concatenate([r[name][i] for r in ranks], axis=1)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's ring and Ulysses on 2 virtual devices inside ``shard_map``
    (``impl="einsum"``): outputs and gradients of ``sum(out * w)``."""
    q, k, v, w = (jnp.asarray(t) for t in worker.attention_inputs())
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    spec = P(None, "seq")
    out = {}
    for name, core in (
            ("ring", lambda q, k, v: j_ring_sdpa(q, k, v, "seq",
                                                 impl="einsum")),
            ("ulysses", lambda q, k, v: j_ulysses_sdpa(q, k, v, "seq"))):
        fn = shard_map(core, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=spec)
        o, vjp = jax.vjp(jax.jit(fn), q, k, v)
        out[name] = [np.asarray(t) for t in (o, *vjp(w))]
    return out


@pytest.fixture(scope="module")
def unsharded():
    q, k, v, w = (torch.from_numpy(t) for t in worker.attention_inputs())
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = attention_reference(q, k, v)
    (o * w).sum().backward()
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


def test_ring_engines_have_no_fallback():
    """``'cuda'`` (the default) is the flash wrapper, whose plain version
    runs on a CPU tensor of any shape (on the card such shapes raise);
    ``'einsum'`` is the plain engine; nothing picks between them."""
    assert ring_attention.IMPLS == ("cuda", "einsum")
    impl = inspect.signature(ring_attention.ring_sdpa).parameters["impl"]
    assert impl.default == "cuda"
    wide = torch.zeros(1, 2, 1, 1024)            # D above the kernel's 512
    pick = ring_attention._pick_engine
    assert pick(wide, wide, wide, "cuda") is ring_attention.block_olse_flash
    assert pick(wide, wide, wide, "einsum") is \
        ring_attention.block_olse_einsum
    with pytest.raises(ValueError, match="not in"):
        pick(wide, wide, wide, "auto")


def test_grad_bucket_without_a_group():
    """The train step's gradient bucket serves the one-process step too:
    the gradients are aligned views of it, ``reduce`` moves nothing, and
    ``zero`` makes the views the ``.grad`` again after a caller dropped
    them."""
    a = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(2, 70))
    sync = GradSync([a, b])
    assert sync.world == 1
    assert a.grad.data_ptr() == sync.flat.data_ptr()
    assert b.grad.data_ptr() - sync.flat.data_ptr() == GradSync.ALIGN * 4
    b.grad.fill_(2.0)
    sync.total.fill_(5.0)
    sync.reduce()
    assert float(b.grad.sum()) == 280.0 and float(sync.total) == 5.0
    b.grad = None
    sync.zero()
    assert b.grad is sync.grads[1] and float(sync.flat.abs().sum()) == 0.0


CORES = [("ring_einsum", "ring"), ("ring_cuda", "ring"),
         ("ulysses", "ulysses")]


@pytest.mark.parametrize("i", [0, 1, 2, 3], ids=["out", "dq", "dk", "dv"])
@pytest.mark.parametrize("port,ref", CORES, ids=[c[0] for c in CORES])
def test_sequence_parallel_matches_jax_shard_map(ranks, jax_sharded, port,
                                                 ref, i):
    np.testing.assert_allclose(_global(ranks, port, i),
                               jax_sharded[ref][i], **TOL)


@pytest.mark.parametrize("i", [0, 1, 2, 3], ids=["out", "dq", "dk", "dv"])
@pytest.mark.parametrize("port", [c[0] for c in CORES])
def test_sequence_parallel_matches_unsharded_attention(ranks, unsharded,
                                                       port, i):
    np.testing.assert_allclose(_global(ranks, port, i), unsharded[i], **TOL)


def test_ulysses_refuses_indivisible_heads(ranks):
    assert ranks[0]["indivisible"] == "heads 3 not divisible by axis size 2"
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    three = jnp.zeros((2, 8, 3, 8))
    fn = shard_map(lambda q, k, v: j_ulysses_sdpa(q, k, v, "seq"),
                   mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                   out_specs=P(None, "seq"))
    with pytest.raises(ValueError, match=ranks[0]["indivisible"]):
        fn(three, three, three)


@pytest.mark.parametrize("impl", ["ring:data", "ulysses:data"])
def test_attn_layer_sequence_parallel_matches_the_unsharded_layer(ranks,
                                                                   impl):
    layer = AttnLayer(worker.LAYER_SHAPE[2], num_heads=4)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in
                           ranks[0]["layer_state"].items()})
    layer.kernels = "torch"
    x = torch.from_numpy(np.random.RandomState(1).randn(
        *worker.LAYER_SHAPE).astype(np.float32))
    with torch.no_grad():
        want = layer(x, x).numpy()
    got = np.concatenate([r[f"layer_{impl}"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, **TOL)
