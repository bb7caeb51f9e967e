"""Tensor parallelism of the port (the ``tp`` / ``fsdp+tp`` placements
over the mesh's model axis) on the CPU over gloo, held against the JAX
package and against one process.

  * The placement of every leaf of the test-size X-UNet equals the JAX
    package's ``tp_param_sharding`` (mp 2 and 4, and ``fsdp+tp`` at
    dp2 x mp2), through the converter's kernel permutation; the spec
    tables the ranks report are that rule.
  * Layers on 2 ranks against the unsharded layer, outputs and every
    gradient at 1e-5 (f32): a ResnetBlock with FiLM, dropout and its skip
    projection; attention with the heads split and with 3 heads over 2
    ranks; a GroupNorm whose groups do not split; the up path's
    concatenation.  FiLM at mp 2 and 4: each rank modulates its own
    channels with its own ``scale`` and ``shift``.
  * The whole X-UNet forward at mp 2, mp 4 and dp2 x mp2 ``fsdp+tp``
    against the JAX package's forward under the same ``MeshConfig`` on the
    virtual CPU mesh, with the same carried weights, at 1e-4 (the JAX
    package's own tolerance, ``tests/test_parallel.py:153``).
  * Three train steps at mp 2 from a mid-training checkpoint against one
    rank's: losses and every tensor at 1e-5 of its norm; checkpoints both
    ways between tp 2 and world 1, bit for bit; ``Sampler(mesh)``,
    ``eval_cli --mesh --model_parallel 2`` and ``train_cli
    --param_sharding tp --model_parallel 2`` under the group.

Two spawned groups (2 and 4 ranks) run ``tests/_torch_port_tp_worker.py``
once each; the tests below assert on what they returned and wrote.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.tree_util import DictKey

torch = pytest.importorskip("torch")

import _torch_port_parallel_worker as dp_worker  # noqa: E402
import _torch_port_tp_worker as worker  # noqa: E402
from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from diff3d_tpu.parallel.mesh import tp_param_sharding  # noqa: E402
from diff3d_tpu_torch.config import MeshConfig  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.convert.from_jax import port_key  # noqa: E402
from diff3d_tpu_torch.models import build_model  # noqa: E402
from diff3d_tpu_torch.parallel import make_mesh, tp_dims  # noqa: E402
from diff3d_tpu_torch.parallel.mesh import block_of, flax_dims  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.testing.distributed import spawn  # noqa: E402
from diff3d_tpu_torch.train import Trainer  # noqa: E402

from _torch_port_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)

# (data, model, policy) of each placement the tests hold.
MESHES = [(1, 2, "tp"), (1, 4, "tp"), (2, 2, "fsdp+tp")]


def _batch(B, H, seed=6):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(B, 2, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    K = np.broadcast_to(np.array([[19.0, 0, H / 2], [0, 19.0, H / 2],
                                  [0, 0, 1]], np.float32), (B, 3, 3))
    return {
        "x": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "z": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "logsnr": np.stack([np.full(B, 20.0), rng.uniform(-25, 25, B)],
                           1).astype(np.float32),
        "R": R, "t": rng.normal(0, 1.5, (B, 2, 3)).astype(np.float32),
        "K": np.array(K),
    }


@pytest.fixture(scope="module")
def flax_model():
    """The shallow tiny X-UNet's Flax leaves, every one random (the
    zero-initialised convs too), a batch of 4 and its mask."""
    jcfg = jax_tiny_config(imgsize=8, ch=8, shallow=True).model
    batch = _batch(4, 8)
    mask = np.array([True, False, True, True])
    shapes = jax.eval_shape(lambda: JXUNet(jcfg).init(
        jax.random.PRNGKey(0), batch, cond_mask=mask))["params"]
    rng = np.random.default_rng(5)
    flat = {k: (0.08 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in sorted(flatten_dict(shapes, sep="/").items())}
    return jcfg, flat, batch, mask


def _jax_mesh(dp, mp, policy):
    return j_make_mesh(jconfig.MeshConfig(data_parallel=dp, model_parallel=mp,
                                          param_sharding=policy),
                       devices=jax.devices()[:dp * mp])


def _jax_spec(mesh, path, shape, policy):
    keys = [DictKey(k) for k in path.split("/")]
    return tuple(tp_param_sharding(
        mesh, keys, shape, "model",
        fsdp_axis="data" if policy == "fsdp+tp" else None).spec)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, flax_model):
    """Both spawned groups, run at once: ``{"two": (workdir, [rank 0's
    results, rank 1's]), "four": (workdir, the 4 ranks' results)}`` (mp 2;
    then mp 4 and dp2 x mp2 ``fsdp+tp``, its training from the warm start
    in its workdir)."""
    from concurrent.futures import ThreadPoolExecutor

    _, flat, batch, mask = flax_model
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("tp2", "tp4")}
    dp_worker.write_warm_start(os.path.join(dirs["tp2"], "train"))
    dp_worker.write_warm_start(dirs["tp4"])
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(spawn, "_torch_port_tp_worker:group_of_two", 2,
                          dirs["tp2"], flat, batch, mask, timeout_s=600)
        four = pool.submit(spawn, "_torch_port_tp_worker:group_of_four", 4,
                           dirs["tp4"], flat, batch, mask, timeout_s=600)
        return {"two": (dirs["tp2"], two.result()),
                "four": (dirs["tp4"], four.result())}


@pytest.fixture(scope="module")
def two(groups):
    return groups["two"]


@pytest.fixture(scope="module")
def four(groups):
    return groups["four"]


# ---- placement --------------------------------------------------------

@pytest.mark.parametrize("dp,mp,policy", MESHES)
def test_placement_of_every_leaf_matches_the_jax_rule(flax_model, dp, mp,
                                                      policy):
    """Each leaf's model dim and data dim: the JAX package's
    ``tp_param_sharding`` on ``dp x mp`` virtual devices, through the
    converter's kernel permutation, equals the port's ``tp_dims`` on the
    port's shape."""
    _, flat, _, _ = flax_model
    mesh = _jax_mesh(dp, mp, policy).mesh
    split = {"model": 0, "data": 0}
    for path, leaf in flat.items():
        name, tensor = port_key(path, leaf)
        spec = _jax_spec(mesh, path, leaf.shape, policy)
        dims = flax_dims(name, tensor.shape)
        want = {axis: next((dims[i] for i, s in enumerate(spec)
                            if s == axis), None)
                for axis in ("model", "data")}
        got = tp_dims(name, tensor.shape, mp,
                      dp if policy == "fsdp+tp" else None)
        assert got == (want["model"], want["data"]), (path, spec)
        for axis in split:
            split[axis] += want[axis] is not None
    assert split["model"] > 0
    assert (split["data"] > 0) == (policy == "fsdp+tp")


@pytest.mark.parametrize("path,want", [
    ("middle/resnetblock/FiLM_0/Dense_0/kernel", 0),     # column
    ("middle/resnetblock/FiLM_0/Dense_0/bias", 0),
    ("middle/attnblock_self/attn/q_proj/kernel", 0),
    ("middle/attnblock_self/attn/out_proj/kernel", 1),   # row
    ("middle/attnblock_self/attn/out_proj/bias", None),  # added once
    ("middle/resnetblock/FrameGroupNorm_1/GroupNorm_0/scale", None),
    ("middle/resnetblock/FrameGroupNorm_1/GroupNorm_0/bias", None),
    ("conditioningprocessor/pos_emb", None),
    ("conditioningprocessor/level_conv_0/kernel", 0),
    ("last_conv/kernel", None),                          # 3 outputs
    ("last_conv/bias", None),
    ("stem_conv/kernel", 0)])
def test_named_leaves_take_the_megatron_placement(flax_model, path, want):
    _, flat, _, _ = flax_model
    name, tensor = port_key(path, flat[path])
    assert tp_dims(name, tensor.shape, 2)[0] == want


def _table(flat, dp, mp, policy):
    """The spec table the JAX rule gives, in the port's layout."""
    mesh = _jax_mesh(dp, mp, policy).mesh
    out = {}
    for path, leaf in flat.items():
        name, tensor = port_key(path, leaf)
        spec = _jax_spec(mesh, path, leaf.shape, policy)
        dims = flax_dims(name, tensor.shape)
        port = [None] * tensor.dim()
        for i, s in enumerate(spec):
            port[dims[i]] = s
        out[name] = "()" if not any(port) else str(tuple(port))
    return out


def test_spec_tables_of_the_ranks_are_the_jax_rule(flax_model, two, four):
    _, flat, _, _ = flax_model
    _, (r0, r1) = two
    assert r0["spec"] == r1["spec"] == _table(flat, 1, 2, "tp")
    for r in four[1]:
        assert r["spec_tp4"] == _table(flat, 1, 4, "tp")
        assert r["spec_fsdp_tp"] == _table(flat, 2, 2, "fsdp+tp")


def test_ranks_hold_their_blocks(flax_model, two):
    """Each rank's parameter is its block: half the whole leaf along the
    split dim, the whole leaf elsewhere; ``fsdp+tp`` wraps the data-split
    leaves in FSDP2."""
    _, flat, _, _ = flax_model
    _, (r0, _) = two
    for path, leaf in flat.items():
        name, tensor = port_key(path, leaf)
        d = tp_dims(name, tensor.shape, 2)[0]
        want = list(tensor.shape)
        if d is not None:
            want[d] //= 2
        assert list(r0["local_shapes"][name]) == want, name
    assert r0["topology"] == {"axes": {"data": 1, "model": 2},
                              "n_devices": 2, "n_processes": 2,
                              "param_sharding": "tp"}
    assert [r0["model_rank"], two[1][1]["model_rank"]] == [0, 1]


def test_converter_carries_the_whole_tree_then_places(flax_model, two):
    """``load_flax_params(..., placement=env)``: each rank's parameter is
    its block of the carried tensor (FiLM's per half); a whole JAX train
    state carried into the split state gathers back to the carried
    tensors."""
    _, flat, _, _ = flax_model
    _, ranks = two
    for path, leaf in flat.items():
        name, whole = port_key(path, leaf)
        d = tp_dims(name, whole.shape, 2)[0]
        for r, got in enumerate(ranks):
            want = whole if d is None else block_of(
                whole, d, r, 2, name in got["halved"])
            np.testing.assert_array_equal(got["carried"][name],
                                          want.numpy(), err_msg=name)
        state = ranks[0]["carried_state"]
        for kind, f in (("model", 1.0), ("ema", 0.5)):
            np.testing.assert_array_equal(
                state[f"{kind}.{name}"], port_key(path, f * leaf)[1].numpy())
        for key, f in (("exp_avg", 1e-3), ("exp_avg_sq", 1e-4)):
            np.testing.assert_array_equal(
                state[f"adam.{name}.{key}"],
                port_key(path, f * leaf)[1].numpy())
    assert any("FiLM_0.Dense_0" in n for n in ranks[0]["halved"])


def test_fsdp_tp_shards_over_both_axes(four):
    _, ranks = four
    assert sorted(r["ranks"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    assert all(r["dtensors"] > 0 for r in ranks)


# ---- layers -----------------------------------------------------------

@pytest.fixture(scope="module")
def unsharded():
    return worker.unsharded_layers()


@pytest.mark.parametrize("case", list(worker.layer_cases()))
def test_layer_matches_the_unsharded_layer(two, unsharded, case):
    want = unsharded[case]
    for r in two[1]:
        got = r["layers"][case]
        np.testing.assert_allclose(got["out"], want["out"], **TOL)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for n, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][n], g, err_msg=n, **TOL)
        for a, b in zip(got["input_grads"], want["input_grads"]):
            np.testing.assert_allclose(a, b, **TOL)


def test_up_path_concatenation_keeps_the_channel_order(two):
    """Two channel blocks joined ``[h, skip]``: the next block sees the
    unsharded model's channel order (the output, both inputs' gradients
    and every parameter's at 1e-5)."""
    want = worker.concat_case()
    for r in two[1]:
        got = r["concat"]
        for key in ("out", "dh", "dskip"):
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **TOL)
        for n, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][n], g, err_msg=n, **TOL)


@pytest.mark.parametrize("mp", [2, 4])
def test_film_applies_each_ranks_own_scale_and_shift(two, four, mp):
    """FiLM's Dense emits ``[scale | shift]``: rank ``r`` of ``mp`` gets
    ``scale`` and ``shift`` of its own channel block ``c_r`` (the JAX
    layout's contiguous block would give rank 0 all of ``scale`` at
    mp 2)."""
    want = worker.film_case()
    ranks = two[1] if mp == 2 else four[1]
    F = want["scale"].shape[-1]
    c = F // mp
    for r, got in enumerate(ranks):
        f = got["film"]
        assert f["halves"] and f["scale"].shape[-1] == c
        block = slice(r * c, (r + 1) * c)
        np.testing.assert_allclose(f["scale"], want["scale"][..., block],
                                   **TOL)
        np.testing.assert_allclose(f["shift"], want["shift"][..., block],
                                   **TOL)


# ---- the whole forward ------------------------------------------------

def _jax_forward(flax_model, dp, mp, policy):
    jcfg, flat, batch, mask = flax_model
    env = _jax_mesh(dp, mp, policy)
    params = unflatten_dict(flat, sep="/")
    model = JXUNet(jcfg)
    p_sh = jax.device_put(params, env.params(params))
    b_sh = jax.device_put(batch, env.batch())
    m_sh = jax.device_put(mask, env.batch())
    fwd = jax.jit(lambda p, b, m: model.apply({"params": p}, b,
                                              cond_mask=m))
    return np.asarray(fwd(p_sh, b_sh, m_sh))


@pytest.mark.parametrize("dp,mp,policy", MESHES)
def test_whole_forward_matches_the_jax_package(flax_model, two, four, dp,
                                               mp, policy):
    want = _jax_forward(flax_model, dp, mp, policy)
    if mp == 2 and dp == 1:
        outs = [r["forward"] for r in two[1]]
        for got in outs:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(outs[0], outs[1])
    elif mp == 4:
        for r in four[1]:
            np.testing.assert_allclose(r["forward_tp4"], want, atol=1e-4,
                                       rtol=1e-4)
    else:
        rows = {r["ranks"]: r["forward_fsdp_tp"] for r in four[1]}
        got = np.concatenate([rows[(0, 0)], rows[(1, 0)]])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        for d in (0, 1):
            np.testing.assert_array_equal(rows[(d, 0)], rows[(d, 1)])


# ---- training and checkpoints -----------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The same 3 steps at 1 rank from the same warm start."""
    cfg = dp_worker.tiny_config()
    env = make_mesh(cfg.mesh)
    workdir = str(tmp_path_factory.mktemp("tp1"))
    dp_worker.write_warm_start(workdir)
    tr = Trainer(cfg, workdir=workdir, device="cpu", env=env, transfer=True)
    tr.loader = dp_worker._Batches(dp_worker.loader(cfg, env))
    tr.train()
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        losses = [json.loads(x)["loss"] for x in f]
    return dp_worker.state_arrays(tr.state), losses


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("kind", ["model.", "ema.", "adam."])
def test_tp_training_follows_the_one_rank_trajectory(two, one_rank, kind):
    _, (r0, r1) = two
    want, losses = one_rank
    got = {k: v for k, v in r0["trained"].items() if k.startswith(kind)}
    assert got and sorted(got) == sorted(k for k in want
                                         if k.startswith(kind))
    worst = max((_rel(got[k], want[k]), k) for k in got)
    assert worst[0] <= 1e-5, worst
    for k, v in got.items():                 # both ranks hold the same
        np.testing.assert_array_equal(v, r1["trained"][k])
    assert len(r0["losses"]) == len(losses) == 3
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    assert r0["graphs"] is False and r0["ckpt_steps"] == [0, 2, 3]


@pytest.mark.parametrize("kind", ["model.", "ema.", "adam."])
def test_fsdp_tp_training_at_dp2_mp2_follows_one_rank(four, one_rank,
                                                      kind):
    """dp2 x mp2 ``fsdp+tp``: the step's data group is the data axis (2
    ranks, this rank's data index), each data rank trains its rows of the
    global batch, and the 3 steps follow one rank's at 1e-5; every rank
    holds the same gathered state."""
    _, ranks = four
    want, losses = one_rank
    byrank = {r["ranks"]: r for r in ranks}
    for (d, m), r in byrank.items():
        assert r["fsdp_tp_restored_step"] == 0
        assert r["step_group_size"] == (d, 2)
    got = {k: v for k, v in byrank[(0, 0)]["fsdp_tp_trained"].items()
           if k.startswith(kind)}
    assert got and sorted(got) == sorted(k for k in want
                                         if k.startswith(kind))
    worst = max((_rel(got[k], want[k]), k) for k in got)
    assert worst[0] <= 1e-5, worst
    for r in ranks:
        for k, v in got.items():
            np.testing.assert_array_equal(v, r["fsdp_tp_trained"][k])
    np.testing.assert_allclose(byrank[(0, 0)]["fsdp_tp_losses"], losses,
                               rtol=1e-5)


def test_fsdp_tp_checkpoint_restores_at_world_one(four):
    """The dp2 x mp2 run's last checkpoint (gathered over both axes)
    restored at world 1: bit for bit the run's final state."""
    workdir, ranks = four
    tr = Trainer(dp_worker.tiny_config(), workdir=workdir, device="cpu",
                 transfer=True)
    assert tr.state.step == 3
    got = dp_worker.state_arrays(tr.state)
    want = ranks[0]["fsdp_tp_trained"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert tr.ckpt.last_restore_reshard["from"]["axes"] == {"data": 2,
                                                            "model": 2}


def test_stop_agreement_spans_the_model_axis(two):
    """At dp1 x mp2 a signal seen by one model rank stops both at one
    step (the data axis alone has one rank)."""
    workdir, ranks = two
    assert [r["stop"]["step"] for r in ranks] == [2, 2]
    assert ranks[0]["stop"]["saved"] == [2]          # rank 0 writes
    assert os.listdir(os.path.join(workdir, "stop", "checkpoints")) == [
        "ckpt_2.pt"]


def test_world_one_checkpoint_restores_at_tp2(two):
    """The warm start (a world-1 ``full`` checkpoint) restored into the
    split state: gathered again, bit for bit the file's tensors."""
    workdir, (r0, _) = two
    assert r0["restored_step"] == 0
    saved = torch.load(os.path.join(workdir, "train", "checkpoints",
                                    "ckpt_0.pt"), weights_only=True)
    names = list(saved["model"])
    for k, v in saved["model"].items():
        np.testing.assert_array_equal(r0["restored"][f"model.{k}"],
                                      v.numpy(), err_msg=k)
        np.testing.assert_array_equal(r0["restored"][f"ema.{k}"],
                                      saved["ema"][k].numpy(), err_msg=k)
    for i, st in saved["optim"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(
                r0["restored"][f"adam.{names[i]}.{key}"], st[key].numpy())


def test_tp2_checkpoint_restores_at_world_one_and_at_tp2(two):
    """The step-3 checkpoint of the mp-2 run (gathered, written by rank 0)
    restored at world 1 and again at mp 2: bit for bit the run's final
    state, the reshard recorded at world 1."""
    workdir, (r0, r1) = two
    cfg = dp_worker.tiny_config()
    tr = Trainer(cfg, workdir=os.path.join(workdir, "train"), device="cpu",
                 transfer=True)
    assert tr.state.step == 3
    got = dp_worker.state_arrays(tr.state)
    assert sorted(got) == sorted(r0["trained"])
    for k, v in r0["trained"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        for r in (r0, r1):
            np.testing.assert_array_equal(r["again"][k], v, err_msg=k)
    assert r0["again_step"] == 3
    # The next update's lr: the saved one, as one process restores it.
    lr = float(tr.state.optimizer.param_groups[0]["lr"])
    assert r0["again_lr"] == r1["again_lr"] == lr
    assert lr == tr.step_fn.sched(3) != tr.step_fn.sched(0)
    event = tr.ckpt.last_restore_reshard
    assert event["from"]["axes"] == {"data": 1, "model": 2}
    assert event["from"]["param_sharding"] == "tp"
    assert event["to"]["axes"] == {"data": 1, "model": 1}


# ---- sampling and the entry points ------------------------------------

def test_sampler_mesh_matches_one_process(two):
    _, (r0, r1) = two
    assert r0["lane_multiple"] == 1 and r0["sampler_graphs"] is False
    cfg = dp_worker.tiny_config()
    torch.manual_seed(0)
    sampler = Sampler(build_model(cfg.model, "cpu"), cfg, device="cpu",
                      cuda_graphs=False)
    want = sampler.synthesize_many(
        dp_worker.sampler_views(),
        [torch.Generator().manual_seed(10 + i) for i in range(3)],
        max_views=3)
    assert r0["views"].shape == want.shape
    np.testing.assert_array_equal(r0["views"], r1["views"])
    np.testing.assert_allclose(r0["views"], want, rtol=1e-4, atol=1e-4)


def test_tp_mesh_of_one_process_splits_nothing():
    """One process has no model axis: a tp mesh there splits nothing and
    the sampler keeps its graphs setting."""
    cfg = dataclasses.replace(dp_worker.tiny_config(),
                              mesh=MeshConfig(param_sharding="tp"))
    env = make_mesh(cfg.mesh)
    assert not env.tensor_parallel and env.model_axis is None
    sampler = Sampler(build_model(cfg.model, "cpu"), cfg, device="cpu",
                      mesh=env, cuda_graphs=False)
    assert sampler.lane_multiple == 1


def test_train_cli_under_tp_trains_and_checkpoints(two):
    workdir, _ = two
    ckpts = os.path.join(workdir, "cli", "checkpoints")
    assert os.listdir(ckpts) == ["ckpt_2.pt"]
    saved = torch.load(os.path.join(ckpts, "ckpt_2.pt"), weights_only=True)
    assert saved["mesh"]["axes"] == {"data": 1, "model": 2}
    assert saved["mesh"]["param_sharding"] == "tp"
    assert saved["step"] == 2
    model = build_model(port_tiny_config(imgsize=8).model, "cpu")
    assert {n: tuple(v.shape) for n, v in saved["model"].items()} == {
        n: tuple(p.shape) for n, p in model.named_parameters()}  # whole
    with open(os.path.join(workdir, "cli", "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 2       # rank 0 alone logs


def test_eval_cli_mesh_model_parallel_matches_one_process(two, tmp_path):
    from diff3d_tpu_torch.cli import eval_cli

    workdir, _ = two
    with open(os.path.join(workdir, "cli", "eval.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    out = str(tmp_path / "one.jsonl")
    eval_cli.main(["--device", "cpu", "--config", "test", "--imgsize", "8",
                   "--model", os.path.join(workdir, "cli", "checkpoints"),
                   "--synthetic_scenes", "--objects", "3", "--max_views",
                   "3", "--steps", "4", "--out", out])
    with open(out) as f:
        want = json.loads(f.read())
    assert got["checkpoint_step"] == want["checkpoint_step"] == 2
    assert len(got["per_object"]) == len(want["per_object"]) == 3
    for key in ("psnr", "ssim"):
        assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key])


def test_eval_cli_refuses_model_parallel_without_mesh():
    from diff3d_tpu_torch.cli import eval_cli

    with pytest.raises(SystemExit, match="take --mesh"):
        eval_cli.main(["--device", "cpu", "--config", "test", "--model",
                       "none", "--synthetic_scenes", "--model_parallel",
                       "2"])
