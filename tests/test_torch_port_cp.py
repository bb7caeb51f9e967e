"""Context parallelism of the port (``MeshConfig.context_parallel``: the
activations' image rows split over the mesh's model axis, the
``replicated`` placement) on the CPU over gloo, held against the JAX
package and against one process.

  * Layers on 2 ranks (and 4) against the unsplit layer: a 3x3 conv at
    stride 1 (the halo) and the stride-2 / stride-4 level convs (the row
    above) at 1e-6, outputs and the gradients summed over the ranks; the
    split-statistics GroupNorm, all four variants, its statistics equal
    one process's and every gradient at 1e-5; self and cross attention
    with gathered K/V at 1e-5, also at dp2 x mp2 (the model-rank token
    order); a ResnetBlock with FiLM, dropout and a downsample.
  * Every block's output holds ``h / mp`` rows.
  * The whole X-UNet forward at mp 2, mp 4 and dp2 x mp2 against the JAX
    package's context-parallel forward (``activation_constraint``) on the
    virtual CPU mesh, with the same carried weights, at 1e-4.
  * Three train steps at mp 2 and at dp2 x mp2 from a mid-training
    checkpoint against one rank's at 1e-5 (model, EMA, Adam); two under
    each remat policy; checkpoints both ways between cp 2 and world 1, bit
    for bit; ``Sampler(mesh)``'s single-object view and ``train_cli
    --context_parallel --model_parallel 2`` under the group; the refusals.

Two spawned groups (2 and 4 ranks) run ``tests/_torch_port_cp_worker.py``
once each; the tests below assert on what they returned and wrote.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

import _torch_port_cp_worker as worker  # noqa: E402
import _torch_port_parallel_worker as dp_worker  # noqa: E402
from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from diff3d_tpu_torch.config import MeshConfig  # noqa: E402
from diff3d_tpu_torch.config import test_config as port_tiny_config  # noqa: E402
from diff3d_tpu_torch.models import build_model  # noqa: E402
from diff3d_tpu_torch.parallel import make_mesh  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.testing.distributed import spawn  # noqa: E402
from diff3d_tpu_torch.train import Trainer  # noqa: E402

from _torch_port_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-6, atol=1e-6)

# (data, model) of each mesh the whole forward is held at.
MESHES = [(1, 2), (1, 4), (2, 2)]


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
    zero-initialised convs too), a batch of 4 and its mask (the rows of
    its 8 x 8 images split at every level over 2 and 4 ranks)."""
    jcfg = jax_tiny_config(imgsize=8, ch=8, shallow=True).model
    batch = _batch(4, 8)
    mask = np.array([True, False, True, True])
    shapes = jax.eval_shape(lambda: JXUNet(jcfg).init(
        jax.random.PRNGKey(0), batch, cond_mask=mask))["params"]
    rng = np.random.default_rng(5)
    flat = {k: (0.08 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in sorted(flatten_dict(shapes, sep="/").items())}
    return jcfg, flat, batch, mask


@pytest.fixture(scope="module")
def groups(tmp_path_factory, flax_model):
    """Both spawned groups, run at once: ``{"two": (workdir, [rank 0's
    results, rank 1's]), "four": (workdir, the 4 ranks' results)}``."""
    from concurrent.futures import ThreadPoolExecutor

    _, flat, batch, mask = flax_model
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("cp2", "cp4")}
    for sub in ("train", "remat_nothing", "remat_dots"):
        dp_worker.write_warm_start(os.path.join(dirs["cp2"], sub))
    dp_worker.write_warm_start(dirs["cp4"])
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(spawn, "_torch_port_cp_worker:group_of_two", 2,
                          dirs["cp2"], flat, batch, mask, timeout_s=600)
        four = pool.submit(spawn, "_torch_port_cp_worker:group_of_four", 4,
                           dirs["cp4"], flat, batch, mask, timeout_s=600)
        return {"two": (dirs["cp2"], two.result()),
                "four": (dirs["cp4"], four.result())}


@pytest.fixture(scope="module")
def two(groups):
    return groups["two"]


@pytest.fixture(scope="module")
def four(groups):
    return groups["four"]


@pytest.fixture(scope="module")
def unsplit():
    return worker.unsplit_layers()


def _ranks(two, four, mesh):
    """``(the ranks' results, the key of their layer cases)`` at mesh
    ``"mp2"``, ``"mp4"`` or ``"dp2"`` (dp2 x mp2)."""
    return {"mp2": (two[1], "layers"), "mp4": (four[1], "layers_mp4"),
            "dp2": (four[1], "layers_dp2")}[mesh]


def _check_layer(ranks, key, case, want, tol):
    """Each rank's gathered output equals the unsplit layer's; the
    parameters' and inputs' gradients, summed over one model group's
    ranks (data rank 0's at dp2 x mp2), equal its gradients."""
    group = [r for r in ranks
             if key != "layers_dp2" or r["ranks"][0] == 0]
    for r in ranks:
        np.testing.assert_allclose(r[key][case]["out"], want["out"], **tol)
    got = [r[key][case] for r in group]
    assert sorted(got[0]["grads"]) == sorted(want["grads"])
    pairs = [(n, sum(x["grads"][n] for x in got), g)
             for n, g in want["grads"].items()]
    pairs += [(f"input {i}", sum(x["input_grads"][i] for x in got), g)
              for i, g in enumerate(want["input_grads"])]
    for name, a, b in pairs:
        if tol is CONV_TOL:
            # A sum over the rows in two parts: 1e-6 of the leaf's
            # largest magnitude (f32 spacing at ~18 is 1.9e-6).
            err = float(np.abs(a - b).max())
            assert err <= 1e-6 * (1 + float(np.abs(b).max())), (name, err)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **tol)


# ---- layers -----------------------------------------------------------

@pytest.mark.parametrize("case", ["conv3", "level_conv_s2", "level_conv_s4"])
def test_halo_convs_match_the_whole_conv(two, unsplit, case):
    """A rank's rows of a 3x3 conv at stride 1 (a halo row from each
    neighbour, zeros at the image's edges) and of the level convs at
    stride 2 and 4 (explicit padding 1: the row above only), and the
    gradients summed over the ranks (the halo's backward adds the
    neighbour's share to the edge rows), at 1e-6 (the gradients: of each
    leaf's largest magnitude)."""
    _check_layer(two[1], "layers", case, unsplit[case], CONV_TOL)


@pytest.mark.parametrize("mesh", ["mp2", "mp4"])
@pytest.mark.parametrize("case", list(worker.GN_VARIANTS))
def test_split_groupnorm_matches_the_whole_layer(two, four, unsplit, mesh,
                                                 case):
    """GroupNorm, GN -> SiLU, GN -> FiLM and GN -> FiLM -> SiLU on a
    rank's rows with the statistics summed over the ranks (f64 sums, then
    the one-rank f32 formula): the output, dx, dgamma, dbeta, dscale and
    dshift against the whole layer at 1e-5."""
    ranks, key = _ranks(two, four, mesh)
    _check_layer(ranks, key, case, unsplit[case], TOL)


@pytest.mark.parametrize("mesh", ["mp2", "mp4"])
def test_split_statistics_equal_one_process(two, four, mesh):
    ranks, _ = _ranks(two, four, mesh)
    want = worker.gn_stats()
    key = "stats" if mesh == "mp2" else "stats_mp4"
    for r in ranks:
        for name, s in want.items():
            np.testing.assert_allclose(r[key][name], s, rtol=1e-6,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mesh", ["mp2", "mp4", "dp2"])
@pytest.mark.parametrize("case", ["attn_self", "attn_cross"])
def test_attention_with_gathered_kv_matches_the_whole_layer(
        two, four, unsplit, mesh, case):
    """Self and cross attention on a rank's queries against every rank's
    keys and values (gathered in model-rank order; the backward sums the
    keys' gradients over the ranks), at 1e-5; at dp2 x mp2 the model
    group's ranks are not the global ranks' order."""
    ranks, key = _ranks(two, four, mesh)
    _check_layer(ranks, key, case, unsplit[case], TOL)
    if mesh == "dp2":
        for r in ranks:
            assert r["model_ranks"] == [2 * r["ranks"][0],
                                        2 * r["ranks"][0] + 1]


def test_resnet_block_with_dropout_and_downsample(two, unsplit):
    """FiLM, dropout (the whole activation's mask, this rank's rows of
    it) and the 2x2 downsample on even row blocks."""
    _check_layer(two[1], "layers", "resnet_down", unsplit["resnet_down"],
                 TOL)


def test_every_block_holds_its_rows(two):
    """Forward hooks: every block's output (and input) on a rank holds
    ``h / mp`` rows of its level."""
    cfg = worker.model_config().model
    H, levels = cfg.H, cfg.num_resolutions
    for r in two[1]:
        seen = r["block_rows"]
        assert seen["stem_conv"][0] == H // 2
        assert seen["last_gn"] == (H // 2, H // 2)
        assert seen["last_conv"][0] == H // 2
        for name, (rows_out, rows_in) in seen.items():
            parts = name.split("_")
            if name == "middle":
                level = levels - 1
                assert rows_out == rows_in == H // 2 ** level // 2
            elif parts[0] in ("down", "up") and parts[2].isdigit():
                level = int(parts[1])
                assert rows_out == H // 2 ** level // 2, name
            elif name.endswith("downsample"):
                level = int(parts[1])
                assert (rows_in, rows_out) == (H // 2 ** level // 2,
                                               H // 2 ** level // 4), name
            elif name.endswith("upsample"):
                level = int(parts[1])
                assert (rows_in, rows_out) == (H // 2 ** level // 2,
                                               H // 2 ** level), name
        assert len(seen) >= 8


# ---- the whole forward ------------------------------------------------

def _jax_forward(flax_model, dp, mp):
    """The JAX package's forward under ``context_parallel`` on ``dp x
    mp`` virtual devices: every block output constrained to ``P(data,
    None, model)``."""
    jcfg, flat, batch, mask = flax_model
    env = j_make_mesh(jconfig.MeshConfig(data_parallel=dp, model_parallel=mp,
                                         context_parallel=True),
                      devices=jax.devices()[:dp * mp])
    params = unflatten_dict(flat, sep="/")
    model = JXUNet(jcfg)
    constrain = env.activation_constraint()
    p_sh = jax.device_put(params, env.params(params))
    b_sh = jax.device_put(batch, env.batch())
    m_sh = jax.device_put(mask, env.batch())
    fwd = jax.jit(lambda p, b, m: model.apply(
        {"params": p}, b, cond_mask=m, constrain=constrain))
    return np.asarray(fwd(p_sh, b_sh, m_sh))


@pytest.mark.parametrize("dp,mp", MESHES)
def test_whole_forward_matches_the_jax_package(flax_model, two, four, dp,
                                               mp):
    want = _jax_forward(flax_model, dp, mp)
    if (dp, mp) == (1, 2):
        outs = [r["forward"] for r in two[1]]
        np.testing.assert_array_equal(outs[0], outs[1])
    elif mp == 4:
        outs = [r["forward_mp4"] for r in four[1]]
    else:
        rows = {r["ranks"]: r["forward_dp2"] for r in four[1]}
        for d in (0, 1):
            np.testing.assert_array_equal(rows[(d, 0)], rows[(d, 1)])
        outs = [np.concatenate([rows[(0, 0)], rows[(1, 0)]])]
    for got in outs:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---- training and checkpoints -----------------------------------------

def _one_rank(workdir, steps=None, **model_kw):
    cfg = dp_worker.tiny_config(**({} if steps is None
                                   else {"max_steps": steps}))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             **model_kw))
    env = make_mesh(cfg.mesh)
    dp_worker.write_warm_start(workdir)
    tr = Trainer(cfg, workdir=workdir, device="cpu", env=env, transfer=True)
    tr.loader = dp_worker._Batches(dp_worker.loader(cfg, env))
    tr.train()
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        losses = [json.loads(x)["loss"] for x in f]
    return dp_worker.state_arrays(tr.state), losses


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The same 3 steps at 1 rank from the same warm start."""
    return _one_rank(str(tmp_path_factory.mktemp("cp1")))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_trajectory(run, want, losses, kind):
    got = {k: v for k, v in run["state"].items() if k.startswith(kind)}
    assert got and sorted(got) == sorted(k for k in want
                                         if k.startswith(kind))
    worst = max((_rel(got[k], want[k]), k) for k in got)
    assert worst[0] <= 1e-5, worst
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-5)


@pytest.mark.parametrize("kind", ["model.", "ema.", "adam."])
def test_cp_training_follows_the_one_rank_trajectory(two, one_rank, kind):
    """mp 2: both ranks train the same data rows, each its image rows; the
    bucket is summed over the model axis and divided by the data size (1),
    model rank 1's loss left out of it; every rank ends with the same
    state, 1e-5 of one rank's."""
    _, (r0, r1) = two
    want, losses = one_rank
    _check_trajectory(r0["train"], want, losses, kind)
    for k, v in r0["train"]["state"].items():
        np.testing.assert_array_equal(v, r1["train"]["state"][k])
    assert r0["train"]["bucket"] == (1, True)
    assert r1["train"]["bucket"] == (1, False)
    assert r0["train"]["graphs"] is False and r0["eager_only"]
    assert r0["train"]["ckpt_steps"] == [0, 2, 3]
    assert len(r0["train"]["losses"]) == 3


@pytest.mark.parametrize("kind", ["model.", "ema.", "adam."])
def test_cp_training_at_dp2_mp2_follows_one_rank(four, one_rank, kind):
    """dp2 x mp2: each data rank trains its rows of the global batch, the
    bucket summed over all 4 ranks and divided by the data size 2."""
    _, ranks = four
    want, losses = one_rank
    byrank = {r["ranks"]: r for r in ranks}
    _check_trajectory(byrank[(0, 0)]["train_dp2"], want, losses, kind)
    for (d, m), r in byrank.items():
        assert r["train_dp2"]["bucket"] == (2, m == 0)
        for k, v in byrank[(0, 0)]["train_dp2"]["state"].items():
            np.testing.assert_array_equal(v, r["train_dp2"]["state"][k])


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_cp_training_under_remat(two, tmp_path, policy):
    """2 steps at mp 2 with every block rematerialised: the recompute
    re-runs the block's collectives and its dropout mask (this rank's rows
    of the whole mask, kept as bits), 1e-5 of one rank's run."""
    _, (r0, r1) = two
    want, losses = _one_rank(str(tmp_path), steps=2, remat=True,
                             remat_policy=policy)
    run = r0[f"remat_{policy}"]
    for kind in ("model.", "ema.", "adam."):
        _check_trajectory(run, want, losses, kind)
    for k, v in run["state"].items():
        np.testing.assert_array_equal(v, r1[f"remat_{policy}"]["state"][k])


def test_world_one_checkpoint_restores_at_cp2(two):
    """The warm start (a world-1 ``full`` checkpoint) restored at cp 2:
    every tensor bit for bit the file's, on each rank."""
    workdir, ranks = two
    saved = torch.load(os.path.join(workdir, "train", "checkpoints",
                                    "ckpt_0.pt"), weights_only=True)
    names = list(saved["model"])
    for r in ranks:
        assert r["restored_step"] == 0
        for k, v in saved["model"].items():
            np.testing.assert_array_equal(r["restored"][f"model.{k}"],
                                          v.numpy(), err_msg=k)
            np.testing.assert_array_equal(r["restored"][f"ema.{k}"],
                                          saved["ema"][k].numpy())
        for i, st in saved["optim"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(
                    r["restored"][f"adam.{names[i]}.{key}"],
                    st[key].numpy())


def test_cp2_checkpoint_restores_at_world_one_and_at_cp2(two):
    """The step-3 checkpoint of the mp-2 run (written by rank 0) restored
    at world 1 and again at mp 2: bit for bit the run's final state, the
    lr the saved one, the reshard recorded at world 1."""
    workdir, (r0, r1) = two
    tr = Trainer(dp_worker.tiny_config(),
                 workdir=os.path.join(workdir, "train"), device="cpu",
                 transfer=True)
    assert tr.state.step == 3
    got = dp_worker.state_arrays(tr.state)
    want = r0["train"]["state"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        for r in (r0, r1):
            np.testing.assert_array_equal(r["again"][k], v, err_msg=k)
    assert r0["again_step"] == r1["again_step"] == 3
    lr = float(tr.state.optimizer.param_groups[0]["lr"])
    assert r0["again_lr"] == r1["again_lr"] == lr
    event = tr.ckpt.last_restore_reshard
    assert event["from"]["axes"] == {"data": 1, "model": 2}
    assert event["from"]["param_sharding"] == "replicated"
    assert event["to"]["axes"] == {"data": 1, "model": 1}


# ---- sampling, the entry points and the refusals ----------------------

def test_sampler_single_object_view_matches_one_process(two):
    """``Sampler(mesh).synthesize`` under cp runs the single-object path
    split by rows (the output gathered every step), eagerly, both ranks
    the same views; against one process at 1e-4."""
    _, (r0, r1) = two
    assert r0["sampler_graphs"] is False and r0["split_calls"] > 0
    cfg = dp_worker.tiny_config()
    torch.manual_seed(0)
    sampler = Sampler(build_model(cfg.model, "cpu"), cfg, device="cpu",
                      cuda_graphs=False)
    want = sampler.synthesize(dp_worker.sampler_views()[0],
                              torch.Generator().manual_seed(10), max_views=3)
    assert r0["views"].shape == want.shape
    np.testing.assert_array_equal(r0["views"], r1["views"])
    np.testing.assert_allclose(r0["views"], want, rtol=1e-4, atol=1e-4)


def test_train_cli_context_parallel_trains_and_checkpoints(two):
    workdir, ranks = two
    assert ranks[0]["topology"] == {"axes": {"data": 1, "model": 2},
                                    "n_devices": 2, "n_processes": 2,
                                    "param_sharding": "replicated"}
    assert not ranks[0]["tensor_parallel"]
    ckpts = os.path.join(workdir, "cli", "checkpoints")
    assert os.listdir(ckpts) == ["ckpt_2.pt"]
    saved = torch.load(os.path.join(ckpts, "ckpt_2.pt"), weights_only=True)
    assert saved["mesh"]["axes"] == {"data": 1, "model": 2}
    assert saved["step"] == 2
    model = build_model(port_tiny_config(imgsize=16).model, "cpu")
    assert {n: tuple(v.shape) for n, v in saved["model"].items()} == {
        n: tuple(p.shape) for n, p in model.named_parameters()}
    with open(os.path.join(workdir, "cli", "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f.read().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]         # rank 0 alone logs
    assert all(np.isfinite(r["loss"]) for r in recs)


@pytest.mark.parametrize("policy", ["fsdp", "tp", "fsdp+tp"])
def test_cp_with_a_sharded_placement_is_refused(policy):
    cfg = MeshConfig(model_parallel=2, context_parallel=True,
                     param_sharding=policy)
    with pytest.raises(ValueError, match="A10b"):
        cfg.validate()
    with pytest.raises(ValueError, match="A10b"):
        make_mesh(cfg)


@pytest.mark.parametrize("mp,imgsize,shallow,level", [
    (4, 16, False, "level 2"), (4, 8, False, "level 1"),
    (3, 8, True, "level 0")])
def test_a_model_whose_rows_do_not_split_is_refused(mp, imgsize, shallow,
                                                    level):
    """Every level's height must divide over the ranks, and a rank's rows
    must be even at a level that downsamples; the error names the level
    and the widths."""
    model = port_tiny_config(imgsize=imgsize, shallow=shallow).model
    cfg = MeshConfig(model_parallel=mp, context_parallel=True)
    with pytest.raises(ValueError, match=f"{level} has .*H={imgsize}"):
        make_mesh(cfg, model=model)
    good = port_tiny_config(imgsize=8, shallow=True).model
    with pytest.raises(ValueError, match="spans every rank|needs"):
        make_mesh(MeshConfig(model_parallel=2, context_parallel=True),
                  model=good)


def test_distillation_under_cp_is_refused_naming_a10c():
    """Distillation under the row split waits for ROADMAP A10c: its step
    refuses a context-parallel mesh rather than run the unsplit model on
    every rank."""
    from types import SimpleNamespace

    from diff3d_tpu_torch.train.distill import DistillStep

    env = SimpleNamespace(cfg=MeshConfig(model_parallel=2,
                                         context_parallel=True),
                          context_parallel=True)
    with pytest.raises(ValueError, match="A10c"):
        DistillStep(dp_worker.tiny_config(), env=env)
