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
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

import _torch_port_cp_worker as worker  # noqa: E402
import _torch_port_parallel_worker as dp_worker  # noqa: E402
from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.data import InfiniteLoader as JLoader  # noqa: E402
from diff3d_tpu.data import SyntheticDataset as JSynthetic  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from diff3d_tpu.train import state as jstate  # noqa: E402
from diff3d_tpu.train.step import make_train_step as j_make_train_step  # noqa: E402
from diff3d_tpu_torch.config import MeshConfig  # noqa: E402
from diff3d_tpu_torch.convert import (convert_params,  # noqa: E402
                                      load_flax_train_state)
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


# (data, model, placement) of each split-placement mesh held against the
# JAX package: its forward at all four, its train step at dp2 x mp2.
SHARDED_MESHES = [(1, 2, "tp")] + [(2, 2, p) for p in worker.SHARDED]


def _jax_carry(flax_model):
    """A mid-training state as Flax leaves (``flax_model``'s parameters,
    an EMA near them, Adam's moments of 7 updates; the schedule at 8, the
    step at 9), a JAX loader batch of 8 and the draws the JAX step takes
    from key 11 at step 9 (``test_torch_port_train.py``'s ``jax_step``,
    one microbatch)."""
    _, flat, _, _ = flax_model
    rng = np.random.default_rng(7)

    def rand(scale):
        return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in flat.items()}

    ema = {k: v + d for (k, v), d in zip(flat.items(), rand(0.01).values())}
    mu = rand(0.01)
    nu = {k: (v * v + 1e-6).astype(np.float32) for k, v in rand(0.01).items()}
    B = worker.JAX_B
    ds = JSynthetic(num_objects=3, num_views=5, imgsize=8, seed=4)
    batch = {k: np.asarray(v) for k, v in
             next(JLoader(ds, B, seed=4, num_workers=0)).items()}
    key = jax.random.PRNGKey(11)
    # make_train_step folds the step in, splits off the dropout key, and
    # p_losses splits the rest in four.
    k_t, k_noise, k_mask, k_x = jax.random.split(
        jax.random.split(jax.random.fold_in(key, 9))[0], 4)
    shape = (B, 8, 8, 3)
    draws = {"t": np.array(jax.random.uniform(k_t, (B,))),
             "noise": np.array(jax.random.normal(k_noise, shape)),
             "cond_u": np.array(jax.random.uniform(k_mask, (B,))),
             "x_noise": np.array(jax.random.normal(k_x, shape))}
    return {"flax": dict(params=flat, ema_params=ema, mu=mu, nu=nu),
            "batch": batch, "draws": draws, "key": key}


def _write_carry(carry, workdir):
    """The carried state as the port's world-1 ``full`` checkpoint in
    ``<workdir>/checkpoints`` (the ranks restore it under each
    placement)."""
    tr = Trainer(worker.jax_step_config(), workdir=workdir, device="cpu")
    load_flax_train_state(tr.state, **carry["flax"], adam_count=7,
                          schedule_count=8, step=9)
    tr.ckpt.save(tr.state, force=True)


def _jax_step(flax_model, carry, dp, mp, policy):
    """One step of the JAX package's ``make_train_step`` under
    ``context_parallel`` with ``policy`` on ``dp x mp`` virtual devices,
    from the carried state: its metrics and its state in the port's names
    (``model.*``, ``ema.*``, ``adam.<name>.exp_avg`` / ``exp_avg_sq``)."""
    jcfg = jax_tiny_config(imgsize=8, ch=8, shallow=True)
    jcfg = dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, lr=0.1),
        mesh=jconfig.MeshConfig(data_parallel=dp, model_parallel=mp,
                                context_parallel=True,
                                param_sharding=policy))
    env = j_make_mesh(jcfg.mesh, devices=jax.devices()[:dp * mp])
    tree = lambda d: unflatten_dict(  # noqa: E731
        {k: jnp.asarray(v) for k, v in d.items()}, sep="/")
    f = carry["flax"]
    st = jstate.create_train_state(tree(f["params"]), jcfg.train)
    opt_state = jax.tree.map(
        lambda s: (s._replace(count=jnp.int32(7), mu=tree(f["mu"]),
                              nu=tree(f["nu"]))
                   if isinstance(s, optax.ScaleByAdamState) else
                   s._replace(count=jnp.int32(8))
                   if isinstance(s, optax.ScaleByScheduleState) else s),
        st.opt_state, is_leaf=lambda s: isinstance(
            s, (optax.ScaleByAdamState, optax.ScaleByScheduleState)))
    st = st.replace(step=jnp.int32(9), opt_state=opt_state,
                    ema_params=tree(f["ema_params"]))
    model = JXUNet(jcfg.model)
    new, jm = j_make_train_step(model, jcfg, env=env, donate=False)(
        st, {k: jnp.asarray(v) for k, v in carry["batch"].items()},
        carry["key"])
    adam = [s for s in jax.tree.leaves(
        new.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    pm = build_model(worker.jax_step_config().model, "cpu")
    out = {"metrics": {k: float(v) for k, v in jax.device_get(jm).items()},
           "step": int(new.step), "state": {}}
    for prefix, suffix, t in (("model.", "", new.params),
                              ("ema.", "", new.ema_params),
                              ("adam.", ".exp_avg", adam.mu),
                              ("adam.", ".exp_avg_sq", adam.nu)):
        for k, v in convert_params(flatten_dict(jax.device_get(t), sep="/"),
                                   pm).items():
            out["state"][prefix + k + suffix] = v.numpy()
    return out


def _jax_sharded(flax_model, carry):
    """The JAX package's forward under each split-placement mesh and its
    train step under each placement at dp2 x mp2."""
    # The JAX package's forward with the parameters placed by fsdp at a
    # data size of 2 or more under the row constraint differs from its
    # own unsharded forward by 1.2e-2 on the CPU (its train step under the
    # same mesh does not); there the parameters are left unplaced.
    out = {("forward",) + m: _jax_forward(flax_model, *m,
                                          place=m != (2, 2, "fsdp"))
           for m in SHARDED_MESHES}
    for m in SHARDED_MESHES[1:]:
        out[("step",) + m] = _jax_step(flax_model, carry, *m)
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory, flax_model):
    """Both spawned groups, run at once: ``{"two": (workdir, [rank 0's
    results, rank 1's]), "four": (workdir, the 4 ranks' results)}``."""
    from concurrent.futures import ThreadPoolExecutor

    _, flat, batch, mask = flax_model
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("cp2", "cp4")}
    for sub in ("train", "remat_nothing", "remat_dots", "train_tp",
                "control_tp"):
        dp_worker.write_warm_start(os.path.join(dirs["cp2"], sub))
    dp_worker.write_warm_start(dirs["cp4"])
    for sub in worker.SHARDED:
        dp_worker.write_warm_start(os.path.join(dirs["cp4"], sub))
    carry = _jax_carry(flax_model)
    _write_carry(carry, os.path.join(dirs["cp4"], "jax"))
    with ThreadPoolExecutor(3) as pool:
        two = pool.submit(spawn, "_torch_port_cp_worker:group_of_two", 2,
                          dirs["cp2"], flat, batch, mask, timeout_s=600)
        four = pool.submit(spawn, "_torch_port_cp_worker:group_of_four", 4,
                           dirs["cp4"], flat, batch, mask, carry["batch"],
                           carry["draws"], timeout_s=600)
        # Meanwhile the JAX package's forwards and steps under the split
        # placements compile and run on this process's virtual devices.
        jax_refs = pool.submit(_jax_sharded, flax_model, carry)
        return {"two": (dirs["cp2"], two.result()),
                "four": (dirs["cp4"], four.result()),
                "jax": jax_refs.result(), "carry": carry}


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

def _jax_forward(flax_model, dp, mp, policy="replicated", place=True):
    """The JAX package's forward under ``context_parallel`` on ``dp x
    mp`` virtual devices: every block output constrained to ``P(data,
    None, model)``, the parameters placed by ``policy`` (``place`` False:
    left for ``jit`` to replicate)."""
    jcfg, flat, batch, mask = flax_model
    env = j_make_mesh(jconfig.MeshConfig(data_parallel=dp, model_parallel=mp,
                                         context_parallel=True,
                                         param_sharding=policy),
                      devices=jax.devices()[:dp * mp])
    params = unflatten_dict(flat, sep="/")
    model = JXUNet(jcfg)
    constrain = env.activation_constraint()
    p_sh = (jax.device_put(params, env.params(params)) if place
            else params)
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
def test_cp_with_a_sharded_placement_is_refused(two, policy):
    """Refused until context parallelism took the split placements (the
    name is kept): the config validates, and the ranks build the mesh,
    row split and model axis both (the placement splits leaves only under
    ``tp`` / ``fsdp+tp``; ``fsdp`` at data size 1 shards nothing)."""
    cfg = MeshConfig(model_parallel=2, context_parallel=True,
                     param_sharding=policy)
    cfg.validate()
    with pytest.raises(ValueError, match="spans every rank"):
        make_mesh(cfg)                       # one process, no group
    for r in two[1]:
        topology, cp, tp = r["meshes"][policy]
        assert topology == {"axes": {"data": 1, "model": 2},
                            "n_devices": 2, "n_processes": 2,
                            "param_sharding": policy}
        assert cp and tp == (policy != "fsdp")


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
    """Distillation under the row split (ROADMAP A10c, ported): the cp
    distill step takes the train step's bucket, all-reduced over the
    world and divided by the data size, model rank 0's loss alone in it,
    and runs eagerly (``test_torch_port_distill_parallel.py`` runs it on
    ranks)."""
    from types import SimpleNamespace

    import torch.distributed as dist

    from diff3d_tpu_torch.train.distill import DistillStep

    params = list(build_model(dp_worker.tiny_config().model,
                              "cpu").parameters())
    for model_rank in (0, 1):
        env = SimpleNamespace(
            cfg=MeshConfig(data_parallel=2, model_parallel=2,
                           context_parallel=True),
            context_parallel=True, eager_only=True, group=None,
            data_size=2, data_rank=1, model_rank=model_rank,
            model_axis=None)
        step = DistillStep(dp_worker.tiny_config(), env=env)
        assert step.rows == (dist.group.WORLD, 2, model_rank == 0)
        assert (step.rank, step.world) == (1, 2)
        sync = step._bucket(params)
        assert sync.group is dist.group.WORLD
        assert (sync.world, sync.with_loss) == (2, model_rank == 0)
        assert not step.cuda_graphs
        with pytest.raises(ValueError, match="cuda_graphs=True"):
            DistillStep(dp_worker.tiny_config(), cuda_graphs=True, env=env)


# ---- context parallelism with the split placements ---------------------

def _sharded_run(two, four, dp, policy, key="train"):
    """``(the ranks' results of one split-placement mesh, rank 0's first;
    its warm start's state: ``model.*`` and ``ema.*``)``."""
    if dp == 1:
        runs = [r[f"{key}_tp"] for r in two[1]]
        workdir = os.path.join(two[0], f"{key}_tp")
    else:
        runs = [r[f"{key}_{policy}"] for r in
                sorted(four[1], key=lambda r: r["ranks"])]
        workdir = os.path.join(four[0], policy)
    return runs, _warm_start(workdir)


def _warm_start(workdir):
    saved = torch.load(os.path.join(workdir, "checkpoints", "ckpt_0.pt"),
                       weights_only=True)
    return {f"{kind}.{k}": v.numpy() for kind in ("model", "ema")
            for k, v in saved[kind].items()}


def _failed_leaves(state, want, start):
    """The leaf gate of the split placements' training: a leaf of the
    state (parameters, EMA, both Adam moments) fails when it is more than
    1e-5 relative L2 off one rank's, or, a parameter or an EMA leaf, when
    its update (after minus the warm start) is more than 1e-4 relative
    L2 off one rank's update: in the warmup a parameter moves too little
    for its value to show a wrong update."""
    failed = [k for k, v in state.items() if _rel(v, want[k]) > 1e-5]
    failed += [k for k, s in start.items()
               if _rel(state[k] - s, want[k] - s) > 1e-4]
    return failed


@pytest.mark.parametrize("dp,mp,policy", SHARDED_MESHES)
def test_sharded_cp_forward_matches_the_jax_package(groups, two, four, dp,
                                                    mp, policy):
    """The whole forward with the split leaves gathered in each layer (or
    FSDP2's chunks gathered) on each rank's rows, against the JAX
    package's forward under the same ``MeshConfig``, at 1e-4 (under
    ``fsdp`` with the JAX parameters unplaced: :func:`_jax_sharded`)."""
    want = groups["jax"][("forward", dp, mp, policy)]
    if dp == 1:
        outs = [r["forward_tp"] for r in two[1]]
        np.testing.assert_array_equal(outs[0], outs[1])
    else:
        rows = {r["ranks"]: r[f"forward_{policy}"] for r in four[1]}
        for d in (0, 1):
            np.testing.assert_array_equal(rows[(d, 0)], rows[(d, 1)])
        outs = [np.concatenate([rows[(0, 0)], rows[(1, 0)]])]
    for got in outs:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["model.", "ema.", "adam."])
@pytest.mark.parametrize("dp,mp,policy", SHARDED_MESHES)
def test_sharded_cp_training_follows_one_rank(two, four, one_rank, dp, mp,
                                              policy, kind):
    """3 steps from the warm start: a split leaf's gradient summed over
    the model axis by its gather's backward and over the data axis by the
    bucket's second part, a whole leaf's over the world, an FSDP2 shard's
    over the data axis by FSDP2 and over the model axis by the bucket;
    every leaf of the state 1e-5 of one rank's, every rank alike."""
    runs, start = _sharded_run(two, four, dp, policy)
    want, losses = one_rank
    _check_trajectory(runs[0], want, losses, kind)
    failed = [k for k in _failed_leaves(runs[0]["state"], want, start)
              if k.startswith(kind)]
    assert not failed, failed[:5]
    for r in runs[1:]:
        for k, v in runs[0]["state"].items():
            np.testing.assert_array_equal(v, r["state"][k])
    # The bucket's parts: whole leaves, blocks, FSDP2 shards summed over
    # the model axis (a leaf both split and sharded is in none of them).
    shards, split = runs[0]["placed"]
    whole, blocks, summed = runs[0]["parts"]
    assert whole > 0 and runs[0]["graphs"] is False
    assert (shards > 0) == (dp == 2 and policy != "tp")
    assert (split > 0) == (policy != "fsdp")
    assert split - blocks == shards - summed >= 0
    if policy == "fsdp":
        assert blocks == 0 and summed == shards
    if shards == 0:
        assert blocks == split and summed == 0


@pytest.mark.parametrize("policy", worker.SHARDED)
def test_sharded_cp_step_matches_the_jax_package(groups, four, policy):
    """One step at dp2 x mp2 from the carried mid-training state, the JAX
    draws replayed, against the JAX package's ``make_train_step`` under
    the same ``MeshConfig``: loss, gradient norm and lr within 1e-5
    relative, every leaf of the parameters, the EMA and both Adam moments
    within 1e-5 of its largest magnitude."""
    want = groups["jax"][("step", 2, 2, policy)]
    ranks = sorted(four[1], key=lambda r: r["ranks"])
    for r in ranks:
        got = r[f"jax_{policy}"]
        assert got["step"] == want["step"] == 10
        for k in ("loss", "grad_norm", "lr"):
            ref = want["metrics"][k]
            assert abs(got["metrics"][k] - ref) <= 1e-5 * abs(ref), (
                k, got["metrics"][k], ref)
        bad = []
        for k, v in want["state"].items():
            err = float(np.abs(got["state"][k] - v).max())
            if err > 1e-5 * float(np.abs(v).max()):
                bad.append((k, err))
        assert not bad, bad[:5]
    start = convert_params(groups["carry"]["flax"]["params"], build_model(
        worker.jax_step_config().model, "cpu"))
    moved = max(float(np.abs(want["state"][f"model.{k}"] - v.numpy()).max())
                for k, v in start.items())
    assert moved > 1e-3


def test_unsummed_leaf_gather_fails_hundreds_of_leaves(two, one_rank):
    """The control: the 3 steps at cp 2 + ``tp`` with each split leaf's
    gather handing back the rank's block of its own rows' gradient (the
    model-axis sum removed).  The losses stay within 1e-6 of one rank's
    (the forward is untouched), and the leaf gate of
    :func:`test_sharded_cp_training_follows_one_rank`
    (:func:`_failed_leaves`) fails hundreds of leaves: both Adam moments
    of every split leaf, and the update of most split parameters and of
    their EMA."""
    want, losses = one_rank
    (run, _), start = _sharded_run(two, four=None, dp=1, policy="tp",
                                   key="control")
    for got, ref in zip(run["losses"], losses):
        assert abs(got - ref) <= 1e-6 * abs(ref), (run["losses"], losses)
    failed = _failed_leaves(run["state"], want, start)
    assert len(failed) >= 200, len(failed)


def test_world_one_checkpoint_restores_at_cp2_tp(two):
    """The warm start restored at cp 2 + ``tp``: each rank holds its
    blocks (half of a split leaf), gathered whole bit for bit the
    file's."""
    workdir, ranks = two
    saved = torch.load(os.path.join(workdir, "train_tp", "checkpoints",
                                    "ckpt_0.pt"), weights_only=True)
    names = list(saved["model"])
    for r in ranks:
        got = r["tp_restored"]
        for k, v in saved["model"].items():
            np.testing.assert_array_equal(got[f"model.{k}"], v.numpy())
            np.testing.assert_array_equal(got[f"ema.{k}"],
                                          saved["ema"][k].numpy())
        for i, st in saved["optim"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(
                    got[f"adam.{names[i]}.{key}"], st[key].numpy())
        halved = sum(r["tp_local_shapes"][k] != tuple(v.shape)
                     for k, v in saved["model"].items())
        assert halved > len(names) // 2


def test_cp2_tp_checkpoint_restores_at_world_one_and_at_cp2_tp(two):
    """The step-3 checkpoint of the cp 2 + ``tp`` run (gathered whole,
    written by rank 0) restored at world 1 and again at cp 2 + ``tp``:
    bit for bit the run's final state."""
    workdir, (r0, r1) = two
    tr = Trainer(dp_worker.tiny_config(),
                 workdir=os.path.join(workdir, "train_tp"), device="cpu",
                 transfer=True)
    assert tr.state.step == 3
    got = dp_worker.state_arrays(tr.state)
    want = r0["train_tp"]["state"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        for r in (r0, r1):
            np.testing.assert_array_equal(r["tp_again"][k], v, err_msg=k)
    assert r0["tp_again_step"] == r1["tp_again_step"] == 3
    assert tr.ckpt.last_restore_reshard["from"]["param_sharding"] == "tp"


def test_sampler_under_cp_tp_runs_both_paths(two):
    """``Sampler(mesh)`` on one placed model: the single-object path by
    rows with the split leaves gathered, the batched path in ``tp``'s
    column and row modes (no leaf gathered, the model axis's collectives
    run), then the single-object path again, bit for bit its first run;
    each against one process at 1e-4."""
    _, (r0, r1) = two
    cfg = dp_worker.tiny_config()
    torch.manual_seed(0)
    sampler = Sampler(build_model(cfg.model, "cpu"), cfg, device="cpu",
                      cuda_graphs=False)
    views = dp_worker.sampler_views()
    one = sampler.synthesize(views[0], torch.Generator().manual_seed(10),
                             max_views=3)
    many = sampler.synthesize_many(
        views, [torch.Generator().manual_seed(10 + i) for i in range(3)],
        max_views=3)
    assert r0["sampler_graphs_tp"] is False
    for key, want in (("one", one), ("many", many), ("one_again", one)):
        np.testing.assert_array_equal(r0[f"views_{key}"],
                                      r1[f"views_{key}"])
        np.testing.assert_allclose(r0[f"views_{key}"], want, rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(r0["views_one"], r0["views_one_again"])
    counts = r0["sampler_counts"]
    assert counts["one"][0] > 0 and counts["one_again"] == counts["one"]
    assert counts["many"][0] == 0 and counts["many"][1] > 0


def test_train_cli_context_parallel_tp_trains_and_checkpoints(two):
    workdir, _ = two
    ckpts = os.path.join(workdir, "cli_tp", "checkpoints")
    assert os.listdir(ckpts) == ["ckpt_2.pt"]
    saved = torch.load(os.path.join(ckpts, "ckpt_2.pt"), weights_only=True)
    assert saved["mesh"]["axes"] == {"data": 1, "model": 2}
    assert saved["mesh"]["param_sharding"] == "tp"
    assert saved["step"] == 2
    model = build_model(port_tiny_config(imgsize=16).model, "cpu")
    assert {n: tuple(v.shape) for n, v in saved["model"].items()} == {
        n: tuple(p.shape) for n, p in model.named_parameters()}
    with open(os.path.join(workdir, "cli_tp", "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f.read().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
