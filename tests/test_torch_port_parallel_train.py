"""Data-parallel training of the port at 2 gloo ranks on the CPU, held
against the port at 1 rank (which ``test_torch_port_train.py`` holds
against the JAX package).

One spawned group of 2 ranks (``diff3d_tpu_torch.testing.distributed``)
runs ``tests/_torch_port_parallel_worker.py::train`` once for the whole
file: 3 replicated steps, 3 ``fsdp`` steps, the stop agreement, one
global val batch, ``Sampler(mesh)`` and ``train_cli.main`` under the
group; the tests below assert on what it returned and wrote.  Tolerances:
the trajectories differ from one rank's only in the order of the
gradient reduction, so each tensor is held at 1e-5 of its norm (from
a mid-training state, ``write_warm_start``); a checkpoint restored at
another world size is bit-identical.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port_parallel_worker as worker  # noqa: E402
from diff3d_tpu_torch.cli import train_cli  # noqa: E402
from diff3d_tpu_torch.config import MeshConfig  # noqa: E402
from diff3d_tpu_torch.models import build_model  # noqa: E402
from diff3d_tpu_torch.parallel import make_mesh  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.testing.distributed import spawn  # noqa: E402
from diff3d_tpu_torch.train import Trainer  # noqa: E402


from _torch_port_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """``(workdir, [rank 0's results, rank 1's])`` of the 2-rank run."""
    workdir = str(tmp_path_factory.mktemp("dp2"))
    warm = str(tmp_path_factory.mktemp("warm"))
    worker.write_warm_start(warm)
    for policy in ("replicated", "fsdp"):
        shutil.copytree(os.path.join(warm, "checkpoints"),
                        os.path.join(workdir, policy, "checkpoints"))
    return workdir, spawn("_torch_port_parallel_worker:train", 2, workdir,
                          timeout_s=600)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The same 3 steps at 1 rank: the trainer and its state."""
    cfg = worker.tiny_config()
    env = make_mesh(cfg.mesh)
    workdir = str(tmp_path_factory.mktemp("dp1"))
    worker.write_warm_start(workdir)
    tr = Trainer(cfg, workdir=workdir, device="cpu", env=env, transfer=True)
    assert tr.state.step == 0 and tr.state.optimizer.state
    tr.loader = worker._Batches(worker.loader(cfg, env))
    tr.train()
    return tr, worker.state_arrays(tr.state)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_states_close(got: dict, want: dict, tol: float = 1e-5):
    assert sorted(got) == sorted(want)
    worst = max((_rel(got[k], want[k]), k) for k in want)
    assert worst[0] <= tol, worst


@pytest.mark.parametrize("kind", ["model.", "ema.", "adam."])
def test_replicated_two_ranks_follow_the_one_rank_trajectory(group, one_rank,
                                                             kind):
    _, (r0, r1) = group
    _, want = one_rank
    sub = lambda d: {k: v for k, v in d.items() if k.startswith(kind)}
    assert sub(want)
    _assert_states_close(sub(r0["replicated"]), sub(want))
    for k, v in r0["replicated"].items():          # both ranks agree
        np.testing.assert_array_equal(v, r1["replicated"][k])


def test_fsdp_matches_replicated(group):
    _, (r0, r1) = group
    assert r0["fsdp_start"] == r0["replicated_start"] == 0
    assert r0["fsdp_sharded"] > 0 and r0["replicated_sharded"] == 0
    _assert_states_close(r0["fsdp"], r0["replicated"])
    for k, v in r0["fsdp"].items():
        np.testing.assert_array_equal(v, r1["fsdp"][k])


def test_fsdp_checkpoint_restores_into_a_sharded_state(group):
    """The gathered checkpoint of the fsdp run restored at world 2: every
    rank copies its chunks in, and the state gathered again is the run's
    final state bit for bit."""
    _, (r0, r1) = group
    assert r0["fsdp_restored_step"] == 3
    for r in (r0, r1):
        for k, v in r0["fsdp"].items():
            np.testing.assert_array_equal(r["fsdp_restored"][k], v,
                                          err_msg=k)


def test_fsdp_spec_table_is_the_placement_fsdp_applied(group):
    _, (r0, _) = group
    spec = r0["fsdp_spec"]
    sharded = [n for n, s in spec.items() if s != "()"]
    assert len(sharded) == r0["fsdp_sharded"]
    assert set(r0["replicated_spec"].values()) == {"()"}


def test_val_loss_of_one_global_batch_matches_one_rank(group, one_rank):
    _, (r0, r1) = group
    tr, _ = one_rank
    val = worker._Batches(worker.loader(tr.cfg, tr.env, seed=7,
                                        sample_mode="permute"))
    want = float(tr._eval_step(tr.state, next(val), tr.eval_draws(3)))
    for policy in ("replicated", "fsdp"):
        assert r0[f"{policy}_val"] == r1[f"{policy}_val"]
        assert abs(r0[f"{policy}_val"] - want) <= 1e-5 * abs(want)


def test_distillation_at_two_ranks_follows_one_rank(group):
    """The data-parallel distill step's loss and all-reduced gradients
    against one rank's over the same global batch: the whole gradient at
    1e-5 of its norm."""
    _, (r0, r1) = group
    want = worker.distill_run()
    got = r0["distill"]
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    flat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])
    assert _rel(flat(got["grads"]), flat(want["grads"])) <= 1e-5
    assert got["loss"] == r1["distill"]["loss"]
    np.testing.assert_array_equal(flat(got["grads"]),
                                  flat(r1["distill"]["grads"]))


def test_stop_agreement_stops_every_rank_at_one_step(group):
    workdir, (r0, r1) = group
    for r in (r0, r1):
        assert r["stop"]["step"] == 2 and r["stop"]["observed"] == 2
    assert os.listdir(os.path.join(workdir, "stop", "checkpoints")) == [
        "ckpt_2.pt"]


@pytest.mark.parametrize("policy", ["replicated", "fsdp"])
def test_world_two_checkpoint_restores_at_world_one(group, tmp_path, policy):
    """The last checkpoint of each 2-rank run (written by rank 0 alone;
    fsdp's gathered first) restored into a 1-rank trainer: every tensor
    bit-identical to the run's final state, the reshard recorded."""
    workdir, (r0, _) = group
    cfg = dataclasses.replace(worker.tiny_config(),
                              mesh=MeshConfig(param_sharding=policy))
    tr = Trainer(cfg, workdir=os.path.join(workdir, policy), device="cpu",
                 transfer=True)
    assert tr.state.step == 3
    got = worker.state_arrays(tr.state)
    assert sorted(got) == sorted(r0[policy])
    for k, v in r0[policy].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    event = tr.ckpt.last_restore_reshard
    assert event["step"] == 3
    assert event["from"]["n_devices"] == 2 and event["to"]["n_devices"] == 1
    assert event["from"]["param_sharding"] == policy


def test_topology_summary_of_the_group(group):
    _, (r0, _) = group
    assert r0["topology"] == {"axes": {"data": 2, "model": 1},
                              "n_devices": 2, "n_processes": 2,
                              "param_sharding": "fsdp"}


def test_sampler_mesh_pads_three_objects_and_matches_one_rank(group):
    _, (r0, r1) = group
    assert r0["lane_multiple"] == 2
    cfg = worker.tiny_config()
    torch.manual_seed(0)
    sampler = Sampler(build_model(cfg.model, "cpu"), cfg, device="cpu",
                      cuda_graphs=False)
    assert sampler.lane_multiple == 1
    want = sampler.synthesize_many(
        worker.sampler_views(),
        [torch.Generator().manual_seed(10 + i) for i in range(3)],
        max_views=3)
    assert r0["views"].shape == want.shape == (3, 2, 8, 8, 8, 3)
    np.testing.assert_array_equal(r0["views"], r1["views"])
    np.testing.assert_allclose(r0["views"], want, rtol=1e-5, atol=1e-5)


def test_sampler_mesh_refuses_a_count_off_the_lane_multiple(group):
    _, (r0, _) = group
    assert "not a multiple of the mesh's data-axis size 2" in \
        r0["step_many_3"]


def test_train_cli_under_the_group_trains_and_checkpoints(group):
    workdir, _ = group
    ckpts = os.path.join(workdir, "cli", "checkpoints")
    assert os.listdir(ckpts) == ["ckpt_2.pt"]
    saved = torch.load(os.path.join(ckpts, "ckpt_2.pt"), weights_only=True)
    assert saved["mesh"]["n_devices"] == 2
    assert saved["mesh"]["param_sharding"] == "fsdp"
    assert saved["step"] == 2
    with open(os.path.join(workdir, "cli", "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 2       # rank 0 alone logs


def test_eval_cli_mesh_matches_one_process(group, tmp_path):
    """``eval_cli --mesh`` at 2 ranks (3 objects over the ranks, rank 0
    writing) scores as one process does on the same checkpoint."""
    import json

    from diff3d_tpu_torch.cli import eval_cli

    workdir, _ = group
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


def test_train_cli_lifts_and_refuses_the_parallel_flags():
    """The data-, tensor- and context-parallel flags and the kernel-naming
    flags are accepted; ``--context_parallel`` with a sharded placement
    stays refused, naming ROADMAP A10b, and ``--attn_impl xla`` (the plain
    versions) is refused on the card."""
    p = train_cli.build_parser()
    args = p.parse_args(["--param_sharding", "fsdp", "--elastic",
                         "--elastic_max_remesh", "3"])
    train_cli.refuse_unported(args)
    assert train_cli.config_from_args(args).mesh.param_sharding == "fsdp"
    for argv in (["--model_parallel", "2"], ["--param_sharding", "tp"],
                 ["--param_sharding", "fsdp+tp", "--model_parallel", "2"],
                 ["--context_parallel", "--model_parallel", "2"],
                 ["--attn_impl", "xla", "--device", "cpu"],
                 ["--attn_impl", "pallas"], ["--attn_impl", "auto"],
                 ["--pallas"]):
        args = p.parse_args(argv)
        train_cli.refuse_unported(args)
        train_cli.config_from_args(args).validate()
    mesh = train_cli.config_from_args(p.parse_args(
        ["--param_sharding", "fsdp+tp", "--model_parallel", "2"])).mesh
    assert (mesh.param_sharding, mesh.model_parallel) == ("fsdp+tp", 2)
    mesh = train_cli.config_from_args(p.parse_args(
        ["--context_parallel", "--model_parallel", "2"])).mesh
    assert (mesh.context_parallel, mesh.model_parallel,
            mesh.param_sharding) == (True, 2, "replicated")
    for sharded in ("fsdp", "tp", "fsdp+tp"):
        with pytest.raises(SystemExit, match="A10b"):
            train_cli.refuse_unported(p.parse_args(
                ["--context_parallel", "--model_parallel", "2",
                 "--param_sharding", sharded]))
    with pytest.raises(SystemExit, match="only off the card"):
        train_cli.refuse_unported(p.parse_args(["--attn_impl", "xla"]))
