"""The port's elastic supervisor (``train/trainer.py::ElasticSupervisor``)
in one process on the CPU: the counterparts of the JAX package's
``tests/test_elastic.py`` loop, reshard-event and give-up checks.

A torch process group spans processes, so one process cannot change its
own topology: the cycles' meshes are scripted through ``topology_fn``
(a one-process mesh that reports the scripted device count, so a restore
across two cycles is a recorded reshard), and SIGTERMs are real signals
from :class:`~diff3d_tpu_torch.testing.FaultInjector`, as in the JAX
package's suite.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port_parallel_worker as worker  # noqa: E402
from diff3d_tpu_torch.data import InfiniteLoader  # noqa: E402
from diff3d_tpu_torch.parallel import make_mesh  # noqa: E402
from diff3d_tpu_torch.parallel.mesh import MeshEnv  # noqa: E402
from diff3d_tpu_torch.runtime.retry import (RetryableError,  # noqa: E402
                                            RetryPolicy)
from diff3d_tpu_torch.testing import FaultInjector, wrap_iter  # noqa: E402
from diff3d_tpu_torch.train import (ELASTIC_GAVE_UP,  # noqa: E402
                                    ELASTIC_REMESHING, ELASTIC_RESUMED,
                                    ELASTIC_RUNNING, ElasticityGaveUp,
                                    ElasticSupervisor)


from _torch_port_threads import one_thread  # noqa: E402,F401


def _cfg(max_steps, **train_kw):
    cfg = worker.tiny_config(max_steps=max_steps, ckpt_every=2,
                             log_every=0, **train_kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout=0.0))


@dataclasses.dataclass
class _Scripted(MeshEnv):
    """A one-process mesh that reports ``n`` devices in its topology."""

    n: int = 1

    def topology_summary(self) -> dict:
        return dict(super().topology_summary(), n_devices=self.n)


class _Recorder:
    """Pass-through iterator recording the images of every batch."""

    def __init__(self, it, out):
        self.it, self.out = it, out

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        self.out.append(b["imgs"].numpy().copy())
        return b


def test_elastic_loop_survives_kills_and_remeshes(tmp_path):
    """8 steps, SIGTERM at fetches 3, 5 and 7, meshes of 4 / 2 / 4 / 2
    devices: each kill re-meshes, resumes at exactly the preempted step
    (a recorded reshard), and the batches consumed over the four cycles
    are the uninterrupted stream, none replayed or skipped."""
    cfg = _cfg(8, ckpt_mode="full_sliced", ckpt_async=True)
    inj = FaultInjector(seed=0)
    inj.add("loader", kind="sigterm", at_calls=(3, 5, 7))
    consumed, schedule, cycle_devs = [], [4, 2, 4, 2], []

    def topology_fn():
        n = schedule[min(len(cycle_devs), len(schedule) - 1)]
        cycle_devs.append(n)
        return _Scripted(cfg=cfg.mesh, n=n)

    def make_loader(step, env):
        return wrap_iter(_Recorder(worker._Batches(worker.loader(
            cfg, env, start_step=step)), consumed), inj, "loader")

    sup = ElasticSupervisor(cfg, make_loader, workdir=str(tmp_path),
                            topology_fn=topology_fn, reinit_fn=lambda: None,
                            device="cpu")
    state = sup.run(8)

    assert state.step == 8 and inj.fired["loader"] == 3
    assert cycle_devs == [4, 2, 4, 2]
    ev = sup.events
    assert [e.state for e in ev] == [
        ELASTIC_RUNNING, ELASTIC_REMESHING, ELASTIC_RESUMED,
        ELASTIC_REMESHING, ELASTIC_RESUMED, ELASTIC_REMESHING,
        ELASTIC_RESUMED]
    remesh = [e for e in ev if e.state == ELASTIC_REMESHING]
    resumed = [e for e in ev if e.state == ELASTIC_RESUMED]
    assert [e.step for e in remesh] == [3, 5, 7]
    assert [e.step for e in resumed] == [3, 5, 7]
    assert [e.cycle for e in resumed] == [2, 3, 4]
    assert [e.n_devices for e in ev] == [4, 4, 2, 2, 4, 4, 2]
    for e in resumed:
        assert "resharded step" in e.reason, e
    ref = InfiniteLoader(worker.dataset(), cfg.train.global_batch,
                         seed=cfg.train.seed, num_workers=0)
    assert len(consumed) == 8
    for got in consumed:
        np.testing.assert_array_equal(got, next(ref)["imgs"])
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    elastic = [r for r in recs if "elastic" in r]
    assert [r["elastic"] for r in elastic] == [e.state for e in ev]
    assert [r["n_devices"] for r in elastic] == [e.n_devices for e in ev]


def test_a_transient_fault_after_progress_resumes_and_refills(tmp_path):
    """A transient fault from the data path at fetch 3 (step 3): the
    emergency checkpoint keeps step 2, the next cycle resumes there, and
    the run ends at its target with a budget of one no-progress cycle
    untouched (progress refilled it)."""
    cfg = _cfg(4)
    inj = FaultInjector(seed=0)
    inj.add("loader", at_calls=(3,),
            exc=lambda: RetryableError("UNAVAILABLE: transport closed"))
    sup = ElasticSupervisor(
        cfg, lambda step, env: wrap_iter(worker._Batches(worker.loader(
            cfg, env, start_step=step)), inj, "loader"),
        workdir=str(tmp_path), reinit_fn=lambda: None, device="cpu",
        retry=RetryPolicy(max_attempts=1, base_delay_s=0.0, jitter=0.0,
                          sleep=lambda s: None))
    state = sup.run(4)
    assert state.step == 4
    ev = sup.events
    assert [(e.state, e.step) for e in ev] == [
        (ELASTIC_RUNNING, 0), (ELASTIC_REMESHING, 2), (ELASTIC_RESUMED, 2)]
    assert "UNAVAILABLE" in ev[1].reason


def test_supervisor_gives_up_after_no_progress_budget(tmp_path):
    """Transient faults at every bring-up with no progress spend the
    budget: a GAVE_UP event, then ElasticityGaveUp with the history."""
    cfg = _cfg(4)
    inj = FaultInjector(seed=0)
    inj.add("elastic.cycle", first_n=99)
    sup = ElasticSupervisor(
        cfg, make_loader=lambda step, env: iter(()), workdir=str(tmp_path),
        reinit_fn=lambda: None, device="cpu",
        retry=RetryPolicy(max_attempts=2, base_delay_s=0.0, jitter=0.0,
                          sleep=lambda s: None),
        fault_hook=inj.fire)
    with pytest.raises(ElasticityGaveUp) as ei:
        sup.run(4)
    ev = sup.events
    assert [e.state for e in ev] == [ELASTIC_REMESHING, ELASTIC_GAVE_UP]
    assert all("FaultInjected" in e.reason for e in ev)
    assert ei.value.events == ev
    assert "budget exhausted" in str(ei.value)
    assert sup.trainer is None
    assert not os.path.exists(os.path.join(str(tmp_path), "checkpoints"))


def test_a_non_transient_error_is_not_elastic(tmp_path):
    cfg = _cfg(4)

    def make_loader(step, env):
        raise ValueError("bad dataset")

    sup = ElasticSupervisor(cfg, make_loader, workdir=str(tmp_path),
                            reinit_fn=lambda: None, device="cpu")
    with pytest.raises(ValueError, match="bad dataset"):
        sup.run(4)
    assert sup.events == []


def test_default_topology_is_the_one_process_mesh(tmp_path):
    cfg = _cfg(2)
    envs = []

    def make_loader(step, env):
        envs.append(env)
        return worker._Batches(worker.loader(cfg, env, start_step=step))

    sup = ElasticSupervisor(cfg, make_loader, workdir=str(tmp_path),
                            device="cpu")
    assert sup.run(2).step == 2
    assert envs[0].data_size == 1 and envs[0].device_mesh is None
    assert envs[0].topology_summary() == make_mesh(
        cfg.mesh).topology_summary()


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of world size 1 in this process (the CPU
    counterpart of the card's NCCL group of one), torn down after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "store"), world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_one_group_matches_no_group(tmp_path, one_rank_group):
    """At world size 1 the replicated step (its bucket all-reduced over
    the group) is bit-identical to the step without a group, and the fsdp
    step (every leaf replicated at data size 1, the step eager) follows
    it: the chip smoke's parallel phase (a) and (b) on the CPU."""
    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.parallel.mesh import MeshEnv
    from diff3d_tpu_torch.train import Trainer

    cfg = _cfg(2)
    states = {}
    for name, env in (
            ("nogroup", MeshEnv(cfg=cfg.mesh)),
            ("replicated", make_mesh(cfg.mesh)),
            ("fsdp", make_mesh(MeshConfig(param_sharding="fsdp")))):
        c = dataclasses.replace(cfg, mesh=env.cfg)
        tr = Trainer(c, workdir=str(tmp_path / name), device="cpu", env=env)
        assert (tr.step_fn.group is None) == (name == "nogroup")
        tr.loader = worker._Batches(worker.loader(c, env))
        tr.train()
        states[name] = worker.state_arrays(tr.state)
    for k, v in states["nogroup"].items():
        np.testing.assert_array_equal(states["replicated"][k], v, err_msg=k)
        np.testing.assert_allclose(states["fsdp"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
