"""The port's programs as traced graphs and the four program checks
(``diff3d_tpu_torch/analysis/``), held against the JAX package on the CPU.

The fake world (a ``fake`` process group of 8 ranks) is opened in a
process of its own, ``tests/_torch_port_analysis_worker.py`` (no JAX),
which writes one JSON file; while it runs, this process lowers the JAX
package's ``step_many`` and train step on its 8 virtual CPU devices, as
the JAX registry builds them (abstract state and batch; the sampler's
parameters as zeros of ``init_params``'s shapes; nothing compiled).

* **Clean**: each check exits clean on the committed manifests for the
  tier-1 set (the JAX registry's: ``train_step``, ``step_many`` and the
  cascade's two phases).
* **Controls**: each check fails on a seeded mutation of a live program:
  an extra all-gather and an f32 upcast (shardcheck), the records'
  in-place write replaced by a copy (memcheck), one changed op, named
  (equivcheck), a draw without ``generator=`` in a package source and a
  reordered draw (rngcheck).
* **Arguments**: ``step_many``'s and ``train_step``'s argument bytes
  equal the JAX programs' leaf group by leaf group; the leaves that
  differ by design are named (below).
* **Draws**: ``step_many``'s sampler draws, as (distribution, shape),
  in the JAX program's order.
* **Kernel nodes**, **errors**, **device** (each op's CPU implementation
  bit-identical to the plain version) and **admission** (``worker_cli
  --memcheck_dir``).

Nothing here traces a backward on fake CUDA tensors: on a CPU-only torch
build that aborts the process (the autograd engine's CUDA accumulator).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu_torch.cli import worker_cli  # noqa: E402
from diff3d_tpu_torch.config import test_config as tiny_config  # noqa: E402
from diff3d_tpu_torch.ops import cuda_attention as ca  # noqa: E402
from diff3d_tpu_torch.ops import cuda_film as cf  # noqa: E402
from diff3d_tpu_torch.ops import KERNEL_WRAPPERS, library  # noqa: E402
from diff3d_tpu_torch.serving import scheduler as psched  # noqa: E402

from _torch_port_threads import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_port_analysis_worker.py")
MEMCHECK = os.path.join(ROOT, "runs", "torch_memcheck")
TIMEOUT = 300


def _jax_side() -> dict:
    """The JAX package's step_many (witnessed draws, argument bytes) and
    train-step argument bytes, lowered as its registry lowers them."""
    import jax
    import jax.numpy as jnp

    from diff3d_tpu.analysis import rngflow, shardcheck
    from diff3d_tpu.config import test_config
    from diff3d_tpu.models import XUNet
    from diff3d_tpu.sampling import Sampler
    from diff3d_tpu.train import make_train_step
    from diff3d_tpu.train.trainer import init_params

    def nbytes(tree):
        return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                   for x in jax.tree_util.tree_leaves(tree))

    cfg = test_config(imgsize=8, ch=8)
    env = shardcheck._fsdp_mesh()
    model = XUNet(cfg.model)
    shapes = jax.eval_shape(lambda r: init_params(model, cfg, r),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    sampler = Sampler(model, params, cfg, mesh=env)
    witness, uninstall = rngflow.install_rng_witness()
    try:
        lowered = sampler.lower_step_many(lanes=shardcheck.MESH_DEVICES,
                                          capacity=4)
    finally:
        uninstall()
    p_info, *rest = lowered.args_info[0]
    names = ("record_imgs", "record_R", "record_T", "steps", "K", "rngs")
    out = {"step_many": {"params": nbytes(p_info),
                         **{n: nbytes(a) for n, a in zip(names, rest)}},
           "draws": [e for e in witness.events
                     if e.startswith(("normal(", "randint("))]}
    tcfg = shardcheck._train_cfg()
    tenv = shardcheck._fsdp_mesh()
    tmodel = XUNet(tcfg.model)
    state = shardcheck._abstract_state(tmodel, tcfg)
    batch = shardcheck._abstract_batch(tcfg)
    rng = jax.ShapeDtypeStruct((2,), jnp.uint32)
    tl = make_train_step(tmodel, tcfg, tenv, donate=False).lower(
        state, batch, rng)
    st, b, r = tl.args_info[0]
    adam, sched = st.opt_state
    out["train"] = {"params": nbytes(st.params), "mu": nbytes(adam.mu),
                    "nu": nbytes(adam.nu), "count": nbytes(adam.count),
                    "schedule_count": nbytes(sched.count),
                    "ema": nbytes(st.ema_params), "step": nbytes(st.step),
                    "batch": nbytes(b), "rng": nbytes(r)}
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """``(port, jax)``: the worker process's JSON and the JAX side, the
    two built at once."""
    out = tmp_path_factory.mktemp("analysis") / "port.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, WORKER, str(out)], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    jax_out, errs = {}, []

    def run_jax():
        try:
            jax_out.update(_jax_side())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    t = threading.Thread(target=run_jax)
    t.start()
    try:
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        t.join()
    assert proc.returncode == 0, err[-4000:]
    if errs:
        raise errs[0]
    with open(out, encoding="utf-8") as f:
        return json.load(f), jax_out


@pytest.mark.parametrize("tool", ["shardcheck", "memcheck", "equivcheck",
                                  "rngcheck"])
def test_tier1_programs_clean_on_the_committed_manifests(both, tool):
    assert both[0][f"clean.{tool}"] == []


@pytest.mark.parametrize("control,rule,key", [
    ("extra_gather", "SC201", "allgather_base"),
    ("upcast", "SC202", "upcasts"),
    ("record_copy", "MC402", "record_imgs"),
    ("changed_op", "EQ601", "fingerprint"),
    ("reordered_draw", "RC501", "stream"),
    ("no_generator", "RC503", "core.py:89")])
def test_each_check_fails_on_its_seeded_mutation(both, control, rule, key):
    found = both[0]["controls"][control]
    assert [(f["rule"], f["key"]) for f in found] == [(rule, key)]


def test_equivcheck_names_the_changed_node(both):
    (f,) = both[0]["controls"]["changed_op"]
    assert "clamp.default" in f["message"] and "0.5" in f["message"]


def test_the_source_pass_is_clean_on_the_unmutated_source(both):
    assert both[0]["controls"]["no_generator_unmutated"] == []


def test_step_many_argument_bytes_equal_the_jax_programs(both):
    """Parameters, records and intrinsics byte for byte.  By design the
    JAX program takes ``steps`` (int32 [lanes]) and ``rngs`` (uint32
    [lanes, 2]) as arguments where the port takes host ints and one
    generator per object, and the port reads the guidance weights ``w``
    (float32 [8]) as a buffer where the JAX program folds a constant."""
    port, jx = both
    args = port["port"]["step_many_args"]
    js = jx["step_many"]
    assert sum(v for k, v in args.items() if k.startswith("params.")) \
        == js["params"]
    for k in ("record_imgs", "record_R", "record_T", "K"):
        assert args[k] == js[k], k
    assert (js["steps"], js["rngs"], args["w"]) == (8 * 4, 8 * 8, 8 * 4)


def test_train_step_argument_bytes_equal_the_jax_programs(both):
    """Parameters, Adam's two moments, the EMA and the batch byte for
    byte (the port's local shards times the world for the sharded
    leaves).  By design: optax keeps one int32 ``count`` (and the
    schedule's), the port's Adam a float32 ``step`` per leaf; the JAX
    state's ``step`` and ``rng`` are host values and a generator here."""
    port, jx = both
    p, jt = port["port"], jx["train"]
    assert p["train_params_global"] == jt["params"]
    assert jt["mu"] == jt["nu"] == jt["ema"] == jt["params"]
    local = p["train_local"]
    assert local["adam.exp_avg"] == local["adam.exp_avg_sq"] \
        == local["ema"] == local["params"]
    assert p["train_batch_global"] == jt["batch"]
    assert local["adam.step"] == 4 * p["train_adam_step_leaves"]
    assert (jt["count"], jt["schedule_count"], jt["step"], jt["rng"]) \
        == (4, 4, 4, 8)


def test_step_many_draws_follow_the_jax_programs_order(both):
    """JAX's witness sees each lane's init noise, conditioning indices and
    the scan body's two draws once (the body is traced once); the port
    draws every step's pair up front: its first four draws are the init
    noise, the indices and step 0's pair.  ``normal`` is ``randn``."""
    port, jx = both
    ours = [(e["op"].split(".")[0], tuple(e["shape"]))
            for e in port["port"]["step_many_draws"]]
    theirs = [(e.split("(")[0], tuple(
        int(x) for x in e.split("(")[1].split(")")[0].split(",") if x))
        for e in jx["draws"]]
    names = {"normal": "randn", "randint": "randint"}
    assert ours[:4] == [(names[n], s) for n, s in theirs]
    steps = tiny_config(imgsize=8, ch=8).diffusion.timesteps
    assert ours[4:] == ours[2:4] * (steps - 1)


@pytest.mark.parametrize("trace,op,site", [
    ("forward", "gn_forward", "groupnorm"),
    ("forward", "flash_forward", "attention"),
    ("cp", "gn_split_sums", "groupnorm"),
    ("cp", "gn_split_apply", "groupnorm"),
    ("cp", "flash_forward", "attention")])
def test_one_kernel_node_per_site(both, trace, op, site):
    k = both[0]["kernels"][trace]
    assert k["ops"].get(f"diff3d_tpu_torch::{op}.default") == k["sites"][site]


def test_no_plain_version_in_the_kernels_place(both):
    """The plain GroupNorm's ``rsqrt`` and the plain attention's
    ``logsumexp`` appear once per site under ``set_kernels('torch')``
    and never beside the kernel nodes."""
    k = both[0]["kernels"]
    for op in ("rsqrt.default", "logsumexp.default"):
        assert op not in k["forward"]["ops"]
    assert k["plain"]["ops"]["rsqrt.default"] \
        == k["plain"]["sites"]["groupnorm"]
    assert k["plain"]["ops"]["logsumexp.default"] \
        == k["plain"]["sites"]["attention"]
    assert not any(o.startswith("diff3d_tpu_torch::")
                   for o in k["plain"]["ops"])


def test_lower_step_many_raises_as_the_jax_package_does():
    """The JAX package's two refusals with the same conditions: a
    chunked sampler is several programs, and lanes must be a multiple of
    the mesh's data size."""
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.sampling import Sampler

    cfg = tiny_config(imgsize=8, ch=8)
    model = build_model(cfg.model, "cpu")
    with pytest.raises(ValueError, match="scan_chunks=2"):
        Sampler(model, cfg, device="cpu", scan_chunks=2).lower_step_many(
            2, 4)
    s = Sampler(model, cfg, device="cpu")
    s.lane_multiple = 2                       # a data axis of 2
    with pytest.raises(ValueError, match="lanes=3 is not a multiple"):
        s.lower_step_many(3, 4)


def test_lower_step_many_raises_where_the_jax_package_raises():
    import jax

    from diff3d_tpu.config import test_config
    from diff3d_tpu.models import XUNet
    from diff3d_tpu.sampling import Sampler
    from diff3d_tpu.train.trainer import init_params

    cfg = test_config(imgsize=8, ch=8)
    model = XUNet(cfg.model)
    params = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda r: init_params(model, cfg, r),
                       jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="scan_chunks=2"):
        Sampler(model, params, cfg, scan_chunks=2).lower_step_many(2, 4)
    s = Sampler(model, params, cfg)
    s.lane_multiple = 2
    with pytest.raises(ValueError, match="lanes=3 is not a multiple"):
        s.lower_step_many(3, 4)


def _close(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(
        a, (list, tuple)) else torch.equal(a, b)


def test_each_ops_cpu_implementation_is_its_plain_version():
    """On CPU tensors every op is bit-identical (``torch.equal``) to the
    plain version it stands for, rows 1-6 and the split entry points."""
    g = torch.Generator().manual_seed(0)

    def r(*s, dtype=torch.float32):
        return torch.randn(s, generator=g).to(dtype)

    ops = library.OPS
    N, L, C, G = 2, 12, 16, 4
    x, gr = r(N, L, C), r(N, L, C)
    gamma, beta = r(C), r(C)
    film = r(N, L, 2 * C)
    sc, sh = film[..., :C], film[..., C:]
    stats = cf.groupnorm_stats_reference(x, G)
    kw = dict(num_groups=G, silu=True)
    assert _close(ops["gn_forward"](x, gamma, beta, sc, sh, G, True),
                  cf.groupnorm_reference(x, gamma, beta, scale=sc, shift=sh,
                                         **kw))
    out, st = ops["gn_forward_stats"](x, gamma, beta, None, None, G, False)
    assert _close([out, st], [cf.groupnorm_reference(
        x, gamma, beta, num_groups=G, stats=stats), stats])
    ref = cf.groupnorm_backward_reference(x, gr, gamma, beta, sc, sh, stats,
                                          **kw)
    got = ops["gn_backward"](x, gr, gamma, beta, sc, sh, stats, G, True)
    assert _close(got, [ref[0], ref[3], ref[4], ref[1], ref[2]])
    sums = cf.groupnorm_partial_sums_reference(x, G)
    assert _close(ops["gn_split_sums"](x, G), sums)
    assert _close(ops["gn_split_apply"](x, gamma, beta, sc, sh, sums, L, G,
                                        True),
                  cf.groupnorm_apply_sums_reference(
                      x, gamma, beta, sc, sh, sums, length=L, **kw))
    assert _close(ops["gn_split_backward_sums"](x, gr, gamma, beta, sc, sh,
                                                stats, G, True),
                  cf.groupnorm_backward_partial_sums_reference(
                      x, gr, gamma, beta, sc, sh, stats, **kw))
    bsums = r(2, N, G)
    assert _close(ops["gn_split_backward_apply"](
        x, gr, gamma, beta, sc, sh, stats, bsums, L, G, True),
        cf.groupnorm_backward_apply_sums_reference(
            x, gr, gamma, beta, sc, sh, stats, bsums, length=L, **kw))
    B, Lq, Lk, H, D = 2, 6, 5, 2, 8
    q, k, v = r(B, Lq, H, D), r(B, Lk, H, D), r(B, Lk, H, D)
    s = 0.3
    assert _close(ops["flash_forward"](q, k, v, s),
                  ca.attention_reference(q, k, v, s))
    o, lse = ca.attention_lse_reference(q, k, v, s)
    assert _close(ops["flash_forward_lse"](q, k, v, s), [o, lse])
    do, glse = r(B, Lq, H, D), r(B, H, Lq)
    delta = ca.attention_delta_reference(o, do, glse)
    dq, dk, dv = ca._backward_reference(q, k, v, lse, do, delta, s)
    assert _close(ops["flash_backward_dkdv"](q, k, v, o, lse, do, glse, s),
                  [ca._rounded(q, dk), ca._rounded(q, dv), delta])
    assert _close(ops["flash_backward_dq"](q, k, v, o, lse, do, delta, s),
                  ca._rounded(q, dq))
    # Every op counts its launches on a kernel wrapper, and every wrapper
    # launches through an op.
    assert set(library.WRAPPER) == set(ops)
    assert set(library.WRAPPER.values()) == set(KERNEL_WRAPPERS)


def _views(size=8, n_views=2):
    r = np.random.RandomState(0)
    return {"imgs": r.uniform(-1, 1, (n_views, size, size, 3)).astype(
                np.float32),
            "R": np.broadcast_to(np.eye(3, dtype=np.float32),
                                 (n_views, 3, 3)).copy(),
            "T": r.randn(n_views, 3).astype(np.float32),
            "K": np.array([[9.6, 0, 4], [0, 9.6, 4], [0, 0, 1]], np.float32)}


def _boot(memcheck_dir):
    args = worker_cli.build_parser().parse_args(
        ["--device", "cpu", "--devices", "0", "--config", "test",
         "--init", "random", "--imgsize", "8", "--max_batch", "1",
         "--max_views", "2", "--hbm_budget_bytes", "1",
         "--memcheck_dir", memcheck_dir])
    return worker_cli.build_worker(args)


def test_worker_memcheck_dir_admits_and_rejects_by_the_committed_pins():
    with open(os.path.join(MEMCHECK, "step_many.json"),
              encoding="utf-8") as f:
        pin = json.load(f)["budgets"]["peak_bytes"]
    w = _boot(MEMCHECK)
    try:
        gate = w.admission
        assert gate.program_peaks["step_many"] == pin
        assert set(gate.program_peaks) == {
            "step_many", "step_many_ddim", "serving_warmup",
            "step_many_cascade_draft", "step_many_cascade_refine"}
        # The warm-up's readings are reported beside the loaded pins (on
        # the CPU it measures none), with each pin's manifest.
        pins = gate.pin_report()
        assert pins["measured_program_peaks"] == {}
        assert pins["pin_sources"] == {
            p: os.path.join(MEMCHECK, f"{p}.json")
            for p in gate.program_peaks}
        one = psched.ViewRequest(_views(), seed=1)
        gate.budget_bytes = pin + gate.record_bytes(one)
        gate.admit(one)
        with pytest.raises(psched.ReplicaOverBudget) as ei:
            gate.admit(psched.ViewRequest(_views(), seed=2))
        assert ei.value.program_peak_bytes == pin
    finally:
        w.stop()


def test_worker_memcheck_dir_missing_pins_nothing_as_the_jax_worker():
    from diff3d_tpu.serving.worker import HbmAdmission as JGate

    missing = os.path.join(ROOT, "runs", "no_such_memcheck_dir")
    w = _boot(missing)
    try:
        assert w.admission.program_peaks == {}
        assert w.admission.pin_report()["pin_sources"] == {}
    finally:
        w.stop()
    assert JGate(1, manifest_dir=missing).program_peaks == {}
