"""The port's cascades (``diff3d_tpu_torch/cascade/sampler.py`` and
``request.py``, the engine's cascade surface, ``POST /cascade``) on the
CPU, against the JAX package's (``diff3d_tpu/cascade``).

The tiny X-UNet at 16² with random weights in both packages, the draft
at 8², plan ``draft=8:ddim:2,refine=16:ancestral:4@t0.5``.  The resizes
are held to 1e-6, the cascade's views to 1e-5 with the JAX package's
split draws replayed (``test_torch_port_sampler.py`` gives the reason
for 1e-5); the served cascade bit for bit against the port's own
offline ``CascadeSampler`` on the same phase seeds.  Every wait has its
own timeout.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu.cascade import CascadePlan as JPlan  # noqa: E402
from diff3d_tpu.cascade import CascadeSampler as JCascade  # noqa: E402
from diff3d_tpu.cascade import sampler as jcascade  # noqa: E402
from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.diffusion import ScheduleError as JScheduleError  # noqa: E402
from diff3d_tpu.diffusion import schedule_start_index as j_start  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.serving import worker as jworker  # noqa: E402
from diff3d_tpu_torch import config as pconfig  # noqa: E402
from diff3d_tpu_torch.cascade import (CascadePlan, CascadeRequest,  # noqa: E402
                                      CascadeSampler, phase_seed)
from diff3d_tpu_torch.cascade import sampler as pcascade  # noqa: E402
from diff3d_tpu_torch.convert import load_flax_params  # noqa: E402
from diff3d_tpu_torch.convert.progressive import POS_EMB  # noqa: E402
from diff3d_tpu_torch.diffusion import ScheduleError  # noqa: E402
from diff3d_tpu_torch.diffusion import schedule_start_index  # noqa: E402
from diff3d_tpu_torch.models import build_model  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.serving import ServingService, server  # noqa: E402
from diff3d_tpu_torch.serving import worker as pworker  # noqa: E402
from test_torch_port_sampler import jax_view_draws  # noqa: E402

H, DR = 16, 8
PLAN = "draft=8:ddim:2,refine=16:ancestral:4@t0.5"
WAIT = 60.0
SERVING = dict(port=0, max_batch=2, max_queue=8, max_wait_ms=20.0,
               max_views=8, default_timeout_s=60.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the tiny model (the engine thread inherits
    it): at this size the thread pool costs more than it saves."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _views(seed, n=3, size=H):
    r = np.random.default_rng(seed)
    q, _ = np.linalg.qr(r.normal(size=(n, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    return {"imgs": r.uniform(-1, 1, (n, size, size, 3)).astype(np.float32),
            "R": R, "T": r.normal(0, 1.3, (n, 3)).astype(np.float32),
            "K": np.array([[1.2 * size, 0, size / 2],
                           [0, 1.2 * size, size / 2], [0, 0, 1]],
                          np.float32)}


@pytest.fixture(scope="module")
def env():
    """The tiny X-UNet at 16² with the same random weights in both
    packages, and both packages' cascade samplers over it (built once)."""
    jcfg = jax_tiny_config(imgsize=H, ch=8)
    pcfg = dataclasses.replace(
        pconfig.test_config(imgsize=H, ch=8),
        serving=pconfig.ServingConfig(**SERVING))
    jm = JXUNet(jcfg.model)
    B = len(jcfg.diffusion.guidance_weights)
    batch = {"x": np.zeros((2 * B, H, H, 3), np.float32),
             "z": np.zeros((2 * B, H, H, 3), np.float32),
             "logsnr": np.zeros((2 * B, 2), np.float32),
             "R": np.zeros((2 * B, 2, 3, 3), np.float32),
             "t": np.zeros((2 * B, 2, 3), np.float32),
             "K": np.tile(np.eye(3, dtype=np.float32), (2 * B, 1, 1))}
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch, cond_mask=np.ones(2 * B, bool)))
    rng = np.random.default_rng(8)
    flat = {k: (0.08 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in flatten_dict(shapes["params"], sep="/").items()}
    params = unflatten_dict(flat, sep="/")
    model = build_model(pcfg.model, device="cpu")
    load_flax_params(model, flat)
    jc = JCascade(jm, params, jcfg, JPlan.parse(PLAN))
    pc = CascadeSampler(model, pcfg, CascadePlan.parse(PLAN), device="cpu")
    return jcfg, pcfg, jc, pc, model, B


# --- resizes and intrinsics ---------------------------------------------------


@pytest.mark.parametrize("src,dst", [(8, 16), (8, 12), (6, 16), (16, 16)])
def test_upsample_draft_matches_jax(src, dst):
    drafts = np.random.default_rng(src * dst).uniform(
        -1, 1, (2, 3, src, src, 3)).astype(np.float32)
    ref = np.asarray(jcascade.upsample_draft(drafts, (dst, dst)))
    out = pcascade.upsample_draft(drafts, (dst, dst))
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("src,res", [(16, 8), (16, 6), (12, 8), (16, 12)])
def test_downsample_views_matches_jax(src, res):
    views = _views(src + res, size=src)
    ref = jcascade.downsample_views(views, res)
    out = pcascade.downsample_views(views, res)
    np.testing.assert_allclose(out["imgs"], ref["imgs"], atol=1e-6, rtol=0)
    # The intrinsics' fx/fy/cx/cy rows scale with the image, exactly as
    # the JAX package scales them; the poses pass through unchanged.
    np.testing.assert_array_equal(out["K"], ref["K"])
    np.testing.assert_allclose(out["K"][:2], views["K"][:2] * res / src,
                               rtol=1e-6)
    np.testing.assert_array_equal(out["K"][2], views["K"][2])
    for k in ("R", "T"):
        assert out[k] is views[k]


# --- the cascade sampler ------------------------------------------------------


def _jax_cascade_draws(seed, n_views, B, jcfg, plan):
    """The draws ``CascadeSampler.synthesize_cascade`` takes from
    ``PRNGKey(seed)``: one split into the draft and refine keys, each
    then threaded per view."""
    k_draft, k_refine = jax.random.split(jax.random.PRNGKey(seed))
    n_refine = plan.refine.steps - j_start(
        plan.refine.steps, plan.refine.start_t,
        timesteps=jcfg.diffusion.timesteps)
    out = {}
    for phase, key, size, n in (("draft", k_draft, DR, plan.draft.steps),
                                ("refine", k_refine, H, n_refine)):
        out[phase] = []
        for view in range(1, n_views):
            key, d = jax_view_draws(key, (B, size, size, 3), n, view)
            out[phase].append(d)
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_cascade_sampler_matches_jax(env, seed):
    """Draft and refined views of a 3-view object against the JAX
    ``CascadeSampler`` with its split draws replayed: 1e-5."""
    jcfg, _, jc, pc, _, B = env
    views = _views(seed)
    ref = jc.synthesize_cascade(views, jax.random.PRNGKey(seed))
    out = pc.synthesize_cascade(
        views, draws=_jax_cascade_draws(seed, 3, B, jcfg, jc.plan))
    assert out["draft"].shape == (2, B, DR, DR, 3)
    assert out["refined"].shape == (2, B, H, H, 3)
    np.testing.assert_allclose(out["draft"], np.asarray(ref["draft"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out["refined"], np.asarray(ref["refined"]),
                               atol=1e-5, rtol=1e-5)


def test_refine_at_start_t_one_is_the_single_pass_sampler(env):
    """A refine phase truncated at t = 1.0 ignores its drafts: bit for
    bit the port's untruncated ``synthesize`` on the same generator."""
    _, pcfg, _, _, model, B = env
    casc = CascadeSampler(model, pcfg, CascadePlan.parse(
        "draft=8:ddim:2,refine=16:ancestral:4@t1"), device="cpu")
    views = _views(21)
    drafts = np.random.default_rng(2).uniform(
        -1, 1, (2, B, DR, DR, 3)).astype(np.float32)
    out = casc.refine_views(views, drafts, torch.Generator().manual_seed(9))
    ref = Sampler(model, pcfg, device="cpu", steps=4).synthesize(
        views, torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("spec", [
    PLAN, "draft=8:ancestral:4,refine=16:ddim:2@t0.5",
    "draft=8:ddim:1,refine=16:ancestral:4@t0.25",
    "draft=8:ddim:2,refine=16:ancestral:4@t1"])
def test_model_calls_per_view_match_jax(env, spec):
    jcfg, pcfg, jc, _, model, _ = env
    params = jc.refine.params
    ref = JCascade(jc.refine.model, params, jcfg, JPlan.parse(spec))
    out = CascadeSampler(model, pcfg, CascadePlan.parse(spec), device="cpu")
    assert out.model_calls_per_view == ref.model_calls_per_view


def test_draft_shares_the_served_weights_but_pos_emb(env):
    """Every draft tensor but ``pos_emb`` IS the served model's; the
    draft's ``pos_emb`` is the served one resized, and ``refresh_draft``
    writes a changed one into it in place."""
    _, pcfg, _, _, model, _ = env
    casc = CascadeSampler(model, pcfg, CascadePlan.parse(PLAN),
                          device="cpu")
    served = dict(model.named_parameters())
    draft = dict(casc.draft.model.named_parameters())
    assert draft.keys() == served.keys()
    assert all(draft[k] is served[k] for k in draft if k != POS_EMB)
    assert tuple(draft[POS_EMB].shape[:2]) == (DR, DR)
    ptr = draft[POS_EMB].data_ptr()
    before = draft[POS_EMB].detach().clone()
    with torch.no_grad():
        served[POS_EMB].add_(0.5)
    try:
        casc.refresh_draft()
        assert draft[POS_EMB].data_ptr() == ptr
        assert not torch.equal(draft[POS_EMB], before)
        want = pcascade.upsample_draft(
            served[POS_EMB].detach().numpy(), (DR, DR))
        np.testing.assert_array_equal(draft[POS_EMB].detach().numpy(),
                                      want)
    finally:
        with torch.no_grad():
            served[POS_EMB].sub_(0.5)


def test_phase_seeds_are_two_streams():
    seeds = {(s, p): phase_seed(s, p) for s in range(50)
             for p in ("draft", "refine")}
    assert len(set(seeds.values())) == 100
    assert all(0 <= v < 2 ** 63 for v in seeds.values())
    with pytest.raises(ValueError):
        phase_seed(0, "preview")


def test_readme_plan_is_off_the_refine_grid_in_both_packages():
    """The plan ``README.md`` gave, ``refine=128:ancestral:64@t0.4``,
    starts between grid points of the 64-step schedule (0.4 x 64 =
    25.6), so both packages refuse it; ``@t0.40625`` is the grid point
    that leaves 26 refine steps."""
    for start in (j_start, schedule_start_index):
        err = JScheduleError if start is j_start else ScheduleError
        with pytest.raises(err, match="not a grid point"):
            start(64, 0.4, timesteps=256)
        assert 64 - start(64, 0.40625, timesteps=256) == 26


# --- the served cascade ---------------------------------------------------------


@pytest.fixture(scope="module")
def service(env):
    _, pcfg, _, pc, model, _ = env
    svc = ServingService(Sampler(model, pcfg, device="cpu"), pcfg,
                         cascade=pc).start(serve_http=True)
    yield svc
    svc.stop()


def _payload(seed, **kw):
    return {"views": {k: v.tolist() for k, v in _views(seed).items()},
            "seed": seed, **kw}


def _post(port, payload, path="/cascade"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.status, r.read()


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def test_served_cascade_events_cursor_and_offline_result(env, service):
    """One cascade posted ``block=false`` and polled through ``?from=K``:
    2 draft events before 2 refine events, a gapless cursor, the refined
    result bit for bit the offline ``synthesize_cascade`` on the same
    seed, and each draft event the offline draft."""
    _, _, _, pc, _, _ = env
    port = service.port
    status, head = _post(port, _payload(31, block=False))
    head = json.loads(head)
    assert status == 202 and head["n_frames"] == 2 and head["n_events"] == 4
    events, nxt = [], 0
    deadline = time.monotonic() + WAIT
    while True:
        assert time.monotonic() < deadline, "cascade did not finish"
        _, poll = _get_json(port, f"/result/{head['id']}?from={nxt}")
        assert poll["from"] == nxt
        assert [e["event"] for e in poll["events"]] == list(
            range(nxt, poll["next"]))
        events += poll["events"]
        nxt = poll["next"]
        if poll["status"] == "done":
            break
        assert poll["status"] == "running"
        time.sleep(0.02)
    assert nxt == 4 and poll["events_committed"] == 4
    assert [(e["phase"], e["frame"]) for e in events] == [
        ("draft", 0), ("draft", 1), ("refine", 0), ("refine", 1)]
    ref = pc.synthesize_cascade(_views(31), seed=31)
    _, body = _get_json(port, f"/result/{head['id']}")
    np.testing.assert_array_equal(np.asarray(body["views"], np.float32),
                                  ref["refined"])
    for e in events:
        want = ref["draft" if e["phase"] == "draft" else "refined"]
        np.testing.assert_array_equal(np.asarray(e["view"], np.float32),
                                      want[e["frame"]])
    counters = service.metrics_snapshot()["counters"]
    assert counters["serving_cascade_requests_total"] >= 1
    assert counters["serving_cascade_frames_total"] >= 4


def test_served_cascade_streams_ndjson_and_refuses_schedules(service):
    port = service.port
    status, raw = _post(port, _payload(32, stream=True))
    lines = [json.loads(ln) for ln in raw.decode().splitlines() if ln]
    assert status == 200 and lines[0]["status"] == "streaming"
    assert lines[0]["n_events"] == 4 and lines[-1]["status"] == "done"
    assert [ln["phase"] for ln in lines[1:-1]] == ["draft", "draft",
                                                  "refine", "refine"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, _payload(33, steps=2))
    assert ei.value.code == 400
    _, health = _get_json(port, "/healthz")
    assert health["cascade"] == CascadePlan.parse(PLAN).spec()


def test_a_swap_refreshes_the_served_draft_in_place(env):
    """A swap between cascades: the draft's ``pos_emb`` is refreshed in
    place (same address), no new loop is built, and the result equals
    the offline cascade over the swapped weights; swapping back restores
    the first result bit for bit."""
    _, pcfg, _, _, model, _ = env
    own = build_model(pcfg.model, device="cpu")
    own.load_state_dict(model.state_dict())
    casc = CascadeSampler(own, pcfg, CascadePlan.parse(PLAN), device="cpu")
    svc = ServingService(Sampler(own, pcfg, device="cpu"), pcfg,
                         cascade=casc).start(serve_http=False)
    try:
        pe = casc.draft.model.get_parameter(POS_EMB)
        ptr = pe.data_ptr()
        base = svc.submit_cascade(_payload(41)).result(timeout=WAIT)
        loops = (set(casc.draft._loops), set(casc.refine._loops))
        orig = {k: t.clone() for k, t in own.state_dict().items()}
        svc.registry.swap({k: t + 0.05 for k, t in orig.items()}, "v1")
        swapped = svc.submit_cascade(_payload(41)).result(timeout=WAIT)
        assert pe.data_ptr() == ptr
        assert (set(casc.draft._loops), set(casc.refine._loops)) == loops
        ref_model = build_model(pcfg.model, device="cpu")
        ref_model.load_state_dict({k: t + 0.05 for k, t in orig.items()})
        ref = CascadeSampler(ref_model, pcfg, CascadePlan.parse(PLAN),
                             device="cpu").synthesize_cascade(
            _views(41), seed=41)
        np.testing.assert_array_equal(swapped, ref["refined"])
        svc.registry.swap(orig, "v2")
        again = svc.submit_cascade(_payload(41)).result(timeout=WAIT)
        np.testing.assert_array_equal(again, base)
        assert not np.array_equal(swapped, base)
    finally:
        svc.stop()


def test_no_cascade_plan_is_503_and_plan_mismatch_refused(env):
    _, pcfg, _, _, model, _ = env
    svc = ServingService(Sampler(model, pcfg, device="cpu"),
                         pcfg).start(serve_http=True)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(svc.port, _payload(1))
        assert ei.value.code == 503
        other = CascadeRequest(_views(1), CascadePlan.parse(
            "draft=8:ddim:1,refine=16:ancestral:4@t0.5"))
        with pytest.raises(Exception, match="no cascade plan"):
            svc.engine.submit_cascade(other)
    finally:
        svc.stop()


# --- admission ----------------------------------------------------------------


def test_admission_charges_each_phase_its_pin(env):
    """Draft child, refine child and the parent against the same pins in
    both packages: the phase names, the pin each is charged, and the
    same admit / refuse decisions when the record bytes agree."""
    _, pcfg, _, _, _, B = env
    pins = {"step_many": 1000, "step_many_cascade_draft": 300,
            "step_many_cascade_refine": 5000}
    for kind in (None, "ancestral", "ddim"):
        for phase in (None, "draft", "refine"):
            assert (pworker.program_for_schedule(kind, phase)
                    == jworker.program_for_schedule(kind, phase))
    parent = server.build_cascade_request(_payload(5), pcfg,
                                          CascadePlan.parse(PLAN))
    draft = parent.make_draft_child(lambda r: None)
    refine = parent.make_refine_child(np.zeros((2, B, DR, DR, 3),
                                               np.float32))
    assert (draft.bucket.H, draft.bucket.phase) == (DR, "draft")
    assert (refine.bucket.H, refine.bucket.phase) == (H, "refine")
    decisions = []
    for mod in (pworker, jworker):
        gate = (mod.HbmAdmission(0, program_peaks=pins, guidance_B=B)
                if mod is pworker else mod.HbmAdmission(
                    0, manifest_dir="/nonexistent-manifests"))
        gate.program_peaks = dict(pins)
        charged = [gate.program_peak(r.sampler_kind, r.bucket.phase)
                   for r in (draft, refine)]
        gate.budget_bytes = 6000 + 2 * pworker.HbmAdmission(
            guidance_B=B).record_bytes(refine)
        gate.record_bytes = pworker.HbmAdmission(guidance_B=B).record_bytes
        got = []
        for r in (parent, draft, refine, draft):
            try:
                gate.admit(r)
                got.append("ok")
            except Exception as e:          # the typed refusal
                got.append(type(e).__name__)
        decisions.append((charged, got))
    assert decisions[0] == decisions[1]
    assert decisions[0][0] == [300, 5000]
    assert decisions[0][1] == ["ok", "ok", "ReplicaOverBudget", "ok"]
