"""The cascade sampler: a low-resolution draft pass feeding a truncated
high-resolution refinement pass (counterpart:
``diff3d_tpu/cascade/sampler.py``).

Both phases run through the ordinary
:class:`~diff3d_tpu_torch.sampling.Sampler`: the draft is a plain
few-step sampler at the low resolution over a second X-UNet, and the
refine phase is a ``start_t``-truncated sampler over the served model
whose per-view ``draft`` operand is the upsampled draft view, renoised
inside the reverse loop.  So the captured CUDA graphs, the record
contract and the object batching of the single-pass path carry over.

**The draft's weights.**  Without ``draft_params`` the draft model is the
served model resolution-adapted (``convert/progressive.py``): every
parameter but the conditioning ``pos_emb`` is resolution-independent, so
the draft model *shares* those tensors with the served model and holds
only its own resized ``pos_emb``.  A weight swap copies into the served
model in place, which reaches the shared tensors at once;
:meth:`CascadeSampler.refresh_draft` then resizes the served ``pos_emb``
into the draft's, in place (a captured graph reads every weight at the
address it had at capture).  With ``draft_params`` (a distilled student
at the draft resolution) the draft model owns its weights and a swap of
the served model leaves it alone.

**Random streams across phases.**  JAX splits ``PRNGKey(seed)`` once into
independent draft and refine keys.  The port derives two generator seeds
from the request seed (:func:`phase_seed`), so the refine stream never
depends on how many draws the draft phase took.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from diff3d_tpu_torch.cascade.plan import CascadePlan
from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.convert.progressive import POS_EMB, resize_bilinear
from diff3d_tpu_torch.models import XUNet
from diff3d_tpu_torch.sampling import Sampler

PHASES = ("draft", "refine")


def phase_seed(seed: int, phase: str) -> int:
    """The generator seed of one cascade phase of a request with
    ``seed``: two independent streams, as JAX's ``split(PRNGKey(seed))``
    gives two keys."""
    if phase not in PHASES:
        raise ValueError(f"phase={phase!r} not in {PHASES}")
    digest = hashlib.sha256(f"cascade:{int(seed)}:{phase}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def upsample_draft(draft, dst_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinearly upsample ``[..., h, w, 3]`` draft images to ``dst_hw``
    (float32 numpy, on the host), the interpolation
    ``convert/progressive.py`` uses for the positional embedding, so the
    draft the refine pass renoises is aligned with the prior the
    high-resolution model learned."""
    x = torch.as_tensor(np.asarray(draft, np.float32))
    return resize_bilinear(x, dst_hw).numpy()


def downsample_views(views: Mapping[str, np.ndarray],
                     resolution: int) -> Dict[str, np.ndarray]:
    """An ``all_views``-style dict resized to ``resolution``² for the
    draft phase: images resized bilinearly (antialiased), the intrinsics'
    fx/fy/cx/cy rows scaled with the image, poses unchanged."""
    imgs = np.asarray(views["imgs"], np.float32)
    scale = resolution / imgs.shape[1]
    out = dict(views)
    out["imgs"] = resize_bilinear(torch.from_numpy(imgs),
                                  (resolution, resolution)).numpy()
    K = np.array(views["K"], np.float32)
    K[:2] *= scale
    out["K"] = K
    return out


def _draft_model(model: XUNet, cfg: Config,
                 draft_params: Optional[Mapping[str, torch.Tensor]]
                 ) -> XUNet:
    """The draft-resolution X-UNet: its own weights from ``draft_params``,
    or every tensor shared with ``model`` except a resized ``pos_emb``."""
    device = next(model.parameters()).device
    with torch.device("meta"):         # every tensor is replaced below
        draft = XUNet(cfg.model)
    if draft_params is not None:
        draft.load_state_dict({k: v.detach().clone()
                               for k, v in draft_params.items()},
                              assign=True)
        return draft.to(device).eval()
    served = dict(model.named_parameters())
    for name, _ in list(draft.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = draft.get_submodule(owner)
        if name == POS_EMB:
            pe = served[POS_EMB]
            mod._parameters[leaf] = torch.nn.Parameter(
                resize_bilinear(pe.detach(), (cfg.model.H, cfg.model.W))
                .to(pe.dtype), requires_grad=False)
        else:
            mod._parameters[leaf] = served[name]
    return draft.to(device).eval()


class CascadeSampler:
    """Runs the two-phase cascade for one object.

    Args:
      model / cfg: the refine-resolution (served) model and its config;
        ``cfg.model`` must match ``plan.refine.resolution``.
      plan: the :class:`CascadePlan`.
      device: the samplers' device (the card unless named).
      draft_params: optional distilled-student state dict at the draft
        resolution; ``None`` shares the served weights (see the module
        docstring).
      cuda_graphs: as :class:`~diff3d_tpu_torch.sampling.Sampler`'s.
      mesh: a :class:`~diff3d_tpu_torch.parallel.MeshEnv` both phases
        split their lanes over (``Sampler(mesh=)``), so their
        ``lane_multiple``s agree.
    """

    def __init__(self, model: XUNet, cfg: Config, plan: CascadePlan, *,
                 device: Optional[Union[str, torch.device]] = None,
                 draft_params: Optional[Mapping[str, torch.Tensor]] = None,
                 cuda_graphs: Optional[bool] = None, mesh=None):
        if (cfg.model.H, cfg.model.W) != (plan.refine.resolution,) * 2:
            raise ValueError(
                f"cfg.model is {cfg.model.H}x{cfg.model.W} but the plan "
                f"refines at {plan.refine.resolution}² — the served "
                "model IS the refine phase")
        self.cfg = cfg
        self.plan = plan
        dr = plan.draft.resolution
        self.draft_cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, H=dr, W=dr))
        self.owns_draft_weights = draft_params is not None
        self.refine = Sampler(
            model, cfg, device=device, sampler_kind=plan.refine.sampler_kind,
            steps=plan.refine.steps, start_t=plan.refine.start_t,
            cuda_graphs=cuda_graphs, mesh=mesh)
        self.draft = Sampler(
            _draft_model(self.refine.model, self.draft_cfg, draft_params),
            self.draft_cfg, device=self.refine.device,
            sampler_kind=plan.draft.sampler_kind, steps=plan.draft.steps,
            cuda_graphs=cuda_graphs, mesh=mesh)
        self.device = self.refine.device

    @property
    def model_calls_per_view(self) -> int:
        """Draft + refine denoiser calls per view (the refine sampler
        already subtracts its truncated steps)."""
        return (self.draft.model_calls_per_view
                + self.refine.model_calls_per_view)

    @torch.no_grad()
    def refresh_draft(self) -> None:
        """Bring the draft's weights up to date with the served model's
        after a swap: the served ``pos_emb`` resized into the draft's, in
        place.  A no-op for a draft with weights of its own."""
        if self.owns_draft_weights:
            return
        served = self.refine.model.get_parameter(POS_EMB)
        own = self.draft.model.get_parameter(POS_EMB)
        own.copy_(resize_bilinear(served, tuple(own.shape[:2])))

    def upsample(self, drafts) -> np.ndarray:
        """Draft views → refine resolution (see :func:`upsample_draft`)."""
        return upsample_draft(drafts, (self.cfg.model.H, self.cfg.model.W))

    def synthesize_draft(self, views: Mapping[str, np.ndarray],
                         generator: Optional[torch.Generator] = None,
                         max_views: Optional[int] = None,
                         draws: Optional[Sequence] = None) -> np.ndarray:
        """The draft pass: downsample the conditioning views and run the
        draft sampler.  Returns ``[n_views-1, B, dr, dr, 3]``."""
        return self.draft.synthesize(
            downsample_views(views, self.plan.draft.resolution), generator,
            max_views=max_views, draws=draws)

    @torch.inference_mode()
    def refine_views(self, views: Mapping[str, np.ndarray], drafts,
                     generator: Optional[torch.Generator] = None,
                     max_views: Optional[int] = None,
                     draws: Optional[Sequence] = None) -> np.ndarray:
        """The refine pass: autoregressively re-synthesise views
        ``1..n_views-1`` at full resolution, each view's reverse loop
        entered at ``start_t`` from its upsampled draft.

        ``drafts`` is ``[n_views-1, B, h, w, 3]`` at either resolution
        (upsampled here, on the host, if needed).  Draws come from
        ``generator`` (seed 0 when omitted) or ``draws`` (one source per
        view), as :meth:`Sampler.synthesize` takes them; the record
        conditions on *refined* outputs, so at ``start_t = 1.0`` this is
        bit-identical to the single-pass sampler with the same draws.
        """
        imgs = np.asarray(views["imgs"], np.float32)
        n_views = imgs.shape[0] if max_views is None else min(
            imgs.shape[0], max_views)
        B = int(self.refine.w.shape[0])
        H, W = self.cfg.model.H, self.cfg.model.W
        if n_views < 2:
            return np.zeros((0, B, H, W, 3), np.float32)
        if len(drafts) < n_views - 1:
            raise ValueError(
                f"{len(drafts)} drafts for {n_views - 1} refined views")
        up = self.upsample(np.asarray(drafts, np.float32)[:n_views - 1])
        per_view = self.refine._view_draws(n_views - 1, generator, draws,
                                           "draws")
        dev = self.device
        rec, rec_R, rec_T = (torch.from_numpy(a).to(dev) for a in
                             self.refine._record_init(
                                 imgs[0], np.asarray(views["R"], np.float32),
                                 np.asarray(views["T"], np.float32),
                                 n_views))
        K = torch.from_numpy(np.asarray(views["K"], np.float32)).to(dev)
        step = 1
        for v in range(n_views - 1):
            _, rec, step = self.refine.step(
                rec, rec_R, rec_T, step, K, per_view[v],
                draft=torch.from_numpy(up[v]).to(dev))
        return rec[1:n_views].cpu().numpy()

    def synthesize_cascade(self, views: Mapping[str, np.ndarray],
                           seed: int = 0, max_views: Optional[int] = None,
                           draws: Optional[Mapping[str, Sequence]] = None
                           ) -> dict:
        """The full draft → upsample → refine pipeline for one object.

        Each phase draws from its own generator seeded with
        :func:`phase_seed` (``seed``), or from ``draws[phase]`` (one draw
        source per view) to replay another stream.  Returns ``{"draft":
        [V, B, dr, dr, 3], "refined": [V, B, H, W, 3]}`` (V = n_views -
        1).
        """
        draws = draws or {}
        gens = {p: (None if p in draws else torch.Generator(
            self.device).manual_seed(phase_seed(seed, p))) for p in PHASES}
        drafts = self.synthesize_draft(views, gens["draft"],
                                       max_views=max_views,
                                       draws=draws.get("draft"))
        refined = self.refine_views(views, drafts, gens["refine"],
                                    max_views=max_views,
                                    draws=draws.get("refine"))
        return {"draft": drafts, "refined": refined}


__all__ = ["CascadeSampler", "downsample_views", "phase_seed",
           "upsample_draft"]
