"""Carry the JAX package's Flax parameter tree into the port's
``state_dict`` (the inverse direction of ``diff3d_tpu/convert/
torch_ckpt.py``), and a whole JAX ``TrainState`` into the port's.

The port's modules carry the Flax module names, so a Flax leaf path names
its port parameter:

  * ``.../kernel`` of a Conv ``[kh, kw, in, out]`` -> ``.../weight``
    ``[out, in, kh, kw]``; of a Dense ``[in, out]`` -> ``[out, in]``;
  * ``.../GroupNorm_0/scale`` / ``bias`` -> ``.../weight`` / ``bias`` of
    the enclosing ``FrameGroupNorm``;
  * ``.../bias`` -> ``.../bias``; ``pos_emb``, ``first_emb`` and
    ``other_emb`` as they are.

The carry is total: every Flax leaf is consumed exactly once, every port
parameter is set exactly once, and shapes are checked; a missing or
extra key raises and names it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_AS_IS = ("pos_emb", "first_emb", "other_emb")


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> ``{'a/b/c': leaf}``; keys already joined by ``/``
    pass through."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def port_key(path: str, leaf: np.ndarray):
    """``(port state_dict key, torch tensor)`` of one Flax leaf."""
    parts = path.split("/")
    name = parts[-1]
    if len(parts) >= 2 and parts[-2] == "GroupNorm_0" \
            and name in ("scale", "bias"):
        parts = parts[:-2] + ["weight" if name == "scale" else "bias"]
        value = leaf
    elif name == "kernel":
        parts[-1] = "weight"
        if leaf.ndim == 4:
            value = leaf.transpose(3, 2, 0, 1)
        elif leaf.ndim == 2:
            value = leaf.T
        else:
            raise ValueError(f"{path}: kernel of rank {leaf.ndim}")
    elif name == "bias" or name in _AS_IS:
        value = leaf
    else:
        raise KeyError(f"{path}: no port counterpart for Flax leaf "
                       f"{name!r}")
    tensor = torch.from_numpy(
        np.ascontiguousarray(value, dtype=np.float32))
    return ".".join(parts), tensor


def convert_params(params: Mapping, model: nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` for ``model`` from a Flax ``params`` tree
    (nested dicts of arrays, or one flat ``/``-joined dict)."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in sorted(flatten(params).items()):
        key, tensor = port_key(path, leaf)
        if key not in expected:
            raise KeyError(f"Flax leaf {path} -> {key}: the port model has "
                           "no such parameter")
        if key in out:
            raise KeyError(f"Flax leaf {path} -> {key}: set twice")
        if tuple(tensor.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"Flax leaf {path} -> {key}: shape {tuple(tensor.shape)} "
                f"!= port {tuple(expected[key].shape)}")
        out[key] = tensor
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters with no Flax leaf: {missing}")
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a Flax parameter tree into ``model`` in place (on the
    model's device)."""
    model.load_state_dict(convert_params(params, model), strict=True)
    return model


def load_flax_train_state(state, *, params: Mapping, ema_params: Mapping,
                          mu: Mapping, nu: Mapping, adam_count: int,
                          schedule_count: int, step: int):
    """Carry a JAX ``TrainState`` into the port's
    :class:`~diff3d_tpu_torch.train.TrainState` in place: the parameters,
    the EMA, Adam's first / second moments (``ScaleByAdamState.mu`` /
    ``nu``, the same tree as the parameters) and its count (torch's per
    parameter ``step``), the warmup schedule's count
    (``ScaleByScheduleState.count``) and ``TrainState.step``.  The trees
    are numpy, as :func:`convert_params` takes them; the JAX side
    extracts them."""
    from diff3d_tpu_torch.train.state import set_schedule_step

    model = state.model
    load_flax_params(model, params)
    ema, m1, m2 = (convert_params(t, model) for t in (ema_params, mu, nu))
    with torch.no_grad():
        for name, p in model.named_parameters():
            state.ema[name].copy_(ema[name])
            state.optimizer.state[p] = {
                "step": torch.tensor(float(adam_count)),
                "exp_avg": m1[name].to(p.device),
                "exp_avg_sq": m2[name].to(p.device)}
    set_schedule_step(state, int(schedule_count))
    state.step = int(step)
    return state


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """A Flax parameter tree saved as an ``.npz`` of ``/``-joined paths."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}
