"""Carry a reference PyTorch checkpoint into the port's ``state_dict``
(counterpart: ``diff3d_tpu/convert/torch_ckpt.py``).

The reference's ``.pt`` files (``torch.save({'model': state_dict,
'optim': ..., 'step': ...})``, the published pretrained weights among
them) name their tensors after the reference's modules
(its ``xunet.py``); the port's modules carry the Flax names.
Each port parameter name maps to one reference key:

  * ``conditioningprocessor.Dense_{0,1}`` <- ``logsnr_emb_emb.{0,2}``,
    ``level_conv_{i}`` <- ``convs.{i}``; ``pos_emb [H, W, D]`` <- the
    channel-first ``[D, H, W]``; ``first_emb`` / ``other_emb`` ``[1, 1,
    1, 1, D]`` <- ``[1, 1, D, 1, 1]``;
  * ``stem_conv`` <- ``conv``; ``last_gn`` <- ``lastgn.gn``;
    ``last_conv`` <- ``lastconv``;
  * ``down_{L}_{B}`` <- ``xunetblocks.{L}.{B}``, ``down_{L}_downsample``
    <- ``xunetblocks.{L}.{num_res_blocks}``; ``up_{L}_{B}`` <-
    ``upsample.{L}.{B}``, ``up_{L}_upsample`` <-
    ``upsample.{L}.{num_res_blocks + 1}``; ``middle`` <- ``middle``;
  * inside a block: ``FrameGroupNorm_0`` / ``_1`` <- ``groupnorm0.gn`` /
    ``groupnorm1.gn`` (an attention block's: ``groupnorm.gn``),
    ``FiLM_0.Dense_0`` <- ``film.dense``, ``skip_proj`` <- ``dense``,
    ``attn`` <- ``attn_layer.attn``, ``out_conv`` <- ``linear``; the
    ``q_proj`` / ``k_proj`` / ``v_proj`` weights and biases are the three
    row blocks of ``nn.MultiheadAttention``'s packed ``in_proj_weight [3C,
    C]`` / ``in_proj_bias [3C]``.

The port's Linear and Conv weights are in torch's layout already
(``[out, in]``, ``[out, in, kh, kw]``), so nothing else is transposed.  A
leading ``module.`` (DataParallel) is stripped.  The carry is total:
every reference key is used once, every port parameter is set once, and
shapes are checked.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from diff3d_tpu_torch.config import ModelConfig

_BLOCK = re.compile(r"^(down|up)_(\d+)_(\d+|downsample|upsample)$")
_QKV = {"q_proj": 0, "k_proj": 1, "v_proj": 2}
_ATTN_BLOCKS = ("attnblock_self", "attnblock_cross")
_REF_EMB = ("first_emb", "other_emb")


def reference_key(name: str, cfg: ModelConfig) -> Tuple[str, Optional[int]]:
    """``(reference key, q/k/v row block or None)`` of port parameter
    ``name``."""
    head, *rest = name.split(".")
    if head == "conditioningprocessor":
        sub = rest[0]
        if sub in ("Dense_0", "Dense_1"):
            pre = [head, "logsnr_emb_emb", "0" if sub == "Dense_0" else "2"]
        elif sub.startswith("level_conv_"):
            pre = [head, "convs", sub[len("level_conv_"):]]
        else:                               # pos_emb, first_emb, other_emb
            return name, None
        return ".".join(pre + rest[1:]), None
    if head in ("stem_conv", "last_conv", "last_gn", "middle"):
        pre = {"stem_conv": ["conv"], "last_conv": ["lastconv"],
               "last_gn": ["lastgn", "gn"], "middle": ["middle"]}[head]
    else:
        m = _BLOCK.match(head)
        if m is None:
            raise KeyError(f"{name}: no reference counterpart")
        kind, level, blk = m.groups()
        blk = {"downsample": str(cfg.num_res_blocks),
               "upsample": str(cfg.num_res_blocks + 1)}.get(blk, blk)
        pre = ["xunetblocks" if kind == "down" else "upsample", level, blk]
    out: List[str] = []
    qkv = None
    parent = None
    for seg in rest[:-1]:
        if seg == "FrameGroupNorm_0":
            out += (["groupnorm", "gn"] if parent in _ATTN_BLOCKS
                    else ["groupnorm0", "gn"])
        elif seg == "FrameGroupNorm_1":
            out += ["groupnorm1", "gn"]
        elif seg == "FiLM_0":
            out.append("film")
        elif seg == "Dense_0" and parent == "FiLM_0":
            out.append("dense")
        elif seg == "skip_proj":
            out.append("dense")
        elif seg == "attn":
            out += ["attn_layer", "attn"]
        elif seg in _QKV:
            qkv = _QKV[seg]
        elif seg == "out_conv":
            out.append("linear")
        else:       # resnetblock, attnblock_*, conv1, conv2, out_proj
            out.append(seg)
        parent = seg
    leaf = rest[-1] if qkv is None else f"in_proj_{rest[-1]}"
    return ".".join(pre + out + [leaf]), qkv


def _port_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The port X-UNet's parameter shapes, built on the meta device (no
    memory)."""
    from diff3d_tpu_torch.models.xunet import XUNet

    with torch.device("meta"):
        model = XUNet(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def key_map(cfg: ModelConfig
            ) -> Dict[str, List[Tuple[str, Optional[int]]]]:
    """Reference key -> the port parameters it fills, each with its q/k/v
    row block (None: the whole tensor)."""
    groups: Dict[str, List[Tuple[str, Optional[int]]]] = {}
    for name in _port_shapes(cfg):
        ref, qkv = reference_key(name, cfg)
        groups.setdefault(ref, []).append((name, qkv))
    return groups


def _reference_shape(port: str, qkv: Optional[int], shape: tuple) -> tuple:
    if qkv is not None:
        return (3 * shape[0],) + shape[1:]
    if port.endswith(".pos_emb"):
        h, w, d = shape
        return (d, h, w)
    if port.rsplit(".", 1)[-1] in _REF_EMB:
        return (1, 1, shape[-1], 1, 1)
    return shape


def _to_port(t: torch.Tensor, port: str, qkv: Optional[int]) -> torch.Tensor:
    if qkv is not None:
        return t.chunk(3, dim=0)[qkv]
    if port.endswith(".pos_emb"):
        return t.permute(1, 2, 0)                    # [D,H,W] -> [H,W,D]
    if port.rsplit(".", 1)[-1] in _REF_EMB:
        return t.permute(0, 1, 3, 4, 2)              # D last
    return t


def _strip(sd: Mapping) -> Dict[str, object]:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def expected_torch_state(cfg: ModelConfig) -> Dict[str, tuple]:
    """The complete reference state-dict key set (key -> shape) of a
    ``.pt`` trained with the reference's ``XUNet`` of ``cfg``, built by
    inverting the key map over the port model's shapes (no weights are
    made)."""
    shapes = _port_shapes(cfg)
    return {ref: _reference_shape(ports[0][0], ports[0][1],
                                  shapes[ports[0][0]])
            for ref, ports in key_map(cfg).items()}


def verify_state_dict(sd: Mapping, cfg: ModelConfig) -> Dict[str, list]:
    """``{'missing': [...], 'extra': [...], 'shape_mismatch': [(key, got,
    want), ...]}`` of a reference state dict against
    :func:`expected_torch_state` -- all empty iff it converts cleanly (a
    ``module.`` prefix is stripped first)."""
    got = {k: tuple(v.shape) for k, v in _strip(sd).items()}
    want = expected_torch_state(cfg)
    return {
        "missing": sorted(want.keys() - got.keys()),
        "extra": sorted(got.keys() - want.keys()),
        "shape_mismatch": sorted(
            (k, got[k], want[k]) for k in want.keys() & got.keys()
            if got[k] != want[k]),
    }


def convert_state_dict(sd: Mapping, cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """Reference state dict (torch tensors or numpy arrays) -> the port
    ``state_dict`` of ``XUNet(cfg)``: float32 CPU tensors.  A missing or
    extra key, or a shape that does not fit, raises and names it."""
    sd = _strip(sd)
    groups = key_map(cfg)
    shapes = _port_shapes(cfg)
    missing = sorted(groups.keys() - sd.keys())
    extra = sorted(sd.keys() - groups.keys())
    if missing or extra:
        raise KeyError(f"reference state dict does not fit the port model: "
                       f"missing {missing[:5]}, extra {extra[:5]}")
    out: Dict[str, torch.Tensor] = {}
    for ref, ports in sorted(groups.items()):
        t = torch.as_tensor(sd[ref]).detach().to("cpu", torch.float32)
        for port, qkv in ports:
            value = _to_port(t, port, qkv)
            if tuple(value.shape) != shapes[port]:
                raise ValueError(
                    f"reference {ref} {tuple(t.shape)} -> {port}: shape "
                    f"{tuple(value.shape)} != port {shapes[port]}")
            out[port] = value.contiguous()
    return out


def read_torch_checkpoint(path: str) -> Tuple[Mapping, int]:
    """``(state dict, step)`` of a reference ``.pt`` (``{'model':
    state_dict, 'step': ...}`` or a bare state dict, whose step is 0)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        return ckpt["model"], int(ckpt.get("step", 0))
    return ckpt, 0


def load_torch_checkpoint(path: str, cfg: ModelConfig
                          ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Load a reference ``.pt`` and convert its model weights: ``(port
    state dict, step)``."""
    sd, step = read_torch_checkpoint(path)
    return convert_state_dict(sd, cfg), step
