"""Checkpoints of the train state (counterpart:
``diff3d_tpu/train/checkpoint.py``, its ``full`` mode).

One ``torch.save`` per checkpoint, ``<dir>/ckpt_<step>.pt``, holding
``{'model', 'ema', 'optim', 'sched', 'step'}`` -- the reference's
``{'model', 'optim', 'step'}`` plus the EMA and the warmup schedule's
position.  Written to a temporary name and renamed, so a crash never
leaves a half-written checkpoint under a final name; the newest ``keep``
are kept.  A restore gives back the exact state, so the next step is the
one the saving run would have taken.  The sliced, asynchronous and
``ema_bf16`` modes wait for a later slice.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from diff3d_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def steps(self) -> List[int]:
        """Steps of the checkpoints on disk, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, *, force: bool = False) -> bool:
        """Write ``state``; an existing checkpoint of the same step is kept
        unless ``force``.  Returns whether it wrote."""
        path = self.path(state.step)
        if os.path.exists(path) and not force:
            return False
        os.makedirs(self.directory, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": state.model.state_dict(), "ema": state.ema,
                    "optim": state.optimizer.state_dict(),
                    "sched": state.scheduler.state_dict(),
                    "step": state.step}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self.path(old))
        return True

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[int]:
        """Load checkpoint ``step`` (the latest when None) into ``state``
        in place; returns its step, or None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        # Loaded on the host: the loaders below move each tensor to its
        # parameter's device, and Adam's step counters stay on the host
        # where a fresh Adam keeps them.
        ckpt = torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optim"])
        state.scheduler.load_state_dict(ckpt["sched"])
        if set(ckpt["ema"]) != set(state.ema):
            raise KeyError("checkpoint EMA names differ from the model's")
        with torch.no_grad():
            for name, t in ckpt["ema"].items():
                state.ema[name].copy_(t)
        state.step = int(ckpt["step"])
        return state.step
