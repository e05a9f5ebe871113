"""Checkpoint save and restore of a train state.

A checkpoint is `<ckpt_dir>/step_<N>/state.pt`, one `torch.save` of the
model's state dict, the optimizer's state dict and the step. The copy to
the host is taken synchronously inside `save_checkpoint`, so training may
go on updating the state; with `async_save` the file write then runs on a
background thread (one save in flight at a time) and `wait_for_saves`
blocks until every write is on disk, as the reference package's async
checkpointer does.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import torch

_FILE = "state.pt"
_writer: Optional[ThreadPoolExecutor] = None
_pending: List[Future] = []


def _host(obj):
    """A copy of every tensor in `obj` on the host (a new buffer even for a
    CPU tensor, so later in-place updates do not reach it)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _write(payload, path: str):
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def wait_for_saves():
    """Block until every async checkpoint write is on disk (re-raising a
    failed write's error)."""
    while _pending:
        _pending.pop(0).result()


def save_checkpoint(ckpt_dir: str, state, step: int,
                    async_save: bool = False) -> str:
    """Save the model, optimizer and step of `state` at
    `ckpt_dir/step_<step>`; returns that directory."""
    global _writer
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    payload = {"model": _host(state.model.state_dict()),
               "optimizer": _host(state.optimizer.state_dict()),
               "step": int(state.step)}
    if async_save:
        wait_for_saves()                    # one save in flight at a time
        if _writer is None:
            _writer = ThreadPoolExecutor(max_workers=1)
        _pending.append(_writer.submit(_write, payload, path))
    else:
        _write(payload, path)
    logging.info("saved checkpoint %s%s", path,
                 " (async)" if async_save else "")
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, _FILE)):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load a checkpoint written by `save_checkpoint` (the latest unless
    `step` is given) into `state` in place, and return it."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", _FILE)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    dev = next(state.model.parameters()).device
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(_to(payload["optimizer"], dev))
    state.step = int(payload["step"])
    logging.info("restored checkpoint %s", path)
    return state
