"""Checkpoint save and restore of a train state.

A checkpoint is `<ckpt_dir>/step_<N>/state.pt`, one `torch.save` of the
model's state dict, the optimizer's state dict and the step. The copy to
the host is taken synchronously inside `save_checkpoint`, so training may
go on updating the state; with `async_save` the file write then runs on a
background thread (one save in flight at a time) and `wait_for_saves`
blocks until every write is on disk, as the reference package's async
checkpointer does.

Under a model axis a checkpoint holds whole tensors, in the one-process
layout (`whole_state`), and loading keeps each rank's slice, so a run
saved at one model-axis extent restores at any other.

A seed checkpoint (`save_seed`, `<ckpt_dir>/seed/seed.pt`) holds only the
model's parameters and BatchNorm statistics, for a run that starts from
trained weights with a fresh optimizer. `load_pretrained_params` copies
the entries that match by name and shape and reports the rest.
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


def whole_state(state):
    """(model state dict, optimizer state dict) of `state` with whole
    tensors: under a model axis (`build(mesh=...)`) the sharded leaves and
    their buffers are gathered from the model group, so every model rank
    calls this; otherwise the state's own dicts."""
    from ..parallel import model_axis

    if not model_axis.specs_of(state.model):
        return state.model.state_dict(), state.optimizer.state_dict()
    return (model_axis.full_state_dict(state.model),
            model_axis.full_optimizer_state(state.model, state.optimizer))


def save_checkpoint(ckpt_dir: str, state, step: int,
                    async_save: bool = False, whole=None) -> str:
    """Save the model, optimizer and step of `state` at
    `ckpt_dir/step_<step>`; returns that directory. `whole`: the
    (model, optimizer) state dicts of `whole_state(state)`, taken by every
    rank of a model axis, to write in the one-process layout."""
    global _writer
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    model_sd, opt_sd = whole if whole is not None else (
        state.model.state_dict(), state.optimizer.state_dict())
    payload = {"model": _host(model_sd), "optimizer": _host(opt_sd),
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


_SEED_FILE = "seed.pt"


def save_seed(ckpt_dir: str, model, state_dict=None) -> str:
    """Save a seed checkpoint at `ckpt_dir/seed`: the model's parameters
    and BatchNorm statistics only (`state_dict` when given: the whole
    tensors of a model-sharded model), no optimizer state and no step, so
    a run with any solver can start from it. Returns that directory."""
    path = os.path.join(os.path.abspath(ckpt_dir), "seed")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{_SEED_FILE}.{os.getpid()}.tmp")
    sd = model.state_dict() if state_dict is None else state_dict
    torch.save({"model": _host(sd)}, tmp)
    os.replace(tmp, os.path.join(path, _SEED_FILE))
    logging.info("saved seed checkpoint %s", path)
    return path


def is_seed_checkpoint(ckpt_dir: str) -> bool:
    return os.path.isdir(os.path.join(ckpt_dir, "seed"))


def restore_seed(ckpt_dir: str, model):
    """Load the seed checkpoint of `ckpt_dir` into `model` in place (the
    caller's optimizer and step stay as they are) and return it."""
    path = os.path.join(os.path.abspath(ckpt_dir), "seed", _SEED_FILE)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    logging.info("restored seed checkpoint %s", path)
    return model


def load_pretrained_params(state_dict, src_state_dict,
                           filter_prefixes=None):
    """Partial weight loading: a copy of `state_dict` with every entry of
    `src_state_dict` of the same name and shape copied in (in the
    destination's dtype); with `filter_prefixes`, only names starting with
    one of them are taken. Returns (state dict, {"loaded": count,
    "unmatched": [names with no source of that name and shape]})."""
    out = dict(state_dict)
    loaded, unmatched = 0, []
    for name, dst in state_dict.items():
        src = src_state_dict.get(name)
        if src is None or tuple(src.shape) != tuple(dst.shape):
            unmatched.append(name)
            continue
        if filter_prefixes and not any(name.startswith(p)
                                       for p in filter_prefixes):
            continue
        out[name] = torch.as_tensor(src).to(dtype=dst.dtype,
                                            device=dst.device)
        loaded += 1
    logging.info("loaded %d tensors; %d unmatched", loaded, len(unmatched))
    return out, {"loaded": loaded, "unmatched": unmatched}


def read_model_weights(ckpt_dir: str, step: Optional[int] = None):
    """(model state dict, step) of the checkpoint of `step` (default: the
    latest) of `ckpt_dir`, on the CPU: the float32 master weights and BN
    statistics."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", _FILE)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    logging.info("read the weights of checkpoint %s", path)
    return payload["model"], step


def load_model_weights(model, ckpt_dir: str, step: Optional[int] = None
                       ) -> int:
    """Load the model weights of the checkpoint of `step` (default: the
    latest) of `ckpt_dir` into `model`, a train or an eval build (float32
    master weights are cast to the model's dtypes); returns the step."""
    weights, step = read_model_weights(ckpt_dir, step)
    model.load_state_dict(weights, strict=True)
    return step
