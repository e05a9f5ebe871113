"""Optimizer, train state and the train step.

The port's counterpart of the reference package's `train/state.py`. The
optimizer is written out rather than taken from `torch.optim`, because it
has to do what the reference's optax chain does:

  * `clip_by_global_norm` first, as g * max_norm / norm when norm >=
    max_norm (torch's clip_grad_norm_ divides by norm + 1e-6), over the
    trainable parameters only;
  * weight decay added to the gradient (`add_decayed_weights`) before the
    solver: SGD with momentum (trace = g + momentum * trace, the
    `momentum_buffer`), adam or adamax;
  * the learning rate from `train/lr.py` at the solver's own update count,
    before its increment;
  * frozen parameters (conf.freeze_blacklist / freeze_whitelist) get no
    update at all: no decay, no momentum (optax `multi_transform` with
    `set_to_zero`);
  * `batch_skip` = k as `optax.MultiSteps`: every call accumulates the
    running mean of the gradients, and every k-th call applies the solver
    to the mean of the k.

`make_train_step` returns `train_step(state, batch, generator) -> stats`:
forward in train mode (BN running statistics move), the loss, the
gradients, the optimizer update; stats stay tensors on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..losses.rpn_loss import RPNLossConfig, rpn_3d_loss
from .lr import make_lr_schedule

_SOLVERS = ("sgd", "adam", "adamax")
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def freeze_mask_fn(conf) -> Optional[Callable[[str], bool]]:
    """`name -> trainable` from freeze_blacklist / freeze_whitelist (a name
    is frozen when it holds a blacklisted substring, or no whitelisted
    one); None when nothing is frozen."""
    bl, wl = conf.freeze_blacklist, conf.freeze_whitelist
    if not bl and not wl:
        return None

    def fn(name: str) -> bool:
        if bl and any(p in name for p in bl):
            return False
        if wl and not any(p in name for p in wl):
            return False
        return True

    return fn


class Optimizer:
    """The reference's optax chain over named float32 parameters.

    `state` holds, per trainable parameter, the solver's buffers
    ("momentum_buffer" for sgd; "exp_avg" and "exp_avg_sq" for adam;
    "exp_avg" and "exp_inf" for adamax), and the counts `count` (solver
    updates) and `mini_step` (calls since the last update with batch_skip
    > 1) with the accumulated gradients `acc`.
    """

    def __init__(self, conf, max_iter: int, names: List[str],
                 trainable: Optional[Callable[[str], bool]] = None):
        solver = conf.solver_type.lower()
        if solver not in _SOLVERS:
            raise ValueError(f"solver {conf.solver_type} not supported")
        self.solver = solver
        self.sched = make_lr_schedule(conf, max_iter)
        self.weight_decay = float(conf.weight_decay)
        self.momentum = float(conf.momentum)
        self.clip_norm = conf.grad_clip_norm or None
        self.every = max(int(conf.batch_skip or 1), 1)
        self.names = [n for n in names if trainable is None or trainable(n)]
        self.count = 0
        self.mini_step = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.acc: Dict[str, torch.Tensor] = {}

    def lr(self) -> float:
        """The learning rate of the next solver update."""
        return self.sched(self.count)

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> bool:
        """Update `params` in place from `grads` (both keyed by name; frozen
        names are ignored). Returns whether the solver ran (always, unless
        batch_skip > 1 holds this call's gradients back)."""
        with torch.no_grad():
            if self.every > 1:
                n = self.mini_step
                for name in self.names:
                    g = grads[name]
                    acc = self.acc.get(name)
                    self.acc[name] = g.clone() if acc is None \
                        else acc + (g - acc) / (n + 1)
                if n < self.every - 1:
                    self.mini_step += 1
                    return False
                self.mini_step = 0
                grads, self.acc = self.acc, {}
            self._apply(params, grads)
        return True

    def _apply(self, params, grads):
        names = self.names
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        if self.clip_norm:
            norm = torch.sqrt(sum(torch.sum(v * v) for v in g))
            keep = norm < self.clip_norm
            g = [torch.where(keep, v, (v / norm) * self.clip_norm) for v in g]
        if self.weight_decay:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        lr = self.sched(self.count)
        t = self.count + 1
        states = [self.state.setdefault(n, {}) for n in names]
        if self.solver == "sgd":
            if "momentum_buffer" not in states[0]:
                bufs = [v.clone() for v in g]
            else:
                bufs = [st["momentum_buffer"] for st in states]
                torch._foreach_mul_(bufs, self.momentum)
                torch._foreach_add_(bufs, g)
            for st, buf in zip(states, bufs):
                st["momentum_buffer"] = buf
            torch._foreach_add_(p, bufs, alpha=-lr)
        else:
            for st, v, param in zip(states, g, p):
                m = st.get("exp_avg", torch.zeros_like(v))
                m = (1 - _B1) * v + _B1 * m
                if self.solver == "adam":
                    s2 = st.get("exp_avg_sq", torch.zeros_like(v))
                    s2 = (1 - _B2) * (v * v) + _B2 * s2
                    st["exp_avg"], st["exp_avg_sq"] = m, s2
                    u = (m / (1 - _B1 ** t)) / (
                        torch.sqrt(s2 / (1 - _B2 ** t)) + _EPS)
                else:
                    s2 = st.get("exp_inf", torch.zeros_like(v))
                    s2 = torch.maximum(torch.abs(v) + _EPS, _B2 * s2)
                    st["exp_avg"], st["exp_inf"] = m, s2
                    u = (m / (1 - _B1 ** t)) / s2
                param.add_(-lr * u)
        self.count += 1

    def state_dict(self) -> dict:
        return {"solver": self.solver, "count": self.count,
                "mini_step": self.mini_step, "acc": dict(self.acc),
                "state": {n: dict(s) for n, s in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        if sd["solver"] != self.solver:
            raise ValueError(f"optimizer state of {sd['solver']}, this "
                             f"optimizer runs {self.solver}")
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])
        self.acc = dict(sd["acc"])
        self.state = {n: dict(s) for n, s in sd["state"].items()}


@dataclasses.dataclass
class TrainState:
    """The model (train mode, float32 master parameters), its optimizer and
    the count of train steps taken."""
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    trainable: Optional[Callable[[str], bool]] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(conf, model, max_iter: int,
                       trainable_mask_fn=None) -> TrainState:
    """A TrainState for a model from `build(conf, phase="train")`."""
    if trainable_mask_fn is None:
        trainable_mask_fn = freeze_mask_fn(conf)
    names = [n for n, _ in model.named_parameters()]
    opt = Optimizer(conf, max_iter, names, trainable_mask_fn)
    return TrainState(model=model, optimizer=opt, step=0,
                      trainable=trainable_mask_fn)


def make_train_step(conf, rois: np.ndarray, packed_input: bool = False):
    """`train_step(state, batch, generator) -> stats`.

    batch: the loader's dict of tensors (images [B,H,W,3], or with
    `packed_input` their space-to-depth packing [B,H/2,W/2,12]; labels,
    labels_fg/bg/ign [B,N]; bbox_2d [B,4,N]; bbox_3d [B,7,N]; any_val [B]),
    moved to the model's device here. `generator` (on that device) draws the
    loss's random sampling when hard_negatives is off. Frozen layers'
    BatchNorm running statistics are put back after the forward.

    With conf.pre_compute_target off, the batch carries padded gts
    (`targets.build_gt_arrays` keys) instead of the targets, and the step
    assigns the targets on the device before the forward
    (`ops/targets_device.py`).
    """
    loss_cfg = RPNLossConfig.from_conf(conf)
    target_fn = None
    if not conf.pre_compute_target:
        from ..ops.targets_device import make_device_target_fn

        target_fn = make_device_target_fn(conf, rois)
    consts = {}

    def constants(dev):
        if dev not in consts:
            f32 = torch.float32
            consts[dev] = (
                torch.as_tensor(np.asarray(rois)[:, :5], dtype=f32,
                                device=dev),
                torch.as_tensor(np.asarray(conf.anchors), dtype=f32,
                                device=dev),
                torch.as_tensor(np.asarray(conf.bbox_means), dtype=f32,
                                device=dev),
                torch.as_tensor(np.asarray(conf.bbox_stds), dtype=f32,
                                device=dev))
        return consts[dev]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        model = state.model
        dev = next(model.parameters()).device
        batch = {k: (v.to(dev, non_blocking=True)
                     if isinstance(v, torch.Tensor) else v)
                 for k, v in batch.items()}
        if target_fn is not None:
            batch.update(target_fn(batch))
        pinned = {}
        if state.trainable is not None:
            pinned = {n: b.clone() for n, b in model.named_buffers()
                      if not state.trainable(n)}
        model.train()
        outputs = model(batch["images"], packed=packed_input)
        loss, stats = rpn_3d_loss(outputs, batch, *constants(dev), loss_cfg,
                                  generator)
        params = state.params()
        names = state.optimizer.names
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        del outputs, loss
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        state.optimizer.step(params, grads)
        if pinned:
            with torch.no_grad():
                bufs = dict(model.named_buffers())
                for n, b in pinned.items():
                    bufs[n].copy_(b)
        state.step += 1
        return stats

    return train_step
