"""Eval-time BatchNorm folding: BN with running statistics folded into the
preceding linear op, in place on an eval model.

The port's counterpart of the reference package's `utils/fold_bn.py`. For
a frozen graph BN is a per-channel affine map of the linear op's output:

    BN(conv(x)) = s * (W x + b - mean) + beta,   s = scale / sqrt(var + eps)
                = (s*W) x + (s*(b - mean) + beta)

so the scale folds into the weight and the shift into a bias. Folding
happens only at the module scopes whose conv -> BN adjacency holds by
construction, as in the reference package:

  * `ConvBNAct` (models/layers.py): children {Conv_0, BatchNorm_0};
  * `DeformConv` (models/necks.py): {DCN_0, BatchNorm_0}; the DCN output is
    linear in its weight and bias, so BN folds the same way;
  * the head `Tower` (models/rpn.py): {Conv_0, BatchNorm_0, Conv_1,
    BatchNorm_1, Conv_2}.

A module is matched by the set of its children that hold parameters, as
the reference package matches a flax scope by its parameter keys (ANAB
interleaves gate convs, so its BNs stay unfolded). An OIHW conv weight
scales along dim 0, a [K, K, Cin, Cout] DCN weight along its last dim.
Each folded BN is left as an exact identity-plus-bias: weight 1, mean 0,
var 1 - eps (so 1/sqrt(var + eps) is 1.0), with any additive constant in
its bias; the state dict keeps its keys and shapes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_TOWER = {"Conv_0", "BatchNorm_0", "Conv_1", "BatchNorm_1", "Conv_2"}


def _fold_pair(lin: nn.Module, bn: nn.BatchNorm2d, out_dim: int, get):
    """Fold `bn` into `lin` (its weight's output channels along
    `out_dim`), in float64 from the tensors `get(module, name)` gives and
    rounded once to each tensor's dtype."""
    eps = bn.eps
    s = get(bn, "weight") / torch.sqrt(get(bn, "running_var") + eps)
    shape = [1] * lin.weight.dim()
    shape[out_dim] = -1
    lin.weight.copy_(get(lin, "weight") * s.reshape(shape))
    add = get(bn, "bias") - get(bn, "running_mean") * s
    if lin.bias is not None:
        # the linear op's own bias scales too; all of it moves into that
        # bias and the BN becomes the identity
        lin.bias.copy_(get(lin, "bias") * s + add)
        add = torch.zeros_like(add)
    bn.weight.fill_(1.0)
    bn.bias.copy_(add)
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - eps)


def _param_children(mod: nn.Module):
    return {name for name, child in mod.named_children()
            if any(True for _ in child.parameters())}


def fold_bn_eval(model: nn.Module, master=None) -> int:
    """Fold BN into the preceding conv at every known-safe scope of
    `model`, in place; returns the number of BNs folded. Exact for eval
    (running-statistics BN) up to rounding; do not train a folded
    model.

    `master`: a state dict of `model` at a higher precision than its
    tensors, such as a checkpoint's float32 master weights that a bf16
    eval build was cast from. The fold then reads its inputs from there,
    so each folded tensor is rounded to the model's dtype once, as the
    reference package folds its float32 parameters before the cast."""
    names = {id(m): n for n, m in model.named_modules()}

    def get(mod, name):
        t = getattr(mod, name) if master is None else \
            master[f"{names[id(mod)]}.{name}".lstrip(".")]
        return t.detach().to(device=getattr(mod, name).device,
                             dtype=torch.float64)

    n = 0
    with torch.no_grad():
        for mod in model.modules():
            keys = _param_children(mod)
            if keys in ({"Conv_0", "BatchNorm_0"}, _TOWER):
                for i in (0, 1):
                    conv = getattr(mod, f"Conv_{i}", None)
                    bn = getattr(mod, f"BatchNorm_{i}", None)
                    if conv is not None and isinstance(bn, nn.BatchNorm2d):
                        _fold_pair(conv, bn, 0, get)
                        n += 1
            elif keys == {"DCN_0", "BatchNorm_0"} and isinstance(
                    mod.BatchNorm_0, nn.BatchNorm2d):
                _fold_pair(mod.DCN_0, mod.BatchNorm_0, -1, get)
                n += 1
    return n
