"""Import checkpoints of the original PyTorch model (and ImageNet DLA
weights) into the port.

The port's counterpart of the reference package's `utils/torch_import.py`.
The port's module names follow the reference package's flax names
(`utils/weights.py`), so each entry of the port's state dict has a flax
path (module path, leaf), and `flax_to_torch_key` translates that path into
the original model's state-dict key, as the reference package does. The
converters take the original tensor to the port's layout:

  * conv weights stay OIHW;
  * deformable and align weights OIHW -> [K, K, Cin, Cout] (the layout the
    shift-DCN kernel takes);
  * upsampling ConvTranspose weights [C, 1, 2f, 2f] stay as they are: the
    reference package flips them into its correlation kernel, and
    `from_flax_variables` flips them back;
  * DCN offset-mask conv: the original kernel reads tap k's (dy, dx) from
    channels (2k, 2k+1) and the mask from the last third; the port takes
    thirds [dy x KK | dx x KK | mask x KK], so the output channels are
    permuted;
  * classification tower's last conv: original channel c * A + a, the
    port's a * C + c, permuted.

`load_reference_checkpoint(model, state_dict, num_anchors, num_classes)`
returns the port's state dict with every translated tensor replaced, and
counts of what loaded and lists of what did not (partial loading: a key
that does not translate or is missing keeps the model's value).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

Converter = Callable[[torch.Tensor], torch.Tensor]

# --------------------------------------------------------------------------
# converters (original tensor -> the port's layout)
# --------------------------------------------------------------------------


def _ident(t):
    return t


def _dcn_w(t):
    """OIHW -> [K, K, Cin, Cout]."""
    return t.permute(2, 3, 1, 0)


def _offset_mask_perm(KK: int):
    return ([2 * k for k in range(KK)] + [2 * k + 1 for k in range(KK)]
            + list(range(2 * KK, 3 * KK)))


def _dcn_offset_mask(KK: int) -> Converter:
    """Output channels (dy, dx) interleaved per tap -> thirds."""
    perm = _offset_mask_perm(KK)
    return lambda t: t[perm]


def _cls_conv(A: int, C: int) -> Converter:
    """Output channel c * A + a -> a * C + c."""
    perm = [c * A + a for a in range(A) for c in range(C)]
    return lambda t: t[perm]


# --------------------------------------------------------------------------
# name translation (the reference package's, with the port's converters)
# --------------------------------------------------------------------------

_HEAD_SEQ = {"Conv_0": "0", "BatchNorm_0": "1", "Conv_1": "3",
             "BatchNorm_1": "4", "Conv_2": "6"}
_HEAD_NAMES = {"cls_tower": "cls", "bbox_x": "bbox_x", "bbox_y": "bbox_y",
               "bbox_w": "bbox_w", "bbox_h": "bbox_h", "bbox_x3d": "bbox_x3d",
               "bbox_y3d": "bbox_y3d", "bbox_z3d": "bbox_z3d",
               "bbox_w3d": "bbox_w3d", "bbox_h3d": "bbox_h3d",
               "bbox_l3d": "bbox_l3d", "bbox_rY3d": "bbox_rY3d"}


def _bn_key(torch_prefix, leaf):
    return {
        "scale": f"{torch_prefix}.weight",
        "bias": f"{torch_prefix}.bias",
        "mean": f"{torch_prefix}.running_mean",
        "var": f"{torch_prefix}.running_var",
    }[leaf], _ident


def _conv(prefix, leaf):
    return (f"{prefix}.weight" if leaf == "kernel" else f"{prefix}.bias",
            _ident)


def _block_child(rest_parts, torch_prefix, leaf, block):
    """Block-internal paths of BasicBlock ('basic') or Bottleneck."""
    head, rest = rest_parts[0], rest_parts[1:]
    if block == "basic":
        conv_name, bn_name = {"ConvBNAct_0": ("conv1", "bn1"),
                              "ConvBNAct_1": ("conv2", "bn2")}[head]
        if rest[0] == "Conv_0":
            return _conv(f"{torch_prefix}.{conv_name}", leaf)
        return _bn_key(f"{torch_prefix}.{bn_name}", leaf)
    # bottleneck: ConvBNAct_0 -> conv1/bn1, Conv_0/BatchNorm_0 ->
    # conv2/bn2, ConvBNAct_1 -> conv3/bn3
    if head == "ConvBNAct_0":
        if rest[0] == "Conv_0":
            return _conv(f"{torch_prefix}.conv1", leaf)
        return _bn_key(f"{torch_prefix}.bn1", leaf)
    if head == "Conv_0":
        return _conv(f"{torch_prefix}.conv2", leaf)
    if head == "BatchNorm_0":
        return _bn_key(f"{torch_prefix}.bn2", leaf)
    if head == "ConvBNAct_1":
        if rest[0] == "Conv_0":
            return _conv(f"{torch_prefix}.conv3", leaf)
        return _bn_key(f"{torch_prefix}.bn3", leaf)
    raise KeyError(head)


def _leaf_to_torch(leaf):
    # flax convs name their kernel 'kernel'; the deformable and align
    # modules name their [K, K, Cin, Cout] weight 'weight'
    return {"kernel": "weight", "weight": "weight", "bias": "bias"}[leaf]


def flax_to_torch_key(path_parts, leaf, *, num_anchors, num_classes,
                      block="basic", dcn_kk=9) -> Tuple[str, Converter]:
    """Translate one flax path (module names) and leaf name into (the
    original model's key, converter to the port's layout). Raises KeyError
    for a path that does not translate."""
    p = list(path_parts)
    A, C = num_anchors, num_classes

    # ------------------------------------------------ heads (Tower)
    if p[0] in _HEAD_NAMES:
        tname = _HEAD_NAMES[p[0]]
        idx = _HEAD_SEQ[p[1]]
        if p[1].startswith("Conv"):
            key = f"{tname}.{idx}.{_leaf_to_torch(leaf)}"
            if tname == "cls" and p[1] == "Conv_2":
                return key, _cls_conv(A, C)
            return key, _ident
        return _bn_key(f"{tname}.{idx}", leaf)

    # ------------------------------------------------ alignment / ANAB
    dcn_like = _dcn_w if leaf == "weight" else _ident
    if p[0] == "shape_align_mod":
        return f"shape_align.align.{_leaf_to_torch(leaf)}", dcn_like
    if p[0] in ("center_align2d", "center_align3d"):
        return f"{p[0]}.align.{_leaf_to_torch(leaf)}", dcn_like
    if p[0] == "anab":
        return f"bbox_z3d_gl.0.{p[1]}.weight", _ident
    if p[0] == "anab_bn":
        return _bn_key("bbox_z3d_gl.1", leaf)

    # ------------------------------------------------ backbone / necks
    if p[0] != "base":
        raise KeyError("/".join(path_parts))
    p = p[1:]
    if p[0] == "base":   # DLA trunk
        p = p[1:]
        if p[0] == "base_conv":
            return "base.base.base_layer.0.weight", _ident
        if p[0] == "base_bn":
            return _bn_key("base.base.base_layer.1", leaf)
        m = re.match(r"ConvBNAct_(\d+)", p[0])
        if m:
            # level0 / level1 conv stacks: one conv per level in dla34/102
            lvl = 0 if int(m.group(1)) == 0 else 1
            base = f"base.base.level{lvl}"
            if p[1] == "Conv_0":
                return f"{base}.0.weight", _ident
            return _bn_key(f"{base}.1", leaf)
        m = re.match(r"Tree_(\d+)", p[0])
        if m:
            prefix = f"base.base.level{int(m.group(1)) + 2}"
            rest = p[1:]
            while rest and rest[0] in ("tree1", "tree2"):
                prefix += f".{rest[0]}"
                rest = rest[1:]
            if rest[0] == "root":
                if rest[1] == "Conv_0":
                    return f"{prefix}.root.conv.weight", _ident
                return _bn_key(f"{prefix}.root.bn", leaf)
            if rest[0] == "project":
                if rest[1] == "Conv_0":
                    return f"{prefix}.project.0.weight", _ident
                return _bn_key(f"{prefix}.project.1", leaf)
            return _block_child(rest, prefix, leaf, block)

    if p[0] in ("dla_up", "ida_up"):
        if p[0] == "dla_up":
            m = re.match(r"idas_(\d+)", p[1])
            tprefix = f"base.dla_up.ida_{m.group(1)}"
            rest = p[2:]
        else:
            tprefix = "base.ida_up"
            rest = p[1:]
        m = re.match(r"(projs|nodes|ups)_(\d+)", rest[0])
        kind, j = m.group(1), int(m.group(2)) + 1
        if kind == "ups":
            return f"{tprefix}.up_{j}.weight", _ident
        tname = {"projs": "proj", "nodes": "node"}[kind]
        mod = f"{tprefix}.{tname}_{j}"
        sub = rest[1:]
        if sub[0] == "DCN_0":
            if len(sub) > 1 and sub[1] == "conv_offset_mask":
                return (f"{mod}.conv.conv_offset_mask.{_leaf_to_torch(leaf)}",
                        _dcn_offset_mask(dcn_kk))
            return f"{mod}.conv.{_leaf_to_torch(leaf)}", dcn_like
        if sub[0] == "BatchNorm_0":
            return _bn_key(f"{mod}.actf.0", leaf)
        # plain-conv variant (ida_dcnv2=False)
        return f"{mod}.{_leaf_to_torch(leaf)}", _ident

    raise KeyError("/".join(path_parts) + ":" + leaf)


# --------------------------------------------------------------------------
# state-dict application
# --------------------------------------------------------------------------

_STATS = {"running_mean": "mean", "running_var": "var"}


def flax_path(modules: Dict[str, nn.Module], key: str
              ) -> Tuple[Tuple[str, ...], str]:
    """(flax module path, flax leaf) of one entry of the port's state dict:
    the inverse of `weights.from_flax_variables`' naming."""
    mod_name, _, name = key.rpartition(".")
    parts = tuple(mod_name.split(".")) if mod_name else ()
    mod = modules[mod_name]
    if isinstance(mod, nn.BatchNorm2d):
        leaf = _STATS.get(name) or {"weight": "scale", "bias": "bias"}[name]
    elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)) \
            and name == "weight":
        leaf = "kernel"
    else:
        leaf = name
    return parts, leaf


def load_reference_checkpoint(model: nn.Module, state_dict: Dict[str, Any],
                              num_anchors: int, num_classes: int,
                              block: str = "basic", strip_module=True):
    """Map an original-model state dict onto `model`'s state dict.

    `block`: 'basic' for the dla34 family, 'bottleneck' for dla60/102.
    Returns (the port's state dict, stats) with stats "loaded" (count),
    "unmapped" (flax paths with no translation), "missing" (translated
    keys absent from `state_dict`) and "shape_mismatch", as the reference
    package's import reports them; every entry not loaded keeps the
    model's value, in the model's dtype and device.
    """
    sd = {}
    for k, v in state_dict.items():
        if strip_module and k.startswith("module."):
            k = k[len("module."):]
        sd[k] = v
    stats = {"loaded": 0, "unmapped": [], "missing": [],
             "shape_mismatch": []}
    modules = dict(model.named_modules())
    out = {}
    for key, val in model.state_dict().items():
        out[key] = val
        if key.endswith("num_batches_tracked"):
            continue
        parts, leaf = flax_path(modules, key)
        try:
            ref_key, conv = flax_to_torch_key(
                parts, leaf, num_anchors=num_anchors,
                num_classes=num_classes, block=block)
        except (KeyError, AttributeError, IndexError, TypeError):
            stats["unmapped"].append("/".join(parts + (leaf,)))
            continue
        if ref_key not in sd:
            stats["missing"].append(ref_key)
            continue
        src = sd[ref_key]
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src))
        new = conv(src)
        if tuple(new.shape) != tuple(val.shape):
            stats["shape_mismatch"].append(
                f"{ref_key}: {tuple(new.shape)} vs {tuple(val.shape)}")
            continue
        out[key] = new.to(dtype=val.dtype, device=val.device).contiguous()
        stats["loaded"] += 1
    logging.info("torch import: %d loaded, %d unmapped, %d missing, "
                 "%d shape mismatches", stats["loaded"],
                 len(stats["unmapped"]), len(stats["missing"]),
                 len(stats["shape_mismatch"]))
    return out, stats


def has_learned_dcn_offsets(state_dict: Dict[str, Any]) -> bool:
    """True if the checkpoint carries learned DCN offset predictors
    (`conv_offset_mask`)."""
    return any("conv_offset_mask" in k for k in state_dict)


def pin_parity_conf(conf, state_dict: Dict[str, Any]):
    """conf with `dcn_shift_clamp=None` when the checkpoint has learned
    neck offsets.

    The shift DCN (`ops/dcn.py:dcn_v2_shift`, on the card the hand-written
    kernel) is exact only for |offset| <= clamp. The original model's neck
    offsets are unbounded, so a checkpoint with `conv_offset_mask` weights
    must run its 8 neck layers on the unbounded gather `ops/dcn.py:dcn_v2`,
    or its forward diverges from the original. Trunk-only checkpoints
    (ImageNet DLA) keep the shift DCN.
    """
    if getattr(conf, "dcn_shift_clamp", None) is not None \
            and has_learned_dcn_offsets(state_dict):
        logging.info(
            "torch import: checkpoint has learned DCN offsets -> pinning "
            "dcn_shift_clamp=None (the unbounded gather DCN)")
        return conf.replace(dcn_shift_clamp=None)
    return conf


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a .pth/.pkl checkpoint of the original model, on
    the CPU (unwrapping a {"state_dict": ...} checkpoint)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v)) for k, v in obj.items()}
