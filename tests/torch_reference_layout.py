"""The port's weights written back as a checkpoint of the original
PyTorch model: the inverse of `m3dssd_tpu_torch.utils.torch_import
.load_reference_checkpoint`. The upstream-import tests
(`test_torch_upstream.py`, `test_torch_run_dir.py`) and `chip_smoke.py`
make their reference-layout checkpoints with it."""

import torch

from m3dssd_tpu_torch.utils import torch_import as ti


def _invert(conv, val: torch.Tensor) -> torch.Tensor:
    """The original tensor that `conv` takes to `val`: the converters only
    move entries (a transpose or a channel permutation), so `conv` of the
    original's flat positions says where each entry of `val` came from."""
    shape = val.permute(3, 2, 0, 1).shape if conv is ti._dcn_w else val.shape
    pos = conv(torch.arange(val.numel(), device=val.device)
               .reshape(shape)).reshape(-1)
    out = torch.empty(val.numel(), dtype=val.dtype, device=val.device)
    return out.index_copy_(0, pos, val.reshape(-1)).reshape(shape)


def reference_state_dict(model: torch.nn.Module, num_anchors: int,
                         num_classes: int, block: str = "basic"):
    """The inverse of `ti.load_reference_checkpoint`: `model`'s weights as a
    state dict in the original model's names and layouts (every entry that
    translates)."""
    modules = dict(model.named_modules())
    out = {}
    for key, val in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        parts, leaf = ti.flax_path(modules, key)
        try:
            ref_key, conv = ti.flax_to_torch_key(
                parts, leaf, num_anchors=num_anchors,
                num_classes=num_classes, block=block)
        except (KeyError, AttributeError, IndexError, TypeError):
            continue
        out[ref_key] = _invert(conv, val.detach())
    return out
