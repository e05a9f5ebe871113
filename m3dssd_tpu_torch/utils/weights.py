"""Weight bridge from the reference package's parameter trees.

`from_flax_variables({"params": ..., "batch_stats": ...})` takes the trees
as nested dicts of arrays (numpy, or anything `np.asarray` reads) and
returns a state dict that the port's model loads with `strict=True`, so that
both packages compute the same function. The port's module names follow the
reference's, so the walk is mechanical; only the layouts change:

  * conv kernels HWIO [kh, kw, I, O] -> OIHW [O, I, kh, kw];
  * BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
    running_mean/running_var (num_batches_tracked 0);
  * deformable and align weights [K, K, Cin, Cout] stay as they are (the
    layout the shift-DCN kernel takes);
  * upsampling kernels [2f, 2f, 1, C] (a correlation over the lhs-dilated
    input) -> ConvTranspose2d weight [C, 1, 2f, 2f], spatially flipped,
    since a transposed convolution applies the flipped kernel.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key in sorted(tree):
        val = tree[key]
        if hasattr(val, "keys"):
            yield from _leaves(val, path + (str(key),))
        else:
            yield path + (str(key),), val


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _key(path: Tuple[str, ...], name: str) -> str:
    return ".".join(path[:-1] + (name,))


def from_flax_variables(variables) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} trees -> the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables["params"]):
        name = path[-1]
        a = np.asarray(leaf, np.float32)
        if name == "kernel":
            if len(path) > 1 and path[-2].startswith("ups_"):
                a = a[::-1, ::-1]
            out[_key(path, "weight")] = _tensor(a.transpose(3, 2, 0, 1))
        elif name == "scale":
            out[_key(path, "weight")] = _tensor(a)
            out[_key(path, "num_batches_tracked")] = torch.tensor(0)
        elif name in ("bias", "weight"):
            out[_key(path, name)] = _tensor(a)
        else:
            raise KeyError(f"unknown parameter {'/'.join(path)}")
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in _STATS:
            raise KeyError(f"unknown statistic {'/'.join(path)}")
        out[_key(path, _STATS[path[-1]])] = _tensor(leaf)
    return out
