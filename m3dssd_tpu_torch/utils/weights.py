"""Weight bridge from the reference package's parameter trees.

`from_flax_variables({"params": ..., "batch_stats": ...})` takes the trees
as nested dicts of arrays (numpy, or anything `np.asarray` reads) and
returns a state dict that the port's model loads with `strict=True`, so that
both packages compute the same function. The port's module names follow the
reference's, so the walk is mechanical; only the layouts change:

  * conv kernels HWIO [kh, kw, I, O] -> OIHW [O, I, kh, kw] (grouped
    convs too: LocalConv2d's [3, 3, C, r*F] kernel, band i in outputs
    i*F .. (i+1)*F - 1, needs no reordering);
  * BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
    running_mean/running_var (num_batches_tracked 0; a GroupNorm's
    scale/bias, with no statistics, -> weight/bias);
  * deformable and align weights [K, K, Cin, Cout] stay as they are (the
    layout the shift-DCN kernel takes), as do DeformLocConv's per-band
    weight [r, K*K*Cin, Cout] and bias [r, Cout];
  * upsampling kernels [2f, 2f, 1, C] (a correlation over the lhs-dilated
    input) -> ConvTranspose2d weight [C, 1, 2f, 2f], spatially flipped,
    since a transposed convolution applies the flipped kernel.

`sgd_state_from_optax` carries an optax SGD momentum trace across the same
way, as the port optimizer's `momentum_buffer`s.
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


def _param_entries(params) -> Iterator[Tuple[str, torch.Tensor]]:
    """(port parameter name, tensor) for every leaf of a params-shaped
    tree (the parameters themselves, or an optimizer buffer per
    parameter)."""
    for path, leaf in _leaves(params):
        name = path[-1]
        a = np.asarray(leaf, np.float32)
        if name == "kernel":
            if len(path) > 1 and path[-2].startswith("ups_"):
                a = a[::-1, ::-1]
            yield _key(path, "weight"), _tensor(a.transpose(3, 2, 0, 1))
        elif name == "scale":
            yield _key(path, "weight"), _tensor(a)
        elif name in ("bias", "weight"):
            yield _key(path, name), _tensor(a)
        else:
            raise KeyError(f"unknown parameter {'/'.join(path)}")


def from_flax_variables(variables) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} trees -> the port's state dict."""
    out: Dict[str, torch.Tensor] = dict(_param_entries(variables["params"]))
    stats = variables.get("batch_stats", {})
    # a BatchNorm's scale, not a GroupNorm's (which keeps no statistics)
    with_stats = {path[:-1] for path, _ in _leaves(stats)}
    for path, _ in _leaves(variables["params"]):
        if path[-1] == "scale" and path[:-1] in with_stats:
            out[_key(path, "num_batches_tracked")] = torch.tensor(0)
    for path, leaf in _leaves(stats):
        if path[-1] not in _STATS:
            raise KeyError(f"unknown statistic {'/'.join(path)}")
        out[_key(path, _STATS[path[-1]])] = _tensor(leaf)
    return out


def sgd_state_from_optax(trace, count: int) -> dict:
    """An optax SGD momentum `trace` (a params-shaped tree) and its update
    count -> the state dict of the port's `train.state.Optimizer` ("sgd"),
    each trace leaf becoming that parameter's `momentum_buffer`, so a run
    can continue in the port from a mid-training reference state."""
    return {"solver": "sgd", "count": int(count), "mini_step": 0, "acc": {},
            "state": {name: {"momentum_buffer": t}
                      for name, t in _param_entries(trace)}}
