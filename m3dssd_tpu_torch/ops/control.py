"""Data-dependent control flow in one form for eager runs and for
`torch.export`.

Eager, a branch on a device flag reads the flag back (one sync) and runs
one side, and a loop that runs to a fixpoint stops when nothing changed
(one sync a step). Each read-back is counted and spanned under its call
site's name (`utils/profiling.py:read_back`), and so is the dense side of a
branch whose sparse budget overflowed (`profiling.fallback`).
Under `torch.export` both become graph operators with the same results:
`torch.cond` keeps both branches, whose outputs must match in shape and
dtype, and `while_loop` carries the loop state. Run eagerly, the graph
operators give the same answers but cost eager detect more (PERF.md §6,
`profile_detect.py --graph_forms`).
"""

from __future__ import annotations

import torch

from ..utils.profiling import fallback, read_back


def tracing() -> bool:
    """True while torch.export traces."""
    return torch.compiler.is_exporting()


def cond(pred, true_fn, false_fn, operands=(), *, site: str):
    """`true_fn(*operands)` when pred holds, else `false_fn(*operands)`,
    the dense fallback of call site `site`.
    pred: a Python bool, or a one-element bool tensor."""
    if isinstance(pred, torch.Tensor):
        if tracing():
            return torch.cond(pred, true_fn, false_fn, tuple(operands))
        pred = read_back(site, pred)
    if pred:
        return true_fn(*operands)
    with fallback(site):
        return false_fn(*operands)


def fixpoint(step, state: torch.Tensor, max_iter: int, *,
             site: str) -> torch.Tensor:
    """Iterate `state <- step(state)` until it stops changing, at most
    `max_iter` times. Once step(s) == s every further step gives s, so
    running past the fixpoint would change nothing. Eager, each step's
    test is a read-back at `site`."""
    if tracing():
        from torch._higher_order_ops.while_loop import while_loop

        def go(it, cur, prev):
            return (it < max_iter) & torch.any(cur != prev)

        def body(it, cur, prev):
            return it + 1, step(cur), cur.clone()

        # the first step is taken before the loop, as the eager form's
        it0 = torch.ones((), dtype=torch.int64, device=state.device)
        _, out, _ = while_loop(go, body, (it0, step(state), state))
        return out
    for _ in range(max_iter):
        new = step(state)
        if read_back(site, (new == state).all()):
            break
        state = new
    return state
