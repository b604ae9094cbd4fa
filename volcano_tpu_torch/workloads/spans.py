"""Profiler ranges inside the port's workloads, on the device trace's
clock.

Every range is a `torch.profiler.record_function`, so any
`torch.profiler` capture around training steps or served batches shows
them beside the kernels they launched (open the exported Chrome trace
in Perfetto or TensorBoard).  When no profiler runs, `span` costs one
flag check and `mark_in` makes nothing, so an untraced step is the same
as one built without them.

The names (`NAMES`):

- `vtp::forward`, `vtp::backward`: the loss's forward and
  `torch.autograd.grad` in `train.value_and_grad`.
- `vtp::adamw`: `AdamW.update`; its children `vtp::adamw.clip` (the
  global norm and the clip factor) and `vtp::adamw.leaves` (the
  per-leaf loop).
- `vtp::block`: each transformer block; the residual adds are its own
  time.  Forward only.
- `vtp::embed`, `vtp::norm`, `vtp::attn`, `vtp::rotary`,
  `vtp::attn.core`, `vtp::mlp`, `vtp::cast`, `vtp::head`, `vtp::loss`
  (`PARTS`): the model's parts (`model.py`).  Each block's two norms,
  attention and MLP lie inside its `vtp::block`; `vtp::rotary`,
  `vtp::attn.core` and the casts of q, k, v and o inside `vtp::attn`;
  the MLP's casts inside `vtp::mlp`; the final norm and the head's cast
  inside `vtp::head`.
- `<part>.bwd`: the part's backward, on the thread that runs it.  The
  autograd engine runs one device's nodes highest sequence number
  first, so the nodes the part's forward made run one after another:
  the range opens in a pre-hook of the first of them and closes in a
  post-hook of the last.  Hooks leave the graph and its sums as they
  are, so a traced step computes what an untraced one does.
- `vtp::serve.batch`: one served batch in `serve.BatchedServer`, from
  popping it off the queue to the forward's return.

This module imports torch only once a profiler runs, so the serving
replica's stdlib path stays free of it.
"""

from __future__ import annotations

import contextlib
import sys

PARTS = ("vtp::embed", "vtp::norm", "vtp::attn", "vtp::rotary",
         "vtp::attn.core", "vtp::mlp", "vtp::cast", "vtp::head", "vtp::loss")
NAMES = ("vtp::forward", "vtp::backward", "vtp::adamw", "vtp::adamw.clip",
         "vtp::adamw.leaves", "vtp::serve.batch", "vtp::block") + PARTS + \
    tuple(p + ".bwd" for p in PARTS)

_NULL = contextlib.nullcontext()
_ACCUMULATE = 2 ** 64 - 1      # an AccumulateGrad node's sequence number


def profiling() -> bool:
    """Whether a profiler records this thread (never without torch)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def span(name: str):
    """A profiler range called `name` while a profiler runs, else a
    shared null context."""
    if not profiling():
        return _NULL
    import torch
    return torch.profiler.record_function(name)


class _Backward:
    """One call's `.bwd` range: the sequence number its part's first
    node gets, and while the backward runs the part, the open range."""

    __slots__ = ("name", "floor", "open")

    def __init__(self, name: str, floor: int):
        self.name, self.floor, self.open = name + ".bwd", floor, None


def mark_in(x, name: str):
    """The `.bwd` range of part `name`, called on its input x before the
    part's forward; None unless a profiler runs with gradients recorded
    for x."""
    if not (profiling() and x.requires_grad and
            sys.modules["torch"].is_grad_enabled()):
        return None
    return _Backward(name, sys.modules["torch"]._C._autograd.
                     _get_sequence_nr())


def mark_out(out, bwd):
    """`out` (a tensor or a tuple) unchanged, as the output of the part
    whose input `mark_in` gave `bwd`: hooks the first and the last node
    its forward made to open and close the range."""
    if bwd is None:
        return out
    made = {}
    todo = [t.grad_fn for t in (out if isinstance(out, tuple) else (out,))
            if getattr(t, "grad_fn", None) is not None]
    while todo:
        node = todo.pop()
        seq = node._sequence_nr()
        if seq < bwd.floor or seq == _ACCUMULATE or seq in made:
            continue
        made[seq] = node
        todo.extend(n for n, _ in node.next_functions if n is not None)
    if made:
        first, last = made[max(made)], made[min(made)]
        first.register_prehook(lambda grads: _open(bwd, last))
        last.register_hook(lambda grads_in, grads_out: _close(bwd))
    return out


def _open(bwd: _Backward, last) -> None:
    import torch
    # opened only where the part's last node will run and close it
    if torch._C._will_engine_execute_node(last):
        bwd.open = torch.profiler.record_function(bwd.name)
        bwd.open.__enter__()


def _close(bwd: _Backward) -> None:
    if bwd.open is not None:
        bwd.open.__exit__(None, None, None)
        bwd.open = None
