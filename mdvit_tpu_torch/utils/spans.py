"""Named host spans on the profiler's timeline, where the port's work happens.

``with span("mdvit.data"): ...`` is ``torch.profiler.record_function`` while
a ``torch.profiler`` (or ``torch.autograd.profiler``) session records, so the
span lands on the clock that Kineto aligns the device's ops to: a profile
shows which span each launch, and each idle gap of the device, fell in.
With no profiler recording it is one shared no-op context, after one read of
the profiler's own flag: no dispatcher call, no allocation. Nothing turns
spans on but a profiler: the trainer's ``tpu.profile_steps`` trace and the
benchmark's traced windows carry them as they are.

The spans, each entered where its work is issued:

- ``mdvit.train_step``: one step of ``train.steps.make_train_step`` or of
  ``parallel.context.make_context_parallel_train_step``; the four train
  spans below nest in it (the context-parallel step has no ``mdvit.data``:
  its caller passes the batch);
- ``mdvit.data``: ``gather_batch`` and the augmentation (or the eval
  transform);
- ``mdvit.forward``: the model call (the checkpoint wrapper under
  ``remat``);
- ``mdvit.backward``: one ``torch.autograd.grad`` pull; the autograd engine
  may issue its device ops from a thread of its own;
- ``mdvit.optimizer``: the gradients set (and all-reduced), then
  ``optimizer.step()`` and ``scheduler.step()``;
- ``mdvit.dropout`` (``ops.layers``): a dropout, DropPath or Dropout2d that
  draws a mask: its hashing, compare and apply;
- ``mdvit.serve``: one call of ``predict.make_forward``'s forward;
- ``mdvit.cp.halo``, ``mdvit.cp.gather``, ``mdvit.cp.reduce``
  (``parallel.mesh``, ``ops.factorized_attention.gather_partials``): one
  collective of context or data parallelism each, with the copies that
  feed and unpack it: a halo exchange; a gather of rows, of A's or A′'s workspace, or a
  broadcast; an all-reduce (the BatchNorms' moments, the losses' and
  spatial means' sums, the context-parallel step's gradients), forward
  and backward.
"""
from __future__ import annotations

import torch.autograd.profiler as _profiler
from torch.profiler import record_function


class _Off:
    """The no-op context every span is while no profiler records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """A context that records ``name`` as a range on the profiler's
    timeline while a profiler records, and does nothing otherwise."""
    return record_function(name) if _profiler._is_profiler_enabled else _OFF
