"""Named host spans on the profiler's clock.

``span(name)`` opens a ``torch.profiler.record_function`` range named
``littlegan:<name>``. It lands in the same trace as the device's kernels
(Chrome trace ``cat`` "user_annotation"), so spans and device events share
one clock. Tracing is on exactly while a ``torch.profiler`` runs on the
calling thread (``ProfileWindow``, ``scaling_curve --trace``, a benchmark's
traced window); otherwise ``span`` returns a shared null context and enters
nothing.

The spans, outside every captured CUDA graph (a replay runs no Python):

- ``step.schedule``: the K updates' schedule rows and host inputs
  (``training/step.py``);
- ``dispatch.stage_wait``, ``dispatch.stage``, ``dispatch.inputs``,
  ``dispatch.replay``, ``dispatch.outputs``: one ``GraphedUpdates`` call
  (``training/dispatch.py``);
- ``trainer.fetch``, ``trainer.draws``, ``trainer.flush``,
  ``trainer.cadence``: the Trainer's epoch loops (``training/trainer.py``).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "littlegan:"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``littlegan:<name>`` profiler range while a profiler runs, else a no-op."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
