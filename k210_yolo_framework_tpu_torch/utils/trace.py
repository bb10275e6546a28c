"""Named host ranges at the port's layer boundaries, for ``torch.profiler``.

``span("serve.net")`` is a ``torch.profiler.record_function`` range named
``k210.serve.net`` while a profiler records, and nothing otherwise: with no
profiler running it costs one flag check, with no dispatcher call, no
allocation and no device sync.  A range is a host event on the profiler's
clock, beside the device events it records, so a trace shows which stage
of the serving entry or the train step launched each kernel and what the
host was doing while the device sat idle.  ``keras_train --profile True``
(``training.train.fit(profile_dir=...)``) writes them into its Chrome
trace.  ``torch.export`` leaves the ranges out of the programs it traces
under a profiler (torch 2.11 and 2.13): they hold no profiler op.  A span
reads nothing from the device.

The names (``PREFIX`` + name): ``serve.*`` in ``inference.Predictor``,
``train.*`` in ``training.train``'s train step, ``preprocess.*`` in
``data.pipeline.make_preprocess_fn`` and ``fit.load`` (the wait for the
loader's batch) in ``training.train.fit``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["PREFIX", "span"]

PREFIX = "k210."

# shared: a nullcontext holds no state, so one serves every closed span
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the ``PREFIX + name`` range while a profiler is
    recording; a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
