# -*- coding: utf-8 -*-
"""Lightweight timing and profiling helpers (port of
:mod:`pyiga_tpu.profiling`).

* :func:`timed` / :class:`Timings` — wall-clock phase timers that
  synchronize the device before the clock stops: a CUDA launch returns
  before its kernel ends, so a result to sync on may be passed (every
  CUDA device holding a tensor of it is synchronized);
* :func:`trace` — a ``torch.profiler`` context recording CPU and, with a
  card present, CUDA activity (the hand-written kernels launched through
  :mod:`~pyiga_tpu_torch._cuda` included), and writing a TensorBoard-
  readable trace into a directory.  A profiler that fails raises: a run
  that asked for a trace never ends without one.
"""

import contextlib
import time

import numpy as np
import torch


class Timings:
    """Accumulates named phase timings; ``report()`` prints a table."""

    def __init__(self):
        self.records = {}

    def add(self, label, seconds):
        self.records.setdefault(label, []).append(seconds)

    @contextlib.contextmanager
    def __call__(self, label, sync=None):
        with _timed_box(sync) as box:
            yield box
        self.add(label, box['seconds'])

    def report(self, stream=None):
        import sys
        out = stream or sys.stdout
        for label, ts in self.records.items():
            ts = np.asarray(ts)
            out.write('%-32s %3d calls  best %8.2f ms  mean %8.2f ms\n'
                      % (label, len(ts), 1e3 * ts.min(), 1e3 * ts.mean()))


def _leaves(result):
    """The leaves of nested tuples, lists and dicts."""
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        for x in result:
            yield from _leaves(x)
    else:
        yield result


def _device_sync(result):
    """Wait until every CUDA device that holds a tensor among the leaves
    of `result` has finished its work (CPU tensors need no sync)."""
    devices = {x.device for x in _leaves(result)
               if isinstance(x, torch.Tensor) and x.device.type == 'cuda'}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return result


@contextlib.contextmanager
def _timed_box(sync):
    """Shared timing protocol of :func:`timed` and :class:`Timings`:
    device-synchronize on the block's result, record elapsed seconds."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        result = box.get('result', sync)
        if result is not None:
            _device_sync(result)
        box['seconds'] = time.perf_counter() - t0


@contextlib.contextmanager
def timed(label='elapsed', sync=None, verbose=True):
    """Time a block; pass ``sync=result`` (or set ``box['result']``) to
    synchronize on device values before stopping the clock.

    >>> with timed('assembly') as box:
    ...     box['result'] = asm.run_device()
    """
    with _timed_box(sync) as box:
        yield box
    if verbose:
        print('%s: %.2f ms' % (label, 1e3 * box['seconds']))


# one-element kernels launched at the start of a CUDA trace: on an H100
# the first 5-7 launches of a profiler session in a long-running process
# lost their kernel records while their launches were recorded (not so in
# a fresh process); launched first, these take their place
TRACE_WARMUP = 16


@contextlib.contextmanager
def trace(logdir):
    """``torch.profiler`` trace context: records CPU activity and, when a
    card is present, CUDA activity, and writes a TensorBoard-readable
    trace (``*.pt.trace.json``) into `logdir` when the block ends.
    Yields the profiler (``key_averages()``, ``events()``).  Raises if
    the profiler cannot start or stop.  With a card the trace starts with
    :data:`TRACE_WARMUP` one-element kernels on the current device and a
    synchronize (the range ``profiling.trace warm-up``), ahead of the
    block's own launches."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    warm = None
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        warm = torch.zeros(1, dtype=torch.float64, device='cuda')
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        if warm is not None:
            with record_function('profiling.trace warm-up'):
                for _ in range(TRACE_WARMUP):
                    warm.add_(1.0)
                torch.cuda.synchronize()
        yield prof
