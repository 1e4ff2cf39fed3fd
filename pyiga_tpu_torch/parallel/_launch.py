# -*- coding: utf-8 -*-
"""Rank processes for the multi-device layer: start `n` processes, join
them into one ``torch.distributed`` group and run functions in all of
them.

The processes start by ``multiprocessing``'s ``spawn`` method (CUDA does
not survive a fork) and meet through a file store in a temporary
directory, so no port is opened.  Rank r uses the card ``r %
device_count`` (or the CPU), the backend the caller named: ``'nccl'``
needs a card a rank, ``'gloo'`` runs on the CPU and lets ranks share a
card.  A function to run is named by reference (a module-level function
of an importable module) and gets the rank's device and the arguments;
what it returns must pickle.

    with RankPool(4, device='cpu') as pool:
        results = pool.run(fn, *args)      # one result a rank
"""

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch

_CTX = multiprocessing.get_context('spawn')


def resolve(n, device=None, backend=None):
    """The device type and backend of `n` ranks asked for on `device`
    (None: the card) with `backend` (None: ``'nccl'`` on cards,
    ``'gloo'`` on the CPU).  Raises where the ranks would not each get a
    card of their own under NCCL, or for NCCL on the CPU."""
    kind = 'cpu' if device is not None and \
        torch.device(device).type == 'cpu' else 'cuda'
    if backend is None:
        backend = 'nccl' if kind == 'cuda' else 'gloo'
    if backend not in ('nccl', 'gloo'):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    if kind == 'cpu' and backend == 'nccl':
        raise ValueError("NCCL needs cards: pass backend='gloo' for ranks "
                         "on the CPU")
    if kind == 'cuda' and backend == 'nccl':
        count = torch.cuda.device_count()
        if count < n:
            raise RuntimeError(
                '%d ranks over NCCL need %d cards, but %d are visible; '
                "pass backend='gloo' to let ranks share a card, or "
                "device='cpu'" % (n, n, count))
    return kind, backend


def _worker(rank, n, kind, backend, store_path, threads, timeout, inbox,
            outbox):
    """A rank process: join the group (its collectives time out after
    `timeout` seconds), then run what comes in `inbox` until None
    arrives."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if kind == 'cuda':
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device('cuda', torch.cuda.current_device())
        else:
            device = torch.device('cpu')
        import torch.distributed as dist
        store = dist.FileStore(store_path, n)
        opts = dict(store=store, rank=rank, world_size=n,
                    timeout=datetime.timedelta(seconds=timeout))
        try:
            dist.init_process_group(backend, **opts, **(
                dict(device_id=device) if backend == 'nccl' else {}))
        except TypeError:           # a torch without device_id
            dist.init_process_group(backend, **opts)
        outbox.put((rank, True, None))
    except Exception:
        outbox.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                outbox.put((rank, True, fn(device, *args, **kwargs)))
            except Exception:       # reported to the caller, who raises
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`n` rank processes joined into one process group (see the module's
    docstring); :meth:`run` runs a function in all of them, :meth:`close`
    (or leaving a ``with`` block) ends them.  `threads` sets each rank's
    torch CPU threads; `timeout` (seconds) bounds the wait for a result
    and each collective of the ranks."""

    def __init__(self, n, device=None, backend=None, threads=None,
                 timeout=600):
        self.n = n
        self.kind, self.backend = resolve(n, device, backend)
        self.timeout = timeout
        self._dir = tempfile.mkdtemp(prefix='pyiga_ranks_')
        store = os.path.join(self._dir, 'store')
        self._outbox = _CTX.Queue()
        self._inboxes = [_CTX.Queue() for _ in range(n)]
        self._procs = [_CTX.Process(
            target=_worker, args=(r, n, self.kind, self.backend, store,
                                  threads, timeout, self._inboxes[r],
                                  self._outbox),
            daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()
        try:
            self._collect('joining the process group')
        except Exception:
            self.close()
            raise

    def _collect(self, what):
        """One answer from every rank; raises on a failed rank, on a rank
        process that ended without answering (its exit code), and after
        `timeout` seconds without every answer."""
        results, errors, answered = [None] * self.n, [], set()
        deadline = time.monotonic() + self.timeout
        while len(answered) < self.n:
            try:
                rank, ok, value = self._outbox.get(timeout=1.0)
            except queue.Empty:
                gone = {r: p.exitcode for r, p in enumerate(self._procs)
                        if r not in answered and not p.is_alive()}
                if gone or time.monotonic() > deadline:
                    raise RuntimeError(
                        '%s: no answer from ranks %s (exit codes of those '
                        'that ended: %s)' % (what, sorted(
                            set(range(self.n)) - answered), gone))
                continue
            answered.add(rank)
            if ok:
                results[rank] = value
            else:
                errors.append('rank %d:\n%s' % (rank, value))
        if errors:
            raise RuntimeError('%s failed on %d of %d ranks:\n%s'
                               % (what, len(errors), self.n,
                                  '\n'.join(errors)))
        return results

    def run(self, fn, *args, **kwargs):
        """``fn(device, *args, **kwargs)`` in every rank; returns the
        results in rank order, or raises with every failed rank's
        traceback."""
        for box in self._inboxes:
            box.put((fn, args, kwargs))
        return self._collect(getattr(fn, '__name__', str(fn)))

    def close(self):
        for box, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                box.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run(fn, n, *args, device=None, backend=None, threads=None, **kwargs):
    """Start `n` ranks, run ``fn(device, *args, **kwargs)`` in each, end
    them; returns the results in rank order and raises if any rank
    failed."""
    with RankPool(n, device, backend, threads) as pool:
        return pool.run(fn, *args, **kwargs)
