# -*- coding: utf-8 -*-
"""Every collective of the multi-device layer, over ``torch.distributed``.

A mesh axis of a rank is a :class:`Comm`: its process group, the rank's
place in it and the rank's device.  The layer is explicit SPMD: each rank
holds its shard as a plain tensor on its own device, and the three kinds
of traffic it needs are written out here and nowhere else:

* :meth:`Comm.halo` — the ``'space'`` halo exchange: each rank owns a
  contiguous slab of the first axis (:func:`slab`; uneven and empty slabs
  allowed) and receives the planes around it that its rows reach from
  whichever ranks own them (the two neighbours, unless a slab is thinner
  than the halo);
* :meth:`Comm.sum` — the ``all_reduce`` of Krylov dot products and of
  other partial sums;
* :meth:`Comm.gather` — the ``all_gather`` of results along an axis of
  slabs of unequal length.

The backend is the caller's: ``'nccl'`` on cards, one card a rank, or
``'gloo'`` on the CPU and for ranks that share a card.  Gloo's send of a
CUDA tensor aborts the process on the H100 machine (gloo's TCP pair
writes from the device pointer: ``writev ... Bad address``), so with gloo
every collective of a CUDA tensor goes through a host copy of the halo,
the scalar or the slab (:attr:`Comm.host`); NCCL takes them in place.

:data:`STATS` counts the bytes each kind moves and, while
:func:`profile` is on, the seconds spent in collectives (each one then
synchronizes the device before and after it).
"""

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

# kind -> [calls, bytes a rank sends]; 'seconds': time in collectives
# while profiling is on
STATS = {'halo': [0, 0], 'sum': [0, 0], 'gather': [0, 0], 'seconds': 0.0}
_profile = [False]


def reset_stats():
    for k in STATS:
        STATS[k] = 0.0 if k == 'seconds' else [0, 0]


@contextlib.contextmanager
def profile(device):
    """Time every collective inside the block (into ``STATS['seconds']``),
    synchronizing `device` before and after each one."""
    _profile[:] = [device]
    try:
        yield
    finally:
        _profile[:] = [False]


@contextlib.contextmanager
def _timed(kind, nbytes):
    STATS[kind][0] += 1
    STATS[kind][1] += int(nbytes)
    dev = _profile[0]
    if dev is False:
        yield
        return
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    yield
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    STATS['seconds'] += time.perf_counter() - t0


def slab(n, size, index):
    """The rows ``[lo, hi)`` of `n` that rank `index` of `size` owns:
    contiguous, in rank order, their lengths differing by at most one
    (some empty when ``n < size``)."""
    return n * index // size, n * (index + 1) // size


class Comm:
    """One mesh axis as seen from this rank: ``group``, ``size``,
    ``index`` (this rank's place in the group), ``ranks`` (the global
    ranks in group order) and ``device`` (where this rank's tensors
    live).  A `group` of None is an axis of this rank alone."""

    def __init__(self, group, device):
        self.group = group
        self.device = torch.device(device)
        if group is None:
            self.size, self.index, self.host = 1, 0, False
            return
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.ranks = dist.get_process_group_ranks(group)
        backend = dist.get_backend(group)
        self.host = self.device.type == 'cuda' and backend == 'gloo'
        if backend == 'nccl' and self.size > 1:
            # NCCL sets up a communicator at a group's first collective,
            # which every rank must join: a halo exchange may not
            dist.all_reduce(torch.zeros(1, device=self.device), group=group)

    def slab(self, n):
        """This rank's rows of `n` (:func:`slab`)."""
        return slab(n, self.size, self.index)

    def slabs(self, n):
        """Every rank's rows of `n`, in group order."""
        return [slab(n, self.size, q) for q in range(self.size)]

    def _out(self, t):
        return t.cpu() if self.host else t

    def _back(self, t):
        return t.to(self.device) if self.host else t

    def sum(self, t):
        """The sum of `t` over the group (every rank gets it)."""
        if self.size == 1:
            return t
        h = self._out(t).clone()
        with _timed('sum', h.numel() * h.element_size()):
            dist.all_reduce(h, group=self.group)
        return self._back(h)

    def dot(self, u, v):
        """The dot product of two vectors split over the group."""
        return self.sum(torch.dot(u, v))

    def gather(self, t, counts, dim=0):
        """Concatenate every rank's `t` along `dim` in group order; rank
        q's has ``counts[q]`` entries there (unequal counts are padded to
        the largest for the ``all_gather`` and cut after it)."""
        if self.size == 1:
            return t
        t = t.movedim(dim, 0)
        m = max(counts)
        buf = self._out(t).new_zeros((m,) + tuple(t.shape[1:]))
        buf[:t.shape[0]] = self._out(t)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        with _timed('gather', buf.numel() * buf.element_size()):
            dist.all_gather(parts, buf, group=self.group)
        out = torch.cat([p[:c] for p, c in zip(parts, counts)])
        return self._back(out).movedim(0, dim)

    def halo(self, x, n, need, dim=0, out=None):
        """Rows ``need[index]`` of an axis of length `n` split into this
        group's slabs, `x` holding this rank's slab along `dim`.  Every
        rank names the rows it needs (``need[q] = (a, c)``, clipped to
        ``[0, n)``, covering the rank's own slab where that is not
        empty); each row comes from the rank that owns it by a send and a
        receive, own rows are copied.  Returns the ``c - a`` rows along
        `dim`, written into `out` (rows along dim 0) where it is given."""
        own = self.slabs(n)
        lo, hi = own[self.index]
        a, c = need[self.index]
        x = x.movedim(dim, 0)
        if out is None:
            out = x.new_zeros((c - a,) + tuple(x.shape[1:]))
        s0, s1 = max(a, lo), min(c, hi)
        if s0 < s1:
            out[s0 - a:s1 - a] = x[s0 - lo:s1 - lo]
        ops, recvs, nbytes = [], [], 0
        for q in range(self.size):
            if q == self.index:
                continue
            # what q sends me, what I send q
            r0, r1 = max(a, own[q][0]), min(c, own[q][1])
            if r0 < r1:
                buf = self._out(out[r0 - a:r1 - a]).new_empty(
                    (r1 - r0,) + tuple(x.shape[1:]))
                recvs.append((buf, r0))
                ops.append(dist.P2POp(dist.irecv, buf, self.ranks[q],
                                      self.group))
            t0, t1 = max(need[q][0], lo), min(need[q][1], hi)
            if t0 < t1:
                part = self._out(x[t0 - lo:t1 - lo]).contiguous()
                nbytes += part.numel() * part.element_size()
                ops.append(dist.P2POp(dist.isend, part, self.ranks[q],
                                      self.group))
        if ops:
            with _timed('halo', nbytes):
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        for buf, r0 in recvs:
            out[r0 - a:r0 - a + buf.shape[0]] = self._back(buf)
        return out.movedim(0, dim)


def halo_need(n, size, w):
    """The rows every rank of `size` needs for a halo of `w` planes on
    each side of its slab of `n` (clipped to the axis)."""
    return [(max(0, lo - w), min(n, hi + w))
            for lo, hi in (slab(n, size, q) for q in range(size))]


def offsets(counts):
    """Start of each rank's part in the concatenation of `counts`."""
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
