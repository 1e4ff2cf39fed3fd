# -*- coding: utf-8 -*-
"""Regular banded layout and the flat banded matvec (port of
:mod:`pyiga_tpu.ops.banded`'s flat-offset path, with kernel K4).

For spline spaces with single interior knots the per-axis sparsity is a
clipped band of width ``2b+1``.  Padding the clipped boundary rows to the
full band gives the regular layout ``D[mu_1..mu_d, i_1..i_d]`` with
``j_k = i_k + mu_k - b_k``.  Flattening the dof grid turns every band
combo ``mu`` into ONE flat shift

    off(mu) = sum_k (mu_k - b_k) * stride_k,    y[i] = sum_mu D[mu, i] x[i + off(mu)]

because D is zero exactly where the band leaves the matrix, which masks
every read that wraps across an axis boundary.  The port stores D as
``(C, F)`` (combo-major, no lane padding) and x zero-padded by ``lead``
on both sides.

The regular layout ``(b..., n...)`` reshapes to that flat layout with no
copy of its own, so :class:`BandedOperator` (the JAX package's
regular-layout operator) runs the same K4 matvec.
"""

import numpy as np
import torch

from .. import _cuda
from ..config import resolve_device


def band_info(structure):
    """If every level of the MLStructure is a clipped band over a square
    block, return the per-level bandwidths; else None."""
    bws = []
    for (m, n), bidx in zip(structure.bs, structure.bidx):
        if m != n:
            return None
        i = bidx[:, 0].astype(np.int64)
        j = bidx[:, 1].astype(np.int64)
        bw = int(np.max(np.abs(i - j))) if len(i) else 0
        lo = np.maximum(0, np.arange(n) - bw)
        hi = np.minimum(n, np.arange(n) + bw + 1)
        if len(i) != int(np.sum(hi - lo)):
            return None
        bws.append(bw)
    return bws


def compact_to_banded_indices(structure, bws):
    """Indices mapping the flat compact data tensor into the padded banded
    tensor: returns per-level arrays ``(mu_k, i_k)`` for each nonzero."""
    out = []
    for bw, bidx in zip(bws, structure.bidx):
        i = bidx[:, 0].astype(np.int64)
        j = bidx[:, 1].astype(np.int64)
        out.append((j - i + bw, i))
    return out


def banded_from_compact(data, structure, bws):
    """Scatter the compact data tensor into the regular banded layout
    ``(b_1, ..., b_d, n_1, ..., n_d)`` (zeros on the padding).  Host numpy:
    the mapping is separable per level, one ``np.ix_`` assignment."""
    d = len(bws)
    ns = [b[0] for b in structure.bs]
    bsz = [2 * bw + 1 for bw in bws]
    idx = compact_to_banded_indices(structure, bws)
    flat = [mu * n + i for (mu, i), n in zip(idx, ns)]
    # interleaved layout (b1, n1, b2, n2, ...), flattened per level
    D = np.zeros([b * n for b, n in zip(bsz, ns)],
                 dtype=np.asarray(data).dtype)
    D[np.ix_(*flat)] = np.asarray(data)
    D = D.reshape([x for b, n in zip(bsz, ns) for x in (b, n)])
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    return np.ascontiguousarray(np.transpose(D, perm))


def banded_gather_maps(structure, bws):
    """Per-level lookup tables mapping banded flat row ``mu*n + i`` to the
    compact data index (or -1 on the clipped-band padding).  Host setup
    for :func:`banded_from_compact_device`."""
    maps = []
    for (m, n), bidx, bw in zip(structure.bs, structure.bidx, bws):
        lookup = -np.ones((2 * bw + 1) * n, dtype=np.int64)
        i = bidx[:, 0].astype(np.int64)
        mu = bidx[:, 1].astype(np.int64) - i + bw
        lookup[mu * n + i] = np.arange(len(bidx))
        maps.append(lookup)
    return maps


def banded_from_compact_device(data, maps, bsz, ns):
    """Compact -> banded ``(b..., n...)`` on the data's device: one
    separable gather per level with the padding zeroed, then the reorder
    (:func:`~pyiga_tpu_torch.ops.sumfac.banded_reorder`, a view); the
    data never leaves the device."""
    from .sumfac import banded_reorder
    X = data
    for k, lk in enumerate(maps):
        lk = torch.as_tensor(lk, dtype=torch.int64, device=data.device)
        mask_shape = [1] * data.dim()
        mask_shape[k] = -1
        X = (torch.index_select(X, k, torch.clamp(lk, min=0))
             * (lk >= 0).reshape(mask_shape).to(data.dtype))
    return banded_reorder(X, bsz, ns)


def flat_banded_layout(bws, ns):
    """Static layout of the flat banded matvec: band sizes ``bsz``, combo
    count ``C``, flat length ``F``, per-combo shifts ``offs`` (int64, combo
    order = ``np.ndindex(*bsz)``) and the zero padding ``lead`` of x."""
    d = len(ns)
    bsz = tuple(2 * b + 1 for b in bws)
    strides = [int(np.prod(ns[k + 1:])) for k in range(d)]
    offs = np.asarray([sum((m - b) * s for m, b, s in zip(mu, bws, strides))
                       for mu in np.ndindex(*bsz)], np.int64)
    return {'bsz': bsz, 'C': len(offs), 'F': int(np.prod(ns)),
            'offs': offs, 'lead': int(-offs.min())}


def flat_banded_data(D, bws, ns):
    """Banded data ``(b..., n...)`` (numpy or tensor) as the flat ``(C, F)``
    layout (a reshape: the port's flat layout has no lane padding)."""
    return flat_banded_embed_device(torch.as_tensor(D), bws, ns)


def flat_banded_embed_device(D_banded, bws, ns, lay=None):
    """The regular ``(b..., n...)`` (or ``(C,) + ns``) layout as the flat
    ``(C, F)`` one: a reshape (a copy only where `D_banded` is a
    non-contiguous view, as :func:`banded_from_compact_device`'s)."""
    if lay is None:
        lay = flat_banded_layout(tuple(bws), tuple(ns))
    return D_banded.reshape(lay['C'], lay['F'])


def flat_banded_from_padded_chain(Z, bws, ns, add_transpose=True):
    """The flat ``(C, F)`` layout directly from the chain output
    ``Z (b_1 n_1, ..., b_d n_d)`` (axis-k position ``mu_k * n_k + i_k``),
    fusing the symmetric mirror/combine, the banded reorder and the flat
    embed: for every band combo ``mu`` the direct part is the box
    ``Z[mu, i]``, and with `add_transpose` the transpose part is the
    shifted box ``Z[2b - mu, j = i + mu - b]`` (see
    :func:`~pyiga_tpu_torch.ops.cuda_sumfac.assemble_flat_banded` for the
    0.5 prescale this needs)."""
    lay = flat_banded_layout(bws, ns)
    out = torch.empty((lay['C'], lay['F']), dtype=Z.dtype, device=Z.device)
    for c, mu in enumerate(np.ndindex(*lay['bsz'])):
        oc = out[c].view(tuple(ns))
        oc.copy_(Z[tuple(slice(m * n, m * n + n) for m, n in zip(mu, ns))])
        if add_transpose:
            src, dst = [], []
            for m, b, n in zip(mu, bws, ns):
                s = m - b
                start = (2 * b - m) * n + max(0, s)
                ln = n - abs(s)
                lo = max(0, -s)
                src.append(slice(start, start + ln))
                dst.append(slice(lo, lo + ln))
            oc[tuple(dst)] += Z[tuple(src)]
    return out


def flat_banded_to_csr(D, bws, ns):
    """Host helper: the flat ``(C, F)`` data as a scipy CSR matrix (drops
    the zero padding of the band)."""
    import scipy.sparse
    lay = flat_banded_layout(bws, ns)
    D = np.asarray(torch.as_tensor(D).cpu(), dtype=np.float64)
    rows = np.broadcast_to(np.arange(lay['F']), D.shape)
    cols = rows + lay['offs'][:, None]
    nz = D != 0
    return scipy.sparse.csr_matrix((D[nz], (rows[nz], cols[nz])),
                                   shape=(lay['F'], lay['F']))


def flat_banded_matvec_plain(D, xp, offs, lead):
    """Plain PyTorch version of :func:`flat_banded_matvec`: shifted-slice
    accumulation in combo order."""
    F = D.shape[1]
    y = torch.zeros(F, dtype=D.dtype, device=D.device)
    for c, off in enumerate(offs.tolist()):
        s = lead + off
        y += D[c] * xp[s:s + F]
    return y


def flat_banded_matvec(D, xp, offs, lead):
    """K4: ``y[i] = sum_c D[c, i] * xp[lead + i + offs[c]]``.

    `D` ``(C, F)`` float64 or float32, `xp` ``(F + 2 lead,)`` of the same
    dtype (x with `lead` zeros on both sides), `offs` ``(C,)`` int64 on
    the same device.  A CPU tensor runs the plain version, a CUDA tensor
    launches the kernel."""
    if D.device.type == 'cpu':
        return flat_banded_matvec_plain(D, xp, offs, lead)
    if not D.is_cuda:
        raise ValueError('flat_banded_matvec: unsupported device %s'
                         % D.device)
    if D.dtype == torch.float64:
        name, fn = 'flat_banded_f64', 'pyiga_flat_banded_f64'
    elif D.dtype == torch.float32:
        name, fn = 'flat_banded_f32', 'pyiga_flat_banded_f32'
    else:
        raise ValueError('flat_banded_matvec: D must be float64 or float32')
    _cuda.no_grad_operands(name, D, xp)
    _cuda.require(D, 'D', D.dtype, 2)
    _cuda.require(xp, 'xp', D.dtype, 1)
    _cuda.require(offs, 'offs', torch.int64, 1)
    C, F = D.shape
    if offs.shape != (C,) or xp.shape != (F + 2 * lead,):
        raise ValueError('flat_banded_matvec: D %s, xp %s, offs %s, lead %d '
                         'disagree' % (tuple(D.shape), tuple(xp.shape),
                                       tuple(offs.shape), lead))
    y = torch.empty(F, dtype=D.dtype, device=D.device)
    with _cuda.device_of(D):
        err = getattr(_cuda.library(), fn)(
            D.data_ptr(), xp.data_ptr(), offs.data_ptr(), y.data_ptr(),
            C, F, lead, _cuda.stream_of(D))
    _cuda.check(err, name)
    _cuda.LAUNCHES[name] += 1
    return y


class FlatBandedOperator:
    """Banded operator on the flat ``(C, F)`` layout with the K4 matvec;
    its dtype is that of `D` (float64 for residuals, float32 for the
    Krylov loop of :func:`~pyiga_tpu_torch.solvers.cg_ir`).  Callable on
    raveled vectors of the full dof grid.  `interpret` is accepted for the
    reference's signature and ignored: it picks Pallas's interpret mode
    on the TPU, and the port's CPU tensors always run the plain version."""

    def __init__(self, D, bws, ns, interpret=None):
        self.bws, self.ns = tuple(bws), tuple(ns)
        self.lay = flat_banded_layout(self.bws, self.ns)
        if D.shape != (self.lay['C'], self.lay['F']):
            raise ValueError('D must be (C, F) = (%d, %d), got %s'
                             % (self.lay['C'], self.lay['F'], tuple(D.shape)))
        self.D = D.contiguous()
        self.dtype, self.device = D.dtype, D.device
        self.shape = (self.lay['F'], self.lay['F'])
        self._offs = torch.as_tensor(self.lay['offs'], device=D.device)

    def to(self, dtype):
        """The same operator with its data cast to `dtype`."""
        return FlatBandedOperator(self.D.to(dtype), self.bws, self.ns)

    def set_data_banded_device(self, D_banded):
        """Replace the data by a regular-layout ``(b..., n...)`` tensor
        (:func:`flat_banded_embed_device`), cast to the operator's dtype
        and device."""
        D = flat_banded_embed_device(D_banded, self.bws, self.ns, self.lay)
        self.D = D.to(dtype=self.dtype, device=self.device).contiguous()

    def matvec(self, x):
        lead, F = self.lay['lead'], self.lay['F']
        xp = torch.zeros(F + 2 * lead, dtype=self.dtype, device=self.device)
        xp[lead:lead + F] = x
        return flat_banded_matvec(self.D, xp, self._offs, lead)

    __call__ = matvec


class BandedOperator:
    """Banded operator on the regular layout ``D (b_1..b_d, n_1..n_d)``
    (``j_k = i_k + mu_k - b_k``, zeros on the padding), as the JAX
    package's: its matvec is K4 on ``D.reshape(C, F)``
    (:class:`FlatBandedOperator`).  A tensor `D` stays on its device; a
    numpy one goes to `device` (default: the card).  Callable on raveled
    vectors of the full dof grid.  Carries the operand protocol of
    :func:`~pyiga_tpu_torch.solvers.cg_jit` (``operands = {'D': D}`` and
    ``apply_with_operands(operands, x)``) as the JAX package's does."""

    def __init__(self, D, bws, ns, device=None):
        if not isinstance(D, torch.Tensor):
            D = torch.as_tensor(np.asarray(D), device=resolve_device(device))
        self.bws, self.ns = tuple(bws), tuple(ns)
        self.D = D
        self.dtype, self.device = D.dtype, D.device
        self.shape = (int(np.prod(ns)), int(np.prod(ns)))
        self.flat = FlatBandedOperator(
            flat_banded_embed_device(D, self.bws, self.ns), self.bws,
            self.ns)
        self.operands = {'D': D}

    def apply_with_operands(self, operands, x):
        """The matvec with the regular-layout data ``operands['D']`` (this
        operator's own data reuses its flat layout)."""
        D = operands['D']
        if D is self.D:
            return self.matvec(x)
        return banded_matvec(D, x, self.bws, self.ns)

    def to(self, dtype):
        """The same operator with its data cast to `dtype`."""
        return BandedOperator(self.D.to(dtype), self.bws, self.ns)

    @staticmethod
    def from_mlmatrix(mlm, data=None, device=None):
        """Build from an MLMatrix (its structure; `data` may replace its
        data tensor).  None if the space is not regularly banded."""
        bws = band_info(mlm.structure)
        if bws is None:
            return None
        ns = tuple(b[0] for b in mlm.structure.bs)
        if data is None:
            data = mlm.data
        if isinstance(data, torch.Tensor):
            maps = banded_gather_maps(mlm.structure, bws)
            D = banded_from_compact_device(
                data, maps, tuple(2 * b + 1 for b in bws), ns)
        else:
            D = banded_from_compact(data, mlm.structure, bws)
        return BandedOperator(D, bws, ns, device=device)

    def matvec(self, x):
        return self.flat.matvec(x)

    __call__ = matvec


def banded_matvec(D, x, bws, ns):
    """Banded matvec: `D` in ``(b_1..b_d, n_1..n_d)`` layout, `x` raveled
    (K4 on the flat reshape of `D`)."""
    return BandedOperator(D, bws, ns).matvec(x.reshape(-1))


# the JAX package's static-offset form exists for SPMD slicing; the port
# has one matvec
banded_matvec_static = banded_matvec
