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
"""

import numpy as np
import torch

from .. import _cuda


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
    lay = flat_banded_layout(bws, ns)
    return torch.as_tensor(D).reshape(lay['C'], lay['F'])


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
    raveled vectors of the full dof grid."""

    def __init__(self, D, bws, ns):
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

    def matvec(self, x):
        lead, F = self.lay['lead'], self.lay['F']
        xp = torch.zeros(F + 2 * lead, dtype=self.dtype, device=self.device)
        xp[lead:lead + F] = x
        return flat_banded_matvec(self.D, xp, self._offs, lead)

    __call__ = matvec
