# -*- coding: utf-8 -*-
"""Differentiable and batched assembly with respect to the geometry, the
input fields and the parameters (port of :mod:`pyiga_tpu.diff`).

:func:`assembly_coeff_fn` returns a function mapping user-layout geometry
coefficients (the layout of ``geo.coeffs``) to the assembled compact data
tensor; :func:`assembly_input_fn` does the same for a named parameter or
a scalar parametric spline input of a compiled form.  Both run the port's
production kernels: the geometry stages (K2), the geometry fields (K1),
a form's coefficient fields (K5) and the contraction chains (K2 stages,
one K3 fold).  Each kernel is a :class:`torch.autograd.Function` whose
backward is a kernel too (K1's ``geo_fields_bwd_kernel``, K2 with the
roles of field and table swapped for K2's and K3's, the generated
adjoint of K5), so ``torch.autograd`` gives exact *shape derivatives*
and coefficient derivatives on the card; on CPU tensors the same
Functions run the plain versions (K5 its plain torch evaluation, which
autograd differentiates).  Under ``set_dtype(np.float32)`` the whole
path runs in float32, as ``pyiga_tpu.diff`` casts the tables, weights and
coefficients to the compute dtype: the coefficients, parameters and input
fields enter in float32, every kernel runs its float32 instance (the
backward kernels and K5's adjoint too), and the gradient comes back in
the dtype of the tensor the caller passed, as ``jax.grad`` gives it.  ``torch.func.vmap`` over a stack of
coefficient arrays equals the loop (the kernels' rules loop over the
batch).  Forward mode and second derivatives run on the card too, as the
JAX package's ``jax.jvp`` / ``jax.jacfwd`` / ``jax.hessian`` through its
XLA forms: every kernel Function has a ``jvp`` (K2 and K3 on the
tangents, K1-jvp, K5's generated tangent program) and every backward
kernel a ``jvp`` and a ``backward`` of its own (K1-hvp and K1-jvp for
K1-bwd, K2-bwd and K3 for K2-/K3-bwd, K5's generated second-order
program and its tangent program for its adjoint), so ``torch.func.jvp``,
``torch.func.jacfwd`` (``vmap`` of ``jvp``), ``torch.func.hessian``,
forward over reverse, ``create_graph`` and ``torch.autograd.forward_ad``
dual tensors go through the kernels, in float64 and in float32.

The tables, Gauss weights and quadrature grids are fixed at the
assembler's construction and are constants: asking a gradient of one
raises.  The fused stage-2 + fold tail (``PYIGA_TAIL_FUSED``) has no
backward: a chain that autograd records takes the two-call chain (K2
stages, one K3 fold), as the JAX package's build on
``assemble_terms_folded``; one it does not record takes the route
``run_device`` takes.

:func:`implicit_cg_solve` solves ``A x = b`` by conjugate gradients with
gradients by implicit differentiation: one adjoint solve with the same
operator, as ``jax.lax.custom_linear_solve(symmetric=True)``.
"""

import numpy as np
import torch
from torch.autograd import forward_ad

from . import _cuda, geometry
from .assemblers import BaseGaussAssembler
from .compile import VFormAssembler, check_mode
from .config import get_dtype
from .ops.basis import dense_collocation_tables
from .ops.geom import tp_apply
from .solvers import cg

__all__ = ['assembly_coeff_fn', 'assembly_input_fn', 'implicit_cg_solve',
           'user_coeffs_to_internal']


class _AdjointSolve(torch.autograd.Function):
    """``apply(r, solve, again, cell)``: zeros of `r`'s shape whose
    backward is the adjoint solve ``again(g)`` (the operator is symmetric;
    `again` is :func:`implicit_cg_solve` itself, so a second derivative
    flows through it).  Its ``jvp`` is zero: the residual it is applied to
    is formed from :class:`_Tangent`'s solution, whose tangent makes the
    residual's vanish.  The backward marks `cell` for that
    :class:`_Tangent`: the pass is a first-order one."""

    @staticmethod
    def forward(r, solve, again, cell):
        return torch.zeros_like(r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.again, ctx.cell = inputs[2], inputs[3]
        ctx.set_materialize_grads(False)   # None: no tangent

    @staticmethod
    def backward(ctx, g):
        ctx.cell['first'] = True
        return ctx.again(g), None, None, None

    @staticmethod
    def jvp(ctx, dr, _solve, _again, _cell):
        return torch.zeros_like(dr)

    vmap = _cuda.loop_vmap(lambda *a: _AdjointSolve.apply(*a))


class _Tangent(torch.autograd.Function):
    """``apply(r, solve, again, cell)``: zeros of `r`'s shape whose
    ``jvp`` is the solve of the residual's tangent, ``solve(dr) = A^-1
    (db - (dA) x*)`` (one solve, as ``custom_linear_solve``'s JVP: through
    :class:`~pyiga_tpu_torch._cuda.Launch`, once a member of a ``vmap``
    batch), so that ``x* + apply(b - A x*)`` carries the solution's
    tangent.  In a first-order
    backward pass (`cell` marked by :class:`_AdjointSolve`) its cotangent
    is ``g - A lambda``, zero up to the adjoint solve's tolerance, and it
    returns none; in a later pass (reverse over reverse) it returns
    ``again(u)``: the solution's dependence on the operator, the term of
    the second derivative that a solution without history would drop."""

    @staticmethod
    def forward(r, solve, again, cell):
        return torch.zeros_like(r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.solve, ctx.again, ctx.cell = inputs[1], inputs[2], inputs[3]
        ctx.set_materialize_grads(False)   # None: no tangent

    @staticmethod
    def backward(ctx, u):
        if ctx.cell.pop('first', False):
            return None, None, None, None
        return ctx.again(u), None, None, None

    @staticmethod
    def jvp(ctx, dr, _solve, _again, _cell):
        return ctx.solve(dr)

    vmap = _cuda.loop_vmap(lambda *a: _Tangent.apply(*a))


def _forward_mode():
    """Whether forward mode may be running: a dual level of
    ``torch.autograd.forward_ad`` or a ``torch.func`` transform (whose
    tangents need not require grad, whatever grad mode says)."""
    return (forward_ad._current_level >= 0
            or torch._C._functorch.peek_interpreter_stack() is not None)


def implicit_cg_solve(matvec, b, tol=1e-12, maxiter=None, precond=None):
    """Solve ``A x = b`` (A symmetric positive definite, given as the
    function `matvec`) by conjugate gradients
    (:func:`~pyiga_tpu_torch.solvers.cg`: zero start, stop at ``||r|| <=
    tol ||b||``), with gradients by *implicit differentiation*: reverse
    mode through the Krylov loop is replaced by ONE adjoint solve with the
    same operator and preconditioner, as ``jax.lax.custom_linear_solve``
    with ``symmetric=True`` does in the JAX package.

    `matvec` may close over differentiable tensors (e.g. the assembled
    data tensor from :func:`assembly_coeff_fn`): with ``x*`` the solve
    (no history), ``x~ = x* + T(b - A x*)`` and the result ``x~ + Z(b - A
    x~)``, where ``T`` and ``Z`` are Functions whose values are zero:
    ``T``'s tangent is the solve of its input's, ``A^-1 (db - (dA) x*)``
    (one solve, as ``custom_linear_solve``'s JVP: forward mode,
    ``torch.func.jvp`` / ``jacfwd`` and ``torch.autograd.forward_ad``),
    and ``Z``'s backward is the adjoint solve ``lambda = A^-1 g`` (one
    solve), so the value is exactly ``x*``, `b` receives ``lambda`` and
    the operator's tensors ``-lambda^T (dA) x*``.  The adjoint solve is
    this function again and ``x~`` carries the solution's dependence, so
    second derivatives (``torch.func.hessian``, forward over reverse,
    ``create_graph``) flow through it; the two residuals cost two
    matvecs.  `precond` (optional SPD preconditioner apply) serves every
    solve; `maxiter` defaults to ``10 * b.numel()``."""
    if maxiter is None:
        maxiter = 10 * b.numel()     # total system size, not the last axis

    def cg_solve(rhs):
        return cg(matvec, rhs, tol=tol, maxiter=maxiter, precond=precond)[0]

    def solve(rhs):         # no history; once a member of a vmap batch
        with torch.no_grad():
            return _cuda.Launch.apply(cg_solve, rhs.detach())

    def again(rhs):
        return implicit_cg_solve(matvec, rhs, tol, maxiter, precond)

    x = solve(b)
    if not (torch.is_grad_enabled() or _forward_mode()):
        return x
    r = b - matvec(x)
    # a tangent need not require grad: the guard sees both modes
    if not _cuda.differentiated(r):
        return x
    cell = {}
    x = x + _Tangent.apply(r, solve, again, cell)
    return x + _AdjointSolve.apply(b - matvec(x), solve, again, cell)


def user_coeffs_to_internal(coeffs, is_nurbs, sdim):
    """Layout change from user coefficients (``geo.coeffs``: grid axes
    leading, XYZ components last, NURBS homogeneous with the weight as
    the final component) to the internal level-ordered, component-leading
    layout of :func:`pyiga_tpu_torch.ops.geom.geo_eval_tables`;
    differentiable (torch ops on a tensor)."""
    coeffs = torch.as_tensor(coeffs)
    if coeffs.dim() == sdim:        # scalar-valued: add component axis
        coeffs = coeffs[..., None]
    if is_nurbs:
        coeffs = torch.cat((coeffs[..., :-1].flip(-1), coeffs[..., -1:]),
                           dim=-1)
    else:
        coeffs = coeffs.flip(-1)
    return torch.movedim(coeffs, -1, 0)


def _tensor(x, asm):
    """`x` as a tensor of the compute dtype on the assembler's device (a
    tensor keeps its autograd history: its gradient comes back in its own
    dtype)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=get_dtype(), device=asm.device)
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=get_dtype(),
                           device=asm.device)


def _structured_geo(asm):
    """(is_nurbs, sdim, coeffs0) of the assembler's geometry, or raise."""
    geo = asm.geo
    if isinstance(geo, geometry.NurbsFunc):
        return True, geo.sdim, np.asarray(geo.coeffs)
    if isinstance(geo, geometry.BSplineFunc):
        return False, geo.sdim, np.asarray(geo.coeffs)
    raise ValueError(
        'assembly_coeff_fn requires a structured geometry (BSplineFunc or '
        'NurbsFunc); %r is evaluated on the host and is not differentiable'
        % type(geo).__name__)


def _internal_coeffs(asm, coeffs, is_nurbs, sdim):
    return user_coeffs_to_internal(_tensor(coeffs, asm), is_nurbs,
                                   sdim).contiguous()


def _gauss_assembler_fn(asm):
    is_nurbs, sdim, coeffs0 = _structured_geo(asm)

    def fn(coeffs):
        return asm._assemble_compact(asm.geo_inputs(
            geo_coeffs=_internal_coeffs(asm, coeffs, is_nurbs, sdim)))

    return fn, coeffs0


def _vform_assembler_fn(asm):
    is_nurbs, sdim, coeffs0 = _structured_geo(asm)
    scalar = not asm.vf.vec

    def fn(coeffs):
        ci = _internal_coeffs(asm, coeffs, is_nurbs, sdim)
        blocks = asm._assemble_blocks(asm.device_arrays(geo_coeffs=ci))
        return blocks[(None, None)] if scalar else blocks

    return fn, coeffs0


def assembly_input_fn(asm, name, mode='exact'):
    """Return ``(fn, x0)`` where ``fn(x)`` assembles the compact data
    tensor as a differentiable function of the named vform input or
    parameter — the knob for material/coefficient optimization (e.g. the
    gradient of a compliance through a diffusion coefficient: topology
    optimization).

    * If `name` is a declared *parameter*, ``x`` is its value array and
      ``x0`` the current value.
    * If `name` is an *input field* given as a scalar parametric
      :class:`~pyiga_tpu_torch.geometry.BSplineFunc`, ``x`` is its spline
      coefficient array (layout of ``f.coeffs``, level-ordered grid
      axes) and the needed Gauss-grid values/derivatives are recomputed
      from per-axis collocation tables (:func:`~pyiga_tpu_torch.ops.geom.
      tp_apply`).  First derivatives of the input are supported;
      physical, vector-valued, or second-derivative inputs raise
      ``NotImplementedError``.

    Only :class:`~pyiga_tpu_torch.compile.VFormAssembler` takes named
    inputs; scalar forms return the single data tensor, vector forms the
    block dict (as in :func:`assembly_coeff_fn`).  `mode` is accepted as
    ``run_device`` accepts it.  The assembly runs in the compute dtype
    (the inputs and the collocation tables cast to it, as the JAX
    package's)."""
    if not isinstance(asm, VFormAssembler):
        raise TypeError('assembly_input_fn requires a VFormAssembler '
                        '(predefined Gauss assemblers take no named inputs)')
    check_mode(mode)
    scalar = not asm.vf.vec

    def run(inputs):
        blocks = asm._assemble_blocks(asm.device_arrays(inputs))
        return blocks[(None, None)] if scalar else blocks

    if name in asm._param_values:
        x0 = np.asarray(asm._param_values[name], dtype=float)
        # the operand's shape (a scalar parameter is uploaded as (1,))
        shape = asm._device_operands()['inputs']['param:' + name].shape

        def fn(x):
            return run({'param:' + name: _tensor(x, asm).reshape(shape)})
        return fn, x0

    if name == 'geo':
        raise ValueError("use assembly_coeff_fn for derivatives w.r.t. the "
                         'geometry control points')
    inps = [i for i in asm.vf.inputs if i.name == name]
    if not inps:
        raise ValueError('%r is not an input or parameter of this form'
                         % name)
    inp = inps[0]
    f = asm._input_values[name]
    if inp.physical:
        raise NotImplementedError('physical input fields are evaluated at '
                                  'mapped points; not differentiable in '
                                  'coeffs')
    if inp.shape != () or not isinstance(f, geometry.BSplineFunc) or \
            isinstance(f, geometry.NurbsFunc):
        raise NotImplementedError('only scalar parametric BSplineFunc '
                                  'inputs are supported')
    orders = {sum(key[3]) for key in asm._needed_keys
              if key[0] == 'input_deriv' and key[1] == name}
    if any(o > 1 for o in orders):
        raise NotImplementedError('input derivatives of order > 1')

    d = len(f.kvs)
    host_tabs = [np.ascontiguousarray(B.swapaxes(-2, -1))   # (nd+1, Q, n)
                 for B in dense_collocation_tables(f.kvs, asm.grid,
                                                   numderiv=1)]
    tables = {}         # compute dtype -> (value tables, derivative tables)
    x0 = np.asarray(f.coeffs, dtype=float)

    def fn(coeffs):
        dtype = get_dtype()
        if dtype not in tables:
            tabs = [torch.as_tensor(B, dtype=dtype, device=asm.device)
                    for B in host_tabs]
            tables[dtype] = [t[0] for t in tabs], [t[1] for t in tabs]
        val_tabs, der_tabs = tables[dtype]
        c = _tensor(coeffs, asm)
        inputs = {'input:' + name: tp_apply(val_tabs, c).contiguous()}
        if 1 in orders:
            # derivative axis in XYZ order: coordinate k = level axis d-1-k
            ders = [tp_apply([der_tabs[j] if j == d - 1 - k else val_tabs[j]
                              for j in range(d)], c) for k in range(d)]
            inputs['ideriv:%s:1' % name] = torch.stack(ders, dim=0)
        return run(inputs)

    return fn, x0


def assembly_coeff_fn(asm, mode='exact'):
    """Return ``(fn, coeffs0)`` where ``fn(coeffs)`` assembles the compact
    data tensor (:class:`~pyiga_tpu_torch.mlmatrix.MLMatrix` layout) on
    the assembler's device as a differentiable function of the geometry
    coefficients and ``coeffs0 = geo.coeffs`` is the assembler's current
    coefficient array.

    `coeffs` (layout of ``geo.coeffs``; a numpy array or a tensor, whose
    autograd history is kept) may be differentiated with
    ``torch.autograd`` (shape derivatives) and batched with
    ``torch.func.vmap``.  ``fn(coeffs0)`` equals ``asm.run_device()`` (the
    same kernels in the same order).  For NURBS the coefficients are the
    homogeneous ones, weights as the last component.

    `asm` is a predefined Gauss assembler
    (:class:`~pyiga_tpu_torch.assemblers.BaseGaussAssembler` subclass) or
    a compiled vform assembler (:class:`~pyiga_tpu_torch.compile.
    VFormAssembler`; scalar forms return the single data tensor, vector
    forms the block dict); its geometry must be a
    :class:`~pyiga_tpu_torch.geometry.BSplineFunc` or
    :class:`~pyiga_tpu_torch.geometry.NurbsFunc`.  `mode` is accepted as
    ``run_device`` accepts it: the port has one mode, the exact one.
    The assembly runs in the compute dtype (:func:`~pyiga_tpu_torch.
    config.get_dtype`; the coefficients cast to it)."""
    check_mode(mode)
    if isinstance(asm, BaseGaussAssembler):
        return _gauss_assembler_fn(asm)
    if isinstance(asm, VFormAssembler):
        return _vform_assembler_fn(asm)
    raise TypeError('unsupported assembler type %r' % type(asm).__name__)
