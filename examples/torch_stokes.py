# -*- coding: utf-8 -*-
"""Steady Stokes channel flow with a Taylor-Hood-like spline pair over
:mod:`pyiga_tpu_torch` (the port of ``examples/stokes.py``; the blocks
assemble on `device`, the card unless ``'cpu'`` is given).  The stationary
solution of the saddle-point system reproduces the analytic Poiseuille
profile: velocity u = (4 y (1-y), 0), linear pressure drop.

Run ``python examples/torch_stokes.py`` on a machine with a CUDA card, or
``python examples/torch_stokes.py cpu`` on the CPU."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_navier_stokes import NavierStokes  # noqa: E402  (examples dir)


def main(p=2, n_el=(8, 12), device=None):
    # Re only scales the viscosity of the linear Stokes operator here; the
    # stationary solve (initial_state) drops the convection term entirely
    ns = NavierStokes(n_el=n_el, p=p, Re=1.0, device=device)
    x = ns.initial_state()          # solves the steady Stokes system
    u_p = ns.LS.complete(x)
    vel, pres = ns.get_components(u_p)

    div = ns.divergence_norm(x)
    print('weak divergence norm: %.2e' % div)
    assert div < 1e-10

    # Poiseuille: u_x = 4 y (1-y), u_y = 0 across the whole channel
    y = np.linspace(0, 1, 21)
    for xpos in (0.5, 1.0, 1.7):
        V = vel.grid_eval((y, np.array([xpos])))
        err = max(np.abs(V[:, 0, 0] - 4 * y * (1 - y)).max(),
                  np.abs(V[:, 0, 1]).max())
        print('profile error at x=%.1f: %.2e' % (xpos, err))
        assert err < 1e-6

    # the pressure is exactly linear along the channel (constant gradient
    # drives the parabolic profile; its sign follows the form's convention)
    px = pres.grid_eval((np.array([0.5]), np.linspace(0.1, 1.9, 10)))[0]
    drops = np.diff(px)
    print('pressure gradient per segment: mean %.4f, spread %.2e'
          % (drops.mean(), np.ptp(drops)))
    assert np.ptp(drops) < 1e-6 * abs(drops.mean())
    return vel, pres


if __name__ == '__main__':
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
