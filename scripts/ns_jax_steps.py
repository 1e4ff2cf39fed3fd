# -*- coding: utf-8 -*-
"""The JAX package's Navier-Stokes step sequence on the CPU: the reference
that ``chip_smoke.py`` phase 16 holds the port's device scheme to
(``NS_TIMES_JAX``).

    JAX_PLATFORMS=cpu python scripts/ns_jax_steps.py [n_x n_y]

Runs ``examples/navier_stokes.py``'s ``NavierStokes`` (default n_el
(16, 32), p=2, Re=20) from its Stokes state with ROWDAIND2, tau0 5e-2,
tol 1e-2, to t_end 1.0 on the host scheme, and prints the accepted step
times, the step count, the final divergence norm and the seconds it
took as one JSON line."""

import importlib.util as ilu
import json
import os
import sys
import time


def main(n_el=(16, 32)):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                        'examples', 'navier_stokes.py')
    spec = ilu.spec_from_file_location('jax_navier_stokes', path)
    mod = ilu.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    ns = mod.NavierStokes(n_el=n_el, p=2, Re=20.0)
    x0 = ns.initial_state()
    times, states = ns.integrate(x0=x0, tau=5e-2, t_end=1.0,
                                 method='rowdaind2', tol=1e-2,
                                 backend='host')
    print(json.dumps(dict(n_el=list(n_el), n_free=len(x0),
                          steps=len(times) - 1, times=times,
                          divergence=float(ns.divergence_norm(states[-1])),
                          seconds=time.perf_counter() - t0)))


if __name__ == '__main__':
    main(tuple(int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2
         else (16, 32))
