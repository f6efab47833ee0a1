"""Eager L-BFGS with a strong-Wolfe line search.

Port of ``mpi4torch_tpu/utils/lbfgs.py``.  The mpi4torch reference's
data-parallel example drives ``torch.optim.LBFGS`` with a closure whose
every evaluation runs collectives on every rank; because the Allreduced
loss and gradients are the same bits on every rank, every rank takes the
same line-search branches and the ranks stay in lock-step.  This module
is that optimizer on a flat view of one tensor: values and gradients
come from ``torch.autograd``, and the control flow is plain Python over
host floats, so each scalar it branches on is read from the device once
(one synchronisation per scalar, expected on the card).

With ``comm`` the variable is domain-decomposed (each rank owns a
disjoint slice of one global variable), and every inner product and norm
the algorithm branches on is a global ``Allreduce``, so the ranks take
the same branches.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch


def _local_dot(a, b) -> float:
    return float(torch.vdot(a, b))


def _make_reducers(comm):
    """``(dot, max_abs, sum_abs)`` over the optimization variable: local
    without a communicator (or on one rank), global reductions with
    one."""
    if comm is None or comm.size == 1:
        return (_local_dot,
                lambda a: float(a.abs().max()),
                lambda a: float(a.abs().sum()))
    from ..constants import MPI_MAX, MPI_SUM

    # compression=False: the control scalars must be exact.
    def dot(a, b):
        return float(comm.Allreduce(torch.vdot(a, b), MPI_SUM,
                                    compression=False))

    def max_abs(a):
        return float(comm.Allreduce(a.abs().max(), MPI_MAX,
                                    compression=False))

    def sum_abs(a):
        return float(comm.Allreduce(a.abs().sum(), MPI_SUM,
                                    compression=False))

    return dot, max_abs, sum_abs


def _strong_wolfe(fg, x, d, f0, g0, *, c1=1e-4, c2=0.9, max_evals=25,
                  t0=1.0, _dot=_local_dot):
    """Bracket-and-zoom strong-Wolfe line search on phi(t) = f(x + t d).
    Returns ``(t, f_t, g_t, n_evals)``; falls back to the best point seen
    when the conditions cannot be met within the evaluation budget."""
    dphi0 = _dot(g0, d)
    if dphi0 >= 0:
        # Not a descent direction (numerical breakdown): signal the caller.
        return 0.0, f0, g0, 0

    def phi(t):
        f, g = fg(x + t * d)
        return float(f), g

    evals = 0
    t_prev, f_prev, g_prev = 0.0, float(f0), g0
    t = t0
    best = (0.0, float(f0), g0)

    bracket = None
    for _ in range(max_evals):
        f_t, g_t = phi(t)
        evals += 1
        if f_t < best[1]:
            best = (t, f_t, g_t)
        dphi_t = _dot(g_t, d)
        if f_t > float(f0) + c1 * t * dphi0 or (evals > 1 and f_t >= f_prev):
            bracket = (t_prev, f_prev, g_prev, t, f_t, g_t)
            break
        if abs(dphi_t) <= -c2 * dphi0:
            return t, f_t, g_t, evals
        if dphi_t >= 0:
            bracket = (t, f_t, g_t, t_prev, f_prev, g_prev)
            break
        t_prev, f_prev, g_prev = t, f_t, g_t
        t = 2.0 * t
    if bracket is None:
        return best[0], best[1], best[2], evals

    lo_t, lo_f, lo_g, hi_t, hi_f, hi_g = bracket
    for _ in range(max_evals - evals):
        t = 0.5 * (lo_t + hi_t)
        f_t, g_t = phi(t)
        evals += 1
        if f_t < best[1]:
            best = (t, f_t, g_t)
        dphi_t = _dot(g_t, d)
        if f_t > float(f0) + c1 * t * dphi0 or f_t >= lo_f:
            hi_t, hi_f, hi_g = t, f_t, g_t
        else:
            if abs(dphi_t) <= -c2 * dphi0:
                return t, f_t, g_t, evals
            if dphi_t * (hi_t - lo_t) >= 0:
                hi_t, hi_f, hi_g = lo_t, lo_f, lo_g
            lo_t, lo_f, lo_g = t, f_t, g_t
        if abs(hi_t - lo_t) < 1e-12:
            break
    return best[0], best[1], best[2], evals


def minimize_lbfgs(loss_fn: Callable, params, *, max_iter: int = 20,
                   history_size: int = 10, tolerance_grad: float = 1e-10,
                   tolerance_change: float = 1e-12,
                   value_and_grad: bool = False, comm=None,
                   callback: Optional[Callable] = None):
    """Minimize ``loss_fn(params)`` over the tensor ``params`` with
    L-BFGS (two-loop recursion, strong-Wolfe line search).  Returns
    ``(params, final_loss)``: a tensor shaped like ``params`` and a
    float.

    ``loss_fn`` returns a scalar tensor, differentiated with
    ``torch.autograd.grad``; with ``value_and_grad=True`` it returns
    ``(loss, gradient)`` itself.  Pass ``comm`` when ``params`` is
    domain-decomposed across ranks and ``loss_fn`` returns the global
    (Allreduced) loss: every scalar the algorithm branches on is then a
    global reduction, keeping the ranks in lock-step.  Leave it ``None``
    for replicated parameters.  ``callback(iteration, loss)``, when
    given, is called after every completed iteration."""
    shape = params.shape
    _dot, _max_abs, _sum_abs = _make_reducers(comm)

    def fg(xflat):
        if value_and_grad:
            f, g = loss_fn(xflat.reshape(shape))
            return f.detach(), g.reshape(-1)
        x = xflat.detach().reshape(shape).requires_grad_()
        f = loss_fn(x)
        (g,) = torch.autograd.grad(f, x)
        return f.detach(), g.reshape(-1)

    x = params.detach().reshape(-1)
    f, g = fg(x)
    s_hist: List = []
    y_hist: List = []
    rho_hist: List = []

    for it in range(max_iter):
        if _max_abs(g) <= tolerance_grad:
            break
        # Two-loop recursion.
        q = g
        alphas = []
        for s, y, rho in zip(reversed(s_hist), reversed(y_hist),
                             reversed(rho_hist)):
            a = rho * _dot(s, q)
            alphas.append(a)
            q = q - a * y
        if y_hist:
            gamma = _dot(s_hist[-1], y_hist[-1]) / max(
                _dot(y_hist[-1], y_hist[-1]), 1e-300)
        else:
            gamma = 1.0
        r = gamma * q
        for (s, y, rho), a in zip(zip(s_hist, y_hist, rho_hist),
                                  reversed(alphas)):
            b = rho * _dot(y, r)
            r = r + s * (a - b)
        d = -r

        t0 = min(1.0, 1.0 / max(_sum_abs(g), 1e-300)) \
            if not y_hist else 1.0
        t, f_new, g_new, _ = _strong_wolfe(fg, x, d, f, g, t0=t0, _dot=_dot)
        if t == 0.0:
            break
        x_new = x + t * d
        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        if sy > 1e-10:
            s_hist.append(s)
            y_hist.append(y)
            rho_hist.append(1.0 / sy)
            if len(s_hist) > history_size:
                s_hist.pop(0)
                y_hist.pop(0)
                rho_hist.pop(0)
        x, f, g = x_new, f_new, g_new
        if callback is not None:
            callback(it, float(f))
        if _max_abs(s) <= tolerance_change:
            break

    return x.reshape(shape), float(f)


class LBFGS:
    """Closure-style wrapper in the shape of the reference example's
    optimizer loop::

        opt = LBFGS(max_iter=20)
        params, loss = opt.step(lossfn, params)

    ``comm`` enables the domain-decomposed mode (see
    :func:`minimize_lbfgs`)."""

    def __init__(self, max_iter: int = 20, history_size: int = 10,
                 tolerance_grad: float = 1e-10,
                 tolerance_change: float = 1e-12, comm=None):
        self.max_iter = max_iter
        self.history_size = history_size
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.comm = comm

    def step(self, loss_fn: Callable, params,
             callback: Optional[Callable] = None) -> Tuple:
        return minimize_lbfgs(
            loss_fn, params, max_iter=self.max_iter,
            history_size=self.history_size,
            tolerance_grad=self.tolerance_grad,
            tolerance_change=self.tolerance_change, comm=self.comm,
            callback=callback)
