"""Standalone transliteration of the reference pendulum DDP solve.

This is the *reference-parity oracle* (BASELINE north star: "matching the
reference C++ solver's control sequences within tolerance at the same horizon
and iteration budget").  It re-implements, in plain Python/numpy with zero
dependence on ddp_jax, the exact algorithm the reference driver runs:

- driver config:            /root/reference/test/pendulum_ddp.cpp:24-114
  (pendulum m=1 L=1, horizon 200, dt 0.01, target q=3.14 through a double
  constraint_advance_time, method primal_dual_affine_multipliers,
  mu0=1e20, w0=1/mu0, n0=mu0^-0.1, reg0=0, 200 iters, threshold 1e-80)
- outer AL loop:            ddp.hpp:744-842  (incl. the pre-loop
  backward/forward whose trajectory is never swapped in, ddp.hpp:768-773)
- update_derivatives:       ddp.hpp:641-696  (multiplier update decision
  tree; on success n = opt_obj(new mults)/mu^0.1, w /= mu, ddp.hpp:787-797)
- backward pass:            ddp_bwd.ipp:9-155  (Q-expansion with AL terms,
  LLT of Quu+reg*I, failure -> reg=max(reg,mu); mu*=2; reg*=2; restart
  whole sweep; simplified V-update Vx=Qx+Qux'k, Vxx=Qxx+Qux'K)
- forward pass:             ddp_fwd.ipp:9-67  (u = u_old + step*k + K*(x -
  x_old), accept iff sum(cost_new - cost_old) <= 0, step *= 0.5, floor 1e-10)
- AL cost:                  ddp.hpp:699-735  (l + p(x)'eq + mu/2 ||eq||^2)
- optimality measures:      ddp.hpp:516-627  (reverse adjoint recursions)
- affine multipliers:       mat_seq_common.hpp:12-177  (p(x) = val + jac*(x
  - origin); update_origin: val += jac*d, jac = jac*ddiff, origin = x_new)
- pendulum model:           pendulum_model.hpp:105-130  (a = -g/L sin q +
  tau/m, g = 9.81)
- Euler dynamics:           problem.hpp:441-503  (q' = q + dt v, v' = v +
  dt a; analytic first-order chain)
- double advance_time:      problem.hpp:527-629  (eq at outer t uses
  x_{t+2} = f(t+1, f(t, x, u), u) -- the SAME control u both steps)
- config constraint:        problem.hpp:745-864  (eq = q - target)
- cost:                     problem.hpp:932-942  (l = 0.5 c ||u||^2, lf = 0)

Derivative precision: the reference computes second-order derivatives by
finite differences (problem.hpp:50-341) under MPFR-1000 scalars, where the
FD truncation error is ~1e-500 -- i.e. exact.  The oracle uses the closed
forms (the pendulum constraint composition is the polynomial
    eq(x, u) = q + 2 dt v + dt^2 (u - G sin q) - target,  G = g/L,
so every derivative is analytic), which is the same limit.

Precision-generic like the reference's scalar template: pass
``scalar=float`` (f64) or e.g. ``scalar=mpmath.mpf`` with matching
``sin``/``cos``/``sqrt`` to instantiate the whole solve at another precision
(the analog of test/pendulum_ddp.cpp:15-17's MPFR instantiation).  All
arrays are numpy object arrays in non-float mode; only np.dot-compatible
ops are used.
"""

from __future__ import annotations

import math

import numpy as np

G_OVER_L = 9.81  # pendulum_model.hpp:26 (g), driver length = 1.0


class _Scalar:
    """Bundle of scalar-type hooks (≙ the reference's Scalar template param)."""

    def __init__(self, scalar=float, sin=math.sin, cos=math.cos, sqrt=math.sqrt):
        self.scalar = scalar
        self.sin = sin
        self.cos = cos
        self.sqrt = sqrt

    @property
    def dtype(self):
        return np.float64 if self.scalar is float else object

    def zeros(self, shape):
        if self.scalar is float:
            return np.zeros(shape, dtype=np.float64)
        a = np.empty(shape, dtype=object)
        a[...] = self.scalar(0)
        return a

    def asarray(self, x):
        a = np.asarray(x, dtype=object)
        out = np.empty(a.shape, dtype=self.dtype)
        flat_in, flat_out = a.ravel(), out.ravel()
        for i in range(flat_in.size):
            flat_out[i] = self.scalar(flat_in[i])
        return out


def _cholesky(A, sp: _Scalar):
    """Lower-triangular LLT; returns None on numerical failure
    (≙ Eigen llt().info() == NumericalIssue, ddp_bwd.ipp:104)."""
    n = A.shape[0]
    L = sp.zeros((n, n))
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j] - np.dot(L[i, :j], L[j, :j])
            if i == j:
                if not s > 0:  # non-PD or NaN
                    return None
                L[i, i] = sp.sqrt(s)
            else:
                L[i, j] = s / L[j, j]
    return L


def _chol_solve(L, b):
    n = L.shape[0]
    y = b.copy()
    for i in range(n):
        y[i] = (y[i] - np.dot(L[i, :i], y[:i])) / L[i, i]
    for i in reversed(range(n)):
        y[i] = (y[i] - np.dot(L[i + 1 :, i], y[i + 1 :])) / L[i, i]
    return y


class PendulumReferenceProblem:
    """The driver's problem: dynamics + doubly-advanced config constraint.

    nx = ndx = 2 (q, v), nu = 1, one scalar constraint active at outer
    timestep t_active = horizon - 2 (the range_row_filter keeps rows only at
    inner t = horizon, shifted twice, pendulum_ddp.cpp:37-39).
    """

    def __init__(self, sp: _Scalar, horizon=200, dt=0.01, target=3.14, c=1.0,
                 mass=1.0, length=1.0):
        self.sp = sp
        self.T = horizon
        self.dt = sp.scalar(dt)
        self.target = sp.scalar(target)
        self.c = sp.scalar(c)
        self.mass = sp.scalar(mass)
        self.G = sp.scalar(G_OVER_L) / sp.scalar(length)
        self.t_active = horizon - 2

    # --- model (pendulum_model.hpp:105-130) ---
    def acc(self, q, v, u):
        return -self.G * self.sp.sin(q) + u / self.mass

    # --- dynamics (problem.hpp:441-461) ---
    def f(self, t, x, u):
        q, v = x[0], x[1]
        a = self.acc(q, v, u[0])
        out = self.sp.zeros((2,))
        out[0] = q + self.dt * v
        out[1] = v + self.dt * a
        return out

    def f_derivs(self, t, x, u):
        """fx [2,2], fu [2,1], fxx [2,2,2], fux [2,1,2], fuu [2,1,1]
        (first order: problem.hpp:463-503; second order: exact limit of the
        FD schemes, problem.hpp:50-341)."""
        sp = self.sp
        q = x[0]
        dt = self.dt
        fx = sp.zeros((2, 2))
        fx[0, 0] = sp.scalar(1)
        fx[0, 1] = dt
        fx[1, 0] = dt * (-self.G * sp.cos(q))
        fx[1, 1] = sp.scalar(1)
        fu = sp.zeros((2, 1))
        fu[1, 0] = dt / self.mass
        fxx = sp.zeros((2, 2, 2))
        fxx[1, 0, 0] = dt * self.G * sp.sin(q)
        fux = sp.zeros((2, 1, 2))
        fuu = sp.zeros((2, 1, 1))
        return fx, fu, fxx, fux, fuu

    # --- constraint: double advance_time of config target ---
    # eval composes the actual dynamics with the same u (problem.hpp:563-567
    # applied twice); closed form eq = q + 2 dt v + dt^2 a(q,v,u) - target.
    def eq(self, t, x, u):
        out = self.sp.zeros((1,))
        if t != self.t_active:
            return out
        x1 = self.f(t, x, u)
        x2 = self.f(t + 1, x1, u)
        out[0] = x2[0] - self.target
        return out

    def eq_derivs(self, t, x, u):
        """eq_x [1,2], eq_u [1,1], eq_xx [1,2,2], eq_ux [1,1,2],
        eq_uu [1,1,1]; zero rows when inactive (0-row storage in the
        reference).  Chain product per problem.hpp:569-605 == closed form."""
        sp = self.sp
        eq_x = sp.zeros((1, 2))
        eq_u = sp.zeros((1, 1))
        eq_xx = sp.zeros((1, 2, 2))
        eq_ux = sp.zeros((1, 1, 2))
        eq_uu = sp.zeros((1, 1, 1))
        if t != self.t_active:
            return eq_x, eq_u, eq_xx, eq_ux, eq_uu
        q = x[0]
        dt = self.dt
        dt2 = dt * dt
        eq_x[0, 0] = sp.scalar(1) - dt2 * self.G * sp.cos(q)
        eq_x[0, 1] = dt + dt
        eq_u[0, 0] = dt2 / self.mass
        eq_xx[0, 0, 0] = dt2 * self.G * sp.sin(q)
        return eq_x, eq_u, eq_xx, eq_ux, eq_uu

    # --- cost (problem.hpp:932-942) ---
    def l(self, t, x, u):
        return self.sp.scalar(0.5) * self.c * np.dot(u, u)

    def lf(self, x):
        return self.sp.scalar(0)


def solve_pendulum_reference(
    mu_init=1e20,
    max_iterations=200,
    threshold=1e-80,
    reg=0.0,
    w=None,
    n=None,
    horizon=200,
    dt=0.01,
    target=3.14,
    c=1.0,
    x_init=(0.0, 0.0),
    jac_init=None,  # [2] multiplier jac row at t_active (eq.jac().setRandom(),
    # ddp.hpp:760-764); None -> zeros
    scalar=float,
    sin=math.sin,
    cos=math.cos,
    sqrt=math.sqrt,
    record_history=False,
):
    """ddp_solver_t::solve<primal_dual_affine_multipliers> (ddp.hpp:744-842)
    on the pendulum driver problem.  Returns dict with xs [T+1,2], us [T,1],
    final mu/reg/w/n, per-iteration history, and the final optimality
    measures."""
    sp = _Scalar(scalar, sin, cos, sqrt)
    prob = PendulumReferenceProblem(sp, horizon, dt, target, c)
    T = prob.T
    ta = prob.t_active

    mu = sp.scalar(mu_init)
    reg = sp.scalar(reg)
    w = sp.scalar(w) if w is not None else sp.scalar(1) / mu
    n = sp.scalar(n) if n is not None else sp.scalar(1) / (mu ** sp.scalar(0.1))
    thr = sp.scalar(threshold)

    # make_trajectory with zero controls (ddp.hpp:392-415, driver
    # control_generator_t)
    xs = sp.zeros((T + 1, 2))
    xs[0] = sp.asarray(list(x_init))
    us = sp.zeros((T, 1))
    for t in range(T):
        xs[t + 1] = prob.f(t, xs[t], us[t])

    # affine multipliers: val zero, jac random, origin = x_t (ddp.hpp:757-764)
    p_val = sp.zeros((1,))
    p_jac = sp.zeros((1, 2))
    if jac_init is not None:
        p_jac[0] = sp.asarray(np.asarray(jac_init, dtype=np.float64))
    p_origin = xs[ta].copy()

    # control feedback storage (affine in state, origin = x_t)
    fb_k = sp.zeros((T, 1))
    fb_K = sp.zeros((T, 1, 2))
    fb_origin = xs[:T].copy()

    def compute_derivatives(xs, us):
        d = {
            "fx": sp.zeros((T, 2, 2)), "fu": sp.zeros((T, 2, 1)),
            "fxx": sp.zeros((T, 2, 2, 2)), "fux": sp.zeros((T, 2, 1, 2)),
            "fuu": sp.zeros((T, 2, 1, 1)),
            "eq": sp.zeros((T, 1)), "eqx": sp.zeros((T, 1, 2)),
            "equ": sp.zeros((T, 1, 1)), "eqxx": sp.zeros((T, 1, 2, 2)),
            "equx": sp.zeros((T, 1, 1, 2)), "equu": sp.zeros((T, 1, 1, 1)),
            "lu": sp.zeros((T, 1)), "luu": sp.zeros((T, 1, 1)),
        }  # lx = lxx = lux = 0; lfx = lfxx = 0 (problem.hpp:956-997)
        for t in range(T):
            d["fx"][t], d["fu"][t], d["fxx"][t], d["fux"][t], d["fuu"][t] = (
                prob.f_derivs(t, xs[t], us[t])
            )
            d["eq"][t] = prob.eq(t, xs[t], us[t])
            (d["eqx"][t], d["equ"][t], d["eqxx"][t], d["equx"][t],
             d["equu"][t]) = prob.eq_derivs(t, xs[t], us[t])
            d["lu"][t] = prob.c * us[t]
            d["luu"][t][0, 0] = prob.c
        return d

    def mult_eval(x):
        """p(x) = val + jac (x - origin) at t_active
        (mat_seq_common.hpp:106-115)."""
        return p_val + np.dot(p_jac, x - p_origin)

    def update_origin_mults(xs):
        nonlocal p_val, p_jac, p_origin
        # vector space: difference = x_new - origin, d_difference = I
        d = xs[ta] - p_origin
        p_val = p_val + np.dot(p_jac, d)
        p_origin = xs[ta].copy()

    def update_origin_fb(xs):
        nonlocal fb_k, fb_origin
        for t in range(T):
            d = xs[t] - fb_origin[t]
            fb_k[t] = fb_k[t] + np.dot(fb_K[t], d)
            fb_origin[t] = xs[t].copy()

    def optimality_constr(d):
        m = sp.scalar(0)
        for t in range(T):
            nrm = sp.sqrt(np.dot(d["eq"][t], d["eq"][t]))
            if nrm > m:
                m = nrm
        return m

    def optimality_obj(xs, d, mu):
        """ddp.hpp:575-627 (with multipliers already at origin = x_t)."""
        retval = sp.scalar(0)
        adj = sp.zeros((2,))  # lfx = 0
        for t in reversed(range(T)):
            pe = mult_eval(xs[t]) if t == ta else sp.zeros((1,))
            pjac = p_jac if t == ta else sp.zeros((1, 2))
            lu = (d["lu"][t] + np.dot(d["equ"][t].T, pe)
                  + mu * np.dot(d["equ"][t].T, d["eq"][t])
                  + np.dot(d["fu"][t].T, adj))
            score = sp.sqrt(np.dot(lu, lu))
            if score > retval:
                retval = score
            adj = (np.dot(d["fx"][t].T, adj)
                   + mu * np.dot(d["eqx"][t].T, d["eq"][t])
                   + np.dot(d["eqx"][t].T, pe)
                   + np.dot(pjac.T, d["eq"][t]))
        return retval

    def cost_seq_aug(xs, us, mu):
        """ddp.hpp:699-735 with the *current* multipliers."""
        costs = sp.zeros((T + 1,))
        for t in range(T):
            costs[t] = prob.l(t, xs[t], us[t])
            if t == ta:
                ce = prob.eq(t, xs[t], us[t])
                pe = mult_eval(xs[t])
                costs[t] = (costs[t] + np.dot(pe, ce)
                            + (mu / sp.scalar(2)) * np.dot(ce, ce))
        costs[T] = prob.lf(xs[T])
        return costs

    def backward_pass(xs, d, reg, mu):
        """ddp_bwd.ipp:9-155.  Mutates fb_k/fb_K/fb_origin like the
        reference mutates ctrl_fb; returns (mu, reg)."""
        I_u = sp.zeros((1, 1))
        I_u[0, 0] = sp.scalar(1)
        success = False
        while not success:
            Vx = sp.zeros((2,))
            Vxx = sp.zeros((2, 2))
            failed = False
            for t in reversed(range(T)):
                pe = mult_eval(xs[t]) if t == ta else sp.zeros((1,))
                pe_x = p_jac if t == ta else sp.zeros((1, 2))
                tmp = pe + mu * d["eq"][t]
                tmp2 = pe_x + mu * d["eqx"][t]
                fx, fu = d["fx"][t], d["fu"][t]
                Qx = (np.dot(fx.T, Vx) + np.dot(d["eqx"][t].T, tmp)
                      + np.dot(pe_x.T, d["eq"][t]))  # lx = 0
                Qu = (d["lu"][t] + np.dot(fu.T, Vx)
                      + np.dot(d["equ"][t].T, tmp))
                Qxx = (np.dot(fx.T, np.dot(Vxx, fx))
                       + np.dot(d["eqx"][t].T, tmp2)
                       + np.dot(pe_x.T, d["eqx"][t])
                       + np.tensordot(tmp, d["eqxx"][t], axes=1)
                       + np.tensordot(Vx, d["fxx"][t], axes=1))
                Quu = (d["luu"][t] + np.dot(fu.T, np.dot(Vxx, fu))
                       + mu * np.dot(d["equ"][t].T, d["equ"][t])
                       + np.tensordot(tmp, d["equu"][t], axes=1)
                       + np.tensordot(Vx, d["fuu"][t], axes=1))
                Qux = (np.dot(fu.T, np.dot(Vxx, fx))
                       + np.dot(d["equ"][t].T, tmp2)
                       + np.tensordot(tmp, d["equx"][t], axes=1)
                       + np.tensordot(Vx, d["fux"][t], axes=1))

                L = _cholesky(Quu + reg * I_u, sp)
                if L is None:  # ddp_bwd.ipp:105-132
                    if reg < mu:
                        reg = mu
                    mu = mu * sp.scalar(2)
                    reg = reg * sp.scalar(2)
                    failed = True
                    break
                fb_origin[t] = xs[t].copy()
                fb_k[t] = _chol_solve(L, -Qu)
                fb_K[t] = np.stack([_chol_solve(L, -Qux[:, j])
                                    for j in range(2)], axis=1)
                Vx = Qx + np.dot(Qux.T, fb_k[t])
                Vxx = Qxx + np.dot(Qux.T, fb_K[t])
            if not failed:
                success = True
        return mu, reg

    def forward_pass(xs_old, us_old, mu):
        """ddp_fwd.ipp:9-67; returns (xs_new, us_new, step)."""
        costs_old = cost_seq_aug(xs_old, us_old, mu)
        step = sp.scalar(1)
        xs_new = xs_old.copy()
        us_new = us_old.copy()
        while True:
            if step < sp.scalar(1e-10):
                break
            for t in range(T):
                dx = xs_new[t] - fb_origin[t]
                us_new[t] = us_old[t] + step * fb_k[t] + np.dot(fb_K[t], dx)
                xs_new[t + 1] = prob.f(t, xs_new[t], us_new[t])
            costs_new = cost_seq_aug(xs_new, us_new, mu)
            if np.sum(costs_new - costs_old) <= 0:
                break
            step = step * sp.scalar(0.5)
        return xs_new, us_new, step

    history = []

    # --- pre-loop (ddp.hpp:768-773): derivatives, backward, forward whose
    # trajectory is never swapped in (only mu and the feedback survive) ---
    d = compute_derivatives(xs, us)
    mu, _reg_discard = backward_pass(xs, d, reg, mu)
    forward_pass(xs, us, mu)  # result discarded (new_traj overwritten)

    opt_obj = opt_constr = None
    for it in range(max_iterations):
        # --- update_derivatives (ddp.hpp:641-696) ---
        d = compute_derivatives(xs, us)
        update_origin_mults(xs)
        update_origin_fb(xs)
        opt_obj = optimality_obj(xs, d, mu)
        opt_constr = optimality_constr(d)
        if opt_constr < thr and opt_obj < thr:
            break  # optimum_attained
        gate = "none"  # ddp.hpp:677-695 decision label (for parity tests)
        if opt_obj < w:
            gate = "success" if opt_constr < n else "failure"
        if opt_obj < w:
            if opt_constr < n:  # update_success (ddp.hpp:677-688, 787-797)
                p_val_new = p_val + mu * (
                    d["eq"][ta] + np.dot(d["equ"][ta], fb_k[ta])
                )
                p_jac_new = p_jac + mu * (
                    d["eqx"][ta] + np.dot(d["equ"][ta], fb_K[ta])
                )
                p_val, p_jac = p_val_new, p_jac_new
                opt_obj2 = optimality_obj(xs, d, mu)
                n = opt_obj2 / (mu ** sp.scalar(0.1))
                w = w / mu
            else:  # update_failure
                mu = mu * sp.scalar(10)
        # else: no_update

        mu, reg = backward_pass(xs, d, reg, mu)
        xs_new, us_new, step = forward_pass(xs, us, mu)
        if step >= sp.scalar(0.5):  # ddp.hpp:819-824
            reg = reg / sp.scalar(2)
            if reg < sp.scalar(1e-5):
                reg = sp.scalar(0)
        xs, us = xs_new, us_new
        if record_history:
            history.append({
                "iter": it, "mu": mu, "reg": reg, "w": w, "n": n,
                "step": step, "opt_obj": opt_obj, "opt_constr": opt_constr,
                "gate": gate,
            })

    return {
        "xs": xs, "us": us, "mu": mu, "reg": reg, "w": w, "n": n,
        "opt_obj": opt_obj, "opt_constr": opt_constr, "history": history,
        "eq_final": prob.eq(ta, xs[ta], us[ta])[0],
    }


if __name__ == "__main__":
    res = solve_pendulum_reference(mu_init=1e20, max_iterations=200)
    print("final q_T:", res["xs"][-1][0], " |eq|:", abs(res["eq_final"]),
          " opt_obj:", res["opt_obj"], " opt_constr:", res["opt_constr"])
