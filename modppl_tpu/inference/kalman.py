"""Exact inference for linear-Gaussian SSMs: Kalman filtering/smoothing,
sequential AND time-parallel.

This is the framework's sequence-parallelism subsystem (SURVEY.md §5): the
reference's only sequential-scaling mechanism is O(1) EXTEND updates
(modppl/src/gfi.rs:111, dynunfold.rs:79-98), which keeps each step cheap
but leaves the time dimension strictly serial. On an accelerator the serial chain is
the latency wall for long sequences, so alongside the ``lax.scan`` filter
this module provides the *temporal parallelization* of Bayesian
filters/smoothers (Särkkä & García-Fernández, IEEE TAC 2021): filtering and
smoothing recast as prefix sums over an associative operator, executed by
``jax.lax.associative_scan`` in O(log T) depth across the time axis — the
honest long-context story for state-space models (no attention to
ring-shard).

It also serves as the LGSSM oracle for SMC tests, exactly as the discrete
forward algorithm (modppl/tests/hmm/forward.rs:3-23) anchors the HMM
particle-filter gate (tests/particle_filter.rs:76).

Conventions (models/lgssm.py): x_1 ~ N(mu0, P0); x_t = A x_{t-1} + N(0, Q);
y_t = H x_t + N(0, R); ys has shape (T, E).
"""

import jax
import jax.numpy as jnp

from modppl_tpu.ops.smalllinalg import (
    SMALL_DIM_MAX,
    cholesky_small,
    lu_solve_small,
    solve_lower_small,
    solve_psd_small,
    tril_logdet_small,
)

# above this the unrolled expression graphs stop paying; jnp.linalg wins
_LU_DIM_MAX = 8


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def _solve_psd(S, B):
    """Solve S X = B for symmetric-PD S (batched).

    Small static dims route through the unrolled custom-call-free Cholesky
    (ops/smalllinalg.py), which fuses into the ``lax.scan`` body where a
    ``jnp.linalg.cholesky`` custom call cannot.
    """
    if S.shape[-1] <= SMALL_DIM_MAX:
        return solve_psd_small(S, B)
    L = jnp.linalg.cholesky(S)
    return jax.scipy.linalg.cho_solve((L, True), B)


def _solve_general(A, B):
    """Solve general A X = B; unrolled pivoted LU at small static dims."""
    if A.shape[-1] <= _LU_DIM_MAX:
        return lu_solve_small(A, B)
    return jnp.linalg.solve(A, B)


def _mvn_logpdf(x, mean, cov):
    d = x.shape[-1]
    if d <= SMALL_DIM_MAX:
        L = cholesky_small(cov)
        z = solve_lower_small(L, x - mean)
        logdet = 2.0 * tril_logdet_small(L)
    else:
        L = jnp.linalg.cholesky(cov)
        z = jax.scipy.linalg.solve_triangular(L, x - mean, lower=True)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)),
                               axis=-1)
    return -0.5 * (d * jnp.log(2.0 * jnp.pi) + logdet
                   + jnp.sum(z * z, axis=-1))


# ---------------------------------------------------------------------------
# Sequential filter / smoother (lax.scan — the O(T)-depth reference form)
# ---------------------------------------------------------------------------

@jax.jit
def kalman_filter(params, ys):
    """Sequential Kalman filter.

    Returns dict with filtered means (T, D), covs (T, D, D), and ``log_ml``
    — the exact log marginal likelihood sum_t log p(y_t | y_{1:t-1}).
    """
    A, Q, H, R = params.A, params.Q, params.H, params.R

    def step(carry, y):
        m_pred, P_pred = carry
        S = _sym(H @ P_pred @ H.T + R)
        ll = _mvn_logpdf(y, H @ m_pred, S)
        K = _solve_psd(S, H @ P_pred).T                   # P H^T S^-1
        m = m_pred + K @ (y - H @ m_pred)
        P = _sym(P_pred - K @ S @ K.T)
        return (A @ m, _sym(A @ P @ A.T + Q)), (m, P, ll)

    _, (ms, Ps, lls) = jax.lax.scan(step, (params.mu0, params.P0), ys)
    return {"means": ms, "covs": Ps, "log_ml": jnp.sum(lls),
            "step_log_liks": lls}


@jax.jit
def kalman_smoother(params, ys):
    """Sequential RTS smoother. Returns smoothed means/covs + filter output."""
    A, Q = params.A, params.Q
    filt = kalman_filter(params, ys)
    ms, Ps = filt["means"], filt["covs"]

    def step(carry, inp):
        ms_next, Ps_next = carry
        m, P = inp
        P_pred = _sym(A @ P @ A.T + Q)
        G = _solve_psd(P_pred, A @ P).T                   # P A^T P_pred^-1
        m_s = m + G @ (ms_next - A @ m)
        P_s = _sym(P + G @ (Ps_next - P_pred) @ G.T)
        return (m_s, P_s), (m_s, P_s)

    (mT, PT) = (ms[-1], Ps[-1])
    _, (ms_s, Ps_s) = jax.lax.scan(step, (mT, PT), (ms[:-1], Ps[:-1]),
                                   reverse=True)
    ms_s = jnp.concatenate([ms_s, mT[None]], axis=0)
    Ps_s = jnp.concatenate([Ps_s, PT[None]], axis=0)
    return {"means": ms_s, "covs": Ps_s, **{f"filtered_{k}": v
                                            for k, v in filt.items()}}


# ---------------------------------------------------------------------------
# Time-parallel filter (associative scan, O(log T) depth)
# ---------------------------------------------------------------------------

def _filter_elements(params, ys):
    """Per-step conditional-Gaussian elements (A_k, b_k, C_k, eta_k, J_k).

    Element k parameterizes p(x_k | y_{1:k}, x_{k-1}); composing elements
    under the operator below is associative, so the prefix compositions —
    the filtering distributions — are an associative scan (Särkkä &
    García-Fernández 2021, Lemmas 7-8).
    """
    A, Q, H, R = params.A, params.Q, params.H, params.R
    D = A.shape[-1]
    I = jnp.eye(D, dtype=A.dtype)

    # generic step k >= 2: predictive cov given x_{k-1} is Q
    S = _sym(H @ Q @ H.T + R)
    K = _solve_psd(S, H @ Q).T                            # Q H^T S^-1
    HtSinv = _solve_psd(S, H).T                           # H^T S^-1 (D_y solve)

    def generic(y):
        Ak = (I - K @ H) @ A
        bk = K @ y
        Ck = _sym((I - K @ H) @ Q)
        eta = A.T @ (HtSinv @ y)
        J = _sym(A.T @ HtSinv @ H @ A)
        return Ak, bk, Ck, eta, J

    As, bs, Cs, etas, Js = jax.vmap(generic)(ys)

    # first element: prior N(mu0, P0) conditioned on y_1 (no x_0 dependence)
    S1 = _sym(H @ params.P0 @ H.T + R)
    K1 = _solve_psd(S1, H @ params.P0).T
    m1 = params.mu0 + K1 @ (ys[0] - H @ params.mu0)
    P1 = _sym(params.P0 - K1 @ S1 @ K1.T)
    As = As.at[0].set(jnp.zeros_like(A))
    bs = bs.at[0].set(m1)
    Cs = Cs.at[0].set(P1)
    etas = etas.at[0].set(jnp.zeros(D, A.dtype))
    Js = Js.at[0].set(jnp.zeros((D, D), A.dtype))
    return As, bs, Cs, etas, Js


def _filter_combine(elem_i, elem_j):
    """Associative composition of filtering elements (i earlier, j later)."""
    Ai, bi, Ci, etai, Ji = elem_i
    Aj, bj, Cj, etaj, Jj = elem_j
    D = Ai.shape[-1]
    I = jnp.eye(D, dtype=Ai.dtype)
    # M = (I + C_i J_j)^{-1}; solves batched over the scan axis
    CJ = I + Ci @ Jj
    AjM = jnp.swapaxes(
        _solve_general(jnp.swapaxes(CJ, -1, -2), jnp.swapaxes(Aj, -1, -2)),
        -1, -2)                                           # A_j M
    JC = I + Jj @ Ci
    AiTN = jnp.swapaxes(
        _solve_general(jnp.swapaxes(JC, -1, -2), Ai), -1, -2)  # A_i^T N
    A_out = AjM @ Ai
    b_out = (AjM @ (bi[..., None] + Ci @ etaj[..., None]))[..., 0] + bj
    C_out = _sym(AjM @ Ci @ jnp.swapaxes(Aj, -1, -2) + Cj)
    eta_out = (AiTN @ (etaj[..., None] - Jj @ bi[..., None]))[..., 0] + etai
    J_out = _sym(AiTN @ Jj @ Ai + Ji)
    return A_out, b_out, C_out, eta_out, J_out


@jax.jit
def kalman_filter_parallel(params, ys):
    """Time-parallel Kalman filter via ``jax.lax.associative_scan``.

    O(log T) sequential depth over the time axis — the whole filter runs as
    ~2 log2(T) batched (T, D, D) matmul rounds instead of T
    serial small-matrix steps. Output matches :func:`kalman_filter` to
    floating-point tolerance, including ``log_ml``.
    """
    elems = _filter_elements(params, ys)
    _, ms, Ps, _, _ = jax.lax.associative_scan(_filter_combine, elems)

    # log-ML from one-step predictives, vectorized over t after the scan:
    # t=1 uses the prior; t>=2 uses filtered (m_{t-1}, P_{t-1}).
    A, Q, H, R = params.A, params.Q, params.H, params.R
    m_pred = jnp.concatenate(
        [params.mu0[None], (ms[:-1] @ A.T)], axis=0)
    P_pred = jnp.concatenate(
        [params.P0[None], _sym(A @ Ps[:-1] @ A.T + Q)], axis=0)
    S = _sym(jnp.einsum("ij,tjk,lk->til", H, P_pred, H) + R)
    lls = _mvn_logpdf(ys, (m_pred @ H.T), S)
    return {"means": ms, "covs": Ps, "log_ml": jnp.sum(lls),
            "step_log_liks": lls}


# ---------------------------------------------------------------------------
# Time-parallel smoother (reverse associative scan)
# ---------------------------------------------------------------------------

def _smoother_elements(params, ms, Ps):
    """Per-step smoothing elements (E_k, g_k, L_k) from filtered moments."""
    A, Q = params.A, params.Q

    def generic(m, P):
        P_pred = _sym(A @ P @ A.T + Q)
        E = _solve_psd(P_pred, A @ P).T                   # P A^T P_pred^-1
        g = m - E @ (A @ m)
        L = _sym(P - E @ P_pred @ E.T)
        return E, g, L

    Es, gs, Ls = jax.vmap(generic)(ms, Ps)
    # last element carries the filtered marginal itself
    Es = Es.at[-1].set(jnp.zeros_like(A))
    gs = gs.at[-1].set(ms[-1])
    Ls = Ls.at[-1].set(Ps[-1])
    return Es, gs, Ls


def _smoother_combine(later, earlier):
    """Affine-map composition f_earlier ∘ f_later, f_k(x) = E_k x + g_k.

    Under ``associative_scan(..., reverse=True)`` the FIRST operand is the
    composite of later-time elements and the SECOND the earlier element,
    which must sit on the outside (earliest E leftmost)."""
    Ea, ga, La = later
    Eb, gb, Lb = earlier
    E_out = Eb @ Ea
    g_out = (Eb @ ga[..., None])[..., 0] + gb
    L_out = _sym(Eb @ La @ jnp.swapaxes(Eb, -1, -2) + Lb)
    return E_out, g_out, L_out


@jax.jit
def kalman_smoother_parallel(params, ys):
    """Time-parallel RTS smoother: parallel filter + reverse associative scan."""
    filt = kalman_filter_parallel(params, ys)
    elems = _smoother_elements(params, filt["means"], filt["covs"])
    _, gs, Ls = jax.lax.associative_scan(_smoother_combine, elems,
                                         reverse=True)
    return {"means": gs, "covs": Ls,
            **{f"filtered_{k}": v for k, v in filt.items()}}
