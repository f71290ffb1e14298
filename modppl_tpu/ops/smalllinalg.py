"""Custom-call-free linear algebra for small static dimensions.

The reference's mvnormal does its algebra on 2-6 dimensional matrices
(modppl/src/modeling/dists/mvnormal.rs:14-35, nalgebra on the CPU).
``jnp.linalg.cholesky`` / ``triangular_solve`` lower to XLA *custom calls*
(cuSOLVER / cuBLAS on a GPU), which cannot fuse with their neighbours and
are launched separately — inside a ``lax.scan`` body, once per segment.
For the small fixed dims a PPL actually uses, unrolled
Cholesky-Banachiewicz / forward-backward substitution in plain jnp
elementwise ops is exact, differentiable, batchable, and fuses into the
surrounding program like any other arithmetic.

All functions take the matrix dimension from the *static* trailing shape and
unroll O(k^2)..O(k^3) scalar-slot expressions; they broadcast over arbitrary
leading batch axes. Intended for k <= SMALL_DIM_MAX (above that, call the
stock ``jnp.linalg`` path — at those sizes the custom call is worth its
latency).
"""

import jax.numpy as jnp

# Above this the unrolled expression graph stops being worth it and
# jnp.linalg's custom calls win; 32 unrolls ~5k scalar slots for cholesky.
# The crossover is not yet measured on a GPU (ROADMAP R3).
SMALL_DIM_MAX = 32


def cholesky_small(a):
    """Lower-Cholesky of PSD ``a`` (..., k, k) by unrolled Banachiewicz.

    Bit-for-bit the classic algorithm: L[i,j] = (a[i,j] - sum_m<j L[i,m]
    L[j,m]) / L[j,j]; L[i,i] = sqrt(a[i,i] - sum L[i,m]^2). Non-PD inputs
    produce NaNs (matching ``jnp.linalg.cholesky``'s NaN convention, which
    the eager non-PD fallback in dists/mvnormal.py checks for).
    """
    k = a.shape[-1]
    zero = jnp.zeros_like(a[..., 0, 0])
    L = [[zero] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = a[..., i, j]
            for m in range(j):
                s = s - L[i][m] * L[j][m]
            L[i][j] = jnp.sqrt(s) if i == j else s / L[j][j]
    rows = [jnp.stack(L[i], axis=-1) for i in range(k)]
    return jnp.stack(rows, axis=-2)


def solve_lower_small(L, b):
    """Solve L z = b by unrolled forward substitution.

    ``L``: (..., k, k) lower-triangular; ``b``: (..., k). Broadcasts over
    batch axes of either operand.
    """
    k = L.shape[-1]
    z = []
    for i in range(k):
        s = b[..., i]
        for m in range(i):
            s = s - L[..., i, m] * z[m]
        z.append(s / L[..., i, i])
    return jnp.stack(z, axis=-1)


def solve_upper_small(U, b):
    """Solve U z = b by unrolled backward substitution (U upper-triangular)."""
    k = U.shape[-1]
    z = [None] * k
    for i in range(k - 1, -1, -1):
        s = b[..., i]
        for m in range(i + 1, k):
            s = s - U[..., i, m] * z[m]
        z[i] = s / U[..., i, i]
    return jnp.stack(z, axis=-1)


def solve_psd_small(S, B):
    """Solve S X = B for symmetric-PD ``S`` via unrolled Cholesky.

    ``S``: (..., k, k); ``B``: (..., k) or (..., k, m). Column-wise
    forward/backward substitution against the unrolled factor — the
    custom-call-free counterpart of ``cho_solve`` for static k <=
    SMALL_DIM_MAX (used by inference/kalman.py inside scan bodies, where a
    ``jnp.linalg.cholesky`` custom call would not fuse).
    """
    L = cholesky_small(S)
    Lt = jnp.swapaxes(L, -1, -2)
    if B.ndim == S.ndim - 1:          # vector RHS
        return solve_upper_small(Lt, solve_lower_small(L, B))
    cols = [solve_upper_small(Lt, solve_lower_small(L, B[..., :, j]))
            for j in range(B.shape[-1])]
    return jnp.stack(cols, axis=-1)


def lu_solve_small(A, B):
    """Solve general A X = B by unrolled LU with partial pivoting.

    ``A``: (..., k, k); ``B``: (..., k, m). Pivoting is a bubble pass of
    ``where``-selected row swaps (after comparing row i against each row
    j > i, row i holds the max-|pivot| row), so the whole solve is branch-
    free elementwise arithmetic — batchable, differentiable, custom-call
    free. O(k^2) selects + O(k^3) FLOPs unrolled: intended for small k
    (inference/kalman.py uses it for the parallel-filter combine at
    k <= 8); above that ``jnp.linalg.solve``'s LU custom call wins.
    """
    k = A.shape[-1]
    arows = [A[..., i, :] for i in range(k)]
    brows = [B[..., i, :] for i in range(k)]
    for i in range(k):
        for j in range(i + 1, k):
            c = (jnp.abs(arows[j][..., i])
                 > jnp.abs(arows[i][..., i]))[..., None]
            arows[i], arows[j] = (jnp.where(c, arows[j], arows[i]),
                                  jnp.where(c, arows[i], arows[j]))
            brows[i], brows[j] = (jnp.where(c, brows[j], brows[i]),
                                  jnp.where(c, brows[i], brows[j]))
        inv = 1.0 / arows[i][..., i]
        for j in range(i + 1, k):
            f = (arows[j][..., i] * inv)[..., None]
            arows[j] = arows[j] - f * arows[i]
            brows[j] = brows[j] - f * brows[i]
    xrows = [None] * k
    for i in range(k - 1, -1, -1):
        s = brows[i]
        for j in range(i + 1, k):
            s = s - arows[i][..., j: j + 1] * xrows[j]
        xrows[i] = s / arows[i][..., i: i + 1]
    return jnp.stack(xrows, axis=-2)


def matvec_small(m, v):
    """(..., k, k) @ (..., k) as a broadcast-multiply-sum.

    A dot_general with a tiny contracting dim over a huge batch wastes a
    matrix unit's tile on padding; the equivalent elementwise form fuses
    with its neighbours.
    """
    return jnp.sum(m * v[..., None, :], axis=-1)


def tril_logdet_small(L):
    """log |det| of a triangular factor: sum of log |diag|."""
    k = L.shape[-1]
    acc = jnp.log(jnp.abs(L[..., 0, 0]))
    for i in range(1, k):
        acc = acc + jnp.log(jnp.abs(L[..., i, i]))
    return acc
