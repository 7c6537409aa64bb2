"""Batched closed-form small-matrix algebra.

The reference leans on np.linalg.inv for 2x2/3x3 matrices inside per-node
Python loops (clustering.py:20,91-105; helper.py:384).  Here those become
closed-form cofactor expressions vectorised over the edge axis — pure
elementwise math with no dynamic shapes, which XLA fuses into the
surrounding kernels.  All functions broadcast over arbitrary leading axes.

Batched tiny matrix products are written as explicit component slices +
elementwise math, never einsum/dot_general: a 3-wide contraction would
go to a matrix unit that it cannot fill (and, in float32 on the GPU,
would round through TF32).
"""

from __future__ import annotations

import jax.numpy as jnp


def tiny(dtype):
    """Smallest safe positive guard constant for the dtype (1e-300
    underflows to 0 in float32, defeating division guards)."""
    return jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)


def det2(m):
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv2(m):
    """Closed-form inverse of (..., 2, 2)."""
    d = det2(m)
    inv = jnp.stack([
        jnp.stack([m[..., 1, 1], -m[..., 0, 1]], axis=-1),
        jnp.stack([-m[..., 1, 0], m[..., 0, 0]], axis=-1),
    ], axis=-2)
    return inv / d[..., None, None]


def mat2_vec(m, v):
    """(..., 2, 2) @ (..., 2) -> (..., 2) (componentwise; see module doc)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    v0, v1 = v[..., 0], v[..., 1]
    return jnp.stack([a * v0 + b * v1, c * v0 + d * v1], axis=-1)


def sandwich2(f, c):
    """F C F^T for (..., 2, 2) operands (componentwise)."""
    f00, f01 = f[..., 0, 0], f[..., 0, 1]
    f10, f11 = f[..., 1, 0], f[..., 1, 1]
    c00, c01 = c[..., 0, 0], c[..., 0, 1]
    c10, c11 = c[..., 1, 0], c[..., 1, 1]
    # rows of f @ c
    m00 = f00 * c00 + f01 * c10
    m01 = f00 * c01 + f01 * c11
    m10 = f10 * c00 + f11 * c10
    m11 = f10 * c01 + f11 * c11
    return jnp.stack([
        jnp.stack([m00 * f00 + m01 * f01, m00 * f10 + m01 * f11], axis=-1),
        jnp.stack([m10 * f00 + m11 * f01, m10 * f10 + m11 * f11], axis=-1),
    ], axis=-2)


def det3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adj3(m):
    """Adjugate (transposed cofactor matrix) of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    row0 = jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], axis=-1)
    row1 = jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], axis=-1)
    row2 = jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def inv3(m):
    """Closed-form inverse of (..., 3, 3)."""
    return adj3(m) / det3(m)[..., None, None]


def unpack3(m):
    """(..., 3, 3) -> row-major 9-tuple of (...,) components."""
    return tuple(m[..., i, j] for i in range(3) for j in range(3))


def pack3(c):
    """Row-major 9-tuple -> (..., 3, 3)."""
    rows = [jnp.stack(c[3 * i:3 * i + 3], axis=-1) for i in range(3)]
    return jnp.stack(rows, axis=-2)


def _matmul3_c(a, b):
    """Componentwise 9-tuple matmul a @ b."""
    return tuple(
        a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3) for j in range(3))


def mat3_vec(m, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    c = unpack3(m)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([
        c[0] * v0 + c[1] * v1 + c[2] * v2,
        c[3] * v0 + c[4] * v1 + c[5] * v2,
        c[6] * v0 + c[7] * v1 + c[8] * v2,
    ], axis=-1)


def mat3_mat(a, b):
    """(..., 3, 3) @ (..., 3, 3)."""
    return pack3(_matmul3_c(unpack3(a), unpack3(b)))


def sandwich3(f, c):
    """F C F^T for (..., 3, 3) operands."""
    fc_ = unpack3(f)
    fcm = _matmul3_c(fc_, unpack3(c))
    # (f c) f^T: out[i, j] = sum_k fc[i, k] * f[j, k]
    return pack3(tuple(
        fcm[3 * i] * fc_[3 * j] + fcm[3 * i + 1] * fc_[3 * j + 1]
        + fcm[3 * i + 2] * fc_[3 * j + 2]
        for i in range(3) for j in range(3)))


def merge_gaussians(mean1, cov1, mean2, cov2):
    """Inverse-variance-weighted merge of two 3D Gaussians.

    Multivariate inverse-variance weighting as in clustering.py:97-105 and
    extrapolate_merged_states.py:15-23:
      C = (C1^-1 + C2^-1)^-1,  mu = C (C1^-1 mu1 + C2^-1 mu2).
    """
    i1 = inv3(cov1)
    i2 = inv3(cov2)
    merged_cov = inv3(i1 + i2)
    merged_mean = mat3_vec(merged_cov, mat3_vec(i1, mean1) + mat3_vec(i2, mean2))
    return merged_mean, merged_cov


def kl_distance(mean1, cov1, mean2, cov2, bug_compat: bool = True):
    """Symmetrised KL-style distance between two 3D Gaussians.

    Reference: clustering.py:90-94.  NOTE the reference computes
    ``np.trace((cov1 - cov2) * (inv2 - inv1))`` with ELEMENTWISE ``*`` on
    ndarray operands, so the trace sums the elementwise product's diagonal
    rather than a matrix product's.  bug_compat=True reproduces that;
    False uses the proper matrix-product trace.
    """
    i1 = inv3(cov1)
    i2 = inv3(cov2)
    dc = unpack3(cov1 - cov2)
    di = unpack3(i2 - i1)
    if bug_compat:
        trace = dc[0] * di[0] + dc[4] * di[4] + dc[8] * di[8]
    else:
        trace = sum(dc[3 * i + j] * di[3 * j + i]
                    for i in range(3) for j in range(3))
    dm = mean1 - mean2
    s = unpack3(i1 + i2)
    d0, d1, d2 = dm[..., 0], dm[..., 1], dm[..., 2]
    quad = (d0 * (s[0] * d0 + s[1] * d1 + s[2] * d2)
            + d1 * (s[3] * d0 + s[4] * d1 + s[5] * d2)
            + d2 * (s[6] * d0 + s[7] * d1 + s[8] * d2))
    return trace + quad
