"""Matmul-formulated intra prediction: one matmul per wavefront step per bucket.

HEVC intra prediction (spec 8.4.4.2) is *linear* in the (filtered) reference
samples for every mode -- planar, DC interior, and all 33 angular modes are
fixed integer weight patterns over the left/top strips.  We precompute, per
(mode, size), an integer matrix A[s*s, 4s+3] acting on the vector
v = [left(0..2s), top(0..2s), 1] such that

    pred = (A @ v) >> shift        (shift = 5 for s<=16, 6 for s=32)

is bit-exact with the sequential spec arithmetic: every rounding constant is
folded into the constant column (no global rounding term, so the floor
semantics compose exactly; see the per-mode scaling notes inline).  The only
non-linear pieces -- the [1 2 1]/strong reference smoothing (data-dependent
decision), the DC/vertical/horizontal edge filters (nested floors + clip),
and the MC-pred substitution -- stay as cheap vector ops.

This replaces ~60 vector ops (incl. 4 take_along_axis gathers) per step per
bucket in kernels/intra.py with: 1 ref gather + filter + 1 table gather +
1 matmul + edge patches + 1 scatter.  The matmul runs in bfloat16 with f32
accumulation: all |A| entries <= 128 and refs <= 255 are exactly
representable, and row sums <= 96 bound the f32 accumulator below 2^15, so
the result is exact.

Bit-exactness vs kernels/intra.py and the golden decoder is enforced by
tests/test_intra_mxu.py.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from p265_tpu.kernels.intra import _filter_refs
from p265_tpu.tables import INTRA_ANGLE, INV_ANGLE

_ANGLE = np.zeros(35, np.int64)
_ANGLE[2:] = INTRA_ANGLE
_INV = np.zeros(35, np.int64)
_INV[11:26] = INV_ANGLE


def _angular_ext_weights(s: int, angle: int, k: int) -> np.ndarray:
    """Weights over the extended reference (positions 0..3s+1, base=s) for
    one angular mode, in main-axis layout [s*s(y-major), 3s+2].  Mirrors
    kernels/intra.py _angular exactly (incl. its clip behavior)."""
    base = s
    W = np.zeros((s * s, 3 * s + 2), np.int64)
    for y in range(1, s + 1):
        idx = (y * angle) >> 5
        fact = (y * angle) & 31
        for x in range(s):
            i1 = min(max(base + x + idx + 1, 0), 3 * s)
            i2 = min(i1 + 1, 3 * s + 1)
            r = (y - 1) * s + x
            W[r, i1] += (32 - fact) * k
            W[r, i2] += fact * k
    return W


def _ext_to_v(s: int, inv: int, main_off: int, side_off: int) -> np.ndarray:
    """Map extended-ref positions to v entries.  ext[base+j] = main[j]
    (j=0..2s); ext[0..s-1] = side[side_idx] via inverse-angle projection;
    ext[base+2s+1..] are never weighted (checked by construction)."""
    base = s
    E = np.zeros((3 * s + 2, 4 * s + 3), np.int64)
    for j in range(2 * s + 1):
        E[base + j, main_off + j] = 1
    for i in range(s):
        neg_i = i - s
        side_idx = min(max((neg_i * inv + 128) >> 8, 0), 2 * s)
        E[i, side_off + side_idx] = 1
    return E


@functools.lru_cache()
def _a_table(size: int) -> np.ndarray:
    """[35, s*s, 4s+3] int16 prediction matrices.  v = [left, top, 1]."""
    s = size
    R = 4 * s + 3
    shift = 6 if s == 32 else 5
    k = 1 << (shift - 5)              # angular scale
    log2s = int(np.log2(s))
    kp = 1 << (shift - log2s - 1)     # planar/DC scale
    L, T, C = 0, 2 * s + 1, 4 * s + 2
    A = np.zeros((35, s * s, R), np.int64)

    # mode 0: planar -- pred[y,x] = ((s-1-x)*left[1+y] + (x+1)*top[s+1]
    #   + (s-1-y)*top[1+x] + (y+1)*left[s+1] + s) >> (log2s+1)
    for y in range(s):
        for x in range(s):
            r = y * s + x
            A[0, r, L + 1 + y] += (s - 1 - x) * kp
            A[0, r, T + s + 1] += (x + 1) * kp
            A[0, r, T + 1 + x] += (s - 1 - y) * kp
            A[0, r, L + s + 1] += (y + 1) * kp
            A[0, r, C] += s * kp

    # mode 1: DC interior -- dc = (sum(left[1..s]) + sum(top[1..s]) + s)
    #   >> (log2s+1); edges patched at runtime (luma s<32)
    for j in range(1, s + 1):
        A[1, :, L + j] = kp
        A[1, :, T + j] = kp
    A[1, :, C] = s * kp

    # modes 2..34: angular.  vertical family (>=18): main=top, side=left,
    # output in [y,x] order; horizontal: main=left, side=top, transposed.
    for m in range(2, 35):
        angle, inv = int(_ANGLE[m]), int(_INV[m])
        W = _angular_ext_weights(s, angle, k)
        if m >= 18:
            E = _ext_to_v(s, inv, main_off=T, side_off=L)
            Am = W @ E
        else:
            E = _ext_to_v(s, inv, main_off=L, side_off=T)
            At = W @ E                       # [y-major over main=left axis]
            Am = At.reshape(s, s, R).transpose(1, 0, 2).reshape(s * s, R)
        Am[:, C] += 16 * k                   # angular rounding constant
        A[m] = Am

    assert np.abs(A).max() <= 128 and A.min() >= 0
    # row sums (<=96) bound the f32 accumulation to <2^15: exact in bf16
    assert A.sum(axis=2).max() <= 96
    return A.astype(np.int16)


@functools.lru_cache()
def _a_bf16(size: int) -> np.ndarray:
    """Host bf16 table (entries <=128: exactly representable).  Kept as a
    NumPy array so using it inside a jit trace is a constant, not a leaked
    tracer."""
    import ml_dtypes
    return _a_table(size).astype(ml_dtypes.bfloat16)


@functools.partial(jax.jit, static_argnames=("size", "c_idx"))
def predict_values_mxu(plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
                       strong_allowed, residual, size: int, c_idx: int,
                       inter=None, pred_plane=None, dc_edge=None):
    """kernels/intra.predict_values with the MXU matmul formulation: returns
    (rows, cols, out) so the caller can merge all buckets of a wavefront
    step into one flat scatter.

    dc_edge: optional [n] bool -- per-TU gate for the luma DC/10/26 edge
    filters, enabling mixed luma+chroma batches (c_idx=0 with per-TU flags).
    Defaults to the static c_idx/size gate of the original kernel.
    """
    s = size
    nref = 2 * s + 1
    shift = 6 if s == 32 else 5
    refs = jnp.where(ref_ok, plane[ref_ys, ref_xs], 128)
    left = refs[:, :nref]
    top = refs[:, nref:]
    if c_idx == 0:
        left, top = _filter_refs(left, top, s, filter_flag, strong_allowed)

    n = mode.shape[0]
    ones = jnp.ones((n, 1), jnp.int32)
    v = jnp.concatenate([left, top, ones], axis=1)
    A = jnp.asarray(_a_bf16(s))[mode]             # [n, s*s, 4s+3]
    acc = jax.lax.dot_general(
        A, v.astype(jnp.bfloat16),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)       # exact: bounded integers
    pred = (acc.astype(jnp.int32) >> shift).reshape(n, s, s)

    if c_idx == 0 and s < 32:
        edge = (jnp.ones_like(mode, bool) if dc_edge is None else dc_edge)
        # DC edge filters: dc == any interior prediction sample (A row)
        dc = pred[:, 1, 1]
        row0 = (top[:, 2:s + 1] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, 2:s + 1] + 3 * dc[:, None] + 2) >> 2
        corner = (left[:, 1] + 2 * dc + top[:, 1] + 2) >> 2
        is_dc = ((mode == 1) & edge)[:, None]
        pred = pred.at[:, 0, 1:].set(jnp.where(is_dc, row0, pred[:, 0, 1:]))
        pred = pred.at[:, 1:, 0].set(jnp.where(is_dc, col0, pred[:, 1:, 0]))
        pred = pred.at[:, 0, 0].set(jnp.where(is_dc[:, 0], corner,
                                              pred[:, 0, 0]))
        # vertical (26) / horizontal (10) edge columns on unfiltered refs
        # (filter_flag is False for modes 10/26, so left/top are unfiltered)
        v_col = jnp.clip(top[:, 1][:, None]
                         + ((left[:, 1:s + 1] - left[:, 0][:, None]) >> 1),
                         0, 255)
        h_row = jnp.clip(left[:, 1][:, None]
                         + ((top[:, 1:s + 1] - top[:, 0][:, None]) >> 1),
                         0, 255)
        pred = pred.at[:, :, 0].set(jnp.where(((mode == 26) & edge)[:, None],
                                              v_col, pred[:, :, 0]))
        pred = pred.at[:, 0, :].set(jnp.where(((mode == 10) & edge)[:, None],
                                              h_row, pred[:, 0, :]))

    rows = pos[:, 0][:, None, None] + jnp.arange(s)[None, :, None]
    cols = pos[:, 1][:, None, None] + jnp.arange(s)[None, None, :]
    if inter is not None and pred_plane is not None:
        mc = pred_plane[rows, cols]
        pred = jnp.where(inter[:, None, None], mc, pred)
    out = jnp.clip(pred + residual, 0, 255)
    return rows, cols, out


@functools.partial(jax.jit, static_argnames=("size", "c_idx"))
def predict_batch_mxu(plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
                      strong_allowed, residual, size: int, c_idx: int,
                      inter=None, pred_plane=None, dc_edge=None):
    """Drop-in replacement for kernels/intra.predict_batch (same contract):
    predict_values_mxu + the plane scatter."""
    rows, cols, out = predict_values_mxu.__wrapped__(
        plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
        strong_allowed, residual, size, c_idx, inter=inter,
        pred_plane=pred_plane, dc_edge=dc_edge)
    return plane.at[rows, cols].set(out)
