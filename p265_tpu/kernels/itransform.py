"""Batched dequant + inverse transform on the device (spec 8.6.3/8.6.4).

Exact integer path: int32 arithmetic throughout (XLA int ops are exact, shifts
map directly -- SURVEY.md 7.1).  The limb path (use_mxu=True) decomposes the
int16 coefficients into 8-bit limbs so both stages run as bf16 matmuls with
f32 accumulation: every operand holds at most 8 significant bits and every
partial sum stays below 2^24, so the result is exact under any summation
order (and under TF32).  Tested bit-exact against the int32 path.

Golden oracle: p265_tpu.golden.transform.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from p265_tpu.tables import DCT, DST4, LEVEL_SCALE

BIT_DEPTH = 8


@functools.lru_cache(maxsize=None)
def _mats(log2: int) -> tuple[np.ndarray, np.ndarray]:
    n = 1 << log2
    dct = np.asarray(DCT[n], np.int32)
    dst = np.asarray(DST4 if n == 4 else DCT[n], np.int32)
    return dct, dst


def _dequant(levels: jnp.ndarray, qp: jnp.ndarray, log2: int,
             scale_m: jnp.ndarray | None = None) -> jnp.ndarray:
    """levels [n,s,s] int32, qp [n] -> int32 clamped to +-2^15.

    The spec formula ((c*16*ls << qp/6) + (1<<(bdShift-1))) >> bdShift needs 43
    bits; staged exactly in int32: X = c*16*ls (<= 2^25.2), then either a
    rounded right shift by (bdShift - qp/6) or a left shift by (qp/6 - bdShift)
    (result <= 2^28.2), which are algebraically identical on integers.
    """
    bd = BIT_DEPTH + log2 - 5
    e = (qp // 6)[:, None, None]
    ls = jnp.asarray(LEVEL_SCALE, jnp.int32)[qp % 6][:, None, None]
    if scale_m is None:
        x = levels * (16 * ls)                    # <= 2^25.2
    else:
        x = (levels * scale_m) * ls               # <= 2^29.2
    rsh = jnp.maximum(bd - e, 0)
    rnd = jnp.where(e < bd, 1 << jnp.maximum(bd - 1 - e, 0), 0)
    d_rs = (x + rnd) >> rsh                       # e <= bd cases (e==bd: x>>0)
    # left-shift branch: clamp first (any |x| > 2^15 saturates anyway) so the
    # shift cannot overflow int32 even with 255-valued scaling matrices
    x_c = jnp.clip(x, -(1 << 27), 1 << 27)
    d_ls = x_c << jnp.maximum(e - bd, 0)
    d = jnp.where(e > bd, d_ls, d_rs)
    return jnp.clip(d, -32768, 32767)


def _imatmul_exact(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact int32 batched matmul a[n,s,s] @ b[s,s] (or b.T @ a)."""
    return jax.lax.dot_general(
        a, b, dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)


def _imatmul_mxu(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact int matmul as bf16 matrix products: split a (int16 range) into
    8-bit limbs, multiply with f32 accumulation (all partials < 2^24)."""
    a_hi = (a >> 8).astype(jnp.bfloat16)            # [-128, 127]
    a_lo = (a & 0xFF).astype(jnp.bfloat16)          # [0, 255]
    bf = b.astype(jnp.bfloat16)                     # |b| <= 90
    hi = jax.lax.dot_general(a_hi, bf, (((2,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32)
    lo = jax.lax.dot_general(a_lo, bf, (((2,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32)
    return (hi.astype(jnp.int32) << 8) + lo.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("log2", "use_mxu"))
def batch_residual(levels: jnp.ndarray, qp: jnp.ndarray, is_dst: jnp.ndarray,
                   tskip: jnp.ndarray, log2: int, use_mxu: bool = True,
                   bypass: jnp.ndarray | None = None,
                   scale_m: jnp.ndarray | None = None) -> jnp.ndarray:
    """[n,s,s] quantized levels -> [n,s,s] int32 spatial residual, bit-exact."""
    d = _dequant(levels, qp, log2, scale_m)
    dct, dst = _mats(log2)
    mm = _imatmul_mxu if use_mxu else _imatmul_exact
    shift2 = 20 - BIT_DEPTH

    def itx(m):
        # stage 1: tmp = clip((m^T @ d + 64) >> 7): compute as (d^T @ m)^T
        t = mm(jnp.swapaxes(d, 1, 2), m)            # [n,s,s] = d^T @ m
        t = jnp.swapaxes(t, 1, 2)                   # m^T @ d
        t = jnp.clip((t + 64) >> 7, -32768, 32767)
        r = mm(t, m)                                # tmp @ m
        r = (r + (1 << (shift2 - 1))) >> shift2
        return jnp.clip(r, -32768, 32767)

    res = itx(dct)
    if log2 == 2:
        res_dst = itx(dst)
        res = jnp.where(is_dst[:, None, None], res_dst, res)
        # transform skip: r = (d << 7 + off) >> shift2 (flat dequant)
        d_flat = _dequant(levels, qp, log2) if scale_m is not None else d
        ts = (jnp.left_shift(d_flat, 7) + (1 << (shift2 - 1))) >> shift2
        ts = jnp.clip(ts, -32768, 32767)
        res = jnp.where(tskip[:, None, None], ts, res)
    if bypass is not None:
        res = jnp.where(bypass[:, None, None], levels, res)
    return res
