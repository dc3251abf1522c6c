"""Batched device intra prediction (spec 8.4.4.2) over wavefront TU batches.

One jitted function per (size, batch_capacity): gathers reference samples via
plan-time coordinate tables (availability/substitution already resolved on the
host -- p265_tpu.plan.frame_plan), computes every mode family fully
vectorized (planar / DC / generic angular with per-TU angle), and selects with
masks.  No data-dependent control flow; all int32; bit-exact vs
p265_tpu.golden.intra.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from p265_tpu.tables import INTRA_ANGLE, INV_ANGLE

# per-mode host tables (static)
_ANGLE = np.zeros(35, np.int32)
_ANGLE[2:] = INTRA_ANGLE
_INV = np.zeros(35, np.int32)
_INV[11:26] = INV_ANGLE


def _filter_refs(left, top, size, filter_flag, strong_allowed):
    """[1 2 1] + strong smoothing, vectorized.  left/top: [n, 2s+1] int32."""
    n2 = 2 * size
    # [1 2 1]
    fl = left.at[:, 1:n2].set((left[:, 0:n2 - 1] + 2 * left[:, 1:n2]
                               + left[:, 2:n2 + 1] + 2) >> 2)
    ft = top.at[:, 1:n2].set((top[:, 0:n2 - 1] + 2 * top[:, 1:n2]
                              + top[:, 2:n2 + 1] + 2) >> 2)
    corner = (left[:, 1] + 2 * left[:, 0] + top[:, 1] + 2) >> 2
    fl = fl.at[:, 0].set(corner)
    ft = ft.at[:, 0].set(corner)
    if size == 32:
        thresh = 1 << 3  # 1 << (bit_depth - 5)
        flat_h = jnp.abs(top[:, 0] + top[:, n2] - 2 * top[:, size]) < thresh
        flat_v = jnp.abs(left[:, 0] + left[:, n2] - 2 * left[:, size]) < thresh
        strong = strong_allowed & flat_h & flat_v
        i = jnp.arange(n2 + 1, dtype=jnp.int32)[None, :]
        sl = ((n2 - i) * left[:, 0:1] + i * left[:, n2:n2 + 1] + size) >> 6
        st = ((n2 - i) * top[:, 0:1] + i * top[:, n2:n2 + 1] + size) >> 6
        sl = sl.at[:, 0].set(left[:, 0]).at[:, n2].set(left[:, n2])
        st = st.at[:, 0].set(top[:, 0]).at[:, n2].set(top[:, n2])
        fl = jnp.where(strong[:, None], sl, fl)
        ft = jnp.where(strong[:, None], st, ft)
    use = filter_flag[:, None]
    return jnp.where(use, fl, left), jnp.where(use, ft, top)


def _angular(main, side, angle, inv, size):
    """Generic angular prediction on the main reference.  main/side [n, 2s+1]
    (index 0 = corner); angle/inv [n].  Returns [n, s, s] in main-axis layout
    (rows = perpendicular coordinate)."""
    n = main.shape[0]
    s = size
    base = s
    # extended ref [n, 3s+2]: positions -s .. 2s+1
    ext = jnp.zeros((n, 3 * s + 2), jnp.int32)
    ext = ext.at[:, base:base + 2 * s + 1].set(main)
    # negative extension via inverse angle projection from the side array
    neg_i = jnp.arange(-s, 0, dtype=jnp.int32)[None, :]            # [-s..-1]
    side_idx = jnp.clip((neg_i * inv[:, None] + 128) >> 8, 0, 2 * s)
    ext = ext.at[:, 0:s].set(jnp.take_along_axis(side, side_idx, axis=1))
    y = jnp.arange(1, s + 1, dtype=jnp.int32)[None, :]             # [1..s]
    idx = (y * angle[:, None]) >> 5                                # [n, s]
    fact = (y * angle[:, None]) & 31
    x = jnp.arange(s, dtype=jnp.int32)
    i1 = base + x[None, None, :] + idx[:, :, None] + 1             # [n, s, s]
    i1 = jnp.clip(i1, 0, 3 * s)
    # gather via take_along_axis on [n, s*s]
    ii = i1.reshape(n, s * s)
    e0 = jnp.take_along_axis(ext, ii, axis=1).reshape(n, s, s)
    e1 = jnp.take_along_axis(ext, jnp.clip(ii + 1, 0, 3 * s + 1),
                             axis=1).reshape(n, s, s)
    pred = ((32 - fact)[:, :, None] * e0 + fact[:, :, None] * e1 + 16) >> 5
    return pred


@functools.partial(jax.jit, static_argnames=("size", "c_idx"))
def predict_values(plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
                   strong_allowed, residual, size: int, c_idx: int,
                   inter=None, pred_plane=None, dc_edge=None):
    """One wavefront step for one size bucket, WITHOUT the plane scatter.

    plane: [Hpad, W] int32 current recon (device)
    pos: [n, 2] (y, x); ref_*: [n, 2*(2s+1)]; mode: [n]; residual: [n, s, s]
    inter: [n] bool -> prediction gathered from pred_plane instead of intra.
    Returns (rows, cols, out): the reconstructed sample block per TU plus its
    scatter coordinates -- the caller merges all size buckets of a step into
    ONE flat scatter (4x fewer scatter ops per scan step; the scatter is the
    dominant per-step cost at 1080p, profiling/probe_scan_variants.py).
    """
    s = size
    nref = 2 * s + 1
    refs = jnp.where(ref_ok, plane[ref_ys, ref_xs], 128)
    left = refs[:, :nref]
    top = refs[:, nref:]
    if c_idx == 0:
        left, top = _filter_refs(left, top, s, filter_flag, strong_allowed)

    angle = jnp.asarray(_ANGLE)[mode]
    inv = jnp.asarray(_INV)[mode]
    is_vert = mode >= 18

    # vertical-family angular (main = top), horizontal-family (main = left)
    pv = _angular(top, left, angle, inv, s)
    ph = jnp.swapaxes(_angular(left, top, angle, inv, s), 1, 2)
    pred_ang = jnp.where(is_vert[:, None, None], pv, ph)

    # planar
    xg = jnp.arange(s, dtype=jnp.int32)[None, None, :]
    yg = jnp.arange(s, dtype=jnp.int32)[None, :, None]
    l_y = left[:, 1:s + 1][:, :, None]       # p[-1][y]
    t_x = top[:, 1:s + 1][:, None, :]        # p[x][-1]
    t_n = top[:, s + 1][:, None, None]       # p[N][-1]
    l_n = left[:, s + 1][:, None, None]      # p[-1][N]
    log2s = int(np.log2(s))
    planar = ((s - 1 - xg) * l_y + (xg + 1) * t_n
              + (s - 1 - yg) * t_x + (yg + 1) * l_n + s) >> (log2s + 1)

    # DC
    dc = (jnp.sum(left[:, 1:s + 1], axis=1) + jnp.sum(top[:, 1:s + 1], axis=1)
          + s) >> (log2s + 1)
    pred_dc = jnp.broadcast_to(dc[:, None, None], (mode.shape[0], s, s))
    if c_idx == 0 and s < 32:
        e = (jnp.ones_like(mode, bool) if dc_edge is None else dc_edge)[:, None]
        row0 = (top[:, 2:s + 1] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, 2:s + 1] + 3 * dc[:, None] + 2) >> 2
        corner = (left[:, 1] + 2 * dc + top[:, 1] + 2) >> 2
        pred_dc = pred_dc.at[:, 0, 1:].set(jnp.where(e, row0,
                                                     pred_dc[:, 0, 1:]))
        pred_dc = pred_dc.at[:, 1:, 0].set(jnp.where(e, col0,
                                                     pred_dc[:, 1:, 0]))
        pred_dc = pred_dc.at[:, 0, 0].set(jnp.where(e[:, 0], corner,
                                                    pred_dc[:, 0, 0]))

    pred = jnp.where((mode == 0)[:, None, None], planar,
                     jnp.where((mode == 1)[:, None, None], pred_dc, pred_ang))

    if c_idx == 0 and s < 32:
        edge = (jnp.ones_like(mode, bool) if dc_edge is None else dc_edge)
        # vertical (26) / horizontal (10) edge filters on unfiltered refs
        v_col = jnp.clip(top[:, 1][:, None]
                         + ((left[:, 1:s + 1] - left[:, 0][:, None]) >> 1),
                         0, 255)
        h_row = jnp.clip(left[:, 1][:, None]
                         + ((top[:, 1:s + 1] - top[:, 0][:, None]) >> 1),
                         0, 255)
        pred = jnp.where(((mode == 26) & edge)[:, None, None],
                         pred.at[:, :, 0].set(v_col), pred)
        pred = jnp.where(((mode == 10) & edge)[:, None, None],
                         pred.at[:, 0, :].set(h_row), pred)

    rows = pos[:, 0][:, None, None] + jnp.arange(s)[None, :, None]
    cols = pos[:, 1][:, None, None] + jnp.arange(s)[None, None, :]
    if inter is not None and pred_plane is not None:
        mc = pred_plane[rows, cols]
        pred = jnp.where(inter[:, None, None], mc, pred)
    out = jnp.clip(pred + residual, 0, 255)
    return rows, cols, out


@functools.partial(jax.jit, static_argnames=("size", "c_idx"))
def predict_batch(plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
                  strong_allowed, residual, size: int, c_idx: int,
                  inter=None, pred_plane=None, dc_edge=None):
    """predict_values + the plane scatter (single-bucket convenience)."""
    rows, cols, out = predict_values.__wrapped__(
        plane, pos, ref_ys, ref_xs, ref_ok, mode, filter_flag,
        strong_allowed, residual, size, c_idx, inter=inter,
        pred_plane=pred_plane, dc_edge=dc_edge)
    return plane.at[rows, cols].set(out)
