"""Sharded Stage-B execution over a device mesh (SURVEY.md 2.3, config 5).

Multi-stream data parallelism: S independent streams' frame plans are padded
to common shapes, stacked on a leading 'stream' axis, and executed with one
shard_map -- each device runs the identical compiled wavefront program on its
local stream.  Output is REQUIRED to be bit-exact vs the unsharded path
(determinism is the sanitizer, SURVEY.md 5).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from p265_tpu.kernels.itransform import batch_residual
from p265_tpu.pipeline.wavefront import GUARD, _pow2, _run_plane, _stack_plane

_FIELDS = ("pos", "ref_ys", "ref_xs", "ref_ok", "mode", "filter_flag",
           "strong_allowed", "inter", "dc_edge")
_FILL = {"pos": 0, "ref_ys": 0, "ref_xs": 0, "ref_ok": False, "mode": 1,
         "filter_flag": False, "strong_allowed": False, "inter": False,
         "dc_edge": False}


def _pad_stream_plane(pp, sizes, n_steps, caps, use_mxu):
    """Stacked step tensors + residuals for one stream's plane, padded to the
    fleet-common (sizes, n_steps, caps)."""
    ph, pw = pp.shape
    own_steps, own = (_stack_plane(pp) if pp.batches
                      else (0, {}))
    stacked = {}
    residuals = {}
    for log2 in sizes:
        size = 1 << log2
        cap = caps[log2]
        nref2 = 2 * (2 * size + 1)
        tails = {"pos": (2,), "ref_ys": (nref2,), "ref_xs": (nref2,),
                 "ref_ok": (nref2,), "mode": (), "filter_flag": (),
                 "strong_allowed": (), "inter": (), "dc_edge": ()}
        d = own.get(log2)
        out = {}
        for f in _FIELDS:
            dt = (bool if f in ("ref_ok", "filter_flag", "strong_allowed",
                                "inter", "dc_edge") else np.int32)
            a = np.full((n_steps, cap) + tails[f], _FILL[f], dt)
            if d is not None:
                # expand compact per-TU rows (with pad row at index n) via
                # the bucket's step gather map
                src = d[f].astype(dt)[d["idx_map"]]
                a[:src.shape[0], :src.shape[1]] = src
            out[f] = a
        # pads scatter into guard: rows beyond real data
        mask = np.zeros((n_steps, cap), bool)
        if d is not None:
            mask[:d["idx_map"].shape[0], :d["idx_map"].shape[1]] = True
            # real pads inside own region already point at (ph, 0)
        out["pos"][~mask] = (ph, 0)
        stacked[log2] = out
        res = np.zeros((n_steps, cap, size, size), np.int32)
        if d is not None and log2 in pp.batches:
            b = pp.batches[log2]
            sm = None if b.scale_m is None else jnp.asarray(b.scale_m)
            r = np.asarray(batch_residual(
                jnp.asarray(b.coeffs), jnp.asarray(b.qp),
                jnp.asarray(b.is_dst), jnp.asarray(b.tskip), log2, use_mxu,
                bypass=jnp.asarray(b.bypass), scale_m=sm))
            rp = np.concatenate([r, np.zeros((1,) + r.shape[1:], r.dtype)])
            got = rp[d["idx_map"][:, :]]
            got = np.where((d["idx_map"] < len(b.step))[..., None, None],
                           got, 0)
            res[:got.shape[0], :got.shape[1]] = got
        residuals[log2] = res
    pred = np.zeros((ph, pw), np.int32)
    if pp.inter_pred is not None:
        pred[:] = pp.inter_pred
    return stacked, residuals, pred


def sharded_multistream_recon(tplans: list, mesh: Mesh, axis: str = "stream",
                              use_mxu: bool = True):
    """One frame plan per stream; len(tplans) must equal the axis size.

    Returns per-stream [y, cb, cr] planes, bit-exact vs the unsharded scan.
    """
    n_dev = mesh.shape[axis]
    assert len(tplans) == n_dev, (len(tplans), n_dev)
    per_plane_inputs = []
    for p_idx in range(3):
        pps_ = [tp.planes[p_idx] for tp in tplans]
        shape = pps_[0].shape
        sizes = tuple(sorted({log2 for pp in pps_ for log2 in pp.batches}))
        n_steps = 8
        caps = {}
        for pp in pps_:
            if pp.batches:
                ns, st = _stack_plane(pp)
                n_steps = max(n_steps, ns)
                for log2, d in st.items():
                    caps[log2] = max(caps.get(log2, 8),
                                     d["idx_map"].shape[1])
        for log2 in sizes:
            caps.setdefault(log2, 8)
        streams = [_pad_stream_plane(pp, sizes, n_steps, caps, use_mxu)
                   for pp in pps_]
        stacked = jax.tree.map(lambda *xs: np.stack(xs),
                               *[s for s, _, _ in streams])
        residuals = jax.tree.map(lambda *xs: np.stack(xs),
                                 *[r for _, r, _ in streams])
        preds = np.stack([p for _, _, p in streams])
        per_plane_inputs.append((stacked, residuals, preds, shape, sizes))

    spec_leaf = P(axis)

    def body(*flat):
        # local shard: leading stream dim == 1 per device (S == N); avoid
        # a vmap-of-scan by squeezing it
        it = iter(flat)
        outs = []
        for (_, _, _, shape, sizes) in per_plane_inputs:
            stacked = jax.tree.map(lambda a: a[0], next(it))
            residuals = jax.tree.map(lambda a: a[0], next(it))
            pred = next(it)[0]
            c_idx = min(len(outs), 1)
            out = _run_plane.__wrapped__(stacked, residuals, sizes, c_idx,
                                         shape, pred)
            outs.append(out[None])
        return tuple(outs)

    flat_in = []
    for (stacked, residuals, preds, _, _) in per_plane_inputs:
        flat_in += [jax.tree.map(jnp.asarray, stacked),
                    jax.tree.map(jnp.asarray, residuals),
                    jnp.asarray(preds)]
    in_specs = tuple(jax.tree.map(lambda _: spec_leaf, x,
                                  is_leaf=lambda l: hasattr(l, "shape"))
                     if not isinstance(x, jnp.ndarray) else spec_leaf
                     for x in flat_in)
    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=in_specs,
                       out_specs=(spec_leaf,) * 3,
                       check_vma=False)
    outs = jax.jit(fn)(*flat_in)
    results = []
    for s_idx in range(n_dev):
        results.append([np.asarray(outs[p][s_idx]) for p in range(3)])
    return results
