"""Measure device-scan variants at 1080p (the real warm-path wall, round 4).

Variants:
  base     -- production _scan_plane (4 buckets chained through the carry)
  merged   -- all buckets predict from the SAME input plane; ONE flat scatter
  u8       -- carry plane in uint8 (4x less scatter/gather traffic)
  steps    -- n_steps rounded to 128-multiple instead of pow2
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
import functools


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


from tools.make_streams import get_stream
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.plan.frame_plan import build_tensor_plan
from p265_tpu.pipeline.wavefront import (_merge_segments, _stack_plane,
                                         _expand, GUARD, _round_up, _pow2)
from p265_tpu.kernels.intra_mxu import predict_batch_mxu, _a_bf16, _filter_refs

name = sys.argv[1] if len(sys.argv) > 1 else "s1080"
data = get_stream(name)
g = GoldenDecoder().decode_stream(data)[0]
tp = build_tensor_plan(g.plan)
merged, offs = _merge_segments(list(tp.planes))
ph, pw = merged.shape
log("merged shape", merged.shape)


def build(n_steps_round):
    merged._stacked_cache = None
    n_steps, stacked = _stack_plane(merged)
    # restack with the requested step rounding
    real = merged.n_steps
    tgt = n_steps_round(real)
    log("steps: real", real, "->", tgt)
    # _stack_plane already rounded to x8; emulate by padding idx_map/counts
    out = {}
    for log2, d in stacked.items():
        im, cnt = d["idx_map"], d["counts"]
        n1 = d["pos"].shape[0]
        if im.shape[0] < tgt:
            im = np.concatenate([im, np.full((tgt - im.shape[0], im.shape[1]),
                                             n1 - 1, np.int32)])
            cnt = np.concatenate([cnt, np.zeros(tgt - cnt.shape[0], cnt.dtype)])
        else:
            im, cnt = im[:tgt], cnt[:tgt]
        out[log2] = dict(d, idx_map=im, counts=cnt)
    return tgt, out


def predict_only(plane32, d, log2):
    """predict_batch_mxu minus the scatter: returns (rows, cols, out)."""
    s = 1 << log2
    nref = 2 * s + 1
    shift = 6 if s == 32 else 5
    pos, ref_ys, ref_xs, ref_ok = d["pos"], d["ref_ys"], d["ref_xs"], d["ref_ok"]
    mode, filter_flag, strong_allowed = d["mode"], d["filter_flag"], d["strong_allowed"]
    residual, dc_edge = d["residual"], d["dc_edge"]
    refs = jnp.where(ref_ok, plane32[ref_ys, ref_xs], 128)
    left = refs[:, :nref]
    top = refs[:, nref:]
    left, top = _filter_refs(left, top, s, filter_flag, strong_allowed)
    n = mode.shape[0]
    ones = jnp.ones((n, 1), jnp.int32)
    v = jnp.concatenate([left, top, ones], axis=1)
    A = jnp.asarray(_a_bf16(s))[mode]
    acc = jax.lax.dot_general(
        A, v.astype(jnp.bfloat16),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    pred = (acc.astype(jnp.int32) >> shift).reshape(n, s, s)
    if s < 32:
        edge = d["dc_edge"]
        dc = pred[:, 1, 1]
        row0 = (top[:, 2:s + 1] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, 2:s + 1] + 3 * dc[:, None] + 2) >> 2
        corner = (left[:, 1] + 2 * dc + top[:, 1] + 2) >> 2
        is_dc = ((mode == 1) & edge)[:, None]
        pred = pred.at[:, 0, 1:].set(jnp.where(is_dc, row0, pred[:, 0, 1:]))
        pred = pred.at[:, 1:, 0].set(jnp.where(is_dc, col0, pred[:, 1:, 0]))
        pred = pred.at[:, 0, 0].set(jnp.where(is_dc[:, 0], corner, pred[:, 0, 0]))
        v_col = jnp.clip(top[:, 1][:, None]
                         + ((left[:, 1:s + 1] - left[:, 0][:, None]) >> 1), 0, 255)
        h_row = jnp.clip(left[:, 1][:, None]
                         + ((top[:, 1:s + 1] - top[:, 0][:, None]) >> 1), 0, 255)
        pred = pred.at[:, :, 0].set(jnp.where(((mode == 26) & edge)[:, None],
                                              v_col, pred[:, :, 0]))
        pred = pred.at[:, 0, :].set(jnp.where(((mode == 10) & edge)[:, None],
                                              h_row, pred[:, 0, :]))
    rows = pos[:, 0][:, None, None] + jnp.arange(s)[None, :, None]
    cols = pos[:, 1][:, None, None] + jnp.arange(s)[None, None, :]
    out = jnp.clip(pred + residual, 0, 255)
    return rows, cols, out


@functools.partial(jax.jit, static_argnames=("sizes", "shape", "variant"))
def scan_variant(tu, idx_maps, sizes, shape, variant):
    stacked = _expand(tu, idx_maps, sizes, True)
    ph, pw = shape
    u8 = "u8" in variant
    dt = jnp.uint8 if u8 else jnp.int32
    plane = jnp.zeros((ph + GUARD, pw), dt)

    def body_base(plane, step_data):
        for log2 in sizes:
            d = step_data[log2]
            p32 = plane.astype(jnp.int32) if u8 else plane
            rows, cols, out = predict_only(p32, d, log2)
            plane = plane.at[rows, cols].set(out.astype(dt))
        return plane, None

    def body_merged(plane, step_data):
        p32 = plane.astype(jnp.int32) if u8 else plane
        flat_idx, flat_val = [], []
        for log2 in sizes:
            if "nopred" in variant:
                d = step_data[log2]
                s_ = 1 << log2
                rows = d["pos"][:, 0][:, None, None] + jnp.arange(s_)[None, :, None]
                cols = d["pos"][:, 1][:, None, None] + jnp.arange(s_)[None, None, :]
                out = jnp.clip(d["residual"], 0, 255)
            elif "nomm" in variant:
                d = step_data[log2]
                s_ = 1 << log2
                nref = 2 * s_ + 1
                refs = jnp.where(d["ref_ok"], p32[d["ref_ys"], d["ref_xs"]], 128)
                rows = d["pos"][:, 0][:, None, None] + jnp.arange(s_)[None, :, None]
                cols = d["pos"][:, 1][:, None, None] + jnp.arange(s_)[None, None, :]
                out = jnp.clip(d["residual"] + refs[:, :1, None], 0, 255)
            else:
                rows, cols, out = predict_only(p32, step_data[log2], log2)
            flat_idx.append((rows * pw + cols).reshape(-1))
            flat_val.append(out.reshape(-1).astype(dt))
        if "row4" in variant:
            fi4, fv4 = [], []
            for fi_b, fv_b in zip(flat_idx, flat_val):
                fi4.append(fi_b.reshape(-1, 4)[:, 0] // 4)
                fv4.append(fv_b.reshape(-1, 4))
            fi = jnp.concatenate(fi4)
            fv = jnp.concatenate(fv4)
            plane = plane.reshape(-1, 4).at[fi].set(fv).reshape(plane.shape)
            return plane, None
        fi = jnp.concatenate(flat_idx)
        fv = jnp.concatenate(flat_val)
        if "hint" in variant:
            # pad lanes all hit the same guard position -> NOT unique; route
            # them to distinct guard slots first when hinting uniqueness
            plane = plane.reshape(-1).at[fi].set(
                fv, mode="promise_in_bounds").reshape(plane.shape)
        else:
            plane = plane.reshape(-1).at[fi].set(fv).reshape(plane.shape)
        return plane, None

    body = body_merged if "merged" in variant else body_base
    plane, _ = jax.lax.scan(body, plane, stacked)
    return plane[:ph].astype(jnp.int32)


tgt, stacked = build(lambda n: _pow2(n, lo=8))
sizes = tuple(sorted(merged.batches.keys()))
tu = {log2: {k: v for k, v in d.items() if k not in ("idx_map", "okc", "pos4")}
      for log2, d in stacked.items()}
idx_maps = {log2: jnp.asarray(d["idx_map"]) for log2, d in stacked.items()}
tuj = {log2: {k: jnp.asarray(v) for k, v in d.items()} for log2, d in tu.items()}
jax.block_until_ready((tuj, idx_maps))

ref = None
for variant in ():
    t0 = time.perf_counter()
    out = jax.block_until_ready(scan_variant(tuj, idx_maps, sizes,
                                             merged.shape, variant))
    ct = time.perf_counter() - t0
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        out = scan_variant(tuj, idx_maps, sizes, merged.shape, variant)
        np.asarray(out[:1, :1])   # wait for the device
        best = min(best, time.perf_counter() - t0)
    if ref is None:
        ref = np.asarray(out)
        h, w = g.prefilter[0].shape
        ok = np.array_equal(ref[:h, :w], g.prefilter[0])
    else:
        ok = np.array_equal(np.asarray(out), ref)
    log(f"{variant:10s} compile {ct:6.1f}s  warm {best*1e3:8.1f} ms  "
        f"bit-exact={ok}")

# steps variant: 128-multiple trip count on the best body
tgt2, stacked2 = build(lambda n: _round_up(n, 128))
tu2 = {log2: {k: jnp.asarray(v) for k, v in d.items()
              if k not in ("idx_map", "okc", "pos4")}
       for log2, d in stacked2.items()}
idx2 = {log2: jnp.asarray(d["idx_map"]) for log2, d in stacked2.items()}
jax.block_until_ready((tu2, idx2))
for variant in ("merged_row4", "merged_nopred_row4"):
    t0 = time.perf_counter()
    out = jax.block_until_ready(scan_variant(tu2, idx2, sizes,
                                             merged.shape, variant))
    ct = time.perf_counter() - t0
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        out = scan_variant(tu2, idx2, sizes, merged.shape, variant)
        np.asarray(out[:1, :1])   # wait for the device
        best = min(best, time.perf_counter() - t0)
    ok = "n/a"
    log(f"steps128 {variant:14s} compile {ct:6.1f}s  warm {best*1e3:8.1f} ms  "
        f"bit-exact={ok}")
