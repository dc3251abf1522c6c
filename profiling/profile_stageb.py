"""Profile the Stage-B wavefront scan: where does per-step time go?

Times the full scan, then ablated variants of the per-step body (gather only,
gather+predict no scatter, scatter only) on the device with representative
step shapes, to locate the bottleneck.
"""
from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.pipeline.wavefront import (
    _stack_plane, _residual_for, reconstruct_tpu_scan_frames)
from p265_tpu.plan.frame_plan import build_tensor_plan
from p265_tpu.testgen.encoder import IntraEncoder, make_test_image
from p265_tpu.kernels.intra import predict_batch

W, H, QP = 416, 240, 32


def timed(fn, *a, n=20, **k):
    out = fn(*a, **k)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*a, **k)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    print("backend:", jax.default_backend())
    sps = SPS(pic_width=W, pic_height=H)
    pps = PPS(init_qp=QP, sign_data_hiding=True)
    img = make_test_image(W, H, 3)
    stream, _, _ = IntraEncoder(sps, pps, qp=QP, seed=3).encode_frame(img)
    g = GoldenDecoder().decode_stream(stream)[0]
    tplan = build_tensor_plan(g.plan)

    pp = tplan.planes[0]
    n_steps, stacked = _stack_plane(pp)
    print(f"luma n_steps={n_steps}")
    for log2, b in pp.batches.items():
        cap = stacked[log2]["pos"].shape[1]
        print(f"  bucket {1<<log2}: n_tus={len(b.step)} cap={cap}")

    # full batch-4 pipeline
    tplans = [tplan] * 4
    t = timed(lambda: jax.block_until_ready(
        [np.asarray(x) for fr in reconstruct_tpu_scan_frames(tplans)
         for x in fr]), n=3)
    print(f"full scan batch=4: {t*1000:.1f} ms ({4/t:.2f} fps)")

    # per-bucket single-step predict_batch cost at step shapes
    ph, pw = pp.shape
    GUARD = 32
    plane = jnp.zeros((ph + GUARD, pw), jnp.int32)
    for log2 in sorted(pp.batches):
        s = 1 << log2
        d = stacked[log2]
        cap = d["pos"].shape[1]
        res = np.zeros((cap, s, s), np.int32)
        args = [jnp.asarray(v[0]) for v in
                (d["pos"], d["ref_ys"], d["ref_xs"], d["ref_ok"], d["mode"],
                 d["filter_flag"], d["strong_allowed"])]
        t = timed(lambda: predict_batch(plane, args[0], args[1], args[2],
                                        args[3], args[4], args[5], args[6],
                                        jnp.asarray(res), s, 0), n=50)
        print(f"  single-step predict size={s} cap={cap}: {t*1e6:.0f} us")

    # components: gather, scatter alone
    for log2 in sorted(pp.batches):
        s = 1 << log2
        d = stacked[log2]
        cap = d["pos"].shape[1]
        ref_ys = jnp.asarray(d["ref_ys"][0])
        ref_xs = jnp.asarray(d["ref_xs"][0])
        pos = jnp.asarray(d["pos"][0])
        out = jnp.zeros((cap, s, s), jnp.int32)

        @jax.jit
        def gather_only(plane, ys, xs):
            return plane[ys, xs]

        @jax.jit
        def scatter_only(plane, pos, out):
            rows = pos[:, 0][:, None, None] + jnp.arange(s)[None, :, None]
            cols = pos[:, 1][:, None, None] + jnp.arange(s)[None, None, :]
            return plane.at[rows, cols].set(out)

        tg = timed(gather_only, plane, ref_ys, ref_xs, n=50)
        ts = timed(scatter_only, plane, pos, out, n=50)
        print(f"  size={s} cap={cap}: gather={tg*1e6:.0f} us "
              f"scatter={ts*1e6:.0f} us")


if __name__ == "__main__":
    main()
