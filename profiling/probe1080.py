"""Bisect the 1080p XLA compile blowup, stage by stage."""
import sys, time
import numpy as np

def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)

import jax
import jax.numpy as jnp
log("backend", jax.default_backend())

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.plan.frame_plan import build_tensor_plan
from tools.make_streams import get_stream

data = get_stream("s1080")
t0 = time.perf_counter()
g = GoldenDecoder().decode_stream(data)[0]
log("stage-A parse + golden recon", round(time.perf_counter()-t0, 2), "s")

t0 = time.perf_counter()
tp = build_tensor_plan(g.plan)
log("tensor plan", round(time.perf_counter()-t0, 2), "s")

from p265_tpu.pipeline.wavefront import (_merge_segments, _stack_plane,
                                         _round_up)
pps_ = list(tp.planes)
merged, offs = _merge_segments(pps_)
n_steps, stacked = _stack_plane(merged)
log("merged n_steps", n_steps, "rounded", _round_up(n_steps, 32),
    "shape", merged.shape)
for log2, d in sorted(stacked.items()):
    log(f"bucket {1<<log2}: n={d['pos'].shape[0]-1} cap={d['idx_map'].shape[1]}")

stage = sys.argv[1] if len(sys.argv) > 1 else "all"

if stage in ("resid", "all"):
    from p265_tpu.kernels.itransform import batch_residual
    for log2, d in sorted(stacked.items()):
        t0 = time.perf_counter()
        r = batch_residual(jnp.asarray(d["coeffs"], jnp.int32),
                           jnp.asarray(d["qp"], jnp.int32),
                           jnp.asarray(d["is_dst"]), jnp.asarray(d["tskip"]),
                           log2, True, bypass=jnp.asarray(d["bypass"]))
        r.block_until_ready()
        log(f"resid {1<<log2} compile+run", round(time.perf_counter()-t0, 2))

if stage in ("scan", "all"):
    from p265_tpu.pipeline.wavefront import reconstruct_tpu_scan_plane
    t0 = time.perf_counter()
    plane = reconstruct_tpu_scan_plane(merged)
    plane.block_until_ready()
    log("scan-only compile+run", round(time.perf_counter()-t0, 2))
    t0 = time.perf_counter()
    plane = reconstruct_tpu_scan_plane(merged)
    plane.block_until_ready()
    log("scan-only warm run", round(time.perf_counter()-t0, 2))

if stage in ("filters", "all"):
    from p265_tpu.kernels.loopfilter import loop_filters_tpu
    y = jnp.asarray(np.asarray(g.prefilter[0], np.int32))
    cb = jnp.asarray(np.asarray(g.prefilter[1], np.int32))
    cr = jnp.asarray(np.asarray(g.prefilter[2], np.int32))
    t0 = time.perf_counter()
    out = loop_filters_tpu(g.plan, [y, cb, cr])
    out[0].block_until_ready()
    log("filters compile+run", round(time.perf_counter()-t0, 2))

if stage in ("full", "all"):
    from p265_tpu.pipeline.batch_decode import decode_batch_planes
    t0 = time.perf_counter()
    pl, pc, fl, fc = decode_batch_planes([tp], [g.plan])
    fl.block_until_ready()
    log("full single-dispatch compile+run", round(time.perf_counter()-t0, 2))
    ok = np.array_equal(np.asarray(fl)[0], g.planes[0])
    log("bit-exact luma:", ok)
    t0 = time.perf_counter()
    pl, pc, fl, fc = decode_batch_planes([tp], [g.plan])
    fl.block_until_ready()
    log("full warm run", round(time.perf_counter()-t0, 2))
log("DONE")
