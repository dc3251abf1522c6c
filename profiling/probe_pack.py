"""Break down the per-frame HOST cost of the production decode path at 1080p
(round-3 judge: recon_s 1.363 s/frame vs 0.012 s device step).

Times each Stage-B host phase separately on repeated warm frames:
tensor_plan assembly, _merge_segments, _hoist_inter, _stack_plane, filter
param grids, _pack, dispatch+fetch.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


from tools.make_streams import get_stream

name = sys.argv[1] if len(sys.argv) > 1 else "s1080"
data = get_stream(name)

from p265_tpu.pipeline.decoder import TpuDecoder
from p265_tpu.golden.decoder import GoldenDecoder, bypass_pixel_masks

dec = TpuDecoder()
frames = dec.decode_stream(data)  # warm-up: compile + caches
log("warm-up decode done")

# re-parse to get a fresh plan (parse only)
dec2 = TpuDecoder()
tasks = []
orig = dec2._run_recon
dec2._run_recon = lambda task: (tasks.append(task), orig(task))[1]
dec2.decode_stream(data)
task = tasks[0]
plan = task["plan"]
pol = dec2.shape_policy

R = 5


def timeit(label, fn):
    best = 1e9
    out = None
    for _ in range(R):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    log(f"{label:28s} {best*1e3:8.1f} ms")
    return out


tplan = timeit("tensor_plan", lambda: dec2._build_tplan(plan, skip_pred=True))

from p265_tpu.pipeline.wavefront import (_merge_segments, _stack_plane)
from p265_tpu.pipeline.batch_decode import (_build_batch, _hoist_inter,
                                            _pack)

pps_ = [tplan.planes[0], tplan.planes[1], tplan.planes[2]]


def merge():
    m, offs = _merge_segments(pps_, policy=pol, host_pred=False)
    return m

merged = timeit("_merge_segments", merge)
timeit("_hoist_inter", lambda: _hoist_inter(
    _merge_segments(pps_, policy=pol, host_pred=False)[0], pol))


def stack():
    merged._stacked_cache = None
    return _stack_plane(merged, policy=pol)

timeit("_stack_plane", stack)

from p265_tpu.kernels.loopfilter import (_sao_maps, chroma_edge_params,
                                         luma_edge_params)

timeit("luma_edge_params x2", lambda: [luma_edge_params(plan, v)
                                       for v in (True, False)])
timeit("chroma_edge_params x2", lambda: [chroma_edge_params(plan, v)
                                         for v in (True, False)])
timeit("sao_maps x3", lambda: [_sao_maps(plan, c) for c in (0, 1, 2)])
timeit("bypass_pixel_masks", lambda: bypass_pixel_masks(plan))


def full_build():
    for pp in pps_:
        pp._stacked_cache = None
    return _build_batch([tplan], [plan], policy=pol)

bufs, meta = timeit("_build_batch TOTAL", full_build)
log("buf sizes:", [f"{b.dtype.str}:{b.nbytes>>10}KiB" for b in bufs])

import jax.numpy as jnp
from p265_tpu.pipeline.batch_decode import _decode_batch_jit


def dispatch():
    out = _decode_batch_jit(tuple(jnp.asarray(b) for b in bufs), meta, True,
                            refs=None)
    return [np.asarray(o) for o in out]

timeit("upload+dispatch+fetch", dispatch)
