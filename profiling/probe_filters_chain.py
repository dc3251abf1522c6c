"""Step through loop_filters_tpu at 1080p one device call at a time."""
import time
import numpy as np
import jax
import jax.numpy as jnp


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


log("backend", jax.default_backend())

from p265_tpu.golden.decoder import GoldenDecoder
from tools.make_streams import get_stream

data = get_stream("s1080")
t0 = time.perf_counter()
g = GoldenDecoder().decode_stream(data)[0]
log("parse+golden", round(time.perf_counter() - t0, 2))
plan = g.plan

from p265_tpu.kernels.loopfilter import (
    _deblock_chroma_vertical, _deblock_luma_vertical, _sao_apply, _sao_maps,
    chroma_edge_params, luma_edge_params)

y = jnp.asarray(np.asarray(g.prefilter[0], np.int32))
cb = jnp.asarray(np.asarray(g.prefilter[1], np.int32))
cr = jnp.asarray(np.asarray(g.prefilter[2], np.int32))
y.block_until_ready()
log("h2d done", y.shape, cb.shape)

t0 = time.perf_counter()
bs, beta, tc = luma_edge_params(plan, vertical=True)
log("host luma_edge_params V", round(time.perf_counter() - t0, 2),
    bs.shape, bs.dtype)
t0 = time.perf_counter()
y = _deblock_luma_vertical(y, jnp.asarray(bs), jnp.asarray(beta),
                           jnp.asarray(tc))
y.block_until_ready()
log("deblock luma V", round(time.perf_counter() - t0, 2))

t0 = time.perf_counter()
tcb, tcr = chroma_edge_params(plan, vertical=True)
cb = _deblock_chroma_vertical(cb, jnp.asarray(tcb))
cr = _deblock_chroma_vertical(cr, jnp.asarray(tcr))
cr.block_until_ready()
log("deblock chroma V", round(time.perf_counter() - t0, 2), tcb.shape)

t0 = time.perf_counter()
bs, beta, tc = luma_edge_params(plan, vertical=False)
log("host luma_edge_params H", round(time.perf_counter() - t0, 2), bs.shape)
t0 = time.perf_counter()
y = _deblock_luma_vertical(y.T, jnp.asarray(bs), jnp.asarray(beta),
                           jnp.asarray(tc)).T
y.block_until_ready()
log("deblock luma H", round(time.perf_counter() - t0, 2))

t0 = time.perf_counter()
tcb, tcr = chroma_edge_params(plan, vertical=False)
cb = _deblock_chroma_vertical(cb.T, jnp.asarray(tcb)).T
cr = _deblock_chroma_vertical(cr.T, jnp.asarray(tcr)).T
cr.block_until_ready()
log("deblock chroma H", round(time.perf_counter() - t0, 2), tcb.shape)

for c, p in ((0, y), (1, cb), (2, cr)):
    t0 = time.perf_counter()
    ty, cls, offs = _sao_maps(plan, c)
    ctb = plan.sps.ctb_size if c == 0 else plan.sps.ctb_size >> 1
    p = _sao_apply(p, jnp.asarray(ty), jnp.asarray(cls), jnp.asarray(offs),
                   ctb)
    p.block_until_ready()
    log(f"sao plane {c}", round(time.perf_counter() - t0, 2))
    if c == 0:
        ok = np.array_equal(np.asarray(p), g.planes[0])
        log("luma bit-exact:", ok)
log("DONE")
