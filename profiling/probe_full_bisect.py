"""Bisect the fused _decode_batch_jit 1080p hang by toggling meta stages.

Usage: python profiling/probe_full_bisect.py <variant>
Variants: scan (filters off), deblock (scan+deblock), sao (scan+sao), full.
"""
import sys
import time

import numpy as np
import jax.numpy as jnp


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


variant = sys.argv[1] if len(sys.argv) > 1 else "scan"

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.plan.frame_plan import build_tensor_plan
from p265_tpu.pipeline.batch_decode import (_build_batch, _decode_batch_jit,
                                            _freeze, _thaw)
from tools.make_streams import get_stream

data = get_stream("s1080")
t0 = time.perf_counter()
g = GoldenDecoder().decode_stream(data)[0]
tp = build_tensor_plan(g.plan)
log("host prep", round(time.perf_counter() - t0, 2))

blob, meta = _build_batch([tp], [g.plan])
m = _thaw(meta)
if variant == "scan":
    m["deblock"] = False
    m["sao_luma"] = m["sao_chroma"] = False
elif variant == "deblock":
    m["sao_luma"] = m["sao_chroma"] = False
elif variant == "sao":
    m["deblock"] = False
meta = _freeze(m)
log("variant", variant, "deblock", m["deblock"], "sao", m["sao_luma"])

if variant == "unpack":
    import functools
    import jax
    from p265_tpu.pipeline.batch_decode import _unpack

    @functools.partial(jax.jit, static_argnames=("specs",))
    def _just_unpack(b, specs):
        arrays = _unpack(b, specs)
        return sum(jnp.sum(a.astype(jnp.int32)) for a in arrays)

    t0 = time.perf_counter()
    s = _just_unpack(tuple(jnp.asarray(b) for b in blob), m["specs"])
    s.block_until_ready()
    log("unpack compile+run", round(time.perf_counter() - t0, 2))
    raise SystemExit

if variant == "expand":
    import functools
    import jax
    from p265_tpu.pipeline.batch_decode import _unpack
    from p265_tpu.pipeline.wavefront import _expand

    @functools.partial(jax.jit, static_argnames=("meta",))
    def _unpack_expand(b, meta):
        mm = _thaw(meta)
        arrays = _unpack(b, mm["specs"])
        tu = {}
        idx_maps = {}
        for log2, fields in mm["tu"]:
            d = {f: arrays[i] for f, i in fields}
            idx_maps[log2] = d.pop("idx_map")
            tu[log2] = d
        stacked = _expand(tu, idx_maps, mm["sizes"], True)
        return sum(jnp.sum(d["residual"]) for d in stacked.values())

    t0 = time.perf_counter()
    s = _unpack_expand(tuple(jnp.asarray(b) for b in blob), meta)
    s.block_until_ready()
    log("unpack+expand compile+run", round(time.perf_counter() - t0, 2))
    raise SystemExit

t0 = time.perf_counter()
pl, pc, fl, fc = _decode_batch_jit(tuple(jnp.asarray(b) for b in blob), meta, True, False,
                                   False)
fl.block_until_ready()
log("compile+run", round(time.perf_counter() - t0, 2))
t0 = time.perf_counter()
pl, pc, fl, fc = _decode_batch_jit(tuple(jnp.asarray(b) for b in blob), meta, True, False,
                                   False)
fl.block_until_ready()
log("warm run", round(time.perf_counter() - t0, 3))
if variant == "full":
    ok = np.array_equal(np.asarray(fl)[0], g.planes[0])
    log("bit-exact luma:", ok)
log("DONE")
