"""MC window fetch: element gather (refs[r, ys, xs] advanced indexing, the
current kernels/mc.py formulation) vs contiguous-slice gather
(vmap(dynamic_slice) over edge-padded refs).  Slice gathers move the same
windows as (1, span, span) contiguous blocks instead of scattered
elements.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


def bench(fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    np.asarray(out[0] if isinstance(out, tuple) else out)[:1]
    best = 1e9
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    rng = np.random.default_rng(0)
    H, W, R = 1080, 1920, 4
    refs = jnp.asarray(rng.integers(0, 255, (R, H, W), np.int32))
    for block, taps, nb in ((16, 8, 2048), (8, 8, 2048), (4, 8, 4096),
                            (8, 4, 2048)):
        span = block + taps - 1
        half = taps // 2 - 1
        pos = np.stack([rng.integers(0, H - block, nb),
                        rng.integers(0, W - block, nb)], 1).astype(np.int32)
        mv = rng.integers(-32, 32, (nb, 2)).astype(np.int32)
        ridx = rng.integers(0, R, nb).astype(np.int32)
        jpos, jmv, jr = jnp.asarray(pos), jnp.asarray(mv), jnp.asarray(ridx)

        @jax.jit
        def elem_gather(refs, pos, ridx, mv):
            ix = pos[:, 1] + (mv[:, 0] >> 2) - half
            iy = pos[:, 0] + (mv[:, 1] >> 2) - half
            ys = jnp.clip(iy[:, None] + jnp.arange(span)[None, :], 0, H - 1)
            xs = jnp.clip(ix[:, None] + jnp.arange(span)[None, :], 0, W - 1)
            return refs[ridx[:, None, None], ys[:, :, None], xs[:, None, :]]

        P = 16

        @jax.jit
        def slice_gather(refs, pos, ridx, mv):
            padded = jnp.pad(refs, ((0, 0), (P, P), (P, P)), mode="edge")
            ix = pos[:, 1] + (mv[:, 0] >> 2) - half + P
            iy = pos[:, 0] + (mv[:, 1] >> 2) - half + P
            win = jax.vmap(
                lambda r, y, x: jax.lax.dynamic_slice(
                    padded, (r, y, x), (1, span, span))[0]
            )(ridx, iy, ix)
            return win

        a = bench(elem_gather, refs, jpos, jr, jmv)
        b = bench(slice_gather, refs, jpos, jr, jmv)
        va = np.asarray(elem_gather(refs, jpos, jr, jmv))
        vb = np.asarray(slice_gather(refs, jpos, jr, jmv))
        exact = np.array_equal(va, vb)
        log(f"block {block} taps {taps} n {nb}: elem {a * 1e3:7.2f} ms  "
            f"slice {b * 1e3:7.2f} ms  ({a / b:5.2f}x)  exact={exact}")


if __name__ == "__main__" and "--layout" not in sys.argv:
    main()


def bench_layout():
    """Old n-minor layout vs new [spatial, n] lane layout of _mc_blocks."""
    from p265_tpu.kernels.mc import _mc_blocks
    rng = np.random.default_rng(0)
    H, W, R = 1080, 1920, 4
    refs = jnp.asarray(rng.integers(0, 255, (R, H, W), np.int32))
    from p265_tpu.tables import LUMA_FILTER, CHROMA_FILTER
    for block, taps, nb in ((16, 8, 2048), (8, 8, 2048), (4, 8, 4096),
                            (8, 4, 2048), (2, 4, 4096)):
        filt = np.asarray(LUMA_FILTER if taps == 8 else CHROMA_FILTER,
                          np.int32)
        fmask = 3 if taps == 8 else 7
        pos = np.stack([rng.integers(0, H - block, nb),
                        rng.integers(0, W - block, nb)], 1).astype(np.int32)
        mv = rng.integers(-32, 32, (nb, 2)).astype(np.int32)
        ridx = rng.integers(0, R, nb).astype(np.int32)
        ff = np.stack([filt[mv[:, 0] & fmask], filt[mv[:, 1] & fmask]], 1)
        args = (refs, jnp.asarray(pos), jnp.asarray(ridx), jnp.asarray(mv),
                jnp.asarray(ff))
        t = bench(lambda *a: _mc_blocks(*a, block=block, taps=taps,
                                        n_refs=R), *args)
        log(f"mc_blocks block {block} taps {taps} n {nb}: {t * 1e3:7.2f} ms")


if __name__ == "__main__" and "--layout" in sys.argv:
    bench_layout()

