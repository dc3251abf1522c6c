"""Pipelined (parse || recon) decoder == sequential, bit-exact."""
import numpy as np

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.pipeline.async_decoder import PipelinedTpuDecoder
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence


def test_pipelined_matches_golden_ra():
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5)
    pps = PPS(init_qp=32, sign_data_hiding=True)
    frames = make_moving_sequence(96, 64, 9, seed=50)
    stream, _ = Encoder(sps, pps, qp=32, seed=50).encode_sequence(
        frames, structure="RA")
    gold = GoldenDecoder().decode_stream(stream)
    pipe = PipelinedTpuDecoder().decode_stream(stream)
    assert [f.poc for f in pipe] == [f.poc for f in gold]
    for p, g in zip(pipe, gold):
        for c in range(3):
            assert np.array_equal(p.planes[c], g.planes[c])


def _ldp_stream(seed):
    sps = SPS(pic_width=96, pic_height=64)
    pps = PPS(init_qp=32, sign_data_hiding=True)
    frames = make_moving_sequence(96, 64, 3, seed=seed)
    stream, _ = Encoder(sps, pps, qp=32, seed=seed).encode_sequence(frames)
    return stream


def test_warm_compile_builds_the_dispatched_program(monkeypatch):
    """The first inter program is compiled ahead on a side thread: it must
    be the very program the recon worker dispatches later (else the
    persistent cache never hits), and a second decode of the same stream
    compiles it again from JAX's in-memory caches, with no XLA compile."""
    import threading

    import jax

    import p265_tpu.pipeline.batch_decode as bd
    from p265_tpu import compile_cache

    monkeypatch.setattr(compile_cache, "enabled", lambda: True)
    stream = _ldp_stream(51)
    metas = []                      # (thread name, meta) of every batch
    orig_build = bd._build_batch

    def spy(*a, **k):
        bufs, meta = orig_build(*a, **k)
        metas.append((threading.current_thread().name, meta))
        return bufs, meta

    compiles = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda ev, d, **k: compiles.append(ev)
        if ev == "/jax/core/compile/backend_compile_duration" else None)
    monkeypatch.setattr(bd, "_build_batch", spy)
    gold = GoldenDecoder().decode_stream(stream)
    for run in range(2):
        metas.clear()
        n0 = len(compiles)
        dec = PipelinedTpuDecoder()
        pics = dec.decode_stream(stream)
        for p, g in zip(pics, gold):
            for c in range(3):
                assert np.array_equal(p.planes[c], g.planes[c])
        assert dec.warm_program is not None
        assert dec.stats["warm_compile_s"] > 0
        warm = [m for t, m in metas if t == "p265-warm-compile"]
        dispatched = [m for t, m in metas if t != "p265-warm-compile"]
        assert len(warm) == 1 and warm[0] in dispatched
        if run:
            assert len(compiles) == n0, compiles[n0:]
        else:
            assert len(compiles) > n0       # the listener sees compiles


def test_warm_compile_failure_is_raised(monkeypatch):
    """A failure on the warm-compile thread fails the decode, as one on the
    recon worker does; it is never left to the thread's traceback."""
    import pytest

    from p265_tpu import compile_cache

    def boom(self, task, policy):
        raise RuntimeError("warm compile failed")

    monkeypatch.setattr(compile_cache, "enabled", lambda: True)
    monkeypatch.setattr(PipelinedTpuDecoder, "_warm_compile", boom)
    dec = PipelinedTpuDecoder()
    with pytest.raises(RuntimeError, match="warm compile failed"):
        dec.decode_stream(_ldp_stream(52))
    assert dec._warm_err is None
