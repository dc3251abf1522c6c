"""Fused-MC program: prediction planes computed INSIDE the single-dispatch
Stage-B program from device-resident DPB slabs (kernels/mc.mc_pred_plane via
pipeline/batch_decode meta["mc"]), bit-exact vs golden and still a bounded
program count (one per frame kind) per stream."""
import numpy as np
import pytest

import p265_tpu.pipeline.batch_decode as bd
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.pipeline.decoder import TpuDecoder
from p265_tpu.testgen.encoder import Encoder, make_test_image


def _stream(structure, w=96, h=64, n=5, qp=30, seed=3, **pps_kw):
    sps = SPS(pic_width=w, pic_height=h)
    pps = PPS(init_qp=qp, sign_data_hiding=True, **pps_kw)
    frames = [make_test_image(w, h, s) for s in range(n)]
    stream, _ = Encoder(sps, pps, qp=qp, seed=seed).encode_sequence(
        frames, structure=structure)
    return stream


def _check(stream, expect_mc=True, max_programs=2):
    progs = set()
    orig = bd._decode_batch_jit

    def spy(bufs, meta, *a, **k):
        progs.add((tuple((b.shape, str(b.dtype)) for b in bufs), meta))
        return orig(bufs, meta, *a, **k)

    bd._decode_batch_jit = spy
    try:
        dec = TpuDecoder()
        gold = GoldenDecoder().decode_stream(stream)
        pics = dec.decode_stream(stream)
    finally:
        bd._decode_batch_jit = orig
    assert dec.shape_policy.want_mc == expect_mc
    if expect_mc:
        # the inter-kind program must carry MC specs (device MC); the intra
        # program carries none; NO program uploads a dense pred plane
        assert any(dict(meta)["mc"] is not None for _, meta in progs)
        for _, meta in progs:
            assert "pred" not in dict(dict(meta)["fp"])
    assert len(progs) <= max_programs, len(progs)
    assert len(pics) == len(gold)
    for i, (p, g) in enumerate(zip(pics, gold)):
        for c in range(3):
            assert np.array_equal(p.prefilter[c], g.prefilter[c]), (i, c)
            assert np.array_equal(p.planes[c], g.planes[c]), (i, c)


def test_fused_mc_ldp():
    _check(_stream("LDP"))


def test_fused_mc_ldp2_multiref():
    _check(_stream("LDP2", seed=5))


def test_fused_mc_ra_bframes():
    # frame-DAG batching defaults OFF, so the RA stream compiles exactly 2
    # programs again
    _check(_stream("RA", n=5, seed=7))


def test_fused_mc_weighted_pred():
    _check(_stream("LDP", seed=9, weighted_pred=True, weighted_bipred=True))


def test_fused_mc_longterm():
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=6)
    sps.long_term_ref_pics_present = True
    pps = PPS(init_qp=30, sign_data_hiding=True)
    frames = [make_test_image(96, 64, s) for s in range(5)]
    stream, _ = Encoder(sps, pps, qp=30, seed=11).encode_sequence(
        frames, structure="LDP-LT")
    _check(stream)


def test_pcm_stream_keeps_dense_path():
    # PCM pixels are host-stamped: the policy must refuse the MC program
    sps = SPS(pic_width=96, pic_height=64, pcm_enabled=True,
              pcm_loop_filter_disabled=True)
    pps = PPS(init_qp=30)
    frames = [make_test_image(96, 64, s) for s in range(3)]
    stream, _ = Encoder(sps, pps, qp=30, seed=4).encode_sequence(
        frames, structure="LDP")
    gold = GoldenDecoder().decode_stream(stream)
    assert any(t.pcm for g in gold for t in g.plan.tus), "stream lacks PCM"
    _check(stream, expect_mc=False, max_programs=2)
