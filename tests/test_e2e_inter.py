"""Configs 2/3: P and B GOP round trips, golden + device, bit-exact."""
import numpy as np
import pytest

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.pipeline.decoder import TpuDecoder
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence


def _roundtrip(structure, n_frames, w=96, h=64, qp=30, seed=1, tpu=False):
    sps = SPS(pic_width=w, pic_height=h, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5)
    pps = PPS(init_qp=qp, sign_data_hiding=True)
    frames = make_moving_sequence(w, h, n_frames, seed=seed)
    enc = Encoder(sps, pps, qp=qp, seed=seed)
    stream, recons = enc.encode_sequence(frames, structure=structure)
    gold = GoldenDecoder().decode_stream(stream)
    assert [f.poc for f in gold] == list(range(n_frames))
    for f in gold:
        for c in range(3):
            assert np.array_equal(f.planes[c], recons[f.poc][c]), \
                f"poc {f.poc} plane {c}"
    if tpu:
        tp = TpuDecoder().decode_stream(stream)
        for t, g in zip(tp, gold):
            for c in range(3):
                assert np.array_equal(t.planes[c], g.planes[c]), \
                    f"tpu poc {t.poc} plane {c}"
    return stream, gold


def test_ldp_roundtrip():
    _roundtrip("LDP", 3, seed=2)


def test_ldp2_two_refs():
    _roundtrip("LDP2", 4, seed=3)


def test_ra_bgop_roundtrip():
    _roundtrip("RA", 5, seed=4)


def test_ra_bgop_tpu():
    _roundtrip("RA", 5, seed=5, tpu=True)


def test_ldp_tpu():
    _roundtrip("LDP", 3, seed=6, tpu=True)


def test_p_high_qp_skip_heavy():
    # high QP => most CUs quantize to zero => skip path coverage
    stream, gold = _roundtrip("LDP", 3, qp=45, seed=7)
    skips = sum(int(f.plan.skip_map.sum()) for f in gold)
    assert skips > 0, "expected skip CUs at high QP"
