"""Conformance corners (VERDICT r3 missing #8): feature COMBINATIONS the
per-feature suites never crossed -- explicit weighted prediction together
with long-term references, and DPB bumping at capacity under reorder
depth > 1 over a 30+ frame random-access sequence."""
import numpy as np

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.pipeline.decoder import TpuDecoder
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence


def _assert_tpu_matches(stream, gold):
    pics = TpuDecoder().decode_stream(stream)
    assert len(pics) == len(gold)
    for p, g in zip(pics, gold):
        assert p.poc == g.poc
        for c in range(3):
            assert np.array_equal(np.asarray(p.planes[c]), g.planes[c]), \
                (p.poc, c)


def test_weighted_pred_with_longterm_refs():
    """Explicit WP applied to a mixed short-term + long-term L0 (LDP-LT):
    the WP table must be indexed by ref_idx across the st/lt boundary and
    the fused-MC program must reproduce it bit-exactly."""
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=6)
    sps.long_term_ref_pics_present = True
    pps = PPS(init_qp=30, sign_data_hiding=True,
              weighted_pred=True, weighted_bipred=True)
    frames = make_moving_sequence(96, 64, 5, seed=21)
    enc = Encoder(sps, pps, qp=30, seed=21)
    stream, recons = enc.encode_sequence(frames, structure="LDP-LT")
    gold = GoldenDecoder().decode_stream(stream)
    assert [f.poc for f in gold] == list(range(5))
    for f in gold:  # encoder round trip
        for c in range(3):
            assert np.array_equal(f.planes[c], recons[f.poc][c]), (f.poc, c)
    _assert_tpu_matches(stream, gold)


def test_dpb_stress_long_ra_sequence():
    """33-frame hierarchical RA GOP with reorder depth 2 and a tight DPB:
    output bumping at capacity must emit every frame exactly once, in POC
    order, bit-exact through the device path."""
    n = 33
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5)
    pps = PPS(init_qp=34, sign_data_hiding=True)
    frames = make_moving_sequence(96, 64, n, seed=8)
    enc = Encoder(sps, pps, qp=34, seed=8)
    stream, recons = enc.encode_sequence(frames, structure="RA")
    gold = GoldenDecoder().decode_stream(stream)
    assert [f.poc for f in gold] == list(range(n)), "POC output order"
    for f in gold:
        for c in range(3):
            assert np.array_equal(f.planes[c], recons[f.poc][c]), (f.poc, c)
    _assert_tpu_matches(stream, gold)
