"""Long-term reference pictures (spec 8.3.2 PocLtCurr, 8.5.3.2.7/.8 lt
scaling gates): LDP-LT GOP round trips, golden + device, bit-exact."""
import numpy as np

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.pipeline.decoder import TpuDecoder
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence


def _lt_roundtrip(n_frames, w=96, h=64, qp=30, seed=1, tpu=False,
                  log2_max_poc_lsb=8, sps_lt=False):
    sps = SPS(pic_width=w, pic_height=h, temporal_mvp_enabled=True,
              log2_max_poc_lsb=log2_max_poc_lsb,
              num_reorder_pics=2, max_dec_pic_buffering=6)
    sps.long_term_ref_pics_present = True
    if sps_lt:
        # SPS-signaled LT candidates: POC-0 lsb plus an unused decoy so the
        # slice writes a real lt_idx_sps (>1 candidates -> coded index)
        sps.num_long_term_ref_pics = 2
        sps.lt_ref_poc_lsb = [7, 0]
        sps.lt_used_by_curr = [0, 1]
    pps = PPS(init_qp=qp, sign_data_hiding=True)
    frames = make_moving_sequence(w, h, n_frames, seed=seed)
    enc = Encoder(sps, pps, qp=qp, seed=seed)
    stream, recons = enc.encode_sequence(frames, structure="LDP-LT")
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


def test_lt_roundtrip_golden():
    # every P frame references [prev (ST), frame 0 (LT)]: LT marking,
    # mixed-lt AMVP/TMVP and ref-list construction all on the decode path
    _lt_roundtrip(5, seed=2)


def test_lt_poc_wrap_msb_cycle():
    # 20 frames with max_poc_lsb=16: the LT entry for POC 0 needs
    # delta_poc_msb_cycle_lt=1 after the wrap (spec 7.4.7.1 accumulation)
    _lt_roundtrip(20, w=64, h=64, qp=34, seed=3, log2_max_poc_lsb=4)


def test_lt_tpu_bit_exact():
    _lt_roundtrip(4, seed=4, tpu=True)


def test_lt_sps_signaled_sets():
    # the LT entry for POC 0 rides the SPS candidate list (num_long_term_sps
    # > 0, lt_idx_sps coded) instead of being slice-signaled
    stream, _ = _lt_roundtrip(5, seed=6, sps_lt=True)
    # confirm the bitstream really took the lt_idx_sps path
    from p265_tpu.hls import nal as nal_mod
    from p265_tpu.hls.params import parse_pps, parse_sps
    from p265_tpu.hls.slice_header import parse_slice_header
    sps_map, pps_map, saw_sps_entry = {}, {}, False
    for unit in nal_mod.split_nal_units(stream):
        t, rbsp = unit.nal_type, unit.rbsp
        if t == nal_mod.NAL_SPS:
            s = parse_sps(rbsp)
            sps_map[s.sps_id] = s
        elif t == nal_mod.NAL_PPS:
            p = parse_pps(rbsp)
            pps_map[p.pps_id] = p
        elif t == nal_mod.NAL_TRAIL_R:
            h, _, _, _ = parse_slice_header(rbsp, t, sps_map, pps_map)
            for e in h.lt_entries:
                if "sps_idx" in e:
                    assert e["sps_idx"] == 1 and e["poc_lsb"] == 0
                    saw_sps_entry = True
    assert saw_sps_entry


def test_lt_marking_in_dpb():
    # frame 0 must be held as a long-term reference throughout
    from p265_tpu.hls import nal as nal_mod
    sps = SPS(pic_width=64, pic_height=64, temporal_mvp_enabled=True)
    sps.long_term_ref_pics_present = True
    pps = PPS(init_qp=30)
    frames = make_moving_sequence(64, 64, 4, seed=5)
    enc = Encoder(sps, pps, qp=30, seed=5)
    stream, _ = enc.encode_sequence(frames, structure="LDP-LT")
    dec = GoldenDecoder()
    for unit in nal_mod.split_nal_units(stream):
        dec.decode_nal(unit)
        if dec.dpb is not None:
            lt = [p.poc for p in dec.dpb.pics if p.is_long_term]
            assert lt in ([], [0]), lt
    # after >=2 coded pictures the LT marking must actually be present
    assert any(p.is_long_term for p in dec.dpb.pics)
    dec.flush()
