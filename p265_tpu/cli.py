"""Command-line interface: decode / encode / info.

Examples:
  python -m p265_tpu.cli decode -i in.265 -o out.yuv --md5
  python -m p265_tpu.cli encode -i in.yuv --size 416x240 -o out.265 --qp 32 \
      --gop RA --frames 9
  python -m p265_tpu.cli info -i in.265
"""
from __future__ import annotations

import argparse
import sys


def _cmd_decode(args):
    import numpy as np

    from p265_tpu import yuv
    if args.backend == "device":
        if args.pipelined:
            from p265_tpu.pipeline.async_decoder import \
                PipelinedTpuDecoder as Dec
        else:
            from p265_tpu.pipeline.decoder import TpuDecoder as Dec
    else:
        from p265_tpu.golden.decoder import GoldenDecoder as Dec
    dec = Dec()
    dec.error_resilient = args.resilient
    with open(args.input, "rb") as f:
        data = f.read()
    frames = dec.decode_stream(data)
    out = [[np.clip(p, 0, 255) for p in f.cropped_planes()] for f in frames]
    if args.output:
        yuv.write_yuv(args.output, out)
    if args.md5:
        print("MD5:", yuv.sequence_md5(out))
    if args.metrics:
        dec.write_metrics(args.metrics)
    if dec.errors:
        print(f"{len(dec.errors)} corrupt slices skipped (resynced at IRAP)",
              file=sys.stderr)
    print(f"decoded {len(frames)} frames "
          f"({dec.stats['parse_s']:.2f}s parse, "
          f"{dec.stats['recon_s']:.2f}s recon, "
          f"{dec.stats['filter_s']:.2f}s filters)")
    return 0


def _cmd_encode(args):
    from p265_tpu import yuv
    from p265_tpu.hls.params import PPS, SPS
    from p265_tpu.testgen.encoder import Encoder, make_moving_sequence

    w, h = (int(v) for v in args.size.split("x"))
    sps = SPS(pic_width=w, pic_height=h,
              temporal_mvp_enabled=args.gop != "AI",
              long_term_ref_pics_present=args.gop == "LDP-LT",
              num_reorder_pics=2 if args.gop in ("RA", "CRA-RASL") else 0,
              max_dec_pic_buffering=5)
    tiles = None
    pps = PPS(init_qp=args.qp, sign_data_hiding=True)
    if args.tiles:
        tc, tr = (int(v) for v in args.tiles.split("x"))
        pps.tiles_enabled = True
        pps.num_tile_columns = tc
        pps.num_tile_rows = tr
    if args.wpp:
        pps.entropy_coding_sync_enabled = True
    if args.input == "synthetic":
        frames = make_moving_sequence(w, h, args.frames, seed=args.seed)
    else:
        frames = yuv.read_yuv(args.input, w, h)[:args.frames or None]
    enc = Encoder(sps, pps, qp=args.qp, seed=args.seed)
    if args.gop == "AI":
        stream = b""
        from p265_tpu.hls.bitio import BitWriter
        from p265_tpu.hls import nal as N
        from p265_tpu.hls.params import write_pps, write_sps, write_vps
        wtr = BitWriter(); write_vps(wtr)
        stream += N.make_nal(N.NAL_VPS, wtr.get_bytes())
        wtr = BitWriter(); write_sps(wtr, sps)
        stream += N.make_nal(N.NAL_SPS, wtr.get_bytes())
        wtr = BitWriter(); write_pps(wtr, pps)
        stream += N.make_nal(N.NAL_PPS, wtr.get_bytes())
        for i, f in enumerate(frames):
            nb, *_ = enc.encode_frame(f, poc=0, slice_type=2)
            stream += nb
    else:
        stream, _ = enc.encode_sequence(frames, structure=args.gop,
                                        num_slices=args.slices)
    with open(args.output, "wb") as f:
        f.write(stream)
    print(f"encoded {len(frames)} frames -> {len(stream)} bytes")
    return 0


def _cmd_info(args):
    from p265_tpu.hls import nal
    from p265_tpu.hls.params import parse_pps, parse_sps

    with open(args.input, "rb") as f:
        data = f.read()
    units = nal.split_nal_units(data)
    counts = {}
    for u in units:
        counts[u.nal_type] = counts.get(u.nal_type, 0) + 1
        if u.nal_type == nal.NAL_SPS:
            s = parse_sps(u.rbsp)
            print(f"SPS: {s.pic_width}x{s.pic_height} CTB {s.ctb_size} "
                  f"SAO={s.sao_enabled} TMVP={s.temporal_mvp_enabled}")
        elif u.nal_type == nal.NAL_PPS:
            p = parse_pps(u.rbsp)
            print(f"PPS: qp={p.init_qp} tiles={p.tiles_enabled} "
                  f"wpp={p.entropy_coding_sync_enabled} sdh={p.sign_data_hiding}")
    print("NAL units:", {k: v for k, v in sorted(counts.items())})
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="p265_tpu", description="HEVC Main-profile decoder on JAX devices")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode an Annex-B HEVC stream")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output")
    d.add_argument("--backend", choices=("golden", "device"),
                   default="device")
    d.add_argument("--md5", action="store_true")
    d.add_argument("--metrics", help="append JSONL run metrics to this file")
    d.add_argument("--resilient", action="store_true",
                   help="skip corrupt slices, resync at next IRAP")
    d.add_argument("--pipelined", action="store_true",
                   help="overlap host parse with device reconstruction")
    d.set_defaults(fn=_cmd_decode)

    e = sub.add_parser("encode", help="encode YUV (or synthetic) to HEVC")
    e.add_argument("-i", "--input", default="synthetic",
                   help="planar YUV420 file or 'synthetic'")
    e.add_argument("-o", "--output", required=True)
    e.add_argument("--size", required=True, help="WxH")
    e.add_argument("--qp", type=int, default=32)
    e.add_argument("--frames", type=int, default=5)
    e.add_argument("--gop", choices=("AI", "LDP", "LDP2", "LDP-LT", "RA",
                                     "CRA-RASL"),
                   default="LDP")
    e.add_argument("--tiles", help="CxR tile grid")
    e.add_argument("--wpp", action="store_true")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--slices", type=int, default=1,
                   help="independent slices per picture")
    e.set_defaults(fn=_cmd_encode)

    i = sub.add_parser("info", help="inspect an Annex-B stream")
    i.add_argument("-i", "--input", required=True)
    i.set_defaults(fn=_cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
