"""The named benchmark and smoke bitstreams.

Deterministic: every stream is a pure function of its name (testgen encoder
with fixed seeds), so any checkout can regenerate the exact bytes.  The
pure-Python encoder is slow at 1080p (minutes per stream), so the streams the
smoke test needs are committed under streams/ with a sha256 manifest, and
get_stream reads them from there.  Any other stream is generated on first use
and cached under .stream_cache/ in the checkout.

Usage: python tools/make_streams.py [name ...]           (default: all)
       python tools/make_streams.py --commit name [...]  (write to streams/)
Names: s1080 (1080p intra), s1080_i0..s1080_i2 (1080p intra, other seeds),
       s1080_ldp4 / s1080_ldp16 (1080p low-delay P), s1080_ra8 (1080p
       random access), s416_ldp4, s832_ldp4, s4k (3840x2160 intra),
       s1080_t8 / s1080_t8w (1080p intra, 4x2 tiles, with WPP).
"""
from __future__ import annotations

import hashlib
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED_DIR = os.path.join(REPO, "streams")
MANIFEST = os.path.join(TRACKED_DIR, "SHA256SUMS")
CACHE_DIR = os.path.join(REPO, ".stream_cache")


def _enc(w, h, qp=32, **kw):
    from p265_tpu.hls.params import PPS, SPS
    from p265_tpu.testgen.encoder import Encoder
    sps = SPS(pic_width=w, pic_height=h)
    pps = PPS(init_qp=qp, sign_data_hiding=True)
    return Encoder(sps, pps, qp=qp, **kw), sps, pps


def _intra(w, h, seed=3, qp=32, **pps_kw):
    from p265_tpu.hls.params import PPS, SPS
    from p265_tpu.testgen.encoder import IntraEncoder, make_test_image
    sps = SPS(pic_width=w, pic_height=h)
    pps = PPS(init_qp=qp, sign_data_hiding=True, **pps_kw)
    img = make_test_image(w, h, seed)
    stream, _, _ = IntraEncoder(sps, pps, qp=qp, seed=seed).encode_frame(img)
    return stream


def _gop(w, h, n, structure, seed=5, qp=32):
    from p265_tpu.testgen.encoder import make_moving_sequence
    enc, sps, pps = _enc(w, h, qp=qp, seed=seed)
    frames = make_moving_sequence(w, h, n, seed=seed)
    stream, _ = enc.encode_sequence(frames, structure)
    return stream


GENERATORS = {
    "s1080": lambda: _intra(1920, 1080),
    "s1080_i0": lambda: _intra(1920, 1080, seed=0),
    "s1080_i1": lambda: _intra(1920, 1080, seed=1),
    "s1080_i2": lambda: _intra(1920, 1080, seed=2),
    "s1080_ldp4": lambda: _gop(1920, 1080, 4, "LDP"),
    "s1080_ldp16": lambda: _gop(1920, 1080, 16, "LDP"),
    "s1080_ra8": lambda: _gop(1920, 1080, 8, "RA"),
    "s416_ldp4": lambda: _gop(416, 240, 4, "LDP"),
    "s832_ldp4": lambda: _gop(832, 480, 4, "LDP"),
    "s4k": lambda: _intra(3840, 2160),
    "s1080_t8": lambda: _intra(1920, 1080, tiles_enabled=True,
                               num_tile_columns=4, num_tile_rows=2),
    "s1080_t8w": lambda: _intra(1920, 1080, tiles_enabled=True,
                                num_tile_columns=4, num_tile_rows=2,
                                entropy_coding_sync_enabled=True),
}


def read_manifest(path: str = MANIFEST) -> dict:
    """sha256sum-format manifest -> {file name: hex digest}."""
    if not os.path.exists(path):
        return {}
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                digest, fn = line.split()
                out[fn] = digest
    return out


def stream_path(name: str) -> str:
    fn = name + ".265"
    if fn in read_manifest():
        return os.path.join(TRACKED_DIR, fn)
    return os.path.join(CACHE_DIR, fn)


def get_stream(name: str) -> bytes:
    """Load the named stream: the committed copy (sha256-checked) if there
    is one, else the cached copy, else generate and cache it."""
    fn = name + ".265"
    digest = read_manifest().get(fn)
    if digest is not None:
        with open(os.path.join(TRACKED_DIR, fn), "rb") as f:
            data = f.read()
        got = hashlib.sha256(data).hexdigest()
        if got != digest:
            raise ValueError(f"{fn}: sha256 {got} does not match the "
                             f"manifest ({digest})")
        return data
    p = os.path.join(CACHE_DIR, fn)
    if os.path.exists(p):
        with open(p, "rb") as f:
            return f.read()
    data = _generate(name)
    _write(p, data)
    return data


def _generate(name: str) -> bytes:
    t0 = time.perf_counter()
    data = GENERATORS[name]()
    print(f"[make_streams] {name}: {len(data)} bytes in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return data


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def commit(names: list) -> None:
    """Generate the named streams into streams/ and update the manifest."""
    sums = read_manifest()
    for name in names:
        data = _generate(name)
        _write(os.path.join(TRACKED_DIR, name + ".265"), data)
        sums[name + ".265"] = hashlib.sha256(data).hexdigest()
    with open(MANIFEST, "w") as f:
        for fn in sorted(sums):
            f.write(f"{sums[fn]}  {fn}\n")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    args = sys.argv[1:]
    if args[:1] == ["--commit"]:
        commit(args[1:])
    else:
        for name in args or list(GENERATORS):
            get_stream(name)
