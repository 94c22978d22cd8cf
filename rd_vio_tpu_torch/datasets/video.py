"""Minimal ISO-BMFF (QuickTime .mov / .mp4) video I/O, dependency-free.

Port of the JAX package's datasets/video.py (NumPy and PIL, no device
work). Behavioral reference: examples/dataset.hpp:830-1109 — the
reference's ADVIO reader streams `frames.mov` through cv::VideoCapture. This
environment has no OpenCV/ffmpeg, so the container is parsed from scratch:

  MovReader      walks the box tree (moov/trak/mdia/minf/stbl), rebuilds the
                 sample table (stsd codec, stts timestamps, stsc/stco chunk
                 map, stsz sizes) and yields per-frame compressed samples.
                 Motion-JPEG tracks ('jpeg'/'mjpa'/'mjpb'/'MJPG') decode via
                 PIL; other codecs (ADVIO ships H.264 'avc1') raise with the
                 documented one-time extraction step.
  write_mjpeg_mov  the matching muxer: packs JPEG frames into a spec-valid
                 single-track MJPEG .mov (used by the ADVIO e2e test and as
                 a debug-sequence dumper).

The sample-table layout implemented here is ISO/IEC 14496-12 §8.5-8.7.
"""

from __future__ import annotations

import io
import os
import struct
from typing import List, Tuple

import numpy as np

MJPEG_FOURCCS = {b"jpeg", b"mjpa", b"mjpb", b"MJPG", b"AVDJ", b"dmb1"}

EXTRACT_HINT = (
    "codec {codec!r} needs an external decoder; extract frames once with\n"
    "  ffmpeg -i {path} -vsync 0 iphone/frames/%06d.png\n"
    "and the reader will pick up the frames/ directory automatically"
)


# ---------------------------------------------------------------------------
# box-tree walking
# ---------------------------------------------------------------------------

def _iter_boxes(buf: memoryview, start: int, end: int):
    """Yield (type, payload_start, payload_end) for the boxes in [start, end)."""
    off = start
    while off + 8 <= end:
        size = struct.unpack_from(">I", buf, off)[0]
        btype = bytes(buf[off + 4:off + 8])
        payload = off + 8
        if size == 1:  # 64-bit largesize
            size = struct.unpack_from(">Q", buf, off + 8)[0]
            payload = off + 16
        elif size == 0:  # to end of enclosing box
            size = end - off
        if size < 8 or off + size > end:
            break  # malformed/truncated trailer — stop cleanly
        yield btype, payload, off + size
        off += size


def _find(buf, start, end, *path):
    """Descend a chain of container boxes; returns (payload_start, payload_end)
    of the first match or None."""
    if not path:
        return start, end
    for btype, p0, p1 in _iter_boxes(buf, start, end):
        if btype == path[0]:
            return _find(buf, p0, p1, *path[1:])
    return None


def _find_all(buf, start, end, btype):
    return [(p0, p1) for t, p0, p1 in _iter_boxes(buf, start, end) if t == btype]


class MovReader:
    """Sample-level reader for one video track of a .mov/.mp4 file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self._data = data
        buf = memoryview(data)

        moov = _find(buf, 0, len(buf), b"moov")
        if moov is None:
            raise ValueError(f"{path}: no moov box (not a MOV/MP4 file)")

        track = self._pick_video_track(buf, *moov)
        if track is None:
            raise ValueError(f"{path}: no video ('vide' handler) track")
        stbl, timescale = track

        self.codec, self.width, self.height = self._parse_stsd(buf, *stbl)
        sizes = self._parse_stsz(buf, *stbl)
        offsets = self._chunk_offsets(buf, *stbl)
        stsc = self._parse_stsc(buf, *stbl)
        self._samples = self._build_sample_map(sizes, offsets, stsc)
        self.timestamps = self._parse_stts(buf, *stbl, timescale=timescale,
                                           n=len(self._samples))

    # -- track selection -------------------------------------------------
    @staticmethod
    def _pick_video_track(buf, m0, m1):
        for t0, t1 in _find_all(buf, m0, m1, b"trak"):
            mdia = _find(buf, t0, t1, b"mdia")
            if mdia is None:
                continue
            hdlr = _find(buf, *mdia, b"hdlr")
            if hdlr is None:
                continue
            # FullBox(4) + pre_defined(4) + handler_type(4)
            handler = bytes(buf[hdlr[0] + 8:hdlr[0] + 12])
            if handler != b"vide":
                continue
            mdhd = _find(buf, *mdia, b"mdhd")
            version = buf[mdhd[0]]
            timescale = struct.unpack_from(
                ">I", buf, mdhd[0] + (20 if version == 1 else 12))[0]
            stbl = _find(buf, *mdia, b"minf", b"stbl")
            if stbl is None:
                continue
            return stbl, timescale
        return None

    # -- sample-table boxes ------------------------------------------------
    @staticmethod
    def _parse_stsd(buf, s0, s1):
        box = _find(buf, s0, s1, b"stsd")
        p = box[0] + 8  # FullBox + entry_count
        entry_size = struct.unpack_from(">I", buf, p)[0]
        codec = bytes(buf[p + 4:p + 8])
        # VisualSampleEntry: +8 hdr, +6 reserved, +2 dref idx, +16 predefined
        w, h = struct.unpack_from(">HH", buf, p + 32)
        return codec, w, h

    @staticmethod
    def _parse_stsz(buf, s0, s1):
        box = _find(buf, s0, s1, b"stsz")
        fixed, count = struct.unpack_from(">II", buf, box[0] + 4)
        if fixed:
            return [fixed] * count
        return list(struct.unpack_from(f">{count}I", buf, box[0] + 12))

    @staticmethod
    def _chunk_offsets(buf, s0, s1):
        box = _find(buf, s0, s1, b"stco")
        fmt = "I"
        if box is None:
            box = _find(buf, s0, s1, b"co64")
            fmt = "Q"
        count = struct.unpack_from(">I", buf, box[0] + 4)[0]
        return list(struct.unpack_from(f">{count}{fmt}", buf, box[0] + 8))

    @staticmethod
    def _parse_stsc(buf, s0, s1):
        box = _find(buf, s0, s1, b"stsc")
        count = struct.unpack_from(">I", buf, box[0] + 4)[0]
        vals = struct.unpack_from(f">{3 * count}I", buf, box[0] + 8)
        return [tuple(vals[3 * i:3 * i + 3]) for i in range(count)]

    @staticmethod
    def _parse_stts(buf, s0, s1, timescale, n):
        box = _find(buf, s0, s1, b"stts")
        count = struct.unpack_from(">I", buf, box[0] + 4)[0]
        ts, t = [], 0
        for i in range(count):
            num, delta = struct.unpack_from(">II", buf, box[0] + 8 + 8 * i)
            for _ in range(num):
                ts.append(t / timescale)
                t += delta
        return np.asarray(ts[:n])

    @staticmethod
    def _build_sample_map(sizes, chunk_offsets, stsc) -> List[Tuple[int, int]]:
        """(file_offset, size) per sample via the sample-to-chunk table."""
        n_chunks = len(chunk_offsets)
        spc = [0] * n_chunks  # samples per chunk
        for i, (first, per, _) in enumerate(stsc):
            last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else n_chunks
            for c in range(first - 1, last):
                spc[c] = per
        samples, si = [], 0
        for c in range(n_chunks):
            off = chunk_offsets[c]
            for _ in range(spc[c]):
                if si >= len(sizes):
                    break
                samples.append((off, sizes[si]))
                off += sizes[si]
                si += 1
        return samples

    # -- public API --------------------------------------------------------
    def __len__(self):
        return len(self._samples)

    def sample(self, idx: int) -> bytes:
        off, size = self._samples[idx]
        return self._data[off:off + size]

    def decode(self, idx: int) -> np.ndarray:
        """Grayscale float32 frame (MJPEG tracks only)."""
        if self.codec not in MJPEG_FOURCCS:
            raise NotImplementedError(
                EXTRACT_HINT.format(codec=self.codec.decode("latin1"),
                                    path=self.path))
        from PIL import Image

        img = Image.open(io.BytesIO(self.sample(idx)))
        return np.asarray(img.convert("L"), dtype=np.float32)


# ---------------------------------------------------------------------------
# muxer
# ---------------------------------------------------------------------------

def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def _full(btype: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return _box(btype, struct.pack(">I", (version << 24) | flags) + payload)


def write_mjpeg_mov(path: str, frames, fps: float = 30.0, quality: int = 90):
    """Write grayscale/uint8 frames as a single-track MJPEG .mov.

    frames: iterable of (H, W) uint8/float arrays (floats clipped to [0,255]).
    """
    from PIL import Image

    jpegs = []
    w = h = None
    for fr in frames:
        a = np.asarray(fr)
        if a.dtype != np.uint8:
            a = np.clip(a, 0, 255).astype(np.uint8)
        h, w = a.shape[:2]
        bio = io.BytesIO()
        Image.fromarray(a).save(bio, format="JPEG", quality=quality)
        jpegs.append(bio.getvalue())
    if not jpegs:
        raise ValueError("no frames")
    n = len(jpegs)
    timescale = 600
    delta = int(round(timescale / fps))
    duration = n * delta

    ftyp = _box(b"ftyp", b"qt  " + struct.pack(">I", 0x200) + b"qt  ")
    # mdat starts right after ftyp; sample offsets are absolute
    mdat_payload = b"".join(jpegs)
    mdat_off = len(ftyp) + 8

    offsets, off = [], mdat_off
    for j in jpegs:
        offsets.append(off)
        off += len(j)

    # --- stbl -----------------------------------------------------------
    compressor = b"Motion JPEG".ljust(32, b"\x00")[:32]
    sample_entry = _box(
        b"jpeg",
        b"\x00" * 6 + struct.pack(">H", 1)          # data_reference_index
        + b"\x00" * 16
        + struct.pack(">HH", w, h)
        + struct.pack(">II", 0x480000, 0x480000)     # 72 dpi
        + b"\x00" * 4
        + struct.pack(">H", 1)                       # frame_count
        + compressor
        + struct.pack(">Hh", 24, -1),                # depth, pre_defined
    )
    stsd = _full(b"stsd", struct.pack(">I", 1) + sample_entry)
    stts = _full(b"stts", struct.pack(">III", 1, n, delta))
    stsc = _full(b"stsc", struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full(b"stsz", struct.pack(">II", 0, n)
                 + struct.pack(f">{n}I", *[len(j) for j in jpegs]))
    stco = _full(b"stco", struct.pack(">I", n)
                 + struct.pack(f">{n}I", *offsets))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)

    # --- minf/mdia/trak/moov ---------------------------------------------
    vmhd = _full(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1)
    dref = _full(b"dref", struct.pack(">I", 1) + _full(b"url ", b"", flags=1))
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", vmhd + dinf + stbl)
    hdlr = _full(b"hdlr", b"\x00" * 4 + b"vide" + b"\x00" * 12 + b"VideoHandler\x00")
    mdhd = _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))
    mdia = _box(b"mdia", mdhd + hdlr + minf)

    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    tkhd = _full(
        b"tkhd",
        struct.pack(">IIIII", 0, 0, 1, 0, duration) + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, 0, 0) + matrix
        + struct.pack(">II", w << 16, h << 16),
        flags=7,
    )
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(
        b"mvhd",
        struct.pack(">IIII", 0, 0, timescale, duration)
        + struct.pack(">IH", 0x10000, 0x100) + b"\x00" * 10 + matrix
        + b"\x00" * 24 + struct.pack(">I", 2),
    )
    moov = _box(b"moov", mvhd + trak)

    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(_box(b"mdat", mdat_payload))
        f.write(moov)
    return os.path.getsize(path)
