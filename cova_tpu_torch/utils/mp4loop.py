"""Looping MP4 re-muxer for long-stream soak testing.

Builds an N-times-longer MP4 from a source clip by writing the source
samples once into a fresh mdat and repeating the sample table N times
with shifted timestamps — every repetition's chunk offsets point at the
same mdat bytes, so a 30-minute soak stream costs the same disk as the
1-minute source. The reference validates long-run behavior by running
days of real camera footage (the reference's parse/config.yaml
multi-day datasets); offline, looping the bundled demo is the
equivalent stressor for GoP-cache eviction, aggregator growth and
selector flush (cova_tpu/csrc/api.cc kGopCacheCap,
aggregator/associator.py, scheduler/selector.py).

Only the features the in-repo demuxer consumes are written: one video
trak, stts/ctts/stss/stsc/stsz/stco sample tables and the source's
stsd (codec config) verbatim.
"""

from __future__ import annotations

import struct


def _boxes(buf: bytes, start: int = 0, end: int | None = None):
    """Iterate (type, payload_start, payload_end) over top-level boxes."""
    end = len(buf) if end is None else end
    pos = start
    while pos + 8 <= end:
        size = struct.unpack(">I", buf[pos : pos + 4])[0]
        typ = buf[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", buf[pos + 8 : pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr:
            break
        yield typ, pos + hdr, pos + size
        pos += size


def _find(buf: bytes, path: list[bytes], start: int = 0, end: int | None = None):
    """Payload range of the first box at the given nested path."""
    cur = [(start, len(buf) if end is None else end)]
    for name in path:
        nxt = None
        for s, e in cur:
            for typ, ps, pe in _boxes(buf, s, e):
                if typ == name:
                    nxt = (ps, pe)
                    break
            if nxt:
                break
        if nxt is None:
            return None
        cur = [nxt]
    return cur[0]


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(typ, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def _rle(values):
    """(count, value) run-length pairs."""
    out = []
    for v in values:
        if out and out[-1][1] == v:
            out[-1][0] += 1
        else:
            out.append([1, v])
    return out


def _avc1_stsd(width: int, height: int, avcc: bytes) -> bytes:
    """Build an stsd box with one avc1 entry wrapping the avcC blob."""
    avc1 = (
        b"\0" * 6
        + struct.pack(">H", 1)  # data_reference_index
        + b"\0" * 16
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x480000, 0x480000)  # 72 dpi
        + b"\0" * 4
        + struct.pack(">H", 1)  # frame count
        + b"\0" * 32  # compressor name
        + struct.pack(">Hh", 0x18, -1)  # depth, color table
        + _box(b"avcC", avcc)
    )
    return _full(b"stsd", 0, 0, struct.pack(">I", 1) + _box(b"avc1", avc1))


def _annexb_to_avcc(payload: bytes) -> tuple[bytes, list[bytes], list[bytes]]:
    """Convert an Annex-B AU to 4-byte length-prefixed NALs, extracting
    SPS (type 7) and PPS (type 8) along the way. Trailing zero bytes of
    each segment belong to the next 4-byte start code (a NAL cannot end
    in 0x00 — rbsp_trailing_bits ends with a 1 bit)."""
    nals = []
    sps, pps = [], []
    segs = payload.split(b"\x00\x00\x01")
    for k, seg in enumerate(segs):
        if k == 0:
            continue  # bytes before the first start code (usually empty)
        nal = seg.rstrip(b"\x00") if k + 1 < len(segs) else seg
        if not nal:
            continue
        t = nal[0] & 0x1F
        if t == 7:
            sps.append(nal)
        elif t == 8:
            pps.append(nal)
        nals.append(nal)
    out = b"".join(struct.pack(">I", len(x)) + x for x in nals)
    return out, sps, pps


def _avcc_box(sps: list[bytes], pps: list[bytes]) -> bytes:
    s0 = sps[0]
    out = bytearray([1, s0[1] if len(s0) > 1 else 0,
                     s0[2] if len(s0) > 2 else 0,
                     s0[3] if len(s0) > 3 else 0, 0xFF,
                     0xE0 | len(sps)])
    for s in sps:
        out += struct.pack(">H", len(s)) + s
    out.append(len(pps))
    for p in pps:
        out += struct.pack(">H", len(p)) + p
    return bytes(out)


def write_mp4(
    dst_path: str,
    samples: list[tuple[bytes, int, int, bool]],  # (avcc payload, pts, dts, key)
    timescale: int,
    width: int,
    height: int,
    avcc: bytes,
) -> None:
    """Write a single-video-track MP4 from length-prefixed samples."""
    dts = [s[2] for s in samples]
    deltas = [dts[i + 1] - dts[i] for i in range(len(dts) - 1)]
    deltas.append(deltas[-1] if deltas else 3003)
    cto = [s[1] - s[2] for s in samples]
    shift = -min(0, min(cto)) if cto else 0
    cto = [c + shift for c in cto]
    duration = sum(deltas)

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")
    mdat_payload = b"".join(s[0] for s in samples)
    mdat = _box(b"mdat", mdat_payload)
    data_off = len(ftyp) + 8
    offsets = []
    pos = data_off
    for s in samples:
        offsets.append(pos)
        pos += len(s[0])

    total = len(samples)
    stts = _rle(deltas)
    stts_box = _full(
        b"stts", 0, 0,
        struct.pack(">I", len(stts))
        + b"".join(struct.pack(">II", c, v) for c, v in stts),
    )
    ctts = _rle(cto)
    ctts_box = _full(
        b"ctts", 0, 0,
        struct.pack(">I", len(ctts))
        + b"".join(struct.pack(">II", c, v) for c, v in ctts),
    )
    sync = [i + 1 for i, s in enumerate(samples) if s[3]]
    stss_box = _full(
        b"stss", 0, 0,
        struct.pack(">I", len(sync)) + b"".join(struct.pack(">I", x) for x in sync),
    )
    stsc_box = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz_box = _full(
        b"stsz", 0, 0,
        struct.pack(">II", 0, total)
        + b"".join(struct.pack(">I", len(s[0])) for s in samples),
    )
    stco_box = _full(
        b"stco", 0, 0,
        struct.pack(">I", total) + b"".join(struct.pack(">I", o) for o in offsets),
    )
    stbl = _box(
        b"stbl",
        _avc1_stsd(width, height, avcc) + stts_box + ctts_box + stss_box
        + stsc_box + stsz_box + stco_box,
    )
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1) + _full(b"url ", 0, 1, b""))
    minf = _box(b"minf", vmhd + _box(b"dinf", dref) + stbl)
    hdlr = _full(
        b"hdlr", 0, 0,
        struct.pack(">I", 0) + b"vide" + b"\0" * 12 + b"cova reencode\0",
    )
    mdhd = _full(
        b"mdhd", 0, 0,
        struct.pack(">IIIIHH", 0, 0, timescale, duration & 0xFFFFFFFF,
                    0x55C4, 0),
    )
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(
        b"tkhd", 0, 7,
        struct.pack(">IIIII", 0, 0, 1, 0, duration & 0xFFFFFFFF)
        + b"\0" * 8
        + struct.pack(">hhhh", 0, 0, 0, 0)
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", width << 16, height << 16),
    )
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, timescale, duration & 0xFFFFFFFF)
        + struct.pack(">IH", 0x00010000, 0x0100)
        + b"\0" * 10
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\0" * 24
        + struct.pack(">I", 2),
    )
    moov = _box(b"moov", mvhd + trak)
    with open(dst_path, "wb") as f:
        f.write(ftyp)
        f.write(mdat)
        f.write(moov)


def mux_rec_to_mp4(rec_path: str, dst_path: str) -> int:
    """Mux the output of csrc/tools/reencode (Annex-B packet records)
    into an MP4; returns the sample count. SPS/PPS are lifted out of the
    first AUs into avcC (and kept in-band too — harmless)."""
    samples = []
    all_sps: list[bytes] = []
    all_pps: list[bytes] = []
    with open(rec_path, "rb") as f:
        width, height, timescale, edlen = struct.unpack("<IIII", f.read(16))
        f.read(edlen)
        while True:
            hdr = f.read(20)
            if len(hdr) < 20:
                break
            size, pts, dts = struct.unpack("<Iqq", hdr)
            key = f.read(1)[0]
            payload = f.read(size)
            avcc_payload, sps, pps = _annexb_to_avcc(payload)
            for s in sps:
                if s not in all_sps:
                    all_sps.append(s)
            for p in pps:
                if p not in all_pps:
                    all_pps.append(p)
            samples.append((avcc_payload, pts, dts, key == 1))
    if not all_sps or not all_pps:
        raise ValueError("no SPS/PPS found in re-encoded stream")
    # dts must be monotonically increasing from 0 in the sample table.
    d0 = samples[0][2]
    samples = [(p, pts - d0, dts - d0, k) for p, pts, dts, k in samples]
    write_mp4(
        dst_path, samples, timescale, width, height,
        _avcc_box(all_sps, all_pps),
    )
    return len(samples)


def write_looped_mp4(src_path: str, dst_path: str, reps: int) -> int:
    """Write `dst_path` = `src_path`'s video track repeated `reps` times
    (timestamps shifted per repetition; same encoded bytes). Returns the
    total sample count."""
    from cova_tpu_torch.codec import Mp4Demuxer

    src = open(src_path, "rb").read()
    stsd = _find(src, [b"moov", b"trak", b"mdia", b"minf", b"stbl", b"stsd"])
    if stsd is None:
        raise ValueError("source has no stsd box")
    # Source stsd payload (version/flags + avc1 + avcC) kept verbatim.
    stsd_box = (
        struct.pack(">I", 8 + (stsd[1] - stsd[0]))
        + b"stsd"
        + src[stsd[0] : stsd[1]]
    )

    d = Mp4Demuxer(src_path)
    n = d.num_samples
    infos = [d.sample(i) for i in range(n)]
    payloads = [d.read_sample(i) for i in range(n)]
    timescale = d.timescale
    width, height = d.width, d.height
    d.close()

    dts = [s.dts for s in infos]
    deltas = [dts[i + 1] - dts[i] for i in range(n - 1)]
    last_delta = deltas[-1] if deltas else 3003
    deltas.append(last_delta)
    period = dts[-1] - dts[0] + last_delta  # shift per repetition

    # Composition offsets must be non-negative for ctts version 0.
    cto = [s.pts - s.dts for s in infos]
    shift = -min(0, min(cto)) if cto else 0
    cto = [c + shift for c in cto]

    # ---- layout: ftyp, mdat (samples once, back to back), moov -------
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")
    mdat_payload = b"".join(payloads)
    mdat = _box(b"mdat", mdat_payload)
    mdat_data_off = len(ftyp) + 8  # offset of first sample byte

    offsets = []
    pos = mdat_data_off
    for p in payloads:
        offsets.append(pos)
        pos += len(p)

    total = n * reps
    duration = period * reps

    stts = _rle(deltas * reps)
    stts_box = _full(
        b"stts", 0, 0,
        struct.pack(">I", len(stts))
        + b"".join(struct.pack(">II", c, v) for c, v in stts),
    )
    ctts = _rle(cto * reps)
    ctts_box = _full(
        b"ctts", 0, 0,
        struct.pack(">I", len(ctts))
        + b"".join(struct.pack(">II", c, v) for c, v in ctts),
    )
    sync = [
        r * n + i + 1 for r in range(reps) for i in range(n) if infos[i].keyframe
    ]
    stss_box = _full(
        b"stss", 0, 0,
        struct.pack(">I", len(sync)) + b"".join(struct.pack(">I", s) for s in sync),
    )
    stsc_box = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz_box = _full(
        b"stsz", 0, 0,
        struct.pack(">II", 0, total)
        + b"".join(struct.pack(">I", len(p)) for p in payloads) * reps,
    )
    stco_box = _full(
        b"stco", 0, 0,
        struct.pack(">I", total)
        + b"".join(struct.pack(">I", o) for o in offsets) * reps,
    )
    stbl = _box(
        b"stbl", stsd_box + stts_box + ctts_box + stss_box + stsc_box
        + stsz_box + stco_box,
    )
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1) + _full(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", vmhd + dinf + stbl)
    hdlr = _full(
        b"hdlr", 0, 0,
        struct.pack(">I", 0) + b"vide" + b"\0" * 12 + b"cova looped\0",
    )
    mdhd = _full(
        b"mdhd", 0, 0,
        struct.pack(">IIIIHH", 0, 0, timescale, duration & 0xFFFFFFFF, 0x55C4, 0),
    )
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(
        b"tkhd", 0, 7,
        struct.pack(">IIIII", 0, 0, 1, 0, duration & 0xFFFFFFFF)
        + b"\0" * 8
        + struct.pack(">hhhh", 0, 0, 0, 0)
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", width << 16, height << 16),
    )
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, timescale, duration & 0xFFFFFFFF)
        + struct.pack(">IH", 0x00010000, 0x0100)
        + b"\0" * 10
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\0" * 24
        + struct.pack(">I", 2),
    )
    moov = _box(b"moov", mvhd + trak)

    with open(dst_path, "wb") as f:
        f.write(ftyp)
        f.write(mdat)
        f.write(moov)
    return total
