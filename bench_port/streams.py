"""The job streams: a recorded clip with its GoPs rotated.

`read_mp4` reads a single-video-track MP4's sample table (the boxes the
committed renders carry); `write_rotated` writes the same samples with
the GoPs in the order r, r+1, ..., n-1, 0, ..., r-1 and the timestamps
of each GoP shifted to its new place, the codec configuration (stsd)
verbatim. Every GoP of the committed renders opens with an in-band SPS,
PPS and IDR picture and no picture refers across a GoP, so a rotated
stream decodes to the same pictures, each GoP to its own.

`Rotation` maps the rotated stream's presentation times back to the
source's, so a check can look up what the source says of a frame.
"""

from __future__ import annotations

import dataclasses
import struct


@dataclasses.dataclass(frozen=True)
class Sample:
    offset: int
    size: int
    dts: int
    pts: int
    key: bool


@dataclasses.dataclass
class Mp4:
    data: bytes
    timescale: int
    stsd: bytes  # the whole stsd box, header included
    samples: list
    width: int
    height: int

    def gops(self) -> list[list[int]]:
        """Sample indices, one list a GoP (each opens at a sync sample)."""
        out: list[list[int]] = []
        for i, s in enumerate(self.samples):
            if s.key or not out:
                out.append([])
            out[-1].append(i)
        return out


def _boxes(buf, start, end):
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack(">I4s", buf[pos : pos + 8])
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", buf[pos + 8 : pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr:
            raise ValueError("malformed MP4 box")
        yield typ, pos, pos + hdr, pos + size
        pos += size


def _child(buf, span, name):
    for typ, b0, p0, p1 in _boxes(buf, *span):
        if typ == name:
            return b0, p0, p1
    return None


def _path(buf, names):
    span = (0, len(buf))
    for n in names:
        hit = _child(buf, span, n)
        if hit is None:
            return None
        span = hit[1:]
    return hit


def _table(buf, hit, fmt, skip=8):
    """Entries of a full box's table: count at payload+4, entries after."""
    _, p0, _ = hit
    (n,) = struct.unpack(">I", buf[p0 + 4 : p0 + 8])
    w = struct.calcsize(fmt)
    base = p0 + skip
    return [struct.unpack(fmt, buf[base + i * w : base + (i + 1) * w]) for i in range(n)]


def read_mp4(path) -> Mp4:
    buf = open(path, "rb").read()
    stbl = ("moov", "trak", "mdia", "minf", "stbl")
    at = lambda *n: _path(buf, [x.encode() for x in (*stbl, *n)])
    mdhd = _path(buf, [b"moov", b"trak", b"mdia", b"mdhd"])
    version = buf[mdhd[1]]
    ts_off = mdhd[1] + (20 if version == 1 else 12)
    (timescale,) = struct.unpack(">I", buf[ts_off : ts_off + 4])
    tkhd = _path(buf, [b"moov", b"trak", b"tkhd"])
    width = struct.unpack(">I", buf[tkhd[2] - 8 : tkhd[2] - 4])[0] >> 16
    height = struct.unpack(">I", buf[tkhd[2] - 4 : tkhd[2]])[0] >> 16

    stsz = at("stsz")
    p0 = stsz[1]
    fixed, count = struct.unpack(">II", buf[p0 + 4 : p0 + 12])
    sizes = ([fixed] * count if fixed else
             list(struct.unpack(f">{count}I", buf[p0 + 12 : p0 + 12 + 4 * count])))
    co = at("stco")
    offs = ([o for (o,) in _table(buf, co, ">I")] if co else
            [o for (o,) in _table(buf, at("co64"), ">Q")])
    stsc = _table(buf, at("stsc"), ">III")
    offsets = []
    for ci, chunk_off in enumerate(offs):
        per = next(n for first, n, _ in reversed(stsc) if first <= ci + 1)
        pos = chunk_off
        for _ in range(per):
            if len(offsets) == count:
                break
            offsets.append(pos)
            pos += sizes[len(offsets) - 1]
    dts, t = [], 0
    for n, delta in _table(buf, at("stts"), ">II"):
        for _ in range(n):
            dts.append(t)
            t += delta
    cto = [0] * count
    if at("ctts"):
        i = 0
        for n, off in _table(buf, at("ctts"), ">Ii"):
            for _ in range(n):
                cto[i] = off
                i += 1
    keys = set(range(count))
    if at("stss"):
        keys = {k - 1 for (k,) in _table(buf, at("stss"), ">I")}
    stsd = at("stsd")
    samples = [Sample(offsets[i], sizes[i], dts[i], dts[i] + cto[i], i in keys)
               for i in range(count)]
    return Mp4(buf, timescale, buf[stsd[0] : stsd[2]], samples, width, height)


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, payload: bytes, flags: int = 0) -> bytes:
    return _box(typ, struct.pack(">I", flags) + payload)


def _rle(values):
    out: list[list[int]] = []
    for v in values:
        if out and out[-1][1] == v:
            out[-1][0] += 1
        else:
            out.append([1, v])
    return out


@dataclasses.dataclass(frozen=True)
class Rotation:
    """The rotated stream's pts -> the source's pts."""

    to_source: dict

    def source_pts(self, pts: int) -> int:
        return self.to_source[pts]


def write_rotated(src: Mp4, dst_path, rot: int) -> Rotation:
    """Write `src` with its GoPs rotated by `rot` to dst_path."""
    gops = src.gops()
    rot %= len(gops)
    order = gops[rot:] + gops[:rot]
    s = src.samples
    deltas = [s[i + 1].dts - s[i].dts for i in range(len(s) - 1)]
    deltas.append(deltas[-1] if deltas else 1)
    new, to_source, t = [], {}, 0
    for g in order:
        shift = t - s[g[0]].dts
        for i in g:
            new.append((s[i], s[i].dts + shift, s[i].pts + shift))
            to_source[s[i].pts + shift] = s[i].pts
        t = s[g[-1]].dts + shift + deltas[g[-1]]
    mdat = b"".join(src.data[x.offset : x.offset + x.size] for x, _, _ in new)
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")
    off = len(ftyp) + 8
    offsets = []
    for x, _, _ in new:
        offsets.append(off)
        off += x.size
    n = len(new)
    dts = [d for _, d, _ in new]
    d2 = [dts[i + 1] - dts[i] for i in range(n - 1)] + [deltas[-1]]
    cto = [p - d for _, d, p in new]
    tbl = lambda pairs: struct.pack(">I", len(pairs)) + b"".join(
        struct.pack(">II", c, v) for c, v in pairs)
    sync = [i + 1 for i, (x, _, _) in enumerate(new) if x.key]
    stbl = _box(b"stbl", src.stsd
                + _full(b"stts", tbl(_rle(d2)))
                + _full(b"ctts", tbl(_rle(cto)))
                + _full(b"stss", struct.pack(">I", len(sync))
                        + b"".join(struct.pack(">I", k) for k in sync))
                + _full(b"stsc", struct.pack(">IIII", 1, 1, 1, 1))
                + _full(b"stsz", struct.pack(">II", 0, n)
                        + b"".join(struct.pack(">I", x.size) for x, _, _ in new))
                + _full(b"stco", struct.pack(">I", n)
                        + b"".join(struct.pack(">I", o) for o in offsets)))
    duration = sum(d2)
    matrix = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    minf = _box(b"minf", _full(b"vmhd", b"\0" * 8, 1)
                + _box(b"dinf", _full(b"dref", struct.pack(">I", 1)
                                      + _full(b"url ", b"", 1)))
                + stbl)
    mdia = _box(b"mdia", _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, src.timescale,
                                                    duration, 0x55C4, 0))
                + _full(b"hdlr", struct.pack(">I", 0) + b"vide" + b"\0" * 12
                        + b"rotated\0")
                + minf)
    tkhd = _full(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, duration) + b"\0" * 8
                 + struct.pack(">hhhh", 0, 0, 0, 0) + matrix
                 + struct.pack(">II", src.width << 16, src.height << 16), 7)
    mvhd = _full(b"mvhd", struct.pack(">IIII", 0, 0, src.timescale, duration)
                 + struct.pack(">IH", 0x00010000, 0x0100) + b"\0" * 10 + matrix
                 + b"\0" * 24 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + _box(b"trak", tkhd + mdia))
    with open(dst_path, "wb") as f:
        f.write(ftyp)
        f.write(_box(b"mdat", mdat))
        f.write(moov)
    return Rotation(to_source)
