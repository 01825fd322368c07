#!/usr/bin/env python3
"""Minimal H.264 CABAC *encoder* (9.3.4) for validation streams.

PURPOSE: paff_gen.py can only emit CAVLC field pictures, leaving
CABAC-mode PAFF with no first-party stream source (x264 cannot emit
PAFF at all). This module is the missing piece: a spec-faithful CABAC
arithmetic encoder plus the context bookkeeping for a deliberately
small macroblock menu (cbp=0 everywhere, I_4x4 intra, P/B partitions
with explicit MVDs, skips and direct modes), enough to build conforming
CABAC field-picture slices whose decode can be adjudicated bin-exactly
against libavcodec via the ptrace oracle (csrc/tools/diff_oracle.sh).

Tables: the normative context-init constants (Tables 9-12..9-33) and
the arithmetic engine tables (9-44/9-45) are read from the checked-in
spec-constant headers this directory's extract tools generated —
../cabac_tables.h and ../cabac_engine_tables.h — so encoder and decoder
share one source of truth.

Context-index numbering and neighbor rules mirror the (oracle-
validated) decoder in ../entdec.cc: cabac_mb_skip, cabac_mb_type_*,
cabac_ref_idx, cabac_mvd_pair, cabac_cbp_luma/chroma,
cabac_intra_chroma_mode. The arithmetic core follows 9.3.4.2
(EncodeDecision / EncodeBypass / EncodeTerminate / EncodeFlush with
PutBit's first-bit discard and bit-outstanding accounting).
"""

from __future__ import annotations

import pathlib
import re

_HERE = pathlib.Path(__file__).resolve().parents[2] / "cova_tpu" / "csrc" / "tools"
# The table headers stay with the shared C++ sources in cova_tpu/csrc:
# _HERE names the directory the original module lives in.


def _parse_int_table(text: str, name: str) -> list[int]:
    m = re.search(re.escape(name) + r"[^=]*=\s*\{(.*?)\};", text, re.S)
    assert m, name
    return [int(x) for x in re.findall(r"-?\d+", m.group(1))]


class _Tables:
    _inst = None

    def __init__(self):
        eng = (_HERE.parent / "cabac_engine_tables.h").read_text()
        ini = (_HERE.parent / "cabac_tables.h").read_text()
        flat = _parse_int_table(eng, "kRangeTabLPS")
        assert len(flat) == 64 * 4
        self.lps = [flat[4 * i: 4 * i + 4] for i in range(64)]
        self.trans_lps = _parse_int_table(eng, "kTransIdxLPS")
        assert len(self.trans_lps) == 64
        flat_i = _parse_int_table(ini, "kCabacInitI")
        assert len(flat_i) == 1024 * 2
        self.init_i = [(flat_i[2 * i], flat_i[2 * i + 1]) for i in range(1024)]
        self.sig_field = _parse_int_table(eng, "kSigBaseField")
        self.last_field = _parse_int_table(eng, "kLastBaseField")
        # 8x8-block (ctxBlockCat 5) significance/last ctxIdxInc maps
        # (Table 9-43; the field significance column differs, the last
        # column is shared — mirrors entdec.cc residual_block is8x8).
        self.sig8 = _parse_int_table(eng, "kSigCtx8x8")
        self.last8 = _parse_int_table(eng, "kLastCtx8x8")
        self.sig8_field = _parse_int_table(eng, "kSigCtx8x8Field")
        assert len(self.sig8) == len(self.last8) == 63
        assert len(self.sig8_field) == 63
        flat_pb = _parse_int_table(ini, "kCabacInitPB")
        assert len(flat_pb) == 3 * 1024 * 2
        self.init_pb = [
            [(flat_pb[2 * (k * 1024 + i)], flat_pb[2 * (k * 1024 + i) + 1])
             for i in range(1024)]
            for k in range(3)
        ]

    @classmethod
    def get(cls):
        if cls._inst is None:
            cls._inst = cls()
        return cls._inst


class CabacWriter:
    """Arithmetic encoder over the 1024-context H.264 model."""

    def __init__(self, intra_slice: bool, cabac_init_idc: int, qp: int):
        t = _Tables.get()
        self.t = t
        tab = t.init_i if intra_slice else t.init_pb[cabac_init_idc]
        qpc = min(max(qp, 0), 51)
        self.ctx = []
        for m, n in tab:
            pre = ((m * qpc) >> 4) + n
            pre = min(max(pre, 1), 126)
            if pre <= 63:
                self.ctx.append((63 - pre) << 1)
            else:
                self.ctx.append(((pre - 64) << 1) | 1)
        self.low = 0
        self.range = 510
        self.first_bit = True
        self.outstanding = 0
        self.bits: list[int] = []

    # ---- PutBit (9.3.4.2.4) ----
    def _put(self, b: int):
        if self.first_bit:
            self.first_bit = False
        else:
            self.bits.append(b)
        while self.outstanding:
            self.bits.append(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 0x100:
            if self.low >= 0x200:
                self._put(1)
                self.low -= 0x200
            elif self.low < 0x100:
                self._put(0)
            else:
                self.low -= 0x100
                self.outstanding += 1
            self.low <<= 1
            self.range <<= 1

    # ---- EncodeDecision (9.3.4.2.2) ----
    def decision(self, ctx_idx: int, binval: int):
        v = self.ctx[ctx_idx]
        state, mps = v >> 1, v & 1
        r_lps = self.t.lps[state][(self.range >> 6) & 3]
        self.range -= r_lps
        if binval != mps:
            self.low += self.range
            self.range = r_lps
            if state == 0:
                mps = 1 - mps
            state = self.t.trans_lps[state]
        else:
            # Table 9-45 transIdxMPS == min(state+1, 62)
            state = min(state + 1, 62)
        self.ctx[ctx_idx] = (state << 1) | mps
        self._renorm()

    # ---- EncodeBypass (9.3.4.4... 9.3.4.2 bypass) ----
    def bypass(self, binval: int):
        self.low <<= 1
        if binval:
            self.low += self.range
        if self.low >= 0x400:
            self._put(1)
            self.low -= 0x400
        elif self.low < 0x200:
            self._put(0)
        else:
            self.low -= 0x200
            self.outstanding += 1

    # ---- EncodeTerminate + EncodeFlush ----
    def terminate(self, binval: int):
        self.range -= 2
        if binval:
            self.low += self.range
            # EncodeFlush (9.3.4.2.5); the final written 1 doubles as the
            # rbsp stop bit.
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            v = ((self.low >> 7) & 3) | 1
            self.bits.append((v >> 1) & 1)
            self.bits.append(v & 1)
        else:
            self._renorm()

    # ---- helpers over bins ----
    def bypass_eg(self, k: int, value: int):
        """UEGk suffix: inverse of CabacDecoder::bypass_eg."""
        leading = 0
        while value >= (((1 << (leading + 1)) - 1) << k):
            leading += 1
        for _ in range(leading):
            self.bypass(1)
        self.bypass(0)
        rem = value - ((((1 << leading) - 1)) << k)
        for i in range(leading + k - 1, -1, -1):
            self.bypass((rem >> i) & 1)


class MbModel:
    """Per-MB state the context derivations read (mirror of the MbCtx
    fields the decoder's ctxInc functions touch)."""

    __slots__ = ("skip", "intra", "i16", "pcm", "is_direct16",
                 "chroma_mode", "cbp_luma", "cbp_chroma", "direct_mask",
                 "cbf_luma_dc", "cbf_luma", "cbf_chroma_dc",
                 "cbf_chroma_ac", "ref4", "mvd4", "t8x8")

    def __init__(self):
        self.skip = False
        self.t8x8 = False
        self.intra = False
        self.i16 = False
        self.pcm = False
        self.is_direct16 = False
        self.chroma_mode = 0
        self.cbp_luma = 0
        self.cbp_chroma = 0
        self.direct_mask = 0
        self.cbf_luma_dc = 0  # bit 0: I16 DC coded_block_flag (plane 0)
        self.cbf_luma = 0     # per-4x4 coded_block_flag bits, MB raster
        self.cbf_chroma_dc = 0   # bit c: chroma DC cbf per component
        self.cbf_chroma_ac = [0, 0]  # per-2x2-block cbf bits per comp
        self.ref4 = [[-1] * 16, [-1] * 16]          # [list][cell]
        self.mvd4 = [[(0, 0)] * 16, [(0, 0)] * 16]  # [list][cell]

    def fill(self, list_idx, x0, y0, w, h, ref, mvd):
        for yy in range(y0, y0 + h):
            for xx in range(x0, x0 + w):
                ci = yy * 4 + xx
                self.ref4[list_idx][ci] = ref
                self.mvd4[list_idx][ci] = mvd


class SliceModel:
    """Context bookkeeping for one single-slice picture of W x H MBs."""

    def __init__(self, mb_w: int, mb_h: int):
        self.w = mb_w
        self.h = mb_h
        self.mbs: list[MbModel | None] = [None] * (mb_w * mb_h)

    def at(self, x: int, y: int) -> MbModel | None:
        if x < 0 or y < 0 or x >= self.w or y >= self.h:
            return None
        return self.mbs[y * self.w + x]

    # cell lookup in 4x4 frame coords (mirror of the decoder's accum/flag
    # bounds — out-of-picture cells just return None here).
    def cell_mb(self, cx: int, cy: int) -> MbModel | None:
        if cx < 0 or cy < 0:
            return None
        return self.at(cx >> 2, cy >> 2)


_LISTS = {"l0": (0,), "l1": (1,), "bi": (0, 1), "direct": ()}


class FieldSliceCabac:
    """Encode one single-slice picture's slice_data() in CABAC mode.

    MB menu (cbp = 0 everywhere, mirroring paff_gen's CAVLC specs):
    skip, i4; p16/p16x8/p8x16/p8x8; bdirect, b16 (l0/l1/bi),
    b16x8/b8x16 (kind pairs), b8x8 (subs incl. direct). Context trees
    and neighbor rules mirror ../entdec.cc's oracle-validated decode
    functions bin for bin.
    """

    def __init__(self, mb_w: int, mb_rows: int, slice_type: str, *,
                 nref0: int = 1, nref1: int = 1, qp: int = 26,
                 init_idc: int = 0, field: bool = True,
                 mono: bool = False, t8x8_mode: bool = False):
        self.stype = slice_type
        self.wr = CabacWriter(slice_type == "I", init_idc, qp)
        self.model = SliceModel(mb_w, mb_rows)
        self.nref = (nref0, nref1)
        self.w = mb_w
        self.h = mb_rows
        # field: residual blocks use the Table 9-34 FIELD context rows
        # (the PAFF/MBAFF validation streams); sep_gen.py's progressive
        # separate-colour-plane slices pass field=False.
        self.field = field
        # mono: ChromaArrayType 0 syntax — no intra_chroma_pred_mode,
        # no chroma cbp bins, no chroma residual (each plane of a
        # separate_colour_plane stream parses as monochrome, 7.4.2.1.1).
        self.mono = mono
        # t8x8_mode: PPS transform_8x8_mode_flag is set — every inter MB
        # with CodedBlockPatternLuma != 0 and every I_NxN MB codes
        # transform_size_8x8_flag (ctx 399 + neighbor t8x8 flags,
        # entdec.cc cabac_transform_8x8); coded 8x8s use ctxBlockCat 5.
        self.t8x8_mode = t8x8_mode

    # ---- neighbor context helpers (mirrors of entdec.cc) ----
    def _skip_ctx(self, x, y, b_slice):
        a, b = self.model.at(x - 1, y), self.model.at(x, y - 1)
        inc = (1 if a and not a.skip else 0) + (1 if b and not b.skip else 0)
        return (24 if b_slice else 11) + inc

    def _ref_flag(self, list_idx, cx, cy):
        m = self.model.cell_mb(cx, cy)
        if not m or m.intra:
            return 0
        idx = (cy & 3) * 4 + (cx & 3)
        if m.direct_mask & (1 << idx):
            return 0
        return 1 if m.ref4[list_idx][idx] > 0 else 0

    def _encode_ref(self, list_idx, cx, cy, r):
        ctx = self._ref_flag(list_idx, cx - 1, cy) + \
            2 * self._ref_flag(list_idx, cx, cy - 1)
        c = 54 + ctx
        k = 0
        while k < r:
            self.wr.decision(c, 1)
            k += 1
            c = 54 + (4 if k == 1 else 5)
        self.wr.decision(c, 0)

    def _mvd_accum(self, list_idx, cx, cy):
        s = [0, 0]
        for nx, ny in ((cx - 1, cy), (cx, cy - 1)):
            m = self.model.cell_mb(nx, ny)
            # skip / whole-MB direct correspond to the decoder's
            # `uniform` fills (zero mvd, skipped by its accum).
            if not m or m.intra or m.skip or m.is_direct16:
                continue
            idx = (ny & 3) * 4 + (nx & 3)
            if m.ref4[list_idx][idx] < 0:
                continue
            s[0] += abs(m.mvd4[list_idx][idx][0])
            s[1] += abs(m.mvd4[list_idx][idx][1])
        return s

    def _encode_mvd(self, list_idx, cx, cy, mvd):
        s = self._mvd_accum(list_idx, cx, cy)
        for comp in (0, 1):
            inc = 0 if s[comp] < 3 else (2 if s[comp] > 32 else 1)
            base = 40 if comp == 0 else 47
            av = abs(mvd[comp])
            if av == 0:
                self.wr.decision(base + inc, 0)
                continue
            self.wr.decision(base + inc, 1)
            n = 1
            while n < 9:
                c = base + 2 + min(n, 4)
                if av > n:
                    self.wr.decision(c, 1)
                    n += 1
                else:
                    self.wr.decision(c, 0)
                    break
            if av >= 9:
                self.wr.bypass_eg(3, av - 9)
            self.wr.bypass(1 if mvd[comp] < 0 else 0)

    def _encode_cbp0(self, x, y, cur=None, cbp_luma=0, cbp_chroma=0):
        # coded_block_pattern: 4 luma bins + chroma trailing bins,
        # neighbor contexts exactly as cabac_cbp_luma/cabac_cbp_chroma.
        a, b = self.model.at(x - 1, y), self.model.at(x, y - 1)

        def abit(blk):
            if not a:
                return 1
            if a.pcm:
                return 1
            return (a.cbp_luma >> blk) & 1

        def bbit(blk):
            if not b:
                return 1
            if b.pcm:
                return 1
            return (b.cbp_luma >> blk) & 1

        bits = [(cbp_luma >> i) & 1 for i in range(4)]
        self.wr.decision(73 + (0 if abit(1) else 1) +
                         2 * (0 if bbit(2) else 1), bits[0])
        self.wr.decision(73 + (0 if bits[0] else 1) +
                         2 * (0 if bbit(3) else 1), bits[1])
        self.wr.decision(73 + (0 if abit(3) else 1) +
                         2 * (0 if bits[0] else 1), bits[2])
        self.wr.decision(73 + (0 if bits[2] else 1) +
                         2 * (0 if bits[1] else 1), bits[3])
        if cur is not None:
            cur.cbp_luma = cbp_luma

        if self.mono:
            # ChromaArrayType 0: coded_block_pattern has no chroma part
            # (Table 9-4 gray column / CABAC 9.3.2.6 luma prefix only).
            assert cbp_chroma == 0
            if cur is not None:
                cur.cbp_chroma = 0
            return

        def nz(m):
            if not m:
                return 0
            if m.pcm:
                return 1
            return 1 if m.cbp_chroma != 0 else 0

        def two(m):
            if not m:
                return 0
            if m.pcm:
                return 1
            return 1 if m.cbp_chroma == 2 else 0

        self.wr.decision(77 + nz(a) + 2 * nz(b), 1 if cbp_chroma else 0)
        if cbp_chroma:
            self.wr.decision(81 + two(a) + 2 * two(b),
                             1 if cbp_chroma == 2 else 0)
        if cur is not None:
            cur.cbp_chroma = cbp_chroma

    def _encode_i4(self, x, y, cur, in_p, in_b, mb=None):
        # intra mb_type via the slice-appropriate tree: I_NxN for 'i4',
        # I_16x16 (cbp 0, nonzero DC allowed) for 'i16r'.
        i16 = mb is not None and mb["k"] == "i16r"
        cur.intra = True
        if in_p:
            self.wr.decision(14, 1)
            self.wr.decision(17, 1 if i16 else 0)  # intra suffix base 17
            if i16:
                self.wr.terminate(0)  # not I_PCM
                pred = mb.get("pred", 2)
                cbpc = mb.get("cbpc", 0)
                self.wr.decision(18, 0)            # cbp_luma == 0
                self.wr.decision(19, 1 if cbpc else 0)
                if cbpc:
                    self.wr.decision(19, 1 if cbpc == 2 else 0)
                self.wr.decision(20, (pred >> 1) & 1)
                self.wr.decision(20, pred & 1)
                self._finish_i16(x, y, cur, mb)
                return
        elif in_b:
            a, b = self.model.at(x - 1, y), self.model.at(x, y - 1)
            inc = (1 if a and not a.skip and not a.is_direct16 else 0) + \
                  (1 if b and not b.skip and not b.is_direct16 else 0)
            self.wr.decision(27 + inc, 1)
            self.wr.decision(30, 1)
            for c, v in ((31, 1), (32, 1), (32, 0), (32, 1)):  # bits == 13
                self.wr.decision(c, v)
            self.wr.decision(32, 0)  # intra suffix first bin, base 32
        else:
            a, b = self.model.at(x - 1, y), self.model.at(x, y - 1)
            inc = (1 if a and (a.i16 or a.pcm) else 0) + \
                  (1 if b and (b.i16 or b.pcm) else 0)
            self.wr.decision(3 + inc, 1 if i16 else 0)
            if i16:
                # I-slice I_16x16 suffix: distinct contexts 6,(7,8),(9,10)
                # (cabac_mb_type_i, intra_slice branch).
                self.wr.terminate(0)  # not I_PCM
                pred = mb.get("pred", 2)
                cbpc = mb.get("cbpc", 0)
                self.wr.decision(6, 0)  # cbp_luma == 0
                self.wr.decision(7, 1 if cbpc else 0)
                if cbpc:
                    self.wr.decision(8, 1 if cbpc == 2 else 0)
                self.wr.decision(9, (pred >> 1) & 1)
                self.wr.decision(10, pred & 1)
                self._finish_i16(x, y, cur, mb)
                return
        if self.t8x8_mode:
            # I_NxN codes transform_size_8x8_flag BEFORE the pred modes
            # (7.3.5; our menu keeps 4x4 intra prediction, flag = 0).
            self._encode_t8x8_flag(x, y, cur, False)
        for _ in range(16):
            self.wr.decision(68, 1)  # prev_intra4x4_pred_mode_flag
        if not self.mono:
            self._chroma_dc_mode(x, y)
        self._encode_cbp0(x, y, cur, 0)

    def _encode_t8x8_flag(self, x, y, cur, val: bool):
        a, b = self.model.at(x - 1, y), self.model.at(x, y - 1)
        ctx = (1 if a and a.t8x8 else 0) + (1 if b and b.t8x8 else 0)
        self.wr.decision(399 + ctx, 1 if val else 0)
        cur.t8x8 = val

    def _chroma_dc_mode(self, x, y):
        a, b = self.model.at(x - 1, y), self.model.at(x, y - 1)
        inc = (1 if a and a.intra and not a.pcm and a.chroma_mode != 0 else 0) \
            + (1 if b and b.intra and not b.pcm and b.chroma_mode != 0 else 0)
        self.wr.decision(64 + inc, 0)  # chroma DC

    def _finish_i16(self, x, y, cur, mb):
        """I_16x16 epilogue: chroma mode, mb_qp_delta (always present
        for I_16x16), the mandatory Intra16x16DCLevel block (cat 0,
        field sig/last rows), and AC blocks only if cbp_luma (ours is
        always 0)."""
        cur.i16 = True
        cur.cbp_chroma = mb.get("cbpc", 0)
        if self.mono:
            assert cur.cbp_chroma == 0, \
                "mono I_16x16 mb_type must carry CodedBlockPatternChroma 0"
        else:
            self._chroma_dc_mode(x, y)
        self._encode_qp_delta0()
        inc = self._cbf_ctx_luma_dc(x, y, cur)
        if self._encode_residual(0, 16, inc, mb.get("dc", []), self.field):
            cur.cbf_luma_dc |= 1
        if not self.mono:
            self._encode_chroma_blocks(x, y, cur, cur.cbp_chroma,
                                       mb.get("cdc", {}), mb.get("cac", {}))

    @staticmethod
    def _parts_of(mb):
        """(list_mask, x0, y0, w, h, mvd_per_list, ref_per_list, direct)
        in 4x4 cells, decode order."""
        k = mb["k"]
        M = {"l0": 1, "l1": 2, "bi": 3}
        if k == "p16":
            return [(1, 0, 0, 4, 4, [mb["mvd"]], [mb.get("ref", 0)], False)]
        if k in ("p16x8", "p8x16"):
            refs = mb.get("ref", [0, 0])
            if k == "p16x8":
                geo = [(0, 0, 4, 2), (0, 2, 4, 2)]
            else:
                geo = [(0, 0, 2, 4), (2, 0, 2, 4)]
            return [(1, gx, gy, gw, gh, [mb["mvd"][i]], [refs[i]], False)
                    for i, (gx, gy, gw, gh) in enumerate(geo)]
        if k == "p8x8":
            refs = mb.get("ref", [0, 0, 0, 0])
            return [(1, (i & 1) * 2, (i >> 1) * 2, 2, 2, [mb["mvd"][i]],
                     [refs[i]], False) for i in range(4)]
        if k == "b16":
            lists = _LISTS[mb["kind"]]
            refs = mb.get("ref", [0] * len(lists))
            return [(M[mb["kind"]], 0, 0, 4, 4, mb["mvd"], refs, False)]
        if k in ("b16x8", "b8x16"):
            kinds = mb["kinds"]
            refs = mb.get("ref", [[0] * len(_LISTS[kd]) for kd in kinds])
            if k == "b16x8":
                geo = [(0, 0, 4, 2), (0, 2, 4, 2)]
            else:
                geo = [(0, 0, 2, 4), (2, 0, 2, 4)]
            return [(M[kinds[i]], gx, gy, gw, gh, mb["mvd"][i], refs[i],
                     False)
                    for i, (gx, gy, gw, gh) in enumerate(geo)]
        if k == "b8x8":
            out = []
            refs = mb.get("ref", [[0] * len(_LISTS[kd]) for kd in mb["sub"]])
            for i, kd in enumerate(mb["sub"]):
                bx, by = (i & 1) * 2, (i >> 1) * 2
                if kd == "direct":
                    out.append((3, bx, by, 2, 2, None, None, True))
                else:
                    out.append((M[kd], bx, by, 2, 2, mb["mvd"][i], refs[i],
                                False))
            return out
        raise ValueError(k)

    def _encode_inter(self, x, y, cur, mb, b_slice):
        k = mb["k"]
        w = self.wr
        if not b_slice:
            if k == "p16":
                w.decision(14, 0)
                w.decision(15, 0)
                w.decision(16, 0)
            elif k == "p16x8":
                w.decision(14, 0)
                w.decision(15, 1)
                w.decision(17, 1)
            elif k == "p8x16":
                w.decision(14, 0)
                w.decision(15, 1)
                w.decision(17, 0)
            elif k == "p8x8":
                w.decision(14, 0)
                w.decision(15, 0)
                w.decision(16, 1)
                for _ in range(4):
                    w.decision(21, 1)  # sub_mb_type P_L0_8x8
            else:
                raise ValueError(k)
        else:
            a, b = self.model.at(x - 1, y), self.model.at(x, y - 1)
            inc = (1 if a and not a.skip and not a.is_direct16 else 0) + \
                  (1 if b and not b.skip and not b.is_direct16 else 0)
            if k == "bdirect":
                w.decision(27 + inc, 0)
                cur.is_direct16 = True
                cur.direct_mask = 0xFFFF
                self._encode_cbp0(x, y)
                return
            w.decision(27 + inc, 1)
            btype = {"l0": 1, "l1": 2, "bi": 3}.get(mb.get("kind"))
            if k == "b16" and btype in (1, 2):
                w.decision(30, 0)
                w.decision(32, btype - 1)
            else:
                if k == "b16":
                    bits = 0  # Bi_16x16 -> mb_type 3 -> bits 0
                elif k in ("b16x8", "b8x16"):
                    base = {("l0", "l0"): 4, ("l1", "l1"): 6,
                            ("l0", "l1"): 8, ("l1", "l0"): 10}[mb["kinds"]]
                    t = base + (0 if k == "b16x8" else 1)
                    assert t <= 11, "Bi rectangular pairs need 5-bit codes"
                    bits = 14 if t == 11 else t - 3
                elif k == "b8x8":
                    bits = 15
                else:
                    raise ValueError(k)
                w.decision(30, 1)
                w.decision(31, (bits >> 3) & 1)
                for sh in (2, 1, 0):
                    w.decision(32, (bits >> sh) & 1)
            if k == "b8x8":
                for kd in mb["sub"]:
                    if kd == "direct":
                        w.decision(36, 0)
                    elif kd == "l0":
                        w.decision(36, 1)
                        w.decision(37, 0)
                        w.decision(39, 0)
                    elif kd == "l1":
                        w.decision(36, 1)
                        w.decision(37, 0)
                        w.decision(39, 1)
                    else:  # bi
                        w.decision(36, 1)
                        w.decision(37, 1)
                        w.decision(38, 0)
                        w.decision(39, 0)
                        w.decision(39, 0)

        parts = self._parts_of(mb)
        # direct sub-parts publish their mask before any ref parsing
        # (build_parts_b order).
        for mask, x0, y0, pw, ph, _, _, direct in parts:
            if direct:
                for yy in range(y0, y0 + ph):
                    for xx in range(x0, x0 + pw):
                        cur.direct_mask |= 1 << (yy * 4 + xx)
        # refs: list-major, publish per part (decoder's ref loop).
        for lx in (0, 1):
            for mask, x0, y0, pw, ph, _mvds, refs, direct in parts:
                if direct or not (mask & (1 << lx)):
                    continue
                r = refs[_LISTS_IDX[mask].index(lx)] if isinstance(refs, list) \
                    else refs
                if self.nref[lx] > 1:
                    self._encode_ref(lx, x * 4 + x0, y * 4 + y0, r)
                for yy in range(y0, y0 + ph):
                    for xx in range(x0, x0 + pw):
                        cur.ref4[lx][yy * 4 + xx] = r
        # mvds: list-major, publish per part.
        for lx in (0, 1):
            for mask, x0, y0, pw, ph, mvds, refs, direct in parts:
                if direct or not (mask & (1 << lx)):
                    continue
                mvd = mvds[_LISTS_IDX[mask].index(lx)] if isinstance(
                    mvds[0], (list, tuple)) else mvds
                self._encode_mvd(lx, x * 4 + x0, y * 4 + y0, mvd)
                for yy in range(y0, y0 + ph):
                    for xx in range(x0, x0 + pw):
                        cur.mvd4[lx][yy * 4 + xx] = tuple(mvd)
        cbp = mb.get("cbp", 0)
        cbpc = mb.get("cbpc", 0)
        self._encode_cbp0(x, y, cur, cbp, cbpc)
        if self.t8x8_mode and cbp:
            # Inter MBs code transform_size_8x8_flag after CBP when
            # CodedBlockPatternLuma != 0 (entdec.cc: full &&
            # transform_8x8_mode && !intra_nxn && sub8x8_ok).
            self._encode_t8x8_flag(x, y, cur, bool(mb.get("t8x8")))
        if cbp or cbpc:
            self._encode_qp_delta0()
            self._encode_luma_blocks(x, y, cur, cbp, mb.get("coeffs", {}),
                                     i16=False, coeffs8=mb.get("coeffs8"))
            if not self.mono:
                self._encode_chroma_blocks(x, y, cur, cbpc,
                                           mb.get("cdc", {}), mb.get("cac", {}))

    def encode(self, mbs: list[dict]) -> bytes:
        assert len(mbs) == self.w * self.h
        b_slice = self.stype == "B"
        i_slice = self.stype == "I"
        for i, mb in enumerate(mbs):
            x, y = i % self.w, i // self.w
            cur = MbModel()
            self.model.mbs[i] = cur
            if not i_slice:
                is_skip = mb["k"] == "skip"
                self.wr.decision(self._skip_ctx(x, y, b_slice),
                                 1 if is_skip else 0)
                if is_skip:
                    cur.skip = True
                    cur.direct_mask = 0xFFFF
                    self.wr.terminate(1 if i == len(mbs) - 1 else 0)
                    continue
            if mb["k"] in ("i4", "i16r"):
                self._encode_i4(x, y, cur, in_p=self.stype == "P",
                                in_b=b_slice, mb=mb)
            else:
                self._encode_inter(x, y, cur, mb, b_slice)
            self.wr.terminate(1 if i == len(mbs) - 1 else 0)
        bits = self.wr.bits
        out = bytearray()
        for i in range(0, len(bits), 8):
            byte = 0
            for j, bit in enumerate(bits[i:i + 8]):
                byte |= bit << (7 - j)
            out.append(byte)
        return bytes(out)


# list_mask -> ordered list indices (for ref/mvd per-list selection)
_LISTS_IDX = {1: [0], 2: [1], 3: [0, 1]}


# Residual context bases per ctxBlockCat 0-4 (Table 9-40 frame rows —
# same normative constants entdec.cc compiles; the FIELD sig/last rows
# are parsed from cabac_engine_tables.h in _Tables).
_CBF_BASE = [85, 89, 93, 97, 101]
_SIG_BASE = [105, 120, 134, 149, 152]
_LAST_BASE = [166, 181, 195, 210, 213]
_ABS_BASE = [227, 237, 247, 257, 266]
# ctxBlockCat 5 (8x8) frame bases (entdec.cc kSigBase[5]/kLastBase[5]/
# kAbsBase[5]; the field sig/last bases come from kSigBaseField/
# kLastBaseField like cats 0-4).
_SIG_BASE8 = 402
_LAST_BASE8 = 417
_ABS_BASE8 = 426

# 4x4 luma block coding order (8x8 Z order, 4x4 Z within) -> MB raster
# (mirror of entdec.cc blk_raster).
def _blk_raster(i8: int, i4: int) -> int:
    return (2 * (i8 >> 1) + (i4 >> 1)) * 4 + 2 * (i8 & 1) + (i4 & 1)


def _residual_methods():
    """Attach the residual-coding methods to FieldSliceCabac (kept in a
    helper so the class body above stays the slice-layer mirror)."""

    def _cbf_cond(self, n, cur_intra: bool, kind: int, blk: int) -> int:
        # entdec.cc cbf_cond, kinds 0 (I16 DC) / 1 (luma 4x4), plane 0.
        if n is None:
            return 1 if cur_intra else 0
        if n.pcm:
            return 1
        if n.skip:
            return 0
        if kind == 0:
            return (n.cbf_luma_dc & 1) if n.i16 else 0
        return (n.cbf_luma >> blk) & 1

    def _cbf_ctx_luma_dc(self, x, y, cur):
        a = self._cbf_cond(self.model.at(x - 1, y), cur.intra, 0, 0)
        b = self._cbf_cond(self.model.at(x, y - 1), cur.intra, 0, 0)
        return a + 2 * b

    def _cbf_ctx_luma4x4(self, x, y, cur, blk):
        x4, y4 = blk & 3, blk >> 2
        if x4 > 0:
            a = (cur.cbf_luma >> (blk - 1)) & 1
        else:
            a = self._cbf_cond(self.model.at(x - 1, y), cur.intra, 1,
                               y4 * 4 + 3)
        if y4 > 0:
            b = (cur.cbf_luma >> (blk - 4)) & 1
        else:
            b = self._cbf_cond(self.model.at(x, y - 1), cur.intra, 1,
                               12 + x4)
        return a + 2 * b

    def _encode_residual(self, cat, max_coeff, cbf_inc, coeffs, field):
        """Mirror of entdec.cc residual_block for ctxBlockCat 0-4
        (ctxIdxInc = scan position): coded_block_flag, significance/
        last maps (frame or FIELD Table 9-34 rows), then levels in
        reverse scan order with the eq1/gt1 context evolution and the
        >=15 EG0 escape. `coeffs`: [(scan_pos, level)] ascending, level
        nonzero. Returns the coded_block_flag."""
        w = self.wr
        w.decision(_CBF_BASE[cat] + cbf_inc, 1 if coeffs else 0)
        if not coeffs:
            return 0
        t = w.t
        sig_base = t.sig_field[cat] if field else _SIG_BASE[cat]
        last_base = t.last_field[cat] if field else _LAST_BASE[cat]
        abs_base = _ABS_BASE[cat]
        pos = [p for p, _ in coeffs]
        assert pos == sorted(pos) and pos[-1] < max_coeff
        pset = set(pos)
        for i in range(max_coeff - 1):
            # ctxIdxInc: scan position for cats 0-2/4; Min(i/NumC8x8, 2)
            # for chroma DC (cat 3, 9.3.3.1.3).
            inc = min(i // (max_coeff >> 2), 2) if cat == 3 else i
            sig = i in pset
            w.decision(sig_base + inc, 1 if sig else 0)
            if sig:
                last = i == pos[-1]
                w.decision(last_base + inc, 1 if last else 0)
                if last:
                    break
        self._encode_levels(coeffs, abs_base, cap=3 if cat == 3 else 4)
        return 1

    def _encode_levels(self, coeffs, abs_base, cap):
        """Levels in reverse scan order: eq1/gt1 context evolution and
        the >=15 EG0 escape (shared by the 4x4/chroma and 8x8 paths —
        the evolution depends only on the magnitude sequence)."""
        w = self.wr
        eq1 = gt1 = 0
        for _, level in reversed(coeffs):
            m = abs(level) - 1
            ctx0 = 0 if gt1 else min(4, 1 + eq1)
            if m == 0:
                w.decision(abs_base + ctx0, 0)
            else:
                w.decision(abs_base + ctx0, 1)
                ctx_n = abs_base + 5 + min(cap, gt1)
                n = 1
                while n < min(m, 14):
                    w.decision(ctx_n, 1)
                    n += 1
                if m < 14:
                    w.decision(ctx_n, 0)
                else:
                    w.bypass_eg(0, m - 14)
            w.bypass(1 if level < 0 else 0)
            if m == 0:
                eq1 += 1
            else:
                gt1 += 1

    def _encode_residual8x8(self, coeffs, field):
        """ctxBlockCat 5 (LumaLevel8x8, 64 coefficients): no
        coded_block_flag outside ChromaArrayType 3 (7.4.5.3.3 — block
        presence comes from the CBP bit), Table 9-43 significance /
        last ctxIdxInc MAPS (position-dependent, field column for the
        significance map only), frame bases 402/417 and field bases
        436/451 (Table 9-34), shared abs base 426. Mirrors entdec.cc
        residual_block's is8x8 branch."""
        assert coeffs, "a CBP-coded 8x8 block must carry coefficients"
        w = self.wr
        t = w.t
        sig_base = t.sig_field[5] if field else _SIG_BASE8
        last_base = t.last_field[5] if field else _LAST_BASE8
        sig8 = t.sig8_field if field else t.sig8
        pos = [p for p, _ in coeffs]
        assert pos == sorted(pos) and pos[-1] < 64
        pset = set(pos)
        for i in range(63):
            sig = i in pset
            w.decision(sig_base + sig8[i], 1 if sig else 0)
            if sig:
                last = i == pos[-1]
                w.decision(last_base + t.last8[i], 1 if last else 0)
                if last:
                    break
        self._encode_levels(coeffs, _ABS_BASE8, cap=4)

    def _cbf_cond_chroma(self, n, cur_intra, kind, comp, blk):
        # entdec.cc cbf_cond kinds 2 (chroma DC) / 3 (chroma AC).
        if n is None:
            return 1 if cur_intra else 0
        if n.pcm:
            return 1
        if n.skip:
            return 0
        if kind == 2:
            return ((n.cbf_chroma_dc >> comp) & 1) if n.cbp_chroma != 0 else 0
        return ((n.cbf_chroma_ac[comp] >> blk) & 1) if n.cbp_chroma == 2 \
            else 0

    def _encode_chroma_blocks(self, x, y, cur, cbp_chroma, cdc, cac):
        """Chroma DC (cat 3) then AC (cat 4) blocks, 4:2:0 geometry
        (4-coeff DC, 2x2 AC grid per component)."""
        if not cbp_chroma:
            return
        a, b = self.model.at(x - 1, y), self.model.at(x, y - 1)
        for comp in (0, 1):
            inc = self._cbf_cond_chroma(a, cur.intra, 2, comp, 0) + \
                2 * self._cbf_cond_chroma(b, cur.intra, 2, comp, 0)
            if self._encode_residual(3, 4, inc, cdc.get(comp, []),
                                     self.field):
                cur.cbf_chroma_dc |= 1 << comp
        if cbp_chroma != 2:
            return
        for comp in (0, 1):
            for blk in range(4):
                x2, y2 = blk & 1, blk >> 1
                if x2 > 0:
                    ca = (cur.cbf_chroma_ac[comp] >> (blk - 1)) & 1
                else:
                    ca = self._cbf_cond_chroma(a, cur.intra, 3, comp,
                                               y2 * 2 + 1)
                if y2 > 0:
                    cb = (cur.cbf_chroma_ac[comp] >> (blk - 2)) & 1
                else:
                    cb = self._cbf_cond_chroma(b, cur.intra, 3, comp,
                                               2 + x2)
                if self._encode_residual(4, 15, ca + 2 * cb,
                                         cac.get((comp, blk), []),
                                         self.field):
                    cur.cbf_chroma_ac[comp] |= 1 << blk

    def _encode_qp_delta0(self):
        # mb_qp_delta = 0; every emitted delta is 0, so the "previous
        # delta nonzero" ctxInc is always 0 (entdec.cc cabac_qp_delta).
        self.wr.decision(60, 0)

    def _encode_luma_blocks(self, x, y, cur, cbp_luma, coeffs_map, i16,
                            coeffs8=None):
        """Coded 8x8s in coding order, 4 blocks each (cat 1 for I16 AC,
        cat 2 for plain 4x4), with per-block cbf publication. When the
        MB carries transform_size_8x8_flag (cur.t8x8), each coded 8x8
        is ONE cat-5 block (`coeffs8`: {i8: [(scan_pos, level)]}) and
        publishes cbf on all four of its 4x4 cells — the neighbor
        convention entdec.cc uses for later 4x4 cbf contexts."""
        if cur.t8x8:
            for i8 in range(4):
                if not ((cbp_luma >> i8) & 1):
                    continue
                self._encode_residual8x8((coeffs8 or {}).get(i8, []),
                                         self.field)
                for i4 in range(4):
                    cur.cbf_luma |= 1 << _blk_raster(i8, i4)
            return
        cat = 1 if i16 else 2
        nc = 15 if i16 else 16
        for i8 in range(4):
            if not ((cbp_luma >> i8) & 1):
                continue
            for i4 in range(4):
                blk = _blk_raster(i8, i4)
                coeffs = coeffs_map.get(blk, [])
                inc = self._cbf_ctx_luma4x4(x, y, cur, blk)
                if self._encode_residual(cat, nc, inc, coeffs, self.field):
                    cur.cbf_luma |= 1 << blk
        return

    for name, fn in list(locals().items()):
        if callable(fn):
            setattr(FieldSliceCabac, name, fn)


_residual_methods()
