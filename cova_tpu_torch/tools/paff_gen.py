#!/usr/bin/env python3
"""Minimal conforming H.264 PAFF (field-picture) encoder.

PURPOSE: x264 — the only offline encoder in this environment — can emit
MBAFF but never PAFF, so field-picture decode support had no validation
path (see entdec.h "MBAFF path" note and PARITY.md).  This tool closes
that gap from the other side: it hand-writes small, conforming PAFF
bitstreams (field pictures only, frame_mbs_only_flag=0 and
mb_adaptive_frame_field_flag=0) that libavcodec accepts, so our entropy
decoder's field path can be validated differentially — per-MB MV
equality vs libavcodec's export_mvs (the TestExactMVs methodology) and
parse-sync health.

Reference contract being validated: the reference's patched FFmpeg
decodes any conforming stream (the reference's README, lines 94-114);
field coding per ITU-T H.264 7.3.3/7.3.4/7.3.5 (syntax), 7.4.3/7.4.4
(field inference rules), 8.2.1 (field POC), 8.2.4.2.5 (field reference
lists), 8.4.1 (MV prediction — unchanged inside a field picture).

Encoder scope (deliberately minimal — every tool here exists to make a
VALIDATION stream, not to compress video):
  * CAVLC entropy coding (entropy_coding_mode_flag=0), Main profile.
  * I field pictures: I_PCM, I_4x4 and I_16x16 macroblocks (all-zero
    residuals; I_16x16 codes its mandatory DC coeff_token as
    TotalCoeff=0).
  * P field pictures: P_Skip runs, P_L0_16x16 / 16x8 / 8x16 and P_8x8
    (sub_mb_type P_L0_8x8) partitions with explicit per-partition MVDs
    and reference indices, coded_block_pattern=0.
  * POC type 0, per-field pic_order_cnt_lsb; IDR leading top field;
    sliding-window marking only.
All higher-level structure (field order, frame_num, references) is
driven by the scenario functions at the bottom.

Output container: length-prefixed Annex-B records ([u32le size][AU]),
one access unit (= one field picture) per record, SPS/PPS in-band in
the first record — the same .lp264 format the other csrc tools consume.
"""

from __future__ import annotations

import struct
import sys

from cova_tpu_torch.tools.cabac_enc import FieldSliceCabac


class BitWriter:
    """MSB-first bit assembler for RBSP payloads."""

    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def u(self, n: int, v: int):
        assert 0 <= v < (1 << n), (n, v)
        for i in range(n - 1, -1, -1):
            self._acc = (self._acc << 1) | ((v >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self._bytes.append(self._acc)
                self._acc = 0
                self._nbits = 0

    def ue(self, v: int):
        assert v >= 0
        code = v + 1
        nbits = code.bit_length()
        self.u(2 * nbits - 1, code)

    def se(self, v: int):
        # 9.1.1: codeNum = 2|v| - 1 for v > 0, 2|v| for v <= 0.
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, v: int, cmax: int):
        # 9.1: truncated exp-Golomb — single INVERTED bit when cMax == 1.
        if cmax == 1:
            self.u(1, 1 - v)
        else:
            self.ue(v)

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def align_zero(self):
        while self._nbits:
            self.u(1, 0)

    def raw_bytes(self, data: bytes):
        assert self.byte_aligned()
        self._bytes += data

    def trailing_bits(self):
        self.u(1, 1)
        self.align_zero()

    def rbsp(self) -> bytes:
        assert self.byte_aligned(), "call trailing_bits() first"
        return bytes(self._bytes)


def ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (7.4.1.1)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal(ref_idc: int, nal_type: int, rbsp: bytes) -> bytes:
    return b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | nal_type]) + ebsp(rbsp)


# --------------------------------------------------------------------------
# Parameter sets
# --------------------------------------------------------------------------


def sps_rbsp(mb_w: int, frame_mb_h: int, *, max_ref: int = 4,
             log2_max_frame_num: int = 8, log2_max_poc_lsb: int = 8,
             mb_adaptive: bool = False, high: bool = False) -> bytes:
    assert frame_mb_h % 2 == 0, "PAFF needs an even frame MB height"
    w = BitWriter()
    # Main for the base scenarios; High (100) when the PPS needs
    # transform_8x8_mode (7.4.2.1.1: the profile gates the flag).
    w.u(8, 100 if high else 77)
    w.u(8, 0)   # constraint flags + reserved
    w.u(8, 30)  # level_idc
    w.ue(0)     # seq_parameter_set_id
    if high:
        w.ue(1)    # chroma_format_idc 4:2:0
        w.ue(0)    # bit_depth_luma_minus8
        w.ue(0)    # bit_depth_chroma_minus8
        w.u(1, 0)  # qpprime_y_zero_transform_bypass_flag
        w.u(1, 0)  # seq_scaling_matrix_present_flag
    w.ue(log2_max_frame_num - 4)
    w.ue(0)     # pic_order_cnt_type 0
    w.ue(log2_max_poc_lsb - 4)
    w.ue(max_ref)  # max_num_ref_frames
    w.u(1, 0)   # gaps_in_frame_num_value_allowed_flag
    w.ue(mb_w - 1)
    w.ue(frame_mb_h // 2 - 1)  # map units = field MB rows when interlaced
    w.u(1, 0)   # frame_mbs_only_flag = 0  (interlace permitted)
    # mb_adaptive=1 exercises the 7.4.4 rule that field PICTURES of an
    # MBAFF-capable stream are plain PAFF fields (no per-MB flags).
    w.u(1, 1 if mb_adaptive else 0)
    w.u(1, 1)   # direct_8x8_inference_flag (mandatory when interlaced)
    w.u(1, 0)   # frame_cropping_flag
    w.u(1, 0)   # vui_parameters_present_flag
    w.trailing_bits()
    return w.rbsp()


def pps_rbsp(*, cabac: bool = False, t8x8: bool = False) -> bytes:
    w = BitWriter()
    w.ue(0)  # pic_parameter_set_id
    w.ue(0)  # seq_parameter_set_id
    w.u(1, 1 if cabac else 0)  # entropy_coding_mode_flag
    w.u(1, 0)  # bottom_field_pic_order_in_frame_present_flag
    w.ue(0)  # num_slice_groups_minus1
    w.ue(0)  # num_ref_idx_l0_default_active_minus1
    w.ue(0)  # num_ref_idx_l1_default_active_minus1
    w.u(1, 0)  # weighted_pred_flag
    w.u(2, 0)  # weighted_bipred_idc
    w.se(0)  # pic_init_qp_minus26
    w.se(0)  # pic_init_qs_minus26
    w.se(0)  # chroma_qp_index_offset
    w.u(1, 0)  # deblocking_filter_control_present_flag
    w.u(1, 0)  # constrained_intra_pred_flag
    w.u(1, 0)  # redundant_pic_cnt_present_flag
    if t8x8:
        # PPS extension (present iff more_rbsp_data; needs High SPS).
        w.u(1, 1)  # transform_8x8_mode_flag
        w.u(1, 0)  # pic_scaling_matrix_present_flag
        w.se(0)    # second_chroma_qp_index_offset
    w.trailing_bits()
    return w.rbsp()


# --------------------------------------------------------------------------
# Macroblock specs
# --------------------------------------------------------------------------
#
# A field picture's slice data is a list of per-MB dicts, field raster
# order:
#   {'k': 'pcm'}
#   {'k': 'i4'}                       all prev_intra4x4_pred_mode, cbp 0
#   {'k': 'i16', 'pred': 0..3}       I_16x16, cbp 0, zero DC residual
#   {'k': 'skip'}                     P_Skip
#   {'k': 'p16', 'mvd': (x, y), 'ref': r}
#   {'k': 'p16x8', 'mvd': [(x,y),(x,y)], 'ref': [r0, r1]}
#   {'k': 'p8x16', 'mvd': [...], 'ref': [...]}
#   {'k': 'p8x8', 'mvd': [4 x (x,y)], 'ref': [4 x r]}   sub types P_L0_8x8

_PCM_LUMA = bytes((16 * i + j) & 0xFF for i in range(16) for j in range(16))
_PCM_CHROMA = bytes(128 for _ in range(64))


def _write_mb_i(w: BitWriter, mb: dict, off: int):
    # off: intra mb_type offset — 0 in I slices, 5 in P, 23 in B.
    k = mb["k"]
    if k == "pcm":
        w.ue(off + 25)
        w.align_zero()  # pcm_alignment_zero_bit
        w.raw_bytes(_PCM_LUMA + _PCM_CHROMA + _PCM_CHROMA)
    elif k == "i4":
        w.ue(off + 0)
        for _ in range(16):
            w.u(1, 1)  # prev_intra4x4_pred_mode_flag
        w.ue(0)  # intra_chroma_pred_mode DC
        # coded_block_pattern, Intra mapping (Table 9-4): cbp 0 -> codeNum 3
        w.ue(3)
    elif k == "i16":
        pred = mb.get("pred", 0)
        w.ue(off + 1 + pred)  # I_16x16 pred, CBP luma 0 chroma 0
        w.ue(0)  # intra_chroma_pred_mode DC
        w.se(0)  # mb_qp_delta (always present for I_16x16)
        # Intra16x16DCLevel: TotalCoeff 0 with nC<2 -> coeff_token '1'
        # (all neighbours in these streams carry zero nnz).
        w.u(1, 1)
    else:
        raise ValueError(k)


_B16_TYPE = {"l0": 1, "l1": 2, "bi": 3}
# (list0kind, list1kind) -> base mb_type of the 16x8 variant (Table
# 7-14; +1 selects 8x16).
_BPAIR_TYPE = {("l0", "l0"): 4, ("l1", "l1"): 6, ("l0", "l1"): 8,
               ("l1", "l0"): 10, ("l0", "bi"): 12, ("l1", "bi"): 14,
               ("bi", "l0"): 16, ("bi", "l1"): 18, ("bi", "bi"): 20}
_BSUB_TYPE = {"direct": 0, "l0": 1, "l1": 2, "bi": 3}
_LISTS = {"l0": (0,), "l1": (1,), "bi": (0, 1), "direct": ()}


def _write_mb_b(w: BitWriter, mb: dict, nref0: int, nref1: int):
    """B macroblock layer (7.3.5.1/7.3.5.2, CAVLC, cbp 0).

    Specs: {'k':'bdirect'}; {'k':'b16','kind':'l0'|'l1'|'bi',
    'mvd':[(x,y) per used list],'ref':[r per used list]};
    {'k':'b16x8'/'b8x16','kinds':(k0,k1),'mvd':[[(x,y)..] per part],
    'ref':[[r..] per part]}; {'k':'b8x8','sub':[4 kinds incl 'direct'],
    'mvd':[per-sub per-list],'ref':[per-sub per-list]}."""
    k = mb["k"]
    if k in ("pcm", "i4", "i16"):
        _write_mb_i(w, mb, off=23)
        return
    nref = (nref0, nref1)
    if k == "bdirect":
        w.ue(0)
        w.ue(0)  # cbp 0 (inter mapping)
        return
    if k == "b16":
        kind = mb["kind"]
        w.ue(_B16_TYPE[kind])
        lists = _LISTS[kind]
        refs = mb.get("ref", [0] * len(lists))
        for lx, r in zip(lists, refs):
            if nref[lx] > 1:
                w.te(r, nref[lx] - 1)
        for mx, my in mb["mvd"]:
            w.se(mx)
            w.se(my)
        w.ue(0)
        return
    if k in ("b16x8", "b8x16"):
        kinds = mb["kinds"]
        w.ue(_BPAIR_TYPE[kinds] + (0 if k == "b16x8" else 1))
        refs = mb.get("ref", [[0] * len(_LISTS[kd]) for kd in kinds])
        # refs for all partitions list0-first (7.3.5.1 order), then l1.
        for lx in (0, 1):
            for part, kd in enumerate(kinds):
                if lx in _LISTS[kd] and nref[lx] > 1:
                    w.te(refs[part][_LISTS[kd].index(lx)], nref[lx] - 1)
        for lx in (0, 1):
            for part, kd in enumerate(kinds):
                if lx in _LISTS[kd]:
                    mx, my = mb["mvd"][part][_LISTS[kd].index(lx)]
                    w.se(mx)
                    w.se(my)
        w.ue(0)
        return
    if k == "b8x8":
        w.ue(22)
        subs = mb["sub"]
        for kd in subs:
            w.ue(_BSUB_TYPE[kd])
        refs = mb.get("ref", [[0] * len(_LISTS[kd]) for kd in subs])
        for lx in (0, 1):
            for i8, kd in enumerate(subs):
                if lx in _LISTS[kd] and nref[lx] > 1:
                    w.te(refs[i8][_LISTS[kd].index(lx)], nref[lx] - 1)
        for lx in (0, 1):
            for i8, kd in enumerate(subs):
                if lx in _LISTS[kd]:
                    mx, my = mb["mvd"][i8][_LISTS[kd].index(lx)]
                    w.se(mx)
                    w.se(my)
        w.ue(0)
        return
    raise ValueError(k)


def _write_mb_p(w: BitWriter, mb: dict, nref: int):
    k = mb["k"]
    assert "cbp" not in mb and k != "i16r", "residual specs are CABAC-only"
    if k in ("pcm", "i4", "i16"):
        _write_mb_i(w, mb, off=5)
        return
    if k == "p16":
        w.ue(0)  # P_L0_16x16
        if nref > 1:
            w.te(mb.get("ref", 0), nref - 1)
        mx, my = mb["mvd"]
        w.se(mx)
        w.se(my)
        w.ue(0)  # cbp 0 (Inter mapping: codeNum 0)
    elif k in ("p16x8", "p8x16"):
        w.ue(1 if k == "p16x8" else 2)
        refs = mb.get("ref", [0, 0])
        if nref > 1:
            for r in refs:
                w.te(r, nref - 1)
        for mx, my in mb["mvd"]:
            w.se(mx)
            w.se(my)
        w.ue(0)
    elif k == "p8x8":
        w.ue(3)  # P_8x8
        for _ in range(4):
            w.ue(0)  # sub_mb_type P_L0_8x8
        refs = mb.get("ref", [0, 0, 0, 0])
        if nref > 1:
            for r in refs:
                w.te(r, nref - 1)
        for mx, my in mb["mvd"]:
            w.se(mx)
            w.se(my)
        w.ue(0)
    else:
        raise ValueError(k)


# --------------------------------------------------------------------------
# Field pictures
# --------------------------------------------------------------------------


class FieldEncoder:
    """Emits one access unit per FIELD picture (CAVLC)."""

    def __init__(self, mb_w: int, frame_mb_h: int, *, max_ref: int = 4,
                 mb_adaptive: bool = False, cabac: bool = False,
                 t8x8: bool = False):
        self.mb_w = mb_w
        self.frame_mb_h = frame_mb_h
        self.field_mbs = mb_w * (frame_mb_h // 2)
        self.log2_max_frame_num = 8
        self.log2_max_poc_lsb = 8
        self.aus: list[bytes] = []
        self.keys: list[bool] = []  # per-AU: leading IDR field
        self._param_sets = nal(3, 7, sps_rbsp(
            mb_w, frame_mb_h, max_ref=max_ref,
            log2_max_frame_num=self.log2_max_frame_num,
            log2_max_poc_lsb=self.log2_max_poc_lsb,
            mb_adaptive=mb_adaptive, high=t8x8,
        )) + nal(3, 8, pps_rbsp(cabac=cabac, t8x8=t8x8))
        self.cabac = cabac
        self.t8x8 = t8x8
        self._idr_id = 0

    def field(self, mbs: list[dict], *, slice_type: str, bottom: bool,
              frame_num: int, poc_lsb: int, idr: bool = False,
              nref: int = 1, nref1: int = 1, ref: bool = True,
              direct_spatial: bool = True, lt_flag: bool = False,
              mmco: list | None = None, list_mod: dict | None = None):
        """Append one field picture (a single slice covering the field).

        lt_flag: IDR long_term_reference_flag. mmco: MMCO ops as tuples
        (op, v1[, v2]) in the FIELD PicNum domain (8.2.4.1 — values are
        the caller's responsibility). list_mod: {list_index: [(idc,
        value), ...]} ref_pic_list_modification ops, field domain."""
        assert len(mbs) == self.field_mbs, (len(mbs), self.field_mbs)
        p_slice = slice_type == "P"
        b_slice = slice_type == "B"
        w = BitWriter()
        w.ue(0)  # first_mb_in_slice
        w.ue(0 if p_slice else 1 if b_slice else 2)  # slice_type
        w.ue(0)  # pic_parameter_set_id
        w.u(self.log2_max_frame_num, frame_num)
        w.u(1, 1)  # field_pic_flag
        w.u(1, 1 if bottom else 0)
        if idr:
            w.ue(self._idr_id)
            self._idr_id ^= 1  # consecutive IDRs must differ (7.4.3)
        w.u(self.log2_max_poc_lsb, poc_lsb)
        if b_slice:
            w.u(1, 1 if direct_spatial else 0)
        mods = list_mod or {}

        def write_mods(which):
            m = mods.get(which)
            if not m:
                w.u(1, 0)  # ref_pic_list_modification_flag
                return
            w.u(1, 1)
            for idc, val in m:
                w.ue(idc)
                w.ue(val)
            w.ue(3)

        if p_slice or b_slice:
            # Always override explicitly: the FIELD default is
            # 2*pps_default+1 (7.4.3) and explicitness keeps the stream
            # unambiguous for every decoder under test.
            w.u(1, 1)
            w.ue(nref - 1)
            if b_slice:
                w.ue(nref1 - 1)
            write_mods(0)
            if b_slice:
                write_mods(1)
        if ref:
            if idr:
                w.u(1, 0)  # no_output_of_prior_pics_flag
                w.u(1, 1 if lt_flag else 0)  # long_term_reference_flag
            elif mmco:
                w.u(1, 1)  # adaptive_ref_pic_marking_mode_flag
                for op in mmco:
                    w.ue(op[0])
                    if op[0] in (1, 2, 3, 4, 6):
                        w.ue(op[1])
                    if op[0] == 3:
                        w.ue(op[2])
                w.ue(0)
            else:
                w.u(1, 0)  # adaptive_ref_pic_marking_mode_flag
        if self.cabac and (p_slice or b_slice):
            w.ue(0)  # cabac_init_idc
        w.se(0)  # slice_qp_delta
        if self.cabac:
            # ---- slice data (CABAC): alignment ones, then the
            # arithmetic-coded macroblock layer (cabac_enc.py); the
            # EncodeFlush trailing 1 is the rbsp stop bit.
            while not w.byte_aligned():
                w.u(1, 1)
            coder = FieldSliceCabac(
                self.mb_w, self.frame_mb_h // 2, slice_type,
                nref0=nref, nref1=nref1, qp=26, init_idc=0,
                t8x8_mode=self.t8x8)
            w.raw_bytes(coder.encode(mbs))
            au = nal(2 if ref else 0, 5 if idr else 1, w.rbsp())
            if not self.aus:
                au = self._param_sets + au
            self.aus.append(au)
            self.keys.append(idr)
            return
        # ---- slice data (CAVLC) ----
        if p_slice or b_slice:
            run = 0
            for mb in mbs:
                if mb["k"] == "skip":
                    run += 1
                    continue
                w.ue(run)
                run = 0
                if b_slice:
                    _write_mb_b(w, mb, nref, nref1)
                else:
                    _write_mb_p(w, mb, nref)
            if run:
                w.ue(run)
        else:
            for mb in mbs:
                _write_mb_i(w, mb, off=0)
        w.trailing_bits()
        au = nal(2 if ref else 0, 5 if idr else 1, w.rbsp())
        if not self.aus:
            au = self._param_sets + au
        self.aus.append(au)
        self.keys.append(idr)

    def frame(self, mbs: list[dict], *, slice_type: str, frame_num: int,
              poc_lsb: int, idr: bool = False, nref: int = 1,
              ref: bool = True):
        """Append one plain FRAME picture (field_pic_flag=0) — valid in
        an interlace-capable stream only when mb_adaptive_frame_field
        is 0 (MBAFF frames are pair-coded and not emitted here). Mixing
        these with field() calls builds a true adaptive-PAFF stream,
        which x264 cannot produce either."""
        assert len(mbs) == 2 * self.field_mbs
        p_slice = slice_type == "P"
        w = BitWriter()
        w.ue(0)
        w.ue(0 if p_slice else 2)
        w.ue(0)
        w.u(self.log2_max_frame_num, frame_num)
        w.u(1, 0)  # field_pic_flag = 0
        if idr:
            w.ue(self._idr_id)
            self._idr_id ^= 1
        w.u(self.log2_max_poc_lsb, poc_lsb)
        if p_slice:
            w.u(1, 1)
            w.ue(nref - 1)
            w.u(1, 0)
        if ref:
            if idr:
                w.u(1, 0)
                w.u(1, 0)
            else:
                w.u(1, 0)
        w.se(0)
        if p_slice:
            run = 0
            for mb in mbs:
                if mb["k"] == "skip":
                    run += 1
                    continue
                w.ue(run)
                run = 0
                _write_mb_p(w, mb, nref)
            if run:
                w.ue(run)
        else:
            for mb in mbs:
                _write_mb_i(w, mb, off=0)
        w.trailing_bits()
        au = nal(2 if ref else 0, 5 if idr else 1, w.rbsp())
        if not self.aus:
            au = self._param_sets + au
        self.aus.append(au)
        self.keys.append(idr)

    def write(self, path: str):
        with open(path, "wb") as f:
            for au in self.aus:
                f.write(struct.pack("<I", len(au)) + au)

    def write_rec(self, path: str, *, timescale: int = 50):
        """Write the csrc/tools/reencode record format so the stream can
        be muxed into MP4 via cova_tpu.utils.mp4loop.mux_rec_to_mp4 (one
        sample per FIELD; pts = dts = field index — the scenarios below
        are IP-only, so decode order is presentation order). Keyframe
        flag = the IDR leading field (record 0 carries in-band SPS/PPS,
        which the muxer lifts into avcC)."""
        with open(path, "wb") as f:
            f.write(struct.pack("<IIII", 16 * self.mb_w,
                                16 * self.frame_mb_h, timescale, 0))
            for i, au in enumerate(self.aus):
                f.write(struct.pack("<Iqq", len(au), i, i))
                f.write(bytes([1 if self.keys[i] else 0]))
                f.write(au)


# --------------------------------------------------------------------------
# Scenarios
# --------------------------------------------------------------------------


def _grid(enc: FieldEncoder, fill):
    return [fill(i) for i in range(enc.field_mbs)]


def _i16(enc: FieldEncoder, i: int, pred: int) -> dict:
    """I_16x16 with a pred mode legal at this position: Vertical needs
    the top neighbour, Horizontal the left, Plane both — fall back to
    DC (2, always available) where the wanted neighbour is missing."""
    row, col = divmod(i, enc.mb_w)
    need_top = pred in (0, 3)
    need_left = pred in (1, 3)
    if (need_top and row == 0) or (need_left and col == 0):
        pred = 2
    return {"k": "i16", "pred": pred}


def scenario_ip_basic(mb_w: int = 6, frame_mb_h: int = 6) -> FieldEncoder:
    """IDR top field (mixed intra), P bottom field (same frame,
    cross-parity reference), then two more field pairs of P with MVD
    variety — skips, 16x16, 16x8, 8x16, 8x8, an intra island."""
    enc = FieldEncoder(mb_w, frame_mb_h)
    intra = [{"k": "pcm"} if i % 3 == 0 else
             {"k": "i4"} if i % 3 == 1 else _i16(enc, i, i % 4)
             for i in range(enc.field_mbs)]
    enc.field(intra, slice_type="I", bottom=False, frame_num=0, poc_lsb=0,
              idr=True)

    def p_mix(i):
        r = i % 6
        if r == 0:
            return {"k": "skip"}
        if r == 1:
            return {"k": "p16", "mvd": (6, -2)}
        if r == 2:
            return {"k": "p16x8", "mvd": [(-3, 1), (2, 4)]}
        if r == 3:
            return {"k": "p8x16", "mvd": [(1, 1), (-1, -5)]}
        if r == 4:
            return {"k": "p8x8",
                    "mvd": [(2, 0), (0, 2), (-2, 0), (0, -2)]}
        return {"k": "i16", "pred": 2}

    enc.field(_grid(enc, p_mix), slice_type="P", bottom=True, frame_num=0,
              poc_lsb=1)
    enc.field(_grid(enc, lambda i: p_mix(i + 1)), slice_type="P",
              bottom=False, frame_num=1, poc_lsb=2)
    enc.field(_grid(enc, lambda i: p_mix(i + 3)), slice_type="P",
              bottom=True, frame_num=1, poc_lsb=3)
    return enc


def scenario_multiref(mb_w: int = 6, frame_mb_h: int = 6) -> FieldEncoder:
    """Field reference lists with several fields in the DPB: later P
    fields pick ref_idx 0..3 explicitly (same- and opposite-parity
    references per 8.2.4.2.5 ordering)."""
    enc = FieldEncoder(mb_w, frame_mb_h)
    enc.field(_grid(enc, lambda i: _i16(enc, i, i % 4)),
              slice_type="I", bottom=False, frame_num=0, poc_lsb=0, idr=True)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (i % 5 - 2, 1)}),
              slice_type="P", bottom=True, frame_num=0, poc_lsb=1)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (1, i % 3 - 1),
                                    "ref": i % 2}),
              slice_type="P", bottom=False, frame_num=1, poc_lsb=2, nref=2)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (-2, 2),
                                    "ref": i % 3}),
              slice_type="P", bottom=True, frame_num=1, poc_lsb=3, nref=3)

    def p4(i):
        if i % 4 == 0:
            return {"k": "skip"}
        return {"k": "p16", "mvd": ((i * 7) % 9 - 4, (i * 5) % 7 - 3),
                "ref": i % 4}

    enc.field(_grid(enc, p4), slice_type="P", bottom=False, frame_num=2,
              poc_lsb=4, nref=4)
    enc.field(_grid(enc, lambda i: p4(i + 2)), slice_type="P", bottom=True,
              frame_num=2, poc_lsb=5, nref=4)
    return enc


def scenario_skip_heavy(mb_w: int = 6, frame_mb_h: int = 6) -> FieldEncoder:
    """Long P_Skip runs (incl. whole-field skip) — P_Skip MV inference
    inside field pictures, plus trailing-run end-of-slice handling."""
    enc = FieldEncoder(mb_w, frame_mb_h)
    enc.field(_grid(enc, lambda i: {"k": "i4"}), slice_type="I",
              bottom=False, frame_num=0, poc_lsb=0, idr=True)
    mbs = [{"k": "skip"} for _ in range(enc.field_mbs)]
    mbs[enc.field_mbs // 2] = {"k": "p16", "mvd": (9, 3)}
    enc.field(mbs, slice_type="P", bottom=True, frame_num=0, poc_lsb=1)
    enc.field([{"k": "skip"} for _ in range(enc.field_mbs)], slice_type="P",
              bottom=False, frame_num=1, poc_lsb=2)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (0, 0)}
                    if i == 0 else {"k": "skip"}),
              slice_type="P", bottom=True, frame_num=1, poc_lsb=3)
    return enc


def _scenario_b(spatial: bool, mb_w: int = 6, frame_mb_h: int = 6):
    """IDR-I/P frame 0, P pair frame 1 (future refs), then a non-ref B
    field pair coded between them (POC 4/5 vs 0/1 and 8/9) — direct
    modes (whole-MB, 8x8 sub), explicit L0/L1/Bi 16x16, mixed-list
    rectangular partitions, B_Skip runs, cross-parity ref indices."""
    enc = FieldEncoder(mb_w, frame_mb_h)
    enc.field(_grid(enc, lambda i: _i16(enc, i, i % 4)), slice_type="I",
              bottom=False, frame_num=0, poc_lsb=0, idr=True)
    enc.field(_grid(enc, lambda i: {"k": "p16",
                                    "mvd": ((i * 3) % 7 - 3, (i * 5) % 5 - 2)}),
              slice_type="P", bottom=True, frame_num=0, poc_lsb=1)
    enc.field(_grid(enc, lambda i: {"k": "skip"} if i % 3 == 0 else
              {"k": "p16", "mvd": ((i * 7) % 9 - 4, (i * 2) % 5 - 2),
               "ref": i % 2}),
              slice_type="P", bottom=False, frame_num=1, poc_lsb=8, nref=2)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (1 - i % 3, i % 4 - 1),
                                    "ref": i % 3}),
              slice_type="P", bottom=True, frame_num=1, poc_lsb=9, nref=3)

    def bmix(i):
        r = i % 8
        if r == 0:
            return {"k": "skip"}
        if r == 1:
            return {"k": "bdirect"}
        if r == 2:
            return {"k": "b16", "kind": "l0", "mvd": [(3, -1)], "ref": [i % 2]}
        if r == 3:
            return {"k": "b16", "kind": "l1", "mvd": [(-2, 2)], "ref": [0]}
        if r == 4:
            return {"k": "b16", "kind": "bi", "mvd": [(1, 1), (-1, 3)],
                    "ref": [0, i % 2]}
        if r == 5:
            return {"k": "b16x8", "kinds": ("l0", "l1"),
                    "mvd": [[(2, 0)], [(0, -2)]], "ref": [[1], [0]]}
        if r == 6:
            return {"k": "b8x16", "kinds": ("bi", "l0"),
                    "mvd": [[(1, 0), (0, 1)], [(-1, 2)]],
                    "ref": [[0, 0], [1]]}
        return {"k": "b8x8", "sub": ["direct", "l0", "bi", "direct"],
                "mvd": [None, [(2, -2)], [(1, 1), (3, 0)], None],
                "ref": [None, [1], [0, 1], None]}

    enc.field(_grid(enc, bmix), slice_type="B", bottom=False, frame_num=2,
              poc_lsb=4, nref=2, nref1=2, ref=False, direct_spatial=spatial)
    enc.field(_grid(enc, lambda i: bmix(i + 3)), slice_type="B", bottom=True,
              frame_num=2, poc_lsb=5, nref=2, nref1=2, ref=False,
              direct_spatial=spatial)
    return enc


def scenario_b_spatial(mb_w: int = 6, frame_mb_h: int = 6):
    return _scenario_b(True, mb_w, frame_mb_h)


def scenario_b_temporal(mb_w: int = 6, frame_mb_h: int = 6):
    return _scenario_b(False, mb_w, frame_mb_h)


def scenario_pipeline(mb_w: int = 10, frame_mb_h: int = 8,
                      nframes: int = 48, gop: int = 16):
    """A longer IP-only PAFF clip for full-pipeline integration: multi
    GoP (IDR field pair every `gop` frames), a high-|mv| macroblock
    cluster drifting across the field (a synthetic moving object for
    the compressed-domain stage), P_Skip background."""
    enc = FieldEncoder(mb_w, frame_mb_h)
    rows = frame_mb_h // 2
    for fr in range(nframes):
        idr = fr % gop == 0
        fn = fr % gop  # frame_num restarts at each IDR
        for parity in (0, 1):
            if idr and parity == 0:
                enc.field(_grid(enc, lambda i: _i16(enc, i, i % 4)),
                          slice_type="I", bottom=False, frame_num=0,
                          poc_lsb=(2 * fr) % 256, idr=True)
                continue
            cx = (fr * 2 + parity) % (mb_w - 1)  # drifting object column

            def pmb(i, cx=cx):
                r, c = divmod(i, mb_w)
                if c in (cx, cx + 1) and 1 <= r < rows:
                    return {"k": "p16", "mvd": (8 if c == cx else 0,
                                                -4 if r == 1 else 2)}
                return {"k": "skip"}

            enc.field(_grid(enc, pmb), slice_type="P", bottom=parity == 1,
                      frame_num=fn, poc_lsb=(2 * fr + parity) % 256)
    return enc


def scenario_adaptive(mb_w: int = 6, frame_mb_h: int = 6):
    """True adaptive PAFF: frame pictures and field pairs interleaved
    in one stream (frame_mbs_only=0, mb_adaptive=0) — IDR frame, P
    frame, field pair, P frame again, field pair. Exercises the
    frame-picture path of an interlace-capable stream, field lists over
    a mixed DPB (degrade: frames buffered -> field lists empty), and
    frame pictures over field references."""
    enc = FieldEncoder(mb_w, frame_mb_h)
    n2 = 2 * enc.field_mbs

    def pframe(i):
        if i % 4 == 0:
            return {"k": "skip"}
        return {"k": "p16", "mvd": ((i * 3) % 7 - 3, (i * 5) % 9 - 4)}

    enc.frame([_i16(enc, 0, 2) for _ in range(n2)], slice_type="I",
              frame_num=0, poc_lsb=0, idr=True)
    enc.frame([pframe(i) for i in range(n2)], slice_type="P",
              frame_num=1, poc_lsb=2)
    enc.field(_grid(enc, lambda i: pframe(i + 1)), slice_type="P",
              bottom=False, frame_num=2, poc_lsb=4)
    enc.field(_grid(enc, lambda i: pframe(i + 2)), slice_type="P",
              bottom=True, frame_num=2, poc_lsb=5)
    enc.frame([pframe(i + 3) for i in range(n2)], slice_type="P",
              frame_num=3, poc_lsb=6)
    enc.field(_grid(enc, lambda i: pframe(i)), slice_type="P",
              bottom=False, frame_num=4, poc_lsb=8)
    enc.field(_grid(enc, lambda i: pframe(i + 5)), slice_type="P",
              bottom=True, frame_num=4, poc_lsb=9)
    return enc


def scenario_mbadaptive_fields(mb_w: int = 6, frame_mb_h: int = 6):
    """Field pictures under an mb_adaptive_frame_field=1 SPS: per 7.4.4
    a field picture of an MBAFF-capable stream carries NO per-MB field
    flags — it is a plain PAFF field. x264 emits only MBAFF frames, so
    this combination has no other validation source."""
    enc = FieldEncoder(mb_w, frame_mb_h, mb_adaptive=True)
    enc.field(_grid(enc, lambda i: _i16(enc, i, i % 4)), slice_type="I",
              bottom=False, frame_num=0, poc_lsb=0, idr=True)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (i % 5 - 2, 2 - i % 4)}),
              slice_type="P", bottom=True, frame_num=0, poc_lsb=1)
    enc.field(_grid(enc, lambda i: {"k": "skip"} if i % 2 else
                    {"k": "p8x8", "mvd": [(1, 0), (0, 1), (-1, 0), (0, -1)]}),
              slice_type="P", bottom=False, frame_num=1, poc_lsb=2, nref=2)
    enc.field(_grid(enc, lambda i: {"k": "p16x8", "mvd": [(2, -1), (-2, 3)]}),
              slice_type="P", bottom=True, frame_num=1, poc_lsb=3, nref=2)
    return enc


def scenario_cabac_ip(mb_w: int = 6, frame_mb_h: int = 6):
    """CABAC-mode PAFF, I/P fields: the arithmetic slice layer (context
    init at the field QP, mb_skip / mb_type / ref / mvd / cbp contexts
    with field-geometry neighbors, per-MB end_of_slice) adjudicated
    bin-exactly against libavcodec via the ptrace oracle."""
    enc = FieldEncoder(mb_w, frame_mb_h, cabac=True)
    enc.field(_grid(enc, lambda i: {"k": "i4"}), slice_type="I",
              bottom=False, frame_num=0, poc_lsb=0, idr=True)

    def p_mix(i):
        r = i % 6
        if r == 0:
            return {"k": "skip"}
        if r == 1:
            return {"k": "p16", "mvd": (6, -2)}
        if r == 2:
            return {"k": "p16x8", "mvd": [(-3, 1), (2, 4)]}
        if r == 3:
            return {"k": "p8x16", "mvd": [(1, 1), (-1, -15)]}
        if r == 4:
            return {"k": "p8x8",
                    "mvd": [(2, 0), (0, 12), (-2, 0), (0, -2)]}
        return {"k": "i4"}

    enc.field(_grid(enc, p_mix), slice_type="P", bottom=True, frame_num=0,
              poc_lsb=1)
    enc.field(_grid(enc, lambda i: p_mix(i + 1)), slice_type="P",
              bottom=False, frame_num=1, poc_lsb=2, nref=2)
    enc.field(_grid(enc, lambda i: {"k": "p16",
                                    "mvd": ((i * 7) % 9 - 4, (i * 5) % 7 - 3),
                                    "ref": i % 3}),
              slice_type="P", bottom=True, frame_num=1, poc_lsb=3, nref=3)
    return enc


def scenario_cabac_b(mb_w: int = 6, frame_mb_h: int = 6, spatial: bool = True):
    """CABAC-mode PAFF with B fields (direct modes, mixed-list
    partitions, B_8x8 with direct subs, B_Skip runs)."""
    enc = FieldEncoder(mb_w, frame_mb_h, cabac=True)
    enc.field(_grid(enc, lambda i: {"k": "i4"}), slice_type="I",
              bottom=False, frame_num=0, poc_lsb=0, idr=True)
    enc.field(_grid(enc, lambda i: {"k": "p16",
                                    "mvd": ((i * 3) % 7 - 3, (i * 5) % 5 - 2)}),
              slice_type="P", bottom=True, frame_num=0, poc_lsb=1)
    enc.field(_grid(enc, lambda i: {"k": "skip"} if i % 3 == 0 else
              {"k": "p16", "mvd": ((i * 7) % 9 - 4, (i * 2) % 5 - 2),
               "ref": i % 2}),
              slice_type="P", bottom=False, frame_num=1, poc_lsb=8, nref=2)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (1 - i % 3, i % 4 - 1),
                                    "ref": i % 3}),
              slice_type="P", bottom=True, frame_num=1, poc_lsb=9, nref=3)

    def bmix(i):
        r = i % 8
        if r == 0:
            return {"k": "skip"}
        if r == 1:
            return {"k": "bdirect"}
        if r == 2:
            return {"k": "b16", "kind": "l0", "mvd": [(3, -1)], "ref": [i % 2]}
        if r == 3:
            return {"k": "b16", "kind": "l1", "mvd": [(-2, 2)], "ref": [0]}
        if r == 4:
            return {"k": "b16", "kind": "bi", "mvd": [(1, 11), (-1, 3)],
                    "ref": [0, i % 2]}
        if r == 5:
            return {"k": "b16x8", "kinds": ("l0", "l1"),
                    "mvd": [[(2, 0)], [(0, -2)]], "ref": [[1], [0]]}
        if r == 6:
            return {"k": "b8x16", "kinds": ("l1", "l0"),
                    "mvd": [[(1, 0)], [(-1, 2)]], "ref": [[0], [1]]}
        return {"k": "b8x8", "sub": ["direct", "l0", "bi", "direct"],
                "mvd": [None, [(2, -2)], [(1, 1), (3, 0)], None],
                "ref": [None, [1], [0, 1], None]}

    enc.field(_grid(enc, bmix), slice_type="B", bottom=False, frame_num=2,
              poc_lsb=4, nref=2, nref1=2, ref=False, direct_spatial=spatial)
    enc.field(_grid(enc, lambda i: bmix(i + 3)), slice_type="B", bottom=True,
              frame_num=2, poc_lsb=5, nref=2, nref1=2, ref=False,
              direct_spatial=spatial)
    return enc


def scenario_cabac_b_temporal(mb_w: int = 6, frame_mb_h: int = 6):
    return scenario_cabac_b(mb_w, frame_mb_h, spatial=False)


def scenario_cabac_resid(mb_w: int = 6, frame_mb_h: int = 6):
    """CABAC field pictures WITH residual coefficients: I_16x16 DC
    blocks (ctxBlockCat 0) and coded 4x4 luma blocks in P MBs
    (ctxBlockCat 2) — driving the Table 9-34/9-43 FIELD significance /
    last rows and the level context evolution (eq1/gt1, the >=15 EG0
    escape) directly through the bin oracle."""
    enc = FieldEncoder(mb_w, frame_mb_h, cabac=True)

    def i_mix(i):
        r = i % 4
        if r == 0:
            return {"k": "i4"}
        if r == 1:
            # sparse DC: positions incl. the implied-last final coeff;
            # chroma DC (cat 3) + AC (cat 4) blocks too
            return {"k": "i16r", "pred": 2,
                    "dc": [(0, 3), (2, -1), (15, 1)], "cbpc": 2,
                    "cdc": {0: [(0, 2), (3, -1)], 1: [(1, 5)]},
                    "cac": {(0, 0): [(0, -1), (14, 2)], (1, 3): [(7, 1)]}}
        if r == 2:
            # dense leading run + big level (EG0 escape: |level|-1 >= 14)
            return {"k": "i16r", "pred": 2,
                    "dc": [(p, (-1) ** p * (p + 1)) for p in range(5)]
                    + [(7, 16)]}
        return {"k": "i16r", "pred": 2, "dc": [(11, -15)]}

    enc.field(_grid(enc, i_mix), slice_type="I", bottom=False, frame_num=0,
              poc_lsb=0, idr=True)

    def p_mix(i):
        r = i % 5
        if r == 0:
            return {"k": "skip"}
        if r == 1:
            return {"k": "p16", "mvd": (2, -1), "cbp": 0b1001,
                    "coeffs": {0: [(0, 1), (3, -2)], 1: [(5, 4)],
                               15: [(1, -1), (14, 2), (15, -3)]},
                    "cbpc": 1, "cdc": {0: [(2, -3)]}}
        if r == 2:
            return {"k": "i16r", "pred": 2,  # DC: position-independent
                    "dc": [(1, 2), (6, -7), (13, 1)]}
        if r == 3:
            return {"k": "p16x8", "mvd": [(0, 4), (-3, 0)], "cbp": 0b0110,
                    "coeffs": {2: [(0, -20)], 6: [(2, 1), (9, 1)],
                               9: [(0, 1)]}}
        return {"k": "p16", "mvd": (1, 1)}

    enc.field(_grid(enc, p_mix), slice_type="P", bottom=True, frame_num=0,
              poc_lsb=1)
    enc.field(_grid(enc, lambda i: p_mix(i + 2)), slice_type="P",
              bottom=False, frame_num=1, poc_lsb=2, nref=2)
    enc.field(_grid(enc, lambda i: p_mix(i + 4)), slice_type="P",
              bottom=True, frame_num=1, poc_lsb=3, nref=2)
    return enc


def scenario_cabac_8x8(mb_w: int = 6, frame_mb_h: int = 6):
    """CABAC FIELD pictures with 8x8-transform residuals (ctxBlockCat
    5): drives the Table 9-43 FIELD significance map (kSigCtx8x8Field),
    the field 8x8 bases 436/451 (Table 9-34), the shared last-map
    column and abs base 426, plus transform_size_8x8_flag's neighbor
    context (399+inc) on inter AND I_NxN macroblocks — the one CABAC
    context family previously bin-covered only via x264's MBAFF 8x8dct
    matrix, now first-party (VERDICT r3 #10). High-profile SPS + PPS
    transform_8x8_mode."""
    enc = FieldEncoder(mb_w, frame_mb_h, cabac=True, t8x8=True)

    def i_mix(i):
        r = i % 3
        if r == 0:
            return {"k": "i4"}  # codes transform_size_8x8_flag = 0
        if r == 1:
            return {"k": "i16r", "pred": 2, "dc": [(0, 2), (9, -3)]}
        return {"k": "i4"}

    enc.field(_grid(enc, i_mix), slice_type="I", bottom=False, frame_num=0,
              poc_lsb=0, idr=True)

    def p_mix(i):
        r = i % 6
        if r == 0:
            return {"k": "skip"}
        if r == 1:
            # one coded 8x8: sparse map with an isolated high position
            return {"k": "p16", "mvd": (2, -1), "cbp": 0b0001, "t8x8": True,
                    "coeffs8": {0: [(0, 3), (17, -1), (44, 2)]}}
        if r == 2:
            # 4x4-coded MB in a t8x8 stream: flag coded as 0
            return {"k": "p16", "mvd": (0, 1), "cbp": 0b1000,
                    "coeffs": {10: [(0, -2), (7, 1)]}}
        if r == 3:
            # all four 8x8s coded: dense leading run, EG0 escape
            # (|level|-1 >= 14), implied-last at scan position 63,
            # single-coefficient block
            return {"k": "p16x8", "mvd": [(1, 0), (-2, 3)], "t8x8": True,
                    "cbp": 0b1111,
                    "coeffs8": {
                        0: [(p, (-1) ** p * (p % 5 + 1)) for p in range(9)],
                        1: [(2, 17)],
                        2: [(5, -1), (63, 4)],
                        3: [(30, 1)]}}
        if r == 4:
            # p8x8 (P_L0_8x8 subs): sub8x8_ok, flag still coded
            return {"k": "p8x8",
                    "mvd": [(1, 1), (0, -1), (2, 0), (-1, 2)],
                    "ref": [0, 0, 0, 0], "cbp": 0b0010, "t8x8": True,
                    "coeffs8": {1: [(1, -6), (20, 1), (21, 2), (50, -1)]}}
        return {"k": "p16", "mvd": (-1, -1)}  # cbp 0: no flag coded

    enc.field(_grid(enc, p_mix), slice_type="P", bottom=True, frame_num=0,
              poc_lsb=1)
    enc.field(_grid(enc, lambda i: p_mix(i + 1)), slice_type="P",
              bottom=False, frame_num=1, poc_lsb=2, nref=2)
    enc.field(_grid(enc, lambda i: p_mix(i + 4)), slice_type="P",
              bottom=True, frame_num=1, poc_lsb=3, nref=2)
    return enc


def scenario_field_lt(mb_w: int = 6, frame_mb_h: int = 6) -> FieldEncoder:
    """Homogeneous long-term FIELD pair: both fields of frame 0
    converted short->long in ONE marking list (MMCO 3 x2, field PicNum
    domain — the only long-term field shape libavcodec's frame-granular
    reference model agrees with the spec on); later P fields read
    across the short list + the 8.2.4.2.2 long-term field tail; MMCO 2
    x2 unmarks the pair again; the temporal-direct B fields in between
    map colocated refs through the tail (8.4.1.2.3 bypass)."""
    enc = FieldEncoder(mb_w, frame_mb_h, max_ref=4)
    enc.field(_grid(enc, lambda i: _i16(enc, i, i % 4)), slice_type="I",
              bottom=False, frame_num=0, poc_lsb=0, idr=True)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (6, -4)}),
              slice_type="P", bottom=True, frame_num=0, poc_lsb=1)
    # CurrPicNum = 3 (top): fn0 top has field PicNum 2*0+1 = 1 ->
    # (3, 1, 0); fn0 bottom has PicNum 2*0 = 0 -> (3, 2, 0).
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (1 - i % 3, 2),
                                    "ref": i % 2}),
              slice_type="P", bottom=False, frame_num=1, poc_lsb=8,
              nref=2, mmco=[(3, 1, 0), (3, 2, 0)])
    enc.field(_grid(enc, lambda i: {"k": "p16",
                                    "mvd": (i % 3 - 1, 1 - i % 4),
                                    "ref": i % 3}),
              slice_type="P", bottom=True, frame_num=1, poc_lsb=9,
              nref=3)

    def bmix(i):
        r = i % 4
        if r == 0:
            return {"k": "skip"}
        if r == 1:
            return {"k": "bdirect"}
        if r == 2:
            return {"k": "b16", "kind": "l0", "mvd": [(1, -1)],
                    "ref": [i % 2]}
        return {"k": "b8x8", "sub": ["direct", "l0", "direct", "l1"],
                "mvd": [None, [(2, 0)], None, [(0, 2)]],
                "ref": [None, [0], None, [0]]}

    enc.field(_grid(enc, bmix), slice_type="B", bottom=False, frame_num=2,
              poc_lsb=4, nref=2, nref1=2, ref=False, direct_spatial=False)
    enc.field(_grid(enc, lambda i: bmix(i + 1)), slice_type="B",
              bottom=True, frame_num=2, poc_lsb=5, nref=2, nref1=2,
              ref=False, direct_spatial=True)
    # Unmark the pair (MMCO 2 x2, LongTermPicNum domain: same-parity
    # top = 2*0+1 = 1, opposite bottom = 0), then the bottom mate —
    # libavcodec only outputs woven PAIRS, so the stream must not end
    # on a lone field.
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (0, 1),
                                    "ref": i % 2}),
              slice_type="P", bottom=False, frame_num=2, poc_lsb=10,
              nref=2, mmco=[(2, 1), (2, 0)])
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (2, 0),
                                    "ref": i % 2}),
              slice_type="P", bottom=True, frame_num=2, poc_lsb=11,
              nref=2)
    return enc


def scenario_field_mark(mb_w: int = 6, frame_mb_h: int = 6) -> FieldEncoder:
    """Field-domain short-term marking and reordering: MMCO 1 unmarks
    a single FIELD (PicNum 2*FrameNumWrap+1/+0), and a later P field
    reorders its list with idc-0/1 ops in the field PicNum domain —
    the modified list is what the closing temporal-direct B's
    colocated mapping reads, so both are observable."""
    enc = FieldEncoder(mb_w, frame_mb_h, max_ref=4)
    enc.field(_grid(enc, lambda i: _i16(enc, i, i % 4)), slice_type="I",
              bottom=False, frame_num=0, poc_lsb=0, idr=True)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (4, -2)}),
              slice_type="P", bottom=True, frame_num=0, poc_lsb=1)
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (1 - i % 3, 2),
                                    "ref": i % 2}),
              slice_type="P", bottom=False, frame_num=1, poc_lsb=2,
              nref=2)
    # CurrPicNum = 3 (bottom fn1): the fn0 TOP field (opposite parity)
    # has field PicNum 2*0 = 0 -> diff_minus1 = 2.
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (0, i % 5 - 2),
                                    "ref": i % 3}),
              slice_type="P", bottom=True, frame_num=1, poc_lsb=3,
              nref=3, mmco=[(1, 2)])
    # Reorder in the field domain: CurrPicNum = 5 (top fn2); idc-0
    # val 2 picks PicNum 2 (fn1 BOTTOM, opposite parity), then idc-0
    # val 1 continues the pred chain to PicNum 0 (fn0 bottom — its
    # top mate was the MMCO-1 target above).
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (i % 4 - 2, 1),
                                    "ref": i % 3}),
              slice_type="P", bottom=False, frame_num=2, poc_lsb=4,
              nref=3, list_mod={0: [(0, 2), (0, 1)]})
    # Bottom mate (libavcodec only outputs woven pairs).
    enc.field(_grid(enc, lambda i: {"k": "p16", "mvd": (1, -1),
                                    "ref": i % 2}),
              slice_type="P", bottom=True, frame_num=2, poc_lsb=5,
              nref=2)

    def bmix(i):
        r = i % 3
        if r == 0:
            return {"k": "skip"}
        if r == 1:
            return {"k": "bdirect"}
        return {"k": "b16", "kind": "bi", "mvd": [(1, 0), (0, 1)],
                "ref": [0, 0]}

    enc.field(_grid(enc, bmix), slice_type="B", bottom=False, frame_num=3,
              poc_lsb=6, nref=2, nref1=2, ref=False, direct_spatial=False)
    enc.field(_grid(enc, lambda i: bmix(i + 1)), slice_type="B",
              bottom=True, frame_num=3, poc_lsb=7, nref=2, nref1=2,
              ref=False, direct_spatial=True)
    return enc


SCENARIOS = {
    "ip_basic": scenario_ip_basic,
    "field_lt": scenario_field_lt,
    "field_mark": scenario_field_mark,
    "multiref": scenario_multiref,
    "skip_heavy": scenario_skip_heavy,
    "b_spatial": scenario_b_spatial,
    "b_temporal": scenario_b_temporal,
    "pipeline": scenario_pipeline,
    "adaptive": scenario_adaptive,
    "mbadaptive_fields": scenario_mbadaptive_fields,
    "cabac_ip": scenario_cabac_ip,
    "cabac_b": scenario_cabac_b,
    "cabac_b_temporal": scenario_cabac_b_temporal,
    "cabac_resid": scenario_cabac_resid,
    "cabac_8x8": scenario_cabac_8x8,
}


def main(argv):
    if len(argv) < 3 or argv[1] not in SCENARIOS:
        sys.stderr.write(
            f"usage: {argv[0]} {{{'|'.join(SCENARIOS)}}} OUT.lp264 "
            "[mb_w frame_mb_h]\n")
        return 2
    args = [int(a) for a in argv[3:5]]
    enc = SCENARIOS[argv[1]](*args)
    enc.write(argv[2])
    print(f"{argv[2]}: {len(enc.aus)} field AUs, "
          f"{enc.mb_w}x{enc.frame_mb_h} frame MBs")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
