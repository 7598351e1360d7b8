"""A baseline JPEG decoder in numpy (the port has no Pillow).

``decode_jpeg`` gives what Pillow's ``Image.open(...)`` gives with its
libjpeg-turbo: uint8 ``(H, W, 3)`` for a colour file, ``(H, W, 1)`` for a
grey one, equal value for value.  Three steps are where an almost-right
decoder drifts by one level, and each is libjpeg's own arithmetic here:

* the ISLOW integer IDCT (``jidctint.c``: 13-bit constants, 2 extra bits
  between the passes, the post-IDCT range-limit table that wraps modulo
  1024 before it clamps);
* "fancy" triangle upsampling of the chroma (``jdsample.c``: h2v1, h2v2
  with its alternating +8 / +7 rounding, h1v2 with +1 / +2), which libjpeg
  uses by default, so its merged upsampler never runs; edge samples are
  replicated, and other integer ratios repeat samples;
* the fixed-point YCbCr -> RGB of ``jdcolor.c`` (16 fraction bits).

Scope: baseline and extended sequential DCT (SOF0, SOF1) with 8-bit
samples and Huffman coding; 1 or 3 components (YCbCr, or RGB where an
Adobe marker or the component ids say so); any integer sampling ratios
(4:4:4, 4:2:2, 4:2:0, 4:4:0); restart intervals, byte stuffing, sizes off
the MCU grid; interleaved or one-component scans.  Progressive (SOF2),
lossless and hierarchical frames, arithmetic coding, 12-bit samples and
4-component (CMYK / YCCK) files raise a ``ValueError`` that names what
the file is.  EXIF orientation is not applied, as Pillow's ``open`` does
not apply it.

The Huffman decode is the only serial part: one Python step per coded
coefficient, through 16-bit lookahead tables that carry the code, the
zero run and the coefficient's value bits together.  Dequantisation, the
IDCT, upsampling and colour conversion run as integer numpy over all
blocks at once.
"""

from __future__ import annotations

import functools

import numpy as np

# zigzag position k -> natural (row-major) index of the 8x8 block
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {
    0xC2: "progressive DCT (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential DCT (SOF5, hierarchical)",
    0xC6: "differential progressive DCT (SOF6, hierarchical)",
    0xC7: "differential lossless (SOF7, hierarchical)",
    0xC9: "arithmetic-coded sequential DCT (SOF9)",
    0xCA: "arithmetic-coded progressive DCT (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential DCT (SOF13)",
    0xCE: "arithmetic-coded differential progressive DCT (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}

# jidctint.c
_CONST_BITS, _PASS1_BITS = 13, 2
_FIX_0_298631336, _FIX_0_390180644, _FIX_0_541196100 = 2446, 3196, 4433
_FIX_0_765366865, _FIX_0_899976223, _FIX_1_175875602 = 6270, 7373, 9633
_FIX_1_501321110, _FIX_1_847759065, _FIX_1_961570560 = 12299, 15137, 16069
_FIX_2_053119869, _FIX_2_562915447, _FIX_3_072711026 = 16819, 20995, 25172


def _idct_range_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by the descaled value & 1023:
    v + 128 clamped to [0, 255] for v in [-512, 511], wrapping beyond."""
    v = np.arange(1024)
    v = np.where(v >= 512, v - 1024, v)
    return np.clip(v + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _idct_range_limit()


@functools.lru_cache(maxsize=32)
def _huffman_lut(counts: bytes, symbols: bytes) -> tuple:
    """One Huffman table as a 16-bit lookahead: ``lut[w]`` for the next 16
    bits ``w`` packs the bits to consume (bits 0-4; 0 for an invalid code),
    a flag (bit 5) set when the value bits run past the 16-bit window, the
    symbol (bits 6-13) and the coefficient's value (bits 14 and up, signed),
    where the symbol's low nibble is the value's bit count.  Cached: most
    files carry the same few tables."""
    lut = np.zeros(1 << 16, np.int64)
    w = np.arange(1 << 16, dtype=np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("JPEG: bad Huffman table (code space overrun)")
            sym = symbols[k]
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            s = sym & 15
            if length + s <= 16:
                extra = (w[lo:hi] >> (16 - length - s)) & ((1 << s) - 1)
                value = np.where(extra >= (1 << s >> 1), extra, extra - (1 << s) + 1) \
                    if s else np.zeros_like(extra)
                lut[lo:hi] = (length + s) | (sym << 6) | (value << 14)
            else:
                lut[lo:hi] = length | 32 | (sym << 6)
            code += 1
            k += 1
        code <<= 1
    return tuple(lut.tolist())


def _u16(data: bytes, i: int) -> int:
    return (data[i] << 8) | data[i + 1]


def _split_scan(data: bytes, pos: int):
    """The entropy-coded data from ``pos`` -> (its segments between restart
    markers, unstuffed; the position of the marker that ends the scan)."""
    segments, start, i = [], pos, pos
    n = len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise ValueError("JPEG: the scan runs off the end of the file (truncated)")
        if data[i + 1] == 0x00:            # a stuffed 0xFF data byte
            i += 2
            continue
        j = i
        while j + 1 < n and data[j + 1] == 0xFF:   # fill bytes before a marker
            j += 1
        if j + 1 >= n or data[j + 1] == 0x00:
            raise ValueError(f"JPEG: corrupt data (stray 0xFF at byte {i})")
        segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= data[j + 1] <= 0xD7:     # RSTn: the next restart interval
            start = i = j + 2
            continue
        return segments, j


def _windows(segment: bytes):
    """32-bit big-endian windows at every byte offset of ``segment`` (zero
    padded, as libjpeg fills past the data with zeros)."""
    a = np.frombuffer(segment + b"\x00" * 8, np.uint8).astype(np.int64)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()


def _decode_segment(win, nbits, blocks, dc_luts, ac_luts, coef_idx, coef_val):
    """Huffman-decode the blocks ``[(component, flat coefficient offset)]``
    of one restart interval from ``win``; appends each coefficient's flat
    index (zigzag order within its block) and value."""
    pred = [0] * len(dc_luts)
    p = 0
    ia, va = coef_idx.append, coef_val.append
    for ci, base in blocks:
        e = dc_luts[ci][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        n = e & 31
        if not n:
            raise ValueError("JPEG: corrupt data (invalid DC Huffman code)")
        if e & 32:
            p += n
            s = (e >> 6) & 15
            extra = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
            p += s
            diff = extra if extra >= (1 << (s - 1)) else extra - (1 << s) + 1
        else:
            p += n
            diff = e >> 14
        pred[ci] += diff
        ia(base)
        va(pred[ci])
        lut = ac_luts[ci]
        k = 1
        while k < 64:
            e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            n = e & 31
            if not n:
                raise ValueError("JPEG: corrupt data (invalid AC Huffman code)")
            p += n
            sym = (e >> 6) & 255
            if e & 32:
                s = sym & 15
                extra = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                k += sym >> 4
                ia(base + k)
                va(extra if extra >= (1 << (s - 1)) else extra - (1 << s) + 1)
                k += 1
            elif sym & 15:
                k += sym >> 4
                ia(base + k)
                va(e >> 14)
                k += 1
            elif sym == 0xF0:
                k += 16
            else:
                break                       # end of block
        if k > 64:
            raise ValueError("JPEG: corrupt data (a zero run past the block's end)")
    if p > nbits + 64:
        raise ValueError("JPEG: corrupt or truncated data (the scan read past its end)")


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """jidctint.c's 1-D ISLOW butterfly on int64 arrays -> its 8 outputs
    before the descale (out[0..7])."""
    z1 = (x2 + x6) * _FIX_0_541196100
    tmp2 = z1 - x6 * _FIX_1_847759065
    tmp3 = z1 + x2 * _FIX_0_765366865
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _FIX_1_175875602
    t0 = t0 * _FIX_0_298631336
    t1 = t1 * _FIX_2_053119869
    t2 = t2 * _FIX_3_072711026
    t3 = t3 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised blocks (N, 8, 8) in natural order -> uint8 samples
    (N, 8, 8), libjpeg's ``jpeg_idct_islow`` (columns, then rows)."""
    c = coef.astype(np.int64)
    cols = _idct_1d(*(c[:, k, :] for k in range(8)))
    ws = np.stack([_descale(v, _CONST_BITS - _PASS1_BITS) for v in cols], axis=1)
    rows = _idct_1d(*(ws[:, :, k] for k in range(8)))
    out = np.stack([_descale(v, _CONST_BITS + _PASS1_BITS + 3) for v in rows], axis=2)
    return _RANGE_LIMIT[out & 1023]


def _fancy_h2(x: np.ndarray, bias_even: int, bias_odd: int, shift: int) -> np.ndarray:
    """Horizontal 2x triangle filter along the last axis with replicated
    edges: out[2i] = (3 x[i] + x[i-1] + b0) >> s, out[2i+1] = (3 x[i] +
    x[i+1] + b1) >> s."""
    left = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int32)
    out[..., 0::2] = (3 * x + left + bias_even) >> shift
    out[..., 1::2] = (3 * x + right + bias_odd) >> shift
    return out


def _vertical_sums(x: np.ndarray):
    """(3 x[j] + x[j-1], 3 x[j] + x[j+1]) per row j, edges replicated: the
    column sums of h1v2 / h2v2 for the output rows 2j and 2j+1."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    return 3 * x + up, 3 * x + down


def upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """One component plane (its downsampled size) upsampled by (hr, vr) as
    libjpeg-turbo's ``jdsample.c`` does with fancy upsampling on."""
    x = plane.astype(np.int32)
    w = x.shape[1]
    if (hr, vr) == (1, 1):
        return x
    if (hr, vr) == (2, 1) and w > 2:
        return _fancy_h2(x, 1, 2, 2)
    if (hr, vr) == (1, 2):
        above, below = _vertical_sums(x)
        out = np.empty((2 * x.shape[0], w), np.int32)
        out[0::2], out[1::2] = (above + 1) >> 2, (below + 2) >> 2
        return out
    if (hr, vr) == (2, 2) and w > 2:
        above, below = _vertical_sums(x)
        out = np.empty((2 * x.shape[0], 2 * w), np.int32)
        out[0::2] = _fancy_h2(above, 8, 7, 4)
        out[1::2] = _fancy_h2(below, 8, 7, 4)
        return out
    return np.repeat(np.repeat(x, vr, axis=0), hr, axis=1)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16, ONE_HALF)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ``ycc_rgb_convert`` on int planes -> uint8 (H, W, 3)."""
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None                   # latched at its first scan
        self.offset = 0                     # its first coefficient in the frame's array


class _Frame:
    """The frame header and the coefficients decoded so far: one flat
    array over every component's MCU-padded block grid, component after
    component, filled from (index, value) lists."""

    def __init__(self, height, width, comps):
        self.height, self.width, self.comps = height, width, comps
        self.hmax, self.vmax = max(c.h for c in comps), max(c.v for c in comps)
        self.mcux = _cdiv(width, 8 * self.hmax)
        self.mcuy = _cdiv(height, 8 * self.vmax)
        offset = 0
        for c in comps:
            c.offset = offset
            offset += self.mcux * c.h * self.mcuy * c.v * 64
        self.size = offset
        self.idx, self.val = [], []


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG file's bytes -> uint8 (H, W, 3) (colour) or (H, W, 1)
    (grey), equal to Pillow's decode.  Raises ``ValueError`` on a file
    outside the scope in the module docstring."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame = None
    restart = 0
    jfif, adobe_transform = False, None
    pos = 2
    while True:
        if pos >= len(data):
            raise ValueError("JPEG: no EOI marker (truncated file)")
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError("JPEG: the file ends inside a marker (truncated)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                  # EOI
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > len(data) or pos + _u16(data, pos) > len(data):
            raise ValueError(f"JPEG: marker 0xFF{marker:02X} runs off the end of the file "
                             "(truncated)")
        length = _u16(data, pos)
        seg = data[pos + 2:pos + length]
        if marker in _SOF_NAMES:
            raise ValueError(f"unsupported JPEG: {_SOF_NAMES[marker]}; only baseline "
                             "sequential Huffman JPEG is decoded")
        if marker == 0xCC:
            raise ValueError("unsupported JPEG: arithmetic coding (DAC marker)")
        if marker in (0xC0, 0xC1):          # SOF0 baseline, SOF1 extended sequential
            precision, height, width, nf = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision != 8:
                raise ValueError(f"unsupported JPEG: {precision}-bit samples (8-bit only)")
            if height == 0:
                raise ValueError("unsupported JPEG: height given by a DNL marker")
            if nf == 4:
                raise ValueError("unsupported JPEG: 4 components (CMYK / YCCK)")
            if nf not in (1, 3):
                raise ValueError(f"unsupported JPEG: {nf} components")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                                seg[8 + 3 * i]) for i in range(nf)]
            if any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) for c in comps):
                raise ValueError("JPEG: bad sampling factors")
            frame = _Frame(height, width, comps)
        elif marker == 0xC4:                # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = bytes(seg[i + 1:i + 17])
                symbols = bytes(seg[i + 17:i + 17 + sum(counts)])
                if len(counts) != 16 or len(symbols) != sum(counts):
                    raise ValueError("JPEG: a Huffman table runs past its segment")
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lut(counts, symbols)
                i += 17 + sum(counts)
        elif marker == 0xDB:                # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    qt[tq] = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    qt[tq] = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
        elif marker == 0xDD:                # DRI
            restart = _u16(seg, 0)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:                # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            pos = _decode_scan(data, pos + length, seg, frame, qt, dc_tabs, ac_tabs,
                               restart)
            continue
        pos += length
    if frame is None:
        raise ValueError("JPEG: no frame header")
    return _reconstruct(frame, jfif, adobe_transform)


def _decode_scan(data, pos, seg, frame, qt, dc_tabs, ac_tabs, restart) -> int:
    """One scan: Huffman-decode its blocks into ``frame``'s coefficient
    lists -> the position of the marker after it."""
    ns = seg[0]
    by_id = {c.id: c for c in frame.comps}
    scomps, dcs, acs = [], [], []
    for i in range(ns):
        c = by_id.get(seg[1 + 2 * i])
        if c is None:
            raise ValueError("JPEG: a scan names an unknown component")
        td, ta = seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15
        if td not in dc_tabs or ta not in ac_tabs:
            raise ValueError("JPEG: a scan uses an undefined Huffman table")
        if c.quant is None:
            if c.tq not in qt:
                raise ValueError("JPEG: a component uses an undefined quantisation table")
            c.quant = qt[c.tq]
        scomps.append(c)
        dcs.append(dc_tabs[td])
        acs.append(ac_tabs[ta])
    if (seg[1 + 2 * ns], seg[2 + 2 * ns]) != (0, 63):
        raise ValueError("unsupported JPEG: spectral selection (a progressive scan)")
    if ns == 1:             # one component: its own block grid, one block per MCU
        c = scomps[0]
        bw = _cdiv(_cdiv(frame.width * c.h, frame.hmax), 8)
        bh = _cdiv(_cdiv(frame.height * c.v, frame.vmax), 8)
        stride = frame.mcux * c.h
        mcus = [((0, c.offset + (by * stride + bx) * 64),)
                for by in range(bh) for bx in range(bw)]
    else:                   # interleaved: each component's h x v blocks per MCU
        mcus = [tuple((si, c.offset + ((my * c.v + v) * frame.mcux * c.h + mx * c.h + h) * 64)
                      for si, c in enumerate(scomps) for v in range(c.v) for h in range(c.h))
                for my in range(frame.mcuy) for mx in range(frame.mcux)]
    segments, end = _split_scan(data, pos)
    per = restart or len(mcus)
    n_intervals = _cdiv(len(mcus), per)
    if len(segments) < n_intervals:
        raise ValueError(f"JPEG: {len(segments)} restart intervals, expected {n_intervals}")
    for k in range(n_intervals):
        blocks = [b for mcu in mcus[k * per:(k + 1) * per] for b in mcu]
        try:
            _decode_segment(_windows(segments[k]), 8 * len(segments[k]), blocks, dcs, acs,
                            frame.idx, frame.val)
        except IndexError:      # the bit reader ran past the padded data
            raise ValueError("JPEG: corrupt or truncated data (the scan read past its "
                             "end)") from None
    return end


def _reconstruct(frame: _Frame, jfif: bool, adobe_transform) -> np.ndarray:
    """The frame's coefficients -> dequantised, IDCT'd, upsampled and
    colour-converted uint8 pixels."""
    coef = np.zeros(frame.size, np.int64)
    coef[np.asarray(frame.idx, np.int64)] = np.asarray(frame.val, np.int64)
    planes = []
    for c in frame.comps:
        if c.quant is None:
            raise ValueError("JPEG: a component is in no scan")
        if frame.hmax % c.h or frame.vmax % c.v:
            raise ValueError("unsupported JPEG: fractional sampling ratios")
        bw, bh = frame.mcux * c.h, frame.mcuy * c.v
        zz = coef[c.offset:c.offset + bw * bh * 64].reshape(-1, 64) * c.quant[None, :]
        nat = np.empty_like(zz)
        nat[:, NATURAL_ORDER] = zz
        pix = idct_islow(nat.reshape(-1, 8, 8))
        plane = pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        cw = _cdiv(frame.width * c.h, frame.hmax)
        ch = _cdiv(frame.height * c.v, frame.vmax)
        planes.append(upsample(plane[:ch, :cw], frame.hmax // c.h, frame.vmax // c.v)
                      [:frame.height, :frame.width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)[:, :, None]
    if jfif:
        rgb = False
    elif adobe_transform is not None:
        rgb = adobe_transform == 0
    else:
        rgb = tuple(c.id for c in frame.comps) == (0x52, 0x47, 0x42)    # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> uint8 (H, W, 3) or (H, W, 1) (see :func:`decode_jpeg`)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
