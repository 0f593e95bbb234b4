"""A VP8 key frame's boolean-coded decisions, read and written again, for
tests/make_raster_fixtures.py's WebP variants that Pillow cannot write: a
frame Pillow (libwebp) encoded is parsed into the (bit, probability) pairs
of its first partition, header field by header field, and of each
macroblock row's tokens; the header is changed (the simple loop filter,
sharpness, the ref/mode filter deltas, the number of token partitions)
and everything is coded again with RFC 6386's boolean encoder.  The
decisions are the frame's own, so the pixels change only where the loop
filter does.  The constant tables are read from the port's decoder
(data/csrc/webp_decode.cpp); imageio's decode of the new file is what the
port is held to, so a wrong table here shows as a mismatch, not a pass."""

import os
import re
import struct

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "terrain_tpu_torch", "data", "csrc", "webp_decode.cpp")


def _table(text, name):
    body = re.search(name + r"[^=]*= \{(.*?)\};", text, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)])


with open(SRC) as _f:
    _TEXT = _f.read()
BANDS = _table(_TEXT, "kBands")
PROBA0 = _table(_TEXT, "kCoeffsProba0").reshape(4, 8, 3, 11)
UPDATE = _table(_TEXT, "kCoeffsUpdateProba").reshape(4, 8, 3, 11)
BMODES = _table(_TEXT, "kBModesProba").reshape(10, 10, 9)
YMODES4 = _table(_TEXT, "kYModesIntra4")
CATS = [list(_table(_TEXT, k)[:-1]) for k in ("kCat3", "kCat4", "kCat5",
                                               "kCat6")]


class Reader:
    """libwebp's boolean decoder, recording each decision."""

    def __init__(self, data):
        self.buf, self.pos = data, 0
        self.value, self.range, self.bits = 0, 254, -8
        self.log = []
        self._load()

    def _load(self):
        if self.pos < len(self.buf):
            self.bits += 8
            self.value = self.buf[self.pos] | (self.value << 8)
            self.pos += 1
        else:
            raise ValueError("VP8: a partition read past its end")

    def bit(self, prob):
        r = self.range
        if self.bits < 0:
            self._load()
        split = (r * prob) >> 8
        v = self.value >> self.bits
        b = int(v > split)
        if b:
            r -= split
            self.value -= (split + 1) << self.bits
        else:
            r = split + 1
        shift = 7 ^ (r.bit_length() - 1)
        self.bits -= shift
        self.range = (r << shift) - 1
        self.log.append((b, prob))
        return b

    def value_bits(self, n):
        v = 0
        for i in range(n - 1, -1, -1):
            v |= self.bit(128) << i
        return v

    def signed(self, n):
        v = self.value_bits(n)
        return -v if self.bit(128) else v


class Writer:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, b, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
            assert self.bottom < 1 << 32
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def bits(self, pairs):
        for b, p in pairs:
            self.bit(b, p)

    def finish(self):
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _value(v, n):
    return [((v >> i) & 1, 128) for i in range(n - 1, -1, -1)]


def _signed(v, n):
    return _value(abs(v), n) + [(int(v < 0), 128)]


class Frame:
    """A VP8 key frame as decisions: `groups` the first partition's header
    fields (name -> pairs), `modes` its intra-mode pairs, `rows` each
    macroblock row's token pairs."""

    def __init__(self, data):
        tag = data[0] | data[1] << 8 | data[2] << 16
        self.profile = tag & 0xE
        self.head = bytes(data[3:10])
        part0 = tag >> 5
        w, h = (struct.unpack("<H", data[6:8])[0] & 0x3FFF,
                struct.unpack("<H", data[8:10])[0] & 0x3FFF)
        mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
        br = Reader(data[10:10 + part0])
        groups = {}

        def group(name, fn):
            start = len(br.log)
            out = fn()
            groups[name] = br.log[start:]
            return out

        group("colour", lambda: br.value_bits(2))
        seg = {}

        def segments():
            seg["use"] = br.bit(128)
            seg["update_map"] = 0
            seg["probs"] = [255] * 3
            if seg["use"]:
                seg["update_map"] = br.bit(128)
                if br.bit(128):
                    br.bit(128)
                    for _ in range(8):
                        if br.bit(128):
                            br.signed(7 if _ < 4 else 6)
                if seg["update_map"]:
                    seg["probs"] = [br.value_bits(8) if br.bit(128) else 255
                                    for _ in range(3)]

        group("segments", segments)

        def filt():
            f = {"simple": br.bit(128), "level": br.value_bits(6),
                 "sharpness": br.value_bits(3), "ref": [0] * 4,
                 "mode": [0] * 4}
            f["use_delta"] = br.bit(128)
            if f["use_delta"] and br.bit(128):
                for k in ("ref", "mode"):
                    for i in range(4):
                        if br.bit(128):
                            f[k][i] = br.signed(6)
            return f

        self.filter = group("filter", filt)
        parts = group("parts", lambda: 1 << br.value_bits(2))
        group("quant", lambda: [br.value_bits(7)] + [
            br.signed(4) if br.bit(128) else 0 for _ in range(5)])
        proba = np.array(PROBA0)

        def probas():
            br.bit(128)
            for t in range(4):
                for b in range(8):
                    for c in range(3):
                        for p in range(11):
                            if br.bit(int(UPDATE[t, b, c, p])):
                                proba[t, b, c, p] = br.value_bits(8)
            use_skip = br.bit(128)
            return br.value_bits(8) if use_skip else None

        skip_p = group("probas", probas)
        self.groups = groups
        # intra modes (partition 0) and tokens (the token partitions)
        sizes = data[10 + part0:10 + part0 + 3 * (parts - 1)]
        at = 10 + part0 + 3 * (parts - 1)
        readers = []
        for p in range(parts):
            n = (sizes[3 * p] | sizes[3 * p + 1] << 8 | sizes[3 * p + 2] << 16
                 if p < parts - 1 else len(data) - at)
            readers.append(Reader(data[at:at + n]))
            at += n
        mode_start = len(br.log)
        intra_t = [0] * (4 * mb_w)
        top_nz, top_dc = [0] * mb_w, [0] * mb_w
        self.rows = []
        for mb_y in range(mb_h):
            left = [0] * 4
            kinds = []
            for mb_x in range(mb_w):
                if seg["update_map"]:
                    if not br.bit(seg["probs"][0]):
                        br.bit(seg["probs"][1])
                    else:
                        br.bit(seg["probs"][2])
                skip = br.bit(skip_p) if skip_p is not None else 0
                i4 = not br.bit(145)
                top = intra_t[4 * mb_x:4 * mb_x + 4]
                if not i4:
                    if br.bit(156):
                        ymode = 1 if br.bit(128) else 3
                    else:
                        ymode = 2 if br.bit(163) else 0
                    top, left = [ymode] * 4, [ymode] * 4
                else:
                    for y in range(4):
                        ymode = left[y]
                        for x in range(4):
                            prob = BMODES[top[x], ymode]
                            i = YMODES4[br.bit(int(prob[0]))]
                            while i > 0:
                                i = YMODES4[2 * i + br.bit(int(prob[i]))]
                            ymode = -i
                            top[x] = ymode
                        left[y] = ymode
                intra_t[4 * mb_x:4 * mb_x + 4] = top
                if br.bit(142) and br.bit(114):
                    br.bit(183)
                kinds.append((skip, i4))
            tr = readers[mb_y % parts]
            start = len(tr.log)
            lnz = ldc = 0
            for mb_x, (skip, i4) in enumerate(kinds):
                if skip:
                    top_nz[mb_x] = lnz = 0
                    if not i4:
                        top_dc[mb_x] = ldc = 0
                    continue
                if not i4:
                    nz = _coeffs(tr, proba[1], top_dc[mb_x] + ldc, 0)
                    top_dc[mb_x] = ldc = int(nz > 0)
                first, ac = (0, proba[3]) if i4 else (1, proba[0])
                tnz, lz = top_nz[mb_x] & 15, lnz & 15
                for y in range(4):
                    lb = lz & 1
                    for x in range(4):
                        nz = _coeffs(tr, ac, lb + (tnz & 1), first)
                        lb = int(nz > first)
                        tnz = (tnz >> 1) | (lb << 7)
                    tnz >>= 4
                    lz = (lz >> 1) | (lb << 7)
                out_t, out_l = tnz, lz >> 4
                for ch in (0, 2):
                    tnz = top_nz[mb_x] >> (4 + ch)
                    lz = lnz >> (4 + ch)
                    for y in range(2):
                        lb = lz & 1
                        for x in range(2):
                            nz = _coeffs(tr, proba[2], lb + (tnz & 1), 0)
                            lb = int(nz > 0)
                            tnz = (tnz >> 1) | (lb << 3)
                        tnz >>= 2
                        lz = (lz >> 1) | (lb << 5)
                    out_t |= (tnz << 4) << ch
                    out_l |= (lz & 0xF0) << ch
                top_nz[mb_x], lnz = out_t & 0xFF, out_l & 0xFF
            self.rows.append(tr.log[start:])
        self.modes = br.log[mode_start:]

    def encode(self, simple=None, sharpness=None, level=None, deltas=None,
               parts=None):
        """The frame coded again, its header changed as given: simple
        (0/1), sharpness (0-7), level (0-63), deltas ((ref[4], mode[4])
        or None to keep), parts (1, 2, 4 or 8 token partitions)."""
        f = dict(self.filter)
        if simple is not None:
            f["simple"] = simple
        if sharpness is not None:
            f["sharpness"] = sharpness
        if level is not None:
            f["level"] = level
        filt = ([(f["simple"], 128)] + _value(f["level"], 6)
                + _value(f["sharpness"], 3))
        if deltas is None:  # the frame's own
            filt += self.groups["filter"][10:]
        else:
            filt += [(1, 128), (1, 128)]
            for v in deltas[0] + deltas[1]:
                filt += [(1, 128)] + _signed(v, 6) if v else [(0, 128)]
        nparts = parts or 1 << (self.groups["parts"][0][0] * 2
                                + self.groups["parts"][1][0])
        w = Writer()
        for name in ("colour", "segments"):
            w.bits(self.groups[name])
        w.bits(filt)
        w.bits(_value(nparts.bit_length() - 1, 2))
        for name in ("quant", "probas"):
            w.bits(self.groups[name])
        w.bits(self.modes)
        first = w.finish()
        toks = [Writer() for _ in range(nparts)]
        for y, pairs in enumerate(self.rows):
            toks[y % nparts].bits(pairs)
        toks = [t.finish() for t in toks]
        sizes = b"".join(struct.pack("<I", len(t))[:3] for t in toks[:-1])
        tag = len(first) << 5 | 1 << 4 | self.profile  # a key frame, shown
        return (struct.pack("<I", tag)[:3] + self.head + first + sizes
                + b"".join(toks))


def _coeffs(br, bands, ctx, n):
    """Read one block's tokens from position n, as the decoder does."""
    p = bands[BANDS[n], ctx]
    while n < 16:
        if not br.bit(int(p[0])):
            return n
        while not br.bit(int(p[1])):
            n += 1
            if n == 16:
                return 16
            p = bands[BANDS[n], 0]
        if not br.bit(int(p[2])):
            p = bands[BANDS[n + 1], 1]
        else:
            _large(br, p)
            p = bands[BANDS[n + 1], 2]
        br.bit(128)  # the sign
        n += 1
    return 16


def _large(br, p):
    if not br.bit(int(p[3])):
        if br.bit(int(p[4])):
            br.bit(int(p[5]))
    elif not br.bit(int(p[6])):
        if not br.bit(int(p[7])):
            br.bit(159)
        else:
            br.bit(165)
            br.bit(145)
    else:
        b1 = br.bit(int(p[8]))
        b0 = br.bit(int(p[9 + b1]))
        for prob in CATS[2 * b1 + b0]:
            br.bit(int(prob))
