"""The port's JPEG decoder (terrain_tpu_torch/data/jpeg.py and its host C++)
against imageio.v3.imread, the JAX package's reader (libjpeg-turbo through
Pillow), byte for byte.

Pillow writes seeded images at every sampling it offers (grayscale, 4:4:4,
4:2:2, 4:2:0), at qualities 50, 75 and 95, with and without optimized
Huffman tables and restart markers, at sizes from 1x1 to 37x53.  4:4:0
and the other factor mixes Pillow cannot write come from a small
baseline encoder here (`_encode`), whose files imageio decodes too.
Progressive files at every sampling and size, with restart intervals in
every scan, and the same files cut after each of their scans (EOI spliced
in after a whole scan, so libjpeg-turbo smooths the blocks whose
coefficients are still unrefined) decode to imageio's bytes too.  CMYK,
arithmetic-coded (sequential and progressive), lossless, 12-bit and
non-interleaved sequential files are refused naming their kind.  The
committed fixtures of tests/data/jpeg/ (tests/make_jpeg_fixtures.py, read
by chip_smoke.py on the card) still match imageio and the decoder, and
`_get_data` with a JPEG texture gives terrain_tpu's crops.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest

from terrain_tpu_torch import experiments
from make_jpeg_fixtures import cut_after_scan
from terrain_tpu_torch.data.jpeg import decode_jpeg, read_header
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
Image = pytest.importorskip("PIL.Image")
ImageFile = pytest.importorskip("PIL.ImageFile")
# a progressive file is written whole into Pillow's buffer
ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 1 << 24)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "jpeg")
SIZES = [(1, 1), (17, 33), (37, 53), (8, 8), (2, 3), (16, 1)]


def _image(h, w, seed, channels=3):
    """A seeded image: a smooth ramp and noise, so both low and high
    frequencies carry energy."""
    rnd = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 7 + xx * 5)[..., None] + np.arange(channels) * 60
    img = base + rnd.randint(-40, 40, (h, w, channels))
    img = np.clip(img % 256, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _pil_jpeg(img, **opts):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _assert_decodes_as_imageio(data):
    want = np.asarray(iio.imread(data))
    got = decode_jpeg(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sampling", ["gray", "4:4:4", "4:2:2", "4:2:0"])
def test_pillow_files_decode_to_imageios_bytes(size, sampling):
    h, w = size
    for i, (q, optimize, rst) in enumerate([(50, False, 0), (75, True, 0),
                                            (95, False, 1), (95, True, 2)]):
        opts = dict(quality=q, optimize=optimize)
        if rst:
            opts["restart_marker_blocks"] = rst
        if sampling == "gray":
            img = _image(h, w, i, channels=1)
        else:
            img = _image(h, w, i)
            opts["subsampling"] = sampling
        _assert_decodes_as_imageio(_pil_jpeg(img, **opts))


def test_restart_marker_rows_and_a_large_image():
    img = _image(300, 700, 5)
    for sampling in ("4:2:0", "4:2:2", "4:4:4"):
        _assert_decodes_as_imageio(_pil_jpeg(
            img, quality=90, subsampling=sampling, restart_marker_rows=1))
    _assert_decodes_as_imageio(_pil_jpeg(img[..., 0], quality=80,
                                         restart_marker_rows=3))


# ----------------------------------------------- a small baseline encoder
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
_C = np.array([[np.sqrt((1 if u == 0 else 2) / 8)
                * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
               for u in range(8)])


def _huffman_table(freq):
    """(bits, values) of an optimal length-limited code for the symbol
    counts, libjpeg's jpeg_gen_optimal_table (one code point reserved)."""
    freq = list(freq) + [1]
    size, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if freq[i] > 0]
        if len(live) < 2:
            break
        c1 = min(live, key=lambda i: (freq[i], -i))
        c2 = min((i for i in live if i != c1), key=lambda i: (freq[i], -i))
        freq[c1] += freq[c2]
        freq[c2] = 0
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if size[i]:
            bits[size[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    values = [s for n in range(1, 33) for s in range(256) if size[s] == n]
    return bits[1:17], values


def _codes(bits, values):
    code, out, k = 0, {}, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _category(v):
    return int(abs(v)).bit_length()


def _encode(img, factors, quality=75, restart=0):
    """A baseline JPEG of img (H, W, C) uint8, read as YCbCr, with the
    components' (h, v) sampling factors: each component averaged to its
    size, one interleaved scan, optimal Huffman tables, restart markers
    every `restart` MCUs."""
    h, w, nc = img.shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qtab = np.clip((np.arange(64) % 8 + np.arange(64) // 8 + 2) * 200
                   // quality, 1, 255)  # natural order
    comps = []
    for c, (fh, fv) in enumerate(factors):
        sy, sx = vmax // fv, hmax // fh
        plane = img[..., c].astype(np.float64)
        ph, pw = mcuy * 8 * vmax, mcux * 8 * hmax
        plane = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
        plane = plane.reshape(ph // sy, sy, pw // sx, sx).mean((1, 3))
        blocks = plane.reshape(plane.shape[0] // 8, 8, plane.shape[1] // 8,
                               8).transpose(0, 2, 1, 3) - 128
        coef = np.einsum("ux,abxy,vy->abuv", _C, blocks, _C)
        q = np.round(coef.reshape(*coef.shape[:2], 64) / qtab).astype(int)
        comps.append(q[..., _ZIGZAG])
    # symbols, in scan order
    syms, preds, n_mcu = [], [0] * nc, 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n_mcu and n_mcu % restart == 0:
                syms.append(("rst", n_mcu // restart - 1))
                preds = [0] * nc
            n_mcu += 1
            for c, (fh, fv) in enumerate(factors):
                for by in range(fv):
                    for bx in range(fh):
                        blk = comps[c][my * fv + by, mx * fh + bx]
                        diff = blk[0] - preds[c]
                        preds[c] = blk[0]
                        syms.append(("dc", diff))
                        run = 0
                        for k in range(1, 64):
                            v = blk[k]
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                syms.append(("ac", 0xF0, 0))
                                run -= 16
                            syms.append(("ac", (run << 4) | _category(v), v))
                            run = 0
                        if run:
                            syms.append(("ac", 0x00, 0))
    dc_freq, ac_freq = [0] * 256, [0] * 256
    for s in syms:
        if s[0] == "dc":
            dc_freq[_category(s[1])] += 1
        elif s[0] == "ac":
            ac_freq[s[1]] += 1
    dc_tab, ac_tab = _huffman_table(dc_freq), _huffman_table(ac_freq)
    dc_codes, ac_codes = _codes(*dc_tab), _codes(*ac_tab)
    out, acc, nbits = bytearray(), 0, 0

    def put(value, length):
        nonlocal acc, nbits
        acc = (acc << length) | (value & ((1 << length) - 1))
        nbits += length
        while nbits >= 8:
            byte = (acc >> (nbits - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nbits -= 8

    def flush():
        if nbits % 8:
            put(0x7F, 8 - nbits % 8)

    def value_bits(v):
        n = _category(v)
        return (v if v >= 0 else v + (1 << n) - 1), n

    for s in syms:
        if s[0] == "rst":
            flush()
            out += bytes([0xFF, 0xD0 + s[1] % 8])
        elif s[0] == "dc":
            put(*dc_codes[_category(s[1])])
            if s[1]:
                put(*value_bits(s[1]))
        else:
            put(*ac_codes[s[1]])
            if s[1] & 15:
                put(*value_bits(s[2]))
    flush()

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") \
            + bytes(body)

    head = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                             b"\x00\x00")
    head += seg(0xDB, bytes([0]) + bytes(qtab[_ZIGZAG].astype(np.uint8)))
    sof = [8, h >> 8, h & 255, w >> 8, w & 255, nc]
    for c, (fh, fv) in enumerate(factors):
        sof += [c + 1, (fh << 4) | fv, 0]
    head += seg(0xC0, sof)
    for cls, (bits, values) in ((0x00, dc_tab), (0x10, ac_tab)):
        head += seg(0xC4, [cls] + bits + values)
    if restart:
        head += seg(0xDD, [restart >> 8, restart & 255])
    sos = [nc]
    for c in range(nc):
        sos += [c + 1, 0x00]
    head += seg(0xDA, sos + [0, 63, 0])
    return head + bytes(out) + b"\xff\xd9"


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("factors", [
    ((1, 2), (1, 1), (1, 1)),   # 4:4:0
    ((2, 2), (1, 1), (1, 1)),   # 4:2:0
    ((2, 1), (1, 1), (1, 1)),   # 4:2:2
    ((2, 2), (1, 2), (2, 1)),   # chroma planes subsampled each its own way
    ((1, 1), (2, 2), (1, 1)),   # luma the smaller plane
])
def test_other_sampling_factors_decode_to_imageios_bytes(size, factors):
    for restart in (0, 1):
        _assert_decodes_as_imageio(_encode(_image(*size, seed=3), factors,
                                           restart=restart))


# ------------------------------------------------------------- progressive
def _scans(data):
    """Offsets of the SOS markers of a JPEG."""
    out, i = [], data.find(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


@pytest.mark.parametrize("size", SIZES + [(24, 40), (45, 70)])
@pytest.mark.parametrize("sampling", ["gray", "4:4:4", "4:2:2", "4:2:0"])
def test_progressive_files_decode_to_imageios_bytes(size, sampling):
    """Pillow's progressive files (libjpeg's jpeg_simple_progression: DC
    first and refinement scans, interleaved; spectral selection and
    successive approximation in the AC scans, with EOB runs), whole and cut
    after every scan (block smoothing where bits are unrefined: 24x40
    4:2:0 has an odd count of luma block rows, whose last iMCU row
    libjpeg-turbo smooths with its own row arithmetic), and with restart
    intervals (every block, every MCU row) in every scan."""
    h, w = size
    for i, q in enumerate((50, 92)):
        opts = dict(quality=q, progressive=True)
        if sampling == "gray":
            img = _image(h, w, i, channels=1)
        else:
            img = _image(h, w, i)
            opts["subsampling"] = sampling
        data = _pil_jpeg(img, **opts)
        for k in range(1, len(_scans(data))):
            _assert_decodes_as_imageio(cut_after_scan(data, k))
        _assert_decodes_as_imageio(data)
        _assert_decodes_as_imageio(_pil_jpeg(img, restart_marker_blocks=1,
                                             **opts))
        _assert_decodes_as_imageio(_pil_jpeg(img, restart_marker_rows=1,
                                             optimize=True, **opts))


def test_progressive_large_image_and_its_header():
    img = _image(300, 700, 6)
    for sampling in ("4:2:0", "4:2:2"):
        data = _pil_jpeg(img, quality=85, subsampling=sampling,
                         progressive=True, restart_marker_rows=2)
        assert read_header(data) == (300, 700, 3)
        _assert_decodes_as_imageio(data)
        _assert_decodes_as_imageio(cut_after_scan(data, 4))


def test_damaged_progressive_files_raise_value_error():
    data = _pil_jpeg(_image(40, 56, 1), quality=80, progressive=True,
                     restart_marker_blocks=2)
    with pytest.raises(ValueError, match="without an EOI marker"):
        decode_jpeg(data[:_scans(data)[3]])
    with pytest.raises(ValueError, match="restart marker is missing in "
                                         "scan 1"):
        decode_jpeg(data.replace(b"\xff\xd1", b"\xff\xd5", 1))
    i = _scans(data)[2]
    bad = bytearray(data)
    bad[i + 4 + 2 * bad[i + 4] + 1] = 0  # Ss 0 with Se > 0
    with pytest.raises(ValueError, match="progressive scan of bad"):
        decode_jpeg(bytes(bad))


# ---------------------------------------------------------------- refusals
def _sof_patched(data, marker=None, precision=None, sof=0xC0):
    """data with its SOF (SOF0 unless `sof` says) turned into another frame
    type or precision."""
    i = data.index(bytes([0xFF, sof]))
    data = bytearray(data)
    if marker is not None:
        data[i + 1] = marker
    if precision is not None:
        data[i + 4] = precision
    return bytes(data)


def _one_component_scan(data):
    """A baseline colour file whose SOS names its first component only: a
    sequential JPEG of several scans."""
    i = data.index(b"\xff\xda")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    body = data[i + 4:i + 2 + n]
    sos = bytes([1, body[1], body[2], 0, 63, 0])
    return (data[:i] + b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big")
            + sos + data[i + 2 + n:])


@pytest.mark.parametrize("kind,make,match", [
    ("progressive", lambda img: _sof_patched(
        _pil_jpeg(img, progressive=True), marker=0xCA, sof=0xC2),
     r"arithmetic-coded progressive \(SOF10\)"),
    ("non-interleaved sequential", lambda img: _one_component_scan(
        _pil_jpeg(img)), r"several scans \(1 of 3 components"),
    ("cmyk", lambda img: _cmyk(img), r"4-component \(CMYK/YCCK\)"),
    ("arithmetic", lambda img: _sof_patched(_pil_jpeg(img), marker=0xC9),
     r"arithmetic-coded sequential \(SOF9\)"),
    ("lossless", lambda img: _sof_patched(_pil_jpeg(img), marker=0xC3),
     r"lossless \(SOF3\)"),
    ("12-bit", lambda img: _sof_patched(_pil_jpeg(img), precision=12),
     r"12-bit samples \(SOF0\)"),
])
def test_unsupported_jpegs_are_refused_by_name(kind, make, match):
    data = make(_image(24, 40, 0))
    with pytest.raises(NotImplementedError, match=match):
        decode_jpeg(data)
    with pytest.raises(NotImplementedError, match=match):
        read_header(data)


def _cmyk(img):
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def test_damaged_files_raise_value_error():
    data = _pil_jpeg(_image(24, 40, 0), restart_marker_blocks=1)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG" + data[4:])
    with pytest.raises(ValueError, match="restart marker"):
        decode_jpeg(data.replace(b"\xff\xd1", b"\xff\xd5", 1))
    with pytest.raises(ValueError, match="SOS"):
        decode_jpeg(data[:data.index(b"\xff\xda")])


@pytest.mark.parametrize("n_short", [2, 3, 200])
def test_an_over_full_huffman_table_raises_value_error(n_short):
    """A DHT with more codes of length 1 than that length holds (two codes
    of length 1 would make one of them all ones, which jdhuff.c refuses
    too) raises before the table is built, so a damaged file never writes
    past the lookup table."""
    data = _pil_jpeg(_image(24, 40, 0))
    vals = bytes(range(n_short))
    body = bytes([0x00, n_short]) + bytes(15) + vals  # DC table 0
    dht = b"\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body
    sos = data.index(b"\xff\xda")
    bad = data[:sos] + dht + data[sos:]
    with pytest.raises(ValueError, match="Huffman table"):
        decode_jpeg(bad)
    with pytest.raises(Exception):
        iio.imread(bad)


# ---------------------------------------------------------------- fixtures
def test_committed_fixtures_match_imageio_and_the_decoder(tmp_path):
    """The script makes the same files again (Pillow is seeded and
    deterministic), their imageio digests are the committed ones, and the
    decoder gives those bytes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixtures", os.path.join(HERE, "make_jpeg_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        committed = json.load(f)
    assert mod.main(str(tmp_path)) == committed
    for name, want in committed.items():
        if name == "reference":  # the versions that decoded them
            continue
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        assert data == (tmp_path / name).read_bytes()
        got = decode_jpeg(data)
        assert list(got.shape) == want["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


def test_get_data_with_a_jpeg_texture_gives_terrain_tpus_crops(
        tmp_path, monkeypatch):
    """TERRAIN_RASTER=hm.png,tex.jpg (and a JPEG heightmap): the port's
    first batches equal terrain_tpu's, which decodes with imageio."""
    from terrain_tpu import experiments as jexp
    from terrain_tpu_torch.serve.png import encode_png

    rnd = np.random.RandomState(0)
    h, w = 150, 190
    hm = np.zeros((h, w), np.uint8)
    hm[:, w // 3:] = rnd.randint(1, 255, (h, w - w // 3))
    tex = _image(h, w, 1)
    paths = {"hm.png": encode_png(hm), "hm.jpg": _pil_jpeg(hm, quality=90),
             "tex.jpg": _pil_jpeg(tex, quality=85, subsampling="4:2:0")}
    for name, data in paths.items():
        (tmp_path / name).write_bytes(data)
    for hm_name in ("hm.png", "hm.jpg"):
        value = f"{tmp_path / hm_name},{tmp_path / 'tex.jpg'}"
        for k, v in {"TERRAIN_RASTER": value, "TERRAIN_BS": "2",
                     "TERRAIN_EPOCH_CROPS": "20"}.items():
            monkeypatch.setenv(k, v)
        mine = experiments._get_data(64, device="cpu")
        ref = jexp._get_data(64)
        for it, jit in zip(mine, ref):
            assert it.N == jit.N
            for _ in range(2):
                for a, b in zip(next(it), next(jit)):
                    np.testing.assert_array_equal(a, b)
