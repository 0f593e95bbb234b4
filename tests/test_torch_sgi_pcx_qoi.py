"""The SGI, PCX and QOI decoders (terrain_tpu_torch/data/sgi.py, pcx.py and
qoi.py, with data/csrc/raster_decode.cpp's sgi_rle, pcx_rle and qoi_decode)
against imageio, which reads all three through Pillow: every committed
fixture of tests/data/{sgi,pcx,qoi} (tests/make_raster_fixtures.py) to
imageio's shape, dtype and SHA-256 from its bytes and its path (or the
exception imageio raises), Pillow's files at random sizes, seeded
run-length streams, files cut at many offsets, the thread count of the SGI
rows, imageio's choice of plugin by name, and an SGI + QOI pair's first
batches against terrain_tpu's `_get_data`.  Images are a few dozen pixels
a side."""

import io

import numpy as np
import pytest

from raster_cases import (check_fixture, digests, exception, rerun,
                          same_first_batches, script, summary)
from terrain_tpu_torch.data import cvread, pcx, qoi, sgi
from terrain_tpu_torch.data.raster import read_raster
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

iio = pytest.importorskip("imageio.v3")
Image = pytest.importorskip("PIL.Image")
mk = script()
DECODERS = {"sgi": sgi.decode_sgi, "pcx": pcx.decode_pcx,
            "qoi": qoi.decode_qoi}


def _pillow(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def same_as_imageio(decode, src):
    """decode(src) gives imageio.v3.imread(src)'s array, or raises the
    exception imageio raises there; 1 where it decoded."""
    try:
        want = iio.imread(src)
    except Exception as e:  # noqa: BLE001 -- imageio raises many kinds
        with pytest.raises(exception(mk.error_name(e))):
            decode(src)
        return 0
    assert summary(decode(src)) == summary(want)
    return 1


@pytest.mark.parametrize("kind,name", [(k, n) for k in DECODERS
                                       for n in sorted(digests(k))])
def test_each_fixture_decodes_to_imageios_array(kind, name):
    check_fixture(kind, name, DECODERS[kind])


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_committed_fixtures_match_the_script(kind, tmp_path):
    rerun(kind, tmp_path)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fmt,mode,kw", [
    ("SGI", "L", {}), ("SGI", "RGB", {}), ("SGI", "RGBA", {}),
    ("SGI", "L", {"bpc": 2}), ("SGI", "RGBA", {"bpc": 2}),
    ("PCX", "1", {}), ("PCX", "L", {}), ("PCX", "P", {}), ("PCX", "RGB", {}),
    ("QOI", "RGB", {}), ("QOI", "RGBA", {})])
def test_pillows_files_decode_as_imageio(fmt, mode, kw, seed, tmp_path):
    """At random sizes (odd widths), by bytes and at a path."""
    rnd = np.random.RandomState(seed)
    w, h = int(rnd.randint(3, 40)), int(rnd.randint(1, 30))
    img = Image.fromarray(mk.terrain(h, w, seed + 7, 4))
    img = img.convert("RGB").quantize(int(rnd.randint(2, 120))) \
        if mode == "P" else img.convert(mode)
    data = _pillow(img, fmt, **kw)
    ext = {"SGI": ".rgb", "PCX": ".pcx", "QOI": ".qoi"}[fmt]
    path = tmp_path / f"a{ext}"
    path.write_bytes(data)
    same_as_imageio(DECODERS[fmt.lower()], data)
    same_as_imageio(read_raster, str(path))


@pytest.mark.parametrize("seed", range(6))
def test_random_sgi_run_length_rows_decode_as_pillow(seed):
    """Rows that share data, end early, or whose length field stops the
    decode (refused by name) or overruns: each as Pillow's SgiRleDecode
    takes it."""
    rnd = np.random.RandomState(seed)
    z, bpc = int(rnd.choice([1, 3, 4])), int(rnd.choice([1, 2]))
    w, h = int(rnd.randint(1, 30)), int(rnd.randint(1, 12))
    planes = rnd.randint(0, 4, (z, h, w)).astype(np.uint16) * 60
    rows = []
    for c in range(z):
        for r in range(h):
            row = mk._sgi_rle_row(planes[c, h - 1 - r].tolist(), bpc)
            u = rnd.rand()
            if u < 0.15:
                row = (row[:2 * bpc] + bytes(bpc), len(row))  # ends early
            elif u < 0.25:
                row = (row, int(rnd.randint(1, 4)))  # length field short
            elif u < 0.3 and rows:
                row = (512 + 8 * z * h, int(rnd.randint(1, 40)))  # shared
            rows.append(row)
    data = mk.sgi_bytes(planes if bpc == 2 else planes.astype(np.uint8),
                        bpc, 1, rows=rows)
    try:
        same_as_imageio(sgi.decode_sgi, data)
    except NotImplementedError as e:  # Pillow leaves rows unwritten
        assert "stops the decode there" in str(e)


@pytest.mark.parametrize("planes", [1, 2, 4])
def test_random_pcx_bit_planes_decode_as_pillow(planes):
    """1-bit planes at widths whose stride is padded or not (Pillow moves
    padded planes together before its unpacker reads them)."""
    rnd = np.random.RandomState(planes)
    for w in (1, 2, 3, 5, 8, 9, 15, 16, 17, 33):
        st = (w + 7) // 8
        for given in (st, st + 1):
            stride = st + (st % 2 if given != st else 0)
            lines = rnd.randint(0, 256, (3, planes * stride)).astype(np.uint8)
            data = mk.pcx_bytes(lines, w, 3, 1, planes, given, 2,
                                bytes(rnd.randint(0, 256, 48).astype(
                                    np.uint8)))
            same_as_imageio(pcx.decode_pcx, data)


@pytest.mark.parametrize("seed", range(4))
def test_random_qoi_op_streams_decode_as_pillow(seed):
    """Random op bytes after a header: Pillow's decoder, index and run
    quirks included, or the error it raises where the stream runs out."""
    rnd = np.random.RandomState(seed)
    w, h = int(rnd.randint(3, 20)), int(rnd.randint(1, 8))
    ops = rnd.randint(0, 256, int(rnd.randint(1, 4 * w * h))).astype(
        np.uint8).tobytes()
    data = mk.qoi_bytes(np.zeros((h, w, 4), np.uint8), int(rnd.choice(
        [3, 4])), ops=ops)
    same_as_imageio(qoi.decode_qoi, data)


@pytest.mark.parametrize("name", ["sgi/rle_rgba16.sgi", "sgi/pillow_rgb.rgb",
                                  "sgi/pillow_gray16.bw", "pcx/pillow_rgb.pcx",
                                  "pcx/pillow_palette.pcx",
                                  "pcx/planes4_w17.pcx", "qoi/ops_rgba.qoi",
                                  "qoi/pillow_rgb.qoi"])
def test_files_cut_anywhere_decode_or_raise_as_imageio(name):
    kind = name.split("/")[0]
    with open(f"{mk.DEFAULT_DIR}/{name}", "rb") as f:
        data = f.read()
    decoded = 0
    for k in sorted(set(np.linspace(0, len(data), 40).astype(int))):
        decoded += same_as_imageio(DECODERS[kind], data[:k])
    assert decoded >= 1


def test_sgi_rows_on_threads_give_the_same_bytes(monkeypatch):
    rnd = np.random.RandomState(4)
    planes = rnd.randint(0, 3, (3, 97, 41)).astype(np.uint8) * 70
    rows = [mk._sgi_rle_row(planes[c, 96 - r].tolist(), 1)
            for c in range(3) for r in range(97)]
    rows[50] = bytes([2, 9, 0])  # a short row across a band's edge
    data = mk.sgi_bytes(planes, 1, 1, rows=rows)
    many = sgi.decode_sgi(data)
    for threads in (1, 2, 3):
        monkeypatch.setattr(sgi, "_THREADS", threads)
        assert np.array_equal(sgi.decode_sgi(data), many)
    assert summary(many) == summary(iio.imread(data))


def _imopen_reader(src):
    """The library of the plugin imageio opens src with (its legacy
    wrappers of Pillow's readers are Pillow too), or None."""
    names = {"PillowPlugin": "pillow", "OpenCVPlugin": "opencv"}
    try:
        with iio.imopen(src, "r") as f:
            fmt = getattr(getattr(f, "_format", None), "name", "")
            return "pillow" if fmt.endswith("-PIL") else names.get(
                type(f).__name__, type(f).__name__)
    except Exception:  # noqa: BLE001 -- no plugin opens it
        return None


@pytest.mark.parametrize("ext", [".sgi", ".rgb", ".rgba", ".bw", ".pcx",
                                 ".qoi", ".im", ".ico", ".icns", ".mpo",
                                 None])
def test_the_reader_table_is_imageios_choice(ext, tmp_path):
    """cvread.reader names the plugin imageio opens these files with, at
    each name and as bytes (imageio lists only pyav for *.pcx, and knows
    no *.qoi: both reach Pillow by trying every plugin)."""
    files = {"sgi": ("SGI", {}), "pcx": ("PCX", {}), "qoi": ("QOI", {}),
             "im": ("IM", {}), "ico": ("ICO", {}), "icns": ("ICNS", {}),
             "mpo": ("MPO", {"save_all": True})}
    img = Image.fromarray(mk.terrain(16, 16, 3, 3))
    for kind, (fmt, kw) in files.items():
        data = _pillow(img, fmt, **kw)
        src = data
        if ext is not None:
            src = tmp_path / f"{kind}{ext}"
            src.write_bytes(data)
        want = _imopen_reader(src)
        assert want in ("pillow", None)
        got = cvread.reader(None if ext is None else str(src), True)
        if want is not None:
            assert got == want, (kind, ext)


def test_an_sgi_and_qoi_pair_gives_terrain_tpus_crops(tmp_path,
                                                      monkeypatch):
    """The slice's path on the CPU: run-length SGI heights and a QOI
    texture through both packages' `_get_data`."""
    h, w = 132, 148
    tex = mk.terrain(h, w, 21, 4)
    heights = tex[..., 0][None]
    hp, tp = tmp_path / "hm.sgi", tmp_path / "tex.qoi"
    hp.write_bytes(mk.sgi_bytes(heights, 1, 1))
    tp.write_bytes(mk.qoi_bytes(tex, 3))
    same_first_batches(f"{hp},{tp}", monkeypatch)


@pytest.mark.parametrize("h,w", [(64, 96), (24, 416)])
def test_chip_smokes_sgi_and_qoi_writers_give_what_imageio_reads(h, w):
    """chip_smoke.py's `_sgi_heights` and `_qoi_texture`, which write the
    card's 21600 x 10800 files, here small (416 columns give ocean runs and
    land copies of more than one 127-byte packet): imageio reads the seeded
    arrays from their bytes, and the port's decoders read the same."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(mk.DEFAULT_DIR, "..", "..",
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    data, heights = cs._sgi_heights(np, h, w, 3)
    assert summary(iio.imread(data)) == summary(heights)
    assert summary(sgi.decode_sgi(data)) == summary(heights)
    data, colours = cs._qoi_texture(np, h, w, 4)
    texture = np.repeat(colours, 8, axis=1)
    assert summary(iio.imread(data)) == summary(texture)
    assert summary(qoi.decode_qoi(data)) == summary(texture)
