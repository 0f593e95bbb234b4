"""Shared by the port's raster tests (test_torch_png_formats.py,
test_torch_tiff.py, test_torch_bmp.py, test_torch_webp.py,
test_torch_pnm_tga.py, test_torch_jp2.py, test_torch_opencv_rasters.py,
test_torch_dds_sun.py, test_torch_sgi_pcx_qoi.py, test_torch_icons_im.py):
the committed fixtures of tests/data/{png,tiff,bmp,webp,pnm,tga,jp2,
pfm_pam,hdr,sun,dds,sgi,pcx,qoi,im,ico,icns,mpo}/
(tests/make_raster_fixtures.py) against their digests, the script re-run,
and a raster pair's first batches against terrain_tpu's `_get_data`."""

import hashlib
import importlib.util
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")


def digests(kind):
    with open(os.path.join(DATA, kind, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items() if k != "reference"}


def summary(a):
    a = np.asarray(a)
    return [list(a.shape), str(a.dtype),
            hashlib.sha256(a.tobytes()).hexdigest()]


def exception(name):
    """The exception class a digest names ("struct.error" or a built-in)."""
    import builtins
    import struct

    return struct.error if name == "struct.error" else getattr(builtins,
                                                               name)


def check_fixture(kind, name, decode):
    """decode(bytes) of a committed fixture gives imageio's decode of its
    bytes, and data/raster.read_raster(path) imageio's of its path (the
    same but for TIFFs and a *.pbm), as the digests hold them; where
    imageio raises on the bytes ("error"), decode raises the exception
    named there, and where it raises on the path (an "error" under
    "path"), read_raster does; a fixture the port refuses ("refused") is refused by name
    both ways, one it refuses at its path ("path_refused") by path."""
    import re

    import pytest

    from terrain_tpu_torch.data.raster import read_raster

    want = digests(kind)[name]
    path = os.path.join(DATA, kind, name)
    with open(path, "rb") as f:
        data = f.read()
    if "refused" in want:
        for read in (lambda: decode(data), lambda: read_raster(path)):
            with pytest.raises(NotImplementedError,
                               match=re.escape(want["refused"])):
                read()
        return
    if "error" in want:
        with pytest.raises(exception(want["error"])):
            decode(data)
    else:
        assert summary(decode(data)) == [
            want["shape"], want["dtype"], want["sha256"]]
    if "path_refused" in want:
        with pytest.raises(NotImplementedError,
                           match=re.escape(want["path_refused"])):
            read_raster(path)
        return
    by_path = want.get("path", want)
    if by_path is not None and "error" in by_path:
        with pytest.raises(exception(by_path["error"])):
            read_raster(path)
    elif by_path is not None:
        assert summary(read_raster(path)) == [
            by_path["shape"], by_path["dtype"], by_path["sha256"]]


def script():
    spec = importlib.util.spec_from_file_location(
        "make_raster_fixtures", os.path.join(HERE, "make_raster_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rerun(kind, tmp_path):
    """The script writes the committed digests again (imageio's decodes
    under the installed Pillow), and the committed bytes of every file its own
    encoders write.  Pillow's TIFF writer leaves a byte of its IFD
    unset (it differed between two runs of one build), so the files
    Pillow writes ("pillow_*", the "strip_*" pair) are held by digest."""
    got = script().main(str(tmp_path), (kind,))[kind]
    with open(os.path.join(DATA, kind, "digests.json")) as f:
        assert got == json.load(f)
    for name in got:
        if name != "reference" and not name.startswith(("pillow_",
                                                          "strip_")):
            with open(os.path.join(DATA, kind, name), "rb") as f:
                assert f.read() == (tmp_path / kind / name).read_bytes(), name


def same_first_batches(value, monkeypatch, epoch_crops=20, crop=64):
    """TERRAIN_RASTER=value: the port's `_get_data` and terrain_tpu's give
    the same first batches (both cast the pair to uint8 the same way)."""
    from terrain_tpu import experiments as jexp
    from terrain_tpu_torch import experiments

    for k, v in {"TERRAIN_RASTER": value, "TERRAIN_BS": "2",
                 "TERRAIN_EPOCH_CROPS": str(epoch_crops)}.items():
        monkeypatch.setenv(k, v)
    mine = experiments._get_data(crop, device="cpu")
    ref = jexp._get_data(crop)
    for it, jit in zip(mine, ref):
        assert it.N == jit.N
        for _ in range(2):
            for a, b in zip(next(it), next(jit)):
                np.testing.assert_array_equal(a, b)
