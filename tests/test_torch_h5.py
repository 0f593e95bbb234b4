"""The port's HDF5 reader and writer (terrain_tpu_torch/data/h5.py) against
h5py, the reference's HDF5 package, and the JAX package's loaders.

h5py writes files in tmp_path with its default libver (superblock 0,
version-1 object headers, symbol-table groups) and with libver="latest"
(superblock 3, OHDR headers, compact links): contiguous, compact and
chunked datasets (gzip, shuffle, fletcher32), unallocated ones (the fill
value), integer and float types of either byte order, nested groups,
headers long enough to need continuation blocks, and the reference
layout; under libver="latest" each of layout version 4's five chunk
indices (a paged fixed array, an extensible array's super blocks and
paged data blocks, a version 2 B-tree of depth 1 and more, single chunk,
implicit), whose lookup3 checksums are checked, and, written through the
bundled HDF5 library's H5Pset_chunk_opts, partial edge chunks stored
unfiltered under the fixed-array, extensible-array and v2 B-tree indices.
The reader gives h5py's arrays bit for bit and refuses every other kind by
name.  The writer's files are read by h5py and by
terrain_tpu's get_iterators with the port's batches.  The committed
fixtures of tests/data/h5 (tests/make_h5_fixtures.py, read by
chip_smoke.py on the card) still match h5py and the reader.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from terrain_tpu_torch import experiments
from terrain_tpu_torch.data import h5, hdf5, synthetic
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

h5py = pytest.importorskip("h5py")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "h5")
LIBVERS = {"earliest": {}, "latest": {"libver": "latest"}}


def _arrays(seed=0):
    rnd = np.random.RandomState(seed)
    return {
        "u1": rnd.randint(0, 256, (7, 5, 3)).astype("u1"),
        "i2_be": rnd.randint(-3000, 3000, (9, 4)).astype(">i2"),
        "u4": rnd.randint(0, 2**31, (13,)).astype("<u4"),
        "i8_be": rnd.randint(-2**40, 2**40, (3, 3)).astype(">i8"),
        "f2": rnd.randn(5, 6).astype("<f2"),
        "f4": rnd.randn(11, 6).astype("<f4"),
        "f8_be": rnd.randn(4, 7).astype(">f8"),
        "scalar": np.array(3.5, "<f8"),
    }


def _compact():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def _write(path, libver, layout):
    """h5py's file of every array in `layout` (contiguous, compact or
    chunked), with a nested group and an unallocated dataset."""
    arrays = _arrays()
    with h5py.File(path, "w", **LIBVERS[libver]) as f:
        g = f.create_group("a")  # eight links: version 2 keeps them compact
        for name, a in arrays.items():
            if layout == "compact":
                g.create_dataset(name, data=a, dcpl=_compact())
            elif layout == "chunked" and a.ndim:
                chunks = tuple(max(1, s // 2) for s in a.shape)
                g.create_dataset(name, data=a, chunks=chunks,
                                 compression="gzip", shuffle=True,
                                 fletcher32=name.startswith("f"))
            else:
                g.create_dataset(name, data=a)
        f.create_group("grp").create_group("sub").create_dataset(
            "x", data=np.arange(10, dtype="<i4"))
        f.create_dataset("unallocated", (4, 5), dtype="<f4", fillvalue=2.5)
        f.create_dataset("unallocated_zero", (3,), dtype="u1")
    return arrays


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("libver", list(LIBVERS))
@pytest.mark.parametrize("layout", ["contiguous", "compact", "chunked"])
def test_the_reader_gives_h5pys_arrays(libver, layout, tmp_path):
    path = tmp_path / "a.h5"
    arrays = _write(path, libver, layout)
    names = [f"a/{k}" for k in arrays] + [
        "grp/sub/x", "unallocated", "unallocated_zero"]
    with h5.File(path) as f, h5py.File(path, "r") as g:
        assert f.keys() == sorted(g.keys())
        for name in names:
            got = f[name]
            _same(np.asarray(got), g[name][()])
            if layout == "contiguous" and name[2:] in arrays and \
                    arrays[name[2:]].ndim:
                assert isinstance(got, np.memmap) and not got.flags.writeable
        assert "grp/sub/x" in f and "nope" not in f


@pytest.mark.parametrize("libver", list(LIBVERS))
def test_headers_with_continuation_blocks(libver, tmp_path):
    """Attributes and links added after creation push an object's messages
    into continuation blocks (OCHK ones in version 2)."""
    path = tmp_path / "c.h5"
    seen = []
    with h5py.File(path, "w", **LIBVERS[libver]) as f:
        for i in range(3):
            d = f.create_dataset(f"d{i}", data=np.arange(5 + i) * 1.5)
            for j in range(30):
                d.attrs[f"a{j}"] = np.arange(25)
        for i in range(5):  # eight links in all: still compact
            f.create_dataset(f"late_{i}_{'x' * 40}", data=[i])
    orig = h5.File._message

    def spy(self, mtype, *args, **kw):
        seen.append(mtype)
        return orig(self, mtype, *args, **kw)

    with h5.File(path) as f, h5py.File(path, "r") as g:
        f._message = spy.__get__(f)
        for i in range(3):
            _same(f[f"d{i}"], g[f"d{i}"][()])
    assert 0x10 in seen


def test_the_reference_layout(tmp_path):
    """tools/build_dataset.py's way: datasets created by shape, filled row
    by row; the port's loaders give terrain_tpu's batches from it."""
    from terrain_tpu import experiments as jexp

    path = str(tmp_path / "ref.h5")
    xt, yt = synthetic.make_pairs(10, 32, seed=4)
    xv, yv = synthetic.make_pairs(4, 32, seed=5)
    with h5py.File(path, "w") as f:
        for name, a in (("xt", xt), ("yt", yt), ("xv", xv), ("yv", yv)):
            d = f.create_dataset(name, a.shape, dtype="uint8")
            for i in range(len(a)):
                d[i] = a[i]
    _loaders_agree(jexp, path, xt, yt)


def _loaders_agree(jexp, path, xt, yt):
    mine = experiments.get_iterators(path, 4, True, False)
    ref = jexp.get_iterators(path, 4, True, False)
    for it, jit in zip(mine, ref):
        assert it.N == jit.N
        for _ in range(5):
            for a, b in zip(next(it), next(jit)):
                np.testing.assert_array_equal(a, b)
    tr, va = experiments.get_device_datasets(path, True, False, device="cpu")
    np.testing.assert_array_equal(tr.x.numpy(), xt)
    np.testing.assert_array_equal(tr.y.numpy(), yt)
    assert va.N == 4


def _refusal_files(tmp_path):
    """{kind: (path, dataset, the error's text)}, each file h5py's."""
    out = {}

    def make(kind, fill, name, match, **kw):
        path = tmp_path / f"{kind}.h5"
        with h5py.File(path, "w", **kw) as f:
            fill(f)
        out[kind] = (path, name, match)

    make("lzf", lambda f: f.create_dataset(
        "d", data=np.arange(100), chunks=(10,), compression="lzf"),
        "d", r"the lzf filter \(id 32000\)")
    make("scaleoffset", lambda f: f.create_dataset(
        "d", data=np.arange(100), chunks=(10,), scaleoffset=0),
        "d", r"the scaleoffset filter \(id 6\)")
    make("string", lambda f: f.create_dataset(
        "d", data=np.array([b"ab", b"cd"])), "d", "the string datatype")
    make("compound", lambda f: f.create_dataset(
        "d", data=np.zeros(3, [("a", "<i4"), ("b", "<f4")])),
        "d", "the compound datatype")
    make("enum", lambda f: f.create_dataset(
        "d", data=np.array([True, False])), "d", "the enumerated datatype")
    make("soft link", lambda f: (f.create_dataset("a", data=[1]),
                                 f.__setitem__("s", h5py.SoftLink("/a"))),
         "s", "'s' is a soft link")
    make("external", lambda f: f.create_dataset(
        "d", (4,), dtype="u1", external=[("ext.bin", 0, 4)]),
        "d", "external data files")
    make("lzf on layout 4", lambda f: f.create_dataset(
        "d", data=np.arange(20), chunks=(5,), maxshape=(None,),
        compression="lzf"), "d", r"the lzf filter \(id 32000\)",
        libver="latest")
    make("scaleoffset on layout 4", lambda f: f.create_dataset(
        "d", data=np.arange(16).reshape(4, 4), chunks=(2, 2),
        maxshape=(None, None), scaleoffset=0), "d",
        r"the scaleoffset filter \(id 6\)", libver="latest")

    def virtual(f):
        layout = h5py.VirtualLayout(shape=(4,), dtype="i8")
        f.create_dataset("src", data=np.arange(4))
        layout[:] = h5py.VirtualSource(f["src"])
        f.create_virtual_dataset("v", layout)

    make("virtual", virtual, "v", "virtual dataset storage", libver="latest")
    make("dense links", lambda f: [f.create_dataset(f"n{i:02d}", data=[i])
                                   for i in range(12)],
         "n03", r"dense link storage", libver="latest")
    return out


@pytest.mark.parametrize("kind", [
    "lzf", "scaleoffset", "string", "compound", "enum", "soft link",
    "external", "lzf on layout 4", "scaleoffset on layout 4", "virtual",
    "dense links"])
def test_other_kinds_are_refused_by_name(kind, tmp_path):
    path, name, match = _refusal_files(tmp_path)[kind]
    with pytest.raises(NotImplementedError, match=match):
        with h5.File(path) as f:
            f[name]


def test_damaged_files_raise(tmp_path):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=np.arange(1000, dtype="<i4"),
                         chunks=(100,), fletcher32=True)
    data = bytearray(path.read_bytes())
    # flip a byte of the first chunk's data (0..99 as int32: byte 40 is 10)
    i = data.index(np.arange(100, dtype="<i4").tobytes())
    data[i + 40] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="fletcher32"):
        h5.File(path)["d"]
    (tmp_path / "junk.h5").write_bytes(b"not an HDF5 file at all" * 40)
    with pytest.raises(ValueError, match="no HDF5 superblock"):
        h5.File(tmp_path / "junk.h5")
    with h5.File(path) as f, pytest.raises(KeyError):
        f["missing"]


def test_fletcher32_is_hdf5s():
    """Against h5py's own checksums: files whose stored sums the reader
    checks, of odd and even lengths across the 360-word folds."""
    for n in (1, 7, 719, 721, 5000):
        data = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8)
        # the reference algorithm, one word at a time
        s1 = s2 = 0
        words = [int(data[i]) << 8 | int(data[i + 1])
                 for i in range(0, n - n % 2, 2)]
        for k in range(0, len(words), 360):
            for w in words[k:k + 360]:
                s1 += int(w)
                s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        if n % 2:
            s1 += int(data[-1]) << 8
            s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        assert h5.fletcher32(data.tobytes()) == (s2 << 16) | s1


# -------------------------------------------------- layout version 4
def _implicit(f, name, data):
    """An implicit chunk index: early allocation and no filter, through
    h5py's low-level dataset creation property list."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((4, 3))
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    h5py.h5d.create(f.id, name.encode(), h5py.h5t.STD_I16BE,
                    h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    f[name][...] = data


def _sparse(f, name, data):
    d = f.create_dataset(name, (1000, 3), dtype="<u2", chunks=(1, 3),
                         maxshape=(None, 3), fillvalue=7)
    d[500:510] = data[:10, :3]


_L4 = {  # kind -> (index type, create(f, name, data), data's shape)
    "single chunk": (1, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=a.shape), (5, 6)),
    "single chunk, filtered": (1, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=a.shape, compression="gzip", shuffle=True,
        fletcher32=True), (5, 6)),
    "implicit": (2, _implicit, (10, 7)),
    "fixed array": (3, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=(3, 2)), (10, 7)),
    "fixed array, paged": (3, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=(1, 1), compression="gzip"), (40, 30)),
    "extensible array": (4, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=(2, 3), maxshape=(None, 7)), (31, 7)),
    "extensible array, super blocks": (4, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=(1, 2), maxshape=(None, 4), compression="gzip",
        fletcher32=True), (400, 4)),
    "extensible array, second dimension": (4, lambda f, n, a:
                                           f.create_dataset(
        n, data=a, chunks=(2, 1), maxshape=(4, None)), (4, 300)),
    "extensible array, sparse": (4, _sparse, (10, 3)),
    "version 2 B-tree": (5, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=(2, 2), maxshape=(None, None)), (40, 40)),
    "version 2 B-tree, filtered": (5, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=(2, 2), maxshape=(None, None),
        compression="gzip"), (40, 40)),
    "version 2 B-tree, depth 2": (5, lambda f, n, a: f.create_dataset(
        n, data=a, chunks=(1, 1), maxshape=(None, None)), (90, 90)),
}


def _index_of(f, name):
    ds = f._dataset(f._messages(f._find(name)), name)
    return ds.layout[1] if ds.layout[0] == "chunked4" else None


def _btree2_depth(path):
    data = open(path, "rb").read()
    i = data.index(b"BTHD")
    return int.from_bytes(data[i + 12:i + 14], "little")


@pytest.mark.parametrize("kind", list(_L4))
def test_layout4_chunk_indices_read_as_h5py(kind, tmp_path):
    index, create, shape = _L4[kind]
    rnd = np.random.RandomState(len(kind))
    data = rnd.randint(-30000, 30000, shape).astype(">i2")
    path = tmp_path / "l4.h5"
    with h5py.File(path, "w", libver="latest") as f:
        create(f, "d", data)
    with h5.File(path) as f, h5py.File(path, "r") as g:
        assert _index_of(f, "d") == index
        _same(np.asarray(f["d"]), g["d"][()])
    if kind == "version 2 B-tree, depth 2":
        assert _btree2_depth(path) == 2
    elif index == 5:
        assert _btree2_depth(path) >= 1


def test_an_extensible_arrays_paged_data_blocks(tmp_path):
    """140,000 one-byte chunks: data blocks of more than 2^10 elements in a
    super block are paged, each page with its checksum and its bit in the
    super block's page bitmap (a byte or more a data block)."""
    path = tmp_path / "ea.h5"
    a = (np.arange(140000) % 251).astype("u1")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("d", data=a, chunks=(1,), maxshape=(None,))
    with h5.File(path) as f:
        _same(np.asarray(f["d"]), a)


@pytest.mark.parametrize("sig,fixture", [
    (b"FAHD", "layout4_fixed_array.h5"), (b"FADB", "layout4_fixed_array.h5"),
    (b"EAHD", "layout4_extensible_array.h5"),
    (b"EAIB", "layout4_extensible_array.h5"),
    (b"EASB", "layout4_extensible_array.h5"),
    (b"EADB", "layout4_extensible_array.h5"),
    (b"BTHD", "layout4_btree2.h5"), (b"BTIN", "layout4_btree2.h5"),
    (b"BTLF", "layout4_btree2.h5")])
def test_a_flipped_byte_fails_the_lookup3_checksum(sig, fixture, tmp_path):
    data = bytearray(open(os.path.join(FIXTURES, fixture), "rb").read())
    i = data.index(sig)
    data[i + 5] ^= 0x10  # its client id or record type: checksummed
    path = tmp_path / fixture
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="lookup3 checksum"):
        with h5.File(path) as f:
            for k in f.keys():
                np.asarray(f[k])


def test_lookup3_is_bob_jenkins_hashlittle():
    """lookup3.c's own self-test values, and lengths of every remainder."""
    assert h5.lookup3(b"") == 0xDEADBEEF
    assert h5.lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    assert h5.lookup3(b"Four score and seven years ago") == 0x17770551
    assert h5.lookup3(b"Four score and seven years ago", 1) == 0xCD628161
    seen = {h5.lookup3(bytes(range(n))) for n in range(40)}
    assert len(seen) == 40


# ------------------------------------------------------------------ writer
def test_written_files_are_h5pys_and_terrain_tpus(tmp_path):
    from terrain_tpu import experiments as jexp

    arrays = {k: v for k, v in _arrays(1).items()}
    path = str(tmp_path / "w.h5")
    h5.write(path, {**arrays, "empty": np.zeros((0, 3), "u1")})
    with h5py.File(path, "r") as g, h5.File(path) as f:
        assert sorted(g) == sorted([*arrays, "empty"]) == f.keys()
        for name, a in arrays.items():
            _same(g[name][()], a)
            _same(np.asarray(f[name]), a)
        assert g["empty"].shape == (0, 3)
    xt, yt = synthetic.make_pairs(12, 16, seed=2)
    xv, yv = synthetic.make_pairs(4, 16, seed=3)
    pairs = str(tmp_path / "pairs.h5")
    h5.write(pairs, {"xt": xt, "yt": yt, "xv": xv, "yv": yv})
    _loaders_agree(jexp, pairs, xt, yt)


def test_streaming_create_and_many_datasets(tmp_path):
    """`create` returns writable memmaps filled row by row; more datasets
    than one symbol node holds (8) spread over several."""
    path = str(tmp_path / "s.h5")
    specs = {f"d{i:02d}": ((i + 1, 6, 2), "<f4" if i % 2 else "u1")
             for i in range(20)}
    maps = h5.create(path, specs)
    want = {}
    for name, (shape, dtype) in specs.items():
        a = (np.arange(np.prod(shape)) % 251).reshape(shape).astype(dtype)
        for r in range(shape[0]):
            maps[name][r] = a[r]
        maps[name].flush()
        want[name] = a
    del maps
    with h5py.File(path, "r") as g:
        assert sorted(g) == sorted(specs)
        for name, a in want.items():
            _same(g[name][()], a)
    with h5.File(path) as f:
        for name, a in want.items():
            _same(np.asarray(f[name]), a)


def test_write_h5_is_terrain_tpus(tmp_path):
    from terrain_tpu.data import synthetic as jsyn

    a = synthetic.write_h5(str(tmp_path / "a.h5"), 5, 2, 24, seed=7)
    b = jsyn.write_h5(str(tmp_path / "b.h5"), 5, 2, 24, seed=7)
    with h5py.File(a, "r") as f, h5py.File(b, "r") as g:
        assert sorted(f) == sorted(g)
        for k in g:
            _same(f[k][()], g[k][()])


# ------------------------------------------------ unfiltered edge chunks
def _h5_fixture_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_h5_fixtures", os.path.join(HERE, "make_h5_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("index", ["fixed_array", "extensible_array",
                                   "btree2"])
@pytest.mark.parametrize("name", ["gzip_2d", "gzip_4d",
                                  "shuffle_gzip_fletcher32_2d",
                                  "shuffle_gzip_fletcher32_4d"])
def test_partial_edge_chunks_stored_unfiltered_read_as_h5py(index, name):
    """H5Pset_chunk_opts' H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS (layout
    version 4's flag bit 0) under each chunk index that stores filter
    masks: a chunk crossing the dataset's edge is stored as it is, whole
    chunks through their filters (the committed fixtures)."""
    path = os.path.join(FIXTURES, f"edge_unfiltered_{index}.h5")
    with h5.File(path) as f, h5py.File(path, "r") as g:
        ds = f._dataset(f._messages(f._find(name)), name)
        assert ds.layout[0] == "chunked4" and ds.layout[-1] is True
        assert ds.layout[1] == {"fixed_array": 3, "extensible_array": 4,
                                "btree2": 5}[index]
        _same(np.asarray(f[name]), g[name][()])


@pytest.mark.parametrize("index", ["fixed_array", "extensible_array",
                                   "btree2"])
@pytest.mark.parametrize("shape,chunk", [((9, 7), (4, 4)),
                                         ((3, 10, 6, 2), (2, 4, 4, 2)),
                                         ((16, 5), (4, 5))])
def test_written_edge_chunk_files_read_as_h5py(index, shape, chunk,
                                               tmp_path):
    """Files the bundled HDF5 library writes here with the flag set: edges
    in one dimension, in several, or in none (every chunk whole)."""
    mod = _h5_fixture_script()
    lib = mod._libhdf5()
    rnd = np.random.RandomState(len(index) + len(shape))
    a = rnd.randint(0, 4, shape).astype("<i2") * 1000
    path = str(tmp_path / "edge.h5")
    unlimited = {"fixed_array": 0, "extensible_array": 1, "btree2": 2}[index]
    with h5py.File(path, "w", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk(chunk)
        dcpl.set_shuffle()
        dcpl.set_deflate(6)
        dcpl.set_fletcher32()
        assert lib.H5Pset_chunk_opts(dcpl.id,
                                     mod.DONT_FILTER_PARTIAL_CHUNKS) >= 0
        space = h5py.h5s.create_simple(shape, tuple(
            h5py.h5s.UNLIMITED if i < unlimited else s
            for i, s in enumerate(shape)))
        h5py.h5d.create(f.id, b"d", h5py.h5t.STD_I16LE, space, dcpl=dcpl)
        f["d"][...] = a
    with h5.File(path) as f, h5py.File(path, "r") as g:
        _same(np.asarray(f["d"]), g["d"][()])
        np.testing.assert_array_equal(np.asarray(f["d"]), a)


def test_an_edge_chunk_fixture_trains_the_reference_layout(monkeypatch):
    """TERRAIN_DATA on the 512px pairs whose last rows lie in unfiltered
    edge chunks: the host iterator's first batch is h5py's rows."""
    path = os.path.join(FIXTURES, "edge_unfiltered_pairs_512.h5")
    monkeypatch.setenv("TERRAIN_DATA", path)
    for k in ("TERRAIN_SYNTHETIC", "TERRAIN_RASTER"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TERRAIN_FAST", "0")
    with h5py.File(path, "r") as g:
        xt, yt = g["xt"][()], g["yt"][()]
    tr, va = experiments._get_data(512, device="cpu")
    want = hdf5.Hdf5Iterator(xt, yt, 4)
    for a, b in zip(next(tr), next(want)):
        np.testing.assert_array_equal(a, b)
    assert (tr.N, va.N) == (8, 4)


# ---------------------------------------------------------------- fixtures
def test_committed_fixtures_match_h5py_and_the_reader(tmp_path):
    """The script writes files whose h5py arrays have the committed digests
    (the latest-libver gzip file and the five layout-4 indices' files
    among them), and the reader gives those arrays from the committed
    files."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_h5_fixtures", os.path.join(HERE, "make_h5_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        committed = json.load(f)
    assert mod.main(str(tmp_path)) == committed
    assert {f"layout4_{k}.h5" for k in mod.LAYOUT4} <= set(committed)
    assert {f"edge_unfiltered_{k}.h5" for k in mod.EDGE} | {
        mod.EDGE_PAIRS} <= set(committed)
    for name, want in committed.items():
        if name == "reference":
            continue
        path = os.path.join(FIXTURES, name)
        with h5.File(path) as f:
            assert f.keys() == sorted(want)
            for k, w in want.items():
                a = np.ascontiguousarray(f[k])
                assert [list(a.shape), str(a.dtype)] == [w["shape"],
                                                         w["dtype"]]
                assert hashlib.sha256(a.tobytes()).hexdigest() == w["sha256"]


def test_terrain_data_from_a_committed_fixture(monkeypatch):
    """TERRAIN_DATA on a gzip-chunked h5py file: host iterators and the
    device dataset hold the file's pairs."""
    path = os.path.join(FIXTURES, "pairs_earliest_gzip.h5")
    monkeypatch.setenv("TERRAIN_DATA", path)
    for k in ("TERRAIN_SYNTHETIC", "TERRAIN_RASTER"):
        monkeypatch.delenv(k, raising=False)
    xt, yt = synthetic.make_pairs(6, 64, seed=0)
    monkeypatch.setenv("TERRAIN_FAST", "0")
    tr, va = experiments._get_data(64, device="cpu")
    want = hdf5.Hdf5Iterator(xt, yt, 4)
    for a, b in zip(next(tr), next(want)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("TERRAIN_FAST", "1")
    tr, va = experiments._get_data(64, device="cpu")
    np.testing.assert_array_equal(tr.y.numpy(), yt)
    assert (tr.N, va.N) == (6, 2)
