"""Write the HDF5 fixtures of tests/data/h5/ (h5py) and their digests.

    python tests/make_h5_fixtures.py [directory]   # default tests/data/h5

Each file holds the reference layout, xt/yt/xv/yv as uint8 NHWC: 6 train
and 2 valid synthetic pairs at 64px (data/synthetic.make_pairs, seeds 0
and 1), written by h5py as the reference's tools write them:
  pairs_earliest_contiguous.h5  h5py's default libver (superblock 0), the
                                datasets created by shape and filled row by
                                row (tools/build_dataset.py's way)
  pairs_earliest_gzip.h5        the same, chunked a pair a chunk through
                                shuffle and gzip, yt with fletcher32
  pairs_latest_contiguous.h5    libver="latest" (superblock 3, OHDR
                                headers, compact links), contiguous
  pairs_latest_gzip.h5          libver="latest", gzip-chunked: layout
                                version 4's fixed-array chunk index
and, with libver="latest", one file for each of layout version 4's chunk
indices (seeded random data, a few datasets each):
  layout4_fixed_array.h5        1056 chunks, so the data block is paged
                                (2^10 entries a page), gzip + shuffle; and
                                an unpaged, unfiltered one
  layout4_extensible_array.h5   one unlimited dimension: 300 chunks reach
                                the first super block; gzip + fletcher32;
                                the unlimited dimension second; a sparse
                                one (most chunks never written)
  layout4_btree2.h5             two unlimited dimensions: a version 2
                                B-tree of depth 1 (900 records), unfiltered
                                and gzip'd float32
  layout4_single_chunk.h5       one chunk, unfiltered and gzip'd
  layout4_implicit.h5           early allocation, no filter: the implicit
                                index (h5py's low-level creation list)
and, through the bundled HDF5 library's H5Pset_chunk_opts (ctypes: h5py
does not expose it), files whose partial edge chunks are stored
unfiltered (H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS):
  edge_unfiltered_{fixed_array,extensible_array,btree2}.h5
                                each index, 2-D (37, 41) and 4-D
                                (5, 37, 41, 3) uint8 in 16x16 chunks,
                                through gzip and shuffle + gzip + fletcher32
  edge_unfiltered_pairs_512.h5  the reference layout at 512px (8 + 4
                                pairs) in 20-row chunks: what chip_smoke.py
                                trains an epoch from
digests.json holds, for each file, each dataset's shape, dtype and the
SHA-256 of h5py's array, and under "reference" the h5py and HDF5 versions
that wrote them.  h5py is needed here, not on the card: chip_smoke.py reads the
committed files with the port's reader to these digests, and
tests/test_torch_h5.py re-runs this script and checks them.
"""

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
DEFAULT_DIR = os.path.join(HERE, "data", "h5")

N_TRAIN, N_VALID, SIZE = 6, 2, 64


def pairs():
    from terrain_tpu_torch.data.synthetic import make_pairs

    xt, yt = make_pairs(N_TRAIN, SIZE, seed=0)
    xv, yv = make_pairs(N_VALID, SIZE, seed=1)
    return {"xt": xt, "yt": yt, "xv": xv, "yv": yv}


def write(path, libver, chunked):
    import h5py

    arrays = pairs()
    kw = {"libver": libver} if libver else {}
    with h5py.File(path, "w", **kw) as f:
        for name, a in arrays.items():
            opts = {}
            if chunked:
                opts = dict(chunks=(1,) + a.shape[1:], compression="gzip",
                            compression_opts=4, shuffle=True,
                            fletcher32=name == "yt")
            d = f.create_dataset(name, a.shape, dtype="uint8", **opts)
            for i in range(len(a)):
                d[i] = a[i]


FILES = {"pairs_earliest_contiguous.h5": (None, False),
         "pairs_earliest_gzip.h5": (None, True),
         "pairs_latest_contiguous.h5": ("latest", False),
         "pairs_latest_gzip.h5": ("latest", True)}


def _layout4(path, kind):
    import h5py

    rnd = np.random.RandomState(len(kind))

    def u1(*shape):
        return rnd.randint(0, 256, shape).astype("u1")

    with h5py.File(path, "w", libver="latest") as f:
        if kind == "fixed_array":
            f.create_dataset("paged", data=u1(66, 64), chunks=(2, 2),
                             compression="gzip", shuffle=True)
            f.create_dataset("small", data=rnd.randint(
                -2**31, 2**31, (10, 12)).astype("<i4"), chunks=(3, 5))
        elif kind == "extensible_array":
            f.create_dataset("rows", data=u1(300, 5), chunks=(1, 5),
                             maxshape=(None, 5))
            f.create_dataset("rows_gzip", data=u1(300, 5), chunks=(1, 5),
                             maxshape=(None, 5), compression="gzip",
                             fletcher32=True)
            f.create_dataset("cols", data=u1(6, 300), chunks=(3, 1),
                             maxshape=(6, None))
            d = f.create_dataset("sparse", (1000, 3), dtype="u1",
                                 chunks=(1, 3), maxshape=(None, 3),
                                 fillvalue=9)
            d[500:510] = u1(10, 3)
        elif kind == "btree2":
            f.create_dataset("plain", data=u1(60, 60), chunks=(2, 2),
                             maxshape=(None, None))
            f.create_dataset("gzip", data=rnd.randn(60, 60).astype("<f4"),
                             chunks=(2, 2), maxshape=(None, None),
                             compression="gzip")
        elif kind == "single_chunk":
            f.create_dataset("plain", data=u1(7, 9), chunks=(7, 9))
            f.create_dataset("gzip", data=u1(7, 9), chunks=(7, 9),
                             compression="gzip")
        else:
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((4, 4))
            dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
            h5py.h5d.create(f.id, b"d", h5py.h5t.STD_U8LE,
                            h5py.h5s.create_simple((10, 10)), dcpl=dcpl)
            f["d"][...] = u1(10, 10)


LAYOUT4 = ("fixed_array", "extensible_array", "btree2", "single_chunk",
           "implicit")
# H5Pset_chunk_opts' flag: partial edge chunks stored unfiltered
DONT_FILTER_PARTIAL_CHUNKS = 0x0002
EDGE = ("fixed_array", "extensible_array", "btree2")


def _libhdf5():
    """The HDF5 library h5py runs on (the one it bundles), through ctypes:
    h5py exposes no H5Pset_chunk_opts, the library does."""
    import ctypes

    import h5py  # noqa: F401 -- loads the library into the process

    with open("/proc/self/maps") as f:  # the libraries this process maps
        paths = sorted({ln.split()[-1] for ln in f if "libhdf5" in ln
                        and "libhdf5_hl" not in ln})
    for path in paths:
        lib = ctypes.CDLL(path)
        if hasattr(lib, "H5Pset_chunk_opts"):
            lib.H5Pset_chunk_opts.argtypes = [ctypes.c_int64, ctypes.c_uint]
            lib.H5Pset_chunk_opts.restype = ctypes.c_int
            return lib
    raise RuntimeError(f"no libhdf5 with H5Pset_chunk_opts among {paths}")


EDGE_PAIRS = "edge_unfiltered_pairs_512.h5"
EDGE_TRAIN, EDGE_VALID = 8, 4


def edge_pairs():
    """The reference layout at the flagship's 512px, seeded waves in 15
    levels (which gzip to little): xt (8, 512, 512, 1), yt (8, 512, 512, 3), xv
    and yv with 4 pairs."""
    out = {}
    y = np.arange(512, dtype=np.float32)[:, None]
    x = np.arange(512, dtype=np.float32)[None, :]
    for split, n, seed in (("t", EDGE_TRAIN, 0), ("v", EDGE_VALID, 1)):
        rnd = np.random.RandomState(seed)
        hm, tex = [], []
        for _ in range(n):
            fy, fx, py, px = rnd.uniform(0.005, 0.03, 4) * [1, 1, 600, 600]
            f = np.sin(fy * y + py) * np.cos(fx * x + px)
            h = (np.round(f * 7) * 17 + 128).astype(np.uint8)  # 15 levels
            hm.append(h[..., None])
            tex.append(np.stack([h, 255 - h, h // 2], -1))
        out["x" + split], out["y" + split] = np.stack(hm), np.stack(tex)
    return out


def _edge_pairs(path):
    """edge_pairs() in 20-row chunks, so each image's last 12 rows lie in a
    partial edge chunk, stored unfiltered (all 20 rows of it); gzip,
    shuffle and (yt) fletcher32 on the whole chunks; libver="latest", the
    fixed array index."""
    import h5py

    lib = _libhdf5()
    with h5py.File(path, "w", libver="latest") as f:
        for name, a in edge_pairs().items():
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((1, 20, 512, a.shape[-1]))
            dcpl.set_shuffle()
            dcpl.set_deflate(4)
            if name == "yt":
                dcpl.set_fletcher32()
            if lib.H5Pset_chunk_opts(dcpl.id, DONT_FILTER_PARTIAL_CHUNKS) < 0:
                raise RuntimeError("H5Pset_chunk_opts failed")
            h5py.h5d.create(f.id, name.encode(), h5py.h5t.STD_U8LE,
                            h5py.h5s.create_simple(a.shape), dcpl=dcpl)
            f[name][...] = a


def _edge(path, kind):
    """Datasets whose partial edge chunks HDF5 stores unfiltered, under the
    chunk index `kind` (fixed array: fixed dims; extensible array: one
    unlimited; version 2 B-tree: two), each 2-D and 4-D (the reference's
    (N, H, W, C) at a tiny size), through gzip and through shuffle + gzip +
    fletcher32."""
    import h5py

    lib = _libhdf5()
    rnd = np.random.RandomState(7 + len(kind))
    shapes = {"2d": ((37, 41), (16, 16)), "4d": ((5, 37, 41, 3),
                                                  (2, 16, 16, 3))}
    with h5py.File(path, "w", libver="latest") as f:
        for dims, (shape, chunk) in shapes.items():
            unlimited = {"fixed_array": 0, "extensible_array": 1,
                         "btree2": 2}[kind]
            maxshape = tuple(h5py.h5s.UNLIMITED if i < unlimited else s
                             for i, s in enumerate(shape))
            for filters in ("gzip", "shuffle_gzip_fletcher32"):
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_chunk(chunk)
                if filters != "gzip":
                    dcpl.set_shuffle()
                dcpl.set_deflate(4)
                if filters != "gzip":
                    dcpl.set_fletcher32()
                if lib.H5Pset_chunk_opts(dcpl.id,
                                         DONT_FILTER_PARTIAL_CHUNKS) < 0:
                    raise RuntimeError("H5Pset_chunk_opts failed")
                name = f"{filters}_{dims}".encode()
                space = h5py.h5s.create_simple(shape, maxshape)
                h5py.h5d.create(f.id, name, h5py.h5t.STD_U8LE, space,
                                dcpl=dcpl)
                # smooth rows compress, so a whole chunk's stored size
                # differs from its unfiltered size
                a = (np.arange(int(np.prod(shape))).reshape(shape) // 7
                     + rnd.randint(0, 3, shape)).astype("u1")
                f[name][...] = a


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main(out_dir=DEFAULT_DIR):
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    digests = {"reference": {"h5py": h5py.__version__,
                             "hdf5": h5py.version.hdf5_version}}
    for name, (libver, chunked) in FILES.items():
        write(os.path.join(out_dir, name), libver, chunked)
    for kind in LAYOUT4:
        _layout4(os.path.join(out_dir, f"layout4_{kind}.h5"), kind)
    for kind in EDGE:
        _edge(os.path.join(out_dir, f"edge_unfiltered_{kind}.h5"), kind)
    _edge_pairs(os.path.join(out_dir, EDGE_PAIRS))
    for name in list(FILES) + [f"layout4_{k}.h5" for k in LAYOUT4] + [
            f"edge_unfiltered_{k}.h5" for k in EDGE] + [EDGE_PAIRS]:
        path = os.path.join(out_dir, name)
        entry = {}
        with h5py.File(path, "r") as f:
            for k in sorted(f):
                a = f[k][()]
                entry[k] = {"shape": list(a.shape), "dtype": str(a.dtype),
                            "sha256": digest(a)}
        digests[name] = entry
        print(f"{name}: {os.path.getsize(path)} bytes")
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


if __name__ == "__main__":
    main(*sys.argv[1:])
