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
                                version 4's fixed-array chunk index, which
                                data/h5.py refuses by name
digests.json holds, for each file, each dataset's shape, dtype and the
SHA-256 of h5py's array (or, for the refused file, the error the port's
reader must raise), and under "reference" the h5py and HDF5 versions that
wrote them.  h5py is needed here, not on the card: chip_smoke.py reads the
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
REFUSED = {"pairs_latest_gzip.h5":
           "data layout version 4's fixed array chunk index"}


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


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main(out_dir=DEFAULT_DIR):
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    digests = {"reference": {"h5py": h5py.__version__,
                             "hdf5": h5py.version.hdf5_version}}
    for name, (libver, chunked) in FILES.items():
        path = os.path.join(out_dir, name)
        write(path, libver, chunked)
        if name in REFUSED:
            digests[name] = {"refused": REFUSED[name]}
            continue
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
