"""HDF5 datasets read and written with numpy and the standard library.

The reference keeps its training data in HDF5 files (xt/yt/xv/yv, uint8
NHWC), read and written through h5py.  The port depends on no such
package: `File` reads what h5py writes, after the public *HDF5 File Format
Specification Version 3.0*, and `create` / `write` write files that h5py
and the JAX package read.

Read:
  * superblock version 0 (h5py's default libver): version-1 object headers
    with continuation blocks, groups as symbol tables (a v1 B-tree, a
    local heap, symbol nodes);
  * superblock versions 2 and 3 (libver="latest"): "OHDR" version-2
    object headers with "OCHK" continuations, groups of compact link
    messages;
  * data layout message versions 3 and 4: compact, contiguous, and
    chunked through the deflate, shuffle and fletcher32 filters (the
    checksum is checked), with version 3's v1 B-tree chunk index or any of
    version 4's five (libver="latest"), partial edge chunks stored
    unfiltered where the layout says so (H5Pset_chunk_opts'
    H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS: a chunk crossing the dataset's
    current edge skips the filters): single chunk (filtered or not),
    implicit, fixed array (FAHD/FADB, paged past 2^page bits entries),
    extensible array (EAHD/EAIB/EASB/EADB: super blocks, paged data
    blocks) and version 2 B-tree (BTHD/BTIN/BTLF, record types 10 and 11,
    any depth); each of these structures' Jenkins lookup3 checksum is
    checked, and a mismatch raises ValueError;
  * storage never allocated, which reads as the fill value;
  * fixed-point and IEEE floating-point data of either byte order.
Anything else raises NotImplementedError naming it: virtual and external
storage, other filters, dense link storage, shared messages, soft and
external links, other datatypes.

A contiguous dataset comes back as a read-only `np.memmap` of the file, so
a dataset larger than memory opens at once and reads only the rows sliced
from it; a compact or chunked dataset is decoded into memory.

Write: superblock version 0, one root group of up to 256 contiguous
datasets, their headers first and their data after them.  `create` returns
writable memmaps of the data, to be filled row by row (a dataset larger
than memory never exists whole); `write` writes arrays in one call.
"""

import mmap
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
            6: "compound", 7: "reference", 8: "enumerated",
            9: "variable-length", 10: "array"}
_FILTERS = {4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf",
            32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
            32013: "zfp", 32015: "zstd"}
# layout version 4's chunk indices, every one of them read
_INDICES = {1: "single chunk", 2: "implicit", 3: "fixed array",
            4: "extensible array", 5: "version 2 B-tree"}
# IEEE layouts: size -> (sign bit, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias)
_IEEE = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
         8: (63, 52, 11, 0, 52, 1023)}


def _u(buf, pos, n):
    return int.from_bytes(buf[pos:pos + n], "little")


def fletcher32(data):
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit words
    (an odd last byte the high byte of one more), both sums folded to 16
    bits as they grow.  A fold keeps a sum's value modulo 65535 and keeps it
    above zero, so each sum ends as 0 if every word is 0, else as the one
    value in 1..65535 congruent to its exact total."""
    data = bytes(data)
    words = np.frombuffer(data, ">u2", len(data) // 2).astype(np.int64)
    if len(data) % 2:
        words = np.append(words, data[-1] << 8)
    if not words.any():
        return 0
    n = len(words)
    s1 = int(words.sum())
    # the second sum adds every running first sum: word i counts n - i times
    s2 = 0
    for b in range(0, n, 1 << 20):
        w = words[b:b + (1 << 20)]
        times = (n - np.arange(b, b + len(w), dtype=np.int64)) % 65535
        s2 += int((w * times).sum())
    return (((s2 - 1) % 65535 + 1) << 16) | ((s1 - 1) % 65535 + 1)


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data, initval=0):
    """Bob Jenkins' lookup3 hashlittle, as HDF5's H5_checksum_lookup3
    computes the checksum of its version-2 metadata (B-tree v2, fixed and
    extensible array blocks)."""
    data = bytes(data)
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & 0xFFFFFFFF
    m = 0xFFFFFFFF
    k = 0
    while n - k > 12:
        x, y, z = struct.unpack_from("<III", data, k)
        a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
        a = (a - c) & m; a ^= _rot(c, 4); c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 6); a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 8); b = (b + a) & m  # noqa: E702
        a = (a - c) & m; a ^= _rot(c, 16); c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 19); a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 4); b = (b + a) & m  # noqa: E702
        k += 12
    if n - k == 0:
        return c
    x, y, z = struct.unpack("<III", data[k:] + bytes(12 - (n - k)))
    a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
    c ^= b; c = (c - _rot(b, 14)) & m  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & m  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & m  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & m  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & m  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & m  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & m  # noqa: E702
    return c


def _enc_size(n):
    """HDF5's H5VM_limit_enc_size: the bytes that hold counts up to n."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


def _chunk_size_len(nbytes):
    """The bytes of a filtered chunk's size in a version-4 chunk index."""
    return min(1 + ((max(int(nbytes), 1).bit_length() - 1) + 8) // 8, 8)


def _unfilter(raw, filters, mask, itemsize):
    """A chunk's stored bytes through its filters, last first; a filter
    whose bit is set in the chunk's mask was skipped when it was written."""
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        fid = filters[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            a = np.frombuffer(raw, np.uint8)
            n = len(a) // itemsize
            body = a[:n * itemsize].reshape(itemsize, n).T.reshape(-1)
            raw = body.tobytes() + bytes(a[n * itemsize:])
        elif fid == 3:
            body, stored = raw[:-4], raw[-4:]
            got = fletcher32(body)
            want = int.from_bytes(stored, "little")
            # files of HDF5 before 1.6.3 stored the sum's bytes swapped
            swapped = int.from_bytes(stored[1::-1] + stored[:1:-1], "little")
            if want != got and swapped != got:
                raise ValueError("HDF5: a chunk fails its fletcher32 "
                                 "checksum")
            raw = body
    return raw


class _Dataset:
    """What a dataset's object header says: shape, dtype, fill value,
    layout and filters."""

    def __init__(self):
        self.shape = None
        self.maxshape = None
        self.dtype = None
        self.fill = None
        self.layout = None
        self.filters = []


class File:
    """An HDF5 file opened for reading: `f[name]` is a dataset's array
    (`name` may hold '/'), `f.keys()` the root group's names.  Usable as a
    context manager, as h5py.File is."""

    def __init__(self, path):
        self.path = os.fspath(path)
        with open(self.path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            if size == 0:
                raise ValueError(f"HDF5: {self.path} is empty")
            self._buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            self._superblock()
        except Exception:
            self.close()
            raise

    # ------------------------------------------------------------ file
    def close(self):
        if self._buf is not None:
            self._buf.close()
            self._buf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _superblock(self):
        b = self._buf
        at = 0
        while b[at:at + 8] != SIGNATURE:
            at = 512 if at == 0 else 2 * at
            if at + 8 > len(b):
                raise ValueError(f"HDF5: {self.path} has no HDF5 superblock")
        version = b[at + 8]
        if version in (0, 1):
            self.O, self.L = b[at + 13], b[at + 14]
            p = at + 24 + (4 if version == 1 else 0)
            base = _u(b, p, self.O)
            root_entry = p + 4 * self.O
            root = _u(b, root_entry + self.O, self.O)
        elif version in (2, 3):
            self.O, self.L = b[at + 9], b[at + 10]
            p = at + 12
            base = _u(b, p, self.O)
            root = _u(b, p + 3 * self.O, self.O)
        else:
            raise NotImplementedError(
                f"HDF5: superblock version {version}")
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            raise ValueError("HDF5: bad sizes of offsets and lengths")
        self.base = base
        self.undef = (1 << (8 * self.O)) - 1
        self.root = root

    def _addr(self, a):
        return self.base + a

    # ---------------------------------------------------- object headers
    def _messages(self, addr):
        """[(type, bytes)] of the object header at `addr`, continuation
        blocks followed."""
        b = self._buf
        a = self._addr(addr)
        out = []
        if b[a:a + 4] == b"OHDR":
            flags = b[a + 5]
            p = a + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10
                                                       else 0)
            width = 1 << (flags & 3)
            size = _u(b, p, width)
            p += width
            blocks = [(p, p + size)]
            order = 2 if flags & 0x04 else 0
            while blocks:
                start, end = blocks.pop(0)
                q = start
                while q + 4 + order <= end:
                    mtype, msize, mflags = b[q], _u(b, q + 1, 2), b[q + 3]
                    q += 4 + order
                    data = bytes(b[q:q + msize])
                    q += msize
                    self._message(mtype, mflags, data, out, blocks, v2=True)
            return out
        if b[a] != 1:
            raise NotImplementedError(f"HDF5: object header version {b[a]}")
        nmsgs, size = _u(b, a + 2, 2), _u(b, a + 8, 4)
        blocks = [(a + 16, a + 16 + size)]
        while blocks and len(out) < nmsgs:
            start, end = blocks.pop(0)
            q = start
            while q + 8 <= end:
                mtype, msize, mflags = _u(b, q, 2), _u(b, q + 2, 2), b[q + 4]
                data = bytes(b[q + 8:q + 8 + msize])
                q += 8 + msize
                self._message(mtype, mflags, data, out, blocks, v2=False)
        return out

    def _message(self, mtype, mflags, data, out, blocks, v2):
        if mtype == 0x10:  # continuation: (offset, length)
            off = self._addr(_u(data, 0, self.O))
            length = _u(data, self.O, self.L)
            if v2:
                if self._buf[off:off + 4] != b"OCHK":
                    raise ValueError("HDF5: a continuation block without "
                                     "its OCHK signature")
                blocks.append((off + 4, off + length - 4))
            else:
                blocks.append((off, off + length))
            return
        if mflags & 0x02 and mtype != 0:
            raise NotImplementedError("HDF5: shared object header messages")
        out.append((mtype, data))

    # ------------------------------------------------------------ groups
    def _links(self, addr):
        """{name: object header address} of the group at `addr`."""
        links = {}
        for mtype, data in self._messages(addr):
            if mtype == 0x11:  # symbol table: v1 B-tree and local heap
                btree, heap = _u(data, 0, self.O), _u(data, self.O, self.O)
                links.update(self._symbol_table(btree, heap))
            elif mtype == 0x02:  # link info: a fractal heap = dense links
                p = 2 + (8 if data[1] & 1 else 0)
                if _u(data, p, self.O) != self.undef:
                    raise NotImplementedError(
                        "HDF5: dense link storage (a fractal heap of links)")
            elif mtype == 0x06:
                name, target = self._link(data)
                links[name] = target
        return links

    def _link(self, data):
        flags = data[1]
        p = 2
        kind = 0
        if flags & 0x08:
            kind = data[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 3)
        n = _u(data, p, width)
        p += width
        name = bytes(data[p:p + n]).decode()
        p += n
        if kind != 0:
            return name, ("soft link" if kind == 1 else "external link")
        return name, _u(data, p, self.O)

    def _symbol_table(self, btree, heap):
        b = self._buf
        h = self._addr(heap)
        if b[h:h + 4] != b"HEAP":
            raise ValueError("HDF5: a local heap without its signature")
        data = self._addr(_u(b, h + 8 + 2 * self.L, self.O))

        def name_at(off):
            end = b.find(b"\0", data + off)
            return bytes(b[data + off:end]).decode()

        links = {}
        entry = 2 * self.O + 24
        for snod in self._btree_children(btree, 0):
            s = self._addr(snod)
            if b[s:s + 4] != b"SNOD":
                raise ValueError("HDF5: a symbol node without its signature")
            for i in range(_u(b, s + 6, 2)):
                e = s + 8 + i * entry
                links[name_at(_u(b, e, self.O))] = (
                    "soft link" if _u(b, e + 2 * self.O, 4) == 2
                    else _u(b, e + self.O, self.O))
        return links

    def _btree_children(self, addr, node_type, ndims=0):
        """Level-0 (key, child) pairs of a v1 B-tree: a group's symbol
        nodes (type 0; key unused) or a dataset's chunks (type 1; key
        (size, filter mask, offsets))."""
        b = self._buf
        a = self._addr(addr)
        if b[a:a + 4] != b"TREE" or b[a + 4] != node_type:
            raise ValueError("HDF5: a B-tree node without its signature")
        level, used = b[a + 5], _u(b, a + 6, 2)
        key = self.L if node_type == 0 else 8 + 8 * ndims
        p = a + 8 + 2 * self.O
        out = []
        for i in range(used):
            k = p + i * (key + self.O)
            child = _u(b, k + key, self.O)
            if level:
                out += self._btree_children(child, node_type, ndims)
            elif node_type == 0:
                out.append(child)
            else:
                offs = [_u(b, k + 8 + 8 * d, 8) for d in range(ndims)]
                out.append(((_u(b, k, 4), _u(b, k + 4, 4), offs), child))
        return out

    def keys(self):
        return sorted(self._links(self.root))

    def __contains__(self, name):
        try:
            self._find(name)
        except KeyError:
            return False
        return True

    def _find(self, name):
        addr = self.root
        for part in [p for p in name.split("/") if p]:
            links = self._links(addr)
            if part not in links:
                raise KeyError(f"HDF5: no {name!r} in {self.path}")
            addr = links[part]
            if isinstance(addr, str):
                raise NotImplementedError(f"HDF5: {name!r} is a {addr}")
        return addr

    # ---------------------------------------------------------- datasets
    def __getitem__(self, name):
        ds = self._dataset(self._messages(self._find(name)), name)
        kind = ds.layout[0]
        count = int(np.prod(ds.shape, dtype=np.int64))
        if kind == "compact":
            return np.frombuffer(ds.layout[1], ds.dtype,
                                 count).reshape(ds.shape).copy()
        if kind == "contiguous":
            addr = ds.layout[1]
            if addr == self.undef or count == 0:
                return np.full(ds.shape, ds.fill, ds.dtype)
            return np.memmap(self.path, ds.dtype, "r",
                             offset=self._addr(addr), shape=ds.shape)
        return self._chunked(ds)

    def _dataset(self, messages, name):
        ds = _Dataset()
        fill_old = None
        for mtype, data in messages:
            if mtype == 0x01:
                ds.shape, ds.maxshape = self._dataspace(data)
            elif mtype == 0x03:
                ds.dtype = _datatype(data)
            elif mtype == 0x04:
                fill_old = data[4:4 + _u(data, 0, 4)]
            elif mtype == 0x05:
                ds.fill = _fill_value(data)
            elif mtype == 0x07:
                raise NotImplementedError("HDF5: external data files")
            elif mtype == 0x08:
                ds.layout = self._layout(data)
            elif mtype == 0x0B:
                ds.filters = _filters(data)
        if ds.shape is None or ds.dtype is None or ds.layout is None:
            raise ValueError(f"HDF5: {name!r} is not a dataset")
        if ds.fill is None:
            ds.fill = fill_old
        fill = ds.fill
        ds.fill = (np.frombuffer(fill, ds.dtype)[0]
                   if fill is not None and len(fill) == ds.dtype.itemsize
                   else ds.dtype.type(0))
        return ds

    def _dataspace(self, data):
        """(dims, max dims; an unlimited one None)."""
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            p = 8
        elif version == 2:
            if data[3] == 2:
                raise NotImplementedError("HDF5: a null dataspace")
            p = 4
        else:
            raise NotImplementedError(f"HDF5: dataspace version {version}")
        dims = tuple(_u(data, p + self.L * i, self.L) for i in range(rank))
        if not flags & 1:
            return dims, dims
        p += self.L * rank
        big = (1 << (8 * self.L)) - 1
        return dims, tuple(None if v == big else v for v in (
            _u(data, p + self.L * i, self.L) for i in range(rank)))

    def _layout(self, data):
        version, cls = data[0], data[1]
        if version not in (3, 4):
            raise NotImplementedError(f"HDF5: data layout version {version}")
        if cls == 0:
            n = _u(data, 2, 2)
            return ("compact", bytes(data[4:4 + n]))
        if cls == 1:
            return ("contiguous", _u(data, 2, self.O))
        if cls == 3:
            raise NotImplementedError("HDF5: virtual dataset storage")
        if cls != 2:
            raise NotImplementedError(f"HDF5: data layout class {cls}")
        if version == 4:
            return self._layout4(data)
        ndims = data[2]
        btree = _u(data, 3, self.O)
        dims = [_u(data, 3 + self.O + 4 * i, 4) for i in range(ndims)]
        return ("chunked", btree, dims)

    def _layout4(self, data):
        """Version 4's chunked layout: ("chunked4", index type, address,
        chunk dims with the element size last, the single chunk's filtered
        size and mask, whether partial edge chunks are stored unfiltered).
        Each index's own parameters are in its header."""
        flags, ndims, enc = data[2], data[3], data[4]
        dims = [_u(data, 5 + enc * i, enc) for i in range(ndims)]
        p = 5 + enc * ndims
        index = data[p]
        if index not in _INDICES:
            raise NotImplementedError(
                f"HDF5: chunk index type {index} (the reader knows "
                f"{', '.join(_INDICES.values())})")
        single = None
        if index == 1 and flags & 2:
            single = (_u(data, p + 1, self.L), _u(data, p + 1 + self.L, 4))
        # the index's parameters: the filtered single chunk's size and mask;
        # a fixed array's page bits; an extensible array's five sizes; a
        # version 2 B-tree's node size, split and merge percentages
        p += 1 + {1: self.L + 4 if flags & 2 else 0, 2: 0, 3: 1, 4: 5,
                  5: 6}[index]
        return ("chunked4", index, _u(data, p, self.O), dims, single,
                bool(flags & 1))

    def _chunked(self, ds):
        if ds.layout[0] == "chunked4":
            _, index, addr, dims, single, edge_raw = ds.layout
        else:
            _, addr, dims = ds.layout
            index, single, edge_raw = 0, None, False
        chunk = tuple(dims[:-1])
        out = np.full(ds.shape, ds.fill, ds.dtype)
        if addr == self.undef or not out.size:
            return out
        nbytes = int(np.prod(chunk)) * ds.dtype.itemsize
        if index == 0:
            entries = self._btree_children(addr, 1, len(dims))
        else:
            entries = self._index4(ds, index, addr, chunk, nbytes, single)
        for (size, mask, offs), a in entries:
            a = self._addr(a)
            raw = bytes(self._buf[a:a + size])
            # H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS: a chunk that crosses the
            # dataset's edge is stored as it is, whatever its filter mask
            if not (edge_raw and any(o + c > d for o, c, d in
                                     zip(offs, chunk, ds.shape))):
                raw = _unfilter(raw, ds.filters, mask, ds.dtype.itemsize)
            block = np.frombuffer(raw, ds.dtype,
                                  int(np.prod(chunk))).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offs, chunk, ds.shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    # ------------------------------------------- layout version 4's indices
    def _checked(self, a, n, what):
        """The n bytes at file address `a` (absolute), followed by their
        lookup3 checksum, which must match."""
        if a + n + 4 > len(self._buf):
            raise ValueError(f"HDF5: a {what} lies past the file's end")
        body = bytes(self._buf[a:a + n])
        (want,) = struct.unpack("<I", self._buf[a + n:a + n + 4])
        if lookup3(body) != want:
            raise ValueError(f"HDF5: a {what} fails its lookup3 checksum")
        return body

    def _entry(self, buf, p, filtered, nbytes):
        """One chunk entry of a fixed or extensible array or a B-tree
        record: (address, stored size, filter mask) and its length."""
        a = _u(buf, p, self.O)
        if not filtered:
            return (a, nbytes, 0), self.O
        n = _chunk_size_len(nbytes)
        return (a, _u(buf, p + self.O, n),
                _u(buf, p + self.O + n, 4)), self.O + n + 4

    def _index4(self, ds, index, addr, chunk, nbytes, single):
        """[((stored size, filter mask, element offsets), address)] of a
        version-4 chunk index's allocated chunks."""
        grid_dims = [m if m is not None else s
                     for s, m in zip(ds.shape, ds.maxshape)]
        grid = [-(-d // c) for d, c in zip(grid_dims, chunk)]
        filtered = bool(ds.filters)
        if index == 1:
            size, mask = single if single else (nbytes, 0)
            return [((size, mask, [0] * len(chunk)), addr)]
        if index == 2:
            n = int(np.prod(grid))
            return [((nbytes, 0, self._offsets(i, grid, chunk)),
                     addr + i * nbytes) for i in range(n)]
        unlim = 0
        if index == 3:
            elems = self._fixed_array(addr, filtered, nbytes)
        elif index == 4:
            elems = self._extensible_array(addr, filtered, nbytes)
            unlim = next((i for i, m in enumerate(ds.maxshape) if m is None),
                         0)
        else:
            return [((size, mask, [s * c for s, c in zip(scaled, chunk)]),
                     a) for (a, size, mask), scaled in
                    self._btree2(addr, filtered, nbytes, len(chunk))
                    if a != self.undef]
        out = []
        for i, (a, size, mask) in enumerate(elems):
            if a == self.undef:
                continue
            if unlim:  # the unlimited dimension is the slowest (swizzled)
                g = [grid[unlim]] + grid[:unlim] + grid[unlim + 1:]
                offs = self._offsets(i, g, [chunk[unlim]] + list(
                    chunk[:unlim]) + list(chunk[unlim + 1:]))
                offs = offs[1:unlim + 1] + [offs[0]] + offs[unlim + 1:]
            else:
                offs = self._offsets(i, grid, chunk)
            out.append(((size, mask, offs), a))
        return out

    @staticmethod
    def _offsets(i, grid, chunk):
        """The element offsets of chunk i in row-major order over `grid`."""
        scaled = []
        for g in reversed(grid):
            i, r = divmod(i, g)
            scaled.append(r)
        return [s * c for s, c in zip(reversed(scaled), chunk)]

    def _fixed_array(self, addr, filtered, nbytes):
        """[(address, size, mask)] of every entry of a fixed array."""
        b, O, L = self._buf, self.O, self.L
        h = self._addr(addr)
        if b[h:h + 4] != b"FAHD":
            raise ValueError("HDF5: a fixed array header without FAHD")
        hd = self._checked(h, 8 + L + O, "fixed array header")
        esize, page_bits = hd[6], hd[7]
        n = _u(hd, 8, L)
        d = self._addr(_u(hd, 8 + L, O))
        if b[d:d + 4] != b"FADB":
            raise ValueError("HDF5: a fixed array data block without FADB")
        per_page = 1 << page_bits
        paged = n > per_page
        if not paged:
            body = self._checked(d, 6 + O + n * esize, "fixed array data "
                                 "block")
            return [self._entry(body, 6 + O + i * esize, filtered, nbytes)[0]
                    for i in range(n)]
        pages = -(-n // per_page)
        nmap = -(-pages // 8)
        prefix = self._checked(d, 6 + O + nmap, "fixed array data block")
        bitmap = prefix[6 + O:]
        at = d + 6 + O + nmap + 4
        out = []
        for pg in range(pages):
            k = min(per_page, n - pg * per_page)
            if not bitmap[pg // 8] & (0x80 >> (pg % 8)):
                out += [(self.undef, 0, 0)] * k
            else:
                body = self._checked(at + pg * (per_page * esize + 4),
                                     k * esize, "fixed array page")
                out += [self._entry(body, i * esize, filtered, nbytes)[0]
                        for i in range(k)]
        return out

    def _extensible_array(self, addr, filtered, nbytes):
        """[(address, size, mask)] of every element of an extensible array
        up to its largest index set (H5EAcache.c, H5EA__lookup_elmt)."""
        b, O, L = self._buf, self.O, self.L
        h = self._addr(addr)
        if b[h:h + 4] != b"EAHD":
            raise ValueError("HDF5: an extensible array header without "
                             "EAHD")
        hd = self._checked(h, 12 + 6 * L + O, "extensible array header")
        esize, max_bits, iblk_elmts, dblk_min, sblk_min_ptrs, page_bits = \
            hd[6:12]
        n_max = _u(hd, 12 + 4 * L, L)  # the largest index set, plus one
        iaddr = _u(hd, 12 + 6 * L, O)
        undef = (self.undef, 0, 0)
        if iaddr == self.undef:
            return [undef] * n_max
        off_size = (max_bits + 7) // 8
        nsblks = 1 + max_bits - (dblk_min.bit_length() - 1)
        info, start, start_dblk = [], 0, 0
        for u in range(nsblks):
            nd, ne = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
            info.append((nd, ne, start, start_dblk))
            start += nd * ne
            start_dblk += nd
        iblk_sblks = 2 * (sblk_min_ptrs.bit_length() - 1)
        ndblk = 2 * (sblk_min_ptrs - 1)
        nsblk = nsblks - iblk_sblks
        ia = self._addr(iaddr)
        if b[ia:ia + 4] != b"EAIB":
            raise ValueError("HDF5: an extensible array index block without "
                             "EAIB")
        ib = self._checked(ia, 6 + O + iblk_elmts * esize + (ndblk + nsblk)
                           * O, "extensible array index block")
        p = 6 + O
        out = [self._entry(ib, p + i * esize, filtered, nbytes)[0]
               for i in range(iblk_elmts)]
        p += iblk_elmts * esize
        dblks = [_u(ib, p + i * O, O) for i in range(ndblk)]
        sblks = [_u(ib, p + (ndblk + i) * O, O) for i in range(nsblk)]
        per_page = 1 << page_bits
        prefix = 6 + O + off_size  # a data block before its elements

        def dblock(a, ne, page_init):
            """The ne elements of the data block at a (pages whose bit in
            page_init is clear read as unallocated)."""
            if a == self.undef:
                return [undef] * ne
            a = self._addr(a)
            if b[a:a + 4] != b"EADB":
                raise ValueError("HDF5: an extensible array data block "
                                 "without EADB")
            if ne <= per_page:
                body = self._checked(a, prefix + ne * esize,
                                     "extensible array data block")
                return [self._entry(body, prefix + i * esize, filtered,
                                    nbytes)[0] for i in range(ne)]
            self._checked(a, prefix, "extensible array data block")
            got = []
            for pg in range(ne // per_page):
                if page_init is not None and not page_init(pg):
                    got += [undef] * per_page
                    continue
                body = self._checked(a + prefix + 4 + pg * (
                    per_page * esize + 4), per_page * esize,
                    "extensible array data block page")
                got += [self._entry(body, i * esize, filtered, nbytes)[0]
                        for i in range(per_page)]
            return got

        for u, (nd, ne, _, first) in enumerate(info):
            if len(out) >= n_max:
                break
            if u < iblk_sblks:
                for j in range(nd):
                    out += dblock(dblks[first + j], ne, None)
                continue
            sa = sblks[u - iblk_sblks]
            if sa == self.undef:
                out += [undef] * (nd * ne)
                continue
            sa = self._addr(sa)
            if b[sa:sa + 4] != b"EASB":
                raise ValueError("HDF5: an extensible array super block "
                                 "without EASB")
            npages = ne // per_page if ne > per_page else 0
            # a byte or more of page bits a data block (H5EAsblock.c)
            nmap = nd * ((npages + 7) // 8)
            sb = self._checked(sa, 6 + O + off_size + nmap + nd * O,
                               "extensible array super block")
            bitmap = sb[6 + O + off_size:6 + O + off_size + nmap]
            q = 6 + O + off_size + nmap
            for j in range(nd):
                init = None
                if npages:
                    def init(pg, j=j):
                        k = j * npages + pg
                        return bitmap[k // 8] & (0x80 >> (k % 8))
                out += dblock(_u(sb, q + j * O, O), ne, init)
        return out[:n_max]

    def _btree2(self, addr, filtered, nbytes, ndims):
        """[((address, size, mask), scaled offsets)] of every record of a
        version-2 B-tree of chunks (record types 10 and 11)."""
        b, O, L = self._buf, self.O, self.L
        h = self._addr(addr)
        if b[h:h + 4] != b"BTHD":
            raise ValueError("HDF5: a version 2 B-tree header without BTHD")
        hd = self._checked(h, 16 + O + 2 + L, "version 2 B-tree header")
        rtype, node_size, rec_size, depth = hd[5], _u(hd, 6, 4), \
            _u(hd, 10, 2), _u(hd, 12, 2)
        if rtype not in (10, 11):
            raise NotImplementedError(f"HDF5: a version 2 B-tree of record "
                                      f"type {rtype}")
        root, root_n = _u(hd, 16, O), _u(hd, 16 + O, 2)
        # the sizes of the record counts in child pointers (H5B2hdr.c)
        max_nrec = [(node_size - 10) // rec_size]
        cum = [max_nrec[0]]
        cum_size = [0]
        nrec_size = _enc_size(max_nrec[0])
        for d in range(1, depth + 1):
            ptr = O + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
            cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
            cum_size.append(_enc_size(cum[d]))
        out = []

        def record(body, p):
            ent, n = self._entry(body, p, rtype == 11, nbytes)
            scaled = [_u(body, p + n + 8 * i, 8) for i in range(ndims)]
            out.append((ent, scaled))

        def node(a, nrec, d):
            a = self._addr(a)
            sig = b"BTLF" if d == 0 else b"BTIN"
            if b[a:a + 4] != sig:
                raise ValueError(f"HDF5: a version 2 B-tree node without "
                                 f"{sig.decode()}")
            ptr = O + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            size = 6 + nrec * rec_size + (0 if d == 0 else (nrec + 1) * ptr)
            body = self._checked(a, size, "version 2 B-tree node")
            for i in range(nrec):
                record(body, 6 + i * rec_size)
            for i in range(nrec + 1 if d else 0):
                q = 6 + nrec * rec_size + i * ptr
                node(_u(body, q, O), _u(body, q + O, nrec_size), d - 1)

        if root != self.undef and root_n:
            node(root, root_n, depth)
        return out


def _datatype(data):
    cls = data[0] & 15
    bits = data[1] | data[2] << 8 | data[3] << 16
    size = _u(data, 4, 4)
    if cls == 0:
        offset, precision = _u(data, 8, 2), _u(data, 10, 2)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise NotImplementedError(
                f"HDF5: a {precision}-bit fixed-point type at bit {offset} "
                f"of {size} bytes")
        kind = "i" if bits & 8 else "u"
        return np.dtype(("<", ">")[bits & 1] + kind + str(size))
    if cls == 1:
        if bits & 0x40:
            raise NotImplementedError("HDF5: a VAX-order floating-point type")
        props = (bits >> 8 & 0xFF, data[12], data[13], data[14], data[15],
                 _u(data, 16, 4))
        if size not in _IEEE or props != _IEEE[size] or _u(data, 8, 2):
            raise NotImplementedError(
                f"HDF5: a non-IEEE floating-point type of {size} bytes")
        return np.dtype(("<", ">")[bits & 1] + "f" + str(size))
    raise NotImplementedError(
        f"HDF5: the {_CLASSES.get(cls, f'class {cls}')} datatype")


def _fill_value(data):
    version = data[0]
    if version in (1, 2):
        defined = data[3]
        if version == 1 or defined:
            n = _u(data, 4, 4)
            return bytes(data[8:8 + n]) if n else None
        return None
    flags = data[1]
    if flags & 0x20:
        n = _u(data, 2, 4)
        return bytes(data[6:6 + n])
    return None


def _filters(data):
    version, n = data[0], data[1]
    p = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _u(data, p, 2)
        p += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = _u(data, p, 2)
            p += 2
        nvals = _u(data, p + 2, 2)
        p += 4
        name = bytes(data[p:p + name_len]).split(b"\0")[0].decode(
            errors="replace")
        p += name_len + 4 * nvals
        if version == 1 and nvals % 2:
            p += 4
        if fid not in (1, 2, 3):
            label = _FILTERS.get(fid, name or "unknown")
            raise NotImplementedError(
                f"HDF5: the {label} filter (id {fid})")
        out.append(fid)
    return out


# ------------------------------------------------------------------ writer
_O = 8            # sizes of offsets and lengths
_LEAF_K = 4       # symbol node: up to 2K entries
_INTERNAL_K = 16  # group B-tree node: up to 2K children
_UNDEF = b"\xff" * _O


def _pad8(b):
    return b + bytes(-len(b) % 8)


def _msg(mtype, data, flags=0):
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _datatype_msg(dtype):
    order = 1 if dtype.byteorder == ">" or (
        dtype.byteorder == "=" and not np.little_endian) else 0
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = order | (8 if dtype.kind == "i" else 0)
        return struct.pack("<B3BIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in _IEEE:
        sign, eloc, esize, mloc, msize, bias = _IEEE[size]
        bits = order | 0x20
        return struct.pack("<B3BIHHBBBBI", 0x11, bits, sign, 0, size, 0,
                           8 * size, eloc, esize, mloc, msize, bias)
    raise NotImplementedError(f"HDF5 writer: the numpy type {dtype}")


def _object_header(messages):
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dataset_header(shape, dtype, at, nbytes):
    """A contiguous dataset's version-1 object header: dataspace,
    datatype, fill value (allocated late, written if set, undefined: zeros)
    and layout (`at` None: no storage)."""
    space = struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
        struct.pack("<Q", s) for s in shape)
    fill = struct.pack("<BBBB", 2, 2, 2, 0)
    layout = struct.pack("<BBQQ", 3, 1, (1 << 64) - 1 if at is None else at,
                         nbytes)
    return _object_header([_msg(0x01, space),
                           _msg(0x03, _datatype_msg(dtype), 1),
                           _msg(0x05, fill, 1), _msg(0x08, layout)])


def create(path, specs):
    """Write an HDF5 file whose root group holds one contiguous dataset per
    entry of `specs` ({name: (shape, dtype)}), its data unwritten (zeros),
    and return {name: writable np.memmap of its data}: fill them (row by
    row for a dataset larger than memory) and flush."""
    names = list(specs)
    if not names or len(names) > 2 * _LEAF_K * 2 * _INTERNAL_K:
        raise ValueError(f"HDF5 writer: 1 to "
                         f"{2 * _LEAF_K * 2 * _INTERNAL_K} datasets")
    for name in names:
        if not name or "/" in name or "\0" in name:
            raise ValueError(f"HDF5 writer: bad dataset name {name!r}")
    order = sorted(names, key=lambda s: s.encode())
    # local heap: "" at 0, then each name, null-terminated, 8-aligned
    heap_data, offset = bytearray(8), {}
    for name in order:
        offset[name] = len(heap_data)
        heap_data += _pad8(name.encode() + b"\0")
    superblock_size = 56 + 2 * _O + 24
    root_size = 16 + 8 + 16
    heap_addr = superblock_size + root_size
    heap_size = 8 + 3 * _O + len(heap_data)
    btree_addr = heap_addr + heap_size
    btree_size = 8 + 2 * _O + (2 * _INTERNAL_K + 1) * _O \
        + 2 * _INTERNAL_K * _O
    entry = 2 * _O + 24
    snod_size = 8 + 2 * _LEAF_K * entry
    groups = [order[i:i + 2 * _LEAF_K]
              for i in range(0, len(order), 2 * _LEAF_K)]
    snod_addr = [btree_addr + btree_size + i * snod_size
                 for i in range(len(groups))]
    p = snod_addr[-1] + snod_size
    headers, data_at, nbytes = {}, {}, {}
    for name in names:
        shape, dtype = specs[name]
        shape = tuple(int(s) for s in shape)
        dtype = np.dtype(dtype)
        nbytes[name] = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        headers[name] = (p, shape, dtype)
        p += len(_dataset_header(shape, dtype, None, 0))
    p += -p % 64
    for name in names:
        data_at[name] = p if nbytes[name] else None
        p += nbytes[name]
        p += -p % 8
    eof = p

    out = bytearray()
    root_header = _object_header([_msg(0x11, struct.pack(
        "<QQ", btree_addr, heap_addr))])
    out += SIGNATURE + bytes([0, 0, 0, 0, 0, _O, _O, 0])
    out += struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
    out += struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", eof) + _UNDEF
    out += struct.pack("<QQII", 0, superblock_size, 1, 0)
    out += struct.pack("<QQ", btree_addr, heap_addr)
    assert len(out) == superblock_size
    out += root_header
    assert len(out) == heap_addr
    out += b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap_data), 1,
                                            heap_addr + 8 + 3 * _O)
    out += heap_data
    node = b"TREE" + bytes([0, 0]) + struct.pack("<H", len(groups))
    node += _UNDEF + _UNDEF + struct.pack("<Q", 0)
    for group, addr in zip(groups, snod_addr):
        node += struct.pack("<QQ", addr, offset[group[-1]])
    out += node + bytes(btree_size - len(node))
    for group, addr in zip(groups, snod_addr):
        assert len(out) == addr
        snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(group))
        for name in group:
            snod += struct.pack("<QQII16x", offset[name], headers[name][0],
                                0, 0)
        out += snod + bytes(snod_size - len(snod))
    for name in names:
        addr, shape, dtype = headers[name]
        assert len(out) == addr
        out += _dataset_header(shape, dtype, data_at[name], nbytes[name])
    with open(path, "wb") as f:
        f.write(out)
        f.truncate(eof)
    maps = {}
    for name in names:
        _, shape, dtype = headers[name]
        if data_at[name] is None:
            maps[name] = np.zeros(shape, dtype)
        else:
            maps[name] = np.memmap(path, dtype, "r+", offset=data_at[name],
                                   shape=shape)
    return maps


def write(path, arrays):
    """Write {name: array} as an HDF5 file of contiguous datasets."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    maps = create(path, {k: (v.shape, v.dtype) for k, v in arrays.items()})
    for name, m in maps.items():
        if isinstance(m, np.memmap):
            m[...] = arrays[name]
            m.flush()
    return path
