"""HDF5 files read and written with numpy and the standard library.

The port's copy of the part of h5py that the JAX package uses: the
readers read the pseudo-label heat maps and the A2D instance masks from
``.h5`` files, and the pseudo-label generator writes them.  The card's
machine has no h5py, so the port parses the file format itself
(``struct`` for the structures, ``zlib`` for deflate).

Reading: ``read_datasets(path, names=None)`` returns ``{name: array}``
for the named datasets (``/``-separated paths), every dataset by
default; ``dataset_names(path)`` lists them.  Each array equals
``np.asarray(h5py.File(path)[name][()])``: the same shape and dtype,
byte order made native, a 0-d array for a scalar dataspace, ``bool`` for
h5py's bool enum.  It covers what h5py writes by default and with
``libver="latest"``, and what MATLAB ``-v7.3`` writes:

* superblocks 0-3, found at 0, 512, 1024, 2048, ... (a user block first);
* object headers v1 and v2 (``OHDR``) with their continuation blocks;
* groups as symbol tables (v1 B-trees of type 0, a local heap and
  ``SNOD`` nodes, any depth) or compact link messages;
* compact, contiguous and chunked layouts: layout v3 with a v1 B-tree of
  type 1, layout v4 with the single-chunk, implicit and fixed-array
  indexes; chunks never written read as the fill value;
* the deflate, shuffle and Fletcher-32 filters (the checksum is checked);
* fixed-point integers of 1, 2, 4 and 8 bytes, IEEE floats of 2, 4 and 8
  bytes, either byte order, and h5py's bool (an int8 enum FALSE=0,
  TRUE=1).

It never guesses: a structure it does not parse (dense link storage in a
fractal heap, extensible-array and v2 B-tree chunk indexes, other
filters, strings, compounds, references, variable-length types, shared
messages, null dataspaces) raises ``NotImplementedError`` naming the
structure, the dataset and the file; a checksum that does not match or a
structure that runs past the file raises ``H5FormatError``.

Writing: ``write_datasets(path, items)`` writes a new file as h5py does
by default (superblock v0, a symbol-table root group, v1 object headers,
contiguous little-endian datasets), so any HDF5 reader takes it.
``update_datasets(path, items)`` is ``h5py.File(path, "r+")`` followed by
``del f[k]; f.create_dataset(k, data=v)`` for each item: the file is
rewritten beside the old one and moved over it.
"""

from __future__ import annotations

import os
import stat
import struct
import tempfile
import zlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE, _CONTINUATION = 0x6, 0x8, 0xB, 0xC, 0x10
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x11, 0x15

_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
                5: "opaque", 6: "compound", 7: "reference", 8: "enumeration",
                9: "variable-length", 10: "array"}
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf"}
_INDEX_NAMES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
                5: "version 2 B-tree"}
# IEEE layouts by size: (exponent location, exponent size, mantissa
# location, mantissa size, exponent bias)
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}

PathLike = Union[str, "os.PathLike"]


class H5FormatError(ValueError):
    """A file that breaks the HDF5 format: a bad signature or checksum, a
    structure past the end of the file."""


# ------------------------------------------------------------- checksums --
def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, the checksum of HDF5's
    version-2 metadata (superblock v2/3, ``OHDR``, ``OCHK``, fixed arrays)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & 0xFFFFFFFF
    if n == 0:
        return c
    m = 0xFFFFFFFF
    padded = data + b"\0" * (-n % 12)
    words = struct.unpack(f"<{len(padded) // 4}I", padded)
    last = len(words) - 3
    for i in range(0, last, 3):
        a, b, c = (a + words[i]) & m, (b + words[i + 1]) & m, (c + words[i + 2]) & m
        a = (a - c) & m; a ^= _rot(c, 4); c = (c + b) & m     # noqa: E702  (mix)
        b = (b - a) & m; b ^= _rot(a, 6); a = (a + c) & m     # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 8); b = (b + a) & m     # noqa: E702
        a = (a - c) & m; a ^= _rot(c, 16); c = (c + b) & m    # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 19); a = (a + c) & m    # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 4); b = (b + a) & m     # noqa: E702
    a, b, c = (a + words[last]) & m, (b + words[last + 1]) & m, (c + words[last + 2]) & m
    c ^= b; c = (c - _rot(b, 14)) & m     # noqa: E702  (final)
    a ^= c; a = (a - _rot(c, 11)) & m     # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & m     # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & m     # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & m      # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & m     # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & m     # noqa: E702
    return c


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): 16-bit big-endian
    words, the sums folded every 360 words, an odd last byte as the high
    byte of a word."""
    odd = len(data) % 2
    words = np.frombuffer(data, ">u2", len(data) // 2).astype(np.int64)
    s1 = s2 = 0
    for start in range(0, len(words), 360):
        block = words[start:start + 360]
        t = len(block)
        # t steps of s1 += w; s2 += s1 from (s1, s2)
        s2 += t * s1 + int(np.dot(np.arange(t, 0, -1, dtype=np.int64), block))
        s1 += int(block.sum())
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if odd:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & 0xFFFFFFFF


# ---------------------------------------------------------------- reader --
class _Dataset:
    """A dataset's header messages, decoded."""

    def __init__(self, name: str):
        self.name = name
        self.shape: Tuple[int, ...] = ()
        self.dtype: np.dtype = np.dtype("u1")    # the file's element type
        self.is_bool = False
        self.fill: Optional[bytes] = None
        self.filters: List[Tuple[int, Tuple[int, ...]]] = []
        self.layout: Tuple = ()


class _File:
    """One open HDF5 file: the superblock, object headers, groups and
    datasets, each parsed when asked for."""

    def __init__(self, path: PathLike):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        try:
            self._size = os.fstat(self._f.fileno()).st_size
            self._superblock()
        except BaseException:
            self._f.close()
            raise
        self._members_cache: Dict[int, Dict[str, int]] = {}

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "_File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ bytes --
    def _read(self, addr: int, n: int, what: str) -> bytes:
        at = self.base + addr
        if addr == self.undef or at + n > self._size:
            raise H5FormatError(f"{what} at address {addr} ({n} bytes) lies past the end of "
                                f"{self.path} ({self._size} bytes)")
        self._f.seek(at)
        return self._f.read(n)

    def _uint(self, buf: bytes, pos: int, n: int) -> int:
        return int.from_bytes(buf[pos:pos + n], "little")

    def _offset(self, buf: bytes, pos: int) -> int:
        return self._uint(buf, pos, self.so)

    def _length(self, buf: bytes, pos: int) -> int:
        return self._uint(buf, pos, self.sl)

    def _checked(self, buf: bytes, what: str) -> None:
        """Raise unless the last 4 bytes of ``buf`` are the lookup3 of the rest."""
        if lookup3(buf[:-4]) != struct.unpack_from("<I", buf, len(buf) - 4)[0]:
            raise H5FormatError(f"{what} of {self.path}: checksum mismatch")

    # ------------------------------------------------------- superblock --
    def _superblock(self) -> None:
        at = 0
        while True:
            if at + 8 > self._size:
                raise H5FormatError(f"{self.path}: no HDF5 signature at 0, 512, 1024, ...")
            self._f.seek(at)
            if self._f.read(8) == SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        self._f.seek(at)
        head = self._f.read(min(self._size - at, 256))
        version = head[8]
        if version in (0, 1):
            self.so, self.sl = head[13], head[14]
            pos = 24 + (4 if version == 1 else 0)
        elif version in (2, 3):
            self.so, self.sl = head[9], head[10]
            pos = 12
        else:
            raise NotImplementedError(f"superblock version {version} in {self.path}")
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise H5FormatError(f"{self.path}: sizes of offsets {self.so} and lengths {self.sl}")
        self.undef = (1 << (8 * self.so)) - 1
        if version in (0, 1):
            # base, free space, end of file, driver block, root symbol table entry
            entry = pos + 4 * self.so
            self.root = self._offset(head, entry + self.so)
        else:
            # base, extension, end of file, root object header, checksum
            end = pos + 4 * self.so
            self._checked(head[:end + 4], "superblock")
            self.root = self._offset(head, pos + 3 * self.so)
        # addresses are relative to the superblock's place (after a user
        # block), whatever its base address field says, as the library reads it
        self.base = at

    # --------------------------------------------------- object headers --
    def messages(self, addr: int, what: str) -> List[Tuple[int, int, bytes]]:
        """The (type, flags, data) messages of the object header at ``addr``,
        continuation blocks followed."""
        prefix = self._read(addr, 16, f"object header of {what}")
        out: List[Tuple[int, int, bytes]] = []
        if prefix[:4] == b"OHDR":
            self._messages_v2(addr, prefix, what, out)
        elif prefix[0] == 1:
            size = struct.unpack_from("<I", prefix, 8)[0]
            blocks = [(addr + 16, size)]
            while blocks:
                at, n = blocks.pop(0)
                buf = self._read(at, n, f"object header of {what}")
                pos = 0
                while pos + 8 <= n:
                    mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                    data = buf[pos + 8:pos + 8 + msize]
                    pos += 8 + msize
                    if mtype == _CONTINUATION:
                        blocks.append((self._offset(data, 0), self._length(data, self.so)))
                    else:
                        out.append((mtype, flags, data))
        else:
            raise NotImplementedError(f"object header version {prefix[0]} of {what} in "
                                      f"{self.path}")
        for mtype, flags, _ in out:
            if flags & 0x02 and mtype != _NIL:
                raise NotImplementedError(f"shared object header message (type {mtype:#x}) "
                                          f"in {what} of {self.path}")
        return out

    def _messages_v2(self, addr, prefix, what, out) -> None:
        flags = prefix[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        chunk0 = self._uint(self._read(addr + pos, width, f"object header of {what}"), 0, width)
        head = pos + width
        buf = self._read(addr, head + chunk0 + 4, f"object header of {what}")
        self._checked(buf, f"object header of {what}")
        blocks = [(buf, head, head + chunk0)]
        step = 6 if flags & 0x04 else 4
        while blocks:
            block, pos, end = blocks.pop(0)
            while pos + step <= end:
                mtype, msize, mflags = struct.unpack_from("<BHB", block, pos)
                data = block[pos + step:pos + step + msize]
                pos += step + msize
                if mtype == _CONTINUATION:
                    at, n = self._offset(data, 0), self._length(data, self.so)
                    cont = self._read(at, n, f"object header continuation of {what}")
                    if cont[:4] != b"OCHK":
                        raise H5FormatError(f"object header continuation of {what} in "
                                            f"{self.path}: no OCHK signature")
                    self._checked(cont, f"object header continuation of {what}")
                    blocks.append((cont, 4, n - 4))
                else:
                    out.append((mtype, mflags, data))

    # ----------------------------------------------------------- groups --
    def members(self, addr: int, what: str) -> Dict[str, int]:
        """``{name: object header address}`` of the group at ``addr``."""
        if addr in self._members_cache:
            return self._members_cache[addr]
        out: Dict[str, int] = {}
        for mtype, _, data in self.messages(addr, what):
            if mtype == _SYMBOL_TABLE:
                heap = self._local_heap(self._offset(data, self.so), what)
                self._btree_group(self._offset(data, 0), heap, out, what)
            elif mtype == _LINK_INFO:
                pos = 2 + (8 if data[1] & 1 else 0)
                if self._offset(data, pos) != self.undef:
                    raise NotImplementedError(
                        f"dense link storage (a fractal heap) in group {what} of {self.path}: "
                        f"write the file with libver='earliest' or with at most 8 links per "
                        f"group")
            elif mtype == _LINK:
                name, target = self._link(data, what)
                out[name] = target
        self._members_cache[addr] = out
        return out

    def _link(self, data: bytes, what: str) -> Tuple[str, int]:
        flags = data[1]
        pos = 2
        kind = 0
        if flags & 0x08:
            kind = data[pos]
            pos += 1
        pos += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        n = self._uint(data, pos, width)
        pos += width
        name = data[pos:pos + n].decode("utf-8")
        if kind != 0:
            raise NotImplementedError(f"{'soft' if kind == 1 else 'external'} link "
                                      f"{name!r} in group {what} of {self.path}")
        return name, self._offset(data, pos + n)

    def _local_heap(self, addr: int, what: str) -> bytes:
        head = self._read(addr, 8 + 2 * self.sl + self.so, f"local heap of group {what}")
        if head[:4] != b"HEAP":
            raise H5FormatError(f"local heap of group {what} in {self.path}: no HEAP signature")
        size = self._length(head, 8)
        return self._read(self._offset(head, 8 + 2 * self.sl), size,
                          f"local heap data of group {what}")

    def _btree_group(self, addr: int, heap: bytes, out: Dict[str, int], what: str) -> None:
        """Walk a v1 B-tree of type 0 down to its symbol table nodes."""
        head = self._read(addr, 8 + 2 * self.so, f"B-tree of group {what}")
        if head[:4] != b"TREE" or head[4] != 0:
            raise H5FormatError(f"B-tree of group {what} in {self.path}: not a group node")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self._read(addr + len(head), (used + 1) * self.sl + used * self.so,
                          f"B-tree of group {what}")
        for i in range(used):
            child = self._offset(body, (i + 1) * self.sl + i * self.so)
            if level > 0:
                self._btree_group(child, heap, out, what)
            else:
                self._symbol_node(child, heap, out, what)

    def _symbol_node(self, addr: int, heap: bytes, out: Dict[str, int], what: str) -> None:
        head = self._read(addr, 8, f"symbol table node of group {what}")
        if head[:4] != b"SNOD":
            raise H5FormatError(f"symbol table node of group {what} in {self.path}: no SNOD "
                                f"signature")
        n = struct.unpack_from("<H", head, 6)[0]
        entry = 2 * self.so + 24
        body = self._read(addr + 8, n * entry, f"symbol table node of group {what}")
        for i in range(n):
            pos = i * entry
            start = self._offset(body, pos)
            name = heap[start:heap.index(b"\0", start)].decode("utf-8")
            cache = struct.unpack_from("<I", body, pos + 2 * self.so)[0]
            if cache == 2:
                raise NotImplementedError(f"soft link {name!r} in group {what} of {self.path}")
            out[name] = self._offset(body, pos + self.so)

    def walk(self) -> Tuple[Dict[str, int], List[str], Dict[int, List]]:
        """Every dataset ``{path: header address}`` in name order, every group
        below the root, and the messages of each object."""
        datasets: Dict[str, int] = {}
        groups: List[str] = []
        objects: Dict[int, List] = {}

        def visit(addr: int, prefix: str) -> None:
            members = self.members(addr, prefix or "/")
            for name in sorted(members):
                child, path = members[name], prefix + name
                if child in objects:
                    continue        # a second hard link to an object already seen
                msgs = objects[child] = self.messages(child, path)
                types = {m[0] for m in msgs}
                if types & {_SYMBOL_TABLE, _LINK_INFO, _LINK}:
                    groups.append(path)
                    visit(child, path + "/")
                elif _LAYOUT in types:
                    datasets[path] = child

        objects[self.root] = self.messages(self.root, "/")
        visit(self.root, "")
        return datasets, groups, objects

    def find(self, name: str) -> int:
        """The header address of the object at the ``/``-separated ``name``."""
        addr, seen = self.root, ""
        for part in name.strip("/").split("/"):
            members = self.members(addr, seen or "/")
            if part not in members:
                raise KeyError(f"no dataset {name!r} in {self.path}")
            addr, seen = members[part], seen + "/" + part
        return addr

    # --------------------------------------------------------- datasets --
    def describe(self, name: str, msgs) -> _Dataset:
        d = _Dataset(name)
        types = {m[0] for m in msgs}
        if _LAYOUT not in types:
            raise KeyError(f"{name!r} in {self.path} is not a dataset")
        fill_old = None
        for mtype, _, data in msgs:
            if mtype == _DATASPACE:
                self._dataspace(d, data)
            elif mtype == _DATATYPE:
                d.dtype, d.is_bool = self._datatype(data, 0, name)
            elif mtype == _FILL:
                d.fill = self._fill(data)
            elif mtype == _FILL_OLD:
                n = struct.unpack_from("<I", data, 0)[0]
                fill_old = data[4:4 + n] if n else None
            elif mtype == _FILTERS:
                d.filters = self._filters(data, name)
            elif mtype == _LAYOUT:
                d.layout = self._layout(data, name)
        if _FILL not in types:
            d.fill = fill_old
        if d.fill is not None and len(d.fill) != d.dtype.itemsize:
            raise H5FormatError(f"fill value of dataset {name!r} in {self.path}: "
                                f"{len(d.fill)} bytes for a {d.dtype.itemsize}-byte type")
        return d

    def _dataspace(self, d: _Dataset, data: bytes) -> None:
        version, rank = data[0], data[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if data[3] == 2:
                raise NotImplementedError(f"null dataspace (an empty dataset) of dataset "
                                          f"{d.name!r} in {self.path}")
            pos = 4
        else:
            raise NotImplementedError(f"dataspace version {version} of dataset {d.name!r} "
                                      f"in {self.path}")
        d.shape = tuple(self._length(data, pos + i * self.sl) for i in range(rank))

    def _datatype(self, data: bytes, pos: int, name: str) -> Tuple[np.dtype, bool]:
        cls, version = data[pos] & 0x0F, data[pos] >> 4
        bits = data[pos + 1] | data[pos + 2] << 8 | data[pos + 3] << 16
        size = struct.unpack_from("<I", data, pos + 4)[0]
        where = f"dataset {name!r} in {self.path}"
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", data, pos + 8)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise NotImplementedError(f"{size}-byte fixed-point type of precision "
                                          f"{precision} at bit {offset} in {where}")
            order = ">" if bits & 1 else "<"
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}"), False
        if cls == 1:
            layout = struct.unpack_from("<HHBBBBI", data, pos + 8)
            if (size not in _IEEE or bits & 0x40 or layout[:2] != (0, 8 * size)
                    or layout[2:] != _IEEE[size] or (bits >> 4) & 3 != 2
                    or (bits >> 8) & 0xFF != 8 * size - 1):
                raise NotImplementedError(f"{size}-byte floating-point type {layout} "
                                          f"(bits {bits:#x}) in {where}")
            return np.dtype(f"{'>' if bits & 1 else '<'}f{size}"), False
        if cls == 8:
            base, _ = self._datatype(data, pos + 8, name)
            base_cls = data[pos + 8] & 0x0F
            if base_cls != 0:
                raise NotImplementedError(f"enumeration over a {_CLASS_NAMES.get(base_cls)} "
                                          f"type in {where}")
            at, names = pos + 8 + 12, []
            for _ in range(bits & 0xFFFF):
                end = data.index(b"\0", at)
                names.append(data[at:end].decode("utf-8"))
                # versions 1 and 2 pad each name to a multiple of 8 bytes
                at = end + 1 + ((at - end - 1) % 8 if version < 3 else 0)
            values = np.frombuffer(data, base, len(names), at).tolist()
            if base.itemsize == 1 and dict(zip(names, values)) == {"FALSE": 0, "TRUE": 1}:
                return base, True
            raise NotImplementedError(f"enumeration type {dict(zip(names, values))} in {where} "
                                      f"(only the FALSE/TRUE bool enum is read)")
        raise NotImplementedError(f"{_CLASS_NAMES.get(cls, f'class {cls}')} datatype in {where}")

    def _fill(self, data: bytes) -> Optional[bytes]:
        version = data[0]
        if version in (1, 2):
            if not data[3]:
                return None
            n = struct.unpack_from("<i", data, 4)[0]
            return data[8:8 + n] if n > 0 else None
        if version == 3:
            if not data[1] & 0x20:
                return None
            n = struct.unpack_from("<I", data, 2)[0]
            return data[6:6 + n] if n else None
        raise NotImplementedError(f"fill value message version {version} in {self.path}")

    def _filters(self, data: bytes, name: str) -> List[Tuple[int, Tuple[int, ...]]]:
        version, count = data[0], data[1]
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(count):
            fid = struct.unpack_from("<H", data, pos)[0]
            if version == 1 or fid >= 256:
                name_len, flags, nvals = struct.unpack_from("<HHH", data, pos + 2)
                pos += 8
            else:
                name_len, (flags, nvals) = 0, struct.unpack_from("<HH", data, pos + 2)
                pos += 6
            pos += (-(-name_len // 8) * 8) if version == 1 else name_len
            values = struct.unpack_from(f"<{nvals}I", data, pos)
            pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2, 3):
                raise NotImplementedError(
                    f"filter {fid} ({_FILTER_NAMES.get(fid, 'unregistered')}) on dataset "
                    f"{name!r} in {self.path}: only deflate, shuffle and fletcher32 are read")
            out.append((fid, values))
        return out

    def _layout(self, data: bytes, name: str) -> Tuple:
        version, cls = data[0], data[1]
        where = f"dataset {name!r} in {self.path}"
        if version not in (3, 4):
            raise NotImplementedError(f"data layout message version {version} of {where}")
        if cls == 0:
            n = struct.unpack_from("<H", data, 2)[0]
            return ("compact", data[4:4 + n])
        if cls == 1:
            return ("contiguous", self._offset(data, 2), self._length(data, 2 + self.so))
        if cls != 2:
            raise NotImplementedError(f"{'virtual' if cls == 3 else cls} layout of {where}")
        if version == 3:
            rank1 = data[2]
            addr = self._offset(data, 3)
            dims = struct.unpack_from(f"<{rank1}I", data, 3 + self.so)
            return ("btree1", dims[:-1], addr, 0)
        flags, rank1, width = data[2], data[3], data[4]
        dims = tuple(self._uint(data, 5 + i * width, width) for i in range(rank1))
        pos = 5 + rank1 * width
        index = data[pos]
        pos += 1
        if index == 1:
            filtered = None
            if flags & 0x02:
                filtered = (self._length(data, pos),
                            struct.unpack_from("<I", data, pos + self.sl)[0])
                pos += self.sl + 4
            return ("single", dims[:-1], self._offset(data, pos), flags, filtered)
        if index == 2:
            return ("implicit", dims[:-1], self._offset(data, pos), flags)
        if index == 3:
            return ("farray", dims[:-1], self._offset(data, pos + 1), flags)
        raise NotImplementedError(
            f"{_INDEX_NAMES.get(index, f'index type {index}')} chunk index of {where} (a "
            f"dataset made with maxshape None): only the v1 B-tree, single-chunk, implicit "
            f"and fixed-array indexes are read")

    # ------------------------------------------------------------ data --
    def read(self, d: _Dataset) -> np.ndarray:
        n = int(np.prod(d.shape, dtype=np.int64))
        kind = d.layout[0]
        if kind == "compact":
            raw = d.layout[1]
            if len(raw) != n * d.dtype.itemsize:
                raise H5FormatError(f"compact dataset {d.name!r} in {self.path}: {len(raw)} "
                                    f"bytes for {n} elements")
            arr = np.frombuffer(raw, d.dtype, n).reshape(d.shape).copy()   # writable, as h5py's
        elif kind == "contiguous":
            _, addr, size = d.layout
            if addr == self.undef or n == 0:
                arr = self._filled(d, d.shape)
            else:
                if size < n * d.dtype.itemsize:
                    raise H5FormatError(f"contiguous dataset {d.name!r} in {self.path}: "
                                        f"{size} bytes for {n} elements")
                arr = np.empty(n, d.dtype)
                at = self.base + addr
                self._f.seek(at)
                if at + arr.nbytes > self._size or self._f.readinto(arr) != arr.nbytes:
                    raise H5FormatError(f"dataset {d.name!r} runs past the end of {self.path}")
                arr = arr.reshape(d.shape)
        else:
            arr = self._chunked(d)
        if d.is_bool:
            return arr != 0
        return arr.astype(d.dtype.newbyteorder("="), copy=False)

    def _filled(self, d: _Dataset, shape) -> np.ndarray:
        if d.fill is None:
            return np.zeros(shape, d.dtype)
        return np.full(shape, np.frombuffer(d.fill, d.dtype, 1)[0], d.dtype)

    def _chunked(self, d: _Dataset) -> np.ndarray:
        chunk = tuple(int(c) for c in d.layout[1])
        if len(chunk) != len(d.shape) or 0 in chunk:
            raise H5FormatError(f"dataset {d.name!r} in {self.path}: chunk {chunk} for shape "
                                f"{d.shape}")
        out = self._filled(d, d.shape)
        if out.size == 0:
            return out
        grid = tuple(-(-s // c) for s, c in zip(d.shape, chunk))
        nbytes = int(np.prod(chunk)) * d.dtype.itemsize
        kind = d.layout[0]
        if kind == "btree1":
            chunks = []
            if d.layout[2] != self.undef:
                self._btree_chunks(d.layout[2], len(chunk), chunks, d.name)
        elif kind == "single":
            filtered = d.layout[4]
            size, mask = filtered if filtered else (nbytes, 0)
            chunks = [((0,) * len(chunk), d.layout[2], size, mask)]
            if d.layout[2] == self.undef:
                chunks = []
        elif kind == "implicit":
            if d.filters:
                raise H5FormatError(f"implicit chunk index with filters on {d.name!r} in "
                                    f"{self.path}")
            chunks = []
            if d.layout[2] != self.undef:
                for i, idx in enumerate(np.ndindex(*grid)):
                    chunks.append((tuple(k * c for k, c in zip(idx, chunk)),
                                   d.layout[2] + i * nbytes, nbytes, 0))
        else:
            chunks = self._farray_chunks(d, grid, chunk, nbytes)
        partial_raw = kind != "btree1" and d.layout[3] & 0x01
        for offsets, addr, size, mask in chunks:
            if len(offsets) != len(chunk) or any(
                    o % c or o >= s for o, c, s in zip(offsets, chunk, d.shape)):
                raise H5FormatError(f"chunk at {offsets} of {d.name!r} in {self.path} lies "
                                    f"outside the dataset {d.shape} (chunk {chunk})")
            raw = self._read(addr, size, f"chunk {offsets} of dataset {d.name!r}")
            edge = any(o + c > s for o, c, s in zip(offsets, chunk, d.shape))
            if not (partial_raw and edge):
                raw = self._unfilter(raw, d, mask, offsets)
            if len(raw) != nbytes:
                raise H5FormatError(f"chunk {offsets} of {d.name!r} in {self.path}: {len(raw)} "
                                    f"bytes after the filters, want {nbytes}")
            block = np.frombuffer(raw, d.dtype).reshape(chunk)
            sl = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, d.shape))
            out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
        return out

    def _btree_chunks(self, addr: int, rank: int, out: List, name: str) -> None:
        """Walk a v1 B-tree of type 1: (offsets, address, size, filter mask)."""
        head = self._read(addr, 8 + 2 * self.so, f"chunk B-tree of dataset {name!r}")
        if head[:4] != b"TREE" or head[4] != 1:
            raise H5FormatError(f"chunk B-tree of dataset {name!r} in {self.path}: not a "
                                f"raw-data node")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        key = 8 + 8 * (rank + 1)
        body = self._read(addr + len(head), (used + 1) * key + used * self.so,
                          f"chunk B-tree of dataset {name!r}")
        for i in range(used):
            pos = i * (key + self.so)
            size, mask = struct.unpack_from("<II", body, pos)
            offsets = struct.unpack_from(f"<{rank}Q", body, pos + 8)
            child = self._offset(body, pos + key)
            if level > 0:
                self._btree_chunks(child, rank, out, name)
            else:
                out.append((tuple(offsets), child, size, mask))

    def _farray_chunks(self, d: _Dataset, grid, chunk, nbytes) -> List:
        what = f"fixed-array chunk index of dataset {d.name!r}"
        if d.layout[2] == self.undef:
            return []
        head = self._read(d.layout[2], 12 + self.sl + self.so, what)
        if head[:4] != b"FAHD":
            raise H5FormatError(f"{what} in {self.path}: no FAHD signature")
        self._checked(head, what)
        client, entry, page_bits = head[5], head[6], head[7]
        count = self._length(head, 8)
        block_addr = self._offset(head, 8 + self.sl)
        if count != int(np.prod(grid)):
            raise H5FormatError(f"{what} in {self.path}: {count} entries for {grid} chunks")
        filtered = client == 1
        page = 1 << page_bits
        prefix = 6 + self.so
        entries = []
        if count <= page:
            buf = self._read(block_addr, prefix + count * entry + 4, what)
            if buf[:4] != b"FADB":
                raise H5FormatError(f"{what} in {self.path}: no FADB signature")
            self._checked(buf, what)
            raw = [buf[prefix + i * entry:prefix + (i + 1) * entry] for i in range(count)]
        else:
            pages = -(-count // page)
            bitmap_len = -(-pages // 8)
            buf = self._read(block_addr, prefix + bitmap_len + 4, what)
            if buf[:4] != b"FADB":
                raise H5FormatError(f"{what} in {self.path}: no FADB signature")
            self._checked(buf, what)
            bitmap = buf[prefix:prefix + bitmap_len]
            at = block_addr + len(buf)
            raw = []
            for p in range(pages):
                n = min(page, count - p * page)
                if bitmap[p // 8] & (0x80 >> (p % 8)):
                    pbuf = self._read(at, n * entry + 4, what)
                    self._checked(pbuf, what)
                    raw += [pbuf[i * entry:(i + 1) * entry] for i in range(n)]
                else:
                    raw += [None] * n
                at += page * entry + 4
        for idx, e in zip(np.ndindex(*grid), raw):
            if e is None:
                continue
            addr = self._offset(e, 0)
            if addr == self.undef:
                continue
            if filtered:
                size = self._uint(e, self.so, entry - self.so - 4)
                mask = struct.unpack_from("<I", e, entry - 4)[0]
            else:
                size, mask = nbytes, 0
            entries.append((tuple(k * c for k, c in zip(idx, chunk)), addr, size, mask))
        return entries

    def _unfilter(self, raw: bytes, d: _Dataset, mask: int, offsets) -> bytes:
        for i in reversed(range(len(d.filters))):
            if mask >> i & 1:
                continue
            fid, values = d.filters[i]
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                size = values[0] if values else d.dtype.itemsize
                n = len(raw) // size
                body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T.tobytes()
                raw = body + raw[n * size:]
            else:
                if len(raw) < 4:
                    raise H5FormatError(f"chunk {offsets} of {d.name!r} in {self.path}: no "
                                        f"Fletcher-32 checksum")
                stored = struct.unpack_from("<I", raw, len(raw) - 4)[0]
                raw = raw[:-4]
                want = fletcher32(raw)
                swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
                if stored not in (want, swapped):
                    raise H5FormatError(f"Fletcher-32 checksum mismatch in chunk {offsets} of "
                                        f"dataset {d.name!r} in {self.path}")
        return raw


def dataset_names(path: PathLike) -> List[str]:
    """Every dataset of the file, as ``/``-separated paths in name order."""
    with _File(path) as f:
        return list(f.walk()[0])


def read_datasets(path: PathLike, names: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """``{name: array}`` of the named datasets (every dataset by default);
    each equals ``np.asarray(h5py.File(path)[name][()])`` with its byte
    order made native.  Only the named datasets are read."""
    with _File(path) as f:
        if names is None:
            datasets, _, objects = f.walk()
            return {n: f.read(f.describe(n, objects[a])) for n, a in datasets.items()}
        out = {}
        for name in names:
            addr = f.find(name)
            out[name] = f.read(f.describe(name, f.messages(addr, name)))
        return out


# ---------------------------------------------------------------- writer --
_UNDEF = 0xFFFFFFFFFFFFFFFF
_GROUP_INTERNAL_K = 16        # the superblock's default: 32 children per B-tree node
_ENTRY = 40                   # a symbol table entry with 8-byte offsets


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, data: bytes) -> bytes:
    """A v1 object header message: its data padded to 8 bytes."""
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _encode_datatype(dtype: np.dtype, name: str) -> bytes:
    """The datatype message of a little-endian ``dtype`` as HDF5 1.8 writes
    it (version 1); bool as h5py's enum over int8."""
    if dtype.kind == "b":
        base = _encode_datatype(np.dtype("i1"), name)
        members = _pad8(b"FALSE\0") + _pad8(b"TRUE\0")
        return struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + members + b"\x00\x01"
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in _IEEE:
        return (struct.pack("<BBBBIHH", 0x11, 0x20, 8 * size - 1, 0, size, 0, 8 * size)
                + struct.pack("<BBBBI", *_IEEE[size]))
    raise NotImplementedError(f"dataset {name!r}: dtype {dtype} is not written (integers of 1, "
                              f"2, 4 and 8 bytes, floats of 2, 4 and 8 bytes, bool)")


def _dataset_header(arr: np.ndarray, name: str, data_addr: int) -> bytes:
    """The v1 object header of a contiguous dataset whose data lies at
    ``data_addr`` (undefined when it has no elements)."""
    rank = arr.ndim
    dims = struct.pack(f"<{rank}Q", *arr.shape)
    space = struct.pack("<BBBB4x", 1, rank, 1 if rank else 0, 0) + dims + (dims if rank else b"")
    # fill value v2: allocated late, written if set, the library's default (0)
    fill = struct.pack("<BBBBi", 2, 2, 2, 1, 0)
    layout = struct.pack("<BBQQ", 3, 1, data_addr if arr.nbytes else _UNDEF, arr.nbytes)
    body = (_message(_DATASPACE, space) + _message(_DATATYPE, _encode_datatype(arr.dtype, name))
            + _message(_FILL, fill) + _message(_LAYOUT, layout))
    return struct.pack("<BBHII4x", 1, 0, 4, 1, len(body)) + body


def _little_endian(name: str, value) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype.kind not in "biuf":
        _encode_datatype(arr.dtype, name)       # raises, naming the dtype
    # (np.asarray keeps a 0-d array 0-d, where ascontiguousarray makes it 1-d)
    return np.asarray(arr, arr.dtype.newbyteorder("<"), order="C")


def write_datasets(path: PathLike, items: Union[Mapping[str, object],
                                                Iterable[Tuple[str, object]]]) -> None:
    """Write a new HDF5 file holding ``items`` (name -> array) as datasets of
    its root group, as h5py writes them by default: superblock v0, a
    symbol-table root group, v1 object headers, contiguous little-endian
    data.  Names are single path components."""
    pairs = list(items.items()) if isinstance(items, Mapping) else list(items)
    arrays: Dict[str, np.ndarray] = {}
    for name, value in pairs:
        if not isinstance(name, str) or not name or "/" in name or "\0" in name or name == ".":
            raise ValueError(f"dataset name {name!r}: one non-empty path component")
        if name in arrays:
            raise ValueError(f"dataset {name!r} given twice")
        arrays[name] = _little_endian(name, value)
    # HDF5 looks names up by binary search: the node's entries and the
    # B-tree's keys go in byte order (UTF-8 keeps code point order)
    names = sorted(arrays)
    n = len(names)
    # one symbol table node holds 2 * leaf K entries: size K to the group
    leaf_k = max(4, -(-n // 2))

    heap = bytearray(8)                          # offset 0: the empty name
    name_at = {}
    for name in names:
        name_at[name] = len(heap)
        heap += _pad8(name.encode("utf-8") + b"\0")
    root_at = 96
    root_size = 16 + 8 + 16
    btree_at = root_at + root_size
    btree_size = 24 + (2 * _GROUP_INTERNAL_K + 1) * 8 + 2 * _GROUP_INTERNAL_K * 8
    heap_at = btree_at + btree_size
    heap_data_at = heap_at + 32
    snod_at = heap_data_at + len(heap)
    snod_size = 8 + 2 * leaf_k * _ENTRY
    at = snod_at + (snod_size if n else 0)
    headers, header_at = {}, {}
    for name in names:
        arr = arrays[name]
        header_at[name] = at
        data_at = at + len(_dataset_header(arr, name, 0))
        headers[name] = _dataset_header(arr, name, data_at)
        at = data_at + arr.nbytes
        at += -at % 8
    eof = at

    superblock = (SIGNATURE + struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0)
                  + struct.pack("<HHI", leaf_k, _GROUP_INTERNAL_K, 0)
                  + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
                  # root symbol table entry: cached B-tree and heap addresses
                  + struct.pack("<QQIIQQ", 0, root_at, 1, 0, btree_at, heap_at))
    root = (struct.pack("<BBHII4x", 1, 0, 1, 1, 24)
            + _message(_SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_at)))
    # B-tree leaf: key 0 the empty name, key 1 the last name, one child
    btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if n else 0, _UNDEF, _UNDEF)
    btree += struct.pack("<Q", 0)
    if n:
        btree += struct.pack("<QQ", snod_at, name_at[names[-1]])
    btree += b"\0" * (btree_size - len(btree))
    # local heap: no free block (HDF5 ends its free list with offset 1)
    local_heap = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data_at)
    snod = b""
    if n:
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, n)
        for name in names:
            snod += struct.pack("<QQII16x", name_at[name], header_at[name], 0, 0)
        snod += b"\0" * (snod_size - len(snod))

    with open(path, "wb") as f:
        for part in (superblock, root, btree, local_heap, bytes(heap), snod):
            f.write(part)
        for name in names:
            f.write(headers[name])
            f.write(arrays[name].tobytes())
            f.write(b"\0" * (-f.tell() % 8))
        if f.tell() != eof:
            raise RuntimeError(f"{path}: wrote {f.tell()} bytes, the superblock says {eof}")


def update_datasets(path: PathLike, items: Union[Mapping[str, object],
                                                 Iterable[Tuple[str, object]]],
                    drop_attributes: bool = False) -> None:
    """``h5py.File(path, "r+")`` then ``del f[k]; f.create_dataset(k, data=v)``
    for each item: every dataset of the file is read, the given ones
    replaced or added, and the result written (``write_datasets``) to a
    temporary file beside the old one, which then replaces it, so a crash
    never leaves a half-written file.

    Raises on a file with groups below the root.  Attributes are not
    carried over: a file with any raises unless ``drop_attributes``.  The
    A2D annotation files, written by MATLAB ``-v7.3``, carry
    ``MATLAB_class`` attributes that no reader of this system reads; the
    generator drops them.  A user block before the superblock (MATLAB's
    512-byte header) is not carried over either."""
    path = os.fspath(path)
    with _File(path) as f:
        datasets, groups, objects = f.walk()
        if groups:
            raise NotImplementedError(f"update_datasets: {path} has groups below the root "
                                      f"({groups[:5]}); only flat files are rewritten")
        holders = []
        for name, addr in (("/", f.root), *datasets.items()):
            for mtype, _, data in objects[addr]:
                dense = mtype == _ATTRIBUTE_INFO and f._offset(
                    data, 2 + (2 if data[1] & 1 else 0)) != f.undef
                if mtype == _ATTRIBUTE or dense:
                    holders.append(name)
                    break
        if holders and not drop_attributes:
            raise ValueError(f"update_datasets: {path} has attributes on {holders}, which the "
                             f"rewrite would drop; pass drop_attributes=True to drop them")
        data = {name: f.read(f.describe(name, objects[addr])) for name, addr in datasets.items()}
    pairs = list(items.items()) if isinstance(items, Mapping) else list(items)
    data.update(pairs)
    fd, tmp = tempfile.mkstemp(prefix=".", suffix=".h5.tmp", dir=os.path.dirname(path) or ".")
    os.close(fd)
    try:
        write_datasets(tmp, data)
        with open(tmp, "rb+") as fh:       # on disk before it takes the old file's name
            os.fsync(fh.fileno())
        os.chmod(tmp, stat.S_IMODE(os.stat(path).st_mode))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
