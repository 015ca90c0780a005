"""The port's HDF5 reader and writer (``ocpg_tpu_torch/data/h5.py``) on the
CPU, with h5py as the oracle.

* Read side: files written by h5py over a matrix of options (libver
  earliest and latest; contiguous, compact and chunked storage, deflate at
  levels 1 and 9, shuffle, Fletcher-32; a 512-byte user block; both byte
  orders of every integer and float width, bool, scalar and zero-size
  datasets, a chunk never written under a fill value; nested groups; 40
  and 600 datasets in one group, which take several symbol table nodes
  and a B-tree of two levels under earliest; the single-chunk, implicit
  and fixed-array chunk indexes of latest, a paged fixed array among
  them): ``read_datasets`` equals h5py on each file, dtype and shape
  included.
* Write side: h5py and the port read every ``write_datasets`` file back
  equal (a hypothesis test draws the dtypes, shapes and names);
  ``update_datasets`` keeps the old datasets bit-identical, replaces and
  adds the given ones, and refuses attributes and nested groups unless
  told.
* Refusals: dense link storage, maxshape None under latest, strings, a
  null dataspace, the lzf and szip filters, and a Fletcher-32 chunk with
  one flipped byte each raise, naming what they met.
"""
import os
import string

import h5py
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from ocpg_tpu_torch.data import h5

INTS = [f"{o}{k}{n}" for o in "<>" for k in "iu" for n in (1, 2, 4, 8)]
FLOATS = [f"{o}f{n}" for o in "<>" for n in (2, 4, 8)]


def h5py_read(path):
    """``{name: np.asarray(f[name][()])}`` of every dataset, by h5py."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj[()]))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def assert_same(got, want):
    assert list(got) == sorted(want), (list(got), sorted(want))
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype.newbyteorder("="), (name, g.dtype, w.dtype)
        assert g.dtype.isnative and g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


def values(dtype, shape, rng):
    dtype = np.dtype(dtype)
    if dtype.kind == "b":
        return rng.random(shape) > 0.5
    if dtype.kind == "f":
        return (rng.standard_normal(shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype.newbyteorder("="),
                        endpoint=True).astype(dtype)


def compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


STORAGE = {
    "contiguous": {},
    "compact": None,          # a dcpl, made per dataset
    "chunked": {"chunks": True},
    "gzip1": {"chunks": True, "compression": "gzip", "compression_opts": 1},
    "gzip9": {"chunks": True, "compression": "gzip", "compression_opts": 9},
    "shuffle": {"chunks": True, "shuffle": True},
    "fletcher32": {"chunks": True, "fletcher32": True},
    "gzip_shuffle_fletcher32": {"compression": "gzip", "shuffle": True, "fletcher32": True},
}


def write_matrix_file(path, libver, storage, userblock=0, seed=0):
    """Every dtype at several shapes under one storage option, 8 datasets
    to a group (more links make a dense group under latest)."""
    rng = np.random.default_rng(seed)
    kw = {"userblock_size": userblock} if userblock else {}
    with h5py.File(path, "w", libver=libver, **kw) as f:
        for i, dtype in enumerate(INTS + FLOATS + ["bool"]):
            shape = [(7, 5), (3, 4, 6), (33,)][i % 3]
            data = values(dtype, shape, rng)
            name = f"g{i // 8}/d{i:02d}"
            if storage == "compact":
                f.create_dataset(name, data=data, dcpl=compact_dcpl())
            elif storage == "contiguous":
                f.create_dataset(name, data=data)
            else:
                opts = dict(STORAGE[storage])
                if opts.get("chunks") is True:
                    opts["chunks"] = tuple(max(1, s // 2) for s in shape)
                elif "chunks" not in opts:
                    opts["chunks"] = tuple(max(1, s // 3) for s in shape)
                f.create_dataset(name, data=data, **opts)
        f.create_dataset("scalar_f8", data=np.float64(2.5))
        f.create_dataset("scalar_i2", data=np.array(-7, ">i2"))
        f.create_dataset("empty", data=np.zeros((0, 3), np.float32))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("storage", list(STORAGE))
def test_read_matches_h5py(tmp_path, libver, storage):
    path = tmp_path / "m.h5"
    write_matrix_file(path, libver, storage)
    assert_same(h5.read_datasets(path), h5py_read(path))
    assert h5.dataset_names(path) == sorted(h5py_read(path))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_user_block(tmp_path, libver):
    path = tmp_path / "u.h5"
    write_matrix_file(path, libver, "gzip1", userblock=512, seed=1)
    with open(path, "r+b") as f:        # MATLAB writes its text header there
        f.write(b"MATLAB 7.3 MAT-file, Platform: GLNXA64".ljust(128, b" "))
    assert_same(h5.read_datasets(path), h5py_read(path))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_unwritten_chunks_read_as_the_fill_value(tmp_path, libver):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver=libver) as f:
        d = f.create_dataset("filled", shape=(9, 7), chunks=(4, 3), dtype=">f4", fillvalue=3.5)
        d[0:4, 0:3] = np.arange(12, dtype=np.float32).reshape(4, 3)
        d[8, 6] = -1
        d = f.create_dataset("zero_fill", shape=(5, 5), chunks=(2, 2), dtype="i2",
                             compression="gzip")
        d[4, 4] = 9
        f.create_dataset("never_written", shape=(3, 4), dtype="u1", fillvalue=200)
        f.create_dataset("never_written_chunked", shape=(6,), chunks=(2,), dtype="<f8",
                         fillvalue=-2.0)
    want = h5py_read(path)
    assert (want["filled"] == 3.5).sum() > 0 and (want["never_written"] == 200).all()
    assert_same(h5.read_datasets(path), want)


def test_nested_groups_and_named_reads(tmp_path):
    path = tmp_path / "n.h5"
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        f.create_dataset("top", data=rng.random(4))
        g = f.create_group("a/b")
        g.create_dataset("deep", data=np.arange(6, dtype=">u4").reshape(2, 3))
        g.create_dataset("deep_bool", data=np.array([True, False]))
        f["a"].create_dataset("mid", data=np.float32(1.25))
    want = h5py_read(path)
    assert h5.dataset_names(path) == ["a/b/deep", "a/b/deep_bool", "a/mid", "top"]
    assert_same(h5.read_datasets(path), want)
    got = h5.read_datasets(path, ["a/b/deep", "/a/mid"])
    assert list(got) == ["a/b/deep", "/a/mid"]
    np.testing.assert_array_equal(got["a/b/deep"], want["a/b/deep"])
    assert got["/a/mid"].shape == () and got["/a/mid"] == np.float32(1.25)
    with pytest.raises(KeyError, match="nope"):
        h5.read_datasets(path, ["a/nope"])


@pytest.mark.parametrize("count", [40, 600])
def test_many_datasets_in_one_group(tmp_path, count):
    """Under earliest, 40 names take several SNOD nodes and 600 a B-tree of
    two levels; under latest at most 8 links stay compact."""
    path = tmp_path / "many.h5"
    with h5py.File(path, "w", libver="earliest") as f:
        for i in range(count):
            f.create_dataset(f"x{(i * 7919) % count:04d}", data=np.array([i, -i], np.int32))
    with h5._File(path) as f:
        addr = f.messages(f.root, "/")[0][2]
        head = f._read(f._offset(addr, 0), 8, "root B-tree")
    assert head[5] == (1 if count == 600 else 0)       # the B-tree's level
    assert_same(h5.read_datasets(path), h5py_read(path))
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        for i in range(8):
            f.create_dataset(f"y{i}", data=np.full(3, i, np.uint8))
    assert_same(h5.read_datasets(latest), h5py_read(latest))


def test_v4_chunk_indexes(tmp_path):
    """libver latest: the single-chunk (filtered or not), implicit and
    fixed-array indexes, paged past 1024 chunks."""
    path = tmp_path / "idx.h5"
    rng = np.random.default_rng(3)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("single", data=rng.random((4, 5)), chunks=(4, 5))
        f.create_dataset("single_gzip", data=rng.random((4, 5)), chunks=(4, 5),
                         compression="gzip", fletcher32=True)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((3, 2))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        d = f.create_dataset("implicit", shape=(7, 5), dtype="<i4", dcpl=dcpl)
        d[...] = np.arange(35).reshape(7, 5)
        f.create_dataset("farray", data=rng.integers(0, 9, (10, 9)), chunks=(3, 4))
        f.create_dataset("farray_gzip", data=rng.random((10, 9)).astype(np.float32),
                         chunks=(3, 4), compression="gzip", shuffle=True)
        d = f.create_dataset("farray_paged", shape=(2100,), chunks=(1,), dtype="i2",
                             fillvalue=-5)
        d[:1000] = np.arange(1000)
        d[2050:] = 7
        d = f.create_dataset("farray_paged_gzip", shape=(1500, 2), chunks=(1, 2), dtype="f4",
                             compression="gzip")
        d[3:1400] = 1.5
    with h5._File(path) as f:
        kinds = {name: f.describe(name, f.messages(f.find(name), name)).layout[0]
                 for name in ("single", "single_gzip", "implicit", "farray", "farray_paged")}
    assert kinds == {"single": "single", "single_gzip": "single", "implicit": "implicit",
                     "farray": "farray", "farray_paged": "farray"}
    assert_same(h5.read_datasets(path), h5py_read(path))


def test_earliest_unlimited_maxshape_reads(tmp_path):
    """maxshape None under earliest is a v1 B-tree, which is read."""
    path = tmp_path / "grow.h5"
    with h5py.File(path, "w", libver="earliest") as f:
        d = f.create_dataset("grow", shape=(3, 4), maxshape=(None, 4), chunks=(2, 4), dtype="f4")
        d[...] = 1.0
        d.resize((7, 4))
        d[5:] = 2.0
    assert_same(h5.read_datasets(path), h5py_read(path))


# ---------------------------------------------------------------- refusals --
def test_dense_links_raise(tmp_path):
    path = tmp_path / "dense.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(9):
            f.create_dataset(f"d{i}", data=np.arange(3))
    with pytest.raises(NotImplementedError, match="dense link storage.*dense.h5"):
        h5.read_datasets(path)
    with pytest.raises(NotImplementedError, match="dense link storage"):
        h5.read_datasets(path, ["d1"])


@pytest.mark.parametrize("maxshape,index", [((None, 4), "extensible array"),
                                            ((None, None), "version 2 B-tree")])
def test_unlimited_maxshape_under_latest_raises(tmp_path, maxshape, index):
    path = tmp_path / "unl.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("grow", data=np.ones((3, 4)), maxshape=maxshape, chunks=(2, 2))
    with pytest.raises(NotImplementedError, match=f"{index} chunk index of dataset 'grow'"):
        h5.read_datasets(path)


def test_unsupported_types_raise(tmp_path):
    path = tmp_path / "types.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("ok", data=np.arange(3))
        f.create_dataset("text", data="a string")
        f.create_dataset("fixed_text", data=np.array([b"ab", b"cd"]))
        f.create_dataset("pairs", data=np.zeros(2, [("a", "<i4"), ("b", "<f8")]))
        f.create_dataset("nothing", data=h5py.Empty("f4"))
        f.create_dataset("c64", data=np.ones(2, np.complex64))
    np.testing.assert_array_equal(h5.read_datasets(path, ["ok"])["ok"], np.arange(3))
    for name, what in (("text", "variable-length datatype in dataset 'text'"),
                       ("fixed_text", "string datatype in dataset 'fixed_text'"),
                       ("pairs", "compound datatype in dataset 'pairs'"),
                       ("nothing", "null dataspace"),
                       ("c64", "compound datatype in dataset 'c64'")):
        with pytest.raises(NotImplementedError, match=what):
            h5.read_datasets(path, [name])
    with pytest.raises(NotImplementedError):
        h5.read_datasets(path)


@pytest.mark.parametrize("name", ["lzf", "szip"])
def test_other_filters_raise(tmp_path, name):
    path = tmp_path / "filt.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(64, dtype=np.int32), chunks=(16,),
                         compression=name)
    fid = {"lzf": 32000, "szip": 4}[name]
    with pytest.raises(NotImplementedError, match=f"filter {fid} \\({name}\\) on dataset 'x'"):
        h5.read_datasets(path)


def test_fletcher32_flip_raises(tmp_path):
    path = tmp_path / "flip.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=np.arange(200, dtype=np.float32), chunks=(50,),
                             fletcher32=True)
        info = d.id.get_chunk_info(2)
    np.testing.assert_array_equal(h5.read_datasets(path)["x"], np.arange(200, dtype=np.float32))
    with open(path, "r+b") as f:
        f.seek(info.byte_offset + 17)
        b = f.read(1)
        f.seek(info.byte_offset + 17)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(h5.H5FormatError, match="Fletcher-32 checksum mismatch in chunk "
                                               "\\(100,\\) of dataset 'x'"):
        h5.read_datasets(path)


def test_checksums_against_known_values():
    # lookup3 hashlittle test vectors (from lookup3.c's self-test); Fletcher-32 by
    # its definition on a short odd-length buffer
    assert h5.lookup3(b"") == 0xDEADBEEF
    assert h5.lookup3(b"Four score and seven years ago") == 0x17770551
    data = bytes(range(1, 12))
    s1 = s2 = 0
    words = [data[i] << 8 | data[i + 1] for i in range(0, 10, 2)] + [data[10] << 8]
    for w in words:
        s1 = (s1 + w) % 65535
        s2 = (s2 + s1) % 65535
    assert h5.fletcher32(data) == (s2 << 16 | s1)


# ------------------------------------------------------------------- write --
def test_write_reads_back_through_h5py_and_the_port(tmp_path):
    rng = np.random.default_rng(4)
    items = {f"a_{d.replace('<', 'le').replace('>', 'be')}": values(d, (3, 5), rng)
             for d in INTS + FLOATS}
    items.update(flag=np.array([[True, False, True]]), scalar=np.float32(-0.5),
                 scalar_bool=np.bool_(True), empty=np.zeros((2, 0), ">i8"),
                 heatPoint=rng.random((2, 72, 128)).astype(np.float32),
                 obj_ids=np.asarray([1, 3]), ZZ=np.int8(3), aa=[1.0, 2.0])
    path = tmp_path / "w.h5"
    h5.write_datasets(path, items)
    want = {k: np.asarray(v) for k, v in items.items()}
    assert_same(h5py_read(path), want)
    assert_same(h5.read_datasets(path), want)
    with h5py.File(path, "r") as f:
        assert os.path.getsize(path) == f.id.get_filesize()


def test_write_many_names_in_one_node(tmp_path):
    """More names than one default symbol table node (8) holds: h5py finds
    every one by its binary search."""
    names = [f"k{i}" for i in range(50)] + ["B", "a", "é", "Z9", "_"]
    items = {n: np.array([i], np.int16) for i, n in enumerate(names)}
    path = tmp_path / "many.h5"
    h5.write_datasets(path, items)
    with h5py.File(path, "r") as f:
        for i, n in enumerate(names):
            assert f[n][0] == i, n
        assert sorted(f) == sorted(names)
    assert_same(h5.read_datasets(path), {n: np.asarray(v) for n, v in items.items()})


def test_write_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(NotImplementedError, match="'c'.*complex"):
        h5.write_datasets(tmp_path / "x.h5", {"c": np.ones(2, np.complex64)})
    with pytest.raises(ValueError, match="one non-empty path component"):
        h5.write_datasets(tmp_path / "x.h5", {"a/b": np.ones(2)})
    with pytest.raises(ValueError, match="given twice"):
        h5.write_datasets(tmp_path / "x.h5", [("a", 1), ("a", 2)])


NAME = st.text(string.ascii_letters + string.digits + "_-. ", min_size=1, max_size=12).filter(
    lambda s: s != ".")


@settings(max_examples=40, deadline=None)
@given(st.dictionaries(
    NAME, st.tuples(st.sampled_from(INTS + FLOATS + ["bool"]),
                    st.lists(st.integers(0, 5), min_size=0, max_size=3),
                    st.integers(0, 2 ** 31)),
    min_size=0, max_size=12))
def test_write_round_trip_hypothesis(tmp_path_factory, spec):
    items = {name: values(dtype, tuple(shape), np.random.default_rng(seed))
             for name, (dtype, shape, seed) in spec.items()}
    path = tmp_path_factory.mktemp("rt") / "rt.h5"
    h5.write_datasets(path, items)
    assert_same(h5py_read(path), items)
    assert_same(h5.read_datasets(path), items)


def test_update_keeps_the_rest_bit_identical(tmp_path):
    path = tmp_path / "00004.h5"
    mask = np.zeros((40, 30), np.uint8)
    mask[5:20, 3:9] = 1
    with h5py.File(path, "w") as f:                # as the A2D annotation files hold them
        f.create_dataset("instance", data=np.asarray([2.0]))
        f.create_dataset("reMask", data=mask, chunks=(10, 10), compression="gzip")
        f.create_dataset("heatBBox", data=np.zeros((1, 2)))
    before = h5py_read(path)
    os.chmod(path, 0o640)
    heat = np.random.default_rng(5).random((1, 30, 40)).astype(np.float32)
    h5.update_datasets(path, (("heatBBox", heat), ("heatPoint", heat * 0.5),
                              ("centerPoint", np.array([[3.0, 4.0]], np.float32))))
    after = h5py_read(path)
    assert sorted(after) == ["centerPoint", "heatBBox", "heatPoint", "instance", "reMask"]
    for k in ("instance", "reMask"):
        assert after[k].dtype == before[k].dtype and after[k].tobytes() == before[k].tobytes()
    np.testing.assert_array_equal(after["heatBBox"], heat)
    np.testing.assert_array_equal(after["heatPoint"], heat * 0.5)
    assert_same(h5.read_datasets(path), after)
    assert os.stat(path).st_mode & 0o777 == 0o640
    assert os.listdir(tmp_path) == ["00004.h5"]        # no temporary file left


def test_update_refuses_attributes_and_groups(tmp_path):
    path = tmp_path / "attrs.h5"
    with h5py.File(path, "w", userblock_size=512) as f:
        d = f.create_dataset("reMask", data=np.ones((3, 2), np.uint8))
        d.attrs["MATLAB_class"] = np.bytes_("logical")
    with pytest.raises(ValueError, match="attributes on \\['reMask'\\].*drop_attributes"):
        h5.update_datasets(path, {"x": np.zeros(2)})
    assert sorted(h5py_read(path)) == ["reMask"]
    h5.update_datasets(path, {"x": np.zeros(2)}, drop_attributes=True)
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["reMask", "x"] and not f["reMask"].attrs
        np.testing.assert_array_equal(f["reMask"][()], np.ones((3, 2), np.uint8))
    nested = tmp_path / "nested.h5"
    with h5py.File(nested, "w") as f:
        f.create_group("#refs#").create_dataset("a", data=[1])
    with pytest.raises(NotImplementedError, match="groups below the root.*#refs#"):
        h5.update_datasets(nested, {"x": np.zeros(2)})
    # a write that fails leaves the old file and no temporary one
    with pytest.raises(NotImplementedError, match="complex"):
        h5.update_datasets(path, {"c": np.ones(2, np.complex64)})
    assert sorted(os.listdir(tmp_path)) == ["attrs.h5", "nested.h5"]
