"""Port check: the port's HDF5 subset (``io/hdf5.py``) against h5py.

Files the port writes are read back by h5py: every group, dataset, dtype
(bools as h5py's enum included), shape, attribute (variable-length UTF-8
strings and fixed ``S`` strings) and variable-length ``uint8`` element
equals what was written. Files h5py writes under each setting the reader
lists (``libver`` earliest to latest: superblocks 0-3, version 2 object
headers, compact links, version 4 layouts; chunked datasets with
``maxshape=(None, ...)``, gzip 1-9, shuffle, chunks that do not divide the
shape; continuation blocks) are read by the port equal to what h5py
reads. A hypothesis property test draws compound arrays, string lengths,
empty shapes and 1-30 members a group (several symbol-table leaves). Each
feature outside the subset raises ``NotImplementedError`` naming itself.
"""

import zlib
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sleap_nn_tpu_torch.io import hdf5
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

POINT = np.dtype([("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?"),
                  ("score", "<f8")])
INSTANCE = np.dtype([("instance_id", "<i8"), ("instance_type", "u1"), ("frame_id", "<u8"),
                     ("skeleton", "<u4"), ("track", "<i4"), ("from_predicted", "<i8"),
                     ("score", "<f4"), ("point_id_start", "<u8"), ("point_id_end", "<u8"),
                     ("tracking_score", "<f4")])


def _tree(f, group_type):
    """{path: (kind, dtype, value, attrs)} of every object below ``f``."""
    out = {"/": ("group", None, None, {k: f.attrs[k] for k in f.attrs})}

    def visit(name, obj):
        attrs = {k: obj.attrs[k] for k in obj.attrs}
        if isinstance(obj, group_type):
            out[name] = ("group", None, None, attrs)
        else:
            out[name] = ("dataset", obj.dtype, obj[()], attrs)
    f.visititems(visit)
    return out


def _same(a, b):
    if isinstance(a, np.ndarray) and a.dtype == object:
        return a.shape == b.shape and all(_same(x, y) for x, y in zip(a.ravel(), b.ravel()))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.names:
            return all(_same(a[n], b[n]) for n in a.dtype.names)
        return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (a != a and b != b)
    return a == b


def assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, (kind, dtype, value, attrs) in want.items():
        g_kind, g_dtype, g_value, g_attrs = got[name]
        assert g_kind == kind, name
        assert g_dtype == dtype, (name, g_dtype, dtype)
        if dtype is not None:
            assert (g_dtype.metadata or {}).get("vlen") == (dtype.metadata or {}).get("vlen"), name
        assert _same(g_value, value), name
        assert sorted(g_attrs) == sorted(attrs), name
        for k in attrs:
            assert _same(g_attrs[k], attrs[k]), (name, k, g_attrs[k], attrs[k])


def _port_tree(path):
    with hdf5.File(path, "r") as f:
        return _tree(f, hdf5.Group)


def _h5py_tree(path):
    with h5py.File(path, "r") as f:
        return _tree(f, h5py.Group)


def _vlen(arrays, base=np.uint8):
    out = np.empty(len(arrays), dtype=hdf5.vlen_dtype(base))
    for i, a in enumerate(arrays):
        out[i] = np.asarray(a, base)
    return out


def test_port_file_reads_back_in_h5py(tmp_path):
    """An ``.slp``-shaped file, with every type and layout the writer has."""
    rng = np.random.default_rng(0)
    points = np.zeros(50, POINT)
    points["x"], points["y"] = rng.normal(size=50), rng.normal(size=50)
    points["x"][3] = np.nan
    points["visible"] = rng.random(50) < 0.5
    points["score"] = rng.random(50)
    instances = np.zeros(9, INSTANCE)
    instances["instance_id"] = np.arange(9)
    instances["track"] = -1
    pngs = [rng.integers(0, 256, n, dtype=np.uint8) for n in (10, 5000, 0, 70000, 3)]
    path = tmp_path / "port.h5"
    with hdf5.File(path, "w") as f:
        f.attrs["title"] = "héllo wörld"
        f.create_dataset("points", data=points)
        f.create_dataset("instances", data=instances)
        f.create_dataset("videos_json", data=np.array([b'{"a": 1}', b'{"backend": {}}']))
        f.create_dataset("tracks_json", data=np.zeros(0))
        f.create_dataset("bools", data=rng.random(7) < 0.5)
        for dt in ("<i1", "<u2", "<i4", "<u8", "<f2", "<f4"):
            f.create_dataset(f"n_{dt[1:]}", data=rng.integers(0, 100, (3, 4)).astype(dt))
        f.create_dataset("scalar_int", data=np.int64(-7))
        f.create_dataset("scalar_str", data=np.bytes_("a path"))
        f.create_dataset("empty_str", data=np.bytes_(""))
        f.create_dataset("empty_2d", data=np.zeros((0, 2), np.int64))
        md = f.create_group("metadata")
        md.attrs["format_id"] = 1.2
        md.attrs["json"] = np.bytes_(b'{"version": "2.0.0"}')
        grp = f.create_group("video0")
        ds = grp.create_dataset("video", data=_vlen(pngs))
        ds.attrs["format"] = "png"
        ds.attrs["channels"] = 3
        ds.attrs["height"] = np.int64(20)
        grp.create_dataset("frame_numbers", data=np.arange(5, dtype=np.int64))
        grp.create_group("source_video").attrs["json"] = '{"filename": "v.mp4"}'
        f.create_dataset("tracks", data=rng.normal(size=(2, 3, 2, 11)), compression="gzip",
                         compression_opts=1)
        f.create_dataset("occupancy", data=rng.integers(0, 2, (11, 2)).astype(np.uint8),
                         compression="gzip", compression_opts=1)
        f.create_dataset("no_tracks", data=np.zeros((0, 3, 2, 11)), compression="gzip",
                         compression_opts=1)
        f.create_dataset("nested/deeper/leaf", data=np.arange(3.0))
        f["points"].attrs["note"] = "a note"
    with h5py.File(path, "r") as f:
        assert f["bools"].dtype == np.bool_
        assert h5py.check_enum_dtype(f["bools"].dtype) is None  # h5py's bool, not an enum
        assert f["points"].dtype == POINT
        assert f["points"].id.get_type().get_member_type(2).get_class() == h5py.h5t.ENUM
        assert h5py.check_vlen_dtype(f["video0/video"].dtype) == np.uint8
        assert f["tracks"].compression == "gzip" and f["tracks"].compression_opts == 1
        assert f["tracks"].chunks == (2, 3, 2, 11)
        assert f["tracks_json"].shape == (0,) and f["tracks_json"].id.get_offset() is None
        assert isinstance(f.attrs["title"], str)
        assert isinstance(f["metadata"].attrs["json"], np.bytes_)
        assert f.id.get_create_plist().get_version()[0] == 0  # superblock version 0
        for k, want in enumerate(pngs):
            np.testing.assert_array_equal(f["video0/video"][k], want)
        assert _same(f["points"][:], points)
    assert_trees_equal(_h5py_tree(path), _port_tree(path))


def _fill(f, setting):
    rng = np.random.default_rng(1)
    f.attrs["s"] = "héllo"
    f.attrs["b"] = np.bytes_(b"xyz")
    f.attrs["f"] = 1.5
    f.attrs["arr"] = np.arange(3)
    f.create_dataset("points", data=np.zeros(5, POINT))
    f.create_dataset("plain", data=rng.random((7, 3)))
    f.create_dataset("strs", data=np.array([b"ab", b"cde"]))
    g = f.create_group("g")
    g.create_group("h").attrs["q"] = 1
    for i in range(5):
        g.create_dataset(f"d{i}", data=np.arange(i))
    d = g.create_dataset("vl", shape=(3,), dtype=h5py.vlen_dtype(np.uint8))
    for k in range(3):
        d[k] = np.arange(k * 3000, dtype=np.uint8)
    g.create_dataset("vs", data=np.array(["a", "bb"], dtype=object), dtype=h5py.string_dtype())
    c = f.create_group("c")
    if setting == "maxshape":
        c.create_dataset("m", data=rng.random((11, 2)), maxshape=(None, 2), chunks=(4, 2))
        c.create_dataset("m2", data=rng.random((3, 5)), maxshape=(None, None), chunks=(2, 2),
                         compression="gzip")
    elif setting == "latest_maxshape":  # extensible-array chunk indexes
        c.create_dataset("e", data=rng.random((11, 3)), maxshape=(None, 3), chunks=(2, 2))
        c.create_dataset("egz", data=rng.random(10), maxshape=(None,), chunks=(4,),
                         compression="gzip", shuffle=True)
        big = c.create_dataset("ebig", data=rng.integers(0, 9, 300), maxshape=(None,),
                               chunks=(1,))  # 300 chunks: secondary blocks
        big.resize((310,))
        big[305] = 7  # an unwritten chunk in between reads as the fill value
        c.create_dataset("eempty", shape=(0, 2), maxshape=(None, 2), chunks=(2, 2))
    elif setting.startswith("gzip"):
        c.create_dataset("z", data=rng.random((10, 7)), compression="gzip",
                         compression_opts=int(setting[4:]), chunks=(3, 4))
    elif setting == "shuffle":
        c.create_dataset("s", data=rng.integers(0, 1000, (10, 7)).astype("<i2"),
                         compression="gzip", shuffle=True, chunks=(4, 3))
        c.create_dataset("s8", data=rng.random(13), shuffle=True, chunks=(5,))
    elif setting == "uneven_chunks":
        c.create_dataset("u", data=rng.random((10, 7, 3)), chunks=(3, 4, 2))
    elif setting == "implicit":  # early allocation, no filter: an implicit chunk index
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((3, 4))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        h5py.h5d.create(c.id, b"i", h5py.h5t.IEEE_F64LE, h5py.h5s.create_simple((10, 7)),
                        dcpl=dcpl)
        c["i"][:8] = rng.random((8, 7))  # rows 8-9 keep the fill value
    elif setting == "continuation":
        for i in range(7):
            f["plain"].attrs[f"a{i}"] = np.arange(i + 1)
            f.attrs[f"t{i}"] = f"value {i}"
    else:  # a libver: chunked datasets under its chunk indexes
        c.create_dataset("one", data=rng.random(10), chunks=(10,))
        c.create_dataset("onegz", data=rng.random(10), chunks=(10,), compression="gzip")
        c.create_dataset("fixed", data=rng.random((10, 3)), chunks=(4, 3), compression="gzip")
        c.create_dataset("empty", data=np.zeros((0, 3)), compression="gzip")
        for i in range(5):
            f["plain"].attrs[f"a{i}"] = np.arange(i + 1)


SETTINGS = ["earliest", "v108", "v110", "v112", "latest", "maxshape", "latest_maxshape",
            "implicit", "shuffle",
            "uneven_chunks", "continuation"] + [f"gzip{k}" for k in range(1, 10)]


@pytest.mark.parametrize("setting", SETTINGS)
def test_port_reads_h5py_files(tmp_path, setting):
    libver = (setting if setting in ("earliest", "v108", "v110", "v112", "latest")
              else "latest" if setting.startswith("latest") or setting == "implicit"
              else "earliest")
    path = tmp_path / f"{setting}.h5"
    with h5py.File(path, "w", libver=libver) as f:
        _fill(f, setting)
    want = _h5py_tree(path)
    assert_trees_equal(_port_tree(path), want)
    with hdf5.File(path, "r") as f:
        # A row at a time reads as h5py reads it (the embedded-frame backend's access).
        np.testing.assert_array_equal(f["g/vl"][2], want["g/vl"][2][2])
        np.testing.assert_array_equal(f["plain"][3], want["plain"][2][3])
        np.testing.assert_array_equal(f["plain"][-1], want["plain"][2][-1])
        np.testing.assert_array_equal(f["plain"][2:5], want["plain"][2][2:5])
        assert "g/h" in f and "g/nope" not in f and "nope/x" not in f
        # Rows of each chunked dataset, within and across chunks.
        for name, (_, _, value, _) in want.items():
            if not name.startswith("c/") or not getattr(value, "shape", ()):
                continue
            n = len(value)
            keys = [slice(None), slice(2, 2), slice(n, None)]
            if n:
                keys += [0, n - 1, -1, n // 2, slice(1, n - 1), slice(n // 2, n)]
            for key in keys:
                np.testing.assert_array_equal(f[name][key], value[key], err_msg=f"{name}[{key}]")


@pytest.mark.parametrize("libver,maxshape", [("earliest", None), ("latest", None),
                                             ("latest", (None, 6, 5, 1))])
def test_a_row_inflates_only_its_chunks(tmp_path, monkeypatch, libver, maxshape):
    # A v1 B-tree, a fixed-array and an extensible-array chunk index.
    data = np.random.default_rng(3).integers(0, 255, (40, 6, 5, 1)).astype(np.uint8)
    path = tmp_path / "frames.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("one", data=data, chunks=(1, 6, 5, 1), compression="gzip",
                         maxshape=maxshape)
        f.create_dataset("three", data=data, chunks=(3, 4, 5, 1), compression="gzip",
                         maxshape=maxshape)
    inflated = []
    monkeypatch.setattr(hdf5, "zlib", SimpleNamespace(
        decompress=lambda b: inflated.append(1) or zlib.decompress(b)))
    with hdf5.File(path, "r") as f:
        for name, key, n_chunks in (("one", 17, 1), ("one", -1, 1), ("one", slice(3, 6), 3),
                                    ("three", 4, 2), ("three", slice(5, 10), 6),
                                    ("three", 39, 2), ("one", slice(None), 40)):
            del inflated[:]
            np.testing.assert_array_equal(f[name][key], data[key], err_msg=f"{name}[{key}]")
            assert len(inflated) == n_chunks, (name, key, len(inflated))


def _names(n):
    return [f"m{i:02d}" for i in range(n)]


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(
    n_members=st.integers(1, 30),
    n_rows=st.integers(0, 40),
    n_fields=st.integers(1, 6),
    str_len=st.integers(0, 40),
    seed=st.integers(0, 2**31 - 1),
)
def test_property_port_writes_what_h5py_reads(tmp_path_factory, n_members, n_rows, n_fields,
                                              str_len, seed):
    rng = np.random.default_rng(seed)
    kinds = ["<f8", "<f4", "<i8", "<u4", "<i2", "u1", "?", f"S{max(str_len, 1)}"]
    fields = [(f"f{i}", kinds[rng.integers(len(kinds))]) for i in range(n_fields)]
    dt = np.dtype(fields)
    rows = np.zeros(n_rows, dt)
    for name, kind in fields:
        if kind == "?":
            rows[name] = rng.random(n_rows) < 0.5
        elif kind.startswith("S"):
            rows[name] = [bytes(rng.integers(97, 123, rng.integers(0, str_len + 1)))
                          for _ in range(n_rows)]
        else:
            rows[name] = rng.integers(0, 100, n_rows).astype(kind)
    strings = np.array([bytes(rng.integers(32, 127, str_len)) for _ in range(max(n_rows, 1))])
    path = tmp_path_factory.mktemp("prop") / "p.h5"
    with hdf5.File(path, "w") as f:
        grp = f.create_group("g")
        for k, name in enumerate(_names(n_members)):
            if k % 3 == 0:
                grp.create_dataset(name, data=rows)
            elif k % 3 == 1:
                grp.create_dataset(name, data=strings[: rng.integers(0, len(strings) + 1)])
            else:
                grp.create_group(name).attrs["s"] = "x" * str_len
        f.attrs["u"] = "é" * str_len
        f.attrs["b"] = np.bytes_(b"y" * str_len)
    with h5py.File(path, "r") as f:
        assert sorted(f["g"].keys()) == _names(n_members)
        for k, name in enumerate(_names(n_members)):
            if k % 3 == 0:
                assert f["g"][name].dtype == dt
                np.testing.assert_array_equal(f["g"][name][()], rows)
    assert_trees_equal(_port_tree(path), _h5py_tree(path))


def _refused(tmp_path, name, build, read=lambda f: (dict(f.attrs), f["x"][()])):
    path = tmp_path / f"{name}.h5"
    build(path)
    with pytest.raises(NotImplementedError, match=name):
        with hdf5.File(path, "r") as f:
            read(f)


REFUSED = {
    "dense link storage": lambda p: _h5(p, "latest", lambda f: [
        f.create_dataset(f"x{i}", data=[i]) for i in range(12)]),
    "dense attribute storage": lambda p: _h5(p, "latest", lambda f: [
        f.attrs.__setitem__(f"a{i}", i) for i in range(12)] + [f.create_dataset("x", data=[1])]),
    "extensible-array chunk index over a dimension other than the first": lambda p: _h5(
        p, "latest", lambda f: f.create_dataset("x", data=np.ones((2, 4)), maxshape=(2, None),
                                                chunks=(1, 2))),
    "version 2 B-tree chunk index": lambda p: _h5(p, "latest", lambda f: f.create_dataset(
        "x", data=np.ones((4, 4)), maxshape=(None, None), chunks=(2, 2))),
    "lzf filter": lambda p: _h5(p, "earliest", lambda f: f.create_dataset(
        "x", data=np.arange(10.0), compression="lzf")),
    "fletcher32 filter": lambda p: _h5(p, "earliest", lambda f: f.create_dataset(
        "x", data=np.arange(10.0), fletcher32=True)),
    "scaleoffset filter": lambda p: _h5(p, "earliest", lambda f: f.create_dataset(
        "x", data=np.arange(10), scaleoffset=0)),
    "big-endian datatype": lambda p: _h5(p, "earliest", lambda f: f.create_dataset(
        "x", data=np.arange(4, dtype=">f8"))),
    "opaque datatype": lambda p: _h5(p, "earliest", lambda f: f.create_dataset(
        "x", data=np.zeros(3, "V4"))),
    "reference datatype": lambda p: _h5(p, "earliest", lambda f: f.create_dataset(
        "x", data=np.array([f.ref], dtype=h5py.ref_dtype))),
    "array datatype": lambda p: _h5(p, "latest", lambda f: f.create_dataset(
        "x", data=np.zeros(2, [("a", "<f8", (3,))]))),
    "bitfield datatype": lambda p: _h5(p, "earliest", lambda f: h5py.h5d.create(
        f.id, b"x", h5py.h5t.STD_B8LE, h5py.h5s.create_simple((3,)))),
    "soft link": lambda p: _h5(p, "earliest", lambda f: f.__setitem__("x", h5py.SoftLink("/y"))),
    "external link": lambda p: _h5(p, "latest", lambda f: f.__setitem__(
        "x", h5py.ExternalLink("other.h5", "/y"))),
    "virtual dataset": lambda p: _vds(p),
    "committed datatype": lambda p: _h5(p, "earliest", lambda f: f.__setitem__(
        "x", np.dtype("<f8"))),
    "external data files": lambda p: _h5(p, "earliest", lambda f: f.create_dataset(
        "x", shape=(4,), dtype="<f8", external=[(str(p) + ".raw", 0, 32)])),
}


def _h5(path, libver, fill):
    with h5py.File(path, "w", libver=libver) as f:
        fill(f)


def _vds(path):
    layout = h5py.VirtualLayout(shape=(4,), dtype="<f8")
    layout[:] = h5py.VirtualSource(str(path) + ".src", "s", shape=(4,))
    with h5py.File(str(path) + ".src", "w") as f:
        f.create_dataset("s", data=np.arange(4.0))
    with h5py.File(path, "w", libver="latest") as f:
        f.create_virtual_dataset("x", layout)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_features_name_themselves(tmp_path, name):
    _refused(tmp_path, name, REFUSED[name])


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with hdf5.File(tmp_path / "w.h5", "w") as f:
        with pytest.raises(NotImplementedError, match="big-endian"):
            f.create_dataset("be", data=np.arange(3, dtype=">i4"))
        with pytest.raises(NotImplementedError, match="lzf"):
            f.create_dataset("lzf", data=np.arange(3.0), compression="lzf")
        with pytest.raises(TypeError, match="dtype"):
            f.create_dataset("u", data=np.array(["a"]))
        with pytest.raises(ValueError, match="already exists"):
            f.create_dataset("d", data=[1])
            f.create_dataset("d", data=[2])
    with pytest.raises(OSError, match="not an HDF5 file"):
        (tmp_path / "junk.h5").write_bytes(b"x" * 100)
        hdf5.File(tmp_path / "junk.h5", "r")


def test_a_large_predictions_table_round_trips(tmp_path):
    """A million compound rows, as a long predictions file holds: one
    ``frombuffer`` each way, no loop a row."""
    rows = np.zeros(1_000_000, POINT)
    rows["x"] = np.arange(len(rows))
    rows["visible"] = rows["x"] % 3 == 0
    with hdf5.File(tmp_path / "big.h5", "w") as f:
        f.create_dataset("pred_points", data=rows)
    with hdf5.File(tmp_path / "big.h5", "r") as f:
        got = f["pred_points"][:]
    np.testing.assert_array_equal(got, rows)
    with h5py.File(tmp_path / "big.h5", "r") as f:
        np.testing.assert_array_equal(f["pred_points"][-5:], rows[-5:])
