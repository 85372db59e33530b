"""Show-compatible .oct serialization tests (format:
include/slam6d/Boctree.h:449-560)."""

import struct

import numpy as np

from tpu3dtk.io.boctree import oct_header, read_oct, write_oct
from tests.conftest import make_room_cloud


def test_roundtrip_points(tmp_path, rng):
    pts = make_room_cloud(rng, n=5000, size=700.0)
    p = str(tmp_path / "scan000.oct")
    write_oct(p, pts, voxel_size=10.0)
    back = read_oct(p)
    assert back.shape == pts.shape
    # order differs (octant DFS); compare as sorted sets, f32 rounding
    a = np.sort(pts.astype(np.float32).view("f4,f4,f4"), axis=0)
    b = np.sort(back.astype(np.float32).view("f4,f4,f4"), axis=0)
    assert (a == b).all()


def test_header_fields(tmp_path, rng):
    pts = make_room_cloud(rng, n=1000, size=500.0)
    p = str(tmp_path / "t.oct")
    write_oct(p, pts, voxel_size=7.5)
    h = oct_header(p)
    assert h["voxel"] == np.float32(7.5)
    assert h["pointdim"] == 3
    np.testing.assert_allclose(h["mins"], pts.min(0), atol=1e-3)
    np.testing.assert_allclose(h["maxs"], pts.max(0), atol=1e-3)
    # root half-size = max half-extent + 1.0 (Boctree.h:253-255)
    expect = float(np.max(0.5 * (pts.max(0) - pts.min(0)))) + 1.0
    np.testing.assert_allclose(h["size"], expect, rtol=1e-6)


def test_exact_bytes_single_leaf(tmp_path):
    """Byte-level golden check of a tiny tree against the hand-encoded
    reference layout: magic, pointtype flags, T[5] header, POINTDIM,
    mins/maxs, then (valid, leaf) and one uint32-length leaf block."""
    # two points in one octant close together -> root with ONE child
    pts = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]])
    p = str(tmp_path / "g.oct")
    write_oct(p, pts, voxel_size=100.0)  # child half-size <= voxel -> leaf
    raw = open(p, "rb").read()
    assert raw[:2] == b"XT"
    assert struct.unpack_from("<I", raw, 2)[0] == 0  # USE_NONE
    hdr = np.frombuffer(raw, np.float32, count=5, offset=6)
    mins = pts.min(0)
    maxs = pts.max(0)
    np.testing.assert_allclose(hdr[1:4], 0.5 * (mins + maxs))
    size = np.max(0.5 * (maxs - mins)) + 1.0
    np.testing.assert_allclose(hdr[4], size)
    assert struct.unpack_from("<i", raw, 26)[0] == 3
    np.testing.assert_allclose(np.frombuffer(raw, np.float32, 3, 30), mins)
    np.testing.assert_allclose(np.frombuffer(raw, np.float32, 3, 42), maxs)
    valid, leaf = raw[54], raw[55]
    # both points lie in octants relative to center (1.5,1.5,1.5):
    # (1,1,1) -> bits (0,0,0) = idx 0; (2,2,2) -> idx 7
    assert valid == (1 << 0) | (1 << 7)
    assert leaf == valid  # half-size 0.75 <= voxel 100 -> leaves
    n0 = struct.unpack_from("<I", raw, 56)[0]
    assert n0 == 1
    np.testing.assert_allclose(
        np.frombuffer(raw, np.float32, 3, 60), [1.0, 1.0, 1.0]
    )
    n7 = struct.unpack_from("<I", raw, 72)[0]
    assert n7 == 1
    np.testing.assert_allclose(
        np.frombuffer(raw, np.float32, 3, 76), [2.0, 2.0, 2.0]
    )
    assert len(raw) == 88


def test_deep_tree_and_empty(tmp_path, rng):
    pts = rng.uniform(0, 1000, (2000, 3))
    p = str(tmp_path / "d.oct")
    write_oct(p, pts, voxel_size=1.0)  # deep subdivision
    back = read_oct(p)
    assert len(back) == len(pts)
    p2 = str(tmp_path / "e.oct")
    write_oct(p2, np.zeros((0, 3)), voxel_size=10.0)
    assert len(read_oct(p2)) == 0
