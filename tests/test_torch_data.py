"""The port's TUM loader (tpuslam_torch/data/tum.py, _tum_native.py, png.py),
sequence writer and `frontend.prefetch_to_device` against the reference's
(tpuslam/data/tum.py, tpuslam/data/synthetic.py) on CPU.

Depth is held byte for byte: each available decoder (native libpng built
from csrc/tum_decode.cc, OpenCV, the numpy + zlib codec) against the
reference's `_decode_depth_png_raw`; the numpy codec against OpenCV on
PNGs that OpenCV wrote with each of the five row filters; association,
trajectory files and the depth sidecar across the two packages.
"""

import os
import shutil
import sys
import zlib

import numpy as np
import pytest
import torch

from tpuslam.config import Intrinsics
from tpuslam.data import synthetic as rsyn
from tpuslam.data import tum as rtum
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.data import _tum_native, png
from tpuslam_torch.data import synthetic as psyn
from tpuslam_torch.data import tum as ptum
from tpuslam_torch.frontend import prefetch_to_device

torch.set_num_threads(1)

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH")


@pytest.fixture(scope="module")
def ref_seq(tmp_path_factory):
    """A 6-frame sequence written by the reference (OpenCV PNGs)."""
    root = str(tmp_path_factory.mktemp("ref_tum"))
    poses = rsyn.write_tum_sequence(root, 6, K, H, W, rgb=True)
    return root, poses


def _png_filters(path: str) -> set:
    """The filter type of every row of a PNG (parsed with the codec's own
    chunk reader)."""
    chunks = list(png._chunks(open(path, "rb").read()))
    w, h, depth, color = np.frombuffer(chunks[0][1][:10], ">u4,>u4,u1,u1")[0]
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    stride = 1 + w * png._CHANNELS[color] * depth // 8
    return set(raw[::stride][:h])


@pytest.mark.parametrize("decoder", ptum.DECODERS)
def test_depth_decoders_match_reference(ref_seq, decoder):
    root, _ = ref_seq
    if decoder == "native":
        try:
            _tum_native.library()
        except RuntimeError as e:
            pytest.skip(f"native decoder unavailable here: {e}")
    for _, (rel, *_r) in rtum.read_file_list(os.path.join(root, "depth.txt")):
        path = os.path.join(root, rel)
        ref = rtum._decode_depth_png_raw(path)
        got = ptum._DECODE[decoder](path)
        assert got.dtype == np.uint16 == ref.dtype
        assert got.shape == ref.shape and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("kind", ["depth16", "rgb8"])
def test_numpy_codec_reads_cv2_filters(tmp_path, filt, kind):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    if kind == "depth16":
        img = rsyn.render_depth(np.eye(4), K, 48, 64)
        img = (np.round(img * 5000) + rng.integers(0, 300, img.shape)
               ).astype(np.uint16)
        wrote = img
    else:
        img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
        img[10:20] = 200                 # runs, so filters differ
        wrote = img[..., ::-1]           # OpenCV writes BGR
    path = str(tmp_path / f"{kind}_{filt}.png")
    code = getattr(cv2, f"IMWRITE_PNG_FILTER_{filt}")
    assert cv2.imwrite(path, wrote, [cv2.IMWRITE_PNG_FILTER, code])
    assert _png_filters(path) <= {0, FILTERS.index(filt)}
    assert FILTERS.index(filt) in _png_filters(path) or filt == "NONE"
    got = png.read_png(path)
    assert got.dtype == img.dtype and np.array_equal(got, img)


def test_numpy_codec_writes_what_cv2_reads(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    d = rng.integers(0, 65536, (30, 50)).astype(np.uint16)
    rgb = rng.integers(0, 256, (30, 50, 3)).astype(np.uint8)
    png.write_png(str(tmp_path / "d.png"), d)
    png.write_png(str(tmp_path / "c.png"), rgb)
    assert _png_filters(str(tmp_path / "d.png")) == {0}
    assert np.array_equal(cv2.imread(str(tmp_path / "d.png"),
                                     cv2.IMREAD_UNCHANGED), d)
    assert np.array_equal(cv2.imread(str(tmp_path / "c.png"))[..., ::-1], rgb)
    assert np.array_equal(rtum._decode_depth_png_raw(str(tmp_path / "d.png")),
                          d)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"not a png at all")
    data = bytearray((tmp_path / "d.png").read_bytes())
    data[40] ^= 0xFF                     # inside IDAT: the CRC catches it
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))


@pytest.mark.parametrize("matcher", ["native", "python"])
def test_associate_matches_reference(monkeypatch, matcher):
    """Jittered streams at 30 Hz against 100 Hz with drops: the greedy
    rule (|Δt|, then index) gives the reference's pairs."""
    if matcher == "python":
        def unavailable(*a):
            raise RuntimeError("native TUM decoder unavailable (test)")
        monkeypatch.setattr(_tum_native, "associate_native", unavailable)
    elif _tum_native._load()[0] is None:
        pytest.skip("native matcher unavailable here")
    rng = np.random.default_rng(3)
    for trial in range(5):
        ta = 1000 + np.arange(200) / 30.0 + rng.uniform(-4e-3, 4e-3, 200)
        tb = 1000 + np.arange(700) / 100.0 + rng.uniform(-3e-3, 3e-3, 700)
        tb = tb[rng.uniform(size=700) > 0.2]
        tb = tb[rng.permutation(len(tb))]        # unsorted stream
        a = [(float(t), []) for t in ta]
        b = [(float(t), []) for t in tb]
        for md, off in ((0.02, 0.0), (0.004, 0.001), (0.05, -0.01)):
            assert (ptum.associate(a, b, md, off)
                    == rtum.associate(a, b, md, off))
    # exact ties resolve by index, as the reference's sort does
    a = [(1.0, []), (2.0, [])]
    b = [(1.5, []), (1.5, [])]
    assert ptum.associate(a, b, 0.6) == rtum.associate(a, b, 0.6) == [(0, 0),
                                                                      (1, 1)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trajectory_files_cross_packages(tmp_path, writer):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(4)
    n = 12
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = Rotation.random(n, rng).as_matrix()
    poses[:, :3, 3] = rng.normal(size=(n, 3))
    ts = 100.0 + np.arange(n) / 30.0
    mine, other = (rtum, ptum) if writer == "reference" else (ptum, rtum)
    path = str(tmp_path / "traj.txt")
    mine.write_trajectory(path, ts, poses)
    text = open(path).read()
    other.write_trajectory(str(tmp_path / "other.txt"), ts, poses)
    assert open(str(tmp_path / "other.txt")).read() == text
    ts_o, p_o = other.read_trajectory(path)
    ts_m, p_m = mine.read_trajectory(path)
    np.testing.assert_allclose(ts_o, ts_m, atol=1e-6)
    np.testing.assert_allclose(p_o, p_m, atol=1e-6)
    np.testing.assert_allclose(p_o, poses, atol=1e-5)


def test_sequence_matches_reference(ref_seq):
    root, poses = ref_seq
    r = rtum.TumSequence(root, depth_cache=False, load_rgb=True)
    p = ptum.TumSequence(root, depth_cache=False, load_rgb=True)
    assert p.intrinsics == PIntrinsics(*r.intrinsics)
    assert len(p) == len(r) == 6
    for fp, fr in zip(p.frames(), r.frames()):
        assert fp.timestamp == fr.timestamp
        assert fp.depth.dtype == np.float32
        assert fp.depth.tobytes() == fr.depth.tobytes()
        np.testing.assert_array_equal(fp.gt_pose, fr.gt_pose)
        np.testing.assert_array_equal(fp.rgb, fr.rgb)
    for i in (0, 3):
        np.testing.assert_array_equal(p.frame(i, raw=True).depth,
                                      r.frame(i, raw=True).depth)
    np.testing.assert_allclose(p.gt_pose(0), poses[0], atol=1e-5)


@pytest.mark.parametrize("codec", ["cv2", "numpy"])
def test_write_tum_sequence_matches_reference(tmp_path, ref_seq, monkeypatch,
                                              codec):
    root_r, poses_r = ref_seq
    if codec == "numpy":
        monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    root = str(tmp_path / "port")
    poses = psyn.write_tum_sequence(root, 6, PIntrinsics(*K), H, W, rgb=True)
    np.testing.assert_array_equal(poses, poses_r)
    for name in ("depth.txt", "rgb.txt", "groundtruth.txt", "intrinsics.txt"):
        assert (open(os.path.join(root, name)).read()
                == open(os.path.join(root_r, name)).read())
    for _, (rel, *_r) in rtum.read_file_list(os.path.join(root, "depth.txt")):
        a = png.read_png(os.path.join(root, rel))
        b = png.read_png(os.path.join(root_r, rel))
        assert a.dtype == np.uint16 and a.tobytes() == b.tobytes()
        if codec == "numpy":
            assert _png_filters(os.path.join(root, rel)) == {0}
    for _, (rel, *_r) in rtum.read_file_list(os.path.join(root, "rgb.txt")):
        np.testing.assert_array_equal(png.read_png(os.path.join(root, rel)),
                                      png.read_png(os.path.join(root_r, rel)))


def test_decoder_order_and_note(monkeypatch):
    """native, then cv2, then numpy; the note says why each earlier one
    is unavailable, and a failed decode raises."""
    ptum._pick_decoder.cache_clear()
    try:
        name = ptum.depth_decoder()
        assert name in ptum.DECODERS
        assert ptum.decoder_note().startswith(name)
        monkeypatch.setattr(_tum_native, "_load",
                            lambda: (None, "OSError: no libpng (test)"))
        ptum._pick_decoder.cache_clear()
        if ptum.depth_decoder() == "cv2":
            assert ptum.decoder_note() == ("cv2 (native: native TUM decoder "
                                           "unavailable (OSError: no libpng "
                                           "(test)))")
        monkeypatch.setitem(sys.modules, "cv2", None)
        ptum._pick_decoder.cache_clear()
        assert ptum.depth_decoder() == "numpy"
        note = ptum.decoder_note()
        assert note.startswith("numpy (native: ") and "; cv2: " in note
        with pytest.raises((IOError, ValueError)):
            ptum.decode_depth_png_raw(os.devnull)
    finally:
        ptum._pick_decoder.cache_clear()


def test_raw_uint16_frames(ref_seq, tmp_path):
    root, _ = ref_seq
    seq = ptum.TumSequence(root, depth_cache=False)
    f32 = seq.frame(1)
    raw = seq.frame(1, raw=True)
    assert raw.depth.dtype == np.uint16
    np.testing.assert_array_equal(
        raw.depth, np.round(f32.depth * 5000.0).astype(np.uint16))
    assert all(f.depth.dtype == np.uint16 for f in seq.frames(raw=True))
    croot = str(tmp_path / "cached")
    shutil.copytree(root, croot)
    for _ in ptum.TumSequence(croot).frames():        # build + publish
        pass
    cseq = ptum.TumSequence(croot)
    assert cseq.cached(5000.0) and not cseq.cached(1000.0)
    np.testing.assert_array_equal(cseq.frame(1, raw=True).depth, raw.depth)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_depth_cache_roundtrip_and_invalidation(tmp_path, writer):
    """Mirror of tests/test_tum_loader.py's sidecar test through the port,
    with the sidecar built by either package (the format is shared)."""
    rsyn.write_tum_sequence(str(tmp_path), 5, K, H, W)
    mod = ptum if writer == "port" else rtum
    seq = mod.TumSequence(str(tmp_path))
    assert seq._open_cache(5000.0) is None
    ref = [f.depth.copy() for f in seq.frames()]      # builds the sidecar
    assert (tmp_path / "depth_cache.npy").exists()
    assert (tmp_path / "depth_cache.json").exists()

    seq2 = ptum.TumSequence(str(tmp_path))
    assert seq2._open_cache(5000.0) is not None
    got = [f.depth for f in seq2.frames()]
    assert len(got) == 5
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert rtum.TumSequence(str(tmp_path))._open_cache(5000.0) is not None
    assert seq2._open_cache(1000.0) is None
    np.testing.assert_allclose(seq2.frame(0, depth_scale=1000.0).depth,
                               ref[0] * 5.0, rtol=1e-6)

    p = tmp_path / "depth.txt"
    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    seq3 = ptum.TumSequence(str(tmp_path))
    assert seq3._open_cache(5000.0) is None
    list(seq3.frames())
    assert seq3._open_cache(5000.0) is not None

    png_path = tmp_path / seq3.depth_list[2][1][0]
    st = os.stat(png_path)
    os.utime(png_path, ns=(st.st_atime_ns, st.st_mtime_ns + 2_000_000_000))
    assert ptum.TumSequence(str(tmp_path))._open_cache(5000.0) is None


def test_depth_cache_partial_iteration_not_published(tmp_path):
    rsyn.write_tum_sequence(str(tmp_path), 5, K, H, W)
    seq = ptum.TumSequence(str(tmp_path))
    gen = seq.frames()
    next(gen)
    gen.close()
    assert not (tmp_path / "depth_cache.npy").exists()
    assert not (tmp_path / "depth_cache.npy.tmp").exists()
    list(seq.frames(start=1))                # windowed: no build attempted
    assert not (tmp_path / "depth_cache.npy").exists()
    list(ptum.TumSequence(str(tmp_path), depth_cache=False).frames())
    assert not (tmp_path / "depth_cache.npy").exists()


def test_prefetch_to_device_on_cpu(ref_seq):
    root, _ = ref_seq
    seq = ptum.TumSequence(root, depth_cache=False)
    for raw, dtype in ((False, torch.float32), (True, torch.uint16)):
        host = [f.depth.copy() for f in seq.frames(raw=raw)]
        frames = list(seq.frames(raw=raw))
        out = list(prefetch_to_device(iter(frames), lookahead=3,
                                      device="cpu"))
        assert [f.timestamp for f in out] == [f.timestamp for f in frames]
        for f, h in zip(out, host):
            assert isinstance(f.depth, torch.Tensor) and f.depth.dtype == dtype
            assert np.array_equal(f.depth.numpy(), h)
    # the upload is the caller's own copy: the loader may reuse its array
    buf = np.ones((4, 5), dtype=np.float32)
    frame = ptum.TumFrame(timestamp=0.0, depth=buf, gt_pose=None)
    (got,) = prefetch_to_device([frame], device="cpu")
    buf[:] = 7.0
    assert float(got.depth.max()) == 1.0
