"""The port's native libraries (``pose3d_tpu_torch/native/``, built by
``data/native_build.py``) and their bindings (``data/native_loader.py``,
``data/native_video.py``) against the JAX package's, and the direct
trainer's Human3.6M branch (``cli/train_direct.py``), on the CPU.

Both packages build their own libraries from the same sources, here in a
module fixture, not at import. Comparisons:

- ``NativeImageLoader.decode_batch`` (f32 and uint8), ``parallel_gather``,
  ``read_video_frames`` (uint8 and f32, stride, a frame cap, reads of more
  than 256 frames), ``stream_video_frames`` and ``extract_jpegs`` (JPEG
  bytes) vs the JAX package's native output: bitwise;
- the same functions on the cv2 fallback vs JAX's fallback: bitwise; the
  native video decode vs the cv2 fallback: bitwise (the same codec and
  resize); the native image loader vs cv2: JAX's own bounds (mean
  |diff| < 0.01, max < 0.15 in [0, 1): another bilinear resize);
- the video cases skip where the video library is not available, as
  ``tests/test_native_video.py`` skips, and every case here needs cv2 to
  write its inputs, as ``tests/test_native_loader.py`` does;
- a binding never builds: without its ``.so`` it logs the build command
  once and falls back;
- ``cli/train_direct.py`` on a fabricated Human3.6M export with JPEG
  frames: the uint8 frames, keypoints and statistics bitwise equal to the
  JAX trainer's ``load_image_split``, and one epoch trains with finite
  losses.
"""

import json
import logging

import numpy as np
import pytest
import torch

from torch_port_util import write_fake_h36m

from pose3d_tpu_torch.data import native_build, native_loader, native_video

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def built():
    """Both packages' libraries built; each binding loads afresh."""
    from pose3d_tpu.data import native_loader as jax_loader
    from pose3d_tpu.data import native_video as jax_video
    from pose3d_tpu.data.native_build import ensure_built as jax_build

    assert native_build.ensure_built()
    jax_build()
    for mod in (native_loader, native_video, jax_loader, jax_video):
        mod._lib = None  # a load tried before the build is tried again
    return jax_loader, jax_video


@pytest.fixture
def native_video_lib(built):
    if not native_video.native_available():
        pytest.skip("native video lib unavailable")
    return built[1]


@pytest.fixture
def no_native(monkeypatch, built):
    """Both packages on their python fallbacks."""
    for mod in (native_loader, native_video, *built):
        monkeypatch.setattr(mod, "_load_library", lambda: None)
    return built


@pytest.fixture
def jpeg_paths(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        img = (rng.random((100 + 10 * i, 120, 3)) * 255).astype(np.uint8)
        p = tmp_path / f"{i:04d}.jpg"
        cv2.imwrite(str(p), cv2.cvtColor(img, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 95])
        paths.append(p)
    return paths


def _write_video(path, w, h, n, fps):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    for i in range(n):  # smooth gradients, as tests/test_native_video.py writes
        writer.write(np.stack([(xx * 2 + i * 5) % 256, (yy * 3) % 256,
                               ((xx + yy) + i * 7) % 256], axis=-1).astype(np.uint8))
    writer.release()
    return path


@pytest.fixture(scope="module")
def video_file(tmp_path_factory):
    return _write_video(tmp_path_factory.mktemp("vid") / "clip.mp4", 96, 64, 25, 10.0)


def test_loader_builds_into_the_ports_directory(built):
    assert native_loader.native_available()
    assert native_loader._SO_PATH == native_build.NATIVE_DIR / "libposeloader.so"
    assert native_build.NATIVE_DIR.parent.name == "pose3d_tpu_torch"


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
def test_decode_batch_matches_jax_native(built, jpeg_paths, dtype):
    got = native_loader.NativeImageLoader(64).decode_batch(jpeg_paths, dtype)
    want = built[0].NativeImageLoader(64).decode_batch(jpeg_paths, dtype)
    assert got.shape == (6, 64, 64, 3) and got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if dtype == np.float32:
        assert got.min() >= 0.0 and got.max() < 1.0  # the /256 convention


def test_decode_batch_fallback_matches_jax_and_native(built, jpeg_paths, monkeypatch):
    native = native_loader.NativeImageLoader(64).decode_batch(jpeg_paths)
    jax_loader = built[0]
    for mod in (native_loader, jax_loader):
        monkeypatch.setattr(mod, "_load_library", lambda: None)
    for dtype in (np.float32, np.uint8):
        got = native_loader.NativeImageLoader(64).decode_batch(jpeg_paths, dtype)
        np.testing.assert_array_equal(got, jax_loader.NativeImageLoader(64).decode_batch(
            jpeg_paths, dtype))
    cv2_f32 = native_loader.NativeImageLoader(64).decode_batch(jpeg_paths)
    np.testing.assert_array_equal(
        native_loader.NativeImageLoader(64).decode_batch(jpeg_paths, np.uint8) / 256.0, cv2_f32)
    diff = np.abs(native - cv2_f32)
    assert diff.mean() < 0.01 and diff.max() < 0.15


def test_missing_file_zero_filled(built, jpeg_paths, tmp_path):
    got = native_loader.NativeImageLoader(32).decode_batch([jpeg_paths[0], tmp_path / "no.jpg"])
    assert got[0].max() > 0
    np.testing.assert_array_equal(got[1], 0.0)


def test_parallel_gather_matches_numpy_and_jax(built):
    rng = np.random.default_rng(1)
    for shape, idx, threads in (((1000, 17, 3), rng.integers(0, 1000, 256), 0),
                                ((64, 32, 32, 3), rng.permutation(64), 4)):
        src = rng.random(shape).astype(np.float32)
        got = native_loader.parallel_gather(src, idx, threads)
        np.testing.assert_array_equal(got, src[idx])
        np.testing.assert_array_equal(got, built[0].parallel_gather(src, idx, threads))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_read_video_frames_matches_jax_and_fallback(native_video_lib, video_file, dtype,
                                                    monkeypatch):
    cases = ({"size": 48}, {"size": 32, "stride": 3}, {"size": 32, "max_frames": 4})
    got = [native_video.read_video_frames(video_file, dtype=dtype, **kw) for kw in cases]
    for g, kw in zip(got, cases):
        np.testing.assert_array_equal(
            g, native_video_lib.read_video_frames(video_file, dtype=dtype, **kw))
    assert [len(g) for g in got] == [25, 9, 4] and got[0].dtype == dtype
    monkeypatch.setattr(native_video, "_load_library", lambda: None)
    for g, kw in zip(got, cases):
        np.testing.assert_array_equal(
            g, native_video.read_video_frames(video_file, dtype=dtype, **kw))


def test_stream_matches_jax_and_the_batch_reader(native_video_lib, video_file):
    chunks = list(native_video.stream_video_frames(video_file, size=48, chunk=7))
    want = list(native_video_lib.stream_video_frames(video_file, size=48, chunk=7))
    assert [len(c) for c in chunks] == [len(c) for c in want] == [7, 7, 7, 4]
    for a, b in zip(chunks, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  native_video.read_video_frames(video_file, size=48))


def test_stream_fallback_matches_jax_fallback(no_native, video_file):
    got = list(native_video.stream_video_frames(video_file, size=32, chunk=6, stride=2))
    want = list(no_native[1].stream_video_frames(video_file, size=32, chunk=6, stride=2))
    assert [len(c) for c in got] == [len(c) for c in want] == [6, 6, 1]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        next(native_video.stream_video_frames(video_file.parent / "nope.mp4"))


@pytest.mark.parametrize("fps", [None, 4.0])
def test_extract_jpegs_matches_jax(native_video_lib, video_file, tmp_path, fps):
    from pose3d_tpu_torch.pipeline.video import extract_frames, iter_frames

    n = native_video.extract_jpegs(video_file, tmp_path / "port", fps=fps)
    assert n == native_video_lib.extract_jpegs(video_file, tmp_path / "jax", fps=fps)
    assert n == sum(1 for _ in iter_frames(video_file, fps)) == (25 if fps is None else 10)
    names = sorted(p.name for p in (tmp_path / "port").glob("*.jpg"))
    assert names[0] == "0001.jpg" and names == sorted(p.name for p in
                                                      (tmp_path / "jax").glob("*.jpg"))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    if fps:  # the pipeline's extraction takes the native decoder
        assert extract_frames(video_file, tmp_path / "pipe", fps) == n
        assert (tmp_path / "pipe" / "0001.jpg").read_bytes() == \
            (tmp_path / "port" / "0001.jpg").read_bytes()


def test_chunked_reads_with_stride(native_video_lib, tmp_path, monkeypatch):
    """More than 256 frames: several native reads, the stride carried over."""
    path = _write_video(tmp_path / "long.mp4", 64, 48, 300, 30.0)
    got = native_video.read_video_frames(path, size=32, stride=7)
    assert got.shape[0] == 43  # ceil(300 / 7)
    np.testing.assert_array_equal(got, native_video_lib.read_video_frames(path, size=32,
                                                                          stride=7))
    monkeypatch.setattr(native_video, "_load_library", lambda: None)
    np.testing.assert_array_equal(got, native_video.read_video_frames(path, size=32, stride=7))


def test_missing_video_raises(native_video_lib, tmp_path):
    with pytest.raises(FileNotFoundError):
        native_video.read_video_frames(tmp_path / "nope.mp4")


@pytest.mark.parametrize("mod", [native_loader, native_video], ids=["loader", "video"])
def test_a_binding_never_builds(mod, tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(mod, "_SO_PATH", tmp_path / "absent.so")
    monkeypatch.setattr(mod, "_lib", None)
    with caplog.at_level(logging.WARNING):
        assert not mod.native_available() and not mod.native_available()
    assert not (tmp_path / "absent.so").exists()
    warned = [r for r in caplog.records if "pose3d_tpu_torch.data.native_build" in r.message]
    assert len(warned) == 1  # once, not a call


def _fake_export(root):
    """A fabricated Human3.6M export (mono 3D file) with one JPEG a frame,
    where ``h36m.read_data`` looks for them."""
    frames = {("S1", "Posing"): 7, ("S1", "Walking"): 5, ("S11", "Posing"): 4,
              ("S11", "Eating"): 3}
    write_fake_h36m(root, frames, np.random.default_rng(3))
    rng = np.random.default_rng(4)
    for (s, a), n in frames.items():
        d = root / "videos" / s / "outputVideos" / f"{a}.mp4"
        d.mkdir(parents=True)
        for i in range(n):
            img = (rng.random((90, 120, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(d / f"{i + 1:04d}.jpg"), img)


def test_train_direct_on_a_fabricated_h36m_export(built, tmp_path):
    from pose3d_tpu.cli.train_direct import load_image_split as jax_split
    from pose3d_tpu.config import DataConfig as JaxData
    from pose3d_tpu.config import DirectConfig as JaxConfig

    from pose3d_tpu_torch.cli import train_direct as cli
    from pose3d_tpu_torch.config import DataConfig, DirectConfig

    _fake_export(tmp_path / "h36m")
    data = {"data_dir": str(tmp_path / "h36m"), "action": "", "split_rate": 2}
    cfg = DirectConfig(architecture="resnet18", image_size=64, batch_size=2, chunk_steps=1,
                       n_epochs=1, device="cpu", log_dir=str(tmp_path / "port"),
                       data=DataConfig(**data))
    jcfg = JaxConfig(image_size=64, log_dir=str(tmp_path / "jax"), data=JaxData(**data))
    for is_train, n in ((True, 6), (False, 4)):  # every 2nd of S1's 12 frames, S11's 7
        got, want = cli.load_image_split(cfg, is_train), jax_split(jcfg, is_train)
        assert got[0].dtype == want[0].dtype == np.uint8 and got[0].shape == (n, 64, 64, 3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for name in ("mean", "std"):
            np.testing.assert_array_equal(getattr(got[2], name), getattr(want[2], name))
        assert got[0].std() > 10  # decoded pixels, not zero frames

    state = cli.train(cfg)
    assert state.step == 6 // 2
    records = [json.loads(line) for line in
               (tmp_path / "port" / "runs" / "direct_run.jsonl").read_text().splitlines()]
    epoch = next(r for r in records if r.get("epoch") == 1)
    assert all(np.isfinite(epoch[k]) for k in ("train_loss", "train_mpjpe", "val_loss",
                                               "val_mpjpe"))
