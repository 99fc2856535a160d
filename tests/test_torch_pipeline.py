"""The port's video -> 3D pipeline (``pose3d_tpu_torch/pipeline/{keypoints,
video,detector,h36m_batch,run}.py``), the 2D heatmap functions
(``ops/heatmap.py``) and ``render_pose_frames`` (``data/synthetic.py``)
against the JAX package, on the CPU. Inputs come from numpy seeds.

Tolerances:

- ``soft_argmax_2d``, ``gaussian_heatmap_2d``, ``norm_heatmap`` vs JAX, f32
  (and bf16 inputs for the soft-argmax), logits N(0, 3) and ~100 with
  planted peaks: atol 1e-6 (f32 sums in another order);
  ``hard_argmax_2d``: bitwise;
- ``render_pose_frames(noise=0)`` vs JAX: atol 1e-5 (an f32 einsum over
  113 blobs summed in another order); with noise: values in [0, 1] and
  bitwise equal for one generator seed;
- video I/O (``extract_frames`` names, counts and JPEG bytes,
  ``iter_frames``, ``load_frames`` f32 and uint8, fps resampling) on a
  cv2-written mp4, both packages on the cv2 path: bitwise (the native
  decoder is held to JAX's in ``test_torch_native.py``);
- ``MockDetector``, ``merge_detections`` / ``save_to_json`` (COCO and H36M
  order, several people, an empty frame) and ``detect_h36m_tree`` on a
  fabricated frame tree: the JSON files equal byte for byte;
  ``rotate_to_global``: atol 1e-6;
- ``process_video`` with ``MockDetector`` and a small f32
  ``TemporalLifter`` (clip 8, hidden 32, 1 block, 2 heads, weights by
  ``temporal_lifter_from_flax``) vs JAX's: poses and the saved npy atol
  1e-4 (PERF.md §2's f32 limit); with ``render`` its 3D video equals, byte
  for byte, JAX's ``render_3d_video`` on the same poses with the
  reference's display convention;
- ``run.main`` with ``--cpu --detector posenet2d`` on port checkpoints: the
  JAX layout, the npy bitwise equal to ``lift_video_json`` on the run's own
  JSON with the same lifter, and a missing checkpoint giving a fresh init
  with JAX's messages; ``--render`` writes the 2D and the 3D videos, one
  frame a video frame;
- ``OpenPifPafDetector`` against a stub ``openpifpaf.predict`` on
  ``PYTHONPATH``: one process sees every frame and JAX's flags, the same
  argument list as the JAX detector's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_util import flax_temporal, torch_temporal

from pose3d_tpu_torch.data.synthetic import render_pose_frames, synthetic_h36m
from pose3d_tpu_torch.ops import heatmap as H
from pose3d_tpu_torch.pipeline import keypoints as kp_lib
from pose3d_tpu_torch.pipeline import run as run_lib
from pose3d_tpu_torch.pipeline import video as video_lib
from pose3d_tpu_torch.pipeline.detector import MockDetector, OpenPifPafDetector
from pose3d_tpu_torch.pipeline.h36m_batch import detect_h36m_tree

torch.set_num_threads(2)

TEMPORAL = {"clip_len": 8, "hidden": 32, "n_blocks": 1, "heads": 2}


def _logits(kind, dtype, shape=(3, 17, 16, 16)):
    rng = np.random.default_rng(5)
    if kind == "normal":
        x = rng.normal(0.0, 3.0, shape)
    else:  # ~100 with a planted peak a map
        x = 100.0 + rng.normal(0.0, 1.0, shape)
        b, j, h, w = shape
        ys, xs = rng.integers(0, h, (b, j)), rng.integers(0, w, (b, j))
        for i in range(b):
            for k in range(j):
                x[i, k, ys[i, k], xs[i, k]] += 8.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["normal", "peaks"])
def test_soft_argmax_2d_matches_jax(kind, dtype):
    import jax.numpy as jnp

    from pose3d_tpu.ops.heatmap import soft_argmax_2d as jax_soft

    x = _logits(kind, dtype)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32)
    want = np.asarray(jax_soft(jx, 17, 16, 16))
    got = H.soft_argmax_2d(x, 17, 16, 16)
    assert got.dtype == torch.float32 and got.shape == (3, 34)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert got.std() > 0.1  # the maps peak: the coordinates spread


def test_soft_argmax_2d_stays_f32_under_autocast():
    x = _logits("peaks", torch.float32)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = H.soft_argmax_2d(x, 17, 16, 16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), H.soft_argmax_2d(x, 17, 16, 16).numpy())


def test_hard_argmax_2d_matches_jax_bitwise():
    import jax.numpy as jnp

    from pose3d_tpu.ops.heatmap import hard_argmax_2d as jax_hard

    x = _logits("normal", torch.float32)
    x[0, 0] = -1.0 - x[0, 0].abs()      # a map with no positive value: (0, 0)
    x[1, 2] = 0.5
    x[1, 2, 3, 4] = x[1, 2, 9, 1] = 2.0  # a tie: the first maximum
    coords, maxvals = H.hard_argmax_2d(x)
    want_c, want_m = jax_hard(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(maxvals.numpy(), np.asarray(want_m))
    assert coords[0, 0].tolist() == [0.0, 0.0] and coords[1, 2].tolist() == [4.0, 3.0]


def test_gaussian_heatmap_2d_matches_jax():
    import jax.numpy as jnp

    from pose3d_tpu.ops.heatmap import gaussian_heatmap_2d as jax_gauss

    rng = np.random.default_rng(6)
    pt = rng.uniform(-4.0, 68.0, (5, 17, 2)).astype(np.float32)  # some windows clipped
    for sigma in (2.0, 1.5):
        want = np.asarray(jax_gauss(jnp.asarray(pt), (64, 48), sigma))
        got = H.gaussian_heatmap_2d(torch.from_numpy(pt), (64, 48), sigma).numpy()
        assert got.shape == want.shape == (5, 17, 64, 48)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got.max() > 0.5


@pytest.mark.parametrize("norm_type", ["softmax", "sigmoid", "divide_sum"])
def test_norm_heatmap_matches_jax(norm_type):
    import jax.numpy as jnp

    from pose3d_tpu.ops.heatmap import norm_heatmap as jax_norm

    x = _logits("normal", torch.float32, (2, 5, 8, 8))
    if norm_type == "divide_sum":
        x = x.abs() + 0.1
    want = np.asarray(jax_norm(norm_type, jnp.asarray(x.numpy())))
    got = H.norm_heatmap(norm_type, x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError):
        H.norm_heatmap("l2", x)


def test_render_pose_frames_matches_jax():
    import jax

    from pose3d_tpu.data.synthetic import render_pose_frames as jax_render

    kp, _ = synthetic_h36m(4, seed=2)
    want = np.asarray(jax_render(kp, jax.random.key(0), size=64, noise=0.0))
    got = render_pose_frames(torch.from_numpy(kp), size=64, noise=0.0)
    assert got.shape == (4, 64, 64, 3) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert want.max() > 0.5  # the blobs are in the frame

    noisy = render_pose_frames(kp, torch.Generator().manual_seed(3), size=64)
    again = render_pose_frames(kp, torch.Generator().manual_seed(3), size=64)
    other = render_pose_frames(kp, torch.Generator().manual_seed(4), size=64)
    assert noisy.min() >= 0.0 and noisy.max() <= 1.0
    assert torch.equal(noisy, again) and not torch.equal(noisy, other)
    with pytest.raises(ValueError, match="Generator"):
        render_pose_frames(kp, size=64)


def test_rotate_to_global_matches_jax():
    from pose3d_tpu.pipeline.keypoints import rotate_to_global as jax_rotate

    poses = np.random.default_rng(7).normal(size=(10, 17, 3)).astype(np.float32)
    for subject, camera in (("S1", 2), ("S9", 0)):
        got = kp_lib.rotate_to_global(poses, subject, camera)
        np.testing.assert_allclose(got, jax_rotate(poses, subject, camera), atol=1e-6, rtol=0)


def _same_files(a, b, pattern="*.json"):
    names = sorted(p.relative_to(a) for p in a.rglob(pattern))
    assert names and names == sorted(p.relative_to(b) for p in b.rglob(pattern))
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def _frame_names(d, n):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        (d / f"{i + 1:04d}.jpg").write_bytes(b"")  # the mock detector reads names only
    return d


@pytest.mark.parametrize("already_h36m", [False, True])
def test_mock_detections_and_merge_match_jax_byte_for_byte(tmp_path, already_h36m):
    from pose3d_tpu.pipeline import keypoints as jax_kp
    from pose3d_tpu.pipeline.detector import MockDetector as JaxMock

    frames = _frame_names(tmp_path / "frames", 12)
    MockDetector(seed=3, n_people=3).detect_dir(frames, tmp_path / "port")
    JaxMock(seed=3, n_people=3).detect_dir(frames, tmp_path / "jax")
    for d in ("port", "jax"):  # a frame with no person
        (tmp_path / d / "0013.jpg.predictions.json").write_text("[]")
    _same_files(tmp_path / "port", tmp_path / "jax")

    got = kp_lib.save_to_json(tmp_path / "port", tmp_path / "out/port.json", already_h36m)
    want = jax_kp.save_to_json(tmp_path / "jax", tmp_path / "out/jax.json", already_h36m)
    assert got == want and len(got) == 13 and got[-1]["score"] == 0.0
    assert (tmp_path / "out/port.json").read_bytes() == (tmp_path / "out/jax.json").read_bytes()


def test_detect_h36m_tree_matches_jax_byte_for_byte(tmp_path, capsys):
    from pose3d_tpu.pipeline.detector import MockDetector as JaxMock
    from pose3d_tpu.pipeline.h36m_batch import detect_h36m_tree as jax_tree

    data = tmp_path / "h36m"
    for action, n in (("Walking.54138969.mp4", 5), ("Posing.mp4", 3), ("Eating 2.mp4", 4)):
        _frame_names(data / "videos" / "S1" / "outputVideos" / action, n)
    _frame_names(data / "videos" / "S9" / "outputVideos" / "Sitting.mp4", 2)
    subjects = ("S1", "S5", "S9")  # S5 has no tree
    got = detect_h36m_tree(data, tmp_path / "port", MockDetector(), subjects)
    want = jax_tree(data, tmp_path / "jax", JaxMock(), subjects)
    assert [p.relative_to(tmp_path / "port") for p in got] == \
        [p.relative_to(tmp_path / "jax") for p in want]
    assert len(got) == 4 and "S5/outputVideos not a directory" in capsys.readouterr().out
    _same_files(tmp_path / "port", tmp_path / "jax")


@pytest.fixture
def cv2_only(monkeypatch):
    """Both packages on their cv2 path (no native decoder)."""
    pytest.importorskip("cv2")
    from pose3d_tpu.data import native_video as jax_native

    from pose3d_tpu_torch.data import native_video

    monkeypatch.setattr(native_video, "_load_library", lambda: None)
    monkeypatch.setattr(jax_native, "_load_library", lambda: None)


@pytest.fixture
def mp4(tmp_path):
    """A 12-frame 64 x 64 mp4 at 10 fps, written by cv2 (the pattern of
    ``tests/test_pipeline.py``), under ``raw_videos/``."""
    pytest.importorskip("cv2")
    frames = (np.random.default_rng(0).random((12, 64, 64, 3)) * 255).astype(np.uint8)
    path = tmp_path / "videos" / "raw_videos" / "clip.mp4"
    assert video_lib.write_video(iter(frames), path, fps=10) == 12
    return path


@pytest.mark.parametrize("fps", [100.0, 5.0, 4.0, 10.0])
def test_extract_frames_matches_jax(mp4, tmp_path, cv2_only, fps):
    from pose3d_tpu.pipeline import video as jax_video

    n = video_lib.extract_frames(mp4, tmp_path / "port", fps=fps)
    want = jax_video.extract_frames(mp4, tmp_path / "jax", fps=fps)
    assert n == want == {100.0: 12, 10.0: 12, 5.0: 6, 4.0: 5}[fps]
    assert (tmp_path / "port" / "0001.jpg").exists()
    _same_files(tmp_path / "port", tmp_path / "jax", "*.jpg")
    got = list(video_lib.iter_frames(mp4, fps))
    ref = list(jax_video.iter_frames(mp4, fps))
    assert len(got) == n and all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_load_frames_matches_jax(mp4, tmp_path, cv2_only):
    from pose3d_tpu.pipeline import video as jax_video

    video_lib.extract_frames(mp4, tmp_path / "f", fps=100)
    for size in (None, 32):
        f32 = video_lib.load_frames(tmp_path / "f", size=size)
        u8 = video_lib.load_frames(tmp_path / "f", size=size, dtype=np.uint8)
        assert f32.dtype == np.float32 and u8.dtype == np.uint8 and len(u8) == 12
        np.testing.assert_array_equal(f32, jax_video.load_frames(tmp_path / "f", size=size))
        np.testing.assert_array_equal(
            u8, jax_video.load_frames(tmp_path / "f", size=size, dtype=np.uint8))
        np.testing.assert_array_equal(u8.astype(np.float32) / 256.0, f32)
    assert video_lib.load_frames(tmp_path / "empty").shape == (0, 0, 0, 3)


def test_run_ffmpeg_writes_the_reduced_video(mp4, tmp_path, cv2_only):
    video_lib.run_ffmpeg(["clip.mp4"], mp4.parent, tmp_path / "frames", tmp_path / "reduced",
                         fps=5)
    assert len(list((tmp_path / "frames" / "clip.mp4").glob("*.jpg"))) == 6
    assert len(list(video_lib.iter_frames(tmp_path / "reduced" / "clip.mp4_fps.mp4"))) == 6


def test_process_video_matches_jax(mp4, tmp_path):
    """MockDetector + a small f32 TemporalLifter: the staged layout and the
    poses of the JAX ``process_video``."""
    import shutil

    from pose3d_tpu.pipeline.detector import MockDetector as JaxMock
    from pose3d_tpu.pipeline.run import process_video as jax_process

    fmodel, params = flax_temporal(seed=0, **TEMPORAL)
    model = torch_temporal(params, **TEMPORAL)
    jax_root = tmp_path / "jax"
    shutil.copytree(mp4.parent, jax_root / "raw_videos")
    want = jax_process("clip.mp4", jax_root, JaxMock(), fmodel, params, fps=100)
    got = run_lib.process_video("clip.mp4", mp4.parent.parent, MockDetector(), model, fps=100)
    assert got.shape == want.shape == (12, 17, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    root = mp4.parent.parent
    np.testing.assert_allclose(np.load(root / "MB_npy" / "clip.mp4.npy"),
                               np.load(jax_root / "MB_npy" / "clip.mp4.npy"), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.load(root / "MB_npy" / "clip.mp4.npy"), got)
    assert (root / "final_json_outputs" / "clip.mp4.json").read_bytes() == \
        (jax_root / "final_json_outputs" / "clip.mp4.json").read_bytes()
    assert np.abs(want).max() > 0.1
    # without a lifter: detections only, as in JAX
    assert run_lib.process_video("clip.mp4", root, MockDetector(), fps=100) is None
    # with the renders: the 2D and 3D videos, one frame a frame; the 3D one
    # is JAX's render of the same poses (S1 camera 2 to global, x2.8)
    from pose3d_tpu.utils.visualize import render_3d_video

    got = run_lib.process_video("clip.mp4", root, MockDetector(), model, fps=100, render=True)
    out2d = root / "opp_2d_frames" / "clip.mp4" / "out.mp4"
    out3d = root / "MB_3d_frames" / "clip.mp4" / "out.mp4"
    assert len(list(video_lib.iter_frames(out2d))) == len(list(video_lib.iter_frames(out3d))) == 12
    render_3d_video(got, tmp_path / "jax3d.mp4", 100, scale=2.8, to_global=True)
    assert out3d.read_bytes() == (tmp_path / "jax3d.mp4").read_bytes()
    with pytest.raises(FileNotFoundError, match="no frames"):
        run_lib.process_video("other.mp4", root, MockDetector())


def test_run_main_posenet2d_on_port_checkpoints(mp4, tmp_path, capsys):
    """``run.main`` on the CPU with a ResNet-18 PoseNet2D checkpoint and a
    default TemporalLifter checkpoint, both saved by the port."""
    from pose3d_tpu_torch.models.heads import PoseNet2D
    from pose3d_tpu_torch.models.temporal import TemporalLifter
    from pose3d_tpu_torch.pipeline.lift import lift_video_json
    from pose3d_tpu_torch.train import checkpoint as ckpt
    from pose3d_tpu_torch.train.state import create_train_state

    logs = tmp_path / "logs"
    det = PoseNet2D("resnet18", device="cpu").init_weights(torch.Generator().manual_seed(1))
    ckpt.save(create_train_state(det, lr=1e-3), logs, "det",
              extra={"architecture": "resnet18", "bf16": False})
    lifter = TemporalLifter(device="cpu").init_weights(torch.Generator().manual_seed(2))
    ckpt.save(create_train_state(lifter, lr=1e-3), logs, "lift")
    root = mp4.parent.parent
    argv = ["--video", "clip.mp4", "--root", str(root), "--cpu", "--detector", "posenet2d",
            "--log_dir", str(logs), "--fps", "100"]
    run_lib.main(argv + ["--detector_checkpoint", "det", "--lifter_checkpoint", "lift"])
    out = capsys.readouterr().out
    assert "detector restored from det (resnet18" in out and "lifter restored from lift" in out
    assert out.rstrip().endswith("___DONE___")
    assert len(list((root / "opp_outputs" / "clip.mp4" / "jsons_force").glob("*.json"))) == 12
    final = root / "final_json_outputs" / "clip.mp4.json"
    records = json.loads(final.read_text())
    assert len(records) == 12 and all(r["score"] == 1.0 for r in records)
    kp = np.asarray([r["keypoints"] for r in records])
    assert kp.shape == (12, 17, 3) and (kp[..., 2] == 1.0).all()
    assert 0.0 <= kp[..., :2].min() and kp[..., :2].max() <= 1000.0
    poses = np.load(root / "MB_npy" / "clip.mp4.npy")
    assert poses.shape == (12, 17, 3) and np.isfinite(poses).all()
    want = lift_video_json(run_lib.build_lifter(logs, "lift", "cpu"), final,
                           tmp_path / "again.npy")
    np.testing.assert_array_equal(poses, want)

    run_lib.main(argv + ["--detector_checkpoint", "nope", "--lifter_checkpoint", "nope"])
    out = capsys.readouterr().out
    assert "detector checkpoint nope not found; using fresh init" in out
    assert "lifter checkpoint not found; using fresh init" in out
    # --render with the mock detector and the lifter: both videos
    run_lib.main(argv[:2] + ["--root", str(root), "--cpu", "--render", "--log_dir", str(logs),
                             "--lifter_checkpoint", "lift"])
    for video in ("opp_2d_frames", "MB_3d_frames"):
        assert len(list(video_lib.iter_frames(root / video / "clip.mp4" / "out.mp4"))) == 12


def test_run_main_defaults_to_the_card(mp4):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="pass --cpu"):
        run_lib.main(["--video", "clip.mp4", "--root", str(mp4.parent.parent)])


STUB = '''\
import json, os, pathlib, sys

args = sys.argv[1:]
frames = [a for a in args if a.endswith(".jpg")]
flags = args[len(frames):]
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps({"frames": frames, "flags": flags}) + "\\n")
out = pathlib.Path(flags[flags.index("--json-output") + 1])
for i, frame in enumerate(frames):
    kp = [[100.0 + 10 * j + i, 200.0 + 5 * j, 0.9] for j in range(17)]
    people = [{"keypoints": sum(kp, []), "score": 0.8, "category_id": 1}]
    (out / (pathlib.Path(frame).name + ".predictions.json")).write_text(json.dumps(people))
'''


def test_openpifpaf_detector_runs_one_process_with_jax_flags(tmp_path, monkeypatch):
    from pose3d_tpu.pipeline.detector import OpenPifPafDetector as JaxPifPaf

    stub = tmp_path / "stub" / "openpifpaf"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (stub / "predict.py").write_text(STUB)
    monkeypatch.setenv("PYTHONPATH",
                       os.pathsep.join([str(stub.parent), os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("STUB_LOG", str(tmp_path / "calls.jsonl"))
    monkeypatch.setenv("PATH", os.pathsep.join([os.path.dirname(sys.executable),
                                                os.environ.get("PATH", "")]))
    frames = _frame_names(tmp_path / "frames", 7)
    OpenPifPafDetector().detect_dir(frames, tmp_path / "port")
    JaxPifPaf().detect_dir(frames, tmp_path / "jax")
    calls = [json.loads(line) for line in (tmp_path / "calls.jsonl").read_text().splitlines()]
    assert len(calls) == 2  # one process a directory, for each package
    port, jax_call = calls
    assert port["frames"] == sorted(str(p) for p in frames.glob("*.jpg")) == jax_call["frames"]
    assert port["flags"] == ["--checkpoint", "shufflenetv2k30", "--force-complete-pose",
                             "--instance-threshold", "0.2", "--json-output",
                             str(tmp_path / "port")]
    assert port["flags"][:-1] == jax_call["flags"][:-1]
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert len(kp_lib.merge_detections(tmp_path / "port")) == 7
