"""The port's data-parallel serving and trainers, on the CPU over spawned
``gloo`` ranks (``torch_dist_util.spawn``; the ranks import no JAX):
``LifterService(mesh=)`` and its fused-route gate, and the three
trainers that build a mesh (``cli/train_temporal.py``, ``train_direct.py``,
``train_loop.py``) under the launcher."""

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_dist_util import spawn

torch.set_num_threads(2)


# --- serving -------------------------------------------------------------------

def test_fused_gate_matches_the_kernels_contract():
    """The gate accepts exactly the per-shard buckets the trunk accepts
    (the port of ``tests/test_serving.py:67-94``): ``lifter_forward_fused``
    takes a whole number of ``FRAMES_PER_CTA`` frames, checked by calling
    it on the default bf16 ViT."""
    from pose3d_tpu_torch.ops import lifter as L
    from pose3d_tpu_torch.serving import fused_vit_buckets_ok

    model = cases.serve_model("vit_bf16")
    weights = L.pack_weights(model)

    def kernel_accepts(batch):
        try:
            L.lifter_forward_fused(model, torch.zeros(batch, 17, 2, dtype=torch.bfloat16),
                                   weights=weights)
            return True
        except ValueError:
            return False

    cell = L.FRAMES_PER_CTA
    accepts = {b: kernel_accepts(b) for b in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)}
    assert accepts == {b: b % cell == 0 for b in accepts}
    for n_shards in (1, 2, 4, 8):
        for bucket in (4, 8, 16, 24, 32, 64, 96, 128, 8192):
            if bucket % n_shards:
                continue
            per_shard = bucket // n_shards
            assert fused_vit_buckets_ok([bucket], n_shards) == (per_shard % cell == 0), (
                bucket, n_shards)
    # a 2-shard mesh whose smallest bucket is one kernel tile a process
    assert not fused_vit_buckets_ok([cell], 2) and fused_vit_buckets_ok([2 * cell], 2)


def test_dp_serving_equals_the_one_process_service(tmp_path):
    """ViT (the default bf16 one on the trunk route, a small f32 one on the
    module) and Martinez (the default bf16 one on the block route, a small
    f32 one), BatchNorm statistics seeded: over 2 ranks every rank answers
    the whole request, on odd request sizes (padding), one above the top
    bucket (chunks) and one below the smallest. The f32 services' answers
    are bitwise the one-process service's; the bf16 routes' plain versions
    on the CPU round their products by the batch's size (a shard holds half
    the rows), so they are held to the bf16 budget, atol 5e-2 (measured
    one or two bf16 steps, 1.6e-2)."""
    rng = np.random.default_rng(3)
    requests = {name: [rng.random((n, 17, 2)).astype(np.float32) for n in (77, 5, 1)]
                for name in cases.SERVE_MODELS}
    res = spawn(cases.dp_serving, 2, tmp_path, requests)
    for name, reqs in requests.items():
        one = cases.service(name)
        for r in res:
            got = r[name]
            assert got["fused"] == one.fused == name.endswith("bf16"), name
            assert all(b % 2 == 0 for b in got["buckets"]), got["buckets"]
            assert got["buckets"][0] == max(one.buckets[0], 2)
            for kp, out in zip(reqs, got["out"]):
                want = one.lift(kp)
                assert out.shape == want.shape == (len(kp), 17, 3)
                if name.endswith("f32"):
                    np.testing.assert_array_equal(out, want, err_msg=name)
                else:
                    np.testing.assert_allclose(out, want, atol=5e-2, rtol=0, err_msg=name)


# --- the trainer under the launcher ---------------------------------------------

CLIS = {  # module: (argv, the run's files)
    "train_temporal": (["--n_blocks", "1", "--clip_len", "12", "--batch_size", "5",
                        "--data.synthetic_frames", "480"], ("t1",)),
    "train_direct": (["--architecture", "resnet18", "--image_size", "32", "--batch_size", "4",
                      "--chunk_steps", "2", "--data.synthetic_frames", "16", "--bf16", "false"],
                     ("t1",)),
    "train_loop": (["--architecture", "resnet18", "--image_size", "32", "--batch_size", "4",
                    "--data.synthetic_frames", "16", "--bf16", "false", "--triangle", "true",
                    "--flip", "true"], ("t1_2d", "t1_3d")),
}


@pytest.mark.parametrize("module", sorted(CLIS))
def test_trainer_under_the_launcher(tmp_path, module):
    """The three trainers that build a mesh, for one epoch on 2 ranks (CPU,
    toy sizes; the temporal batch of 5 trimmed to 4): both ranks'
    parameters bitwise equal, and only rank 0 wrote the log and the
    checkpoints."""
    import json

    argv, runs = CLIS[module]
    argv = ["--cpu", *argv, "--n_epochs", "1", "--log_dir", "logs/t", "--run_name", "t1"]
    res = spawn(cases.cli_main, 2, tmp_path, module, argv, str(tmp_path / "cwd"))
    for k, v in res[1]["sd"].items():
        np.testing.assert_array_equal(v, res[0]["sd"][k], err_msg=k)
    assert res[1]["files"] == []
    assert res[0]["bound"] == res[1]["bound"] == []  # BatchNorms local again after main
    written = set(res[0]["files"])
    assert "logs/t/runs/t1.jsonl" in written
    for run in runs:
        assert {f"logs/t/models/{run}", f"logs/t/models/{run}.meta.json"} <= written
    records = [json.loads(line) for line in
               (tmp_path / "cwd" / "rank0" / "logs/t/runs/t1.jsonl").read_text().splitlines()]
    assert [r.get("event", "epoch") for r in records] == ["config", "epoch", "finish"]
    assert all(np.isfinite(records[1][k]) for k in ("train_loss", "val_loss", "val_mpjpe"))
