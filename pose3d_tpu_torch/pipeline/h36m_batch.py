"""Batched 2D detection over Human3.6M frame trees: the port of
``pose3d_tpu/pipeline/h36m_batch.py``.

The reference (``phase2_opp_mb/run.py:354-393`` ``run_openpifpaf_H36``)
walks ``<data>/videos/<S>/outputVideos/<action>/`` and runs a detector
process a frame, then merges each action's JSONs into
``final_json_outputs/<S>/<action>.json`` (``:395-447``). Here the detector
takes one call an action directory; the layout and the JSON are the same.
"""

from __future__ import annotations

import pathlib

from pose3d_tpu_torch.pipeline.keypoints import save_to_json


def detect_h36m_tree(data_root, out_root, detector, subjects=("S1",),
                     already_h36m: bool = False) -> list[pathlib.Path]:
    """Detect every action directory of every subject, writing the
    per-frame JSONs under ``out_root/opp_outputs/<S>/<action>/`` and the
    consolidated ones under ``out_root/final_json_outputs/<S>/``; returns
    the consolidated paths written."""
    data_root, out_root = pathlib.Path(data_root), pathlib.Path(out_root)
    written = []
    for s in subjects:
        subject_dir = data_root / "videos" / s / "outputVideos"
        if not subject_dir.exists():
            print(f"{subject_dir} not a directory")
            continue
        for action_dir in sorted(p for p in subject_dir.iterdir() if p.is_dir()):
            jsons_dir = out_root / "opp_outputs" / s / action_dir.name
            detector.detect_dir(action_dir, jsons_dir)
            final = out_root / "final_json_outputs" / s / f"{action_dir.name}.json"
            save_to_json(jsons_dir, final, already_h36m)
            written.append(final)
            print(f"{s}/{action_dir.name}: -> {final}")
    return written
