"""Rules of the PyTorch port that no parity test sees.

- ``pose3d_tpu_torch`` runs where JAX is absent: importing it pulls in no
  ``jax``, ``flax`` or ``pose3d_tpu`` (checked in a fresh interpreter,
  since ``tests/conftest.py`` imports JAX into this one), and no ``cv2``
  or ``matplotlib``, which the GPU host lacks.
- Its kernels are built from the repository's own CUDA sources with
  ``nvcc`` for ``sm_90a`` and bound through ctypes, call no kernel
  library, and every launcher reports CUDA errors to the caller.
- Importing a module builds nothing.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "pose3d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pose3d_tpu")
# the package's own sources, not what a build or a run left in _build/
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts)


def _top(name: str) -> str:
    return name.split(".")[0]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import pose3d_tpu_torch, pose3d_tpu_torch.serving\n"
        "import pose3d_tpu_torch.interop.weights, pose3d_tpu_torch.models.temporal\n"
        "import pose3d_tpu_torch.ops.stblock, pose3d_tpu_torch.ops.attention\n"
        "import pose3d_tpu_torch.ops.martinez, pose3d_tpu_torch.models.lifters\n"
        "import pose3d_tpu_torch.pipeline.lift, pose3d_tpu_torch.pipeline.keypoints\n"
        "import pose3d_tpu_torch.ops.stblock_train, pose3d_tpu_torch.cli.train_temporal\n"
        "import pose3d_tpu_torch.train.checkpoint, pose3d_tpu_torch.train.logging\n"
        "import pose3d_tpu_torch.models.resnet, pose3d_tpu_torch.models.heads\n"
        "import pose3d_tpu_torch.ops.softargmax, pose3d_tpu_torch.ops.conv_decode\n"
        "import pose3d_tpu_torch.train.image_steps, pose3d_tpu_torch.config\n"
        "import pose3d_tpu_torch.cli.train_direct, pose3d_tpu_torch.data.video_dataset\n"
        "import pose3d_tpu_torch.train.epoch, pose3d_tpu_torch.train.debug\n"
        "import pose3d_tpu_torch.cli.train_lift, pose3d_tpu_torch.cli.predict\n"
        "import pose3d_tpu_torch.data.h36m, pose3d_tpu_torch.data.stats\n"
        "import pose3d_tpu_torch.core.quaternion, pose3d_tpu_torch.core.transforms\n"
        "import pose3d_tpu_torch.pipeline.video, pose3d_tpu_torch.pipeline.detector\n"
        "import pose3d_tpu_torch.pipeline.h36m_batch, pose3d_tpu_torch.data.native_build\n"
        "import pose3d_tpu_torch.data.native_loader, pose3d_tpu_torch.data.native_video\n"
        "import pose3d_tpu_torch.train.loop_steps, pose3d_tpu_torch.cli.train_loop\n"
        "import pose3d_tpu_torch.cli.train_detector, pose3d_tpu_torch.cli.train_project\n"
        "import pose3d_tpu_torch.core.affine, pose3d_tpu_torch.models.smpl\n"
        "import pose3d_tpu_torch.models.hybrik, pose3d_tpu_torch.models.smpl_pose\n"
        "import pose3d_tpu_torch.train.smpl_steps, pose3d_tpu_torch.utils\n"
        "import pose3d_tpu_torch.utils.visualize, pose3d_tpu_torch.parallel.mesh\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
        "print('cv2' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    bad, cv2 = proc.stdout.split("\n")[:2]
    assert bad == "", f"imported: {bad}"
    # the GPU host has no OpenCV: only the functions that decode import it
    assert cv2 == "False"


def test_renders_import_no_matplotlib():
    """The GPU host has no matplotlib: ``utils/visualize.py``, the pipeline
    entry point and the phase-1 trainer (which import the renders only to
    draw) load none of it, nor cv2."""
    code = ("import sys\n"
            "import pose3d_tpu_torch.utils.visualize, pose3d_tpu_torch.pipeline.run\n"
            "import pose3d_tpu_torch.cli.train_lift, pose3d_tpu_torch.train.logging\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'cv2', 'wandb')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_pipeline_entry_point_imports_neither_jax_nor_cv2():
    """``python -m pose3d_tpu_torch.pipeline.run`` starts on a host without
    JAX or OpenCV (the native decoder or cv2 is needed only to decode)."""
    code = ("import sys\n"
            "import pose3d_tpu_torch.pipeline.run\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('cv2',)!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_native_sources_are_the_ports_own():
    """The port builds its own copies of the native sources into its own
    directory: its build script and bindings name no path of the JAX
    package, and the C++ is the JAX package's code, only the comments
    differ."""
    native = PKG / "native"
    assert sorted(p.name for p in native.iterdir() if not p.name.endswith(".so")) == \
        ["build.sh", "loader.cc", "video.cc"]
    for path in [*native.glob("*.sh"), *native.glob("*.cc"),
                 *(PKG / "data").glob("native_*.py")]:
        assert "pose3d_tpu/" not in path.read_text(), path.name
    from pose3d_tpu_torch.data import native_build, native_loader, native_video

    assert native_build.NATIVE_DIR == native
    assert native_loader._SO_PATH.parent == native_video._SO_PATH.parent == native

    def code(text):
        return [line for line in text.splitlines() if not line.lstrip().startswith("//")]

    for name in ("loader.cc", "video.cc"):
        assert code((native / name).read_text()) == \
            code((REPO / "pose3d_tpu" / "native" / name).read_text()), name


@pytest.mark.parametrize("path", SOURCES + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert _top(name) not in FORBIDDEN, f"{path.name} imports {name}"


CUDA_SOURCES = sorted((PKG / "csrc").glob("*.cu"))
LAUNCHERS = {
    "lifter_trunk.cu": ["lifter_trunk_launch"],
    "attention.cu": ["attention_launch"],
    "stblock.cu": ["stblock_temporal_launch", "stblock_sequences_launch"],
    "stblock_train.cu": ["stblock_train_bwd_launch"],
    "martinez.cu": ["martinez_launch"],
    "softargmax.cu": ["softargmax_nhwc_launch", "softargmax_nhwc_bwd_launch",
                      "softargmax_volume_launch"],
    "conv_decode.cu": ["conv_decode_launch"],
    "conv_decode_bwd.cu": ["conv_decode_bwd_launch"],
    "flash_attention.cu": ["flash_fwd_launch", "flash_bwd_dq_launch", "flash_bwd_dkv_launch"],
    "dstformer.cu": ["dstformer_ln_qkv_launch", "dstformer_proj_residual_launch",
                     "dstformer_ln_fc1_gelu_launch", "dstformer_fc2_residual_launch",
                     "dstformer_attention_launch"],
}


def test_kernel_build_is_nvcc_for_sm90a_from_repo_sources():
    from pose3d_tpu_torch.ops import _build

    assert _build.CSRC == PKG / "csrc"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == PKG / "_build"
    assert _build.library_path().parent == _build.BUILD_DIR
    assert sorted(p.name for p in CUDA_SOURCES) == sorted(LAUNCHERS)
    gitignore = (REPO / ".gitignore").read_text().splitlines()
    assert "pose3d_tpu_torch/_build/" in gitignore


def _with_local_headers(path: Path) -> str:
    """A source and, recursively, the package's headers it includes."""
    seen, todo, text = set(), [path], []
    while todo:
        p = todo.pop()
        if p in seen or not p.exists():
            continue
        seen.add(p)
        src = p.read_text()
        text.append(src)
        todo += [p.parent / line.split('"')[1] for line in src.splitlines()
                 if line.startswith('#include "')]
    return "\n".join(text)


@pytest.mark.parametrize("path", CUDA_SOURCES + sorted((PKG / "csrc").glob("*.cuh")),
                         ids=lambda p: p.name)
def test_kernel_source_calls_no_library(path):
    """Hand-written kernels: no cuBLAS, cuDNN or CUTLASS device GEMM, and
    every C launcher returns the launch's error to the caller (from its
    source or the launch helpers of a header it includes)."""
    src = path.read_text()
    for lib_call in ("cublas", "cudnn", "cutlass::gemm::device", "scaled_dot_product"):
        assert lib_call not in src.lower()
    for name in LAUNCHERS.get(path.name, []):
        assert f'extern "C" cudaError_t {name}(' in src
    if path.suffix == ".cu":
        assert "return cudaGetLastError();" in _with_local_headers(path)


# The kernels redesigned for the H100 after their first versions: each
# header still names the TPU kernels it replaces, states its bound at the
# main path's shape and the bytes a call moves there, and says what the
# design does about them.
REDESIGNED = {
    "stblock.cu": ("pallas_stblock.py", "_spatial_kernel", "_temporal_slab_kernel",
                   "_temporal_kernel", "_spatial_fwd_kernel", "_temporal_slab_fwd_kernel",
                   "What bounds it on this card", "104 GFLOP", "0.37 GB",
                   "230,448 bytes", "230,464 bytes", "does not fit", "rowtile_sm90.cuh"),
    "attention.cu": ("pallas_attention.py", "_packed_kernel", "_seq_kernel",
                     "What bounds it on this card", "0.040 ms", "101.5 MB",
                     "Q never enters shared memory", "cp.async", "kAttnSplitLen",
                     "64-query wgmma tiles fed by TMA", "persistent CTA", "mbarrier ring",
                     "3-D map", "4-D map", "Rows past L arrive as zeros", "transpose flag",
                     "nothing is rescaled", "No atomics", "bitwise equal"),
    "stblock_train.cu": ("pallas_stblock_train.py", "_spatial_bwd_kernel",
                         "_temporal_bwd_kernel", "_temporal_slab_bwd_kernel",
                         "What bounds it on this card", "0.313", "2.25 GB", "2.27 GB",
                         "3.57 GB", "registers or shared memory", "wgmma", "TMA",
                         "mbarrier ring", "transpose flag", "persistent", "kWgradItems",
                         "mma.sync", "two CTAs share an SM", "No atomics",
                         "Four consumer warpgroups in two pairs", "one accumulator pair each",
                         "four warps a", "16 bytes a lane"),
    "lifter_trunk.cu": ("pallas_lifter.py", "_trunk_kernel", "What bounds it on this card",
                        "438 GFLOP", "0.443 ms", "6.44 GB", "1.9 GB", "double LN",
                        "subblock_sm90.cuh", "rowtile_sm90.cuh", "persistent grid"),
    "conv_decode_bwd.cu": ("pallas_conv_decode.py", "_bwd_kernel",
                           "What bounds it on this card", "146 GFLOP", "0.443 ms", "0.59 ms",
                           "557 KB", "wgmma", "TMA", "transpose flag", "no atomics"),
    "conv_decode.cu": ("pallas_conv_decode.py", "_fwd_kernel", "What bounds it on this card",
                       "146 GFLOP", "0.148 ms", "wgmma", "TMA", "issue_logits",
                       "persistent CTA", "bitwise these logits",
                       "while the other warpgroup's product runs", "fixed order", "no atomics",
                       "mma.sync", "0.92 ms"),
    "martinez.cu": ("pallas_martinez.py", "_block_kernel", "fused_residual_block",
                    "What bounds it on this card", "34.4 GFLOP", "0.035 ms", "~88 MB",
                    "0.026 ms", "The L2 stream", "11.5 TB/s", "multicast",
                    "Why h goes through device memory", "128 KB", "0.5 GB", "wgmma", "TMA",
                    "transpose flag", "persistent grid", "rowtile_sm90.cuh", "mma.sync",
                    "0.128 ms", "No atomics"),
    "softargmax.cu": ("pallas_softargmax.py", "_kernel_nhwc_fwd", "_kernel_nhwc_pair_fwd",
                      "What bounds it on this card", "570 MB", "persistent grid",
                      "16-byte cp.async copies in flight a thread", "cp.async.wait_group",
                      "no barrier couples", "shuffle tree", "fixed order", "no atomics",
                      "0.369 ms"),
}


@pytest.mark.parametrize("name", sorted(REDESIGNED))
def test_redesigned_kernel_keeps_its_header_note(name):
    src = (PKG / "csrc" / name).read_text()
    header = " ".join(line.removeprefix("//").strip()
                      for line in src[:src.index("#include")].splitlines())
    assert "Replaces" in header
    for phrase in REDESIGNED[name]:
        assert phrase in header, phrase



def test_long_sequences_take_the_wgmma_attention():
    """csrc/attention.cu: a sequence longer than the split length takes
    attention_wg_kernel, wgmma on attention_sm90.cuh's head tiles fed by
    TMA (3-D and 4-D maps) through rowtile_sm90.cuh's ring, an item's first
    S issued beside the last item's last P V; mma.sync, ldmatrix and
    cp.async stay in attention_kernel (L <= the split) alone; the split is
    one constant, the same in attention.cuh and ops/attention.py; no source
    keeps a copy of the head-tile descriptors or the ring of its own."""
    from pose3d_tpu_torch.ops import attention as A

    csrc = PKG / "csrc"
    src = (csrc / "attention.cu").read_text()
    assert f"constexpr int kAttnSplitLen = {A.SPLIT_LEN};" in (csrc / "attention.cuh").read_text()
    assert "if (L > kAttnSplitLen) {" in src and '#include "attention_sm90.cuh"' in src
    split = src.index("// " + "-" * 48 + " L > kAttnSplitLen")
    short = src[src.index("#include"):split]
    wide = src[split:src.index("namespace pose3d {\n\ncudaError_t launch_attention(")]
    for old in ("mma_bf16(", "ldsm_x4", "cp_async", "ldmatrix", "mma.sync", "__ldg"):
        assert old not in wide, old
    for used in ("mma_bf16(", "ldsm_x4_trans(", "cp_async16("):
        assert used in short, used
    for used in ("attn::issue_scores<DH, kN>(", "attn::issue_rows<DH, kN>(", "attn::to_frags<kN>(",
                 "attn::issue_scores<DH, kN>(s, dn, kn);  // the next item's first S",
                 "rt::tma_load3(", "rt::tma_load4(", "ring.acquire()", "ring.claim(",
                 "slots.claim(", "rt::regs_dec", "rt::regs_inc", "attn::head_box_map<DH>(",
                 "t += gridDim.x", "__grid_constant__ CUtensorMap"):
        assert used in wide, used
    with_headers = _with_local_headers(csrc / "attention.cu")
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor.3d", "cp.async.bulk.tensor.4d",
                  "mbarrier.try_wait"):
        assert instr in with_headers, instr
    assert "atomicAdd" not in src and "atom." not in src and "red.global" not in src
    for name in ("attention.cu", "flash_attention.cu", "stblock_train.cu"):
        text = (csrc / name).read_text()
        for copy in ("uint64_t head_desc(", "void wgmma_rs_n", "struct Ring", "void mbar_init("):
            assert copy not in text, (name, copy)

def test_sub_block_backward_products_run_on_wgmma():
    """csrc/stblock_train.cu: every product but the attention backward's
    runs on rowtile_sm90.cuh's wgmma fed by TMA (the recomputed qkv on the
    forward's qkv_kernel); no cp.async ring or ldmatrix GEMM is left."""
    src = (PKG / "csrc" / "stblock_train.cu").read_text()
    assert '#include "subblock_sm90.cuh"' in src
    for used in ("rt::wgmma_m64n256<", "rt::wgmma_m64n64<0, 0>", "rt::tma_load(",
                 "rt::Ring<", "sb::launch_qkv<", "kWgradItems",
                 "constexpr int kMlpThreads = kMlpPairs * rt::kConsumers * 128;"):
        assert used in src, used
    for gone in ("cp_async", "load_stage", "kTargetCtas"):
        assert gone not in src, gone
    # mma.sync stays in the attention backward only
    body = src[src.index("-- attention backward"):]
    assert src.count("mma_bf16(") == body.count("mma_bf16(")


def test_rowtile_engine_header():
    """The sub-block forwards' and the lifter trunk's engine
    (csrc/rowtile_sm90.cuh): its note says what it is and what it replaces;
    it is wgmma on TMA-loaded weight chunks behind mbarriers with a producer
    warp, and nothing of JAX; the sub-block kernels and the trunk run on it
    (through csrc/subblock_sm90.cuh, which both include), the conv-decode
    backward's products are wgmma on TMA-loaded operands, and common.cuh's
    80-row engine is gone."""
    src = (PKG / "csrc" / "rowtile_sm90.cuh").read_text()
    note = " ".join(line.removeprefix("//").strip()
                    for line in src[:src.index("#pragma once")].splitlines())
    for phrase in ("row-tile engine", "common.cuh's 80-row engine", "producer warpgroup",
                   "setmaxnreg", "TMA", "mbarrier", "wgmma", "transpose flag"):
        assert phrase in note, phrase
    for instr in ("cp.async.bulk.tensor.2d", "wgmma.mma_async", "mbarrier.try_wait",
                  "setmaxnreg.dec", "setmaxnreg.inc", "cudaGetDriverEntryPoint"):
        assert instr in src, instr
    assert "jax" not in src.lower() and "pose3d_tpu/" not in src
    csrc = PKG / "csrc"
    assert '#include "rowtile_sm90.cuh"' in (csrc / "subblock_sm90.cuh").read_text()
    for name in ("stblock.cu", "lifter_trunk.cu"):
        assert '#include "subblock_sm90.cuh"' in (csrc / name).read_text(), name
    for name in ("stblock.cu", "lifter_trunk.cu", "subblock_sm90.cuh", "common.cuh"):
        text = (csrc / name).read_text()
        for old_engine in ("mma_pass", "WeightStream", "mlp_residual", "attend_row"):
            assert old_engine not in text, (name, old_engine)
    bwd = (csrc / "conv_decode_bwd.cu").read_text()
    assert '#include "rowtile_sm90.cuh"' in bwd
    assert "rt::wgmma_m64n" in bwd and "rt::tma_load3" in bwd
    bwd_all = _with_local_headers(csrc / "conv_decode_bwd.cu")
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait"):
        assert instr in bwd_all, instr
    assert "mma_bf16(" not in bwd and "atomicAdd" not in bwd


def test_decode_forwards_are_wgmma_and_cp_async_rings():
    """Kernel 13a computes its logits on wgmma fed by TMA, with the
    backward's own product (conv_decode.cuh issue_logits, which both
    sources call), and nothing of the first version's ldmatrix + mma.sync
    engine is left in it or its header; kernel 11a streams its logits
    through each thread's own ring of cp.async copies; neither uses
    atomics."""
    csrc = PKG / "csrc"
    fwd = (csrc / "conv_decode.cu").read_text()
    head = (csrc / "conv_decode.cuh").read_text()
    for text in (fwd, head):
        for old in ("mma_bf16(", "ldsm_x4", "cp_async16", "slab_logits", "LogitAcc",
                    "kDecodeWarps", "kLd"):
            assert old not in text, old
    assert "rt::wgmma_m64n" in fwd + head
    assert "rt::wgmma_m64n64<0, 0>(" in head
    for name in ("conv_decode.cu", "conv_decode_bwd.cu"):
        assert "issue_logits(" in (csrc / name).read_text(), name
    fwd_all = _with_local_headers(csrc / "conv_decode.cu")
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor.3d", "mbarrier.try_wait"):
        assert instr in fwd_all, instr
    assert "rt::tma_load3" in head and "load_feature_tile(" in fwd
    soft = (csrc / "softargmax.cu").read_text()
    start = soft.index("nhwc_stream_kernel(const T*")
    kernel = soft[start:soft.index("bwd_kernel(const T*", start)]
    assert "cp_async16(" in soft and "cp_async_wait<kFwdDepth - 1>()" in kernel
    assert "tile_kernel(" not in soft.replace("volume_tile_kernel(", "")
    for text in (fwd, head, soft):
        assert "atomicAdd" not in text and "atom." not in text and "red.global" not in text


def test_martinez_block_is_wgmma_fed_by_tma():
    """Row 2 (csrc/martinez.cu) runs its two GEMMs on wgmma fed by TMA
    through an mbarrier ring of its own stage size, on rowtile_sm90.cuh's
    primitives; nothing of the first version's ldmatrix + mma.sync +
    cp.async engine is left in its code; it uses no atomics; its row width
    is the wrapper's."""
    from pose3d_tpu_torch.ops import martinez as M

    csrc = PKG / "csrc"
    src = (csrc / "martinez.cu").read_text()
    code = src[src.index("#include"):]
    assert '#include "rowtile_sm90.cuh"' in src
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor.2d", "mbarrier.try_wait",
                  "setmaxnreg.dec", "setmaxnreg.inc"):
        assert instr in _with_local_headers(csrc / "martinez.cu"), instr
    for old in ("mma_bf16(", "ldsm_x4", "cp_async16(", "cp_async_wait", "cp_async_commit",
                "ldmatrix", "mma.sync"):
        assert old not in code, old
    for used in ("rt::wgmma_m64n256(", "rt::tma_load(", "rt::tma_store(", "rt::Ring<",
                 "rt::regs_dec<", "rt::regs_inc<", "rt::swz(", "__grid_constant__ CUtensorMap",
                 "tile_map(", "t += gridDim.x"):
        assert used in code, used
    assert "atomicAdd" not in src and "atom." not in src and "red.global" not in src
    assert f"constexpr int kWidth = {M.WIDTH};" in src
    # the ring's stage size is a parameter whose default the other users keep
    rowtile = (csrc / "rowtile_sm90.cuh").read_text()
    assert "template <int kStages, int kBytes = kStageBytes>\nstruct Ring {" in rowtile


def _layout_offsets(src: str) -> list[str]:
    return [line.split("constexpr int ")[1].split(" =")[0]
            for line in src.splitlines() if line.startswith("constexpr int kOff")]


def _offset_names(layout) -> list[str]:
    return ["kOff" + "".join(p.capitalize() for p in name.split("_"))
            for name, *_ in layout]


@pytest.mark.parametrize("kernel", ["lifter", "stblock", "stblock_train", "martinez",
                                    "softargmax", "conv_decode"])
def test_kernel_constants_match_the_wrapper(kernel):
    """The .cu file's tile and layout constants are the Python wrapper's
    (the launchers refuse a mismatch at run time; this catches it here)."""
    from pose3d_tpu_torch.ops import attention as A
    from pose3d_tpu_torch.ops import conv_decode as CD
    from pose3d_tpu_torch.ops import lifter as L
    from pose3d_tpu_torch.ops import martinez as M
    from pose3d_tpu_torch.ops import softargmax as SA
    from pose3d_tpu_torch.ops import stblock as S

    if kernel == "softargmax":
        src = (PKG / "csrc" / "softargmax.cu").read_text()
        assert f"constexpr int kTilePixels = {SA.TILE_PIXELS};" in src
        assert f"constexpr int kVolumeTileBytes = {SA.VOLUME_TILE_BYTES};" in src
        head = (PKG / "csrc" / "softargmax.cuh").read_text()
        assert "constexpr int kPartial = 5;" in head  # the wrappers' (..., 5) partials
    elif kernel == "conv_decode":  # the tiling both conv-decode sources include
        src = (PKG / "csrc" / "conv_decode.cuh").read_text()
        assert f"constexpr int kTilePixels = {CD.TILE_PIXELS};" in src
        assert f"constexpr int kFeat = {CD.FEATURES};" in src
        assert f"constexpr int kDepth = {CD.DEPTH};" in src
        fwd = (PKG / "csrc" / "conv_decode.cu").read_text()
        assert f"constexpr int kMaxJoints = {CD.MAX_JOINTS};" in fwd
        bwd = (PKG / "csrc" / "conv_decode_bwd.cu").read_text()
        assert f"constexpr int kChunkPixels = {CD.CHUNK_PIXELS};" in bwd
    elif kernel == "martinez":
        src = (PKG / "csrc" / "martinez.cu").read_text()
        assert f"constexpr int kWidth = {M.WIDTH};" in src
    elif kernel == "stblock_train":
        from pose3d_tpu_torch.ops import stblock_train as ST

        src = (PKG / "csrc" / "stblock_train.cu").read_text()
        assert f"constexpr int kHeads = {S.HEADS};" in src
        assert (f"enum Layout {{ kSpatial = {ST.LAYOUT_SPATIAL}, kSlab = {ST.LAYOUT_SLAB}, "
                f"kSequences = {ST.LAYOUT_SEQUENCES} }};") in src
        assert f"constexpr int kBwdMaxLen = {ST.BWD_MAX_LEN};" in src
        assert _layout_offsets(src) == _offset_names(S._LAYOUT)
    elif kernel == "lifter":
        src = (PKG / "csrc" / "lifter_trunk.cu").read_text()
        assert f"constexpr int kFrames = {L.FRAMES_PER_CTA};" in src
        assert f"constexpr int kHeads = {L.HEADS};" in src
        assert _layout_offsets(src) == _offset_names(L._BLOCK_LAYOUT)
    else:
        src = (PKG / "csrc" / "stblock.cu").read_text()
        assert f"constexpr int kHeads = {S.HEADS};" in src
        assert _layout_offsets(src) == _offset_names(S._LAYOUT)
        head = (PKG / "csrc" / "attention.cuh").read_text()
        assert "return size_t(2) * attn_rows(seq) * attn_ld(dh) * 2;" in head
        assert "constexpr int attn_ld(int dh) { return dh + 8; }" in head
        assert "constexpr int attn_rows(int seq) { return (seq + 15) / 16 * 16; }" in head
        common = (PKG / "csrc" / "common.cuh").read_text()
        assert f"constexpr int kSmemLimit = {A.SMEM_LIMIT};" in common
        for dh in A.HEAD_DIMS:
            assert f"case {dh}: return launch_dh<{dh}>" in (
                PKG / "csrc" / "attention.cu").read_text()


def test_import_builds_nothing(tmp_path):
    code = (
        "import pose3d_tpu_torch.ops._build as b, pose3d_tpu_torch.serving\n"
        "print(b.library.cache_info().currsize)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0"


def test_missing_nvcc_raises(monkeypatch):
    from pose3d_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_dstformer_sub_blocks_are_their_own_gemm_plan():
    """csrc/dstformer.cu: its note says it replaces no TPU kernel, what
    bounds it and what the design does about it; its products are wgmma
    fed by TMA on rowtile_sm90.cuh's primitives with the weights taken
    K-major as they lie, LayerNorm in the prologue, bias, GELU and residual
    in the epilogue; the attention is attention.cu's launch_attention; it
    takes nothing of the 256-wide engine (subblock_sm90.cuh) and bakes in
    the wrapper's widths and eps; no atomics."""
    from pose3d_tpu_torch.ops import dstformer as D

    csrc = PKG / "csrc"
    src = (csrc / "dstformer.cu").read_text()
    header = " ".join(line.removeprefix("//").strip()
                      for line in src[:src.index("#include")].splitlines())
    for phrase in ("Replaces no TPU kernel", "What bounds it on this card", "277 GFLOP",
                   "0.280 ms", "1.12 GB", "0.335 ms", "no HBM pass of its own",
                   "subblock_sm90.cuh", "rowtile_sm90.cuh", "persistent", "resident A tile",
                   "named barriers", "epilogue runs under the other's products", "exact erf",
                   "4-D TMA map", "neither layout is ever transposed", "No atomics",
                   "bitwise equal"):
        assert phrase in header, phrase
    code = src[src.index("#include"):]
    assert '#include "rowtile_sm90.cuh"' in code and '#include "attention.cuh"' in code
    assert "subblock_sm90.cuh" not in code
    for used in ("rt::wgmma_m64n128<0, 0>(", "rt::tma_load(", "rt::Ring<", "rt::regs_dec<",
                 "rt::regs_inc<", "__grid_constant__ CUtensorMap", "pose3d::tile_map(",
                 "pose3d::launch_attention(", "t += gridDim.x", "erff(", "layer_norm_tile("):
        assert used in code, used
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor.2d", "mbarrier.try_wait",
                  "setmaxnreg.dec"):
        assert instr in _with_local_headers(csrc / "dstformer.cu"), instr
    assert "atomicAdd" not in src and "atom." not in src and "red.global" not in src
    assert f"constexpr int kWidth = {D.WIDTH};" in code
    assert f"constexpr int kHeads = {D.HEADS};" in code
    assert f"constexpr float kEps = {D.LN_EPS:.0e}f;".replace("e-06", "e-6") in code
