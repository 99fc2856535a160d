"""Chip smoke test of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Drives the port's serving paths, its training paths, the joint-major and
legacy entry points, the video pipeline, the phase-5 trainers, the
SMPL-IK family, the parallel layers and the long-clip path on one NVIDIA
GPU (Hopper,
sm_90a), with random weights from a seed, and fails (non-zero exit,
traceback) if any phase fails:

1. device: the card's name and power limit;
2. build: nvcc builds the kernels from ``pose3d_tpu_torch/csrc`` (one
   process per source, side by side); prints ptxas' register and spill
   lines.

The lifter path, the default JointTransformerLifter (the reference MyViT:
17 tokens, hidden 256, 2 blocks, 4 heads, bf16):

3. kernel vs plain: the trunk kernels against ``trunk_reference`` at B=64
   and B=8192 on the embedded tokens of seeded keypoints, two calls
   bitwise equal, and frame isolation. Tolerances: the fused forward's (B,
   17, 3) outputs within atol 5e-2 (the JAX package's bf16 budget); the
   trunk's own outputs, which reach |7| where one bf16 step is 2^-5,
   within 5e-2 + 2^-5 |want|; and the kernel's error against an f32 trunk
   at most 1.5x the plain version's. Then each of the trunk's six launches
   (per block ``qkv_kernel``, the attention, ``rest_kernel``) against its
   plain version (``trunk_qkv_reference``, ``trunk_attention_reference``,
   ``trunk_rest_reference``) on the inputs the kernels gave it, at 4, 8,
   12 and 8192 frames (a batch is a multiple of 4 frames): rows as above,
   the attention as in phase 6, the first block's bf16(tokens + pe)
   bitwise;
4. serving: ``LifterService(...).warmup()`` then requests of N = 1, 33,
   200, 8192, 10000, each checked against the f32 module (atol 0.1) and
   the plain path (atol 5e-2); the trunk's launches over these requests
   must be the number of batches they make;
5. times at B=8192 (every time below: ms per call, the median of 3 runs
   of 20 back-to-back calls, each run fenced by CUDA events, after
   warm-up); each trunk launch by device ms (torch.profiler), and the
   trunk's eight products as bare bf16 ``torch.matmul`` (a yardstick; the
   port never calls it).

The temporal path, the default TemporalLifter (17 joints, hidden 256, 8
heads x 32, MLP 1024, 5 blocks, clips of 243 frames, bf16):

6. kernel vs plain: the spatial and temporal sub-block kernels against
   ``spatial_block_reference`` / ``temporal_slab_reference`` at C = 2 and
   C = 16 clips, on the embedded tokens of seeded clips (rows: 5e-2 +
   2^-5 |want| and the f32-yardstick ratio 1.5, as for the trunk);
   clip and frame isolation; the attention kernels through both wrappers
   (``packed_flat_attention`` at seq 17, 40 and 64 on ``attention_kernel``,
   ``seq_attention`` on ``attention_wg_kernel`` at L = 100 and 243 and at
   its tile edges 65, 128, 129, 256 and 257, 8 heads x 32 and the other
   head widths, and at the longest L of each head width) within 2^-6 +
   2^-7 |want| and the f32-yardstick ratio 1.5; two calls bitwise equal at
   L = 243 in the contiguous, the slab and the joint-major layouts (the
   training forwards' att), the last two bitwise equal on the same tokens;
7. ``lift_sequence`` on videos of 600 frames (the fused route: one
   spatial and one temporal sub-block launch per block), 100 frames (the
   module route: packed attention for the joints, per-sequence attention
   for the frames) and 40 frames (packed attention for both), each held
   to the f32 module (atol 0.1) and to the same route on the plain
   versions (atol 5e-2), with every launch counted;
8. times at C = 16 x 243 frames:
   each kernel, its plain version and, for the attention, PyTorch's
   ``scaled_dot_product_attention`` on the same head-split inputs (a
   yardstick only; the port never calls it); the fused forward, its plain
   path and the eager bf16 module; ``lift_sequence`` on the 600-frame
   video, host to host; a torch.profiler device-time split of the fused
   forward by kernel.

The Martinez path, the default MartinezLifter (the reference LinearModel:
34 -> 1024, 2 residual blocks of 1024, -> 51, BatchNorm, bf16):

9. kernel vs plain: the block kernel against ``fused_residual_block_reference``
   at B = 1, 64, 127, 128, 129 (partial tiles on both sides of a 128-row
   tile edge), 200 (a ragged last tile), 8192 and 10000 on the first
   block's input rows of seeded keypoints (rows: 5e-2 + 2^-5 |want| and
   the f32-yardstick ratio 1.5, as for the trunk; the kernel's error
   against a float64 run at most 1.5x the plain version's + 2^-16 of the
   largest float64 value); two calls bitwise equal; row isolation inside
   a tile and across tile edges in a persistent CTA's second tile;
10. serving: ``LifterService`` on the same requests as the lifter path, each
    checked against the f32 module (atol 0.1) and the plain route (atol
    5e-2); the block's launches must be 2 blocks x the 6 batches;
11. times at B = 8192: the kernel, its plain version, the block's two
    GEMMs as bare ``torch.matmul`` (a yardstick only; the port never calls
    it), the eager bf16 module, the fused forward and ``LifterService.lift``
    host to host; and the device time of the fused forward and of the
    block by kernel (torch.profiler over 20 calls). ``python3 chip_smoke.py
    --martinez-split`` logs the block's two launches (GEMM 1, GEMM 2) by
    device ms at B = 64, 256 and 8192, after phases 1-2.

The temporal training path, the default TemporalLifter with f32 master
weights (bf16 compute in the kernels), 16 clips x 243 frames a step
(66,096 token rows), synthetic clips from ``data/synthetic.py``:

12. kernel vs plain: the four training wrappers (``spatial_fwd``,
    ``spatial_bwd``, ``slab_fwd``, ``slab_bwd``) at 16 clips and at 1 clip
    (243 frames: 4,131 rows, not a multiple of the 128-row tile):
    outputs and residuals as rows, dx and each of the 12 weight gradients
    within 2^-7 max|want| + 2^-7 |want|, each with the f32 yardstick; two
    backward calls must give bitwise equal gradients;
13. the whole training forward + backward on the kernels vs on the plain
    versions (the loss within 1e-2 relative, each parameter's gradient
    within 5e-2 in relative L2) and vs the f32 module (the yardstick);
14. 10 AdamW steps at lr 1e-3 through ``make_lifter_train_step``: 5
    launches of each training wrapper per step, a finite loss whose last
    three steps' mean is below the first; times of the step (frames/s),
    of the eager bf16 module's forward + backward through torch autograd
    (a yardstick only; the port never calls it), of each training wrapper
    and its plain version, and a torch.profiler device-time split of one
    step by kernel; each launch of one ``spatial_bwd`` and one ``slab_bwd``
    call with its device ms (torch.profiler), the bytes it reads and
    writes (reckoned from the shapes, each operand once) and its bound (its
    products' flops, exponentials and bytes at the card's peaks); ``python3
    chip_smoke.py --train`` runs phases 12-14 and this backward split alone,
    after phases 1-2; each launch of
    the four sub-block forwards (spatial and slab, serving and training:
    LN_1 + qkv, the attention, projection + MLP) by device ms, and a
    sub-block's four products alone as bf16 ``torch.matmul`` at the same
    shapes (a yardstick; the port never calls it). ``python3 chip_smoke.py
    --forward-split`` runs this forward split and the trunk's of phase 5
    alone, after phases 1-2.

The direct image->3D path, the default PoseNet3D (the reference Model_3D:
ResNet-50, three 4x4 stride-2 deconvs of 256, a 1x1 conv to 17 x 64
channels, z_scale 2.5, bf16), 64 frames of 256 x 256 a batch (bench.py's
``direct_train`` batch), synthetic frames from ``data/synthetic.py``, the
final conv's weights x8 so that the heatmaps peak and the coordinates
spread (std >= 0.1 is asserted):

15. kernel vs plain: the NHWC soft-argmax kernel on the model's own
    logits, on N(0, 1) + 100 logits with a +30 peak planted per (sample,
    joint) (the coordinates must sit on the peaks) and at J = 3; the
    conv-decode kernel on the model's own features, with +200 on its bias
    and at J = 3: coordinates within 1e-3 of the plain version, the
    kernel's error against a float64 run at most 1.5x the plain version's
    (+ 2^-16 of the largest coordinate), two calls bitwise equal;
16. the forward on each route (heatmap, NHWC, fused) against the same
    route on the plain versions (atol 5e-2) and the f32 module (atol
    5e-2), one soft-argmax launch on the NHWC route, one conv-decode
    launch on the fused route, none on the heatmap route (counts set to 0
    before each forward); ``make_direct_eval_chunk_step`` over 4 batches
    of uint8 frames on the fused route (4 conv-decode launches);
17. times: each kernel, its plain version and, for the conv decode, the
    1x1 conv alone as one bf16 ``torch.matmul`` (a yardstick; the port
    never calls it); the forward on each route (frames/s), and a
    torch.profiler device-time split of the fused route (decode,
    convolutions, batch norm, casts and copies, the rest); each decode
    forward launch by launch (the tile partials, their merge) by device
    ms. ``python3 chip_smoke.py --decode-forward-split`` runs that split
    alone.

The direct training path, the default PoseNet3D with f32 master weights
computing in bf16 under ``torch.autocast`` (``image_steps.bf16_apply``),
Adam with weight decay 1e-8 at lr 1e-3, 64 uint8 frames of 256 x 256 a
step (bench.py's ``direct_train``), the final conv x8 as above:

18. decode backwards vs plain on the model's own tensors at B = 64: the
    soft-argmax backward (dx) on the model's logits, at J = 3 and on the
    planted peaks of logits ~100; the conv-decode backward (dfeats, dW,
    db) on the model's features, with +100 on its bias and at J = 3:
    each output's error against a float64 run of its plain version at
    most 1.5x the plain version's (+ 2^-16 of the largest float64
    value), two calls bitwise equal;
19. the train step on three routes (fused: the conv-decode kernels
    forward and backward; NHWC with ``use_kernels_train``: the
    soft-argmax kernels; NHWC plain, the JAX trainer's default): one
    forward and one backward launch of the route's kernels a step
    (counts set to 0 before it); against the same step with the decode
    Functions on their kernels' plain versions: the loss within rtol
    1e-2, the final conv's gradients and all gradients together within
    5e-2 in relative L2, and each parameter's gradient as close to an f32
    step's as the plain step's is (at most 1.5x, floor 5e-2); 10 Adam
    steps on one fixed batch whose loss must be finite and whose last
    three steps' mean must be below the first; ms a step and frames/s
    per route (CUDA events), a torch.profiler device-time split of each
    route's step by kind and its busy share (device time over event time);
    each backward kernel, its plain version and, for the conv decode, its
    three products as bf16 ``torch.matmul`` (a yardstick; the port never
    calls it); the conv-decode backward launch by launch (A: dfeats, B:
    the dW and db partials, C: their fold) by device ms. ``python3
    chip_smoke.py --decode-backward-split`` runs that split alone;
20. ``cli.train_direct.train`` for one epoch on the fused route (256
    synthetic frames, 2 optimizer steps a chunk), then ``infer`` on its
    checkpoint.

The joint-major and legacy entry points: ``temporal_block_fused`` and
``temporal_block_train`` on the default TemporalLifter's block 0 (temporal
half), on the embedded tokens of 16 seeded clips laid out joint-major (272
sequences of 243 frames, bf16), and ``soft_argmax_3d_pallas`` on the x8
PoseNet3D's head output at B = 64, permuted to (B, 17, 64, 64, 64):

21. the main path: with the counts set to 0, one call of each entry point
    (``temporal_block_train`` forward and one ``backward()``, which must
    reach the flat weights, and the decode's forward and backward); one
    launch of each of the four kernels (the serving sub-block, the
    training forward and backward, the legacy soft-argmax);
22. kernel vs plain: the serving sub-block's rows (5e-2 + 2^-5 |want|,
    the f32 yardstick ratio 1.5), bitwise equal to the slab kernel on the
    same tokens, sequence isolation; the training forward's out, x1, att
    as rows, dx and the 12 weight gradients within 2^-7 max|want| + 2^-7
    |want| and the f32 yardstick; against the slab route out, x1, att and
    dx bitwise and each weight gradient within f32 summation order
    (relative L2 at most 2^-10, the measured value logged); two backward
    calls bitwise equal; the legacy soft-argmax as the NHWC one (within
    1e-3 of plain, the float64 yardstick, bitwise repeat, spread) on the
    model's logits and on planted peaks at logits ~100 with J = 3 in f32,
    its difference from the NHWC kernel on the same logits logged, and
    its backward (the XLA formula on the card) against a float64 run of
    the formula;
23. times of the four kernels and their plain versions, and of the
    legacy decode's backward.

The phase-1 lifter path (``cli/train_lift.py``, ``data/h36m.py``,
``cli/predict.py``), in a temporary directory, with f32 modules as the
JAX package trains and predicts: no kernel of ``csrc/`` runs on it:

24. a fabricated Human3.6M export (seeded; subjects S1, S5-S9, S11;
    actions that the ``Posing`` filter keeps and drops; the mono and
    4-camera files); ``train_lift.train`` of the ViT at full width
    (hidden 256, 2 blocks, 4 heads, MLP 1024), B = 64, 16,384 synthetic
    frames (256 steps an epoch), 3 epochs, flip TTA: every metric finite
    and the validation MPJPE of epoch 3 below epoch 1's; one more epoch
    timed by CUDA events (seconds, frames/s) and profiled (device time,
    busy share, kernel launches a step); the Martinez lifter (hidden
    1024, 2 stages, BatchNorm, dropout 0.5) and the AE for 2 epochs, the
    training loss falling; the ViT for 1 epoch on the export (its frame
    count that of the tree's arrays, the statistics under
    ``run_time_utils``); ``predict.main`` on each checkpoint with 10,000
    frames (chunks of 4096, the third padded) against the restored module
    in one batch on the card and on the CPU (atol 1e-4), timed;
    ``predict.main --model temporal`` on a 600-frame video JSON from a
    checkpoint of the seeded f32 TemporalLifter, bitwise equal to
    ``lift_sequence`` on the card and within 1e-4 of the CPU's;
    ``train_temporal.train`` for 1 epoch on the export. ``python3
    chip_smoke.py --lift-cli`` runs this phase alone, after phases 1-2.

The video -> 3D path (``pipeline/{video,detector,run}.py``), in a
temporary directory: the ResNet-50 ``PoseNet2D`` on 256 x 256 frames at
batch 64 (its final conv x40 so that the heatmaps peak; a coordinate
spread of at least 0.1 is asserted), and the default TemporalLifter in
bf16, both from the seed:

25. what the host has: whether cv2 imports and whether the port's native
    libraries build (``data/native_build.py``: g++, libjpeg, OpenCV C++);
    neither ends the run. 512 frames (bench.py's ``E2E_FRAMES``) rendered
    on the card by ``render_pose_frames`` from ``synthetic_h36m``
    keypoints, as uint8; the detector saved as port checkpoints in f32 and
    bf16 and the lifter in bf16, and each built again from its checkpoint
    by ``pipeline.run``; ``detect_frames`` (pinned chunks of 64, at most 6
    in flight): f32 against the same module on the CPU for the first
    chunk (atol 1e-3 in [0, 1] units: 1 px at the x1000 scale; TF32 off),
    bf16 against f32 (atol 0.1: at a spread of 0.1 the bf16 budget of
    5e-2 does not hold, see DETECT_BF16_ATOL); the detections as
    prediction JSONs, merged by ``save_to_json``, lifted by
    ``lift_video_json`` for the 512-frame video (one spatial and one
    temporal sub-block launch a block: rows 5 and 6) and a 100-frame cut
    (one packed and one sequence attention launch a block: rows 3 and 4),
    counted from 0 before each,
    the poses within 5e-2 of the plain versions on the CPU and 0.1 of the
    f32 module. Where cv2 imports: the frames written to
    ``raw_videos/walk.mp4`` and ``pipeline.run.main`` with ``--detector
    posenet2d`` and both checkpoints, its npy bitwise equal to
    ``lift_video_json`` on the run's own JSON, and the mp4's pixel
    difference from the rendered frames logged; where it does not, a line
    says so. Times (CUDA events, torch.profiler): the detector on frames
    already on the card, f32 and bf16 (frames/s, device ms, busy share,
    top device operations), the lift of 512 frames, and host to host per
    stage (detect on frames in host memory, lift) and for the whole path,
    and ``pipeline.run.main`` host to host (decode included) where cv2
    imports. ``python3
    chip_smoke.py --video`` runs this phase alone, after phases 1-2.

The detector, projector and consistency-loop trainers
(``cli/train_detector.py``, ``cli/train_project.py``, ``cli/train_loop.py``),
in a temporary directory, at the CLIs' default widths; no kernel of
``csrc/`` is on this path, as in the JAX package (the loop's PoseNet3D
decodes through the plain heatmap route):

26. ``train_detector.main`` at DetectorConfig's defaults (ResNet-18, B =
    32, 256 x 256, bf16 over f32, 8 steps a chunk, 600 steps): the eval
    pixel error finite and below a quarter of the fresh init's (the same
    eval step); a chunk's step time by CUDA events, its device time, busy
    share, launches a step and the peak memory; the trained checkpoint
    through ``pipeline.run.build_detector`` and ``detect_frames`` (bf16) on
    512 frames rendered from held-out poses, its pixel error; the
    projector (``train_project.main``) and the ViT lifter
    (``train_lift.train``) for 2 epochs of 16,384 synthetic frames, the
    loop's frozen checkpoints; ``train_loop.main`` at LoopConfig's defaults
    (ResNet-50, B = 64, 256 x 256, bf16, AdamW 5e-4) with the triangle
    (``sep``), the flip and the projector on 512 synthetic frames for 2
    epochs, then 1 epoch of ``cycle``: finite records with every triangle
    term, both checkpoints, and none of the 18 records' wrappers launched
    (counts from 0); 10 steps on one fixed batch whose last three losses'
    mean must be below the first, the step's time, device time, busy share,
    launches, peak memory and device time by kind, and the device time of
    its parts alone (each image model's forward + backward on the 2B
    frames, the heatmap decode's on their logits, the frozen ViTs, AdamW);
    one loop step (``sep``, flip, projector) at ResNet-18, 64 x 64, B = 4
    from the same weights on the card and on the CPU, in float64 (the loss
    and terms within rtol 1e-10, each trained parameter's gradient within
    relative L2 1e-8, the running statistics within 1e-10) and in f32 with
    TF32 off (1e-5; all gradients together within relative L2 2e-2; 1e-5);
    the 2D final conv's bias, whose gradient is 0 in exact arithmetic, held
    to 1e-12 / 1e-5 of the final conv weight gradient's norm.
    ``python3 chip_smoke.py --loop`` runs this phase alone, after phases
    1-2.

The SMPL-IK family (``models/{smpl,hybrik,smpl_pose}.py``,
``train/smpl_steps.py``) on the 6890-vertex synthetic body with the
reference's leaf vertex ids; no kernel of ``csrc/`` is on this path, as in
the JAX package (the plain ``soft_argmax_3d``; the IK's batched 3 x 3 SVD
is cuSOLVER's):

27. ``lbs``, ``batch_rigid_transform``, ``inverse_kinematics`` and
    ``hybrik`` (eval and naive paths) on FK skeletons (B = 8, 5 mm of
    noise, one joint moved 10 cm) on the card in float64 and f32 (TF32
    off) against a float64 run on the CPU: within 1e-10 and 5e-5; the eval
    path's 15 mm clamp changes the result against never and always
    clamping, and not when its threshold moves by 1e-5 either way;
    ``HybrIKPose`` with the ResNet-50 ``PoseSMPLNet`` (depth 64, 256 x 256
    frames, B = 32, the final conv x12, a uvd spread of at least 0.1
    asserted) in eval, bf16 under autocast against the f32 module with
    ``flip_test`` off and on (uvd, twists and shape within 5e-2, every
    output finite and f32), timed (CUDA events, device time, busy share,
    launches, peak memory, device time by kind) and its SMPL half alone;
    one ``make_hybrik_train_step`` from the same weights on the card and
    on the CPU (ResNet-18, 64 x 64, depth 8, B = 4, dropout 0) in float64
    (loss rtol 1e-10, each gradient relative L2 1e-8, statistics 1e-10)
    and f32 (1e-5, all gradients together 2e-2, 1e-5); 10 steps at full
    width (bf16 over f32, Adam 3e-4) on one batch, the mean of the last
    three losses below the first, the step timed; none of the 18 records'
    wrappers launched (counts from 0). ``python3 chip_smoke.py --smpl``
    runs this phase alone, after phases 1-2.

The data-parallel layer (``parallel/mesh.py``, the DP steps, global
BatchNorm, ``LifterService(mesh=)``) on the one card:

28. a world of one ``nccl`` rank in this process, every collective real:
    the DP fused temporal step (16 clips x 243, rows 8a-9b), the fused DP
    direct step (ResNet-50, B = 64, 256^2, rows 13a/13b, cuDNN's
    deterministic algorithms) and ``LifterService(mesh=)`` at N = 8192
    and 10000 (row 1), each bitwise equal to its one-process counterpart
    on the same inputs from copies of one model (a sum over one rank and a
    division by 1 are exact), with the counts set to 0 before each; times
    (CUDA events) of each step beside its one-process step (the direct
    steps' device time too, torch.profiler), the ``pmean_`` of its
    gradients and their flat ``all_reduce`` alone, the service host to
    host. In the same world, the global-BN Function forced through the
    one rank beside cuDNN's batch norm: one BatchNorm of layer 1's output
    (bf16, 256 x 64^2, within 2 bf16 steps); the direct step (fused
    route, ResNet-50, B = 64, 256^2) in float64 (loss rtol 1e-10,
    gradients together and the final conv's 1e-8), in f32 and in bf16 (as
    accurate as cuDNN's against the float64 step), both bf16 steps timed,
    with their peak memory. Then two ``gloo`` ranks spawned on cuda:0
    (``nccl`` takes one device a rank): the DP fused temporal step, 8
    clips a rank, against the one-process 16-clip step (loss rtol 1e-2,
    each gradient relative L2 <= 5e-2); the global-BN direct step in float64 (ResNet-18, 64^2, B = 8, rank 0's
    frames brightened) against the one-process step on the global batch
    (loss and MPJPE sums rtol 1e-10, parameters atol 1e-8, running
    statistics 1e-10); and the global-BN direct steps at full width, 2 x
    32 frames, against the one-process 64-frame steps by the same limits
    as over one rank; the ranks' parameters and gradients bitwise equal;
    each step timed on its rank (two processes sharing one GPU, not a
    scaling figure), the bf16 one with its peak memory. Its launches add
    to the records' counts. ``python3 chip_smoke.py --dp`` runs this phase
    alone, after phases 1-2. A run over several GPUs is not verified here.

Tensor parallelism (``parallel/sharding.py``: ``shard_params`` over the
mesh's model axis), the TP-sharded checkpoint, the DP SMPL-IK step and
``parallel/dryrun.dryrun_multichip``:

29. (a) one ``nccl`` rank on a 1 x 1 mesh: ``shard_params`` over one
    model rank cuts nothing, and three f32 Martinez steps at full width
    (hidden 1024, 2 stages, B = 64, Adam, dropout 0.5, global BatchNorm
    bound) are bitwise the one-process steps; (b) two ``gloo`` ranks on
    cuda:0, 1 x 2: the Martinez steps in float64 against the one-process
    float64 steps (losses and MPJPE sums rtol 1e-10, parameters and the
    gathered running statistics atol 1e-10 after 3 steps; the same
    dropout masks), in f32 as close to float64 as the one-process f32
    steps (2x, loss and state relative L2; without dropout, since the
    card's masks depend on the dtype), then as 2 x 1 the DP SMPL-IK
    step in float64 at phase 27's configuration against the one-process
    step on the global batch (loss and MPJPE sums rtol 1e-10, parameters
    atol 1e-8, running statistics 1e-10); (c) four ``gloo`` ranks on
    cuda:0, 2 x 2: the Martinez steps in float64 (dropout 0) by (b)'s
    limits, replicated tensors bitwise on every rank and each shard on
    its data peers; the checkpoint saved, restored and resumed bitwise,
    its file's tensors bitwise the gathered state and a one-process save
    of it; then ``dryrun_multichip(4, device="cuda")``, whose stages 6-7
    launch rows 8a-9b, 13a and 13b on each rank (their launches add to
    the records' counts). Each TP step timed on its rank by CUDA events
    beside the one-process step (ranks sharing one GPU, not a scaling
    figure), the gather of a 64 x 512 shard, peak memory.
    ``python3 chip_smoke.py --tp`` runs this phase alone, after phases 1-2.

The long-clip path, ``TemporalLifter(flash=True, remat=True)`` at the
default widths (hidden 256, 5 blocks, 8 heads x 32) and clips of 2048
frames, f32 master weights under bf16 autocast (``bf16_apply``), 2 clips
a step (34 sequences of 2048 frames in each temporal attention):

30. kernels 14a-14c (``ops/flash_attention.py``) against their plain
    versions on block 0's temporal qkv rows of seeded clips at 16 x 243
    and 2 x 2048 frames, 14c (dQ and D = rowsum(dO ∘ O)) launched before
    14b, which reads its D: O within 2^-6 + 2^-7 |want|; dQ, dK, dV within
    2^-7 max|want| + 2^-7 |want|; the log-sum-exp within 2^-12 (1 +
    |want|); D within 2^-18 of the row's Σ|dO ∘ O| of ``flash_delta`` on
    the same O and dO; each output's error against a float64 run at most
    1.5x the plain version's + 2^-16 of its largest value; two calls
    bitwise equal. Their times at 2 x 2048 (14c with D inside), the plain
    versions' (``flash_delta`` apart) and PyTorch's
    ``scaled_dot_product_attention`` forward, backward alone and both (a
    yardstick; the port never calls it). The full-width model, flash
    against eager attention from the same weights: the forward within
    5e-2, one step's loss within rtol 1e-2 and each gradient within 5e-2
    in relative L2. The main path: 10 AdamW steps of the flash + remat
    model through ``make_lifter_train_step`` with the counts from 0 (14a
    ten times a step, 14b and 14c five times), the loss falling. ms a
    step and peak memory of eager, flash and flash + remat. Two ``gloo``
    ranks on cuda:0 as a 1 x 2 sequence-parallel mesh, flash on (each
    rank's 1024 frames of queries over the gathered keys and values),
    against one process: loss rtol 1e-2, gradients relative L2 5e-2. The
    dry run's sequence-parallel stage (f32, flash off) runs in phase 29.
    ``python3 chip_smoke.py --long`` runs this phase alone, after phases
    1-2.

Prints one JSON line of kernel records (with each kernel's bound: the
larger of its matrix-product flops over the H100's 989 TFLOP/s dense bf16
peak, or for the soft-argmax and its backward their f32 operations over
the 67 TFLOP/s f32 peak, for the flash kernels also their exponentials
over the SFUs' 16 a clock an SM at the card's maximum SM clock, and its
bytes, each input read once and each output written once, over 3.35
TB/s), then as the last line
``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero and prints no result. Imports torch, numpy
and ``pose3d_tpu_torch`` only; phase 28's and 29's ranks are spawned
processes of this script or of ``parallel/dryrun.py``, ended by the phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import pose3d_tpu_torch
from pose3d_tpu_torch.cli import (predict, train_detector, train_direct, train_lift, train_loop,
                                  train_project, train_temporal)
from pose3d_tpu_torch.config import (DataConfig, DetectorConfig, DirectConfig, LiftConfig,
                                     LoopConfig, TemporalConfig)
from pose3d_tpu_torch.data.feed import batch_iterator
from pose3d_tpu_torch.data.synthetic import synthetic_frames, synthetic_h36m
from pose3d_tpu_torch.data import native_build
from pose3d_tpu_torch.data.synthetic import render_pose_frames
from pose3d_tpu_torch.models.heads import PoseNet2D, PoseNet3D
from pose3d_tpu_torch.models import hybrik, smpl
from pose3d_tpu_torch.models.lifters import JointTransformerLifter, MartinezLifter
from pose3d_tpu_torch.models.norm import F32BatchNorm1d, F32BatchNorm2d, sync_batch_norm
from pose3d_tpu_torch.models.smpl import synthetic_model
from pose3d_tpu_torch.models.smpl_pose import HybrIKPose, PoseSMPLNet
from pose3d_tpu_torch.models.dstformer import DSTformer
from pose3d_tpu_torch.models.temporal import TemporalLifter, make_clips
from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops import attention as A
from pose3d_tpu_torch.ops import conv_decode as CD
from pose3d_tpu_torch.ops import flash_attention as FA
from pose3d_tpu_torch.ops import heatmap as H
from pose3d_tpu_torch.ops import lifter as L
from pose3d_tpu_torch.ops import martinez as Mz
from pose3d_tpu_torch.ops import softargmax as SA
from pose3d_tpu_torch.ops import stblock as S
from pose3d_tpu_torch.ops import stblock_train as ST
from pose3d_tpu_torch.parallel import mesh as PM
from pose3d_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks
from pose3d_tpu_torch.parallel.sharding import (gathered_state_dict, sequence_parallel,
                                                shard_params, tp_layout)
from pose3d_tpu_torch.pipeline import run as video_run
from pose3d_tpu_torch.pipeline.detector import PoseNet2DDetector, write_predictions
from pose3d_tpu_torch.pipeline.keypoints import load_video_json, save_to_json
from pose3d_tpu_torch.pipeline.lift import lift_sequence, lift_video_json
from pose3d_tpu_torch.pipeline.video import extract_frames, load_frames, write_video
from pose3d_tpu_torch.serving import LifterService
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.epoch import make_lifter_epoch_fn, stack_batches
from pose3d_tpu_torch.train.image_steps import (bf16_apply, make_detector_chunk_step,
                                                make_detector_eval_step,
                                                make_direct_eval_chunk_step,
                                                make_direct_eval_step, make_direct_train_step,
                                                make_dp_direct_train_step)
from pose3d_tpu_torch.train.loop_steps import LoopState, freeze, make_loop_train_step
from pose3d_tpu_torch.train.smpl_steps import make_hybrik_train_step
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_dp_lifter_train_step, make_lifter_train_step

SEED = 0
TOP = 8192
REQUESTS = (1, 33, 200, 8192, 10000)
N_TIMED = 20         # calls per timed run
N_RUNS = 3           # timed runs; the median is kept
KERNEL_ATOL = 5e-2   # kernel vs plain path, (B, 17, 3) outputs (the JAX package's bf16 budget)
# the trunk's outputs reach |7|: a different f32 summation order flips bf16
# roundings that the bf16 residual stream carries on, so the bound grows
# with the value, by 4 to 8 bf16 steps (2^-5 relative)
TRUNK_RTOL = 2 ** -5
F32_ERR_RATIO = 1.5  # kernel's error vs an f32 trunk, relative to the plain version's
F32_ATOL = 0.1       # bf16 path vs the f32 module (test_close_to_f32_flax_apply)
# attention rows: one bf16 step of |out| (2^-7 relative), plus one flipped
# bf16 rounding of a dominant softmax numerator, worth 2^-8 |v| with |v| up
# to ~4 for N(0, 1) inputs; and, as for the trunk, the kernel's error
# against an f32 attention at most 1.5x the plain version's
ATTN_ATOL, ATTN_RTOL = 2 ** -6, 2 ** -7
CLIPS = 16           # the JAX bench's temporal_infer batch (TI_B)
VIDEOS = (600, 100, 40)  # frames: the fused route, the module route at L > 64, at L <= 64
TRAIN_CLIPS = 16     # TemporalConfig.batch_size: 16 x 243 x 17 = 66,096 token rows
TRAIN_STEPS = 10     # steps of the training run whose loss must fall
TRAIN_LR = 1e-3
# gradients (dx, each of the 12 weight gradients): a bf16 kernel summing in
# another order than its plain version flips bf16 roundings of the
# intermediates (dh, dqkv, dx1), which move a gradient by a few bf16 steps
# of its elements: 2^-7 of the tensor's largest element plus 2^-7 |want|,
# and, as for the forwards, the f32 yardstick ratio 1.5 (with a floor of
# 2^-16 of the f32 tensor's largest element where the plain error is ~0)
GRAD_ATOL_REL, GRAD_RTOL = 2 ** -7, 2 ** -7
STEP_GRAD_REL = 5e-2  # whole step, kernels vs plain versions: relative L2 (see each phase)
DIRECT_B = 64        # bench.py's DIRECT_B
DIRECT_SIZE = 256    # the reference's input frames
DIRECT_CHUNK = 4     # batches of the eval chunk step
# the final conv x8: at the init's scale the heatmaps are near uniform and
# every coordinate sits near -1/32, so a comparison would say little
FINAL_SCALE = 8.0
MIN_SPREAD = 0.1     # std of the coordinates over samples and joints
DECODE_ATOL = 1e-3   # decode kernels vs plain: both sum in f32, in other orders
DIRECT_ATOL = 5e-2   # direct routes vs plain routes and vs the f32 module (bf16 budget)
DIRECT_LR = 1e-3     # DirectConfig.lr
DIRECT_WD = 1e-8     # the phase-3 Adam's weight decay (cli/train_direct._weight_decay)
CLI_FRAMES = 256     # the CLI phase's synthetic training frames
# the block kernel's batches: one row, partial tiles on both sides of a
# 128-row tile edge, a ragged last tile, the serving bucket and two buckets'
# worth; rows across tile edges that a persistent CTA's second tile holds
# at B = TOP (row tiles 40 and 63: the first round of 132 CTAs on 128 x
# 256 tiles covers row tiles 0-33 at most)
MARTINEZ_BATCHES = (1, 64, 127, 128, 129, 200, TOP, 10000)
MARTINEZ_EDGE_ROWS = (5119, 5120, 8063, 8064)
MARTINEZ_SPLIT_BATCHES = (64, 256, TOP)
LIFT_FRAMES = 16384  # LiftConfig's synthetic split: 256 steps of B = 64 an epoch
LIFT_EPOCHS = 3
LIFT_B = 64          # LiftConfig.batch_size
PREDICT_FRAMES = 10000  # cli.predict's 4096-frame chunks: two whole and a padded third
PREDICT_ATOL = 1e-4  # f32 vs f32 (PERF.md §2): sums in another order or on another device
VIDEO_FRAMES = 600
# the fabricated Human3.6M export: every calibrated subject, two actions
# that the "Posing" filter keeps and two it drops
H36M_SUBJECTS = ("S1", "S5", "S6", "S7", "S8", "S9", "S11")
H36M_ACTIONS = ("Posing", "Posing 1", "Walking", "Directions 1")
H36M_CAMS = (".54138969", ".55011271", ".58860488", ".60457274")
E2E_FRAMES = 512     # bench.py's E2E_FRAMES: the video of phase 25
E2E_CUT = 100        # a video shorter than one 243-frame clip: rows 3 and 4
DETECT_B = 64        # bench.py's E2E_DETECT_B, PoseNet2DDetector's batch
# the detector's final conv x40: at the init's scale every coordinate sits
# within a few 1e-3 of 0.47; x40 spreads them (std ~0.105, MIN_SPREAD 0.1)
DETECT_SCALE = 40.0
DETECT_CPU_ATOL = 1e-3  # f32 detector, card vs CPU, [0, 1] units (1 px at x1000)
# the bf16 detector vs the f32 one: F32_ATOL, the limit of a bf16 model
# against its f32 module. The bf16 budget of 5e-2 does not hold at a spread
# of 0.1: the logits reach |60|, where one bf16 step is 0.25, and a random
# network's heatmaps have near-equal peaks between which such steps move
# the softmax's mass (experiments/detector_scale_sweep.py: x32 spreads
# 0.094 with a largest error of 0.043, x40 0.105 with 0.072)
DETECT_BF16_ATOL = F32_ATOL
PEAK_BF16 = 989e12   # H100 SXM dense bf16 FLOP/s (NVIDIA's data sheet)
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_HBM = 3.35e12   # H100 SXM HBM3 bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def build_phase() -> None:
    here = Path(__file__).resolve().parent
    if Path(pose3d_tpu_torch.__file__).resolve().parent.parent != here:
        sys.exit("chip_smoke: pose3d_tpu_torch does not come from this checkout")
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{_build.library_path().relative_to(here)}")
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            kernel = line.split("'")[1]  # the mangled name ends in its arguments
            log(f"  ptxas: {kernel[:90]}")
        elif "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


def seeded_model(device, dtype):
    model = JointTransformerLifter(device="cpu")
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.to(device=device, dtype=dtype).eval()


def kernel_phase(model) -> float:
    """Kernel vs plain on the card; returns the trunk's max abs error at B=TOP."""
    w = L.pack_weights(model)
    w32 = L.TrunkWeights(w.flat.float(), w.n_blocks)
    gen = torch.Generator().manual_seed(SEED + 1)
    err_top = None
    for batch in (64, TOP):
        kp = torch.rand(batch, 17, 2, generator=gen).to("cuda")
        tokens = L.embed_tokens(model, kp)
        got = L.trunk(tokens, model.pe, w)
        again = L.trunk(tokens, model.pe, w)
        want = L.trunk_reference(tokens, model.pe, w)
        ref32 = L.trunk_reference(tokens.float(), model.pe.float(), w32)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"kernel output not finite at B={batch}")
        if not torch.equal(got, again):
            raise AssertionError(f"two trunk calls at B={batch} differ")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        excess = (diff - (KERNEL_ATOL + TRUNK_RTOL * want.float().abs())).max().item()
        err32 = (got.float() - ref32).abs().max().item()
        plain32 = (want.float() - ref32).abs().max().item()
        out_err = (L.lifter_forward_fused(model, kp, weights=w)
                   - L.lifter_head(model, want)).abs().max().item()
        log(f"kernel vs plain, B={batch}: trunk max abs err {err:.6g} "
            f"(|want| max {want.float().abs().max().item():.4g}, worst excess over "
            f"5e-2 + 2^-5|want| {excess:.4g}); vs an f32 trunk: kernel "
            f"{err32:.6g}, plain {plain32:.6g}; fused output max abs err "
            f"{out_err:.6g} (atol {KERNEL_ATOL})")
        if excess > 0 or err32 > F32_ERR_RATIO * plain32 or out_err > KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with its plain version at B={batch}")
        err_top = err
    tokens = L.embed_tokens(model, torch.rand(64, 17, 2, generator=gen).to("cuda"))
    base = L.trunk(tokens, model.pe, w)
    pert = tokens.clone()
    pert[:17] += 1.0
    out = L.trunk(pert, model.pe, w)
    torch.cuda.synchronize()
    if not torch.equal(base[17:], out[17:]) or torch.equal(base[:17], out[:17]):
        raise AssertionError("frame isolation: perturbing frame 0 moved other frames")
    log("kernel frame isolation: ok")
    return err_top


TRUNK_LAUNCH_FRAMES = (4, 8, 12, TOP)  # the trunk takes multiples of 4 frames (FRAMES_PER_CTA)


def _attn_check(what, got, want, ref32) -> float:
    """Attention rows: 2^-6 + 2^-7 |want| and the f32-yardstick ratio."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - (ATTN_ATOL + ATTN_RTOL * want.float().abs())).max().item()
    err32 = (got.float() - ref32.view_as(got)).abs().max().item()
    plain32 = (want.float() - ref32.view_as(want)).abs().max().item()
    log(f"kernel vs plain, {what}: max abs err {diff.max().item():.6g} (worst excess over "
        f"2^-6 + 2^-7|want| {excess:.4g}); vs f32: kernel {err32:.6g}, plain {plain32:.6g}")
    if not torch.isfinite(got).all() or excess > 0 or err32 > F32_ERR_RATIO * plain32:
        raise AssertionError(f"{what} disagrees with its plain version")
    return diff.max().item()


def trunk_launch_phase(model) -> None:
    """Each of the trunk's launches against its plain version on the inputs
    the kernels gave it (``L.trunk_scratch``: a call's q|k|v, attention
    and residual scratch), at 4, 8, 12 and TOP frames: block 0 from a
    one-block call (its residual stream bf16(tokens + pe) bitwise), block 1
    from the two-block call, whose block-0 output must equal the one-block
    call's bitwise; q|k|v and the block's output as rows (5e-2 + 2^-5
    |want|, the f32-yardstick ratio 1.5), the attention within 2^-6 + 2^-7
    |want| and the ratio."""
    w = L.pack_weights(model)
    w32 = L.TrunkWeights(w.flat.float(), w.n_blocks)
    one = L.TrunkWeights(w.flat[:L.BLOCK_ELEMS], 1)
    pe = model.pe
    gen = torch.Generator().manual_seed(SEED + 50)
    for frames in TRUNK_LAUNCH_FRAMES:
        tokens = L.embed_tokens(model, torch.rand(frames, 17, 2, generator=gen).to("cuda"))
        out1, resid1, qkv1, att1 = L.trunk_scratch(tokens, pe, one)
        out2, resid2, qkv2, att2 = L.trunk_scratch(tokens, pe, w)
        torch.cuda.synchronize()
        if not torch.equal(resid1, L.trunk_qkv_reference(tokens, w.block(0), pe)[1]):
            raise AssertionError(f"trunk block 0, {frames} frames: bf16(tokens + pe) differs")
        if not torch.equal(resid2, out1):
            raise AssertionError(f"trunk, {frames} frames: block 0's output differs between "
                                 "a one-block and a two-block call")
        for blk, x_in, x, qkv, att, out in ((0, tokens, resid1, qkv1, att1, out1),
                                            (1, resid2, resid2, qkv2, att2, out2)):
            wb, wb32 = w.block(blk), w32.block(blk)
            pe_b = pe if blk == 0 else None
            what = f"trunk block {blk}, {frames} frames"
            _rows_check(f"{what}, qkv_kernel", qkv, L.trunk_qkv_reference(x_in, wb, pe_b)[0],
                        L.trunk_qkv_reference(x_in.float(), wb32,
                                              None if pe_b is None else pe_b.float())[0])
            _attn_check(f"{what}, attention", att, L.trunk_attention_reference(qkv),
                        L.trunk_attention_reference(qkv.float()))
            _rows_check(f"{what}, rest_kernel", out, L.trunk_rest_reference(x, att, wb),
                        L.trunk_rest_reference(x.float(), att.float(), wb32))


def serving_phase(model, model_f32):
    """Returns (service, the trunk launches the requests made)."""
    svc = LifterService(model, None, device="cuda", max_batch=TOP).warmup()
    if not svc.fused:
        raise AssertionError("the bf16 default lifter is not on the kernel route")
    rng = np.random.default_rng(SEED + 2)
    requests = [rng.random((n, 17, 2)).astype(np.float32) for n in REQUESTS]
    expected = sum(-(-n // TOP) for n in REQUESTS)

    L.trunk.launches = 0
    answers = [svc.lift(kp) for kp in requests]
    launches = L.trunk.launches
    log(f"serving: {len(REQUESTS)} requests, trunk launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError("the requests did not all go through the kernel")

    for kp, got in zip(requests, answers):
        n = len(kp)
        if got.shape != (n, 17, 3) or not np.isfinite(got).all():
            raise AssertionError(f"N={n}: bad answer {got.shape}")
        x = torch.from_numpy(kp).to("cuda")
        ref32 = model_f32(x).cpu().numpy()
        plain = np.concatenate([
            _plain_forward(model, svc, x[i:i + TOP]) for i in range(0, n, TOP)])
        e32 = np.abs(got - ref32).max()
        ep = np.abs(got - plain).max()
        log(f"serving N={n}: max abs err vs f32 module {e32:.6g} "
            f"(atol {F32_ATOL}), vs plain path {ep:.6g} (atol {KERNEL_ATOL})")
        if e32 > F32_ATOL or ep > KERNEL_ATOL:
            raise AssertionError(f"N={n}: answer out of tolerance")
    return svc, launches


def _plain_forward(model, svc, x):
    """The plain path on x padded to its service bucket, as lift pads it."""
    n = len(x)
    b = min(b for b in svc.buckets if b >= n)
    xp = torch.zeros((b, 17, 2), device=x.device)
    xp[:n] = x
    plain = L.lifter_head(model, L.trunk_reference(
        L.embed_tokens(model, xp), model.pe, L.pack_weights(model)))
    return plain[:n].cpu().numpy()


def cuda_ms(fn, n=N_TIMED) -> float:
    """ms per call of fn(): the median over N_RUNS runs of n back-to-back
    calls, each run fenced by CUDA events, after 3 warm-up calls. Where
    the host enqueues faster than the device runs, this is device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def device_ms_by_kernel(fn, n=N_TIMED) -> dict[str, float]:
    """Device ms per call of fn() by kernel (its full name), from
    torch.profiler's CUDA activity over n calls (``device_profile``)."""
    return device_profile(fn, n)[0]


def device_profile(fn, n: int = N_TIMED) -> tuple[dict[str, float], float]:
    """(device ms per call of fn() by kernel, kernel launches per call),
    from torch.profiler's CUDA activity over n calls after one warm-up
    call. User annotations (``record_function`` ranges, such as the
    optimizer's step) are left out: their device time is that of the
    kernels inside them. In a process that has profiled before, a window
    can come back empty (device_launches): it is taken again, three times
    at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        split, launches = {}, 0
        for e in prof.key_averages():
            us = e.self_device_time_total
            if (e.device_type == torch.autograd.DeviceType.CUDA and us > 0
                    and not e.is_user_annotation):
                name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
                split[name] = split.get(name, 0.0) + us / n / 1e3
                launches += e.count
        if split:
            return split, launches / n
        log("device_profile: torch.profiler recorded no device time; recording again")
    raise AssertionError("torch.profiler recorded no device time")


def top_kernels(split: dict[str, float], n: int) -> str:
    """The n kernels of a split with the most device time, by short name
    (the function and the start of its template arguments)."""
    def short(name):
        head, sep, tail = name.split("(")[0].partition("<")
        return (head.split("::")[-1] + sep + tail)[:60]

    return ", ".join(f"{short(k)} {v:.4f}"
                     for k, v in sorted(split.items(), key=lambda kv: -kv[1])[:n])


def by_kind(split: dict[str, float], kinds) -> dict[str, float]:
    """Device ms of a split summed by kind: the first kind one of whose
    keys is in a kernel's full name, else "other"."""
    groups = {kind: 0.0 for kind, _ in kinds} | {"other": 0.0}
    for name, ms in split.items():
        low = name.lower()
        groups[next((k for k, keys in kinds if any(key in low for key in keys)), "other")] += ms
    return groups


def timing_phase(model, svc) -> dict:
    w = L.pack_weights(model)
    kp = torch.rand(TOP, 17, 2, generator=torch.Generator().manual_seed(SEED + 3))
    kp_dev = kp.to("cuda")
    kp_np = kp.numpy()
    tokens = L.embed_tokens(model, kp_dev)
    t = {
        "kernel_trunk": cuda_ms(lambda: L.trunk(tokens, model.pe, w)),
        "plain_trunk": cuda_ms(lambda: L.trunk_reference(tokens, model.pe, w)),
        "eager_bf16_module": cuda_ms(lambda: model(kp_dev)),
        "fused_forward": cuda_ms(
            lambda: L.lifter_forward_fused(model, kp_dev, weights=w)),
        "service_lift": cuda_ms(lambda: svc.lift(kp_np)),
    }
    for k, ms in t.items():
        log(f"time B={TOP} {k}: {ms:.4f} ms = {TOP / ms * 1e3:.1f} frames/s")
    return t


def seeded_temporal(device, dtype):
    model = TemporalLifter(device="cpu")
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.to(device=device, dtype=dtype).eval()


def seeded_clips(n_clips, model, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n_clips, model.clip_len, 17, 2, generator=gen).to("cuda")


def _rows_check(what, got, want, ref32) -> float:
    """Sub-block rows: 5e-2 + 2^-5 |want| and the f32-yardstick ratio."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - (KERNEL_ATOL + TRUNK_RTOL * want.float().abs())).max().item()
    err32 = (got.float() - ref32).abs().max().item()
    plain32 = (want.float() - ref32).abs().max().item()
    log(f"kernel vs plain, {what}: max abs err {err:.6g} (|want| max "
        f"{want.float().abs().max().item():.4g}, worst excess over 5e-2 + 2^-5|want| "
        f"{excess:.4g}); vs f32: kernel {err32:.6g}, plain {plain32:.6g}")
    if not torch.isfinite(got).all() or excess > 0 or err32 > F32_ERR_RATIO * plain32:
        raise AssertionError(f"kernel disagrees with its plain version: {what}")
    return err


def sub_block_phase(model) -> dict:
    """The spatial and temporal sub-block kernels vs their plain versions on
    the embedded tokens of seeded clips; returns max abs errors at C=16."""
    ws, wt = S.pack_spatial_weights(model.blocks[0]), S.pack_temporal_weights(model.blocks[0])
    w32 = [S.SubBlockWeights(w.flat.float()) for w in (ws, wt)]
    errs = {}
    for n_clips in (2, CLIPS):
        kp = seeded_clips(n_clips, model, SEED + 4)
        tokens = S.embed_clips(model, kp)
        errs["spatial_block"] = _rows_check(
            f"spatial_block C={n_clips}", S.spatial_block(tokens, ws),
            S.spatial_block_reference(tokens, ws),
            S.spatial_block_reference(tokens.float(), w32[0]))
        slab = tokens.view(n_clips, model.clip_len, -1)
        errs["temporal_slab"] = _rows_check(
            f"temporal_slab C={n_clips}", S.temporal_slab(slab, wt),
            S.temporal_slab_reference(slab, wt),
            S.temporal_slab_reference(slab.float(), w32[1]))
    slab = S.embed_clips(model, seeded_clips(3, model, SEED + 5)).view(3, model.clip_len, -1)
    pert = slab.clone()
    pert[0] += 1.0
    base, out = S.temporal_slab(slab, wt), S.temporal_slab(pert, wt)
    if not torch.equal(base[1:], out[1:]) or torch.equal(base[0], out[0]):
        raise AssertionError("clip isolation: perturbing clip 0 moved other clips")
    rows, pert = slab.view(-1, 256), slab.view(-1, 256).clone()
    pert[:17] += 1.0
    base, out = S.spatial_block(rows, ws), S.spatial_block(pert, ws)
    if not torch.equal(base[17:], out[17:]) or torch.equal(base[:17], out[:17]):
        raise AssertionError("frame isolation: perturbing frame 0 moved other frames")
    log("sub-block kernels: clip and frame isolation ok")
    return errs


# the wgmma attention's edges (L > A.SPLIT_LEN): one row past the split,
# whole and ragged 128-row query and key tiles; and, at 2 sequences, the
# longest L check_length lets each head width have
WG_LENGTHS = (65, 128, 129, 256, 257)
LONGEST = ((4, 16, 2416), (8, 32, 1440), (4, 64, 800))


def attention_phase(model) -> dict:
    """The attention kernels through both wrappers vs the plain versions,
    and bitwise repeats at L = 243 in the contiguous and the slab layout."""
    gen = torch.Generator().manual_seed(SEED + 6)
    frames = CLIPS * 243
    cases = [  # (wrapper, sequences, length, heads, dh): the main path's shapes
        ("packed_flat_attention", frames, 17, 8, 32),     # spatial halves
        ("packed_flat_attention", CLIPS * 17, 40, 8, 32),  # temporal halves, 40 frames
        ("packed_flat_attention", frames, 17, 4, 64),
        ("packed_flat_attention", CLIPS * 17, 40, 4, 16),
        ("packed_flat_attention", CLIPS * 17, 5, 2, 32),
        ("packed_flat_attention", CLIPS * 17, A.SPLIT_LEN, 8, 32),
        ("seq_attention", CLIPS * 17, 100, 8, 32),        # temporal halves, 100 frames
        ("seq_attention", CLIPS * 17, 243, 8, 32),
        ("seq_attention", CLIPS * 17, 243, 4, 64),
        ("seq_attention", CLIPS * 17, 100, 4, 16),
        ("packed_flat_attention", frames, 17, 8, 64),      # DSTformer's spatial halves
        ("seq_attention", CLIPS * 17, 243, 8, 64),         # DSTformer's temporal halves
    ]
    cases += [("seq_attention", CLIPS * 17, length, heads, dh) for length in WG_LENGTHS
              for heads, dh in ((8, 32), (4, 16), (4, 64), (8, 64))]
    cases += [("seq_attention", 2, length, heads, dh) for heads, dh, length in LONGEST]
    errs = {"packed_flat_attention": 0.0, "seq_attention": 0.0}
    for name, n, length, heads, dh in cases:
        qkv = torch.randn(n, length, 3 * heads * dh, generator=gen).to("cuda", torch.bfloat16)
        if name == "packed_flat_attention":
            flat = qkv.view(n * length, -1)
            got = A.packed_flat_attention(flat, length, heads)
            want = A.packed_flat_attention_reference(flat, length, heads)
            ref32 = A.packed_flat_attention_reference(flat.float(), length, heads)
        else:
            got = A.seq_attention(qkv, heads)
            want = A.seq_attention_reference(qkv, heads)
            ref32 = A.seq_attention_reference(qkv.float(), heads)
        err = _attn_check(f"{name} {n} x {length}, {heads} x {dh}", got, want, ref32)
        errs[name] = max(errs[name], err)
    qkv = torch.randn(CLIPS * 17, 243, 768, generator=gen).to("cuda", torch.bfloat16)
    w = S.pack_temporal_weights(model.blocks[0])
    slab = S.embed_clips(model, seeded_clips(CLIPS, model, SEED + 120)).view(CLIPS, 243, -1)
    seqs = S.joint_major(slab.reshape(-1, 256), CLIPS)
    first = (A.seq_attention(qkv, 8), ST.slab_fwd(slab, w)[2], ST.sequences_fwd(seqs, w)[2])
    again = (A.seq_attention(qkv, 8), ST.slab_fwd(slab, w)[2], ST.sequences_fwd(seqs, w)[2])
    torch.cuda.synchronize()
    for what, a, b in zip(("seq_attention", "the slab's attention", "the joint-major "
                           "attention"), first, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} at L = 243: two calls differ")
    if not torch.equal(S.joint_major(first[1].reshape(-1, 256), CLIPS), first[2]):
        raise AssertionError("the slab's and the joint-major attention differ on the same tokens")
    log("attention at L = 243: two calls bitwise equal in the contiguous, slab and joint-major "
        "layouts; slab and joint-major bitwise equal on the same tokens")
    return errs


TEMPORAL_KERNELS = (S.spatial_block, S.temporal_slab, A.packed_flat_attention,
                    A.seq_attention)
DST_VIDEO = 600  # frames: 5 clips of 243 at the half-clip stride, one forward


def seeded_dstformer(device, dtype):
    model = DSTformer(device="cpu")
    model.init_weights(torch.Generator().manual_seed(SEED + 9))
    return model.to(device=device, dtype=dtype).eval()


def dstformer_phase() -> dict:
    """MotionBERT's DSTformer at its published widths (dim 512, 8 heads x
    64) through lift_sequence's module route: every attention of its 20
    sub-blocks on rows 3-4. As for the trunk, the kernels' rms error
    against the f32 module is at most F32_ERR_RATIO times the plain bf16
    route's. Returns each attention kernel's launches."""
    rng = np.random.default_rng(SEED + 9)
    kp = np.concatenate([rng.random((DST_VIDEO, 17, 2)) * 1000,
                         rng.uniform(0.3, 1.0, (DST_VIDEO, 17, 1))], -1).astype(np.float32)
    model = seeded_dstformer("cuda", torch.bfloat16)
    kernels = (A.packed_flat_attention, A.seq_attention)
    before = [f.launches for f in kernels]
    got = lift_sequence(model, kp)
    made = {f.__name__: f.launches - b for f, b in zip(kernels, before)}
    log(f"DSTformer lift_sequence {DST_VIDEO} frames: launches {made} (expected 10 each)")
    if made != {"packed_flat_attention": 10, "seq_attention": 10}:
        raise AssertionError("the DSTformer's attention did not take the kernels")
    plain = lift_sequence(model, kp, use_kernels=False)
    want = lift_sequence(seeded_dstformer("cuda", torch.float32), kp)
    gaps = {k: v - want for k, v in (("kernels", got), ("plain", plain))}
    err = {k: (float(np.abs(g).max()), float(np.sqrt((g ** 2).mean()))) for k, g in gaps.items()}
    log(f"DSTformer lift_sequence {DST_VIDEO} frames vs the f32 module (max abs, rms): kernels "
        f"{err['kernels'][0]:.6g}, {err['kernels'][1]:.6g}; plain bf16 {err['plain'][0]:.6g}, "
        f"{err['plain'][1]:.6g}; |want| max {np.abs(want).max():.4g}")
    if got.shape != (DST_VIDEO, 17, 3) or err["kernels"][1] > F32_ERR_RATIO * err["plain"][1]:
        raise AssertionError("the DSTformer's answer out of tolerance")
    return made


def lift_phase(model, model_f32) -> dict:
    """lift_sequence on three videos; returns each kernel's launches."""
    model_cpu = seeded_temporal("cpu", torch.bfloat16)
    rng = np.random.default_rng(SEED + 7)
    videos = {n: (rng.random((n, 17, 2)) * 1000).astype(np.float32) for n in VIDEOS}
    expected = {  # launches per kernel: 5 blocks, one forward per video
        600: (5, 5, 0, 0), 100: (0, 0, 5, 5), 40: (0, 0, 10, 0)}
    for f in TEMPORAL_KERNELS:
        f.launches = 0
    answers = {}
    for n, kp in videos.items():
        before = [f.launches for f in TEMPORAL_KERNELS]
        answers[n] = lift_sequence(model, kp)
        made = tuple(f.launches - b for f, b in zip(TEMPORAL_KERNELS, before))
        log(f"lift_sequence {n} frames: launches spatial {made[0]}, temporal {made[1]}, "
            f"packed {made[2]}, seq {made[3]} (expected {expected[n]})")
        if made != expected[n]:
            raise AssertionError(f"{n} frames: the video did not take its route's kernels")
    launches = {f.__name__: f.launches for f in TEMPORAL_KERNELS}
    for n, kp in videos.items():
        got = answers[n]
        if got.shape != (n, 17, 3) or not np.isfinite(got).all():
            raise AssertionError(f"{n} frames: bad answer {got.shape}")
        e32 = np.abs(got - lift_sequence(model_f32, kp)).max()
        ep = np.abs(got - lift_sequence(model_cpu, kp, use_kernels=True)).max()
        log(f"lift_sequence {n} frames: max abs err vs f32 module {e32:.6g} (atol "
            f"{F32_ATOL}), vs the plain versions {ep:.6g} (atol {KERNEL_ATOL})")
        if e32 > F32_ATOL or ep > KERNEL_ATOL:
            raise AssertionError(f"{n} frames: answer out of tolerance")
    return launches


def temporal_timing_phase(model) -> dict:
    kp = seeded_clips(CLIPS, model, SEED + 8)
    weights = S.pack_temporal_lifter(model)
    ws, wt = weights[0]
    tokens = S.embed_clips(model, kp)
    slab = tokens.view(CLIPS, model.clip_len, -1)
    gen = torch.Generator().manual_seed(SEED + 9)
    frames = CLIPS * model.clip_len
    packed = torch.randn(frames * 17, 768, generator=gen).to("cuda", torch.bfloat16)
    seq = torch.randn(CLIPS * 17, model.clip_len, 768, generator=gen).to(
        "cuda", torch.bfloat16)

    def heads_split(qkv, length):  # (N, L, 3*256) -> 3 x (N, 8, L, 32), contiguous
        q, k, v = qkv.view(-1, length, 3, 8, 32).permute(2, 0, 3, 1, 4)
        return q.contiguous(), k.contiguous(), v.contiguous()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qp, kp_, vp = heads_split(packed, 17)
    qs, ks, vs = heads_split(seq, model.clip_len)

    def plain_forward():
        trunk = S.temporal_trunk_reference(S.embed_clips(model, kp), CLIPS, weights)
        return S.temporal_head(model, trunk, CLIPS)

    t = {
        "spatial_block": cuda_ms(lambda: S.spatial_block(tokens, ws)),
        "spatial_block_plain": cuda_ms(lambda: S.spatial_block_reference(tokens, ws)),
        "temporal_slab": cuda_ms(lambda: S.temporal_slab(slab, wt)),
        "temporal_slab_plain": cuda_ms(lambda: S.temporal_slab_reference(slab, wt)),
        "packed_flat_attention": cuda_ms(lambda: A.packed_flat_attention(packed, 17, 8)),
        "packed_flat_attention_plain": cuda_ms(
            lambda: A.packed_flat_attention_reference(packed, 17, 8)),
        "packed_flat_attention_sdpa": cuda_ms(lambda: sdpa(qp, kp_, vp)),
        "seq_attention": cuda_ms(lambda: A.seq_attention(seq, 8)),
        "seq_attention_plain": cuda_ms(lambda: A.seq_attention_reference(seq, 8)),
        "seq_attention_sdpa": cuda_ms(lambda: sdpa(qs, ks, vs)),
        "fused_forward": cuda_ms(lambda: S.temporal_forward_fused(model, kp, weights=weights)),
        "plain_forward": cuda_ms(plain_forward),
        "eager_bf16_module": cuda_ms(lambda: model(kp)),
    }
    video = (np.random.default_rng(SEED + 10).random((VIDEOS[0], 17, 2)) * 1000).astype(
        np.float32)
    t["lift_sequence"] = cuda_ms(lambda: lift_sequence(model, video))
    log(f"time lift_sequence {VIDEOS[0]} frames (host to host): {t['lift_sequence']:.4f} ms = "
        f"{VIDEOS[0] / t['lift_sequence'] * 1e3:.1f} frames/s")
    for k in ("fused_forward", "plain_forward", "eager_bf16_module"):
        log(f"time C={CLIPS} x {model.clip_len} {k}: {t[k]:.4f} ms = "
            f"{frames / t[k] * 1e3:.1f} frames/s")
    split = device_ms_by_kernel(lambda: S.temporal_forward_fused(model, kp, weights=weights), n=5)
    log(f"device time C={CLIPS} x {model.clip_len} fused_forward: {sum(split.values()):.4f} ms "
        "per call: " + top_kernels(split, 8))
    for k, ms in t.items():
        if "forward" not in k and "module" not in k and k != "lift_sequence":
            log(f"time C={CLIPS} x {model.clip_len} {k}: {ms:.4f} ms")
    return t


def seeded_martinez(device, dtype):
    model = MartinezLifter(device="cpu")
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.to(device=device, dtype=dtype).eval()


def _martinez_f64(h, w1, s1, b1, w2, s2, b2):
    """The block in float64 throughout (h not rounded): the yardstick."""
    x = h.double()
    hh = torch.relu(x @ w1.double() * s1.double() + b1.double())
    return x + torch.relu(hh @ w2.double() * s2.double() + b2.double())


def martinez_kernel_phase(model) -> float:
    """The block kernel vs its plain version on the first block's input rows
    of seeded keypoints at every batch of MARTINEZ_BATCHES: rows, the f32
    and float64 yardsticks, two calls bitwise equal; row isolation inside
    a tile and across tile edges in a persistent CTA's second tile. Returns
    the max abs error at B=TOP."""
    fused = Mz.pack_martinez(model)
    w1, s1, b1, w2, s2, b2 = block = fused.blocks[0]
    gen = torch.Generator().manual_seed(SEED + 10)
    err = None
    for batch in MARTINEZ_BATCHES:
        h = Mz.martinez_input(fused, torch.rand(batch, 17, 2, generator=gen).to("cuda"))
        got, want = Mz.fused_residual_block(h, *block), Mz.fused_residual_block_reference(h, *block)
        e = _rows_check(f"martinez_block B={batch}", got, want,
                        Mz.fused_residual_block_reference(h.float(), w1.float(), s1, b1,
                                                          w2.float(), s2, b2))
        ref64 = _martinez_f64(h, *block)
        e64, p64 = ((t.double() - ref64).abs().max().item() for t in (got, want))
        floor = 2 ** -16 * ref64.abs().max().item()
        log(f"martinez_block B={batch} vs float64: kernel {e64:.6g}, plain {p64:.6g} "
            f"(limit {F32_ERR_RATIO} x plain + {floor:.3g})")
        if e64 > F32_ERR_RATIO * p64 + floor:
            raise AssertionError(f"martinez_block B={batch}: farther from float64 than plain")
        if not torch.equal(got, Mz.fused_residual_block(h, *block)):
            raise AssertionError(f"martinez_block B={batch}: two calls differ")
        if batch == TOP:
            err = e
    log("martinez_block: two calls bitwise equal at every batch")
    for batch, rows in ((200, (131,)), (TOP, MARTINEZ_EDGE_ROWS)):
        h = Mz.martinez_input(fused, torch.rand(batch, 17, 2, generator=gen).to("cuda"))
        pert = h.clone()
        for r in rows:
            pert[r] += 1.0
        base, out = Mz.fused_residual_block(h, *block), Mz.fused_residual_block(pert, *block)
        torch.cuda.synchronize()
        moved = (base != out).any(dim=1).nonzero().flatten().tolist()
        if moved != list(rows):
            raise AssertionError(f"row isolation B={batch}: perturbing rows {rows} moved "
                                 f"rows {moved[:10]}")
        log(f"martinez_block row isolation B={batch}, rows {rows}: ok")
    return err


def _martinez_plain(fused, svc, x):
    """The plain route on x padded to its service bucket, as lift pads it."""
    n = len(x)
    xp = torch.zeros((svc._bucket(n), 17, 2), device=x.device)
    xp[:n] = x
    h = Mz.martinez_input(fused, xp)
    for block in fused.blocks:
        h = Mz.fused_residual_block_reference(h, *block)
    return Mz.martinez_output(fused, h)[:n].reshape(n, 17, 3).cpu().numpy()


def martinez_serving_phase(model, model_f32):
    """Returns (service, the block launches the requests made)."""
    svc = LifterService(model, None, device="cuda", max_batch=TOP).warmup()
    if not svc.fused:
        raise AssertionError("the bf16 Martinez lifter is not on the kernel route")
    fused = Mz.pack_martinez(model)
    rng = np.random.default_rng(SEED + 11)
    requests = [rng.random((n, 17, 2)).astype(np.float32) for n in REQUESTS]
    expected = len(fused.blocks) * sum(-(-n // TOP) for n in REQUESTS)

    Mz.fused_residual_block.launches = 0
    answers = [svc.lift(kp) for kp in requests]
    launches = Mz.fused_residual_block.launches
    log(f"martinez serving: {len(REQUESTS)} requests, block launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError("the Martinez requests did not all go through the kernel")

    for kp, got in zip(requests, answers):
        n = len(kp)
        if got.shape != (n, 17, 3) or not np.isfinite(got).all():
            raise AssertionError(f"martinez N={n}: bad answer {got.shape}")
        x = torch.from_numpy(kp).to("cuda")
        ref32 = model_f32(x).reshape(n, 17, 3).cpu().numpy()
        plain = np.concatenate([
            _martinez_plain(fused, svc, x[i:i + TOP]) for i in range(0, n, TOP)])
        e32 = np.abs(got - ref32).max()
        ep = np.abs(got - plain).max()
        log(f"martinez serving N={n}: max abs err vs f32 module {e32:.6g} (atol "
            f"{F32_ATOL}; |f32| max {np.abs(ref32).max():.4g}), vs plain route {ep:.6g} "
            f"(atol {KERNEL_ATOL})")
        if e32 > F32_ATOL or ep > KERNEL_ATOL:
            raise AssertionError(f"martinez N={n}: answer out of tolerance")
    return svc, launches


def martinez_timing_phase(model, svc) -> dict:
    fused = Mz.pack_martinez(model)
    block = fused.blocks[0]
    kp = torch.rand(TOP, 17, 2, generator=torch.Generator().manual_seed(SEED + 12))
    kp_dev = kp.to("cuda")
    kp_np = kp.numpy()
    h = Mz.martinez_input(fused, kp_dev)
    t = {
        "martinez_block": cuda_ms(lambda: Mz.fused_residual_block(h, *block)),
        "martinez_block_plain": cuda_ms(lambda: Mz.fused_residual_block_reference(h, *block)),
        "martinez_two_matmuls": cuda_ms(lambda: (h @ block[0]) @ block[3]),
        "eager_bf16_module": cuda_ms(lambda: model(kp_dev)),
        "fused_forward": cuda_ms(lambda: Mz.martinez_infer_fused(fused, kp_dev)),
        "service_lift": cuda_ms(lambda: svc.lift(kp_np)),
    }
    for k in ("eager_bf16_module", "fused_forward", "service_lift"):
        log(f"time martinez B={TOP} {k}: {t[k]:.4f} ms = {TOP / t[k] * 1e3:.1f} frames/s")
    for k in ("martinez_block", "martinez_block_plain", "martinez_two_matmuls"):
        log(f"time martinez B={TOP} {k}: {t[k]:.4f} ms")
    for what, fn in (("fused_forward", lambda: Mz.martinez_infer_fused(fused, kp_dev)),
                     ("martinez_block", lambda: Mz.fused_residual_block(h, *block))):
        split = device_ms_by_kernel(fn)
        log(f"device time martinez B={TOP} {what}: {sum(split.values()):.4f} ms per call: "
            + top_kernels(split, 12))
    return t


def martinez_split_phase(model) -> None:
    """Logs each launch of one block call (GEMM 1 into h, GEMM 2 with the
    residual) at B = 64, 256 and TOP on the first block's input rows of
    seeded keypoints, by device ms (torch.profiler)."""
    fused = Mz.pack_martinez(model)
    block = fused.blocks[0]
    gen = torch.Generator().manual_seed(SEED + 13)
    for batch in MARTINEZ_SPLIT_BATCHES:
        h = Mz.martinez_input(fused, torch.rand(batch, 17, 2, generator=gen).to("cuda"))
        launches = device_launches(lambda: Mz.fused_residual_block(h, *block), 2)
        for i, (name, ms) in enumerate(launches):
            log(f"launch split martinez_block B={batch} GEMM {i + 1} "
                f"{name.split('(')[0][:60]}: {ms:.4f} ms")
        log(f"launch split martinez_block B={batch}: {len(launches)} launches, "
            f"{sum(ms for _, ms in launches):.4f} ms of device time")


def seeded_train_model():
    """The default TemporalLifter with f32 master weights on the card."""
    model = TemporalLifter(device="cpu").init_weights(torch.Generator().manual_seed(SEED))
    return model.to("cuda")


def synthetic_batch(n_clips, clip_len, seed):
    """(2D clips, root-centred 3D clips) on the card from the port's
    synthetic Human3.6M-like poses."""
    kp2d, kp3d = synthetic_h36m(n_clips * clip_len, seed=seed)
    y1 = make_clips(kp2d, clip_len)
    y2 = make_clips(kp3d - kp3d[:, :1], clip_len)
    return torch.from_numpy(y1).to("cuda"), torch.from_numpy(y2).to("cuda")


def _grad_check(what, got, want, ref32) -> float:
    """A gradient tensor: 2^-7 max|want| + 2^-7 |want| and the f32 yardstick."""
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    diff = (got - want).abs()
    excess = (diff - (GRAD_ATOL_REL * top + GRAD_RTOL * want.abs())).max().item()
    err32 = (got - ref32).abs().max().item()
    plain32 = (want - ref32).abs().max().item()
    floor = 2 ** -16 * ref32.abs().max().item()
    ok = torch.isfinite(got).all() and excess <= 0 and err32 <= F32_ERR_RATIO * plain32 + floor
    if not ok:
        log(f"FAILED {what}: max abs err {diff.max().item():.6g} (|want| max {top:.4g}, "
            f"excess {excess:.4g}); vs f32: kernel {err32:.6g}, plain {plain32:.6g}")
        raise AssertionError(f"kernel gradient disagrees with its plain version: {what}")
    return diff.max().item()


def train_kernel_phase(model) -> dict:
    """The four training wrappers vs their plain versions on the card, on
    the first sub-block inputs of synthetic clips: C = 16 clips, and C = 1
    (243 frames: 4,131 rows, not a multiple of the 128-row tile).
    Forward outputs and residuals as sub-block rows; dx and every weight
    gradient as gradients. Two backward calls must give bitwise equal
    results. Returns the max abs errors at C = 16."""
    errs = {}
    blk = model.blocks[0]
    with torch.no_grad():
        for n_clips in (1, TRAIN_CLIPS):
            y1, _ = synthetic_batch(n_clips, model.clip_len, SEED + 20 + n_clips)
            tokens = ST.embed_clips(model, y1, torch.bfloat16)
            gen = torch.Generator().manual_seed(SEED + 21)
            dout = (torch.randn(tokens.shape, generator=gen) * 2 ** -6).to("cuda", torch.bfloat16)
            for half, fwd, bwd, fref, bref, shape in (
                    ("spatial", ST.spatial_fwd, ST.spatial_bwd, ST.spatial_fwd_reference,
                     ST.spatial_bwd_reference, tokens.shape),
                    ("temporal", ST.slab_fwd, ST.slab_bwd, ST.slab_fwd_reference,
                     ST.slab_bwd_reference, (n_clips, model.clip_len, 17 * 256))):
                w = ST.pack_train(blk, half, torch.bfloat16)
                w32 = S.SubBlockWeights(w.flat.float())
                x, g = tokens.view(shape), dout.view(shape)
                got, want = fwd(x, w), fref(x, w)
                ref32 = fref(x.float(), w32)
                e_fwd = max(_rows_check(f"{fwd.__name__} {name} C={n_clips}", a, b, c)
                            for name, a, b, c in zip(("out", "x1", "att"), got, want, ref32))
                # the backward kernels on the plain forward's residuals
                dx, dw = bwd(x, *want[1:], g, w)
                dx_p, dw_p = bref(x, *want[1:], g, w)
                dx32, dw32 = bref(x.float(), *(t.float() for t in want[1:]), g.float(), w32)
                e_bwd = _grad_check(f"{bwd.__name__} dx C={n_clips}", dx, dx_p, dx32)
                pos = 0
                for name, shp, _, _ in S._LAYOUT:
                    n = math.prod(shp)
                    e_bwd = max(e_bwd, _grad_check(
                        f"{bwd.__name__} d{name} C={n_clips}", dw[pos:pos + n],
                        dw_p[pos:pos + n], dw32[pos:pos + n]))
                    pos += n
                dx2, dw2 = bwd(x, *want[1:], g, w)
                torch.cuda.synchronize()
                if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
                    raise AssertionError(f"{bwd.__name__}: two calls gave different gradients")
                log(f"{bwd.__name__} C={n_clips}: dx and 12 weight gradients within "
                    f"tolerance (max abs err {e_bwd:.6g}); two calls bitwise equal")
                errs[fwd.__name__], errs[bwd.__name__] = e_fwd, e_bwd
    return errs


# the training wrappers of the temporal trainer's step (ST.WRAPPERS also
# holds the joint-major pair, which phase 21 drives)
TRAIN_WRAPPERS = (ST.spatial_fwd, ST.spatial_bwd, ST.slab_fwd, ST.slab_bwd)


class plain_sub_blocks:
    """Within it, the training forward's sub-blocks run their plain
    versions on the card (the yardstick of the whole step)."""

    NAMES = ("spatial_fwd", "spatial_bwd", "slab_fwd", "slab_bwd")

    def __enter__(self):
        self.saved = {n: getattr(ST, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(ST, n, getattr(ST, f"{n}_reference"))

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(ST, n, f)


def _loss_and_grads(model, apply, y1, y2):
    model.zero_grad(set_to_none=True)
    loss = ((apply(model, y1) - y2) ** 2).mean()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def train_step_phase(model):
    """The whole training forward + backward on the kernels vs on the plain
    versions (same bf16 route) and vs the f32 module: the loss, and each
    parameter's gradient error in relative L2. The backward kernels
    recompute y, qkv and the MLP hidden with their own products, so they
    may differ from the forward kernels' intermediates by flipped bf16
    roundings; the limits (loss rtol 1e-2, relative L2 5e-2) cover that."""
    y1, y2 = synthetic_batch(TRAIN_CLIPS, model.clip_len, SEED + 22)
    fused = ST.temporal_train_forward_fused
    loss_k, g_k = _loss_and_grads(model, fused, y1, y2)
    with plain_sub_blocks():
        loss_p, g_p = _loss_and_grads(model, fused, y1, y2)
    loss_32, g_32 = _loss_and_grads(model, lambda m, x: m(x), y1, y2)
    model.zero_grad(set_to_none=True)
    rel = {n: ((g_k[n] - g_p[n]).norm() / g_p[n].norm()).item() for n in g_k}
    rel32_k = {n: ((g_k[n] - g_32[n]).norm() / g_32[n].norm()).item() for n in g_k}
    rel32_p = {n: ((g_p[n] - g_32[n]).norm() / g_32[n].norm()).item() for n in g_k}
    worst = max(rel, key=rel.get)
    worst32 = max(rel32_k, key=lambda n: rel32_k[n] / max(rel32_p[n], 1e-3))
    log(f"train step C={TRAIN_CLIPS}: loss kernels {loss_k:.8g}, plain {loss_p:.8g}, f32 module "
        f"{loss_32:.8g}; grads kernels vs plain: worst relative L2 {rel[worst]:.4g} ({worst}), "
        f"median {statistics.median(rel.values()):.4g}; vs the f32 module: worst kernels "
        f"{rel32_k[worst32]:.4g}, plain {rel32_p[worst32]:.4g} ({worst32})")
    if (not math.isfinite(loss_k) or abs(loss_k - loss_p) > 1e-2 * abs(loss_p)
            or rel[worst] > STEP_GRAD_REL
            or rel32_k[worst32] > F32_ERR_RATIO * max(rel32_p[worst32], 1e-3)):
        raise AssertionError("the fused training step disagrees with its plain version")


def train_loop_phase(model) -> tuple[dict, dict]:
    """TRAIN_STEPS AdamW steps (lr 1e-3) through ``make_lifter_train_step``
    on the fused route, distinct synthetic batches of TRAIN_CLIPS clips:
    the main path of the training slice. Each step must launch each
    training wrapper 5 times (one per block), and the loss must fall.
    Returns (the wrappers' launches, times)."""
    clips2d, clips3d = synthetic_batch(TRAIN_CLIPS * TRAIN_STEPS, model.clip_len, SEED + 23)
    batches = list(batch_iterator((clips2d.cpu().numpy(), clips3d.cpu().numpy()),
                                  TRAIN_CLIPS, shuffle=True, seed=SEED, epochs=1))
    state = create_train_state(model, lr=TRAIN_LR, apply=ST.temporal_train_forward_fused)
    step = make_lifter_train_step("mse")
    batches = [(torch.from_numpy(a).to("cuda"), torch.from_numpy(b).to("cuda"))
               for a, b in batches]
    for f in ST.WRAPPERS:
        f.launches = 0
    losses = [step(state, *b)["loss"].item() for b in batches]
    launches = {f.__name__: f.launches for f in ST.WRAPPERS}
    expected = {f.__name__: 5 * TRAIN_STEPS * (f in TRAIN_WRAPPERS) for f in ST.WRAPPERS}
    log(f"train loop: {TRAIN_STEPS} steps, loss " + ", ".join(f"{v:.5g}" for v in losses)
        + f"; launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("the training steps did not all go through the kernels")
    # Adam's first steps move every weight by ~lr and the loss may spike
    # before it falls: the last three steps' mean must be below the first
    if not all(math.isfinite(v) for v in losses) or not (
            statistics.mean(losses[-3:]) < losses[0]):
        raise AssertionError("the training loss did not fall")

    y1, y2 = batches[0]
    frames = TRAIN_CLIPS * model.clip_len
    t = {"train_step": cuda_ms(lambda: step(state, y1, y2))}
    bf16_model = TemporalLifter(device="cpu").to("cuda", torch.bfloat16)
    bf16_model.load_state_dict(model.state_dict())

    def eager_step():  # the yardstick: eager bf16 module, torch autograd (cuBLAS)
        bf16_model.zero_grad(set_to_none=True)
        ((bf16_model(y1) - y2) ** 2).mean().backward()

    t["eager_bf16_fwd_bwd"] = cuda_ms(eager_step)
    for k in ("train_step", "eager_bf16_fwd_bwd"):
        log(f"time C={TRAIN_CLIPS} x {model.clip_len} {k}: {t[k]:.4f} ms = "
            f"{frames / t[k] * 1e3:.1f} frames/s")
    split = device_ms_by_kernel(lambda: step(state, y1, y2), n=5)
    log(f"device time C={TRAIN_CLIPS} x {model.clip_len} train_step: "
        f"{sum(split.values()):.4f} ms per step: " + top_kernels(split, 16))

    blk = model.blocks[0]
    with torch.no_grad():
        tokens = ST.embed_clips(model, y1, torch.bfloat16)
        dout = (torch.randn(tokens.shape, generator=torch.Generator().manual_seed(SEED + 24))
                * 2 ** -6).to("cuda", torch.bfloat16)
        for half, fwd, bwd, fref, bref, shape in (
                ("spatial", ST.spatial_fwd, ST.spatial_bwd, ST.spatial_fwd_reference,
                 ST.spatial_bwd_reference, tokens.shape),
                ("temporal", ST.slab_fwd, ST.slab_bwd, ST.slab_fwd_reference,
                 ST.slab_bwd_reference, (TRAIN_CLIPS, model.clip_len, 17 * 256))):
            w = ST.pack_train(blk, half, torch.bfloat16)
            x, g = tokens.view(shape), dout.view(shape)
            _, x1, att = fwd(x, w)
            t[fwd.__name__] = cuda_ms(lambda: fwd(x, w))
            t[f"{fwd.__name__}_plain"] = cuda_ms(lambda: fref(x, w))
            t[bwd.__name__] = cuda_ms(lambda: bwd(x, x1, att, g, w))
            t[f"{bwd.__name__}_plain"] = cuda_ms(lambda: bref(x, x1, att, g, w))
    for f in TRAIN_WRAPPERS:
        log(f"time C={TRAIN_CLIPS} x {model.clip_len} {f.__name__}: {t[f.__name__]:.4f} ms, "
            f"plain {t[f.__name__ + '_plain']:.4f} ms")
    return launches, t


DEVICE_LAUNCH_CALLS = 4  # calls of fn() in device_launches' recorded step


def calls_kernels(call_starts: list[float], kernels: list[tuple[float, str, float]]
                  ) -> list[list[tuple[str, float]]]:
    """Sorts kernels ((start, name, ms), one clock with call_starts) into
    the calls that launched them: a kernel belongs to the last call that
    started before it (each call ends with a synchronize, and a 1 ms pause
    stands on either side of each call's start)."""
    calls = [[] for _ in call_starts]
    for start, name, ms in sorted(kernels):
        owner = [i for i, s in enumerate(call_starts) if s <= start]
        if owner:
            calls[owner[-1]].append((name, ms))
    return calls


def complete_call(calls: list[list[tuple[str, float]]], expected: int | None
                  ) -> list[tuple[str, float]] | None:
    """The calls that hold `expected` kernels (by default the count that
    most calls hold, the larger on a tie), all with the first such call's
    kernel names: each kernel's name and its median ms over them; None
    when no call does."""
    counts = [len(c) for c in calls if c]
    if not counts:
        return None
    want = expected if expected is not None else max(statistics.multimode(counts))
    whole = [c for c in calls if c and len(c) == want]
    if not whole:
        return None
    names = [n for n, _ in whole[0]]
    same = [c for c in whole if [n for n, _ in c] == names]
    return [(n, statistics.median(c[i][1] for c in same)) for i, n in enumerate(names)]


def device_launches(fn, expected: int | None = None) -> list[tuple[str, float]]:
    """Each kernel that one call of fn() launches, in launch order: (its
    full name, its device ms, the median over the calls recorded whole),
    from torch.profiler's CUDA activity. The recorded step follows a
    warm-up call inside the profiler (a step of its schedule) and holds
    DEVICE_LAUNCH_CALLS calls, each in a record_function range. In a
    process that has profiled before, a kernel at the edge of a window can
    go unrecorded, or a window can come back empty, so the kernels are
    sorted into their calls by the ranges' starts and only calls with
    `expected` kernels are kept; a step with none is taken again, three
    times at most."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    tags = [f"device_launches call {i}" for i in range(DEVICE_LAUNCH_CALLS)]
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for tag in tags:
                time.sleep(1e-3)  # 1 ms between one call's kernels and the next range
                with record_function(tag):
                    time.sleep(1e-3)  # and between the range's start and its kernels
                    fn()
                    torch.cuda.synchronize()
        events = prof.events()
        starts = sorted(e.time_range.start for e in events
                        if e.device_type == cpu and e.name in tags)
        kernels = [(e.time_range.start,
                    e.name.removeprefix("void ").replace("(anonymous namespace)::", ""),
                    e.time_range.elapsed_us() / 1e3)
                   for e in events if e.device_type == cuda and not e.is_user_annotation]
        calls = calls_kernels(starts, kernels)
        got = complete_call(calls, expected)
        if got:
            if len({len(c) for c in calls}) > 1:
                log(f"device_launches: the calls held {[len(c) for c in calls]} kernels; "
                    f"kept those with {len(got)}")
            return got
        log(f"device_launches: torch.profiler recorded {len(kernels)} kernels, "
            f"{[len(c) for c in calls]} a call"
            + (f", not {expected}" if expected else "") + "; recording again")
    raise AssertionError(f"torch.profiler recorded no call of fn() whole: {len(kernels)} "
                         f"kernels, {[len(c) for c in calls]} a call"
                         + (f", not {expected}" if expected else ""))


WGRAD_ITEMS = 132  # csrc/stblock_train.cu's kWgradItems: split-K work items of a weight gradient


def _wgrad_slices(m: int, n: int, rows: int) -> int:
    """The K slices (of 64-row chunks) of csrc/stblock_train.cu's
    weight_grad for an m x n gradient over `rows` rows."""
    tiles = (m // 128) * (n // 256)
    chunks = -(-rows // 64)
    per = -(-chunks // max(1, min(chunks, WGRAD_ITEMS // tiles)))
    return -(-chunks // per)


def bwd_launches(rows: int, n_seq: int, length: int) -> list[tuple[str, float, float, float]]:
    """(kernel name key, bytes it reads and writes, matrix-product flops,
    exponentials) of each launch of one sub-block backward on `rows` rows
    in n_seq sequences of `length`, in launch order. Bytes count each
    operand once; flops and exponentials count the work itself, not a
    kernel's recomputation (the attention backward: five L x L x 32
    products a head, one exponential a score)."""
    e, f = 2, 4  # bytes of bf16, f32
    d, q, hid = 256, 768, 1024
    rd, rq, rh = rows * d, rows * q, rows * hid
    tiles = -(-rows // 128)  # 128-row tiles: the LayerNorm products' partial a tile
    parts = tiles * 8  # db1's partials: one a warp of a tile

    def fold(slices, count):
        return ("sum_slices", slices * count * f + count * f, 0, 0)

    def wgrad(m, n):
        s = _wgrad_slices(m, n, rows)
        return [("gemm_kernel<true, true", rows * (m + n) * e + s * m * n * f, 2 * rows * m * n,
                 0), fold(s, m * n)]

    scores = n_seq * 8 * length * length
    return [
        ("ln_rows", 2 * rd * e, 0, 0), ("ln_rows", 2 * rd * e, 0, 0),
        ("qkv_kernel<", rd * e + d * q * e + q * e + rq * e, 2 * rows * d * q, 0),
        ("mlp_bwd", 2 * rd * e + 2 * d * hid * e + hid * e + 2 * rh * e + parts * hid * f,
         4 * rows * d * hid, 0),
        fold(parts, hid),
        ("ln_gemm_kernel<true", rh * e + d * hid * e + rd * (3 * e + f) + d * e
         + tiles * 4 * d * f, 2 * rows * hid * d, 0),
        fold(tiles, 3 * d), fold(tiles, d),
        *wgrad(hid, d), *wgrad(d, hid), *wgrad(d, d),
        ("gemm_kernel<false, false", rd * e + d * d * e + rd * f, 2 * rows * d * d, 0),
        ("attention_bwd", 2 * rq * e + rd * f + n_seq * q * f, 5 * 2 * scores * 32, scores),
        fold(n_seq, q),
        *wgrad(d, q),
        ("ln_gemm_kernel<false", rq * e + d * q * e + rd * (2 * e + f) + d * e
         + tiles * 2 * d * f, 2 * rows * q * d, 0),
        fold(tiles, 2 * d)]


def max_sm_clock() -> float:
    """The card's maximum SM clock in Hz (nvidia-smi)."""
    return float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()) * 1e6


def launch_bound(flops: float, nbytes: float, exps: float, clock: float) -> tuple[float, str]:
    """A launch's least ms: the larger of its products' flops over the bf16
    peak, its bytes over the HBM rate and its exponentials over the SFUs
    (SFU_EXP_PER_CLOCK a clock at ``clock`` Hz)."""
    ms, by = bound(flops, nbytes)
    t_exp = exps / (SFU_EXP_PER_CLOCK * clock) * 1e3
    return (t_exp, "exponentials") if t_exp > ms else (ms, by)


def backward_split_phase(model) -> dict:
    """Each launch of one spatial_bwd and one slab_bwd call at TRAIN_CLIPS
    x 243 frames: its name, device ms (torch.profiler), reckoned bytes and
    bound (``bwd_launches``, ``launch_bound``). Returns the bytes a call
    moves, by wrapper."""
    blk = model.blocks[0]
    y1, _ = synthetic_batch(TRAIN_CLIPS, model.clip_len, SEED + 25)
    clock = max_sm_clock()
    moved = {}
    with torch.no_grad():
        tokens = ST.embed_clips(model, y1, torch.bfloat16)
        dout = (torch.randn(tokens.shape, generator=torch.Generator().manual_seed(SEED + 26))
                * 2 ** -6).to("cuda", torch.bfloat16)
        rows = tokens.shape[0]
        for half, fwd, bwd, shape, n_seq, length in (
                ("spatial", ST.spatial_fwd, ST.spatial_bwd, tokens.shape, rows // 17, 17),
                ("temporal", ST.slab_fwd, ST.slab_bwd,
                 (TRAIN_CLIPS, model.clip_len, 17 * 256), TRAIN_CLIPS * 17, model.clip_len)):
            w = ST.pack_train(blk, half, torch.bfloat16)
            x, g = tokens.view(shape), dout.view(shape)
            _, x1, att = fwd(x, w)
            table = bwd_launches(rows, n_seq, length)
            for attempt in range(3):  # the profiler can drop a window's first kernels
                launches = device_launches(lambda: bwd(x, x1, att, g, w), expected=len(table))
                if all(key in name for (key, *_), (name, _) in zip(table, launches)):
                    break
                log(f"launch split {bwd.__name__}: the profiler recorded "
                    f"{[n for n, _ in launches]}, not this design's launches; recording again")
            else:
                raise AssertionError(f"{bwd.__name__}: launches {[n for n, _ in launches]} "
                                     f"are not this design's")
            total_bound = 0.0
            for i, ((name, ms), (_, nbytes, flops, exps)) in enumerate(zip(launches, table)):
                b_ms, by = launch_bound(flops, nbytes, exps, clock)
                total_bound += b_ms
                log(f"launch split {bwd.__name__} {i + 1:2d} {name.split('(')[0][:60]}: "
                    f"{ms:.4f} ms, {nbytes / 1e6:.1f} MB, bound {b_ms:.4f} ms ({by}), "
                    f"{b_ms / ms:.0%} of it")
            moved[bwd.__name__] = sum(b for _, b, _, _ in table)
            log(f"launch split {bwd.__name__}: {len(launches)} launches, "
                f"{sum(ms for _, ms in launches):.4f} ms of device time, "
                f"{moved[bwd.__name__] / 1e9:.3f} GB reckoned, launches' bounds "
                f"{total_bound:.4f} ms (SM clock {clock / 1e6:.0f} MHz)")
    return moved


SUB_BLOCK_PRODUCTS = (("qkv", 256, 768), ("proj", 256, 256), ("w1", 256, 1024),
                      ("w2", 1024, 256))  # a sub-block's four products: (in, out)


def forward_split_phase(model) -> None:
    """Logs each launch of the four sub-block forwards at TRAIN_CLIPS x
    243 frames (66,096 token rows): spatial and slab, serving and training
    (kSave), by kernel, device ms per call from torch.profiler over
    N_TIMED calls; and a sub-block's four products alone as bf16
    ``torch.matmul`` at the same shapes (a yardstick of what the card's
    GEMMs do here; the port never calls it)."""
    blk = model.blocks[0]
    y1, _ = synthetic_batch(TRAIN_CLIPS, model.clip_len, SEED + 27)
    with torch.no_grad():
        tokens = ST.embed_clips(model, y1, torch.bfloat16)
        rows = tokens.shape[0]
        slab = tokens.view(TRAIN_CLIPS, model.clip_len, 17 * 256)
        for name, fn, x, half in (("spatial_block", S.spatial_block, tokens, "spatial"),
                                  ("spatial_fwd", ST.spatial_fwd, tokens, "spatial"),
                                  ("temporal_slab", S.temporal_slab, slab, "temporal"),
                                  ("slab_fwd", ST.slab_fwd, slab, "temporal")):
            w = ST.pack_train(blk, half, torch.bfloat16)
            split = device_ms_by_kernel(lambda: fn(x, w))
            for kernel, ms in split.items():
                log(f"forward split {name} {kernel.split('(')[0][:70]}: {ms:.4f} ms")
            log(f"forward split {name}: {len(split)} kernels, {sum(split.values()):.4f} ms of "
                "device time")
        gen = torch.Generator().manual_seed(SEED + 28)
        total = 0.0
        for what, k, n in SUB_BLOCK_PRODUCTS:
            a = torch.randn(rows, k, generator=gen).to("cuda", torch.bfloat16)
            b = torch.randn(k, n, generator=gen).to("cuda", torch.bfloat16)
            ms = cuda_ms(lambda: a @ b)
            total += ms
            log(f"forward split torch.matmul {what} {rows} x {k} @ {k} x {n}: {ms:.4f} ms")
        log(f"forward split torch.matmul, the four products: {total:.4f} ms "
            f"({2 * rows * sum(k * n for _, k, n in SUB_BLOCK_PRODUCTS) / total / 1e9:.1f} "
            "TFLOP/s)")


def trunk_split_phase(model) -> float:
    """Logs each launch of one trunk call at B = TOP by device ms
    (torch.profiler), and times row 1's yardstick: the trunk's eight
    products (qkv, projection, W1, W2 of each block) as bf16
    ``torch.matmul`` on the same weights at TOP x 17 rows (the port never
    calls it). Returns the yardstick's ms."""
    w = L.pack_weights(model)
    kp = torch.rand(TOP, 17, 2, generator=torch.Generator().manual_seed(SEED + 51))
    tokens = L.embed_tokens(model, kp.to("cuda"))
    launches = device_launches(lambda: L.trunk(tokens, model.pe, w))
    for i, (name, ms) in enumerate(launches):
        log(f"forward split lifter trunk {i + 1} {name.split('(')[0][:70]}: {ms:.4f} ms")
    log(f"forward split lifter trunk: {len(launches)} launches, "
        f"{sum(ms for _, ms in launches):.4f} ms of device time")
    rows = tokens.shape[0]
    gen = torch.Generator().manual_seed(SEED + 52)
    ins = {k: torch.randn(rows, k, generator=gen).to("cuda", torch.bfloat16) for k in (256, 1024)}
    mats = [w.block(i)[name] for i in range(w.n_blocks)
            for name in ("w_qkv", "w_proj", "w1", "w2")]
    ms = cuda_ms(lambda: [ins[m.shape[0]] @ m for m in mats])
    flops = 2 * rows * sum(m.numel() for m in mats)
    log(f"forward split torch.matmul, the trunk's {len(mats)} products at {rows} rows: "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
    return ms


def seeded_posenet(device, dtype):
    """The default PoseNet3D from the seed, its final conv x FINAL_SCALE."""
    model = PoseNet3D(device="cpu").init_weights(torch.Generator().manual_seed(SEED))
    model.final_layer.weight.data.mul_(FINAL_SCALE)
    return model.to(device=device, dtype=dtype).eval()


def direct_frames(n, seed):
    return torch.from_numpy(synthetic_frames(n, DIRECT_SIZE, seed=seed)).to("cuda")


def _decode_check(what, kernel, plain, ref64, args, spread_check=True) -> float:
    """A decode kernel vs its plain version: coordinates within DECODE_ATOL,
    the kernel's error against ref64, the same function in float64, at
    most F32_ERR_RATIO x the plain version's (+ 2^-16 of the largest
    coordinate), two calls bitwise equal, and (unless spread_check is
    off) coordinates that spread. Returns the max abs error."""
    got, again = kernel(*args), kernel(*args)
    want = plain(*args)
    ref = ref64(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err_k = (got.double() - ref).abs().max().item()
    err_p = (want.double() - ref).abs().max().item()
    floor = 2 ** -16 * ref.abs().max().item()
    spread = got.std().item()
    log(f"kernel vs plain, {what}: max abs err {err:.6g} (atol {DECODE_ATOL}); vs float64: "
        f"kernel {err_k:.6g}, plain {err_p:.6g}; coordinate std {spread:.4g}")
    if not torch.isfinite(got).all() or err > DECODE_ATOL or err_k > F32_ERR_RATIO * err_p + floor:
        raise AssertionError(f"kernel disagrees with its plain version: {what}")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two calls gave different coordinates")
    if spread_check and spread < MIN_SPREAD:
        raise AssertionError(f"{what}: the coordinates do not spread (std {spread:.4g})")
    return err


def planted_logits(b, h, w, j, d):
    """N(0, 1) + 100 bf16 logits (B, H, W, J*D) with a +30 peak at a seeded
    voxel per (sample, joint), and the peaks' (B, J, 3) [x, y, depth]
    indices: against 262,144 others a peak holds all but ~1e-7 of the
    mass, so the coordinates sit on it."""
    gen = torch.Generator().manual_seed(SEED + 31)
    where = torch.stack([torch.randint(0, n, (b, j), generator=gen) for n in (w, h, d)], -1)
    planted = torch.randn(b, h * w, j, d, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(SEED + 31)) + 100
    bi, ji = torch.meshgrid(torch.arange(b), torch.arange(j), indexing="ij")
    idx = [t.flatten().to("cuda") for t in (bi, where[..., 1] * w + where[..., 0], ji,
                                             where[..., 2])]
    planted[tuple(idx)] += 30
    return planted.to(torch.bfloat16).view(b, h, w, j * d), where


def direct_kernel_phase(model) -> dict:
    """The two decode kernels vs their plain versions at B = DIRECT_B on
    the model's own head output, on planted peaks, on large logits and at
    J = 3. Returns the max abs errors on the model's own tensors."""
    j, d = model.num_joints, model.depth
    feats = model.features(direct_frames(DIRECT_B, SEED + 30))
    logits = model.final_layer(feats).permute(0, 2, 3, 1)  # a view: NHWC in memory
    if not logits.is_contiguous():
        raise AssertionError("the final conv's output is not channels_last")
    errs = {}

    def soft(x, jj):
        return (lambda t: SA.soft_argmax_3d_nhwc_kernel(t, jj, d),
                lambda t: SA.soft_argmax_3d_nhwc_reference(t, jj, d),
                lambda t: SA.soft_argmax_3d_nhwc_reference(t.double(), jj, d), (x,))

    b, h, w = logits.shape[:3]
    planted, where = planted_logits(b, h, w, j, d)
    errs["soft_argmax_nhwc"] = _decode_check(f"soft_argmax_nhwc B={b} model logits",
                                             *soft(logits, j))
    _decode_check(f"soft_argmax_nhwc B={b} planted peaks, logits ~100", *soft(planted, j))
    peaks = torch.stack([where[..., 0] / w, where[..., 1] / h, where[..., 2] / d], -1)
    peaks = (peaks - 0.5) * torch.tensor([2.0, 2.0, model.z_scale])
    miss = (SA.soft_argmax_3d_nhwc_kernel(planted, j, d).cpu().view(b, j, 3) - peaks).abs().max()
    log(f"soft_argmax_nhwc planted peaks: max distance to the peaks {miss.item():.6g}")
    if miss > 5e-3:
        raise AssertionError("soft_argmax_nhwc did not find the planted peaks")
    # J = 3: three joints of the logits above (their spread is not asserted again)
    _decode_check(f"soft_argmax_nhwc B={b} J=3", *soft(logits[..., :3 * d].contiguous(), 3),
                  spread_check=False)

    nhwc = feats.permute(0, 2, 3, 1)
    weight = model.final_layer.weight.view(j * d, -1)
    bias = model.final_layer.bias.float()

    def fused(wt, bs, jj):
        return (lambda *a: CD.conv_soft_argmax_3d_fused(*a, jj, d),
                lambda *a: CD.conv_soft_argmax_3d_reference(*a, jj, d),
                lambda f, w_, b_: H.soft_argmax_3d_nhwc(
                    f.double() @ w_.double().t() + b_.double(), jj, d), (nhwc, wt, bs))

    errs["conv_decode"] = _decode_check(f"conv_decode B={b} model features",
                                        *fused(weight, bias, j))
    _decode_check(f"conv_decode B={b} bias +200", *fused(weight, bias + 200, j))
    _decode_check(f"conv_decode B={b} J=3", *fused(weight[:3 * d], bias[:3 * d], 3),
                  spread_check=False)
    return errs


ROUTES = {"heatmap": (True, False), "nhwc": (False, False), "fused": (False, True)}
DECODE_KERNELS = (SA.soft_argmax_3d_nhwc_kernel, CD.conv_soft_argmax_3d_fused)


def set_route(model, route):
    model.return_heatmap, model.fuse_final_conv = ROUTES[route]
    return model


def _plain_route(model, route, x):
    """The route on the plain versions, from the model's own features."""
    feats = model.features(x)
    j, d = model.num_joints, model.depth
    if route == "fused":
        return CD.conv_soft_argmax_3d_reference(
            feats.permute(0, 2, 3, 1), model.final_layer.weight.view(j * d, -1),
            model.final_layer.bias.float(), j, d, z_scale=model.z_scale)
    logits = model.final_layer(feats)
    if route == "nhwc":
        return H.soft_argmax_3d_nhwc(logits.permute(0, 2, 3, 1), j, d, z_scale=model.z_scale)
    b, _, h, w = logits.shape
    return H.soft_argmax_3d(logits.reshape(b, j, d, h, w), j, d, h, w, z_scale=model.z_scale)[0]


def direct_forward_phase(model, model_f32) -> dict:
    """PoseNet3D's forward on each route at B = DIRECT_B, each route's
    kernel launches counted from 0, and the eval chunk step on the fused
    route (its count from 0 as well). Returns each decode kernel's
    launches on its route and, for the conv decode, in the chunk step."""
    x = direct_frames(DIRECT_B, SEED + 32)
    expected = {"heatmap": (0, 0), "nhwc": (1, 0), "fused": (0, 1)}
    launches = {}
    for route in ROUTES:
        for f in DECODE_KERNELS:
            f.launches = 0
        coords, heatmap = set_route(model, route)(x)
        made = tuple(f.launches for f in DECODE_KERNELS)
        torch.cuda.synchronize()
        for f, n in zip(DECODE_KERNELS, made):
            launches[f.__name__] = launches.get(f.__name__, 0) + n
        plain = _plain_route(model, route, x)
        ref32 = set_route(model_f32, route)(x)[0]
        ep = (coords - plain).abs().max().item()
        e32 = (coords - ref32).abs().max().item()
        spread = coords.std().item()
        log(f"direct forward {route} B={DIRECT_B}: launches soft_argmax {made[0]}, conv_decode "
            f"{made[1]} (expected {expected[route]}); max abs err vs plain route {ep:.6g}, vs "
            f"f32 module {e32:.6g} (atol {DIRECT_ATOL}); coordinate std {spread:.4g}")
        if made != expected[route]:
            raise AssertionError(f"the {route} route did not take its kernels")
        if (coords.shape != (DIRECT_B, 51) or not torch.isfinite(coords).all()
                or ep > DIRECT_ATOL or e32 > DIRECT_ATOL or spread < MIN_SPREAD):
            raise AssertionError(f"the {route} route is out of tolerance")
        if route == "heatmap":
            sums = heatmap.sum(dim=(2, 3, 4))
            side = DIRECT_SIZE // 4
            if heatmap.shape != (DIRECT_B, 17, 64, side, side) or (sums - 1).abs().max() > 1e-4:
                raise AssertionError("the heatmap is not a normalised (B, J, D, H, W) volume")

    set_route(model, "fused")
    rng = np.random.default_rng(SEED + 33)
    frames = torch.from_numpy(rng.integers(0, 256, (DIRECT_CHUNK, DIRECT_B, DIRECT_SIZE,
                                                    DIRECT_SIZE, 3), dtype=np.uint8)).to("cuda")
    kp3d = torch.from_numpy(rng.uniform(-1, 1, (DIRECT_CHUNK, DIRECT_B, 17, 3))).float().to("cuda")
    state = create_train_state(model, lr=1e-3)
    CD.conv_soft_argmax_3d_fused.launches = 0
    out = make_direct_eval_chunk_step("mse")(state, frames, kp3d)
    n = CD.conv_soft_argmax_3d_fused.launches
    single = [make_direct_eval_step("mse")(state, f, y) for f, y in zip(frames, kp3d)]
    want_loss = torch.stack([o["loss"] for o in single]).mean()
    want_sums = torch.stack([o["mpjpe_sums"] for o in single]).sum(0)
    log(f"eval chunk step, {DIRECT_CHUNK} x {DIRECT_B} uint8 frames: loss "
        f"{out['loss'].item():.6g}, conv_decode launches {n} (expected {DIRECT_CHUNK})")
    if (n != DIRECT_CHUNK or out["mpjpe_sums"].shape != (17,)
            or not torch.isfinite(out["mpjpe_sums"]).all()
            or not torch.allclose(out["loss"], want_loss, rtol=1e-5, atol=0)
            or not torch.allclose(out["mpjpe_sums"], want_sums, rtol=1e-5, atol=0)):
        raise AssertionError("the eval chunk step is not the mean of its batches' eval steps")
    launches[CD.conv_soft_argmax_3d_fused.__name__] += n
    return launches


def direct_timing_phase(model) -> dict:
    j, d = model.num_joints, model.depth
    x = direct_frames(DIRECT_B, SEED + 34)
    feats = model.features(x)
    logits = model.final_layer(feats).permute(0, 2, 3, 1)
    nhwc = feats.permute(0, 2, 3, 1)
    weight = model.final_layer.weight.view(j * d, -1)
    bias = model.final_layer.bias.float()
    rows = nhwc.reshape(-1, nhwc.shape[-1])  # a view: (B*H*W, 256)
    t = {
        "soft_argmax_nhwc": cuda_ms(lambda: SA.soft_argmax_3d_nhwc_kernel(logits, j, d)),
        "soft_argmax_nhwc_plain": cuda_ms(
            lambda: SA.soft_argmax_3d_nhwc_reference(logits, j, d)),
        "conv_decode": cuda_ms(lambda: CD.conv_soft_argmax_3d_fused(nhwc, weight, bias, j, d)),
        "conv_decode_plain": cuda_ms(
            lambda: CD.conv_soft_argmax_3d_reference(nhwc, weight, bias, j, d)),
        "conv_decode_matmul": cuda_ms(lambda: rows @ weight.t()),
    }
    for route in ROUTES:
        t[f"forward_{route}"] = cuda_ms(lambda: set_route(model, route)(x))
        log(f"time direct B={DIRECT_B} forward {route}: {t[f'forward_{route}']:.4f} ms = "
            f"{DIRECT_B / t[f'forward_{route}'] * 1e3:.1f} frames/s")
    for k in ("soft_argmax_nhwc", "soft_argmax_nhwc_plain", "conv_decode", "conv_decode_plain",
              "conv_decode_matmul"):
        log(f"time direct B={DIRECT_B} {k}: {t[k]:.4f} ms")
    split = device_ms_by_kernel(lambda: set_route(model, "fused")(x), n=5)
    groups = by_kind(split, (("decode", ("decode_kernel", "merge_kernel")),
                             ("convolutions", ("conv", "gemm", "xmma", "fprop", "dgrad", "nvjet",
                                               "cutlass")),
                             ("batch norm", ("bn_", "batch_norm")),
                             ("casts and copies", ("copy",))))
    busy = sum(split.values())
    log(f"device time direct B={DIRECT_B} forward fused: {busy:.4f} ms per call, "
        f"{busy / t['forward_fused']:.1%} of its event-timed {t['forward_fused']:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in groups.items()) + "; by kernel: "
        + top_kernels(split, 12))
    return t


def _grad_check_f64(what, got, again, want, ref64) -> float:
    """A backward kernel's output vs its plain version: the kernel's error
    against ref64, the plain version run in float64, at most F32_ERR_RATIO
    x the plain version's (+ 2^-16 of the largest float64 value), two
    calls bitwise equal. Returns the max abs error against the plain
    version."""
    err = (got.float() - want.float()).abs().max().item()
    err_k = (got.double() - ref64).abs().max().item()
    err_p = (want.double() - ref64).abs().max().item()
    top = ref64.abs().max().item()
    log(f"kernel vs plain, {what}: max abs err {err:.6g}; vs float64: kernel {err_k:.6g}, "
        f"plain {err_p:.6g} (|float64| max {top:.4g})")
    if not torch.isfinite(got).all() or err_k > F32_ERR_RATIO * err_p + 2 ** -16 * top:
        raise AssertionError(f"backward kernel disagrees with its plain version: {what}")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two calls gave different gradients")
    return err


def direct_backward_phase(model) -> dict:
    """The two decode backwards vs their plain versions at B = DIRECT_B on
    the model's own head output, at J = 3 and on logits of ~100 (planted
    peaks for the soft-argmax, +100 on the bias for the conv decode), the
    gradients g of the expectations drawn from the seed. Returns the max
    abs errors on the model's own tensors."""
    j, d = model.num_joints, model.depth
    feats = model.features(direct_frames(DIRECT_B, SEED + 40))
    logits = model.final_layer(feats).permute(0, 2, 3, 1)
    gen = torch.Generator().manual_seed(SEED + 41)
    b, h, w = logits.shape[:3]

    def soft(x, jj, what):
        g = torch.randn(b, jj, 3, generator=gen).to("cuda")
        e, stats = SA.soft_argmax_3d_nhwc_expectations(x, jj, d, with_stats=True)
        got, again = (SA.soft_argmax_3d_nhwc_backward(x, e, stats, g) for _ in range(2))
        want = SA.soft_argmax_3d_nhwc_backward_reference(x, e, g, jj, d)
        ref = SA.soft_argmax_3d_nhwc_backward_reference(x.double(), e.double(), g.double(),
                                                        jj, d)
        torch.cuda.synchronize()
        return _grad_check_f64(f"soft_argmax_nhwc_bwd B={b} {what} dx", got, again, want, ref)

    errs = {"soft_argmax_nhwc_bwd": soft(logits, j, "model logits")}
    soft(logits[..., :3 * d].contiguous(), 3, "J=3")
    soft(planted_logits(b, h, w, j, d)[0], j, "planted peaks, logits ~100")

    nhwc = feats.permute(0, 2, 3, 1)
    weight = model.final_layer.weight.view(j * d, -1)
    bias = model.final_layer.bias.float()

    def fused(wt, bs, jj, what):
        g = torch.randn(b, jj, 3, generator=gen).to("cuda")
        e, stats = CD.conv_soft_argmax_3d_expectations(nhwc, wt, bs, jj, d, with_stats=True)
        got, again = (CD.conv_soft_argmax_3d_backward(nhwc, wt, bs, e, stats, g)
                      for _ in range(2))
        want = CD.conv_soft_argmax_3d_backward_reference(nhwc, wt, bs, e, g, jj, d)
        ref = CD.conv_soft_argmax_3d_backward_reference(nhwc.double(), wt.double(), bs.double(),
                                                        e.double(), g.double(), jj, d)
        torch.cuda.synchronize()
        return max(_grad_check_f64(f"conv_decode_bwd B={b} {what} {name}", *args)
                   for name, *args in zip(("dfeats", "dW", "db"), got, again, want, ref))

    errs["conv_decode_bwd"] = fused(weight, bias, j, "model features")
    fused(weight, bias + 100, j, "bias +100")
    fused(weight[:3 * d], bias[:3 * d], 3, "J=3")
    return errs


def direct_backward_timing_phase(model) -> dict:
    """Each decode backward, its plain version and, for the conv decode,
    its three products (the logits' recompute, dfeats, dW) as bf16
    ``torch.matmul`` (a yardstick; the port never calls it), at B =
    DIRECT_B on the model's own tensors."""
    j, d = model.num_joints, model.depth
    feats = model.features(direct_frames(DIRECT_B, SEED + 42))
    logits = model.final_layer(feats).permute(0, 2, 3, 1)
    nhwc = feats.permute(0, 2, 3, 1)
    weight = model.final_layer.weight.view(j * d, -1)
    bias = model.final_layer.bias.float()
    g = torch.randn(DIRECT_B, j, 3, generator=torch.Generator().manual_seed(SEED + 43)).to("cuda")
    e, stats = SA.soft_argmax_3d_nhwc_expectations(logits, j, d, with_stats=True)
    fe, fstats = CD.conv_soft_argmax_3d_expectations(nhwc, weight, bias, j, d, with_stats=True)
    rows = nhwc.reshape(-1, nhwc.shape[-1])  # a view: (B*H*W, 256)
    dslab = torch.randn(rows.shape[0], j * d, device="cuda", dtype=torch.bfloat16)
    t = {
        "soft_argmax_nhwc_bwd": cuda_ms(
            lambda: SA.soft_argmax_3d_nhwc_backward(logits, e, stats, g)),
        "soft_argmax_nhwc_bwd_plain": cuda_ms(
            lambda: SA.soft_argmax_3d_nhwc_backward_reference(logits, e, g, j, d)),
        "conv_decode_bwd": cuda_ms(
            lambda: CD.conv_soft_argmax_3d_backward(nhwc, weight, bias, fe, fstats, g)),
        "conv_decode_bwd_plain": cuda_ms(
            lambda: CD.conv_soft_argmax_3d_backward_reference(nhwc, weight, bias, fe, g, j, d)),
        "conv_decode_bwd_matmuls": cuda_ms(
            lambda: (rows @ weight.t(), dslab @ weight, dslab.t() @ rows)),
    }
    for k, ms in t.items():
        log(f"time direct B={DIRECT_B} {k}: {ms:.4f} ms")
    return t


def decode_backward_split_phase(model) -> None:
    """Logs each launch of one conv-decode backward (kernel 13b: A, the
    dfeats launch; B, the dW and db partials; C, their fold) at B =
    DIRECT_B on the model's own head features, by device ms
    (torch.profiler)."""
    j, d = model.num_joints, model.depth
    with torch.inference_mode():
        nhwc = model.features(direct_frames(DIRECT_B, SEED + 44)).permute(0, 2, 3, 1)
        weight = model.final_layer.weight.view(j * d, -1)
        bias = model.final_layer.bias.float()
        g = torch.randn(DIRECT_B, j, 3,
                        generator=torch.Generator().manual_seed(SEED + 45)).to("cuda")
        e, stats = CD.conv_soft_argmax_3d_expectations(nhwc, weight, bias, j, d, with_stats=True)
        launches = device_launches(
            lambda: CD.conv_soft_argmax_3d_backward(nhwc, weight, bias, e, stats, g), 3)
    for i, (name, ms) in enumerate(launches):
        log(f"launch split conv_decode_bwd {'ABC'[i] if i < 3 else i + 1} "
            f"{name.split('(')[0][:60]}: {ms:.4f} ms")
    log(f"launch split conv_decode_bwd: {len(launches)} launches, "
        f"{sum(ms for _, ms in launches):.4f} ms of device time")


def decode_forward_split_phase(model) -> None:
    """Logs each launch of one NHWC soft-argmax forward (kernel 11a: the
    tile partials, their merge) on the model's logits and of one
    conv-decode forward (13a: the same two) on its head features, at B =
    DIRECT_B, by device ms (torch.profiler)."""
    j, d = model.num_joints, model.depth
    with torch.inference_mode():
        feats = model.features(direct_frames(DIRECT_B, SEED + 46))
        logits = model.final_layer(feats).permute(0, 2, 3, 1)
        nhwc = feats.permute(0, 2, 3, 1)
        weight = model.final_layer.weight.view(j * d, -1)
        bias = model.final_layer.bias.float()
        both = device_launches(  # one profiler window for both: two launches each
            lambda: (SA.soft_argmax_3d_nhwc_expectations(logits, j, d),
                     CD.conv_soft_argmax_3d_expectations(nhwc, weight, bias, j, d)), 4)
    for what, launches in (("soft_argmax_nhwc", both[:2]), ("conv_decode", both[2:])):
        for i, (name, ms) in enumerate(launches):
            log(f"launch split {what} {i + 1} {name.split('(')[0][:60]}: {ms:.4f} ms")
        log(f"launch split {what}: {len(launches)} launches, "
            f"{sum(ms for _, ms in launches):.4f} ms of device time")


# route: (PoseNet3D's flags, the kernel wrappers a step launches: forward, backward)
DIRECT_TRAIN_ROUTES = {
    "fused": ({"return_heatmap": False, "fuse_final_conv": True},
              (CD.conv_soft_argmax_3d_fused, CD.conv_soft_argmax_3d_backward)),
    "nhwc_kernels": ({"return_heatmap": False, "use_kernels_train": True},
                     (SA.soft_argmax_3d_nhwc_kernel, SA.soft_argmax_3d_nhwc_backward)),
    "nhwc_plain": ({"return_heatmap": False}, ()),
}
DECODE_WRAPPERS = (SA.soft_argmax_3d_nhwc_kernel, SA.soft_argmax_3d_nhwc_backward,
                   CD.conv_soft_argmax_3d_fused, CD.conv_soft_argmax_3d_backward)
TRAIN_KINDS = (
    ("decode", ("decode_kernel", "merge_kernel", "dfeats_kernel", "dweight_kernel",
                "fold_kernel", "nhwc_stream_kernel", "bwd_kernel")),
    ("convolutions", ("conv", "gemm", "xmma", "fprop", "dgrad", "wgrad", "nvjet", "cutlass",
                      "sm90")),
    ("batch norm", ("bn_", "batch_norm", "batchnorm")),
    ("Adam", ("adam", "multi_tensor")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce", "copy", "fill",
                     "relu", "max_pool", "clamp")),
)


def seeded_train_posenet(**flags):
    """The default PoseNet3D with f32 master weights on the card, from the
    seed, its final conv x FINAL_SCALE, in train mode."""
    model = PoseNet3D(device="cpu", **flags).init_weights(torch.Generator().manual_seed(SEED))
    model.final_layer.weight.data.mul_(FINAL_SCALE)
    return model.to("cuda").train()


def direct_train_batch(seed):
    """DIRECT_B uint8 frames of DIRECT_SIZE^2 and root-centred synthetic
    Human3.6M-like poses, on the card."""
    frames = (synthetic_frames(DIRECT_B, DIRECT_SIZE, seed=seed) * 256.0).astype(np.uint8)
    _, kp3d = synthetic_h36m(DIRECT_B, seed=seed)
    return (torch.from_numpy(frames).to("cuda"),
            torch.from_numpy(kp3d - kp3d[:, :1]).to("cuda"))


@contextlib.contextmanager
def plain_decodes():
    """Within it, the decode Functions run their kernels' plain versions on
    the card (the yardstick of the step): the same rounding points, the
    sums in other orders."""
    def soft_fwd(x, j, d, with_stats=False):
        return H.nhwc_expectations(x, j, d), None

    def soft_bwd(x, e, stats, g):
        j = e.shape[1]
        return SA.soft_argmax_3d_nhwc_backward_reference(x, e, g, j, x.shape[3] // j)

    def fused_fwd(f, w, b, j, d, with_stats=False):
        return CD.conv_soft_argmax_3d_expectations_reference(f, w, b, j, d), None

    def fused_bwd(f, w, b, e, stats, g):
        j = e.shape[1]
        return CD.conv_soft_argmax_3d_backward_reference(f, w, b, e, g, j, w.shape[0] // j)

    plain = ((SA, "soft_argmax_3d_nhwc_expectations", soft_fwd),
             (SA, "soft_argmax_3d_nhwc_backward", soft_bwd),
             (CD, "conv_soft_argmax_3d_expectations", fused_fwd),
             (CD, "conv_soft_argmax_3d_backward", fused_bwd))
    saved = [(m, name, getattr(m, name)) for m, name, _ in plain]
    for m, name, f in plain:
        setattr(m, name, f)
    try:
        yield
    finally:
        for m, name, f in saved:
            setattr(m, name, f)


def _direct_loss_and_grads(model, frames, kp3d, apply=bf16_apply):
    model.zero_grad(set_to_none=True)
    coords, _ = apply(model, frames.float() / 256.0)
    loss = ((coords.reshape(kp3d.shape) - kp3d) ** 2).mean()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def direct_step_check(route, model, frames, kp3d) -> None:
    """One bf16 step's loss and gradients on the kernels against the same
    step with the decode Functions on their kernels' plain versions, and
    both against the step in f32 on the plain versions (the yardstick).
    Train-mode BatchNorm amplifies where bf16 rounds: one flipped
    rounding in the decode's gradient moves the gradients of the layers
    below by ~1% (relative L2; ~10% for the stem BatchNorm's bias, whose
    gradient nearly cancels), so each parameter is held to the f32 step:
    its error at most F32_ERR_RATIO x the plain step's (floor
    STEP_GRAD_REL); the final conv's gradients (the decode backward's own
    output) and all gradients together within STEP_GRAD_REL of the plain
    step's, the loss within 1e-2."""
    loss_k, g_k = _direct_loss_and_grads(model, frames, kp3d)
    with plain_decodes():
        loss_p, g_p = _direct_loss_and_grads(model, frames, kp3d)
        _, g_32 = _direct_loss_and_grads(model, frames, kp3d, lambda m, x: m(x))
    rel = {n: _rel(g_k[n], g_p[n]) for n in g_k}
    worst = max(rel, key=rel.get)
    total = _rel(torch.cat([g.flatten() for g in g_k.values()]),
                 torch.cat([g.flatten() for g in g_p.values()]))
    ratio = {n: _rel(g_k[n], g_32[n]) / max(_rel(g_p[n], g_32[n]), STEP_GRAD_REL) for n in g_k}
    worst32 = max(ratio, key=ratio.get)
    final = max(rel["final_layer.weight"], rel["final_layer.bias"])
    log(f"direct train step {route} B={DIRECT_B}: loss kernels {loss_k:.8g}, plain {loss_p:.8g}; "
        f"grads kernels vs plain: all together {total:.4g}, final conv {final:.4g}, median "
        f"{statistics.median(rel.values()):.4g}, worst {rel[worst]:.4g} ({worst}); vs the f32 "
        f"step: worst kernels {_rel(g_k[worst32], g_32[worst32]):.4g}, plain "
        f"{_rel(g_p[worst32], g_32[worst32]):.4g} ({worst32})")
    if (not math.isfinite(loss_k) or abs(loss_k - loss_p) > 1e-2 * abs(loss_p)
            or total > STEP_GRAD_REL or final > STEP_GRAD_REL
            or ratio[worst32] > F32_ERR_RATIO):
        raise AssertionError(f"the {route} train step disagrees with its plain version")


def direct_train_phase() -> tuple[dict, dict]:
    """The direct train step on each route (DIRECT_TRAIN_ROUTES), B =
    DIRECT_B, bf16 compute over f32 master weights, Adam: the step's loss
    and gradients against the same step on the plain versions
    (``direct_step_check``), then TRAIN_STEPS steps on one fixed batch
    with the decode wrappers' counts set to 0 before them (one forward and
    one backward launch of the route's kernels a step), and times.
    Returns (the route's wrappers' launches, forward and backward, times)."""
    frames, kp3d = direct_train_batch(SEED + 50)
    launches, t = {}, {}
    for route, (flags, wrappers) in DIRECT_TRAIN_ROUTES.items():
        model = seeded_train_posenet(**flags)
        if wrappers:
            direct_step_check(route, model, frames, kp3d)
        state = create_train_state(model, lr=DIRECT_LR, optimizer="adam",
                                   weight_decay=DIRECT_WD, apply=bf16_apply)
        step = make_direct_train_step("mse")
        for f in DECODE_WRAPPERS:
            f.launches = 0
        losses = [step(state, frames, kp3d)["loss"].item() for _ in range(TRAIN_STEPS)]
        made = {f.__name__: f.launches for f in DECODE_WRAPPERS}
        want = {f.__name__: TRAIN_STEPS * (f in wrappers) for f in DECODE_WRAPPERS}
        log(f"direct train {route}: {TRAIN_STEPS} Adam steps, loss "
            + ", ".join(f"{v:.5g}" for v in losses) + f"; launches {made} (expected {want})")
        if made != want:
            raise AssertionError(f"the {route} train steps did not take their kernels")
        if not all(math.isfinite(v) for v in losses) or not (
                statistics.mean(losses[-3:]) < losses[0]):
            raise AssertionError(f"the {route} training loss did not fall")
        launches.update({f.__name__: made[f.__name__] for f in wrappers})
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise AssertionError("Adam stepped parameters that are not f32")

        t[route] = cuda_ms(lambda: step(state, frames, kp3d), n=10)
        log(f"time direct train B={DIRECT_B} step {route}: {t[route]:.4f} ms = "
            f"{DIRECT_B / t[route] * 1e3:.1f} frames/s")
        split = device_ms_by_kernel(lambda: step(state, frames, kp3d), n=5)
        busy = sum(split.values())
        log(f"device time direct train B={DIRECT_B} step {route}: {busy:.4f} ms per step, "
            f"{busy / t[route]:.1%} of its event-timed {t[route]:.4f} ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in by_kind(split, TRAIN_KINDS).items())
            + "; by kernel: " + top_kernels(split, 16))
        del model, state
        torch.cuda.empty_cache()
    return launches, t


def direct_cli_phase() -> None:
    """``cli.train_direct.train`` for one epoch on the fused route (the
    default ResNet-50 at B = DIRECT_B, CLI_FRAMES synthetic frames, 2 steps
    a chunk; its checkpoint under the checkout's gitignored ``logs/``),
    then ``infer`` on that checkpoint."""
    log_dir = Path(__file__).resolve().parent / "logs" / "chip_smoke_direct"
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg = DirectConfig(fuse_final_conv=True, n_epochs=1, chunk_steps=2, log_dir=str(log_dir),
                       run_name="chip_smoke", data=DataConfig(synthetic_frames=CLI_FRAMES))
    for f in DECODE_WRAPPERS:
        f.launches = 0
    t0 = time.perf_counter()
    state = train_direct.train(cfg)
    steps = CLI_FRAMES // DIRECT_B
    val_batches = len(train_direct.load_image_split(cfg, is_train=False)[0]) // DIRECT_B
    made = {f.__name__: f.launches for f in DECODE_WRAPPERS}
    log(f"cli train_direct: {state.step} steps in {time.perf_counter() - t0:.1f} s; "
        f"launches {made}")
    # each step's forward and backward, and each validation batch's forward
    if (state.step != steps or made["conv_soft_argmax_3d_backward"] != steps
            or made["conv_soft_argmax_3d_fused"] != steps + val_batches):
        raise AssertionError("the CLI's steps did not take the conv-decode kernels")
    del state
    mpjpe = train_direct.infer(cfg)
    if not math.isfinite(mpjpe):
        raise AssertionError("infer gave no MPJPE")
    shutil.rmtree(log_dir)


JOINT_MAJOR_WRAPPERS = (S.temporal_block_fused, ST.sequences_fwd, ST.sequences_bwd,
                        SA.soft_argmax_3d_pallas)
LAYOUT_GRAD_REL = 2 ** -10  # joint-major vs slab weight gradients: f32 summation order


def joint_major_tokens(model, n_clips, seed):
    """The embedded tokens of seeded clips: (frame-major rows, (C·17, T,
    256) joint-major sequences)."""
    tokens = S.embed_clips(model, seeded_clips(n_clips, model, seed))
    return tokens, S.joint_major(tokens, n_clips)


def legacy_logits(model, seed):
    """The x8 PoseNet3D's head output at B = DIRECT_B as the legacy decode
    takes it: (B, J, D, H, W), contiguous."""
    b, j, d = DIRECT_B, model.num_joints, model.depth
    with torch.no_grad():
        head = model.final_layer(model.features(direct_frames(b, seed)))  # (B, J*D, H, W)
        return head.reshape(b, j, d, *head.shape[2:]).contiguous()


def joint_major_main_path(tmodel, train_model, dmodel) -> dict:
    """The four kernels' entry points once each, with every count set to 0
    just before and read just after: ``temporal_block_fused``,
    ``temporal_block_train`` forward and backward (the gradient must reach
    the f32 model's temporal weights through the differentiable pack), and
    ``soft_argmax_3d_pallas`` forward and backward. Returns the counts."""
    blk = train_model.blocks[0]
    with torch.no_grad():  # tmodel's weights are inference tensors
        _, seqs = joint_major_tokens(tmodel, CLIPS, SEED + 60)
        w = S.pack_temporal_weights(tmodel.blocks[0])
        x = S.joint_major(ST.embed_clips(train_model, seeded_clips(CLIPS, train_model, SEED + 61),
                                         torch.bfloat16), CLIPS)
    x.requires_grad_(True)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(SEED + 62)).to(
        "cuda", torch.bfloat16) * 2 ** -6
    logits = legacy_logits(dmodel, SEED + 63).requires_grad_(True)
    b, j, d, h, wd = logits.shape
    for f in JOINT_MAJOR_WRAPPERS:
        f.launches = 0
    with torch.inference_mode():
        served = S.temporal_block_fused(seqs, w)
    out = ST.temporal_block_train(x, ST.pack_train(blk, "temporal", torch.bfloat16).flat)
    if out.grad_fn is None:
        raise AssertionError("temporal_block_train's output has no grad_fn on the card")
    out.backward(g)
    coords = SA.soft_argmax_3d_pallas(logits, j, d, h, wd)
    coords.square().sum().backward()
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in JOINT_MAJOR_WRAPPERS}
    log(f"joint-major and legacy main path: launches {launches} (expected 1 each)")
    if any(n != 1 for n in launches.values()):
        raise AssertionError("the joint-major and legacy entry points did not take their kernels")
    grads = [p.grad for n, p in blk.named_parameters() if n.startswith("temporal")]
    if (len(grads) != 12 or any(gr is None or not torch.isfinite(gr).all() for gr in grads)
            or not all(gr.abs().max() > 0 for gr in grads) or x.grad is None):
        raise AssertionError("temporal_block_train's backward did not reach the weights")
    for t in (served, out, coords, logits.grad):
        if not torch.isfinite(t).all():
            raise AssertionError("a joint-major or legacy output is not finite")
    if coords.std() < MIN_SPREAD:
        raise AssertionError(f"legacy decode: the coordinates do not spread ({coords.std():.4g})")
    blk.zero_grad(set_to_none=True)
    return launches


def joint_major_phase(model) -> dict:
    """Rows 7 and 10 against their plain versions and against the slab
    kernels on the same tokens, at 272 sequences of 243 frames. Returns
    the max abs errors."""
    errs = {}
    w = S.pack_temporal_weights(model.blocks[0])
    w32 = S.SubBlockWeights(w.flat.float())
    tokens, seqs = joint_major_tokens(model, CLIPS, SEED + 64)
    slab = tokens.view(CLIPS, model.clip_len, -1)
    got = S.temporal_block_fused(seqs, w)
    errs["temporal_block_fused"] = _rows_check(
        f"temporal_block_fused {tuple(seqs.shape)}", got, S.temporal_block_reference(seqs, w),
        S.temporal_block_reference(seqs.float(), w32))
    relaid = S.joint_major(S.temporal_slab(slab, w).view(-1, 256), CLIPS)
    pert = seqs.clone()
    pert[0] += 1.0
    moved = S.temporal_block_fused(pert, w)
    torch.cuda.synchronize()
    if not torch.equal(got, relaid):
        raise AssertionError("temporal_block_fused differs from the slab kernel on the same tokens")
    if not torch.equal(got[1:], moved[1:]) or torch.equal(got[0], moved[0]):
        raise AssertionError("sequence isolation: perturbing sequence 0 moved other sequences")
    log("temporal_block_fused: bitwise equal to temporal_slab on the same tokens; "
        "sequence isolation ok")

    dout = (torch.randn(tokens.shape, generator=torch.Generator().manual_seed(SEED + 65))
            * 2 ** -6).to("cuda", torch.bfloat16)
    g_seq = S.joint_major(dout, CLIPS)
    fwd = ST.sequences_fwd(seqs, w)
    want = ST.sequences_fwd_reference(seqs, w)
    ref32 = ST.sequences_fwd_reference(seqs.float(), w32)
    errs["sequences_fwd"] = max(_rows_check(f"sequences_fwd {name}", a, b, c)
                                for name, a, b, c in zip(("out", "x1", "att"), fwd, want, ref32))
    dx, dw = ST.sequences_bwd(seqs, *want[1:], g_seq, w)
    dx_p, dw_p = ST.sequences_bwd_reference(seqs, *want[1:], g_seq, w)
    dx32, dw32 = ST.sequences_bwd_reference(seqs.float(), *(t.float() for t in want[1:]),
                                            g_seq.float(), w32)
    e_bwd = _grad_check("sequences_bwd dx", dx, dx_p, dx32)
    pos = 0
    for name, shp, _, _ in S._LAYOUT:
        n = math.prod(shp)
        e_bwd = max(e_bwd, _grad_check(f"sequences_bwd d{name}", dw[pos:pos + n],
                                       dw_p[pos:pos + n], dw32[pos:pos + n]))
        pos += n
    errs["sequences_bwd"] = e_bwd
    dx2, dw2 = ST.sequences_bwd(seqs, *want[1:], g_seq, w)
    # against the slab route on the same tokens, each route on its own residuals
    slab_fwd = ST.slab_fwd(slab, w)
    sdx, sdw = ST.slab_bwd(slab, *slab_fwd[1:], dout.view(slab.shape), w)
    qdx, qdw = ST.sequences_bwd(seqs, *fwd[1:], g_seq, w)
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError("sequences_bwd: two calls gave different gradients")
    for name, a, b in zip(("out", "x1", "att", "dx"), (*slab_fwd, sdx), (*fwd, qdx)):
        if not torch.equal(S.joint_major(a.reshape(-1, 256), CLIPS), b):
            raise AssertionError(f"the joint-major training route's {name} differs from the "
                                 "slab route's")
    rels, pos = {}, 0
    for name, shp, _, _ in S._LAYOUT:
        n = math.prod(shp)
        a, b = qdw[pos:pos + n], sdw[pos:pos + n]
        rels[name] = ((a - b).norm() / b.norm()).item()
        pos += n
    worst = max(rels, key=rels.get)
    log(f"sequences_fwd / sequences_bwd vs the slab route: out, x1, att, dx bitwise; weight "
        f"gradients relative L2 worst {rels[worst]:.4g} ({worst}), median "
        f"{statistics.median(rels.values()):.4g} (limit {LAYOUT_GRAD_REL:.4g}); two backward "
        "calls bitwise equal")
    if rels[worst] > LAYOUT_GRAD_REL:
        raise AssertionError("the joint-major weight gradients differ from the slab route's")
    return errs


def legacy_softargmax_phase(model) -> dict:
    """Row 12 against its plain version at B = DIRECT_B on the model's own
    (B, J, D, H, W) logits and on planted peaks at logits ~100 with J = 3 in
    f32; against kernel 11a on the same logits in NHWC; the backward (the
    XLA formula on the card) against a float64 run of it. Returns the max
    abs error on the model's logits, and the backward's time."""
    logits = legacy_logits(model, SEED + 66)
    b, j, d, h, w = logits.shape

    def legacy(x, jj):
        return (lambda t: SA.soft_argmax_3d_pallas(t, jj, d, h, w),
                lambda t: H.soft_argmax_3d(t, jj, d, h, w, return_heatmap=False)[0],
                lambda t: H.soft_argmax_3d(t.double(), jj, d, h, w, return_heatmap=False)[0],
                (x,))

    err = _decode_check(f"soft_argmax_3d_pallas B={b} model logits", *legacy(logits, j))
    planted, where = planted_logits(b, h, w, 3, d)
    vol = planted.float().view(b, h, w, 3, d).permute(0, 3, 4, 1, 2).contiguous()
    _decode_check(f"soft_argmax_3d_pallas B={b} J=3 f32 planted peaks, logits ~100",
                  *legacy(vol, 3))
    peaks = torch.stack([where[..., 0] / w, where[..., 1] / h, where[..., 2] / d], -1)
    peaks = (peaks - 0.5) * torch.tensor([2.0, 2.0, model.z_scale])
    miss = (SA.soft_argmax_3d_pallas(vol, 3, d, h, w).cpu().view(b, 3, 3) - peaks).abs().max()
    nhwc = logits.permute(0, 3, 4, 1, 2).reshape(b, h, w, j * d).contiguous()
    vs_11a = (SA.soft_argmax_3d_pallas(logits, j, d, h, w)
              - SA.soft_argmax_3d_nhwc_kernel(nhwc, j, d)).abs().max().item()
    log(f"soft_argmax_3d_pallas planted peaks: max distance to the peaks {miss.item():.6g}; "
        f"vs the NHWC kernel on the same logits: max abs difference {vs_11a:.6g}")
    if miss > 5e-3 or vs_11a > DECODE_ATOL:
        raise AssertionError("the legacy soft-argmax kernel missed the peaks or the NHWC kernel")

    # the backward: dcoords/dE is diagonal, so g becomes dE by the scales
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(SEED + 67)).to("cuda")
    de = (g * torch.tensor([2.0 / w, 2.0 / h, model.z_scale / d], device="cuda")).view(-1, 3)
    flat = logits.view(b * j, d, h, w)

    def kernel_route():
        x = logits.detach().requires_grad_(True)
        SA.soft_argmax_3d_pallas(x, j, d, h, w).backward(g.view(b, -1))
        return x.grad.view(b * j, d, h, w)

    got, again = kernel_route(), kernel_route()
    want = SA.soft_argmax_3d_backward_reference(
        flat, SA.soft_argmax_3d_expectations_reference(flat), de)
    f64 = flat.double()
    ref = SA.soft_argmax_3d_backward_reference(
        f64, SA.soft_argmax_3d_expectations_reference(f64), de.double())
    torch.cuda.synchronize()
    _grad_check_f64(f"soft_argmax_3d_pallas backward B={b} model logits dx", got, again, want, ref)
    e = SA.soft_argmax_3d_volume_expectations(flat)
    return {"soft_argmax_volume": err}, {"soft_argmax_volume_bwd": cuda_ms(
        lambda: SA.soft_argmax_3d_backward_reference(flat, e, de))}


def joint_major_timing_phase(model, dmodel) -> dict:
    """The four kernels and their plain versions at the main path's shapes."""
    w = S.pack_temporal_weights(model.blocks[0])
    _, seqs = joint_major_tokens(model, CLIPS, SEED + 68)
    dout = (torch.randn(seqs.shape, generator=torch.Generator().manual_seed(SEED + 69))
            * 2 ** -6).to("cuda", torch.bfloat16)
    _, x1, att = ST.sequences_fwd(seqs, w)
    logits = legacy_logits(dmodel, SEED + 70)
    b, j, d, h, wd = logits.shape
    t = {
        "temporal_block_fused": cuda_ms(lambda: S.temporal_block_fused(seqs, w)),
        "temporal_block_fused_plain": cuda_ms(lambda: S.temporal_block_reference(seqs, w)),
        "sequences_fwd": cuda_ms(lambda: ST.sequences_fwd(seqs, w)),
        "sequences_fwd_plain": cuda_ms(lambda: ST.sequences_fwd_reference(seqs, w)),
        "sequences_bwd": cuda_ms(lambda: ST.sequences_bwd(seqs, x1, att, dout, w)),
        "sequences_bwd_plain": cuda_ms(
            lambda: ST.sequences_bwd_reference(seqs, x1, att, dout, w)),
        "soft_argmax_volume": cuda_ms(lambda: SA.soft_argmax_3d_pallas(logits, j, d, h, wd)),
        "soft_argmax_volume_plain": cuda_ms(
            lambda: H.soft_argmax_3d(logits, j, d, h, wd, return_heatmap=False)),
    }
    for k, ms in t.items():
        log(f"time joint-major {tuple(seqs.shape)} / legacy {tuple(logits.shape)} {k}: "
            f"{ms:.4f} ms")
    return t


def write_fake_h36m(root: Path, seed: int) -> dict:
    """A fabricated Human3.6M export in the VideoPose3D schema under
    ``root/npz`` (the mono and the 4-camera 3D files and the 2D file of
    every camera, 32 joints, float32), 64-160 seeded frames for each
    subject and action; returns the frame count of each (subject, action)."""
    rng = np.random.default_rng(seed)
    (root / "npz").mkdir(parents=True)
    pos3d, mono, pos2d, frames = {}, {}, {}, {}
    for s in H36M_SUBJECTS:
        pos3d[s], mono[s], pos2d[s] = {}, {}, {}
        for a in H36M_ACTIONS:
            n = frames[s, a] = int(rng.integers(64, 161))
            pos3d[s][a] = rng.standard_normal((n, 32, 3)).astype(np.float32)
            mono[s][a] = rng.standard_normal((n, 32, 3)).astype(np.float32)
            pos2d[s][a] = rng.random((n, 32, 2)).astype(np.float32)
            for c in H36M_CAMS:
                pos2d[s][a + c] = rng.random((n, 32, 2)).astype(np.float32)
    np.savez(root / "npz" / "data_3d_h36m.npz", positions_3d=pos3d)
    np.savez(root / "npz" / "data_3d_h36m_mono.npz", positions_3d_mono=mono)
    np.savez(root / "npz" / "data_2d_h36m.npz", positions_2d=pos2d)
    return frames


def _epochs(log_dir: Path, run_name: str) -> list[dict]:
    """The epoch records of a run's JSONL log."""
    lines = (log_dir / "runs" / f"{run_name}.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "epoch" in r]


def _check_run(name: str, records: list[dict], n_epochs: int, terms=()) -> None:
    """n_epochs epoch records of a CLI run, each metric and each of
    ``terms`` finite; logs them."""
    if len(records) != n_epochs:
        raise AssertionError(f"{name}: {len(records)} epoch records, expected {n_epochs}")
    for r in records:
        for k in ("train_loss", "train_mpjpe", "val_loss", "val_mpjpe", *terms):
            if k not in r or not math.isfinite(r[k]):
                raise AssertionError(f"{name}: epoch {r['epoch']} {k} = {r.get(k)}")
    log(f"cli {name}: " + "; ".join(
        f"epoch {r['epoch']} loss {r['train_loss']:.5f} val MPJPE {r['val_mpjpe']:.2f} mm"
        + "".join(f", {k} {r[k]:.4g}" for k in terms) for r in records))


def lift_epoch_timing(state, cfg: LiftConfig) -> None:
    """One more training epoch of the trained ViT (LIFT_FRAMES synthetic
    frames, B = 64), CUDA-event timed: seconds an epoch and frames/s; its
    device time and kernel launches by torch.profiler (a second epoch), so
    the busy share (device time over event time) and launches a step."""
    from torch.profiler import ProfilerActivity, profile

    ds = train_lift.load_split(cfg, is_train=True)
    y1, y2 = (torch.from_numpy(a).cuda() for a in stack_batches(
        (ds.kp2d, ds.kp3d), LIFT_B, np.random.default_rng(SEED)))
    epoch_fn = make_lifter_epoch_fn(cfg.loss)
    epoch_fn(state, y1, y2, 1)  # warm-up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    epoch_fn(state, y1, y2, 2)
    b.record()
    b.synchronize()
    host_s, ms = time.perf_counter() - t0, a.elapsed_time(b)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch_fn(state, y1, y2, 3)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    steps = y1.shape[0]
    log(f"time lift train epoch vit B={LIFT_B} ({steps} steps, {steps * LIFT_B} frames): "
        f"{ms / 1e3:.4f} s by CUDA events ({host_s:.4f} s host), "
        f"{steps * LIFT_B / ms * 1e3:.1f} frames/s, {ms / steps:.4f} ms a step; device "
        f"{device_ms:.2f} ms an epoch (profiled), busy {device_ms / ms:.1%}; "
        f"{launches / steps:.1f} kernel launches a step; by kernel: "
        + top_kernels({e.key: e.self_device_time_total / 1e3 for e in kernels}, 6))
    # where the host's time goes: self CPU time of each op and runtime
    # call, a step (under the profiler, which adds its own cost to each)
    host = {e.key: (e.self_cpu_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0}
    log(f"host time lift train step (profiled): {sum(v[0] for v in host.values()):.4f} ms a "
        f"step in {sum(v[1] for v in host.values()):.0f} calls; by call (ms a step, calls "
        "a step): " + ", ".join(f"{k} {t:.4f} ({c:.0f})" for k, (t, c) in
                                sorted(host.items(), key=lambda kv: -kv[1][0])[:14]))


def _predict_check(name: str, got: np.ndarray, model, kp: np.ndarray) -> None:
    """cli.predict's output against the restored module's forward in one
    batch on the card and on the CPU."""
    x = torch.from_numpy(kp)
    with torch.inference_mode():
        card = model(x.cuda()).float().cpu().numpy().reshape(-1, 17, 3)
        cpu = model.cpu()(x).float().numpy().reshape(-1, 17, 3)
    model.cuda()
    errs = (np.abs(got - card).max(), np.abs(got - cpu).max())
    log(f"cli predict {name}: {got.shape}, vs the module on the card in one batch "
        f"{errs[0]:.3e}, vs the CPU {errs[1]:.3e} (limit {PREDICT_ATOL})")
    if got.shape != (len(kp), 17, 3) or got.dtype != np.float32 or max(errs) > PREDICT_ATOL:
        raise AssertionError(f"cli predict {name} disagrees with its module")


def lift_cli_phase() -> None:
    """The phase-1 trainer, the Human3.6M reader and the predict CLI at full
    width, on the card, in a temporary directory; no kernel of ``csrc/``
    is on this path (the f32 modules, as the JAX package runs them)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lift_") as tmp:
        tmp = Path(tmp)
        frames = write_fake_h36m(tmp / "h36m", SEED + 20)
        log_dir = tmp / "logs"

        # the ViT at full width: 3 epochs of LIFT_FRAMES, flip TTA
        cfg = LiftConfig(model="vit", n_epochs=LIFT_EPOCHS, flip=True, log_dir=str(log_dir),
                         run_name="vit", data=DataConfig(action="Posing",
                                                         synthetic_frames=LIFT_FRAMES))
        t0 = time.perf_counter()
        state = train_lift.train(cfg)
        torch.cuda.synchronize()
        records = _epochs(log_dir, "vit")
        _check_run("train_lift vit", records, LIFT_EPOCHS)
        log(f"cli train_lift vit: {LIFT_EPOCHS} epochs in {time.perf_counter() - t0:.2f} s "
            f"host to host, epoch ends at " + ", ".join(f"{r['_runtime']:.2f}" for r in records)
            + " s (logger clock, 0.01 s steps)")
        if not records[-1]["val_mpjpe"] < records[0]["val_mpjpe"]:
            raise AssertionError("the ViT's validation MPJPE did not fall over 3 epochs")
        lift_epoch_timing(state, cfg)
        del state

        # the Martinez lifter (hidden 1024, 2 stages, BatchNorm, dropout 0.5)
        # and the AE, 2 epochs each
        for name in ("martinez", "ae"):
            run = train_lift.train(dataclasses.replace(cfg, model=name, n_epochs=2,
                                                        flip=False, run_name=name))
            records = _epochs(log_dir, name)
            _check_run(f"train_lift {name}", records, 2)
            if not records[1]["train_loss"] < records[0]["train_loss"]:
                raise AssertionError(f"the {name} training loss did not fall")
            del run

        # the ViT for one epoch on the fabricated export
        real = dataclasses.replace(cfg, n_epochs=1, flip=False, run_name="vit_h36m",
                                   data=DataConfig(data_dir=str(tmp / "h36m"), action="Posing"))
        want = sum(n for (s, a), n in frames.items()
                   if s in real.data.train_subjects and "Posing" in a)
        got = len(train_lift.load_split(real, is_train=True))
        state = train_lift.train(real)
        stats_files = sorted(p.name for p in (log_dir / "run_time_utils").iterdir())
        log(f"cli train_lift on the fabricated export: {got} training frames (the tree's "
            f"arrays: {want}), {state.step} steps; {stats_files}")
        if got != want or state.step != want // LIFT_B or len(stats_files) != 6:
            raise AssertionError("train_lift did not read the fabricated export")
        _check_run("train_lift vit_h36m", _epochs(log_dir, "vit_h36m"), 1)

        # cli.predict on each checkpoint, 10,000 frames
        kp = np.random.default_rng(SEED + 21).random((PREDICT_FRAMES, 17, 2)).astype(np.float32)
        np.save(tmp / "kp.npy", kp)
        for name in ("vit", "martinez", "ae"):
            out = tmp / f"{name}.npy"
            argv = ["--model", name, "--checkpoint", name, "--log_dir", str(log_dir),
                    "--input", str(tmp / "kp.npy"), "--output", str(out)]
            predict.main(argv)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict.main(argv)
            log(f"time cli predict {name} {PREDICT_FRAMES} frames: "
                f"{time.perf_counter() - t0:.4f} s host to host (process start excluded)")
            model = ckpt.restore_params(log_dir, name, train_lift.build_lifter(name))
            _predict_check(name, np.load(out), model.cuda().eval(), kp)

        # the temporal route: the seeded f32 TemporalLifter's checkpoint
        tmodel = seeded_temporal("cuda", torch.float32)
        ckpt.save(create_train_state(tmodel, lr=1e-3), log_dir, "temporal",
                  extra={"heads": tmodel.heads, "hidden": tmodel.hidden,
                         "n_blocks": tmodel.n_blocks, "clip_len": tmodel.clip_len})
        px = (np.random.default_rng(SEED + 22).random((VIDEO_FRAMES, 17, 3))
              * [1000.0, 1000.0, 1.0])
        (tmp / "video.json").write_text(json.dumps([
            {"image_id": f"{i:04d}.jpg", "category_id": 1, "keypoints": px[i].tolist(),
             "score": 0.9} for i in range(VIDEO_FRAMES)]))
        argv = ["--model", "temporal", "--checkpoint", "temporal", "--log_dir", str(log_dir),
                "--input", str(tmp / "video.json"), "--output", str(tmp / "t.npy")]
        t0 = time.perf_counter()
        got = predict.main(argv)
        log(f"time cli predict temporal {VIDEO_FRAMES}-frame video JSON: "
            f"{time.perf_counter() - t0:.4f} s host to host")
        kp2d = (px[..., :2].astype(np.float32) / 1000.0) * 1000.0
        want = lift_sequence(tmodel, kp2d, image_size=1000.0)
        cpu = lift_sequence(seeded_temporal("cpu", torch.float32), kp2d, image_size=1000.0)
        err = np.abs(got - cpu).max()
        log(f"cli predict temporal: bitwise equal to lift_sequence on the card: "
            f"{np.array_equal(got, want)}; vs the CPU {err:.3e} (limit {PREDICT_ATOL})")
        if not np.array_equal(got, want) or err > PREDICT_ATOL:
            raise AssertionError("cli predict temporal disagrees with lift_sequence")

        # the temporal trainer for one epoch on the fabricated export
        tcfg = TemporalConfig(n_epochs=1, log_dir=str(log_dir), run_name="temporal_h36m",
                              data=DataConfig(data_dir=str(tmp / "h36m")))
        t0 = time.perf_counter()
        tstate = train_temporal.train(tcfg)
        records = _epochs(log_dir, "temporal_h36m")
        log(f"cli train_temporal on the fabricated export: {tstate.step} steps in "
            f"{time.perf_counter() - t0:.2f} s; {records}")
        if tstate.step < 1 or not all(math.isfinite(records[0][k])
                                      for k in ("train_loss", "val_loss")):
            raise AssertionError("train_temporal did not train on the fabricated export")


def seeded_posenet2d(device, dtype):
    """The default PoseNet2D (ResNet-50) from the seed, its final conv x
    DETECT_SCALE."""
    model = PoseNet2D(device="cpu").init_weights(torch.Generator().manual_seed(SEED))
    model.final_layer.weight.data.mul_(DETECT_SCALE)
    return model.to(device=device, dtype=dtype).eval()


def host_phase() -> bool:
    """What the host has for the video path; returns whether cv2 imports.
    Neither answer ends the run."""
    try:
        import cv2
        log(f"host: cv2 {cv2.__version__} imports")
        have_cv2 = True
    except ImportError as e:
        log(f"host: cv2 does not import ({e})")
        have_cv2 = False
    t0 = time.perf_counter()
    try:
        native_build.ensure_built()
        note = ""
    except RuntimeError as e:  # no g++ or no libjpeg: the cv2 fallbacks stay
        errors = [line for line in str(e).splitlines() if "error" in line] or [str(e)]
        note = f" (build failed: {errors[0].strip()[:200]})"
    built = [name for name in native_build.LIBRARIES if (native_build.NATIVE_DIR / name).exists()]
    log(f"host: the port's native libraries built here: {built or 'none'} of "
        f"{list(native_build.LIBRARIES)} in {time.perf_counter() - t0:.2f} s{note}")
    return have_cv2


def _lift_check(what, got, kp_px, model_f32, model_cpu) -> None:
    e32 = np.abs(got - lift_sequence(model_f32, kp_px)).max()
    ep = np.abs(got - lift_sequence(model_cpu, kp_px, use_kernels=True)).max()
    log(f"video lift {what}: max abs err vs f32 module {e32:.6g} (atol {F32_ATOL}), vs the "
        f"plain versions {ep:.6g} (atol {KERNEL_ATOL})")
    if not np.isfinite(got).all() or e32 > F32_ATOL or ep > KERNEL_ATOL:
        raise AssertionError(f"video lift {what}: answer out of tolerance")


def video_phase() -> dict:
    """Phase 25, the video -> 3D path; returns the launches of the
    temporal kernels (rows 3-6) in its two lifts."""
    have_cv2 = host_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as tmp:
        tmp = Path(tmp)
        logs = tmp / "logs"
        kp2d, _ = synthetic_h36m(E2E_FRAMES, seed=SEED + 40)
        with torch.inference_mode():
            frames = render_pose_frames(torch.from_numpy(kp2d).cuda(),
                                        torch.Generator("cuda").manual_seed(SEED + 41))
            frames_dev = (frames * 255.0).round().to(torch.uint8)
        frames_u8 = frames_dev.cpu().numpy()
        log(f"video: {E2E_FRAMES} rendered frames {tuple(frames_u8.shape)} uint8, mean "
            f"{frames_u8.mean():.2f}")
        del frames

        # the models from the seed, saved as port checkpoints and built again
        # from them as pipeline.run builds them
        for name, dtype in (("det_f32", torch.float32), ("det_bf16", torch.bfloat16)):
            ckpt.save(create_train_state(seeded_posenet2d("cpu", dtype), lr=1e-3), logs, name,
                      extra={"architecture": "resnet50", "bf16": dtype == torch.bfloat16})
        ckpt.save(create_train_state(seeded_temporal("cpu", torch.bfloat16), lr=1e-3), logs,
                  "lift")
        det32 = video_run.build_detector(logs, "det_f32", "cuda")
        det16 = video_run.build_detector(logs, "det_bf16", "cuda")
        lifter = video_run.build_lifter(logs, "lift", "cuda")
        if det16.model.dtype != torch.bfloat16 or lifter.dtype != torch.bfloat16:
            raise AssertionError("the checkpoints did not give a bf16 detector and lifter")

        # detect: f32 vs the CPU on the first chunk, bf16 vs f32
        t0 = time.perf_counter()
        kp32 = det32.detect_frames(frames_u8)
        t_det32 = time.perf_counter() - t0
        t0 = time.perf_counter()
        kp16 = det16.detect_frames(frames_u8)
        t_det16 = time.perf_counter() - t0
        cpu = PoseNet2DDetector(seeded_posenet2d("cpu", torch.float32)).detect_frames(
            frames_u8[:DETECT_B])
        e_cpu = np.abs(kp32[:DETECT_B] - cpu).max()
        e16 = np.abs(kp16 - kp32).max()
        spread = kp32.std()
        log(f"video detect {E2E_FRAMES} frames, B={DETECT_B}: f32 vs the CPU (first "
            f"{DETECT_B} frames) max abs err {e_cpu:.6g} (atol {DETECT_CPU_ATOL}); bf16 vs f32 "
            f"{e16:.6g} (atol {DETECT_BF16_ATOL}; 99.9th percentile "
            f"{np.quantile(np.abs(kp16 - kp32), 0.999):.4g}); coordinate std {spread:.4g} "
            f"(>= {MIN_SPREAD}); "
            f"host to host incl. the copies: f32 {t_det32:.4f} s, bf16 {t_det16:.4f} s")
        if (kp32.shape != (E2E_FRAMES, 17, 2) or not np.isfinite(kp16).all()
                or e_cpu > DETECT_CPU_ATOL or e16 > DETECT_BF16_ATOL or spread < MIN_SPREAD):
            raise AssertionError("the detector is out of tolerance")

        # the detections' JSON, and the lifts that count the kernels' launches
        names = [f"{i + 1:04d}.jpg" for i in range(E2E_FRAMES)]
        write_predictions(names, kp16, tmp / "jsons")
        write_predictions(names[:E2E_CUT], kp16[:E2E_CUT], tmp / "jsons_cut")
        save_to_json(tmp / "jsons", tmp / "walk.json", already_h36m=True)
        save_to_json(tmp / "jsons_cut", tmp / "cut.json", already_h36m=True)
        model_f32 = seeded_temporal("cuda", torch.float32)
        model_cpu = seeded_temporal("cpu", torch.bfloat16)
        expected = {E2E_FRAMES: (5, 5, 0, 0), E2E_CUT: (0, 0, 5, 5)}
        launches = dict.fromkeys((f.__name__ for f in TEMPORAL_KERNELS), 0)
        for n, path in ((E2E_FRAMES, tmp / "walk.json"), (E2E_CUT, tmp / "cut.json")):
            for f in TEMPORAL_KERNELS:
                f.launches = 0
            poses = lift_video_json(lifter, path, tmp / f"{n}.npy")
            made = tuple(f.launches for f in TEMPORAL_KERNELS)
            for f, m in zip(TEMPORAL_KERNELS, made):
                launches[f.__name__] += m
            log(f"video lift {n} frames: launches spatial {made[0]}, temporal {made[1]}, "
                f"packed {made[2]}, seq {made[3]} (expected {expected[n]})")
            if made != expected[n] or poses.shape != (n, 17, 3):
                raise AssertionError(f"the {n}-frame video did not take its route's kernels")
            _lift_check(f"{n} frames", poses, load_video_json(path)[0], model_f32, model_cpu)

        if have_cv2:
            video_end_to_end(tmp, logs, frames_u8, lifter)
        else:
            log("video: cv2 does not import on this host, so the decode, JPEG and mp4 stages "
                "(write_video, extract_frames, load_frames, pipeline.run.main) were not run; "
                "detect_frames -> prediction JSONs -> save_to_json -> lift_video_json ran")
        video_timing(det32, det16, lifter, frames_dev, frames_u8)
        del frames_dev
    torch.cuda.empty_cache()
    return launches


def video_end_to_end(tmp: Path, logs: Path, frames_u8: np.ndarray, lifter) -> None:
    """pipeline.run.main on an mp4 of the frames, with both checkpoints."""
    root = tmp / "videos"
    write_video(iter(frames_u8), root / "raw_videos" / "walk.mp4", fps=10)
    argv = ["--video", "walk.mp4", "--root", str(root), "--detector", "posenet2d",
            "--detector_checkpoint", "det_bf16", "--lifter_checkpoint", "lift",
            "--log_dir", str(logs), "--fps", "10"]
    t0 = time.perf_counter()
    video_run.main(argv)
    t_main = time.perf_counter() - t0
    t0 = time.perf_counter()  # the decode stages again, alone
    n = extract_frames(root / "raw_videos" / "walk.mp4", tmp / "frames_again", fps=10)
    t_extract = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = load_frames(root / "ffmpeg_frames" / "walk.mp4", size=256, dtype=np.uint8)
    t_load = time.perf_counter() - t0
    diff = np.abs(decoded.astype(np.int16) - frames_u8.astype(np.int16))
    final = root / "final_json_outputs" / "walk.mp4.json"
    poses = np.load(root / "MB_npy" / "walk.mp4.npy")
    again = lift_video_json(lifter, final, tmp / "again.npy")
    log(f"video end to end (pipeline.run.main, {len(decoded)} frames): {t_main:.4f} s host to "
        f"host; of it, alone: mp4 -> {n} JPEGs {t_extract:.4f} s, JPEGs -> uint8 frames "
        f"{t_load:.4f} s; the mp4's frames differ from the rendered ones by mean "
        f"{diff.mean():.3f}, max {diff.max()} (lossy mp4v); npy bitwise equal to "
        f"lift_video_json on its JSON: "
        f"{np.array_equal(poses, again)}")
    if len(decoded) != E2E_FRAMES or poses.shape != (E2E_FRAMES, 17, 3) or \
            not np.array_equal(poses, again):
        raise AssertionError("pipeline.run.main did not give the lift of its own JSON")


def video_timing(det32, det16, lifter, frames_dev, frames_u8) -> None:
    """Host to host per stage and for the whole path (the frames in host
    memory, decode excluded), before any profiler runs in this phase; the
    detector on frames already on the card and the lift (CUDA events,
    torch.profiler); the host's side of one bf16 ``detect_frames`` call."""
    from torch.profiler import ProfilerActivity, profile

    name = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    for tag, det in (("f32", det32), ("bf16", det16)):
        stages = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            px = det.detect_frames(frames_u8) * 1000.0
            t1 = time.perf_counter()
            lift_sequence(lifter, px)
            stages.append((t1 - t0, time.perf_counter() - t1))
        d, lft = (statistics.median(x) for x in zip(*stages))
        log(f"time video path {tag} detector, {E2E_FRAMES} frames host to host ({name}): "
            f"detect (copies + model) {d * 1e3:.2f} ms, lift {lft * 1e3:.2f} ms, whole "
            f"{(d + lft) * 1e3:.2f} ms = {E2E_FRAMES / (d + lft):.1f} frames/s (median of 3; "
            f"detect calls " + ", ".join(f"{a * 1e3:.1f}" for a, _ in stages) + " ms)")
    batch = frames_dev[:DETECT_B]
    with torch.inference_mode():
        for tag, det in (("f32", det32), ("bf16", det16)):
            fwd = lambda: det.model(batch.to(torch.float32) / 256.0)  # noqa: E731
            ms = cuda_ms(fwd)
            split = device_ms_by_kernel(fwd, n=5)
            busy = sum(split.values())
            log(f"time video detect {tag} B={DETECT_B} on frames on the card ({name}): "
                f"{ms:.4f} ms = {DETECT_B / ms * 1e3:.1f} frames/s; device {busy:.4f} ms, busy "
                f"{busy / ms:.1%}; top: " + top_kernels(split, 8))
    kp = (det16.detect_frames(frames_u8) * 1000.0).astype(np.float32)
    t_lift = cuda_ms(lambda: lift_sequence(lifter, kp), n=5)
    split = device_ms_by_kernel(lambda: lift_sequence(lifter, kp), n=3)
    log(f"time video lift {E2E_FRAMES} frames (lift_sequence, host to host, {name}): "
        f"{t_lift:.4f} ms = {E2E_FRAMES / t_lift * 1e3:.1f} frames/s; device "
        f"{sum(split.values()):.4f} ms; top: " + top_kernels(split, 6))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det16.detect_frames(frames_u8)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU), reverse=True)
    log(f"host side of one bf16 detect_frames call under torch.profiler: {wall:.1f} ms wall, "
        f"{device:.1f} ms of device time; top host ops by self time: "
        + ", ".join(f"{k} {ms:.1f} ms ({n})" for ms, n, k in host[:8]))


# phase 26: the detector, projector and consistency-loop trainers

LOOP_FRAMES = 512    # the loop runs' --data.synthetic_frames: 8 steps of B = 64 an epoch
LOOP_EPOCHS = 2
LOOP_STEPS = 10      # steps on one fixed batch whose loss must fall
PROJECT_EPOCHS = 2   # the projector's and the lifter's epochs of LIFT_FRAMES
LOOP_SEP_TERMS = ("loss_2d", "loss_3d", "loss_domain_gap", "loss_lift", "loss_gap_proj",
                  "loss_proj")
LOOP_CYCLE_TERMS = ("loss_2d", "loss_3d", "loss_lift", "loss_proj")
# the loop step on the card against the CPU: ResNet-18, 64^2, B = 4, every
# toggle on, f32 with TF32 off (PERF.md §2)
LOOP_CHECK_B, LOOP_CHECK_SIZE = 4, 64
# Limits by dtype (PERF.md §2): the loss and its terms (relative), the
# gradients (relative L2), the running statistics (absolute). In float64
# the card and the CPU compute the same function, each parameter's
# gradient to 1e-8 (measured 4.2e-14). In f32 (TF32 off) train-mode
# BatchNorm on 8 small frames makes the gradients ill-conditioned: the
# CPU's own f32 gradients lie 4.1e-4 (1 thread) to 4.2e-3 (8 threads)
# from its float64 ones, all together, and up to 5.8e-3 for one
# parameter, so a limit of 1e-3 a parameter would hold on neither device:
# f32 holds all gradients together to 2e-2 (measured 5.1e-3 card vs CPU),
# the loss to 1e-5 (measured 2.2e-7 to 4.5e-7) and the statistics to 1e-5
# (measured 7.2e-7 to 8.3e-7).
LOOP_CHECK_LIMITS = {torch.float64: (1e-10, 1e-8, 1e-10), torch.float32: (1e-5, 2e-2, 1e-5)}
# PoseNet2D's final conv bias: each joint's softmax is invariant to a shift
# of its map, so the bias's gradient is 0 in exact arithmetic and the two
# devices' rounding residues have no relative error to hold. Each is held
# to this fraction of the final conv weight gradient's norm instead.
LOOP_CHECK_ZERO_GRAD = {"net2d.final_layer.bias": "net2d.final_layer.weight"}
LOOP_CHECK_ZERO_REL = {torch.float64: 1e-12, torch.float32: 1e-5}
LOOP_KINDS = (
    ("convolutions", ("conv", "gemm", "xmma", "fprop", "dgrad", "wgrad", "nvjet", "cutlass",
                      "sm90")),
    ("batch norm", ("bn_", "batch_norm", "batchnorm")),
    ("Adam", ("adam", "multi_tensor")),
    ("softmax and reductions", ("softmax", "reduce")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill", "relu",
                     "max_pool", "clamp", "cat")),
)


def kernel_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches (the 18 records' rows)."""
    return tuple(dict.fromkeys((L.trunk, Mz.fused_residual_block, *TEMPORAL_KERNELS,
                                S.temporal_block_fused, *ST.WRAPPERS, *DECODE_WRAPPERS,
                                SA.soft_argmax_3d_pallas)))


def detector_train_phase(logs: Path, smi: str) -> float:
    """``cli.train_detector.main`` at DetectorConfig's defaults; the trained
    eval pixel error below a quarter of the fresh init's; the step's times.
    Returns the fresh init's eval pixel error."""
    cfg = DetectorConfig(log_dir=str(logs), run_name="det")
    eval_fn = make_detector_eval_step(cfg.image_size)
    kp_eval = train_detector.eval_poses(cfg, "cuda")
    fresh_px = eval_fn(train_detector.new_state(cfg), kp_eval, train_detector.EVAL_SEED).item()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, px = train_detector.main(["--log_dir", str(logs), "--run_name", "det"])
    secs = time.perf_counter() - t0
    log(f"cli train_detector ({cfg.architecture}, B={cfg.batch_size}, {cfg.image_size}^2, "
        f"bf16 {cfg.bf16}, {cfg.chunk_steps} steps a chunk): {state.step} steps in {secs:.2f} s "
        f"host to host (evals included); eval pixel error {px:.4f} px, fresh init "
        f"{fresh_px:.4f} px (must be below a quarter: {fresh_px / 4:.4f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if state.step != cfg.n_steps or not math.isfinite(px) or not px < fresh_px / 4:
        raise AssertionError("the detector did not train")

    # one chunk of K steps: CUDA events, then torch.profiler
    step_fn = make_detector_chunk_step(cfg.image_size)
    pool, _ = synthetic_h36m(cfg.chunk_steps * cfg.batch_size, seed=SEED + 62)
    kp = torch.from_numpy(pool.reshape(cfg.chunk_steps, cfg.batch_size, 17, 2)).cuda()
    gen = torch.Generator("cuda").manual_seed(SEED + 63)
    ms = cuda_ms(lambda: step_fn(state, kp, gen), n=2) / cfg.chunk_steps
    split, launches = device_profile(lambda: step_fn(state, kp, gen), n=2)
    busy = sum(split.values()) / cfg.chunk_steps
    log(f"time detector train step B={cfg.batch_size} ({smi}): {ms:.4f} ms a step (CUDA events "
        f"over chunks of {cfg.chunk_steps}) = {cfg.batch_size / ms * 1e3:.1f} frames/s; device "
        f"{busy:.4f} ms a step, busy {busy / ms:.1%}; {launches / cfg.chunk_steps:.1f} kernel "
        "launches a step; by kind (ms a step): " + ", ".join(
            f"{k} {v / cfg.chunk_steps:.4f}" for k, v in by_kind(split, LOOP_KINDS).items())
        + "; top: " + top_kernels({k: v / cfg.chunk_steps for k, v in split.items()}, 8))
    del state
    torch.cuda.empty_cache()
    return fresh_px


def trained_detector_video(logs: Path, fresh_px: float) -> None:
    """The trained checkpoint through ``pipeline.run.build_detector`` and
    ``detect_frames`` (bf16) on E2E_FRAMES frames rendered from held-out
    poses: its pixel error against the rendered keypoints."""
    size = DetectorConfig.image_size
    det = video_run.build_detector(logs, "det", "cuda")
    if det.model.dtype != torch.bfloat16:
        raise AssertionError("the bf16 detector checkpoint did not build a bf16 detector")
    kp2d, _ = synthetic_h36m(E2E_FRAMES, seed=SEED + 64)  # the trainer's pools: seeds 0, 1
    with torch.inference_mode():
        frames = render_pose_frames(torch.from_numpy(kp2d).cuda(),
                                    torch.Generator("cuda").manual_seed(SEED + 65), size=size)
        # uint8, as detect_frames takes them (it divides by 256)
        frames_u8 = (frames * 256.0).clamp(max=255.0).to(torch.uint8).cpu().numpy()
    det.detect_frames(frames_u8[:DETECT_B])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = det.detect_frames(frames_u8)
    secs = time.perf_counter() - t0
    err = np.linalg.norm(got - kp2d, axis=-1) * size
    log(f"video path, trained detector ({E2E_FRAMES} held-out rendered frames, bf16, "
        f"detect_frames host to host {secs * 1e3:.2f} ms = {E2E_FRAMES / secs:.1f} frames/s): "
        f"pixel error mean {err.mean():.4f} px, median {np.median(err):.4f}, 95th percentile "
        f"{np.quantile(err, 0.95):.4f} ({size} x {size} frames; fresh init {fresh_px:.4f} px)")
    if got.shape != (E2E_FRAMES, 17, 2) or not err.mean() < fresh_px / 4:
        raise AssertionError("the trained detector does not detect in the video path")


def frozen_models_phase(logs: Path) -> None:
    """``cli.train_project`` and ``cli.train_lift`` (the ViT) for
    PROJECT_EPOCHS epochs of LIFT_FRAMES synthetic frames: the loop's frozen
    checkpoints ``proj`` and ``lift``."""
    t0 = time.perf_counter()
    train_project.main(["--n_epochs", str(PROJECT_EPOCHS), "--log_dir", str(logs),
                        "--run_name", "proj"])
    records = _epochs(logs, "proj")
    _check_run("train_project", records, PROJECT_EPOCHS)
    log(f"cli train_project: {PROJECT_EPOCHS} epochs in {time.perf_counter() - t0:.2f} s; val "
        f"L2 {records[-1]['val_mpjpe']:.2f} millipixels")
    if not records[-1]["train_loss"] < records[0]["train_loss"]:
        raise AssertionError("the projector's training loss did not fall")
    train_lift.train(LiftConfig(n_epochs=PROJECT_EPOCHS, log_dir=str(logs), run_name="lift",
                                data=DataConfig(action="Posing", synthetic_frames=LIFT_FRAMES)))
    _check_run("train_lift lift", _epochs(logs, "lift"), PROJECT_EPOCHS)


def loop_cli_phase(logs: Path) -> None:
    """``cli.train_loop.main`` at LoopConfig's defaults with the triangle
    (sep), the flip and the projector for LOOP_EPOCHS epochs, then one
    epoch of ``cycle``; no kernel of the 18 records is launched."""
    base = ["--triangle", "1", "--flip", "1", "--project", "1", "--lifter_checkpoint", "lift",
            "--projector_checkpoint", "proj", "--data.synthetic_frames", str(LOOP_FRAMES),
            "--log_dir", str(logs)]
    wrappers = kernel_wrappers()
    for f in wrappers:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_loop.main(base + ["--n_epochs", str(LOOP_EPOCHS), "--run_name", "loop"])
    secs = time.perf_counter() - t0
    _check_run("train_loop sep", _epochs(logs, "loop"), LOOP_EPOCHS, LOOP_SEP_TERMS)
    log(f"cli train_loop sep (resnet50, B=64, 256^2, bf16, flip, projector, {LOOP_FRAMES} "
        f"frames): {LOOP_EPOCHS} epochs in {secs:.2f} s host to host (data and checkpoints "
        f"included); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for tag in ("2d", "3d"):
        if not ckpt.exists(logs, f"loop_{tag}"):
            raise AssertionError(f"train_loop wrote no loop_{tag} checkpoint")
    train_loop.main(base + ["--n_epochs", "1", "--triangle_mode", "cycle",
                            "--run_name", "loop_cycle"])
    cycle = _epochs(logs, "loop_cycle")
    _check_run("train_loop cycle", cycle, 1, LOOP_CYCLE_TERMS)
    if "loss_domain_gap" in cycle[0]:
        raise AssertionError("the cycle run logged the sep loss's terms")
    made = {f.__name__: f.launches for f in wrappers if f.launches}
    log(f"train_loop launches of the 18 kernel records' wrappers (counts from 0): {made or 0}")
    if made:
        raise AssertionError("the loop's path launched a kernel of the records")


def loop_step_phase(logs: Path, smi: str) -> None:
    """LOOP_STEPS loop steps on one fixed batch at LoopConfig's defaults
    (the trained frozen checkpoints, every toggle on): finite, the mean of
    the last three below the first; the step's time, device time, busy
    share, launches and peak memory; the device time of its parts, each
    alone on the step's shapes."""
    cfg = LoopConfig(triangle=True, flip=True, project=True, lifter_checkpoint="lift",
                     projector_checkpoint="proj", log_dir=str(logs),
                     data=DataConfig(action="Walking", split_rate=64, synthetic_frames=DIRECT_B))
    state = train_loop.build_state(cfg)
    f, y1, y2 = (torch.from_numpy(a[:cfg.batch_size]).cuda()
                 for a in train_loop.load_frames_split(cfg, True))
    step = make_loop_train_step(triangle=True, flip=True, project=True)
    torch.cuda.reset_peak_memory_stats()
    losses = [step(state, f, y1, y2)["loss"].item() for _ in range(LOOP_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"loop train B={cfg.batch_size}: {LOOP_STEPS} AdamW steps on one batch, loss "
        + ", ".join(f"{v:.5g}" for v in losses) + f"; peak device memory {peak:.2f} GiB")
    if not all(math.isfinite(v) for v in losses) or not (
            statistics.mean(losses[-3:]) < losses[0]):
        raise AssertionError("the loop's training loss did not fall")

    ms = cuda_ms(lambda: step(state, f, y1, y2), n=3)
    split, launches = device_profile(lambda: step(state, f, y1, y2), n=2)
    busy = sum(split.values())
    log(f"time loop train step B={cfg.batch_size} (2 x {cfg.batch_size} frames with the flip; "
        f"{smi}): {ms:.4f} ms = {cfg.batch_size / ms * 1e3:.1f} frames/s; device {busy:.4f} ms, "
        f"busy {busy / ms:.1%}; {launches:.0f} kernel launches a step; by kind: "
        + ", ".join(f"{k} {v:.4f}" for k, v in by_kind(split, LOOP_KINDS).items())
        + "; top: " + top_kernels(split, 10))

    # the parts alone, on the step's shapes (device ms of each)
    frames2 = torch.cat([f, f.flip(2)], 0)
    net2d, net3d = state.net2d.model, state.net3d.model
    logits = torch.randn(2 * cfg.batch_size, 17, 64, 64, 64, device="cuda",
                         dtype=torch.bfloat16, requires_grad=True)
    y1h = y1.clone().requires_grad_(True)
    y2h = y2.clone().requires_grad_(True)

    def vits():
        (state.lifter(y1h).sum() + state.projector(y2h).sum()).backward()
        with torch.no_grad():
            state.lifter(y1)
            state.projector(y2)

    parts = {
        "PoseNet2D forward + backward": lambda: bf16_apply(net2d, frames2).sum().backward(),
        "PoseNet3D forward + backward": lambda: bf16_apply(net3d, frames2)[0].sum().backward(),
        "heatmap decode forward + backward": lambda: H.soft_argmax_3d(
            logits, 17, 64, 64, 64)[0].sum().backward(),
        "frozen ViTs": vits,
        "AdamW, both models": lambda: (state.net2d.optimizer.step(),
                                       state.net3d.optimizer.step()),
    }
    net2d.train()
    net3d.train()
    times = {k: sum(device_profile(fn, n=2)[0].values()) for k, fn in parts.items()}
    log("device time loop step parts alone (ms; the decode's share of the step "
        f"{times['heatmap decode forward + backward'] / busy:.1%}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; sum {sum(times.values()) - times['heatmap decode forward + backward']:.4f} "
        f"(the decode is inside PoseNet3D's) against the step's {busy:.4f}")
    del state, logits, parts
    torch.cuda.empty_cache()


def _loop_check_state(device, dtype) -> LoopState:
    gen = lambda i: torch.Generator().manual_seed(SEED + 70 + i)  # noqa: E731
    model2d = PoseNet2D("resnet18", device="cpu").init_weights(gen(0))
    model3d = PoseNet3D("resnet18", return_heatmap=True, device="cpu").init_weights(gen(1))
    lifter = JointTransformerLifter(device="cpu").init_weights(gen(2))
    projector = JointTransformerLifter(in_dim=3, out_dim=2, device="cpu").init_weights(gen(3))
    kw = {"device": device, "dtype": dtype}
    return LoopState(net2d=create_train_state(model2d.to(**kw), lr=LoopConfig.lr),
                     net3d=create_train_state(model3d.to(**kw), lr=LoopConfig.lr),
                     lifter=freeze(lifter.to(**kw)), projector=freeze(projector.to(**kw)))


def loop_device_check() -> None:
    """One loop step (sep, flip, projector) from the same weights on the card
    and on the CPU, in float64 and in f32 with TF32 off: the loss and its
    terms, the trained models' gradients and running statistics, held to
    LOOP_CHECK_LIMITS."""
    rng = np.random.default_rng(SEED + 74)
    batch = (rng.random((LOOP_CHECK_B, LOOP_CHECK_SIZE, LOOP_CHECK_SIZE, 3)),
             rng.random((LOOP_CHECK_B, 17, 2)), 0.3 * rng.standard_normal((LOOP_CHECK_B, 17, 3)))
    step = make_loop_train_step(triangle=True, flip=True, project=True)
    for dtype, (loss_rtol, grad_rel, stats_atol) in LOOP_CHECK_LIMITS.items():
        states, metrics = {}, {}
        for dev in ("cpu", "cuda"):
            states[dev] = _loop_check_state(dev, dtype)
            metrics[dev] = step(states[dev], *(torch.from_numpy(a).to(dev, dtype) for a in batch))
        loss_err = max(abs(metrics["cuda"][k].item() / metrics["cpu"][k].item() - 1)
                       for k in metrics["cpu"] if k.startswith("loss"))
        grads, stats_err = {}, 0.0
        for tag in ("net2d", "net3d"):
            cpu_model, card_model = (getattr(states[d], tag).model for d in ("cpu", "cuda"))
            for (name, p), q in zip(cpu_model.named_parameters(), card_model.parameters()):
                grads[f"{tag}.{name}"] = (p.grad.double(), q.grad.cpu().double())
            for (name, b), c in zip(cpu_model.named_buffers(), card_model.buffers()):
                if "running" in name:
                    stats_err = max(stats_err, (c.cpu() - b).abs().max().item())
        rel = sorted((((q - p).norm() / p.norm()).item(), k) for k, (p, q) in grads.items()
                     if k not in LOOP_CHECK_ZERO_GRAD)
        kept = [g for k, g in grads.items() if k not in LOOP_CHECK_ZERO_GRAD]
        together = (torch.cat([(q - p).flatten() for p, q in kept]).norm()
                    / torch.cat([p.flatten() for p, _ in kept]).norm()).item()
        zero = {k: max(g.norm().item() for g in grads[k]) / grads[ref][0].norm().item()
                for k, ref in LOOP_CHECK_ZERO_GRAD.items()}
        per_param = dtype == torch.float64
        log(f"loop step on the card vs the CPU ({dtype}, TF32 off, resnet18, {LOOP_CHECK_SIZE}^2, "
            f"B={LOOP_CHECK_B}, sep + flip + projector): loss and terms max relative err "
            f"{loss_err:.3e} (rtol {loss_rtol}); gradients relative L2 (limit {grad_rel} "
            + ("each" if per_param else "all together") + f"): all together {together:.3e}, "
            "worst " + ", ".join(f"{v:.3e} ({k})" for v, k in rel[-3:][::-1])
            + f", median {statistics.median(v for v, _ in rel):.3e}"
            + "; zero in exact arithmetic, the larger norm over the weight gradient's: "
            + ", ".join(f"{k} {v:.3e} (limit {LOOP_CHECK_ZERO_REL[dtype]})"
                        for k, v in zero.items())
            + f"; running statistics max abs err {stats_err:.3e} (atol {stats_atol})")
        grad_err = rel[-1][0] if per_param else together
        if (loss_err > loss_rtol or grad_err > grad_rel or stats_err > stats_atol
                or any(v > LOOP_CHECK_ZERO_REL[dtype] for v in zero.values())):
            raise AssertionError(f"the loop step on the card disagrees with the CPU in {dtype}")


def loop_phase() -> None:
    """Phase 26: the detector, projector, lifter and loop trainers from their
    CLIs in a temporary directory, the trained detector in the video path,
    the loop step's times and its check against the CPU."""
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        logs = Path(tmp) / "logs"
        fresh_px = detector_train_phase(logs, smi)
        trained_detector_video(logs, fresh_px)
        frozen_models_phase(logs)
        loop_cli_phase(logs)
        loop_step_phase(logs, smi)
    loop_device_check()
    torch.cuda.empty_cache()
    log(f"phase 26 (detector, projector and loop trainers): {time.perf_counter() - t0:.1f} s")


# phase 27: SMPL, HybrIK and the SMPL-IK pose model

SMPL_LEAVES = (411, 2445, 5905, 3216, 6617)  # the reference's leaf vertices (lbs.py:352)
SMPL_FN_B = 8        # skeletons a batch in the function checks
# the SMPL functions on the card against a float64 run on the CPU: float64
# computes the same expressions (1e-10; measured 3.0e-14). f32 with TF32
# off: the eval path's rotations (the SVD pelvis, swings between near
# parallel bones) are ill-conditioned in f32: the CPU's f32 lies up to
# 4.9e-6 from float64 here, JAX's f32 1.1e-5 on the CPU (PERF.md §2), the
# card's (cuSOLVER's SVD) 2.3e-5 (positions in metres and rotations)
SMPL_FN_ATOL = {torch.float64: 1e-10, torch.float32: 5e-5}
SMPL_CLAMP_MARGIN = 1e-5  # no joint's distance within this of the 15 mm threshold
SMPL_B = 32          # the SMPL-IK forward's and train step's batch, 256 x 256 frames
# the final conv x12: at the init's scale the uvd sit within ~0.05 of 0
# (std 0.010); x12 spreads them (std ~0.135 on the CPU), where the bf16
# net stays within 0.016 (uvd) and 0.026 (phis) of the f32 one
SMPL_FINAL_SCALE = 12.0
SMPL_BF16_ATOL = 5e-2  # the bf16 net vs the f32 module: uvd, phis, shape
SMPL_BF16_KEYS = ("pred_uvd_jts", "pred_phi", "pred_shape")
SMPL_STEPS = 10
SMPL_LR = 3e-4       # Adam, the JAX package's test of the step
# the train step on the card against the CPU: ResNet-18, 64^2, volume depth
# 8, B = 4, the final conv x64 (uvd std ~0.13), dropout 0 (the devices draw
# other masks); limits as the loop step's (LOOP_CHECK_LIMITS)
SMPL_CHECK = {"architecture": "resnet18", "depth": 8, "size": 64, "b": 4, "scale": 64.0}
SMPL_KINDS = (("cuSOLVER (SVD, det)", ("svd", "gesvd", "syevj", "jacobi", "getrf", "lu_",
                                       "det")),) + LOOP_KINDS


def smpl_body():
    """The 6890-vertex synthetic body with the reference's leaf vertex ids."""
    return dataclasses.replace(synthetic_model(6890, seed=0), leaf_vertex_ids=SMPL_LEAVES)


def smpl_cams(b: int, device) -> tuple:
    """(trans_inv, k_inv, joint_root, depth_factor) of ``tests/test_smpl_pose.py``:
    identity crop, 1/f = 1e-3, the root 3 m away, a 2.2 m depth factor."""
    return (torch.eye(2, 3, device=device).expand(b, 2, 3),
            torch.diag(torch.tensor([1e-3, 1e-3, 1.0], device=device)).expand(b, 3, 3),
            torch.tensor([[0.0, 0.0, 3000.0]], device=device).expand(b, 3),
            torch.full((b, 1), 2200.0, device=device))


def smpl_skeletons(body, seed: int):
    """Float64 CPU inputs: betas (B, 10), axis-angle poses (B, 72), the rest
    joints (B, 29, 3), their rotations (B, 29, 3, 3) (the leaves'
    identity), FK skeletons (B, 29, 3) with 5 mm of noise and joint 4 of
    sample 0 moved 10 cm (an outlier for the eval path's clamp), twists
    (B, 23, 2)."""
    g = torch.Generator().manual_seed(seed)
    b = SMPL_FN_B

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    betas, pose = 0.3 * randn(b, 10), 0.25 * randn(b, 72)
    arr = smpl.body_arrays(body, betas)
    v_shaped = arr["v_template"] + smpl.blend_shapes(betas, arr["shapedirs"])
    rest24 = smpl.vertices2joints(arr["j_regressor"], v_shaped)
    rest29 = torch.cat([rest24, v_shaped[:, list(body.leaf_vertex_ids)]], 1)
    rots = torch.cat([smpl.batch_rodrigues(pose.view(b, 24, 3)),
                      torch.eye(3, dtype=torch.float64).expand(b, 5, 3, 3)], 1)
    pos, _ = smpl.batch_rigid_transform(rots, rest29, parents=smpl.PARENTS,
                                        levels=smpl.IK_LEVELS[1:])
    pos = pos + 0.005 * randn(*pos.shape)
    pos[0, 4, 0] += 0.1
    return betas, pose, rest29, rots, pos, randn(b, 23, 2)


def _ik_clamped(threshold: float, args) -> torch.Tensor:
    """The eval path's rotations with the clamp's threshold at ``threshold``."""
    old = hybrik.CLAMP_M
    hybrik.CLAMP_M = threshold
    try:
        return hybrik.inverse_kinematics(*args, train=False)[0]
    finally:
        hybrik.CLAMP_M = old


def smpl_function_check() -> None:
    """lbs, batch_rigid_transform, inverse_kinematics (eval and naive) and
    hybrik (eval and naive) on the card, in float64 and in f32 (TF32 off),
    against a float64 run on the CPU (SMPL_FN_ATOL); the eval clamp fires
    on some joints and not on others, with no distance within
    SMPL_CLAMP_MARGIN of its threshold."""
    body = smpl_body()
    betas, pose, rest29, rots, pos, phis = smpl_skeletons(body, SEED + 86)
    fns = {
        "lbs": lambda m, t: smpl.lbs(m, t[0], t[1]),
        "batch_rigid_transform": lambda m, t: smpl.batch_rigid_transform(
            t[3], t[2], parents=smpl.PARENTS, levels=smpl.IK_LEVELS[1:]),
        "inverse_kinematics eval": lambda m, t: hybrik.inverse_kinematics(t[4], t[5], t[2]),
        "inverse_kinematics naive": lambda m, t: hybrik.inverse_kinematics(t[4], t[5], t[2],
                                                                           train=True),
        "hybrik eval": lambda m, t: hybrik.hybrik(m, t[0], t[4], t[5]),
        "hybrik naive": lambda m, t: hybrik.hybrik(m, t[0], t[4], t[5], train=True),
    }
    inputs = (betas, pose, rest29, rots, pos, phis)
    ref_body = smpl.SMPLTensors(body, device="cpu").double()
    ref = {k: fn(ref_body, inputs) for k, fn in fns.items()}
    errs = {}
    for dtype, atol in SMPL_FN_ATOL.items():
        for dev in ("cuda", "cpu"):
            m = smpl.SMPLTensors(body, device=dev).to(dtype)
            t = tuple(a.to(dev, dtype) for a in inputs)
            for k, fn in fns.items():
                errs[(dev, dtype, k)] = max((g.cpu().double() - w).abs().max().item()
                                            for g, w in zip(fn(m, t), ref[k]))
        card = {k: v for (dev, dt, k), v in errs.items() if dev == "cuda" and dt == dtype}
        log(f"SMPL functions on the card vs a float64 CPU run ({dtype}, TF32 off, 6890 "
            f"vertices, B={SMPL_FN_B}): max abs err " + ", ".join(
                f"{k} {v:.3e} (CPU {errs[('cpu', dtype, k)]:.3e})" for k, v in card.items())
            + f"; limit {atol}")
        if max(card.values()) > atol:
            raise AssertionError(f"the SMPL functions on the card disagree with the CPU in {dtype}")
    t = tuple(a.cuda() for a in (pos, phis, rest29))
    default = hybrik.inverse_kinematics(*t, train=False)[0]
    never, always = _ik_clamped(math.inf, t), _ik_clamped(-1.0, t)
    moved = [(_ik_clamped(hybrik.CLAMP_M + d, t) - default).abs().max().item()
             for d in (-SMPL_CLAMP_MARGIN, SMPL_CLAMP_MARGIN)]
    fires = [(default - never).abs().max().item(), (default - always).abs().max().item()]
    log(f"eval clamp on the card (float64): vs never clamping {fires[0]:.3e}, vs always "
        f"{fires[1]:.3e} (both must exceed 1e-3); threshold moved by -/+{SMPL_CLAMP_MARGIN}: "
        f"{moved[0]:.3e}, {moved[1]:.3e} (must be 0)")
    if min(fires) <= 1e-3 or max(moved) != 0.0:
        raise AssertionError("the eval clamp does not fire on some joints only, or a distance "
                             "lies at its threshold")


def smpl_pose_model(architecture="resnet50", depth=64, scale=SMPL_FINAL_SCALE, seed=SEED + 80,
                    device="cuda"):
    """HybrIKPose from the seed: the PoseSMPLNet's final conv x ``scale``, the
    6890-vertex body."""
    net = PoseSMPLNet(architecture, depth=depth, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    net.final_layer.weight.data.mul_(scale)
    return HybrIKPose(net.to(device), smpl_body())


def smpl_forward_phase(smi: str) -> None:
    """The SMPL-IK forward at full width (ResNet-50, depth 64, 256^2, B =
    SMPL_B), eval, bf16 under autocast against the f32 module, flip_test
    off and on; its times, and the IK + LBS half's apart."""
    model = smpl_pose_model().eval()
    x = direct_frames(SMPL_B, SEED + 81)
    cam = smpl_cams(SMPL_B, "cuda")
    with torch.inference_mode():
        for flip in (False, True):
            f32 = model(x, *cam, flip_test=flip)
            bf16 = bf16_apply(lambda f: model(f, *cam, flip_test=flip), x)
            errs = {k: (bf16[k] - f32[k]).abs().max().item() for k in f32}
            spread = model.net(x)["uvd29"].std().item()
            finite = all(v.isfinite().all() for v in (*f32.values(), *bf16.values()))
            log(f"SMPL-IK forward bf16 vs f32 (resnet50, depth 64, {DIRECT_SIZE}^2, B={SMPL_B}, "
                f"flip_test {flip}; uvd spread {spread:.4f}, min {MIN_SPREAD}): max abs err "
                + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
                + f"; limit {SMPL_BF16_ATOL} on {', '.join(SMPL_BF16_KEYS)}")
            if (not finite or spread < MIN_SPREAD or any(v.dtype != torch.float32 for v in
                                                          bf16.values())
                    or max(errs[k] for k in SMPL_BF16_KEYS) > SMPL_BF16_ATOL):
                raise AssertionError(f"the bf16 SMPL-IK forward (flip_test {flip}) is wrong")
        times = {}
        for flip in (False, True):
            fwd = lambda: bf16_apply(lambda f: model(f, *cam, flip_test=flip), x)  # noqa: E731
            ms = cuda_ms(fwd, n=5)
            split, launches = device_profile(fwd, n=3)
            torch.cuda.reset_peak_memory_stats()
            fwd()
            torch.cuda.synchronize()
            times[flip] = (ms, sum(split.values()), launches,
                           torch.cuda.max_memory_allocated() / 2**30, split)
        out = bf16_apply(model.net, x)
        half = lambda: model._smpl_half(out, *cam)  # noqa: E731
        half_ms = cuda_ms(half, n=5)
        half_split, half_launches = device_profile(half, n=5)
    for flip, (ms, busy, launches, peak, split) in times.items():
        log(f"time SMPL-IK forward bf16 B={SMPL_B} flip_test {flip} ({smi}): {ms:.4f} ms (CUDA "
            f"events) = {SMPL_B / ms * 1e3:.1f} frames/s; device {busy:.4f} ms, busy "
            f"{busy / ms:.1%}; {launches:.0f} kernel launches; peak device memory {peak:.2f} GiB;"
            " by kind: " + ", ".join(f"{k} {v:.4f}" for k, v in by_kind(split, SMPL_KINDS).items())
            + "; top: " + top_kernels(split, 8))
    half_dev = sum(half_split.values())
    log(f"time SMPL half alone (uvd_to_cam, HybrIK eval: IK + LBS, root-centring, quaternions; "
        f"f32, B={SMPL_B}, 6890 vertices): {half_ms:.4f} ms (CUDA events), device "
        f"{half_dev:.4f} ms, busy {half_dev / half_ms:.1%}, {half_launches:.0f} launches; by "
        "kind: " + ", ".join(f"{k} {v:.4f}" for k, v in by_kind(half_split, SMPL_KINDS).items())
        + "; top: " + top_kernels(half_split, 8))
    del model, out
    torch.cuda.empty_cache()


def _smpl_check_state(device, dtype):
    c = SMPL_CHECK
    model = smpl_pose_model(c["architecture"], c["depth"], c["scale"], SEED + 82, "cpu")
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0  # the two devices would draw other masks
    return create_train_state(model.to(device=device, dtype=dtype), lr=SMPL_LR, optimizer="adam")


def smpl_step_check() -> None:
    """One ``make_hybrik_train_step`` from the same weights on the card and
    on the CPU, in float64 and in f32 with TF32 off: the loss, the net's
    gradients and its running statistics (LOOP_CHECK_LIMITS)."""
    c = SMPL_CHECK
    rng = np.random.default_rng(SEED + 87)
    frames = rng.random((c["b"], c["size"], c["size"], 3))
    uvd_gt = rng.uniform(-0.4, 0.4, (c["b"], 29, 3))
    xyz_gt = rng.uniform(-0.3, 0.3, (c["b"], 17, 3))
    step = make_hybrik_train_step()
    for dtype, (loss_rtol, grad_rel, stats_atol) in LOOP_CHECK_LIMITS.items():
        states, metrics = {}, {}
        for dev in ("cpu", "cuda"):
            states[dev] = _smpl_check_state(dev, dtype)
            cam = tuple(t.to(dtype) for t in smpl_cams(c["b"], dev))
            f, u, y = (torch.from_numpy(a).to(dev, dtype) for a in (frames, uvd_gt, xyz_gt))
            metrics[dev] = step(states[dev], f, cam, u, y, SEED)
        loss_err = abs(metrics["cuda"]["loss"].item() / metrics["cpu"]["loss"].item() - 1)
        cpu_net, card_net = states["cpu"].model.net, states["cuda"].model.net
        grads = {name: (p.grad.double(), q.grad.cpu().double()) for (name, p), q in
                 zip(cpu_net.named_parameters(), card_net.parameters())}
        stats_err = max((q.cpu() - p).abs().max().item() for (name, p), q in
                        zip(cpu_net.named_buffers(), card_net.buffers()) if "running" in name)
        rel = sorted((_rel(q, p), k) for k, (p, q) in grads.items())
        together = (torch.cat([(q - p).flatten() for p, q in grads.values()]).norm()
                    / torch.cat([p.flatten() for p, _ in grads.values()]).norm()).item()
        per_param = dtype == torch.float64
        log(f"SMPL-IK train step on the card vs the CPU ({dtype}, TF32 off, "
            f"{c['architecture']}, {c['size']}^2, depth {c['depth']}, B={c['b']}, naive IK): "
            f"loss {metrics['cuda']['loss'].item():.6g}, relative err {loss_err:.3e} (rtol "
            f"{loss_rtol}); gradients relative L2 (limit {grad_rel} "
            + ("each" if per_param else "all together") + f"): all together {together:.3e}, "
            "worst " + ", ".join(f"{v:.3e} ({k})" for v, k in rel[-3:][::-1])
            + f", median {statistics.median(v for v, _ in rel):.3e}; running statistics max abs "
            f"err {stats_err:.3e} (atol {stats_atol})")
        grad_err = rel[-1][0] if per_param else together
        if loss_err > loss_rtol or grad_err > grad_rel or stats_err > stats_atol:
            raise AssertionError(f"the SMPL-IK step on the card disagrees with the CPU in {dtype}")


def smpl_train_phase(smi: str) -> None:
    """SMPL_STEPS steps of ``make_hybrik_train_step`` at full width (ResNet-50,
    depth 64, 256^2, B = SMPL_B, bf16 over f32 weights, Adam SMPL_LR) on one
    fixed batch and dropout seed: finite, the mean of the last three below
    the first; the step's times, launches, peak memory and device time by
    kind."""
    model = smpl_pose_model(seed=SEED + 83)
    state = create_train_state(model, lr=SMPL_LR, optimizer="adam", apply=bf16_apply)
    rng = np.random.default_rng(SEED + 84)
    x = direct_frames(SMPL_B, SEED + 85)
    cam = smpl_cams(SMPL_B, "cuda")
    uvd_gt = torch.from_numpy(rng.uniform(-0.4, 0.4, (SMPL_B, 29, 3)).astype(np.float32)).cuda()
    xyz_gt = torch.from_numpy(rng.uniform(-0.3, 0.3, (SMPL_B, 17, 3)).astype(np.float32)).cuda()
    step = make_hybrik_train_step()
    run = lambda: step(state, x, cam, uvd_gt, xyz_gt, SEED + 86)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    losses = [run()["loss"].item() for _ in range(SMPL_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"SMPL-IK train B={SMPL_B} (resnet50, depth 64, {DIRECT_SIZE}^2, bf16 over f32, Adam "
        f"{SMPL_LR}): {SMPL_STEPS} steps on one batch, loss " + ", ".join(f"{v:.5g}" for v in losses)
        + f"; peak device memory {peak:.2f} GiB")
    if not all(math.isfinite(v) for v in losses) or not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError("the SMPL-IK training loss did not fall")
    ms = cuda_ms(run, n=3)
    split, launches = device_profile(run, n=2)
    busy = sum(split.values())
    log(f"time SMPL-IK train step B={SMPL_B} ({smi}): {ms:.4f} ms (CUDA events) = "
        f"{SMPL_B / ms * 1e3:.1f} frames/s; device {busy:.4f} ms, busy {busy / ms:.1%}; "
        f"{launches:.0f} kernel launches a step; by kind: "
        + ", ".join(f"{k} {v:.4f}" for k, v in by_kind(split, SMPL_KINDS).items())
        + "; top: " + top_kernels(split, 10))
    del state, model
    torch.cuda.empty_cache()


def smpl_phase() -> None:
    """Phase 27: the SMPL functions and HybrIK on the card, the SMPL-IK
    forward and train step; none of the 18 records' wrappers launched."""
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    for f in wrappers:
        f.launches = 0
    smpl_function_check()
    smpl_forward_phase(smi)
    smpl_step_check()
    smpl_train_phase(smi)
    made = {f.__name__: f.launches for f in wrappers if f.launches}
    log(f"phase 27 launches of the 18 kernel records' wrappers (counts from 0): {made or 0}")
    if made:
        raise AssertionError("the SMPL-IK path launched a kernel of the records")
    log(f"phase 27 (SMPL, HybrIK, the SMPL-IK model): {time.perf_counter() - t0:.1f} s")


# --- data parallelism (parallel/mesh.py) ------------------------------------

DP_RANK_CLIPS = TRAIN_CLIPS // 2  # the 2-rank temporal step: 8 clips a rank
DP_BN_B, DP_BN_SIZE = 8, 64       # the 2-rank global-BN direct step: ResNet-18, float64
DP_BN_ARCH = "resnet18"
DP_WIDE_SEED = SEED + 96          # the full-width bf16 global-BN steps' batch
DP_TIMED = 5                      # steps a timed run in the DP phase
DP_DEADLINE_S = 300               # the 2-rank phase's ranks, at most
BN_F64_ATOL = 1e-8                # float64 parameters of a BatchNorm image step vs one process
DP_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def world_of_one():
    """A world of one ``nccl`` rank in this process, its mesh yielded: every
    collective is real, over one rank; the group and the environment are
    gone after."""
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(_free_port()))
    try:
        device = PM.init_distributed("nccl", device_type="cuda")
        if device != torch.device("cuda", 0):
            raise AssertionError(f"the rank's device is {device}")
        yield PM.make_mesh()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in DP_ENV:
            os.environ.pop(k, None)


def _differ(a: dict, b: dict) -> list[str]:
    """Names whose tensors are not bitwise equal."""
    return [k for k, v in a.items() if not torch.equal(v, b[k])]


def _counts(wrappers) -> dict:
    return {f.__name__: f.launches for f in wrappers}


def _reset(wrappers) -> None:
    for f in wrappers:
        f.launches = 0


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _pmean_ms(model, mesh) -> tuple[float, float, int]:
    """(ms of ``pmean_`` over the model's gradients, ms of the bare
    ``all_reduce`` of one flat buffer of them, its bytes)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    group = PM.data_group(mesh)
    return (cuda_ms(lambda: PM.pmean_(grads, mesh)),
            cuda_ms(lambda: dist.all_reduce(flat, group=group)),
            flat.numel() * flat.element_size())


def dp_one_rank_phase(mesh) -> tuple[dict, dict]:
    """One ``nccl`` rank: each DP entry point against its one-process
    counterpart on the same inputs from copies of one model, bitwise (a sum
    over one rank and a division by 1 are exact): the DP fused temporal
    step (TRAIN_CLIPS x 243, rows 8a-9b), the fused DP direct step
    (ResNet-50, B = DIRECT_B, 256^2, rows 13a/13b; cuDNN's deterministic
    algorithms, so the two runs of the one step agree), and
    ``LifterService(mesh=)`` at B = TOP and 10000 (row 1). Each DP run with
    the counts set to 0 before it. Returns (launches, times)."""
    import copy

    launches, t = {}, {}
    model = seeded_train_model()
    twin = copy.deepcopy(model)
    y1, y2 = synthetic_batch(TRAIN_CLIPS, model.clip_len, SEED + 90)
    one_state = create_train_state(model, lr=TRAIN_LR, apply=ST.temporal_train_forward_fused)
    dp_state = create_train_state(twin, lr=TRAIN_LR, apply=ST.temporal_train_forward_fused)
    one, dp = make_lifter_train_step("mse"), make_dp_lifter_train_step(mesh, "mse")
    m1 = one(one_state, y1, y2)
    _reset(ST.WRAPPERS)
    m2 = dp(dp_state, y1, y2)
    launches.update(_counts(TRAIN_WRAPPERS))
    bad = (_differ(_grads(model), _grads(twin)) + _differ(model.state_dict(), twin.state_dict())
           + _differ(m1, m2))
    log(f"dp 1 rank temporal step C={TRAIN_CLIPS}: loss {m2['loss'].item():.8g}, "
        f"launches {launches}; bitwise the one-process step: {not bad}")
    if bad or launches != {f.__name__: 5 for f in TRAIN_WRAPPERS}:
        raise AssertionError(f"the one-rank DP temporal step differs: {bad[:5]}")
    t["temporal_one"] = cuda_ms(lambda: one(one_state, y1, y2), n=DP_TIMED)
    t["temporal_dp"] = cuda_ms(lambda: dp(dp_state, y1, y2), n=DP_TIMED)
    t["temporal_pmean"], t["temporal_allreduce"], nbytes = _pmean_ms(twin, mesh)
    log(f"time dp 1 rank temporal step C={TRAIN_CLIPS}: one process {t['temporal_one']:.4f} ms, "
        f"DP {t['temporal_dp']:.4f} ms; pmean_ of the gradients {t['temporal_pmean']:.4f} ms, "
        f"its flat all_reduce alone {t['temporal_allreduce']:.4f} ms ({nbytes} bytes)")
    del model, twin, one_state, dp_state
    torch.cuda.empty_cache()

    flags, wrappers = DIRECT_TRAIN_ROUTES["fused"]
    model = seeded_train_posenet(**flags)
    twin = copy.deepcopy(model)
    frames, kp3d = direct_train_batch(SEED + 91)
    one_state, dp_state = (create_train_state(m, lr=DIRECT_LR, optimizer="adam",
                                              weight_decay=DIRECT_WD, apply=bf16_apply)
                           for m in (model, twin))
    one, dp = make_direct_train_step("mse"), make_dp_direct_train_step(mesh, "mse")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m1 = one(one_state, frames, kp3d)
        _reset(DECODE_WRAPPERS)
        m2 = dp(dp_state, frames, kp3d)
        made = _counts(wrappers)
        bad = (_differ(_grads(model), _grads(twin))
               + _differ(model.state_dict(), twin.state_dict()) + _differ(m1, m2))
        log(f"dp 1 rank direct fused step B={DIRECT_B}: loss {m2['loss'].item():.8g}, launches "
            f"{made}; bitwise the one-process step: {not bad}")
        if bad or made != {f.__name__: 1 for f in wrappers}:
            raise AssertionError(f"the one-rank DP direct step differs: {bad[:5]}")
        launches.update(made)
        t["direct_one"] = cuda_ms(lambda: one(one_state, frames, kp3d), n=DP_TIMED)
        t["direct_dp"] = cuda_ms(lambda: dp(dp_state, frames, kp3d), n=DP_TIMED)
        # device time: does the DP step's extra time run on the card?
        busy = {k: sum(device_ms_by_kernel(fn, n=DP_TIMED).values()) for k, fn in (
            ("one", lambda: one(one_state, frames, kp3d)),
            ("dp", lambda: dp(dp_state, frames, kp3d)))}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    t["direct_pmean"], t["direct_allreduce"], nbytes = _pmean_ms(twin, mesh)
    log(f"time dp 1 rank direct fused step B={DIRECT_B} (cuDNN deterministic): one process "
        f"{t['direct_one']:.4f} ms ({busy['one']:.4f} of device time), DP "
        f"{t['direct_dp']:.4f} ms ({busy['dp']:.4f}); pmean_ of the gradients "
        f"{t['direct_pmean']:.4f} ms, its flat all_reduce alone {t['direct_allreduce']:.4f} ms "
        f"({nbytes} bytes)")
    del model, twin, one_state, dp_state
    torch.cuda.empty_cache()

    with torch.inference_mode():
        vit = seeded_model("cuda", torch.bfloat16)
        svc = LifterService(vit, None, device="cuda", max_batch=TOP).warmup()
        svc_dp = LifterService(vit, None, device="cuda", max_batch=TOP, mesh=mesh).warmup()
        if not svc_dp.fused or svc_dp.buckets != svc.buckets:
            raise AssertionError("the DP service left the trunk route or its buckets")
        rng = np.random.default_rng(SEED + 92)
        requests = [rng.random((n, 17, 2)).astype(np.float32) for n in (TOP, 10000)]
        L.trunk.launches = 0
        answers = [svc_dp.lift(kp) for kp in requests]
        launches["trunk"] = L.trunk.launches
        same = all(np.array_equal(a, svc.lift(kp)) for a, kp in zip(answers, requests))
        log(f"dp 1 rank LifterService N={TOP}, 10000: trunk launches {launches['trunk']} "
            f"(expected 3); bitwise the one-process service: {same}")
        if not same or launches["trunk"] != 3:
            raise AssertionError("the one-rank DP service differs")
        kp = requests[0]
        t["serve_one"] = cuda_ms(lambda: svc.lift(kp))
        t["serve_dp"] = cuda_ms(lambda: svc_dp.lift(kp))
        full = torch.zeros((TOP, 51), device="cuda")
        t["serve_allreduce"] = cuda_ms(lambda: dist.all_reduce(full, group=PM.data_group(mesh)))
    log(f"time dp 1 rank LifterService.lift N={TOP} host to host: one process "
        f"{t['serve_one']:.4f} ms, DP {t['serve_dp']:.4f} ms; the answer's all_reduce "
        f"({TOP} x 51 f32) {t['serve_allreduce']:.4f} ms")
    return launches, t


def force_global_bn(model, mesh):
    """``model``'s BatchNorms bound global over ``mesh`` even where its data
    axis has one rank (``sync_batch_norm`` then leaves them as they are):
    the global-BN Function runs, its all-reduces over the one rank, to be
    held and timed against cuDNN's batch norm on the same batch."""
    sync_batch_norm(model, mesh)
    for m in model.modules():
        if isinstance(m, (F32BatchNorm1d, F32BatchNorm2d)):
            m.process_group = PM.data_group(mesh)
    return model


def _peak_gib(fn) -> float:
    """GiB the card's allocator held at most during fn(), above what it
    held before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def _total_rel(a: dict, b: dict) -> float:
    return _rel(torch.cat([v.flatten() for v in a.values()]),
                torch.cat([b[k].flatten() for k in a]))


def f64_apply(model, x):
    """``TrainState.apply`` of a float64 model: the frames in float64."""
    return model(x.double())


def hold_f64_step(what, loss, grads, loss_ref, grads_ref) -> None:
    """A float64 direct step on the global-BN Function against the same
    step on cuDNN's batch norm: the loss within rtol 1e-10, all gradients
    together and the final conv's within relative L2 1e-8 (the same
    function, sums in other orders; float64 as PRs 13-17's parity checks,
    since this model's train-mode f32 and bf16 gradients are
    ill-conditioned). No per-parameter limit: a BatchNorm weight's
    gradient can nearly cancel; the worst is logged."""
    total = _total_rel(grads, grads_ref)
    final = max(_rel(grads[k], grads_ref[k]) for k in ("final_layer.weight", "final_layer.bias"))
    rel = {n: _rel(grads[n], grads_ref[n]) for n in grads}
    worst = max(rel, key=rel.get)
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    log(f"{what}: loss {loss:.12g} vs {loss_ref:.12g} (rel {loss_err:.3g}); grads: all together "
        f"{total:.4g}, final conv {final:.4g}, median {statistics.median(rel.values()):.4g}, "
        f"worst {rel[worst]:.4g} ({worst})")
    if not math.isfinite(loss) or loss_err > 1e-10 or total > 1e-8 or final > 1e-8:
        raise AssertionError(f"{what} disagrees with cuDNN's batch norm")


F64_LOSS_RTOL = 1e-10             # a float64 multi-rank step vs one process: loss, MPJPE sums
F64_RUNNING_ATOL = 1e-10          # and running statistics


def hold_f64_state(what, got, want, param_atol: float) -> None:
    """A float64 multi-rank run, ``got`` = (loss or losses, MPJPE sums, the
    whole state dict), against the one-process run of the same steps on
    the global batch, ``want``: every loss and the sums within rtol
    F64_LOSS_RTOL, every parameter within atol ``param_atol``, every
    running statistic within F64_RUNNING_ATOL."""
    (losses, sums, sd), (w_losses, w_sums, w_sd) = got, want
    loss_err = max(abs(a / b - 1) for a, b in zip(np.atleast_1d(losses), np.atleast_1d(w_losses)))
    sums_err = ((sums - w_sums).abs() / w_sums.abs()).max().item()
    errs = {"params": 0.0, "running": 0.0}
    for k, v in w_sd.items():
        if v.is_floating_point():
            kind = "running" if "running" in k else "params"
            errs[kind] = max(errs[kind], (sd[k] - v).abs().max().item())
    log(f"{what}: loss {losses}, rel err {loss_err:.3g}, MPJPE sums {sums_err:.3g}; parameters "
        f"{errs['params']:.3g}, running statistics {errs['running']:.3g} from one process")
    if (loss_err > F64_LOSS_RTOL or sums_err > F64_LOSS_RTOL or errs["params"] > param_atol
            or errs["running"] > F64_RUNNING_ATOL):
        raise AssertionError(f"{what} disagrees with one process")


def hold_to_f64(what, got, cudnn, ref64, floor) -> None:
    """A reduced-precision direct step on the global-BN Function, ``got`` =
    (loss, gradients), as accurate as the same step on cuDNN's batch norm,
    ``cudnn``, both measured against the float64 step ``ref64``: the
    loss's error and all gradients' together (relative L2) each at most
    F32_ERR_RATIO x cuDNN's (floor ``floor``, relative). The two steps
    round the BatchNorms' outputs in other places, and this model's
    train-mode gradients amplify roundings (both errors are logged), so
    they are not held to each other; each parameter's ratio is logged."""
    (loss_k, g_k), (loss_p, g_p), (loss_64, g_64) = got, cudnn, ref64
    err_k, err_p = _total_rel(g_k, g_64), _total_rel(g_p, g_64)
    lerr_k, lerr_p = (abs(v - loss_64) / abs(loss_64) for v in (loss_k, loss_p))
    ratio = {n: _rel(g_k[n], g_64[n]) / max(_rel(g_p[n], g_64[n]), floor) for n in g_k}
    worst = max(ratio, key=ratio.get)
    log(f"{what}: loss {loss_k:.8g}, cuDNN's {loss_p:.8g}, float64 {loss_64:.8g} (rel "
        f"{lerr_k:.3g}, {lerr_p:.3g}); grads vs float64, all together: global BN {err_k:.4g}, "
        f"cuDNN {err_p:.4g}; to each other {_total_rel(g_k, g_p):.4g}; per parameter ratio: "
        f"median {statistics.median(ratio.values()):.3g}, worst {ratio[worst]:.3g} ({worst})")
    if (not math.isfinite(loss_k) or lerr_k > F32_ERR_RATIO * max(lerr_p, floor)
            or err_k > F32_ERR_RATIO * max(err_p, floor)):
        raise AssertionError(f"{what} is less accurate than cuDNN's batch norm")


def global_bn_module_check(mesh) -> None:
    """One BatchNorm of the ResNet-50's layer 1 output, bf16, B = 64:
    (64, 256, 64, 64) channels_last, per-channel offsets and scales, half
    the batch shifted; the global-BN Function over the one rank against
    cuDNN's train-mode batch norm on the same input and upstream gradient:
    output and input gradient within 2 bf16 steps of the largest (both
    compute in f32 and round once), the f32 weight and bias gradients
    within 1e-3 of the largest, the running statistics rtol 1e-4."""
    gen = torch.Generator().manual_seed(SEED + 97)
    shape = (DIRECT_B, 256, DIRECT_SIZE // 4, DIRECT_SIZE // 4)
    scale = torch.linspace(0.5, 3.0, 256).view(1, 256, 1, 1)
    x = torch.randn(shape, generator=gen) * scale + torch.linspace(-2.0, 4.0, 256).view(
        1, 256, 1, 1)
    x[:DIRECT_B // 2] += 1.5
    x = x.to("cuda", torch.bfloat16).contiguous(memory_format=torch.channels_last)
    g = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    out = {}
    for name in ("cudnn", "global"):
        bn = F32BatchNorm2d(256, device="cuda").train()
        if name == "global":
            force_global_bn(bn, mesh)
        xi = x.detach().requires_grad_(True)
        y = bn(xi)
        y.backward(g)
        out[name] = (y.float(), xi.grad.float(), bn.weight.grad, bn.bias.grad,
                     bn.running_mean, bn.running_var, y.is_contiguous(
                         memory_format=torch.channels_last))
    errs = []
    for i, (got, want) in enumerate(zip(out["global"][:6], out["cudnn"][:6])):
        errs.append(((got - want).abs().max() / want.abs().max()).item())
    log(f"dp 1 rank global-BN module bf16 {tuple(shape)} vs cuDNN's batch norm: relative to the "
        f"largest: y {errs[0]:.3g}, dx {errs[1]:.3g}, dw {errs[2]:.3g}, db {errs[3]:.3g}, "
        f"running mean {errs[4]:.3g}, var {errs[5]:.3g}; channels_last {out['global'][6]}")
    if (errs[0] > 2 * 2.0 ** -8 or errs[1] > 2 * 2.0 ** -8 or max(errs[2:4]) > 1e-3
            or max(errs[4:6]) > 1e-4 or not out["global"][6]):
        raise AssertionError("the global-BN Function disagrees with cuDNN's batch norm")


def dp_wide_bn_phase(mesh) -> tuple[dict, dict]:
    """Global BatchNorm at full width (the fused route's ResNet-50, B =
    DIRECT_B, 256^2) in the world of one rank, forced through the global-BN
    Function (``force_global_bn``) beside cuDNN's batch norm: one
    BatchNorm alone (``global_bn_module_check``); the float64 step (the
    decodes on their plain versions) by ``hold_f64_step``; the f32 and
    bf16 steps' accuracy against it (``hold_to_f64``); then both bf16
    steps' time (CUDA events), device time (torch.profiler) and peak
    memory, neither with ``pmean_``. Returns (the one-process steps'
    losses and gradients, on the CPU: the two-rank steps' reference;
    times)."""
    import copy

    global_bn_module_check(mesh)
    flags, _ = DIRECT_TRAIN_ROUTES["fused"]
    frames, kp3d = direct_train_batch(DP_WIDE_SEED)
    model = seeded_train_posenet(**flags)
    model64 = copy.deepcopy(model).double()
    with plain_decodes():
        ref = {"f64": _direct_loss_and_grads(model64, frames, kp3d, f64_apply)}
        got = _direct_loss_and_grads(force_global_bn(model64, mesh), frames, kp3d, f64_apply)
    hold_f64_step(f"dp 1 rank global-BN direct step float64 B={DIRECT_B} vs cuDNN's", *got,
                  *ref["f64"])
    del model64, got
    for name, apply, floor in (("f32", lambda m, x: m(x), 2.0 ** -16),
                               ("bf16", bf16_apply, STEP_GRAD_REL)):
        ref[name] = _direct_loss_and_grads(model, frames, kp3d, apply)
        got = _direct_loss_and_grads(force_global_bn(model, mesh), frames, kp3d, apply)
        sync_batch_norm(model, None)
        hold_to_f64(f"dp 1 rank global-BN direct step {name} B={DIRECT_B}", got, ref[name],
                    ref["f64"], floor)
        del got
    ref = {k: (loss, {n: g.cpu() for n, g in grads.items()}) for k, (loss, grads) in ref.items()}
    state = create_train_state(model, lr=DIRECT_LR, optimizer="adam", weight_decay=DIRECT_WD,
                               apply=bf16_apply)
    step = make_direct_train_step("mse")
    t = {}
    for name, bind in (("cudnn", lambda: sync_batch_norm(model, None)),
                       ("global", lambda: force_global_bn(model, mesh))):
        bind()
        t[name] = cuda_ms(lambda: step(state, frames, kp3d), n=DP_TIMED)
        t[f"{name}_busy"] = sum(device_ms_by_kernel(lambda: step(state, frames, kp3d),
                                                    n=DP_TIMED).values())
        t[f"{name}_gib"] = _peak_gib(lambda: step(state, frames, kp3d))
    log(f"time dp 1 rank direct step bf16 B={DIRECT_B} (fused route, no pmean_): cuDNN's batch "
        f"norm {t['cudnn']:.4f} ms ({t['cudnn_busy']:.4f} of device time), peak "
        f"{t['cudnn_gib']:.3f} GiB above the state; global BN forced over one rank "
        f"{t['global']:.4f} ms ({t['global_busy']:.4f}), peak {t['global_gib']:.3f} GiB")
    del model, state
    torch.cuda.empty_cache()
    return ref, t


def dp_bn_model(dtype=torch.float64):
    """The DP_BN_ARCH PoseNet3D on the NHWC route from the seed (final conv
    x FINAL_SCALE), on the card in ``dtype``, and its batch: DP_BN_B
    synthetic frames of DP_BN_SIZE^2, the first half brightened (each
    rank's statistics differ from the global batch's), and poses."""
    model = PoseNet3D(DP_BN_ARCH, return_heatmap=False, device="cpu").init_weights(
        torch.Generator().manual_seed(SEED + 93))
    model.final_layer.weight.data.mul_(FINAL_SCALE)
    frames = synthetic_frames(DP_BN_B, DP_BN_SIZE, seed=SEED + 94).astype(np.float64) * 0.5
    frames[:DP_BN_B // 2] += 0.5
    _, kp3d = synthetic_h36m(DP_BN_B, seed=SEED + 94)
    return (model.to("cuda", dtype),
            torch.from_numpy(frames).to("cuda", dtype),
            torch.from_numpy((kp3d - kp3d[:, :1]).astype(np.float64)).to("cuda", dtype))


def dp_rank() -> dict:
    """A rank of the 2-rank phase (``gloo`` on cuda:0, ``run_ranks``): the DP fused
    temporal step on its DP_RANK_CLIPS clips, the global-BN float64 direct
    step on its DP_BN_B / 2 frames, then the full-width global-BN direct
    steps (ResNet-50, fused route), float64 (the decodes on their plain
    versions) and bf16, on its DIRECT_B / 2 frames; each timed (two processes sharing one GPU, not a scaling
    figure), the bf16 one with its peak memory. Returns the results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = PM.make_mesh()
    model = seeded_train_model()
    y1, y2 = PM.shard_batch(synthetic_batch(TRAIN_CLIPS, model.clip_len, SEED + 95), mesh)
    state = create_train_state(model, lr=TRAIN_LR, apply=ST.temporal_train_forward_fused)
    step = make_dp_lifter_train_step(mesh, "mse")
    _reset(ST.WRAPPERS)
    m = step(state, y1, y2)
    result = {"launches": _counts(TRAIN_WRAPPERS), "loss": m["loss"].item(),
              "grads": {k: v.cpu() for k, v in _grads(model).items()},
              "temporal_sd": {k: v.cpu().clone() for k, v in model.state_dict().items()}}
    result["temporal_ms"] = cuda_ms(lambda: step(state, y1, y2), n=DP_TIMED)
    del model, state
    torch.cuda.empty_cache()

    model, frames, kp3d = dp_bn_model()
    state = create_train_state(sync_batch_norm(model, mesh), lr=DIRECT_LR,
                               optimizer="adam", weight_decay=DIRECT_WD)
    step = make_direct_train_step("mse", mesh=mesh)
    frames, kp3d = PM.shard_batch((frames, kp3d), mesh)
    m = step(state, frames, kp3d)
    result.update(bn_loss=m["loss"].item(), bn_sums=m["mpjpe_sums"].cpu().clone(),
                  bn_sd={k: v.cpu().clone() for k, v in model.state_dict().items()})
    result["bn_ms"] = cuda_ms(lambda: step(state, frames, kp3d), n=DP_TIMED)
    del model, state
    torch.cuda.empty_cache()

    # the full-width global-BN steps (f32, then bf16) on the rank's half
    # of the batch
    frames, kp3d = PM.shard_batch(direct_train_batch(DP_WIDE_SEED), mesh)
    for name, apply in (("f64", f64_apply), ("bf16", bf16_apply)):
        model = seeded_train_posenet(**DIRECT_TRAIN_ROUTES["fused"][0])
        if name == "f64":
            model.double()
        state = create_train_state(sync_batch_norm(model, mesh), lr=DIRECT_LR,
                                   optimizer="adam", weight_decay=DIRECT_WD, apply=apply)
        with plain_decodes() if name == "f64" else contextlib.nullcontext():
            m = step(state, frames, kp3d)
        result[f"wide_{name}"] = (m["loss"].item(),
                                  {k: v.cpu() for k, v in _grads(model).items()})
        del model, state
        torch.cuda.empty_cache()
    model = sync_batch_norm(seeded_train_posenet(**DIRECT_TRAIN_ROUTES["fused"][0]), mesh)
    state = create_train_state(model, lr=DIRECT_LR, optimizer="adam",
                               weight_decay=DIRECT_WD, apply=bf16_apply)
    result["wide_ms"] = cuda_ms(lambda: step(state, frames, kp3d), n=DP_TIMED)
    result["wide_gib"] = _peak_gib(lambda: step(state, frames, kp3d))
    return result


def dp_two_rank_phase(wide_ref: dict) -> tuple[dict, dict]:
    """Two ``gloo`` ranks sharing cuda:0 (``nccl`` takes one device a rank),
    spawned from here after the one-process runs: the DP fused temporal
    step (2 x DP_RANK_CLIPS clips) against the one-process TRAIN_CLIPS-clip
    step (PERF.md's whole-step limits: loss rtol 1e-2, each gradient
    relative L2 <= STEP_GRAD_REL), and the global-BN direct step in float64
    (ResNet-18, DP_BN_SIZE^2, B = DP_BN_B) against the one-process step on
    the global batch (loss and MPJPE sums rtol 1e-10, parameters atol 1e-8,
    running statistics 1e-10), and the full-width global-BN direct steps
    (ResNet-50, 2 x DIRECT_B / 2 frames, 256^2) against the one-process
    DIRECT_B-frame steps of ``wide_ref``: float64 (``hold_f64_step``) and
    bf16 (``hold_to_f64``); the ranks' parameters and gradients bitwise
    equal. Returns (the ranks'
    launches, summed; times)."""
    model = seeded_train_model()
    y1, y2 = synthetic_batch(TRAIN_CLIPS, model.clip_len, SEED + 95)
    state = create_train_state(model, lr=TRAIN_LR, apply=ST.temporal_train_forward_fused)
    m = make_lifter_train_step("mse")(state, y1, y2)
    one_loss, one_grads = m["loss"].item(), {k: v.cpu() for k, v in _grads(model).items()}
    bn_model, frames, kp3d = dp_bn_model()
    bn_state = create_train_state(bn_model, lr=DIRECT_LR, optimizer="adam",
                                  weight_decay=DIRECT_WD)
    bm = make_direct_train_step("mse")(bn_state, frames, kp3d)
    bn_sd = {k: v.cpu().clone() for k, v in bn_model.state_dict().items()}
    del model, state, bn_model, bn_state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = run_ranks(dp_rank, 2, "cuda", deadline=DP_DEADLINE_S)
    log(f"dp 2 ranks: ready and done in {time.perf_counter() - t0:.1f} s")

    bad = (_differ(res[0]["temporal_sd"], res[1]["temporal_sd"])
           + _differ(res[0]["bn_sd"], res[1]["bn_sd"])
           + _differ(res[0]["wide_f64"][1], res[1]["wide_f64"][1])
           + _differ(res[0]["wide_bf16"][1], res[1]["wide_bf16"][1]))
    if bad:
        raise AssertionError(f"the ranks' parameters differ: {bad[:5]}")
    rel = {n: _rel(res[0]["grads"][n], one_grads[n]) for n in one_grads}
    worst = max(rel, key=rel.get)
    loss_err = abs(res[0]["loss"] - one_loss) / abs(one_loss)
    log(f"dp 2 ranks temporal step {2} x {DP_RANK_CLIPS} clips: loss {res[0]['loss']:.8g} vs "
        f"one process {one_loss:.8g} (rel {loss_err:.3g}); grads: worst relative L2 "
        f"{rel[worst]:.4g} ({worst}), median {statistics.median(rel.values()):.4g}; "
        f"launches {res[0]['launches']} + {res[1]['launches']}")
    want = {f.__name__: 5 for f in TRAIN_WRAPPERS}
    if (loss_err > 1e-2 or rel[worst] > STEP_GRAD_REL
            or any(r["launches"] != want for r in res)):
        raise AssertionError("the 2-rank DP temporal step disagrees with one process")
    got = res[0]
    hold_f64_state(f"dp 2 ranks global-BN direct step float64 {DP_BN_ARCH} {DP_BN_SIZE}^2 "
                   f"B={DP_BN_B}", (got["bn_loss"], got["bn_sums"], got["bn_sd"]),
                   (bm["loss"].item(), bm["mpjpe_sums"].cpu(), bn_sd), BN_F64_ATOL)
    hold_f64_step(f"dp 2 ranks global-BN direct step float64 2 x {DIRECT_B // 2} vs one "
                  f"process B={DIRECT_B}", *got["wide_f64"], *wide_ref["f64"])
    hold_to_f64(f"dp 2 ranks global-BN direct step bf16 2 x {DIRECT_B // 2}", got["wide_bf16"],
                wide_ref["bf16"], wide_ref["f64"], STEP_GRAD_REL)
    t = {k: [r[k] for r in res] for k in ("temporal_ms", "bn_ms", "wide_ms", "wide_gib")}
    log(f"time dp 2 ranks sharing one GPU (two processes, not a scaling figure): temporal step "
        f"{DP_RANK_CLIPS} clips a rank {t['temporal_ms'][0]:.4f} / {t['temporal_ms'][1]:.4f} ms, "
        f"global-BN float64 step {DP_BN_B // 2} frames a rank {t['bn_ms'][0]:.4f} / "
        f"{t['bn_ms'][1]:.4f} ms, global-BN bf16 ResNet-50 step {DIRECT_B // 2} frames a rank "
        f"{t['wide_ms'][0]:.4f} / {t['wide_ms'][1]:.4f} ms, peak {t['wide_gib'][0]:.3f} / "
        f"{t['wide_gib'][1]:.3f} GiB above the state (rank 0 / rank 1)")
    launches = {k: sum(r["launches"][k] for r in res) for k in want}
    return launches, t


def dp_phase() -> dict:
    """Phase 28: the data-parallel layer on the card (one ``nccl`` rank,
    then two ``gloo`` ranks on cuda:0). Returns the launches of the
    records' wrappers it made."""
    t0 = time.perf_counter()
    with world_of_one() as mesh:
        launches, _ = dp_one_rank_phase(mesh)
        wide_ref, _ = dp_wide_bn_phase(mesh)
    two, _ = dp_two_rank_phase(wide_ref)
    for k, n in two.items():
        launches[k] += n
    log(f"dp phase: {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


# phase 29: tensor parallelism (the model axis), its checkpoint, the DP
# SMPL-IK step and the multi-process dry run

TP_B = LiftConfig().batch_size  # the phase-1 trainer's batch
TP_LR = LiftConfig().lr         # with Adam
TP_STEPS = 3
TP_SEED = SEED + 100
TP_F64_ATOL = 1e-10              # float64 parameters after TP_STEPS
TP_F32_RATIO = 2.0               # f32 TP vs float64, relative to the one-process f32 step's
TP_F32_FLOOR = 2.0 ** -20        # relative: below it an f32 error is not held to a ratio
TP_DEADLINE_S = 300              # the TP ranks, at most
TP_GATHER = (TP_B, 512)          # one rank's activation shard at hidden 1024 over 2


def tp_martinez(dtype, dropout: float = 0.5) -> MartinezLifter:
    """The full-width MartinezLifter (hidden 1024, 2 stages) from the seed,
    on the card in ``dtype``."""
    return MartinezLifter(dropout=dropout, device="cpu").init_weights(
        torch.Generator().manual_seed(TP_SEED)).to("cuda", dtype)


def tp_batch(dtype) -> tuple:
    kp2d, kp3d = synthetic_h36m(TP_B, seed=TP_SEED)
    return tuple(torch.from_numpy(a).to("cuda", dtype) for a in (kp2d, kp3d - kp3d[:, :1]))


def tp_state(dtype, mesh=None, dropout: float = 0.5):
    """Adam at TP_LR over ``tp_martinez``; with ``mesh`` its BatchNorms bound
    global over the data axis and its wide layers cut over the model axis."""
    model = tp_martinez(dtype, dropout)
    if mesh is not None:
        shard_params(sync_batch_norm(model, mesh), mesh)
    return create_train_state(model, lr=TP_LR, optimizer="adam")


def tp_steps(state, y1, y2, mesh=None, steps: int = TP_STEPS) -> tuple[list, torch.Tensor]:
    """``steps`` steps of ``make_lifter_train_step(mesh=)`` on this rank's
    shard, step i's dropout from ``shard_seed(TP_SEED + i, data rank)``,
    each followed by the plateau step: (losses, the last MPJPE sums)."""
    step = make_lifter_train_step("mse", mesh)
    if mesh is not None:
        y1, y2 = PM.shard_batch((y1, y2), mesh)
    losses = []
    for i in range(steps):
        torch.manual_seed(PM.shard_seed(TP_SEED + i, 0 if mesh is None else PM.data_rank(mesh)))
        m = step(state, y1, y2)
        state.plateau.step(m["loss"].item())
        losses.append(m["loss"].item())
    return losses, m["mpjpe_sums"].cpu()


def tp_full(model) -> dict:
    """The model's whole state dict on the CPU: its shards gathered."""
    return {k: v.cpu().clone() for k, v in gathered_state_dict(model).items()}


def tp_step_ms(state, y1, y2, mesh=None) -> tuple[float, float]:
    """(ms a step by CUDA events, GiB of peak memory above the state)."""
    step = make_lifter_train_step("mse", mesh)
    if mesh is not None:
        y1, y2 = PM.shard_batch((y1, y2), mesh)
    return (cuda_ms(lambda: step(state, y1, y2), n=DP_TIMED),
            _peak_gib(lambda: step(state, y1, y2)))


def tp_one_rank_phase() -> dict:
    """(a) One ``nccl`` rank on a 1 x 1 mesh: ``shard_params`` over one model
    rank cuts nothing, and the f32 Martinez step at full width (B = TP_B,
    Adam, dropout 0.5) is bitwise the one-process step from a copy of the
    model, TP_STEPS steps. Returns the times."""
    import copy

    y1, y2 = tp_batch(torch.float32)
    with world_of_one() as mesh:
        one = tp_state(torch.float32)
        tp = create_train_state(shard_params(sync_batch_norm(copy.deepcopy(one.model), mesh),
                                             mesh), lr=TP_LR, optimizer="adam")
        m1, m2 = tp_steps(one, y1, y2), tp_steps(tp, y1, y2, mesh)
        bad = (_differ(one.model.state_dict(), tp.model.state_dict())
               + _differ(_grads(one.model), _grads(tp.model))
               + ([] if m1[0] == m2[0] and torch.equal(m1[1], m2[1]) else ["metrics"]))
        log(f"tp 1 nccl rank, 1 x 1 mesh, Martinez f32 B={TP_B} x {TP_STEPS} steps: losses "
            f"{m2[0]}; nothing sharded: {not tp_layout(tp.model)[1]}; bitwise the one-process "
            f"steps: {not bad}")
        if bad or tp_layout(tp.model)[1]:
            raise AssertionError(f"the 1 x 1 TP step differs from one process: {bad[:5]}")
        t = {"one": tp_step_ms(one, y1, y2), "tp": tp_step_ms(tp, y1, y2, mesh)}
    log(f"time tp 1 rank Martinez f32 step B={TP_B}: one process {t['one'][0]:.4f} ms, 1 x 1 "
        f"mesh {t['tp'][0]:.4f} ms; peak {t['one'][1]:.4f} / {t['tp'][1]:.4f} GiB above the state")
    return t


def tp_rank(world: int, out_dir: str) -> dict:
    """A rank of phase 29 (``gloo`` on cuda:0, ``run_ranks``). Two ranks: the 1 x 2
    Martinez steps in float64 (dropout 0.5) and f32 (dropout 0), their
    times and the gather's, then the 2 x 1 SMPL-IK step in float64. Four ranks: the 2 x 2
    float64 steps (dropout 0: each data rank draws its own masks), the f32
    step's time, then the checkpoint round trip in ``out_dir``. Returns
    the results."""
    result = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = PM.make_mesh(n_data=world // 2, n_model=2)
    for dtype in (torch.float64, torch.float32):
        # the masks of 1 x 2 are one process's; on the card they depend on
        # the dtype, so f32 is held to float64 without dropout
        dropout = 0.5 if world == 2 and dtype == torch.float64 else 0.0
        state = tp_state(dtype, mesh, dropout)
        y1, y2 = tp_batch(dtype)
        result[str(dtype)] = (*tp_steps(state, y1, y2, mesh), tp_full(state.model))
    result["ms"] = tp_step_ms(state, y1, y2, mesh)
    if world == 2:
        shard = torch.randn(TP_GATHER, device="cuda")
        result["gather_ms"] = cuda_ms(lambda: PM.gather_model(shard, -1, mesh))
        dp = PM.make_mesh(n_data=2, n_model=1)
        c = SMPL_CHECK
        state = _smpl_check_state("cuda", torch.float64)
        sync_batch_norm(state.model, dp)
        frames, uvd, xyz = smpl_dp_batch()
        cam = tuple(t.double() for t in smpl_cams(c["b"], "cuda"))
        frames, uvd, xyz, *cam = PM.shard_batch((frames, uvd, xyz, *cam), dp)
        m = make_hybrik_train_step(mesh=dp)(state, frames, tuple(cam), uvd, xyz, SEED)
        result["smpl"] = (m["loss"].item(), m["mpjpe_sums"].cpu(),
                          {k: v.cpu().clone() for k, v in state.model.net.state_dict().items()})
    else:
        state = tp_state(torch.float64, mesh, 0.0)
        y1, y2 = tp_batch(torch.float64)
        tp_steps(state, y1, y2, mesh, steps=1)
        path = ckpt.save(state, out_dir, "tp_run", batch_size=TP_B)
        restored, _ = ckpt.restore(tp_state(torch.float64, mesh, 0.0), out_dir, "tp_run")
        same = _same_bits
        opt = lambda s: [t for p in s.model.parameters()  # noqa: E731
                         for t in s.optimizer.state[p].values()]
        result["restored"] = (
            all(same(a, b) for a, b in zip(state.model.state_dict().values(),
                                           restored.model.state_dict().values()))
            and all(same(a, b) for a, b in zip(opt(state), opt(restored)))
            and restored.step == state.step
            and restored.plateau.state_dict() == state.plateau.state_dict())
        result["saved"] = tp_full(state.model)
        a, b = (tp_steps(s, y1, y2, mesh, steps=1) for s in (state, restored))
        result["resumed"] = (a[0] == b[0] and same(a[1], b[1])
                             and all(same(x, y) for x, y in
                                     zip(state.model.state_dict().values(),
                                         restored.model.state_dict().values()))
                             and all(same(x, y) for x, y in zip(opt(state), opt(restored))))
        result["path"] = path
        result["local"] = {k: v.cpu().clone() for k, v in state.model.state_dict().items()}
        result["coords"] = (PM.data_rank(mesh), PM.model_rank(mesh))
    return result


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, wherever each lies (a restored Adam step count lies
    on the model's device, a fresh one on the CPU)."""
    return a.shape == b.shape and torch.equal(a.detach().cpu().reshape(-1).view(torch.uint8),
                                              b.detach().cpu().reshape(-1).view(torch.uint8))


def smpl_dp_batch() -> tuple:
    """The SMPL_CHECK batch in float64 on the card: frames, uvd29, xyz17."""
    c = SMPL_CHECK
    rng = np.random.default_rng(SEED + 101)
    arrays = (rng.random((c["b"], c["size"], c["size"], 3)),
              rng.uniform(-0.4, 0.4, (c["b"], 29, 3)), rng.uniform(-0.3, 0.3, (c["b"], 17, 3)))
    return tuple(torch.from_numpy(a).to("cuda", torch.float64) for a in arrays)


def tp_phase() -> dict:
    """Phase 29: (a) one ``nccl`` rank, 1 x 1; (b) two ``gloo`` ranks on
    cuda:0, 1 x 2 Martinez (float64, f32) and 2 x 1 SMPL-IK; (c) four,
    2 x 2 Martinez in float64 and the checkpoint round trip, then
    ``dryrun_multichip(4, device="cuda")``. Returns the dry run's launches
    of the records' wrappers."""
    t0 = time.perf_counter()
    t = {"1x1": tp_one_rank_phase()}
    # the one-process references
    ref = {}
    for dtype in (torch.float64, torch.float32):
        y1, y2 = tp_batch(dtype)
        for dropout in (0.5, 0.0):
            state = tp_state(dtype, dropout=dropout)
            ref[(dtype, dropout)] = (*tp_steps(state, y1, y2), tp_full(state.model))
    t["one_f32"] = tp_step_ms(state, y1, y2)
    smpl = _smpl_check_state("cuda", torch.float64)
    frames, uvd, xyz = smpl_dp_batch()
    cam = tuple(c.double() for c in smpl_cams(SMPL_CHECK["b"], "cuda"))
    sm = make_hybrik_train_step()(smpl, frames, cam, uvd, xyz, SEED)
    smpl_ref = (sm["loss"].item(), sm["mpjpe_sums"].cpu(),
                {k: v.cpu().clone() for k, v in smpl.model.net.state_dict().items()})
    del smpl, state
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        two = run_ranks(tp_rank, 2, "cuda", 2, out, deadline=TP_DEADLINE_S)
    log(f"tp 2 ranks: ready and done in {time.perf_counter() - t1:.1f} s")
    for r in two:
        if _differ(r[str(torch.float64)][2], two[0][str(torch.float64)][2]):
            raise AssertionError("the 1 x 2 ranks' gathered states differ")
    hold_f64_state(f"tp 2 gloo ranks 1 x 2 Martinez float64 B={TP_B} x {TP_STEPS} steps, "
                   "dropout 0.5", two[0][str(torch.float64)], ref[(torch.float64, 0.5)],
                   TP_F64_ATOL)
    want = ref[(torch.float64, 0.0)]
    errs = {}
    for name, run in (("tp", two[0][str(torch.float32)]), ("one", ref[(torch.float32, 0.0)])):
        keys = [k for k, v in want[2].items() if v.is_floating_point()]
        errs[name] = (max(abs(a / b - 1) for a, b in zip(run[0], want[0])),
                      _rel(torch.cat([run[2][k].double().flatten() for k in keys]),
                           torch.cat([want[2][k].flatten() for k in keys])))
    log(f"tp 2 gloo ranks 1 x 2 Martinez f32, dropout 0, vs the float64 one-process steps: "
        f"loss rel {errs['tp'][0]:.3g} (one process f32 {errs['one'][0]:.3g}), state relative L2 "
        f"{errs['tp'][1]:.3g} (one process f32 {errs['one'][1]:.3g})")
    if any(errs["tp"][i] > TP_F32_RATIO * max(errs["one"][i], TP_F32_FLOOR) for i in (0, 1)):
        raise AssertionError("the 1 x 2 f32 step is less accurate than one process")
    hold_f64_state(f"tp 2 gloo ranks 2 x 1 SMPL-IK step float64 ({SMPL_CHECK['architecture']}, "
                   f"{SMPL_CHECK['size']}^2, B={SMPL_CHECK['b']})", two[0]["smpl"], smpl_ref,
                   BN_F64_ATOL)
    if _differ(two[1]["smpl"][2], two[0]["smpl"][2]):
        raise AssertionError("the 2 x 1 SMPL-IK ranks' states differ")

    with tempfile.TemporaryDirectory() as out:
        t1 = time.perf_counter()
        four = run_ranks(tp_rank, 4, "cuda", 4, out, deadline=TP_DEADLINE_S)
        log(f"tp 4 ranks: ready and done in {time.perf_counter() - t1:.1f} s")
        hold_f64_state(f"tp 4 gloo ranks 2 x 2 Martinez float64 B={TP_B} x {TP_STEPS} steps, "
                       "dropout 0", four[0][str(torch.float64)], ref[(torch.float64, 0.0)],
                       TP_F64_ATOL)
        for r in four:
            peer = next(q for q in four if q["coords"][1] == r["coords"][1])
            for k, v in r["local"].items():
                ref_v = (peer if v.shape != r["saved"][k].shape else four[0])["local"][k]
                if not torch.equal(v, ref_v):
                    raise AssertionError(f"rank {r['coords']}: {k} is not its peers'")
        payload = torch.load(four[0]["path"], map_location="cpu", weights_only=True)
        file_same = all(_same_bits(v, four[0]["saved"][k]) for k, v in payload["model"].items())
        one = tp_state(torch.float64, dropout=0.0)
        ckpt.restore(one, out, "tp_run")
        again_path = ckpt.save(one, Path(out) / "one", "tp_run", batch_size=TP_B)
        again = torch.load(again_path, map_location="cpu", weights_only=True)
        one_same = (all(_same_bits(v, again["model"][k]) for k, v in payload["model"].items())
                    and all(_same_bits(t, again["optimizer"]["state"][i][n])
                            for i, a in payload["optimizer"]["state"].items()
                            for n, t in a.items()))
    ok = all(r["restored"] and r["resumed"] for r in four)
    log(f"tp 4 gloo ranks 2 x 2 checkpoint: restored bitwise {all(r['restored'] for r in four)}, "
        f"resumed bitwise {all(r['resumed'] for r in four)}; the file's tensors are the "
        f"gathered state {file_same} and a one-process save of it {one_same}")
    if not (ok and file_same and one_same):
        raise AssertionError("the TP checkpoint round trip differs")
    t["1x2"] = [r["ms"] for r in two]
    t["2x2"] = [r["ms"] for r in four]
    log(f"time tp Martinez f32 step B={TP_B} (gloo ranks sharing one GPU, not a scaling "
        f"figure): one process {t['one_f32'][0]:.4f} ms, peak {t['one_f32'][1]:.4f} GiB; 1 x 2 "
        + " / ".join(f"{ms:.4f} ms" for ms, _ in t["1x2"]) + ", peak "
        + " / ".join(f"{g:.4f}" for _, g in t["1x2"]) + " GiB; 2 x 2 "
        + " / ".join(f"{ms:.4f} ms" for ms, _ in t["2x2"]) + ", peak "
        + " / ".join(f"{g:.4f}" for _, g in t["2x2"]) + " GiB (above the state, by rank); "
        f"gather_model of a {TP_GATHER} f32 shard over 2 gloo ranks "
        + " / ".join(f"{r['gather_ms']:.4f}" for r in two) + " ms")

    t1 = time.perf_counter()
    lines, launches = dryrun_multichip(4, device="cuda")
    made = {k.rsplit(".", 1)[1]: n for k, n in launches.items() if n}
    log(f"tp dryrun_multichip(4, device='cuda'): {len(lines)} stages in "
        f"{time.perf_counter() - t1:.1f} s; kernel launches over the 4 ranks {made}")
    want = [f.__name__ for f in (*TRAIN_WRAPPERS, CD.conv_soft_argmax_3d_fused,
                                 CD.conv_soft_argmax_3d_backward)]
    if len(lines) != 7 or any(made.get(k, 0) < 4 for k in want):
        raise AssertionError(f"the dry run's stages or launches are short: {made}")
    log(f"tp phase: {time.perf_counter() - t0:.1f} s")
    return made


# --- phase 30: the long-clip path ------------------------------------------------

LONG_T = 2048        # frames a clip on the long-clip path
LONG_CLIPS = 2       # clips a step: 34 sequences of 2048 frames in each temporal attention
LONG_CHECKS = ((CLIPS, 243), (LONG_CLIPS, LONG_T))  # (clips, frames) of the kernel checks
LONG_SEED = SEED + 110
LONG_HEADS = 8
FLASH_CHUNK = 8      # sequences a plain-version call in the checks (the float64 scores of
#                      34 sequences x 8 heads at L = 2048 would take 9 GB a tensor)
FLASH_NAMES = {"flash_fwd": FA.flash_forward, "flash_bwd_dkv": FA.flash_backward_dkv,
               "flash_bwd_dq": FA.flash_backward_dq}
DELTA_REL = 2 ** -18  # 14c's D against flash_delta: of the row's sum |dO O| (f32 sums in
#                       another order)
SFU_EXP_PER_CLOCK = 16 * 132  # exponentials a clock on the H100's SFUs: 16 an SM, 132 SMs
SP_SPEC = ("data", "model", None, None)
SP_DEADLINE_S = 300


def long_model(flash: bool, remat: bool = False, activation_spec=None) -> TemporalLifter:
    """The full-width TemporalLifter (hidden 256, 5 blocks, 8 heads) at
    clips of LONG_T frames with f32 master weights on the card, seeded;
    its steps run under bf16 autocast (``bf16_apply``)."""
    model = TemporalLifter(clip_len=LONG_T, flash=flash, remat=remat,
                           activation_spec=activation_spec, device="cpu")
    return model.init_weights(torch.Generator().manual_seed(LONG_SEED)).to("cuda")


def flash_tokens(model, n_clips: int, frames: int, seed: int):
    """Block 0's temporal qkv rows of seeded clips under bf16 autocast, (n_clips
    x 17, frames, 768) bf16, and a seeded output gradient (N(0, 1), bf16)."""
    y1, _ = synthetic_batch(n_clips, frames, seed)
    blk = model.blocks[0]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        x = model.embed(y1) + model.spatial_pe + model.temporal_pe[:, :frames]
        b, t, j, c = x.shape
        xs = x.reshape(b * t, j, c)
        xs = xs + blk.spatial_attn(blk.spatial_norm1(xs))
        xs = xs + blk.spatial_mlp(blk.spatial_norm2(xs))
        xt = xs.view(b, t, j, c).transpose(1, 2).reshape(b * j, t, c)
        qkv = blk.temporal_attn.qkv(blk.temporal_norm1(xt)).contiguous()
    dout = torch.randn(b * j, t, c, generator=torch.Generator().manual_seed(seed + 1))
    return qkv, dout.to("cuda", torch.bfloat16)


def flash_run(qkv, dout, kernel: bool, saved=None) -> tuple:
    """(O, lse, dQ, dK, dV, D) from the three kernels on every sequence,
    14c (dQ and D) before 14b, or from the plain versions FLASH_CHUNK
    sequences at a time. ``saved``: the kernels' (O, lse), which the plain
    backward then takes, so that each kernel meets its plain version on
    the same inputs; without it the plain backward takes the plain
    forward's (on float64 inputs: the float64 yardstick)."""
    if kernel:
        q, k, v = FA._views(qkv, None)
        o, lse = FA.flash_forward(q, k, v, LONG_HEADS)
        delta = torch.empty_like(lse)
        grads = FA._views(torch.empty_like(qkv), None)
        FA.flash_backward_dq(q, k, v, dout, o, lse, LONG_HEADS, grads[0], delta)
        FA.flash_backward_dkv(q, k, v, dout, lse, delta, LONG_HEADS, grads[1], grads[2])
        return (o, lse, *grads, delta)
    parts = []
    for i in range(0, qkv.shape[0], FLASH_CHUNK):
        q, k, v = FA._views(qkv[i:i + FLASH_CHUNK], None)
        d = dout[i:i + FLASH_CHUNK]
        o, lse = FA.flash_forward_reference(q, k, v, LONG_HEADS)
        bo, blse = (o, lse) if saved is None else (t[i:i + FLASH_CHUNK] for t in saved)
        delta = FA.flash_delta(d, bo, LONG_HEADS)
        parts.append((o, lse, *FA.flash_backward_reference(q, k, v, d, blse, delta, LONG_HEADS),
                      delta))
    return tuple(torch.cat(p) for p in zip(*parts))


def _flash_hold(what, got, want, ref64, atol, rtol) -> tuple[float, bool]:
    """Kernel vs plain within atol + rtol |want|; the kernel's error against
    float64 at most F32_ERR_RATIO x the plain version's + 2^-16 of the
    largest float64 value. Returns (the max abs difference from plain,
    whether both hold)."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    excess = (diff - (atol + rtol * want.abs())).max().item()
    err64, plain64 = ((t - ref64).abs().max().item() for t in (got, want))
    floor = 2 ** -16 * ref64.abs().max().item()
    log(f"kernel vs plain, {what}: max abs err {diff.max().item():.6g} (worst excess "
        f"{excess:.4g}, |want| max {want.abs().max().item():.4g}); vs float64: kernel "
        f"{err64:.6g}, plain {plain64:.6g}")
    ok = (bool(torch.isfinite(got).all()) and excess <= 0
          and err64 <= F32_ERR_RATIO * plain64 + floor)
    return diff.max().item(), ok


def flash_kernel_phase(model) -> dict:
    """Kernels 14a-14c against their plain versions on block 0's temporal qkv
    rows of seeded clips at (CLIPS, 243) and (LONG_CLIPS, LONG_T), the
    backward ones on the forward kernel's O and log-sum-exp: O within
    2^-6 + 2^-7 |want|, dQ, dK, dV within 2^-7 max|want| + 2^-7 |want|, the
    log-sum-exp within 2^-12 (1 + |want|), each against a float64 run of
    the plain version (``_flash_hold``); 14c's D within DELTA_REL of the
    row's Σ|dO ∘ O| of ``flash_delta`` on the kernel's O; two calls bitwise
    equal; every check logged before any failure raises. Returns each
    kernel's max abs error at the long shape."""
    errs, failed = {}, []
    for n_clips, frames in LONG_CHECKS:
        qkv, dout = flash_tokens(model, n_clips, frames, LONG_SEED + frames)
        got, again = flash_run(qkv, dout, True), flash_run(qkv, dout, True)
        torch.cuda.synchronize()
        what = f"L={frames} ({n_clips * 17} sequences x 8 heads x 32)"
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            failed.append(f"two calls at {what}")
        want = flash_run(qkv, dout, False, saved=got[:2])
        ref64 = flash_run(qkv.double(), dout.double(), False)
        held = {"flash_fwd": _flash_hold(f"flash_fwd O {what}", got[0], want[0], ref64[0],
                                         ATTN_ATOL, ATTN_RTOL)}
        lse = (got[1] - want[1]).abs()
        log(f"kernel vs plain, flash_fwd log-sum-exp {what}: max abs err {lse.max().item():.6g}")
        if (lse > 2 ** -12 * (1 + want[1].abs())).any():
            failed.append(f"flash_fwd log-sum-exp {what}")
        for n, a, w, r in zip(("dq", "dk", "dv"), got[2:5], want[2:5], ref64[2:5]):
            held[n] = _flash_hold(f"{n} {what}", a, w, r,
                                  GRAD_ATOL_REL * w.float().abs().max().item(), GRAD_RTOL)
        failed += [f"{n} {what}" for n, (_, ok) in held.items() if not ok]
        # D: 14c's against flash_delta on the kernel's O and the same dO
        scale = torch.cat([FA.flash_delta(dout[i:i + FLASH_CHUNK].abs(),
                                          got[0][i:i + FLASH_CHUNK].abs(), LONG_HEADS)
                           for i in range(0, dout.shape[0], FLASH_CHUNK)])
        dlt = (got[5] - want[5]).abs()
        log(f"kernel vs plain, flash_bwd_dq D {what}: max abs err {dlt.max().item():.6g}, worst "
            f"share of the row's sum |dO O| {(dlt / scale.clamp_min(1e-30)).max().item():.4g} "
            f"(limit {DELTA_REL:.4g})")
        if not bool(torch.isfinite(got[5]).all()) or (dlt > DELTA_REL * scale).any():
            failed.append(f"flash_bwd_dq D {what}")
        errs = {"flash_fwd": held["flash_fwd"][0], "flash_bwd_dq": held["dq"][0],
                "flash_bwd_dkv": max(held["dk"][0], held["dv"][0])}
        del got, again, want, ref64
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash kernels disagree with their plain versions: {failed}")
    return errs


def flash_timing_phase(model) -> dict:
    """ms of each kernel (14c with D inside), its plain version (D's,
    ``flash_delta``, apart) and PyTorch's ``scaled_dot_product_attention``
    (a yardstick only; the port never calls it) on block 0's temporal qkv
    at (LONG_CLIPS, LONG_T): the forward, the backward alone (dQ, dK and
    dV together) and both."""
    qkv, dout = flash_tokens(model, LONG_CLIPS, LONG_T, LONG_SEED + 7)
    q, k, v = FA._views(qkv, None)
    o, lse = FA.flash_forward(q, k, v, LONG_HEADS)
    delta = torch.empty_like(lse)
    g = FA._views(torch.empty_like(qkv), None)
    t = {"flash_fwd": cuda_ms(lambda: FA.flash_forward(q, k, v, LONG_HEADS)),
         "flash_bwd_dq": cuda_ms(lambda: FA.flash_backward_dq(q, k, v, dout, o, lse, LONG_HEADS,
                                                              g[0], delta)),
         "flash_bwd_dkv": cuda_ms(lambda: FA.flash_backward_dkv(q, k, v, dout, lse, delta,
                                                                LONG_HEADS, g[1], g[2])),
         "delta": cuda_ms(lambda: FA.flash_delta(dout, o, LONG_HEADS))}
    t["flash_fwd_plain"] = cuda_ms(lambda: FA.flash_forward_reference(q, k, v, LONG_HEADS), n=3)
    t["flash_bwd_plain"] = cuda_ms(lambda: FA.flash_backward_reference(
        q, k, v, dout, lse, delta, LONG_HEADS), n=3)
    n, length = qkv.shape[:2]
    heads = [x.view(n, length, LONG_HEADS, -1).transpose(1, 2).detach().requires_grad_(True)
             for x in (q, k, v)]
    g4 = dout.view(n, length, LONG_HEADS, -1).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t["sdpa_fwd"] = cuda_ms(lambda: sdpa(*heads))
    out = sdpa(*heads)
    t["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(out, heads, g4, retain_graph=True))
    t["sdpa_fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad(sdpa(*heads), heads, g4))
    log(f"time flash attention {n} sequences x {length} frames x 8 heads x 32 (bf16): forward "
        f"{t['flash_fwd']:.4f} ms (plain {t['flash_fwd_plain']:.4f}, SDPA {t['sdpa_fwd']:.4f}); "
        f"dK/dV {t['flash_bwd_dkv']:.4f} ms, dQ with D inside {t['flash_bwd_dq']:.4f} ms "
        f"(together {t['flash_bwd_dkv'] + t['flash_bwd_dq']:.4f}), D = "
        f"rowsum(dO O) plain {t['delta']:.4f} ms (plain backward {t['flash_bwd_plain']:.4f}, "
        f"SDPA backward {t['sdpa_bwd']:.4f}, SDPA forward + backward {t['sdpa_fwd_bwd']:.4f})")
    return t


def long_step_check(y1, y2) -> None:
    """The full-width model at LONG_T frames under bf16 autocast, flash
    against eager attention from the same weights: the forward within
    KERNEL_ATOL, each against the f32 module (logged); one step's loss
    within rtol 1e-2 and each parameter's gradient within STEP_GRAD_REL in
    relative L2 (P and dS rounded to bf16 in the kernels, the scores to bf16
    in the eager module under autocast)."""
    flash, eager = long_model(True), long_model(False)
    with torch.no_grad():
        pf, pe = bf16_apply(flash, y1), bf16_apply(eager, y1)
        p32 = eager(y1)
    err = (pf - pe).abs().max().item()
    log(f"long forward {LONG_CLIPS} x {LONG_T} bf16: flash vs eager max abs {err:.6g}; vs the "
        f"f32 module: flash {(pf - p32).abs().max().item():.6g}, eager "
        f"{(pe - p32).abs().max().item():.6g}")
    if not torch.isfinite(pf).all() or err > KERNEL_ATOL:
        raise AssertionError("the flash forward disagrees with the eager module")
    del p32
    lf, gf = _loss_and_grads(flash, bf16_apply, y1, y2)
    le, ge = _loss_and_grads(eager, bf16_apply, y1, y2)
    rel = {n: _rel(gf[n].float(), ge[n].float()) for n in ge}
    worst = max(rel, key=rel.get)
    log(f"long step {LONG_CLIPS} x {LONG_T}: loss flash {lf:.8g}, eager {le:.8g}; grads "
        f"flash vs eager: worst relative L2 {rel[worst]:.4g} ({worst}), median "
        f"{statistics.median(rel.values()):.4g}")
    if not math.isfinite(lf) or abs(lf - le) > 1e-2 * abs(le) or rel[worst] > STEP_GRAD_REL:
        raise AssertionError("the flash step disagrees with the eager module's")


def long_train_phase(y1, y2) -> dict:
    """The main path: TRAIN_STEPS AdamW steps (lr 1e-3) of
    ``TemporalLifter(flash=True, remat=True)`` through
    ``make_lifter_train_step("mse")`` under bf16 autocast on LONG_CLIPS
    clips of LONG_T frames, the counts set to 0 just before: each step
    launches 14a ten times (5 blocks, each recomputed in the backward) and
    14b and 14c five times; a finite loss whose last three steps' mean is
    below the first. Returns the launches."""
    state = create_train_state(long_model(True, remat=True), lr=TRAIN_LR, apply=bf16_apply)
    step = make_lifter_train_step("mse")
    _reset(FLASH_NAMES.values())
    losses = [step(state, y1, y2)["loss"].item() for _ in range(TRAIN_STEPS)]
    launches = {k: f.launches for k, f in FLASH_NAMES.items()}
    log(f"long train flash + remat {LONG_CLIPS} x {LONG_T}, {TRAIN_STEPS} AdamW steps: losses "
        + " ".join(f"{x:.5g}" for x in losses) + f"; launches {launches}")
    blocks = state.model.n_blocks
    want = {"flash_fwd": 2 * blocks * TRAIN_STEPS, "flash_bwd_dkv": blocks * TRAIN_STEPS,
            "flash_bwd_dq": blocks * TRAIN_STEPS}
    if (not all(math.isfinite(x) for x in losses) or statistics.mean(losses[-3:]) >= losses[0]
            or launches != want):
        raise AssertionError("the long-clip training run did not fall or launched short")
    return launches


def long_memory_phase(y1, y2) -> dict:
    """ms a step (CUDA events, 3 runs of 3) and peak memory above the state
    of one step, for eager attention, flash, and flash + remat."""
    t = {}
    for name, flash, remat in (("eager", False, False), ("flash", True, False),
                               ("flash_remat", True, True)):
        state = create_train_state(long_model(flash, remat), lr=TRAIN_LR, apply=bf16_apply)
        step = make_lifter_train_step("mse")
        gib = _peak_gib(lambda: step(state, y1, y2))
        t[name] = (cuda_ms(lambda: step(state, y1, y2), n=3), gib)
        del state, step
        torch.cuda.empty_cache()
    log(f"time long step {LONG_CLIPS} x {LONG_T} frames (bf16 autocast, AdamW): "
        + ", ".join(f"{k} {ms:.4f} ms ({LONG_CLIPS * LONG_T / ms * 1e3:.1f} frames/s), peak "
                    f"{g:.3f} GiB above the state" for k, (ms, g) in t.items()))
    return t


def long_sp_rank() -> dict:
    """A rank of the 1 x 2 sequence-parallel check (``gloo`` on cuda:0): one
    step of the flash model with its frames split over the model axis, on
    the whole batch. Returns the loss, the gradients and the launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = PM.make_mesh(n_data=1, n_model=2)
    model = sequence_parallel(long_model(True, activation_spec=SP_SPEC), mesh)
    y1, y2 = synthetic_batch(LONG_CLIPS, LONG_T, LONG_SEED + 2)
    state = create_train_state(model, lr=TRAIN_LR, apply=bf16_apply)
    _reset(FLASH_NAMES.values())
    m = make_lifter_train_step("mse", mesh)(state, y1, y2)
    return {"loss": m["loss"].item(), "grads": {k: v.cpu() for k, v in _grads(model).items()},
            "launches": {k: f.launches for k, f in FLASH_NAMES.items()}}


def long_sp_phase(y1, y2) -> None:
    """Two ``gloo`` ranks on cuda:0 as a 1 x 2 mesh, each with half of every
    clip's frames, flash on (local queries over gathered K and V, Lq != Lk),
    against the one-process flash step on the same batch: loss rtol 1e-2,
    each gradient relative L2 <= STEP_GRAD_REL; the ranks' gradients
    bitwise equal."""
    model = long_model(True)
    state = create_train_state(model, lr=TRAIN_LR, apply=bf16_apply)
    loss = make_lifter_train_step("mse")(state, y1, y2)["loss"].item()
    want = {k: v.cpu() for k, v in _grads(model).items()}
    blocks = model.n_blocks
    del model, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks(long_sp_rank, 2, "cuda", deadline=SP_DEADLINE_S)
    rel = {n: _rel(res[0]["grads"][n].float(), want[n].float()) for n in want}
    worst = max(rel, key=rel.get)
    err = abs(res[0]["loss"] - loss) / abs(loss)
    log(f"long sp 1 x 2 gloo ranks on one GPU, flash, {LONG_T // 2} frames a rank: loss "
        f"{res[0]['loss']:.8g} vs one process {loss:.8g} (rel {err:.3g}); grads worst relative "
        f"L2 {rel[worst]:.4g} ({worst}); launches {res[0]['launches']} a rank; "
        f"{time.perf_counter() - t0:.1f} s")
    if (err > 1e-2 or rel[worst] > STEP_GRAD_REL or _differ(res[0]["grads"], res[1]["grads"])
            or any(r["launches"] != dict.fromkeys(FLASH_NAMES, blocks) for r in res)):
        raise AssertionError("the sequence-parallel flash step disagrees with one process")


def long_phase() -> tuple[dict, dict, dict, float]:
    """Phase 30: the long-clip path. Returns (each flash kernel's max abs
    error, the times, the main path's launches, the SM clock in Hz)."""
    t0 = time.perf_counter()
    clock = max_sm_clock()
    model = long_model(True)
    errs = flash_kernel_phase(model)
    times = flash_timing_phase(model)
    del model
    torch.cuda.empty_cache()
    y1, y2 = synthetic_batch(LONG_CLIPS, LONG_T, LONG_SEED + 2)
    long_step_check(y1, y2)
    launches = long_train_phase(y1, y2)
    times.update(long_memory_phase(y1, y2))
    long_sp_phase(y1, y2)
    log(f"long phase: {time.perf_counter() - t0:.1f} s, SM clock {clock / 1e6:.0f} MHz")
    return errs, times, launches, clock


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    """(least ms the H100 could take, what bounds it)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bounds(n_seq: int, length: int, dh: int, clock: float) -> dict:
    """Kernels 14a-14c's bounds at n_seq sequences x LONG_HEADS heads of
    ``length`` frames: the larger of their products' flops over the bf16
    peak, their exponentials (one a score, recomputed in each backward
    kernel) over the SFUs' SFU_EXP_PER_CLOCK a clock at ``clock`` Hz, and
    their bytes (q, k, v and dO bf16, the log-sum-exp and D f32, each read
    once; O, dQ, dK, dV written once; 14c also reads O and writes D) over
    the HBM rate."""
    scores = n_seq * LONG_HEADS * length * length
    product = 2 * scores * dh  # flops of one (L x L x dh) product
    t_exp = scores / (SFU_EXP_PER_CLOCK * clock) * 1e3
    rows = n_seq * length * LONG_HEADS * dh * 2  # one (N, L, dim) bf16 tensor
    stat = n_seq * LONG_HEADS * length * 4
    out = {}
    for name, products, nbytes in (("flash_fwd", 2, 4 * rows + stat),  # S, PV
                                   ("flash_bwd_dkv", 4, 6 * rows + 2 * stat),  # S, dV, dP, dK
                                   ("flash_bwd_dq", 3, 6 * rows + 2 * stat)):  # S, dP, dQ
        ms, by = bound(products * product, nbytes)
        out[name] = (t_exp, "operations") if t_exp > ms else (ms, by)
    return out


def kernel_bounds(model_vit, model_t, model_m, model_d, long_clock: float) -> dict:
    """Each kernel's bound at the shapes it is timed at: its matrix-product
    flops, and its bytes with each input read once and each output written
    once (weights included); rows 3 and 4 and the flash kernels (at the
    long-clip path's shape, ``flash_bounds``) with their exponentials too."""
    b2 = 2  # bytes of a bf16 element
    d = 256
    dense = 2 * d * (3 * d + d + 4 * d + 4 * d)  # qkv, proj, W1, W2 flops per row
    rows_vit = TOP * 17
    trunk = bound(
        model_vit.n_blocks * (rows_vit * dense + TOP * 4 * 17 * 17 * 64 * 4),
        2 * rows_vit * d * b2 + 17 * d * b2 + model_vit.n_blocks * L.BLOCK_ELEMS * b2)
    t = model_t.clip_len
    rows = CLIPS * t * 17
    att_spatial = CLIPS * t * 8 * 17 * 17 * 32 * 4  # QK^T and PV per (frame, head)
    att_temporal = CLIPS * 17 * 8 * t * t * 32 * 4
    spatial = bound(rows * dense + att_spatial, 2 * rows * d * b2 + S.BLOCK_ELEMS * b2)
    temporal = bound(rows * dense + att_temporal, 2 * rows * d * b2 + S.BLOCK_ELEMS * b2)
    # rows 3 and 4 also take one exponential a score (L^2 a head) on the
    # SFUs, SFU_EXP_PER_CLOCK a clock at ``long_clock`` Hz (flash_bounds)
    def with_exps(b, scores):
        t_exp = scores / (SFU_EXP_PER_CLOCK * long_clock) * 1e3
        return (t_exp, "operations") if t_exp > b[0] else b

    packed = with_exps(bound(att_spatial, rows * 4 * d * b2), CLIPS * t * 8 * 17 * 17)
    seq = with_exps(bound(att_temporal, rows * 4 * d * b2), CLIPS * 17 * 8 * t * t)
    f = model_m.hidden
    martinez = bound(4 * TOP * f * f,  # two (TOP, f) x (f, f) products
                     2 * TOP * f * b2 + 2 * f * f * b2 + 4 * f * 4)  # x, out; W1, W2; s, b
    # training, at TRAIN_CLIPS (= CLIPS) clips: the forwards also write x1
    # and att; the backwards read x, x1, att, dout and the weights, write dx
    # and the f32 weight gradients, and do the recomputed qkv and fc1
    # products, twice the forward's four products (the W^T products and the
    # weight gradients) and 2.5x its attention products (scores recomputed,
    # dA, dV, dQ, dK)
    recompute = 2 * d * (3 * d + 4 * d)
    fwd_bytes = 4 * rows * d * b2 + S.BLOCK_ELEMS * b2
    bwd_bytes = 5 * rows * d * b2 + S.BLOCK_ELEMS * (b2 + 4)
    # the direct decodes at B = DIRECT_B on the model's 64 x 64 head output:
    # the soft-argmax reads the bf16 logits and does no matrix product (an
    # exp, a subtract and four multiply-adds a logit, f32); the conv decode
    # reads the features, the weight and the bias and does the 1x1 conv's
    # product; both write (B, J, 3) f32
    pix = DIRECT_B * (DIRECT_SIZE // 4) ** 2
    jd = model_d.num_joints * model_d.depth
    out_bytes = DIRECT_B * model_d.num_joints * 3 * 4
    soft = bound(6 * pix * jd, pix * jd * b2 + out_bytes, PEAK_F32)
    decode = bound(2 * pix * 256 * jd, pix * 256 * b2 + jd * 256 * b2 + jd * 4 + out_bytes)
    # the backwards read g, E and the statistics (8 f32 a joint) besides:
    # the soft-argmax's reads the logits and writes dx (a subtract, an
    # exp, two multiplies and five multiply-adds a logit, f32); the conv
    # decode's reads the features, the weight and the bias, writes dfeats,
    # dW (bf16) and db (f32), and does three products of the forward's
    # size (the recompute, dfeats and dW)
    coef_bytes = DIRECT_B * model_d.num_joints * 8 * 4
    soft_bwd = bound(9 * pix * jd, 2 * pix * jd * b2 + coef_bytes, PEAK_F32)
    decode_bwd = bound(3 * 2 * pix * 256 * jd, 2 * pix * 256 * b2 + 2 * (jd * 256 * b2 + jd * 4)
                       + coef_bytes)
    # rows 7, 10a and 10b do the work of the slab kernels on the same token
    # count; row 12 that of the NHWC soft-argmax on the same logits
    return {"soft_argmax_nhwc": soft, "conv_decode": decode, "soft_argmax_volume": soft,
            "temporal_block_fused": temporal,
            "sequences_fwd": bound(rows * dense + att_temporal, fwd_bytes),
            "sequences_bwd": bound(rows * (recompute + 2 * dense) + 2.5 * att_temporal,
                                   bwd_bytes),
            "soft_argmax_nhwc_bwd": soft_bwd, "conv_decode_bwd": decode_bwd,
            "lifter_trunk": trunk, "spatial_block": spatial, "temporal_slab": temporal,
            "packed_flat_attention": packed, "attention_wg_kernel": seq,
            "martinez_block": martinez,
            "spatial_fwd": bound(rows * dense + att_spatial, fwd_bytes),
            "slab_fwd": bound(rows * dense + att_temporal, fwd_bytes),
            "spatial_bwd": bound(rows * (recompute + 2 * dense) + 2.5 * att_spatial, bwd_bytes),
            "slab_bwd": bound(rows * (recompute + 2 * dense) + 2.5 * att_temporal, bwd_bytes),
            **flash_bounds(LONG_CLIPS * 17, LONG_T, d // LONG_HEADS, long_clock)}


def main() -> None:
    name = device_phase()
    build_phase()
    with torch.inference_mode():
        model = seeded_model("cuda", torch.bfloat16)
        model_f32 = seeded_model("cuda", torch.float32)
        err = kernel_phase(model)
        trunk_launch_phase(model)
        svc, launches = serving_phase(model, model_f32)
        t = timing_phase(model, svc)
        t["trunk_matmuls"] = trunk_split_phase(model)

        tmodel = seeded_temporal("cuda", torch.bfloat16)
        errs = {**sub_block_phase(tmodel), **attention_phase(tmodel)}
        tlaunches = lift_phase(tmodel, seeded_temporal("cuda", torch.float32))
        for k, n in dstformer_phase().items():
            tlaunches[k] += n
        tt = temporal_timing_phase(tmodel)

        mmodel = seeded_martinez("cuda", torch.bfloat16)
        merr = martinez_kernel_phase(mmodel)
        msvc, mlaunches = martinez_serving_phase(mmodel, seeded_martinez("cuda", torch.float32))
        mt = martinez_timing_phase(mmodel, msvc)

        dmodel = seeded_posenet("cuda", torch.bfloat16)
        derrs = direct_kernel_phase(dmodel)
        dlaunches = direct_forward_phase(dmodel, seeded_posenet("cuda", torch.float32))
        dt = direct_timing_phase(dmodel)
        derrs.update(direct_backward_phase(dmodel))
        dt.update(direct_backward_timing_phase(dmodel))
    decode_forward_split_phase(dmodel)
    decode_backward_split_phase(dmodel)

    train_model = seeded_train_model()
    errs.update(train_kernel_phase(train_model))
    train_step_phase(train_model)
    trlaunches, trt = train_loop_phase(train_model)
    backward_split_phase(train_model)
    forward_split_phase(train_model)
    del train_model
    torch.cuda.empty_cache()
    dtrlaunches, _ = direct_train_phase()
    direct_cli_phase()

    jlaunches = joint_major_main_path(tmodel, seeded_train_model(), dmodel)
    with torch.inference_mode():
        errs.update(joint_major_phase(tmodel))
    lerrs, lt = legacy_softargmax_phase(dmodel)
    errs.update(lerrs)
    with torch.inference_mode():
        jt = joint_major_timing_phase(tmodel, dmodel)
    log(f"time legacy soft-argmax backward (the XLA formula in PyTorch ops) B={DIRECT_B}: "
        f"{lt['soft_argmax_volume_bwd']:.4f} ms")
    lift_cli_phase()
    # rows 3-6: the launches of phase 25's two lifts add to phase 8's
    for k, n in video_phase().items():
        tlaunches[k] += n
    loop_phase()
    smpl_phase()
    # phase 28: the data-parallel runs of rows 1, 8a-9b, 13a and 13b
    plaunches = dp_phase()
    launches += plaunches["trunk"]
    for f in TRAIN_WRAPPERS:
        trlaunches[f.__name__] += plaunches[f.__name__]
    for k in ("conv_soft_argmax_3d_fused", "conv_soft_argmax_3d_backward"):
        dtrlaunches[k] += plaunches[k]
    # phase 29: tensor parallelism; its dry run's stages 6-7 launch rows 8a-9b, 13a and 13b
    for k, n in tp_phase().items():
        for counts in (trlaunches, dtrlaunches):
            if k in counts:
                counts[k] += n
    # phase 30: the long-clip path (rows 14a-14c)
    ferrs, ft, flaunches, clock = long_phase()
    bounds = kernel_bounds(model, tmodel, mmodel, dmodel, clock)

    def record(kname, source, replaces, n_launches, max_err, ms, plain_ms, library_ms):
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": max_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bounds[kname][0],
                "bound_by": bounds[kname][1], "library_ms": library_ms}

    csrc = "pose3d_tpu_torch/csrc"
    kernels = [
        record("lifter_trunk", f"{csrc}/lifter_trunk.cu", "pose3d_tpu/ops/pallas_lifter.py:166",
               launches, err, t["kernel_trunk"], t["plain_trunk"], None),
        record("spatial_block", f"{csrc}/stblock.cu", "pose3d_tpu/ops/pallas_stblock.py:90",
               tlaunches["spatial_block"], errs["spatial_block"], tt["spatial_block"],
               tt["spatial_block_plain"], None),
        record("temporal_slab", f"{csrc}/stblock.cu", "pose3d_tpu/ops/pallas_stblock.py:144",
               tlaunches["temporal_slab"], errs["temporal_slab"], tt["temporal_slab"],
               tt["temporal_slab_plain"], None),
        record("packed_flat_attention", f"{csrc}/attention.cu",
               "pose3d_tpu/ops/pallas_attention.py:393", tlaunches["packed_flat_attention"],
               errs["packed_flat_attention"], tt["packed_flat_attention"],
               tt["packed_flat_attention_plain"], tt["packed_flat_attention_sdpa"]),
        # seq_attention's L = 243 launches, all on the kernel for L > A.SPLIT_LEN
        record("attention_wg_kernel", f"{csrc}/attention.cu",
               "pose3d_tpu/ops/pallas_attention.py:447", tlaunches["seq_attention"],
               errs["seq_attention"], tt["seq_attention"], tt["seq_attention_plain"],
               tt["seq_attention_sdpa"]),
        # no one PyTorch call computes the block; its two GEMMs alone are
        # logged above as martinez_two_matmuls, a yardstick only
        record("martinez_block", f"{csrc}/martinez.cu", "pose3d_tpu/ops/pallas_martinez.py:34",
               mlaunches, merr, mt["martinez_block"], mt["martinez_block_plain"], None),
    ]
    # no one PyTorch call computes a sub-block's forward or backward; the
    # eager bf16 module's forward + backward is logged above as a yardstick
    train_rows = (("spatial_fwd", "stblock.cu", ":348"), ("spatial_bwd", "stblock_train.cu", ":359"),
                  ("slab_fwd", "stblock.cu", ":407"), ("slab_bwd", "stblock_train.cu", ":424"))
    kernels += [record(k, f"{csrc}/{src}", f"pose3d_tpu/ops/pallas_stblock_train.py{line}",
                       trlaunches[k], errs[k], trt[k], trt[f"{k}_plain"], None)
                for k, src, line in train_rows]
    # the forwards' launches: the route's forward and eval chunk step
    # (phase 16) and the TRAIN_STEPS train steps of the route (phase 19)
    fwd_launches = {k: dlaunches[k] + dtrlaunches[k]
                    for k in ("soft_argmax_3d_nhwc_kernel", "conv_soft_argmax_3d_fused")}
    kernels += [
        # no one PyTorch call computes the soft-argmax
        record("soft_argmax_nhwc", f"{csrc}/softargmax.cu",
               "pose3d_tpu/ops/pallas_softargmax.py:138",
               fwd_launches["soft_argmax_3d_nhwc_kernel"], derrs["soft_argmax_nhwc"],
               dt["soft_argmax_nhwc"], dt["soft_argmax_nhwc_plain"], None),
        # the 1x1 conv alone as one bf16 torch.matmul: a yardstick only
        record("conv_decode", f"{csrc}/conv_decode.cu", "pose3d_tpu/ops/pallas_conv_decode.py:98",
               fwd_launches["conv_soft_argmax_3d_fused"], derrs["conv_decode"],
               dt["conv_decode"], dt["conv_decode_plain"], dt["conv_decode_matmul"]),
        # the backwards: launches in the TRAIN_STEPS steps of their routes;
        # no one PyTorch call computes either (the conv decode's three
        # products as torch.matmul are logged above, a yardstick only)
        record("soft_argmax_nhwc_bwd", f"{csrc}/softargmax.cu",
               "pose3d_tpu/ops/pallas_softargmax.py:164",
               dtrlaunches["soft_argmax_3d_nhwc_backward"], derrs["soft_argmax_nhwc_bwd"],
               dt["soft_argmax_nhwc_bwd"], dt["soft_argmax_nhwc_bwd_plain"], None),
        record("conv_decode_bwd", f"{csrc}/conv_decode_bwd.cu",
               "pose3d_tpu/ops/pallas_conv_decode.py:124",
               dtrlaunches["conv_soft_argmax_3d_backward"], derrs["conv_decode_bwd"],
               dt["conv_decode_bwd"], dt["conv_decode_bwd_plain"], None),
    ]
    # rows 7, 10 and 12: launches on this slice's main path (phase 21); no
    # one PyTorch call computes a sub-block or a soft-argmax
    jm_rows = (("temporal_block_fused", "stblock.cu", "pallas_stblock.py:137"),
               ("sequences_fwd", "stblock.cu", "pallas_stblock_train.py:379"),
               ("sequences_bwd", "stblock_train.cu", "pallas_stblock_train.py:388"))
    kernels += [record(k, f"{csrc}/{src}", f"pose3d_tpu/ops/{line}", jlaunches[k], errs[k],
                       jt[k], jt[f"{k}_plain"], None) for k, src, line in jm_rows]
    kernels.append(record("soft_argmax_volume", f"{csrc}/softargmax.cu",
                          "pose3d_tpu/ops/pallas_softargmax.py:36",
                          jlaunches["soft_argmax_3d_pallas"], errs["soft_argmax_volume"],
                          jt["soft_argmax_volume"], jt["soft_argmax_volume_plain"], None))
    # rows 14a-14c: the plain backward computes dQ, dK and dV at once, and so
    # does SDPA's backward, timed alone on its saved forward (a yardstick only)
    flash_src = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    kernels += [record(k, f"{csrc}/flash_attention.cu", f"{flash_src}:{line}", flaunches[k],
                       ferrs[k], ft[k], ft[plain], ft[lib])
                for k, line, plain, lib in (
                    ("flash_fwd", 758, "flash_fwd_plain", "sdpa_fwd"),
                    ("flash_bwd_dkv", 1121, "flash_bwd_plain", "sdpa_bwd"),
                    ("flash_bwd_dq", 1456, "flash_bwd_plain", "sdpa_bwd"))]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--forward-split"]:  # the forward splits alone
        device_phase()
        build_phase()
        forward_split_phase(seeded_train_model())
        with torch.inference_mode():
            trunk_split_phase(seeded_model("cuda", torch.bfloat16))
    elif sys.argv[1:] == ["--train"]:  # the temporal training phases alone
        device_phase()
        build_phase()
        train_model = seeded_train_model()
        train_kernel_phase(train_model)
        train_step_phase(train_model)
        train_loop_phase(train_model)
        backward_split_phase(train_model)
    elif sys.argv[1:] == ["--decode-backward-split"]:  # kernel 13b's launch split alone
        device_phase()
        build_phase()
        decode_backward_split_phase(seeded_posenet("cuda", torch.bfloat16))
    elif sys.argv[1:] == ["--decode-forward-split"]:  # kernels 11a's and 13a's launches alone
        device_phase()
        build_phase()
        decode_forward_split_phase(seeded_posenet("cuda", torch.bfloat16))
    elif sys.argv[1:] == ["--lift-cli"]:  # the phase-1 path alone
        device_phase()
        build_phase()
        lift_cli_phase()
    elif sys.argv[1:] == ["--video"]:  # the video path alone
        device_phase()
        build_phase()
        video_phase()
    elif sys.argv[1:] == ["--loop"]:  # the detector, projector and loop trainers alone
        device_phase()
        build_phase()
        loop_phase()
    elif sys.argv[1:] == ["--smpl"]:  # SMPL, HybrIK and the SMPL-IK model alone
        device_phase()
        build_phase()
        smpl_phase()
    elif sys.argv[1:] == ["--dp"]:  # the data-parallel layer alone
        device_phase()
        build_phase()
        dp_phase()
    elif sys.argv[1:] == ["--tp"]:  # tensor parallelism, its checkpoint and the dry run alone
        device_phase()
        build_phase()
        tp_phase()
    elif sys.argv[1:] == ["--long"]:  # the long-clip path alone
        device_phase()
        build_phase()
        long_phase()
    elif sys.argv[1:] == ["--martinez-split"]:  # the block kernel's two launches alone
        device_phase()
        build_phase()
        with torch.inference_mode():
            martinez_split_phase(seeded_martinez("cuda", torch.bfloat16))
    else:
        main()
