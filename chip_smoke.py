#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``brushstroke_engine_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. The card: needs CUDA; prints ``nvidia-smi``'s name and power limit.
2. Builds every hand-written kernel from ``brushstroke_engine_torch/csrc``.
3. Kernel vs plain version on the card: the FIR-epilogue kernel at the six
   ``conv0`` shapes of the 256-px flagship at B=16, f32 and bf16, without
   noise, with per-sample noise and with one noise plane for the batch, with
   and without clamp, against ``fir4_epilogue_plain``; then the
   kernel's, the plain version's and a library yardstick's times beside the
   memory bound.  Then shapes off the kernel's vector path (a channel count
   that is no multiple of the 16-byte vector, H != W, ragged strips, W
   narrower than a thread's column walk), every tile forced as well as the
   kernel's own choice; then the paint and serving paths' batches (B = 1
   to 8 and 32 at the same six shapes, f32); then the trainer's shapes
   (B = 64, f32), checked and timed; then the CLI training run's bf16 rows
   (``--num_bf16_res 4``: 16-128 px, C = 128, noise and clamp) at every
   batch phase 10 launches them at (B = 64, 32 and 1-8), checked, the
   B = 64 rows timed; then phase 11's StyleGAN2 config-f rows (B = 2, f32,
   8-1024 px, C = 512 down to 32, one noise plane, no clamp), checked and
   timed.
4. The FIR-epilogue kernel's backward: gradients of x, dcoefs, noise and
   bias through the kernel path against autograd through the plain version
   at the 64-px and 128-px training shapes, and one double backward; then
   bf16 at the 64- and 128-px training shapes (B = 64, C = 128).
5. The ADA two-pass warp kernels W and W^T against their plain versions:
   the five transform classes and 64 matrices of the ADA pipe at p = 1, at
   [64,128,128,3], [8,64,64,3] and the batches phase 12's Gstitch launches
   them at ([128,128,128,3], [16,128,128,3]), antialias on and off, values,
   two calls
   bit-equal, the second-order (R1) pattern and the adjoint identity, with
   times.  Then both under stress: pass slopes of 0 and near 0, a quarter
   turn, a translation, flips, a strong zoom-out and zoom-in, a
   near-singular shear, at N = 67 (C = 5; no multiple of W's column band),
   N = 128 and N = 33 (C = 11: two channel chunks).  Prints the column band
   W picks at each shape.
6. The render path: the 256-px flagship (random weights from a seed, through
   ``init_native_params`` -> ``params_from_jax``) renders through
   ``TriadGanPaintEngine.render_stroke`` (z style, canvas position, UVS
   mapping, clear and full modes, color override) and ``render_batch``
   (B=16, strict f32 and bf16 blocks); checks shapes, finiteness, range and
   the kernel's launch count, and the f32 render against the same request
   rendered on the CPU.
7. The training path: the canonical 128-px / batch-64 configuration
   (``flagship_train_config``) takes 33 batches through ``TrainingLoop``
   with every phase (Dmain, Dr1, Gmain, Gpl, Ggeom, the ADA p update), then
   2 warm-start batches of a second loop; checks finite stats, moved
   parameters, the three kernels' launch counts against the schedule, and a
   non-zero gradient at every ``conv0``; then the first Dmain, Dr1, Gmain
   and Gpl batch at B = 8 with identical draws on the card and on the CPU.
8. The paint path: the same flagship (strict f32) paints a 1024 x 1024 canvas
   through ``PaintingHelper`` with feature blending at level 2 (12
   overlapping full strokes and 4 partial patches, crop margin 10, then 30
   timed strokes), through ``DevicePaintSession`` (30 timed strokes after
   warm-up, the canvas on the card throughout), stylizes a 2048 x 2048
   synthetic line drawing (81 tiles) with each of the three stylizers, and
   renders ``CanvasPaintEngine`` (the flagship with the canvas head) in its
   four modes and one blended stroke; checks shapes, metadata, the mask's
   growth, finiteness and K1's launches (6 per generator pass); then the
   same requests at a smaller size on the card and on the CPU: strokes on a
   512 x 512 canvas, each stylizer on a 472 x 472 drawing (4 tiles; the
   card at the default batches of 16 and 32, the CPU at 2), the canvas
   engine's modes.
9. The serve path: the flagship (strict f32) is written with the port's
   ``save_native`` and served by ``ui.core.create_core(gan_checkpoint=...)``
   (no transport: ``tools/bench_serve.py`` drives closed-loop painter
   sessions on the core) through each image path -- helper, device canvas,
   ``RenderBatcher`` (4 ms window), the pool (both) -- with 1 session and
   with 8, whole 256-px patches at seeded positions on 1024 x 1024 canvases
   at level 2, crop margin 10; every reply arrives, no fallback and no error
   is counted, K1 launches 6 times per generator pass, the batched paths
   render more than one row per pass at 8 sessions, every flush's batch
   is one that phase 3 held K1 at, each served image
   equals the same strokes replayed one by one on the card (every session
   of the batched paths, session 0 of the others) within 1 LSB, and a
   4-stroke session on a 512 x 512 canvas through each serial path equals
   the same core on the CPU within 1 LSB.
10. The training run as ``neube_train.sh train`` runs it:
    ``tools/train.py:main`` in process with the lines of ``train_flags.txt``
    (128 px, batch 64, ``--num_bf16_res`` 4 and ``--metrics fid,forger`` at
    their defaults), cut only in length, warm start, Ggeom interval and
    snapshot cadence (``CLI_CUTS``); checks the files it leaves (options,
    finite stats, the snapshot and train state, the three viz sheets, the
    forger metrics), that no eval hook failed, and K1's, W's and W^T's
    launches against the schedule with the hooks' generator passes.  Then
    resume (a loop resumed from the run's train state takes RESUME_N
    batches and saves; a new loop resumed from that save takes the same
    RESUME_M batches as the first: bitwise equal, with cuDNN's
    deterministic algorithms), the clarity finetune (train + finetune
    flags, ``--resume`` the snapshot: the LPIPS term finite and non-zero,
    G_orig the frozen snapshot, a snapshot written), FID of the snapshot's
    engine against 256 seeded noise style images, LPIPS and the detector
    features of one batch on the card against the CPU, and the snapshot
    loaded by ``PaintEngineFactory`` (within 1 LSB of the loop's engine) and
    served by ``ui.core.create_core``; every (B, H, W, C, dtype) that K1
    launched at in this phase is one that phase 3 held against the plain
    version.  Prints s/batch and images/s per phase (the loop's
    ``profile_phases``), ``Timing/snapshot_sec``, the hooks', FID's and the
    finetune step's seconds and peak memory.
11. The checkpoint path: (a) the 256-px flagship (strict f32, seeded
    weights) written in the reference's training-snapshot layout
    (``utils/reference_layout.py``: ``G``, ``G_ema`` as persistence
    records, ``args``, ``encoder``) loads through ``PaintEngineFactory``
    with parameters bit-equal to the native engine's and renders within
    1 LSB of it, as does the native bundle ``tools/convert_checkpoint.py``
    makes of it; ``ui.core.create_core`` serves it 4 strokes; (b) StyleGAN2
    config-f (1024 px, 'skip' trunk, 'orig' head) written as a TF-legacy
    pickle converts, and renders z -> image at B = 2 on the card against
    the CPU at B = 1; (c) the 'conv' encoder feeding a triad generator at
    its bottleneck, 'sine:16' positional encoding injected in 'cat' mode,
    and a c_dim = 4 mapping and discriminator, at the 128-px training
    widths, card against CPU at B = 8; (d) the autoencoder trainer, 50
    steps of the flagship 'sauto' encoder at 128 px, batch 16 (the loss
    falls), its checkpoint, and ``tools/train.py`` with ``train_flags.txt``
    and ``--encoder_checkpt`` (one batch, no eval hooks), once with the AE
    checkpoint and once with a reference ``.pt`` of the same weights, K1,
    W and W^T launched as the schedule says.  Every K1 shape it launched
    was held in phase 3.  Prints the conversion seconds, config-f ms per
    image, the AE's steps/s, and how many LSB apart two renders of the
    native engine, a second native engine and the converted ones lie; with
    cuDNN's deterministic algorithms (and empty style caches) they must be
    bit-equal.
12. Stitching and the metric zoo (``[stitch]`` lines): the canonical
    128-px / batch-64 configuration with Gstitch every 4 batches and the
    stitch losses ``gan(fake)``, ``gan(fake_composite)``, ``l1(patch)``
    takes 9 batches of ``TrainingLoop`` (launches on the schedule, Gstitch's
    and Gmain's seconds, peak memory); one Gstitch at B = 8 on the card and
    on the CPU with the same draws (stats within 1e-4 relative, the G
    update within one Adam step's rounding); ``tools/train.py`` with
    ``train_flags.txt`` and the stitch flags (bf16, one batch), resumed
    bitwise across a Gstitch; then the 256-px flagship written with
    ``save_native``: ``tools/metric_main.py --enable_stitching`` (the
    stitching keys present and finite), ``stitching_metric_loop`` card
    against CPU, ``tools/visualize_stitching.py``, ``tools/calc_metrics.py
    --metrics fid,kid,is,pr,ppl_w,ppl_z`` over 256 noise style images and
    synthetic geometry written as PNG (every value finite, with its
    seconds), ``tools/fid_from_images.py --pr``, ``compute_pr`` and PPL's
    per-sample distances card against CPU.  Every K1 shape and every W /
    W^T shape it launched was held in phases 3 and 5.
13. The brush-creation workflow (``[brush]`` lines), on the 256-px flagship
    bundle in strict f32 through the CLIs a user runs:
    ``tools/make_synthetic_media.py`` (8 media PNGs at 512 px, drawn in a
    process started with the smoke), ``tools/project_main.py`` on the 8
    targets (``project_parallel``, 2 patches each: 16 rows per step, 100
    steps; the npz files, the library, ``--skip_existing``) and on one
    target alone (``project``, 4 patches); ms per step and styles per
    second, the first and best LPIPS, peak memory, and K1's forward and
    backward share of a step's device time (the profiler); one
    ``project_parallel`` at N = 2, B = 1 on the card and on the CPU with the
    same draws; ``tools/opt_clarity_main.py`` on the projected library (its
    clarity terms alone, optimized from each projected style, fall);
    ``tools/clip_search_main.py`` with a
    seeded ViT-B/32 file and a small merges file (the dictionary, a query,
    ``--optimize``), then the hashing fallback, and CLIP's encoders card
    against CPU; ``tools/get_ws_main.py``, ``tools/seed_expand.py`` and
    ``tools/visualize_pca_main.py``; then ``ui/core.create_core`` serves the
    seed, projected, OPT and CLIP libraries and 5 strokes of a projected
    brush (its noise textures in use) each within 1 LSB of
    ``render_stroke`` with the same style.  K1's launches of every step
    against its schedule (6 per generator pass), each of its shapes held in
    phase 3.  The clarity CLI runs 20 steps at batch 4 and the CLIP
    optimizer 30 steps; every stroke is drawn by the native rasterizer
    (``native.py``, which the smoke requires).
14. The data chain (``[data]`` lines) of ``scripts/run_r5_flagship.sh``
    through the port's CLIs at the reference's resolutions, cut only in
    count: strokes/s of the native and the numpy rasterizer at 128, 192 and
    256 px (max abs difference <= 1e-4); ``tools/make_synthetic_media.py``
    (256 images at 128 px) -> ``tools/dataset_tool.py`` -> the style zip;
    ``tools/create_splines.py`` (256 at 192 px, 8 processes) ->
    ``tools/prep_geom_data.py`` -> ``dataset_tool`` -> the geometry zip;
    ``tools/patch_augment.py``, ``tools/reformat_triband_data_main.py`` and
    ``tools/make_synthetic_styles.py``; each CLI's seconds; every member
    checked (style [128,128,3] uint8; geometry [192,192,3] with G binary and
    B its blur; every patch at or above ``--min_entropy``; the reformatted
    channels reversed); then ``tools/train_autoencoder.py`` on the geometry
    zip (300 steps, the loss falls) and ``tools/train.py`` on both zips with
    ``train_flags.txt`` and ``--encoder_checkpt`` that AE for 4 batches: K1,
    W and W^T launched on the schedule, each shape held in phases 3 and 5.
15. Prints the kernel table as JSON, then the final JSON line.

It imports nothing of JAX and nothing of ``brushstroke_engine_tpu``.
"""

import atexit
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BATCH = 16
RES = 256
SEED = 0
NOISE_STRENGTH = 0.1           # init leaves it 0; non-zero so noise counts

# Kernel vs plain tolerances (stated before any run):
#   f32: |k - p| <= 1e-5 * |p| + 1e-5 -- the same f32 math, only the order
#        of the 16-term FIR sum differs (1e-5 abs floor for outputs near 0).
#   bf16: |k - p| <= 2^-7 * |p| + 1e-5 -- both round one f32 value to bf16
#        once; a reordered sum can move it across one rounding boundary,
#        i.e. one bf16 ulp (<= 2^-7 relative).
F32_RTOL, BF16_RTOL, ATOL = 1e-5, 2.0 ** -7, 1e-5
# CUDA (TF32 off) vs CPU render of the same request, RGBA in [0, 1]: 1e-3
# abs -- cuDNN's f32 conv algorithms sum in other orders than the CPU's
# through the encoder and 13 synthesis layers; uint8 within 1 LSB.
RENDER_ATOL = 1e-3
# FIR-epilogue gradients, kernel path vs plain: 1e-4 of the largest entry of
# each gradient (the backward re-runs the plain chain on the saved inputs;
# only rounding of the f32 sums differs).
FIR_GRAD_RTOL = 1e-4
# The same with a bf16 input and cotangent (the CLI run's --num_bf16_res 4):
# 2^-7 of the largest entry -- the backward re-runs the plain chain on the
# same bf16 inputs, so the bound is one bf16 rounding of a summed product.
FIR_GRAD_BF16_RTOL = 2.0 ** -7
# Two-pass warp, kernel vs plain: 2e-5 forward (the same f32 weights, taps
# summed in another order), 2e-4 for W^T and the second-order gradient
# (relative to the largest entry), 1e-4 relative for <Wx, g> = <x, W^T g>.
WARP_FWD_TOL, WARP_GRAD_TOL, WARP_ADJ_RTOL = 2e-5, 2e-4, 1e-4
# The same training phases on the card and on the CPU, identical draws:
# losses within 1e-4 relative (f32 sums in another order through G and D).
TRAIN_RTOL = 1e-4
TRAIN_RES, TRAIN_BATCH, TRAIN_BATCHES, WARM_BATCHES = 128, 64, 33, 2
# The conv0 layers the CLI run's --num_bf16_res 4 puts in bf16 at 128 px.
TRAIN_BF16_RES = (16, 32, 64, 128)
# The paint path: a 1024-px canvas blended at level 2 (res/2 = 128 px,
# 128 channels: a 128 MiB feature canvas), crop margin 10, a 2048-px drawing
# (padded to 2144 px: 9 x 9 tiles at stride 236); the CPU comparison at 512 px
# and on a 472-px drawing (2 x 2 tiles), where the card runs the wave
# stylizers at their default batches (16 and 32) and the CPU at CMP_BATCH
# (a chunk's padding repeats its last tile, so the batch does not change the
# image).
PAINT_CANVAS, PAINT_LEVEL, PAINT_CROP, PAINT_TIMED = 1024, 2, 10, 30
STYLIZE_SIZE, STYLIZE_STROKES, STYLIZE_OVERLAP = 2048, 64, 10
CMP_CANVAS, CMP_DRAWING, CMP_BATCH = 512, 472, 2
# The serve path: the client's defaults (positions on, render mode 'clear',
# level 2, crop margin 10) on 1024-px canvases (512^2 x 128 f32 features,
# 128 MiB per session), a 4 ms flush window; per path (sessions, timed
# strokes, warm-up strokes) per session, then SERVE_TRACE strokes under the
# profiler for the idle share.  The CPU comparison: 4 strokes at 512 px.
SERVE_CANVAS, SERVE_WINDOW_MS = 1024, 4.0
SERVE_RUNS = ((1, 24, 4), (8, 8, 2))
SERVE_TRACE, SERVE_CMP_STROKES = 2, 4
# Phase 10, the CLI training run: train_flags.txt with only these cut --
# the length (2 kimg: 32 batches of 64), the warm start (4 batches), the Ggeom
# interval (200 batches would never come in 32: 8 runs it after the warm
# start) and the snapshot and image cadence (every tick: the run is one
# tick) -- then RESUME_N + RESUME_M batches of the resume check, the clarity
# finetune for FINETUNE_WARM_KIMG (3 batches), FID over FID_ITEMS items at
# B = FID_BATCH, and SNAP_SERVE_STROKES strokes served from the snapshot.
# The hooks' generator passes: the visualizer's fakes and geometry sheets
# and one per VIZ_COLORS entry; two per METRIC_STYLES style of the metric
# loop.  Card vs CPU for LPIPS and the detector features: METRIC_RTOL
# (cuDNN's and the CPU's f32 sums in other orders, TF32 off).
CLI_CUTS = ["--kimg", "2", "--geom_warmstart_kimg", "0.256",
            "--geom_interval", "8", "--snap", "1", "--image_snap", "1"]
RESUME_N, RESUME_M = 1, 4
FINETUNE_WARM_KIMG = 0.192
FID_ITEMS, FID_BATCH = 256, 8
SNAP_SERVE_STROKES = 4
VIZ_COLORS, METRIC_STYLES = 5, 8
METRIC_RTOL = 1e-4
FORGER_KEYS = {"BG_CLARITY_MEAN", "FG_OPACITY_MEDIAN", "LAB_E%", "LAB_L2",
               "LPIPS_ACROSS_GEO", "LPIPS_UNIFORM_BG",
               "LPIPS_UNIFORM_BG_multicolor"}
# Phase 11, the checkpoint path.  (b) StyleGAN2 config-f as its TF pickle
# carries it (1024 px, z = w = 512, 8 mapping layers, fmap_base 16384 ->
# channel_base 32768, fmap_max 512, the 'skip' trunk and 'orig' head, no
# conv clamp), z -> image at CONFIG_F_BATCH on the card against the first
# sample on the CPU: max abs err <= 1e-3 of max(1, max |CPU image|) (f32
# sums in other orders through 18 layers; the 'orig' head's image is not
# bounded to [0, 1]).  (c) the variants at the 128-px training widths, card
# against CPU at VARIANT_BATCH: RGBA within RENDER_ATOL, the conditional D's
# logits within 1e-3 of max(1, max |CPU logit|).  (d) the autoencoder
# trainer: AE_STEPS steps of the flagship 'sauto' encoder at width AE_WIDTH,
# batch AE_BATCH (the mean loss of the last 5 steps below that of the first
# 5), then tools/train.py with train_flags.txt and --encoder_checkpt, cut to
# one batch without eval hooks (CKPT_CLI_CUTS), once with the AE checkpoint
# and once with a reference-layout .pt of the same weights.
CONFIG_F = dict(z_dim=512, w_dim=512, img_resolution=1024, mapping_layers=8,
                color_format="orig", architecture="skip", channel_base=32768,
                channel_max=512, conv_clamp=None)
CONFIG_F_BATCH, CONFIG_F_TOL = 2, 1e-3
VARIANT_RES, VARIANT_BATCH, D_LOGIT_TOL = 128, 8, 1e-3
AE_STEPS, AE_WIDTH, AE_BATCH = 50, 128, 16
CKPT_CLI_CUTS = ["--kimg", "0", "--geom_warmstart_kimg", "0",
                 "--geom_interval", "8", "--snap", "1", "--image_snap", "1",
                 "--metrics", ""]
# K1 against its plain version at the 256-px shapes for every batch these
# paths launch: B = 1 (a helper or session stroke), 2-8 (a cross-session
# flush of that many of the at most 8 painters; the port pads no flush to a
# bucket) and 32 (an on-device stylize chunk; the batched stylizer's B = 16
# is the timing table).  The serve phase checks that no flush left this set.
K1_PATH_BATCHES = (*range(1, 9), 32)
# K1 in bf16 at the CLI run's 16-128 px shapes for every batch phase 10
# launches it at: B = 64 (the training phases), 32 (Gpl), 1-8 (the
# visualizer's sheets, the forger metric loop's B = 4, FID's B = 8, the
# loaded snapshot's strokes and the served ones).  Phase 10 checks that
# every shape it launched K1 at was held in phase 3.
K1_BF16_BATCHES = (TRAIN_BATCH, *K1_PATH_BATCHES)
# Phase 12, stitching and the metric zoo.  Gstitch at the canonical
# configuration with the JAX package's parity losses (all three stitch
# sources) every STITCH_INTERVAL batches: STITCH_BATCHES batches of
# TrainingLoop (Gstitch at 0, 4 and 8), then one Gstitch at
# STITCH_CHECK_BATCH on the card and on the CPU from the same weights, data
# and draws: every stat within TRAIN_RTOL, the updated G by the port's
# parity tests' rule for one Adam step (~lr * sign(g), so per tensor the
# mean |dG_card - dG_cpu| under 2 % of the step and 99 % of the entries
# under 10 %).  The CLI: train_flags.txt with the stitch flags, one batch
# (Gstitch at batch 0), then the resume check of phase 10 (Gstitch at batch
# 4).  Then the 256-px flagship written with save_native: the stitching
# metrics through tools/metric_main.py over ZOO_STYLES styles at B = 8 and
# stitching_metric_loop at B = STITCH_CMP_BATCH on the card against the CPU
# (METRIC_RTOL), the stitching sheets, tools/calc_metrics.py over ZOO_ITEMS
# items at B = ZOO_BATCH (ZOO_ITEMS noise style images and ZOO_GEOMS
# synthetic geometries written as PNG), tools/fid_from_images.py --pr,
# compute_pr on the card against the CPU on the same features (equal), and
# PPL's per-sample distances at PPL_CMP_EPS card against CPU (PPL_CMP_RTOL
# relative -- f32 renders summed in other orders, magnified by eps^-2 --
# plus the f32 floor of LPIPS, 8 u sqrt(d) / eps with u = 2^-24).
STITCH_LOSSES = "1.0*gan(fake)+1.0*gan(fake_composite)+1.0*l1(patch)"
STITCH_INTERVAL, STITCH_BATCHES, STITCH_CHECK_BATCH = 4, 9, 8
STITCH_CMP_BATCH = 2
ZOO_ITEMS, ZOO_BATCH, ZOO_STYLES, ZOO_GEOMS = 256, 32, 4, 64
ZOO_METRICS = "fid,kid,is,pr,ppl_w,ppl_z"
PPL_CMP_SAMPLES, PPL_CMP_EPS, PPL_CMP_RTOL = 4, 1e-2, 1e-3
# Phase 13, the brush-creation workflow through its CLIs, as
# scripts/run_r5_brush_workflow.sh runs it, on the 256-px flagship bundle
# (seeded weights, strict f32): WF_MEDIA media PNGs of WF_MEDIA_RES px (the
# media CLI runs in a process of its own from the start of the smoke, beside
# the earlier phases), all projected in one run (WF_PATCHES patches each,
# WF_STEPS steps: N * B = 16 rows) and the first alone (WF_SINGLE_PATCHES
# patches); ms per step as the median over WF_TIME_CHUNKS chunks of
# WF_TIME_EVERY steps after a first chunk; the clarity finetune of the
# projected library (WF_CLARITY_STEPS steps at WF_CLARITY_BATCH strokes; the
# objective before and after on WF_CLARITY_EVAL held batches of 4 strokes,
# reported: its anchor terms are 0 where a style starts; its clarity terms
# WF_CLARITY_TERMS alone, optimized from each projected style for
# WF_DESCENT_STEPS steps on the held batches, must fall there); CLIP search
# with a seeded ViT-B/32 file and --optimize (WF_CLIP_STEPS; WF_CLIP_TIMED
# more steps timed on the held batches), then the
# hashing fallback; the W-space CLIs (WF_WS seeds, a WF_GRID^2 grid); the
# four libraries served and WF_STROKES strokes painted with a projected
# brush on a WF_CANVAS canvas.  The CLIs draw their geometry on the host,
# through the native rasterizer (native.py; main fails without it).  Card
# vs CPU: project_parallel
# at N = 2, B = 1 for WF_CMP_STEPS steps with the same draws (LPIPS within
# WF_RTOL relative; w and noise within WF_RTOL relative plus Adam's lr bound, as
# phase 12 holds an Adam update: each entry within 10 % of the summed
# learning rate, the mean within 2 %); CLIP
# ViT-B/32's encode_image and encode_text within WF_RTOL.  Served strokes
# within 1 LSB of render_stroke with the same style.
WF_MEDIA, WF_MEDIA_RES, WF_MEDIA_SEED = 8, 512, 777
WF_STEPS, WF_PATCHES, WF_SINGLE_PATCHES = 100, 2, 4
WF_TIME_EVERY, WF_TIME_CHUNKS = 10, 4
WF_CMP_STEPS, WF_RTOL = 3, 1e-4
WF_CLARITY_STEPS, WF_CLARITY_BATCH, WF_CLARITY_EVAL = 20, 4, 2
WF_CLARITY_TERMS, WF_DESCENT_STEPS = "0.5*iou_inv(uvs)+0.5*iou(u)", 20
WF_CLIP_STEPS, WF_CLIP_TIMED = 30, 10
WF_WS, WF_GRID, WF_STROKES, WF_CANVAS = 64, 3, 5, 512
WF_PROFILE_W_SAMPLES = 512
WF_QUERY = "a dark ink brush stroke"
# Phase 14, the data chain of scripts/run_r5_flagship.sh:12-28 through the
# port's CLIs, at the reference's resolutions and cut only in count
# (DC_CUTS): DC_MEDIA media images at DC_MEDIA_RES px
# (tools/make_synthetic_media.py) packed into the style zip; DC_SPLINES
# splines at DC_SPLINE_RES px (DC_WORKERS processes) -> triband -> the
# geometry zip; patch_augment on the media (DC_PATCHES patches of
# DC_PATCH_WIDTH px per image, every member at or above DC_MIN_ENTROPY);
# reformat_triband_data_main (2,1,0: each output the input's channels
# reversed); make_synthetic_styles (DC_STYLES at DC_MEDIA_RES px).  Then the
# autoencoder trainer on the geometry zip, DC_AE_STEPS steps at width 128
# (the loss falls: the mean of the last DC_AE_WINDOW steps below that of the
# first), and tools/train.py on both zips with train_flags.txt,
# CKPT_CLI_CUTS and --encoder_checkpt that AE, for DC_TRAIN_BATCHES
# batches: K1, W and W^T launched on the schedule at held shapes.  Before
# it, strokes/s of the native and the numpy rasterizer at DC_STROKE_WIDTHS
# (DC_STROKES_NATIVE and DC_STROKES_NUMPY seeded splines), max abs
# difference <= DC_STROKE_ATOL (the bound of tests/test_native.py).
DC_MEDIA, DC_MEDIA_RES, DC_SPLINES, DC_SPLINE_RES = 256, 128, 256, 192
DC_CUTS = ("counts only: media 256 (reference 4000), splines 256 (1000), "
           "AE 300 steps (10000), tools/train.py 4 batches (3000 kimg)")
DC_WORKERS, DC_PATCH_WIDTH, DC_PATCHES, DC_MIN_ENTROPY = 8, 64, 4, 1.0
DC_STYLES, DC_AE_STEPS, DC_AE_WINDOW, DC_TRAIN_BATCHES = 64, 300, 20, 4
DC_STROKE_WIDTHS, DC_STROKES_NATIVE, DC_STROKES_NUMPY = (128, 192, 256), 50, 3
DC_STROKE_ATOL = 1e-4


def fail(msg):
    raise RuntimeError(msg)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: the port's smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def phase_build():
    from brushstroke_engine_torch.ops import cuda_build
    t0 = time.time()
    reports = cuda_build.build_all()
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {sorted(cuda_build.SOURCES)} in {time.time() - t0:.1f} s",
          flush=True)


def _fir_inputs(res, channels, dtype, noise_batch, gen):
    """``noise_batch``: None (no noise), BATCH (one plane per sample) or 1
    (one plane for the whole batch, as the sfactor pass sends it)."""
    import torch
    dev = "cuda"
    x = (torch.randn((BATCH, res + 3, res + 3, channels), generator=gen,
                     device=dev) * 2).to(dtype)
    d = torch.rand((BATCH, channels), generator=gen, device=dev) * 0.5 + 0.7
    noise = None if noise_batch is None else torch.randn(
        (noise_batch, res, res, 1), generator=gen, device=dev)
    bias = torch.randn((channels,), generator=gen, device=dev)
    return x, d, noise, bias


def _library_fir(x, taps_w, d, noise, bias, act_gain, clamp):
    """Yardstick only (the port never calls it): cuDNN depthwise conv on the
    channels_last view in the input's dtype, then torch elementwise ops."""
    import torch.nn.functional as F
    y = F.conv2d(x.permute(0, 3, 1, 2), taps_w, groups=x.shape[-1])
    y = y * d.to(y.dtype)[:, :, None, None]
    if noise is not None:
        y = y + noise.permute(0, 3, 1, 2).to(y.dtype)
    y = F.leaky_relu(y + bias.to(y.dtype)[None, :, None, None], 0.2)
    y = y * act_gain
    return y.clamp_(-clamp, clamp) if clamp is not None else y


def phase_kernel_vs_plain():
    import torch
    from brushstroke_engine_torch.flagship import flagship_generator_config
    from brushstroke_engine_torch.ops import fir_epilogue as fe
    from brushstroke_engine_torch.ops.filters import setup_filter

    syn = flagship_generator_config(RES).synthesis
    f = setup_filter([1, 3, 3, 1])
    taps = fe.correlation_taps(f)
    act_gain = 2 ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # Every (B, H, W, C, dtype) held against the plain version through the
    # kernel's own tile choice; phase 10 checks its launches against it.
    held = set()
    rows = []
    for res in syn.block_resolutions[1:]:
        c = syn.channels(res)
        for dtype in (torch.float32, torch.bfloat16):
            rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
            for noise_batch in (None, BATCH, 1):
                for clamp in (256.0, None):
                    x, d, noise, bias = _fir_inputs(res, c, dtype,
                                                    noise_batch, gen)
                    got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain,
                                           clamp, out_dtype=dtype)
                    want = fe.fir4_epilogue_plain(x, taps, d, noise, bias,
                                                  act_gain, clamp,
                                                  out_dtype=dtype)
                    torch.cuda.synchronize()
                    check(got.shape == (BATCH, res, res, c),
                          f"kernel shape {tuple(got.shape)}")
                    err = (got.float() - want.float()).abs()
                    bad = err > rtol * want.float().abs() + ATOL
                    check(not bool(bad.any()),
                          f"kernel != plain at res {res} {dtype} noise "
                          f"batch {noise_batch} clamp={clamp}: max err "
                          f"{err.max().item():.3e}")
                    max_err[dtype] = max(max_err[dtype], err.max().item())
                    held.add((BATCH, res, res, c, str(dtype)))
            # Timing in the render's configuration: noise and clamp on.
            x, d, noise, bias = _fir_inputs(res, c, dtype, BATCH, gen)
            taps_w = torch.as_tensor(taps, device="cuda").to(dtype)[
                None, None].expand(c, 1, 4, 4)
            iters = 200 if res <= 64 else 50
            k_ms = cuda_ms(lambda: fe.fir4_epilogue(
                x, f, d, noise, bias, act_gain, 256.0, out_dtype=dtype),
                iters)
            p_ms = cuda_ms(lambda: fe.fir4_epilogue_plain(
                x, taps, d, noise, bias, act_gain, 256.0, out_dtype=dtype),
                iters)
            l_ms = cuda_ms(lambda: _library_fir(
                x, taps_w, d, noise, bias, act_gain, 256.0), iters)
            n_out = BATCH * res * res * c
            nbytes = (x.numel() * x.element_size() + n_out * x.element_size()
                      + noise.numel() * 4 + d.numel() * 4 + bias.numel() * 4)
            flops = n_out * (16 * 2 + 6)   # FIR FMAs + scale/noise/bias/act
            b_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
            row = {"res": res, "channels": c, "batch": BATCH,
                   "dtype": str(dtype).replace("torch.", ""),
                   "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "bound_ms": b_ms, "bytes": nbytes, "flops": flops,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                   >= flops / F32_FLOPS_PER_S else "operations"}
            rows.append(row)
            print("[fir4] " + json.dumps(row), flush=True)
    print(f"[fir4] all 72 kernel-vs-plain cases within tolerance; max abs "
          f"err f32 {max_err[torch.float32]:.3e}, bf16 "
          f"{max_err[torch.bfloat16]:.3e}", flush=True)

    # Off the vector path: C = 20 (a multiple of 4, not of 8), C = 5
    # (neither), H != W with H no multiple of any strip, W narrower than a
    # thread's walk of 2 columns; the kernel's own tile and every forced
    # (columns, rows) tile.  Same tolerances.
    n_off = 0
    for b, h, w, c in ((2, 13, 9, 20), (3, 5, 7, 5), (2, 6, 3, 24),
                       (1, 1, 1, 8), (2, 37, 66, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
            x = (torch.randn((b, h + 3, w + 3, c), generator=gen,
                             device="cuda") * 2).to(dtype)
            d = torch.rand((b, c), generator=gen, device="cuda") * 0.5 + 0.7
            noise = torch.randn((b, h, w, 1), generator=gen, device="cuda")
            bias = torch.randn((c,), generator=gen, device="cuda")
            want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                          256.0, out_dtype=dtype).float()
            tiles = [(xw, strip) for xw in (1, 2) for strip in (1, 3, 8)]
            for tile in [None] + tiles:
                if tile is None:
                    got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain,
                                           256.0, out_dtype=dtype)
                else:
                    got = fe._launch_kernel(x, taps, d, noise, bias,
                                            act_gain, 256.0, 0.2, dtype,
                                            tile=tile)
                torch.cuda.synchronize()
                err = (got.float() - want).abs()
                check(got.shape == (b, h, w, c) and not bool(
                    (err > rtol * want.abs() + ATOL).any()),
                    f"kernel != plain at [{b},{h},{w},{c}] {dtype} tile "
                    f"{tile}: max err {err.max().item():.3e}")
                max_err[dtype] = max(max_err[dtype], err.max().item())
                if tile is None:
                    held.add((b, h, w, c, str(dtype)))
                n_off += 1
    print(f"[fir4] {n_off} off-vector-path cases within tolerance",
          flush=True)

    # The paint and serve paths' batches (K1_PATH_BATCHES) at the 256-px
    # shapes, f32 with one noise plane per sample and the clamp, as the
    # render sends them.  ``dispatch`` picks the strip and block per shape,
    # so each batch is checked on its own.
    n_paint = 0
    for b in K1_PATH_BATCHES:
        for res in syn.block_resolutions[1:]:
            c = syn.channels(res)
            x = torch.randn((b, res + 3, res + 3, c), generator=gen,
                            device="cuda") * 2
            d = torch.rand((b, c), generator=gen, device="cuda") * 0.5 + 0.7
            noise = torch.randn((b, res, res, 1), generator=gen,
                                device="cuda")
            bias = torch.randn((c,), generator=gen, device="cuda")
            got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain, 256.0)
            want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                          256.0)
            torch.cuda.synchronize()
            err = (got - want).abs()
            check(got.shape == (b, res, res, c) and not bool(
                (err > F32_RTOL * want.abs() + ATOL).any()),
                f"kernel != plain at [{b},{res},{res},{c}] f32: max err "
                f"{err.max().item():.3e}")
            max_err[torch.float32] = max(max_err[torch.float32],
                                         err.max().item())
            held.add((b, res, res, c, str(torch.float32)))
            n_paint += 1
    print(f"[fir4] {n_paint} paint- and serve-path cases (B = "
          f"{', '.join(map(str, K1_PATH_BATCHES))}) within tolerance",
          flush=True)

    # The trainer's shapes (B = 64, C = 128, f32, noise and clamp): checked
    # against the plain version, then timed.
    train_rows = []
    for res in flagship_generator_config(TRAIN_RES).synthesis \
            .block_resolutions[1:]:
        c = flagship_generator_config(TRAIN_RES).synthesis.channels(res)
        x = torch.randn((TRAIN_BATCH, res + 3, res + 3, c), generator=gen,
                        device="cuda") * 2
        d = torch.rand((TRAIN_BATCH, c), generator=gen, device="cuda") + 0.5
        noise = torch.randn((TRAIN_BATCH, res, res, 1), generator=gen,
                            device="cuda")
        bias = torch.randn((c,), generator=gen, device="cuda")
        got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain, 256.0)
        want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                      256.0)
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(not bool((err > F32_RTOL * want.abs() + ATOL).any()),
              f"kernel != plain at [{TRAIN_BATCH},{res},{res},{c}] f32: max "
              f"err {err.max().item():.3e}")
        max_err[torch.float32] = max(max_err[torch.float32], err.max().item())
        held.add((TRAIN_BATCH, res, res, c, str(torch.float32)))
        del got, want, err
        iters = 200 if res <= 32 else 30
        k_ms = cuda_ms(lambda: fe.fir4_epilogue(
            x, f, d, noise, bias, act_gain, 256.0), iters)
        p_ms = cuda_ms(lambda: fe.fir4_epilogue_plain(
            x, taps, d, noise, bias, act_gain, 256.0), iters)
        nbytes = 4 * (x.numel() + TRAIN_BATCH * res * res * c
                      + noise.numel() + d.numel() + bias.numel())
        row = {"shape": [TRAIN_BATCH, res, res, c], "dtype": "float32",
               "kernel_ms": k_ms, "plain_ms": p_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
        train_rows.append(row)
        print("[fir4-train] " + json.dumps(row), flush=True)

    # The CLI training run's bf16 rows (--num_bf16_res 4: the 16-128 px
    # conv0 layers, C = 128, noise and clamp) at every batch that run
    # launches them at (K1_BF16_BATCHES): checked against the plain version,
    # the B = 64 rows timed.
    bf16_rows = []
    syn = flagship_generator_config(TRAIN_RES).synthesis
    for b in K1_BF16_BATCHES:
        for res in TRAIN_BF16_RES:
            c = syn.channels(res)
            x = (torch.randn((b, res + 3, res + 3, c), generator=gen,
                             device="cuda") * 2).to(torch.bfloat16)
            d = torch.rand((b, c), generator=gen, device="cuda") + 0.5
            noise = torch.randn((b, res, res, 1), generator=gen,
                                device="cuda")
            bias = torch.randn((c,), generator=gen, device="cuda")
            got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain, 256.0)
            want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                          256.0)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            check(got.dtype == torch.bfloat16 and not bool(
                (err > BF16_RTOL * want.float().abs() + ATOL).any()),
                f"kernel != plain at [{b},{res},{res},{c}] bf16: max err "
                f"{err.max().item():.3e}")
            max_err[torch.bfloat16] = max(max_err[torch.bfloat16],
                                          err.max().item())
            held.add((b, res, res, c, str(torch.bfloat16)))
            del got, want, err
            if b != TRAIN_BATCH:
                continue
            iters = 200 if res <= 32 else 30
            k_ms = cuda_ms(lambda: fe.fir4_epilogue(
                x, f, d, noise, bias, act_gain, 256.0), iters)
            p_ms = cuda_ms(lambda: fe.fir4_epilogue_plain(
                x, taps, d, noise, bias, act_gain, 256.0), iters)
            nbytes = 2 * (x.numel() + b * res * res * c) + 4 * (
                noise.numel() + d.numel() + bias.numel())
            row = {"shape": [b, res, res, c], "dtype": "bfloat16",
                   "kernel_ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bytes": nbytes}
            bf16_rows.append(row)
            print("[fir4-train-bf16] " + json.dumps(row), flush=True)
    print(f"[fir4] the CLI run's bf16 rows (B = "
          f"{', '.join(map(str, K1_BF16_BATCHES))}; "
          f"{', '.join(map(str, TRAIN_BF16_RES))} px) within tolerance",
          flush=True)

    # Phase 11's config-f generator: B = CONFIG_F_BATCH, f32, 8-1024 px at
    # C = 512 down to 32, one noise plane for the batch (constant noise
    # without positions) and no clamp, as that pass sends them.
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    fsyn = make_generator_config(**CONFIG_F).synthesis
    ff_rows = []
    for res in fsyn.block_resolutions[1:]:
        c = fsyn.channels(res)
        b = CONFIG_F_BATCH
        x = torch.randn((b, res + 3, res + 3, c), generator=gen,
                        device="cuda") * 2
        d = torch.rand((b, c), generator=gen, device="cuda") + 0.5
        noise = torch.randn((1, res, res, 1), generator=gen, device="cuda")
        bias = torch.randn((c,), generator=gen, device="cuda")
        got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain, None)
        want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                      None)
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(not bool((err > F32_RTOL * want.abs() + ATOL).any()),
              f"kernel != plain at [{b},{res},{res},{c}] f32 (config-f): "
              f"max err {err.max().item():.3e}")
        max_err[torch.float32] = max(max_err[torch.float32], err.max().item())
        held.add((b, res, res, c, str(torch.float32)))
        del got, want, err
        iters = 200 if res <= 64 else 20
        k_ms = cuda_ms(lambda: fe.fir4_epilogue(
            x, f, d, noise, bias, act_gain, None), iters)
        p_ms = cuda_ms(lambda: fe.fir4_epilogue_plain(
            x, taps, d, noise, bias, act_gain, None), iters)
        nbytes = 4 * (x.numel() + b * res * res * c + noise.numel()
                      + d.numel() + bias.numel())
        flops = b * res * res * c * (16 * 2 + 5)
        row = {"shape": [b, res, res, c], "dtype": "float32",
               "kernel_ms": k_ms, "plain_ms": p_ms,
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / F32_FLOPS_PER_S) * 1e3,
               "bytes": nbytes, "flops": flops}
        ff_rows.append(row)
        print("[fir4-config-f] " + json.dumps(row), flush=True)
        del x, d, noise, bias
    print(f"[fir4] config-f rows (B = {CONFIG_F_BATCH}, 8-1024 px) within "
          f"tolerance", flush=True)
    return rows, max_err, held


def _rel_err(got, want):
    """max |got - want| relative to max(|want|, 1)."""
    return ((got - want).abs().max() /
            want.abs().max().clamp_min(1.0)).item()


def phase_fir_backward():
    import torch
    from brushstroke_engine_torch.ops import fir_epilogue as fe
    from brushstroke_engine_torch.ops.filters import setup_filter

    f = setup_filter([1, 3, 3, 1])
    taps = fe.correlation_taps(f)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, c, gain, clamp = 4, 128, 2 ** 0.5, 256.0
    worst = 0.0

    def grads(use_kernel, leaves, cot, second):
        x, d, noise, bias = [t.detach().clone().requires_grad_(True)
                             for t in leaves]
        xin = torch.tanh(x) * 3      # so that d2/dx2 is not identically 0
        if use_kernel:
            y = fe.fir4_epilogue(xin, f, d, noise, bias, gain, clamp)
            check(y.grad_fn is not None, "kernel output has no grad_fn")
        else:
            y = fe.fir4_epilogue_plain(xin, taps, d, noise, bias, gain, clamp)
        g1 = torch.autograd.grad((y * cot).sum(), [x, d, noise, bias],
                                 create_graph=second)
        if not second:
            return g1
        return torch.autograd.grad(sum(g.square().sum() for g in g1),
                                   [x, d, noise, bias], allow_unused=True)

    for res, second in ((64, False), (128, False), (64, True)):
        x = torch.randn((b, res + 3, res + 3, c), generator=gen,
                        device="cuda")
        d = torch.rand((b, c), generator=gen, device="cuda") * 0.5 + 0.7
        noise = torch.randn((b, res, res, 1), generator=gen, device="cuda")
        bias = torch.randn((c,), generator=gen, device="cuda")
        cot = torch.randn((b, res, res, c), generator=gen, device="cuda")
        before = fe.fir4_epilogue.launches
        got = grads(True, (x, d, noise, bias), cot, second)
        check(fe.fir4_epilogue.launches == before + 1,
              "the gradient case did not launch the kernel once")
        want = grads(False, (x, d, noise, bias), cot, second)
        torch.cuda.synchronize()
        for name, a, w in zip(("x", "dcoefs", "noise", "bias"), got, want):
            check((a is None) == (w is None), f"{name}: gradient missing")
            if a is None:
                continue
            check(w.abs().max().item() > 0, f"{name}: plain gradient is 0")
            err = ((a - w).abs().max() / w.abs().max()).item()
            worst = max(worst, err)
            check(err <= FIR_GRAD_RTOL,
                  f"fir4_epilogue d/d{name} res {res} "
                  f"{'second' if second else 'first'} order: rel err {err:.3e}")
    print(f"[fir4-bwd] first-order at 64 and 128 px and one double backward "
          f"(B={b}, C={c}, f32) within {FIR_GRAD_RTOL:g} of the largest "
          f"gradient; worst {worst:.3e}", flush=True)

    # bf16 at the 64- and 128-px training shapes (B = 64, C = 128), as the
    # CLI run's --num_bf16_res 4 differentiates them.
    worst_bf16 = 0.0
    for res in (64, 128):
        x = torch.randn((TRAIN_BATCH, res + 3, res + 3, c), generator=gen,
                        device="cuda").to(torch.bfloat16)
        d = torch.rand((TRAIN_BATCH, c), generator=gen, device="cuda") + 0.5
        noise = torch.randn((TRAIN_BATCH, res, res, 1), generator=gen,
                            device="cuda")
        bias = torch.randn((c,), generator=gen, device="cuda")
        cot = torch.randn((TRAIN_BATCH, res, res, c), generator=gen,
                          device="cuda").to(torch.bfloat16)
        before = fe.fir4_epilogue.launches
        got = grads(True, (x, d, noise, bias), cot, False)
        check(fe.fir4_epilogue.launches == before + 1,
              "the bf16 gradient case did not launch the kernel once")
        want = grads(False, (x, d, noise, bias), cot, False)
        torch.cuda.synchronize()
        for name, a, w in zip(("x", "dcoefs", "noise", "bias"), got, want):
            check(a.dtype == w.dtype and w.abs().max().item() > 0,
                  f"bf16 {name}: gradient dtype or zero")
            err = ((a.float() - w.float()).abs().max()
                   / w.float().abs().max()).item()
            worst_bf16 = max(worst_bf16, err)
            check(err <= FIR_GRAD_BF16_RTOL,
                  f"fir4_epilogue bf16 d/d{name} res {res}: rel err "
                  f"{err:.3e}")
        del got, want, x, cot
    print(f"[fir4-bwd] bf16 first-order at [{TRAIN_BATCH},64,64,{c}] and "
          f"[{TRAIN_BATCH},128,128,{c}] within {FIR_GRAD_BF16_RTOL:g} of the "
          f"largest gradient; worst {worst_bf16:.3e}", flush=True)

    # The kernel's time at the training shape (B=64, 128 px, C=128, f32).
    x = torch.randn((TRAIN_BATCH, 131, 131, c), generator=gen, device="cuda")
    d = torch.rand((TRAIN_BATCH, c), generator=gen, device="cuda") + 0.5
    noise = torch.randn((TRAIN_BATCH, 128, 128, 1), generator=gen,
                        device="cuda")
    bias = torch.randn((c,), generator=gen, device="cuda")
    k_ms = cuda_ms(lambda: fe.fir4_epilogue(x, f, d, noise, bias, gain,
                                            clamp), 20)
    p_ms = cuda_ms(lambda: fe.fir4_epilogue_plain(x, taps, d, noise, bias,
                                                  gain, clamp), 20)
    nbytes = 4 * (x.numel() + TRAIN_BATCH * 128 * 128 * c + noise.numel()
                  + d.numel() + bias.numel())
    row = {"shape": [TRAIN_BATCH, 128, 128, c], "dtype": "float32",
           "kernel_ms": k_ms, "plain_ms": p_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print("[fir4-train] " + json.dumps(row), flush=True)
    return {"worst_rel_err": worst, "worst_rel_err_bf16": worst_bf16,
            "train_shape": row}


def _class_mats(batch):
    """The five transform classes (identity, translate, scale, rotate,
    near-90 rotation) cycled over the batch, each sample with a translation
    jitter of its own."""
    import numpy as np
    ms = []
    for i in range(batch):
        kind = i % 5
        m = np.eye(3)
        if kind == 1:
            m[0, 2], m[1, 2] = 7.35, -3.6
        elif kind == 2:
            m = np.diag([1.7, 0.55, 1.0])
        elif kind in (3, 4):
            t, tx, ty = (0.5, 2.0, -1.0) if kind == 3 else \
                (np.pi / 2 - 0.07, 0.5, 0.0)
            m = np.array([[np.cos(t), -np.sin(t), tx],
                          [np.sin(t), np.cos(t), ty], [0, 0, 1.0]])
        m[0, 2] += 0.37 * (i // 5)
        m[1, 2] -= 0.21 * (i // 5)
        ms.append(m)
    return np.stack(ms).astype(np.float32)


def _stress_mats():
    """Inverse affines that stress W^T's source walk: a pure quarter turn
    (factored out by the prep), a pure translation, flips, a strong zoom-out
    (wide triangles, many sources per tap), a zoom-in (no source for many
    taps), a near-singular shear (pass-1 slope near 0)."""
    import numpy as np
    ms = {
        "quarter": [[0, -1, 0.0], [1, 0, 0.0]],
        "translate": [[1, 0, 13.25], [0, 1, -40.5]],
        "flip_x": [[-1, 0, 0.5], [0, 1, 0.0]],
        "flip_y": [[1, 0, 0.0], [0, -1, -0.25]],
        "zoom_out": [[4.3, 0.2, 1.0], [-0.3, 3.1, 2.0]],
        "zoom_in": [[0.3, 0.05, -2.0], [0.02, 0.22, 3.0]],
        "shear_flat": [[0.81 + 1e-5, 0.9, 0.0], [0.9, 1.0, 0.0]],
        "rotate_far": [[0.8, -0.6, 300.0], [0.6, 0.8, -500.0]],
    }
    return list(ms), np.stack([np.array(m + [[0, 0, 1.0]], np.float32)
                               for m in ms.values()])


# Stress shapes (N, C) of the warp kernels at B = 8: N = 67 is no multiple
# of the column band W picks there, C = 11 takes two channel chunks.
WARP_STRESS_SHAPES = ((67, 5), (128, 3), (33, 11))
# W and W^T against the plain version at the trainer's batch, a small one,
# and the batches phase 12's Gstitch launches them at: its discriminator
# sees both crops, 2 x 64 in the timed loop and the CLI, 2 x
# STITCH_CHECK_BATCH in the card-vs-CPU step.
WARP_BATCHES = ((TRAIN_BATCH, TRAIN_RES), (8, 64),
                (2 * TRAIN_BATCH, TRAIN_RES), (2 * STITCH_CHECK_BATCH,
                                               TRAIN_RES))


def _warp_stress(tw, taug, gen, worst):
    """W and W^T against their plain versions, each twice for equal bits,
    and against each other by the adjoint identity, on the stress matrices
    and on scalar packs whose pass slopes are exactly 0 and next to 0 (which
    no matrix reaches through the prep).  Returns the number of cases."""
    import torch
    names, mats = _stress_mats()
    mats = torch.from_numpy(mats).to("cuda")
    n_cases = 0
    b = len(names)
    check(any(n % tw.warp_band(b, n, c) for n, c in WARP_STRESS_SHAPES),
          "no stress shape leaves W a ragged last column band")
    for n, c in WARP_STRESS_SHAPES:
        for antialias in (True, False):
            x = torch.randn((b, n, n, c), generator=gen, device="cuda")
            g = torch.randn((b, n, n, c), generator=gen, device="cuda")
            imgs, sc = taug._twopass_prep(x, mats, antialias)
            packs = [("matrices", imgs.contiguous(), sc.contiguous())]
            flat = sc.clone()
            flat[:, 0] = torch.tensor([0.0, 1e-7, -1e-7, 3e-3, 0.0, 1e-7,
                                       -3e-3, 0.0], device="cuda")
            flat[:, 5] = torch.tensor([1e-6, -1e-6, 2e-3, 1e-6, -2e-3, 1.0,
                                       1e-6, -1.0], device="cuda")
            if antialias:
                flat[:, 3], flat[:, 7] = 1.0, 1.0
            packs.append(("flat slopes", imgs.contiguous(), flat))
            for what, im, scal in packs:
                wtg = tw.warp_twopass_t(g, scal)
                torch.cuda.synchronize()
                ptg = tw.warp_twopass_t_plain(g, scal)
                err = (wtg - ptg).abs()
                bad = err > WARP_GRAD_TOL * ptg.abs() + WARP_GRAD_TOL
                tag = f"{what} [{b},{n},{n},{c}] antialias={antialias}"
                check(not bool(bad.any()),
                      f"W^T != plain, {tag}: max err per sample "
                      f"{dict(zip(names, err.amax(dim=(1, 2, 3)).tolist()))}")
                check(torch.equal(wtg, tw.warp_twopass_t(g, scal)),
                      f"W^T is not deterministic, {tag}")
                wx = tw.warp_twopass(im, scal)
                torch.cuda.synchronize()
                px = tw.warp_twopass_plain(im, scal)
                err_w = (wx - px).abs()
                per_sample = err_w.amax(dim=(1, 2, 3)).tolist()
                check(not bool((err_w > WARP_FWD_TOL * px.abs()
                                + WARP_FWD_TOL).any()),
                      f"W != plain, {tag}: max err per sample "
                      f"{dict(zip(names, per_sample))}")
                check(torch.equal(wx, tw.warp_twopass(im, scal)),
                      f"W is not deterministic, {tag}")
                lhs, rhs = (wx * g).sum().item(), (im * wtg).sum().item()
                adj = abs(lhs - rhs) / max(abs(lhs), 1.0)
                check(adj <= WARP_ADJ_RTOL,
                      f"<Wx,g> {lhs} != <x,W^T g> {rhs}, {tag}")
                worst["w_stress"] = max(worst["w_stress"],
                                        err_w.max().item())
                worst["wt_stress"] = max(worst["wt_stress"], err.max().item())
                worst["adjoint"] = max(worst["adjoint"], adj)
                n_cases += b
    return n_cases


def phase_warp_vs_plain():
    import torch
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.train import augment as taug

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cfg = taug.AugmentConfig.from_spec("bgc")
    one = torch.tensor(1.0, device="cuda")
    rows = []
    # Every (B, N, C) launched here is held against the plain version;
    # phase 12 checks its launches against these sets.
    tw.warp_twopass.shapes.clear()
    tw.warp_twopass_t.shapes.clear()
    worst = {"w": 0.0, "wt": 0.0, "w_stress": 0.0, "wt_stress": 0.0,
             "second": 0.0, "adjoint": 0.0}

    def second_order(fn, x, g):
        xr = x.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad((torch.sin(fn(xr)) * g).sum(), xr,
                                    create_graph=True)
        (g2,) = torch.autograd.grad(g1.square().sum(), xr)
        return g2

    for b, n in WARP_BATCHES:
        c = 3
        ada_draws = taug.draw_augment(cfg, gen, b, (n, n, c), "cuda")
        ada = torch.linalg.inv_ex(taug.geometric_matrix(
            cfg, ada_draws, b, n, n, one)).inverse
        classes = torch.from_numpy(_class_mats(b)).to("cuda")
        for mats_name, mat in (("classes", classes), ("ada_p1", ada)):
            for antialias in (True, False):
                x = torch.randn((b, n, n, c), generator=gen, device="cuda")
                g = torch.randn((b, n, n, c), generator=gen, device="cuda")
                imgs, sc = taug._twopass_prep(x, mat, antialias)
                imgs, sc = imgs.contiguous(), sc.contiguous()
                n_w, n_t = tw.warp_twopass.launches, tw.warp_twopass_t.launches
                wx = tw.warp_twopass(imgs, sc)
                wtg = tw.warp_twopass_t(g, sc)
                torch.cuda.synchronize()
                check((tw.warp_twopass.launches, tw.warp_twopass_t.launches)
                      == (n_w + 1, n_t + 1), "warp launch counters")
                px = tw.warp_twopass_plain(imgs, sc)
                ptg = tw.warp_twopass_t_plain(g, sc)
                tag = f"{mats_name} [{b},{n},{n},{c}] antialias={antialias}"
                err_w = (wx - px).abs()
                check(not bool((err_w > WARP_FWD_TOL * px.abs()
                                + WARP_FWD_TOL).any()),
                      f"W != plain, {tag}: max err {err_w.max().item():.3e}")
                err_t = (wtg - ptg).abs()
                check(not bool((err_t > WARP_GRAD_TOL * ptg.abs()
                                + WARP_GRAD_TOL).any()),
                      f"W^T != plain, {tag}: max err "
                      f"{err_t.max().item():.3e}")
                check(torch.equal(wx, tw.warp_twopass(imgs, sc)),
                      f"W is not deterministic, {tag}")
                check(torch.equal(wtg, tw.warp_twopass_t(g, sc)),
                      f"W^T is not deterministic, {tag}")
                lhs, rhs = (wx * g).sum().item(), (imgs * wtg).sum().item()
                adj = abs(lhs - rhs) / max(abs(lhs), 1.0)
                check(adj <= WARP_ADJ_RTOL,
                      f"<Wx,g> {lhs} != <x,W^T g> {rhs}, {tag}")
                so = _rel_err(
                    second_order(lambda v: tw.warp_twopass(v, sc), imgs, g),
                    second_order(lambda v: tw.warp_twopass_plain(v, sc),
                                 imgs, g))
                check(so <= WARP_GRAD_TOL,
                      f"second-order gradient, {tag}: rel err {so:.3e}")
                # The whole entry (prep + kernel) against the plain entry.
                full = tw.affine_warp_twopass(x, mat, antialias)
                full_p = taug._affine_warp_twopass(x, mat, antialias)
                check(not bool(((full - full_p).abs() > WARP_FWD_TOL
                                * full_p.abs() + WARP_FWD_TOL).any()),
                      f"affine_warp_twopass != plain entry, {tag}")
                worst["w"] = max(worst["w"], err_w.max().item())
                worst["wt"] = max(worst["wt"], err_t.max().item())
                worst["second"] = max(worst["second"], so)
                worst["adjoint"] = max(worst["adjoint"], adj)

                # Times.  The library yardstick is the two einsums alone on
                # dense weights built beforehand (cuBLAS batched products).
                w1, w2 = tw.dense_weights(sc, n)
                iters = 20
                t = {
                    "w_ms": cuda_ms(lambda: tw.warp_twopass(imgs, sc), iters),
                    "wt_ms": cuda_ms(lambda: tw.warp_twopass_t(g, sc), iters),
                    "w_plain_ms": cuda_ms(
                        lambda: tw.warp_twopass_plain(imgs, sc), iters),
                    "wt_plain_ms": cuda_ms(
                        lambda: tw.warp_twopass_t_plain(g, sc), iters),
                    "w_library_ms": cuda_ms(lambda: torch.einsum(
                        "bijr,brjc->bijc", w2, torch.einsum(
                            "brjk,brkc->brjc", w1, imgs)), iters),
                    "wt_library_ms": cuda_ms(lambda: torch.einsum(
                        "brjk,brjc->brkc", w1, torch.einsum(
                            "bijr,bijc->brjc", w2, g)), iters),
                }
                del w1, w2
                # Bound: one image batch read, one written, the scalars; the
                # operations this data needs: per output pixel and pass the
                # taps under its triangle (2 s + 1), each a weight (4 ops)
                # and C multiply-adds.
                nbytes = 2 * imgs.numel() * 4 + sc.numel() * 4
                taps = (2 * sc[:, 3] + 1) + (2 * sc[:, 7] + 1)
                flops = float(taps.sum().item()) * n * n * (4 + 2 * c)
                by_bytes = nbytes / HBM_BYTES_PER_S
                by_ops = flops / F32_FLOPS_PER_S
                row = {"mats": mats_name, "shape": [b, n, n, c],
                       "antialias": antialias, **t,
                       "bound_ms": max(by_bytes, by_ops) * 1e3,
                       "bound_by": "bytes" if by_bytes >= by_ops
                       else "operations", "bytes": nbytes, "flops": flops,
                       "max_abs_err_w": err_w.max().item(),
                       "max_abs_err_wt": err_t.max().item()}
                rows.append(row)
                print("[warp] " + json.dumps(row), flush=True)
    n_stress = _warp_stress(tw, taug, gen, worst)
    print(f"[warp] {n_stress} W and W^T stress cases within tolerance and "
          f"bit-stable, max abs err W {worst['w_stress']:.3e}, W^T "
          f"{worst['wt_stress']:.3e}", flush=True)
    shapes = [(TRAIN_BATCH, TRAIN_RES, 3), (8, TRAIN_RES, 3), (8, 64, 3)] \
        + [(len(_stress_mats()[0]), n, c) for n, c in WARP_STRESS_SHAPES]
    print("[warp] W column band per shape: " + json.dumps(
        {f"[{b},{n},{n},{c}]": tw.warp_band(b, n, c) for b, n, c in shapes}),
        flush=True)
    print(f"[warp] all {len(rows)} cases within tolerance: W max abs err "
          f"{worst['w']:.3e}, W^T {worst['wt']:.3e}, second-order rel "
          f"{worst['second']:.3e}, adjoint rel {worst['adjoint']:.3e}",
          flush=True)
    held = {"warp_twopass": set(tw.warp_twopass.shapes),
            "warp_twopass_t": set(tw.warp_twopass_t.shapes)}
    return rows, worst, held


def _stroke_patch(width):
    import numpy as np
    from brushstroke_engine_torch.data.curated_geometry import \
        curated_geometry_patch
    geom = curated_geometry_patch("curve", 9, width)     # 1 = background
    patch = np.zeros((width, width, 4), np.uint8)
    patch[..., 3] = np.round((1.0 - geom) * 255).astype(np.uint8)
    return patch


def _engine(num_bf16_res, device, trees):
    from brushstroke_engine_torch.flagship import flagship_engine
    return flagship_engine(trees, RES, num_bf16_res, device)


def _stroke_opts(engine):
    import numpy as np
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    opts = GanBrushOptions(
        primary_color=np.array([220, 40, 60], np.uint8))
    opts.set_style(engine.random_style(7), style_id=7)
    opts.set_position(x=1000, y=333)
    opts.enable_uvs_mapping = True
    return opts


def _batch_opts(engine, n):
    import numpy as np
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    out = []
    for i in range(n):
        o = GanBrushOptions(secondary_color=np.array([0, 90, 200], np.uint8)
                            if i % 2 else None)
        o.set_style(engine.random_style(100 + i))
        o.set_position(x=37 * i, y=1000 - 11 * i)
        out.append(o)
    return out


def phase_main_path():
    import numpy as np
    import torch
    from brushstroke_engine_torch.flagship import flagship_trees
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode

    set_precision_mode("strict")
    trees = flagship_trees(RES, SEED, NOISE_STRENGTH)
    engine = _engine(0, "cuda", trees)
    patch = _stroke_patch(RES)
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1   # 6
    geoms = np.stack([engine.prepare_geom_input(np.roll(patch, 8 * i, 1))[0]
                      for i in range(BATCH)])

    fir4_epilogue.launches = 0            # main path starts here
    passes = 0

    out = {}
    for mode in ("clear", "full"):
        engine.set_render_mode(mode)
        opts = _stroke_opts(engine)
        before = fir4_epilogue.launches
        rgba_u8, _ = engine.render_stroke(patch, None, opts)
        torch.cuda.synchronize()
        # clear: the sfactor pass of a new style, then the render.
        new = 2 if mode == "clear" else 1
        passes += new
        check(fir4_epilogue.launches - before == n_up * new,
              f"{mode}: {fir4_epilogue.launches - before} kernel launches "
              f"for {new} generator pass(es), want {n_up * new}")
        check(rgba_u8.shape == (RES, RES, 4) and rgba_u8.dtype == np.uint8,
              f"render_stroke output {rgba_u8.shape} {rgba_u8.dtype}")
        rgba = engine._run_core(engine.prepare_geom_input(patch), opts)["rgba"]
        passes += 1
        rgba = rgba[0].float().cpu().numpy()
        check(np.isfinite(rgba).all(), f"{mode}: non-finite RGBA")
        check(rgba.min() >= -1e-6 and rgba.max() <= 1 + 1e-6,
              f"{mode}: RGBA outside [0, 1]: [{rgba.min()}, {rgba.max()}]")
        out[mode] = (rgba_u8, rgba)
    sfactor = engine.uvs_mapper.sfactors[7]
    print(f"[main] render_stroke clear+full ok, sfactor {sfactor:.6f}, "
          f"alpha mean {out['clear'][1][..., 3].mean():.4f}", flush=True)

    engine.set_render_mode("clear")
    bopts = _batch_opts(engine, BATCH)
    rb = engine.render_batch(geoms, bopts)["rgba"].float()
    passes += 1
    check(tuple(rb.shape) == (BATCH, RES, RES, 4), f"batch {tuple(rb.shape)}")
    check(bool(torch.isfinite(rb).all()), "render_batch: non-finite RGBA")
    check(rb.min().item() >= -1e-6 and rb.max().item() <= 1 + 1e-6,
          "render_batch: RGBA outside [0, 1]")

    # Timing: render_stroke on the host clock (the uint8 copy-out syncs),
    # 3 warm-up calls then 60 timed; the spread shows how far the shared host
    # cores move one call.
    opts = _stroke_opts(engine)
    times = []
    for _ in range(63):
        t0 = time.perf_counter()
        engine.render_stroke(patch, None, opts)
        times.append((time.perf_counter() - t0) * 1e3)
        passes += 1
    times = times[3:]
    deciles = statistics.quantiles(times, n=10)
    stroke = {"p10": deciles[0], "p50": statistics.median(times),
              "p90": deciles[-1], "min": min(times), "max": max(times)}

    def batch_rate(eng, iters=8):
        nonlocal passes
        ts = []
        for i in range(iters + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.render_batch(geoms, _batch_opts(eng, BATCH))
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            passes += 1
        return BATCH / statistics.median(ts[2:])

    f32_rate = batch_rate(engine)
    # bf16 blocks at every res >= 8 (num_bf16_res=6) in 'fast' mode.
    set_precision_mode("fast")
    try:
        engine16 = _engine(6, "cuda", trees)
        rb16 = engine16.render_batch(geoms, _batch_opts(engine16, BATCH))
        rb16 = rb16["rgba"].float()
        passes += 1
        check(bool(torch.isfinite(rb16).all()), "bf16 render_batch non-finite")
        check(rb16.min().item() >= -1e-3 and rb16.max().item() <= 1 + 1e-3,
              "bf16 render_batch: RGBA outside [0, 1]")
        bf16_rate = batch_rate(engine16)
        bf16_vs_f32 = (rb16 - rb).abs().max().item()
    finally:
        set_precision_mode("strict")
    launches = fir4_epilogue.launches     # main path ends here
    check(launches == n_up * passes,
          f"{launches} kernel launches for {passes} generator passes, want "
          f"{n_up * passes}")
    print(f"[main] {passes} generator passes, {launches} fir4_epilogue "
          f"launches ({n_up} per pass)", flush=True)
    print(f"[main] render_stroke ms (f32, clear, UVS, 60 calls): p10 "
          f"{stroke['p10']:.3f} p50 {stroke['p50']:.3f} p90 "
          f"{stroke['p90']:.3f} min {stroke['min']:.3f} max "
          f"{stroke['max']:.3f}; "
          f"render_batch B={BATCH}: f32 {f32_rate:.1f} patches/s, bf16 "
          f"{bf16_rate:.1f} patches/s (max |bf16 - f32| RGBA "
          f"{bf16_vs_f32:.4f})", flush=True)

    # The same requests on the CPU (plain FIR version, strict f32).
    t0 = time.time()
    cpu_engine = _engine(0, "cpu", trees)
    for mode in ("clear", "full"):
        cpu_engine.set_render_mode(mode)
        opts = _stroke_opts(cpu_engine)
        u8, _ = cpu_engine.render_stroke(patch, None, opts)
        rgba = cpu_engine._run_core(cpu_engine.prepare_geom_input(patch),
                                    opts)["rgba"][0].numpy()
        err = float(np.abs(rgba - out[mode][1]).max())
        u8_err = int(np.abs(u8.astype(int) - out[mode][0].astype(int)).max())
        print(f"[main] {mode}: CUDA vs CPU max |RGBA| err {err:.3e}, uint8 "
              f"{u8_err} LSB", flush=True)
        check(err <= RENDER_ATOL, f"{mode}: CUDA vs CPU RGBA err {err}")
        check(u8_err <= 1, f"{mode}: CUDA vs CPU uint8 err {u8_err}")
    cpu_sf = cpu_engine.uvs_mapper.sfactors[7]
    check(abs(cpu_sf - sfactor) <= 1e-3 * abs(cpu_sf),
          f"sfactor CUDA {sfactor} vs CPU {cpu_sf}")
    print(f"[main] CPU reference renders in {time.time() - t0:.1f} s, "
          f"sfactor CPU {cpu_sf:.6f}", flush=True)
    return {"launches": launches, "passes": passes,
            "render_stroke_ms": stroke,
            "render_batch_f32_patches_per_s": f32_rate,
            "render_batch_bf16_patches_per_s": bf16_rate}


def _phase_draws(cfg, b, seed):
    """Explicit draws (CPU tensors) for one Dmain, Dr1, Gmain and Gpl batch
    of size ``b``: noise planes, style mixing, augment draws, PL noise."""
    import torch
    from brushstroke_engine_torch.models.generator import draw_style_mixing
    from brushstroke_engine_torch.train.augment import draw_augment
    gen = torch.Generator().manual_seed(seed)
    syn = cfg.gen_cfg.synthesis
    res = cfg.gen_cfg.img_resolution

    def g_draws(bb):
        noise = {}
        for r in syn.block_resolutions:
            for name in ("conv1",) if r == 4 else ("conv0", "conv1"):
                noise[f"b{r}.{name}"] = torch.randn((bb, r, r, 1),
                                                    generator=gen)
        return {"noise": noise, "mixing": draw_style_mixing(
            gen, (bb, cfg.gen_cfg.z_dim), "cpu")}

    def aug():
        return draw_augment(cfg.augment, gen, b, (res, res, 3), "cpu")

    return {"z": [torch.randn((b, cfg.gen_cfg.z_dim), generator=gen)
                  for _ in range(3)],
            "Dmain": {"g": g_draws(b), "aug_fake": aug(), "aug_real": aug()},
            "Dr1": {"aug": aug()},
            "Gmain": {"g": g_draws(b), "aug": aug()},
            "Gpl": {"g": g_draws(b // 2), "pl_noise": torch.randn(
                (b // 2, res, res, 3), generator=gen)}}


def _four_phases(cfg, device, draws, real_u8, tri_u8):
    """The first Dmain, Dr1, Gmain and Gpl batch from seed-0 weights on
    ``device`` with the given draws; returns ({stat: float}, conv0 weight
    gradient maxima of the Gmain loss)."""
    import torch
    import torch.nn.functional as F
    from brushstroke_engine_torch.flagship import flagship_train_setup
    from brushstroke_engine_torch.train import steps
    from brushstroke_engine_torch.train.dataset import (
        geom_batch_to_float, style_batch_to_float,
    )
    from brushstroke_engine_torch.utils.util import tree_to
    state, enc_p, enc_s = flagship_train_setup(cfg, SEED, NOISE_STRENGTH,
                                               device)
    dev = state["ada_p"].device
    state["ada_p"] = torch.full((), 0.5, device=dev)
    d = tree_to(draws, dev)
    res = cfg.gen_cfg.img_resolution
    real = torch.from_numpy(style_batch_to_float(real_u8)).to(dev)
    tri = torch.from_numpy(geom_batch_to_float(tri_u8)[:, :res, :res]).to(dev)
    enc_p, enc_s = tree_to(enc_p, dev), tree_to(enc_s, dev)
    feats = steps.encode_geometry(cfg, enc_p, enc_s, tri[..., 1:2])
    truth = tri[..., 2:3]
    stats = {}

    # Gradient of the Gmain GAN loss at every conv0 weight (the up-sampling
    # layers, whose epilogue is the FIR kernel on the card).
    gp = steps._trainable(state["g_params"])
    img, _ = steps._run_g(cfg, gp, state, d["z"][1], feats, None,
                          d["Gmain"]["g"])
    logits = steps._run_d(cfg, state["d_params"], img, None, state["ada_p"],
                          d["Gmain"]["aug"])
    grads = steps._grads(F.softplus(-logits).mean(), gp)
    conv0 = {k: float(v["conv0"]["weight"].abs().max())
             for k, v in grads["synthesis"].items() if "conv0" in v}
    del gp, img, logits, grads

    state, s = steps.d_main_step(cfg, state, real, feats, d["z"][0],
                                 draws=d["Dmain"])
    stats.update(s)
    state, s = steps.d_reg_step(cfg, state, real, draws=d["Dr1"])
    stats.update(s)
    state, s = steps.g_main_step(cfg, state, feats, truth, d["z"][1],
                                 ema_beta=0.5, draws=d["Gmain"])
    stats.update(s)
    state, s = steps.g_reg_step(cfg, state, feats, d["z"][2], ema_beta=0.5,
                                draws=d["Gpl"])
    stats.update(s)
    return {k: float(v) for k, v in stats.items()}, conv0


def phase_train(style_iter, geom_iter, card):
    import shutil
    import tempfile
    import numpy as np
    import torch
    from brushstroke_engine_torch.flagship import (
        flagship_train_config, flagship_train_setup,
    )
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from brushstroke_engine_torch.train.loop import LoopHooks, TrainingLoop
    from brushstroke_engine_torch.utils.util import tree_leaves

    set_precision_mode("strict")
    per_tick = dict(geom_interval=8, kimg_per_tick=TRAIN_BATCH / 1000.0)
    cfg = flagship_train_config(TRAIN_RES, TRAIN_BATCH,
                                geom_warmstart_kimg=0, **per_tick)
    state, enc_p, enc_s = flagship_train_setup(cfg, SEED, NOISE_STRENGTH,
                                               "cuda")
    # A mid-training ADA strength, so the warp does more than identity.
    state["ada_p"] = torch.full((), 0.5, device="cuda")
    g0, d0 = tree_leaves(state["g_params"]), tree_leaves(state["d_params"])
    rows = []
    hooks = LoopHooks(on_tick=lambda loop, st: rows.append(dict(st)))
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    n = TRAIN_BATCHES
    try:
        # Every batch is a tick here; the loops persist only when done.
        loop = TrainingLoop(cfg, enc_p, enc_s, style_iter, geom_iter,
                            run_dir, seed=SEED, hooks=hooks,
                            resume_state=state, profile_phases=True,
                            snapshot_ticks=10 ** 9, device="cuda")
        fir4_epilogue.launches = 0        # the training path starts here
        tw.warp_twopass.launches = 0
        tw.warp_twopass_t.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop.run(total_kimg=(n * TRAIN_BATCH - 0.5) / 1000.0)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        check(loop.batch_idx == n, f"{loop.batch_idx} batches, want {n}")

        warm_cfg = flagship_train_config(TRAIN_RES, TRAIN_BATCH, **per_tick)
        warm_rows = []
        warm = TrainingLoop(
            warm_cfg, enc_p, enc_s, style_iter, geom_iter, run_dir,
            seed=SEED + 1, resume_state=loop.state, profile_phases=True,
            hooks=LoopHooks(on_tick=lambda lp, st: warm_rows.append(dict(st))),
            snapshot_ticks=10 ** 9, device="cuda")
        check(warm.in_warmstart(), "the second loop is not in warm start")
        warm.run(total_kimg=(WARM_BATCHES * TRAIN_BATCH - 0.5) / 1000.0)
        torch.cuda.synchronize()
        launches = {"fir4_epilogue": fir4_epilogue.launches,
                    "warp_twopass": tw.warp_twopass.launches,
                    "warp_twopass_t": tw.warp_twopass_t.launches}
        # the training path ends here
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    check(len(rows) == n and len(warm_rows) == WARM_BATCHES,
          f"{len(rows)} + {len(warm_rows)} ticks")
    for i, row in enumerate(rows + warm_rows):
        bad = [k for k, v in row.items() if not np.isfinite(v)]
        check(not bad, f"batch {i}: non-finite stats {bad}")
    for key in ("Loss/D/loss", "Loss/D/reg", "Loss/r1_penalty", "Loss/G/loss",
                "Loss/G/reg", "Loss/pl_penalty", "Loss/forger/Ggeom/total"):
        check(key in rows[0], f"batch 0 ran no phase that reports {key}")
    check(all("Loss/forger/Ggeom-warm/total" in r for r in warm_rows),
          "warm-start batches report no Ggeom-warm loss")
    ada_ps = [r["Progress/ada_p"] for r in rows]
    ada_p = ada_ps[-1]
    check(min(ada_ps) >= 0 and any(p != 0.5 for p in ada_ps),
          f"ada_p never moved from 0.5, or went negative: {ada_ps}")
    for name, before, tree in (("g_params", g0, loop.state["g_params"]),
                               ("d_params", d0, loop.state["d_params"])):
        moved = sum(not torch.equal(a, b)
                    for a, b in zip(before, tree_leaves(tree)))
        check(moved == len(before), f"{name}: {moved}/{len(before)} tensors "
              f"changed")

    # Launch counts against the schedule.  Generator passes: Dmain, Gmain,
    # Gpl, Ggeom and each warm batch, n_up FIR launches each.  W: two
    # discriminator passes in Dmain, one in Dr1 plus one when its penalty is
    # differentiated through W^T, one in Gmain.  W^T: the backward of Dr1's
    # and Gmain's warp.
    sched = {"Dmain": n, "Gmain": n,
             "Dr1": len(range(0, n, cfg.d_reg_interval)),
             "Gpl": len(range(0, n, cfg.g_reg_interval)),
             "Ggeom": len(range(0, n, cfg.geom_interval))}
    n_up = len(cfg.gen_cfg.synthesis.block_resolutions) - 1
    want = {"fir4_epilogue": n_up * (sched["Dmain"] + sched["Gmain"]
                                     + sched["Gpl"] + sched["Ggeom"]
                                     + WARM_BATCHES),
            "warp_twopass": 2 * sched["Dmain"] + 2 * sched["Dr1"]
            + sched["Gmain"],
            "warp_twopass_t": sched["Dr1"] + sched["Gmain"]}
    print(f"[train] launches {json.dumps(launches)} over {n} batches "
          f"{json.dumps(sched)} + {WARM_BATCHES} warm-start batches",
          flush=True)
    check(launches == want, f"kernel launches {launches}, schedule says "
          f"{want}")

    def median(key, rs):
        vals = [r[key] for r in rs if key in r]
        return statistics.median(vals), len(vals)

    phases = {}
    for phase in ("Dmain", "Dreg", "Gmain", "Greg", "Ggeom"):
        # Batch 0 warms up cuDNN's algorithm choice; every phase runs again
        # after it.
        rs = rows[1:]
        sec, cnt = median(f"Timing/{phase}", rs)
        batch = TRAIN_BATCH // 2 if phase == "Greg" else TRAIN_BATCH
        phases[phase] = {"median_s": sec, "timed_batches": cnt,
                         "images_per_s": batch / sec}
    sec, cnt = median("Timing/Ggeom-warm", warm_rows)
    phases["Ggeom-warm"] = {"median_s": sec, "timed_batches": cnt,
                            "images_per_s": TRAIN_BATCH / sec}
    plain = [r["Timing/sec_per_tick"] for r in rows[1:]
             if "Timing/Dreg" not in r and "Timing/Greg" not in r]
    train = {"card": card, "batches": n, "warm_batches": WARM_BATCHES,
             "wall_s": main_s, "images_per_s_overall": n * TRAIN_BATCH / main_s,
             "sec_per_batch_median": statistics.median(
                 r["Timing/sec_per_tick"] for r in rows[1:]),
             "sec_per_batch_dmain_gmain_only": statistics.median(plain),
             "phases": phases, "peak_memory_gib": peak_gb, "ada_p": ada_p,
             "launches": launches, "schedule": sched}
    print("[train] " + json.dumps(train), flush=True)
    for phase, v in phases.items():
        print(f"[train] {phase}: {v['median_s'] * 1e3:.1f} ms median of "
              f"{v['timed_batches']} synchronised batches, "
              f"{v['images_per_s']:.1f} images/s ({card})", flush=True)

    # The card against the CPU: the first Dmain, Dr1, Gmain, Gpl batch at
    # B = 8, same weights, same data, same draws.
    b = 8
    cfg8 = flagship_train_config(TRAIN_RES, b, geom_warmstart_kimg=0)
    draws = _phase_draws(cfg8, b, SEED + 3)
    real_u8 = next(style_iter)[:b]
    tri_u8 = next(geom_iter)[:b]
    fir4_before = fir4_epilogue.launches
    gpu, conv0 = _four_phases(cfg8, "cuda", draws, real_u8, tri_u8)
    check(fir4_epilogue.launches > fir4_before, "B=8 phases: no FIR launch")
    for k, v in conv0.items():
        check(np.isfinite(v) and v > 0,
              f"Gmain passes no gradient to {k}.conv0.weight ({v})")
    print(f"[train] Gmain d loss / d conv0.weight, max abs: "
          f"{json.dumps(conv0)}", flush=True)
    t0 = time.time()
    cpu, conv0_cpu = _four_phases(cfg8, "cpu", draws, real_u8, tri_u8)
    errs = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-3) for k in cpu}
    print("[train] CUDA vs CPU per stat (cuda, cpu, rel err): " + json.dumps(
        {k: [gpu[k], cpu[k], errs[k]] for k in cpu}), flush=True)
    worst = max(errs.values())
    for k, err in errs.items():
        check(err <= TRAIN_RTOL, f"CUDA vs CPU {k}: {gpu[k]} vs {cpu[k]} "
              f"(rel {err:.3e})")
    for k in conv0:
        err = abs(conv0[k] - conv0_cpu[k]) / conv0_cpu[k]
        check(err <= 1e-3, f"CUDA vs CPU conv0 gradient {k}: {conv0[k]} vs "
              f"{conv0_cpu[k]}")
    print(f"[train] CUDA vs CPU, B={b}, Dmain+Dr1+Gmain+Gpl, "
          f"{len(cpu)} stats: worst rel err {worst:.3e} (CPU side "
          f"{time.time() - t0:.1f} s)", flush=True)
    train["cuda_vs_cpu_worst_rel_err"] = worst
    return train


def _timed_hooks(loop):
    """Wraps the loop's eval hooks so that their seconds add up in the
    returned dict under "on_tick" and "on_snapshot"."""
    import torch
    seconds = {}

    def timed(fn, key):
        def call(*a):
            t0 = time.perf_counter()
            fn(*a)
            torch.cuda.synchronize()
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return call

    loop.hooks.on_tick = timed(loop.hooks.on_tick, "on_tick")
    loop.hooks.on_snapshot = timed(loop.hooks.on_snapshot, "on_snapshot")
    return seconds


def _run_cli(cli, argv):
    """``tools/train.py:main`` split at its run call: the loop it builds
    runs with ``profile_phases`` (each phase synchronised and timed) and
    its eval hooks timed.  Returns the loop and the hooks' seconds."""
    loop, args = cli.build(argv)
    loop.profile_phases = True
    hook_s = _timed_hooks(loop)
    loop.run(exit_after_warmstart=args.exit_after_warmstart)
    return loop, hook_s


def _flag_lines(name):
    """A flag file's lines that do not start with '#', as neube_train.sh
    reads them."""
    with open(os.path.join(REPO, name)) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def _finite_stats(path):
    import numpy as np
    with open(path) as f:
        rows = [json.loads(ln) for ln in f]
    check(rows, f"{path}: no stats")
    for i, row in enumerate(rows):
        bad = [k for k, v in row.items() if not np.isfinite(v)]
        check(not bad, f"{path} row {i}: non-finite {bad}")
    return rows


def _resume_bitwise(loop, style_iter, geom_iter, root, tag):
    """X resumes ``loop``'s train state, takes RESUME_N batches, saves, and
    takes RESUME_M more; Y resumes X's save in the same directory and takes
    the same RESUME_M batches.  Fails unless both end bitwise equal, with
    cuDNN's deterministic algorithms (every other op of the step is
    deterministic)."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from brushstroke_engine_torch.train.loop import LoopHooks, TrainingLoop
    from brushstroke_engine_torch.utils.util import tree_leaves

    t0 = time.time()
    cfg, n = loop.cfg, loop.batch_idx
    rcfg = dataclasses.replace(cfg, kimg_per_tick=cfg.batch_size / 1000.0)
    batches = [(next(style_iter), next(geom_iter))
               for _ in range(RESUME_N + RESUME_M)]
    xdir = os.path.join(root, f"resume_{len(os.listdir(root))}")
    os.makedirs(xdir)
    shutil.copy(os.path.join(loop.run_dir, "train_state.pkl"), xdir)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    xs, ys = [], []
    try:
        def make(start, rows):
            return TrainingLoop(
                rcfg, loop.enc_params, loop.enc_state,
                iter([b[0] for b in batches[start:]]),
                iter([b[1] for b in batches[start:]]), xdir,
                seed=SEED + 5, auto_resume=True,
                hooks=LoopHooks(on_tick=lambda lp, st: rows.append(
                    dict(st))),
                snapshot_ticks=10 ** 9, device="cuda")
        x = make(0, xs)
        check((x.cur_nimg, x.batch_idx) == (loop.cur_nimg, n),
              "X did not resume the run's state")
        x.run(total_kimg=(x.cur_nimg + RESUME_N * cfg.batch_size) / 1000.0)
        x.save_train_state()
        y = make(RESUME_N, ys)
        check(y.batch_idx == n + RESUME_N, "Y did not resume X's save")
        end = (x.cur_nimg + RESUME_M * cfg.batch_size) / 1000.0
        x.run(total_kimg=end)
        y.run(total_kimg=end)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    for i, row in enumerate(xs + ys):
        bad = [k for k, v in row.items() if not np.isfinite(v)]
        check(not bad, f"resume row {i}: non-finite {bad}")

    def strip(rs):
        return [{k: v for k, v in r.items() if not k.startswith(
            "Timing/")} for r in rs]
    stats_equal = strip(xs[-RESUME_M:]) == strip(ys[-RESUME_M:])
    leaves = [(a, b) for a, b in zip(tree_leaves(x.state),
                                     tree_leaves(y.state))
              if isinstance(a, torch.Tensor)]
    params_equal = all(torch.equal(a, b) for a, b in leaves)
    ran = sorted({k for r in xs[-RESUME_N - RESUME_M:] for k in r
                  if k.startswith("Loss/")})
    print(f"{tag} resume: X {RESUME_N} + {RESUME_M} batches from the run's "
          f"state (batch {n} on), Y resumed after {RESUME_N}: stats equal "
          f"{stats_equal}, {len(leaves)} state tensors equal {params_equal} "
          f"(bitwise, cudnn.deterministic); phases {ran}; "
          f"{time.time() - t0:.1f} s", flush=True)
    check(stats_equal and params_equal and x.state["d_opt"]["count"]
          == y.state["d_opt"]["count"]
          and x.stitch_rng.getstate() == y.stitch_rng.getstate(),
          "a resumed run is not bitwise the uninterrupted one")
    return ran


def phase_train_cli(style_iter, geom_iter, card, held):
    """The training run as neube_train.sh runs it, through the port's CLI
    (see the module doc, phase 10).  ``held``: the K1 shapes phase 3 held
    against the plain version."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.metrics import fid as fid_lib
    from brushstroke_engine_torch.metrics import lpips as lpips_lib
    from brushstroke_engine_torch.metrics.metric_main import \
        forger_compute_fid
    from brushstroke_engine_torch.metrics.stroke_generator import (
        PaintStrokeGenerator, RandomState,
    )
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from brushstroke_engine_torch.tools import bench_serve as bs
    from brushstroke_engine_torch.tools import train as cli
    from brushstroke_engine_torch.train.dataset import NoiseStyleDataset
    from brushstroke_engine_torch.train.eval_hooks import _engine_from_loop
    from brushstroke_engine_torch.ui.core import create_core
    from brushstroke_engine_torch.utils.checkpoint import load_native
    from brushstroke_engine_torch.utils.util import tree_leaves

    set_precision_mode("strict")       # what a fresh CLI process runs in
    t_phase = time.time()
    train_flags = _flag_lines("train_flags.txt")
    cuts = CLI_CUTS
    print(f"[cli] train_flags.txt with these cuts: {' '.join(cuts)} (no "
          f"--data: seeded noise styles; no --geom_data: synthetic "
          f"geometry; --num_bf16_res {cli.build_parser().get_default('num_bf16_res')} "
          f"and --metrics {cli.build_parser().get_default('metrics')} "
          f"at their defaults)", flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out = {"card": card, "cuts": cuts}
    try:
        # ---- 1. the CLI run -------------------------------------------
        fir4_epilogue.launches = 0   # the CLI run starts here
        fir4_epilogue.shapes.clear()
        tw.warp_twopass.launches = 0
        tw.warp_twopass_t.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop, hook_s = _run_cli(cli, ["--outdir", root, "--device", "cuda"]
                                + train_flags + cuts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fir4_epilogue": fir4_epilogue.launches,
                    "warp_twopass": tw.warp_twopass.launches,
                    "warp_twopass_t": tw.warp_twopass_t.launches}
        # the CLI run ends here
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        cfg, run = loop.cfg, loop.run_dir
        check(cfg.gen_cfg.synthesis.num_bf16_res == 4
              and cfg.disc_cfg.num_bf16_res == 4
              and cfg.disc_cfg.architecture == "orig",
              "the CLI run is not the canonical bf16 'orig'-D configuration")
        n = loop.batch_idx
        warm = int(np.ceil(cfg.geom_warmstart_kimg * 1000 / cfg.batch_size))
        check(n == max(1, int(np.ceil(cfg.total_kimg * 1000
                                      / cfg.batch_size))),
              f"{n} batches for {cfg.total_kimg} kimg")

        # ---- 2. what the run leaves -----------------------------------
        snap = os.path.join(run, f"network-snapshot-"
                                 f"{loop.cur_nimg // 1000:06d}.pkl")
        for name in ("training_options.json", "stats.jsonl",
                     "train_state.pkl", snap, "summary_metrics.txt"):
            check(os.path.isfile(os.path.join(run, name)),
                  f"the CLI run left no {name}")
        tag = f"{loop.cur_nimg // 1000:06d}"
        sheets = sorted(os.listdir(os.path.join(run, "viz")))
        check(sheets == [f"{k}_{tag}.png" for k in
                         ("color_control", "fakes", "geom_control")],
              f"viz sheets {sheets}")
        for name in sheets:
            with open(os.path.join(run, "viz", name), "rb") as f:
                check(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name}: no PNG")
        rows = _finite_stats(os.path.join(run, "stats.jsonl"))
        with open(os.path.join(run, "summary_metrics.txt")) as f:
            head, line = f.read().splitlines()[:2]
        forger = dict(zip(head.split()[1:], map(float, line.split()[1:])))
        check(set(forger) == FORGER_KEYS and all(
            np.isfinite(v) for v in forger.values()),
            f"summary_metrics.txt: {forger}")

        # ---- 3. no hook failed ----------------------------------------
        failures = {k: v for r in rows for k, v in r.items()
                    if k.startswith("Eval/")}
        check(not loop.hook_failure_counts and not any(failures.values()),
              f"eval hooks failed: {loop.hook_failure_counts} {failures}")

        # ---- 4. launches against the schedule -------------------------
        main = n - warm
        sched = {"warm": warm, "Dmain": main, "Gmain": main,
                 "Dr1": sum(1 for i in range(warm, n)
                            if i % cfg.d_reg_interval == 0),
                 "Gpl": sum(1 for i in range(warm, n)
                            if i % cfg.g_reg_interval == 0),
                 "Ggeom": sum(1 for i in range(warm, n)
                              if i % cfg.geom_interval == 0)}
        timed = {k: len(v) for k, v in loop.phase_seconds.items()}
        check(all(timed.get(k if k != "warm" else "Ggeom-warm", 0) == v
                  for k, v in (("Dmain", sched["Dmain"]),
                               ("Gmain", sched["Gmain"]),
                               ("Dreg", sched["Dr1"]),
                               ("Greg", sched["Gpl"]),
                               ("Ggeom", sched["Ggeom"]),
                               ("warm", sched["warm"]))),
              f"phases ran {timed}, the schedule says {sched}")
        check(sched["Dr1"] and sched["Gpl"] and sched["Ggeom"]
              and timed.get("ada", 0) > 0,
              f"a phase never ran after the warm start: {sched} {timed}")
        n_up = len(cfg.gen_cfg.synthesis.block_resolutions) - 1
        # Generator passes of the hooks: the visualizer's fakes and geometry
        # sheets and one per color of its color sheet; the metric loop's two
        # renders per style.
        viz_passes = 2 + VIZ_COLORS
        metric_passes = 2 * METRIC_STYLES
        want = {"fir4_epilogue": n_up * (
                    sched["warm"] + sched["Dmain"] + sched["Gmain"]
                    + sched["Gpl"] + sched["Ggeom"] + viz_passes
                    + metric_passes),
                "warp_twopass": 2 * sched["Dmain"] + 2 * sched["Dr1"]
                + sched["Gmain"],
                "warp_twopass_t": sched["Dr1"] + sched["Gmain"]}
        print(f"[cli] launches {json.dumps(launches)} over {n} batches "
              f"{json.dumps(sched)} + {viz_passes} viz and {metric_passes} "
              f"metric generator passes (K1's backward re-runs the plain "
              f"chain: no launch)", flush=True)
        check(launches == want, f"CLI run launches {launches}, schedule "
              f"says {want}")

        def med(phase):
            v = loop.phase_seconds.get(phase, [])
            return statistics.median(v[1:] if len(v) > 2 else v), len(v)

        phases = {}
        for phase in ("Ggeom-warm", "Dmain", "Dreg", "Gmain", "Greg",
                      "Ggeom"):
            if phase not in loop.phase_seconds:
                continue
            sec, cnt = med(phase)
            batch = cfg.batch_size // cfg.pl_batch_shrink \
                if phase == "Greg" else cfg.batch_size
            phases[phase] = {"median_s": sec, "calls": cnt,
                             "images_per_s": batch / sec}
        train_s = sum(sum(v) for v in loop.phase_seconds.values())
        out.update({
            "batches": n, "warm_batches": warm, "wall_s": wall,
            "train_phases_s": train_s,
            "sec_per_batch": train_s / n,
            "images_per_s": n * cfg.batch_size / train_s,
            "phases": phases, "peak_memory_gib": peak_gb,
            "snapshot_sec": loop._last_snapshot_sec,
            "hooks_s": hook_s, "launches": launches, "schedule": sched,
            "forger": forger})
        print("[cli] " + json.dumps(out), flush=True)
        for phase, v in phases.items():
            print(f"[cli] {phase}: {v['median_s'] * 1e3:.1f} ms median of "
                  f"{v['calls']} calls, {v['images_per_s']:.1f} images/s, "
                  f"bf16 at 16-128 px ({card})", flush=True)
        print(f"[cli] {n} batches: {out['sec_per_batch']:.3f} s/batch in the "
              f"phases, {wall:.1f} s wall with the data, the eval hooks "
              f"({json.dumps(hook_s)}) and Timing/snapshot_sec "
              f"{out['snapshot_sec']:.2f}; peak {peak_gb:.1f} GiB ({card})",
              flush=True)

        # ---- 5. resume ------------------------------------------------
        _resume_bitwise(loop, style_iter, geom_iter, root, "[cli]")
        out["resume_bitwise"] = True

        # ---- 6. the clarity finetune ----------------------------------
        finetune = train_flags + _flag_lines("finetune_flags.txt") + [
            "--resume", snap, "--geom_warmstart_kimg",
            str(FINETUNE_WARM_KIMG)]
        check("--exit_after_warmstart" in finetune,
              "finetune_flags.txt lost --exit_after_warmstart")
        ft, hook_ft = _run_cli(cli, ["--outdir", root, "--device", "cuda"]
                               + finetune)
        bundle = load_native(snap, device="cuda")
        check(ft.g_orig_params is not None and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(ft.g_orig_params),
                tree_leaves(bundle.gen_params))),
              "the finetune's G_orig is not the frozen resumed snapshot")
        ft_rows = _finite_stats(ft.stats_path)
        lp = [r.get("Loss/forger/Ggeom-warm/lpips_fake_orig") for r in
              ft_rows]
        check(all(v is not None and np.isfinite(v) and v > 0 for v in lp),
              f"finetune LPIPS term {lp}")
        ft_snaps = [f for f in os.listdir(ft.run_dir)
                    if f.startswith("network-snapshot-")]
        check(ft_snaps and ft.batch_idx == int(np.ceil(
            FINETUNE_WARM_KIMG * 1000 / cfg.batch_size)),
            f"finetune: {ft.batch_idx} batches, snapshots {ft_snaps}")
        ft_step = ft.phase_seconds["Ggeom-warm"]
        out["finetune"] = {
            "batches": ft.batch_idx, "lpips_fake_orig": lp,
            "step_s_median": statistics.median(ft_step[1:] or ft_step),
            "step_s": ft_step, "hooks_s": hook_ft}
        print("[cli] finetune " + json.dumps(out["finetune"]), flush=True)

        # ---- 7. FID ---------------------------------------------------
        engine = PaintEngineFactory.create(snap, device="cuda")
        style_ds = NoiseStyleDataset(cfg.gen_cfg.img_resolution)
        real = [np.stack([style_ds[j] for j in range(i, i + 16)])
                for i in range(0, FID_ITEMS, 16)]

        def fid_geometry():
            while True:
                g = next(geom_iter)
                for i in range(0, g.shape[0], FID_BATCH):
                    yield g[i:i + FID_BATCH]

        gen = PaintStrokeGenerator(FID_BATCH, engine, RandomState(0))
        gen.set_geometry_source_from_iterator(fid_geometry(), FID_BATCH)
        fir_before = fir4_epilogue.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fid = forger_compute_fid(gen, real, num_items=FID_ITEMS)
        torch.cuda.synchronize()
        fid_s = time.perf_counter() - t0
        check(np.isfinite(fid) and fid > 0, f"FID {fid}")
        check(fir4_epilogue.launches - fir_before
              == n_up * FID_ITEMS // FID_BATCH, "FID: K1 launches")
        # One fixed batch on the card and on the CPU.
        imgs = torch.as_tensor(real[0][:8], device="cuda")
        rend = gen.generate()[..., :3] * 2 - 1
        lp_gpu = lpips_lib.lpips_batched(imgs.float() / 127.5 - 1, rend)
        lp_cpu = lpips_lib.lpips_batched(imgs.cpu().float() / 127.5 - 1,
                                         rend.cpu())
        f_gpu = fid_lib.extract_features(imgs)
        f_cpu = fid_lib.extract_features(imgs.cpu())
        lp_err = ((lp_gpu.cpu() - lp_cpu).abs() / lp_cpu.abs()).max().item()
        f_err = ((f_gpu.cpu() - f_cpu).abs().max()
                 / f_cpu.abs().max()).item()
        check(lp_err <= METRIC_RTOL and f_err <= METRIC_RTOL,
              f"card vs CPU: LPIPS rel err {lp_err:.3e}, detector "
              f"features {f_err:.3e}")
        out["fid"] = {"value": fid, "items": FID_ITEMS, "batch": FID_BATCH,
                      "seconds": fid_s,
                      "detector": fid_lib.default_detector_kind("cuda"),
                      "lpips_card_vs_cpu": lp_err,
                      "features_card_vs_cpu": f_err}
        print("[cli] fid " + json.dumps(out["fid"]), flush=True)

        # ---- 8. the snapshot serves -----------------------------------
        live = _engine_from_loop(loop)
        geom = _stroke_patch(cfg.gen_cfg.img_resolution)
        worst = 0
        for mode, seed in (("clear", 1), ("clear", 2), ("full", 3)):
            imgs = []
            for eng in (engine, live):
                eng.set_render_mode(mode)
                opts = _stroke_opts(eng)
                opts.set_style(eng.random_style(seed))
                imgs.append(eng.render_stroke(geom, None, opts)[0])
            worst = max(worst, _u8_err(*imgs))
        check(worst <= 1, f"the loaded snapshot renders {worst} LSB off "
              f"the training loop's engine")
        core = create_core(gan_checkpoint=snap, device="cuda")
        try:
            stats, painters = bs.serve(
                core, "helper", 1, SNAP_SERVE_STROKES, 1, canvas=512,
                level=PAINT_LEVEL, crop=PAINT_CROP, seed=SEED,
                trace_strokes=0)
        finally:
            core.close()
        check(stats["fallbacks"] == 0 and stats["errors"] == 0
              and stats["strokes_served"] == SNAP_SERVE_STROKES + 1,
              f"serving the snapshot: {stats['strokes_served']} strokes, "
              f"{stats['fallbacks']} fallbacks, {stats['errors']} errors")
        out["serve"] = {"loaded_vs_live_lsb": worst,
                        "strokes": stats["strokes_served"],
                        "client_ms_p50": stats["client_ms"]["p50"]}
        print("[cli] snapshot serve " + json.dumps(out["serve"]), flush=True)

        # ---- 9. every K1 shape of this phase was held in phase 3 ------
        # The CLI run, the resume loops, the finetune, FID, the loaded and
        # live engines' strokes and the served ones.
        launched = sorted(fir4_epilogue.shapes)
        check(set(launched) <= held, f"K1 launched at shapes phase 3 did "
              f"not hold against the plain version: "
              f"{sorted(set(launched) - held)}")
        out["k1_shapes"] = [list(k) for k in launched]
        print(f"[cli] K1 launched at {len(launched)} shapes, each held in "
              f"phase 3: {json.dumps(out['k1_shapes'])}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    print(f"[cli] phase {out['seconds']:.1f} s", flush=True)
    return out


def _quantiles(times):
    deciles = statistics.quantiles(times, n=10)
    return {"p10": deciles[0], "p50": statistics.median(times),
            "p90": deciles[-1], "n": len(times)}


def _full_strokes(n, canvas):
    """``n`` overlapping full-patch origins (x, y) along a diagonal, each
    reaching canvas the earlier ones did not; even, as level 2 aligns."""
    step, drop = RES * 3 // 16, RES * 5 // 32
    return [((i * step) % (canvas - RES) // 2 * 2,
             (RES // 16 + i * drop) % (canvas - RES) // 2 * 2)
            for i in range(n)]


def _partial_strokes(canvas):
    """(x, y, rows, cols) of smaller-than-patch strokes in corners the full
    strokes leave blank, the last against the right edge."""
    return [(int(fx * canvas), int(fy * canvas), int(fh * RES),
             int(fw * RES)) for fx, fy, fh, fw in (
                 (0.04, 0.76, 0.375, 0.5), (0.2, 0.88, 0.25, 0.25),
                 (0.78, 0.04, 0.47, 0.625), (1 - 0.25 * RES / canvas, 0.3,
                                             0.31, 0.25))]


def _paint_helper_run(engine, strokes, canvas, checked):
    """Paint ``strokes`` ((x, y, rows, cols)) through a PaintingHelper at
    level 2 with crop margin 10; if ``checked``, hold each stroke's shape,
    metadata, K1 launches and mask growth.  Returns (helper, images,
    seconds per stroke)."""
    import numpy as np
    from brushstroke_engine_torch.engine.canvas import PaintingHelper
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1
    helper = PaintingHelper(engine, style_seed=SEED)
    helper.make_new_canvas(canvas, canvas, feature_blending=PAINT_LEVEL)
    opts = helper.default_brush_options()
    patch = _stroke_patch(RES)
    cm = PAINT_CROP
    images, times, covered = [], [], 0
    for i, (x, y, h, w) in enumerate(strokes):
        before = fir4_epilogue.launches
        opts.set_position(x, y)
        t0 = time.perf_counter()
        img, _, meta = helper.render_stroke(
            np.roll(patch, 8 * i, 1)[:h, :w], None, opts,
            meta={"x": x, "y": y, "crop_margin": cm})
        times.append(time.perf_counter() - t0)
        images.append((img, meta))
        if not checked:
            continue
        tag = f"stroke {i} at ({x}, {y}) {h}x{w}"
        check(img.shape == (RES - 2 * cm, RES - 2 * cm, 4)
              and img.dtype == np.uint8, f"{tag}: image {img.shape}")
        gx, gy = meta["x"] - cm, meta["y"] - cm
        if (h, w) == (RES, RES):
            check((gx, gy) == (x, y), f"{tag}: meta {meta}")
        check(0 <= gx <= canvas - RES and 0 <= gy <= canvas - RES
              and gx <= x and gx + RES >= x + w and gy <= y
              and gy + RES >= y + h, f"{tag}: window {meta} misses it")
        check(fir4_epilogue.launches - before == n_up,
              f"{tag}: {fir4_epilogue.launches - before} K1 launches")
        now = int(helper.feature_canvas.mask.sum())
        check(now > covered, f"{tag}: the feature mask did not grow")
        covered = now
    return helper, images, times


def _session_run(engine, positions, canvas, checked):
    """DevicePaintSession strokes at ``positions``; if ``checked``, hold
    shapes, metadata, K1 launches and that the canvas stays the same CUDA
    tensors.  Returns (session, images, seconds per stroke)."""
    import numpy as np
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    from brushstroke_engine_torch.engine.device_canvas import \
        DevicePaintSession
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1
    session = DevicePaintSession(engine, canvas, canvas,
                                 feature_blending_level=PAINT_LEVEL,
                                 crop_margin=PAINT_CROP)
    ptrs = (session.canvas.features.data_ptr(),
            session.canvas.mask.data_ptr())
    opts = GanBrushOptions()
    opts.set_style(engine.random_style(11), style_id=11)
    patch = _stroke_patch(RES)
    images, times = [], []
    for i, (x, y) in enumerate(positions):
        before = fir4_epilogue.launches
        t0 = time.perf_counter()
        img, meta = session.render_stroke(np.roll(patch, 8 * i, 0), opts,
                                          x=x, y=y)
        times.append(time.perf_counter() - t0)
        images.append((img, meta))
        if not checked:
            continue
        c = session.canvas
        check(img.shape == (RES - 2 * PAINT_CROP,) * 2 + (4,)
              and meta == {"x": x + PAINT_CROP, "y": y + PAINT_CROP},
              f"session stroke {i}: {img.shape} {meta}")
        check(fir4_epilogue.launches - before == n_up,
              f"session stroke {i}: {fir4_epilogue.launches - before} K1 "
              f"launches")
        check(c.features.is_cuda and c.mask.is_cuda and
              (c.features.data_ptr(), c.mask.data_ptr()) == ptrs,
              f"session stroke {i}: the canvas left the card or was "
              f"reallocated")
    return session, images, times


def _stylizers(engine, geom, batch):
    """name -> a call of that stylizer on ``geom`` with the paint phase's
    margins and blending; ``batch`` None = each one's default."""
    from brushstroke_engine_torch.engine.canvas import PaintingHelper
    from brushstroke_engine_torch.engine import stylize as st
    kw = dict(overlap_margin=STYLIZE_OVERLAP, crop_margin=PAINT_CROP,
              feature_blending_level=PAINT_LEVEL)
    bkw = {} if batch is None else {"batch_size": batch}
    return {
        "sequential": lambda o: st.stylize_image(
            PaintingHelper(engine, style_seed=SEED), geom, o, **kw),
        "batched": lambda o: st.stylize_image_batched(engine, geom, o,
                                                      **kw, **bkw),
        "ondevice": lambda o: st.stylize_image_ondevice(engine, geom, o,
                                                        **kw, **bkw),
    }


def _style_opts(engine, seed):
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    opts = GanBrushOptions()
    opts.set_style(engine.random_style(seed), style_id=seed)
    return opts


def _u8_err(a, b):
    return int(abs(a.astype(int) - b.astype(int)).max())


def phase_paint(card):
    import numpy as np
    import torch
    from brushstroke_engine_torch.data.curves import line_drawing
    from brushstroke_engine_torch.engine import stylize as st
    from brushstroke_engine_torch.flagship import (
        flagship_engine, flagship_trees,
    )
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode

    set_precision_mode("strict")
    t_phase = time.time()
    trees = flagship_trees(RES, SEED, NOISE_STRENGTH)
    trees_c = flagship_trees(RES, SEED, NOISE_STRENGTH, "canvas")
    engine = _engine(0, "cuda", trees)
    cengine = flagship_engine(trees_c, RES, 0, "cuda", "canvas")
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1
    t0 = time.perf_counter()
    drawing = line_drawing(STYLIZE_SIZE, STYLIZE_STROKES, SEED)
    print(f"[paint] {STYLIZE_SIZE}^2 line drawing ({STYLIZE_STROKES} strokes) "
          f"drawn on the host in {time.perf_counter() - t0:.2f} s", flush=True)
    padded, stride = st.pad_geometry(drawing, RES, STYLIZE_OVERLAP)
    crops = st.generate_stitching_crops(padded.shape, RES, STYLIZE_OVERLAP,
                                        geom=padded)
    # Generator passes per image: one per tile, or one per chunk of the
    # wave renderers' default batches (16 and 32).
    chunks = {"sequential": len(crops),
              "batched": len(st._prepare_wave_chunks(crops, stride, 16)[0]),
              "ondevice": len(st._prepare_wave_chunks(crops, stride, 32)[0])}
    out = {"card": card}

    fir4_epilogue.launches = 0            # the paint path starts here
    passes = 0
    # PaintingHelper: 12 overlapping full strokes and 4 partial patches,
    # each checked, then PAINT_TIMED strokes on a new canvas of the same
    # size; the first of those has nothing stored to blend, so its time is
    # left out of the quantiles.
    full = [(x, y, RES, RES) for x, y in _full_strokes(12, PAINT_CANVAS)]
    helper, _, _ = _paint_helper_run(
        engine, full + _partial_strokes(PAINT_CANVAS), PAINT_CANVAS, True)
    passes += 16
    feats = helper.feature_canvas.features
    check(feats.is_cuda and tuple(feats.shape) == (
        1, PAINT_CANVAS // 2, PAINT_CANVAS // 2,
        engine.gen_cfg.synthesis.channels(RES // 2)),
        f"feature canvas {tuple(feats.shape)} on {feats.device}")
    check(bool(torch.isfinite(feats).all()), "non-finite feature canvas")
    timed = [(x, y, RES, RES) for x, y in
             _full_strokes(PAINT_TIMED, PAINT_CANVAS)]
    _, _, times = _paint_helper_run(engine, timed, PAINT_CANVAS, False)
    passes += PAINT_TIMED
    out["helper_stroke_ms"] = _quantiles([t * 1e3 for t in times[1:]])
    out["feature_canvas_mib"] = feats.numel() * feats.element_size() / 2 ** 20
    print(f"[paint] PaintingHelper {PAINT_CANVAS}^2 level {PAINT_LEVEL}: 16 "
          f"strokes checked (shapes, meta, mask growth, {n_up} K1 launches "
          f"each); feature canvas {out['feature_canvas_mib']:.0f} MiB on "
          f"the card; blended stroke ms p10/p50/p90 "
          f"{out['helper_stroke_ms']['p10']:.3f} / "
          f"{out['helper_stroke_ms']['p50']:.3f} / "
          f"{out['helper_stroke_ms']['p90']:.3f} ({card})", flush=True)

    # DevicePaintSession: 3 warm-up strokes, then PAINT_TIMED.
    positions = [(x, y) for x, y, _, _ in timed[:3] + timed]
    session, _, times = _session_run(engine, positions, PAINT_CANVAS, True)
    passes += len(positions)
    check(bool(torch.isfinite(session.canvas.features).all())
          and session.canvas.mask.sum().item() > 0, "session canvas")
    out["session_stroke_ms"] = _quantiles([t * 1e3 for t in times[3:]])
    print(f"[paint] DevicePaintSession {PAINT_CANVAS}^2: {len(positions)} "
          f"strokes checked, canvas on the card throughout; stroke ms "
          f"p10/p50/p90 {out['session_stroke_ms']['p10']:.3f} / "
          f"{out['session_stroke_ms']['p50']:.3f} / "
          f"{out['session_stroke_ms']['p90']:.3f} ({card})", flush=True)
    del helper, session

    # The three stylizers on the 2048-px drawing: one warm-up call each,
    # then one timed call.
    out["stylize"] = {"size": STYLIZE_SIZE, "padded": list(padded.shape),
                      "tiles": len(crops), "chunks": chunks}
    results = {}
    for name, fn in _stylizers(engine, drawing, None).items():
        for rep in range(2):
            before = fir4_epilogue.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            canvas = fn(_style_opts(engine, 7))
            sec = time.perf_counter() - t0
            passes += chunks[name]
            check(fir4_epilogue.launches - before == n_up * chunks[name],
                  f"{name}: {fir4_epilogue.launches - before} K1 launches "
                  f"for {chunks[name]} generator passes")
        check(canvas.shape == padded.shape + (4,) and canvas.dtype == np.uint8
              and canvas[..., 3].max() > 0, f"{name}: canvas {canvas.shape}")
        results[name] = canvas
        out["stylize"][name] = {"seconds": sec, "tiles_per_s": len(crops) / sec}
        print(f"[paint] {name} stylize {STYLIZE_SIZE}^2 ({len(crops)} tiles, "
              f"{chunks[name]} generator passes): {sec:.3f} s, "
              f"{len(crops) / sec:.1f} tiles/s ({card})", flush=True)
    wave_err = _u8_err(results["batched"], results["ondevice"])
    check(wave_err <= 1, f"batched vs ondevice waves: {wave_err} LSB")

    # The canvas-format engine: its four modes, then one blended stroke.
    cpatch = _stroke_patch(RES)
    modes = {}
    for mode in ("clear", "stroke", "canvas", "full"):
        cengine.set_render_mode(mode)
        opts = _stroke_opts(cengine)
        opts.enable_uvs_mapping = False
        before = fir4_epilogue.launches
        u8, _ = cengine.render_stroke(cpatch, None, opts)
        rgba = cengine._run_core(cengine.prepare_geom_input(cpatch),
                                 opts)["rgba"][0].cpu().numpy()
        passes += 2
        check(fir4_epilogue.launches - before == 2 * n_up,
              f"canvas engine {mode}: K1 launches")
        check(u8.shape == (RES, RES, 4) and np.isfinite(rgba).all(),
              f"canvas engine {mode}: output {u8.shape}")
        # The generated canvas color is the head's raw output (no tanh), so
        # only the stroke modes stay inside [0, 1] before the uint8 clip.
        if mode in ("clear", "stroke"):
            check(rgba.min() >= -1e-6 and rgba.max() <= 1 + 1e-6,
                  f"canvas engine {mode}: RGBA outside [0, 1]")
        if mode != "clear":
            check(bool((rgba[..., 3] == 1).all()), f"{mode}: alpha != 1")
        modes[mode] = (u8, rgba)
    cengine.set_render_mode("clear")
    chelper, cimgs, _ = _paint_helper_run(
        cengine, [(0, 0, RES, RES), (RES // 4, RES // 8, RES, RES)],
        CMP_CANVAS, True)
    passes += 2
    launches = fir4_epilogue.launches     # the paint path ends here
    check(launches == n_up * passes,
          f"{launches} K1 launches for {passes} generator passes")
    out.update(launches=launches, passes=passes)
    print(f"[paint] canvas engine: 4 modes + 2 blended strokes ok; paint "
          f"path {passes} generator passes, {launches} fir4_epilogue "
          f"launches ({n_up} per pass)", flush=True)

    # CUDA against the CPU on smaller requests.
    t_cpu = 0.0
    cmp = {}
    cpu_engine = _engine(0, "cpu", trees)
    cpu_cengine = flagship_engine(trees_c, RES, 0, "cpu", "canvas")
    strokes = [(0, 0, RES, RES), (RES * 3 // 8, RES // 4, RES, RES),
               (CMP_CANVAS - RES * 3 // 4, CMP_CANVAS * 5 // 8,
                RES * 3 // 8, RES * 5 // 16)]
    pos = [(x, y) for x, y, _, _ in strokes[:2]] + [(CMP_CANVAS - RES,) * 2]
    runs = {}
    for dev, eng in (("cuda", engine), ("cpu", cpu_engine)):
        t0 = time.time()
        h, imgs, _ = _paint_helper_run(eng, strokes, CMP_CANVAS, False)
        s, simgs, _ = _session_run(eng, pos, CMP_CANVAS, False)
        runs[dev] = (h.feature_canvas, imgs, s.canvas, simgs)
        if dev == "cpu":
            t_cpu += time.time() - t0
    (hc, ic, sc, sic), (hp, ip, sp, sip) = runs["cuda"], runs["cpu"]
    cmp["helper_u8"] = max(_u8_err(a[0], b[0]) for a, b in zip(ic, ip))
    check(all(a[1] == b[1] for a, b in zip(ic, ip)), "helper meta CUDA/CPU")
    check(bool((hc.mask == hp.mask).all()), "helper mask CUDA vs CPU")
    cmp["helper_features"] = (hc.features.cpu() - hp.features).abs().max() \
        .item()
    cmp["session_u8"] = max(_u8_err(a[0], b[0]) for a, b in zip(sic, sip))
    check(torch.equal(sc.mask.cpu(), sp.mask), "session mask CUDA vs CPU")
    cmp["session_features"] = (sc.features.cpu() - sp.features).abs().max() \
        .item()
    small = line_drawing(CMP_DRAWING, 6, SEED + 1, span=CMP_DRAWING // 2)
    for name in ("sequential", "batched", "ondevice"):
        a = _stylizers(engine, small, None)[name](_style_opts(engine, 7))
        t0 = time.time()
        b = _stylizers(cpu_engine, small, CMP_BATCH)[name](
            _style_opts(cpu_engine, 7))
        t_cpu += time.time() - t0
        cmp[f"stylize_{name}_u8"] = _u8_err(a, b)
    t0 = time.time()
    cmode_err = 0.0
    for mode, (u8, rgba) in modes.items():
        cpu_cengine.set_render_mode(mode)
        opts = _stroke_opts(cpu_cengine)
        opts.enable_uvs_mapping = False
        ref = cpu_cengine._run_core(cpu_cengine.prepare_geom_input(cpatch),
                                    opts)["rgba"][0].numpy()
        cmode_err = max(cmode_err, float(abs(ref - rgba).max()))
        ref_u8 = np.clip(ref * 255.0, 0, 255).astype(np.uint8)
        cmp[f"canvas_{mode}_u8"] = _u8_err(u8, ref_u8)
    cpu_cengine.set_render_mode("clear")
    _, cpu_cimgs, _ = _paint_helper_run(
        cpu_cengine, [(0, 0, RES, RES), (RES // 4, RES // 8, RES, RES)],
        CMP_CANVAS, False)
    cmp["canvas_blended_u8"] = max(_u8_err(a[0], b[0])
                                   for a, b in zip(cimgs, cpu_cimgs))
    t_cpu += time.time() - t0
    cmp["canvas_rgba"] = cmode_err
    print("[paint] CUDA vs CPU (uint8 LSB, f32 max abs): " + json.dumps(cmp),
          flush=True)
    for k, v in cmp.items():
        lim = 1 if k.endswith("_u8") else RENDER_ATOL
        check(v <= lim, f"paint CUDA vs CPU {k}: {v} > {lim}")
    out["cuda_vs_cpu"] = cmp
    out["cpu_seconds"] = t_cpu
    out["seconds"] = time.time() - t_phase
    print(f"[paint] phase {out['seconds']:.1f} s (CPU references "
          f"{t_cpu:.1f} s)", flush=True)
    print("[paint] " + json.dumps(out), flush=True)
    return out


def phase_serve(card):
    """The drawing server's core on the card through its four image paths
    (see the module doc, phase 9)."""
    import numpy as np
    from brushstroke_engine_torch.flagship import (
        flagship_encoder_config, flagship_generator_config, flagship_trees,
    )
    from brushstroke_engine_torch.ops.cuda_build import BUILD_DIR
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from brushstroke_engine_torch.tools import bench_serve as bs
    from brushstroke_engine_torch.ui.core import (
        WARM_BATCHES, create_core, warmup_engine,
    )
    from brushstroke_engine_torch.utils.checkpoint import (
        EngineBundle, params_from_jax, save_native,
    )

    set_precision_mode("strict")
    t_phase = time.time()
    trees = {k: params_from_jax(v) for k, v in
             flagship_trees(RES, SEED, NOISE_STRENGTH).items()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    bundle_path = os.path.join(BUILD_DIR, "serve_flagship.pkl")
    save_native(bundle_path, EngineBundle(
        flagship_generator_config(RES, (0, 1)), trees["gen_params"],
        trees["gen_state"], flagship_encoder_config(), trees["enc_params"],
        trees["enc_state"], geom_inject_resolutions=(0, 1)))
    core = create_core(gan_checkpoint=bundle_path, device="cuda")
    engine = core.engine
    check(engine.device.type == "cuda" and engine.patch_width == RES,
          f"served engine {engine.device} {engine.patch_width} px")
    warmup_engine(engine)
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1
    kw = dict(canvas=SERVE_CANVAS, level=PAINT_LEVEL, crop=PAINT_CROP,
              seed=SEED)
    want_path = {"helper": "helper", "device_canvas": "device_canvas",
                 "batched": "batched", "pooled": "device_batched"}
    runs, launches, served, passes, worst = [], 0, 0, 0, 0
    flush_batches = set()
    for path in bs.PATHS:
        for sessions, strokes, warm in SERVE_RUNS:
            tag = f"{path} x{sessions}"
            serving = bs.make_core(engine, path, SERVE_WINDOW_MS,
                                   SERVE_CANVAS, PAINT_LEVEL, PAINT_CROP)
            fir4_epilogue.launches = 0    # this serve run starts here
            stats, painters = bs.serve(
                serving, path, sessions, strokes, warm,
                trace_strokes=SERVE_TRACE, keep_images=True, **kw)
            n = fir4_epilogue.launches    # and ends here
            serving.close()
            # Every batch a flush of this run launched K1 at (warm-up
            # included) was held against the plain version in phase 3.
            flushed = {b for bt in (serving.batcher, serving.dev_batcher)
                       if bt is not None for b in bt.batch_sizes}
            check(flushed <= set(K1_PATH_BATCHES)
                  and set(WARM_BATCHES) <= set(K1_PATH_BATCHES),
                  f"{tag}: K1 launched at batches {sorted(flushed)}, "
                  f"checked at {K1_PATH_BATCHES}")
            flush_batches.update(flushed)
            check(stats["k1_launches"] == n and n == n_up
                  * stats["generator_passes"],
                  f"{tag}: {n} K1 launches for "
                  f"{stats['generator_passes']} generator passes")
            check(stats["fallbacks"] == 0 and stats["errors"] == 0,
                  f"{tag}: {stats['fallbacks']} fallbacks, "
                  f"{stats['errors']} errors")
            total = sessions * (warm + strokes + SERVE_TRACE)
            check(stats["strokes_served"] == total
                  and all(len(p.records) == warm + strokes + SERVE_TRACE
                          for p in painters), f"{tag}: replies missing")
            check(stats["timed_paths"] == [want_path[path]],
                  f"{tag}: served by {stats['timed_paths']}")
            batched = path in ("batched", "pooled")
            if batched and sessions > 1:
                check(stats["rows_per_pass"]["mean"] > 1,
                      f"{tag}: {stats['rows_per_pass']} rows per pass")
            run_worst = 0
            for p in (painters if batched else painters[:1]):
                replay = bs.serial_replay(engine, path, p, SERVE_CANVAS,
                                          PAINT_LEVEL, PAINT_CROP)
                for i, (r, (img, meta)) in enumerate(zip(p.records,
                                                         replay)):
                    err = _u8_err(r["image"], img)
                    run_worst = max(run_worst, err)
                    check(r["meta"] == meta and err <= 1,
                          f"{tag}: stroke {i} served {r['meta']} vs serial "
                          f"{meta}, {err} LSB")
            for p in painters:
                p.records = None          # the images are checked
            launches += n
            served += total
            passes += stats["generator_passes"]
            worst = max(worst, run_worst)
            stats["replay_max_lsb"] = run_worst
            runs.append(stats)
            check(stats["device"] is not None, f"{tag}: no device trace")
            idle = stats["device"]["idle_share"]
            rows = stats["rows_per_pass"]
            print(f"[serve] {tag}: client ms p50/p99 "
                  f"{stats['client_ms']['p50']:.2f} / "
                  f"{stats['client_ms']['p99']:.2f}, server_ms p50 "
                  f"{stats['server_ms']['p50']:.2f}, render_ms p50 "
                  f"{stats['render_ms']['p50']:.2f}, "
                  f"{stats['strokes_per_s']:.1f} strokes/s, rows per pass "
                  f"{rows['mean'] if rows else 1:.2f}, idle {idle:.3f}, "
                  f"{n} K1 launches ({card})", flush=True)
    core.close()

    # Each serial path against the same core on the CPU.
    t0 = time.time()
    cpu_core = create_core(gan_checkpoint=bundle_path, device="cpu")
    cmp = {}
    for path in ("helper", "device_canvas"):
        out = []
        for eng in (engine, cpu_core.engine):
            _, painters = bs.run_path(
                eng, path, 1, SERVE_CMP_STROKES, 0, canvas=CMP_CANVAS,
                level=PAINT_LEVEL, crop=PAINT_CROP, seed=SEED + 1,
                trace_strokes=0, keep_images=True, warm_core=False)
            out.append(painters[0].records)
        check(len(out[0]) == len(out[1]) == SERVE_CMP_STROKES
              and all(a["meta"] == b["meta"] for a, b in zip(*out)),
              f"{path}: CUDA vs CPU replies")
        cmp[f"{path}_u8"] = max(_u8_err(a["image"], b["image"])
                                for a, b in zip(*out))
        check(cmp[f"{path}_u8"] <= 1,
              f"{path}: CUDA vs CPU {cmp[f'{path}_u8']} LSB")
    cpu_core.close()
    out = {"runs": runs, "launches": launches, "strokes_served": served,
           "generator_passes": passes, "replay_max_lsb": worst,
           "flush_batches": sorted(flush_batches),
           "cuda_vs_cpu_u8": cmp, "cpu_seconds": time.time() - t0,
           "seconds": time.time() - t_phase, "card": card}
    print(f"[serve] {served} strokes served in {passes} generator passes, "
          f"{launches} K1 launches ({n_up} per pass; flushes of "
          f"{sorted(flush_batches)} rows); served vs serial "
          f"replay max {worst} LSB; CUDA vs CPU {json.dumps(cmp)} (CPU "
          f"{out['cpu_seconds']:.1f} s); phase {out['seconds']:.1f} s",
          flush=True)
    return out


def _tree_equal(a, b):
    """Same keys and bit-equal tensors (any key order)."""
    import torch
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(_tree_equal(a[k], b[k]) for k in a))
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _launch_counts():
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    return {"fir4_epilogue": fir4_epilogue.launches,
            "warp_twopass": tw.warp_twopass.launches,
            "warp_twopass_t": tw.warp_twopass_t.launches}


def _ckpt_snapshot(root, card, out):
    """(a) The 256-px flagship as a reference training snapshot, through
    the factory, the serving core and the converter CLI."""
    import torch
    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.flagship import (
        flagship_encoder_config, flagship_generator_config, flagship_trees,
    )
    from brushstroke_engine_torch.tools import bench_serve as bs
    from brushstroke_engine_torch.tools import convert_checkpoint as tconv
    from brushstroke_engine_torch.ui.core import create_core
    from brushstroke_engine_torch.utils import reference_layout as rl

    trees = flagship_trees(RES, SEED, NOISE_STRENGTH)
    gen_cfg, enc_cfg = flagship_generator_config(RES), \
        flagship_encoder_config()
    pkl = os.path.join(root, "network-snapshot-flagship.pkl")
    rl.write_reference_snapshot(
        pkl, rl.generator_state_dict(gen_cfg, trees["gen_params"],
                                     trees["gen_state"]),
        {"color_format": "triad", "geom_inject_resolutions": [0, 1]},
        encoder={"args": rl.encoder_args(enc_cfg),
                 "model_state": rl.encoder_state_dict(
                     enc_cfg, trees["enc_params"], trees["enc_state"])})
    native = _engine(0, "cuda", trees)
    t0 = time.perf_counter()
    conv = PaintEngineFactory.create(pkl, device="cuda")
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    check(conv.gen_cfg == native.gen_cfg and conv.enc_cfg == native.enc_cfg
          and conv.enc_res == native.enc_res,
          f"converted config {conv.gen_cfg} != the flagship's")
    for k in ("gen_params", "gen_state", "enc_params", "enc_state"):
        check(_tree_equal(getattr(conv, k), getattr(native, k)),
              f"converted {k} are not bit-equal to the native engine's")
    dst = os.path.join(root, "flagship-converted.pkl")
    t0 = time.perf_counter()
    tconv.main(["--kind", "snapshot", "--src", pkl, "--dst", dst])
    tool_s = time.perf_counter() - t0
    from_tool = PaintEngineFactory.create(dst, device="cuda")
    # The same requests through the native engine twice and through a
    # second native engine built alike: how far two renders of one engine
    # lie apart on the card, beside the converted engines' distance; then
    # the same with cuDNN's deterministic algorithms, each engine's style
    # cache (its clarity factors, computed by a render) emptied first.
    rebuilt = _engine(0, "cuda", trees)
    geom = _stroke_patch(RES)
    engines = (native, native, rebuilt, conv, from_tool)

    def spread():
        for eng in engines:
            eng.uvs_mapper.sfactors.clear()
        lsb = {"native_repeat": 0, "native_rebuilt": 0, "converted": 0,
               "converted_by_tool": 0}
        for mode, seed in (("clear", 1), ("full", 2)):
            imgs = []
            for eng in engines:
                eng.set_render_mode(mode)
                opts = _stroke_opts(eng)
                opts.set_style(eng.random_style(seed))
                imgs.append(eng.render_stroke(geom, None, opts)[0])
            for key, img in zip(lsb, imgs[1:]):
                lsb[key] = max(lsb[key], _u8_err(imgs[0], img))
        return lsb

    lsb = spread()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        lsb_det = spread()
    finally:
        torch.backends.cudnn.deterministic = det
    print(f"[ckpt] LSB from the native engine's first render: "
          f"{json.dumps(lsb)}; with cuDNN's deterministic algorithms "
          f"{json.dumps(lsb_det)}", flush=True)
    worst = max(lsb["converted"], lsb["converted_by_tool"])
    check(worst <= 1, f"the converted snapshot renders {worst} LSB off the "
          f"native engine")
    # With deterministic algorithms every render of these engines is the
    # same: the 1 LSB above is cuDNN's run-to-run rounding, not the
    # conversion.
    check(not any(lsb_det.values()), f"with cuDNN's deterministic "
          f"algorithms the renders differ: {lsb_det}")
    core = create_core(gan_checkpoint=pkl, device="cuda")
    try:
        stats, _ = bs.serve(core, "helper", 1, SNAP_SERVE_STROKES, 1,
                            canvas=512, level=PAINT_LEVEL, crop=PAINT_CROP,
                            seed=SEED, trace_strokes=0)
    finally:
        core.close()
    check(stats["fallbacks"] == 0 and stats["errors"] == 0
          and stats["strokes_served"] == SNAP_SERVE_STROKES + 1,
          f"serving the snapshot: {stats['strokes_served']} strokes, "
          f"{stats['fallbacks']} fallbacks, {stats['errors']} errors")
    out["snapshot"] = {"convert_s": convert_s, "tool_convert_s": tool_s,
                       "snapshot_mib": os.path.getsize(pkl) / 2 ** 20,
                       "lsb_vs_native": worst, "lsb": lsb,
                       "lsb_deterministic": lsb_det,
                       "served": stats["strokes_served"],
                       "client_ms_p50": stats["client_ms"]["p50"]}
    print("[ckpt] flagship snapshot " + json.dumps(out["snapshot"])
          + f" ({card})", flush=True)


def _ckpt_config_f(root, card, out):
    """(b) StyleGAN2 config-f as a TF pickle, converted; z -> image on the
    card at CONFIG_F_BATCH against the CPU at B = 1."""
    import numpy as np
    import torch
    from brushstroke_engine_torch.models.generator import (
        generator_apply, make_generator_config,
    )
    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    from brushstroke_engine_torch.flagship import _set_noise_strength
    from brushstroke_engine_torch.utils import checkpoint as ckpt
    from brushstroke_engine_torch.utils import reference_layout as rl
    from brushstroke_engine_torch.utils.util import tree_leaves

    cfg = make_generator_config(**CONFIG_F)
    tiny = GeoEncoderConfig(pre_filters=1, down_filters=(1,),
                            post_filters=(1,), up_filters=(1,))
    trees = ckpt.init_native_params(cfg, tiny, seed=SEED)
    _set_noise_strength(trees, NOISE_STRENGTH)
    trees["gen_state"]["w_avg"] = np.random.RandomState(SEED).randn(
        cfg.w_dim).astype(np.float32)
    p = os.path.join(root, "stylegan2-config-f-tf.pkl")
    rl.write_tf_pickle(p, rl.generator_state_dict(
        cfg, trees["gen_params"], trees["gen_state"]), cfg)
    t0 = time.perf_counter()
    got_cfg, params, state = ckpt.convert_tf_generator_pkl(p, device="cuda")
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    check(got_cfg == cfg, f"config-f converted as {got_cfg}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    z = torch.from_numpy(np.random.RandomState(SEED + 1).randn(
        CONFIG_F_BATCH, cfg.z_dim).astype(np.float32))
    zc = z.cuda()

    def run():
        return generator_apply(cfg, params, state, z=zc,
                               truncation_psi=0.7, noise_mode="const")[0]

    with torch.no_grad():
        img = run()
        ms = cuda_ms(run, 5, warmup=1)
        cpu_params = ckpt.params_from_jax(trees["gen_params"])
        cpu_state = ckpt.params_from_jax(trees["gen_state"])
        t0 = time.perf_counter()
        want = generator_apply(cfg, cpu_params, cpu_state, z=z[:1],
                               truncation_psi=0.7, noise_mode="const")[0]
        cpu_s = time.perf_counter() - t0
    got = img[:1].float().cpu()
    check(img.shape == (CONFIG_F_BATCH, 1024, 1024, 3)
          and bool(torch.isfinite(img).all()),
          f"config-f image {tuple(img.shape)}, finite "
          f"{bool(torch.isfinite(img).all())}")
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    check(err <= CONFIG_F_TOL * scale, f"config-f card vs CPU: max abs err "
          f"{err:.3e} > {CONFIG_F_TOL} x {scale:.3g}")
    out["config_f"] = {"params": n_params, "convert_s": convert_s,
                       "tf_pickle_mib": os.path.getsize(p) / 2 ** 20,
                       "ms_per_image": ms / CONFIG_F_BATCH,
                       "batch": CONFIG_F_BATCH, "max_abs_err": err,
                       "image_scale": scale, "cpu_s_b1": cpu_s}
    print("[ckpt] config-f " + json.dumps(out["config_f"]) + f" ({card})",
          flush=True)


def _ckpt_variants(geom_batch, out):
    """(c) The 'conv' encoder with a triad generator at its bottleneck,
    'sine:N' positional encoding in 'cat' mode, and a c_dim = 4 mapping and
    discriminator, at the 128-px training widths: card against CPU at
    VARIANT_BATCH."""
    import numpy as np
    import torch
    from brushstroke_engine_torch.engine.render import render_core
    from brushstroke_engine_torch.flagship import (
        _set_noise_strength, flagship_encoder_config,
    )
    from brushstroke_engine_torch.models.discriminator import (
        DiscriminatorConfig, discriminator_apply,
    )
    from brushstroke_engine_torch.models.generator import (
        generator_apply, make_generator_config,
    )
    from brushstroke_engine_torch.models.geo_encoder import (
        GeoEncoderConfig, geo_encoder_encode,
    )
    from brushstroke_engine_torch.utils import checkpoint as ckpt
    from brushstroke_engine_torch.utils.util import tree_to

    b, res = VARIANT_BATCH, VARIANT_RES
    rng = np.random.RandomState(SEED + 2)
    geom = torch.from_numpy(np.ascontiguousarray(
        geom_batch[:b, :res, :res, 1:2].astype(np.float32) / 255.0))
    z = torch.from_numpy(rng.randn(b, 64).astype(np.float32))
    c = torch.from_numpy(rng.randn(b, 4).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 4096, (b, 2)).astype(np.int64))
    flag = flagship_encoder_config()
    conv = GeoEncoderConfig(kind="conv", preproc="-11inverse",
                            img_width=res, emb_channel=4, channel_factor=4,
                            num_layers=4)
    widths = dict(z_dim=64, w_dim=64, img_resolution=res,
                  channel_base=16384, channel_max=128)

    def flagship_geom(enc, inject):
        return dict(geom_feature_resolutions=tuple(
            enc.featuremap_resolution(res, r) for r in inject),
            geom_feature_channels=tuple(enc.feature_channels(r)
                                        for r in inject))
    cases = {
        "conv_encoder": (conv, (0,), make_generator_config(
            **widths, **flagship_geom(conv, (0,)))),
        "posenc_sine_cat": (flag, (0, 1), make_generator_config(
            **widths, **flagship_geom(flag, (0, 1)),
            positional_encoding="sine:16", posenc_inject_resolutions=(2, 3))),
        "c_dim_4": (flag, (0, 1), make_generator_config(
            **widths, **flagship_geom(flag, (0, 1)), c_dim=4)),
    }
    dcfg = DiscriminatorConfig(c_dim=4, img_resolution=res, img_channels=3,
                               architecture="orig", channel_base=16384,
                               channel_max=128)
    result = {}
    for name, (enc, inject, gcfg) in cases.items():
        trees = ckpt.init_native_params(
            gcfg, enc, seed=SEED + 3,
            disc_cfg=dcfg if name == "c_dim_4" else None)
        _set_noise_strength(trees, NOISE_STRENGTH)
        outs = {}
        for dev in ("cuda", "cpu"):
            t = {k: tree_to(ckpt.params_from_jax(v), dev)
                 for k, v in trees.items()}
            with torch.no_grad():
                if name != "c_dim_4":
                    outs[dev] = (render_core(
                        gcfg, enc, inject, "clear", (), "triad",
                        t["gen_params"], t["gen_state"], t["enc_params"],
                        t["enc_state"], geom, z, None, pos, None, None, None,
                        None, None, device=dev)["rgba"].cpu(),)
                    continue
                feats = geo_encoder_encode(enc, t["enc_params"],
                                           t["enc_state"], geom.to(dev),
                                           res=list(inject))
                img, debug = generator_apply(
                    gcfg, t["gen_params"], t["gen_state"], z=z.to(dev),
                    c=c.to(dev), geom_features=feats, positions=pos.to(dev),
                    noise_mode="const", return_debug_data=True)
                logits = discriminator_apply(dcfg, t["disc_params"],
                                             img * 2 - 1, c.to(dev))
                outs[dev] = (img.cpu(), logits.cpu())
        errs = [(g - w).abs().max().item()
                for g, w in zip(outs["cuda"], outs["cpu"])]
        check(all(bool(torch.isfinite(g).all()) for g in outs["cuda"])
              and errs[0] <= RENDER_ATOL,
              f"{name}: card vs CPU max abs err {errs[0]:.3e}")
        if len(errs) > 1:
            scale = max(1.0, outs["cpu"][1].abs().max().item())
            check(errs[1] <= D_LOGIT_TOL * scale,
                  f"conditional D logits card vs CPU {errs[1]:.3e} > "
                  f"{D_LOGIT_TOL} x {scale:.3g}")
        result[name] = errs
    out["variants"] = result
    print(f"[ckpt] variants at {res} px, B = {b}, card vs CPU max abs err: "
          + json.dumps(result), flush=True)


def _cli_schedule(tcfg, n):
    """The phases of ``n`` batches of the training CLI after its warm
    start, without eval hooks, and the K1, W and W^T launches they make:
    (phase counts, launches)."""
    sched = {k: sum(1 for i in range(n) if i % iv == 0) for k, iv in (
        ("Dr1", tcfg.d_reg_interval), ("Gpl", tcfg.g_reg_interval),
        ("Ggeom", tcfg.geom_interval))}
    n_up = len(tcfg.gen_cfg.synthesis.block_resolutions) - 1
    return sched, {"fir4_epilogue": n_up * (2 * n + sched["Gpl"]
                                            + sched["Ggeom"]),
                   "warp_twopass": 2 * n + 2 * sched["Dr1"] + n,
                   "warp_twopass_t": sched["Dr1"] + n}


def _ckpt_autoencoder(root, geom_iter, card, out):
    """(d) The autoencoder trainer on the card, then the training CLI with
    --encoder_checkpt: the AE checkpoint, then a reference .pt."""
    import argparse
    import numpy as np
    import torch
    from brushstroke_engine_torch.flagship import flagship_encoder_config
    from brushstroke_engine_torch.tools import train as cli
    from brushstroke_engine_torch.train.train_autoencoder import (
        AETrainConfig, load_ae_checkpoint, train_autoencoder,
    )
    from brushstroke_engine_torch.utils import reference_layout as rl
    from brushstroke_engine_torch.utils.checkpoint import params_to_jax

    enc_cfg = flagship_encoder_config()
    cfg = AETrainConfig(enc_cfg=enc_cfg, batch_size=AE_BATCH,
                        num_steps=AE_STEPS, widths=(AE_WIDTH,),
                        eval_every=AE_STEPS, checkpoint_every=AE_STEPS)
    batches = (next(geom_iter)[:AE_BATCH] for _ in range(AE_STEPS))
    ae_dir = os.path.join(root, "ae")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, losses = train_autoencoder(cfg, batches, ae_dir,
                                              seed=SEED, device="cuda")
    torch.cuda.synchronize()
    ae_s = time.perf_counter() - t0
    losses = [x.item() for x in losses]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(len(losses) == AE_STEPS and all(np.isfinite(losses))
          and last < first, f"AE losses: first 5 mean {first:.4f}, last 5 "
          f"mean {last:.4f}, finite {all(np.isfinite(losses))}")
    ae_path = os.path.join(ae_dir, "ae_latest.pkl")
    got_cfg, got_p, got_s = load_ae_checkpoint(ae_path, device="cuda")
    check(got_cfg == enc_cfg and _tree_equal(got_p, params)
          and _tree_equal(got_s, state), "the AE checkpoint does not hold "
          "the trained weights")
    pt = os.path.join(root, "encoder.pt")
    torch.save({"model_state": {
        k: torch.from_numpy(np.array(v)) for k, v in rl.encoder_state_dict(
            enc_cfg, params_to_jax(params), params_to_jax(state)).items()},
        "args": argparse.Namespace(**rl.encoder_args(enc_cfg))}, pt)
    out["autoencoder"] = {"steps": AE_STEPS, "batch": AE_BATCH,
                          "width": AE_WIDTH, "seconds": ae_s,
                          "steps_per_s": AE_STEPS / ae_s,
                          "loss_first5": first, "loss_last5": last}
    print("[ckpt] autoencoder " + json.dumps(out["autoencoder"])
          + f" ({card})", flush=True)

    runs = {}
    for src, path in (("ae_checkpoint", ae_path), ("reference_pt", pt)):
        before = _launch_counts()
        t0 = time.perf_counter()
        # No eval hooks (--metrics ""): the loop's phases, timed.
        loop, _ = cli.build(["--outdir", os.path.join(root, src),
                             "--device", "cuda"]
                            + _flag_lines("train_flags.txt") + CKPT_CLI_CUTS
                            + ["--encoder_checkpt", path])
        loop.profile_phases = True
        loop.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in _launch_counts().items()}
        tcfg = loop.cfg
        check(tcfg.enc_cfg == enc_cfg and _tree_equal(loop.enc_params, params)
              and _tree_equal(loop.enc_state, state),
              f"{src}: the run's encoder is not the trained one")
        n = loop.batch_idx
        sched, want = _cli_schedule(tcfg, n)
        check(launches == want, f"{src}: launches {launches}, the schedule "
              f"of {n} batches {sched} says {want}")
        _finite_stats(os.path.join(loop.run_dir, "stats.jsonl"))
        runs[src] = {"batches": n, "wall_s": wall, "launches": launches,
                     "phase_s": {k: sum(v) for k, v in
                                 loop.phase_seconds.items()}}
    out["train_cli"] = runs
    print("[ckpt] tools/train.py --encoder_checkpt " + json.dumps(runs)
          + f" ({card})", flush=True)


def phase_checkpoint(geom_iter, card, held):
    """The checkpoint path (see the module doc, phase 11).  ``held``: the
    K1 shapes phase 3 held against the plain version."""
    import shutil
    import tempfile
    import torch
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode

    set_precision_mode("strict")
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {"card": card}
    try:
        fir4_epilogue.launches = 0     # the checkpoint path starts here
        fir4_epilogue.shapes.clear()
        tw.warp_twopass.launches = 0
        tw.warp_twopass_t.launches = 0
        t0 = time.time()
        _ckpt_snapshot(root, card, out)
        out["snapshot"]["seconds"] = time.time() - t0
        t0 = time.time()
        _ckpt_config_f(root, card, out)
        out["config_f"]["seconds"] = time.time() - t0
        t0 = time.time()
        geom_batch = next(geom_iter)
        _ckpt_variants(geom_batch, out)
        out["variants"]["seconds"] = time.time() - t0
        t0 = time.time()
        _ckpt_autoencoder(root, geom_iter, card, out)
        out["autoencoder"]["seconds_with_cli"] = time.time() - t0
        torch.cuda.synchronize()
        out["launches"] = _launch_counts()     # the checkpoint path ends here
        check(all(v > 0 for v in out["launches"].values()),
              f"a kernel was not launched on the checkpoint path: "
              f"{out['launches']}")
        launched = sorted(fir4_epilogue.shapes)
        check(set(launched) <= held, f"K1 launched at shapes phase 3 did "
              f"not hold against the plain version: "
              f"{sorted(set(launched) - held)}")
        out["k1_shapes"] = [list(k) for k in launched]
        print(f"[ckpt] K1 launched at {len(launched)} shapes, each held in "
              f"phase 3: {json.dumps(out['k1_shapes'])}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    print(f"[ckpt] launches {json.dumps(out['launches'])}; phase "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def _stitch_step_on(cfg, device, draws, z, tri_u8, crops):
    """One Gstitch from seed-0 weights on ``device`` with the given draws:
    ({stat: float}, G before, G after)."""
    import torch
    from brushstroke_engine_torch.flagship import flagship_train_setup
    from brushstroke_engine_torch.train import steps
    from brushstroke_engine_torch.train.dataset import geom_batch_to_float
    from brushstroke_engine_torch.utils.util import tree_to
    state, enc_p, enc_s = flagship_train_setup(cfg, SEED, NOISE_STRENGTH,
                                               device)
    dev = state["ada_p"].device
    state["ada_p"] = torch.full((), 0.5, device=dev)
    enc_p, enc_s = tree_to(enc_p, dev), tree_to(enc_s, dev)
    tri = torch.from_numpy(geom_batch_to_float(tri_u8)).to(dev)
    res = cfg.gen_cfg.img_resolution
    feats = [steps.encode_geometry(
        cfg, enc_p, enc_s,
        tri[:, r:r + res, c:c + res, 1:2].contiguous())
        for r, c, _, _ in crops]
    new, s = steps.g_stitch_step(cfg, state, feats[0], feats[1], z.to(dev),
                                 crops[0], crops[1], ema_beta=0.5,
                                 draws=tree_to(draws, dev))
    return {k: float(v) for k, v in s.items()}, state["g_params"], \
        new["g_params"]


def _update_parity(before, card, cpu, lr):
    """The port's parity rule for one Adam step (see STITCH_* above);
    returns the worst per-tensor mean |dG_card - dG_cpu| / lr."""
    import torch
    from brushstroke_engine_torch.utils.util import tree_leaves
    worst = 0.0
    for b, g, c in zip(tree_leaves(before), tree_leaves(card),
                       tree_leaves(cpu)):
        b = b.detach().cpu().double()
        dg, dc = g.detach().cpu().double() - b, c.detach().double() - b
        diff = (dg - dc).abs()
        check(float(diff.mean()) < 0.02 * lr
              and float((diff < 0.1 * lr).double().mean()) > 0.99,
              f"Gstitch card vs CPU: G update differs beyond one Adam "
              f"step's rounding ({float(diff.mean()) / lr:.3e} of lr)")
        worst = max(worst, float(diff.mean()) / lr)
    return worst


def _zoo_folders(root):
    """ZOO_ITEMS noise style images at RES (two folders, the second half as
    large) and ZOO_GEOMS synthetic triband geometries at RES + 64, written
    as PNG (the dataset reads them without Pillow)."""
    from brushstroke_engine_torch.train.dataset import (
        NoiseStyleDataset, SyntheticGeometryDataset,
    )
    from brushstroke_engine_torch.utils.img_proc import write_png
    dirs = {}
    for name, ds, n in (
            ("styles", NoiseStyleDataset(RES, seed=SEED), ZOO_ITEMS),
            ("styles_b", NoiseStyleDataset(RES, seed=SEED + 1),
             ZOO_ITEMS // 2),
            ("geom", SyntheticGeometryDataset(RES + 64, size=ZOO_GEOMS,
                                              seed=SEED), ZOO_GEOMS)):
        dirs[name] = os.path.join(root, name)
        for i in range(n):
            write_png(os.path.join(dirs[name], f"{i:04d}.png"), ds[i])
    return dirs


def phase_stitch(style_iter, geom_iter, card, held, warp_held):
    """Stitching and the metric zoo (see the module doc, phase 12).
    ``held`` / ``warp_held``: the K1 and W / W^T shapes phases 3 and 5 held
    against the plain versions."""
    import random
    import shutil
    import tempfile
    import numpy as np
    import torch
    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.flagship import (
        flagship_encoder_config, flagship_generator_config,
        flagship_train_config, flagship_train_setup, flagship_trees,
    )
    from brushstroke_engine_torch.metrics import fid as fid_lib
    from brushstroke_engine_torch.metrics import ppl as tppl
    from brushstroke_engine_torch.metrics import pr as tpr
    from brushstroke_engine_torch.metrics.metric_main import \
        stitching_metric_loop
    from brushstroke_engine_torch.metrics.stroke_generator import (
        PaintStrokeGenerator, RandomState,
    )
    from brushstroke_engine_torch.models.geo_encoder import \
        geo_encoder_encode
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from brushstroke_engine_torch.tools import calc_metrics as tcalc
    from brushstroke_engine_torch.tools import fid_from_images as tfid
    from brushstroke_engine_torch.tools import metric_main as tmetric
    from brushstroke_engine_torch.tools import train as cli
    from brushstroke_engine_torch.tools import visualize_stitching as tvis
    from brushstroke_engine_torch.train.augment import draw_augment
    from brushstroke_engine_torch.train.loop import TrainingLoop
    from brushstroke_engine_torch.train.stitching import RandomStitcher
    from brushstroke_engine_torch.utils.checkpoint import (
        EngineBundle, params_from_jax, save_native,
    )
    from brushstroke_engine_torch.utils.img_proc import read_png

    def png(d, i):
        with open(os.path.join(dirs[d], f"{i:04d}.png"), "rb") as f:
            return read_png(f.read())

    set_precision_mode("strict")
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_stitch_")
    out = {"card": card}
    launches = {}
    try:
        fir4_epilogue.launches = 0     # the stitch path starts here
        fir4_epilogue.shapes.clear()
        for fn in (tw.warp_twopass, tw.warp_twopass_t):
            fn.launches = 0
            fn.shapes.clear()

        # ---- 1. Gstitch in TrainingLoop at 128 px, batch 64 ----------
        cfg = flagship_train_config(
            TRAIN_RES, TRAIN_BATCH, geom_warmstart_kimg=0, geom_interval=8,
            kimg_per_tick=TRAIN_BATCH / 1000.0,
            stitch_interval=STITCH_INTERVAL,
            stitch_phase_losses=STITCH_LOSSES)
        state, enc_p, enc_s = flagship_train_setup(cfg, SEED, NOISE_STRENGTH,
                                                   "cuda")
        state["ada_p"] = torch.full((), 0.5, device="cuda")
        rows = []
        n = STITCH_BATCHES
        loop = TrainingLoop(cfg, enc_p, enc_s, style_iter, geom_iter,
                            os.path.join(root, "loop"), seed=SEED,
                            resume_state=state, profile_phases=True,
                            snapshot_ticks=10 ** 9, device="cuda")
        loop.hooks.on_tick = lambda lp, st: rows.append(dict(st))
        before = _launch_counts()
        torch.cuda.reset_peak_memory_stats()
        loop.run(total_kimg=(n * TRAIN_BATCH - 0.5) / 1000.0)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        got = {k: v - before[k] for k, v in _launch_counts().items()}
        for i, row in enumerate(rows):
            bad = [k for k, v in row.items() if not np.isfinite(v)]
            check(not bad, f"stitch loop batch {i}: non-finite {bad}")
        sched = {"Dmain": n, "Gmain": n,
                 "Dr1": len(range(0, n, cfg.d_reg_interval)),
                 "Gpl": len(range(0, n, cfg.g_reg_interval)),
                 "Ggeom": len(range(0, n, cfg.geom_interval)),
                 "Gstitch": len(range(0, n, STITCH_INTERVAL))}
        check(len(loop.phase_seconds.get("Gstitch", [])) == sched["Gstitch"]
              and all("Loss/forger/Gstitch/total" in rows[i]
                      for i in range(0, n, STITCH_INTERVAL)),
              f"Gstitch ran {len(loop.phase_seconds.get('Gstitch', []))} "
              f"times, the schedule says {sched['Gstitch']}")
        n_up = len(cfg.gen_cfg.synthesis.block_resolutions) - 1
        # Gstitch: two generator passes, two discriminator passes (W) and
        # their backward (W^T); K1's backward re-runs the plain chain.
        want = {"fir4_epilogue": n_up * (sched["Dmain"] + sched["Gmain"]
                                         + sched["Gpl"] + sched["Ggeom"]
                                         + 2 * sched["Gstitch"]),
                "warp_twopass": 2 * sched["Dmain"] + 2 * sched["Dr1"]
                + sched["Gmain"] + 2 * sched["Gstitch"],
                "warp_twopass_t": sched["Dr1"] + sched["Gmain"]
                + 2 * sched["Gstitch"]}
        check(got == want, f"stitch loop launches {got}, schedule says "
              f"{want}")
        launches["loop"] = got

        def med(phase):
            v = loop.phase_seconds[phase]
            return statistics.median(v[1:] if len(v) > 1 else v)

        out["loop"] = {
            "batches": n, "schedule": sched, "launches": got,
            "gstitch_s": loop.phase_seconds["Gstitch"],
            "gstitch_median_s": med("Gstitch"),
            "gmain_median_s": med("Gmain"), "dmain_median_s": med("Dmain"),
            "gstitch_images_per_s": TRAIN_BATCH / med("Gstitch"),
            "gmain_images_per_s": TRAIN_BATCH / med("Gmain"),
            "peak_memory_gib": peak_gb,
            "stats": {k: v for k, v in rows[STITCH_INTERVAL].items()
                      if "Gstitch" in k}}
        print("[stitch] loop " + json.dumps(out["loop"]), flush=True)
        print(f"[stitch] Gstitch {out['loop']['gstitch_median_s'] * 1e3:.1f}"
              f" ms median ({out['loop']['gstitch_images_per_s']:.1f} "
              f"images/s of the batch of {TRAIN_BATCH}) beside Gmain "
              f"{out['loop']['gmain_median_s'] * 1e3:.1f} ms, strict f32, "
              f"peak {peak_gb:.1f} GiB ({card})", flush=True)
        del loop, state

        # ---- 2. one Gstitch at B = STITCH_CHECK_BATCH, card vs CPU ----
        b = STITCH_CHECK_BATCH
        cfg8 = flagship_train_config(TRAIN_RES, b, geom_warmstart_kimg=0,
                                     stitch_interval=STITCH_INTERVAL,
                                     stitch_phase_losses=STITCH_LOSSES)
        tri_u8 = next(geom_iter)[:b]
        stitcher = RandomStitcher()
        crop1 = (20, 30, TRAIN_RES, TRAIN_RES)
        crops = (crop1, stitcher.gen_overlapping_square_crop(
            tri_u8.shape[1], crop1, random.Random(SEED)))
        gen = torch.Generator().manual_seed(SEED + 7)
        shape = (TRAIN_RES, TRAIN_RES, 3)
        draws = {"positions1": torch.randint(0, TRAIN_RES - 1, (b, 2),
                                             generator=gen),
                 "aug_fake": draw_augment(cfg8.augment, gen, 2 * b, shape,
                                          "cpu"),
                 "aug_composite": draw_augment(cfg8.augment, gen, 2 * b,
                                               shape, "cpu")}
        z = torch.randn((b, cfg8.gen_cfg.z_dim), generator=gen)
        t0 = time.time()
        gpu, g0, g_gpu = _stitch_step_on(cfg8, "cuda", draws, z, tri_u8,
                                         crops)
        cpu, _, g_cpu = _stitch_step_on(cfg8, "cpu", draws, z, tri_u8, crops)
        errs = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-3)
                for k in cpu}
        for k, err in errs.items():
            check(err <= TRAIN_RTOL, f"Gstitch card vs CPU {k}: {gpu[k]} vs "
                  f"{cpu[k]} (rel {err:.3e})")
        lr = cfg8.g_lr * cfg8.g_reg_interval / (cfg8.g_reg_interval + 1)
        upd = _update_parity(g0, g_gpu, g_cpu, lr)
        out["check"] = {"batch": b, "crops": crops, "stats": gpu,
                        "worst_rel_err": max(errs.values()),
                        "update_mean_diff_of_lr": upd,
                        "seconds": time.time() - t0}
        print("[stitch] card vs CPU " + json.dumps(out["check"]), flush=True)

        # ---- 3. the CLI with the stitch flags, and resume -------------
        cuts = ["--kimg", "0", "--geom_warmstart_kimg", "0", "--snap", "1",
                "--image_snap", "1", "--metrics", "",
                "--stitch_interval", str(STITCH_INTERVAL),
                "--stitch_phase_losses", STITCH_LOSSES]
        t0 = time.time()
        before = _launch_counts()
        cli_loop, args = cli.build(["--outdir", os.path.join(root, "cli"),
                                    "--device", "cuda"]
                                   + _flag_lines("train_flags.txt") + cuts)
        cli_loop.profile_phases = True
        cli_loop.run(exit_after_warmstart=args.exit_after_warmstart)
        torch.cuda.synchronize()
        check(cli_loop.cfg.gen_cfg.synthesis.num_bf16_res == 4
              and cli_loop.cfg.stitch_interval == STITCH_INTERVAL
              and "Gstitch" in cli_loop.phase_seconds,
              "the CLI run is not the bf16 run with Gstitch")
        _finite_stats(cli_loop.stats_path)
        for name in ("train_state.pkl", "training_options.json"):
            check(os.path.isfile(os.path.join(cli_loop.run_dir, name)),
                  f"the stitch CLI run left no {name}")
        ran = _resume_bitwise(cli_loop, style_iter, geom_iter, root,
                              "[stitch]")
        check("Loss/forger/Gstitch/total" in ran,
              "the resumed batches ran no Gstitch")
        launches["cli"] = {k: v - before[k]
                           for k, v in _launch_counts().items()}
        out["cli"] = {"gstitch_s": cli_loop.phase_seconds["Gstitch"],
                      "launches": launches["cli"], "resume_bitwise": True,
                      "seconds": time.time() - t0}
        print("[stitch] cli " + json.dumps(out["cli"]), flush=True)
        del cli_loop

        # ---- 4. the 256-px flagship: stitching metrics, sheets, zoo ---
        t0 = time.time()
        dirs = _zoo_folders(root)
        trees = {k: params_from_jax(v) for k, v in
                 flagship_trees(RES, SEED, NOISE_STRENGTH).items()}
        snap = os.path.join(root, "flagship.pkl")
        save_native(snap, EngineBundle(
            flagship_generator_config(RES, (0, 1)), trees["gen_params"],
            trees["gen_state"], flagship_encoder_config(),
            trees["enc_params"], trees["enc_state"],
            geom_inject_resolutions=(0, 1)))
        out["zoo_setup_s"] = time.time() - t0

        before = _launch_counts()
        t0 = time.perf_counter()
        summary = tmetric.main([
            "--gan_checkpoint", snap, "--eval_output_dir",
            os.path.join(root, "metrics"), "--library", f"rand{ZOO_STYLES}",
            "--batch_size", "8", "--geom_data", dirs["geom"],
            "--enable_stitching", "--device", "cuda"])
        torch.cuda.synchronize()
        metric_s = time.perf_counter() - t0
        check({"STITCH_LPIPS", "STITCH_L1"} <= set(summary) and all(
            np.isfinite(v) for v in summary.values()),
            f"metric_main --enable_stitching: {summary}")

        # stitching_metric_loop, card vs CPU: the same crops and positions
        # from the loop's seeded streams on both sides.
        tri = np.stack([png("geom", i) for i in range(STITCH_CMP_BATCH)])
        sm = {}
        for dev in ("cuda", "cpu"):
            eng = PaintEngineFactory.create(snap, device=dev)
            sm[dev] = stitching_metric_loop(
                PaintStrokeGenerator(STITCH_CMP_BATCH, eng, RandomState(SEED)),
                iter([tri]), 1)
        sm_err = {k: abs(sm["cuda"][k] - v) / max(abs(v), 1e-3)
                  for k, v in sm["cpu"].items()}
        check(set(sm["cuda"]) == set(sm["cpu"]) == {"STITCH_LPIPS",
                                                     "STITCH_L1"}
              and max(sm_err.values()) <= METRIC_RTOL,
              f"stitching_metric_loop card vs CPU: {sm}")
        sheets = tvis.main(["--gan_checkpoint", snap, "--output_dir",
                            os.path.join(root, "sheets"), "--num_styles", "2",
                            "--device", "cuda"])
        for p in sheets:
            with open(p, "rb") as f:
                check(read_png(f.read()).shape == (2 * RES, 2 * RES, 3),
                      f"stitching sheet {p}")
        out["stitch_metrics"] = {
            "summary": summary, "seconds": metric_s,
            "loop_card_vs_cpu": {k: [sm["cuda"][k], sm["cpu"][k], e]
                                 for k, e in sm_err.items()},
            "sheets": len(sheets)}
        print("[stitch] metrics " + json.dumps(out["stitch_metrics"])
              + f" ({card})", flush=True)

        # The metric zoo.
        t0 = time.perf_counter()
        zoo = tcalc.main([
            "--gan_checkpoint", snap, "--data", dirs["styles"],
            "--geom_data", dirs["geom"], "--metrics", ZOO_METRICS,
            "--num_items", str(ZOO_ITEMS), "--batch_size", str(ZOO_BATCH),
            "--device", "cuda", "--out", os.path.join(root, "zoo.json")])
        torch.cuda.synchronize()
        zoo_s = time.perf_counter() - t0
        keys = {"fid", "kid", "is", "precision", "recall", "ppl_w", "ppl_z"}
        check(keys <= set(zoo) and all(np.isfinite(zoo[k]) for k in keys)
              and zoo["detector"] == "random",
              f"calc_metrics: {zoo}")
        fid_pr = tfid.main(["--images0", dirs["styles"], "--images1",
                            dirs["styles_b"], "--resolution", str(RES),
                            "--batch_size", str(ZOO_BATCH), "--pr",
                            "--device", "cuda"])
        check(all(np.isfinite(fid_pr[k]) for k in
                  ("fid", "precision", "recall")), f"fid_from_images {fid_pr}")
        launches["eval"] = {k: v - before[k]
                            for k, v in _launch_counts().items()}

        # PR and PPL, card vs CPU on the same features and draws.
        feats = [np.concatenate([fid_lib.extract_features(
            np.stack([png(d, i) for i in range(j, j + ZOO_BATCH)]),
            device="cuda").cpu().numpy()
            for j in range(0, ZOO_ITEMS // 2, ZOO_BATCH)])
            for d in ("styles", "styles_b")]
        pr = {dev: tpr.compute_pr(*feats, device=dev)
              for dev in ("cuda", "cpu")}
        check(pr["cuda"] == pr["cpu"], f"compute_pr card {pr['cuda']} vs "
              f"CPU {pr['cpu']}")
        g = (tri[:1, :RES, :RES, 1:2] / 255.0).astype(np.float32)
        dists = {}
        for dev in ("cuda", "cpu"):
            eng = PaintEngineFactory.create(snap, device=dev)
            with torch.no_grad():
                f = geo_encoder_encode(eng.enc_cfg, eng.enc_params,
                                       eng.enc_state,
                                       torch.from_numpy(g).to(dev),
                                       res=list(eng.enc_res))
            dists[dev] = tppl.ppl_distances(
                eng, f, num_samples=PPL_CMP_SAMPLES, epsilon=PPL_CMP_EPS,
                space="w", batch=PPL_CMP_SAMPLES, seed=SEED)
        bound = PPL_CMP_RTOL * dists["cpu"] + 8 * 2.0 ** -24 * np.sqrt(
            dists["cpu"]) / PPL_CMP_EPS
        ppl_err = float(np.max(np.abs(dists["cuda"] - dists["cpu"])
                               / dists["cpu"]))
        check(bool(np.all(np.abs(dists["cuda"] - dists["cpu"]) <= bound)),
              f"PPL distances card {dists['cuda']} vs CPU {dists['cpu']}")
        out["zoo"] = {"values": {k: zoo[k] for k in sorted(keys)},
                      "detector": zoo["detector"],
                      "seconds": zoo["seconds"], "wall_s": zoo_s,
                      "items": ZOO_ITEMS, "batch": ZOO_BATCH,
                      "fid_from_images": fid_pr,
                      "pr_card_vs_cpu": [pr["cuda"], pr["cpu"]],
                      "ppl_distances_card_vs_cpu_rel": ppl_err,
                      "launches": launches["eval"]}
        print("[stitch] zoo " + json.dumps(out["zoo"]) + f" ({card})",
              flush=True)
        for k in sorted(keys):
            sec = zoo["seconds"]["pr" if k in ("precision", "recall") else k]
            print(f"[stitch] zoo {k} = {zoo[k]:.6g} ({sec:.2f} s; detector "
                  f"{zoo['detector']}; {card})", flush=True)

        # ---- 5. every launch shape of this phase was held -------------
        launched = sorted(fir4_epilogue.shapes)
        check(set(launched) <= held, f"K1 launched at shapes phases 3 did "
              f"not hold against the plain version: "
              f"{sorted(set(launched) - held)}")
        for name, fn in (("warp_twopass", tw.warp_twopass),
                         ("warp_twopass_t", tw.warp_twopass_t)):
            check(fn.shapes <= warp_held[name],
                  f"{name} launched at shapes phase 5 did not hold: "
                  f"{sorted(fn.shapes - warp_held[name])}")
        out["k1_shapes"] = [list(k) for k in launched]
        out["warp_shapes"] = sorted(tw.warp_twopass.shapes
                                    | tw.warp_twopass_t.shapes)
        out["launches"] = _launch_counts()    # the stitch path ends here
        check(all(v > 0 for v in out["launches"].values()),
              f"a kernel was not launched on the stitch path: "
              f"{out['launches']}")
        print(f"[stitch] K1 launched at {len(launched)} shapes, W / W^T at "
              f"{json.dumps(out['warp_shapes'])}, each held; launches "
              f"{json.dumps(out['launches'])}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    print(f"[stitch] phase {out['seconds']:.1f} s", flush=True)
    return out


class _KeepRecords:
    """A logging handler that keeps every record it is handed."""

    def __init__(self):
        import logging
        self.handler = logging.Handler(logging.DEBUG)
        self.records = []
        self.handler.emit = self.records.append

    def __enter__(self):
        import logging
        self.logger = logging.getLogger(
            "brushstroke_engine_torch.tools.projection")
        self.level = self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.DEBUG)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _chunks(records):
    """The projection loop's chunk lines: [(created, step, chunk LPIPS
    list)], one per chunk (the INFO line and the DEBUG line after it)."""
    steps = [(r.created, r.args[0]) for r in records
             if r.msg.startswith("Step ")]
    lps = [r.args[0] for r in records if r.msg.startswith("chunk lpips")]
    check(len(steps) == len(lps) and steps,
          f"projection chunk lines: {len(steps)} steps, {len(lps)} LPIPS")
    return [(t, s, lp) for (t, s), lp in zip(steps, lps)]


def _opt_close(got, want, lr_total):
    """Port parameters after a few Adam steps, card against CPU, by phase
    12's rule for an Adam update: Adam divides each gradient entry by its
    own running magnitude, so rounding of a small gradient becomes a share
    of a step.  Every entry within WF_RTOL relative plus 10 % of the summed
    learning rate, the mean difference within 2 % of it.  Returns (ok, mean
    error over the summed lr, max error)."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    ok = got.shape == want.shape \
        and bool((err <= WF_RTOL * np.abs(want) + 0.1 * lr_total).all()) \
        and float(err.mean()) <= WF_RTOL * float(np.abs(want).mean()) \
        + 0.02 * lr_total
    return ok, float(err.mean()) / lr_total, float(err.max())


def start_media(root):
    """Start ``tools/make_synthetic_media.py`` for phase 13 in a process of
    its own (numpy on the host, ~15 s per 512-px image), so that it runs
    while the earlier phases keep the card busy.  Returns its handle."""
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    log = open(os.path.join(root, "media.log"), "w")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "brushstroke_engine_torch.tools.make_synthetic_media",
             "--output_dir", os.path.join(root, "media"),
             "--num_images", str(WF_MEDIA), "--resolution",
             str(WF_MEDIA_RES), "--seed", str(WF_MEDIA_SEED)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return {"proc": proc, "root": root}


def _stop(proc):
    """Kill ``proc`` if it still runs (the smoke leaves no process)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


async def _serve_brush(core, library, style, patches, plan):
    """One session of ``core``: positions on, a WF_CANVAS canvas without
    feature blending, the brush ``style`` of ``library``, then the strokes
    of ``plan`` [(patch index, x, y)] with no crop margin.  Returns
    [(uint8 image, meta)] and the K1 launches of the brush infos (at
    connect and after set_brush)."""
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ui import protocol
    replies = []
    session = core.session(replies.append)
    before = fir4_epilogue.launches
    session.open()
    for msg in ({"type": "set_option", "option": "positions", "value": True},
                {"type": "new_canvas", "rows": WF_CANVAS, "cols": WF_CANVAS,
                 "feature_blending": 0},
                {"type": "set_brush", "library_id": library,
                 "style_id": style}):
        await session.on_message(json.dumps(msg))
    info_launches = fir4_epilogue.launches - before
    check(session.helper.brush_options.style_id == style
          and session.helper.brush_options.custom_args.get("noise_buffers"),
          f"the session did not take {library}/{style} with its noise")
    out = []
    for idx, x, y in plan:
        n0 = len(replies)
        await session.on_message(protocol.encode_render_request(
            patches[idx], x, y, crop_margin=0))
        images = [m for m in replies[n0:] if isinstance(m, bytes)]
        check(len(images) == 1, f"stroke at ({x}, {y}): {len(images)} "
              f"image replies")
        _, meta, img = protocol.decode_render_response(images[0])
        out.append((img.copy(), meta))
    session.on_close()
    return out, info_launches


def _profile_projection_step(engine, targets, geoms):
    """K1's share of a projection step's device time: ``project_parallel``
    for 2 steps under the profiler (set-up included: the encoder, the masks,
    WF_PROFILE_W_SAMPLES w samples).  Forward: the kernel's own device time;
    backward: the device time under ``_Fir4EpilogueFnBackward`` (the plain
    chain re-run and differentiated).  Per step, ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from brushstroke_engine_torch.tools import projection

    cfg = projection.ProjectionConfig(num_steps=2,
                                      w_avg_samples=WF_PROFILE_W_SAMPLES,
                                      min_lpips_improvement=-1.0)
    projection.project_parallel(engine, targets, geoms, cfg, log_every=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        projection.project_parallel(engine, targets, geoms, cfg,
                                    log_every=1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = sum(e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    check(busy > 0, "the profiler recorded no device time")
    fwd = sum(e.time_range.elapsed_us() for e in events
              if e.device_type == DeviceType.CUDA
              and "fir4_epilogue" in e.name) / 1e3

    def device_ms(e):
        """Device time of the kernels an op and its children launched."""
        own = sum(k.duration for k in getattr(e, "kernels", []))
        return own + sum(device_ms(c) for c in e.cpu_children)

    # The autograd engine's node for K1's backward (its child op of the
    # same name is inside it, so only the outer event is summed).
    bwd = sum(device_ms(e) for e in events
              if e.device_type == DeviceType.CPU
              and e.name.startswith("autograd::engine::evaluate_function")
              and e.name.endswith("_Fir4EpilogueFnBackward")) / 1e3
    return {"steps": 2, "wall_ms_per_step": wall / 2,
            "device_busy_ms_per_step": busy / 2,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "k1_forward_ms_per_step": fwd / 2,
            "k1_backward_ms_per_step": bwd / 2,
            "k1_forward_share": fwd / busy, "k1_backward_share": bwd / busy}


def phase_brush_workflow(card, held, media):
    """The brush-creation workflow (see the module doc, phase 13).
    ``held``: the K1 shapes phase 3 held against the plain version;
    ``media``: the media process :func:`start_media` started."""
    import asyncio
    import glob
    import pickle
    import shutil
    import numpy as np
    import torch
    from brushstroke_engine_torch.engine.brush import (
        GanBrushOptions, PaintEngineFactory,
    )
    from brushstroke_engine_torch.flagship import (
        flagship_encoder_config, flagship_generator_config, flagship_trees,
    )
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from brushstroke_engine_torch.tools import (
        clarity, clip_model, clip_search, clip_search_main, get_ws_main,
        opt_clarity_main, project_main, projection, seed_expand,
        visualize_pca_main,
    )
    from brushstroke_engine_torch.tools.bench_serve import stroke_patches
    from brushstroke_engine_torch.data.curves import random_spline_stroke
    from brushstroke_engine_torch.ui.core import create_core, parse_libraries
    from brushstroke_engine_torch.utils import reference_layout as rl
    from brushstroke_engine_torch.utils.checkpoint import (
        EngineBundle, params_from_jax, save_native,
    )
    from brushstroke_engine_torch.utils.img_proc import read_png

    set_precision_mode("strict")
    t_phase = time.time()
    root = media["root"]
    out = {"card": card}
    launches = {}
    schedule = {}

    def counted(name, fn):
        """Run ``fn``; keep its K1 launches and its seconds."""
        before = fir4_epilogue.launches
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        launches[name] = fir4_epilogue.launches - before
        return result, time.perf_counter() - t0

    try:
        fir4_epilogue.launches = 0     # the brush workflow starts here
        fir4_epilogue.shapes.clear()
        trees = {k: params_from_jax(v) for k, v in
                 flagship_trees(RES, SEED, NOISE_STRENGTH).items()}
        bundle = os.path.join(root, "flagship.pkl")
        save_native(bundle, EngineBundle(
            flagship_generator_config(RES, (0, 1)), trees["gen_params"],
            trees["gen_state"], flagship_encoder_config(),
            trees["enc_params"], trees["enc_state"],
            geom_inject_resolutions=(0, 1)))
        engine = PaintEngineFactory.create(bundle, device="cuda")
        gen_cfg = engine.gen_cfg
        n_up = len(gen_cfg.synthesis.block_resolutions) - 1

        # ---- 1. the media CLI (started by main) -------------------------
        t0 = time.time()
        rc = media["proc"].wait(timeout=900)
        out["media_wait_s"] = time.time() - t0
        with open(os.path.join(root, "media.log")) as f:
            media_log = f.read()
        check(rc == 0, f"make_synthetic_media exited {rc}: "
              f"{media_log[-2000:]}")
        targets = sorted(glob.glob(os.path.join(root, "media", "*.png")))
        check(len(targets) == WF_MEDIA, f"{len(targets)} media PNGs")
        for p in targets:
            with open(p, "rb") as f:
                shape = read_png(f.read()).shape
            check(shape == (WF_MEDIA_RES, WF_MEDIA_RES, 3),
                  f"{p}: shape {shape}")

        # ---- 2. projection: 8 styles in one run, then one alone --------
        proj_dir = os.path.join(root, "proj")
        argv = ["--gan_checkpoint", bundle, "--target_image", *targets,
                "--output_dir", proj_dir, "--num_steps", str(WF_STEPS),
                "--num_patches", str(WF_PATCHES), "--library_name",
                "ALL_projected_media.pkl", "--seed", "0", "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        with _KeepRecords() as recs:
            res, sec = counted("project_parallel",
                               lambda: project_main.main(argv))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        chunks = _chunks(recs)
        steps = chunks[-1][1]
        schedule["project_parallel"] = steps * n_up
        names = [os.path.splitext(os.path.basename(p))[0] for p in targets]
        check(sorted(res) == names, f"projected {sorted(res)}")
        first, best = chunks[0][2][0], float(np.mean(
            [r["lpips"] for r in res.values()]))
        check(best < first and all(r["step"] > 0 for r in res.values()),
              f"LPIPS did not fall: first {first}, best {best}, best steps "
              f"{[r['step'] for r in res.values()]}")
        for name, r in res.items():
            check(np.isfinite(r["w"]).all() and all(
                np.isfinite(v).all() for v in r["noise"].values())
                and np.isfinite(r["lpips"]),
                f"{name}: non-finite projection")
            npz = np.load(os.path.join(proj_dir, f"{name}.npz"))
            check(np.array_equal(npz["w"], r["w"]),
                  f"{name}.npz does not hold the result")
        with open(os.path.join(proj_dir, "ALL_projected_media.pkl"),
                  "rb") as f:
            lib = pickle.load(f)
        check(sorted(lib) == names and all(
            len(v["noise"]) == 2 * n_up + 1 for v in lib.values()),
            f"the projected library: {sorted(lib)}")
        again, _ = counted("skip_existing", lambda: project_main.main(
            argv + ["--skip_existing"]))
        check(again == {} and launches["skip_existing"] == 0,
              f"--skip_existing projected {sorted(again)}")
        schedule["skip_existing"] = 0
        out["project_parallel"] = {
            "styles": WF_MEDIA, "rows": WF_MEDIA * WF_PATCHES,
            "steps": steps, "seconds": sec, "lpips_first": first,
            "lpips_best_mean": best, "peak_gib": peak}

        single_dir = os.path.join(root, "single")
        argv1 = ["--gan_checkpoint", bundle, "--target_image", targets[0],
                 "--style_name", "single", "--output_dir", single_dir,
                 "--num_steps", str(WF_STEPS), "--num_patches",
                 str(WF_SINGLE_PATCHES), "--seed", "0", "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        with _KeepRecords() as recs:
            res1, sec1 = counted("project", lambda: project_main.main(argv1))
        chunks1 = _chunks(recs)
        schedule["project"] = chunks1[-1][1] * n_up
        r1 = res1["single"]
        check(r1["lpips"] < chunks1[0][2][0] and r1["step"] > 0
              and np.isfinite(r1["w"]).all(),
              f"single projection: first {chunks1[0][2][0]}, best "
              f"{r1['lpips']} at step {r1['step']}")
        check(os.path.isfile(os.path.join(single_dir, "single.npz")),
              "single.npz not written")
        out["project"] = {
            "rows": WF_SINGLE_PATCHES, "steps": chunks1[-1][1],
            "seconds": sec1, "lpips_first": chunks1[0][2][0],
            "lpips_best": r1["lpips"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

        # ms per step: WF_TIME_CHUNKS chunks of WF_TIME_EVERY steps after a
        # first chunk (w stats, cuDNN's first calls), host clock between
        # the chunk lines (each follows a device read).
        pairs = [project_main.load_target_patches(p, RES, WF_PATCHES, 0)
                 for p in targets]
        tgts = np.stack([t for t, _ in pairs])
        geoms = np.stack([g for _, g in pairs])
        one_t, one_g = project_main.load_target_patches(
            targets[0], RES, WF_SINGLE_PATCHES, 0)
        tcfg = projection.ProjectionConfig(
            num_steps=WF_TIME_EVERY * (WF_TIME_CHUNKS + 1),
            min_lpips_improvement=-1.0)
        for key, fn in (
                ("project_parallel", lambda: projection.project_parallel(
                    engine, tgts, geoms, tcfg, log_every=WF_TIME_EVERY)),
                ("project", lambda: projection.project(
                    engine, one_t, one_g, tcfg, log_every=WF_TIME_EVERY))):
            with _KeepRecords() as recs:
                counted(f"timing_{key}", fn)
            schedule[f"timing_{key}"] = tcfg.num_steps * n_up
            times = [t for t, _, _ in _chunks(recs)]
            per_step = [(b - a) * 1e3 / WF_TIME_EVERY
                        for a, b in zip(times, times[1:])]
            ms = statistics.median(per_step)
            styles = WF_MEDIA if key == "project_parallel" else 1
            out[key].update(ms_per_step=ms, ms_per_step_chunks=per_step,
                            styles_per_s=styles / (ms * WF_STEPS / 1e3))
        out["k1_step_profile"], _ = counted(
            "profile", lambda: _profile_projection_step(engine, tgts, geoms))
        schedule["profile"] = 2 * 2 * n_up        # two calls of 2 steps
        print("[brush] projection " + json.dumps(
            {k: out[k] for k in ("project_parallel", "project",
                                 "k1_step_profile")}), flush=True)

        # ---- 3. card vs CPU: project_parallel, N = 2, B = 1 -------------
        cpu_engine = PaintEngineFactory.create(bundle, device="cpu")
        draws = np.random.RandomState(SEED + 3).randn(
            WF_CMP_STEPS, 2, 1, gen_cfg.num_ws, gen_cfg.w_dim).astype(
            np.float32)
        ccfg = projection.ProjectionConfig(num_steps=WF_CMP_STEPS,
                                           min_lpips_improvement=-1.0)
        got, _ = counted("card_vs_cpu", lambda: projection.project_parallel(
            engine, tgts[:2, :1], geoms[:2, :1], ccfg, log_every=1,
            draws=draws))
        schedule["card_vs_cpu"] = WF_CMP_STEPS * n_up
        t0 = time.time()
        want = projection.project_parallel(
            cpu_engine, tgts[:2, :1], geoms[:2, :1], ccfg, log_every=1,
            draws=draws)
        cpu_s = time.time() - t0
        lr_total = sum(projection._lr_schedule(ccfg, s)
                       for s in range(WF_CMP_STEPS))
        worst = {"lpips": 0.0, "mean_err_over_lr": 0.0, "max_err": 0.0}
        for g, w in zip(got, want):
            lp = abs(g["lpips"] - w["lpips"]) / abs(w["lpips"])
            check(lp <= WF_RTOL and g["step"] == w["step"],
                  f"card vs CPU LPIPS {g['lpips']} vs {w['lpips']}")
            worst["lpips"] = max(worst["lpips"], lp)
            for a, b in [(g["w"], w["w"])] + [
                    (g["noise"][k], w["noise"][k]) for k in w["noise"]]:
                ok, mean, err = _opt_close(a, b, lr_total)
                check(ok, f"card vs CPU projection: mean err {mean:.4f} of "
                      f"the summed lr {lr_total}, max err {err:.3e}")
                worst["mean_err_over_lr"] = max(worst["mean_err_over_lr"],
                                                mean)
                worst["max_err"] = max(worst["max_err"], err)
        out["card_vs_cpu"] = dict(worst, cpu_seconds=cpu_s)
        print("[brush] card vs CPU " + json.dumps(out["card_vs_cpu"]),
              flush=True)

        # ---- 4. the clarity finetune of the projected library -----------
        # Held geometry: WF_CLARITY_EVAL batches of 4 spline strokes, drawn
        # on the host as the CLIs draw theirs (timed: the tools' host cost).
        rng = np.random.default_rng(SEED + 5)
        t0 = time.perf_counter()
        held_geoms = [np.stack([
            random_spline_stroke(rng, RES)[..., None] for _ in range(4)])
            for _ in range(WF_CLARITY_EVAL)]
        stroke_s = (time.perf_counter() - t0) / (4 * WF_CLARITY_EVAL)
        print(f"[brush] host s per {RES}-px stroke {stroke_s:.6f} (the "
              f"native rasterizer)", flush=True)
        lib_path = os.path.join(proj_dir, "ALL_projected_media.pkl")
        opt_dir = os.path.join(root, "opt")
        _, sec = counted("clarity", lambda: opt_clarity_main.main([
            "--gan_checkpoint", bundle, "--library", lib_path,
            "--output_dir", opt_dir, "--num_steps", str(WF_CLARITY_STEPS),
            "--batch_size", str(WF_CLARITY_BATCH), "--device", "cuda"]))
        schedule["clarity"] = WF_MEDIA * WF_CLARITY_STEPS * 2 * n_up
        opt_path = os.path.join(opt_dir, "OPT_ALL_projected_media.pkl")
        with open(opt_path, "rb") as f:
            opt_lib = pickle.load(f)
        check(sorted(opt_lib) == names, f"OPT library {sorted(opt_lib)}")
        for name in names:
            check(np.isfinite(opt_lib[name]["w"]).all()
                  and not np.array_equal(opt_lib[name]["w"], lib[name]["w"])
                  and all(np.array_equal(opt_lib[name]["noise"][k], v)
                          for k, v in lib[name]["noise"].items()),
                  f"{name}: the OPT entry is not finite, did not move or "
                  f"does not carry the noise")

        def objective(losses, w, w0, noise):
            """Mean over the held batches: (the clarity terms -- the IoU
            items --, the whole objective)."""
            w = torch.as_tensor(np.asarray(w, np.float32), device="cuda")
            w0 = torch.as_tensor(np.asarray(w0, np.float32), device="cuda")
            terms = []
            with torch.no_grad():
                for g in held_geoms:
                    total, items = clarity.clarity_loss(
                        engine, losses, w, w0,
                        torch.as_tensor(g, device="cuda"), noise)
                    terms.append([sum(
                        it.weight * float(items[it.full_name])
                        for it in losses.items
                        if it.name in ("iou", "iou_inv")), float(total)])
            return np.mean(terms, axis=0).tolist()

        def per_style(losses, w_after):
            """{style: [(clarity terms, objective) at the projected W and
            at ``w_after(name)``]} on the held batches."""
            out_ = {}
            for name in names:
                noise = {k: torch.as_tensor(np.asarray(v), device="cuda")
                         for k, v in lib[name]["noise"].items()}
                w1 = w_after(name)
                out_[name] = [objective(losses, w, lib[name]["w"], noise)
                              for w in (lib[name]["w"], w1)]
            return out_

        # The default objective has its anchor terms at 0 where a style
        # starts, so with random weights it may end above its start: it is
        # reported.  Its clarity terms alone, optimized from each projected
        # style for WF_DESCENT_STEPS steps on the held batches, must fall
        # there.
        default = clarity.ForgerLosses.create_from_string(
            clarity.DEFAULT_LOSSES)
        report, _ = counted("clarity_report", lambda: per_style(
            default, lambda name: opt_lib[name]["w"]))
        schedule["clarity_report"] = WF_MEDIA * 2 * WF_CLARITY_EVAL * 2 * n_up
        iou_cfg = clarity.ClarityConfig(num_steps=WF_DESCENT_STEPS,
                                        losses=WF_CLARITY_TERMS)
        falls, _ = counted("clarity_descent", lambda: per_style(
            clarity.ForgerLosses.create_from_string(WF_CLARITY_TERMS),
            lambda name: clarity.optimize_style_clarity(
                engine, lib[name]["w"], itertools.cycle(held_geoms),
                iou_cfg, noise_buffers=lib[name]["noise"])["w"]))
        schedule["clarity_descent"] = WF_MEDIA * (
            WF_DESCENT_STEPS + 2 * WF_CLARITY_EVAL) * 2 * n_up
        for name, (before, after) in falls.items():
            check(np.isfinite(after).all() and after[0] < before[0],
                  f"{name}: the clarity terms went {before[0]} -> "
                  f"{after[0]} in {WF_DESCENT_STEPS} steps")
        out["clarity"] = {"styles": WF_MEDIA, "steps": WF_CLARITY_STEPS,
                          "batch": WF_CLARITY_BATCH, "seconds": sec,
                          "s_per_style": sec / WF_MEDIA,
                          "host_s_per_stroke": stroke_s,
                          "default_objective_before_after": report,
                          "clarity_terms_descent": falls}
        print("[brush] clarity " + json.dumps(out["clarity"]), flush=True)

        # ---- 5. CLIP search: ViT-B/32 (seeded), then the fallback -------
        clip_path = os.path.join(root, "clip_vitb32.pt")
        bpe_path = os.path.join(root, "bpe_simple_vocab.txt.gz")
        torch.save(rl.clip_state_dict(SEED), clip_path)
        rl.write_bpe_merges(bpe_path, rl.bpe_merges_for(
            WF_QUERY.split() + ["soft", "charcoal", "wash"]))
        clip_dir = os.path.join(root, "clip")
        cargv = ["--gan_checkpoint", bundle, "--library", lib_path,
                 "--query", WF_QUERY, "--top_k", "3", "--output_dir",
                 clip_dir, "--clip_weights", clip_path, "--clip_bpe",
                 bpe_path, "--device", "cuda"]
        found, search_s = counted("clip_search",
                                  lambda: clip_search_main.main(cargv))
        schedule["clip_search"] = WF_MEDIA * n_up      # one icon per style
        check(found["backbone"] == "clip" and len(found["results"]) == 3
              and all(k in names and np.isfinite(s)
                      for k, s in found["results"]),
              f"CLIP search: {found}")
        opt_res, opt_s = counted("clip_optimize", lambda: clip_search_main
                                 .main(cargv + ["--optimize", "--num_steps",
                                                str(WF_CLIP_STEPS)]))
        schedule["clip_optimize"] = WF_CLIP_STEPS * n_up
        clip_pkl = opt_res["path"]
        check(os.path.isfile(clip_pkl)
              and np.isfinite(opt_res["optimized"]["w"]).all()
              and np.isfinite(opt_res["optimized"]["loss"]),
              f"CLIP --optimize: {opt_res.get('optimized')}")
        hashed, hash_s = counted("clip_hashing", lambda: clip_search_main
                                 .main(cargv[:8] + [
                                     "--output_dir",
                                     os.path.join(root, "clip_hashing"),
                                     "--optimize", "--num_steps",
                                     str(WF_CLIP_STEPS), "--device",
                                     "cuda"]))
        schedule["clip_hashing"] = (WF_MEDIA + WF_CLIP_STEPS) * n_up
        check(hashed["backbone"] == "hashing"
              and np.isfinite(hashed["optimized"]["w"]).all(),
              f"hashing fallback: {hashed['backbone']}")
        # ms per CLIP optimizer step, after the CLI's warm-up.
        backbone = clip_search.CLIPBackbone(clip_path, bpe_path,
                                            device="cuda")
        w0 = np.asarray(lib[names[0]]["w"], np.float32)
        batches = itertools.cycle(held_geoms)
        optimizer = clip_search.ClipStyleOptimizer(
            engine, backbone, clip_search.ClipOptConfig(
                num_steps=WF_CLIP_TIMED))
        _, opt_timed = counted("clip_timed", lambda: optimizer.optimize(
            WF_QUERY, w0, batches))
        schedule["clip_timed"] = WF_CLIP_TIMED * n_up
        # encode_image / encode_text at ViT-B/32 widths, card vs CPU.
        cpu_backbone = clip_search.CLIPBackbone(clip_path, bpe_path,
                                                device="cpu")
        check(backbone.cfg.vision_width == 768
              and backbone.cfg.image_resolution == 224
              and backbone.cfg.vision_patch == 32
              and backbone.cfg.text_width == 512
              and backbone.cfg.vocab_size == 49408,
              f"ViT-B/32 config: {backbone.cfg}")
        imgs = np.random.RandomState(SEED).rand(2, RES, RES, 3).astype(
            np.float32)
        texts = [WF_QUERY, "soft charcoal wash"]
        with torch.no_grad():
            enc = {dev: (b.encode_image(torch.as_tensor(imgs, device=dev))
                         .cpu().numpy(),
                         b.encode_text(texts).cpu().numpy())
                   for dev, b in (("cuda", backbone), ("cpu", cpu_backbone))}
        clip_err = max(float(np.abs(enc["cuda"][i] - enc["cpu"][i]).max())
                       for i in (0, 1))
        check(clip_err <= WF_RTOL, f"CLIP card vs CPU: {clip_err:.3e}")
        out["clip"] = {
            "search_seconds": search_s, "optimize_cli_seconds": opt_s,
            "hashing_cli_seconds": hash_s, "top": found["results"],
            "optimizer_ms_per_step": opt_timed * 1e3 / WF_CLIP_TIMED,
            "card_vs_cpu_max_err": clip_err}
        print("[brush] clip " + json.dumps(out["clip"]), flush=True)
        del backbone, cpu_backbone, optimizer

        # ---- 6. the W-space CLIs ----------------------------------------
        ws_file = os.path.join(root, "ws.bin")
        ws, _ = counted("get_ws", lambda: get_ws_main.main([
            "--gan_checkpoint", bundle, "--seeds", f"0-{WF_WS - 1}",
            "--output_file", ws_file, "--device", "cuda"]))
        schedule["get_ws"] = 0
        check(ws.shape == (WF_WS, gen_cfg.w_dim) and np.isfinite(ws).all()
              and os.path.getsize(ws_file) == ws.size * 8,
              f"get_ws_main: {ws.shape}")
        sheet, _ = counted("seed_expand", lambda: seed_expand.main([
            "--gan_checkpoint", bundle, "--seed", "7", "--grid",
            str(WF_GRID), "--output_dir", os.path.join(root, "grid"),
            "--device", "cuda"]))
        schedule["seed_expand"] = WF_GRID ** 2 * n_up
        rows, _ = counted("pca", lambda: visualize_pca_main.main([
            "--gan_checkpoint", bundle, "--ws_file", ws_file,
            "--num_components", "2", "--num_steps", "3", "--output_dir",
            os.path.join(root, "pca"), "--device", "cuda"]))
        schedule["pca"] = 2 * 3 * n_up
        for path in [os.path.join(root, "grid", "seed7_grid.png")] + [
                os.path.join(root, "pca", f"pca_{i}.png") for i in (0, 1)]:
            with open(path, "rb") as f:
                img = read_png(f.read())
            check(img.ndim == 3 and img.shape[-1] == 3 and img.std() > 0,
                  f"{path}: {img.shape}")
        check(np.isfinite(sheet).all() and len(rows) == 2,
              "the W-space sheets")

        # ---- 7. serve the libraries, paint with a projected brush -------
        seeds = os.path.join(root, "seeds.txt")
        with open(seeds, "w") as f:
            f.write("3\n7\n11\n21\n42\n")
        specs = parse_libraries(
            f"Seeds:disp:{seeds},Projected:disp:{lib_path},"
            f"Opt:disp:{opt_path},Clip:disp:{clip_pkl}")
        core = create_core(gan_checkpoint=bundle, library_specs=specs,
                           device="cuda")
        try:
            counts = {k: len(v.get_style_ids())
                      for k, v in core.libraries.items()}
            check(counts == {"Seeds": 5, "Projected": WF_MEDIA,
                             "Opt": WF_MEDIA, "Clip": 1},
                  f"served libraries {counts}")
            patches = stroke_patches(RES)
            room = WF_CANVAS - RES + 1
            plan = [(i % len(patches), 37 * i % room, 53 * i % room)
                    for i in range(WF_STROKES)]
            before = fir4_epilogue.launches
            served, info_launches = asyncio.run(_serve_brush(
                core, "Projected", names[0], patches, plan))
            torch.cuda.synchronize()
            launches["serve"] = fir4_epilogue.launches - before
            schedule["serve"] = WF_STROKES * n_up + info_launches
            check(info_launches % n_up == 0, f"brush info launched K1 "
                  f"{info_launches} times")
            projected = core.libraries["Projected"]

            def compare():
                """Each served image against render_stroke with the same
                style (and without its noise textures)."""
                worst, noise_lsb = 0, 0
                for (idx, x, y), (img, meta) in zip(plan, served):
                    check(meta == {"x": x, "y": y}, f"served meta {meta}")
                    opts = GanBrushOptions()
                    projected.set_style(names[0], opts)
                    opts.set_position(x, y)
                    direct = core.engine.render_stroke(patches[idx], None,
                                                       opts)[0]
                    worst = max(worst, _u8_err(img, direct))
                    opts.custom_args = {}
                    plain = core.engine.render_stroke(patches[idx], None,
                                                      opts)[0]
                    noise_lsb = max(noise_lsb, _u8_err(img, plain))
                return worst, noise_lsb

            (worst, noise_lsb), _ = counted("serve_check", compare)
            schedule["serve_check"] = 2 * WF_STROKES * n_up
            check(worst <= 1, f"served strokes {worst} LSB off "
                  f"render_stroke")
            check(noise_lsb > 1, f"the projected noise moved the served "
                  f"strokes by {noise_lsb} LSB only")
        finally:
            core.close()
        out["serve"] = {"strokes": WF_STROKES, "vs_render_stroke_lsb": worst,
                        "vs_default_noise_lsb": noise_lsb,
                        "libraries": counts}
        print("[brush] serve " + json.dumps(out["serve"]), flush=True)

        # ---- 8. launches against the schedule; every K1 shape held ------
        for name, want in schedule.items():
            if want is not None:
                check(launches[name] == want, f"K1 launched "
                      f"{launches[name]} times in {name}, the schedule "
                      f"says {want}")
        out["launches_by_step"] = launches
        out["launches"] = fir4_epilogue.launches   # the workflow ends here
        check(sum(launches.values()) == out["launches"],
              f"K1 launches outside the counted steps: {out['launches']} "
              f"against {launches}")
        launched = sorted(fir4_epilogue.shapes)
        check(set(launched) <= held, f"K1 launched at shapes phase 3 did "
              f"not hold against the plain version: "
              f"{sorted(set(launched) - held)}")
        out["k1_shapes"] = [list(k) for k in launched]
        print(f"[brush] K1 launched {out['launches']} times at "
              f"{len(launched)} shapes, each held in phase 3: "
              f"{json.dumps(out['k1_shapes'])}", flush=True)
    finally:
        _stop(media["proc"])
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    print(f"[brush] phase {out['seconds']:.1f} s", flush=True)
    return out


def _stroke_rates():
    """Strokes/s of ``draw_stroke`` (the native rasterizer) and of its numpy
    form on the same seeded splines at each of DC_STROKE_WIDTHS, with their
    max abs difference."""
    import numpy as np
    from brushstroke_engine_torch.data import curves
    rows = []
    for width in DC_STROKE_WIDTHS:
        rng = np.random.default_rng(SEED + width)
        splines = [(curves.random_spline_points(rng, width),
                    curves.sample_radius(rng))
                   for _ in range(DC_STROKES_NATIVE)]
        t0 = time.perf_counter()
        got = [curves.draw_stroke(width, p, r) for p, r in splines]
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [curves.draw_stroke_numpy(width, p, r)
                for p, r in splines[:DC_STROKES_NUMPY]]
        numpy_s = time.perf_counter() - t0
        err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        check(err <= DC_STROKE_ATOL, f"native strokes at {width} px are "
              f"{err:.3e} from numpy's (bound {DC_STROKE_ATOL})")
        rows.append({"width": width,
                     "native_strokes_per_s": DC_STROKES_NATIVE / native_s,
                     "numpy_strokes_per_s": DC_STROKES_NUMPY / numpy_s,
                     "native_s_per_stroke": native_s / DC_STROKES_NATIVE,
                     "numpy_s_per_stroke": numpy_s / DC_STROKES_NUMPY,
                     "max_abs_diff": err})
    return rows


def _members(path):
    """{name: decoded image as stored} of every member of a zip."""
    import zipfile
    from brushstroke_engine_torch.utils.img_proc import read_image
    with zipfile.ZipFile(path) as zf:
        return {n: read_image(zf.read(n), None) for n in zf.namelist()}


def _check_chain_outputs(d, out):
    """Every member of the chain's zips and folders (see DC_* above)."""
    import numpy as np
    from brushstroke_engine_torch.data.curves import triband_from_stroke
    from brushstroke_engine_torch.utils.img_proc import (
        patch_entropy, read_image,
    )
    style = _members(d["style_zip"])
    check(len(style) == DC_MEDIA and all(
        a.dtype == np.uint8 and a.shape == (DC_MEDIA_RES, DC_MEDIA_RES, 3)
        for a in style.values()), f"style zip: {len(style)} members, "
        f"shapes {sorted({a.shape for a in style.values()})}")
    geom = _members(d["geom_zip"])
    check(len(geom) == DC_SPLINES, f"geometry zip: {len(geom)} members")
    for name, a in geom.items():
        check(a.dtype == np.uint8
              and a.shape == (DC_SPLINE_RES, DC_SPLINE_RES, 3),
              f"geometry {name}: {a.dtype} {a.shape}")
        g = a[..., 1]
        check(set(np.unique(g)) <= {0, 255}, f"geometry {name}: G is not "
              f"binary")
        blur = triband_from_stroke(g.astype(np.float32) / 255.0)[..., 2]
        check(np.array_equal(a[..., 2], (np.clip(blur, 0, 1) * 255).astype(
            np.uint8)), f"geometry {name}: B is not the blur of G")
    patches = _members(d["patch_zip"])
    check(patches, "patch_augment wrote no patch")
    low = [n for n, a in patches.items() if patch_entropy(
        a.astype(np.float32).mean(-1) / 255.0) < DC_MIN_ENTROPY]
    check(not low and all(a.shape == (DC_PATCH_WIDTH, DC_PATCH_WIDTH, 3)
                          for a in patches.values()),
          f"patches below --min_entropy {DC_MIN_ENTROPY}: {low[:4]}")
    tri = sorted(os.listdir(d["triband"]))
    check(sorted(os.listdir(d["reformat"])) == tri and len(tri) ==
          DC_SPLINES, "reformat_triband_data_main: names differ")
    for name in tri:
        check(np.array_equal(
            read_image(os.path.join(d["reformat"], name), None),
            read_image(os.path.join(d["triband"], name), None)[..., ::-1]),
            f"reformat {name}: channels not reversed")
    styles = sorted(os.listdir(d["styles"]))
    check(styles == [f"{i:04d}.png" for i in range(DC_STYLES)],
          f"make_synthetic_styles: {len(styles)} images")
    out["members"] = {"style_zip": len(style), "geom_zip": len(geom),
                      "patch_zip": len(patches), "triband": len(tri),
                      "styles": len(styles)}


def phase_data_chain(card, held, warp_held):
    """The data chain (see DC_* above, phase 14): the six data CLIs, the AE
    trainer and ``tools/train.py`` on the zips they made.  ``held`` /
    ``warp_held``: the K1 and W / W^T shapes phases 3 and 5 held."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from brushstroke_engine_torch import native
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from brushstroke_engine_torch.tools import (
        create_splines, dataset_tool, make_synthetic_media,
        make_synthetic_styles, patch_augment, prep_geom_data,
        reformat_triband_data_main, train_autoencoder,
    )
    from brushstroke_engine_torch.tools import train as train_cli

    check(native.available(), f"the native stroke rasterizer is not "
          f"loaded: {native.load_error()}")
    set_precision_mode("strict")
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    out = {"card": card, "cuts": DC_CUTS}
    try:
        out["strokes"] = _stroke_rates()
        for row in out["strokes"]:
            print("[data] strokes " + json.dumps(row) + f" ({card})",
                  flush=True)
        d = {k: os.path.join(root, k) for k in (
            "media", "splines", "triband", "reformat", "styles", "ae",
            "runs")}
        d.update({k: os.path.join(root, k + ".zip") for k in (
            "style_zip", "geom_zip", "patch_zip")})
        seconds = {}
        runs = [
            ("make_synthetic_media", make_synthetic_media, [
                "--output_dir", d["media"], "--num_images", DC_MEDIA,
                "--resolution", DC_MEDIA_RES, "--seed", SEED]),
            ("dataset_tool style", dataset_tool, [
                "--source", d["media"], "--dest", d["style_zip"],
                "--resolution", DC_MEDIA_RES]),
            ("create_splines", create_splines, [
                "--output_dir", d["splines"], "--num_images", DC_SPLINES,
                "--width", DC_SPLINE_RES, "--seed", SEED, "--workers",
                DC_WORKERS]),
            ("prep_geom_data", prep_geom_data, [
                "--input_dir", d["splines"], "--output_dir", d["triband"]]),
            ("dataset_tool geometry", dataset_tool, [
                "--source", d["triband"], "--dest", d["geom_zip"],
                "--resolution", DC_SPLINE_RES]),
            ("patch_augment", patch_augment, [
                "--input_dir", d["media"], "--output_zip", d["patch_zip"],
                "--patch_width", DC_PATCH_WIDTH, "--patches_per_image",
                DC_PATCHES, "--min_entropy", DC_MIN_ENTROPY, "--seed",
                SEED]),
            ("reformat_triband_data_main", reformat_triband_data_main, [
                "--input_dir", d["triband"], "--output_dir", d["reformat"],
                "--channel_order", "2,1,0"]),
            ("make_synthetic_styles", make_synthetic_styles, [
                "--output_dir", d["styles"], "--num_images", DC_STYLES,
                "--resolution", DC_MEDIA_RES, "--seed", SEED]),
        ]
        for name, cli, argv in runs:
            t0 = time.perf_counter()
            cli.main([str(a) for a in argv])
            seconds[name] = time.perf_counter() - t0
        out["cli_seconds"] = seconds
        print("[data] CLI seconds " + json.dumps(seconds) + f" ({card})",
              flush=True)
        _check_chain_outputs(d, out)
        print(f"[data] members {json.dumps(out['members'])}; {DC_CUTS}",
              flush=True)

        # The AE on the geometry zip (no generator: no kernel launches).
        t0 = time.perf_counter()
        _, _, losses = train_autoencoder.main([
            "--data", d["geom_zip"], "--run_dir", d["ae"], "--num_steps",
            str(DC_AE_STEPS), "--widths", "128", "--seed", str(SEED),
            "--device", "cuda"])
        torch.cuda.synchronize()
        ae_s = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        first = float(np.mean(losses[:DC_AE_WINDOW]))
        last = float(np.mean(losses[-DC_AE_WINDOW:]))
        check(len(losses) == DC_AE_STEPS and np.isfinite(losses).all()
              and last < first, f"AE on the geometry zip: first "
              f"{DC_AE_WINDOW} mean {first:.4f}, last {last:.4f}")
        out["autoencoder"] = {"steps": DC_AE_STEPS, "seconds": ae_s,
                              "steps_per_s": DC_AE_STEPS / ae_s,
                              "loss_first": first, "loss_last": last}
        print("[data] autoencoder " + json.dumps(out["autoencoder"])
              + f" ({card})", flush=True)

        # tools/train.py on both zips with that encoder.
        fir4_epilogue.launches = 0     # the data chain's training starts
        fir4_epilogue.shapes.clear()
        for fn in (tw.warp_twopass, tw.warp_twopass_t):
            fn.launches = 0
            fn.shapes.clear()
        t0 = time.perf_counter()
        loop, _ = train_cli.build(
            ["--data", d["style_zip"], "--geom_data", d["geom_zip"],
             "--encoder_checkpt", os.path.join(d["ae"], "ae_latest.pkl"),
             "--outdir", d["runs"], "--device", "cuda"]
            + _flag_lines("train_flags.txt") + CKPT_CLI_CUTS)
        loop.profile_phases = True
        loop.run(total_kimg=DC_TRAIN_BATCHES * TRAIN_BATCH / 1000.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"] = _launch_counts()    # the data chain ends here
        n = loop.batch_idx
        sched, want = _cli_schedule(loop.cfg, n)
        check(n == DC_TRAIN_BATCHES and out["launches"] == want,
              f"tools/train.py on the zips: {n} batches, launches "
              f"{out['launches']}, the schedule {sched} says {want}")
        _finite_stats(os.path.join(loop.run_dir, "stats.jsonl"))
        launched = sorted(fir4_epilogue.shapes)
        check(set(launched) <= held, f"K1 launched at shapes phase 3 did "
              f"not hold: {sorted(set(launched) - held)}")
        for name, fn in (("warp_twopass", tw.warp_twopass),
                         ("warp_twopass_t", tw.warp_twopass_t)):
            check(fn.shapes <= warp_held[name], f"{name} launched at "
                  f"shapes phase 5 did not hold: "
                  f"{sorted(fn.shapes - warp_held[name])}")
        out["train"] = {"batches": n, "wall_s": wall,
                        "phase_s": {k: sum(v) for k, v in
                                    loop.phase_seconds.items()},
                        "k1_shapes": [list(k) for k in launched]}
        print("[data] tools/train.py on the zips " + json.dumps(out["train"])
              + f"; launches {json.dumps(out['launches'])} ({card})",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    print(f"[data] phase {out['seconds']:.1f} s", flush=True)
    return out


def main():
    t_start = time.time()
    card = phase_card()
    import torch
    sys.path.insert(0, REPO)
    # Every host stroke of the run is drawn by the native rasterizer; the
    # numpy fallback is not what the card's users run.
    from brushstroke_engine_torch import native
    check(native.available(), f"the native stroke rasterizer is not "
          f"loaded: {native.load_error()}")
    # The training data starts prefetching now: rasterizing the synthetic
    # geometry on the host takes about as long as the kernel phases.
    from brushstroke_engine_torch.flagship import synthetic_data_iters
    style_iter, geom_iter = synthetic_data_iters(TRAIN_RES, TRAIN_BATCH, SEED)
    # Phase 13's media are drawn on the host meanwhile, in a process.
    from brushstroke_engine_torch.ops.cuda_build import BUILD_DIR
    media = start_media(os.path.join(BUILD_DIR, "brush_workflow"))
    atexit.register(_stop, media["proc"])
    phase_build()
    rows, max_err, held = phase_kernel_vs_plain()
    fir_bwd = phase_fir_backward()
    warp_rows, warp_err, warp_held = phase_warp_vs_plain()
    main_stats = phase_main_path()
    train = phase_train(style_iter, geom_iter, card)
    paint = phase_paint(card)
    serve = phase_serve(card)
    train_cli = phase_train_cli(style_iter, geom_iter, card, held)
    ckpt = phase_checkpoint(geom_iter, card, held)
    stitch = phase_stitch(style_iter, geom_iter, card, held, warp_held)
    brush = phase_brush_workflow(card, held, media)
    data = phase_data_chain(card, held, warp_held)

    top = next(r for r in rows if r["res"] == RES and r["dtype"] == "float32")
    warp = next(r for r in warp_rows if r["mats"] == "ada_p1"
                and r["shape"][0] == TRAIN_BATCH and r["antialias"])
    kernels = [{
        "name": "fir4_epilogue",
        "route": "cuda",
        "source": "brushstroke_engine_torch/csrc/fir4_epilogue.cu",
        "replaces": "brushstroke_engine_tpu/ops/pallas_fir.py:85",
        "launches": main_stats["launches"]
        + train["launches"]["fir4_epilogue"] + paint["launches"]
        + serve["launches"] + train_cli["launches"]["fir4_epilogue"]
        + ckpt["launches"]["fir4_epilogue"]
        + stitch["launches"]["fir4_epilogue"] + brush["launches"]
        + data["launches"]["fir4_epilogue"],
        "launches_render_path": main_stats["launches"],
        "launches_training_path": train["launches"]["fir4_epilogue"],
        "launches_paint_path": paint["launches"],
        "launches_serve_path": serve["launches"],
        "launches_train_run": train_cli["launches"]["fir4_epilogue"],
        "launches_checkpoint_path": ckpt["launches"]["fir4_epilogue"],
        "launches_stitch_path": stitch["launches"]["fir4_epilogue"],
        "launches_brush_workflow_path": brush["launches"],
        "launches_data_chain_path": data["launches"]["fir4_epilogue"],
        "max_abs_err": max_err[torch.float32],
        "max_abs_err_bf16": max_err[torch.bfloat16],
        "backward_max_rel_err": fir_bwd["worst_rel_err"],
        "backward_max_rel_err_bf16": fir_bwd["worst_rel_err_bf16"],
        "ms": top["kernel_ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": f"B={BATCH} res={RES} C={top['channels']} float32, "
                 f"noise+clamp",
    }]
    for name, fn, key, err in (
            ("warp_twopass", "_fwd_kernel", "w", "max_abs_err_w"),
            ("warp_twopass_t", "_bwd_kernel", "wt", "max_abs_err_wt")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "brushstroke_engine_torch/csrc/warp_twopass.cu",
            "replaces": "brushstroke_engine_tpu/ops/pallas_warp.py:"
                        + ("125" if fn == "_fwd_kernel" else "156"),
            "launches": train["launches"][name]
            + train_cli["launches"][name] + ckpt["launches"][name]
            + stitch["launches"][name] + data["launches"][name],
            "launches_training_path": train["launches"][name],
            "launches_train_run": train_cli["launches"][name],
            "launches_checkpoint_path": ckpt["launches"][name],
            "launches_stitch_path": stitch["launches"][name],
            "launches_data_chain_path": data["launches"][name],
            "max_abs_err": warp_err[key],
            "ms": warp[f"{key}_ms"],
            "plain_ms": warp[f"{key}_plain_ms"],
            "bound_ms": warp["bound_ms"],
            "bound_by": warp["bound_by"],
            "library_ms": warp[f"{key}_library_ms"],
            "shape": f"{warp['shape']} float32, ADA 'bgc' matrices at p=1, "
                     f"antialias",
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched")
    print(json.dumps({"main_path": main_stats, "training_path": train,
                      "paint_path": paint, "serve_path": serve,
                      "train_run": train_cli, "checkpoint_path": ckpt,
                      "stitch_path": stitch, "brush_workflow": brush,
                      "data_chain": data,
                      "seconds": time.time() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
