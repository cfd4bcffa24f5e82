"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU, for a LowRank field and for a MixedFeature hash-grid field, on
a synthetic scene and on a multi-cascade COLMAP scene, the encoder
formulation probes (mfnerf_tpu_torch/benchmarking/), data parallelism
(two ranks sharing the card), the fp32 hat kernels, LPIPS, RTMV from
its OpenEXR frames, and the march and composite kernels against their
plain versions.

    python3 chip_smoke.py

Phases (one line each; any failure ends the run with a non-zero exit):

1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc, Triton;
2. build, 11. build_hashgrid, 16a. build_linetable, 36. build_raymarch and
   37. build_composite: compile the hat-product, the hash-grid, the
   line-table, the march and the composite kernels from
   mfnerf_tpu_torch/csrc/, one nvcc each, started together; then (ptxas)
   what ptxas said in those builds (build.ptxas_report) of the registers,
   spills and shared memory of march_train_kernel and of each
   instantiation of the composite training forward's and backward's
   kernels;
3. kernel: hat_prod's kernel against its plain torch version at the serving
   shapes (N = 2^20 samples, K = 257 knots, R = 128 columns), with both times;
4. state: a seeded bench-width LowRank field and one dense occupancy refresh
   (2,097,152 cells through the kernel);
5. serve: eight distinct 800x800 frames of the procedural scene through
   render_test (the alive-ray loop), T_threshold 1e-2; the kernel's launch
   count, the window march's and the compositing round's are reset just
   before and read just after (one round a window march);
6. oracle: a strided ~8k-ray subset of frame 0 against the plain dense
   oracle render_test_dense (run on the CPU, where hat_prod is the plain
   version);
7. kernel_bwd: hat_prod's backward kernel against its plain torch version at
   the padded training step's largest shapes (N = 8192 x 64 = 2^19 samples
   of uniform u, K = 257, R = 128): dW bitwise equal across launches (with
   and without du), dW and du against the plain version, the kernel's time
   beside its bound; then the same checks on ragged edges (R = 40, N =
   2,100 in two chunks, a strided g);
8. train_step_oracle: one training step's loss and parameter gradients on
   the card (both kernels) against the same step on the CPU (the plain
   versions), same weights, rays and march jitter;
8b, 8c. train_step_oracle_ext and train_step_oracle_bf16: one step of the
   trainer (NeRFSystem.step_loss) under --optimize_ext (dR and dT drawn
   N(0, EXT_OFFSET^2); the hat backward with du) and under --bf16, card
   against CPU (LOSS_TOL and GRAD_TOL; under --bf16 BF16_LOSS_TOL and
   BF16_GRAD_TOL), every gradient, dR and dT included;
9. train: the JAX bench's training configuration (bench.py: 8192-ray
   batches, lr 1e-2, half-dense refresh every 16 steps, --s_flat 16,
   --pool_a 4) on 16 procedural 800x800 views for 900 steps through
   NeRFSystem.fit (the fused runner's graphs: the padded step's from step
   0, the flat step's from FLAT_AFTER = 512; the timed chunks wholly past
   it reported apart); both kernels' launch
   counts and the training march's are reset just before and read just
   after (at least one march a step; the graphs' replays count the
   launches their capture recorded);
10. test_view: the held-out 800x800 view through render_test (T_threshold
   1e-4) before and after training;
9b. train_bf16: phase 9 under --bf16, its ms/step and held-out view beside
   phase 9's;
7b. kernel_bwd (shape "train"): phase 7's checks and times on the operands
   of one real training step of the trained field (one LowRank frame's u
   and g as HatProd.backward receives them: g a column slice of the (N, 2R)
   feature gradient, read in place), and hat_prod's time on the same u
   (through its wrapper, so at this size mostly the host's;
   tools/hat_bwd_ab.py times the kernel alone); then the forward kernel as
   the step runs it, on the capacity buffer with the step's valid count,
   by graph replay beside its bound (u of the valid rows, W, the whole
   output);
12. kernel_hashgrid: the hash-grid kernels against their plain torch
   versions for the CLI's default Hash grid (L 16, F 2, T 19) and the
   reference's MixedFeature benchmark grid (T 20, 8 tables), both 5,710,032
   rows, at N = 2^19 uniform x with points on the box faces; for the
   MixedFeature grid also at 2^19 samples along 40,330 rays (13 consecutive
   samples a ray at the march step, as training orders them) and at a
   degenerate set in which each warp's 32 samples share one point: the
   forward bit for bit, the backward's d_params bitwise equal across three
   launches and to the fixed-point model hashgrid_bwd_fixed_plain (exact,
   sampled at one corner with the same uniforms, and windowed), d_params,
   d_x and d_window (window alpha 0.6) within HASH_TOL of the plain
   version, the fixed-point scale 2^k, the backward's atomics with one an
   update and after the warp's merge of equal rows, the kernels' device
   times by CUDA-graph replay beside their bounds (and, host time included,
   through their wrappers) and the plain times; then the kernels' generic
   path (F 4, L 12) at 2^16 points;
13. train_step_oracle_mf: one step of the MixedFeature bench configuration
   (benchmarking/benchmark_synthetic_nerf_mf.sh: batch 16384, lr 2e-2, rgb
   128 x 2) on the card against the same step on the CPU, exact and with
   the sampled-corner table gradient (the same uniforms);
13b, 13c. train_step_oracle_ext (the hash backward with d_x) and
   train_step_oracle_bf16 for the MixedFeature configuration;
14. train_mf: 900 steps of it on the 16 procedural views through
   NeRFSystem.fit, as phase 9; the hash-grid kernels' launch counts are
   reset just before and read just after;
38, 39, 40. fused (bench after 37a, mf after 37b, mf360_black and lr360
   in phase 21): the fused runner (NeRFSystem.fit's CUDA graphs of the
   static step and of each refresh parity) on the trained field of phase
   9 or 14 (the flat step's graph), or of phase 21's MF360_BLACK_ARGS and
   LR360_ARGS runs at --scale 8 (the padded step's, s_flat 0, past
   FLAT_AFTER): FUSED_STEPS steps run
   eagerly and the same steps replayed from the same parameters, Adam
   state, occupancy and generator state, equal bit for bit (parameters,
   Adam state, occupancy, every step's metrics); a refresh and a static
   step under torch.cuda.set_sync_debug_mode("error"); ms/step eager (P)
   and graphed (T) in the turns PTTPPT, FUSED_CHUNK synced steps a turn,
   the medians; FUSED_PROFILE steps of each under torch.profiler (device
   busy and idle share, device activities a step); the launches the step's
   capture recorded; the encoder kernels' valid count on a step's
   operands (check_count_kernels);
41. fused_from_zero (bench after 38, mf360_black in phase 20): two
   systems drawn alike from SEED, FUSED_STEPS steps from step 0 each,
   eagerly and through the fused runner (the padded step's warm-up,
   capture and replays, both refresh parities): parameters, Adam state,
   occupancy and every step's metrics equal bit for bit;
42. serve_graphed (42a after 10b: the trained bench view at TEST_T and
   T_THRESHOLD; 42b after 15b: the MixedFeature view; 42c in phase 20:
   the LowRank recipe's five-cascade view at 400x400): render_test's
   rounds on capacity buffers replayed as CUDA graphs against the same
   rounds run eagerly, bit for bit, and across two frames; against the
   valid-only loop (valid_only_frame) within SERVE_AB_TOL but on
   threshold ties (frame_gap), PSNR within SERVE_PSNR_TOL; the graphed
   frame under torch.cuda.set_sync_debug_mode("error") with at most two
   host reads a round and one a frame, one window march and one
   compositing round a round; the field's slots at most twice a round's
   valid samples or the floor; ms a frame eager and graphed in turns;
   phases 36-37 hold the kernels' alive-count variants to their plain
   versions (check_window_count, check_round_count: the edge sets with a
   quarter of the rows cut, and the frame's first round at its tier,
   timed);
15. test_view_mf: the held-out view through render_test before and after
   training, with the forward kernel's launch count (a gain of 8 dB over
   the untrained field, and at least MF_PSNR_MIN);
12b. kernel_hashgrid (shape "train"): phase 12's checks and times on one
   real step's operands of the trained MixedFeature field (x and g as
   HashGridEncode.backward receives them);
36. march, 36a-c: each march kernel of csrc/raymarch.cu (march_train,
   march_window) against its plain version on the card, bit for bit (ts,
   deltas, xyzs, mask, n_samples, t_start, rm_samples, and k_idx on the
   valid slots; for the window, run in place as the serving loop runs it
   (march_rays_window_into), every output, the cursor and exhausted, the
   frame's cursor after it (the alive rows moved, the others unchanged),
   and each window set also against the skip model
   march_rays_window_skip_plain):
   36a on the trained bench field (phase 9) for one step's rays (the
   two-level strata), N_MARCH_DEGENERATE degenerate rays (missing the box,
   starting inside it, along the axes, grazing a face), an empty and a
   full bitfield (each budgeted and exact), the dense oracle's rank
   windows on every MARCH_ORACLE_STRIDE-th ray of the held-out view, the
   training kernel's edge sets with gradients (the cap and the exit inside
   a pass, rank_start 40, 128 and 200, exact marches of 20, 50 and 1000
   rungs, budgets of one and two strata, one stratum at 1,024 rays), every
   window march of one
   render_test frame of it (the stage-A skip), and the
   window edge sets (an empty and a full bitfield, degenerate rays at
   mid-ladder cursors, |d| three times dir_norm, windows of stratum + 1 and
   3 stratum - 1 rungs; three quarters of each set's rows alive); 36b on a
   step of the trained MixedFeature field (phase 14); 36c in phase 20, on
   each recipe's cascade step (the union grid's strata, and exact), on the
   windows of its five-cascade serving loop and on the edge sets there
   (every rung walked). The step's march and every round of the bench
   frame (the cascade frames': the first) are timed by CUDA-graph replay,
   the window in place (each replay restores the frame's cursor first, and
   the restore's own time is taken off), beside their plain
   versions and bounds (bytes of the rays, the bitfield, the stage-A grid
   and the sample buffers; MARCH_OPS_PER_RUNG a rung up to each ray's
   last sample), with the operations of the rung-by-rung walk's rungs
   beside them. The train, train_mf, cli and cli_colmap phases count the
   march kernels' launches over their runs;
37. composite, 37a-c: each composite kernel of csrc/composite.cu
   (composite_train's forward and analytic backward, composite_test_step
   and its in-place form) against its plain version on the card: the
   forward's ws, opacity, depth and rgb within COMPOSITE_FWD_TOL x max and
   each row's included samples equal, on the rows clear of T_threshold
   (rows within COMPOSITE_TIE_ULPS of it are counted apart), and on every
   row bit for bit this tree's pass-by-pass forward kernel (kept for rows
   of more than four passes; an earlier tree's kernel is built only by
   tools/composite_check.py --fwd-ab), the kernels' order model
   composite_train_fwd_order_plain, and, in ws, the backward kernel's
   weights (d_rgbs given g_rgb = 1); the backward
   within COMPOSITE_BWD_TOL relative L2 of composite_train_bwd_plain and
   of autograd through composite_train_plain, for seeded incoming
   gradients of all four outputs, of all but ws and the loss's own, and
   bit for bit this tree's two-walk backward kernel (kept for rows of
   more than four passes; an earlier tree's kernel is built only by
   tools/composite_check.py --bwd-ab) on each (and, reported, to the
   kernels' order model composite_train_bwd_order_plain), each output left
   out once without changing the others' bits; each kernel bit for bit across two launches.
   37a on the trained bench field (phase 9): one step's block, the edge
   blocks (an opaque first sample, the threshold tie, masked holes, empty
   rows, S = 256, and S = 8, 40, 64, 128 and 200 with holes and rows
   saturating in mid-pass), every round of one
   render_test frame of the held-out view, and the edge blocks as serving
   rounds; 37b on a step of the trained MixedFeature field (phase 14); 37c
   in phase 20, on each recipe's cascade step (the card's step of the
   oracle) and the rounds of its five-cascade serving loop. The step's
   forward and backward (and the two-walk backward) and the frame's first
   round are timed by CUDA-graph replay beside their plain versions and
   bounds. The train,
   train_mf, cli and cli_colmap phases check one forward and one backward
   launch a step and one round a window march;
19. cli: the command line (mfnerf_tpu_torch/train.py main, CLI_ARGS: the
   bench.py LowRank model, 600 steps) on the 800x800 procedural scene
   (16 train and 2 test views) written in the NSVF layout under a temporary
   working directory: the load time (datasets/png.py), the loaded rays
   against the in-memory images (CLI_LOAD_TOL), main in process (ms/step
   synced around fit, both hat kernels' launch counts over the run, test
   PSNR at least PSNR_MIN and SSIM, the checkpoints' sizes, the result
   PNGs), then "python -m mfnerf_tpu_torch.train --val_only --ckpt_path"
   as a subprocess, whose test PSNR must equal the in-process one within
   CLI_PSNR_TOL;
22. cli_ext: main --optimize_ext --pose_lr 2e-3 (EXT_ARGS) on the cli's
   scene written with perturbed training poses (perturb_poses), its steps
   served by the fused runner (fit's line says CUDA graphs): the
   gauge-corrected camera-centre error before and after (it must fall
   below EXT_ERR_SHARE of the perturbed error), ms/step, test PSNR, the
   hat backward's launches (each asking for du) and phase 7's checks and
   times on one such step's operands, du on, beside its bound; then phase
   38's checks on the trained system ("fused", config cli_ext: 48 steps
   eager against graphed bit for bit, dR, dT and their Adam state
   included; a refresh and a step under sync-debug "error"; eager and
   graphed chunks in turns, device idle);
23. cli_hdr: main --use_exposure (HDR_ARGS) on a 400x400 scene written in
   HDR-NeRF's synthetic layout (write_hdr_scene): load seconds, ms/step,
   test PSNR at each test exposure and the unit-exposure rgb; the fused
   runner serves its steps (the padded step's graph, its log line);
24. jpeg (after 2b. build_jpeg, which compiles csrc/jpeg.cpp with the host
   compiler beside the kernels' nvcc and lists what it links: no libjpeg):
   the committed fixtures (tests/data/jpeg: progressive 4:2:0 with
   restarts, 4:2:2 at an odd size, grayscale) decoded byte for byte as
   PIL decoded them, then an 800x800 4:2:0 view's decode seconds beside
   png.py's on the same view;
26. eval, 27. orbit, 28. profile, on phase 19's checkpoint in its working
   directory: mfnerf_tpu_torch/eval.py in process at T 1e-4 (its mean PSNR
   equals --val_only's within CLI_PSNR_TOL) and at 1e-2 with --mesh at
   256^3 (ms a frame, FPS, the mesh's seconds and vertices), then
   "python -m mfnerf_tpu_torch.eval"; the viewer's orbit render
   (show_gui.py) in process, 8 frames at 400x400, then "python -m
   mfnerf_tpu_torch.show_gui" (30 frames); main --profile (48 traced
   steps, then 16): the trace names the hat kernels, and the run goes on
   from step 0. The hat kernels' launches are counted in each;
20. colmap_scene and train_step_oracle_cascades: the multi-cascade path's
   scene (make_scene at COLMAP_SPREAD, 800x800, 16 train and 3 test views)
   written as a COLMAP reconstruction (write_colmap_scene) under a
   temporary working directory and loaded (datasets/colmap.py), its rays
   against the in-memory images; then for the LowRank model and the
   MixedFeature mip-NeRF 360 recipe (with its --random_bg) at --scale 8
   (five cascades; see MF360_ARGS): the culled, refreshed untrained
   field, one training step on the card (the recipe's kernels) against
   the CPU (step_oracle, the same rays, jitter and background), marched
   with the cascade strata (the union grid), which keep fewer samples than
   the exact march; and render_test at five cascades against the CPU's
   dense oracle on ~1,000 rays of a test view (phase 6's tolerances);
21. cli_colmap: main on that scene, 600 steps, for the MixedFeature recipe,
   the same without --random_bg and the LowRank model: ms/step, the last
   step's rm_s and vr_s, test PSNR and SSIM (reported: see MF360_ARGS),
   the kernels' launch counts over the run (the hash-grid pair for
   MixedFeature, the hat pair for LowRank) and fit's fused-runner line,
   which must say that CUDA graphs serve the steps (phase 40 follows on
   two of the trained fields);
25. cli_jpeg: the same scene with its views written as JPEG (quality 95,
   4:2:0, utils/procedural.py's encoder), loaded through csrc/jpeg.cpp
   (the rays on average within JPEG_LOAD_TOL of the images), and the
   LowRank run on it: load seconds, ms/step and test PSNR beside the PNG
   run's;
16. probe_gather: the port of benchmarking/probe_pallas_gather.py, run()
   at its shape (N = 2^20, RANK 8, K 128): table_lerp in idx mode bit for
   bit against its plain version, beside grid_sample; then at a ragged N;
17. probe_gather2: the port of probe_pallas_gather2.py (N = 2^19, K 513,
   R 128): table_lerp in u mode the same way, and hat_basis_dw's dW
   bitwise equal across three launches, within 1e-4 x max of its plain
   version and bit for bit equal to the model of its sums
   (hat_basis_dw_order_plain); then at a ragged N, and dW the same way on
   2^19 sorted u and 2^19 u on the knots, each set's time by CUDA-graph
   replay beside its bound;
18. probe_hatmul: the port of probe_pallas_hatmul.py, hat_prod at N = 2^19,
   K 513, R 128 bit for bit against hat_prod_plain; then at a ragged N.
   Each probe's run() is its kernels' path: their launch counts are reset
   just before it and read just after;
29. dp_one: bench.py's configuration (DP_HP) through the data-parallel
   path (parallel/dist.py) in a process group of one rank on NCCL, 20
   steps from step 0 and 20 from step 600 (the flat budget), against the
   same steps without a group, both served by the fused runner (the
   group's line says CUDA graphs in an NCCL group): parameters, bitfield
   and metrics bit for bit, and both ms/step; then in the group 48 steps
   eager against graphed bit for bit, the step captured anew with its
   collectives under sync-debug "error", eager and graphed chunks in
   turns and device idle. One rank proves the capture, not the traffic
   between cards;
30. dp_two: two ranks spawned on the one card (gloo, a test-only device
   list; the ranks' fit says the fused runner is off, gloo's collectives
   cannot be captured), for DP_HP and for the MixedFeature recipe with the
   sampled corner (DP_MF_HP), against one rank in this process: 48 steps
   from step 0 (the first step's gradients within DP_GRAD_TOL; the ranks
   bitwise equal to each other at each checkpoint, the distance to one
   rank reported) and 16 steps from step 600 whose flat cut falls inside
   rank 0 (tests/test_multichip.py's rule), with the count of such steps;
31. dp_render: render_test_sharded on the two ranks against render_test
   on the trained field's held-out view (tests/test_multichip.py's
   tolerances), and "python -m mfnerf_tpu_torch.train --num_gpus 2" on
   this one-card machine exiting with the ValueError of make_mesh;
32. hat_fp32: the fp32 instantiation of csrc/hatmul.cu
   (lr_matmul_dtype="float32"): the forward at N = 2^20 and the backward
   at 2^19 against the plain fp32 versions (phase 3's and 7's checks), one
   fp32 training step card against CPU, 300 steps in fp32 and in bf16 in
   turns, and both kernels on one real fp32 step's operands by CUDA-graph
   replay, beside their bounds for 4-byte W;
33. lpips: seeded random LPIPS weights (the pretrained VGG16 weights do
   not ship) in an npz; two 800x800 views, card against the CPU port, ms
   a pair; and --val_only --eval_lpips on phase 19's checkpoint
   (test/lpips_vgg);
34. exr (after 2c. build_exr, which compiles csrc/exr.cpp with the host
   compiler beside the kernels' nvcc and lists what it links: no zlib or
   OpenEXR library): a procedural view at RTMV's 1600x1600 as an RTMV
   frame (linear light, RGBA HALF) under ZIP and PIZ, and in FLOAT under
   ZIP, each decode bit for bit the encoder's input; the median decode
   ms beside png.py's on the view's 8-bit PNG, and the host CPU;
35. cli_rtmv: a scene of 110 distinct 800x800 views written as RTMV
   publishes it (EXR frames, ZIP, beside their jsons), "python -m
   mfnerf_tpu_torch.misc.prepare_rtmv" on it (wall seconds), and the
   same scene written as PNG; the PNG bytes in which the two images/
   folders differ (the half round trip and the truncation move a byte by
   at most one); main with the reference's RTMV recipe (RTMV_ARGS: Hash
   grid, batch 16384, lr 2e-2, 600 steps) on each: load seconds, ms/step,
   test PSNR and SSIM (within RTMV_PSNR_TOL of each other), the first
   test view's rendered foreground colour (a saturated rgb head renders
   one colour: PERF.md §6) and the hash-grid kernels' launch counts.

Each phase that times a kernel prints it beside its bound (bytes at
3.35 TB/s or fp32 operations at 67 TFLOP/s), its plain version's time and,
where one PyTorch call computes the same function, that call's time.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""
import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import platform
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mfnerf_tpu_torch.benchmarking import bound, cuda_ms, graph_ms

SEED = 0
N_KERNEL = 1 << 20
WH = 800
N_FRAMES = 8
T_THRESHOLD = 1e-2
ORACLE_STRIDE = 78          # 640,000 rays / 78 = 8,206 oracle rays
KERNEL_TOL = 1e-4           # same bf16 operands; summation order only
RGB_TOL, DEPTH_TOL = 2e-3, 5e-3
N_BWD = 8192 * 64           # the padded step's most samples, 2^19
# dW sums up to 2^19 contributions per row, in chunk and run order
DW_TOL = 1e-3               # x max |dW_plain|
# du off the knots, relative to max(|du_plain|, 1e-3 max |du_plain|): the
# kernel sums g_d (W[i+1] - W[i]) over R columns, the plain version takes
# the difference of two such sums
DU_TOL_MOST, DU_TOL_ALL = 1e-4, 1e-2   # on >= 99% of samples / on all
N_ORACLE_RAYS = 1024
# the card's step vs the CPU's: XLA-free but still two devices. Frame 1's
# rotation matmul rounds differently on the card, which moves a few bf16
# hat weights by one step; sums run in other orders
LOSS_TOL = 1e-4             # relative
GRAD_TOL = 1e-2             # relative L2 error of each parameter's gradient
# bench.py:115-130 (TPU-only knobs dropped), with bench.py's --s_flat 16
# and --pool_a 4 (bench.py:63,69), the command line's defaults too
# (mfnerf_tpu_torch/opt.py:172,176): the flat budget from FLAT_AFTER, which
# the fused runner's static step needs, and the stage-A grid pooled 4 to a
# side
BENCH_HP = dict(
    dataset_name="nsvf", scale=0.5, use_exposure=False, distortion_loss_w=0.0,
    batch_size=8192, num_epochs=1, lr=1e-2, optimize_ext=False,
    random_bg=False, grid="LowRank", L=16, F=2, rgb_channels=64,
    rgb_layers=2, seed=1337, s_max_train=64, s_max_test=256,
    test_chunk=65536, steps_per_epoch=1000, grid_size=128, max_samples=1024,
    lr_levels=8, lr_rank=16, lr_frames=2, lr_k_max=256, bf16=False,
    refresh_half=True, lr_fused=True, s_flat=16, pool_a=4)
N_TRAIN_VIEWS = 16
WARM_STEPS, CHUNK, N_CHUNKS = 300, 100, 6   # bench.py: 300 + 600 steps
TEST_T = 1e-4
PSNR_MIN, PSNR_GAIN = 20.0, 8.0   # tests/test_e2e_train.py:69-70
# the reference's MixedFeature benchmark (benchmarking/
# benchmark_synthetic_nerf_mf.sh:15-17), the rest as BENCH_HP (its
# --s_flat 16 and --pool_a 4 are the command line's defaults, which the
# script keeps)
MF_HP = dict(BENCH_HP, grid="MixedFeature", L=16, F=2, T=20, N_min=16,
             N_max=2048, N_tables=8, rgb_channels=128, rgb_layers=2,
             batch_size=16384, lr=2e-2)
# the CLI's default grid (mfnerf_tpu/opt.py:89-105)
HASH_GRID = dict(grid="Hash", L=16, F=2, log2_T=19, N_min=16, N_max=2048,
                 N_tables=1)
N_HASH = 1 << 19
N_FACE = 384                # of them on the box faces (the corner clamp)
# the "rays" set: 13 samples a ray (the MixedFeature step's mean, PERF.md
# §5) at the march step sqrt(3) / 1024 of the unit box
RAY_SAMPLES, RAY_STEP = 13, math.sqrt(3) / 1024
# the forward repeats the plain version's fp32 operations: 0 expected
HASH_FWD_TOL = 1e-6         # x max |plain|
# d_params: fixed-point sums against fp32 scatter-adds; d_x and d_window:
# sums over levels and samples in another order
HASH_TOL = 1e-5             # x max |plain|
WINDOW_ALPHA = 0.6
# The MixedFeature recipe (batch 16384, lr 2e-2, rgb 128 x 2) plateaus on
# this scene: train PSNR ~22.4 and the held-out view 19.76 dB at 900 steps,
# 19.81 at 1800, the same with the Hash grid in its place
# (tools/train_grid.py, PERF.md §6). Its view must gain PSNR_GAIN over the
# untrained field and stay above this floor; PSNR_MIN is LowRank's.
MF_PSNR_MIN = 19.0
N_RAGGED = (1 << 16) + 37   # the probes' ragged size: part-filled tiles
# the cli phase: the README's command line on the procedural scene written
# to disk (the bench.py LowRank model at full width, 600 steps), at the
# command line's default --seed
CLI_ARGS = ("--dataset_name", "nsvf", "--exp_name", "cli", "--grid",
            "LowRank", "--lr_k_max", "256", "--num_epochs", "1",
            "--steps_per_epoch", "600", "--batch_size", "8192", "--lr", "1e-2")
CLI_TEST_VIEWS = 2
# the loaded rays against the in-memory images: the PNG's uint8 truncation
CLI_LOAD_TOL = 1 / 255 + 1e-6
CLI_PSNR_TOL = 1e-3         # --val_only in a subprocess against in process
# the multi-cascade phases: the MF-NeRF paper's mip-NeRF 360 recipe
# (benchmarking/benchmark_mipnerf360_mf.sh:7-9 on benchmark_mipnerf360.sh:
# 7-11: colmap, --scale 8 as for bonsai, counter, kitchen and room, batch
# 16384, lr 2e-2, --random_bg), the same without --random_bg, and the
# bench.py LowRank model of CLI_ARGS on the same scene and scale. Cuts: a
# procedural scene for mip-NeRF 360 (no dataset ships; make_scene at
# COLMAP_SPREAD, whose background is black, written as a COLMAP
# reconstruction of 16 train and 3 test views), --downsample 1.0 on its
# 800x800 views (the recipe's 0.25 of ~5000x3300 photos), 600 steps of the
# recipe's 20 epochs. On this scene --random_bg drives both packages'
# trainers to an opaque black first sample on every ray (vr_s 1), and the
# held-out views stay far below the train views (PERF.md §6): the
# runs' quality is reported, not gated; phase 20 holds the path's steps
# and serving loop to their oracles.
COLMAP_ROOT = os.path.join("360_v2", "spheres")
COLMAP_SPREAD, COLMAP_TEST_VIEWS = 5.0, 3
COLMAP_ORACLE_STRIDE = 641  # 640,000 rays / 641 = 999 oracle rays
REAL_ARGS = ("--dataset_name", "colmap", "--scale", "8")
MF360_BLACK_ARGS = (*CLI_ARGS, *REAL_ARGS, "--exp_name", "colmap_mf",
                    "--grid", "MixedFeature", "--L", "16", "--F", "2",
                    "--T", "20", "--N_min", "16", "--N_tables", "8",
                    "--rgb_channels", "128", "--rgb_layers", "2",
                    "--batch_size", "16384", "--lr", "2e-2")
MF360_ARGS = (*MF360_BLACK_ARGS, "--random_bg", "--exp_name",
              "colmap_mf_random_bg")
LR360_ARGS = (*CLI_ARGS, *REAL_ARGS, "--exp_name", "colmap_lowrank")
# the trainer's flags (--optimize_ext, --bf16, --use_exposure). The step
# oracles set dR and dT to N(0, EXT_OFFSET^2): small, off the zero rotation
EXT_OFFSET = 0.02
# --bf16, card against CPU: cuBLAS's bf16 GEMMs and the CPU's sum in other
# orders, and an fp32 sum an ulp apart rounds a hidden activation to the
# neighbouring bf16 value (2^-8 relative); tests/test_torch_train.py holds
# the CPU step to the JAX one at 1e-4 (loss) and 2e-2 (gradients, relative
# L2): the card gets twice that room on the gradients
BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-3, 4e-2
# cli_hdr: HDR-NeRF's synthetic layout (write_hdr_scene: 18 train poses at
# luckycat's exposures 2, 0.5, 0.125; 17 test poses at 1, 0.25) of the
# COLMAP phases' spread scene at 400x400, the cli's LowRank model at
# --scale 8 with --use_exposure. Cuts: a procedural scene for HDR-NeRF's
# Blender renders (none ships; 400x400 of their 400x400), 600 steps
HDR_CUTS = ("a procedural scene for HDR-NeRF's Blender renders (none "
            "ships)", "600 steps")
HDR_ROOT = os.path.join("HDR-NeRF", "syndata", "luckycat")
HDR_WH = 400
HDR_ARGS = (*CLI_ARGS, *REAL_ARGS, "--exp_name", "hdr", "--use_exposure")
# cli_ext: the cli's scene and model with the training poses perturbed as
# the JAX package's pose-refinement test perturbs them (axis-angle and
# translation N(0, 0.03^2)), refined at --pose_lr 2e-3 (that test's rate;
# the default 1e-6 moves dT ~6e-4 in 600 steps). Cut: 600 steps
EXT_CUTS = ("a procedural scene with perturbed training poses (no real "
            "scene ships)", "600 steps")
EXT_PERTURB = 0.03
EXT_ARGS = (*CLI_ARGS, "--exp_name", "ext", "--optimize_ext", "--pose_lr",
            "2e-3")
# the refined centres' error must fall below this share of the perturbed
# ones' (tests/test_flag_paths.py:216, the JAX package's test)
EXT_ERR_SHARE = 0.9
# the host JPEG decoder (built with the kernels by the host compiler) and
# its fixtures: PIL-written files, each beside PIL's decode as a PNG
JPEG_SRC = "mfnerf_tpu_torch/csrc/jpeg.cpp"
JPEG_FIXTURES = os.path.join("tests", "data", "jpeg")
JPEG_REPEAT = 5             # timed decodes of the 800x800 view (median)
# cli_jpeg: phase 20's scene with its views in JPEG (quality 95, 4:2:0);
# the loaded rays are the codec's, not the images': on average within
# this of them (the checker edges' chroma is what 4:2:0 loses)
JPEG_LOAD_TOL = 0.01
LR360_JPEG_ARGS = (*LR360_ARGS, "--exp_name", "colmap_lowrank_jpg")
COLMAP_JPEG_ROOT = os.path.join("360_v2", "spheres_jpg")
# the offline phases on the cli phase's checkpoint: the mesh at the root
# eval.py's default resolution, the orbit at 400x400 (--downsample 0.5),
# --profile's 48 traced steps then PROFILE_STEPS more, and the kernels the
# trace must name (mfnerf_tpu_torch/csrc/hatmul.cu)
MESH_RES = 256
ORBIT_FRAMES = 8
PROFILE_STEPS = 16
PROFILE_KERNELS = ("hat_prod_fwd_kernel", "hat_prod_bwd_slab_kernel")
# the data-parallel phases (29-31): bench.py's configuration (bench.py:
# 115-139) with its --pool_a 4 and a flat budget, which BENCH_HP leaves
# out, so that the steps from FLAT_AFTER take the flat budget; and MF_HP
# with the sampled-corner table gradient that
# benchmark_synthetic_nerf_mf.sh's note offers (--hash_grad_samples 1),
# whose noise rows the ranks draw for the global batch. The budget is
# --s_flat 8, half bench.py's 16: the field's first refresh leaves ~21
# samples a ray (LowRank) and ~27 (MixedFeature; phase 9 and 14's
# rm_s_first), so 8 a ray of the whole batch ends inside rank 0's half,
# the case that the samples' prefix across ranks exists for; 16 would end
# in rank 1's
DP_HP = dict(BENCH_HP, s_flat=8, pool_a=4)
DP_MF_HP = dict(MF_HP, s_flat=8, pool_a=4, hash_grad_samples=1)
DP_STEPS, DP_LATE = 20, 600       # dp_one: 20 steps from 0, 20 from 600
# dp_two: 48 steps from step 0 (three refreshes), and 16 from step 600
# after the cull and one refresh, each run from the seeded untrained field
DP_TWO_STEPS, DP_TWO_LATE_STEPS = 48, 16
# the early run's steps at which one and two ranks are compared: at every
# one the ranks must be bitwise equal, and the distance to one rank by the
# multichip rule is reported. It is not gated there: Adam's eps of 1e-15
# turns a parameter's gradient near 1e-15, whose last bits the order of
# the sums decides, into an update of up to lr, from the first step on
# (PERF.md §6). The gate is the first step's gradients: the two
# ranks' average against one rank's, a parameter's relative L2 error
DP_CHECKPOINTS = (1, 2, 4, 8, 16, 32, DP_TWO_STEPS)
DP_GRAD_TOL = 1e-3
DP_LARGE = ("hash_table",)        # kept at the first and last checkpoint
DP_DEVICES = ("cuda:0", "cuda:0")  # two ranks share the card (gloo)
# what the gloo ranks' fit must print: their steps run one at a time
DP_GLOO_OFF = ("off (inside a gloo process group: gloo collectives cannot "
               "be captured)")
DP_TIMEOUT = 300                   # seconds for the two ranks' spawn
# tests/test_multichip.py:80-95: the loss, then each parameter's elements
DP_LOSS_TOL, DP_ELEM_ATOL, DP_ELEM_RTOL = 1e-4, 1e-4, 5e-4
DP_ELEM_SHARE, DP_ELEM_MAX = 0.05, 5e-3
DP_RGB_TOL, DP_DEPTH_TOL = 2e-4, 2e-3   # tests/test_multichip.py:124-131
# the fp32 hat mode (phase 32): products round in fp32 on both sides
HAT_FP32_TOL = 1e-5               # forward, x max |plain|
HAT_FP32_DW_TOL = 1e-4            # dW, x max |plain|
FP32_CHUNKS = 2                   # 100 warm + 2 x 100 timed steps a mode
# LPIPS (phase 33): seeded random weights (the pretrained ones do not
# ship), card against the CPU port; float32 convolutions, TF32 off
LPIPS_TOL = 1e-5                  # relative
LPIPS_REPEAT = 5
# the host OpenEXR decoder (phase 34): one frame at RTMV's 1600x1600 in
# RGBA HALF under ZIP and PIZ, and in FLOAT under ZIP; median of 5 decodes
EXR_SRC = "mfnerf_tpu_torch/csrc/exr.cpp"
EXR_WH = 1600
EXR_REPEAT = 5
EXR_LINKS = ("libz", "OpenEXR", "IlmImf", "Imath")   # none may be linked
# cli_rtmv (phase 35): the reference's RTMV recipe (benchmarking/
# benchmark_rtmv.sh:4-7: --batch_size 16384 --lr 2e-2, the default Hash
# grid) on a procedural scene written as RTMV publishes it, EXR frames
# (ZIP) converted by misc/prepare_rtmv.py, and on the same scene written
# as PNG. Cuts: a procedural scene for RTMV's renders (none ships), 800x800
# of RTMV's 1600x1600 (100 training frames at 1600^2 are 3.1 GB of host
# rays), 110 frames of 150 (train 0-100, test 105-110), 600 steps of 20
# epochs
RTMV_ARGS = ("--dataset_name", "rtmv", "--no_save_test", "--num_epochs",
             "1", "--steps_per_epoch", "600", "--batch_size", "16384",
             "--lr", "2e-2")
RTMV_CUTS = ("a procedural scene for RTMV's renders (none ships)",
             "800x800 of 1600x1600", "110 of 150 frames", "600 steps")
RTMV_FRAMES = 110
RTMV_ROOT = os.path.join("RTMV", "google_scanned")
RTMV_PSNR_TOL = 0.5               # dB, the EXR scene's run against the PNG's
# the march kernels (csrc/raymarch.cu): each set is marched by the kernel
# and by its plain version on the card, and the two must agree bit for bit
MARCH_GRAPH_ITERS = 20            # kernel calls a CUDA graph replays
# serve_graphed: the tiered rounds against the valid-only loop (another
# grouping of the same samples into rounds: fp32 sums in another order)
SERVE_AB_TOL = 1e-5               # max abs, rgb, opacity and depth
SERVE_PSNR_TOL = 0.01             # dB
# a threshold tie: the transmittance a frame ends with within this share of
# T_threshold (its opacity's fp32 sum rounds at ~1e-7 a term)
SERVE_TIE_SHARE = 0.05
SERVE_TURN_FRAMES = 3             # frames a turn (eager, graphed x2, eager)
# fp32 operations of one rung test (the ladder, calc_dt, the position, the
# cascade and the three cell coordinates)
MARCH_OPS_PER_RUNG = 30
N_MARCH_DEGENERATE = 4096         # rays of the degenerate set
MARCH_ORACLE_STRIDE = 8           # of the test view's rays, the oracle set
# the composite kernels (csrc/composite.cu) against their plain versions:
# the same operations in another order (a shuffle scan and trees against
# torch's cumprod and sums)
COMPOSITE_FWD_TOL = 1e-6          # x max |plain|: ws, opacity, depth, rgb
COMPOSITE_BWD_TOL = 1e-5          # relative L2 of each gradient
# rows whose transmittance lies this close to T_threshold (float32 ulps of
# it) may include a sample on one side and not on the other
COMPOSITE_TIE_ULPS = 4
COMPOSITE_GRAPH_ITERS = 20
# phases 38-39, the fused runner: steps run eagerly and then replayed from
# one state, held bit for bit; timed chunks of synced steps in turns (P
# eager, T graphed); steps under the profiler of each kind
FUSED_STEPS = 48
FUSED_CHUNK, FUSED_TURNS = 100, "PTTPPT"
FUSED_PROFILE = 16
OCC_TENSORS = ("density_grid", "density_bitfield", "count_grid", "stage_a",
               "union_bits")
# fp32 operations of a sample in the forward (exp, alpha, the scan's
# product, w, the five sums)
COMPOSITE_OPS_PER_SAMPLE = 12


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(label, **fields):
    print(json.dumps({"phase": label, **fields}), flush=True)


def fwd_bound(n, k, r, w_bytes=2):
    """hat_prod: read u and W (``w_bytes`` an element: 2 bf16, 4 in the
    fp32 mode) once, write out; per (sample, column) three two-row lerps
    (3 operations each) and two products."""
    return bound(12 * n + 3 * w_bytes * k * r + 4 * n * r, 11 * n * r)


def bwd_bound(n, k, r, need_du, w_bytes=2):
    """hat_prod_bwd: read u, g and W (``w_bytes`` an element) once, write dW
    (and du); per (sample, column, axis) a lerp (3), g_d (2), two row sums
    (4) and with du a difference and a product (2)."""
    n_bytes = 12 * n + 4 * n * r + 3 * w_bytes * k * r + 12 * k * r \
        + (12 * n if need_du else 0)
    return bound(n_bytes, (11 if need_du else 9) * 3 * n * r)


def check_bwd(label, u3, w3, k, g, dtype="bfloat16", dw_tol=DW_TOL):
    """Phase 7 on one set of operands of the kernel for ``dtype``: three
    launches give the same dW bytes, dW within ``dw_tol`` of the plain
    version, du 0 on the knots and within DU_TOL elsewhere; the kernel's
    times (with and without du) beside their bounds. Returns the phase's
    fields."""
    from mfnerf_tpu_torch.ops.hatmul import hat_prod_bwd, hat_prod_bwd_plain
    n, r = g.shape
    du, dw = hat_prod_bwd(u3, w3, k, g, dtype=dtype)
    dw_again = hat_prod_bwd(u3, w3, k, g, dtype=dtype)[1]
    dw_no_du = hat_prod_bwd(u3, w3, k, g, need_du=False, dtype=dtype)[1]
    du_p, dw_p = hat_prod_bwd_plain(u3, w3, k, g, dtype=dtype)
    torch.cuda.synchronize()
    check(du.shape == (n, 3) and dw.shape == w3.shape,
          f"hat_prod_bwd shapes {tuple(du.shape)} {tuple(dw.shape)}")
    bitwise = torch.equal(dw, dw_again) and torch.equal(dw, dw_no_du)
    dw_spread = float((dw - dw_again).abs().max())
    dw_scale = float(dw_p.abs().max())
    dw_err = float((dw - dw_p).abs().max())
    pos = u3 * (k - 1)
    knot = pos == torch.floor(pos)
    du_knot = max(float(torch.where(knot, du.abs(), 0.0).max()),
                  float(torch.where(knot, du_p.abs(), 0.0).max()))
    du_scale = float(du_p.abs().max())
    du_rel = ((du - du_p).abs()
              / du_p.abs().clamp_min(1e-3 * du_scale))[~knot]
    du_within = float((du_rel <= DU_TOL_MOST).float().mean())
    du_rel_max = float(du_rel.max())
    ms = cuda_ms(lambda: hat_prod_bwd(u3, w3, k, g, dtype=dtype), 20)
    ms_no_du = cuda_ms(lambda: hat_prod_bwd(u3, w3, k, g, need_du=False,
                                            dtype=dtype), 20)
    plain_ms = cuda_ms(lambda: hat_prod_bwd_plain(u3, w3, k, g,
                                                  dtype=dtype), 5)
    w_bytes = 2 if dtype == "bfloat16" else 4
    bound_ms, bound_by = bwd_bound(n, k, r, True, w_bytes)
    bound_no_du = bwd_bound(n, k, r, False, w_bytes)[0]
    fields = dict(
        shape=label, dtype=dtype, n=n, k=k, r=r, g_row_stride=g.stride(0),
        g_contiguous=g.is_contiguous(), dw_bitwise_equal=bitwise,
        dw_launch_spread=dw_spread, dw_max_abs_err=dw_err,
        dw_max_abs=dw_scale, dw_tol=dw_tol, du_knot_max_abs=du_knot,
        knot_samples=int(knot.any(dim=1).sum()),
        du_share_within_tol=du_within, du_rel_err_max=du_rel_max,
        du_tol_99=DU_TOL_MOST, du_tol_all=DU_TOL_ALL, ms=ms,
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        ms_no_du=ms_no_du, bound_ms_no_du=bound_no_du, plain_ms=plain_ms)
    check(bitwise and dw_spread == 0.0,
          f"{label}: dW differs between launches by {dw_spread}")
    check(dw_err <= dw_tol * dw_scale, f"{label}: dW vs plain: {dw_err}")
    check(du_knot == 0.0, f"{label}: du on the knots: {du_knot}")
    check(du_within >= 0.99 and du_rel_max <= DU_TOL_ALL,
          f"{label}: du vs plain: {du_within} within {DU_TOL_MOST}, "
          f"max {du_rel_max}")
    return fields


@contextlib.contextmanager
def recording(module, tensors=True):
    """Within the context, each call of ``module._launch_bwd`` appends its
    positional arguments (not the hat product's keyword ``dtype``) to the
    yielded list (the hat product's (u3, w3, k, g,
    need_du), the hash grid's (params, x, cfg, g, window, grad_noise,
    need_dx)), tensors detached (None without ``tensors``: a training run
    would keep every step's operands), and launches as before."""
    captured, launch = [], module._launch_bwd

    def recorder(*args, **kwargs):
        captured.append(tuple(
            a if not torch.is_tensor(a) else a.detach() if tensors else None
            for a in args))
        return launch(*args, **kwargs)

    module._launch_bwd = recorder
    try:
        yield captured
    finally:
        module._launch_bwd = launch


def capture_bwd_operands(system, seed, module, with_count=False):
    """One forward and backward of a training step of ``system``
    (``NeRFSystem.step_loss``: with ``--optimize_ext`` the refined poses)
    on a ray batch drawn from ``seed``, weights and optimiser untouched:
    the arguments of each call of ``module._launch_bwd`` (:func:`recording`)
    and, ``with_count``, the step's valid count (the samples its capacity
    buffer holds: the count the encoder kernels were given)."""
    dev, b = system.device, system.hparams.batch_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_img, hw = system.rays.shape[:2]
    img = torch.randint(n_img, (b,), generator=gen, device=dev)
    pix = torch.randint(hw, (b,), generator=gen, device=dev)
    loss, res, _ = system.step_loss(img, pix, torch.rand(
        (b,), generator=gen, device=dev))
    with recording(module) as captured:
        loss.backward()
    system.optimizer.zero_grad(set_to_none=True)
    if with_count:
        return captured, int(res["mask"].sum())
    return captured


def step_oracle(model, cpu_model, occ, rcfg, loss_mod, batch, rows=None):
    """One training step's loss and parameter gradients on the card and on
    the CPU, same weights, rays, march jitter, background (``batch["bg"]``
    where the scene draws one) and, with ``rows``, the same sampled-corner
    uniforms (N * s_max_train rows, the JAX padded draw: a row an entry of
    the (N, S) samples). Checks the sample counts, LOSS_TOL and GRAD_TOL;
    returns the phase's fields and the card's gradients."""
    from mfnerf_tpu_torch.models.rendering import render_train
    steps = {}
    for where, model_, occ_ in (("card", model, occ),
                                ("cpu", cpu_model, occ.to("cpu"))):
        on = {key: v.to(model_.device) for key, v in batch.items()}
        grad_noise = None if rows is None else rows.to(model_.device)
        res = render_train(model_, occ_, on["rays_o"], on["rays_d"],
                           on["noise"], rcfg, bg_rgb=on.get("bg"),
                           grad_noise=grad_noise)
        loss = sum(v.mean() for v in loss_mod(
            res, {"rgb": on["rgb"]}).values())
        model_.zero_grad(set_to_none=True)
        loss.backward()
        steps[where] = (float(loss.detach()), int(res["rm_samples"]), {
            name: p_.grad.detach().cpu() for name, p_
            in model_.named_parameters()})
        model_.zero_grad(set_to_none=True)
    (loss_c, rm_c, grads_c), (loss_p, rm_p, grads_p) = \
        steps["card"], steps["cpu"]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    grad_rel = {name: float((grads_c[name] - grads_p[name]).norm()
                            / grads_p[name].norm()) for name in grads_p}
    check(rm_c == rm_p, f"samples on the card {rm_c} vs cpu {rm_p}")
    check(loss_rel <= LOSS_TOL, f"loss card {loss_c} vs cpu {loss_p}")
    check(max(grad_rel.values()) <= GRAD_TOL, f"gradients: {grad_rel}")
    return dict(rays=batch["noise"].shape[0], samples_card=rm_c,
                samples_cpu=rm_p, loss_card=loss_c, loss_cpu=loss_p,
                loss_rel_err=loss_rel, loss_tol=LOSS_TOL,
                grad_rel_err_max=max(grad_rel.values()),
                grad_rel_err_worst=max(grad_rel, key=grad_rel.get),
                grad_tol=GRAD_TOL), grads_c


def hash_distinct_rows(x, cfg):
    """The number of distinct table rows the 8 corners of x's cells read
    (the plain version's indices)."""
    from mfnerf_tpu_torch.ops import hashgrid as hg
    arrays, base, frac = hg._cells(x, cfg)
    rows = torch.cat([hg._corner(c, base, frac, arrays)[0].reshape(-1)
                      for c in range(8)])
    return int(torch.unique(rows).numel())


def hash_atomics(x, cfg):
    """The exact table gradient's atomics (the plain version's indices): one
    an update, 8 L F a sample; one a distinct (sample // 32, level, round,
    row) and feature, where round r takes each sample's corner
    r ^ (base & 1), the vertex of parity r (what merging all of a warp's
    equal rows would leave); and the backward kernel's, one a run of
    consecutive lanes with the same row in a (warp, level, round) and
    feature. Returns the three counts."""
    from mfnerf_tpu_torch.ops import hashgrid as hg
    arrays, base, frac = hg._cells(x, cfg)
    n = x.shape[0]
    warps = -(-n // 32)
    rows = torch.stack([hg._corner(c, base, frac, arrays)[0]
                        for c in range(8)])                      # (8, L, N)
    par = (base[..., 0] & 1) | (base[..., 1] & 1) << 1 \
        | (base[..., 2] & 1) << 2                                # (L, N)
    # (level, warp) a key, then the row: below 2^5 * 2^26 * 2^31
    lw = (torch.arange(cfg.L, device=x.device)[:, None] * warps
          + torch.arange(n, device=x.device)[None, :] // 32)
    first = torch.arange(n, device=x.device) % 32 == 0
    distinct = runs = 0
    for r in range(8):
        rows_r = rows.gather(0, (r ^ par)[None])[0]             # (L, N)
        distinct += int(torch.unique(lw * cfg.n_params + rows_r).numel())
        new_row = torch.ones_like(rows_r, dtype=torch.bool)
        new_row[:, 1:] = rows_r[:, 1:] != rows_r[:, :-1]
        runs += int((first | new_row).sum())
    return n * cfg.L * 8 * cfg.F, distinct * cfg.F, runs * cfg.F


def hash_fwd_bound(n, cfg, distinct):
    """hashgrid fwd: read x and the distinct rows once, write the output;
    per (sample, level) the cell (6 operations), 8 weights (2 each) and
    8 blends of F features (2 each)."""
    return bound(12 * n + 4 * n * cfg.out_dim + 4 * cfg.F * distinct,
                 n * cfg.L * (6 + 8 * (2 + 2 * cfg.F)))


def hash_bwd_bound(n, cfg, distinct, need_dx):
    """hashgrid bwd: read g and x, write d_params whole; with d_x read the
    distinct rows and write d_x; operations as the forward's, plus per
    corner and feature the update (1) and with d_x the row's dot (2) and the
    weight's partials (6 a corner)."""
    n_bytes = 12 * n + 4 * n * cfg.out_dim + 4 * cfg.n_params * cfg.F
    ops = n * cfg.L * (6 + 8 * (2 + 3 * cfg.F))
    if need_dx:
        n_bytes += 12 * n + 4 * cfg.F * distinct
        ops += n * cfg.L * 8 * (2 * cfg.F + 6)
    return bound(n_bytes, ops)


def check_hashgrid(label, cfg, params, x, g, seed):
    """Phase 12 on one set of operands: the forward bit for bit against the
    plain version; the backward's d_params bitwise equal across three
    launches and to the fixed-point model, exact, sampled at one corner (the
    same uniforms) and windowed (alpha 0.6); d_params, d_x and d_window
    within HASH_TOL of the plain version; the atomics before and after the
    merge; the kernels' device times by CUDA-graph replay beside their
    bounds, and through their wrappers call by call (host time included).
    Returns the phase's fields."""
    from mfnerf_tpu_torch.ops.hashgrid import (fixed_point_scale,
                                               hashgrid_bwd,
                                               hashgrid_bwd_fixed_plain,
                                               hashgrid_bwd_plain,
                                               hashgrid_encode,
                                               hashgrid_encode_plain,
                                               window_weights)
    n = x.shape[0]
    dev = x.device
    with torch.no_grad():
        out = hashgrid_encode(params, x, cfg)
        want = hashgrid_encode_plain(params, x, cfg)
    torch.cuda.synchronize()
    check(out.shape == (n, cfg.out_dim), f"{label}: output {out.shape}")
    fwd_err = float((out - want).abs().max())
    fwd_scale = float(want.abs().max())
    fwd_bitwise = bool(torch.equal(out, want))
    check(fwd_err <= HASH_FWD_TOL * fwd_scale and fwd_bitwise,
          f"{label}: forward vs plain: {fwd_err} of {fwd_scale}, bitwise "
          f"{fwd_bitwise}")

    def errs(got, ref):
        return float((got - ref).abs().max()), float(ref.abs().max())

    fields = dict(shape=label, grid=cfg.grid_type, n=n, levels=cfg.L,
                  features=cfg.F, rows=cfg.n_params,
                  fwd_max_abs_err=fwd_err, fwd_max_abs=fwd_scale,
                  fwd_bitwise_equal=fwd_bitwise)
    del out, want
    sampled = dataclasses.replace(cfg, grad_corners=1)
    noise = torch.rand((n, 1), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    window = window_weights(cfg, WINDOW_ALPHA, dev)
    for name, cfg_, noise_, win in (("exact", cfg, None, None),
                                    ("sampled", sampled, noise, None),
                                    ("window", cfg, None, window)):
        runs = [hashgrid_bwd(params, x, cfg_, g, win, noise_,
                             need_dx=i == 2) for i in range(3)]
        dp_p, dx_p, dw_p = hashgrid_bwd_plain(params, x, cfg_, g, win,
                                              noise_)
        dp_fixed = hashgrid_bwd_fixed_plain(params, x, cfg_, g, win, noise_)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(runs[0][0], r[0]) for r in runs[1:])
        spread = max(float((runs[0][0] - r[0]).abs().max())
                     for r in runs[1:])
        fixed_equal = bool(torch.equal(runs[0][0], dp_fixed))
        log2_scale = math.log2(fixed_point_scale(g, cfg_, win))
        dp_err, dp_scale = errs(runs[2][0], dp_p)
        dx_err, dx_scale = errs(runs[2][1], dx_p)
        fields.update({f"{name}_dp_bitwise_equal": bitwise,
                       f"{name}_dp_launch_spread": spread,
                       f"{name}_dp_fixed_model_equal": fixed_equal,
                       f"{name}_log2_fixed_scale": log2_scale,
                       f"{name}_dp_max_abs_err": dp_err,
                       f"{name}_dp_max_abs": dp_scale,
                       f"{name}_dx_max_abs_err": dx_err,
                       f"{name}_dx_max_abs": dx_scale})
        check(bitwise and spread == 0.0,
              f"{label} {name}: d_params differs between launches")
        # a ratio of exactly 2 would be S on a power of two, not the merge
        check(fixed_equal, f"{label} {name}: d_params vs the fixed-point "
              f"model (2^{log2_scale}): max abs diff "
              f"{float((runs[0][0] - dp_fixed).abs().max())}")
        check(dp_err <= HASH_TOL * dp_scale,
              f"{label} {name}: d_params vs plain: {dp_err} of {dp_scale}")
        check(dx_err <= HASH_TOL * dx_scale,
              f"{label} {name}: d_x vs plain: {dx_err} of {dx_scale}")
        if win is not None:
            dw_err, dw_scale = errs(runs[2][2], dw_p)
            fields.update(window_alpha=WINDOW_ALPHA,
                          window_dw_max_abs_err=dw_err,
                          window_dw_max_abs=dw_scale)
            check(dw_err <= HASH_TOL * dw_scale,
                  f"{label}: d_window vs plain: {dw_err} of {dw_scale}")
        del runs, dp_p, dx_p, dw_p, dp_fixed
    distinct = hash_distinct_rows(x, cfg)
    atomics, atomics_distinct, merged = hash_atomics(x, cfg)
    fwd_bound_ms, fwd_bound_by = hash_fwd_bound(n, cfg, distinct)
    bwd_bound_ms, bwd_bound_by = hash_bwd_bound(n, cfg, distinct, False)

    def fwd():
        return hashgrid_encode(params, x, cfg)

    def bwd():
        return hashgrid_bwd(params, x, cfg, g, need_dx=False)

    fields.update(
        distinct_rows=distinct, atomics_per_update=atomics,
        atomics_distinct=atomics_distinct, atomics_merged=merged,
        atomics_merged_share=merged / atomics,
        tol=HASH_TOL, fwd_tol=HASH_FWD_TOL,
        fwd_ms=graph_ms(fwd, 20),
        fwd_wrapper_ms_host_inclusive=cuda_ms(fwd, 20),
        fwd_plain_ms=cuda_ms(lambda: hashgrid_encode_plain(params, x, cfg),
                             5),
        fwd_bound_ms=fwd_bound_ms, fwd_bound_by=fwd_bound_by,
        bwd_ms=graph_ms(bwd, 20),
        bwd_wrapper_ms_host_inclusive=cuda_ms(bwd, 20),
        bwd_sampled_ms=graph_ms(lambda: hashgrid_bwd(
            params, x, sampled, g, None, noise, need_dx=False), 20),
        bwd_dx_ms=graph_ms(lambda: hashgrid_bwd(params, x, cfg, g), 20),
        bwd_plain_ms=cuda_ms(lambda: hashgrid_bwd_plain(
            params, x, cfg, g, need_dx=False), 5),
        bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by,
        bwd_dx_bound_ms=hash_bwd_bound(n, cfg, distinct, True)[0])
    fields.update(fwd_share_of_bound=fwd_bound_ms / fields["fwd_ms"],
                  bwd_share_of_bound=bwd_bound_ms / fields["bwd_ms"])
    return fields


def hash_uniform_operands(cfg, seed, n=None):
    """A seeded N(0, 1) table, n (default N_HASH) uniform points (N_FACE of
    them on the box faces) and an N(0, 1) cotangent, on the card."""
    n = N_HASH if n is None else n
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = torch.randn((cfg.n_params, cfg.F), generator=gen,
                         device="cuda")
    x = torch.rand((n, 3), generator=gen, device="cuda")
    _on_faces(x)
    g = torch.randn((n, cfg.out_dim), generator=gen, device="cuda")
    return params, x, g


def _on_faces(x):
    """Put the first N_FACE + 16 points on the box faces and corner."""
    third = N_FACE // 3
    for d in range(3):
        x[d * third:(d + 1) * third, d] = 1.0
    x[N_FACE:N_FACE + 16] = 1.0


def hash_ray_operands(cfg, seed, n=None):
    """As hash_uniform_operands, but the points lie along rays, ray by ray
    as a training step hands them to the encoder: RAY_SAMPLES consecutive
    samples a ray RAY_STEP apart, from a uniform origin (inside the box by
    the ray's length) in a uniform direction; then the box-face points."""
    n = N_HASH if n is None else n
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = torch.randn((cfg.n_params, cfg.F), generator=gen,
                         device="cuda")
    rays = -(-n // RAY_SAMPLES)
    reach = RAY_SAMPLES * RAY_STEP
    o = reach + torch.rand((rays, 3), generator=gen, device="cuda") * (
        1 - 2 * reach)
    d = torch.randn((rays, 3), generator=gen, device="cuda")
    d = d / d.norm(dim=1, keepdim=True)
    t = torch.arange(RAY_SAMPLES, device="cuda") * RAY_STEP
    x = (o[:, None] + d[:, None] * t[None, :, None]).reshape(-1, 3)[:n]
    x = x.clamp(0.0, 1.0).contiguous()
    _on_faces(x)
    g = torch.randn((n, cfg.out_dim), generator=gen, device="cuda")
    return params, x, g


def hash_degenerate_operands(cfg, seed, n=None):
    """As hash_uniform_operands, but the 32 samples of each warp share one
    uniform point (every corner row of a warp is one group)."""
    params, x, g = hash_uniform_operands(cfg, seed, n)
    x = x[::32].repeat_interleave(32, dim=0)[:x.shape[0]].contiguous()
    return params, x, g


def hash_operand_sets():
    """Phase 12's operand sets: (label, config, operands maker, seed); the
    last is the kernels' generic path (F 4, L 12) at 2^16 points."""
    from mfnerf_tpu_torch.models.ngp import NGPConfig
    hash_cfg = NGPConfig(**HASH_GRID).hash_cfg
    mf_cfg = NGPConfig(**dict(HASH_GRID, grid="MixedFeature", log2_T=20,
                              N_tables=8)).hash_cfg
    generic = NGPConfig(grid="Hash", L=12, F=4, log2_T=16,
                        N_max=512).hash_cfg
    return [("uniform", hash_cfg, hash_uniform_operands, SEED + 10),
            ("uniform", mf_cfg, hash_uniform_operands, SEED + 11),
            ("rays", mf_cfg, hash_ray_operands, SEED + 13),
            ("degenerate", mf_cfg, hash_degenerate_operands, SEED + 14),
            ("generic", generic, lambda cfg, seed: hash_uniform_operands(
                cfg, seed, 1 << 16), SEED + 12)]


def march_counts(reset=False):
    """The march kernels' launch counts, {"train": .., "window": ..}, after
    zeroing them with ``reset``."""
    from mfnerf_tpu_torch.ops.ray_march import (march_rays_train,
                                                march_rays_window)
    if reset:
        march_rays_train.launches = march_rays_window.launches = 0
    return {"train": march_rays_train.launches,
            "window": march_rays_window.launches}


def _float_bits(t):
    """A float32 tensor's bits as int32 (bit for bit comparisons)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def march_differs(got, want, names, masked_k=None):
    """The names among ``names`` where two marches' results differ in a
    bit; with ``masked_k`` (the training march's mask), k_idx is compared
    on the valid slots only."""
    bad = [n for n in names if not torch.equal(
        _float_bits(getattr(got, n)), _float_bits(getattr(want, n)))]
    if masked_k is not None and not torch.equal(got.k_idx[masked_k],
                                                want.k_idx[masked_k]):
        bad.append("k_idx")
    return bad


def march_max_err(got, want):
    return max(float((getattr(got, n) - getattr(want, n)).abs().max())
               if getattr(got, n).numel() else 0.0
               for n in ("xyzs", "deltas", "ts"))


def march_train_bound(args, kw, res):
    """(least ms, bound_by) of one training march: each input read once
    (the bitfield and the stage-A grid whole), each output written once;
    MARCH_OPS_PER_RUNG a rung up to each ray's last sample (the rungs any
    march must test)."""
    bits = args[3]
    n, s = res.mask.shape
    strata = kw.get("strata")
    grid_bytes = bits.numel() + (0 if strata is None
                                 else strata.stage_a.numel())
    n_bytes = n * (12 + 12 + 8 + 4) + grid_bytes \
        + n * s * (12 + 4 + 4 + 1 + 8) + n * (8 + 4)
    last = torch.where(res.n_samples > 0, res.k_idx.gather(
        1, (res.n_samples - 1).clamp_min(0)[:, None])[:, 0] + 1, 0)
    return bound(n_bytes, MARCH_OPS_PER_RUNG * float(last.sum()))


def march_window_bound(args, res, skip=None, extra_bytes=0):
    """(least ms, bound_by) of one window march in place (``args`` the
    gathered rows, as march_rays_window takes them), as march_train_bound:
    the rows' index, rays, t_start, t2 and cursor read once, the cursor
    written back, the bitfield and the stage-A grid whole, and
    ``extra_bytes`` (the empty rows past an alive count written). The
    operations term counts only the rungs from each cursor to its ray's
    last sample, so a ray that finds nothing counts zero, though every
    march tests some of its rungs (window_rung_work counts a rung-by-rung
    walk's)."""
    cursor, bits, n_window = args[4], args[5], args[11]
    n, s = res.mask.shape
    grid_bytes = bits.numel() + (0 if skip is None else skip.stage_a.numel())
    n_bytes = n * (8 + 12 + 12 + 4 + 4 + 8) + grid_bytes \
        + n * s * (12 + 4 + 4 + 1 + 8) + n * (8 + 8 + 1 + 8) + extra_bytes
    last = torch.where(res.n_samples > 0, res.k_idx.gather(
        1, (res.n_samples - 1).clamp_min(0)[:, None])[:, 0] + 1 - cursor, 0)
    return bound(n_bytes, MARCH_OPS_PER_RUNG * float(last.clamp_max(
        n_window).sum()))


def window_rung_work(args):
    """Rungs a rung-by-rung walk of the window (``args`` the gathered rows,
    march_rays_window's positional args) tests: each ray's up to its
    (s_cap + 1)-th occupied rung, its first rung past the exit, or the
    window's end."""
    from mfnerf_tpu_torch.ops.ray_march import _occupancy_at, _window_rungs
    ro, rd, t0, t2, cursor, bits, cascades, scale, e, grid, max_samples, \
        n_window, s_cap, dt_scale = args
    xyz, dt, in_box = _window_rungs(ro, rd, t0, t2, cursor, n_window,
                                    (e, max_samples, grid, dt_scale))
    occ = _occupancy_at(xyz, dt, bits, cascades, scale, grid) & in_box
    stop = (torch.cumsum(occ.to(torch.int32), 1) > s_cap) | ~in_box
    walked = torch.where(stop.any(1), stop.to(torch.int32).argmax(1) + 1,
                         n_window)
    return int(walked.sum())


def window_skip_stats(args, skip):
    """The stage-A skip on a window set (``args`` the gathered rows): the
    share of its grid's cells that are occupied, the rays it takes and the
    share of their strata (before the exit) that its test keeps."""
    from mfnerf_tpu_torch.ops.ray_march import (_window_live, _window_skips,
                                                window_params)
    from mfnerf_tpu_torch.ops.stepping import t_ladder
    ro, rd, t0, t2, cursor, bits, cascades, scale, e, grid, max_samples, \
        n_window, s_cap, dt_scale = args
    p = window_params(scale, e, grid, cascades, max_samples, dt_scale,
                      n_window, s_cap, skip)
    if not p.mode:
        return dict(skip_mode=0)
    ladder = (e, max_samples, grid, dt_scale)
    skips = _window_skips(p, ro, rd, t0, cursor, ladder)
    live = _window_live(p, skip.stage_a, ro, rd, t0, t2, cursor)
    first = (cursor[:, None] + torch.arange(live.shape[1], device=ro.device)
             * p.stratum).to(torch.float32)
    before = t_ladder(t0, first, *ladder) < t2[:, None]
    kept = int(live[skips].sum())
    tested = int(before[skips].sum())
    return dict(skip_mode=p.mode, stratum=p.stratum,
                stage_a_share=float(skip.stage_a.float().mean()),
                rays_skipping=int(skips.sum()),
                live_strata_share=kept / tested if tested else 0.0)


def march_grads(fn, args, kw, window=False):
    """The samples and gradients of one march whose rays require gradients
    (as pose refinement marches): ts, deltas, xyzs (and t_start), and the
    gradients of their sum with respect to rays_o and rays_d, flattened
    into one list. The training march's hits are the box's intersections
    of those rays."""
    from mfnerf_tpu_torch.models.rendering import _clamp_near
    from mfnerf_tpu_torch.ops.intersection import ray_aabb_intersect_single
    ro = args[0].detach().clone().requires_grad_()
    rd = args[1].detach().clone().requires_grad_()
    if window:
        res = fn(ro, rd, *args[2:], **kw)
        outs = [res.ts, res.deltas, res.xyzs]
    else:
        hits = _clamp_near(ray_aabb_intersect_single(
            ro, rd, torch.zeros(3), torch.full((3,), args[5])))
        res = fn(ro, rd, hits, *args[3:], **kw)
        outs = [res.ts, res.deltas, res.xyzs, res.t_start]
    grads = torch.autograd.grad(sum(o.sum() for o in outs), (ro, rd))
    return [o.detach() for o in outs] + list(grads)


def check_march_train(label, args, kw, timed=False, grad=False):
    """One set of the training march's operands (march_rays_train's
    positional ``args`` and keywords ``kw``): the kernel against its plain
    version on the card, bit for bit in ts, deltas, xyzs, mask, n_samples,
    t_start and rm_samples, and k_idx on the valid slots (the kernel writes
    n_rungs - 1 on the others); with ``grad``, the samples recomputed for
    autograd and their gradients (march_grads) bit for bit too; with
    ``timed``, the kernel's device time by CUDA-graph replay, the plain
    version's, and the bound. Returns the fields; raises on a
    difference."""
    from mfnerf_tpu_torch.ops.ray_march import (march_rays_train,
                                                march_rays_train_plain)
    got = march_rays_train(*args, **kw)
    want = march_rays_train_plain(*args, **kw)
    torch.cuda.synchronize()
    bad = march_differs(got, want, ("ts", "deltas", "xyzs", "mask",
                                    "n_samples", "t_start", "rm_samples"),
                        masked_k=want.mask)
    n_rungs = args[10]
    fill_ok = bool((got.k_idx[~got.mask] == n_rungs - 1).all())
    strata = kw.get("strata")
    fields = dict(
        set=label, kernel="march_train", rays=int(args[0].shape[0]),
        mode="exact" if strata is None else "union" if strata.union
        else "twolevel", rank_start=kw.get("rank_start", 0),
        s_max=args[11], n_rungs=n_rungs, samples=int(want.rm_samples),
        rays_with_samples=int((want.n_samples > 0).sum()),
        full_rays=int((want.n_samples == args[11]).sum()),
        bit_equal=not bad, differs=bad,
        max_abs_err=march_max_err(got, want), masked_k_idx_fill=fill_ok)
    check(not bad, f"march_train {label}: differs from its plain version "
          f"in {bad}")
    check(fill_ok, f"march_train {label}: masked k_idx not n_rungs - 1")
    if grad:
        fields["grad_bit_equal"] = all(
            torch.equal(_float_bits(a), _float_bits(b)) for a, b in zip(
                march_grads(march_rays_train, args, kw),
                march_grads(march_rays_train_plain, args, kw)))
        check(fields["grad_bit_equal"], f"march_train {label}: the "
              f"differentiable samples or their gradients differ")
    if timed:
        fields["ms"] = graph_ms(lambda: march_rays_train(*args, **kw),
                                MARCH_GRAPH_ITERS)
        fields["plain_ms"] = cuda_ms(
            lambda: march_rays_train_plain(*args, **kw), 5)
        fields["bound_ms"], fields["bound_by"] = march_train_bound(
            args, kw, want)
        fields["share_of_bound"] = fields["bound_ms"] / fields["ms"]
    return fields


def window_rows(args):
    """march_rays_window's positional args of a window set in place
    (march_rays_window_into's ``args``): the rows ``alive`` of the frame's
    arrays, gathered."""
    alive = args[5]
    return tuple(x[alive] for x in args[:5]) + tuple(args[6:])


def _window_into_fresh(ro, rd, t0, t2, cursor, alive, *rest, **kw):
    """march_rays_window_into on a copy of the frame's cursor."""
    from mfnerf_tpu_torch.ops.ray_march import march_rays_window_into
    return march_rays_window_into(ro, rd, t0, t2, cursor.clone(), alive,
                                  *rest, **kw)


def _window_plain_rows(ro, rd, t0, t2, cursor, alive, *rest, skip=None):
    """The plain window march of the rows ``alive`` (gathered)."""
    from mfnerf_tpu_torch.ops.ray_march import march_rays_window_plain
    return march_rays_window_plain(*window_rows(
        (ro, rd, t0, t2, cursor, alive, *rest)))


def window_into_ms(args, kw):
    """Device ms of the in-place window march of a set (CUDA-graph replay):
    each replay first restores the frame's cursor, so every replay marches
    the same rows from the same cursors; the restore's own replay time is
    taken off. Returns (ms, restore ms); the cursor is left as it was."""
    from mfnerf_tpu_torch.ops.ray_march import march_rays_window_into
    cursor = args[4]
    saved = cursor.clone()

    def run():
        cursor.copy_(saved)
        march_rays_window_into(*args, **kw)

    both = graph_ms(run, MARCH_GRAPH_ITERS)
    restore = graph_ms(lambda: cursor.copy_(saved), MARCH_GRAPH_ITERS)
    cursor.copy_(saved)
    return both - restore, restore


def check_march_window(label, args, kw=None, timed=False):
    """check_march_train for the window march in place, as the serving loop
    runs it (march_rays_window_into's positional ``args``: the frame's
    arrays, its cursor before the round and the rows ``alive``; ``kw`` the
    skip): the kernel, on a copy of the frame's cursor, against the plain
    version of the gathered rows and against the skip model
    (march_rays_window_skip_plain), every output bit for bit, k_idx
    everywhere, the new cursor and exhausted; the frame's cursor after the
    kernel against the plain version's scattered into it (the rows
    ``alive`` moved, every other row as it was); the rung-by-rung walk's
    rungs (window_rung_work) and their operations' least time beside the
    byte bound; with ``timed`` the gradients too, and the kernel's time
    (window_into_ms)."""
    from mfnerf_tpu_torch.ops.ray_march import (march_rays_window_into,
                                                march_rays_window_plain,
                                                march_rays_window_skip_plain,
                                                window_lanes, window_params)
    kw = kw or {}
    cursor, alive = args[4], args[5]
    rows = window_rows(args)
    frame_cursor = cursor.clone()
    got = march_rays_window_into(*args[:4], frame_cursor, *args[5:], **kw)
    want = march_rays_window_plain(*rows)
    model = march_rays_window_skip_plain(*rows, **kw)
    expect = cursor.clone()
    expect[alive] = want.cursor
    outside = torch.ones_like(cursor, dtype=torch.bool)
    outside[alive] = False
    torch.cuda.synchronize()
    names = ("ts", "deltas", "xyzs", "mask", "n_samples", "cursor",
             "exhausted", "k_idx")
    bad = march_differs(got, want, names)
    bad_model = march_differs(model, want, names)
    in_place = torch.equal(frame_cursor, expect)
    untouched = torch.equal(frame_cursor[outside], cursor[outside])
    n = int(alive.shape[0])
    skip = kw.get("skip")
    p = window_params(rows[7], rows[8], rows[9], rows[6], rows[10],
                      rows[13], rows[11], rows[12], skip)
    rungs = window_rung_work(rows)
    bytes_ms, _ = march_window_bound(rows, want, skip)
    fields = dict(
        set=label, kernel="march_window", rays=n,
        frame_rows=int(cursor.shape[0]), n_window=rows[11], s_cap=rows[12],
        lanes=window_lanes(n, rows[11], p),
        cursor_min=int(rows[4].min()) if n else 0,
        cursor_max=int(rows[4].max()) if n else 0,
        samples=int(want.n_samples.sum()),
        exhausted=int(want.exhausted.sum()), bit_equal=not bad,
        differs=bad, model_bit_equal=not bad_model,
        model_differs=bad_model, cursor_in_place_equal=in_place,
        rows_outside_unchanged=untouched,
        max_abs_err=march_max_err(got, want), rung_by_rung_rungs=rungs,
        rung_by_rung_ops_ms=bound(0, MARCH_OPS_PER_RUNG * rungs)[0],
        **window_skip_stats(rows, skip))
    check(not bad, f"march_window {label}: differs from its plain version "
          f"in {bad}")
    check(not bad_model, f"march_window {label}: the skip model differs "
          f"from the plain version in {bad_model}")
    check(in_place and untouched, f"march_window {label}: the frame's "
          f"cursor after the march differs from the plain version's "
          f"scattered (rows outside alive unchanged: {untouched})")
    if timed:
        fields["grad_bit_equal"] = all(
            torch.equal(_float_bits(a), _float_bits(b)) for a, b in zip(
                march_grads(_window_into_fresh, args, kw, window=True),
                march_grads(_window_plain_rows, args, {}, window=True)))
        check(fields["grad_bit_equal"], f"march_window {label}: the "
              f"differentiable samples or their gradients differ")
        fields["ms"], fields["restore_ms"] = window_into_ms(args, kw)
        fields["plain_ms"] = cuda_ms(
            lambda: march_rays_window_plain(*rows), 5)
        fields["bound_ms"], fields["bound_by"] = march_window_bound(
            rows, want, skip)
        fields["share_of_bound"] = fields["bound_ms"] / fields["ms"]
    fields["bytes_ms"] = bytes_ms
    return fields


def round_capacity(frame_rays, rows):
    """The alive tier at which the tiered loop runs a round of ``rows``
    alive rays in a frame of ``frame_rays``."""
    from mfnerf_tpu_torch.models import rendering
    return rendering._tier(rendering._tiers(frame_rays,
                                            rendering.ALIVE_FLOOR), rows)


def _capacity_rows(alive, frame_rows, capacity):
    """A round's rows as the tiered loop launches them: ``alive`` and, up
    to ``capacity``, the frame's last row (the sentinel past the count)."""
    return torch.cat([alive, alive.new_full((capacity - alive.shape[0],),
                                            frame_rows - 1)])


def check_window_count(label, args, kw=None, capacity=None, timed=False):
    """The window march with an alive count (march_rays_window_into's
    ``count``) on a window set in place (check_march_window's ``args``):
    with ``capacity``, the set's rows padded to it as a serving round's
    tier holds them, the count the set's rows; else the count cutting a
    quarter of the set's rows. The kernel, on a copy of the frame's
    cursor, against march_rays_window_plain of the gathered rows with the
    count, every output bit for bit (the rows past the count an empty ray
    at cursor 0); the frame's cursor moved at the rows before the count
    only. With ``timed``, its device time by CUDA-graph replay
    (window_into_ms) against the bound of the rows before the count
    (march_window_bound) and the rows past it written."""
    from mfnerf_tpu_torch.ops.ray_march import (march_rays_window_into,
                                                march_rays_window_plain)
    kw = dict(kw or {})
    cursor, alive = args[4], args[5]
    if capacity is None:
        k = alive.shape[0] - alive.shape[0] // 4
    else:
        k = alive.shape[0]
        alive = _capacity_rows(alive, cursor.shape[0], capacity)
        args = (*args[:5], alive, *args[6:])
    count = torch.tensor([k], device=cursor.device)
    frame_cursor = cursor.clone()
    got = march_rays_window_into(*args[:4], frame_cursor, *args[5:],
                                 count=count, **kw)
    want = march_rays_window_plain(*window_rows(args), count=count)
    expect = cursor.clone()
    expect[alive[:k]] = want.cursor[:k]
    names = ("ts", "deltas", "xyzs", "mask", "n_samples", "cursor",
             "exhausted", "k_idx")
    bad = march_differs(got, want, names)
    fields = dict(set=label, kernel="march_window", count=k,
                  rows=int(alive.shape[0]), bit_equal=not bad, differs=bad,
                  cursor_in_place_equal=torch.equal(frame_cursor, expect),
                  max_abs_err=march_max_err(got, want))
    check(not bad and fields["cursor_in_place_equal"],
          f"march_window {label} with a count: differs from its plain "
          f"version in {bad}, cursor {fields['cursor_in_place_equal']}")
    if timed:
        fields["ms"], fields["restore_ms"] = window_into_ms(
            args, dict(kw, count=count))
        rows = window_rows((*args[:5], alive[:k], *args[6:]))
        past = (alive.shape[0] - k) * (args[13] * (12 + 4 + 4 + 1 + 8) + 17)
        fields["bound_ms"], fields["bound_by"] = march_window_bound(
            rows, march_rays_window_plain(*rows), kw.get("skip"), past)
        fields["share_of_bound"] = fields["bound_ms"] / fields["ms"]
    return fields


@contextlib.contextmanager
def capturing_marches():
    """Within the context, each call of the rendering module's marches
    appends ("train", args, kwargs) or, for a serving round's in-place
    window march, ("window", args, {"skip": ..}) to the yielded list, with
    march_rays_window_into's positional args: the frame's arrays, copies
    of its cursor before the round and of the round's rows ``alive``
    before its alive count (the rows it marches); tensors detached. The
    marches run as before (a frame's rounds run eagerly:
    render_test(graphs=False))."""
    from mfnerf_tpu_torch.models import rendering
    captured = []
    inner = {name: getattr(rendering, name)
             for name in ("march_rays_train", "march_rays_window_into")}

    def train(*args, **kwargs):
        captured.append(("train", tuple(
            a.detach() if torch.is_tensor(a) else a for a in args),
            dict(kwargs)))
        return inner["march_rays_train"](*args, **kwargs)

    def window(rays_o, rays_d, t_start, t2, cursor, alive, *rest, skip=None,
               **kw):
        rows = alive if kw.get("count") is None \
            else alive[:int(kw["count"])]
        frame = tuple(x.detach() for x in (rays_o, rays_d, t_start, t2)) \
            + (cursor.clone(), rows.clone())
        captured.append(("window", frame + tuple(rest), {"skip": skip}))
        return inner["march_rays_window_into"](
            rays_o, rays_d, t_start, t2, cursor, alive, *rest, skip=skip,
            **kw)

    rendering.march_rays_train = train
    rendering.march_rays_window_into = window
    try:
        yield captured
    finally:
        for name, fn in inner.items():
            setattr(rendering, name, fn)


@torch.no_grad()
def step_march_operands(system, seed):
    """The training march's operands of one step of ``system``
    (``NeRFSystem.step_loss`` on a ray batch drawn from ``seed``): (args,
    kwargs) of march_rays_train as render_train calls it."""
    dev, b = system.device, system.hparams.batch_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_img, hw = system.rays.shape[:2]
    img = torch.randint(n_img, (b,), generator=gen, device=dev)
    pix = torch.randint(hw, (b,), generator=gen, device=dev)
    with capturing_marches() as captured:
        system.step_loss(img, pix, torch.rand((b,), generator=gen,
                                              device=dev))
    check(len(captured) == 1 and captured[0][0] == "train",
          f"a step marched {[c[0] for c in captured]}")
    return captured[0][1:]


def degenerate_rays(scale, n, seed, dev):
    """Rays that exercise the march's edges, n // 4 of each kind: from
    outside the box pointing away (they miss), from inside the box (t_near
    0, clamped to NEAR_DISTANCE), along the axes (1/d infinite) from inside
    and outside, and grazing the box's faces."""
    rng = np.random.default_rng(seed)
    q = n // 4
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.empty((n, 3))
    o[:q] = 3.0 * scale * d[:q]                     # outward: miss
    o[q:2 * q] = rng.uniform(-scale, scale, (q, 3))  # inside the box
    axes = np.eye(3)[rng.integers(0, 3, q)] * rng.choice([-1.0, 1.0], (q, 1))
    o[2 * q:3 * q] = np.where(rng.random((q, 1)) < 0.5,
                              rng.uniform(-scale, scale, (q, 3)),
                              -2.0 * scale * axes)
    d[2 * q:3 * q] = axes
    face = rng.integers(0, 3, n - 3 * q)              # grazing a face
    o[3 * q:] = rng.uniform(-scale, scale, (n - 3 * q, 3))
    o[3 * q:, :][np.arange(n - 3 * q), face] = scale
    d[3 * q:][np.arange(n - 3 * q), face] = 0.0
    d[3 * q:] /= np.linalg.norm(d[3 * q:], axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))


def march_sets_of(system, seed):
    """The training march's sets of ``system``'s configuration: one step's
    operands (rays drawn from ``seed``), the degenerate rays (budgeted and
    exact), an empty and a full bitfield (budgeted and exact) on the step's
    rays, as (label, args, kwargs)."""
    from mfnerf_tpu_torch.models.rendering import _scene_hits, train_strata
    cfg, rcfg, dev, occ = (system.model_cfg, system.rcfg, system.device,
                           system.occ)
    args, kw = step_march_operands(system, seed)
    sets = [("step", args, kw)]
    ro, rd = degenerate_rays(cfg.scale, N_MARCH_DEGENERATE, seed + 1, dev)
    hits = _scene_hits(system.model, ro, rd)
    noise = torch.rand((ro.shape[0],), generator=torch.Generator(
        device=dev).manual_seed(seed + 2), device=dev)
    deg = (ro, rd, hits, *args[3:9], noise, *args[10:])
    sets += [("degenerate", deg, kw), ("degenerate_exact", deg, {})]
    for label, byte in (("empty", 0), ("full", 255)):
        bits = torch.full_like(occ.density_bitfield, byte)
        occ_b = dataclasses.replace(occ, density_bitfield=bits
                                    ).refresh_coarse(cfg)
        strata = train_strata(cfg, occ_b, rcfg)
        a = (*args[:3], bits, *args[4:])
        sets += [(label, a, dict(kw, strata=strata)),
                 (label + "_exact", a, {})]
    return sets


def march_train_edge_sets(system, seed):
    """The training kernel's edges on ``system``'s configuration, as
    (label, args, kwargs), each checked with gradients: on a full bitfield
    the cap inside a pass (s_max 40 and 100) and the exit inside one (the
    degenerate rays that start inside the box, cap max_samples: every ray
    stops at its exit); rank_start 40, 128 and 200 on the step; the exact
    march over n_rungs 20, 50 and 1000 (none a multiple of 32); budgets of
    one and two strata a ray, and of one at 1,024 rays (the five-cascade
    steps' count);
    each budgeted and exact where both apply."""
    from mfnerf_tpu_torch.models.rendering import _scene_hits, train_strata
    cfg, dev, occ = system.model_cfg, system.device, system.occ
    args, kw = step_march_operands(system, seed)
    strata = kw["strata"]
    full = torch.full_like(occ.density_bitfield, 255)
    strata_f = train_strata(cfg, dataclasses.replace(
        occ, density_bitfield=full).refresh_coarse(cfg), system.rcfg)

    def changed(a, **at):
        a = list(a)
        for i, v in at.items():
            a[int(i[1:])] = v
        return tuple(a)

    sets = []
    for s_max in (40, 100):
        a = changed(args, a3=full, a11=s_max)
        sets += [(f"cap_{s_max}", a, dict(kw, strata=strata_f)),
                 (f"cap_{s_max}_exact", a, {})]
    ro, rd = degenerate_rays(cfg.scale, 4 * 1024, seed + 1, dev)
    ro, rd = ro[1024:2048].contiguous(), rd[1024:2048].contiguous()
    noise = torch.rand((1024,), generator=torch.Generator(
        device=dev).manual_seed(seed + 2), device=dev)
    a = changed(args, a0=ro, a1=rd, a2=_scene_hits(system.model, ro, rd),
                a3=full, a9=noise, a11=args[8])
    sets += [("exit", a, dict(kw, strata=strata_f)), ("exit_exact", a, {})]
    for r in (40, 128, 200):
        sets += [(f"rank_start_{r}", args, dict(kw, rank_start=r)),
                 (f"rank_start_{r}_exact", args, dict(rank_start=r))]
    for n_rungs in (20, 50, 1000):
        sets.append((f"exact_{n_rungs}_rungs", changed(args, a10=n_rungs),
                     {}))
    for s_strata in (1, 2):
        sets.append((f"s_strata_{s_strata}", args,
                     dict(kw, strata=strata._replace(s_strata=s_strata))))
    few = changed(args, **{f"a{i}": args[i][:1024].contiguous()
                           for i in (0, 1, 2, 9)})
    sets.append(("s_strata_1_1024_rays", few,
                 dict(kw, strata=strata._replace(s_strata=1))))
    return sets


def oracle_march_sets(system, rays, rcfg):
    """The dense oracle's exact march (render_test_dense's chunks) on every
    MARCH_ORACLE_STRIDE-th ray of a view: one set a rank window."""
    from mfnerf_tpu_torch.models.rendering import _scene_hits
    cfg = system.model_cfg
    ro = rays[0][::MARCH_ORACLE_STRIDE].contiguous()
    rd = rays[1][::MARCH_ORACLE_STRIDE].contiguous()
    hits = _scene_hits(system.model, ro, rd)
    base = (ro, rd, hits, system.occ.density_bitfield, cfg.cascades,
            cfg.scale, rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples,
            torch.zeros_like(hits[:, 0]),
            rcfg.n_rungs(cfg.scale, cfg.grid_size, test=True),
            rcfg.s_max_test)
    return [(f"oracle_window_{j}", base,
             dict(dt_scale=rcfg._dt_scale(cfg.scale, True),
                  rank_start=j * rcfg.s_max_test))
            for j in range(-(-rcfg.max_samples // rcfg.s_max_test))]


def frame_window_sets(system, rays, rcfg):
    """Every window march of one render_test frame (the alive-ray loop's
    rounds, their cursors, s_cap, n_window and stage-A skip as the loop
    chose them), as (args, kwargs)."""
    from mfnerf_tpu_torch.models.rendering import render_test
    with torch.no_grad(), capturing_marches() as captured:
        render_test(system.model, system.occ, *rays, rcfg, graphs=False)
    check(captured and all(c[0] == "window" for c in captured),
          f"render_test marched {[c[0] for c in captured]}")
    return [c[1:] for c in captured]


def window_edge_sets(model, occ, rcfg, rays, seed):
    """The window march's edge sets on ``model``'s configuration, beside a
    frame's rounds, as (label, args, kwargs) in place
    (march_rays_window_into's args: each set's rays as a frame, three
    quarters of its rows alive, in a random order): ``rays`` (a view's,
    every MARCH_ORACLE_STRIDE-th) against an empty and a full bitfield
    (their grids refreshed), the degenerate rays at mid-ladder cursors, the
    view's rays with |d| three times the grids' dir_norm (walked rung by
    rung), and windows of stratum + 1 and 3 stratum - 1 rungs at mid-ladder
    cursors (indivisible; without a skip, of the cascade march's
    stratum)."""
    from mfnerf_tpu_torch.models.rendering import _scene_hits, window_skip
    from mfnerf_tpu_torch.ops.ray_march import cascades_stratum
    cfg = model.cfg
    dev = occ.density_bitfield.device
    k_total = rcfg.n_rungs(cfg.scale, cfg.grid_size, test=True)
    static = (cfg.cascades, cfg.scale, rcfg.exp_step_factor, cfg.grid_size,
              rcfg.max_samples)
    dt_scale = rcfg._dt_scale(cfg.scale, True)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def window_args(ro, rd, bits, cursor, n_window, s_cap):
        hits = _scene_hits(model, ro, rd)
        m = ro.shape[0]
        alive = torch.randperm(m, generator=gen, device=dev)[:m - m // 4]
        return (ro, rd, hits[:, 0].contiguous(), hits[:, 1].contiguous(),
                cursor, alive, bits, *static, n_window, s_cap, dt_scale)

    ro = rays[0][::MARCH_ORACLE_STRIDE].contiguous()
    rd = rays[1][::MARCH_ORACLE_STRIDE].contiguous()
    n = ro.shape[0]
    zeros = torch.zeros((n,), dtype=torch.int64, device=dev)
    mid = torch.randint(0, k_total // 2, (n,), generator=gen, device=dev)
    skip = window_skip(cfg, occ, rcfg)
    sets = []
    for label, byte, s_cap in (("empty", 0, 1), ("full", 255, 4)):
        bits = torch.full_like(occ.density_bitfield, byte)
        occ_b = dataclasses.replace(occ, density_bitfield=bits
                                    ).refresh_coarse(cfg)
        sets.append((label, window_args(ro, rd, bits, zeros, 70, s_cap),
                     dict(skip=window_skip(cfg, occ_b, rcfg))))
    dro, drd = degenerate_rays(cfg.scale, N_MARCH_DEGENERATE, seed + 1, dev)
    dmid = torch.randint(0, k_total // 2, (dro.shape[0],), generator=gen,
                         device=dev)
    sets.append(("degenerate", window_args(
        dro, drd, occ.density_bitfield, dmid, 64, 8), dict(skip=skip)))
    long_d = rd * (3.0 * cfg.dir_norm / rd.norm(dim=1, keepdim=True))
    sets.append(("long_d", window_args(
        ro, long_d, occ.density_bitfield, mid, 70, 2), dict(skip=skip)))
    st = skip.stratum if skip is not None else cascades_stratum(
        rcfg.exp_step_factor, cfg.scale, cfg.cascades,
        dir_norm=cfg.dir_norm)[0] or 8
    for label, n_window in (("stratum+1", st + 1),
                            ("3stratum-1", 3 * st - 1)):
        sets.append((label, window_args(ro, rd, occ.density_bitfield, mid,
                                        n_window, 4), dict(skip=skip)))
    return sets


def march_phase(label, train_sets, window_sets=(), timed_train=0,
                window_edges=(), time_rounds=False, train_edges=()):
    """The march checks of a configuration: every training-march set
    (label, args, kwargs), every window set ((args, kwargs): one a round of
    the alive-ray loop) and every window edge set (label, args, kwargs)
    against the plain version and the skip model, bit for bit; the training
    set at ``timed_train`` also with gradients (check_march_train's
    ``grad``) and timed, the first (largest) window timed with gradients,
    and with ``time_rounds`` every round timed (CUDA-graph replay) and the
    rounds' sum. Prints a phase line a training set, one an edge set and
    one for the window sets; every training edge set (label, args,
    kwargs) with gradients. Returns the timed sets' fields (the rounds'
    times under "window_rounds") and the worst error."""
    timed = {}
    err = 0.0
    for i, (name, args, kw) in enumerate(train_sets):
        fields = check_march_train(name, args, kw, timed=i == timed_train,
                                   grad=i == timed_train)
        phase("march", config=label, **fields)
        err = max(err, fields["max_abs_err"])
        if i == timed_train:
            timed["train"] = fields
        torch.cuda.empty_cache()
    for name, args, kw in train_edges:
        fields = check_march_train(name, args, kw, grad=True)
        phase("march", config=label, edge=True, **fields)
        err = max(err, fields["max_abs_err"])
        torch.cuda.empty_cache()
    for name, args, kw in window_edges:
        fields = check_march_window(name, args, kw)
        phase("march", config=label, **fields)
        err = max(err, fields["max_abs_err"])
        fields = check_window_count(name, args, kw)
        phase("march", config=label, **fields)
        err = max(err, fields["max_abs_err"])
        torch.cuda.empty_cache()
    if window_sets:
        # the first round with its alive count, as the tiered loop runs it
        args, kw = window_sets[0]
        timed["window_count"] = check_window_count(
            "round_0", args, kw, round_capacity(args[0].shape[0] - 1,
                                                args[5].shape[0]),
            timed=True)
        phase("march", config=label, **timed["window_count"])
        err = max(err, timed["window_count"]["max_abs_err"])
        rounds = []
        for i, (args, kw) in enumerate(window_sets):
            rounds.append(check_march_window(f"round_{i}", args, kw,
                                             timed=i == 0))
            if time_rounds and i:
                rounds[-1]["ms"], rounds[-1]["restore_ms"] = \
                    window_into_ms(args, kw)
        timed["window"] = rounds[0]
        err = max([err] + [r["max_abs_err"] for r in rounds])
        fields = dict(
            rounds=len(rounds), rays=[r["rays"] for r in rounds],
            s_caps=sorted({r["s_cap"] for r in rounds}),
            n_windows=sorted({r["n_window"] for r in rounds}),
            lanes=[r["lanes"] for r in rounds],
            cursor_max=max(r["cursor_max"] for r in rounds),
            samples=sum(r["samples"] for r in rounds),
            exhausted=sum(r["exhausted"] for r in rounds),
            bit_equal=all(r["bit_equal"] for r in rounds),
            model_bit_equal=all(r["model_bit_equal"] for r in rounds),
            cursor_in_place_equal=all(r["cursor_in_place_equal"]
                                      for r in rounds),
            rung_by_rung_rungs=sum(r["rung_by_rung_rungs"] for r in rounds),
            max_abs_err=err, first_round=rounds[0])
        if time_rounds:
            fields["round_ms"] = [r["ms"] for r in rounds]
            fields["rounds_ms_sum"] = sum(fields["round_ms"])
            fields["round_restore_ms"] = [r["restore_ms"] for r in rounds]
            fields["round_bytes_ms"] = [r["bytes_ms"] for r in rounds]
            fields["round_rung_by_rung_ops_ms"] = [
                r["rung_by_rung_ops_ms"] for r in rounds]
            timed["window_rounds"] = {key: fields[key] for key in (
                "round_ms", "rounds_ms_sum", "round_restore_ms",
                "round_bytes_ms",
                "round_rung_by_rung_ops_ms", "rays", "lanes")}
        phase("march", config=label, set="frame", kernel="march_window",
              **fields)
        torch.cuda.empty_cache()
    return timed, err


def composite_counts(reset=False):
    """The composite kernels' launch counts, {"fwd": .., "bwd": ..,
    "round": ..}, after zeroing them with ``reset``."""
    from mfnerf_tpu_torch.ops.composite import (composite_test_step,
                                                composite_train,
                                                composite_train_bwd)
    if reset:
        composite_train.launches = composite_train_bwd.launches = 0
        composite_test_step.launches = 0
    return {"fwd": composite_train.launches,
            "bwd": composite_train_bwd.launches,
            "round": composite_test_step.launches}


def check_composite_launches(label, fields):
    """Exactly one composite forward and one backward launch a step of a
    run's ``steps``, and one round a window march (each round of each
    served frame)."""
    c, m = fields["composite"], fields["march"]
    check(c["fwd"] == c["bwd"] == fields["steps"]
          and c["round"] == m["window"],
          f"{label}: composite launches {c} in {fields['steps']} steps and "
          f"{m['window']} window marches")


@contextlib.contextmanager
def capturing_composites():
    """Within the context, each call of the rendering module's
    composite_train appends ("train", (sigmas, rgbs,
    deltas, ts, mask), T_threshold, grads) to the yielded list, detached,
    ``grads`` a dict that the backward fills with the incoming gradients of
    the outputs it reaches (opacity, depth, rgb, ws); each call of
    composite_test_step_into appends ("round", (sigmas,
    rgbs, deltas, ts, mask, index, opacity, depth, rgb), T_threshold, None),
    the block's rows before the call's alive count, the accumulators
    copied as the call found them. Calls run as before (a frame's rounds
    run eagerly: render_test(graphs=False))."""
    from mfnerf_tpu_torch.models import rendering
    captured = []
    train, into = rendering.composite_train, rendering.composite_test_step_into

    def train_rec(sigmas, rgbs, deltas, ts, mask, T_threshold=1e-4):
        comp = train(sigmas, rgbs, deltas, ts, mask, T_threshold)
        grads = {}
        for name in ("opacity", "depth", "rgb", "ws"):
            out = getattr(comp, name)
            if out.requires_grad:    # a hook may see None: not reached
                out.register_hook(lambda g, name=name: None if g is None
                                  else grads.__setitem__(
                                      name, g.detach().clone()))
        captured.append(("train", tuple(x.detach() for x in (
            sigmas, rgbs, deltas, ts, mask)), T_threshold, grads))
        return comp

    def into_rec(sigmas, rgbs, deltas, ts, mask, index, opacity, depth, rgb,
                 T_threshold, count=None):
        k = index.shape[0] if count is None else int(count)
        captured.append(("round", tuple(x[:k].detach().clone() for x in (
            sigmas, rgbs, deltas, ts, mask, index)) + tuple(
            x.detach().clone() for x in (opacity, depth, rgb)),
            T_threshold, None))
        return into(sigmas, rgbs, deltas, ts, mask, index, opacity, depth,
                    rgb, T_threshold, count=count)

    rendering.composite_train = train_rec
    rendering.composite_test_step_into = into_rec
    try:
        yield captured
    finally:
        rendering.composite_train = train
        rendering.composite_test_step_into = into


def step_composite_operands(system, seed):
    """The composite's operands of one training step of ``system``
    (``NeRFSystem.step_loss`` and its backward on a ray batch drawn from
    ``seed``; weights and optimiser untouched): (args, T_threshold, the
    loss's incoming gradients)."""
    dev, b = system.device, system.hparams.batch_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_img, hw = system.rays.shape[:2]
    img = torch.randint(n_img, (b,), generator=gen, device=dev)
    pix = torch.randint(hw, (b,), generator=gen, device=dev)
    with capturing_composites() as captured:
        system.step_loss(img, pix, torch.rand(
            (b,), generator=gen, device=dev))[0].backward()
    system.optimizer.zero_grad(set_to_none=True)
    check(len(captured) == 1 and captured[0][0] == "train",
          f"a step composited {[c[0] for c in captured]}")
    return captured[0][1:]


def frame_round_sets(system, rays, rcfg, occ=None):
    """Every compositing round of one render_test frame (the alive-ray
    loop's blocks, their rows' accumulator entries and the accumulators as
    the round found them), as (args, T_threshold)."""
    from mfnerf_tpu_torch.models.rendering import render_test
    with torch.no_grad(), capturing_composites() as captured:
        render_test(system.model, system.occ if occ is None else occ, *rays,
                    rcfg, graphs=False)
    check(captured and all(c[0] == "round" for c in captured),
          f"render_test composited {[c[0] for c in captured]}")
    return [c[1:3] for c in captured]


def composite_edge_sets(dev, seed, n=4096):
    """Synthetic training blocks at the edges, (label, args, T_threshold):
    an opaque first sample (sigma * delta = 30: 1 - alpha == 0 exactly),
    the threshold tie (two samples that leave the transmittance before the
    third at T_threshold or a few ulps from it, row by row), masked holes between valid samples,
    empty rows (all masked), and S = 256 (the oracle chunk's rows, eight
    passes of a warp), with seeded random samples elsewhere."""
    rng = np.random.default_rng(seed)

    def block(s, sigma_scale=20.0, valid=0.9):
        sig = rng.exponential(sigma_scale, (n, s)).astype(np.float32)
        dl = rng.uniform(2e-3, 2e-2, (n, s)).astype(np.float32)
        mask = rng.random((n, s)) < valid
        return sig, dl, mask

    sets = []
    sig, dl, mask = block(64)
    sig[:, 0], dl[:, 0], mask[:, 0] = 3000.0, 0.01, True
    sets.append(("opaque_first", sig, dl, mask, 1e-4))
    # the tie: 1 - alpha of the first sample 1.0002 x T_threshold, the
    # second's alpha swept so that the transmittance before the third
    # crosses T_threshold in steps of about one of its ulps
    sig, dl, mask = block(64, 2.0)
    om0 = np.float32(1) - (np.float32(1) - np.exp(-np.float32(9.2101)))
    x1 = (om0 / np.float32(1e-4) - 1 + np.arange(-(n // 2), n - n // 2)
          * 1e-8).astype(np.float32)
    sig[:, :2] = np.stack([np.full(n, 9.2101, np.float32), x1], axis=1)
    dl[:, :2], mask[:, :3] = 1.0, True
    sets.append(("threshold_tie", sig, dl, mask, 1e-4))
    sig, dl, mask = block(64, valid=0.5)
    sets.append(("masked_holes", sig, dl, mask, 1e-4))
    sig, dl, mask = block(64)
    mask[: n // 2] = False
    sets.append(("empty_rows", sig, dl, mask, 1e-4))
    sig, dl, mask = block(256, 1.0)
    sets.append(("s256", sig, dl, mask, 1e-4))
    # the backward's row lengths (a pass of 8 lanes; 2, 2, 4 and 4 passes in
    # registers; 7 passes, the two-walk kernel), with holes, and a quarter
    # of the rows saturating in mid-pass (opaque from slot s // 3 + 5)
    for s_ in (8, 40, 64, 128, 200):
        sig, dl, mask = block(s_, 2.0, valid=0.7)
        sig[: n // 4, s_ // 3 + 5:] = 400.0
        sets.append((f"bwd_s{s_}", sig, dl, mask, 1e-4))
    out = []
    for label, sig, dl, mask, thr in sets:
        s = sig.shape[1]
        ts = (np.cumsum(dl, axis=1) + 0.05).astype(np.float32)
        rgbs = rng.random((n, s, 3), dtype=np.float32)
        out.append((label, tuple(torch.from_numpy(a).to(dev) for a in (
            sig, rgbs, dl, ts, mask)), thr))
    return out


def composite_round_edge_sets(dev, seed):
    """The edge blocks as serving rounds, (label, args, T_threshold): each
    row's accumulators drawn (opacities in [0, 1), a tenth of them within
    1e-3 of 1 - T_threshold) into a frame of twice the rows, at a random
    entry of it, at T_threshold 1e-2."""
    rng = np.random.default_rng(seed)
    out = []
    for label, (sig, rgbs, dl, ts, mask), _ in composite_edge_sets(
            dev, seed):
        n = sig.shape[0]
        m = 2 * n
        op = rng.uniform(0.0, 1.0, m).astype(np.float32)
        near = rng.random(m) < 0.1
        op[near] = (1.0 - 1e-2 + rng.uniform(-1e-3, 1e-3, near.sum())
                    ).astype(np.float32)
        frame = [torch.from_numpy(a).to(dev) for a in (
            op, rng.random(m, dtype=np.float32),
            rng.random((m, 3), dtype=np.float32))]
        index = torch.from_numpy(rng.permutation(m)[:n]).to(dev)
        out.append((label, (sig, rgbs, dl, ts, mask, index, *frame), 1e-2))
    return out


def _plain_transmittance(sigmas, deltas, mask, t_start=None):
    """The plain version's transmittance before each sample and, last, after
    the row: (N, S + 1)."""
    alpha = torch.where(mask, 1.0 - torch.exp(-sigmas * deltas), 0.0)
    t = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                 1.0 - alpha], dim=1), dim=1)
    return t if t_start is None else t_start[:, None] * t


def composite_tie_rows(sigmas, deltas, mask, thr, t_start=None):
    """Rows with a valid sample whose transmittance before it, or the row's
    after it, lies within COMPOSITE_TIE_ULPS float32 ulps of thr: where the
    kernel's and torch's orders of the product may fall on either side."""
    t = _plain_transmittance(sigmas, deltas, mask, t_start)
    ulp = float(np.spacing(np.float32(thr)))
    near = (t - np.float32(thr)).abs() <= COMPOSITE_TIE_ULPS * ulp
    return (near & torch.cat([mask, torch.ones_like(mask[:, :1])],
                             dim=1)).any(dim=1)


def _rows_err(got, want, keep):
    """max |got - want| over the rows ``keep``, and max |want| there."""
    if not bool(keep.any()):
        return 0.0, 0.0
    return (float((got[keep] - want[keep]).abs().max()),
            float(want[keep].abs().max()))


def _rel_l2(got, want, keep):
    """||got - want|| / ||want|| over the rows ``keep`` (0 where both are
    0)."""
    num = float((got[keep] - want[keep]).norm())
    den = float(want[keep].norm())
    return num / den if den else (0.0 if num == 0 else math.inf)


def _bits_equal(a, b):
    return all(torch.equal(_float_bits(x), _float_bits(y))
               for x, y in zip(a, b))


def composite_fwd_bound(args, included):
    """(least ms, bound_by) of one training forward: the mask read whole,
    sigma, delta, t and rgb of the included samples (the slots that decide
    the row), ws written whole, the rows' outputs once;
    COMPOSITE_OPS_PER_SAMPLE a sample."""
    n, s = args[0].shape
    n_bytes = n * s * (1 + 4) + included * (4 + 4 + 4 + 12) + n * 24
    return bound(n_bytes, COMPOSITE_OPS_PER_SAMPLE * included)


def composite_bwd_bound(args, included, ups, needs):
    """(least ms, bound_by) of one backward: the mask whole, the included
    samples' operands and g_ws, the rows' incoming gradients, the asked-for
    gradients written whole; twice the forward's operations."""
    n, s = args[0].shape
    g_row = sum(4 * (3 if i == 2 else 1) for i, g in enumerate(ups[:3])
                if g is not None)
    out = sum(b for b, need in zip((4, 12, 4, 4), needs) if need)
    n_bytes = n * s * (1 + out) + included * (
        24 + (4 if ups[3] is not None else 0)) + n * g_row
    return bound(n_bytes, 2 * COMPOSITE_OPS_PER_SAMPLE * included)


def composite_round_bound(args, included):
    """(least ms, bound_by) of one serving round: the mask whole, the
    included samples' operands, the rows' accumulators (and entries) read
    and written, alive written."""
    n, s = args[0].shape
    n_bytes = n * s * 1 + included * 24 + n * (8 + 20 + 20 + 1)
    return bound(n_bytes, COMPOSITE_OPS_PER_SAMPLE * included)


def check_composite_train(label, args, thr, loss_grads=None, timed=False):
    """One training block (sigmas, rgbs, deltas, ts, mask on the card): the
    forward kernel against composite_train_fwd_plain (ws, opacity, depth
    and rgb within COMPOSITE_FWD_TOL x max, the rows' included counts
    equal) and the backward kernel against composite_train_bwd_plain and
    autograd through composite_train_plain (each gradient within
    COMPOSITE_BWD_TOL relative L2), with seeded random incoming gradients
    for all four outputs and, where given, the loss's own (``loss_grads``:
    {output: gradient}); rows within COMPOSITE_TIE_ULPS of the threshold
    are counted apart and may differ by one sample's weight. Each kernel
    twice, bit for bit. With ``timed``, device times by CUDA-graph replay
    beside the plain versions' and the bounds. Returns the fields."""
    from mfnerf_tpu_torch.ops.composite import (
        _launch_train_bwd, _launch_train_fwd, bwd_passes,
        composite_train_bwd, composite_train_bwd_order_plain,
        composite_train_bwd_plain, composite_train_fwd,
        composite_train_fwd_order_plain, composite_train_fwd_plain,
        composite_train_plain)
    sig, rgbs, dl, ts, mask = args
    n, s = sig.shape
    f32 = tuple(x.float() for x in args[:4])
    got = composite_train_fwd(*args, thr)
    again = composite_train_fwd(*args, thr)
    want = composite_train_fwd_plain(*args, thr)
    walk = _launch_train_fwd(*f32, mask, thr, passes=0)
    model = composite_train_fwd_order_plain(*args, thr)
    weights = composite_train_bwd(
        *args, None, None, torch.ones((n, 3), device=sig.device), None, thr,
        needs=(False, True, False, False))[1][..., 0].contiguous()
    torch.cuda.synchronize()
    ties = composite_tie_rows(sig, dl, mask, thr)
    keep = ~ties
    counts_differ = got[4] != want[4]
    fwd_err = {}
    for name, g, w in zip(("opacity", "depth", "rgb", "ws"), got, want):
        err, scale = _rows_err(g, w, keep)
        fwd_err[name] = err / scale if scale else err
    tie_err = max(_rows_err(g, w, ties)[0] for g, w in zip(got[:4], want))
    included = int(want[4].sum())
    at_thr = _plain_transmittance(sig, dl, mask)[:, :-1] == np.float32(thr)
    fields = dict(
        set=label, kernel="composite_train", rays=n, s=s, T_threshold=thr,
        samples=int(mask.sum()), included=included,
        slots_at_threshold=int((at_thr & mask).sum()),
        vr_samples_equal=int(got[4].sum()) == included,
        tie_rows=int(ties.sum()), tie_rows_differing=int(
            (counts_differ & ties).sum()), tie_max_abs_err=tie_err,
        fwd_rel_err=fwd_err, fwd_tol=COMPOSITE_FWD_TOL,
        fwd_bit_equal=_bits_equal(got, again),
        fwd_passes=bwd_passes(s),
        fwd_walk_bit_equal=_bits_equal(got, walk),
        fwd_model_bit_equal=_bits_equal(got, model),
        ws_bwd_weights_bit_equal=_bits_equal(got[3:4], (weights,)),
        max_abs_err=max(_rows_err(g, w, keep)[0]
                        for g, w in zip(got[:4], want)))
    check(not bool((counts_differ & keep).any()),
          f"composite_train {label}: included counts differ on "
          f"{int((counts_differ & keep).sum())} rows clear of the threshold")
    check(max(fwd_err.values()) <= COMPOSITE_FWD_TOL,
          f"composite_train {label}: forward {fwd_err}")
    check(tie_err <= thr * 1.001 + COMPOSITE_FWD_TOL,
          f"composite_train {label}: tie rows differ by {tie_err}")
    check(fields["fwd_bit_equal"], f"composite_train {label}: two launches "
          f"differ")
    check(fields["fwd_walk_bit_equal"], f"composite_train {label}: differs "
          f"from the pass-by-pass kernel")
    check(fields["fwd_model_bit_equal"], f"composite_train {label}: differs "
          f"from composite_train_fwd_order_plain")
    check(fields["ws_bwd_weights_bit_equal"], f"composite_train {label}: ws "
          f"differ from the backward kernel's weights")
    rng = np.random.default_rng(n + s)
    rand = tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                  ).to(sig.device)
                 for shape in ((n,), (n,), (n, 3), (n, s)))
    ups_sets = [("all", rand), ("no_ws", rand[:3] + (None,))]
    if loss_grads is not None:
        ups_sets.append(("loss", tuple(loss_grads.get(k) for k in (
            "opacity", "depth", "rgb", "ws"))))
    bwd = {}
    for ups_label, ups in ups_sets:
        g1 = composite_train_bwd(*args, *ups, thr)
        g2 = composite_train_bwd(*args, *ups, thr)
        plain = composite_train_bwd_plain(*args, *ups, thr)
        leaves = [x.clone().requires_grad_() for x in args[:4]]
        comp = composite_train_plain(*leaves, mask, thr)
        outs = [(getattr(comp, k), g) for k, g in zip(
            ("opacity", "depth", "rgb", "ws"), ups) if g is not None]
        auto = torch.autograd.grad([o for o, _ in outs], leaves,
                                   [g for _, g in outs], allow_unused=True)
        auto = [torch.zeros_like(x) if a is None else a
                for a, x in zip(auto, leaves)]
        torch.cuda.synchronize()
        names = ("d_sigmas", "d_rgbs", "d_deltas", "d_ts")
        rel_plain = {k: _rel_l2(a, b, keep) for k, a, b in
                     zip(names, g1, plain)}
        rel_auto = {k: _rel_l2(a, b, keep) for k, a, b in
                    zip(names, g1, auto)}
        bwd[ups_label] = dict(
            rel_l2_plain=rel_plain, rel_l2_autograd=rel_auto,
            bit_equal=_bits_equal(g1, g2),
            max_abs_err=max(_rows_err(a, b, keep)[0]
                            for a, b in zip(g1, plain)))
        check(max(rel_plain.values()) <= COMPOSITE_BWD_TOL
              and max(rel_auto.values()) <= COMPOSITE_BWD_TOL,
              f"composite_train_bwd {label} ({ups_label}): plain "
              f"{rel_plain}, autograd {rel_auto}")
        check(bwd[ups_label]["bit_equal"], f"composite_train_bwd {label}: "
              f"two launches differ")
        # the two-walk kernel on the same operands
        two = _launch_train_bwd(*f32, mask, *ups, thr, (True,) * 4,
                                passes=0)
        bwd[ups_label]["two_walk_bit_equal"] = _bits_equal(g1, two)
        check(bwd[ups_label]["two_walk_bit_equal"], f"composite_train_bwd "
              f"{label} ({ups_label}): differs from the two-walk kernel")
        bwd[ups_label]["order_model_bit_equal"] = _bits_equal(
            g1, composite_train_bwd_order_plain(*args, *ups, thr))
    # each output left out: the others' bits unchanged
    full = composite_train_bwd(*args, *rand, thr)
    for k in range(4):
        needs = tuple(j != k for j in range(4))
        part = composite_train_bwd(*args, *rand, thr, needs=needs)
        ok = part[k] is None and _bits_equal(
            [g for j, g in enumerate(part) if j != k],
            [g for j, g in enumerate(full) if j != k])
        check(ok, f"composite_train_bwd {label}: output {k} left out "
              f"changes the others")
    fields["bwd_outputs_left_out_equal"] = True
    fields["bwd_passes"] = bwd_passes(s)
    fields["bwd"] = bwd
    fields["bwd_tol"] = COMPOSITE_BWD_TOL
    fields["bwd_max_abs_err"] = max(b["max_abs_err"] for b in bwd.values())
    if timed:
        fields["ms"] = graph_ms(lambda: composite_train_fwd(*args, thr),
                                COMPOSITE_GRAPH_ITERS)
        fields["fwd_walk_ms"] = graph_ms(
            lambda: _launch_train_fwd(*f32, mask, thr, passes=0),
            COMPOSITE_GRAPH_ITERS)
        fields["plain_ms"] = cuda_ms(
            lambda: composite_train_fwd_plain(*args, thr), 5)
        fields["bound_ms"], fields["bound_by"] = composite_fwd_bound(
            args, included)
        fields["share_of_bound"] = fields["bound_ms"] / fields["ms"]
        ups = ups_sets[-1][1]
        needs = (True, True, False, False)     # a training step's
        fields["bwd_ms"] = graph_ms(
            lambda: composite_train_bwd(*args, *ups, thr, needs=needs),
            COMPOSITE_GRAPH_ITERS)
        fields["bwd_plain_ms"] = cuda_ms(
            lambda: composite_train_bwd_plain(*args, *ups, thr), 5)
        fields["bwd_bound_ms"], fields["bwd_bound_by"] = \
            composite_bwd_bound(args, included, ups, needs)
        fields["bwd_share_of_bound"] = fields["bwd_bound_ms"] \
            / fields["bwd_ms"]
        fields["bwd_two_walk_ms"] = graph_ms(
            lambda: _launch_train_bwd(*f32, mask, *ups, thr, needs,
                                      passes=0),
            COMPOSITE_GRAPH_ITERS)
        fields["bwd_incoming"] = ups_sets[-1][0]
    return fields


def check_composite_round(label, args, thr, timed=False):
    """One serving round (sigmas, rgbs, deltas, ts, mask, the rows' entries
    ``index`` and the frame's accumulators opacity, depth, rgb, on the
    card): composite_test_step_into (the kernel, in place on copies of the
    accumulators) and composite_test_step (the kernel, on the gathered
    accumulators) against composite_test_step_plain: opacity, depth and
    rgb within COMPOSITE_FWD_TOL x max, alive equal, on the rows clear of
    the threshold; the entries of other rows untouched; the kernel twice
    bit for bit. With ``timed``, composite_test_step's device time by
    CUDA-graph replay, the plain version's and the bound."""
    from mfnerf_tpu_torch.ops.composite import (composite_test_step,
                                                composite_test_step_into,
                                                composite_test_step_plain)
    sig, rgbs, dl, ts, mask, index, op, de, rgb = args
    n, s = sig.shape
    block = (sig, rgbs, dl, ts, mask)
    acc = (op[index], de[index], rgb[index])
    alive = torch.ones((n,), dtype=torch.bool, device=sig.device)
    frames, alives = [], []
    for _ in range(2):
        frame = [x.clone() for x in (op, de, rgb)]
        alives.append(composite_test_step_into(*block, index, *frame, thr))
        frames.append(frame)
    func = composite_test_step(*block, *acc, alive, thr)
    want = composite_test_step_plain(*block, *acc, alive, thr)
    torch.cuda.synchronize()
    ties = composite_tie_rows(sig, dl, mask, thr, 1.0 - acc[0])
    keep = ~ties
    others = torch.ones_like(op, dtype=torch.bool)
    others[index] = False
    got = [x[index] for x in frames[0]] + [alives[0]]
    err = {}
    for form, outs in (("into", got), ("functional", func)):
        for name, g, w in zip(("opacity", "depth", "rgb"), outs, want):
            e, scale = _rows_err(g, w, keep)
            err[f"{form}_{name}"] = e / scale if scale else e
    alive_differs = {form: int((outs[3] != want[3])[keep].sum())
                     for form, outs in (("into", got), ("functional", func))}
    t_start = 1.0 - acc[0]
    included = int(((_plain_transmittance(sig, dl, mask, t_start)[:, :-1]
                     > np.float32(thr)) & mask).sum())
    fields = dict(
        set=label, kernel="composite_test_step", rays=n, s=s,
        T_threshold=thr, included=included, tie_rows=int(ties.sum()),
        rel_err=err, tol=COMPOSITE_FWD_TOL, alive_differs=alive_differs,
        alive_after=int(want[3].sum()),
        others_untouched=all(torch.equal(f[others], x[others])
                             for f, x in zip(frames[0], (op, de, rgb))),
        bit_equal=_bits_equal(frames[0] + [alives[0]],
                              frames[1] + [alives[1]])
        and _bits_equal(got, func),
        max_abs_err=max(_rows_err(g, w, keep)[0]
                        for g, w in zip(got[:3], want)))
    check(max(err.values()) <= COMPOSITE_FWD_TOL
          and not any(alive_differs.values()),
          f"composite_test_step {label}: {err}, alive {alive_differs}")
    check(fields["others_untouched"], f"composite_test_step_into {label}: "
          f"wrote other rows' entries")
    check(fields["bit_equal"], f"composite_test_step {label}: launches or "
          f"forms differ")
    if timed:
        fields["ms"] = graph_ms(
            lambda: composite_test_step(*block, *acc, alive, thr),
            COMPOSITE_GRAPH_ITERS)
        fields["plain_ms"] = cuda_ms(
            lambda: composite_test_step_plain(*block, *acc, alive, thr), 5)
        fields["bound_ms"], fields["bound_by"] = composite_round_bound(
            args, included)
        fields["share_of_bound"] = fields["bound_ms"] / fields["ms"]
    return fields


def check_round_count(label, args, thr, capacity=None, timed=False):
    """The compositing round with an alive count
    (composite_test_step_into's ``count``) on a serving round's operands
    (check_composite_round's ``args``): with ``capacity``, the block padded
    to it with masked rows (entries of row 0) as a serving round's tier
    holds it, the count the set's rows; else the count cutting a quarter
    of the rows. The kernel with the count, in place on copies of the
    accumulators, bit for bit the kernel on the rows before the count
    alone (the accumulators whole, alive), the rows past it not alive;
    against composite_test_step_plain with the count within
    COMPOSITE_FWD_TOL x max on the rows clear of the threshold, the
    entries that no row before it owns unchanged. With ``timed``, its
    device time by CUDA-graph replay, each replay first restoring the
    accumulators (that restore's time taken off), against the bound of
    the rows before the count."""
    from mfnerf_tpu_torch.ops.composite import (composite_test_step_into,
                                                composite_test_step_plain)
    sig, rgbs, dl, ts, mask, index, op, de, rgb = args
    n, s = sig.shape
    if capacity is None:
        k = n - n // 4
    else:
        k, pad = n, capacity - n
        sig, rgbs, dl, ts = (torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
                             for x in (sig, rgbs, dl, ts))
        mask = torch.cat([mask, mask.new_zeros((pad, s))])
        index = torch.cat([index, index[:1].expand(pad)])
        n = capacity
    block = (sig, rgbs, dl, ts, mask)
    count = torch.tensor([k], device=sig.device)
    frame = [x.clone() for x in (op, de, rgb)]
    alive = composite_test_step_into(*block, index, *frame, thr, count=count)
    sliced = [x.clone() for x in (op, de, rgb)]
    alive_k = composite_test_step_into(*(x[:k] for x in block), index[:k],
                                       *sliced, thr)
    acc = (op[index], de[index], rgb[index])
    want = composite_test_step_plain(
        *block, *acc, torch.ones((n,), dtype=torch.bool, device=sig.device),
        thr, count=count)
    torch.cuda.synchronize()
    keep = ~composite_tie_rows(sig, dl, mask, thr, 1.0 - acc[0])
    got = [x[index] for x in frame]
    others = torch.ones_like(op, dtype=torch.bool)
    others[index[:k]] = False
    err = {}
    for name, g, w in zip(("opacity", "depth", "rgb"), got, want):
        e, scale = _rows_err(g[:k], w[:k], keep[:k])
        err[name] = e / scale if scale else e
    fields = dict(
        set=label, kernel="composite_test_step", count=k, rows=n, s=s,
        bit_equal_sliced=_bits_equal(frame, sliced)
        and torch.equal(alive[:k], alive_k) and not bool(alive[k:].any()),
        rel_err=err, tol=COMPOSITE_FWD_TOL,
        alive_differs=int((alive != want[3])[keep].sum()),
        past_unchanged=all(torch.equal(f[others], x[others])
                           for f, x in zip(frame, (op, de, rgb))),
        max_abs_err=max(_rows_err(g[:k], w[:k], keep[:k])[0]
                        for g, w in zip(got, want)))
    check(fields["bit_equal_sliced"] and fields["past_unchanged"],
          f"composite_test_step {label} with a count: differs from the "
          f"rows before it alone, or wrote the rows past it")
    check(max(err.values()) <= COMPOSITE_FWD_TOL
          and not fields["alive_differs"],
          f"composite_test_step {label} with a count: {err}, alive "
          f"{fields['alive_differs']}")
    if timed:
        saved = [x.clone() for x in (op, de, rgb)]

        def restore():
            for x, y in zip(frame, saved):
                x.copy_(y)

        def run():
            restore()
            composite_test_step_into(*block, index, *frame, thr, count=count)

        fields["ms"] = graph_ms(run, COMPOSITE_GRAPH_ITERS) \
            - graph_ms(restore, COMPOSITE_GRAPH_ITERS)
        t_start = 1.0 - acc[0][:k]
        included = int(((_plain_transmittance(sig[:k], dl[:k], mask[:k],
                                              t_start)[:, :-1]
                         > np.float32(thr)) & mask[:k]).sum())
        fields["bound_ms"], fields["bound_by"] = composite_round_bound(
            tuple(x[:k] for x in block), included)
        fields["share_of_bound"] = fields["bound_ms"] / fields["ms"]
    return fields


def composite_phase(label, train_sets, round_sets=(), timed_train=0):
    """The composite checks of a configuration: every training block
    (label, args, T_threshold, loss gradients or None) and every serving
    round (args, T_threshold) against the plain versions; the training
    block at ``timed_train`` and the first (largest) round timed. Prints a
    phase line a training block and one for the rounds; returns the timed
    sets' fields and the worst errors {"fwd", "bwd", "round"}."""
    timed, err = {}, {"fwd": 0.0, "bwd": 0.0, "round": 0.0}
    for i, (name, args, thr, grads) in enumerate(train_sets):
        fields = check_composite_train(name, args, thr, grads,
                                       timed=i == timed_train)
        phase("composite", config=label, **fields)
        err["fwd"] = max(err["fwd"], fields["max_abs_err"])
        err["bwd"] = max(err["bwd"], fields["bwd_max_abs_err"])
        if i == timed_train:
            timed["train"] = fields
        torch.cuda.empty_cache()
    if round_sets:
        rounds = [check_composite_round(f"round_{i}", args, thr,
                                        timed=i == 0)
                  for i, (args, thr) in enumerate(round_sets)]
        # the first round with its alive count, as the tiered loop runs it
        args, thr = round_sets[0]
        timed["round_count"] = check_round_count(
            "round_0", args, thr, round_capacity(args[6].shape[0],
                                                 args[0].shape[0]),
            timed=True)
        phase("composite", config=label, **timed["round_count"])
        err["round"] = max(err["round"],
                           timed["round_count"]["max_abs_err"])
        timed["round"] = rounds[0]
        err["round"] = max([err["round"]]
                           + [r["max_abs_err"] for r in rounds])
        phase("composite", config=label, set="frame",
              kernel="composite_test_step", rounds=len(rounds),
              rays=[r["rays"] for r in rounds],
              s=sorted({r["s"] for r in rounds}),
              tie_rows=sum(r["tie_rows"] for r in rounds),
              alive_after=[r["alive_after"] for r in rounds],
              bit_equal=all(r["bit_equal"] for r in rounds),
              max_abs_err=err["round"], first_round=rounds[0])
        torch.cuda.empty_cache()
    return timed, err


def start_system(hp, datasets, dev):
    """A NeRFSystem of the hyperparameters ``hp`` on the (train, test)
    datasets, its field drawn from SEED."""
    from mfnerf_tpu_torch.train import NeRFSystem
    system = NeRFSystem(argparse.Namespace(**hp), device=dev)
    system.setup(*datasets)
    system.configure(SEED)
    return system


def culled_state(system, seed):
    """The untrained field's occupancy: culled to the training cameras, then
    one dense refresh with jitter drawn from ``seed``."""
    ds, cfg, dev = system.train_dataset, system.model_cfg, system.device
    occ = system.model.mark_invisible_cells(system.occ, ds.K, system.poses,
                                            ds.img_wh)
    return system.model.update_density_grid(
        occ, system.density_threshold,
        torch.rand((cfg.cascades, cfg.n_cells, 3),
                   generator=torch.Generator(device=dev).manual_seed(seed),
                   device=dev) * 2 - 1)


def oracle_batch(ds, seed):
    """N_ORACLE_RAYS training rays (CPU tensors) and their march jitter."""
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    pick = np.random.default_rng(seed)
    img = torch.from_numpy(pick.integers(0, len(ds.poses), N_ORACLE_RAYS))
    pix = torch.from_numpy(pick.integers(0, ds.rays.shape[1],
                                         N_ORACLE_RAYS))
    ro, rd = get_rays(torch.from_numpy(ds.directions)[pix],
                      torch.from_numpy(ds.poses)[img])
    return {"rays_o": ro, "rays_d": rd,
            "rgb": torch.from_numpy(ds.rays)[img, pix],
            "noise": torch.from_numpy(pick.random(N_ORACLE_RAYS,
                                                  dtype=np.float32))}


def held_out_view(system):
    """(rays, rgb, render config at T_threshold TEST_T) of the test view."""
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    dev, view = system.device, system.test_dataset[0]
    rays = get_rays(torch.from_numpy(system.train_dataset.directions).to(dev),
                    torch.from_numpy(view["pose"]).to(dev))
    return (rays, torch.from_numpy(view["rgb"]).to(dev),
            dataclasses.replace(system.rcfg, T_threshold=TEST_T))


def render_view(system, rays, rcfg, occ=None):
    """(render_test's output, synced host ms) of one view, with ``occ`` or
    the system's occupancy."""
    from mfnerf_tpu_torch.models.rendering import render_test
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render_test(system.model, system.occ if occ is None else occ,
                      *rays, rcfg)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def valid_only_frame(model, occ, rays_o, rays_d, rcfg):
    """The serving loop as it ran before the capacity buffers (the
    valid-only loop), built from the port's pieces: each round's alive
    rows found by nonzero, s_cap and the window from the alive count, the
    field on the valid samples only (rendering._eval_valid), the window
    march and the compositing round in place without a count. Returns
    dict(rgb, opacity, depth, total_samples, rounds)."""
    from mfnerf_tpu_torch.models import rendering as r
    from mfnerf_tpu_torch.ops.composite import composite_test_step_into
    from mfnerf_tpu_torch.ops.ray_march import march_rays_window_into
    cfg = model.cfg
    n, dev = rays_o.shape[0], rays_o.device
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    hits_t = r._scene_hits(model, rays_o, rays_d)
    t_start, t2 = hits_t[:, 0].contiguous(), hits_t[:, 1].contiguous()
    k_total = rcfg.n_rungs(cfg.scale, cfg.grid_size, test=True)
    dt_scale = rcfg._dt_scale(cfg.scale, True)
    skip = r.serving_skip(cfg, occ, rcfg)
    opacity = torch.zeros((n,), device=dev)
    depth = torch.zeros((n,), device=dev)
    rgb = torch.zeros((n, 3), device=dev)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    taken = torch.zeros((n,), dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.nonzero(t_start >= 0).squeeze(1)
    rounds = 0
    while alive.numel():
        n_alive = alive.numel()
        s_cap = max(min(n // n_alive, 64), 1)
        window = min(k_total, max(s_cap, r.MARCH_BUDGET // n_alive))
        mr = march_rays_window_into(
            rays_o, rays_d, t_start, t2, cursor, alive,
            occ.density_bitfield, cfg.cascades, cfg.scale,
            rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples, window,
            s_cap, dt_scale, skip=skip)
        taken_a = taken[alive]
        room = rcfg.max_samples - taken_a
        mask = mr.mask & (torch.arange(s_cap, device=dev)[None, :]
                          < room[:, None])
        sigmas, rgbs = r._eval_valid(model, mr.xyzs, rays_d[alive], mask)
        transparent = composite_test_step_into(
            sigmas, rgbs, mr.deltas, mr.ts, mask, alive, opacity, depth, rgb,
            rcfg.T_threshold)
        emitted = mask.sum(dim=1)
        taken_a = taken_a + emitted
        taken[alive] = taken_a
        total += emitted.sum()
        keep = transparent & ~mr.exhausted & (mr.cursor < k_total) \
            & (taken_a < rcfg.max_samples)
        alive = alive[torch.nonzero(keep).squeeze(1)]
        rounds += 1
    return {"rgb": r._with_background(rcfg, rgb, opacity),
            "opacity": opacity, "depth": depth,
            "total_samples": int(total), "rounds": rounds}


def frame_gap(got, ref, thr, far):
    """``got``'s rgb, opacity and depth against ``ref``'s, two frames of
    the same samples composited in other rounds (fp32 sums in another
    order). A ray apart by more than SERVE_AB_TOL must be a threshold tie:
    a sample whose transmittance lies at T_threshold to rounding, included
    by one frame and not the other. There the frame that left it out ends
    with its transmittance (1 - opacity) within SERVE_TIE_SHARE x
    T_threshold of T_threshold, and the frames differ by that sample's
    weight (below T_threshold; in depth, times at most ``far``). Returns
    dict(max_abs off the ties, ties, ties_max_abs, untied: rays over the
    tolerance that are no such tie)."""
    keys = ("rgb", "opacity", "depth")
    per = {k: (got[k] - ref[k]).abs().reshape(got[k].shape[0], -1)
           .amax(1) for k in keys}
    over = torch.stack([per[k] > SERVE_AB_TOL for k in keys]).any(0)
    t_max = torch.maximum(1.0 - got["opacity"], 1.0 - ref["opacity"])
    tie = over & ((t_max - thr).abs() <= SERVE_TIE_SHARE * thr) \
        & (per["opacity"] <= thr) & (per["rgb"] <= thr) \
        & (per["depth"] <= thr * far)

    def worst(rows):
        return {k: float(per[k][rows].max()) if bool(rows.any()) else 0.0
                for k in keys}

    return dict(max_abs=worst(~tie), ties=int(tie.sum()),
                ties_max_abs=worst(tie), untied=int((over & ~tie).sum()))


def _frames_bit_equal(a, b):
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               for k in ("rgb", "opacity", "depth")) \
        and a["total_samples"] == b["total_samples"] \
        and a["rounds"] == b["rounds"]


def serve_graphed(label, model, occ, rays, rcfg, gt=None,
                  turn_frames=SERVE_TURN_FRAMES):
    """Phase serve_graphed on a field: render_test's rounds on capacity
    buffers replayed as CUDA graphs (the main path, after a first frame
    that captures) against the same rounds run eagerly (graphs=False), bit
    for bit, and against the valid-only loop (valid_only_frame) within
    SERVE_AB_TOL max abs on rgb, opacity and depth but on threshold ties
    (frame_gap) and, with the view's ``gt``, its PSNR within
    SERVE_PSNR_TOL dB; a tier's replays bit for
    bit across two frames; the graphed frame served under
    torch.cuda.set_sync_debug_mode("error"), its host reads (render_test's
    count) at most two a round and one a frame and its launches one
    window march and one compositing round a round; in the eager frame
    the field's slots at most twice a round's valid samples or the floor;
    synced ms a frame, eager and graphed, in the turns eager, graphed,
    graphed, eager (``turn_frames`` frames a turn). Returns the
    fields."""
    from mfnerf_tpu_torch.models import rendering
    from mfnerf_tpu_torch.ops.composite import composite_test_step
    from mfnerf_tpu_torch.ops.ray_march import march_rays_window
    from mfnerf_tpu_torch.utils.metrics import psnr
    ro, rd = rays
    ref = valid_only_frame(model, occ, ro, rd, rcfg)
    field_tiers = []
    field = rendering._Rounds.field

    def recorded(self, slots):
        field_tiers.append((slots, int(self.f.valid)))
        return field(self, slots)

    rendering._Rounds.field = recorded
    try:
        eager = rendering.render_test(model, occ, ro, rd, rcfg, graphs=False)
    finally:
        rendering._Rounds.field = field
    floor = rendering._tiers(ro.shape[0], rendering.FIELD_FLOOR)[-1]
    over = [(f, v) for f, v in field_tiers if f > max(2 * v, floor)]
    rendering.render_test(model, occ, ro, rd, rcfg)       # captures
    march_rays_window.launches = composite_test_step.launches = 0
    reads = rendering.render_test.host_reads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphed = rendering.render_test(model, occ, ro, rd, rcfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reads = rendering.render_test.host_reads - reads
    launches = dict(window=march_rays_window.launches,
                    round=composite_test_step.launches)
    again = rendering.render_test(model, occ, ro, rd, rcfg)
    gap = frame_gap(graphed, ref, rcfg.T_threshold,
                    2 * math.sqrt(3) * model.cfg.scale + 1.0)

    def frame_ms(graphs):
        out = []
        for _ in range(turn_frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rendering.render_test(model, occ, ro, rd, rcfg, graphs=graphs)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    turns = [("eager", frame_ms(False)), ("graphed", frame_ms(True)),
             ("graphed", frame_ms(True)), ("eager", frame_ms(False))]
    ms = {kind: [m for k, t in turns if k == kind for m in t]
          for kind in ("eager", "graphed")}
    runner = rendering.serving_runner(model, ro.device)
    fields = dict(
        config=label, wh=int(math.isqrt(ro.shape[0])), rays=ro.shape[0],
        T_threshold=rcfg.T_threshold, rounds=graphed["rounds"],
        samples=graphed["total_samples"], valid_only_rounds=ref["rounds"],
        valid_only_samples=ref["total_samples"],
        graphed_bit_equal_eager=_frames_bit_equal(graphed, eager),
        replays_bit_equal=_frames_bit_equal(graphed, again),
        vs_valid_only=gap, tol=SERVE_AB_TOL, tie_share=SERVE_TIE_SHARE,
        bit_equal_valid_only={k: torch.equal(graphed[k], ref[k])
                              for k in ("rgb", "opacity", "depth")},
        host_reads=reads, host_reads_max=2 * graphed["rounds"] + 1,
        launches=launches, field_tiers=sorted({f for f, _ in field_tiers}),
        field_slots_per_valid=sum(f for f, _ in field_tiers)
        / max(sum(v for _, v in field_tiers), 1),
        field_over_twice_valid=over,
        graphs=len(runner.frames[ro.shape[0]].graphs),
        turns=[(k, float(np.median(t))) for k, t in turns],
        ms_eager=float(np.median(ms["eager"])),
        ms_graphed=float(np.median(ms["graphed"])))
    if gt is not None:
        fields["psnr"] = float(psnr(graphed["rgb"], gt))
        fields["psnr_valid_only"] = float(psnr(ref["rgb"], gt))
    check(fields["graphed_bit_equal_eager"] and fields["replays_bit_equal"],
          f"serve_graphed {label}: graphed frames differ from the eager "
          f"rounds or from each other")
    check(max(gap["max_abs"].values()) <= SERVE_AB_TOL
          and not gap["untied"], f"serve_graphed {label}: against the "
          f"valid-only loop {gap}")
    check(gt is None or abs(fields["psnr"] - fields["psnr_valid_only"])
          <= SERVE_PSNR_TOL, f"serve_graphed {label}: PSNR "
          f"{fields.get('psnr')} against {fields.get('psnr_valid_only')}")
    check(reads <= 2 * graphed["rounds"] + 1, f"serve_graphed {label}: "
          f"{reads} host reads in {graphed['rounds']} rounds")
    check(launches["window"] == launches["round"] == graphed["rounds"],
          f"serve_graphed {label}: launches {launches} in "
          f"{graphed['rounds']} rounds")
    check(not over, f"serve_graphed {label}: field tiers above twice the "
          f"valid samples {over}")
    return fields


@torch.no_grad()
def foreground_colour(system):
    """The first test view rendered (render_test at TEST_T): over the
    pixels whose true colour is not white, the rendered colour's mean and
    spread (standard deviation, averaged over the channels) beside the
    true spread. A head whose sigmoid saturated renders one colour."""
    rays, rgb, rcfg = held_out_view(system)
    out, _ = render_view(system, rays, rcfg)
    fg = (rgb < 0.99).any(1)
    return {"mean": out["rgb"][fg].mean(0).tolist(),
            "spread": float(out["rgb"][fg].std(0).mean()),
            "true_spread": float(rgb[fg].std(0).mean())}


def clone_occ(occ):
    """A copy of the occupancy state with tensors of its own, its derived
    grids as fresh as the original's."""
    copy = dataclasses.replace(occ, **{
        name: getattr(occ, name).clone() for name in OCC_TENSORS
        if getattr(occ, name) is not None})
    copy.derived_from = (copy.density_bitfield if occ.derived_from
                         is occ.density_bitfield else None)
    return copy


def train_steps(system, read_launches):
    """WARM_STEPS steps of ``system.fit``, then N_CHUNKS chunks of CHUNK
    steps timed on the host clock (those wholly past FLAT_AFTER, which the
    fused runner replays, reported apart); ``read_launches()`` (the kernels'
    launch counts) just after them; then four half refreshes of the trained
    field, timed, after which the state from before them is set back as a
    copy (``system.occ`` replaced: the fused runner copies it into the
    tensors its graphs read). Returns the train phase's fields."""
    from mfnerf_tpu_torch.train import FLAT_AFTER
    hp = system.hparams
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [system.fit(WARM_STEPS)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    chunk_ms = []
    for _ in range(N_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(system.fit(CHUNK))
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / CHUNK)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    m = {key: torch.cat([c[key] for c in metrics]) for key in metrics[0]}
    check(bool(torch.isfinite(m["loss"]).all()), "a training loss is not "
          "finite")
    occ_after = clone_occ(system.occ)  # the refreshes write in place
    refresh_ms = []
    for _ in range(4):                 # the trained field's half refreshes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.update_grid()
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
    system.occ = occ_after
    ms_step = float(np.median(chunk_ms))
    flat = [ms for i, ms in enumerate(chunk_ms)
            if WARM_STEPS + i * CHUNK >= FLAT_AFTER]
    early = chunk_ms[:len(chunk_ms) - len(flat)]
    runner = system.fused
    return dict(
        grid=hp.grid, steps=system.global_step, batch=hp.batch_size,
        s_flat=system.rcfg.s_flat, pool_a=system.model_cfg.pool_a,
        ms_per_step=ms_step, chunk_ms_per_step=chunk_ms,
        flat_chunk_ms_per_step=flat,
        flat_ms_per_step=float(np.median(flat)) if flat else None,
        early_chunk_ms_per_step=early,
        fused_step_graph=None if runner is None or runner.step_graph is None
        else runner.kind,
        warm_seconds=warm_s, rays_per_s=hp.batch_size / ms_step * 1e3,
        rm_s=float(m["rm_s"][-CHUNK:].mean()),
        vr_s=float(m["vr_s"][-CHUNK:].mean()),
        rm_s_first=float(m["rm_s"][0]),
        train_psnr=float(m["psnr"][-50:].mean()),
        train_psnr_last_step=float(m["psnr"][-1]),
        loss_last=float(m["loss"][-1]), refresh_ms=refresh_ms,
        **launches, max_memory_gb=peak_gb)


def state_tensors(system):
    """What a training step changes, by name: the system's own parameter
    (with ``--optimize_ext``'s ``dR`` and ``dT``), Adam state and occupancy
    tensors (those the fused runner's graphs read)."""
    out = {}
    named = [(f"param/{name}", f"adam/{name}", p)
             for name, p in system.model.named_parameters()]
    named += [(f"ext/{name}", f"adam/ext/{name}", p)
              for name, p in system.ext.items()]
    for key, adam, p in named:
        out[key] = p
        out.update({f"{adam}/{k}": v
                    for k, v in system.optimizer.state[p].items()})
    out.update({f"occ/{name}": getattr(system.occ, name)
                for name in OCC_TENSORS
                if getattr(system.occ, name) is not None})
    return out


def train_state(system):
    """Copies of :func:`state_tensors`, the generator's state and the step
    and refresh counters."""
    return dict(tensors={k: v.detach().clone()
                         for k, v in state_tensors(system).items()},
                gen=system.generator.get_state(), step=system.global_step,
                n_refresh=system.n_refresh)


def load_train_state(system, state):
    """:func:`train_state`'s copies written back into the system's own
    tensors."""
    live = state_tensors(system)
    with torch.no_grad():
        for name, t in state["tensors"].items():
            live[name].copy_(t)
    system.occ.stage_a_share = None
    system.generator.set_state(state["gen"])
    system.n_refresh = state["n_refresh"]
    system.set_step(state["step"])


def eager_fit(system, n):
    """``system.fit(n)`` with every step run eagerly (the rule of the fused
    runner answering no)."""
    system.fused_ok = lambda: False
    try:
        return system.fit(n)
    finally:
        del system.fused_ok


def device_profile(fn, steps):
    """``fn()`` (``steps`` training steps) under torch.profiler: ms a step
    on the host clock (synced), the device's busy ms a step (the kernels'
    and copies' summed durations), its idle share of the window, and the
    device activities a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return dict(ms_per_step=span_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1 - busy_ms / span_ms if events else None,
                device_activities_per_step=len(events) / steps)


def check_count_kernels(label, system, module, seed):
    """The encoder kernels' valid count on one real step's operands of the
    trained ``system`` (``module``: hatmul or hashgrid): with a count inside
    the buffer, the forward's rows before it bit for bit the kernel's
    without a count and the rest zero; the backward's dW or d_params bit
    for bit the kernel's without a count on the cotangent with the rows
    past the count zeroed, du or d_x likewise before it and zero after."""
    captured = capture_bwd_operands(system, seed, module)
    dev = system.device
    if module.__name__.endswith("hatmul"):
        u3, w3, k, g, _ = captured[0]
        n = u3.shape[0]
        count = torch.tensor([n // 2 + 13], device=dev)
        c = int(count)
        fwd = [module._launch(u3, w3, k, count=cnt) for cnt in (count, None)]
        g0 = g.clone()
        g0[c:] = 0.0
        bwd = [module._launch_bwd(u3, w3, k, gg, True, count=cnt)
               for gg, cnt in ((g, count), (g0, None))]
        (du_c, dw_c), (du_0, dw_0) = bwd
        grads_equal = torch.equal(dw_c, dw_0)
    else:
        params, x, cfg, g, window, noise, _ = captured[0]
        n = x.shape[0]
        count = torch.tensor([n // 2 + 13], device=dev)
        c = int(count)
        fwd = [module._launch_fwd(params, x, cfg, window, count=cnt)
               for cnt in (count, None)]
        g0 = g.clone()
        g0[c:] = 0.0
        bwd = [module._launch_bwd(params, x, cfg, gg, window, noise, True,
                                  count=cnt)
               for gg, cnt in ((g, count), (g0, None))]
        (dw_c, du_c, _), (dw_0, du_0, _) = bwd
        grads_equal = torch.equal(dw_c, dw_0)
    torch.cuda.synchronize()
    fields = dict(
        encoder=label, rows=n, count=c,
        fwd_rows_equal=torch.equal(fwd[0][:c], fwd[1][:c]),
        fwd_rest_zero=not fwd[0][c:].any().item(),
        table_grad_equal=grads_equal,
        point_grad_rows_equal=torch.equal(du_c[:c], du_0[:c]),
        point_grad_rest_zero=not du_c[c:].any().item())
    check(all(v for key, v in fields.items()
              if key not in ("encoder", "rows", "count")),
          f"{label}: the valid count: {fields}")
    return fields


def fused_phase(label, system, module, seed):
    """Phases 38-40: the fused runner on ``system``, trained past
    FLAT_AFTER through ``fit`` (so with its graphs captured: the flat
    step's on a single-cascade scene, the padded step's on a multi-cascade
    one).

    From one state FUSED_STEPS steps run eagerly, then the state is set
    back and the same steps run through the graphs: parameters, Adam
    state, occupancy and every step's metrics must be equal bit for bit.
    Then a refresh and a static step run under
    ``torch.cuda.set_sync_debug_mode("error")``; chunks of FUSED_CHUNK
    synced steps are timed eager (P) and graphed (T) in the turns
    FUSED_TURNS, each kind's median reported; FUSED_PROFILE steps of each
    kind run under the profiler (device busy, idle share, device
    activities a step); and the encoder kernels' valid count is checked on
    a step's operands (:func:`check_count_kernels`)."""
    from mfnerf_tpu_torch.train import FLAT_AFTER, UPDATE_INTERVAL
    runner = system.fused
    check(system.global_step >= FLAT_AFTER and runner is not None
          and runner.step_graph is not None,
          f"{label}: fit did not capture the step past FLAT_AFTER")
    step_launches = {f.__name__: n for f, n
                     in runner.launches[runner.step_graph].items()}
    start = train_state(system)
    runs = {}
    for kind, fit in (("eager", eager_fit), ("graphed",
                                             lambda s, n: s.fit(n))):
        load_train_state(system, start)
        metrics = fit(system, FUSED_STEPS)
        runs[kind] = dict(train_state(system)["tensors"], **{
            f"metric/{k}": v for k, v in metrics.items()})
    differ = [name for name, t in runs["eager"].items()
              if not _bits_equal([t], [runs["graphed"][name]])]

    # a refresh and a static step with host syncs made errors
    system.fit((-system.global_step) % UPDATE_INTERVAL)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        system.update_grid()
        system._device_step()
        sync_free = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    system._next_lr()
    system.global_step += 1

    times = {"P": [], "T": []}
    for kind in FUSED_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (eager_fit if kind == "P" else lambda s, n: s.fit(n))(
            system, FUSED_CHUNK)
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3 / FUSED_CHUNK)
    graphed = device_profile(lambda: system.fit(FUSED_PROFILE),
                             FUSED_PROFILE)
    eager = device_profile(lambda: eager_fit(system, FUSED_PROFILE),
                           FUSED_PROFILE)
    count = check_count_kernels(label, system, module, seed)
    fields = dict(
        config=label, step_kind=runner.kind, steps_compared=FUSED_STEPS,
        from_step=start["step"], bitwise_equal=not differ,
        differing=differ[:12], sync_debug_error_mode_ok=sync_free,
        warmup_steps=runner.warm,
        refresh_graphs=sorted(str(k) for k in runner.refresh_graphs),
        step_graph_launches=step_launches,
        eager_ms_per_step=times["P"], graphed_ms_per_step=times["T"],
        eager_ms_median=float(np.median(times["P"])),
        graphed_ms_median=float(np.median(times["T"])),
        speedup=float(np.median(times["P"]) / np.median(times["T"])),
        graphed_profile=graphed, eager_profile=eager, count=count)
    check(not differ, f"{label}: replayed steps differ from eager ones in "
          f"{differ[:12]}")
    return fields


def fused_log(log, served="CUDA graphs"):
    """The fused runner's line that ``fit`` printed in ``log`` (its rule's
    decision), checked to hold ``served`` (default: the steps served with
    CUDA graphs)."""
    line = re.findall(r"^fused runner: .*$", log, re.M)
    check(len(line) == 1 and served in line[0],
          f"the fused runner's log: {line}, not {served!r}")
    return line[0]


def fused_from_zero(label, hp, datasets, dev):
    """Phase 41: two systems of ``hp`` drawn alike from SEED, each trained
    FUSED_STEPS steps from step 0, one eagerly and one through the fused
    runner (the padded step's warm-up, capture and replays, the refresh
    graphs of both parities): parameters, Adam state, occupancy and every
    step's metrics equal bit for bit. Returns the fields."""
    runs, kinds = {}, {}
    for kind, fit in (("eager", eager_fit), ("graphed",
                                             lambda s, n: s.fit(n))):
        system = start_system(hp, datasets, dev)
        metrics = fit(system, FUSED_STEPS)
        runs[kind] = dict(train_state(system)["tensors"], **{
            f"metric/{k}": v for k, v in metrics.items()})
        runner = system.fused
        kinds[kind] = None if runner is None or runner.step_graph is None \
            else runner.kind
        del system
    differ = [name for name, t in runs["eager"].items()
              if not _bits_equal([t], [runs["graphed"][name]])]
    check(kinds == {"eager": None, "graphed": "padded"},
          f"{label}: the step graphs from step 0: {kinds}")
    check(not differ, f"{label}: replayed steps from step 0 differ from "
          f"eager ones in {differ[:12]}")
    return dict(config=label, steps_compared=FUSED_STEPS, from_step=0,
                step_kind=kinds["graphed"], bitwise_equal=not differ,
                tensors_compared=len(runs["eager"]))


def val_ms(log):
    """The per-view render times that ``validate`` printed in ``log``."""
    return [float(ms) for ms in re.findall(r"^val image .*\[([0-9.]+) ms\]$",
                                           log, re.M)]


def cli_phase(dev, read_launches, offline=None):
    """The command line, in process and then as a subprocess, on the 800x800
    procedural scene (N_TRAIN_VIEWS train and CLI_TEST_VIEWS test views)
    written in the NSVF layout under a temporary directory, which is also
    the working directory of both runs; then ``offline(argv, ckpt,
    val_only_psnr)`` there. Returns the phase's fields and what
    ``offline`` returned."""
    from mfnerf_tpu_torch.datasets.nsvf import NSVFDataset
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.train import main as train_main
    from mfnerf_tpu_torch.utils.procedural import make_scene, write_nsvf_scene

    repo = os.path.dirname(os.path.abspath(__file__))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join("Synthetic_NeRF_proc", "Spheres")
        argv = ["--root_dir", root, *CLI_ARGS]
        hp = get_opts(argv)
        scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=CLI_TEST_VIEWS,
                           wh=WH, seed=SEED)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            write_nsvf_scene(root, scene)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = NSVFDataset(root, split=hp.split,
                                 downsample=hp.downsample)
            load_s = time.perf_counter() - t0
            load_err = float(np.abs(loaded.rays - scene["images"]).max())
            check(loaded.rays.shape == scene["images"].shape
                  and load_err <= CLI_LOAD_TOL,
                  f"loaded rays {loaded.rays.shape}: max error {load_err}")
            del loaded
            log = io.StringIO()
            read_launches(reset=True)
            with contextlib.redirect_stdout(log):
                metrics = train_main(hp, device=dev)
            launches = read_launches()
            print(log.getvalue(), end="", flush=True)
            ckpt_dir = os.path.join("ckpts", "nsvf", "cli")
            ckpt = os.path.join(ckpt_dir, "epoch=0.ckpt.npz")
            sizes = {name: os.path.getsize(os.path.join(ckpt_dir, name))
                     for name in ("epoch=0.ckpt.npz",
                                  "epoch=0_slim.ckpt.npz")}
            results = sorted(os.listdir(os.path.join("results", "nsvf",
                                                     "cli")))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [repo, os.environ.get("PYTHONPATH", "")]))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "mfnerf_tpu_torch.train", *argv,
                 "--val_only", "--ckpt_path", ckpt, "--no_save_test"],
                env=env, capture_output=True, text=True, timeout=300)
            val_only_s = time.perf_counter() - t0
            print(proc.stdout, end="", flush=True)
            check(proc.returncode == 0, f"--val_only exited "
                  f"{proc.returncode}: {proc.stderr[-2000:]}")
            val_psnr = float(re.search(r"^test/psnr: ([0-9.]+)$",
                                       proc.stdout, re.M).group(1))
            after = offline(argv, ckpt, val_psnr) if offline else None
        finally:
            os.chdir(cwd)
    return dict(
        write_seconds=write_s,
        load_seconds=load_s, load_max_abs_err=load_err,
        load_tol=CLI_LOAD_TOL, argv=argv, ms_per_step=metrics[
            "train/ms_per_step"], test_psnr=metrics["test/psnr"],
        test_ssim=metrics["test/ssim"], psnr_min=PSNR_MIN,
        val_ms_per_frame=val_ms(log.getvalue()),
        steps=hp.num_epochs * hp.steps_per_epoch, **launches,
        ckpt_bytes=sizes, results=results, val_only_psnr=val_psnr,
        val_only_ms_per_frame=val_ms(proc.stdout),
        val_only_seconds=val_only_s, psnr_tol=CLI_PSNR_TOL), after


def dp_runs(hp, datasets, device, cuts=None):
    """Phase 30's two runs of ``hp``, each from the seeded untrained field
    (:func:`start_system`): DP_TWO_STEPS of ``fit`` from step 0 (three
    refreshes), its first step's gradients (as the optimiser takes them:
    averaged over the ranks) and its state at each of DP_CHECKPOINTS (the
    large hash table only at the first and the last), and
    DP_TWO_LATE_STEPS from step
    DP_LATE (set_step: the flat budget) after the cull and one refresh, as
    step 0 starts, so that its first steps march the untrained field's
    many samples a ray. With ``cuts`` (a list) every flat-budget prefix of
    the late run is recorded in it: (samples of the ranks before this one,
    every rank's). Returns {"early", "late": (system, metrics, ms/step,
    [(step, state)], first step's gradients or None)}."""
    from mfnerf_tpu_torch.parallel import dist as pdist
    out = {}
    prefix = pdist.Shard.prefix
    for label, start, stops in (("early", 0, DP_CHECKPOINTS),
                                ("late", DP_LATE, (DP_TWO_LATE_STEPS,))):
        system = start_system(hp, datasets, device)
        if start:
            system.set_step(start)
            system.fit(0)              # the cull
            system.update_grid()       # step 0's refresh
            if cuts is not None:
                def recorded(shard, count):
                    before, total = prefix(shard, count)
                    if torch.is_tensor(count):   # the flat budget's
                        cuts.append((int(before), int(total)))
                    return before, total
                pdist.Shard.prefix = recorded
        metrics, states, seconds, done = [], [], 0.0, 0
        grads = {}

        def first_grads(optimizer, args, kwargs):
            if not grads:
                grads.update({name: p.grad.detach().cpu().numpy() for name, p
                              in system.model.named_parameters()})

        hook = system.optimizer.register_step_pre_hook(first_grads)
        try:
            for stop in stops:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics.append(system.fit(stop - done))
                torch.cuda.synchronize()
                seconds += time.perf_counter() - t0
                done = stop
                state = state_of(system)
                if stop not in (stops[0], stops[-1]):
                    state = {k: v for k, v in state.items()
                             if k not in DP_LARGE}
                states.append((stop, state))
        finally:
            pdist.Shard.prefix = prefix
            hook.remove()
        out[label] = (system, {k: torch.cat([m[k] for m in metrics]).numpy()
                               for k in metrics[0]},
                      seconds * 1e3 / done, states,
                      grads if label == "early" else None)
    return out


def state_of(system):
    """The field's parameters and buffers and the occupancy bitfield, as
    CPU numpy arrays."""
    out = {k: v.detach().cpu().numpy()
           for k, v in system.model.state_dict().items()}
    out["density_bitfield"] = system.occ.density_bitfield.cpu().numpy()
    return out


def digest(state):
    """One sha256 of every array of ``state`` in key order."""
    import hashlib
    h = hashlib.sha256()
    for key in sorted(state):
        h.update(key.encode())
        h.update(np.ascontiguousarray(state[key]).tobytes())
    return h.hexdigest()


def dp_rank(rank, device, recipes):
    """A rank of phases 30-31 (``parallel.dist.spawn``, two ranks on one
    card through gloo): for each (label, hyperparameters) of ``recipes``
    the train scene, then :func:`dp_runs` on this rank's shards, each
    run's state's digest (rank 0: the state), the late run's flat cuts;
    for LowRank also phase 31, render_test_sharded of the held-out view
    against render_test (rank 0) on the early run's field."""
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.device import no_tf32
    from mfnerf_tpu_torch.models.rendering import (render_test,
                                                   render_test_sharded)
    from mfnerf_tpu_torch.utils.procedural import make_scene
    no_tf32()
    scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=1, wh=WH, seed=SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    out = {}
    for label, hp in recipes:
        cuts = []
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            runs = dp_runs(hp, datasets, device, cuts)
        print(log.getvalue(), end="", flush=True)
        system = runs["late"][0]
        run = dict(cuts=cuts, shard=(system.shard.lo, system.shard.hi),
                   s_flat=system.rcfg.s_flat, n_global=system.shard.n_global,
                   fused_runner=re.findall(r"^fused runner: .*$",
                                           log.getvalue(), re.M))
        for when, (sys_, metrics, ms, states, grads) in runs.items():
            run[when] = dict(metrics=metrics, ms_per_step=ms,
                             digests=[digest(st) for _, st in states])
            if rank == 0:
                run[when].update(states=states, grads=grads)
        system = runs["early"][0]
        del runs
        if label == "LowRank":
            rays, _, rcfg = held_out_view(system)
            render_test_sharded(system.model, system.occ, *rays, rcfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            split = render_test_sharded(system.model, system.occ, *rays, rcfg)
            torch.cuda.synchronize()
            run["sharded_ms"] = (time.perf_counter() - t0) * 1e3
            run["sharded_samples"] = split["total_samples"]
            if rank == 0:
                whole, whole_ms = render_view(system, rays, rcfg)
                run["whole_ms"] = whole_ms
                run["whole_samples"] = whole["total_samples"]
                run["render_err"] = {key: float(
                    (split[key] - whole[key]).abs().max())
                    for key in ("rgb", "opacity", "depth")}
                run["render_finite"] = bool(torch.isfinite(
                    split["rgb"]).all())
        out[label] = run
        del system
        torch.cuda.empty_cache()
    return out


def dp_one(datasets, dev):
    """Phase 29: DP_HP through the distributed path at W = 1 (a process
    group of one rank on NCCL): DP_STEPS from step 0 and DP_STEPS from
    DP_LATE, against the same steps without a group, both through the
    fused runner (each fit's line must say CUDA graphs; the group's, on
    NCCL). Parameters, bitfield and metrics must be equal bit for bit (an
    all-reduce of one rank, divided by 1). Then chunks of FUSED_CHUNK
    graphed steps of the system without a group, timed, and
    :func:`fused_group` on the group's system. Returns the phase's
    fields."""
    from mfnerf_tpu_torch.parallel import dist as pdist
    runs = {}
    for label in ("plain", "dp"):
        if label == "dp":
            pdist.init(0, 1, dev, "nccl",
                       f"tcp://127.0.0.1:{pdist.free_port()}")
        try:
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                system = start_system(DP_HP, datasets, dev)
                check((system.shard is not None) == (label == "dp"),
                      f"{label}: shard {system.shard}")
                metrics, ms = [], []
                for start in (0, DP_LATE):
                    if start:
                        system.set_step(start)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    metrics.append(system.fit(DP_STEPS))
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3 / DP_STEPS)
            print(log.getvalue(), end="", flush=True)
            line = fused_log(log.getvalue(), "CUDA graphs" if label == "plain"
                             else "in an NCCL process group of 1 rank")
            state = state_of(system)
            state.update({f"metric_{k}": torch.cat([m[k] for m in metrics]
                                                   ).numpy()
                          for k in metrics[0]})
            runs[label] = dict(digest=digest(state), ms=ms, fused_runner=line,
                               backend=(torch.distributed.get_backend()
                                        if label == "dp" else None))
            if label == "dp":
                runs["group"] = fused_group(system)
            else:      # the same graphed steps' time without a group
                runs["plain_graphed"] = []
                for _ in range(FUSED_TURNS.count("T")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    system.fit(FUSED_CHUNK)
                    torch.cuda.synchronize()
                    runs["plain_graphed"].append(
                        (time.perf_counter() - t0) * 1e3 / FUSED_CHUNK)
            del system
            torch.cuda.empty_cache()
        finally:
            if label == "dp":
                torch.distributed.destroy_process_group()
    plain, dp = runs["plain"], runs["dp"]
    equal = plain["digest"] == dp["digest"]
    fields = dict(
        config="bench.py:115-139 (DP_HP: BENCH_HP, --s_flat 8, --pool_a 4)",
        world=1, backend=dp["backend"], steps=[DP_STEPS, DP_STEPS],
        starts=[0, DP_LATE], bitwise_equal=equal,
        plain_ms_per_step=plain["ms"], dp_ms_per_step=dp["ms"],
        ms_ratio_dp_to_plain_late=dp["ms"][1] / plain["ms"][1],
        fused_runner={"plain": plain["fused_runner"],
                      "dp": dp["fused_runner"]},
        plain_graphed_ms_per_step=runs["plain_graphed"],
        plain_graphed_ms_median=float(np.median(runs["plain_graphed"])),
        group=runs["group"])
    return fields


def fused_group(system):
    """Phase 29's fused runner inside the one-rank NCCL group, on the
    group's ``system`` (trained past FLAT_AFTER, the flat step captured
    with its collectives): FUSED_STEPS run eagerly and then through the
    graphs from one state, bit for bit (:func:`state_tensors` and every
    step's metrics); the step captured anew with host syncs made errors
    (``set_sync_debug_mode("error")`` inside the capture: the flat
    budget's prefix, the gradients' all-reduce with the set the warm-up
    steps found, the metrics' sums) and replayed; chunks of FUSED_CHUNK
    synced steps eager (P) and graphed (T) in the turns FUSED_TURNS, and
    FUSED_PROFILE steps of each under the profiler. Returns the fields."""
    from mfnerf_tpu_torch.train import FLAT_AFTER, FUSED_WARMUP
    runner = system.fused
    check(system.global_step >= FLAT_AFTER and runner is not None
          and runner.step_graph is not None,
          "dp_one: fit did not capture the group's step past FLAT_AFTER")
    step_launches = {f.__name__: n for f, n
                     in runner.launches[runner.step_graph].items()}
    start = train_state(system)
    runs = {}
    for kind, fit in (("eager", eager_fit), ("graphed",
                                             lambda s, n: s.fit(n))):
        load_train_state(system, start)
        metrics = fit(system, FUSED_STEPS)
        runs[kind] = dict(train_state(system)["tensors"], **{
            f"metric/{k}": v for k, v in metrics.items()})
    differ = [name for name, t in runs["eager"].items()
              if not _bits_equal([t], [runs["graphed"][name]])]

    step = system._device_step

    def strict_step():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    runner._drop_step()
    runner.warm = FUSED_WARMUP        # the kind's warm-up steps ran above
    system._device_step = strict_step
    try:
        runner.bind()
        runner.step()                 # captures the step and replays it
        torch.cuda.synchronize()
        sync_free = runner.step_graph is not None
    finally:
        del system._device_step
    system._next_lr()
    system.global_step += 1

    times = {"P": [], "T": []}
    for kind in FUSED_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (eager_fit if kind == "P" else lambda s, n: s.fit(n))(
            system, FUSED_CHUNK)
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3 / FUSED_CHUNK)
    graphed = device_profile(lambda: system.fit(FUSED_PROFILE),
                             FUSED_PROFILE)
    eager = device_profile(lambda: eager_fit(system, FUSED_PROFILE),
                           FUSED_PROFILE)
    check(not differ, f"dp_one: the group's replayed steps differ from its "
          f"eager ones in {differ[:12]}")
    return dict(
        step_kind=runner.kind, steps_compared=FUSED_STEPS,
        from_step=start["step"], bitwise_equal=not differ,
        differing=differ[:12], tensors_compared=len(runs["eager"]),
        sync_debug_error_mode_capture_ok=sync_free,
        step_graph_launches=step_launches,
        eager_ms_per_step=times["P"], graphed_ms_per_step=times["T"],
        eager_ms_median=float(np.median(times["P"])),
        graphed_ms_median=float(np.median(times["T"])),
        speedup=float(np.median(times["P"]) / np.median(times["T"])),
        graphed_profile=graphed, eager_profile=eager)


def dp_two(datasets, dev):
    """Phases 30-31: DP_HP and DP_MF_HP on two ranks sharing the card
    (DP_DEVICES, gloo) against one rank without a group (this process),
    the same runs (:func:`dp_runs`). Gated: the early run's first step
    (its gradients within DP_GRAD_TOL, its loss within DP_LOSS_TOL), the
    late run (16 steps, the flat cut inside rank 0) by
    tests/test_multichip.py's rule (the loss within DP_LOSS_TOL, each
    parameter's elements), the ranks bitwise equal to each other at every
    checkpoint, the late steps on which the flat cut fell inside rank 0;
    reported: the early run's distance to one rank at each checkpoint.
    The ranks' fit must print the fused runner's gloo refusal
    (DP_GLOO_OFF). Then render_test_sharded against render_test on the
    early run's field. Returns ({label: fields}, the render's fields, what
    failed)."""
    from mfnerf_tpu_torch.parallel import dist as pdist
    recipes = [("LowRank", DP_HP), ("MixedFeature", DP_MF_HP)]
    t0 = time.perf_counter()
    ranks = pdist.spawn(dp_rank, list(DP_DEVICES), (recipes,),
                        timeout=DP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    out, failed = {}, []
    for label, hp in recipes:
        runs = dp_runs(hp, datasets, dev)
        r0, r1 = ranks[0][label], ranks[1][label]
        fields = dict(
            config=("DP_HP (bench.py:115-139 with --s_flat 8 --pool_a 4)"
                    if label == "LowRank" else
                    "DP_MF_HP (benchmark_synthetic_nerf_mf.sh:15-17, "
                    "--hash_grad_samples 1)"),
            world=2, devices=list(DP_DEVICES), backend="gloo",
            shards=[r0["shard"], r1["shard"]], spawn_seconds=spawn_s,
            fused_runner=r0["fused_runner"])
        if not (r0["fused_runner"] and all(
                DP_GLOO_OFF in line for line in r0["fused_runner"])):
            failed.append(f"{label}: the gloo ranks' runner lines "
                          f"{r0['fused_runner']}")
        for when, (system, metrics, ms, states, grads) in runs.items():
            two_run = r0[when]
            rows = []
            grad_rel = {}
            if grads is not None:     # the first step's, one rank and two
                grad_rel = {name: float(np.linalg.norm(
                    two_run["grads"][name] - g) / max(np.linalg.norm(g),
                                                      1e-30))
                    for name, g in grads.items()}
                failed += [f"{label} first step: {name}'s gradient off by "
                           f"{err} (relative L2)"
                           for name, err in grad_rel.items()
                           if not err <= DP_GRAD_TOL]
            for i, (stop, one) in enumerate(states):
                two = two_run["states"][i][1]
                loss_one = float(metrics["loss"][stop - 1])
                loss_two = float(two_run["metrics"]["loss"][stop - 1])
                worst = {}
                for key, want in one.items():
                    if key == "density_bitfield":
                        continue
                    err = np.abs(two[key] - want)
                    worst[key] = (float((err > DP_ELEM_ATOL + DP_ELEM_RTOL
                                         * np.abs(want)).mean()),
                                  float(err.max()))
                rows.append(dict(
                    steps=stop,
                    ranks_bitwise_equal=(two_run["digests"][i]
                                         == r1[when]["digests"][i]),
                    loss_rel_err=abs(loss_two - loss_one) / abs(loss_one),
                    worst_share_off=max(v[0] for v in worst.values()),
                    worst_share_param=max(worst, key=lambda k_: worst[k_][0]),
                    max_abs_err=max(v[1] for v in worst.values()),
                    max_abs_param=max(worst, key=lambda k_: worst[k_][1]),
                    bitfield_bits_differ_from_one_rank=int(np.unpackbits(
                        two["density_bitfield"]
                        ^ one["density_bitfield"]).sum())))
                if not rows[-1]["ranks_bitwise_equal"]:
                    failed.append(f"{label} {when} at {stop} steps: the two "
                                  f"ranks' parameters or bitfields differ")
                if i == 0 and rows[-1]["loss_rel_err"] > DP_LOSS_TOL:
                    failed.append(f"{label} {when} at {stop}: loss "
                                  f"{loss_two} against {loss_one}")
                if when == "late":   # the late run: the multichip rule
                    failed += [
                        f"{label} {when} at {stop}: {key}: {bad} of the "
                        f"elements off, max {err}"
                        for key, (bad, err) in worst.items()
                        if bad >= DP_ELEM_SHARE or err >= DP_ELEM_MAX]
            fields[when] = dict(
                start=0 if when == "early" else DP_LATE,
                steps=len(metrics["loss"]),
                first_step_grad_rel_err_max=max(grad_rel.values(),
                                                default=None),
                first_step_grad_rel_err_worst=max(grad_rel, default=None,
                                                  key=grad_rel.get),
                grad_tol=DP_GRAD_TOL,
                loss_tol=DP_LOSS_TOL, elem_share_tol=DP_ELEM_SHARE,
                elem_max_tol=DP_ELEM_MAX, checkpoints=rows,
                rm_s_one=float(metrics["rm_s"][-1]),
                rm_s_two=float(two_run["metrics"]["rm_s"][-1]),
                one_rank_ms_per_step=ms,
                two_rank_ms_per_step=two_run["ms_per_step"])
        del runs, system
        torch.cuda.empty_cache()
        budget = r1["n_global"] * r1["s_flat"]
        fields["late"].update(
            flat_budget=budget,
            steps_cut_in_rank0=sum(1 for before, _ in r1["cuts"]
                                   if before > budget),
            rank0_samples=[before for before, _ in r1["cuts"]])
        out[label] = fields
    if out["LowRank"]["late"]["steps_cut_in_rank0"] == 0:
        failed.append("the flat cut never fell inside rank 0")
    r0 = ranks[0]["LowRank"]
    errs = r0["render_err"]
    render = dict(
        wh=WH, T_threshold=TEST_T, world=2, max_abs_err=errs,
        tol_rgb_opacity=DP_RGB_TOL, tol_depth=DP_DEPTH_TOL,
        sharded_ms=r0["sharded_ms"], whole_ms=r0["whole_ms"],
        sharded_samples=r0["sharded_samples"],
        whole_samples=r0["whole_samples"])
    if not (r0["render_finite"] and errs["rgb"] <= DP_RGB_TOL
            and errs["opacity"] <= DP_RGB_TOL
            and errs["depth"] <= DP_DEPTH_TOL):
        failed.append(f"render_test_sharded against render_test: {errs}")
    return out, render, failed


def num_gpus_refused():
    """``python -m mfnerf_tpu_torch.train --num_gpus N`` with N one more
    than the machine's cards: a non-zero exit with the ValueError of the
    JAX make_mesh, before anything is read. Returns the phase's fields."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get("PYTHONPATH", "")]))
    n = torch.cuda.device_count() + 1
    proc = subprocess.run(
        [sys.executable, "-m", "mfnerf_tpu_torch.train", "--root_dir",
         "no_such_scene", "--num_gpus", str(n)], env=env,
        capture_output=True, text=True, timeout=300)
    want = f"ValueError: requested {n} devices, have {n - 1}"
    check(proc.returncode != 0 and want in proc.stderr,
          f"--num_gpus {n}: exit {proc.returncode}, {proc.stderr[-1000:]}")
    return dict(num_gpus=n, exit_code=proc.returncode, error=want)


def hat_fp32(u, w3, k, datasets, dev, hat_launches):
    """Phase 32: the fp32 instantiation of csrc/hatmul.cu. The forward at
    N_KERNEL (phase 3's u and W) within HAT_FP32_TOL of the plain fp32
    version, the backward at N_BWD (phase 7's checks, dW within
    HAT_FP32_DW_TOL); one training step of BENCH_HP with
    lr_matmul_dtype="float32", card against CPU (step_oracle); then 100 +
    FP32_CHUNKS x 100 steps in fp32 and in bf16, in turns in this process,
    their ms/step; and both kernels on one real fp32 step's operands,
    device times by CUDA-graph replay beside the bf16 kernels' on the same
    operands. Returns the phase's fields."""
    from mfnerf_tpu_torch import build
    from mfnerf_tpu_torch.models.ngp import NGP
    from mfnerf_tpu_torch.ops import hatmul
    from mfnerf_tpu_torch.ops.hatmul import (hat_prod, hat_prod_bwd,
                                             hat_prod_plain)
    r = w3.shape[2]
    u3 = torch.from_numpy(u).to(dev)
    got = hat_prod(u3, w3, k, "float32")
    want = hat_prod_plain(u3, w3, k, "float32")
    torch.cuda.synchronize()
    fwd_err = float((got - want).abs().max())
    fwd_scale = float(want.abs().max())
    check(got.dtype == torch.float32 and fwd_err <= HAT_FP32_TOL * fwd_scale,
          f"fp32 hat_prod vs plain: {fwd_err} of {fwd_scale}")
    fwd = dict(n=N_KERNEL, k=k, r=r, max_abs_err=fwd_err, max_abs=fwd_scale,
               tol=HAT_FP32_TOL,
               ms=cuda_ms(lambda: hat_prod(u3, w3, k, "float32"), 20),
               bf16_ms=cuda_ms(lambda: hat_prod(u3, w3, k), 20),
               plain_ms=cuda_ms(lambda: hat_prod_plain(u3, w3, k, "float32"),
                                5))
    fwd["bound_ms"], fwd["bound_by"] = fwd_bound(N_KERNEL, k, r, 4)
    del got, want, u3
    u3 = torch.from_numpy(u[:N_BWD].copy()).to(dev)
    g = torch.from_numpy(np.random.default_rng(SEED + 90).standard_normal(
        (N_BWD, r), dtype=np.float32)).to(dev)
    bwd = check_bwd("uniform_fp32", u3, w3, k, g, "float32", HAT_FP32_DW_TOL)
    lib = build.load_library("hatmul")
    bwd["blocks_per_sm"] = lib.hat_prod_bwd_blocks_per_sm_f32(k)
    bwd["blocks_per_sm_bf16"] = lib.hat_prod_bwd_blocks_per_sm(k)
    del u3, g
    torch.cuda.empty_cache()

    # one step, card against CPU
    hp32 = dict(BENCH_HP, lr_matmul_dtype="float32")
    system = start_system(hp32, datasets, dev)
    check(system.model.lowrank_cfg.matmul_dtype == "float32",
          "lr_matmul_dtype did not reach the encoder")
    occ0 = culled_state(system, SEED + 91)
    cpu_model = NGP(system.model_cfg, device="cpu")
    cpu_model.load_state_dict(system.model.state_dict())
    oracle, _ = step_oracle(system.model, cpu_model, occ0, system.rcfg,
                            system.loss, oracle_batch(system.train_dataset,
                                                      SEED + 92))
    del cpu_model, occ0

    # training in fp32 and bf16, in turns
    bf16 = start_system(BENCH_HP, datasets, dev)
    train = {}
    for label, sys_ in (("float32", system), ("bfloat16", bf16)):
        hat_launches(reset=True)
        sys_.fit(CHUNK)
        chunk_ms = []
        for _ in range(FP32_CHUNKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = sys_.fit(CHUNK)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3 / CHUNK)
        check(bool(torch.isfinite(m["loss"]).all()), f"{label}: loss")
        train[label] = dict(chunk_ms_per_step=chunk_ms,
                            ms_per_step=float(np.median(chunk_ms)),
                            train_psnr=float(m["psnr"][-50:].mean()),
                            **hat_launches())
    check(min(train["float32"]["hat_prod_launches"],
              train["float32"]["hat_prod_bwd_launches"]) > 0,
          f"fp32 training launched {train['float32']}")

    # both kernels on one real fp32 step's operands, graph-replayed
    captured = capture_bwd_operands(system, SEED + 93, hatmul)
    u3t, w3t, kt, gt, _ = captured[0]
    frame = {"n": u3t.shape[0], "k": kt, "r": w3t.shape[2]}
    for dt in ("float32", "bfloat16"):
        frame[f"fwd_ms_{dt}"] = graph_ms(
            lambda: hat_prod(u3t, w3t, kt, dt), 20)
        frame[f"bwd_ms_{dt}"] = graph_ms(
            lambda: hat_prod_bwd(u3t, w3t, kt, gt, need_du=False, dtype=dt),
            20)
    n_t, r_t = frame["n"], frame["r"]
    frame["fwd_bound_ms"], _ = fwd_bound(n_t, kt, r_t, 4)
    frame["bwd_bound_ms"], _ = bwd_bound(n_t, kt, r_t, False, 4)
    train_bwd = check_bwd("train_fp32", u3t, w3t, kt, gt, "float32",
                          HAT_FP32_DW_TOL)
    del captured, system, bf16
    torch.cuda.empty_cache()
    return dict(fwd=fwd, bwd=bwd, step_oracle=oracle, train=train,
                ms_ratio_fp32_to_bf16=train["float32"]["ms_per_step"]
                / train["bfloat16"]["ms_per_step"],
                train_frame=frame,
                train_frame_checks={key: train_bwd[key] for key in (
                    "dw_bitwise_equal", "dw_max_abs_err", "dw_max_abs",
                    "du_knot_max_abs", "du_share_within_tol")})


def lpips_weights_npz(path):
    """Seeded random LPIPS weights (the pretrained ones do not ship) written
    where ``--lpips_weights`` reads them."""
    from mfnerf_tpu_torch.utils.lpips import random_lpips_weights
    weights = random_lpips_weights(torch.Generator().manual_seed(SEED + 95))
    np.savez(path, **{key: v.numpy() for key, v in weights.items()})


def lpips_pair(npz, images, dev):
    """Phase 33's pair: LPIPS of two WH x WH images on the card against the
    CPU port, the card's ms a pair. Returns the phase's fields."""
    from mfnerf_tpu_torch.utils.lpips import (load_lpips_weights,
                                              lpips_from_weights)
    a, b = (torch.from_numpy(x.reshape(WH, WH, 3)) for x in images)
    cpu = float(lpips_from_weights(load_lpips_weights(npz), a, b))
    w_dev = load_lpips_weights(npz, dev)
    a_d, b_d = a.to(dev), b.to(dev)
    card = float(lpips_from_weights(w_dev, a_d, b_d))
    rel = abs(card - cpu) / abs(cpu)
    ms = cuda_ms(lambda: lpips_from_weights(w_dev, a_d, b_d), LPIPS_REPEAT)
    check(cpu > 0 and rel <= LPIPS_TOL, f"LPIPS card {card} against CPU {cpu}")
    return dict(wh=WH, weights="random, seeded (the pretrained VGG16 "
                "weights do not ship)", lpips_card=card, lpips_cpu=cpu,
                rel_err=rel, tol=LPIPS_TOL, ms_per_pair=ms)


def lpips_validate(argv, ckpt, npz, dev):
    """``main --val_only --eval_lpips --lpips_weights`` on the cli phase's
    checkpoint: its metrics (with test/lpips_vgg)."""
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.train import main as train_main
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        metrics = train_main(get_opts([
            *argv, "--val_only", "--ckpt_path", ckpt, "--no_save_test",
            "--eval_lpips", "--lpips_weights", npz]), device=dev)
    print(log.getvalue(), end="", flush=True)
    check("test/lpips_vgg" in metrics
          and math.isfinite(metrics["test/lpips_vgg"]),
          f"--eval_lpips: {metrics}")
    return dict(metrics, seconds=time.perf_counter() - t0)


def host_links(lib):
    """The shared libraries that the built host library ``lib`` (a decoder
    in csrc/) needs (ldd)."""
    from mfnerf_tpu_torch import build
    out = subprocess.run(["ldd", str(build.build(lib))], check=True,
                         capture_output=True, text=True).stdout
    return [line.split()[0] for line in out.splitlines() if line.strip()]


def median_seconds(fn, repeat):
    """The median host seconds of ``repeat`` calls of ``fn``."""
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def jpeg_phase():
    """24: the committed fixtures (tests/data/jpeg: each JPEG beside PIL's
    decode of it as a PNG) decoded byte for byte, then an 800x800 4:2:0
    file (the procedural view, utils/procedural.py's encoder at quality
    95) timed against png.py on the same view. Returns the fields."""
    from mfnerf_tpu_torch.datasets.jpeg import decode_jpeg, read_jpeg
    from mfnerf_tpu_torch.datasets.png import read_png, write_png
    from mfnerf_tpu_torch.utils.procedural import encode_jpeg, make_scene
    repo = os.path.dirname(os.path.abspath(__file__))
    fixtures = {}
    for name in sorted(os.listdir(os.path.join(repo, JPEG_FIXTURES))):
        if not name.endswith(".jpg"):
            continue
        path = os.path.join(repo, JPEG_FIXTURES, name)
        got = read_jpeg(path)
        want = read_png(path[:-4] + ".png")
        want = want[..., None] if want.ndim == 2 else want
        check(got.shape == want.shape and np.array_equal(got, want),
              f"{name}: the decode differs from PIL's")
        fixtures[name] = list(got.shape)
    check(len(fixtures) >= 3, f"JPEG fixtures {fixtures}")
    scene = make_scene(n_train=1, n_test=1, wh=WH, seed=SEED)
    img = (scene["images"][0].reshape(WH, WH, 3) * 255).astype(np.uint8)
    data = encode_jpeg(img, 95, (2, 2))
    decode_s = median_seconds(lambda: decode_jpeg(data), JPEG_REPEAT)
    err = np.abs(decode_jpeg(data).astype(np.int64) - img)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "view.png")
        write_png(path, img)
        png_s = median_seconds(lambda: read_png(path), JPEG_REPEAT)
        png_bytes = os.path.getsize(path)
    return dict(fixtures=fixtures, wh=WH, sampling="4:2:0", quality=95,
                jpeg_bytes=len(data), png_bytes=png_bytes,
                decode_seconds=decode_s, png_decode_seconds=png_s,
                repeats=JPEG_REPEAT, mean_abs_err=float(err.mean()),
                max_abs_err=int(err.max()))


def host_cpu():
    """The host CPU's model name (lscpu, else /proc/cpuinfo; else the
    architecture) and its logical CPUs, which the decode times stand
    beside."""
    try:
        text = subprocess.run(["lscpu"], capture_output=True,
                              text=True).stdout
    except OSError:
        text = ""
    with open("/proc/cpuinfo") as f:
        text += f.read()
    names = re.findall(r"^(?:Model name|model name|cpu model)\s*:\s*(.+)$",
                       text, re.M)
    name = names[0].strip() if names else platform.machine()
    return f"{name} ({os.cpu_count()} logical)"


def exr_phase():
    """34: one procedural view at RTMV's 1600x1600 as RTMV stores a frame
    (linear light, RGBA HALF, alpha 1) encoded under ZIP and PIZ, and in
    FLOAT under ZIP (utils/procedural.py's encoder); each decode equals
    the encoder's input bit for bit; the median of EXR_REPEAT decodes each,
    beside png.py on the view's 8-bit PNG. Returns the fields."""
    from mfnerf_tpu_torch.datasets.color_utils import srgb_to_linear
    from mfnerf_tpu_torch.datasets.exr import decode_exr
    from mfnerf_tpu_torch.datasets.png import read_png, write_png
    from mfnerf_tpu_torch.utils.procedural import encode_exr, make_scene
    scene = make_scene(n_train=1, n_test=1, wh=EXR_WH, seed=SEED)
    img = (scene["images"][0].reshape(EXR_WH, EXR_WH, 3) * 255).astype(
        np.uint8)
    linear = srgb_to_linear(img.astype(np.float32) / 255)
    rgba = np.concatenate([linear, np.ones_like(linear[..., :1])], -1)
    frames = {}
    for label, compression, pixel_type in (("half_zip", "zip", "half"),
                                           ("half_piz", "piz", "half"),
                                           ("float_zip", "zip", "float")):
        t0 = time.perf_counter()
        data = encode_exr(rgba, compression, pixel_type)
        encode_s = time.perf_counter() - t0
        want = (rgba.astype(np.float16).astype(np.float32)
                if pixel_type == "half" else rgba)
        got = decode_exr(data, label)
        check(got.shape == want.shape and np.array_equal(
            got.view(np.uint32), want.view(np.uint32)),
            f"{label}: the decode differs from the encoder's input")
        frames[label] = dict(
            bytes=len(data), encode_seconds=encode_s,
            decode_ms=1e3 * median_seconds(lambda: decode_exr(data, label),
                                           EXR_REPEAT))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "view.png")
        write_png(path, img)
        png_ms = 1e3 * median_seconds(lambda: read_png(path), EXR_REPEAT)
        png_bytes = os.path.getsize(path)
    return dict(wh=EXR_WH, channels="RGBA", frames=frames,
                png_decode_ms=png_ms, png_bytes=png_bytes, repeats=EXR_REPEAT,
                bit_exact=True, host_cpu=host_cpu())


def png_bytes_apart(root_a, root_b):
    """Over the images/ PNGs of two scenes: the bytes that differ, all
    bytes, and the largest difference."""
    from mfnerf_tpu_torch.datasets.png import read_png
    names = sorted(os.listdir(os.path.join(root_a, "images")))
    check(names == sorted(os.listdir(os.path.join(root_b, "images"))),
          f"{root_a} and {root_b} hold other images")
    differ = total = largest = 0
    for name in names:
        a = read_png(os.path.join(root_a, "images", name)).astype(np.int16)
        b = read_png(os.path.join(root_b, "images", name)).astype(np.int16)
        check(a.shape == b.shape, f"{name}: {a.shape} against {b.shape}")
        differ += int((a != b).sum())
        total += a.size
        largest = max(largest, int(np.abs(a - b).max()))
    return differ, total, largest


def cli_rtmv(dev, read_launches):
    """35: a procedural scene of RTMV_FRAMES distinct views at 800x800
    written as RTMV publishes it (NNNNN.exr, ZIP, beside NNNNN.json),
    "python -m mfnerf_tpu_torch.misc.prepare_rtmv" on it, and the same
    scene written as PNG; then main with the reference's RTMV recipe on
    each. Returns the fields."""
    from mfnerf_tpu_torch.datasets.rtmv import RTMVDataset
    from mfnerf_tpu_torch.utils.procedural import make_scene, write_rtmv_scene
    repo = os.path.dirname(os.path.abspath(__file__))
    scene = make_scene(n_train=RTMV_FRAMES, n_test=1, wh=WH, seed=SEED)
    roots = {"exr": os.path.join(RTMV_ROOT, "spheres_exr"),
             "png": os.path.join(RTMV_ROOT, "spheres_png")}
    t0 = time.perf_counter()
    write_rtmv_scene(roots["exr"], scene, n_frames=RTMV_FRAMES,
                     image_format="exr", compression="zip")
    write_s = time.perf_counter() - t0
    exr_bytes = sum(os.path.getsize(os.path.join(roots["exr"], name))
                    for name in os.listdir(roots["exr"])
                    if name.endswith(".exr"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "mfnerf_tpu_torch.misc.prepare_rtmv",
                           roots["exr"]], env=env, capture_output=True,
                          text=True, timeout=300)
    prepare_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"prepare_rtmv exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check(proc.stdout.split() == [f"{i:05d}.png" for i in range(
        RTMV_FRAMES)], f"prepare_rtmv printed {proc.stdout[:200]}")
    write_rtmv_scene(roots["png"], scene, n_frames=RTMV_FRAMES)
    differ, total, largest = png_bytes_apart(roots["exr"], roots["png"])
    check(largest <= 1, f"the EXR scene's PNGs differ by up to {largest}")
    del scene
    runs = {}
    for label, root in roots.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            views = [RTMVDataset(root, split=split).rays.shape
                     for split in ("train", "test")]
        load_s = time.perf_counter() - t0
        check(views == [(100, WH * WH, 3), (5, WH * WH, 3)],
              f"RTMV views {views}")
        argv = ["--root_dir", root, *RTMV_ARGS, "--exp_name", f"rtmv_{label}"]
        metrics, log, system, launches = run_main(argv, dev, read_launches)
        runs[label] = dict(
            argv=argv, load_seconds=load_s,
            ms_per_step=metrics["train/ms_per_step"],
            test_psnr=metrics["test/psnr"], test_ssim=metrics["test/ssim"],
            train_psnr_last_step=float(re.findall(
                r"^step .* psnr ([0-9.]+)", log, re.M)[-1]),
            foreground=foreground_colour(system),
            val_ms_per_frame=val_ms(log), **launches)
        del system
        counts = [v for key, v in launches.items()
                  if key.endswith("_launches")]
        check(min(counts + list(launches["march"].values())) > 0,
              f"the RTMV run ({label}) launched {launches}")
        torch.cuda.empty_cache()
    return dict(wh=WH, frames=RTMV_FRAMES, cuts=list(RTMV_CUTS),
                write_seconds=write_s, exr_bytes=exr_bytes,
                prepare_seconds=prepare_s, png_bytes_differ=differ,
                png_bytes=total, png_max_diff=largest,
                psnr_tol=RTMV_PSNR_TOL, runs=runs)


def offline_phases(argv, ckpt, val_psnr, dev, read_launches):
    """26-28 on the cli phase's checkpoint, in its working directory: eval
    (in process at validation's T 1e-4, whose mean PSNR must equal
    --val_only's within CLI_PSNR_TOL, then at 1e-2 with --mesh at 256^3;
    then "python -m mfnerf_tpu_torch.eval" at 1e-2), the orbit render (in
    process, ORBIT_FRAMES frames at 400x400, then "python -m
    mfnerf_tpu_torch.show_gui", its 30 frames) and main --profile (48
    traced steps, then PROFILE_STEPS). The hat kernels' launch counts are
    reset before and read after each in-process run. Returns {phase:
    fields}."""
    from mfnerf_tpu_torch import eval as teval
    from mfnerf_tpu_torch import show_gui
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.train import main as train_main
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get("PYTHONPATH", "")]))
    served = [*argv, "--ckpt_path", ckpt, "--no_save_test"]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        at_val = teval.main([*served, "--t_threshold", str(TEST_T)],
                            device=dev)
    check(abs(at_val["mean_psnr"] - val_psnr) <= CLI_PSNR_TOL,
          f"eval at T {TEST_T}: {at_val['mean_psnr']} against --val_only's "
          f"{val_psnr}")
    read_launches(reset=True)
    with contextlib.redirect_stdout(log):
        served_run = teval.main([*served, "--mesh", "mesh.obj",
                                 "--mesh_resolution", str(MESH_RES)],
                                device=dev)
    eval_launches = read_launches()
    print(log.getvalue(), end="", flush=True)
    check(eval_launches["hat_prod_launches"] > 0,
          f"eval launched {eval_launches}")
    check(served_run["mesh_vertices"] > 0 and os.path.getsize("mesh.obj"),
          f"mesh: {served_run['mesh_vertices']} vertices")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mfnerf_tpu_torch.eval",
                           *served], env=env, capture_output=True,
                          text=True, timeout=300)
    eval_cli_s = time.perf_counter() - t0
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0,
          f"python -m mfnerf_tpu_torch.eval exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    cli_psnr = float(re.search(r"^mean PSNR: ([0-9.]+) dB$", proc.stdout,
                               re.M).group(1))
    check(abs(cli_psnr - served_run["mean_psnr"]) <= 0.0051,
          f"python -m eval's mean PSNR {cli_psnr} against "
          f"{served_run['mean_psnr']} in process")
    out = {"eval": dict(
        psnr_t_1e4=at_val["mean_psnr"], val_only_psnr=val_psnr,
        psnr_tol=CLI_PSNR_TOL, psnr_t_1e2=served_run["mean_psnr"],
        ms_per_frame_t_1e2=served_run["ms"],
        mean_fps_t_1e2=served_run["mean_fps"],
        ms_per_frame_t_1e4=at_val["ms"], mesh_resolution=MESH_RES,
        mesh_seconds=served_run["mesh_seconds"],
        mesh_vertices=served_run["mesh_vertices"],
        mesh_obj_bytes=os.path.getsize("mesh.obj"),
        cli_mean_psnr=cli_psnr, cli_seconds=eval_cli_s, **eval_launches)}

    orbit_argv = [*argv, "--ckpt_path", ckpt, "--downsample", "0.5"]
    log = io.StringIO()
    read_launches(reset=True)
    with contextlib.redirect_stdout(log):
        frame_ms = show_gui.main(orbit_argv, device=dev,
                                 n_frames=ORBIT_FRAMES)
    orbit_launches = read_launches()
    print(log.getvalue(), end="", flush=True)
    samples = [float(s) for s in re.findall(
        r"^frame \d+: \d+ ms, ([0-9.]+) samples/ray$", log.getvalue(), re.M)]
    frames = sorted(os.listdir(os.path.join("results", "nsvf", "cli",
                                            "gui")))
    check(len(frame_ms) == ORBIT_FRAMES and len(frames) == ORBIT_FRAMES
          and orbit_launches["hat_prod_launches"] > 0,
          f"orbit: {len(frame_ms)} frames, {frames}, {orbit_launches}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mfnerf_tpu_torch.show_gui",
                           *orbit_argv], env=env, capture_output=True,
                          text=True, timeout=300)
    gui_cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"python -m mfnerf_tpu_torch.show_gui exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    cli_ms = [float(ms) for ms in re.findall(
        r"^frame \d+: (\d+) ms, ", proc.stdout, re.M)]
    check(len(cli_ms) == 30, f"python -m show_gui wrote {len(cli_ms)} "
          f"frames")
    out["orbit"] = dict(wh=[WH // 2, WH // 2], frames=ORBIT_FRAMES,
                        ms_per_frame=frame_ms, samples_per_ray=samples,
                        cli_frames=len(cli_ms), cli_ms_per_frame=cli_ms,
                        cli_seconds=gui_cli_s, **orbit_launches)

    log = io.StringIO()
    read_launches(reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        metrics = train_main(get_opts([
            *argv, "--exp_name", "profile", "--steps_per_epoch",
            str(PROFILE_STEPS), "--no_save_test", "--profile"]), device=dev)
    profile_s = time.perf_counter() - t0
    profile_launches = read_launches()
    print(log.getvalue(), end="", flush=True)
    trace = os.path.join("logs", "nsvf", "profile", "profile", "trace.json")
    with open(trace) as f:
        text = f.read()
    named = {kernel: kernel in text for kernel in PROFILE_KERNELS}
    steps = re.findall(r"^step +(\d+)/(\d+) ", log.getvalue(), re.M)
    check(all(named.values()) and steps[-1] == (str(PROFILE_STEPS),
                                                 str(PROFILE_STEPS)),
          f"profile: kernels named {named}, steps {steps}")
    out["profile"] = dict(trace_bytes=os.path.getsize(trace),
                          kernels_named=named, traced_steps=48,
                          steps_after=PROFILE_STEPS, seconds=profile_s,
                          test_psnr=metrics["test/psnr"],
                          **profile_launches)
    return out


def colmap_views(root, image_format="png"):
    """Write the multi-cascade phases' scene under ``root`` as a COLMAP
    reconstruction (its views as PNG, or with ``image_format="jpg"`` as
    JPEG at quality 95, 4:2:0) and load its train and test splits as
    ``main`` does. Returns (train, test, write seconds, load seconds of
    both splits, mean and max |rays - images|)."""
    from mfnerf_tpu_torch.datasets.colmap import ColmapDataset
    from mfnerf_tpu_torch.utils.procedural import (make_scene,
                                                   write_colmap_scene)
    scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=COLMAP_TEST_VIEWS,
                       wh=WH, seed=SEED, spread=COLMAP_SPREAD)
    t0 = time.perf_counter()
    write_colmap_scene(root, scene, spread=COLMAP_SPREAD,
                       image_format=image_format)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        views = [ColmapDataset(root, split=split)
                 for split in ("train", "test")]
    load_s = time.perf_counter() - t0
    errs = []
    for ds, key in zip(views, ("images", "test_images")):
        check(ds.rays.shape == scene[key].shape,
              f"COLMAP views {ds.rays.shape}")
        errs.append(np.abs(ds.rays - scene[key]))
    mean_err = float(np.mean([e.mean() for e in errs]))
    max_err = float(max(e.max() for e in errs))
    if image_format == "png":
        check(max_err <= CLI_LOAD_TOL, f"COLMAP views: max error {max_err}")
    else:       # the lossy codec: on average within JPEG_LOAD_TOL
        check(mean_err <= JPEG_LOAD_TOL, f"COLMAP views in JPEG: mean "
              f"error {mean_err}")
    return (*views, write_s, load_s, mean_err, max_err)


def cascade_step_oracle(argv, datasets, dev, seed):
    """Phase 20 for one recipe: its untrained field on the COLMAP views
    (culled, one dense refresh), then one training step on the card
    against the CPU (step_oracle) with the same rays, jitter and random
    background; the march takes the cascade strata (the union grid), which
    cut the rays' samples below the exact march's. Then the serving loop at
    five cascades against its oracle, as phase 6: render_test on the card
    against the CPU's render_test_dense on every COLMAP_ORACLE_STRIDE-th
    ray of the first test view. Returns the fields."""
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models.ngp import NGP
    from mfnerf_tpu_torch.models.rendering import (_scene_hits,
                                                   march_rays_train,
                                                   render_test,
                                                   render_test_dense,
                                                   train_strata)
    from mfnerf_tpu_torch.opt import get_opts
    system = start_system(vars(get_opts(["--root_dir", "", *argv])),
                          datasets, dev)
    cfg, rcfg = system.model_cfg, system.rcfg
    occ0 = culled_state(system, seed)
    strata = train_strata(cfg, occ0, rcfg)
    check(strata is not None and strata.union and cfg.cascades == 5,
          f"{cfg.cascades} cascades, strata {strata}")
    batch = oracle_batch(system.train_dataset, seed + 1)
    if rcfg.random_bg:
        batch["bg"] = torch.from_numpy(
            np.random.default_rng(seed + 2).random(3, dtype=np.float32))
    cpu_model = NGP(cfg, device="cpu")
    cpu_model.load_state_dict(system.model.state_dict())
    with capturing_composites() as step_comp:
        fields, _ = step_oracle(system.model, cpu_model, occ0, rcfg,
                                system.loss, batch)
    # the card's step, then the CPU's
    check(len(step_comp) == 2, f"the two steps composited "
          f"{len(step_comp)} times")
    ro, rd = batch["rays_o"].to(dev), batch["rays_d"].to(dev)
    march_args = (
        ro, rd, _scene_hits(system.model, ro, rd), occ0.density_bitfield,
        cfg.cascades, cfg.scale, rcfg.exp_step_factor, cfg.grid_size,
        rcfg.max_samples, batch["noise"].to(dev),
        rcfg.n_rungs(cfg.scale, cfg.grid_size), rcfg.s_max_train)
    exact = march_rays_train(*march_args)
    samples_exact = int(exact.rm_samples)
    check(samples_exact > fields["samples_card"] > 0,
          f"the cascade budget kept {fields['samples_card']} of "
          f"{samples_exact} samples")
    ds = system.test_dataset
    ro, rd = get_rays(torch.from_numpy(ds.directions),
                      torch.from_numpy(ds.poses[0]))
    ro, rd = ro[::COLMAP_ORACLE_STRIDE], rd[::COLMAP_ORACLE_STRIDE]
    test_rcfg = dataclasses.replace(rcfg, T_threshold=TEST_T)
    with capturing_marches() as windows, capturing_composites() as rounds:
        loop = render_test(system.model, occ0, ro.to(dev), rd.to(dev),
                           test_rcfg, graphs=False)
    ref = render_test_dense(cpu_model, occ0.to("cpu"), ro, rd,
                            dataclasses.replace(test_rcfg, test_chunk=2048))
    errs = {key: float((loop[key].cpu() - ref[key]).abs().max())
            for key in ("rgb", "opacity", "depth")}
    check(errs["rgb"] <= RGB_TOL and errs["opacity"] <= RGB_TOL
          and errs["depth"] <= DEPTH_TOL,
          f"render_test at {cfg.cascades} cascades vs oracle: {errs}")
    # 36c. the march kernels on this step's rays (the union grid's strata,
    # and exact) and on the serving loop's windows at five cascades
    timed, march_err = march_phase(
        f"cascades_{cfg.grid}", [("step", march_args, dict(strata=strata)),
                                 ("step_exact", march_args, {})],
        [c[1:] for c in windows],
        window_edges=window_edge_sets(system.model, occ0, test_rcfg,
                                      (ro.to(dev), rd.to(dev)), seed + 3))
    # 37c. the composite kernels on the step and the serving loop's rounds
    comp_timed, comp_err = composite_phase(
        f"cascades_{cfg.grid}", [("step", *step_comp[0][1:])],
        [c[1:3] for c in rounds])
    # 42c. serve_graphed on the first test view at five cascades, every
    # second row and column of it (the LowRank recipe's field; a frame of
    # ~450 rounds, one a turn)
    del windows, rounds
    torch.cuda.empty_cache()
    serve = None
    if cfg.grid == "LowRank":
        w, h = ds.img_wh
        view = np.arange(h * w).reshape(h, w)[::2, ::2].reshape(-1)
        rays = get_rays(torch.from_numpy(ds.directions[view]).to(dev),
                        torch.from_numpy(ds.poses[0]).to(dev))
        serve = serve_graphed(
            f"cascades_{cfg.grid}", system.model, occ0, rays, test_rcfg,
            torch.from_numpy(ds[0]["rgb"][view]).to(dev), turn_frames=1)
        phase("serve_graphed", **serve)
    return dict(grid=cfg.grid, random_bg=rcfg.random_bg, scale=cfg.scale,
                cascades=cfg.cascades,
                stratum=strata.stratum, s_strata=strata.s_strata,
                union_occupied=float(np.unpackbits(
                    occ0.union_bits.cpu().numpy()).mean()),
                samples_exact=samples_exact, **fields,
                oracle_rays=int(ro.shape[0]),
                oracle_samples=ref["total_samples"],
                **{f"oracle_max_abs_{k_}": v for k_, v in errs.items()},
                march={kind: {key: f[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "rays",
                    "samples")} for kind, f in timed.items()
                    if kind in ("train", "window")},
                march_max_abs_err=march_err,
                composite={kind: {key: f[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "rays")}
                    for kind, f in comp_timed.items()
                    if kind in ("train", "round")},
                composite_fwd={key: comp_timed["train"][key] for key in (
                    "fwd_walk_ms", "fwd_passes")},
                composite_bwd={key: comp_timed["train"][key] for key in (
                    "bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
                    "bwd_bound_by", "bwd_two_walk_ms", "bwd_passes")},
                composite_max_abs_err=comp_err,
                serve_graphed=serve and {key: serve[key] for key in (
                    "rounds", "ms_eager", "ms_graphed", "host_reads")})


def colmap_cli(argv, dev, read_launches, root=COLMAP_ROOT):
    """Phase 21 for one recipe: ``main`` on the COLMAP scene at ``root`` in
    the working directory, its launches over the run. Returns the fields
    (ms/step, the last step's rm_s and vr_s, test PSNR and SSIM, the val
    frames' ms, the fused runner's log line) and the trained system."""
    from mfnerf_tpu_torch import train as train_mod
    from mfnerf_tpu_torch.opt import get_opts
    log = io.StringIO()
    hp = get_opts(["--root_dir", root, *argv])
    read_launches(reset=True)
    with fitted_system(train_mod) as seen, contextlib.redirect_stdout(log):
        metrics = train_mod.main(hp, device=dev)
    launches = read_launches()
    print(log.getvalue(), end="", flush=True)
    last = re.findall(r"^step .* psnr ([0-9.]+) rm_s ([0-9.]+) vr_s "
                      r"([0-9.]+)", log.getvalue(), re.M)[-1]
    check(all(math.isfinite(v) for v in metrics.values()),
          f"{argv}: metrics {metrics}")
    return dict(argv=list(argv), ms_per_step=metrics["train/ms_per_step"],
                train_psnr_last_step=float(last[0]), rm_s=float(last[1]),
                vr_s=float(last[2]), test_psnr=metrics["test/psnr"],
                test_ssim=metrics["test/ssim"],
                val_ms_per_frame=val_ms(log.getvalue()),
                fused_runner=fused_log(log.getvalue()),
                steps=hp.num_epochs * hp.steps_per_epoch,
                **launches), seen["system"]


def trainer_step_oracle(hp, datasets, dev, seed, module, loss_tol,
                        grad_tol):
    """One step of the trainer (``NeRFSystem.step_loss``) of the
    hyperparameters ``hp`` on the card against the same step on the CPU:
    the same weights drawn from SEED, the culled and refreshed occupancy,
    N_ORACLE_RAYS (image, pixel) draws and jitter from ``seed`` and, with
    ``--optimize_ext``, dR and dT drawn N(0, EXT_OFFSET^2). The loss within
    ``loss_tol`` (relative) and every gradient, dR and dT included, within
    ``grad_tol`` (relative L2). The card's encoder backward launches are
    recorded (``module``): with ``--optimize_ext`` each asks for the input
    gradient. Returns the phase's fields."""
    from mfnerf_tpu_torch.train import NeRFSystem
    card = start_system(hp, datasets, dev)
    cpu = NeRFSystem(argparse.Namespace(**hp), device="cpu")
    cpu.setup(*datasets)
    cpu.configure(SEED)
    cpu.model.load_state_dict(card.model.state_dict())
    card.occ = culled_state(card, seed)
    cpu.occ = card.occ.to("cpu")
    pick = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name in card.ext:
            v = torch.from_numpy((EXT_OFFSET * pick.standard_normal(
                card.ext[name].shape)).astype(np.float32))
            card.ext[name].copy_(v)
            cpu.ext[name].copy_(v)
    ds = card.train_dataset
    img = torch.from_numpy(pick.integers(0, len(ds.poses), N_ORACLE_RAYS))
    pix = torch.from_numpy(pick.integers(0, ds.rays.shape[1],
                                         N_ORACLE_RAYS))
    noise = torch.from_numpy(pick.random(N_ORACLE_RAYS, dtype=np.float32))
    steps, launches = {}, []
    for where, system in (("card", card), ("cpu", cpu)):
        d = system.device
        with recording(module, tensors=False) as calls:
            loss, res, _ = system.step_loss(img.to(d), pix.to(d),
                                            noise.to(d))
            system.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if where == "card":
            launches = [args[-1] for args in calls]
        steps[where] = (float(loss.detach()), int(res["rm_samples"]), {
            name: p.grad.detach().cpu() for name, p in
            [*system.model.named_parameters(), *system.ext.items()]})
        system.optimizer.zero_grad(set_to_none=True)
    (loss_c, rm_c, grads_c), (loss_p, rm_p, grads_p) = \
        steps["card"], steps["cpu"]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    grad_rel = {name: float((grads_c[name] - grads_p[name]).norm()
                            / grads_p[name].norm()) for name in grads_p}
    check(rm_c == rm_p, f"samples on the card {rm_c} vs cpu {rm_p}")
    check(loss_rel <= loss_tol, f"loss card {loss_c} vs cpu {loss_p}")
    check(max(grad_rel.values()) <= grad_tol, f"gradients: {grad_rel}")
    check(len(launches) > 0 and all(launches) == bool(card.ext),
          f"encoder backward launches, input gradient asked: {launches}")
    del cpu
    return dict(grid=card.model_cfg.grid, bf16=bool(hp.get("bf16")),
                optimize_ext=bool(card.ext), rays=N_ORACLE_RAYS,
                samples_card=rm_c, samples_cpu=rm_p, loss_card=loss_c,
                loss_cpu=loss_p, loss_rel_err=loss_rel, loss_tol=loss_tol,
                grad_rel_err_max=max(grad_rel.values()),
                grad_rel_err_worst=max(grad_rel, key=grad_rel.get),
                grad_rel_err_dR=grad_rel.get("dR"),
                grad_rel_err_dT=grad_rel.get("dT"), grad_tol=grad_tol,
                bwd_launches=len(launches),
                bwd_input_grad=all(launches))


@contextlib.contextmanager
def fitted_system(train_module):
    """Within the context, ``NeRFSystem.fit`` records its system in the
    yielded dict (``main`` keeps it to itself)."""
    seen, fit = {}, train_module.NeRFSystem.fit

    def spy(self, n_steps=None):
        seen["system"] = self
        return fit(self, n_steps)

    train_module.NeRFSystem.fit = spy
    try:
        yield seen
    finally:
        train_module.NeRFSystem.fit = fit


def run_main(argv, dev, read_launches):
    """``main`` on ``argv`` in the working directory, its output captured and
    then printed: (metrics, log, the trained system, the launch counts)."""
    from mfnerf_tpu_torch import train as train_mod
    from mfnerf_tpu_torch.opt import get_opts
    log = io.StringIO()
    read_launches(reset=True)
    with fitted_system(train_mod) as seen, contextlib.redirect_stdout(log):
        metrics = train_mod.main(get_opts(argv), device=dev)
    launches = read_launches()
    print(log.getvalue(), end="", flush=True)
    check(all(math.isfinite(v) for v in metrics.values()),
          f"{argv}: metrics {metrics}")
    return metrics, log.getvalue(), seen["system"], launches


def cli_hdr(dev, read_launches):
    """``main --use_exposure`` on the 400x400 scene written in HDR-NeRF's
    synthetic layout under the working directory: the write and load
    seconds, ms/step, test PSNR and SSIM, the PSNR at each test exposure,
    the unit-exposure rgb (the head's rgb of zero log radiance at exposure
    1, which the unit-exposure loss pulls to 0.73), the kernels' launches."""
    from mfnerf_tpu_torch.datasets.colmap import ColmapDataset
    from mfnerf_tpu_torch.utils.procedural import (HDR_TEST, HDR_TRAIN,
                                                   make_scene,
                                                   write_hdr_scene)
    scene = make_scene(n_train=HDR_TRAIN[0], n_test=HDR_TEST[0], wh=HDR_WH,
                       seed=SEED, spread=COLMAP_SPREAD)
    t0 = time.perf_counter()
    write_hdr_scene(HDR_ROOT, scene, spread=COLMAP_SPREAD)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        views = [ColmapDataset(HDR_ROOT, split=split)
                 for split in ("train", "test")]
    load_s = time.perf_counter() - t0
    check([v.rays.shape for v in views] == [(54, HDR_WH ** 2, 4),
                                            (34, HDR_WH ** 2, 4)],
          f"HDR views {[v.rays.shape for v in views]}")
    exposures = [float(views[1][i]["exposure"]) for i in range(34)]
    del views
    metrics, log, system, launches = run_main(
        ["--root_dir", HDR_ROOT, *HDR_ARGS], dev, read_launches)
    psnrs = [float(v) for v in re.findall(r"^val image .*psnr=([0-9.]+)",
                                          log, re.M)]
    check(len(psnrs) == 34, f"{len(psnrs)} HDR test views scored")
    by_exposure = {str(e): float(np.mean([p for p, e_ in
                                          zip(psnrs, exposures) if e_ == e]))
                   for e in sorted(set(exposures), reverse=True)}
    with torch.no_grad():
        unit = system.model.log_radiance_to_rgb(
            torch.zeros((1, 3), device=dev), torch.ones((1, 1), device=dev))
    check(system.model.cfg.rgb_act == "None", "the HDR head is not on")
    runner = system.fused
    check(runner is not None and runner.step_graph is not None
          and runner.kind == "padded",
          "the fused runner did not serve --use_exposure's padded step")
    return dict(argv=list(HDR_ARGS), cuts=HDR_CUTS, wh=HDR_WH, views=[54, 34],
                write_seconds=write_s, load_seconds=load_s,
                ms_per_step=metrics["train/ms_per_step"],
                test_psnr=metrics["test/psnr"],
                test_ssim=metrics["test/ssim"],
                psnr_by_exposure=by_exposure,
                unit_exposure_rgb=unit[0].tolist(),
                unit_exposure_target=system.unit_exposure_rgb.tolist(),
                val_ms_per_frame=val_ms(log), fused_runner=fused_log(log),
                **launches)


def cli_ext(dev, read_launches):
    """``main --optimize_ext --pose_lr 2e-3`` on the cli's 800x800 scene
    written in the NSVF layout with its training poses perturbed
    (``perturb_poses``, EXT_PERTURB) under the working directory, its
    steps served by the fused runner (fit's line must say CUDA graphs): the
    gauge-corrected camera-centre error before and after (the refined
    centre is the perturbed one plus dT), ms/step, test PSNR, the hat
    backward's launches (every call, eager or captured, asked for du);
    then phase 7's checks and times on one step's operands of the trained
    system, du on, and :func:`fused_phase` on it (the --optimize_ext step,
    dR, dT and their Adam state held bit for bit). Returns (the fields, the
    fused phase's fields)."""
    from mfnerf_tpu_torch.ops import hatmul
    from mfnerf_tpu_torch.utils.procedural import (gauge_center_error,
                                                   make_scene, perturb_poses,
                                                   write_nsvf_scene)
    root = os.path.join("Synthetic_NeRF_proc", "Perturbed")
    scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=CLI_TEST_VIEWS, wh=WH,
                       seed=SEED)
    true_centers = scene["poses"][:, :, 3].copy()
    perturbed = perturb_poses(scene["poses"], EXT_PERTURB)[0]
    write_nsvf_scene(root, dict(scene, poses=perturbed))
    with recording(hatmul, tensors=False) as calls:
        metrics, log, system, launches = run_main(
            ["--root_dir", root, *EXT_ARGS], dev, read_launches)
    runner_line = fused_log(log)
    du_asked = sum(1 for args in calls if args[-1])
    centers = system.poses[:, :, 3].cpu().numpy()
    before = gauge_center_error(centers, true_centers)
    after = gauge_center_error(
        centers + system.ext["dT"].detach().cpu().numpy(), true_centers)
    # the graphs' replays launch what their captured calls asked for
    check(du_asked == len(calls) > 0,
          f"{du_asked} of {len(calls)} hat backward calls asked for du")
    captured = capture_bwd_operands(system, SEED + 50, hatmul)
    u3, w3, k, g, need_du = captured[0]
    check(need_du, "an --optimize_ext step's hat backward without du")
    bwd = check_bwd("train_du", u3, w3, k, g)
    fields = dict(argv=list(EXT_ARGS), cuts=EXT_CUTS, perturb=EXT_PERTURB,
                  center_err_before=before, center_err_after=after,
                  center_err_share_max=EXT_ERR_SHARE,
                  ms_per_step=metrics["train/ms_per_step"],
                  test_psnr=metrics["test/psnr"], fused_runner=runner_line,
                  **launches,
                  hat_prod_bwd_du_launches=launches["hat_prod_bwd_launches"],
                  hat_prod_bwd_du_calls=du_asked,
                  bwd_du={key: bwd[key] for key in (
                      "n", "k", "r", "ms", "bound_ms", "bound_by",
                      "share_of_bound", "ms_no_du", "bound_ms_no_du",
                      "dw_bitwise_equal", "du_share_within_tol",
                      "du_knot_max_abs")})
    return fields, fused_phase("cli_ext", system, hatmul, SEED + 102)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mfnerf_tpu_torch.device import no_tf32, tf32_off
    no_tf32()

    from mfnerf_tpu_torch import build
    from mfnerf_tpu_torch.benchmarking import (probe_gather, probe_gather2,
                                               probe_hatmul)
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
    from mfnerf_tpu_torch.models.rendering import (RenderConfig, render_test,
                                                   render_test_dense)
    from mfnerf_tpu_torch.ops import hashgrid, hatmul
    from mfnerf_tpu_torch.ops.hashgrid import hashgrid_bwd, hashgrid_encode
    from mfnerf_tpu_torch.ops.hatmul import (hat_prod, hat_prod_bwd,
                                             hat_prod_plain)
    from mfnerf_tpu_torch.ops.linetable import hat_basis_dw, table_lerp
    from mfnerf_tpu_torch.ops.lowrank import fold_frame
    from mfnerf_tpu_torch.ops.ray_march import (march_rays_train,
                                                march_rays_window)
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.utils.metrics import psnr
    from mfnerf_tpu_torch.utils.procedural import make_scene

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    card = smi.splitlines()[0]
    nvcc = subprocess.run([build.nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    nvcc = [line for line in nvcc.splitlines() if "release" in line][0]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    print(f"card: {card}", flush=True)
    phase("device", name=name, nvidia_smi=smi, torch=torch.__version__,
          torch_cuda=torch.version.cuda,
          nvcc=nvcc.strip(), triton=triton_version,
          tf32=not tf32_off())

    # ---- 2, 11 and 16a. build the kernels' sources, one nvcc each, together
    src = "mfnerf_tpu_torch/csrc/hatmul.cu"
    hash_src = "mfnerf_tpu_torch/csrc/hashgrid.cu"
    line_src = "mfnerf_tpu_torch/csrc/linetable.cu"
    march_src = "mfnerf_tpu_torch/csrc/raymarch.cu"
    comp_src = "mfnerf_tpu_torch/csrc/composite.cu"

    def timed_build(lib):
        fresh = not build.library_path(lib).exists()
        t0 = time.perf_counter()
        build.load_library(lib)
        return fresh, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(7) as pool:
        builds = {lib: pool.submit(timed_build, lib)
                  for lib in ("hatmul", "hashgrid", "linetable", "raymarch",
                              "composite", "jpeg", "exr")}
        for label, lib, source in (("build", "hatmul", src),
                                   ("build_hashgrid", "hashgrid", hash_src),
                                   ("build_linetable", "linetable",
                                    line_src),
                                   ("build_raymarch", "raymarch",
                                    march_src),
                                   ("build_composite", "composite",
                                    comp_src),
                                   ("build_jpeg", "jpeg", JPEG_SRC),
                                   ("build_exr", "exr", EXR_SRC)):
            fresh, seconds = builds[lib].result()
            extra = {}
            if lib == "jpeg":     # host code: no libjpeg behind it
                extra = dict(compiler=build.cxx(), linked=host_links(lib))
                check(not any("jpeg" in dep for dep in extra["linked"]),
                      f"{JPEG_SRC} links {extra['linked']}")
            if lib == "exr":      # host code: no zlib or OpenEXR behind it
                extra = dict(compiler=build.cxx(), linked=host_links(lib))
                check(not any(name in dep for dep in extra["linked"]
                              for name in EXR_LINKS),
                      f"{EXR_SRC} links {extra['linked']}")
            phase(label, source=source, built=fresh, seconds=seconds,
                  **extra, card=card)
        ptxas = {name: build.ptxas_report(lib, name)
                 for lib, name in (("raymarch", "march_train_kernel"),
                                   ("composite", "composite_train_fw"),
                                   ("composite", "composite_train_bw"))}
        check(all(ptxas.values()), f"ptxas named no kernel: {ptxas}")
        phase("ptxas", march_train=ptxas["march_train_kernel"],
              composite_train_fw=ptxas["composite_train_fw"],
              composite_train_bw=ptxas["composite_train_bw"], card=card)

    # ---- 3. kernel against its plain version, at the serving shapes
    cfg = NGPConfig(lr_k_max=256, lr_fused=True)   # the bench model
    model = NGP(cfg, torch.Generator().manual_seed(SEED), device=dev)
    lr = model.lowrank_cfg
    k = lr.levels[-1]
    w3 = fold_frame({"lines": model.lowrank.lines}, lr, 0).detach()
    rng = np.random.default_rng(SEED)
    u = rng.random((N_KERNEL, 3), dtype=np.float32)
    u[:64] = 1.0                                   # the last knot
    u[64:128] = 0.0
    u[128:1024] = np.round(u[128:1024] * (k - 1)) / (k - 1)   # on knots
    u3 = torch.from_numpy(u).to(dev)
    got = hat_prod(u3, w3, k)
    want = hat_prod_plain(u3, w3, k)
    torch.cuda.synchronize()
    check(got.shape == (N_KERNEL, w3.shape[2]) and got.dtype == torch.float32,
          f"hat_prod output {tuple(got.shape)} {got.dtype}")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-3)).max())
    check(max_abs <= KERNEL_TOL and max_rel <= KERNEL_TOL,
          f"kernel vs plain: max abs {max_abs}, max rel {max_rel}")
    ms = cuda_ms(lambda: hat_prod(u3, w3, k), 20)
    plain_ms = cuda_ms(lambda: hat_prod_plain(u3, w3, k), 5)
    phase("kernel", name="hat_prod", n=N_KERNEL, k=k, r=w3.shape[2],
          max_abs_err=max_abs, max_rel_err=max_rel, tol=KERNEL_TOL, ms=ms,
          plain_ms=plain_ms, card=card)
    del got, want, err

    # ---- 4. serving state: seeded field, one dense occupancy refresh
    noise = torch.rand((cfg.cascades, cfg.n_cells, 3),
                       generator=torch.Generator().manual_seed(SEED + 1)
                       ).to(dev) * 2 - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ = model.update_density_grid(OccupancyState.create(cfg, dev),
                                    0.01 * 1024 / math.sqrt(3), noise)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    occupied = float(torch.from_numpy(np.unpackbits(
        occ.density_bitfield.cpu().numpy())).float().mean())
    check(0.0 < occupied < 1.0, f"occupied fraction {occupied}")
    phase("state", cells=cfg.cascades * cfg.n_cells, occupied=occupied,
          refresh_ms=refresh_ms, card=card)

    # ---- 5. serve eight distinct 800x800 frames through render_test
    scene = make_scene(n_train=1, n_test=N_FRAMES, wh=WH, seed=SEED)
    directions = torch.from_numpy(scene["directions"]).to(dev)
    rays = [get_rays(directions, torch.from_numpy(p).to(dev))
            for p in scene["test_poses"]]
    rcfg = RenderConfig(T_threshold=T_THRESHOLD)
    render_test(model, occ, *rays[0], rcfg)           # warm-up frame
    hat_prod.launches = march_rays_window.launches = 0
    composite_counts(reset=True)
    frame_ms, samples, rounds, outs = [], [], [], []
    for ro, rd in rays:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_test(model, occ, ro, rd, rcfg)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        samples.append(out["total_samples"])
        rounds.append(out["rounds"])
        outs.append(out)
    launches = hat_prod.launches
    serve_window_launches = march_rays_window.launches
    serve_rounds = composite_counts()["round"]
    check(serve_rounds == serve_window_launches == sum(rounds),
          f"render_test launched composite_test_step {serve_rounds} times "
          f"in {sum(rounds)} rounds ({serve_window_launches} window "
          f"marches)")
    check(launches > 0, "render_test never launched the hat_prod kernel")
    check(serve_window_launches > 0,
          "render_test never launched the march_window kernel")
    for out in outs:
        op = out["opacity"]
        check(out["rgb"].shape == (WH * WH, 3)
              and bool(torch.isfinite(out["rgb"]).all())
              and bool(torch.isfinite(out["depth"]).all()),
              "frame not finite or of the wrong shape")
        # a sum of weights that telescopes to 1 - T, up to fp32 rounding
        check(bool(((op >= -1e-6) & (op <= 1 + 1e-6)).all()),
              "opacity outside [0, 1]")
    check(len({float(o["rgb"].sum()) for o in outs}) == N_FRAMES,
          "frames are not distinct")
    ms_med = float(np.median(frame_ms))
    phase("serve", frames=N_FRAMES, wh=WH, T_threshold=T_THRESHOLD,
          ms_per_frame=frame_ms, ms_median=ms_med, fps=1e3 / ms_med,
          samples_per_frame=samples, rounds_per_frame=rounds,
          hat_prod_launches=launches,
          march_window_launches=serve_window_launches,
          composite_test_step_launches=serve_rounds,
          max_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
          card=card)

    # ---- 6. oracle: plain dense renderer on a strided subset of frame 0
    cpu_model = NGP(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_occ = occ.to("cpu")
    ro, rd = rays[0]
    sub = slice(None, None, ORACLE_STRIDE)
    t0 = time.perf_counter()
    ref = render_test_dense(cpu_model, cpu_occ, ro[sub].cpu(), rd[sub].cpu(),
                            RenderConfig(T_threshold=T_THRESHOLD,
                                         test_chunk=2048))
    oracle_s = time.perf_counter() - t0
    errs = {key: float((outs[0][key][sub].cpu() - ref[key]).abs().max())
            for key in ("rgb", "opacity", "depth")}
    phase("oracle", rays=int(ref["opacity"].shape[0]), **{
        f"max_abs_{k_}": v for k_, v in errs.items()},
        tol_rgb_opacity=RGB_TOL, tol_depth=DEPTH_TOL,
        samples=ref["total_samples"], cpu_seconds=oracle_s, card=card)
    check(errs["rgb"] <= RGB_TOL and errs["opacity"] <= RGB_TOL
          and errs["depth"] <= DEPTH_TOL, f"render_test vs oracle: {errs}")

    del outs, out, ref
    torch.cuda.empty_cache()

    # ---- 7. backward kernel against its plain version, uniform u at 2^19
    u3 = torch.from_numpy(u[:N_BWD].copy()).to(dev)
    g = torch.from_numpy(rng.standard_normal((N_BWD, w3.shape[2]),
                                             dtype=np.float32)).to(dev)
    bwd_uniform = check_bwd("uniform", u3, w3, k, g)
    phase("kernel_bwd", name="hat_prod_bwd", **bwd_uniform, card=card)
    # ragged edges: a part-filled column tile (R = 40), two chunks of 1,050
    # samples whose last step holds 10, g a column slice (row stride 80)
    edge = np.random.default_rng(SEED + 5)
    u_e = torch.from_numpy(edge.random((2100, 3), dtype=np.float32)).to(dev)
    w_e = torch.from_numpy(edge.normal(size=(3, 65, 40)).astype(
        np.float32)).to(dev)
    g_e = torch.from_numpy(edge.standard_normal(
        (2100, 80), dtype=np.float32)).to(dev)[:, 40:]
    phase("kernel_bwd", name="hat_prod_bwd",
          **check_bwd("edge", u_e, w_e, 65, g_e), card=card)
    del u3, g, u_e, w_e, g_e
    torch.cuda.empty_cache()

    # ---- 12. the hash-grid kernels against their plain versions
    for label, hcfg, operands, seed in hash_operand_sets():
        phase("kernel_hashgrid", **check_hashgrid(
            label, hcfg, *operands(hcfg, seed), seed + 10), card=card)
        torch.cuda.empty_cache()

    # ---- 8. one training step on the card against the same step on the CPU
    train_scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=1, wh=WH,
                             seed=SEED)
    datasets = (MemoryDataset.from_scene(train_scene, "train"),
                MemoryDataset.from_scene(train_scene, "test"))
    system = start_system(BENCH_HP, datasets, dev)
    occ0 = culled_state(system, SEED + 2)
    cpu_model = NGP(system.model_cfg, device="cpu")
    cpu_model.load_state_dict(system.model.state_dict())
    fields, grads_c = step_oracle(system.model, cpu_model, occ0, system.rcfg,
                                  system.loss,
                                  oracle_batch(system.train_dataset,
                                               SEED + 3))
    line_norms = [float(v.norm()) for name, v in grads_c.items()
                  if name.startswith("lowrank.lines.")]
    phase("train_step_oracle", **fields, line_tables=len(line_norms),
          line_grad_norm_min=min(line_norms), card=card)
    check(len(line_norms) == 3 * lr.n_frames * len(lr.levels)
          and min(line_norms) > 0, "a line table got no gradient")
    del cpu_model, grads_c

    # ---- 8b and 8c. the trainer's step under --optimize_ext (the hat
    # backward with du) and under --bf16, card against CPU
    for label, flags, tols in (
            ("train_step_oracle_ext", dict(optimize_ext=True),
             (LOSS_TOL, GRAD_TOL)),
            ("train_step_oracle_bf16", dict(bf16=True),
             (BF16_LOSS_TOL, BF16_GRAD_TOL))):
        fields = trainer_step_oracle(dict(BENCH_HP, **flags), datasets, dev,
                                     SEED + 60, hatmul, *tols)
        phase(label, **fields, card=card)
        torch.cuda.empty_cache()

    # ---- 10a. the held-out view before training (culled + one refresh)
    test_rays, test_rgb, test_rcfg = held_out_view(system)
    out, _ = render_view(system, test_rays, test_rcfg, occ0)
    psnr_before = float(psnr(out["rgb"], test_rgb))
    del occ0, out

    # ---- 9. train: 300 steps, then 6 timed chunks of 100
    hat_prod.launches = hat_prod_bwd.launches = 0
    march_counts(reset=True)
    composite_counts(reset=True)
    fields = train_steps(system, lambda: dict(
        hat_prod_launches=hat_prod.launches,
        hat_prod_bwd_launches=hat_prod_bwd.launches,
        march=march_counts(), composite=composite_counts()))
    fields["march_train_per_step"] = fields["march"]["train"] \
        / fields["steps"]
    phase("train", **fields, card=card)
    march_train_launches = fields["march"]["train"]
    check(fields["march_train_per_step"] >= 1,
          f"training launched march_train {fields['march']} times")
    check_composite_launches("train", fields)
    train_composite = fields["composite"]
    train_fp32 = fields
    launches_fwd = fields["hat_prod_launches"]
    launches_bwd = fields["hat_prod_bwd_launches"]
    check(launches_fwd > 0 and launches_bwd > 0,
          f"training launched hat_prod {launches_fwd}, hat_prod_bwd "
          f"{launches_bwd} times")

    # ---- 10b. the held-out view after training
    render_view(system, test_rays, test_rcfg)      # warm-up frame
    out, view_ms = render_view(system, test_rays, test_rcfg)
    psnr_after = float(psnr(out["rgb"], test_rgb))
    phase("test_view", wh=WH, T_threshold=TEST_T, psnr_before=psnr_before,
          psnr_after=psnr_after, ms_per_frame=view_ms,
          samples_per_frame=out["total_samples"], rounds=out["rounds"],
          card=card)
    check(bool(torch.isfinite(out["rgb"]).all()), "test view not finite")
    check(psnr_after >= PSNR_MIN and psnr_after >= psnr_before + PSNR_GAIN,
          f"test PSNR {psnr_before} -> {psnr_after}")
    # ---- 42a. serve_graphed: the held-out view's rounds as CUDA graphs
    # against the same rounds eagerly and against the valid-only loop
    serve_bench = {}
    for thr in (TEST_T, T_THRESHOLD):
        serve_bench[thr] = serve_graphed(
            "bench", system.model, system.occ, test_rays,
            dataclasses.replace(test_rcfg, T_threshold=thr), test_rgb)
        phase("serve_graphed", **serve_bench[thr], card=card)
    torch.cuda.empty_cache()

    # ---- 7b. backward kernel on one real step's operands (trained field)
    captured, valid = capture_bwd_operands(system, SEED + 4, hatmul,
                                           with_count=True)
    check(len(captured) == lr.n_frames, f"{len(captured)} hat backward calls")
    # both frames' g are column slices of the (N, 2R) feature gradient
    u3, w3_t, k_t, g, _ = captured[0]
    check(not g.is_contiguous() and g.stride(0) == 2 * g.shape[1],
          f"g of stride {g.stride()} is not a column slice")
    bwd_train = check_bwd("train", u3, w3_t, k_t, g)
    # hat_prod on the same frame's u (the wrapper: host time included)
    fwd_train_ms = cuda_ms(lambda: hat_prod(u3, w3_t, k_t), 20)
    fwd_train_bound = fwd_bound(u3.shape[0], k_t, w3_t.shape[2])[0]
    # the forward kernel as the step runs it: the capacity buffer with its
    # valid count, by graph replay; bound: u of the valid rows, W, out
    count_t = torch.tensor([valid], device=dev)
    fwd_count_ms = graph_ms(lambda: hatmul._launch(u3, w3_t, k_t,
                                                   count=count_t),
                            MARCH_GRAPH_ITERS)
    n_slots, r_t = u3.shape[0], w3_t.shape[2]
    fwd_count_bound, fwd_count_by = bound(
        12 * valid + 3 * 2 * k_t * r_t + 4 * n_slots * r_t,
        11 * valid * r_t)
    phase("kernel_bwd", name="hat_prod_bwd", **bwd_train,
          fwd_ms=fwd_train_ms, fwd_bound_ms=fwd_train_bound,
          fwd_share_of_bound=fwd_train_bound / fwd_train_ms,
          fwd_count=dict(slots=n_slots, count=valid, ms=fwd_count_ms,
                         bound_ms=fwd_count_bound, bound_by=fwd_count_by,
                         share_of_bound=fwd_count_bound / fwd_count_ms),
          card=card)
    del captured, u3, g

    # ---- 36a. the march kernels against their plain versions on the
    # trained field: a step's rays, the degenerate rays, an empty and a
    # full bitfield, the dense oracle's rank windows, a frame's windows
    bench_march, march_err = march_phase(
        "bench", march_sets_of(system, SEED + 80)
        + oracle_march_sets(system, test_rays, test_rcfg),
        frame_window_sets(system, test_rays, test_rcfg),
        window_edges=window_edge_sets(system.model, system.occ, test_rcfg,
                                      test_rays, SEED + 82),
        time_rounds=True,
        train_edges=march_train_edge_sets(system, SEED + 84))

    # ---- 37a. the composite kernels against their plain versions: a step
    # of the trained field, the edge blocks, every round of a trained frame
    # and the edge blocks as serving rounds
    bench_comp, comp_err = composite_phase(
        "bench", [("step", *step_composite_operands(system, SEED + 90))]
        + [(label, args, thr, None) for label, args, thr
           in composite_edge_sets(dev, SEED + 91)],
        frame_round_sets(system, test_rays, test_rcfg))
    for label, args, thr in composite_round_edge_sets(dev, SEED + 92):
        fields = check_composite_round(label, args, thr)
        phase("composite", config="edges", **fields)
        comp_err["round"] = max(comp_err["round"], fields["max_abs_err"])
        fields = check_round_count(label, args, thr)
        phase("composite", config="edges", **fields)
        comp_err["round"] = max(comp_err["round"], fields["max_abs_err"])

    # ---- 38. the fused runner on the trained bench field: replayed steps
    # bit for bit eager ones, no host sync, ms/step in turns, the profile
    phase("fused", **fused_phase("bench", system, hatmul, SEED + 100),
          card=card)
    del system, out
    torch.cuda.empty_cache()
    # ---- 41. the fused runner from step 0 (the padded step) on bench
    phase("fused_from_zero", **fused_from_zero("bench", BENCH_HP, datasets,
                                               dev), card=card)
    torch.cuda.empty_cache()

    # ---- 9b. the train phase's configuration under --bf16: ms/step and the
    # held-out view beside phase 9's fp32 ones
    bf16 = start_system(dict(BENCH_HP, bf16=True), datasets, dev)
    hat_prod.launches = hat_prod_bwd.launches = 0
    fields = train_steps(bf16, lambda: dict(
        hat_prod_launches=hat_prod.launches,
        hat_prod_bwd_launches=hat_prod_bwd.launches))
    render_view(bf16, test_rays, test_rcfg)        # warm-up frame
    out, view_ms = render_view(bf16, test_rays, test_rcfg)
    bf16_psnr = float(psnr(out["rgb"], test_rgb))
    phase("train_bf16", **fields, cuts="none (phase 9's configuration)",
          psnr_after=bf16_psnr,
          fp32_ms_per_step=train_fp32["ms_per_step"],
          fp32_psnr_after=psnr_after,
          ms_ratio_bf16_to_fp32=fields["ms_per_step"]
          / train_fp32["ms_per_step"], view_ms=view_ms, card=card)
    check(bf16.model.dtype == torch.bfloat16 and bf16_psnr >= PSNR_MIN
          and fields["hat_prod_launches"] > 0,
          f"--bf16: view {bf16_psnr} dB, {fields['hat_prod_launches']} "
          f"hat_prod launches")
    del bf16, out
    torch.cuda.empty_cache()

    # ---- 13. the MixedFeature bench configuration: one step, card vs CPU,
    # exact and with the sampled-corner table gradient (one corner)
    mf = start_system(MF_HP, datasets, dev)
    occ0 = culled_state(mf, SEED + 6)
    batch = oracle_batch(mf.train_dataset, SEED + 7)
    for mode, m_ in (("exact", 8), ("sampled", 1)):
        mcfg = dataclasses.replace(mf.model_cfg, hash_grad_samples=m_)
        model_c, model_p = (NGP(mcfg, device=d) for d in (dev, "cpu"))
        model_c.load_state_dict(mf.model.state_dict())
        model_p.load_state_dict(mf.model.state_dict())
        rows = None if m_ == 8 else torch.from_numpy(
            np.random.default_rng(SEED + 8).random(
                (N_ORACLE_RAYS * MF_HP["s_max_train"], m_),
                dtype=np.float32))
        fields, grads_c = step_oracle(model_c, model_p, occ0, mf.rcfg,
                                      mf.loss, batch, rows)
        table_norm = float(grads_c["hash_table"].norm())
        phase("train_step_oracle_mf", mode=mode, hash_grad_samples=m_,
              **fields, hash_table_grad_norm=table_norm, card=card)
        check(table_norm > 0, "the hash table got no gradient")
        del model_c, model_p, grads_c
    # ---- 13b and 13c. the trainer's step under --optimize_ext (the hash
    # backward with d_x) and under --bf16, card against CPU
    for label, flags, tols in (
            ("train_step_oracle_ext", dict(optimize_ext=True),
             (LOSS_TOL, GRAD_TOL)),
            ("train_step_oracle_bf16", dict(bf16=True),
             (BF16_LOSS_TOL, BF16_GRAD_TOL))):
        fields = trainer_step_oracle(dict(MF_HP, **flags), datasets, dev,
                                     SEED + 70, hashgrid, *tols)
        phase(label, **fields, card=card)
        torch.cuda.empty_cache()

    # ---- 15a. the held-out view before training (culled + one refresh)
    out, _ = render_view(mf, test_rays, test_rcfg, occ0)
    psnr_before = float(psnr(out["rgb"], test_rgb))
    del occ0, out

    # ---- 14. train the MixedFeature field: 300 steps, 6 timed chunks of 100
    hashgrid_encode.launches = hashgrid_bwd.launches = 0
    march_counts(reset=True)
    composite_counts(reset=True)
    fields = train_steps(mf, lambda: dict(
        hashgrid_fwd_launches=hashgrid_encode.launches,
        hashgrid_bwd_launches=hashgrid_bwd.launches,
        march=march_counts(), composite=composite_counts()))
    fields["march_train_per_step"] = fields["march"]["train"] \
        / fields["steps"]
    phase("train_mf", **fields, card=card)
    march_mf_launches = fields["march"]["train"]
    check_composite_launches("train_mf", fields)
    mf_composite = fields["composite"]
    check(fields["march_train_per_step"] >= 1,
          f"MixedFeature training launched march_train {fields['march']} "
          f"times")
    mf_fwd = fields["hashgrid_fwd_launches"]
    mf_bwd = fields["hashgrid_bwd_launches"]
    check(mf_fwd > 0 and mf_bwd > 0,
          f"training launched hashgrid_fwd {mf_fwd}, hashgrid_bwd {mf_bwd} "
          f"times")

    # ---- 15b. the held-out view after training
    render_view(mf, test_rays, test_rcfg)          # warm-up frame
    hashgrid_encode.launches = 0
    out, view_ms = render_view(mf, test_rays, test_rcfg)
    view_launches = hashgrid_encode.launches
    psnr_after = float(psnr(out["rgb"], test_rgb))
    phase("test_view_mf", wh=WH, T_threshold=TEST_T,
          psnr_before=psnr_before, psnr_after=psnr_after,
          psnr_min=MF_PSNR_MIN, psnr_gain=PSNR_GAIN,
          ms_per_frame=view_ms, samples_per_frame=out["total_samples"],
          rounds=out["rounds"], hashgrid_fwd_launches=view_launches,
          card=card)
    check(bool(torch.isfinite(out["rgb"]).all()), "test view not finite")
    check(view_launches > 0, "render_test never launched hashgrid_fwd")
    check(psnr_after >= MF_PSNR_MIN
          and psnr_after >= psnr_before + PSNR_GAIN,
          f"MixedFeature test PSNR {psnr_before} -> {psnr_after}")
    del out
    # ---- 42b. serve_graphed on the trained MixedFeature view
    serve_mf = serve_graphed("mf", mf.model, mf.occ, test_rays, test_rcfg,
                             test_rgb)
    phase("serve_graphed", **serve_mf, card=card)
    torch.cuda.empty_cache()

    # ---- 12b. the hash-grid kernels on one real step's operands
    captured = capture_bwd_operands(mf, SEED + 9, hashgrid)
    check(len(captured) == 1, f"{len(captured)} hash-grid backward calls")
    params_t, x_t, cfg_t, g_t, win_t, noise_t, need_dx_t = captured[0]
    check(win_t is None and noise_t is None and not need_dx_t,
          "the training step's hash-grid backward is not the exact one "
          "without d_x")
    hash_train = check_hashgrid("train", cfg_t, params_t, x_t, g_t,
                                SEED + 30)
    phase("kernel_hashgrid", **hash_train, card=card)
    del captured, params_t, x_t, g_t

    # ---- 36b. the march kernel on a step of the trained MixedFeature field
    mf_march, err = march_phase(
        "mf", [("step", *step_march_operands(mf, SEED + 82))])
    march_err = max(march_err, err)
    # ---- 37b. the composite kernels on a step of it
    mf_comp, err = composite_phase(
        "mf", [("step", *step_composite_operands(mf, SEED + 93))])
    comp_err = {k: max(v, err[k]) for k, v in comp_err.items()}
    # ---- 39. the fused runner on the trained MixedFeature field
    phase("fused", **fused_phase("mf", mf, hashgrid, SEED + 101), card=card)
    del mf
    torch.cuda.empty_cache()

    # ---- 19. cli: the command line on the procedural scene on disk
    def hat_launches(reset=False):
        if reset:
            hat_prod.launches = hat_prod_bwd.launches = 0
        return dict(hat_prod_launches=hat_prod.launches,
                    hat_prod_bwd_launches=hat_prod_bwd.launches,
                    march=march_counts(reset),
                    composite=composite_counts(reset))

    # ---- 24. the JPEG decoder: the fixtures, an 800x800 file's time
    phase("jpeg", **jpeg_phase(), card=card)

    # ---- 19, then 26-28 on its checkpoint: eval, the orbit, --profile;
    # and 33's --eval_lpips on it, with seeded random LPIPS weights
    lpips_dir = tempfile.TemporaryDirectory()
    lpips_npz = os.path.join(lpips_dir.name, "lpips_vgg.npz")
    lpips_weights_npz(lpips_npz)
    fields, offline = cli_phase(
        dev, hat_launches, lambda argv, ckpt, val_psnr: dict(
            offline_phases(argv, ckpt, val_psnr, dev, hat_launches),
            lpips_val=lpips_validate(argv, ckpt, lpips_npz, dev)))
    phase("cli", **fields, card=card)
    for label in ("eval", "orbit", "profile"):
        phase(label, **offline[label], card=card)
    check(fields["hat_prod_launches"] > 0
          and fields["hat_prod_bwd_launches"] > 0,
          f"the command line launched hat_prod {fields['hat_prod_launches']}"
          f", hat_prod_bwd {fields['hat_prod_bwd_launches']} times")
    check(fields["march"]["train"] >= fields["steps"]
          and fields["march"]["window"] > 0,
          f"the command line launched the marches {fields['march']}")
    cli_march = fields["march"]
    check_composite_launches("cli", fields)
    cli_composite = fields["composite"]
    check(len(fields["results"]) == 2 * CLI_TEST_VIEWS,
          f"results written: {fields['results']}")
    check(fields["test_psnr"] >= PSNR_MIN,
          f"command line test PSNR {fields['test_psnr']}")
    check(abs(fields["val_only_psnr"] - fields["test_psnr"]) <= CLI_PSNR_TOL,
          f"--val_only PSNR {fields['val_only_psnr']} against "
          f"{fields['test_psnr']} in process")
    torch.cuda.empty_cache()

    # ---- 22 and 23. the command line with --optimize_ext on a scene with
    # perturbed training poses, and with --use_exposure on an HDR-NeRF scene
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            ext_run, ext_fused = cli_ext(dev, hat_launches)
            phase("cli_ext", **ext_run, card=card)
            check(ext_run["center_err_after"]
                  < EXT_ERR_SHARE * ext_run["center_err_before"]
                  and ext_run["hat_prod_bwd_launches"] > 0,
                  f"--optimize_ext: centre error "
                  f"{ext_run['center_err_before']} -> "
                  f"{ext_run['center_err_after']}")
            phase("fused", **ext_fused, card=card)
            torch.cuda.empty_cache()
            hdr_run = cli_hdr(dev, hat_launches)
            phase("cli_hdr", **hdr_run, card=card)
            check(hdr_run["hat_prod_launches"] > 0
                  and hdr_run["hat_prod_bwd_launches"] > 0,
                  f"--use_exposure launched {hdr_run}")
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)

    # ---- 20 and 21. the multi-cascade COLMAP path: the scene on disk, one
    # step of each recipe on the card against the CPU, then main
    def hash_launches(reset=False):
        if reset:
            hashgrid_encode.launches = hashgrid_bwd.launches = 0
        return dict(hashgrid_fwd_launches=hashgrid_encode.launches,
                    hashgrid_bwd_launches=hashgrid_bwd.launches,
                    march=march_counts(reset),
                    composite=composite_counts(reset))

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            train_v, test_v, write_s, load_s, _, _ = colmap_views(
                COLMAP_ROOT)
            phase("colmap_scene", root=COLMAP_ROOT, spread=COLMAP_SPREAD,
                  views=[len(train_v), len(test_v)], wh=WH,
                  write_seconds=write_s, load_seconds=load_s, card=card)
            cascade_march, cascade_comp = {}, {}
            for label, argv in (("LowRank", LR360_ARGS),
                                ("MixedFeature", MF360_ARGS)):
                fields = cascade_step_oracle(argv, (train_v, test_v), dev,
                                             SEED + 40)
                phase("train_step_oracle_cascades", recipe=label, **fields,
                      card=card)
                cascade_march[label] = fields["march"]
                march_err = max(march_err, fields["march_max_abs_err"])
                cascade_comp[label] = dict(fields["composite"],
                                           fwd=fields["composite_fwd"],
                                           bwd=fields["composite_bwd"])
                comp_err = {k: max(v, fields["composite_max_abs_err"][k])
                            for k, v in comp_err.items()}
                torch.cuda.empty_cache()
            # ---- 41. the fused runner from step 0 on mf360_black
            phase("fused_from_zero", **fused_from_zero(
                "mf360_black", vars(get_opts(["--root_dir", "",
                                              *MF360_BLACK_ARGS])),
                (train_v, test_v), dev), card=card)
            del train_v, test_v
            torch.cuda.empty_cache()
            runs = {}
            for label, argv, launches, fused in (
                    ("MixedFeature", MF360_ARGS, hash_launches, None),
                    ("MixedFeature_black", MF360_BLACK_ARGS, hash_launches,
                     ("mf360_black", hashgrid)),
                    ("LowRank", LR360_ARGS, hat_launches,
                     ("lr360", hatmul))):
                runs[label], trained = colmap_cli(argv, dev, launches)
                phase("cli_colmap", recipe=label, **runs[label],
                      load_seconds=load_s, card=card)
                if fused is not None:
                    # ---- 40. the fused runner on the trained multi-cascade
                    # field: the padded step's graph past FLAT_AFTER
                    phase("fused", **fused_phase(*fused[:1], trained,
                                                 fused[1], SEED + 102),
                          card=card)
                del trained
                torch.cuda.empty_cache()
            # ---- 25. cli_jpeg: the same scene in JPEG, the LowRank run
            _, _, jpg_write_s, jpg_load_s, jpg_mean, jpg_max = colmap_views(
                COLMAP_JPEG_ROOT, "jpg")
            jpeg_run = colmap_cli(LR360_JPEG_ARGS, dev, hat_launches,
                                  COLMAP_JPEG_ROOT)[0]
            png_run = runs["LowRank"]
            phase("cli_jpeg", root=COLMAP_JPEG_ROOT, **jpeg_run,
                  write_seconds=jpg_write_s, load_seconds=jpg_load_s,
                  load_mean_abs_err=jpg_mean, load_max_abs_err=jpg_max,
                  load_tol=JPEG_LOAD_TOL, png_load_seconds=load_s,
                  png_ms_per_step=png_run["ms_per_step"],
                  png_test_psnr=png_run["test_psnr"], card=card)
            check(min(jpeg_run["hat_prod_launches"],
                      jpeg_run["hat_prod_bwd_launches"]) > 0,
                  f"the JPEG COLMAP run launched {jpeg_run}")
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    colmap_mf, colmap_lr = runs["MixedFeature"], runs["LowRank"]
    for label, run in runs.items():
        counts = [v for key, v in run.items() if key.endswith("_launches")]
        check(len(counts) == 2 and min(counts) > 0,
              f"the COLMAP run {label} launched {counts}")
        check(run["march"]["train"] >= run["steps"]
              and run["march"]["window"] > 0,
              f"the COLMAP run {label} launched the marches {run['march']}")
        check_composite_launches(f"cli_colmap {label}", run)


    # ---- 16-18. the encoder formulation probes: each run() at the probe's
    # shape is its kernels' path, then a run at a ragged size
    probes = {}
    for label, probe, kernels in (
            ("probe_gather", probe_gather, (table_lerp,)),
            ("probe_gather2", probe_gather2, (table_lerp, hat_basis_dw)),
            ("probe_hatmul", probe_hatmul, (hat_prod,))):
        for fn in kernels:
            fn.launches = 0
        res = probe.run(dev, SEED)
        counts = {fn.__name__: fn.launches for fn in kernels}
        ragged = probe.run(dev, SEED + 1, N_RAGGED)
        failed = res["failed"] + ragged["failed"]
        dw_sets = {}
        if probe is probe_gather2:     # hat_basis_dw on sorted u and knots
            for kind in ("sorted", "knots"):
                u_set, g_set = probe.dw_operands(kind, probe.N, SEED + 2, dev)
                dw_sets[kind] = probe.dw_row(u_set, g_set, failed,
                                             f"hat_basis_dw ({kind})")
                del u_set, g_set
        phase(label, **res["kernels"], launches=counts,
              ragged=ragged["kernels"], **dw_sets, failed=failed, card=card)
        check(not failed, f"{label}: {failed}")
        check(min(counts.values()) > 0, f"{label} launched {counts}")
        probes[label] = dict(res["kernels"], launches=counts, **dw_sets)
    lerp_idx = probes["probe_gather"]["table_lerp"]
    lerp_u = probes["probe_gather2"]["table_lerp"]
    probe_dw = probes["probe_gather2"]["hat_basis_dw"]
    probe_hat = probes["probe_hatmul"]["hat_prod"]

    # ---- 29. the distributed path at W = 1 (NCCL) against the plain steps
    fields = dp_one(datasets, dev)
    phase("dp_one", **fields, card=card)
    check(fields["bitwise_equal"], "W = 1 through the distributed path "
          "differs from the plain steps")
    torch.cuda.empty_cache()

    # ---- 30-31. two ranks sharing the card (gloo) against one; then
    # render_test_sharded, and --num_gpus beyond the machine's cards
    two, render, failed = dp_two(datasets, dev)
    for label, fields in two.items():
        phase("dp_two", recipe=label, **fields, card=card)
    phase("dp_render", **render, refused=num_gpus_refused(), card=card)
    check(not failed, f"two ranks: {failed}")
    torch.cuda.empty_cache()

    # ---- 32. the fp32 hat kernels (lr_matmul_dtype="float32")
    fp32 = hat_fp32(u, w3, k, datasets, dev, hat_launches)
    phase("hat_fp32", **fp32, card=card)

    # ---- 33. LPIPS: a pair of 800x800 views, card against CPU; the cli
    # checkpoint's --val_only --eval_lpips (run in phase 19's directory)
    lpips_fields = lpips_pair(lpips_npz, train_scene["images"][:2], dev)
    phase("lpips", **lpips_fields, validate=offline["lpips_val"], card=card)
    lpips_dir.cleanup()

    # ---- 34. the OpenEXR decoder at RTMV's frame size (host only)
    phase("exr", **exr_phase(), card=card)

    # ---- 35. cli_rtmv: RTMV's EXR frames through prepare_rtmv, then the
    # RTMV recipe through main, beside the same scene in PNG
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            rtmv = cli_rtmv(dev, hash_launches)
        finally:
            os.chdir(cwd)
    phase("cli_rtmv", **rtmv, card=card)
    rtmv_gap = abs(rtmv["runs"]["exr"]["test_psnr"]
                   - rtmv["runs"]["png"]["test_psnr"])
    check(rtmv_gap <= RTMV_PSNR_TOL,
          f"RTMV test PSNR from EXR {rtmv['runs']['exr']['test_psnr']} "
          f"against PNG {rtmv['runs']['png']['test_psnr']}")

    fwd_bound_ms, fwd_bound_by = fwd_bound(N_KERNEL, k, w3.shape[2])
    fp32_train = fp32["train"]["float32"]
    print(json.dumps({"kernels": [{
        "name": "hat_prod", "route": "cuda", "source": src,
        "replaces": "mfnerf_tpu/ops/hatmul.py:54",
        "launches": launches_fwd,
        "cli_colmap_launches": colmap_lr["hat_prod_launches"],
        "offline_launches": {label: offline[label]["hat_prod_launches"]
                             for label in ("eval", "orbit", "profile")},
        "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": fwd_bound_ms,
        "bound_by": fwd_bound_by, "library_ms": None,
        "fp32": {
            "launches": fp32_train["hat_prod_launches"],
            "max_abs_err": fp32["fwd"]["max_abs_err"],
            "ms": fp32["fwd"]["ms"], "plain_ms": fp32["fwd"]["plain_ms"],
            "bound_ms": fp32["fwd"]["bound_ms"],
            "bound_by": fp32["fwd"]["bound_by"], "library_ms": None,
            "train_frame_ms": fp32["train_frame"]["fwd_ms_float32"],
            "train_frame_bound_ms": fp32["train_frame"]["fwd_bound_ms"]}},
        {
        "name": "hat_prod_bwd", "route": "cuda", "source": src,
        "replaces": "mfnerf_tpu/ops/hatmul.py:68",
        "launches": launches_bwd,
        "cli_colmap_launches": colmap_lr["hat_prod_bwd_launches"],
        "cli_ext_du_launches": ext_run["hat_prod_bwd_du_launches"],
        "train_du_ms": ext_run["bwd_du"]["ms"],
        "train_du_bound_ms": ext_run["bwd_du"]["bound_ms"],
        "max_abs_err": bwd_uniform["dw_max_abs_err"],
        "ms": bwd_uniform["ms"], "plain_ms": bwd_uniform["plain_ms"],
        "bound_ms": bwd_uniform["bound_ms"],
        "bound_by": bwd_uniform["bound_by"], "library_ms": None,
        "fp32": {
            "launches": fp32_train["hat_prod_bwd_launches"],
            "max_abs_err": fp32["bwd"]["dw_max_abs_err"],
            "ms": fp32["bwd"]["ms"], "plain_ms": fp32["bwd"]["plain_ms"],
            "bound_ms": fp32["bwd"]["bound_ms"],
            "bound_by": fp32["bwd"]["bound_by"], "library_ms": None,
            "train_frame_ms": fp32["train_frame"]["bwd_ms_float32"],
            "train_frame_bound_ms": fp32["train_frame"]["bwd_bound_ms"]}},
        {
        "name": "hashgrid_fwd", "route": "cuda", "source": hash_src,
        "replaces": "mfnerf_tpu/ops/hashgrid.py:197",
        "launches": mf_fwd,
        "cli_colmap_launches": colmap_mf["hashgrid_fwd_launches"],
        "cli_rtmv_launches": rtmv["runs"]["exr"]["hashgrid_fwd_launches"],
        "max_abs_err": hash_train["fwd_max_abs_err"],
        "ms": hash_train["fwd_ms"], "plain_ms": hash_train["fwd_plain_ms"],
        "bound_ms": hash_train["fwd_bound_ms"],
        "bound_by": hash_train["fwd_bound_by"], "library_ms": None}, {
        "name": "hashgrid_bwd", "route": "cuda", "source": hash_src,
        "replaces": "mfnerf_tpu/ops/hashgrid.py:246",
        "launches": mf_bwd,
        "cli_colmap_launches": colmap_mf["hashgrid_bwd_launches"],
        "cli_rtmv_launches": rtmv["runs"]["exr"]["hashgrid_bwd_launches"],
        "train_dx_ms": hash_train["bwd_dx_ms"],
        "train_dx_bound_ms": hash_train["bwd_dx_bound_ms"],
        "max_abs_err": hash_train["exact_dp_max_abs_err"],
        "ms": hash_train["bwd_ms"], "plain_ms": hash_train["bwd_plain_ms"],
        "bound_ms": hash_train["bwd_bound_ms"],
        "bound_by": hash_train["bwd_bound_by"], "library_ms": None}, {
        "name": "table_lerp", "route": "cuda", "source": line_src,
        "replaces": "benchmarking/probe_pallas_gather.py:60, "
                    "benchmarking/probe_pallas_gather.py:105, "
                    "benchmarking/probe_pallas_gather2.py:88",
        "launches": probes["probe_gather"]["launches"]["table_lerp"]
        + probes["probe_gather2"]["launches"]["table_lerp"],
        "max_abs_err": max(lerp_idx["max_abs_err"], lerp_u["max_abs_err"]),
        "ms": lerp_u["ms"], "plain_ms": lerp_u["plain_ms"],
        "bound_ms": lerp_u["bound_ms"], "bound_by": lerp_u["bound_by"],
        "library_ms": lerp_u["library_ms"], "shape": "probe_gather2, u mode",
        "idx_mode": {key: lerp_idx[key] for key in (
            "n", "ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")}}, {
        "name": "hat_basis_dw", "route": "cuda", "source": line_src,
        "replaces": "benchmarking/probe_pallas_gather2.py:143",
        "launches": probes["probe_gather2"]["launches"]["hat_basis_dw"],
        "max_abs_err": probe_dw["max_abs_err"], "ms": probe_dw["ms"],
        "plain_ms": probe_dw["plain_ms"], "bound_ms": probe_dw["bound_ms"],
        "bound_by": probe_dw["bound_by"], "library_ms": None,
        "sets": {kind: {key: probes["probe_gather2"][kind][key] for key in (
            "ms", "bound_ms", "max_abs_err", "order_model_equal")}
            for kind in ("sorted", "knots")}}, {
        "name": "hat_prod_probe", "route": "cuda", "source": src,
        "replaces": "benchmarking/probe_pallas_hatmul.py:89",
        "launches": probes["probe_hatmul"]["launches"]["hat_prod"],
        "max_abs_err": probe_hat["max_abs_err"], "ms": probe_hat["ms"],
        "plain_ms": probe_hat["plain_ms"], "bound_ms": probe_hat["bound_ms"],
        "bound_by": probe_hat["bound_by"], "library_ms": None,
        "shape": "probe_hatmul: N 2^19, K 513, R 128"}, {
        "name": "march_train", "route": "cuda", "source": march_src,
        "replaces": "mfnerf_tpu/ops/ray_march.py:107, "
                    "mfnerf_tpu/ops/ray_march.py:220, "
                    "mfnerf_tpu/ops/ray_march.py:388",
        "launches": march_train_launches,
        "launches_per_step": march_train_launches / train_fp32["steps"],
        "train_mf_launches": march_mf_launches,
        "cli_launches": cli_march["train"],
        "cli_colmap_launches": {label: run["march"]["train"]
                                for label, run in runs.items()},
        "max_abs_err": march_err, **{key: bench_march["train"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "shape": "bench.py's step: 8192 rays, the two-level strata",
        "registers": ptxas["march_train_kernel"],
        "mf": {key: mf_march["train"][key] for key in (
            "rays", "ms", "plain_ms", "bound_ms", "bound_by")},
        "cascades": {label: m["train"] for label, m in
                     cascade_march.items()}}, {
        "name": "march_window", "route": "cuda", "source": march_src,
        "replaces": "mfnerf_tpu/ops/ray_march.py:876",
        "redesigned": "in place through the alive index, 4-32 lanes a "
                      "ray, the two-level stage-A skip over the window's "
                      "strata at one cascade",
        "launches": serve_window_launches,
        "cli_launches": cli_march["window"],
        "cli_colmap_launches": {label: run["march"]["window"]
                                for label, run in runs.items()},
        "max_abs_err": march_err, **{key: bench_march["window"][key]
                                     for key in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by",
                                                 "rung_by_rung_ops_ms",
                                                 "lanes")},
        "library_ms": None,
        "shape": "the first round of the trained bench field's held-out "
                 "800x800 view",
        "frame_rounds": bench_march["window_rounds"],
        "count": {key: bench_march["window_count"][key] for key in (
            "rows", "count", "ms", "bound_ms", "bound_by", "share_of_bound",
            "max_abs_err")},
        "cascades": {label: m["window"] for label, m in
                     cascade_march.items()}}, {
        "name": "composite_train", "route": "cuda", "source": comp_src,
        "replaces": "mfnerf_tpu/ops/composite.py:35",
        "launches": train_composite["fwd"],
        "launches_per_step": train_composite["fwd"] / train_fp32["steps"],
        "train_mf_launches": mf_composite["fwd"],
        "cli_launches": cli_composite["fwd"],
        "cli_colmap_launches": {label: run["composite"]["fwd"]
                                for label, run in runs.items()},
        "max_abs_err": comp_err["fwd"], **{key: bench_comp["train"][key]
                                           for key in ("ms", "plain_ms",
                                                       "bound_ms",
                                                       "bound_by")},
        "library_ms": None,
        "shape": "bench.py's step on the trained field: 8192 rays, 64 "
                 "slots a row",
        "redesigned": "rows of up to four passes in registers, each "
                      "operand loaded once; passes masked on the whole warp "
                      "skip their scans; a warp's sums traded between its "
                      "lanes (warp_sums)",
        "passes": bench_comp["train"]["fwd_passes"],
        "fwd_walk_ms": bench_comp["train"]["fwd_walk_ms"],
        "registers": ptxas["composite_train_fw"],
        "mf": {key: mf_comp["train"][key] for key in (
            "rays", "ms", "plain_ms", "bound_ms", "bound_by", "fwd_walk_ms",
            "fwd_passes")},
        "cascades": {label: c["train"] for label, c in
                     cascade_comp.items()}}, {
        "name": "composite_train_bwd", "route": "cuda", "source": comp_src,
        "replaces": "mfnerf_tpu/ops/composite.py:35 (its VJP)",
        "launches": train_composite["bwd"],
        "launches_per_step": train_composite["bwd"] / train_fp32["steps"],
        "train_mf_launches": mf_composite["bwd"],
        "cli_launches": cli_composite["bwd"],
        "cli_colmap_launches": {label: run["composite"]["bwd"]
                                for label, run in runs.items()},
        "max_abs_err": comp_err["bwd"],
        **{key: bench_comp["train"]["bwd_" + key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": "the same step, the loss's incoming gradients (opacity, "
                 "rgb), d_sigmas and d_rgbs",
        "redesigned": "rows of up to four passes in registers, loaded "
                      "once; passes with no included sample skip their "
                      "scans",
        "passes": bench_comp["train"]["bwd_passes"],
        "two_walk_ms": bench_comp["train"]["bwd_two_walk_ms"],
        "registers": ptxas["composite_train_bw"],
        "mf": {key: mf_comp["train"]["bwd_" + key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "two_walk_ms",
            "passes")},
        "cascades": {label: c["bwd"] for label, c in
                     cascade_comp.items()}}, {
        "name": "composite_test_step", "route": "cuda", "source": comp_src,
        "replaces": "mfnerf_tpu/ops/composite.py:489",
        "launches": serve_rounds,
        "cli_launches": cli_composite["round"],
        "cli_colmap_launches": {label: run["composite"]["round"]
                                for label, run in runs.items()},
        "max_abs_err": comp_err["round"], **{key: bench_comp["round"][key]
                                             for key in ("ms", "plain_ms",
                                                         "bound_ms",
                                                         "bound_by")},
        "library_ms": None,
        "shape": "the first round of the trained bench field's held-out "
                 "800x800 view at T 1e-4",
        "count": {key: bench_comp["round_count"][key] for key in (
            "rows", "count", "ms", "bound_ms", "bound_by", "share_of_bound",
            "max_abs_err")},
        "cascades": {label: c["round"] for label, c in
                     cascade_comp.items()}}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
