#!/usr/bin/env python3
"""Smoke run of nerf_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel under nerf_tpu_torch/csrc with plain nvcc, all at once,
     and print ptxas's registers, stack and spills for each kernel entry (the
     wgmma kernels must not spill);
  3. each kernel against its plain PyTorch version on random inputs (the
     fused MLP on 65,536 points; integrate with and without ERT, relu,
     softplus and exp, S = 64 and 192 at N = 8192 and 1024); the fused MLP's
     wgmma path: one layer's product against torch.matmul, 84,525 random
     points (5 rounds of the persistent grid and a ragged tile) against the
     plain version, and every ragged prefix (1, 63, 64, 127, 128, 129,
     65,553 points) launched alone, exactly equal to the same rows of that
     launch; B2's weight-gradient product (MN-major operands) against
     torch.matmul;
  4. serve: a RenderService for configs/nerf/lego.yaml with the committed
     checkpoint (ESS grid rebuilt through the fused kernel), an HTTP server
     on 127.0.0.1, one warm-up GET /frame at 200x200 (the startup figure),
     then a timed window of 32 requests at distinct poses; the launch
     counters are zeroed before the service is built and read after the
     window, and every kernel must have been launched;
  5. each kernel against its plain version at the serving path's own
     shapes and inputs (the first and the last render tile of the warm-up
     pose, coarse and fine, and one ESS lattice slab), and each kernel's
     time on the first tile's fine pass, with its bound from those inputs;
     the fused MLP also on the first tile's coarse pass, beside a chain of
     bf16 torch.matmul calls with float32 epilogues (a yardstick, printed on
     its own line); integrate on the first tile's fine and coarse passes
     (CUDA graphs of launches);
  6. the warm-up pose rendered through the plain versions; PSNR >= 40 dB;
  7. train: the committed epoch-49 lego state (params, Adam's moments and
     counts) copied to a temp directory and resumed through the trainer's
     entry point (python -m nerf_tpu_torch.train, called in-process) with
     configs/nerf/lego.yaml at full width on the in-memory synthetic scene
     at lego's size (100 images, 800x800): epoch 50, 500 steps of 1024 rays,
     then an ESS rebuild and the final checkpoint. The launch counters are
     zeroed before and read after, and every kernel must have been launched;
     every logged loss must be finite; the checkpoint must hold 147 leaves,
     step 13000, and load back through the port's load_checkpoint;
  8. from the state that run resumed (epoch 49) and its ESS grid, on one
     batch of 1024 rays of the model's own renders at 8 orbit poses: the fused backward (B2) against its plain version
     on the step's own coarse and fine inputs with the real loss's upstream
     gradients (its recomputed forward equal to fused_nerf_eval's output
     bit for bit, its mask bits those of its stash), and the whole train
     step (loss and every parameter gradient) through the kernels against
     the same step through the plain versions;
  9. 10 steps on the kernel path against 10 on the plain path from that
     state with the same batches;
 10. times: a window of warm train steps (ms per step, train rays/s, the
     kernels' launches per step); B2 on the step's coarse and fine batches,
     each of its five launches alone, its bound and this design's byte
     floor;
     on the fine batch also its plain version and a yardstick, its products
     as bf16 torch.matmul calls over the unpacked stash and gbuf;
 11. the hash-grid model, configs/nerf/lego_hashgrid_cellpack.yaml at full
     width (16 levels x 2 features, 2^19 cellpack tables of [16, 65536, 16]
     bf16, the 4x128 MLP), trained from init_hashgrid tables through the
     trainer's entry point on the same synthetic scene: one epoch cut to
     HASH_TRAIN_STEPS steps of 1024 rays (the config has 500), an ESS rebuild
     through the hash density, a checkpoint of 105 leaves in a temp directory;
     the counters are zeroed before and read after, and the gather, its
     scatter-add and integrate must have been launched;
 12. that checkpoint served by RenderService at 200x200 over HTTP: one
     warm-up request and a timed window of HASH_N_TIMED requests; then the
     gather and integrate against their plain versions on the first and the
     last render tile's own indices, rows and samples, and the frame through
     the kernels against the frame through the plain versions (PSNR >= 40);
 13. one hash-grid train step on random colours at 8 orbit poses:
     the scatter-add on the step's own fine indices and cotangents against
     its plain version, and the whole step (loss and every gradient) through
     the kernels against the plain versions, from the trained state (a leaf
     whose gradient norm is below HASH_SMALL_LEAF of the largest leaf's held
     in absolute distance, and printed) and from the initial parameters
     (init_nerf_params: every leaf at the relative bound, the norms printed);
 14. times: a window of warm hash-grid train steps, and the gather and the
     scatter-add on that step's fine batch (3,145,728 rows) beside their
     bounds, their plain versions and one PyTorch call each; the
     scatter-add's three launches alone and its design's byte floor; the
     gather, exact against plain on those rows, beside its sector floor
     (hash_gather.gather_bytes); integrate on the hash-grid serving tiles
     and the train step's batches (N = 1024, S = 64 and 192), and the
     launches x (time - bound) of integrate per request and per step.
 15. a Blender-layout scene in a temp directory: the epoch-49 lego model
     rendered through the kernels at 800x800 (lego's camera_angle_x) at 8
     test, 2 val and 8 train poses on the orbit, written as RGBA PNGs by the
     port's encoder (alpha from acc_map, the colour un-whitened, so that the
     loader's white composite gives the render back within 8-bit rounding;
     each test view's jitter seeded as the evaluator seeds it) with a
     transforms_*.json a split; every PNG decoded and compared exactly with
     what was encoded; the encode and decode rates (frames/s);
 16. python -m nerf_tpu_torch.run --type dataset, then --type network (called
     in-process) on that scene: the 800x800 frame's ms and rays/s over 5
     frames, the first dropped;
 17. --type evaluate with write_video True and render_num 8: the counters
     must show B1 and B3; every view at PSNR >= 40 dB and SSIM >= 0.99
     against the scene's PNGs (the same model's renders, rounded to 8
     bits); the 8 spiral frames and both videos of 8 frames. Then
     ess_compaction auto (the calibrated fraction printed), and a fixed
     fraction COMPACTION_MARGIN x the probe's measured kept rate: the
     compacted frame against the dense frame (PSNR >= 40 dB), B1 on one
     compacted [cap, 1, 3] fine batch against its plain version (phase 5's
     gates), the compacted and dense frame times in turns;
 18. --type marched: the hierarchical and the marched frame's time and PSNR
     against the scene; at 100x100 the marched frame through the kernels
     against the plain versions (PSNR >= 40 dB); one hash-grid test view at
     200x200, rendered from phase 11's model and written the same way,
     through --type evaluate (B4's gather and integrate launched; PSNR >= 40);
 19. python -m nerf_tpu_torch.train on the Blender scene (train_dataset_module
     blender, lego's default), the epoch-49 state resumed for one epoch of
     BLENDER_TRAIN_STEPS steps, an ESS rebuild and one validation on the val
     split (its "val psnr" line must appear, a skip warning fails); B1, B2
     and B3 launched; then --test on the checkpoint it wrote;
 20. B1-f32 and B2-f32 (float32 weights; B2-f32's weight gradients in
     3xTF32 on the tensor cores, the rest float32 on the CUDA cores)
     against their float32 plain versions on random points at 1, 63, 64,
     127, 128, 129, 65,553 and 196,608 (the backward with the knife-edge
     points' cotangents zeroed on both sides), and every ragged prefix
     launched alone against the same rows of the largest launch; on the
     196,608 points B2-f32's weight-gradient launch and its four launches
     timed, both bounds and their shares, and each leaf's distance from the
     plain version summed in float64 beside the plain version's in float32;
 21. the committed lego checkpoint served with network.dtype float32 at
     200x200 over HTTP (B1-f32 and B3 launched); its frame against the plain
     float32 path (>= 40 dB) and against the bf16 frame (printed); B1-f32 on
     the first tile's fine pass against its plain version and timed;
 22. the epoch-49 lego state trained with network.dtype float32 through the
     trainer's entry point (B1-f32, B2-f32, B3 launched); one step through
     the kernels against the plain float32 path with the same fine samples
     and masking, and that step's loss and gradients timed over 10 warm
     calls; B2-f32 on that step's inputs, and timed on its fine batch as in
     phase 20;
 23. a D=4, W=64, skips [2], 6/2-band NeRF, with and without view
     directions, trained through the entry point (its MLP in plain PyTorch,
     B3 launched) and served over HTTP; its frame through B3 against B3's
     plain version (>= 40 dB);
 24. one train_full_image step of lego (bf16) at 200x200 through the entry
     point (B1, B2, B3 launched, the rays/s line counting H x W); then one
     such step through the kernels against the plain path at phase 8's
     bounds, its ms and its peak device memory;
 25. python -m nerf_tpu_torch.bench as a subprocess, in a working directory
     where the JAX package's checkpoint path holds the committed lego
     checkpoint: its JSON line (forward and train rays/s, reps, spreads)
     all finite and > 0;
 26. the ESS/ERT harnesses, each in its own working directory:
     quick_ess_ert; ess_ert on 3 test views of phase 15's scene at
     ESS_ERT_SIZE (B3 against its plain version on its baseline tiles, ERT
     off); performance_test (four run --type network subprocesses); each
     writes only its own file, and the committed ess_ert_results.json
     stays as it is;
 27. python -m nerf_tpu_torch.distill_kilonerf (in-process) from the
     committed teacher copied to a temp directory: KILO_STEPS steps of
     65,536 points, the loss at the end below the loss at the start, the
     student-against-teacher PSNR printed (no bound); B1 (the teacher and
     its ESS grid) and B3 (the comparison render) launched; B1 against its
     plain version on the first teacher batch;
 28. the distilled model through configs/nerf/lego_kilonerf.yaml: run --type
     network at 800x800 on the scene, ms a frame (B3 launched, B1 not);
     KILO_N_TIMED 200x200 requests over HTTP; its frame through B3 against
     B3's plain version (>= 40 dB) and B3 on its tiles; kilonerf_eval on
     KILO_CHECK_POINTS points of the fine tile against the per-point
     evaluation in float64 (served points within KILO_REL, dropped points
     exactly 0; the error with TF32 products printed beside it); the served
     points per round on the 1,572,864-point fine tile; its time and the
     grouped products' share under torch.profiler, also of a request; one
     ESS-rebuild slab through the density with no point dropped (65,536 of
     them against float64), and the drop rate the JAX package's capacity
     gives on one lattice plane;
 29. lego data-parallel at world 1 over NCCL: python -m nerf_tpu_torch.train
     in a subprocess with distributed True and torchrun's environment for
     world 1, the epoch-49 state (bf16, 1024 rays, 64 + 128 samples, ESS) on
     8 synthetic 800x800 images for 2 epochs of DP_STEPS steps, against the
     same run in-process without distributed: the params equal bit for bit
     (else within BWD_FRO_REL of the update), B1, B2 and B3 launched (the
     rank's last line);
 30. the same state trained 2 epochs of DP2_STEPS steps by two ranks sharing
     the card over gloo (dist_backend gloo) against world 1 in-process: losses
     within STEP_LOSS_REL, params within BWD_FRO_REL of the update, rank 1
     silent, ms a step of the second epoch from rank 0's epoch line; if gloo
     refuses CUDA tensors (its own message; any other failure fails) the
     phase prints that and ends;
 31. KiloNeRF (configs/nerf/lego_kilonerf.yaml at full width: 16^3
     networks, hidden 32, 4 dispatch rounds, 1024 rays) trained from
     init_nerf_params on phase 15's scene through the entry point, one
     epoch of KILO_TRAIN_STEPS steps: the loss falls, B3 launched twice a
     step and B1 never; one step through B3 against B3's plain version with
     the same batch and fine samples (loss within STEP_LOSS_REL, every leaf
     within KILO_GRAD_REL of its largest |value|);
 32. kilonerf_eval_ep at world 1 over NCCL (this process as the rank) on
     that step's 196,608-point fine batch with the trained fine model,
     against the dense kilonerf_eval at capacities that serve every point:
     equal bit for bit, both timed; under the same group, phase 29's step
     (phase 10's setting) through make_sharded_train_step with the group and
     without one, in turns of DP_TIMED steps, each to a synchronize (the
     medians), and the gradient all-reduce alone; bench_scaling's main at world 1 in a temp
     directory (its one rank over NCCL): its record, the only file;
 33. every encoder type of nerf_tpu_torch.models.encoders.get_encoder at the
     JAX package's defaults (ENC_CFGS; the aliases share their code) on a
     lego step's fine batch of 196,608 points (xyz uniform in the bbox, t
     uniform over frames 0-59, or over [0, 1] for the D-NeRF types; unit
     directions for SH): forward and backward of sum(out^2) through the
     kernels and through the plain path (plain=True) on the same tree:
     outputs equal (the 3-D grids that take the hash encoder's kernels:
     within twice their interp_tolerance, and the rows' cotangent of each
     hash_interp_bwd equal to hash_interp_bwd_plain's on the same cotangent
     and points), each bf16 table's gradient per
     element within hash_gather.scatter_add_tolerance of the plain
     scatter-add of the same cotangent rows, every float32 leaf within ENC_LEAF_REL of its largest
     |value|; B4 and B4' launched once a table under every hash-based type
     and never under frequency, SH, tri-plane and the frequency or tri-plane
     D-NeRF; each type's ms; B4 and B4' alone on the cuda_hashgrid_4d rows
     (16 corners x 16 levels x 196,608 = 50,331,648 rows of 4 bytes) and the
     hashgrid rows (25,165,824), each with its bound and library call, B4
     exact against plain there, beside its sector floor (their
     "encoder_shapes" in the kernels line);
 34. configs/img_fit/lego_view0.yaml on view 0 of phase 15's scene
     (input_ratio 0.5, N_pixels 8192) through python -m
     nerf_tpu_torch.train's main for IMG_FIT_EPOCHS epochs, then run --type
     evaluate: the loss finite and falling, metrics.json and gt_pred.png
     written, the checkpoint loaded back, no kernel launched; one step's
     loss and gradients on the card against the CPU's with TF32 allowed
     (within IMG_FIT_STEP_REL); the PSNR and ms a warm step;
 35. a light-stage rig (4 cameras x 2 frames at 1024x1024, non-zero
     distortion) through the loader at ratios 1.0 and 0.5 on this machine,
     which has no cv2: train batches of 1024 rays and a test image, rays
     finite and of unit direction, an rgb row a ray; host ms of a first
     read and of a batch;
 36. configs/nerf/lego_400_coarse.yaml (N_importance 0) trained COARSE_STEPS
     steps from a fresh init on 100 synthetic 400x400 images through the
     trainer's entry point, then served at 200x200: one B1, B2 and B3 launch
     a step and one B1 and B3 a render tile (no fine pass), the fine MLP's
     Adam moments all zero;
 37. configs/nerf/lego_hashgrid.yaml (the corner layout) trained
     CORNER_STEPS steps from a fresh init on the synthetic scene, then
     served; one step's gathers (exact) and scatter-adds against their plain
     versions and the whole step against the plain path (phase 13's gate);
     B4 and B4' on its fine batch (CORNER_ROWS rows of 4 bytes) beside their
     bounds and library calls, B4 also exact against plain there, beside
     its sector floor ("corner_nerf" in the kernels line); ms a
     step and a request beside the cellpack model's (phases 12, 14);
 38. each of the 7 other nerf_synthetic scene yamls trained SCENE_STEPS
     steps at full width from a fresh init on a 2-frame 800x800 scene
     written under its own name;
 39. the native image loader: built from nerf_tpu_torch/native/loader.cpp
     with g++ where libpng's and libjpeg's headers are installed, else the
     reason recorded and the PNG path run (one warning); phase 15's test
     split through the Blender loader; a JPEG written by cv2 decoded within
     1 of 255 of cv2's, or, without the library, refused with its name;
 40. python -m nerf_tpu_torch.extract_mesh on the committed lego model at
     MESH_RES^3 (the lattice through B1, its launches counted), the lattice
     alone timed; at MESH_CHECK_RES^3 the kernel's densities and mesh
     against the plain path's;
 41. the committed lego weights as a reference-format .pth, ported by
     python -m nerf_tpu_torch.port_torch_checkpoint and served over HTTP:
     the frame at the warm-up pose equal to phase 4's bit for bit;
 42. a COLMAP model of phase 15's train views through python -m
     nerf_tpu_torch.colmap2nerf (poses within 1e-6 of the views' own after
     its recentring and scaling), read by the Blender loader, and
     COLMAP_STEPS train steps on it from a fresh init;
 43. the helpers on the card against the same functions on the CPU:
     get_near_far on the 640,000 rays of one 800x800 lego view against the
     scene's box (the ESS grid's [-2, 2]^3, which every ray of the view
     hits) and its central half (which some miss): hits equal, near and far
     within 1e-6; heatmap_nms on a [4, 80, 128, 128] float32 heatmap
     without ties, in [0, 1) and shifted negative, then topk (K = 40) and
     gather_feat on it (equal); a torch.profiler trace
     (utils/profiling.trace) of one warm 200x200 lego render, whose Chrome
     trace must name B1's and B3's kernels; and memory_stats(), which must
     report the card's bytes in use and peak;
 44. the multi-tensor Adam kernel (csrc/adam.cu) on the committed lego
     state's 48 leaves (nerf_tpu_torch/tools/adam_check.py): 3 steps equal
     to step_plain's bit for bit (p, mu, nu); its time by CUDA events, warm
     (L2 evicted before each launch, and back to back in a CUDA graph)
     beside its byte bound and step_plain's time, and the host's time a
     step of each. Phase 7 must have launched it;
 45. Instant-NGP's train path (nerf_tpu_torch/configs/lego_ngp.yaml, a seeded
     state; nerf_tpu_torch/tools/ngp_check.py): B4 on the float32 table's
     8-byte rows at 2^18 points x 128 corner rows, exact against
     gather_rows_plain, and B4' (float32, no rounding pass) into its
     8,388,608 rows against scatter_add_rows_plain; one train step of 4,096
     rays x 64 samples with the launch counters zeroed just before it (one
     launch each of B4, B4', B3 and Adam); the Adam kernel with the L2 and
     the zero-gradient skip, 2 steps equal to step_plain's bit for bit, its
     skip count equal to the table gradient's zeros; the step's launches
     include one each of the hash encoder's three kernels;
 46. the hash encoder's kernels (nerf_tpu_torch/ops/hash_encode.py) on that
     state's float32 table at 2^18 points, an eighth of them on cell faces,
     the clamp's edge or outside the box (ngp_check.encoder): hash_index
     equal to hashgrid_index on the card, hash_interp and hash_interp_bwd
     equal to their plain versions, hash_interp within interp_tolerance of
     encode_torch, one forward and backward of encode_fused with no host
     synchronisation, its five launches and its table gradient within
     scatter_add_tolerance; each kernel's time by CUDA events beside its
     byte bound and its plain version (hash_index's: the PyTorch path's
     index arithmetic itself), and the encoder's forward and backward on either path (rows of the kernels
     line).
Phase 3 also holds the gather (exact) and the scatter-add against their
plain versions on random tables of the config's sizes (cellpack, and the
corner layout's [16 x 2^19, 2]) at 3,145,728 rows indexed as the hash
encoder indexes random points, and the scatter-add, against its plain
version, at 3,145,728 rows of every index mix of
tools/scatter_variants.py (all one row; runs of 31, 32, 33 and 1,000 equal
indices across warp edges; sorted; uniform) in both layouts.
The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Any failure exits non-zero before either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

T0 = time.perf_counter()

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores, float32 without tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Tolerances:
# - fused MLP (bf16), err = |k - p| / (1 + |p|) per output, k the kernel and
#   p the plain version: both round every activation to bf16 and sum in
#   float32 in another order, so a sum next to a bf16 rounding boundary
#   rounds differently and the flip grows through the later layers. On each
#   input the 99th percentile of err <= 1e-3 (set before the first run) and
#   the 99.9th <= 1e-2. The largest err has no fixed bound: on the path's
#   inputs the plain version differs from itself summed in float64 by up to
#   0.21 (python -m nerf_tpu_torch.tools.fused_accuracy, H100), so the
#   largest err over every input checked must stay within twice the largest
#   err of that float64 plain version over the same inputs. (A fixed 5e-2,
#   set from 65,536 random points, held there but not on the path's tiles.)
# - integrate (float32): atol 2e-5 on rgb/depth/acc/weights, as
#   tests/test_integrate_kernel.py (sums of up to 192 terms in another order),
#   against the plain version; with ERT, a weight is
#   exactly 0 wherever the plain version's transmittance T is below the
#   threshold, outside the band where the two float32 sums of log T (S terms
#   in other orders) may put T on either side of it: |T - ert| <= ert
#   (e^m - 1), m = S 2^-23 |log ert| (integrate.past_the_cut; 1e-4 of ert at
#   S = 192). The samples in that band and the side each fell on are printed.
# - whole frame, kernels against plain versions: PSNR >= 40 dB.
# - fused backward (B2, bf16), on the train path's own coarse and fine
#   inputs, for every gradient leaf, dpts and ddirs:
#   (a) against the plain backward run on the kernel's own recomputed
#       forward (its activation stash), so that both multiply the same bf16
#       activations under the same ReLU masks: ||k - p|| / ||p|| <= 1e-2,
#       because each layer's gradient G is rounded to bf16 (2^-9 relative)
#       before its two products, and a sum of such products keeps that
#       relative size (1e-2 leaves ~2.5x); and max|k - p| / max|p|, the
#       largest over all leaves of both inputs, within 2x the same figure of
#       that plain backward summed in float64 (as the forward's gate above);
#   (b) against the plain version with its own forward: ||k - p|| / ||p||
#       <= max(1e-2, 2x ||p - p32|| / ||p32||), p32 the plain version with
#       the float32 weights. The two forwards sum in other orders, so a ReLU
#       mask or a bf16 rounding can flip between them, and where a few points
#       carry a gradient one flip moves it by up to 11% (a 256-ray step on
#       the CUDA tests' first run); the plain version summed in float64 need
#       not flip the same unit, so the bound is how far bf16 itself moves the
#       gradient (the float32 weights), which holds every flip of that kind.
# - one whole train step through the kernels against the plain versions,
#   same batch and random numbers: loss within 1e-4 relative (rounding flips
#   average out over 1024 rays x 192 samples); each parameter's gradient
#   within max(1e-2, 2x its distance between the plain path and the plain
#   path with float32 weights), for the reason in (b).
# - trajectory: 10 steps from one state with the same batches: the largest
#   relative difference of a step's loss within max(1e-3, 2x that between
#   the plain path and the plain path with float32 weights). 1e-3 alone,
#   set before the first run, broke there (1.2e-2 after 9 steps on a loss
#   of 0.002): Adam scales each update to ~lr whatever the gradient's size,
#   so the small gradient differences above move the parameters apart and
#   the gap grows step by step; how far bf16 itself moves the trajectory
#   bounds that growth.
# - hash-table gather (B4): exact, on random tables and on the path's rows,
#   against the plain version.
# - its scatter-add: per element within hash_gather.scatter_add_tolerance
#   of the plain version (index_add_ into float32, rounded once to bf16):
#   two float32 sums of the same n terms in other orders lie within
#   2.01 n 2^-24 S of each other (S the terms' summed magnitudes), and each
#   rounds once to bf16 (2^-8). The kernel's float32 reductions add in an
#   order that changes from run to run, so its last bits do too.
# - one hash-grid train step, kernels against plain versions: loss within
#   1e-4 relative; every gradient within max(1e-2, 2x its distance between
#   the plain path and the plain path with float32 MLP weights) in relative
#   norm. The gather is exact, but B3's float32 sums move the coarse weights
#   by ~1e-7, and with them the random fine samples drawn from them; on this
#   script's second run the losses agreed to float32 resolution, yet the
#   coarse alpha_linear's gradient came out 2.8% apart (and a leaf 10% on the
#   third): such a gradient sums 65,536 points' terms of both signs that
#   nearly cancel, so points moved by 1e-7 move it far in relative terms,
#   while the plain path run twice agrees to 1e-6 (the line shows both).
#   bf16's own distance from float32 bounds such differences, as for the
#   lego step above. The tables' gradients also differ by their bf16
#   rounding after float32 sums in other orders (2^-8 relative).
#   The model trained on noise saturates its density, so the alpha_linear
#   leaves' gradients are 2.2e-7 to 4.6e-6 of the largest leaf's
#   (tools/hash_grad_scale.py, H100), and both relative distances there are
#   noise: the gate failed 2 of 5 runs on them. A leaf below HASH_SMALL_LEAF
#   (1e-4) of the largest leaf's norm is held to the same bound times the
#   largest leaf's norm in absolute distance; the same batch from the
#   initial parameters (alpha_linear bias 0.1, no saturated density) holds
#   every leaf, alpha_linear's included, at the relative bound.
# - float32 kernels (B1-f32, B2-f32; nerf_tpu_torch/tools/f32_check.py):
#   the forward's largest |k - p| / (1 + |p|) over every input checked
#   within 2x that of the plain version summed in float32 against float64,
#   as the bf16 gate above; the backward per leaf within 2e-4 max|want| +
#   1e-6 (dpts, ddirs 1e-3 of their largest), as tests/test_torch_fused_bwd.py,
#   the cotangents of the points with a ReLU unit within 64 x 2^-24 of its
#   sum of |terms| of zero (float64 margins) zeroed on both sides: two
#   correct float32 forwards may decide such a unit either way, and one flip
#   moves a whole leaf; a float32 train step with the same fine samples and
#   masking: loss within 1e-5 relative, every leaf as the backward; a prefix
#   launched alone: exact. B2-f32's weight gradients are 3xTF32 products on
#   the tensor cores (hi hi + hi lo + lo hi, summed in float32 and promoted
#   into a register sum every 256 points) and are held to the same bounds.
# - one layer's product through the fused kernel's wgmma path (ring,
#   descriptors, accumulator layout) against torch.matmul of the same bf16
#   operands in float32: per element within 2^-14 sum |a w|: float32 sums of
#   256 terms in any two orders lie within 256 x 2^-24 sum |a w| (4x left).
# - the fused kernel on a prefix of points launched alone against the same
#   rows of a larger launch: exact (a row's arithmetic does not depend on
#   its tile, its block or the rows around it).
# - B2's recomputed forward against fused_nerf_eval on the same points:
#   exact (the same kernel code, fused_mlp_wgmma.cuh); its mask bits against
#   those the plain mask_bits forms from its own stash: exact.
# - one weight-gradient product of B2 (64 x 256 over 64 points, both
#   operands MN-major) against torch.matmul in float32: within 2^-14 sum
#   |x g|, as the layer product above (float32 sums of 64 terms in any two
#   orders lie within 64 x 2^-24 sum |x g|).
FUSED_P99_REL, FUSED_P999_REL, FUSED_MAX_OVER_PLAIN64 = 1e-3, 1e-2, 2.0
LAYER_REL = 2.0 ** -14
RAGGED_SIZES, PERSISTENT_SIZE = (1, 63, 64, 127, 128, 129, 65_553), 84_525
INTEGRATE_ATOL = 2e-5
PSNR_MIN_DB = 40.0
BWD_FRO_REL, BWD_MAX_OVER_PLAIN64, OVER_BF16_SPREAD = 1e-2, 2.0, 2.0
STEP_LOSS_REL = 1e-4
TRAJ_LOSS_REL, TRAJ_STEPS = 1e-3, 10

MACS_PER_POINT = 593_408  # the lego MLP's multiply-adds per point (63+27 inputs)
# B2 as the train step calls it (no input gradients): the forward again, dW
# for every weight, and dX for every layer but layer 0 and the encoding
# columns of layers 5 and 8 (64x256, 64x256, 32x128 MACs a point)
BWD_MACS_PER_POINT = 2 * MACS_PER_POINT + MACS_PER_POINT - 64 * 256 - 64 * 256 - 32 * 128
TRAIN_OVERRIDES = ["train_dataset_module", "synthetic", "train_dataset.n_images", "100",
                   "train_dataset.H", "800", "train_dataset.W", "800", "train.epoch", "51",
                   "grid_rebuild_ep", "1"]
TRAIN_STEPS, STEP_WINDOW = 500, 50  # lego's ep_iter; warm steps timed in phase 10
FUSED_IO_BYTES = 40  # pts, dirs in (24 B), raw out (16 B)
SIZE = 200
THETA0, PHI, RADIUS = 0.5, 0.3, 4.0  # the warm-up pose, rendered again in phase 6
N_TIMED = 32  # requests in the timed serving window, at thetas spread over the orbit
HASH_STEP_LOSS_REL, HASH_GRAD_REL = 1e-4, 1e-2
# phase 13: below this fraction of the largest leaf's gradient norm a leaf is
# held in absolute distance (tools/hash_grad_scale.py, H100: the alpha_linear
# leaves of the model trained on noise are 2.2e-7 to 4.6e-6 of it)
HASH_SMALL_LEAF = 1e-4
HASH_TRAIN_STEPS, HASH_STEP_WINDOW, HASH_N_TIMED = 200, 20, 16
HASH_ROWS = 3_145_728  # a train step's fine batch: 1024 rays x 192 samples x 16 levels
# the hash-grid phases override only the dataset and the cadence
HASH_TRAIN_OVERRIDES = ["train_dataset_module", "synthetic", "train_dataset.n_images", "100",
                        "train_dataset.H", "800", "train_dataset.W", "800", "train.epoch", "1",
                        "ep_iter", str(HASH_TRAIN_STEPS), "grid_rebuild_ep", "1",
                        "save_latest_ep", "1"]


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.2f} s] {msg}", flush=True)


class Failure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Device time per call, by CUDA events around ``reps`` calls. Timed
    through ``launch_*`` itself, a kernel's time leaves out its wrapper's
    checks, allocations and finishing ops, which the wrapper time shows."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_entries(text):
    """[(kernel, its ptxas -v figures)] from nvcc's log: the stack and spill
    line and the registers line of every entry function."""
    entries = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            names = re.findall(r"\d([a-z][a-z_]*_kernel)", m.group(1))
            entries.append([max(names, key=len) if names else m.group(1), []])
        elif entries and ("spill" in line or "registers" in line):
            entries[-1][1].append(line.replace("ptxas info    :", "").strip())
    return [(name, " | ".join(stats)) for name, stats in entries]


def fused_errors(label, kp, pts, dirs):
    """Hold fused_nerf_eval against fused_nerf_eval_plain on one input, beside
    the plain version summed in float64. Returns (max abs err, max rel err,
    max rel err of the float64 plain version)."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp

    got = fused_mlp.fused_nerf_eval(kp, pts, dirs)
    want = fused_mlp.fused_nerf_eval_plain(kp, pts, dirs)
    want64 = fused_mlp.fused_nerf_eval_plain(kp, pts, dirs, torch.float64)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"fused_nerf_eval on {label}: non-finite output")
    err = (got - want).abs()
    rel = (err / (1.0 + want.abs())).flatten()
    rel64 = ((want64 - want).abs() / (1.0 + want.abs())).flatten()
    q = torch.quantile(rel, torch.tensor([0.99, 0.999], device=rel.device))
    p99, p999 = float(q[0]), float(q[1])
    max_rel, max_rel64 = float(rel.max()), float(rel64.max())
    log(f"fused_nerf_eval {label}, {pts.shape[0]} pts bf16: max abs err {float(err.max()):.6g}, "
        f"rel: p99 {p99:.3g} (tol {FUSED_P99_REL}), p99.9 {p999:.3g} (tol {FUSED_P999_REL}), "
        f"max {max_rel:.4g} (plain summed in float64: {max_rel64:.4g})")
    check(p99 <= FUSED_P99_REL and p999 <= FUSED_P999_REL,
          f"fused_nerf_eval disagrees with fused_nerf_eval_plain on {label}")
    return float(err.max()), max_rel, max_rel64


def check_fused_max(errs):
    """The largest rel err over every input against twice that of the float64 plain version."""
    max_rel, max_rel64 = max(e[1] for e in errs), max(e[2] for e in errs)
    log(f"fused_nerf_eval over {len(errs)} inputs: max rel err {max_rel:.4g}, plain summed in "
        f"float64 {max_rel64:.4g} (tol {FUSED_MAX_OVER_PLAIN64} x)")
    check(max_rel <= FUSED_MAX_OVER_PLAIN64 * max_rel64,
          "fused_nerf_eval's largest error exceeds the plain version's own spread")
    return max(e[0] for e in errs)


def integrate_errors(label, raw, z, d, ert, act):
    """Hold integrate against integrate_plain on one input, with exact zeros
    past ERT's cut; returns max abs err."""
    import torch
    from nerf_tpu_torch.ops import integrate as tint

    keys = ("rgb_map", "depth_map", "acc_map", "weights")
    got = tint.integrate(raw, z, d, ert, True, act)
    want = tint.integrate_plain(raw, z, d, ert, True, act)
    trans = tint.plain_transmittance(raw, z, d, act)
    torch.cuda.synchronize()
    err = max(float((got[k] - want[k]).abs().max()) for k in keys)
    cut = ""
    if ert > 0:
        beyond, near = tint.past_the_cut(trans, ert)
        nonzero = int((got["weights"][beyond] != 0).sum())
        flips = int(((got["weights"] != 0) != (trans >= ert))[near].sum())
        cut = (f"; {int(beyond.sum())} weights past ERT's cut, {nonzero} of them not 0; "
               f"{int(near.sum())} within rounding of it, {flips} of those on the other side")
        check(nonzero == 0, f"integrate: weights past ERT's cut are not 0 on {label}")
    log(f"integrate {label} N={z.shape[0]} S={z.shape[1]} ert={ert} {act}: "
        f"max abs err {err:.3g} (tol {INTEGRATE_ATOL}){cut}")
    check(err <= INTEGRATE_ATOL, f"integrate disagrees with integrate_plain on {label}")
    return err


def integrate_bound(raw, z, d, ert, act):
    """(bound ms, "bytes" or "operations", share of samples read) of
    integrate on one input: samples up to ERT's cut are read (raw 16 B, z
    4 B, ~40 flops), every weight and the per-ray values are written."""
    from nerf_tpu_torch.render.composite import composite

    nr, s = z.shape
    trans = composite(raw, z, d, white_bkgd=False, sigma_activation=act)["transmittance"]
    read = int((trans >= ert).sum())
    nbytes = read * 20 + nr * s * 4 + nr * (12 + 12 + 4 + 4)
    flops = 40.0 * read
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS) * 1e3
    return (bound, "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_F32_FLOPS else "operations",
            read / (nr * s))


def integrate_times(label, raw, z, d, ert, act):
    """integrate on one input, timed twice, each time a CUDA graph of
    launches (device time only: the host's launch time exceeds the kernel's
    at N = 1024). Returns {label, n, s, ms, bound_ms, bound_by}."""
    import torch
    from nerf_tpu_torch.ops import integrate as tint
    from nerf_tpu_torch.tools.variants import graph_ms

    nr, s = z.shape
    outs = [torch.empty(shape, device=raw.device) for shape in ((nr, 3), (nr,), (nr,), (nr, s))]
    args = [t.data_ptr() for t in (raw, z, d, *outs)] + [nr, s, ert,
                                                          tint._ACTIVATIONS.index(act)]
    lib = tint._lib()

    def launch():  # no ERT counter
        return lib.launch_integrate(*args, None, torch.cuda.current_stream().cuda_stream)

    check(launch() == 0, "launch_integrate failed")
    times = [graph_ms(launch, reps=100) for _ in range(2)]
    ms = sum(times) / 2
    bound, bound_by, share = integrate_bound(raw, z, d, ert, act)
    log(f"integrate {label}, N={nr} S={s} ert={ert} {act}: kernel {ms:.4f} ms "
        f"({', '.join(f'{t:.4f}' for t in times)}), bound {bound:.4f} ms ({bound_by}; "
        f"{share:.3f} of the samples before the cut), {bound / ms:.3f} of it")
    return {"label": label, "n": nr, "s": s, "ms": ms, "bound_ms": bound, "bound_by": bound_by}


def random_phase(kp, dev):
    """Both kernels against their plain versions on random inputs, covering
    the options the serving path does not take (ERT off, softplus, exp)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand((65_536, 3), generator=gen, device=dev) * 3.0 - 1.5
    d = torch.randn((65_536, 3), generator=gen, device=dev)
    fused_errs = [fused_errors("random", kp, pts, d / torch.linalg.norm(d, dim=-1, keepdim=True))]

    integrate_err = 0.0
    for n, s in ((8192, 64), (8192, 192), (1024, 64), (1024, 192)):
        raw = torch.randn((n, s, 4), generator=gen, device=dev)
        raw[..., 3] *= 20.0
        z = torch.sort(torch.rand((n, s), generator=gen, device=dev) * 4.0 + 2.0, -1).values
        d = torch.randn((n, 3), generator=gen, device=dev)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        # exp's raw sigma a tenth as wide: densities up to ~e^8, none infinite
        raw_exp = torch.cat([raw[..., :3], raw[..., 3:] / 10.0], dim=-1)
        for ert in (0.0, 0.01):
            for act in ("relu", "softplus", "exp"):
                integrate_err = max(integrate_err, integrate_errors(
                    "random", raw_exp if act == "exp" else raw, z, d, ert, act))
    return fused_errs, integrate_err


def wgmma_phase(kp, dev):
    """The fused kernel's wgmma path: one layer's product against
    torch.matmul; PERSISTENT_SIZE random points against the plain version
    (returned for the gates); each ragged prefix launched alone against the
    same rows of that launch."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd

    gen = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn((128, 256), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((256, 256), generator=gen, device=dev).to(torch.bfloat16)
    got = fused_mlp.wgmma_layer_product(a, w)
    want = a.float() @ w.float()
    ratio = float(((got - want).abs() / (a.float().abs() @ w.float().abs())).max())
    log(f"wgmma layer product 128x256x256 against torch.matmul in float32: max |err| / "
        f"sum|a w| {ratio:.3g} (tol {LAYER_REL:.3g})")
    check(ratio <= LAYER_REL, "the wgmma layer product disagrees with torch.matmul")
    x = torch.randn((64, 64), generator=gen, device=dev).to(torch.bfloat16)
    gg = torch.randn((64, 256), generator=gen, device=dev).to(torch.bfloat16)
    got = fused_mlp_bwd.wgrad_product(x, gg)
    want = x.float().T @ gg.float()
    ratio = float(((got - want).abs() / (x.float().abs().T @ gg.float().abs())).max())
    log(f"B2's weight-gradient product 64x256 over 64 points (MN-major operands) against "
        f"torch.matmul in float32: max |err| / sum|x g| {ratio:.3g} (tol {LAYER_REL:.3g})")
    check(ratio <= LAYER_REL, "B2's weight-gradient product disagrees with torch.matmul")

    n = PERSISTENT_SIZE
    pts = torch.rand((n, 3), generator=gen, device=dev) * 3.0 - 1.5
    d = torch.randn((n, 3), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    errs = fused_errors(f"random, {n // 128 + 1} tiles of 128", kp, pts, d)
    full = fused_mlp.fused_nerf_eval(kp, pts, d)
    for m in RAGGED_SIZES:
        part = fused_mlp.fused_nerf_eval(kp, pts[:m].contiguous(), d[:m].contiguous())
        check(bool(torch.equal(part, full[:m])), f"fused_nerf_eval on {m} points differs from "
              f"the same points inside a launch of {n}")
    log(f"fused_nerf_eval alone on {', '.join(map(str, RAGGED_SIZES))} points: exactly the "
        f"rows of the {n}-point launch")
    return errs


def matmul_chain(kp, pts, dirs):
    """The forward as a chain of bf16 torch.matmul calls (cuBLAS, float32
    sums, bf16 results) with bias, ReLU and rounding as float32 PyTorch ops
    between them: the yardstick of unfused library products."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp

    mats, off = [], 0
    for k, nn in fused_mlp.STREAM_LAYERS:
        mats.append(kp["wbuf"][off: off + k * nn].view(k, nn))
        off += k * nn
    wa = kp["wbuf"][off: off + 256].view(256, 1)
    wr = kp["wbuf"][off + 256: off + 256 + 384].view(128, 3)
    b = kp["bbuf"]
    bf = torch.bfloat16

    def enc(v, s, width):
        a = fused_mlp._phases(v, s)
        e = torch.cat([v, torch.sin(a), torch.cos(a)], -1)
        return torch.nn.functional.pad(e, (0, width - e.shape[1])).to(bf)

    ex, ed = enc(pts, kp["sx"], 64), enc(dirs, kp["sd"], 32)
    h = ex
    for l in range(9):
        x = ex if l == 0 else torch.cat([ex, h], -1) if l == 5 else h
        y = (x @ mats[l]).float() + b[l * 256: (l + 1) * 256]
        if l == 7:
            sigma = (y.clamp_min(0).to(bf) @ wa).float() + b[2432]
        h = (y.clamp_min(0) if l < 8 else y).to(bf)
    v = ((torch.cat([h, ed], -1) @ mats[9]).float() + b[2304:2432]).clamp_min(0).to(bf)
    return torch.cat([(v @ wr).float() + b[2433:2436], sigma], -1)


def serve_phase(dev, cfg, counters, n_timed=N_TIMED):
    """Drive the serving path through its entry points: build the service,
    one warm-up request, then a timed window of n_timed requests. The
    counters are zeroed first; each must have counted a launch by the end."""
    import numpy as np
    import torch
    from nerf_tpu_torch.serve import RenderService, decode_png, make_server

    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    service = RenderService(cfg, size=SIZE, device=dev)
    torch.cuda.synchronize()
    populate_s = time.perf_counter() - t
    populate_launches = {k: c.launches for k, c in counters.items()}
    log(f"RenderService on {dev}: {populate_s:.3f} s including the ESS rebuild at "
        f"R={service.grid.resolution} (launches {populate_launches}), occupied "
        f"{float(service.grid.occupied.float().mean()):.4f}")

    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    thetas = [THETA0] + [THETA0 + 2.0 * math.pi * i / n_timed for i in range(n_timed)]
    bodies, times = [], []
    try:
        port = server.server_address[1]
        window_start = None
        for i, theta in enumerate(thetas):
            if i == 1:
                window_start = time.perf_counter()
            url = f"http://127.0.0.1:{port}/frame?theta={theta}&phi={PHI}&radius={RADIUS}"
            t = time.perf_counter()
            with urllib.request.urlopen(url, timeout=120) as resp:
                status, ctype, body = resp.status, resp.headers["Content-Type"], resp.read()
            times.append(time.perf_counter() - t)
            check(status == 200 and ctype == "image/png", f"GET {url}: {status} {ctype}")
            bodies.append(body)
        window_s = time.perf_counter() - window_start
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    check(service.errors == 0, f"{service.errors} /frame errors")
    launches = {k: c.launches for k, c in counters.items()}
    log(f"launches on the serving path: {launches} ({populate_launches} in the ESS rebuild, "
        f"the rest in {len(thetas)} requests)")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched by the path")

    frames = []
    for theta, body in zip(thetas, bodies):
        img = decode_png(body)
        check(img.shape == (SIZE, SIZE, 3), f"frame shape {img.shape}")
        mean = float(img.mean()) / 255.0
        check(mean < 0.98, f"frame at theta={theta:.4f} is blank (mean {mean:.4f})")
        frames.append(img)
    means = [float(f.mean()) / 255.0 for f in frames]
    log(f"all {len(frames)} frames: 200, PNG [{SIZE}, {SIZE}, 3], mean "
        f"{min(means):.4f}..{max(means):.4f}")
    w = np.array(times[1:]) * 1e3
    log(f"serving {SIZE}x{SIZE}: startup {populate_s * 1e3:.1f} ms (service) + "
        f"{times[0] * 1e3:.1f} ms (first request); window of {n_timed} requests "
        f"{window_s:.4f} s, {window_s * 1e3 / n_timed:.2f} ms per request, "
        f"{n_timed * SIZE * SIZE / window_s:.0f} rays/s; per request min {w.min():.2f}, "
        f"median {np.median(w):.2f}, p90 {np.percentile(w, 90):.2f}, max {w.max():.2f}, "
        f"std {w.std():.2f} ms")
    return service, frames[0], launches, window_s * 1e3 / n_timed


def path_phase(service, random_errs):
    """Both kernels against their plain versions on the serving path's own
    inputs and shapes, and their times on the first tile's fine pass."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp, integrate as tint
    from nerf_tpu_torch.tools.fused_accuracy import path_inputs

    dev, opts, kp = service.device, service.opts, service.params
    fused_errs, integrate_err = random_errs
    ert, act = opts.ert_threshold if opts.enable_ert else 0.0, opts.sigma_activation
    timed = coarse = coarse_int = None
    for label, model, pts, dirs, z, d in path_inputs(service, THETA0, PHI, RADIUS):
        fused_errs.append(fused_errors(label, kp[model], pts, dirs))
        if z is None:
            continue
        raw = fused_mlp.fused_nerf_eval(kp[model], pts, dirs).reshape(*z.shape, 4)
        integrate_err = max(integrate_err, integrate_errors(label, raw, z, d, ert, act))
        if timed is None and model == "fine":
            timed = (pts, dirs, raw, z, d)
        if coarse is None and model == "coarse":
            coarse = (kp["coarse"], pts, dirs)
            coarse_int = (raw, z, d)
    fused_err = check_fused_max(fused_errs)

    pts, dirs, raw, z, d = timed
    lib, stream = fused_mlp._lib(), torch.cuda.current_stream().cuda_stream
    for label, wk, tp, td in (("first tile fine", kp["fine"], pts, dirs),
                              ("first tile coarse", *coarse)):
        n = tp.shape[0]
        out = torch.empty((n, 4), device=dev)
        wg_args = [t.data_ptr() for t in (tp, td, wk["wpack"], wk["wbuf"], wk["bbuf"], out)]
        check(lib.launch_fused_nerf(*wg_args, n, stream) == 0, "launch_fused_nerf failed")
        times = [time_ms(lambda: lib.launch_fused_nerf(*wg_args, n, stream), reps=10)
                 for _ in range(2)]
        ms = sum(times) / 2
        wrapper_ms = time_ms(lambda: fused_mlp.fused_nerf_eval(wk, tp, td), reps=10)
        plain_ms = time_ms(lambda: fused_mlp.fused_nerf_eval_plain(wk, tp, td), reps=3)
        chain_ms = time_ms(lambda: matmul_chain(wk, tp, td), reps=5)
        want = fused_mlp.fused_nerf_eval_plain(wk, tp, td)
        chain_rel = float(((matmul_chain(wk, tp, td) - want).abs() / (1.0 + want.abs()))
                          .flatten().quantile(0.99))
        flops = 2.0 * MACS_PER_POINT * n
        nbytes = FUSED_IO_BYTES * n + wk["wbuf"].numel() * 2 + wk["bbuf"].numel() * 4
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        log(f"fused_nerf_eval {label}, {n} pts: wgmma kernel {ms:.4f} ms ("
            f"{', '.join(f'{t:.4f}' for t in times)}; {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound / ms:.3f} of the bound), wrapper {wrapper_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms")
        log(f"yardstick, {label}: a chain of bf16 torch.matmul calls with float32 epilogues "
            f"{chain_ms:.4f} ms (rel p99 {chain_rel:.3g} from the plain version)")
        if label == "first tile fine":
            kernels = [{"name": "fused_nerf_eval", "route": "cuda",
                        "source": "nerf_tpu_torch/csrc/fused_mlp.cu",
                        "replaces": "nerf_tpu/ops/fused_mlp.py:129",
                        "max_abs_err": fused_err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound,
                        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
                        else "bytes", "library_ms": None}]

    fine = integrate_times("lego tile fine", raw, z, d, ert, act)
    b3_rows = [integrate_times("lego tile coarse", *coarse_int, ert, act), fine]
    wrapper_ms = time_ms(lambda: tint.integrate(raw, z, d, ert, True, act), reps=50)
    plain_ms = time_ms(lambda: tint.integrate_plain(raw, z, d, ert, True, act), reps=20)
    log(f"integrate first tile fine: wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms")
    kernels.append({"name": "integrate", "route": "cuda",
                    "source": "nerf_tpu_torch/csrc/integrate.cu",
                    "replaces": "nerf_tpu/ops/integrate.py:24",
                    "max_abs_err": integrate_err, "ms": fine["ms"], "plain_ms": plain_ms,
                    "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
                    "library_ms": None})
    return kernels, b3_rows


def plain_phase(service):
    """The warm-up pose again, through the kernels and through the plain versions."""
    import numpy as np
    import torch

    rgb_k = service.render(THETA0, PHI, RADIUS)
    plain = dataclasses.replace(service.opts, use_fused_mlp=False, use_integrate_kernel=False)
    t = time.perf_counter()
    rgb_p = service.render(THETA0, PHI, RADIUS, opts=plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    check(tuple(rgb_k.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(rgb_k).all()),
          "kernel frame is not finite [200, 200, 3]")
    check(bool(torch.isfinite(rgb_p).all()), "plain frame is not finite")
    mse = float(torch.mean((rgb_k - rgb_p) ** 2))
    psnr = -10.0 * math.log10(max(mse, 1e-20))
    log(f"kernel vs plain frame: PSNR {psnr:.2f} dB (min {PSNR_MIN_DB}), max abs "
        f"{float((rgb_k - rgb_p).abs().max()):.4g}; plain render {plain_s:.3f} s")
    check(psnr >= PSNR_MIN_DB, "kernel path disagrees with the plain path")
    return (np.clip(rgb_k.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


class _Tee(io.TextIOBase):
    """Writes to several streams: the trainer's log goes to stdout and to a buffer."""

    def __init__(self, *streams):
        super().__init__()
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def _drive_trainer(cfg_file, opts, counters):
    """Run the trainer's entry point in-process with the counters zeroed.
    Returns (state, grid, launches, its log, seconds)."""
    import torch
    from nerf_tpu_torch.train.__main__ import main as train_main

    for c in counters.values():
        c.launches = 0
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        state, grid = train_main(["--cfg_file", cfg_file, *opts])
    torch.cuda.synchronize()
    return (state, grid, {k: c.launches for k, c in counters.items()}, buf.getvalue(),
            time.perf_counter() - t)


@contextlib.contextmanager
def _spy(module, name, keep=None, limit=None):
    """Record the (args, kwargs) of every call of module.name inside the
    block (with ``keep``, of the first ``limit`` calls for which
    ``keep(args, kwargs)`` holds); the spy carries its own ``launches``
    (the wrappers count on the module-level name they are bound to)."""
    seen, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        if keep is None or ((limit is None or len(seen) < limit) and keep(args, kwargs)):
            seen.append((args, kwargs))
        return real(*args, **kwargs)

    spy.launches = 0
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _counters():
    from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd, integrate as tint

    return {"fused_nerf_eval": fused_mlp.fused_nerf_eval,
            "fused_nerf_bwd": fused_mlp_bwd.fused_nerf_bwd, "integrate": tint.integrate}


def train_phase(root, tmp):
    """Resume the committed lego state through the trainer's entry point and
    train one epoch; check its log and its checkpoint."""
    import numpy as np
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import adam
    from nerf_tpu_torch.train.checkpoint import load_checkpoint

    model_dir = os.path.join(tmp, "model")
    os.makedirs(model_dir)
    src = os.path.join(root, "checkpoints/nerf/lego/nerf")
    for f in ("latest.npz", "latest.json"):
        shutil.copy(os.path.join(src, f), model_dir)
    with np.load(os.path.join(src, "latest.npz")) as data:
        step0 = int(data["leaf_146"])
    opts = [*TRAIN_OVERRIDES, "trained_model_dir", model_dir,
            "record_dir", os.path.join(tmp, "record")]
    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    cfg = make_cfg(cfg_file, opts)
    adam_before = adam.adam.launches
    state, grid, launches, text, train_s = _drive_trainer(cfg_file, opts, _counters())
    log(f"train entry point: {train_s:.2f} s (data, resume, {TRAIN_STEPS} steps, ESS rebuild, "
        f"checkpoint); launches {launches}, adam {adam.adam.launches - adam_before}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched by the train path")
    check(adam.adam.launches - adam_before == TRAIN_STEPS,
          "the train path did not update its leaves through the Adam kernel once a step")
    losses = [float(v) for v in re.findall(r"\bloss: (\S+)", text)]
    check(len(losses) == TRAIN_STEPS // 50 and all(math.isfinite(v) for v in losses),
          f"logged losses {losses}")
    log(f"{len(losses)} logged losses, all finite: {losses[0]:.5f} ... {losses[-1]:.5f}")
    with np.load(os.path.join(model_dir, "latest.npz")) as data:
        n_leaves, step = len(data.files), int(data["leaf_146"])
    check(n_leaves == 147 and step == step0 + TRAIN_STEPS,
          f"checkpoint: {n_leaves} leaves, step {step} (want 147, {step0 + TRAIN_STEPS})")
    back = load_checkpoint(model_dir, state)
    check(back is not None and back[0].step == step and back[1] == 50,
          "the written checkpoint does not load back through load_checkpoint")
    log(f"checkpoint: 147 leaves, step {step}, epoch {back[1]}; loads back")
    return cfg, state, grid, launches


def adam_phase(dev, smi):
    """The Adam kernel on lego's leaves: exact against step_plain, then its
    times (tools/adam_check.py); returns its row of the kernel table."""
    from nerf_tpu_torch.tools import adam_check

    t = adam_check.run(dev)
    log(f"adam on {smi}, lego's {t['leaves']} leaves ({t['elements']} elements), equal to "
        f"step_plain bit for bit over 3 steps: {t['ms'] * 1e3:.2f} us a launch, L2 evicted "
        f"before each ({t['l2_warm_ms'] * 1e3:.2f} us back to back in a CUDA graph), bound "
        f"{t['bound_ms'] * 1e3:.2f} us (28 bytes an element), {100 * t['share_of_bound']:.1f}% of "
        f"it; step_plain {t['plain_ms']:.4f} ms by events; host {t['host_us']:.1f} us a step "
        f"(step_plain {t['plain_host_us']:.1f} us)")
    return {"name": "adam", "route": "cuda", "source": "nerf_tpu_torch/csrc/adam.cu",
            "replaces": "none (optax's update, fused by XLA; added to cut the loop's 720 "
                        "launches a lego step)", "launches": 1, "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


def ngp_phase(dev, smi):
    """Instant-NGP's train path on a seeded state (tools/ngp_check.py)."""
    from nerf_tpu_torch.tools import ngp_check

    t = ngp_check.run(dev)
    h, a = t["hash"], t["adam"]
    log(f"ngp on {smi}: gather_rows {h['gather_rows']} rows of 2 float32 from "
        f"{h['table_rows']}: exact against the plain version; scatter_add_rows into them: max "
        f"abs err {h['scatter_max_abs_err']:.4g}, worst err / tolerance "
        f"{h['scatter_worst_over_tol']:.3g}; a step's launches {t['launches']}; adam with the L2 "
        f"and the skip on {a['leaves']} leaves ({a['elements']} elements) equal to step_plain "
        f"bit for bit over {len(a['skipped'])} steps, {a['skipped'][0]} elements skipped a step "
        f"(the table gradient's zeros)")


def encoder_kernels_phase(dev, smi):
    """Phase 46: the hash encoder's kernels at ngp.train's shape
    (tools/ngp_check.py ``encoder``); returns their rows of the kernel table."""
    from nerf_tpu_torch.tools import ngp_check

    t = ngp_check.encoder(dev)
    c, times = t["check"], t["times"]
    enc = times["encoder"]
    log(f"hash encoder kernels on {smi}, {c['points']} points ({c['rows']} corner rows of 2 "
        f"float32): hash_index equal to the PyTorch path; hash_interp equal to its plain "
        f"version, worst err / interp_tolerance against encode_torch "
        f"{c['interp_worst_over_tol']:.3g}; hash_interp_bwd equal to its plain version; "
        f"encode_fused with no synchronisation, launches {c['forward']} forward, "
        f"{c['backward']} backward, table gradient worst err / tolerance "
        f"{c['grad_worst_over_tol']:.3g}")
    for name in ("hash_index", "hash_interp", "hash_interp_bwd"):
        k = times[name]
        log(f"{name}: {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bytes']} bytes), "
            f"{100 * k['share_of_bound']:.1f}% of it; plain {k['plain_ms']:.4f} ms")
    log(f"the encoder, fwd / fwd+bwd / host us a fwd+bwd: fused {enc['fused']['fwd_ms']:.4f} / "
        f"{enc['fused']['fwd_bwd_ms']:.4f} ms / {enc['fused']['host_us']:.1f}, PyTorch path "
        f"{enc['torch']['fwd_ms']:.4f} / {enc['torch']['fwd_bwd_ms']:.4f} ms / "
        f"{enc['torch']['host_us']:.1f} (B4 and B4' on both)")
    err = c["interp_max_abs_err"]
    return [{"name": name, "route": "cuda", "source": "nerf_tpu_torch/csrc/hash_gather.cu",
             "replaces": "none (the hash encoder's index arithmetic and interpolation, which "
                         "XLA fuses in the JAX package)", "launches": 1,
             "max_abs_err": err if name == "hash_interp" else 0.0,
             "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
             "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": None}
            for name in ("hash_index", "hash_interp", "hash_interp_bwd")]


def _clone_state(state):
    from nerf_tpu_torch.train.state import TrainState
    from nerf_tpu_torch.tree import tree_map

    opt = state.opt_state
    return TrainState(params=tree_map(lambda x: x.detach().clone().requires_grad_(True),
                                      state.params),
                      opt_state=dataclasses.replace(opt, mu=[m.clone() for m in opt.mu],
                                                    nu=[m.clone() for m in opt.nu]),
                      step=state.step)


def _model_views(service, n_views: int = 8):
    """(images_u8, poses, K) of the served model's own renders at n_views
    poses of the serving orbit: targets the model explains, so that a step
    is one of continued training."""
    import numpy as np
    import torch
    from nerf_tpu_torch.serve import look_at_pose

    thetas = [2.0 * math.pi * i / n_views for i in range(n_views)]
    imgs = [(service.render(t, PHI, RADIUS).clamp(0, 1) * 255).round().to(torch.uint8)
            for t in thetas]
    poses = np.stack([look_at_pose(t, PHI, RADIUS) for t in thetas])
    return torch.stack(imgs), torch.as_tensor(poses, device=service.device), service.K


def _rel(a, b):
    """(||a - b|| / ||b||, max|a - b| / max|b|, max|a - b|)."""
    err = (a.double() - b.double())
    return (float(err.norm() / b.double().norm().clamp_min(1e-30)),
            float(err.abs().max() / b.double().abs().max().clamp_min(1e-30)),
            float(err.abs().max()))


def grads_phase(cfg, state, grid, data, dev):
    """B2 on the path's own inputs, and one whole step, kernels against plain."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp_bwd as fb
    from nerf_tpu_torch.ops.fused_mlp import fused_nerf_eval, repack_params
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.state import loss_and_grads, sample_ray_batch

    opts = RenderOptions.from_cfg(cfg)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    plain32 = dataclasses.replace(plain, compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    ro, rd, tgt = sample_ray_batch(gen, *data, int(cfg.task_arg.N_rays))
    rng = gen.get_state()
    with _spy(fb, "fused_nerf_bwd") as calls:
        lk, _, gk = loss_and_grads(state.params, ro, rd, tgt, opts, grid, gen)
    seen = [args[:4] for args, _ in calls]
    step = {}
    for name, o in (("plain", plain), ("plain32", plain32)):
        gen.set_state(rng)
        step[name] = loss_and_grads(state.params, ro, rd, tgt, o, grid, gen)
    torch.cuda.synchronize()
    check(len(seen) == 2, f"{len(seen)} backward calls in one step, expected 2")

    def flat(out):
        return [out[0][k] for k in fb._GRAD_KEYS] + [out[1], out[2]]

    names = list(fb._GRAD_KEYS) + ["dpts", "ddirs"]
    max_err, worst, worst64 = 0.0, 0.0, 0.0
    for kp, pts, dirs, g in sorted(seen, key=lambda c: c[1].shape[0]):
        model = "coarse" if pts.shape[0] == ro.shape[0] * opts.n_samples else "fine"
        full = fb.launch_full(kp, pts, dirs, g)
        got = flat((full["kgrads"], full["dpts"], full["ddirs"]))
        acts = fb.stash_activations(kp, full["stash"], pts, dirs)
        raw = fused_nerf_eval(kp, pts, dirs)
        m = full["masks"].shape[0] * 64
        zeros = torch.zeros((m, 3), device=dev)
        padded = fb.stash_activations(kp, fb.unpack_slabs(full["stash_slabs"], m), zeros, zeros)
        check(bool(torch.equal(full["raw"], raw)), f"B2's recomputed forward on {model} differs "
              "from fused_nerf_eval's output")
        check(bool(torch.equal(fb.mask_bits(padded), full["masks"])),
              f"B2's mask bits on {model} are not those of its stash")
        own = flat(fb.backward_from_activations(kp, acts, g))
        own64 = flat(fb.backward_from_activations(kp, acts, g, accumulate=torch.float64))
        want = flat(fb.fused_nerf_bwd_plain(kp, pts, dirs, g))
        kp32 = {k: v.to(dev) for k, v in repack_params(
            state.params[model], opts.xyz_freqs, opts.dir_freqs, torch.float32).items()}
        want32 = flat(fb.fused_nerf_bwd_plain(kp32, pts, dirs, g))
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got), f"B2 {model}: non-finite")
        errs = [_rel(k, p) for k, p in zip(got, own)]
        errs64 = [_rel(q, p) for q, p in zip(own64, own)]
        fro = max(e[0] for e in errs)
        worst = max(worst, max(e[1] for e in errs))
        worst64 = max(worst64, max(e[1] for e in errs64))
        max_err = max(max_err, max(e[2] for e in errs))
        log(f"fused_nerf_bwd {model}, {pts.shape[0]} pts of one step: recomputed raw equals "
            f"fused_nerf_eval's bit for bit, mask bits those of its stash; against the plain "
            f"backward on the kernel's stash: relative norm err max {fro:.3g} at "
            f"{names[max(range(len(errs)), key=lambda i: errs[i][0])]} (tol {BWD_FRO_REL}; "
            f"float64 sums {max(e[0] for e in errs64):.3g}); max|k-p|/max|p| "
            f"{max(e[1] for e in errs):.3g} (float64 sums {max(e[1] for e in errs64):.3g})")
        check(fro <= BWD_FRO_REL, f"fused_nerf_bwd disagrees with its plain backward on {model}")
        ratios = []
        for nm, k, p, p32 in zip(names, got, want, want32):
            e, spread = _rel(k, p)[0], _rel(p, p32)[0]
            ratios.append((e / max(BWD_FRO_REL, OVER_BF16_SPREAD * spread), nm, e, spread))
        r, nm, e, spread = max(ratios)
        log(f"fused_nerf_bwd {model} against the plain version with its own forward: worst "
            f"leaf {nm}, relative norm err {e:.3g} against bf16's own {spread:.3g} (tol "
            f"max({BWD_FRO_REL}, {OVER_BF16_SPREAD} x))")
        check(r <= 1.0, f"fused_nerf_bwd disagrees with fused_nerf_bwd_plain on {model}")
    log(f"fused_nerf_bwd largest element err {worst:.4g} of the leaf's max, float64 sums "
        f"{worst64:.4g} (tol {BWD_MAX_OVER_PLAIN64} x)")
    check(worst <= BWD_MAX_OVER_PLAIN64 * worst64,
          "fused_nerf_bwd's largest error exceeds the plain backward's own spread")

    (lp, _, gp), (_, _, g32) = step["plain"], step["plain32"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    ratios = []
    for i, (a, b, c) in enumerate(zip(gk, gp, g32)):
        e, spread = _rel(a, b)[0], _rel(b, c)[0]
        ratios.append((e / max(BWD_FRO_REL, OVER_BF16_SPREAD * spread), i, e, spread))
    r, i, e, spread = max(ratios)
    errs = sorted(x[2] for x in ratios)
    log(f"train step, kernels vs plain on one batch: loss {float(lk):.7f} vs {float(lp):.7f} "
        f"(rel {loss_rel:.3g}, tol {STEP_LOSS_REL}); gradients of {len(gk)} leaves: relative "
        f"norm err median {errs[len(errs) // 2]:.4g}, max {errs[-1]:.4g}; worst against "
        f"bf16's own spread: leaf {i}, {e:.4g} against {spread:.4g} (tol max({BWD_FRO_REL}, "
        f"{OVER_BF16_SPREAD} x))")
    check(math.isfinite(float(lk)) and loss_rel <= STEP_LOSS_REL, "train step loss disagrees")
    check(r <= 1.0, "train step gradients disagree")
    return max_err, sorted(seen, key=lambda c: c[1].shape[0])


def trajectory_phase(cfg, state, grid, data, dev):
    """TRAJ_STEPS steps through the kernels, through the plain versions and
    through the plain versions with float32 weights."""
    import torch
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import train_step

    opts = RenderOptions.from_cfg(cfg)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    tx = make_optimizer(cfg)
    losses = {}
    for name, o in (("kernel", opts), ("plain", plain),
                    ("plain32", dataclasses.replace(plain, compute_dtype="float32"))):
        st = _clone_state(state)
        gen = torch.Generator(device=dev).manual_seed(2)
        losses[name] = [float(train_step(st, *data, tx, o, int(cfg.task_arg.N_rays), grid,
                                         gen)["loss"]) for _ in range(TRAJ_STEPS)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["plain"]))
    spread = max(abs(a - b) / abs(b) for a, b in zip(losses["plain32"], losses["plain"]))
    tol = max(TRAJ_LOSS_REL, OVER_BF16_SPREAD * spread)
    log(f"{TRAJ_STEPS} steps: losses kernel {[f'{v:.6g}' for v in losses['kernel']]}, plain "
        f"{[f'{v:.6g}' for v in losses['plain']]}, plain with float32 weights "
        f"{[f'{v:.6g}' for v in losses['plain32']]}; kernel vs plain max rel {rel:.3g}, "
        f"float32 vs plain {spread:.3g} (tol {tol:.3g})")
    check(all(math.isfinite(v) for v in losses["kernel"]) and rel <= tol,
          "the kernel path's trajectory leaves the plain path's")


def train_times_phase(cfg, state, grid, data, dev, batches):
    """A window of warm train steps, and B2 on the step's coarse and fine
    batches (``batches``: the spied (kp, pts, dirs, g), coarse first)."""
    import numpy as np
    import torch
    from nerf_tpu_torch.ops import fused_mlp_bwd
    from nerf_tpu_torch.ops.fused_mlp import BBUF_SIZE, WBUF_SIZE, WPACK_SIZE
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import train_step

    opts = RenderOptions.from_cfg(cfg)
    tx = make_optimizer(cfg)
    n_rays = int(cfg.task_arg.N_rays)
    st = _clone_state(state)
    gen = torch.Generator(device=dev).manual_seed(3)
    for _ in range(5):
        train_step(st, *data, tx, opts, n_rays, grid, gen)
    torch.cuda.synchronize()
    for c in _counters().values():
        c.launches = 0
    times = []
    t0 = time.perf_counter()
    for _ in range(STEP_WINDOW):
        t = time.perf_counter()
        train_step(st, *data, tx, opts, n_rays, grid, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    window = time.perf_counter() - t0
    per_step = {k: c.launches / STEP_WINDOW for k, c in _counters().items()}
    w = np.array(times) * 1e3
    log(f"train step window of {STEP_WINDOW} warm steps: {window * 1e3 / STEP_WINDOW:.3f} ms per "
        f"step, {n_rays * STEP_WINDOW / window:.0f} train rays/s; per step min {w.min():.3f}, "
        f"median {np.median(w):.3f}, max {w.max():.3f}, std {w.std():.3f} ms; launches per "
        f"step {per_step}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    lib = fused_mlp_bwd._lib()[0]
    out = {}
    for label, (kp, pts, dirs, g) in zip(("coarse", "fine"), batches):
        n = pts.shape[0]
        new = fused_mlp_bwd.launch_full(kp, pts, dirs, g, input_grads=False)
        args = list(new["args"])
        check(lib.launch_fused_nerf_bwd(*args) == 0, "B2 launch failed")
        run_new = lambda: lib.launch_fused_nerf_bwd(*args)  # noqa: E731
        times = [time_ms(run_new, reps=10) for _ in range(2)]
        ms = sum(times) / 2
        parts = {}
        for name, bit in (("forward + stash", 1), ("chain", 2), ("dW", 4), ("heads", 8),
                          ("reduce", 16)):
            args[-2] = bit
            parts[name] = time_ms(run_new, reps=10)
        args[-2] = fused_mlp_bwd.PHASES_ALL
        flops = 2.0 * BWD_MACS_PER_POINT * n
        nbytes = 40 * n + WBUF_SIZE * 2 + BBUF_SIZE * 4 + (WBUF_SIZE + BBUF_SIZE) * 4
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        # this design's own bytes: the stash and gbuf written once and read
        # once by dW, the mask bits written and read once, the inputs once
        floor = (n * (2 * 2 * (STASH_WIDTH + GBUF_WIDTH) + 2 * MASK_BYTES + 40)
                 + 3 * WPACK_SIZE * 2) / PEAK_BYTES * 1e3
        log(f"fused_nerf_bwd {label} batch, {n} pts: kernels {ms:.4f} ms ({times[0]:.4f}, "
            f"{times[1]:.4f}; {flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.3f} of the bound); "
            f"launches {', '.join(f'{k} {v:.4f}' for k, v in parts.items())} ms; bound "
            f"{bound:.4f} ms ({BWD_MACS_PER_POINT} MACs a point), this design's byte floor "
            f"{floor:.4f} ms")
        out[label] = {"ms": ms, "bound_ms": bound, "bound_by":
                      "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"}
    kp, pts, dirs, g = batches[-1]
    wrapper_ms = time_ms(lambda: fused_mlp_bwd.fused_nerf_bwd(kp, pts, dirs, g, input_grads=False),
                         reps=10)
    plain_ms = time_ms(lambda: fused_mlp_bwd.fused_nerf_bwd_plain(kp, pts, dirs, g,
                                                                  input_grads=False), reps=3)
    stash = fused_mlp_bwd.unpack_slabs(new["stash_slabs"], pts.shape[0])
    gbuf = fused_mlp_bwd.unpack_slabs(new["gbuf_slabs"], pts.shape[0])
    yard_ms = time_ms(lambda: bwd_matmuls(kp, stash, gbuf), reps=3)
    log(f"fused_nerf_bwd fine batch: wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"yardstick (its 19 products as bf16 torch.matmul calls over the unpacked stash and "
        f"gbuf, no masks or roundings between them) {yard_ms:.4f} ms")
    return {**out["fine"], "plain_ms": plain_ms}


# B2's scratch a point: stash and gbuf columns (bf16), mask bytes
STASH_WIDTH, GBUF_WIDTH, MASK_BYTES = 2528, 2432, 272
# (stash column, K, gbuf column, N) of the ten matrix layers' X and G
BWD_LAYERS = ((1024, 64, 0, 256), (0, 256, 256, 256), (256, 256, 512, 256),
              (512, 256, 768, 256), (768, 256, 1024, 256), (1024, 320, 1280, 256),
              (1344, 256, 1536, 256), (1600, 256, 1792, 256), (1856, 256, 2048, 256),
              (2112, 288, 2304, 128))


def bwd_matmuls(kp, stash, gbuf):
    """B2's products as bf16 torch.matmul calls (cuBLAS, float32 sums): dW =
    X^T G for every layer and dX = G W^T down the chain (view, feature and
    trunk layers 7-1, the skip layer on its h5 rows): the yardstick of
    unfused library products."""
    from nerf_tpu_torch.ops import fused_mlp

    mats = fused_mlp._stream_matrices(kp["wbuf"])
    out = []
    for i, (xc, k, gc, n) in enumerate(BWD_LAYERS):
        gl = gbuf[:, gc: gc + n]
        out.append(stash[:, xc: xc + k].T @ gl)
        if i >= 1:
            w = mats[i][64:] if i == 5 else mats[i][:256]
            out.append(gl @ w.T)
    return out


def _hash_counters():
    from nerf_tpu_torch.ops import hash_gather, integrate as tint

    return {"hash_gather_rows": hash_gather.gather_rows,
            "hash_scatter_add_rows": hash_gather.scatter_add_rows, "integrate": tint.integrate}


def _pattern_rows(dev, layout, n_rows_wanted, gen):
    """The hash encoder's own row indices for random points in the bbox, at
    the config's geometry, cut to n_rows_wanted (level-major)."""
    import torch
    from nerf_tpu_torch.models.hashgrid import hashgrid_index, level_resolutions, table_shape

    shape = table_shape(16, 2, 19, layout)
    per_point = 16 * (1 if layout == "cellpack" else 8)
    n_pts = -(-n_rows_wanted // per_point)
    pts = torch.rand((n_pts, 3), generator=gen, device=dev) * 3.0 - 1.5
    idx, _ = hashgrid_index(shape, pts, level_resolutions(), layout=layout)
    return shape, idx[:n_rows_wanted].contiguous()


def scatter_errors(label, idx, cot, n_rows):
    """Hold scatter_add_rows against its plain version; returns max abs err."""
    import torch
    from nerf_tpu_torch.ops import hash_gather

    got = hash_gather.scatter_add_rows(idx, cot, n_rows)
    want = hash_gather.scatter_add_rows_plain(idx, cot, n_rows)
    tol = hash_gather.scatter_add_tolerance(idx, cot, want)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    worst = float((err / tol.clamp_min(1e-30)).max())
    log(f"scatter_add_rows {label}: {idx.shape[0]} rows of {cot.shape[1]} {cot.dtype} into "
        f"{n_rows}: max abs err {float(err.max()):.4g}, {int((err > 0).sum())} elements "
        f"differ, worst err / tolerance {worst:.3g} (float32 reductions: the order varies from "
        f"run to run)")
    check(got.dtype == cot.dtype and worst <= 1.0,
          f"scatter_add_rows disagrees with its plain version on {label}")
    return float(err.max())


def gather_errors(label, table, idx):
    """Hold gather_rows against its plain version: exact. Returns 0.0."""
    import torch
    from nerf_tpu_torch.ops import hash_gather

    got = hash_gather.gather_rows(table, idx)
    want = hash_gather.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    log(f"gather_rows {label}: {idx.shape[0]} rows of {table.shape[1]} {table.dtype} from "
        f"{table.shape[0]}: {'exact' if same else 'DIFFERS'} against the plain version")
    check(same, f"gather_rows disagrees with gather_rows_plain on {label}")
    return 0.0


def hash_random_phase(dev):
    """B4 and its scatter-add on random tables of the config's sizes, at a
    train step's fine-batch row count with the encoder's index pattern; the
    scatter-add also on every index mix of tools/scatter_variants.py."""
    import torch
    from nerf_tpu_torch.tools import scatter_variants

    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {"gather": 0.0, "scatter": 0.0}
    for layout in ("cellpack", "corner"):
        shape, idx = _pattern_rows(dev, layout, HASH_ROWS, gen)
        table = (torch.rand((shape[0] * shape[1], shape[2]), generator=gen, device=dev) * 2
                 - 1).to(torch.bfloat16)
        errs["gather"] = max(errs["gather"], gather_errors(f"random {layout}", table, idx))
        cot = torch.randn((idx.shape[0], shape[2]), generator=gen, device=dev).to(torch.bfloat16)
        errs["scatter"] = max(errs["scatter"], scatter_errors(f"random {layout}", idx, cot,
                                                              table.shape[0]))
        counts = torch.bincount(idx.long(), minlength=table.shape[0])
        log(f"{layout}: {int((counts > 0).sum())} distinct rows of {idx.shape[0]}, the most "
            f"used {int(counts.max())} times")
        for mix in scatter_variants.MIXES:
            midx = scatter_variants.index_mix(mix, HASH_ROWS, table.shape[0], gen)
            errs["scatter"] = max(errs["scatter"], scatter_errors(f"{mix} {layout}", midx, cot,
                                                                  table.shape[0]))
    return errs


def hash_train_phase(root, tmp):
    """Train the hash-grid config from init tables through the entry point."""
    import numpy as np
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.train.checkpoint import load_checkpoint

    cfg_file = os.path.join(root, "configs/nerf/lego_hashgrid_cellpack.yaml")
    model_dir = os.path.join(tmp, "hash_model")
    opts = [*HASH_TRAIN_OVERRIDES, "trained_model_dir", model_dir,
            "record_dir", os.path.join(tmp, "hash_record")]
    cfg = make_cfg(cfg_file, opts)
    state, grid, launches, text, train_s = _drive_trainer(cfg_file, opts, _hash_counters())
    log(f"hash-grid train entry point: {train_s:.2f} s (data, init, {HASH_TRAIN_STEPS} steps, "
        f"ESS rebuild, checkpoint); launches {launches}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched by the hash path")
    losses = [float(v) for v in re.findall(r"\bloss: (\S+)", text)]
    chunk = int(cfg.get("scan_chunk", 50))
    check(len(losses) == -(-HASH_TRAIN_STEPS // chunk) and all(math.isfinite(v) for v in losses),
          f"logged losses {losses}")
    log(f"{len(losses)} logged losses, all finite: {losses[0]:.5f} ... {losses[-1]:.5f}")
    with np.load(os.path.join(model_dir, "latest.npz")) as data:
        n_leaves, step = len(data.files), int(data["leaf_104"])
        table_kind = data["leaf_16"].dtype.kind
    check(n_leaves == 105 and step == HASH_TRAIN_STEPS and table_kind == "V",
          f"checkpoint: {n_leaves} leaves, step {step}, table {table_kind}")
    back = load_checkpoint(model_dir, state)
    check(back is not None and back[0].step == step and back[1] == 0,
          "the hash-grid checkpoint does not load back through load_checkpoint")
    log(f"checkpoint: 105 leaves, step {step}, bf16 tables; loads back")
    return cfg, state, grid, launches


def hash_path_phase(service):
    """The gather and integrate against their plain versions on the first
    and the last render tile's own inputs, spied from the render itself."""
    import torch
    from nerf_tpu_torch.ops import hash_gather, integrate as tint
    from nerf_tpu_torch.render.rays import image_rays
    from nerf_tpu_torch.render.renderer import render_rays
    from nerf_tpu_torch.serve import look_at_pose

    dev, opts = service.device, service.opts
    pose = torch.as_tensor(look_at_pose(THETA0, PHI, RADIUS), device=dev)
    ro, rd = image_rays(SIZE, SIZE, service.K, pose)
    with _spy(hash_gather, "gather_rows") as seen_g, _spy(tint, "integrate") as seen_i:
        n = ro.shape[0]
        for t0 in (0, (n - 1) // opts.tile_rays * opts.tile_rays):
            sl = slice(t0, t0 + opts.tile_rays)
            gen = torch.Generator(device=dev).manual_seed(0)
            render_rays(service.params, ro[sl].contiguous(), rd[sl].contiguous(), opts,
                        grid=service.grid, generator=gen)
    check(len(seen_g) == 4 and len(seen_i) == 4, f"{len(seen_g)} gathers, {len(seen_i)} "
          "integrates in two tiles, expected 4 and 4")
    names = ["first tile coarse", "first tile fine", "last tile coarse", "last tile fine"]
    for label, (args, _) in zip(names, seen_g):
        gather_errors(label, *args)
    err = 0.0
    for label, (args, kw) in zip(names, seen_i):
        err = max(err, integrate_errors(f"hash {label}", *args[:3], kw["ert_threshold"],
                                        kw["sigma_activation"]))
    b3_rows = [integrate_times(f"hash-grid serving {label}", *args[:3], kw["ert_threshold"],
                               kw["sigma_activation"])
               for label, (args, kw) in zip(names[:2], seen_i[:2])]
    return err, b3_rows


def hash_grads_phase(cfg, state, grid, data, dev):
    """The scatter-add on one step's own fine inputs, and the whole step,
    kernels against plain, and integrate on the step's batches timed.
    Returns the scatter-add's error, the fine batch's gather and scatter
    inputs and the integrate times."""
    import torch
    from nerf_tpu_torch.ops import hash_gather, integrate as tint
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.state import loss_and_grads, sample_ray_batch

    opts = RenderOptions.from_cfg(cfg)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    gen = torch.Generator(device=dev).manual_seed(1)
    ro, rd, tgt = sample_ray_batch(gen, *data, int(cfg.task_arg.N_rays))
    rng = gen.get_state()
    with _spy(hash_gather, "gather_rows") as seen_g, \
            _spy(hash_gather, "scatter_add_rows") as seen_s, _spy(tint, "integrate") as seen_i:
        lk, _, gk = loss_and_grads(state.params, ro, rd, tgt, opts, grid, gen)
    seen_g, seen_s = [a for a, _ in seen_g], [a for a, _ in seen_s]
    check(len(seen_i) == 2, f"{len(seen_i)} integrates in one step, expected 2")
    b3_rows = [integrate_times(f"train batch {lbl}", *args[:3], kw["ert_threshold"],
                               kw["sigma_activation"])
               for lbl, (args, kw) in zip(("coarse", "fine"),
                                          sorted(seen_i, key=lambda c: c[0][1].shape[1]))]
    step = _hash_plain_steps(state.params, ro, rd, tgt, plain, grid, gen, rng)
    torch.cuda.synchronize()
    check(len(seen_g) == 2 and len(seen_s) == 2,
          f"{len(seen_g)} gathers and {len(seen_s)} scatter-adds in one step, expected 2 and 2")
    fine_s = max(seen_s, key=lambda c: c[0].shape[0])
    fine_g = max(seen_g, key=lambda c: c[1].shape[0])
    check(fine_s[0].shape[0] == HASH_ROWS, f"fine batch of {fine_s[0].shape[0]} rows")
    scatter_err = max(scatter_errors(f"train step {lbl}", *c) for lbl, c in
                      zip(("coarse", "fine"), sorted(seen_s, key=lambda c: c[0].shape[0])))
    hash_step_gate("trained", lk, gk, step, small_leaves=True)
    # the same batch from the initial parameters, where no density saturates
    # and alpha_linear's gradients do not vanish: every leaf at the relative
    # bound
    from nerf_tpu_torch.train.loop import init_nerf_params
    init = init_nerf_params(torch.Generator().manual_seed(3), opts, dev)
    gen.set_state(rng)
    lk0, _, gk0 = loss_and_grads(init, ro, rd, tgt, opts, grid, gen)
    step0 = _hash_plain_steps(init, ro, rd, tgt, plain, grid, gen, rng)
    hash_step_gate("initial", lk0, gk0, step0, small_leaves=False)
    return scatter_err, fine_g, fine_s, b3_rows


def _hash_plain_steps(params, ro, rd, tgt, plain, grid, gen, rng):
    """One step's (loss, stats, grads) through the plain versions, again, and
    with float32 MLP weights, each from the generator state ``rng``."""
    from nerf_tpu_torch.train.state import loss_and_grads

    step = {}
    for name, o in (("plain", plain), ("again", plain),
                    ("plain32", dataclasses.replace(plain, compute_dtype="float32"))):
        gen.set_state(rng)
        step[name] = loss_and_grads(params, ro, rd, tgt, o, grid, gen)
    return step


def hash_step_gate(label, lk, gk, step, small_leaves):
    """The hash-grid step's gate: loss within HASH_STEP_LOSS_REL; a leaf
    within max(HASH_GRAD_REL, OVER_BF16_SPREAD x bf16's own spread) in
    relative norm. With ``small_leaves``, a leaf whose plain gradient norm is
    below HASH_SMALL_LEAF of the largest leaf's is held to that bound times
    the largest leaf's norm in absolute distance instead (its relative
    distance is noise); those leaves are printed with their norms."""
    (lp, _, gp), (_, _, g32) = step["plain"], step["plain32"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    norms = [float(b.double().norm()) for b in gp]
    top = max(norms)
    ratios, small = [], []
    for i, (a, b, c) in enumerate(zip(gk, gp, g32)):
        e, spread = _rel(a, b)[0], _rel(b, c)[0]
        bound = max(HASH_GRAD_REL, OVER_BF16_SPREAD * spread)
        if small_leaves and norms[i] < HASH_SMALL_LEAF * top:
            dist = float((a.double() - b.double()).norm())
            small.append(f"leaf {i}: norm {norms[i]:.3g}, distance {dist:.3g} (tol "
                         f"{bound * top:.3g})")
            ratios.append((dist / (bound * top), i, e, spread))
        else:
            ratios.append((e / bound, i, e, spread))
    held = [x for x in ratios if not (small_leaves and norms[x[1]] < HASH_SMALL_LEAF * top)]
    r, i, e, spread = max(held)
    errs = sorted(x[2] for x in held)
    again = _rel(step["again"][2][i], gp[i])[0]
    log(f"hash train step ({label} parameters), kernels vs plain on one batch: loss "
        f"{float(lk):.7f} vs {float(lp):.7f} (rel {loss_rel:.3g}, tol {HASH_STEP_LOSS_REL}); "
        f"gradients of {len(held)} of {len(gk)} leaves in relative norm: median "
        f"{errs[len(errs) // 2]:.4g}, max {errs[-1]:.4g}; the tables' (16, 33): "
        f"{ratios[16][2]:.4g}, {ratios[33][2]:.4g}; worst against bf16's own spread: leaf {i}, "
        f"{e:.4g} against {spread:.4g} (tol max({HASH_GRAD_REL}, {OVER_BF16_SPREAD} x)); the "
        f"plain path run again: {again:.4g}; largest leaf norm {top:.4g}")
    if small_leaves:
        log(f"hash train step ({label}): {len(small)} leaves below {HASH_SMALL_LEAF} x the "
            f"largest norm, held in absolute distance to the bound x {top:.4g}: "
            + ("; ".join(small) or "none"))
    else:
        log(f"hash train step ({label}): leaf norms " + ", ".join(f"{v:.3g}" for v in norms))
    check(math.isfinite(float(lk)) and loss_rel <= HASH_STEP_LOSS_REL,
          f"hash train step loss disagrees ({label} parameters)")
    check(max(x[0] for x in ratios) <= 1.0,
          f"hash train step gradients disagree ({label} parameters)")


def gather_times(label, table, idx):
    """B4 alone on (table [R, W], idx [N]), exact against its plain version
    on these rows, timed beside its bound, sector floor, plain version and
    library call (torch.index_select), which B4 must beat on rows of 4
    bytes."""
    import torch
    from nerf_tpu_torch.ops import hash_gather

    gather_errors(f"{label} (timed rows)", table, idx)
    n = idx.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=table.dtype, device=table.device)
    lib, stream = hash_gather._lib(), torch.cuda.current_stream().cuda_stream
    row_b = table.shape[1] * table.element_size()
    gargs = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.shape[0], n, row_b, stream)
    check(lib.launch_gather_rows(*gargs) == 0, "launch_gather_rows failed")
    times = [time_ms(lambda: lib.launch_gather_rows(*gargs), reps=50) for _ in range(2)]
    ms = sum(times) / 2
    plain_ms = time_ms(lambda: hash_gather.gather_rows_plain(table, idx), reps=20)
    library_ms = time_ms(lambda: torch.index_select(table, 0, idx), reps=20)
    distinct = int(torch.unique(idx).numel())
    # bytes these inputs need: each index once, each distinct row once, each
    # gathered row written once; and the same at 32-byte sector grain
    nbytes, sector_bytes = hash_gather.gather_bytes(idx, row_b)
    bound = nbytes / PEAK_BYTES * 1e3
    floor = sector_bytes / PEAK_BYTES * 1e3
    log(f"gather_rows {label}, {n} rows of {row_b} B ({distinct} distinct of {table.shape[0]}): "
        f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s of the bound's bytes, "
        f"{bound / ms:.3f} of the bound; {', '.join(f'{t:.4f}' for t in times)}), plain "
        f"{plain_ms:.4f} ms, torch.index_select "
        f"{library_ms:.4f} ms, bound {bound:.4f} ms, sector floor {floor:.4f} ms (HBM; a "
        f"table that fits the 50 MB L2 serves repeated rows for less)")
    if row_b == 4:
        check(ms < library_ms, f"B4 on {label} is not faster than index_select")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms, "sector_floor_ms": floor}


def scatter_times(label, sidx, cot, n_rows):
    """B4' alone and its three launches alone beside its bound, byte floor,
    plain version and library call (index_add_ in the cotangent's dtype)."""
    import torch
    from nerf_tpu_torch.ops import hash_gather

    n, width = cot.shape
    dev = cot.device
    lib, stream = hash_gather._lib(), torch.cuda.current_stream().cuda_stream
    acc = torch.empty((n_rows, width), device=dev)
    res = torch.empty((n_rows, width), dtype=cot.dtype, device=dev)
    sargs = (sidx.data_ptr(), cot.data_ptr(), acc.data_ptr(), res.data_ptr(), n_rows, n, width,
             int(cot.dtype == torch.bfloat16))
    check(lib.launch_scatter_add_rows(*sargs, stream) == 0, "launch_scatter_add_rows failed")
    times = [time_ms(lambda: lib.launch_scatter_add_rows(*sargs, stream), reps=50)
             for _ in range(2)]
    sms = sum(times) / 2
    parts = [time_ms(lambda: lib.launch_scatter_add_rows_part(*sargs, i, stream), reps=50)
             for i in range(3)]
    splain_ms = time_ms(lambda: hash_gather.scatter_add_rows_plain(sidx, cot, n_rows), reps=20)
    lib_buf = torch.empty((n_rows, width), dtype=cot.dtype, device=dev)
    slib_ms = time_ms(lambda: lib_buf.zero_().index_add_(0, sidx, cot), reps=20)
    # indices and cotangent rows read once, the gradient table written once
    snbytes = 4 * n + n * width * cot.element_size() + n_rows * width * cot.element_size()
    sbound = snbytes / PEAK_BYTES * 1e3
    # this design's floor: also the float32 buffer zeroed, then read by the rounding
    floor = (snbytes + 2 * n_rows * width * 4) / PEAK_BYTES * 1e3
    runs = int(hash_gather.warp_runs(sidx)[2][:n].sum())
    log(f"scatter_add_rows {label}, {n} rows of {width} {cot.dtype} into {n_rows} ({runs} runs "
        f"in warps of 32 rows): kernel {sms:.4f} ms ({', '.join(f'{t:.4f}' for t in times)}); "
        f"its launches alone: memset {parts[0]:.4f}, accumulation {parts[1]:.4f}, rounding "
        f"{parts[2]:.4f} ms; plain {splain_ms:.4f} ms, "
        f"index_add_ in {cot.dtype} {slib_ms:.4f} ms, bound {sbound:.4f} ms ({sbound / sms:.3f} "
        f"of it), this design's byte floor {floor:.4f} ms")
    return {"ms": sms, "plain_ms": splain_ms, "bound_ms": sbound, "bound_by": "bytes",
            "library_ms": slib_ms}


def hash_times_phase(cfg, state, grid, data, dev, fine_g, fine_s):
    """A window of warm hash-grid train steps; the gather and the scatter-add
    on the fine batch beside their bounds, plain versions and library calls."""
    import numpy as np
    import torch
    from nerf_tpu_torch.ops import hash_gather
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import train_step

    opts = RenderOptions.from_cfg(cfg)
    tx = make_optimizer(cfg)
    n_rays = int(cfg.task_arg.N_rays)
    gen = torch.Generator(device=dev).manual_seed(3)
    for _ in range(3):
        train_step(state, *data, tx, opts, n_rays, grid, gen)
    torch.cuda.synchronize()
    for c in _hash_counters().values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    t0 = time.perf_counter()
    for _ in range(HASH_STEP_WINDOW):
        t = time.perf_counter()
        train_step(state, *data, tx, opts, n_rays, grid, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    window = time.perf_counter() - t0
    per_step = {k: c.launches / HASH_STEP_WINDOW for k, c in _hash_counters().items()}
    w = np.array(times) * 1e3
    step_ms = window * 1e3 / HASH_STEP_WINDOW
    log(f"hash train step window of {HASH_STEP_WINDOW} warm steps: {step_ms:.3f} ms per step, "
        f"{n_rays * HASH_STEP_WINDOW / window:.0f} train rays/s; per step min {w.min():.3f}, "
        f"median {np.median(w):.3f}, max {w.max():.3f}, std {w.std():.3f} ms; launches per "
        f"step {per_step}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    gather = gather_times("fine batch", *fine_g)
    scatter = scatter_times("fine batch", *fine_s)
    return gather, scatter, step_ms


def b3_summary(rows):
    """integrate at every shape it runs at, and its launches x (time - bound)
    per request and per step. A lego request composites 5 tiles (4 of 8192
    rays and one of 7232), coarse and fine: 5 x each first-tile pass, a
    little above the truth; a hash-grid request 40 tiles of 1024 rays,
    coarse and fine; a train step of either model one batch of 1024 rays,
    coarse and fine (timed on the hash-grid step's)."""
    for r in rows:
        log(f"B3 {r['label']:<30} N={r['n']:>5} S={r['s']:>3}: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of it")
    lost = {r["label"]: r["ms"] - r["bound_ms"] for r in rows}
    for what, counts in (("lego request", {"lego tile coarse": 5, "lego tile fine": 5}),
                         ("hash-grid request", {"hash-grid serving first tile coarse": 40,
                                                "hash-grid serving first tile fine": 40}),
                         ("train step", {"train batch coarse": 1, "train batch fine": 1})):
        log(f"B3 launches x (time - bound) per {what}: "
            f"{sum(c * lost[k] for k, c in counts.items()):.4f} ms")


# The evaluation slice (phases 15-19): a Blender-layout scene of the lego
# model's own renders at the reference's 800x800, through the port's CLIs.
SCENE = 800
CAMERA_ANGLE_X = 0.6911112070083618  # lego's transforms_*.json
SCENE_PHI = 0.45
# split -> (views, first theta): 8 test, 2 val and 8 train poses on the orbit
SCENE_SPLITS = {"test": (8, 0.15), "val": (2, 0.55), "train": (8, 0.35)}
EVAL_PSNR_MIN, EVAL_SSIM_MIN = 40.0, 0.99
COMPACTION_MARGIN = 1.25  # the fixed fraction's headroom over the measured kept rate
COMPACTION_MAX = 0.99  # ... and its ceiling, below a tile's points
MARCH_CHECK = 100  # the marched frame through kernels and plain versions, 100x100
HASH_SCENE = 200
BLENDER_TRAIN_STEPS = 20


def scene_K(size, dev):
    import torch

    f = 0.5 * size / math.tan(0.5 * CAMERA_ANGLE_X)
    return torch.tensor([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], dtype=torch.float32,
                        device=dev)


def scene_poses(split):
    import numpy as np
    from nerf_tpu_torch.serve import look_at_pose

    n, t0 = SCENE_SPLITS[split]
    return np.stack([look_at_pose(t0 + 2.0 * math.pi * i / n, SCENE_PHI, RADIUS)
                     for i in range(n)])


def render_rgba(params, opts, grid, pose, K, size, seed):
    """One frame through the renderer -> RGBA uint8 [size, size, 4]: alpha
    from acc_map, the colour un-whitened (rgb = c + (1 - acc), c = u * acc),
    so that the loader's white composite u * a + (1 - a) gives the render
    back within 8-bit rounding. The jitter is seeded with ``seed``: the
    evaluator's seed of a test view, so that it renders the same frame."""
    import torch
    from nerf_tpu_torch.render.renderer import render_image

    out = render_image(params, torch.as_tensor(pose, device=K.device), K, size, size, opts,
                       grid=grid, generator=torch.Generator(device=K.device).manual_seed(seed))
    rgb, acc = out["rgb_map"], out["acc_map"].clamp(0, 1)
    c = rgb - (1.0 - acc)[..., None] if opts.white_bkgd else rgb
    u = torch.where(acc[..., None] > 0, c / acc.clamp_min(1e-12)[..., None], 0.0)
    rgba = torch.cat([u.clamp(0, 1), acc[..., None]], -1)
    return (rgba * 255).round().to(torch.uint8).cpu().numpy()


def write_scene(root, service, size, splits, label):
    """Render ``service``'s model at size x size for each split -> number of
    views, and write the Blender-layout scene under root/lego; check every
    PNG decodes to exactly what was encoded; print the codec's rates."""
    import numpy as np
    import torch
    from nerf_tpu_torch.data.blender import write_blender_scene
    from nerf_tpu_torch.utils.png import read_png

    params, opts, grid = service.params, service.opts, service.grid
    K = scene_K(size, service.device)
    frames = {}
    t = time.perf_counter()
    for split, n in splits.items():
        poses = scene_poses(split)[:n]
        frames[split] = (np.stack([render_rgba(params, opts, grid, p, K, size, i)
                                   for i, p in enumerate(poses)]), poses)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    n = sum(len(f[0]) for f in frames.values())
    t = time.perf_counter()
    # rows cycle through the five PNG filters, as an encoder's adaptive choice mixes them
    write_blender_scene(os.path.join(root, "lego"), frames, CAMERA_ANGLE_X,
                        filters=np.arange(size) % 5)
    encode_s = time.perf_counter() - t
    t = time.perf_counter()
    for split, (imgs, _) in frames.items():
        for i, img in enumerate(imgs):
            back = read_png(os.path.join(root, "lego", split, f"r_{i}.png"))
            check(back.shape == img.shape and bool((back == img).all()),
                  f"{split}/r_{i}.png does not decode to the encoded pixels")
    decode_s = time.perf_counter() - t
    counts = ", ".join(f"{k} {len(v[0])}" for k, v in frames.items())
    log(f"{label} scene: {n} RGBA frames {size}x{size} ({counts}) "
        f"rendered in {render_s:.2f} s; PNG (filters 0-4 by row) encoded and written at "
        f"{n / encode_s:.2f} frames/s ({encode_s / n * 1e3:.1f} ms a frame), read and decoded "
        f"at {n / decode_s:.2f} frames/s ({decode_s / n * 1e3:.1f} ms a frame, one thread), "
        f"every frame exactly as encoded")
    return frames, decode_s / n


def _scene_opts(root, scene_dir, extra=()):
    """The lego config's overrides for the scene: its data, the committed
    checkpoint, a workspace in the scene's directory."""
    opts = ["trained_model_dir", os.path.join(root, "checkpoints/nerf/lego/nerf"),
            "workspace", os.path.join(scene_dir, "ws")]
    for split in ("train", "test"):
        opts += [f"{split}_dataset.data_root", scene_dir, f"{split}_dataset.H", str(SCENE),
                 f"{split}_dataset.W", str(SCENE)]
    return opts + list(extra)


def _run_cli(fn, argv):
    """Run a CLI's main in-process; its output goes to stdout and is returned.
    Returns (its result, its output, seconds to a synchronize after it)."""
    import torch

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        out = fn(argv)
    torch.cuda.synchronize()
    return out, buf.getvalue(), time.perf_counter() - t


def scene_phase(root, work, service):
    """Phase 15: the lego scene, and the Blender loader's read of its test split."""
    import numpy as np
    from nerf_tpu_torch.data.blender import BlenderDataset

    scene_dir = os.path.join(work, "lego_scene")
    frames, decode_frame_s = write_scene(scene_dir, service, SCENE,
                                         {k: v[0] for k, v in SCENE_SPLITS.items()}, "lego")
    t = time.perf_counter()
    ds = BlenderDataset(data_root=scene_dir, split="test", H=SCENE, W=SCENE)
    load_s = time.perf_counter() - t
    imgs, _ = frames["test"]
    f = imgs.astype(np.float32) / 255.0
    want = f[..., :3] * f[..., 3:] + (1.0 - f[..., 3:])
    check(bool(np.allclose(ds.images, want, atol=1e-6)), "the loader's composite differs")
    log(f"BlenderDataset test split ({len(ds)} frames, {os.cpu_count()} threads): "
        f"{load_s:.3f} s, {len(ds) / load_s:.2f} frames/s")
    return scene_dir, decode_frame_s, len(ds) / load_s


def run_phase(root, scene_dir):
    """Phase 16: run --type dataset and --type network on the scene."""
    from nerf_tpu_torch import run

    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    ds, _, secs = _run_cli(run.main, ["--type", "dataset", "--cfg_file", cfg_file,
                                        *_scene_opts(root, scene_dir)])
    check(len(ds) == SCENE_SPLITS["train"][0] and ds.images.shape[1:] == (SCENE, SCENE, 3),
          f"run --type dataset: {len(ds)} frames")
    log(f"run --type dataset: {len(ds)} train frames in {secs:.2f} s")
    s, _, secs = _run_cli(run.main, ["--type", "network", "--cfg_file", cfg_file,
                                       *_scene_opts(root, scene_dir)])
    check(s["frames"] == 4 and s["rays_per_s"] > 0, f"run --type network: {s}")
    log(f"run --type network: {SCENE}x{SCENE} lego frame {s['mean_time_s'] * 1e3:.1f} ms "
        f"({s['rays_per_s']:.0f} rays/s, {s['fps']:.3f} fps) over {s['frames']} frames after "
        f"the first; {secs:.2f} s with the ESS rebuild")
    return s


def _avi_frames(path):
    with open(path, "rb") as f:
        data = f.read()
    i = data.index(b"avih") + 8
    return int.from_bytes(data[i + 16:i + 20], "little")


def evaluate_phase(root, scene_dir, counters):
    """Phase 17: run --type evaluate with the video, then compaction."""
    from nerf_tpu_torch import run

    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    result = os.path.join(scene_dir, "result")
    for c in counters.values():
        c.launches = 0
    summary, text, secs = _run_cli(run.main, [
        "--type", "evaluate", "--cfg_file", cfg_file,
        *_scene_opts(root, scene_dir, ["write_video", "True", "render_num", "8",
                                       "result_dir", result])])
    launches = {k: c.launches for k, c in counters.items()}
    log(f"run --type evaluate: {secs:.2f} s; launches {launches}")
    check(all(v > 0 for v in launches.values()), "evaluate did not launch every kernel")
    with open(os.path.join(result, "metrics", "evaluation_results.json")) as f:
        per = json.load(f)["per_image"]
    n_test = SCENE_SPLITS["test"][0]
    check(len(per) == n_test, f"{len(per)} views evaluated")
    worst = (min(p["psnr"] for p in per), min(p["ssim"] for p in per))
    log(f"evaluate: {n_test} views, PSNR {worst[0]:.2f} dB at worst (min {EVAL_PSNR_MIN}), "
        f"SSIM {worst[1]:.5f} at worst (min {EVAL_SSIM_MIN}); mean PSNR "
        f"{summary['avg_psnr']:.2f}, SSIM {summary['avg_ssim']:.5f}")
    check(worst[0] >= EVAL_PSNR_MIN and worst[1] >= EVAL_SSIM_MIN,
          "an evaluated view is below the PSNR/SSIM gate")
    fps = re.search(r"mean net_time: (\S+)s  fps: (\S+)  rays/s: (\S+)", text)
    check(fps is not None, "evaluate printed no fps line")
    log(f"evaluate: {float(fps.group(1)) * 1e3:.1f} ms a frame, {fps.group(2)} fps, "
        f"{fps.group(3)} rays/s")
    frames = sorted(os.listdir(os.path.join(result, "frames")))
    check(frames == [f"view{i:04d}_rgb.png" for i in range(8)], f"spiral frames {frames}")
    videos = sorted(os.listdir(os.path.join(result, "videos")))
    check(len(videos) == 2, f"videos {videos}")
    for v in videos:
        path = os.path.join(result, "videos", v)
        n = _avi_frames(path) if v.endswith(".avi") else (8 if os.path.getsize(path) else 0)
        check(n == 8, f"{v}: {n} frames")
    log(f"spiral: {len(frames)} frames, videos {videos} of 8 frames each")
    return {"fps": float(fps.group(2)), "ms": float(fps.group(1)) * 1e3, "seconds": secs}


def compaction_phase(root, scene_dir, errs, dev):
    """Phase 17 (continued): ess_compaction auto, then a fixed fraction
    COMPACTION_MARGIN x the measured kept rate against the dense frame; B1
    on one compacted fine batch against its plain version."""
    import torch
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.render import renderer as rend
    from nerf_tpu_torch.render.rays import image_rays
    from nerf_tpu_torch.run import load_eval_model

    cfg = make_cfg(os.path.join(root, "configs/nerf/lego.yaml"), _scene_opts(root, scene_dir))
    opts, params, grid = load_eval_model(cfg, dev)
    K = scene_K(SCENE, dev)
    pose = torch.as_tensor(scene_poses("test")[0], device=dev)
    ro, rd = image_rays(SCENE, SCENE, K, pose)
    mid = SCENE * SCENE // 2
    po, pd = ro[mid - 2048:mid + 2048].contiguous(), rd[mid - 2048:mid + 2048].contiguous()
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    auto = rend.resolve_compaction(dataclasses.replace(opts, ess_compaction=-1.0), params, grid,
                                   po, pd, gen())
    out = rend.render_rays(params, po, pd, opts, grid=grid, generator=gen())
    pts_f = po[:, None, :] + pd[:, None, :] * out["fine_z_vals"][..., None]
    kept = float(rend.fine_pass_mask(grid, pts_f).float().mean())
    n_tile = opts.tile_rays * out["fine_z_vals"].shape[1]
    # at least COMPACTION_MARGIN x kept, but below every point of a tile, so
    # that the compacted path runs (at a kept rate near 0.9 the margin asks
    # for more than a tile holds)
    cap = min(rend.compaction_capacity(n_tile, COMPACTION_MARGIN * kept),
              rend.compaction_capacity(n_tile, COMPACTION_MAX))
    frac = cap / n_tile
    log(f"compaction: auto -> {auto.ess_compaction:.4f}; the probe's (middle 4096 rays of view "
        f"0) fine-pass kept rate {kept:.4f}; fixed fraction {frac:.4f}, capacity {cap} of "
        f"{n_tile} a tile ({COMPACTION_MARGIN} x kept would be "
        f"{COMPACTION_MARGIN * kept:.4f}; at most {COMPACTION_MAX})")
    comp = dataclasses.replace(opts, ess_compaction=frac)

    def frame(o):
        return rend.render_image(params, pose, K, SCENE, SCENE, o, grid=grid,
                                 generator=gen())["rgb_map"]

    with _spy(fused_mlp, "fused_nerf_eval") as seen:
        rgb_c = frame(comp)
    batches = [a for a, _ in seen if a[1].shape[0] == cap]
    check(len(batches) > 0, "no compacted batch reached B1")
    kp, pts, dirs = batches[len(batches) // 2][:3]
    errs.append(fused_errors(f"compacted fine batch [{pts.shape[0]}, 1, 3]", kp, pts, dirs))
    rgb_d = frame(opts)
    psnr = -10.0 * math.log10(max(float(torch.mean((rgb_c - rgb_d) ** 2)), 1e-20))
    times = {}
    for name, o in (("dense", opts), ("compacted", comp), ("compacted", comp), ("dense", opts)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        frame(o)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t)
    dense_ms = sum(times["dense"]) / 2 * 1e3
    comp_ms = sum(times["compacted"]) / 2 * 1e3
    turns = (times["dense"][0], *times["compacted"], times["dense"][1])
    log(f"compaction at {frac:.4f}: frame {SCENE}x{SCENE} {comp_ms:.1f} ms, dense {dense_ms:.1f} "
        f"ms (turns dense, compacted, compacted, dense: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in turns)}); "
        f"compacted vs dense frame PSNR {psnr:.2f} dB (min {PSNR_MIN_DB}); "
        f"{len(batches)} compacted fine batches of {pts.shape[0]} points")
    check(psnr >= PSNR_MIN_DB, "the compacted frame disagrees with the dense frame")
    return {"auto": auto.ess_compaction, "kept": kept, "frac": frac, "ms": comp_ms,
            "dense_ms": dense_ms, "psnr": psnr}


def marched_phase(root, scene_dir, dev):
    """Phase 18: run --type marched on the scene, then the marched frame at
    100x100 through the kernels against the plain versions."""
    import torch
    from nerf_tpu_torch import run
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.render.marched import render_image_marched
    from nerf_tpu_torch.run import load_eval_model

    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    before = fused_mlp.fused_nerf_eval.launches
    res, _, secs = _run_cli(run.main, ["--type", "marched", "--cfg_file", cfg_file,
                                         *_scene_opts(root, scene_dir)])
    h, m = res["hierarchical"], res["marched"]
    b1 = fused_mlp.fused_nerf_eval.launches - before
    log(f"run --type marched ({secs:.2f} s; B1 launches {b1}): "
        f"hierarchical {h['seconds'] * 1e3:.1f} ms a frame, PSNR {h['psnr']:.2f} dB; marched "
        f"{m['seconds'] * 1e3:.1f} ms, PSNR {m['psnr']:.2f} dB (16 blocks x 16 samples)")
    check(all(math.isfinite(r["psnr"]) for r in res.values()), "marched PSNR not finite")
    opts, params, grid = load_eval_model(make_cfg(cfg_file, _scene_opts(root, scene_dir)), dev)
    K = scene_K(MARCH_CHECK, dev)
    pose = torch.as_tensor(scene_poses("test")[0], device=dev)
    k = render_image_marched(params, pose, K, MARCH_CHECK, MARCH_CHECK, opts, grid=grid)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    p = render_image_marched(params, pose, K, MARCH_CHECK, MARCH_CHECK, plain, grid=grid)
    psnr = -10.0 * math.log10(max(float(torch.mean((k["rgb_map"] - p["rgb_map"]) ** 2)), 1e-20))
    log(f"marched {MARCH_CHECK}x{MARCH_CHECK}, kernels vs plain versions: PSNR {psnr:.2f} dB "
        f"(min {PSNR_MIN_DB}), acc mean {float(k['acc_map'].mean()):.4f}")
    check(bool(torch.isfinite(k["rgb_map"]).all()) and psnr >= PSNR_MIN_DB,
          "the marched frame through the kernels disagrees with the plain versions")
    return {"hier_ms": h["seconds"] * 1e3, "hier_psnr": h["psnr"], "march_ms": m["seconds"] * 1e3,
            "march_psnr": m["psnr"], "kernel_vs_plain_psnr": psnr}


def hash_eval_phase(root, work, hservice, hcfg):
    """Phase 18 (continued): one hash-grid test view at 200x200, rendered
    from phase 11's model, through run --type evaluate (B4 on the eval path)."""
    from nerf_tpu_torch import run

    scene_dir = os.path.join(work, "hash_scene")
    write_scene(scene_dir, hservice, HASH_SCENE, {"test": 1}, "hash-grid")
    counters = _hash_counters()
    for c in counters.values():
        c.launches = 0
    result = os.path.join(scene_dir, "result")
    summary, _, secs = _run_cli(run.main, [
        "--type", "evaluate", "--cfg_file",
        os.path.join(root, "configs/nerf/lego_hashgrid_cellpack.yaml"),
        "trained_model_dir", hcfg.trained_model_dir, "test_dataset.data_root", scene_dir,
        "test_dataset.H", str(HASH_SCENE), "test_dataset.W", str(HASH_SCENE),
        "write_video", "False", "result_dir", result, "workspace", os.path.join(scene_dir, "ws")])
    launches = {k: c.launches for k, c in counters.items()}
    log(f"hash-grid run --type evaluate, one {HASH_SCENE}x{HASH_SCENE} view: {secs:.2f} s, "
        f"PSNR {summary['avg_psnr']:.2f} dB, SSIM {summary['avg_ssim']:.5f}; launches {launches}")
    check(launches["hash_gather_rows"] > 0 and launches["integrate"] > 0,
          "the hash-grid evaluation did not launch the gather and integrate")
    check(summary["avg_psnr"] >= EVAL_PSNR_MIN, "the hash-grid view is below the PSNR gate")


def blender_train_phase(root, work, scene_dir, counters):
    """Phase 19: the trainer on the Blender scene from the resumed epoch-49
    state, BLENDER_TRAIN_STEPS steps, an ESS rebuild and one validation;
    then --test on the checkpoint it wrote."""
    from nerf_tpu_torch.train.__main__ import main as train_main

    model_dir = os.path.join(work, "blender_model")
    os.makedirs(model_dir)
    src = os.path.join(root, "checkpoints/nerf/lego/nerf")
    for f in ("latest.npz", "latest.json"):
        shutil.copy(os.path.join(src, f), model_dir)
    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    opts = [*_scene_opts(root, scene_dir), "trained_model_dir", model_dir,
            "record_dir", os.path.join(work, "blender_record"), "ep_iter",
            str(BLENDER_TRAIN_STEPS), "train.epoch", "51", "eval_ep", "51",
            "grid_rebuild_ep", "1", "log_interval", "10"]
    _, _, launches, text, secs = _drive_trainer(cfg_file, opts, counters)
    log(f"train on the Blender scene: {secs:.2f} s (load, resume, {BLENDER_TRAIN_STEPS} steps, "
        f"ESS rebuild, validation, checkpoint); launches {launches}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched by the train path")
    check("skipping validation" not in text, "validation was skipped")
    val = re.findall(r"val psnr: (\S+)", text)
    check(len(val) == 1, f"validation lines {val}")
    rate = re.search(r"epoch 50 done in (\S+)s  \((\S+) train rays/s\)", text)
    check(rate is not None, "no epoch line")
    step_ms = float(rate.group(1)) * 1e3 / BLENDER_TRAIN_STEPS
    log(f"Blender-data train: {step_ms:.2f} ms a step over the epoch of {BLENDER_TRAIN_STEPS} "
        f"(first steps included), {rate.group(2)} train rays/s; val psnr {val[0]}")
    result = os.path.join(work, "blender_test")
    _, _, secs = _run_cli(train_main, ["--test", "--cfg_file", cfg_file, *opts,
                                         "write_video", "False", "result_dir", result])
    with open(os.path.join(result, "metrics", "evaluation_results.json")) as f:
        summary = json.load(f)["summary"]
    check(summary["num_images"] == SCENE_SPLITS["test"][0] and
          math.isfinite(summary["avg_psnr"]), f"--test summary {summary}")
    log(f"train --test on that checkpoint: {secs:.2f} s, mean PSNR {summary['avg_psnr']:.2f} dB, "
        f"SSIM {summary['avg_ssim']:.5f}")
    return {"step_ms": step_ms, "val_psnr": float(val[0])}


# The float32 slice (phases 20-24): B1-f32 and B2-f32 (network.dtype
# float32), frequency NeRFs of another shape, whole-image training.
F32_SIZES = RAGGED_SIZES + (196_608,)
F32_N_TIMED = 8  # float32 requests in the timed window
F32_TRAIN_STEPS = 10
F32_STEP_REPS = 10  # warm float32 loss-and-gradient calls timed in phase 22
F32_TRAIN_OVERRIDES = ["train_dataset_module", "synthetic", "train_dataset.n_images", "10",
                       "train_dataset.H", "800", "train_dataset.W", "800",
                       "network.dtype", "float32", "train.epoch", "51",
                       "ep_iter", str(F32_TRAIN_STEPS), "log_interval", "5", "scan_chunk", "5"]
SMALL_NERF = ["network.nerf.D", "4", "network.nerf.W", "64", "network.nerf.skips", "[2]",
              "network.xyz_encoder.freq", "6", "network.dir_encoder.freq", "2"]
SMALL_TRAIN_STEPS = 100
FULL_IMAGE = 200  # the whole-image step's frame, H = W


class _GradSpy:
    """An optimizer that keeps the gradients it is handed, then steps."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def step(self, leaves, grads, opt_state):
        self.grads = [g.clone() for g in grads]
        self.tx.step(leaves, grads, opt_state)


def _f32_counters():
    from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd, integrate as tint

    return {"fused_nerf_eval_f32": fused_mlp.fused_nerf_eval_f32,
            "fused_nerf_bwd_f32": fused_mlp_bwd.fused_nerf_bwd_f32, "integrate": tint.integrate}


def f32_dw_times(label, kp, pts, dirs, g):
    """B2-f32 on one batch (no input gradients, as the train step calls it):
    its weight-gradient launch (3xTF32, tensor cores) timed twice (each CUDA
    events over 3 calls); the whole backward and its four launches; the
    weight gradients against the 3xTF32 bound and their byte floor, the
    whole backward against the float32 bound and the bound with dW in
    3xTF32; each leaf's distance from the plain version summed in float64,
    the largest of the kernel's and the plain version's in float32. Returns
    the times."""
    from nerf_tpu_torch.ops import fused_mlp_bwd as fb
    from nerf_tpu_torch.tools import f32_check

    n = pts.shape[0]
    full = fb.launch_f32(kp, pts, dirs, g, input_grads=False)
    lib = fb._lib_f32()[0]

    def timed(phases):
        args = list(full["args"])
        args[-2] = phases
        return time_ms(lambda: lib.launch_fused_nerf_bwd_f32(*args), reps=3)

    dws = [timed(4) for _ in range(2)]
    dw = sum(dws) / 2
    t = {name: timed(ph) for name, ph in (("all", fb.F32_PHASES_ALL), ("forward + stash", 1),
                                          ("chain", 2), ("weight gradients", 4), ("reduce", 8))}
    splits = fb.f32_splits_for(min(n + (-n) % fb.F32_TILE, fb.F32_CHUNK))
    tc, floor = f32_check.dw_bound_ms(n), f32_check.dw_byte_floor_ms(n, splits)
    b32, bmix = f32_check.bwd_bound_ms(n), f32_check.bwd_bound_ms(n, tf32_dw=True)
    dist = f32_check.float64_distances(kp, pts, dirs, g, {
        "B2-f32": lambda *a: fb.launch_f32(*a, input_grads=False)["kgrads"]})
    log(f"B2-f32 dW on {label}, {n} pts: 3xTF32 {dw:.4f} ms "
        f"({', '.join(f'{v:.4f}' for v in dws)}); 3xTF32 bound {tc:.4f} ms at 495/3 TFLOP/s "
        f"({tc / dw:.3f}), byte floor {floor:.4f} ms ({floor / dw:.3f})")
    log(f"B2-f32 on {label}: whole {t['all']:.4f} ms; "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items() if k != "all")
        + f" ms; float32 bound {b32:.4f} ms ({b32 / t['all']:.3f}), bound with dW in 3xTF32 "
        f"{bmix:.4f} ms ({bmix / t['all']:.3f})")
    log(f"B2-f32 on {label}, largest leaf distance from the plain version in float64 "
        f"(max|k - p64| / max|p64|, knife-edge points masked): "
        + "; ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in dist.items()))
    return t


def f32_random_phase(params, dev):
    """Phase 20: B1-f32 and B2-f32 against their float32 plain versions on
    random points at the ragged sizes and 196,608; every ragged prefix
    launched alone equals the same rows of the largest launch (raw, dpts,
    ddirs). Returns (the forward's errors, B2-f32's largest |err|)."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd as fb
    from nerf_tpu_torch.tools import f32_check

    kp = {k: v.to(dev) for k, v in
          fused_mlp.repack_params(params["fine"], weight_dtype=torch.float32).items()}
    gen = torch.Generator(device=dev).manual_seed(11)
    fwd_errs, bwd_abs = [], 0.0
    for n in F32_SIZES:
        pts = torch.rand((n, 3), generator=gen, device=dev) * 3.0 - 1.5
        d = torch.randn((n, 3), generator=gen, device=dev)
        d = d / d.norm(dim=-1, keepdim=True)
        g = torch.randn((n, 4), generator=gen, device=dev)
        fwd_errs.append(f32_check.forward_errors(kp, pts, d))
        b = f32_check.backward_errors(kp, pts, d, g)
        torch.cuda.synchronize()
        log(f"B1-f32 on {n} random pts: rel err {fwd_errs[-1][0]:.3g} (the plain version in "
            f"float32 against float64: {fwd_errs[-1][1]:.3g}); B2-f32: worst {b['leaf']} at "
            f"{b['worst']:.3g} of its bound, {b['masked']} knife-edge points zeroed")
        check(b["worst"] <= 1.0, f"B2-f32 disagrees with its plain version on {n} points")
        bwd_abs = max(bwd_abs, b["abs"])
    full = fused_mlp.fused_nerf_eval(kp, pts, d)
    whole = fb.fused_nerf_bwd(kp, pts, d, g)
    for m in RAGGED_SIZES:
        sl = [t[:m].contiguous() for t in (pts, d, g)]
        check(bool(torch.equal(fused_mlp.fused_nerf_eval(kp, *sl[:2]), full[:m])),
              f"B1-f32 on {m} points differs from the same rows of a launch of {n}")
        part = fb.fused_nerf_bwd(kp, *sl)
        check(bool(torch.equal(part[1], whole[1][:m]) and torch.equal(part[2], whole[2][:m])),
              f"B2-f32's input gradients on {m} points differ from a launch of {n}")
    log(f"B1-f32 and B2-f32 alone on {', '.join(map(str, RAGGED_SIZES))} points: exactly the "
        f"rows of the {n}-point launch")
    f32_dw_times("the random points", kp, pts, d, g)
    return fwd_errs, bwd_abs


def f32_serve_phase(root, dev, bf16_service, fwd_errs):
    """Phase 21: the committed lego checkpoint served with network.dtype
    float32 through B1-f32 and B3 over HTTP; its frame against the plain
    float32 path (>= 40 dB) and against the bf16 frame (printed); B1-f32 on
    the first render tile's fine pass against its plain version and timed,
    beside its bound, the plain version and a float32 torch.matmul chain."""
    import torch
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import fused_mlp, integrate
    from nerf_tpu_torch.tools import f32_check

    cfg = make_cfg(os.path.join(root, "configs/nerf/lego.yaml"),
                   ["trained_model_dir", os.path.join(root, "checkpoints/nerf/lego/nerf"),
                    "network.dtype", "float32"])
    service, _, launches, request_ms = serve_phase(
        dev, cfg, {"fused_nerf_eval_f32": fused_mlp.fused_nerf_eval_f32,
                   "integrate": integrate.integrate}, n_timed=F32_N_TIMED)
    check(service.params["fine"]["wbuf"].dtype == torch.float32, "the service's weights")
    plain_phase(service)
    rgb32 = service.render(THETA0, PHI, RADIUS)
    rgb16 = bf16_service.render(THETA0, PHI, RADIUS)
    mse = float(torch.mean((rgb32 - rgb16) ** 2))
    log(f"float32 frame against the bf16 frame: PSNR {-10 * math.log10(max(mse, 1e-20)):.2f} dB")
    with _spy(fused_mlp, "fused_nerf_eval") as calls:
        service.render(THETA0, PHI, RADIUS)
    kp, pts, dirs = next(a[:3] for a, _ in calls if a[1].shape[0] == 8192 * 192)
    fwd_errs.append(f32_check.forward_errors(kp, pts, dirs))
    rel, rel64 = max(e[0] for e in fwd_errs), max(e[1] for e in fwd_errs)
    log(f"B1-f32 on the first tile's fine pass, {pts.shape[0]} pts: rel err "
        f"{fwd_errs[-1][0]:.3g}; over every input: {rel:.4g} against the plain version in "
        f"float32 vs float64 {rel64:.4g} (tol {f32_check.FWD_OVER_PLAIN64} x)")
    check(rel <= f32_check.FWD_OVER_PLAIN64 * rel64,
          "B1-f32's largest error exceeds the plain version's own spread")
    n = pts.shape[0]
    out = torch.empty((n, 4), device=dev)
    lib, stream = fused_mlp._lib_f32(), torch.cuda.current_stream().cuda_stream
    args = [t.data_ptr() for t in (pts, dirs, kp["wbuf"], kp["bbuf"], out)]
    ms = time_ms(lambda: lib.launch_fused_nerf_f32(*args, n, stream), reps=5)
    plain_ms = time_ms(lambda: fused_mlp.fused_nerf_eval_plain(kp, pts, dirs), reps=2)
    chain_ms = time_ms(lambda: f32_check.matmul_chain_f32(kp, pts, dirs), reps=2)
    bound = f32_check.fwd_bound_ms(n)
    log(f"B1-f32 first tile fine, {n} pts: {ms:.4f} ms ({2.0 * MACS_PER_POINT * n / ms / 1e9:.1f} "
        f"TFLOP/s, {bound / ms:.3f} of the bound {bound:.4f} ms at 67 TFLOP/s float32), plain "
        f"{plain_ms:.4f} ms; yardstick: a chain of float32 torch.matmul calls (full float32, "
        f"allow_tf32 off) {chain_ms:.4f} ms; float32 request {request_ms:.2f} ms "
        f"(launches {launches})")
    return {"name": "fused_nerf_eval_f32", "route": "cuda",
            "source": "nerf_tpu_torch/csrc/fused_mlp_f32.cu",
            "replaces": "nerf_tpu/ops/fused_mlp.py:129", "max_abs_err": max(
                e[2] for e in fwd_errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations", "library_ms": None}


def f32_train_phase(root, work, data, grid, dev):
    """Phase 22: the epoch-49 lego state resumed with network.dtype float32
    through the trainer's entry point for F32_TRAIN_STEPS steps (B1-f32,
    B2-f32, B3 launched); one step on the model's own renders through the
    kernels against the plain float32 path with the same fine samples and
    the knife-edge points masked (loss within 1e-5 relative, every leaf
    within B2-f32's bound); B2-f32 on that step's coarse and fine inputs
    against its plain version, and timed on the fine batch (``f32_dw_times``)
    beside its bound, the plain version and a float32 torch.matmul chain's
    autograd. Returns (the kernel's entry, the path's launches)."""
    import torch
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import fused_mlp_bwd as fb
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.tools import f32_check
    from nerf_tpu_torch.train.checkpoint import load_checkpoint
    from nerf_tpu_torch.train.state import loss_and_grads, sample_ray_batch

    model_dir = os.path.join(work, "f32_model")
    os.makedirs(model_dir)
    src = os.path.join(root, "checkpoints/nerf/lego/nerf")
    for f in ("latest.npz", "latest.json"):
        shutil.copy(os.path.join(src, f), model_dir)
    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    opts_list = [*F32_TRAIN_OVERRIDES, "trained_model_dir", model_dir,
                 "record_dir", os.path.join(work, "f32_record")]
    state, _, launches, text, secs = _drive_trainer(cfg_file, opts_list, _f32_counters())
    losses = [float(v) for v in re.findall(r"\bloss: (\S+)", text)]
    log(f"float32 train entry point: {secs:.2f} s ({F32_TRAIN_STEPS} steps, checkpoint); "
        f"launches {launches}; losses {losses}")
    check(all(v > 0 for v in launches.values()), "a float32 kernel was not launched by the "
          "train path")
    check(len(losses) == F32_TRAIN_STEPS // 5 and all(math.isfinite(v) for v in losses),
          f"logged losses {losses}")
    cfg = make_cfg(cfg_file, opts_list)
    opts = RenderOptions.from_cfg(cfg)
    state = load_checkpoint(src, state)[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    ro, rd, tgt = sample_ray_batch(gen, *data, int(cfg.task_arg.N_rays))
    rng = gen.get_state()
    with _spy(fb, "fused_nerf_bwd") as calls:
        loss_and_grads(state.params, ro, rd, tgt, opts, grid, gen)
    seen = sorted((a[:4] for a, _ in calls), key=lambda c: c[1].shape[0])
    check(len(seen) == 2, f"{len(seen)} backward calls in one step, expected 2")
    gen.set_state(rng)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    (lk, gk), (lp, gp) = f32_check.step_pair(state.params, ro, rd, tgt, opts, grid, gen, plain)
    torch.cuda.synchronize()
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    worst = max((float((a - b).abs().max()) / (f32_check.BWD_LEAF_REL * float(b.abs().max())
                                               + f32_check.BWD_LEAF_ABS), i)
                for i, (a, b) in enumerate(zip(gk, gp)))
    log(f"float32 train step, kernels vs plain (same fine samples, knife-edge points "
        f"masked): loss {float(lk):.7f} vs {float(lp):.7f} (rel {loss_rel:.3g}, tol 1e-5); "
        f"worst gradient leaf {worst[1]} at {worst[0]:.3g} of its bound")
    check(loss_rel <= 1e-5, "float32 train step loss disagrees")
    check(worst[0] <= 1.0, "float32 train step gradients disagree")
    step_ms = time_ms(lambda: loss_and_grads(state.params, ro, rd, tgt, opts, grid, gen),
                      reps=F32_STEP_REPS)
    log(f"float32 train step's loss and gradients (the step but Adam's update), "
        f"{F32_STEP_REPS} warm calls: {step_ms:.3f} ms each")
    bwd_abs = 0.0
    for label, (kp, pts, dirs, g) in zip(("coarse", "fine"), seen):
        b = f32_check.backward_errors(kp, pts, dirs, g, input_grads=False)
        bwd_abs = max(bwd_abs, b["abs"])
        log(f"B2-f32 on the step's {label} inputs, {pts.shape[0]} pts: worst {b['leaf']} at "
            f"{b['worst']:.3g} of its bound, {b['masked']} knife-edge points zeroed")
        check(b["worst"] <= 1.0, f"B2-f32 disagrees with its plain version on the {label} batch")
    kp, pts, dirs, g = seen[1]
    times = f32_dw_times("the step's fine batch", kp, pts, dirs, g)
    plain_ms = time_ms(lambda: fb.fused_nerf_bwd_plain(kp, pts, dirs, g, input_grads=False),
                       reps=2)
    chain_ms = time_ms(lambda: f32_check.matmul_chain_f32_bwd(kp, pts, dirs, g), reps=2)
    n = pts.shape[0]
    bound = f32_check.bwd_bound_ms(n, tf32_dw=True)
    log(f"B2-f32 on the step's fine batch, {n} pts: {times['all']:.4f} ms "
        f"({bound / times['all']:.3f} of the bound {bound:.4f} ms: dW at 495/3 TFLOP/s, the rest "
        f"at 67 TFLOP/s float32); plain {plain_ms:.4f} ms; yardstick: a float32 torch.matmul "
        f"chain and its autograd (full float32) {chain_ms:.4f} ms")
    return {"name": "fused_nerf_bwd_f32", "route": "cuda",
            "source": "nerf_tpu_torch/csrc/fused_mlp_bwd_f32.cu",
            "replaces": "nerf_tpu/ops/fused_mlp_bwd.py:43", "max_abs_err": bwd_abs,
            "ms": times["all"], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations", "library_ms": None}, launches


def small_nerf_phase(root, work, dev):
    """Phase 23: a frequency NeRF of another shape (D=4, W=64, skips [2],
    6/2 bands; its MLP in plain PyTorch, as JAX's XLA path), with and
    without view directions: SMALL_TRAIN_STEPS steps through the trainer's
    entry point from its initial weights, then its checkpoint served over
    HTTP; the frame through B3 against B3's plain version (>= 40 dB)."""
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import integrate

    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    for vd in (True, False):
        tag = "with" if vd else "without"
        opts = ["train_dataset_module", "synthetic", "train_dataset.n_images", "4",
                "train_dataset.H", "100", "train_dataset.W", "100", *SMALL_NERF,
                "task_arg.use_viewdirs", str(vd), "train.epoch", "1",
                "ep_iter", str(SMALL_TRAIN_STEPS), "grid_rebuild_ep", "1", "log_interval", "50",
                "trained_model_dir", os.path.join(work, f"small_{tag}"),
                "record_dir", os.path.join(work, f"small_{tag}_record")]
        _, _, launches, text, secs = _drive_trainer(cfg_file, opts,
                                                    {"integrate": integrate.integrate})
        losses = [float(v) for v in re.findall(r"\bloss: (\S+)", text)]
        log(f"D=4 W=64 NeRF {tag} view directions: trained {SMALL_TRAIN_STEPS} steps in "
            f"{secs:.2f} s, losses {losses}; launches {launches}")
        check(launches["integrate"] > 0 and losses and all(math.isfinite(v) for v in losses),
              f"the D=4 W=64 NeRF {tag} view directions did not train through B3")
        service, _, slaunches, ms = serve_phase(dev, make_cfg(cfg_file, opts),
                                                {"integrate": integrate.integrate}, n_timed=4)
        log(f"D=4 W=64 NeRF {tag} view directions served: {ms:.2f} ms per request")
        plain_phase(service)


def full_image_phase(root, work, service, dev):
    """Phase 24: train_full_image with the lego model (bf16): one whole-image
    step at FULL_IMAGE x FULL_IMAGE through the trainer's entry point (B1,
    B2, B3 launched; the rays/s line counts H x W rays); then one such step
    from the epoch-49 state on the model's own renders through the kernels
    against the plain path and the plain path with float32 weights, at
    phase 8's bounds; its ms per step and its peak device memory."""
    import torch
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.checkpoint import load_checkpoint
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import train_step_full_image

    model_dir = os.path.join(work, "full_image_model")
    os.makedirs(model_dir)
    src = os.path.join(root, "checkpoints/nerf/lego/nerf")
    for f in ("latest.npz", "latest.json"):
        shutil.copy(os.path.join(src, f), model_dir)
    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    opts_list = ["train_dataset_module", "synthetic", "train_dataset.n_images", "4",
                 "train_dataset.H", str(FULL_IMAGE), "train_dataset.W", str(FULL_IMAGE),
                 "train_full_image", "True", "train.epoch", "51", "ep_iter", "1",
                 "grid_rebuild_ep", "100", "trained_model_dir", model_dir,
                 "record_dir", os.path.join(work, "full_image_record")]
    torch.cuda.reset_peak_memory_stats(dev)
    state, _, launches, text, secs = _drive_trainer(cfg_file, opts_list, _counters())
    entry_peak = torch.cuda.max_memory_allocated(dev)
    rate = re.search(r"epoch 50 done in (\S+)s  \((\S+) train rays/s\)", text)
    check(rate is not None, "no epoch line")
    line_rate = float(rate.group(2).replace(",", ""))
    # the line's seconds are rounded to 0.01: the rates H x W rays a step
    # could give over them, against N_rays' (1024) which it must not count
    secs_line = float(rate.group(1))
    want = FULL_IMAGE * FULL_IMAGE / secs_line
    lo = FULL_IMAGE * FULL_IMAGE / (secs_line + 0.005)
    hi = FULL_IMAGE * FULL_IMAGE / max(secs_line - 0.005, 1e-9)
    log(f"train_full_image entry point, one {FULL_IMAGE}x{FULL_IMAGE} step: {secs:.2f} s in "
        f"all, epoch line {rate.group(1)} s and {rate.group(2)} train rays/s (H x W over its "
        f"seconds: {want:,.0f}); launches {launches}; peak device memory "
        f"{entry_peak / 2**30:.2f} GiB")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched by the "
          "whole-image step")
    check(lo - 1 <= line_rate <= hi + 1, "the rays/s line does not count H x W rays")
    cfg = make_cfg(cfg_file, opts_list)
    opts = RenderOptions.from_cfg(cfg)
    base = load_checkpoint(src, state)[0]
    imgs, poses, K = _model_views(service)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    runs = {}
    for name, o in (("warm-up", opts), ("kernel", opts), ("plain", plain),
                    ("plain32", dataclasses.replace(plain, compute_dtype="float32"))):
        st = _clone_state(base)
        spy = _GradSpy(make_optimizer(cfg))
        gen = torch.Generator(device=dev).manual_seed(4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        stats = train_step_full_image(st, imgs, poses, K, spy, o, FULL_IMAGE, FULL_IMAGE,
                                      tile=o.tile_rays, grid=service.grid, generator=gen)
        torch.cuda.synchronize()
        runs[name] = (stats, spy.grads, time.perf_counter() - t,
                      torch.cuda.max_memory_allocated(dev) - before, before)
    (sk, gk, step_s, peak, before), (sp, gp, *_), (_, g32, *_) = (
        runs[k] for k in ("kernel", "plain", "plain32"))
    loss_rel = abs(float(sk["loss"]) - float(sp["loss"])) / abs(float(sp["loss"]))
    ratios = []
    for i, (a, b, c) in enumerate(zip(gk, gp, g32)):
        e, spread = _rel(a, b)[0], _rel(b, c)[0]
        ratios.append((e / max(BWD_FRO_REL, OVER_BF16_SPREAD * spread), i, e, spread))
    r, i, e, spread = max(ratios)
    log(f"whole-image step, kernels vs plain: loss {float(sk['loss']):.7f} vs "
        f"{float(sp['loss']):.7f} (rel {loss_rel:.3g}, tol {STEP_LOSS_REL}); worst gradient "
        f"leaf {i}: {e:.4g} against bf16's own {spread:.4g} (tol max({BWD_FRO_REL}, "
        f"{OVER_BF16_SPREAD} x))")
    check(math.isfinite(float(sk["loss"])) and loss_rel <= STEP_LOSS_REL,
          "whole-image step loss disagrees")
    check(r <= 1.0, "whole-image step gradients disagree")
    log(f"whole-image step at {FULL_IMAGE}x{FULL_IMAGE}, tiles of {opts.tile_rays} rays: "
        f"{step_s * 1e3:.1f} ms ({FULL_IMAGE * FULL_IMAGE / step_s:,.0f} rays/s, H x W "
        f"counted); the step's peak device memory {peak / 2**30:.2f} GiB above the "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f} GiB card's "
        f"{before / 2**30:.2f} GiB in use before it")
    return {"step_ms": step_s * 1e3, "peak_gib": peak / 2**30}



# phases 25-28: the benchmark, the ESS/ERT harnesses, KiloNeRF
KILO_STEPS = 2000  # distillation steps of 65,536 points: the distill CLI's default, uncut
KILO_CHECK_POINTS = 4096  # points of a serving tile held against the float64 evaluation
# KiloNeRF's float32 outputs against the per-point evaluation in float64: per
# output |k - p64| <= KILO_REL (1 + |p64|). Five float32 layers of at most 63
# + 32 terms lie within ~1e-6 of float64 at these weights; TF32 products
# (10-bit mantissas) are ~1e-3 away, which the check must catch (printed
# beside it).
KILO_REL = 2e-5
ESS_ERT_SIZE = 200  # the ESS/ERT harnesses' frame (phase 15's scene resized)


def _digest(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def bench_phase(root, work):
    """Phase 25: nerf_tpu_torch.bench's main (in-process) in a working
    directory where the JAX package's checkpoint path holds the committed
    lego checkpoint, with B1's, B2's and B3's counts zeroed just before it;
    each kernel launched, every number of its JSON line finite and > 0."""
    from nerf_tpu_torch import bench

    run_dir = os.path.join(work, "bench")
    ckpt = os.path.join(run_dir, "workspace", "trained_model", "nerf", "lego")
    os.makedirs(ckpt)
    os.symlink(os.path.join(root, "checkpoints/nerf/lego/nerf"), os.path.join(ckpt, "nerf"))
    counters = _counters()
    cwd, err = os.getcwd(), io.StringIO()
    os.chdir(run_dir)
    try:
        for c in counters.values():
            c.launches = 0
        with contextlib.redirect_stderr(_Tee(sys.stderr, err)):
            record, _, secs = _run_cli(bench.main, [])
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        os.chdir(cwd)
    check("using trained checkpoint" in err.getvalue(),
          f"bench found no checkpoint: {err.getvalue()}")
    check(all(v > 0 for v in launches.values()), f"bench missed a kernel: launches {launches}")
    nums = [record["value"], record["rep_spread"] + 1.0, record["train_rays_per_s"],
            record["train_rep_spread"] + 1.0, *record["reps"], *record["train_reps"]]
    check(record["metric"] == "lego_800x800_fwd_rays_per_s_per_chip"
          and all(math.isfinite(v) and v > 0 for v in nums), f"bench record {record}")
    log(f"bench ({secs:.1f} s with its kernel loads and ESS rebuild; launches {launches}): "
        f"{json.dumps(record)}")
    return record


def ess_ert_phase(root, work, scene_dir):
    """Phase 26: quick_ess_ert, ess_ert on 3 frames of phase 15's scene at
    ESS_ERT_SIZE, performance_test (four run --type network subprocesses on
    that scene), each in its own working directory; B1 and B3 launched in
    each (counts zeroed just before the in-process harnesses; each run's
    last line gives its frames' launches); B3 against its plain version on
    ess_ert's baseline (ERT off) tiles. The committed ess_ert_results.json
    (the JAX package's) must stay as it is."""
    from nerf_tpu_torch import ess_ert, performance_test, quick_ess_ert
    from nerf_tpu_torch.ops import fused_mlp, integrate as tint

    counters = _counters()

    jax_results = os.path.join(root, "ess_ert_results.json")
    before = _digest(jax_results)
    size = ["test_dataset.H", str(ESS_ERT_SIZE), "test_dataset.W", str(ESS_ERT_SIZE)]
    opts = _scene_opts(root, scene_dir) + size
    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    cwd = os.getcwd()
    out = {}
    try:
        for name in ("quick", "ess_ert", "performance"):
            os.makedirs(os.path.join(work, name))
            os.chdir(os.path.join(work, name))
            if name == "quick":
                quick_counts = {"fused_nerf_eval_f32": fused_mlp.fused_nerf_eval_f32,
                                "integrate": tint.integrate}  # its weights are float32
                for c in quick_counts.values():
                    c.launches = 0
                q, _, secs = _run_cli(quick_ess_ert.main, [])
                launches = {k: c.launches for k, c in quick_counts.items()}
                check(all(math.isfinite(v) for v in q["seconds"].values()), f"quick {q}")
                check(all(v > 0 for v in launches.values()),
                      f"quick_ess_ert missed a kernel: launches {launches}")
                log(f"quick_ess_ert: {secs:.2f} s; launches {launches}; {q}")
            elif name == "ess_ert":
                counters["fused_nerf_eval"].launches = 0
                with _spy(tint, "integrate", lambda a, kw: kw["ert_threshold"] == 0.0,
                          limit=2) as caught:
                    r, _, secs = _run_cli(ess_ert.main, ["--cfg_file", cfg_file, "n_frames", "3",
                                                         *opts])
                    launches = {"fused_nerf_eval": counters["fused_nerf_eval"].launches,
                                "integrate": tint.integrate.launches}  # the spy's count
                check(len(caught) == 2 and all(v > 0 for v in launches.values()),
                      f"ess_ert did not go through B1 and B3: launches {launches}")
                out["b3_err"] = max(integrate_errors(f"ess_ert baseline call {i}", *a[:3], 0.0,
                                                     kw["sigma_activation"])
                                    for i, (a, kw) in enumerate(caught))
                check(sorted(os.listdir(".")) == ["ess_ert_results.json"], "ess_ert's files")
                check(all(math.isfinite(v) and v > 0 for v in r["frame_times"].values()),
                      f"ess_ert {r}")
                out["ess_ert"] = r
                log(f"ess_ert ({secs:.2f} s; launches {launches}): {json.dumps(r)}")
            else:
                p, _, secs = _run_cli(performance_test.main, [
                    "--cfg_file", cfg_file, "--timeout", "300", *opts])
                check(all(v["ok"] for v in p.values()), f"performance_test {p}")
                runs = {k: dict((kv.rsplit(" ", 1)[0], int(kv.rsplit(" ", 1)[1]))
                                for kv in v["tail"].splitlines()[-1].split(": ", 1)[1]
                                .split(", "))
                        for k, v in p.items()}
                check(all(n["fused_nerf_eval"] > 0 and n["integrate"] > 0 for n in runs.values()),
                      f"a performance_test run missed B1 or B3: launches {runs}")
                log(f"performance_test runs' launches (their last lines): {runs}")
                check(sorted(os.listdir(".")) == ["performance_test_results.txt"],
                      "performance_test's files")
                out["performance"] = {k: v["wall_s"] for k, v in p.items()}
                log(f"performance_test ({secs:.1f} s): wall s {out['performance']}")
    finally:
        os.chdir(cwd)
    check(_digest(jax_results) == before, "the committed ess_ert_results.json changed")
    return out


def distill_phase(root, work, dev):
    """Phase 27: python -m nerf_tpu_torch.distill_kilonerf (in-process) from
    the committed teacher, copied to a temp directory, KILO_STEPS steps of
    65,536 points; the loss must fall; B1 (the teacher's queries and its ESS
    grid) and B3 (the comparison render) launched; B1 against its plain
    version on the first teacher batch. Returns (result, model dir, B1's
    errors)."""
    from nerf_tpu_torch import distill_kilonerf
    from nerf_tpu_torch.ops import fused_mlp, integrate as tint
    from nerf_tpu_torch.train.checkpoint import load_params
    from nerf_tpu_torch.ops.fused_mlp import repack_params

    model_dir = os.path.join(work, "kilo_teacher")
    os.makedirs(model_dir)
    for f in ("latest.npz", "latest.json"):
        shutil.copy(os.path.join(root, "checkpoints/nerf/lego/nerf", f), model_dir)
    tint.integrate.launches = 0
    with _spy(fused_mlp, "fused_nerf_eval", lambda a, kw: a[1].shape[0] == 65536,
              limit=1) as caught:
        res, _, secs = _run_cli(distill_kilonerf.main, [
            "--cfg_file", os.path.join(root, "configs/nerf/lego.yaml"),
            "trained_model_dir", model_dir, "kilo.steps", str(KILO_STEPS)])
        b1_launches = fused_mlp.fused_nerf_eval.launches  # the spy's count
    launches = {"fused_nerf_eval": b1_launches, "integrate": tint.integrate.launches}
    (first_step, first), (last_step, last) = res["losses"][0], res["losses"][-1]
    log(f"distill: {KILO_STEPS} steps in {secs:.1f} s (teacher grid, steps, save, render), "
        f"{res['pts_per_s']:,.0f} pts/s; loss {first:.6f} at step {first_step} -> {last:.6f} at "
        f"step {last_step}; student vs teacher {res['psnr']:.2f} dB (no bound; the JAX "
        f"package's distilled model: 9.72 dB); {res['n_centres']} occupied centres; launches "
        f"{launches}")
    check(last < first, "the distillation loss did not fall")
    check(launches["integrate"] > 0 and launches["fused_nerf_eval"] > KILO_STEPS
          and len(caught) == 1, "the distillation did not go through B1 and B3")
    kp = {k: v.to(dev) for k, v in repack_params(
        load_params(os.path.join(root, "checkpoints/nerf/lego/nerf"))["fine"]).items()}
    pts, dirs = caught[0][0][1], caught[0][0][2]
    errs = [fused_errors("distill teacher batch", kp, pts, dirs)]
    return res, model_dir, errs


KILO_N_TIMED = 8  # KiloNeRF requests in the timed serving window
KILO_MACS_PER_POINT = 63 * 32 + 32 * 32 + 32 * 33 + 59 * 32 + 32 * 3  # lego_kilonerf's five layers


def _kilo_profile(fn, dev):
    """(device ms, grouped-product ms, top kernels) of fn() under torch.profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize(dev)

    def us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in prof.key_averages() if us(e) > 0 and e.device_type.name == "CUDA"]
    gemm = sum(us(e) for e in kern if any(k in e.key.lower() for k in ("gemm", "bmm", "cutlass")))
    top = sorted(kern, key=us, reverse=True)[:6]
    return (sum(us(e) for e in kern) / 1e3, gemm / 1e3,
            "; ".join(f"{us(e) / 1e3:.3f} ms x{e.count} {e.key[:60]}" for e in top))


def kilo_phase(root, dev, scene_dir, model_dir):
    """Phase 28: the distilled KiloNeRF (configs/nerf/lego_kilonerf.yaml)
    through run --type network at SCENE x SCENE and served over HTTP at
    SIZE x SIZE (B3 launched, B1 not); its frame through B3 against B3's
    plain version (>= 40 dB); B3 against its plain version on its tiles;
    kilonerf_eval on KILO_CHECK_POINTS points of a serving tile against the
    per-point evaluation in float64 (dropped points exactly 0); the drop
    rate per round on the fine tile; the ESS rebuild's density on one slab
    with no point dropped. Returns (numbers, B3's largest error)."""
    import torch
    from nerf_tpu_torch import run
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import fused_mlp, integrate as tint, kilonerf as tk
    from nerf_tpu_torch.render import renderer
    from nerf_tpu_torch.tools.fused_accuracy import path_inputs

    kfile = os.path.join(root, "configs/nerf/lego_kilonerf.yaml")
    fused_mlp.fused_nerf_eval.launches = tint.integrate.launches = 0
    s, _, secs = _run_cli(run.main, ["--type", "network", "--cfg_file", kfile,
                                       *_scene_opts(root, scene_dir, ["trained_model_dir",
                                                                      model_dir])])
    launches = {"fused_nerf_eval": fused_mlp.fused_nerf_eval.launches,
                "integrate": tint.integrate.launches}
    log(f"KiloNeRF run --type network: {SCENE}x{SCENE} frame {s['mean_time_s'] * 1e3:.1f} ms "
        f"({s['rays_per_s']:.0f} rays/s) over {s['frames']} frames after the first; {secs:.2f} s "
        f"with the ESS rebuild; launches {launches}")
    check(s["frames"] == 4 and launches["integrate"] > 0 and launches["fused_nerf_eval"] == 0,
          "the KiloNeRF frames did not composite through B3 alone")

    service, _, _, request_ms = serve_phase(dev, make_cfg(kfile, ["trained_model_dir", model_dir]),
                                            {"integrate": tint.integrate}, n_timed=KILO_N_TIMED)
    plain_phase(service)
    opts, p = service.opts, service.params["fine"]
    kcfg = renderer.kilo_config_from_opts(opts)
    b3_err, fine, slab = 0.0, None, None
    with torch.no_grad():
        for label, _, pts, dirs, z, d in path_inputs(service, THETA0, PHI, RADIUS):
            if z is None:
                slab = pts
                continue
            raw = tk.kilonerf_eval(p, pts, dirs, kcfg).reshape(*z.shape, 4)
            b3_err = max(b3_err, integrate_errors(f"KiloNeRF {label}", raw, z, d,
                                                  opts.ert_threshold, opts.sigma_activation))
            if fine is None and label.endswith("fine"):
                fine = (pts, dirs)
        fpts, fdirs = fine
        served = tk.served_per_round(fpts, kcfg)
        n = fpts.shape[0]
        log(f"KiloNeRF fine tile, {n} points, capacity {tk.default_capacity(n, kcfg)} a network "
            f"a round: served per round {served} ({', '.join(f'{v / n:.4f}' for v in served)}), "
            f"dropped {n - sum(served)} ({(n - sum(served)) / n:.4f})")

        gen = torch.Generator(device=dev).manual_seed(7)
        sel = torch.randperm(n, generator=gen, device=dev)[:KILO_CHECK_POINTS]
        sp, sd = fpts[sel].contiguous(), fdirs[sel].contiguous()
        got = tk.kilonerf_eval(p, sp, sd, kcfg)
        want = tk.kilonerf_naive(p, sp, sd, kcfg)
        ids = tk.assign_networks(sp, kcfg)
        keep = tk.rank_in_network(ids, tk.n_networks(kcfg)) < (
            kcfg.dispatch_rounds * tk.default_capacity(KILO_CHECK_POINTS, kcfg))
        rel = ((got.double() - want).abs() / (1.0 + want.abs()))[keep]
        err = float(rel.max())

        real = tk.full_float32
        tk.full_float32 = lambda: tk.matmul_precision(True)
        try:
            got_tf32 = tk.kilonerf_eval(p, sp, sd, kcfg)
        finally:
            tk.full_float32 = real
        err_tf32 = float(((got_tf32.double() - want).abs() / (1.0 + want.abs()))[keep].max())
        want32 = tk.kilonerf_naive(p, sp, sd, kcfg, torch.float32)
        err32 = float(((want32.double() - want).abs() / (1.0 + want.abs()))[keep].max())
        n_zero = int((got[~keep] != 0).sum())
        log(f"kilonerf_eval on {KILO_CHECK_POINTS} points of the fine tile against float64: "
            f"{int(keep.sum())} served, max |k - p64| / (1 + |p64|) {err:.3g} (tol {KILO_REL}; "
            f"the per-point evaluation in float32 {err32:.3g}; with TF32 products "
            f"{err_tf32:.3g}); {int((~keep).sum())} dropped, {n_zero} of them not exactly 0")
        check(err <= KILO_REL and n_zero == 0, "kilonerf_eval disagrees with float64")

        eval_ms = time_ms(lambda: tk.kilonerf_eval(p, fpts, fdirs, kcfg), reps=3)
        busy_ms, gemm_ms, top = _kilo_profile(lambda: tk.kilonerf_eval(p, fpts, fdirs, kcfg), dev)
        counts = torch.bincount(tk.assign_networks(fpts, kcfg), minlength=tk.n_networks(kcfg))
        cap, load = tk.default_capacity(n, kcfg), int(counts.max())
        slots = sum(int((counts > r * cap).sum()) * min(cap, load - r * cap)
                    for r in range(kcfg.dispatch_rounds) if load > r * cap)
        bound = 2.0 * KILO_MACS_PER_POINT * sum(served) / PEAK_F32_FLOPS * 1e3
        log(f"kilonerf_eval on the fine tile: {eval_ms:.3f} ms; under the profiler device "
            f"{busy_ms:.3f} ms, of it the grouped products {gemm_ms:.3f} ms; {slots} slots "
            f"evaluated for {sum(served)} served points; the served points' products at "
            f"67 TFLOP/s float32: {bound:.3f} ms; top kernels: {top}")
        frame_busy, frame_gemm, frame_top = _kilo_profile(
            lambda: service.render(THETA0, PHI, RADIUS), dev)
        log(f"a {SIZE}x{SIZE} KiloNeRF request under the profiler: device {frame_busy:.3f} ms, "
            f"the grouped products {frame_gemm:.3f} ms ({frame_gemm / frame_busy:.3f}); "
            f"top kernels: {frame_top}")

        dens = renderer.make_density_fn(service.params["coarse"], opts)(slab)
        sub = torch.randperm(slab.shape[0], generator=gen, device=dev)[:65536]
        naive = torch.relu(tk.kilonerf_naive(service.params["coarse"], slab[sub],
                                             torch.zeros_like(slab[sub]), kcfg)[:, 3])
        d_err = float(((dens[sub].double() - naive).abs() / (1.0 + naive)).max())
        naive32 = torch.relu(tk.kilonerf_naive(service.params["coarse"], slab[sub],
                                               torch.zeros_like(slab[sub]), kcfg,
                                               torch.float32)[:, 3])
        d_err32 = float(((naive32.double() - naive).abs() / (1.0 + naive)).max())
        cap_all = tk.no_drop_capacity(slab, kcfg)
        plane = slab[:(3 * service.grid.resolution) ** 2]
        jax_served = sum(tk.served_per_round(plane, kcfg))
        log(f"ESS rebuild slab of {slab.shape[0]} points: capacity {cap_all} (its fullest "
            f"network), served {tk.served_per_round(slab, kcfg, cap_all)}; 65,536 of them "
            f"against float64: {d_err:.3g} (tol {KILO_REL}; the per-point evaluation in "
            f"float32 {d_err32:.3g}); one lattice plane (the JAX "
            f"package's slab) at its default capacity would drop {plane.shape[0] - jax_served} "
            f"of {plane.shape[0]} ({1 - jax_served / plane.shape[0]:.4f})")
        check(tk.served_per_round(slab, kcfg, cap_all)[0] == slab.shape[0] and d_err <= KILO_REL,
              "the KiloNeRF ESS density drops points or disagrees with float64")
    return {"frame_ms": s["mean_time_s"] * 1e3, "request_ms": request_ms, "eval_ms": eval_ms,
            "occupied": float(service.grid.occupied.float().mean())}, b3_err



# The data- and expert-parallel slice (phases 29-32).
DP_STEPS = 50  # steps an epoch in phase 29 (two epochs)
DP_TIMED = 20  # steps a turn in phase 32's world-1 step timing (eight turns)
DP2_STEPS = 10  # steps an epoch in phase 30 (two epochs: the second is timed)
DP_OVERRIDES = ["train_dataset_module", "synthetic", "train_dataset.n_images", "8",
                "train_dataset.H", "800", "train_dataset.W", "800", "grid_rebuild_ep", "1",
                "save_latest_ep", "1", "eval_ep", "1000", "log_interval", "10",
                "scan_chunk", "10"]
KILO_TRAIN_STEPS = 50
KILO_GRAD_REL = 1e-4  # a KiloNeRF step's gradient leaves, B3 against its plain version
LEGO_PARAM_LEAVES = 48


def _copy_lego_state(root, model_dir):
    os.makedirs(model_dir)
    for f in ("latest.npz", "latest.json"):
        shutil.copy(os.path.join(root, "checkpoints/nerf/lego/nerf", f), model_dir)


def _launch_counts(text):
    """The trainer's last line, "kernel launches: name n, ..." -> {name: n}."""
    line = [l for l in text.splitlines() if l.startswith("kernel launches: ")][-1]
    return {k: int(v) for k, v in (kv.rsplit(" ", 1) for kv in
                                  line[len("kernel launches: "):].split(", "))}


def _step_ms(text, epoch, steps):
    """ms a step from the trainer's epoch line (it prints 10 ms steps)."""
    m = re.search(rf"epoch {epoch} done in (\S+)s", text)
    check(m is not None, f"no epoch {epoch} line")
    return float(m.group(1)) * 1e3 / steps


def _param_gap(a_dir, b_dir, base_dir):
    """The 48 lego param leaves of two checkpoints: (exactly equal, the
    largest ||a - b|| / ||b - base|| over the leaves: the distance against
    the update from ``base``'s state)."""
    import numpy as np

    def leaves(d):
        with np.load(os.path.join(d, "latest.npz")) as data:
            return [np.asarray(data[f"leaf_{i}"], np.float64) for i in range(LEGO_PARAM_LEAVES)]

    a, b, base = leaves(a_dir), leaves(b_dir), leaves(base_dir)
    exact = all(np.array_equal(x, y) for x, y in zip(a, b))
    rel = max(float(np.linalg.norm(x - y) / max(np.linalg.norm(y - z), 1e-30))
              for x, y, z in zip(a, b, base))
    return exact, rel


def _losses(text):
    return [float(v) for v in re.findall(r"\bloss: (\S+)", text)]


def dp_nccl_phase(root, work, service):
    """Phase 29: the epoch-49 lego state (bf16, 1024 rays, 64 + 128
    samples, ESS) trained for 2 epochs of DP_STEPS steps by python -m
    nerf_tpu_torch.train in a subprocess with distributed True and
    torchrun's environment for world 1 (NCCL), and in-process without
    distributed; the parameters equal, or within BWD_FRO_REL of the update
    in relative norm; B1, B2 and B3 launched. Returns the launches and what
    phase 32 times the step on, under its world-1 group: phase 10's setting
    (the committed state, the served grid, the model's own views)."""
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.parallel import mesh
    from nerf_tpu_torch.train.checkpoint import load_checkpoint

    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    base = [*DP_OVERRIDES, "ep_iter", str(DP_STEPS), "train.epoch", "52"]
    dirs = {k: os.path.join(work, f"dp_{k}") for k in ("plain", "nccl")}
    for d in dirs.values():
        _copy_lego_state(root, d)
    state, _, launches, text, _ = _drive_trainer(
        cfg_file, [*base, "trained_model_dir", dirs["plain"], "record_dir",
                   os.path.join(work, "dp_plain_rec")], _counters())
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(mesh.free_port()),
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nerf_tpu_torch.train", "--cfg_file", cfg_file,
                           *base, "trained_model_dir", dirs["nccl"], "record_dir",
                           os.path.join(work, "dp_nccl_rec"), "distributed", "True"],
                          env=env, capture_output=True, text=True, timeout=600)
    nccl_s = time.perf_counter() - t
    check(proc.returncode == 0, f"the NCCL rank failed: {proc.stderr[-3000:]}")
    check("data-parallel: 1 ranks, nccl on cuda" in proc.stdout, "the rank did not run over NCCL")
    nccl = _launch_counts(proc.stdout)
    steps = 2 * DP_STEPS
    check(all(nccl[k] > 0 for k in launches), f"the NCCL run's launches {nccl}")
    check(nccl["fused_nerf_bwd"] == launches["fused_nerf_bwd"] == 2 * steps,
          "B2 is not launched twice a step")
    check(_losses(proc.stdout) == _losses(text) or all(
        abs(a - b) <= STEP_LOSS_REL * abs(b) for a, b in zip(_losses(proc.stdout), _losses(text))),
        "the NCCL run's logged losses differ")
    exact, rel = _param_gap(dirs["nccl"], dirs["plain"],
                            os.path.join(root, "checkpoints/nerf/lego/nerf"))
    log(f"lego at world 1 over NCCL (a subprocess, {nccl_s:.2f} s with its start): "
        f"launches over {steps} steps and 2 ESS rebuilds {nccl} (in-process without "
        f"distributed {launches}); params after {steps} steps "
        + ("equal bit for bit" if exact else f"{rel:.3g} of the update apart (tol {BWD_FRO_REL})"))
    check(exact or rel <= BWD_FRO_REL, "world 1 over NCCL leaves the trajectory without it")
    lego = load_checkpoint(os.path.join(root, "checkpoints/nerf/lego/nerf"), state)[0]
    return {"launches": nccl, "steps": steps, "cfg": make_cfg(cfg_file, base), "state": lego,
            "grid": service.grid, "data": _model_views(service)}


def dp_step_times(group, dp, dev):
    """Phase 32's timing of phase 29's step: make_sharded_train_step over
    the world-1 NCCL ``group`` and without a group, on one clone of the
    state, in turns (NCCL, none, none, NCCL, twice) of DP_TIMED steps, each
    step timed by the host clock up to a synchronize; then all_reduce_mean
    alone on the step's gradient leaves and its two losses, the same way.
    Returns the medians (ms) and each mode's quartiles."""
    import numpy as np
    import torch
    from nerf_tpu_torch.parallel.mesh import all_reduce_mean
    from nerf_tpu_torch.parallel.train_step import make_sharded_train_step
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.tree import tree_leaves

    def clocked(fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    cfg = dp["cfg"]
    opts, tx, n_rays = RenderOptions.from_cfg(cfg), make_optimizer(cfg), int(cfg.task_arg.N_rays)
    st = _clone_state(dp["state"])
    gen = torch.Generator(device=dev).manual_seed(3)
    steps = {"nccl": make_sharded_train_step(group, tx, opts, n_rays),
             "none": make_sharded_train_step(None, tx, opts, n_rays)}
    run = {k: (lambda f=f: f(st, *dp["data"], gen, dp["grid"])) for k, f in steps.items()}
    for k in steps:
        for _ in range(3):
            run[k]()
    torch.cuda.synchronize()
    times = {k: [] for k in steps}
    for k in ("nccl", "none", "none", "nccl") * 2:
        times[k] += [clocked(run[k]) for _ in range(DP_TIMED)]
    q = {k: np.percentile(v, [25, 50, 75]) for k, v in times.items()}
    leaves = [torch.zeros_like(t) for t in tree_leaves(st.params)]
    leaves += [torch.zeros((), device=dev), torch.zeros((), device=dev)]
    exchange = float(np.median([clocked(lambda: all_reduce_mean(leaves))
                                for _ in range(DP_TIMED)]))
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(st.params)),
          "the timed steps' params are not finite")
    log(f"lego step at world 1 ({n_rays} rays), {4 * DP_TIMED} steps of each in turns of "
        f"{DP_TIMED}, each to a synchronize (quartiles, ms): over NCCL {q['nccl'].round(4)}, "
        f"without a group {q['none'].round(4)}; medians {q['nccl'][1] - q['none'][1]:.4f} ms "
        f"apart; all_reduce_mean alone on the {len(leaves) - 2} gradient leaves "
        f"({sum(t.numel() for t in leaves):,} values) and 2 losses, median {exchange:.4f} ms")
    return {"nccl_ms": float(q["nccl"][1]), "plain_ms": float(q["none"][1]),
            "exchange_ms": exchange,
            "iqr_ms": {k: float(v[2] - v[0]) for k, v in q.items()}}


def dp_gloo_phase(root, work):
    """Phase 30: two ranks on the one card over gloo: the epoch-49 lego
    state trained 2 epochs of DP2_STEPS steps at world 2 (each rank 512
    rays of the 1024) against the same steps in-process at world 1, the
    second epochs timed: every logged loss
    within STEP_LOSS_REL, the params within BWD_FRO_REL of the update in
    relative norm, B1, B2 and B3 launched. If gloo refuses CUDA tensors
    (its own message in a rank's output; any other failure fails the phase)
    the phase says so and ends: the 2-rank case stays a CPU test. Returns
    its numbers or None."""
    from nerf_tpu_torch.parallel import mesh

    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    base = [*DP_OVERRIDES, "ep_iter", str(DP2_STEPS), "train.epoch", "52"]
    dirs = {k: os.path.join(work, f"dp2_{k}") for k in ("one", "two")}
    for d in dirs.values():
        _copy_lego_state(root, d)
    _, _, _, text1, _ = _drive_trainer(cfg_file, [*base, "trained_model_dir", dirs["one"],
                                                  "record_dir", os.path.join(work, "dp2_rec1")],
                                       _counters())
    logs = os.path.join(work, "dp2_logs")
    os.makedirs(logs)
    t = time.perf_counter()
    try:
        mesh.launch("nerf_tpu_torch.train", ["--cfg_file", cfg_file, *base, "trained_model_dir",
                                             dirs["two"], "record_dir",
                                             os.path.join(work, "dp2_rec2"), "distributed",
                                             "True", "dist_backend", "gloo"], 2, "cuda",
                    log_dir=logs, timeout=600)
    except RuntimeError as e:
        text = "".join(open(os.path.join(logs, f"rank{r}.log")).read() for r in (0, 1))
        refused = re.search(r"(?i)(cuda|device)[^\n]*(not supported|unsupported|not implemented)"
                            r"|(not supported|unsupported|not implemented)[^\n]*(cuda|device)",
                            text)
        check(refused is not None and "nccl" not in text.lower(),
              f"the gloo ranks failed ({e}): {text[-3000:]}")
        log(f"gloo refuses CUDA tensors here: {refused.group(0)}; the 2-rank case stays a CPU "
            f"test (tests/test_torch_parallel.py)")
        return None
    secs = time.perf_counter() - t
    text2 = open(os.path.join(logs, "rank0.log")).read()
    check("data-parallel: 2 ranks, gloo on cuda" in text2, "the ranks did not run over gloo")
    check("epoch" not in open(os.path.join(logs, "rank1.log")).read(), "rank 1 printed the log")
    l1, l2 = _losses(text1), _losses(text2)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
    exact, rel = _param_gap(dirs["two"], dirs["one"],
                            os.path.join(root, "checkpoints/nerf/lego/nerf"))
    two = _launch_counts(text2)
    ms2 = _step_ms(text2, 51, DP2_STEPS)
    log(f"gloo takes CUDA tensors: lego at world 2, both ranks on one card ({secs:.2f} s with "
        f"their start): {ms2:.3f} ms a step (the second epoch of {DP2_STEPS}) against "
        f"{_step_ms(text1, 51, DP2_STEPS):.3f} at world 1 in-process; rank 0's launches "
        f"{two}; logged losses {l2} against {l1} (max rel {loss_rel:.3g}, tol "
        f"{STEP_LOSS_REL}); params "
        + ("equal bit for bit" if exact else f"{rel:.3g} of the update apart (tol {BWD_FRO_REL})"))
    check(len(l1) == len(l2) == 2 * DP2_STEPS // 10 and loss_rel <= STEP_LOSS_REL,
          "world 2's losses leave world 1's")
    check(exact or rel <= BWD_FRO_REL, "world 2's params leave world 1's")
    check(all(two[k] > 0 for k in ("fused_nerf_eval", "fused_nerf_bwd", "integrate")),
          "a kernel was not launched at world 2")
    return {"ms": ms2, "launches": two}


def kilo_train_phase(root, work, scene_dir, dev):
    """Phase 31: KiloNeRF (configs/nerf/lego_kilonerf.yaml: 16^3 networks of
    hidden width 32, 4 dispatch rounds, 1024 rays) trained from
    init_nerf_params on phase 15's Blender scene through the trainer's entry
    point, one epoch of KILO_TRAIN_STEPS steps: the loss falls, B3 launched
    and B1 not; one step's loss and gradients on the kernel path against the
    plain path (the same batch and fine samples): loss within STEP_LOSS_REL,
    every leaf within KILO_GRAD_REL of its largest |value|; the fine batch
    of that step for phase 32. Returns (numbers, the trained fine model, its
    config, the fine batch's points and directions)."""
    import torch
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.data import make_dataset
    from nerf_tpu_torch.ops import fused_mlp, integrate as tint, kilonerf as tk
    from nerf_tpu_torch.render import renderer
    from nerf_tpu_torch.tools.f32_check import replayed_fine_samples
    from nerf_tpu_torch.train.state import loss_and_grads, sample_ray_batch

    kfile = os.path.join(root, "configs/nerf/lego_kilonerf.yaml")
    over = [*_scene_opts(root, scene_dir), "trained_model_dir", os.path.join(work, "kilo_train"),
            "record_dir", os.path.join(work, "kilo_train_rec"), "ep_iter",
            str(KILO_TRAIN_STEPS), "train.epoch", "1", "log_interval", "10", "scan_chunk", "10"]
    counters = {"fused_nerf_eval": fused_mlp.fused_nerf_eval, "integrate": tint.integrate}
    state, grid, launches, text, secs = _drive_trainer(kfile, over, counters)
    losses = _losses(text)
    rate = re.search(r"epoch 0 done in (\S+)s  \((\S+) train rays/s\)", text)
    check(rate is not None, "no epoch line")
    step_ms = float(rate.group(1)) * 1e3 / KILO_TRAIN_STEPS
    log(f"KiloNeRF trained from images: {secs:.2f} s (load, {KILO_TRAIN_STEPS} steps, "
        f"checkpoint), {step_ms:.2f} ms a step, {rate.group(2)} train rays/s (first steps "
        f"included); losses {losses}; launches {launches}")
    check(len(losses) == KILO_TRAIN_STEPS // 10 and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0], "the KiloNeRF loss did not fall")
    check(launches["integrate"] == 2 * KILO_TRAIN_STEPS and launches["fused_nerf_eval"] == 0,
          "KiloNeRF training did not composite through B3 alone")

    cfg = make_cfg(kfile, over)
    opts = renderer.RenderOptions.from_cfg(cfg)
    ds = make_dataset(cfg, "train")
    images = torch.from_numpy((ds.images * 255).round().astype("uint8")).to(dev)
    poses = torch.as_tensor(ds.poses, dtype=torch.float32, device=dev)
    K = torch.as_tensor(ds.K, dtype=torch.float32, device=dev)
    n_rays = int(cfg.task_arg.N_rays)
    gen = torch.Generator(device=dev).manual_seed(3)
    ro, rd, tgt = sample_ray_batch(gen, images, poses, K, n_rays)
    rng, record, out = gen.get_state(), [], []
    n_fine = n_rays * (opts.n_samples + opts.n_importance)
    with _spy(tk, "kilonerf_eval", lambda a, kw: a[1].shape[0] == n_fine, limit=1) as fine:
        for o in (opts, dataclasses.replace(opts, use_integrate_kernel=False)):
            gen.set_state(rng)
            tint.integrate.launches = 0
            with replayed_fine_samples(record):
                out.append(loss_and_grads(state.params, ro, rd, tgt, o, grid, gen))
            out[-1] += (tint.integrate.launches,)
    torch.cuda.synchronize()
    (lk, _, gk, nk), (lp, _, gp, npl) = out
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    worst = max((float((a - b).abs().max()) / (KILO_GRAD_REL * float(b.abs().max())), i)
                for i, (a, b) in enumerate(zip(gk, gp)))
    log(f"KiloNeRF step, B3 against its plain version (the same batch and fine samples): loss "
        f"{float(lk):.7f} vs {float(lp):.7f} (rel {loss_rel:.3g}, tol {STEP_LOSS_REL}); worst "
        f"of {len(gk)} gradient leaves {worst[1]} at {worst[0]:.3g} of its bound "
        f"({KILO_GRAD_REL} of its largest |value|); B3 launches {nk} and {npl}")
    check(nk == 2 and npl == 0, "the kernel path did not composite through B3")
    check(loss_rel <= STEP_LOSS_REL and worst[0] <= 1.0, "the KiloNeRF step's gradients disagree")
    fpts, fdirs = fine[0][0][1].detach(), fine[0][0][2].detach()
    fine_model = {k: {n: t.detach() for n, t in v.items()}
                  for k, v in state.params["fine"].items()}
    return ({"step_ms": step_ms, "rays_per_s": float(rate.group(2).replace(",", "")),
             "losses": losses}, fine_model, renderer.kilo_config_from_opts(opts), fpts, fdirs)


def ep_phase(dev, smi, params, kcfg, pts, dirs, dp):
    """Phase 32: kilonerf_eval_ep at world 1 over NCCL (this process as the
    rank) on phase 31's fine batch with the trained fine model, against the
    dense kilonerf_eval at capacities that serve every point: equal bit for
    bit; both timed. Under the same group, phase 29's lego step timed with
    and without it (``dp_step_times``). Then python -m nerf_tpu_torch.bench_scaling's main
    (in-process; its rank is a process) at world 1 in a temp directory as
    its working directory: its record, the only file it writes. Returns the
    numbers."""
    import torch
    from nerf_tpu_torch.ops import kilonerf as tk
    from nerf_tpu_torch.parallel import mesh
    from nerf_tpu_torch.parallel.kilonerf_ep import kilonerf_eval_ep, shard_kilonerf_params

    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(mesh.free_port()))
    try:
        check(mesh.init_distributed(device=dev), "a process group was already up")
        group = mesh.data_group(dev, owned=True)
        import torch.distributed as dist

        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        n = pts.shape[0]
        cap = tk.no_drop_capacity(pts, kcfg)
        with torch.no_grad():
            local = shard_kilonerf_params(params, group)
            got = kilonerf_eval_ep(local, pts, dirs, kcfg, group, send_capacity=n,
                                   expert_capacity=cap)
            want = tk.kilonerf_eval(params, pts, dirs, kcfg, capacity=cap)
            ep_ms = time_ms(lambda: kilonerf_eval_ep(local, pts, dirs, kcfg, group, n, cap), 5)
            dense_ms = time_ms(lambda: tk.kilonerf_eval(params, pts, dirs, kcfg, capacity=cap), 5)
        diff = float((got - want).abs().max())
        log(f"kilonerf_eval_ep at world 1 over NCCL on the KiloNeRF step's fine batch ({n} "
            f"points, send capacity {n}, expert capacity {cap}, every point served): "
            f"max|ep - dense| {diff:.3g} ({'equal bit for bit' if torch.equal(got, want) else 'NOT equal'}); "
            f"{ep_ms:.3f} ms against the dense kilonerf_eval's {dense_ms:.3f} ms")
        check(torch.equal(got, want), "EP at world 1 differs from the dense evaluation")
        step_times = dp_step_times(group, dp, dev)
        mesh.destroy(group)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    from nerf_tpu_torch import bench_scaling

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # bench_scaling writes its record into the working directory
        try:
            rec, _, secs = _run_cli(bench_scaling.main, [])
        finally:
            os.chdir(cwd)
        check(os.listdir(tmp) == ["scaling_results_torch.json"],
              f"bench_scaling wrote {os.listdir(tmp)}")
        with open(os.path.join(tmp, "scaling_results_torch.json")) as f:
            check(json.load(f) == rec, "bench_scaling's file is not its record")
    log(f"bench_scaling at world 1 ({secs:.1f} s): {json.dumps(rec)}")
    check(rec["backend"] == "nccl" and list(rec["results"]) == ["1"] and rec["device"] == smi
          and rec["results"]["1"] > 0, "bench_scaling's record")
    return {"ep_ms": ep_ms, "dense_ms": dense_ms, "points": n, "scaling": rec["results"]["1"],
            **step_times}


# The breadth slice (phases 33-35): every encoder type of the factory at JAX's
# defaults on a lego step's fine batch, the img_fit task through the CLIs,
# the light-stage loader.
ENC_POINTS = 196_608  # a lego step's fine batch
ENC_CFGS = {"frequency": {"input_dim": 3, "freq": 10}, "sphere_harmonics": {}, "hashgrid": {},
            "triplane": {}, "cuda_hashgrid_4d": {}, "cuda_hashgrid_latent": {},
            "cuda_hashgrid_coef": {}, "cuda_motion2d": {}, "dnerf": {}, "dnerf_ngp_mlp": {},
            "dnerf_ngp_tensorf": {}, "cuda_dnerf_ngp_tensorf": {}, "dnerf_mlp_tensorf": {}}
ENC_NO_KERNEL = ("frequency", "sphere_harmonics", "triplane", "dnerf", "dnerf_mlp_tensorf")
# the 3-D grids whose points do not require grad: calls of the hash encoder's kernels
ENC_FUSED = {"hashgrid": 1, "cuda_hashgrid_latent": 1, "cuda_hashgrid_coef": 6}
ENC_TIMED = {"cuda_hashgrid_4d": "corner, 2 bf16 (4 B) rows, D = 4",
             "hashgrid": "corner, 2 bf16 (4 B) rows, D = 3"}
# a float32 leaf's gradient through the kernels against the plain path: the
# same products, but the latent codes' rows are added by index_put's atomics
ENC_LEAF_REL = 1e-5
IMG_FIT_EPOCHS, IMG_FIT_TIMED = 3, 50
IMG_FIT_STEP_REL = 1e-5  # the card's step against the CPU's: float32 sums in other orders
RIG, RIG_CAMS, RIG_FRAMES, RIG_RAYS = 1024, 4, 2, 1024


def _encoder_inputs(etype, dev, gen):
    """The fine batch for a type: xyz uniform in the bbox; t uniform over
    frames 0-59 (xyzt types) or over [0, 1] (D-NeRF types); unit directions
    for SH. The inputs require grad for the types without parameters."""
    import torch
    from nerf_tpu_torch.models import encoders

    n = ENC_POINTS
    xyz = torch.rand((n, 3), generator=gen, device=dev) * 4.0 - 2.0
    if etype == "sphere_harmonics":
        d = torch.randn((n, 3), generator=gen, device=dev)
        return (d / d.norm(dim=-1, keepdim=True),)
    if etype in encoders.DYNAMIC_HASH_TYPES:
        return (torch.cat([xyz, torch.rand((n, 1), generator=gen, device=dev) * 59.0], -1),)
    if etype in encoders.DNERF_TYPES:
        return xyz, torch.rand((n, 1), generator=gen, device=dev)
    return (xyz,)


def encoder_phase(dev):
    """Phase 33: every factory type at JAX's defaults, forward and backward
    of sum(out^2) on the fine batch through the kernels and through the
    plain path on the same tree: outputs equal (where 3-D grids take the hash
    encoder's kernels, ENC_FUSED, within twice their interp_tolerance: the
    same products summed in another order; and each hash_interp_bwd's rows
    equal to hash_interp_bwd_plain's on its cotangent and points, which the
    table's gradient check below takes as given), each table's gradient per
    element within scatter_add_tolerance of the plain scatter-add of the
    same cotangent rows, each float32 leaf within ENC_LEAF_REL of its
    largest |value|; B4 and B4' launched once a table under every hash-based
    type, never under the others; ms of each. Then B4 and B4' alone on the
    rows of two types (ENC_TIMED). Returns ({label: (gather, scatter)},
    {"gather": launches, "scatter": launches, "gather_err", "scatter_err"})."""
    import torch
    from nerf_tpu_torch.models import encoders
    from nerf_tpu_torch.ops import hash_encode, hash_gather
    from nerf_tpu_torch.tree import tree_leaves

    gen = torch.Generator(device=dev).manual_seed(7)
    table_of, seen, gathered, fused = {}, [], [], []
    real_gather, real_scatter = hash_gather.gather_rows, hash_gather.scatter_add_rows
    real_interp, real_interp_bwd = hash_encode.hash_interp, hash_encode.hash_interp_bwd
    bwd_calls = []

    def gather_spy(table, idx):
        table_of[idx.data_ptr()] = table.data_ptr()
        gathered.append((table, idx))
        return real_gather(table, idx)

    def scatter_spy(idx, cot, n_rows):
        seen.append((idx, cot, n_rows))
        return real_scatter(idx, cot, n_rows)

    def interp_spy(rows, pts, lv):
        fused.append((rows, pts, lv))
        return real_interp(rows, pts, lv)

    def interp_bwd_spy(g, pts, lv, dtype):
        cot = real_interp_bwd(g, pts, lv, dtype)
        bwd_calls.append((g, pts, lv, dtype, cot))
        return cot

    # the wrappers count on their module-level names, which are the spies meanwhile
    gather_spy.launches = scatter_spy.launches = interp_spy.launches = 0
    interp_bwd_spy.launches = 0
    hash_gather.gather_rows, hash_gather.scatter_add_rows = gather_spy, scatter_spy
    hash_encode.hash_interp, hash_encode.hash_interp_bwd = interp_spy, interp_bwd_spy
    counters = (gather_spy, scatter_spy)
    totals = {"gather": 0, "scatter": 0, "gather_err": 0.0, "scatter_err": 0.0}
    timed = {}
    try:
        for etype, extra in ENC_CFGS.items():
            built = encoders.get_encoder({"type": etype, **extra},
                                         torch.Generator().manual_seed(0), device=dev)
            params, fn, dim = built if len(built) == 3 else (None, *built)
            args = _encoder_inputs(etype, dev, gen)
            leaves = tree_leaves(params) if params is not None else []
            wrt = leaves if leaves else [args[0]]
            for t in wrt:
                t.requires_grad_(True)

            def run(plain):
                for t in wrt:
                    t.grad = None
                seen.clear()
                gathered.clear()
                fused.clear()
                bwd_calls.clear()
                before = [c.launches for c in counters]
                out = fn(params, *args, plain=plain) if params is not None else fn(*args)
                (out * out).sum().backward()
                torch.cuda.synchronize()
                return (out.detach(), [t.grad.clone() for t in wrt],
                        [c.launches - b for c, b in zip(counters, before)])

            run(False)  # warm-up
            times = {}
            for mode in (False, True, True, False):
                t0 = time.perf_counter()
                out, grads, counts = run(mode)
                times.setdefault(mode, []).append((time.perf_counter() - t0) * 1e3)
                if mode:
                    out_p, grads_p, counts_p = out, grads, counts
                else:
                    out_k, grads_k, counts_k, seen_k, gathered_k, fused_k = (
                        out, grads, counts, list(seen), list(gathered), list(fused))
                    bwd_k = list(bwd_calls)
            n_tables = sum(1 for t in leaves if t.dtype == torch.bfloat16)
            check(out_k.shape == (ENC_POINTS, dim) and bool(torch.isfinite(out_k).all()),
                  f"{etype}: output {tuple(out_k.shape)}, dim {dim}")
            check(len(fused_k) == len(bwd_k) == ENC_FUSED.get(etype, 0),
                  f"{etype}: {len(fused_k)} forward and {len(bwd_k)} backward calls of the hash "
                  "encoder's kernels")
            for g, pts, lv, dtype, cot in bwd_k:
                check(torch.equal(cot, hash_encode.hash_interp_bwd_plain(g, pts, lv, dtype)),
                      f"{etype}: hash_interp_bwd's rows differ from hash_interp_bwd_plain's")
            if fused_k:  # the 3-D grids' 8 products summed in another order
                tol = max(float(hash_encode.interp_tolerance(*c).max()) for c in fused_k)
                check(float((out_k - out_p).abs().max()) <= 2 * tol,
                      f"{etype}: the kernels' output beyond twice interp_tolerance of plain")
            else:
                check(torch.equal(out_k, out_p), f"{etype}: the kernels' output differs from "
                                                 "the plain path's")
            if etype in ENC_NO_KERNEL:
                check(counts_k == [0, 0] and n_tables == 0, f"{etype}: launches {counts_k}")
            else:
                check(n_tables > 0 and counts_k == [n_tables, n_tables] and counts_p == [0, 0],
                      f"{etype}: B4/B4' launches {counts_k} through the kernels, {counts_p} "
                      f"plain, for {n_tables} tables")
            totals["gather"] += counts_k[0]
            totals["scatter"] += counts_k[1]
            ptrs = [t.data_ptr() for t in wrt]
            worst = 0.0
            for idx, cot, n_rows in seen_k:
                i = ptrs.index(table_of[idx.data_ptr()])
                want = hash_gather.scatter_add_rows_plain(idx, cot, n_rows)
                tol = hash_gather.scatter_add_tolerance(idx, cot, want)
                err = (grads_k[i].reshape(want.shape).double() - want.double()).abs()
                worst = max(worst, float((err / tol.clamp_min(1e-30)).max()))
                totals["scatter_err"] = max(totals["scatter_err"], float(err.max()))
                check(bool((err <= tol).all()), f"{etype}: table leaf {i}'s gradient outside "
                                                "scatter_add_tolerance")
            leaf_rel = 0.0
            for a, b, t in zip(grads_k, grads_p, wrt):
                if t.dtype != torch.bfloat16:
                    rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    leaf_rel = max(leaf_rel, rel)
                    check(rel <= ENC_LEAF_REL, f"{etype}: a float32 leaf {rel:.3g} from plain")
            rows = sum(idx.shape[0] for _, idx in gathered_k)
            log(f"encoder {etype} (dim {dim}, {len(leaves)} leaves, {n_tables} bf16 tables, "
                f"{rows} gathered rows): fwd+bwd {min(times[False]):.3f} ms through the kernels, "
                f"{min(times[True]):.3f} ms plain; output "
                f"{'within the sum-order bound' if fused_k else 'equal'}; tables' worst err / "
                f"tolerance {worst:.3g}; float32 leaves {leaf_rel:.3g} of their largest; "
                f"B4/B4' launches {counts_k}")
            if etype in ENC_TIMED:
                table, idx = gathered_k[0]
                sidx, cot, n_rows = seen_k[0]
                timed[etype] = (gather_times(f"{etype} ({ENC_TIMED[etype]})", table.detach(), idx),
                                scatter_times(f"{etype} ({ENC_TIMED[etype]})", sidx, cot, n_rows),
                                idx.shape[0])
            del built, params, args, leaves, wrt, out, grads, out_k, out_p, grads_k, grads_p
            seen_k.clear()
            gathered_k.clear()
            fused_k.clear()
            bwd_k.clear()
            torch.cuda.empty_cache()
    finally:
        hash_gather.gather_rows, hash_gather.scatter_add_rows = real_gather, real_scatter
        hash_encode.hash_interp, hash_encode.hash_interp_bwd = real_interp, real_interp_bwd
    return timed, totals


def img_fit_phase(root, work, scene_dir, dev):
    """Phase 34: configs/img_fit/lego_view0.yaml on view 0 of phase 15's
    scene (input_ratio 0.5: 400x400, 8192 pixels a step): train
    IMG_FIT_EPOCHS epochs through ``python -m nerf_tpu_torch.train``'s main,
    evaluate through ``run --type evaluate``; the loss finite and falling,
    metrics.json and gt_pred.png written, the checkpoint loaded back, no
    kernel launched; one step on the card against the same step on the CPU
    (TF32 allowed in the process); IMG_FIT_TIMED warm steps timed."""
    import numpy as np
    import torch
    from nerf_tpu_torch import run
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.data.img_fit import make_img_fit_dataset
    from nerf_tpu_torch.models.img_fit import apply_img_fit_mlp
    from nerf_tpu_torch.train import __main__ as train_main
    from nerf_tpu_torch.train import checkpoint, img_fit_loop
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.tree import tree_leaves, tree_map
    from nerf_tpu_torch.utils.png import read_png

    cfg_file = os.path.join(root, "configs/img_fit/lego_view0.yaml")
    opts = ["train_dataset.data_root", scene_dir, "test_dataset.data_root", scene_dir,
            "train.epoch", str(IMG_FIT_EPOCHS), "workspace", os.path.join(work, "img_fit")]
    cfg = make_cfg(cfg_file, opts)
    before = train_main.launches()
    _, text, train_s = _run_cli(train_main.main, ["--cfg_file", cfg_file] + opts)
    losses = [float(m) for m in re.findall(r"loss: (\S+)", text)]
    check(len(losses) == IMG_FIT_EPOCHS and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], f"img_fit losses {losses}")
    psnr, _, eval_s = _run_cli(run.main, ["--type", "evaluate", "--cfg_file", cfg_file] + opts)
    with open(os.path.join(cfg.result_dir, "metrics.json")) as f:
        check(json.load(f)["psnr"] == psnr, "metrics.json's PSNR")
    ds = make_img_fit_dataset(cfg)
    png = read_png(os.path.join(cfg.result_dir, "gt_pred.png"))
    check(png.shape == (ds.H, 2 * ds.W, 3), f"gt_pred.png {png.shape}")
    launched = {k: v - before[k] for k, v in train_main.launches().items() if v != before[k]}
    check(not launched, f"img_fit launched kernels: {launched}")
    ckpt = checkpoint.load_checkpoint(cfg.trained_model_dir, img_fit_loop.template_state(cfg, dev))
    check(ckpt is not None and ckpt[1] == IMG_FIT_EPOCHS - 1
          and ckpt[0].step == IMG_FIT_EPOCHS * int(cfg.ep_iter), "the img_fit checkpoint")
    state = ckpt[0]

    # one step's loss and gradients on the card and on the CPU, same pixels
    idx = torch.randint(0, ds.uv.shape[0], (ds.n_pixels,), generator=torch.Generator()
                        .manual_seed(1))
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        steps = []
        for d in (dev, torch.device("cpu")):
            p = tree_map(lambda t: t.detach().to(d).requires_grad_(True), state.params)
            loss = torch.mean((apply_img_fit_mlp(p, torch.from_numpy(ds.uv[idx.numpy()]).to(d))
                               - torch.from_numpy(ds.rgb[idx.numpy()]).to(d)) ** 2)
            grads = torch.autograd.grad(loss, tree_leaves(p))
            steps.append((float(loss.detach()), [g.cpu() for g in grads]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    loss_rel = abs(steps[0][0] - steps[1][0]) / steps[1][0]
    grad_rel = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(steps[0][1], steps[1][1]))
    check(loss_rel <= IMG_FIT_STEP_REL and grad_rel <= IMG_FIT_STEP_REL,
          f"img_fit step on the card vs the CPU: loss {loss_rel:.3g}, gradients {grad_rel:.3g}")

    uv, rgb = torch.from_numpy(ds.uv).to(dev), torch.from_numpy(ds.rgb).to(dev)
    tx, gen = make_optimizer(cfg), torch.Generator(device=dev).manual_seed(2)
    for _ in range(5):
        img_fit_loop.img_fit_step(state, uv, rgb, tx, 10, ds.n_pixels, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IMG_FIT_TIMED):
        img_fit_loop.img_fit_step(state, uv, rgb, tx, 10, ds.n_pixels, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / IMG_FIT_TIMED
    log(f"img_fit ({ds.H}x{ds.W}, {ds.n_pixels} pixels a step): {IMG_FIT_EPOCHS} epochs of "
        f"{cfg.ep_iter} steps in {train_s:.2f} s, losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"evaluate PSNR {psnr:.4f} dB in {eval_s:.2f} s; {step_ms:.3f} ms a warm step "
        f"({IMG_FIT_TIMED} steps to a synchronize); no kernel launched; one step on the card "
        f"vs the CPU (TF32 allowed): loss {loss_rel:.3g}, gradients {grad_rel:.3g} of their "
        f"largest")
    return {"psnr": psnr, "step_ms": step_ms, "losses": losses}


def light_stage_phase(work):
    """Phase 35: a rig of RIG_CAMS cameras x RIG_FRAMES frames at RIG x RIG
    with distortion (light_stage.write_synthetic_rig) through the
    light-stage loader at ratios 1.0 and 0.5: every train batch of RIG_RAYS
    rays and a test image; rays finite and of unit direction, an rgb row a
    ray; the host ms of a first read (decode, undistort, resize) and of a
    batch."""
    import importlib.util

    import numpy as np
    from nerf_tpu_torch.data import light_stage

    root = os.path.join(work, "rig")
    t0 = time.perf_counter()
    light_stage.write_synthetic_rig(root, n_cams=RIG_CAMS, n_frames=RIG_FRAMES, H=RIG, W=RIG,
                                    seed=11)
    write_s = time.perf_counter() - t0
    out = {}
    for ratio in (1.0, 0.5):
        ds = light_stage.LightStageDataset(root, split="train", n_rays=RIG_RAYS,
                                           input_ratio=ratio)
        first, again = [], []
        for pass_times in (first, again):
            for i in range(len(ds)):
                t0 = time.perf_counter()
                b = ds[i]
                pass_times.append((time.perf_counter() - t0) * 1e3)
                rays = b["rays"]
                check(0.75 * RIG_RAYS < rays.shape[0] <= RIG_RAYS
                      and b["rgb"].shape == (rays.shape[0], 3) and bool(np.isfinite(rays).all())
                      and bool(np.abs(np.linalg.norm(rays[:, 3:6], axis=-1) - 1).max() < 1e-5),
                      f"light stage batch {i} at ratio {ratio}")
        t0 = time.perf_counter()
        test = light_stage.LightStageDataset(root, split="test", input_ratio=ratio)[0]
        test_ms = (time.perf_counter() - t0) * 1e3
        side = int(round(RIG * ratio))
        check(test["rays"].shape == (side * side, 7) and test["rgb"].shape == (side * side, 3)
              and bool(np.isfinite(test["rays"]).all())
              and bool(np.abs(np.linalg.norm(test["rays"][:, 3:6], axis=-1) - 1).max() < 1e-5),
              f"light stage test image at ratio {ratio}")
        out[ratio] = {"read_ms": float(np.median(first)), "batch_ms": float(np.median(again)),
                      "test_ms": test_ms}
        log(f"light stage at ratio {ratio}: {len(ds)} items of {RIG}x{RIG}; a first read "
            f"(PNG decode, undistortion, resize) and batch {np.median(first):.1f} ms (median; "
            f"{min(first):.1f}-{max(first):.1f}), a batch of {RIG_RAYS} rays from the cache "
            f"{np.median(again):.2f} ms; a test image ({side}x{side} rays) {test_ms:.1f} ms")
    have = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "imageio", "PIL")}
    log(f"rig written in {write_s:.2f} s; on this machine "
        + ", ".join(f"{m} {'present' if v else 'absent'}" for m, v in have.items()))
    if have["cv2"]:  # where cv2 is installed, hold the port's undistortion to it
        import cv2
        from nerf_tpu_torch.utils import remap
        from nerf_tpu_torch.utils.png import read_png

        ds = light_stage.LightStageDataset(root, split="test")
        K, D = np.asarray(ds.cams["K"][0], np.float64), np.asarray(ds.cams["D"][0], np.float64)
        img = read_png(ds.items[0]["img_path"]).astype(np.float32) / 255.0
        msk = (read_png(ds._mask_path(ds.items[0]["img_path"])) != 0).astype(np.uint8)
        same = [bool((remap.undistort(a, K, D) == cv2.undistort(a, K, D)).all()) for a in (img, msk)]
        check(all(same), f"remap.undistort differs from cv2 {cv2.__version__}: {same}")
        log(f"remap.undistort equal to cv2 {cv2.__version__}'s on a {RIG}x{RIG} image and mask")
    return out


# The thirteenth slice (phases 36-42): the shipped configs other than lego
# (lego_400_coarse, the corner-layout hash grid, the 7 other scenes), the
# native image loader, mesh extraction, reference checkpoints, COLMAP.
COARSE_STEPS, COARSE_N_TIMED = 20, 8  # lego_400_coarse: steps from a fresh init; requests
CORNER_STEPS = 50  # lego_hashgrid (corner layout): steps from a fresh init
CORNER_ROWS = 25_165_824  # its fine batch: 1024 rays x 192 samples x 16 levels x 8 corners
OTHER_SCENES = ("chair", "drums", "ficus", "hotdog", "materials", "mic", "ship")
SCENE_STEPS = 3  # steps a scene yaml, on a 2-frame 800x800 scene
MESH_RES, MESH_CHECK_RES, MESH_LEVEL = 256, 64, 5.0
COLMAP_STEPS = 5


def _fresh_train(cfg_file, work, tag, steps, counters, extra=()):
    """Train ``cfg_file`` from a fresh init through the trainer's entry point
    for ``steps`` steps of one epoch (then an ESS rebuild and the
    checkpoint); the counters are zeroed before and read after. Returns
    (cfg, state, grid, launches, log, seconds)."""
    from nerf_tpu_torch.config import make_cfg

    opts = ["train.epoch", "1", "ep_iter", str(steps), "grid_rebuild_ep", "1",
            "save_latest_ep", "1", "trained_model_dir", os.path.join(work, f"{tag}_model"),
            "record_dir", os.path.join(work, f"{tag}_record"), *extra]
    state, grid, launches, text, secs = _drive_trainer(cfg_file, opts, counters)
    losses = [float(v) for v in re.findall(r"\bloss: (\S+)", text)]
    check(losses and all(math.isfinite(v) for v in losses), f"{tag}: logged losses {losses}")
    check(state.step == steps, f"{tag}: {state.step} steps, expected {steps}")
    check(os.path.exists(os.path.join(work, f"{tag}_model", "latest.npz")),
          f"{tag}: no checkpoint written")
    return make_cfg(cfg_file, opts), state, grid, launches, text, secs


def _request_launches(service, counters):
    """The counters' launches in one render of the warm-up pose."""
    import torch

    for c in counters.values():
        c.launches = 0
    service.render(THETA0, PHI, RADIUS)
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}


def coarse400_phase(root, work, dev):
    """Phase 36: configs/nerf/lego_400_coarse.yaml (N_importance 0) trained
    COARSE_STEPS steps from a fresh init on 100 synthetic 400x400 images
    (the config's input_ratio 0.5 of 800), then served at SIZE x SIZE. No
    fine pass: one B1, one B2 and one B3 launch a step, one B1 and one B3 a
    render tile, and the fine MLP's Adam moments still all zero."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp, integrate
    from nerf_tpu_torch.tree import tree_leaves

    cfg_file = os.path.join(root, "configs/nerf/lego_400_coarse.yaml")
    cfg, state, _, launches, text, secs = _fresh_train(
        cfg_file, work, "coarse400", COARSE_STEPS, _counters(),
        ["train_dataset_module", "synthetic", "train_dataset.n_images", "100",
         "train_dataset.H", "400", "train_dataset.W", "400"])
    log(f"lego_400_coarse: {COARSE_STEPS} steps from a fresh init in {secs:.2f} s (data, init, "
        f"steps, ESS rebuild, checkpoint); launches {launches}")
    check(int(cfg.task_arg.N_importance) == 0, "lego_400_coarse has a fine pass")
    check(launches["fused_nerf_bwd"] == COARSE_STEPS and launches["integrate"] == COARSE_STEPS
          and launches["fused_nerf_eval"] > COARSE_STEPS,
          f"lego_400_coarse: launches {launches}, expected one B2 and one B3 a step "
          f"(a fine pass would double them)")
    n_coarse = len(tree_leaves(state.params["coarse"]))
    fine_moments = state.opt_state.mu[n_coarse:] + state.opt_state.nu[n_coarse:]
    check(all(not bool(m.any()) for m in fine_moments),
          "lego_400_coarse: a gradient reached the fine MLP")
    rate = re.search(r"done in (\S+)s  \((\S+) train rays/s\)", text)
    counters = {"fused_nerf_eval": fused_mlp.fused_nerf_eval, "integrate": integrate.integrate}
    service, _, serve_launches, request_ms = serve_phase(dev, cfg, counters, COARSE_N_TIMED)
    per_request = _request_launches(service, counters)
    tiles = -(-SIZE * SIZE // service.opts.tile_rays)
    check(per_request == {"fused_nerf_eval": tiles, "integrate": tiles},
          f"lego_400_coarse request launches {per_request}, expected {tiles} each (no fine pass)")
    log(f"lego_400_coarse: the fine MLP's {len(fine_moments)} Adam moments all zero; epoch "
        f"{float(rate.group(1)) * 1e3 / COARSE_STEPS:.2f} ms a step (first steps included), "
        f"{rate.group(2)} train rays/s; {request_ms:.2f} ms a {SIZE}x{SIZE} request, "
        f"launches a request {per_request} ({tiles} tiles, coarse only)")
    del service
    torch.cuda.empty_cache()
    return {"request_ms": request_ms, "launches": launches}


def corner_phase(root, work, dev, cellpack):
    """Phase 37: configs/nerf/lego_hashgrid.yaml (the corner layout: 2 bf16,
    4-byte rows, 8 corners a level) trained CORNER_STEPS steps from a fresh
    init on the synthetic scene, served at SIZE x SIZE; one step's gathers
    and scatter-adds against their plain versions and the whole step
    against the plain path (phase 13's gate); B4 and B4' on the step's fine
    batch (CORNER_ROWS rows) beside their bounds and library calls; a window
    of warm steps. ``cellpack``: phase 12/14's step and request ms."""
    import numpy as np
    import torch
    from nerf_tpu_torch.ops import hash_gather
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import loss_and_grads, sample_ray_batch, train_step

    cfg_file = os.path.join(root, "configs/nerf/lego_hashgrid.yaml")
    extra = HASH_TRAIN_OVERRIDES[:HASH_TRAIN_OVERRIDES.index("train.epoch")]
    cfg, state, _, launches, _, secs = _fresh_train(cfg_file, work, "corner", CORNER_STEPS,
                                                    _hash_counters(), extra)
    opts = RenderOptions.from_cfg(cfg)
    check(opts.hash_layout == "corner", f"lego_hashgrid's layout is {opts.hash_layout}")
    log(f"lego_hashgrid (corner): {CORNER_STEPS} steps from a fresh init in {secs:.2f} s; "
        f"launches {launches}")
    check(launches["hash_scatter_add_rows"] == 2 * CORNER_STEPS
          and launches["hash_gather_rows"] > 2 * CORNER_STEPS
          and launches["integrate"] == 2 * CORNER_STEPS,
          f"corner train launches {launches}: expected 2 B4' and 2 B3 a step, and B4 more")
    counters = {k: c for k, c in _hash_counters().items() if k != "hash_scatter_add_rows"}
    service, _, _, request_ms = serve_phase(dev, cfg, counters, HASH_N_TIMED)
    per_request = _request_launches(service, _hash_counters())
    log(f"lego_hashgrid (corner): launches a request {per_request}")
    check(per_request["hash_scatter_add_rows"] == 0 and per_request["hash_gather_rows"] > 0
          and per_request["integrate"] > 0,
          f"corner request launches {per_request}: expected B4 and B3, and no B4'")

    imgs, poses, K = _model_views(service)
    data = (torch.randint(0, 256, imgs.shape, dtype=torch.uint8, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(7)), poses, K)
    plain = dataclasses.replace(opts, use_fused_mlp=False, use_integrate_kernel=False)
    gen = torch.Generator(device=dev).manual_seed(2)
    ro, rd, tgt = sample_ray_batch(gen, *data, int(cfg.task_arg.N_rays))
    rng = gen.get_state()
    for c in _hash_counters().values():
        c.launches = 0
    with _spy(hash_gather, "gather_rows") as seen_g, \
            _spy(hash_gather, "scatter_add_rows") as seen_s:
        lk, _, gk = loss_and_grads(state.params, ro, rd, tgt, opts, service.grid, gen)
        torch.cuda.synchronize()
        per_step = {k: c.launches for k, c in _hash_counters().items()}  # the spies' counts
    check(per_step == {"hash_gather_rows": 2, "hash_scatter_add_rows": 2, "integrate": 2},
          f"corner step launches {per_step}: expected 2 B4, 2 B4' and 2 B3 (coarse, fine)")
    step = _hash_plain_steps(state.params, ro, rd, tgt, plain, service.grid, gen, rng)
    torch.cuda.synchronize()
    seen_g, seen_s = [a for a, _ in seen_g], [a for a, _ in seen_s]
    check(len(seen_g) == 2 and len(seen_s) == 2,
          f"{len(seen_g)} gathers and {len(seen_s)} scatter-adds in a corner step, expected 2")
    fine_g = max(seen_g, key=lambda c: c[1].shape[0])
    fine_s = max(seen_s, key=lambda c: c[0].shape[0])
    check(fine_s[0].shape[0] == CORNER_ROWS and fine_g[0].shape[1] == 2,
          f"corner fine batch: {fine_s[0].shape[0]} rows of {fine_g[0].shape[1]}")
    gather_err = max(gather_errors(f"corner step {lbl}", *c) for lbl, c in
                     zip(("coarse", "fine"), sorted(seen_g, key=lambda c: c[1].shape[0])))
    scatter_err = max(scatter_errors(f"corner step {lbl}", *c) for lbl, c in
                      zip(("coarse", "fine"), sorted(seen_s, key=lambda c: c[0].shape[0])))
    hash_step_gate("corner", lk, gk, step, small_leaves=True)
    gather = gather_times("corner NeRF fine batch", *fine_g)
    scatter = scatter_times("corner NeRF fine batch", *fine_s)

    tx = make_optimizer(cfg)
    n_rays = int(cfg.task_arg.N_rays)
    for _ in range(3):
        train_step(state, *data, tx, opts, n_rays, service.grid, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(HASH_STEP_WINDOW):
        t = time.perf_counter()
        train_step(state, *data, tx, opts, n_rays, service.grid, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    w = np.array(times) * 1e3
    step_ms = float(w.mean())
    log(f"lego_hashgrid (corner) on the card: {step_ms:.3f} ms a step (mean of "
        f"{HASH_STEP_WINDOW} warm steps; median {np.median(w):.3f}), {request_ms:.2f} ms a "
        f"{SIZE}x{SIZE} request; the cellpack model (phases 12, 14): {cellpack['step_ms']:.3f} "
        f"ms a step, {cellpack['request_ms']:.2f} ms a request; B4 {gather['ms']:.4f} ms "
        f"({gather['bound_ms'] / gather['ms']:.3f} of its {gather['bound_ms']:.4f} ms bound, "
        f"index_select {gather['library_ms']:.4f}), "
        f"B4' {scatter['ms']:.4f} ms "
        f"({scatter['bound_ms'] / scatter['ms']:.3f} of its {scatter['bound_ms']:.4f} ms bound, "
        f"index_add_ {scatter['library_ms']:.4f}) on {CORNER_ROWS} rows of 4 B")
    del service
    torch.cuda.empty_cache()
    shape = "lego_hashgrid fine batch: corner, 2 bf16 (4 B) rows, D = 3"
    return {"gather": {"shape": shape, "rows": CORNER_ROWS, **gather,
                       "launches_step": per_step["hash_gather_rows"],
                       "launches_request": per_request["hash_gather_rows"]},
            "scatter": {"shape": shape, "rows": CORNER_ROWS, **scatter,
                        "launches_step": per_step["hash_scatter_add_rows"],
                        "launches_request": per_request["hash_scatter_add_rows"]},
            "gather_err": gather_err, "scatter_err": scatter_err, "step_ms": step_ms,
            "request_ms": request_ms}


def scenes_phase(root, work):
    """Phase 38: each of the 7 other nerf_synthetic scene yamls trains
    SCENE_STEPS steps from a fresh init at full width, through the trainer's
    entry point, on a 2-frame 800x800 scene written under its own name."""
    import numpy as np
    from nerf_tpu_torch.data.blender import write_blender_scene
    from nerf_tpu_torch.serve import look_at_pose

    data_root = os.path.join(work, "scenes")
    out = {}
    for i, scene in enumerate(OTHER_SCENES):
        rng = np.random.default_rng(i)
        imgs = rng.integers(0, 256, (2, SCENE, SCENE, 4), dtype=np.uint8)
        imgs[..., 3] = np.where(rng.uniform(size=(2, SCENE, SCENE)) < 0.5, 255, 0)
        poses = np.stack([look_at_pose(0.4 + 2.1 * k, SCENE_PHI, RADIUS) for k in range(2)])
        write_blender_scene(os.path.join(data_root, scene), {"train": (imgs, poses)},
                            CAMERA_ANGLE_X)
        cfg_file = os.path.join(root, f"configs/nerf/{scene}.yaml")
        cfg, _, _, launches, text, secs = _fresh_train(
            cfg_file, work, scene, SCENE_STEPS, _counters(),
            ["train_dataset.data_root", data_root, "train_dataset.H", str(SCENE),
             "train_dataset.W", str(SCENE)])
        check(cfg.scene == scene and f"train data: 2 images {SCENE}x{SCENE}" in text,
              f"{scene}: the trainer did not read the scene's own data")
        check(launches["fused_nerf_bwd"] == 2 * SCENE_STEPS
              and launches["integrate"] == 2 * SCENE_STEPS
              and launches["fused_nerf_eval"] >= 2 * SCENE_STEPS,
              f"{scene}: launches {launches}")
        out[scene] = secs
        log(f"configs/nerf/{scene}.yaml: {SCENE_STEPS} steps on its own 2-frame "
            f"{SCENE}x{SCENE} scene in {secs:.2f} s (load, init, steps, ESS rebuild, "
            f"checkpoint); launches {launches}")
    return out


def loader_phase(work, scene_dir):
    """Phase 39: the native image loader on the machine that runs this: built from
    nerf_tpu_torch/native/loader.cpp with g++, or, where it cannot be
    (headers missing), the fact recorded and the PNG path run: phase 15's
    test split through the Blender loader either way, and a JPEG (written by
    cv2 where it is installed) decoded, or refused with its name."""
    import importlib.util
    import shutil as sh

    import numpy as np
    from nerf_tpu_torch import native
    from nerf_tpu_torch.data.blender import BlenderDataset

    reason = native.unavailable_reason()
    log(f"native loader: g++ {sh.which('g++') or 'absent'}; "
        + ("built and loaded from nerf_tpu_torch/native/loader.cpp" if reason is None
           else f"not built ({reason}): frames go through utils/png.py"))
    t = time.perf_counter()
    ds = BlenderDataset(data_root=scene_dir, split="test", H=SCENE, W=SCENE)
    load_s = time.perf_counter() - t
    if reason is not None:
        check(native._state.warned, "the PNG fallback gave no warning")
    log(f"BlenderDataset test split ({len(ds)} frames {SCENE}x{SCENE}) through the "
        f"{'native loader' if reason is None else 'PNG path'}: {load_s:.3f} s, "
        f"{len(ds) / load_s:.2f} frames/s")
    out = {"native": reason is None, "reason": reason, "frames_per_s": len(ds) / load_s}
    if importlib.util.find_spec("cv2") is None:
        return out
    import cv2

    img = (ds.images[0] * 255).round().astype(np.uint8)
    jpg = os.path.join(work, "frame.jpg")
    check(cv2.imwrite(jpg, img[..., ::-1]), "cv2 did not write a JPEG")
    if reason is None:
        got, want = native.decode(jpg), cv2.imread(jpg)[..., ::-1]
        diff = int(np.abs(got.astype(int) - want).max())
        log(f"a {SCENE}x{SCENE} JPEG: the native decode within {diff} of 255 of cv2's")
        check(diff <= 1, "the native JPEG decode differs from cv2's")
    else:
        try:
            native.read_image(jpg)
        except ValueError as e:
            check("frame.jpg" in str(e), f"the refusal does not name the file: {e}")
            log(f"a JPEG without the native loader raises: {e}")
        else:
            check(False, "a JPEG was read without the native loader")
    return out


def mesh_phase(root, work, dev):
    """Phase 40: python -m nerf_tpu_torch.extract_mesh on the committed lego
    model at MESH_RES (MESH_RES^3 lattice points through B1 in chunks of
    extract_mesh.CHUNK, the counter zeroed before and read after); the
    lattice alone timed; at MESH_CHECK_RES the kernel's field and mesh
    against the plain path's (phase 5's percentile gates on the densities;
    face counts within 0.1%, every vertex within one cell of the other
    mesh's)."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree
    from nerf_tpu_torch import extract_mesh as em
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.render.renderer import make_density_fn
    from nerf_tpu_torch.run import load_eval_model
    from nerf_tpu_torch.utils.mesh import extract_mesh

    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    out_path = os.path.join(work, "lego_mesh.ply")
    argv = ["--cfg_file", cfg_file, "trained_model_dir",
            os.path.join(root, "checkpoints/nerf/lego/nerf"), "mesh.resolution", str(MESH_RES),
            "mesh.level", str(MESH_LEVEL), "mesh.out", out_path]
    fused_mlp.fused_nerf_eval.launches = 0
    (verts, faces), text, secs = _run_cli(em.main, argv)
    b1 = fused_mlp.fused_nerf_eval.launches
    want = -(-MESH_RES ** 3 // em.CHUNK)
    check(b1 == want, f"extract_mesh: {b1} B1 launches, expected {want}")
    check(len(verts) > 10_000 and len(faces) > 10_000 and os.path.getsize(out_path) > 0,
          f"extract_mesh: {len(verts)} vertices, {len(faces)} faces")

    cfg = make_cfg(cfg_file, argv[2:])
    cfg["enable_ess"] = False
    opts, params, _ = load_eval_model(cfg, dev)
    axes = [torch.linspace(-2.0, 2.0, MESH_RES, device=dev)] * 3
    lattice = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3).contiguous()
    density = make_density_fn(params["fine"], opts)
    lattice_ms = time_ms(lambda: [density(c) for c in lattice.split(em.CHUNK)], reps=3)
    pts = MESH_RES ** 3
    log(f"extract_mesh at {MESH_RES}^3 = {pts} points: {len(verts)} vertices, {len(faces)} "
        f"faces in {secs:.2f} s (load, lattice, marching tetrahedra on the host, PLY); B1 "
        f"launches {b1}; the lattice's densities alone {lattice_ms:.2f} ms "
        f"({pts / lattice_ms / 1e3:.0f} M points/s)")

    plain = dataclasses.replace(opts, use_fused_mlp=False)
    fields = {}
    for name, o in (("kernel", opts), ("plain", plain)):
        fn = make_density_fn(params["fine"], o)

        def query(p, fn=fn):
            with torch.no_grad():
                return fn(torch.from_numpy(p).to(dev)).float().cpu().numpy()

        fields[name] = (query, extract_mesh(query, MESH_LEVEL, em.BBOX, MESH_CHECK_RES))
    axes = [np.linspace(-2.0, 2.0, MESH_CHECK_RES)] * 3
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    k, p = fields["kernel"][0](grid), fields["plain"][0](grid)
    err = np.abs(k - p) / (1.0 + np.abs(p))
    (kv, kf), (pv, pf) = fields["kernel"][1], fields["plain"][1]
    cell = 4.0 / (MESH_CHECK_RES - 1)
    near = (max(cKDTree(pv).query(kv)[0].max(), cKDTree(kv).query(pv)[0].max())
            if len(kv) and len(pv) else float("inf"))
    log(f"mesh at {MESH_CHECK_RES}^3, kernel vs plain: densities p99 {np.quantile(err, 0.99):.3g}"
        f", p99.9 {np.quantile(err, 0.999):.3g}, max {err.max():.3g} of 1 + |plain|; vertices "
        f"{len(kv)} vs {len(pv)}, faces {len(kf)} vs {len(pf)}; farthest vertex from the other "
        f"mesh {near:.4g} (a cell is {cell:.4g})")
    check(np.quantile(err, 0.99) <= FUSED_P99_REL and np.quantile(err, 0.999) <= FUSED_P999_REL,
          "the mesh lattice's densities: kernel and plain disagree")
    check(abs(len(kf) - len(pf)) <= 0.001 * len(pf) and abs(len(kv) - len(pv)) <= 0.001 * len(pv)
          and near <= cell, "the kernel's mesh differs from the plain path's")
    return {"seconds": secs, "verts": len(verts), "faces": len(faces), "b1": b1,
            "lattice_ms": lattice_ms}


def ported_phase(root, work, dev, first_png):
    """Phase 41: the committed lego weights written out as a reference-style
    .pth (model. / model_fine. state_dict, weights [out, in]), ported by
    python -m nerf_tpu_torch.port_torch_checkpoint, and served: the frame at
    the warm-up pose must equal phase 4's (the committed model's) bit for
    bit, through B1 and B3."""
    import torch
    from nerf_tpu_torch import port_torch_checkpoint
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import fused_mlp, integrate
    from nerf_tpu_torch.train.checkpoint import load_params
    from nerf_tpu_torch.utils.torch_port import reference_state_dict

    pth = os.path.join(work, "lego_reference.pth")
    torch.save({"net": reference_state_dict(load_params(
        os.path.join(root, "checkpoints/nerf/lego/nerf"))), "epoch": 49}, pth)
    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    model_dir = os.path.join(work, "ported")
    epoch, _, secs = _run_cli(port_torch_checkpoint.main,
                              ["--cfg_file", cfg_file, pth, "trained_model_dir", model_dir])
    check(epoch == 49, f"ported epoch {epoch}")
    cfg = make_cfg(cfg_file, ["trained_model_dir", model_dir])
    counters = {"fused_nerf_eval": fused_mlp.fused_nerf_eval, "integrate": integrate.integrate}
    service, frame, launches, request_ms = serve_phase(dev, cfg, counters, n_timed=1)
    same = bool((frame == first_png).all())
    log(f"reference checkpoint: written, ported in {secs:.2f} s, served ({request_ms:.2f} ms a "
        f"request, launches {launches}); the frame at the warm-up pose "
        f"{'equals' if same else 'DIFFERS FROM'} the committed model's bit for bit")
    check(same, "the ported checkpoint's frame differs from the committed model's")
    del service
    torch.cuda.empty_cache()
    return {"request_ms": request_ms}


def colmap_phase(root, work, scene_dir):
    """Phase 42: a COLMAP model (PINHOLE camera, binary cameras, images and
    points) of phase 15's train views, written with utils/colmap.py, through
    python -m nerf_tpu_torch.colmap2nerf: its poses must be the views' own
    up to its recentring and scaling (1e-6); the port's Blender loader reads
    the result and the trainer takes COLMAP_STEPS steps on it from a fresh
    init (B1, B2, B3)."""
    import numpy as np
    from nerf_tpu_torch import colmap2nerf
    from nerf_tpu_torch.utils import colmap

    with open(os.path.join(scene_dir, "lego", "transforms_train.json")) as f:
        meta = json.load(f)
    root_c = os.path.join(work, "colmap")
    scene = os.path.join(root_c, "lego")
    os.makedirs(os.path.join(scene, "images"))
    os.makedirs(os.path.join(root_c, "sparse"))
    focal = 0.5 * SCENE / math.tan(0.5 * meta["camera_angle_x"])
    cams = {1: colmap.Camera(1, "PINHOLE", SCENE, SCENE,
                             np.array([focal, focal, SCENE / 2, SCENE / 2]))}
    imgs, c2ws = {}, []
    for i, fr in enumerate(meta["frames"]):
        name = os.path.basename(fr["file_path"]) + ".png"
        shutil.copy(os.path.join(scene_dir, "lego", fr["file_path"] + ".png"),
                    os.path.join(scene, "images", name))
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        c2ws.append(c2w)
        cv = c2w.copy()
        cv[:3, 1:3] *= -1  # NeRF's camera axes -> COLMAP's (+Y down, +Z forward)
        R = cv[:3, :3].T
        imgs[i + 1] = colmap.Image(i + 1, colmap.rotmat2qvec(R), -R @ cv[:3, 3], 1, name)
    pts = {1: colmap.Point3D(1, np.zeros(3), np.array([128, 128, 128], np.uint8), 0.5,
                             np.array([1, 2]), np.array([0, 0]))}
    sparse = os.path.join(root_c, "sparse")
    colmap.write_cameras_bin(os.path.join(sparse, "cameras.bin"), cams)
    colmap.write_images_bin(os.path.join(sparse, "images.bin"), imgs)
    colmap.write_points3d_bin(os.path.join(sparse, "points3D.bin"), pts)
    out, _, _ = _run_cli(colmap2nerf.main, ["--model_dir", sparse, "--images", "images",
                                             "--out", os.path.join(scene, "transforms_train.json")])
    centers = np.stack([m[:3, 3] for m in c2ws])
    center = centers.mean(0)
    scale = 4.0 / np.linalg.norm(centers - center, axis=1).mean()
    by_name = {os.path.basename(fr["file_path"]): c2w for fr, c2w in zip(meta["frames"], c2ws)}
    worst = 0.0
    for fr in out["frames"]:
        want = by_name[os.path.basename(fr["file_path"])].copy()
        want[:3, 3] = (want[:3, 3] - center) * scale
        worst = max(worst, float(np.abs(np.asarray(fr["transform_matrix"]) - want).max()))
    check(len(out["frames"]) == len(c2ws) and worst <= 1e-6
          and abs(out["camera_angle_x"] - meta["camera_angle_x"]) <= 1e-9,
          f"colmap2nerf: {len(out['frames'])} frames, pose error {worst}")
    cfg_file = os.path.join(root, "configs/nerf/lego.yaml")
    _, state, _, launches, text, secs = _fresh_train(
        cfg_file, work, "colmap", COLMAP_STEPS, _counters(),
        ["train_dataset.data_root", root_c, "train_dataset.H", str(SCENE),
         "train_dataset.W", str(SCENE)])
    check(f"train data: {len(c2ws)} images {SCENE}x{SCENE}" in text,
          "the trainer did not read the COLMAP scene")
    check(all(v > 0 for v in launches.values()), f"COLMAP scene launches {launches}")
    log(f"COLMAP model of {len(c2ws)} lego views -> colmap2nerf (poses within {worst:.3g} of "
        f"the views' own, recentred and scaled by {scale:.4f}) -> the Blender loader -> "
        f"{COLMAP_STEPS} steps from a fresh init in {secs:.2f} s; launches {launches}")
    return {"seconds": secs}


HELPER_HEAT = (4, 80, 128, 128)  # phase 43's heatmap: batch, classes, height, width
HELPER_TOPK = 40
NEAR_FAR_ATOL = 1e-6


def _host_ms(fn, reps: int = 3) -> float:
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def helpers_phase(dev, smi, service):
    """Phase 43: the tensor helpers on the card against the CPU, the
    profiler's trace of a lego request, and memory_stats."""
    import glob

    import numpy as np
    import torch
    from nerf_tpu_torch.render.rays import image_rays
    from nerf_tpu_torch.serve import look_at_pose
    from nerf_tpu_torch.utils import data_utils, profiling, ray_utils

    t0 = time.perf_counter()
    pose = torch.as_tensor(look_at_pose(THETA0, PHI, RADIUS), device=dev)
    rays_o, rays_d = image_rays(SCENE, SCENE, scene_K(SCENE, dev), pose)
    grid = service.grid  # the lego scene's AABB, [-2, 2]^3, and its central half
    nf_err, hits = 0.0, []
    for scale in (1.0, 0.5):
        box = (grid.bbox_min * scale, grid.bbox_max * scale)
        got = ray_utils.get_near_far(rays_o, rays_d, *box)
        cpu_args = (rays_o.cpu(), rays_d.cpu(), box[0].cpu(), box[1].cpu())
        want = ray_utils.get_near_far(*cpu_args)
        check(got[0].device.type == "cuda" and torch.equal(got[2].cpu(), want[2]),
              "get_near_far: the card's hits differ from the CPU's")
        nf_err = max([nf_err] + [float((g.cpu() - w).abs().max())
                                 for g, w in zip(got[:2], want[:2])])
        hits.append(int(got[2].sum()))
    check(nf_err <= NEAR_FAR_ATOL, f"get_near_far: near/far {nf_err} from the CPU's")
    check(0 < hits[1] < rays_o.shape[0], f"the central half's hits {hits[1]}: no misses")
    nf_ms = time_ms(lambda: ray_utils.get_near_far(rays_o, rays_d, *box), 10)
    nf_cpu_ms = _host_ms(lambda: ray_utils.get_near_far(*cpu_args))

    n = int(np.prod(HELPER_HEAT))
    heat = torch.from_numpy((np.random.RandomState(43).permutation(n).reshape(HELPER_HEAT)
                             .astype(np.float32) + 0.5) / n)
    check(len(torch.unique(heat)) == n, "the heatmap has ties")
    heat_d = heat.to(dev)
    for h, hd in ((heat - 0.5, heat_d - 0.5), (heat, heat_d)):  # negative, then in [0, 1)
        nms = data_utils.heatmap_nms(h)
        nms_d = data_utils.heatmap_nms(hd)
        check(torch.equal(nms_d.cpu(), nms), "heatmap_nms: the card differs from the CPU")
    tk, tk_d = data_utils.topk(nms, HELPER_TOPK), data_utils.topk(nms_d, HELPER_TOPK)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(tk_d, tk)),
          "topk: the card differs from the CPU")
    feat = nms.reshape(HELPER_HEAT[0], HELPER_HEAT[1], -1).transpose(1, 2).contiguous()
    feat_d = feat.to(dev)
    g = data_utils.gather_feat(feat, tk[1])  # each peak's row: its class's column is its score
    check(torch.equal(data_utils.gather_feat(feat_d, tk_d[1]).cpu(), g)
          and torch.equal(g.gather(2, tk[2].long().unsqueeze(-1))[..., 0], tk[0]),
          "gather_feat: the card differs from the CPU")
    det_ms = time_ms(lambda: data_utils.topk(data_utils.heatmap_nms(heat_d), HELPER_TOPK), 10)
    det_cpu_ms = _host_ms(lambda: data_utils.topk(data_utils.heatmap_nms(heat), HELPER_TOPK), 1)

    service.render_png(THETA0, PHI, RADIUS)  # warm
    log_dir = tempfile.mkdtemp(prefix="trace-")
    try:
        t = time.perf_counter()
        with profiling.trace(log_dir):
            profiling.sync(service.render(THETA0, PHI, RADIUS))
        trace_s = time.perf_counter() - t
        paths = glob.glob(os.path.join(log_dir, "*.json"))
        check(len(paths) == 1, f"trace: {paths}")
        with open(paths[0]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    b1 = sum("fused_nerf" in k for k in kern)
    b3 = sum("integrate" in k for k in kern)
    check(b1 > 0 and b3 > 0, f"the trace names no B1 ({b1}) or no B3 ({b3}) kernel")
    stats = profiling.memory_stats()
    mem = stats.get(f"cuda:{torch.cuda.current_device()}", {})
    check(mem.get("bytes_in_use", 0) > 0
          and mem.get("peak_bytes_in_use", 0) >= mem["bytes_in_use"],
          f"memory_stats: {stats}")
    secs = time.perf_counter() - t0
    log(f"helpers on {smi}: get_near_far on {rays_o.shape[0]} rays {nf_ms:.4f} ms on the card "
        f"({nf_cpu_ms:.2f} ms on the CPU; hits equal, {hits[0]} in the scene's box, {hits[1]} "
        f"in its central half; near/far "
        f"within {nf_err:.3g}); heatmap_nms + topk on {list(HELPER_HEAT)} {det_ms:.4f} ms "
        f"({det_cpu_ms:.2f} ms on the CPU; equal); a {SIZE}x{SIZE} request traced in "
        f"{trace_s:.3f} s, {len(kern)} kernel events, B1 {b1}, B3 {b3}; memory_stats "
        f"{mem['bytes_in_use'] / 2**30:.3f} GiB in use, peak {mem['peak_bytes_in_use'] / 2**30:.3f}"
        f" GiB; the phase {secs:.2f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import build, fused_mlp, integrate
    from nerf_tpu_torch.train.checkpoint import load_checkpoint, load_params

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"phase 1: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 2: build kernels")
    secs = build.build()
    for name in build.sources():
        log(f"built {name} in {secs.get(name, 0.0):.1f} s")
        for entry, stats in ptxas_entries(build.build_log(name)):
            log(f"  {entry}: {stats}")
            check(not ("wgmma" in entry and re.search(r"[1-9]\d* bytes spill", stats)),
                  f"{entry} spills registers")
        for l in build.build_log(name).splitlines():  # e.g. wgmma serialized, setmaxnreg ignored
            if "Performance" in l or "setmaxnreg" in l or "serializ" in l:
                log(f"  ptxas: {l.strip()}")

    log("phase 3: kernels against their plain versions on random inputs "
        "(torch.backends.cuda.matmul.allow_tf32 = False for the plain side)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = load_params(os.path.join(root, "checkpoints/nerf/lego/nerf"))
    kp = {k: v.to(dev) for k, v in fused_mlp.repack_params(params["coarse"]).items()}
    random_errs = random_phase(kp, dev)
    random_errs[0].append(wgmma_phase(kp, dev))
    hash_errs = hash_random_phase(dev)

    log("phase 4: serve")
    lego_cfg = make_cfg(os.path.join(root, "configs/nerf/lego.yaml"),
                        ["trained_model_dir", os.path.join(root, "checkpoints/nerf/lego/nerf")])
    service, first_png, launches, _ = serve_phase(
        dev, lego_cfg, {"fused_nerf_eval": fused_mlp.fused_nerf_eval,
                        "integrate": integrate.integrate})

    log("phase 5: kernels against their plain versions on the serving path's inputs")
    kernels, b3_rows = path_phase(service, random_errs)
    log("phase 6: the kernel path against the plain path")
    rgb_k = plain_phase(service)
    # renders are deterministic: the served PNG is the same frame
    check(bool((rgb_k == first_png).all()), "served frame differs from a re-render")

    log("phase 7: train through the entry point")
    with tempfile.TemporaryDirectory() as tmp:
        cfg, state, _, train_launches = train_phase(root, tmp)
    # phases 8-10 start from the state the run resumed (epoch 49) and its ESS
    # grid (the service's), on the model's own renders. 500 steps on the
    # synthetic scene's noise images drive the model toward their mean gray
    # (the loss nears 2 x 1/12, the variance of uniform colours, in both
    # passes), where the gradients nearly vanish; and the lego model's first
    # steps on those images (loss 0.6) are so steep that two paths 1e-3
    # apart in their gradients part after a few steps (0.08 in the loss
    # after 8, on this script's first run)
    state = load_checkpoint(os.path.join(root, "checkpoints/nerf/lego/nerf"), state)[0]
    grid = service.grid
    data = _model_views(service)
    log("phase 8: the backward kernel and a whole step against their plain versions")
    bwd_err, batches = grads_phase(cfg, state, grid, data, dev)
    log("phase 9: trajectory")
    trajectory_phase(cfg, state, grid, data, dev)
    log("phase 10: train times")
    bwd = train_times_phase(cfg, state, grid, data, dev, batches)
    kernels.insert(1, {"name": "fused_nerf_bwd", "route": "cuda",
                       "source": "nerf_tpu_torch/csrc/fused_mlp_bwd.cu",
                       "replaces": "nerf_tpu/ops/fused_mlp_bwd.py:43", "max_abs_err": bwd_err,
                       **bwd, "library_ms": None})
    log(f"launches on the serving path {launches}; on the train path {train_launches}")
    for k in kernels:
        k["launches"] = train_launches[k["name"]]

    work = tempfile.TemporaryDirectory()  # phases 11-19; the hash-grid model serves phase 18
    try:
        return _from_phase_11(root, dev, smi, work.name, service, first_png, kernels, b3_rows,
                              hash_errs)
    finally:
        work.cleanup()


def _from_phase_11(root, dev, smi, work, service, first_png, kernels, b3_rows, hash_errs):
    import torch
    from nerf_tpu_torch.ops import fused_mlp, integrate
    from nerf_tpu_torch.train.checkpoint import load_params

    log("phase 11: train the hash-grid model through the entry point")
    hcfg, hstate, _, hash_launches = hash_train_phase(root, work)
    log("phase 12: serve the hash-grid checkpoint")
    hservice, _, hserve_launches, request_ms = serve_phase(
        dev, hcfg, {k: c for k, c in _hash_counters().items()
                    if k != "hash_scatter_add_rows"}, n_timed=HASH_N_TIMED)
    hash_int_err, hash_b3 = hash_path_phase(hservice)
    plain_phase(hservice)
    log("phase 13: the scatter-add and a whole hash-grid step against their plain versions")
    # noise targets at the orbit's poses: the hash model trained on the noise
    # scene renders their mean gray, so its own renders would leave a loss
    # of 1e-4 and gradients too small to compare (4% apart on the first run)
    imgs, poses, K = _model_views(hservice)
    hdata = (torch.randint(0, 256, imgs.shape, dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5)), poses, K)
    scatter_err, fine_g, fine_s, train_b3 = hash_grads_phase(hcfg, hstate, hservice.grid, hdata,
                                                             dev)
    log("phase 14: hash-grid times")
    gather_t, scatter_t, step_ms = hash_times_phase(hcfg, hstate, hservice.grid, hdata, dev,
                                                    fine_g, fine_s)
    log(f"hash-grid model on {smi}: {step_ms:.3f} ms per train step (1024 rays), "
        f"{request_ms:.2f} ms per {SIZE}x{SIZE} request; B4 on the fine batch "
        f"{gather_t['ms']:.4f} ms (bound "
        f"{gather_t['bound_ms']:.4f}, sector floor {gather_t['sector_floor_ms']:.4f}); "
        f"launches on its serving path "
        f"{hserve_launches}, on its train path {hash_launches}")
    b3_summary(b3_rows + hash_b3 + train_b3)
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], hash_int_err)
    kernels.append({"name": "hash_gather_rows", "route": "cuda",
                    "source": "nerf_tpu_torch/csrc/hash_gather.cu",
                    "replaces": "nerf_tpu/ops/hash_gather.py:45",
                    "launches": hash_launches["hash_gather_rows"],
                    "max_abs_err": hash_errs["gather"], **gather_t})
    kernels.append({"name": "hash_scatter_add_rows", "route": "cuda",
                    "source": "nerf_tpu_torch/csrc/hash_gather.cu",
                    "replaces": "nerf_tpu/models/hashgrid.py:214 (XLA scatter-add of the "
                                "slotpack VJP; B4's backward)",
                    "launches": hash_launches["hash_scatter_add_rows"],
                    "max_abs_err": max(hash_errs["scatter"], scatter_err), **scatter_t})

    log("phase 15: a Blender-layout scene of the lego model's renders")
    scene_dir, decode_s, load_fps = scene_phase(root, work, service)
    log("phase 16: run --type dataset, --type network")
    network = run_phase(root, scene_dir)
    log("phase 17: run --type evaluate, the video, compaction")
    evaluated = evaluate_phase(root, scene_dir, {"fused_nerf_eval": fused_mlp.fused_nerf_eval,
                                                 "integrate": integrate.integrate})
    compacted_errs = []
    compaction = compaction_phase(root, scene_dir, compacted_errs, dev)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], check_fused_max(compacted_errs))
    log("phase 18: run --type marched; a hash-grid view through run --type evaluate")
    march = marched_phase(root, scene_dir, dev)
    hash_eval_phase(root, work, hservice, hcfg)
    log("phase 19: train on the Blender scene with validation, then --test")
    blender = blender_train_phase(root, work, scene_dir, _counters())
    log(f"evaluation slice on {smi}: {SCENE}x{SCENE} lego frame {network['mean_time_s'] * 1e3:.1f} "
        f"ms (run --type network), evaluate {evaluated['fps']:.3f} fps; PNG decode "
        f"{1.0 / decode_s:.2f} frames/s a thread, the loader {load_fps:.2f} frames/s; compaction "
        f"auto {compaction['auto']:.4f}, fixed {compaction['frac']:.4f}: {compaction['ms']:.1f} ms "
        f"vs dense {compaction['dense_ms']:.1f} ms; hierarchical {march['hier_ms']:.1f} ms "
        f"({march['hier_psnr']:.2f} dB) vs marched {march['march_ms']:.1f} ms "
        f"({march['march_psnr']:.2f} dB); Blender-data train step {blender['step_ms']:.2f} ms")
    log("phase 20: B1-f32 and B2-f32 against their float32 plain versions on random inputs")
    params = load_params(os.path.join(root, "checkpoints/nerf/lego/nerf"))
    fwd_errs, bwd_abs = f32_random_phase(params, dev)
    log("phase 21: serve the lego checkpoint with float32 weights")
    b1_f32 = f32_serve_phase(root, dev, service, fwd_errs)
    log("phase 22: train lego with float32 weights")
    b2_f32, f32_launches = f32_train_phase(root, work, _model_views(service), service.grid, dev)
    b2_f32["max_abs_err"] = max(b2_f32["max_abs_err"], bwd_abs)
    for k in (b1_f32, b2_f32):
        k["launches"] = f32_launches[k["name"]]
    kernels += [b1_f32, b2_f32]
    log("phase 23: frequency NeRFs of another shape (D=4, W=64), with and without view "
        "directions")
    small_nerf_phase(root, work, dev)
    log("phase 24: one whole-image train step (train_full_image)")
    full = full_image_phase(root, work, service, dev)
    log(f"float32 slice on {smi}: B1-f32 {b1_f32['ms']:.3f} ms on a lego fine tile (bound "
        f"{b1_f32['bound_ms']:.3f}), B2-f32 {b2_f32['ms']:.3f} ms on a step's fine batch (bound "
        f"{b2_f32['bound_ms']:.3f}); whole-image step {full['step_ms']:.1f} ms at "
        f"{FULL_IMAGE}x{FULL_IMAGE}, peak {full['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()  # the subprocesses below share the card
    log("phase 25: nerf_tpu_torch.bench, in-process, its kernels counted")
    bench = bench_phase(root, work)
    log("phase 26: the ESS/ERT harnesses")
    ess = ess_ert_phase(root, work, scene_dir)
    log("phase 27: KiloNeRF distillation from the committed teacher")
    distilled, kilo_dir, teacher_errs = distill_phase(root, work, dev)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], check_fused_max(teacher_errs))
    log("phase 28: KiloNeRF rendered, served and checked")
    kilo, kilo_b3 = kilo_phase(root, dev, scene_dir, kilo_dir)
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], ess["b3_err"], kilo_b3)
    log(f"harness and KiloNeRF slice on {smi}: bench {bench['value']:.1f} fwd rays/s, "
        f"{bench['train_rays_per_s']:.1f} train rays/s; ess_ert at {ESS_ERT_SIZE}x{ESS_ERT_SIZE} "
        f"s/frame {ess['ess_ert']['frame_times']}; distill {distilled['pts_per_s']:,.0f} pts/s, "
        f"{distilled['psnr']:.2f} dB against the teacher; KiloNeRF {SCENE}x{SCENE} frame "
        f"{kilo['frame_ms']:.1f} ms, {SIZE}x{SIZE} request {kilo['request_ms']:.2f} ms, "
        f"kilonerf_eval on a fine tile {kilo['eval_ms']:.3f} ms")
    log("phase 29: lego data-parallel at world 1 over NCCL")
    dp = dp_nccl_phase(root, work, service)
    log("phase 30: two ranks on the card over gloo")
    dp2 = dp_gloo_phase(root, work)
    log("phase 31: KiloNeRF trained from images")
    ktrain, kmodel, kcfg, fpts, fdirs = kilo_train_phase(root, work, scene_dir, dev)
    log("phase 32: KiloNeRF expert-parallel and the lego step at world 1 over NCCL; "
        "bench_scaling")
    ep = ep_phase(dev, smi, kmodel, kcfg, fpts, fdirs, dp)
    log(f"parallel slice on {smi}: lego {ep['nccl_ms']:.4f} ms a step at world 1 over NCCL, "
        f"{ep['plain_ms']:.4f} without a group (medians; interquartile ranges "
        f"{ep['iqr_ms']['nccl']:.4f}, {ep['iqr_ms']['none']:.4f}), the exchange alone "
        f"{ep['exchange_ms']:.4f} ms; "
        + (f"{dp2['ms']:.3f} ms a step at world 2 over gloo on one card; " if dp2 else
           "world 2 over gloo not run on the card; ")
        + f"KiloNeRF training {ktrain['step_ms']:.2f} ms a step ({ktrain['rays_per_s']:.0f} "
        f"rays/s); EP tile {ep['ep_ms']:.3f} ms vs dense {ep['dense_ms']:.3f} ms "
        f"({ep['points']} points); bench_scaling world 1 {ep['scaling']:.1f} rays/s")
    log("phase 33: every encoder type at JAX's defaults on the fine batch, through the "
        "kernels and plain")
    timed, enc = encoder_phase(dev)
    for name, i, err in (("hash_gather_rows", 0, "gather_err"),
                         ("hash_scatter_add_rows", 1, "scatter_err")):
        kern = next(k for k in kernels if k["name"] == name)
        kern["max_abs_err"] = max(kern["max_abs_err"], enc[err])
        kern["encoder_launches"] = enc["gather" if i == 0 else "scatter"]
        kern["encoder_shapes"] = [{"shape": f"{etype}: {ENC_TIMED[etype]}", "rows": rows,
                                   **times[i]} for etype, (*times, rows) in timed.items()]
    log("phase 34: img_fit through the trainer and run --type evaluate")
    img_fit = img_fit_phase(root, work, scene_dir, dev)
    log("phase 35: the light-stage loader")
    rig = light_stage_phase(work)
    g4, s4 = timed["cuda_hashgrid_4d"][:2]
    log(f"breadth slice on {smi}: B4 on the 4-D corner rows {g4['ms']:.4f} ms (bound "
        f"{g4['bound_ms']:.4f}, index_select {g4['library_ms']:.4f}), B4' {s4['ms']:.4f} ms "
        f"(bound {s4['bound_ms']:.4f}, index_add_ {s4['library_ms']:.4f}); under the encoder "
        f"phase B4 {enc['gather']} and B4' {enc['scatter']} launches; img_fit "
        f"{img_fit['step_ms']:.3f} ms a step, PSNR {img_fit['psnr']:.4f} dB after "
        f"{IMG_FIT_EPOCHS} epochs; light stage {rig[1.0]['read_ms']:.1f} ms a first read at "
        f"{RIG}x{RIG}, {rig[1.0]['batch_ms']:.2f} ms a batch")
    log("phase 36: lego_400_coarse trained from a fresh init and served (no fine pass)")
    coarse = coarse400_phase(root, work, dev)
    log("phase 37: lego_hashgrid (corner layout) trained, served, B4 and B4' on its fine batch")
    corner = corner_phase(root, work, dev, {"step_ms": step_ms, "request_ms": request_ms})
    for name, key, err in (("hash_gather_rows", "gather", "gather_err"),
                           ("hash_scatter_add_rows", "scatter", "scatter_err")):
        kern = next(k for k in kernels if k["name"] == name)
        kern["max_abs_err"] = max(kern["max_abs_err"], corner[err])
        kern["corner_nerf"] = corner[key]
    log("phase 38: the 7 other nerf_synthetic scene yamls")
    scenes = scenes_phase(root, work)
    log("phase 39: the native image loader")
    loader = loader_phase(work, scene_dir)
    log("phase 40: mesh extraction from the committed lego model")
    mesh = mesh_phase(root, work, dev)
    log("phase 41: a reference-format checkpoint of the lego model, ported and served")
    ported = ported_phase(root, work, dev, first_png)
    log("phase 42: a COLMAP model through colmap2nerf, the Blender loader and the trainer")
    colmap_run = colmap_phase(root, work, scene_dir)
    cg, cs = corner["gather"], corner["scatter"]
    log(f"configs and tools slice on {smi}: lego_400_coarse {coarse['request_ms']:.2f} ms a "
        f"{SIZE}x{SIZE} request; lego_hashgrid (corner) {corner['step_ms']:.3f} ms a step, "
        f"{corner['request_ms']:.2f} ms a request (cellpack {step_ms:.3f}, {request_ms:.2f}); "
        f"B4 {cg['ms']:.4f} ms (bound {cg['bound_ms']:.4f}, index_select "
        f"{cg['library_ms']:.4f}), B4' {cs['ms']:.4f} ms "
        f"(bound {cs['bound_ms']:.4f}, index_add_ "
        f"{cs['library_ms']:.4f}) on its {CORNER_ROWS} fine rows; 7 scenes "
        f"{sum(scenes.values()):.1f} s; native loader "
        f"{'built' if loader['native'] else 'not built: ' + str(loader['reason'])}; mesh at "
        f"{MESH_RES}^3 {mesh['verts']} vertices in {mesh['seconds']:.2f} s ({mesh['b1']} B1 "
        f"launches, lattice {mesh['lattice_ms']:.2f} ms); ported checkpoint "
        f"{ported['request_ms']:.2f} ms a request, equal to the committed model's frame; COLMAP "
        f"scene {colmap_run['seconds']:.2f} s")
    log("phase 43: the helpers, the profiler's trace and memory_stats on the card")
    helpers_phase(dev, smi, service)
    log("phase 44: the multi-tensor Adam kernel on lego's 48 leaves")
    kernels.append(adam_phase(dev, smi))
    log("phase 45: Instant-NGP's train path: B4 and B4' on its float32 table, a step's "
        "launches, Adam with the L2 and the skip")
    ngp_phase(dev, smi)
    log("phase 46: the hash encoder's kernels at ngp.train's shape")
    kernels += encoder_kernels_phase(dev, smi)
    log("phase 47: done")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "sector_floor_ms",
             "encoder_launches", "encoder_shapes", "corner_nerf"]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: kern[k] for k in order if k in kern}
                                  for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Failure as e:
        log(f"FAILED: {e}")
        code = 1
    sys.exit(code)
