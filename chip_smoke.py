"""Smoke run of the PyTorch port of NeRFactor on one GPU: the joint
model's inference and training, the shape stage's and the BRDF prior's
training (and the prior's explorer), the joint model from their
checkpoints, the NeRF stage's training and test rendering, geometry
distillation from that NeRF with the shape stage on its buffers, the
whole pipeline end to end (tools/quality_e2e.py) with the serving entry
points' video compile, the shipped variants: the GGX microfacet
ablation and the MVS path from a DTU-style scan, the dataset
converters on inputs at real data's sizes with NeRF and the BRDF prior
on what they write, and data-parallel training (``--multihost``) with
the step and relight tools.

  python3 chip_smoke.py      (from the repository root; needs one CUDA card)

1. Requires CUDA and prints the card's name and power limit.
2. Builds the CUDA kernels (nerfactor_tpu_torch/csrc) with nvcc for sm_90a,
   checks that every tensor-core kernel of the library (the bf16 K1-fwd,
   K1r-fwd, K1w-fwd, K2-fwd and K3-fwd, K2-bwd, the dW backwards' phase 1,
   K1r-bwd's and K1w-bwd's among them, the dW pass and K1w-bwd's dx pass)
   holds HMMA instructions, and holds their
   building block (mma.sync fragments,
   loaders, cp.async pipeline; csrc/mma_bf16.cuh) against the float64
   product of the same bf16 values, 64 x 96 x 80 and ragged sizes.
3. Writes a synthetic scene -- the analytic sphere at imh 128 with
   light_h 16: 3 train and 1 val views with a Lambertian rgba.png, 3 test
   views, two .npy light probes -- and seeded BRDF, shape and joint
   checkpoints at the shipped nerfactor.ini widths (128 x 4 MLPs, 512
   lights, bf16 big chains, fused kernels on).
4. Holds kernels K1-fwd and K2-fwd against their plain PyTorch versions
   at the shapes one inference chunk gives them, and times both; the bf16
   lvis chain's K1-fwd and the bf16 BRDF chain's K2-fwd run on the tensor
   cores, and are also held against the CUDA-core kernels they replace and
   timed beside them; the f32 heads as the rule runs them at this size,
   beside the split-TF32 kernel, and f32 K1-fwd both ways on the normal
   head at 128-524,288 rows (``f32_fwd_by_rows``).
5. Inference path: runs ``nerfactor_tpu_torch.test.main`` over the 3 test
   views (OLAT and probe relights on the last), with the kernels' launch
   counters set to 0 just before and read just after, and checks the
   files it writes; holds the model's GPU forward against its CPU forward
   on a few hundred rays.
6. Holds all four kernels against their plain versions (autograd of them
   for K1-bwd and K2-bwd) at the shapes one training step gives them
   (1024 rays x 512 lights, jitter twins on), reports what the f32
   kernel reads against the bf16 plain version (how far the bf16 bounds
   sit from a kernel that computed the f32 gradient), checks that
   K1-bwd's dW is bit-identical across two launches, and times kernels
   against plain versions, backward alone and forward + backward; bf16
   K1-fwd lvis alone at 1,048,576 rows (tensor cores) against the plain
   version and the CUDA-core kernel, with its device ms and TFLOP/s. bf16
   K1-bwd lvis with dW only (the tensor-core design) must read below the
   f32 kernel; its phase 1, dW pass and sums are timed apart (device ms
   from a profiler window), beside its scratch bytes, TFLOP/s and the
   HMMA count of its kernels in the built library. bf16 K2-fwd and K2-bwd
   (the tensor cores) at the step's 524,288 rows beside the CUDA-core
   kernels they replace: errors, device ms, TFLOP/s; K2-bwd's cotangents
   bit-identical across two launches. The f32 heads' training pair in
   split TF32 (``f32_head_readings``: the normal, albedo and brdf_z heads
   at 2,048 rows and the pipeline's 64-wide plan at 1,024): the forward
   within TOL_F32 and the backward with dW alone (phase 1 and the dW pass)
   within DW_TOL_F32 of the plain f32 version (TF32 off), dW bit-identical
   across two launches, the plain-TF32 control's and the CUDA-core
   kernels' readings beside each limit (the control must break one of
   them), ms, device ms, launches a backward and bounds, the CUDA-core
   kernels' ms and device ms; the packing kernel (``nfk_pack_transposed``)
   against ``pack_transposed``: the same bits in f32 and bf16, and both
   timed.
7. Training path: runs ``nerfactor_tpu_torch.trainvali.main`` on
   nerfactor.ini for 4 epochs (checkpoints every 2, vali at 4), with the
   four kernels' counters zeroed before and read after, checks its
   losses, checkpoints and vali images, and renders a view from the
   trained checkpoint with ``test.main``.
8. Times the steady-state train step at 1024 rays x 512 lights and
   profiles a few steps for the device's idle share and the time by
   kernel.
9. NeRF training path: runs ``trainvali.main`` on nerf.ini at full width
   (8 x 256 trunk, 64 + 128 samples, 1024 rays, bf16, fused) for 4 epochs
   on the scene's rgba.png views, with K3's counters zeroed before and
   read after; checks its losses, that every parameter of ckpt-4 moved
   from ckpt-2, and its vali images, flipbooks, PSNR and HTML.
10. NeRF serving path: runs ``nerf_test.main`` on ckpt-4 over the 3 test
   views (K3-fwd launched, K3-bwd not), checks the images, and holds the
   model's GPU test render against its CPU render on 256 rays.
11. Holds K3-fwd and K3-bwd against the plain version (autograd of it for
   the backward) at one train step's shapes (1024 rays x 64 and x 192
   samples), bf16 and f32, dW bit-identical across launches, and K1 on
   NeRF's no-views chain (256 x 8, 4-wide head); times both, and each of
   bf16 K3-bwd's kernels (phase 1, the dW pass, the sums: device time from
   a profiler window) with its scratch bytes and TFLOP/s; bf16 K3-fwd
   (tensor cores) beside the CUDA-core kernel it replaces, with its device
   ms and TFLOP/s.
12. Times the steady-state NeRF train step with a profiler window.
13. The stash route (K1r): holds K1r-fwd (with and without the stash, and
   the stash itself) and K1r-bwd against the stash route's plain version on
   every chain of the joint step at its shapes (the normal, albedo and
   brdf_z heads at 2,048 rows in f32, lvis at 1,048,576 rows in bf16, dW
   only) and on 65,536 lvis rows in f32 with dx, dW bit-identical across
   launches. The bf16 lvis calls run on the tensor cores; beside them the
   CUDA-core kernels they replace: the forward's output and the stash
   (bit for bit), the backward's dW/db, times, and device ms (the
   forward; the backward's phase 1, dW pass and sums apart) and TFLOP/s.
14. The last-skip chain (K1w): the lvis chain and its weights with the
   skip moved after the head, driven through apply_chain under autograd
   (bf16 at 1,048,576 rows, f32 at 65,536 with dx) with the counters
   zeroed before and read after; K1w-fwd and K1w-bwd against the plain
   version at the same shapes, dW bit-identical across launches; the head
   column and dW/db bit-identical to K1's on the same layers without the
   last skip (dW/db also held within K1W_VS_K1_TOL_BF16 by relative norm
   in bf16), the embedding columns to the CUDA-core K1w-fwd's. The bf16
   calls run on the tensor cores (K1w-fwd; K1w-bwd's phase 1, dW pass and
   dx pass); beside them the CUDA-core kernels they replace: dx, times,
   and device ms (the forward; the backward's kernels apart), TFLOP/s,
   and the backward with dW only and with dx only. Then f32 K1-bwd with
   dW alone on the lvis chain's weights at 2,048-65,536 rows
   (``f32_dw_by_rows``): the split-TF32 design against the plain f32
   version and float64 with the gates its phase 1 flipped, within
   DW_TOL_F32 wherever the rule sends it there.
15. The joint train step on the stash route (fused_mlp.TRANSPOSED_BOUNDARY
   = False): its loss and gradients against the default route's on one
   batch, then its steady-state step time, counters zeroed before and read
   after: one tensor-core K1r-fwd and K1r-bwd a step, no K1 (step 8 times
   the default route in the same run).
16. tools.chain_probe with --impl fused, fused_rowmajor and ref (both
   directions, bf16) through its entry point, each with the counters
   zeroed before and read after.
17. Kernel P (wgmma, TMA and an mbarrier ring) and its mma.sync control
   against the plain version (width 128, every mode): at 4,096 rows,
   depths 4 and 8, and at the probe's shapes (1,048,576 rows, block
   4,096, depths 12 and 32; the grid sweep's serial depth-8 chain at each
   of its blocks); the build's ptxas report (no spill), wgmma
   serialization notes and SASS (HGMMA, no HMMA); then tools.dot_probe's
   slope run and grid sweep at their defaults through its entry point,
   counters zeroed before and read after; the control's slopes and sweep
   by the same tool in turns; the kernel's device ms a launch and
   TFLOP/s; and beside it the plain version's and
   one torch.matmul per pass's slope (P's library yardstick, which the
   port never calls).

18. Shape stage: runs ``trainvali.main`` on shape.ini at full width
   (128 x 4, 1024 rays, 512 lights, bf16 lvis chain, fused kernels) for 4
   epochs on the scene's surface buffers, counters zeroed before and read
   after (K1-fwd and K1-bwd on the tensor cores for lvis; the f32 normal
   chain's training K1-fwd and K1-bwd with dW in split TF32, no K1-bwd on
   the CUDA cores); checks its losses, that every leaf of
   ckpt-2 and ckpt-4 moved, and its vali images, flipbooks and HTML. Holds
   one shape step's loss and every gradient leaf on the card against the
   port's plain version on the CPU (same batch and jitter), then times the
   step with a profiler window (device ms by kernel); the shape model's
   normal head as phase 6 reads the joint model's (``f32_head_readings``).
19. BRDF prior: writes synthetic MERL-format tables (3 materials; a test
   table of the characteristic slice and a 64 x 64 sphere render's rows),
   runs ``trainvali.main`` on brdf.ini at full width (128 x 4, z_dim 3,
   1024 rows and their reciprocity twins; plain PyTorch, no kernel) for 4
   epochs, checks losses, moved leaves and vali charts, and times the
   step; then ``explore_brdf_space.main`` on its ckpt-4: every identity's
   charts, slice and render, the HTML and the interpolation video.
20. Joint model from the port's stages: ``trainvali.main`` on
   nerfactor.ini for 2 epochs restoring the two checkpoints above (the
   restored leaves bit for bit the written ones), then ``test.main`` with
   ``--tgt_brdf`` (the edit's code is the BRDF checkpoint's row).
21. Geometry distillation: runs ``geometry_from_nerf.main`` on the NeRF
   run's ckpt-4 at nerf.ini's full width (8 x 256, 128 + 192 samples, 512
   lights) over every view of the scene (3 train, 1 val, 3 test) at imh
   64, counters zeroed before and read after (K1-fwd on the tensor cores
   in the bf16 visibility march and in split TF32 in the f32 depth/normal
   pass, two a block; K1-bwd with dx alone in split TF32, one a block; no
   CUDA-core K1 and no dW); checks the files,
   foreground, unit normals and lvis in [0, 1]; holds the card's two
   passes against the port's CPU run on 256 rays and 16 surface points,
   and reads the controls that must break those limits (the depth/normal
   pass in bf16, the march without the reference's 64 extra samples).
22. The shape stage (``trainvali.main`` on shape.ini, as 18) trained from
   the buffers 21 wrote, at imh 64.
23. The sigma chain at distillation's shapes: bf16 K1-fwd on the tensor
   cores at one visibility block's 8,355,840 rows, f32 K1-fwd and K1-bwd
   with dx alone (split TF32 on the tensor cores) at one depth/normal
   block's 1,048,320 fine and 419,328 coarse rows, against the plain
   versions (TF32 off), with ms, device ms (the mean over the launches a
   profiler window recorded; none recorded fails), bounds (f32 and split
   TF32), the CUDA-core kernels they replace (ms, same run) and the plain
   TF32 control's readings beside each limit, which must break one; f32
   K1-fwd both ways at 128-524,288 rows (``f32_fwd_by_rows``, as for the
   f32 normal head in phase 4).
24. ``tools.march_probe`` through its entry point at its defaults (nerf.ini,
   4096 points x 512 lights, 16384 rays), counters zeroed before and read
   after: ``lvis_march_torch`` and ``depth_normal_torch`` with the device's
   idle share, one JSON line each.
25. The pipeline end to end: ``tools.quality_e2e.main`` on the card at
   the 32px anchor's size (8 x 16 lights, 64-wide MLPs, 512 rays) on a
   short schedule (E2E_EPOCHS), with the exact buffers and then from its
   own NeRF (NeRF, distillation, BRDF prior, shape, joint), counters
   zeroed before and read after each; ``test.main`` (and with a NeRF
   ``nerf_test.main``) on its checkpoints with the video compile, each
   video's frame count checked; the joint model's mean vali PSNR against
   E2E_PSNR_FLOOR, and the control that must stay under it: the shape and
   joint stages again on the same buffers, each moved to the next view.
26. The GGX microfacet ablation: ``trainvali.main`` on
   nerfactor_microfacet.ini at full width (128 x 4, 1024 rays x 512
   lights, bf16 lvis chain, fused kernels) for 4 epochs from the seeded
   shape checkpoint, counters zeroed before and read after (K1 on the
   tensor cores for lvis; for the albedo, roughness and normal heads in
   split TF32 in training, forward and backward with dW, no K1-bwd on the
   CUDA cores; K2 never); its losses, checkpoints without BRDF-prior
   leaves, every leaf of ckpt-4 moved from ckpt-2, the roughness image;
   ``test.main`` on ckpt-4 with OLAT and probe relights and the video; one
   step's loss and every gradient leaf on the card against the CPU plain
   port; ``microfacet_spec`` at 1024 x 512 pairs against float64 and the
   CPU; the step's time with its idle share; the roughness, albedo and
   normal heads as phase 6 reads the joint model's
   (``f32_head_readings``). The control of the lobe's
   two limits and the step's: the lobe in bf16 (``lobe_in_bf16``), which
   must break each. Beside the step's leaves, their distance from the CPU
   step whose f32 heads run in float64, for the card's step, the same
   step with the heads on the CUDA cores and the CPU's
   (``f32_heads_witness``).
27. The MVS path: ``tools/synth_dtu.py`` writes a DTU-style scan (an
   icosphere of 5,120 faces, 8 views at 128 px), ``dtu_surf_from_mvs.main``
   casts it on the card (--h 128 --light_h 16, 3 test views: seconds a
   view, ray-triangle tests a second), the tracer on the card against the
   CPU on 2,048 of its rays, ``trainvali.main`` on shape_mvs.ini for 4
   epochs and on nerfactor_mvs.ini for 2 from that checkpoint (counters
   zeroed before and read after: K1; K1 and K2), each step timed, then
   ``test.main`` on the MVS test views with its video. The tracer's
   control: the same rays against the mesh's vertices rounded to bf16,
   which must break its limits.
28. The dataset converters (``data_gen``), each through its entry point
   and timed: (a) a synthetic LLFF capture (tools/synth_llff.py, 20 JPEG
   views at LLFF's images_4 size, 1008 x 756) by
   ``nerf_real_make_dataset`` at its default --h 512; (b) a raw DTU scan
   (tools/synth_dtu.py, 49 views at DTU's 1600 x 1200) by
   ``dtu_make_dataset_from_raw`` and, from cameras.npz of the same
   projections, ``dtu_make_dataset``, both at their default --h 256; (c)
   three MERL binaries at the format's full size by ``merl_make_dataset``
   at its defaults (--ims 128). Then ``trainvali.main`` on nerf.ini at
   full width for one epoch on (a) at imh 512 and on (b) at 256, counters
   zeroed before and read after (K3-fwd and K3-bwd must launch), every
   leaf moved; ``debug/dataloader.py`` on (a)'s run; brdf.ini for 2
   epochs on (c). Prints its own JSON line (walls, view counts and sizes,
   launches, the nvidia-smi line).
29. Multi-device training (``multidevice``): (a) ``trainvali.main`` with
   ``--multihost`` and one process (NCCL, a TCP coordinator on
   localhost) on nerfactor.ini as in 7, counters zeroed before and read
   after: the tensor-core K1 and K2 launches equal 7's, its ckpt-4 holds
   7's within MD_CLI_TOL, vali written. In one NCCL group of one process,
   the joint step at 1024 rows with the gradient all-reduce against the
   plain step, and the all-reduce alone (CUDA events), with the bytes it
   reduces. (b) Two ranks on the one card (gloo: NCCL takes one rank a
   card), each on 1024 rows of a 2048-row batch of the scene's rays, three
   joint steps from the seeded checkpoint, against one process on the
   2048 rows with the same draws: every trainable leaf's update within
   MD_RANKS_TOL, and the control (ranks that skip the reduction) outside.
   The two ranks share one card, so their time is no scaling figure. Then
   ``tools.step_time``, ``tools.profile_joint`` (counters zeroed before
   and read after each) and ``tools.bench_relight`` at their defaults,
   each printing its JSON line. Prints the phase's JSON line.
30. The multi-step dispatch (``scan_dispatch``; it runs last): the
   shipped ``scan_steps`` = 8, a group of steps as one CUDA graph launch
   (``make_train_step_scan``). On a scene of its own (the sphere at imh
   64 with SCAN_TRAIN = 19 train views, a batch a view: two groups and 3
   single steps an epoch), for each of nerfactor.ini, nerf.ini,
   shape.ini and nerfactor_microfacet.ini at full width: from one start
   (parameters, optimizer state and the generator's state cloned) 11
   steps two ways, the eager loop of ``make_train_step`` and one graph
   replay of 8 steps (the graph's first call and its capture on groups of
   their own first, then the start copied back into its storage) plus 3
   eager steps; the losses, every parameter, the optimizer state and the
   generator's state must be the eager loop's bit for bit, the replay
   runs under ``torch.cuda.set_sync_debug_mode('error')``, and the
   launches a step it counts (a replay counts every launch it runs, the
   capture none) must equal the eager loop's. Then ms a step both ways
   over 4 groups (CUDA events, the
   host's issue inside), a profiler window of 2 groups each way (busy ms,
   idle share of the window and of the timed ms, one ``cudaGraphLaunch``
   a group), the capture's seconds and its pool's MiB. Then ``trainvali.main`` on each INI for 2 epochs on that
   scene, counters zeroed before and read after: 4 groups, the graph
   captured; each again with ``scan_steps`` = 1 (every step eager), its
   ckpt-2 the graph run's bit for bit; nerfactor.ini
   again with ``--multihost`` (one process, NCCL: the graph holds the
   all-reduce), its ckpt-2 the run's without bit for bit; a gloo group's
   scan on CUDA tensors must raise ValueError. Prints the phase's JSON
   line. K3's transposed weights packed in one launch
   (``nfk_pack_transposed_table``) are held against the plain packing bit
   for bit at nerf.ini's width after 11 (``k3_pack_readings``).

Every profiler window is ``card.profiler_window``: the profiler drops the
first kernels of about every other window, more as the process ages
(PERF.md §7), so a window first launches empty kernels, which the
readings leave out (``card.device_events``), and holds host idle on each
side of its work.

Prints a JSON line of per-kernel results (with each kernel's bound: the
least time the card could take for the same work; also written to
build/smoke/result.json), the nvidia-smi line,
and as the last line {"ok": true, "device": {...}}. Any failed check
raises, so the run exits non-zero. The only cuts from production are imh
128 (not 512; distillation and the shape stage on its buffers imh 64),
the BRDF test table's render (64 x 64, not 128), the MVS scan's test
trajectory (3 views, not 120) and the NeRF runs on the converted scenes
(one epoch); the probes and the converters run at their own defaults,
uncut.

  python3 chip_smoke.py --limit_seeds k3 11,12,13,14
  python3 chip_smoke.py --limit_seeds k1 11,12,13,14
  python3 chip_smoke.py --limit_seeds k1r 11,12,13,14
  python3 chip_smoke.py --limit_seeds k1w 11,12,13,14
  python3 chip_smoke.py --limit_seeds k2 11,12,13,14

print only the readings behind a kernel's error bounds, over weights and
inputs drawn from each seed: for K3, its error readings (bf16 and f32,
both row counts, the f32 kernel's beside the bf16 kernel's) over random
nerf.ini weights; for K1, its bf16 readings (k1_limit_readings: the lvis
chain's tensor-core backward and the f32 kernel against the plain bf16
version at the joint step's 1,048,576 rows, and K1w against K1) over
lvis weights; for K1r, the same on the stash route (k1r_limit_readings:
K1r-bwd's tensor-core, CUDA-core bf16 and f32 kernels and K1r-fwd against
the plain bf16 stash route at 1,048,576 rows); for K1w, the same on the
lvis chain with its skip after the head (k1w_limit_readings: K1w-fwd and
K1w-bwd with dx and dW, tensor-core, CUDA-core bf16 and f32 kernels,
against the plain bf16 version at 1,048,576 rows, and against K1); for
K2, its bf16 readings
(k2_limit_readings: K2-fwd's output and K2-bwd's cotangents against the
plain bf16 version at the joint step's 524,288 rows, of the tensor-core
kernels, the CUDA-core bf16 kernels and the f32 kernels) over BRDF
weights.

  python3 chip_smoke.py --field_seed k3 0
  python3 chip_smoke.py --field_seed k1 0
  python3 chip_smoke.py --field_seed k1r 0
  python3 chip_smoke.py --field_seed k2 0

print only a bf16 backward's readings against the plain bf16 version (and
float64, for K3), its dW digest, times, per-kernel device ms and ptxas
report, with the bf16 forward's output against the plain version, its ms
and device ms, on one field drawn from the seed: nerf.ini's field under the
tests' kind of weights (glorot-uniform, small random biases) at 196,608
rows, or the lvis chain under the shape model's (glorot-uniform, zero
biases) at 1,048,576 rows, on K1's route or the stash route (K1r, the
forward with its stash); for K2, the sha256 of bf16 K2-bwd's cotangents
and K2-fwd's output on the shipped BRDF chain at 524,288 rows
(k2_field_readings). Each calls only its kernel's wrappers.

  python3 chip_smoke.py --f32_heads

prints only phase 6's f32 heads readings (the split-TF32 training pair
against the plain f32 version and the CUDA-core kernels, the packing
kernel), ``f32_fwd_by_rows`` on the normal head and ``f32_dw_by_rows`` on
the lvis chain.

  python3 chip_smoke.py --steps 2

prints only the joint, shape and microfacet train steps' ms, host CPU ms,
device busy ms and idle share, each run twice in turns (steps_alone; it
calls only the models).

  python3 chip_smoke.py --scan_dispatch

prints only phase 30's JSON line (it writes the scene it needs).

  python3 chip_smoke.py --view_repeats 4

prints only the seconds per view of test.py and nerf_test.py on the smoke's
scene, each run 4 times in turns (view_readings; it calls only the entry
points). To compare with an older checkout, run that checkout's own
script beside this one.
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from os.path import abspath, dirname, join

import numpy as np
import torch

from nerfactor_tpu_torch import explore_brdf_space, geometry_from_nerf
from nerfactor_tpu_torch.data_gen import (
    dtu_make_dataset, dtu_make_dataset_from_raw, dtu_surf_from_mvs,
    merl_make_dataset, meshio, nerf_real_make_dataset, raytrace)
from nerfactor_tpu_torch.debug import dataloader as debug_dataloader
from nerfactor_tpu_torch import nerf_test
from nerfactor_tpu_torch import test as test_cli
from nerfactor_tpu_torch import trainvali
from nerfactor_tpu_torch.brdf import merl
from nerfactor_tpu_torch.brdf.renderer import SphereRenderer
from nerfactor_tpu_torch.datasets.brdf_merl import (
    N_BETWEEN, Dataset as BrdfDataset)
from nerfactor_tpu_torch.datasets.nerf import Dataset as NerfDataset
from nerfactor_tpu_torch.datasets.mvs_shape import Dataset as MvsDataset
from nerfactor_tpu_torch.datasets.nerf_shape import Dataset
from nerfactor_tpu_torch.models import networks
from nerfactor_tpu_torch.models.brdf import Model as BrdfModel
from nerfactor_tpu_torch.models.nerf import Model as NerfModel
from nerfactor_tpu_torch.models import (
    nerfactor_microfacet as microfacet_model)
from nerfactor_tpu_torch.models.nerfactor_microfacet import (
    Model as MicrofacetModel)
from nerfactor_tpu_torch.models.nerfactor import (
    BRDF_PARAM_KEYS, SHAPE_PARAM_KEYS, Model)
from nerfactor_tpu_torch.models.shape import Model as ShapeModel
from nerfactor_tpu_torch.ops import dot_probe as dp
from nerfactor_tpu_torch.ops import encoding, geom as geomops, sampling
from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import fused_nerf as fn
from nerfactor_tpu_torch.ops import fused_rusink as fr
from nerfactor_tpu_torch.ops import kernel_lib
from nerfactor_tpu_torch.ops.microfacet import microfacet_spec
from nerfactor_tpu_torch.parallel import mesh
from nerfactor_tpu_torch.parallel.train import (
    build_optimizer, make_train_step, make_train_step_scan, upcast_batch)
from nerfactor_tpu_torch.tools import (
    bench_model, bench_relight, chain_probe, dot_probe, march_probe,
    profile_joint, quality_e2e, step_time, synth_dtu, synth_llff,
    synth_scene)
from nerfactor_tpu_torch.utils import (
    card, ckpt as ckptutil, config as configutil, io as ioutil)

ROOT = dirname(abspath(__file__))
WORK = join(ROOT, 'build', 'smoke')
IMH, LIGHT_H, N_VIEWS = 128, 16, 3
N_LIGHTS = 2 * LIGHT_H * LIGHT_H
N_TRAIN, N_VALI = 3, 1
N_RAYS = 1024  # nerfactor.ini n_rays_per_step, bench.py's step

# Tolerances of a kernel against its plain version (|err| <= atol + rtol
# * |plain|): f32 chains differ only in summation order; bf16 chains
# round activations at other places (the plain version also rounds each
# pre-activation and the head to bf16). TOL_F32 holds the per-row outputs
# of the f32 backward kernels too (dx, dz, dldir, dvdir).
TOL_F32 = (1e-4, 1e-4)
TOL_BF16 = (2e-2, 2e-2)
# dW/db sum up to 1M rows: each f32 leaf is held by its relative norm
# |got - plain| / |plain| (summation order only).
DW_TOL_F32 = 1e-4
# bf16 backward: the plain version rounds every cotangent to bf16 at each
# cast, the kernel (as the TPU kernel) keeps d_h in f32 and rounds d_pre.
# Every bf16 cotangent (each dW/db leaf; dx, dz, dldir, dvdir over the
# rows kept) is held by its relative norm. Readings at this step's shapes
# over 4 seeds (NVIDIA H100 80GB HBM3, 700.00 W): the kernel <= 0.013
# (dW), 0.0047 (dx), 0.0060 (K2-bwd); the f32 kernel, i.e. a kernel that
# computed the f32 gradient, >= 0.086, 0.042, 0.053. The lvis chain's
# dW/db with dW only, on the tensor cores (k1_limit_readings, seeds
# 11-14): 0.0052-0.0158 against the f32 kernel's 0.087-0.098.
# check_backward reports the f32 kernel's reading in every run.
NORM_TOL_BF16 = 0.025
# The per-row bf16 cotangents of K2-bwd also get a bound per element, for
# a fault confined to a few rows: over the same 4 seeds the kernel's worst
# element needed atol 0.048 at rtol 0.1, the f32 kernel's 0.57 on dldir
# and dvdir (0.037 on dz, which only the norm tells apart).
TOL_BF16_GRAD = (1e-1, 1e-1)


# ------ synthetic scene: the analytic sphere of tools/synth_scene.py ------

SPHERE_R, CAM_DIST = synth_scene.SPHERE_R, synth_scene.CAM_DIST


def write_scene(data_root, nerf_root, imh=IMH):
    """The sphere's views at ``imh`` (N_TRAIN train, N_VALI val, N_VIEWS
    test) and, under ``nerf_root`` unless None, their exact buffers."""
    synth_scene.make_scene(data_root, n_train=N_TRAIN, n_vali=N_VALI,
                           n_test=N_VIEWS, imh=imh,
                           with_buffers=nerf_root is not None,
                           nerf_root=nerf_root, light_h=LIGHT_H)


def write_experiments(data_root, nerf_root, probe_dir):
    """Seeded BRDF, shape and joint experiments as trainvali would leave
    them (<outroot>/<xname>.ini + checkpoints/ckpt-N.npz)."""
    g = torch.Generator().manual_seed(0)
    cfg_dir = configutil.CONFIG_DIR

    def experiment(name, ini, override):
        parser = configutil.read_config(join(cfg_dir, ini))
        configutil.apply_override(parser, override)
        outdir = join(WORK, 'out', name, 'run')
        configutil.write_config(parser, outdir + '.ini')
        return configutil.Config(parser), join(outdir, 'checkpoints')

    cb, brdf_dir = experiment('merl', 'brdf.ini', '')
    in_dim = cb.getint('z_dim') + encoding.embed_dims(3, cb.getint('n_freqs'))
    mlp = networks.MLPSpec(in_dim, [cb.getint('mlp_width')]
                           * cb.getint('mlp_depth'), 'relu',
                           [cb.getint('mlp_skip_at')])
    head = networks.MLPSpec(mlp.out_dim, [1], 'softplus')
    ckptutil.save_pytree({'params': {
        'brdf_mlp': mlp.init(g), 'brdf_out': head.init(g),
        'latent_code': networks.init_latent_code(g, 8, cb.getint('z_dim'),
                                                 std=0.5)}},
        join(brdf_dir, 'ckpt-50'))
    cs, shape_dir = experiment('shape', 'shape.ini', 'imh=%d' % IMH)
    ckptutil.save_pytree(
        {'params': ShapeModel(cs, device='cpu').init_params(g)},
        join(shape_dir, 'ckpt-2'))
    joint_override = ','.join([
        'data_root=' + data_root, 'data_nerf_root=' + nerf_root,
        'brdf_model_ckpt=' + join(brdf_dir, 'ckpt-50'),
        'shape_model_ckpt=' + join(shape_dir, 'ckpt-2'),
        'test_envmap_dir=' + probe_dir, 'imh=%d' % IMH,
        'light_h=%d' % LIGHT_H])
    cn, joint_dir = experiment('nerfactor', 'nerfactor.ini', joint_override
                               + ',outroot=' + join(WORK, 'out', 'nerfactor'))
    ckptutil.save_pytree({'params': Model(cn, device='cpu').init_params(g)},
                         join(joint_dir, 'ckpt-10'))
    return cn, join(joint_dir, 'ckpt-10'), joint_override


# ------ kernel checks ------

def time_ms(fn, iters=20):
    """Mean device time of ``fn`` per call, by CUDA events."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, tol, mask=None):
    err = (got - want).abs()
    bound = tol[0] + tol[1] * want.abs()
    if mask is not None:
        err, bound = err[mask], bound[mask]
    if not torch.isfinite(got).all():
        raise AssertionError("%s: non-finite kernel output" % name)
    bad = int((err > bound).sum())
    if bad:
        raise AssertionError("%s: %d values beyond tolerance %s (max err "
                             "%.3g)" % (name, bad, tol, err.max().item()))
    return err.max().item()


def check_kernels(model, params):
    """K1-fwd on each head's chain and K2-fwd on the BRDF chain, at the
    shapes one test chunk gives them (128 rays x 512 lights)."""
    dev = params['light'].device
    g = torch.Generator().manual_seed(1)
    n = model.eval_ray_chunk
    pts = torch.randn(n, 3, generator=g)
    pts = (SPHERE_R * pts / pts.norm(dim=1, keepdim=True)).to(dev)
    cam = torch.tensor([CAM_DIST, 0.0, 1.0], device=dev).expand(n, 3)
    surf2l = model.calc_ldir(pts)
    lvis_x = torch.cat((pts[:, None].expand(surf2l.shape).reshape(-1, 3),
                        surf2l.reshape(-1, 3)), dim=1)
    w2l = geomops.gen_world2local(pts)
    ldir = torch.einsum('jkl,jnl->jnk', w2l, surf2l).reshape(-1, 3)
    vdir = torch.einsum('jkl,jl->jk', w2l, model.calc_vdir(cam, pts))
    vdir = vdir[:, None].expand(n, model.n_lights, 3).reshape(-1, 3)
    z = (0.5 * torch.randn(n, model.z_dim, generator=g)).to(dev)
    z = z[:, None].expand(n, model.n_lights, model.z_dim).reshape(
        -1, model.z_dim)
    # phi_d is discontinuous at 0 == pi: rows within rounding of the wrap
    # may land on either side in the two versions, so they are left out
    pd = geomops.dir2rusink(ldir, vdir)[:, 0]
    off_wrap = ((pd > 1e-3) & (pd < np.pi - 1e-3))[:, None]

    chains = [('normal', 'normal_mlp', 'normal_out', pts, None),
              ('albedo', 'albedo_mlp', 'albedo_out', pts, None),
              ('brdf_z', 'brdf_z_mlp', 'brdf_z_out', pts, None),
              ('lvis', 'lvis_mlp', 'lvis_out', lvis_x,
               model.chain_dtype('lvis'))]
    k1 = []
    for name, mlp, out, x, cd in chains:
        plan = model.plans[name]
        p = fm.params_from_tree(params[mlp], params[out])
        run_k = lambda: fm.chain_kernel(plan, x, p, cd)  # noqa: E731
        run_p = lambda: fm.chain_reference(plan, x, p, cd)  # noqa: E731
        tol = TOL_BF16 if cd is not None else TOL_F32
        row = {'chain': name, 'rows': x.shape[0],
               'dtype': 'bf16' if cd is not None else 'f32',
               'max_abs_err': compare('K1-fwd ' + name, run_k(), run_p(),
                                      tol),
               'tol': tol}
        if cd is not None and fm.fwd_on_tensor_cores(plan, cd, x.device):
            row.update(tc_fwd_readings(
                run_k, lambda: fm.chain_kernel_cuda_core(plan, x, p, cd),
                lambda: fm.chain_kernel_cuda_core(plan, x, p, None), run_p,
                chain_bound(plan, x.shape[0], 'bf16', 6, 1)['flop'],
                K1_FWD_KERNELS))
        else:
            row.update(ms=time_ms(run_k), plain_ms=time_ms(run_p),
                       split_tf32=fm.fwd_on_tensor_cores(
                           plan, cd, x.device, rows=x.shape[0]))
            if cd is None and fm.fwd_on_tensor_cores(plan, cd, x.device):
                # The split-TF32 kernel here, and both kernels by rows
                row['split_tf32_ms'] = time_ms(
                    lambda: fm.chain_kernel_f32_tc(plan, x, p))
                if name == 'normal':
                    row['by_rows'] = f32_fwd_by_rows(plan, p)
        k1.append(row)
    plan, cd = model.plans['brdf'], model.chain_dtype('brdf')
    p = fm.params_from_tree(params['brdf_mlp'], params['brdf_out'])
    run_k = lambda: fr.rusink_kernel(plan, z, ldir, vdir, p, cd)  # noqa: E731
    run_p = lambda: fr.reference(plan, z, ldir, vdir, p, cd)  # noqa: E731
    tol = TOL_BF16 if cd is not None else TOL_F32
    k2 = {'chain': 'brdf', 'rows': z.shape[0],
          'dtype': 'bf16' if cd is not None else 'f32',
          'max_abs_err': compare('K2-fwd brdf', run_k(), run_p(), tol,
                                 mask=off_wrap),
          'rows_at_phi_d_wrap': int((~off_wrap).sum()), 'tol': tol}
    if fr.rusink_on_tensor_cores(plan, cd, z.device):
        k2.update(k2_fwd_readings(plan, p, z, ldir, vdir, off_wrap))
    else:
        k2.update(ms=time_ms(run_k), plain_ms=time_ms(run_p))
    return k1, k2


def k2_fwd_readings(plan, p, z, ldir, vdir, keep):
    """tc_fwd_readings of bf16 K2-fwd on the tensor cores against the
    CUDA-core kernel it replaces, on the rows ``keep`` (N, 1) leaves off
    phi_d's wrap for the plain version."""
    cd = torch.bfloat16
    return tc_fwd_readings(
        lambda: fr.rusink_kernel(plan, z, ldir, vdir, p, cd),
        lambda: fr.rusink_kernel_cuda_core(plan, z, ldir, vdir, p, cd),
        lambda: fr.rusink_kernel_cuda_core(plan, z, ldir, vdir, p, None),
        lambda: fr.reference(plan, z, ldir, vdir, p, cd),
        chain_bound(plan, z.shape[0], 'bf16', z.shape[1] + 6, 1)['flop'],
        K2_FWD_KERNELS, mask=keep.expand(-1, plan.widths[-1]))


def check_forward(model_gpu, model_cpu, params, dataset):
    """The model's GPU forward (kernels) against its CPU forward (plain
    versions) on the first 256 rays of the last test view."""
    batch = list(dataset.build_pipeline(no_shuffle=True, prefetch=0))[-1]
    rows = slice(IMH * IMH // 2, IMH * IMH // 2 + 256)  # crosses the sphere
    arrays = {k: torch.as_tensor(np.asarray(batch[k][rows], np.float32))
              for k in dataset.array_keys}
    with torch.no_grad():
        pred_g = model_gpu.apply(
            params, {k: v.cuda() for k, v in arrays.items()}, mode='test',
            relight_olat=True, relight_probes=True)[0]
        pred_c = model_cpu.apply(
            ckptutil.tree_map(lambda t: t.cpu(), params), arrays,
            mode='test', relight_olat=True, relight_probes=True)[0]
    errs = {}
    for k, want in pred_c.items():
        got = pred_g[k].cpu()
        if got.shape != want.shape:
            raise AssertionError("%s: shape %s vs %s" % (
                k, tuple(got.shape), tuple(want.shape)))
        # Outputs downstream of the bf16 chains carry their tolerance
        tol = TOL_F32 if k in ('normal', 'albedo', 'brdf') else TOL_BF16
        errs[k] = compare('forward ' + k, got, want, tol)
    return errs


def rel_norm(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def time_pair(run_k, run_p, iters=20):
    """(kernel ms, plain ms) by CUDA events, in turns k, p, p, k."""
    k1, p1, p2, k2 = (time_ms(f, iters) for f in (run_k, run_p, run_p, run_k))
    return (k1 + k2) / 2, (p1 + p2) / 2


def tc_fwd_readings(run, run_core, run_f32, run_plain, flop, kernels,
                    iters=10, mask=None):
    """What the smoke reads of a bf16 forward on the tensor cores (``run``,
    its output one tensor) at a path's shape: its output against the
    CUDA-core bf16 kernel's (``run_core``), and the f32 kernel's
    (``run_f32``, the control) against both that and the plain bf16
    version (``run_plain``; on the rows ``mask`` keeps, where given); the
    output bit-identical across two launches;
    its ms and the plain version's (CUDA events, in turns), the CUDA-core
    kernel's ms (the kernel it replaces, timed in the same run), its
    device ms (kernel_device_ms) and TFLOP/s (``flop``)."""
    with torch.no_grad():
        got, core, f32, plain = run(), run_core(), run_f32(), run_plain()
        keep = slice(None) if mask is None else mask
        out = {'tc_vs_cuda_core_rel_err': rel_norm(got, core),
               'f32_kernel_vs_cuda_core_rel_err': rel_norm(f32, core),
               'f32_kernel_max_abs_err':
                   (f32 - plain)[keep].abs().max().item(),
               'fwd_bit_identical': torch.equal(got, run())}
        if not out['fwd_bit_identical']:
            raise AssertionError("tensor-core forward: output differs "
                                 "between two launches on the same inputs")
        del got, core, f32, plain
        out['ms'], out['plain_ms'] = time_pair(run, run_plain, iters=iters)
        out['cuda_core_ms'] = time_ms(run_core, iters=iters)
        out.update(kernel_device_ms(run, kernels, iters=iters))
    out['tflops'] = flop / out['ms'] / 1e9
    return out


def step_inputs(model, g):
    """The chains' inputs at one training step's shapes: N_RAYS surface
    points with their jitter twins (2N rows for the heads and 2N x L for
    lvis) and the BRDF chain's N x L local-frame directions."""
    dev = 'cuda'
    pts = torch.randn(N_RAYS, 3, generator=g)
    pts = SPHERE_R * pts / pts.norm(dim=1, keepdim=True)
    twins = torch.cat([pts, pts + model.xyz_jitter_std * torch.randn(
        N_RAYS, 3, generator=g)]).to(dev)
    surf2l = model.calc_ldir(twins)
    lvis_x = torch.cat((twins[:, None].expand(surf2l.shape).reshape(-1, 3),
                        surf2l.reshape(-1, 3)), dim=1)
    pts = pts.to(dev)
    cam = torch.tensor([CAM_DIST, 0.0, 1.0], device=dev).expand(N_RAYS, 3)
    w2l = geomops.gen_world2local(pts)
    ldir = torch.einsum('jkl,jnl->jnk', w2l, model.calc_ldir(pts)).reshape(
        -1, 3)
    vdir = torch.einsum('jkl,jl->jk', w2l, model.calc_vdir(cam, pts))
    vdir = vdir[:, None].expand(N_RAYS, model.n_lights, 3).reshape(-1, 3)
    z = (0.5 * torch.randn(N_RAYS, model.z_dim, generator=g)).to(dev)
    z = z[:, None].expand(N_RAYS, model.n_lights, model.z_dim).reshape(
        -1, model.z_dim)
    return twins, lvis_x, (z, ldir, vdir)


def chain_f64(plan, x, params, gates=None, pres=None):
    """The plain chain in float64 (the exact math the f32 kernels are held
    to), and per row the smallest |pre-activation| over its ReLU layers:
    a row whose gate sits within rounding of 0 may be gated differently
    by an f32 version, and its gradient then differs by that unit's whole
    contribution. ``gates`` (a boolean tensor a ReLU layer) replaces each
    ReLU's own gate with the given one; ``pres``, a list, receives each
    ReLU layer's pre-activations."""
    e = fm._embed(plan, x)
    h, low = e, None
    for i, ((w, b), act) in enumerate(zip(params, plan.acts)):
        w, b = w.double(), b.double()
        if i > 0 and (i - 1) in plan.skip_at:
            pre = torch.cat((h, e), dim=1) @ w + b
        else:
            pre = h @ w + b
        if act == 'relu':
            m = pre.detach().abs().min(dim=1).values
            low = m if low is None else torch.minimum(low, m)
            if pres is not None:
                pres.append(pre.detach())
            if gates is not None:
                h = pre * gates[i]
                continue
        h = fm._act(act, pre)
    return h, low


# In the f32 per-row backward check, rows whose pre-activations come within
# this of a ReLU kink are left out: a sum of 128 products of size up to ~1
# in f32 moves by up to ~1e-5, enough to gate a unit the other way
# (measured: rows at 6e-8 from a kink missed by 0.035). In bf16 rounding
# moves pre-activations by ~1e-2, and nearly every row has one of its 512
# units that close, so no row is left out for it: those gate flips are
# inside TOL_BF16_GRAD.
KINK_F32 = 1e-4


def check_norm(name, errs, tol):
    if max(errs) > tol:
        raise AssertionError("%s: relative error %.3g > %g"
                             % (name, max(errs), tol))
    return max(errs)


def flatten(pairs):
    return [t for pair in pairs for t in pair]


def check_backward(model, params):
    """K1-fwd/K1-bwd on each chain and K2-fwd/K2-bwd on the BRDF chain at
    one training step's shapes, against the plain versions (autograd for
    the backward) on the same tensors; timings of backward alone and of
    forward + backward."""
    g = torch.Generator().manual_seed(2)
    twins, lvis_x, (z, ldir, vdir) = step_inputs(model, g)
    chains = [('normal', 'normal_mlp', 'normal_out', twins, None),
              ('albedo', 'albedo_mlp', 'albedo_out', twins, None),
              ('brdf_z', 'brdf_z_mlp', 'brdf_z_out', twins, None),
              ('lvis', 'lvis_mlp', 'lvis_out', lvis_x,
               model.chain_dtype('lvis'))]
    k1 = []
    for name, mlp, out, x, cd in chains:
        plan = model.plans[name]
        p = fm.params_from_tree(params[mlp], params[out])
        flat = flatten(p)
        dy = (2 * torch.rand(x.shape[0], plan.widths[-1], generator=g)
              - 1).cuda()
        bf16 = cd is not None
        with torch.no_grad():
            fwd_err = compare('K1-fwd %s (train)' % name,
                              fm.chain_kernel(plan, x, p, cd),
                              fm.chain_reference(plan, x, p, cd),
                              TOL_BF16 if bf16 else TOL_F32)
        fwd = None
        if bf16 and fm.fwd_on_tensor_cores(plan, cd, x.device):
            # The forward alone at the step's shapes (the tensor cores)
            fwd = tc_fwd_readings(
                lambda: fm.chain_kernel(plan, x, p, cd),
                lambda: fm.chain_kernel_cuda_core(plan, x, p, cd),
                lambda: fm.chain_kernel_cuda_core(plan, x, p, None),
                lambda: fm.chain_reference(plan, x, p, cd),
                chain_bound(plan, x.shape[0], 'bf16', 6, 1)['flop'],
                K1_FWD_KERNELS)
        # The step's flags: x is data, the weights train
        _, got = fm.chain_kernel_bwd(plan, x, dy, p, cd, needs_dx=False)
        leaves = [t.clone().requires_grad_() for t in flat]
        xg = x.clone().requires_grad_()
        y_p = fm.chain_reference(plan, xg, list(zip(leaves[0::2],
                                                    leaves[1::2])), cd)
        want = torch.autograd.grad(y_p, [xg] + leaves, dy, retain_graph=True)
        dw_tol = NORM_TOL_BF16 if bf16 else DW_TOL_F32
        dw_err = check_norm('K1-bwd dW/db ' + name, [
            rel_norm(a, b) for a, b in zip(flatten(got), want[1:])], dw_tol)
        # The input cotangent branch (K2-bwd's path; the step needs none)
        dx, _ = fm.chain_kernel_bwd(plan, x, dy, p, cd, needs_dw=False)
        row = {'chain': name, 'rows': x.shape[0],
               'dtype': 'bf16' if bf16 else 'f32',
               'fwd_max_abs_err': fwd_err, 'dw_rel_err': dw_err,
               'dw_tol': dw_tol}
        if fwd is not None:
            row['fwd'] = dict(fwd, rows=x.shape[0], dtype='bf16')
        if bf16:
            row['dx_rel_err'] = check_norm('K1-bwd dx ' + name,
                                           [rel_norm(dx, want[0])], dw_tol)
            # What a kernel that computed the f32 gradient would read
            dx32, got32 = fm.chain_kernel_bwd(plan, x, dy, p, None)
            row['f32_kernel_dw_rel_err'] = max(
                rel_norm(a, b) for a, b in zip(flatten(got32), want[1:]))
            row['f32_kernel_dx_rel_err'] = rel_norm(dx32, want[0])
            del dx32, got32
        else:
            row['dx_max_abs_err'] = compare('K1-bwd dx ' + name, dx, want[0],
                                            TOL_F32)
        if name == 'lvis':
            if row['dw_rel_err'] >= row['f32_kernel_dw_rel_err']:
                raise AssertionError(
                    "K1-bwd lvis: dW/db reads %.4g, not below the f32 "
                    "kernel's %.4g" % (row['dw_rel_err'],
                                       row['f32_kernel_dw_rel_err']))
            again = fm.chain_kernel_bwd(plan, x, dy, p, cd, needs_dx=False)[1]
            row['dw_bit_identical'] = all(
                torch.equal(a, b) for pa, pb in zip(got, again)
                for a, b in zip(pa, pb))
            if not row['dw_bit_identical']:
                raise AssertionError("K1-bwd lvis: dW differs between two "
                                     "launches on the same inputs")
        row['ms'], row['plain_ms'] = time_pair(
            lambda: fm.chain_kernel_bwd(plan, x, dy, p, cd, needs_dx=False),
            lambda: torch.autograd.grad(y_p, leaves, dy, retain_graph=True),
            iters=10)
        del y_p
        if fm.bwd_on_tensor_cores(plan, cd, False, True, x.device):
            # The tensor-core design's kernels, its scratch and its rate
            row.update(kernel_device_ms(lambda: fm.chain_kernel_bwd(
                plan, x, dy, p, cd, needs_dx=False), K1_BWD_KERNELS))
            size = fm.tc_bwd_sizes(fm.mma_plan(plan), x.shape[0], x.device)
            row.update(scratch_bytes=2 * size['scratch'],
                       dw_chunks=size['chunks'], phase1_blocks=size['slices'])
            bnd = chain_bound(plan, x.shape[0], 'bf16', 6, 1,
                              bwd=(False, True))
            row['tflops'] = bnd['flop'] / row['ms'] / 1e9

        def fwd_bwd(fn):
            ls = [t.detach().requires_grad_() for t in flat]
            y = fn(plan, x, list(zip(ls[0::2], ls[1::2])), compute_dtype=cd)
            return torch.autograd.grad(y, ls, dy)
        row['fwd_bwd_ms'], row['fwd_bwd_plain_ms'] = time_pair(
            lambda: fwd_bwd(lambda *a, **k: fm.apply_chain(*a, needs_dx=False,
                                                           **k)),
            lambda: fwd_bwd(fm.chain_reference), iters=10)
        k1.append(row)

    plan, cd = model.plans['brdf'], model.chain_dtype('brdf')
    p = fm.params_from_tree(params['brdf_mlp'], params['brdf_out'])
    dy = (2 * torch.rand(z.shape[0], 1, generator=g) - 1).cuda()
    off_wrap, keep = k2_rows(ldir, vdir)
    with torch.no_grad():
        fwd_err = compare('K2-fwd brdf (train)',
                          fr.rusink_kernel(plan, z, ldir, vdir, p, cd),
                          fr.reference(plan, z, ldir, vdir, p, cd),
                          TOL_BF16 if cd is not None else TOL_F32,
                          mask=off_wrap[:, None])
    k2 = {'chain': 'brdf', 'rows': z.shape[0],
          'dtype': 'bf16' if cd is not None else 'f32',
          'fwd_max_abs_err': fwd_err,
          'fwd_rows_at_phi_d_wrap': int((~off_wrap).sum()),
          'rows_left_out': int((~keep).sum())}
    tc = fr.rusink_on_tensor_cores(plan, cd, z.device)
    if tc:
        # The forward alone at the step's shapes (the tensor cores)
        k2['fwd'] = dict(k2_fwd_readings(plan, p, z, ldir, vdir,
                                         off_wrap[:, None]),
                         rows=z.shape[0], dtype='bf16')

    def plain(dtype):
        ins = [t.clone().requires_grad_() for t in (z, ldir, vdir)]
        return torch.autograd.grad(fr.reference(plan, *ins, p, dtype), ins,
                                   dy)
    # f32 is held to the exact math, the plain version in float64; the
    # plain version in f32 is read against it on the same rows
    ins = [t.double().requires_grad_() for t in (z, ldir, vdir)]
    y64, low = chain_f64(plan, torch.cat(
        (ins[0], geomops.dir2rusink(ins[1], ins[2])), dim=1), p)
    want64 = [w.float() for w in torch.autograd.grad(y64, ins, dy.double())]
    del y64, ins
    mask = (keep & (low > KINK_F32))[:, None]
    got32 = fr.rusink_kernel_bwd(plan, z, ldir, vdir, dy, p, None)
    k2['f32_rows_at_relu_kink'] = int((low <= KINK_F32).sum())
    k2['f32_max_abs_err'] = max(
        compare('K2-bwd f32 ' + n, a, b, TOL_F32, mask=mask.expand_as(b))
        for n, a, b in zip(('dz', 'dldir', 'dvdir'), got32, want64))
    k2['f32_plain_max_abs_err'] = max(
        (a - b).abs()[mask.expand_as(b)].max().item()
        for a, b in zip(plain(None), want64))
    del want64
    # bf16 against the plain version in bf16, per element and in norm
    want = plain(cd)
    got = fr.rusink_kernel_bwd(plan, z, ldir, vdir, dy, p, cd)
    k2['bf16_max_abs_err'] = max(
        compare('K2-bwd bf16 ' + n, a, b, TOL_BF16_GRAD,
                mask=keep[:, None].expand_as(b))
        for n, a, b in zip(('dz', 'dldir', 'dvdir'), got, want))
    k2['bf16_rel_err'] = check_norm('K2-bwd bf16', [
        rel_norm(a[keep], b[keep]) for a, b in zip(got, want)], NORM_TOL_BF16)
    k2['max_abs_err'] = k2['bf16_max_abs_err']
    # What the CUDA-core bf16 kernel and a kernel that computed the f32
    # gradient read
    core = fr.rusink_kernel_bwd_cuda_core(plan, z, ldir, vdir, dy, p, cd) \
        if tc else None
    k2.update(k2_bwd_limit_readings(got, core, got32, want, keep))
    if tc:
        k2['bwd_bit_identical'] = all(torch.equal(a, b) for a, b in zip(
            got, fr.rusink_kernel_bwd(plan, z, ldir, vdir, dy, p, cd)))
        if not k2['bwd_bit_identical']:
            raise AssertionError("K2-bwd: cotangents differ between two "
                                 "launches on the same inputs")
    del got, got32, want, core
    ins = [t.clone().requires_grad_() for t in (z, ldir, vdir)]
    y_p = fr.reference(plan, *ins, p, cd)
    k2['ms'], k2['plain_ms'] = time_pair(
        lambda: fr.rusink_kernel_bwd(plan, z, ldir, vdir, dy, p, cd),
        lambda: torch.autograd.grad(y_p, ins, dy, retain_graph=True),
        iters=10)
    del y_p
    if tc:
        # The CUDA-core kernel it replaces, its device time and its rate
        k2['cuda_core_ms'] = time_ms(lambda: fr.rusink_kernel_bwd_cuda_core(
            plan, z, ldir, vdir, dy, p, cd), iters=10)
        k2.update(kernel_device_ms(lambda: fr.rusink_kernel_bwd(
            plan, z, ldir, vdir, dy, p, cd), K2_BWD_KERNELS))
        k2['tflops'] = chain_bound(plan, z.shape[0], 'bf16', z.shape[1] + 6,
                                   1, bwd=(True, False))['flop'] \
            / k2['ms'] / 1e9

    def fwd_bwd(fn):
        args = [t.detach().requires_grad_() for t in (z, ldir, vdir)]
        return torch.autograd.grad(fn(plan, *args, p, compute_dtype=cd),
                                   args, dy)
    k2['fwd_bwd_ms'], k2['fwd_bwd_plain_ms'] = time_pair(
        lambda: fwd_bwd(fr.apply_rusink_chain),
        lambda: fwd_bwd(fr.reference), iters=10)
    return k1, k2


def k2_rows(ldir, vdir):
    """The BRDF chain's rows (N,) held against the plain version: off_wrap,
    the rows not within 1e-3 of phi_d's wrap (0 == pi), where the two
    sides disagree; keep, the rows of those the cotangents are held on,
    also away from |cos theta_d| or |cos theta_h| > 1 - 1e-4, where the
    safe-acos gradient is ~1e3 and ill-conditioned, and from sin theta <
    0.1 at either pole, where the VJP divides by sin(theta) (phi's
    cotangent by sin^2), which amplifies either version's rounding as
    much."""
    rusink = geomops.dir2rusink(ldir, vdir)
    off_wrap = (rusink[:, 0] > 1e-3) & (rusink[:, 0] < np.pi - 1e-3)
    keep = off_wrap & (torch.cos(rusink[:, 1]).abs() < 1 - 1e-4) \
        & (torch.cos(rusink[:, 2]).abs() < 1 - 1e-4) \
        & (torch.sin(rusink[:, 1]) > 0.1) & (torch.sin(rusink[:, 2]) > 0.1)
    return off_wrap, keep


def atol_needed(got, want, rtol, keep):
    """The least atol at which every cotangent of ``got`` holds against
    ``want`` (|got - want| <= atol + rtol |want|) on the rows ``keep``."""
    return max(((a - b).abs() - rtol * b.abs())[keep].max().item()
               for a, b in zip(got, want))


def k2_bwd_limit_readings(got, core, got32, want, keep):
    """What K2-bwd's bf16 limits rest on: the worst cotangent's relative
    norm (NORM_TOL_BF16) and the atol its worst element needs at
    TOL_BF16_GRAD's rtol, on the rows ``keep``, against the plain bf16
    version ``want``: of the kernel ``got``, of the CUDA-core bf16 kernel
    ``core`` (None when ``got`` is that kernel) and of the f32 kernel
    ``got32`` (the control); and the kernel against the CUDA-core one."""
    def worst(a, b):
        return max(rel_norm(u[keep], v[keep]) for u, v in zip(a, b))
    rtol = TOL_BF16_GRAD[1]
    out = {'bf16_rel_err': worst(got, want),
           'bf16_atol_needed': atol_needed(got, want, rtol, keep),
           'f32_kernel_rel_err': worst(got32, want),
           'f32_kernel_atol_needed': atol_needed(got32, want, rtol, keep)}
    if core is not None:
        out.update(cuda_core_rel_err=worst(core, want),
                   cuda_core_atol_needed=atol_needed(core, want, rtol, keep),
                   tc_vs_cuda_core_rel_err=worst(got, core))
    return out


def k2_limit_readings(model, seeds):
    """What K2's bf16 bounds rest on, at the joint step's shapes (524,288
    rows), over ``seeds`` (each seeding the BRDF chain's weights, drawn as
    the BRDF model initialises them, and the inputs): K2-fwd's output
    against the plain bf16 version on the rows off phi_d's wrap (the max
    error and the atol its worst element needs at TOL_BF16's rtol) of the
    kernel and of the f32 kernel (the control), and k2_bwd_limit_readings
    of K2-bwd."""
    plan, cd = model.plans['brdf'], model.chain_dtype('brdf')
    out = []
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        p = [(w.cuda(), b.cuda()) for w, b in fm.params_from_tree(
            model.specs['brdf_mlp'].init(g), model.specs['brdf_out'].init(g))]
        _, _, (z, ldir, vdir) = step_inputs(model, g)
        dy = (2 * torch.rand(z.shape[0], 1, generator=g) - 1).cuda()
        off_wrap, keep = k2_rows(ldir, vdir)
        r = {'seed': seed, 'rows': z.shape[0],
             'rows_left_out': int((~keep).sum())}
        with torch.no_grad():
            plain = fr.reference(plan, z, ldir, vdir, p, cd)
            for key, y in (('fwd', fr.rusink_kernel(plan, z, ldir, vdir, p,
                                                     cd)),
                           ('f32_kernel_fwd', fr.rusink_kernel(
                               plan, z, ldir, vdir, p, None))):
                r[key + '_max_abs_err'] = (y - plain)[off_wrap].abs().max() \
                    .item()
                r[key + '_atol_needed'] = atol_needed(
                    [y], [plain], TOL_BF16[1], off_wrap)
        ins = [t.clone().requires_grad_() for t in (z, ldir, vdir)]
        want = torch.autograd.grad(fr.reference(plan, *ins, p, cd), ins, dy)
        r.update(k2_bwd_limit_readings(
            fr.rusink_kernel_bwd(plan, z, ldir, vdir, dy, p, cd),
            fr.rusink_kernel_bwd_cuda_core(plan, z, ldir, vdir, dy, p, cd),
            fr.rusink_kernel_bwd(plan, z, ldir, vdir, dy, p, None), want,
            keep))
        out.append(r)
        del z, ldir, vdir, dy, want, ins
        torch.cuda.empty_cache()
    return out


# Each kernel's counter: its wrapper and the wrapper's attribute. K1, K1r,
# K1w, K2 and K3-fwd count every launch of their wrappers; "K1-fwd tc",
# "K1-bwd tc", "K1r-fwd tc", "K1r-bwd tc", "K1w-fwd tc", "K1w-bwd tc",
# "K2-fwd tc", "K2-bwd tc" and "K3-fwd tc" those of the bf16 tensor-core
# kernels among them (for K1-bwd and K1r-bwd without dx); "K1-fwd f32 tc"
# and "K1-bwd dx tc" those of K1's f32 tensor-core kernels (split TF32:
# the forward, and the backward with dx alone), "K1-bwd dW f32 tc" those
# of its f32 backward with dW alone (split TF32: phase 1 and the dW pass);
# the rest being the CUDA-core kernels'; "K1-bwd dW" the K1-bwd launches
# that computed dW/db; "K1 pack" the packing kernel's (the transposed
# hidden weights of every tensor-core chain launch, K1 and K2, on the card).
COUNTERS = {'K1-fwd': (fm.chain_kernel, 'launches'),
            'K1-fwd tc': (fm.chain_kernel, 'tc_launches'),
            'K1-fwd f32 tc': (fm.chain_kernel, 'f32_tc_launches'),
            'K1-bwd': (fm.chain_kernel_bwd, 'launches'),
            'K1-bwd tc': (fm.chain_kernel_bwd, 'tc_launches'),
            'K1-bwd dx tc': (fm.chain_kernel_bwd, 'dx_tc_launches'),
            'K1-bwd dW': (fm.chain_kernel_bwd, 'dw_launches'),
            'K1-bwd dW f32 tc': (fm.chain_kernel_bwd, 'dw_tc_f32_launches'),
            'K2-fwd': (fr.rusink_kernel, 'launches'),
            'K2-fwd tc': (fr.rusink_kernel, 'tc_launches'),
            'K2-bwd': (fr.rusink_kernel_bwd, 'launches'),
            'K2-bwd tc': (fr.rusink_kernel_bwd, 'tc_launches'),
            'K3-fwd': (fn.nerf_kernel, 'launches'),
            'K3-fwd tc': (fn.nerf_kernel, 'tc_launches'),
            'K3-bwd': (fn.nerf_kernel_bwd, 'launches'),
            'K1r-fwd': (fm.chain_kernel_stash, 'launches'),
            'K1r-fwd tc': (fm.chain_kernel_stash, 'tc_launches'),
            'K1r-bwd': (fm.chain_kernel_stash_bwd, 'launches'),
            'K1r-bwd tc': (fm.chain_kernel_stash_bwd, 'tc_launches'),
            'K1w-fwd': (fm.chain_kernel_last_skip, 'launches'),
            'K1w-fwd tc': (fm.chain_kernel_last_skip, 'tc_launches'),
            'K1w-bwd': (fm.chain_kernel_last_skip_bwd, 'launches'),
            'K1w-bwd tc': (fm.chain_kernel_last_skip_bwd, 'tc_launches'),
            'K1 pack': (fm.pack_transposed_kernel, 'launches'),
            'K3 pack': (fn.transposed_weights, 'launches'),
            'P': (dp.dot_chain_kernel, 'launches')}
JOINT_KERNELS = ('K1-fwd', 'K1-fwd tc', 'K1-bwd', 'K2-fwd', 'K2-fwd tc',
                 'K2-bwd', 'K2-bwd tc')


def zero_counters():
    for f, attr in COUNTERS.values():
        setattr(f, attr, 0)


def counts():
    return {k: getattr(f, attr) for k, (f, attr) in COUNTERS.items()}


def cuda_core_k1_bwd(launches):
    """K1-bwd's launches on the CUDA cores (chain_bwd_kernel): all of them
    but the bf16 design's and K1's f32 tensor-core ones."""
    return launches['K1-bwd'] - launches['K1-bwd tc'] \
        - launches['K1-bwd dx tc'] - launches['K1-bwd dW f32 tc']


def f32_training_kernels(launches, path):
    """The f32 heads' training backward runs the split-TF32 design with dW
    (K1-bwd dW f32 tc), and no K1-bwd on the CUDA cores: raises otherwise.
    Returns ``launches``."""
    if launches['K1-bwd dW f32 tc'] <= 0 or cuda_core_k1_bwd(launches):
        raise AssertionError("%s: the f32 heads' K1-bwd with dW off the "
                             "split-TF32 design: %s" % (path, launches))
    return launches


def read_counters(names, path):
    """Every kernel's launches since zero_counters; raises if one of
    ``names``, the kernels of ``path``, never launched."""
    launches = counts()
    for k in names:
        if launches[k] <= 0:
            raise AssertionError("%s never launched on the %s path"
                                 % (k, path))
    return launches


def train_scalars(outdir, steps=(2, 4)):
    """The train loss at each checkpoint; raises unless it is logged at
    epochs ``steps`` and finite."""
    recs = [json.loads(line) for line in open(
        join(outdir, 'summary_train', 'scalars.jsonl'))]
    losses = [r['loss_train'] for r in recs]
    if [r['step'] for r in recs] != list(steps) \
            or not np.all(np.isfinite(losses)):
        raise AssertionError("train scalars: %s" % recs)
    return losses


def run_training(joint_override):
    """The training path through trainvali.main on nerfactor.ini; checks
    what it writes. Returns (launches, outdir, losses)."""
    outroot = join(WORK, 'out', 'train')
    override = joint_override + ',' + ','.join([
        'outroot=' + outroot, 'epochs=4', 'ckpt_period=2', 'vali_period=4',
        'vali_batches=1'])
    zero_counters()
    run = trainvali.main(['--config', 'nerfactor.ini',
                          '--config_override', override])
    torch.cuda.synchronize()
    launches = f32_training_kernels(read_counters(
        JOINT_KERNELS + ('K1-fwd f32 tc', 'K1 pack'), 'training'),
        'training')
    outdir = run['outdir']
    losses = train_scalars(outdir)
    config = configutil.Config(configutil.read_config(outdir + '.ini'))
    init = Model(config, device='cpu').init_params(
        torch.Generator().manual_seed(0))
    for n in (2, 4):
        trained = ckptutil.restore_trained_params(
            join(outdir, 'checkpoints', 'ckpt-%d' % n), init)
        for k in init:
            same = all(torch.equal(a, b) for a, b in zip(
                ckptutil.tree_leaves(init[k]), ckptutil.tree_leaves(trained[k])))
            # The BRDF prior is frozen; everything else trains
            if same != (k in ('brdf_mlp', 'brdf_out', 'latent_code')):
                raise AssertionError("ckpt-%d: '%s' %s" % (
                    n, k, 'unchanged' if same else 'changed'))
    vali_dir = join(outdir, 'vis_vali', 'epoch000000004', 'batch000000000')
    meta = ioutil.read_json(join(vali_dir, 'metadata.json'))
    img = ioutil.load_img(join(vali_dir, 'pred_rgb.png'))
    if img.shape[:2] != (IMH, IMH) or not np.isfinite(meta['psnr']) \
            or not os.path.exists(join(vali_dir, 'pred-vs-gt_rgb.apng')):
        raise AssertionError("vali outputs: %s %s" % (img.shape, meta))
    ckpt = join(outdir, 'checkpoints', 'ckpt-4')
    rendered = test_cli.main(['--ckpt', ckpt, '--debug'])
    img = ioutil.load_img(join(rendered['outroot'], 'batch000000000',
                               'pred_rgb.png'))
    if img.shape[:2] != (IMH, IMH):
        raise AssertionError("render from ckpt-4: %s" % (img.shape,))
    loss_vali = json.loads(open(join(outdir, 'summary_vali',
                                     'scalars.jsonl')).readline())['loss_vali']
    if not np.isfinite(loss_vali):
        raise AssertionError("vali loss %r" % loss_vali)
    return launches, outdir, {'loss_train': losses, 'loss_vali': loss_vali,
                              'vali_psnr': meta['psnr']}


# Every profiler window's activities (card.profiler_window pads each)
PROFILER_ACTS = (torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA)


def time_train_step(model, dataset, warmup=3, iters=20, profiled=5,
                    kernels=()):
    """Steady-state ms per make_train_step step of ``model`` (on the card)
    on a batch of ``dataset``'s train views (the config's rays per step),
    and the CPU time the process spent a step (its host work, whatever
    the host's other load);
    then a torch.profiler window for the device's idle share and time by
    kernel (the 12 longest, and each of ``kernels``: (label, a regular
    expression its profiler names match))."""
    config = model.config
    params = model.init_params(torch.Generator().manual_seed(0))
    optimizer = build_optimizer(config)
    opt_state = optimizer.init(params)
    mask = model.trainable_mask(params) \
        if hasattr(model, 'trainable_mask') else None
    step = make_train_step(model, optimizer, mask)
    batch = next(iter(dataset.build_pipeline(prefetch=0)))
    arrays = {k: torch.as_tensor(np.asarray(batch[k])).cuda()
              for k in dataset.array_keys}
    gen = torch.Generator(device='cuda').manual_seed(0)
    for _ in range(warmup):
        params, opt_state, loss = step(params, opt_state, arrays, gen)
    torch.cuda.synchronize()
    before = counts()
    t0, cpu0 = time.perf_counter(), time.process_time()
    for _ in range(iters):
        params, opt_state, loss = step(params, opt_state, arrays, gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    cpu_ms = 1e3 * (time.process_time() - cpu0) / iters
    launches = {k: (v - before[k]) / iters for k, v in counts().items()
                if v != before[k]}
    if not torch.isfinite(loss):
        raise AssertionError("train step loss %r" % float(loss))
    with card.profiler_window(PROFILER_ACTS) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            params, opt_state, loss = step(params, opt_state, arrays, gen)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel = {}
    for e in card.device_events(prof):
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + getattr(
            e, 'self_device_time_total', 0.0)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    rays = dataset.bs
    of = {label: sum(v for k, v in by_kernel.items() if re.search(pat, k))
          / 1e3 / profiled for label, pat in kernels}
    return {'rays': rays, 'ms_per_step': ms,
            'host_cpu_ms_per_step': cpu_ms,
            'rays_per_sec': rays / (ms / 1e3), 'steps_timed': iters,
            'launches_per_step': launches,
            'profiled_steps': profiled,
            'device_busy_ms_per_step': busy_us / 1e3 / profiled,
            'device_idle_share': 1 - busy_us / wall_us if busy_us else None,
            'device_ms_per_step_by_kernel': {
                k[:80]: v / 1e3 / profiled for k, v in top},
            **({'device_ms_per_step_of': of} if kernels else {})}


# ------ the f32 heads' training pair in split TF32 ------

# The pipeline's heads (tools/quality_e2e.py: the shipped INIs at
# mlp_width 64, 512 rays a step, the jitter twins: 1,024 rows)
PIPELINE_HEAD_PLAN = fm.make_plan([(3, 10)], (64,) * 4 + (3,),
                                  ('relu',) * 4 + (None,), (2,))
PIPELINE_HEAD_ROWS = 1024
# The split-TF32 forward's readings of each head in the kernels line
HEAD_FWD_KEYS = ('chain', 'rows', 'fwd_max_abs_err', 'fwd_control_beyond',
                 'fwd_control_max_abs_err', 'fwd_ms', 'fwd_plain_ms',
                 'fwd_device_ms', 'fwd_pack_device_ms', 'fwd_cuda_core_ms',
                 'fwd_cuda_core_device_ms', 'fwd_bound', 'fwd_f32_bound_ms',
                 'fwd_f64_rel_err')
# The f32 design's kernels in a profiler window: phase 1 and the dW pass
F32_DW_KERNELS = (('phase1_device_ms', 'chain_bwd_f32_tc_kernel'),
                  ('dw_pass_device_ms', 'dw_f32_kernel'))


def seeded_head_params(plan, seed):
    """Glorot-uniform weights and small biases for ``plan`` from a seed, on
    the card."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for din, w in zip(fm.layer_in_dims(plan), plan.widths):
        lim = (6.0 / (din + w)) ** 0.5
        out.append(((2 * torch.rand(din, w, generator=g) - 1) * lim,
                    0.05 * torch.randn(w, generator=g)))
    return [(w.cuda(), b.cuda()) for w, b in out]


def device_ms_of(run, names, iters=5):
    """Device ms per call of ``run`` of the kernels whose profiler names
    hold one of ``names``, and the launches a call of them and of every
    kernel (a profiler window over ``iters`` calls)."""
    us, seen = profiled_device_us(run, iters)
    keys = [k for k in us if any(n in k for n in names)]
    return {'device_ms': sum(us[k] for k in keys) / 1e3 / iters,
            'launches_per_call': sum(seen[k] for k in keys) / iters,
            'all_launches_per_call': sum(seen.values()) / iters}


def f32_head_readings(name, plan, p, x, dy, iters=10):
    """K1's f32 training pair on one f32 head at a training step's rows, as
    the rule runs it: the split-TF32 forward
    (chain_fwd_f32_tc_kernel) within TOL_F32 of the plain f32 version
    (TF32 off) and the backward with dW alone (chain_bwd_f32_tc_kernel +
    dw_f32_kernel) within DW_TOL_F32 by relative norm of its autograd, dW
    bit-identical across two launches; beside each limit the plain-TF32
    control's reading (``terms`` 1) and the CUDA-core kernel's, and the
    limits the control breaks (raises if none); the forward's output and
    dW/db of the design, the CUDA-core kernels and the plain f32 version
    from the float64 chain's (chain_f64), by relative norm; ms (CUDA
    events, the wrapper's packing included, in turns with the plain
    version), device ms, launches a call and the bounds (f32 and split
    TF32), the CUDA-core kernels' ms and device ms in the same run; phase
    1's blocks, the dW pass's chunks and the scratch."""
    rows, no = x.shape[0], plan.widths[-1]
    out = {'chain': name, 'rows': rows, 'dtype': 'f32'}
    leaves64 = [t.double().requires_grad_() for t in flatten(p)]
    y64 = chain_f64(plan, x.double(), pairs(leaves64))[0]
    want64 = torch.autograd.grad(y64, leaves64, dy.double())
    with torch.no_grad():
        want_y = fm.chain_reference(plan, x, p)
        got_y = fm.chain_kernel_f32_tc(plan, x, p)
        core_y = fm.chain_kernel_cuda_core(plan, x, p)
        out['fwd_max_abs_err'] = compare('K1-fwd f32 split TF32 ' + name,
                                         got_y, want_y, TOL_F32)
        out['fwd_control_beyond'], out['fwd_control_max_abs_err'] = beyond(
            fm.chain_kernel_f32_tc(plan, x, p, 1), want_y, TOL_F32)
        out['fwd_cuda_core_max_abs_err'] = (
            core_y - want_y).abs().max().item()
        out['fwd_f64_rel_err'] = {k: rel_norm(v.double(), y64) for k, v in (
            ('split_tf32', got_y), ('cuda_core', core_y),
            ('plain_f32', want_y))}
    leaves = [t.clone().requires_grad_() for t in flatten(p)]
    y_p = fm.chain_reference(plan, x, pairs(leaves))
    want = torch.autograd.grad(y_p, leaves, dy, retain_graph=True)

    def dw_err(grads, ref=want):
        return max(rel_norm(a.to(b.dtype), b)
                   for a, b in zip(flatten(grads), ref))
    got = fm.chain_kernel_bwd_dw_f32_tc(plan, x, dy, p)
    core = fm.chain_kernel_bwd_cuda_core(plan, x, dy, p, None,
                                         needs_dx=False)[1]
    out['dw_rel_err'] = check_norm('K1-bwd f32 dW ' + name,
                                   [dw_err(got)], DW_TOL_F32)
    out['dw_max_abs_err'] = max((a - b).abs().max().item()
                                for a, b in zip(flatten(got), want))
    out['dw_tol'] = DW_TOL_F32
    out['dw_control_rel_err'] = dw_err(
        fm.chain_kernel_bwd_dw_f32_tc(plan, x, dy, p, 1))
    out['dw_cuda_core_rel_err'] = dw_err(core)
    out['dw_f64_rel_err'] = {
        'split_tf32': dw_err(got, want64), 'cuda_core': dw_err(core, want64),
        'plain_f32': max(rel_norm(a.double(), b)
                         for a, b in zip(want, want64))}
    del y64, want64, leaves64, core
    # The limits that part the control from the kernel: at least one must
    out['control_broken_by'] = [k for k, broken in (
        ('fwd', out['fwd_control_beyond'] > 0),
        ('dw', out['dw_control_rel_err'] > DW_TOL_F32)) if broken]
    if not out['control_broken_by']:
        raise AssertionError("K1 f32 %s: the plain-TF32 control is within "
                             "the forward's and dW's limits" % name)
    again = fm.chain_kernel_bwd_dw_f32_tc(plan, x, dy, p)
    out['dw_bit_identical'] = all(torch.equal(a, b) for a, b in zip(
        flatten(got), flatten(again)))
    if not out['dw_bit_identical']:
        raise AssertionError("K1-bwd f32 dW %s: dW differs between two "
                             "launches on the same inputs" % name)
    del got, again
    run_b = lambda: fm.chain_kernel_bwd_dw_f32_tc(plan, x, dy, p)  # noqa
    run_bc = lambda: fm.chain_kernel_bwd_cuda_core(  # noqa: E731
        plan, x, dy, p, None, needs_dx=False)
    out['bwd_ms'], out['bwd_plain_ms'] = time_pair(
        run_b, lambda: torch.autograd.grad(y_p, leaves, dy,
                                           retain_graph=True), iters=iters)
    out['bwd_cuda_core_ms'] = time_ms(run_bc, iters)
    out.update(kernel_device_ms(run_b, F32_DW_KERNELS, rest='rest_device_ms'))
    out['bwd_device_ms'] = out['phase1_device_ms'] + out['dw_pass_device_ms']
    out['bwd_launches'] = device_ms_of(
        run_b, ('chain_bwd_f32_tc', 'dw_f32'))['launches_per_call']
    core = device_ms_of(run_bc, ('chain_bwd_kernel', 'sum_slices'))
    out['bwd_cuda_core_device_ms'] = core['device_ms']
    out['bwd_cuda_core_launches'] = core['launches_per_call']
    del y_p
    run_f = lambda: fm.chain_kernel_f32_tc(plan, x, p)  # noqa: E731
    run_fc = lambda: fm.chain_kernel_cuda_core(plan, x, p)  # noqa: E731
    with torch.no_grad():
        out['fwd_ms'], out['fwd_plain_ms'] = time_pair(
            run_f, lambda: fm.chain_reference(plan, x, p), iters=iters)
        out['fwd_cuda_core_ms'] = time_ms(run_fc, iters)
        fwd = device_ms_of(run_f, ('chain_fwd_f32_tc',))
        out['fwd_device_ms'] = fwd['device_ms']
        out['fwd_pack_device_ms'] = device_ms_of(
            run_f, ('pack_transposed',))['device_ms']
        out['fwd_cuda_core_device_ms'] = device_ms_of(
            run_fc, ('chain_fwd_kernel',))['device_ms']
    kplan = fm.mma_plan(plan)
    size = fm.tc_bwd_f32_sizes(kplan, rows, x.device)
    out.update(phase1_blocks=size['slices'], dw_chunks=size['chunks'],
               scratch_bytes=4 * size['scratch'])
    fb = chain_bound(plan, rows, 'f32', fm.raw_dim(plan), no)
    bb = chain_bound(plan, rows, 'f32', fm.raw_dim(plan), no,
                     bwd=(False, True))
    out.update(fwd_bound=tf32x3_bound(fb), fwd_f32_bound_ms=fb['bound_ms'],
               bwd_bound=tf32x3_bound(bb), bwd_f32_bound_ms=bb['bound_ms'])
    return out


def pack_readings(plan, p, iters=20):
    """nfk_pack_transposed (one launch) against its plain version
    pack_transposed on the packed weights of ``plan``'s f32 and bf16
    kernels: the same bits, and each one's ms (CUDA events, host and
    device, in turns) and the kernel's device ms."""
    kplan = fm.mma_plan(plan)
    kp = fm.pad_params(plan, p) if kplan != plan else p
    tab, _ = fm.chain_dw_table(kplan, p[0][0].device)
    out = {}
    for dtype, name, bits in ((torch.float32, 'f32', torch.int32),
                              (torch.bfloat16, 'bf16', torch.int16)):
        w_flat, _ = fm.pack_params(kplan, kp, dtype)
        ws = fm.hidden_weights(kplan, w_flat)
        run_k = lambda: fm.pack_transposed_kernel(kplan, w_flat)  # noqa
        run_p = lambda: fm.pack_transposed(ws, tab, dtype)  # noqa: E731
        same = torch.equal(run_k().view(bits), run_p().view(bits))
        if not same:
            raise AssertionError("nfk_pack_transposed %s: not "
                                 "pack_transposed's bits" % name)
        ms, plain_ms = time_pair(run_k, run_p, iters=iters)
        out[name] = {'same_bits': same, 'ms': ms, 'plain_ms': plain_ms,
                     'device_ms': device_ms_of(
                         run_k, ('pack_transposed',))['device_ms'],
                     'values': run_k().numel()}
    return out


def k3_pack_readings(nplan, params, iters=20):
    """nfk_pack_transposed_table (one launch: K3's transposed dense
    weights, fused_nerf.transposed_weights) against its plain version
    (transposed_weights_plain) on the bf16 packed weights of the field
    ``params`` of ``nplan``: the same bits, each one's ms (CUDA events,
    host and device, in turns) and the kernel's device ms."""
    kplan, kp = fn._mma_params(nplan, params)
    dense, _ = fn.pack_params(kplan, kp, torch.bfloat16)
    run_k = lambda: fn.transposed_weights(kplan, dense)  # noqa: E731
    run_p = lambda: fn.transposed_weights_plain(  # noqa: E731
        kplan, kp, dense.device)
    same = torch.equal(run_k().view(torch.int16), run_p().view(torch.int16))
    if not same:
        raise AssertionError("nfk_pack_transposed_table: not "
                             "transposed_weights_plain's bits")
    ms, plain_ms = time_pair(run_k, run_p, iters=iters)
    return {'same_bits': same, 'ms': ms, 'plain_ms': plain_ms,
            'device_ms': device_ms_of(run_k, ('pack_transposed',))[
                'device_ms'], 'values': run_k().numel()}


def f32_heads(cases, g):
    """f32_head_readings of each (name, plan, params, rows) of ``cases``
    on seeded inputs (points on the sphere and their jitter twins' spread,
    a uniform cotangent)."""
    out = []
    for name, plan, p, rows in cases:
        pts = torch.randn(rows, 3, generator=g)
        x = (SPHERE_R * pts / pts.norm(dim=1, keepdim=True)).cuda()
        dy = (2 * torch.rand(rows, plan.widths[-1], generator=g) - 1).cuda()
        out.append(f32_head_readings(name, plan, p, x, dy))
        torch.cuda.empty_cache()
    return out


def model_head_cases(model, params, names, rows=2 * N_RAYS):
    """f32_heads' cases of a model's f32 heads (each chain's plan and its
    params) at a training step's rows."""
    keys = {'normal': ('normal_mlp', 'normal_out'),
            'albedo': ('albedo_mlp', 'albedo_out'),
            'brdf_z': ('brdf_z_mlp', 'brdf_z_out')}
    return [(n, model.plans[n], fm.params_from_tree(params[keys[n][0]],
                                                   params[keys[n][1]]), rows)
            for n in names]


def joint_f32_heads(model, params):
    """Phase 6's f32 heads: the joint model's three at a training step's
    2,048 rows and the pipeline's 64-wide plan (seeded weights) at its
    1,024 (f32_heads), and the packing kernel on the normal head's weights
    (pack_readings)."""
    cases = model_head_cases(model, params, ('normal', 'albedo', 'brdf_z'))
    cases.append(('pipeline_64', PIPELINE_HEAD_PLAN,
                  seeded_head_params(PIPELINE_HEAD_PLAN, 3),
                  PIPELINE_HEAD_ROWS))
    return {'heads': f32_heads(cases, torch.Generator().manual_seed(19)),
            'pack': pack_readings(cases[0][1], cases[0][2])}


def run_config(ini, override):
    """A run's config from a shipped INI and an override, as trainvali
    builds it."""
    parser = configutil.read_config(configutil.resolve_config_path(ini))
    configutil.apply_override(parser, override)
    return configutil.Config(parser)


def steps_alone(config, joint_override, data_root, nerf_root, repeats):
    """--steps: the steady-state joint (nerfactor.ini), shape (shape.ini) and
    microfacet (nerfactor_microfacet.ini) train steps at the smoke's
    shapes from seeded weights (time_train_step: ms, device busy ms, idle
    share, launches a step), each ``repeats`` times in turns. It builds
    the configs as trainvali does and calls only the models."""
    shape = run_config('shape.ini', ','.join([
        'data_root=' + data_root, 'data_nerf_root=' + nerf_root,
        'imh=%d' % IMH, 'light_h=%d' % LIGHT_H]))
    micro = run_config('nerfactor_microfacet.ini', joint_override)
    runs = (('joint', Model, config), ('shape', ShapeModel, shape),
            ('microfacet', MicrofacetModel, micro))
    zero_counters()
    out = []
    for i in range(repeats):
        for name, cls, cfg in runs:
            step = time_train_step(cls(cfg, device='cuda'),
                                   Dataset(cfg, 'train'))
            out.append({'step': name, 'repeat': i, **{
                k: step[k] for k in ('ms_per_step', 'host_cpu_ms_per_step',
                                     'device_busy_ms_per_step',
                                     'device_idle_share',
                                     'launches_per_step')}})
            torch.cuda.empty_cache()
    return out


def f32_heads_alone(config, ckpt):
    """--f32_heads: joint_f32_heads on the smoke's seeded joint checkpoint,
    f32 K1-fwd by rows (f32_fwd_by_rows) on its normal head and f32 K1-bwd
    with dW by rows on its lvis chain (f32_dw_by_rows)."""
    model = Model(config, device='cuda')
    params = ckptutil.restore_trained_params(
        ckpt, model.init_params(torch.Generator()), device='cuda')
    out = joint_f32_heads(model, params)
    normal = model_head_cases(model, params, ('normal',))[0]
    out['by_rows'] = f32_fwd_by_rows(normal[1], normal[2])
    out['dw_by_rows'] = f32_dw_by_rows(params, step_inputs(
        model, torch.Generator().manual_seed(6))[1])
    out['ptxas'] = ptxas_report(('chain_bwd_f32_tc', 'dw_f32',
                                 'pack_transposed', 'chain_fwd_f32_tc'))
    out['sass_hmma'] = sass_hmma(('chain_bwd_f32_tc_kernel', 'dw_f32_kernel'))
    return out


# ------ the stages whose checkpoints the joint model restores ------

# The shape step's kernels: the bf16 lvis chain on the tensor cores (K1-fwd
# tc; K1-bwd tc, dW only), the f32 normal chain in split TF32 on the tensor
# cores (K1-fwd f32 tc; K1-bwd dW f32 tc, dW only)
SHAPE_KERNELS = ('K1-fwd', 'K1-fwd tc', 'K1-bwd', 'K1-bwd tc')
# Device ms a step by kernel, matched by name in the profiler's keys: the
# f32 kernels there are the normal chain's; the CUDA-core ones, which ran
# it before the split-TF32 design, launch no more and read 0
SHAPE_STEP_KERNELS = (
    ('K1-fwd chain_fwd_tc_kernel', r'(?<![a-z_])chain_fwd_tc_kernel'),
    ('K1-bwd chain_bwd_tc_kernel', r'(?<![a-z_])chain_bwd_tc_kernel'),
    ('K1-bwd dw_kernel', r'(?<![a-z_])dw_kernel'),
    ('K1 sum_slices_kernel', r'(?<![a-z_])sum_slices_kernel'),
    ('K1-fwd chain_fwd_f32_tc_kernel (f32 normal)',
     r'(?<![a-z_])chain_fwd_f32_tc_kernel'),
    ('K1-bwd chain_bwd_f32_tc_kernel + dw_f32_kernel (f32 normal)',
     r'(?<![a-z_])(chain_bwd_f32_tc_kernel|dw_f32_kernel)'),
    ('K1 pack_transposed_kernel', r'(?<![a-z_])pack_transposed_kernel'),
    ('K1-fwd chain_fwd_kernel (CUDA cores)', r'(?<![a-z_])chain_fwd_kernel'),
    ('K1-bwd chain_bwd_kernel (CUDA cores)', r'(?<![a-z_])chain_bwd_kernel'))
# The BRDF prior's synthetic MERL tables: materials, rows a table, and the
# test table's sphere render (ims 64, the one cut: the MERL converter's
# default is 128) under the 16 x 32 'point' light
MERL_MATERIALS = ('alum-bronze', 'pearl-paint', 'red-plastic')
MERL_ROWS, MERL_IMS, MERL_ENVMAP_H = 65536, 64, 16


def changed_leaves(init, ckpt):
    """{key: whether every leaf under it differs} of a checkpoint's params
    against ``init``."""
    trained = ckptutil.restore_trained_params(ckpt, init)
    return {k: all(not torch.equal(a, b) for a, b in zip(
        ckptutil.tree_leaves(init[k]), ckptutil.tree_leaves(trained[k])))
        for k in init}


def run_shape_training(data_root, nerf_root, imh=IMH, outname='shape_train'):
    """The shape stage through trainvali.main on shape.ini at full width
    (128 x 4, 1024 rays, 512 lights, bf16 lvis chain, fused kernels) on
    the smoke's scene at ``imh`` and the buffers under ``nerf_root``;
    checks its losses, that every shape leaf of ckpt-2 and ckpt-4 moved,
    and the vali images, flipbooks and HTML. Returns (launches, outdir,
    record)."""
    override = ','.join([
        'data_root=' + data_root, 'data_nerf_root=' + nerf_root,
        'outroot=' + join(WORK, 'out', outname), 'imh=%d' % imh,
        'light_h=%d' % LIGHT_H, 'epochs=4', 'ckpt_period=2',
        'vali_period=4', 'vali_batches=1'])
    zero_counters()
    outdir = trainvali.main(['--config', 'shape.ini',
                             '--config_override', override])['outdir']
    torch.cuda.synchronize()
    launches = f32_training_kernels(read_counters(
        SHAPE_KERNELS + ('K1-fwd f32 tc', 'K1 pack'), 'shape training'),
        'shape training')
    losses = train_scalars(outdir)
    config = configutil.Config(configutil.read_config(outdir + '.ini'))
    init = ShapeModel(config, device='cpu').init_params(
        torch.Generator().manual_seed(0))
    for n in (2, 4):
        moved = changed_leaves(init, join(outdir, 'checkpoints',
                                          'ckpt-%d' % n))
        if not all(moved.values()):
            raise AssertionError("shape ckpt-%d: leaves that did not move "
                                 "under %s" % (n, moved))
    vali_dir = join(outdir, 'vis_vali', 'epoch000000004')
    for f in ('pred_normal', 'pred_lvis'):
        img = ioutil.load_img(join(vali_dir, 'batch000000000', f + '.png'))
        if img.shape[:2] != (imh, imh):
            raise AssertionError("shape vali %s.png: %s" % (f, img.shape))
    for f in ('batch000000000/pred-vs-gt_normal.apng',
              'batch000000000/pred-vs-gt_lvis.apng', 'all.html'):
        if not os.path.exists(join(vali_dir, f)):
            raise AssertionError("shape vali: no %s" % f)
    loss_vali = json.loads(open(join(outdir, 'summary_vali',
                                     'scalars.jsonl')).readline())['loss_vali']
    if not np.isfinite(loss_vali):
        raise AssertionError("shape vali loss %r" % loss_vali)
    return launches, outdir, {'loss_train': losses, 'loss_vali': loss_vali}


def shape_step_loss_grads(config, device, params, arrays, noise,
                          cls=ShapeModel):
    """One step's loss and every gradient leaf of model class ``cls`` (the
    shape model unless named) on ``device``: [(key, gradient)] in flatten
    order."""
    model = cls(config, device=device)
    live = ckptutil.tree_map(
        lambda t: t.detach().to(device).requires_grad_(), params)
    pred, gt, kwargs, _ = model.apply(
        live, upcast_batch({k: v.to(device) for k, v in arrays.items()}),
        mode='train', jitter_noise=noise.to(device))
    loss = torch.mean(model.compute_loss(live, pred, gt, **kwargs))
    keys = [k for k in sorted(live) for _ in ckptutil.tree_leaves(live[k])]
    grads = torch.autograd.grad(loss, ckptutil.tree_leaves(live))
    return loss.item(), [(k, g.cpu()) for k, g in zip(keys, grads)]


def check_shape_step(config):
    """One shape step's loss and every gradient leaf on the card (K1's
    kernels) against the port's plain version on the CPU, from one batch
    and one jitter draw: the lvis chain's bf16 cotangents within
    NORM_TOL_BF16 by relative norm, the f32 normal chain's within
    DW_TOL_F32, the loss within TOL_BF16."""
    params = ShapeModel(config, device='cpu').init_params(
        torch.Generator().manual_seed(0))
    batch = next(iter(Dataset(config, 'train').build_pipeline(prefetch=0)))
    arrays = {k: torch.as_tensor(np.asarray(batch[k]))
              for k in Dataset.array_keys}
    noise = config.getfloat('xyz_jitter_std') * torch.randn(
        (N_RAYS, 3), generator=torch.Generator().manual_seed(1))
    loss_k, grads_k = shape_step_loss_grads(config, 'cuda', params, arrays,
                                            noise)
    loss_p, grads_p = shape_step_loss_grads(config, 'cpu', params, arrays,
                                            noise)
    errs = {'lvis': [], 'normal': []}
    for (k, got), (_, want) in zip(grads_k, grads_p):
        errs[k.split('_')[0]].append(rel_norm(got, want))
    return {
        'rows_lvis': 2 * N_RAYS * N_LIGHTS, 'rows_normal': 2 * N_RAYS,
        'loss_card': loss_k, 'loss_plain_cpu': loss_p,
        'loss_abs_err': compare('shape step loss', torch.tensor([loss_k]),
                                torch.tensor([loss_p]), TOL_BF16),
        'lvis_grad_rel_err': check_norm('shape step lvis gradients',
                                        errs['lvis'], NORM_TOL_BF16),
        'normal_grad_rel_err': check_norm('shape step normal gradients',
                                          errs['normal'], DW_TOL_F32),
        'grad_leaves': len(grads_k),
        'tol': {'lvis': NORM_TOL_BF16, 'normal': DW_TOL_F32,
                'loss': TOL_BF16}}


def write_merl_tables(root):
    """Synthetic MERL-format tables (the format of
    data_gen_tpu/merl_make_dataset.py): train_/vali_<material>.npz of
    MERL_ROWS random Rusinkiewicz rows each, a material's reflectance a
    smooth function of theta_h, and the shared test.npz in the reference's
    layout, the characteristic slice's rows then the sphere render's."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    common = {'envmap_h': MERL_ENVMAP_H, 'ims': MERL_IMS, 'spp': 1}
    for i, name in enumerate(MERL_MATERIALS):
        rusink = (rng.rand(MERL_ROWS, 3) * [np.pi, np.pi / 2, np.pi / 2]
                  ).astype(np.float32)
        refl = (0.05 + (i + 1) * np.exp(-8 * rusink[:, 1:2] ** 2)).astype(
            np.float32)
        n_vali = MERL_ROWS // 100
        for mode, rows in (('train', slice(n_vali, None)),
                           ('vali', slice(0, n_vali))):
            np.savez(join(root, '%s_%s.npz' % (mode, name)), i=i, name=name,
                     rusink=rusink[rows], refl=refl[rows], **common)
    ren = SphereRenderer('point', None, envmap_h=MERL_ENVMAP_H,
                         envmap_inten=40, ims=MERL_IMS)
    render = merl.dir2rusink(ren.ldir, ren.vdir)[ren.lvis.astype(bool)]
    np.savez(join(root, 'test.npz'), rusink=np.vstack((
        merl.characteristic_slice_rusink().reshape(-1, 3),
        render)).astype(np.float32), **common)
    return root


def run_brdf_training(tables):
    """The BRDF prior through trainvali.main on brdf.ini at full width
    (128 x 4, z_dim 3, n_freqs 2, 1024 rows and their reciprocity twins a
    step); checks its losses, that every leaf of ckpt-2 and ckpt-4 moved,
    and the vali charts. Its MLP is plain PyTorch, as the JAX package's
    runs on XLA: no kernel launches. Returns (launches, outdir,
    record)."""
    override = ','.join([
        'data_root=' + tables, 'outroot=' + join(WORK, 'out', 'merl_train'),
        'epochs=4', 'ckpt_period=2', 'vali_period=4', 'vali_batches=1'])
    zero_counters()
    outdir = trainvali.main(['--config', 'brdf.ini',
                             '--config_override', override])['outdir']
    torch.cuda.synchronize()
    launches = counts()
    if any(launches.values()):
        raise AssertionError("kernels launched on the BRDF path: %s"
                             % launches)
    losses = train_scalars(outdir)
    config = configutil.Config(configutil.read_config(outdir + '.ini'))
    init = BrdfModel(config, device='cpu').init_params(
        torch.Generator().manual_seed(0))
    for n in (2, 4):
        moved = changed_leaves(init, join(outdir, 'checkpoints',
                                          'ckpt-%d' % n))
        if not all(moved.values()):
            raise AssertionError("BRDF ckpt-%d: leaves that did not move "
                                 "under %s" % (n, moved))
    vali_dir = join(outdir, 'vis_vali', 'epoch000000004')
    for f in ('all.html', 'batch000000000/z.png',
              'batch000000000/log10_brdf.png'):
        if not os.path.exists(join(vali_dir, f)):
            raise AssertionError("BRDF vali: no %s" % f)
    return launches, outdir, {'loss_train': losses}


def run_brdf_explore(ckpt):
    """explore_brdf_space.main on a BRDF checkpoint: every test identity
    (the seen materials, then N_BETWEEN steps between each consecutive
    pair of a seeded choice) gets its charts, metadata, slice and sphere render; the
    HTML and the interpolation video (an APNG without an mp4 backend).
    Returns (launches, record)."""
    zero_counters()
    t0 = time.perf_counter()
    run = explore_brdf_space.main(['--ckpt', ckpt])
    seconds = time.perf_counter() - t0
    launches = counts()
    dirs = ioutil.sortglob(run['outroot'], 'batch?????????')
    n_iden = len(MERL_MATERIALS) + N_BETWEEN * (len(MERL_MATERIALS) - 1)
    if len(dirs) != n_iden:
        raise AssertionError("explore: %d identities, expected %d"
                             % (len(dirs), n_iden))
    for d in dirs:
        for f in ('z.png', 'log10_brdf.png', 'metadata.json', 'cslice.png',
                  'render.png'):
            if not os.path.exists(join(d, f)):
                raise AssertionError("explore: no %s in %s" % (f, d))
    render = ioutil.load_img(join(dirs[-1], 'render.png'))
    if render.shape[:2] != (MERL_IMS, MERL_IMS) \
            or not np.isfinite(render).all():
        raise AssertionError("explore render: %s" % (render.shape,))
    video = [p for p in (run['outroot'] + '.apng', run['outroot'] + '.mp4')
             if os.path.exists(p)]
    if not os.path.exists(run['outroot'] + '.html') or not video:
        raise AssertionError("explore: no HTML or video: %s" % video)
    ids = [ioutil.read_json(join(d, 'metadata.json'))['id'] for d in dirs]
    return launches, {'identities': n_iden, 'seconds': seconds,
                      'video': os.path.basename(video[0]),
                      'seen': ids[:len(MERL_MATERIALS)],
                      'first_interpolated': ids[len(MERL_MATERIALS)]}


def run_joint_from_port_stages(data_root, nerf_root, probe_dir, shape_dir,
                               brdf_dir, material):
    """trainvali.main on nerfactor.ini for 2 epochs restoring the shape and
    BRDF checkpoints the two phases above wrote (shape_mode finetune),
    then test.main with --tgt_brdf ``material`` on the joint ckpt-2.
    Checks that the joint model restored the port-written leaves bit for
    bit, the render's size, and that the edit's code is the BRDF
    checkpoint's row for the material. Returns (launches, record)."""
    shape_ckpt = join(shape_dir, 'checkpoints', 'ckpt-4')
    brdf_ckpt = join(brdf_dir, 'checkpoints', 'ckpt-4')
    override = ','.join([
        'data_root=' + data_root, 'data_nerf_root=' + nerf_root,
        'brdf_model_ckpt=' + brdf_ckpt, 'shape_model_ckpt=' + shape_ckpt,
        'test_envmap_dir=' + probe_dir, 'imh=%d' % IMH,
        'light_h=%d' % LIGHT_H, 'outroot=' + join(WORK, 'out', 'joint_port'),
        'epochs=2', 'ckpt_period=2', 'vali_period=2', 'vali_batches=1'])
    zero_counters()
    outdir = trainvali.main(['--config', 'nerfactor.ini',
                             '--config_override', override])['outdir']
    torch.cuda.synchronize()
    launches = read_counters(JOINT_KERNELS, 'joint training from the '
                             "port's stage checkpoints")
    config = configutil.Config(configutil.read_config(outdir + '.ini'))
    if config.get('shape_mode') != 'finetune':
        raise AssertionError("shape_mode %s" % config.get('shape_mode'))
    joint = Model(config, device='cpu')
    restored = joint.init_params(torch.Generator())
    written = {}
    for name, ckpt, cls, keys in (
            ('shape', shape_ckpt, ShapeModel, SHAPE_PARAM_KEYS),
            ('brdf', brdf_ckpt, BrdfModel, BRDF_PARAM_KEYS)):
        sub = configutil.Config(configutil.read_config(
            configutil.get_config_ini(ckpt)))
        written[name] = ckptutil.restore_trained_params(ckpt, cls(
            sub, device='cpu').init_params(torch.Generator()))
        for k in keys:
            if not all(torch.equal(a, b) for a, b in zip(
                    ckptutil.tree_leaves(restored[k]),
                    ckptutil.tree_leaves(written[name][k]))):
                raise AssertionError("joint model: '%s' is not the leaves "
                                     "of %s" % (k, ckpt))
    losses = [json.loads(line)['loss_train'] for line in open(
        join(outdir, 'summary_train', 'scalars.jsonl'))]
    if not np.all(np.isfinite(losses)):
        raise AssertionError("joint from the port's stages: losses %s"
                             % losses)
    ind = BrdfModel(joint.config_brdf, device='cpu').brdf_names.index(
        material)
    rendered = test_cli.main(['--ckpt', join(outdir, 'checkpoints', 'ckpt-2'),
                              '--tgt_brdf', material, '--debug'])
    want_z = written['brdf']['latent_code'][ind].numpy()
    if not np.array_equal(rendered['brdf_z_override'], want_z):
        raise AssertionError("--tgt_brdf code %s, the BRDF checkpoint's row "
                             "%s" % (rendered['brdf_z_override'], want_z))
    img = ioutil.load_img(join(rendered['outroot'], 'batch000000000',
                               'pred_rgb.png'))
    if img.shape[:2] != (IMH, IMH) or not np.isfinite(img).all():
        raise AssertionError("--tgt_brdf render: %s" % (img.shape,))
    return launches, {'loss_train': losses, 'tgt_brdf': material,
                      'brdf_z': want_z.tolist()}


# ------ the NeRF slice ------

NERF_RAYS, NERF_COARSE, NERF_FINE = 1024, 64, 128  # nerf.ini
# bf16 K3 against the plain version (the plain version keeps its heads in
# f32 where the kernel rounds the bottleneck's and rgb layer 0's operands,
# and its autograd rounds every cotangent at each cast): rgb and sigma, and
# each dW/db leaf, by relative norm. Readings at this step's shapes over 6
# seeds of random weights (NVIDIA H100 80GB HBM3, 700.00 W): outputs
# 0.0025-0.0030; dW/db 0.031-0.038 at 196,608 rows and 0.049-0.074 at
# 65,536, where the f32 kernel, i.e. a kernel that computed the f32
# gradient, reads 0.136-0.169. check_nerf_kernels reports the f32
# kernel's readings in every run. The margin holds for the model's own
# weights (init_params: zero biases; trained): under random biases
# (k3_field_readings) the plain bf16 version strays further, and every
# bf16 kernel, tensor-core or CUDA-core, reads 0.097 against it, the f32
# kernel 0.133.
NERF_OUT_TOL_BF16 = 0.01
NERF_DW_TOL_BF16 = 0.1
# f32 dW/db (K3, and K1 on the no-views chain) against the exact math
# (nerf_f64, chain_f64): over 10^5 rows ReLU gates near 0 fall apart from
# the float64 ones, and the plain f32 version parts from it as far.
# Readings over the same seeds: the kernels 4.7e-4-1.7e-3, the plain
# version 6.3e-4-2.2e-3 (check_nerf_kernels reports both).
NERF_DW_TOL_F32 = 5e-3
# The model's GPU test render (kernels) against its CPU render (plain
# version), each output by relative norm. The fine level resamples its
# depths from the coarse weights, and posenc carries a depth's rounding up
# 2^9-fold into the field, so the two renders part by more than the field.
# Readings on the trained checkpoint (same card): bf16 <= 0.0094, f32 <=
# 1.6e-4, both at the fine disparity.
NERF_FWD_TOL = {'bf16': 0.05, 'f32': 1e-3}


def nerf_config(outdir):
    return configutil.Config(configutil.read_config(outdir + '.ini'))


def nerf_override(data_root):
    """nerf.ini at full width, cut only in image size; 4 epochs of the 3
    train views, checkpoints every 2, vali at 4."""
    return ','.join(['data_root=' + data_root, 'imh=%d' % IMH,
                     'outroot=' + join(WORK, 'out', 'nerf'), 'epochs=4',
                     'ckpt_period=2', 'vali_period=4', 'vali_batches=1'])


def run_nerf_training(data_root):
    """The NeRF training path through trainvali.main on nerf.ini; checks
    what it writes. Returns (launches, outdir, losses)."""
    zero_counters()
    run = trainvali.main(['--config', 'nerf.ini', '--config_override',
                          nerf_override(data_root)])
    torch.cuda.synchronize()
    launches = read_counters(('K3-fwd', 'K3-fwd tc', 'K3-bwd', 'K3 pack'),
                             'NeRF training')
    outdir = run['outdir']
    recs = [json.loads(line) for line in open(
        join(outdir, 'summary_train', 'scalars.jsonl'))]
    losses = [r['loss_train'] for r in recs]
    if [r['step'] for r in recs] != [2, 4] \
            or not np.all(np.isfinite(losses)):
        raise AssertionError("NeRF train scalars: %s" % recs)
    n_params = len(ckptutil.tree_leaves(NerfModel(
        nerf_config(outdir), device='cpu').init_params(torch.Generator())))
    ckpts = [ckptutil.read_leaves(join(outdir, 'checkpoints', 'ckpt-%d' % n))
             for n in (2, 4)]
    same = [i for i, (a, b) in enumerate(zip(ckpts[0][-n_params:],
                                             ckpts[1][-n_params:]))
            if np.array_equal(a, b)]
    if same:
        raise AssertionError("NeRF ckpt-4: params leaves %s as in ckpt-2"
                             % same)
    epoch_dir = join(outdir, 'vis_vali', 'epoch000000004')
    vali_dir = join(epoch_dir, 'batch000000000')
    meta = ioutil.read_json(join(vali_dir, 'metadata.json'))
    img = ioutil.load_img(join(vali_dir, 'fine_rgb.png'))
    files = [join(vali_dir, 'fine-vs-gt_rgb.apng'),
             join(vali_dir, 'fine-vs-coarse_depth.apng'),
             join(epoch_dir, 'all.html')]
    if img.shape[:2] != (IMH, IMH) or not np.isfinite(meta['psnr']) \
            or not all(os.path.exists(f) for f in files):
        raise AssertionError("NeRF vali outputs: %s %s" % (img.shape, meta))
    loss_vali = json.loads(open(join(outdir, 'summary_vali',
                                     'scalars.jsonl')).readline())['loss_vali']
    if not np.isfinite(loss_vali):
        raise AssertionError("NeRF vali loss %r" % loss_vali)
    return launches, outdir, {'loss_train': losses, 'loss_vali': loss_vali,
                              'vali_psnr': meta['psnr']}


def run_nerf_serving(ckpt):
    """The NeRF inference path through nerf_test.main over the test views;
    checks its images. Returns (launches, view seconds)."""
    zero_counters()
    run = nerf_test.main(['--ckpt', ckpt])
    torch.cuda.synchronize()
    launches = read_counters(('K3-fwd', 'K3-fwd tc'), 'NeRF inference')
    if launches['K3-bwd']:
        raise AssertionError("K3-bwd launched %d times on the NeRF "
                             "inference path" % launches['K3-bwd'])
    batch_dirs = ioutil.sortglob(run['outroot'], 'batch?????????')
    if len(batch_dirs) != N_VIEWS:
        raise AssertionError("NeRF views: %d dirs" % len(batch_dirs))
    for d in batch_dirs:
        for f in ('fine_rgb', 'coarse_rgb', 'fine_depth', 'fine_occu'):
            img = ioutil.load_img(join(d, f + '.png'))
            if img.shape[:2] != (IMH, IMH):
                raise AssertionError("%s/%s.png: %s" % (d, f, img.shape))
    return launches, run['view_seconds']


def check_nerf_forward(outdir, ckpt):
    """The NeRF model's GPU test render (kernels) against its CPU render
    (plain version) on 256 rays of the first test view that cross the
    sphere, as trained (bf16) and with bf16_big_chains off (f32)."""
    dataset = NerfDataset(nerf_config(outdir), 'test')
    batch = next(iter(dataset.build_pipeline(no_shuffle=True, prefetch=0)))
    rows = slice(IMH * IMH // 2, IMH * IMH // 2 + 256)
    arrays = {k: torch.as_tensor(np.asarray(batch[k][rows], np.float32))
              for k in dataset.array_keys}
    errs = {}
    for mode in ('bf16', 'f32'):
        parser = configutil.read_config(outdir + '.ini')
        if mode == 'f32':
            configutil.apply_override(parser, 'bf16_big_chains=False')
        outs = []
        for dev in ('cuda', 'cpu'):
            model = NerfModel(configutil.Config(parser), device=dev)
            params = ckptutil.restore_trained_params(
                ckpt, model.init_params(torch.Generator()), device=dev)
            with torch.no_grad():
                to_vis = model.apply(params, {k: v.to(dev) for k, v in
                                              arrays.items()}, mode='test')[3]
            outs.append({k: v.cpu() for k, v in to_vis.items()})
        errs[mode] = {k: rel_norm(outs[0][k], v) for k, v in outs[1].items()}
        check_norm('NeRF forward %s' % mode, list(errs[mode].values()),
                   NERF_FWD_TOL[mode])
    return errs


def nerf_field_inputs(g, n_rays, n_samples):
    """Points and view directions (n_rays x n_samples, 3) on rays from the
    camera distance towards the sphere, at sorted depths in [2, 6]."""
    cam = torch.randn(n_rays, 3, generator=g)
    cam = CAM_DIST * cam / cam.norm(dim=1, keepdim=True)
    aim = 0.5 * SPHERE_R * torch.randn(n_rays, 3, generator=g)
    d = aim - cam
    d = d / d.norm(dim=1, keepdim=True)
    z = torch.sort(2 + 4 * torch.rand(n_rays, n_samples, generator=g)).values
    pts = cam[:, None] + d[:, None] * z[:, :, None]
    views = d[:, None].expand(pts.shape)
    return pts.reshape(-1, 3).cuda(), views.reshape(-1, 3).contiguous().cuda()


def nerf_f64(nplan, pts, views, params):
    """The field's exact math: nerf_reference's program in float64 (the
    f32 versions are held to it; two f32 sums over 10^5 rows of random-sign
    cotangents cancel to ~1e-3 of each other)."""
    trunk, sigma_p, bott_p, rgb_p = params
    e = fm._embed(nplan.trunk_plan, pts)
    h = e
    for i, ((w, b), act) in enumerate(zip(trunk, nplan.trunk_plan.acts)):
        if i > 0 and (i - 1) in nplan.trunk_plan.skip_at:
            h = torch.cat((h, e), dim=1)
        h = fm._act(act, h @ w + b)
    (ws, bs), = sigma_p
    (wb, bb), = bott_p
    x = torch.cat([h @ wb + bb, encoding.posenc(views, nplan.n_freqs_view)],
                  dim=1)
    for (w, b), act in zip(rgb_p, nplan.rgb_acts):
        x = fm._act(act, x @ w + b)
    return x, h @ ws + bs


def nerf_params(model, params, level):
    pref = level + '_'
    return tuple(model._pairs(params[pref + k]) for k in (
        'enc', 'sigma_out', 'bottleneck', 'rgb_out'))


def check_nerf_kernels(model, params, seed=3, timing=True):
    """K3-fwd and K3-bwd against nerf_reference and autograd of it on the
    same tensors, at one train step's shapes (1024 rays x 64 coarse and x
    192 fine samples), bf16 and f32, with the fine level's weights of
    ``params`` and inputs drawn from ``seed``; dW bit-identical across two
    launches; with ``timing``, kernel and plain times, forward and backward
    alone, and bf16 K3-bwd's stages apart, at the fine shape."""
    g = torch.Generator().manual_seed(seed)
    nplan = model.nerf_plan
    p = nerf_params(model, params, 'fine')
    flat = fn.flatten(p)
    rows = []
    for n_s in (NERF_COARSE, NERF_COARSE + NERF_FINE):
        pts, views = nerf_field_inputs(g, NERF_RAYS, n_s)
        n = pts.shape[0]
        drgb = (2 * torch.rand(n, 3, generator=g) - 1).cuda()
        dsig = (2 * torch.rand(n, 1, generator=g) - 1).cuda()
        for mode, cd in (('bf16', torch.bfloat16), ('f32', None)):
            row = {'rows': n, 'dtype': mode}
            with torch.no_grad():
                got = fn.nerf_kernel(nplan, pts, views, p, cd)
                want = fn.nerf_reference(nplan, pts, views, p, cd)
            if mode == 'f32':
                row['max_abs_err'] = max(
                    compare('K3-fwd %s' % k, a, b, TOL_F32)
                    for k, a, b in zip(('rgb', 'sigma'), got, want))
            else:
                row['max_abs_err'] = max((a - b).abs().max().item()
                                         for a, b in zip(got, want))
                row['out_rel_err'] = check_norm('K3-fwd bf16', [
                    rel_norm(a, b) for a, b in zip(got, want)],
                    NERF_OUT_TOL_BF16)
                with torch.no_grad():
                    row['f32_kernel_out_rel_err'] = max(
                        rel_norm(a, b) for a, b in zip(fn.nerf_kernel(
                            nplan, pts, views, p, None), want))
            leaves = [t.clone().requires_grad_() for t in flat]
            out = fn.nerf_reference(nplan, pts, views,
                                    fn.unflatten(nplan, leaves), cd)
            want = torch.autograd.grad(out, leaves, (drgb, dsig),
                                       retain_graph=True)
            got = fn.flatten(fn.nerf_kernel_bwd(nplan, pts, views, drgb,
                                                dsig, p, cd))
            if cd is None:
                # f32 against the exact math, and the plain f32 beside it
                l64 = [t.double().requires_grad_() for t in flat]
                exact = [g.float() for g in torch.autograd.grad(
                    nerf_f64(nplan, pts.double(), views.double(),
                             fn.unflatten(nplan, l64)), l64,
                    (drgb.double(), dsig.double()))]
                row['plain_dw_rel_err'] = max(
                    rel_norm(a, b) for a, b in zip(want, exact))
                want = exact
                del l64
            tol = NERF_DW_TOL_BF16 if cd is not None else NERF_DW_TOL_F32
            row['dw_rel_err'] = check_norm('K3-bwd dW/db %s' % mode, [
                rel_norm(a, b) for a, b in zip(got, want)], tol)
            row['dw_tol'] = tol
            if cd is not None:
                # What a kernel that computed the f32 gradient would read
                row['f32_kernel_dw_rel_err'] = max(
                    rel_norm(a, b) for a, b in zip(fn.flatten(
                        fn.nerf_kernel_bwd(nplan, pts, views, drgb, dsig, p,
                                           None)), want))
                if row['dw_rel_err'] >= row['f32_kernel_dw_rel_err']:
                    raise AssertionError(
                        "K3-bwd bf16: dW/db reads %.4g, not below the f32 "
                        "kernel's %.4g" % (row['dw_rel_err'],
                                           row['f32_kernel_dw_rel_err']))
            again = fn.flatten(fn.nerf_kernel_bwd(nplan, pts, views, drgb,
                                                  dsig, p, cd))
            row['dw_bit_identical'] = all(torch.equal(a, b)
                                          for a, b in zip(got, again))
            if not row['dw_bit_identical']:
                raise AssertionError("K3-bwd: dW differs between two "
                                     "launches on the same inputs")
            if timing and n_s > NERF_COARSE and cd is not None:
                def field(f, dtype):
                    return lambda: torch.cat(f(nplan, pts, views, p, dtype),
                                             dim=1)
                row.update(tc_fwd_readings(
                    field(fn.nerf_kernel, cd),
                    field(fn.nerf_kernel_cuda_core, cd),
                    field(fn.nerf_kernel_cuda_core, None),
                    field(fn.nerf_reference, cd),
                    nerf_bound(nplan, n, mode)['flop'], K3_FWD_KERNELS))
            elif timing and n_s > NERF_COARSE:
                with torch.no_grad():
                    row['ms'], row['plain_ms'] = time_pair(
                        lambda: fn.nerf_kernel(nplan, pts, views, p, cd),
                        lambda: fn.nerf_reference(nplan, pts, views, p, cd),
                        iters=10)
            if timing and n_s > NERF_COARSE:
                row['bwd_ms'], row['bwd_plain_ms'] = time_pair(
                    lambda: fn.nerf_kernel_bwd(nplan, pts, views, drgb, dsig,
                                               p, cd),
                    lambda: torch.autograd.grad(out, leaves, (drgb, dsig),
                                                retain_graph=True),
                    iters=5)
                bnd = nerf_bound(nplan, n, mode, bwd=True)
                row['bwd_tflops'] = bnd['flop'] / row['bwd_ms'] / 1e9
                row['bwd_bound_ms'] = bnd['bound_ms']
                if cd is not None:
                    row.update(kernel_device_ms(lambda: fn.nerf_kernel_bwd(
                        nplan, pts, views, drgb, dsig, p, cd), K3_BWD_KERNELS))
                    size = fn.bwd_sizes(nplan, n, cd, pts.device)
                    row.update(scratch_bytes=2 * size['scratch'],
                               dw_chunks=size['chunks'],
                               phase1_blocks=size['slices'])
            del out, want
            rows.append(row)
    return rows


# The kernels of a bf16 K3-bwd and K1-bwd launch, by the names the
# profiler gives them (the dW pass, dw_kernel, is the two's own copy of
# mma_bf16.cuh's), and of a K1-fwd and K3-fwd launch (the names match the
# tensor-core and the CUDA-core kernel, so that an older tree reads too)
K3_BWD_KERNELS = (('phase1_ms', 'nerf_bwd_tc_kernel'),
                  ('dw_pass_ms', 'dw_kernel'),
                  ('sums_ms', 'sum_slices_kernel'))
K1_BWD_KERNELS = (('phase1_ms', 'chain_bwd_tc_kernel'),
                  ('dw_pass_ms', 'dw_kernel'),
                  ('sums_ms', 'sum_slices_kernel'))
K1_FWD_KERNELS = (('fwd_device_ms', 'chain_fwd'),)
K1R_BWD_KERNELS = (('phase1_ms', 'chain_stash_bwd_tc_kernel'),
                   ('dw_pass_ms', 'dw_kernel'),
                   ('sums_ms', 'sum_slices_kernel'))
K1R_FWD_KERNELS = (('fwd_device_ms', 'chain_stash_fwd'),)
K1W_BWD_KERNELS = (('phase1_ms', 'chain_last_skip_bwd_tc_kernel'),
                   ('dw_pass_ms', 'dw_kernel'),
                   ('dx_pass_ms', 'chain_dx_pass_kernel'),
                   ('sums_ms', 'sum_slices_kernel'))
K1W_FWD_KERNELS = (('fwd_device_ms', 'chain_last_skip_fwd'),)
K2_FWD_KERNELS = (('fwd_device_ms', 'rusink_chain_fwd'),)
K2_BWD_KERNELS = (('bwd_device_ms', 'rusink_chain_bwd'),)
K3_FWD_KERNELS = (('fwd_device_ms', 'nerf_fwd'),)


def profiled_device_us(run, iters):
    """A torch.profiler window over ``iters`` calls of ``run`` (after one
    outside it): ({kernel name: device us}, {kernel name: launches the
    window recorded})."""
    run()
    with card.profiler_window(PROFILER_ACTS) as prof:
        for _ in range(iters):
            run()
    us, seen = {}, {}
    for e in card.device_events(prof):
        us[e.key] = us.get(e.key, 0.0) + getattr(
            e, 'self_device_time_total', 0.0)
        seen[e.key] = seen.get(e.key, 0) + e.count
    return us, seen


def kernel_device_ms(run, kernels, iters=10, rest='packing_ms'):
    """Device ms per call of ``run`` (a kernel wrapper's launch) of each of
    ``kernels``, from a torch.profiler window over ``iters`` calls: for a
    bf16 backward phase 1, the dW pass and the slice sums (0 for a kernel
    the build lacks); the rest of its device time (``rest``) is the
    wrapper's weight packing."""
    us, _ = profiled_device_us(run, iters)
    out = {key: sum(v for k, v in us.items() if name in k) / 1e3 / iters
           for key, name in kernels}
    out[rest] = sum(us.values()) / 1e3 / iters - sum(out.values())
    return out


# The tensor-core building block alone (mma_bf16.cuh through
# nfk_tc_matmul) against the float64 product of the same bf16 values:
# 64 x 96 x 80 and sizes that are not multiples of the mma fragment. Only
# the f32 accumulation's rounding parts them.
TC_BLOCK_SHAPES = [(64, 96, 80), (37, 20, 45), (130, 300, 33)]
TC_BLOCK_TOL = 1e-4


def check_tc_block():
    """Shows that the lane mapping the CPU emulation assumes is the
    card's: each product within TC_BLOCK_TOL (abs + rel) of float64."""
    g = torch.Generator(device='cuda').manual_seed(6)
    out = []
    for m, n, k in TC_BLOCK_SHAPES:
        a, b = ((2 * torch.rand(r, k, generator=g, device='cuda') - 1).to(
            torch.bfloat16) for r in (m, n))
        got = fn.tc_matmul(a, b).double()
        err = compare('tc_matmul %dx%dx%d' % (m, n, k), got,
                      fn.tc_matmul_reference(a, b),
                      (TC_BLOCK_TOL, TC_BLOCK_TOL))
        out.append({'m': m, 'n': n, 'k': k, 'max_abs_err': err,
                    'tol': TC_BLOCK_TOL})
    return out


def k3_limit_readings(seeds):
    """What K3's bounds rest on: check_nerf_kernels' error readings (no
    timing) at nerf.ini widths over ``seeds``, each seeding both the
    weights (NerfModel.init_params) and the inputs."""
    parser = configutil.read_config(configutil.resolve_config_path(
        'nerf.ini'))
    model = NerfModel(configutil.Config(parser), device='cuda')
    keys = ('rows', 'dtype', 'out_rel_err', 'f32_kernel_out_rel_err',
            'dw_rel_err', 'f32_kernel_dw_rel_err', 'plain_dw_rel_err')
    out = []
    for seed in seeds:
        params = model.init_params(torch.Generator().manual_seed(seed))
        for r in check_nerf_kernels(model, params, seed=seed, timing=False):
            out.append(dict({k: r[k] for k in keys if k in r}, seed=seed))
        torch.cuda.empty_cache()
    return out


# ptxas -v's report of one kernel in build.log
PTXAS_ENTRY = re.compile(
    r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
    r"(\d+) bytes spill loads.*?Used (\d+) registers", re.S)


def named(function, names):
    """Whether the mangled ``function`` is a kernel whose name starts with
    one of ``names`` (in a mangled name an identifier follows its length:
    'chain_fwd' names K1's 19chain_fwd_tc_kernel, not K2's
    26rusink_chain_fwd_tc_kernel)."""
    return any(re.search(r'\d' + name, function) for name in names)


def ptxas_report(names):
    """Registers and spill bytes of the built kernels whose names start
    with one of ``names`` (named), from the build's ptxas report."""
    with open(join(dirname(kernel_lib.build()), 'build.log')) as f:
        log = f.read()
    return {m.group(1): {'registers': int(m.group(4)),
                         'spill_stores': int(m.group(2)),
                         'spill_loads': int(m.group(3))}
            for m in PTXAS_ENTRY.finditer(log) if named(m.group(1), names)}


def k3_field_readings(seed, iters=10):
    """bf16 K3-bwd at the NeRF step's fine shape (1024 rays x 192 samples)
    on nerf.ini's field under glorot-uniform weights with biases of 0.05
    randn (as the tests' fields), drawn from ``seed`` with the inputs:
    dW/db of the bf16 kernel, the f32 kernel and the plain bf16 version
    against the float64 gradient, and of both kernels against autograd of
    the plain bf16 version (smoke's comparison); dW bits across two
    launches and their digest; the bf16 backward's ms (CUDA events), each
    of its kernels' device ms (kernel_device_ms); K3-fwd's output against
    the plain bf16 version, its ms and device ms; the ptxas report of the
    K3 kernels. It calls nothing but nerf_kernel and nerf_kernel_bwd, so it
    runs the same against an older tree's package."""
    parser = configutil.read_config(configutil.resolve_config_path(
        'nerf.ini'))
    nplan = NerfModel(configutil.Config(parser), device='cuda').nerf_plan
    tp = nplan.trunk_plan
    g = torch.Generator().manual_seed(seed)

    def dense(din, dout):
        lim = (6.0 / (din + dout)) ** 0.5
        return ((2 * torch.rand(din, dout, generator=g) - 1) * lim).cuda(), \
            (0.05 * torch.randn(dout, generator=g)).cuda()
    width, ev = tp.widths[-1], fn.view_dim(nplan)
    p = ([dense(d, w) for d, w in zip(fm.layer_in_dims(tp), tp.widths)],
         [dense(width, 1)], [dense(width, width)],
         [dense(width + ev, nplan.rgb_widths[0]), dense(*nplan.rgb_widths)])
    n = NERF_RAYS * (NERF_COARSE + NERF_FINE)
    pts = (3 * torch.rand(n, 3, generator=g) - 1.5).cuda()
    views = torch.nn.functional.normalize(torch.randn(n, 3, generator=g),
                                          dim=1).cuda()
    drgb = (2 * torch.rand(n, 3, generator=g) - 1).cuda()
    dsig = (2 * torch.rand(n, 1, generator=g) - 1).cuda()
    flat = fn.flatten(p)
    bf16 = torch.bfloat16

    def kernel(cd):
        return fn.flatten(fn.nerf_kernel_bwd(nplan, pts, views, drgb, dsig,
                                             p, cd))
    leaves = [t.clone().requires_grad_() for t in flat]
    plain = torch.autograd.grad(fn.nerf_reference(
        nplan, pts, views, fn.unflatten(nplan, leaves), bf16), leaves,
        (drgb, dsig))
    l64 = [t.double().requires_grad_() for t in flat]
    exact = [x.float() for x in torch.autograd.grad(
        nerf_f64(nplan, pts.double(), views.double(),
                 fn.unflatten(nplan, l64)), l64,
        (drgb.double(), dsig.double()))]
    del leaves, l64
    with torch.no_grad():
        fwd = (lambda cd: torch.cat(fn.nerf_kernel(nplan, pts, views, p, cd),
                                    dim=1),
               torch.cat(fn.nerf_reference(nplan, pts, views, p, bf16), dim=1),
               K3_FWD_KERNELS)
    return dict(seed=seed, rows=n, plain_bf16_vs_f64=worst_leaf(plain, exact),
                **field_readings(kernel, {'plain_bf16': plain, 'f64': exact},
                                 K3_BWD_KERNELS,
                                 ('nerf_fwd', 'nerf_bwd', 'dw_kernel'), iters,
                                 fwd))


def k1_field_readings(seed, iters=10):
    """bf16 K1-bwd with dW only on the lvis chain (LVIS_PLAN) at the joint
    step's 1,048,576 rows, under glorot-uniform weights and zero biases
    (the shape model's init) and inputs drawn from ``seed``: dW/db of the
    bf16 kernel and of the f32 kernel against autograd of the plain bf16
    version; dW bits across two launches and their digest; the backward's
    ms (CUDA events), each of its kernels' device ms (kernel_device_ms);
    K1-fwd's output against the plain bf16 version, its ms and device ms;
    the ptxas report of the K1 kernels. It calls nothing but chain_kernel
    and chain_kernel_bwd, so it runs the same against an older tree's
    package."""
    plan, p, x, dy = lvis_field(seed)
    n = x.shape[0]
    bf16 = torch.bfloat16

    def kernel(cd):
        return flatten(fm.chain_kernel_bwd(plan, x, dy, p, cd,
                                           needs_dx=False)[1])
    leaves = [t.clone().requires_grad_() for t in flatten(p)]
    plain = torch.autograd.grad(fm.chain_reference(plan, x, pairs(leaves),
                                                   bf16), leaves, dy)
    del leaves
    with torch.no_grad():
        fwd = (lambda cd: fm.chain_kernel(plan, x, p, cd),
               fm.chain_reference(plan, x, p, bf16), K1_FWD_KERNELS)
    return dict(seed=seed, rows=n, **field_readings(
        kernel, {'plain_bf16': plain}, K1_BWD_KERNELS,
        ('chain_fwd', 'chain_bwd', 'dw_kernel'), iters, fwd))


def lvis_field(seed):
    """The lvis chain's weights as the shape model initialises them
    (glorot-uniform, zero biases) and 1,048,576 rows of inputs (sphere
    points and light directions) and head cotangents, from ``seed``."""
    plan = LVIS_PLAN
    g = torch.Generator().manual_seed(seed)
    p = []
    for din, dout in zip(fm.layer_in_dims(plan), plan.widths):
        lim = (6.0 / (din + dout)) ** 0.5
        p.append((((2 * torch.rand(din, dout, generator=g) - 1) * lim).cuda(),
                  torch.zeros(dout).cuda()))
    n = LAST_SKIP_ROWS['bf16']
    pts = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    ldir = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    x = torch.cat((SPHERE_R * pts, ldir), dim=1).cuda()
    dy = (2 * torch.rand(n, 1, generator=g) - 1).cuda()
    return plan, p, x, dy


def k1r_field_readings(seed, iters=10):
    """k1_field_readings on the stash route: bf16 K1r-bwd with dW only on
    the lvis chain at 1,048,576 rows (lvis_field), over the stash K1r-fwd
    writes in the same precision, against autograd of the plain bf16 stash
    route; its dW bits and digest, ms and each kernel's device ms; K1r-fwd
    with the stash against the plain bf16 stash route, its ms and device
    ms; the ptxas report of the K1r tensor-core kernels. It calls nothing
    but chain_kernel_stash and chain_kernel_stash_bwd, so it runs the same
    against an older tree's package (whose K1r kernels are the CUDA-core
    ones)."""
    plan, p, x, dy = lvis_field(seed)
    bf16 = torch.bfloat16
    with torch.no_grad():
        stashes = {cd: fm.chain_kernel_stash(plan, x, p, cd,
                                             with_stash=True)[1]
                   for cd in (bf16, None)}

    def kernel(cd):
        return flatten(fm.chain_kernel_stash_bwd(plan, x, dy, stashes[cd], p,
                                                 cd, needs_dx=False)[1])
    leaves = [t.clone().requires_grad_() for t in flatten(p)]
    plain = torch.autograd.grad(fm.chain_reference_stash(
        plan, x, pairs(leaves), bf16), leaves, dy)
    del leaves
    with torch.no_grad():
        fwd = (lambda cd: fm.chain_kernel_stash(plan, x, p, cd,
                                                with_stash=True)[0],
               fm.chain_reference_stash(plan, x, p, bf16), K1R_FWD_KERNELS)
    return dict(seed=seed, rows=x.shape[0], **field_readings(
        kernel, {'plain_bf16': plain}, K1R_BWD_KERNELS,
        ('chain_stash_fwd', 'chain_stash_bwd', 'dw_kernel'), iters, fwd))


# The shipped BRDF prior's chain (brdf.ini: 128 x 4, skip after layer 2;
# nerfactor.ini: z_dim 3, rusink at 2 octaves), K2's plan
K2_FIELD_PLAN = fm.make_plan([(3, 0), (3, 2)], (128,) * 4 + (1,),
                             ('relu',) * 4 + ('softplus',), (2,))
K2_FIELD_ROWS = 524288  # the joint step's K2 rows


def k2_field_readings(seed, iters=10):
    """bf16 K2-bwd on the BRDF chain (K2_FIELD_PLAN) at the joint step's
    524,288 rows, under glorot-uniform weights with biases of 0.05 randn
    and inputs (latent codes, light and view directions) and head
    cotangents drawn from ``seed``: the sha256 of its cotangents (dz, dl,
    dv) and of K2-fwd's output, both bit-identical across two launches,
    and the backward's ms. It calls nothing but rusink_kernel and
    rusink_kernel_bwd, so it runs the same against an older tree's
    package: two trees' digests say whether their bf16 K2 computes the
    same bits."""
    plan, g = K2_FIELD_PLAN, torch.Generator().manual_seed(seed)
    p = []
    for din, dout in zip(fm.layer_in_dims(plan), plan.widths):
        lim = (6.0 / (din + dout)) ** 0.5
        p.append((((2 * torch.rand(din, dout, generator=g) - 1) * lim).cuda(),
                  (0.05 * torch.randn(dout, generator=g)).cuda()))
    n = K2_FIELD_ROWS
    z = (0.5 * torch.randn(n, 3, generator=g)).cuda()
    ldir, vdir = (torch.nn.functional.normalize(
        torch.randn(n, 3, generator=g), dim=1).cuda() for _ in range(2))
    dy = (2 * torch.rand(n, 1, generator=g) - 1).cuda()
    bf16 = torch.bfloat16

    def digest(tensors):
        return hashlib.sha256(b''.join(
            t.cpu().numpy().tobytes() for t in tensors)).hexdigest()
    with torch.no_grad():
        y = fr.rusink_kernel(plan, z, ldir, vdir, p, bf16)
        y_again = fr.rusink_kernel(plan, z, ldir, vdir, p, bf16)
    got = fr.rusink_kernel_bwd(plan, z, ldir, vdir, dy, p, bf16)
    again = fr.rusink_kernel_bwd(plan, z, ldir, vdir, dy, p, bf16)
    return {'seed': seed, 'rows': n, 'fwd_sha256': digest([y]),
            'fwd_bit_identical': torch.equal(y, y_again),
            'cotangents_sha256': digest(got),
            'cotangents_bit_identical': all(
                torch.equal(a, b) for a, b in zip(got, again)),
            'bwd_ms': time_ms(lambda: fr.rusink_kernel_bwd(
                plan, z, ldir, vdir, dy, p, bf16), iters=iters)}


def worst_leaf(a, b):
    """The worst relative norm over the leaves of ``a`` against ``b``."""
    return max(rel_norm(x, y) for x, y in zip(a, b))


def field_readings(kernel, refs, kernels, ptxas_names, iters, fwd):
    """What --field_seed prints of a backward ``kernel(compute_dtype)``
    (its flat dW/db): the bf16 and the f32 kernel's worst dW/db leaf
    against each of ``refs`` (name: flat dW/db); the bf16 dW bits across
    two launches and their digest; the bf16 backward's ms (CUDA events),
    each of ``kernels``' device ms (kernel_device_ms) and the ptxas report
    of the kernels ``ptxas_names`` name. ``fwd`` = (run(compute_dtype), the
    plain bf16 version's output, the forward's kernels): the bf16 and the
    f32 forward's output against the plain one (relative norm), the bf16
    forward's ms (CUDA events) and device ms."""
    bf16 = torch.bfloat16
    run_fwd, plain_fwd, fwd_kernels = fwd
    with torch.no_grad():
        out = {'fwd_bf16_vs_plain_bf16': rel_norm(run_fwd(bf16), plain_fwd),
               'fwd_f32_vs_plain_bf16': rel_norm(run_fwd(None), plain_fwd),
               'fwd_ms': time_ms(lambda: run_fwd(bf16), iters=iters)}
        out.update(kernel_device_ms(lambda: run_fwd(bf16), fwd_kernels,
                                    iters=iters, rest='fwd_packing_ms'))
    got, got_f32 = kernel(bf16), kernel(None)
    for name, ref in refs.items():
        out['bf16_kernel_vs_' + name] = worst_leaf(got, ref)
        out['f32_kernel_vs_' + name] = worst_leaf(got_f32, ref)
    out['dw_bit_identical'] = all(torch.equal(a, b)
                                  for a, b in zip(got, kernel(bf16)))
    out['dw_sha256'] = hashlib.sha256(b''.join(
        t.cpu().numpy().tobytes() for t in got)).hexdigest()
    out['bwd_ms'] = time_ms(lambda: kernel(bf16), iters=iters)
    out.update(kernel_device_ms(lambda: kernel(bf16), kernels, iters=iters))
    out['ptxas'] = ptxas_report(ptxas_names)
    return out


def check_no_views_chain(g):
    """K1-fwd and K1-bwd on NeRF's no-views chain (nerf.ini widths with
    use_views off: 256 x 8, skip after layer 4, a 4-wide head) at the
    coarse level's 65,536 rows, bf16 and f32, against the plain version."""
    parser = configutil.read_config(configutil.resolve_config_path(
        'nerf.ini'))
    configutil.apply_override(parser, 'use_views=False')
    model = NerfModel(configutil.Config(parser), device='cuda')
    params = model.init_params(torch.Generator().manual_seed(4))
    plan = model.rgbs_plan
    p = fm.params_from_tree(params['coarse_enc'], params['coarse_rgbs_out'])
    x, _ = nerf_field_inputs(g, NERF_RAYS, NERF_COARSE)
    dy = (2 * torch.rand(x.shape[0], 4, generator=g) - 1).cuda()
    rows = []
    for mode, cd in (('bf16', torch.bfloat16), ('f32', None)):
        with torch.no_grad():
            err = compare('K1-fwd no-views %s' % mode,
                          fm.chain_kernel(plan, x, p, cd),
                          fm.chain_reference(plan, x, p, cd),
                          TOL_BF16 if cd is not None else TOL_F32)
        leaves = [t.clone().requires_grad_() for t in flatten(p)]
        y = fm.chain_reference(plan, x, list(zip(leaves[0::2], leaves[1::2])),
                               cd)
        want = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        _, got = fm.chain_kernel_bwd(plan, x, dy, p, cd, needs_dx=False)
        row = {'chain': 'nerf_rgbs', 'rows': x.shape[0], 'dtype': mode,
               'fwd_max_abs_err': err}
        if cd is None:
            # f32 against the exact math, as K3's (see nerf_f64)
            l64 = [t.double().requires_grad_() for t in flatten(p)]
            exact = [g.float() for g in torch.autograd.grad(
                chain_f64(plan, x.double(),
                          list(zip(l64[0::2], l64[1::2])))[0],
                l64, dy.double())]
            row['plain_dw_rel_err'] = max(
                rel_norm(a, b) for a, b in zip(want, exact))
            want = exact
            del l64
        row['dw_tol'] = tol = NORM_TOL_BF16 if cd is not None \
            else NERF_DW_TOL_F32
        row['dw_rel_err'] = check_norm('K1-bwd no-views %s' % mode, [
            rel_norm(a, b) for a, b in zip(flatten(got), want)], tol)
        if cd is not None and fm.fwd_on_tensor_cores(plan, cd, x.device):
            row.update(tc_fwd_readings(
                lambda: fm.chain_kernel(plan, x, p, cd),
                lambda: fm.chain_kernel_cuda_core(plan, x, p, cd),
                lambda: fm.chain_kernel_cuda_core(plan, x, p, None),
                lambda: fm.chain_reference(plan, x, p, cd),
                chain_bound(plan, x.shape[0], 'bf16', 3, 4)['flop'],
                K1_FWD_KERNELS))
        else:
            with torch.no_grad():
                row['ms'], row['plain_ms'] = time_pair(
                    lambda: fm.chain_kernel(plan, x, p, cd),
                    lambda: fm.chain_reference(plan, x, p, cd), iters=10)
        row['bwd_ms'], row['bwd_plain_ms'] = time_pair(
            lambda: fm.chain_kernel_bwd(plan, x, dy, p, cd, needs_dx=False),
            lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
            iters=5)
        del y, want
        rows.append(row)
    return rows


# ------ the chain's other routes and the dot-chain probe ------

# The stash's trig columns against trig_stash at the operand type: precise
# sinf against torch.sin (f32, ~1 ulp), and in bf16 a value within that of
# a rounding boundary lands one step of 2^-8 (|sin| <= 1) away.
STASH_TOL = {'f32': (1e-6, 0.0), 'bf16': (2 ** -8 + 1e-6, 0.0)}


def pairs(flat):
    return list(zip(flat[0::2], flat[1::2]))


def check_stash_route(model, params):
    """K1r-fwd (with and without the stash) and K1r-bwd against the stash
    route's plain version (chain_reference_stash, autograd of it) on every
    chain the stash-route joint step runs, at its shapes: the normal,
    albedo and brdf_z heads (2N twin rows, f32) and lvis (2N x L =
    1,048,576 rows, bf16), dW only as the step asks; then 65,536 of the
    lvis rows in f32 with dx. The forward within TOL_F32 / TOL_BF16, dW/db
    by relative norm per leaf (DW_TOL_F32, NORM_TOL_BF16), f32 dx by
    relative norm (DW_TOL_F32); dW bit-identical across two launches. The
    bf16 lvis calls run on the tensor cores (stash_fwd_tc_readings,
    stash_bwd_tc_readings): beside them the CUDA-core kernels they
    replace, and bf16 K1r-bwd's dW/db must read below the f32 kernel's. Returns the rows and the lvis inputs (for
    check_last_skip)."""
    g = torch.Generator().manual_seed(6)
    twins, lvis_x, _ = step_inputs(model, g)
    cases = [(name, twins, None, False) for name in
             ('normal', 'albedo', 'brdf_z')]
    cases += [('lvis', lvis_x, model.chain_dtype('lvis'), False),
              ('lvis', lvis_x[:65536].contiguous(), None, True)]
    rows = []
    for name, x, cd, needs_dx in cases:
        plan = model.plans[name]
        p = fm.params_from_tree(params[name + '_mlp'], params[name + '_out'])
        flat = flatten(p)
        n = x.shape[0]
        mode = 'bf16' if cd is not None else 'f32'
        dy = (2 * torch.rand(n, fm.out_dim(plan), generator=g) - 1).cuda()
        tol = TOL_BF16 if cd is not None else TOL_F32
        with torch.no_grad():
            y, stash = fm.chain_kernel_stash(plan, x, p, cd, with_stash=True)
            y_ns = fm.chain_kernel_stash(plan, x, p, cd)[0]
            want_y = fm.chain_reference_stash(plan, x, p, cd)
            want_stash = fm.trig_stash(plan, x).to(stash.dtype).float()
        what = '%s %s %d rows' % (name, mode, n)
        row = {'chain': name, 'rows': n, 'dtype': mode, 'needs_dx': needs_dx,
               'max_abs_err': max(compare('K1r-fwd ' + what, y, want_y, tol),
                                  compare('K1r-fwd no stash ' + what, y_ns,
                                          want_y, tol)),
               'stash_max_abs_err': compare('K1r-fwd stash ' + what,
                                            stash.float(), want_stash,
                                            STASH_TOL[mode]),
               'fwd_same_with_and_without_stash': torch.equal(y, y_ns)}
        if not row['fwd_same_with_and_without_stash']:
            raise AssertionError("K1r-fwd %s: the output changes with the "
                                 "stash" % what)
        del want_y, want_stash
        tc = fm.fwd_on_tensor_cores(plan, cd, x.device, stash_route=True)
        if tc:
            row['fwd'] = stash_fwd_tc_readings(plan, x, p, cd, stash)
        leaves = [t.clone().requires_grad_() for t in flat]
        xg = x.clone().requires_grad_()
        y_p = fm.chain_reference_stash(plan, xg, pairs(leaves), cd)
        wrt = ([xg] if needs_dx else []) + leaves
        want = torch.autograd.grad(y_p, wrt, dy, retain_graph=True)
        dx, got = fm.chain_kernel_stash_bwd(plan, x, dy, stash, p, cd,
                                            needs_dx=needs_dx)
        dw_tol = NORM_TOL_BF16 if cd is not None else DW_TOL_F32
        row['dw_tol'] = dw_tol
        row['dw_rel_err'] = check_norm('K1r-bwd dW/db ' + what, [
            rel_norm(a, b) for a, b in zip(flatten(got), want[-len(flat):])],
            dw_tol)
        if cd is not None:
            # What a kernel that computed the f32 gradient would read
            with torch.no_grad():
                stash32 = fm.chain_kernel_stash(plan, x, p, None,
                                                with_stash=True)[1]
            got32 = fm.chain_kernel_stash_bwd(plan, x, dy, stash32, p, None,
                                              needs_dx=False)[1]
            row['f32_kernel_dw_rel_err'] = max(rel_norm(a, b) for a, b in zip(
                flatten(got32), want[-len(flat):]))
            del stash32, got32
            if row['dw_rel_err'] >= row['f32_kernel_dw_rel_err']:
                raise AssertionError(
                    "K1r-bwd %s: dW/db reads %.4g, not below the f32 "
                    "kernel's %.4g" % (what, row['dw_rel_err'],
                                       row['f32_kernel_dw_rel_err']))
        tc_bwd = fm.bwd_on_tensor_cores(plan, cd, needs_dx, True, x.device,
                                        stash_route=True)
        if tc_bwd:
            core = fm.chain_kernel_stash_bwd_cuda_core(
                plan, x, dy, stash, p, cd, needs_dx=False)[1]
            row['cuda_core_dw_rel_err'] = max(rel_norm(a, b) for a, b in zip(
                flatten(core), want[-len(flat):]))
            row['tc_vs_cuda_core_dw_rel_err'] = max(
                rel_norm(a, b) for a, b in zip(flatten(got), flatten(core)))
            del core
        if needs_dx:
            row['dx_rel_err'] = check_norm('K1r-bwd dx ' + what,
                                           [rel_norm(dx, want[0])], DW_TOL_F32)
            row['dx_max_abs_err'] = (dx - want[0]).abs().max().item()
        again = fm.chain_kernel_stash_bwd(plan, x, dy, stash, p, cd,
                                          needs_dx=needs_dx)[1]
        row['dw_bit_identical'] = all(torch.equal(a, b) for a, b in zip(
            flatten(got), flatten(again)))
        if not row['dw_bit_identical']:
            raise AssertionError("K1r-bwd %s: dW differs between two launches "
                                 "on the same inputs" % what)
        del got, again, want
        with torch.no_grad():
            row['ms'], row['plain_ms'] = time_pair(
                lambda: fm.chain_kernel_stash(plan, x, p, cd, with_stash=True),
                lambda: fm.chain_reference_stash(plan, x, p, cd), iters=10)
            row['no_stash_ms'] = time_ms(
                lambda: fm.chain_kernel_stash(plan, x, p, cd), iters=10)
        row['bwd_ms'], row['bwd_plain_ms'] = time_pair(
            lambda: fm.chain_kernel_stash_bwd(plan, x, dy, stash, p, cd,
                                              needs_dx=needs_dx),
            lambda: torch.autograd.grad(y_p, wrt, dy, retain_graph=True),
            iters=10)
        del y_p
        if tc_bwd:
            row.update(stash_bwd_tc_readings(plan, x, dy, p, cd, stash,
                                             row['bwd_ms']))
        del stash
        rows.append(row)
    return rows, lvis_x


def stash_fwd_tc_readings(plan, x, p, cd, stash):
    """What the smoke reads of bf16 K1r-fwd on the tensor cores with the
    stash, at a path's shape (tc_fwd_readings: against the CUDA-core bf16
    kernel it replaces and the f32 kernel, ms, device ms, TFLOP/s), and
    whether its ``stash`` is the CUDA-core kernel's bit for bit; raises if
    it is not."""
    out = dict(tc_fwd_readings(
        lambda: fm.chain_kernel_stash(plan, x, p, cd, with_stash=True)[0],
        lambda: fm.chain_kernel_stash_cuda_core(plan, x, p, cd,
                                                with_stash=True)[0],
        lambda: fm.chain_kernel_stash_cuda_core(plan, x, p, None,
                                                with_stash=True)[0],
        lambda: fm.chain_reference_stash(plan, x, p, cd),
        chain_bound(plan, x.shape[0], 'bf16', 6, 1)['flop'],
        K1R_FWD_KERNELS), rows=x.shape[0], dtype='bf16')
    with torch.no_grad():
        core = fm.chain_kernel_stash_cuda_core(plan, x, p, cd,
                                               with_stash=True)[1]
    out['stash_same_as_cuda_core'] = torch.equal(stash, core)
    if not out['stash_same_as_cuda_core']:
        raise AssertionError("K1r-fwd on the tensor cores: the stash differs "
                             "from the CUDA-core kernel's")
    return out


def stash_bwd_tc_readings(plan, x, dy, p, cd, stash, bwd_ms):
    """bf16 K1r-bwd with dW only on the tensor cores at a path's shape: the
    CUDA-core kernel it replaces (ms), its kernels' device ms (phase 1, the
    dW pass, the sums; kernel_device_ms), its scratch and its TFLOP/s at
    ``bwd_ms``."""
    out = {'cuda_core_bwd_ms': time_ms(
        lambda: fm.chain_kernel_stash_bwd_cuda_core(
            plan, x, dy, stash, p, cd, needs_dx=False), iters=5)}
    out.update(kernel_device_ms(lambda: fm.chain_kernel_stash_bwd(
        plan, x, dy, stash, p, cd, needs_dx=False), K1R_BWD_KERNELS))
    size = fm.tc_bwd_sizes(fm.mma_plan(plan), x.shape[0], x.device)
    out.update(scratch_bytes=2 * size['scratch'], dw_chunks=size['chunks'],
               phase1_blocks=size['slices'])
    out['bwd_tflops'] = chain_bound(plan, x.shape[0], 'bf16', 6, 1,
                                    bwd=(False, True))['flop'] / bwd_ms / 1e9
    return out


# The lvis chain with its skip moved after the head: the output is [lvis |
# embedding], 1 + 90 columns. It runs in bf16 at the lvis chain's
# 1,048,576 rows and in f32 at 65,536 rows with dx.
LAST_SKIP_ROWS = {'bf16': 1048576, 'f32': 65536}
# The joint model's lvis chain (nerfactor.ini: xyz and light directions
# at 10 and 4 octaves, 128 x 4, the embedding concatenated after layer 2)
LVIS_PLAN = fm.make_plan([(3, 10), (3, 4)], (128,) * 4 + (1,),
                         ('relu',) * 4 + ('sigmoid',), (2,))
LAST_SKIP_PLAN = LVIS_PLAN._replace(skip_at=(4,))
# The same layers without the last skip: what K1 runs for K1w's head
NO_LAST_SKIP_PLAN = LAST_SKIP_PLAN._replace(skip_at=())


def last_skip_params(p_lvis):
    """The lvis chain's weights on LAST_SKIP_PLAN: each layer's first
    rows (the skip consumer loses its embedding rows). K1's bf16 dW bound
    is read on the lvis chain's weights; under glorot-uniform weights K1
    and K1w alike sit several times further from the bf16 plain version,
    and no longer apart from a kernel computing the f32 gradient."""
    return [(w[:d].contiguous(), b) for (w, b), d in
            zip(p_lvis, fm.layer_in_dims(LAST_SKIP_PLAN))]


# In bf16 K1w and K1 run the same tensor-core code on the layers they
# share (K1w-fwd is K1-fwd's tile, K1w-bwd's dW comes from K1-bwd's phase 1
# and dW pass), so K1w's dW/db are K1's bit for bit (dw_same_as_k1). The
# gate below held them while K1w-bwd ran on the CUDA cores, where a d_pre
# next to a bf16 rounding boundary rounds the other way; it stays, by
# relative norm (worst leaf). Readings at LAST_SKIP_ROWS with K1w-bwd on
# the CUDA cores (chip_smoke.py --limit_seeds k1 11,12,13,14; NVIDIA H100
# 80GB HBM3, 700.00 W): 0.0015-0.0026, and 0.0019 on the lvis chain's
# trained weights in the smoke (the f32 kernel, in the same readings, sits
# 0.087-0.098 from the plain bf16 version).
K1W_VS_K1_TOL_BF16 = 0.005


def last_skip_vs_k1(x, dy, p, cd, y, got):
    """K1w against K1 on the same layers without the last skip: K1w-fwd's
    head column ``y[:, :1]`` against K1-fwd's (in bf16 both on the tensor
    cores; in f32 K1w's CUDA-core kernel against K1's, which K1-fwd may
    run in split TF32 on the tensor cores; bit for bit, the CUDA-core
    kernel's relative norm reported beside), and K1w-bwd's dW/db ``got``
    against K1-bwd's with dy's head column (dy's embedding columns reach
    dx alone; in f32 K1's CUDA-core kernel, which K1w-bwd shares, since
    K1-bwd with dW alone runs split TF32): whether they are the same bits,
    and the worst leaf's relative norm."""
    with torch.no_grad():
        head_core = fm.chain_kernel_cuda_core(NO_LAST_SKIP_PLAN, x, p, cd)
        head = head_core if cd is None \
            else fm.chain_kernel(NO_LAST_SKIP_PLAN, x, p, cd)
    bwd = fm.chain_kernel_bwd_cuda_core if cd is None else fm.chain_kernel_bwd
    k1 = flatten(bwd(NO_LAST_SKIP_PLAN, x, dy[:, :1].contiguous(), p, cd,
                     needs_dx=False)[1])
    return {'head_same_as_k1': torch.equal(y[:, :1], head),
            'head_rel_err_vs_cuda_core': rel_norm(y[:, :1], head_core),
            'dw_same_as_k1': all(torch.equal(a, b)
                                 for a, b in zip(flatten(got), k1)),
            'dw_rel_err_vs_k1': max(rel_norm(a, b)
                                    for a, b in zip(flatten(got), k1))}


def last_skip_tc_readings(x, dy, p, cd, bwd_ms):
    """bf16 K1w on the tensor cores at the last-skip path's shape: K1w-fwd
    against the CUDA-core bf16 kernel it replaces and the f32 kernel
    (tc_fwd_readings: ms, device ms, TFLOP/s), and whether its embedding
    columns are the CUDA-core kernel's bit for bit (raises if not); K1w-bwd
    with dx and dW: its dx against the CUDA-core bf16 kernel's (relative
    norm; the f32 kernel's beside), the CUDA-core kernel's ms, its kernels'
    device ms (phase 1, the dW pass, the dx pass, the sums;
    kernel_device_ms), its scratch, its TFLOP/s at ``bwd_ms``, and its ms
    with dW only and with dx only."""
    plan = LAST_SKIP_PLAN
    rows = x.shape[0]
    out = {'fwd': dict(tc_fwd_readings(
        lambda: fm.chain_kernel_last_skip(plan, x, p, cd),
        lambda: fm.chain_kernel_last_skip_cuda_core(plan, x, p, cd),
        lambda: fm.chain_kernel_last_skip_cuda_core(plan, x, p, None),
        lambda: fm.chain_reference(plan, x, p, cd),
        chain_bound(plan, rows, 'bf16', 6, fm.out_dim(plan))['flop'],
        K1W_FWD_KERNELS), rows=rows, dtype='bf16')}
    with torch.no_grad():
        y = fm.chain_kernel_last_skip(plan, x, p, cd)
        core = fm.chain_kernel_last_skip_cuda_core(plan, x, p, cd)
    out['fwd']['embed_same_as_cuda_core'] = torch.equal(y[:, 1:], core[:, 1:])
    if not out['fwd']['embed_same_as_cuda_core']:
        raise AssertionError("K1w-fwd on the tensor cores: the embedding "
                             "columns differ from the CUDA-core kernel's")
    del y, core
    dx = fm.chain_kernel_last_skip_bwd(plan, x, dy, p, cd)[0]
    dx_core = fm.chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, p, cd,
                                                      needs_dw=False)[0]
    dx32 = fm.chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, p, None,
                                                   needs_dw=False)[0]
    out.update(tc_vs_cuda_core_dx_rel_err=rel_norm(dx, dx_core),
               f32_kernel_vs_cuda_core_dx_rel_err=rel_norm(dx32, dx_core))
    del dx, dx_core, dx32
    out['cuda_core_bwd_ms'] = time_ms(
        lambda: fm.chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, p, cd),
        iters=3)
    out.update(kernel_device_ms(lambda: fm.chain_kernel_last_skip_bwd(
        plan, x, dy, p, cd), K1W_BWD_KERNELS))
    size = fm.tc_bwd_sizes(fm.mma_plan(plan), rows, x.device)
    out.update(scratch_bytes=2 * size['scratch'], dw_chunks=size['chunks'],
               phase1_blocks=size['slices'])
    out['bwd_tflops'] = chain_bound(plan, rows, 'bf16', 6, fm.out_dim(plan),
                                    bwd=(True, True))['flop'] / bwd_ms / 1e9
    for key, flags in (('bwd_dw_only_ms', (False, True)),
                       ('bwd_dx_only_ms', (True, False))):
        out[key] = time_ms(lambda: fm.chain_kernel_last_skip_bwd(
            plan, x, dy, p, cd, *flags), iters=10)
    return out


def run_last_skip_path(cases, p):
    """The last-skip chain's path: apply_chain under autograd (x and the
    weights trainable) on each of ``cases`` (mode, dtype, x, dy), as a
    caller of the chain API runs it. Returns the kernels' launches on it."""
    zero_counters()
    for _, cd, x, dy in cases:
        ins = [x.clone().requires_grad_()] + [
            t.clone().requires_grad_() for t in flatten(p)]
        y = fm.apply_chain(LAST_SKIP_PLAN, ins[0], pairs(ins[1:]),
                           compute_dtype=cd)
        grads = torch.autograd.grad(y, ins, dy)
        if not all(torch.isfinite(t).all() for t in (y,) + grads):
            raise AssertionError("last-skip chain: non-finite values")
        del ins, y, grads
    torch.cuda.synchronize()
    return read_counters(('K1w-fwd', 'K1w-bwd'), 'last-skip chain')


def phase1_gates(plan, scratch, n):
    """The ReLU gate that phase 1 of the f32 dW design applied on each
    hidden layer of ``plan``'s ``n`` rows, read from its scratch: the post
    above 0 where the scratch holds it (each hidden layer that feeds
    another), the d_pre not 0 on the last (a boolean tensor a layer)."""
    tab, _ = fm.chain_dw_table(fm.mma_plan(plan), scratch.device)
    rows = scratch.view(-1, tab.total)[:n]
    nh = len(plan.widths) - 1
    out = []
    for i in range(nh):
        col = tab.layers[i + 1].seg1 if i < nh - 1 else tab.layers[i].dpre
        cols = rows[:, col:col + plan.widths[i]]
        out.append(cols > 0 if i < nh - 1 else cols != 0)
    return out


# Rows at which f32 K1-bwd with dW alone is held on the lvis chain's
# weights (f32_dw_by_rows): the rule's largest size for the split-TF32
# design (fused_mlp.F32_DW_TC_MAX_ROWS) and below
F32_DW_SWEEP_ROWS = (2048, 8192, 16384, 32768, 65536)


def f32_dw_by_rows(params, lvis_x, seed=8, iters=10):
    """f32 K1-bwd with dW alone on the lvis chain's weights, on K1's plan
    for K1w's head (NO_LAST_SKIP_PLAN, last_skip_params) and on the lvis
    plan itself (LVIS_PLAN, what f32_chains = lvis runs), at
    F32_DW_SWEEP_ROWS of the lvis rows with a seeded cotangent: the
    split-TF32 design (chain_kernel_bwd_dw_f32_tc), the plain-TF32
    control (``terms`` 1) and the CUDA-core kernel, each leaf's relative
    norm from autograd of the plain f32 version (TF32 off, what
    DW_TOL_F32 holds) and from autograd of the float64 chain (chain_f64),
    the plain f32 version's own from float64 beside them; the rows whose
    smallest |pre-activation| lies within KINK_F32 of a ReLU kink (an f32
    version may gate them either way), the gates of the design's phase 1
    (phase1_gates) that differ from float64's, by layer, and the design's
    dW/db from the float64 gradient under those gates (the witness that
    a gap is the flipped gates' alone); the design's ms against the
    CUDA-core kernel's (CUDA events, in turns), the device ms of each and
    whether the rule sends the launch to the design. Raises where the rule does and the design
    reads beyond DW_TOL_F32."""
    g = torch.Generator().manual_seed(seed)
    p_lvis = fm.params_from_tree(params['lvis_mlp'], params['lvis_out'])
    out = []
    for name, plan, p in (('lvis_no_skip', NO_LAST_SKIP_PLAN,
                           last_skip_params(p_lvis)),
                          ('lvis', LVIS_PLAN, p_lvis)):
        flat = flatten(p)
        for n in F32_DW_SWEEP_ROWS:
            x = lvis_x[:n].contiguous()
            dy = (2 * torch.rand(n, fm.out_dim(plan), generator=g) - 1).cuda()
            leaves = [t.clone().requires_grad_() for t in flat]
            want = torch.autograd.grad(
                fm.chain_reference(plan, x, pairs(leaves)), leaves, dy)
            leaves64 = [t.double().requires_grad_() for t in flat]
            pres = []
            y64, low = chain_f64(plan, x.double(), pairs(leaves64), pres=pres)
            want64 = torch.autograd.grad(y64, leaves64, dy.double())

            def errs(grads):
                got = flatten(grads)
                return ([rel_norm(a, b) for a, b in zip(got, want)],
                        [rel_norm(a.double(), b) for a, b in zip(got, want64)])
            scratch = []
            kernel = fm.chain_kernel_bwd_dw_f32_tc(plan, x, dy, p,
                                                   scratch=scratch)
            gates = phase1_gates(plan, scratch[0], n)
            y64 = chain_f64(plan, x.double(), pairs(leaves64), gates=gates)[0]
            gated = torch.autograd.grad(y64, leaves64, dy.double())
            del y64, scratch
            core = fm.chain_kernel_bwd_cuda_core(plan, x, dy, p, None,
                                                 needs_dx=False)[1]
            k32, k64 = errs(kernel)
            c32, c64 = errs(core)
            row = {'chain': name, 'rows': n, 'dw_tol': DW_TOL_F32,
                   'rule_takes_split_tf32': fm.bwd_on_tensor_cores(
                       plan, None, False, True, x.device, rows=n),
                   'dw_rel_err': max(k32), 'dw_rel_err_by_leaf': k32,
                   'dw_f64_rel_err': max(k64),
                   'dw_f64_rel_err_by_leaf': k64,
                   'cuda_core_dw_rel_err': max(c32),
                   'cuda_core_dw_f64_rel_err': max(c64),
                   'cuda_core_dw_f64_rel_err_by_leaf': c64,
                   'plain_f32_f64_rel_err': max(
                       rel_norm(a.double(), b) for a, b in zip(want, want64)),
                   'control_dw_rel_err': max(errs(
                       fm.chain_kernel_bwd_dw_f32_tc(plan, x, dy, p, 1))[0]),
                   'rows_near_kink': int((low < KINK_F32).sum()),
                   'gates_flipped_by_layer': [int((gt != (q > 0)).sum())
                                              for gt, q in zip(gates, pres)],
                   'dw_rel_err_vs_f64_under_its_gates': max(
                       rel_norm(a.double(), b)
                       for a, b in zip(flatten(kernel), gated))}
            del kernel, core, want, want64, gated, leaves, leaves64, pres
            run = lambda: fm.chain_kernel_bwd_dw_f32_tc(  # noqa: E731
                plan, x, dy, p)
            run_core = lambda: fm.chain_kernel_bwd_cuda_core(  # noqa: E731
                plan, x, dy, p, None, needs_dx=False)
            row['ms'], row['cuda_core_ms'] = time_pair(run, run_core,
                                                       iters=iters)
            row['device_ms'] = device_ms_of(
                run, ('chain_bwd_f32_tc', 'dw_f32'))['device_ms']
            row['cuda_core_device_ms'] = device_ms_of(
                run_core, ('chain_bwd_kernel', 'sum_slices'))['device_ms']
            out.append(row)
            torch.cuda.empty_cache()
    if any(r['rule_takes_split_tf32'] and r['dw_rel_err'] > DW_TOL_F32
           for r in out):
        raise AssertionError("f32 K1-bwd dW in split TF32 beyond %g where "
                             "the rule sends it: %s" % (DW_TOL_F32, out))
    return out


def check_last_skip(params, lvis_x):
    """K1w-fwd and K1w-bwd (dx and dW) against the plain version and
    autograd of it on LAST_SKIP_PLAN with the lvis chain's weights at
    LAST_SKIP_ROWS of the lvis rows, bf16 and f32, with K1's tolerances;
    dW bit-identical across two launches. Witness (last_skip_vs_k1): K1w's
    head column is bit-identical to K1-fwd's on NO_LAST_SKIP_PLAN, and its
    dW/db with dy's head column are K1-bwd's bit for bit (in bf16 both
    run on the tensor cores; there also within K1W_VS_K1_TOL_BF16). The
    bf16 case adds last_skip_tc_readings (the CUDA-core kernels the
    tensor-core ones replace; raises unless K1w-fwd's embedding columns are
    the CUDA-core kernel's). The path runs the same shapes. Returns
    (launches on the path, rows)."""
    g = torch.Generator().manual_seed(7)
    plan = LAST_SKIP_PLAN
    p = last_skip_params(fm.params_from_tree(params['lvis_mlp'],
                                             params['lvis_out']))
    flat = flatten(p)
    cases = []
    for mode, cd in (('bf16', torch.bfloat16), ('f32', None)):
        n = LAST_SKIP_ROWS[mode]
        cases.append((mode, cd, lvis_x[:n].contiguous(), (2 * torch.rand(
            n, fm.out_dim(plan), generator=g) - 1).cuda()))
    launches = run_last_skip_path(cases, p)
    rows = []
    for mode, cd, x, dy in cases:
        n = x.shape[0]
        tol = TOL_BF16 if cd is not None else TOL_F32
        with torch.no_grad():
            y = fm.chain_kernel_last_skip(plan, x, p, cd)
            row = {'chain': 'lvis_last_skip', 'rows': n, 'dtype': mode,
                   'out_cols': y.shape[1],
                   'max_abs_err': compare('K1w-fwd %s' % mode, y,
                                          fm.chain_reference(plan, x, p, cd),
                                          tol)}
        leaves = [t.clone().requires_grad_() for t in flat]
        xg = x.clone().requires_grad_()
        y_p = fm.chain_reference(plan, xg, pairs(leaves), cd)
        want = torch.autograd.grad(y_p, [xg] + leaves, dy, retain_graph=True)
        dx, got = fm.chain_kernel_last_skip_bwd(plan, x, dy, p, cd)
        dw_tol = NORM_TOL_BF16 if cd is not None else DW_TOL_F32
        row['dw_tol'] = dw_tol
        row['dw_rel_err'] = check_norm('K1w-bwd dW/db %s' % mode, [
            rel_norm(a, b) for a, b in zip(flatten(got), want[1:])], dw_tol)
        row['dx_rel_err'] = check_norm(
            'K1w-bwd dx %s' % mode, [rel_norm(dx, want[0])],
            NORM_TOL_BF16 if cd is not None else DW_TOL_F32)
        if cd is not None:
            # What a kernel that computed the f32 gradient would read
            dx32, got32 = fm.chain_kernel_last_skip_bwd(plan, x, dy, p, None)
            row['f32_kernel_dw_rel_err'] = max(
                rel_norm(a, b) for a, b in zip(flatten(got32), want[1:]))
            row['f32_kernel_dx_rel_err'] = rel_norm(dx32, want[0])
            del dx32, got32
        row['dx_max_abs_err'] = (dx - want[0]).abs().max().item()
        again = fm.chain_kernel_last_skip_bwd(plan, x, dy, p, cd)[1]
        row['dw_bit_identical'] = all(torch.equal(a, b) for a, b in zip(
            flatten(got), flatten(again)))
        if not row['dw_bit_identical']:
            raise AssertionError("K1w-bwd: dW differs between two launches "
                                 "on the same inputs")
        row.update(last_skip_vs_k1(x, dy, p, cd, y, got))
        dw_ok = row['dw_same_as_k1'] and (
            cd is None or row['dw_rel_err_vs_k1'] <= K1W_VS_K1_TOL_BF16)
        if not (row['head_same_as_k1'] and dw_ok):
            raise AssertionError("K1w %s: head or dW differs from K1's on the "
                                 "plan without the last skip: %s" % (mode, row))
        del got, again, y
        with torch.no_grad():
            row['ms'], row['plain_ms'] = time_pair(
                lambda: fm.chain_kernel_last_skip(plan, x, p, cd),
                lambda: fm.chain_reference(plan, x, p, cd), iters=10)
        row['bwd_ms'], row['bwd_plain_ms'] = time_pair(
            lambda: fm.chain_kernel_last_skip_bwd(plan, x, dy, p, cd),
            lambda: torch.autograd.grad(y_p, [xg] + leaves, dy,
                                        retain_graph=True), iters=10)
        del y_p, want
        if fm.bwd_on_tensor_cores(plan, cd, True, True, x.device):
            row.update(last_skip_tc_readings(x, dy, p, cd, row['bwd_ms']))
        rows.append(row)
    return launches, rows


def k1_limit_readings(model, seeds):
    """What K1's bf16 bounds rest on, at the joint step's shapes, over
    ``seeds`` (each seeding the lvis chain's weights, drawn as the shape
    model initialises them, and the inputs): bf16 K1-bwd lvis with dW only
    (the tensor cores) and the f32 kernel against autograd of the plain
    bf16 version (worst dW/db leaf), and K1w against K1 on those weights
    at LAST_SKIP_ROWS['bf16'] rows (last_skip_vs_k1)."""
    plan, cd = model.plans['lvis'], model.chain_dtype('lvis')
    out = []
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        p = [(w.cuda(), b.cuda()) for w, b in fm.params_from_tree(
            model.specs['lvis_mlp'].init(g), model.specs['lvis_out'].init(g))]
        _, x, _ = step_inputs(model, g)
        dy = (2 * torch.rand(x.shape[0], 1, generator=g) - 1).cuda()
        leaves = [t.clone().requires_grad_() for t in flatten(p)]
        want = torch.autograd.grad(fm.chain_reference(plan, x, pairs(leaves),
                                                      cd), leaves, dy)

        def worst(dtype):
            got = fm.chain_kernel_bwd(plan, x, dy, p, dtype, needs_dx=False)[1]
            return max(rel_norm(a, b) for a, b in zip(flatten(got), want))
        r = {'seed': seed, 'rows': x.shape[0], 'dw_rel_err': worst(cd),
             'f32_kernel_dw_rel_err': worst(None)}
        del want, leaves
        n = LAST_SKIP_ROWS['bf16']
        xs, pk = x[:n].contiguous(), last_skip_params(p)
        dyw = (2 * torch.rand(n, fm.out_dim(LAST_SKIP_PLAN), generator=g)
               - 1).cuda()
        with torch.no_grad():
            y = fm.chain_kernel_last_skip(LAST_SKIP_PLAN, xs, pk, cd)
        got = fm.chain_kernel_last_skip_bwd(LAST_SKIP_PLAN, xs, dyw, pk, cd)[1]
        r.update(last_skip_vs_k1(xs, dyw, pk, cd, y, got))
        out.append(r)
        del x, xs, dy, dyw, y, got
        torch.cuda.empty_cache()
    return out


def k1r_limit_readings(model, seeds):
    """What K1r's bf16 bounds rest on, at the joint step's shapes, over
    ``seeds`` (each seeding the lvis chain's weights, drawn as the shape
    model initialises them, and the inputs), on the stash route: bf16
    K1r-bwd with dW only over K1r-fwd's bf16 stash (the tensor cores), the
    CUDA-core bf16 K1r-bwd over the same stash and the f32 kernel over its
    own against autograd of the plain bf16 stash route (worst dW/db leaf),
    and the tensor-core against the CUDA-core kernel; K1r-fwd's output
    against the plain bf16 stash route (max error, the atol it needs at
    TOL_BF16's rtol) and whether its stash is the CUDA-core kernel's."""
    plan, cd = model.plans['lvis'], model.chain_dtype('lvis')
    out = []
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        p = [(w.cuda(), b.cuda()) for w, b in fm.params_from_tree(
            model.specs['lvis_mlp'].init(g), model.specs['lvis_out'].init(g))]
        _, x, _ = step_inputs(model, g)
        dy = (2 * torch.rand(x.shape[0], 1, generator=g) - 1).cuda()
        with torch.no_grad():
            y, stash = fm.chain_kernel_stash(plan, x, p, cd, with_stash=True)
            stash_core = fm.chain_kernel_stash_cuda_core(plan, x, p, cd,
                                                         with_stash=True)[1]
            stash32 = fm.chain_kernel_stash(plan, x, p, None,
                                            with_stash=True)[1]
            plain = fm.chain_reference_stash(plan, x, p, cd)
            r = {'seed': seed, 'rows': x.shape[0],
                 'fwd_max_abs_err': (y - plain).abs().max().item(),
                 'fwd_atol_needed': atol_needed([y], [plain], TOL_BF16[1],
                                                slice(None)),
                 'stash_same_as_cuda_core': torch.equal(stash, stash_core)}
            del y, plain, stash_core
        leaves = [t.clone().requires_grad_() for t in flatten(p)]
        want = torch.autograd.grad(fm.chain_reference_stash(
            plan, x, pairs(leaves), cd), leaves, dy)
        del leaves
        got = flatten(fm.chain_kernel_stash_bwd(plan, x, dy, stash, p, cd,
                                                needs_dx=False)[1])
        core = flatten(fm.chain_kernel_stash_bwd_cuda_core(
            plan, x, dy, stash, p, cd, needs_dx=False)[1])
        got32 = flatten(fm.chain_kernel_stash_bwd(plan, x, dy, stash32, p,
                                                  None, needs_dx=False)[1])
        r.update(dw_rel_err=worst_leaf(got, want),
                 cuda_core_dw_rel_err=worst_leaf(core, want),
                 f32_kernel_dw_rel_err=worst_leaf(got32, want),
                 tc_vs_cuda_core_dw_rel_err=worst_leaf(got, core))
        out.append(r)
        del x, dy, stash, stash32, want, got, core, got32
        torch.cuda.empty_cache()
    return out


def k1w_limit_readings(model, seeds):
    """What K1w's bf16 bounds rest on, at the last-skip path's shape
    (LAST_SKIP_ROWS['bf16'] of the joint step's lvis rows), over ``seeds``
    (each seeding the lvis chain's weights, drawn as the shape model
    initialises them and cut to LAST_SKIP_PLAN, and the inputs): K1w-fwd
    on the tensor cores against the plain bf16 version (max error, the
    atol it needs at TOL_BF16's rtol) and whether its embedding columns
    are the CUDA-core kernel's; K1w-bwd with dx and dW, of the tensor-core,
    the CUDA-core bf16 and the f32 kernels, against autograd of the plain
    bf16 version (dx and the worst dW/db leaf, relative norm), and the
    tensor-core against the CUDA-core kernel; K1w against K1
    (last_skip_vs_k1)."""
    plan, cd = LAST_SKIP_PLAN, model.chain_dtype('lvis')
    out = []
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        p = last_skip_params([(w.cuda(), b.cuda()) for w, b in
                              fm.params_from_tree(
                                  model.specs['lvis_mlp'].init(g),
                                  model.specs['lvis_out'].init(g))])
        x = step_inputs(model, g)[1][:LAST_SKIP_ROWS['bf16']].contiguous()
        dy = (2 * torch.rand(x.shape[0], fm.out_dim(plan), generator=g)
              - 1).cuda()
        with torch.no_grad():
            y = fm.chain_kernel_last_skip(plan, x, p, cd)
            core = fm.chain_kernel_last_skip_cuda_core(plan, x, p, cd)
            plain = fm.chain_reference(plan, x, p, cd)
            r = {'seed': seed, 'rows': x.shape[0],
                 'fwd_max_abs_err': (y - plain).abs().max().item(),
                 'fwd_atol_needed': atol_needed([y], [plain], TOL_BF16[1],
                                                slice(None)),
                 'embed_same_as_cuda_core': torch.equal(y[:, 1:],
                                                        core[:, 1:])}
            del plain, core
        leaves = [t.clone().requires_grad_() for t in flatten(p)]
        xg = x.clone().requires_grad_()
        want = torch.autograd.grad(fm.chain_reference(
            plan, xg, pairs(leaves), cd), [xg] + leaves, dy)
        del leaves, xg
        got = fm.chain_kernel_last_skip_bwd(plan, x, dy, p, cd)
        core = fm.chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, p, cd)
        got32 = fm.chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, p,
                                                        None)
        for key, (dx, dw) in (('', got), ('cuda_core_', core),
                              ('f32_kernel_', got32)):
            r[key + 'dx_rel_err'] = rel_norm(dx, want[0])
            r[key + 'dw_rel_err'] = worst_leaf(flatten(dw), want[1:])
        r.update(tc_vs_cuda_core_dx_rel_err=rel_norm(got[0], core[0]),
                 tc_vs_cuda_core_dw_rel_err=worst_leaf(flatten(got[1]),
                                                       flatten(core[1])))
        r.update(last_skip_vs_k1(x, dy, p, cd, y, got[1]))
        out.append(r)
        del x, dy, y, want, got, core, got32
        torch.cuda.empty_cache()
    return out


def sass_hmma(names):
    """Per kernel of the built library whose mangled name holds one of
    ``names``: its HMMA (mma.sync) and HGMMA (wgmma) tensor-core
    instructions in ``cuobjdump --dump-sass``, one entry per copy of the
    kernel."""
    tool = join(dirname(kernel_lib.find_nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '--dump-sass', kernel_lib.build()],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, fn = [], None
    for line in sass.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            fn = m.group(1) if any(n in m.group(1) for n in names) else None
            if fn:
                out.append({'function': fn, 'hmma': 0, 'hgmma': 0})
        elif fn and 'HMMA' in line:
            out[-1]['hmma'] += 1
        elif fn and 'HGMMA' in line:
            out[-1]['hgmma'] += 1
    return out


TC_KERNELS = ('chain_fwd_tc_kernel', 'chain_stash_fwd_tc_kernel',
              'chain_last_skip_fwd_tc_kernel', 'nerf_fwd_tc_kernel',
              'rusink_chain_fwd_tc_kernel', 'chain_bwd_tc_kernel',
              'chain_stash_bwd_tc_kernel', 'chain_last_skip_bwd_tc_kernel',
              'nerf_bwd_tc_kernel', 'rusink_chain_bwd_tc_kernel', 'dw_kernel',
              'chain_dx_pass_kernel', 'chain_fwd_f32_tc_kernel',
              'chain_dx_f32_tc_kernel', 'chain_bwd_f32_tc_kernel',
              'dw_f32_kernel')


def hmma_of(kernels, *names):
    """The entries of sass_hmma's ``kernels`` whose function is one of
    ``names`` (named)."""
    return [k for k in kernels if named(k['function'], names)]


def check_tc_sass():
    """The tensor-core kernels run their products on the tensor cores:
    every copy of K1-fwd's, K1r-fwd's, K1w-fwd's, K2-fwd's and K3-fwd's
    bf16 tensor-core kernels, of K2-bwd's, of each phase 1 (K1r-bwd's and
    K1w-bwd's too), of the dW pass, of K1w-bwd's dx pass and of K1's f32
    forward and dx-only backward (TF32 HMMA) in the library holds HMMA
    instructions."""
    kernels = sass_hmma(TC_KERNELS)
    for name in TC_KERNELS:
        found = hmma_of(kernels, name)
        if not found or not all(k['hmma'] for k in found):
            raise AssertionError("%s: no HMMA in the built kernels: %s"
                                 % (name, kernels))
    return kernels


def step_loss_grads(model, params, arrays, transposed):
    """make_train_step's loss and gradients of the trainable leaves on the
    chain route ``transposed`` (fused_mlp.TRANSPOSED_BOUNDARY), with the
    jitter noise drawn from one seed."""
    saved = fm.TRANSPOSED_BOUNDARY
    fm.TRANSPOSED_BOUNDARY = transposed
    try:
        mask = ckptutil.tree_leaves(model.trainable_mask(params))
        live = ckptutil.tree_map(lambda t: t.detach(), params)
        wrt = [t.requires_grad_() for t, m in zip(ckptutil.tree_leaves(live),
                                                  mask) if m]
        gen = torch.Generator(device='cuda').manual_seed(0)
        with torch.enable_grad():
            pred, gt, loss_kwargs, _ = model.apply(
                live, upcast_batch(arrays), mode='train', generator=gen)
            loss = torch.mean(model.compute_loss(live, pred, gt,
                                                 **loss_kwargs))
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        return loss.detach(), grads
    finally:
        fm.TRANSPOSED_BOUNDARY = saved


def run_stash_step(config):
    """The joint train step on the stash route (TRANSPOSED_BOUNDARY =
    False): its loss and every trainable leaf's gradient against the
    default route's on one batch (loss within TOL_BF16, each gradient
    leaf's relative norm within NORM_TOL_BF16); then its steady-state
    step time through make_train_step, with the kernels' counters zeroed
    before and read after. Returns (step record, launches)."""
    model = Model(config, device='cuda')
    dataset = Dataset(config, 'train')
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = next(iter(dataset.build_pipeline(prefetch=0)))
    arrays = {k: torch.as_tensor(np.asarray(batch[k])).cuda()
              for k in dataset.array_keys}
    loss_t, grads_t = step_loss_grads(model, params, arrays, True)
    loss_s, grads_s = step_loss_grads(model, params, arrays, False)
    errs = [rel_norm(a, b) for a, b in zip(grads_s, grads_t)
            if a is not None and b is not None and b.norm() > 0]
    check = {'loss_default': loss_t.item(), 'loss_stash': loss_s.item(),
             'loss_abs_err': compare('stash-route step loss', loss_s[None],
                                     loss_t[None], TOL_BF16),
             'grad_leaves': len(errs),
             'grad_rel_err': check_norm('stash-route step gradients', errs,
                                        NORM_TOL_BF16),
             'grad_tol': NORM_TOL_BF16}
    del grads_t, grads_s, params
    fm.TRANSPOSED_BOUNDARY = False
    try:
        zero_counters()
        step = time_train_step(model, dataset)
        torch.cuda.synchronize()
        launches = read_counters(('K1r-fwd', 'K1r-fwd tc', 'K1r-bwd',
                                  'K1r-bwd tc', 'K2-fwd tc', 'K2-bwd tc'),
                                 'stash-route training step')
    finally:
        fm.TRANSPOSED_BOUNDARY = True
    if launches['K1-fwd'] or launches['K1-bwd']:
        raise AssertionError("K1 launched on the stash route: %s" % launches)
    per_step = step['launches_per_step']
    if per_step.get('K1r-fwd tc') != 1 or per_step.get('K1r-bwd tc') != 1:
        raise AssertionError("stash-route step: the lvis chain's K1r launches "
                             "a step off the tensor cores: %s" % per_step)
    return dict(step, agreement=check), launches


def run_chain_probe():
    """tools.chain_probe at its defaults (524,288 rows, the 128 x 4 lvis
    chain, forward and backward) in bf16, for each impl, with the
    counters zeroed before and read after each: fused must launch K1,
    fused_rowmajor K1r and ref no chain kernel. Returns ({impl: record},
    {impl: launches})."""
    expect = {'fused': ('K1-fwd', 'K1-fwd tc', 'K1-bwd'),
              'fused_rowmajor': ('K1r-fwd', 'K1r-bwd'), 'ref': ()}
    records, launches = {}, {}
    for impl, kernels in expect.items():
        zero_counters()
        records[impl] = chain_probe.main(['--impl', impl, '--mode', 'both',
                                          '--compute_dtype', 'bf16'])
        torch.cuda.synchronize()
        launches[impl] = read_counters(kernels, 'chain_probe ' + impl)
        chain = [k for k in ('K1-fwd', 'K1-bwd', 'K1r-fwd', 'K1r-bwd')
                 if launches[impl][k] and k not in kernels]
        if chain or not np.isfinite(records[impl]['checksum']):
            raise AssertionError("chain_probe %s: %s, launched %s" % (
                impl, records[impl], chain))
    return records, launches


P_COLS = 4096
SLOPE_DEPTHS = (4, 16)


def slope_ms(run_at_depth):
    """ms per pass of a chain: the slope of CUDA-event time between depths
    SLOPE_DEPTHS (what does not grow with depth cancels)."""
    t = [time_ms(lambda d=d: run_at_depth(d), iters=10) for d in SLOPE_DEPTHS]
    return (t[1] - t[0]) / (SLOPE_DEPTHS[1] - SLOPE_DEPTHS[0])


def p_check(kernel, xs, ws, mode, block):
    """One reading of a kernel P design against the plain version; raises
    past dp.TOL or on a non-finite output."""
    got = kernel(xs, ws, mode, block=block)
    want = dp.dot_chain_reference(xs, ws, mode)
    err = rel_norm(got, want)
    if not torch.isfinite(got).all() or err > dp.TOL[mode]:
        raise AssertionError(
            "P (%s) %s depth %d, %d rows, block %d: relative error %.3g > %g"
            % (kernel.__name__, mode, ws.shape[0], xs.shape[0], block, err,
               dp.TOL[mode]))
    return {'mode': mode, 'depth': ws.shape[0], 'rows': xs.shape[0],
            'block': block, 'rel_err': err, 'tol': dp.TOL[mode],
            'max_abs_err': (got - want).abs().max().item()}


def p_build_report():
    """Kernel P's build: ptxas's registers and spills, its notes that it
    serialized wgmma (per kernel), and the SASS HGMMA / HMMA counts; raises
    unless every copy of the wgmma kernel holds HGMMA and no HMMA and
    spills nothing."""
    with open(join(dirname(kernel_lib.build()), 'build.log')) as f:
        log = f.read()
    notes = sorted(set(re.findall(
        r"\((C75\d\d)\) Potential Performance Loss: wgmma.mma_async "
        r"instructions are serialized due to (.*?) in the function '(\w+)'",
        log)))
    ptxas = ptxas_report(('dot_chain_wg', 'dot_pack'))
    sass = sass_hmma(('dot_chain_wg_kernel', 'dot_pack_kernel',
                      'dot_chain_mma_kernel'))
    wg_sass = [k for k in sass if 'dot_chain_wg_kernel' in k['function']]
    if len(wg_sass) != 3 or not all(k['hgmma'] and not k['hmma']
                                    for k in wg_sass):
        raise AssertionError("P: the wgmma kernel's SASS: %s" % wg_sass)
    if any(v['spill_stores'] or v['spill_loads'] for v in ptxas.values()):
        raise AssertionError("P: ptxas spills: %s" % ptxas)
    return {'ptxas': ptxas, 'sass': sass,
            'wgmma_serialized': [{'note': n, 'why': why, 'function': fn}
                                 for n, why, fn in notes
                                 if 'dot_chain_wg' in fn]}


def check_dot_probe():
    """Kernel P (wgmma) and its mma.sync control against the plain version
    at width 128: at P_COLS rows, depths 4 and 8, every mode; at the shapes
    the probe's path gives it (its default rows and block at its
    shallowest and deepest default depth, every mode; the grid sweep's
    serial depth-8 chain at each of its blocks). Then the probe's path,
    tools.dot_probe at its defaults (1,048,576 rows, depths 12-32, slope
    per mode) and its grid sweep, with the counters zeroed before and read
    after; the control's slopes and sweep by the same tool in the same
    run, in turns (kernel, control, control, kernel); the kernel's device
    ms a launch at depth 32 from a profiler window (over the launches it
    recorded) and its TFLOP/s; then the plain version's and one
    torch.matmul per pass's slope (bf16 operands, bf16 out: the serial
    pass as cuBLAS computes it) on the probe's operand. Returns (launches,
    record)."""
    rng = np.random.RandomState(8)
    gen = torch.Generator(device='cuda').manual_seed(8)
    args = dot_probe.parse_args([])
    sweep_args = dot_probe.parse_args(['--grid_sweep'])
    cols, depths = args.cols, [int(d) for d in args.depths.split(',')]
    x = 0.1 * torch.randn(P_COLS, dp.WIDTH, generator=gen, device='cuda')
    xl = 0.1 * torch.randn(cols, dp.WIDTH, generator=gen, device='cuda')
    shapes = [(x, depth, mode, 1024) for depth in (4, 8) for mode in dp.MODES]
    shapes += [(xl, depth, mode, args.block)
               for depth in (min(depths), max(depths)) for mode in dp.MODES]
    shapes += [(xl, 8, 'serial', block) for block in dot_probe.SWEEP_BLOCKS]
    checks, control_checks = [], []
    for xs, depth, mode, block in shapes:
        ws = dot_probe.make_weights(rng, depth, dp.WIDTH, 'cuda')
        checks.append(p_check(dp.dot_chain_kernel, xs, ws, mode, block))
        control_checks.append(p_check(dp._dot_chain_mma, xs, ws, mode,
                                      block))
    build = p_build_report()
    zero_counters()
    summary = dot_probe.main([])
    sweep = dot_probe.main(['--grid_sweep'])
    torch.cuda.synchronize()
    launches = read_counters(('P',), 'dot_probe')
    control = [dot_probe.run(args, chain=dp._dot_chain_mma)
               for _ in range(2)]
    control_sweep = dot_probe.run(sweep_args, chain=dp._dot_chain_mma)
    summary_again = dot_probe.run(args)
    # Device ms a launch over the launches the window recorded
    ws = dot_probe.make_weights(rng, max(depths), dp.WIDTH, 'cuda')
    us, seen = profiled_device_us(
        lambda: dp.dot_chain_kernel(xl, ws, 'serial', block=args.block), 10)
    device = {'depth': max(depths), 'launches_run': 10}
    for key, name in (('chain', 'dot_chain_wg_kernel'),
                      ('pack', 'dot_pack_kernel')):
        n = sum(c for k, c in seen.items() if name in k)
        if not n:
            raise AssertionError("P: the profiler window recorded no %s"
                                 % name)
        device[key + '_device_ms'] = sum(
            v for k, v in us.items() if name in k) / 1e3 / n
        device[key + '_recorded'] = n
    pass_flop = 2 * dp.WIDTH * dp.WIDTH * cols
    device['tflops'] = pass_flop * max(depths) / (
        device['chain_device_ms'] * 1e-3) / 1e12
    ws = dot_probe.make_weights(rng, max(SLOPE_DEPTHS), dp.WIDTH,
                                'cuda')

    def matmul_chain(d):
        y = xl.to(torch.bfloat16)
        for w in ws[:d]:
            y = torch.matmul(y, w.t())
        return y
    with torch.no_grad():
        plain = slope_ms(lambda d: dp.dot_chain_reference(xl, ws[:d],
                                                          'serial'))
        library = slope_ms(matmul_chain)
    return launches, {
        'checks': checks, 'summary': summary, 'sweep': sweep,
        'summary_again': summary_again,
        'mma_sync_control': {'checks': control_checks, 'summary': control,
                             'sweep': control_sweep},
        'device_ms_a_launch': device, 'build': build,
        'cols': cols, 'plain_ms_per_pass': plain,
        'library_ms_per_pass': library}


# ------ geometry distillation (the NeRF -> buffers stage) ------

# Distillation runs every view of the scene at imh 64 (a cut from the
# scene's 128: every pixel of a barely trained NeRF is a hit, and each hit
# marches 512 lights x 320 samples); light_h 16 and the CLI's defaults
# otherwise (mlp_chunk 1,048,576: 3,276-ray depth/normal blocks, 51-point
# visibility blocks). Its data root is the scene's cameras with photos at
# imh 64: the shape stage that trains on the buffers reads the photos at
# the buffers' size (its dataset resizes them only with the buffers, as
# the JAX package's and the reference's)
DISTILL_IMH = 64
DISTILL_DATA = join(WORK, 'data_distill')
DISTILL_VIEWS = ['test_%03d' % i for i in range(N_VIEWS)] \
    + ['train_%03d' % i for i in range(N_TRAIN)] \
    + ['val_%03d' % i for i in range(N_VALI)]
DISTILL_FILES = ('alpha.png', 'xyz.npy', 'xyz.png', 'normal.npy',
                 'normal.png', 'lvis.npy', 'lvis.png')
# The card's distillation against the port's CPU run on the same rays and
# surface points, each limit 7-10x the largest of its readings on three
# sets of rays of a test view (PERF.md §6): occupancy, depth and normal
# from the f32 depth/normal pass (the importance samples move with the
# coarse pass's rounding, and the normal is the field's gradient, one more
# factor of the octave); visibility from the bf16 march on the tensor
# cores against the plain bf16 version (under one pair in a hundred parts
# by more than the p99, those by far more: the mean exceeds the p99). The
# controls must each break a limit of their pass: the depth/normal pass
# with its sigma chain in bf16, and the march without the 64 samples the
# reference adds to each of NeRF's counts. The f32 march against the CPU's bf16 march is read too,
# with no limit: end to end it parts from the sound march by under 2x (the
# sigma chain's own check holds the kernel's rounding).
DISTILL_TOL = {'occu_max_abs': 5e-4, 'depth_rel_norm': 5e-4,
               'normal_rel_norm': 1e-2, 'lvis_mean_abs': 5e-3,
               'lvis_p99_abs': 3e-3}
DISTILL_DN_KEYS = ('occu_max_abs', 'depth_rel_norm', 'normal_rel_norm')
DISTILL_LVIS_KEYS = ('lvis_mean_abs', 'lvis_p99_abs')
DISTILL_CPU_RAYS, DISTILL_CPU_POINTS = 256, 16
# f32 K1-bwd dx of the sigma chain over all rows of a depth/normal block,
# relative norm (check_sigma_chain)
SIGMA_DX_TOL_F32 = 1e-2
# Wrapper calls in each profiler window of check_sigma_chain
SIGMA_WINDOW_CALLS = 5


def distill_args(nerf_dir, out_root, *extra):
    return ['--trained_nerf', nerf_dir, '--out_root', out_root,
            '--data_root', DISTILL_DATA, '--imh', str(DISTILL_IMH),
            '--light_h', str(LIGHT_H)] + list(extra)


def distiller_on(nerf_dir, device, *extra):
    """geometry_from_nerf's distiller on ``device`` as its CLI builds it
    from run_distillation's flags and ``extra``: (distiller, config)."""
    args = geometry_from_nerf.parse_args(
        distill_args(nerf_dir, 'unused', '--device', device, *extra))
    return geometry_from_nerf.load_distiller(args)[:2]


def distill_view_rays(nerf_dir):
    """The first test view's rays at DISTILL_IMH, unit directions."""
    _, config = distiller_on(nerf_dir, 'cpu')
    batch = next(iter(NerfDataset(config, 'test')
                      .build_pipeline(no_shuffle=True, prefetch=0)))
    rayd = np.asarray(batch['rayd'], np.float32)
    return (np.asarray(batch['rayo'], np.float32),
            rayd / np.linalg.norm(rayd, axis=1, keepdims=True))


def run_distillation(nerf_dir):
    """The distillation path through geometry_from_nerf.main on the NeRF
    run's latest checkpoint (its ckpt-4) at nerf.ini's full width, every
    view of DISTILL_DATA (the scene at DISTILL_IMH), with the counters
    zeroed before and read after: K1-fwd on the tensor cores in bf16 (the
    march) and in split TF32 (the depth/normal pass's two forwards a
    block), K1-bwd with dx alone in split TF32 (one a block), and no
    CUDA-core K1, bf16 tensor-core K1-bwd or dW pass. Checks the buffers.
    Returns (launches, out_root, record)."""
    out_root = join(WORK, 'out', 'surf')
    write_scene(DISTILL_DATA, None, imh=DISTILL_IMH)
    zero_counters()
    t0 = time.perf_counter()
    run = geometry_from_nerf.main(distill_args(nerf_dir, out_root))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(('K1-fwd', 'K1-fwd tc', 'K1-fwd f32 tc',
                              'K1-bwd', 'K1-bwd dx tc'), 'distillation')
    blocks = launches['K1-bwd dx tc']
    if launches['K1-fwd f32 tc'] != 2 * blocks \
            or launches['K1-fwd'] != launches['K1-fwd tc'] + 2 * blocks:
        raise AssertionError("distillation: not two f32 tensor-core K1-fwd "
                             "a depth/normal block, or a CUDA-core K1-fwd: "
                             "%s" % launches)
    if launches['K1-bwd'] != blocks or launches['K1-bwd tc'] \
            or launches['K1-bwd dW']:
        raise AssertionError("distillation: a K1-bwd off the f32 dx-only "
                             "tensor-core kernel (chain_bwd_kernel, the "
                             "bf16 design or a dW pass): %s" % launches)
    if sorted(r['id'] for r in run['views']) != sorted(DISTILL_VIEWS):
        raise AssertionError("distillation views: %s" % run['views'])
    hw = (DISTILL_IMH, DISTILL_IMH)
    fg = {}
    for view in DISTILL_VIEWS:
        d = join(out_root, view)
        files = set(os.listdir(d))
        if not set(DISTILL_FILES) <= files or not files & {'lvis.mp4',
                                                           'lvis.apng'}:
            raise AssertionError("distillation %s: files %s" % (view, files))
        alpha = ioutil.load_img(join(d, 'alpha.png'))
        xyz, normal, lvis = (np.load(join(d, k + '.npy'))
                             for k in ('xyz', 'normal', 'lvis'))
        norms = np.linalg.norm(normal, axis=2)
        if alpha.shape != hw or xyz.shape != hw + (3,) \
                or normal.shape != hw + (3,) or lvis.shape != hw + (N_LIGHTS,):
            raise AssertionError("distillation %s: shapes %s %s %s %s" % (
                view, alpha.shape, xyz.shape, normal.shape, lvis.shape))
        if not (alpha > 0).any() or not np.isfinite(xyz).all() \
                or np.abs(norms - 1).max() > 1e-3 \
                or not 0 <= lvis.min() <= lvis.max() <= 1:
            raise AssertionError(
                "distillation %s: foreground %d, |normal| in [%.4g, %.4g], "
                "lvis in [%.4g, %.4g]" % (view, (alpha > 0).sum(),
                                           norms.min(), norms.max(),
                                           lvis.min(), lvis.max()))
        fg[view] = {'alpha_gt_0': int((alpha > 0).sum()),
                    'alpha_gt_0.5': int((alpha > 0.5).sum()),
                    'lvis_mean': float(lvis.mean())}
    return launches, out_root, {
        'imh': DISTILL_IMH, 'n_lights': N_LIGHTS, 'seconds': wall,
        'views': run['views'], 'foreground': fg}


def sigma_in_bf16(dist):
    """The depth/normal control: ``dist`` with its sigma chain in bf16,
    the precision the f32 pass must not run at."""
    f32 = dist._sigma_with_bounds
    dist._sigma_with_bounds = lambda pts, use_fine, compute_dtype=None: f32(
        pts, use_fine, torch.bfloat16)
    return dist


def without_extra_samples(dist):
    """The march control: ``dist`` without the 64 samples the reference
    adds to each of NeRF's sample counts."""
    dist.n_coarse -= 64
    dist.n_fine -= 64
    return dist


def distill_diffs(got, want):
    """The readings of DISTILL_TOL between two (occupancy, depth, normal,
    lvis) tuples."""
    (o_g, d_g, n_g, l_g), (o_w, d_w, n_w, l_w) = got, want
    lvis_diff = np.abs(l_g - l_w)
    return {'occu_max_abs': float(np.abs(o_g - o_w).max()),
            'depth_rel_norm': rel_norm(torch.from_numpy(d_g),
                                       torch.from_numpy(d_w)),
            'normal_rel_norm': rel_norm(torch.from_numpy(n_g),
                                        torch.from_numpy(n_w)),
            'lvis_mean_abs': float(lvis_diff.mean()),
            'lvis_p99_abs': float(np.quantile(lvis_diff, 0.99))}


def distill_readings(nerf_dir, rays):
    """The card's two passes against the port's CPU run (the plain
    versions) on the same inputs: ``rays`` (occupancy, depth, normal), and
    DISTILL_CPU_POINTS of them spread along the set, at their surface
    points and normals distilled on the card, against all 512 lights.
    Returns (the readings of DISTILL_TOL; those of the controls, each
    against the same CPU run: the card's depth/normal pass with its sigma
    chain in bf16, and its march without the reference's 64 extra samples
    a level; the f32 march's lvis readings; the CPU run's occupancy
    range)."""
    pick = slice(None, None, rays[0].shape[0] // DISTILL_CPU_POINTS)
    dist, _ = distiller_on(nerf_dir, 'cuda')
    occu, depth, normal = dist.compute_depth_and_normal(*rays)
    surf = rays[0][pick] + rays[1][pick] * depth[pick, None]
    nrm = normal[pick] / np.maximum(
        np.linalg.norm(normal[pick], axis=1, keepdims=True), 1e-12)
    card_out = (occu, depth, normal,
                dist.compute_light_visibility(surf, nrm))
    ctl_dn = sigma_in_bf16(dist).compute_depth_and_normal(*rays)
    del dist
    dist, _ = distiller_on(nerf_dir, 'cuda')
    ctl_lvis = without_extra_samples(dist).compute_light_visibility(surf, nrm)
    del dist
    dist, _ = distiller_on(nerf_dir, 'cuda', '--no-bf16_march')
    f32_lvis = dist.compute_light_visibility(surf, nrm)
    del dist
    dist, _ = distiller_on(nerf_dir, 'cpu')
    cpu_out = dist.compute_depth_and_normal(*rays) \
        + (dist.compute_light_visibility(surf, nrm),)
    f32_march = distill_diffs(card_out[:3] + (f32_lvis,), cpu_out)
    return (distill_diffs(card_out, cpu_out),
            distill_diffs(ctl_dn + (ctl_lvis,), cpu_out),
            {k: f32_march[k] for k in DISTILL_LVIS_KEYS},
            [float(cpu_out[0].min()), float(cpu_out[0].max())])


def check_distillation(nerf_dir, view_rays):
    """distill_readings on DISTILL_CPU_RAYS rays of ``view_rays`` (a test
    view's) across the middle of the image: the card within DISTILL_TOL,
    and each control beyond a limit of its pass. Returns the readings
    beside DISTILL_TOL."""
    start = DISTILL_IMH * DISTILL_IMH // 2
    rays = [a[start:start + DISTILL_CPU_RAYS] for a in view_rays]
    got, control, f32_march, occu_range = distill_readings(nerf_dir, rays)
    bad = {k: v for k, v in got.items() if not v <= DISTILL_TOL[k]}
    if bad:
        raise AssertionError("distillation on the card vs the CPU: %s "
                             "beyond %s (all: %s; controls: %s)" % (
                                 bad, DISTILL_TOL, got, control))
    for name, keys in (('bf16 depth/normal', DISTILL_DN_KEYS),
                       ('fewer samples march', DISTILL_LVIS_KEYS)):
        if all(control[k] <= DISTILL_TOL[k] for k in keys):
            raise AssertionError(
                "distillation: the %s control is within %s: %s" % (
                    name, {k: DISTILL_TOL[k] for k in keys}, control))
    return dict(got, tol=DISTILL_TOL, control=control,
                f32_march=f32_march, rays=DISTILL_CPU_RAYS,
                points=DISTILL_CPU_POINTS, lights=N_LIGHTS,
                occu_range=occu_range)


def plain_in_chunks(plan, x, p, cd, rows=1 << 20):
    """chain_reference over ``rows``-row slices of ``x``, concatenated:
    the plain version at a visibility block's 8M rows, whose f32 products
    of 256-wide activations would take ~8.5 GB a layer at once."""
    return torch.cat([fm.chain_reference(plan, x[i:i + rows], p, cd)
                      for i in range(0, x.shape[0], rows)])


def sigma_chain_inputs(dist, view_rays):
    """The sigma chain's inputs at distillation's three block shapes: one
    visibility block's fine level (lvis_block_pts surface points on the
    sphere x 512 lights x 320 depths in [0.1, lvis_far]), and one
    depth/normal block's fine level (ray_block rays of a view x 320 depths
    in [near, far]) and coarse level (x 128 depths), at evenly spaced
    depths."""
    n_total = dist.n_coarse + dist.n_fine
    g = torch.Generator().manual_seed(6)
    surf = torch.randn(dist.lvis_block_pts, 3, generator=g)
    surf = (SPHERE_R * surf / surf.norm(dim=1, keepdim=True)).cuda()
    d = dist.lxyz[None] - surf[:, None]
    d = (d / d.norm(dim=-1, keepdim=True)).reshape(-1, 3)
    o = surf[:, None].expand(-1, dist.n_lights, 3).reshape(-1, 3)
    z = sampling.gen_z(0.1, dist.args.lvis_far, n_total, o.shape[0],
                       device='cuda')
    march = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    rayo, rayd = (torch.as_tensor(a[:dist.ray_block]).cuda()
                  for a in view_rays)
    dn = []
    for n_z in (n_total, dist.n_coarse):
        z = sampling.gen_z(dist.near, dist.far, n_z, rayo.shape[0],
                           device='cuda')
        dn.append((rayo[:, None] + rayd[:, None] * z[..., None])
                  .reshape(-1, 3))
    return march, dn[0], dn[1]


def tf32x3_bound(bound_):
    """bound() of a split-TF32 kernel doing the f32 work of ``bound_`` (a
    bound() at 'f32'): three TF32 products for each f32 one at the tensor
    cores' TF32 rate (its 'flop' counts the three), or the same bytes at
    the memory rate."""
    return bound(3 * bound_['flop'], bound_['bytes'], 'tf32')


# Rows at which f32 K1-fwd runs both ways (f32_fwd_by_rows): from the test
# chunk's heads (128) and a training step's (2,048) to the order of a
# depth/normal block
F32_SWEEP_ROWS = (128, 2048, 8192, 16384, 32768, 65536, 131072, 524288)


def f32_fwd_by_rows(plan, p, seed=0, iters=10):
    """f32 K1-fwd on ``plan`` at F32_SWEEP_ROWS rows of seeded inputs:
    the split-TF32 kernel's ms against the CUDA-core kernel's (CUDA
    events, each wrapper's packing included, in turns), each kernel's
    device ms a launch (a profiler window), and whether the rule takes the
    tensor cores at that size: where fused_mlp.F32_TC_MIN_ROWS comes
    from."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for n in F32_SWEEP_ROWS:
        x = torch.rand(n, fm.raw_dim(plan), generator=g).cuda()
        runs = {'split_tf32': lambda: fm.chain_kernel_f32_tc(plan, x, p),
                'cuda_core': lambda: fm.chain_kernel_cuda_core(plan, x, p)}
        row = dict(zip(('split_tf32_ms', 'cuda_core_ms'), time_pair(
            runs['split_tf32'], runs['cuda_core'], iters=iters)))
        for key, run in runs.items():
            us, seen = profiled_device_us(run, 5)
            k = [k for k in us if 'chain_fwd' in k]
            row[key + '_device_ms'] = sum(us[i] for i in k) / max(
                sum(seen[i] for i in k), 1) / 1e3
        out.append(dict(row, rows=n, rule_takes_split_tf32=(
            fm.fwd_on_tensor_cores(plan, None, x.device, rows=n))))
    return out


def beyond(got, want, tol, mask=None):
    """compare()'s reading without its verdict: (values of ``got`` beyond
    ``tol`` of ``want`` on ``mask``, the max abs error there)."""
    err = (got - want).abs()
    lim = tol[0] + tol[1] * want.abs()
    if mask is not None:
        err, lim = err[mask], lim[mask]
    return int((err > lim).sum()), err.max().item()


def check_sigma_chain(nerf_dir, view_rays):
    """K1 on NeRF's sigma chain (nerf.ini: 256 x 8, skip after layer 4, a
    1-wide head; the checkpoint's fine level) at distillation's shapes:
    bf16 K1-fwd on the tensor cores at one visibility block's 8,355,840
    rows against the plain bf16 version; f32 K1-fwd (split TF32 on the
    tensor cores, chain_fwd_f32_tc_kernel) at one depth/normal block's
    1,048,320 fine and 419,328 coarse rows, and f32 K1-bwd with dx alone
    (chain_dx_f32_tc_kernel) at both, against the plain f32 version (TF32
    off) and autograd of it for the path's cotangent (the ReLU's mask, d
    sum(relu(sigma)) / d sigma). Each with its ms and the plain version's
    (CUDA events, in turns), device ms, bound and TFLOP/s; the f32 ones
    also with the CUDA-core kernel they replace (ms and error, same run)
    and the plain-TF32 control (terms 1), whose reading must break a limit
    the kernel holds; their bound is the split-TF32 one (tf32x3_bound), the
    f32 bound on the CUDA cores beside it. Returns (the forward readings,
    the backward's)."""
    dist, _ = distiller_on(nerf_dir, 'cuda')
    plan = dist.model.sigma_plan
    p = fm.params_from_tree(dist.params['fine_enc'],
                            dist.params['fine_sigma_out'])
    x_march, x_dn, x_coarse = sigma_chain_inputs(dist, view_rays)
    del dist
    bf16 = torch.bfloat16
    if not fm.fwd_on_tensor_cores(plan, bf16, x_march.device) \
            or not fm.fwd_on_tensor_cores(plan, None, x_march.device) \
            or not fm.bwd_on_tensor_cores(plan, None, True, False,
                                          x_march.device):
        raise AssertionError("the sigma plan is off the tensor cores: %s"
                             % (plan,))

    def reading(rows, dtype, ms, plain_ms, run, kernel, bound_, flop=None):
        """The readings of wrapper calls ``run``: the device ms of a
        ``kernel`` launch is the profiler's mean over the launches its
        window of SIGMA_WINDOW_CALLS calls recorded (late in the smoke it
        records some of them only); none recorded fails. TFLOP/s count
        ``flop``, the function's (bound_'s by default)."""
        us, seen = profiled_device_us(run, SIGMA_WINDOW_CALLS)
        n = sum(c for k, c in seen.items() if kernel in k)
        if not n:
            raise AssertionError(
                "sigma chain: the profiler window recorded no launch of %s "
                "in %d calls (it saw %s)" % (kernel, SIGMA_WINDOW_CALLS,
                                             seen))
        return {'rows': rows, 'dtype': dtype, 'ms': ms, 'plain_ms': plain_ms,
                'device_ms': sum(v for k, v in us.items() if kernel in k)
                / n / 1e3,
                'launches_recorded': n, 'window_calls': SIGMA_WINDOW_CALLS,
                'bound_ms': bound_['bound_ms'], 'bound_by': bound_['bound_by'],
                'bound_at': bound_,
                'tflops': (flop or bound_['flop']) / ms / 1e9}
    fwd = {}
    with torch.no_grad():
        err = compare('K1-fwd sigma march bf16',
                      fm.chain_kernel(plan, x_march, p, bf16),
                      plain_in_chunks(plan, x_march, p, bf16), TOL_BF16)
        ms, plain_ms = time_pair(
            lambda: fm.chain_kernel(plan, x_march, p, bf16),
            lambda: plain_in_chunks(plan, x_march, p, bf16), iters=2)
        fwd['march_bf16'] = dict(reading(
            x_march.shape[0], 'bf16', ms, plain_ms,
            lambda: fm.chain_kernel(plan, x_march, p, bf16),
            'chain_fwd_tc_kernel',
            chain_bound(plan, x_march.shape[0], 'bf16', 3, 1)),
            max_abs_err=err, route='tensor cores')
        del x_march
        for key, x in (('depth_normal_f32', x_dn),
                       ('depth_normal_coarse_f32', x_coarse)):
            y_plain = fm.chain_reference(plan, x, p)
            f32_tc = fm.chain_kernel.f32_tc_launches
            err = compare('K1-fwd sigma f32 %d rows' % x.shape[0],
                          fm.chain_kernel(plan, x, p), y_plain, TOL_F32)
            if fm.chain_kernel.f32_tc_launches != f32_tc + 1:
                raise AssertionError("f32 K1-fwd off the tensor cores")
            ctl_bad, ctl_err = beyond(
                fm.chain_kernel_f32_tc(plan, x, p, terms=1), y_plain, TOL_F32)
            if not ctl_bad:
                raise AssertionError(
                    "sigma f32 K1-fwd: the plain-TF32 control is within %s "
                    "(max err %.3g)" % (TOL_F32, ctl_err))
            core_err = (fm.chain_kernel_cuda_core(plan, x, p) - y_plain) \
                .abs().max().item()
            del y_plain
            ms, plain_ms = time_pair(lambda: fm.chain_kernel(plan, x, p),
                                     lambda: fm.chain_reference(plan, x, p),
                                     iters=3)
            b = chain_bound(plan, x.shape[0], 'f32', 3, 1)
            fwd[key] = dict(reading(
                x.shape[0], 'f32', ms, plain_ms,
                lambda: fm.chain_kernel(plan, x, p), 'chain_fwd_f32_tc_kernel',
                tf32x3_bound(b), b['flop']), max_abs_err=err, tol=TOL_F32,
                tf32x1_control={'values_beyond_tol': ctl_bad,
                                'max_abs_err': ctl_err},
                f32_cuda_core_bound_ms=b['bound_ms'],
                cuda_core_ms=time_ms(
                    lambda: fm.chain_kernel_cuda_core(plan, x, p), iters=2),
                cuda_core_max_abs_err=core_err,
                route='tensor cores (split TF32)')
        fwd['depth_normal_f32']['by_rows'] = f32_fwd_by_rows(plan, p)
    bwd = {}
    for key, x in (('dx_only_f32', x_dn), ('dx_only_coarse_f32', x_coarse)):
        with torch.no_grad():
            dy = (fm.chain_reference(plan, x, p) > 0).float()
        xg = x.clone().requires_grad_()
        y = fm.chain_reference(plan, xg, p)
        want, = torch.autograd.grad(y, xg, dy, retain_graph=True)
        dw_before = fm.chain_kernel_bwd.dw_launches
        dx_tc = fm.chain_kernel_bwd.dx_tc_launches
        dx, dparams = fm.chain_kernel_bwd(plan, x, dy, p, needs_dx=True,
                                          needs_dw=False)
        if dparams is not None \
                or fm.chain_kernel_bwd.dw_launches != dw_before:
            raise AssertionError("K1-bwd dx only computed dW")
        if fm.chain_kernel_bwd.dx_tc_launches != dx_tc + 1:
            raise AssertionError("f32 K1-bwd dx only off the tensor cores")
        # Rows away from every ReLU kink (as check_backward's K2 rows): a
        # row whose gate sits within f32 rounding of 0 is gated either way
        _, low = chain_f64(plan, x.double(), p)
        keep = (low > KINK_F32)[:, None].expand_as(dx)
        err = compare('K1-bwd sigma dx f32 %d rows' % x.shape[0], dx, want,
                      TOL_F32, mask=keep)
        # Over all rows, the gate flips move the rows at a kink by one
        # unit's share of their dx: ~1e-3 of the norm expected, bounded an
        # order above
        dx_rel_err = check_norm('K1-bwd sigma dx f32 (all rows)',
                                [rel_norm(dx, want)], SIGMA_DX_TOL_F32)
        ctl = fm.chain_kernel_bwd_dx_f32_tc(plan, x, dy, p, terms=1)
        ctl_bad, ctl_err = beyond(ctl, want, TOL_F32, mask=keep)
        ctl_rel = rel_norm(ctl, want)
        if not ctl_bad and ctl_rel <= SIGMA_DX_TOL_F32:
            raise AssertionError(
                "sigma f32 K1-bwd: the plain-TF32 control is within %s "
                "off the kinks and %g by relative norm (%.3g, %.3g)" % (
                    TOL_F32, SIGMA_DX_TOL_F32, ctl_err, ctl_rel))
        core, _ = fm.chain_kernel_bwd_cuda_core(plan, x, dy, p, None, True,
                                                False)
        core_rel = rel_norm(core, want)
        del ctl, core, dx
        ms, plain_ms = time_pair(
            lambda: fm.chain_kernel_bwd(plan, x, dy, p, needs_dw=False),
            lambda: torch.autograd.grad(y, xg, dy, retain_graph=True),
            iters=2)
        b = chain_bound(plan, x.shape[0], 'f32', 3, 1, bwd=(True, False))
        bwd[key] = dict(reading(
            x.shape[0], 'f32', ms, plain_ms,
            lambda: fm.chain_kernel_bwd(plan, x, dy, p, needs_dw=False),
            'chain_dx_f32_tc_kernel', tf32x3_bound(b), b['flop']),
            max_abs_err=err, tol=TOL_F32, dx_rel_err=dx_rel_err,
            dx_tol=SIGMA_DX_TOL_F32,
            rows_at_relu_kink=int((low <= KINK_F32).sum()),
            tf32x1_control={'values_beyond_tol_off_kinks': ctl_bad,
                            'max_abs_err_off_kinks': ctl_err,
                            'dx_rel_err': ctl_rel},
            f32_cuda_core_bound_ms=b['bound_ms'],
            cuda_core_ms=time_ms(lambda: fm.chain_kernel_bwd_cuda_core(
                plan, x, dy, p, None, True, False), iters=1),
            cuda_core_dx_rel_err=core_rel,
            route='tensor cores (split TF32)', mode='dx only')
        del xg, y, want, dy
        torch.cuda.empty_cache()
    return fwd, bwd


# ------ the end-to-end pipeline (tools/quality_e2e.py) ------

# The harness at its anchor's size (imh 32, 8 x 16 lights, 64-wide MLPs,
# 512 rays a step, 8 train views) on a short schedule: epochs a stage
E2E_SIZE = ['--imh', '32', '--light_h', '8', '--n_train', '8',
            '--mlp_width', '64', '--n_rays', '512']
E2E_EPOCHS = {'brdf': 50, 'shape': 30, 'joint': 50, 'nerf': 150}
# The joint model's mean vali PSNR on this schedule must reach the floor,
# on the exact buffers and on those distilled from the harness's NeRF;
# the control, the same buffers each moved to the next view (a hand-off
# fault), must stay under it. Readings on an H100 (PERF.md §6, limits):
# exact 45.19 dB, control 28.12; from the NeRF 34.76, control 27.03 (the
# from-NeRF PSNR moves ~2.5 dB with the NeRF's init draw).
E2E_PSNR_FLOOR = {'exact': 40.0, 'from_nerf': 31.0}
# The kernels each harness run must launch: the shape and joint stages run
# K1 (the lvis chain on the tensor cores) and K2; from a NeRF also K3, and
# K1 in distillation
E2E_KERNELS = {'exact': JOINT_KERNELS + ('K1-bwd tc',),
               'from_nerf': JOINT_KERNELS + ('K1-bwd tc', 'K3-fwd',
                                             'K3-fwd tc', 'K3-bwd')}


def video_frames(path, fps=12):
    """The frames a compiled video holds: for an APNG its total duration
    over one frame's (PIL merges equal neighbours into one longer
    frame)."""
    if path.endswith('.apng'):
        from PIL import Image, ImageSequence
        with Image.open(path) as im:
            total = sum(f.info['duration']
                        for f in ImageSequence.Iterator(im))
        return total / int(1000 / fps)
    import imageio.v2 as imageio
    return imageio.get_reader(path).count_frames()


def check_video(run, n_frames, what):
    """A serving run's compiled video exists and holds ``n_frames``."""
    video = run['video']
    if video is None or not os.path.isfile(video) \
            or video_frames(video) != n_frames:
        raise AssertionError("%s video %s: %s frames, expected %d" % (
            what, video, video and os.path.isfile(video)
            and video_frames(video), n_frames))
    return {'path': os.path.relpath(video, ROOT), 'frames': n_frames,
            'view_seconds': run['view_seconds']}


def run_pipeline(mode):
    """quality_e2e.main on the card in ``mode`` ('exact' or 'from_nerf'),
    counters zeroed before and read after, then test.main (and with a NeRF
    nerf_test.main) on its checkpoints with the video compile. Checks the
    report and the videos' frame counts. Returns (launches by path, the
    record, the harness's parsed args)."""
    argv = ['--workdir', join(WORK, 'e2e_' + mode)] + E2E_SIZE + sum(
        (['--epochs_' + k, str(v)] for k, v in E2E_EPOCHS.items()), [])
    if mode == 'from_nerf':
        argv.append('--from_nerf')
    args = quality_e2e.parse_args(argv)
    zero_counters()
    rec = quality_e2e.main(argv)
    torch.cuda.synchronize()
    launches = {'pipeline_e2e_' + mode: read_counters(
        E2E_KERNELS[mode], 'end-to-end (%s)' % mode)}
    stages = ['brdf', 'joint', 'shape'] + (
        ['distill', 'nerf'] if mode == 'from_nerf' else [])
    if sorted(rec['stage_walls_min']) != sorted(stages) \
            or len(rec['per_view_psnr']) != 2 \
            or not np.isfinite(rec['mean_psnr']):
        raise AssertionError("end-to-end (%s) report: %s" % (mode, rec))
    out = join(args.workdir, 'out')
    zero_counters()
    run = test_cli.main(['--ckpt', join(out, 'nerfactor', 'lr5e-3',
                                        'checkpoints', 'ckpt-%d'
                                        % args.epochs_joint)])
    launches['pipeline_test_' + mode] = read_counters(
        ('K1-fwd', 'K1-fwd tc', 'K2-fwd', 'K2-fwd tc'),
        'end-to-end (%s) test.py' % mode)
    last = ioutil.sortglob(run['outroot'], 'batch?????????')[-1]
    n_olat = len(ioutil.sortglob(last, 'pred_lvis_olat*.png'))
    # View synthesis, the last view's OLATs, the two probes' round trip
    rec['test'] = check_video(run, 3 + n_olat + 2 * 2 * 3,
                              'test.py (%s)' % mode)
    if mode == 'from_nerf':
        zero_counters()
        run = nerf_test.main(['--ckpt', join(
            out, 'nerf', 'lr5e-4', 'checkpoints', 'ckpt-%d'
            % args.epochs_nerf)])
        launches['pipeline_nerf_test'] = read_counters(
            ('K3-fwd', 'K3-fwd tc'), 'end-to-end nerf_test.py')
        rec['nerf_test'] = check_video(run, 3, 'nerf_test.py')
    return launches, rec, args


def run_pipeline_swapped_buffers(args, surf_root):
    """The shape and joint stages of a harness run again on its buffers
    with each view's moved to the next view (in sorted order, the last to
    the first): a hand-off fault between distillation and the later
    stages, the PSNR floor's control. Returns its mean vali PSNR."""
    views = sorted(os.listdir(surf_root))
    swapped = surf_root + '_swapped'
    shutil.rmtree(swapped, ignore_errors=True)
    for src, dst in zip(views, views[1:] + views[:1]):
        shutil.copytree(join(surf_root, src), join(swapped, dst))
    data, out = join(args.workdir, 'data'), join(args.workdir, 'out_swapped')
    shape_ckpt = quality_e2e.shape_stage(args, data, swapped, out)
    joint_dir = quality_e2e.joint_stage(
        args, data, swapped, join(out, 'nerfactor'),
        join(args.workdir, 'out', 'merl', 'lr1e-2', 'checkpoints',
             'ckpt-%d' % args.epochs_brdf), shape_ckpt,
        join(data, 'envmaps'))
    return float(np.mean([p for _, p in quality_e2e.vali_psnrs(joint_dir)]))


def check_pipeline():
    """Both harness modes and their controls against E2E_PSNR_FLOOR.
    Returns (launches by path, record)."""
    t0 = time.perf_counter()
    launches, record = {}, {'epochs': E2E_EPOCHS, 'floor': E2E_PSNR_FLOOR}
    for mode in ('exact', 'from_nerf'):
        more, rec, args = run_pipeline(mode)
        launches.update(more)
        rec['control_swapped_buffers_psnr'] = run_pipeline_swapped_buffers(
            args, join(args.workdir, 'data', 'surf') if mode == 'exact'
            else join(args.workdir, 'out', 'surf_from_nerf'))
        record[mode] = rec
        floor = E2E_PSNR_FLOOR[mode]
        if not rec['mean_psnr'] >= floor \
                > rec['control_swapped_buffers_psnr']:
            raise AssertionError(
                "end-to-end (%s): mean vali PSNR %.3f and its control %.3f "
                "do not part at the floor %.1f" % (
                    mode, rec['mean_psnr'],
                    rec['control_swapped_buffers_psnr'], floor))
    record['seconds'] = time.perf_counter() - t0
    return launches, record


# ------ the shipped variants: the GGX microfacet ablation, the MVS path ------

# The microfacet step's kernels: K1 for the albedo, roughness and normal
# heads (f32, CUDA cores) and the bf16 lvis chain (tensor cores); no BRDF
# prior, so no K2
MICROFACET_KERNELS = ('K1-fwd', 'K1-fwd tc', 'K1-bwd', 'K1-bwd tc')
NO_K2 = ('K2-fwd', 'K2-fwd tc', 'K2-bwd', 'K2-bwd tc')
# microfacet_spec in f32 against float64 at the step's 1024 x 512 pairs,
# by relative norm: at grazing views the lobe divides by v.n and l.n, and
# its peaks carry their rounding (CPU reading at seed 0: 4.05e-4). The
# card against the CPU in f32 parts as far (the card's rsqrt and pow
# round otherwise; first card reading 3.08e-4), so the same limit.
MICROFACET_F64_TOL = 2e-3
MICROFACET_CARD_CPU_TOL = MICROFACET_F64_TOL
# The control that must break these limits: the lobe in bf16 (inputs and
# arithmetic), the precision the f32 lobe must not fall to. CPU readings
# at seeds 0-1 against float64: 1.33, 285 (summing the dots in f32
# instead reads 4.7e-4, 2.1e-4: inside the limit, so no control). In the
# microfacet step it must break NORM_TOL_BF16 on some leaf.
# The MVS phase's scan: tools/synth_dtu.py's icosphere at subdivision 4
# (5,120 faces), 8 views at imh 128 (6 train, 2 val) and 3 test views of
# the 120 the trajectory has by default (the one cut); 512 lights
MVS_IMH, MVS_VIEWS, MVS_SUBDIV, MVS_TEST_VIEWS = 128, 8, 4, 3
# Rays of one view (camera and occlusion rays) traced on the card and on
# the CPU: hit mask and triangle index equal, t within RAYTRACE_T_TOL (the
# same elementwise operations in the same order: bit for bit expected)
RAYTRACE_SAMPLE = 2048
RAYTRACE_T_TOL = (1e-6, 1e-5)
# The tracer's control: the same rays against the mesh with its vertices
# rounded to bf16 (a mesh kept at half precision), which must break the
# hit, index or t limit


def lobe_in_bf16(pts2l, pts2c, normal, rough=None, **kwargs):
    """microfacet_spec on bf16 inputs in bf16 arithmetic, back to f32:
    the control of the lobe's limits."""
    return microfacet_spec(
        pts2l.bfloat16(), pts2c.bfloat16(), normal.bfloat16(),
        rough=None if rough is None else rough.bfloat16(),
        **kwargs).float()


def no_k2(launches, path):
    """Raises if K2 launched on ``path``."""
    k2 = {k: launches[k] for k in NO_K2 if launches[k]}
    if k2:
        raise AssertionError("K2 launched on the %s path: %s" % (path, k2))


def check_relights(run, n_views, what):
    """A test.py run's views: OLAT relights on the last view only, probe
    relights on each; the compiled video's frames (views, the last view's
    OLATs, the two probes' round trip)."""
    batch_dirs = ioutil.sortglob(run['outroot'], 'batch?????????')
    if len(batch_dirs) != n_views:
        raise AssertionError("%s: %d view dirs" % (what, len(batch_dirs)))
    n_olat = [len(ioutil.sortglob(d, 'pred_rgb_olat_*.png'))
              for d in batch_dirs]
    if n_olat != [0] * (n_views - 1) + [LIGHT_H * LIGHT_H]:
        raise AssertionError("%s: OLAT files by view %s" % (what, n_olat))
    for d in batch_dirs:
        for name in ('courtyard', 'sunset'):
            if not os.path.exists(join(d, 'pred_rgb_probes_%s.png' % name)):
                raise AssertionError("%s: no %s relight in %s"
                                     % (what, name, d))
    n_lvis_olat = len(ioutil.sortglob(batch_dirs[-1], 'pred_lvis_olat*.png'))
    return check_video(run, n_views + n_lvis_olat + 2 * 2 * n_views, what)


def run_microfacet(joint_override):
    """trainvali.main on nerfactor_microfacet.ini for 4 epochs from the
    smoke's seeded shape checkpoint, counters zeroed before and read
    after (K1 on the tensor cores and the CUDA cores, no K2); checks the
    losses, that the checkpoints hold no BRDF-prior leaf and every leaf of
    ckpt-4 moved from ckpt-2, the roughness image; then test.main on
    ckpt-4 (OLAT and probe relights, the video), counters zeroed before
    and read after. Returns (launches by path, outdir, record)."""
    override = joint_override + ',' + ','.join([
        'outroot=' + join(WORK, 'out', 'microfacet'), 'epochs=4',
        'ckpt_period=2', 'vali_period=4', 'vali_batches=1'])
    zero_counters()
    t0 = time.perf_counter()
    outdir = trainvali.main(['--config', 'nerfactor_microfacet.ini',
                             '--config_override', override])['outdir']
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {'microfacet_training': f32_training_kernels(read_counters(
        MICROFACET_KERNELS + ('K1-fwd f32 tc', 'K1 pack'),
        'microfacet training'), 'microfacet training')}
    no_k2(launches['microfacet_training'], 'microfacet training')
    losses = train_scalars(outdir)
    config = configutil.Config(configutil.read_config(outdir + '.ini'))
    ckpts = join(outdir, 'checkpoints')
    at2 = ckptutil.restore_trained_params(
        join(ckpts, 'ckpt-2'), MicrofacetModel(config, device='cpu')
        .init_params(torch.Generator()))
    if set(at2) & set(BRDF_PARAM_KEYS):
        raise AssertionError("microfacet checkpoint with BRDF-prior leaves: "
                             "%s" % sorted(at2))
    moved = changed_leaves(at2, join(ckpts, 'ckpt-4'))
    if not all(moved.values()):
        raise AssertionError("microfacet ckpt-4: leaves that did not move "
                             "from ckpt-2: %s" % moved)
    vali_dir = join(outdir, 'vis_vali', 'epoch000000004', 'batch000000000')
    rough = ioutil.load_img(join(vali_dir, 'pred_brdf.png'))
    if rough.shape != (IMH, IMH, 3) or not np.array_equal(rough[..., 0],
                                                          rough[..., 2]):
        raise AssertionError("microfacet pred_brdf.png: %s" % (rough.shape,))
    zero_counters()
    run = test_cli.main(['--ckpt', join(ckpts, 'ckpt-4')])
    launches['microfacet_inference'] = read_counters(
        ('K1-fwd', 'K1-fwd tc'), 'microfacet test.py')
    no_k2(launches['microfacet_inference'], 'microfacet test.py')
    return launches, outdir, {
        'loss_train': losses, 'seconds': seconds, 'leaves': len(
            ckptutil.tree_leaves(at2)),
        'test': check_relights(run, N_VIEWS, 'microfacet test.py')}


def f32_heads_witness(config, params, arrays, noise, steps):
    """How far each of ``steps`` ({name: [(key, gradient)]}) and the same
    microfacet step on the card with the f32 heads' training pair on the
    CUDA cores (the design split TF32 replaced; F32_DW_TC_MAX_ROWS set to
    0 for that step) sit from the CPU plain port's step whose f32 chains
    (the heads) run in float64 (chain_f64, their outputs rounded to f32):
    a witness of which heads' rounding lies nearer their exact math. The
    worst relative norm of each key's leaves, by step."""
    max_rows = fm.F32_DW_TC_MAX_ROWS
    fm.F32_DW_TC_MAX_ROWS = 0
    try:
        _, cuda_core = shape_step_loss_grads(
            config, 'cuda', params, arrays, noise, cls=MicrofacetModel)
    finally:
        fm.F32_DW_TC_MAX_ROWS = max_rows
    plain = fm.chain_reference

    def heads_f64(plan, x, p, compute_dtype=None):
        if compute_dtype is not None:
            return plain(plan, x, p, compute_dtype)
        return chain_f64(plan, x.double(), [(w.double(), b.double())
                                            for w, b in p])[0].float()
    fm.chain_reference = heads_f64
    try:
        _, exact = shape_step_loss_grads(config, 'cpu', params, arrays, noise,
                                         cls=MicrofacetModel)
    finally:
        fm.chain_reference = plain
    out = {}
    for name, grads in dict(steps, card_cuda_core_heads=cuda_core).items():
        errs = out.setdefault(name, {})
        for (k, got), (_, want) in zip(grads, exact):
            errs[k] = max(errs.get(k, 0.0), rel_norm(got, want))
    return out


def check_microfacet_step(config):
    """One microfacet step's loss and every gradient leaf on the card
    against the port's plain version on the CPU, from one batch and one
    jitter draw: every leaf within NORM_TOL_BF16 by relative norm (the
    bf16 lvis chain feeds the render, so each leaf's gradient carries
    it), the loss within TOL_BF16."""
    params = MicrofacetModel(config, device='cpu').init_params(
        torch.Generator().manual_seed(0))
    batch = next(iter(Dataset(config, 'train').build_pipeline(prefetch=0)))
    arrays = {k: torch.as_tensor(np.asarray(batch[k]))
              for k in Dataset.array_keys}
    noise = config.getfloat('xyz_jitter_std') * torch.randn(
        (N_RAYS, 3), generator=torch.Generator().manual_seed(1))
    zero_counters()
    loss_k, grads_k = shape_step_loss_grads(
        config, 'cuda', params, arrays, noise, cls=MicrofacetModel)
    no_k2(counts(), 'microfacet step')
    loss_p, grads_p = shape_step_loss_grads(
        config, 'cpu', params, arrays, noise, cls=MicrofacetModel)
    # The control: the same step on the card with the lobe in bf16
    spec_f32 = microfacet_model.microfacet_spec
    microfacet_model.microfacet_spec = lobe_in_bf16
    try:
        _, grads_c = shape_step_loss_grads(
            config, 'cuda', params, arrays, noise, cls=MicrofacetModel)
    finally:
        microfacet_model.microfacet_spec = spec_f32
    errs, control = {}, {}
    for (k, got), (_, want), (_, ctl) in zip(grads_k, grads_p, grads_c):
        errs[k] = max(errs.get(k, 0.0), rel_norm(got, want))
        control[k] = max(control.get(k, 0.0), rel_norm(ctl, want))
    if all(v <= NORM_TOL_BF16 for v in control.values()):
        raise AssertionError("microfacet step: the bf16-lobe control is "
                             "within %g on every leaf: %s"
                             % (NORM_TOL_BF16, control))
    witness = f32_heads_witness(config, params, arrays, noise, {
        'card': grads_k, 'plain_cpu': grads_p})
    return {'control_bf16_lobe_grad_rel_err_by_key': control,
            'f64_heads_witness_rel_err_by_key': witness,
        'rows_lvis': 2 * N_RAYS * N_LIGHTS, 'loss_card': loss_k,
        'loss_plain_cpu': loss_p,
        'loss_abs_err': compare('microfacet step loss',
                                torch.tensor([loss_k]),
                                torch.tensor([loss_p]), TOL_BF16),
        'grad_rel_err': check_norm('microfacet step gradients',
                                   list(errs.values()), NORM_TOL_BF16),
        'grad_rel_err_by_key': errs, 'grad_leaves': len(grads_k),
        'tol': {'grads': NORM_TOL_BF16, 'loss': TOL_BF16}}


def check_microfacet_lobe(seed=0):
    """microfacet_spec at the step's shapes (N_RAYS x N_LIGHTS pairs,
    seeded directions and roughness in [0.05, 1]) on the card in f32
    against float64 and against the CPU, with its ms."""
    g = torch.Generator().manual_seed(seed)
    args = (torch.randn(N_RAYS, N_LIGHTS, 3, generator=g),
            torch.randn(N_RAYS, 3, generator=g),
            torch.randn(N_RAYS, 3, generator=g),
            0.05 + 0.95 * torch.rand(N_RAYS, 1, generator=g))

    def spec(device, dtype=torch.float32):
        a = [t.to(device=device, dtype=dtype) for t in args]
        return microfacet_spec(*a[:3], rough=a[3], f0=0.04)

    got = spec('cuda')
    f64 = spec('cuda', torch.float64)
    cpu = spec('cpu')
    if not torch.isfinite(got).all():
        raise AssertionError("microfacet_spec: non-finite values")
    a = [t.cuda() for t in args]
    ctl = lobe_in_bf16(*a[:3], rough=a[3], f0=0.04)
    control = {'f64_rel_err': rel_norm(ctl.double().cpu(), f64.cpu()),
               'card_vs_cpu_rel_err': rel_norm(ctl.cpu(), cpu)}
    if control['f64_rel_err'] <= MICROFACET_F64_TOL \
            or control['card_vs_cpu_rel_err'] <= MICROFACET_CARD_CPU_TOL:
        raise AssertionError("microfacet_spec: the bf16-lobe control is "
                             "within a limit: %s" % control)
    return {'rows': N_RAYS * N_LIGHTS, 'control_bf16_lobe': control,
            'f64_rel_err': check_norm('microfacet_spec vs float64', [
                rel_norm(got.double().cpu(), f64.cpu())], MICROFACET_F64_TOL),
            'card_vs_cpu_rel_err': check_norm('microfacet_spec card vs CPU', [
                rel_norm(got.cpu(), cpu)], MICROFACET_CARD_CPU_TOL),
            'ms': time_ms(lambda: microfacet_spec(*a[:3], rough=a[3],
                                                  f0=0.04)),
            'tol': {'f64': MICROFACET_F64_TOL,
                    'card_vs_cpu': MICROFACET_CARD_CPU_TOL}}


def run_dtu(scan, surf_root):
    """dtu_surf_from_mvs.main on the card over the scan (--h MVS_IMH,
    --light_h LIGHT_H, MVS_TEST_VIEWS test views); checks each view's
    files. Returns the record: seconds a view, rays and ray-triangle tests
    a second of the tracer."""
    t0 = time.perf_counter()
    run = dtu_surf_from_mvs.main([
        '--cam_dir', scan['cam_dir'], '--img_dir', scan['img_dir'],
        '--surf_dir', scan['surf_dir'], '--outdir', surf_root,
        '--h', str(MVS_IMH), '--light_h', str(LIGHT_H),
        '--n_test', str(MVS_TEST_VIEWS)])
    seconds = time.perf_counter() - t0
    views = run['views']
    if len(views) != MVS_VIEWS + MVS_TEST_VIEWS:
        raise AssertionError("dtu_surf_from_mvs: views %s" % sorted(views))
    for name in views:
        d = join(surf_root, name)
        for f in ('metadata.json', 'alpha.png', 'xyz.npy', 'normal.npy',
                  'lvis.npy', 'rgba.png' if name[:4] != 'test' else 'nn.png'):
            if not os.path.exists(join(d, f)):
                raise AssertionError("dtu_surf_from_mvs %s: no %s" % (name,
                                                                      f))
        alpha = ioutil.load_img(join(d, 'alpha.png'))
        lvis = np.load(join(d, 'lvis.npy'), mmap_mode='r')
        if alpha.shape != (MVS_IMH, MVS_IMH) or not 0 < alpha.mean() < 1 \
                or lvis.shape != (MVS_IMH, MVS_IMH, N_LIGHTS):
            raise AssertionError("dtu_surf_from_mvs %s: alpha %s, lvis %s"
                                 % (name, alpha.shape, lvis.shape))
    rays = sum(v['rays'] for v in views.values())
    trace_s = sum(v['trace_seconds'] for v in views.values())
    return {'seconds': seconds, 'n_faces': run['n_faces'],
            'views': len(views),
            's_per_view': sum(v['seconds'] for v in views.values())
            / len(views),
            'trace_s_per_view': trace_s / len(views),
            'rays_per_view': rays / len(views),
            'rays_per_s': rays / trace_s,
            'ray_triangle_tests_per_s': rays * run['n_faces'] / trace_s}


def check_raytrace(scan, surf_root, seed=0):
    """RAYTRACE_SAMPLE rays of view train_000 (half camera rays at its
    foreground's surface points, half occlusion rays from them to the
    lights, as dtu_surf_from_mvs casts them) traced on the card and on the
    CPU."""
    vertices, faces = meshio.read_ply(join(
        scan['surf_dir'], 'stl042_l3_surf_11_trim_8.ply'))
    view = join(surf_root, 'train_000')
    fg = ioutil.load_img(join(view, 'alpha.png')).reshape(-1) > 0.5
    xyz = np.load(join(view, 'xyz.npy')).reshape(-1, 3)[fg].astype(
        np.float64)
    cam = np.array(ioutil.read_json(join(view, 'metadata.json'))['cam_loc'])
    lxyz = np.load(join(surf_root, 'lights.npz'))['lxyzs'].reshape(-1, 3)
    rng = np.random.RandomState(seed)
    half = RAYTRACE_SAMPLE // 2
    pts = xyz[rng.randint(0, len(xyz), RAYTRACE_SAMPLE)]
    dirs = np.concatenate([pts[:half] - cam,
                           lxyz[rng.randint(0, len(lxyz), half)]
                           - pts[half:]])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origs = np.concatenate([np.tile(cam, (half, 1)), pts[half:]
                            + 0.1 * dirs[half:]])
    got = raytrace.intersect(origs, dirs, vertices, faces, device='cuda')
    want = raytrace.intersect(origs, dirs, vertices, faces, ray_chunk=512,
                              device='cpu')
    hit_k, t_k, idx_k = (x.cpu() for x in got)
    hit_p, t_p, idx_p = want
    if not torch.equal(hit_k, hit_p) or not torch.equal(idx_k, idx_p):
        raise AssertionError("raytrace card vs CPU: %d hit and %d index "
                             "mismatches" % (int((hit_k != hit_p).sum()),
                                             int((idx_k != idx_p).sum())))
    # The control: the mesh's vertices rounded to bf16
    verts_bf16 = torch.as_tensor(vertices, dtype=torch.float32).bfloat16(
        ).float().numpy()
    hit_c, t_c, idx_c = (x.cpu() for x in raytrace.intersect(
        origs, dirs, verts_bf16, faces, device='cuda'))
    both = hit_c & hit_p
    t_err = (t_c[both] - t_p[both]).abs()
    control = {'hit_mismatches': int((hit_c != hit_p).sum()),
               'index_mismatches': int((idx_c != idx_p).sum()),
               't_beyond_tol': int((t_err > RAYTRACE_T_TOL[0]
                                    + RAYTRACE_T_TOL[1]
                                    * t_p[both].abs()).sum()),
               't_max_abs_err': t_err.max().item()}
    if not (control['hit_mismatches'] or control['index_mismatches']
            or control['t_beyond_tol']):
        raise AssertionError("raytrace: the bf16-mesh control is within "
                             "the limits: %s" % control)
    return {'rays': RAYTRACE_SAMPLE, 'hits': int(hit_p.sum()),
            'control_bf16_mesh': control,
            't_max_abs_err': compare('raytrace t', t_k[hit_p], t_p[hit_p],
                                     RAYTRACE_T_TOL),
            't_bit_identical': bool(torch.equal(t_k, t_p)),
            'tol': RAYTRACE_T_TOL}


def run_mvs(probe_dir):
    """The MVS path through the user's entry points: tools/synth_dtu.py
    writes a scan, dtu_surf_from_mvs.main casts it on the card (timed; the
    tracer then held against the CPU on a sample), trainvali.main on
    shape_mvs.ini for 4 epochs on those buffers and on nerfactor_mvs.ini
    for 2 from that checkpoint and the smoke's seeded BRDF checkpoint,
    counters zeroed before and read after each (K1; K1 and K2), then
    test.main on the MVS test views with its video (the mvs_root frame
    layout). Returns (launches by path, record)."""
    scan = synth_dtu.make_scan(join(WORK, 'dtu_scan'), imh=MVS_IMH,
                               n_views=MVS_VIEWS, subdiv=MVS_SUBDIV)
    surf_root = join(WORK, 'surf_mvs')
    record = {'dtu_surf_from_mvs': run_dtu(scan, surf_root)}
    record['raytrace_card_vs_cpu'] = check_raytrace(scan, surf_root)
    torch.cuda.empty_cache()
    common = ['mvs_root=' + surf_root, 'imh=%d' % MVS_IMH,
              'light_h=%d' % LIGHT_H]
    zero_counters()
    t0 = time.perf_counter()
    shape_dir = trainvali.main(['--config', 'shape_mvs.ini',
                                '--config_override', ','.join(common + [
                                    'outroot=' + join(WORK, 'out',
                                                      'shape_mvs'),
                                    'epochs=4', 'ckpt_period=2',
                                    'vali_period=4', 'vali_batches=1'])])[
        'outdir']
    torch.cuda.synchronize()
    launches = {'mvs_shape_training': read_counters(SHAPE_KERNELS,
                                                    'MVS shape training')}
    record['shape'] = {'seconds': time.perf_counter() - t0,
                       'loss_train': train_scalars(shape_dir)}
    shape_config = configutil.Config(configutil.read_config(
        shape_dir + '.ini'))
    record['shape']['train_step'] = time_train_step(
        ShapeModel(shape_config, device='cuda'),
        MvsDataset(shape_config, 'train'), kernels=SHAPE_STEP_KERNELS)
    torch.cuda.empty_cache()
    zero_counters()
    t0 = time.perf_counter()
    joint_dir = trainvali.main(['--config', 'nerfactor_mvs.ini',
                                '--config_override', ','.join(common + [
                                    'brdf_model_ckpt=' + join(
                                        WORK, 'out', 'merl', 'run',
                                        'checkpoints', 'ckpt-50'),
                                    'shape_model_ckpt=' + join(
                                        shape_dir, 'checkpoints', 'ckpt-4'),
                                    'test_envmap_dir=' + probe_dir,
                                    'outroot=' + join(WORK, 'out',
                                                      'joint_mvs'),
                                    'epochs=2', 'ckpt_period=2',
                                    'vali_period=2', 'vali_batches=1'])])[
        'outdir']
    torch.cuda.synchronize()
    launches['mvs_joint_training'] = read_counters(JOINT_KERNELS,
                                                   'MVS joint training')
    losses = [json.loads(line)['loss_train'] for line in open(
        join(joint_dir, 'summary_train', 'scalars.jsonl'))]
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError("MVS joint losses %s" % losses)
    record['joint'] = {'seconds': time.perf_counter() - t0,
                       'loss_train': losses}
    config = configutil.Config(configutil.read_config(joint_dir + '.ini'))
    record['joint']['train_step'] = time_train_step(
        Model(config, device='cuda'), MvsDataset(config, 'train'))
    torch.cuda.empty_cache()
    zero_counters()
    run = test_cli.main(['--ckpt', join(joint_dir, 'checkpoints', 'ckpt-2')])
    launches['mvs_inference'] = read_counters(
        ('K1-fwd', 'K1-fwd tc', 'K2-fwd', 'K2-fwd tc'), 'MVS test.py')
    record['test'] = check_relights(run, MVS_TEST_VIEWS, 'MVS test.py')
    return launches, record


# ------ data_gen: the port's converters on inputs at real data's sizes ------

# (a) a synthetic LLFF capture (tools/synth_llff.py): JPEG views at
# LLFF's images_4 size, converted at nerf_real_make_dataset's default
# --h 512; (b) a raw DTU scan (tools/synth_dtu.py): views at DTU's 1600 x
# 1200, converted at the DTU converters' default --h 256, raw and
# processed layouts; (c) MERL binaries at the format's full size (90 x 90
# x 180 x 3 doubles, 35 MB), converted at merl_make_dataset's defaults
# (--ims 128, 16 x 32 lights)
LLFF_VIEWS, LLFF_IMH, LLFF_IMW = 20, 756, 1008
DTU_VIEWS, DTU_IMH, DTU_IMW = 49, 1200, 1600
DATA_GEN_MERL = ('gen-gold', 'gen-plastic', 'gen-rubber')
# NeRF on the converted scenes: nerf.ini at full width and the scene's
# own height, bounds around a spherified capture (its cameras on the unit
# sphere), one epoch (a step a train view) with a checkpoint at its end
SPHERIFIED_BOUNDS = ('near=0.05', 'far=2.0')
NERF_KERNELS = ('K3-fwd', 'K3-fwd tc', 'K3-bwd')


def write_merl_binary(path, kd, ks, sharpness):
    """A MERL .binary of a diffuse + specular material, smooth in theta_h
    (``kd``, ``ks`` per channel), in the format's layout and scales."""
    theta_h = merl.merl_rusink_grid()[:, 1:2]
    rgb = np.asarray(kd) + np.asarray(ks) * np.exp(-sharpness * theta_h ** 2)
    merl.write_merl_brdf(path, rgb.reshape(merl.BRDF_SHAPE + (3,)))


def converted(record, inputs):
    """A converter's record with its seconds per input view."""
    return dict(record, s_per_view=record['seconds'] / inputs)


def run_nerf_on(name, data_root, imh, n_train):
    """nerf.ini through trainvali.main on a converted scene, counters
    zeroed before and read after (K3); checks the loss and that every
    leaf of ckpt-1 moved from the seeded init. Returns (launches,
    outdir, record)."""
    zero_counters()
    t0 = time.perf_counter()
    outdir = trainvali.main(['--config', 'nerf.ini', '--config_override',
                             ','.join(('data_root=' + data_root,
                                       'imh=%d' % imh, 'outroot=' + join(
                                           WORK, 'out', 'data_gen_' + name),
                                       'epochs=1', 'ckpt_period=1',
                                       'vali_period=0')
                                      + SPHERIFIED_BOUNDS)])['outdir']
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters(NERF_KERNELS, 'NeRF on ' + name)
    # Two K3 launches each way a step (coarse and fine), replayed or eager
    if launches['K3-fwd'] != 2 * n_train or launches['K3-bwd'] != 2 * n_train:
        raise AssertionError("NeRF on %s: %d steps, launches %s"
                             % (name, n_train, launches))
    recs = [json.loads(line) for line in open(
        join(outdir, 'summary_train', 'scalars.jsonl'))]
    if [r['step'] for r in recs] != [1] \
            or not np.isfinite(recs[0]['loss_train']):
        raise AssertionError("NeRF on %s: train scalars %s" % (name, recs))
    init = NerfModel(nerf_config(outdir), device='cpu').init_params(
        torch.Generator().manual_seed(0))
    moved = changed_leaves(init, join(outdir, 'checkpoints', 'ckpt-1'))
    if not all(moved.values()):
        raise AssertionError("NeRF on %s: leaves that did not move: %s"
                             % (name, moved))
    return launches, outdir, {
        'seconds': seconds, 'steps': n_train,
        'loss_train': recs[0]['loss_train'],
        'launches_per_step': {k: launches[k] / n_train
                              for k in NERF_KERNELS},
        'tensorboard_events': bool(ioutil.sortglob(
            join(outdir, 'summary_train'), 'events.out.tfevents.*'))}


def check_converted_views(root, n_inputs, imh, imw):
    """A converted scene's layout: the view counts (the converters' 2
    vali views of ``n_inputs``, the rest train, 120 test) and image size,
    an all-one alpha, metadata beside the views."""
    n_vali = len(range(0, n_inputs - 1, max(1, n_inputs // 2)))
    views = {'train': n_inputs - n_vali, 'val': n_vali, 'test': 120}
    got = {m: len(ioutil.sortglob(root, m + '_???')) for m in views}
    if got != views:
        raise AssertionError("%s: views %s, not %s" % (root, got, views))
    rgba = ioutil.load_img(join(root, 'train_000', 'rgba.png'))
    meta = ioutil.read_json(join(root, 'test_119', 'metadata.json'))
    if rgba.shape != (imh, imw, 4) or rgba[..., 3].min() < 1 \
            or (meta['imh'], meta['imw']) != (imh, imw):
        raise AssertionError("%s: rgba %s, metadata %s" % (root, rgba.shape,
                                                           meta))


def run_data_gen():
    """The converters through their entry points on (a), (b) and (c),
    each timed, then on the card: nerf.ini a few steps on (a) and on (b)
    (counters zeroed before and read after: K3-fwd and K3-bwd), the debug
    loader on (a)'s run, brdf.ini two epochs on (c). Returns (launches by
    path, record)."""
    root = join(WORK, 'data_gen')
    t0 = time.perf_counter()
    llff = synth_llff.make_capture(join(root, 'llff'), n_views=LLFF_VIEWS,
                                   imh=LLFF_IMH, imw=LLFF_IMW)
    scan = synth_dtu.make_scan(join(root, 'dtu'), imh=DTU_IMH, imw=DTU_IMW,
                               n_views=DTU_VIEWS, subdiv=2)
    processed = synth_dtu.make_processed(scan, join(root, 'dtu_processed'))
    merl_dir = join(root, 'merl_binaries')
    os.makedirs(merl_dir)
    for i, name in enumerate(DATA_GEN_MERL):
        write_merl_binary(join(merl_dir, name + '.binary'),
                          kd=(0.05 + 0.1 * i, 0.04, 0.03 + 0.05 * i),
                          ks=(2.0 / (i + 1),) * 3, sharpness=40.0 / (i + 1))
    inputs_s = time.perf_counter() - t0

    out = join(root, 'converted')
    conv = {'llff': converted(nerf_real_make_dataset.main([
        '--scene_dir', llff['scene_dir'], '--outroot', join(out, 'llff')]),
        LLFF_VIEWS)}
    conv['dtu_raw'] = converted(dtu_make_dataset_from_raw.main([
        '--cam_dir', scan['cam_dir'], '--img_root', dirname(scan['img_dir']),
        '--scenes', 'scan42', '--outroot', join(out, 'dtu_raw')])['scan42'],
        DTU_VIEWS)
    conv['dtu'] = converted(dtu_make_dataset.main([
        '--scene_dir', processed, '--outroot', join(out, 'dtu')]), DTU_VIEWS)
    conv['merl'] = merl_make_dataset.main([
        '--indir', merl_dir, '--outdir', join(out, 'merl')])
    llff_imw = int(round(LLFF_IMW / LLFF_IMH * 512))
    dtu_imw = int(round(DTU_IMW / DTU_IMH * 256))
    check_converted_views(conv['llff']['outroot'], LLFF_VIEWS, 512,
                          llff_imw)
    for k in ('dtu_raw', 'dtu'):
        check_converted_views(conv[k]['outroot'], DTU_VIEWS, 256, dtu_imw)
    if conv['merl']['materials'] != sorted(DATA_GEN_MERL):
        raise AssertionError("MERL conversion: %s" % conv['merl'])

    launches, nerf = {}, {}
    for name, imh in (('llff', 512), ('dtu_raw', 256)):
        launches['data_gen_nerf_' + name], outdir, nerf[name] = run_nerf_on(
            name, conv[name]['outroot'], imh, conv[name]['views']['train'])
        torch.cuda.empty_cache()
        if name == 'llff':
            batch = debug_dataloader.main(['--config_ini', outdir + '.ini',
                                           '--mode', 'train'])
            if batch['rayo'].shape != (N_RAYS, 3) \
                    or batch['id'][:6] != 'train_':
                raise AssertionError("debug loader on (a): %s %s" % (
                    batch['rayo'].shape, batch['id']))
    zero_counters()
    t0 = time.perf_counter()
    brdf_dir = trainvali.main(['--config', 'brdf.ini', '--config_override',
                               ','.join([
                                   'data_root=' + conv['merl']['outdir'],
                                   'outroot=' + join(WORK, 'out',
                                                     'data_gen_merl'),
                                   'epochs=2', 'ckpt_period=1',
                                   'vali_period=2', 'vali_batches=1'])])[
        'outdir']
    torch.cuda.synchronize()
    launches['data_gen_brdf'] = counts()
    brdf_losses = [json.loads(line)['loss_train'] for line in open(
        join(brdf_dir, 'summary_train', 'scalars.jsonl'))]
    init = BrdfModel(configutil.Config(configutil.read_config(
        brdf_dir + '.ini')), device='cpu').init_params(
        torch.Generator().manual_seed(0))
    moved = changed_leaves(init, join(brdf_dir, 'checkpoints', 'ckpt-2'))
    if len(brdf_losses) != 2 or not np.all(np.isfinite(brdf_losses)) \
            or not all(moved.values()):
        raise AssertionError("brdf.ini on (c): losses %s, moved %s"
                             % (brdf_losses, moved))
    brdf = {'seconds': time.perf_counter() - t0, 'loss_train': brdf_losses}
    shutil.rmtree(root)
    return launches, {
        'inputs': {'llff': [LLFF_VIEWS, LLFF_IMH, LLFF_IMW, 'jpg'],
                   'dtu': [DTU_VIEWS, DTU_IMH, DTU_IMW, 'png'],
                   'merl': [len(DATA_GEN_MERL)] + list(merl.BRDF_SHAPE)},
        'inputs_seconds': inputs_s, 'converters': conv, 'nerf': nerf,
        'brdf': brdf, 'launches': {p: {k: c[k] for k in NERF_KERNELS}
                                   for p, c in launches.items()}}

# ------ multi-device training (parallel/mesh.py) ------

# (b): MD_WORLD gloo ranks on the one card, each on MD_ROWS rows of one
# global batch, MD_STEPS joint steps from the seeded joint checkpoint,
# against one process on the whole batch with the same draws
MD_WORLD, MD_ROWS, MD_STEPS, MD_SEED = 2, N_RAYS, 3, 1
# Every trainable leaf's update (its move from the checkpoint) by relative
# norm against the one-process run's: the ranks differ from it only in
# the order of f32 sums (each rank's dW over its rows, then the
# all-reduce). Readings (NVIDIA H100 80GB HBM3, 700.00 W): 4.2e-4; the
# control, ranks that skip the reduction, 0.96 (PERF.md §6).
MD_RANKS_TOL = 0.01
# (a): the 1-process --multihost run's ckpt-4 against the run without
# --multihost (run_training), every leaf by relative norm; read 0 (the
# same draws; a one-rank all-reduce copies)
MD_CLI_TOL = 1e-6
MD_TIMEOUT_S = 600


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def md_model(ini, ckpt, device='cuda'):
    """The smoke's joint model at nerfactor.ini's full width and its
    seeded checkpoint's parameters, on ``device``."""
    config = configutil.Config(configutil.read_config(ini))
    model = Model(config, device=device)
    return model, ckptutil.restore_trained_params(
        ckpt, model.init_params(torch.Generator()), device=device)


def md_batch(config, n):
    """``n`` rows of the smoke scene's train rays (whole train batches,
    in the pipeline's order), NumPy."""
    dataset = Dataset(config, 'train')
    parts = []
    for batch in dataset.build_pipeline(prefetch=0):
        parts.append({k: np.asarray(batch[k]) for k in dataset.array_keys})
        if sum(len(p['xyz']) for p in parts) >= n:
            break
    return {k: np.concatenate([p[k] for p in parts])[:n] for k in parts[0]}


def md_updates(model, params, batch, group=None, device='cuda'):
    """MD_STEPS joint steps of ``params`` on ``batch`` (draws from a
    generator seeded MD_SEED): (losses, each leaf's update, the host's
    s of each step, the first a process's first)."""
    init = [t.clone() for t in ckptutil.tree_leaves(params)]
    run = bench_model.stepper(model, params, batch, device, group=group,
                              seed=MD_SEED)
    sync = torch.cuda.synchronize if device != 'cpu' else (lambda: None)
    losses, secs = [], []
    for _ in range(MD_STEPS):
        sync()
        t0 = time.perf_counter()
        losses.append(float(run()))
        sync()
        secs.append(time.perf_counter() - t0)
    return losses, [(t - i).cpu() for t, i in zip(
        ckptutil.tree_leaves(params), init)], secs


def md_rank(rank, world, store, ini, ckpt, batch, out, device):
    """One rank of (b): the steps on its part of ``batch`` with the
    reduction, then (the control) without; rank 0 saves both."""
    mesh.initialize('file://' + store, world, rank, device=device,
                    backend='gloo', timeout_s=MD_TIMEOUT_S)
    try:
        if device != 'cpu':
            kernel_lib.load()  # built by the parent
        part = mesh.shard_batch(batch, rank, world)
        got = {}
        for name, group in (('reduced', mesh.group()), ('no_reduce', None)):
            model, params = md_model(ini, ckpt, device)
            got[name] = md_updates(model, params, part, group, device)
        if rank == 0:
            torch.save(got, out)
    finally:
        mesh.shutdown()


def worst_update(got, want, mask):
    """The worst relative norm over the trainable leaves' updates."""
    return max(rel_norm(g, w) for g, w, m in zip(got, want, mask) if m)


def run_multidevice(joint_override, train_dir, launches_train, ini, ckpt,
                    device='cuda'):
    """(a) trainvali --multihost with one process through NCCL, as
    run_training, counters zeroed before and read after; its ckpt-4
    against run_training's. Then, in one NCCL group of one process, the
    joint step at N_RAYS rows with the reduction against the plain step,
    and the reduction alone. (b) MD_WORLD gloo ranks on the card against
    one process. Returns (launches, record)."""
    outroot = join(WORK, 'out', 'train_multihost')
    override = joint_override + ',' + ','.join([
        'outroot=' + outroot, 'epochs=4', 'ckpt_period=2', 'vali_period=4',
        'vali_batches=1'])
    zero_counters()
    t0 = time.perf_counter()
    outdir = trainvali.main([
        '--config', 'nerfactor.ini', '--config_override', override,
        '--device', device, '--multihost', '--coordinator',
        'localhost:%d' % free_port(), '--num_processes', '1',
        '--process_id', '0'])['outdir']
    if device != 'cpu':
        torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters(JOINT_KERNELS, 'multidevice training')
    tc = ('K1-fwd tc', 'K1-bwd tc', 'K2-fwd tc', 'K2-bwd tc',
          'K1-bwd dW f32 tc')
    if any(launches[k] != launches_train[k] for k in tc):
        raise AssertionError("--multihost launches %s, the run without %s"
                             % (launches, launches_train))
    losses = train_scalars(outdir)
    template = Model(configutil.Config(configutil.read_config(
        outdir + '.ini')), device='cpu').init_params(torch.Generator())
    cli_err = worst_leaf(*(ckptutil.tree_leaves(
        ckptutil.restore_trained_params(
            join(d, 'checkpoints', 'ckpt-4'), template))
        for d in (outdir, train_dir)))
    if not cli_err <= MD_CLI_TOL:
        raise AssertionError("--multihost ckpt-4 vs the run without: %r"
                             % cli_err)
    vali = join(outdir, 'vis_vali', 'epoch000000004', 'batch000000000',
                'pred_rgb.png')
    if not os.path.exists(vali):
        raise AssertionError("--multihost vali: no %s" % vali)

    # The step at world 1 with and without the reduction, and the
    # reduction alone, by CUDA events
    config = configutil.Config(configutil.read_config(ini))
    batch = md_batch(config, MD_WORLD * MD_ROWS)
    one = {}
    if device != 'cpu':
        mesh.initialize('localhost:%d' % free_port(), 1, 0, device=device,
                        timeout_s=MD_TIMEOUT_S)
        try:
            runs = {}
            for name, group in (('plain', None), ('reduced', mesh.group())):
                model, params = md_model(ini, ckpt)
                runs[name] = bench_model.stepper(
                    model, params, mesh.shard_batch(batch, 0, MD_WORLD),
                    device, group=group)
            mask = ckptutil.tree_leaves(model.trainable_mask(params))
            bufs = [torch.zeros_like(t) for t, m in zip(
                ckptutil.tree_leaves(params), mask) if m]
            bufs.append(torch.zeros([], device=device))
            one = dict(zip(('plain_ms', 'reduced_ms'), time_pair(
                runs['plain'], runs['reduced'])))
            one.update(all_mean_ms=time_ms(lambda: mesh.all_mean(bufs)),
                       reduced_bytes=4 * sum(b.numel() for b in bufs),
                       reduced_leaves=len(bufs) - 1)
        finally:
            mesh.shutdown()

    # (b) two ranks on the one card, against one process
    store, out = join(WORK, 'md_rendezvous'), join(WORK, 'md_rank0.pt')
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(md_rank, args=(
        MD_WORLD, store, ini, ckpt, batch, out, device), nprocs=MD_WORLD,
        join=True)
    ranks_s = time.perf_counter() - t0
    got = torch.load(out, weights_only=False)
    model, params = md_model(ini, ckpt, device)
    mask = ckptutil.tree_leaves(model.trainable_mask(params))
    want = md_updates(model, params, batch, device=device)
    ranks = {'loss_rel_err': abs(got['reduced'][0][-1] - want[0][-1])
             / abs(want[0][-1]),
             'update_rel_err': worst_update(got['reduced'][1], want[1], mask),
             'control_no_reduce_update_rel_err': worst_update(
                 got['no_reduce'][1], want[1], mask),
             's_per_step_two_ranks_one_card': got['reduced'][2],
             's_per_step_one_process': want[2],
             'losses': got['reduced'][0],
             'losses_one_process': want[0], 'wall_s': ranks_s}
    if not ranks['update_rel_err'] <= MD_RANKS_TOL \
            or not ranks['control_no_reduce_update_rel_err'] > MD_RANKS_TOL:
        raise AssertionError("two ranks vs one process: %s" % ranks)
    return {'multidevice_training': launches}, {
        'cli': {'seconds': cli_s, 'loss_train': losses,
                'ckpt4_vs_single_process_rel_err': cli_err,
                'launches_tc': {k: launches[k] for k in tc}},
        'world1_nccl': one, 'two_ranks_gloo': ranks,
        'rows_per_rank': MD_ROWS, 'steps': MD_STEPS}


def run_tools():
    """tools.step_time, tools.profile_joint and tools.bench_relight through
    their entry points at their defaults, counters zeroed before and read
    after the two step tools. Returns (launches by path, records)."""
    records, launches = {}, {}
    for name, tool in (('step_time', step_time), ('profile_joint',
                                                  profile_joint)):
        zero_counters()
        records[name] = tool.main([])
        launches['tool_' + name] = read_counters(
            ('K1-fwd', 'K1-fwd tc', 'K1-bwd', 'K1-bwd tc', 'K2-fwd',
             'K2-bwd'), name)
        torch.cuda.empty_cache()
    records['bench_relight'] = bench_relight.main([])
    return launches, records


# ------ the multi-step dispatch: a scan_steps group as one CUDA graph ------

# Every shipped training INI's scan_steps; the steps after a group that an
# epoch leaves over; the groups timed each way
SCAN_STEPS = 8
SCAN_EXTRA = 3
SCAN_TIMED_GROUPS = 4
SCAN_PROFILED_GROUPS = 2
# The phase's scene: two groups and a remainder a training epoch (a train
# batch is one view's rays), at 64 px (the rays a step are the config's)
SCAN_TRAIN = 2 * SCAN_STEPS + SCAN_EXTRA
SCAN_IMH = 64
SCAN_DATA = join(WORK, 'data_scan')


def scan_configs(joint_override, probe_dir):
    """The four paths' configs on the phase's scene, as trainvali builds
    them: (model class, dataset class, config, ini) by path."""
    root, surf = SCAN_DATA, join(SCAN_DATA, 'surf')
    on_scene = ','.join(['data_root=' + root, 'data_nerf_root=' + surf,
                         'imh=%d' % SCAN_IMH, 'light_h=%d' % LIGHT_H])
    joint = joint_override + ',' + on_scene + ',test_envmap_dir=' + probe_dir
    return {
        'joint': (Model, Dataset, 'nerfactor.ini', joint),
        'nerf': (NerfModel, NerfDataset, 'nerf.ini', on_scene),
        'shape': (ShapeModel, Dataset, 'shape.ini', on_scene),
        'microfacet': (MicrofacetModel, Dataset, 'nerfactor_microfacet.ini',
                       joint)}


def scan_batches(dataset, n):
    """``n`` train batches of ``dataset`` (its epochs in turn) as trainvali
    makes them: host tensors, pinned."""
    out = []
    while len(out) < n:
        for batch in dataset.build_pipeline(prefetch=0):
            _, arrays = trainvali.split_batch(dataset, batch)
            out.append({k: torch.from_numpy(np.ascontiguousarray(v))
                         .pin_memory() for k, v in arrays.items()})
    return out[:n]


def stacked(batches):
    return {k: torch.stack([b[k] for b in batches]).pin_memory()
            for k in batches[0]}


def copy_tree(dst, src):
    for d, s in zip(ckptutil.tree_leaves(dst), ckptutil.tree_leaves(src)):
        d.copy_(s)


def events_ms(run, calls):
    """Wall ms of ``calls`` calls of ``run`` by CUDA events recorded around
    them, the host's work to issue them inside."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profiled_window(run, calls):
    """A torch.profiler window over ``calls`` calls of ``run``: (wall ms,
    device busy ms, graph launches the host made)."""
    with card.profiler_window(PROFILER_ACTS) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_us, graph_launches = 0.0, 0
    for e in prof.key_averages():
        if e.key == 'cudaGraphLaunch':
            graph_launches += e.count
    for e in card.device_events(prof):
        busy_us += getattr(e, 'self_device_time_total', 0.0)
    return wall_ms, busy_us / 1e3, graph_launches


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def scan_dispatch_path(name, cls, dataset_cls, cfg):
    """One path's graph against its eager loop (see the docstring's phase
    list). Returns its record."""
    model = cls(cfg, device='cuda')
    dataset = dataset_cls(cfg, 'train')
    optimizer = build_optimizer(cfg)
    start = model.init_params(torch.Generator().manual_seed(0))
    start_opt = optimizer.init(start)
    mask = model.trainable_mask(start) \
        if hasattr(model, 'trainable_mask') else None
    gen0 = torch.Generator(device='cuda').manual_seed(1)
    n_cmp = SCAN_STEPS + SCAN_EXTRA
    batches = scan_batches(dataset, n_cmp + 2 * SCAN_STEPS)
    step = make_train_step(model, optimizer, mask)

    def state():
        p = ckptutil.tree_map(torch.clone, start)
        o = ckptutil.tree_map(torch.clone, start_opt)
        g = torch.Generator(device='cuda')
        g.set_state(gen0.get_state())
        return p, o, g

    def eager(p, o, g, group):
        return [step(p, o, trainvali.to_device(b, 'cuda'), g)[2]
                for b in group]

    # The eager loop: n_cmp steps from the start
    pe, oe, ge = state()
    zero_counters()
    losses_e = torch.stack(eager(pe, oe, ge, batches[:n_cmp]))
    torch.cuda.synchronize()
    eager_counts = counts()
    # The graph: its first call (eager) and its capture (and first replay)
    # on groups of their own, then the start again in its storage, one
    # replay and the remainder's eager steps
    pg, og, gg = state()
    scan = make_train_step_scan(model, optimizer, mask, n_steps=SCAN_STEPS)
    scan(pg, og, stacked(batches[n_cmp:n_cmp + SCAN_STEPS]), gg)
    zero_counters()
    scan(pg, og, stacked(batches[n_cmp + SCAN_STEPS:]), gg)
    torch.cuda.synchronize()
    capture_counts = counts()
    copy_tree((pg, og), (start, start_opt))
    gg.set_state(gen0.get_state())
    group = stacked(batches[:SCAN_STEPS])
    zero_counters()
    torch.cuda.set_sync_debug_mode('error')
    try:
        _, _, losses_g = scan(pg, og, group, gg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    replay_counts = counts()
    losses_g = torch.cat([losses_g, torch.stack(eager(
        pg, og, gg, batches[SCAN_STEPS:n_cmp]))])
    torch.cuda.synchronize()
    pairs = {'losses': [(losses_g, losses_e)],
             'params': list(zip(ckptutil.tree_leaves(pg),
                                ckptutil.tree_leaves(pe))),
             'opt_state': list(zip(ckptutil.tree_leaves(og),
                                   ckptutil.tree_leaves(oe))),
             'generator': [(gg.get_state(), ge.get_state())]}
    bit_equal = {k: all(same_bits(a, b) for a, b in v)
                 for k, v in pairs.items()}
    max_abs = {k: max(float((a.double() - b.double()).abs().max())
                      for a, b in v) for k, v in pairs.items()
               if k != 'generator'}
    if not all(bit_equal.values()):
        raise AssertionError("%s: the graph's %s differ from the eager "
                             "loop's (max |diff| %s)" % (
                                 name, sorted(k for k, v in bit_equal.items()
                                              if not v), max_abs))
    # A replay counts the launches it runs; the call that captures counts
    # its one replay, the capture itself nothing
    if capture_counts != replay_counts:
        raise AssertionError("%s: the capturing call counted %s, a replay %s"
                             % (name, capture_counts, replay_counts))
    per_step_e = {k: v / n_cmp for k, v in eager_counts.items() if v}
    per_step_g = {k: v / SCAN_STEPS for k, v in replay_counts.items() if v}
    if per_step_e != per_step_g:
        raise AssertionError("%s: launches a step eager %s, replayed %s"
                             % (name, per_step_e, per_step_g))
    # ms a step both ways over SCAN_TIMED_GROUPS groups after warm-up, and
    # a profiler window for the idle share
    timed = batches[:SCAN_STEPS]
    runs = {'eager': lambda: eager(pe, oe, ge, timed),
            'graph': lambda: scan(pg, og, group, gg)}
    readings = {}
    for way, run in runs.items():
        run()
        ms = events_ms(run, SCAN_TIMED_GROUPS) / (
            SCAN_TIMED_GROUPS * SCAN_STEPS)
        wall_ms, busy_ms, launches = profiled_window(run,
                                                     SCAN_PROFILED_GROUPS)
        n = SCAN_PROFILED_GROUPS * SCAN_STEPS
        readings[way] = {'ms_per_step': ms,
                         'profiled_wall_ms_per_step': wall_ms / n,
                         'device_busy_ms_per_step': busy_ms / n,
                         'device_idle_share': 1 - busy_ms / wall_ms
                         if busy_ms else None,
                         'idle_share_of_timed_ms': 1 - busy_ms / n / ms
                         if busy_ms else None,
                         'graph_launches_in_window': launches}
    if readings['graph']['graph_launches_in_window'] \
            != SCAN_PROFILED_GROUPS:
        raise AssertionError("%s: %d graph launches for %d groups" % (
            name, readings['graph']['graph_launches_in_window'],
            SCAN_PROFILED_GROUPS))
    return {'bit_equal': bit_equal, 'max_abs_diff': max_abs,
            'steps_compared': n_cmp, 'rays': dataset.bs, **readings,
            'capture_s': scan.captured['seconds'],
            'graph_pool_mib': scan.captured['pool_bytes'] / 2 ** 20,
            'launches_per_step': per_step_g}


def run_scan_training(name, ini, override, kernels, multihost=False,
                      scan_steps=SCAN_STEPS):
    """trainvali.main on ``ini`` on the phase's scene for 2 epochs (two
    groups of SCAN_STEPS and SCAN_EXTRA single steps each), counters
    zeroed before and read after (each of ``kernels`` must launch): the
    graph captured, every group after the first a replay. With
    ``scan_steps`` = 1 every step eager, no graph. Returns (launches,
    record)."""
    suffix = ('_multihost' if multihost else '') + (
        '' if scan_steps == SCAN_STEPS else '_scan%d' % scan_steps)
    outroot = join(WORK, 'out', 'scan_' + name + suffix)
    argv = ['--config', ini, '--config_override', override + ',' + ','.join([
        'outroot=' + outroot, 'epochs=2', 'ckpt_period=2',
        'vali_period=0', 'scan_steps=%d' % scan_steps])]
    if multihost:
        argv += ['--multihost', '--coordinator', 'localhost:%d' % free_port(),
                 '--num_processes', '1', '--process_id', '0']
    zero_counters()
    t0 = time.perf_counter()
    run = trainvali.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    path = 'scan_%s_training%s' % (name, suffix)
    launches = read_counters(kernels, path)
    graph = scan_steps > 1
    if run['scan_steps'] != scan_steps \
            or run['scan_groups'] != (4 if graph else 0) \
            or (run['scan_captured'] is None) == graph:
        raise AssertionError("%s: scan_steps %s, %s groups, captured %s"
                             % (name, run['scan_steps'], run['scan_groups'],
                                run['scan_captured']))
    losses = train_scalars(run['outdir'], steps=[2])
    record = {'seconds': seconds, 'loss_train': losses,
              'groups': run['scan_groups'], 'outdir': run['outdir']}
    if graph:
        record.update(capture_s=run['scan_captured']['seconds'],
                      graph_pool_mib=run['scan_captured']['pool_bytes']
                      / 2 ** 20)
    return launches, record


def same_ckpt(outdir_a, outdir_b):
    """Whether two runs' ckpt-2 hold the same leaves bit for bit; also
    the number of leaves that differ."""
    same = [same_bits(torch.from_numpy(a), torch.from_numpy(b))
            for a, b in zip(*(ckptutil.read_leaves(join(
                d, 'checkpoints', 'ckpt-2')) for d in (outdir_a, outdir_b)))]
    return all(same), same.count(False)


SCAN_KERNELS = {'joint': JOINT_KERNELS + ('K1-fwd f32 tc', 'K1 pack'),
                'nerf': ('K3-fwd', 'K3-fwd tc', 'K3-bwd', 'K3 pack'),
                'shape': SHAPE_KERNELS + ('K1-fwd f32 tc', 'K1 pack'),
                'microfacet': MICROFACET_KERNELS + ('K1-fwd f32 tc',
                                                    'K1 pack')}


def check_scan_dispatch(joint_override, probe_dir):
    """The scan_dispatch phase. Returns (launches by path, record)."""
    t0 = time.perf_counter()
    shutil.rmtree(SCAN_DATA, ignore_errors=True)
    synth_scene.make_scene(SCAN_DATA, n_train=SCAN_TRAIN, n_vali=1, n_test=1,
                           imh=SCAN_IMH, with_buffers=True, light_h=LIGHT_H)
    scene_s = time.perf_counter() - t0
    record, launches = {'scene_s': scene_s}, {}
    for name, (cls, dataset_cls, ini, override) in scan_configs(
            joint_override, probe_dir).items():
        cfg = run_config(ini, override)
        got = scan_dispatch_path(name, cls, dataset_cls, cfg)
        torch.cuda.empty_cache()
        launches['scan_%s_training' % name], got['trainvali'] = \
            run_scan_training(name, ini, override, SCAN_KERNELS[name])
        # The same run with every step eager: the graph's replays after
        # eager remainder steps, its groups filled from the prefetch
        # thread's pinned memory and the epochs' checkpoint hold it bit
        # for bit
        launches['scan_%s_training_scan1' % name], eager = \
            run_scan_training(name, ini, override, SCAN_KERNELS[name],
                              scan_steps=1)
        same, n_differ = same_ckpt(got['trainvali']['outdir'],
                                   eager['outdir'])
        eager['ckpt_bit_equal_to_graph_run'] = same
        if not same:
            raise AssertionError("%s: the scan_steps = %d run's ckpt-2 "
                                 "differs from the scan_steps = 1 run's in "
                                 "%d leaves" % (name, SCAN_STEPS, n_differ))
        got['trainvali_scan1'] = eager
        record[name] = got
        torch.cuda.empty_cache()
    # The joint path again with --multihost (one process, NCCL): the
    # graph holds the gradient all-reduce; its checkpoint is the run's
    # without --multihost bit for bit (a one-rank all-reduce copies)
    cls, dataset_cls, ini, override = scan_configs(joint_override,
                                                   probe_dir)['joint']
    launches['scan_joint_training_multihost'], nccl = run_scan_training(
        'joint', ini, override, SCAN_KERNELS['joint'], multihost=True)
    same, n_differ = same_ckpt(nccl['outdir'],
                               record['joint']['trainvali']['outdir'])
    nccl['ckpt_bit_equal_to_single_process'] = same
    if not same:
        raise AssertionError("--multihost scan run's ckpt-2 differs from "
                             "the single-process run's in %d leaves"
                             % n_differ)
    record['joint']['trainvali_multihost_nccl'] = nccl
    # gloo cannot run in a graph: the scan raises on CUDA tensors
    mesh.initialize('localhost:%d' % free_port(), 1, 0, device='cuda',
                    backend='gloo', timeout_s=MD_TIMEOUT_S)
    try:
        cfg = run_config(ini, override)
        model = cls(cfg, device='cuda')
        params = model.init_params(torch.Generator().manual_seed(0))
        optimizer = build_optimizer(cfg)
        scan = make_train_step_scan(model, optimizer,
                                    model.trainable_mask(params),
                                    n_steps=SCAN_STEPS, group=mesh.group())
        batch = scan_batches(dataset_cls(cfg, 'train'), SCAN_STEPS)
        try:
            scan(params, optimizer.init(params), stacked(batch),
                 torch.Generator(device='cuda').manual_seed(1))
        except ValueError as exc:
            record['gloo_raises'] = str(exc)
        else:
            raise AssertionError("a gloo group's scan ran on CUDA tensors")
    finally:
        mesh.shutdown()
    record['seconds'] = time.perf_counter() - t0
    return launches, record


# ------ the least time the card could take ------

# Published H100 SXM peaks at 700 W (dense): bf16 and TF32 operands on the
# tensor cores (TF32 for the split-TF32 kernels alone, tf32x3_bound); f32
# off them (TF32 is off elsewhere); HBM3 bytes per second.
PEAK_FLOPS = {'bf16': 989e12, 'tf32': 495e12, 'f32': 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flop, n_bytes, dtype):
    """The larger of the operations over the peak for their operand type
    and the bytes (each input read once, each output written once) over
    the memory rate."""
    t_ops, t_bytes = flop / PEAK_FLOPS[dtype], n_bytes / HBM_BYTES_PER_S
    return {'bound_ms': 1e3 * max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'flop': flop, 'bytes': n_bytes}


def chain_macs(plan):
    return sum(d * w for d, w in zip(fm.layer_in_dims(plan), plan.widths))


def chain_bwd_macs(plan, needs_dx, needs_dw):
    """Multiply-adds of K1-bwd: the recompute, dW (with needs_dw), and
    d_pre @ W^T of every layer but the first (and, with needs_dx, of the
    embedding's rows of the first layer and of a skip consumer)."""
    dims = fm.layer_in_dims(plan)
    dgrad = 0
    for i, w in enumerate(plan.widths):
        skip_in = i > 0 and (i - 1) in plan.skip_at
        k = dims[i] if needs_dx and (i == 0 or skip_in) else \
            (plan.widths[i - 1] if i else 0)
        dgrad += k * w
    return chain_macs(plan) * (2 if needs_dw else 1) + dgrad


def weight_bytes(n_weights, n_biases, dtype):
    return n_weights * (2 if dtype == 'bf16' else 4) + 4 * n_biases


def chain_bound(plan, rows, dtype, in_cols, out_cols, bwd=None,
                stash_bytes=0):
    """bound() of K1/K2 over ``rows``: forward, or with ``bwd`` =
    (needs_dx, needs_dw) the backward (inputs and output cotangent in,
    input cotangents and/or f32 dW/db out). ``stash_bytes`` a row: the
    stash route's trig columns, written by K1r-fwd and read by K1r-bwd."""
    n_w, n_b = chain_macs(plan), sum(plan.widths)
    w_bytes = weight_bytes(n_w, n_b, dtype) + rows * stash_bytes
    if bwd is None:
        return bound(2 * rows * chain_macs(plan),
                     4 * rows * (in_cols + out_cols) + w_bytes, dtype)
    needs_dx, needs_dw = bwd
    return bound(2 * rows * chain_bwd_macs(plan, needs_dx, needs_dw),
                 4 * rows * (in_cols * (2 if needs_dx else 1) + out_cols)
                 + w_bytes + (4 * (n_w + n_b) if needs_dw else 0), dtype)


def dot_pass_bound(rows):
    """bound() of one pass of kernel P: 2 * 128 * 128 FLOP a row in bf16,
    and the pass's own bytes, its bf16 weight (the operand is read and
    written once whatever the depth, which the slope leaves out)."""
    return bound(2 * dp.WIDTH * dp.WIDTH * rows, 2 * dp.WIDTH * dp.WIDTH,
                 'bf16')


def nerf_bound(nplan, rows, dtype, bwd=False):
    """bound() of K3-fwd (points and views in, rgb and sigma out) or K3-bwd
    (also d_rgb and d_sigma in; f32 dW/db out; the recompute, dW, and
    d_pre @ W^T of every layer but the first, only the bottleneck's rows
    of rgb layer 0)."""
    tp = nplan.trunk_plan
    width, (hr, n_out) = tp.widths[-1], nplan.rgb_widths
    dense = chain_macs(tp) + width * width \
        + (width + fn.view_dim(nplan)) * hr
    heads = width + hr * n_out
    n_b = sum(tp.widths) + 1 + width + hr + n_out
    w_bytes = weight_bytes(dense, 0, dtype) + 4 * (heads + n_b)
    if not bwd:
        return bound(2 * rows * (dense + heads), 4 * rows * 10 + w_bytes,
                     dtype)
    dgrad = sum(a * b for a, b in zip(tp.widths, tp.widths[1:])) \
        + width + width * width + width * hr + hr * n_out
    return bound(2 * rows * (2 * (dense + heads) + dgrad),
                 4 * rows * 10 + w_bytes + 4 * (dense + heads + n_b), dtype)


def view_readings(ckpt, data_root, repeats):
    """Seconds per view of the two serving entry points, test.main on the
    joint checkpoint ``ckpt`` (3 views, the last with its 512 OLAT
    relights) and nerf_test.main on a NeRF checkpoint that trainvali.main
    trains here (nerf_override's run), each run ``repeats`` times in
    turns: the spread of a tree's own runs, which host work (image writes)
    dominates. It calls nothing but the entry points."""
    nerf_dir = trainvali.main(['--config', 'nerf.ini', '--config_override',
                               nerf_override(data_root)])['outdir']
    nerf_ckpt = join(nerf_dir, 'checkpoints', 'ckpt-4')
    out = []
    for r in range(repeats):
        out.append({'repeat': r,
                    'joint_view_seconds': test_cli.main(
                        ['--ckpt', ckpt])['view_seconds'],
                    'nerf_view_seconds': nerf_test.main(
                        ['--ckpt', nerf_ckpt])['view_seconds']})
    return out


# The reading modes, per kernel: its bf16 backward on one seeded field
# (--field_seed), and the readings behind its error bounds (--limit_seeds;
# each takes the joint experiment's config and the seeds)
FIELD_READINGS = {'k1': k1_field_readings, 'k1r': k1r_field_readings,
                  'k2': k2_field_readings, 'k3': k3_field_readings}
LIMIT_READINGS = {
    'k1': lambda config, seeds: k1_limit_readings(
        Model(config, device='cuda'), seeds),
    'k1r': lambda config, seeds: k1r_limit_readings(
        Model(config, device='cuda'), seeds),
    'k1w': lambda config, seeds: k1w_limit_readings(
        Model(config, device='cuda'), seeds),
    'k2': lambda config, seeds: k2_limit_readings(
        Model(config, device='cuda'), seeds),
    'k3': lambda config, seeds: k3_limit_readings(seeds),
}


def shape_k1(step, plans, fwd):
    """K1-fwd's (``fwd``) or K1-bwd's reading in the shape step: launches
    a step on and off the tensor cores, and the device ms a step of the
    bf16 lvis chain's kernels and the f32 normal chain's (split TF32 on
    the tensor cores; the CUDA-core kernels' beside, 0 where none
    launched), each beside its bound (2N rows of the normal chain, 2N x L
    of lvis; the backwards with dW only; the normal chain's f32 and split
    TF32 bounds)."""
    name = 'K1-fwd' if fwd else 'K1-bwd'
    per_step = step['launches_per_step']
    of = step['device_ms_per_step_of']
    bwd = None if fwd else (False, True)
    rows = 2 * N_RAYS
    if fwd:
        lvis_ms = of['K1-fwd chain_fwd_tc_kernel']
        normal_ms = of['K1-fwd chain_fwd_f32_tc_kernel (f32 normal)']
        core_ms = of['K1-fwd chain_fwd_kernel (CUDA cores)']
    else:
        lvis_ms = of['K1-bwd chain_bwd_tc_kernel'] + of['K1-bwd dw_kernel']
        normal_ms = of['K1-bwd chain_bwd_f32_tc_kernel + dw_f32_kernel '
                       '(f32 normal)']
        core_ms = of['K1-bwd chain_bwd_kernel (CUDA cores)']
    normal_bound = chain_bound(plans['normal'], rows, 'f32', 3, 3, bwd=bwd)
    return {
        'launches_per_step': {'tc': per_step.get(name + ' tc', 0),
                              'all': per_step.get(name, 0),
                              'f32_tc': per_step.get(
                                  'K1-fwd f32 tc' if fwd
                                  else 'K1-bwd dW f32 tc', 0)},
        'lvis_device_ms': lvis_ms,
        'lvis_bound_ms': chain_bound(plans['lvis'], rows * N_LIGHTS, 'bf16',
                                     6, 1, bwd=bwd)['bound_ms'],
        'normal_f32_device_ms': normal_ms,
        'normal_f32_bound': normal_bound,
        'normal_f32_split_tf32_bound': tf32x3_bound(normal_bound),
        'cuda_core_device_ms': core_ms,
        'pack_device_ms': of['K1 pack_transposed_kernel'],
        'sum_slices_device_ms': of['K1 sum_slices_kernel']}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument(
        '--field_seed', nargs=2, metavar=('KERNEL', 'SEED'),
        help="k1, k1r, k2 or k3 and a seed: print only that bf16 "
             "backward's readings (for k2 its cotangents' digest), times "
             "and ptxas report on one field drawn from the seed "
             "(FIELD_READINGS), and stop")
    parser.add_argument(
        '--limit_seeds', nargs=2, metavar=('KERNEL', 'SEEDS'),
        help="k1, k1r, k1w, k2 or k3 and comma-separated seeds: print only "
             "the readings behind that kernel's error bounds over them "
             "(LIMIT_READINGS), one JSON line each, and stop")
    parser.add_argument(
        '--f32_heads', action='store_true',
        help="print only the f32 heads' training pair in split TF32 against "
             "the plain f32 version and the CUDA-core kernels, the packing "
             "kernel, f32 K1-fwd by rows and f32 K1-bwd with dW by rows "
             "(f32_heads_alone), and stop")
    parser.add_argument(
        '--steps', type=int, metavar='N',
        help="print only the joint, shape and microfacet train steps' ms, "
             "host CPU ms, device busy ms and idle share, each run N times "
             "in turns (steps_alone), one JSON line each, and stop")
    parser.add_argument(
        '--scan_dispatch', action='store_true',
        help="print only the scan_dispatch phase's JSON line (each training "
             "path's scan_steps group as one CUDA graph against its eager "
             "loop, and trainvali on the phase's scene), and stop")
    parser.add_argument(
        '--view_repeats', type=int, metavar='N',
        help="print only the serving entry points' seconds per view, each "
             "run N times (view_readings), one JSON line each, and stop")
    args = parser.parse_args(argv)
    for opt, table in (('field_seed', FIELD_READINGS),
                       ('limit_seeds', LIMIT_READINGS)):
        if getattr(args, opt) and getattr(args, opt)[0] not in table:
            parser.error("--%s takes one of %s" % (opt, sorted(table)))
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card.name_and_power()
    t0 = time.perf_counter()
    kernel_lib.load()
    build_s = time.perf_counter() - t0
    if args.field_seed:
        kernel, seed = args.field_seed
        print(json.dumps(FIELD_READINGS[kernel](int(seed))))
        print(gpu)
        return
    shutil.rmtree(WORK, ignore_errors=True)
    data_root, nerf_root = join(WORK, 'data'), join(WORK, 'data', 'surf')
    probe_dir = join(WORK, 'data', 'envmaps')
    write_scene(data_root, nerf_root)
    rng = np.random.RandomState(0)
    for name in ('courtyard', 'sunset'):
        ioutil.save_np(rng.rand(LIGHT_H, 2 * LIGHT_H, 3).astype(np.float32),
                       join(probe_dir, name + '.npy'))
    config, ckpt, joint_override = write_experiments(
        data_root, nerf_root, probe_dir)
    if args.f32_heads:
        print(json.dumps(f32_heads_alone(config, ckpt)))
        print(gpu)
        return
    if args.scan_dispatch:
        _, scan_record = check_scan_dispatch(joint_override, probe_dir)
        print(json.dumps(dict(scan_record, phase='scan_dispatch', gpu=gpu)))
        print(gpu)
        return
    if args.steps:
        for r in steps_alone(config, joint_override, data_root, nerf_root,
                             args.steps):
            print(json.dumps(r))
        print(gpu)
        return
    if args.limit_seeds or args.view_repeats:
        if args.limit_seeds:
            kernel, seeds = args.limit_seeds
            rows = LIMIT_READINGS[kernel](
                config, [int(x) for x in seeds.split(',')])
        else:
            rows = view_readings(ckpt, data_root, args.view_repeats)
        for r in rows:
            print(json.dumps(r))
        print(gpu)
        return
    tc_block = check_tc_block()
    tc_sass = check_tc_sass()
    k2_field = k2_field_readings(0, iters=3)

    model = Model(config, device='cuda')
    params = ckptutil.restore_trained_params(
        ckpt, model.init_params(torch.Generator()), device='cuda')
    with torch.no_grad():
        k1, k2 = check_kernels(model, params)

    # The inference path, through the user's entry point
    zero_counters()
    run = test_cli.main(['--ckpt', ckpt])
    launches_infer = read_counters(('K1-fwd', 'K1-fwd tc', 'K2-fwd',
                                    'K2-fwd tc'), 'inference')

    batch_dirs = ioutil.sortglob(run['outroot'], 'batch?????????')
    if len(batch_dirs) != N_VIEWS:
        raise AssertionError("expected %d view dirs, got %d"
                             % (N_VIEWS, len(batch_dirs)))
    for d in batch_dirs:
        for f in ('pred_rgb', 'pred_albedo', 'pred_brdf', 'pred_normal',
                  'pred_lvis', 'pred_rgb_probes_courtyard',
                  'pred_rgb_probes_sunset'):
            img = ioutil.load_img(join(d, f + '.png'))
            if img.shape[:2] != (IMH, IMH):
                raise AssertionError("%s/%s.png: shape %s" % (d, f, img.shape))
    n_olat = len(ioutil.sortglob(batch_dirs[-1], 'pred_rgb_olat_*.png'))
    n_olat_first = len(ioutil.sortglob(batch_dirs[0], 'pred_rgb_olat_*.png'))
    if n_olat != LIGHT_H * 2 * LIGHT_H // 2 or n_olat_first:
        raise AssertionError("OLAT files: %d on the last view, %d on the "
                             "first" % (n_olat, n_olat_first))

    model_cpu = Model(config, device='cpu')
    fwd_err = check_forward(model, model_cpu, params, Dataset(config, 'test'))

    k1b, k2b = check_backward(model, params)
    heads = {'joint': joint_f32_heads(model, params)}
    torch.cuda.empty_cache()
    k1r, x_last_skip = check_stash_route(model, params)
    torch.cuda.empty_cache()
    launches_last_skip, k1w = check_last_skip(params, x_last_skip)
    f32_dw_rows = f32_dw_by_rows(params, x_last_skip)
    plans, z_dim = model.plans, model.z_dim
    del model, model_cpu, params, x_last_skip
    torch.cuda.empty_cache()

    # The training path, through the user's entry point
    t0 = time.perf_counter()
    launches_train, outdir, train_out = run_training(joint_override)
    train_s = time.perf_counter() - t0
    train_config = configutil.Config(configutil.read_config(outdir + '.ini'))
    step = dict(time_train_step(Model(train_config, device='cuda'),
                                Dataset(train_config, 'train')),
                n_lights=N_LIGHTS)
    torch.cuda.empty_cache()
    step_stash, launches_stash_step = run_stash_step(train_config)
    torch.cuda.empty_cache()

    # The stages whose checkpoints the joint model restores, through the
    # user's entry points: the shape stage, the BRDF prior and its
    # explorer, then the joint model from both
    t0 = time.perf_counter()
    launches_shape, shape_dir, shape_train = run_shape_training(data_root,
                                                                nerf_root)
    shape_train['seconds'] = time.perf_counter() - t0
    shape_config = configutil.Config(configutil.read_config(
        shape_dir + '.ini'))
    shape_agreement = check_shape_step(shape_config)
    torch.cuda.empty_cache()
    shape_step = time_train_step(ShapeModel(shape_config, device='cuda'),
                                 Dataset(shape_config, 'train'),
                                 kernels=SHAPE_STEP_KERNELS)
    shape_model = ShapeModel(shape_config, device='cuda')
    heads['shape'] = f32_heads(model_head_cases(
        shape_model, shape_model.init_params(torch.Generator().manual_seed(0)),
        ('normal',)), torch.Generator().manual_seed(18))
    del shape_model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_brdf, brdf_dir, brdf_train = run_brdf_training(
        write_merl_tables(join(WORK, 'data', 'merl_npz')))
    brdf_train['seconds'] = time.perf_counter() - t0
    brdf_config = configutil.Config(configutil.read_config(brdf_dir + '.ini'))
    brdf_step = time_train_step(BrdfModel(brdf_config, device='cuda'),
                                BrdfDataset(brdf_config, 'train'))
    launches_explore, explore = run_brdf_explore(
        join(brdf_dir, 'checkpoints', 'ckpt-4'))
    launches_joint_port, joint_port = run_joint_from_port_stages(
        data_root, nerf_root, probe_dir, shape_dir, brdf_dir,
        MERL_MATERIALS[1])
    torch.cuda.empty_cache()

    # The NeRF slice: training and serving through the user's entry points
    t0 = time.perf_counter()
    launches_nerf_train, nerf_dir, nerf_train = run_nerf_training(data_root)
    nerf_train_s = time.perf_counter() - t0
    nerf_ckpt = join(nerf_dir, 'checkpoints', 'ckpt-4')
    launches_nerf_test, nerf_view_s = run_nerf_serving(nerf_ckpt)
    nerf_fwd_err = check_nerf_forward(nerf_dir, nerf_ckpt)
    nerf_model = NerfModel(nerf_config(nerf_dir), device='cuda')
    nerf_trained = ckptutil.restore_trained_params(
        nerf_ckpt, nerf_model.init_params(torch.Generator()), device='cuda')
    k3 = check_nerf_kernels(nerf_model, nerf_trained)
    k3_pack = k3_pack_readings(nerf_model.nerf_plan, nerf_params(
        nerf_model, nerf_trained, 'fine'))
    del nerf_trained
    torch.cuda.empty_cache()
    k1_no_views = check_no_views_chain(torch.Generator().manual_seed(5))
    torch.cuda.empty_cache()
    nerf_step = time_train_step(nerf_model, NerfDataset(nerf_model.config,
                                                        'train'))
    nplan = nerf_model.nerf_plan
    del nerf_model
    torch.cuda.empty_cache()

    # Geometry distillation from the NeRF run's checkpoint through the
    # user's entry point, the shape stage on its buffers, the sigma chain
    # at distillation's shapes and the march probe
    launches_distill, surf_root, distill = run_distillation(nerf_dir)
    view_rays = distill_view_rays(nerf_dir)
    distill['card_vs_cpu'] = check_distillation(nerf_dir, view_rays)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_shape_distilled, _, shape_distilled = run_shape_training(
        DISTILL_DATA, surf_root, imh=DISTILL_IMH, outname='shape_distilled')
    shape_distilled['seconds'] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    sigma_fwd, sigma_bwd = check_sigma_chain(nerf_dir, view_rays)
    torch.cuda.empty_cache()
    zero_counters()
    march = march_probe.main([])
    launches_march = read_counters(('K1-fwd', 'K1-fwd tc', 'K1-bwd'),
                                   'march probe')
    torch.cuda.empty_cache()

    # The probes, through their command-line entry points
    probe_records, launches_probe = run_chain_probe()
    torch.cuda.empty_cache()
    launches_dot, p_run = check_dot_probe()
    torch.cuda.empty_cache()

    # The pipeline end to end through the user's entry points: the
    # harness in both modes, then test.py and nerf_test.py with the video
    # compile on its checkpoints
    launches_e2e, e2e = check_pipeline()
    torch.cuda.empty_cache()

    # The shipped variants through the user's entry points: the GGX
    # microfacet ablation, then the MVS path from a DTU-style scan
    launches_micro, micro_dir, micro = run_microfacet(joint_override)
    micro_config = configutil.Config(configutil.read_config(
        micro_dir + '.ini'))
    micro['step_agreement'] = check_microfacet_step(micro_config)
    micro['lobe'] = check_microfacet_lobe()
    torch.cuda.empty_cache()
    micro['train_step'] = time_train_step(
        MicrofacetModel(micro_config, device='cuda'),
        Dataset(micro_config, 'train'))
    micro_model = MicrofacetModel(micro_config, device='cuda')
    heads['microfacet'] = f32_heads(model_head_cases(
        micro_model, micro_model.init_params(torch.Generator().manual_seed(0)),
        ('brdf_z', 'albedo', 'normal')), torch.Generator().manual_seed(26))
    del micro_model
    if set(micro['train_step']['launches_per_step']) & set(NO_K2):
        raise AssertionError("K2 launched in the microfacet step: %s"
                             % micro['train_step']['launches_per_step'])
    torch.cuda.empty_cache()
    launches_mvs, mvs = run_mvs(probe_dir)
    torch.cuda.empty_cache()

    # The dataset converters on inputs at real data's sizes, then NeRF
    # and the BRDF prior on what they wrote, through the user's entry
    # points
    t0 = time.perf_counter()
    launches_data_gen, data_gen = run_data_gen()
    data_gen['seconds'] = time.perf_counter() - t0
    print(json.dumps(dict(data_gen, gpu=gpu)))
    torch.cuda.empty_cache()

    # Multi-device training: --multihost through the user's entry point
    # (NCCL, one process), the reduction's cost, two gloo ranks on the
    # card against one process; then the step and relight tools
    t0 = time.perf_counter()
    launches_md, multidevice = run_multidevice(
        joint_override, outdir, launches_train, ckpt.rsplit(
            '/checkpoints/', 1)[0] + '.ini', ckpt)
    torch.cuda.empty_cache()
    launches_tools, multidevice['tools'] = run_tools()
    multidevice['seconds'] = time.perf_counter() - t0
    print(json.dumps(dict(multidevice, phase='multidevice', gpu=gpu)))
    torch.cuda.empty_cache()

    # The multi-step dispatch: each training path's scan_steps group as
    # one CUDA graph against its eager loop, and trainvali through it
    launches_scan, scan_dispatch = check_scan_dispatch(joint_override,
                                                       probe_dir)
    print(json.dumps(dict(scan_dispatch, phase='scan_dispatch', gpu=gpu)))

    paths = {'joint_inference': launches_infer,
             'joint_training': launches_train,
             'nerf_training': launches_nerf_train,
             'nerf_inference': launches_nerf_test,
             'last_skip_chain': launches_last_skip,
             'joint_training_stash_route': launches_stash_step,
             'shape_training': launches_shape,
             'brdf_training': launches_brdf, 'brdf_explore': launches_explore,
             'joint_from_port_stages': launches_joint_port,
             'distillation': launches_distill,
             'shape_from_distilled_buffers': launches_shape_distilled,
             'march_probe': launches_march,
             **{'chain_probe_' + k: v for k, v in launches_probe.items()},
             'dot_probe': launches_dot, **launches_e2e,
             **launches_micro, **launches_mvs, **launches_data_gen,
             **launches_md, **launches_tools, **launches_scan}
    variant_paths = list(launches_micro) + list(launches_mvs)

    def on_variants(kernel):
        """A kernel's launches on each path of the variants, 0 included."""
        return {p: {'all': paths[p][kernel], 'tc': paths[p][kernel + ' tc']}
                for p in variant_paths}
    src = 'nerfactor_tpu_torch/csrc/'

    def entry(name, source, replaces, row, bound_, library_ms=None,
              counter=None, **extra):
        counter = counter or name.split()[0]
        by_path = {p: c[counter] for p, c in paths.items() if c[counter]}
        return dict({'name': name, 'route': 'cuda', 'source': src + source,
                     'replaces': replaces,
                     'launches': sum(by_path.values()),
                     'launches_by_path': by_path, 'ms': row['ms'],
                     'plain_ms': row['plain_ms'],
                     'bound_ms': bound_['bound_ms'],
                     'bound_by': bound_['bound_by'], 'library_ms': library_ms,
                     'bound_at': dict(bound_, rows=row['rows'],
                                      dtype=row['dtype'])}, **extra)

    lvis_b = [r for r in k1b if r['chain'] == 'lvis'][0]
    lvis_f = lvis_b['fwd']
    k1r_lvis = [r for r in k1r if r['chain'] == 'lvis'
                and r['dtype'] == 'bf16'][0]
    k1r_f = k1r_lvis['fwd']

    def cuda_core_by_path(kernel):
        """A kernel's CUDA-core launches by path: all of its launches but
        its tensor-core ones (K1's f32 ones too)."""
        def tc(c):
            return c[kernel + ' tc'] + sum(c.get(k, 0) for k in {
                'K1-fwd': ('K1-fwd f32 tc',),
                'K1-bwd': ('K1-bwd dx tc', 'K1-bwd dW f32 tc')}.get(
                    kernel, ()))
        return {p: c[kernel] - tc(c) for p, c in paths.items()
                if c[kernel] - tc(c)}
    def f32_entry(name, replaces, readings, keys, counter, kernel, **extra):
        """The kernels line's entry of one of K1's f32 tensor-core
        kernels: its readings at distillation's shapes (check_sigma_chain;
        the first of ``keys`` the depth/normal block's fine rows), its
        launches on every path, ptxas report and HMMA count. Its bound is
        the split-TF32 one (bound_at's flop counts the three TF32
        products), the f32 bound on the CUDA cores beside it."""
        row = readings[keys[0]]
        return entry(name, 'chain_f32_tc.cu', replaces, row, row['bound_at'],
                     counter=counter,
                     max_abs_err=max(readings[k]['max_abs_err'] for k in keys),
                     device_ms=row['device_ms'], tflops=row['tflops'],
                     f32_cuda_core_bound_ms=row['f32_cuda_core_bound_ms'],
                     cuda_core_ms=row['cuda_core_ms'],
                     distillation={k: readings[k] for k in keys},
                     ptxas=ptxas_report((kernel,)),
                     sass_hmma=hmma_of(tc_sass, kernel + '_kernel'), **extra)
    k1w_bf16 = [r for r in k1w if r['dtype'] == 'bf16'][0]
    k1w_f = k1w_bf16['fwd']
    # The f32 heads' training pair: every head of phases 6, 18 and 26; the
    # joint step's normal head (2,048 rows) the row's numbers
    all_heads = {k: v['heads'] if isinstance(v, dict) else v
                 for k, v in heads.items()}
    head_b = all_heads['joint'][0]
    k3_fine = [r for r in k3 if r['rows'] > NERF_RAYS * NERF_COARSE]
    k3_bf16 = [r for r in k3_fine if r['dtype'] == 'bf16'][0]
    result = json.dumps({'kernels': [
        entry('K1-fwd chain_fwd_tc_kernel', 'fused_mlp.cu',
              'nerfactor_tpu/ops/pallas_mlp.py:1424', lvis_f,
              chain_bound(plans['lvis'], lvis_f['rows'], 'bf16', 6, 1),
              counter='K1-fwd tc',
              max_abs_err=max([r['max_abs_err'] for r in k1]
                              + [r['fwd_max_abs_err'] for r in k1b]
                              + [r['fwd_max_abs_err'] for r in k1_no_views]),
              tflops=lvis_f['tflops'], fwd_device_ms=lvis_f['fwd_device_ms'],
              cuda_core_ms=lvis_f['cuda_core_ms'],
              tc_vs_cuda_core_rel_err=lvis_f['tc_vs_cuda_core_rel_err'],
              cuda_core_launches_by_path=cuda_core_by_path('K1-fwd'),
              launches_per_step={'tc': step['launches_per_step'].get(
                  'K1-fwd tc', 0), 'all': step['launches_per_step'].get(
                      'K1-fwd', 0)},
              launches_per_view={k: launches_infer[c] / N_VIEWS for k, c in (
                  ('tc', 'K1-fwd tc'), ('all', 'K1-fwd'))},
              shape_step=shape_k1(shape_step, plans, fwd=True),
              distillation={'march_bf16': sigma_fwd['march_bf16']},
              launches_on_variant_paths=on_variants('K1-fwd'),
              ptxas=ptxas_report(('chain_fwd',)),
              sass_hmma=hmma_of(tc_sass, 'chain_fwd_tc_kernel'),
              shapes=k1, nerf_no_views=k1_no_views),
        entry('K1-bwd chain_bwd_tc_kernel + dw_kernel', 'fused_mlp.cu',
              'nerfactor_tpu/ops/pallas_mlp.py:1497', lvis_b,
              chain_bound(plans['lvis'], lvis_b['rows'], lvis_b['dtype'], 6,
                          1, bwd=(False, True)), counter='K1-bwd tc',
              max_abs_err=max(r['dx_max_abs_err'] for r in k1b
                              if 'dx_max_abs_err' in r),
              max_rel_err={'dW_db': max(r['dw_rel_err']
                                        for r in k1b + k1_no_views),
                           'dx_bf16': lvis_b['dx_rel_err']},
              phase1_ms=lvis_b['phase1_ms'], dw_pass_ms=lvis_b['dw_pass_ms'],
              sums_ms=lvis_b['sums_ms'], packing_ms=lvis_b['packing_ms'],
              scratch_bytes=lvis_b['scratch_bytes'], tflops=lvis_b['tflops'],
              cuda_core_launches_by_path=cuda_core_by_path('K1-bwd'),
              shape_step=shape_k1(shape_step, plans, fwd=False),
              launches_on_variant_paths=on_variants('K1-bwd'),
              ptxas=ptxas_report(('chain_bwd_tc', 'dw_kernel')),
              sass_hmma=hmma_of(tc_sass, 'chain_bwd_tc_kernel', 'dw_kernel'),
              shapes=k1b),
        f32_entry('K1-fwd f32 chain_fwd_f32_tc_kernel',
                  'nerfactor_tpu/ops/pallas_mlp.py:1424', sigma_fwd,
                  ('depth_normal_f32', 'depth_normal_coarse_f32'),
                  'K1-fwd f32 tc', 'chain_fwd_f32_tc',
                  min_rows_alone=fm.F32_TC_MIN_ROWS,
                  heads=[r for r in k1 if r['dtype'] == 'f32'],
                  training_heads={
                      k: [{f: r[f] for f in HEAD_FWD_KEYS} for r in v]
                      for k, v in all_heads.items()},
                  pack_transposed=dict(
                      heads['joint']['pack'],
                      launches_by_path={p: c['K1 pack'] for p, c in
                                        paths.items() if c.get('K1 pack')})),
        f32_entry('K1-bwd dx chain_dx_f32_tc_kernel',
                  'nerfactor_tpu/ops/pallas_mlp.py:1497', sigma_bwd,
                  ('dx_only_f32', 'dx_only_coarse_f32'), 'K1-bwd dx tc',
                  'chain_dx_f32_tc'),
        entry('K1-bwd dW f32 chain_bwd_f32_tc_kernel + dw_f32_kernel',
              'chain_f32_tc.cu', 'nerfactor_tpu/ops/pallas_mlp.py:1497',
              dict(head_b, ms=head_b['bwd_ms'],
                   plain_ms=head_b['bwd_plain_ms']),
              head_b['bwd_bound'], counter='K1-bwd dW f32 tc',
              max_abs_err=max(r['dw_max_abs_err'] for v in all_heads.values()
                              for r in v),
              max_rel_err={'dW_db': max(r['dw_rel_err']
                                        for v in all_heads.values()
                                        for r in v)},
              device_ms=head_b['bwd_device_ms'],
              phase1_device_ms=head_b['phase1_device_ms'],
              dw_pass_device_ms=head_b['dw_pass_device_ms'],
              launches_per_backward=head_b['bwd_launches'],
              phase1_blocks=head_b['phase1_blocks'],
              dw_chunks=head_b['dw_chunks'],
              scratch_bytes=head_b['scratch_bytes'],
              f32_cuda_core_bound_ms=head_b['bwd_f32_bound_ms'],
              cuda_core_ms=head_b['bwd_cuda_core_ms'],
              cuda_core_device_ms=head_b['bwd_cuda_core_device_ms'],
              cuda_core_launches_by_path=cuda_core_by_path('K1-bwd'),
              ptxas=ptxas_report(('chain_bwd_f32_tc', 'dw_f32')),
              sass_hmma=hmma_of(tc_sass, 'chain_bwd_f32_tc_kernel',
                                'dw_f32_kernel'),
              heads=all_heads, lvis_by_rows=f32_dw_rows),
        entry('K2-fwd rusink_chain_fwd_tc_kernel', 'fused_rusink.cu',
              'nerfactor_tpu/ops/pallas_rusink.py:187', k2,
              chain_bound(plans['brdf'], k2['rows'], k2['dtype'], z_dim + 6,
                          1), counter='K2-fwd tc',
              max_abs_err=max(k2['max_abs_err'], k2b['fwd_max_abs_err']),
              tflops=k2['tflops'], fwd_device_ms=k2['fwd_device_ms'],
              cuda_core_ms=k2['cuda_core_ms'],
              tc_vs_cuda_core_rel_err=k2['tc_vs_cuda_core_rel_err'],
              cuda_core_launches_by_path=cuda_core_by_path('K2-fwd'),
              launches_per_step={'tc': step['launches_per_step'].get(
                  'K2-fwd tc', 0), 'all': step['launches_per_step'].get(
                      'K2-fwd', 0)},
              launches_per_view={k: launches_infer[c] / N_VIEWS for k, c in (
                  ('tc', 'K2-fwd tc'), ('all', 'K2-fwd'))},
              launches_on_variant_paths=on_variants('K2-fwd'),
              ptxas=ptxas_report(('rusink_chain_fwd',)),
              sass_hmma=hmma_of(tc_sass, 'rusink_chain_fwd_tc_kernel'),
              train_shape=dict(k2b['fwd'], bound_ms=chain_bound(
                  plans['brdf'], k2b['rows'], 'bf16', z_dim + 6,
                  1)['bound_ms']),
              shapes=[k2]),
        entry('K2-bwd rusink_chain_bwd_tc_kernel', 'fused_rusink.cu',
              'nerfactor_tpu/ops/pallas_rusink.py:200', k2b,
              chain_bound(plans['brdf'], k2b['rows'], k2b['dtype'],
                          z_dim + 6, 1, bwd=(True, False)),
              counter='K2-bwd tc', max_abs_err=k2b['max_abs_err'],
              max_rel_err={'bf16': k2b['bf16_rel_err']},
              tflops=k2b['tflops'], bwd_device_ms=k2b['bwd_device_ms'],
              packing_ms=k2b['packing_ms'], cuda_core_ms=k2b['cuda_core_ms'],
              tc_vs_cuda_core_rel_err=k2b['tc_vs_cuda_core_rel_err'],
              launches_per_step={'tc': step['launches_per_step'].get(
                  'K2-bwd tc', 0), 'all': step['launches_per_step'].get(
                      'K2-bwd', 0)},
              launches_on_variant_paths=on_variants('K2-bwd'),
              ptxas=ptxas_report(('rusink_chain_bwd',)),
              sass_hmma=hmma_of(tc_sass, 'rusink_chain_bwd_tc_kernel'),
              field_seed_0=k2_field, shapes=[k2b]),
        entry('K3-fwd nerf_fwd_tc_kernel', 'fused_nerf.cu',
              'nerfactor_tpu/ops/pallas_nerf.py:153', k3_bf16,
              nerf_bound(nplan, k3_bf16['rows'], 'bf16'), counter='K3-fwd tc',
              max_abs_err=max(r['max_abs_err'] for r in k3
                              if r['dtype'] == 'f32'),
              max_rel_err={'bf16': max(r['out_rel_err'] for r in k3
                                       if 'out_rel_err' in r)},
              tflops=k3_bf16['tflops'], fwd_device_ms=k3_bf16['fwd_device_ms'],
              cuda_core_ms=k3_bf16['cuda_core_ms'],
              tc_vs_cuda_core_rel_err=k3_bf16['tc_vs_cuda_core_rel_err'],
              f32_cuda_core_ms=[r['ms'] for r in k3_fine
                                if r['dtype'] == 'f32'][0],
              launches_per_step={'tc': nerf_step['launches_per_step'].get(
                  'K3-fwd tc', 0)},
              launches_per_view={'tc': launches_nerf_test['K3-fwd tc']
                                 / N_VIEWS},
              ptxas=ptxas_report(('nerf_fwd',)),
              sass_hmma=hmma_of(tc_sass, 'nerf_fwd_tc_kernel'),
              pack=dict(k3_pack, launches_by_path={
                  p: c['K3 pack'] for p, c in paths.items()
                  if c['K3 pack']}),
              shapes=k3),
        entry('K3-bwd nerf_bwd_kernel', 'fused_nerf.cu',
              'nerfactor_tpu/ops/pallas_nerf.py:203',
              dict(k3_bf16, ms=k3_bf16['bwd_ms'],
                   plain_ms=k3_bf16['bwd_plain_ms']),
              nerf_bound(nplan, k3_bf16['rows'], 'bf16', bwd=True),
              max_rel_err={'dW_db': max(r['dw_rel_err'] for r in k3)},
              phase1_ms=k3_bf16['phase1_ms'],
              dw_pass_ms=k3_bf16['dw_pass_ms'], sums_ms=k3_bf16['sums_ms'],
              packing_ms=k3_bf16['packing_ms'],
              scratch_bytes=k3_bf16['scratch_bytes'],
              tflops=k3_bf16['bwd_tflops'], tc_block=tc_block,
              sass_hmma=hmma_of(tc_sass, 'nerf_bwd_tc_kernel', 'dw_kernel'),
              shapes=k3),
        entry('K1r-fwd chain_stash_fwd_tc_kernel', 'fused_mlp.cu',
              'nerfactor_tpu/ops/pallas_mlp.py:851', k1r_lvis,
              chain_bound(plans['lvis'], k1r_lvis['rows'], k1r_lvis['dtype'],
                          6, 1, stash_bytes=2 * fm.trig_dim(plans['lvis'])),
              counter='K1r-fwd tc',
              max_abs_err=max(r['max_abs_err'] for r in k1r),
              stash_max_abs_err=max(r['stash_max_abs_err'] for r in k1r),
              stash_same_as_cuda_core=k1r_f['stash_same_as_cuda_core'],
              tflops=k1r_f['tflops'], fwd_device_ms=k1r_f['fwd_device_ms'],
              cuda_core_ms=k1r_f['cuda_core_ms'],
              tc_vs_cuda_core_rel_err=k1r_f['tc_vs_cuda_core_rel_err'],
              cuda_core_launches_by_path=cuda_core_by_path('K1r-fwd'),
              launches_per_step={
                  k: step_stash['launches_per_step'].get(c, 0) for k, c in (
                      ('tc', 'K1r-fwd tc'), ('all', 'K1r-fwd'))},
              ptxas=ptxas_report(('chain_stash_fwd',)),
              sass_hmma=hmma_of(tc_sass, 'chain_stash_fwd_tc_kernel'),
              shapes=k1r),
        entry('K1r-bwd chain_stash_bwd_tc_kernel + dw_kernel', 'fused_mlp.cu',
              'nerfactor_tpu/ops/pallas_mlp.py:878',
              dict(k1r_lvis, ms=k1r_lvis['bwd_ms'],
                   plain_ms=k1r_lvis['bwd_plain_ms']),
              chain_bound(plans['lvis'], k1r_lvis['rows'], k1r_lvis['dtype'],
                          6, 1, bwd=(False, True),
                          stash_bytes=2 * fm.trig_dim(plans['lvis'])),
              counter='K1r-bwd tc',
              max_abs_err=max(r['dx_max_abs_err'] for r in k1r
                              if 'dx_max_abs_err' in r),
              max_rel_err={'dW_db': max(r['dw_rel_err'] for r in k1r),
                           'dx_f32': max(r['dx_rel_err'] for r in k1r
                                         if 'dx_rel_err' in r)},
              phase1_ms=k1r_lvis['phase1_ms'],
              dw_pass_ms=k1r_lvis['dw_pass_ms'], sums_ms=k1r_lvis['sums_ms'],
              packing_ms=k1r_lvis['packing_ms'],
              scratch_bytes=k1r_lvis['scratch_bytes'],
              tflops=k1r_lvis['bwd_tflops'],
              cuda_core_ms=k1r_lvis['cuda_core_bwd_ms'],
              tc_vs_cuda_core_rel_err=k1r_lvis['tc_vs_cuda_core_dw_rel_err'],
              dw_bit_identical=k1r_lvis['dw_bit_identical'],
              cuda_core_launches_by_path=cuda_core_by_path('K1r-bwd'),
              launches_per_step={
                  k: step_stash['launches_per_step'].get(c, 0) for k, c in (
                      ('tc', 'K1r-bwd tc'), ('all', 'K1r-bwd'))},
              ptxas=ptxas_report(('chain_stash_bwd_tc',)),
              sass_hmma=hmma_of(tc_sass, 'chain_stash_bwd_tc_kernel'),
              shapes=k1r),
        entry('K1w-fwd chain_last_skip_fwd_tc_kernel', 'fused_mlp.cu',
              'nerfactor_tpu/ops/pallas_mlp.py:416', k1w_bf16,
              chain_bound(LAST_SKIP_PLAN, k1w_bf16['rows'], 'bf16', 6,
                          fm.out_dim(LAST_SKIP_PLAN)), counter='K1w-fwd tc',
              max_abs_err=max(r['max_abs_err'] for r in k1w),
              head_same_as_k1=k1w_bf16['head_same_as_k1'],
              embed_same_as_cuda_core=k1w_f['embed_same_as_cuda_core'],
              tflops=k1w_f['tflops'], fwd_device_ms=k1w_f['fwd_device_ms'],
              cuda_core_ms=k1w_f['cuda_core_ms'],
              tc_vs_cuda_core_rel_err=k1w_f['tc_vs_cuda_core_rel_err'],
              cuda_core_launches_by_path=cuda_core_by_path('K1w-fwd'),
              launches_on_path={k: launches_last_skip[c] for k, c in (
                  ('tc', 'K1w-fwd tc'), ('all', 'K1w-fwd'))},
              ptxas=ptxas_report(('chain_last_skip_fwd',)),
              sass_hmma=hmma_of(tc_sass, 'chain_last_skip_fwd_tc_kernel'),
              shapes=k1w),
        entry('K1w-bwd chain_last_skip_bwd_tc_kernel + dw_kernel + '
              'chain_dx_pass_kernel', 'fused_mlp.cu',
              'nerfactor_tpu/ops/pallas_mlp.py:452',
              dict(k1w_bf16, ms=k1w_bf16['bwd_ms'],
                   plain_ms=k1w_bf16['bwd_plain_ms']),
              chain_bound(LAST_SKIP_PLAN, k1w_bf16['rows'], 'bf16', 6,
                          fm.out_dim(LAST_SKIP_PLAN), bwd=(True, True)),
              counter='K1w-bwd tc',
              max_abs_err=max(r['dx_max_abs_err'] for r in k1w),
              max_rel_err={'dW_db': max(r['dw_rel_err'] for r in k1w),
                           'dx': max(r['dx_rel_err'] for r in k1w)},
              phase1_ms=k1w_bf16['phase1_ms'],
              dw_pass_ms=k1w_bf16['dw_pass_ms'],
              dx_pass_ms=k1w_bf16['dx_pass_ms'], sums_ms=k1w_bf16['sums_ms'],
              packing_ms=k1w_bf16['packing_ms'],
              dw_only_ms=k1w_bf16['bwd_dw_only_ms'],
              dx_only_ms=k1w_bf16['bwd_dx_only_ms'],
              scratch_bytes=k1w_bf16['scratch_bytes'],
              tflops=k1w_bf16['bwd_tflops'],
              cuda_core_ms=k1w_bf16['cuda_core_bwd_ms'],
              tc_vs_cuda_core_dx_rel_err=k1w_bf16[
                  'tc_vs_cuda_core_dx_rel_err'],
              f32_kernel_vs_cuda_core_dx_rel_err=k1w_bf16[
                  'f32_kernel_vs_cuda_core_dx_rel_err'],
              dw_same_as_k1=k1w_bf16['dw_same_as_k1'],
              dw_bit_identical=k1w_bf16['dw_bit_identical'],
              cuda_core_launches_by_path=cuda_core_by_path('K1w-bwd'),
              launches_on_path={k: launches_last_skip[c] for k, c in (
                  ('tc', 'K1w-bwd tc'), ('all', 'K1w-bwd'))},
              ptxas=ptxas_report(('chain_last_skip_bwd', 'chain_dx_pass')),
              sass_hmma=hmma_of(tc_sass, 'chain_last_skip_bwd_tc_kernel',
                                'chain_dx_pass_kernel'),
              shapes=k1w),
        entry('P dot_chain_kernel', 'dot_probe.cu',
              'tools/mosaic_dot_probe.py:74',
              {'ms': p_run['summary']['serial']['ms_per_pass'],
               'plain_ms': p_run['plain_ms_per_pass'], 'rows': p_run['cols'],
               'dtype': 'bf16'},
              dot_pass_bound(p_run['cols']),
              library_ms=p_run['library_ms_per_pass'],
              unit='ms per pass (slope over depth), serial chain',
              max_abs_err=max(c['max_abs_err'] for c in p_run['checks']),
              max_rel_err={m: max(c['rel_err'] for c in p_run['checks']
                                  if c['mode'] == m) for m in dp.MODES},
              ms_per_pass={m: [r[m]['ms_per_pass'] for r in (
                  p_run['summary'], p_run['summary_again'])]
                  for m in dp.MODES},
              mma_sync_control_ms_per_pass={m: [
                  r[m]['ms_per_pass']
                  for r in p_run['mma_sync_control']['summary']]
                  for m in dp.MODES},
              device_ms=p_run['device_ms_a_launch'],
              ptxas_report=p_run['build']['ptxas'],
              sass_hgmma=p_run['build']['sass'],
              wgmma_serialized=p_run['build']['wgmma_serialized'],
              probe=p_run)],
        'build_s': build_s, 'view_seconds': run['view_seconds'],
        'forward_max_abs_err': fwd_err, 'imh': IMH, 'n_lights': N_LIGHTS,
        'training': dict(train_out, seconds=train_s), 'train_step': step,
        'train_step_stash_route': step_stash, 'chain_probe': probe_records,
        'shape': {'training': shape_train, 'train_step': shape_step,
                  'step_agreement': shape_agreement},
        'brdf': {'training': brdf_train, 'train_step': brdf_step,
                 'explore': explore},
        'joint_from_port_stages': joint_port,
        'distillation': dict(distill, march_probe=march,
                             shape_from_distilled_buffers=shape_distilled),
        'nerf': {'training': dict(nerf_train, seconds=nerf_train_s),
                 'view_seconds': nerf_view_s, 'forward_rel_err': nerf_fwd_err,
                 'train_step': nerf_step},
        'pipeline_e2e': e2e, 'microfacet': micro, 'mvs': mvs,
        'scan_dispatch': scan_dispatch,
        'f32_heads': all_heads,
        'data_gen': data_gen, 'multidevice': multidevice,
        'smoke_s': time.perf_counter() - t_start})
    # The whole line also goes to a file: the end of a long output may be
    # all a caller keeps
    with open(join(WORK, 'result.json'), 'w') as f:
        f.write(result + '\n')
    print(result)
    print(gpu)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
