#!/usr/bin/env python3
"""Drive the PyTorch port (``ocpg_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--phases NAME ...]

With no arguments it runs every phase; each fails the run (non-zero exit,
no result line) if it goes wrong.  ``--phases`` runs only the named ones
(``--phases swin_t recipes``, say), in this order, and prints no result
lines:

1. build      -- compile every CUDA kernel of the port from
                 ocpg_tpu_torch/ops/csrc (one nvcc per source, all started
                 together).
2. kernel     -- each kernel against its plain PyTorch version on the card,
                 in float32 and bfloat16: the MSDA forward (K1) at the
                 serving, A2D and train calls, with samples outside the map,
                 on integer pixel coordinates (xp = -1 among them) and at
                 NaN/inf coordinates; its backward (K2) at the serving and
                 train calls (encoder and decoder, Lq = 5) against autograd
                 through the plain version; at the serving and train encoder
                 calls both also on clustered samples (each query within
                 +-2 pixels of its reference point, as a trained encoder
                 samples); their standard-layout entries (K3 at the encoder
                 calls, K4 at K2's calls) on the same samples in the
                 standard layout; the dense-row (K5) and fused-K (K6)
                 forwards against the plain gather version at the encoder
                 calls, uniform and clustered, and at the decoder calls
                 (Lq = 5, a ragged query tile), timed at the encoder calls
                 with the tensor-core FLOPs they execute; the memory-fusion bicubic resize (two bf16
                 products) against the CPU, forward and gradient, timed
                 beside F.interpolate's bicubic at the train call; the Swin
                 window attention (K7) at the four Video Swin-B serving calls
                 (n = 245) and the four Swin-B train calls (n = 147, a
                 ragged last row tile, whose rows are also held apart) with
                 and without the SW-MSA mask, at a 2D Swin (n = 49) call and
                 at its edges (n = 392, an odd n = 13), at the stage-0 call
                 infer_davis makes at clip_len 36 (bw = 1610, n = 392), at
                 Video Swin-T's stage-0 and stage-3 calls (3 and 24 heads)
                 of the A2D 1 x 5 x 384 x 640 forward and of phase swin_t's
                 train step, its autograd
                 Function's gradients against autograd through the plain
                 version (serving stages 0 and 3, train stage 0).  Each
                 kernel's device time (the launches queue behind a sleep
                 kernel, so the host's launch rate does not count), the
                 plain version's, the bound and, for K7,
                 scaled_dot_product_attention's, with the host's enqueue
                 time per call beside both.
3. card       -- the small models on the card (through the kernels) against
                 the same weights on the CPU (through the plain versions),
                 TF32 off: the ResNet eval forward (both branches) and the
                 Video Swin eval forward (DAVIS branch) at the bounds of
                 tests/test_golden_parity.py, and one train step with dropout
                 and stochastic depth off (matched queries identical, every
                 loss and grad_norm within 1e-3 relative, K1 and K2 each
                 launched once per transformer layer) of the ResNet model,
                 of the Video Swin model (K7 once per block), of the Video
                 Swin model with use_checkpoint (K7 twice per block: forward
                 and recompute) and of the ResNet model with the BoxInst
                 pairwise loss on a 3-frame clip; the ResNet A2D model's
                 evaluate_a2d with the device postprocess on three batches
                 (scores within 1e-3, masks equal except where the resized
                 logit is within 1e-3 of 0).
4. serve      -- the full-width YTVOS R101 model (ResNet-101, RoBERTa-base,
                 4+4 layers, bf16) behind ClipInferenceEngine, answering
                 uint8 requests of mixed sizes; every answer has its
                 request's shape and is finite, MSDA launched 8 times per
                 dispatch and its backward never.
5. a2d        -- the A2D R101 eval forward on one 5 x 384 x 640 clip (bf16,
                 valid_indices): finite masks of shape (1, 1, 5, 384, 640),
                 MSDA launched 8 times in the forward and its backward never.
6. train      -- the full-width YTVOS R101 train step (forward, matcher, the
                 weak-supervision losses, backward, clip, AdamW; bf16 with
                 float32 parameters, dropout on) on one 3 x 512 x 640 clip: K1
                 and K2 each launched 8 times in a step, every loss and the
                 grad norm finite, the trained parameters moved and the frozen
                 ones (ResNet stem and layer1, text encoder) bit-identical;
                 then ms/step over 5 steps, peak memory, and one step under
                 torch.profiler.
7. swin_serve -- the full-width DAVIS Video Swin-B model (davis_videoswin_base:
                 embed 128, depths 2/2/18/2, RoBERTa-base, 4+4 layers, bf16)
                 behind the same engine and requests as phase serve: K7
                 launched 24 times per dispatch, K1 8 times, K2 never;
                 frames/s and one dispatch under torch.profiler.
8. swin_a2d   -- the A2D eval forward with the Video Swin-B backbone on one
                 5 x 384 x 640 clip (bf16, valid_indices): K7 launched 24
                 times, K1 8 times.
9. swin_train -- the JAX bench's Swin-B train stage: ytvos_r101_boxsup
                 with the Video Swin-B backbone, B=1, T=3, 512 x 640, bf16,
                 dropout and stochastic depth on, the batch in the compact
                 wire (uint8 frames and masks, float16 heatmaps), run as
                 phase train runs, once without per-block recompute (path
                 swin_train: K7 24 times a step) and once with it
                 (swin_train_recompute: 48), K1 and K2 8 times each, the
                 frozen text encoder bit-identical; ms/step, peak memory,
                 and a profile with K7's forward and its plain recompute
                 backward (the kernels under the Function's backward).
10. swin_t    -- Video Swin-T at its widths: the full-width
                 a2d_videoswin_tiny (embed 96, depths 2/2/6/2, heads
                 3/6/12/24) from its seeded init, one float32 train step on
                 an A2D batch (2 x 192 x 256, valid_indices) on the card
                 against the CPU (TF32 off): matched queries identical, every
                 loss and grad_norm within 1e-3 relative, K1 and K2 8 times,
                 K7 12 times at the calls phase kernel holds; then one bf16
                 A2D eval forward at 1 x 5 x 384 x 640 (path swin_t_a2d: K7
                 12, K1 8).
11. resume    -- two train steps of the small model, a checkpoint save and a
                 restore into a fresh model, optimizer and step: state dicts
                 and generator state bit-identical to the saved ones, the
                 next step's losses within 1e-3 relative on both sides.
12. train_cli -- the port's train CLI (``ocpg_tpu_torch.cli.train
                 --dataset_file ytvos``) in this process, as a user runs it:
                 the full-width ytvos_r101_boxsup model (ResNet-101, bf16,
                 canvas 512 x 640, B=1, T=3) on a seeded Ref-YouTube-VOS tree
                 of 8 frames at 720 x 1280 (``bench_loader.build_tree``: JPEG
                 frames and palette-PNG masks written with PIL, the
                 AnnotationsWeakly h5 heat maps with ``data/h5.py``), one
                 epoch, then --resume for a second: the first batch's heat
                 maps and weak masks nonzero inside the object, K1 and K2 8
                 times per step over every step of both runs, K3-K7 never, no
                 cv2 and no h5py loaded, every logged loss finite, log.txt
                 with epochs 0 and 1, the latest checkpoint at 2 x 8 steps,
                 the frozen ResNet stem and text encoder bit-identical to
                 their init; steps/s, the data-wait share, the loader's
                 batches/s alone, one compact batch's pinned copy (device
                 ms), peak memory; ms per ``read_datasets`` of one frame's
                 720 x 1280 heatPoint with 1 and 3 instances beside the PIL
                 decode of its JPEG.
13. multi_gpu -- data parallelism (``ocpg_tpu_torch/parallel``) on the one
                 card: (a) an NCCL process group of world size 1 in this
                 process, the full-width ytvos_r101_boxsup train step (B=1,
                 T=3, 512 x 640, bf16) through TrainStep(mesh) against the
                 step without a mesh from the same state and the same
                 backward (K2 adds with atomics, so a second no-mesh run
                 shows the spread of two backwards): the flat all-reduce
                 hands every gradient back bit-identical and every parameter,
                 AdamW moment and metric after 2 steps is bit-identical, K1
                 and K2 8 a step; ms/step with and without the mesh, the
                 all-reduce's device ms and GB, peak memory.  (b) Two spawned
                 ranks sharing the card over gloo (NCCL refuses two ranks on
                 one device), the model in float32 with TF32 off, dropout
                 off, rank 0's weights broadcast, one row each of a B=2
                 batch whose rows have 3 and 1 valid frames, against this
                 process's one-rank B=2 step: losses within 1e-5 and
                 grad_norm within 3e-5 relative, the clipped gradients
                 within 1e-4 of their norm and 2e-3 of each leaf's scale
                 (the ReLU gates that flip between a B=2 and a B=1 float32
                 forward are counted and logged), Adam's first moment
                 likewise; the eval forward and an engine run of 5 requests
                 within 5e-3 of scale; per-rank peak memory and the gloo
                 all-reduce's wall ms.  (c) ``dryrun_multigpu(2)``: K1, K2
                 and K7 launched on both ranks.  (d) ``cli.train`` on two
                 ranks for 2 steps of a global batch of 2 on a 4-frame
                 Ref-DAVIS tree: K1 and K2 8 a step on each rank, only rank
                 0 writes log.txt (with the global batch) and checkpoints.
14. eval_cli  -- the port's A2D/JHMDB eval CLI (``ocpg_tpu_torch.cli.evaluate``)
                 in this process at full width (R101, bf16) with its
                 defaults (device postprocess, f32 wire), batches of 2 with a
                 padded tail: on a seeded A2D-Sentences tree
                 (``bench_eval_e2e.build_a2d_tree``: 7 mp4 clips of 8 frames
                 at 320 x 568 written with cv2, the annotated frame's h5
                 written with ``data/h5.py``; ``--dataset_file a2d``), then on
                 a seeded JHMDB tree (7 videos of PNG frames at 240 x 320, a
                 scipy.io ``puppet_mask.mat`` each) and again with
                 ``--postprocess host``: K1 8 per forward and nothing else,
                 the A2D metric keys finite in [0, 1], the two JHMDB dicts
                 within 1e-6; clips/s, the host seconds in RLE encoding and
                 in the metrics, one forward with its device postprocess
                 (device ms) and the packed mask wire beside the float32
                 canvas.
15. pretrain_cli -- the RefCOCO pretrain CLI (``cli.pretrain``) at full width,
                 T = 1, batches of 2, one epoch of a seeded COCO tree (8 train
                 and 4 val JPEGs at 480 x 640) with its val: K1 and K2 8 per
                 step, K1 8 per val forward, every step's loss finite, the
                 refcoco_{bbox,segm,coco_bbox}_* entries of log.txt finite,
                 the checkpoint at the last step; steps/s, peak memory.
16. infer_davis -- the Ref-DAVIS inference CLI (``cli.infer_davis``) with the
                 Video Swin-B backbone (davis_videoswin_base, full width) at
                 its defaults (clip_len 36, exact canvases, f32) on a seeded
                 valid split (one video of 36 frames at 720 x 1280, two
                 objects, eight expressions), then ``cli.eval_davis`` on each
                 annotator: K1 8 per dispatch, K7 24 per backbone run (one:
                 the chunk's other seven requests reuse it), every palette PNG at
                 720 x 1280, both CSVs, J&F finite; requests/s and the share
                 of the run outside the engine.
17. infer_ytvos -- the Ref-YTVOS inference CLI (``cli.infer_ytvos``, R101 at
                 full width) on a seeded valid split (12- and 4-frame videos
                 at 720 x 1280, and a 6-frame video of two unlike scenes that
                 a probe run picked because their best queries differ),
                 chunked (clip_len 3, global query selection) and whole-video
                 (clip_len 0): K1 8 per dispatch, one query per expression
                 after the re-run, at least one chunk run again, each re-run
                 chunk's masks those of a direct dispatch of its request with
                 the query forced, every PNG of both runs, the two runs
                 agreeing on at least 99% of pixels (share and re-run chunks
                 recorded).
18. pretrained -- a reference-layout checkpoint at full width
                 (tests/torch_replica.py's OCPGReplica with ResNet-101 and a
                 RoBERTa-base config made here, seeded, saved as a .pth):
                 ``load_pretrained_torch`` into the float32 ytvos_r101_boxsup
                 model on the card sets every tensor to the checkpoint's;
                 its eval forward on a padded 1 x 5 x 384 x 640 clip (K1 8
                 times) against the replica's own forward on the card
                 (grid_sample MSDA), TF32 off, logits, boxes and reference
                 points within 2e-3, masks within 5e-3 of their scale;
                 ``cli.tools convert_checkpoint``, then ``cli.infer_ytvos``
                 with ``--checkpoint`` the .pth and the converted directory
                 (``--tokenizer_path`` a toy vocabulary): identical PNGs;
                 two steps of ``cli.train --pretrained_weights`` (K1 and K2
                 8 per step; before the first step every tensor but the
                 class heads is the checkpoint's); the toy vocabulary's ids
                 on this machine's transformers equal to TOY_IDS; load and
                 conversion seconds, the forward's device ms, peak memory.
19. pseudo_labels -- the generator's --densecl path at full width: the
                 replica's ResNet-101 body through ``convert_resnet`` into
                 the sim model on the card and on the CPU,
                 ``generate_for_frame`` on a seeded 320 x 576 frame with 3
                 instances (one empty), without and with the CRF: centres
                 equal, heat maps within 1e-3, each bbox query choice the
                 CPU's or a tie within 1e-5; seconds per frame and the sim
                 model's device ms.  Then OCPG's own data path:
                 ``generate_anno.main --dataset ytvos --densecl`` on a
                 2-video tree at 720 x 1280 writes AnnotationsWeakly/*.h5,
                 read back equal bit for bit to ``generate_for_frame`` on
                 those frames; ``cli.train`` takes 2 full-width steps (R101,
                 bf16) on that tree (K1 and K2 8 per step, finite losses);
                 ``--dataset a2d`` on a one-video A2D tree (mp4 by cv2)
                 rewrites its annotation h5 in place, ``instance`` and
                 ``reMask`` bit-identical, the three maps added and equal to
                 ``generate_for_frame``'s; seconds per frame of each run.
20. recipes   -- the 21 run recipes of ocpg_tpu_torch/scripts/recipes that
                 no other phase runs (A2D-Sentences training with ResNet-101
                 under box, point and full supervision and the boxinst,
                 boxlevelset, boxvos and partialsup variants, the frozen
                 video encoder at batch 4, Video Swin-B with --use_checkpoint
                 and Swin-T; Ref-YTVOS full and point supervision, Swin-B,
                 Swin-T from scratch and at batch 2; joint; pretrain on all
                 three RefCOCO sets as 3-frame sequences; the Swin-T A2D
                 eval and the Swin-B Ref-YTVOS inference of the checkpoints
                 the phase just trained), each through its own calls
                 recorded under bash with NGPUS=1, with --output_dir a
                 directory of the phase and --epochs 1, in this process at
                 full width, on trees sized to two steps an epoch at the
                 recipe's own batch (the A2D ones written by
                 bench_eval_e2e.build_a2d_tree and labelled by
                 generate_pseudo_labels_a2d.sh's call): K1 8 per forward,
                 K2 8 per step, K7 12 (Swin-T) or 24 (Swin-B) per forward
                 and again per step with --use_checkpoint; every loss and
                 grad_norm finite; the pairwise loss with boxinst and boxvos
                 alone; the first batch's weak masks on the object; the
                 backbone bit-identical with --freeze_video_encoder; the eval
                 metrics finite and the PNGs written; only the two
                 checkpoints the test recipes read are written to disk;
                 seconds and peak memory per recipe.
21. demo_e2e  -- the whole product (``ocpg_tpu_torch.scripts.
                 demo_synthetic_e2e``) at a shortened length: random-weight
                 ``cli.infer_davis`` and J&F, ``cli.train`` (the small R50
                 model, 2+2 layers, bf16, 128 x 160, 96 steps), trained
                 inference and J&F: K2 4 per step, K1 4 per step and per
                 dispatch, the loss falls, every J&F finite in [0, 1].
22. long_run  -- ``ocpg_tpu_torch.scripts.train_long_run`` (its default
                 Ref-YouTube-VOS tree with h5 heat maps) at 60 steps of the
                 full-width ytvos_r101_boxsup model fed by
                 ClipLoader(compact=True) from 6 videos x 16 frames at 720 x
                 1280: the checkpoint at 30 read back bit-identical, restored
                 into fresh objects bit-identical and replayed twice over 10
                 steps, the first replayed loss equal to the live one and the
                 first two within 1e-3 relative (the whole replay's difference
                 and the two replays' spread recorded), val J and F at steps 1
                 and 60; K1 and K2 8 per step, K1 8 per val forward.
23. memory_envelope -- ``ocpg_tpu_torch.scripts.memory_envelope --quick``:
                 peak allocated and reserved memory of the R101 train rows
                 B=1 and 2 (T=3, 512 x 640, two steps each) and eval rows T=5
                 and 36 (384 x 640), every row within the card's memory.
24. std_op     -- the standard-layout MSDA op ``ms_deform_attn_fast`` once
                 forward and backward at the train encoder call: K3 and K4
                 launched once each, the gradients finite.
25. msda_bench -- the port's MSDA kernel bench in this process
                 (``ocpg_tpu_torch.scripts.bench_msda_kernel``, variants cm
                 r4 fk sep, --bwd, eval shapes, checked against sep): every
                 check within 2e-2, K1, K2, K5 and K6 each launched.
26. bench      -- the port's bench (``ocpg_tpu_torch.scripts.bench``, the
                 root bench.py's stages: the A2D R101 and Swin-B eval
                 forwards at 1 x 5 x 384 x 640 and the R101 train step at
                 B=1 and B=2, T=3, 512 x 640, bf16) in this process with its
                 paired runs shortened (8/2 x 3 forwards, 4/1 x 3 steps):
                 every stage present and none failed, the rates above 0, the
                 dense and kernel-inclusive MFUs in (0, 1.05], the kernels'
                 GFLOP above 0; per stage K1 8 per forward and per step, K2
                 8 per step, K7 24 per Swin-B forward; the R101 forward's
                 dense GFLOP beside the JAX bench's HLO count.
27. bench_scripts -- the measurement drivers of ocpg_tpu_torch/scripts at
                 their shortest: bench_train (timing with --trace, then
                 --e2e on its default Ref-YTVOS tree), bench_serving,
                 bench_eval_e2e (its default A2D tree), bench_loader (its
                 default Ref-YTVOS tree, then --dataset davis at the same
                 worker counts),
                 bench_swin_micro and bench_train_sweep (one R101 point in
                 a child process, whose launches it reports): each record's
                 keys and values, launches per forward and step as above.

Every launch counter (K1-K7) is reset just before each of the phases serve,
a2d, train, swin_serve, swin_a2d, swin_train (each of its two runs), swin_t
(its card step and its A2D forward), resume, train_cli (each of its two
runs), multi_gpu (each run and rank: the ranks count in their own processes
and return their counts, which are summed), eval_cli (each of its three
runs), pretrain_cli, infer_davis, infer_ytvos (each of its two runs),
pretrained (its forward, each infer_ytvos run and the train run),
pseudo_labels (generate_for_frame, each generate_anno.main run and the train
run), recipes (the trees' labelling and each recipe), demo_e2e, long_run,
memory_envelope, std_op, msda_bench, bench (each of its four stages, by the
bench itself) and bench_scripts (each script) runs its path and read just
after; the ``kernels`` line gives each kernel's count on every path.

It imports nothing of JAX.  The last three lines of its output are the
card's name and power limit (nvidia-smi), one JSON object listing the
kernels, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ocpg_tpu_torch.config import (OCPGConfig, a2d_r101_boxsup, a2d_videoswin_tiny,
                                   davis_videoswin_base, ytvos_r101_boxsup)
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ocpg_tpu_torch.engine.checkpoint import CheckpointManager
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.engine.optim import build_optimizer, param_group_label
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer
from ocpg_tpu_torch.ops import _build
from ocpg_tpu_torch.ops import image
from ocpg_tpu_torch.ops import ms_deform_attn as msda
from ocpg_tpu_torch.ops import ms_deform_attn_variants as msda_var
from ocpg_tpu_torch.ops import window_attention as wattn
# the MSDA and window-attention work formulas the bounds read
from ocpg_tpu_torch.ops.ms_deform_attn import msda_bwd_work, msda_work
from ocpg_tpu_torch.ops.window_attention import wattn_work
from ocpg_tpu_torch.preprocess.sim_model import no_tf32
from ocpg_tpu_torch.scripts import bench_msda_kernel
from ocpg_tpu_torch.scripts.bench_eval_e2e import H as A2D_H
from ocpg_tpu_torch.scripts.bench_eval_e2e import W as A2D_W
from ocpg_tpu_torch.scripts.bench_eval_e2e import (JHMDB_H, JHMDB_W, build_a2d_tree,
                                                   build_jhmdb_tree)
# the Swin-B serving calls' geometry (window, head width, grids, heads) and
# the window attention's seeded inputs
from ocpg_tpu_torch.scripts.bench_swin_micro import (SWIN_GRIDS, SWIN_HEAD_DIM, SWIN_HEADS,
                                                     swin_call, wattn_inputs)
from ocpg_tpu_torch.utils.hw import gpu_spec, nvidia_smi_line
# the timing and profiling helpers and the launch counters (reset, read)
from ocpg_tpu_torch.utils.profiling import LAUNCH_COUNTERS, cuda_ms, cuda_times, profile_run
from ocpg_tpu_torch.utils.profiling import launch_counts as read_counts
from ocpg_tpu_torch.utils.profiling import reset_launch_counts as reset_counts
# the model's MSDA (M, D), the serving and train paths' levels and frames,
# and the seeded MSDA inputs (uniform or clustered samples)
from ocpg_tpu_torch.scripts.bench_msda_bwd import (HEAD_DIM, HEADS, SERVE_N, SERVE_SHAPES,
                                                   TRAIN_N, TRAIN_SHAPES, msda_inputs)

# the card's data-sheet peaks (utils/hw.py): HBM rate, float32 rate outside
# the tensor cores, dense bf16 tensor-core rate
SPEC = gpu_spec()
HBM_BYTES_PER_S = SPEC.hbm_bytes_per_s
F32_FLOPS_PER_S = SPEC.peak_flops_f32
BF16_FLOPS_PER_S = SPEC.peak_flops_bf16
# the decoder calls' queries (Lq = 5)
QUERIES = 5
# Swin-B: blocks (each launches K7 once a forward)
SWIN_B_BLOCKS = 24
# Swin-B train path (one 3 x 512 x 640 clip): the window clamps to T = 3,
# n = 147 = 9 x 16 + 3, so the tensor-core body has a ragged last row tile;
# windows per stage of a shifted block
SWIN_TRAIN_T = 3
SWIN_TRAIN_GRIDS = ((128, 160), (64, 80), (32, 40), (16, 20))
SWIN_TRAIN_WINDOWS = (437, 120, 30, 9)
# Video Swin-T (a2d_videoswin_tiny): blocks (depths 2/2/6/2) and heads of
# 32 channels a stage; phase swin_t's train step is one 2 x 192 x 256 clip,
# whose stage-0 and stage-3 grids (stride 4, then 2 a stage) are these
SWIN_T_BLOCKS = 12
SWIN_T_HEADS = (3, 6, 12, 24)
SWIN_T_STEP_T, SWIN_T_STEP_SIZE = 2, (192, 256)
SWIN_T_STEP_GRIDS = ((48, 64), (6, 8))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ kernel --
def counts_of(**launched) -> dict:
    """The expected counts of a path: the named kernels, every other one 0."""
    return {name: launched.get(name, 0) for name, _, _ in LAUNCH_COUNTERS}


def timed_bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_kernel(results):
    """K1 at the calls the main paths make: the serving encoder and decoder
    (N = clip_len frames), the A2D ones (valid_indices leaves N = 1) and the
    train ones (N = B x T = 3 frames at 512 x 640); K2 at the serving and
    train calls.  The serving and train encoder calls run on uniform and on
    clustered samples (msda_inputs)."""
    lq_serve = sum(h * w for h, w in SERVE_SHAPES)
    lq_train = sum(h * w for h, w in TRAIN_SHAPES)
    calls = (("serve encoder", SERVE_SHAPES, SERVE_N, lq_serve),
             ("serve decoder", SERVE_SHAPES, SERVE_N, QUERIES),
             ("a2d encoder", SERVE_SHAPES, 1, lq_serve),
             ("a2d decoder", SERVE_SHAPES, 1, QUERIES),
             ("train encoder", TRAIN_SHAPES, TRAIN_N, lq_train),
             ("train decoder", TRAIN_SHAPES, TRAIN_N, QUERIES))
    report = {}
    for name, shapes, n, lq in calls:
        with_bwd = not name.startswith("a2d")
        kinds = (False, True) if with_bwd and name.endswith("encoder") else (False,)
        for clustered in kinds:
            tag = f"{name} clustered" if clustered else name
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7, clustered=clustered)
                got = msda.ms_deform_attn_cm(value, shapes, x, y, aw)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_cm_reference(value.float(), shapes, x, y, aw)
                label = f"{tag} N={n} Lq={lq} {str(dtype)[6:]}"
                err = held(f"K1 msda {label}", got, want, tol)
                if dtype == torch.bfloat16:
                    ms = cuda_ms(lambda: msda.ms_deform_attn_cm(value, shapes, x, y, aw), 50)
                    plain_ms = cuda_ms(lambda: msda.ms_deform_attn_cm_reference(
                        value, shapes, x, y, aw), 10)
                    nbytes, flops = msda_work(shapes, value, x, y, aw)
                    bound_ms, bound_by = timed_bound(nbytes, flops)
                    gather_bytes = x.numel() * 4 * HEAD_DIM * value.element_size()
                    log(f"kernel msda {tag} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
                        f"{flops / 1e9:.3f} GFLOP f32); corner gathers "
                        f"{gather_bytes / 1e9:.3f} GB = "
                        f"{gather_bytes / (ms * 1e-3) / 1e12:.2f} TB/s through L2/L1")
                    report[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, max_abs_err=err)
                if not with_bwd:
                    continue
                # K2 at the same call: each gradient against autograd through
                # the plain version, within tol x its own max |.|.  The order
                # of d_value's atomic sums changes from run to run.
                g = torch.randn(n, lq, HEADS * HEAD_DIM, generator=torch.Generator(
                    device="cuda").manual_seed(9), device="cuda").to(dtype)
                got = msda.ms_deform_attn_cm_backward(value, shapes, x, y, aw, g)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_cm_grad_reference(value.float(), shapes, x, y, aw,
                                                             g.float())
                err = held_grads(f"K2 msda_bwd {label}", got, want,
                                 ("d_value", "d_x", "d_y", "d_aw"), tol, dtype)
                del got, want
                if dtype == torch.bfloat16:
                    ms, plain_ms = time_bwd(
                        lambda: msda.ms_deform_attn_cm_backward(value, shapes, x, y, aw, g),
                        lambda v, *p: msda.ms_deform_attn_cm_reference(v, shapes, *p),
                        (value, x, y, aw), g)
                    nbytes, flops = msda_bwd_work(shapes, value, x, y, aw)
                    bound_ms, bound_by = timed_bound(nbytes, flops)
                    log(f"kernel msda_bwd {tag} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
                        f"{flops / 1e9:.3f} GFLOP f32)")
                    report[f"bwd {tag}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                                bound_by=bound_by, max_abs_err=err)
    results["msda"] = report["serve encoder"]
    results["msda_train"] = report["train encoder"]
    results["msda_calls"] = {k: v for k, v in report.items() if not k.startswith("bwd ")}
    results["msda_bwd"] = report["bwd train encoder"]
    results["msda_bwd_calls"] = {k[4:]: v for k, v in report.items() if k.startswith("bwd ")}
    msda_other_kernel_checks(results)
    dense_row_kernel_checks(results)
    resize_checks(results)
    wattn_kernel_checks(results)


def held_grads(label, got, want, names, tol, value_dtype):
    """Each gradient of a backward kernel against autograd through the plain
    version (held: within tol x its own max |.|); d_value in the value's
    type, the others float32.  Returns the largest error."""
    worst = 0.0
    for gname, a, b in zip(names, got, want):
        check(a.dtype == (value_dtype if gname == "d_value" else torch.float32),
              f"{label} {gname} dtype {a.dtype}")
        worst = max(worst, held(f"{label} {gname}", a, b, tol))
    return worst


def time_bwd(fn, plain_fwd, inputs, g):
    """(device ms of a backward kernel's wrapper fn(), device ms of the plain
    backward alone): autograd through a graph of plain_fwd(*inputs) built
    once, outside the timed calls."""
    ms = cuda_ms(fn, 20)
    inputs = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = plain_fwd(*inputs)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True), 5)
    return ms, plain_ms


def held(label, got, want, limit):
    """max |got - want| against limit x max |want|; returns the error."""
    check(bool(torch.isfinite(want).all()), f"{label}: plain version not finite")
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    check(math.isfinite(err) and err <= limit * scale,
          f"{label}: max |kernel - plain| {err} > {limit} x max {scale}")
    log(f"kernel {label}: max_abs_err {err:.3e} (limit {limit} x {scale:.4g})")
    return err


def msda_other_kernel_checks(results):
    """The standard-layout entries K3 (forward) and K4 (backward) on
    msda_inputs in the standard layout (out-of-map, integer and NaN/inf
    samples), against their plain versions with K1's and K2's limits: K3 at
    the serving and train encoder calls, K4 at K2's calls (the encoder ones
    on uniform and clustered samples, and the decoder ones).  Then times in
    bf16."""
    calls = (("serve encoder", SERVE_SHAPES, SERVE_N), ("train encoder", TRAIN_SHAPES, TRAIN_N))
    for name, shapes, n in calls:
        lq = sum(h * w for h, w in shapes)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            tag = f"{name} N={n} Lq={lq} {str(dtype)[6:]}"
            value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7)
            locs, attn = msda._cm_to_standard(x, y, aw)
            got = msda.ms_deform_attn_fast(value, shapes, locs, attn)
            torch.cuda.synchronize()
            err3 = held(f"K3 msda_std {tag}", got,
                        msda.ms_deform_attn_reference(value.float(), shapes, locs, attn), tol)
            del got
            if dtype != torch.bfloat16:
                continue
            bound_ms, bound_by = timed_bound(*msda_work(shapes, value, x, y, aw))
            ms = cuda_ms(lambda: msda.ms_deform_attn_fast(value, shapes, locs, attn), 50)
            plain_ms = cuda_ms(lambda: msda.ms_deform_attn_reference(value, shapes, locs, attn),
                               10, warmup=1)
            log(f"kernel K3 {name} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms by {bound_by}")
            results.setdefault("K3", {})[name] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err3)

    # K4 at K2's calls, against the plain backward, timed alone as K2 is
    for name, shapes, n, lq in (
            ("serve encoder", SERVE_SHAPES, SERVE_N, sum(h * w for h, w in SERVE_SHAPES)),
            ("serve decoder", SERVE_SHAPES, SERVE_N, QUERIES),
            ("train encoder", TRAIN_SHAPES, TRAIN_N, sum(h * w for h, w in TRAIN_SHAPES)),
            ("train decoder", TRAIN_SHAPES, TRAIN_N, QUERIES)):
        for clustered in ((False, True) if name.endswith("encoder") else (False,)):
            call = f"{name} clustered" if clustered else name
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7, clustered=clustered)
                locs, attn = msda._cm_to_standard(x, y, aw)
                g = torch.randn(n, lq, HEADS * HEAD_DIM, generator=torch.Generator(
                    device="cuda").manual_seed(9), device="cuda").to(dtype)
                got = msda.ms_deform_attn_backward(value, shapes, locs, attn, g)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_grad_reference(value.float(), shapes, locs, attn,
                                                          g.float())
                err = held_grads(f"K4 msda_std_bwd {call} N={n} Lq={lq} {str(dtype)[6:]}",
                                 got, want, ("d_value", "d_locs", "d_attn"), tol, dtype)
                del got, want
                if dtype != torch.bfloat16:
                    continue
                ms, plain_ms = time_bwd(
                    lambda: msda.ms_deform_attn_backward(value, shapes, locs, attn, g),
                    lambda v, *p: msda.ms_deform_attn_reference(v, shapes, *p),
                    (value, locs, attn), g)
                bound_ms, bound_by = timed_bound(*msda_bwd_work(shapes, value, x, y, aw))
                log(f"kernel K4 {call} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms by {bound_by}")
                results.setdefault("K4", {})[call] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    max_abs_err=err)


def dense_row_kernel_checks(results):
    """The dense-row (K5) and fused-K (K6) forwards against the plain gather
    version within 2e-2 x max |out|, the bound of
    tests/test_ms_deform_attn_pallas.py for the TPU's dense-row and fused-K
    kernels (they round their tensor-core operands to bf16 in both dtypes),
    float32 and bfloat16, at the serving and train encoder calls on uniform
    and on clustered samples and at the decoder calls (Lq = 5, a ragged
    query tile); every input has out-of-map, integer and NaN/inf samples,
    where K5 and K6 sample nothing, as K1 and the plain version do.  Then bf16
    times at the encoder calls, uniform and clustered, with the tensor-core
    FLOPs each kernel executes on those samples (r4_mma_flops, fk_mma_flops)
    and the rate they reach."""
    kernels = (("K5", msda_var.ms_deform_attn_cm_r4, msda_var.ms_deform_attn_cm_r4_reference,
                msda_var.r4_mma_flops),
               ("K6", msda_var.ms_deform_attn_cm_fk, msda_var.ms_deform_attn_cm_fk_reference,
                msda_var.fk_mma_flops))
    for name, shapes, n in (("serve", SERVE_SHAPES, SERVE_N), ("train", TRAIN_SHAPES, TRAIN_N)):
        s = sum(h * w for h, w in shapes)
        for call, lq, clustered in ((f"{name} encoder", s, False),
                                    (f"{name} encoder clustered", s, True),
                                    (f"{name} decoder", QUERIES, False)):
            for dtype in (torch.float32, torch.bfloat16):
                value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7, clustered=clustered)
                want = msda.ms_deform_attn_cm_reference(value.float(), shapes, x, y, aw)
                tag = f"{call} N={n} Lq={lq} {str(dtype)[6:]}"
                errs = {}
                for kname, fn, _, _ in kernels:
                    got = fn(value, shapes, x, y, aw)
                    torch.cuda.synchronize()
                    check(got.dtype == dtype, f"{kname} {tag}: output dtype {got.dtype}")
                    errs[kname] = held(f"{kname} {tag}", got, want, 2e-2)
                    del got
                del want
                if dtype != torch.bfloat16 or call.endswith("decoder"):
                    continue
                bound_ms, bound_by = timed_bound(*msda_work(shapes, value, x, y, aw))
                for kname, fn, plain, count in kernels:
                    ms = cuda_ms(lambda: fn(value, shapes, x, y, aw), 20)
                    plain_ms = cuda_ms(lambda: plain(value, shapes, x, y, aw), 3, warmup=1)
                    mma = count(shapes, x, y, HEAD_DIM)
                    entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 max_abs_err=errs[kname], mma_gflop=mma / 1e9,
                                 mma_bound_ms=mma / BF16_FLOPS_PER_S * 1e3,
                                 mma_tflops=mma / (ms * 1e-3) / 1e12)
                    log(f"kernel {kname} {call} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"bound {bound_ms:.4f} ms by {bound_by}; executes "
                        f"{entry['mma_gflop']:.1f} GFLOP on the tensor cores (>= "
                        f"{entry['mma_bound_ms']:.4f} ms at 989 TFLOP/s), "
                        f"{entry['mma_tflops']:.1f} TFLOP/s")
                    results.setdefault(kname, {})[call] = entry


# memory-fusion resize (models/ocpg.py): the encoder's stride-16 and -32
# levels to stride 8, N = frames, 256 channels
FUSION_CALLS = (("serve", SERVE_N, ((24, 40), (12, 20)), (48, 80)),
                ("train", TRAIN_N, ((32, 40), (16, 20)), (64, 80)))


def resize_checks(results):
    """The memory-fusion bicubic resize (ops/image.py: two bf16 products
    with float32 accumulation, rounded to bf16 between them) on the card
    against the same function on the CPU, forward and gradient, within
    1e-2 x max |.| at the serving and train calls; then its device time at
    the train call, forward and forward + backward, beside F.interpolate's
    bicubic (the function the port called before, which rounds once)."""
    import torch.nn.functional as F

    def interpolate(x, size):
        return F.interpolate(x, size=size, mode="bicubic", align_corners=False)

    for name, n, levels, size in FUSION_CALLS:
        gen = torch.Generator().manual_seed(31)
        xs = [torch.randn(n, 256, h, w, generator=gen).bfloat16() for h, w in levels]
        gout = torch.randn(n, 256, *size, generator=gen)

        def fusion(inputs, resize=image.bicubic_resize):
            return sum(resize(x, size).float() for x in inputs)

        outs = {}
        for dev in ("cpu", "cuda"):
            inputs = [x.to(dev, copy=True).requires_grad_() for x in xs]
            out = fusion(inputs)
            out.backward(gout.to(dev))
            outs[dev] = [out.detach().cuda()] + [t.grad.cuda() for t in inputs]
        errs = [held(f"resize memory fusion {name} N={n} {levels}->{size} bf16 "
                     f"{'forward' if i == 0 else f'd_level{i}'} (card vs cpu)", a, b, 1e-2)
                for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"]))]
        if name != "train":
            continue
        inputs = [x.cuda() for x in xs]
        grad_inputs = [x.cuda().requires_grad_() for x in xs]
        go = gout.cuda()

        def fwd_bwd(resize):
            torch.autograd.grad(fusion(grad_inputs, resize), grad_inputs, go)

        entry = dict(max_abs_err=max(errs),
                     fwd_ms=cuda_ms(lambda: fusion(inputs), 50),
                     interpolate_fwd_ms=cuda_ms(lambda: fusion(inputs, interpolate), 20),
                     fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(image.bicubic_resize), 20),
                     interpolate_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(interpolate), 5, warmup=1))
        log(f"resize memory fusion {name} bf16: forward {entry['fwd_ms']:.4f} ms "
            f"(F.interpolate {entry['interpolate_fwd_ms']:.4f}), forward + backward "
            f"{entry['fwd_bwd_ms']:.4f} ms (F.interpolate "
            f"{entry['interpolate_fwd_bwd_ms']:.4f})")
        results["resize"] = entry


def wattn_held(got, want, scale, dtype):
    """(max |got - want|, within the limit, the limit): 1e-5 x scale for
    float32 inputs, 2e-2 + 2e-2 x |want| for bfloat16 ones."""
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        return err, err <= 1e-5 * scale, f"1e-5 x {scale:.3f}"
    excess = ((got - want).abs() - 2e-2 * want.abs()).max().item()
    return err, excess <= 2e-2, "2e-2 + 2e-2 x |out|"


def swin_t_calls():
    """Video Swin-T's stage-0 and stage-3 K7 calls (name, bw, heads, n,
    SW-MSA mask): the A2D 1 x 5 x 384 x 640 forward (the serving grids,
    3 and 24 heads) and phase swin_t's train step."""
    calls = [(f"swin-T stage {s}",) + swin_call(SWIN_GRIDS[s], SWIN_T_HEADS[s])
             for s in (0, 3)]
    return calls + [(f"swin-T train stage {s}",) + swin_call(grid, SWIN_T_HEADS[s],
                                                             frames=SWIN_T_STEP_T)
                    for s, grid in zip((0, 3), SWIN_T_STEP_GRIDS)]


def wattn_kernel_checks(results):
    """K7 at the four Video Swin-B serving calls (n = 245, dh = 32), the
    four Swin-B train calls (n = 147), a 2D Swin call (n = 49) and the
    kernel's edges (the largest window, n = 392, of an 8-frame clip, and
    infer_davis's stage-0 call at clip_len 36, bw = 1610; a small
    odd n = 13 with 2 heads), each with the shifted block's SW-MSA mask and
    without, against the plain version on the same values in float32:
    within 1e-5 x max |out| for float32 inputs, and within the 2e-2
    (absolute + relative) bound of tests/test_window_attention_pallas.py for
    bfloat16 ones; where n is not a multiple of 16 the rows of the last,
    ragged row tile are also held apart.  The mask is handed over in q's
    type, as the Swin module does.  Then the autograd Function's gradients
    (serving stages 0 and 3, train stage 0), and times."""
    import torch.nn.functional as F

    calls = [(f"swin-B stage {s}",) + swin_call(SWIN_GRIDS[s], SWIN_HEADS[s])
             for s in range(4)]
    calls += [(f"swin-B train stage {s}",)
              + swin_call(SWIN_TRAIN_GRIDS[s], SWIN_HEADS[s], frames=SWIN_TRAIN_T)
              for s in range(4)]
    check([c[1:4] for c in calls[4:8]] == [(bw, h, 147) for bw, h in
                                           zip(SWIN_TRAIN_WINDOWS, SWIN_HEADS)],
          f"Swin-B train calls {[c[1:4] for c in calls[4:8]]}")
    calls.append(("swin2d-B stage 1 (1 frame)",)
                 + swin_call((48, 80), 8, window=(1, 7, 7), frames=1))
    calls.append(("swin-B stage 1, 8 frames",)
                 + swin_call(SWIN_GRIDS[1], SWIN_HEADS[1], frames=8))
    # the stage-0 call of infer_davis at its default clip_len 36 (384 x 640
    # canvas): the window (8, 7, 7) over 40 padded frames, n = 392
    calls.append(("swin-B stage 0, 36 frames (infer_davis)",)
                 + swin_call(SWIN_GRIDS[0], SWIN_HEADS[0], frames=36))
    calls.append(("odd window 1x1x13",) + swin_call((2, 26), 2, window=(1, 1, 13), frames=1))
    calls += swin_t_calls()
    report = {}
    for name, bw, heads, n, mask_np in calls:
        for masked in (True, False):
            label = f"{name} bw={bw} h={heads} n={n}{' masked' if masked else ''}"
            for dtype in (torch.float32, torch.bfloat16):
                mask = torch.from_numpy(mask_np).cuda().to(dtype) if masked else None
                q, k, v, bias = wattn_inputs(bw, heads, n, dtype, seed=11)
                got = wattn.window_attention(q, k, v, bias, mask).float()
                torch.cuda.synchronize()
                want = wattn.window_attention_reference(q.float(), k.float(), v.float(),
                                                        bias.float(), mask)
                scale = want.abs().max().item()
                err, ok, limit = wattn_held(got, want, scale, dtype)
                check(math.isfinite(err) and ok,
                      f"K7 {label} {dtype}: max |kernel - plain| {err} (limit {limit})")
                tail = ""
                if n % 16:
                    # the rows of the last, ragged 16-row tile
                    t_err, t_ok, _ = wattn_held(got[:, n - n % 16:], want[:, n - n % 16:],
                                                scale, dtype)
                    check(math.isfinite(t_err) and t_ok,
                          f"K7 {label} {dtype}: rows {n - n % 16}..{n - 1} "
                          f"{t_err} (limit {limit})")
                    tail = f", last {n % 16} rows {t_err:.3e}"
                log(f"kernel wattn {label} {str(dtype)[6:]}: max_abs_err {err:.3e}{tail} "
                    f"(limit {limit})")
            # times in bf16, the serving type: the kernel alone (bias and
            # mask already in q's type), the plain version, and
            # scaled_dot_product_attention with bias + mask as its attn_mask,
            # built outside the timed calls
            qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            attn_mask = bias[None].expand(bw, -1, -1, -1)
            if mask is not None:
                attn_mask = (attn_mask + mask[:, None]).contiguous()
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, scale=1.0)
            lib_err = ((lib.permute(0, 2, 1, 3).float() - want).abs()
                       - 2e-2 * want.abs()).max().item()
            check(lib_err <= 2e-2, f"K7 {label}: scaled_dot_product_attention disagrees "
                                   f"with the plain version ({lib_err})")
            ms, host_ms = cuda_times(lambda: wattn.window_attention(q, k, v, bias, mask), 20)
            plain_ms = cuda_ms(lambda: wattn.window_attention_reference(q, k, v, bias, mask), 5)
            library_ms, library_host_ms = cuda_times(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=attn_mask, scale=1.0), 20)
            nbytes, flops, l2_bytes = wattn_work(q, mask)
            bound_ms, bound_by = timed_bound(nbytes, flops, BF16_FLOPS_PER_S)
            tflops = flops / (ms * 1e-3) / 1e12
            log(f"kernel wattn {label} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); {tflops:.2f} TFLOP/s; "
                f"bias + mask {l2_bytes / 1e6:.1f} MB from L2 = "
                f"{l2_bytes / (ms * 1e-3) / 1e12:.2f} TB/s; host enqueue per call "
                f"{host_ms:.4f} ms (sdpa {library_host_ms:.4f})")
            report[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                                 tflops=tflops, bias_mask_l2_mb=l2_bytes / 1e6,
                                 host_ms=host_ms, library_host_ms=library_host_ms)
            del q, k, v, bias, qt, kt, vt, attn_mask, lib, got, want

    # the Function's gradients (plain recompute, as the JAX custom VJP)
    # against autograd through the plain version, float32, with the mask
    for idx in (0, 3, 4):
        stage, bw, heads, n, mask_np = calls[idx]
        mask = torch.from_numpy(mask_np).cuda()
        gen = torch.Generator(device="cuda").manual_seed(12)
        qkv0 = torch.randn(bw, n, 3, heads, SWIN_HEAD_DIM, generator=gen, device="cuda")
        bias0 = torch.randn(heads, n, n, generator=gen, device="cuda") * 0.5
        gout = torch.randn(bw, n, heads, SWIN_HEAD_DIM, generator=gen, device="cuda")
        grads = []
        for fn in (wattn.window_attention, wattn.window_attention_reference):
            qkv, bias = qkv0.clone().requires_grad_(), bias0.clone().requires_grad_()
            out = fn(qkv[:, :, 0] * SWIN_HEAD_DIM ** -0.5, qkv[:, :, 1], qkv[:, :, 2],
                     bias, mask)
            out.backward(gout)
            grads.append((qkv.grad, bias.grad))
        for gname, a, b in zip(("d_qkv", "d_bias"), *grads):
            e, sc = (a - b).abs().max().item(), b.abs().max().item()
            check(math.isfinite(e) and e <= 1e-5 * sc,
                  f"K7 Function {gname} at {stage}: {e} > 1e-5 x {sc}")
            log(f"kernel wattn Function backward {stage} {gname}: max_abs_err "
                f"{e:.3e} (limit 1e-5 x {sc:.4g})")
    results["wattn"] = report[next(iter(report))]       # stage 0, masked
    results["wattn_train"] = next(v for k, v in report.items()
                                  if k.startswith("swin-B train stage 0"))
    results["wattn_report"] = report
    results["wattn_infer_davis"] = next(v for k, v in report.items()
                                        if k.startswith("swin-B stage 0, 36 frames"))
    results["wattn_swin_t"] = {k: v for k, v in report.items() if k.startswith("swin-T")}


# -------------------------------------------------------------------- card --
SMALL = OCPGConfig(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64,
                   num_queries=5, num_frames=2, compute_dtype="float32",
                   dataset_file="davis", text_layers=2, text_hidden=128, text_heads=4,
                   text_ffn=256, text_vocab=1000, text_max_pos=40)


def perturb(model, seed):
    """Seeded noise in every weight (running variances kept positive), so
    the sampling offsets and attention weights depend on the query."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)


def phase_card():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(3)
        b, t, h, w, lt = 1, 2, 192, 256, 8
        samples = rng.standard_normal((b, t, h, w, 3)).astype(np.float32)
        smask = np.zeros((b, t, h, w), bool)
        smask[..., -32:] = True
        smask[..., -16:, :] = True
        ids = rng.integers(4, 999, (b, lt)).astype(np.int32)
        tmask = np.ones((b, lt), np.int32)
        ids[:, -2:], tmask[:, -2:] = 1, 0
        sizes = np.asarray([[h - 16, w - 32]], np.int32)
        inputs = [torch.from_numpy(a) for a in (samples, smask, ids, tmask, sizes)]
        # (backbone, branch, K7 launches: one per Swin block)
        for backbone, branch, k7 in (("resnet50", "davis", 0), ("resnet50", "a2d", 0),
                                     ("video_swin_test", "davis", 5)):
            cfg = SMALL.replace(backbone=backbone, dataset_file=branch)
            cpu_model = build_model(cfg, device="cpu")
            perturb(cpu_model, seed=2)
            gpu_model = copy.deepcopy(cpu_model).to("cuda")
            vidx = torch.tensor([1]) if branch == "a2d" else None
            want = cpu_model(*inputs, valid_indices=vidx)
            reset_counts()
            got = gpu_model(*(a.cuda() for a in inputs),
                            valid_indices=None if vidx is None else vidx.cuda())
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts["K1"] == SMALL.enc_layers + SMALL.dec_layers and counts["K7"] == k7,
                  f"card {backbone} forward launched {counts}")
            label = f"{backbone} {branch}"
            keys = ["pred_logits", "pred_boxes"] + (["reference_points"]
                                                    if branch == "davis" else [])
            for k in keys:
                err = (got[k].cpu() - want[k]).abs().max().item()
                check(err <= 2e-3, f"{label} {k}: card vs cpu {err} > 2e-3")
                log(f"card {label} {k}: max |card - cpu| {err:.2e} (limit 2e-3)")
            scale = max(want["pred_masks"].abs().max().item(), 1e-3)
            err = (got["pred_masks"].cpu() - want["pred_masks"]).abs().max().item() / scale
            check(err <= 5e-3, f"{label} pred_masks: card vs cpu {err} > 5e-3 (scaled)")
            log(f"card {label} pred_masks: max |card - cpu| / max |mask| {err:.2e} "
                f"(limit 5e-3); launches {counts}")
        card_evaluate_a2d(inputs)
        # (config, frames, K7 launches per step: one per Swin block in the
        # forward, again in the recompute)
        small = SMALL.replace(dataset_file="ytvos")
        swin = small.replace(backbone="video_swin_test")
        for cfg, frames, k7 in ((small, 2, 0), (swin, 2, 5),
                                (swin.replace(use_checkpoint=True), 2, 10),
                                (small.replace(pairwise_loss=True), 3, 0)):
            card_train_step(cfg, frames, k7)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False


def card_evaluate_a2d(inputs):
    """The small ResNet model's evaluate_a2d (device postprocess) on three
    in-memory batches (the last padded) on the card and on the CPU: every
    prediction's score within 1e-3, its packed-then-unpacked mask equal
    except at pixels whose resized logit (CPU) is within 1e-3 of 0."""
    from ocpg_tpu_torch.engine import evaluate
    from ocpg_tpu_torch.evaluation.rle import rle_decode

    cfg = SMALL.replace(dataset_file="a2d")
    # perturbed weights (masks of both signs) with the class heads of the
    # seeded init, whose prior keeps the scores off saturation at 1.0
    cpu_model = build_model(cfg, device="cpu")
    heads = {k: v.clone() for k, v in cpu_model.state_dict().items() if "class_embed" in k}
    perturb(cpu_model, seed=2)
    cpu_model.load_state_dict(heads, strict=False)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(9)
    batches = []
    for i in range(3):
        b = synthetic_batch(rng, batch=2, frames=2, height=128, width=192, text_len=8,
                            with_valid_indices=True, vocab_size=cfg.text_vocab)
        b["targets"]["size"] = np.asarray([[128, 192], [112, 160]], np.int32)
        b["targets"]["orig_size"] = np.asarray([[240, 320], [100, 150 + 10 * i]], np.int32)
        b["orig_masks"] = [(rng.random((1, h, w)) > 0.5).astype(np.uint8)
                           for h, w in b["targets"]["orig_size"]]
        batches.append(b)
    batches[-1]["real_count"] = 1

    class Batches:
        def epoch(self, _):
            yield from batches

    got = {}
    metrics = evaluate._metrics
    for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        def keep(preds, gts, dev=dev):
            got[dev] = preds
            return metrics(preds, gts)
        evaluate._metrics = keep
        try:
            reset_counts()
            evaluate.evaluate_a2d(model, Batches(), device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = read_counts()
        finally:
            evaluate._metrics = metrics
    check(counts == counts_of(K1=3 * (cfg.enc_layers + cfg.dec_layers)),
          f"card evaluate_a2d launched {counts}")
    logits = []
    for b in batches:
        out = evaluate._forward(cpu_model, b, torch.device("cpu"), True)["pred_masks"][:, 0]
        for i in range(int(b.get("real_count", 2))):
            (h, w), orig = b["targets"]["size"][i], tuple(b["targets"]["orig_size"][i])
            logits.append(image.bilinear_resize(out[i:i + 1, :, :h, :w], orig)[0].numpy())
    check(len(got["cpu"]) == len(got["cuda"]) == len(logits) * cfg.num_queries,
          "card evaluate_a2d: prediction counts differ")
    worst, flips, in_band, fg, total = 0.0, 0, 0, 0, 0
    for k, (c, g) in enumerate(zip(got["cpu"], got["cuda"])):
        worst = max(worst, abs(c["score"] - g["score"]))
        want, have = rle_decode(c["rle"]), rle_decode(g["rle"])
        diff = want != have
        band = np.abs(logits[k // cfg.num_queries][k % cfg.num_queries]) < 1e-3
        check(not (diff & ~band).any(), f"card evaluate_a2d: prediction {k} masks differ "
                                        f"at {int((diff & ~band).sum())} pixels off the band")
        flips += int(diff.sum())
        in_band += int(band.sum())
        fg += int(have.sum())
        total += have.size
    scores = [p["score"] for p in got["cuda"]]
    check(worst <= 1e-3, f"card evaluate_a2d scores: max |card - cpu| {worst} > 1e-3")
    log(f"card evaluate_a2d (device postprocess, 3 batches of 2, the last padded): "
        f"{len(got['cuda'])} predictions, scores {min(scores):.4f}-{max(scores):.4f}, max "
        f"|card - cpu| {worst:.2e} (limit 1e-3); {fg} of {total} mask pixels foreground, "
        f"{flips} differ, {in_band} within 1e-3 of logit 0; launches {counts}")


@contextlib.contextmanager
def k7_calls():
    """The (bw, heads, n) of every K7 launch while the block runs."""
    launch, calls = wattn._launch, []

    def record(q, k, v, bias, mask):
        calls.append((q.shape[0], q.shape[2], q.shape[1]))
        return launch(q, k, v, bias, mask)

    wattn._launch = record
    try:
        yield calls
    finally:
        wattn._launch = launch


def card_train_step(cfg, frames, k7, size=(128, 192), noise=True, valid_frame=None):
    """The model's train step (dropout and stochastic depth off) on the card
    against the CPU, from the same weights (``noise``: seeded noise in every
    weight, else the seeded init): matched queries identical, every loss and
    grad_norm within 1e-3 relative, K1 and K2 each launched once per
    transformer layer, K7 ``k7`` times.  ``valid_frame``: an A2D batch whose
    annotated frame it is (the targets that frame's alone).  Returns the
    card step's launches and K7's calls."""
    label = (f"{cfg.backbone}{' use_checkpoint' if cfg.use_checkpoint else ''}"
             f"{' pairwise' if cfg.pairwise_loss else ''} T={frames}")
    batch = synthetic_batch(np.random.default_rng(5), batch=1, frames=frames, height=size[0],
                            width=size[1], text_len=8, vocab_size=cfg.text_vocab,
                            with_valid_indices=valid_frame is not None)
    if valid_frame is not None:
        batch["valid_indices"][:] = valid_frame
        batch["targets"] = {k: (v[:, valid_frame:valid_frame + 1]
                                if v.ndim > 1 and k != "size" else v)
                            for k, v in batch["targets"].items()}
    cpu_model = build_model(cfg, device="cpu")
    if noise:
        perturb(cpu_model, seed=4)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    args = [torch.from_numpy(batch[k]) for k in ("samples", "samples_mask", "text_ids",
                                                 "text_mask")]
    args.append(torch.from_numpy(batch["targets"]["size"]))
    vidx = None if valid_frame is None else torch.from_numpy(batch["valid_indices"])
    targets = {k: torch.from_numpy(v) for k, v in batch["targets"].items()}
    matched = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        with torch.no_grad():
            out = model(*(a.to(dev) for a in args), None if vidx is None else vidx.to(dev),
                        targets={k: v.to(dev) for k, v in targets.items()}, train=True)
        matched.append(out["matched"].cpu())
    check(torch.equal(matched[0], matched[1]),
          f"card train {label} matched {matched[1].tolist()} != cpu {matched[0].tolist()}")
    metrics = []
    for model in (cpu_model, gpu_model):
        step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                               build_optimizer(model, cfg), deterministic=True,
                               has_valid_indices=valid_frame is not None)
        reset_counts()
        with k7_calls() as calls:
            metrics.append(step(batch))
    torch.cuda.synchronize()
    counts = read_counts()
    layers = cfg.enc_layers + cfg.dec_layers
    check(counts == counts_of(K1=layers, K2=layers, K7=k7),
          f"card train step {label} launched {counts} (want K1 and K2 {layers} times "
          f"each, K7 {k7})")
    want, got = metrics
    check(got.keys() == want.keys(), f"card train {label} metrics {sorted(got)}")
    worst = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
    for k, v in want.items():
        check(abs(got[k] - v) <= 1e-3 * max(abs(v), 1e-6),
              f"card train {label} {k}: card {got[k]} vs cpu {v} (limit 1e-3 relative)")
    log(f"card train step {label}: matched {matched[0].tolist()} on both; {len(want)} "
        f"metrics, max relative |card - cpu| {worst:.2e} (limit 1e-3); loss "
        f"{got['loss']:.4f}, grad_norm {got['grad_norm']:.4f}; launches {counts}")
    return counts, calls


# ------------------------------------------------------------------ swin_t --
def phase_swin_t(results):
    """Video Swin-T at its own widths: the full-width ``a2d_videoswin_tiny``
    (embed 96, depths 2/2/6/2, 3/6/12/24 heads; RoBERTa-base, 4+4 layers)
    from its seeded init, one float32 train step on an A2D batch (one
    2 x 192 x 256 clip, valid_indices, TF32 off) on the card against the
    CPU: matched queries identical, every loss and grad_norm within 1e-3
    relative, K1 and K2 8 times, K7 12 times, at the (bw, heads, n) phase
    kernel held.  Then one bf16 A2D eval forward at 1 x 5 x 384 x 640 (K7
    12, K1 8) and its time."""
    cfg = a2d_videoswin_tiny()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        counts, calls = card_train_step(cfg.replace(compute_dtype="float32"), SWIN_T_STEP_T,
                                        SWIN_T_BLOCKS, size=SWIN_T_STEP_SIZE, noise=False,
                                        valid_frame=1)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
    results["paths"]["swin_t_step"] = counts
    # stage 0 (3 heads) and stage 3 (24 heads) of the step
    held = {c for c in calls if c[1] in (SWIN_T_HEADS[0], SWIN_T_HEADS[3])}
    want = {(bw, heads, n) for name, bw, heads, n, _ in swin_t_calls() if "train" in name}
    check(held == want, f"swin_t: the step's stage-0 and stage-3 K7 calls {sorted(held)} "
                        f"are not those phase kernel holds {sorted(want)}")
    log(f"swin_t: card vs CPU float32 step of {cfg.backbone} in {time.perf_counter() - t0:.1f} "
        f"s (two model copies); K7 calls (bw, heads, n) {sorted(set(calls))}")
    a2d_path(results, "swin_t_a2d", cfg, SWIN_T_BLOCKS)


# ------------------------------------------------------------------- serve --
def serve_path(results, name, cfg, k7_per_dispatch):
    """``cfg`` at full width behind ClipInferenceEngine, answering six uint8
    requests of mixed sizes at the 384 x 640 bucket, clip_len 5."""
    t0 = time.perf_counter()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    log(f"{name}: built {cfg.backbone} + RoBERTa {cfg.text_layers}x{cfg.text_hidden}, "
        f"{cfg.enc_layers}+{cfg.dec_layers} layers, {cfg.compute_dtype}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params "
        f"in {time.perf_counter() - t0:.1f} s")
    engine = ClipInferenceEngine(model, clip_len=5, buckets=((384, 640),))
    tok = SimpleTokenizer(max_len=16, vocab_size=cfg.text_vocab)
    rng = np.random.default_rng(1)
    shapes = [(5, 384, 640), (3, 360, 640), (5, 300, 500), (1, 384, 512),
              (4, 240, 320), (2, 384, 640)]
    captions = ["a man riding a horse", "the dog on the left", "a red car turning",
                "person in white shirt", "the cat jumping down", "a bird on a branch"]
    requests = []
    for (t, h, w), cap in zip(shapes, captions):
        ids, mask = tok([cap])
        requests.append(InferRequest(rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8),
                                     ids[0], mask[0]))
    engine.run(requests[:2])                 # warm-up: cuDNN plans, kernel load
    torch.cuda.synchronize()

    done = []
    batches0 = engine.n_batches
    reset_counts()
    t0 = time.perf_counter()
    out = engine.run(requests, progress=lambda k: done.append(time.perf_counter() - t0))
    wall = time.perf_counter() - t0
    counts = read_counts()
    dispatches = engine.n_batches - batches0
    for r, o in zip(requests, out):
        check(o.shape == r.frames.shape[:3], f"answer {o.shape} for a {r.frames.shape} request")
        check(bool(np.isfinite(o).all()), "non-finite mask logits")
    want = counts_of(K1=8 * dispatches, K7=k7_per_dispatch * dispatches)
    check(counts == want, f"{name}: {dispatches} dispatches launched {counts}, want {want}")
    frames = sum(r.frames.shape[0] for r in requests)
    log(f"{name}: {len(requests)} requests, {frames} frames, {dispatches} dispatches, "
        f"launches {counts}, wall {wall:.3f} s, {frames / wall:.2f} frames/s")
    log(f"{name}: per-request completion latency (s): "
        + ", ".join(f"{x:.3f}" for x in done))
    results["paths"][name] = counts
    return profile_run(f"{name}: one dispatch ({requests[0].frames.shape[0]} frames, "
                       "canvas 384x640)", lambda: engine.run([requests[0]]))


def phase_serve(results):
    serve_path(results, "serve", ytvos_r101_boxsup(), 0)


def phase_swin_serve(results):
    prof = serve_path(results, "swin_serve", davis_videoswin_base(), SWIN_B_BLOCKS)
    if prof:
        k7 = prof["classes"].get("wattn", 0.0)
        log(f"swin_serve: K7 (wattn_fwd) {k7:.2f} ms = "
            f"{100 * k7 / prof['busy_ms']:.1f}% of a dispatch's device time; "
            f"K1 {prof['classes'].get('msda', 0.0):.2f} ms")


# --------------------------------------------------------------------- a2d --
def a2d_path(results, name, cfg, k7):
    """One A2D eval forward of ``cfg`` at full width on a 1 x 5 x 384 x 640
    clip with valid_indices, then its time over 5 forwards."""
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=5, height=384,
                            width=640)
    args = [torch.from_numpy(batch[k]).cuda() for k in
            ("samples", "samples_mask", "text_ids", "text_mask")]
    args.append(torch.from_numpy(batch["targets"]["size"]).cuda())
    vidx = torch.zeros(1, dtype=torch.int32, device="cuda")
    reset_counts()
    out = model(*args, valid_indices=vidx)
    torch.cuda.synchronize()
    counts = read_counts()
    want = counts_of(K1=cfg.enc_layers + cfg.dec_layers, K7=k7)
    check(counts == want, f"{name}: one forward launched {counts}, want {want}")
    results["paths"][name] = counts
    log(f"{name}: one {cfg.backbone} forward, launches {counts}")
    pm = out["pred_masks"]
    check(tuple(pm.shape) == (1, 1, 5, 384, 640), f"A2D pred_masks {tuple(pm.shape)}")
    check(bool(torch.isfinite(pm).all()), "A2D pred_masks not finite")
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        model(*args, valid_indices=vidx)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    log(f"{name}: eval forward 1x5x384x640 bf16 {dt * 1e3:.2f} ms, "
        f"{5 / dt:.2f} clip frames/s")


def phase_a2d(results):
    a2d_path(results, "a2d", a2d_r101_boxsup(), 0)


def phase_swin_a2d(results):
    # the JAX bench's Swin-B eval stage: the A2D config with the Swin-B backbone
    a2d_path(results, "swin_a2d", a2d_r101_boxsup().replace(backbone="video_swin_b_p4w7"),
             SWIN_B_BLOCKS)


# ------------------------------------------------------------------- train --
def compact_wire(batch, rng):
    """``batch`` in the compact wire of the JAX loader (``pad_to_canvas(
    compact=True)``): uint8 RGB frames, uint8 binary masks, float16 heatmaps."""
    out = dict(batch, samples=rng.integers(0, 256, batch["samples"].shape, dtype=np.uint8))
    tg = dict(batch["targets"])
    for k, dtype in (("masks", np.uint8), ("weights", np.float16), ("weak_masks", np.uint8)):
        tg[k] = tg[k].astype(dtype)
    out["targets"] = tg
    return out


def train_path(results, name, cfg, batch, k7):
    """The full-width train step of ``cfg`` (forward, matcher, losses,
    backward, clip, AdamW; dropout and stochastic depth on) on ``batch``:
    after a warm-up step, one step launches K1 and K2 once per transformer
    layer and K7 ``k7`` times, gives finite losses and grad norm, moves every
    trained group and leaves the frozen parameters bit-identical; then
    ms/step over 5 steps, peak memory, and one step under torch.profiler.
    Returns the profile (profile_run)."""
    t0 = time.perf_counter()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    optimizer = build_optimizer(model, cfg)
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg), optimizer)
    log(f"{name}: built {cfg.backbone}{' (use_checkpoint)' if cfg.use_checkpoint else ''} "
        f"+ RoBERTa {cfg.text_layers}x{cfg.text_hidden}, {cfg.enc_layers}+{cfg.dec_layers} "
        f"layers, {cfg.compute_dtype} compute, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"{sum(len(g['params']) for g in optimizer.adamw.param_groups)} trained tensors "
        f"in {time.perf_counter() - t0:.1f} s; batch samples {batch['samples'].dtype}, "
        f"heatmaps {batch['targets']['weights'].dtype}")
    step(batch)                              # warm-up: cuDNN plans, Adam state
    torch.cuda.synchronize()

    labels = {n: param_group_label(cfg, n) for n, _ in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_counts()
    metrics = step(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    layers = cfg.enc_layers + cfg.dec_layers
    check(counts == counts_of(K1=layers, K2=layers, K7=k7),
          f"{name} step launched {counts} (want K1 and K2 {layers} times each, K7 {k7})")
    results["paths"][name] = counts
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    check(not bad and metrics["finite"] == 1.0, f"{name} step: non-finite {bad}")
    moved = {}
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if labels[n] == "frozen":
            check(same, f"{name}: frozen parameter {n} changed")
        else:
            n_moved, n_all = moved.get(labels[n], (0, 0))
            moved[labels[n]] = (n_moved + (not same), n_all + 1)
    check(all(m > 0 for m, _ in moved.values()), f"{name}: trained groups did not move: {moved}")
    frozen = sorted({n.split(".")[0] for n, g in labels.items() if g == "frozen"})
    del before
    log(f"{name}: one step, launches {counts}; loss {metrics['loss']:.4f}, grad_norm "
        f"{metrics['grad_norm']:.4f}, all {len(metrics)} metrics finite; tensors moved "
        "by group: " + ", ".join(f"{g} {m}/{a}" for g, (m, a) in sorted(moved.items()))
        + f"; frozen ones ({', '.join(frozen)}) bit-identical")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sum(times) / len(times)
    b, t, h, w = batch["samples"].shape[:4]
    log(f"{name}: B={b} T={t} {h}x{w} step {ms:.2f} ms mean over {len(times)} (min "
        f"{min(times):.2f}, max {max(times):.2f}; " + ", ".join(f"{x:.2f}" for x in times)
        + f"), peak memory {peak:.2f} GiB")
    prof = profile_run(f"{name}: one train step (B={b}, T={t}, {h}x{w})", lambda: step(batch))
    if prof:
        classes, total = prof["classes"], prof["busy_ms"]
        log(f"{name}: K2 (msda_cm_bwd) {classes.get('msda_cm_bwd', 0.0):.2f} ms = "
            f"{100 * classes.get('msda_cm_bwd', 0.0) / total:.1f}% of device time; "
            f"K1 {classes.get('msda', 0.0):.2f} ms")
    return prof


def phase_train(results):
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=3, height=512,
                            width=640)
    train_path(results, "train", ytvos_r101_boxsup(), batch, 0)


def phase_swin_train(results):
    """The JAX bench's Swin-B train stage (``ytvos_r101_boxsup`` with the
    Video Swin-B backbone, B=1, T=3, 512x640, bf16), fed the compact wire:
    without per-block recompute (K7 once per block) and with it (twice)."""
    rng = np.random.default_rng(0)
    batch = compact_wire(synthetic_batch(rng, batch=1, frames=3, height=512, width=640), rng)
    cfg = ytvos_r101_boxsup().replace(backbone="video_swin_b_p4w7")
    for name, use_checkpoint in (("swin_train", False), ("swin_train_recompute", True)):
        prof = train_path(results, name, cfg.replace(use_checkpoint=use_checkpoint), batch,
                          SWIN_B_BLOCKS * (2 if use_checkpoint else 1))
        gc.collect()
        torch.cuda.empty_cache()
        if not prof:
            continue
        classes, total = prof["classes"], prof["busy_ms"]
        fwd, bwd = classes.get("wattn", 0.0), prof["wattn_bwd_ms"]
        log(f"{name}: K7 forward (wattn_fwd, forward and recompute) {fwd:.2f} ms = "
            f"{100 * fwd / total:.1f}%, K7 plain backward (the kernels under the "
            f"Function's backward: bmm, softmax and its backward, casts) {bwd:.2f} ms = "
            f"{100 * bwd / total:.1f}% of {total:.2f} device ms; copy/cast "
            f"{classes.get('copy/cast', 0.0):.2f}, norm {classes.get('norm', 0.0):.2f}, "
            f"gemm {classes.get('gemm', 0.0):.2f} ms")


# ------------------------------------------------------------------ resume --
def phase_resume(results):
    """Two train steps of the small model (dropout on), a save, a restore
    into a fresh model, optimizer and step: their state dicts and the
    generator state bit-identical to the saved ones; then one more step on
    each side, losses within 1e-3 relative (K2's float32 sums are atomic,
    so their order changes from run to run)."""
    cfg = SMALL.replace(dataset_file="ytvos")
    batches = [synthetic_batch(np.random.default_rng(20 + i), batch=1, frames=2, height=128,
                               width=192, text_len=8, vocab_size=cfg.text_vocab)
               for i in range(3)]

    def fresh(seed):
        model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
        optimizer = build_optimizer(model, cfg)
        step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                               optimizer)
        return {"model": model, "optimizer": optimizer, "train_step": step}

    directory = os.path.join(_build.BUILD_DIR, "resume_checkpoint")
    shutil.rmtree(directory, ignore_errors=True)
    reset_counts()
    run = fresh(0)
    for batch in batches[:2]:
        run["train_step"](batch)
    CheckpointManager(directory).save(2, run)
    resumed = fresh(1)
    restored = CheckpointManager(directory).restore()
    for name, obj in resumed.items():
        obj.load_state_dict(restored[name])
    for name in run:
        want = run[name].state_dict()
        same_tree(f"resume {name} (saved)", restored[name], want)
        same_tree(f"resume {name} (loaded)", resumed[name].state_dict(), want)
    count, at = resumed["optimizer"].count, resumed["train_step"].state["step"]
    want = run["train_step"](batches[2])
    got = resumed["train_step"](batches[2])
    torch.cuda.synchronize()
    counts = read_counts()
    layers = cfg.enc_layers + cfg.dec_layers
    check(counts == counts_of(K1=4 * layers, K2=4 * layers), f"resume launched {counts}")
    results["paths"]["resume"] = counts
    worst = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
    check(worst <= 1e-3, f"resume: the next step's metrics differ by {worst} relative")
    shutil.rmtree(directory)
    log(f"resume: 2 steps, save, restore into fresh objects: model, optimizer (AdamW "
        f"moments, count {count}), step counter {at} and generator state bit-identical; the "
        f"next step's {len(want)} metrics within {worst:.2e} relative (limit 1e-3); "
        f"launches {counts}")


# --------------------------------------------------------------- train_cli --
# the trees of the CLI phases: 8 frames at the native YTVOS size.  Phase
# train_cli trains on bench_loader.build_tree's Ref-YouTube-VOS tree (one
# video, one expression, its AnnotationsWeakly h5 heat maps written and
# read by data/h5.py); write_davis_tree's Ref-DAVIS trees (full masks, no
# heat maps) feed multi_gpu, infer_davis and pretrained
CLI_FRAMES, CLI_H, CLI_W = 8, 720, 1280


def palette_png(indices: np.ndarray) -> bytes:
    """A palette PNG of (H, W) uint8 indices (index i colored (i, i, i)),
    written with the standard library."""
    import struct
    import zlib

    h, w = indices.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), indices], 1)   # filter 0
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes())
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_davis_tree(root, split="train", frames=CLI_FRAMES, objects=1):
    """Seeded JPEG frames (PIL) and palette-PNG masks of ``objects`` (1 or 2)
    objects moving across ``frames`` frames, and the expression file: one
    expression per object in the train split, 4 (one per annotator,
    interleaved as Ref-DAVIS's ``obj_id * 4 + anno_id``) otherwise."""
    from PIL import Image

    rng = np.random.default_rng(7)
    video, names = "vid0", [f"{i:05d}" for i in range(frames)]
    for sub in ("JPEGImages", "Annotations"):
        os.makedirs(os.path.join(root, split, sub, video))
    base = np.kron(rng.random((CLI_H // 16, CLI_W // 16, 3)), np.ones((16, 16, 1)))
    yy, xx = np.mgrid[0:CLI_H, 0:CLI_W]
    for k, name in enumerate(names):
        step = k * CLI_FRAMES / frames
        cy, cx = 360 + 10 * step, 420 + 60 * step
        obj = ((yy - cy) / 170.0) ** 2 + ((xx - cx) / 260.0) ** 2 <= 1.0
        img = 180 * base + 40 * rng.random((CLI_H, CLI_W, 3))
        ids = obj.astype(np.uint8)
        if objects == 2:
            obj2 = (((yy - 200 - 5 * step) / 120.0) ** 2
                    + ((xx - 1000 + 40 * step) / 160.0) ** 2) <= 1.0
            img[obj2] = 0.5 * img[obj2] + [20, 20, 110]
            ids = np.where(obj, 1, np.where(obj2, 2, 0)).astype(np.uint8)
        img[obj] = 0.5 * img[obj] + [110, 20, 20]
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, split, "JPEGImages", video, f"{name}.jpg"), quality=90)
        with open(os.path.join(root, split, "Annotations", video, f"{name}.png"), "wb") as f:
            f.write(palette_png(ids))
    captions = ("the red blob moving to the right", "the blue blob moving to the left")
    if split == "train":
        expressions = {str(o): {"exp": captions[o], "obj_id": str(o + 1)}
                       for o in range(objects)}
    else:
        expressions = {str(o * 4 + a): {"exp": f"{captions[o]}, annotator {a}",
                                        "obj_id": str(o + 1)}
                       for o in range(objects) for a in range(4)}
        expressions = dict(sorted(expressions.items(), key=lambda kv: int(kv[0])))
    os.makedirs(os.path.join(root, "meta_expressions", split))
    with open(os.path.join(root, "meta_expressions", split, "meta_expressions.json"),
              "w") as f:
        json.dump({"videos": {video: {"frames": names, "expressions": expressions}}}, f)


def pinned_copy_ms(batch):
    """Device ms of one compact batch's host-to-device copy from pinned
    memory (cuda_times), and its bytes."""
    from ocpg_tpu_torch.parallel.mesh import _map_arrays, _tensors

    pinned = _map_arrays(batch, lambda x: torch.as_tensor(x).pin_memory())
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(pinned))
    ms, _ = cuda_times(lambda: _map_arrays(pinned, lambda t: t.to("cuda", non_blocking=True)),
                       iters=20)
    return ms, nbytes


def h5_read_ms(root):
    """Host ms per ``read_datasets`` of one frame's 720 x 1280 float32
    heatPoint with 1 and with 3 instances (the file just written, so in the
    page cache), beside the PIL decode of a 720 x 1280 JPEG of the tree."""
    from PIL import Image

    from ocpg_tpu_torch.data.h5 import read_datasets, write_datasets

    rng = np.random.default_rng(3)
    out = {}
    for n in (1, 3):
        path = os.path.join(root, f"heat{n}.h5")
        heat = rng.random((n, CLI_H, CLI_W), dtype=np.float32)
        write_datasets(path, (("obj_ids", np.arange(1, n + 1)), ("heatPoint", heat),
                              ("heatBBox", heat)))
        check(np.array_equal(read_datasets(path, ("heatPoint",))["heatPoint"], heat),
              f"h5 read of {n} instances")
        out[f"h5_heatpoint_{n}_ms"] = median_ms(
            lambda: read_datasets(path, ("heatPoint", "obj_ids")))
    jpg = os.path.join(root, "ytvos", "train", "JPEGImages", "vid0", "00000.jpg")
    out["pil_jpeg_ms"] = median_ms(lambda: np.asarray(Image.open(jpg).convert("RGB")))
    return out


def median_ms(fn, iters=20):
    """Median host ms of ``fn()`` over ``iters`` calls after one warm call."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_train_cli(results):
    """The port's train CLI in this process, as a user runs it: the
    full-width ytvos_r101_boxsup model (ResNet-101, bf16, canvas 512 x 640,
    B=1, T=3) on a seeded Ref-YouTube-VOS tree of 720 x 1280 frames with
    its AnnotationsWeakly h5 heat maps (``bench_loader.build_tree``, written
    and read by ``data/h5.py``), one epoch, then --resume for a second.  The
    first batch's heat maps and weak masks nonzero inside the object; K1
    and K2 8 times a step over every step of both runs, K3-K7 never; no cv2
    and no h5py loaded; every logged loss finite; log.txt with epochs 0 and
    1; the latest checkpoint at 2 x steps per epoch; the frozen ResNet stem
    and text encoder of the resumed model bit-identical to their init.  Also
    the loader alone (batches/s with its worker count and the host's cores),
    one compact batch's pinned copy and one heat-map read beside one JPEG
    decode."""
    from ocpg_tpu_torch.cli import train as train_cli
    from ocpg_tpu_torch.data.imageio import decoder
    from ocpg_tpu_torch.scripts.bench_loader import build_tree

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="train_cli_", dir=_build.BUILD_DIR)
    try:
        tree, out = os.path.join(root, "ytvos"), os.path.join(root, "run")
        t0 = time.perf_counter()
        build_tree(tree, 1, CLI_FRAMES, CLI_H, CLI_W, dataset="ytvos")
        tree_s = time.perf_counter() - t0
        argv = ["--dataset_file", "ytvos", "--ytvos_path", tree, "--backbone", "resnet101",
                "--supervision", "box", "--num_frames", "3", "--batch_size", "1",
                "--output_dir", out, "--log_every", "1", "--tb_every", "0",
                "--debug_images_every", "0"]
        args = train_cli.get_args(argv + ["--epochs", "1"])
        cfg = train_cli.make_config(args)
        width = [f.name for f in dataclasses.fields(cfg)
                 if f.name not in ("dataset_file", "epochs")]
        check(all(getattr(cfg, k) == getattr(ytvos_r101_boxsup(), k) for k in width),
              "train_cli: the CLI's config is not ytvos_r101_boxsup at full width")
        dataset = train_cli.make_dataset(args, cfg)
        loader = train_cli.make_loader(args, cfg, dataset)
        steps = len(dataset) // cfg.batch_size
        log(f"train_cli: Ref-YTVOS tree with h5 heat maps, {CLI_FRAMES} frames at "
            f"{CLI_H}x{CLI_W}, {len(dataset)} clips, written in {tree_s:.2f} s; decode "
            f"{decoder()}")
        reads = h5_read_ms(root)
        log(f"train_cli: one read_datasets of a {CLI_H}x{CLI_W} heatPoint (+ obj_ids): "
            f"{reads['h5_heatpoint_1_ms']:.3f} ms with 1 instance, "
            f"{reads['h5_heatpoint_3_ms']:.3f} ms with 3; PIL decode of one {CLI_H}x{CLI_W} "
            f"JPEG {reads['pil_jpeg_ms']:.3f} ms (host medians of 20, warm page cache) [{smi}]")

        # the loader alone: decode, transform and batch at 720p
        t0 = time.perf_counter()
        n = sum(1 for _ in loader.epoch(0)) + sum(1 for _ in loader.epoch(1))
        secs = time.perf_counter() - t0
        first = next(iter(loader.epoch(0)))
        t = first["targets"]
        inside = np.asarray(t["masks"]) > 0
        heat_in = float((np.asarray(t["weights"], np.float32)[inside] > 0).mean())
        weak_in = float((np.asarray(t["weak_masks"])[inside] > 0).mean())
        # (the heat map resizes linearly, the mask by nearest: a one-pixel
        # ring of the object can sample the zero outside it)
        check(inside.any() and heat_in >= 0.95 and weak_in >= 0.95,
              f"train_cli: the batch's heat maps ({heat_in:.4f} nonzero) or weak masks "
              f"({weak_in:.4f}) are not the object's")
        log(f"train_cli: first batch: {inside.sum()} object pixels, heat map nonzero on "
            f"{100 * heat_in:.2f}% of them, weak mask on {100 * weak_in:.2f}%")
        copy_ms, nbytes = pinned_copy_ms(first)
        log(f"train_cli: loader alone {n} batches in {secs:.3f} s = {n / secs:.2f} "
            f"batches/s, {loader.num_workers} worker threads on {os.cpu_count()} host "
            f"cores [{smi}]")
        log(f"train_cli: compact batch ({nbytes / 2**20:.2f} MiB) pinned host-to-device "
            f"copy {copy_ms:.4f} device ms = {nbytes / copy_ms / 1e6:.2f} GB/s [{smi}]")

        paths = {}
        torch.cuda.reset_peak_memory_stats()
        for run, extra in (("first", ["--epochs", "1"]),
                           ("resumed", ["--epochs", "2", "--resume",
                                        os.path.join(out, "checkpoints")])):
            reset_counts()
            t0 = time.perf_counter()
            train_cli.main(argv + extra)
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts == counts_of(K1=8 * steps, K2=8 * steps),
                  f"train_cli {run} run of {steps} steps launched {counts} (want K1 and K2 "
                  f"8 per step)")
            check("cv2" not in sys.modules and "h5py" not in sys.modules,
                  "train_cli: the train path imported cv2 or h5py")
            paths[run] = counts
            log(f"train_cli: {run} run, {steps} steps in {time.perf_counter() - t0:.1f} s "
                f"(model build, loader and checkpoint included), launches {counts} [{smi}]")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results["paths"]["train_cli"] = {k: paths["first"][k] + paths["resumed"][k]
                                         for k in paths["first"]}

        with open(os.path.join(out, "log.txt")) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        check([r["epoch"] for r in lines] == [0, 1], f"train_cli log.txt epochs {lines}")
        for r in lines:
            check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
                  f"train_cli epoch {r['epoch']}: non-finite logged loss {r}")
        latest = CheckpointManager(os.path.join(out, "checkpoints")).latest_step()
        check(latest == 2 * steps, f"train_cli latest checkpoint {latest} != {2 * steps}")
        saved = CheckpointManager(os.path.join(out, "checkpoints")).restore()["model"]
        init = build_model(cfg, device="cpu").state_dict()
        frozen = [k for k in init if k.startswith("text_encoder.") or (
            k.startswith("backbone.") and param_group_label(cfg, k) == "frozen")]
        changed = [k for k in frozen if not torch.equal(saved[k], init[k])]
        check(frozen and not changed, f"train_cli: frozen tensors changed: {changed[:5]}")
        moved = sum(not torch.equal(saved[k], init[k]) for k in init if k not in frozen)
        check(moved > 0, "train_cli: no trained tensor moved")
        for r in lines:
            per_step = r["data_time_s"] + r["step_time_s"]
            log(f"train_cli: epoch {r['epoch']}: {1 / per_step:.3f} steps/s over the loop "
                f"(data_time_s {r['data_time_s']:.4f} = {100 * r['data_time_s'] / per_step:.1f}%"
                f", step_time_s {r['step_time_s']:.4f}), epoch time_s {r['time_s']:.2f} "
                f"with its checkpoint; mean loss {r['loss']:.4f} [{smi}]")
        log(f"train_cli: peak memory {peak:.2f} GiB over both runs; {len(frozen)} frozen "
            f"tensors (ResNet stem and layer1, text encoder) bit-identical to the init after "
            f"the resume, {moved} others moved; latest checkpoint step {latest} [{smi}]")
        results["train_cli"] = {"steps_per_epoch": steps, "peak_gib": peak,
                                "loader_batches_per_s": n / secs, "pinned_copy_ms": copy_ms,
                                **reads}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------- multi_gpu --
MULTI_B, MULTI_T, MULTI_H, MULTI_W = 2, 3, 512, 640


def multi_batch(batch=MULTI_B):
    """The train stage's synthetic clips, B rows whose valid frames differ
    (3 and 1), so a box count taken per rank would be wrong."""
    b = synthetic_batch(np.random.default_rng(0), batch=batch, frames=MULTI_T,
                        height=MULTI_H, width=MULTI_W)
    b["targets"]["valid"][:] = np.asarray([[1, 1, 1], [1, 0, 0]][:batch], np.int32)
    return b


def flat_params(model, optimizer):
    """Every parameter and AdamW's moments, flattened to one float32 tensor."""
    parts = [p.detach().reshape(-1) for p in model.parameters()]
    for p in optimizer.adamw.state:
        st = optimizer.adamw.state[p]
        parts += [st["exp_avg"].reshape(-1), st["exp_avg_sq"].reshape(-1)]
    return torch.cat(parts)


def multi_gpu_world_one(results, smi):
    """(a) An NCCL process group of world size 1 in this process: the
    full-width train step through TrainStep(mesh) against the step without a
    mesh from the same state, two steps each.  K2 and PyTorch's scatter-add
    backwards add float32 with atomics, so two backwards of the same step
    differ in their last bits (a second no-mesh run measures by how much);
    the mesh run is therefore handed the no-mesh run's gradients as its
    backward leaves them, and from there (the flat all-reduce of every
    gradient, the clip, AdamW, the all-reduced losses) the two runs must be
    bit-identical: the gradients leave the all-reduce as they entered it,
    in the tensors the backward made, and every parameter, AdamW moment and metric after two steps equals the
    no-mesh run's.  Returns the launches of the mesh run."""
    from ocpg_tpu_torch.parallel.distributed import free_port, initialize_distributed
    from ocpg_tpu_torch.parallel.mesh import create_mesh

    os.environ.update(OCPG_COORDINATOR=f"127.0.0.1:{free_port()}", OCPG_NUM_PROCESSES="1",
                      OCPG_PROCESS_ID="0")
    try:
        check(initialize_distributed(device="cuda"), "multi_gpu: no process group")
        mesh = create_mesh(device="cuda")
        backend = torch.distributed.get_backend()
        check(backend == "nccl" and mesh.size == 1, f"multi_gpu: world {mesh.size}, {backend}")
        cfg = ytvos_r101_boxsup()
        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        init = {k: v.clone() for k, v in model.state_dict().items()}
        batch = multi_batch(1)
        runs, counts, grads_kept, backward_grads = {}, None, [], []
        times = {}
        for run in ("plain", "mesh", "plain again"):
            model.load_state_dict(init)
            optimizer = build_optimizer(model, cfg)
            with_mesh = run == "mesh"
            step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                                   optimizer, mesh=mesh if with_mesh else None)
            if run == "plain":
                clip = optimizer.clip_grads_

                def recorded_clip(clip=clip, optimizer=optimizer):
                    backward_grads.append([None if p.grad is None else p.grad.clone()
                                           for p in optimizer.params])
                    return clip()
                optimizer.clip_grads_ = recorded_clip
            if with_mesh:
                average = optimizer.average_grads_

                def same_backward_average(m, average=average, optimizer=optimizer):
                    want = backward_grads[len(grads_kept)]
                    for p, g in zip(optimizer.params, want):
                        check((p.grad is None) == (g is None), "multi_gpu: gradient sets")
                        if g is not None:
                            p.grad.copy_(g)
                    ptrs = [None if p.grad is None else p.grad.data_ptr()
                            for p in optimizer.params]
                    average(m)
                    # the same values, in the tensors the backward made (so
                    # the clip's foreach norm reads the no-mesh layout)
                    grads_kept.append(all(
                        (g is None and p.grad is None)
                        or (torch.equal(g, p.grad) and p.grad.data_ptr() == ptr)
                        for g, p, ptr in zip(want, optimizer.params, ptrs)))
                optimizer.average_grads_ = same_backward_average
                reset_counts()
            metrics = [step(batch) for _ in range(2)]
            torch.cuda.synchronize()
            if with_mesh:
                counts = read_counts()
                optimizer.average_grads_ = average
            if run == "plain":
                optimizer.clip_grads_ = clip
            runs[run] = (metrics, flat_params(model, optimizer))
            if run != "plain again":
                torch.cuda.reset_peak_memory_stats()
                ms = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    step(batch)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                times[run] = (sum(ms) / len(ms), torch.cuda.max_memory_allocated() / 2 ** 30)
            del optimizer, step
        del backward_grads
        check(counts == counts_of(K1=16, K2=16),
              f"multi_gpu NCCL world 1: two steps launched {counts} (want K1 and K2 8 a step)")
        check(grads_kept == [True, True],
              f"multi_gpu NCCL world 1: the all-reduce changed the gradients or moved them out "
              f"of their own tensors {grads_kept}")
        (m_plain, p_plain), (m_mesh, p_mesh), (m_again, p_again) = (
            runs["plain"], runs["mesh"], runs["plain again"])
        check(torch.equal(p_mesh, p_plain),
              f"multi_gpu NCCL world 1: after 2 steps {int((p_mesh != p_plain).sum())} "
              f"parameter and AdamW values differ from the no-mesh run's (max "
              f"{float((p_mesh - p_plain).abs().max()):.3e})")
        check(m_mesh == m_plain, f"multi_gpu NCCL world 1: metrics {m_mesh} != {m_plain}")
        spread = float((p_again - p_plain).abs().max())
        differ = int((p_again != p_plain).sum())
        log(f"multi_gpu (a): NCCL world 1, full-width ytvos_r101_boxsup B=1 T=3 "
            f"{MULTI_H}x{MULTI_W} bf16: launches {counts} over 2 steps; given the no-mesh "
            f"run's backward, the all-reduce handed every gradient back bit-identical, in its "
            f"own tensor, in both steps and all {p_plain.numel()} parameter and AdamW values and every metric "
            f"after 2 steps are bit-identical; a second no-mesh run (its own backward) differs "
            f"in {differ} values, max {spread:.3e}, step-1 loss {m_again[0]['loss']!r} vs "
            f"{m_plain[0]['loss']!r} [{smi}]")
        identical = True
        # the flat all-reduce alone, on a buffer of every gradient's size
        n = sum(p.numel() for p in model.parameters() if p.requires_grad)
        flat = torch.zeros(n, device="cuda")
        ar_ms = cuda_ms(lambda: torch.distributed.all_reduce(flat), iters=10)
        gb = flat.numel() * 4 / 1e9
        del flat
        log(f"multi_gpu (a): step {times['plain'][0]:.2f} ms without the mesh, "
            f"{times['mesh'][0]:.2f} ms with it (mean of 5, host clock); peak memory "
            f"{times['plain'][1]:.2f} / {times['mesh'][1]:.2f} GiB; the flat all-reduce of "
            f"{n / 1e6:.1f} M float32 gradients ({gb:.3f} GB) {ar_ms:.4f} device ms in NCCL "
            f"(world 1) [{smi}]")
        results["multi_gpu"] = {"step_ms": times["plain"][0], "mesh_step_ms": times["mesh"][0],
                                "peak_gib": times["plain"][1],
                                "mesh_peak_gib": times["mesh"][1],
                                "allreduce_ms": ar_ms, "allreduce_gb": gb,
                                "bit_identical": identical, "plain_spread": spread}
        del model, init
        return counts
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k in ("OCPG_COORDINATOR", "OCPG_NUM_PROCESSES", "OCPG_PROCESS_ID"):
            os.environ.pop(k, None)
        gc.collect()
        torch.cuda.empty_cache()


def multi_gpu_engine_requests():
    rng = np.random.default_rng(3)
    ids, attn = SimpleTokenizer(vocab_size=50265)(["the red blob moving to the right"])
    return [InferRequest(frames=rng.integers(0, 255, (3, 360 if i % 2 else 480, 640, 3),
                                             dtype=np.uint8),
                         text_ids=ids[0], text_mask=attn[0]) for i in range(5)]


def multi_gpu_rank_float32(rank, ref_path):
    """(b) on one rank of two sharing the card over gloo: the float32
    full-width train step (TF32 off, dropout off) on this rank's row of the
    B=2 batch, the weights broadcast from rank 0, held against the one-rank
    B=2 step of the parent (``ref_path``); then the eval forward of the rows
    and the engine over the mesh.  Returns the worst deviations, launches,
    peak memory and the all-reduce's wall ms."""
    from ocpg_tpu_torch.parallel.distributed import initialize_distributed
    from ocpg_tpu_torch.parallel.mesh import create_mesh, gather_rows, replicate, shard_batch

    initialize_distributed(device="cuda")
    mesh = create_mesh(2, device="cuda")
    check(torch.distributed.get_backend() == "gloo", "multi_gpu (b): not gloo")
    ref = torch.load(ref_path, mmap=True)
    cfg = ytvos_r101_boxsup().replace(compute_dtype="float32")
    out = {"rank": rank}
    with no_tf32():
        model = build_model(cfg, generator=torch.Generator().manual_seed(100 + rank))
        replicate(mesh, model)
        optimizer = build_optimizer(model, cfg)
        step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                               optimizer, deterministic=True, mesh=mesh)
        average = optimizer.average_grads_
        wall = []

        def timed_average(m):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            average(m)
            wall.append((time.perf_counter() - t0) * 1e3)
        optimizer.average_grads_ = timed_average
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        metrics = step(shard_batch(mesh, multi_batch()))
        torch.cuda.synchronize()
        out["train_launches"] = read_counts()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["allreduce_wall_ms"] = wall[0]
        out["loss_rel"] = max(abs(metrics[k] - v) / max(abs(v), 1e-6)
                              for k, v in ref["metrics"].items()
                              if k not in ("grad_norm", "finite"))
        out["grad_norm_rel"] = abs(metrics["grad_norm"] - ref["metrics"]["grad_norm"]) / abs(
            ref["metrics"]["grad_norm"])
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                 for n, p in model.named_parameters()}
        mu = {n: optimizer.adamw.state[p]["exp_avg"].cpu()
              for n, p in model.named_parameters() if p in optimizer.adamw.state}
        (out["grad_rel"], leaf), (out["mu_rel"], _) = (worst_leaf(grads, ref["grads"]),
                                                       worst_leaf(mu, ref["mu"]))
        out["worst_leaves"] = sorted(
            ((float((g - ref["grads"][n]).abs().max())
              / max(float(ref["grads"][n].abs().max()), 1e-6), n) for n, g in grads.items()),
            reverse=True)[:8]
        diff = sum(float(((g - ref["grads"][n]) ** 2).sum()) for n, g in grads.items())
        total = sum(float((g ** 2).sum()) for g in ref["grads"].values())
        out["grad_global_rel"] = math.sqrt(diff / total)
        del grads, mu
        del optimizer, step

        # the eval forward of this rank's row, gathered; then the engine
        model.eval()
        local = shard_batch(mesh, multi_batch())
        reset_counts()
        with torch.no_grad():
            masks = model(local["samples"], local["samples_mask"], local["text_ids"],
                          local["text_mask"], local["targets"]["size"])["pred_masks"]
        masks = gather_rows(mesh, masks.float().contiguous()).cpu()
        want = ref["eval_masks"]
        out["eval_rel"] = float((masks - want).abs().max()) / float(want.abs().max())
        engine = ClipInferenceEngine(model, clip_len=3, mesh=mesh, per_device_batch=1)
        answers = engine.run(multi_gpu_engine_requests())
        torch.cuda.synchronize()
        out["serve_launches"] = read_counts()
        out["engine_rel"] = max(float(np.abs(a - w.numpy()).max()) / float(w.abs().max())
                                for a, w in zip(answers, ref["engine"]))
        out["engine_dispatches"] = engine.n_batches
    return out


def one_rank_float32_step(cfg):
    """The one-rank float32 step (TF32 off, dropout off) on the B=2 batch:
    its metrics, every clipped gradient and Adam's first moment, on the
    host, and the model."""
    model = build_model(cfg, generator=torch.Generator().manual_seed(100))
    optimizer = build_optimizer(model, cfg)
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg), optimizer,
                           deterministic=True)
    metrics = step(multi_batch())
    return model, {
        "metrics": metrics,
        "grads": {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                  for n, p in model.named_parameters()},
        "mu": {n: optimizer.adamw.state[p]["exp_avg"].cpu()
               for n, p in model.named_parameters() if p in optimizer.adamw.state}}


def relu_flips(model, batch):
    """Per transformer FFN, how many pre-activations of its ReLU change sign
    between the B=2 forward and the two rows' B=1 forwards (float32 GEMMs
    round by their M)."""
    pre = {}
    hooks = [mod.register_forward_hook(
        lambda m, i, o, name=name: pre.setdefault(name, []).append(o.detach()))
        for name, mod in model.named_modules() if name.endswith("linear1")
        and name.startswith("transformer.")]
    args = [torch.from_numpy(batch[k]).cuda() for k in ("samples", "samples_mask", "text_ids",
                                                        "text_mask")]
    args.append(torch.from_numpy(batch["targets"]["size"]).cuda())
    with torch.no_grad():
        model(*args)
        for r in range(len(args[0])):
            model(*(a[r:r + 1] for a in args))
    for h in hooks:
        h.remove()
    out = {}
    for name, (both, *rows) in pre.items():
        if both.shape[0] == len(rows) * rows[0].shape[0]:
            one = torch.cat(rows)
        else:
            one = torch.cat(rows, dim=1) if both.shape[1] == sum(r.shape[1] for r in rows) \
                else None
        if one is None or one.shape != both.shape:
            continue
        out[name] = int(((both > 0) != (one > 0)).sum())
    return out


def worst_leaf(got, want):
    """The largest max |got - want| of a leaf over its max |want| (floored at
    1e-6, as tests/test_torch_train_model.py does), and that leaf."""
    return max((float((g - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-6), n)
               for n, g in got.items())


def multi_gpu_two_ranks_float32(results, smi):
    """(b) The parent's one-rank B=2 float32 step, eval forward and engine
    run, saved for the two ranks, which hold themselves against it.  The
    step runs twice: K2 and PyTorch's scatter-add backwards add float32 with
    atomics, so the second run measures the reference's own spread, leaf by
    leaf; the ranks' clipped gradients and Adam first moment are held within
    the CPU tests' bounds where they hold on the card (see the check)."""
    from ocpg_tpu_torch.parallel.distributed import launch

    cfg = ytvos_r101_boxsup().replace(compute_dtype="float32")
    root = tempfile.mkdtemp(prefix="multi_gpu_", dir=_build.BUILD_DIR)
    try:
        with no_tf32():
            _, again = one_rank_float32_step(cfg)
            model, ref = one_rank_float32_step(cfg)
            ref["spread"] = {k: worst_leaf(again[k], ref[k]) for k in ("grads", "mu")}
            ref["spread"]["loss"] = max(abs(again["metrics"][k] - v) / max(abs(v), 1e-6)
                                        for k, v in ref["metrics"].items())
            del again
            model.eval()
            b = multi_batch()
            flips = relu_flips(model, b)
            with torch.no_grad():
                ref["eval_masks"] = model(*(torch.from_numpy(b[k]).cuda() for k in (
                    "samples", "samples_mask", "text_ids", "text_mask")),
                    torch.from_numpy(b["targets"]["size"]).cuda())["pred_masks"].float().cpu()
            ref["engine"] = [torch.from_numpy(a) for a in ClipInferenceEngine(
                model, clip_len=3, slots=1).run(multi_gpu_engine_requests())]
        ref_path = os.path.join(root, "reference.pt")
        torch.save(ref, ref_path)
        spread = ref["spread"]
        del model, ref
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = launch(multi_gpu_rank_float32, 2, ref_path, timeout=600)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    layers = cfg.enc_layers + cfg.dec_layers
    log(f"multi_gpu (b): two one-rank B=2 float32 steps differ by {spread['loss']:.2e} "
        f"relative in the losses and grad_norm, by {spread['grads'][0]:.2e} of scale in the "
        f"clipped gradients ({spread['grads'][1]}) and {spread['mu'][0]:.2e} in Adam's first "
        f"moment; ReLU pre-activations that change sign between that B=2 forward and its "
        f"rows' B=1 forwards, by FFN: {flips} [{smi}]")
    for r in got:
        log(f"multi_gpu (b) rank {r['rank']} of 2 (gloo, one card): float32 step launches "
            f"{r['train_launches']}; against the one-rank B=2 step: losses "
            f"{r['loss_rel']:.2e} relative (1e-5), grad_norm {r['grad_norm_rel']:.2e} (3e-5), "
            f"the clipped gradients {r['grad_global_rel']:.2e} of their norm (1e-4), per "
            f"leaf at most {r['grad_rel']:.2e} of its scale (2e-3; worst leaves "
            f"{r['worst_leaves'][:4]}), Adam first moment {r['mu_rel']:.2e} (2e-3); eval "
            f"masks {r['eval_rel']:.2e}, engine answers {r['engine_rel']:.2e} of scale (5e-3, "
            f"{r['engine_dispatches']} dispatches); peak memory {r['peak_gib']:.2f} GiB; "
            f"gradient all-reduce {r['allreduce_wall_ms']:.1f} wall ms [{smi}]")
    for r in got:
        check(r["train_launches"] == counts_of(K1=layers, K2=layers),
              f"multi_gpu (b) rank {r['rank']}: the step launched {r['train_launches']}")
        check(r["loss_rel"] <= 1e-5 and r["grad_norm_rel"] <= 3e-5,
              f"multi_gpu (b) rank {r['rank']}: losses {r['loss_rel']:.2e} (1e-5), grad_norm "
              f"{r['grad_norm_rel']:.2e} (3e-5) relative to the one-rank B=2 step")
        # the CPU tests' 1e-4 holds for the gradient as a whole; a leaf whose
        # ReLU gate flips (a B=1 and a B=2 float32 GEMM round apart) moves by
        # one token's term, about 1e-3 of its scale, so a leaf is held at 2e-3
        # (a box count taken per rank, or a missing all-reduce, moves leaves by
        # tens of percent)
        check(r["grad_global_rel"] <= 1e-4 and r["grad_rel"] <= 2e-3 and r["mu_rel"] <= 2e-3,
              f"multi_gpu (b) rank {r['rank']}: clipped gradients {r['grad_global_rel']:.2e} "
              f"of their norm (1e-4), per leaf {r['grad_rel']:.2e} (2e-3), Adam first moment "
              f"{r['mu_rel']:.2e} (2e-3)")
        check(r["eval_rel"] <= 5e-3 and r["engine_rel"] <= 5e-3,
              f"multi_gpu (b) rank {r['rank']}: eval masks {r['eval_rel']:.2e}, engine "
              f"{r['engine_rel']:.2e} of scale (limit 5e-3)")
    log(f"multi_gpu (b): two ranks in {secs:.1f} s (spawn, model builds and both runs)")
    results["multi_gpu"].update(gloo_allreduce_wall_ms=[r["allreduce_wall_ms"] for r in got],
                                gloo_peak_gib=[r["peak_gib"] for r in got],
                                grad_rel=[r["grad_rel"] for r in got],
                                reference_spread=spread["grads"][0])
    return [{k: r["train_launches"][k] + r["serve_launches"][k] for k in r["train_launches"]}
            for r in got]


def multi_gpu_train_cli_rank(rank, argv):
    """(d) ``cli.train`` on one rank (its own --output_dir); its launches."""
    from ocpg_tpu_torch.cli import train as train_cli

    reset_counts()
    train_cli.main(argv[rank])
    torch.cuda.synchronize()
    return read_counts()


def phase_multi_gpu(results):
    """(a) NCCL world 1 in this process, (b) two gloo ranks on the card at
    full width in float32 against the one-rank B=2 step, (c) the dry run on
    two ranks, (d) the train CLI on two ranks.  The launches of every rank
    are summed into path multi_gpu."""
    from ocpg_tpu_torch.parallel.distributed import launch
    from ocpg_tpu_torch.parallel.dryrun import dryrun_multigpu

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    parts = [multi_gpu_world_one(results, smi)]
    log(f"multi_gpu (a) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parts += multi_gpu_two_ranks_float32(results, smi)
    log(f"multi_gpu (b) in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    dry = dryrun_multigpu(2, "cuda")
    for r in dry:
        c = r["launches"]
        check(c["K1"] > 0 and c["K2"] > 0 and c["K7"] > 0,
              f"multi_gpu (c) rank {r['rank']}: dry run launched {c}")
        parts.append(counts_of(**c))
    log(f"multi_gpu (c): dryrun_multigpu(2) on the card (gloo), loss {dry[0]['loss']:.4f}, "
        f"launches by rank {[r['launches'] for r in dry]} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="multi_cli_", dir=_build.BUILD_DIR)
    try:
        tree = os.path.join(root, "davis")
        write_davis_tree(tree, frames=4)         # 4 clips: 2 steps of a global batch of 2
        outs = [os.path.join(root, f"rank{r}") for r in range(2)]
        argv = [["--dataset_file", "davis", "--davis_path", tree, "--backbone", "resnet101",
                 "--num_frames", "3", "--batch_size", "1", "--epochs", "1",
                 "--output_dir", out, "--log_every", "1", "--tb_every", "0",
                 "--debug_images_every", "0"] for out in outs]
        counts = launch(multi_gpu_train_cli_rank, 2, argv, timeout=600)
        for r, c in enumerate(counts):
            check(c == counts_of(K1=16, K2=16),
                  f"multi_gpu (d) rank {r}: 2 steps launched {c} (want K1 and K2 8 a step)")
        parts += counts
        check(not os.path.exists(outs[1]), "multi_gpu (d): rank 1 wrote its output_dir")
        with open(os.path.join(outs[0], "log.txt")) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        check(len(lines) == 1 and lines[0]["global_batch"] == 2
              and math.isfinite(lines[0]["loss"]), f"multi_gpu (d): log.txt {lines}")
        latest = CheckpointManager(os.path.join(outs[0], "checkpoints")).latest_step()
        check(latest == 2, f"multi_gpu (d): latest checkpoint {latest} != 2")
        log(f"multi_gpu (d): cli.train on 2 ranks, 2 steps of a global batch "
            f"{lines[0]['global_batch']}: launches by rank {counts}; rank 0 alone wrote "
            f"log.txt (loss {lines[0]['loss']:.4f}) and checkpoints/ (step {latest}); "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    results["paths"]["multi_gpu"] = {k: sum(p[k] for p in parts) for k in parts[0]}


# ---------------------------------------------------------------- eval_cli --
@contextlib.contextmanager
def timed_calls(module, names, secs):
    """Add the seconds spent in each ``module.<name>`` call to ``secs[name]``
    while inside (the functions' own module globals, which their callers
    look up at call time)."""
    saved = {n: getattr(module, n) for n in names}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    for n, fn in saved.items():
        setattr(module, n, timed(n, fn))
    try:
        yield secs
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


# videos and frames of the phase's JHMDB tree (240 x 320 PNG frames) and
# A2D tree (320 x 568 mp4 clips, the middle frame annotated)
JHMDB_VIDEOS, JHMDB_FRAMES = 7, 12
A2D_VIDEOS, A2D_FRAMES = 7, 8


def write_jhmdb_tree(root):
    build_jhmdb_tree(root, JHMDB_VIDEOS, JHMDB_FRAMES)


A2D_KEYS = ("mAP 0.5:0.95", "AP50", "AP75", "overall_iou", "mean_iou",
            "P@0.5", "P@0.6", "P@0.7", "P@0.8", "P@0.9")


def phase_eval_cli(results):
    """``python -m ocpg_tpu_torch.cli.evaluate`` in this process at full
    width (R101, bf16) with the CLI's defaults (device postprocess, f32),
    batches of 2 with a padded tail: ``--dataset_file a2d`` on a seeded
    A2D-Sentences tree (mp4 clips by cv2, the annotation h5 files by
    ``data/h5.py``), then ``--dataset_file jhmdb`` and again with
    ``--postprocess host``.  K1 8 per forward and nothing else, the A2D
    metric keys finite in [0, 1], the two JHMDB dicts within 1e-6.
    Clips/s, one forward with its postprocess in device ms, the packed mask
    wire beside the float32 canvas, the host seconds in RLE encoding and in
    the metrics."""
    from ocpg_tpu_torch.cli import evaluate as evaluate_cli
    from ocpg_tpu_torch.engine import evaluate
    from ocpg_tpu_torch.models import postprocessors

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    base = tempfile.mkdtemp(prefix="eval_cli_", dir=_build.BUILD_DIR)
    try:
        a2d, jhmdb = os.path.join(base, "a2d"), os.path.join(base, "jhmdb")
        t0 = time.perf_counter()
        build_a2d_tree(a2d, A2D_VIDEOS, A2D_FRAMES)
        log(f"eval_cli: A2D tree, {A2D_VIDEOS} mp4 clips of {A2D_FRAMES} frames at "
            f"{A2D_H}x{A2D_W} with their annotation h5 files, written in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        write_jhmdb_tree(jhmdb)
        log(f"eval_cli: JHMDB tree, {JHMDB_VIDEOS} videos of {JHMDB_FRAMES} PNG frames at "
            f"{JHMDB_H}x{JHMDB_W}, written in {time.perf_counter() - t0:.1f} s")
        # (path, argv, clips): A2D-Sentences, the paper's evaluation, then
        # JHMDB with the device and the host postprocess
        runs = (("eval_cli_a2d", ["--dataset_file", "a2d", "--a2d_path", a2d], A2D_VIDEOS),
                ("eval_cli", ["--dataset_file", "jhmdb", "--jhmdb_path", jhmdb,
                              "--postprocess", "device"], JHMDB_VIDEOS),
                ("eval_cli_host", ["--dataset_file", "jhmdb", "--jhmdb_path", jhmdb,
                                   "--postprocess", "host"], JHMDB_VIDEOS))
        metrics, kept, clips_per_s = {}, [], {}
        run = evaluate.evaluate_a2d
        for path, argv, clips in runs:
            secs = {}
            batches = -(-clips // 2)

            def keep(model, loader, **kw):
                kept.append((model, loader))
                t0 = time.perf_counter()
                try:
                    return run(model, loader, **kw)
                finally:
                    secs["loop"] = time.perf_counter() - t0

            evaluate.evaluate_a2d = keep
            try:
                with timed_calls(evaluate, ("rle_encode", "_metrics"), secs), \
                        timed_calls(postprocessors, ("rle_encode",), secs):
                    reset_counts()
                    t0 = time.perf_counter()
                    metrics[path] = evaluate_cli.main(argv + ["--batch_size", "2"])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                evaluate.evaluate_a2d = run
            counts = read_counts()
            check(counts == counts_of(K1=8 * batches),
                  f"{path}: {batches} batches launched {counts} (want K1 8 a forward)")
            results["paths"][path] = counts
            m = metrics[path]
            check(tuple(sorted(m)) == tuple(sorted(A2D_KEYS)), f"{path} keys {sorted(m)}")
            check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
                  f"{path} metrics {m}")
            rle_s, loop_s = secs.get("rle_encode", 0.0), secs["loop"]
            clips_per_s[path] = clips / loop_s
            log(f"{path}: {' '.join(argv[:2] + argv[4:])}: {clips} clips in {wall:.2f} s = "
                f"{clips / wall:.2f} clips/s (model build included; the eval loop "
                f"{loop_s:.2f} s = {clips / loop_s:.2f} clips/s); RLE encode "
                f"{rle_s:.3f} s = {100 * rle_s / loop_s:.1f}% of the loop (native codec "
                f"{native_rle()}), metrics {secs['_metrics']:.3f} s = "
                f"{100 * secs['_metrics'] / loop_s:.1f}%; launches {counts} [{smi}]")
        log(f"eval_cli: A2D metrics {json.dumps(metrics['eval_cli_a2d'])}")
        worst = max(abs(metrics["eval_cli"][k] - metrics["eval_cli_host"][k]) for k in A2D_KEYS)
        check(worst <= 1e-6, f"eval_cli device vs host postprocess: {metrics}")
        log(f"eval_cli: JHMDB metrics {json.dumps(metrics['eval_cli'])}; device vs host "
            f"postprocess max |diff| {worst:.2e} (limit 1e-6)")

        # one forward with its postprocess, timed on the JHMDB run's model and first batch
        model, loader = kept[1]
        batch = next(iter(loader.epoch(0)))
        sizes = np.asarray(batch["targets"]["size"])
        orig = np.asarray(batch["targets"]["orig_size"])
        bucket = evaluate.output_bucket(orig)

        def fwd_post():
            out = evaluate._forward(model, batch, torch.device("cuda"), True)
            return evaluate.device_postprocess(out["pred_masks"], sizes, orig, bucket)

        dev_ms, host_ms = cuda_times(fwd_post, iters=5)
        packed = fwd_post()
        b, q, obh, obw8 = packed.shape
        canvas_bytes = b * q * batch["samples"].shape[2] * batch["samples"].shape[3] * 4
        log(f"eval_cli: one forward + device postprocess (B={b}, Q={q}, canvas "
            f"{batch['samples'].shape[2]}x{batch['samples'].shape[3]}, bucket {obh}x{obw8 * 8}"
            f"): {dev_ms:.2f} device ms, {host_ms:.2f} host ms to enqueue; mask wire "
            f"{packed.numel()} B packed vs {canvas_bytes} B float32 canvas "
            f"({canvas_bytes / packed.numel():.0f}x) [{smi}]")
        results["eval_cli"] = {"forward_post_ms": dev_ms, "metrics": metrics,
                               "clips_per_s": clips_per_s}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def native_rle() -> bool:
    from ocpg_tpu_torch.evaluation import rle

    return rle._native_io() is not None


# ------------------------------------------------------------ pretrain_cli --
COCO_H, COCO_W, COCO_TRAIN, COCO_VAL = 480, 640, 8, 4


def write_coco_tree(root, datasets=(("refcoco", COCO_TRAIN, COCO_VAL),)):
    """A COCO root of seeded PIL JPEGs (train2014/) with
    instances_<name>_{train,val}.json for each (name, train images, val
    images) of ``datasets`` (no val file for 0): one referred ellipse per
    image, its polygon and box (tests/torch_data_fixtures.py::write_coco_tree's
    schema)."""
    from PIL import Image

    rng = np.random.default_rng(13)
    os.makedirs(os.path.join(root, "train2014"))
    yy, xx = np.mgrid[0:COCO_H, 0:COCO_W]
    for dataset, n_train, n_val in datasets:
        for split, n in (("train", n_train), ("val", n_val)):
            if not n:
                continue
            images, anns = [], []
            for i in range(n):
                name = f"{dataset}_{split}_{i}.jpg"
                cy, cx = rng.uniform(150, 330), rng.uniform(150, 490)
                ry, rx = rng.uniform(60, 120), rng.uniform(60, 140)
                img = 50 + 150 * rng.random((COCO_H, COCO_W, 3))
                obj = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
                img[obj] = 0.4 * img[obj] + [130, 40, 40]
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(root, "train2014", name), quality=90)
                angles = np.linspace(0, 2 * np.pi, 24, endpoint=False)
                poly = np.stack([cx + rx * np.cos(angles), cy + ry * np.sin(angles)], 1)
                images.append({"id": i, "file_name": name, "height": COCO_H, "width": COCO_W,
                               "caption": f"the red {('oval', 'blob')[i % 2]} in the picture"})
                anns.append({"id": i, "image_id": i, "category_id": 1,
                             "bbox": [cx - rx, cy - ry, 2 * rx, 2 * ry],
                             "segmentation": [poly.ravel().tolist()],
                             "area": float(obj.sum()), "iscrowd": 0})
            with open(os.path.join(root, f"instances_{dataset}_{split}.json"), "w") as f:
                json.dump({"images": images, "annotations": anns,
                           "categories": [{"id": 1, "name": "thing"}]}, f)


def phase_pretrain_cli(results):
    """``python -m ocpg_tpu_torch.cli.pretrain`` in this process at full width
    (R101, bf16), ``--num_frames 1``, the default batch of 2, one epoch of a
    seeded RefCOCO tree with its val: K1 and K2 8 per step, K1 8 per val
    forward, every step's loss finite, log.txt's refcoco_{bbox,segm,
    coco_bbox}_* finite, the checkpoint at the last step; steps/s, peak
    memory."""
    from ocpg_tpu_torch.cli import pretrain as pretrain_cli
    from ocpg_tpu_torch.engine.train import TrainStep

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="pretrain_cli_", dir=_build.BUILD_DIR)
    try:
        tree, out = os.path.join(root, "coco"), os.path.join(root, "run")
        t0 = time.perf_counter()
        write_coco_tree(tree)
        log(f"pretrain_cli: RefCOCO tree, {COCO_TRAIN} train and {COCO_VAL} val JPEGs at "
            f"{COCO_H}x{COCO_W}, written in {time.perf_counter() - t0:.1f} s")
        losses = []
        step_call = TrainStep.__call__

        def keep_loss(self, batch):
            metrics = step_call(self, batch)
            losses.append(metrics["loss"])
            return metrics

        TrainStep.__call__ = keep_loss
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_counts()
            t0 = time.perf_counter()
            pretrain_cli.main(["--coco_path", tree, "--num_frames", "1", "--epochs", "1",
                               "--output_dir", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            TrainStep.__call__ = step_call
        counts = read_counts()
        steps, val_batches = COCO_TRAIN // 2, COCO_VAL // 2
        check(counts == counts_of(K1=8 * (steps + val_batches), K2=8 * steps),
              f"pretrain_cli: {steps} steps and {val_batches} val batches launched {counts}")
        results["paths"]["pretrain_cli"] = counts
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"pretrain_cli losses {losses}")
        with open(os.path.join(out, "log.txt")) as f:
            (rec,) = [json.loads(line) for line in f if line.strip()]
        keys = [k for k in rec if k.startswith("refcoco_")]
        for prefix in ("refcoco_bbox_", "refcoco_segm_", "refcoco_coco_bbox_"):
            check(any(k.startswith(prefix) for k in keys), f"pretrain_cli: no {prefix}* in log")
        check(all(math.isfinite(rec[k]) for k in keys) and math.isfinite(rec["loss"]),
              f"pretrain_cli log {rec}")
        latest = CheckpointManager(os.path.join(out, "checkpoints")).latest_step()
        check(latest == steps, f"pretrain_cli latest checkpoint {latest} != {steps}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_step = rec["data_time_s"] + rec["step_time_s"]
        log(f"pretrain_cli: {steps} steps (B=2, T=1, canvas 512x640) and {val_batches} val "
            f"batches in {wall:.1f} s (two model builds and the checkpoint included); "
            f"{1 / per_step:.3f} steps/s over the loop (data_time_s {rec['data_time_s']:.4f}, "
            f"step_time_s {rec['step_time_s']:.4f}); losses {[round(v, 4) for v in losses]}; "
            f"val {json.dumps({k: rec[k] for k in keys[:6]})}; peak memory {peak:.2f} GiB; "
            f"launches {counts} [{smi}]")
        results["pretrain_cli"] = {"steps_per_s": 1 / per_step, "peak_gib": peak}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- infer_davis --
DAVIS_INFER_FRAMES = 36


def phase_infer_davis(results):
    """``python -m ocpg_tpu_torch.cli.infer_davis --backbone video_swin_b_p4w7``
    in this process (davis_videoswin_base at full width, bf16) at the CLI's
    defaults (clip_len 36, exact buckets, f32) on a seeded valid split of
    one video of 36 frames at 720 x 1280 with two objects and eight
    expressions, then ``python -m ocpg_tpu_torch.cli.eval_davis`` on each
    annotator's PNGs: K1 8 per dispatch, K7 24 per backbone run (one: the
    chunk's other seven requests reuse its results), one palette PNG per
    annotator and frame at 720 x 1280, both CSVs, J&F finite.  Requests/s
    and the share of the run outside the engine."""
    from ocpg_tpu_torch.cli import eval_davis as eval_davis_cli
    from ocpg_tpu_torch.cli import infer_davis
    from ocpg_tpu_torch.engine import infer as infer_engine

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="infer_davis_", dir=_build.BUILD_DIR)
    try:
        tree, out = os.path.join(root, "davis"), os.path.join(root, "out")
        t0 = time.perf_counter()
        write_davis_tree(tree, split="valid", frames=DAVIS_INFER_FRAMES, objects=2)
        log(f"infer_davis: Ref-DAVIS valid tree, 1 video of {DAVIS_INFER_FRAMES} frames at "
            f"{CLI_H}x{CLI_W}, 2 objects x 4 annotators, written in "
            f"{time.perf_counter() - t0:.1f} s")
        engines, secs = [], {}
        init = infer_davis.init_engine

        def keep(*args, **kwargs):
            model, engine = init(*args, **kwargs)
            engines.append(engine)
            return model, engine

        infer_davis.init_engine = keep
        try:
            with timed_calls(infer_engine.ClipInferenceEngine, ("run",), secs):
                reset_counts()
                infer_engine.backbone_runs = infer_engine.backbone_reused = 0
                t0 = time.perf_counter()
                infer_davis.main(["--davis_path", tree, "--output_dir", out,
                                  "--backbone", "video_swin_b_p4w7"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            infer_davis.init_engine = init
        counts = read_counts()
        (engine,) = engines
        dispatches = engine.n_batches
        check(dispatches == 8, f"infer_davis: {dispatches} dispatches, want 8 (2 x 4 x 1 chunk)")
        runs = infer_engine.backbone_runs
        check(runs == 1 and infer_engine.backbone_reused == 7,
              f"infer_davis: {runs} backbone runs and {infer_engine.backbone_reused} reused, "
              "want 1 and 7")
        check(counts == counts_of(K1=8 * dispatches, K7=SWIN_B_BLOCKS * runs),
              f"infer_davis: {dispatches} dispatches launched {counts}")
        results["paths"]["infer_davis"] = counts
        from PIL import Image

        names = [f"{i:05d}" for i in range(DAVIS_INFER_FRAMES)]
        fg = 0
        for a in range(4):
            for name in names:
                img = Image.open(os.path.join(out, "valid", f"anno_{a}", "vid0", f"{name}.png"))
                check(img.mode == "P" and img.size == (CLI_W, CLI_H),
                      f"infer_davis PNG {img.mode} {img.size}")
                fg += int((np.asarray(img) > 0).sum())
        jf = []
        t0 = time.perf_counter()
        for a in range(4):
            res = os.path.join(out, "valid", f"anno_{a}")
            summary = eval_davis_cli.main(["--davis_path", os.path.join(tree, "valid"),
                                           "--results_path", res])
            for csv in ("global_results-val.csv", "per-sequence_results-val.csv"):
                check(os.path.exists(os.path.join(res, csv)), f"eval_davis wrote no {csv}")
            check(math.isfinite(summary["J&F-Mean"]), f"eval_davis {summary}")
            jf.append(summary["J&F-Mean"])
        score_s = time.perf_counter() - t0
        engine_s = secs["run"]
        log(f"infer_davis: 8 requests of {DAVIS_INFER_FRAMES} frames in {wall:.2f} s = "
            f"{8 / wall:.3f} requests/s ({8 * DAVIS_INFER_FRAMES / wall:.2f} frames/s; model "
            f"build included); in the engine {engine_s:.2f} s, outside it (build, decode, "
            f"resize, merge, PNGs) {wall - engine_s:.2f} s = "
            f"{100 * (wall - engine_s) / wall:.1f}%; {engine.canvas_count} canvas; "
            f"{fg} foreground label pixels; launches {counts} [{smi}]")
        log(f"infer_davis: eval_davis J&F per annotator {[round(x, 4) for x in jf]} in "
            f"{score_s:.2f} s (4 x {DAVIS_INFER_FRAMES} frames at {CLI_H}x{CLI_W})")
        results["infer_davis"] = {"requests_per_s": 8 / wall, "jf": jf}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- infer_ytvos --
# the valid split of phase infer_ytvos: a 12-frame video (longer than the
# 3-frame clip) and a 4-frame one of a moving blob, and "vidX", two 3-frame
# chunks of unlike scenes chosen by a probe so that the two chunks' own
# best queries differ: global query selection must run one of them again
YTVOS_CLIP, YTVOS_VIDEOS = 3, (("vidL", 12), ("vidS", 4))
YTVOS_MIXED = "vidX"
# the probe's scenes, one 3-frame chunk each
YTVOS_SCENES = ("blob", "dark", "noise", "stripes", "gradient", "checker")


def ytvos_blob_frames(rng, n, v):
    yy, xx = np.mgrid[0:CLI_H, 0:CLI_W]
    frames = []
    for k in range(n):
        obj = (((yy - 300 - 8 * k) / 150.0) ** 2
               + ((xx - 400 - 40 * k - 200 * v) / 220.0) ** 2) <= 1
        img = 40 + 160 * rng.random((CLI_H, CLI_W, 3))
        img[obj] = 0.4 * img[obj] + [20, 130, 40]
        frames.append(img.astype(np.uint8))
    return frames


def ytvos_blob_videos():
    """The seeded blob videos YTVOS_VIDEOS, name -> frames."""
    rng = np.random.default_rng(17)
    return {name: ytvos_blob_frames(rng, n, v) for v, (name, n) in enumerate(YTVOS_VIDEOS)}


def ytvos_scene_frames(scene, rng):
    """YTVOS_CLIP frames of one of YTVOS_SCENES, seeded."""
    if scene == "blob":
        return ytvos_blob_frames(rng, YTVOS_CLIP, 0)
    yy, xx = np.mgrid[0:CLI_H, 0:CLI_W]
    frames = []
    for k in range(YTVOS_CLIP):
        if scene == "dark":
            img = np.zeros((CLI_H, CLI_W, 3))
            img[200 + 10 * k:500 + 10 * k, 300:900] = 250
        elif scene == "noise":
            img = 255 * rng.random((CLI_H, CLI_W, 3))
        elif scene == "stripes":
            img = np.where(((xx + 20 * k) // 40 % 2)[..., None] == 1, [230, 30, 30], [30, 30, 230])
        elif scene == "gradient":
            img = np.stack([xx / CLI_W * 255, yy / CLI_H * 255,
                            np.full((CLI_H, CLI_W), 40.0 * k)], -1)
        else:
            img = np.where(((xx // 80 + yy // 80 + k) % 2)[..., None] == 1, 255, 0) * [1, 1, 0.5]
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def write_ytvos_valid(root, videos):
    """A Ref-YTVOS valid split of the given videos (name -> frames) as
    JPEGs, frame i named 5 i, two expressions each."""
    from PIL import Image

    meta = {"videos": {}}
    for video, frames in videos.items():
        d = os.path.join(root, "valid", "JPEGImages", video)
        os.makedirs(d)
        names = [f"{5 * i:05d}" for i in range(len(frames))]
        for name, img in zip(names, frames):
            Image.fromarray(img).save(os.path.join(d, f"{name}.jpg"), quality=90)
        meta["videos"][video] = {"frames": names, "expressions": {
            "0": {"exp": "the green blob moving right"}, "1": {"exp": "the background"}}}
    os.makedirs(os.path.join(root, "meta_expressions", "valid"))
    with open(os.path.join(root, "meta_expressions", "valid", "meta_expressions.json"),
              "w") as f:
        json.dump(meta, f)


def phase_infer_ytvos(results):
    """``python -m ocpg_tpu_torch.cli.infer_ytvos`` in this process
    (ytvos_r101_boxsup at full width, bf16) on a seeded valid split, chunked
    (--clip_len 3, --query_select global) and whole-video (--clip_len 0):
    K1 8 per dispatch, one query per expression after the re-run, at least
    one chunk run again (video vidX, whose two chunks a probe run picked
    from unlike scenes with different best queries), each re-run chunk's
    mask logits those of a direct dispatch of its request with the query
    forced, every Annotations/<video>/<exp>/<frame>.png of both runs at 720
    x 1280, the two runs' masks agreeing on at least 99% of pixels (the
    share recorded)."""
    from ocpg_tpu_torch.cli import infer_davis, infer_ytvos

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="infer_ytvos_", dir=_build.BUILD_DIR)
    try:
        engines, picks = [], []
        init, select = infer_davis.init_engine, infer_ytvos.select_global_queries

        def keep(*args, **kwargs):
            """init_engine, its engine kept and every run's requests and
            results recorded."""
            model, engine = init(*args, **kwargs)
            engine.calls, run = [], engine.run

            def recorded(requests):
                out = run(requests)
                engine.calls.append((list(requests), out))
                return out

            engine.run = recorded
            engines.append(engine)
            return model, engine

        def keep_select(engine, requests, meta):
            scores = list(engine.last_query_scores)
            redo = select(engine, requests, meta)
            picks.append((scores, [r.query_override for r in requests], meta, redo))
            return redo

        def infer(tree, out, clip_len):
            return infer_ytvos.main(["--ytvos_path", tree, "--output_dir", out,
                                     "--clip_len", str(clip_len)])

        infer_ytvos.init_engine, infer_ytvos.select_global_queries = keep, keep_select
        try:
            # the probe: each scene as a one-chunk video; each (scene,
            # expression)'s best query and its margin over the second best
            rng = np.random.default_rng(17)
            scenes = {s: ytvos_scene_frames(s, rng) for s in YTVOS_SCENES}
            probe = os.path.join(root, "probe")
            write_ytvos_valid(probe, scenes)
            infer(probe, os.path.join(root, "probe_out"), YTVOS_CLIP)
            best = {}
            for scene, (scores, _, meta, _) in zip(YTVOS_SCENES, picks):   # one per video
                for k, (exp_id, _) in enumerate(meta):
                    per_query = scores[k].max(-1)
                    top2 = np.sort(per_query)[-2:]
                    best[(scene, exp_id)] = (int(per_query.argmax()), float(top2[1] - top2[0]))
            picks.clear()
            pairs = [(min(best[(a, e)][1], best[(b, e)][1]), a, b, e)
                     for e in ("0", "1") for i, a in enumerate(YTVOS_SCENES)
                     for b in YTVOS_SCENES[i + 1:] if best[(a, e)][0] != best[(b, e)][0]]
            check(pairs, f"infer_ytvos: every probe scene has the same best query {best}")
            margin, first, second, exp_mixed = max(pairs)
            log(f"infer_ytvos: probe best (query, margin) per scene and expression {best}; "
                f"vidX = {first} + {second} (expression {exp_mixed}, margin {margin:.3g})")

            videos = ytvos_blob_videos()
            videos[YTVOS_MIXED] = scenes[first] + scenes[second]
            tree = os.path.join(root, "ytvos")
            write_ytvos_valid(tree, videos)
            outs, runs = {}, {}
            for name, clip_len in (("chunked", YTVOS_CLIP), ("whole", 0)):
                outs[name] = os.path.join(root, name)
                reset_counts()
                t0 = time.perf_counter()
                runs[name] = infer(tree, outs[name], clip_len)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counts()
                dispatches = engines[-1].n_batches
                check(counts == counts_of(K1=8 * dispatches),
                      f"infer_ytvos {name}: {dispatches} dispatches launched {counts}")
                results["paths"][f"infer_ytvos_{name}"] = counts
                log(f"infer_ytvos: {name} (clip_len {clip_len or 'whole video'}): "
                    f"{runs[name]['requests']} requests, {runs[name]['rerun']} chunks run "
                    f"again, {dispatches} dispatches in {wall:.2f} s, launches {counts} [{smi}]")
        finally:
            infer_ytvos.init_engine, infer_ytvos.select_global_queries = init, select
        # one query per expression: a chunk's own argmax, or the forced one
        for scores, overrides, meta, _ in picks:
            chosen = {}
            for k, (exp_id, _) in enumerate(meta):
                q = overrides[k] if overrides[k] >= 0 else int(scores[k].max(-1).argmax())
                chosen.setdefault(exp_id, set()).add(q)
            check(all(len(v) == 1 for v in chosen.values()),
                  f"infer_ytvos: an expression's chunks use queries {chosen}")
        rerun = runs["chunked"]["rerun"]
        check(rerun >= 1, "infer_ytvos: global query selection ran no chunk again")
        # each re-run chunk against a direct dispatch of its request
        from ocpg_tpu_torch.engine.infer import InferRequest

        chunked = engines[-2]
        forced = [(r, out) for requests, outs_ in chunked.calls
                  for r, out in zip(requests, outs_) if r.query_override >= 0]
        check(len(forced) == rerun, f"infer_ytvos: {len(forced)} forced requests, {rerun} re-runs")
        worst = 0.0
        for r, got in forced:
            [want] = chunked.run([InferRequest(r.frames, r.text_ids, r.text_mask,
                                               query_override=r.query_override)])
            scale = max(float(np.abs(want).max()), 1e-6)
            worst = max(worst, float(np.abs(got - want).max()) / scale)
            differ = ((got > 0) != (want > 0)) & (np.abs(want) > 1e-3)
            check(got.shape == want.shape and not differ.any(),
                  f"infer_ytvos: a re-run chunk's masks differ from a direct dispatch with "
                  f"query {r.query_override} in {int(differ.sum())} pixels")
        log(f"infer_ytvos: {rerun} chunk(s) run again with the global query; their mask "
            f"logits within {worst:.2e} of scale of a direct query_override dispatch, masks "
            f"equal")
        from PIL import Image

        same = total = 0
        for video, frames in videos.items():
            for exp_id in ("0", "1"):
                for i in range(len(frames)):
                    masks = [np.asarray(Image.open(os.path.join(
                        outs[r], "Annotations", video, exp_id, f"{5 * i:05d}.png")))
                        for r in ("chunked", "whole")]
                    for m in masks:
                        check(m.shape == (CLI_H, CLI_W) and set(np.unique(m)) <= {0, 255},
                              f"infer_ytvos PNG {m.shape} {np.unique(m)}")
                    same += int((masks[0] == masks[1]).sum())
                    total += masks[0].size
        check(same / total >= 0.99, f"infer_ytvos: chunked and whole-video masks agree "
                                    f"on {same / total:.4f} of pixels (< 0.99)")
        log(f"infer_ytvos: chunked (global query) and whole-video masks agree on "
            f"{100 * same / total:.3f}% of {total} pixels")
        results["infer_ytvos"] = {"agreement": same / total, "rerun": rerun,
                                  "rerun_vs_direct": worst}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def same_tree(label, got, want):
    """Tensors equal in type and bits, other leaves equal, keys equal."""
    if isinstance(want, torch.Tensor):
        check(isinstance(got, torch.Tensor) and got.dtype == want.dtype
              and torch.equal(got.cpu(), want.cpu()), f"{label}: tensors differ")
    elif isinstance(want, dict):
        check(isinstance(got, dict) and got.keys() == want.keys(), f"{label}: keys differ")
        for k in want:
            same_tree(f"{label}/{k}", got[k], want[k])
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{label}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            same_tree(f"{label}/{i}", g, w)
    else:
        check(got == want, f"{label}: {got!r} != {want!r}")


# -------------------------------------------------------------- pretrained --
# the toy RoBERTa vocabulary of phase pretrained (and of the tokenizer's CPU
# test): the special tokens, the 256 byte-level symbols and a few merges;
# the ids and masks its tokenizer gives TOY_CAPTIONS at TOY_MAX_LEN, which
# JAX's tokenizer gives too (tests/test_torch_pretrained.py)
TOY_MERGES = (("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("Ġ", "r"), ("Ġr", "e"), ("Ġre", "d"),
              ("i", "n"), ("Ġ", "b"), ("l", "o"), ("Ġb", "lo"), ("Ġblo", "b"))
TOY_VOCAB_SIZE = 4 + 256 + len(TOY_MERGES) + 1
TOY_CAPTIONS = ("the red blob moving to the right", "The blob in the water, left!", "a é")
TOY_MAX_LEN = 12
TOY_IDS = ((0, 87, 261, 265, 270, 224, 80, 82, 89, 266, 74, 2),
           (0, 55, 261, 270, 224, 266, 262, 224, 90, 68, 87, 2),
           (0, 68, 224, 131, 106, 2, 1, 1, 1, 1, 1, 1))
TOY_MASK = ((1,) * 12, (1,) * 12, (1,) * 6 + (0,) * 6)


def byte_symbols():
    """The 256 symbols of byte-level BPE (GPT-2's bytes_to_unicode), in byte order
    of the printable bytes first."""
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    others = [b for b in range(256) if b not in printable]
    return [chr(b) for b in printable] + [chr(256 + n) for n in range(len(others))]


def write_toy_vocab(directory):
    """The toy vocabulary as a RoBERTa checkpoint holds its tokenizer:
    vocab.json, merges.txt and the ``tokenizers`` library's tokenizer.json
    (byte-level BPE, RoBERTa's <s> ... </s> post-processor, the special
    tokens), in ``directory``."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers, processors

    tokens = (["<s>", "<pad>", "</s>", "<unk>"] + byte_symbols()
              + [a + b for a, b in TOY_MERGES] + ["<mask>"])
    vocab = {t: i for i, t in enumerate(tokens)}
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in TOY_MERGES))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=list(TOY_MERGES)))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 0))
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens([AddedToken(t, special=True) for t in ("<s>", "<pad>", "</s>", "<unk>")]
                           + [AddedToken("<mask>", lstrip=True, special=True)])
    tok.save(os.path.join(directory, "tokenizer.json"))


def torch_replica():
    """tests/torch_replica.py, imported from its file: a ``tests`` package
    installed in site-packages would shadow the repo's ``tests`` directory,
    which has no ``__init__.py``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_replica.py")
    spec = importlib.util.spec_from_file_location("torch_replica", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def full_width_replica(cfg, seed):
    """tests/torch_replica.py's OCPGReplica (the reference checkpoint's key
    layout) at ``cfg``'s widths with ResNet-101, on the CPU: PyTorch's and
    transformers' default init under ``seed``, then seeded FrozenBN
    statistics and affine terms."""
    from transformers import RobertaConfig

    replica_module = torch_replica()
    FrozenBN2d, OCPGReplica = replica_module.FrozenBN2d, replica_module.OCPGReplica
    text = RobertaConfig(vocab_size=cfg.text_vocab, hidden_size=cfg.text_hidden,
                         num_hidden_layers=cfg.text_layers, num_attention_heads=cfg.text_heads,
                         intermediate_size=cfg.text_ffn, max_position_embeddings=cfg.text_max_pos,
                         type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5)
    torch.manual_seed(seed)
    replica = OCPGReplica(text, resnet_layers=(3, 4, 23, 3), hidden=cfg.hidden_dim,
                          heads=cfg.nheads, enc=cfg.enc_layers, dec=cfg.dec_layers,
                          ffn=cfg.dim_feedforward, levels=cfg.num_feature_levels,
                          points=cfg.dec_n_points, queries=cfg.num_queries,
                          mask_ch=cfg.dynamic_mask_channels).eval()
    g = torch.Generator().manual_seed(seed + 1)
    for mod in replica.modules():
        if isinstance(mod, FrozenBN2d):
            n = mod.weight.numel()
            mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
            mod.bias.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return replica


def phase_pretrained(results):
    """A reference-layout checkpoint at full width through every loader:
    (a) ``load_pretrained_torch`` into the float32 ytvos_r101_boxsup model on
    the card, its eval forward (K1) against the replica's own forward on
    the card (grid_sample MSDA), TF32 off; (b) ``cli.tools
    convert_checkpoint``, then ``cli.infer_ytvos`` with ``--checkpoint``
    the .pth and the directory (and ``--tokenizer_path`` the toy
    vocabulary): identical PNGs; (c) two steps of ``cli.train
    --pretrained_weights``: before the first, the class heads are the
    model's init and every other tensor is the checkpoint's; (d) the toy
    vocabulary's ids on this machine's transformers."""
    import transformers

    from ocpg_tpu_torch.cli import infer_ytvos, tools
    from ocpg_tpu_torch.cli import train as train_cli
    from ocpg_tpu_torch.engine import train as engine_train
    from ocpg_tpu_torch.engine.checkpoint import load_pretrained_torch
    from ocpg_tpu_torch.utils.torch_weights import convert_ocpg, load_torch_file
    from ocpg_tpu_torch.utils.weights import jax_to_state_dict

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="pretrained_", dir=_build.BUILD_DIR)
    try:
        cfg = ytvos_r101_boxsup().replace(compute_dtype="float32")
        t0 = time.perf_counter()
        replica = full_width_replica(cfg, seed=0)
        pth = os.path.join(root, "ocpg_r101.pth")
        torch.save({"model": replica.state_dict()}, pth)
        log(f"pretrained: replica ({sum(t.numel() for t in replica.state_dict().values()) / 1e6:.1f}"
            f"M values) built and saved in {time.perf_counter() - t0:.1f} s")

        # (a) the loader and the converted forward
        t0 = time.perf_counter()
        sd = load_torch_file(pth)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, frozen = convert_ocpg(sd, backbone="resnet101")
        convert_s = time.perf_counter() - t0
        want = jax_to_state_dict({"params": params, "frozen": frozen})
        model = build_model(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_pretrained_torch(model, pth, cfg, drop_class_heads=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        state = model.state_dict()
        check(loaded == sorted(state), f"pretrained: {len(state) - len(loaded)} tensors not "
                                       "loaded")
        differ = [k for k in state if not torch.equal(state[k].cpu(),
                                                      torch.from_numpy(want[k]))]
        check(not differ, f"pretrained: tensors unlike the checkpoint's: {differ[:5]}")
        log(f"pretrained: load_pretrained_torch {load_s:.2f} s ({len(loaded)} tensors, every "
            f"one the checkpoint's; torch.load {read_s:.2f} s, convert_ocpg {convert_s:.2f} s "
            f"on the host) [{smi}]")

        batch = synthetic_batch(np.random.default_rng(5), batch=1, frames=5, height=384,
                                width=640, vocab_size=cfg.text_vocab)
        # padding on the right and at the bottom, and in the caption
        batch["samples_mask"][..., -64:] = True
        batch["samples_mask"][..., -32:, :] = True
        batch["targets"]["size"][:] = (384 - 32, 640 - 64)
        batch["text_ids"][:, -4:], batch["text_mask"][:, -4:] = 1, 0
        args = [torch.from_numpy(batch[k]).cuda() for k in
                ("samples", "samples_mask", "text_ids", "text_mask")]
        args.append(torch.from_numpy(batch["targets"]["size"]).cuda())
        rargs = (args[0].permute(0, 1, 4, 2, 3).contiguous(), args[1], args[2].long(),
                 args[3].long(), args[4])
        with no_tf32(), torch.no_grad():
            reset_counts()
            got = model(*args)
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts == counts_of(K1=8), f"pretrained: one forward launched {counts}")
            results["paths"]["pretrained"] = counts
            fwd_ms, fwd_host_ms = cuda_times(lambda: model(*args), iters=5)
            replica.to("cuda")
            with torch.device("cuda"):     # the replica makes its tensors on the host
                ref = replica(*rargs)
            torch.cuda.synchronize()
        del replica
        check(all(bool(torch.isfinite(got[k]).all()) for k in got),
              "pretrained: the converted forward is not finite")
        for k in ("pred_logits", "pred_boxes", "reference_points"):
            err = (got[k] - ref[k]).abs().max().item()
            check(err <= 2e-3, f"pretrained {k}: port vs replica {err} > 2e-3")
            log(f"pretrained {k}: max |port - replica| {err:.2e} (limit 2e-3)")
        scale = max(ref["pred_masks"].abs().max().item(), 1e-3)
        err = (got["pred_masks"] - ref["pred_masks"]).abs().max().item() / scale
        check(err <= 5e-3, f"pretrained pred_masks: port vs replica {err} > 5e-3 (scaled)")
        log(f"pretrained pred_masks: max |port - replica| / max |mask| {err:.2e} (limit "
            f"5e-3); converted float32 forward 1x5x384x640 {fwd_ms:.2f} device ms "
            f"({fwd_host_ms:.2f} host ms to enqueue), launches {counts} [{smi}]")
        del model, got, ref
        gc.collect()
        torch.cuda.empty_cache()

        # (b) convert_checkpoint, then infer_ytvos from the file and the directory
        vocab = os.path.join(root, "vocab")
        os.makedirs(vocab)
        write_toy_vocab(vocab)
        ckdir = os.path.join(root, "converted")
        t0 = time.perf_counter()
        tools.main(["convert_checkpoint", "--source", pth, "--output", ckdir,
                    "--backbone", "resnet101"])
        tool_s = time.perf_counter() - t0
        tree = os.path.join(root, "ytvos")
        write_ytvos_valid(tree, ytvos_blob_videos())
        pngs = {}
        for name, ckpt in (("pth", pth), ("dir", ckdir)):
            out = os.path.join(root, f"infer_{name}")
            reset_counts()
            runs = infer_ytvos.main(["--ytvos_path", tree, "--output_dir", out,
                                     "--checkpoint", ckpt, "--tokenizer_path", vocab])
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts["K1"] > 0 and counts["K1"] % 8 == 0
                  and counts == counts_of(K1=counts["K1"]),
                  f"pretrained infer_ytvos --checkpoint {name} launched {counts}")
            results["paths"][f"pretrained_infer_{name}"] = counts
            pngs[name] = {os.path.relpath(os.path.join(d, f), out): open(os.path.join(d, f),
                                                                         "rb").read()
                          for d, _, files in os.walk(out) for f in files if f.endswith(".png")}
        check(pngs["pth"] and pngs["pth"] == pngs["dir"],
              f"pretrained: infer_ytvos PNGs from the .pth and the converted directory differ "
              f"({len(pngs['pth'])} and {len(pngs['dir'])} files)")
        log(f"pretrained: cli.tools convert_checkpoint {tool_s:.1f} s (model build, load and "
            f"save); infer_ytvos from the .pth and from the directory wrote the same "
            f"{len(pngs['pth'])} PNGs, launches {results['paths']['pretrained_infer_pth']}")

        # (c) two steps of the train CLI from --pretrained_weights
        davis = os.path.join(root, "davis")
        write_davis_tree(davis, frames=2)
        argv = ["--dataset_file", "davis", "--davis_path", davis, "--backbone", "resnet101",
                "--supervision", "box", "--num_frames", "3", "--batch_size", "1", "--epochs",
                "1", "--output_dir", os.path.join(root, "train"), "--log_every", "1",
                "--tb_every", "0", "--pretrained_weights", pth, "--tokenizer_path", vocab]
        first = {}
        step_call = engine_train.TrainStep.__call__

        def keep_first(self, batch):
            if not first:
                first.update({k: v.detach().cpu().clone()
                              for k, v in self.model.state_dict().items()})
            return step_call(self, batch)

        engine_train.TrainStep.__call__ = keep_first
        try:
            reset_counts()
            t0 = time.perf_counter()
            train_cli.main(argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            engine_train.TrainStep.__call__ = step_call
        counts = read_counts()
        args = train_cli.get_args(argv)
        steps = len(train_cli.make_dataset(args, train_cli.make_config(args)))
        check(steps == 2 and counts == counts_of(K1=16, K2=16),
              f"pretrained train_cli: {steps} steps launched {counts} (want 2 steps, K1 and "
              f"K2 8 per step)")
        results["paths"]["pretrained_train"] = counts
        heads = [k for k in first if k.startswith("class_embed_")]
        check(heads and all(not torch.equal(first[k], torch.from_numpy(want[k]))
                            for k in heads),
              "pretrained train_cli: a class head holds the checkpoint's value")
        differ = [k for k in first if k not in heads
                  and not torch.equal(first[k], torch.from_numpy(want[k]))]
        check(not differ, f"pretrained train_cli: tensors unlike the checkpoint's before the "
                          f"first step: {differ[:5]}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"pretrained: train_cli --pretrained_weights, {steps} steps in {train_s:.1f} s "
            f"(model build, load, loader and checkpoint included), launches {counts}; before "
            f"the first step {len(heads)} class-head tensors at their init, the other "
            f"{len(first) - len(heads)} the checkpoint's [{smi}]")

        # (d) the toy vocabulary on this machine's transformers
        tokenizer = SimpleTokenizer(vocab, max_len=TOY_MAX_LEN)
        ids, mask = tokenizer(list(TOY_CAPTIONS))
        check(ids.dtype == mask.dtype == np.int32
              and ids.tolist() == [list(r) for r in TOY_IDS]
              and mask.tolist() == [list(r) for r in TOY_MASK],
              f"pretrained: transformers {transformers.__version__} tokenizes the toy "
              f"vocabulary as {ids.tolist()} {mask.tolist()}")
        log(f"pretrained: transformers {transformers.__version__} "
            f"{type(tokenizer._hf).__name__} on the toy vocabulary gives the constant ids "
            f"and masks; peak memory {peak:.2f} GiB")
        if type(tokenizer._hf) is not transformers.RobertaTokenizerFast:
            # why models/text_encoder.py does not call RobertaTokenizerFast here
            fast = transformers.RobertaTokenizerFast.from_pretrained(vocab)
            fast_ids = fast(list(TOY_CAPTIONS), padding="max_length", truncation=True,
                            max_length=TOY_MAX_LEN)["input_ids"]
            log(f"pretrained: RobertaTokenizerFast.from_pretrained on the same directory gives "
                f"{'the same' if fast_ids == ids.tolist() else 'other'} ids: {fast_ids}")
        results["pretrained"] = {"load_s": load_s, "convert_s": convert_s,
                                 "forward_ms": fwd_ms, "tool_s": tool_s, "peak_gib": peak}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------- pseudo_labels --
PSEUDO_H, PSEUDO_W = 320, 576


def pseudo_label_frame(rng):
    """A seeded 320 x 576 RGB frame (A2D's clips320H height) with two
    objects, and their 3 instance masks, the last one empty."""
    yy, xx = np.mgrid[0:PSEUDO_H, 0:PSEUDO_W]
    img = 60 + 120 * np.kron(rng.random((PSEUDO_H // 16, PSEUDO_W // 16, 3)),
                             np.ones((16, 16, 1)))
    masks = np.zeros((3, PSEUDO_H, PSEUDO_W), np.float32)
    masks[0] = ((yy - 150) / 90.0) ** 2 + ((xx - 180) / 120.0) ** 2 <= 1
    masks[1, 40:140, 360:540] = 1
    img[masks[0] > 0] = 0.4 * img[masks[0] > 0] + [140, 30, 30]
    img[masks[1] > 0] = 0.4 * img[masks[1] > 0] + [30, 30, 140]
    img += 20 * rng.random(img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), masks


def densecl_checkpoint(path, calibrated=False):
    """tests/torch_replica.py's ResNet-101 body (torchvision names), seeded,
    saved as a DenseCL checkpoint.  Its frozen BatchNorm statistics are
    seeded noise, or (``calibrated``) each layer's own input statistics on
    one seeded 320 x 568 noise frame, as a trained network's are: the
    random body's layer4 features are then no longer near-parallel, and
    the sim model's similarity maps peak around their query point instead
    of lying flat at about 0.02."""
    replica_module = torch_replica()
    torch.manual_seed(1)
    body = replica_module.ResNetBody((3, 4, 23, 3))
    bns = [m for m in body.modules() if isinstance(m, replica_module.FrozenBN2d)]
    if calibrated:
        def measure(mod, inputs):
            mod.running_mean.copy_(inputs[0].mean((0, 2, 3)))
            mod.running_var.copy_(inputs[0].var((0, 2, 3)))

        hooks = [m.register_forward_pre_hook(measure) for m in bns]
        img = np.random.default_rng(21).random((A2D_H, A2D_W, 3)).astype(np.float32)
        x = torch.from_numpy(((img - IMAGENET_MEAN) / IMAGENET_STD).transpose(2, 0, 1)[None]
                             .astype(np.float32))
        with torch.no_grad():
            body(x)
        for h in hooks:
            h.remove()
    else:
        g = torch.Generator().manual_seed(2)
        for mod in bns:
            n = mod.weight.numel()
            mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
    torch.save({"state_dict": body.state_dict()}, path)


def phase_pseudo_labels(results):
    """The generator's --densecl path at full width: the replica's
    ResNet-101 body (torchvision names) through ``convert_resnet`` into the
    sim model on the card and on the CPU; ``generate_for_frame`` on a
    seeded 320 x 576 frame with 3 instances (one empty), without and with
    the CRF: centres equal, heat maps within 1e-3, each bbox choice the
    CPU's or a tie within 1e-5 (TF32 off on the card).  Then OCPG's own data
    path on the card (``pseudo_label_chain``): ``generate_anno.main`` for
    Ref-YTVOS and A2D, its h5 files read back, 2 train steps on them."""
    from ocpg_tpu_torch.preprocess import generate_anno, sim_model
    from ocpg_tpu_torch.utils.torch_weights import load_torch_file

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="pseudo_", dir=_build.BUILD_DIR)
    try:
        pth = os.path.join(root, "densecl_r101.pth")
        densecl_checkpoint(pth)
        models = {}
        for dev in ("cuda", "cpu"):
            models[dev] = sim_model.init_sim_model(device=dev)
            sim_model.load_resnet_weights(models[dev], load_torch_file(pth))
        img, masks = pseudo_label_frame(np.random.default_rng(9))
        generate_anno.generate_for_frame(models["cuda"], img, masks)     # cuDNN warm-up
        reset_counts()
        outs, secs = {}, {}
        for crf in (False, True):
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                outs[dev, crf] = generate_anno.generate_for_frame(models[dev], img, masks, crf)
                torch.cuda.synchronize()
                secs[dev, crf] = time.perf_counter() - t0
        counts = read_counts()
        check(counts == counts_of(), f"pseudo_labels launched {counts}")
        results["paths"]["pseudo_labels"] = counts

        x = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        image = {dev: torch.from_numpy(x.transpose(2, 0, 1)[None].copy()).to(dev)
                 for dev in models}
        keys = {dev: sim_model.image_keys(models[dev], image[dev]) for dev in models}
        choices = []
        for n, m in enumerate(masks):
            if not m.any():
                continue
            ys, xs = np.where(m > 0)
            box = (float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max()))
            (_, sg), (_, sc) = (sim_model.bbox_scores(keys[d], box, img.shape[:2])
                                for d in ("cuda", "cpu"))
            sg = sg.cpu()
            ig, ic = int(sg.argmax()), int(sc.argmax())
            check(abs(float(sg[ic]) - float(sc[ic])) <= 1e-5
                  and abs(float(sg[ig]) - float(sc[ic])) <= 1e-5,
                  f"pseudo_labels instance {n}: bbox scores card {float(sg[ig])} (query {ig}) "
                  f"cpu {float(sc[ic])} (query {ic})")
            choices.append((n, ig, ic))
        for crf in (False, True):
            (hb_g, hp_g, cp_g), (hb_c, hp_c, cp_c) = outs["cuda", crf], outs["cpu", crf]
            check(np.array_equal(cp_g, cp_c), f"pseudo_labels centres {cp_g} != {cp_c}")
            check(float(np.abs(hp_g - hp_c).max()) <= 1e-3,
                  f"pseudo_labels crf={crf} heatPoint: card vs cpu "
                  f"{float(np.abs(hp_g - hp_c).max())} > 1e-3")
            for n, ig, ic in choices:
                if ig == ic:
                    err = float(np.abs(hb_g[n] - hb_c[n]).max())
                    check(err <= 1e-3, f"pseudo_labels crf={crf} heatBBox {n}: card vs cpu "
                                       f"{err} > 1e-3")
            log(f"pseudo_labels crf={crf}: heatPoint max |card - cpu| "
                f"{float(np.abs(hp_g - hp_c).max()):.2e}, heatBBox "
                f"{max(float(np.abs(hb_g[n] - hb_c[n]).max()) for n, _, _ in choices):.2e} "
                f"(limit 1e-3), centres {cp_g.tolist()} equal; frame {secs['cuda', crf]:.2f} s "
                f"with the model on the card, {secs['cpu', crf]:.2f} s on the host [{smi}]")
        check(all(not out[k][2].any() for out in outs.values() for k in (0, 1)),
              "pseudo_labels: the empty instance's maps are not zero")
        keys_ms, _ = cuda_times(lambda: sim_model.image_keys(models["cuda"], image["cuda"]),
                                iters=10)
        log(f"pseudo_labels: bbox query choices (instance, card, cpu) {choices}; sim model "
            f"layer4 keys 1x3x{PSEUDO_H}x{PSEUDO_W} {keys_ms:.2f} device ms (float32, TF32 "
            f"off) [{smi}]")
        results["pseudo_labels"] = {"frame_s": secs["cuda", False],
                                    "frame_crf_s": secs["cuda", True], "keys_ms": keys_ms,
                                    **pseudo_label_chain(results, root, pth, models["cuda"], smi)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the Ref-YTVOS tree generate_anno.main labels and cli.train takes 2 steps
# on: 2 videos of one 720 x 1280 frame each (one clip a video); the
# one-video A2D tree: 8 frames at 320 x 568, the middle one annotated
PSEUDO_VIDEOS, PSEUDO_A2D_FRAMES = 2, 8


def pseudo_label_chain(results, root, pth, model, smi):
    """OCPG's own data path on the card: ``generate_anno.main`` (the sim
    model from ``pth`` on the card) writes the Ref-YTVOS pseudo-labels, read
    back by ``data/h5.py`` equal bit for bit to ``generate_for_frame`` with
    ``model`` (the same weights); ``cli.train`` takes 2 full-width steps on
    them; ``--dataset a2d`` rewrites a one-video A2D annotation file in
    place.  Returns seconds per frame of each ``main`` run."""
    import cv2

    from ocpg_tpu_torch.cli import train as train_cli
    from ocpg_tpu_torch.data.h5 import read_datasets
    from ocpg_tpu_torch.data.imageio import read_palette, read_rgb
    from ocpg_tpu_torch.preprocess import generate_anno
    from ocpg_tpu_torch.scripts.bench_loader import build_tree

    out = {}
    # (a) Ref-YTVOS: frames, masks and expressions without heat maps, then main
    tree = os.path.join(root, "ytvos")
    t0 = time.perf_counter()
    build_tree(tree, PSEUDO_VIDEOS, 1, CLI_H, CLI_W, dataset="davis")
    tree_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    generate_anno.main(["--dataset", "ytvos", "--root", tree, "--densecl", pth])
    torch.cuda.synchronize()
    out["main_ytvos_frame_s"] = (time.perf_counter() - t0) / PSEUDO_VIDEOS
    counts = read_counts()
    check(counts == counts_of(), f"pseudo_labels main ytvos launched {counts}")
    results["paths"]["pseudo_labels_main_ytvos"] = counts
    train_dir = os.path.join(tree, "train")
    for v in range(PSEUDO_VIDEOS):
        got = read_datasets(os.path.join(train_dir, "AnnotationsWeakly", f"vid{v}", "00000.h5"))
        pal = read_palette(os.path.join(train_dir, "Annotations", f"vid{v}", "00000.png"))
        img = read_rgb(os.path.join(train_dir, "JPEGImages", f"vid{v}", "00000.jpg"))
        obj_ids = [int(o) for o in np.unique(pal) if o != 0]
        want = dict(zip(("heatBBox", "heatPoint", "centerPoint"), generate_anno.generate_for_frame(
            model, img, np.stack([(pal == o).astype(np.float32) for o in obj_ids]))))
        want["obj_ids"] = np.asarray(obj_ids)
        check(sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            and np.array_equal(got[k], want[k]) for k in want),
              f"pseudo_labels: vid{v}'s h5 ({sorted(got)}) is not generate_for_frame's maps")
    log(f"pseudo_labels: generate_anno.main --dataset ytvos on {PSEUDO_VIDEOS} videos of one "
        f"{CLI_H}x{CLI_W} frame (tree written in {tree_s:.2f} s): "
        f"{out['main_ytvos_frame_s']:.2f} s per frame (sim model build and load included); "
        f"each AnnotationsWeakly h5 read back equal bit for bit to generate_for_frame [{smi}]")

    # (b) two full-width train steps on the pseudo-labels
    argv = ["--dataset_file", "ytvos", "--ytvos_path", tree, "--backbone", "resnet101",
            "--supervision", "box", "--num_frames", "3", "--batch_size", "1", "--epochs", "1",
            "--output_dir", os.path.join(root, "train"), "--log_every", "1", "--tb_every", "0"]
    reset_counts()
    t0 = time.perf_counter()
    train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts == counts_of(K1=8 * PSEUDO_VIDEOS, K2=8 * PSEUDO_VIDEOS),
          f"pseudo_labels train: {PSEUDO_VIDEOS} steps launched {counts} (want K1 and K2 8 "
          f"per step)")
    results["paths"]["pseudo_labels_train"] = counts
    with open(os.path.join(root, "train", "log.txt")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    check(len(lines) == 1 and all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                                  for r in lines), f"pseudo_labels train log {lines}")
    log(f"pseudo_labels: cli.train on the pseudo-labels, {PSEUDO_VIDEOS} steps in {train_s:.1f} "
        f"s (model build, loader and checkpoint included), mean loss {lines[0]['loss']:.4f}, "
        f"launches {counts} [{smi}]")

    # (c) A2D: the annotation file rewritten in place
    a2d = os.path.join(root, "a2d")
    t0 = time.perf_counter()
    build_a2d_tree(a2d, 1, PSEUDO_A2D_FRAMES)
    tree_s = time.perf_counter() - t0
    ann = os.path.join(a2d, "text_annotations", "a2d_annotation_with_instances", "vid000",
                       f"{PSEUDO_A2D_FRAMES // 2:05d}.h5")
    before = read_datasets(ann)
    reset_counts()
    t0 = time.perf_counter()
    generate_anno.main(["--dataset", "a2d", "--root", a2d, "--densecl", pth])
    torch.cuda.synchronize()
    out["main_a2d_frame_s"] = time.perf_counter() - t0
    counts = read_counts()
    check(counts == counts_of(), f"pseudo_labels main a2d launched {counts}")
    results["paths"]["pseudo_labels_main_a2d"] = counts
    after = read_datasets(ann)
    cap = cv2.VideoCapture(os.path.join(a2d, "Release", "clips320H", "vid000.mp4"))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
    cap.release()
    masks = np.transpose(before["reMask"][None], (0, 2, 1))
    want = dict(zip(("heatBBox", "heatPoint", "centerPoint"), generate_anno.generate_for_frame(
        model, frames[PSEUDO_A2D_FRAMES // 2 - 1], masks)))
    check(sorted(after) == ["centerPoint", "heatBBox", "heatPoint", "instance", "reMask"]
          and all(after[k].dtype == before[k].dtype
                  and after[k].tobytes() == before[k].tobytes() for k in ("instance", "reMask"))
          and all(after[k].dtype == want[k].dtype and np.array_equal(after[k], want[k])
                  for k in want),
          f"pseudo_labels: the A2D annotation file after main ({sorted(after)}) kept or "
          f"wrote the wrong datasets")
    log(f"pseudo_labels: generate_anno.main --dataset a2d on one mp4 of {PSEUDO_A2D_FRAMES} "
        f"frames at {A2D_H}x{A2D_W} (tree written in {tree_s:.2f} s): "
        f"{out['main_a2d_frame_s']:.2f} s for its one annotated frame (sim model build, "
        f"load and mp4 decode included); instance and reMask bit-identical, heatBBox, "
        f"heatPoint and centerPoint generate_for_frame's [{smi}]")
    return out


# ---------------------------------------------------------------- demo_e2e --
# the demo at a shortened length: 3 epochs of a 2-video train split (96
# steps), one valid video
DEMO_EPOCHS, DEMO_TRAIN_VIDEOS, DEMO_VALID_VIDEOS = 3, 2, 1


def finite_unit(x) -> bool:
    return math.isfinite(x) and 0.0 <= x <= 1.0


def phase_demo_e2e(results):
    """``ocpg_tpu_torch.scripts.demo_synthetic_e2e`` in this process at a
    shortened length (the small ResNet-50 model, 2+2 layers, bf16, 128 x
    160): random-weight infer_davis and J&F, train_cli, trained infer_davis
    and J&F.  K2 4 per train step, K1 4 per train step and per inference
    dispatch, K3-K7 never; the record has the JAX script's keys with this
    card's name and power limit as its platform, the loss of the last epoch
    below the first's, every J&F finite in [0, 1]."""
    from ocpg_tpu_torch.scripts import demo_synthetic_e2e as demo

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="demo_e2e_", dir=_build.BUILD_DIR)
    try:
        reset_counts()
        t0 = time.perf_counter()
        rec = demo.main(["--epochs", str(DEMO_EPOCHS), "--train_videos", str(DEMO_TRAIN_VIDEOS),
                         "--valid_videos", str(DEMO_VALID_VIDEOS), "--workdir", root,
                         "--out", os.path.join(root, "record.json")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        layers = demo.DEMO_CFG["enc_layers"] + demo.DEMO_CFG["dec_layers"]
        steps = rec["steps"]
        check(counts["K2"] == layers * steps and counts["K1"] > layers * steps
              and counts["K1"] % layers == 0
              and all(counts[k] == 0 for k in ("K3", "K4", "K5", "K6", "K7")),
              f"demo_e2e: {steps} train steps launched {counts}")
        results["paths"]["demo_e2e"] = counts
        check(sorted(rec) == sorted(["platform", "devices", "config", "dtype", "epochs", "steps",
                                     "random", "train", "trained", "jf_random", "jf_trained"])
              and rec["platform"] == smi and rec["devices"] == torch.cuda.device_count(),
              f"demo_e2e record {sorted(rec)} on {rec['platform']}")
        train = rec["train"]
        check(train["epochs"] == DEMO_EPOCHS and train["loss_last"] < train["loss_first"],
              f"demo_e2e: the loss did not fall {train}")
        jfs = [rec["jf_random"], rec["jf_trained"], *rec["random"]["jf_per_annotator"],
               *rec["trained"]["jf_per_annotator"]]
        check(all(finite_unit(x) for x in jfs), f"demo_e2e J&F {jfs}")
        log(f"demo_e2e: {steps} steps in {train['train_wall_s']} s of train_cli (whole run "
            f"{wall:.1f} s), loss {train['loss_first']} -> {train['loss_last']}, J&F random "
            f"{rec['jf_random']} -> trained {rec['jf_trained']}; launches {counts} [{smi}]")
        results["demo_e2e"] = rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- long_run --
# the long run at a shortened length: 60 steps, the checkpoint at 30, a
# 10-step replay (twice), val at steps 1 and 60
LONG_STEPS, LONG_CKPT, LONG_REPLAY, LONG_VAL_BATCHES = 60, 30, 10, 2


def phase_long_run(results):
    """``ocpg_tpu_torch.scripts.train_long_run`` in this process at a
    shortened length: the full-width ytvos_r101_boxsup model (bf16, B=1,
    T=3, 512 x 640) fed by ClipLoader(compact=True) from its default
    Ref-YouTube-VOS tree (6 videos x 16 frames at 720 x 1280, the h5 heat
    maps written and read by ``data/h5.py``).  K1 and K2 8 per
    train step (live and both replays) and K1 8 per val forward, K3-K7
    never; the restored state bit-identical to the saved one, the first
    replayed loss equal to the live one and the first two within 1e-3
    relative (the script raises otherwise), every loss finite, the val J
    and F finite in [0, 1]."""
    from ocpg_tpu_torch.scripts import train_long_run as long_run

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="long_run_", dir=_build.BUILD_DIR)
    try:
        config = long_run.LongRunConfig(steps=LONG_STEPS, ckpt_step=LONG_CKPT,
                                        replay_steps=LONG_REPLAY, eval_every=LONG_STEPS,
                                        out=os.path.join(root, "record.json"))
        check(config.dataset == "ytvos", f"long_run's default tree is {config.dataset}")
        reset_counts()
        t0 = time.perf_counter()
        rec = long_run.run(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        train_steps = LONG_STEPS + 2 * LONG_REPLAY
        val_forwards = 2 * LONG_VAL_BATCHES
        check(counts == counts_of(K1=8 * (train_steps + val_forwards), K2=8 * train_steps),
              f"long_run: {train_steps} train steps and {val_forwards} val forwards "
              f"launched {counts}")
        results["paths"]["long_run"] = counts
        check(rec["platform"] == smi and rec["dataset"] == "ytvos"
              and rec["resume_state_bit_identical"]
              and rec["resume_replay_steps"] == LONG_REPLAY
              and rec["replay_losses_restored"][0] == rec["replay_losses_live"][0]
              and all(math.isfinite(x) for x in rec["curve_every_20"]
                      + rec["replay_losses_live"] + rec["replay_losses_restored"]
                      + rec["replay_losses_repeat"]),
              f"long_run record {rec}")
        check([p["step"] for p in rec["val_jf_curve"]] == [1, LONG_STEPS]
              and all(finite_unit(p["J"]) and finite_unit(p["F"]) for p in rec["val_jf_curve"]),
              f"long_run val curve {rec['val_jf_curve']}")
        log(f"long_run: {LONG_STEPS} steps ({rec['params_m']} M parameters) in {rec['wall_s']} "
            f"s = {rec['ms_per_step_e2e']} ms/step loader-fed, peak {rec['peak_memory_gib']} "
            f"GiB; loss {rec['loss_first']:.3f} -> last-50 mean {rec['loss_last50_mean']:.3f}; "
            f"val {rec['val_jf_curve']}; checkpoint save {rec['checkpoint_save_wall_s']} s; "
            f"resume: state bit-identical, replay bit-exact {rec['resume_bit_exact']}, max "
            f"rel diff {rec['resume_max_rel_diff']:.3e} (repeat {rec['replay_repeat_max_rel_diff']:.3e}); "
            f"whole phase {wall:.1f} s; launches {counts} [{smi}]")
        results["long_run"] = rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------- memory_envelope --
def phase_memory_envelope(results):
    """``ocpg_tpu_torch.scripts.memory_envelope --quick`` in this process:
    the R101 train rows B=1 and B=2 (T=3, 512 x 640, two steps each) and
    eval rows T=5 and T=36 (384 x 640), each on a fresh full-width bf16
    model.  K1 and K2 8 per train step, K1 8 per eval forward, K3-K7 never;
    every row ok (none runs out of memory on an 80 GB card), its peaks
    above what the process held before it positive and hbm_frac in (0, 1)."""
    from ocpg_tpu_torch.scripts import memory_envelope

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    reset_counts()
    rec = memory_envelope.envelope(quick=True)
    torch.cuda.synchronize()
    counts = read_counts()
    train_grid, eval_grid = memory_envelope.grids(quick=True)
    check(counts == counts_of(K1=8 * (2 * len(train_grid) + len(eval_grid)),
                              K2=8 * 2 * len(train_grid)),
          f"memory_envelope launched {counts}")
    results["paths"]["memory_envelope"] = counts
    rows = rec["rows"]
    check(rec["platform"] == smi and len(rows) == len(train_grid) + len(eval_grid)
          and all(r["status"] == "ok" and r["allocated_mib"] > 0 and r["reserved_mib"] > 0
                  and 0 < r["hbm_frac"] < 1 for r in rows),
          f"memory_envelope rows {rows}")
    for r in rows:
        log(f"memory_envelope: {r['mode']} {r['backbone']} B={r['batch']} T={r['frames']} "
            f"{r['canvas']}{' recompute' if r.get('remat') else ''}: allocated "
            f"{r['allocated_mib']} MiB, reserved {r['reserved_mib']} MiB, hbm_frac "
            f"{r['hbm_frac']} ({r['wall_s']} s) [{smi}]")
    results["memory_envelope"] = rec


# ------------------------------------------------------------------ std_op --
def phase_std_op(results):
    """The standard-layout op once, forward and backward, at the train
    encoder call (bf16 value, msda_inputs in the standard layout)."""
    lq = sum(h * w for h, w in TRAIN_SHAPES)
    value, x, y, aw = msda_inputs(TRAIN_SHAPES, TRAIN_N, lq, torch.bfloat16, seed=21)
    inputs = [t.requires_grad_() for t in (value, *msda._cm_to_standard(x, y, aw))]
    reset_counts()
    out = msda.ms_deform_attn_fast(inputs[0], TRAIN_SHAPES, *inputs[1:])
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == counts_of(K3=1, K4=1), f"std_op launched {counts}")
    check(tuple(out.shape) == (TRAIN_N, lq, HEADS * HEAD_DIM) and bool(torch.isfinite(out).all()),
          f"std_op output {tuple(out.shape)} not finite or of the wrong shape")
    for t in inputs:
        check(t.grad is not None and t.grad.shape == t.shape
              and bool(torch.isfinite(t.grad).all()), "std_op gradient missing or not finite")
    results["paths"]["std_op"] = counts
    log(f"std_op: ms_deform_attn_fast forward + backward at the train encoder call, "
        f"launches {counts}, output and gradients finite")


# -------------------------------------------------------------- msda_bench --
def phase_msda_bench(results):
    """The port's MSDA kernel bench, in this process, as a user runs it."""
    argv = ["--variants", "cm", "r4", "fk", "sep", "--bwd", "--shapes", "eval",
            "--check", "sep"]
    reset_counts()
    out = bench_msda_kernel.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    check(all(counts[k] >= 1 for k in ("K1", "K2", "K5", "K6"))
          and counts["K3"] == counts["K4"] == counts["K7"] == 0,
          f"msda_bench launched {counts}")
    check(sorted(out["check"]) == ["cm", "fk", "r4", "sep"]
          and all(e < 2e-2 for e in out["check"].values()),
          f"msda_bench checks {out['check']}")
    results["paths"]["msda_bench"] = counts
    results["msda_bench"] = out
    log(f"msda_bench: {bench_msda_kernel.__name__} {' '.join(argv)}: launches {counts}")



# ------------------------------------------------------------------- bench --
# bench.py's stages at shortened paired runs: (long, short, repeats) for the
# forward stages (32, 4, 5 run alone) and the train stages (16, 2, 3)
BENCH_EVAL_ITERS, BENCH_TRAIN_ITERS = (8, 2, 3), (4, 1, 3)
BENCH_STAGES = ("headline", "swin_b", "train_bs1", "train_bs2")
# the JAX bench's HLO count of the same R101 forward (bench.py:222)
JAX_R101_FORWARD_GFLOP = 477.5


def mfu_ok(x) -> bool:
    return math.isfinite(x) and 0.0 < x <= 1.05


def phase_bench(results):
    """``ocpg_tpu_torch.scripts.bench`` (``run``) in this process at its
    defaults, the paired runs shortened: every stage present and none
    failed, exit code 0, the four rates above 0, every MFU in (0, 1.05],
    every kernel GFLOP above 0; per stage (the counters reset before each)
    K1 8 per forward and per step, K2 8 per step, K7 24 per Swin-B forward,
    nothing else.  The record is printed on a line of its own."""
    from ocpg_tpu_torch.scripts import bench

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    rec, rc = bench.run(eval_iters=BENCH_EVAL_ITERS, train_iters=BENCH_TRAIN_ITERS)
    log("bench record: " + json.dumps(rec))
    check(rc == 0 and rec["skipped"] == [] and tuple(rec["stage_wall_s"]) == BENCH_STAGES,
          f"bench: exit code {rc}, skipped {rec['skipped']}, stages {list(rec['stage_wall_s'])}")
    rates = ("value", "swin_b_fps", "train_frames_per_sec_per_chip",
             "train_b2_frames_per_sec_per_chip")
    check(all(rec[k] > 0 for k in rates), f"bench rates {[rec[k] for k in rates]}")
    mfus = {k: v for k, v in rec.items() if "_mfu_" in k}
    check(len(mfus) == 8 and all(mfu_ok(v) for v in mfus.values()), f"bench MFUs {mfus}")
    kernel_gflop = {k: v for k, v in rec.items() if "_gflop_" in k and k.endswith("_kernels")}
    check(len(kernel_gflop) == 4 and all(v > 0 for v in kernel_gflop.values()),
          f"bench kernel GFLOP {kernel_gflop}")
    check(rec["nvidia_smi"] == smi and not rec["peak_is_fallback_guess"],
          f"bench card {rec['nvidia_smi']}, peak guessed {rec['peak_is_fallback_guess']}")
    want = {"headline": lambda n: counts_of(K1=8 * n),
            "swin_b": lambda n: counts_of(K1=8 * n, K7=SWIN_B_BLOCKS * n),
            "train_bs1": lambda n: counts_of(K1=8 * n, K2=8 * n),
            "train_bs2": lambda n: counts_of(K1=8 * n, K2=8 * n)}
    for stage in BENCH_STAGES:
        calls, counts = rec["calls"][stage], rec["launches"][stage]
        check(counts == want[stage](calls),
              f"bench {stage}: {calls} forwards or steps launched {counts}")
        results["paths"][f"bench_{stage}"] = counts
    dense = rec["model_gflop_per_clip_dense"]
    log(f"bench: {rec['value']} clip frames/s (R101), {rec['swin_b_fps']} (Swin-B); train "
        f"{rec['train_step_ms']} ms/step (B=1), {rec['train_b2_step_ms']} (B=2); MFU dense / "
        f"incl kernels: R101 {rec['model_mfu_dense']} / {rec['model_mfu_incl_custom_calls']}, "
        f"Swin-B {rec['swin_b_model_mfu_dense']} / "
        f"{rec['swin_b_model_mfu_incl_custom_calls']}, train {rec['train_mfu_dense']} / "
        f"{rec['train_mfu_incl_custom_calls']}, B=2 {rec['train_b2_mfu_dense']} / "
        f"{rec['train_b2_mfu_incl_custom_calls']}; R101 forward {dense} GFLOP dense + "
        f"{rec['model_gflop_per_clip_kernels']} kernels against the JAX bench's HLO count of "
        f"{JAX_R101_FORWARD_GFLOP} ({dense / JAX_R101_FORWARD_GFLOP:.3f} of it); stage walls "
        f"{rec['stage_wall_s']} [{smi}]")
    results["bench"] = rec


# ----------------------------------------------------------------- recipes --
# The recipes no other phase runs (ocpg_tpu_torch/scripts/recipes), in run
# order; each test_* recipe evaluates the checkpoint of its train recipe.
RECIPES = (
    "train_a2d_resnet101_box", "train_a2d_resnet101_boxsup",
    "train_a2d_resnet101_boxinst_point", "train_a2d_resnet101_boxlevelset",
    "train_a2d_resnet101_boxlevelset_point", "train_a2d_resnet101_boxvos",
    "train_a2d_resnet101_freeze", "train_a2d_resnet101_fullsup",
    "train_a2d_resnet101_pointsup", "train_a2d_resnet101_pointsup_partial",
    "train_a2d_videoswin_base", "train_a2d_videoswin_tiny", "test_a2d_videoswin_tiny",
    "train_ytvos_resnet101_fullsup", "train_ytvos_resnet101_pointsup",
    "train_ytvos_videoswin_base", "test_ytvos_videoswin_base",
    "train_ytvos_videoswin_scratch", "train_ytvos_videoswin_tiny",
    "train_joint_resnet101", "pretrain_refcoco")
RECIPES_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(_build.__file__)),
                                            os.pardir, "scripts", "recipes"))
RECIPE_CKPT = {"test_a2d_videoswin_tiny": "train_a2d_videoswin_tiny",
               "test_ytvos_videoswin_base": "train_ytvos_videoswin_base"}
# the trees, each sized so that one epoch is two steps at its recipes' own
# batch: A2D (generated pseudo-labels) 4 train clips (and 2 val videos for
# the eval recipe), 8 for the batch-4 freeze recipe; Ref-YTVOS (h5 heat
# maps) 2 clips for the batch-1 recipes, 4 (and a valid split) for the
# batch-2 ones; joint 3 RefCOCO images and 1 Ref-YTVOS clip; pretrain 4
# RefCOCO images (and 3 val images)
RECIPE_TREE = {"train_a2d_resnet101_freeze": "a2d_b4",
               "train_ytvos_resnet101_fullsup": "ytvos_b1",
               "train_ytvos_resnet101_pointsup": "ytvos_b1",
               "train_ytvos_videoswin_scratch": "ytvos_b1"}
A2D_TRAIN_VIDEOS, A2D_VAL_VIDEOS, A2D_FRAMES = 4, 2, 8
RECIPE_YTVOS_FRAMES = {"ytvos_b1": 2, "ytvos_b2": 4, "ytvos_joint": 1}
RECIPE_VALID_FRAMES = 4
RECIPE_STEPS = 2
# K7 launches a forward, by backbone (each Swin block once)
K7_PER_FORWARD = {"video_swin_t_p4w7": SWIN_T_BLOCKS, "video_swin_b_p4w7": SWIN_B_BLOCKS}
RECORDER = ("#!/bin/bash\n"
            "{ printf '%s\\x1f' \"$@\"; printf '\\n'; } >> \"$RECIPE_ARGV\"\n")


def recipe_calls(path, env, work):
    """(module, argv) of each call ``bash path`` makes on one GPU (NGPUS=1),
    recorded by a stand-in ``python`` first on PATH."""
    import subprocess

    bin_dir = os.path.join(work, "bin")
    os.makedirs(bin_dir, exist_ok=True)
    with open(os.path.join(bin_dir, "python"), "w") as f:
        f.write(RECORDER)
    os.chmod(os.path.join(bin_dir, "python"), 0o755)
    argv_log = os.path.join(work, "argv.log")
    if os.path.exists(argv_log):
        os.remove(argv_log)
    base = {k: v for k, v in os.environ.items() if k not in ("NGPUS", "OCPG_BS")}
    subprocess.run(["bash", path], cwd=work, check=True, capture_output=True, timeout=60,
                   env={**base, "PATH": f"{bin_dir}:{os.environ['PATH']}", "NGPUS": "1",
                        "RECIPE_ARGV": argv_log, **env})
    calls = []
    with open(argv_log) as f:
        for line in f.read().splitlines():
            args = line.split("\x1f")[:-1]
            check(args[:1] == ["-m"], f"{path}: a call not of python -m: {args}")
            calls.append((args[1], args[2:]))
    return calls


def set_flag(argv, flag, value):
    """``argv`` with ``flag``'s value set to ``value`` (added if absent)."""
    argv = list(argv)
    if flag in argv:
        argv[argv.index(flag) + 1] = value
    else:
        argv += [flag, value]
    return argv


def flag_value(argv, flag, default=None):
    return argv[argv.index(flag) + 1] if flag in argv else default


def write_recipe_trees(root, pth):
    """The phase's trees (``RECIPE_TREE``'s comment), the A2D ones labelled
    by generate_pseudo_labels_a2d.sh's own call; returns name -> path and
    the seconds per A2D tree's labelling."""
    from ocpg_tpu_torch.scripts.bench_loader import build_tree

    trees = {name: os.path.join(root, name) for name in
             ("a2d", "a2d_b4", "ytvos_b1", "ytvos_b2", "ytvos_joint", "coco_joint",
              "coco_all")}
    for name, train in (("a2d", A2D_TRAIN_VIDEOS), ("a2d_b4", 2 * A2D_TRAIN_VIDEOS)):
        val = A2D_VAL_VIDEOS if name == "a2d" else 0
        build_a2d_tree(trees[name], train + val, A2D_FRAMES)
        # bench_eval_e2e's tree is a test split: the first videos train
        csv_path = os.path.join(trees[name], "Release", "videoset.csv")
        with open(csv_path) as f:
            rows = f.read().splitlines()
        with open(csv_path, "w") as f:
            f.write("\n".join(r[:-1] + ("0" if i < train else "1")
                              for i, r in enumerate(rows)) + "\n")
    for name, frames in RECIPE_YTVOS_FRAMES.items():
        build_tree(trees[name], 1, frames, CLI_H, CLI_W, dataset="ytvos")
    rng = np.random.default_rng(17)
    write_ytvos_valid(trees["ytvos_b2"], {"vidV": ytvos_blob_frames(rng, RECIPE_VALID_FRAMES, 0)})
    write_coco_tree(trees["coco_joint"], (("refcoco", 1, 0), ("refcoco+", 1, 0),
                                          ("refcocog", 1, 0)))
    write_coco_tree(trees["coco_all"], (("refcoco", 2, 1), ("refcoco+", 1, 1),
                                        ("refcocog", 1, 1)))
    from ocpg_tpu_torch.preprocess import generate_anno

    label_s = {}
    for name in ("a2d", "a2d_b4"):
        (module, argv), = recipe_calls(
            os.path.join(RECIPES_DIR, "generate_pseudo_labels_a2d.sh"),
            {"A2D_PATH": trees[name], "DENSECL_CKPT": pth}, root)
        check(module == "ocpg_tpu_torch.preprocess.generate_anno"
              and flag_value(argv, "--root") == trees[name],
              f"generate_pseudo_labels_a2d.sh called {module} {argv}")
        t0 = time.perf_counter()
        generate_anno.main(argv)
        label_s[name] = time.perf_counter() - t0
    return trees, label_s


def recipe_env(name, trees):
    """The recipe's own variables, pointed at the phase's trees."""
    if name == "train_joint_resnet101":
        return {"YTVOS_PATH": trees["ytvos_joint"], "COCO_PATH": trees["coco_joint"],
                "REFEXP_ANN_DIR": trees["coco_joint"]}
    if name == "pretrain_refcoco":
        return {"COCO": trees["coco_all"]}
    tree = trees[RECIPE_TREE.get(name, "a2d" if "_a2d_" in name else "ytvos_b2")]
    return {"DATA_ROOT": tree, "A2D_PATH": tree, "YTVOS_PATH": tree}


class RecipeProbe:
    """While attached: the train steps and the model's train and eval
    forwards (and the eval forwards that reused the engine's backbone
    results); the first step's target maps and metric names; the backbone
    before the first step and the model that trained; the steps of the
    checkpoints saved, which are written only with ``write_checkpoints``
    (the machine's disk takes 45 GiB a call, and a full-width checkpoint
    with AdamW's moments is 1.1-1.9 GB)."""

    def __init__(self, write_checkpoints):
        self.steps = self.train_forwards = self.eval_forwards = self.reused_forwards = 0
        self.first, self.metric_keys, self.losses = None, None, []
        self.backbone0, self.model = None, None
        self.write_checkpoints, self.saved = write_checkpoints, []

    @contextlib.contextmanager
    def attached(self):
        from ocpg_tpu_torch.engine.train import TrainStep
        from ocpg_tpu_torch.models.ocpg import OCPG

        step_call, forward, save = TrainStep.__call__, OCPG.forward, CheckpointManager.save
        probe = self

        def saved(manager, step, state):
            probe.saved.append((step, sorted(state)))
            if probe.write_checkpoints:
                save(manager, step, state)

        def call(step, batch):
            if probe.first is None:
                probe.first = {k: batch["targets"][k].float().cpu().numpy()
                               for k in ("masks", "weak_masks", "weights")}
                probe.backbone0 = {k: v.detach().clone()
                                   for k, v in step.model.backbone.state_dict().items()}
                probe.model = step.model
            metrics = step_call(step, batch)
            probe.steps += 1
            probe.losses.append((metrics["loss"], metrics["grad_norm"]))
            if probe.metric_keys is None:
                probe.metric_keys = set(metrics)
            return metrics

        def counted(model, *args, **kw):
            if kw.get("train", False):
                probe.train_forwards += 1
            else:
                probe.eval_forwards += 1
                visual = kw.get("visual")       # filled: the engine reuses a backbone
                probe.reused_forwards += bool(visual is not None and visual.feats)
            return forward(model, *args, **kw)

        TrainStep.__call__, OCPG.forward, CheckpointManager.save = call, counted, saved
        try:
            yield self
        finally:
            TrainStep.__call__, OCPG.forward, CheckpointManager.save = step_call, forward, save


def run_recipe(results, name, trees, work, outputs, smi):
    """One recipe through its own calls (``--output_dir`` a directory of the
    phase, ``--epochs`` 1), in this process, and its checks."""
    import importlib

    env = recipe_env(name, trees)
    if name in RECIPE_CKPT:
        env["CKPT"] = os.path.join(outputs[RECIPE_CKPT[name]], "checkpoints")
    calls = recipe_calls(os.path.join(RECIPES_DIR, f"{name}.sh"), env, work)
    check(len(calls) == 1, f"{name}: {len(calls)} calls")
    (module, argv), = calls
    out = os.path.join(work, name)
    cli = module.rsplit(".", 1)[-1]
    if cli in ("train", "pretrain", "infer_ytvos"):
        argv = set_flag(argv, "--output_dir", out)
    if cli in ("train", "pretrain"):
        argv = set_flag(argv, "--epochs", "1")
    outputs[name] = out
    backbone = flag_value(argv, "--backbone", "resnet101")
    recompute = "--use_checkpoint" in argv
    supervision = flag_value(argv, "--supervision", "full" if cli == "pretrain" else "box")
    pairwise = flag_value(argv, "--supervision_type") in ("boxinst", "boxvos")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe = RecipeProbe(write_checkpoints=name in RECIPE_CKPT.values())
    reset_counts()
    t0 = time.perf_counter()
    with probe.attached():
        ret = importlib.import_module(module).main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    results["paths"][f"recipe_{name}"] = counts
    nt, ne = probe.train_forwards, probe.eval_forwards
    k7 = K7_PER_FORWARD.get(backbone, 0)
    runs = ne - probe.reused_forwards
    want = counts_of(K1=8 * (nt + ne), K2=8 * nt, K7=k7 * (runs + nt * (2 if recompute else 1)))
    check(counts == want, f"recipe {name}: {nt} train steps and {ne} eval forwards ({runs} "
                          f"ran the backbone) launched "
                          f"{counts}, want {want}")
    check(nt == probe.steps, f"recipe {name}: {probe.steps} steps, {nt} train forwards")
    rec = {"module": module, "argv": argv, "s": secs, "peak_gib": peak, "steps": nt,
           "eval_forwards": ne, "launches": counts}
    notes = []
    if cli in ("train", "pretrain"):
        check(nt == RECIPE_STEPS, f"recipe {name}: {nt} steps in its epoch, want {RECIPE_STEPS}")
        check(all(math.isfinite(v) for pair in probe.losses for v in pair),
              f"recipe {name}: non-finite loss or grad_norm {probe.losses}")
        with open(os.path.join(out, "log.txt")) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        check(len(lines) == 1 and all(math.isfinite(v) for k, v in lines[0].items()
                                      if k == "loss" or k == "grad_norm"
                                      or k.startswith("refcoco")),
              f"recipe {name}: log.txt {lines}")
        check([step for step, _ in probe.saved] == [RECIPE_STEPS] and all(
            keys == ["model", "optimizer", "train_step"] for _, keys in probe.saved),
              f"recipe {name}: checkpoints saved {probe.saved}")
        check(("loss_pairwise" in probe.metric_keys) == pairwise,
              f"recipe {name}: pairwise loss {'missing' if pairwise else 'reported'} "
              f"({sorted(probe.metric_keys)})")
        rec["losses"] = probe.losses
        notes.append(f"loss {probe.losses[0][0]:.4f} -> {probe.losses[-1][0]:.4f}, grad_norm "
                     f"{probe.losses[-1][1]:.4f}; pairwise {'on' if pairwise else 'off'}")
        if supervision in ("box", "point"):
            inside = probe.first["masks"] > 0
            weak = float((probe.first["weak_masks"][inside] > 0).mean())
            heat = float((probe.first["weights"][inside] > 0).mean())
            check(inside.any() and weak > 0 and (supervision == "box" or heat > 0),
                  f"recipe {name}: the first batch's weak masks ({weak:.4f} of the object) "
                  f"or heat maps ({heat:.4f}) are not on the object")
            rec.update(weak_on_object=weak, heat_on_object=heat)
            notes.append(f"first batch's weak mask on {100 * weak:.2f}% of the object, heat "
                         f"map on {100 * heat:.2f}%")
        if "--freeze_video_encoder" in argv:
            after = probe.model.backbone.state_dict()
            moved = [k for k, v in probe.backbone0.items() if not torch.equal(v, after[k])]
            check(not moved, f"recipe {name}: frozen backbone tensors moved: {moved[:5]}")
            notes.append(f"{len(after)} backbone tensors bit-identical")
    elif cli == "evaluate":
        check(ne > 0 and isinstance(ret, dict) and ret and all(
            math.isfinite(float(v)) for v in ret.values()), f"recipe {name}: metrics {ret}")
        rec["metrics"] = ret
        notes.append(f"{len(ret)} metrics finite")
    elif cli == "infer_ytvos":
        pngs = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(out, "Annotations"))
                for f in fs if f.endswith(".png")]
        check(ne > 0 and len(pngs) == 2 * RECIPE_VALID_FRAMES,
              f"recipe {name}: {len(pngs)} PNGs after {ne} dispatches")
        notes.append(f"{len(pngs)} PNGs")
    probe.model = probe.backbone0 = None
    results["recipes"][name] = rec
    log(f"recipe {name}: {cli} {backbone}{' --use_checkpoint' if recompute else ''}, "
        f"supervision {supervision}, batch {flag_value(argv, '--batch_size', 'default')}: "
        f"{nt} steps, {ne} eval forwards in {secs:.1f} s (model build, loader and "
        f"checkpoint included), peak memory {peak:.2f} GiB; launches {counts}; "
        + "; ".join(notes) + f" [{smi}]")


def phase_recipes(results):
    """The 21 run recipes no other phase runs (``RECIPES``), each through its
    own calls recorded under bash (``NGPUS=1``), with ``--output_dir`` a
    directory of the phase and ``--epochs`` 1, in this process at full
    width, on trees sized to two steps an epoch (the A2D ones labelled by
    generate_pseudo_labels_a2d.sh's call with a DenseCL checkpoint whose
    BatchNorm statistics are calibrated); each test_* recipe evaluates the
    checkpoint its train recipe just wrote.  Checks per run: ``main``
    returns; K1 8 per forward, K2 8 per step, K7 12 (Swin-T) or 24 (Swin-B)
    per forward and again per step with --use_checkpoint; two steps, every
    loss and grad_norm finite, log.txt finite; the pairwise loss reported
    with boxinst and boxvos alone; the first batch's weak masks (box and
    point) and heat maps (point) on the object; the backbone bit-identical
    with --freeze_video_encoder; the eval metrics finite, the PNGs written;
    one checkpoint saved at step 2 (written to disk only where a test
    recipe reads it: ``RecipeProbe``).  Seconds and peak memory per recipe."""
    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    results["recipes"] = {}
    root = tempfile.mkdtemp(prefix="recipes_", dir=_build.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        pth = os.path.join(root, "densecl_r101.pth")
        densecl_checkpoint(pth, calibrated=True)
        reset_counts()
        trees, label_s = write_recipe_trees(root, pth)
        counts = read_counts()
        check(counts == counts_of(), f"recipes: labelling the A2D trees launched {counts}")
        log(f"recipes: trees written and the A2D ones labelled in {time.perf_counter() - t0:.1f} "
            f"s (generate_anno.main {label_s['a2d']:.1f} s for {A2D_TRAIN_VIDEOS + A2D_VAL_VIDEOS} "
            f"videos, {label_s['a2d_b4']:.1f} s for {2 * A2D_TRAIN_VIDEOS})")
        outputs = {}
        for name in RECIPES:
            run_recipe(results, name, trees, root, outputs, smi)
            if name in RECIPE_CKPT.values():
                continue
            shutil.rmtree(outputs[name], ignore_errors=True)
            if name in RECIPE_CKPT:
                shutil.rmtree(outputs[RECIPE_CKPT[name]], ignore_errors=True)
        recs = results["recipes"]
        log(f"recipes: {len(recs)} recipes in {sum(r['s'] for r in recs.values()):.1f} s; "
            f"peak memory {max(r['peak_gib'] for r in recs.values()):.2f} GiB "
            f"({max(recs, key=lambda k: recs[k]['peak_gib'])}) [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_script(results, path, fn):
    """``fn()`` with the launch counters reset before and read after, the
    counts kept as path ``path``; returns (fn's result, the counts)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    results["paths"][path] = counts
    return out, counts


def phase_bench_scripts(results):
    """Each measurement driver of ``ocpg_tpu_torch/scripts`` in this
    process at its shortest, as a user runs it (``main(argv)``), its
    record printed on a line of its own: bench_train (timing with --trace,
    then --e2e on its default Ref-YTVOS tree), bench_serving (one round of
    2 requests), bench_eval_e2e (its default A2D tree, 3 videos),
    bench_loader (its default Ref-YTVOS tree, then --dataset davis, at the
    same worker counts, --step_ms from phase bench), bench_swin_micro,
    bench_train_sweep (one R101 point in a child process).  Each run's
    kernel launches are a path of their own:
    K1 and K2 8 per train step, K1 8 per forward, K7 24 per Swin-B
    forward and once per window-attention part."""
    from ocpg_tpu_torch.scripts import (bench_eval_e2e, bench_loader, bench_serving,
                                        bench_swin_micro, bench_train, bench_train_sweep)

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="bench_scripts_", dir=_build.BUILD_DIR)
    try:
        def out(name):
            return os.path.join(root, name)

        def timed(name, fn):
            t0 = time.perf_counter()
            rec, counts = run_script(results, name, fn)
            log(f"{name} record ({time.perf_counter() - t0:.1f} s): " + json.dumps(rec))
            return rec, counts

        rec, counts = timed("bench_train", lambda: bench_train.main(
            ["--iters", "2", "--iters_short", "1", "--repeats", "1", "--trace",
             "--out", out("train.json")]))
        check(counts == counts_of(K1=8 * rec["steps"], K2=8 * rec["steps"])
              and rec["launches"] == counts and rec["step_ms"] > 0
              and mfu_ok(rec["train_mfu_dense"]) and mfu_ok(rec["train_mfu_incl_custom_calls"])
              and rec["gflop_per_step_kernels"] > 0 and rec["profile_device_ms_by_class"]
              and rec["nvidia_smi"] == smi, f"bench_train: launches {counts}, record {rec}")
        rec, counts = timed("bench_train_e2e", lambda: bench_train.main(
            ["--e2e", "4", "--e2e_videos", "2",
             "--e2e_frames_per_video", "6", "--e2e_workers", "2", "--out", out("e2e.json")]))
        steps = 4 + 4 + 1 + 4
        check(counts == counts_of(K1=8 * steps, K2=8 * steps) and rec["e2e_train_step_ms"] > 0
              and rec["resident_step_ms"] > 0 and math.isfinite(rec["last_loss"])
              and rec["dataset"] == "ytvos",
              f"bench_train --e2e: {steps} steps launched {counts}, record {rec}")

        rec, counts = timed("bench_serving", lambda: bench_serving.main(
            ["--reqs", "2", "--rounds", "1", "--out", out("serving.json")]))
        dispatches = 4 * 2 * 2
        times = [v for k, v in rec.items() if k.endswith("_ms_per_request")]
        check(counts == counts_of(K1=8 * dispatches) and len(times) == 4
              and all(t > 0 for t in times), f"bench_serving: launches {counts}, record {rec}")

        rec, counts = timed("bench_eval_e2e", lambda: bench_eval_e2e.main(
            ["--videos", "3", "--frames", "6", "--resident_iters", "3",
             "--out", out("eval.json")]))
        check(rec["dataset"] == "a2d" and counts["K1"] > 0 and counts["K1"] % 8 == 0
              and counts == counts_of(K1=counts["K1"]) and rec["metrics_finite"]
              and rec["metrics_host_vs_device_max_abs_delta"] <= 1e-6
              and all(rec[k] > 0 for k in rec if k.startswith("e2e_eval_ms")),
              f"bench_eval_e2e: launches {counts}, record {rec}")

        loader_recs = {}
        for dataset in ("ytvos", "davis"):
            rec, counts = timed(f"bench_loader_{dataset}", lambda: bench_loader.main(
                ["--dataset", dataset, "--videos", "2", "--frames-per-video", "6",
                 "--batches", "8", "--workers", "1", "2",
                 "--step_ms", str(results["bench"]["train_step_ms"]),
                 "--out", out("loader.json")]))
            check(counts == counts_of() and rec["value"] > 0 and "feeds_one_gpu" in rec
                  and rec["dataset"] == dataset,
                  f"bench_loader --dataset {dataset}: launches {counts}, record {rec}")
            loader_recs[dataset] = rec["batches_per_sec_by_workers"]
        log(f"bench_loader: batches/s by workers, Ref-YTVOS (h5 heat maps) "
            f"{loader_recs['ytvos']} beside Ref-DAVIS {loader_recs['davis']} "
            f"({os.cpu_count()} host cores) [{smi}]")

        rec, counts = timed("bench_swin_micro", lambda: bench_swin_micro.main(
            ["--iters", "5", "--out", out("swin_micro.json")]))
        k7_parts = [k for k in rec["parts"] if k.endswith("K7 kernel")]
        check(len(k7_parts) == 4 and counts["K7"] > 0 and counts == counts_of(K7=counts["K7"])
              and all(v["ms"] > 0 for v in rec["parts"].values()),
              f"bench_swin_micro: launches {counts}, parts {sorted(rec['parts'])}")

        rec, counts = timed("bench_train_sweep", lambda: bench_train_sweep.main(
            ["--backbones", "resnet101", "--batches", "1", "--frames", "3", "--iters", "2",
             "--iters_short", "1", "--repeats", "1", "--out", out("sweep.json")]))
        (point,) = rec["points"]
        check(point["status"] == "ok" and point["step_ms"] > 0
              and mfu_ok(point["train_mfu_incl_custom_calls"])
              and point["launches"] == counts_of(K1=8 * point["steps"], K2=8 * point["steps"]),
              f"bench_train_sweep point {point}")
        # the child's launches: this process launched nothing for the sweep
        check(counts == counts_of(), f"bench_train_sweep launched {counts} in this process")
        results["paths"]["bench_train_sweep"] = point["launches"]
        log(f"bench_scripts: every measurement script ran [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# every phase, in the order it runs (phase bench_scripts reads phase bench's
# step time)
PHASES = (("kernel", phase_kernel), ("card", lambda _: phase_card()),
          ("serve", phase_serve), ("a2d", phase_a2d), ("train", phase_train),
          ("swin_serve", phase_swin_serve), ("swin_a2d", phase_swin_a2d),
          ("swin_train", phase_swin_train), ("swin_t", phase_swin_t),
          ("resume", phase_resume), ("train_cli", phase_train_cli),
          ("multi_gpu", phase_multi_gpu), ("eval_cli", phase_eval_cli),
          ("pretrain_cli", phase_pretrain_cli), ("infer_davis", phase_infer_davis),
          ("infer_ytvos", phase_infer_ytvos), ("pretrained", phase_pretrained),
          ("pseudo_labels", phase_pseudo_labels), ("recipes", phase_recipes),
          ("demo_e2e", phase_demo_e2e), ("long_run", phase_long_run),
          ("memory_envelope", phase_memory_envelope), ("std_op", phase_std_op),
          ("msda_bench", phase_msda_bench), ("bench", phase_bench),
          ("bench_scripts", phase_bench_scripts))


def main(argv=None) -> int:
    import argparse

    phases = dict(PHASES)
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA GPU.")
    ap.add_argument("--phases", nargs="+", choices=list(phases), default=list(phases),
                    help="run only these phases, in the script's order (default: all); "
                         "the result lines come only from a run of every phase")
    args = ap.parse_args(argv)
    if "bench_scripts" in args.phases and "bench" not in args.phases:
        ap.error("phase bench_scripts needs phase bench")
    args.phases = [name for name in phases if name in args.phases]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    results = {"paths": {}}
    log(f"peak rates ({'assumed, ' if SPEC.assumed else ''}{SPEC.kind}): "
        f"{SPEC.hbm_bytes_per_s / 1e12:.2f} TB/s HBM, {SPEC.peak_flops_f32 / 1e12:.0f} "
        f"TFLOP/s float32, {SPEC.peak_flops_bf16 / 1e12:.0f} TFLOP/s bf16")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernel source(s) in {secs:.1f} s "
        f"(phase {time.perf_counter() - t0:.1f} s)")
    for src, text in _build.build_logs.items():
        log(f"build log {src}:\n{text.strip()}")
    for name in args.phases:
        t0 = time.perf_counter()
        phases[name](results)
        log(f"phase {name} ok in {time.perf_counter() - t0:.1f} s")
    if args.phases != list(phases):
        log(f"phases {' '.join(args.phases)} ok; no result lines without every phase")
        return 0

    # K1 timed at the serving encoder call (and at every call of phase
    # kernel, by_call), K2, K3 and K4 at the train encoder (K2 and K4 also at
    # the serving encoder, the decoder calls and on clustered samples), K5 and K6 at the
    # serving encoder (the bench's eval call, and the train one), K7 at the
    # Swin-B train stage-0 call of a shifted block (the serving one beside
    # it); launches counted on each path's run, the entry's own on its main
    # path (train for K1 and K2, std_op for K3 and K4, msda_bench for K5 and
    # K6, swin_train for K7)
    def entry(name, source, replaces, k, counter, main_path, **extra):
        by_path = {path: counts[counter] for path, counts in results["paths"].items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": by_path[main_path], "launches_by_path": by_path,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms"), **extra}

    kernels = [
        entry("ms_deform_attn_cm", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:620", results["msda"], "K1", "train",
              at="serve encoder",
              train_encoder={k: results["msda_train"][k] for k in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
              by_call=results["msda_calls"]),
        entry("ms_deform_attn_cm_backward", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:994", results["msda_bwd"], "K2", "train",
              at="train encoder", by_call=results["msda_bwd_calls"]),
        entry("ms_deform_attn_fast", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:138", results["K3"]["train encoder"],
              "K3", "std_op", at="train encoder",
              serve_encoder=results["K3"]["serve encoder"]),
        entry("ms_deform_attn_backward", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:370", results["K4"]["train encoder"],
              "K4", "std_op", at="train encoder", by_call=results["K4"]),
        entry("ms_deform_attn_cm_r4", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_r4.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:746", results["K5"]["serve encoder"],
              "K5", "msda_bench", at="serve encoder",
              **{k: results["K5"]["serve encoder"][k]
                 for k in ("mma_gflop", "mma_bound_ms", "mma_tflops")},
              by_call=results["K5"], bench_ms=results["msda_bench"]["ms"]["fwd/r4/eval"]),
        entry("ms_deform_attn_cm_fk", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_fk.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:1159", results["K6"]["serve encoder"],
              "K6", "msda_bench", at="serve encoder",
              **{k: results["K6"]["serve encoder"][k]
                 for k in ("mma_gflop", "mma_bound_ms", "mma_tflops")},
              by_call=results["K6"], bench_ms=results["msda_bench"]["ms"]["fwd/fk/eval"]),
        entry("window_attention", "ocpg_tpu_torch/ops/csrc/window_attention_fwd.cu",
              "ocpg_tpu/ops/window_attention_pallas.py:139", results["wattn_train"], "K7",
              "swin_train",
              at="swin-B train stage 0, shifted block (bw=437, h=4, n=147, dh=32)",
              serve_stage0=dict(results["wattn"], at="swin-B serving stage 0, shifted block "
                                                     "(bw=322, h=4, n=245, dh=32)"),
              infer_davis_stage0=dict(results["wattn_infer_davis"],
                                      at="infer_davis stage 0 at clip_len 36, shifted block "
                                         "(bw=1610, h=4, n=392, dh=32)"),
              swin_t=results["wattn_swin_t"],
              by_call=results["wattn_report"]),
    ]
    log("resize: " + json.dumps(results["resize"]))
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
