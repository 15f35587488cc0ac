"""Quickest proof that the PyTorch port (gslora_tpu_torch) runs on the GPU.

    python3 chip_smoke.py

Needs one NVIDIA GPU and the CUDA toolkit (nvcc). It imports nothing of
JAX or of the JAX package, and catches nothing: any failure ends it with a
non-zero exit code and without the final result line.

1. Set-up: prints the card's name and power limit, builds every CUDA
   kernel of the port from gslora_tpu_torch/csrc (attention.cu,
   attention_fp32.cu and group_lasso.cu, one nvcc each, started together)
   and prints the build times.
2. Kernel phase: each kernel against its plain PyTorch version on the
   card, at every shape the driven paths give it (K1: train, eval, fused
   and prototype batches, derived from the paths' configs, each at its
   path's attention scale: ViT-B/16's 0.125 with q and k offset per
   channel as its qkv bias does), at ragged
   ones and at the edges of K1's 64-row tiles and 16-key blocks, each
   output held to a
   tolerance scaled to its own size (ops/attention.plain_mismatch,
   ops/group_lasso.group_mismatch); times of the kernel, the plain version
   and the nearest single PyTorch call (library yardstick, never used by
   the port) with CUDA events, and each kernel's bound from its bytes and
   operations at this card's published rates. K1 is also timed at each
   path shape, L2-warm and L2-cold, beside SDPA at the same shape, with
   its backward's two launches apart, and its blocks per SM, registers
   and spills are printed. The
   group kernels (K2 prox,
   K3 norms and rescale, and the fused group-Lasso through autograd) run
   at the flagship LoRA shapes, ViT-B/16's rank-8 LoRA and two ragged
   ones, fp32 and bf16, with an all-zero layer and a threshold that kills
   one layer and shrinks the others, the flagship also on the prox's
   streamed path; then their cluster size, the clusters the card holds
   at once, the launch floor (an empty kernel of group_lasso.cu through
   the same ctypes path) and their times at both LoRA shapes. Then K1 in
   fp32 (csrc/attention_fp32.cu, slice 16) against its fp32 plain version
   at every shape the fp32 phase gives it and at the same edges, held to
   plain_mismatch's fp32 limits; its occupancy at (197, 64) and (256,
   128); at the flagship shape its warm and L2-cold times, the backward's
   two launches apart, the plain version's and SDPA's in fp32 (no TF32),
   its bound from the fp32 peak outside the tensor cores, beside the bf16
   kernel's times. From slice 21 the fp32 shapes are those of every fp32
   run below (fp32_path_shapes: the pretrain's, ViT-B/16's at its scale,
   the baselines', test_model's 1920 slices, a tp rank's 4 heads, pp's
   micro-batches, the model checks').
3. Model check: the flagship model's and ViT-B/16's embeddings, logits
   and LoRA gradients (dropout off, 4 images) with attention through the
   kernels against the same with the kernels' plain version
   (attn_impl="dpa"), within MODEL_TOLS of the compute dtype; and one
   LIRF step at flagship width, whose student gradients run back through
   the frozen teacher's upper blocks, the same way: in bf16, then in fp32
   (fp32 K1, slice 21). K1's launches counted by dtype.
4. Main path phase: the port's train_forget CLI on the card at the
   flagship width (ViT-P8S8, 112x112, dim 512, 8 heads x 64, CosFace,
   rank-8 FFN LoRA; depth 6), batch 24, one epoch, prototypes on. Checks
   finite accuracies and losses and that every attention of the run went
   through the kernels (launch counts equal what the path implies). Then
   times the bench recipe (bf16 params, merged LoRA, fused dual batch,
   prototypes, 24 images per stream).
5. Continual phase: the port's train_forget_cl CLI (GS-LoRA++) on the card
   at the same width and depth, 2 tasks x 1 epoch, with the prox step
   (kernel K2 after every optimizer update), EMA and per-task prototypes.
   Checks finite per-task accuracies and losses, the old-class accuracy of
   task 1, both task checkpoints, K2 launched once per training step and
   K1's counts equal to what the path implies.
6. ImageNet phase: the port's train_forget_cl CLI with the ImageNet-100
   recipe (scripts/run_cl_forget_image.sh: -d imagenet100 -n VIT_B16,
   bs 48, rank-8 FFN LoRA, BND 10, alpha 1e-4) at ViT-B/16's full width
   and depth (224x224, 197 tokens, dim 768, depth 12, 12 heads x 64),
   cut to 2 tasks x 1 epoch, over a seeded JPEG folder (100 classes at
   scattered indices of a 1000-wnid list, and 3 held-out classes),
   resumed (-r) from a seeded torchvision-named checkpoint with a
   1000-row head and no LoRA. Checks the head cut to the classes' rows,
   finite accuracies, the missing-class accuracy logged before and
   after, and K1's counts against those derived from the flags
   (expected_cl_launches). Then the recipe's forget step alone:
   ms/step and images/s from CUDA events, peak memory.
7. Pretrain phase: the port's train_pretrain CLI at the same width, every
   parameter trained (so K1's backward runs in block 0 too), batch 480,
   4 epochs of 2000 synthetic images (20 steps; the batch-20 eval saves a
   checkpoint); then a LoRA-only run resumed from that checkpoint with
   remat (-r, --lora_rank 8, --remat), which must load the base bit for
   bit, keep it and move the LoRA; export_torch of its result to a
   reference-named .pth that -r loads back bit for bit; pair verification
   (perform_val) of its result on the card. K1 counts equal what each run
   implies (expected_pretrain_launches). The same two runs in fp32 compute
   (slice 21: fp32 K1 in every block's backward and under --remat),
   held the same way, with their peak memory. Then remat with dropout on the
   card's generator (slice 19, remat_dropout_check): one pretrain loss
   at the flagship width, depth 2, dropout 0.1, 48 images, dropout drawn
   from a CUDA generator at seed 3, in bf16 (K1) and fp32 (fp32 K1),
   without remat twice and with it: the gradients with remat equal those
   without bit for bit (or within the two runs' difference, printed),
   the generator ends in the same state, 2 x depth attention blocks run
   under remat and depth without. Then the pretrain step alone at bs
   480, without and with remat: ms/step, images/s, peak memory.
8. Baseline phase: every baseline of the zoo (Retrain, Replay, L2, EWC,
   MAS, LwF, DER, DER++, FDR, SCRUB, LIRF) through train_forget_cl, 2
   tasks, and train_forget --ewc and --retrain, at the flagship width and
   depth 2 (the integration phase runs every method at depth 6) with
   scripts/run_cl_forget_open.sh's windows (bs 48, 80 + 20
   classes, 10 open) and rank 0, cut to 1 epoch, 4 images per class and
   1 SCRUB superepoch. Checks finite accuracies of every task, the task
   snapshots, and K1's counts per run against those its flags and data
   imply (expected_baseline_launches, expected_single_step_launches).
   Then one of each family in fp32 compute (slice 21: train_forget_cl
   --ewc, --DER_plus, --SCRUB, --LIRF and train_forget --retrain), held
   the same way. Then one step of each baseline family alone (reg with
   two anchor terms, DER++, SCRUB min, LIRF; 48 images per stream):
   ms/step from CUDA events and peak memory.
9. Profiler phase, right after each step's timing: five bench-recipe
   steps, two ViT-B/16 forget steps, two pretrain steps (bs 480) and
   three of each baseline step under utils/profiling.trace; prints for
   each the device's busy share over them, its time per step by kernel
   family, the kernels with the most device time and the longest idle
   stretches.
10. Eval phase, the eval and serving surface at the flagship width and
   depth: train_pretrain makes the base it evaluates (255 steps of bs
   120, until CosFace's eval margin no longer hides its predictions:
   test accuracy at least 90 %); cli.test_model with scripts/test.sh's
   flags (-b 240, rank 8) on that base, in bf16 with --ver_targets lfw
   (a seeded lfw.bin of synthetic test pairs) and again with --gemm_impl
   int8 (finite accuracies over every test image once, report.json,
   class_accuracy.txt, the ROC artifact; bf16's overall and per-class
   accuracy equal to engine/evaluate.eval_accuracy's on the card; int8
   within 2.0 points of bf16); W8A8 on the card
   (ops/quant.int8_linear at every projection shape of ViT-P8S8 and
   ViT-B/16 against its float64 twin, to 1e-6 relative, with its times
   beside the bf16 product's; each model's int8 eval against its bf16
   eval: embedding cosine > 0.99, top-1 agreement >= 0.9);
   cli.backbone_probe, 2 epochs (backbone frozen, head trained, no
   attention backward); test_model (both products) and backbone_probe
   again on the same base in fp32 compute (slice 21), test_model's
   accuracy equal to eval_accuracy's in fp32; recovery (10 forget steps
   against 6, a save_train_state / restore_train_state round trip and 4
   more, within 5e-3); run_continual_forgetting(boundary="keep") with
   the continual phase's config (task 1 starts from task 0's final LoRA); and
   tools/bench_inference's serving points (both models, bf16 and int8:
   images/s, ms per batch, mfu against the card's dense peak, peak
   memory), with the P8S8 bs-240 points traced. K1's counts of every run
   are checked against those derived from its flags.
11. Native phase (slice 7): builds the native host IO from
   gslora_tpu_torch/csrc/*.cpp with g++ (the record reader; the JPEG/PNG
   decoder where libjpeg and libpng are installed, else it prints why
   not), writes a seeded 112x112 face folder of JPEGs (100 classes x 48
   train, x 4 test) and a .rec of the train images; holds the decoder
   against PIL over the whole folder (where it builds) and the record
   reader against the Python reader, both to the bit; times the four
   decode paths of a 480-image batch on the host; runs train_pretrain
   from the folder for one epoch (10 steps of bs 480; K1's counts
   derived), untraced for its images/s and traced for the device's busy
   share over the epoch, beside pretrain_bench's synthetic step.
12. Data-parallel phase (slice 7): train_forget (GS-LoRA, bs 48, 20
   steps), train_forget_cl (--one_stage, prox, EMA, 2 tasks) and
   train_pretrain (bs 480, 10 steps; and with --grad_accum 2) with --dp
   at the flagship width and depth 2, dropout off, in two ranks of this
   script (``--dp-rank``) sharing the card through gloo (and with the one
   process, whose references run while the ranks do), each against one
   process with twice the --grad_accum (whose micro-batches are the
   ranks' rows): K1's and K2's counts per rank as derived, both ranks'
   parameters equal to the bit, the final parameters within the JAX
   suite's rtol 1e-4 / atol 1e-5 of the one process's, every eval within
   one test image; walls of both (two ranks on one card measure the path,
   not scaling). The same for the baselines under --dp, at
   the baseline phase's flags: train_forget_cl with --ewc, --DER_plus,
   --SCRUB and --LIRF (2 tasks each) and train_forget --ewc, K1's counts
   per rank from expected_baseline_launches /
   expected_single_step_launches over a rank's rows, every accuracy of
   every task within one test image. Then checkpoints/dcp_io: a flagship
   train state of CUDA tensors (parameters and AdamW moments) through
   AsyncSaver in one process and in both ranks (one gloo group), read
   back equal with a template on the card and without one.
13. Layout phase (slice 9, the (data, model) mesh; every world's ranks
   start together and run beside the one-process references; the face
   ViT at depth 2, as in the data-parallel phase):
   train_forget with --fsdp (2 x 1), with --tp --mesh_model 2 (1 x 2),
   factored and merged (2 of the recipe's 5 epochs);
   train_forget_cl --one_stage with prox, --fsdp --mesh_model 2 (2 x 2,
   K2 on every rank, 2 tasks); train_pretrain --tp --fsdp --mesh_model 2
   (2 x 2, bs 480), at the flagship width, dropout off, bf16, in ranks of
   this script (``--layout-rank``) sharing the card through gloo (the
   all_reduce route of all_gather and reduce_scatter), each against one
   process of the same flags with --grad_accum D (D the data axis): K1's
   and K2's counts per rank as derived from the flags, every rank's
   gathered parameters equal to the bit, the final parameters within
   LAYOUT_FLOOR_FACTOR times the recipe's noise floor of the one
   process's (the one process against itself at --grad_accum 2D; to the
   bit where nothing is split over ``model``), every eval within one test
   image; prints each
   rank's bytes of the four block kernels (exact: 36 MiB at D = 2, 24
   MiB under 2 x 2 tp + fsdp) beside the whole tree's, the route and the
   walls (ranks sharing one card: the path, not scaling). Slice 10 adds
   sequence and pipeline parallelism to the same phase: train_forget with
   --sp, --tp --sp and --pp --pp_micro 2 (1 x 2), train_forget_cl with
   --sp and the prox (K2 on every rank) and with --pp in the loss mode
   (1 x 2), train_pretrain with --tp --fsdp --sp and with --pp (2 x 2);
   K1 runs on whole sequences on every sp rank and on each stage's
   micro-batches under pp, where the counts are per stage (block 0's
   attention backward is skipped on stage 0 only, where the FFN LoRA
   alone trains); each rank's block-kernel bytes (72 MiB under sp, 36 MiB
   a stage under pp) and the peak of the card's memory each rank and the
   one process allocated. Slice 11 adds the whole JAX mesh, in worlds of
   8 and 4 started beside the others: train_forget with --mesh_slices 2
   --mesh_data 2 (2 x 2 x 1, against plain --dp on the same 4 ranks to
   the bit), with --mesh_slices 2 --tp --fsdp --sp --mesh_model 2
   (2 x 2 x 2 on 8 ranks), train_forget_cl with --mesh_slices 2 --fsdp
   and the prox (2 x 2 x 1, K2 on every rank, against plain --dp on 4
   ranks to the bit), train_pretrain with --mesh_slices 2 --pp
   --mesh_model 2 (2 x 1 x 2), each against one process with --grad_accum
   S·D; and train_forget with --mesh_data 2 on a world of 4, whose ranks
   2 and 3 are idle (no launch, no byte on the card, exit 0), against the
   data-parallel phase's one process to the bit, after one save and load
   of checkpoints/dcp_io over the used ranks' group. Slice 12 adds every
   model and method under the layouts: ViT-B/16 at full width and depth
   through the ImageNet continual CLI (1 task of the recipe, the seeded
   folder and checkpoint with the missing-class eval, its 1000-way head
   split over ``model`` too) under --tp --fsdp (2 x 2, 4 ranks, after
   the pretrains in their spawn) and under --sp with the prox (1 x 2, K2
   on every rank); the baselines at the baseline phase's flags:
   train_forget --ewc --tp (1 x 2), train_forget_cl --SCRUB --fsdp
   --mesh_model 2 (2 x 2), --DER_plus --sp (1 x 2) and --LIRF --tp
   --fsdp (2 x 2), whose one-process references at --grad_accum 2 are
   the data-parallel phase's; train_forget with --lora_pos Attention
   --pp (1 x 2, block 0's attention backward on stage 0 too). Each held
   as the others: launches per rank derived, block-kernel bytes by the
   rules, LAYOUT_FLOOR_FACTOR times the noise floor. Slice 21 adds
   train_forget with --tp --sp and with --pp --pp_micro 2 in fp32 compute
   (1 x 2, spawn "2f"), against one fp32 process and its fp32 noise
   floor. No rank and no one-process run calls the plain attention on
   the card.
14. Integration phase (slice 15, right after the baseline phase): the
   four flagship integration tools (gslora_tpu_torch/tools/, the ports
   of the JAX package's scripts/integration_*.py) through their run
   functions at the flagship width and depth and their scripts' recipes,
   every epoch count cut to 1, bf16: integration_synthetic --unsaturated
   (single-step GS-LoRA with the alpha warm-up, prototypes and EMA), all
   twelve methods of integration_baselines --unsaturated, the four
   default methods of integration_baselines_cl for 2 tasks, and
   integration_continual --unsaturated for its 4 tasks in each of its
   modes (merge + reinit, --boundary keep, and --few_shot at
   batch 4 with 4 images a class), from one base at
   $PRETRAIN_CKPT in a temporary directory (the first tool pretrains it
   for 1 epoch and says so, the others say they loaded it). Checks each
   report against the JAX script's keys, every accuracy finite and in
   [0, 100], K1's counts per tool against those its recipe and data
   imply, K2 and K3 at 0, and that no file appeared in the working tree;
   prints each tool's wall and peak memory. Then tools/base_split (slice
   19) once: its recipe arm (torch seed 0, bf16, remat, K1) pretrained
   1 epoch and one forget run of 1 epoch from it, K1's counts of the
   call and of each part against those derived, its walls printed.
15. fp32 phase (slice 16, right after the continual phase): the main
   path's train_forget and the continual phase's train_forget_cl recipes
   with --compute_dtype float32, each checked as its bf16 run (finite
   metrics and losses, checkpoints, K1's counts derived from the flags,
   K2 once per continual step), every K1 launch on the fp32 kernel, none
   on the bf16 one and no call of the plain attention on the card;
   prints the phase's wall. Every fp32 run of the other phases (slice 21)
   is held the same way (fp32_runs).
16. Open-set phase (slice 21, in the eval phase, from its base): GS-LoRA's
   open-set recipes at the flagship's width and depth, bf16, synthetic
   data, -r the eval base: scripts/run_forget_open.sh's gs_lora arm and
   its full arm (--lora_rank 0: every parameter trains, so block 0's
   attention backward runs) through train_forget, 10 epochs, and
   scripts/run_cl_forget_open.sh through train_forget_cl, 2 tasks of 10
   epochs. Checks finite forget, remain and open accuracies, the forget
   accuracy below its value before training in every run and task, both
   task snapshots of the continual run, K1's counts as derived (the open
   classes' evals in every round), K2 and K3 at 0; prints each run's wall
   and peak memory.
17. Prints the kernels line (the bf16 and the fp32 K1 in rows of their
   own; each row's launches on every path, fill_launches), then the
   result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA GPU visible; this check runs only on the "
             "card")

from gslora_tpu_torch.baselines.distill import (  # noqa: E402
    make_distill_step)
from gslora_tpu_torch.baselines.freeze import trains  # noqa: E402
from gslora_tpu_torch.baselines.lirf import (LIRFState,  # noqa: E402
                                             low_slice, make_lirf_step)
from gslora_tpu_torch.baselines.regularization import (  # noqa: E402
    make_reg_step)
from gslora_tpu_torch.baselines.scrub import make_scrub_steps  # noqa: E402
from gslora_tpu_torch.checkpoints.dcp_io import (  # noqa: E402
    AsyncSaver, load_dcp)
from gslora_tpu_torch.checkpoints.io import (  # noqa: E402
    load_params, restore_train_state, save_params, save_train_state)
from gslora_tpu_torch.cli import (backbone_probe, export_torch,  # noqa: E402
                                  test_model, train_forget, train_forget_cl,
                                  train_pretrain)
from gslora_tpu_torch.cli.common import (build_datasets,  # noqa: E402
                                         build_missing_dataset,
                                         build_params)
from gslora_tpu_torch.config import (DataConfig,  # noqa: E402
                                     ForgetConfig, LoraConfig, MeshConfig,
                                     OptimConfig, ViTConfig, build_parser,
                                     config_from_args)
from gslora_tpu_torch import native  # noqa: E402
from gslora_tpu_torch.data.folders import (ImageFolderDataset,  # noqa: E402
                                           SubsetDataset)
from gslora_tpu_torch.data.pipeline import BatchLoader  # noqa: E402
from gslora_tpu_torch.data.recordio import (FaceRecordDataset,  # noqa: E402
                                            read_record, write_recordio)
from gslora_tpu_torch.data.splits import (make_order_list,  # noqa: E402
                                          ratio_subset,
                                          split_by_class_window)
from gslora_tpu_torch.engine import continual as CONT  # noqa: E402
from gslora_tpu_torch.engine.continual import (PROTO_BATCH,  # noqa: E402
                                               detached, split_task_data)
from gslora_tpu_torch.engine.evaluate import (eval_accuracy,  # noqa: E402
                                              make_eval_step)
from gslora_tpu_torch.engine.forget import (make_forget_step,  # noqa: E402
                                            scalars_for_epoch)
from gslora_tpu_torch.engine.pretrain import (PretrainState,  # noqa: E402
                                              make_pretrain_step)
from gslora_tpu_torch.engine.state import (ForgetState,  # noqa: E402
                                           make_optimizer)
from gslora_tpu_torch.evaluation.verification import (  # noqa: E402
    perform_val)
from gslora_tpu_torch.models.convert import flatten_tree  # noqa: E402
from gslora_tpu_torch.losses.classification import (  # noqa: E402
    cross_entropy)
from gslora_tpu_torch.models import vit as VIT  # noqa: E402
from gslora_tpu_torch.models.vit import (ViT, _Node,  # noqa: E402
                                         init_vit_params, vit_apply)
from gslora_tpu_torch.models.vit_imagenet import (  # noqa: E402
    to_torchvision_state_dict)
from gslora_tpu_torch.ops import attention as A  # noqa: E402
from gslora_tpu_torch.ops import cuda_build  # noqa: E402
from gslora_tpu_torch.ops import group_lasso as G  # noqa: E402
from gslora_tpu_torch.ops import quant as Q  # noqa: E402
from gslora_tpu_torch.parallel import sharding  # noqa: E402
from gslora_tpu_torch.parallel.mesh import (active_mesh,  # noqa: E402
                                            make_mesh)
from gslora_tpu_torch.tools import attention_bench as AB  # noqa: E402
from gslora_tpu_torch.tools import attention_split as AS  # noqa: E402
from gslora_tpu_torch.tools import base_split as BS  # noqa: E402
from gslora_tpu_torch.tools import bench_inference as BI  # noqa: E402
from gslora_tpu_torch.tools import flagship  # noqa: E402
from gslora_tpu_torch.tools import integration_baselines as IB  # noqa: E402
from gslora_tpu_torch.tools import (  # noqa: E402
    integration_baselines_cl as ICL)
from gslora_tpu_torch.tools import integration_continual as IC  # noqa: E402
from gslora_tpu_torch.tools import integration_synthetic as IS  # noqa: E402
from gslora_tpu_torch.tools import group_bench as GB  # noqa: E402
from gslora_tpu_torch.utils.profiling import (device_summary,  # noqa: E402
                                              trace)
from gslora_tpu_torch.utils.timing import cuda_cold_ms, cuda_ms  # noqa: E402
from gslora_tpu_torch.utils.trees import tree_map  # noqa: E402

DEV = torch.device("cuda")
SCALE = 512 ** -0.5  # the flagship's attention scale, dim**-0.5
FLAGSHIP_BH = 48 * 8  # fused dual batch of 24 + 24 images, 8 heads
N_TOKENS, HEAD_DIM = 197, 64
# Whole model in bf16, kernels against plain attention: each attention
# output may move by a bf16 ulp, and the six blocks carry that on; the
# relative L2 error of embeddings, logits and LoRA gradients stays far
# below this bound unless a layout or an index is wrong.
MODEL_TOL = 3e-2
# The same in fp32 compute (fp32 K1 against its fp32 plain version, every
# GEMM in fp32 without TF32): MODEL_TOL over K1's bf16 relative L2 limit
# (ops/attention.TOLERANCES, 2e-3: 15 times) times K1's fp32 limit (1e-5),
# 1.5e-4; TF32 anywhere in a block moves these by ~1e-3.
MODEL_TOLS = {torch.bfloat16: MODEL_TOL,
              torch.float32: MODEL_TOL / A.TOLERANCES[torch.bfloat16][1]
              * A.TOLERANCES[torch.float32][1]}

# Published dense rates (NVIDIA data sheets): bytes/s of device memory,
# bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores and TF32
# tensor-core FLOP/s, keyed by a substring of the card's name.
PEAKS = [("H200", 4.8e12, 989e12, 67e12, 495e12),
         ("H100 PCIe", 2.0e12, 756e12, 51e12, 378e12),
         ("H100 NVL", 3.9e12, 835e12, 60e12, 418e12),
         ("H100", 3.35e12, 989e12, 67e12, 495e12)]
SOURCES = ("attention", "attention_fp32", "group_lasso")
# The flagship FFN LoRA: L, r, d, m (rank 8 on ViT-P8S8, depth 6)
LORA_SHAPE = (6, 8, 512, 2048)


def card_rates(name: str):
    for key, *rates in PEAKS:
        if key in name:
            return tuple(rates)
    raise RuntimeError(f"no published rates for card {name!r}")


def build_all():
    """One nvcc per source, all started together: each source's future of
    its build's seconds (:func:`built` waits for them)."""
    def timed(name):
        t0 = time.perf_counter()
        cuda_build.build(name)
        return time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(SOURCES))
    futures = {name: pool.submit(timed, name) for name in SOURCES}
    pool.shutdown(wait=False)
    return futures


def built(builds, names):
    """Waits for the builds of ``names`` (:func:`build_all`'s futures; a
    failed build raises here) and prints their seconds."""
    secs = {name: builds[name].result() for name in names}
    print("built " + ", ".join(f"{k} in {v:.1f} s" for k, v in secs.items()),
          flush=True)


def inputs(bh, n, d, seed, bias=False, dtype=torch.bfloat16):
    """q, k, v, g of N(0, 1) in ``dtype``; ``bias``: q and k also carry one
    offset per channel of N(0, 1), as ViT-B/16's qkv bias puts in front of
    K1."""
    g = torch.Generator().manual_seed(seed)
    ts = [torch.randn(bh, n, d, generator=g) for _ in range(4)]
    if bias:
        for t in ts[:2]:
            t += torch.randn(d, generator=g)
    return [t.to(DEV, dtype) for t in ts]


def max_err(got, want, names, what):
    """Largest abs error of the kernel's outputs; raises unless each is
    within the tolerance of ops/attention.plain_mismatch for its dtype."""
    stats = {n: A.plain_mismatch(a, b) for n, a, b in zip(names, got, want)}
    print(f"kernel vs plain {what}: " + json.dumps(stats), flush=True)
    bad = {n: m for n, m in stats.items() if not m["ok"]}
    if bad:
        max_tol, l2_tol = A.TOLERANCES[want[0].dtype]
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version beyond max_rel {max_tol}, rel_l2 "
                             f"{l2_tol}: {bad}")
    return max(m["max_abs"] for m in stats.values())


def attention_scale(model) -> float:
    """The model's attention scale: dim**-0.5 for the face ViT's quirk,
    dim_head**-0.5 for ViT-B/16 (models/vit.py)."""
    return (model.dim if model.attn_scale == "dim" else model.dim_head) \
        ** -0.5


def recipe_shapes(argv):
    """(batch x heads, tokens, scale) of a CLI recipe's attentions: its
    train and eval batches; the forget recipes' (MAIN_ARGV, CL_ARGV, in
    any compute dtype) fused batch too, and the prototypes' batch where
    the recipe has prototypes."""
    cfg = config_from_args(build_parser().parse_args(argv))
    bs, m = cfg.data.batch_size, cfg.model
    batches = [bs, bs * cfg.data.test_batch_scale]
    if in_dtype(argv, "bfloat16") in (MAIN_ARGV, CL_ARGV):
        batches += [2 * bs, PROTO_BATCH]
    elif cfg.forget.prototype:
        batches.append(PROTO_BATCH)
    return {(b * m.heads, m.seq_len, attention_scale(m)) for b in batches}


def in_dtype(argv, dtype):
    """``argv`` with its --compute_dtype set to ``dtype``."""
    i = argv.index("--compute_dtype")
    return [*argv[:i + 1], dtype, *argv[i + 2:]]


def path_shapes():
    """(batch x heads, tokens, scale) of every attention the driven paths
    launch, from their configs: the train batch and the eval batch of each
    path, the bench recipe's fused batch (train + forget) and the
    continual path's prototype batch; the ImageNet path's train and
    missing-class batch (one size) and its eval batch, at its own scale;
    the baselines' train and eval batches; the eval base's train and eval
    batches and the rest of the eval and serving surface's
    (eval_surface_shapes); the integration tools' train, fused, eval,
    pretrain and prototype batches."""
    shapes = set()
    for argv in (MAIN_ARGV, CL_ARGV, PRETRAIN_ARGV, IMAGENET_ARGV,
                 BASELINE_ARGV, EVAL_BASE_ARGV,
                 *(argv for _, argv in OPEN_RUNS.values())):
        shapes.update(recipe_shapes(argv))
    # a rank of the data-parallel phase: its rows of the train and eval
    # batches, and its micro-batches under --grad_accum (the one-process
    # references' micro-batches are the ranks' rows)
    for _, argv, accum in DP_RUNS.values():
        cfg = config_from_args(build_parser().parse_args(argv))
        local, m = cfg.data.batch_size // DP_WORLD, cfg.model
        shapes.update((b * m.heads, m.seq_len, attention_scale(m)) for b in
                      (local, local // accum,
                       local * cfg.data.test_batch_scale))
    shapes.update(layout_shapes(LAYOUT_RUNS))
    # the integration tools: the train batch, GS-LoRA's fused batch, the
    # evals of 240 and 250 images, the pretrain batch and the continual
    # prototypes (every loader pads its tail on the card)
    m = flagship.model_config(unsaturated=True)
    shapes.update((b * m.heads, m.seq_len, attention_scale(m)) for b in
                  (flagship.BS, 2 * flagship.BS, IB.EVAL_BS, IS.EVAL_BS,
                   IC.EVAL_BS, flagship.PRETRAIN_BS, PROTO_BATCH))
    shapes.update(few_shot_shapes())
    shapes.update(eval_surface_shapes())
    return sorted(shapes)


def layout_shapes(names):
    """(batch x heads, tokens, scale) of the layout phase's runs
    ``names``: a rank's rows of the train and eval batches (whole
    sequences under sp; a tp rank's half of the heads), each cut into M
    micro-batches under pp; the one-process references' micro-batches
    (--grad_accum S·D and 2·S·D)."""
    shapes = set()
    for name in names:
        _, argv, flags, _ = LAYOUT_RUNS[name]
        cfg = config_from_args(build_parser().parse_args(argv))
        bs, m, ways = cfg.data.batch_size, cfg.model, layout_ways(name)
        local = bs // ways
        micro = (pp_stages(name) or (1, 1))[1]
        heads = m.heads // layout_shape(name)[2] if "--tp" in flags \
            else m.heads
        shapes.update((b // micro * heads, m.seq_len, attention_scale(m))
                      for b in (local, local * cfg.data.test_batch_scale))
        shapes.update((bs // a * m.heads, m.seq_len, attention_scale(m))
                      for a in (ways, 2 * ways))
    return shapes


def few_shot_shapes():
    """(batch x heads, tokens, scale) that only integration_continual
    --few_shot launches: its stream of 4 images, the fused pair and its
    test batch; run in bf16 and, in the full recipe's fp32 arm, fp32."""
    m = flagship.model_config(unsaturated=True)
    data = IC.run_config(m, True, 4, "cpu").data
    return {(b * m.heads, m.seq_len, attention_scale(m)) for b in
            (data.batch_size, 2 * data.batch_size,
             data.batch_size * data.test_batch_scale)}


# Two ragged shapes, and the edges of K1's 64-row tiles (128-row blocks in
# fp32) and 16-key blocks (8 in fp32) up to the longest sequence: (bh, n, d)
EDGE_SHAPES = [(6, 17, 64), (3, 70, 64), (7, 63, 64), (7, 64, 64),
               (7, 65, 64), (5, 128, 64), (5, 129, 64), (5, 193, 64),
               (5, 208, 64), (4, 232, 64), (4, A.KERNEL_MAX_N, 64),
               (3, A.KERNEL_MAX_N, 128)]


def k1_errors(path, path_seed, edge_seed, dtype=torch.bfloat16):
    """K1 forward and backward in ``dtype`` against the plain version at
    the (bh, n, scale) shapes ``path`` (d = 64) and at EDGE_SHAPES, inputs
    seeded from ``path_seed`` and ``edge_seed`` on; raises past
    plain_mismatch's limits; the largest abs error of each direction."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    shapes = [(bh, n, HEAD_DIM, scale, seed)
              for seed, (bh, n, scale) in enumerate(path, path_seed)]
    shapes += [(bh, n, d, SCALE, seed) for seed, (bh, n, d) in
               enumerate(EDGE_SHAPES, edge_seed)]
    for bh, n, d, scale, seed in shapes:
        q, k, v, g = inputs(bh, n, d, seed, bias=scale != SCALE, dtype=dtype)
        where = f"{(bh, n, d)} {dtype} scale {scale:.4f}"
        o = A.attention_fwd_kernel(q, k, v, scale)
        torch.cuda.synchronize()
        errs["fwd"] = max(errs["fwd"], max_err(
            [o], [A.attention_fwd_plain(q, k, v, scale)], ["o"],
            f"attention forward at {where}"))
        grads = A.attention_bwd_kernel(q, k, v, g, scale)
        torch.cuda.synchronize()
        errs["bwd"] = max(errs["bwd"], max_err(
            grads, A.attention_bwd_plain(q, k, v, g, scale),
            ["dq", "dk", "dv"], f"attention backward at {where}"))
        del q, k, v, g, o, grads
    return errs


def kernel_phase(bw, peak):
    """K1 forward and backward against the plain version at every shape
    the driven paths give it and at the tile edges; warm and L2-cold times
    at each path shape; plain, library and the backward's two launches at
    the flagship shape; occupancy of the three kernels."""
    errs = k1_errors(path_shapes(), 3, 20)

    occupancy = A.kernel_info(N_TOKENS, HEAD_DIM)
    print(f"attention kernels at n={N_TOKENS}, d={HEAD_DIM}: " +
          json.dumps(occupancy), flush=True)

    by_shape = {"fwd": {}, "bwd": {}}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for bh, n, scale in path_shapes():
        # a shape at another scale than the flagship's carries its scale
        # in its key (ViT-B/16's 384 slices beside the flagship's)
        name = f"{bh}x{n}x{HEAD_DIM}" + (
            "" if scale == SCALE else f"@{scale:.4f}")
        q, k, v, g = inputs(bh, n, HEAD_DIM, 7, bias=scale != SCALE)
        bounds = AB.bf16_bounds(bh, n, HEAD_DIM, bw, peak)
        # library yardsticks at the same shape: SDPA forward, and its
        # backward alone over one recorded forward
        ql, kl, vl = (t[None].clone().requires_grad_(True)
                      for t in (q, k, v))
        out_l = sdpa(ql, kl, vl, scale=scale)
        with torch.no_grad():
            for key, fn, lib in (
                    ("fwd", lambda: A.attention_fwd_kernel(q, k, v, scale),
                     lambda: sdpa(q[None], k[None], v[None], scale=scale)),
                    ("bwd", lambda: A.attention_bwd_kernel(q, k, v, g,
                                                           scale), None)):
                by_shape[key][name] = {
                    "scale": scale, "ms": cuda_ms(fn),
                    "cold_ms": cuda_cold_ms(fn),
                    "bound_ms": bounds[key]["bound_ms"],
                    "library_ms": cuda_ms(lib) if lib else None}
        by_shape["bwd"][name]["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(out_l, (ql, kl, vl), g[None],
                                        retain_graph=True))
        del out_l, ql, kl, vl
    print("attention kernel times by path shape (warm, L2-cold, bound, "
          "SDPA): " + json.dumps(by_shape), flush=True)

    bh, n, d = FLAGSHIP_BH, N_TOKENS, HEAD_DIM
    q, k, v, g = inputs(bh, n, d, 3)
    # library yardsticks: SDPA forward; its backward alone (autograd.grad
    # over one recorded forward, which saved its row statistics)
    q4, k4, v4, g4 = (t.reshape(bh // 8, 8, n, d) for t in (q, k, v, g))
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q4, k4, v4))
    out_l = sdpa(ql, kl, vl, scale=SCALE)
    with torch.no_grad():
        _, stats = A.attention_bwd_rows_kernel(q, k, v, g, SCALE)
        split = {"rows_ms": cuda_ms(
                     lambda: A.attention_bwd_rows_kernel(q, k, v, g, SCALE)),
                 "keys_ms": cuda_ms(
                     lambda: A.attention_bwd_keys_kernel(q, k, v, g, stats,
                                                         SCALE))}
        fwd = {"ms": cuda_ms(lambda: A.attention_fwd_kernel(q, k, v, SCALE)),
               "plain_ms": cuda_ms(
                   lambda: A.attention_fwd_plain(q, k, v, SCALE), iters=20),
               "library_ms": cuda_ms(lambda: sdpa(q4, k4, v4, scale=SCALE))}
        bwd = {"ms": cuda_ms(
                   lambda: A.attention_bwd_kernel(q, k, v, g, SCALE)),
               "plain_ms": cuda_ms(
                   lambda: A.attention_bwd_plain(q, k, v, g, SCALE),
                   iters=20)}
    bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out_l, (ql, kl, vl), g4, retain_graph=True))
    print(f"attention backward at ({bh}, {n}, {d}): rows launch "
          f"{split['rows_ms']:.4f} ms, keys launch {split['keys_ms']:.4f} "
          f"ms", flush=True)
    flagship = f"{bh}x{n}x{d}"
    bounds = AB.bf16_bounds(bh, n, d, bw, peak)
    rows = []
    for name, line, t in (("attention_fwd", ":149", fwd),
                          ("attention_bwd", ":179", bwd)):
        key = name[-3:]
        rows.append({
            "name": name, "route": "cuda",
            "source": "gslora_tpu_torch/csrc/attention.cu",
            "replaces": "gslora_tpu/ops/attention.py" + line,
            "launches": None,
            "max_abs_err": errs[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            **bounds[key],
            "bound_peak": "bf16 tensor cores",
            "library_ms": t["library_ms"],
            "shape": [bh, n, d],
            "cold_ms": by_shape[key][flagship]["cold_ms"],
            "ms_by_shape": by_shape[key],
            "occupancy": {kn: occupancy[kn] for kn in occupancy
                          if kn.startswith("forward" if key == "fwd"
                                           else "backward")},
        })
        if key == "bwd":
            rows[-1]["split_ms"] = split
        print(f"{name} at ({bh}, {n}, {d}) bf16: kernel {t['ms']:.4f} ms "
              f"(L2-cold {rows[-1]['cold_ms']:.4f}), plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {bounds[key]['bound_ms']:.4f} ms "
              f"({bounds[key]['bound_by']})",
              flush=True)
    return rows


def fp32_kernel_phase(bw, fp32_peak, tf32_peak, bf16_rows):
    """The fp32 K1 (csrc/attention_fp32.cu) against its plain version at
    every shape the fp32 runs give it (:func:`fp32_path_shapes`) and at
    EDGE_SHAPES; its occupancy; at the flagship shape its warm and L2-cold
    times, the backward's two launches apart, the plain version's and
    SDPA's in fp32 (no TF32) as the library yardstick, beside the bf16
    kernel's times of this run (``bf16_rows``). Its bound is three TF32
    passes on the tensor cores (the kernel's design), with the bound at
    the fp32 rate outside them beside it."""
    f32 = torch.float32
    errs = k1_errors(fp32_path_shapes(), 40, 60, f32)

    occupancy = {f"{n}x{d}": A.kernel_info(n, d, f32)
                 for n, d in ((N_TOKENS, HEAD_DIM), (A.KERNEL_MAX_N, 128))}
    print("fp32 attention kernels (blocks per SM, registers, spills, "
          "shared memory): " + json.dumps(occupancy), flush=True)

    bh, n, d = FLAGSHIP_BH, N_TOKENS, HEAD_DIM
    q, k, v, g = inputs(bh, n, d, 3, dtype=f32)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, g4 = (t.reshape(bh // 8, 8, n, d) for t in (q, k, v, g))
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q4, k4, v4))
    out_l = sdpa(ql, kl, vl, scale=SCALE)
    with torch.no_grad():
        _, stats = A.attention_bwd_rows_kernel(q, k, v, g, SCALE)
        split = {"rows_ms": cuda_ms(
                     lambda: A.attention_bwd_rows_kernel(q, k, v, g, SCALE)),
                 "keys_ms": cuda_ms(
                     lambda: A.attention_bwd_keys_kernel(q, k, v, g, stats,
                                                         SCALE))}

        def fwd():
            return A.attention_fwd_kernel(q, k, v, SCALE)

        def bwd():
            return A.attention_bwd_kernel(q, k, v, g, SCALE)

        times = {
            "fwd": {"ms": cuda_ms(fwd), "cold_ms": cuda_cold_ms(fwd),
                    "plain_ms": cuda_ms(
                        lambda: A.attention_fwd_plain(q, k, v, SCALE),
                        iters=20),
                    "library_ms": cuda_ms(
                        lambda: sdpa(q4, k4, v4, scale=SCALE))},
            "bwd": {"ms": cuda_ms(bwd), "cold_ms": cuda_cold_ms(bwd),
                    "plain_ms": cuda_ms(
                        lambda: A.attention_bwd_plain(q, k, v, g, SCALE),
                        iters=20)}}
    times["bwd"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out_l, (ql, kl, vl), g4, retain_graph=True))
    del out_l, ql, kl, vl
    bounds = AB.fp32_bounds(bh, n, d, bw, tf32_peak, fp32_peak)
    bf16 = {row["name"]: row for row in bf16_rows}
    rows = []
    for key, line in (("fwd", ":149"), ("bwd", ":179")):
        t, name = times[key], f"attention_{key}_fp32"
        rows.append({
            "name": name, "route": "cuda",
            "source": "gslora_tpu_torch/csrc/attention_fp32.cu",
            "replaces": "gslora_tpu/ops/attention.py" + line,
            "launches": None,
            "max_abs_err": errs[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            **bounds[key],
            "bound_peak": "three TF32 passes on the tensor cores",
            "share_of_bound": bounds[key]["bound_ms"] / t["ms"],
            "library_ms": t["library_ms"],
            "shape": [bh, n, d], "dtype": "float32",
            "cold_ms": t["cold_ms"],
            "occupancy": {shape: {kn: occ[kn] for kn in occ
                                  if kn.startswith("forward" if key == "fwd"
                                                   else "backward")}
                          for shape, occ in occupancy.items()},
        })
        if key == "bwd":
            rows[-1]["split_ms"] = split
        b = bf16[f"attention_{key}"]
        print(f"{name} at ({bh}, {n}, {d}): kernel {t['ms']:.5f} ms "
              f"(L2-cold {t['cold_ms']:.5f}), plain {t['plain_ms']:.4f} ms, "
              f"SDPA fp32 {t['library_ms']:.5f} ms, bound "
              f"{rows[-1]['bound_ms']:.5f} ms ({rows[-1]['bound_by']}, "
              f"three TF32 passes; share {rows[-1]['share_of_bound']:.3f}), "
              f"FFMA bound {rows[-1]['bound_ffma_ms']:.5f} ms; the bf16 "
              f"kernel {b['ms']:.5f} ms (L2-cold {b['cold_ms']:.5f})",
              flush=True)
    print(f"fp32 attention backward at ({bh}, {n}, {d}): rows launch "
          f"{split['rows_ms']:.5f} ms, keys launch {split['keys_ms']:.5f} ms",
          flush=True)
    return rows


def group_max_err(got, want, what, norms=False):
    """Largest abs error of a group kernel's outputs; raises unless each
    is within ops/group_lasso.group_mismatch's tolerance."""
    stats = [G.group_mismatch(a, b, norms=norms) for a, b in zip(got, want)]
    bad = [m for m in stats if not m["ok"]]
    if bad:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version (norms rel {G.NORM_RTOL}, fp32 "
                             f"{G.FP32_TOL} of max, bf16 1 ulp): {stats}")
    return max(m["max_abs"] for m in stats)


def group_phase(bw, fp32_peak):
    """K2 and K3 against their plain versions (the flagship LoRA, ViT-B/16's
    rank-8 LoRA and two ragged shapes, fp32 and bf16, a zero layer, a
    killing threshold; the flagship also on the streamed path), the fused
    group-Lasso through autograd; then the cluster size, the clusters the
    card holds at once, the launch floor, and the three kernels' times at
    both LoRA shapes in fp32 (the LoRA's dtype on the main path)."""
    errs = {"group_prox": 0.0, "group_norms": 0.0, "group_scale": 0.0}
    cases = [(shape, "default") for shape in
             (LORA_SHAPE, GB.SHAPES["vit_b16_r8"], (1, 1, 1, 3),
              (3, 5, 17, 33))] + [(LORA_SHAPE, "streamed")]
    for shape, path in cases:
        for dtype in (torch.float32, torch.bfloat16):
            where = f"{shape} {str(dtype)[6:]} {path}"
            ts, thr = GB.lora_factors(shape, dtype, seed=shape[1])
            L, r, d, m = shape
            plan = G.group_plan(L, r * d, m * r, r * m, d * r, dtype,
                                max_share_bytes=0) \
                if path == "streamed" else None
            norms = G.group_norms_kernel(*ts, plan=plan)
            prox = G.group_prox_kernel(*ts, thr, plan=plan)
            inv = (1.0 / torch.clamp_min(norms, 1e-12)).to(dtype)
            scaled = G.group_scale_kernel(*ts, inv, plan=plan)
            leaves = [t.clone().requires_grad_(True) for t in ts]
            value = G.group_lasso_fused(*leaves)
            value.backward()
            torch.cuda.synchronize()
            want_n = G.group_norms_plain(*ts)
            want_inv = (1.0 / torch.clamp_min(want_n, 1e-12)).to(dtype)
            errs["group_norms"] = max(
                errs["group_norms"],
                group_max_err([norms], [want_n], f"norms {where}", True),
                group_max_err([value.detach().reshape(1)],
                              [want_n.sum().reshape(1)],
                              f"group-Lasso value {where}", True))
            prox_want = G.group_prox_plain(*ts, thr)
            errs["group_prox"] = max(errs["group_prox"], group_max_err(
                prox, prox_want, f"prox {where}"))
            errs["group_scale"] = max(
                errs["group_scale"],
                group_max_err(scaled, G.group_scale_plain(*ts, inv),
                              f"scale {where}"),
                group_max_err([t.grad for t in leaves],
                              G.group_scale_plain(*ts, want_inv),
                              f"group-Lasso grads {where}"))
            killed = int((G.group_norms_plain(*prox_want) == 0).sum())
            print(f"group kernels vs plain at {where}: thr {thr:.4f} "
                  f"kills {killed} of {shape[0]} layers; max abs "
                  f"{json.dumps(errs)}", flush=True)

    plans = {label: GB.cluster_report(shape)
             for label, shape in GB.SHAPES.items()}
    floor = GB.launch_floor(LORA_SHAPE[0])
    print("group kernels' plans (cluster size C, on chip, share bytes, "
          "cudaOccupancyMaxActiveClusters by C): " + json.dumps(plans) +
          "; launch floor (empty kernel, ms): " + json.dumps(floor),
          flush=True)
    by_shape = {name: {} for name in errs}
    with torch.no_grad():
        for label, shape in GB.SHAPES.items():
            ts, thr = GB.lora_factors(shape, torch.float32, seed=9)
            bounds = GB.group_bounds(shape, 4, bw, fp32_peak)
            for name, fn in GB.kernel_calls(ts, thr).items():
                by_shape[name][label] = {"ms": cuda_ms(fn),
                                         "bound_ms": bounds[name][0]}
        ts, thr = GB.lora_factors(LORA_SHAPE, torch.float32, seed=9)
        inv = 1.0 / torch.clamp_min(G.group_norms_plain(*ts), 1e-12)
        # 20 plain calls (~20 launches each) stay inside the launch queue,
        # so they too are all queued before the device wakes
        plain_ms = {
            "group_prox": cuda_ms(lambda: G.group_prox_plain(*ts, thr),
                                  iters=20),
            "group_norms": cuda_ms(lambda: G.group_norms_plain(*ts),
                                   iters=20),
            "group_scale": cuda_ms(lambda: G.group_scale_plain(*ts, inv),
                                   iters=20)}
    bounds = GB.group_bounds(LORA_SHAPE, 4, bw, fp32_peak)
    flagship = plans["flagship"]
    rows = []
    for name, line in (("group_prox", ":147"), ("group_norms", ":57"),
                       ("group_scale", ":81")):
        clustered = name != "group_scale"
        rows.append({
            "name": name, "route": "cuda",
            "source": "gslora_tpu_torch/csrc/group_lasso.cu",
            "replaces": "gslora_tpu/ops/group_lasso.py" + line,
            "launches": None, "max_abs_err": errs[name],
            "ms": by_shape[name]["flagship"]["ms"],
            "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None,
            "library_note": "no single PyTorch call computes a per-layer "
                            "group norm over four tensors",
            "shape": list(LORA_SHAPE), "dtype": "float32",
            "ms_by_shape": by_shape[name],
            "launch_floor_ms": floor["cluster_grid_ms" if clustered
                                     else "scale_grid_ms"],
            "launch_floor_one_block_ms": floor["one_block_ms"],
            "cluster": {"size": flagship["cluster"],
                        "max_active_clusters":
                            flagship["max_active_clusters"][
                                str(flagship["cluster"])],
                        "onchip": flagship["onchip"]}
            if clustered else {"size": None,
                               "blocks_per_layer": G.SCALE_BLOCKS},
        })
        print(f"{name} at {LORA_SHAPE} fp32: kernel {rows[-1]['ms']:.4f} ms "
              f"(ViT-B/16 r8: {by_shape[name]['vit_b16_r8']['ms']:.4f}), "
              f"plain {plain_ms[name]:.4f} ms, bound {bounds[name][0]:.5f} "
              f"ms ({bounds[name][1]}), launch floor "
              f"{rows[-1]['launch_floor_ms']:.4f} ms", flush=True)
    return rows


def rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float(torch.linalg.vector_norm(got - want) /
                 torch.linalg.vector_norm(want).clamp_min(1e-30))


def model_check(model, dtype=torch.bfloat16):
    """A model's forward and LoRA gradients (the flagship's, ViT-B/16's)
    in ``dtype`` compute, attention through the kernels (K1 of that
    dtype alone) against the plain attention, same weights and inputs on
    the card, within MODEL_TOLS[dtype]."""
    lora = LoraConfig(rank=8)
    gen = torch.Generator().manual_seed(1)
    params = init_vit_params(gen, model, lora)
    for name in ("B1", "B2"):  # nonzero B: the LoRA path carries signal
        b = params["lora"]["ffn"][name]
        params["lora"]["ffn"][name] = 0.02 * torch.randn(b.shape,
                                                          generator=gen)
    size = model.image_size
    x = torch.randn(4, 3, size, size, generator=gen).to(DEV)
    y = torch.randint(0, model.num_class, (4,), generator=gen).to(DEV)
    out, counts = {}, {}
    for impl in ("auto", "dpa"):
        vit = ViT(params, dataclasses.replace(model, attn_impl=impl),
                  lora).to(DEV)
        torch.cuda.synchronize()
        start = AS.k1_launches()
        logits, emb = vit(x, y, compute_dtype=dtype)
        grads = torch.autograd.grad(cross_entropy(logits, y),
                                    list(vit.lora.parameters()))
        out[impl] = [emb, logits, *grads]
        torch.cuda.synchronize()
        counts[impl] = AS.k1_launches(start)
    names = ["emb", "logits"] + [n for n, _ in vit.lora.named_parameters()]
    errs = {n: rel_err(a, b) for n, a, b in zip(names, out["auto"],
                                                out["dpa"])}
    name, depth, tol = dtype_name(dtype), model.depth, MODEL_TOLS[dtype]
    print(f"model check, dim {model.dim} depth {depth} {size}x{size}, "
          f"{name} (kernels vs their plain version, relative L2, limit "
          f"{tol:.3g}): " + json.dumps(errs), flush=True)
    # the FFN LoRA's gradient skips block 0's attention backward
    want = {k: [depth, depth - 1] if k == name else [0, 0]
            for k in counts["auto"]}
    if counts != {"auto": want, "dpa": dict.fromkeys(want, [0, 0])}:
        raise AssertionError(f"model check, {name}: K1 launched {counts}")
    bad = {n: e for n, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"model through the kernels disagrees with "
                             f"the plain attention: {bad}")


def dtype_name(dtype):
    """"bfloat16" or "float32": a torch dtype by its --compute_dtype."""
    return str(dtype).replace("torch.", "")


def dtype_tag(dtype):
    """The suffix of a run's name in ``dtype`` (a --compute_dtype): none
    in bf16, "_fp32" in fp32."""
    return "_fp32" if dtype == "float32" else ""


MAIN_ARGV = ["-d", "synthetic", "-n", "VIT", "--vit_depth", "6",
             "--head", "CosFace", "--lora_rank", "8", "-b", "24", "-e", "1",
             "--lr", "1e-2", "--warmup-epochs", "0", "--BND", "110",
             "--beta", "0.15", "--alpha", "0.01", "--alpha_epoch", "0",
             "--prototype", "--pro_f_weight", "0.01",
             "--pro_r_weight", "0.01", "--compute_dtype", "bfloat16"]


def forget_passes(grad_accum):
    """(forwards, backwards) per stream and step of the forget step: one
    of each, or with --grad_accum n the gate pass's n forwards and the
    grad pass's n forwards and backwards (a rank's rows split n ways)."""
    return (1, 1) if grad_accum == 1 else (2 * grad_accum, grad_accum)


def expected_launches(argv):
    """(forward, backward) attention launches the single-step CLI implies
    (on one rank of a --dp run: the same counts over its rows), from its
    flags and data (:func:`forget_run_launches`)."""
    cfg = config_from_args(build_parser().parse_args(argv))
    assert not cfg.forget.average_weight and not cfg.fused_batch
    train, test = datasets(cfg)
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    want = forget_run_launches(
        cfg, train_forget.single_step_data(cfg, train, test, order))
    return want["attention_fwd"], want["attention_bwd"]


def forget_run_launches(cfg, data):
    """K1 launches of engine/loop.run_forget_training (single step) at
    ``cfg`` on ``data``: 'depth' forward launches per forward; 'depth -
    1' backward launches per training forward (the FFN LoRA's gradient
    never needs block 0's attention inputs, so autograd skips that
    backward), 'depth' with an attention LoRA (block 0's qkv LoRA needs
    them) or when the base trains (lora_rank 0: the patch embedding
    needs them); the forget and remain forwards of a step, or one of both
    (fused_batch), with grad_accum as forget_passes says; the test evals
    before training, every ver_freq steps, after each epoch from
    ema_epoch on (average_weight) and at the end, the open classes' (with
    --open_cls_num) as :func:`open_evals` counts them; the prototypes."""
    f, bs = cfg.forget, cfg.data.batch_size
    assert not f.few_shot and f.aug_num == 0
    n_tf, n_tr = len(data.train_forget), len(data.train_remain)
    batches = lambda n, b: -(-n // b)  # noqa: E731
    test_bs = bs * cfg.data.test_batch_scale
    evals = batches(len(data.test_forget), test_bs) + \
        batches(len(data.test_remain), test_bs)
    protos = batches(n_tf, bs) + batches(n_tr, bs) if f.prototype else 0
    # the remain stream drives each epoch
    steps = cfg.num_epoch * batches(n_tr, bs)
    ema_rounds = max(0, cfg.num_epoch - f.ema_epoch) \
        if f.average_weight else 0
    rounds = 2 + steps // cfg.ver_freq + ema_rounds
    fwd, bwd = forget_passes(cfg.optim.grad_accum)
    streams = 1 if cfg.fused_batch else 2
    depth = cfg.model.depth
    per_bwd = depth if cfg.lora.pos == "Attention" or not cfg.lora.rank \
        else depth - 1
    return {"attention_fwd": depth * (rounds * evals + protos +
                                      open_evals(cfg, data, steps) +
                                      streams * fwd * steps),
            "attention_bwd": per_bwd * streams * bwd * steps,
            "group_prox": 0, "group_norms": 0, "group_scale": 0}


def open_evals(cfg, data, steps):
    """Eval batches of the open classes in a run of ``steps`` training
    steps over ``data`` (engine/loop.run_eval: every ver_freq steps and
    at the end; not before training, not of the EMA); 0 without them."""
    if data.test_open is None:
        return 0
    test_bs = cfg.data.batch_size * cfg.data.test_batch_scale
    return (steps // cfg.ver_freq + 1) * -(-len(data.test_open) // test_bs)


_DATASETS = {}


def datasets(cfg):
    """build_datasets(cfg), kept per data source: the launch derivations
    ask for the same synthetic sets (300 MB at the flagship) many times."""
    d = cfg.data
    key = (d.data_mode, d.data_root, d.seed, d.uint8_transfer,
           cfg.model.num_class, cfg.model.image_size)
    if key not in _DATASETS:
        _DATASETS[key] = build_datasets(cfg)
    return _DATASETS[key]


def share_datasets():
    """Every CLI this process runs takes its synthetic sets from the
    :func:`datasets` cache, so no run draws the same 400 MB again (some
    seconds a run; the layout phase's one-process references make dozens
    of runs). The CLIs only read the sets; folder data is built as
    before."""
    def shared(cfg):
        return datasets(cfg) if cfg.data.data_mode == "synthetic" \
            else build_datasets(cfg)

    for cli in (train_forget, train_forget_cl, train_pretrain, test_model,
                backbone_probe):
        cli.build_datasets = shared


def reset_counts():
    A.reset_launch_counts()
    G.reset_launch_counts()


def read_counts():
    """Every kernel's launches since :func:`reset_counts`, K1's by the
    kernel's dtype: attention_fwd / attention_bwd the bf16 kernel's,
    attention_fwd_fp32 / attention_bwd_fp32 the fp32 kernel's."""
    return CONT.kernel_launches()


def run_dtype(argv):
    """The --compute_dtype of ``argv`` (the CLIs' default bfloat16)."""
    return argv[argv.index("--compute_dtype") + 1] \
        if "--compute_dtype" in argv else "bfloat16"


def as_read(want, argv=()):
    """Derived counts ``want`` (K1's under attention_fwd / attention_bwd,
    whatever its dtype) as :func:`read_counts` reads them after a run of
    ``argv``: K1's under the keys of its --compute_dtype's kernel, 0 under
    the other's."""
    fwd, bwd = want["attention_fwd"], want["attention_bwd"]
    out = {**want, "attention_fwd": 0, "attention_bwd": 0,
           "attention_fwd_fp32": 0, "attention_bwd_fp32": 0}
    if run_dtype(argv) == "float32":
        out.update(attention_fwd_fp32=fwd, attention_bwd_fp32=bwd)
    else:
        out.update(attention_fwd=fwd, attention_bwd=bwd)
    return out


def main_path_phase(argv=MAIN_ARGV, what="main path"):
    """train_forget at ``argv`` (the flagship forget recipe, 1 epoch):
    finite metrics and losses, K1's counts as the path implies, every
    launch on the kernel of the run's compute dtype. Returns the counts
    (:func:`read_counts`)."""
    with tempfile.TemporaryDirectory() as out:
        argv = argv + ["--outdir", out]
        want_fwd, want_bwd = expected_launches(argv)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        report = train_forget.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
    for key in ("forget_acc", "remain_acc", "best_H_mean",
                "forget_acc_before"):
        if not math.isfinite(report[key]):
            raise AssertionError(f"{what}: {key} = {report[key]}")
    losses = [(k, v) for rec in logged for k, v in rec.items()
              if k.startswith("loss_")]
    if not losses or not all(math.isfinite(v) for _, v in losses):
        raise AssertionError(f"{what}: missing or non-finite losses "
                             f"{losses[:8]}")
    want = as_read({"attention_fwd": want_fwd, "attention_bwd": want_bwd,
                    "group_prox": 0, "group_norms": 0, "group_scale": 0},
                   argv)
    if launches != want:
        raise AssertionError(f"{what} launched {launches}; the path "
                             f"implies {want}")
    dtype = run_dtype(argv)
    print(f"{what}: train_forget depth 6 dim 512 bs 24, {dtype} compute, "
          f"1 epoch on the card in {wall:.1f} s; forget_acc "
          f"{report['forget_acc']:.2f} remain_acc {report['remain_acc']:.2f} "
          f"best_H {report['best_H_mean']:.3f}; {len(losses)} finite "
          f"logged losses; launches {launches}", flush=True)
    return launches


def bench_setup():
    """The bench recipe's step (bf16 params, merged LoRA, fused dual
    batch, prototypes; 24 images per stream), random weights and inputs;
    returns run(n) -> the last step's metrics."""
    model = ViTConfig(dropout=0.1, emb_dropout=0.1)
    lora = LoraConfig(rank=8)
    fcfg = ForgetConfig(bnd=110.0, beta=0.15, alpha=0.01, alpha_epoch=0,
                        prototype=True, pro_f_weight=0.01, pro_r_weight=0.01)
    params = init_vit_params(torch.Generator().manual_seed(0), model, lora,
                             param_dtype=torch.bfloat16)
    opt = make_optimizer(OptimConfig(lr=1e-2))
    state = ForgetState.create(ViT(params, model, lora).to(DEV), opt)
    step = make_forget_step(model, lora, fcfg, opt,
                            compute_dtype=torch.bfloat16,
                            lora_apply="merged", fused_batch=True)
    gen = torch.Generator(device=DEV).manual_seed(0)
    b = BENCH_STREAM
    xf, xr = (torch.randn(b, 3, 112, 112, device=DEV, generator=gen)
              for _ in range(2))
    yf = torch.randint(90, 100, (b,), device=DEV, generator=gen)
    yr = torch.randint(0, 90, (b,), device=DEV, generator=gen)
    protos = torch.randn(model.num_class, model.dim, device=DEV,
                         generator=gen)
    sc = {"beta": 0.15, "alpha": 0.01, "lr": 1e-3, "bnd": 110.0,
          "bnd_pro": 18.0, "w_pro_f": 0.01, "w_pro_r": 0.01}

    def run(n):
        for _ in range(n):
            _, m = step(state, xf, yf, xr, yr, protos, sc, gen)
        return m

    return run


BENCH_STREAM = 24  # images per stream of the bench recipe


def bench_phase(card):
    """Times the bench recipe's step; returns its run(n) and ms/step for
    the profiler phase."""
    run = bench_setup()
    run(3)
    torch.cuda.synchronize()
    A.reset_launch_counts()
    steps = 20
    t0 = time.perf_counter()
    m = run(steps)
    loss = float(m["loss_total"])  # syncs
    dt = (time.perf_counter() - t0) / steps
    if not math.isfinite(loss):
        raise AssertionError(f"bench recipe step: loss {loss}")
    if (A.FWD_LAUNCHES, A.BWD_LAUNCHES) != (6 * steps, 5 * steps):
        raise AssertionError(f"bench recipe step launched "
                             f"{(A.FWD_LAUNCHES, A.BWD_LAUNCHES)}")
    print("bench " + json.dumps({
        "recipe": "bf16 params, merged LoRA, fused batch, prototypes, "
                  "24 per stream, depth 6",
        "ms_per_step": dt * 1e3, "images_per_sec": 2 * BENCH_STREAM / dt,
        "loss_total": loss, "card": card}), flush=True)
    return run, dt * 1e3


# kernel families of a device timeline (first match wins)
FAMILIES = [("K1 attention", r"attn_(fwd|bwd)"),
            ("K2/K3 group", r"gslora_group"),
            ("GEMM", r"nvjet|gemm|sm90_xmma|cutlass"),
            ("copy and cast", r"copy|Memcpy|Memset"),
            ("reduction", r"reduce|[Ss]oftmax|norm"),
            ("elementwise", r"elementwise")]


def profiler_phase(runs, card):
    """Each (label, run, untraced ms/step, steps) under
    utils/profiling.trace: the device's busy share over the traced steps
    (first enqueue to the device's finish), its time per step by kernel
    family, the kernels with the most device time and the longest idle
    stretches. The untraced step time gives the busy share the steps
    would have without the profiler's own host cost."""
    for label, run, untraced_ms, steps in runs:
        run(2)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as out:
            with trace(out):
                t0 = time.perf_counter()
                with torch.profiler.record_function("steps"):
                    run(steps)
                    torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3 / steps
            summary = device_summary(os.path.join(out, "trace.json"),
                                     window="steps", top=10, gaps=8,
                                     families=FAMILIES)
        if not 0.0 < summary["busy_share"] <= 1.0:
            raise AssertionError(f"profiler: {label}: {summary}")
        device_ms = summary["busy_share"] * summary["window_ms"] / steps
        print("profile " + json.dumps({
            "recipe": label, "steps": steps, "card": card,
            "ms_per_step_traced": host_ms, "ms_per_step_untraced":
                untraced_ms, "device_busy_ms_per_step": device_ms,
            "busy_share_of_untraced_step": device_ms / untraced_ms,
            **summary}), flush=True)


MODEL_FLAGS = ["-n", "VIT", "--vit_depth", "6", "--head", "CosFace"]
# The baseline, data-parallel and layout phases run the flagship's width
# at depth 2 (the fewest blocks pp's two stages take): at depth 6 they do
# not fit the script's 1200 s beside the integration phase, which runs
# every method at full depth.
CUT_MODEL_FLAGS = ["-n", "VIT", "--vit_depth", "2", "--head", "CosFace"]
PRETRAIN_ARGV = ["-d", "synthetic", *MODEL_FLAGS, "--lora_rank", "0",
                 "-b", "480", "-e", "4", "--lr", "3e-4",
                 "--compute_dtype", "bfloat16"]
# the LoRA-only leg resumes the pretrain checkpoint (-r is appended)
PRETRAIN_LORA_ARGV = ["-d", "synthetic", *MODEL_FLAGS, "--lora_rank", "8",
                      "-b", "480", "-e", "1", "--lr", "3e-4", "--remat",
                      "--compute_dtype", "bfloat16"]


def expected_pretrain_launches(argv):
    """K1 launches the pretrain path implies: 'depth' forward launches per
    forward, and 'depth' more per training forward under --remat (the
    backward reruns every block, attention first); 'depth' backward
    launches per training forward when every parameter trains (block 0's
    qkv kernel needs its dq), 'depth - 1' when only the FFN LoRA trains
    (lora_rank > 0 with -r); with --grad_accum n, n of each per step (the
    batch, or a rank's rows under --dp, split n ways); one eval forward
    per test batch every VER_FREQ steps and at the end."""
    cfg = config_from_args(build_parser().parse_args(argv))
    assert not cfg.lora.rank or cfg.lora.pos == "FFN"
    train, test = datasets(cfg)
    batches = lambda n, b: -(-n // b)  # noqa: E731
    bs = cfg.data.batch_size
    steps = cfg.num_epoch * batches(len(train), bs)
    evals = (steps // train_pretrain.VER_FREQ + 1) * batches(
        len(test), bs * cfg.data.test_batch_scale)
    depth = cfg.model.depth
    lora_only = cfg.lora.rank > 0 and bool(cfg.resume)
    per_train_fwd = 2 * depth if cfg.model.remat else depth
    n = cfg.optim.grad_accum
    return {"attention_fwd": depth * evals + per_train_fwd * n * steps,
            "attention_bwd": (depth - 1 if lora_only else depth) * n * steps,
            "group_prox": 0, "group_norms": 0, "group_scale": 0}, steps


def run_pretrain_cli(argv, what):
    """train_pretrain.main on the card with the launch counts read around
    it; checks finite accuracies and logged losses and the counts the
    path implies, every K1 launch in the run's compute dtype; prints the
    test accuracy of every eval and the peak of the card's memory.
    Returns (report, state, launches)."""
    want, steps = expected_pretrain_launches(argv)
    want = as_read(want, argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    report, state = train_pretrain.main(argv, return_state=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    outdir = argv[argv.index("--outdir") + 1]
    with open(os.path.join(outdir, "metrics.jsonl")) as fh:
        logged = [json.loads(line) for line in fh]
    vals = [report["final_test_acc"], report["best_test_acc"]] + [
        rec[k] for rec in logged for k in ("loss", "acc") if k in rec]
    if len(vals) < 4 or not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{what}: non-finite or missing values "
                             f"{vals[:8]}")
    if launches != want:
        raise AssertionError(f"{what} launched {launches}; the path "
                             f"implies {want}")
    rates = [rec["images_per_sec"] for rec in logged
             if "images_per_sec" in rec]
    print(f"{what} " + json.dumps({
        "wall_s": wall, "steps": steps, "compute_dtype": run_dtype(argv),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "report": report,
        "epoch_images_per_sec": rates, "launches": launches,
        "test_accs": [rec["Test Accuracy"] for rec in logged
                      if "Test Accuracy" in rec]}), flush=True)
    return report, state, launches


def host_tree(tree):
    return {k: v.detach().cpu() for k, v in flatten_tree(tree).items()}


def assert_same(got, want, what):
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if set(got) != set(want) or bad:
        raise AssertionError(f"{what}: differs at {bad[:5]} / keys "
                             f"{sorted(set(got) ^ set(want))[:5]}")


def pretrain_phase(dtype="bfloat16"):
    """The pretrain -> LoRA-only resume chain at flagship width in
    ``dtype`` compute: train_pretrain (every parameter, 20 steps at bs
    480, the batch-20 eval saves a checkpoint); train_pretrain
    --lora_rank 8 -r <it> --remat (the base loads bit for bit and stays,
    the LoRA moves). In bf16 then export_torch of the result to a
    reference-named .pth, which -r loads back bit for bit, pair
    verification of the result on the card and remat_dropout_check.
    Returns both runs' counts."""
    tag = dtype_tag(dtype)
    with tempfile.TemporaryDirectory() as out:
        argv = in_dtype(PRETRAIN_ARGV, dtype) + [
            "--outdir", os.path.join(out, "pretrain")]
        _, _, full = run_pretrain_cli(argv, "pretrain" + tag)
        ckpts = sorted(f for f in os.listdir(os.path.join(out, "pretrain"))
                       if f.startswith("Backbone_VIT_") and
                       "_Batch_20_" in f)
        if len(ckpts) != 1:
            raise AssertionError(f"pretrain: checkpoints {ckpts}")
        ckpt = os.path.join(out, "pretrain", ckpts[0])
        saved = load_params(ckpt)

        argv = in_dtype(PRETRAIN_LORA_ARGV, dtype) + [
            "-r", ckpt, "--outdir", os.path.join(out, "lora")]
        cfg = config_from_args(build_parser().parse_args(argv))
        start = build_params(cfg)
        assert_same(host_tree(start["base"]), host_tree(saved["base"]),
                    "pretrain resume: loaded base")
        _, state, lora = run_pretrain_cli(argv, "pretrain_lora_remat" + tag)
        final = state.params
        assert_same(host_tree(final["base"]), host_tree(saved["base"]),
                    "LoRA-only pretrain: base after the steps")
        before, after = host_tree(start["lora"]), host_tree(final["lora"])
        still = [k for k in before if torch.equal(before[k], after[k])]
        if still:
            raise AssertionError(f"LoRA-only pretrain: LoRA {still} did "
                                 f"not move")
        if tag:
            return full, lora

        own = os.path.join(out, "lora_final.pth")
        save_params(own, final)
        pth = os.path.join(out, "exported.pth")
        export_torch.main(["-r", own, *MODEL_FLAGS, "--lora_rank", "8",
                           "--export_out", pth])
        back = build_params(config_from_args(build_parser().parse_args(
            [*MODEL_FLAGS, "--lora_rank", "8", "-r", pth])))
        assert_same(host_tree(back), host_tree(load_params(own)),
                    "export_torch -> -r round trip")
        print("export: reference-named .pth of the LoRA-only result loads "
              "back bit for bit", flush=True)
        verification_check(state, cfg)
    remat_dropout_check()
    return full, lora


REMAT_CHECK_DEPTH = 2
REMAT_CHECK_IMAGES = 48


def remat_dropout_check(depth=REMAT_CHECK_DEPTH, images=REMAT_CHECK_IMAGES):
    """Remat with dropout on the card's generator (models/vit.
    _rematerialized replays each layer's dropout masks in the backward by
    the generator's get_state / set_state): one pretrain loss (CE of the
    unsaturated flagship's Softmax head, every parameter, rank-8 LoRA
    with nonzero B) at the flagship's width, ``depth`` layers, dropout
    and emb_dropout 0.1, ``images`` images, dropout drawn from a
    torch.Generator on the card at seed 3; in bf16 through K1 and in
    fp32 through fp32 K1. Without remat twice (the run-to-run difference
    of the step's kernels on the card), then with remat: remat's
    gradients equal the first run's bit for bit when the two runs without
    it are (else within their difference), the generator ends in the
    same state, the forward runs 2 x depth attention blocks under remat
    and depth without, and K1 launches 2 x depth (depth) forwards and
    depth backwards of the dtype's kernel alone; another generator seed
    gives other gradients (dropout is on). Prints the differences and the
    wall."""
    t0 = time.perf_counter()
    model = dataclasses.replace(flagship.model_config(unsaturated=True),
                                depth=depth)
    assert model.dropout == model.emb_dropout == 0.1
    params = init_vit_params(torch.Generator().manual_seed(0), model,
                             flagship.LORA)
    draw = torch.Generator().manual_seed(1)
    for name in ("B1", "B2"):  # every LoRA leaf gets a gradient
        b = params["lora"]["ffn"][name]
        params["lora"]["ffn"][name] = 0.05 * torch.randn(b.shape,
                                                         generator=draw)
    inputs = torch.Generator(device=DEV).manual_seed(0)
    size = model.image_size
    x = torch.randn(images, 3, size, size, device=DEV, generator=inputs)
    y = torch.randint(0, model.num_class, (images,), device=DEV,
                      generator=inputs)
    calls = []
    block = VIT._attention_block

    def counted(*args, **kwargs):
        calls.append(1)
        return block(*args, **kwargs)

    def run(remat, dtype, seed=3):
        net = ViT(params, dataclasses.replace(model, remat=remat),
                  flagship.LORA).to(DEV)
        gen = torch.Generator(device=DEV).manual_seed(seed)
        calls.clear()
        torch.cuda.synchronize()
        start = AS.k1_launches()
        logits, _ = net(x, y, train=True, generator=gen, compute_dtype=dtype)
        grads = torch.autograd.grad(cross_entropy(logits, y),
                                    list(net.parameters()))
        torch.cuda.synchronize()
        return grads, gen.get_state(), len(calls), AS.k1_launches(start)

    def max_diff(a, b):
        return max(float((u.float() - v.float()).abs().max())
                   for u, v in zip(a, b))

    out = {}
    VIT._attention_block = counted
    try:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            plain, again, remat = (run(False, dtype), run(False, dtype),
                                   run(True, dtype))
            other = run(False, dtype, seed=4)
            noise = max_diff(plain[0], again[0])
            equal = all(torch.equal(u, v)
                        for u, v in zip(plain[0], remat[0]))
            err = max_diff(plain[0], remat[0])
            want = {k: ([2 * depth, depth] if k == name else [0, 0])
                    for k in remat[3]}
            if not (equal or (noise > 0 and err <= noise)):
                raise AssertionError(
                    f"remat with dropout, {name}: gradients differ from "
                    f"the run without remat by {err} (two runs without "
                    f"it: {noise})")
            if not (torch.equal(plain[1], remat[1])
                    and torch.equal(plain[1], again[1])):
                raise AssertionError(f"remat with dropout, {name}: the "
                                     f"generator ends elsewhere")
            if (plain[2], remat[2]) != (depth, 2 * depth):
                raise AssertionError(
                    f"remat with dropout, {name}: {plain[2]} / {remat[2]} "
                    f"attention blocks without / with remat")
            if remat[3] != want or plain[3] != {
                    k: [v[0] // 2, v[1]] for k, v in want.items()}:
                raise AssertionError(
                    f"remat with dropout, {name}: K1 launched "
                    f"{plain[3]} / {remat[3]} without / with remat")
            if all(torch.equal(u, v) for u, v in zip(plain[0], other[0])):
                raise AssertionError(f"remat with dropout, {name}: another "
                                     f"generator seed gives the same "
                                     f"gradients")
            out[name] = {"bit_equal": equal, "remat_max_diff": err,
                         "no_remat_run_to_run": noise,
                         "blocks": [plain[2], remat[2]],
                         "launches": [plain[3][name], remat[3][name]],
                         "other_seed_max_diff": max_diff(plain[0],
                                                         other[0])}
    finally:
        VIT._attention_block = block
    print("remat_dropout " + json.dumps({
        "recipe": f"pretrain loss, flagship width, depth {depth}, "
                  f"{images} images, dropout 0.1, cuda generator seed 3",
        **out, "wall_s": time.perf_counter() - t0}), flush=True)


def verification_check(state, cfg, n_pairs=300):
    """perform_val on the card over in-memory pairs of the synthetic test
    split (same class for odd pairs, another class for even ones)."""
    _, test = build_datasets(cfg)
    targets = np.asarray(test.targets)
    rng = np.random.RandomState(5)
    idx, issame = [], []
    for p in range(n_pairs):
        a = rng.randint(len(targets))
        same = bool(p % 2)
        idx += [a, rng.choice(np.flatnonzero((targets == targets[a]) ==
                                             same))]
        issame.append(same)
    imgs = test.decode_batch(idx)
    params = state.params

    embs = []

    @torch.no_grad()
    def embed(x):
        x = torch.from_numpy(x.copy()).to(DEV)
        embs.append(vit_apply(params, x, None, cfg.model, cfg.lora,
                              compute_dtype=torch.bfloat16).cpu().numpy())
        return embs[-1]

    acc, std, xnorm, thr = perform_val(embed, (imgs, imgs[:, :, :, ::-1]),
                                       issame, embedding_size=cfg.model.dim)
    if not all(math.isfinite(v) for v in (acc, std, xnorm, thr)):
        raise AssertionError(f"verification: {(acc, std, xnorm, thr)}")
    # the squared distances the threshold search sees (flip-summed,
    # normalised embeddings), same-class pairs against the others
    e = np.concatenate(embs).astype(np.float64)
    e = e[:len(idx)] + e[len(idx):]
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    dist = np.sum((e[0::2] - e[1::2]) ** 2, axis=1)
    same = np.asarray(issame)
    print("verification " + json.dumps({
        "pairs": n_pairs, "accuracy": acc, "std": std, "xnorm": xnorm,
        "threshold": thr,
        "median_sq_dist_same": float(np.median(dist[same])),
        "median_sq_dist_different": float(np.median(dist[~same]))}),
        flush=True)


def pretrain_setup(remat=False, bs=480):
    """The pretrain step at bs 480 (every parameter, AdamW, fp32 params,
    bf16 compute, dropout on), random weights and inputs; returns run(n)
    -> the last step's metrics."""
    model = ViTConfig(remat=remat)
    lora = LoraConfig(rank=0)
    params = init_vit_params(torch.Generator().manual_seed(0), model, lora)
    opt = make_optimizer(OptimConfig(lr=3e-4))
    state = PretrainState.create(ViT(params, model, lora).to(DEV), opt)
    step = make_pretrain_step(model, lora, opt, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(0)
    size = model.image_size
    x = torch.randn(bs, 3, size, size, device=DEV, generator=gen)
    y = torch.randint(0, model.num_class, (bs,), device=DEV, generator=gen)

    def run(n):
        for _ in range(n):
            _, m = step(state, x, y, 3e-4, gen)
        return m

    return run


def pretrain_bench(card, bs=480, steps=10):
    """The pretrain step alone at bs 480, without and with remat: ms/step,
    images/s and the peak device memory of the step. Returns run(n) of
    the one without remat, for the profiler phase."""
    out, runs = {}, {}
    for remat in (False, True):
        run = pretrain_setup(remat, bs)
        run(3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(run(steps)["loss"])  # syncs
        dt = (time.perf_counter() - t0) / steps
        if not math.isfinite(loss):
            raise AssertionError(f"pretrain step: loss {loss}")
        out["remat" if remat else "plain"] = {
            "ms_per_step": dt * 1e3, "images_per_sec": bs / dt,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": loss}
        runs[remat] = run
    del runs[True]
    torch.cuda.empty_cache()
    print("pretrain_bench " + json.dumps({
        "recipe": "pretrain step, every parameter, AdamW, fp32 params, "
                  "bf16 compute, bs 480, depth 6", "card": card, **out}),
        flush=True)
    return runs[False], out["plain"]["ms_per_step"]


CL_ARGV = ["-d", "synthetic", "-n", "VIT", "--vit_depth", "6",
           "--head", "CosFace", "--lora_rank", "8", "-b", "24", "-e", "1",
           "--lr", "1e-2", "--warmup-epochs", "0", "--BND", "110",
           "--alpha", "0.01", "--one_stage", "--num_tasks", "2",
           "--num_of_first_cls", "90", "--per_forget_cls", "10",
           "--structure_mode", "prox", "--prototype", "--BND_pro", "18",
           "--pro_r_weight", "0.01", "--cl_beta_list", "0.15", "0.2",
           "--cl_prof_list", "0.01", "0.02", "--average_weight",
           "--ema_epoch", "0", "--compute_dtype", "bfloat16"]


def expected_cl_launches(argv):
    """K1 and K2 launches the continual CLI implies, from its flags (see
    :func:`cl_launches`); with --imagenet_miss_root, the missing-class
    evals before and after the run (batches of -b) too."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    miss = 0
    if cfg.data.data_mode == "imagenet100" and args.imagenet_miss_root:
        miss = len(build_missing_dataset(cfg, args.imagenet_miss_root))
    return cl_launches(cfg, *datasets(cfg), miss=miss)


def cl_launches(cfg, train, test, miss=0):
    """K1 and K2 launches of engine/continual.run_continual_forgetting at
    ``cfg`` over (train, test). Per task: the old-class evals before and
    after training (task > 0); the prototypes (batches of PROTO_BATCH,
    with prototype); the test forget and remain evals before training,
    every ver_freq steps, after each epoch from ema_epoch on
    (average_weight) and at the end, the open classes' (--open_cls_num)
    as :func:`open_evals` counts them; two training forwards per step, or
    one of both batches (fused_batch). ``miss`` images scored before and
    after the run (batches of the training batch). 'depth' forward
    launches per forward, 'depth - 1' backward per training forward (FFN
    LoRA), with grad_accum as forget_passes says; K2 once per training
    step under structure_mode prox. One rank of a --dp run launches these
    counts over its rows."""
    f, bs = cfg.forget, cfg.data.batch_size
    assert cfg.lora.pos == "FFN" and cfg.lora.rank
    f_pass, b_pass = forget_passes(cfg.optim.grad_accum)
    streams = 1 if cfg.fused_batch else 2
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    batches = lambda n, b: -(-n // b)  # noqa: E731
    test_bs = bs * cfg.data.test_batch_scale
    ema_rounds = max(0, cfg.num_epoch - f.ema_epoch) \
        if f.average_weight else 0
    fwd = steps = 0
    for task in range(f.num_tasks):
        data, old = split_task_data(cfg, train, test, order, task,
                                    cfg.data.seed + task)
        # the remain stream drives each epoch
        n = cfg.num_epoch * batches(len(data.train_remain), bs)
        evals = batches(len(data.test_forget), test_bs) + \
            batches(len(data.test_remain), test_bs)
        rounds = 2 + n // cfg.ver_freq + ema_rounds
        old_evals = 2 * batches(len(old), test_bs) \
            if old is not None and len(old) else 0
        protos = batches(len(data.train_forget), PROTO_BATCH) + \
            batches(len(data.train_remain), PROTO_BATCH) \
            if f.prototype else 0
        fwd += rounds * evals + old_evals + protos + \
            open_evals(cfg, data, n) + streams * f_pass * n
        steps += n
    fwd += 2 * batches(miss, bs)
    depth = cfg.model.depth
    prox = steps if cfg.structure_mode == "prox" else 0
    return {"attention_fwd": depth * fwd,
            "attention_bwd": (depth - 1) * streams * b_pass * steps,
            "group_prox": prox, "group_norms": 0, "group_scale": 0}


def continual_phase(argv=CL_ARGV, what="continual"):
    """The CL CLI on the card at ``argv``: GS-LoRA++ with the prox step and
    EMA over 2 tasks at flagship width; wall time per task from the
    report; K1's counts as the path implies, every launch on the kernel
    of the run's compute dtype. Returns the counts."""
    with tempfile.TemporaryDirectory() as out:
        argv = argv + ["--outdir", out]
        want = as_read(expected_cl_launches(argv), argv)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        report = train_forget_cl.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        missing = [t for t in range(2) if not os.path.exists(os.path.join(
            out, "task-level", f"Backbone_task_{t}.pth"))]
    if missing:
        raise AssertionError(f"{what}: no checkpoint of tasks {missing}")
    if [r["task"] for r in report] != [0, 1]:
        raise AssertionError(f"{what}: report of tasks "
                             f"{[r['task'] for r in report]}")
    for r in report:
        vals = [r[k] for k in ("forget_acc_before", "forget_acc",
                               "remain_acc", "best_H_mean")] + r["norm_list"]
        if r["task"] == 1:
            vals.append(r["old_acc"])
        if not all(v is not None and math.isfinite(v) for v in vals):
            raise AssertionError(f"{what}: task {r['task']}: {r}")
    losses = [v for rec in logged for k, v in rec.items()
              if k.startswith("loss_")]
    ema = [rec for rec in logged if "Test forget-ema Accuracy" in rec]
    if not losses or not all(math.isfinite(v) for v in losses) or \
            len(ema) != 2:
        raise AssertionError(f"{what}: losses {losses[:8]}, EMA evals "
                             f"{len(ema)}")
    if launches != want:
        raise AssertionError(f"{what} launched {launches}; the "
                             f"path implies {want}")
    per_task = [r["time_to_forget_s"] for r in report]
    dtype = run_dtype(argv)
    print(f"{what} " + json.dumps({
        "recipe": f"train_forget_cl GS-LoRA++, prox, EMA, prototypes, "
                  f"depth 6 dim 512 bs 24, 2 tasks x 1 epoch, {dtype} "
                  f"compute",
        "wall_s": wall, "time_to_forget_s": per_task,
        "old_acc_task1": report[1]["old_acc"],
        "norm_list_task1": report[1]["norm_list"],
        "launches": launches}), flush=True)
    return launches


# The forget recipes in fp32 compute (slice 16: K1 on fp32 slices)
FP32_ARGVS = {"train_forget_fp32": in_dtype(MAIN_ARGV, "float32"),
              "train_forget_cl_fp32": in_dtype(CL_ARGV, "float32")}


# the layout phase's runs in fp32 compute (slice 21)
FP32_LAYOUTS = ["forget_tp_sp_fp32", "forget_pp_fp32"]


def fp32_path_shapes():
    """(batch x heads, tokens, scale) of every attention in fp32 compute:
    the train, eval and prototype batches of the forget recipes
    (FP32_ARGVS), the pretrain (the LoRA leg with remat runs the same
    batches), ViT-B/16 (its train, missing-class and eval batches at its
    0.125) and the baselines; test_model's, the pair verification's and
    the probe's (eval_cli_shapes), a layout rank's of FP32_LAYOUTS (a tp
    rank's 4 heads, pp's micro-batches), the few-shot arm's, and the
    model and LIRF checks' 4 and 8 images."""
    recipes = [*FP32_ARGVS.values(), in_dtype(PRETRAIN_ARGV, "float32"),
               IMAGENET_FP32_ARGV, in_dtype(BASELINE_ARGV, "float32")]
    shapes = set().union(*map(recipe_shapes, recipes))
    shapes |= eval_cli_shapes() | layout_shapes(FP32_LAYOUTS) | \
        few_shot_shapes()
    for model, images in ((ViTConfig(), 4), (ViTConfig.vit_b16(), 4),
                          (ViTConfig(), 8)):
        shapes.add((images * model.heads, model.seq_len,
                    attention_scale(model)))
    return sorted(shapes)


@contextlib.contextmanager
def no_plain_attention_on_card(what):
    """Raises at its end if the plain attention ran on CUDA tensors while
    it was open (:func:`plain_attention_on_card`)."""
    with plain_attention_on_card() as plain:
        yield
    if plain != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"{what}: the plain attention ran on the card "
                             f"{plain}")


@contextlib.contextmanager
def plain_attention_on_card():
    """Counts the plain attention's calls on CUDA tensors (forward,
    backward) while open."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = A.attention_fwd_plain, A.attention_bwd_plain

    def counted(key, fn):
        def call(q, *args):
            calls[key] += int(q.is_cuda)
            return fn(q, *args)
        return call

    A.attention_fwd_plain = counted("fwd", fwd)
    A.attention_bwd_plain = counted("bwd", bwd)
    try:
        yield calls
    finally:
        A.attention_fwd_plain, A.attention_bwd_plain = fwd, bwd


def fp32_runs(what, fn, *args):
    """``fn(*args)``, a phase's runs in fp32 compute, with no call of the
    plain attention on the card; prints its wall."""
    t0 = time.perf_counter()
    with no_plain_attention_on_card(what):
        out = fn(*args)
    print(f"{what} in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def fp32_path_phase():
    """train_forget and train_forget_cl (--one_stage, prox) at the forget
    recipes' flags in fp32 compute, each held as its bf16 run is (finite
    metrics and losses, K1's counts as the flags imply, K2 once per
    continual step), every K1 launch on the fp32 kernel, none through the
    plain attention on the card. The counts per run, K1's by dtype."""
    t0 = time.perf_counter()
    with no_plain_attention_on_card("fp32 paths"):
        launches = {
            "train_forget_fp32": main_path_phase(
                FP32_ARGVS["train_forget_fp32"], "fp32 main path"),
            "train_forget_cl_fp32": continual_phase(
                FP32_ARGVS["train_forget_cl_fp32"], "fp32 continual")}
    print(f"fp32 phase in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(launches), flush=True)
    return launches


# GS-LoRA's open-set recipes (slice 21) at the flagship's width and depth
# on synthetic data from the eval base (-r), bf16, cut to 10 epochs of
# their 100 (the continual one to 2 tasks), enough for the forget
# accuracy to fall:
# scripts/run_forget_open.sh's gs_lora arm (rank 8, 70 first classes, 30
# forgotten, 40 open, BND 110, data_ratio 0.1) and full arm (--lora_rank
# 0 at lr 1e-4: every parameter trains), scripts/run_cl_forget_open.sh
# (GS-LoRA++, 10 open classes, BND 105, alpha warm-up, prototypes)
OPEN_FORGET_ARGV = ["-d", "synthetic", *MODEL_FLAGS, "-b", "48", "-e", "10",
                    "--group_type", "block", "--data_ratio", "0.1",
                    "--alpha_epoch", "0", "--open_cls_num", "40",
                    "--warmup-epochs", "0", "--decay-epochs", "100",
                    "--num_of_first_cls", "70", "--per_forget_cls", "30",
                    "--min-lr", "1e-5", "--compute_dtype", "bfloat16"]
OPEN_RUNS = {
    "forget_open_gs_lora": (train_forget, OPEN_FORGET_ARGV + [
        "--lr", "1e-2", "--lora_rank", "8", "--BND", "110", "--beta", "0.1",
        "--alpha", "0"]),
    "forget_open_full": (train_forget, OPEN_FORGET_ARGV + [
        "--lr", "1e-4", "--lora_rank", "0"]),
    "cl_forget_open": (train_forget_cl, [
        "-d", "synthetic", *MODEL_FLAGS, "--one_stage", "-b", "48", "-e",
        "10", "--warmup-epochs", "0", "--lr", "1e-2", "--lora_rank", "8",
        "--decay-epochs", "100", "--num_of_first_cls", "80",
        "--per_forget_cls", "20", "--num_tasks", "2", "--open_cls_num",
        "10", "--BND", "105", "--cl_beta_list", "0.14", "0.14", "0.2",
        "0.15", "--warmup_alpha", "--big_alpha", "0.015", "--alpha_epoch",
        "30", "--min-lr", "1e-5", "--prototype", "--pro_f_weight", "0.0003",
        "--pro_r_weight", "0", "--compute_dtype", "bfloat16"]),
}


def open_set_phase(ckpt):
    """OPEN_RUNS through their CLIs on the card from the checkpoint
    ``ckpt`` (the eval base): finite forget, remain and open accuracies
    (and, in the continual run, the old-class accuracy of task 1 and both
    task snapshots, finite), the forget accuracy below its value before
    training in every run and task; K1's counts as the flags and data
    imply (forget_run_launches, cl_launches: the open evals in every
    round, the full arm's backward through block 0 too), K2 and K3 at 0.
    Prints each run's wall and peak memory; returns the counts by run."""
    t_phase = time.perf_counter()
    launches, summary = {}, {}
    for name, (cli, argv) in OPEN_RUNS.items():
        with tempfile.TemporaryDirectory() as out:
            argv = argv + ["-r", ckpt, "--outdir", out]
            if cli is train_forget:
                fwd, bwd = expected_launches(argv)
                want = {"attention_fwd": fwd, "attention_bwd": bwd,
                        "group_prox": 0, "group_norms": 0, "group_scale": 0}
            else:
                want = expected_cl_launches(argv)
            torch.cuda.reset_peak_memory_stats()
            report, got, wall = run_counted(cli.main, argv, want, name)
            snaps = [] if cli is train_forget else [
                load_params(os.path.join(out, "task-level",
                                         f"Backbone_task_{t}.pth"))
                for t in range(2)]
        tasks = report if isinstance(report, list) else [report]
        if cli is train_forget_cl and [r["task"] for r in tasks] != [0, 1]:
            raise AssertionError(f"{name}: report of tasks {tasks}")
        for r in tasks:
            keys = ["forget_acc_before", "forget_acc", "remain_acc",
                    "open_acc", "best_H_mean"] + (
                        ["old_acc"] if r.get("task") == 1 else [])
            if not all(r[k] is not None and math.isfinite(r[k])
                       for k in keys) or \
                    not r["forget_acc"] < r["forget_acc_before"]:
                raise AssertionError(f"{name}: {r}")
        for snap in snaps:
            bad = [k for k, v in flatten_tree(snap).items()
                   if not torch.isfinite(v).all()]
            if bad:
                raise AssertionError(f"{name}: non-finite snapshot {bad}")
        launches[name] = got
        summary[name] = {
            "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": got, "accuracies": [{k: r.get(k) for k in (
                "task", "forget_acc_before", "forget_acc", "remain_acc",
                "open_acc", "old_acc")} for r in tasks]}
    print("open_set " + json.dumps({
        "recipe": "scripts/run_forget_open.sh (gs_lora, full) and "
                  "scripts/run_cl_forget_open.sh, depth 6 dim 512 bs 48, "
                  "10 epochs (the continual run 2 tasks), synthetic data, "
                  "bf16 compute, from the eval base",
        "wall_s": time.perf_counter() - t_phase, "runs": summary}),
        flush=True)
    return launches


IMAGENET_ARGV = ["--one_stage", "-b", "48", "-d", "imagenet100",
                 "-n", "VIT_B16", "--head", "Softmax", "--lora_rank", "8",
                 "--lr", "1e-2", "--warmup-epochs", "0", "--BND", "10",
                 "--alpha", "1e-4", "--alpha_epoch", "0", "--min-lr", "1e-5",
                 "--num_tasks", "2", "--num_of_first_cls", "80",
                 "--per_forget_cls", "20", "--cl_beta_list", "0.15", "0.15",
                 "-e", "1", "--compute_dtype", "bfloat16"]
# ViT-B/16 in fp32 compute (slice 21): one task of the recipe
IMAGENET_FP32_ARGV = in_dtype(IMAGENET_ARGV, "float32") + ["--num_tasks",
                                                            "1"]
# the seeded stand-in for ImageNet-100: images per class in train/ and
# test/, and the held-out classes with their images
IMAGENET_FOLDER = {"train": 20, "test": 4, "miss_classes": 3,
                   "miss_images": 16}


def imagenet_folder(root, seed=0):
    """A seeded ImageNet-100 folder under root: data/train and data/test
    with 100 class folders named by fake wnids (64x80 JPEGs, a colour per
    class plus noise), data/imagenet_folder_names.txt of 1000 sorted wnids
    in which the 100 sit at scattered indices, and miss/ with 3 other
    wnids' images. Returns (data root, missing-class root, the global
    index of each class in folder order)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    wnids = [f"n{i:08d}" for i in
             sorted(rng.choice(10 ** 8, 1000, replace=False))]
    picked = rng.choice(1000, 100 + IMAGENET_FOLDER["miss_classes"],
                        replace=False)
    run_idx, miss_idx = sorted(picked[:100]), sorted(picked[100:])
    data, miss = os.path.join(root, "data"), os.path.join(root, "miss")

    def write(folder, idx, n):
        colour = rng.randint(0, 256, (1, 1, 3))
        os.makedirs(os.path.join(folder, wnids[idx]))
        for i in range(n):
            img = np.clip(colour + rng.randint(-48, 48, (64, 80, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(folder, wnids[idx], f"{i}.JPEG"))

    for idx in run_idx:
        for split in ("train", "test"):
            write(os.path.join(data, split), idx, IMAGENET_FOLDER[split])
    for idx in miss_idx:
        write(miss, idx, IMAGENET_FOLDER["miss_images"])
    with open(os.path.join(data, "imagenet_folder_names.txt"), "w") as fh:
        fh.write("\n".join(wnids) + "\n")
    return data, miss, run_idx


def vit_b16_checkpoint(path, model):
    """A seeded ``model`` (ViT-B/16) with a 1000-row Softmax head and no
    LoRA, written in torchvision naming by the port's own exporter;
    returns its head."""
    model = dataclasses.replace(model, num_class=1000)
    params = init_vit_params(torch.Generator().manual_seed(0), model,
                             LoraConfig(rank=0))
    sd = to_torchvision_state_dict(params, model)
    torch.save(sd, path)
    return sd["heads.head.weight"], sd["heads.head.bias"]


def imagenet_inputs(root):
    """The seeded ImageNet-100 folder (:func:`imagenet_folder`) and
    ViT-B/16 checkpoint (:func:`vit_b16_checkpoint`, root/vit_b16.pth)
    that every ViT-B/16 run of the script reads (the layout phase's ranks
    through $CHIP_SMOKE_IMAGENET_ROOT): (root, the classes' global
    indices, the checkpoint's 1000-row head weight and bias)."""
    _, _, run_idx = imagenet_folder(root)
    model = config_from_args(build_parser().parse_args(IMAGENET_ARGV)).model
    return (root, run_idx,
            *vit_b16_checkpoint(os.path.join(root, "vit_b16.pth"), model))


def imagenet_phase(inputs, argv=IMAGENET_ARGV, what="imagenet"):
    """The ImageNet-100 continual path on the card at ViT-B/16's full width
    and depth: train_forget_cl -d imagenet100 -n VIT_B16 -r <torchvision
    .pth> with the recipe's flags (``argv``: cut to 2 tasks of 1 epoch in
    bf16, to 1 in fp32), over the seeded JPEG folder with a missing-class
    root (``inputs``, :func:`imagenet_inputs`). Checks the head cut to
    the 100 classes' rows, finite accuracies, the missing-class accuracy
    before and after, and K1's counts against the flags, every launch in
    the run's compute dtype. Returns the counts."""
    import PIL
    dtype = run_dtype(argv)
    root, run_idx, head_w, head_b = inputs
    with tempfile.TemporaryDirectory() as out:
        argv = argv + ["--data_root", os.path.join(root, "data"),
                       "--imagenet_miss_root", os.path.join(root, "miss"),
                       "-r", os.path.join(root, "vit_b16.pth"),
                       "--outdir", out]
        model = config_from_args(build_parser().parse_args(argv)).model
        want = as_read(expected_cl_launches(argv), argv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        report = train_forget_cl.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        snap = load_params(os.path.join(out, "task-level",
                                        "Backbone_task_0.pth"))
    head = snap["base"]["head"]
    rows = torch.tensor(run_idx)
    if head["weight"].shape != (model.num_class, model.dim) or not (
            torch.equal(head["weight"], head_w[rows]) and
            torch.equal(head["bias"], head_b[rows])):
        raise AssertionError(f"{what}: head {tuple(head['weight'].shape)}"
                             f" is not the checkpoint's rows of the "
                             f"{model.num_class} classes")
    tasks = config_from_args(build_parser().parse_args(argv)).forget.num_tasks
    if [r["task"] for r in report] != list(range(tasks)):
        raise AssertionError(f"{what}: report of tasks {report}")
    for r in report:
        vals = [r[k] for k in ("forget_acc_before", "forget_acc",
                               "remain_acc", "best_H_mean")] + r["norm_list"]
        if r["task"] == 1:
            vals.append(r["old_acc"])
        if not all(v is not None and math.isfinite(v) for v in vals):
            raise AssertionError(f"{what}: task {r['task']}: {r}")
    missing = {k: v for rec in logged for k, v in rec.items()
               if k.startswith("imagenet-val-miss_")}
    if sorted(missing) != ["imagenet-val-miss_after",
                           "imagenet-val-miss_before"] or not all(
            math.isfinite(v) for v in missing.values()):
        raise AssertionError(f"{what}: missing-class evals {missing}")
    if launches != want:
        raise AssertionError(f"{what} path launched {launches}; the "
                             f"path implies {want}")
    print(f"{what} " + json.dumps({
        "recipe": f"train_forget_cl -d imagenet100 -n VIT_B16 -r <seeded "
                  f"torchvision .pth>, GS-LoRA, depth 12 dim 768 bs 48, "
                  f"{tasks} tasks x 1 epoch, {dtype} compute",
        "data": f"seeded JPEG folder (PIL {PIL.__version__}): "
                f"{IMAGENET_FOLDER}",
        "wall_s": wall, "time_to_forget_s": [r["time_to_forget_s"]
                                             for r in report],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "accuracies": [{k: r[k] for k in ("task", "forget_acc_before",
                                          "forget_acc", "remain_acc",
                                          "old_acc")} for r in report],
        **missing, "launches": launches}), flush=True)
    return launches


def imagenet_bench(card, steps=10):
    """The ImageNet recipe's forget step alone at ViT-B/16 (fp32 params,
    bf16 compute, rank-8 FFN LoRA, forget and remain batches of 48, random
    weights and images): ms/step and images/s from CUDA events around
    the steps, and the peak device memory. Returns its run(n) and ms/step
    for the profiler phase."""
    cfg = config_from_args(build_parser().parse_args(IMAGENET_ARGV))
    model, lora, b = cfg.model, cfg.lora, cfg.data.batch_size
    params = init_vit_params(torch.Generator().manual_seed(0), model, lora)
    opt = make_optimizer(cfg.optim)
    state = ForgetState.create(ViT(params, model, lora).to(DEV), opt)
    step = make_forget_step(model, lora, cfg.forget, opt,
                            compute_dtype=torch.bfloat16,
                            lora_apply=cfg.lora_apply,
                            structure_mode=cfg.structure_mode,
                            fused_batch=cfg.fused_batch)
    gen = torch.Generator(device=DEV).manual_seed(0)
    size = model.image_size
    xf, xr = (torch.randn(b, 3, size, size, device=DEV, generator=gen)
              for _ in range(2))
    first = cfg.forget.num_of_first_cls
    yf = torch.randint(first, model.num_class, (b,), device=DEV,
                       generator=gen)
    yr = torch.randint(0, first, (b,), device=DEV, generator=gen)
    protos = torch.zeros(model.num_class, model.dim, device=DEV)
    sc = scalars_for_epoch(cfg, 0, lr=1e-2, beta=0.15, continual=True)

    def run(n):
        for _ in range(n):
            _, m = step(state, xf, yf, xr, yr, protos, sc, gen)
        return m

    run(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    m = run(steps)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    loss = float(m["loss_total"])
    depth = model.depth
    if not math.isfinite(loss) or (A.FWD_LAUNCHES, A.BWD_LAUNCHES) != (
            2 * depth * steps, 2 * (depth - 1) * steps):
        raise AssertionError(f"ViT-B/16 forget step: loss {loss}, "
                             f"launches {(A.FWD_LAUNCHES, A.BWD_LAUNCHES)}")
    print("imagenet_bench " + json.dumps({
        "recipe": "ViT-B/16 forget step, fp32 params, bf16 compute, rank-8 "
                  "FFN LoRA, forget + remain batches of 48, depth 12",
        "card": card, "ms_per_step": ms, "images_per_sec": 2 * b / ms * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_total": loss}), flush=True)
    return run, ms


# The baseline zoo at the face flagship's width (ViT-P8S8, depth 2),
# with the flags of scripts/run_cl_forget_open.sh (bs 48, 80 first classes,
# 20 forgotten per task, 10 open classes, lr 1e-2, min lr 1e-5) and rank
# 0 as the reference's baselines run (scripts/run_cl_forget.sh), cut to 2
# tasks x 1 epoch, 4 images per class, 1 SCRUB superepoch
BASELINE_ARGV = ["-d", "synthetic", *CUT_MODEL_FLAGS, "--lora_rank", "0",
                 "-b", "48", "-e", "1", "--lr", "1e-2", "--warmup-epochs",
                 "0", "--min-lr", "1e-5", "--num_tasks", "2",
                 "--num_of_first_cls", "80", "--per_forget_cls", "20",
                 "--open_cls_num", "10", "--few_shot", "--few_shot_num", "4",
                 "--SCRUB_superepoch", "1", "--compute_dtype", "bfloat16"]
BASELINE_FLAGS = ["--retrain", "--replay", "--l2", "--ewc", "--MAS", "--Lwf",
                  "--Der", "--DER_plus", "--FDR", "--SCRUB", "--LIRF"]
SINGLE_STEP_FLAGS = ["--ewc", "--retrain"]
BASELINE_RUNS = [("train_forget_cl", flag) for flag in BASELINE_FLAGS] + \
    [("train_forget", flag) for flag in SINGLE_STEP_FLAGS]
# one baseline of each family in fp32 compute (slice 21): reg, distill,
# SCRUB, LIRF through train_forget_cl, Retrain through train_forget
FP32_BASELINE_RUNS = [("train_forget_cl", flag) for flag in
                      ("--ewc", "--DER_plus", "--SCRUB", "--LIRF")] + \
    [("train_forget", "--retrain")]
# K1 forward and backward launches per training step, in units of depth:
# each student forward with its backward (the patch embedding trains, so
# block 0's attention backward runs too), each teacher or deposit forward
# without one
BASELINE_STEP = {"reg": (1, 1), "lwf": (3, 2), "der": (3, 2), "fdr": (3, 2),
                 "der_plus": (4, 3), "scrub": (2, 1), "lirf": (4, 2)}
REG_FAMILY = ("retrain", "replay", "l2", "ewc", "mas")


def expected_baseline_launches(argv):
    """K1 launches train_forget_cl implies for a baseline, from its flags
    and the data (:func:`baseline_cl_launches`)."""
    cfg = config_from_args(build_parser().parse_args(argv))
    assert cfg.lora.rank == 0 and cfg.forget.few_shot and \
        cfg.forget.open_cls_num > 0
    train, test = datasets(cfg)
    return baseline_cl_launches(cfg, train, test)


def baseline_cl_launches(cfg, train, test):
    """K1 launches cli/train_forget_cl.run_baseline_continual implies for
    the baseline of ``cfg`` over (train, test). Per task: the forget test
    eval before training; the training steps (BASELINE_STEP each); for
    EWC and MAS the importance batches (task 0's remain subset and,
    before the next task, its full remain split), a forward and a
    backward each; the evals every ver_freq steps, after each SCRUB
    superepoch and each LIRF epoch, and at the end (forget, remain and
    open for all but LIRF, which scores forget and remain after each
    epoch and open at the end); the old-class eval (task > 0). 'depth'
    launches per forward, per backward of a student forward (everything
    but the head trains, so block 0's attention backward runs too), and
    per importance batch, each of a training step and an importance
    batch once per micro-batch of grad_accum (padded batches on the card,
    so it divides each); K2 and K3: 0. On a rank of a --dp run the same
    counts hold over its rows."""
    f, b, bs = cfg.forget, cfg.baseline, cfg.data.batch_size
    micro = cfg.optim.grad_accum
    assert bs % micro == 0 and not cfg.model.remat
    method = b.method
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    batches = lambda n, bb: -(-n // bb)  # noqa: E731
    test_bs = bs * cfg.data.test_batch_scale
    depth = cfg.model.depth
    fwd = bwd = 0
    for task in range(f.num_tasks):
        data, old_te = split_task_data(cfg, train, test, order, task,
                                       cfg.data.seed + task)
        n_f, n_r = len(data.train_forget), len(data.train_remain)
        ev_f, ev_r, ev_o = (batches(len(d) if d is not None else 0, test_bs)
                            for d in (data.test_forget, data.test_remain,
                                      data.test_open))
        if method == "scrub":
            steps = b.scrub_superepoch * (5 * batches(n_f, bs) +
                                          10 * batches(n_r, bs))
            evals = ev_f + b.scrub_superepoch * (ev_f + ev_r) + \
                ev_f + ev_r + ev_o
        elif method == "lirf":
            steps = cfg.num_epoch * batches(n_f, bs)
            evals = ev_f + cfg.num_epoch * (ev_f + ev_r) + ev_o
        else:
            n = {"retrain": n_r, "replay": n_f + n_r}.get(method, n_f)
            steps = cfg.num_epoch * batches(n, bs)
            evals = ev_f + (steps // cfg.ver_freq) * (ev_f + ev_r) + \
                ev_f + ev_r + ev_o
        if old_te is not None:
            evals += batches(len(old_te), test_bs)
        imp = 0
        if method in ("ewc", "mas"):
            imp = batches(n_r, bs) if task == 0 else 0
            if task < f.num_tasks - 1:
                imp += batches(len(train_forget_cl.next_remain(
                    cfg, train, order, task + 1)), bs)
        per_fwd, per_bwd = BASELINE_STEP[
            "reg" if method in REG_FAMILY else method]
        fwd += evals + micro * (per_fwd * steps + imp)
        bwd += micro * (per_bwd * steps + imp)
    return {"attention_fwd": depth * fwd, "attention_bwd": depth * bwd,
            "group_prox": 0, "group_norms": 0, "group_scale": 0}


def expected_single_step_launches(argv):
    """K1 launches train_forget implies for --retrain, --l2, --ewc or
    --MAS (cli/train_forget.run_single_step_baseline): the forget test
    eval before; one forward and backward per step over the remain subset
    (Retrain) or relabeled forget + remain; for EWC and MAS the importance
    batches over the full first window's remain split; the forget, remain
    and open evals at the end. 'depth' launches each, a step's and an
    importance batch's once per micro-batch of --grad_accum."""
    cfg = config_from_args(build_parser().parse_args(argv))
    f, b, bs = cfg.forget, cfg.baseline, cfg.data.batch_size
    micro = cfg.optim.grad_accum
    assert bs % micro == 0 and not cfg.model.remat and \
        f.few_shot and f.open_cls_num > 0
    train, test = datasets(cfg)
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    batches = lambda n, bb: -(-n // bb)  # noqa: E731
    test_bs = bs * cfg.data.test_batch_scale
    data = train_forget.single_step_data(cfg, train, test, order)
    n_f, n_r = len(data.train_forget), len(data.train_remain)
    ev_f, ev_r, ev_o = (batches(len(d), test_bs) for d in (
        data.test_forget, data.test_remain, data.test_open))
    steps = cfg.num_epoch * batches(
        n_r if b.method == "retrain" else n_f + n_r, bs)
    imp = 0
    if b.method in ("ewc", "mas"):
        imp = batches(len(train_forget.importance_split(cfg, train, order)),
                      bs)
    evals = ev_f + (steps // cfg.ver_freq) * (ev_f + ev_r) + \
        ev_f + ev_r + ev_o
    depth = cfg.model.depth
    return {"attention_fwd": depth * (evals + micro * (steps + imp)),
            "attention_bwd": depth * micro * (steps + imp),
            "group_prox": 0, "group_norms": 0, "group_scale": 0}


def baseline_phase(base_argv=BASELINE_ARGV, runs=BASELINE_RUNS):
    """The baselines of ``runs`` at ``base_argv`` (by default every
    baseline through train_forget_cl (2 tasks) and --ewc and --retrain
    through train_forget, bf16) at the flagship's width on the card; each
    run's K1 counts against those its flags and data imply, every launch
    in the run's compute dtype, finite accuracies of every task (open and
    old-class ones included), both task snapshots and, for LIRF, a
    deployable model with no LoRA. Returns the launch counts summed over
    the runs."""
    total = {k: 0 for k in read_counts()}
    per_run = {}
    dtype = run_dtype(base_argv)
    t_phase = time.perf_counter()
    for cli, flag in runs:
        with tempfile.TemporaryDirectory() as out:
            argv = base_argv + [flag, "--outdir", out]
            single = cli == "train_forget"
            want = as_read((expected_single_step_launches if single else
                            expected_baseline_launches)(argv), argv)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            report = (train_forget if single else train_forget_cl).main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            snaps = [] if single else [
                load_params(os.path.join(out, "task-level",
                                         f"Backbone_task_{t}.pth"))
                for t in range(2)]
        what = f"{cli} {flag}"
        tasks = [report] if single else report
        if not single and [r["task"] for r in tasks] != [0, 1]:
            raise AssertionError(f"{what}: report of tasks {tasks}")
        for r in tasks:
            keys = ["forget_acc_before", "forget_acc", "remain_acc",
                    "open_acc"] + (["old_acc"] if r.get("task") == 1 else [])
            vals = [r[k] for k in keys] + [r.get("best_h",
                                                 r.get("best_H_mean"))]
            if not all(v is not None and math.isfinite(v) for v in vals):
                raise AssertionError(f"{what}: {r}")
        if flag == "--LIRF" and snaps[1]["lora"]:
            raise AssertionError("LIRF: the deployable model carries a LoRA")
        for snap in snaps:
            bad = [k for k, v in flatten_tree(snap).items()
                   if not torch.isfinite(v).all()]
            if bad:
                raise AssertionError(f"{what}: non-finite snapshot {bad}")
        if launches != want:
            raise AssertionError(f"{what} launched {launches}; its flags "
                                 f"and data imply {want}")
        per_run[what] = {"wall_s": wall, "launches": launches,
                         "accuracies": [{k: r.get(k) for k in (
                             "task", "forget_acc_before", "forget_acc",
                             "remain_acc", "open_acc", "old_acc")}
                             for r in tasks]}
        for k in total:
            total[k] += launches[k]
    tag = dtype_tag(dtype)
    print(f"baselines{tag} " + json.dumps({
        "recipe": f"{', '.join(f'{c} {f}' for c, f in runs)} (train_"
                  f"forget_cl: 2 tasks x 1 epoch), depth 2 dim 512 bs 48, "
                  f"80 + 20 classes, 10 open, 4 images per class, rank 0, "
                  f"{dtype} compute", "wall_s": time.perf_counter() - t_phase,
        "runs": per_run, "launches": total}), flush=True)
    return total


# The flagship integration tools (gslora_tpu_torch/tools/integration_*,
# the ports of the JAX package's scripts/integration_*.py) at the
# flagship's width and depth and their scripts' recipes, every epoch count
# cut to 1, bf16 compute, from one unsaturated base that the first tool
# pretrains for 1 epoch. The report keys are the JAX scripts' (the two
# GS-LoRA tools add "device").
INTEGRATION_CL_METHODS = ["scrub", "lwf", "lirf", "ewc"]
INTEGRATION_METHODS = ["gs_lora", "lwf", "der", "der_plus", "fdr", "lirf",
                       "ewc", "mas", "l2", "retrain", "replay", "scrub"]
SYNTHETIC_KEYS = {"pretrain_test_acc", "head", "noise", "forget_acc_before",
                  "forget_acc_after", "remain_acc_after", "best_H_mean",
                  "norm_list", "wallclock_s", "device"}
BASELINE_KEYS = {"pretrain_test_acc_unsat", "total_wallclock_s",
                 *(m + "_unsat" for m in INTEGRATION_METHODS)}
BASELINE_METHOD_KEYS = {"forget_acc_before", "forget_acc", "remain_acc",
                        "best_h", "wallclock_s"}
BASELINE_CL_KEYS = {"pretrain_test_acc", "num_tasks", "total_wallclock_s",
                    *INTEGRATION_CL_METHODS}
BASELINE_CL_TASK_KEYS = {"task", "forget_acc_before", "forget_acc",
                         "remain_acc", "open_acc", "best_h", "old_acc"}
# the JAX script's keys, and the port's base_change (the base's largest
# change over the run) and per task its wall and kernel launches
CONTINUAL_KEYS = {"pretrain_test_acc", "head", "noise", "boundary",
                  "few_shot", "device", "tasks", "wallclock_s",
                  "base_change"}
CONTINUAL_TASK_KEYS = {"task", "forget_before", "forget_after",
                       "remain_after", "old_acc_before", "old_acc", "best_H",
                       "wall_s", "launches"}
ACCURACY_KEYS = {"pretrain_test_acc", "pretrain_test_acc_unsat",
                 "forget_acc_before", "forget_acc", "remain_acc",
                 "forget_acc_after", "remain_acc_after", "forget_before",
                 "forget_after", "remain_after", "old_acc_before", "old_acc",
                 "open_acc"}
H_KEYS = {"best_h", "best_H", "best_H_mean"}


class Tee(io.StringIO):
    """Standard output that is also kept."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)

    def flush(self):
        self.out.flush()


def report_values(report, keys, where=""):
    """(where, value) of every entry under one of ``keys``, at any depth
    of ``report``."""
    if isinstance(report, list):
        for i, item in enumerate(report):
            yield from report_values(item, keys, f"{where}[{i}]")
    elif isinstance(report, dict):
        for k, v in report.items():
            if k in keys:
                yield f"{where}.{k}", v
            else:
                yield from report_values(v, keys, f"{where}.{k}")


def check_integration_report(name, report, file):
    """The report equals the file the tool wrote, carries the JAX
    script's keys, and every accuracy in it is finite and in [0, 100]
    (None only for the old-class accuracies of task 0 and the open ones,
    which these windows do not have), every H-mean finite."""
    if json.loads(json.dumps(report)) != file:
        raise AssertionError(f"{name}: the report written differs")
    bad = []
    if name == "integration_synthetic":
        bad += [report.keys() ^ SYNTHETIC_KEYS]
    elif name == "integration_baselines":
        bad += [report.keys() ^ BASELINE_KEYS]
        bad += [report[m + "_unsat"].keys() ^ BASELINE_METHOD_KEYS
                for m in INTEGRATION_METHODS]
    elif name == "integration_baselines_cl":
        bad += [report.keys() ^ BASELINE_CL_KEYS]
        bad += [report[m].keys() ^ {"tasks", "wallclock_s"}
                for m in INTEGRATION_CL_METHODS]
        # SCRUB's tasks also carry the SWA model's update count
        bad += [t.keys() ^ (BASELINE_CL_TASK_KEYS |
                            ({"n_averaged"} if m == "scrub" else set()))
                for m in INTEGRATION_CL_METHODS for t in report[m]["tasks"]]
        bad += [[t["task"] for t in report[m]["tasks"]] != [0, 1]
                for m in INTEGRATION_CL_METHODS]
    else:
        bad += [report.keys() ^ CONTINUAL_KEYS]
        bad += [t.keys() ^ CONTINUAL_TASK_KEYS for t in report["tasks"]]
        bad += [[t["task"] for t in report["tasks"]] != [0, 1, 2, 3]]
    if any(bad):
        raise AssertionError(f"{name}: report keys differ from the JAX "
                             f"script's: {[b for b in bad if b]}")
    for where, v in report_values(report, ACCURACY_KEYS):
        optional = where.endswith((".old_acc", ".old_acc_before",
                                   ".open_acc"))
        if v is None and optional:
            continue
        if v is None or not math.isfinite(v) or not 0.0 <= v <= 100.0:
            raise AssertionError(f"{name}: accuracy {where} = {v}")
    for where, v in report_values(report, H_KEYS):
        if v is None or not math.isfinite(v):
            raise AssertionError(f"{name}: H-mean {where} = {v}")


def check_continual_report(name, report, got, base_eval):
    """integration_continual's own measurements against the run's: its
    tasks' launches add up to the run's ``got`` less the base's eval
    (``base_eval`` K1 forwards), and the base ends moved by the folds
    under merge + reinit and as loaded under keep."""
    tasks = report["tasks"]
    summed = {k: sum(t["launches"][k] for t in tasks)
              for k in tasks[0]["launches"]}
    want = {**dict.fromkeys(summed, 0), **got,
            "attention_fwd": got["attention_fwd"] - base_eval}
    if summed != want:
        raise AssertionError(f"{name}: its tasks report {summed} launches; "
                             f"the run launched {want} in them")
    if (report["base_change"] == 0.0) != (report["boundary"] == "keep"):
        raise AssertionError(f"{name}: the base changed by "
                             f"{report['base_change']} under "
                             f"{report['boundary']}")


def tree_files(root):
    """Every file under ``root`` but Python's byte-code caches and the
    kernels' build directory."""
    out = set()
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", "_build",
                                                ".git")]
        out.update(os.path.relpath(os.path.join(d, f), root) for f in files)
    return out


def integration_single_launches(model, recipes, bs, train, test):
    """K1 launches tools/integration_baselines.run_methods implies for
    ``recipes`` on (train, test): the pretrain-accuracy eval; per method
    the forget eval before training, the training steps (a fused GS-LoRA
    forward with its backward (FFN LoRA: 'depth - 1') per remain batch;
    BASELINE_STEP per baseline step over the relabeled forget subset, the
    remain subset (Retrain), both (Replay), SCRUB's superepochs of 5
    forget and 10 remain passes), EWC's and MAS's importance over the
    remain subset (a forward and a backward a batch), and the forget and
    remain evals at the end (LIRF's after each epoch). 'depth' launches
    each; K2 and K3: 0."""
    batches = lambda n, b: -(-n // b)  # noqa: E731
    order = make_order_list(100, seed=1337)
    remain_tr, forget_tr = split_by_class_window(train, order, 0, 80, 80, 100)
    remain_te, forget_te = split_by_class_window(test, order, 0, 80, 80, 100)
    n_f = len(ratio_subset(forget_tr, 0.4, 1337))
    n_r = len(ratio_subset(remain_tr, 0.4, 1337))
    ev_f, ev_r = (batches(len(d), IB.EVAL_BS) for d in (forget_te,
                                                         remain_te))
    depth = model.depth
    fwd, bwd = depth * batches(len(test), IB.EVAL_BS), 0
    for m, r in recipes.items():
        n_ep, family = r["n_ep"], r["family"]
        if family == "gs_lora":
            steps = n_ep * batches(n_r, bs)
            # forget and remain evals before and after, at the loop's
            # test batch
            test_bs = bs * DataConfig().test_batch_scale
            evals = 2 * (batches(len(forget_te), test_bs) +
                         batches(len(remain_te), test_bs))
            fwd += depth * (evals + steps)
            bwd += (depth - 1) * steps
            continue
        if family == "scrub":
            se = r["baseline"]["scrub_superepoch"]
            steps = se * (5 * batches(n_f, bs) + 10 * batches(n_r, bs))
            evals = ev_f + se * (ev_f + ev_r) + ev_f + ev_r
        elif family == "lirf":
            steps = n_ep * batches(n_f, bs)
            evals = ev_f + n_ep * (ev_f + ev_r)
        else:
            n = {"retrain": n_r, "replay": n_f + n_r}.get(family, n_f)
            steps = n_ep * batches(n, bs)
            evals = ev_f + ev_f + ev_r  # ver_freq 10_000: no eval between
        imp = batches(n_r, bs) if m in ("ewc", "mas") else 0
        per_fwd, per_bwd = BASELINE_STEP[
            "reg" if m in REG_FAMILY else m]
        fwd += depth * (evals + per_fwd * steps + imp)
        bwd += depth * (per_bwd * steps + imp)
    return {"attention_fwd": fwd, "attention_bwd": bwd, "group_prox": 0,
            "group_norms": 0, "group_scale": 0}


_STAND_IN = []


def flagship_stand_in():
    """tools/flagship's unsaturated stand-in (2400 + 500 images at 112
    px), built once for the phases that use it."""
    if not _STAND_IN:
        _STAND_IN.extend(flagship.stand_in(
            flagship.model_config(unsaturated=True), flagship.noise(True)))
    return tuple(_STAND_IN)


def integration_phase():
    """The four flagship integration tools through their run functions on
    the card (tools/integration_synthetic --unsaturated, all twelve
    methods of tools/integration_baselines --unsaturated, the CL script's
    four default methods for 2 tasks, tools/integration_continual
    --unsaturated for its 4 tasks in each of its modes: merge + reinit,
    --boundary keep and --few_shot), every epoch count cut to 1, from one
    base at $PRETRAIN_CKPT in a temporary directory: the first tool
    pretrains it (1 epoch of the scripts' recipe), the others load it.
    Each run's K1 counts against those its recipe and data imply, K2 and
    K3 at 0, its report against the JAX script's keys with finite
    accuracies in [0, 100]; no file appears in the working tree. Prints
    each tool's wall and peak memory; returns the launch counts per
    tool."""
    t_phase = time.perf_counter()
    dev = str(DEV)
    cwd_files = tree_files(os.getcwd())
    model = flagship.model_config(unsaturated=True)
    train, test = flagship_stand_in()
    depth = model.depth
    batches = lambda n, b: -(-n // b)  # noqa: E731
    pre_steps = batches(len(train), flagship.PRETRAIN_BS)
    single = IB.with_epochs(IB.RECIPES, 1)
    cl_recipes = IB.with_epochs(ICL.RECIPES, 1)
    launches, summary = {}, {}
    saved_env = os.environ.get("PRETRAIN_CKPT")
    with tempfile.TemporaryDirectory() as root:
        os.environ["PRETRAIN_CKPT"] = os.path.join(
            root, "flagship_pretrained.pth")
        path = flagship.checkpoint_path(unsaturated=True)

        def base():
            return flagship.pretrained_base(model, train, 1, dev, path)

        def out(name):
            return os.path.join(root, name + ".json")

        synthetic_want = forget_run_launches(
            IS.run_config(model, True, dev, epochs=1),
            IS.forget_data(train, test))
        # the first tool also pretrains the base (remat: every block's
        # forward again in the backward; every parameter trains)
        synthetic_want["attention_fwd"] += depth * (
            batches(len(test), IS.EVAL_BS) + 2 * pre_steps)
        synthetic_want["attention_bwd"] += depth * pre_steps
        cl_wants = [baseline_cl_launches(ICL.run_config(
            m, cl_recipes[m], model, flagship.BS, 2, dev), train, test)
            for m in INTEGRATION_CL_METHODS]
        cl_want = {k: sum(w[k] for w in cl_wants) for k in cl_wants[0]}
        cl_want["attention_fwd"] += depth * batches(len(test), IB.EVAL_BS)
        continual_want, few_shot_want = (cl_launches(
            IC.run_config(model, few_shot, 4, dev, epochs=1), train, test)
            for few_shot in (False, True))
        for want in (continual_want, few_shot_want):
            want["attention_fwd"] += depth * batches(len(test), IC.EVAL_BS)
        runs = [
            ("integration_synthetic", synthetic_want, lambda: IS.run(
                base(), train, test, model, unsaturated=True,
                device=dev, epochs=1, out=out("integration_synthetic"))),
            ("integration_baselines", integration_single_launches(
                model, single, flagship.BS, train, test),
             lambda: IB.run_methods(
                 INTEGRATION_METHODS, base(), train, test, model,
                 flagship.BS, dev, recipes=single, suffix="_unsat",
                 out=out("integration_baselines"))),
            ("integration_baselines_cl", cl_want, lambda: ICL.run(
                INTEGRATION_CL_METHODS, base(), train, test, model,
                flagship.BS, dev, 2, recipes=cl_recipes,
                out=out("integration_baselines_cl"))),
            ("integration_continual", continual_want, lambda: IC.run(
                base(), train, test, model, unsaturated=True, num_tasks=4,
                device=dev, epochs=1, out=out("integration_continual"))),
            # keep: no fold between tasks (a fold launches no K1, so the
            # counts are merge + reinit's); few-shot: batch 4, 4 images a
            # class
            ("integration_continual_keep", dict(continual_want),
             lambda: IC.run(base(), train, test, model, unsaturated=True,
                            boundary="keep", num_tasks=4, device=dev,
                            epochs=1, out=out("integration_continual_keep"))),
            ("integration_continual_fs", few_shot_want, lambda: IC.run(
                base(), train, test, model, unsaturated=True, few_shot=True,
                num_tasks=4, device=dev, epochs=1,
                out=out("integration_continual_fs"))),
        ]
        try:
            for i, (name, want, fn) in enumerate(runs):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(Tee(sys.stdout)) as tee:
                    report = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = read_counts()
                said = tee.getvalue()
                expect = "pretrained + saved" if i == 0 else \
                    f"loaded pretrained {path}"
                if expect not in said:
                    raise AssertionError(f"{name}: no '{expect}' in its "
                                         f"output: the base is not shared")
                with open(out(name)) as fh:
                    check_integration_report(name, report, json.load(fh))
                if got != as_read(want):
                    raise AssertionError(f"{name} launched {got}; its recipe "
                                         f"and data imply {as_read(want)}")
                launches[name] = got
                summary[name] = {
                    "wall_s": wall,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": got}
                if name.startswith("integration_continual"):
                    check_continual_report(
                        name, report, got,
                        depth * batches(len(test), IC.EVAL_BS))
                    summary[name].update(
                        base_change=report["base_change"],
                        task_walls_s=[t["wall_s"] for t in report["tasks"]])
        finally:
            if saved_env is None:
                os.environ.pop("PRETRAIN_CKPT", None)
            else:
                os.environ["PRETRAIN_CKPT"] = saved_env
    new = tree_files(os.getcwd()) - cwd_files
    if new:
        raise AssertionError(f"integration tools wrote into the working "
                             f"tree: {sorted(new)}")
    print("integration " + json.dumps({
        "recipe": "tools/integration_* at their scripts' recipes, every "
                  "epoch count 1, depth 6 dim 512, bf16 compute, one "
                  "unsaturated base pretrained 1 epoch",
        "wall_s": time.perf_counter() - t_phase, "runs": summary}),
        flush=True)
    return launches


def base_split_phase():
    """tools/base_split once on the card: the recipe's arm (torch seed 0,
    bf16, remat, K1) pretrained 1 epoch at the flagship's width and depth,
    then one forget run of the unsaturated recipe cut to 1 epoch from that
    base. K1's counts of the whole call against those the recipe and data
    imply (as integration_phase derives them: 2 x depth forward and depth
    backward launches a pretrain step under remat, 'depth' a batch of the
    base's test and forget-class evals, forget_run_launches for the
    forget run), the report's pretrain and forget-run counts each against
    its part, K2 and K3 at 0; finite accuracies in [0, 100]. Prints the
    walls; returns the counts."""
    t0 = time.perf_counter()
    model = flagship.model_config(unsaturated=True)
    train, test = flagship_stand_in()
    data = IS.forget_data(train, test)
    depth = model.depth
    batches = lambda n, b: -(-n // b)  # noqa: E731
    steps = batches(len(train), flagship.PRETRAIN_BS)
    pre = [2 * depth * steps, depth * steps]
    forget = forget_run_launches(IS.run_config(model, True, str(DEV),
                                               epochs=1), data)
    evals = depth * (batches(len(test), IS.EVAL_BS) +
                     batches(len(data.test_forget), IS.EVAL_BS))
    want = {**forget,
            "attention_fwd": pre[0] + evals + forget["attention_fwd"],
            "attention_bwd": pre[1] + forget["attention_bwd"]}
    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "base_split.json")
        torch.cuda.synchronize()
        reset_counts()
        report = BS.run_split(model, train, test, arms=["torch0_bf16"],
                              seeds=1, pretrain_epochs=1, epochs=1,
                              device=str(DEV), out=out)
        torch.cuda.synchronize()
        got = read_counts()
        with open(out) as fh:
            if json.load(fh) != json.loads(json.dumps(report)):
                raise AssertionError("base_split: the report file differs "
                                     "from the report")
    base = report["bases"]["torch0_bf16"]
    (run,) = base["runs"]
    if got != as_read(want):
        raise AssertionError(f"base_split launched {got}; its recipe and "
                             f"data imply {as_read(want)}")
    if base["k1_launches"] != {"bfloat16": pre, "float32": [0, 0]}:
        raise AssertionError(f"base_split pretrain launched "
                             f"{base['k1_launches']}; it implies {pre}")
    if run["k1_launches"] != {"bfloat16": [forget["attention_fwd"],
                                           forget["attention_bwd"]],
                              "float32": [0, 0]}:
        raise AssertionError(f"base_split forget run launched "
                             f"{run['k1_launches']}; it implies {forget}")
    accs = [base["pretrain_test_acc"], base["forget_classes_acc"]] + [
        run[k] for k in ("forget_acc_before", *AS.METRICS)]
    if not all(0.0 <= a <= 100.0 for a in accs) or \
            not math.isfinite(base["final_loss"]):
        raise AssertionError(f"base_split: accuracies {accs}, final loss "
                             f"{base['final_loss']}")
    print("base_split " + json.dumps({
        "recipe": "tools/base_split, arm torch0_bf16, 1 pretrain epoch, "
                  "one forget run of 1 epoch, depth 6 dim 512",
        "card": report["card"], "pretrain_wall_s": base["pretrain_wall_s"],
        "forget_wall_s": run["wallclock_s"],
        "pretrain_test_acc": base["pretrain_test_acc"],
        "final_loss": base["final_loss"], "run": {
            k: run[k] for k in ("forget_acc_before", *AS.METRICS)},
        "launches": got, "wall_s": time.perf_counter() - t0}), flush=True)
    return got


def lirf_check(dtype=torch.bfloat16):
    """One LIRF step at flagship width (``dtype`` compute, dropout off,
    forget and remain batches of 8 with pad rows): the gradient of the
    student's low half, whose path runs back through the frozen teacher's
    upper blocks, with attention through the kernels (K1 of that dtype
    alone) against the plain attention, within MODEL_TOLS[dtype]."""
    model = ViTConfig(dropout=0.0, emb_dropout=0.0)
    lora = LoraConfig(rank=0)
    params = init_vit_params(torch.Generator().manual_seed(2), model, lora)
    teacher = detached(params["base"], DEV)
    gen = torch.Generator().manual_seed(3)
    streams = []
    for valid in (6, 8):
        x = torch.randn(8, 3, 112, 112, generator=gen)
        y = torch.randint(0, model.num_class, (8,), generator=gen)
        y[valid:] = -1
        streams += [x.to(DEV), y.to(DEV)]

    class Capture:
        """An optimizer that keeps the gradients and updates nothing."""

        def __init__(self):
            self.grads = []

        def update(self, leaves, grads, state, lr):
            self.grads = list(grads)

    half = model.depth // 2
    out, counts = {}, {}
    for impl in ("auto", "dpa"):
        m = dataclasses.replace(model, attn_impl=impl)
        student = _Node(low_slice(teacher, half)).to(DEV)
        state = LIRFState(student=student,
                          deposit_low=low_slice(teacher, half), opt_state={})
        opt = Capture()
        step = make_lirf_step(m, lora, opt, split=20, T=10.0, alpha=0.1,
                              compute_dtype=dtype)
        torch.cuda.synchronize()
        start = AS.k1_launches()
        _, metrics = step(state, teacher, *streams, 0.0)
        torch.cuda.synchronize()
        counts[impl] = AS.k1_launches(start)
        names = [n for n, _ in student.named_parameters()]
        out[impl] = dict(zip(names, opt.grads))
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"LIRF step ({impl}): {metrics}")
    errs = {n: rel_err(out["auto"][n], out["dpa"][n]) for n in out["dpa"]}
    name, tol = dtype_name(dtype), MODEL_TOLS[dtype]
    print(f"LIRF check, flagship width, {name} (student_low gradients "
          f"through the teacher's upper half, kernels vs their plain "
          f"version, relative L2, limit {tol:.3g}): " + json.dumps(errs),
          flush=True)
    depth = model.depth
    want = {k: [4 * depth, 2 * depth] if k == name else [0, 0]
            for k in counts["auto"]}
    if counts != {"auto": want, "dpa": dict.fromkeys(want, [0, 0])}:
        raise AssertionError(f"LIRF step launched {counts}")
    bad = {n: e for n, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"LIRF gradients through the kernels disagree "
                             f"with the plain attention: {bad}")


def baseline_bench(card, bs=48, steps=10):
    """One step of each baseline family at bs 48 (fp32 params, bf16
    compute, rank 0, dropout on, random weights and images): a reg step
    with two anchor terms, a DER++ step, a SCRUB min step and a LIRF
    step; ms/step from CUDA events around the steps, and each step's peak
    device memory."""
    cfg = config_from_args(build_parser().parse_args(BASELINE_ARGV))
    model, lora = cfg.model, cfg.lora
    gen = torch.Generator(device=DEV).manual_seed(0)
    size = model.image_size

    def batch(lo, hi):
        return (torch.randn(bs, 3, size, size, device=DEV, generator=gen),
                torch.randint(lo, hi, (bs,), device=DEV, generator=gen))

    def fresh(seed):
        return init_vit_params(torch.Generator().manual_seed(seed), model,
                               lora)

    def state_of(params, opt):
        return PretrainState.create(ViT(params, model, lora).to(DEV), opt,
                                    trains=trains)

    xf, yf = batch(80, 100)
    xr, yr = batch(10, 80)
    xr2, yr2 = batch(10, 80)
    b = cfg.baseline
    out = {}

    def reg():
        opt = make_optimizer(cfg.optim)
        state = state_of(fresh(0), opt)
        anchors = [detached(fresh(s), DEV) for s in (1, 2)]
        imps = [tree_map(torch.rand_like, a) for a in anchors]
        step = make_reg_step(model, lora, opt, compute_dtype=torch.bfloat16)
        return lambda: step(state, xf, yf, anchors, imps, 0.1, 1e-2, gen)

    def der_plus():
        opt = make_optimizer(cfg.optim)
        state = state_of(fresh(0), opt)
        teacher = detached(fresh(1), DEV)
        hp = {"lambda_der": b.der_lambda, "lambda_der_plus":
              b.der_plus_lambda}
        step = make_distill_step("der_plus", model, lora, opt, hp,
                                 compute_dtype=torch.bfloat16)
        return lambda: step(state, teacher, xf, yf, xr, yr, xr2, yr2, 1e-2,
                            gen)

    def scrub_min():
        opt = make_optimizer(OptimConfig(opt=b.sgda_optim,
                                         lr=b.sgda_learning_rate,
                                         momentum=b.sgda_momentum,
                                         weight_decay=b.sgda_weight_decay))
        state = state_of(fresh(0), opt)
        teacher, swa = (detached(fresh(s), DEV) for s in (1, 2))
        _, step = make_scrub_steps(model, lora, opt, b.kd_T,
                                   b.sgda_smoothing, b.sgda_gamma,
                                   b.sgda_alpha,
                                   compute_dtype=torch.bfloat16)
        return lambda: step(state, teacher, swa, xr, yr,
                            b.sgda_learning_rate, gen)

    def lirf():
        opt = make_optimizer(cfg.optim)
        teacher = detached(fresh(0), DEV)["base"]
        half = model.depth // 2
        student = _Node(low_slice(teacher, half)).to(DEV)
        state = LIRFState(student=student,
                          deposit_low=low_slice(teacher, half),
                          opt_state=opt.init(list(student.parameters())))
        step = make_lirf_step(model, lora, opt,
                              split=cfg.forget.per_forget_cls, T=b.lirf_T,
                              alpha=b.lirf_alpha,
                              compute_dtype=torch.bfloat16)
        return lambda: step(state, teacher, xf, yf, xr, yr, 1e-2, gen)

    depth = model.depth
    for name, setup, (per_fwd, per_bwd) in (
            ("reg_two_anchors", reg, BASELINE_STEP["reg"]),
            ("der_plus", der_plus, BASELINE_STEP["der_plus"]),
            ("scrub_min", scrub_min, BASELINE_STEP["scrub"]),
            ("lirf", lirf, BASELINE_STEP["lirf"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one = setup()

        def run(n, one=one):
            for _ in range(n):
                _, m = one()
            return m

        run(3)
        torch.cuda.synchronize()
        A.reset_launch_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = run(steps)
        end.record()
        torch.cuda.synchronize()
        loss = float(m["loss_total"] if "loss_total" in m else
                     m["loss_total_remain"])
        launches = (A.FWD_LAUNCHES, A.BWD_LAUNCHES)
        if not math.isfinite(loss) or launches != (
                per_fwd * depth * steps, per_bwd * depth * steps):
            raise AssertionError(f"{name} step: loss {loss}, launches "
                                 f"{launches}")
        out[name] = {"ms_per_step": start.elapsed_time(end) / steps,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "loss": loss, "k1_launches_per_step": [
                         per_fwd * depth, per_bwd * depth]}
        print(f"baseline_bench {name}: " + json.dumps(out[name]),
              flush=True)
        # traced right after its timing, then dropped
        profiler_phase([(f"baseline {name} step", run,
                         out[name]["ms_per_step"], 3)], card)
        del one, run
    torch.cuda.empty_cache()
    print("baseline_bench " + json.dumps({
        "recipe": "one step per family, fp32 params, bf16 compute, rank 0, "
                  "dropout 0.1, batches of 48 per stream, depth 6 dim 512",
        "card": card, **out}), flush=True)


# The eval and serving surface (slice 8), at the flagship width and depth:
# the base it evaluates, pretrained until CosFace's margin no longer hides
# its predictions (255 steps of bs 120; on the card the test accuracy
# jumps from 0 to 100 % by batch 140); scripts/test.sh's flags (-b 240,
# rank 8, -r that base) on the synthetic test split; the head-only probe
# at bs 48 with the main path's windows, 2 epochs; the serving bench's
# batches
EVAL_BASE_ARGV = ["-d", "synthetic", *MODEL_FLAGS, "--lora_rank", "0",
                  "-b", "120", "-e", "15", "--lr", "3e-4",
                  "--warmup-epochs", "1", "--compute_dtype", "bfloat16"]
EVAL_BASE_MIN_ACC = 90.0  # percent; chance is 1
EVAL_ARGV = ["-d", "synthetic", *MODEL_FLAGS, "--lora_rank", "8",
             "-b", "240"]
PROBE_ARGV = ["-d", "synthetic", *MODEL_FLAGS, "--lora_rank", "8",
              "-b", "48", "-e", "2", "--lr", "1e-3", "--warmup-epochs", "0",
              "--num_of_first_cls", "90", "--per_forget_cls", "10",
              "--compute_dtype", "bfloat16"]
VER_PAIRS = 128  # lfw.bin of 256 images: one embed batch per flip
VER_BATCH = 256  # evaluation/verification.perform_val's embed batch
SERVING_K = 20  # chained forwards per serving point
SERVING_LORA = LoraConfig(rank=8)


def eval_surface_shapes():
    """(batch x heads, tokens, scale) of the eval and serving surface:
    :func:`eval_cli_shapes` and the serving bench's batches of both
    models."""
    shapes = eval_cli_shapes()
    for name, batches in BI.BATCHES.items():
        m = BI.serving_model(name)
        shapes.update((b * m.heads, m.seq_len, attention_scale(m))
                      for b in batches)
    return shapes


def eval_cli_shapes():
    """(batch x heads, tokens, scale) of test_model's batch and the pair
    verification's, the probe's train batch, its ragged last one and its
    eval batch (in either compute dtype)."""
    shapes = set()
    cfg = config_from_args(build_parser().parse_args(EVAL_ARGV))
    m = cfg.model
    shapes.update((b * m.heads, m.seq_len, attention_scale(m))
                  for b in (cfg.data.batch_size, VER_BATCH))
    cfg = config_from_args(build_parser().parse_args(PROBE_ARGV))
    bs, m = cfg.data.batch_size, cfg.model
    n_train = len(backbone_probe.probe_data(cfg, *build_datasets(cfg))[0])
    batches = [bs, bs * cfg.data.test_batch_scale] + (
        [n_train % bs] if n_train % bs else [])
    shapes.update((b * m.heads, m.seq_len, attention_scale(m))
                  for b in batches)
    return shapes


def write_lfw_bin(root, cfg, pairs=VER_PAIRS):
    """<root>/lfw.bin: JPEG bytes of 2 x pairs synthetic test images at
    112x112, same class for odd pairs, another class for even ones (the
    .bin layout of tests/test_cli.py)."""
    from PIL import Image
    _, test = build_datasets(cfg)
    targets = np.asarray(test.targets)
    rng = np.random.RandomState(5)
    idx, issame = [], []
    for p in range(pairs):
        a = rng.randint(len(targets))
        same = bool(p % 2)
        idx += [a, rng.choice(np.flatnonzero((targets == targets[a]) ==
                                             same))]
        issame.append(same)
    bins = []
    for img in test.decode_batch(idx):
        # the blobs span about +-3: map them onto the pixel range
        u8 = np.clip((img.transpose(1, 2, 0) + 3.0) / 6.0 * 255.0, 0, 255)
        buf = io.BytesIO()
        Image.fromarray(u8.astype(np.uint8)).save(buf, format="JPEG",
                                                  quality=95)
        bins.append(buf.getvalue())
    with open(os.path.join(root, "lfw.bin"), "wb") as fh:
        pickle.dump((bins, issame), fh)


def expected_eval_launches(argv):
    """K1 launches test_model implies: 'depth' forward launches per padded
    test batch of -b, and per embed batch (VER_BATCH images) of each flip
    of each --ver_targets .bin; no backward."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    _, test = build_datasets(cfg)
    batches = lambda n, b: -(-n // b)  # noqa: E731
    fwd = batches(len(test), cfg.data.batch_size)
    for t in [t for t in args.ver_targets.split(",") if t]:
        with open(os.path.join(cfg.data.data_root, f"{t}.bin"), "rb") as fh:
            n = len(pickle.load(fh)[0])
        fwd += 2 * batches(n, VER_BATCH)
    return {"attention_fwd": cfg.model.depth * fwd, "attention_bwd": 0,
            "group_prox": 0, "group_norms": 0, "group_scale": 0}


def expected_probe_launches(argv):
    """K1 launches backbone_probe implies: 'depth' forward launches per
    training batch (ragged last one included) and per padded forget and
    remain test batch after each epoch; no backward, since nothing
    upstream of the head trains (the JAX package takes the whole
    gradient and zeroes it)."""
    cfg = config_from_args(build_parser().parse_args(argv))
    batches = lambda n, b: -(-n // b)  # noqa: E731
    bs = cfg.data.batch_size
    test_bs = bs * cfg.data.test_batch_scale
    n_train, n_f, n_r = map(len, backbone_probe.probe_data(
        cfg, *build_datasets(cfg)))
    per_epoch = batches(n_train, bs) + batches(n_f, test_bs) + \
        batches(n_r, test_bs)
    return {"attention_fwd": cfg.model.depth * cfg.num_epoch * per_epoch,
            "attention_bwd": 0, "group_prox": 0, "group_norms": 0,
            "group_scale": 0}


def run_counted(fn, argv, want, what):
    """fn(argv) with the launch counts read around it, held to ``want``
    (derived, :func:`as_read`: every K1 launch on the kernel of argv's
    compute dtype); returns (result, launches, wall seconds)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = as_read(want, argv)
    if launches != want:
        raise AssertionError(f"{what} launched {launches}; the path "
                             f"implies {want}")
    return out, launches, wall


def eval_base(root):
    """train_pretrain with EVAL_BASE_ARGV, counted like the pretrain
    phase's runs: its final test accuracy at least EVAL_BASE_MIN_ACC.
    Returns (its last checkpoint, {"eval_base": launches})."""
    out = os.path.join(root, "base")
    report, _, launches = run_pretrain_cli(EVAL_BASE_ARGV + ["--outdir", out],
                                           "eval_base")
    if report["final_test_acc"] < EVAL_BASE_MIN_ACC:
        raise AssertionError(f"eval_base: {report} (at least "
                             f"{EVAL_BASE_MIN_ACC})")
    ckpts = [f for f in os.listdir(out) if f.startswith("Backbone_VIT_")]
    last = max(ckpts, key=lambda f: int(f.split("_Batch_")[1].split("_")[0]))
    return os.path.join(out, last), {"eval_base": launches}


def eval_reference(argv, test, per_class=True):
    """(test accuracy, {class: accuracy}) of argv's checkpoint through
    engine/evaluate.eval_accuracy on the card in argv's compute dtype, in
    padded batches of -b: the whole split, and (``per_class``) each
    class's images alone, else an empty dict."""
    cfg = config_from_args(build_parser().parse_args(argv))
    params = detached(build_params(cfg), DEV)
    step = make_eval_step(cfg.model, cfg.lora, compute_dtype=getattr(
        torch, cfg.compute_dtype))

    def acc(ds):
        return eval_accuracy(step, params, BatchLoader(
            ds, cfg.data.batch_size, shuffle=False, prefetch=0,
            mask_padding=True))

    targets = np.asarray(test.targets)
    return acc(test), {str(c): acc(SubsetDataset(
        test, np.flatnonzero(targets == c))) for c in np.unique(targets)
        if per_class}


def test_model_phase(ckpt, root, dtype="bfloat16"):
    """cli.test_model with scripts/test.sh's flags on the eval base in
    ``dtype`` compute: the default product with --ver_targets lfw (a
    seeded lfw.bin), then --gemm_impl int8.
    Finite accuracies over every test image once (num_samples),
    report.json and class_accuracy.txt, the ROC artifact; the default
    product's test_acc at least EVAL_BASE_MIN_ACC and equal to
    eval_reference's, in bf16 its class_acc too, class by class (the same
    kernels at the same batch shape: padding and the ragged last batch
    must not move a prediction); int8 within 2.0 points of the default
    product (the bound of the JAX package's tests/test_cli.py); K1 counts
    as derived, every launch in ``dtype``. Returns the counts by run."""
    tag = dtype_tag(dtype)
    eval_argv = EVAL_ARGV + ["--compute_dtype", dtype]
    write_lfw_bin(root, config_from_args(build_parser().parse_args(
        EVAL_ARGV)))
    _, test = build_datasets(config_from_args(build_parser().parse_args(
        EVAL_ARGV)))
    runs = {}
    for name, extra in (("test_model" + tag, ["--data_root", root,
                                              "--ver_targets", "lfw"]),
                        ("test_model_int8" + tag, ["--gemm_impl", "int8"])):
        out = os.path.join(root, name)
        argv = eval_argv + ["-r", ckpt, "--outdir", out] + extra
        report, launches, wall = run_counted(
            test_model.main, argv, expected_eval_launches(argv), name)
        vals = [report["test_acc"]] + ([report["lfw_verification_acc"]]
                                       if "--ver_targets" in extra else [])
        files = ["report.json", "class_accuracy.txt"] + (
            [f for f in os.listdir(out) if f.startswith("lfw_ROC_Curve")]
            if "--ver_targets" in extra else [])
        if not all(math.isfinite(v) for v in vals) or len(files) < 2 + (
                "--ver_targets" in extra) or not all(
                os.path.exists(os.path.join(out, f)) for f in files) or \
                report["num_samples"] != len(test):
            raise AssertionError(f"{name}: {report}, files {files}, "
                                 f"{len(test)} test images")
        with open(os.path.join(out, "report.json")) as fh:
            class_acc = json.load(fh)["class_acc"]
        runs[name] = {"wall_s": wall, "launches": launches, **report,
                      "class_acc": class_acc}
    default = runs["test_model" + tag]
    # class by class once, in bf16 (100 evals of one class each)
    ref_acc, ref_class = eval_reference(eval_argv + ["-r", ckpt], test,
                                        per_class=not tag)
    acc = default["test_acc"]
    if acc < EVAL_BASE_MIN_ACC or acc != ref_acc or \
            not tag and default["class_acc"] != ref_class:
        wrong = {c: (a, ref_class.get(c)) for c, a in
                 default["class_acc"].items() if ref_class.get(c) != a}
        raise AssertionError(f"test_model{tag}: test_acc {acc} "
                             f"where eval_accuracy reads {ref_acc} (at "
                             f"least {EVAL_BASE_MIN_ACC}); classes that "
                             f"differ {wrong}")
    gap = abs(runs["test_model_int8" + tag]["test_acc"] - acc)
    if gap > 2.0:
        raise AssertionError(f"test_model{tag}: int8 {gap:.2f} points from "
                             f"the default product (bound 2.0)")
    for run in runs.values():
        accs = run.pop("class_acc").values()
        run["class_acc_min"] = min(accs)
    print(f"test_model{tag} " + json.dumps({**runs, "eval_accuracy":
                                            ref_acc}), flush=True)
    return {k: v["launches"] for k, v in runs.items()}


def projection_shapes(model, bs):
    """(name, rows, K, N) of every projection GEMM of ``model`` at batch
    ``bs``: the patch embedding and each block's qkv, attn_out, fc1,
    fc2."""
    t, d, inner = model.seq_len, model.dim, model.inner_dim
    return [("patch", bs * model.num_patches, model.patch_dim, d),
            ("qkv", bs * t, d, 3 * inner), ("attn_out", bs * t, inner, d),
            ("fc1", bs * t, d, model.mlp_dim),
            ("fc2", bs * t, model.mlp_dim, d)]


def int8_check(ckpt):
    """W8A8 on the card: int8_linear at every projection shape of both
    models against its float64 twin (ops/quant.quant_mismatch, 1e-6
    relative), with the times of int8_linear, its int8 product alone and
    the bf16 product at the same shape; then each model's int8 eval
    against its bf16 eval (tests/test_quant.py's envelope: embedding
    cosine > 0.99, top-1 agreement >= 0.9): the flagship from the
    pretrain phase's checkpoint on 240 test images, ViT-B/16 at full size
    with random weights on 4 images."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    flagship = config_from_args(build_parser().parse_args(EVAL_ARGV)).model
    shapes = {}
    for label, model, bs in (("p8s8", flagship, 240),
                             ("b16", ViTConfig.vit_b16(), 64)):
        for name, rows, k, n in projection_shapes(model, bs):
            x = torch.randn(rows, k, device=DEV, generator=gen).to(
                torch.bfloat16)
            w = torch.randn(k, n, device=DEV, generator=gen) * k ** -0.5
            got = Q.int8_linear(x, w)
            want = Q.int8_linear_reference(x, w)
            torch.cuda.synchronize()
            stats = Q.quant_mismatch(got, want)
            if not stats["ok"]:
                raise AssertionError(f"int8_linear at {label} {name} "
                                     f"({rows}, {k}, {n}): {stats}")
            qx, _ = Q.quantize_per_tensor(x)
            qw, _ = Q.quantize_per_channel(w)
            wb = w.to(torch.bfloat16)
            shapes[f"{label} {name} {rows}x{k}x{n}"] = {
                "max_rel": stats["max_rel"],
                "int8_linear_ms": cuda_ms(lambda: Q.int8_linear(x, w),
                                          iters=20),
                "int_mm_ms": cuda_ms(lambda: Q.int8_matmul(qx, qw),
                                     iters=20),
                "bf16_ms": cuda_ms(lambda: x @ wb, iters=20)}
    print("int8 projections (vs float64 twin, times) " +
          json.dumps(shapes), flush=True)

    cfg = config_from_args(build_parser().parse_args(
        EVAL_ARGV + ["-r", ckpt]))
    _, test = build_datasets(cfg)
    x = torch.from_numpy(test.decode_batch(list(range(240))))
    b16 = ViTConfig.vit_b16()
    b16_params = init_vit_params(torch.Generator().manual_seed(1), b16,
                                 LoraConfig(rank=8))
    size = b16.image_size
    xb = torch.randn(4, 3, size, size,
                     generator=torch.Generator().manual_seed(2))
    envelope = {}
    for label, model, lora, params, images in (
            ("p8s8_pretrained", cfg.model, cfg.lora, build_params(cfg), x),
            ("b16_random", b16, LoraConfig(rank=8), b16_params, xb)):
        params = detached(params, DEV)
        out = {}
        with torch.inference_mode():
            for impl in ("default", "int8"):
                m = dataclasses.replace(model, gemm_impl=impl)
                y = torch.zeros(images.shape[0], dtype=torch.long,
                                device=DEV)
                logits, emb = vit_apply(params, images.to(DEV), y, m, lora,
                                        compute_dtype=torch.bfloat16)
                out[impl] = (logits.float(), emb.float())
        cos = torch.nn.functional.cosine_similarity(out["default"][1],
                                                    out["int8"][1])
        agree = (out["default"][0].argmax(1) ==
                 out["int8"][0].argmax(1)).float().mean()
        envelope[label] = {"images": images.shape[0],
                           "cos_min": float(cos.min()),
                           "top1_agreement": float(agree)}
        if not (envelope[label]["cos_min"] > 0.99 and
                envelope[label]["top1_agreement"] >= 0.9):
            raise AssertionError(f"int8 eval of {label} against bf16: "
                                 f"{envelope[label]}")
    print("int8 eval vs bf16 " + json.dumps(envelope), flush=True)


def probe_phase(ckpt, root, dtype="bfloat16"):
    """cli.backbone_probe from the pretrain phase's checkpoint in
    ``dtype`` compute, 2 epochs: backbone frozen, head trained, finite
    curves, K1 counts as derived (no backward), every launch in
    ``dtype``."""
    what = "backbone_probe" + dtype_tag(dtype)
    argv = in_dtype(PROBE_ARGV, dtype) + [
        "-r", ckpt, "--outdir", os.path.join(root, what)]
    report, launches, wall = run_counted(
        backbone_probe.main, argv, expected_probe_launches(argv), what)
    curves = report["forget_acc_curve"] + report["remain_acc_curve"]
    if not (report["backbone_frozen"] and report["head_trained"] and
            len(curves) == 4 and all(math.isfinite(v) for v in curves)):
        raise AssertionError(f"{what}: {report}")
    print(f"{what} " + json.dumps({"wall_s": wall, **report,
                                   "launches": launches}), flush=True)
    return launches


def recovery_phase(root, steps=10, cut=6):
    """Mid-task recovery at flagship width (dropout 0, rank-8 FFN LoRA,
    AdamW, bf16 compute, forget and remain batches of 24): ``steps``
    forget steps straight, against ``cut`` steps, save_train_state,
    restore_train_state into a fresh state, the rest. The LoRA and the
    optimizer moments must agree within 5e-3 (the trained-LoRA tolerance
    of tests/test_training_parity.py); prints whether they are bitwise
    equal."""
    model = ViTConfig(dropout=0.0, emb_dropout=0.0)
    lora = LoraConfig(rank=8)
    params = init_vit_params(torch.Generator().manual_seed(0), model, lora)
    opt = make_optimizer(OptimConfig(lr=1e-2))
    step = make_forget_step(model, lora, ForgetConfig(bnd=110.0),
                            opt, compute_dtype=torch.bfloat16,
                            use_prototype=False)
    gen = torch.Generator(device=DEV).manual_seed(0)
    size = model.image_size
    xf, xr = (torch.randn(24, 3, size, size, device=DEV, generator=gen)
              for _ in range(2))
    yf = torch.randint(90, 100, (24,), device=DEV, generator=gen)
    yr = torch.randint(0, 90, (24,), device=DEV, generator=gen)
    protos = torch.zeros(model.num_class, model.dim, device=DEV)
    sc = {"beta": 0.15, "alpha": 0.01, "lr": 1e-2, "bnd": 110.0,
          "bnd_pro": 18.0, "w_pro_f": 0.0, "w_pro_r": 0.0}

    def fresh():
        return ForgetState.create(ViT(params, model, lora).to(DEV), opt)

    def run(state, start, end):
        for i in range(start, end):
            state, _ = step(state, xf, yf, xr, yr, protos, sc,
                            torch.Generator(device=DEV).manual_seed(i))
        return state

    torch.cuda.synchronize()
    reset_counts()
    ref = run(fresh(), 0, steps)
    path = os.path.join(root, "train_state.pth")
    save_train_state(path, run(fresh(), 0, cut))
    final = run(restore_train_state(path, fresh()), cut, steps)
    torch.cuda.synchronize()
    launches = read_counts()
    depth = model.depth
    want = as_read({"attention_fwd": 2 * depth * 2 * steps,
                    "attention_bwd": 2 * (depth - 1) * 2 * steps,
                    "group_prox": 0, "group_norms": 0, "group_scale": 0})
    if launches != want:
        raise AssertionError(f"recovery launched {launches}; the path "
                             f"implies {want}")

    def diff(a, b):
        return max(float((x.detach().float() - y.detach().float()).abs()
                         .max()) for x, y in zip(a, b))

    got = {"lora": diff(final.trainable_params(), ref.trainable_params()),
           "mu": diff(final.opt_state["mu"], ref.opt_state["mu"]),
           "nu": diff(final.opt_state["nu"], ref.opt_state["nu"])}
    bitwise = all(torch.equal(x, y) for x, y in zip(
        final.trainable_params() + final.opt_state["mu"] +
        final.opt_state["nu"], ref.trainable_params() +
        ref.opt_state["mu"] + ref.opt_state["nu"]))
    if final.step != ref.step or max(got.values()) > 5e-3:
        raise AssertionError(f"recovery: max abs differences {got}, steps "
                             f"{final.step} / {ref.step}")
    print("recovery " + json.dumps({
        "steps": steps, "saved_after": cut, "max_abs_diff": got,
        "bitwise": bitwise, "launches": launches}), flush=True)
    return launches


def keep_phase():
    """run_continual_forgetting(boundary="keep") with the continual
    phase's config (CL_ARGV: 2 tasks x 1 epoch, prox, EMA): task 1 starts
    from task 0's final LoRA, K2 once per training step, K1 counts those
    of the merge_reinit run (expected_cl_launches)."""
    cfg = config_from_args(build_parser().parse_args(CL_ARGV))
    train, test = build_datasets(cfg)
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    params = build_params(cfg)
    starts = []
    real = CONT.run_forget_training

    def recorded(cfg, params, *args, **kwargs):
        starts.append(host_tree(params["lora"]))
        return real(cfg, params, *args, **kwargs)

    CONT.run_forget_training = recorded
    try:
        out, launches, wall = run_counted(
            lambda argv: CONT.run_continual_forgetting(
                cfg, params, train, test, order, boundary="keep"),
            CL_ARGV, expected_cl_launches(CL_ARGV), "cl_keep")
    finally:
        CONT.run_forget_training = real
    end0 = host_tree(out.tasks[0].result.state.params["lora"])
    assert_same(starts[1], end0, "keep boundary: task 1's starting LoRA")
    for t in out.tasks:
        r = t.result
        vals = [r.forget_acc_before, r.forget_acc, r.remain_acc, r.best_h]
        if t.task:
            vals += [t.old_acc, t.old_acc_before]
        if not all(v is not None and math.isfinite(v) for v in vals):
            raise AssertionError(f"cl_keep: task {t.task}: {vals}")
    print("cl_keep " + json.dumps({
        "wall_s": wall, "tasks": [
            {"task": t.task, "forget_acc_before": t.result.forget_acc_before,
             "forget_acc": t.result.forget_acc,
             "remain_acc": t.result.remain_acc,
             "old_acc_before": t.old_acc_before, "old_acc": t.old_acc}
            for t in out.tasks], "launches": launches}), flush=True)
    return launches


def serving_phase(card):
    """tools/bench_inference's points on the card: ViT-P8S8 at 64 / 128 /
    240 / 512 and ViT-B/16 at 32 / 64 / 128 / 256, bf16 and int8, random
    bf16 parameters, merged LoRA, SERVING_K chained forwards each;
    images/s, ms per batch, mfu against the card's dense peak, peak
    memory; K1 'depth' launches per forward. Then five forwards of each
    P8S8 bs-240 point traced (profiler_phase)."""
    launches = dict.fromkeys(read_counts(), 0)
    traced = []
    for name in ("p8s8", "b16"):
        params = BI.serving_params(BI.serving_model(name), SERVING_LORA,
                                   DEV)
        for int8 in (False, True):
            model = BI.serving_model(name, int8)
            for bs in BI.BATCHES[name]:
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                reset_counts()
                r = BI.measure(model, SERVING_LORA, bs, SERVING_K,
                               BI.FWD_GFLOP[name], DEV, params=params)
                torch.cuda.synchronize()
                got = read_counts()
                if got != as_read({"attention_fwd": model.depth * (
                        SERVING_K + 1), "attention_bwd": 0, "group_prox": 0,
                        "group_norms": 0, "group_scale": 0}) or \
                        not math.isfinite(r["images_per_sec"]):
                    raise AssertionError(f"serving {name} {bs}: {r}, "
                                         f"launches {got}")
                for k, v in got.items():
                    launches[k] += v
                print("serving " + json.dumps({
                    "model": name, "gemm_impl": model.gemm_impl, **r,
                    "card": card}), flush=True)
                if name == "p8s8" and bs == 240:
                    traced.append((model, params, r["ms_per_batch"]))
        del params
    for model, params, ms in traced:
        x = torch.randn(240, 3, model.image_size, model.image_size,
                        device=DEV)
        y = torch.zeros(240, dtype=torch.long, device=DEV)

        def run(n, model=model, params=params, x=x, y=y):
            with torch.inference_mode():
                for _ in range(n):
                    out = vit_apply(params, x, y, model, SERVING_LORA,
                                    compute_dtype=torch.bfloat16,
                                    lora_apply="merged")
            return out

        profiler_phase([(f"serving P8S8 bs 240 {model.gemm_impl}", run, ms,
                         5)], card)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# native host IO (slice 7)
# ---------------------------------------------------------------------------

# The face folder of the native phase: 112x112 JPEGs, 48 train and 4 test
# images in each of 100 classes; one epoch of the folder pretrain is 10
# steps of bs 480.
FACE_FOLDER = {"classes": 100, "train": 48, "test": 4, "size": 112}
DECODE_BATCH = 480
# --data_root and --outdir are appended
FOLDER_PRETRAIN_ARGV = ["-d", "casia100", *MODEL_FLAGS, "--lora_rank", "0",
                        "-b", "480", "-e", "1", "--lr", "3e-4",
                        "--compute_dtype", "bfloat16"]


def face_folder(root, seed=0):
    """A seeded face folder under root: train/ and test/ with one folder
    per class (a smooth pattern of the class plus noise, JPEG quality 90),
    and train.rec / train.idx of the train images' bytes and labels.
    Returns the .rec path."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    size = FACE_FOLDER["size"]
    records = []
    for c in range(FACE_FOLDER["classes"]):
        base = np.asarray(Image.fromarray(
            rng.randint(0, 256, (14, 14, 3)).astype(np.uint8)).resize(
                (size, size), Image.BILINEAR), np.int16)
        for split in ("train", "test"):
            folder = os.path.join(root, split, f"{c:03d}")
            os.makedirs(folder)
            for i in range(FACE_FOLDER[split]):
                img = np.clip(base + rng.randint(-24, 25, base.shape), 0, 255)
                buf = io.BytesIO()
                Image.fromarray(img.astype(np.uint8)).save(
                    buf, format="JPEG", quality=90)
                with open(os.path.join(folder, f"{i:03d}.jpg"), "wb") as fh:
                    fh.write(buf.getvalue())
                if split == "train":
                    records.append((np.asarray([float(c)], np.float32),
                                    buf.getvalue()))
    rec = os.path.join(root, "train.rec")
    # record 0 names [start, end) of the identity records: none follow
    n = float(len(records) + 1)
    write_recordio(rec, records, header0=np.asarray([n, n], np.float32))
    return rec


def host_ms(fn, reps=3):
    """Median host ms of fn() over reps calls, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def native_build():
    """Both native libraries built from csrc/*.cpp; seconds per library,
    None for a decoder that cannot build here, and why."""
    out = {}
    for name in ("recordio", "imagedec"):
        t0 = time.perf_counter()
        lib = native.load_library(name)
        out[name] = time.perf_counter() - t0 if lib is not None else None
    reason = native.unavailable_reason("imagedec")
    print("native build " + json.dumps({
        "seconds": out, "threads": native.default_threads(),
        "imagedec_unavailable": reason}), flush=True)
    return reason


def native_phase(card, synthetic_ms):
    """The native host IO on the card's host: the decoder against PIL and
    the record reader against the Python reader over the whole face
    folder, both to the bit; host ms per 480-image batch of the four
    decode paths; then the pretrain CLI fed from the folder for one epoch
    (K1's counts derived), untraced for its images/s and traced for the
    device's busy share over the epoch, beside the synthetic-data step of
    pretrain_bench (``synthetic_ms``, same run)."""
    reason = native_build()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rec_path = face_folder(root)
        folder = ImageFolderDataset(os.path.join(root, "train"),
                                    image_size=FACE_FOLDER["size"])
        faces = FaceRecordDataset(rec_path, rand_mirror=False)
        n = len(folder)
        print(f"native: wrote {n} train and "
              f"{FACE_FOLDER['classes'] * FACE_FOLDER['test']} test JPEGs "
              f"and a .rec of the train images in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        threads = native.default_threads()
        if reason is None:
            size = FACE_FOLDER["size"]
            out, ok = native.decode_image_batch(
                [p for p, _ in folder.samples], size, size, threads=threads)
            bad = [i for i in range(n) if not ok[i] or not np.array_equal(
                out[i], folder.decode(i))]
            if bad:
                raise AssertionError(f"native decode differs from PIL at "
                                     f"{len(bad)} images, e.g. {bad[:5]}")
        reader = native.NativeRecordReader(rec_path, n_threads=threads)
        keys = [k for k, _ in faces.samples]
        labels, bodies = reader.read_batch(
            [reader._key_to_pos[k] for k in keys])
        with open(rec_path, "rb") as fh:
            for k, label, body in zip(keys, labels, bodies):
                want_labels, want_body = read_record(fh, faces.idx[k])
                if body != want_body or label != want_labels[0]:
                    raise AssertionError(f"native record read differs from "
                                         f"the Python reader at key {k}")
        reader.close()
        idxs = [int(i) for i in
                np.random.RandomState(1).permutation(n)[:DECODE_BATCH]]
        if not np.array_equal(faces.decode_batch(idxs),
                              np.stack([faces.decode(i) for i in idxs])):
            raise AssertionError("FaceRecordDataset.decode_batch differs "
                                 "from the Python reader's images")
        times = {
            "folder_decode_batch": host_ms(lambda: folder.decode_batch(idxs)),
            "folder_pil_per_image": host_ms(
                lambda: np.stack([folder.decode(i) for i in idxs])),
            "rec_decode_batch_native": host_ms(
                lambda: faces.decode_batch(idxs)),
            "rec_python_reader": host_ms(
                lambda: np.stack([faces.decode(i) for i in idxs])),
        }
        print("native decode " + json.dumps({
            "batch": DECODE_BATCH, "card": card, "host_ms": times,
            "folder_decode_batch_route": "PIL per image (decoder "
            "unavailable)" if reason else "native",
            "equal_to_pil": "not checked here: " + reason if reason
            else n, "records_equal": n}), flush=True)

        argv = FOLDER_PRETRAIN_ARGV + ["--data_root", root]
        out = os.path.join(root, "out")
        _, _, launches = run_pretrain_cli(argv + ["--outdir", out],
                                          "train_pretrain_folder")
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            rate = [json.loads(line)["images_per_sec"] for line in fh
                    if "images_per_sec" in line][0]
        with tempfile.TemporaryDirectory() as tdir:
            with trace(tdir):
                train_pretrain.main(argv + ["--outdir",
                                            os.path.join(root, "traced")])
            summary = device_summary(os.path.join(tdir, "trace.json"),
                                     window="epoch", top=5, gaps=5,
                                     families=FAMILIES)
    step_ms = 1e3 * DECODE_BATCH / rate
    print("folder_pretrain " + json.dumps({
        "recipe": "train_pretrain -d casia100 from a 112x112 JPEG folder, "
                  "bs 480, 10 steps, depth 6, bf16 compute",
        "card": card, "epoch_images_per_sec": rate,
        "epoch_ms_per_step": step_ms,
        "synthetic_step_ms": synthetic_ms,
        "host_share_of_epoch": 1.0 - synthetic_ms / step_ms,
        "busy_share_traced_epoch": summary["busy_share"],
        "traced_epoch_ms": summary["window_ms"],
        "idle_gaps": summary["idle_gaps"],
        "families_ms": summary["families_ms"]}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# data parallelism: two ranks on the one card (slice 7)
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_FORGET_ARGV = ["-d", "synthetic", *CUT_MODEL_FLAGS, "--lora_rank", "8",
                  "-b", "48", "-e", "5", "--lr", "1e-2", "--warmup-epochs",
                  "0", "--BND", "110", "--beta", "0.15", "--alpha", "0.01",
                  "--alpha_epoch", "0", "--compute_dtype", "bfloat16"]
DP_CL_ARGV = ["-d", "synthetic", *CUT_MODEL_FLAGS, "--lora_rank", "8", "-b",
              "48", "-e", "1", "--lr", "1e-2", "--warmup-epochs", "0",
              "--BND", "110", "--alpha", "0.01", "--one_stage",
              "--num_tasks", "2", "--num_of_first_cls", "90",
              "--per_forget_cls", "10", "--structure_mode", "prox",
              "--cl_beta_list", "0.15", "0.2", "--average_weight",
              "--ema_epoch", "0", "--compute_dtype", "bfloat16"]
DP_PRETRAIN_ARGV = ["-d", "synthetic", *CUT_MODEL_FLAGS, "--lora_rank",
                    "0", "-b", "480", "-e", "2", "--lr", "3e-4",
                    "--compute_dtype", "bfloat16"]
# path -> (CLI module, argv, --grad_accum of each rank); the one-process
# reference runs --grad_accum DP_WORLD times that, so its micro-batches
# are the ranks' rows: the same rows at the same shapes through the same
# kernels, and the same fp32 sums of the masked sums and the gradients
# (added as a tree, utils/trees.PairwiseSum: each rank's total is one
# subtree, the all_reduce adds the last pair).
# The baselines run the baseline phase's flags (BASELINE_ARGV:
# run_cl_forget_open.sh's windows, bs 48, 1 epoch, 4 images per class, 1
# SCRUB superepoch), one runner family each through train_forget_cl and
# EWC through train_forget.
DP_RUNS = {"train_forget_dp": (train_forget, DP_FORGET_ARGV, 1),
           "train_forget_cl_dp": (train_forget_cl, DP_CL_ARGV, 1),
           "train_pretrain_dp": (train_pretrain, DP_PRETRAIN_ARGV, 1),
           "train_pretrain_dp_accum": (train_pretrain, DP_PRETRAIN_ARGV, 2),
           **{f"train_forget_cl_{flag.lstrip('-').lower()}_dp":
              (train_forget_cl, BASELINE_ARGV + [flag], 1)
              for flag in ("--ewc", "--DER_plus", "--SCRUB", "--LIRF")},
           "train_forget_ewc_dp": (train_forget, BASELINE_ARGV + ["--ewc"],
                                   1)}
DP_TIMEOUT_S = 600
# Final parameters of two ranks against one process: the JAX suite's fp32
# tolerance (tests/test_mesh_loop.py:79-80). The training runs the same
# bf16 GEMMs and kernels on the same rows either way and adds the fp32
# partials in one order, so it holds to the bit (a sequential sum of four
# micro-batches against two ranks' pairs moved the pretrain with
# --grad_accum 2 by 1.8e-5 through Adam in 10 steps, before the tree).
DP_RTOL, DP_ATOL = 1e-4, 1e-5


def is_baseline(argv):
    """Whether ``argv`` runs a baseline (not GS-LoRA)."""
    return config_from_args(build_parser().parse_args(
        argv)).baseline.method != "gs_lora" and "--one_stage" not in argv


def dp_expected(name, accum):
    """K1 and K2 launches of one rank (or of the one-process reference),
    from the flags with --grad_accum ``accum``."""
    module, argv, _ = DP_RUNS[name]
    argv = argv + ["--grad_accum", str(accum)]
    if is_baseline(argv):
        return (expected_single_step_launches if module is train_forget
                else expected_baseline_launches)(argv)
    if module is train_forget:
        fwd, bwd = expected_launches(argv)
        return {"attention_fwd": fwd, "attention_bwd": bwd,
                "group_prox": 0, "group_norms": 0, "group_scale": 0}
    if module is train_forget_cl:
        return expected_cl_launches(argv)
    return expected_pretrain_launches(argv)[0]


def dp_run(name, accum, dp):
    """DP_RUNS[name] through its CLI in this process, dropout off (each
    rank draws its own masks), --grad_accum ``accum``, ``--dp`` if asked;
    launch counts held to dp_expected. Returns the report, the final
    parameters (host fp32, flat), the eval history, the launches, the
    wall seconds and the peak of the card's memory this process
    allocated."""
    module, argv, _ = DP_RUNS[name]
    argv = argv + ["--grad_accum", str(accum), "--outdir", ""] + \
        (["--dp"] if dp else [])
    seen = {"history": []}

    def config(args):
        cfg = config_from_args(args)
        cfg.model = dataclasses.replace(cfg.model, dropout=0.0,
                                        emb_dropout=0.0)
        return cfg

    def host(tree):
        return {k: v.detach().float().cpu()
                for k, v in flatten_tree(tree).items()}

    patched = {"config_from_args": config}
    if is_baseline(argv) and module is train_forget:
        run_reg = module.run_regularization_task

        def spy(*a, **k):
            res = run_reg(*a, **k)
            seen["params"] = host(res["params"])
            return res
        patched["run_regularization_task"] = spy
    elif is_baseline(argv):
        run_cl = module.run_baseline_continual

        def spy(*a, **k):
            res = run_cl(*a, **k)
            seen["params"] = host(res[1])
            return res
        patched["run_baseline_continual"] = spy
    elif module is train_forget:
        run = module.run_forget_training

        def spy(*a, **k):
            res = run(*a, **k)
            seen.update(params=host(res.state.params), history=[res.history])
            return res
        patched["run_forget_training"] = spy
    elif module is train_forget_cl:
        run = module.run_continual_forgetting

        def spy(*a, **k):
            res = run(*a, **k)
            seen.update(params=host(res.final_params),
                        history=[t.result.history for t in res.tasks])
            return res
        patched["run_continual_forgetting"] = spy
    saved = {k: getattr(module, k) for k in patched}
    for k, v in patched.items():
        setattr(module, k, v)
    try:
        if module is train_pretrain:
            fn = lambda a: module.main(a, return_state=True)  # noqa: E731
        else:
            fn = module.main
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, launches, wall = run_counted(fn, argv, dp_expected(name, accum),
                                          name)
        seen["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        for k, v in saved.items():
            setattr(module, k, v)
    if module is train_pretrain:
        out, state = out
        seen["params"] = host(state.params)
    return {"report": out, "launches": launches, "wall_s": wall, **seen}


def dcp_state(seed=0):
    """A train state of CUDA tensors at the flagship width (ViT-P8S8 with
    a rank-8 LoRA, 19.4 M parameters, and AdamW moments filled from a
    seeded generator): the same on every rank."""
    params = detached(init_vit_params(torch.Generator().manual_seed(seed),
                                      ViTConfig(), LoraConfig(rank=8)), DEV)
    leaves = list(flatten_tree(params).values())
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    moments = {k: [torch.randn(t.shape, generator=g, device=DEV)
                   for t in leaves] for k in ("mu", "nu")}
    return {"params": params, "opt_state": {"count": 7, **moments},
            "step": 7}


def dcp_leaves(tree, prefix=""):
    """A state dict's tensors and numbers by their path."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {p: x for k, v in items
                for p, x in dcp_leaves(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def dcp_check(path, mesh=None):
    """checkpoints/dcp_io on the card: dcp_state through AsyncSaver (every
    rank of a group calls it with the same path; of ``mesh``'s ranks,
    over their group, when given), read back with a template of zeros on
    the card and without one; raises unless both equal the state. Returns
    the seconds of save() and of the wait, of a first save (DCP's imports
    and set-up included) and a second."""
    state = dcp_state()
    saver = AsyncSaver(mesh)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(path, state)
        t_save = time.perf_counter() - t0
        saver.wait()
        times.append({"save_s": t_save,
                      "wait_s": time.perf_counter() - t0 - t_save})
    saver.close()

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zeros(v) for v in tree]
        return torch.zeros_like(tree) if torch.is_tensor(tree) else 0

    want = dcp_leaves(state)
    template = zeros(state)
    for what, back in (("a template on the card",
                        load_dcp(path, template, mesh=mesh)),
                       ("its metadata", load_dcp(path, mesh=mesh))):
        got = dcp_leaves(back)
        if set(got) != set(want) or not all(
                torch.equal(got[k].to(DEV), b) if torch.is_tensor(b)
                else got[k] == b for k, b in want.items()):
            raise AssertionError(f"dcp_io: the state read back through "
                                 f"{what} differs")
    if not all(t.device.type == DEV.type
               for t in dcp_leaves(template).values() if torch.is_tensor(t)):
        raise AssertionError("dcp_io: the template's tensors left the card")
    return {"first": times[0], "second": times[1],
            "mbytes": sum(t.numel() * t.element_size() for t in want.values()
                          if torch.is_tensor(t)) / 2 ** 20}


def dp_rank_main(rank, world, port, outdir):
    """One rank of the data-parallel phase (``chip_smoke.py --dp-rank``):
    torchrun's environment, a gloo group (NCCL refuses two ranks on one
    card; gloo all_reduces and broadcasts CUDA tensors), every DP_RUNS
    path through its CLI with --dp on cuda:0; results to outdir."""
    rank, world = int(rank), int(world)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    share_datasets()
    import torch.distributed as dist
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        for name, (_, _, accum) in DP_RUNS.items():
            torch.save(dp_run(name, accum, dp=True),
                       os.path.join(outdir, f"{name}.rank{rank}.pt"))
        # both ranks save one replicated state through one gloo group
        torch.save(dcp_check(os.path.join(outdir, "dcp_ranks")),
                   os.path.join(outdir, f"dcp.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` ranks of this script (``chip_smoke.py --<role>-rank r
    world port outdir *extra``), started together, each rank's log under
    outdir, while the caller works on (the one-process references): the
    ranks and the caller share the card. ``wait`` raises with a rank's
    log if one fails or outlives ``timeout`` seconds from the start;
    ``kill`` stops them; no rank outlives either."""

    def __init__(self, role, world, outdir, extra, timeout):
        import socket
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        self.role, self.world, self.outdir = role, world, outdir
        self.paths = [os.path.join(outdir, f"{role}{world}.rank{r}.log")
                      for r in range(world)]
        self.logs = [open(path, "w") for path in self.paths]
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), f"--{role}-rank",
             str(r), str(world), str(port), outdir, *extra], env=env,
            stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]

    def finished(self):
        """Whether every rank has exited."""
        return all(p.poll() is not None for p in self.procs)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in self.logs:
            fh.close()

    def wait(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        finally:
            self.kill()
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                with open(self.paths[r]) as fh:
                    tail = fh.read()[-4000:]
                raise AssertionError(f"{self.role} rank {r} of {self.world} "
                                     f"exited {p.returncode}:\n{tail}")

    def results(self, names):
        """Each rank's saved result of each of ``names``."""
        return [{name: torch.load(os.path.join(
            self.outdir, f"{name}.rank{r}.pt"), weights_only=False)
            for name in names} for r in range(self.world)]


def accuracy_tolerances(name):
    """Per eval key, one test image of its set in percent: the ranks' eval
    batches hold half the rows of the one-process eval's, so cuBLAS may
    tile its bf16 GEMMs otherwise and sum a logit in another order, which
    can flip the argmax of a near tie."""
    module, argv, _ = DP_RUNS[name]
    return tolerances_of(module, argv)


def tolerances_of(module, argv):
    """accuracy_tolerances of ``module`` run with ``argv``."""
    cfg = config_from_args(build_parser().parse_args(argv))
    train, test = datasets(cfg)
    if module is train_pretrain:
        return {"final_test_acc": 100.0 / len(test)}
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    if is_baseline(argv):
        # a baseline's report, per task: the evals of each set, the
        # old-class eval and H (two points per image of forget: before
        # and after)
        if module is train_forget:
            sets = [(train_forget.single_step_data(cfg, train, test, order),
                     None)]
        else:
            sets = [split_task_data(cfg, train, test, order, t,
                                    cfg.data.seed + t)
                    for t in range(cfg.forget.num_tasks)]
        one = {key: max(100.0 / len(getattr(d, key)) for d, _ in sets)
               for key in ("test_forget", "test_remain", "test_open")}
        tols = {"forget_acc_before": one["test_forget"],
                "forget_acc": one["test_forget"],
                "remain_acc": one["test_remain"],
                "open_acc": one["test_open"],
                "best_H_mean" if module is train_forget else "best_h":
                2 * (2 * one["test_forget"] + one["test_remain"])}
        olds = [old for _, old in sets if old is not None and len(old)]
        if olds:
            tols["old_acc"] = max(100.0 / len(old) for old in olds)
        return tols
    if module is train_forget:
        sets = [train_forget.single_step_data(cfg, train, test, order)]
    else:
        sets = [split_task_data(cfg, train, test, order, t,
                                cfg.data.seed + t)[0]
                for t in range(cfg.forget.num_tasks)]
    tol_f = max(100.0 / len(d.test_forget) for d in sets)
    tol_r = max(100.0 / len(d.test_remain) for d in sets)
    return {"Test forget Accuracy": tol_f, "Test remain Accuracy": tol_r,
            "H_mean": 2 * (tol_f + tol_r)}


def dp_phase(card):
    """Every DP_RUNS path at the flagship width on two gloo ranks sharing
    the card, against one process with --grad_accum 2x: each rank's K1 and
    K2 counts as derived, one set of parameters on both ranks to the bit,
    the final parameters within DP_RTOL / DP_ATOL of the one process's,
    every eval within accuracy_tolerances. Walls and images/s are of two
    ranks sharing one card: they measure the path, not scaling."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        # the ranks run while this process runs the references
        spawned = Ranks("dp", DP_WORLD, out, [], DP_TIMEOUT_S)
        try:
            refs = {name: dp_run(name, DP_WORLD * accum, dp=False)
                    for name, (_, _, accum) in DP_RUNS.items()}
            dcp_one = dcp_check(os.path.join(out, "dcp_one"))
        except BaseException:
            spawned.kill()
            raise
        spawned.wait()
        ranks = spawned.results(list(DP_RUNS) + ["dcp"])
    ranks_wall = time.perf_counter() - t0
    print(f"dp phase: {DP_WORLD} ranks ran every path in {ranks_wall:.1f} s "
          f"(start-up included, beside the one-process references)",
          flush=True)
    print("dp dcp " + json.dumps({
        "what": "checkpoints/dcp_io.AsyncSaver of a flagship train state of "
                "CUDA tensors, read back equal with and without a template",
        "card": card, "one_process": dcp_one,
        "ranks": [r["dcp"] for r in ranks]}), flush=True)
    launches = {}
    for name, (_, argv, accum) in DP_RUNS.items():
        want = as_read(dp_expected(name, accum), argv)
        got = [r[name] for r in ranks]
        for r, run in enumerate(got):
            if run["launches"] != want:
                raise AssertionError(f"{name} rank {r} launched "
                                     f"{run['launches']}; its rows imply "
                                     f"{want}")
        same = [k for k, v in got[0]["params"].items()
                if not torch.equal(v, got[1]["params"][k])]
        if same:
            raise AssertionError(f"{name}: the ranks' parameters differ at "
                                 f"{same[:5]}")
        ref, diffs = refs[name], {}
        for k, want_t in ref["params"].items():
            have = got[0]["params"][k]
            diffs[k] = float((have - want_t).abs().max())
            if not torch.allclose(have, want_t, rtol=DP_RTOL, atol=DP_ATOL):
                raise AssertionError(f"{name}: {k} of two ranks differs from "
                                     f"one process by {diffs[k]}")
        tols = accuracy_tolerances(name)
        pairs = [(h, w) for hs, ws in zip(got[0]["history"], ref["history"])
                 for h, w in zip(hs, ws)]
        if len(got[0]["history"]) != len(ref["history"]) or any(
                len(hs) != len(ws) for hs, ws in zip(got[0]["history"],
                                                     ref["history"])):
            raise AssertionError(f"{name}: eval histories of other lengths")
        if not pairs:
            # a baseline's or the pretrain's report: per task, where a
            # list
            pairs = list(zip(*(r if isinstance(r, list) else [r] for r in
                               (got[0]["report"], ref["report"]))))
        for h, w in pairs:
            if any((h[k] is None) != (w[k] is None) or h[k] is not None
                   and not math.isfinite(h[k]) for k in tols):
                raise AssertionError(f"{name}: evals {h} against {w}")
        worst = {k: max(abs(h[k] - w[k]) for h, w in pairs
                        if w[k] is not None) for k in tols}
        if any(worst[k] > tols[k] + 1e-9 for k in tols):
            raise AssertionError(f"{name}: evals differ by {worst} (at most "
                                 f"{tols})")
        launches[name] = got[0]["launches"]
        print("dp " + json.dumps({
            "path": name, "ranks": DP_WORLD, "card": card,
            "note": "two gloo ranks sharing one card with the one-process "
                    "references: walls measure the path, not scaling",
            "rank_grad_accum": accum, "one_process_grad_accum":
                DP_WORLD * accum,
            "rank_wall_s": [r["wall_s"] for r in got],
            "one_process_wall_s": ref["wall_s"],
            "max_abs_param_diff": max(diffs.values()),
            "worst_eval_diff": worst, "launches_per_rank": want,
            "peak_mib_per_rank": [r["peak_bytes"] / 2 ** 20 for r in got],
            "one_process_peak_mib": ref["peak_bytes"] / 2 ** 20,
            "report_rank0": got[0]["report"] if not isinstance(
                got[0]["report"], list) else None}), flush=True)
    return launches, refs


# ---------------------------------------------------------------------------
# the (data, model) mesh: ranks sharing the one card (slice 9)
# ---------------------------------------------------------------------------

TP2 = ["--tp", "--mesh_model", "2"]
SP2 = ["--sp", "--mesh_model", "2"]
PP2 = ["--pp", "--mesh_model", "2"]
DCN2 = ["--mesh_slices", "2"]
# run -> (CLI module, argv, layout flags, world); each rank runs
# --grad_accum 1 on the rows of its data index, the one-process reference
# --grad_accum D (D = world / model), so its micro-batches are the data
# ranks' rows
# The forget runs take 2 of the recipe's 5 epochs, to keep the script
# inside its time limit as the phase grew (slice 9's from slice 10 on,
# slice 10's from slice 11 on); forget_subworld keeps 5, to reuse the dp
# phase's one process
LAYOUT_FORGET_ARGV = DP_FORGET_ARGV + ["-e", "2"]
LAYOUT_FORGET_FP32_ARGV = in_dtype(LAYOUT_FORGET_ARGV, "float32")
# the ImageNet recipe's flags cut to one task (slice 12's ViT-B/16 runs)
LAYOUT_IMAGENET_ARGV = IMAGENET_ARGV + ["--num_tasks", "1"]
# where layout_phase writes the seeded ImageNet folder and ViT-B/16
# checkpoint the runs of LAYOUT_IMAGENET_ARGV read (every rank is told
# through its environment)
IMAGENET_ROOT_ENV = "CHIP_SMOKE_IMAGENET_ROOT"
LAYOUT_RUNS = {
    "forget_fsdp": (train_forget, LAYOUT_FORGET_ARGV, ["--fsdp"], 2),
    "forget_tp": (train_forget, LAYOUT_FORGET_ARGV, TP2, 2),
    "forget_tp_merged": (train_forget, LAYOUT_FORGET_ARGV +
                         ["--lora_apply", "merged"], TP2, 2),
    "cl_fsdp_model2": (train_forget_cl, DP_CL_ARGV,
                       ["--fsdp", "--mesh_model", "2"], 4),
    "pretrain_tp_fsdp": (train_pretrain, DP_PRETRAIN_ARGV,
                         TP2 + ["--fsdp"], 4),
    # sequence and pipeline parallelism (slice 10): K1 on whole sequences
    # on every sp rank, on each stage's micro-batches under pp
    "forget_sp": (train_forget, LAYOUT_FORGET_ARGV, SP2, 2),
    "forget_tp_sp": (train_forget, LAYOUT_FORGET_ARGV, TP2 + ["--sp"], 2),
    "forget_pp": (train_forget, LAYOUT_FORGET_ARGV,
                  PP2 + ["--pp_micro", "2"], 2),
    "cl_sp_prox": (train_forget_cl, DP_CL_ARGV, SP2, 2),
    "cl_pp_loss": (train_forget_cl, DP_CL_ARGV + ["--structure_mode",
                                                  "loss"], PP2, 2),
    "pretrain_tp_fsdp_sp": (train_pretrain, DP_PRETRAIN_ARGV,
                            TP2 + ["--fsdp", "--sp"], 4),
    "pretrain_pp": (train_pretrain, DP_PRETRAIN_ARGV, PP2, 4),
    # the whole JAX mesh (slice 11): the outer dcn axis under dp, tp +
    # fsdp + sp, fsdp with the prox, pp; plain --dp on the same world of 4
    # (forget_dp4, cl_dp4: the batch order of the M = 1 runs), and a mesh
    # smaller than the world (ranks 2 and 3 idle)
    "forget_dcn_dp": (train_forget, LAYOUT_FORGET_ARGV,
                      DCN2 + ["--mesh_data", "2"], 4),
    "forget_dp4": (train_forget, LAYOUT_FORGET_ARGV, [], 4),
    "forget_dcn_tp_fsdp_sp": (train_forget, LAYOUT_FORGET_ARGV,
                              DCN2 + TP2 + ["--fsdp", "--sp"], 8),
    "cl_dcn_fsdp_prox": (train_forget_cl, DP_CL_ARGV, DCN2 + ["--fsdp"], 4),
    "cl_dp4": (train_forget_cl, DP_CL_ARGV, [], 4),
    "pretrain_dcn_pp": (train_pretrain, DP_PRETRAIN_ARGV, DCN2 + PP2, 4),
    "forget_subworld": (train_forget, DP_FORGET_ARGV, ["--mesh_data", "2"],
                        4),
    # every model and method under the layouts (slice 12): ViT-B/16 at
    # full width and depth through the ImageNet continual CLI (1 task,
    # the seeded folder, layout_argv adds its paths) under tp + fsdp and
    # under sp with the prox; the baselines at the baseline phase's flags
    # under tp, fsdp + a model axis, sp and tp + fsdp; the attention LoRA
    # under pp
    "b16_tp_fsdp": (train_forget_cl, LAYOUT_IMAGENET_ARGV, TP2 + ["--fsdp"],
                    4),
    "b16_sp_prox": (train_forget_cl, LAYOUT_IMAGENET_ARGV + [
        "--structure_mode", "prox"], SP2, 2),
    "ewc_tp": (train_forget, BASELINE_ARGV + ["--ewc"], TP2, 2),
    "scrub_fsdp_model": (train_forget_cl, BASELINE_ARGV + ["--SCRUB"],
                         ["--fsdp", "--mesh_model", "2"], 4),
    "derpp_sp": (train_forget_cl, BASELINE_ARGV + ["--DER_plus"], SP2, 2),
    "lirf_tp_fsdp": (train_forget_cl, BASELINE_ARGV + ["--LIRF"],
                     TP2 + ["--fsdp"], 4),
    "attn_pp": (train_forget, LAYOUT_FORGET_ARGV + ["--lora_pos",
                                                    "Attention"], PP2, 2),
    # fp32 compute (slice 21): fp32 K1 on a tp rank's half of the heads
    # over whole sequences (tp + sp), and on pp's micro-batches
    "forget_tp_sp_fp32": (train_forget, LAYOUT_FORGET_FP32_ARGV,
                          TP2 + ["--sp"], 2),
    "forget_pp_fp32": (train_forget, LAYOUT_FORGET_FP32_ARGV,
                       PP2 + ["--pp_micro", "2"], 2),
}
# the ranks each run is spawned in, by name (others: the world's size;
# the pretrains share one spawn, so that no two run at once on the
# card); every spawn starts at once, the runs of one in turn
LAYOUT_SPAWN = {**{name: "2b" for name in ("forget_sp", "forget_tp_sp",
                                           "forget_pp", "cl_sp_prox",
                                           "cl_pp_loss")},
                **{name: "4b" for name in ("cl_fsdp_model2", "forget_dcn_dp",
                                           "forget_dp4", "cl_dcn_fsdp_prox",
                                           "cl_dp4")},
                "forget_dcn_tp_fsdp_sp": "8", "forget_subworld": "sub4",
                # slice 12: ViT-B/16's 4 ranks after the pretrains, its 2
                # sp ranks once those have ended (LAYOUT_AFTER: beside the
                # pretrains' ranks and every other spawn, their ~9 GB a
                # rank do not fit in an 80 GB card); the baselines after
                # the runs of the old spawns
                "b16_tp_fsdp": "4", "b16_sp_prox": "b16",
                "ewc_tp": "2", "attn_pp": "2", "derpp_sp": "2b",
                "scrub_fsdp_model": "4b", "lirf_tp_fsdp": "4b",
                # slice 21: the fp32 runs in a spawn of their own
                "forget_tp_sp_fp32": "2f", "forget_pp_fp32": "2f"}
# a spawn started only once another has ended (the card's memory)
LAYOUT_AFTER = {"b16": "4"}
# a run held to the bit against plain --dp on the same world (the same
# rows and the same sum over the same ranks); against one process, whose
# fp32 sum of four micro-batches runs in another order than the ranks'
# all_reduce (gloo's ring, not a pairwise tree), within
# LAYOUT_FLOOR_FACTOR times the noise floor
LAYOUT_PARTNER = {"forget_dcn_dp": "forget_dp4",
                  "cl_dcn_fsdp_prox": "cl_dp4"}
LAYOUT_TIMEOUT_S = 600
BLOCK_KERNELS = ("qkv", "attn_out", "fc1", "fc2")
# Final parameters of a layout against one process, where a model axis
# splits a sum. tp sums fc2's product and the LoRA's A2 contraction over
# the halves of the hidden, a class-sharded head sums the embedding's
# gradient over the halves of the classes: each a reordered sum whose
# result is rounded to bf16, perturbing activations and gradients by an
# ulp of bf16 at some elements, which the recipe's Adam steps and gates
# carry into the parameters. The scale of that is the recipe's own noise
# floor, measured in the same run: one process against itself with its
# batch sums split twice as far (--grad_accum 2D: another order of the
# same sums, the same bf16 kernels). A layout is held to
# LAYOUT_FLOOR_FACTOR times that floor, per leaf relative to the leaf's
# norm (the card's first runs of this phase: 0.97-2.6 times; the CPU
# tests hold the same layouts to the JAX suite's rtol 1e-4 / atol 1e-5 in
# fp32). A layout that splits no sum over ``model`` (fsdp alone) gathers
# whole kernels and is held to the bit on two data-parallel ways, whose
# all_reduce adds a pair as the one process does; on more (dcn x data =
# 4), where gloo adds the ranks' gradients in its own order, to the
# floor, and to the bit against plain --dp on the same ranks
# (LAYOUT_PARTNER).
LAYOUT_FLOOR_FACTOR = 4.0


def layout_shape(name):
    """(slices, data, model) of LAYOUT_RUNS[name]: JAX's make_mesh over
    its world (data -1: what slices and model leave)."""
    _, _, flags, world = LAYOUT_RUNS[name]

    def flag(key, default):
        return int(flags[flags.index(key) + 1]) if key in flags \
            else default
    slices, model = flag("--mesh_slices", 1), flag("--mesh_model", 1)
    return slices, flag("--mesh_data", world // (slices * model)), model


def layout_ways(name):
    """The data-parallel ways (dcn x data) of LAYOUT_RUNS[name]."""
    slices, data, _ = layout_shape(name)
    return slices * data


def layout_used(name):
    """The ranks LAYOUT_RUNS[name]'s mesh uses; the others are idle."""
    slices, data, model = layout_shape(name)
    return slices * data * model


def layout_argv(name, layout, accum=None):
    """The argv of one rank (``layout``) or of a one-process run, with
    --grad_accum ``accum`` (by default 1 on a rank, S·D in one
    process); a ViT-B/16 run reads the folder and checkpoint under
    $CHIP_SMOKE_IMAGENET_ROOT."""
    _, argv, flags, _ = LAYOUT_RUNS[name]
    if accum is None:
        accum = 1 if layout else layout_ways(name)
    if argv[:len(LAYOUT_IMAGENET_ARGV)] == LAYOUT_IMAGENET_ARGV:
        root = os.environ[IMAGENET_ROOT_ENV]
        argv = argv + ["--data_root", os.path.join(root, "data"),
                       "--imagenet_miss_root", os.path.join(root, "miss"),
                       "-r", os.path.join(root, "vit_b16.pth")]
    return argv + ["--grad_accum", str(accum), "--outdir", ""] + \
        (["--dp"] + flags if layout else [])


def pp_stages(name):
    """(S, M) of a --pp run: its stages and micro-batches (--pp_micro, or
    S when 0); None without --pp."""
    _, _, flags, _ = LAYOUT_RUNS[name]
    if "--pp" not in flags:
        return None
    stages = layout_shape(name)[2]
    micro = int(flags[flags.index("--pp_micro") + 1]) \
        if "--pp_micro" in flags else 0
    return stages, micro or stages


def layout_expected(name, layout, accum=None, stage=0, idle=False):
    """K1 and K2 launches of one rank (every rank of a model group runs
    the attention and the prox on whole tensors: under sp on whole
    sequences) or of a one-process run; a baseline's as its phase derives
    them. Under pp, of the rank's ``stage``: each forward runs its depth /
    S layers on M micro-batches, and the backward too, but on stage 0
    with an FFN LoRA only, where block 0's attention backward is skipped
    as in one process. An ``idle`` rank launches nothing."""
    if idle:
        return {k: 0 for k in ("attention_fwd", "attention_bwd",
                               "group_prox", "group_norms", "group_scale")}
    module, argv0, _, _ = LAYOUT_RUNS[name]
    argv = layout_argv(name, layout, accum)
    if is_baseline(argv):
        want = (expected_single_step_launches if module is train_forget
                else expected_baseline_launches)(argv)
    elif module is train_forget:
        fwd, bwd = expected_launches(argv)
        want = {"attention_fwd": fwd, "attention_bwd": bwd,
                "group_prox": 0, "group_norms": 0, "group_scale": 0}
    elif module is train_forget_cl:
        want = expected_cl_launches(argv)
    else:
        want = expected_pretrain_launches(argv)[0]
    pp = pp_stages(name) if layout else None
    if pp is None:
        return want
    stages, micro = pp
    cfg0 = config_from_args(build_parser().parse_args(argv0))
    depth = cfg0.model.depth
    # one process: depth forward launches per forward; depth - 1 backward
    # launches per training forward with the FFN LoRA, depth when every
    # parameter trains (the pretrain at lora_rank 0) or an attention LoRA
    # does (block 0's qkv LoRA needs its dq, dk and dv)
    full = module is train_pretrain or cfg0.lora.pos == "Attention"
    per_bwd = depth if full else depth - 1
    local = depth // stages
    skip = 0 if full or stage > 0 else 1
    return {**want,
            "attention_fwd": want["attention_fwd"] // depth * local * micro,
            "attention_bwd": want["attention_bwd"] // per_bwd *
            (local - skip) * micro}


def is_block_kernel(key):
    """Whether a flat parameter name is one of the stacked block kernels
    (qkv, attn_out, fc1, fc2)."""
    parts = key.split(".")
    return ".blocks." in key and parts[-1] == "kernel" and \
        parts[-2] in BLOCK_KERNELS


def tensor_bytes(tree):
    """{name: bytes} of a flat tree of tensors."""
    return {k: v.numel() * v.element_size() for k, v in tree.items()}


def expected_kernel_bytes(name, sizes):
    """A rank's bytes of the block kernels by the rules, from the whole
    tree's ``sizes``: fsdp cuts all four by D (the data axis of a slice,
    never by dcn x data), tp fc1 and fc2 by M, pp all four by the stages
    M; sp none."""
    _, _, flags, _ = LAYOUT_RUNS[name]
    _, data, model = layout_shape(name)
    out = 0
    for k, n in sizes.items():
        if not is_block_kernel(k):
            continue
        if "--pp" in flags:
            n //= model
        if "--fsdp" in flags:
            n //= data
        if "--tp" in flags and k.split(".")[-2] in ("fc1", "fc2"):
            n //= model
        out += n
    return out


def layout_run(name, layout, accum=None, rank=0):
    """LAYOUT_RUNS[name] through its CLI in this process, dropout off,
    as rank ``rank`` of the mesh (``layout``) or as the one-process
    reference; launch counts held to layout_expected. Returns the report,
    the final parameters gathered whole (host fp32, flat), the eval
    history, the launches, the wall seconds, the peak of the card's
    memory this process allocated, and on a rank its bytes of parameters
    (a baseline's as its runner sharded them) and moments and the
    collective route. A rank past the mesh (idle) returns its launches
    (none), wall and peak memory (none) only."""
    module, _, _, _ = LAYOUT_RUNS[name]
    argv = layout_argv(name, layout, accum)
    idle = layout and rank >= layout_used(name)
    seen = {"history": [], "idle": idle}

    def config(args):
        cfg = config_from_args(args)
        cfg.model = dataclasses.replace(cfg.model, dropout=0.0,
                                        emb_dropout=0.0)
        return cfg

    def keep(params):
        seen["shard_bytes"] = tensor_bytes(flatten_tree(params))
        whole = flatten_tree(sharding.gather_tree(active_mesh(), params))
        seen["whole_bytes"] = tensor_bytes(whole)
        return {k: v.detach().float().cpu() for k, v in whole.items()}

    patched = {(module, "config_from_args"): config}
    if is_baseline(argv):
        # the runner's shards of the student (LIRF: of the teacher, whose
        # names lack "base."), each call's; its whole trees come back
        from gslora_tpu_torch.baselines import (distill, lirf,
                                                regularization, scrub)
        for runner in (distill, lirf, regularization, scrub):
            put = runner.put_trees

            def spy_put(*a, put=put, **k):
                out = put(*a, **k)
                first = out[0] if "base" in out[0] else {"base": out[0]}
                seen["shard_bytes"] = tensor_bytes(flatten_tree(first))
                return out
            patched[(runner, "put_trees")] = spy_put
        run_base = module.run_regularization_task \
            if module is train_forget else module.run_baseline_continual

        def spy(*a, **k):
            res = run_base(*a, **k)
            whole = flatten_tree(res["params"] if module is train_forget
                                 else res[1])
            seen["whole_bytes"] = tensor_bytes(whole)
            seen["params"] = {k: v.detach().float().cpu()
                              for k, v in whole.items()}
            return res
        patched[(module, "run_regularization_task" if module is train_forget
                 else "run_baseline_continual")] = spy
    elif module is train_forget:
        run = module.run_forget_training

        def spy(*a, **k):
            res = run(*a, **k)
            seen.update(params=keep(res.state.params), history=[res.history])
            return res
        patched[(module, "run_forget_training")] = spy
    elif module is train_forget_cl:
        run_task, run_cl = CONT.run_forget_training, \
            module.run_continual_forgetting

        def spy_task(*a, **k):
            res = run_task(*a, **k)
            # the last task's trained shards are the final parameters
            keep(res.state.params)
            return res

        def spy(*a, **k):
            res = run_cl(*a, **k)
            seen.update(params={k: v.detach().float().cpu() for k, v in
                                flatten_tree(res.final_params).items()},
                        history=[t.result.history for t in res.tasks])
            return res
        patched[(CONT, "run_forget_training")] = spy_task
        patched[(module, "run_continual_forgetting")] = spy
    saved = {key: getattr(*key) for key in patched}
    for (mod, attr), v in patched.items():
        setattr(mod, attr, v)
    try:
        if module is train_pretrain:
            fn = lambda a: module.main(a, return_state=True)  # noqa: E731
        else:
            fn = module.main
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stage = rank % layout_shape(name)[2]
        with plain_attention_on_card() as plain:
            out, launches, wall = run_counted(
                fn, argv, layout_expected(name, layout, accum, stage, idle),
                name)
        seen["peak_bytes"] = torch.cuda.max_memory_allocated()
        seen["plain_on_card"] = plain
    finally:
        for (mod, attr), v in saved.items():
            setattr(mod, attr, v)
    if idle:
        report = out[0] if module is train_pretrain else out
        return {"report": report, "launches": launches, "wall_s": wall,
                **seen}
    if module is train_pretrain:
        out, state = out
        seen["params"] = keep(state.params)
        seen["moment_bytes"] = sum(
            t.numel() * t.element_size()
            for key in ("mu", "nu") for t in state.opt_state[key])
    mesh = active_mesh()
    if layout:
        seen["route"] = mesh.route
    return {"report": out, "launches": launches, "wall_s": wall, **seen}


SUBWORLD_DCP = MeshConfig(data=2)  # the sub-world mesh of the DCP check


def layout_rank_main(rank, world, port, outdir, *names):
    """One rank of the layout phase (``chip_smoke.py --layout-rank``):
    torchrun's environment, a gloo group on cuda:0, each of ``names``
    through its CLI with --dp and its layout flags (the card's cache
    emptied between them); results to outdir. Where ``names`` hold a run
    on a mesh smaller than the world, the used ranks of SUBWORLD_DCP
    first save and load a train state through checkpoints/dcp_io over
    their group (``dcp_subworld``), while the idle ones go on to the
    runs."""
    rank, world = int(rank), int(world)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    share_datasets()
    import torch.distributed as dist
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        if any(layout_used(n) < world for n in names):
            mesh = make_mesh(SUBWORLD_DCP, "cuda")
            torch.save(None if mesh.idle else dcp_check(
                os.path.join(outdir, "dcp_subworld"), mesh),
                os.path.join(outdir, f"dcp_subworld.rank{rank}.pt"))
        for name in names:
            torch.save(layout_run(name, layout=True, rank=rank),
                       os.path.join(outdir, f"{name}.rank{rank}.pt"))
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def layout_accuracy_tolerances(name):
    """accuracy_tolerances of the run's CLI and flags (one test image of
    each set)."""
    module = LAYOUT_RUNS[name][0]
    return tolerances_of(module, layout_argv(name, False))


def layout_phase(card, refs, imagenet_root):
    """Every LAYOUT_RUNS layout on gloo ranks sharing the card, against
    one process of the same flags with --grad_accum S·D (``refs`` holds
    the dp phase's one-process runs, reused where they ran the same; the
    ViT-B/16 runs read ``imagenet_root``, :func:`imagenet_inputs`):
    each rank's K1 and K2 counts as derived, every used rank's gathered
    parameters equal to the bit, the final parameters within
    LAYOUT_FLOOR_FACTOR times the noise floor of the one process's (to
    the bit without a model axis on two data-parallel ways; with more, to
    the bit against the LAYOUT_PARTNER run), every eval within one test
    image, each used rank's block-kernel
    bytes exactly as the rules cut them; an idle rank launched nothing
    and held no byte of the card. Returns each run's launches per rank."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # earlier phases' blocks: the ranks need them
    ran = {}
    spawns = {}
    for name, (*_, w) in LAYOUT_RUNS.items():
        spawns.setdefault(LAYOUT_SPAWN.get(name, str(w)), (w, []))[1].append(
            name)
    tmp = tempfile.TemporaryDirectory()
    os.environ[IMAGENET_ROOT_ENV] = imagenet_root
    # every spawn's ranks run together (those of LAYOUT_AFTER once the
    # spawn they follow has ended), while this process runs the references
    spawned = {}

    def start(tag):
        w, names = spawns[tag]
        os.makedirs(os.path.join(tmp.name, tag))
        spawned[tag] = Ranks("layout", w, os.path.join(tmp.name, tag),
                             names, LAYOUT_TIMEOUT_S)

    def start_ready():
        for tag, before in LAYOUT_AFTER.items():
            if tag in spawns and tag not in spawned and \
                    spawned[before].finished():
                start(tag)

    try:
        for tag in spawns:
            if tag not in LAYOUT_AFTER:
                start(tag)
    except BaseException:
        for r in spawned.values():
            r.kill()
        tmp.cleanup()
        raise

    def one_process(name, accum):
        """The one-process run of ``name``'s flags at --grad_accum
        ``accum``: the dp phase's where it ran the same, else one run per
        distinct argv."""
        module, argv, _, _ = LAYOUT_RUNS[name]
        for dp, (m, a, dp_accum) in DP_RUNS.items():
            if m is module and a == argv and DP_WORLD * dp_accum == accum \
                    and dp in refs:
                return refs[dp]
        key = (module.__name__, tuple(argv), accum)
        if key not in ran:
            start_ready()
            ran[key] = layout_run(name, False, accum)
            torch.cuda.empty_cache()  # the card is shared with the ranks
        return ran[key]

    ref_runs, floors, dcp = {}, {}, {}
    try:
        for name in LAYOUT_RUNS:
            model, ways = layout_shape(name)[2], layout_ways(name)
            ref_runs[name] = one_process(name, ways)
            if model > 1 or ways > 2:
                # the noise floor of the recipe: the same one process with
                # its batch sums split twice as far (--grad_accum 2·S·D)
                floor = one_process(name, 2 * ways)["params"]
                floors[name] = max(rel_err(floor[k], v) for k, v in
                                   ref_runs[name]["params"].items())
        refs = ref_runs
        ranks = {}
        for tag in sorted(spawns, key=lambda t: t in LAYOUT_AFTER):
            w, names = spawns[tag]
            if tag not in spawned:  # the spawn it follows has been waited
                start(tag)
            spawned[tag].wait()
            for res in spawned[tag].results(names):
                for name in names:
                    ranks.setdefault(name, []).append(res[name])
            path = os.path.join(tmp.name, tag, "dcp_subworld.rank{}.pt")
            if os.path.exists(path.format(0)):
                dcp[tag] = [torch.load(path.format(r), weights_only=False)
                            for r in range(w)]
            print(f"layout phase: {w} ranks ({tag}) ran {names} in "
                  f"{time.perf_counter() - t_phase:.1f} s (start-up "
                  f"included, beside the other spawns and the "
                  f"one-process references)", flush=True)
    finally:
        for r in spawned.values():
            r.kill()
        tmp.cleanup()
    for tag, got in dcp.items():
        used = sum(1 for r in got if r is not None)
        if used != SUBWORLD_DCP.data or any(r is not None for r in
                                            got[used:]):
            raise AssertionError(f"dcp on the sub-world mesh: the ranks "
                                 f"returned {got}")
        print("layout dcp " + json.dumps({
            "what": "checkpoints/dcp_io.AsyncSaver of a flagship train "
                    "state over the used ranks' group of a mesh smaller "
                    "than the world, read back equal with and without a "
                    "template", "card": card, "mesh": {"data":
                                                       SUBWORLD_DCP.data},
            "world": len(got), "ranks": got[:used]}), flush=True)
    launches = {}
    for name, (_, argv, flags, world) in LAYOUT_RUNS.items():
        slices, data, model = layout_shape(name)
        ways, used = layout_ways(name), layout_used(name)
        wants = [as_read(layout_expected(name, True, stage=r % model,
                                         idle=r >= used), argv)
                 for r in range(world)]
        got, ref = ranks[name][:used], refs[name]
        idle = ranks[name][used:]
        for r, run in enumerate(ranks[name]):
            if run["launches"] != wants[r]:
                raise AssertionError(f"{name} rank {r} launched "
                                     f"{run['launches']}; its flags imply "
                                     f"{wants[r]}")
        # (the data-parallel phase's one-process runs did not count it)
        plain = [run.get("plain_on_card", {"fwd": 0, "bwd": 0})
                 for run in ranks[name] + [ref]]
        if any(p != {"fwd": 0, "bwd": 0} for p in plain):
            raise AssertionError(f"{name}: the plain attention ran on the "
                                 f"card (ranks, then one process): {plain}")
        for r, run in enumerate(idle, used):
            if not run["idle"] or run["report"] is not None or \
                    run["peak_bytes"] != 0:
                raise AssertionError(
                    f"{name} rank {r} is past the mesh of {used} ranks but "
                    f"ran: report {run['report']}, peak {run['peak_bytes']}"
                    f" bytes")
        for r, run in enumerate(got):
            diff = [k for k, v in got[0]["params"].items()
                    if not torch.equal(v, run["params"][k])]
            if diff:
                raise AssertionError(f"{name}: rank {r}'s gathered "
                                     f"parameters differ at {diff[:5]}")
        # two ways sum as the one process's pairs do; more add in gloo's
        # order, another than the one process's tree
        exact = model == 1 and ways <= 2
        tol = 0.0 if exact else LAYOUT_FLOOR_FACTOR * floors[name]
        diffs, rels = {}, {}
        for k, want_t in ref["params"].items():
            have = got[0]["params"][k]
            diffs[k] = float((have - want_t).abs().max())
            rels[k] = rel_err(have, want_t)
            if exact and not torch.equal(have, want_t) or rels[k] > tol:
                raise AssertionError(
                    f"{name}: {k} differs from one process by "
                    f"{diffs[k]} (relative {rels[k]}); "
                    f"{'to the bit' if exact else tol} allowed")
        bit_one = all(torch.equal(got[0]["params"][k], v)
                      for k, v in ref["params"].items())
        partner = LAYOUT_PARTNER.get(name)
        if partner:
            other = ranks[partner][0]
            same = [k for k, v in other["params"].items()
                    if not torch.equal(v, got[0]["params"][k])]
            if same or got[0]["history"] != other["history"]:
                raise AssertionError(f"{name}: differs from {partner} (plain"
                                     f" --dp on the same ranks) at "
                                     f"{same[:5]}")
        tols = layout_accuracy_tolerances(name)
        pairs = [(h, w) for hs, ws in zip(got[0]["history"], ref["history"])
                 for h, w in zip(hs, ws)]
        if len(got[0]["history"]) != len(ref["history"]):
            raise AssertionError(f"{name}: eval histories of other lengths")
        if not pairs:
            # a baseline's report: one dict, or one per task
            rep, want_rep = got[0]["report"], ref["report"]
            pairs = list(zip(rep, want_rep)) if isinstance(rep, list) \
                else [(rep, want_rep)]
        for h, w in pairs:
            if any(not math.isfinite(h[k]) for k in tols if h.get(k)
                   is not None):
                raise AssertionError(f"{name}: evals {h}")
        worst = {k: max(abs(h[k] - w[k]) for h, w in pairs
                        if w.get(k) is not None) for k in tols
                 if any(w.get(k) is not None for _, w in pairs)}
        if any(worst[k] > tols[k] + 1e-9 for k in worst):
            raise AssertionError(f"{name}: evals differ by {worst} (at most "
                                 f"{tols})")
        # the whole tree in its parameters' dtype (fp32 at the flagship)
        whole = {k: b for k, b in got[0]["whole_bytes"].items()}
        whole_kb = sum(b for k, b in whole.items() if is_block_kernel(k))
        want_kb = expected_kernel_bytes(name, whole)
        rank_kb = [sum(b for k, b in run["shard_bytes"].items()
                       if is_block_kernel(k)) for run in got]
        if any(b != want_kb for b in rank_kb):
            raise AssertionError(f"{name}: ranks hold {rank_kb} bytes of "
                                 f"block kernels; the rules give {want_kb}")
        for r, run in enumerate(got):
            # AdamW's two moments follow the shards of what trains (every
            # parameter in the pretrain)
            held = sum(run["shard_bytes"].values())
            if run.get("moment_bytes") not in (None, 2 * held):
                raise AssertionError(f"{name} rank {r}: moments of "
                                     f"{run['moment_bytes']} bytes")
        if pp_stages(name):
            launches.update({f"{name}_stage{st}": wants[st]
                             for st in range(model)})
        else:
            launches[name] = wants[0]
        print("layout " + json.dumps({
            "path": name, "mesh": {"dcn": slices, "data": data,
                                   "model": model},
            "world": world, "idle_ranks": list(range(used, world)),
            "flags": flags, "card": card,
            "note": f"{world} gloo ranks sharing one card with the other "
                    f"spawns' ranks and the one-process references: walls "
                    f"measure the path, not scaling",
            "route": sorted({r["route"] for r in got}),
            "rank_grad_accum": 1, "one_process_grad_accum": ways,
            "rank_wall_s": [r["wall_s"] for r in got],
            "idle_rank_wall_s": [r["wall_s"] for r in idle],
            "one_process_wall_s": ref["wall_s"],
            "max_abs_param_diff": max(diffs.values()),
            "max_rel_param_diff": max(rels.values()),
            "bit_equal_to_one_process": bit_one,
            "bit_equal_to": partner,
            "noise_floor_rel": floors.get(name),
            "tolerance": "bit-exact" if exact else
            f"relative {tol} ({LAYOUT_FLOOR_FACTOR} x the noise floor)",
            "worst_eval_diff": worst, "launches_per_rank": wants,
            "peak_bytes_per_rank": [r["peak_bytes"] for r in got],
            "peak_mib_per_rank": [r["peak_bytes"] / 2 ** 20 for r in got],
            "idle_peak_bytes": [r["peak_bytes"] for r in idle],
            "one_process_peak_mib": ref["peak_bytes"] / 2 ** 20,
            "block_kernel_bytes_per_rank": rank_kb,
            "block_kernel_mib_per_rank": [b / 2 ** 20 for b in rank_kb],
            "block_kernel_bytes_whole": whole_kb,
            "param_bytes_per_rank": [sum(r["shard_bytes"].values())
                                     for r in got],
            "param_bytes_whole": sum(whole.values()),
            "moment_bytes_per_rank": [r.get("moment_bytes") for r in got],
            "report_rank0": got[0]["report"] if not isinstance(
                got[0]["report"], list) else None}), flush=True)
    del os.environ[IMAGENET_ROOT_ENV]
    print(f"layout phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def eval_phase(card):
    """The eval and serving surface (slice 8): the base it evaluates,
    test_model (bf16 with pair verification, int8), the int8 checks,
    backbone_probe, the same test_model and backbone_probe runs in fp32
    compute and the open-set recipes from that base (slice 21), recovery,
    the keep boundary and the serving bench."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        ckpt, launches = eval_base(root)
        launches.update(test_model_phase(ckpt, root))
        int8_check(ckpt)
        launches["backbone_probe"] = probe_phase(ckpt, root)
        # the same base evaluated in fp32 compute (slice 21)
        launches.update(fp32_runs("fp32 test_model", test_model_phase,
                                  ckpt, root, "float32"))
        launches["backbone_probe_fp32"] = fp32_runs(
            "fp32 backbone_probe", probe_phase, ckpt, root, "float32")
        launches.update(open_set_phase(ckpt))
        launches["recovery"] = recovery_phase(root)
    launches["cl_keep"] = keep_phase()
    launches["serving"] = serving_phase(card)
    print(f"eval phase in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def fill_launches(rows, paths):
    """Each kernel row's launches: those of the path it serves (K1 the
    single-step main path, in fp32 for the fp32 kernel; K2 the continual
    path; K3 is on neither), and by path (``paths``: each path's counts,
    an fp32 run's K1 under the fp32 keys)."""
    for row in rows:
        name = row["name"]
        own = "train_forget_fp32" if name.endswith("_fp32") else \
            "train_forget" if name.startswith("attention") else \
            "train_forget_cl"
        row["launches"] = paths[own][name]
        row["launches_by_path"] = {path: counts[name]
                                   for path, counts in paths.items()}


def main():
    t_script = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    card = smi.splitlines()[0]
    bw, peak, fp32_peak, tf32_peak = card_rates(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    share_datasets()

    def lap(what):
        print(f"chip_smoke: {what} done at "
              f"{time.perf_counter() - t_script:.1f} s", flush=True)

    builds = build_all()
    built(builds, ("attention", "group_lasso"))
    k1_rows = kernel_phase(bw, peak)
    group_rows = group_phase(bw, fp32_peak)
    lap("bf16 and group kernel phases")
    # the fp32 kernel compiles the longest: it builds on through the
    # phases above
    built(builds, ("attention_fp32",))
    rows = k1_rows + group_rows + fp32_kernel_phase(bw, fp32_peak,
                                                    tf32_peak, k1_rows)
    for dtype in (torch.bfloat16, torch.float32):
        model_check(ViTConfig(dropout=0.0, emb_dropout=0.0), dtype)
        model_check(ViTConfig.vit_b16(), dtype)
        lirf_check(dtype)
    lap("fp32 kernel phase and model checks")
    # every driven path's counts (an fp32 run's K1 under the fp32 keys)
    paths = {"train_forget": main_path_phase()}
    # each step is traced right after it is timed, then dropped, so no
    # step's tensors count in a later one's peak memory
    profiler_phase([("bench recipe step", *bench_phase(card), 5)], card)
    paths["train_forget_cl"] = continual_phase()
    paths.update(fp32_path_phase())
    lap("main, continual and fp32 phases")
    # one seeded folder and checkpoint for every ViT-B/16 run
    imagenet_tmp = tempfile.TemporaryDirectory()
    imagenet = imagenet_inputs(imagenet_tmp.name)
    paths["train_forget_cl_imagenet"] = imagenet_phase(imagenet)
    paths["train_forget_cl_imagenet_fp32"] = fp32_runs(
        "fp32 ViT-B/16", imagenet_phase, imagenet, IMAGENET_FP32_ARGV,
        "imagenet_fp32")
    profiler_phase([("ViT-B/16 forget step", *imagenet_bench(card), 2)],
                   card)
    lap("ImageNet phase")
    paths["train_pretrain"], paths["train_pretrain_lora_remat"] = \
        pretrain_phase()
    paths["train_pretrain_fp32"], paths["train_pretrain_lora_remat_fp32"] = \
        fp32_runs("fp32 pretrain", pretrain_phase, "float32")
    pre_run, pre_ms = pretrain_bench(card)
    profiler_phase([("pretrain step bs 480", pre_run, pre_ms, 2)], card)
    del pre_run
    lap("pretrain phase")
    paths["train_pretrain_folder"] = native_phase(card, pre_ms)
    lap("native phase")
    dp_launches, dp_refs = dp_phase(card)
    paths.update(dp_launches)
    lap("dp phase")
    paths.update({f"layout_{path}": counts for path, counts in
                  layout_phase(card, dp_refs, imagenet_tmp.name).items()})
    del dp_refs
    imagenet_tmp.cleanup()
    lap("layout phase")
    paths["baselines"] = baseline_phase()
    paths["baselines_fp32"] = fp32_runs(
        "fp32 baselines", baseline_phase, in_dtype(BASELINE_ARGV, "float32"),
        FP32_BASELINE_RUNS)
    lap("baseline phase")
    paths.update(integration_phase())
    paths["base_split"] = base_split_phase()
    lap("integration phase and base_split")
    baseline_bench(card)
    lap("baseline bench")
    paths.update(eval_phase(card))
    lap("eval phase")
    fill_launches(rows, paths)

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_script:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(*sys.argv[2:])  # one rank of dp_phase
    elif sys.argv[1:2] == ["--layout-rank"]:
        layout_rank_main(*sys.argv[2:])  # one rank of layout_phase
    else:
        main()
