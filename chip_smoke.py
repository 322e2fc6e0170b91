#!/usr/bin/env python3
"""Smoke test of the boda_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--phases env,build,kernels,...] [--kernels fused_stem,...]

Phases, run in order, each fatal on failure (all of them by default):
  env      card name and power limit (nvidia-smi), torch / CUDA / nvcc versions
  build    nvcc builds the hand-written kernels (boda_tpu_torch/csrc) for sm_90a
  kernels  each kernel against its plain PyTorch version at the ResNet-50
           shapes of its path (timed with CUDA events) and at ragged edge
           shapes (tconv: C not a multiple of 8, M and oc not multiples of
           its 128 tile, split K), f32 (mrd <= 1e-4) and bf16 (mrd <=
           5e-3); matmul_ext's plan (route, tile, K splits) for each case,
           with edges for split-K at M=1, K not a multiple of 8 (the
           element-staging variant) and offsets past 2^31; the fused_stem
           template's NCHW f32 and NHWC-storage bf16 forms against the bare
           kernel, fused_stem's plan (route, tile, blocks) for each case, a
           bf16 output held bit-equal to the same kernel's f32 output rounded
           after, and edges for what its routes mask (oc = 8 and 72, C = 3, 4
           and 5, rows staged element by element, an image smaller than a
           tile, pooled extents no tile divides, forced 7x8 and 4x16 tiles,
           f32 out of bf16, stride 1 with bf16 on the FFMA route, a 5x5
           filter under a 2x2 pool); resblock's plan (route, band rows, cluster, tile) for
           each case, with edges on the tensor-core route (bands that do
           not divide H, no output ReLU, f32 out of bf16, a cluster with a
           ragged last band) and on the FFMA route (ragged channels);
           sgemm_int8 and its quantize kernel alone bit-equal to
           their plain versions at 1024^3 and 4096^3 (timed, with the
           quantize pass and the product alone) and at ragged shapes (K=50,
           K=3, K=4099, N=129, an all-zero A); qconv (B6) and its
           activation quantize, with the dynamic form's two parts a dp
           slot runs (absmax; the quantize at a max read from device
           memory, also bit-equal to the dynamic form at x's own max),
           bit-equal to their plain versions at the
           int8 preset's nine distinct b32 conv shapes and two at b128
           (timed on the card alone through a CUDA graph, beside the
           wrapper's call and the quantize pass's byte bound; each case's
           plan: tiles, K chunks and splits, grid, copy widths) and at
           edges (C = 24, 20 and 3: 8-byte, 4-byte and element copies,
           ragged M and oc, stride 2 with padding, a 5x5 filter, an int8
           output edge, f32 out, an int8 input, a dynamic scale, a NaN in
           x, no bias, and K splits over ragged chunks, into an int8 output,
           under a NaN dynamic scale and at K = 133120 with every product
           127 * 127); B6 in its weight-gradient role at the grad_q8
           preset's four b32 shapes (kernel, quantize passes and wgrad_q8
           bit-equal and timed beside bf16 cuDNN's weight gradient) and at
           two strided sites; then B6 alone by K split count (`qconv
           splits` lines, what qconv_plan's split rule rests on).
           Each timed case also prints its bound (the larger of its FLOPs
           over the card's peak in its precision and its bytes, each input
           read and each output written once, over HBM bandwidth;
           core/machine.card_peaks) and the time of the PyTorch call that
           computes the same function (library: torch.addmm, F.conv2d on
           channels_last, torch._int_mm + the scale), or of the sequence
           of calls where no single one does (fused_stem: conv, ReLU,
           max-pool; resblock: three convs, add, ReLU). Then the tconv
           kernel alone, timed by K split count at the ResNet-50 3x3
           shapes (what tconv_plan's split rule rests on), and the
           matmul_ext kernel alone by K split count at the fc1000 and
           res4/res5 1x1 shapes (what matmul_plan's split rule rests on),
           and the resblock kernel alone by cluster size, tile and band
           rows at the four ResNet-50 stages, each result checked against
           the plain version (what resblock_plan's estimate rests on), and
           the fused_stem kernel alone by tile at conv1 + pool1, batch 32
           and 1 (what stem_plan's estimate rests on; its shared-memory sum
           and blocks per SM must equal the kernel's own). --kernels cuts
           the phase down to the named kernels
  vendor   the vendor conv template under prec=bf16 with NHWC bf16 storage,
           on kernel B7: at the 21 ResNet-50 b32 conv sigs its result is
           contiguous NHWC bf16 and agrees with the f64 conv of the rounded
           operands after one rounding (mrd 5e-3), B7 with its plain version
           (the vendor arithmetic), timed beside its bound and cuDNN's FP32
           conv; beside it, used nowhere in the port, the FP32 vendor form
           (channels_last) and the bf16 cuDNN form that rounds the sum before
           the bias: its mrd against the FP32 form, the share of stored
           values it moves, its time; then B7 at edges (no bias, f32 and int8
           stores, member widths off the 4-result stores, split K, C = 3, 6
           and 20) and at every distinct B7 step of the benchmark's three
           b128 cells, against its plain version and timed, with the sums
           per request
  gconv    kernel B8, the grouped conv under prec=bf16 with NHWC bf16
           storage: at ResNeXt-101 (64x4d)'s seven grouped 3x3 shapes at
           b128 against its plain version (the vendor arithmetic), timed
           beside its bound and cuDNN's bf16 grouped conv alone, with the
           sums over a request's 33 layers; at edges (no bias or ReLU,
           groups of 64 channels, ragged tiles, stride 2 on an odd input,
           pad 0); a grouped xla_conv step on route b8
  digests  TorchFwd at batch 1 under the f32 tune, the fused f32 tune and
           the f32 twin of the headline tune (vendor convs, sibling convs
           fused into xla_conv2) against the per-node digest archives recorded on a TPU
           (tests/data/tpu_digests): resnet-50@shapes40 (trained weights,
           mrd 3e-3) and resnet-50 (zoo weights, mrd 8e-3); a fused plan is
           compared on the nodes it produces
  agree    cls_agree on 64 held-out shapes-src images with the trained
           40-class ResNet-50, against the f32 tune: the bf16+NHWC tune, the
           fused bf16+NHWC tune and the headline tune (use_culibs=1, bf16,
           NHWC, fuse_siblings=1), top-1 >= 0.90 each and top-1 agreement
           >= 0.97; then the int8 preset (int8 with static scales at the 33
           sites of tune/presets.RESNET_INT8_SITE_PATS, scales calibrated on
           the trained weights) against the headline tune, also at
           tests/test_quant8.py's 64-image gates
  full     run_cnet on the 1000-class ResNet-50 at batch 32 under those three
           tunes' forms, the two f32 ones and the int8 preset (six tunes):
           kernel launch counts per forward, exact and equal to what the
           plan's steps send to each hand kernel (unfused: 40 matmul_ext, 13
           tconv; fused: 14 matmul_ext, 3 tconv, 1 fused_stem, 12 resblock;
           headline: none, with 4 xla_conv2 steps; int8: 31 qconv and 31
           act_quantize, one each per int8 step; no sgemm_int8), finite
           softmax rows, ms per forward and imgs/s, the card's busy time in
           one more forward (torch.profiler) and so its idle share, with
           its heaviest device kernels, and each template's summed step
           time over one more forward (CUDA events around each step); then
           one forward time, with its launches, of the headline tune and of
           the int8 preset at batch 128
  engine   the engine's second executor, the per-call mode (fuse=0: one
           be=torch call per plan step, each between CUDA events): at
           ResNet-50 b32 under () the per-call forward bit-equal to the
           fused one on prob and ten interior nodes, with 40 matmul_ext and
           13 tconv launches, its per_call_fn report (one line per step,
           summed per template) and both forwards' time and device-busy
           time; the int8 preset on the trained snapshot per call against
           the fused executor over the 64 held-out images (agreement >=
           0.97, top-1 >= 0.90), qconv once per int8 step; test_compute_multi
           through the CLI on resnet-50 b1 (engine=ref, fused, per-call;
           the TPU archive at mrd 8e-3) and vgg-19 b1 (fused, per-call; 3e-2);
           enable_stats in both executors against the returned nodes
           (min, max exact; mean within 1e-5 x mean|x|, sum(x^2) rtol 1e-5
           of float64 sums); nan_check clean and with a NaN in
           res3a_branch2b's filter (both executors name that node first), and
           run_fwd at b32 with nan_check and with enable_stats beside
           plain; VGG-19 b1 with train_dropout=1,det_drop_seed=7 and a
           quantize hook on fc8-conv against engine=ref (zeroed units of
           fc6/fc7 equal, mrd 3e-2, fc8 on the grid) and the seeded mask on
           the card against its numpy twin; test_lmdb per call over the
           held-out images written as an LMDB (top-1 >= 0.90); wisdom_fn
           (tests/data/wisdom-resnet50-b32.wis) at b32: the CPU's plan, one
           timed forward
  upload   the u8 wire's upload at b128 and b8 (224x224x3), from a pool of
           8 batches read in turn: io/device_preproc.PinnedStager's copy
           bit-equal to the pageable one (torch.from_numpy(x).to(card)),
           and both timed (wall ms to the copy's end; the staged one also
           until it returns)
  ops_prof the per-op path (mode ops_prof, be=torch): the vendor
           sgemm under prec=bf16 returns the unrounded f32 product; the six
           square SGEMMs of tests/data/ops/sgemm-baseline.txt (128^3-4096^3) under
           the tunes kg (cuBLAS FP32), hand (B1) and int8 (B3, mrd 5e-2 vs
           kg), then kg and bf16 at mrd 5e-3; the 21 ResNet-50 b32 conv sigs
           of resnet50-convs.txt under kg (cuDNN FP32) and hand (B1, B2),
           then kg and bf16; no COMP_FAIL, KG_DIGEST_FAIL or ERROR, exactly
           6 x run_iter sgemm_int8 launches (and as many quantize kernel
           launches) in the int8 sweep, wisdom under
           build/ops_prof/, a table of ms, TF/s (TOPS) and % of the card's
           own-precision peak per op and tune; then rtc_test
  zoo      the rest of the zoo (build/zoo_smoke): the zoo's templates at
           zoo shapes on the card against their float64 references (lrn
           at AlexNet's norm1, b128, f32 NCHW mrd 1e-5 and bf16 NHWC 5e-3;
           copy as GoogLeNet's inception_3b/output concat at b128,
           bit-equal and in place; deconv at deconv-tiny's layer and a 2x
           upsample of 256 channels at 56^2, b8; scale, xpose, xpose_filts,
           reduce, bwai), bwai's memory rates through ops_prof
           (tests/data/ops/bwai.txt, bwai-tiny.txt); B6 bit-equal at
           GoogLeNet's int8 shapes (the 5x5s with C = 16, 24, 32, 48, the
           3x3 with C = 96; timed); test_compute_multi at b1 on
           googlenet_conv_lrn, alexnet_ng_conv and squeezenet-1.0 (zoo
           weights; engine=ref, the fused () executor and the per-call
           mode on every node, mrd 1e-4; B1 and B2 launched as both plans
           say); cls_agree on the trained 40-class GoogLeNet over the 64
           held-out images (() against bf16 NHWC and against the headline
           tune, the headline tune against int8 at inception_.*/[35]x[35]
           with static scales calibrated on the trained weights; top-1 >=
           0.85, agreement >= 0.97); cnet_bench rows at b128 through the
           CLI (googlenet_conv, nin_imagenet, squeezenet-1.0,
           alexnet_ng_conv under the headline tune and under their int8
           site sets with static scales; GoogLeNet under ()): ms per
           forward, imgs/s, TF/s, share of the bf16 peak and each hand
           kernel's launches per forward, exactly as the plan says; in
           one more forward of every row that launches B1, B2 or B6,
           each distinct call recorded and held against its plain
           version (B1/B2 mrd 1e-4 f32, B6 and its quantize bit-equal);
           the card's busy share of one GoogLeNet and one AlexNet
           headline forward, and AlexNet's LRN share (norm1 and norm2
           timed alone at b128)
  serve    the serving path on ResNet-50 224², 1000 classes, zoo weights:
           aio_cls_selfcheck with 3 clients (max_batch_seen=3, one ()
           forward's launches); device_preproc_fn on the card equal to the
           host img_to_chw at 224² and within 1e-3 of the CPU at a resize
           down and up, and PrefetchFeeder's five batches in order, each
           within 1e-3 of the CPU's; serve_bench rows (n1=2, n2=8, max_batch = clients)
           on the u8 wire (preprocessing on the card) under () at 8 and
           32 clients, the headline tune at 8, 32 and 64 and the int8
           preset (the trained 40-class snapshot, its static scales) at 8
           and 32, and on the f32 wire under () at 8: req/s, ms/req,
           queue ms/req, engine ms/batch, mean batch, the hand kernels'
           launches per engine batch exact (B1 40 and B2 13 under (), none
           under the headline tune, B6 31 and its quantize 31 under int8),
           every client's last reply equal in classes to a direct run_fwd
           of its image in a zero-padded batch of the same size under the
           same engine (probabilities 1e-5 f32, 5e-3 bf16 and int8); in
           each row with hand-kernel launches (() and int8), every distinct
           B1, B2, B6 and quantize call of one more engine batch of the
           clients' images on the row's wire held against its plain
           version (as the zoo rows hold theirs); at 32
           clients (and the f32 wire's row) one engine call taken apart:
           run_fwd wall, upload, forward alone (CUDA events), busy
           (torch.profiler); the u8 wire's replies equal to the f32 wire's
           under () (1e-6); with pyzmq and PIL, zmq_cls_server on ResNet-50
           against a direct forward
  pyra     dense inference: pyra_bench on googlenet_conv, a 480x640 test
           frame in 640² bins (interval 3: 12 scales, 6 bins), pack=device
           under the headline tune and under () (B1 31 and B2 2 per
           forward, exact as the plan says; under () every distinct B1
           and B2 call of one more forward of the packed frame held against
           its plain version), with PIL also pack=host: pack
           ms, forward ms, frames/s serial and overlapped; the pyramid
           pack on the card within 1e-3 of the CPU; cnet_predict dense=1
           (the trained GoogLeNet at 320², inception_4e/output) on the
           card and on the CPU: the same boxes and labels, confidences
           1e-4; with PIL, conv_pyra predict=1 (host pack) on a 128² frame,
           card against CPU: the same annotations and feature digests
  train    training on the trained 40-class ResNet-50 (224², b32,
           shapes-src data, momentum): one batch's step-1 weight gradients
           under the headline tune against the f32 tune's (relative L2 of
           the whole gradient <= 8e-2, every blob's cosine >= 0.98; the
           per-blob mrd printed), every distinct bf16 cuDNN grad conv of
           its backward held against its FP32 plain form (mrd 5e-3); the
           grad_q8 preset (tune/presets.RESNET_GRAD_Q8_SITE_PATS) on the
           same batch: B6, act_quantize and cotangent_quantize (its
           per-channel form) launched once per planned int8 weight
           gradient, each distinct wgrad call bit-equal to
           wgrad_q8_plain, dx at every grad_q8 site bit-equal to the bf16
           VJP's; cnet_train three steps under the headline tune (no hand
           kernel) and under the preset (B6 and both quantize launches over
           the run = steps x the plan's count, counts zeroed just before),
           finite losses; a training forward under (), the fused tune
           and quant8 raises naming its first step with no backward,
           before any hand kernel launches; resume (2 steps, a snapshot,
           2 more) bit-identical
           to 4 straight steps in losses and weights; GoogLeNet (the trained
           weights on its LRN variant) three steps with train_dropout=1;
           train_bench rows (headline, grad_q8, remat=1): ms per step under
           the trainer's deterministic cuDNN and under cuDNN's defaults,
           imgs/s, TF/s at 3x the forward FLOPs, share of the bf16 peak,
           torch.cuda.max_memory_allocated; B6 in its wgrad role at the
           preset's four b32 site shapes (bit-equal; the kernel alone
           through a CUDA graph beside its plain version, its bound, bf16
           cuDNN's weight gradient, the quantize passes and the wgrad_q8
           wrapper; the kernels phase's readings where that phase ran)
  tune     the tuning and profiling surface, each through its mode in
           this process: ops_prof at the conv-baseline op (3x3, 384->384,
           13^2, b5, ReLU) under cuDNN FP32, the vendor conv in bf16, B2 and
           B1 (im2col) in bf16 (mrd 5e-3 against cuDNN FP32) and B6 (5e-2),
           each hand kernel launched once per timed call, us, TF/s and %
           of the own-precision peak per tune; the wisdom flow at ResNet-50
           b32: ops_prof over the net's 21 conv sigs under the vendor base
           (use_culibs=1,prec=bf16,layout=nhwc,s2d=0) and the hand tune
           (prec=bf16,layout=nhwc), fusion_penalty on that wisdom (8
           sites: a verdict line each, `<plat>@net` rows in records pinned
           to the sites), then cnet_bench with the merged wisdom against
           the vendor base in turns (vendor, wisdom, wisdom, vendor): each
           WINS site runs the template of its one-site net and each losing
           site the vendor one, launches per forward as the plan says, each
           distinct B1 and B2 call of one more forward held against its
           plain version; cnet_tune at ResNet-50 b32 over (), bf16 NHWC,
           the fused bf16 tune and the headline tune (one row each, one
           best: line, the winner file; the run's launches those of the
           rows' plans; each row with B1 or B2 held call by call);
           cnet_stage_probe under the fused bf16 tune (B4 in stem, B5 in
           s2-s5) and the headline tune, and bwd=1 under the headline tune
           (each stage's output against the whole net's value of its
           out_node, mrd 5e-3, bit-equal expected), bwd=1 under () refused
           by the inference-only guard before any launch; cnet_xprof (5
           steps) under (), the int8 preset and, bwd=1, the headline tune:
           each hand kernel's device kernels (its __global__ names in the
           trace) called as often as the plan's steps launch it (B1 40 and
           B2 13 a step under (), B6 31 and its quantize 31 under int8),
           the device total per step beside one forward's busy time; the
           per-model grid at b64 (cnet_bench on ResNet-101, ResNet-152,
           VGG-19 and VGG-16 under the headline tune and their int8 site
           sets with static scales: every entry of each scales file
           applied, launches per forward as the plan says, each int8 row's
           distinct B6 calls bit-equal to their plain versions)
  cli      the rest of the CLI: ResNet-50 b32 224^2 under () per call
           through a worker process that owns the card
           (rtc=(be=ipc,worker_be=torch)), bit-equal to the in-process
           per-call forward, the worker's launches B1 40 and B2 13 read
           over the protocol, both forwards timed; cs_test_master on the
           card; ops_prof over be=ipc beside be=torch at the conv-baseline
           op and the 21 ResNet-50 conv sigs (every row agreeing with the
           in-process kg row, the worker's launches this process's);
           test_dense and test_upsamp on ResNet-50 at 224^2 (under () at
           5e-5 and 2e-4, under bf16 NHWC at 5e-3); the JAX package's
           golden suites through `python -m boda_tpu_torch test_all` in a
           process of their own, started once the forwards are timed and
           run beside ops_prof and the dense modes, held to
           tests/test_torch_golden.py's closed list and value checks
  parallel parallel and multi-process on slots of the one card
           (BODA_TORCH_LOCAL_DEVICES): the engine's 2x2 mesh (mesh_dp=2,
           mesh_mp=2) at ResNet-50 b32 224^2 under (), bf16 NHWC and the
           int8 preset against the same forward without a mesh (mrd 1e-4,
           5e-3, 5e-2), B1/B2/B6 launched four times a forward's (every
           slot runs every step), the steps by route (column-parallel, on
           the whole weight), both forwards timed; on the same mesh the
           int8 preset with dynamic scales (no act_scales_fn): every
           slot's s_act bit-equal to the one-slot quantize of the step's
           whole batch (each slot's absmax, pmax over dp), and to the
           one-slot forward's where that batch is bit-equal to its, the
           logits within 5e-2, one absmax per slot and step beside one
           forward's launches, one pmax per int8 step; GoogLeNet b32
           224^2 under () with train_dropout=1 and a fed seed, the logits
           within 1e-4 of one slot's, B1/B2 four times a forward's, the
           mask live; mh_test with two gloo
           ranks launched here with --spawn=0 (one slot each; ResNet-50
           b32 224^2 forward, then one training step): identical digests,
           the forward's prob within 1e-4 of one slot's; then the
           gradient check over two ranks (mh_logits_run: the same model,
           input and labels, the forward's logits under () and one SGD
           step from the logits' softmax-CE under the f32 vendor tune,
           whose gradients do not vanish where the softmax saturates):
           identical on both ranks, the logits within 1e-4 and every
           weight's update within 1e-3 of the same run on one slot in
           this process, each rank's step and collectives ms; mh_test
           --num-processes=1; pp_test at ResNet-50 224^2, pp=4, M=6, both
           schedules; gpipe_plan_forward under () at the same cut within
           1e-5 of the sequential segments, B1/B2 six forwards' worth;
           dryrun_multichip(8) on 8 slots.
           Every rank and child has a timeout; one that runs past it is
           killed and fails the phase
  bench    the bench twin, python3 -m boda_tpu_torch.bench, in this
           process: bench.py's JSON line for its two plans at batch 128
           (the headline tune, and the int8 preset on the trained weights
           as the headline), its keys exactly bench.py's

A run of every phase that passes ends with four lines: the bench twin's
JSON line; the nvidia-smi name and power limit; a JSON object with one
entry per kernel ("launches": launches in one run of that kernel's own main
path, the f32 tune's forward for matmul_ext and tconv, the fused f32 tune's
for fused_stem and resblock, the int8 preset's b32 forward for qconv, and
the int8 SGEMM sweep of ops_prof for sgemm_int8; the entries of sgemm_int8
and qconv also hold their quantize kernels' launches there
("quantize_launches");
"launches_by_tune": in each of those runs, and in the engine phase's
per-call forwards ("percall_f32", "percall_int8"); "ms", "plain_ms", "bound_ms"
and "library_ms": summed over the timed shapes, "bound_by" that of the
case with the largest bound; "library_ms" is null for fused_stem and
resblock, which no single PyTorch call computes, and
"library_sequence_ms" holds the time of the sequence of calls that does;
"max_abs_err": over every checked shape; "cases": each timed case), the
b32 forward times (and the headline tune's and the int8 preset's at b128),
the card's busy time in a forward, the per-template step times, the
vendor phase's two sums, the engine phase's times ("engine") and the zoo
phase's readings ("zoo": templates, bwai rates, B6 at GoogLeNet's
shapes, cls_agree, the cnet_bench rows with what each held; the zoo
forwards' launches are
in each kernel's "launches_by_tune"), the serve phase's rows ("serve"; per
engine batch in "launches_by_tune" as "serve:<tune>:<wire>:<clients>")
and the pyra phase's ("pyra"; per forward as "pyra:<tune>:<pack>"),
the train phase's ("train"; B6's wgrad role is the kernel entry
"qconv_wgrad", its launches those of the grad_q8 preset's cnet_train run,
with its quantize kernels' as "quantize_launches" and
"cotangent_quantize_launches",
per step of each train_bench row as "train_bench:<tune>"), the tune
phase's ("tune": the conv-baseline rows, the wisdom flow's verdicts and
cnet_bench rows, cnet_tune's rows, the stage tables, cnet_xprof's
device totals and top kernels, the b64 grid), the cli phase's ("cli":
the per-call forward times in process and over be=ipc, test_dense's and
test_upsamp's lines, the suites' summaries; the worker's launches in
"launches_by_tune" as "cli:ipc", "cli:ops_prof_ipc:<file>" and
"cli:<mode>:<tune>"), the parallel phase's ("parallel": the mesh forwards
by tune with their mrd, ms beside the unsharded ms, routes and launches
per slot, mh_test's ms and collectives ms per rank, pp_test's lines,
the gradient check's, gpipe_plan_forward's, the dry run's; per mesh forward as
"parallel:mesh_<tune>", "parallel:mesh_int8_dynamic",
"parallel:mesh_train_dropout", "parallel:gpipe_forward" and
"parallel:dryrun" in "launches_by_tune"; B6's entry adds its dp split's
launches and pmax calls);
and {"ok": true,
"device": {...}}. Without a CUDA device, or outside a checkout of the
repo, it exits non-zero and prints no result. It imports neither jax nor
the JAX package boda_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
TRAINED = DATA / "resnet50-shapes40.boda"
# the tunes of the main paths: the engine default, the bf16 NHWC-storage
# tune, and both with the stem and the identity bottlenecks fused
FUSED = "fuse_stem=1,fuse_resblock=1"
TUNES = {"f32": "()", "bf16_nhwc": "(prec=bf16,layout=nhwc)",
         "fused_f32": f"({FUSED})",
         "fused_bf16_nhwc": f"(prec=bf16,layout=nhwc,{FUSED})",
         # the vendor tune the JAX bench times (bench.py's headline: every
         # conv on the vendor library, sibling convs fused into xla_conv2),
         # and its f32 twin, which the digest archives can be held to
         "headline": "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                     "fuse_siblings=1)",
         "sib_f32": "(use_culibs=1,fuse_siblings=1,s2d=0)"}
# bench.py's int8 tune, the selective-int8 preset: the headline tune with
# int8 (B6) at the 33 sites of tune/presets.RESNET_INT8_SITE_PATS, their
# activation scales static from the artifact calibrated for the weights
# (engine_spec); its 31 int8 steps are 29 xla_conv and 2 xla_conv2 (the
# res4a and res5a projection pairs)
INT8 = "int8"
SCALES = {"trained": DATA / "resnet50-shapes40-int8-scales.lexp",
          "zoo": DATA / "resnet50-b128-int8-scales.lexp"}
# the tunes whose b32 forward the `full` phase runs and times (and at b128)
FULL_TUNES = ("f32", "bf16_nhwc", "fused_f32", "fused_bf16_nhwc", "headline",
              INT8)
B128_TUNES = ("headline", INT8)
# exact kernel launches per ResNet-50 forward under each tune
UNFUSED_LAUNCHES = {"matmul_ext": 40, "tconv": 13, "fused_stem": 0,
                    "resblock": 0, "sgemm_int8": 0, "quantize": 0,
                    "qconv": 0, "act_quantize": 0, "absmax": 0,
                    "cotangent_quantize": 0, "bconv": 0, "gconv": 0}
FUSED_LAUNCHES = {**UNFUSED_LAUNCHES, "matmul_ext": 14, "tconv": 3,
                  "fused_stem": 1, "resblock": 12}
# the headline tune's 50 conv steps (46 xla_conv, 4 xla_conv2) on B7; the
# int8 preset's 19 float ones (17 and 2) on B7, its 31 int8 ones on B6
VENDOR_LAUNCHES = {**dict.fromkeys(UNFUSED_LAUNCHES, 0), "bconv": 50}
INT8_LAUNCHES = {**VENDOR_LAUNCHES, "qconv": 31, "act_quantize": 31,
                 "bconv": 19}
# (prec=bf16,layout=nhwc): conv1 is an s2d_conv step, on B7
LAUNCHES = {"f32": UNFUSED_LAUNCHES,
            "bf16_nhwc": {**UNFUSED_LAUNCHES, "bconv": 1},
            "fused_f32": FUSED_LAUNCHES, "fused_bf16_nhwc": FUSED_LAUNCHES,
            "headline": VENDOR_LAUNCHES, INT8: INT8_LAUNCHES}
# the hand kernel each template launches once per step (the conv steps,
# conv.CONV_STEPS, launch the kernel of their conv.conv_route, the
# plain-torch templates none)
TEMPLATE_KERNEL = {"k1conv": "matmul_ext", "conv": "matmul_ext",
                   "ipconv": "matmul_ext", "tconv": "tconv",
                   "fused_stem": "fused_stem", "resblock": "resblock"}
# the hand kernel of a conv step's float route on inference
ROUTE_KERNEL = {"b7": "bconv", "b8": "gconv"}
# each kernel's own main path: the tune whose forward runs it, or the
# per-op sweep (ops_prof's int8 sgemm run) for sgemm_int8
KERNEL_PATH = {"matmul_ext": "f32", "tconv": "f32",
               "fused_stem": "fused_f32", "resblock": "fused_f32",
               "sgemm_int8": "ops_prof", "qconv": INT8}
SOURCES = {
    "matmul_ext": ("boda_tpu_torch/csrc/sgemm.cu",
                   "boda_tpu/ops/pallas/sgemm.py:114"),
    "tconv": ("boda_tpu_torch/csrc/tconv.cu", "boda_tpu/ops/pallas/tconv.py:62"),
    "fused_stem": ("boda_tpu_torch/csrc/stem.cu",
                   "boda_tpu/ops/pallas/stem.py:57"),
    "resblock": ("boda_tpu_torch/csrc/resblock.cu",
                 "boda_tpu/ops/pallas/resblock.py:31"),
    "sgemm_int8": ("boda_tpu_torch/csrc/qsgemm.cu",
                   "boda_tpu/ops/pallas/qsgemm.py:47"),
    # an XLA int8 conv in the JAX package, not a Pallas kernel
    "qconv": ("boda_tpu_torch/csrc/qconv.cu",
              "boda_tpu/ops/pallas/conv.py:187"),
}
F32_MRD, BF16_MRD = 1e-4, 5e-3
# the per-op path: ops_prof calls (op-sig file, tunes, tolerances).
# bf16 runs in calls of its own, since its tolerance is wider than the f32
# tunes' (func_mrd_toler keys by func name, and f32 and bf16 are both sgemm)
OPS_RUN_ITER = 5
OPS_PROF = [
    ("sgemm", "sgemm-baseline.txt",
     "(kg=(use_culibs=1),hand=(),int8=(prec=int8))",
     "func_mrd_toler=(sgemm_int8=5e-2)"),
    ("sgemm_bf16", "sgemm-baseline.txt", "(kg=(use_culibs=1),bf16=(prec=bf16))",
     "mrd_toler=5e-3"),
    ("rn50_convs", "resnet50-convs.txt", "(kg=(use_culibs=1),hand=())", ""),
    ("rn50_convs_bf16", "resnet50-convs.txt",
     "(kg=(use_culibs=1),bf16=(prec=bf16))", "mrd_toler=5e-3"),
]
# exact sgemm_int8 launches of the int8 sweep, and of its quantize kernel: 6
# ops x run_iter timed calls (profile_rcg_call makes no launch outside its
# timed loop)
OPS_INT8_LAUNCHES = 6 * OPS_RUN_ITER


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def engine_spec(tune_name: str, weights: str = "zoo") -> str:
    """The engine attributes (op_tune, and the int8 preset's per-op tunes
    and scales) of a tune of TUNES, or of INT8 with the scales calibrated
    for `weights` ("trained" or "zoo")."""
    if tune_name != INT8:
        return f"op_tune={TUNES[tune_name]}"
    from boda_tpu_torch.bench import int8_engine_spec
    return int8_engine_spec(TUNES["headline"], SCALES[weights])


def smi_line() -> str:
    """`name, power.limit` of the card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds of fn() on the card: the median over three windows of
    the mean of `reps` back-to-back calls between two CUDA events, after
    one warm-up call (the bench twin's timer, bench.time_forward). A call
    short enough that the host sets its pace varies with the host's load;
    the median drops the windows it slowed."""
    from boda_tpu_torch.bench import time_forward
    return time_forward(fn, reps)[1]


def graph_ms(fn, reps: int = 20) -> float:
    """Milliseconds of fn() on the card alone: `reps` calls captured once
    in a CUDA graph, the graph replayed as cuda_ms times it, over reps. The
    host's work per call (checks, allocation, the launch itself) is left
    out, which matters where it takes longer than the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    ms = cuda_ms(g.replay, 5) / reps
    del g
    return ms


def bit_equal(got, want) -> bool:
    """got and want hold the same values, NaN where the other holds NaN."""
    return got.shape == want.shape and got.dtype == want.dtype and bool(
        ((got == want) | (got.isnan() & want.isnan())).all())


def mrd(got, want) -> float:
    """max |got - want| over max |want| (both cast to f64)."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------- phases

def phase_env(ctx: dict) -> None:
    import torch
    from boda_tpu_torch.core.device import nvcc_path
    print(f"nvidia-smi: {ctx['smi']}")
    nvcc = nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{ver}'")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()}")


def phase_build(ctx: dict) -> None:
    from boda_tpu_torch.ops.cuda import build
    lib, secs, log = build.build_library()
    ctx["build_log"] = log
    print(f"build: {lib.name} in {secs:.1f} s")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln \
                or "warning" in ln.lower():
            print(f"  ptxas: {ln.strip()}")
    build.load_kernels()


def _kernel_cases():
    """(label, kernel, shape) at the shapes the ResNet-50 main paths give
    each kernel. Inputs are made on the card from a seed."""
    return [
        # res2a_branch2a: 1x1 64->64 at b32, 56^2 (k1conv)
        ("res2a_branch2a 1x1 M=100352 K=64 N=64", "matmul_ext",
         dict(M=32 * 56 * 56, K=64, N=64, relu=True)),
        # a res2 3x3 (C=64, so the im2col `conv` route) at b32
        ("res2 3x3 im2col M=100352 K=576 N=64", "matmul_ext",
         dict(M=32 * 56 * 56, K=576, N=64, relu=True)),
        ("fc1000 M=1 K=2048 N=1000", "matmul_ext",
         dict(M=1, K=2048, N=1000, relu=False)),
        ("fc1000 M=32 K=2048 N=1000", "matmul_ext",
         dict(M=32, K=2048, N=1000, relu=False)),
        # res4b_branch2b: 3x3 pad 1, C=oc=256 at 14^2, b32 (tconv)
        ("res4b_branch2b 3x3 n=32 14^2 C=256", "tconv",
         dict(n=32, H=14, W=14, C=256, oc=256, relu=True)),
        # a res5 3x3 at batch 1: C=oc=512 at 7^2 (mostly empty tiles)
        ("res5 3x3 n=1 7^2 C=512", "tconv",
         dict(n=1, H=7, W=7, C=512, oc=512, relu=True)),
        # conv1 7x7/s2/p3 + pool1 3x3/s2 ceil at b32: 224^2 -> 56^2
        ("conv1+pool1 n=32 224^2 3->64", "fused_stem",
         dict(n=32, H=224, W=224, C=3, oc=64)),
        # the fused identity bottlenecks at b32, and res5 at batch 1
        ("res2b n=32 56^2 C=256 Cm=64", "resblock",
         dict(n=32, H=56, W=56, C=256, Cm=64)),
        ("res3b n=32 28^2 C=512 Cm=128", "resblock",
         dict(n=32, H=28, W=28, C=512, Cm=128)),
        ("res4b n=32 14^2 C=1024 Cm=256", "resblock",
         dict(n=32, H=14, W=14, C=1024, Cm=256)),
        ("res5b n=32 7^2 C=2048 Cm=512", "resblock",
         dict(n=32, H=7, W=7, C=2048, Cm=512)),
        ("res5b n=1 7^2 C=2048 Cm=512", "resblock",
         dict(n=1, H=7, W=7, C=2048, Cm=512)),
    ]


def _edge_cases():
    """Ragged shapes the ResNet-50 path never gives the kernels (K and C
    not multiples of 4 or of a tile, a 5x5 filter, a stem whose pool
    windows run past the conv output, bands that do not divide H): checked,
    not timed."""
    return [
        ("edge M=77 K=50 N=33", "matmul_ext", dict(M=77, K=50, N=33, relu=True)),
        ("edge M=1 K=3 N=1", "matmul_ext", dict(M=1, K=3, N=1, relu=False)),
        # K % 8 != 0 over two row tiles: bf16 stages element by element
        ("edge M=300 K=50 N=200", "matmul_ext",
         dict(M=300, K=50, N=200, relu=True)),
        # the fc at M=1 split over K, with ragged K and an odd N
        ("edge split-K M=1 K=2050 N=1001", "matmul_ext",
         dict(M=1, K=2050, N=1001, relu=False)),
        # M*K past 2^31: 64-bit offsets into A and C
        ("edge 64-bit M=2097153 K=1024 N=64", "matmul_ext",
         dict(M=2 ** 21 + 1, K=1024, N=64, relu=False)),
        ("edge 5x5 pad 2 n=2 5x9 C=13 oc=70", "tconv",
         dict(n=2, H=5, W=9, C=13, oc=70, k=5, pad=2, relu=False)),
        ("edge 1x1 n=1 3x3 C=6 oc=5", "tconv",
         dict(n=1, H=3, W=3, C=6, oc=5, k=1, pad=0, relu=True)),
        # M = 429 and oc = 72 off the 128 tile; then a K split (18 splits
        # in bf16, 96 in f32 on 132 SMs; ops/cuda/tconv.tconv_plan)
        ("edge 3x3 n=3 13x11 C=64 oc=72", "tconv",
         dict(n=3, H=13, W=11, C=64, oc=72, relu=True)),
        ("edge split-K 3x3 n=1 7^2 C=256 oc=200", "tconv",
         dict(n=1, H=7, W=7, C=256, oc=200, relu=False)),
        # tests/test_stem.py:53-54
        ("edge stem n=2 48x40 oc=8 no bias", "fused_stem",
         dict(n=2, H=48, W=40, C=3, oc=8, bias=False)),
        ("edge stem n=1 58^2 oc=16", "fused_stem",
         dict(n=1, H=58, W=58, C=3, oc=16)),
        # what the routes mask: two blocks of output channels, the second
        # ragged; C = 5 (filter rows of 35 values, padded to 48 on the
        # tensor cores); rows that are no 16-byte multiples (patches staged
        # element by element); an image smaller than one tile; a pooled
        # extent no tile divides; f32 out of bf16 in; stride 1, which in
        # bf16 cannot take the tensor cores (the FFMA route on bf16); a 5x5
        # filter under a 2x2 pool
        ("edge stem n=2 40x36 oc=72", "fused_stem",
         dict(n=2, H=40, W=36, C=3, oc=72)),
        ("edge stem n=2 30x34 C=5 oc=24", "fused_stem",
         dict(n=2, H=30, W=34, C=5, oc=24)),
        ("edge stem n=1 21x19 oc=8", "fused_stem",
         dict(n=1, H=21, W=19, C=3, oc=8)),
        ("edge stem n=3 12^2 oc=64", "fused_stem",
         dict(n=3, H=12, W=12, C=3, oc=64)),
        ("edge stem n=2 70x94 oc=40", "fused_stem",
         dict(n=2, H=70, W=94, C=3, oc=40)),
        ("edge stem f32 out n=2 64^2 oc=64", "fused_stem",
         dict(n=2, H=64, W=64, C=3, oc=64, out_f32=True)),
        # a forced tile (ty, tx) instead of the plan's small ones
        ("edge stem tile 7x8 n=2 70x94 oc=40", "fused_stem",
         dict(n=2, H=70, W=94, C=3, oc=40, force=(7, 8))),
        ("edge stem tile 7x8 n=3 12^2 oc=64", "fused_stem",
         dict(n=3, H=12, W=12, C=3, oc=64, force=(7, 8))),
        ("edge stem tile 4x16 n=2 40x36 oc=72", "fused_stem",
         dict(n=2, H=40, W=36, C=3, oc=72, force=(4, 16))),
        ("edge stem stride 1 n=2 20x24 oc=16", "fused_stem",
         dict(n=2, H=20, W=24, C=3, oc=16, stride=1)),
        ("edge stem 5x5 pad 2 pool 2x2 n=2 32^2 C=4 oc=32", "fused_stem",
         dict(n=2, H=32, W=32, C=4, oc=32, k=5, pad=2,
              pool=((2, 2), (2, 2)))),
        # tests/test_resblock.py:150-151, and one without the output ReLU
        ("edge resblock n=1 10^2 C=16 Cm=8", "resblock",
         dict(n=1, H=10, W=10, C=16, Cm=8)),
        ("edge resblock n=2 9x7 C=32 Cm=8", "resblock",
         dict(n=2, H=9, W=7, C=32, Cm=8)),
        ("edge resblock relu_out=0 n=2 5x6 C=12 Cm=5", "resblock",
         dict(n=2, H=5, W=6, C=12, Cm=5, relu_out=False)),
        # channels in whole 64-value chunks: bf16 on the tensor-core route.
        # Bands that do not divide H; no output ReLU; f32 out of bf16 in; a
        # forced plan (ty, cluster, tile_m, tile_n): a cluster of 4 over
        # bands of 5 rows of 13, on both tiles
        ("edge resblock n=2 13x11 C=256 Cm=64", "resblock",
         dict(n=2, H=13, W=11, C=256, Cm=64)),
        ("edge resblock relu_out=0 n=1 9^2 C=128 Cm=64", "resblock",
         dict(n=1, H=9, W=9, C=128, Cm=64, relu_out=False)),
        ("edge resblock f32 out n=3 7^2 C=512 Cm=128", "resblock",
         dict(n=3, H=7, W=7, C=512, Cm=128, out_f32=True)),
        ("edge resblock cluster 4 ty 5 n=2 13x11 C=512 Cm=128", "resblock",
         dict(n=2, H=13, W=11, C=512, Cm=128, force=(5, 4, 64, 128))),
        ("edge resblock cluster 2 ty 5 n=2 13x11 C=512 Cm=128", "resblock",
         dict(n=2, H=13, W=11, C=512, Cm=128, force=(5, 2, 128, 128))),
        ("edge resblock cluster 8 ty 4 n=1 7x9 C=64 Cm=64", "resblock",
         dict(n=1, H=7, W=9, C=64, Cm=64, force=(4, 8, 128, 64))),
    ]


def _kernel_args(kname, kw, dt, dev, gen):
    """(kernel call, plain call in dt, plain call in f32) on seeded inputs
    of one case. The f32 plain result is what a bf16 output is held
    against: the kernel's one rounding to bf16 then costs at most half an
    ulp, 2^-8 of the largest value."""
    import torch
    from boda_tpu_torch.ops.cuda.resblock import resblock, resblock_plain
    from boda_tpu_torch.ops.cuda.sgemm import matmul_ext, matmul_ext_plain
    from boda_tpu_torch.ops.cuda.stem import fused_stem, fused_stem_plain
    from boda_tpu_torch.ops.cuda.tconv import tconv, tconv_plain

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(dt)

    if kname == "matmul_ext":
        M, K, N = kw["M"], kw["K"], kw["N"]
        args = (randn(M, K), randn(N, K, scale=K ** -0.5),
                torch.randn(N, device=dev, generator=gen), kw["relu"])
        fns, plain = matmul_ext, matmul_ext_plain
    elif kname == "tconv":
        n, H, W, C, oc = kw["n"], kw["H"], kw["W"], kw["C"], kw["oc"]
        k, pad = kw.get("k", 3), kw.get("pad", 1)
        # the filter in OHWI order, as the tconv template hands it over
        args = (randn(n, H, W, C), randn(oc, k, k, C, scale=(k * k * C) ** -0.5),
                torch.randn(oc, device=dev, generator=gen), (pad, pad),
                kw["relu"])
        fns, plain = tconv, tconv_plain
    elif kname == "fused_stem":
        n, H, W, C, oc = kw["n"], kw["H"], kw["W"], kw["C"], kw["oc"]
        k, pad, st = kw.get("k", 7), kw.get("pad", 3), kw.get("stride", 2)
        bias = torch.randn(oc, device=dev, generator=gen) \
            if kw.get("bias", True) else None
        args = (randn(n, H, W, C), randn(oc, C, k, k, scale=(k * k * C) ** -0.5),
                bias, (pad, pad), kw.get("pool", ((3, 3), (2, 2))), True)

        def fns(*a, **k2):
            return fused_stem(*a, stride=(st, st), **k2)

        def plain(*a, **k2):
            return fused_stem_plain(*a, stride=(st, st), **k2)
        if "force" in kw:
            def fns(*a, out_dtype):
                return _stem_forced_case(a, out_dtype, kw["force"])
    else:
        n, H, W, C, Cm = kw["n"], kw["H"], kw["W"], kw["C"], kw["Cm"]
        args = (randn(n, H, W, C), randn(Cm, C, scale=C ** -0.5),
                # the filter in OHWI order, as the template hands it over
                randn(Cm, scale=0.1), randn(Cm, 3, 3, Cm, scale=(9 * Cm) ** -0.5),
                randn(Cm, scale=0.1), randn(C, Cm, scale=Cm ** -0.5),
                randn(C, scale=0.1), kw.get("relu_out", True))
        fns, plain = resblock, resblock_plain
        if "force" in kw:
            def fns(*a, out_dtype):
                return _resblock_forced(a, out_dtype, kw["force"])
    odt = torch.float32 if kw.get("out_f32") else dt
    return (lambda: fns(*args, out_dtype=odt),
            lambda: plain(*args, out_dtype=odt),
            lambda: plain(*args)), args


def _resblock_forced(args, out_dtype, force, out=None):
    """The resblock kernel through its C entry point under a given (ty,
    cluster, tile_m, tile_n) instead of resblock_plan's choice; the route
    and the load width follow the operands as in the plan."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.resblock import plan_route
    x, w1, b1, w2, b2, w3, b3, relu_out = args
    n, H, W, C = x.shape
    Cm = w1.shape[0]
    ty, cluster, tile_m, tile_n = force
    bf = x.dtype == torch.bfloat16
    route, vec = plan_route(C, Cm, x.element_size())
    if out is None:
        out = torch.empty_like(x, dtype=out_dtype)
    rc = load_kernels().boda_resblock(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        n, H, W, C, Cm, ty, cluster, int(route == "mma"), tile_m, tile_n,
        int(vec),
        int(bf), int(out_dtype == torch.bfloat16), int(bool(relu_out)),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc == 0, f"resblock forced plan {force}: launch failed with "
                   f"cudaError {rc}")
    return out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and hasattr(t, "element_size"))


def _work(kname, args, out) -> int:
    """FLOPs (OPs for sgemm_int8) of one call of a kernel case."""
    if kname in ("matmul_ext", "sgemm_int8"):
        (M, K), N = args[0].shape, out.shape[1]
        return 2 * M * N * K
    if kname == "tconv":
        _oc, ky, kx, C = args[1].shape
        return 2 * out.numel() * ky * kx * C
    if kname == "fused_stem":
        # of the timed case, ResNet's conv1: 7x7 at stride 2
        x, w = args[:2]
        n, H, W, C = x.shape
        (py, px), (sy, sx) = args[3], (2, 2)
        cy, cx = (H + 2 * py - 7) // sy + 1, (W + 2 * px - 7) // sx + 1
        return 2 * n * cy * cx * w.shape[0] * 49 * C
    x, w1 = args[:2]
    n, H, W, C = x.shape
    Cm = w1.shape[0]
    return 2 * n * H * W * (2 * C * Cm + 9 * Cm * Cm)


def bound(peaks, prec: str, work: int, nbytes: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for `work`
    operations in `prec` moving `nbytes`, each input read once and each
    output written once."""
    t_ops = work / peaks.flops(prec)
    t_bytes = nbytes / peaks.hbm_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _library(kname, args, dt):
    """(fn, kind) of the PyTorch yardstick of a kernel case: one call that
    computes the same function ("call"), or the sequence of calls that
    does where no single one does ("sequence"). The port never calls it."""
    import torch
    import torch.nn.functional as F
    cl = torch.channels_last
    if kname == "matmul_ext":
        a, b, bias = args[:3]
        bb = bias.to(dt)
        return (lambda: torch.addmm(bb, a, b.t())), "call"
    if kname == "tconv":
        x, w, bias, pad = args[:4]
        # the NHWC x and the OHWI filter are channels_last NCHW / OIHW views
        xc, wc, bb = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), bias.to(dt)
        return (lambda: F.conv2d(xc, wc, bb, padding=pad)), "call"
    if kname == "fused_stem":
        x, w, bias, pad, pool = args[:5]
        xc, wc = x.permute(0, 3, 1, 2), w.contiguous(memory_format=cl)
        bb = None if bias is None else bias.to(dt)
        return (lambda: F.max_pool2d(torch.relu(F.conv2d(
            xc, wc, bb, stride=2, padding=pad)), pool[0], pool[1],
            ceil_mode=True)), "sequence"
    x, w1, b1, w2, b2, w3, b3, relu_out = args
    C, Cm = x.shape[3], w1.shape[0]
    xc = x.permute(0, 3, 1, 2)
    w1c = w1.reshape(Cm, C, 1, 1).contiguous(memory_format=cl)
    w2c = w2.permute(0, 3, 1, 2)     # OHWI is channels_last OIHW
    w3c = w3.reshape(C, Cm, 1, 1).contiguous(memory_format=cl)

    def seq():
        h = torch.relu(F.conv2d(xc, w1c, b1))
        h = torch.relu(F.conv2d(h, w2c, b2, padding=1))
        y = F.conv2d(h, w3c, b3) + xc
        return torch.relu(y) if relu_out else y
    return seq, "sequence"


def _stats(name: str) -> dict:
    source, replaces = SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": 0.0, "max_mrd": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
            "library_ms": 0.0, "cases": []}


def _add_case(s: dict, case: dict) -> None:
    """Sum a timed case into its kernel's entry. A case timed against a
    sequence of calls keeps that time as library_sequence_ms: its
    library_ms, and its kernel's, is null."""
    for k in ("ms", "plain_ms", "bound_ms"):
        s[k] += case[k]
    if case["library"] == "sequence":
        case["library_sequence_ms"] = case["library_ms"]
        case["library_ms"] = None
        s["library_sequence_ms"] = s.get("library_sequence_ms", 0.0) + \
            case["library_sequence_ms"]
    s["library_ms"] = None if s["library_ms"] is None \
        or case["library_ms"] is None else s["library_ms"] + case["library_ms"]
    if all(case["bound_ms"] >= c["bound_ms"] for c in s["cases"]):
        s["bound_by"] = case["bound_by"]
    s["cases"].append(case)


def _check_stem_template(args, kw, dt, got) -> str:
    """The fused_stem template in the form each main path runs it (f32:
    NCHW in and out; bf16: NHWC bf16-edge storage) on the same operands
    must give the bare kernel's output exactly."""
    import torch
    from boda_tpu_torch.ops.cuda.stem import make_stem_op
    from boda_tpu_torch.ops.registry import get_template
    x, w, bias = args[:3]
    n, H, W, C = x.shape
    (pk, _), (ps, _) = kw.get("pool", ((3, 3), (2, 2)))
    op = make_stem_op(n, C, H, W, w.shape[0], k=kw.get("k", 7),
                      s=kw.get("stride", 2), p=kw.get("pad", 3), pool_k=pk,
                      pool_s=ps, bias=bias is not None)
    if dt == torch.bfloat16:
        op.str_vals.update(prec="bf16", io_layout="nhwc", edge_prec="bf16")
    t = get_template("fused_stem")
    fn = t.build(t.check_args(op))
    targs = (x, w) + ((bias,) if bias is not None else ())
    if dt == torch.bfloat16:
        out, form = fn(*targs), "NHWC bf16 storage"
    else:
        out = fn(x.permute(0, 3, 1, 2).contiguous(), *targs[1:])
        out, form = out.permute(0, 2, 3, 1), "NCHW f32"
    check(torch.equal(out, got), f"fused_stem template ({form}) differs "
                                 f"from the bare kernel")
    return form


def _qsgemm_cases():
    """(label, M, K, N, operands, timed) of sgemm_int8: the square sizes
    of the per-op sweep (tests/data/ops/sgemm-baseline.txt), timed; ragged
    shapes (K not a multiple of 4 or 16), a single element, an all-zero A,
    and a NaN in A with an inf in B (a NaN scale, so NaN throughout),
    checked. operands: "randn", "zero" (A all zero) or "nan"."""
    return [("1024^3", 1024, 1024, 1024, "randn", True),
            ("4096^3", 4096, 4096, 4096, "randn", True),
            ("edge M=77 K=50 N=33", 77, 50, 33, "randn", False),
            ("edge M=1 K=3 N=1", 1, 3, 1, "randn", False),
            ("edge zero A M=130 K=96 N=70", 130, 96, 70, "zero", False),
            ("edge NaN in A, inf in B M=130 K=96 N=70", 130, 96, 70, "nan",
             False),
            ("edge M=200 K=4099 N=129", 200, 4099, 129, "randn", False),
            # ragged N on the 16-byte copies (K % 16 == 0)
            ("edge M=130 K=256 N=129", 130, 256, 129, "randn", False)]


def _check_qsgemm(stats: dict, dev, gen, peaks) -> None:
    """sgemm_int8 against its plain version on the card: bit-equal (the
    int32 sums are exact and both round the same), and so its quantize
    kernel alone against quantize_operands_plain; and its time, the plain
    version's, and those of its two parts alone: the quantize pass and the
    kernel's product."""
    import torch
    from boda_tpu_torch.ops.cuda.qsgemm import int8_product, \
        quantize_operands, quantize_operands_plain, sgemm_int8, \
        sgemm_int8_plain
    s = stats["sgemm_int8"] = _stats("sgemm_int8")
    for label, M, K, N, operands, timed in _qsgemm_cases():
        a = torch.randn(M, K, device=dev, generator=gen)
        b = torch.randn(K, N, device=dev, generator=gen)
        if operands == "zero":
            a.zero_()
        if operands == "nan":
            a[M // 2, K // 3] = float("nan")
            b[K // 2, N // 3] = float("inf")
        q_got, q_want = quantize_operands(a, b), quantize_operands_plain(a, b)
        torch.cuda.synchronize()
        check(all(bit_equal(g, w) for g, w in zip(q_got, q_want)),
              f"sgemm_int8 {label}: the quantize kernel differs from "
              f"quantize_operands_plain")
        got = sgemm_int8(a, b)
        torch.cuda.synchronize()
        want = sgemm_int8_plain(a, b)
        # NaN where both are NaN (bit_equal holds them to that) counts 0
        abs_err = float((got.double() - want.double()).abs().nan_to_num(0.0)
                        .max())
        s["max_abs_err"] = max(s["max_abs_err"], abs_err)
        print(f"kernel sgemm_int8 f32->f32 {label:36s} bit-equal="
              f"{bit_equal(got, want)} (quantize bit-equal) "
              f"max_abs={abs_err:.3e}", end="")
        check(bit_equal(got, want), f"sgemm_int8 {label}: differs from its "
                                    f"plain version (max abs {abs_err:.3e})")
        if operands == "nan":
            check(bool(got.isnan().all()), f"sgemm_int8 {label}: a NaN "
                                           f"operand left finite outputs")
        else:
            check(bool(torch.isfinite(got).all()), f"sgemm_int8 {label}: "
                                                   f"non-finite output")
        if not timed:
            print()
            continue
        ms = cuda_ms(lambda: sgemm_int8(a, b), 20)
        plain_ms = cuda_ms(lambda: sgemm_int8_plain(a, b), 20)
        quant_ms = cuda_ms(lambda: quantize_operands(a, b), 20)
        q = quantize_operands(a, b)
        prod_ms = cuda_ms(lambda: int8_product(*q), 20)
        tops = 2 * M * N * K / ms / 1e9
        bound_ms, bound_by = bound(peaks, "int8", 2 * M * N * K,
                                   _nbytes(a, b, got))
        # the yardstick: torch._int_mm on the quantized operands, then the
        # scale; n/a where its shape rules refuse the case
        qa, qbt, sc = q[0], q[1].t(), q[2]
        try:
            torch._int_mm(qa, qbt)
            lib_ms = cuda_ms(lambda: torch._int_mm(qa, qbt) * sc, 20)
        except RuntimeError:
            lib_ms = None
        print(f" kernel {ms:.4f} ms ({tops:.1f} TOPS) plain {plain_ms:.4f} ms;"
              f" quantize pass {quant_ms:.4f} ms, product alone "
              f"{prod_ms:.4f} ms ({2 * M * N * K / prod_ms / 1e9:.1f} TOPS);"
              f" bound {bound_ms:.4f} ms ({bound_by}); library _int_mm + "
              f"scale {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        _add_case(s, {"case": label, "dtype": "float32", "mrd": 0.0,
                      "ms": ms, "plain_ms": plain_ms,
                      "quantize_ms": quant_ms, "product_ms": prod_ms,
                      "tops": tops, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": lib_ms,
                      "library": "call: torch._int_mm * scale (quantized "
                                 "operands)"})


def _qconv_cases():
    """(label, case, timed) of B6 and its quantize kernel: the int8
    preset's distinct conv shapes at batch 32 (x bf16 NHWC, a static
    scale; a single conv stored bf16, with ReLU where the plan has it; a
    sibling pair concatenated on N and stored f32 before its members'
    ReLUs, as the xla_conv2 template runs it), timed; two of them at batch
    128, the bench's, timed; then edges, checked:
    C = 24 (8-byte copies), C = 20 (4-byte), C = 3 (element staging),
    ragged M and oc, stride 2 with padding, an int8 output edge, an f32
    output, an input that arrives int8 (s_act by value), a dynamic scale,
    a NaN in x (dynamic and static), no bias; and K splits the plan makes:
    over chunks the splits do not divide, into an int8 output, under a NaN
    dynamic scale, and at K = 133120, just under K_MAX, with every product
    127 * 127 (the int32 sum 2147092480). `split` / `ragged` cases check
    that the plan splits (over a chunk count the splits do not divide)."""
    def c(n, H, C, oc, k=1, s=1, p=0, relu=True, **kw):
        return dict(n=n, H=H, W=kw.pop("W", H), C=C, oc=oc, k=k, s=s, p=p,
                    relu=relu, **kw)
    return [
        ("res3 3x3 n=32 28^2 128->128", c(32, 28, 128, 128, 3, p=1), True),
        ("res4a pair 1x1/s2 n=32 28^2 512->1280",
         c(32, 28, 512, 1280, s=2, relu=False, out="f32"), True),
        ("res4 3x3 n=32 14^2 256->256", c(32, 14, 256, 256, 3, p=1), True),
        ("res4 1x1 n=32 14^2 256->1024", c(32, 14, 256, 1024, relu=False),
         True),
        ("res4 1x1 n=32 14^2 1024->256", c(32, 14, 1024, 256), True),
        ("res5a pair 1x1/s2 n=32 14^2 1024->2560",
         c(32, 14, 1024, 2560, s=2, relu=False, out="f32"), True),
        ("res5 3x3 n=32 7^2 512->512", c(32, 7, 512, 512, 3, p=1), True),
        ("res5 1x1 n=32 7^2 512->2048", c(32, 7, 512, 2048, relu=False),
         True),
        ("res5 1x1 n=32 7^2 2048->512", c(32, 7, 2048, 512), True),
        ("res3 3x3 n=128 28^2 128->128", c(128, 28, 128, 128, 3, p=1), True),
        ("res4a pair 1x1/s2 n=128 28^2 512->1280",
         c(128, 28, 512, 1280, s=2, relu=False, out="f32"), True),
        ("edge C=24 3x3 n=2 9x7 oc=40", c(2, 9, 24, 40, 3, p=1, W=7), False),
        ("edge C=24 1x1/s2 n=3 11^2 oc=130", c(3, 11, 24, 130, s=2), False),
        ("edge ragged n=3 13x11 C=64 oc=72", c(3, 13, 64, 72, 3, p=1, W=11),
         False),
        ("edge 3x3/s2 pad 1 n=2 15x13 C=32 oc=48",
         c(2, 15, 32, 48, 3, s=2, p=1, W=13), False),
        ("edge 5x5/s2 pad 2 n=1 9^2 C=48 oc=200",
         c(1, 9, 48, 200, 5, s=2, p=2), False),
        ("edge out_q8 3x3 n=2 14^2 C=256 oc=256",
         c(2, 14, 256, 256, 3, p=1, out="int8"), False),
        ("edge f32 out 3x3 n=2 7^2 C=512 oc=512",
         c(2, 7, 512, 512, 3, p=1, out="f32"), False),
        ("edge in_q8 1x1 n=2 14^2 C=1024 oc=256", c(2, 14, 1024, 256,
                                                     in_q8=True), False),
        ("edge dynamic scale 3x3 n=2 28^2 C=128 oc=128",
         c(2, 28, 128, 128, 3, p=1, dynamic=True), False),
        ("edge NaN in x dynamic n=2 14^2 C=256 oc=64",
         c(2, 14, 256, 64, dynamic=True, nan=True), False),
        ("edge NaN in x static n=2 14^2 C=256 oc=64",
         c(2, 14, 256, 64, nan=True), False),
        ("edge no bias f32 x 1x1 n=2 7^2 C=512 oc=2048",
         c(2, 7, 512, 2048, bias=False, x32=True), False),
        ("edge C=20 3x3 n=2 9x7 oc=40", c(2, 9, 20, 40, 3, p=1, W=7), False),
        ("edge C=3 3x3/s2 pad 1 n=2 15^2 oc=64", c(2, 15, 3, 64, 3, s=2, p=1),
         False),
        ("edge split ragged 3x3 n=1 7^2 C=528 oc=512",
         c(1, 7, 528, 512, 3, p=1, split=True, ragged=True), False),
        ("edge split out_q8 3x3 n=2 7^2 C=512 oc=256",
         c(2, 7, 512, 256, 3, p=1, out="int8", split=True), False),
        ("edge split NaN dynamic 3x3 n=2 7^2 C=512 oc=256",
         c(2, 7, 512, 256, 3, p=1, dynamic=True, nan=True, split=True),
         False),
        ("edge split K=133120 all 127 1x1 n=1 2^2 oc=64",
         c(1, 2, 133120, 64, const=True, split=True), False),
    ]


def _touched(extent: int, out: int, k: int, s: int, p: int) -> int:
    """Rows (or columns) of an input of `extent` that a conv of `out`
    outputs, k taps, stride s and padding p reads: {o*s + t - p} within
    [0, extent). A 1x1 at stride 2 reads every other one."""
    return len({o * s + t - p for o in range(out) for t in range(k)}
               & set(range(extent)))


def _im2col_int8(xq, k: int, s: int, p: int):
    """The (n*oy*ox, k*k*C) int8 patch matrix of NHWC xq, tap-major and
    channel-minor (the filter's OHWI order), for the library yardstick."""
    import torch
    import torch.nn.functional as F
    n, H, W, C = xq.shape
    oy, ox = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    xp = F.pad(xq, (0, 0, p, p, p, p))
    return torch.cat([xp[:, yy:yy + (oy - 1) * s + 1:s,
                         xx:xx + (ox - 1) * s + 1:s, :].reshape(-1, C)
                      for yy in range(k) for xx in range(k)], dim=1)


def _check_qconv(stats: dict, dev, gen, peaks) -> None:
    """B6 (qconv) and its activation quantize against their plain versions
    on the card, both bit-equal (the int32 sums are exact and every f32 op
    rounds the same); at the timed shapes the kernel's time, the quantize
    pass's, the plain version's (the float64 conv: a check, not a
    yardstick), the bound (int8 operations over the int8 peak, or the bytes
    of the input pixels the conv reads, filter, scales, bias and output
    over HBM bandwidth), and
    the library's: torch._int_mm on the im2col'd int8 operands (made once,
    outside the timing) plus the same epilogue in torch ops. The kernel,
    the quantize pass and the library are timed on the card alone
    (graph_ms: at these shapes one call's host work outlasts its kernels);
    the wrapper's call as the engine makes it is call_ms."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = stats["qconv"] = _qconv_stats()
    for label, kw, timed in _qconv_cases():
        _qconv_case(s, label, kw, timed, dev, gen, peaks, sms)


def _qconv_stats() -> dict:
    """B6's stats, with the sums _qconv_case adds its timed readings to
    at 0."""
    s = _stats("qconv")
    for k in ("quantize_ms", "quantize_bound_ms", "absmax_ms",
              "absmax_plain_ms", "absmax_bound_ms", "absmax_library_ms",
              "quantize_at_max_ms", "quantize_at_max_plain_ms"):
        s[k] = 0.0
    return s


def _qconv_plan_str(plan) -> str:
    """B6's plan as the smoke prints it: tiles (those run whole), K chunks
    and the split tiles' splits, the persistent grid, the copy widths of A
    and B."""
    return (f"128x128 tiles {plan.blocks} (whole "
            f"{plan.full}) chunks {plan.chunks} splits {plan.splits} grid "
            f"{plan.grid} copy "
            f"A {'tma' if plan.tma_a else plan.copy} "
            f"B {'tma' if plan.tma_b else plan.copy_b}")


# B6 alone by K split count, the shapes where qconv_plan's split rule
# decides (the preset's sites at b32, the four grad_q8 weight gradients as
# wgrad_q8 hands them to B6): (label, n, H, C, oc, k, stride, pad)
QCONV_SPLIT_SHAPES = [
    ("res3 3x3 b32", 32, 28, 128, 128, 3, 1, 1),
    ("res4 3x3 b32", 32, 14, 256, 256, 3, 1, 1),
    ("res4 1x1 1024->256 b32", 32, 14, 1024, 256, 1, 1, 0),
    ("res5a pair b32", 32, 14, 1024, 2560, 1, 2, 0),
    ("res5 3x3 b32", 32, 7, 512, 512, 3, 1, 1),
    ("res5 1x1 2048->512 b32", 32, 7, 2048, 512, 1, 1, 0),
    ("res5 3x3 b128", 128, 7, 512, 512, 3, 1, 1),
    ("wgrad res3 3x3", 128, 28, 32, 128, 28, 1, 1),
    ("wgrad res4 3x3", 256, 14, 32, 256, 14, 1, 1),
    ("wgrad res5 3x3", 512, 7, 32, 512, 7, 1, 1),
    ("wgrad res5 1x1", 512, 7, 32, 2048, 7, 1, 0)]


def _qconv_splits(dev, gen) -> None:
    """B6 alone (through the C entry point, one CUDA graph of 20 calls)
    timed by K split count at QCONV_SPLIT_SHAPES: every tile in 1, 2, 3,
    4, 6, 8, 12 and 16 splits (at most the chunk count), and the plan's
    own split where it keeps full waves whole, each result bit-equal to the
    unsplit one, for qconv_plan's split rule."""
    import torch
    from boda_tpu_torch.ops.cuda.qconv import launch_qconv, qconv_plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, n, H, C, oc, k, st, p in QCONV_SPLIT_SHAPES:
        xq = torch.randint(-127, 128, (n, H, H, C), device=dev,
                           generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 128, (oc, k, k, C), device=dev,
                           generator=gen, dtype=torch.int8)
        s_act = torch.full((1,), 0.02, device=dev)
        sws = torch.rand(oc, device=dev, generator=gen) * 1e-3
        bias = torch.randn(oc, device=dev, generator=gen)
        plan = qconv_plan(n, H, H, C, oc, k, k, (st, st), (p, p), sms)
        oy = (H + 2 * p - k) // st + 1
        odt = torch.float32 if label.startswith("wgrad") else torch.bfloat16
        outs = {}
        row = []
        runs = [(0, sp) for sp in (1, 2, 3, 4, 6, 8, 12, 16)
                if sp <= plan.chunks]
        if 0 < plan.full < plan.blocks:
            runs.append((plan.full, plan.splits))
        for full, sp in runs:
            out = torch.empty(n, oy, oy, oc, device=dev, dtype=odt)
            grid = min(full + (plan.blocks - full) * sp, sms)

            def run():
                launch_qconv(xq, wq, s_act, sws, bias, out, (st, st), (p, p),
                             True, 0.0, full, sp, grid)
            run()
            outs[(full, sp)] = out
            row.append(f"{sp}{f' past {full} whole' if full else ''}: "
                       f"{graph_ms(run):.4f}")
        torch.cuda.synchronize()
        check(all(bit_equal(o, outs[(0, 1)]) for o in outs.values()),
              f"qconv splits {label}: a split result differs from the "
              f"unsplit one")
        print(f"qconv splits {label}: tiles {plan.blocks} chunks "
              f"{plan.chunks}, planned {plan.splits} past {plan.full} whole "
              f"on {sms} SMs; ms by splits " + ", ".join(row)
              + "; bit-equal", flush=True)


def _qconv_case(s: dict, label: str, kw: dict, timed: bool, dev, gen, peaks,
                sms: int) -> None:
    """One case of _check_qconv (the case's dict as _qconv_cases makes
    it), its timed readings summed into the stats `s`."""
    import torch
    from boda_tpu_torch.ops.cuda.qconv import absmax as absmax_k, \
        absmax_plain, act_quantize, act_quantize_plain, qconv, qconv_plain, \
        qconv_plan, static_act_scale
    out_dt = {"bf16": torch.bfloat16, "f32": torch.float32,
              "int8": torch.int8}
    n, H, W, C, oc, k = (kw[key] for key in ("n", "H", "W", "C", "oc", "k"))
    st, pd = (kw["s"], kw["s"]), (kw["p"], kw["p"])
    x = torch.randn(n, H, W, C, device=dev, generator=gen)
    if kw.get("const"):
        x = torch.full_like(x, 2.0)
    if not kw.get("x32"):
        x = x.bfloat16()
    if kw.get("nan"):
        x[n // 2, H // 2, W // 3, C // 3] = float("nan")
    # a static scale that clips the largest few values, as calibration
    # on other inputs does (every value on code 127 where const)
    absmax = 0.0 if kw.get("dynamic") else \
        (1.0 if kw.get("const") else 0.8) \
        * float(x.float().nan_to_num(0.0).abs().max())
    q_got, q_want = act_quantize(x, absmax), act_quantize_plain(x, absmax)
    torch.cuda.synchronize()
    check(all(bit_equal(g, w) for g, w in zip(q_got, q_want)),
          f"qconv {label}: the quantize kernel differs from "
          f"act_quantize_plain")
    # the dynamic form in a dp slot's two parts: its absmax, then the
    # quantize at a max read from device memory, each bit-equal to its plain
    # version, and at x's own max to the dynamic form
    m = absmax_k(x)
    q_dyn = act_quantize_plain(x)
    q_at = act_quantize(x, amax=m)
    torch.cuda.synchronize()
    check(bit_equal(m, absmax_plain(x)),
          f"qconv {label}: the absmax kernel differs from absmax_plain")
    check(all(bit_equal(g, w) for g, w in
              zip(q_at, act_quantize_plain(x, amax=m)))
          and all(bit_equal(g, w) for g, w in zip(q_at, q_dyn)),
          f"qconv {label}: the quantize at a device max differs from "
          f"act_quantize_plain or from the dynamic form")
    xq = q_got[0]
    s_act = torch.full((1,), static_act_scale(absmax), device=dev) \
        if kw.get("in_q8") else q_got[1]
    wq = torch.randint(-127, 128, (oc, k, k, C), device=dev,
                       generator=gen, dtype=torch.int8)
    if kw.get("const"):
        check(bool((xq == 127).all()), f"qconv {label}: x not on code 127")
        wq.fill_(127)
    sws = torch.rand(oc, device=dev, generator=gen) * 2e-3 + 1e-4
    bias = torch.randn(oc, device=dev, generator=gen) \
        if kw.get("bias", True) else None
    odt = out_dt[kw.get("out", "bf16")]
    out_absmax = 0.0
    if odt == torch.int8:
        y = qconv_plain(xq, wq, s_act, sws, bias, st, pd, kw["relu"])
        out_absmax = 0.7 * float(y.abs().max())
    args = (xq, wq, s_act, sws, bias, st, pd, kw["relu"], odt, out_absmax)
    got = qconv(*args)
    torch.cuda.synchronize()
    want = qconv_plain(*args)
    abs_err = float((got.double() - want.double()).abs().nan_to_num(0.0)
                    .max())
    s["max_abs_err"] = max(s["max_abs_err"], abs_err)
    plan = qconv_plan(n, H, W, C, oc, k, k, st, pd, sms)
    print(f"kernel qconv {str(x.dtype)[6:]}->{str(odt)[6:]:8s} "
          f"{label:44s} bit-equal={bit_equal(got, want)} (quantize, absmax "
          f"and quantize at its max bit-equal) max_abs={abs_err:.3e} plan "
          f"{_qconv_plan_str(plan)}", end="")
    check(bit_equal(got, want), f"qconv {label}: differs from its plain "
                                f"version (max abs {abs_err:.3e})")
    if kw.get("split"):
        check(plan.splits > 1, f"qconv {label}: the plan does not split K")
    if kw.get("ragged"):
        check(plan.chunks % plan.splits != 0,
              f"qconv {label}: {plan.chunks} chunks in {plan.splits} even "
              f"splits")
    if kw.get("nan") and kw.get("dynamic"):
        check(bool(got.isnan().all()), f"qconv {label}: a NaN scale "
                                       f"left finite outputs")
    elif odt != torch.int8:
        check(bool(torch.isfinite(got.float()).all()),
              f"qconv {label}: non-finite output")
    if not timed:
        print()
        return
    ms = graph_ms(lambda: qconv(*args))
    call_ms = cuda_ms(lambda: qconv(*args), 20)
    quant_ms = graph_ms(lambda: act_quantize(x, absmax))
    # the quantize reads x once (twice where dynamic) and writes xq
    quant_bound, _ = bound(peaks, "int8", 0, _nbytes(x, xq))
    # a dp slot's parts: absmax reads x and writes 4 bytes; the library is
    # one PyTorch call for max|x| in f32
    amax_ms = graph_ms(lambda: absmax_k(x))
    amax_plain_ms = graph_ms(lambda: absmax_plain(x))
    amax_bound, _ = bound(peaks, "int8", 0, _nbytes(x, m))
    amax_lib_ms = graph_ms(lambda: torch.linalg.vector_norm(
        x, float("inf"), dtype=torch.float32))
    at_ms = graph_ms(lambda: act_quantize(x, amax=m))
    at_plain_ms = graph_ms(lambda: act_quantize_plain(x, amax=m))
    plain_ms = cuda_ms(lambda: qconv_plain(*args), 3)
    M = got.numel() // oc
    work = 2 * M * oc * k * k * C
    _, oy, ox, _ = got.shape
    x_read = n * C * _touched(H, oy, k, kw["s"], kw["p"]) \
        * _touched(W, ox, k, kw["s"], kw["p"])
    bound_ms, bound_by = bound(peaks, "int8", work,
                               x_read + _nbytes(wq, sws, bias, got))
    a_cols, b_cols = _im2col_int8(xq, k, kw["s"], kw["p"]), \
        wq.view(oc, -1).t()
    scale = s_act * sws

    def lib():
        y = torch._int_mm(a_cols, b_cols).float() * scale + bias
        return (torch.relu(y) if kw["relu"] else y).to(odt)
    try:
        lib()
        lib_ms = graph_ms(lib)
    except RuntimeError:
        lib_ms = None
    print(f" kernel {ms:.4f} ms ({work / ms / 1e9:.1f} TOPS; the "
          f"wrapper's call {call_ms:.4f}) plain "
          f"{plain_ms:.4f} ms; quantize pass {quant_ms:.4f} ms (bound "
          f"{quant_bound:.4f}, bytes); absmax {amax_ms:.4f} ms (plain "
          f"{amax_plain_ms:.4f}, bound {amax_bound:.4f}, bytes; library "
          f"vector_norm {amax_lib_ms:.4f}), quantize at it {at_ms:.4f} ms "
          f"(plain {at_plain_ms:.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by}); library _int_mm + epilogue "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    s["quantize_ms"] += quant_ms
    s["quantize_bound_ms"] += quant_bound
    s["absmax_ms"] += amax_ms
    s["absmax_plain_ms"] += amax_plain_ms
    s["absmax_bound_ms"] += amax_bound
    s["absmax_library_ms"] += amax_lib_ms
    s["quantize_at_max_ms"] += at_ms
    s["quantize_at_max_plain_ms"] += at_plain_ms
    _add_case(s, {"case": label, "dtype": "int8", "mrd": 0.0, "ms": ms,
                  "call_ms": call_ms, "plain_ms": plain_ms,
                  "quantize_ms": quant_ms, "quantize_bound_ms": quant_bound,
                  "absmax_ms": amax_ms, "absmax_plain_ms": amax_plain_ms,
                  "absmax_bound_ms": amax_bound,
                  "absmax_library_ms": amax_lib_ms,
                  "quantize_at_max_ms": at_ms,
                  "quantize_at_max_plain_ms": at_plain_ms,
                  "plan": _qconv_plan_str(plan),
                  "tops": work / ms / 1e9, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": lib_ms,
                  "library": "call: torch._int_mm (im2col'd int8 "
                             "operands) + epilogue"})


def phase_kernels(ctx: dict) -> None:
    import torch
    from boda_tpu_torch.core.machine import card_peaks
    peaks = card_peaks(torch.cuda.get_device_name(0))
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    stats: dict[str, dict] = {}
    only = ctx.get("only_kernels")

    def wanted(kname):
        return not only or kname in only
    if wanted("sgemm_int8"):
        _check_qsgemm(stats, dev, gen, peaks)
    if wanted("qconv"):
        _check_qconv(stats, dev, gen, peaks)
        ctx["wgrad"] = _wgrad_times(dev, peaks)
        _qconv_splits(dev, gen)
    timed = {c[0] for c in _kernel_cases()}
    for label, kname, kw in _kernel_cases() + _edge_cases():
        if not wanted(kname):
            continue
        for dt in (torch.float32, torch.bfloat16):
            (run_k, run_p, ref), args = _kernel_args(kname, kw, dt, dev, gen)
            got = run_k()
            torch.cuda.synchronize()
            want = ref()
            err = mrd(got, want)
            abs_err = float((got.double() - want.double()).abs().max())
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kname} {label} {dt}: non-finite output")
            toler = F32_MRD if dt == torch.float32 else BF16_MRD
            print(f"kernel {kname:10s} {str(dt)[6:]:8s} {label:44s} "
                  f"mrd={err:.3e} (<= {toler:g}) max_abs={abs_err:.3e}",
                  end="")
            check(err <= toler, f"{kname} {label} {dt}: mrd {err:.3e} > "
                                f"{toler:g}")
            if kname == "fused_stem":
                if not kw.get("out_f32"):
                    print(f" template "
                          f"{_check_stem_template(args, kw, dt, got)} exact",
                          end="")
                print(f" {_check_stem_rounding(args, kw, dt, got, sms)}",
                      end="")
            if kname == "matmul_ext":
                print(f" {_matmul_plan_str(args, sms)}", end="")
            if kname == "resblock":
                print(f" {_resblock_plan_str(args, sms, kw.get('force'))}",
                      end="")
            s = stats.setdefault(kname, _stats(kname))
            s["max_abs_err"] = max(s["max_abs_err"], abs_err)
            s["max_mrd"] = max(s["max_mrd"], err)
            if label not in timed:
                print()
                # the 64-bit edge holds gigabytes (the calls hold args)
                del args, got, want, run_k, run_p, ref
                continue
            ms = cuda_ms(run_k, 20)
            plain_ms = cuda_ms(run_p, 20)
            prec = "bf16" if dt == torch.bfloat16 else "f32"
            bound_ms, bound_by = bound(peaks, prec, _work(kname, args, got),
                                       _nbytes(*args, got))
            lib, lib_kind = _library(kname, args, dt)
            lib_ms = cuda_ms(lib, 20)
            print(f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}) library {lib_kind} "
                  f"{lib_ms:.4f} ms")
            case = {"case": label, "dtype": str(dt)[6:], "mrd": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms,
                    "library": lib_kind}
            if kname == "matmul_ext":
                case["plan"] = _matmul_plan_str(args, sms)
            if kname == "resblock":
                case["plan"] = _resblock_plan_str(args, sms)
            if kname == "fused_stem":
                case["plan"] = _stem_plan_str(args, kw, got.dtype, sms)
            _add_case(s, case)
            del args, got, want, lib, run_k, run_p, ref
    ctx["kernels"] = stats
    if wanted("tconv"):
        _tconv_splits(dev)
    if wanted("matmul_ext"):
        _matmul_splits(dev)
    if wanted("resblock"):
        _resblock_plans(dev, gen)
    if wanted("fused_stem"):
        _stem_plans(dev, gen)


def _stem_plan_of(args, kw, out_dtype, sms: int):
    from boda_tpu_torch.ops.cuda.stem import stem_plan
    x, w, _bias, pad, pool = args[:5]
    n, H, W, C = x.shape
    st = kw.get("stride", 2)
    return stem_plan(n, H, W, C, w.shape[0], x.element_size(), sms,
                     tuple(w.shape[2:]), (st, st), pad, pool,
                     out_dtype.itemsize)


def _stem_plan_str(args, kw, out_dtype, sms: int) -> str:
    """fused_stem's plan for a case: its route (and why bf16 left the
    tensor cores), tile, persistent blocks and blocks per SM."""
    p = _stem_plan_of(args, kw, out_dtype, sms)
    return (f"plan {p.route} tile {p.ty}x{p.tx} blocks {p.blocks} "
            f"({p.per_sm} per SM)"
            f"{'' if p.vec else ' element-staged'}"
            f"{' [' + p.why + ']' if p.why else ''}")


def _check_stem_rounding(args, kw, dt, got, sms: int) -> str:
    """The plan of a fused_stem case; and, for a bf16 output, that pooling
    the conv tile in bf16 is bit-equal to pooling it in f32 and rounding
    after: the same kernel with an f32 output, rounded to bf16."""
    import torch
    from boda_tpu_torch.ops.cuda.stem import fused_stem
    plan = _stem_plan_str(args, kw, got.dtype, sms)
    if got.dtype != torch.bfloat16:
        return plan
    st = kw.get("stride", 2)
    wide = fused_stem(*args, out_dtype=torch.float32, stride=(st, st))
    check(torch.equal(wide.bfloat16(), got),
          "fused_stem: a bf16 output pooled in bf16 differs from the f32 "
          "output rounded to bf16")
    return plan + " bf16 pool bit-equal to f32 pool + rounding"


def _resblock_plan_str(args, sms: int, force=None) -> str:
    """resblock's plan for a case: its route, the output rows of a band,
    the cluster that shares a band, the block tile and the grid."""
    from boda_tpu_torch.ops.cuda.resblock import resblock_plan
    x, w1 = args[:2]
    n, H, W, C = x.shape
    p = resblock_plan(n, H, W, C, w1.shape[0], x.element_size(), sms)
    if force is not None:
        ty, cluster, tile_m, tile_n = force
        return (f"forced {p.route} ty {ty} cluster {cluster} tile "
                f"{tile_m}x{tile_n}")
    return (f"plan {p.route} ty {p.ty} cluster {p.cluster} tile "
            f"{p.tile_m}x{p.tile_n} blocks {p.blocks}"
            f"{'' if p.vec or p.route == 'mma' else ' element-staged'}")


def _matmul_plan_str(args, sms: int) -> str:
    """matmul_ext's plan for a case: its route, block tile, K splits and
    whether its operands move in 16-byte copies."""
    from boda_tpu_torch.ops.cuda.sgemm import matmul_plan
    a, b = args[:2]
    (M, K), N = a.shape, b.shape[0]
    p = matmul_plan(M, N, K, a.dtype, sms)
    return (f"plan {p.route} tile {p.tile_m}x{p.tile_n} splits {p.splits}"
            f"{'' if p.vec else ' element-staged'}")


# (n, H = W, C = oc): the ResNet-50 3x3 convs that reach tconv
SPLIT_SHAPES = [(1, 7, 512), (32, 7, 512), (32, 14, 256), (32, 28, 128)]


def _tconv_splits(dev) -> None:
    """The tconv kernel alone, timed by K split count at the ResNet-50 3x3
    shapes, for the planner's split rule: the planned count, powers of two
    up to 16, and twice the planned count, each through the C entry point
    with its buffers allocated once."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.tconv import tconv_plan
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, H, C in SPLIT_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(n, H, H, C, device=dev).to(dt)
            w = (torch.randn(C, 3, 3, C, device=dev) * 0.02).to(dt)
            b = torch.randn(C, device=dev)
            out = torch.empty(n, H, H, C, device=dev, dtype=dt)
            plan = tconv_plan(n, H, H, C, C, 3, 3, dt, (1, 1), sms)
            bf = int(dt == torch.bfloat16)
            row = []
            for sp in sorted({1, 2, 4, 8, 16, plan.splits, 2 * plan.splits}):
                ws = torch.empty(sp, n * H * H, C, device=dev)

                def run():
                    check(lib.boda_tconv(
                        x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), n, H, H, C, C, 3, 3,
                        1, 1, bf, bf, 1, sp, int(plan.vec), stream) == 0,
                        f"tconv splits={sp}: launch failed")
                row.append(f"{sp}: {cuda_ms(run, 50):.4f}")
            print(f"tconv splits n={n} {H}^2 C={C} {str(dt)[6:]}: planned "
                  f"{plan.splits} on {sms} SMs; ms by splits "
                  + " ".join(row), flush=True)


# (M, K, N): the fc1000 at batch 1 and 32, res5a_branch2a at batch 1 and 32,
# and at batch 32 res4b_branch2a (98 tiles) and res5b_branch2c (208 tiles)
MATMUL_SPLIT_SHAPES = [(1, 2048, 1000), (32, 2048, 1000), (49, 1024, 512),
                       (1568, 1024, 512), (6272, 1024, 256),
                       (1568, 512, 2048)]


def _matmul_splits(dev) -> None:
    """The matmul_ext kernel alone, timed by K split count at small-grid
    shapes of ResNet-50, for the planner's split rule: the planned count,
    powers of two up to 64 and twice the planned count (each at most the
    chunk count), through the C entry point with its buffers allocated
    once."""
    import math

    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.sgemm import matmul_plan
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for M, K, N in MATMUL_SPLIT_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn(M, K, device=dev).to(dt)
            b = (torch.randn(N, K, device=dev) * K ** -0.5).to(dt)
            bias = torch.randn(N, device=dev)
            c = torch.empty(M, N, device=dev, dtype=dt)
            plan = matmul_plan(M, N, K, dt, sms)
            chunks = math.ceil(K / plan.bk)
            bf = int(dt == torch.bfloat16)
            row = []
            for sp in sorted({1, 2, 4, 8, 16, 32, 64, plan.splits,
                              2 * plan.splits}):
                if sp > chunks:
                    continue
                ws = torch.empty(sp, M, N, device=dev)

                def run():
                    check(lib.boda_matmul_ext(
                        a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                        c.data_ptr(), M, N, K, bf, bf, 0, ws.data_ptr(),
                        plan.tile_n, sp, int(plan.vec), stream) == 0,
                        f"matmul_ext splits={sp}: launch failed")
                row.append(f"{sp}: {cuda_ms(run, 50):.4f}")
            print(f"matmul splits M={M} K={K} N={N} {str(dt)[6:]}: tile "
                  f"{plan.tile_m}x{plan.tile_n}, planned {plan.splits} on "
                  f"{sms} SMs; ms by splits " + " ".join(row), flush=True)


# (n, H = W, C, Cm): the identity bottlenecks of ResNet-50's four stages at
# batch 32, and res5 at batch 1
RESBLOCK_PLAN_SHAPES = [(32, 56, 256, 64), (32, 28, 512, 128),
                        (32, 14, 1024, 256), (32, 7, 2048, 512),
                        (1, 7, 2048, 512)]
RESBLOCK_PLAN_TYS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 14)


def _resblock_plans(dev, gen) -> None:
    """The resblock kernel alone by cluster size, tile and band rows at the
    ResNet-50 stages, for the planner's estimate: each (cluster, tile, ty)
    that fits runs through the C entry point, is held against the plain
    version (f32 mrd 1e-4, bf16 5e-3), and is timed beside the plan's
    estimate in microseconds and the clusters of that launch the card
    holds at once (cudaOccupancyMaxActiveClusters)."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.resblock import CLUSTERS, plan_candidate, \
        plan_tiles, resblock_plain, resblock_plan
    lib = load_kernels()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, H, C, Cm in RESBLOCK_PLAN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            kw = dict(n=n, H=H, W=H, C=C, Cm=Cm)
            _, args = _kernel_args("resblock", kw, dt, dev, gen)
            want = resblock_plain(*args)
            out = torch.empty_like(args[0])
            es = args[0].element_size()
            plan = resblock_plan(n, H, H, C, Cm, es, sms)
            toler = F32_MRD if dt == torch.float32 else BF16_MRD
            best = None
            for cluster in CLUSTERS:
                for tile_m, tile_n in plan_tiles(C, Cm, es, cluster):
                    row = []
                    for ty in sorted({t for t in RESBLOCK_PLAN_TYS + (H,)
                                      if t <= H} | {plan.ty}):
                        cand = plan_candidate(n, H, H, C, Cm, es, sms, ty,
                                              cluster, tile_m, tile_n)
                        if cand is None:
                            continue
                        force = (ty, cluster, tile_m, tile_n)
                        out.zero_()
                        _resblock_forced(args, dt, force, out)
                        torch.cuda.synchronize()
                        err = mrd(out, want)
                        check(err <= toler, f"resblock {kw} {dt} under "
                                            f"{force}: mrd {err:.3e} > "
                                            f"{toler:g}")
                        ms = cuda_ms(lambda: _resblock_forced(
                            args, dt, force, out), 10)
                        bf = int(dt == torch.bfloat16)
                        held = lib.boda_resblock_max_clusters(
                            H, H, C, Cm, ty, cluster,
                            int(plan.route == "mma"), tile_m, tile_n,
                            int(plan.vec), bf, bf)
                        check(held > 0, f"resblock {kw} {dt} under {force}: "
                                        f"no resident cluster ({held})")
                        row.append(f"{ty}: {ms:.4f} ({cand[0]:.0f}; {held})")
                        if best is None or ms < best[0]:
                            best = (ms, force)
                    if row:
                        print(f"resblock plan n={n} {H}^2 C={C} Cm={Cm} "
                              f"{str(dt)[6:]} {plan.route} cluster {cluster} "
                              f"tile {tile_m}x{tile_n}: ms (estimated us; "
                              f"clusters held at once) by ty "
                              + " ".join(row), flush=True)
            print(f"resblock plan n={n} {H}^2 C={C} Cm={Cm} {str(dt)[6:]}: "
                  f"planned ty {plan.ty} cluster {plan.cluster} tile "
                  f"{plan.tile_m}x{plan.tile_n} on {sms} SMs; fastest "
                  f"{best[0]:.4f} ms at ty {best[1][0]} cluster {best[1][1]} "
                  f"tile {best[1][2]}x{best[1][3]}", flush=True)
            del args, want, out


# (ty, tx): tiles of pooled outputs the `stem plan` sweep times
STEM_PLAN_TILES = [(7, 8), (4, 8), (3, 8), (2, 8), (7, 4), (4, 4), (4, 16),
                   (3, 16), (2, 16), (6, 4), (8, 8)]


def _stem_forced(args, out, plan, ty, tx, wk):
    """The fused_stem kernel through its C entry point under a given tile
    instead of stem_plan's choice, with wk as the room for the reordered
    filter; the rest follows `plan`."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    x, w, bias, pad, pool = args[:5]
    n, H, W, C = x.shape
    oc, _, ky, kx = w.shape
    rc = load_kernels().boda_fused_stem(
        x.data_ptr(), w.data_ptr(), wk.data_ptr(), bias.data_ptr(),
        out.data_ptr(),
        n, H, W, C, oc, ky, kx, 2, 2, pad[0], pad[1], pool[0][0], pool[0][1],
        pool[1][0], pool[1][1], out.shape[1], out.shape[2], ty, tx,
        int(plan.route == "mma"), int(plan.vec), plan.Kp,
        plan.blocks, int(x.dtype == torch.bfloat16),
        int(out.dtype == torch.bfloat16), 1,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc == 0, f"fused_stem forced tile {ty}x{tx}: launch failed with "
                   f"cudaError {rc}")
    return out


def _stem_forced_case(args, out_dtype, force):
    """A fused_stem case (7x7/s2, 3x3/s2 pool) under a forced tile (ty,
    tx); route, copies and filter layout as the plan has them."""
    import torch
    from boda_tpu_torch.ops.cuda.stem import fused_stem_plain, plan_candidate, \
        stem_filter
    x, w = args[:2]
    n, H, W, C = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    cand = plan_candidate(n, H, W, C, w.shape[0], x.element_size(), sms,
                          (7, 7), (2, 2), (3, 3), ((3, 3), (2, 2)),
                          out_dtype.itemsize, *force)
    check(cand is not None, f"fused_stem forced {force}: does not fit")
    plan = cand[1]
    shape = fused_stem_plain(*args).shape
    out = torch.empty(shape, device=x.device, dtype=out_dtype)
    wk = torch.empty_like(stem_filter(w, plan.lead, plan.KR, plan.Kp))
    _stem_forced(args, out, plan, *force, wk)
    check(torch.equal(wk, stem_filter(w, plan.lead, plan.KR, plan.Kp)),
          f"fused_stem forced {force}: the kernel's filter reorder differs "
          f"from stem_filter")
    return out


def _stem_plans(dev, gen) -> None:
    """The fused_stem launches alone (the filter reorder and the stem
    kernel, buffers allocated once) by tile at ResNet-50's conv1 + pool1,
    batch 32 and 1,
    for the planner's estimate: each candidate that fits runs through the C
    entry point, is held against the plain version (f32 mrd 1e-4, bf16
    5e-3) and is timed beside the plan's estimate in microseconds and the
    blocks of it an SM holds (the card's occupancy query, which the plan's
    own count must equal, as its shared-memory sum must the kernel's)."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.stem import fused_stem_plain, \
        plan_candidate, stem_filter, stem_plan
    lib = load_kernels()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (32, 1):
        for dt in (torch.float32, torch.bfloat16):
            kw = dict(n=n, H=224, W=224, C=3, oc=64)
            _, args = _kernel_args("fused_stem", kw, dt, dev, gen)
            x, w = args[:2]
            es = x.element_size()
            want = fused_stem_plain(*args)
            geom = ((7, 7), (2, 2), (3, 3), ((3, 3), (2, 2)), es)
            plan = stem_plan(n, 224, 224, 3, 64, es, sms)
            wk_want = stem_filter(w, plan.lead, plan.KR, plan.Kp)
            wk = torch.zeros_like(wk_want)
            out = torch.empty(n, 56, 56, 64, device=dev, dtype=dt)
            toler = F32_MRD if dt == torch.float32 else BF16_MRD
            bf = int(dt == torch.bfloat16)
            best, row = None, []
            for ty, tx in sorted(set(STEM_PLAN_TILES) | {(plan.ty, plan.tx)}):
                cand = plan_candidate(n, 224, 224, 3, 64, es, sms, *geom, ty,
                                      tx)
                if cand is None:
                    continue
                est, cp = cand
                q = (224, 224, 3, 64, 7, 7, 2, 2, 3, 3, 3, 3, 2, 2, 56, 56,
                     ty, tx, int(cp.route == "mma"), int(cp.vec), cp.Kp, bf,
                     bf)
                smem = lib.boda_fused_stem_smem(*q)
                per_sm = lib.boda_fused_stem_blocks_per_sm(*q)
                check((smem, per_sm) == (cp.smem, cp.per_sm),
                      f"fused_stem {ty}x{tx} {dt}: the plan counts {cp.smem} "
                      f"bytes and {cp.per_sm} blocks per SM, the kernel "
                      f"{smem} and {per_sm}")
                out.zero_()
                _stem_forced(args, out, cp, ty, tx, wk)
                torch.cuda.synchronize()
                err = mrd(out, want)
                check(err <= toler, f"fused_stem n={n} {dt} tile {ty}x{tx}: "
                                    f"mrd {err:.3e} > {toler:g}")
                check(torch.equal(wk, wk_want), "fused_stem: the kernel's "
                      "filter reorder differs from stem_filter")
                ms = cuda_ms(lambda: _stem_forced(args, out, cp, ty, tx, wk),
                             20)
                row.append(f"{ty}x{tx}: {ms:.4f} ({est:.0f}; {per_sm})")
                if best is None or ms < best[0]:
                    best = (ms, ty, tx)
            print(f"stem plan n={n} 224^2 3->64 {str(dt)[6:]} {plan.route}: "
                  f"ms (estimated us; blocks per SM) by tile "
                  + " ".join(row), flush=True)
            print(f"stem plan n={n} 224^2 3->64 {str(dt)[6:]}: planned "
                  f"{plan.ty}x{plan.tx} blocks {plan.blocks} on {sms} SMs; "
                  f"fastest {best[0]:.4f} ms at {best[1]}x{best[2]}",
                  flush=True)
            del args, want, out


def _b7_operands(sig, dev, gen, bias: bool = True):
    """B7's operands for the sig of a B7 step (xla_conv, s2d_conv or
    xla_conv2 under prec=bf16 with NHWC storage): x [n, H, W, C] and the
    concatenated OHWI filter in bf16 (seeded, the filter at fan-in scale),
    f32 biases, the members (out_chan, ReLU, stored dtype and out_absmax as
    the step stores them), stride and pad."""
    import torch
    from boda_tpu_torch.ops.cuda.bconv import Member
    from boda_tpu_torch.ops.cuda.conv import SIBS, _scale_of, conv_params
    from boda_tpu_torch.ops.cuda.util import storage_io, store_dtype, \
        torch_dtype
    n, C, H, W = sig.get_dims("in").shape
    st, pd = sig.get_dims_or_none("stride"), sig.get_dims_or_none("in_pad")
    stride = (st["y"], st["x"]) if st else (1, 1)
    pad = (pd["y"], pd["x"]) if pd else (0, 0)
    if sig.func_name == "xla_conv2":
        _, edt = storage_io(sig)
        sibs = [t for t in SIBS if f"filts_{t}" in sig.nda_vals]
        fds = [sig.get_dims(f"filts_{t}") for t in sibs]
        ky, kx = max(d["y"] for d in fds), max(d["x"] for d in fds)
        members = tuple(Member(
            d["out_chan"], sig.get_u32_or(f"relu_{t}", 0) == 1,
            edt or torch_dtype(sig.get_dims(f"out_{t}").dtype))
            for t, d in zip(sibs, fds))
    else:
        _ind, _outd, fd, _sy, _sx, _py, _px, relu = conv_params(sig)
        ky, kx = fd["y"], fd["x"]
        amax = _scale_of(sig, "out_scale") \
            if sig.get_u32_or("out_q8", 0) else 0.0
        members = (Member(fd["out_chan"], relu,
                          torch.int8 if amax else store_dtype(sig), amax),)
    N = sum(m.oc for m in members)
    x = torch.randn(n, H, W, C, device=dev, generator=gen).bfloat16()
    w = (torch.randn(N, ky, kx, C, device=dev, generator=gen)
         * (C * ky * kx) ** -0.5).bfloat16()
    biases = tuple((torch.randn(m.oc, device=dev, generator=gen) * 0.5)
                   if bias else None for m in members)
    return x, w, biases, members, stride, pad


def _b7_key(sig) -> tuple:
    """What a B7 launch depends on: the template, the input and filter
    shapes, stride, pad and the members' stores."""
    keys = ("in", "stride", "in_pad") + tuple(
        k for k in sorted(sig.nda_vals)
        if k.startswith(("filts", "relu_", "out")) or k == "conv_has_relu")
    return (sig.func_name,) + tuple(
        (k, str(sig.nda_vals[k])) for k in keys if k in sig.nda_vals)


def _b7_cell_steps(model: str, tune_name: str, batch: int = 128) -> dict:
    """{_b7_key: (a B7 step's sig, its count)} of the plan the benchmark's
    cell of `model` runs at `batch` under a tune of TUNES or INT8 (the
    steps whose built fn takes route 'b7')."""
    import torch
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.models.zoo import build_model
    pipe = build_model(model, batch=batch)
    eng = make_engine(f"(engine=torch,{engine_spec(tune_name)})")
    eng.init(pipe)
    out: dict = {}
    for s in eng.plan.steps:
        if eng.fwd.conv_routes.get(s.call_tag) == "b7":
            k = _b7_key(s.sig)
            sig, c = out.get(k, (s.sig, 0))
            out[k] = (sig, c + 1)
    del eng
    torch.cuda.empty_cache()
    return out


def _b7_case(label, x, w, biases, members, stride, pad, peaks, f64=False):
    """B7 against bconv_plain on the card (mrd of every member at the bf16
    gate; f64: also the stored values against the f64 conv of the rounded
    operands after the store's one rounding), then timed: the kernel alone
    (a CUDA graph), the wrapper's call, the plain version and cuDNN's FP32
    conv of the same operands alone (the yardstick; the port never calls
    it), beside the bound. Returns the case's numbers."""
    import torch
    import torch.nn.functional as F
    from boda_tpu_torch.ops.cuda.bconv import bconv, bconv_plain, \
        bconv_plan, launch_bconv, thin_pad
    from boda_tpu_torch.ops.cuda.util import full_fp32
    n, H, W, C = x.shape
    N, ky, kx, _ = w.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # the kernel as the wrapper launches it: a thin input widened first
    extra = thin_pad(C)
    xk, wk = (F.pad(x, (0, extra)), F.pad(w, (0, extra))) if extra else (x, w)
    plan = bconv_plan(n, H, W, C + extra, N, ky, kx, stride, pad, sms)
    got = bconv(x, w, biases, members, stride, pad)
    torch.cuda.synchronize()
    want = bconv_plain(x, w, biases, members, stride, pad)
    # B7's stored values against the plain version's sums stored in f32:
    # the kernel's one rounding to bf16 and its other order of the f32
    # sum (two bf16 stores of sums taken in two orders may sit one bf16
    # step apart, up to 7.8e-3 of the largest value)
    want32 = bconv_plain(x, w, biases, tuple(
        dataclasses.replace(m, dtype=torch.float32)
        if m.dtype == torch.bfloat16 else m for m in members), stride, pad)
    err, moved = 0.0, 0.0
    for g, p, p32, m in zip(got, want, want32, members):
        check(g.dtype == m.dtype and g.shape == p.shape and g.is_contiguous(),
              f"bconv {label}: a member's output {g.dtype} {tuple(g.shape)}")
        if m.dtype == torch.int8:
            # an int8 edge: a code may move one step where the two f32
            # sums, taken in other orders, straddle a rounding boundary
            codes = int((g.int() - p.int()).abs().max())
            check(codes <= 1, f"bconv {label}: int8 codes {codes} apart")
        else:
            err = max(err, mrd(g, p32))
            if m.dtype == torch.bfloat16:
                moved = max(moved, float((g != p).float().mean()))
    check(err <= BF16_MRD, f"bconv {label}: mrd {err:.3e} against the plain "
                           f"version's f32 sums")
    if f64:
        xc = x.permute(0, 3, 1, 2).double()
        acc = F.conv2d(xc, w.permute(0, 3, 1, 2).double(), stride=stride,
                       padding=pad)
        off = 0
        for g, b, m in zip(got, biases, members):
            y = acc[:, off:off + m.oc]
            if b is not None:
                y = y + b.double()[None, :, None, None]
            y = (torch.relu(y) if m.relu else y).permute(0, 2, 3, 1)
            if m.dtype == torch.int8:
                q = torch.round(y * (127.0 / m.out_absmax)).clamp(-127, 127)
                codes = int((g.double() - q).abs().max())
                check(codes <= 1, f"bconv {label}: int8 codes {codes} from "
                                  f"the f64 conv's")
            else:
                e64 = mrd(g, y)
                check(e64 <= BF16_MRD, f"bconv {label}: mrd {e64:.3e} "
                                       f"against the f64 conv")
            off += m.oc
    outs = tuple(torch.empty_like(g) for g in got)
    kern_ms = graph_ms(lambda: launch_bconv(
        xk, wk, biases, members, outs, stride, pad, plan.tile_n, plan.full,
        plan.splits, plan.grid))
    call_ms = cuda_ms(lambda: bconv(x, w, biases, members, stride, pad), 10)
    plain_ms = cuda_ms(lambda: bconv_plain(x, w, biases, members, stride,
                                           pad), 5)
    xf = x.permute(0, 3, 1, 2).float()
    wf = w.permute(0, 3, 1, 2).float()

    def library():
        with full_fp32():
            return F.conv2d(xf, wf, stride=stride, padding=pad)
    lib_ms = cuda_ms(library, 5)
    oy, ox = got[0].shape[1:3]
    work = 2 * n * oy * ox * N * ky * kx * C
    nbytes = 2 * (x.numel() + w.numel()) + sum(
        g.numel() * g.element_size() for g in got)
    bound_ms, by = bound(peaks, "bf16", work, nbytes)
    print(f"bconv {label:44s} mrd {err:.3e} (<= {BF16_MRD:g}; "
          f"{100 * moved:.2f}% of the values one bf16 step off the plain "
          f"version's); kernel "
          f"{kern_ms:.4f} ms (call {call_ms:.4f}), plain {plain_ms:.4f}, "
          f"bound {bound_ms:.4f} ({by}), cuDNN FP32 {lib_ms:.4f}; plan "
          f"tile_n {plan.tile_n} blocks {plan.blocks} chunks {plan.chunks} "
          f"full {plan.full} splits {plan.splits} grid {plan.grid} copy "
          f"{plan.copy}/{plan.copy_b}{' tma_a' if plan.tma_a else ''}",
          flush=True)
    return {"ms": kern_ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": lib_ms, "mrd": err,
            "moved": moved}


def _b7_label(x, w, members, stride) -> str:
    n, H, _W, C = x.shape
    N, ky, kx, _ = w.shape
    mem = "+".join(str(m.oc) for m in members)
    return f"{ky}x{kx}/s{stride[0]} {C}->{mem} {H}^2 b{n}"


def phase_vendor(ctx: dict) -> None:
    """The vendor conv under prec=bf16 with NHWC bf16 storage, which runs on
    kernel B7 (ops/cuda/bconv.py): at the 21 ResNet-50 b32 conv sigs the
    template's result must be contiguous NHWC bf16 and agree with the f64
    conv of the rounded operands after the one rounding of the store, and
    B7 with bconv_plain (the vendor arithmetic: FP32 cuDNN on the rounded
    operands); beside it, timed here and used nowhere in the port, the FP32
    vendor form (its result must come back channels_last) and the bf16
    cuDNN form that rounds the sum before the bias: its mrd against the
    template's result, the share of stored values it moves, and its time.
    Then B7 at every distinct B7 step of the benchmark's three b128 cells
    (ResNet-50 at the headline tune and under the int8 preset, GoogLeNet
    with LRN at the headline tune; conv1 at C = 3, the sibling groups, the
    int8 edges), against bconv_plain and timed (_b7_case), with the sums
    per request; and edges: no bias, f32 and int8 stores, a member width
    that breaks the 4-result stores, split K."""
    import torch
    import torch.nn.functional as F
    from boda_tpu_torch.core.machine import card_peaks
    from boda_tpu_torch.ops.cuda.bconv import Member
    from boda_tpu_torch.ops.cuda.conv import conv_params, vendor_conv
    from boda_tpu_torch.ops.op_base import read_op_sigs
    from boda_tpu_torch.ops.registry import get_template
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda", 0)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(3)
    cl = torch.channels_last
    tot = {"b7": 0.0, "fp32": 0.0, "bf16": 0.0}
    worst = (0.0, 0.0)
    ops = read_op_sigs(DATA / "ops" / "resnet50-convs.txt")
    for op in ops:
        ind, outd, fd, sy, sx, py, px, relu = conv_params(op)
        n, C, H, W = ind.shape
        oc, _, ky, kx = fd.shape
        x = torch.randn(n, H, W, C, device=dev, generator=gen).bfloat16()
        w = torch.randn(oc, C, ky, kx, device=dev, generator=gen) \
            * (C * ky * kx) ** -0.5
        b = torch.randn(oc, device=dev, generator=gen) * 0.5
        top = op.copy()
        top.set_func_name("xla_conv")
        top.str_vals.update(prec="bf16", io_layout="nhwc", edge_prec="bf16")
        t = get_template("xla_conv")
        fn = t.build(t.check_args(top))
        check(fn.route == "b7", f"vendor {_op_label(op)}: route {fn.route}")
        got = fn(x, w, b)
        conv = vendor_conv((sy, sx), (py, px), torch.bfloat16, True)
        y = conv(x, w, b)
        check(y.is_contiguous(memory_format=cl) and got.is_contiguous()
              and got.dtype == torch.bfloat16,
              f"vendor {_op_label(op)}: the FP32 form's result is not "
              f"channels_last, or the step's output not contiguous NHWC")
        wk = w.permute(0, 2, 3, 1).bfloat16().contiguous()
        case = _b7_case(_op_label(op), x, wk, (b,),
                        (Member(oc, relu, torch.bfloat16),), (sy, sx),
                        (py, px), peaks, f64=True)
        xc = x.permute(0, 3, 1, 2)
        wb = w.bfloat16().contiguous(memory_format=cl)

        def fp32_form():
            z = conv(x, w, b)
            z = torch.relu(z) if relu else z
            return z.bfloat16().permute(0, 2, 3, 1).contiguous()

        def bf16_form():
            z = F.conv2d(xc, wb, stride=(sy, sx), padding=(py, px)) \
                + b[None, :, None, None]
            z = torch.relu(z) if relu else z
            return z.bfloat16().permute(0, 2, 3, 1).contiguous()
        alt = bf16_form()
        alt_err = mrd(alt, fp32_form())
        moved = float((alt != fp32_form()).float().mean())
        ms = cuda_ms(lambda: fn(x, w, b), 5)
        fp32_ms = cuda_ms(fp32_form, 5)
        alt_ms = cuda_ms(bf16_form, 5)
        if (ky, sy, C) == (3, 1, 256):
            # the device kernels of one step (res4's 3x3), by name
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(x, w, b)
                torch.cuda.synchronize()
            profiled = _op_label(op)
        tot["b7"] += ms
        tot["fp32"] += fp32_ms
        tot["bf16"] += alt_ms
        worst = max(worst, (alt_err, moved))
        print(f"vendor {_op_label(op):34s} template (B7) {ms:.4f} ms, "
              f"kernel {case['ms']:.4f}; FP32 form {fp32_ms:.4f} ms; bf16 "
              f"cuDNN form mrd {alt_err:.3e} vs the FP32 form, moves "
              f"{100 * moved:.1f}% of the stored values, {alt_ms:.4f} ms")
    print(f"vendor: {len(ops)} sigs; template (B7) {tot['b7']:.3f} ms, FP32 "
          f"form {tot['fp32']:.3f} ms, bf16 cuDNN form {tot['bf16']:.3f} "
          f"ms; the bf16 form's largest mrd against the FP32 form "
          f"{worst[0]:.3e} (gate 5e-3), moving {100 * worst[1]:.1f}% of the "
          f"values there, on [{ctx['smi']}]")
    print(f"vendor {profiled}: device kernels of one step: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.4f} ms"
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0))
    ctx["vendor_ms"] = tot
    # the edges of the epilogue and the split
    for label, (n, H, C, mems, k, s_, p_, bias) in {
            "no bias, f32 + int8 stores": (
                4, 14, 64, (Member(40, True, torch.float32),
                            Member(24, False, torch.int8, 3.0)), 3, 1, 1,
                False),
            "member widths 6+10 (no 4-result stores)": (
                2, 9, 24, (Member(6, True), Member(10, False)), 1, 1, 0,
                True),
            "split K, ragged oc 200": (
                1, 7, 512, (Member(200, True),), 3, 1, 1, True),
            "C = 3 7x7/s2, oc 64": (
                2, 30, 3, (Member(64, True),), 7, 2, 3, True),
            "C = 20 (4-byte copies) 5x5": (
                2, 12, 20, (Member(48, True),), 5, 1, 2, True),
            "C = 6 (element B), 4 members": (
                2, 10, 6, (Member(16, True), Member(8, False),
                           Member(32, True, torch.float32),
                           Member(8, True)), 3, 2, 1, True)}.items():
        N = sum(m.oc for m in mems)
        x = torch.randn(n, H, H, C, device=dev, generator=gen).bfloat16()
        w = (torch.randn(N, k, k, C, device=dev, generator=gen)
             * (C * k * k) ** -0.5).bfloat16()
        bs = tuple((torch.randn(m.oc, device=dev, generator=gen) * 0.5)
                   if bias else None for m in mems)
        _b7_case(f"edge: {label}", x, w, bs, mems, (s_, s_), (p_, p_),
                 peaks, f64=True)
    # the narrow copies (C = 3 element by element, C = 6 in 4 bytes)
    # unwidened, the kernel alone
    from boda_tpu_torch.ops.cuda.bconv import bconv_plain, bconv_plan, \
        launch_bconv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for C, k, mems in ((3, 7, (Member(64, True),)),
                       (6, 3, (Member(24, True), Member(8, False)))):
        x = torch.randn(2, 30, 30, C, device=dev, generator=gen).bfloat16()
        N = sum(m.oc for m in mems)
        w = (torch.randn(N, k, k, C, device=dev, generator=gen)
             * (C * k * k) ** -0.5).bfloat16()
        bs = tuple(torch.randn(m.oc, device=dev, generator=gen)
                   for m in mems)
        plan = bconv_plan(2, 30, 30, C, N, k, k, (2, 2), (1, 1), sms)
        outs = tuple(torch.empty(2, 15 - (k - 3) // 2, 15 - (k - 3) // 2,
                                 m.oc, dtype=m.dtype, device=dev)
                     for m in mems)
        launch_bconv(x, w, bs, mems, outs, (2, 2), (1, 1), plan.tile_n,
                     plan.full, plan.splits, plan.grid)
        want = bconv_plain(x, w, bs, mems, (2, 2), (1, 1))
        err = max(mrd(g, p) for g, p in zip(outs, want))
        print(f"bconv edge: unwidened C = {C} {k}x{k}/s2 copies "
              f"{plan.copy}/{plan.copy_b}: mrd {err:.3e}", flush=True)
        check(plan.copy in (2, 4) and err <= BF16_MRD,
              f"bconv unwidened C = {C}: mrd {err:.3e}")
    # every distinct B7 step of the three b128 cells
    cells = {}
    for cell, (model, tune) in {
            "resnet50-bf16-b128": ("resnet-50", "headline"),
            "resnet50-int8-b128": ("resnet-50", INT8),
            "googlenet-bf16-b128": ("googlenet_conv_lrn", "headline")}.items():
        steps = _b7_cell_steps(model, tune)
        sums = dict.fromkeys(("ms", "call_ms", "plain_ms", "bound_ms",
                              "library_ms"), 0.0)
        count = 0
        for k, (sig, c) in steps.items():
            x, w, bs, mems, stride, pad = _b7_operands(sig, dev, gen)
            case = _b7_case(f"{cell} x{c} {_b7_label(x, w, mems, stride)}",
                            x, w, bs, mems, stride, pad, peaks)
            for key in sums:
                sums[key] += c * case[key]
            count += c
            del x, w, bs
        torch.cuda.empty_cache()
        print(f"bconv {cell}: {count} B7 steps ({len(steps)} distinct) per "
              f"request: kernel {sums['ms']:.3f} ms (calls "
              f"{sums['call_ms']:.3f}), plain {sums['plain_ms']:.3f}, bound "
              f"{sums['bound_ms']:.3f}, cuDNN FP32 {sums['library_ms']:.3f} "
              f"on [{ctx['smi']}]", flush=True)
        cells[cell] = {"steps": count, **sums}
    ctx["bconv_cells"] = cells


# ResNeXt-101 (64x4d)'s grouped 3x3s at b128: (label, H, C, stride, steps
# of a request); 64 groups of C / 64 channels, pad 1
GCONV_STAGES = (("res2", 56, 256, 1, 3), ("res3a", 56, 512, 2, 1),
                ("res3", 28, 512, 1, 3), ("res4a", 28, 1024, 2, 1),
                ("res4", 14, 1024, 1, 22), ("res5a", 14, 2048, 2, 1),
                ("res5", 7, 2048, 1, 2))


def _gconv_case(label, x, w, b, groups, stride, pad, relu, peaks,
                timed=True):
    """B8 against gconv_plain on the card: the stored bf16 values against
    the plain version's sums stored in f32 (mrd at the bf16 gate; the two
    sum in other orders, so a value may sit one bf16 step off the plain
    version's), with the filter packed once as the conv step packs it (and
    packed in the call once, bit for bit the same), then timed: the kernel
    alone (a CUDA graph), the wrapper's call, the plain version and cuDNN's
    bf16 grouped conv alone on channels_last operands (the yardstick; the
    port never calls it), beside the bound. Returns the case's numbers."""
    import torch
    import torch.nn.functional as F
    from boda_tpu_torch.ops.cuda.gconv import gconv, gconv_plain, \
        gconv_plan, pack_filter
    from boda_tpu_torch.ops.cuda.util import sm_count
    from boda_tpu_torch.ops.mxu_grad import _conv_fwd
    wp = pack_filter(w, groups)
    got = gconv(x, w, b, groups, stride, pad, relu, wp)
    torch.cuda.synchronize()
    want = gconv_plain(x, w, b, groups, stride, pad, relu)
    y32 = _conv_fwd(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), stride,
                    pad, False, True, groups)
    if b is not None:
        y32 = y32 + b[None, :, None, None]
    y32 = (torch.relu(y32) if relu else y32).permute(0, 2, 3, 1)
    check(got.dtype == torch.bfloat16 and got.shape == want.shape
          and got.is_contiguous(),
          f"gconv {label}: output {got.dtype} {tuple(got.shape)}")
    check(bit_equal(gconv(x, w, b, groups, stride, pad, relu), got),
          f"gconv {label}: the filter packed in the call gives another "
          f"result")
    err = mrd(got, y32)
    moved = float((got != want).float().mean())
    check(err <= BF16_MRD, f"gconv {label}: mrd {err:.3e} against the "
                           f"plain version's f32 sums")
    n, H, W, C = x.shape
    oc, ky, kx, cg = w.shape
    oy, ox = got.shape[1:3]
    plan = gconv_plan(n, oy, ox, C, cg, ky, kx, tuple(stride),
                      sm_count(x.device.index))
    out = {"mrd": err, "moved": moved}
    if timed:
        out["ms"] = graph_ms(lambda: gconv(x, w, b, groups, stride, pad,
                                           relu, wp))
        out["call_ms"] = cuda_ms(lambda: gconv(x, w, b, groups, stride, pad,
                                               relu, wp), 10)
        out["plain_ms"] = cuda_ms(lambda: gconv_plain(
            x, w, b, groups, stride, pad, relu), 3)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        out["library_ms"] = cuda_ms(lambda: F.conv2d(
            xc, wc, stride=stride, padding=pad, groups=groups), 10)
        work = 2 * n * oy * ox * oc * ky * kx * cg
        nbytes = 2 * (x.numel() + w.numel() + got.numel()) + (
            0 if b is None else 4 * b.numel())
        out["bound_ms"], by = bound(peaks, "bf16", work, nbytes)
        times = (f"kernel {out['ms']:.4f} ms (call {out['call_ms']:.4f}), "
                 f"plain {out['plain_ms']:.4f}, bound {out['bound_ms']:.4f} "
                 f"({by}; kernel/bound "
                 f"{out['ms'] / out['bound_ms']:.2f}), cuDNN bf16 grouped "
                 f"{out['library_ms']:.4f}")
    else:
        times = "not timed"
    print(f"gconv {label:40s} mrd {err:.3e} (<= {BF16_MRD:g}; "
          f"{100 * moved:.2f}% of the values one bf16 step off the plain "
          f"version's); {times}; tile {plan.ty}x{plan.tx} of "
          f"{plan.tiles_y}x{plan.tiles_x}, halo {plan.hy}x{plan.hx}, ring "
          f"{plan.stages}, {plan.per_sm} a SM, grid {plan.grid} "
          f"({plan.per_slab} a slab), smem {plan.smem} B", flush=True)
    return out


def _gconv_registers(log: str) -> None:
    """Each gconv_kernel instance's registers, stack and spills, as ptxas
    -v reported them in this process's build (nothing where the library
    was built before it)."""
    name = None
    props = {}
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", ln.strip())
        if m:
            name = m.group(1)
            continue
        if name and "gconv_kernel" in name and (
                "spill" in ln or "registers" in ln):
            props.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    if not props:
        print("gconv registers: no build in this process", flush=True)
    for name, lines in props.items():
        cg = re.search(r"gconv_kernelILi(\d+)E", name)
        print(f"gconv registers: cg {cg.group(1) if cg else name}: "
              f"{'; '.join(dict.fromkeys(lines))}", flush=True)


def phase_gconv(ctx: dict) -> None:
    """Kernel B8 (csrc/gconv.cu, ops/cuda/gconv.py), the grouped conv under
    prec=bf16 with NHWC storage: each instance's registers and spills from
    the build; at each grouped 3x3 shape of ResNeXt-101 (64x4d) at b128 (64
    groups of 4 to 32 channels, the stride-2 first block of each stage too)
    against gconv_plain (the vendor arithmetic) and timed beside its bound
    and cuDNN's bf16 grouped conv alone, with the sums over a request's 33
    layers; at edges (no bias or ReLU, groups of 64 channels, 1x1 filters,
    pad 0, odd and unequal H and W, stride 2 on odd sizes, one image); and
    the xla_conv template of a grouped sig: route b8, its result the
    kernel's."""
    import torch
    from boda_tpu_torch.core.machine import card_peaks
    from boda_tpu_torch.ops.cuda.conv import make_conv_op
    from boda_tpu_torch.ops.cuda.gconv import gconv
    from boda_tpu_torch.ops.registry import get_template
    dev = torch.device("cuda", 0)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(8)
    _gconv_registers(ctx.get("build_log", ""))

    def operands(n, H, C, cg, bias=True, W=None, k=3):
        x = torch.randn(n, H, W or H, C, device=dev, generator=gen) \
            .bfloat16()
        w = (torch.randn(C, k, k, cg, device=dev, generator=gen)
             * (k * k * cg) ** -0.5).bfloat16()
        b = torch.randn(C, device=dev, generator=gen) * 0.5 if bias else None
        return x, w, b
    sums = dict.fromkeys(("ms", "call_ms", "plain_ms", "bound_ms",
                          "library_ms"), 0.0)
    steps = 0
    for label, H, C, st, count in GCONV_STAGES:
        x, w, b = operands(128, H, C, C // 64)
        case = _gconv_case(f"{label} x{count} 3x3/s{st} {C} g64 {H}^2 b128",
                           x, w, b, 64, (st, st), (1, 1), True, peaks)
        for k in sums:
            sums[k] += count * case[k]
        steps += count
        del x, w, b
    torch.cuda.empty_cache()
    print(f"gconv resnext101-bf16-b128: {steps} B8 steps per request: kernel "
          f"{sums['ms']:.3f} ms (calls {sums['call_ms']:.3f}), plain "
          f"{sums['plain_ms']:.3f}, bound {sums['bound_ms']:.3f} (kernel/"
          f"bound {sums['ms'] / sums['bound_ms']:.2f}), cuDNN bf16 grouped "
          f"{sums['library_ms']:.3f} on [{ctx['smi']}]", flush=True)
    ctx["gconv"] = {"steps": steps, **sums}
    # (n, H, W, C, groups, k, stride, pad, bias, relu)
    for label, (n, H, W, C, g, k, st, pd, bias, relu) in {
            "no bias, no ReLU, 13^2 (ragged tiles)": (
                2, 13, 13, 256, 64, 3, 1, 1, False, False),
            "groups of 64 channels": (2, 9, 9, 128, 2, 3, 1, 1, True, True),
            "groups of 64, stride 2 on 11x7, 4096 channels": (
                2, 11, 7, 4096, 64, 3, 2, 1, True, True),
            "stride 2 on 15^2, groups of 8": (3, 15, 15, 128, 16, 3, 2, 1,
                                              True, True),
            "stride 2 on 13x9, groups of 32": (2, 13, 9, 256, 8, 3, 2, 1,
                                               True, False),
            "pad 0, groups of 16, 37^2 (two tiles across)": (
                1, 37, 37, 64, 4, 3, 1, 0, True, False),
            "odd 17x23, groups of 4, one image": (1, 17, 23, 256, 64, 3, 1,
                                                  1, True, True),
            "1x1, groups of 16, 9x11": (2, 9, 11, 256, 16, 1, 1, 0, True,
                                        True),
            "1x1 stride 2, groups of 4, 15x13": (2, 15, 13, 128, 32, 1, 2, 0,
                                                 True, False),
            "groups of 4 at 64 channels, stride 2, 58^2": (
                2, 58, 58, 64, 16, 3, 2, 1, True, True)}.items():
        x, w, b = operands(n, H, C, C // g, bias, W, k)
        _gconv_case(f"edge: {label}", x, w, b, g, (st, st), (pd, pd), relu,
                    peaks, timed=False)
    # the template: a grouped xla_conv sig under the cell's tune
    op = make_conv_op(4, 512, 28, 28, 512, 3, 3, 1, 1, 1, 1, relu=True,
                      groups=64)
    op.str_vals.update(prec="bf16", io_layout="nhwc", edge_prec="bf16")
    t = get_template("xla_conv")
    fn = t.build(t.check_args(op))
    check(fn.route == "b8", f"gconv template: route {fn.route}")
    x = torch.randn(4, 28, 28, 512, device=dev, generator=gen).bfloat16()
    w = torch.randn(512, 8, 3, 3, device=dev, generator=gen) * 0.1
    b = torch.randn(512, device=dev, generator=gen)
    fn(x, w, b)  # the step's first call packs the filter
    before = gconv.launches
    got = fn(x, w, b)
    check(gconv.launches == before + 1, "gconv template: the step's second "
          "call launched more than B8 once")
    want = gconv(x, w.permute(0, 2, 3, 1).bfloat16().contiguous(), b, 64,
                 (1, 1), (1, 1), True)
    check(bit_equal(got, want),
          "gconv template: the step's result is not the kernel's")
    print("gconv template: a grouped xla_conv step runs B8 once a call, its "
          "result the kernel's bit for bit", flush=True)


def _nodes_to_get(pipe):
    return [n for n, nd in pipe.nodes.items()
            if nd.dims is not None and nd.top_for]


def phase_digests(ctx: dict) -> None:
    from boda_tpu_torch.apps.train import load_weights_into_pipe
    from boda_tpu_torch.core.dims import NDA
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.engine.torch_fwd import produced_nodes
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.ops.cuda.gen_data import gen_test_nda
    from boda_tpu_torch.testing.comp import comp_digests, read_digest_stream
    for archive, kw, wfn, toler in (
            ("resnet-50@shapes40", {"num_classes": 40}, TRAINED, 3e-3),
            ("resnet-50", {}, None, 8e-3)):
        kg = read_digest_stream(DATA / "tpu_digests" / archive /
                                "digest-rtc.boda")
        for tune_name in ("f32", "fused_f32", "sib_f32"):
            t0 = time.perf_counter()
            pipe = build_model("resnet-50", batch=1, **kw)
            if wfn is not None:
                load_weights_into_pipe(pipe, str(wfn))
            eng = make_engine(f"(engine=torch,device=cuda,keep_all_nodes=1,"
                              f"op_tune={TUNES[tune_name]})")
            eng.init(pipe)
            d = pipe.get_data_img_dims()
            blob = NDA(d, gen_test_nda(d, 0, 0.1))
            # a fused plan has no values for its fused ops' interior nodes
            produced = produced_nodes(eng.plan)
            outs = eng.run_fwd({pipe.data_img_node_names[0]: blob},
                               [n for n in _nodes_to_get(pipe)
                                if n in produced])
            want = {k: v for k, v in kg.items() if k in produced}
            missing = [k for k in want if k not in outs]
            check(not missing, f"digests {archive} {tune_name}: nodes "
                               f"missing: {missing[:5]}")
            check(tune_name != "f32" or len(want) == len(kg),
                  f"digests {archive}: the f32 plan lacks "
                  f"{len(kg) - len(want)} archived nodes")
            errs = comp_digests(outs, want, toler)
            print(f"digests {archive} {tune_name}: {len(want)} of {len(kg)} "
                  f"nodes vs TPU archive, mrd toler {toler:g}: {len(errs)} "
                  f"mismatches ({time.perf_counter() - t0:.1f} s)")
            for e in errs[:10]:
                print(f"  {e}")
            check(not errs, f"digests {archive} {tune_name}: {len(errs)} "
                            f"mismatches")
            del eng


def _run_cls_agree(label: str, model_args: str, spec_a: str, spec_b: str,
                   top1: float, batch: int = 32) -> dict:
    """cls_agree of two engine=torch specs on the 64 held-out images;
    returns its statistics, checked against the accuracy gates: top-1 >=
    `top1` each and agreement >= 0.97."""
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        create_and_run_has_main(
            f"(mode=cls_agree,{model_args},batch={batch},src={HELD_OUT_SRC},"
            f"conv_fwd=(engine=torch,{spec_a}),"
            f"conv_fwd_b=(engine=torch,{spec_b}))", {})
    out = buf.getvalue().strip()
    print(f"cls_agree {label} ({time.perf_counter() - t0:.1f} s): "
          f"{out.splitlines()[-1] if out else '<no output>'}")
    stats = {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", out)}
    check(stats.get("num_test") == 64, f"cls_agree: num_test {stats}")
    check(stats["top_1_acc_a"] >= top1 and stats["top_1_acc_b"] >= top1,
          f"cls_agree {label}: top-1 below {top1}: {stats}")
    check(stats["top_1_agree"] >= 0.97, f"cls_agree {label}: agreement "
                                        f"{stats}")
    return stats


def _cls_agree(tune_a: str, tune_b: str) -> dict:
    """cls_agree of engine=torch under two tunes with the trained
    ResNet-50 (_run_cls_agree, top-1 >= 0.90); for the int8 preset against
    the headline tune, also tests/test_quant8.py's 64-image gates (int8
    within one image of bf16, its top-1 in bf16's top-5 for 98% of the
    images, top-5 overlap >= 0.95)."""
    stats = _run_cls_agree(
        f"(a={tune_a}, b={tune_b})",
        f"model=resnet-50,model_opts=(num_classes=40),weights_fn={TRAINED}",
        engine_spec(tune_a, "trained"), engine_spec(tune_b, "trained"), 0.90)
    if tune_b == INT8:
        check(stats["num_pos_b"] >= stats["num_pos_a"] - 1
              and stats["b_top1_in_a_top5"] >= 0.98
              and stats["top_5_overlap"] >= 0.95,
              f"cls_agree {tune_a} vs {tune_b}: int8 gates {stats}")
    return stats


def phase_agree(ctx: dict) -> None:
    for tune_a in ("bf16_nhwc", "fused_bf16_nhwc", "headline"):
        _cls_agree(tune_a, "f32")
    _cls_agree("headline", INT8)


def _wrappers() -> dict:
    """Each kernel's wrapper, whose `launches` counts its launches
    (ops/cuda/util.kernel_wrappers: "quantize" is sgemm_int8's quantize
    kernel, "act_quantize" qconv's, "cotangent_quantize" its per-channel
    form in the int8 weight gradient)."""
    from boda_tpu_torch.ops.cuda.util import kernel_wrappers
    return kernel_wrappers()


def _op_label(op) -> str:
    """A short name for an op sig of the per-op sweep."""
    if op.type == "sgemm":
        a, b = op.get_dims("a"), op.get_dims("b")
        return f"sgemm {a['M']}x{a['K']}x{b['N']}"
    f, i = op.get_dims("filts"), op.get_dims("in")
    st = op.get_dims("stride")
    return (f"conv {f['y']}x{f['x']}/s{st['y']} {f['in_chan']}->"
            f"{f['out_chan']} {i['y']}^2 b{i['img']}")


def _tune_specs(tunes: str) -> dict[str, str]:
    """'(kg=(use_culibs=1),hand=())' -> {'kg': '(use_culibs=1)', 'hand': '()'}"""
    return dict(re.findall(r"(\w+)=(\((?:[^()]|\([^()]*\))*\))", tunes[1:-1]))


def _ops_prof_table(text: str, tunes: str, peaks,
                    us: bool = False) -> list[str]:
    """One row per OP line of an ops_prof run: ms (us: microseconds), TF/s
    (TOPS for int8) and % of the card's peak in the op's own precision."""
    from boda_tpu_torch.ops.cnn_variants import add_codegen_annotations, \
        make_op_tune
    from boda_tpu_torch.ops.op_base import OpBase
    from boda_tpu_torch.tune.opinfo import op_prec
    tune_specs = _tune_specs(tunes)
    rows = []
    for m in re.finditer(r"^OP (\(.*\)) tune=(\w+) be=\w+ func=(\w+) "
                         r"secs=(\S+) GF/s=(\S+) ", text, re.M):
        op = OpBase.from_lexp(m[1])
        top = op.copy()
        tune = make_op_tune(tune_specs[m[2]])
        add_codegen_annotations(top, tune)
        prec = op_prec(top, tune.prec)
        tfs = float(m[5]) / 1e3
        rows.append(f"  {_op_label(op):34s} {m[2]:5s} {m[3]:10s} "
                    f"{float(m[4]) * (1e6 if us else 1e3):9.4f} "
                    f"{'us' if us else 'ms'} {tfs:8.2f} "
                    f"{'TOPS ' if prec == 'int8' else 'TF/s '}"
                    f"{100 * tfs * 1e12 / peaks.flops(prec):6.2f}% of {prec} "
                    f"peak")
    return rows


def _check_vendor_sgemm_bf16(dev) -> None:
    """The vendor sgemm template (xla_sgemm, the kg tune's) under prec=bf16
    on the card: an f32 product of the bf16-rounded operands, not rounded
    again (within 1e-5 of the f64 product of the rounded operands, and not
    a bf16 value)."""
    import torch
    from boda_tpu_torch.ops.op_base import OpBase
    from boda_tpu_torch.ops.registry import get_template
    M, K, N = 256, 1024, 192
    op = OpBase.from_lexp(f"(type=sgemm,str_vals=(prec=bf16),dims_vals=("
                          f"a=(M={M},K={K}),b=(K={K},N={N}),c=(M={M},N={N})))")
    t = get_template("xla_sgemm")
    gen = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn(M, K, device=dev, generator=gen)
    b = torch.randn(K, N, device=dev, generator=gen) * K ** -0.5
    got = t.build(t.check_args(op))(a, b)
    want = a.bfloat16().double() @ b.bfloat16().double()
    err = mrd(got, want)
    rounded = bool(torch.equal(got, got.bfloat16().float()))
    print(f"xla_sgemm prec=bf16 M={M} K={K} N={N}: {got.dtype}, mrd {err:.3e} "
          f"(<= 1e-5) against the f64 product of the bf16 operands; a bf16 "
          f"value: {rounded}")
    check(got.dtype == torch.float32 and err <= 1e-5 and not rounded,
          "xla_sgemm under prec=bf16 does not return the unrounded f32 "
          "product")


def phase_ops_prof(ctx: dict) -> None:
    """The per-op path: ops_prof on be=torch over the SGEMM sizes and
    the ResNet-50 b32 conv sigs, then rtc_test, each in-process
    through the mode a user runs (python -m boda_tpu_torch <mode>)."""
    import torch
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    from boda_tpu_torch.core.machine import card_peaks
    from boda_tpu_torch.tune.wisdom import read_wisdom_file
    peaks = card_peaks(torch.cuda.get_device_name(0))
    out_dir = ROOT / "build" / "ops_prof"
    wrappers = _wrappers()
    _check_vendor_sgemm_bf16(torch.device("cuda", 0))
    for name, ops_fn, tunes, tol in OPS_PROF:
        for w in wrappers.values():
            w.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                create_and_run_has_main(
                    f"(mode=ops_prof,ops_fn={DATA / 'ops' / ops_fn},"
                    f"op_tunes={tunes},run_iter={OPS_RUN_ITER},"
                    f"{tol + ',' if tol else ''}boda_output_dir={out_dir},"
                    f"wisdom_out_fn={name}.wis)", {})
        finally:
            text = buf.getvalue()
            for ln in text.splitlines():
                if "COMP_FAIL" in ln or "KG_DIGEST_FAIL" in ln \
                        or "ERROR" in ln or "UNVERIFIED" in ln:
                    print(f"  {ln}")
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        n_ok = len(re.findall(r"^OP .* ok$", text, re.M))
        print(f"ops_prof {name} ({ops_fn}, {tunes} {tol}): {n_ok} runs "
              f"ok, launches {counts} ({time.perf_counter() - t0:.1f} s)")
        for row in _ops_prof_table(text, tunes, peaks):
            print(row)
        n_ops = len((DATA / "ops" / ops_fn).read_text().split())  # 1 per line
        n_tunes = len(_tune_specs(tunes))
        check(n_ok == n_ops * n_tunes,
              f"ops_prof {name}: {n_ok} runs ok of {n_ops * n_tunes}")
        plats = {p for w in read_wisdom_file(out_dir / f"{name}.wis")
                 for t in w.tunes.values() for p in t.runs}
        check(plats == {f"torch:cuda:{torch.cuda.get_device_name(0)}"},
              f"ops_prof {name}: wisdom plat tags {plats}")
        if name == "sgemm":
            for k in ("sgemm_int8", "quantize"):
                check(counts[k] == OPS_INT8_LAUNCHES,
                      f"ops_prof {name}: {counts[k]} {k} launches != "
                      f"{OPS_INT8_LAUNCHES}")
            ctx.setdefault("launches", {})["ops_prof"] = counts
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        create_and_run_has_main("(mode=rtc_test,n=1048576)", {})
    line = buf.getvalue().splitlines()[0]
    print(line)
    check(line.startswith("rtc_test PASSED plat=torch:cuda:"),
          f"rtc_test: {line}")
    print(f"  on [{ctx['smi']}]")


def _template_ms(eng, inputs: dict, top: str) -> dict:
    """{template: (steps, summed ms)} over one forward of `eng`, each step
    between two CUDA events."""
    import torch
    events = []

    @contextlib.contextmanager
    def timed(step):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        yield
        t1.record()
        events.append((step.func_name, t0, t1))

    with torch.inference_mode():
        eng.fwd(inputs, eng.weights, step_hook=timed)[top]
    torch.cuda.synchronize()
    per: dict = {}
    for f, t0, t1 in events:
        n, t = per.get(f, (0, 0.0))
        per[f] = (n + 1, t + t0.elapsed_time(t1))
    return per


def _device_busy_ms(fn, margin_s: float | None = None
                    ) -> tuple[float, list[tuple[str, int, float]]]:
    """Milliseconds the card spends in kernels and copies during one call of
    fn: the sum of the device events of torch.profiler's trace (one stream,
    so they do not overlap); and the six device kernels that took the most
    of it, as (name, calls, ms). One call before it runs in the trace as
    the profiler's warm-up, whose events it drops: late in a long process
    CUPTI missed about a tenth of a forward's first kernels without it
    (cnet_xprof's per-step total against this function's, on an H100).
    The traced call has margin_s of idle time (default
    tune/xprof.PROFILE_MARGIN_S) inside each end of the recorded window
    (tune/xprof.traced_steps); margin_s 0 is the reading before that, whose
    empty reads scripts/profiler_empty_traces.py counts."""
    import torch
    from boda_tpu_torch.tune.xprof import aggregate_profile, traced_steps
    torch.cuda.synchronize()
    prof = traced_steps(fn, 1, on_card=True, margin_s=margin_s)
    rows = aggregate_profile(prof, device=True)
    busy = sum(r["total_ns"] for r in rows) / 1e6
    check(busy > 0, "torch.profiler recorded no device time")
    return busy, [(r["op"][:48], r["count"], r["total_ns"] / 1e6)
                  for r in rows[:6]]


def phase_full(ctx: dict) -> None:
    import torch
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    wrappers = _wrappers()
    batch = 32
    launches = ctx.setdefault("launches", {})
    for tune_name in FULL_TUNES:
        tune = engine_spec(tune_name)
        buf = io.StringIO()
        for w in wrappers.values():
            w.launches = 0
        with contextlib.redirect_stdout(buf):
            hm = create_and_run_has_main(
                f"(mode=run_cnet,model=resnet-50,batch={batch},dump_top=1,"
                f"conv_fwd=(engine=torch,{tune}))", {})
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        launches[tune_name] = counts
        dig = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith("digest:")]
        print(f"run_cnet resnet-50 b{batch} {tune_name} "
              f"{TUNES.get(tune_name, '(the headline tune, int8 sites)')}: "
              f"launches "
              f"{counts}; {dig[0] if dig else '<no digest line>'}")
        check(counts == LAUNCHES[tune_name],
              f"run_cnet {tune_name}: launches {counts} != "
              f"{LAUNCHES[tune_name]}")
        eng = hm.conv_fwd
        steps = {}
        for s in eng.plan.steps:
            steps[s.func_name] = steps.get(s.func_name, 0) + 1
        print(f"  steps: {steps}")
        # what the lowering sent where: one launch per step of a template
        # that wraps a hand kernel, and per int8 vendor step one qconv and,
        # unless its input arrives int8, one act_quantize
        planned = _planned_launches(eng.plan, counts)
        check(counts == planned, f"run_cnet {tune_name}: launches {counts} "
                                 f"!= the plan's steps {planned}")
        check(("xla_conv2" in steps) == ("fuse_siblings" in tune),
              f"run_cnet {tune_name}: xla_conv2 steps {steps}")
        pipe = hm.pipe
        d = pipe.get_data_img_dims()
        data = pipe.data_img_node_names[0]
        top = pipe.get_single_top_node().name
        gen = torch.Generator(device=eng.dev).manual_seed(1)
        x = torch.randn(tuple(d.shape), device=eng.dev, generator=gen)
        with torch.inference_mode():
            def fwd():
                return eng.fwd({data: x}, eng.weights)[top]
            prob = fwd()
            ms = cuda_ms(fwd, 10)
        p = prob.float()
        check(tuple(p.shape) == (batch, 1000, 1, 1),
              f"{tune_name}: prob shape {tuple(p.shape)}")
        check(bool(torch.isfinite(p).all()), f"{tune_name}: non-finite prob")
        row_err = float((p.sum(dim=1) - 1).abs().max())
        check(row_err < 1e-2, f"{tune_name}: softmax rows off by {row_err}")
        print(f"  forward (device-resident input, CUDA events, 10 reps): "
              f"{ms:.3f} ms = {batch / ms * 1e3:.1f} imgs/s on "
              f"[{ctx['smi']}]")
        ctx.setdefault("fwd_ms", {})[tune_name] = ms
        with torch.inference_mode():
            busy, top_kernels = _device_busy_ms(fwd)
        print(f"  device busy {busy:.3f} ms of the forward's {ms:.3f} ms "
              f"({100 * (1 - busy / ms):.1f}% idle; the kernels and copies "
              f"of one more forward in torch.profiler's device trace); "
              f"most of it: " + "; ".join(f"{k} x{n} {t:.3f} ms"
                                          for k, n, t in top_kernels))
        ctx.setdefault("busy_ms", {})[tune_name] = busy
        per = _template_ms(eng, {data: x}, top)
        print("  per template, one more forward (CUDA events per step): "
              + ", ".join(f"{f} x{n} {t:.3f} ms" for f, (n, t) in
                          sorted(per.items(), key=lambda kv: -kv[1][1]))
              + f"; sum {sum(t for _, t in per.values()):.3f} ms")
        ctx.setdefault("template_ms", {})[tune_name] = {
            f: {"steps": n, "ms": t} for f, (n, t) in per.items()}
        del hm, eng
        torch.cuda.empty_cache()
    for tune_name in B128_TUNES:
        _forward_b128(ctx, tune_name)


def _forward_b128(ctx: dict, tune_name: str) -> None:
    """One forward time of a tune at the JAX bench's batch, 128 (zoo weights
    from a seed; CUDA events, 5 reps), with its exact launches."""
    import torch
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.models.zoo import build_model
    batch = 128
    pipe = build_model("resnet-50", batch=batch)
    eng = make_engine(f"(engine=torch,{engine_spec(tune_name)})")
    eng.init(pipe)
    data = pipe.data_img_node_names[0]
    top = pipe.get_single_top_node().name
    gen = torch.Generator(device=eng.dev).manual_seed(1)
    x = torch.randn(tuple(pipe.get_data_img_dims().shape), device=eng.dev,
                    generator=gen)
    wrappers = _wrappers()
    with torch.inference_mode():
        def fwd():
            return eng.fwd({data: x}, eng.weights)[top]
        for w in wrappers.values():
            w.launches = 0
        p = fwd().float()
        counts = {k: w.launches for k, w in wrappers.items()}
        ms = cuda_ms(fwd, 5)
    check(counts == LAUNCHES[tune_name], f"{tune_name} b128: launches "
                                         f"{counts}")
    check(tuple(p.shape) == (batch, 1000, 1, 1) and
          bool(torch.isfinite(p).all()), f"{tune_name} b128: bad prob")
    print(f"run_cnet resnet-50 b{batch} {tune_name}: forward {ms:.3f} ms = "
          f"{batch / ms * 1e3:.1f} imgs/s on [{ctx['smi']}]")
    ctx.setdefault("fwd_ms_b128", {})[tune_name] = ms
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- engine

ENGINE_OUT = ROOT / "build" / "engine_smoke"
# the 64 held-out images cls_agree reads (the agree phase)
HELD_OUT = dict(num_imgs=64, start_ix=100000, ysz=224, xsz=224,
                num_classes=40, seed=1, mean=128, scale=0.015625)
HELD_OUT_SRC = "(mode=shapes-src," + ",".join(
    f"{k}={v}" for k, v in HELD_OUT.items()) + ")"
STATS_RTOL = 1e-5


def _counts_reset(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0


def _planned_launches(plan, counts: dict, grad: bool = False) -> dict:
    """The launches the plan's steps send to each hand kernel on a
    forward: one per step of a template that wraps one, and per conv step
    what conv.conv_route gives it: one B7 (bconv) or one B8 (gconv) on
    inference (under autograd, grad, the vendor conv runs with its VJP),
    one qconv and, unless its input arrives int8, one act_quantize on
    B6."""
    from boda_tpu_torch.ops.cuda.conv import CONV_STEPS, conv_route
    from boda_tpu_torch.ops.registry import get_template
    planned = dict.fromkeys(counts, 0)
    for st in plan.steps:
        if st.func_name in TEMPLATE_KERNEL:
            planned[TEMPLATE_KERNEL[st.func_name]] += 1
        if st.func_name not in CONV_STEPS:
            continue
        route = conv_route(get_template(st.func_name).check_args(st.sig))
        if route == "b6":
            planned["qconv"] += 1
            planned["act_quantize"] += 1 - st.sig.get_u32_or("in_q8", 0)
        elif route in ROUTE_KERNEL and not grad:
            planned[ROUTE_KERNEL[route]] += 1
    return planned


def _run_mode(spec: str) -> tuple[str, object]:
    """create_and_run_has_main(spec) with its stdout captured."""
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hm = create_and_run_has_main(spec, {})
    return buf.getvalue(), hm


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of fn() (which ends in a host copy)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[reps // 2]


def _percall_vs_fused(ctx: dict, wrappers: dict) -> None:
    """ResNet-50 b32 under (): the per-call forward bit-equal to the fused
    one on prob and interior nodes, B1 and B2 launched as the plan says,
    the per-call report, both forwards timed."""
    import numpy as np
    import torch
    from boda_tpu_torch.core.dims import NDA
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.engine.torch_fwd import produced_nodes
    from boda_tpu_torch.models.zoo import build_model
    batch = 32
    pipe = build_model("resnet-50", batch=batch)
    report = ENGINE_OUT / "per_call_resnet50_b32.txt"
    fused = make_engine("(engine=torch,op_tune=())")
    fused.init(pipe)
    percall = make_engine(f"(engine=torch,fuse=0,op_tune=(),"
                          f"per_call_fn={report})")
    percall.init(pipe)
    d = pipe.get_data_img_dims()
    data = pipe.data_img_node_names[0]
    x = np.random.RandomState(1).randn(*d.shape).astype(np.float32)
    nodes = [n for n in _nodes_to_get(pipe) if n in produced_nodes(fused.plan)]
    interior = [n for n in nodes[:-1][::max(1, len(nodes) // 10)]]
    want = interior + ["prob"]
    outs_f = fused.run_fwd({data: NDA(d, x)}, want)
    _counts_reset(wrappers)
    outs_p = percall.run_fwd({data: NDA(d, x)}, want)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    ctx.setdefault("launches", {})["percall_f32"] = counts
    print(f"per-call resnet-50 b{batch} (): launches {counts}")
    check(counts == UNFUSED_LAUNCHES,
          f"per-call (): launches {counts} != {UNFUSED_LAUNCHES}")
    check(counts == _planned_launches(percall.plan, counts),
          f"per-call (): launches {counts} != the plan's steps")
    unequal = [n for n in want if not np.array_equal(outs_f[n].v,
                                                     outs_p[n].v)]
    print(f"  fused vs per-call: {len(want)} nodes ({', '.join(want)}), "
          f"bit-unequal: {unequal}")
    check(len(interior) >= 5 and not unequal,
          f"per-call vs fused: nodes not bit-equal: {unequal}")
    p = outs_p["prob"].v
    check(p.shape == (batch, 1000, 1, 1) and np.isfinite(p).all(),
          "per-call prob: bad shape or non-finite")
    lines = report.read_text().splitlines()
    check(lines[0] == "per-layer timing (tag func secs):"
          and len(lines) == 1 + len(percall.fwd_calls)
          == 1 + len(percall.plan.steps),
          f"per-call report: {len(lines)} lines for "
          f"{len(percall.fwd_calls)} calls")
    per_t: dict = {}
    total = 0.0
    for ln, c in zip(lines[1:], percall.fwd_calls):
        tag, inst, secs = ln.split()
        check(tag == c.call_tag and inst == c.func_name and float(secs) > 0,
              f"per-call report line '{ln}'")
        f = inst.rsplit("__", 1)[0]
        n, t = per_t.get(f, (0, 0.0))
        per_t[f] = (n + 1, t + float(secs) * 1e3)
        total += float(secs) * 1e3
    x_dev = torch.from_numpy(x).to(fused.dev)
    top = pipe.get_single_top_node().name
    with torch.inference_mode():
        def fused_fwd():
            return fused.fwd({data: x_dev}, fused.weights)[top]

        def percall_fwd():
            for c in percall.fwd_calls:
                percall.codegen.run_func(c)
        ms_f = cuda_ms(fused_fwd, 10)
        busy_f, _ = _device_busy_ms(fused_fwd)
        ms_p = cuda_ms(percall_fwd, 5)
        busy_p, _ = _device_busy_ms(percall_fwd)
    print(f"  per-call report: {len(lines) - 1} lines, sum of the calls' "
          f"CUDA-event spans {total:.3f} ms; the per-call forward "
          f"{ms_p:.3f} ms, the card busy {busy_p:.3f} ms of it "
          f"({100 * (1 - busy_p / ms_p):.1f}% idle); the fused forward "
          f"{ms_f:.3f} ms, busy {busy_f:.3f} ms "
          f"({100 * (1 - busy_f / ms_f):.1f}% idle) on [{ctx['smi']}]")
    print("  per template (per-call report): " + ", ".join(
        f"{f} x{n} {t:.3f} ms" for f, (n, t) in
        sorted(per_t.items(), key=lambda kv: -kv[1][1])))
    ctx["engine"] = {"percall_report_ms": total, "percall_fwd_ms": ms_p,
                     "percall_busy_ms": busy_p, "fused_fwd_ms": ms_f,
                     "fused_busy_ms": busy_f,
                     "percall_template_ms": {f: {"steps": n, "ms": t}
                                             for f, (n, t) in per_t.items()}}


def _percall_int8(ctx: dict, wrappers: dict) -> dict:
    """The int8 preset on the trained snapshot, per call against the fused
    executor, over the 64 held-out images (the cls_agree gates); B6 once
    per int8 step of the per-call plan."""
    import numpy as np
    import torch
    from boda_tpu_torch.core.dims import NDA
    spec = engine_spec(INT8, "trained")
    t0 = time.perf_counter()
    out, hm = _run_mode(
        f"(mode=cls_agree,model=resnet-50,model_opts=(num_classes=40),"
        f"batch=32,weights_fn={TRAINED},src={HELD_OUT_SRC},"
        f"conv_fwd=(engine=torch,{spec}),"
        f"conv_fwd_b=(engine=torch,fuse=0,{spec}))")
    line = out.strip().splitlines()[-1]
    stats = {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", line)}
    print(f"cls_agree int8 preset, a=fused, b=per-call "
          f"({time.perf_counter() - t0:.1f} s): {line}")
    check(stats.get("num_test") == 64 and stats["top_1_agree"] >= 0.97
          and min(stats["top_1_acc_a"], stats["top_1_acc_b"]) >= 0.90,
          f"int8 per-call vs fused: {stats}")
    fused, percall = hm.conv_fwd, hm.conv_fwd_b
    n_f = sum(s.sig.get_u32_or("quant8", 0) for s in fused.plan.steps)
    n_p = sum(s.sig.get_u32_or("quant8", 0) for s in percall.plan.steps)
    d = hm.pipe.get_data_img_dims()
    x = np.random.RandomState(2).randn(*d.shape).astype(np.float32)
    _counts_reset(wrappers)
    percall.run_fwd({hm.pipe.data_img_node_names[0]: NDA(d, x)}, ["prob"])
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    ctx.setdefault("launches", {})["percall_int8"] = counts
    print(f"  int8 steps: fused plan {n_f}, per-call plan {n_p} (lowered "
          f"without the storage pass); per-call forward launches {counts}")
    check(counts == _planned_launches(percall.plan, counts)
          and counts["qconv"] == n_p == n_f == 31,
          f"int8 per-call: launches {counts}, int8 steps {n_p} / {n_f}")
    del hm, fused, percall
    torch.cuda.empty_cache()
    return stats


def _compute_multi(model: str, engines: str, toler: float,
                   out_dir: Path = ENGINE_OUT, kg: bool = True):
    """test_compute_multi at batch 1 through the CLI: the engines against
    each other and, with kg, against the model's TPU digest archive (which
    must be in the repo); returns the mode's object (its engines hold
    their plans)."""
    t0 = time.perf_counter()
    kg_fn = DATA / "tpu_digests" / model / "digest-rtc.boda"
    check(not kg or kg_fn.exists(), f"test_compute_multi {model}: no TPU "
                                    f"digest archive {kg_fn}")
    out, hm = _run_mode(
        f"(mode=test_compute_multi,model={model},batch=1,all_vars=1,"
        f"mrd_toler={toler},boda_output_dir={out_dir / model},"
        f"engines=({engines})"
        + (f",kg_digests_fn={kg_fn})" if kg else ")"))
    lines = out.strip().splitlines()
    print(f"test_compute_multi {model} mrd {toler:g} "
          f"({time.perf_counter() - t0:.1f} s): " + "; ".join(lines))
    n = engines.count("engine=")
    check(len(lines) == (2 * n - 1 if kg else n - 1)
          and all(ln.endswith(": PASS") for ln in lines),
          f"test_compute_multi {model}: {lines}")
    return hm


def _stats_and_nan(ctx: dict) -> None:
    """enable_stats at ResNet-50 b1 in both executors; nan_check, clean and
    with a NaN in one res3 conv's filter; their cost at b32."""
    import numpy as np
    import torch
    from boda_tpu_torch.core.dims import NDA
    from boda_tpu_torch.core.error import RtErr
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.engine.torch_fwd import produced_nodes, step_writes
    from boda_tpu_torch.models.zoo import build_model
    pipe = build_model("resnet-50", batch=1)
    d = pipe.get_data_img_dims()
    data = pipe.data_img_node_names[0]
    ins = {data: NDA(d, np.random.RandomState(3).randn(*d.shape)
                     .astype(np.float32))}
    stats = {}
    for fuse in (1, 0):
        eng = make_engine(f"(engine=torch,fuse={fuse},enable_stats=1,"
                          f"nan_check=1)")
        eng.init(pipe)
        nodes = sorted(produced_nodes(eng.plan) - set(eng.plan.input_nodes))
        outs = eng.run_fwd(ins, nodes)
        # per call, a node's stats are taken after its first write (as the
        # JAX engine's per-call mode takes them): nodes written again (an
        # in-place ReLU after an eltwise) are held only to the fused ones
        writes: dict = {}
        for s in eng.plan.steps:
            for n in step_writes(s):
                writes[n] = writes.get(n, 0) + 1
        once = [n for n in nodes if writes[n] == 1]
        check(set(eng.stats) == set(nodes), f"stats nodes fuse={fuse}")
        held = nodes if fuse else once
        for n in held:
            v = outs[n].v.astype(np.float64)
            s = eng.stats[n].v
            # the mean's error is relative to the mean of |x| (the sum may
            # cancel), sum(x^2)'s to itself
            check((s[0], s[1]) == (np.float32(v.min()), np.float32(v.max()))
                  and abs(s[2] - v.mean()) <= STATS_RTOL * np.abs(v).mean()
                  and abs(s[3] - (v * v).sum()) <= STATS_RTOL * (v * v).sum(),
                  f"stats fuse={fuse} node {n}: {s} vs "
                  f"{[v.min(), v.max(), v.mean(), (v * v).sum()]}")
        stats[fuse] = (eng.stats, once, len(nodes))
        del eng
    (sf, once, n_all), (sp, _, _) = stats[1], stats[0]
    for n in once:
        check(np.array_equal(sf[n].v, sp[n].v),
              f"stats fused vs per-call node {n}: {sf[n].v} {sp[n].v}")
    print(f"enable_stats resnet-50 b1: {n_all} nodes; min and max equal to "
          f"the returned nodes', mean within {STATS_RTOL:g} x mean|x| and "
          f"sum(x^2) within rtol {STATS_RTOL:g} of float64 sums "
          f"(fused: every node; per-call: the {len(once)} "
          f"nodes written once, the other {n_all - len(once)} taken before "
          f"their in-place ReLU as in the JAX engine); fused and per-call "
          f"bit-equal on those {len(once)}")
    bad = build_model("resnet-50", batch=1)
    w = bad.op_params["res3a_branch2b_filts"]
    w.v = w.v.copy()
    w.v.reshape(-1)[5] = np.nan
    for fuse in (1, 0):
        eng = make_engine(f"(engine=torch,fuse={fuse},nan_check=1)")
        eng.init(bad)
        try:
            eng.run_fwd(ins, ["prob"])
            msg = "<no error>"
        except RtErr as e:
            msg = str(e)
        print(f"nan_check fuse={fuse}, NaN in res3a_branch2b_filts: {msg}")
        check(msg.startswith("nan_check: non-finite values in node")
              and (msg.endswith("(first in step order: 'res3a_branch2b')")
                   if fuse else "node 'res3a_branch2b' (first" in msg),
              f"nan_check fuse={fuse}: {msg}")
        del eng
    # the cost of the sanitizer and of the stats at b32 (fused executor)
    pipe = build_model("resnet-50", batch=32)
    d = pipe.get_data_img_dims()
    ins = {data: NDA(d, np.random.RandomState(4).randn(*d.shape)
                     .astype(np.float32))}
    ms, probs = {}, {}
    for opt in ("", ",nan_check=1", ",enable_stats=1"):
        eng = make_engine(f"(engine=torch{opt})")
        eng.init(pipe)
        probs[opt] = eng.run_fwd(ins, ["prob"])["prob"].v
        ms[opt] = _wall_ms(lambda: eng.run_fwd(ins, ["prob"]))
        del eng
        torch.cuda.empty_cache()
    check(all(np.array_equal(probs[""], p) for p in probs.values()),
          "nan_check / enable_stats changed the outputs")
    print(f"resnet-50 b32 fused run_fwd (host copies in and out, median of "
          f"5): plain {ms['']:.3f} ms, nan_check=1 {ms[',nan_check=1']:.3f} "
          f"ms, enable_stats=1 {ms[',enable_stats=1']:.3f} ms on "
          f"[{ctx['smi']}]; outputs bit-equal")
    ctx["engine"].update({"run_fwd_ms_b32": ms[""],
                          "nan_check_run_fwd_ms_b32": ms[",nan_check=1"],
                          "stats_run_fwd_ms_b32": ms[",enable_stats=1"]})


def _vgg_dropout_quantize(ctx: dict) -> None:
    """VGG-19 b1 with train_dropout=1,det_drop_seed=7 and a quantize hook
    on fc8-conv (after both dropouts), both executors, against engine=ref
    with the same dropout settings; the seeded mask on the card against
    its numpy twin."""
    import numpy as np
    import torch
    from boda_tpu_torch.core.dims import NDA
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.engine.lower import DROP_SEED_NODE
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.ops.cuda.elementwise import Dropout
    from boda_tpu_torch.ops.cuda.gen_data import gen_test_nda
    pipe = build_model("vgg-19", batch=1)
    d = pipe.get_data_img_dims()
    seed = 3
    drop_nodes = ("fc6-conv", "fc7-conv")
    want = [*drop_nodes, "fc8-conv", "prob"]
    t0 = time.perf_counter()
    ref = make_engine("(engine=ref,train_dropout=1,det_drop_seed=7)")
    ref.init(pipe)
    sd = ref.plan.node_dims[DROP_SEED_NODE]
    ins = {"data": NDA(d, gen_test_nda(d, 0, 0.1)),
           DROP_SEED_NODE: NDA(sd, np.asarray([seed], np.int32))}
    r = ref.run_fwd(ins, want)
    ref_s = time.perf_counter() - t0
    # the grid: max_val a power of two above twice fc8's reach, 12 bits
    max_val = float(2 ** np.ceil(np.log2(2 * np.abs(r["fc8-conv"].v).max())))
    step = max_val / 4096
    q = f"quantize=((name=fc8-conv,max_val={max_val:g},keep_bits=12))"
    for fuse in (1, 0):
        eng = make_engine(f"(engine=torch,fuse={fuse},train_dropout=1,"
                          f"det_drop_seed=7,{q})")
        eng.init(pipe)
        got = eng.run_fwd(ins, want)
        zeros = {n: (int((got[n].v == 0).sum()), int((r[n].v == 0).sum()))
                 for n in drop_nodes}
        errs = {n: mrd(torch.from_numpy(got[n].v), torch.from_numpy(r[n].v))
                for n in want}
        fc8 = got["fc8-conv"].v.astype(np.float64)
        on_grid = bool((np.round(fc8 / step) * step == fc8).all())
        print(f"vgg-19 b1 fuse={fuse} train_dropout=1,det_drop_seed=7,seed "
              f"{seed}, {q}: zeroed units (torch, ref) {zeros}; mrd vs ref "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f"; fc8-conv on the quantize grid: {on_grid}")
        check(all(a == b for a, b in zeros.values()),
              f"dropout zero counts fuse={fuse}: {zeros}")
        check(all(e <= 3e-2 for e in errs.values()) and on_grid,
              f"vgg-19 dropout/quantize fuse={fuse}: {errs}, grid {on_grid}")
        del eng
    shape = (1, 4096, 1, 1)
    for s in (seed, 0, 2**31 - 1):
        u = Dropout._mask32(torch.tensor([s], dtype=torch.int32,
                                         device="cuda"), shape)
        check(np.array_equal(u.cpu().numpy(),
                             Dropout._mask32_np(s, shape).astype(np.float32)),
              f"seeded mask on the card != _mask32_np (seed {s})")
    print(f"  the seeded mask on the card equals _mask32_np bit for bit "
          f"(seeds {seed}, 0, 2^31-1); engine=ref took {ref_s:.1f} s")
    ctx["engine"]["vgg19_ref_s"] = ref_s


def _test_lmdb(agree: dict) -> None:
    """test_lmdb (per-call, ()) with the trained snapshot over the 64
    held-out images, written as caffe Datums into an LMDB."""
    from boda_tpu_torch.apps.eval_cls import encode_datum
    from boda_tpu_torch.io.synth import render_shapes
    from boda_tpu_torch.utils.lmdbmini import write_lmdb
    h = HELD_OUT
    imgs, labels = render_shapes(
        range(h["start_ix"], h["start_ix"] + h["num_imgs"]), h["ysz"],
        h["xsz"], h["num_classes"], h["seed"])
    db = ENGINE_OUT / "held_out_lmdb"
    write_lmdb(db, [(b"%08d" % i, encode_datum(im, lab))
                    for i, (im, lab) in enumerate(zip(imgs, labels))])
    t0 = time.perf_counter()
    out, _ = _run_mode(
        f"(mode=test_lmdb,model=resnet-50,model_opts=(num_classes=40),"
        f"batch=32,weights_fn={TRAINED},conv_fwd=(engine=torch,fuse=0),"
        f"src=(mode=lmdb-src,fn={db},mean={h['mean']},scale={h['scale']}))")
    line = out.strip().splitlines()[-1]
    stats = {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", line)}
    print(f"test_lmdb per-call () over the held-out LMDB "
          f"({time.perf_counter() - t0:.1f} s): {line}; cls_agree on the "
          f"same images: num_pos_a={agree['num_pos_a']:g} "
          f"num_pos_b={agree['num_pos_b']:g} of {agree['num_test']:g}")
    check(stats.get("num_test") == 64 and stats["top_1_acc"] >= 0.90,
          f"test_lmdb: {stats}")


def _wisdom(ctx: dict, wrappers: dict) -> None:
    """wisdom_fn at ResNet-50 b32: the tunes picked as on the CPU (the
    records' platform tags are a TPU's: the any-platform fallback), then
    one timed forward."""
    import torch
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.models.zoo import build_model
    wis = DATA / "wisdom-resnet50-b32.wis"
    plans = {}
    for dev in ("cuda", "cpu"):
        pipe = build_model("resnet-50", batch=32)
        eng = make_engine(f"(engine=torch,device={dev},wisdom_fn={wis})")
        eng.init(pipe)
        plans[dev] = [str(s.sig.to_lexp()) for s in eng.plan.steps]
        log = eng.get_info_log()
        if dev == "cuda":
            card = eng
    check(plans["cuda"] == plans["cpu"], "wisdom: the card's plan differs "
                                         "from the CPU's")
    data = pipe.data_img_node_names[0]
    top = pipe.get_single_top_node().name
    gen = torch.Generator(device=card.dev).manual_seed(1)
    x = torch.randn(tuple(pipe.get_data_img_dims().shape), device=card.dev,
                    generator=gen)
    steps: dict = {}
    for s in card.plan.steps:
        steps[s.func_name] = steps.get(s.func_name, 0) + 1
    with torch.inference_mode():
        def fwd():
            return card.fwd({data: x}, card.weights)[top]
        _counts_reset(wrappers)
        p = fwd().float()
        counts = {k: w.launches for k, w in wrappers.items()}
        ms = cuda_ms(fwd, 10)
    check(bool(torch.isfinite(p).all()), "wisdom forward: non-finite prob")
    check(counts == _planned_launches(card.plan, counts),
          f"wisdom forward: launches {counts}")
    print(f"wisdom_fn={wis.name} resnet-50 b32: {log}; the same "
          f"{len(plans['cuda'])} step sigs as on the CPU; steps {steps}; "
          f"launches {counts}; forward {ms:.3f} ms on [{ctx['smi']}]")
    ctx["engine"]["wisdom_fwd_ms_b32"] = ms
    del card
    torch.cuda.empty_cache()


def phase_engine(ctx: dict) -> None:
    """The engine's per-call mode (fuse=0) and its options, engine=ref and
    the harness modes test_compute_multi and test_lmdb, on the card."""
    import torch
    ENGINE_OUT.mkdir(parents=True, exist_ok=True)
    wrappers = _wrappers()
    _percall_vs_fused(ctx, wrappers)
    torch.cuda.empty_cache()
    agree = _percall_int8(ctx, wrappers)
    t0 = time.perf_counter()
    _compute_multi("resnet-50", "ref=(engine=ref),fused=(engine=torch,"
                   "keep_all_nodes=1),percall=(engine=torch,fuse=0)", 8e-3)
    ctx["engine"]["compute_multi_resnet50_s"] = time.perf_counter() - t0
    _compute_multi("vgg-19", "fused=(engine=torch,keep_all_nodes=1),"
                   "percall=(engine=torch,fuse=0)", 3e-2)
    _stats_and_nan(ctx)
    _vgg_dropout_quantize(ctx)
    _test_lmdb(agree)
    _wisdom(ctx, wrappers)


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "headline_config",
              "conv_tflops", "frac_of_roofline", "peak_tflops", "prec",
              "batch", "device", "compile_s", "step_ms", "bf16_step_ms",
              "bf16_imgs_per_sec", "bf16_frac_of_roofline",
              "bf16_vs_baseline", "int8_step_ms", "int8_imgs_per_sec",
              "int8_frac_of_roofline", "int8_vs_baseline",
              "int8_peak_tflops", "int8_frac_of_int8_roofline",
              "mixed_peak_tflops", "int8_frac_of_mixed_roofline")


# distinct batches the upload phase cycles through, as the benchmark's
# request pool does: each call reads host memory no cache still holds
UPLOAD_POOL = 8


def _pool_ms(fn, pool: list, reps: int, sync: bool = True) -> float:
    """Median host milliseconds of fn(a) over `reps` calls, a the next
    array of pool in turn, after one call on each; with sync each call ends
    in a synchronize, else the card is synchronized outside the timing (the
    time until fn returns)."""
    import torch
    for a in pool:
        fn(a)
    torch.cuda.synchronize()
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(pool[i % len(pool)])
        if sync:
            torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return sorted(ts)[reps // 2]


def phase_upload(ctx: dict) -> None:
    """The u8 wire's upload at b128 and b8 from a pool of UPLOAD_POOL
    batches: io/device_preproc.PinnedStager's copy bit-equal to the
    pageable one, and both timed, medians of 21 calls."""
    import numpy as np
    import torch
    from boda_tpu_torch.io import device_preproc as dp
    dev = torch.device("cuda", 0)
    reps = 21
    print(f"  host threads {torch.get_num_threads()}, a pool of "
          f"{UPLOAD_POOL} batches [{ctx['smi']}]")
    out = {}
    for batch in (128, 8):
        rs = np.random.RandomState(batch)
        pool = [rs.randint(0, 256, (batch, 224, 224, 3)).astype(np.uint8)
                for _ in range(UPLOAD_POOL)]
        n = pool[0].nbytes
        st = dp.PinnedStager(dev)
        for x in pool:
            got, k = st.upload("data", x)
            check(k == n and torch.equal(got, torch.from_numpy(x).to(dev)),
                  f"upload b{batch}: the staged copy differs from the "
                  f"pageable one, or staged {k} of {n} B")
        row = {"bytes": n,
               "pageable_ms": _pool_ms(
                   lambda x: torch.from_numpy(x).to(dev), pool, reps),
               "staged_ms": _pool_ms(lambda x: st.upload("data", x), pool,
                                     reps),
               "staged_return_ms": _pool_ms(lambda x: st.upload("data", x),
                                            pool, reps, sync=False)}
        print(f"  upload b{batch} {n} B: pageable {row['pageable_ms']:.3f} "
              f"ms ({n / row['pageable_ms'] / 1e6:.1f} GB/s), staged "
              f"{row['staged_ms']:.3f} ({n / row['staged_ms'] / 1e6:.1f}), "
              f"returns after {row['staged_return_ms']:.3f}", flush=True)
        out[f"b{batch}"] = row
        del pool, st
    ctx["upload"] = out


def phase_bench(ctx: dict) -> None:
    """The bench twin (python3 -m boda_tpu_torch.bench) in this process:
    one JSON line with bench.py's keys, finite step times, the int8 preset
    on the trained weights as the headline."""
    import math

    from boda_tpu_torch import bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main()
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"bench: rc {rc}, output {lines}")
    res = json.loads(lines[0])
    print(lines[0])
    check(tuple(res) == BENCH_KEYS, f"bench: keys {tuple(res)}")
    check(res["headline_config"] == "int8-preset+trained-weights"
          and all(math.isfinite(res[k]) and res[k] > 0
                  for k in ("int8_step_ms", "bf16_step_ms", "value")),
          f"bench: {res}")
    ctx["bench"] = lines[0]


# ---------------------------------------------------------------- zoo

ZOO_OUT = ROOT / "build" / "zoo_smoke"
GOOGLENET_TRAINED = DATA / "googlenet-shapes40.boda"
# each zoo model's int8 site set (the JAX package's tests/test_quant8.py
# and docs/PERF.md per-model table) and its static scales, calibrated at
# b128 on the zoo weights; squeezenet has no scales file in the repo, so
# the phase calibrates it as scripts/calibrate_int8.py does (one float
# forward of the headline tune over the bench's seeded input)
ZOO_INT8 = {"googlenet_conv": (r"inception_.*/[35]x[35]",
                               DATA / "googlenet-b128-int8-scales.lexp"),
            "nin_imagenet": (r"conv2|conv3|conv4-1024",
                             DATA / "nin-b128-int8-scales.lexp"),
            "squeezenet-1.0": (r".*expand3x3", None),
            "alexnet_ng_conv": (r"conv[2-5]|fc[67]-conv",
                                DATA / "alexnet-b128-int8-scales.lexp")}
# the cnet_bench rows at b128: every model under the headline tune and
# under its int8 site set, and GoogLeNet under () (B1 and B2 at full width)
ZOO_ROWS = [(m, "headline") for m in ZOO_INT8] + \
    [(m, INT8) for m in ZOO_INT8] + [("googlenet_conv", "f32")]
ZOO_BENCH_ITERS = 10
# B6 at GoogLeNet's int8 sites, batch 128 (x bf16 NHWC at a static scale,
# ReLU, bf16 out): the 5x5s with C = 16, 24, 32 and 48 (K = 400-1200; C =
# 24 is element-staged) and the 3x3 with C = 96
ZOO_QCONV = [
    ("googlenet 3a/5x5 n=128 28^2 16->32",
     dict(n=128, H=28, W=28, C=16, oc=32, k=5, s=1, p=2, relu=True)),
    ("googlenet 3b/5x5 n=128 28^2 32->96",
     dict(n=128, H=28, W=28, C=32, oc=96, k=5, s=1, p=2, relu=True)),
    ("googlenet 4b/5x5 n=128 14^2 24->64",
     dict(n=128, H=14, W=14, C=24, oc=64, k=5, s=1, p=2, relu=True)),
    ("googlenet 5b/5x5 n=128 7^2 48->128",
     dict(n=128, H=7, W=7, C=48, oc=128, k=5, s=1, p=2, relu=True)),
    ("googlenet 3a/3x3 n=128 28^2 96->128",
     dict(n=128, H=28, W=28, C=96, oc=128, k=3, s=1, p=1, relu=True)),
]
ZOO_F32_MRD = 1e-5
# test_compute_multi on the zoo nets: every node of the fused () forward
# (B1, B2, cuDNN's FP32 stem) and of the per-call one against the float64
# engine=ref (the engine phase holds vgg-19 to 3e-2; these pass far inside)
ZOO_NET_MRD = 1e-4


def _step_sig(model: str, tune: str, tag: str, batch: int):
    """The sig of the plan step with call tag `tag` in `model` lowered at
    `batch` under `tune` (with the fused-storage pass)."""
    from boda_tpu_torch.engine.lower import lower_pipe
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.ops.cnn_variants import make_op_tune
    plan = lower_pipe(build_model(model, batch=batch), make_op_tune(tune),
                      fuse_relu=True, fused_storage=True)
    return [s.sig for s in plan.steps if s.call_tag == tag]


def _built(op):
    from boda_tpu_torch.ops.registry import get_template
    t = get_template(op.func_name)
    rfs = t.check_args(op)
    return t, rfs, t.build(rfs)


def _zoo_record(z: dict, label: str, err: float, toler: float, ms: float,
                nbytes: int, peaks, extra: str = "") -> None:
    bound_ms, _ = bound(peaks, "f32", 0, nbytes)
    print(f"zoo template {label:52s} mrd {err:.3e} (<= {toler:g}) "
          f"{ms:.4f} ms (bytes bound {bound_ms:.4f} ms){extra}")
    check(err <= toler, f"zoo template {label}: mrd {err:.3e} > {toler:g}")
    z.setdefault("templates", {})[label] = {
        "mrd": err, "toler": toler, "ms": ms, "bound_ms": bound_ms}


def _zoo_lrn(z: dict, dev, gen, peaks) -> None:
    """LRN at AlexNet's norm1 (b128, 96x55x55) and norm2 (b128, 256x27x27)
    under () (f32 NCHW) and the headline tune (bf16 NHWC storage), against
    the float64 reference of the input as the template gets it; each
    time is kept for the AlexNet rows' LRN share."""
    import torch
    for tag, C, H in (("norm1", 96, 55), ("norm2", 256, 27)):
        x = torch.relu(torch.randn(128, C, H, H, device=dev,
                                   generator=gen)) * 20
        for tune_name, dt, tol in (("f32", torch.float32, ZOO_F32_MRD),
                                   ("headline", torch.bfloat16, BF16_MRD)):
            (op,) = _step_sig("alexnet_ng_conv", TUNES[tune_name], tag, 128)
            t, rfs, fn = _built(op)
            nhwc = op.str_vals.get("io_layout") == "nhwc"
            xs = x.to(dt)
            xin = xs.permute(0, 2, 3, 1).contiguous() if nhwc else xs
            got = fn(xin)
            torch.cuda.synchronize()
            want = t.ref_impl(rfs, xs.double().cpu().numpy())
            g = got.permute(0, 3, 1, 2) if nhwc else got
            err = mrd(g.cpu(), torch.from_numpy(want))
            ms = cuda_ms(lambda: fn(xin), 10)
            z.setdefault("lrn_ms", {}).setdefault(tune_name, {})[tag] = ms
            _zoo_record(z, f"lrn alexnet {tag} b128 {C}x{H}^2 "
                           f"{str(dt)[6:]}{' nhwc' if nhwc else ''}", err,
                        tol, ms, 2 * _nbytes(xin), peaks)
            del got, g, xin, xs


def _zoo_copy(z: dict, dev, gen, peaks) -> None:
    """GoogLeNet's inception_3b/output concat at b128 (four members, 480
    channels of 28x28) under () and the headline tune: its four copy steps
    write their members into one zero buffer in place, bit-equal to the
    float64 reference's slices."""
    import torch
    from boda_tpu_torch.engine.lower import lower_pipe
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.ops.cnn_variants import make_op_tune
    for tune in ("()", TUNES["headline"]):
        plan = lower_pipe(build_model("googlenet_conv", batch=128),
                          make_op_tune(tune), fuse_relu=True,
                          fused_storage=True)
        steps = [s for s in plan.steps if s.func_name == "copy"
                 and s.arg_nodes["out"] == "inception_3b/output"]
        check(len(steps) == 4, f"zoo copy: {len(steps)} members")
        nhwc = plan.storage_nhwc
        dt = torch.bfloat16 if plan.edge_prec == "bf16" else torch.float32
        fns = [_built(s.sig) for s in steps]
        members = [torch.randn(*plan.node_dims[s.arg_nodes["in"]].shape,
                               device=dev, generator=gen).to(dt)
                   for s in steps]
        if nhwc:
            members = [m.permute(0, 2, 3, 1).contiguous() for m in members]
        d = plan.node_dims["inception_3b/output"].shape
        shape = (d[0], d[2], d[3], d[1]) if nhwc else tuple(d)

        def concat():
            buf = torch.zeros(shape, dtype=dt, device=dev)
            for (_, _, fn), m in zip(fns, members):
                check(fn(m, buf) is buf, "zoo copy: not in place")
            return buf
        got = concat()
        torch.cuda.synchronize()
        want = torch.zeros(tuple(d), dtype=torch.float64).numpy()
        for (t, rfs, _), m in zip(fns, members):
            mm = m.permute(0, 3, 1, 2) if nhwc else m
            want = t.ref_impl(rfs, mm.double().cpu().numpy(), want)
        g = got.permute(0, 3, 1, 2) if nhwc else got
        equal = bool(torch.equal(g.double().cpu(), torch.from_numpy(want)))
        check(equal, f"zoo copy {tune}: differs from the reference")
        ms = cuda_ms(concat, 10)
        _zoo_record(z, f"copy googlenet 3b/output b128 480x28^2 "
                       f"{str(dt)[6:]}{' nhwc' if nhwc else ''} (4 members)",
                    0.0, 0.0, ms, 2 * _nbytes(got), peaks,
                    " bit-equal, in place")


def _zoo_deconv(z: dict, dev, gen, peaks) -> None:
    """deconv at deconv-tiny.prototxt's layer (8->4, k4/s2/p1, b1) and at a
    2x upsample of 256 channels at 56^2, b8, f32 NCHW and bf16 NHWC
    storage: the whole batch against a float64 conv_transpose2d on the
    card, and the first image against the template's float64 scatter
    (ref_impl), of the operands as the template rounds them."""
    import torch
    import torch.nn.functional as F
    from boda_tpu_torch.ops.cuda.conv import make_deconv_op
    cases = [("deconv-tiny up1 b1 8->4 8^2", (1, 8, 8, 8, 4)),
             ("upsample x2 b8 256->256 56^2", (8, 256, 56, 56, 256))]
    for label, (n, cin, h, w, cout) in cases:
        x = torch.randn(n, cin, h, w, device=dev, generator=gen)
        wt = torch.randn(cout, cin, 4, 4, device=dev, generator=gen) \
            * (cin * 4) ** -0.5
        b = torch.randn(cout, device=dev, generator=gen)
        for nhwc, dt, tol in ((False, torch.float32, ZOO_F32_MRD),
                              (True, torch.bfloat16, BF16_MRD)):
            op = make_deconv_op(n, cin, h, w, cout, 4, 4, 2, 2, 1, 1)
            if nhwc:
                op.str_vals.update(io_layout="nhwc", prec="bf16",
                                   edge_prec="bf16")
            t, rfs, fn = _built(op)
            xs = x.to(dt)
            xin = xs.permute(0, 2, 3, 1).contiguous() if nhwc else xs
            got = fn(xin, wt, b)
            torch.cuda.synchronize()
            g = (got.permute(0, 3, 1, 2) if nhwc else got).double()
            wr = wt.to(dt).double()
            want = F.conv_transpose2d(xs.double(), wr.transpose(0, 1),
                                      b.double(), stride=2, padding=1)
            err = mrd(g, want)
            ref0 = t.ref_impl(rfs, xs[:1].double().cpu().numpy(),
                              wr.cpu().numpy(), b.double().cpu().numpy())
            err0 = mrd(g[:1].cpu(), torch.from_numpy(ref0))
            ms = cuda_ms(lambda: fn(xin, wt, b), 10)
            _zoo_record(z, f"deconv {label} {str(dt)[6:]}"
                           f"{' nhwc' if nhwc else ''}", max(err, err0), tol,
                        ms, _nbytes(xin, wt, b, got), peaks,
                        f" (image 0 vs ref_impl {err0:.3e})")


def _zoo_small_templates(z: dict, dev, gen, peaks) -> None:
    """scale (with bias), xpose, xpose_filts and reduce at GoogLeNet's
    inception_3b output size against their float64 references (scale
    under bf16 storage rounds the product and the sum to bf16, as the JAX
    template does: bit-equal to the same template on the CPU, which
    tests/test_torch_zoo_ops.py holds bit-equal to the JAX template);
    bwai's three ops at bwai-tiny.txt's size against its reference."""
    import math

    import numpy as np
    import torch
    from boda_tpu_torch.core.dims import Dims
    from boda_tpu_torch.ops.op_base import OpBase
    n, C, H, W = 32, 480, 28, 28
    x = torch.randn(n, C, H, W, device=dev, generator=gen)
    s_, b_ = (torch.randn(C, device=dev, generator=gen) for _ in range(2))
    for nhwc, dt in ((False, torch.float32), (True, torch.bfloat16)):
        op = OpBase({"type": "Scale", "func_name": "scale"})
        op.set_dims("in", Dims.make(img=n, chan=C, y=H, x=W))
        op.set_dims("scales", Dims.make(chan=C))
        op.set_dims("biases", Dims.make(chan=C))
        op.set_dims("out", Dims.make(img=n, chan=C, y=H, x=W))
        if nhwc:
            op.str_vals.update(io_layout="nhwc", edge_prec="bf16")
        t, rfs, fn = _built(op)
        xs = x.to(dt)
        xin = xs.permute(0, 2, 3, 1).contiguous() if nhwc else xs
        sv, bv = s_.to(dt), b_.to(dt)
        got = fn(xin, sv, bv)
        if nhwc:
            err, tol = (0.0 if torch.equal(got.cpu(), fn(
                xin.cpu(), sv.cpu(), bv.cpu())) else math.inf), 0.0
        else:
            err, tol = mrd(got.cpu(), torch.from_numpy(t.ref_impl(
                rfs, xs.double().cpu().numpy(), sv.double().cpu().numpy(),
                bv.double().cpu().numpy()))), 1e-6
        _zoo_record(z, f"scale {n}x{C}x{H}^2 {str(dt)[6:]}"
                       f"{' nhwc (vs the CPU)' if nhwc else ''}", err, tol,
                    cuda_ms(lambda: fn(xin, sv, bv), 10),
                    2 * _nbytes(xin), peaks)
    op = OpBase({"type": "xpose", "func_name": "xpose"})
    op.set_dims("in", Dims.make(img=n, chan=C, y=H, x=W))
    op.set_dims("out", Dims.make(img=n, y=H, x=W, chan=C))
    t, rfs, fn = _built(op)
    got = fn(x)
    equal = bool(torch.equal(got.cpu(), torch.from_numpy(
        t.ref_impl(rfs, x.cpu().numpy()))))
    check(equal, "zoo xpose: differs from its reference")
    _zoo_record(z, f"xpose nchw->nhwc {n}x{C}x{H}^2 float32", 0.0, 0.0,
                cuda_ms(lambda: fn(x), 10), 2 * _nbytes(x), peaks,
                " bit-equal")
    op = OpBase({"type": "xpose_filts", "func_name": "xpose_filts"})
    op.set_dims("filts", Dims.make(out_chan=192, in_chan=96, y=3, x=3))
    op.set_dims("filts_xp", Dims.make(y=3, x=3, in_chan=96, out_chan=192))
    t, rfs, fn = _built(op)
    f = torch.randn(192, 96, 3, 3, device=dev, generator=gen)
    check(bool(torch.equal(fn(f).cpu(), torch.from_numpy(
        t.ref_impl(rfs, f.cpu().numpy())))), "zoo xpose_filts: differs")
    ins = torch.randn(4, n, C, H, W, device=dev, generator=gen)
    op = OpBase({"type": "reduce", "func_name": "reduce"})
    op.set_dims("ins", Dims.make(v=4, img=n, chan=C, y=H, x=W))
    op.set_dims("out", Dims.make(img=n, chan=C, y=H, x=W))
    t, rfs, fn = _built(op)
    want = np.asarray(ins.double().cpu().numpy()).sum(axis=0)
    _zoo_record(z, f"reduce 4 x {n}x{C}x{H}^2 float32",
                mrd(fn(ins).cpu(), torch.from_numpy(want)), 1e-6,
                cuda_ms(lambda: fn(ins), 10), _nbytes(ins, x), peaks)
    xb = torch.randn(65536, device=dev, generator=gen) * 3
    for bw_op in ("copy", "scale", "read"):
        op = OpBase({"type": "bwai", "func_name": "bwai", "bw_op": bw_op})
        op.set_dims("in", Dims.make(tn="float", n=65536))
        op.set_dims("out", Dims.make(tn="float",
                                     n=8 if bw_op == "read" else 65536))
        t, rfs, fn = _built(op)
        got = fn(xb).cpu()
        want = torch.from_numpy(t.ref_impl(rfs, xb.cpu().numpy()))
        if bw_op == "read":
            what = "sum within 1e-6 of sum|x|"
            ok = float((got - want).abs().max()) \
                <= 1e-6 * float(xb.abs().sum())
        else:
            what, ok = "bit-equal", torch.equal(got, want)
        print(f"zoo template bwai {bw_op} n=65536: {what} {ok}")
        check(ok, f"zoo bwai {bw_op}: differs from its reference")


def _zoo_bwai_rates(z: dict, peaks) -> None:
    """bwai through ops_prof (be=torch on the card) on
    tests/data/ops/bwai.txt (67M f32 elements: 256 MiB in, and out but for
    read) and bwai-tiny.txt: each op's best time of 5 calls and its memory
    rate (the bytes it moves over it: bytes_accessed, twice that for scale's
    two passes) beside the card's nominal HBM rate."""
    import torch
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    from boda_tpu_torch.ops.op_base import OpBase
    from boda_tpu_torch.ops.registry import get_template
    bwai = get_template("bwai")
    for ops_fn in ("bwai.txt", "bwai-tiny.txt"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            create_and_run_has_main(
                f"(mode=ops_prof,ops_fn={DATA / 'ops' / ops_fn},"
                f"op_tunes=(t=()),run_iter=5,boda_output_dir={ZOO_OUT},"
                f"wisdom_out_fn=bwai.wis)", {})
        text = buf.getvalue()
        rows = re.findall(r"^OP (\(.*\)) tune=t be=\w+ func=bwai "
                          r"secs=(\S+) .* ok$", text, re.M)
        check(len(rows) == 3 and "COMP_FAIL" not in text
              and "ERROR" not in text,
              f"ops_prof {ops_fn}: {len(rows)} bwai runs ok")
        for sig, secs in rows:
            op = OpBase.from_lexp(sig)
            nb = bwai.bytes_accessed(bwai.check_args(op))
            bw_op = op.str_vals["bw_op"]
            # scale runs as two torch passes (x * a, then + b, each rounded
            # as the JAX body rounds): it moves twice the bytes it counts
            moved = 2 * nb if bw_op == "scale" else nb
            rate = moved / float(secs)
            print(f"bwai {ops_fn} {bw_op:5s} n={op.get_dims('in')['n']}: "
                  f"{float(secs) * 1e3:.4f} ms, {rate / 1e12:.3f} TB/s "
                  f"over {moved} bytes moved"
                  f"{' by two passes' if bw_op == 'scale' else ''} "
                  f"({100 * rate / peaks.hbm_bw:.1f}% of the nominal "
                  f"{peaks.hbm_bw / 1e12:.2f} TB/s) on [{z['smi']}]")
            if ops_fn == "bwai.txt":
                z.setdefault("bwai_tb_per_s", {})[bw_op] = rate / 1e12
    torch.cuda.synchronize()


def _zoo_qconv(z: dict, dev, gen, peaks) -> None:
    """B6 at GoogLeNet's int8 shapes, bit-equal to its plain version
    (the kernels phase's case, _qconv_case, timed)."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = _qconv_stats()
    for label, kw in ZOO_QCONV:
        _qconv_case(s, label, kw, True, dev, gen, peaks, sms)
    z["qconv_googlenet"] = {k: s[k] for k in (
        "ms", "plain_ms", "bound_ms", "library_ms", "quantize_ms",
        "quantize_bound_ms", "max_abs_err")}
    z["qconv_googlenet"]["cases"] = [
        {k: c[k] for k in ("case", "ms", "call_ms", "plain_ms", "tops",
                           "bound_ms", "bound_by", "library_ms", "plan")}
        for c in s["cases"]]


def _zoo_compute_multi(z: dict, launches: dict, wrappers: dict) -> None:
    """test_compute_multi at b1 on googlenet_conv_lrn, alexnet_ng_conv and
    squeezenet-1.0 with zoo weights: engine=ref (float64), the fused ()
    executor (B1 and B2 at every conv shape of the net) and the per-call
    mode on every node; the hand kernels launched as the two plans say."""
    import torch
    engines = ("ref=(engine=ref),fused=(engine=torch,keep_all_nodes=1),"
               "percall=(engine=torch,fuse=0)")
    for model in ("googlenet_conv_lrn", "alexnet_ng_conv", "squeezenet-1.0"):
        _counts_reset(wrappers)
        t0 = time.perf_counter()
        hm = _compute_multi(model, engines, ZOO_NET_MRD, ZOO_OUT, kg=False)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        planned = dict.fromkeys(counts, 0)
        for name in ("fused", "percall"):
            for k, v in _planned_launches(hm.engines[name].plan,
                                          counts).items():
                planned[k] += v
        print(f"  launches (fused + per-call forward) {counts}")
        check(counts == planned and counts["matmul_ext"] > 0,
              f"test_compute_multi {model}: launches {counts} != the "
              f"plans' {planned}")
        launches[f"zoo_compute_multi:{model}"] = counts
        z.setdefault("compute_multi_s", {})[model] = \
            time.perf_counter() - t0


def _calibrate(model: str, pats: str, out_fn: Path) -> None:
    """Static int8 scales of `model`'s site set at b128 on the zoo weights:
    one float forward of the headline tune over the bench's seeded input
    (tune/presets.calibrate_int8_act_scales), saved to out_fn."""
    import numpy as np
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.ops.cnn_variants import make_op_tune
    from boda_tpu_torch.tune.presets import calibrate_int8_act_scales, \
        save_act_scales
    pipe = build_model(model, batch=128)
    d = pipe.get_data_img_dims()
    x = (np.random.RandomState(0).randn(*d.shape) * 0.1).astype(np.float32)
    rx = re.compile(pats)
    q = make_op_tune(TUNES["headline"][:-1] + ",quant8=1)")
    sites = {op.tag: q for op in pipe.ops.values()
             if op.type == "Convolution" and rx.fullmatch(op.tag)}
    save_act_scales(out_fn, calibrate_int8_act_scales(
        pipe, TUNES["headline"], x, sites))
    print(f"calibrated {len(sites)} int8 site(s) of {model}: {out_fn.name}")


def _int8_spec(pats: str, scales_fn) -> str:
    """The engine attributes of the headline tune with int8 at the sites
    `pats` matches, their activation scales static from scales_fn."""
    q = TUNES["headline"][:-1] + ",quant8=1)"
    return (f"op_tune={TUNES['headline']},op_tunes_pat=({pats}={q}),"
            f"act_scales_fn={scales_fn}")


def _zoo_cls_agree(z: dict) -> None:
    """cls_agree on the trained 40-class GoogLeNet over the 64 held-out
    images: () against the bf16 NHWC tune and against the headline tune
    (its inception 1x1 trios fused into 3-member xla_conv2 steps), and the
    headline tune against int8 at GoogLeNet's site set with static scales
    calibrated on the trained weights (32 training-split images, as
    scripts/calibrate_int8.py calibrates the trained ResNet-50); top-1 >=
    0.85 under every tune, agreement >= 0.97."""
    import numpy as np
    from boda_tpu_torch.apps.train import load_weights_into_pipe
    from boda_tpu_torch.io.synth import render_shapes
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.ops.cnn_variants import make_op_tune
    from boda_tpu_torch.tune.presets import calibrate_int8_act_scales, \
        save_act_scales
    pats, _ = ZOO_INT8["googlenet_conv"]
    pipe = build_model("googlenet_conv", batch=32, num_classes=40)
    load_weights_into_pipe(pipe, str(GOOGLENET_TRAINED))
    imgs, _ = render_shapes(range(32), 224, 224, 40, seed=1)
    x = (imgs.astype(np.float32) - 128.0) / 64.0
    rx = re.compile(pats)
    q = make_op_tune(TUNES["headline"][:-1] + ",quant8=1)")
    sites = {op.tag: q for op in pipe.ops.values()
             if op.type == "Convolution" and rx.fullmatch(op.tag)}
    scales_fn = ZOO_OUT / "googlenet-shapes40-int8-scales.lexp"
    save_act_scales(scales_fn, calibrate_int8_act_scales(
        pipe, TUNES["headline"], x, sites))
    args = (f"model=googlenet_conv,model_opts=(num_classes=40),"
            f"weights_fn={GOOGLENET_TRAINED}")
    for a, b in ((TUNES["f32"], TUNES["bf16_nhwc"]),
                 (TUNES["f32"], TUNES["headline"])):
        z.setdefault("cls_agree", {})[f"{a} vs {b}"] = _run_cls_agree(
            f"googlenet (a={a}, b={b})", args, f"op_tune={a}",
            f"op_tune={b}", 0.85)
    z["cls_agree"]["headline vs int8"] = _run_cls_agree(
        f"googlenet (a=headline, b=int8 at {pats}, {len(sites)} sites)",
        args, f"op_tune={TUNES['headline']}",
        _int8_spec(pats, scales_fn), 0.85)


# the hand kernels a zoo row launches and their plain versions: every
# distinct call of one row's forward is held against the plain version on
# the same inputs (B1 and B2 at mrd F32_MRD / BF16_MRD by the operands'
# dtype against the f32 plain result, as the kernels phase holds them; B6
# and its activation quantize bit-equal)
HELD = ("matmul_ext", "tconv", "qconv", "act_quantize")


@contextlib.contextmanager
def _recording(wrappers: dict):
    """For the block, every module of boda_tpu_torch that holds one of the
    HELD wrappers holds instead a stand-in that calls it, counts the call
    and keeps copies of the arguments and the result of its first call at
    each distinct key (the tensors' shapes and dtypes, the other
    arguments' values). Yields ({key: (name, args, kwargs, result)},
    {name: calls})."""
    import torch
    seen, calls = {}, dict.fromkeys(HELD, 0)

    def sig(v):
        return (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) \
            else repr(v)

    def keep(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        return tuple(keep(u) for u in v) if isinstance(v, tuple) else v

    def stand_in(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            calls[name] += 1
            key = (name, *map(sig, a), *((kk, sig(v))
                                         for kk, v in sorted(k.items())))
            if key not in seen:
                seen[key] = (name, keep(a),
                             {kk: keep(v) for kk, v in k.items()}, keep(out))
            return out
        # the wrapper's body counts its launch on the name in its module,
        # which is the stand-in's for the block
        call.launches = fn.launches
        return call
    swaps, proxies = [], {}
    for name in HELD:
        fn = wrappers[name]
        proxy = proxies[name] = stand_in(name, fn)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("boda_tpu_torch"):
                for attr, v in list(vars(mod).items()):
                    if v is fn:
                        swaps.append((mod, attr, fn))
                        setattr(mod, attr, proxy)
    try:
        yield seen, calls
    finally:
        for mod, attr, fn in swaps:
            setattr(mod, attr, fn)
        for name, proxy in proxies.items():
            wrappers[name].launches = proxy.launches


def _hold_row(label: str, eng, per: dict, wrappers: dict, x=None) -> dict:
    """One more forward of a row's engine with its hand-kernel calls
    recorded (every launch must pass through the stand-ins: their calls
    equal the launches per forward), then each distinct call held against
    its plain version; returns what was held. x is the forward's input on
    the card in the form the engine is fed (a u8 wire batch where the
    engine preprocesses its input); by default a seeded f32 batch of the
    net's input dims."""
    import inspect

    import torch
    from boda_tpu_torch.ops.cuda.qconv import act_quantize_plain, \
        qconv_plain
    from boda_tpu_torch.ops.cuda.sgemm import matmul_ext_plain
    from boda_tpu_torch.ops.cuda.tconv import tconv_plain
    plains = {"matmul_ext": matmul_ext_plain, "tconv": tconv_plain,
              "qconv": qconv_plain, "act_quantize": act_quantize_plain}
    data = eng.pipe.data_img_node_names[0]
    if x is None:
        gen = torch.Generator(device=eng.dev).manual_seed(2)
        x = torch.randn(tuple(eng.pipe.get_data_img_dims().shape),
                        device=eng.dev, generator=gen) * 0.1
    t0 = time.perf_counter()
    with torch.inference_mode(), _recording(wrappers) as (seen, calls):
        eng.fwd({data: x}, eng.weights)
        torch.cuda.synchronize()
    check(calls == {k: per[k] for k in HELD},
          f"{label}: the recorded calls {calls} are not the launches per "
          f"forward {per}")
    held = {"distinct": dict.fromkeys(HELD, 0), "max_mrd": 0.0}
    with torch.inference_mode():
        for name, a, k, got in seen.values():
            plain = plains[name]
            held["distinct"][name] += 1
            if name in ("qconv", "act_quantize"):
                want = plain(*a, **k)
                pairs = zip(got, want) if isinstance(got, tuple) \
                    else [(got, want)]
                check(all(bit_equal(g, w) for g, w in pairs),
                      f"{label}: {name} differs from its plain version at "
                      f"{[tuple(t.shape) for t in a if hasattr(t, 'shape')]}")
                continue
            ba = inspect.signature(plain).bind(*a, **k)
            ba.arguments["out_dtype"] = torch.float32
            err = mrd(got, plain(*ba.args, **ba.kwargs))
            toler = F32_MRD if a[0].dtype == torch.float32 else BF16_MRD
            check(err <= toler, f"{label}: {name} at "
                                f"{[tuple(t.shape) for t in a[:2]]} mrd "
                                f"{err:.3e} > {toler:g}")
            held["max_mrd"] = max(held["max_mrd"], err)
    torch.cuda.synchronize()
    held["s"] = time.perf_counter() - t0
    print(f"  {label}: every hand-kernel call of one forward recorded "
          f"({calls}); distinct calls held against the plain versions "
          f"{held['distinct']} (B1/B2 max mrd {held['max_mrd']:.3e}, B6 "
          f"and quantize bit-equal; {held['s']:.1f} s)")
    del seen
    torch.cuda.empty_cache()
    return held


def _zoo_rows(z: dict, launches: dict, wrappers: dict) -> None:
    """The cnet_bench rows at b128 through the CLI (mode cnet_bench, zoo
    weights, the bench's seeded input on the card): ms per forward, imgs/s,
    TF/s and share of the bf16 peak; the hand kernels' launches per
    forward, exactly as the plan's steps say; every distinct hand-kernel
    call of one more forward held against its plain version (_hold_row);
    the card's busy share of one GoogLeNet and one AlexNet forward under
    the headline tune, and AlexNet's LRN share."""
    import torch
    rows = z.setdefault("cnet_bench", [])
    for model, tune_name in ZOO_ROWS:
        pats, scales_fn = ZOO_INT8[model]
        if tune_name == INT8:
            if scales_fn is None:
                scales_fn = ZOO_OUT / f"{model}-b128-int8-scales.lexp"
                _calibrate(model, pats, scales_fn)
            spec = _int8_spec(pats, scales_fn)
        else:
            spec = f"op_tune={TUNES[tune_name]}"
        _counts_reset(wrappers)
        out, hm = _run_mode(f"(mode=cnet_bench,model={model},batch=128,"
                            f"iters={ZOO_BENCH_ITERS},reps=3,{spec})")
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        per = {k: v // hm.forwards for k, v in counts.items()}
        planned = _planned_launches(hm.eng.plan, counts)
        line = out.strip().splitlines()[-1]
        print(f"{line}; launches per forward {per} on [{z['smi']}]")
        check(line.startswith(f"cnet_bench {model} b128 "),
              f"cnet_bench {model}: {line}")
        check(all(counts[k] == planned[k] * hm.forwards for k in counts),
              f"cnet_bench {model} {tune_name}: launches {counts} over "
              f"{hm.forwards} forwards != the plan's {planned} each")
        check(tune_name != INT8 or per["qconv"] > 0,
              f"cnet_bench {model} int8: no qconv launch")
        stats = dict(re.findall(r"(\w+)=(\S+)", line))
        frac = float(stats["frac_roofline"])
        check(hm.step_ms > 0 and frac > 0, f"cnet_bench {model}: {line}")
        launches[f"zoo_cnet_bench:{model}:{tune_name}"] = per
        row = {"model": model, "tune": tune_name, "batch": 128,
               "step_ms": hm.step_ms, "imgs_per_sec": 128 / hm.step_ms * 1e3,
               "tflops": hm.tflops, "frac_bf16_peak": frac,
               "launches_per_forward": per}
        if model == "alexnet_ng_conv":
            # both tunes store bf16 NHWC: the headline tune's LRN times
            lrn = sum(z["lrn_ms"]["headline"].values())
            row["lrn_share"] = lrn / hm.step_ms
            print(f"  alexnet_ng_conv b128 {tune_name}: norm1 + norm2 "
                  f"alone {lrn:.3f} ms, {100 * lrn / hm.step_ms:.1f}% of "
                  f"the forward")
        rows.append(row)
        if any(per[k] for k in HELD):
            row["held"] = _hold_row(f"cnet_bench {model} {tune_name}",
                                    hm.eng, per, wrappers)
        if tune_name == "headline" and model in ("googlenet_conv",
                                                 "alexnet_ng_conv"):
            eng = hm.eng
            data = eng.pipe.data_img_node_names[0]
            gen = torch.Generator(device=eng.dev).manual_seed(1)
            x = torch.randn(tuple(eng.pipe.get_data_img_dims().shape),
                            device=eng.dev, generator=gen)
            top = eng.plan.output_nodes[-1]
            with torch.inference_mode():
                busy, top_k = _device_busy_ms(
                    lambda: eng.fwd({data: x}, eng.weights)[top])
            print(f"  {model} b128 headline: device busy {busy:.3f} "
                  f"ms of the forward's {hm.step_ms:.3f} ms "
                  f"({100 * (1 - busy / hm.step_ms):.1f}% idle); most of "
                  f"it: " + "; ".join(f"{k} x{n} {t:.3f} ms"
                                      for k, n, t in top_k))
            row["busy_ms"], row["idle_share"] = busy, 1 - busy / hm.step_ms
            row["top_kernels"] = [{"kernel": k, "calls": n, "ms": t}
                                  for k, n, t in top_k]
        del hm
        torch.cuda.empty_cache()


def phase_zoo(ctx: dict) -> None:
    """The rest of the zoo on the card: the zoo's templates at zoo shapes,
    B6 at GoogLeNet's int8 shapes, test_compute_multi on three nets, the
    trained GoogLeNet's cls_agree and the cnet_bench rows."""
    import torch
    from boda_tpu_torch.core.machine import card_peaks
    ZOO_OUT.mkdir(parents=True, exist_ok=True)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    z = ctx["zoo"] = {"smi": ctx["smi"]}
    launches = ctx.setdefault("launches", {})
    wrappers = _wrappers()
    t0 = time.perf_counter()
    with torch.inference_mode():
        _zoo_lrn(z, dev, gen, peaks)
        _zoo_copy(z, dev, gen, peaks)
        _zoo_deconv(z, dev, gen, peaks)
        _zoo_small_templates(z, dev, gen, peaks)
    _zoo_bwai_rates(z, peaks)
    torch.cuda.empty_cache()
    _zoo_qconv(z, dev, gen, peaks)
    z["templates_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    _zoo_compute_multi(z, launches, wrappers)
    _zoo_cls_agree(z)
    _zoo_rows(z, launches, wrappers)
    del z["smi"]


# ---------------------------------------------------------------- serve

# the serve phase's serve_bench rows: (tune, wire format, clients); the
# server's max_batch is the client count, so each engine batch is that size
SERVE_ROWS = [("f32", "u8", 8), ("f32", "u8", 32),
              ("headline", "u8", 8), ("headline", "u8", 32),
              ("headline", "u8", 64),
              (INT8, "u8", 8), (INT8, "u8", 32),
              ("f32", "f32", 8)]
SERVE_N1, SERVE_N2, SERVE_TOP_K = 2, 8, 5
# a reply's probabilities against a direct run_fwd of its image
SERVE_PROB_TOL = {"f32": 1e-5, "headline": 5e-3, INT8: 5e-3}
# the u8 and f32 wires under () (the same floats reach the forward), and
# device_preproc_fn on the card against the CPU at a resize
WIRE_TOL, PREPROC_TOL = 1e-6, 1e-3


def _optional(mod: str) -> bool:
    """Whether `mod` imports on this machine."""
    try:
        __import__(mod)
    except ImportError:
        return False
    return True


def _serve_spec(tune_name: str, wire: str, k: int) -> str:
    """serve_bench on ResNet-50 224² (zoo weights; the int8 preset on the
    trained 40-class snapshot with its calibrated scales)."""
    extra = ""
    weights = "zoo"
    if tune_name == INT8:
        weights = "trained"
        extra = f",model_opts=(num_classes=40),weights_fn={TRAINED}"
    return (f"(mode=serve_bench,model=resnet-50,num_clients={k},"
            f"n1={SERVE_N1},n2={SERVE_N2},top_k={SERVE_TOP_K},"
            f"batch_window_ms=20,wire_fmt={wire}{extra},"
            f"engine=(engine=torch,{engine_spec(tune_name, weights)}))")


def _direct_rows(srv, img, top_k: int):
    """img's top-k (class, prob) from the server's engine itself: one
    run_fwd of img in slot 0 of a zero-padded batch of the server's size."""
    import numpy as np
    from boda_tpu_torch.core.dims import NDA
    x = np.zeros(srv._in_dims.shape, srv._in_dims.dtype)
    x[0] = img
    top = srv.pipe.get_single_top_node().name
    p = srv.conv_fwd.run_fwd({srv.pipe.data_img_node_names[0]:
                              NDA(srv._in_dims, x)}, [top])[top].v
    p = p.reshape(p.shape[0], -1)[0]
    ix = np.argsort(-p)[:top_k]
    return ix, p[ix]


def _engine_split(srv) -> dict:
    """Where a b<max_batch> engine call's time goes, on the server's engine
    and a u8 or f32 wire batch: run_fwd's wall ms (upload, forward,
    readback), the upload alone (wall; run_fwd's own upload path, on a
    card the engine's PinnedStager), the forward alone on a batch already
    on the card (CUDA events) and the card's busy ms in one
    run_fwd (torch.profiler)."""
    import numpy as np
    import torch
    from boda_tpu_torch.core.dims import NDA
    eng, d = srv.conv_fwd, srv._in_dims
    x = np.random.RandomState(0).randint(0, 256, d.shape).astype(d.dtype)
    data = srv.pipe.data_img_node_names[0]
    top = srv.pipe.get_single_top_node().name

    def run():
        return eng.run_fwd({data: NDA(d, x)}, [top])

    def upload():
        eng.upload({data: NDA(d, x)})
        torch.cuda.synchronize()
    xd = torch.from_numpy(x).to(eng.dev)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: eng.fwd({data: xd}, eng.weights)[top], 10)
        busy, _ = _device_busy_ms(run)
    return {"run_fwd_ms": _wall_ms(run), "upload_ms": _wall_ms(upload),
            "forward_ms": fwd_ms, "busy_ms": busy}


def _serve_row(s: dict, wrappers: dict, tune_name: str, wire: str,
               k: int) -> dict:
    """One serve_bench row: its record, the hand kernels' launches per
    engine batch (exact, as the plan says), every client's last reply
    against a direct run_fwd of its image under the same engine, and every
    distinct hand-kernel call of one more engine batch (the clients'
    images on the row's wire) held against its plain version."""
    import numpy as np
    import torch
    _counts_reset(wrappers)
    out, hm = _run_mode(_serve_spec(tune_name, wire, k))
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in wrappers.items()}
    srv = hm.srv
    batches = len(srv._batch_sizes)
    want = LAUNCHES[tune_name]
    per = {n: c // batches for n, c in counts.items()}
    check(all(counts[n] == want[n] * batches for n in counts),
          f"serve {tune_name} {wire} {k}: launches {counts} over {batches} "
          f"batches != {want} each")
    planned = _planned_launches(srv.conv_fwd.plan, counts)
    check(planned == want, f"serve {tune_name}: the plan's launches "
                           f"{planned} != {want}")
    rec = hm.record
    check(rec["req_per_sec"] > 0 and rec["engine_ms_per_batch"] > 0,
          f"serve {tune_name} {wire} {k}: {rec}")
    # each reply against a direct forward of its image (distinct images
    # once: clients from the third on send the second's pattern)
    direct: dict = {}
    tol = SERVE_PROB_TOL[tune_name]
    max_err = 0.0
    for i, (img, (bsz, rows)) in enumerate(zip(hm.imgs, hm.replies)):
        key = img.tobytes()
        if key not in direct:
            direct[key] = _direct_rows(srv, img, SERVE_TOP_K)
        ix, p = direct[key]
        check(rows.shape == (SERVE_TOP_K, 2)
              and np.array_equal(rows[:, 0], ix.astype(np.float32)),
              f"serve {tune_name} {wire} {k}: client {i}'s classes "
              f"{rows[:, 0]} != the direct forward's {ix}")
        err = float(np.abs(rows[:, 1] - p).max())
        check(err <= tol, f"serve {tune_name} {wire} {k}: client {i}'s "
                          f"probabilities differ by {err:.3e} > {tol:g}")
        max_err = max(max_err, err)
    row = {"tune": tune_name, "wire": wire, "clients": k, **rec,
           "launches_per_batch": per,
           "max_batch_seen": max(srv._batch_sizes),
           "replies_max_abs_err": max_err,
           "replies": [r[1].tolist() for r in hm.replies]}
    if any(per[n] for n in HELD):
        d = srv._in_dims
        x = np.zeros(d.shape, d.dtype)
        x[:len(hm.imgs)] = np.stack(hm.imgs)
        row["held"] = _hold_row(f"serve {tune_name} {wire} b{k}",
                                srv.conv_fwd, per, wrappers,
                                torch.from_numpy(x).to(srv.conv_fwd.dev))
    if k == 32 or (wire == "f32" and k == 8):
        row["engine_split"] = _engine_split(srv)
    print(f"  serve_bench resnet-50 {tune_name} {wire} {k} clients: "
          f"{rec['req_per_sec']:.1f} req/s, {rec['secs_per_req'] * 1e3:.3f} "
          f"ms/req, queue {rec['queue_ms_per_req']:.3f} ms/req, engine "
          f"{rec['engine_ms_per_batch']:.3f} ms/batch, mean batch "
          f"{rec['mean_batch']:.2f} (p2 {rec['p2_batch']:.2f}); launches per "
          f"batch {({n: v for n, v in per.items() if v})}; replies = direct "
          f"forwards "
          f"(max abs err {max_err:.2e})"
          + (f"; one b{k} engine call: run_fwd "
             f"{row['engine_split']['run_fwd_ms']:.3f} ms, upload "
             f"{row['engine_split']['upload_ms']:.3f}, forward "
             f"{row['engine_split']['forward_ms']:.3f}, busy "
             f"{row['engine_split']['busy_ms']:.3f}"
             if "engine_split" in row else "") + f" [{s['smi']}]",
          flush=True)
    del hm, srv
    torch.cuda.empty_cache()
    return row


def _serve_preproc(s: dict) -> None:
    """device_preproc_fn on the card: at the net's size equal to the host
    img_to_chw; at a resize down and up within PREPROC_TOL of the CPU."""
    import numpy as np
    import torch
    from boda_tpu_torch.io.device_preproc import device_preproc_fn
    from boda_tpu_torch.io.img import img_to_chw, make_test_pattern_img
    dev = torch.device("cuda", 0)
    img = make_test_pattern_img(224, 224, 2)
    got = device_preproc_fn(224, 224)(torch.from_numpy(img[None]).to(dev))
    err = float(np.abs(got.cpu().numpy()[0] - img_to_chw(img)).max())
    check(err <= WIRE_TOL, f"u8 preproc at 224²: {err:.3e} from img_to_chw")
    errs = {"same_size_vs_img_to_chw": err}
    rng = np.random.RandomState(4)
    for name, (h, w) in (("down_300x400", (300, 400)),
                         ("up_100x150", (100, 150))):
        x = rng.randint(0, 256, (8, h, w, 3)).astype(np.uint8)
        f = device_preproc_fn(224, 224)
        a = f(torch.from_numpy(x).to(dev)).cpu().numpy()
        b = f(torch.from_numpy(x)).numpy()
        e = float(np.abs(a - b).max())
        check(e <= PREPROC_TOL, f"device_preproc_fn {name}: card vs CPU "
                                f"{e:.3e} > {PREPROC_TOL:g}")
        errs[name] = e
    # the prefetcher: batches copied from pinned buffers on a side stream,
    # preprocessed on the card, each in order and equal to the CPU's
    from boda_tpu_torch.io.device_preproc import PrefetchFeeder
    src = [rng.randint(0, 256, (8, 300, 400, 3)).astype(np.uint8)
           for _ in range(5)]
    fed = list(PrefetchFeeder(iter(src), 224, 224))
    f = device_preproc_fn(224, 224)
    e = max(float(np.abs(g.cpu().numpy() - f(torch.from_numpy(x)).numpy())
                  .max()) for g, x in zip(fed, src))
    check(len(fed) == len(src) and all(g.is_cuda for g in fed)
          and e <= PREPROC_TOL,
          f"PrefetchFeeder: {len(fed)} of {len(src)} batches, max abs err "
          f"{e:.3e} against the CPU")
    errs["prefetch_feeder"] = e
    s["preproc_max_abs_err"] = errs
    print(f"  device_preproc_fn and PrefetchFeeder (5 batches) on the card: "
          f"{errs} (limits {WIRE_TOL:g} same size, {PREPROC_TOL:g} at a "
          f"resize)")


def _serve_zmq(s: dict) -> None:
    """zmq_cls_server on ResNet-50 224² with a client sending an encoded
    test image (needs pyzmq and PIL): its top-5 against a direct forward."""
    import threading

    import numpy as np
    from boda_tpu_torch.apps.zmq_serve import ZmqClsServer
    from boda_tpu_torch.io.img import img_to_batch, load_img, \
        make_test_pattern_img, save_img
    out_dir = ROOT / "build" / "serve_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    img_fn = out_dir / "in.png"
    save_img(img_fn, make_test_pattern_img(300, 260, 2))
    ep = f"ipc://{out_dir}/zmq_cls"
    srv = ZmqClsServer.init_from_lexp(
        f"(endpoint={ep},num_req=1,model=resnet-50,in_sz=224,top_k=5)")
    th = threading.Thread(target=srv.main)
    th.start()
    out, _ = _run_mode(f"(mode=zmq_det_client,endpoint={ep},"
                       f"image_fn={img_fn})")
    th.join(120)
    check(not th.is_alive(), "zmq_cls_server did not finish")
    rows = [[float(t.split("=")[1]) for t in ln.split()[1:]]
            for ln in out.splitlines() if ln.startswith("box:")]
    d = srv.pipe.get_data_img_dims()
    p = srv.eng.run_fwd({"data": img_to_batch(load_img(img_fn), d)},
                        ["prob"])["prob"].v.reshape(-1)
    ix = np.argsort(-p)[:5]
    check(len(rows) == 5 and [int(r[0]) for r in rows] == ix.tolist(),
          f"zmq_cls_server: {rows} != the direct top-5 {ix}")
    s["zmq_cls_server_top5"] = [int(r[0]) for r in rows]
    print(f"  zmq_cls_server resnet-50: top-5 {s['zmq_cls_server_top5']} = "
          f"the direct forward's")


def phase_serve(ctx: dict) -> None:
    """The serving path on ResNet-50 224², 1000 classes, zoo weights from a
    seed: aio_cls_selfcheck (coalescing), serve_bench rows under (), the
    headline tune and the int8 preset on the u8 wire (preprocessing on the
    card) and one on the f32 wire, each reply held to a direct forward,
    the hand kernels' launches per engine batch exact and each distinct
    hand-kernel call held against its plain version; the u8 wire against
    the f32 wire; device_preproc_fn on the card against the CPU."""
    import numpy as np
    import torch
    wrappers = _wrappers()
    s = ctx["serve"] = {"smi": ctx["smi"]}
    launches = ctx.setdefault("launches", {})
    t0 = time.perf_counter()
    _counts_reset(wrappers)
    out, hm = _run_mode("(mode=aio_cls_selfcheck,model=resnet-50,"
                        "num_clients=3)")
    torch.cuda.synchronize()
    check(hm._max_batch_seen == 3, f"aio_cls_selfcheck: {out}")
    counts = {n: w.launches for n, w in wrappers.items()}
    check(counts == {n: UNFUSED_LAUNCHES[n] for n in counts},
          f"aio_cls_selfcheck: launches {counts} != one () forward's")
    s["selfcheck_max_batch_seen"] = hm._max_batch_seen
    print(f"  {out.strip().splitlines()[-1]}; launches {counts}")
    del hm
    _serve_preproc(s)
    rows = s["rows"] = []
    for tune_name, wire, k in SERVE_ROWS:
        rows.append(_serve_row(s, wrappers, tune_name, wire, k))
        launches[f"serve:{tune_name}:{wire}:{k}"] = rows[-1][
            "launches_per_batch"]
    # the u8 wire's replies equal the f32 wire's under ()
    u8 = next(r for r in rows if r["tune"] == "f32" and r["wire"] == "u8"
              and r["clients"] == 8)
    f32 = next(r for r in rows if r["tune"] == "f32" and r["wire"] == "f32")
    err = float(np.abs(np.array(u8["replies"]) - np.array(f32["replies"]))
                .max())
    check(err <= WIRE_TOL, f"u8 and f32 wires differ by {err:.3e}")
    s["u8_vs_f32_max_abs_err"] = err
    print(f"  u8 wire replies = f32 wire replies under () (max abs err "
          f"{err:.2e})")
    for r in rows:
        del r["replies"]
    if _optional("zmq") and _optional("PIL"):
        _serve_zmq(s)
    else:
        print("  zmq modes not run here: pyzmq or PIL does not import on "
              "this machine (tests/test_torch_zmq.py runs them on the CPU)")
        s["zmq"] = "not run: pyzmq or PIL missing"
    s["s"] = time.perf_counter() - t0
    del s["smi"]


# ---------------------------------------------------------------- pyra

PYRA_FRAME = "in_dims=(dims=(img=1,chan=3,y=480,x=640)),bin_sz=640 640," \
             "interval=3,min_sz=32"
PYRA_ITERS = 10
# dense prediction on a small frame, card against CPU: the trained
# GoogLeNet at 320² with its inception_4e features as the predicted map
DENSE_SPEC = ("(mode=cnet_predict,model=googlenet_conv,dense=1,"
              "out_node=inception_4e/output,model_opts=(num_classes=40,"
              "ysz=320,xsz=320),weights_fn=" + str(DATA /
                                                   "googlenet-shapes40.boda"))
DENSE_TOL = 1e-4


def _annos_key(annos):
    return [(tuple(int(v) for v in a.box),
             [ln.split()[0] for ln in a.str.splitlines()]) for a in annos]


def _pyra_row(p: dict, wrappers: dict, tune_name: str, pack: str) -> dict:
    """One pyra_bench row: its record, the hand kernels' launches per
    forward (exact, as the plan says) and, where it launches any, every
    distinct hand-kernel call of one more forward of the packed
    test-pattern frame held against its plain version."""
    import torch
    _counts_reset(wrappers)
    out, hm = _run_mode(f"(mode=pyra_bench,model=googlenet_conv,{PYRA_FRAME},"
                        f"pack={pack},iters={PYRA_ITERS},reps=3,"
                        f"op_tune={TUNES[tune_name]})")
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in wrappers.items()}
    planned = _planned_launches(hm.eng.plan, counts)
    check(all(counts[n] == planned[n] * hm.forwards for n in counts),
          f"pyra_bench {tune_name}: launches {counts} over {hm.forwards} "
          f"forwards != the plan's {planned} each")
    per = {n: v for n, v in planned.items() if v}
    check(tune_name != "f32" or (planned["matmul_ext"] > 0
                                 and planned["tconv"] > 0),
          f"pyra_bench (): no B1 or B2 launch ({per})")
    line = out.strip().splitlines()[-1]
    check(line.startswith("pyra_bench googlenet_conv in=480x640 "),
          f"pyra_bench: {line}")
    print(f"  {line}; launches per forward {per} [{p['smi']}]", flush=True)
    row = {"tune": tune_name, "pack": pack, **hm.record,
           "launches_per_forward": planned}
    if any(planned[n] for n in HELD):
        row["held"] = _hold_row(f"pyra_bench {tune_name} pack={pack}",
                                hm.eng, planned, wrappers,
                                _pyra_input(hm.pp, pack, hm.eng.dev))
    if pack == "device" and tune_name == "headline":
        _pyra_pack_on_card(p, hm.pp)
    del hm
    torch.cuda.empty_cache()
    return row


def _pyra_input(pp, pack: str, dev):
    """pyra_bench's forward input on the card: the 480x640 test-pattern
    frame packed into pp's bins, on the card (pack=device) or on the host
    through PIL (pack=host), as the mode packs it."""
    import numpy as np
    import torch
    from boda_tpu_torch.io.img import img_to_chw, make_test_pattern_img
    img = make_test_pattern_img(480, 640, 2)
    if pack == "device":
        from boda_tpu_torch.io.device_preproc import make_device_pyra_pack
        frame = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        return make_device_pyra_pack(pp)(frame.to(dev))
    packed = pp.scale_and_pack_img_into_bins(img)
    return torch.from_numpy(np.stack([img_to_chw(packed[b]) for b in range(
        pp.num_bins)]).astype(np.float32)).to(dev)


def _pyra_pack_on_card(p: dict, pp) -> None:
    """The device pyramid pack of the test-pattern frame on the card
    against the same pack on the CPU."""
    import numpy as np
    a = _pyra_input(pp, "device", "cuda").cpu().numpy()
    b = _pyra_input(pp, "device", "cpu").numpy()
    err = float(np.abs(a - b).max())
    check(err <= PREPROC_TOL, f"pyramid pack: card vs CPU {err:.3e}")
    p["pack_max_abs_err"] = err
    print(f"  pyramid pack ({pp.num_bins} bins, {len(pp.scales)} scales) on "
          f"the card = on the CPU (max abs err {err:.2e})")


def _pyra_dense(p: dict) -> None:
    """cnet_predict dense=1 on the card and with device=cpu: the same
    boxes and labels, confidences within DENSE_TOL."""
    res = {}
    for dev in ("cuda", "cpu"):
        _, hm = _run_mode(f"{DENSE_SPEC},conv_fwd=(engine=torch,"
                          f"device={dev}))")
        res[dev] = hm.annos
    check(res["cuda"] and _annos_key(res["cuda"]) == _annos_key(res["cpu"]),
          f"cnet_predict dense=1: {_annos_key(res['cuda'])} != "
          f"{_annos_key(res['cpu'])}")
    err = max(abs(a.top_prob - b.top_prob)
              for a, b in zip(res["cuda"], res["cpu"]))
    check(err <= DENSE_TOL, f"cnet_predict dense=1: confidences {err:.3e}")
    p["dense"] = {"annos": _annos_key(res["cuda"]), "max_abs_err": err}
    print(f"  cnet_predict dense=1 (trained GoogLeNet 320², "
          f"inception_4e/output): {len(res['cuda'])} anno(s) "
          f"{_annos_key(res['cuda'])}, card = CPU (confidences within "
          f"{err:.2e})")


def _pyra_conv_pyra(p: dict) -> None:
    """conv_pyra predict=1 (host pack through PIL) on a small frame, on the
    card and with device=cpu: the same annotations and feature digests."""
    from boda_tpu_torch.testing.comp import read_digest_stream
    out_dir = ROOT / "build" / "pyra_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for dev in ("cuda", "cpu"):
        _, hm = _run_mode(
            f"(mode=conv_pyra,model=googlenet_conv,in_dims=(dims=(img=1,"
            f"chan=3,y=128,x=128)),out_node=inception_3a/output,"
            f"bin_sz=256 256,interval=2,min_sz=48,predict=1,"
            f"filt_show_thresh=0.05,boda_output_dir={out_dir},"
            f"digest_fn={dev}.boda,conv_fwd=(engine=torch,device={dev},"
            f"keep_all_nodes=1))")
        res[dev] = (hm.annos, read_digest_stream(out_dir / f"{dev}.boda"))
    check(_annos_key(res["cuda"][0]) == _annos_key(res["cpu"][0]),
          "conv_pyra predict=1: the card's annotations != the CPU's")
    dg, dc = res["cuda"][1], res["cpu"][1]
    bad = [k for k in dg if k not in dc or dg[k].comp(dc[k], DENSE_TOL)]
    check(sorted(dg) == sorted(dc) and not bad,
          f"conv_pyra feature digests differ: {bad}")
    p["conv_pyra"] = {"annos": len(res["cuda"][0]), "scales": len(dg)}
    print(f"  conv_pyra predict=1 (host pack): {len(res['cuda'][0])} "
          f"anno(s), {len(dg)} scale digests, card = CPU")


def phase_pyra(ctx: dict) -> None:
    """Dense inference: pyra_bench on googlenet_conv, a 480x640 frame in
    640² bins, pack=device under the headline tune and (), B1/B2 launches
    per forward exact and each distinct call held against its plain
    version; the device pack on the card against the CPU;
    cnet_predict dense=1 on the card against the CPU; with PIL, also
    pyra_bench pack=host and conv_pyra predict=1."""
    wrappers = _wrappers()
    p = ctx["pyra"] = {"smi": ctx["smi"]}
    launches = ctx.setdefault("launches", {})
    t0 = time.perf_counter()
    rows = p["rows"] = []
    runs = [("headline", "device"), ("f32", "device")]
    if _optional("PIL"):
        runs.append(("headline", "host"))
    for tune_name, pack in runs:
        rows.append(_pyra_row(p, wrappers, tune_name, pack))
        launches[f"pyra:{tune_name}:{pack}"] = rows[-1]["launches_per_forward"]
    _pyra_dense(p)
    if _optional("PIL"):
        _pyra_conv_pyra(p)
    else:
        print("  pack=host and conv_pyra not run here: PIL does not import "
              "on this machine (tests/test_torch_dense.py runs them on the "
              "CPU)")
        p["host_pack"] = "not run: PIL missing"
    p["s"] = time.perf_counter() - t0
    del p["smi"]


# ---------------------------------------------------------------- train

TRAIN_OUT = ROOT / "build" / "train_smoke"
TRAIN_BATCH, TRAIN_HW = 32, 224
# the trained 40-class ResNet-50 and GoogLeNet on shapes-src data (the set
# they were trained on: 40 classes, mean 128, scale 1/64)
TRAIN_SRC = ("(mode=shapes-src,num_imgs={n},ysz={hw},xsz={hw},"
             "num_classes=40,seed=2,mean=128,scale=0.015625)")
TRAIN_NETS = {
    "resnet-50": f"model=resnet-50,model_opts=(num_classes=40),"
                 f"weights_fn={TRAINED}",
    # the trained GoogLeNet's weights on its LRN variant (the same blobs),
    # so that the steps cover the LRN backward beside concat and dropout
    "googlenet_conv_lrn": f"model=googlenet_conv_lrn,model_opts=(num_classes"
                          f"=40),weights_fn={DATA / 'googlenet-shapes40.boda'}"}
# step-1 weight gradients of the headline tune against the f32 tune's:
# tests/test_mxu_grad.py's whole-program bound 8e-2, on the whole gradient
# (relative L2), and every blob's direction (cosine). Its per-blob mrd
# bound holds on that test's mini net but not on ResNet-50, in the JAX
# package either: there its headline gradients are 0.56-0.60 max per-blob
# mrd off its f32 tune's, at relative L2 0.057-0.063 and per-blob cosine
# >= 0.990 (b2, b8, b32 on the CPU: scripts/resnet50_grad_agreement.py).
# Each bf16 cuDNN grad conv is held against its FP32 plain form at VJP_MRD.
TRAIN_GRAD_L2, TRAIN_GRAD_COS, VJP_MRD = 8e-2, 0.98, 5e-3
# the grad_q8 preset's step-1 gradients against the f32 tune's: the same
# cosine gate (the JAX package's least per-blob cosine there is 0.990, its
# sites' blobs 0.992-0.994), and a relative L2 gate over the JAX package's
# own 0.0675 (b8) and 0.0731 (b32) by about the margin TRAIN_GRAD_L2 has
# over 0.063 (scripts/resnet50_grad_agreement.py on the CPU)
TRAIN_Q8_L2 = 9e-2
TRAIN_STEPS = 3
# B6's wgrad at the preset's four site shapes at b32: (label, n, hw, I, O, k)
WGRAD_SHAPES = [("res3 3x3", 32, 28, 128, 128, 3),
                ("res4 3x3", 32, 14, 256, 256, 3),
                ("res5 3x3", 32, 7, 512, 512, 3),
                ("res5 1x1 2c", 32, 7, 512, 2048, 1)]
# and at two strided sites (not in the preset; one B6 conv per phase of
# the stride), held bit-equal only: (label, n, hw in, I, O, k, stride)
WGRAD_STRIDED = [("res3a_branch1 1x1/s2", 32, 56, 256, 512, 1, 2),
                 ("3x3/s2", 32, 28, 128, 128, 3, 2)]
TRAIN_BENCH_ITERS = 10


def _grad_q8_pats() -> str:
    """op_tunes_pat of tune/presets.RESNET_GRAD_Q8_SITE_PATS over the
    headline tune: the grad_q8 preset (resnet_grad_q8_site_tunes) as a CLI
    value."""
    from boda_tpu_torch.tune.presets import RESNET_GRAD_Q8_SITE_PATS
    q = TUNES["headline"][:-1] + ",grad_q8=1)"
    return "(" + ",".join(f"{p}={q}" for p in RESNET_GRAD_Q8_SITE_PATS) + ")"


def _train_pipe(model: str, batch: int):
    """The trained 40-class net of TRAIN_NETS as its mode would load it."""
    from boda_tpu_torch.apps.train import load_weights_into_pipe
    from boda_tpu_torch.models.zoo import build_model
    pipe = build_model(model, batch=batch, ysz=TRAIN_HW, xsz=TRAIN_HW,
                       num_classes=40)
    load_weights_into_pipe(pipe, re.search(r"weights_fn=(\S+)",
                                           TRAIN_NETS[model]).group(1))
    return pipe


def _train_batch(pipe, dev):
    """The first batch of TRAIN_SRC as (x f32, labels) on dev."""
    import numpy as np
    import torch
    from boda_tpu_torch.io.synth import render_shapes
    d = pipe.get_data_img_dims()
    imgs, labels = render_shapes(range(d["img"]), d["y"], d["x"], 40, 2)
    x = (imgs.astype(np.float32) - 128.0) * 0.015625
    return (torch.from_numpy(x).to(dev),
            torch.from_numpy(np.asarray(labels, np.int64)).to(dev))


@contextlib.contextmanager
def _vjp_recording():
    """For the block, MxuConv's backward calls (ops/mxu_grad.conv_backward)
    and its int8 weight gradients (ops/cuda/qconv.wgrad_q8) go through
    stand-ins that keep, in call order, copies of each call's arguments
    and results. Yields {"conv_backward": [...], "wgrad_q8": [...]} of
    (args, result)."""
    import torch
    from boda_tpu_torch.ops import mxu_grad
    from boda_tpu_torch.ops.cuda import qconv
    calls = {"conv_backward": [], "wgrad_q8": []}

    def keep(v):
        if isinstance(v, torch.Tensor):
            return v.detach().clone()
        return tuple(keep(u) for u in v) if isinstance(v, tuple) else v

    def stand_in(name, fn):
        def call(*a):
            out = fn(*a)
            calls[name].append((keep(a), keep(out)))
            return out
        return call
    swaps = [(mxu_grad, "conv_backward"), (qconv, "wgrad_q8")]
    orig = [getattr(m, n) for m, n in swaps]
    for (m, n), fn in zip(swaps, orig):
        setattr(m, n, stand_in(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(swaps, orig):
            setattr(m, n, fn)


def _step_grads(pipe, tune: str, op_tunes, xb, lb):
    """(loss, {weight: gradient}, plan) of one training batch under a tune
    (and per-op tunes), as cnet_train's first step computes them, under
    its cuDNN settings."""
    import torch
    from boda_tpu_torch.apps.train import batch_loss, deterministic_cudnn, \
        train_forward, train_top
    from boda_tpu_torch.engine.lower import lower_pipe
    from boda_tpu_torch.engine.torch_fwd import weights_to_torch
    from boda_tpu_torch.ops.cnn_variants import make_op_tune
    plan = lower_pipe(pipe, make_op_tune(tune), op_tunes=op_tunes,
                      fused_storage=True, train_dropout=False)
    dev = xb.device
    w = {k: v.requires_grad_(True)
         for k, v in weights_to_torch(plan, pipe.op_params, dev).items()}
    top, from_logits = train_top(pipe, plan)
    fwd = train_forward(plan, dev, top)
    names = sorted(w)
    with deterministic_cudnn():
        loss = batch_loss(fwd, pipe.data_img_node_names[0], top, from_logits,
                          w, xb, lb)
        g = torch.autograd.grad(loss, [w[k] for k in names])
    return float(loss.detach()), dict(zip(names, g)), plan


def _planned_wgrad(plan, n: int) -> tuple[int, int]:
    """The int8 weight gradients a training step of `plan` runs on B6, as
    (act_quantize launches, qconv launches), counted here from the plan
    alone: one quantize for each grad_q8 vendor step the JAX package takes
    it for (xla_conv in NHWC form, xla_conv2) whose N*OH*OW-term int32 sums
    cannot wrap, and one qconv for each phase of its stride that holds a
    filter tap."""
    sites = convs = 0
    for st in plan.steps:
        sig = st.sig
        if not sig.get_u32_or("grad_q8", 0) or sig.get_u32_or("quant8", 0):
            continue
        nhwc = sig.str_vals.get("io_layout") == "nhwc" \
            or sig.str_vals.get("layout") == "nhwc"
        if st.func_name == "xla_conv2" or (st.func_name == "xla_conv"
                                           and nhwc):
            od = sig.get_dims("out" if "out" in sig.nda_vals else "out_a")
            if n * od["y"] * od["x"] * 127 * 127 >= 2 ** 31:
                continue
            sd = sig.get_dims_or_none("stride")
            fds = [sig.get_dims(k) for k in sig.nda_vals
                   if k == "filts" or k.startswith("filts_")]
            sites += 1
            convs += min(sd["y"] if sd else 1, max(d["y"] for d in fds)) \
                * min(sd["x"] if sd else 1, max(d["x"] for d in fds))
    return sites, convs


def _grad_agreement(g, g_ref) -> tuple[float, dict]:
    """(relative L2 of the whole gradient g against g_ref, {blob: cosine})
    over the blobs both hold, in f64."""
    import torch
    common = sorted(set(g) & set(g_ref))
    cos = {k: float(torch.nn.functional.cosine_similarity(
        g[k].double().flatten(), g_ref[k].double().flatten(), dim=0))
        for k in common}
    d = torch.cat([g[k].double().flatten() for k in common])
    dr = torch.cat([g_ref[k].double().flatten() for k in common])
    return float((d - dr).norm() / dr.norm()), cos


def _train_grads(t: dict, dev) -> None:
    """(a) and (b) on one batch of the trained ResNet-50: the headline
    tune's step-1 weight gradients against the f32 tune's, each distinct
    bf16 grad conv against its plain form; under the grad_q8 preset, each
    distinct B6 wgrad call bit-equal to its plain version and the dx of
    every grad_q8 site bit-equal to the headline run's."""
    import torch
    from boda_tpu_torch.ops.cuda.qconv import wgrad_q8_plain
    from boda_tpu_torch.ops.mxu_grad import conv_backward_plain
    from boda_tpu_torch.tune.presets import resnet_grad_q8_site_tunes
    pipe = _train_pipe("resnet-50", TRAIN_BATCH)
    xb, lb = _train_batch(pipe, dev)
    t0 = time.perf_counter()
    with _vjp_recording() as rec_h:
        loss_h, g_h, _ = _step_grads(pipe, TUNES["headline"], None, xb, lb)
    loss_f, g_f, _ = _step_grads(pipe, "(use_culibs=1)", None, xb, lb)
    common = sorted(set(g_h) & set(g_f))
    errs = {k: mrd(g_h[k], g_f[k]) for k in common}
    worst = max(errs, key=errs.get)
    l2, cos = _grad_agreement(g_h, g_f)
    least = min(cos, key=cos.get)
    print(f"  step-1 loss headline {loss_h:.6f} f32 {loss_f:.6f}; weight "
          f"gradients of {len(common)} blobs against the f32 tune's: "
          f"relative L2 {l2:.3e} (gate {TRAIN_GRAD_L2:g}), least cosine "
          f"{cos[least]:.5f} ({least}; gate {TRAIN_GRAD_COS:g}), max mrd "
          f"{errs[worst]:.3e} ({worst}), median "
          f"{sorted(errs.values())[len(errs) // 2]:.3e}")
    check(len(common) == len(g_h) and l2 <= TRAIN_GRAD_L2
          and cos[least] >= TRAIN_GRAD_COS,
          f"train: headline gradients off the f32 tune's: relative L2 "
          f"{l2:.3e}, cosine {cos[least]:.5f} at {least}")
    check(abs(loss_h - loss_f) < 0.05 * max(abs(loss_f), 1.0),
          f"train: step-1 loss {loss_h} against the f32 tune's {loss_f}")
    seen, vjp_worst = {}, 0.0
    for a, out in rec_h["conv_backward"]:
        gc, xc, wc, stride, pad, transposed, mask = a
        key = (tuple(gc.shape), tuple(xc.shape), tuple(wc.shape), stride,
               pad, transposed, mask)
        if key in seen:
            continue
        want = conv_backward_plain(*a)
        e = max(mrd(o, w_) for o, w_ in zip(out, want) if o is not None)
        seen[key] = e
        vjp_worst = max(vjp_worst, e)
    print(f"  headline backward: {len(rec_h['conv_backward'])} grad-conv "
          f"calls, {len(seen)} distinct, each held against its FP32 plain "
          f"form: max mrd {vjp_worst:.3e} (gate {VJP_MRD:g})")
    check(vjp_worst <= VJP_MRD, f"train: a bf16 cuDNN grad conv is "
                                f"{vjp_worst:.3e} off its plain form")
    t["grads"] = {"loss_headline": loss_h, "loss_f32": loss_f,
                  "grad_rel_l2": l2, "grad_min_cos": cos[least],
                  "grad_max_mrd": errs[worst], "grad_worst": worst,
                  "vjp_calls": len(rec_h["conv_backward"]),
                  "vjp_distinct": len(seen), "vjp_max_mrd": vjp_worst}
    # (b): the grad_q8 preset on the same batch
    wrappers = _wrappers()
    _counts_reset(wrappers)
    q8_tunes = resnet_grad_q8_site_tunes(pipe, TUNES["headline"])
    with _vjp_recording() as rec_q:
        loss_q, g_q, plan_q = _step_grads(pipe, TUNES["headline"], q8_tunes,
                                          xb, lb)
        torch.cuda.synchronize()
    planned, planned_convs = _planned_wgrad(plan_q, TRAIN_BATCH)
    got = (wrappers["qconv"].launches, wrappers["act_quantize"].launches,
           wrappers["cotangent_quantize"].launches)
    check(planned > 0 and got == (planned_convs, planned, planned)
          and len(rec_q["wgrad_q8"]) == planned,
          f"train: grad_q8 step launched B6 / act_quantize / "
          f"cotangent_quantize {got}, recorded "
          f"{len(rec_q['wgrad_q8'])} wgrad calls; the plan has "
          f"{planned_convs} / {planned}")
    held, wgrad_abs = {}, 0.0
    for a, out in rec_q["wgrad_q8"]:
        key = tuple(tuple(v.shape) if isinstance(v, torch.Tensor) else v
                    for v in a)
        if key not in held:
            want = wgrad_q8_plain(*a)
            held[key] = bit_equal(out, want)
            wgrad_abs = max(wgrad_abs, float((out - want).abs().max()))
    check(all(held.values()), f"train: a B6 wgrad call differs from "
                              f"wgrad_q8_plain at {held}")
    q8_sites = [i for i, (a, _) in enumerate(rec_q["conv_backward"])
                if not a[6][1]]
    check(len(rec_q["conv_backward"]) == len(rec_h["conv_backward"])
          and len(q8_sites) == planned
          and all(bit_equal(rec_q["conv_backward"][i][1][0],
                            rec_h["conv_backward"][i][1][0])
                  for i in q8_sites if rec_h["conv_backward"][i][1][0]
                  is not None),
          "train: dx at a grad_q8 site differs from the bf16 VJP's")
    gq_errs = {k: mrd(g_q[k], g_h[k]) for k in g_h}
    gq_worst = max(gq_errs, key=gq_errs.get)
    # the whole grad_q8 gradient held to the f32 tune's as (a) holds the
    # headline's, and each blob of a grad_q8 site on its own
    l2_q, cos_q = _grad_agreement(g_q, g_f)
    q_blobs = [k for k in cos_q if k.rsplit("_", 1)[0] in q8_tunes]
    least_q, least_site = min(cos_q, key=cos_q.get), \
        min(q_blobs, key=cos_q.get)
    print(f"  grad_q8: step-1 loss {loss_q:.6f}; {planned} int8 weight "
          f"gradients on B6 ({got[0]} qconv + {got[1]} act_quantize + "
          f"{got[2]} cotangent_quantize launches, as the plan says); {len(held)} distinct wgrad calls "
          f"bit-equal to wgrad_q8_plain; dx at the {len(q8_sites)} sites "
          f"bit-equal to the bf16 VJP's; gradients against the f32 tune's: "
          f"relative L2 {l2_q:.3e} (gate {TRAIN_Q8_L2:g}), least cosine "
          f"{cos_q[least_q]:.5f} ({least_q}; gate {TRAIN_GRAD_COS:g}), at "
          f"the {len(q_blobs)} blobs of the sites {cos_q[least_site]:.5f} "
          f"({least_site}); against the headline's: max mrd "
          f"{gq_errs[gq_worst]:.3e} ({gq_worst})")
    check(len(cos_q) == len(g_q)
          and {k.rsplit("_", 1)[0] for k in q_blobs} == set(q8_tunes)
          and l2_q <= TRAIN_Q8_L2 and cos_q[least_q] >= TRAIN_GRAD_COS,
          f"train: grad_q8 gradients off the f32 tune's: relative L2 "
          f"{l2_q:.3e}, cosine {cos_q[least_q]:.5f} at {least_q}")
    t["grad_q8"] = {"loss": loss_q, "planned_per_step": planned,
                    "qconv_per_step": planned_convs,
                    "wgrad_distinct": len(held),
                    "wgrad_max_abs_err": wgrad_abs,
                    "grad_rel_l2": l2_q, "grad_min_cos": cos_q[least_q],
                    "grad_min_cos_sites": cos_q[least_site],
                    "grad_max_mrd_vs_headline": gq_errs[gq_worst],
                    "grad_worst": gq_worst}
    t["grads"]["s"] = time.perf_counter() - t0
    del rec_h, rec_q, g_h, g_q, g_f
    torch.cuda.empty_cache()


GUARD_TUNES = {"f32": TUNES["f32"], "fused_f32": TUNES["fused_f32"],
               "quant8": "(use_culibs=1,prec=bf16,layout=nhwc,quant8=1)"}


def _train_guard(t: dict, dev) -> None:
    """A training forward (weights that require grad) through the hand
    kernels' templates raises on the card as on the CPU, naming the step,
    before any hand kernel launches: B1/B2 under (), B4/B5 under the fused
    tune, B6's int8 forward under quant8."""
    import torch
    from boda_tpu_torch.core.error import RtErr
    from boda_tpu_torch.engine.lower import lower_pipe
    from boda_tpu_torch.engine.torch_fwd import build_forward, \
        weights_to_torch
    from boda_tpu_torch.ops.cnn_variants import make_op_tune
    wrappers = _wrappers()
    pipe = _train_pipe("resnet-50", 2)
    x, _ = _train_batch(pipe, dev)
    refused = t["refused"] = {}
    for name, tune in GUARD_TUNES.items():
        plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True)
        w = {k: v.requires_grad_(v.is_floating_point()) for k, v in
             weights_to_torch(plan, pipe.op_params, dev).items()}
        _counts_reset(wrappers)
        try:
            build_forward(plan, dev)({"data": x}, w)
            msg = ""
        except RtErr as e:
            msg = str(e)
        torch.cuda.synchronize()
        launched = {k: v.launches for k, v in wrappers.items() if v.launches}
        check("has no backward" in msg and not launched,
              f"train guard {name}: '{msg}', launches {launched}")
        refused[name] = msg.split(":")[1].strip().split(",")[0]
    print(f"  training through the hand kernels' templates raises before "
          f"any launch: {refused}")


def _cnet_train(net: str, extra: str) -> tuple[str, object]:
    """cnet_train through the CLI's parser on TRAIN_SRC, momentum, b32."""
    src = TRAIN_SRC.format(n=4 * TRAIN_BATCH, hw=TRAIN_HW)
    return _run_mode(f"(mode=cnet_train,{TRAIN_NETS[net]},batch="
                     f"{TRAIN_BATCH},in_dims=(dims=(img={TRAIN_BATCH},"
                     f"chan=3,y={TRAIN_HW},x={TRAIN_HW})),stream={src},"
                     f"optimizer=momentum,lr=0.001,log_every=1,"
                     f"boda_output_dir={TRAIN_OUT},{extra})")


def _train_runs(t: dict, launches: dict) -> None:
    """cnet_train's own runs: three steps under the headline tune and
    under the grad_q8 preset (B6's launches counted over the run alone),
    resume bit-identical, and GoogLeNet with dropout."""
    import numpy as np
    import torch
    wrappers = _wrappers()
    runs = t["cnet_train"] = {}
    for label, extra in (("headline", f"op_tune={TUNES['headline']}"),
                         ("grad_q8", f"op_tune={TUNES['headline']},"
                                     f"op_tunes_pat={_grad_q8_pats()}")):
        _counts_reset(wrappers)
        t0 = time.perf_counter()
        out, hm = _cnet_train("resnet-50", f"steps={TRAIN_STEPS},{extra}")
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        s = time.perf_counter() - t0
        check(len(hm.losses) == TRAIN_STEPS
              and all(np.isfinite(hm.losses)),
              f"train {label}: losses {hm.losses}")
        launches[f"train:{label}"] = counts
        runs[label] = {"losses": hm.losses, "s": s, "launches": counts}
        print(f"  cnet_train resnet-50 b{TRAIN_BATCH} {label}: losses "
              f"{[round(v, 6) for v in hm.losses]} ({s:.1f} s with the "
              f"load); launches {counts}")
        if label == "grad_q8":
            sites, convs = _planned_wgrad(hm._plan, TRAIN_BATCH)
            check(sites > 0 and counts["qconv"] == convs * TRAIN_STEPS
                  and counts["act_quantize"] == sites * TRAIN_STEPS
                  and counts["cotangent_quantize"] == sites * TRAIN_STEPS
                  and sum(counts.values())
                  == (2 * sites + convs) * TRAIN_STEPS,
                  f"train grad_q8: launches {counts}, the plan's "
                  f"{sites} wgrads ({convs} qconv) over {TRAIN_STEPS} steps")
        else:
            check(not any(counts.values()),
                  f"train headline: hand-kernel launches {counts}")
        del hm
    # (c) resume: 2 steps + snapshot + 2 more == 4 straight, bit for bit
    t0 = time.perf_counter()
    base = f"op_tune={TUNES['headline']}"
    _, full = _cnet_train("resnet-50", f"steps=4,{base}")
    _, half = _cnet_train("resnet-50", f"steps=2,{base},snapshot_every=2,"
                                       f"snapshot_fn=resume.boda")
    _, res = _cnet_train("resnet-50", f"steps=4,{base},resume_fn="
                                      f"{TRAIN_OUT / 'resume.boda'}")
    same_w = full.weights.keys() == res.weights.keys() and all(
        bit_equal(full.weights[k], res.weights[k]) for k in full.weights)
    check(full.losses == res.losses and same_w,
          f"train: resume differs: losses {full.losses} against "
          f"{res.losses}, weights equal {same_w}")
    runs["resume"] = {"losses": res.losses, "s": time.perf_counter() - t0}
    print(f"  resume: 2 steps, a snapshot, 2 more = 4 straight steps, bit "
          f"for bit in {len(res.losses)} losses and {len(res.weights)} "
          f"weights ({runs['resume']['s']:.1f} s)")
    del full, half, res
    # GoogLeNet: concat, LRN and the seeded dropout under autograd
    t0 = time.perf_counter()
    out, hm = _cnet_train("googlenet_conv_lrn", f"steps={TRAIN_STEPS},"
                                            f"op_tune={TUNES['headline']},"
                                            f"train_dropout=1")
    check(len(hm.losses) == TRAIN_STEPS and all(np.isfinite(hm.losses))
          and any(st.func_name == "dropout" for st in hm._plan.steps)
          and any(st.func_name == "lrn" for st in hm._plan.steps),
          f"train googlenet: losses {hm.losses}")
    runs["googlenet"] = {"losses": hm.losses, "s": time.perf_counter() - t0}
    print(f"  cnet_train googlenet_conv_lrn b{TRAIN_BATCH} headline "
          f"train_dropout=1: losses {[round(v, 6) for v in hm.losses]}")
    del hm
    torch.cuda.empty_cache()


def _train_bench_rows(t: dict, launches: dict, smi: str) -> None:
    """train_bench on ResNet-50 b32 (the trained 40-class weights) under
    the headline tune, the grad_q8 preset and remat=1, with the card's busy
    time in one more step (torch.profiler) and so its idle share."""
    import torch
    from boda_tpu_torch.apps.train import deterministic_cudnn
    wrappers = _wrappers()
    rows = t["train_bench"] = []
    for label, extra in (("headline", f"op_tune={TUNES['headline']}"),
                         ("grad_q8", f"op_tune={TUNES['headline']},"
                                     f"op_tunes_pat={_grad_q8_pats()}"),
                         ("remat", f"op_tune={TUNES['headline']},remat=1")):
        _counts_reset(wrappers)
        out, hm = _run_mode(f"(mode=train_bench,{TRAIN_NETS['resnet-50']},"
                            f"batch={TRAIN_BATCH},in_dims=(dims=(img="
                            f"{TRAIN_BATCH},chan=3,y={TRAIN_HW},"
                            f"x={TRAIN_HW})),optimizer=momentum,"
                            f"iters={TRAIN_BENCH_ITERS},reps=3,{extra})")
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        line = out.strip().splitlines()[-1]
        print(f"{line} on [{smi}]")
        check(line.startswith(f"train_bench resnet-50 b{TRAIN_BATCH} ")
              and hm.step_ms > 0, f"train_bench {label}: {line}")
        per = {k: v // hm.steps for k, v in counts.items()}
        sites, convs = _planned_wgrad(hm.plan, TRAIN_BATCH)
        check(counts["qconv"] == convs * hm.steps
              and counts["act_quantize"] == sites * hm.steps
              and counts["cotangent_quantize"] == sites * hm.steps,
              f"train_bench {label}: launches {counts} over {hm.steps} "
              f"steps, {convs} qconv and {sites} act_quantize each")
        launches[f"train_bench:{label}"] = per
        with deterministic_cudnn():
            busy, top_k = _device_busy_ms(hm.one_step)
        idle = 1 - busy / hm.step_ms
        print(f"  train_bench {label}: device busy {busy:.3f} ms of the "
              f"step's {hm.step_ms:.3f} ms ({100 * idle:.1f}% idle); most "
              f"of it: " + "; ".join(f"{k} x{n} {t:.3f} ms"
                                     for k, n, t in top_k))
        rows.append({"tune": label, "batch": TRAIN_BATCH,
                     "busy_ms": busy, "idle_share": idle,
                     "top_kernels": [{"kernel": k, "calls": n, "ms": t}
                                     for k, n, t in top_k],
                     "step_ms": hm.step_ms,
                     "nondet_step_ms": hm.nondet_step_ms,
                     "imgs_per_sec": TRAIN_BATCH / hm.step_ms * 1e3,
                     "tflops": hm.tflops, "frac_bf16_peak": hm.frac,
                     "max_mem_bytes": hm.max_mem,
                     "base_mem_bytes": hm.base_mem,
                     "launches_per_step": per})
        del hm
        torch.cuda.empty_cache()


def _wgrad_times(dev, peaks) -> dict:
    """B6 in its wgrad role at the preset's four b32 site shapes: the
    wrapper (both quantize passes, the layout glue, the kernel), the
    kernel alone and both quantize passes bit-equal to their plain
    versions; the kernel alone timed through a CUDA graph beside its plain
    version, its plan, its bound and bf16 cuDNN's weight gradient
    (aten.convolution_backward, the weight only); the two quantize passes
    (x stored transposed, the cotangent per channel into B6's filter)
    timed the same way beside their byte bound; the wrapper's time beside
    them; then the wrapper bit-equal at the strided sites of
    WGRAD_STRIDED. Returns the kernel-line entry."""
    import torch
    from boda_tpu_torch.ops.cuda.qconv import act_quantize, \
        act_quantize_plain, cotangent_quantize, cotangent_quantize_plain, \
        qconv, qconv_plain, qconv_plan, wgrad_q8, wgrad_q8_plain
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(12)
    entry = {"name": "qconv_wgrad", "route": "cuda",
             "source": "boda_tpu_torch/csrc/qconv.cu",
             "replaces": "boda_tpu/ops/mxu_grad.py:170",
             "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
             "bound_by": None, "library_ms": 0.0, "wrapper_ms": 0.0,
             "quantize_ms": 0.0, "quantize_bound_ms": 0.0, "cases": []}
    cl = torch.channels_last
    for label, n, hw, ci, co, k in WGRAD_SHAPES:
        p = k // 2
        x = torch.relu(torch.randn(n, hw, hw, ci, device=dev,
                                   generator=gen)).to(torch.bfloat16)
        g = (torch.randn(n, hw, hw, co, device=dev, generator=gen) * 1e-3) \
            .to(torch.bfloat16).float()
        w = torch.empty(co, ci, k, k, device=dev, dtype=torch.bfloat16)
        got = wgrad_q8(x, w, g, (1, 1), (p, p))
        want = wgrad_q8_plain(x, w, g, (1, 1), (p, p))
        check(bit_equal(got, want),
              f"wgrad {label}: differs from wgrad_q8_plain")
        xt, s_x = act_quantize(x, 0.0, True)
        gq, s_g = cotangent_quantize(g)
        torch.cuda.synchronize()
        check(all(bit_equal(a, b) for a, b in zip(
            (xt, s_x, gq, s_g), (*act_quantize_plain(x, 0.0, True),
                                 *cotangent_quantize_plain(g)))),
              f"wgrad {label}: a quantize pass differs from its plain "
              f"version")
        args = (xt, gq, s_x, s_g, None, (1, 1), (p, p), False,
                torch.float32, 0.0)
        out = qconv(*args)
        out_plain = qconv_plain(*args)
        check(bit_equal(out, out_plain),
              f"wgrad {label}: B6 differs from qconv_plain")
        plan = qconv_plan(ci, hw, hw, n, co, hw, hw, (1, 1), (p, p), sms)
        entry["max_abs_err"] = max(
            entry["max_abs_err"], float((got - want).abs().max()),
            float((out - out_plain).abs().max()))
        ms = graph_ms(lambda: qconv(*args))
        plain_ms = cuda_ms(lambda: qconv_plain(*args), 3)
        wrapper_ms = cuda_ms(lambda: wgrad_q8(x, w, g, (1, 1), (p, p)), 20)
        q_ms = graph_ms(lambda: (act_quantize(x, 0.0, True),
                                 cotangent_quantize(g)))
        q_bound, _ = bound(peaks, "int8", 0, _nbytes(x, xt, g, gq, s_g))
        xc, gc = x.permute(0, 3, 1, 2), g.to(torch.bfloat16).permute(
            0, 3, 1, 2)
        wc = w.contiguous(memory_format=cl)
        lib_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            gc, xc, wc, None, [1, 1], [p, p], [1, 1], False, [0, 0], 1,
            [False, True, False]), 20)
        M, N, K = ci * k * k, co, n * hw * hw
        b_ms, b_by = bound(peaks, "int8", 2 * M * N * K,
                           _nbytes(xt, gq, out))
        case = {"case": label, "gemm": [M, N, K], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "wrapper_ms": wrapper_ms,
                "quantize_ms": q_ms, "quantize_bound_ms": q_bound,
                "plan": _qconv_plan_str(plan)}
        print(f"  wgrad {label} (B6 M x N x K = {M} x {N} x {K}; plan "
              f"{case['plan']}): kernel {ms:.4f} ms, plain {plain_ms:.4f}, "
              f"bound {b_ms:.4f} ({b_by}), bf16 cuDNN wgrad {lib_ms:.4f}; "
              f"quantize passes (x transposed, the cotangent per channel) "
              f"{q_ms:.4f} ms, bound {q_bound:.4f} (bytes); wgrad_q8 with "
              f"them {wrapper_ms:.4f} ms; bit-equal")
        for kk in ("ms", "plain_ms", "bound_ms", "library_ms", "wrapper_ms",
                   "quantize_ms", "quantize_bound_ms"):
            entry[kk] += case[kk]
        if all(b_ms >= c["bound_ms"] for c in entry["cases"]):
            entry["bound_by"] = b_by
        entry["cases"].append(case)
        del x, g, xt, gq, out, out_plain, got, want
    for label, n, hw, ci, co, k, st in WGRAD_STRIDED:
        p, oy = k // 2, (hw + 2 * (k // 2) - k) // st + 1
        x = torch.relu(torch.randn(n, hw, hw, ci, device=dev,
                                   generator=gen)).to(torch.bfloat16)
        g = torch.randn(n, oy, oy, co, device=dev, generator=gen) * 1e-3
        w = torch.empty(co, ci, k, k, device=dev, dtype=torch.bfloat16)
        before = qconv.launches
        got = wgrad_q8(x, w, g, (st, st), (p, p))
        convs = qconv.launches - before
        want = wgrad_q8_plain(x, w, g, (st, st), (p, p))
        check(bit_equal(got, want) and convs == min(st, k) ** 2,
              f"wgrad {label}: differs from wgrad_q8_plain or ran {convs} "
              f"B6 convs")
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   float((got - want).abs().max()))
        print(f"  wgrad {label} b{n} {hw}x{hw}: {convs} B6 conv(s), one per "
              f"phase of the stride, K = {n * oy * oy} each; bit-equal")
        del x, g, got, want
    torch.cuda.empty_cache()
    return entry


def phase_train(ctx: dict) -> None:
    """Training on the card: cnet_train and train_bench on the trained
    40-class ResNet-50 (224², b32) and GoogLeNet, the conv VJP held
    against its plain form and the f32 tune, B6's int8 weight gradient."""
    import torch
    from boda_tpu_torch.core.machine import card_peaks
    TRAIN_OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    t = ctx["train"] = {}
    launches = ctx.setdefault("launches", {})
    # the host paces a training step, and autograd makes many Python
    # objects: the earlier phases' objects are moved out of the collector's
    # reach (gc.freeze), as in a fresh process, and what else runs in the
    # process is noted
    import gc
    import threading
    gc.collect()
    gc.freeze()
    t["threads"] = sorted(th.name for th in threading.enumerate())
    print(f"  train: {len(t['threads'])} threads in the process: "
          f"{t['threads']}; {gc.get_freeze_count()} objects frozen")
    t0 = time.perf_counter()
    _train_grads(t, dev)
    _train_guard(t, dev)
    _train_runs(t, launches)
    _train_bench_rows(t, launches, ctx["smi"])
    # B6's wgrad cases (timed in the kernels phase where it ran), and the
    # distinct wgrad calls of the grad_q8 training step
    entry = ctx.pop("wgrad", None) or _wgrad_times(dev, peaks)
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               t["grad_q8"]["wgrad_max_abs_err"])
    t["wgrad"] = entry
    gc.unfreeze()
    t["s"] = time.perf_counter() - t0
    print(f"  train: the card {ctx['smi']}")


# ---------------------------------------------------------------- tune

TUNE_OUT = ROOT / "build" / "tune_smoke"
# the vendor base of fusion_penalty and cnet_stage_probe, and the hand tune
# whose standalone wins fusion_penalty puts to the test inside the net
VENDOR_BASE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0)"
HAND_BF16 = "(prec=bf16,layout=nhwc)"
# ops_prof at the conv-baseline op (3x3, 384->384, 13^2, b5, ReLU: the
# reference's published conv row): cuDNN FP32 (kg), the vendor conv in
# bf16, B2 and B1 (im2col) in bf16, then B6; the vendor forms share the
# func name xla_conv, so each tolerance has a call of its own. Each entry:
# (name, tunes, tolerance, {tune: the hand kernel it launches})
BASELINE_RUNS = [
    ("baseline", "(kg=(use_culibs=1),vendor=(use_culibs=1,prec=bf16),"
                 "tconv=(prec=bf16),conv=(prec=bf16,tconv=0))",
     "mrd_toler=5e-3", {"tconv": "tconv", "conv": "matmul_ext"}),
    ("baseline_int8", "(kg=(use_culibs=1),int8=(use_culibs=1,prec=bf16,"
                      "quant8=1))",
     "mrd_toler=5e-2", {"int8": "qconv"}),
]
TUNE_RUN_ITER = 3
FP_MAX_SITES = 8
TUNE_ITERS = 10
# cnet_tune's grid at ResNet-50 b32: (), bf16 NHWC, the fused bf16 tune and
# the headline tune
TUNE_GRID = ("f32", "bf16_nhwc", "fused_bf16_nhwc", "headline")
XPROF_STEPS = 5
# each hand kernel's device kernels (csrc/*.cu __global__ names; their
# split-K reduce and max passes, which run only where a plan asks, are
# left out), as cnet_xprof's by-kind rows name them
DEVICE_KERNELS = {"matmul_ext": ("matmul_wgmma", "matmul_ffma"),
                  "tconv": ("tconv_bf16_kernel", "tconv_f32_kernel"),
                  "fused_stem": ("stem_mma", "stem_ffma"),
                  "resblock": ("resblock_mma", "resblock_ffma"),
                  "qconv": ("qconv_kernel",),
                  "act_quantize": ("act_quant_write",),
                  "bconv": ("bconv_kernel",)}
# the per-model grid at b64 (docs/PERF.md:80-90's rows): model, its int8
# site regex (None: tune/presets.RESNET_INT8_SITE_PATS) and static scales
GRID_BATCH = 64
GRID_ITERS = 5
GRID = [("resnet-101", None, DATA / "resnet101-b64-int8-scales.lexp"),
        ("resnet-152", None, DATA / "resnet152-b64-int8-scales.lexp"),
        ("vgg-19", r"conv[345]_.*|fc[67]-conv",
         DATA / "vgg19-b64-int8-fc-scales.lexp"),
        ("vgg16-conv", r"conv[345]_.*|fc[67]-conv",
         DATA / "vgg16-b64-int8-fc-scales.lexp")]


def _run_mode_err(spec: str) -> tuple[str, str, object]:
    """create_and_run_has_main(spec) with its stdout and stderr captured."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out, hm = _run_mode(spec)
    return out, err.getvalue(), hm


def _ops_prof_run(name: str, ops_fn: str, tunes: str, extra: str,
                  wrappers: dict, run_iter: int) -> tuple[str, dict]:
    """ops_prof (be=torch) over an op-sig file, its wisdom written to
    TUNE_OUT/<name>.wis; every run must pass (no COMP_FAIL, ERROR or
    digest failure: the mode raises on any). Returns (its output, the hand
    kernels' launches)."""
    import torch
    _counts_reset(wrappers)
    out, _ = _run_mode(f"(mode=ops_prof,ops_fn={DATA / 'ops' / ops_fn},"
                       f"op_tunes={tunes},run_iter={run_iter},{extra},"
                       f"boda_output_dir={TUNE_OUT},wisdom_out_fn={name}.wis)")
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    n_ok = len(re.findall(r"^OP .* ok$", out, re.M))
    n_ops = len((DATA / "ops" / ops_fn).read_text().split())
    check(n_ok == n_ops * len(_tune_specs(tunes)),
          f"ops_prof {name}: {n_ok} runs ok of "
          f"{n_ops * len(_tune_specs(tunes))}")
    return out, counts


def _tune_baseline(t: dict, wrappers: dict, peaks) -> None:
    """ops_prof at the conv-baseline op: every tune checked against cuDNN
    FP32, each hand kernel launched once per timed call."""
    for name, tunes, tol, kernels in BASELINE_RUNS:
        out, counts = _ops_prof_run(name, "conv-baseline.txt", tunes, tol,
                                    wrappers, OPS_RUN_ITER)
        rows = _ops_prof_table(out, tunes, peaks, us=True)
        print(f"ops_prof conv-baseline ({tunes}, {tol}): launches "
              f"{ {k: v for k, v in counts.items() if v} } on "
              f"[{t['smi']}]")
        for r in rows:
            print(r)
        t.setdefault("baseline", []).extend(r.strip() for r in rows)
        for tune, k in kernels.items():
            check(counts[k] == OPS_RUN_ITER,
                  f"ops_prof {name}: {counts[k]} {k} launches for tune "
                  f"{tune} != {OPS_RUN_ITER}")


def _tune_wisdom(t: dict, wrappers: dict) -> None:
    """The wisdom flow at ResNet-50 b32: ops_prof over the net's own conv
    sigs (vendor base and the hand bf16 tune), fusion_penalty on that
    wisdom, then cnet_bench with the merged wisdom against the vendor base
    in turns (vendor, wisdom, wisdom, vendor): each WINS site runs the hand
    template and each losing site the vendor one, the launches per forward
    are the plan's, and each distinct B1 and B2 call of one more forward
    is held against its plain version."""
    import torch
    from boda_tpu_torch.tune.wisdom import NET_PLAT_SUFFIX, read_wisdom_file
    w = t["wisdom"] = {}
    t0 = time.perf_counter()
    _ops_prof_run("rn50_b32", "resnet50-convs.txt",
                  f"(base={VENDOR_BASE},hand={HAND_BF16})",
                  "kg_tune_tag=base,mrd_toler=5e-3", wrappers,
                  TUNE_RUN_ITER)
    w["ops_prof_s"] = time.perf_counter() - t0
    print(f"ops_prof resnet50-convs.txt (base {VENDOR_BASE}, hand "
          f"{HAND_BF16}): 42 runs ok ({w['ops_prof_s']:.1f} s)")
    merged_fn = TUNE_OUT / "rn50_b32_net.wis"
    out, hm = _run_mode(
        f"(mode=fusion_penalty,model=resnet-50,batch=32,"
        f"wisdom_fn={TUNE_OUT / 'rn50_b32.wis'},"
        f"wisdom_out_fn={merged_fn.name},max_sites={FP_MAX_SITES},"
        f"iters={TUNE_ITERS},reps=3,boda_output_dir={TUNE_OUT})")
    print(out.rstrip())
    verdicts = hm.verdicts
    check(len(hm.sites) >= 1, "fusion_penalty: no candidate site")
    check(len(verdicts) == len(hm.sites) and all(
        re.search(rf"^{re.escape(v['site'])} .*(WINS|loses)", out, re.M)
        for v in verdicts), "fusion_penalty: a site without a verdict line")
    net_plat = hm.plat + NET_PLAT_SUFFIX
    recs = {r.site: r for r in read_wisdom_file(merged_fn) if r.site}
    check(set(recs) == {v["site"] for v in verdicts},
          f"fusion_penalty: site records {sorted(recs)}")
    for v in verdicts:
        runs = recs[v["site"]].tunes
        check(net_plat in runs[v["tune"]].runs
              and net_plat in runs[VENDOR_BASE].runs,
              f"fusion_penalty: {v['site']} has no {net_plat} rows")
    w["plat"], w["verdicts"] = net_plat, verdicts
    w["vendor_net_ms"] = hm.vendor_ms
    del hm
    torch.cuda.empty_cache()
    w["cnet_bench"] = []
    vendor_func = None
    for which in ("vendor", "wisdom", "wisdom", "vendor"):
        spec = f"op_tune={VENDOR_BASE}" + (
            f",wisdom_fn={merged_fn}" if which == "wisdom" else "")
        _counts_reset(wrappers)
        out, hm = _run_mode(f"(mode=cnet_bench,model=resnet-50,batch=32,"
                            f"iters={TUNE_ITERS},reps=3,{spec})")
        torch.cuda.synchronize()
        counts = {k: wr.launches for k, wr in wrappers.items()}
        planned = _planned_launches(hm.eng.plan, counts)
        per = {k: v // hm.forwards for k, v in counts.items()}
        check(all(counts[k] == planned[k] * hm.forwards for k in counts),
              f"cnet_bench {which}: launches {counts} over {hm.forwards} "
              f"forwards != the plan's {planned} each")
        funcs = {s.call_tag: s.func_name for s in hm.eng.plan.steps}
        line = out.strip().splitlines()[-1]
        print(f"  {which}: {line}; launches per forward "
              f"{ {k: v for k, v in per.items() if v} }")
        w["cnet_bench"].append({"which": which, "step_ms": hm.step_ms,
                                "launches_per_forward": per})
        if which == "vendor":
            vendor_func = vendor_func or funcs
        elif "held" not in w:
            for v in verdicts:
                want = v["func"] if v["wins"] else vendor_func[v["site"]]
                check(funcs.get(v["site"]) == want,
                      f"wisdom plan: site {v['site']} runs "
                      f"{funcs.get(v['site'])}, not {want} "
                      f"({'WINS' if v['wins'] else 'loses'})")
            check(per["matmul_ext"] + per["tconv"] > 0 or not any(
                v["wins"] for v in verdicts),
                "wisdom plan: a winning hand site launches no B1 or B2")
            if per["matmul_ext"] + per["tconv"]:
                w["held"] = _hold_row("cnet_bench wisdom", hm.eng, per,
                                      wrappers)
            else:
                w["held"] = None
        del hm
        torch.cuda.empty_cache()


def _tune_search(t: dict, wrappers: dict) -> None:
    """cnet_tune at ResNet-50 b32 over TUNE_GRID: a row per tune, one best:
    line written to wisdom_out_fn, the launches of the whole run those of
    each row's plan times its forwards, and each row that launches B1, B2
    or B6 held call by call against the plain versions."""
    import torch
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.models.zoo import build_model
    tunes = ",".join(TUNES[n] for n in TUNE_GRID)
    _counts_reset(wrappers)
    out, hm = _run_mode(f"(mode=cnet_tune,model=resnet-50,batch=32,"
                        f"tunes=({tunes}),iters={TUNE_ITERS},reps=3,"
                        f"wisdom_out_fn=best.txt,boda_output_dir={TUNE_OUT})")
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    print(out.rstrip())
    rows = [ln for ln in out.splitlines() if re.match(r"b\d+ tune ", ln)]
    best = [ln for ln in out.splitlines() if ln.startswith("best: ")]
    check(len(rows) == len(TUNE_GRID) and len(best) == 1,
          f"cnet_tune: {len(rows)} rows, {len(best)} best lines")
    _ips, b, tune = hm.best
    check((TUNE_OUT / "best.txt").read_text()
          == f"(model=resnet-50,batch={b},tune={tune})\n",
          "cnet_tune: the winner file")
    want = dict.fromkeys(counts, 0)
    for r in hm.rows:
        for k, v in _planned_launches(r["plan"], counts).items():
            want[k] += v * r["forwards"]
    check(counts == want, f"cnet_tune: launches {counts} != the rows' "
                          f"plans {want}")
    t["cnet_tune"] = {"rows": [{k: v for k, v in r.items() if k != "plan"}
                               for r in hm.rows],
                      "best": {"batch": b, "tune": tune}}
    pipe = build_model("resnet-50", batch=32)
    for name, r in zip(TUNE_GRID, hm.rows):
        per = _planned_launches(r["plan"], counts)
        if not any(per[k] for k in HELD):
            continue
        eng = make_engine(f"(engine=torch,op_tune={TUNES[name]})")
        eng.init(pipe)
        t["cnet_tune"]["rows"][TUNE_GRID.index(name)]["held"] = _hold_row(
            f"cnet_tune {name}", eng, per, wrappers)
        del eng
        torch.cuda.empty_cache()
    del hm
    torch.cuda.empty_cache()


def _tune_stages(t: dict, wrappers: dict) -> None:
    """cnet_stage_probe at ResNet-50 b32 under the fused bf16 tune (B4 in
    stem, B5 in s2-s5) and the headline tune, then bwd=1 under the headline
    tune: each stage's output equal to the whole net's value of its
    out_node; bwd=1 under () refused by the inference-only guard."""
    import torch
    from boda_tpu_torch.core.error import RtErr
    from boda_tpu_torch.engine.torch_fwd import _storage_in
    st = t["stage_probe"] = {}
    for name, bwd in (("fused_bf16_nhwc", 0), ("headline", 0),
                      ("headline", 1)):
        label = f"{name}{' bwd' if bwd else ''}"
        out, hm = _run_mode(f"(mode=cnet_stage_probe,model=resnet-50,"
                            f"batch=32,op_tune={TUNES[name]},bwd={bwd},"
                            f"iters={TUNE_ITERS},reps=3)")
        print(f"cnet_stage_probe {label} on [{t['smi']}]:")
        print(out.rstrip())
        plan = hm.plan
        funcs = {ps.name: {s.func_name for s in ps.steps}
                 for ps in hm.segments}
        if name == "fused_bf16_nhwc":
            check("fused_stem" in funcs["stem"] and all(
                "resblock" in funcs[s] for s in ("s2", "s3", "s4", "s5")),
                f"cnet_stage_probe {label}: stage templates {funcs}")
        errs = {}
        with torch.inference_mode():
            for ps in hm.segments:
                got = ps.fn(hm.stage_inputs[ps.name],
                            *[hm.weights[w] for w in ps.weight_names])
                want = _storage_in(hm.node_vals[ps.out_node],
                                   plan.node_dims[ps.out_node], plan)
                errs[ps.name] = mrd(got, want)
        toler = BF16_MRD if plan.edge_prec == "bf16" else F32_MRD
        print(f"  each stage's output against the whole net's "
              f"keep_all_nodes value of its out_node: mrd {errs} "
              f"(<= {toler:g})")
        check(max(errs.values()) <= toler,
              f"cnet_stage_probe {label}: stage outputs {errs}")
        st[label] = {"rows": [{"stage": n, "steps": k, "ms": ms,
                               "gflops": fl / 1e9}
                              for n, k, ms, fl in hm.rows],
                     "whole_ms": hm.whole_ms, "stage_mrd": errs}
        del hm
        torch.cuda.empty_cache()
    _counts_reset(wrappers)
    try:
        _run_mode("(mode=cnet_stage_probe,model=resnet-50,batch=32,"
                  "op_tune=(),bwd=1,iters=1,reps=1)")
        refused = ""
    except RtErr as e:
        refused = str(e)
    print(f"cnet_stage_probe () bwd=1: {refused or 'not refused'}")
    check("which has no backward" in refused
          and not any(w.launches for w in wrappers.values()),
          "cnet_stage_probe bwd=1 under (): the guard did not refuse it "
          "before any hand kernel launched")


def _tune_xprof(t: dict, wrappers: dict) -> None:
    """cnet_xprof at ResNet-50 b32 under (), under the int8 preset and, with
    bwd=1, under the headline tune: each hand kernel's device kernels are
    called as often as the plan's steps launch it, and the device total
    per step stands beside one forward's busy time."""
    import torch
    xp = t["xprof"] = {}
    for name, bwd in (("f32", 0), (INT8, 0), ("headline", 1)):
        label = f"{name}{' bwd' if bwd else ''}"
        _counts_reset(wrappers)
        out, hm = _run_mode(f"(mode=cnet_xprof,model=resnet-50,batch=32,"
                            f"steps={XPROF_STEPS},bwd={bwd},top_k=8,"
                            f"{engine_spec(name)})")
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        planned = _planned_launches(hm.eng.plan, counts, grad=bool(bwd))
        print(f"cnet_xprof {label}:")
        print(out.rstrip())
        # the mode's forward outside the trace and its profiler warm-up,
        # then the traced steps
        check(counts == {k: v * (2 + XPROF_STEPS)
                         for k, v in planned.items()},
              f"cnet_xprof {label}: launches {counts}, the plan's "
              f"{planned} per step")
        calls = {k: sum(r["count"] for r in hm.kinds if r["kind"] in names)
                 for k, names in DEVICE_KERNELS.items()}
        print(f"  device kernel calls per hand kernel over {XPROF_STEPS} "
              f"steps: {calls}")
        check(all(calls[k] == planned[k] * XPROF_STEPS for k in calls),
              f"cnet_xprof {label}: device kernel calls {calls} != the "
              f"plan's {planned} x {XPROF_STEPS}")
        if name == "f32":
            check(calls["matmul_ext"] == 40 * XPROF_STEPS
                  and calls["tconv"] == 13 * XPROF_STEPS,
                  f"cnet_xprof f32: {calls}")
        if name == INT8:
            check(calls["qconv"] == 31 * XPROF_STEPS
                  and calls["act_quantize"] == 31 * XPROF_STEPS,
                  f"cnet_xprof int8: {calls}")
        per_step = hm.total_ns / 1e6 / XPROF_STEPS
        row = {"device_ms_per_step": per_step, "kernel_calls": calls,
               "top": [{"kernel": r["kind"], "calls": r["count"],
                        "ms_per_step": r["total_ns"] / 1e6 / XPROF_STEPS}
                       for r in hm.kinds[:8]]}
        if not bwd:
            eng = hm.eng
            data = eng.pipe.data_img_node_names[0]
            x = torch.randn(tuple(eng.pipe.get_data_img_dims().shape),
                            device=eng.dev) * 0.1
            with torch.inference_mode():
                busy, _ = _device_busy_ms(lambda: eng.fwd({data: x},
                                                          eng.weights))
            row["busy_ms_one_forward"] = busy
            print(f"  device total {per_step:.3f} ms per step; "
                  f"_device_busy_ms of one forward {busy:.3f} ms")
        xp[label] = row
        del hm
        torch.cuda.empty_cache()


def _tune_grid(t: dict, wrappers: dict) -> None:
    """cnet_bench at b64 on ResNet-101, ResNet-152, VGG-19 and VGG-16 under
    the headline tune and under their int8 site sets with static scales:
    every entry of each scales file applied, launches per forward as the
    plan says, each int8 row's distinct B6 calls bit-equal to their plain
    versions."""
    import torch
    from boda_tpu_torch.bench import int8_engine_spec
    rows = t["grid"] = []
    for model, pats, scales in GRID:
        for tune_name in ("headline", INT8):
            if tune_name == "headline":
                spec = f"op_tune={TUNES['headline']}"
            elif pats is None:
                spec = int8_engine_spec(TUNES["headline"], scales)
            else:
                spec = _int8_spec(pats, scales)
            _counts_reset(wrappers)
            out, err, hm = _run_mode_err(
                f"(mode=cnet_bench,model={model},batch={GRID_BATCH},"
                f"iters={GRID_ITERS},reps=3,{spec})")
            torch.cuda.synchronize()
            counts = {k: w.launches for k, w in wrappers.items()}
            per = {k: v // hm.forwards for k, v in counts.items()}
            planned = _planned_launches(hm.eng.plan, counts)
            line = out.strip().splitlines()[-1]
            applied = ""
            if tune_name == INT8:
                m = re.search(r"applied (\d+)/(\d+) site\(s\)", err)
                n_file = sum(1 for ln in scales.read_text().splitlines()
                             if ln.strip())
                applied = f"applied {m[1]}/{m[2]}" if m else "no scales"
                check(m is not None and int(m[1]) == n_file,
                      f"cnet_bench {model} int8: {applied} of the "
                      f"{n_file} entries of {scales.name}")
                check(per["qconv"] > 0, f"cnet_bench {model} int8: no qconv")
            print(f"{line}; {applied + '; ' if applied else ''}launches per "
                  f"forward { {k: v for k, v in per.items() if v} } on "
                  f"[{t['smi']}]")
            check(all(counts[k] == planned[k] * hm.forwards for k in counts),
                  f"cnet_bench {model} {tune_name}: launches {counts} over "
                  f"{hm.forwards} forwards != the plan's {planned} each")
            stats = dict(re.findall(r"(\w+)=(\S+)", line))
            row = {"model": model, "tune": tune_name, "batch": GRID_BATCH,
                   "step_ms": hm.step_ms,
                   "imgs_per_sec": GRID_BATCH / hm.step_ms * 1e3,
                   "tflops": hm.tflops,
                   "frac_bf16_peak": float(stats["frac_roofline"]),
                   "launches_per_forward": per}
            if applied:
                row["scales"] = applied
            if any(per[k] for k in HELD):
                row["held"] = _hold_row(f"cnet_bench {model} {tune_name}",
                                        hm.eng, per, wrappers)
            rows.append(row)
            del hm
            torch.cuda.empty_cache()


def phase_tune(ctx: dict) -> None:
    """The tuning and profiling surface: ops_prof at the conv-baseline op,
    the wisdom flow (ops_prof, fusion_penalty, cnet_bench --wisdom_fn),
    cnet_tune, cnet_stage_probe, cnet_xprof and the per-model grid at b64,
    each through the mode a user runs."""
    import torch
    from boda_tpu_torch.core.machine import card_peaks
    TUNE_OUT.mkdir(parents=True, exist_ok=True)
    t = ctx["tune"] = {"smi": ctx["smi"]}
    wrappers = _wrappers()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    for step in (lambda: _tune_baseline(t, wrappers, peaks),
                 lambda: _tune_wisdom(t, wrappers),
                 lambda: _tune_search(t, wrappers),
                 lambda: _tune_stages(t, wrappers),
                 lambda: _tune_xprof(t, wrappers),
                 lambda: _tune_grid(t, wrappers)):
        t0 = time.perf_counter()
        step()
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    del t["smi"]


# ---------------------------------------------------------------- cli

CLI_OUT = ROOT / "build" / "cli_smoke"
# the per-call forward over be=ipc: a worker process owns the card
IPC_SPEC = "(engine=torch,fuse=0,op_tune=(),rtc=(be=ipc,worker_be=torch))"
CLI_BATCH = 32
# test_dense and test_upsamp on ResNet-50 at 224^2, pruned to a node of
# finite support, under the f32 tune at the modes' own tolerances (5e-5,
# 2e-4) and under bf16 NHWC at 5e-3: (mode, tune name, tune, node, extra
# args). test_dense's window is 192 (res4a_branch2c's support is 131, so
# the default 112 would hold no valid output). Under bf16 the upsampled
# companion's folded conv1 filter rounds to bf16 once where the original's
# four taps round apart, and the two nets drift apart with depth (on the
# CPU: 3.8e-3 at conv1, 4.7e-3 at res2a_branch2c, 8.8e-3 at
# res3a_branch2c, 1.1e-2 at res4a_branch2c): its bf16 run stops at
# res2a_branch2c
CLI_DENSE_RUNS = [
    ("test_dense", "f32", "()", "res4a_branch2c", "win_sz=192"),
    ("test_dense", "bf16_nhwc", "(prec=bf16,layout=nhwc)", "res4a_branch2c",
     "win_sz=192,mrd_toler=5e-3"),
    ("test_upsamp", "f32", "()", "res4a_branch2c", ""),
    ("test_upsamp", "bf16_nhwc", "(prec=bf16,layout=nhwc)", "res2a_branch2c",
     "mrd_toler=5e-3"),
]


def _golden():
    """tests/test_torch_golden.py: the golden suites' closed list and its
    checks, which the card's run is held to as the CPU's is."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_torch_golden", ROOT / "tests" / "test_torch_golden.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks itself up there
    spec.loader.exec_module(mod)
    return mod


def _cli_ipc_forward(c: dict, wrappers: dict) -> None:
    """ResNet-50 b32 224^2 under () per call, once in this process and once
    through a worker process over be=ipc: bit-equal on prob and interior
    nodes, the worker's launches B1 40 and B2 13 per forward (none in this
    process), both forwards timed; then cs_test_master on the card."""
    import numpy as np
    import torch
    from boda_tpu_torch.core.dims import NDA
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.engine.torch_fwd import produced_nodes
    from boda_tpu_torch.models.zoo import build_model
    batch = CLI_BATCH
    pipe = build_model("resnet-50", batch=batch)
    local = make_engine("(engine=torch,fuse=0,op_tune=())")
    local.init(pipe)
    remote = make_engine(IPC_SPEC)
    remote.init(pipe)
    worker = remote.rtc
    try:
        d = pipe.get_data_img_dims()
        data = pipe.data_img_node_names[0]
        x = NDA(d, np.random.RandomState(1).randn(*d.shape).astype(np.float32))
        nodes = [n for n in _nodes_to_get(pipe)
                 if n in produced_nodes(local.plan)]
        want = nodes[:-1][::max(1, len(nodes) // 10)] + ["prob"]
        outs_l = local.run_fwd({data: x}, want)
        remote.run_fwd({data: x}, ["prob"])  # builds the worker's kernels
        worker.launches(reset=True)
        _counts_reset(wrappers)
        outs_r = remote.run_fwd({data: x}, want)
        counts = worker.launches(reset=True)
        here = {k: w.launches for k, w in wrappers.items() if w.launches}
        c["launches"]["cli:ipc"] = counts
        print(f"per-call resnet-50 b{batch} () over be=ipc: worker launches "
              f"{ {k: v for k, v in counts.items() if v} }, in this process "
              f"{here}")
        check(counts == UNFUSED_LAUNCHES and not here,
              f"be=ipc: worker launches {counts} != {UNFUSED_LAUNCHES} "
              f"(here {here})")
        unequal = [n for n in want
                   if not np.array_equal(outs_l[n].v, outs_r[n].v)]
        print(f"  in-process vs be=ipc: {len(want)} nodes, bit-unequal: "
              f"{unequal}")
        check(len(want) >= 6 and not unequal,
              f"be=ipc: nodes not bit-equal to the in-process forward: "
              f"{unequal}")
        p = outs_r["prob"].v
        check(p.shape == (batch, 1000, 1, 1) and np.isfinite(p).all(),
              "be=ipc prob: bad shape or non-finite")
        times = {}
        for name, eng in (("local", local), ("ipc", remote)):
            wall, dev = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                eng.run_fwd({data: x}, ["prob"])
                wall.append((time.perf_counter() - t0) * 1e3)
                dev.append(eng.last_run_secs * 1e3)
            times[name] = {"wall_ms": sorted(wall)[1],
                           "calls_span_ms": sorted(dev)[1]}
        print(f"  run_fwd (median of 3; wall / first call's start to last "
              f"call's end on the card): in-process "
              f"{times['local']['wall_ms']:.3f} / "
              f"{times['local']['calls_span_ms']:.3f} ms, be=ipc "
              f"{times['ipc']['wall_ms']:.3f} / "
              f"{times['ipc']['calls_span_ms']:.3f} ms on [{c['smi']}]")
        c["ipc_forward_ms"] = times
    finally:
        worker.quit_worker()
        local.rtc.release_all_vars()
        del local, remote
        torch.cuda.empty_cache()
    out, _ = _run_mode("(mode=cs_test_master,worker_be=torch,n=1048576)")
    print(out.strip())
    check("rtc_test PASSED plat=ipc:torch:cuda:" in out
          and "cs_test_master PASSED" in out, f"cs_test_master: {out}")


def _cli_ops_prof(c: dict, wrappers: dict) -> None:
    """ops_prof over be=ipc beside be=torch in this process: every row of
    both backends checked by the mode against the in-process kg row (mrd
    5e-4), the worker's hand-kernel launches equal to this process's."""
    import torch
    for ops_fn in ("conv-baseline.txt", "resnet50-convs.txt"):
        tunes = "(kg=(use_culibs=1),hand=())"
        _counts_reset(wrappers)
        t0 = time.perf_counter()
        out, hm = _run_mode(
            f"(mode=ops_prof,ops_fn={DATA / 'ops' / ops_fn},op_tunes={tunes},"
            f"rtcs=(t=(be=torch),ipc=(be=ipc,worker_be=torch)),run_iter=1,"
            f"write_kgs=0,"
            f"boda_output_dir={CLI_OUT},wisdom_out_fn=ipc_{ops_fn}.wis)")
        worker = hm.rtcs["ipc"]
        try:
            remote = worker.launches()
        finally:
            worker.quit_worker()
        torch.cuda.synchronize()
        here = {k: w.launches for k, w in wrappers.items()}
        n_ops = len((DATA / "ops" / ops_fn).read_text().split())
        rows = re.findall(r"^OP .* be=(t|ipc) func=(\w+) .* (\S+)$", out,
                          re.M)
        n_ok = {b: sum(1 for be, _f, st in rows if be == b and st == "ok")
                for b in ("t", "ipc")}
        c["launches"][f"cli:ops_prof_ipc:{ops_fn}"] = remote
        print(f"ops_prof {ops_fn} {tunes} over be=torch and be=ipc: rows ok "
              f"{n_ok} of {2 * n_ops} each, launches here "
              f"{ {k: v for k, v in here.items() if v} }, in the worker "
              f"{ {k: v for k, v in remote.items() if v} } "
              f"({time.perf_counter() - t0:.1f} s)")
        check(n_ok == {"t": 2 * n_ops, "ipc": 2 * n_ops},
              f"ops_prof over be=ipc ({ops_fn}): rows ok {n_ok}")
        check(remote == here and remote["matmul_ext"] + remote["tconv"] > 0,
              f"ops_prof over be=ipc ({ops_fn}): worker launches {remote} "
              f"!= here {here}")


def _cli_dense(c: dict, wrappers: dict) -> None:
    """test_dense and test_upsamp on ResNet-50 at 224^2 (CLI_DENSE_RUNS):
    each passes at its tolerance, on a non-empty region, through B1."""
    import torch
    for mode, tune_name, tune, node, extra in CLI_DENSE_RUNS:
        _counts_reset(wrappers)
        t0 = time.perf_counter()
        out, _ = _run_mode(
            f"(mode={mode},model=resnet-50,"
            f"in_dims=(dims=(img=1,chan=3,y=224,x=224)),out_node={node},"
            f"conv_fwd=(engine=torch,keep_all_nodes=1,op_tune={tune})"
            f"{',' + extra if extra else ''})")
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        c["launches"][f"cli:{mode}:{tune_name}"] = \
            {k: w.launches for k, w in wrappers.items()}
        line = out.strip().splitlines()[0]
        print(f"{line} [{tune_name}, launches {counts}, "
              f"{time.perf_counter() - t0:.1f} s]")
        c.setdefault("dense", []).append(f"{line} [{tune_name}]")
        check(f"{mode} PASSED" in out, f"{mode} {tune_name}: {out}")
        box = re.search(r"out_box_full=\[\((\d+),(\d+)\):\((\d+),(\d+)\)\]|"
                        r"cmp=\((\d+),(\d+)\)", line)
        v = [int(g) for g in box.groups() if g is not None]
        size = (v[2] - v[0], v[3] - v[1]) if len(v) == 4 else tuple(v)
        check(min(size) > 0, f"{mode} {tune_name}: empty region {size}")
        check(counts.get("matmul_ext", 0) > 0,
              f"{mode} {tune_name}: no B1 launch ({counts})")


def _cli_suites_start() -> tuple:
    """Start the JAX package's golden suites through `python -m
    boda_tpu_torch test_all` (test_cmds over each) on the card, in their
    own process beside the steps that follow; _cli_suites waits for it."""
    g = _golden()
    root = CLI_OUT / "golden"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    return g, root, g.start_all(root, cpu=False), time.perf_counter()


def _cli_suites(c: dict, started: tuple) -> None:
    """The suites' run held to tests/test_torch_golden.py's closed list with
    its value checks; specs gated on a feature this machine lacks skip (the
    plot specs without matplotlib too)."""
    g, root, proc, t0 = started
    stdout = g.finish_all(proc)
    print(f"golden suites through test_all ({time.perf_counter() - t0:.1f} "
          f"s since their start, beside ops_prof and the dense modes):")
    summaries = re.findall(r"^test_cmds: .*$", stdout, re.M)
    fails = g.failures(stdout)
    for suite, summary in zip(g.CHECKED_IN + g.GENERATED, summaries):
        errs = g.check_suite(suite, stdout, root)
        listed = sorted(set(fails) & set(g.CLOSED)
                        & g.suite_names(suite, root))
        print(f"  {suite}: {summary}; listed {listed}; skipped by feature "
              f"{sorted(g.feature_skips(suite))}")
        for e in errs:
            print(f"    {e}")
        check(not errs, f"golden {suite}: {len(errs)} problem(s)")
        c.setdefault("suites", {})[suite] = summary


def phase_cli(ctx: dict) -> None:
    """The rest of the CLI on the card: the per-call forward and ops_prof
    over be=ipc (a worker process owns the card), cs_test_master,
    test_dense and test_upsamp at full width, and the JAX package's golden
    suites through the port."""
    CLI_OUT.mkdir(parents=True, exist_ok=True)
    wrappers = _wrappers()
    c = {"smi": ctx["smi"], "launches": ctx.setdefault("launches", {})}
    t0 = time.perf_counter()
    _cli_ipc_forward(c, wrappers)  # timed: nothing else on the card yet
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    suites = _cli_suites_start()
    try:
        for step in (lambda: _cli_ops_prof(c, wrappers),
                     lambda: _cli_dense(c, wrappers),
                     lambda: _cli_suites(c, suites)):
            t0 = time.perf_counter()
            step()
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        if suites[2].poll() is None:
            suites[2].kill()
            suites[2].communicate()
    ctx["cli"] = {k: v for k, v in c.items() if k not in ("smi", "launches")}


# the engine's mesh: ResNet-50 b32 224^2 on a 2x2 mesh of 4 slots of the
# card, each tune held to its forward without a mesh at its mrd
PAR_MESH = (2, 2)
PAR_BATCH = 32
PAR_TUNES = {"f32": F32_MRD, "bf16_nhwc": BF16_MRD, INT8: 5e-2}
# GoogLeNet's train-mode dropout on the mesh against one slot, f32 under ()
PAR_DROPOUT_MRD = F32_MRD
PAR_DROPOUT_SEED = 5
# slots of the card the phase's in-process paths see
PAR_SLOTS = 8
# each rank or child process of the phase is killed after this long
PAR_TIMEOUT_S = 300
# the pipelines on the card: pp_test's ResNet-50 at 224^2 (its default
# stages, batch 2 per microbatch) and gpipe_plan_forward under () with the
# same cut, M microbatches
PP_STAGES = 4
PP_MICROBATCHES = 6
PP_ARGS = ["pp_test", "--model=resnet-50", f"--pp={PP_STAGES}",
           f"--microbatches={PP_MICROBATCHES}", "--schedule=both"]
MH_ARGS_MODEL = "resnet-50"
MH_HW = 224
MH_ARGS = [f"--model={MH_ARGS_MODEL}", f"--ysz={MH_HW}",
           f"--batch={PAR_BATCH}"]
# the tolerances of the two-rank gradient check against one slot: the
# forward's logits at the f32 forward's, and each weight's update (lr times
# the summed gradient) at 1e-3, rounding of two half-batch sums against one
# whole-batch sum through ResNet-50's depth (a missing or doubled rank's
# share is off by O(1))
MH_LOGITS_MRD = F32_MRD
MH_UPDATE_MRD = 1e-3
# one rank of the gradient check (mh_logits_run over the two ranks' mesh);
# argv: coordinator, rank
MH_GRADS_RANK = r"""
import json, sys
import chip_smoke
from boda_tpu_torch.parallel.mesh import global_devices, make_mesh
from boda_tpu_torch.parallel.multihost import init_multihost, \
    shutdown_multihost
init_multihost(sys.argv[1], 2, int(sys.argv[2]))
try:
    res = chip_smoke.mh_logits_run(make_mesh(devices=global_devices()))
    print("MH_GRADS " + json.dumps(res))
finally:
    shutdown_multihost()
"""


@contextlib.contextmanager
def _slots(n: int):
    """BODA_TORCH_LOCAL_DEVICES=n for the block, restored after it."""
    import os
    from boda_tpu_torch.core.device import LOCAL_DEVICES_ENV
    old = os.environ.get(LOCAL_DEVICES_ENV)
    os.environ[LOCAL_DEVICES_ENV] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(LOCAL_DEVICES_ENV, None)
        else:
            os.environ[LOCAL_DEVICES_ENV] = old


def _run_procs(cmds: list, what: str, env=None,
               timeout_s: float = PAR_TIMEOUT_S) -> list[tuple[int, str]]:
    """Start every command at once (stdout and stderr to a file of its own,
    so that no process blocks on a full pipe while its peers wait on it),
    wait for each within timeout_s, and kill every one still running after
    that; a timeout fails the phase. [(exit code, output)]."""
    import os
    import tempfile
    env = {**os.environ, "PYTHONPATH": str(ROOT), **(env or {})}
    env = {k: v for k, v in env.items() if v is not None}
    logs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=lg,
                              stderr=subprocess.STDOUT, text=True)
             for c, lg in zip(cmds, logs)]
    deadline = time.perf_counter() + timeout_s
    out = []
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{what}: a process still ran after "
                                   f"{timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, lg in zip(procs, logs):
        lg.seek(0)
        out.append((p.returncode, lg.read()))
        lg.close()
    return out


def _par_mesh_engine(p: dict, wrappers: dict) -> None:
    """The engine on a 2x2 mesh of slots: ResNet-50 b32 224^2 under (), the
    bf16 NHWC tune and the int8 preset (static scales of the trained
    snapshot) against the same forward without a mesh; B1, B2 and B6
    launched as every slot runs every step once (4x the plan's launches),
    the routes of the steps that read a split weight, both forwards timed."""
    import numpy as np
    import torch
    from boda_tpu_torch.core.device import get_device
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.models.zoo import build_model
    dp, mp = PAR_MESH
    n = dp * mp
    pipe = build_model("resnet-50", batch=PAR_BATCH)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        *pipe.get_data_img_dims().shape).astype(np.float32)).to(
            get_device("cuda"))
    for tune, tol in PAR_TUNES.items():
        spec = engine_spec(tune, "trained")
        one = make_engine(f"(engine=torch,{spec})")
        one.init(pipe)
        msh = make_engine(f"(engine=torch,{spec},mesh_dp={dp},mesh_mp={mp})")
        msh.init(pipe)
        with torch.no_grad():
            want = one.fwd({"data": x}, one.weights)["prob"]
            msh.fwd({"data": x}, msh.weights)  # builds the column sigs' plans
            torch.cuda.synchronize()
            _counts_reset(wrappers)
            got = msh.fwd({"data": x}, msh.weights)["prob"]
            torch.cuda.synchronize()
            counts = {k: w.launches for k, w in wrappers.items()}
            ms = cuda_ms(lambda: msh.fwd({"data": x}, msh.weights), 5)
            ms1 = cuda_ms(lambda: one.fwd({"data": x}, one.weights), 5)
        p["launches"][f"parallel:mesh_{tune}"] = counts
        planned = {k: n * v
                   for k, v in _planned_launches(one.plan, counts).items()}
        err = mrd(got.float(), want.float())
        nz = {k: v for k, v in counts.items() if v}
        print(f"mesh {dp}x{mp} resnet-50 b{PAR_BATCH} {tune}: mrd {err:.3g} "
              f"(<= {tol:g}) vs no mesh; {ms:.3f} ms vs {ms1:.3f} ms; "
              f"routes {msh.fwd.routes}; launches {nz} "
              f"({ {k: v / n for k, v in nz.items()} } per slot) "
              f"on [{p['smi']}]")
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"mesh {tune}: bad or non-finite prob")
        check(err <= tol, f"mesh {tune}: mrd {err:.3g} > {tol:g}")
        check(counts == planned, f"mesh {tune}: launches {nz} != planned "
              f"{ {k: v for k, v in planned.items() if v} }")
        check(counts["matmul_ext"] + counts["qconv"] > 0,
              f"mesh {tune}: no B1 or B6 launch")
        p["mesh"][tune] = {"mrd": err, "ms": ms, "ms_unsharded": ms1,
                           "routes": dict(msh.fwd.routes),
                           "launches": nz,
                           "launches_per_slot": {k: v / n
                                                 for k, v in nz.items()}}
        del one, msh, got, want
        torch.cuda.empty_cache()


def _int8_dynamic_spec() -> str:
    """The int8 preset's engine attributes without act_scales_fn: every
    int8 site of tune/presets.RESNET_INT8_SITE_PATS quantizes at its
    batch's absmax."""
    from boda_tpu_torch.tune.presets import RESNET_INT8_SITE_PATS
    q = TUNES["headline"][:-1] + ",quant8=1)"
    pats = ",".join(f"{p}={q}" for p in RESNET_INT8_SITE_PATS)
    return f"op_tune={TUNES['headline']},op_tunes_pat=({pats})"


@contextlib.contextmanager
def _scales_seen():
    """[(x, s_act)] of every int8 step's quantize in the block, in call
    order (the engine's slots run each step in mesh order):
    conv.conv_step's act_quantize wrapped to keep its input and scale."""
    from boda_tpu_torch.ops.cuda import conv
    seen = []
    real = conv.act_quantize

    def act_quantize(x, *a, **kw):
        xq, s_act = real(x, *a, **kw)
        seen.append((x, s_act))
        return xq, s_act
    conv.act_quantize = act_quantize
    try:
        yield seen
    finally:
        conv.act_quantize = real


def _mesh_pair(model: str, spec: str, seed: int | None = None):
    """(one slot's engine, the PAR_MESH engine, inputs) of `model` at
    PAR_BATCH 224^2 under engine attributes `spec`, the inputs random from a
    seed and, where seed is given, the dropout seed node fed it."""
    import numpy as np
    import torch
    from boda_tpu_torch.core.device import get_device
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.engine.lower import DROP_SEED_NODE
    from boda_tpu_torch.models.zoo import build_model
    dp, mp = PAR_MESH
    pipe = build_model(model, batch=PAR_BATCH)
    dev = get_device("cuda")
    inputs = {"data": torch.from_numpy(np.random.RandomState(1).randn(
        *pipe.get_data_img_dims().shape).astype(np.float32)).to(dev)}
    if seed is not None:
        inputs[DROP_SEED_NODE] = torch.tensor([seed], dtype=torch.int32,
                                              device=dev)
    one = make_engine(f"(engine=torch,{spec})")
    one.init(pipe)
    msh = make_engine(f"(engine=torch,{spec},mesh_dp={dp},mesh_mp={mp})")
    msh.init(pipe)
    return one, msh, inputs


def _par_mesh_int8_dynamic(p: dict, wrappers: dict) -> None:
    """ResNet-50 b32 224^2 on the 2x2 mesh under the int8 preset with
    dynamic scales (no act_scales_fn). Every slot of every int8 step
    quantizes at the scale that the one-slot path's dynamic quantize gives
    the step's whole batch (the dp rows' inputs, concatenated), bit for bit
    (each slot's absmax, pmax over dp, the quantize at that max); at the
    steps whose whole batch is bit-equal to the one-slot forward's, at that
    forward's s_act (the vendor f32 convs upstream may round apart at b16
    and out_chan/2: the rest are counted, with the scales' largest relative
    difference). The logits (prob saturates at random weights) within the
    int8 mesh gate of one slot's; per slot one forward's launches, plus one
    absmax per int8 step; one pmax call per int8 step."""
    import torch
    from boda_tpu_torch.ops.cuda.qconv import act_quantize
    from boda_tpu_torch.parallel import mesh as pmesh
    dp, mp = PAR_MESH
    n = dp * mp
    tol = PAR_TUNES[INT8]
    from boda_tpu_torch.engine.torch_fwd import step_writes
    one, msh, inputs = _mesh_pair("resnet-50", _int8_dynamic_spec())
    logits = _logits_node(one.plan)
    # the nodes the float steps before the first int8 step write, in plan
    # order: where the mesh's values first leave one slot's
    first_q = next(i for i, st in enumerate(one.plan.steps)
                   if st.sig.get_u32_or("quant8", 0))
    early = [nd for st in one.plan.steps[:first_q] for nd in step_writes(st)]
    local = msh.mesh.local_positions()
    rows = [j for j, q in enumerate(local) if msh.mesh.coord(q, "mp") == 0]
    with torch.no_grad():
        _counts_reset(wrappers)
        with _scales_seen() as q_one:
            want = one.fwd(inputs, one.weights, out_nodes=[logits, *early])
        torch.cuda.synchronize()
        counts1 = {k: w.launches for k, w in wrappers.items()}
        msh.fwd(inputs, msh.weights)  # builds the column sigs' plans
        torch.cuda.synchronize()
        _counts_reset(wrappers)
        calls0 = pmesh.pmax.calls
        with _scales_seen() as q_mesh:
            got = msh.fwd(inputs, msh.weights, out_nodes=[logits, *early])
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        pmax_calls = pmesh.pmax.calls - calls0
        sites = len(q_one)
        whole = [torch.cat([q_mesh[n * i + j][0] for j in rows])
                 for i in range(sites)]
        s_whole = [act_quantize(x)[1] for x in whole]
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: msh.fwd(inputs, msh.weights), 5)
        ms1 = cuda_ms(lambda: one.fwd(inputs, one.weights), 5)
    p["launches"]["parallel:mesh_int8_dynamic"] = counts
    slot_s = [[s for _, s in q_mesh[n * i:n * (i + 1)]] for i in range(sites)]
    at_whole = [all(torch.equal(v, s_whole[i]) for v in slot_s[i])
                for i in range(sites)]
    same_in = [torch.equal(whole[i], q_one[i][0]) for i in range(sites)]
    at_one = [all(torch.equal(v, q_one[i][1]) for v in slot_s[i])
              for i in range(sites)]
    s_rd = max(float(((s_whole[i] - q_one[i][1]).abs() / q_one[i][1])
                     .max()) for i in range(sites))
    err = mrd(got[logits].float(), want[logits].float())
    err_prob = mrd(got["prob"].float(), want["prob"].float())
    apart = next(((nd, mrd(got[nd].float(), want[nd].float()))
                  for nd in early if not torch.equal(got[nd], want[nd])),
                 None)
    apart_s = "none" if apart is None else f"{apart[0]} (mrd {apart[1]:.3g})"
    nz = {k: v for k, v in counts.items() if v}
    print(f"mesh {dp}x{mp} resnet-50 b{PAR_BATCH} int8 dynamic scales: "
          f"s_act at the whole batch's at {sum(at_whole)} of {sites} sites "
          f"x {n} slots; at one slot's at {sum(at_one)} (inputs bit-equal "
          f"to one slot's at {sum(same_in)}; the first float node before "
          f"them off one slot's: {apart_s}; largest scale rd "
          f"{s_rd:.3g}); logits mrd {err:.3g} (<= {tol:g}), prob "
          f"{err_prob:.3g} vs one slot; {ms:.3f} ms vs {ms1:.3f} ms; routes "
          f"{msh.fwd.routes}; launches {nz} "
          f"({ {k: v / n for k, v in nz.items()} } per slot; one slot "
          f"{ {k: v for k, v in counts1.items() if v} }); absmax "
          f"{counts['absmax']}, act_quantize {counts['act_quantize']}, pmax "
          f"{pmax_calls} calls on [{p['smi']}]")
    check(sites == 31 and len(q_mesh) == n * sites and all(at_whole),
          f"mesh int8 dynamic: s_act is not the whole batch's at "
          f"{at_whole.count(False)} site(s)")
    check(all(o for o, i in zip(at_one, same_in) if i),
          "mesh int8 dynamic: a site whose whole batch is bit-equal to one "
          "slot's quantizes at another scale")
    check(got[logits].shape == want[logits].shape
          and bool(torch.isfinite(got[logits]).all()),
          "mesh int8 dynamic: bad or non-finite logits")
    check(err <= tol, f"mesh int8 dynamic: logits mrd {err:.3g} > {tol:g}")
    check(counts1 == {**INT8_LAUNCHES, "qconv": sites,
                      "act_quantize": sites},
          f"mesh int8 dynamic: one slot launched {counts1}")
    check(counts == {k: n * v + (n * sites if k == "absmax" else 0)
                     for k, v in counts1.items()} and pmax_calls == sites,
          f"mesh int8 dynamic: launches {nz}, pmax {pmax_calls} calls; "
          f"planned per slot {counts1} + {sites} absmax, {sites} pmax")
    p["mesh"]["int8_dynamic"] = {
        "logits_mrd": err, "prob_mrd": err_prob, "ms": ms,
        "ms_unsharded": ms1, "s_act_whole_batch_sites": sum(at_whole),
        "s_act_one_slot_sites": sum(at_one),
        "inputs_one_slot_sites": sum(same_in), "s_act_max_rd": s_rd,
        "first_float_node_apart": apart_s,
        "routes": dict(msh.fwd.routes), "launches": nz,
        "launches_per_slot": {k: v / n for k, v in nz.items()},
        "pmax_calls": pmax_calls}
    del one, msh, got, want, q_one, q_mesh, whole, s_whole
    torch.cuda.empty_cache()


def _par_mesh_train_dropout(p: dict, wrappers: dict) -> None:
    """GoogLeNet (googlenet_conv, whose pool5/drop_7x7_s1 drops in train
    mode) b32 224^2 on the 2x2 mesh under () with train_dropout=1 and a fed
    seed, its logits (prob saturates at random weights) within
    PAR_DROPOUT_MRD of one slot's; B1 and B2 launched as every slot runs
    every step once; the mask live (another seed moves the logits)."""
    import torch
    from boda_tpu_torch.engine.lower import DROP_SEED_NODE
    dp, mp = PAR_MESH
    n = dp * mp
    one, msh, inputs = _mesh_pair("googlenet_conv",
                                  "op_tune=(),train_dropout=1",
                                  seed=PAR_DROPOUT_SEED)
    other = {**inputs, DROP_SEED_NODE: inputs[DROP_SEED_NODE] + 1}
    logits = _logits_node(one.plan)
    with torch.no_grad():
        want = one.fwd(inputs, one.weights, out_nodes=[logits])
        want2 = one.fwd(other, one.weights, out_nodes=[logits])[logits]
        msh.fwd(inputs, msh.weights)  # builds the column sigs' plans
        torch.cuda.synchronize()
        _counts_reset(wrappers)
        got = msh.fwd(inputs, msh.weights, out_nodes=[logits])
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        ms = cuda_ms(lambda: msh.fwd(inputs, msh.weights), 5)
        ms1 = cuda_ms(lambda: one.fwd(inputs, one.weights), 5)
    p["launches"]["parallel:mesh_train_dropout"] = counts
    planned = {k: n * v
               for k, v in _planned_launches(one.plan, counts).items()}
    err = mrd(got[logits].float(), want[logits].float())
    err_prob = mrd(got["prob"].float(), want["prob"].float())
    live = mrd(want2.float(), want[logits].float())
    nz = {k: v for k, v in counts.items() if v}
    print(f"mesh {dp}x{mp} googlenet_conv b{PAR_BATCH} () train_dropout "
          f"seed {PAR_DROPOUT_SEED}: logits mrd {err:.3g} (<= "
          f"{PAR_DROPOUT_MRD:g}), prob {err_prob:.3g} vs one slot (seed "
          f"{PAR_DROPOUT_SEED + 1}: logits {live:.3g}); "
          f"{ms:.3f} ms vs {ms1:.3f} ms; routes {msh.fwd.routes}; launches "
          f"{nz} ({ {k: v / n for k, v in nz.items()} } per slot) on "
          f"[{p['smi']}]")
    check(got[logits].shape == want[logits].shape
          and bool(torch.isfinite(got[logits]).all()),
          "mesh train_dropout: bad or non-finite logits")
    check(err <= PAR_DROPOUT_MRD,
          f"mesh train_dropout: logits mrd {err:.3g} > {PAR_DROPOUT_MRD:g}")
    check(live > PAR_DROPOUT_MRD, f"mesh train_dropout: another seed moved "
                                  f"the output by {live:.3g} only")
    check(counts == planned and counts["matmul_ext"] > 0
          and counts["tconv"] > 0,
          f"mesh train_dropout: launches {nz} != planned "
          f"{ {k: v for k, v in planned.items() if v} }")
    p["mesh"]["googlenet_train_dropout"] = {
        "logits_mrd": err, "prob_mrd": err_prob, "other_seed_mrd": live,
        "ms": ms, "ms_unsharded": ms1,
        "routes": dict(msh.fwd.routes), "launches": nz,
        "launches_per_slot": {k: v / n for k, v in nz.items()}}
    del one, msh, got, want, want2
    torch.cuda.empty_cache()


def _logits_node(plan) -> str:
    """The node the plan's last output (the softmax's prob) is computed
    from."""
    top = plan.output_nodes[-1]
    for s in plan.steps:
        if s.arg_nodes.get("out") == top:
            return s.arg_nodes["in"]
    raise SmokeFailure(f"no step writes {top}")


def mh_logits_run(mesh) -> dict:
    """mh_test's ResNet-50 b32 224^2, on its input (randn * 0.1, seed 0) and
    labels (seed 1), over `mesh` (every rank's slots, or one slot): the
    forward under () and one SGD step (lr 0.01) under the f32 vendor tune
    (dryrun.TRAIN_TUNE) whose loss is the softmax-CE of the logits, the
    node under the softmax (its gradient does not vanish where the softmax
    saturates, as mh_test's log(prob) does at random weights). Over several
    ranks the step sums the ranks' gradients (sum_over_ranks), as mh_test
    --train=1 does. {"prob", "logits": the forward's digests, "loss",
    "step_ms", "collectives_ms", "updates": {weight: digest of w - w'}};
    digests as lexp text."""
    import numpy as np
    import torch
    from boda_tpu_torch.apps.train import build_train_step
    from boda_tpu_torch.core.digest import nda_digest
    from boda_tpu_torch.core.timers import global_timer_log
    from boda_tpu_torch.engine.torch_fwd import build_forward
    from boda_tpu_torch.parallel.dryrun import TRAIN_TUNE, _fused_for
    from boda_tpu_torch.parallel.mesh import COLLECTIVE_TIMER, \
        sum_over_ranks
    dev = mesh.device(mesh.local_positions()[0])
    res = {}
    for tune in ("", TRAIN_TUNE):
        pipe, plan, _f, w = _fused_for(MH_ARGS_MODEL, tune=tune, device=dev,
                                       batch=PAR_BATCH, ysz=MH_HW,
                                       xsz=MH_HW)
        fwd = build_forward(plan, mesh=mesh)
        top, logits = plan.output_nodes[-1], _logits_node(plan)
        x = torch.from_numpy(np.random.RandomState(0).randn(
            *pipe.get_data_img_dims().shape).astype(np.float32) * 0.1).to(dev)
        if not tune:
            with torch.no_grad():
                o = fwd({"data": x}, w, out_nodes=[logits])
            res["prob"] = str(nda_digest(o[top].cpu().numpy()))
            res["logits"] = str(nda_digest(o[logits].cpu().numpy()))
            continue
        labels = torch.from_numpy(np.random.RandomState(1).randint(
            0, plan.node_dims[top].shape[1], size=(PAR_BATCH,)).astype(
                np.int32)).to(dev)
        step = build_train_step(
            lambda ins, ww: fwd(ins, ww, out_nodes=[logits]), "data",
            logits, lr=0.01,
                                from_logits=True,
                                grad_reduce=lambda g: sum_over_ranks(mesh, g))
        step(w, {}, x, labels)  # builds the kernels, warms the libraries
        torch.cuda.synchronize()
        c0 = global_timer_log.tags.get(COLLECTIVE_TIMER, (0, 0.0))[1]
        t0 = time.perf_counter()
        loss, new_w, _vel = step(w, {}, x, labels)
        torch.cuda.synchronize()
        res["step_ms"] = (time.perf_counter() - t0) * 1e3
        res["collectives_ms"] = (global_timer_log.tags.get(
            COLLECTIVE_TIMER, (0, 0.0))[1] - c0) * 1e3
        res["loss"] = float(loss)
        res["updates"] = {k: str(nda_digest((w[k] - new_w[k]).cpu().numpy()))
                          for k in sorted(new_w)}
    return res


def _digest_rd(a: str, b: str) -> float:
    """The largest difference of two digests' statistics (vmin, vmax, avg,
    rms) relative to their largest magnitude: what Digest.comp holds to
    its mrd_toler."""
    from boda_tpu_torch.core.digest import Digest
    da, db = Digest.from_lexp(a), Digest.from_lexp(b)
    scale = max(abs(da.vmin), abs(da.vmax), abs(db.vmin), abs(db.vmax),
                1e-30)
    return max(abs(getattr(da, k) - getattr(db, k)) / scale
               for k in ("vmin", "vmax", "avg", "rms"))


def _par_mh_test(p: dict) -> None:
    """mh_test on the card: two ranks launched here with --spawn=0 (one
    slot of the card each, gloo between them), the forward and then one
    training step, the two ranks' digests identical and the forward's prob
    within 1e-4 (mrd) of one slot's; then the gradient check
    (mh_logits_run) over two ranks against one slot in this process; then
    a mesh of one through the CLI's own spawn path."""
    import json
    import torch
    from boda_tpu_torch.core.device import LOCAL_DEVICES_ENV, get_device
    from boda_tpu_torch.core.digest import Digest
    from boda_tpu_torch.parallel.mesh import Mesh
    from boda_tpu_torch.parallel.multihost import free_port
    env = {LOCAL_DEVICES_ENV: None}  # one slot per rank
    t0 = time.perf_counter()
    ref = mh_logits_run(Mesh([[get_device("cuda")]], ("dp", "mp")))
    torch.cuda.empty_cache()
    print(f"  one slot: loss {ref['loss']:.6f}, step {ref['step_ms']:.3f} ms "
          f"({time.perf_counter() - t0:.1f} s)")
    # mh_test's forward and its training step; at random weights its
    # log(prob) loss saturates (loss = -log 1e-30) and passes no gradient,
    # so the step's digest holds the ranks to each other only
    for key, train in (("forward", 0), ("train", 1)):
        coord = f"localhost:{free_port()}"
        t0 = time.perf_counter()
        outs = _run_procs(
            [[sys.executable, "-m", "boda_tpu_torch", "mh_test",
              f"--coordinator={coord}", "--num-processes=2",
              f"--process-id={r}", "--spawn=0", *MH_ARGS,
              f"--train={train}"] for r in range(2)],
            f"mh_test {key}", env)
        wall = time.perf_counter() - t0
        lines = []
        for r, (rc, out) in enumerate(outs):
            check(rc == 0, f"mh_test rank {r} {key}: exit {rc}: "
                           f"{out[-1500:]}")
            dl = [ln for ln in out.splitlines() if "digest (" in ln]
            tl = [ln for ln in out.splitlines() if "collectives_ms=" in ln]
            check(len(dl) == 1 and len(tl) == 1,
                  f"mh_test rank {r}: no digest/timing line: {out[-1500:]}")
            lines.append((tl[0], dl[0]))
            print(f"  {tl[0]}")
        digests = [d.split("digest ", 1)[1] for _t, d in lines]
        print(f"  {lines[0][1][:200]}...")
        check(digests[0] == digests[1],
              f"mh_test {key}: the ranks' digests differ:\n"
              f"{digests[0]}\n{digests[1]}")
        tms = [float(re.search(r" ms=([0-9.]+)", t).group(1))
               for t, _d in lines]
        cms = [float(re.search(r"collectives_ms=([0-9.]+)", t).group(1))
               for t, _d in lines]
        p["mh_test"][key] = {"ms": tms, "collectives_ms": cms,
                             "collective_share": [c / t for c, t in
                                                  zip(cms, tms)],
                             "wall_s": wall, "digest_line": lines[0][1]}
        if key == "forward":
            cmp = Digest.from_lexp(ref["prob"]).comp(
                Digest.from_lexp(digests[0]), mrd_toler=F32_MRD)
            print(f"  two ranks' prob vs one slot's: "
                  f"{cmp or f'within mrd {F32_MRD:g}'}")
            check(cmp is None, f"mh_test forward vs one slot: {cmp}")
        print(f"mh_test 2 ranks {key}: identical digests; rank ms "
              f"{tms}, collectives ms {cms} ({wall:.1f} s wall) on "
              f"[{p['smi']}]")
    coord = f"localhost:{free_port()}"
    t0 = time.perf_counter()
    outs = _run_procs([[sys.executable, "-c", MH_GRADS_RANK, coord, str(r)]
                       for r in range(2)], "gradient check", env)
    wall = time.perf_counter() - t0
    ranks = []
    for r, (rc, out) in enumerate(outs):
        got = [ln for ln in out.splitlines() if ln.startswith("MH_GRADS ")]
        check(rc == 0 and len(got) == 1,
              f"gradient check rank {r}: exit {rc}: {out[-1500:]}")
        ranks.append(json.loads(got[0].split(" ", 1)[1]))
    same = {k: ranks[0][k] == ranks[1][k]
            for k in ("prob", "logits", "loss", "updates")}
    check(all(same.values()), f"gradient check: the ranks differ in "
          f"{[k for k, v in same.items() if not v]}")
    got = ranks[0]
    errs = []
    cmp = Digest.from_lexp(ref["logits"]).comp(
        Digest.from_lexp(got["logits"]), mrd_toler=MH_LOGITS_MRD)
    if cmp:
        errs.append(f"logits: {cmp}")
    rd_logits = _digest_rd(ref["logits"], got["logits"])
    rd_updates = max(_digest_rd(d, got["updates"][k])
                     for k, d in ref["updates"].items()
                     if k in got["updates"])
    if abs(got["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
        errs.append(f"loss {got['loss']} != {ref['loss']}")
    check(sorted(got["updates"]) == sorted(ref["updates"]),
          "gradient check: the ranks update other weights than one slot")
    moved = 0
    for k, d in ref["updates"].items():
        want = Digest.from_lexp(d)
        moved += want.rms > 0
        cmp = want.comp(Digest.from_lexp(got["updates"][k]),
                        mrd_toler=MH_UPDATE_MRD)
        if cmp:
            errs.append(f"{k}: {cmp}")
    n = len(ref["updates"])
    print(f"gradient check, 2 ranks vs one slot: loss {got['loss']:.6f} "
          f"({ref['loss']:.6f}), logits rd {rd_logits:.3g} (<= "
          f"{MH_LOGITS_MRD:g}), {moved}/{n} weights moved, largest update "
          f"rd {rd_updates:.3g} (<= {MH_UPDATE_MRD:g}): "
          f"{'ok' if not errs else errs[:4]}; rank step "
          f"{got['step_ms']:.3f} ms (one slot {ref['step_ms']:.3f} ms), "
          f"collectives {got['collectives_ms']:.3f} ms ({wall:.1f} s wall) "
          f"on [{p['smi']}]")
    check(not errs, f"gradient check: {errs[:6]}")
    check(moved == n, f"gradient check: {n - moved} of {n} weights have a "
          f"zero update on one slot")
    p["mh_test"]["grads"] = {
        "loss": got["loss"], "loss_one_slot": ref["loss"],
        "logits_rd": rd_logits, "largest_update_rd": rd_updates,
        "weights_moved": moved, "weights": n,
        "step_ms": [r["step_ms"] for r in ranks],
        "step_ms_one_slot": ref["step_ms"],
        "collectives_ms": [r["collectives_ms"] for r in ranks],
        "collective_share": [r["collectives_ms"] / r["step_ms"]
                             for r in ranks], "wall_s": wall}
    t0 = time.perf_counter()
    (rc, out), = _run_procs([[sys.executable, "-m", "boda_tpu_torch",
                              "mh_test", "--num-processes=1", *MH_ARGS]],
                            "mh_test --num-processes=1", env)
    check(rc == 0 and "mh_test PASSED ranks=1" in out
          and "global_devices=1" in out,
          f"mh_test --num-processes=1: exit {rc}: {out[-1500:]}")
    print(f"mh_test --num-processes=1: PASSED "
          f"({time.perf_counter() - t0:.1f} s)")


def _par_pipelines(p: dict, wrappers: dict) -> None:
    """pp_test through the CLI on 4 slots of the card (ResNet-50 224^2, both
    schedules, tol 1e-4 under the f32 vendor tune), then gpipe_plan_forward
    under () in this process: within 1e-5 of the sequential segments, B1
    and B2 launched once per step per microbatch."""
    import numpy as np
    import torch
    from boda_tpu_torch.engine.lower import lower_pipe
    from boda_tpu_torch.engine.segments import build_plan_segments
    from boda_tpu_torch.engine.torch_fwd import _storage_in, weights_to_torch
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.parallel.dryrun import RESNET_STAGES
    from boda_tpu_torch.parallel.mesh import Mesh
    from boda_tpu_torch.parallel.pipeline import gpipe_plan_forward
    from boda_tpu_torch.core.device import LOCAL_DEVICES_ENV, get_device
    t0 = time.perf_counter()
    (rc, out), = _run_procs([[sys.executable, "-m", "boda_tpu_torch",
                              *PP_ARGS]], "pp_test",
                            {LOCAL_DEVICES_ENV: str(PP_STAGES)})
    wall = time.perf_counter() - t0
    passed = re.findall(r"^pp_test \S+ .*PASSED.*$", out, re.M)
    for ln in passed:
        print(f"  {ln}")
    check(rc == 0 and len(passed) == 2,
          f"pp_test: exit {rc}: {out[-2000:]}")
    p["pp_test"] = {"lines": passed, "wall_s": wall}
    print(f"{' '.join(PP_ARGS)} on {PP_STAGES} slots: both schedules "
          f"PASSED ({wall:.1f} s wall)")

    dev = get_device("cuda")
    pipe = build_model("resnet-50", batch=2)
    plan = lower_pipe(pipe)
    w = weights_to_torch(plan, pipe.op_params, dev)
    segs = build_plan_segments(plan, w, RESNET_STAGES + "+prob", dev)
    mesh = Mesh([dev] * PP_STAGES, ("pp",))
    x_mb = (np.random.RandomState(0).randn(
        PP_MICROBATCHES, *pipe.get_data_img_dims().shape) * 0.1
            ).astype(np.float32)
    gpipe_plan_forward(plan, segs, w, x_mb, mesh)  # warm
    torch.cuda.synchronize()
    _counts_reset(wrappers)
    t0 = time.perf_counter()
    got = gpipe_plan_forward(plan, segs, w, x_mb, mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: wk.launches for k, wk in wrappers.items()}
    p["launches"]["parallel:gpipe_forward"] = counts
    t0 = time.perf_counter()
    with torch.no_grad():
        want = []
        for xm in x_mb:
            v = _storage_in(torch.from_numpy(xm).to(dev),
                            plan.node_dims["data"], plan)
            for s in segs:
                v = s.fn(v, *[w[n] for n in s.weight_names])
            want.append(v)
        want = torch.stack(want)
    torch.cuda.synchronize()
    ms_seq = (time.perf_counter() - t0) * 1e3
    err = mrd(got.float(), want.float())
    nz = {k: v for k, v in counts.items() if v}
    planned = {k: PP_MICROBATCHES * v for k, v in UNFUSED_LAUNCHES.items()
               if v}
    print(f"gpipe_plan_forward resnet-50 224^2 b2 () pp={PP_STAGES} "
          f"M={PP_MICROBATCHES}: mrd {err:.3g} vs sequential; launches {nz}; "
          f"{ms:.3f} ms vs {ms_seq:.3f} ms sequential (host clock) on "
          f"[{p['smi']}]")
    check(err <= 1e-5, f"gpipe_plan_forward: mrd {err:.3g} > 1e-5")
    check(nz == planned, f"gpipe_plan_forward: launches {nz} != {planned}")
    p["gpipe_forward"] = {"mrd": err, "ms": ms, "ms_sequential": ms_seq,
                          "launches": nz}


def _par_dryrun(p: dict, wrappers: dict) -> None:
    """dryrun_multichip(8) on 8 slots of the card."""
    import torch
    from boda_tpu_torch.parallel.dryrun import dryrun_multichip
    _counts_reset(wrappers)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(PAR_SLOTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    p["launches"]["parallel:dryrun"] = counts
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        print(f"  {ln}")
    check(len([ln for ln in lines if "dryrun_multichip OK" in ln]) == 6,
          f"dryrun_multichip: {lines}")
    check(counts["matmul_ext"] > 0 and counts["tconv"] > 0,
          f"dryrun_multichip: no B1/B2 launch ({counts})")
    p["dryrun"] = {"lines": lines, "wall_s": wall,
                   "launches": {k: v for k, v in counts.items() if v}}
    print(f"dryrun_multichip({PAR_SLOTS}) on {PAR_SLOTS} slots: {wall:.1f} s, "
          f"launches { {k: v for k, v in counts.items() if v} }")


def phase_parallel(ctx: dict) -> None:
    """Parallel and multi-process on the card, every path at 224^2 on slots
    of the one card: the engine's 2x2 mesh (three tunes; the int8 preset
    with dynamic scales; GoogLeNet's train-mode dropout), mh_test's ranks,
    pp_test and gpipe_plan_forward, and dryrun_multichip(8)."""
    wrappers = _wrappers()
    p = {"smi": ctx["smi"], "launches": ctx.setdefault("launches", {}),
         "mesh": {}, "mh_test": {}}
    with _slots(PAR_SLOTS):
        for step in (lambda: _par_mesh_engine(p, wrappers),
                     lambda: _par_mesh_int8_dynamic(p, wrappers),
                     lambda: _par_mesh_train_dropout(p, wrappers),
                     lambda: _par_mh_test(p),
                     lambda: _par_pipelines(p, wrappers),
                     lambda: _par_dryrun(p, wrappers)):
            t0 = time.perf_counter()
            step()
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    ctx["parallel"] = {k: v for k, v in p.items()
                       if k not in ("smi", "launches")}


PHASES = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
          "vendor": phase_vendor, "gconv": phase_gconv,
          "digests": phase_digests,
          "agree": phase_agree, "full": phase_full, "engine": phase_engine,
          "upload": phase_upload,
          "ops_prof": phase_ops_prof, "zoo": phase_zoo, "serve": phase_serve,
          "pyra": phase_pyra, "train": phase_train, "tune": phase_tune,
          "cli": phase_cli, "parallel": phase_parallel,
          "bench": phase_bench}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run, in order (default: "
                         "all; the result lines need all)")
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels the kernels phase is cut "
                         "down to (matmul_ext, tconv, fused_stem, resblock, "
                         "sgemm_int8, qconv); no result lines then")
    opts = ap.parse_args()
    phases = opts.phases.split(",")
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown} (have: {','.join(PHASES)})")
    only_kernels = [k for k in opts.kernels.split(",") if k]
    unknown = [k for k in only_kernels if k not in SOURCES]
    if unknown:
        ap.error(f"unknown kernels {unknown} (have: {','.join(SOURCES)})")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card, "
              "nothing run", file=sys.stderr)
        return 1
    if not (ROOT / "boda_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repo "
              "(boda_tpu_torch/csrc missing)", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import boda_tpu_torch.modes  # noqa: F401  (the port's modes and engine)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx: dict = {"smi": smi_line(), "only_kernels": only_kernels}
    for name in phases:
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        PHASES[name](ctx)
        print(f"== phase {name} passed ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    for pkg in ("jax", "boda_tpu"):
        if pkg in sys.modules:
            raise SmokeFailure(f"{pkg} was imported")
    if phases != list(PHASES) or only_kernels:
        print(f"chip_smoke: phases {phases} passed"
              f"{' for kernels ' + str(only_kernels) if only_kernels else ''}"
              f"; no result without all of them")
        return 0

    kernels = []
    for name, s in ctx["kernels"].items():
        by_tune = {t: c[name] for t, c in ctx["launches"].items()}
        kernels.append({**s, "launches": by_tune[KERNEL_PATH[name]],
                        "launches_by_tune": by_tune})
        if name == "sgemm_int8":
            kernels[-1]["quantize_launches"] = \
                ctx["launches"]["ops_prof"]["quantize"]
        if name == "qconv":
            kernels[-1]["quantize_launches"] = \
                ctx["launches"][INT8]["act_quantize"]
            # its dynamic scale under a dp split: each slot's absmax, one
            # pmax per step (the 2x2 mesh's forward)
            dyn = ctx["launches"]["parallel:mesh_int8_dynamic"]
            kernels[-1]["dp_split_launches"] = {
                k: dyn[k] for k in ("qconv", "act_quantize", "absmax")}
            kernels[-1]["dp_split_pmax_calls"] = \
                ctx["parallel"]["mesh"]["int8_dynamic"]["pmax_calls"]
    # B6 in the training path's role: the int8 weight gradients of the
    # grad_q8 preset's cnet_train run
    wg = ctx["train"]["wgrad"]
    q8_run = ctx["launches"]["train:grad_q8"]
    kernels.append({**wg, "launches": q8_run["qconv"],
                    "quantize_launches": q8_run["act_quantize"],
                    "cotangent_quantize_launches":
                        q8_run["cotangent_quantize"],
                    "launches_by_tune": {
                        t: c["qconv"] for t, c in ctx["launches"].items()
                        if t.startswith("train")}})
    print(ctx["bench"])
    print(smi_line())
    print(json.dumps({"kernels": kernels,
                      "forward_ms_b32": ctx["fwd_ms"],
                      "forward_ms_b128": ctx["fwd_ms_b128"],
                      "device_busy_ms_b32": ctx["busy_ms"],
                      "template_ms_b32": ctx["template_ms"],
                      "engine": ctx["engine"], "upload": ctx["upload"],
                      "vendor_conv_ms_b32": ctx["vendor_ms"],
                      "zoo": ctx["zoo"], "serve": ctx["serve"],
                      "pyra": ctx["pyra"], "train": ctx["train"],
                      "tune": ctx["tune"], "cli": ctx["cli"],
                      "parallel": ctx["parallel"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
