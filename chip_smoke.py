#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (vlbert_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (built and checked for an NVIDIA H100) and the CUDA
toolkit (``nvcc``); exits non-zero without a card. Phases, each printing
its own line:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the kernels from vlbert_tpu_torch/csrc at first use;
  3. kernel parity: ROIAlign (K1; fp32 and bf16 maps, fp32 and bf16
     output, sampling ratio 1, 0 and 2) at the serve shape, at B=2 with 37
     slots, at the RefCOCO+ test driver's B=4 with 108 slots, at VCR's
     B=4 on 600x1200 canvases with 108 slots, on the portrait map of a
     640x480 query and at an odd C, and attention (K2 on the tensor cores;
     fp32 by a three-product TF32 split) at L = 1, 41, 63, 64, 65, 128 (B=16
     and test_net_vqa's B=64) and 173 (B=1, test_net_refcoco's B=4 and
     VCR's 4 questions x 4 choices, B=16) against their plain PyTorch
     versions, with device times (profiler) and per-call CUDA-event times
     for both (K2 in bf16 and fp32 at L = 41, 128 and 173); K1 also timed
     by kernel name with its kernels per call, and
     the three ops the main path ran before K1 stored the compute dtype
     (the mask's conversion, the fp32-out K1, the cast);
  4. serve: ResNetVLBERTForRefCOCO from cfgs/refcoco/base_gt_boxes_4x16G.yaml
     at full width (ResNet-101, VL-BERT 768 x 12 layers x 12 heads, vocab
     30522), random weights from a fixed seed, bf16 compute, behind the
     port's RefCOCOServer; answers 8 distinct queries and checks that each
     launched K1 once and K2 twelve times;
  5. end-to-end agreement: the same weights in fp32, one query, with the
     kernels (K1 once, the fp32 K2 12 times) and with their plain versions;
  6. training-kernel parity at the VQA training shapes, fp32 and bf16:
     dropout (K5) forward and backward, also at odd sizes and on views
     that start off a 16-byte boundary, attention with prob dropout
     forward (K3) and backward (K4), on the tensor cores in both dtypes
     (fp32 by the TF32 split), at L = 128, 41 and 173, and K2's
     backward, each against its plain version in explicit-bits and Philox
     mode (timed in bf16 and fp32 at the VQA step's B=16 L=128 and VCR's
     B=16 L=173); the kernels' keep masks are read back exactly in both dtypes and must equal the
     plain Philox's bit for bit, the backward must replay the forward's
     mask, the keep fraction must lie within 5 sigma of 1 - rate and two
     seeds must differ; a K4 repeated on the same inputs must give
     bit-identical gradients in both dtypes. Then the yardsticks: one
     PyTorch library call per kernel that computes the same function
     (scaled_dot_product_attention, also in fp32 at K2's timed shapes,
     with dropout and its backward beside the fp32 K3 and K4, dropout),
     timed and never used by the port, and the SASS instructions of one
     Philox evaluation, for each kernel's Philox floor;
  7. train: train_net (python -m vlbert_tpu_torch.engine.train) on a
     synthetic VQA set in the dataset's on-disk format, from
     cfgs/vqa/base_v5e_bf16.yaml at full width (VL-BERT 768 x 12 x 12,
     3129 answers, batch 16, L = 32 + 95 + 1 = 128, bf16), random weights
     from seed 0, with the printed overrides; the loss must fall, every
     step must launch K3 12, K4 12, K5 27 (forward) and 26 (backward)
     times, and validation must run K2; train_net's checkpoint of each
     epoch is recorded, not written, so that no write overlaps the timed
     steps; then a profiler window over a few steps, and the same run
     with the writes made (the background writer) for what they cost;
  8. fp32 train-step agreement: one step from the same weights and seed
     with the kernels and with the plain versions (plain Philox, so the
     same masks): loss, gradient norm, every gradient leaf and the updated
     weights; and a repeat of the kernel step that must give
     bit-identical parameters; the kernel step's attention device ms by
     kernel name (profiler);
  9. train -> checkpoint -> resume: train_net from the same config on
     phase 7's set, warm-started through NETWORK.PARTIAL_PRETRAIN from a
     reference-layout pretrain checkpoint the script writes (``module.``
     prefix, the MLM transform where the classifier's goes, no answer
     head) with the shipped prefix changes: every parameter but the answer
     head must come from the file unchanged; 2 epochs of 4 steps with a
     checkpoint each, then AUTO_RESUME to epoch 3 must begin at epoch 2
     with the optimizer count 8 and run exactly 4 more steps; save and
     load seconds and the file size at base width;
  10. VQA server: phase 9's -best.model in VQAServer (bucket 64 text + 108
     boxes, L = 173), bf16, 8 distinct questions, each launching K2 12
     times and no other kernel; latency p50 / p90; then fp32 logits with
     the kernels (K2 12 launches) and with the plain versions on one
     query;
  11. test drivers: test_net_vqa on a 64-question test split from phase
     9's checkpoint (K2 12 launches a batch), and ``python -m
     vlbert_tpu_torch.engine.test --task refcoco`` (its ``main``) from
     cfgs/refcoco/base_gt_boxes_4x16G.yaml on 16 synthetic referring
     expressions over phase 4's landscape images, from a script-written
     reference-layout ``.model`` (``module.`` and ``vlbert._module.``):
     batch 4, so K1 4 and K2 48 launches; pred-box rows, IoU@0.5 accuracy,
     samples/s of each test driver's inference loop; fp32 kernels and plain
     versions must predict identical boxes on one batch;
  12. VCR: the shipped base Q2A and QA2R configs at full width
     (cfgs/vcr/base_{q2a,qa2r}_4x16G_fp32.yaml: ResNet-101 C4 with a
     dilated conv5, 14x14 ROIAlign and instance masks, VL-BERT 768 x 12 x
     12, bf16) on a synthetic split the script writes (16 questions over 4
     landscape and 4 portrait JPEGs with 3-107 boxes and polygon segms, 4
     answers and 4 rationales each), from a reference-layout ``.model`` of
     seed-0 weights: ``python -m vlbert_tpu_torch.engine.test --task vcr``
     for Q2A val and test (batch 4 x 4 choices, L = 173: K1 once and K2 12
     times a batch) and the answer-conditioned QA2R test (4 passes a
     batch), ``merge_vcr_results``, ``python -m
     vlbert_tpu_torch.engine.vcr_val`` and the single-model Q2AR through
     ``make_validation_fn`` (one visual pass, two text passes), each with
     exact launch counts; the warm inference loops' samples/s and device
     idle share; fp32 kernels vs plain versions on one batch: logits within
     1e-3 and the same argmax for each question;
  13. training from pixels: the ROIAlign backward (K1b) against its plain
     version on phase 3's K1 cases (fp32 and bf16 g and dF, sampling
     ratio 1, 0 and 2; the padded slots' g must not reach dF), each call
     repeated bit for bit, and timed at VCR's training shape (and
     RefCOCO+'s) beside its bound, its plain version and the backward of
     K1's grid_sample yardstick; then ``python -m vlbert_tpu_torch.engine.train --task vcr``
     (its ``main``) from the shipped base Q2A config at full width (bf16,
     SGD, 4 micro-steps of 4 images x 4 choices) on 64 synthetic training
     questions over phase 12's JPEGs, with the printed overrides: 8
     optimizer steps, each launching K1 4, K1b 4, K3 48, K4 48 and K5 108
     times forward and backward, each validation run K1 and K2 only, a
     falling loss, the epochs' checkpoints, and a second ``main`` that
     AUTO_RESUMEs past the last; step p50, peak memory and a profiler
     window's idle share; an fp32 optimizer step with the kernels and with
     the plain versions (plain ROIAlign too), every gradient leaf held,
     stages 3-4 and the RoI head apart, and its attention device ms by
     kernel name; then ``--task refcoco`` from the
     shipped RefCOCO+ config on phase 11's expressions: 8 AdamW steps with
     exact launches, a falling loss, RefAcc from validation;
  14. pretraining from pixels: ``python -m vlbert_tpu_torch.engine.train
     --task pretrain`` (its ``main``) from the shipped
     cfgs/pretrain/base_e2e_16x16G_fp16.yaml at full width (ResNet-101
     C4, VL-BERT 768 x 12 x 12 with the MLM head tied to the 30522-word
     table and the 1601-class MVRC head, bf16, AdamW) on a synthetic
     Conceptual Captions split the script writes (32 landscape and
     portrait JPEGs, 10-100 boxes each with softmax class scores, jsonl
     captions) and a text corpus: 8 optimizer steps of 8 caption and 8
     corpus rows (L = 64 + 108 + 1), each launching K1 1, K1b 1, K3 12,
     K4 12 and K5 26 times forward and backward, no validation, a
     falling loss with its MLM, corpus MLM and MVRC parts and the MLM /
     MVRC accuracies logged, the epochs' checkpoints in the reference
     layout (the tied decoder stored once, -best.model mirrored), and a
     second ``main`` that AUTO_RESUMEs past the last; step p50, peak
     memory and a profiler window's idle share; then one fp32 optimizer
     step of cfgs/pretrain/base_prec_4x16G_fp32.yaml on precomputed
     features (32 + 32 rows) with the kernels and with the plain
     versions, every gradient leaf held;
  15. VL-BERT-large (24 layers x 1024 x 16 heads): K2, K3, K4 at 16 heads
     (B=16 L=173, fp32 and bf16) and K5 at [16, 173, 1024] against their
     plain versions, keep masks at 16 heads bit for bit, each timed
     beside its library call; then ``python -m
     vlbert_tpu_torch.engine.train --task vcr`` from the shipped
     cfgs/vcr/large_q2a_4x16G_fp16.yaml (TRAIN.FP16 -> bf16, SGD, 4
     micro-steps of 4 images x 4 choices) on phase 13's fixture and
     overrides: 8 steps, each launching K1 4, K1b 4, K3 96, K4 96 and K5
     204 times forward and backward, one validation run (K2 24 a batch),
     a falling loss, a profiler window; one step on its first batch with
     TPU.REMAT off and on from the same weights and seed (the same loss,
     every gradient leaf within 1e-5 of its largest element, K3 and the
     encoder's K5 sites launched twice a layer), peak memory and step
     time of each; the peak of one step of the shipped
     cfgs/vcr/large_q2a_v5e_bf16.yaml batch of 16 images, REMAT off and
     on (REMAT must lower it); an fp32 step of cfgs/vqa/large_4x16G_fp32.
     yaml with the kernels and with the plain versions (phase 8's bar);
     RefCOCOServer on cfgs/refcoco/large_gt_boxes_4x16G.yaml over phase
     4's queries (K1 1, K2 24 a query), p50 / p90;
  16. data parallelism (TPU.PARTITION_MODE dp), each rank a child process
     with torchrun's environment and a free port (the card's machine has
     one card: NCCL refuses two ranks on one device, so NCCL runs at one
     rank and two ranks share the card over gloo): (a) phase 7's config
     on a synthetic set of 128 questions, 8 steps of 16, through
     ``python -m vlbert_tpu_torch.engine.train --dist --dist-backend
     nccl`` at one rank beside the same run without ``--dist``: the same
     losses and final parameters bit for bit, phase 7's launches a step;
     (b) the same at two gloo ranks on cuda:0, 16 a rank, 2 epochs: a
     falling loss, both ranks' parameters bit for bit, phase 7's
     launches on each, rank 0 alone writing the checkpoints, the
     validation metric the same on both and equal to one process's over
     the whole split from the same checkpoint, AUTO_RESUME to epoch 2 on
     both; (c) one fp32 step of cfgs/pretrain/base_prec_4x16G_fp32.yaml
     on phase 14's precomputed-feature fixture at two gloo ranks with
     unequal masked counts, dropout off, against one process's step on
     the concatenated batch at phase 8's bar. Per rank the step p50, a
     profiler window's device busy time and the gradient all-reduce's
     share (informative: gloo stages through the host);
  17. int8 weight-only serving at base width: (a) phase 4's weights
     behind RefCOCOServer(quantize="int8"), bf16 compute, phase 4's 8
     queries (K1 8 and K2 96 launches), beside the same weights fp32:
     each query's box (a flip only inside 2 delta of the top-2 margin),
     max |delta logit| over the logit std, weight bytes
     (``quantized_bytes``) and what the card holds
     (``torch.cuda.memory_allocated``) for each, p50 / p90 in turns, one
     query's device busy with the dequant's kernels and share; (b) the same
     for VQAServer(quantize="int8") from phase 9's checkpoint on phase
     10's questions (K2 12 a query, no other kernel); (c) fp32 compute on
     int8 weights, kernels vs plain versions (atol 1e-3, the same argmax);
     (d) tools/int8_accuracy_torch.py's base-scale drift of the VQA and
     RefCOCO+ heads, no flip beyond the 2 delta bound;
  18. (a) ``python -m vlbert_tpu_torch.engine.vis`` (its main) on the
     shipped cfgs/pretrain/vis_attention_maps_coco.yaml at full width
     (ResNet-101, VL-BERT 768 x 12 x 12, fp32; no PARTIAL_PRETRAIN file,
     visual LN scales 1.0) over a synthetic COCO captions val split of 8
     JPEGs: 8 dumps of [12, 12, L, L] whose rows sum to 1 within 1e-5, K1
     once a batch and K2 never, the same dumps with the plain ROIAlign
     within 1e-4, ms an image; (b) one RefCOCO+ query at IMAGE_NUM_LAYERS
     18 (BasicBlock) behind RefCOCOServer, fp32 kernels vs plain versions
     at phase 5's bar, and bf16 launches;
  19. float16 training (TRAIN.FP16 with TPU.FP16_PARITY_MODE): (a) each
     kernel's fp16 route against its plain version in fp16 (K1 at the
     serve, VCR and pretraining cases to fp16 and fp32 out; K1b at VCR's
     and pretraining's shapes, repeated bit for bit; K2 at L = 1, 41, 64,
     65, 128, 173, K3 / K4 at L = 41, 128, 173, at 12 and 16 heads, masks
     and a K4 repeat bit for bit; K5 over phase 6's cases), each timed
     beside its bf16 route and an fp16 library call at VCR-large's
     shapes; (b) ``python -m vlbert_tpu_torch.engine.train --task vcr``
     from cfgs/vcr/large_q2a_4x16G_fp16.yaml on phase 15's fixture and
     overrides with TPU.FP16_PARITY_MODE and TRAIN.FP16_LOSS_SCALE 128 (the
     shipped 'dynamic' shown to raise before a model is built): the seed-0
     weights' per-stage max |activation| in fp16 beside bf16 and, where
     fp16 overflows, each frozen BN calibrated from one fp32 forward of
     the first batch (given to the run as NETWORK.IMAGE_PRETRAINED); 4 SGD
     steps of 4 micro-steps and one validation run with exact launches,
     every one on an fp16 route, finite losses and unscaled gradients,
     the first step's largest K4 and K1b outputs; its step p50 and peak
     beside phase 15a's; that batch's step in fp16 and bf16 against fp32
     (plain versions), and an fp32 step with the scale against one
     without, bit for bit;
  20. the JAX package's own checkpoints (flax msgpack, read by
     vlbert_tpu_torch/training/jax_format.py without flax) and the last
     host modules: (a) phase 9's epoch-2 state written by the port's
     msgpack writer in the JAX package's layout (flax paths, fused qkv,
     the optax chain's AdamW moments, dense and then masked, step, extra)
     and AUTO_RESUMEd by train_net beside the same state's torch file:
     weights, moments, count and plateau scale bit for bit after the
     resume, the next epoch's losses bit for bit and phase 7's launches a
     step; (b) test_net_vqa from a JAX-layout -best.model gives phase 11's
     answers with its launches; (c) PARTIAL_PRETRAIN from phase 9's
     pretrain weights in the JAX pretraining model's layout (vlbert.bert
     nesting) loads the tensors the reference-layout file loads, by name
     and value; (d) the native tokenizer's and the COCO mask codec's
     libraries built by g++ on this machine and loaded, the tokenizer's
     ids equal to the Python path's on phase 12's VCR texts and phase 7's
     questions, each path's tokens/s.

Any failure raises. Every file the phases write lives under one temporary
directory, removed on exit. On every exit it stops the processes it
started (the loader's forkserver, multiprocessing's resource tracker, any
leftover child; phase 16's rank processes stop their own, and orphans are
reparented to this process, a subreaper). The last three lines are the kernels' JSON record, the
nvidia-smi line, and {"ok": true, "device": {...}}. Kernel launches made
to compare a kernel with its plain version are not counted: each path's
counts are set to 0 just before it runs. Each kernel's record carries its
device time, its plain version's and its library call's (for K1
``F.grid_sample`` over the 14x14 bin centres, which computes ROIAlign at
sampling ratio 1 for boxes inside the map; for K1b that call's
backward), and bound_ms: the larger of the bytes it must move over 3.35 TB/s and its
operations over the H100's peak for its dtype (bound_by says which; K1's
for its main-path route, bf16 in and out, with the fp32-out route beside
it; attention's fp32 products at the faster of the CUDA cores and three
TF32 products on the tensor cores);
K3, K4 and K5 also carry philox_floor_ms, their Philox evaluations times
the instructions of one over the card's integer issue rate.
"""

import contextlib
import csv
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "cfgs", "refcoco", "base_gt_boxes_4x16G.yaml")
SEED = 0

# tolerances: fp32 kernels do the plain versions' arithmetic in another
# order; bf16 attention output is rounded once more (one bf16 step at
# |out| ~ 1 is 2**-7 ~ 8e-3). K1's bf16 output is held to the plain fp32
# result rounded to bf16 within one bf16 step (2**-7 |b|: where the two
# fp32 sums straddle a rounding boundary) plus K1_ATOL
K1_ATOL = 1e-4
K1_BF16_RTOL = 2.0 ** -7
# the same for fp16 output: one fp16 step, 2**-10 |b|
K1_FP16_RTOL = 2.0 ** -10
K2_ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 1e-2}
E2E_ATOL = 1e-3
# training kernels. K5 does one IEEE multiply per kept element, the same
# one the plain version does: exact. K3 as K2. K4 and K2's backward: fp32
# sums in another order (fp32), plus one bf16 rounding of each gradient
# (2**-8 relative), relative to max(1, max |reference|)
DROP_RATE = 0.1
K5_ATOL = 0.0
K3_ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 1e-2}
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 1e-2}
# fp16 (phase 19): the same roundings as bf16's at 2**-11 relative instead
# of 2**-8 (P for P V, the output; dS and Pd for the gradients), where one
# fp16 step of an output below 8 is 2**-8: half the bf16 tolerances hold
# them with room
VQA_CFG = os.path.join(REPO, "cfgs", "vqa", "base_v5e_bf16.yaml")
# fp32 step agreement: loss and gradient norm to rounding of sums over
# ~110M parameters. Each leaf's gradient, relative to that leaf's largest
# element: fp32 sums in another order through 12 layers of backward (the
# worst leaf read 2e-6). The key biases get a gradient that is zero in
# exact arithmetic (softmax ignores a per-row shift): both steps give
# them only rounding noise, ~1e-10 of the largest gradient element, so a
# leaf's scale is floored at LEAF_FLOOR times that element (every other
# leaf's largest element read above 2e-4 of it). An AdamW first step
# moves each weight by lr * g / (|g| + 1e-6), about lr * sign(g): a wrong
# gradient sign moves a weight 2 * lr away, while rounding moves only
# elements with |g| near 1e-6; the updated weights must agree to lr / 10
# (the reading was 1.2e-7 at lr 1e-4)
STEP_RTOL = {"loss": 1e-4, "grad_norm": 1e-3, "leaf_grad": 1e-4,
             "param_per_lr": 0.1}
LEAF_FLOOR = 1e-5
# From pixels (VCR), the leaves of the image path: the random ResNet's
# activations are large, and a weight gradient of the conv5 head or of
# stages 3-4 sums ~10^5 products of them that cancel to a far smaller
# result, behind ReLUs that a 1-ulp difference in ROIAlign's or attention's
# fp32 sums can switch; such a leaf is held to 2e-3 of its largest element
# (the worst read 4.6e-4 on the card). A wrong K1b (a dropped, doubled or
# misplaced sample) moves stage 3-4 gradients by a sizeable fraction of
# their size; phase 13's K1b parity holds the kernel itself to 1e-5
IMAGE_LEAF_RTOL = 2e-3
IMAGE_LEAF_PREFIX = "image_feature_extractor."


# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at the full
# 700 W power limit): the roofline that bound_ms is reckoned against. Each
# input byte is counted read once and each output byte written once.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
                  "tf32": 494.7e12}
# int32 ALU lanes per SM and clock on Hopper: the integer issue rate that
# a Philox evaluation's instructions are reckoned against
INT_LANES_PER_SM = 64


def roofline(bytes_moved, ops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(B, L, H, D, dtype, backward=False):
    """Roofline of attention over [B, L, H, D] q, k, v and a [B,1,1,L] fp32
    bias. Forward: reads q, k, v, bias, writes out; 2 products of 2·L²·D
    per (b, h). Backward: reads q, k, v, g, bias, writes dq, dk, dv and
    dbias; 5 products (S again, dP, dV, dQ, dK). In fp32 the products run
    on the CUDA cores or, as three TF32 products (the split that keeps
    fp32 accuracy), on the tensor cores, whichever is faster; bound_by
    names the route: "operations (fp32)" or "operations (tf32 x3)"."""
    es = 4 if dtype == "float32" else 2
    t = B * L * H * D * es
    if backward:
        nbytes, ops = 7 * t + 2 * B * L * 4, 10 * B * H * L * L * D
    else:
        nbytes, ops = 4 * t + B * L * 4, 4 * B * H * L * L * D
    if dtype != "float32":
        return roofline(nbytes, ops, dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min((ops / PEAK_OPS_PER_S["float32"] * 1e3, "operations (fp32)"),
                (3 * ops / PEAK_OPS_PER_S["tf32"] * 1e3,
                 "operations (tf32 x3)"))
    return (t_bytes, "bytes") if t_bytes >= t_ops[0] else t_ops


# Philox4x32-10 evaluations per call of each kernel that draws a mask: K5
# one per four elements; K3 one per four (query, key) elements of each
# (b, h), over the queries padded to 64-row tiles and the keys padded to
# the tiles they are streamed in (bf16 64, fp32 32); K4 (bf16) three times
# K3's, its rows pass sweeping the keys twice and its keys pass once
PHILOX_PER_CALL = {"K5": lambda n: -(-n // 4),
                   "K3": lambda B, H, L: B * H * (-(-L // 64) * 64) ** 2 // 4,
                   "K3_fp32": lambda B, H, L: B * H * (-(-L // 64) * 64)
                   * (-(-L // 32) * 32) // 4,
                   "K4": lambda B, H, L: 3 * B * H * (-(-L // 64) * 64) ** 2
                   // 4}


class HashTokenizer:
    """Deterministic hash tokenizer for random-weight runs (no vocab)."""

    cls_id, sep_id, mask_id = 101, 102, 103

    def tokenize(self, text):
        return text.lower().split()

    def convert_tokens_to_ids(self, toks):
        return [zlib.crc32(t.encode()) % 29000 + 1000 for t in toks]


def cuda_ms(fn, iters=50, warmup=5):
    """(device ms, call ms) per call of ``fn``: the route_ms and call_ms
    of ``time_calls``."""
    t = time_calls(fn, iters=iters, warmup=warmup)
    return t["route_ms"], t["call_ms"]


def event_ms(fn, iters=5, warmup=1):
    """CUDA-event ms per call of ``fn`` over ``iters`` back-to-back calls,
    no profiler window: for the slow plain versions, whose device time is
    their call time."""
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


def time_calls(fn, kernel=None, iters=50, warmup=5):
    """Per call of ``fn``: {"route_ms": the summed device time of every
    kernel and copy it runs, from a torch.profiler trace of ``iters`` calls;
    "ms": that of the kernels whose name holds ``kernel``; "call_ms": the
    CUDA-event time of back-to-back calls, which includes the host's launch
    overhead wherever the host is slower than the device;
    "kernels_per_call"; "by_kernel": {name: device ms}}. Warm: what one
    call reads stays in L2 for the next."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    by_name = device_by_name(fn, iters)
    return {"ms": sum(us for k, (us, _) in by_name.items()
                      if kernel is not None and kernel in k) / 1e3 / iters,
            "route_ms": sum(us for us, _ in by_name.values()) / 1e3 / iters,
            "call_ms": start.elapsed_time(end) / iters,
            "kernels_per_call": sum(n for _, n in by_name.values()) / iters,
            "by_kernel": {k[:60]: us / 1e3 / iters
                          for k, (us, _) in by_name.items()}}


def device_by_name(fn, iters):
    """{kernel name: (summed device µs, launches)} over ``iters`` calls of
    ``fn`` in a torch.profiler window of device activity only (host ops
    are not recorded: a window over whole training steps stays cheap to
    read). The profiler now and then returns a window without device
    events, or with some of them missing (a kernel counted a number of
    times that is not a multiple of ``iters``, when every call launches
    the same kernels); such a window is measured again, up to three times
    in all, and the fullest one is kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    windows = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.device_time, n + 1)
        total = sum(us for us, _ in by_name.values())
        if total > 0 and all(n % iters == 0 for _, n in by_name.values()):
            return by_name
        windows.append((total, by_name))
    total, by_name = max(windows, key=lambda w: w[0])
    if total == 0:
        raise AssertionError("the profiler recorded no device time in "
                             "three windows")
    return by_name


def device_us_by_name(fn, iters):
    """{kernel name: summed device µs} over ``iters`` calls of ``fn``."""
    return {k: us for k, (us, _) in device_by_name(fn, iters).items()}


# K1's kernel, by the name the profiler reports
K1_KERNEL = "roi_align_fwd_kernel"


# The serve shape's 16 box slots on a 1000x600 canvas (body4 [1,38,63,C]
# at stride 16), 14 live: edge cases first, then ordinary boxes
K1_SERVE_BOXES = (
    (0, 0, 999, 599),          # the whole canvas
    (10, 20, 300, 400),
    (900, 500, 1100, 700),     # crosses the right and bottom edges
    (-50, -50, -20, -10),      # entirely outside
    (30, 40, 30.5, 40.2),      # smaller than 1x1 on the map
    (990, 590, 1000, 600),     # on the map's far corner
    (0, 0, 8, 8),
    (500, 100, 700, 599),
    (-10, -10, 1010, 610),     # exceeds the map on every side
    (100, 100, 101, 130),
    (1000, 600, 1040, 640),    # starts at the map's far edge
    (5, 5, 995, 15),
    (200, 200, 600, 500),
    (0, 580, 999, 599),        # a strip along the bottom edge
    (0, 0, 0, 0), (0, 0, 0, 0))
K1_SERVE_LIVE = 14


def k1_serve_inputs(dev, C=1024):
    """The serve shape: fp32 body4 [1,38,63,C] from a seeded generator, the
    16 slots of K1_SERVE_BOXES and their bool mask (2 padded)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    feat = torch.randn(1, 38, 63, C, generator=g, device=dev)
    boxes = torch.tensor([K1_SERVE_BOXES], dtype=torch.float32, device=dev)
    mask = torch.zeros(1, len(K1_SERVE_BOXES), dtype=torch.bool, device=dev)
    mask[0, :K1_SERVE_LIVE] = True
    return feat, boxes, mask


def k1_cases(dev):
    """(name, fp32 map, boxes, bool mask, sampling ratios) of K1's parity:
    the serve shape; B=2 with 37 slots, the edge boxes and random ones,
    different in each image, padded slots at other places in each; the
    RefCOCO+ test driver's B=4 with 108 slots, 108, 97, 66 and 40 live;
    VCR's test batch, B=4 on 600x1200 canvases with 108 slots;
    pretraining's caption batch, B=8 on a 1000x1000 canvas with 108 slots,
    11-101 live, the whole-image box first; the
    portrait canvas a 480x640 query is padded to (1000 tall, 600 wide: map
    [1,63,38,1024]) with the serve boxes transposed; and an odd C (1032:
    129 bf16 or 258 fp32 chunks a pixel, more than a block's threads)."""
    import numpy as np
    import torch

    feat, boxes, mask = k1_serve_inputs(dev)
    yield "serve", feat, boxes, mask, (1, 0, 2)
    rng = np.random.default_rng(SEED)
    O = 37
    b2 = np.zeros((2, O, 4), np.float32)
    m2 = np.zeros((2, O), bool)
    for b in range(2):
        xy = rng.uniform([-60, -60], [1040, 640], (O, 2))
        wh = rng.uniform(0.2, 1.0, (O, 1)) * rng.choice(
            [2.0, 30.0, 300.0, 1100.0], (O, 1)) * rng.uniform(0.5, 1.5, (O, 2))
        b2[b] = np.concatenate([xy, xy + wh], 1)
        m2[b] = rng.uniform(size=O) > 0.2
    b2[0, :K1_SERVE_LIVE] = K1_SERVE_BOXES[:K1_SERVE_LIVE]
    m2[0, :K1_SERVE_LIVE] = True
    m2[1, -1] = True
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    yield ("B2_O37", torch.randn(2, 38, 63, 1024, generator=g, device=dev),
           torch.from_numpy(b2).to(dev), torch.from_numpy(m2).to(dev),
           (1, 0, 2))
    # the RefCOCO+ test driver's batch: B=4, 108 slots, the live boxes first
    # as its collate packs them, slots past 64 live in three images
    O, live = 108, (108, 97, 66, 40)
    b4 = np.zeros((4, O, 4), np.float32)
    m4 = np.zeros((4, O), bool)
    for b in range(4):
        xy = rng.uniform([-60, -60], [1040, 640], (O, 2))
        wh = rng.uniform(0.2, 1.0, (O, 1)) * rng.choice(
            [2.0, 30.0, 300.0, 1100.0], (O, 1)) * rng.uniform(0.5, 1.5, (O, 2))
        b4[b] = np.concatenate([xy, xy + wh], 1)
        m4[b, :live[b]] = True
    b4[3, :K1_SERVE_LIVE] = K1_SERVE_BOXES[:K1_SERVE_LIVE]
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    yield ("B4_O108", torch.randn(4, 38, 63, 1024, generator=g, device=dev),
           torch.from_numpy(b4).to(dev), torch.from_numpy(m4).to(dev), (1,))
    # VCR's test batch: four 600x1200 canvases (SCALES 600, 1200; body4
    # [4,38,75,1024]), 108 slots, the whole-image box first, 108, 60, 21
    # and 8 live
    O, live = 108, (108, 60, 21, 8)
    bv = np.zeros((4, O, 4), np.float32)
    mv = np.zeros((4, O), bool)
    for b in range(4):
        xy = rng.uniform([-20, -20], [1180, 580], (O, 2))
        wh = rng.uniform(0.2, 1.0, (O, 1)) * rng.choice(
            [4.0, 60.0, 400.0], (O, 1)) * rng.uniform(0.5, 1.5, (O, 2))
        bv[b] = np.concatenate([xy, xy + wh], 1)
        bv[b, 0] = (0, 0, 1199 - 100 * b, 599)
        mv[b, :live[b]] = True
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    yield ("vcr_B4_O108", torch.randn(4, 38, 75, 1024, generator=g,
                                      device=dev),
           torch.from_numpy(bv).to(dev), torch.from_numpy(mv).to(dev), (1,))
    # pretraining's caption batch: 8 images of PRETRAIN_CANVASES
    # (landscape and portrait on one 1000x1000 canvas: body4
    # [8,63,63,1024]), 108 slots, the whole-image box first, then 10-100
    # frcnn boxes inside the image, the rest padded with the dataset's -2
    O, live = 108, (101, 11, 57, 88, 30, 74, 19, 45)
    bp = np.full((8, O, 4), -2.0, np.float32)
    mp = np.zeros((8, O), bool)
    for b, ((w, h), n) in enumerate(zip(PRETRAIN_CANVASES, live)):
        x1 = rng.uniform(0, w * 0.8, n - 1)
        y1 = rng.uniform(0, h * 0.8, n - 1)
        bp[b, 0] = (0, 0, w - 1, h - 1)
        bp[b, 1:n] = np.stack(
            [x1, y1, np.minimum(x1 + rng.uniform(16, w / 2, n - 1), w - 1),
             np.minimum(y1 + rng.uniform(16, h / 2, n - 1), h - 1)], 1)
        mp[b, :n] = True
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    yield ("pretrain_B8_O108", torch.randn(8, 63, 63, 1024, generator=g,
                                           device=dev),
           torch.from_numpy(bp).to(dev), torch.from_numpy(mp).to(dev), (1,))
    portrait = boxes[..., [1, 0, 3, 2]].contiguous()
    yield ("portrait", feat.transpose(1, 2).contiguous(), portrait, mask,
           (1, 0))
    yield ("C1032", k1_serve_inputs(dev, C=1032)[0], boxes, mask, (1,))


def k1_parity(dev):
    """ROIAlign kernel vs plain over k1_cases: fp32 and bf16 maps, each to
    fp32 and bf16 output. fp32 out within K1_ATOL; bf16 out within one
    bf16 step of the plain fp32 result rounded to bf16 (|a - b| <=
    K1_BF16_RTOL |b| + K1_ATOL); padded slots exactly 0. Then timings at
    the serve shape, bf16 map, sampling ratio 1: the main path's route
    (bf16 out), the fp32-out route, the route the main path ran before K1
    stored the compute dtype (the bool mask converted to uint8, the fp32-out
    K1, the cast to bf16; three launches), and the plain version."""
    import torch
    from vlbert_tpu_torch.ops.roi_align import roi_align, roi_align_plain

    errs = {}
    for name, feat, boxes, mask, ratios in k1_cases(dev):
        for dtype in (torch.float32, torch.bfloat16):
            f = feat.to(dtype)
            for out_dtype in (torch.float32, torch.bfloat16):
                for sr in ratios:
                    kw = dict(sampling_ratio=sr, out_dtype=out_dtype)
                    a = roi_align(f, boxes, mask, **kw)
                    b = roi_align_plain(f, boxes, mask, **kw)
                    torch.cuda.synchronize()
                    key = (f"{name}/{str(dtype)[6:]}->"
                           f"{str(out_dtype)[6:]}/sr{sr}")
                    diff = (a.float() - b.float()).abs()
                    err = diff.max().item()
                    bf16 = out_dtype == torch.bfloat16
                    excess = (diff - (K1_BF16_RTOL * b.float().abs()
                                      + K1_ATOL) if bf16
                              else diff - K1_ATOL).max().item()
                    if not (a.dtype == out_dtype and a.shape == b.shape
                            and excess <= 0 and torch.all(a[~mask] == 0)):
                        raise AssertionError(
                            f"K1 {key}: max abs err {err}, excess over the "
                            f"tolerance {excess}, padded slots zero "
                            f"{bool(torch.all(a[~mask] == 0))}")
                    errs[key] = err
    feat, boxes, mask = k1_serve_inputs(dev)
    f = feat.to(torch.bfloat16)    # the serve path's body4 is bf16

    def old_route():
        m = mask.to(torch.uint8)
        return roi_align(f, boxes, m, sampling_ratio=1).to(torch.bfloat16)

    times = {
        "bf16_out": time_calls(lambda: roi_align(
            f, boxes, mask, sampling_ratio=1, out_dtype=torch.bfloat16),
            K1_KERNEL),
        "fp32_out": time_calls(lambda: roi_align(f, boxes, mask,
                                                 sampling_ratio=1),
                               K1_KERNEL),
        "old_route": time_calls(old_route, K1_KERNEL),
        "plain": cuda_ms(lambda: roi_align_plain(
            f, boxes, mask, sampling_ratio=1, out_dtype=torch.bfloat16))}
    return errs, times


def k1_bound(B, H, W, C, O, in_bytes, out_bytes, P=14, Q=14, taps=4):
    """K1's roofline: the map read once, the boxes and the mask, the output
    written once; 2 fp32 operations a tap and output element."""
    return roofline(B * H * W * C * in_bytes + B * O * (16 + 1)
                    + B * O * P * Q * C * out_bytes,
                    2 * taps * B * O * P * Q * C, "float32")


# K1b's kernel, by the name the profiler reports
K1B_KERNEL = "roi_align_bwd_kernel"
# K1b against roi_align_bwd_plain: fp32 sums in another order, relative to
# the case's largest |dF| (at least 1; a map pixel sums up to thousands of
# bins); a bf16 dF within one bf16 step of the plain fp32 result rounded
# to bf16, as K1's bf16 output
K1B_RTOL = 1e-5


def k1b_parity(dev):
    """K1b (the dF of ROIAlign) vs roi_align_bwd_plain over k1_cases: fp32
    and bf16 maps (dF in the map's dtype) from fp32 and bf16 g, each
    sampling ratio of the case; fp32 dF within K1B_RTOL of the case's
    largest |dF|, bf16 within one bf16 step plus that; the padded slots' g
    set to 1e6 must not reach dF; a repeat on the same inputs must be bit
    for bit the same. Returns {case: relative error}."""
    import torch
    from vlbert_tpu_torch.ops import roi_align as troi

    errs = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    for name, feat, boxes, mask, ratios in k1_cases(dev):
        B, H, W, C = feat.shape
        g32 = torch.randn(B, boxes.shape[1], 14, 14, C, generator=gen,
                          device=dev)
        g32[~mask] = 1e6
        for dtype in (torch.float32, torch.bfloat16):
            for g_dtype in (torch.float32, torch.bfloat16):
                g = g32.to(g_dtype)
                for sr in ratios:
                    args = (g, boxes, mask, feat.shape, dtype, 14, 14,
                            1.0 / 16, sr)
                    a = troi._roi_align_bwd_cuda(*args)
                    again = troi._roi_align_bwd_cuda(*args)
                    b = troi.roi_align_bwd_plain(feat.to(dtype), boxes,
                                                 mask, g, sampling_ratio=sr)
                    torch.cuda.synchronize()
                    key = (f"{name}/{str(g_dtype)[6:]}->{str(dtype)[6:]}"
                           f"/sr{sr}")
                    scale = max(1.0, b.float().abs().max().item())
                    diff = (a.float() - b.float()).abs()
                    bound = K1B_RTOL * scale + (
                        K1_BF16_RTOL * b.float().abs()
                        if dtype == torch.bfloat16 else 0.0)
                    excess = (diff - bound).max().item()
                    if not (a.dtype == dtype and a.shape == b.shape
                            and excess <= 0 and torch.equal(a, again)):
                        raise AssertionError(
                            f"K1b {key}: max abs err {diff.max().item()} "
                            f"(largest |dF| {scale}), excess over the "
                            f"tolerance {excess}, repeat bit-identical "
                            f"{bool(torch.equal(a, again))}")
                    errs[key] = diff.max().item() / scale
    return errs


# K1b's timed calls: VCR's training shape with the padded slots of the
# main path or every slot live, RefCOCO+'s and pretraining's
K1B_TIMED = ("vcr", "vcr_all_live", "refcoco", "pretrain")
# RefCOCO+'s training batch: live slots of each of its 4 images (its
# candidate boxes, at most 16 of the 108 slots, first)
K1B_REFCOCO_LIVE = (16, 12, 8, 4)


def k1b_inputs(dev, case="vcr"):
    """A main path's K1b call, bf16 map and bf16 g [B,108,14,14,1024]:
    "vcr", VCR's training shape, the vcr_B4_O108 case of k1_cases (body4
    [4,38,75,1024], 108 slots, 108, 60, 21 and 8 live); "vcr_all_live",
    the same with all 108 live; "refcoco", RefCOCO+'s training shape, the
    B4_O108 case's boxes (body4 [4,38,63,1024]) with K1B_REFCOCO_LIVE
    live; "pretrain", pretraining's, the pretrain_B8_O108 case (g
    [8,108,14,14,1024])."""
    import torch

    cases = {c[0]: c for c in k1_cases(dev)}
    _, feat, boxes, mask, _ = cases[{"refcoco": "B4_O108",
                                     "pretrain": "pretrain_B8_O108"}.get(
                                         case, "vcr_B4_O108")]
    if case == "vcr_all_live":
        mask = torch.ones_like(mask)
    elif case == "refcoco":
        mask = torch.zeros_like(mask)
        for b, n in enumerate(K1B_REFCOCO_LIVE):
            mask[b, :n] = True
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    g = torch.randn(*mask.shape, 14, 14, feat.shape[-1], generator=gen,
                    device=dev).to(torch.bfloat16)
    return feat.to(torch.bfloat16), boxes, mask, g


def k1b_bound(feat, mask, g):
    """K1b's roofline: g over the live slots read once, the boxes and the
    mask, dF written once; 2 fp32 operations a sample tap, channel and
    live bin (4 taps a bin at sampling ratio 1)."""
    B, H, W, C = feat.shape
    live = int(mask.sum())
    return roofline(live * 14 * 14 * C * g.element_size()
                    + mask.numel() * 17 + B * H * W * C * feat.element_size(),
                    2 * 4 * live * 14 * 14 * C, "float32")


def k1b_times(dev):
    """K1b at the K1B_TIMED calls (bf16, sampling ratio 1), by kernel
    name; and the plain version at VCR's and pretraining's."""
    from vlbert_tpu_torch.ops import roi_align as troi

    out = {}
    for key in K1B_TIMED:
        feat, boxes, mask, g = k1b_inputs(dev, key)
        args = (g, boxes, mask, feat.shape, feat.dtype, 14, 14, 1.0 / 16, 1)
        out[key] = time_calls(lambda args=args: troi._roi_align_bwd_cuda(
            *args), K1B_KERNEL)
        out[key]["bound"] = k1b_bound(feat, mask, g)
        out[key]["live"] = int(mask.sum())
    for key, case in (("plain", "vcr"), ("plain_pretrain", "pretrain")):
        feat, boxes, mask, g = k1b_inputs(dev, case)
        out[key] = cuda_ms(lambda: troi.roi_align_bwd_plain(
            feat, boxes, mask, g, sampling_ratio=1))
    return out


def k1b_library(dev, case="vcr"):
    """K1b's yardstick: the backward (autograd) of phase 3's F.grid_sample
    yardstick, at a k1b_inputs call: the 14x14 bin centres of the 108
    slots of each of 4 maps (sampling ratio 1; exact for boxes inside the
    map, the padded slots' mask multiply left out), on the map as an NCHW
    view of its NHWC memory, bf16 where grid_sample takes it. Returns (ms,
    kernel names, dtype timed, fp32 max abs err of its dF against the
    plain dF with g on the boxes inside the map)."""
    import torch
    import torch.nn.functional as F
    from vlbert_tpu_torch.ops.roi_align import roi_align_bwd_plain

    feat, boxes, mask, g = k1b_inputs(dev, case)
    B, H, W, C = feat.shape
    grid, inside = k1_grid(boxes, H, W)
    kw = dict(mode="bilinear", padding_mode="border", align_corners=True)
    sel = (inside & mask).to(torch.float32)[..., None, None, None]
    g32 = g.float() * sel
    f32 = feat.float().permute(0, 3, 1, 2).detach().requires_grad_()
    out = F.grid_sample(f32, grid, **kw)
    gl = g32.permute(0, 4, 1, 2, 3).reshape(out.shape)
    (got,) = torch.autograd.grad(out, f32, gl)
    want = roi_align_bwd_plain(feat.float(), boxes, mask, g32,
                               sampling_ratio=1)
    err = _maxerr(got.permute(0, 2, 3, 1), want)
    dtype = "bfloat16"
    try:
        fb = feat.permute(0, 3, 1, 2).detach().requires_grad_()
        ob = F.grid_sample(fb, grid.to(torch.bfloat16), **kw)
        gb = gl.to(torch.bfloat16)
        torch.autograd.grad(ob, fb, gb, retain_graph=True)
    except RuntimeError:
        dtype = "float32"
        fb, ob, gb = f32, out, gl
    ms, names = library_ms(lambda: torch.autograd.grad(ob, fb, gb,
                                                       retain_graph=True))
    return ms, names, dtype, err


# (B, L): the edges of one 64-row tile, the serve shape, the VQA
# validation shape, test_net_vqa's (B=64 L=128), the VQA server's,
# test_net_refcoco's (B=4 L=173) and VCR's (4 questions x 4 choices,
# B=16 L=173)
K2_CASES = ((1, 1), (1, 41), (1, 63), (1, 64), (1, 65), (16, 128), (64, 128),
            (1, 173), (4, 173), (16, 173))
K2_TIMED = ((1, 41), (16, 128), (1, 173), (16, 173))


def k2_parity(dev):
    """Attention kernel vs plain, bf16 and fp32 (both on the tensor cores,
    fp32 by a three-product TF32 split), H=12, D=64, at the (B, L) of
    K2_CASES: L = 41 is the serve
    shape (24 text + 16 boxes + END), 128 the VQA validation (B=16) and
    test_net_vqa (B=64) shape, 173 the VQA server's (B=1) and
    test_net_refcoco's (B=4) bucket, and 1, 63, 64, 65 the ragged edges
    of one 64-row tile, and B=16 L=173 VCR's 4 questions x 4 choices. 5
    keys masked (at L=1 the only key, a fully masked row); q, k, v are
    strided views of one fused projection. Device times at the cases of
    K2_TIMED, keyed "B{B}_L{L}" (bf16) and "B{B}_L{L}_fp32"."""
    import torch
    from vlbert_tpu_torch.ops.attention import fused_attention, plain_attention

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    errs, timing = {}, {}
    for B, L in K2_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, L, 3 * 768, generator=g, device=dev)
            q, k, v = (t.view(B, L, 12, 64) for t in qkv.to(dtype).split(
                768, dim=-1))
            m = torch.ones(B, L, device=dev)
            m[:, -5:] = 0
            bias = ((1.0 - m) * -10000.0)[:, None, None, :].contiguous()
            a = fused_attention(q, k, v, bias)
            b = plain_attention(q, k, v, bias)
            torch.cuda.synchronize()
            err = (a.float() - b.float()).abs().max().item()
            tol = K2_ATOL[str(dtype)[6:]]
            if not err <= tol:
                raise AssertionError(f"K2 B={B} L={L} {dtype}: max abs err "
                                     f"{err} > {tol}")
            errs[f"B{B}_L{L}/{str(dtype)[6:]}"] = err
            key = f"B{B}_L{L}" + ("" if dtype == torch.bfloat16 else "_fp32")
            if (B, L) in K2_TIMED:
                timing[key] = (cuda_ms(lambda: fused_attention(q, k, v, bias)),
                               cuda_ms(lambda: plain_attention(q, k, v, bias)))
    return errs, timing


def ms_by_name(ms):
    """{name: ms} rounded for a log line."""
    return {k: round(v, 4) for k, v in ms.items()}


def _maxerr(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel_err(a, b):
    """max |a - b| / max(1, max |b|)."""
    return _maxerr(a, b) / max(1.0, b.float().abs().max().item())


# K5's parity cases: (shape, elements skipped before the view starts). The
# training shapes; an odd size; views that start 1, 2 or 3 elements past a
# 16-byte boundary (2, 4 or 6 bytes in bf16, 4, 8 or 12 in fp32), whose
# 16-byte chunks begin at every phase of K5's groups of four; and a view
# no longer than its head in bf16 (the 7 elements before its first 16-byte
# boundary).
K5_CASES = (((16, 128, 768), 0), ((16, 95, 4096), 0), ((16, 768), 0),
            ((5, 41, 77), 0), ((5, 41, 77), 1), ((5, 41, 77), 2),
            ((5, 41, 77), 3), ((16, 128, 768), 1), ((7,), 1))


def k5_parity(dev):
    """Dropout kernel vs plain over K5_CASES, fp32 and bf16, both modes,
    forward and backward (the cotangent and the explicit bits start as far
    off a 16-byte boundary as x); Philox masks bit for bit; timing at
    [16,128,768] bf16."""
    import torch
    from vlbert_tpu_torch.ops.dropout import (flat_index_bits, hw_dropout,
                                              keep_mask, plain_dropout)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {}
    for shape, skip in K5_CASES:
        n = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            def view(t):
                return t.to(dtype)[skip:].view(shape)

            x = view(torch.randn(n + skip, generator=g, device=dev)) \
                .requires_grad_()
            gy = view(torch.randn(n + skip, generator=g, device=dev))
            bits = torch.randint(0, 65536, (n + skip,), generator=g,
                                 device=dev, dtype=torch.int32)[skip:] \
                .view(shape)
            for mode, kw in (("bits", dict(bits=bits)),
                             ("philox", dict(seed=SEED + 11))):
                a = hw_dropout(x, DROP_RATE, **kw)
                (da,) = torch.autograd.grad(a, x, gy)
                b = plain_dropout(x, DROP_RATE, **kw)
                (db,) = torch.autograd.grad(b, x, gy)
                err = max(_maxerr(a, b), _maxerr(da, db))
                key = (f"{'x'.join(map(str, shape))}+{skip}/"
                       f"{str(dtype)[6:]}/{mode}")
                if not err <= K5_ATOL:
                    raise AssertionError(f"K5 {key}: max abs err {err} > "
                                         f"{K5_ATOL}")
                errs[key] = err
    shape = (16, 128, 768)
    ones = torch.ones(shape, device=dev, requires_grad=True)
    masks = []
    for seed in (SEED + 21, SEED + 22):
        out = hw_dropout(ones, DROP_RATE, seed=seed)
        (dx,) = torch.autograd.grad(out, ones, torch.ones_like(out))
        keep = out != 0
        want = keep_mask(flat_index_bits(shape, seed, dev), DROP_RATE, False)
        if not (torch.equal(keep, want) and torch.equal(dx != 0, keep)):
            raise AssertionError(f"K5 seed {seed}: kernel mask != plain "
                                 f"Philox mask, or backward did not replay")
        masks.append(keep)
    frac, n = masks[0].float().mean().item(), masks[0].numel()
    sigma = (DROP_RATE * (1 - DROP_RATE) / n) ** 0.5
    if not abs(frac - (1 - DROP_RATE)) <= 5 * sigma:
        raise AssertionError(f"K5 keep fraction {frac} not within 5 sigma "
                             f"({sigma:.2e}) of {1 - DROP_RATE}")
    if torch.equal(masks[0], masks[1]):
        raise AssertionError("K5: two seeds gave the same mask")
    xb = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    timing = (cuda_ms(lambda: hw_dropout(xb, DROP_RATE, seed=SEED)),
              cuda_ms(lambda: plain_dropout(xb, DROP_RATE, seed=SEED)))
    return errs, {"keep_fraction": frac, "sigma": sigma}, timing


def _train_qkv(g, dev, dtype, B=16, L=128, H=12):
    """q, k, v as strided views of one fused [B, L, 3*H*64] leaf (H heads
    of 64), and a [B,1,1,L] bias leaf: 7 padded keys per row, and batch row
    1 with every key masked.

    q and k lie on a 2**-6 grid in (-4, 4): every q.k then sums exactly in
    fp32 (22 bits), in any order. On the all-masked row a score is about
    -10000, where an fp32 step is 2**-10, and two fp32 sums in different
    orders land on different steps, which moves that row's gradients by
    about the fp32 tolerance itself (tests/test_torch_train_attention.py::
    test_exact_score_inputs_make_fp32_sums_order_free). With exact sums
    both sides round to the same score, and what is left to compare is the
    kernels' arithmetic."""
    import torch

    W = H * 64
    qkv = torch.randn(B, L, 3 * W, generator=g, device=dev)
    qk = torch.round(qkv[..., :2 * W] * 64).clamp(-255, 255) / 64
    qkv = torch.cat([qk, qkv[..., 2 * W:]], -1).to(dtype).requires_grad_()
    q, k, v = qkv.view(B, L, 3, H, 64).unbind(2)
    m = torch.ones(B, L, device=dev)
    m[:, -7:] = 0
    m[1] = 0
    bias = ((1.0 - m) * -10000.0)[:, None, None, :].contiguous() \
        .requires_grad_()
    return qkv, (q, k, v), bias


def _attention_masks(dev, seed, dtype, B=16, H=12, L=128, D=64):
    """K3's and K4's keep masks [B, H, L, L], read back exactly: with
    q = k = 0 and bias 0 every prob is 1/L; v (and for K4 the cotangent g)
    encodes key (query) j as 2**(j % n) in dim j // n, so each output (dv)
    element is drop_scale / L times an n-bit word of the mask. n is 16 in
    fp32 and 4 in bf16, where a word of up to 15 survives the one bf16
    rounding of the output (and of the bf16 P operand in K4)."""
    import torch
    from vlbert_tpu_torch.ops.attention import fused_attention_dropout

    n = 16 if dtype == torch.float32 else 4
    j = torch.arange(L, device=dev)
    enc = torch.zeros(L, D, device=dev)
    enc[j, j // n] = (2.0 ** (j % n)).float()
    enc = enc[None, :, None, :].expand(B, L, H, D).contiguous().to(dtype)
    z = torch.zeros(B, L, H, D, device=dev, dtype=dtype)
    v = enc.clone().requires_grad_()
    out = fused_attention_dropout(z, z, v, torch.zeros(B, 1, 1, L,
                                                       device=dev),
                                  DROP_RATE, seed=seed)
    (dv,) = torch.autograd.grad(out, v, enc)
    f = L * (1.0 - DROP_RATE)
    shifts = torch.arange(n, device=dev)

    def unpack(words):            # [B, X, H, D] -> [B, H, X, L]
        w = torch.round(words.double() * f).long()[..., :L // n]
        bits = (w.permute(0, 2, 1, 3)[..., None] >> shifts) & 1
        return bits.reshape(B, H, L, L).bool()

    return unpack(out), unpack(dv).transpose(2, 3)


def k34_parity(dev):
    """K3/K4 vs plain at B=16 H=12 L=128 D=64 and at B=4 with L = 41 and
    173 (7 padded keys, one all-masked batch row), explicit bits and
    Philox, fp32 (the tensor cores by the TF32 split) and bf16 (tensor
    cores); masks read back bit for bit in both dtypes; a backward repeated
    bit for bit in both dtypes; K2's backward; timings in bf16 and fp32 at
    the VQA step's B=16 L=128 and VCR's B=16 L=173, with K4's device time
    by kernel. Returns (errs, mask stats, bf16 K3 and K4 (kernel, plain)
    times at L=128, bf16 K4 by kernel, the fp32 route's {"k3", "k4",
    "k4_split", "k3_L173", "k4_L173"}, bf16 at L=173 {"k3", "k4",
    "k4_split"})."""
    import torch
    from vlbert_tpu_torch.ops.attention import (
        attention_bits, fused_attention, fused_attention_dropout,
        plain_attention, plain_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import keep_mask

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = {"K3": {}, "K4": {}, "K2_bwd": {}}
    for B, L in ((16, 128), (4, 41), (4, 173)):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype)[6:]
            qkv, (q, k, v), bias = _train_qkv(g, dev, dtype, B=B, L=L)
            gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
            bits = torch.randint(0, 65536, (B, 12, L, L), generator=g,
                                 device=dev, dtype=torch.int32)
            for mode, kw in (("bits", dict(bits=bits)),
                             ("philox", dict(seed=SEED + 12))):
                a = fused_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
                ga = torch.autograd.grad(a, (qkv, bias), gy)
                b = plain_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
                gb = torch.autograd.grad(b, (qkv, bias), gy)
                e3 = _maxerr(a, b)
                e4 = max(_rel_err(x, y) for x, y in zip(ga, gb))
                key = f"L{L}/{dn}/{mode}"
                if not (e3 <= K3_ATOL[dn] and e4 <= BWD_RTOL[dn]):
                    raise AssertionError(
                        f"K3/K4 {key}: out err {e3} (atol {K3_ATOL[dn]}), "
                        f"grad rel err {e4} (rtol {BWD_RTOL[dn]})")
                errs["K3"][key] = e3
                errs["K4"][key] = e4
            if L != 128:
                continue
            a = fused_attention_dropout(q, k, v, bias, DROP_RATE,
                                        seed=SEED + 13)
            g1, g2 = (torch.autograd.grad(a, (qkv, bias), gy,
                                          retain_graph=True)
                      for _ in range(2))
            if not all(map(torch.equal, g1, g2)):
                raise AssertionError(f"K4 {dn}: two calls on the same "
                                     f"inputs gave different gradients")
            a = fused_attention(q, k, v, bias)
            ga = torch.autograd.grad(a, (qkv, bias), gy)
            gb = torch.autograd.grad(plain_attention(q, k, v, bias),
                                     (qkv, bias), gy)
            e2 = max(_rel_err(x, y) for x, y in zip(ga, gb))
            if not e2 <= BWD_RTOL[dn]:
                raise AssertionError(f"K2 backward {dn}: rel err {e2}")
            errs["K2_bwd"][dn] = e2

    fwd_masks = []
    for dtype in (torch.float32, torch.bfloat16):
        for seed in (SEED + 31, SEED + 32):
            fwd, bwd = _attention_masks(dev, seed, dtype)
            want = keep_mask(attention_bits(16, 12, 128, seed, dev),
                             DROP_RATE, False)
            if not (torch.equal(fwd, want) and torch.equal(bwd, want)):
                raise AssertionError(
                    f"K3/K4 {dtype} seed {seed}: mismatched keep bits fwd "
                    f"{(fwd != want).sum().item()}, bwd "
                    f"{(bwd != want).sum().item()} of {want.numel()}")
            fwd_masks.append(fwd)
    frac, n = fwd_masks[0].float().mean().item(), fwd_masks[0].numel()
    sigma = (DROP_RATE * (1 - DROP_RATE) / n) ** 0.5
    if not abs(frac - (1 - DROP_RATE)) <= 5 * sigma:
        raise AssertionError(f"K3 keep fraction {frac} not within 5 sigma "
                             f"({sigma:.2e}) of {1 - DROP_RATE}")
    if torch.equal(fwd_masks[0], fwd_masks[1]):
        raise AssertionError("K3: two seeds gave the same mask")

    def k4_times(dtype, L):
        """K4 as the backward of one forward (separate leaves), and its
        plain autograd: ((kernel, plain) cuda_ms, K4's device ms by kernel:
        its two passes and the sum over heads)."""
        _, (q, k, v), bias = _train_qkv(g, dev, dtype, L=L)
        leaves = [t.detach().contiguous().requires_grad_()
                  for t in (q, k, v)]
        bias = bias.detach()
        gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        outs = (fused_attention_dropout(*leaves, bias, DROP_RATE, seed=SEED),
                plain_attention_dropout(*leaves, bias, DROP_RATE, seed=SEED))
        times = tuple(cuda_ms(lambda o=o: torch.autograd.grad(
            o, leaves, gy, retain_graph=True)) for o in outs)
        split = {name: us / 1e3 / 50 for name, us in device_us_by_name(
            lambda: torch.autograd.grad(outs[0], leaves, gy,
                                        retain_graph=True), 50).items()}
        return times, split

    def k3_times(dtype, L):
        """K3 on the fused-projection views and its plain version:
        (kernel, plain) cuda_ms."""
        with torch.no_grad():
            _, (q, k, v), bias = _train_qkv(g, dev, dtype, L=L)
            bias = bias.detach()
            return (cuda_ms(lambda: fused_attention_dropout(
                        q, k, v, bias, DROP_RATE, seed=SEED)),
                    cuda_ms(lambda: plain_attention_dropout(
                        q, k, v, bias, DROP_RATE, seed=SEED)))

    # timings, Philox: bf16 (the main path), then the fp32 route, at the
    # VQA step's L=128 and VCR's L=173
    times = {(str(dtype)[6:], L): (k3_times(dtype, L), *k4_times(dtype, L))
             for L in (128, 173) for dtype in (torch.bfloat16, torch.float32)}
    k3, k4, k4_split = times["bfloat16", 128]
    k3_32, k4_32, k4_split_32 = times["float32", 128]
    f32 = {"k3": k3_32, "k4": k4_32, "k4_split": k4_split_32,
           "k3_L173": times["float32", 173][0],
           "k4_L173": times["float32", 173][1]}
    k3_173, k4_173, k4_split_173 = times["bfloat16", 173]
    bf16_173 = {"k3": k3_173, "k4": k4_173, "k4_split": k4_split_173}
    return (errs, {"keep_fraction": frac, "sigma": sigma}, k3, k4, k4_split,
            f32, bf16_173)


# tensor parallelism's head slices: (heads, model axis) of the layers
# whose K3/K4 launches on a rank's heads are checked, and the dtypes
HEAD_SLICES = ((12, 2), (12, 4), (16, 2), (16, 4))


def k34_head_slices(dev):
    """K3's output and K4's dq, dk, dv launched on a head slice of a layer
    (heads j*H/m .. of H, ``head_offset`` and ``heads_total``: a tensor-
    parallel rank's launch) against the same heads of the launch over all
    H, bit for bit: Philox (the slice draws the layer's masks at its head
    offset) and explicit bits (the rank passes its slice of them), fp32,
    bf16 and fp16, H = 12 and 16 at model axes 2 and 4, B=16 L=128 (7
    padded keys, one all-masked row). Returns the number of slices
    checked by dtype."""
    import torch
    from vlbert_tpu_torch.ops.attention import fused_attention_dropout

    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    checked = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype)[6:]
        for H in sorted({h for h, _ in HEAD_SLICES}):
            qkv, (q, k, v), bias = _train_qkv(g, dev, dtype, H=H)
            B, L = q.shape[:2]
            gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
            bits = torch.randint(0, 65536, (B, H, L, L), generator=g,
                                 device=dev, dtype=torch.int32)
            for mode, kw in (("philox", dict(seed=SEED + 41)),
                             ("bits", dict(bits=bits))):
                full = fused_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
                (gfull,) = torch.autograd.grad(full, qkv, gy)
                gfull = gfull.view(B, L, 3, H, 64)
                for m in sorted({m for h, m in HEAD_SLICES if h == H}):
                    n = H // m
                    for j in range(m):
                        sl = slice(j * n, (j + 1) * n)
                        part_kw = (dict(seed=kw["seed"]) if mode == "philox"
                                   else dict(bits=bits[:, sl].contiguous()))
                        part = fused_attention_dropout(
                            q[:, :, sl], k[:, :, sl], v[:, :, sl], bias,
                            DROP_RATE, head_offset=j * n, heads_total=H,
                            **part_kw)
                        (gpart,) = torch.autograd.grad(part, qkv,
                                                       gy[:, :, sl])
                        gpart = gpart.view(B, L, 3, H, 64)
                        if not (torch.equal(part, full[:, :, sl])
                                and torch.equal(gpart[:, :, :, sl],
                                                gfull[:, :, :, sl])):
                            raise AssertionError(
                                f"K3/K4 {dn} {mode} H={H}: heads {j * n}.."
                                f"{(j + 1) * n - 1} launched as a slice "
                                f"differ from the whole launch's: out "
                                f"{_maxerr(part, full[:, :, sl])}, grad "
                                f"{_maxerr(gpart[:, :, :, sl], gfull[:, :, :, sl])}")
                        checked[dn] = checked.get(dn, 0) + 1
    return checked


def library_ms(fn, iters=50, warmup=5):
    """(device ms per call, sorted kernel names) of a PyTorch library call
    timed as a yardstick; the port never calls it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by_name = device_us_by_name(fn, iters)
    return sum(by_name.values()) / 1e3 / iters, sorted(by_name)


def _sdpa_args(q, k, v, bias):
    """SDPA's [B, H, L, D] views of the port's [B, L, H, D] q, k, v, and the
    bias as an additive mask in q's dtype."""
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            bias.to(q.dtype))


def k1_grid(boxes, H, W, P=14, spatial_scale=1.0 / 16):
    """grid_sample's grid [B, O*P, P, 2] (x, y in align_corners=True
    units) of ROIAlign's bin centres at sampling ratio 1: each box scaled
    by 1/16 with no rounding, at least 1x1, bin p's centre at
    y1 + (p + 0.5) h / P. With padding_mode="border" a sample is clamped to
    [0, H-1], which is ROIAlign's rule for samples inside [-1, H]; outside
    it ROIAlign gives 0. Also returns a [B, O] mask of the boxes whose
    samples all lie inside."""
    import torch

    b = boxes.to(torch.float32) * spatial_scale
    c = torch.arange(P, device=boxes.device, dtype=torch.float32) + 0.5
    ys = b[..., 1, None] + c * (b[..., 3] - b[..., 1]).clamp(min=1)[..., None] / P
    xs = b[..., 0, None] + c * (b[..., 2] - b[..., 0]).clamp(min=1)[..., None] / P
    inside = ((ys >= -1) & (ys <= H)).all(-1) & ((xs >= -1) & (xs <= W)).all(-1)
    gy = (2 * ys / (H - 1) - 1)[..., :, None].expand(*ys.shape, P)
    gx = (2 * xs / (W - 1) - 1)[..., None, :].expand(*xs.shape[:-1], P, P)
    B, O = boxes.shape[:2]
    return torch.stack([gx, gy], -1).reshape(B, O * P, P, 2), inside


def k1_library(dev):
    """K1's yardstick: one F.grid_sample(mode="bilinear",
    padding_mode="border", align_corners=True) over the 14x14 bin centres
    of the serve shape's 16 slots (output [1, C, 16*14, 14], the padded
    slots' mask multiply left out), on the bf16 body4 as an NCHW view of
    its NHWC memory. Returns (ms, kernel names, dtype timed, fp32 max abs
    err against the plain ROIAlign on the boxes inside the map, how many
    of the live boxes that is)."""
    import torch
    import torch.nn.functional as F
    from vlbert_tpu_torch.ops.roi_align import roi_align_plain

    feat, boxes, mask = k1_serve_inputs(dev)
    _, H, W, C = feat.shape
    grid, inside = k1_grid(boxes, H, W)
    kw = dict(mode="bilinear", padding_mode="border", align_corners=True)
    got = F.grid_sample(feat.permute(0, 3, 1, 2), grid, **kw)
    got = got.reshape(1, C, -1, 14, 14).permute(0, 2, 3, 4, 1)
    want = roi_align_plain(feat, boxes, mask, sampling_ratio=1)
    sel = inside & mask
    err = _maxerr(got[sel], want[sel])
    dtype = "bfloat16"
    try:
        fb, gb = feat.to(torch.bfloat16).permute(0, 3, 1, 2), \
            grid.to(torch.bfloat16)
        F.grid_sample(fb, gb, **kw)
    except RuntimeError:
        dtype = "float32"
        fb, gb = feat.permute(0, 3, 1, 2), grid
    ms, names = library_ms(lambda: F.grid_sample(fb, gb, **kw))
    return ms, names, dtype, err, int(sel.sum())


def library_yardsticks(dev):
    """One PyTorch call per kernel that computes the same function, at the
    main path's shapes, bf16: scaled_dot_product_attention for K2 (B=1
    L=41, B=1 L=173, B=16 L=173, B=16 L=128, each also in fp32 beside the
    fp32 K2), with dropout_p=rate for K3 (its masks are its own; the work
    is the same), autograd through that call for K4 (both also in fp32 at
    B=16 L=128 beside the fp32 routes), K3 and K4 also at VCR's B=16
    L=173 in both dtypes, torch.nn.functional.dropout for K5 and
    grid_sample for K1 (``k1_library``). Returns {name: (ms, kernel
    names)}."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = {}
    for B, L in ((1, 41), (1, 173), (16, 173)):
        for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
            qkv = torch.randn(B, L, 3 * 768, generator=g, device=dev) \
                .to(dtype)
            q, k, v = (t.view(B, L, 12, 64) for t in qkv.split(768, dim=-1))
            m = torch.ones(B, L, device=dev)
            m[:, -5:] = 0
            bias = ((1.0 - m) * -10000.0)[:, None, None, :].contiguous()
            a = _sdpa_args(q, k, v, bias)
            key = f"K2_L{L}" if B == 1 else f"K2_B{B}_L{L}"
            out[key + suffix] = library_ms(
                lambda a=a: F.scaled_dot_product_attention(*a[:3],
                                                           attn_mask=a[3]))
    with torch.no_grad():
        _, (q, k, v), bias = _train_qkv(g, dev, torch.float32)
        a32 = _sdpa_args(q, k, v, bias.detach())
        out["K2_L128_fp32"] = library_ms(
            lambda: F.scaled_dot_product_attention(*a32[:3],
                                                   attn_mask=a32[3]))
        out["K3_fp32"] = library_ms(lambda: F.scaled_dot_product_attention(
            *a32[:3], attn_mask=a32[3], dropout_p=DROP_RATE))
    leaves32 = [t.detach().transpose(1, 2).contiguous().requires_grad_()
                for t in (q, k, v)]
    o32 = F.scaled_dot_product_attention(*leaves32, attn_mask=a32[3],
                                         dropout_p=DROP_RATE)
    gy32 = torch.randn(o32.shape, generator=g, device=dev)
    out["K4_fp32"] = library_ms(lambda: torch.autograd.grad(
        o32, leaves32, gy32, retain_graph=True))
    for dtype, suffix in ((torch.float32, "_fp32"), (torch.bfloat16, "")):
        _, (q, k, v), bias = _train_qkv(g, dev, dtype, L=173)
        with torch.no_grad():
            a173 = _sdpa_args(q, k, v, bias.detach())
            out[f"K3{suffix}_L173"] = library_ms(
                lambda a=a173: F.scaled_dot_product_attention(
                    *a[:3], attn_mask=a[3], dropout_p=DROP_RATE))
        leaves173 = [t.detach().transpose(1, 2).contiguous()
                     .requires_grad_() for t in (q, k, v)]
        o173 = F.scaled_dot_product_attention(*leaves173,
                                              attn_mask=a173[3],
                                              dropout_p=DROP_RATE)
        gy173 = torch.randn(o173.shape, generator=g, device=dev).to(dtype)
        out[f"K4{suffix}_L173"] = library_ms(
            lambda o=o173, x=leaves173, y=gy173: torch.autograd.grad(
                o, x, y, retain_graph=True))
    with torch.no_grad():
        _, (q, k, v), bias = _train_qkv(g, dev, torch.bfloat16)
        bias = bias.detach()
        a = _sdpa_args(q, k, v, bias)
        out["K2_L128"] = library_ms(
            lambda: F.scaled_dot_product_attention(*a[:3], attn_mask=a[3]))
        out["K3"] = library_ms(lambda: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], dropout_p=DROP_RATE))
    leaves = [t.detach().transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=a[3],
                                       dropout_p=DROP_RATE)
    gy = torch.randn(o.shape, generator=g, device=dev).to(torch.bfloat16)
    out["K4"] = library_ms(lambda: torch.autograd.grad(o, leaves, gy,
                                                       retain_graph=True))
    x = torch.randn(16, 128, 768, generator=g, device=dev).to(torch.bfloat16)
    out["K5"] = library_ms(lambda: F.dropout(x, DROP_RATE, training=True))
    return out


PHILOX_PROBE = r"""
#include "common.cuh"
extern "C" __global__ void probe_words4(const unsigned* c, uint4* o,
                                        unsigned long long seed) {
  const int i = threadIdx.x;
  o[i] = philox4(c[i], c[i + 32], c[i + 64], c[i + 96], seed);
}
extern "C" __global__ void probe_none4(const unsigned* c, uint4* o,
                                       unsigned long long seed) {
  const int i = threadIdx.x;
  const unsigned s = (unsigned)seed ^ (unsigned)(seed >> 32);
  o[i] = make_uint4(c[i] ^ s, c[i + 32] ^ s, c[i + 64] ^ s, c[i + 96] ^ s);
}
"""


def philox_sass_instructions():
    """SASS instructions of one Philox4x32-10 evaluation of all four words
    (csrc/common.cuh), as K3, K4 and K5 use it, counted with cuobjdump: a
    probe kernel that evaluates it once per thread, minus one that reads
    and writes the same words without it; nvcc for sm_90a at -O3, as the
    kernels are built. Returns (the count, the raw counts)."""
    import re

    from vlbert_tpu_torch.kernels import build

    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    d = tempfile.mkdtemp(prefix="philox_probe_")
    try:
        src = os.path.join(d, "probe.cu")
        with open(src, "w") as f:
            f.write(PHILOX_PROBE)
        cubin = os.path.join(d, "probe.cubin")
        subprocess.run([nvcc, "-cubin", *build.NVCC_FLAGS[:2], "-O3",
                        "-I", str(build.CSRC_DIR), "-o", cubin, src],
                       check=True, capture_output=True, text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    finally:
        shutil.rmtree(d, ignore_errors=True)
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)[@A-Z]",
                               line):
            counts[name] += 1
    return counts["probe_words4"] - counts["probe_none4"], counts


def int_issue_per_s():
    """int32 operations per second the card can issue: SMs x int lanes x
    the maximum SM clock nvidia-smi reports."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_LANES_PER_SM * mhz * 1e6, sms, mhz


def make_queries(n=8):
    import numpy as np

    rng = np.random.default_rng(SEED)
    exprs = ["the man on the left", "red car parked near the tree",
             "woman holding an umbrella", "the smaller dog",
             "second chair from the right", "blue shirt guy in the back",
             "plate with the sandwich", "bus behind the taxi"]
    counts = [2, 5, 9, 15, 3, 12, 7, 15]
    queries = []
    for i in range(n):
        h, w = (480, 640) if i % 2 == 0 else (640, 480)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = counts[i]
        x1 = rng.uniform(0, w * 0.7, k)
        y1 = rng.uniform(0, h * 0.7, k)
        x2 = np.minimum(x1 + rng.uniform(8, w * 0.5, k), w - 1)
        y2 = np.minimum(y1 + rng.uniform(8, h * 0.5, k), h - 1)
        boxes = np.stack([x1, y1, x2, y2], 1).astype(np.float32)
        boxes[0] = (0, h * 0.5, w - 1, h - 1)    # touches three edges
        queries.append((img, boxes, exprs[i]))
    return queries


def serve_checked(srv, queries, layers=12):
    """Answers each query once through the RefCOCOServer ``srv``: each
    must launch K1 once and K2 once a layer, and give finite scores of the
    candidates' shape and a best box among its candidates. Returns the
    launches of them all, the counts set to 0 first."""
    import numpy as np
    from vlbert_tpu_torch.ops.attention import fused_attention
    from vlbert_tpu_torch.ops.roi_align import roi_align

    roi_align.launches = fused_attention.launches = 0
    for i, (img, cand, expr) in enumerate(queries):
        before = roi_align.launches, fused_attention.launches
        r = srv.query(img, cand, expr)
        delta = (roi_align.launches - before[0],
                 fused_attention.launches - before[1])
        scores = r["candidate_scores"]
        if delta != (1, layers):
            raise AssertionError(f"query {i}: launches (K1, K2) {delta}, "
                                 f"expected (1, {layers})")
        if not (scores.shape == (len(cand),) and np.isfinite(scores).all()
                and np.isfinite(r["image_box_score"])):
            raise AssertionError(f"query {i}: non-finite or misshapen "
                                 f"scores {scores}")
        if not 0 <= r["best_index"] < len(cand):
            raise AssertionError(f"query {i}: best_index {r['best_index']} "
                                 f"outside {len(cand)} candidates")
        if not np.array_equal(r["box"], cand[r["best_index"]]):
            raise AssertionError(f"query {i}: box {r['box']} != candidate "
                                 f"{cand[r['best_index']]}")
    return {"roi_align": roi_align.launches,
            "fused_attention": fused_attention.launches}


@contextlib.contextmanager
def plain_versions():
    """Route the model's ROIAlign and attention calls to the plain PyTorch
    versions, explicitly, for the end-to-end comparison."""
    import vlbert_tpu_torch.models.bert as bert
    import vlbert_tpu_torch.models.fast_rcnn as fast_rcnn
    from vlbert_tpu_torch.ops.attention import plain_attention
    from vlbert_tpu_torch.ops.roi_align import roi_align_plain

    saved = fast_rcnn.roi_align, bert.fused_attention
    fast_rcnn.roi_align, bert.fused_attention = roi_align_plain, plain_attention
    try:
        yield
    finally:
        fast_rcnn.roi_align, bert.fused_attention = saved


FIXTURE_WORDS = ["what", "is", "the", "color", "of", "man", "holding", "how",
                 "many", "are", "there", "in", "picture", "left", "right",
                 "dog", "cat", "on", "table", "people", "yes", "no", "red",
                 "blue", "two", "three", "?"]
FIXTURE_ANSWERS = ["yes", "no", "red", "blue", "two", "three"]


def write_vocab(path, size=30522):
    """[PAD] 0, [unused*] 1-99, [UNK] 100, [CLS] 101, [SEP] 102, [MASK]
    103 (bert-base-uncased's ids), the question words, then fillers."""
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + FIXTURE_WORDS)
    vocab += [f"tok{i}" for i in range(size - len(vocab))]
    with open(path, "w") as f:
        f.write("\n".join(vocab) + "\n")


def write_vqa_fixture(root, n_train=64, n_val=32, feat_dim=2048,
                      n_answers=3129, min_boxes=10, max_boxes=100, seed=0):
    """A synthetic VQA set in the VQA dataset's own on-disk format under
    ``root`` (the real data and vocabulary are not in the repo): jsonl rows
    ``train.jsonl`` and ``val.jsonl``, one json per image with base64
    float32 ``boxes`` and ``features``, a generated BERT ``vocab.txt`` and
    an answer vocabulary. Each question's dominant answer is visible in its
    image's features, so the loss can fall. Returns (data_dir, vocab_dir,
    answer_file)."""
    import base64

    import numpy as np

    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "vqa")
    vocab_dir = os.path.join(root, "bert")
    os.makedirs(os.path.join(data_dir, "boxes"), exist_ok=True)
    os.makedirs(vocab_dir, exist_ok=True)
    write_vocab(os.path.join(vocab_dir, "vocab.txt"))
    answers = ["<unk>"] + FIXTURE_ANSWERS
    answers += [f"answer{i}" for i in range(n_answers - len(answers))]
    answer_file = os.path.join(data_dir, "answers.txt")
    with open(answer_file, "w") as f:
        f.write("\n".join(answers) + "\n")

    rows = []
    for i in range(n_train + n_val):
        w, h = int(rng.integers(400, 641)), int(rng.integers(300, 481))
        nb = int(rng.integers(min_boxes, max_boxes + 1))
        xy = rng.uniform(0, [w * 0.7, h * 0.7], (nb, 2))
        wh = rng.uniform(8, [w * 0.3, h * 0.3], (nb, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        feats = np.maximum(rng.normal(size=(nb, feat_dim)), 0) \
            .astype(np.float32)
        label = i % len(FIXTURE_ANSWERS)
        feats[:, label] += 3.0          # the answer is visible in the image
        with open(os.path.join(data_dir, "boxes", f"{i}.json"), "w") as f:
            json.dump({"num_boxes": nb,
                       "boxes": base64.b64encode(boxes.tobytes()).decode(),
                       "features": base64.b64encode(feats.tobytes()).decode()},
                      f)
        n_words = int(rng.integers(4, 12))
        question = " ".join(rng.choice(FIXTURE_WORDS[:-1], n_words)) + " ?"
        rows.append({"question_id": i, "image_id": i, "question": question,
                     "image_fn": f"img/{i}.jpg", "box_fn": f"boxes/{i}.json",
                     "width": w, "height": h,
                     "answers": [FIXTURE_ANSWERS[label]] * 7
                     + [FIXTURE_ANSWERS[(label + 1) % len(FIXTURE_ANSWERS)]]
                     * 3})
    for name, part in (("train.jsonl", rows[:n_train]),
                       ("val.jsonl", rows[n_train:])):
        with open(os.path.join(data_dir, name), "w") as f:
            f.write("\n".join(json.dumps(r) for r in part) + "\n")
    return data_dir, vocab_dir, answer_file


def vqa_train_config(root):
    """cfgs/vqa/base_v5e_bf16.yaml pointed at a synthetic VQA set under
    ``root``, with the overrides printed."""
    from vlbert_tpu_torch.utils.config import load_config

    data_dir, vocab_dir, answer_file = write_vqa_fixture(
        root, n_train=64, n_val=32, seed=SEED)
    cfg = load_config("vqa", VQA_CFG)
    overrides = {
        # no VL-BERT checkpoint or BERT weights are in the repo
        "NETWORK.PARTIAL_PRETRAIN": "",
        "NETWORK.BERT_MODEL_NAME": vocab_dir,
        "DATASET.DATASET_PATH": data_dir,
        "DATASET.ROOT_PATH": data_dir,
        "DATASET.TRAIN_ANNOTATION_FILE": "train.jsonl",
        "DATASET.VAL_ANNOTATION_FILE": "val.jsonl",
        "DATASET.ANSWER_VOCAB_FILE": answer_file,
        "OUTPUT_PATH": os.path.join(root, "out"),
        "RNG_SEED": SEED,
        # 64 samples / batch 16 = 4 steps per epoch, 8 epochs
        "TRAIN.END_EPOCH": 8,
        "LOG_FREQUENT": 4,
        # no warm-up and base LR 16 x 6.25e-6 = 1e-4, so that the loss
        # visibly falls within 32 steps on a small repeated set
        "TRAIN.WARMUP": False,
        "TRAIN.LR": 6.25e-6,
    }
    return apply_overrides(cfg, overrides), overrides


def apply_overrides(cfg, overrides):
    """Set each dotted config path of ``overrides`` in place."""
    for path, value in overrides.items():
        node = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


@contextlib.contextmanager
def plain_training():
    """Route the training path's attention and dropout calls to the plain
    PyTorch versions (plain Philox, so the masks are the kernels')."""
    import vlbert_tpu_torch.models.bert as bert
    import vlbert_tpu_torch.ops.dropout as dropout
    from vlbert_tpu_torch.ops.attention import (plain_attention,
                                                plain_attention_dropout)

    saved = (bert.fused_attention, bert.fused_attention_dropout,
             dropout.hw_dropout)
    bert.fused_attention = plain_attention
    bert.fused_attention_dropout = plain_attention_dropout
    dropout.hw_dropout = dropout.plain_dropout
    try:
        yield
    finally:
        (bert.fused_attention, bert.fused_attention_dropout,
         dropout.hw_dropout) = saved


def _launch_counts():
    from vlbert_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import hw_dropout
    from vlbert_tpu_torch.ops.roi_align import roi_align

    return {"K1": roi_align.launches, "K1b": roi_align.bwd_launches,
            "K2": fused_attention.launches,
            "K3": fused_attention_dropout.launches,
            "K4": fused_attention_dropout.bwd_launches,
            "K5_fwd": hw_dropout.launches,
            "K5_bwd": hw_dropout.bwd_launches}


def _zero_counts():
    from vlbert_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import hw_dropout
    from vlbert_tpu_torch.ops.roi_align import roi_align

    roi_align.launches = roi_align.bwd_launches = fused_attention.launches = 0
    fused_attention_dropout.launches = fused_attention_dropout.bwd_launches = 0
    hw_dropout.launches = hw_dropout.bwd_launches = 0


def train_launches(steps, val_batches, layers=12, micro=1):
    """Launches of ``steps`` VQA train steps of ``micro`` micro-steps and
    ``val_batches`` validation batches at full width: per micro-step K3 and
    K4 once a layer, K5 at 2 sites a layer and 3 more forward (the
    embeddings', obj_downsample's, the classifier's), 2 more backward
    (obj_downsample's input, precomputed features, needs no gradient);
    K2 once a layer and batch; no K1. Base: 27 and 26."""
    n = steps * micro
    return {"K1": 0, "K1b": 0, "K2": layers * val_batches, "K3": layers * n,
            "K4": layers * n, "K5_fwd": (3 + 2 * layers) * n,
            "K5_bwd": (2 + 2 * layers) * n}


@contextlib.contextmanager
def checkpoint_writes_recorded():
    """train_net's checkpoint writes replaced by a record of each one asked
    for, (epoch, is_best): the steps phase 7 times then overlap no write
    (phase 9 makes and times the writes). Yields the record."""
    from vlbert_tpu_torch.training import checkpoint as ckpt

    saved, calls = ckpt.save_checkpoint, []

    def record(prefix, epoch, model, optimizer, extra=None, async_write=False,
               mirror_best_to=None, write=True):
        calls.append((epoch, mirror_best_to is not None))
        return f"{prefix}-{epoch:04d}.model"

    ckpt.save_checkpoint = record
    try:
        yield calls
    finally:
        ckpt.save_checkpoint = saved


def step_p50(step_ms):
    """Median step ms over steps 3.. (the first two build caches)."""
    ms = sorted(step_ms[2:])
    return ms[len(ms) // 2]


def epoch_medians(step_ms, steps_per_epoch=4):
    """The median step ms of each epoch."""
    return [round(sorted(step_ms[i:i + steps_per_epoch])[
        steps_per_epoch // 2], 2)
        for i in range(0, len(step_ms), steps_per_epoch)]


def train_phase(cfg, device="cuda"):
    """train_net at full width; returns (model, history, launches)."""
    import types

    import torch
    from vlbert_tpu_torch.engine.train import train_net

    args = types.SimpleNamespace(model_dir=cfg.OUTPUT_PATH, device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    model, history = train_net(args, cfg, "vqa")
    launches = _launch_counts()
    steps = len(history["loss"])
    n_val = -(-32 // cfg.VAL.BATCH_IMAGES) * len(history["val"])
    want = train_launches(steps, n_val)
    if launches != want or n_val == 0:
        raise AssertionError(f"train launches {launches}, expected {want}")
    loss = history["loss"]
    if not (all(map(math.isfinite, loss))
            and sum(loss[-4:]) < sum(loss[:4])):
        raise AssertionError(f"train loss did not fall: {loss}")
    return model, history, launches


def first_train_batch(cfg, task, dev):
    """The first batch of the config's training loader, on ``dev``."""
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.training.loop import to_device

    loader = make_dataloader(cfg, task, "train")
    try:
        return to_device(next(iter(loader)), dev)
    finally:
        loader.shutdown()


def profile_steps(model, cfg, task="vqa", n=4, batch=None, counts=False):
    """Device busy time and top kernels over ``n`` optimizer steps of
    ``model`` (a fresh optimizer, the config's gradient accumulation) on
    ``batch``, by default the phase's first; with ``counts`` also {kernel
    name: launches a step}."""
    import torch
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import Optimizer

    if batch is None:
        batch = first_train_batch(cfg, task, "cuda")
    accum = max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    step = make_train_step(model, Optimizer(cfg, model, 4), task, cfg, accum)
    step(batch, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(batch, SEED + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    timed = device_by_name(lambda: step(batch, SEED), n)
    by_name = {k: us for k, (us, _) in timed.items()}
    busy_ms = sum(by_name.values()) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = wall_ms, busy_ms, [(k[:60], v / 1e3 / n) for k, v in top]
    if counts:
        return out + ({k: c / n for k, (_, c) in timed.items()},)
    return out


# leaf groups whose worst gradient gap step_agreement reports apart:
# VL-BERT, the backbone stages that train (3 = layer2, 4 = layer3) and the
# conv5 head
E2E_LEAF_GROUPS = {
    "vlbert": "vlbert.",
    "stage3": "image_feature_extractor.backbone.layer2.",
    "stage4": "image_feature_extractor.backbone.layer3.",
    "roi_head": "image_feature_extractor.roi_head_feature_extractor."}


@contextlib.contextmanager
def plain_e2e_training():
    """``plain_training``, and ROIAlign's plain version: autograd through
    its einsums gives the plain dF (K1b's plain version)."""
    import vlbert_tpu_torch.models.fast_rcnn as fast_rcnn
    from vlbert_tpu_torch.ops.roi_align import roi_align_plain

    saved = fast_rcnn.roi_align
    fast_rcnn.roi_align = roi_align_plain
    try:
        with plain_training():
            yield
    finally:
        fast_rcnn.roi_align = saved


def step_agreement(cfg, dev, task="vqa", plain=plain_training,
                   want_launches=None, groups=None, image_rtol=None,
                   batch=None):
    """One fp32 optimizer step from the same weights and seed with the
    kernels and with the plain versions (``plain``), over the config's
    gradient accumulation; then the kernel step again, which must give
    bit-identical parameters (cuDNN and torch held to their deterministic
    algorithms for the three steps). ``want_launches``: the kernel step's launches (default: one
    VQA step's); ``groups``: {name: parameter prefix} whose worst leaf is
    reported apart, each required to have a gradient; ``image_rtol``:
    the image path's leaves (IMAGE_LEAF_PREFIX) held to it instead of
    STEP_RTOL's; ``batch``: the step's batch, by default the training
    loader's first. The kernel step runs under the profiler: its
    attention kernels' device ms by name are returned as
    ``attention_ms``."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import (Optimizer,
                                                 apply_trainable_mask)

    want_launches = want_launches or train_launches(1, 0)
    if batch is None:
        batch = first_train_batch(cfg, task, dev)
    model = build_module(cfg, task, dtype=torch.float32, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    apply_trainable_mask(model, cfg)
    twin, again = copy.deepcopy(model), copy.deepcopy(model)
    accum = max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    results, leaf_grads = [], []
    # cuDNN's deterministic algorithms, and torch's where it has them
    # (gather's backward, which VCR's object-tag gather runs, otherwise
    # sums with atomics); warn_only: torch raises nowhere on an op that
    # has none
    saved_modes = (torch.backends.cudnn.deterministic,
                   torch.are_deterministic_algorithms_enabled(),
                   torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        for m, ctx, window in ((model, contextlib.nullcontext(), prof),
                               (twin, plain(), contextlib.nullcontext()),
                               (again, contextlib.nullcontext(),
                                contextlib.nullcontext())):
            opt = Optimizer(cfg, m, 4)
            lr = opt.lr()
            kept, opt_step = {}, opt.step

            def step_and_keep(grads, opt=opt, kept=kept, opt_step=opt_step):
                kept.update((n, g.detach().clone())
                            for n, g in zip(opt.names, grads))
                return opt_step(grads)

            opt.step = step_and_keep
            _zero_counts()
            with window, ctx:
                loss, dm = make_train_step(m, opt, task, cfg, accum)(
                    batch, SEED + 5)
                torch.cuda.synchronize()
            results.append((float(loss), float(dm["grad_total_norm"][0]),
                            _launch_counts()))
            leaf_grads.append(kept)
    finally:
        torch.backends.cudnn.deterministic = saved_modes[0]
        torch.use_deterministic_algorithms(saved_modes[1],
                                           warn_only=saved_modes[2])
    (l1, n1, c1), (l2, n2, c2), _ = results
    g1, g2 = leaf_grads[:2]
    attention_ms = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and "attn" in e.name:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            attention_ms[name] = attention_ms.get(name, 0.0) \
                + e.device_time / 1e3
    if g1.keys() != g2.keys() or not g1:
        raise AssertionError("fp32 step: the two steps updated different "
                             "parameters")
    leaf_max = {k: g.abs().max().item() for k, g in g2.items()}
    floor = LEAF_FLOOR * max(leaf_max.values())
    leaf_gap = {k: _maxerr(g1[k], g2[k]) / max(leaf_max[k], floor)
                for k in g2}
    image = {k for k in g2 if image_rtol and k.startswith(IMAGE_LEAF_PREFIX)}
    worst_leaf = max((k for k in g2 if k not in image), key=leaf_gap.get)
    by_group = {}
    for name, prefix in (groups or {}).items():
        keys = [k for k in g2 if k.startswith(prefix) and leaf_max[k] > 0]
        if not keys:
            raise AssertionError(f"fp32 step: no gradient reached {name} "
                                 f"({prefix}*)")
        by_group[name] = max(leaf_gap[k] for k in keys)
    # the same seed and batch give a bit-identical step
    p3 = dict(again.named_parameters())
    repeat_equal = all(torch.equal(p, p3[k])
                       for k, p in model.named_parameters())
    if not repeat_equal:
        gap = max((p - p3[k]).abs().max().item()
                  for k, p in model.named_parameters())
        raise AssertionError(f"fp32 step: a repeat from the same weights and "
                             f"seed gave different parameters (max abs "
                             f"difference {gap:.3e})")
    # the kernel step ran the kernels, the plain step none of them
    if c1 != want_launches or any(c2.values()):
        raise AssertionError(f"fp32 step launches: kernels {c1} (want "
                             f"{want_launches}), plain {c2}")
    p2 = dict(twin.named_parameters())
    moved = {k: (p - p2[k]).abs() for k, p in model.named_parameters()}
    dparam = max(d.max().item() for d in moved.values())

    def element_at(k):
        """The element of leaf ``k`` that moved furthest apart, and both
        gradients there relative to the leaf's scale."""
        at = moved[k].argmax()
        out = {"leaf": k, "per_lr": moved[k].flatten()[at].item() / lr}
        if k in g2:
            scale = max(leaf_max[k], floor)
            out.update(kernel_g=g1[k].flatten()[at].item() / scale,
                       plain_g=g2[k].flatten()[at].item() / scale,
                       scale=scale)
        return out

    # From pixels (image_rtol) the image path's leaves are held by their
    # gradients alone: an element of theirs whose gradient lies near AdamW's
    # eps after clipping can change its first step (about
    # lr * g / (|g| + eps)) by up to 2 lr within image_rtol's gradient gap.
    # The other leaves' parameters are held to param_per_lr.
    dheld = max((moved[k].max().item() for k in moved if k not in image),
                default=0.0)
    far = max(moved, key=lambda k: moved[k].max().item())
    worst_held = max((k for k in moved if k not in image),
                     key=lambda k: moved[k].max().item())
    far_at = {"all": element_at(far), "held": element_at(worst_held)}
    checks = {"loss": (abs(l1 - l2) / abs(l2), STEP_RTOL["loss"]),
              "grad_norm": (abs(n1 - n2) / n2, STEP_RTOL["grad_norm"]),
              "leaf_grad": (leaf_gap[worst_leaf], STEP_RTOL["leaf_grad"]),
              "param_per_lr": (dheld / lr, STEP_RTOL["param_per_lr"])}
    if image:
        worst_image = max(image, key=leaf_gap.get)
        checks["image_leaf_grad"] = (leaf_gap[worst_image], image_rtol)
    bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"fp32 step: (err, tol) {checks}; worst leaf "
                             f"gradient {worst_leaf}; furthest parameter "
                             f"{far_at}")
    return {"loss": (l1, l2), "grad_norm": (n1, n2), "checks": checks,
            "launches": (c1, c2), "n_leaves": len(g2),
            "worst_leaf": worst_leaf, "max_param_diff": dparam, "lr": lr,
            "furthest_param": far_at, "by_group": by_group,
            "attention_ms": attention_ms}


# the answer head of a pretrain checkpoint: the VQA classifier's transform
# (final_mlp.0) comes from the MLM head's, its last layer from nowhere
PRETRAIN_HEAD = "vlbert.mlm_head.predictions.transform."


def write_pretrain_checkpoint(cfg, path):
    """A VL-BERT pretrain checkpoint in the reference's layout for the VQA
    model of ``cfg``, from random seed-SEED weights: every name under the
    DDP ``module.`` prefix, the classifier's transform under the MLM head's
    name, no answer head. Returns its state_dict (on the CPU)."""
    import torch
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module

    model = build_module(cfg, "vqa", dtype=torch.float32, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    sd = {}
    for k, t in model.state_dict().items():
        if k.startswith("final_mlp.0."):
            k = PRETRAIN_HEAD + k[len("final_mlp.0."):]
        elif k.startswith("final_mlp."):
            continue
        sd["module." + k] = t.detach().cpu()
    torch.save({"state_dict": sd}, path)
    return sd


def resume_phase(root, cfg7_overrides):
    """Phase 9: train_net warm-started from a reference-layout pretrain
    checkpoint, 2 epochs of 4 steps with a checkpoint each, then an
    AUTO_RESUME to epoch 3; then save and load times of its state. Returns
    (config, results)."""
    import types

    import torch
    import vlbert_tpu_torch.engine.train as t_train
    from vlbert_tpu_torch.training import checkpoint as ckpt
    from vlbert_tpu_torch.training.optim import Optimizer
    from vlbert_tpu_torch.utils.config import load_config

    pretrain = os.path.join(root, "pretrain.model")
    overrides = {**cfg7_overrides,
                 "NETWORK.PARTIAL_PRETRAIN": pretrain,
                 "OUTPUT_PATH": os.path.join(root, "out9"),
                 # train_net's init differs from the file's seed-0 weights
                 "RNG_SEED": SEED + 1,
                 "TRAIN.END_EPOCH": 2, "CHECKPOINT_FREQUENT": 1,
                 "TPU.ASYNC_CHECKPOINT": True, "TRAIN.AUTO_RESUME": True}
    cfg = apply_overrides(load_config("vqa", VQA_CFG), overrides)
    file_sd = write_pretrain_checkpoint(cfg, pretrain)
    res = {"overrides": {k: v for k, v in overrides.items()
                         if k not in cfg7_overrides
                         or cfg7_overrides[k] != v},
           "pretrain_mb": os.path.getsize(pretrain) / 2 ** 20}

    orig = t_train.apply_partial_pretrain

    def checked(model, config):
        t0 = time.perf_counter()
        report = orig(model, config)
        res["partial_pretrain_s"] = time.perf_counter() - t0
        sd = model.state_dict()
        want = {k for k in sd if not k.startswith("final_mlp.2.")}
        src = {k[len("module."):].replace(PRETRAIN_HEAD, "final_mlp.0."): t
               for k, t in file_sd.items()}
        res["from_file"] = len(report[0])
        res["warm_start_ok"] = (set(report[0]) == want and all(
            torch.equal(sd[k].cpu(), src[k]) for k in want))
        return report

    args = types.SimpleNamespace(model_dir=cfg.OUTPUT_PATH, device="cuda")
    t_train.apply_partial_pretrain = checked
    try:
        _zero_counts()
        _, h1 = t_train.train_net(args, cfg, "vqa")
        res["run1_launches"] = _launch_counts()
    finally:
        t_train.apply_partial_pretrain = orig
    res["run1"] = h1
    cfg.TRAIN.END_EPOCH = 3
    _zero_counts()
    t0 = time.perf_counter()
    model, h2 = t_train.train_net(args, cfg, "vqa")
    res["run2_s"] = time.perf_counter() - t0
    res["run2_launches"] = _launch_counts()
    res["run2"] = h2
    out = os.path.join(cfg.OUTPUT_PATH, "vqa_train")
    prefix = os.path.join(out, cfg.MODEL_PREFIX)
    res["files"] = sorted(os.listdir(out))
    res["best"] = f"{prefix}-best.model"

    # the save / load cost of this state, on the trained model
    opt = Optimizer(cfg, model, 4)
    tprefix = os.path.join(root, "timing")
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(tprefix, 0, model, opt)
    res["save_s"] = time.perf_counter() - t0
    res["file_mb"] = os.path.getsize(path) / 2 ** 20
    t0 = time.perf_counter()
    ckpt.save_checkpoint(tprefix, 1, model, opt, async_write=True)
    res["save_blocking_s"] = time.perf_counter() - t0
    ckpt.wait_for_pending_save()
    res["save_async_total_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.load_checkpoint(path, model, opt)
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t0
    for e in (0, 1):
        os.remove(f"{tprefix}-{e:04d}.model")
    return cfg, res


def vqa_queries(n=8, feat_dim=2048):
    """n distinct synthetic VQA questions over 10-100 precomputed boxes
    each: (question, boxes, features, width, height)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 9)
    queries = []
    for i in range(n):
        w, h = int(rng.integers(400, 641)), int(rng.integers(300, 481))
        nb = int(rng.integers(10, 101))
        xy = rng.uniform(0, [w * 0.7, h * 0.7], (nb, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, [w * 0.3, h * 0.3],
                                                     (nb, 2))], 1)
        feats = np.maximum(rng.normal(size=(nb, feat_dim)), 0)
        question = " ".join(FIXTURE_WORDS[j % 26] for j in
                            range(i, i + 4 + i)) + " ?"
        queries.append((question, boxes.astype(np.float32),
                        feats.astype(np.float32), w, h))
    return queries


def vqa_serve_phase(cfg, best):
    """Phase 10: the -best checkpoint behind VQAServer (bucket 64 + 108,
    bf16): launches a query, latency, and fp32 kernels vs plain versions
    on one query. Returns results."""
    import numpy as np
    import torch
    from vlbert_tpu_torch.data.tokenization import BertTokenizer
    from vlbert_tpu_torch.engine.serve import VQAServer
    from vlbert_tpu_torch.engine.test import _load_params
    from vlbert_tpu_torch.models.task_modules import build_module

    tok = BertTokenizer.from_pretrained(cfg.NETWORK.BERT_MODEL_NAME)
    with open(cfg.DATASET.ANSWER_VOCAB_FILE) as f:
        answers = [line.strip() for line in f if line.strip()]
    servers = []
    for dtype in (torch.bfloat16, torch.float32):
        model = build_module(cfg, "vqa", dtype=dtype, device="cuda")
        loaded = _load_params(model, best)
        if len(loaded) != len(model.state_dict()):
            raise AssertionError(f"VQAServer: {len(loaded)} of "
                                 f"{len(model.state_dict())} tensors loaded")
        servers.append(VQAServer(
            model, tok, answers,
            feat_dim=cfg.DATASET.get("PRECOMPUTED_FEAT_DIM", 2048)))
    srv, srv32 = servers
    queries = vqa_queries(feat_dim=srv.feat_dim)
    srv.query(*queries[0])                                   # warm-up
    torch.cuda.synchronize()
    res = {"answers": [], "per_query": []}
    for q in queries:
        _zero_counts()
        res["answers"].append(srv.query(*q))
        res["per_query"].append(_launch_counts())
    res["lat"] = srv.measure_latency(queries * 3, warmup=3)
    batch = srv32.preprocess(*queries[3])
    _zero_counts()
    a = srv32.infer(batch)["label_logits"][0]
    res["fp32_launches"] = _launch_counts()
    with plain_versions():
        b = srv32.infer(batch)["label_logits"][0]
    res["fp32_err"] = float(np.abs(a - b).max())
    res["fp32_argmax"] = (int(a.argmax()), int(b.argmax()))
    res["fp32_finite"] = bool(np.isfinite(a).all())
    res["L"] = srv.max_text + srv.max_boxes + 1
    return res


def _timed_loop(config, task, ckpt_path, mode, profile=False):
    """(samples, seconds, device-busy seconds or None) of the test driver's
    inference loop over its loader, warm (a first pass compiles nothing but
    fills the caches); ``profile``: the summed device time of a third pass
    in a torch.profiler window."""
    import torch
    from vlbert_tpu_torch.engine import test as t_test

    model, loader, n_label = t_test.setup_inference(config, task, ckpt_path,
                                                    mode, "cuda")
    conditioned = t_test.is_conditioned(config, task, mode)

    def loop():
        t_test.infer_loader(model, loader, n_label, "cuda", conditioned)

    try:
        loop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        busy_s = sum(device_us_by_name(loop, 1).values()) / 1e6 \
            if profile else None
        return len(loader.dataset), loop_s, busy_s
    finally:
        loader.shutdown()


def vqa_test_phase(cfg9, best, root):
    """Phase 11a: test_net_vqa on a 64-question test split (the training
    set's images under new question ids, no answers) from phase 9's
    checkpoint. Returns results."""
    from vlbert_tpu_torch.engine import test as t_test

    data_dir = cfg9.DATASET.DATASET_PATH
    with open(os.path.join(data_dir, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    with open(os.path.join(data_dir, "test.jsonl"), "w") as f:
        for r in rows:
            r = {k: v for k, v in r.items() if k != "answers"}
            r["question_id"] += 1000
            f.write(json.dumps(r) + "\n")
    cfg = cfg9
    cfg.DATASET.TEST_ANNOTATION_FILE = "test.jsonl"
    out_dir = os.path.join(root, "results")
    _zero_counts()
    t0 = time.perf_counter()
    answers = t_test.test_net(cfg, "vqa", best, out_dir, "smoke", "test",
                              "cuda")
    res = {"wall_s": time.perf_counter() - t0, "launches": _launch_counts(),
           "batches": -(-len(rows) // cfg.TEST.BATCH_IMAGES)}
    with open(t_test.result_file(out_dir, "smoke", "vqa", "test")) as f:
        res["rows"] = json.load(f)
    res["ok"] = (res["rows"] == answers and [a["question_id"] for a in
                                            answers]
                 == [r["question_id"] + 1000 for r in rows])
    res["n"], res["loop_s"], _ = _timed_loop(cfg, "vqa", best, "test")
    return res


REFCOCO_EXPRS = ("the man on the left", "red car parked near the tree",
                 "woman holding an umbrella", "the smaller dog")


def write_refcoco_fixture(root, n_per_image=4):
    """Synthetic RefCOCO+ rows in the dataset's jsonl form {image_fn,
    width, height, boxes, gt_box, sentence}: the landscape images of
    ``make_queries`` (a test batch shares one canvas orientation), each
    with its candidate boxes and ``n_per_image`` sentences. Returns
    (data_dir, rows)."""
    from PIL import Image

    d = os.path.join(root, "refcoco")
    os.makedirs(os.path.join(d, "img"), exist_ok=True)
    rows = []
    for i, (img, boxes, _) in enumerate(make_queries()):
        if img.shape[0] > img.shape[1]:
            continue
        fn = f"img/{i}.png"
        Image.fromarray(img).save(os.path.join(d, fn))
        for j in range(n_per_image):
            rows.append({"image_id": i, "image_fn": fn,
                         "width": int(img.shape[1]),
                         "height": int(img.shape[0]),
                         "boxes": boxes.tolist(),
                         "gt_box": boxes[j % len(boxes)].tolist(),
                         "sentence": REFCOCO_EXPRS[j]})
    with open(os.path.join(d, "ann.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return d, rows


def _reference_layout(sd):
    """Port names -> a reference RefCOCO+ task checkpoint's: the DDP
    ``module.`` prefix and VL-BERT under ``vlbert._module.``."""
    return {"module." + ("vlbert._module." + k[len("vlbert."):]
                         if k.startswith("vlbert.") else k): t.cpu()
            for k, t in sd.items()}


def refcoco_test_phase(root, vocab_dir):
    """Phase 11b: ``python -m vlbert_tpu_torch.engine.test --task
    refcoco`` (its main) from the shipped RefCOCO+ config on the synthetic
    rows, from a reference-layout .model of phase 4's weights; then the
    inference loop's samples/s, and fp32 kernels vs plain versions on one
    batch. Returns results."""
    import numpy as np
    import torch
    import yaml
    from vlbert_tpu_torch.data.datasets.refcoco import bbox_iou
    from vlbert_tpu_torch.engine import test as t_test
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import to_device
    from vlbert_tpu_torch.utils.config import load_config

    data_dir, rows = write_refcoco_fixture(root)
    with open(CFG) as f:
        raw = yaml.safe_load(f)
    raw["DATASET"].update(DATASET_PATH=data_dir, ROOT_PATH=root,
                          VAL_ANNOTATION_FILE="ann.jsonl",
                          TEST_ANNOTATION_FILE="ann.jsonl")
    raw["NETWORK"]["BERT_MODEL_NAME"] = vocab_dir
    # as phase 4: the config's 0.0 visual scales would blind random weights
    raw["NETWORK"]["VLBERT"].update(visual_scale_text_init=1.0,
                                    visual_scale_object_init=1.0)
    cfg_path = os.path.join(root, "refcoco_smoke.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    cfg = load_config("refcoco", cfg_path)
    model = build_module(cfg, "refcoco", dtype=torch.bfloat16, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    ckpt_path = os.path.join(root, "vl-bert_base_refcoco_ref.model")
    torch.save({"state_dict": _reference_layout(model.state_dict())},
               ckpt_path)
    loaded = len(t_test._load_params(model, ckpt_path))
    res_loaded = loaded == len(model.state_dict())
    del model
    out_dir = os.path.join(root, "results")
    _zero_counts()
    t0 = time.perf_counter()
    rc = t_test.main(["--task", "refcoco", "--cfg", cfg_path, "--ckpt",
                      ckpt_path, "--split", "val", "--result-path", out_dir,
                      "--result-name", "smoke"])
    res = {"rc": rc, "wall_s": time.perf_counter() - t0,
           "launches": _launch_counts(), "loaded_all": res_loaded,
           "batch": cfg.TEST.BATCH_IMAGES, "slots": cfg.TPU.MAX_BOXES,
           "L": cfg.TPU.MAX_TEXT_LEN + cfg.TPU.MAX_BOXES + 1}
    with open(t_test.result_file(out_dir, "smoke", "refcoco", "val")) as f:
        preds = json.load(f)
    boxes = np.asarray([p["pred_box"] for p in preds], np.float32)
    res["n_rows"] = len(preds)
    res["finite"] = bool(boxes.shape == (len(rows), 4)
                         and np.isfinite(boxes).all())
    res["acc"] = float(np.mean([
        bbox_iou(b[None], np.asarray(r["gt_box"], np.float32))[0] > 0.5
        for b, r in zip(boxes, rows)]))
    res["n"], res["loop_s"], _ = _timed_loop(cfg, "refcoco", ckpt_path,
                                             "val")
    # fp32: kernels vs plain versions on one batch
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model, loader, n_label = t_test.setup_inference(cfg, "refcoco",
                                                    ckpt_path, "val", "cuda")
    try:
        batch = to_device(next(iter(loader))[:-n_label], "cuda")
    finally:
        loader.shutdown()
    with torch.inference_mode():
        _zero_counts()
        a = model(*batch)
        res["fp32_launches"] = _launch_counts()
        with plain_versions():
            b = model(*batch)
    res["fp32_boxes_equal"] = bool(torch.equal(a["pred_boxes"],
                                               b["pred_boxes"]))
    live = batch[2]
    res["fp32_logit_err"] = _maxerr(a["label_logits"][live],
                                    b["label_logits"][live])
    return res


VCR_CFGS = {"Q2A": os.path.join(REPO, "cfgs", "vcr",
                                 "base_q2a_4x16G_fp32.yaml"),
            "QA2R": os.path.join(REPO, "cfgs", "vcr",
                                 "base_qa2r_4x16G_fp32.yaml")}
VCR_OBJECTS = ("person", "dog", "car", "chair", "cup", "bottle", "horse",
               "umbrella", "tie", "bench")
# (width, height) of the synthetic images: four landscape, four portrait
# (a batch of 4 shares one canvas orientation), and the boxes each holds:
# 107 fills the 108 slots with the whole-image box
VCR_IMAGES = (((640, 480), 107), ((800, 600), 40), ((1000, 562), 12),
              ((720, 540), 3), ((480, 640), 60), ((600, 800), 25),
              ((562, 1000), 7), ((540, 720), 90))


def write_vcr_fixture(root, per_image=2, n_train=0):
    """A synthetic VCR split in the dataset's on-disk form under ``root``:
    JPEGs (VCR_IMAGES), one metadata json per image with [x1, y1, x2, y2,
    score] boxes and polygon segms, and ``val.jsonl`` (labels) and
    ``test.jsonl`` (none) with ``per_image`` questions an image: mixed
    questions, 4 answers and 4 rationales whose [obj, ...] references tag
    the image's objects; and ``n_train`` more such questions over the same
    images in ``train.jsonl`` (drawn after the others, which stay as they
    are). Returns (data dir, val rows)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 12)
    d = os.path.join(root, "vcr")
    os.makedirs(os.path.join(d, "img"), exist_ok=True)
    words = FIXTURE_WORDS[:-1]

    def sentence(n_obj, n):
        toks = list(rng.choice(words, n))
        for _ in range(int(rng.integers(1, 3))):
            refs = sorted({int(o) for o in rng.integers(0, n_obj,
                                                        rng.integers(1, 3))})
            toks.insert(int(rng.integers(0, len(toks) + 1)), refs)
        return [t if isinstance(t, list) else str(t) for t in toks] + ["?"]

    def question(i, names, split, n):
        n_obj = len(names)
        return {
            "annot_id": f"{split}-{n}", "img_fn": f"img/{i}.jpg",
            "metadata_fn": f"{i}.json", "objects": names,
            "question": sentence(n_obj, int(rng.integers(4, 12))),
            "answer_choices": [sentence(n_obj, int(rng.integers(3, 14)))
                               for _ in range(4)],
            "rationale_choices": [sentence(n_obj, int(rng.integers(6, 22)))
                                  for _ in range(4)],
            "answer_label": int(rng.integers(0, 4)),
            "rationale_label": int(rng.integers(0, 4))}

    rows, image_names = [], []
    for i, ((w, h), n_obj) in enumerate(VCR_IMAGES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(d, "img", f"{i}.jpg"),
                                  quality=90)
        x1 = rng.uniform(0, w * 0.8, n_obj)
        y1 = rng.uniform(0, h * 0.8, n_obj)
        x2 = np.minimum(x1 + rng.uniform(10, w * 0.5, n_obj), w - 1)
        y2 = np.minimum(y1 + rng.uniform(10, h * 0.5, n_obj), h - 1)
        boxes, segms = [], []
        for b in zip(x1, y1, x2, y2):
            boxes.append([float(v) for v in b] + [float(rng.uniform(.5, 1))])
            polys = []
            for _ in range(int(rng.integers(1, 3))):
                k = int(rng.integers(3, 9))
                polys.append(np.stack([rng.uniform(b[0], b[2], k),
                                       rng.uniform(b[1], b[3], k)],
                                      1).round(1).tolist())
            segms.append(polys)
        names = [str(rng.choice(VCR_OBJECTS)) for _ in range(n_obj)]
        image_names.append(names)
        with open(os.path.join(d, f"{i}.json"), "w") as f:
            json.dump({"boxes": boxes, "segms": segms, "names": names,
                       "width": w, "height": h}, f)
        for j in range(per_image):
            rows.append(question(i, names, "val", len(rows)))
    with open(os.path.join(d, "val.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    with open(os.path.join(d, "test.jsonl"), "w") as f:
        for r in rows:
            r = {k: v for k, v in r.items() if not k.endswith("_label")}
            r["annot_id"] = r["annot_id"].replace("val", "test")
            f.write(json.dumps(r) + "\n")
    train = [question(k % len(VCR_IMAGES), image_names[k % len(VCR_IMAGES)],
                      "train", k) for k in range(n_train)]
    with open(os.path.join(d, "train.jsonl"), "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in train))
    return d, rows


def vcr_configs(root, data_dir, vocab_dir):
    """The shipped base Q2A and QA2R configs on the synthetic split (the
    only changes: its paths, the vocabulary and visual LN scales 1.0, as
    phase 4), written as yamls. Returns {task: yaml path}."""
    import yaml

    paths = {}
    for task, src in VCR_CFGS.items():
        with open(src) as f:
            raw = yaml.safe_load(f)
        raw["DATASET"].update(DATASET_PATH=data_dir, ROOT_PATH=root,
                              VAL_ANNOTATION_FILE="val.jsonl",
                              TEST_ANNOTATION_FILE="test.jsonl")
        raw["NETWORK"].update(BERT_MODEL_NAME=vocab_dir, PARTIAL_PRETRAIN="",
                              IMAGE_PRETRAINED="")
        raw["NETWORK"]["VLBERT"].update(visual_scale_text_init=1.0,
                                        visual_scale_object_init=1.0)
        paths[task] = os.path.join(root, f"vcr_{task.lower()}_smoke.yaml")
        with open(paths[task], "w") as f:
            yaml.safe_dump(raw, f)
    return paths


def _vcr_csv(path):
    import numpy as np

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], \
        np.asarray([[float(x) for x in r[1:]] for r in rows[1:]])


def vcr_phase(root, vocab_dir):
    """Phase 12: VCR inference at full width from the shipped base configs
    on a synthetic split: ``python -m vlbert_tpu_torch.engine.test --task
    vcr`` (its ``main``) for Q2A val and test and the answer-conditioned
    QA2R test, ``merge_vcr_results``, ``python -m
    vlbert_tpu_torch.engine.vcr_val`` and the single-model Q2AR validation
    through ``make_validation_fn``, each with its K1/K2 launches; the warm
    inference loops' samples/s and device idle share; fp32 kernels vs
    plain versions on one batch. Returns results."""
    import numpy as np
    import torch
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.engine import test as t_test
    from vlbert_tpu_torch.engine import vcr_val
    from vlbert_tpu_torch.engine.val import make_validation_fn
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import to_device
    from vlbert_tpu_torch.utils.config import load_config

    data_dir, rows = write_vcr_fixture(root)
    yamls = vcr_configs(root, data_dir, vocab_dir)
    cfg = load_config("vcr", yamls["Q2A"])
    model = build_module(cfg, "vcr", dtype=torch.bfloat16, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(root, "vl-bert_base_a_res101_ref.model")
    torch.save({"state_dict": _reference_layout(model.state_dict())}, ckpt)
    res = {"n_params": n_params, "ckpt_mb": os.path.getsize(ckpt) / 2 ** 20,
           "loaded_all": len(t_test._load_params(model, ckpt))
           == len(model.state_dict()),
           "batch": cfg.TEST.BATCH_IMAGES, "slots": cfg.TPU.MAX_BOXES,
           "L": cfg.TPU.MAX_TEXT_LEN + cfg.TPU.MAX_BOXES + 1,
           "n": len(rows), "runs": {}}
    del model
    torch.cuda.empty_cache()
    out_dir = os.path.join(root, "results")

    def run(name, fn):
        _zero_counts()
        t0 = time.perf_counter()
        out = fn()
        res["runs"][name] = {"launches": _launch_counts(),
                             "wall_s": time.perf_counter() - t0}
        return out

    files = {}
    for task, split in (("Q2A", "val"), ("Q2A", "test"), ("QA2R", "test")):
        rc = run(f"{task}_{split}", lambda: t_test.main([
            "--task", "vcr", "--cfg", yamls[task], "--ckpt", ckpt,
            "--split", split, "--result-path", out_dir,
            "--result-name", "smoke"]))
        files[task, split] = t_test.result_file(out_dir, "smoke", "vcr",
                                                split, task)
        head, ids, probs = _vcr_csv(files[task, split])
        npy = np.load(os.path.splitext(files[task, split])[0] + ".npy")
        blocks = probs.reshape(len(probs), -1, 4)
        res["runs"][f"{task}_{split}"].update(
            rc=rc, columns=len(head) - 1, rows=len(ids),
            ids_ok=ids == [r["annot_id"].replace("val", split)
                           for r in rows],
            probs_ok=bool(np.isfinite(probs).all()
                          and np.allclose(blocks.sum(-1), 1.0, atol=1e-5)
                          and np.allclose(npy, probs, atol=1e-6)),
            head_ok=head[0] == "annot_id" and head[1] == (
                "answer_0" if task == "Q2A"
                else "rationale_conditioned_on_a0_0"))
    merged = os.path.join(out_dir, "smoke_test_merged.csv")
    t_test.merge_vcr_results(files["Q2A", "test"], files["QA2R", "test"],
                             merged)
    head, ids, probs = _vcr_csv(merged)
    res["merged"] = {"columns": len(head) - 1, "rows": len(ids),
                     "ok": probs.shape == (len(rows), 20)
                     and ids == [r["annot_id"].replace("val", "test")
                                 for r in rows]}
    res["vcr_val"] = run("vcr_val", lambda: vcr_val.main([
        "--a-cfg", yamls["Q2A"], "--r-cfg", yamls["QA2R"], "--a-ckpt", ckpt,
        "--r-ckpt", ckpt]))

    # the single-model Q2AR: one visual pass, two text passes a batch
    cfg_ar = load_config("vcr", yamls["Q2A"])
    cfg_ar.DATASET.TASK = "Q2AR"
    model = build_module(cfg_ar, "vcr", dtype=torch.bfloat16, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    t_test._load_params(model, ckpt)
    loader = make_dataloader(cfg_ar, "vcr", "val")
    try:
        res["q2ar"] = run("Q2AR_val", lambda: make_validation_fn(
            model, cfg_ar, "vcr", "cuda")(loader))
    finally:
        loader.shutdown()
    del model
    torch.cuda.empty_cache()

    # warm inference loops: samples/s and the device's idle share
    cfg_r = load_config("vcr", yamls["QA2R"])
    for name, c, split in (("Q2A_val", cfg, "val"),
                           ("QA2R_test", cfg_r, "test")):
        n, loop_s, busy_s = _timed_loop(c, "vcr", ckpt, split, profile=True)
        res["runs"][name].update(samples_per_s=n / loop_s, loop_s=loop_s,
                                 busy_s=busy_s, idle=1 - busy_s / loop_s)

    # fp32: kernels vs plain versions on one Q2A val batch
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model, loader, n_label = t_test.setup_inference(cfg, "vcr", ckpt, "val",
                                                    "cuda")
    try:
        batch = to_device(next(iter(loader))[:-n_label], "cuda")
    finally:
        loader.shutdown()
    with torch.inference_mode():
        _zero_counts()
        a = model(*batch)["label_logits"]
        launches = _launch_counts()
        with plain_versions():
            b = model(*batch)["label_logits"]
    top2 = torch.sort(b, dim=1).values[:, -2:]
    res["fp32"] = {"err": _maxerr(a, b), "finite": bool(torch.isfinite(a)
                                                        .all()),
                   "argmax_equal": bool(torch.equal(a.argmax(1),
                                                    b.argmax(1))),
                   "min_margin": float((top2[:, 1] - top2[:, 0]).min()),
                   "shape": tuple(a.shape), "launches": launches}
    return res


# Phase 13: training from pixels. VCR: 64 training questions over phase
# 12's 8 images, 16 a step (4 images x 4 micro-steps), 2 epochs = 8
# optimizer steps; RefCOCO+: phase 11's 16 expressions, 8 a step (4 x 2),
# 4 epochs = 8 steps
VCR_TRAIN_QUESTIONS = 64
# per micro-step, the K5 sites of each model besides the encoder's 2 a
# layer: the embeddings', FastRCNN's before obj_downsample, and VCR's
# classifier's (RefCOCO+'s CLASSIFIER_DROPOUT is 0, its CNN_REG_DROPOUT
# 0); every one on a tensor that requires grad, so each also runs backward
E2E_K5_OUTSIDE = {"vcr": 3, "refcoco": 2, "pretrain": 2}


def e2e_launches(task, micro_steps=0, val_batches=0, layers=12):
    """Launches of ``micro_steps`` training micro-steps from pixels and
    ``val_batches`` validation batches at full width: per micro-step K1
    and K1b once, K3 and K4 once a layer, K5 at 2 sites a layer and those
    of E2E_K5_OUTSIDE forward and backward (base VCR: 27); per validation
    batch K1 once and K2 once a layer."""
    k5 = (E2E_K5_OUTSIDE[task] + 2 * layers) * micro_steps
    return {"K1": micro_steps + val_batches, "K1b": micro_steps,
            "K2": layers * val_batches, "K3": layers * micro_steps,
            "K4": layers * micro_steps, "K5_fwd": k5, "K5_bwd": k5}


@contextlib.contextmanager
def launches_per_call():
    """Records the launches of each optimizer step and of each validation
    run of train_net: the counts before and after each call of the train
    step and of the validation function (host counters, no sync). Yields
    {"steps": [...], "val": [...], "batch": the first step's batch}."""
    import vlbert_tpu_torch.engine.train as t_train
    import vlbert_tpu_torch.training.loop as loop

    rec = {"steps": [], "val": [], "batch": None}
    saved = loop.make_train_step, t_train.make_validation_fn

    def counted(fn, key):
        def run(*a, **kw):
            if key == "steps" and rec["batch"] is None:
                rec["batch"] = a[0]
            before = _launch_counts()
            out = fn(*a, **kw)
            after = _launch_counts()
            rec[key].append({k: after[k] - before[k] for k in after})
            return out
        return run

    loop.make_train_step = lambda *a, **kw: counted(saved[0](*a, **kw),
                                                    "steps")
    t_train.make_validation_fn = lambda *a, **kw: counted(
        saved[1](*a, **kw), "val")
    try:
        yield rec
    finally:
        loop.make_train_step, t_train.make_validation_fn = saved


@contextlib.contextmanager
def kept_train_net():
    """``python -m vlbert_tpu_torch.engine.train``'s main returns its exit
    code; this keeps what its train_net returned. Yields {"model",
    "history"}."""
    import vlbert_tpu_torch.engine.train as t_train

    kept, saved = {}, t_train.train_net

    def keep(args, config, task):
        kept["model"], kept["history"] = saved(args, config, task)
        return kept["model"], kept["history"]

    t_train.train_net = keep
    try:
        yield kept
    finally:
        t_train.train_net = saved


def write_train_yaml(src, path, overrides):
    """The shipped config ``src`` with ``overrides`` (dotted paths; an
    integer picks an entry of a list, as of a pretraining config's
    DATASET) set, written to ``path``."""
    import yaml

    with open(src) as f:
        raw = yaml.safe_load(f)
    for key, value in overrides.items():
        node = raw
        *parents, leaf = key.split(".")
        for k in parents:
            node = node[int(k)] if isinstance(node, list) \
                else node.setdefault(k, {})
        node[leaf] = value
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def e2e_overrides(root, data_dir, vocab_dir):
    """What phase 13 changes in both shipped configs: its data and
    vocabulary, no warm-start files (none is in the repo: random seed-0
    weights), visual LN scales 1.0 (the configs' 0.0 would zero every
    gradient into the image path at random weights), no warm-up (the
    configs' 1000 and 3750 steps from LR 0 would leave a few steps flat),
    and each epoch's checkpoint written between epochs, not beside the
    timed steps."""
    return {"DATASET.DATASET_PATH": data_dir, "DATASET.ROOT_PATH": root,
            "NETWORK.BERT_MODEL_NAME": vocab_dir,
            "NETWORK.PARTIAL_PRETRAIN": "", "NETWORK.IMAGE_PRETRAINED": "",
            "NETWORK.VLBERT.visual_scale_text_init": 1.0,
            "NETWORK.VLBERT.visual_scale_object_init": 1.0,
            "OUTPUT_PATH": os.path.join(root, "out"), "RNG_SEED": SEED,
            "TRAIN.WARMUP": False, "TPU.ASYNC_CHECKPOINT": False}


def e2e_train_run(task, yaml_path, record_writes=False):
    """``python -m vlbert_tpu_torch.engine.train --task <task> --cfg
    <yaml>`` (its main) with the launches of each step and validation run
    recorded; ``record_writes``: the checkpoint writes recorded, not made.
    Returns results."""
    import torch
    import vlbert_tpu_torch.engine.train as t_train

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    writes = checkpoint_writes_recorded() if record_writes \
        else contextlib.nullcontext()
    t0 = time.perf_counter()
    with launches_per_call() as rec, kept_train_net() as kept, \
            writes as saves:
        rc = t_train.main(["--task", task, "--cfg", yaml_path])
    return {"rc": rc, "wall_s": time.perf_counter() - t0,
            "model": kept["model"], "history": kept["history"],
            "steps": rec["steps"], "val": rec["val"], "batch": rec["batch"],
            "total": _launch_counts(), "saves": saves,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _falls(loss, k):
    """The mean of the last ``k`` losses is below that of the first k."""
    return all(map(math.isfinite, loss)) and len(loss) >= 2 * k \
        and sum(loss[-k:]) < sum(loss[:k])


def vcr_train_phase(root, vocab_dir):
    """Phase 13a: VCR Q2A from pixels at full width from the shipped base
    config (python -m vlbert_tpu_torch.engine.train --task vcr): exact
    launches per step and per validation run, a falling loss, the epochs'
    checkpoints, then AUTO_RESUME finding the last; a profiler window; an
    fp32 step with the kernels and with the plain versions. Returns
    results."""
    import torch
    from vlbert_tpu_torch.utils.config import load_config

    data_dir, rows = write_vcr_fixture(root, n_train=VCR_TRAIN_QUESTIONS)
    overrides = {**e2e_overrides(root, data_dir, vocab_dir),
                 "DATASET.TRAIN_ANNOTATION_FILE": "train.jsonl",
                 "DATASET.VAL_ANNOTATION_FILE": "val.jsonl",
                 "TRAIN.END_EPOCH": 2, "LOG_FREQUENT": 4,
                 # base LR 16 x 6.25e-4 = 0.01 (SGD, momentum 0.9)
                 "TRAIN.LR": 6.25e-4}
    path = write_train_yaml(VCR_CFGS["Q2A"],
                            os.path.join(root, "vcr_train.yaml"), overrides)
    cfg = load_config("vcr", path)
    run = e2e_train_run("vcr", path)
    res = {k: run[k] for k in ("rc", "wall_s", "steps", "val", "total",
                               "peak_gib")}
    hist, model = run["history"], run["model"]
    accum = cfg.TRAIN.GRAD_ACCUMULATE_STEPS
    micro = cfg.TRAIN.BATCH_IMAGES
    n_val = -(-len(rows) // cfg.VAL.BATCH_IMAGES)
    out = os.path.join(cfg.OUTPUT_PATH, "vcr_train")
    prefix = cfg.MODEL_PREFIX
    res.update(
        overrides={k: v for k, v in overrides.items()
                   if not k.startswith(("DATASET.", "NETWORK.BERT"))},
        loss=hist["loss"], val_acc=[v["Acc"] for v in hist["val"]],
        step_ms=hist["step_ms"], accum=accum, micro=micro, n_val=n_val,
        n_params=sum(p.numel() for p in model.parameters()),
        files=sorted(os.listdir(out)),
        want_step=e2e_launches("vcr", accum),
        want_val=e2e_launches("vcr", 0, n_val),
        samples=len(hist["loss"]) * accum * micro)
    res["checks"] = {
        "rc": run["rc"] == 0,
        "steps": len(run["steps"]) == VCR_TRAIN_QUESTIONS // (accum * micro)
        * cfg.TRAIN.END_EPOCH and all(c == res["want_step"]
                                      for c in run["steps"]),
        "val": len(run["val"]) == cfg.TRAIN.END_EPOCH
        and all(c == res["want_val"] for c in run["val"]),
        "loss falls": _falls(hist["loss"], 2),
        "files": {f"{prefix}-0000.model", f"{prefix}-0001.model",
                  f"{prefix}-best.model"} <= set(res["files"])}
    # the device's busy share over a fixed batch (no loader waits)
    batch = run["batch"]
    res["profile"] = profile_steps(model, cfg, "vcr", n=2, batch=batch)
    del model, run, hist
    torch.cuda.empty_cache()
    # AUTO_RESUME (on in the shipped config) finds the last epoch's file
    again = e2e_train_run("vcr", path)
    h2 = again["history"]
    res["resume"] = {"begin_epoch": h2["begin_epoch"],
                     "count": h2["resumed_count"], "steps": len(h2["loss"]),
                     "wall_s": again["wall_s"]}
    res["checks"]["auto resume"] = (again["rc"], h2["begin_epoch"],
                                    h2["resumed_count"], h2["loss"]) == (
        0, cfg.TRAIN.END_EPOCH, len(res["loss"]), [])
    del again, h2
    torch.cuda.empty_cache()
    # fp32: one optimizer step with the kernels and with the plain versions
    cfg.TPU.COMPUTE_DTYPE = "float32"
    res["fp32"] = step_agreement(cfg, "cuda", "vcr", plain_e2e_training,
                                 e2e_launches("vcr", accum), E2E_LEAF_GROUPS,
                                 IMAGE_LEAF_RTOL, batch)
    torch.cuda.empty_cache()
    return res


def refcoco_train_phase(root, vocab_dir):
    """Phase 13b: RefCOCO+ from pixels at full width from the shipped
    config (python -m vlbert_tpu_torch.engine.train --task refcoco) on
    phase 11's expressions: exact launches per step and per validation
    run, a falling loss, RefAcc from validation; the checkpoint writes
    recorded, not made (phase 13a writes and resumes). Returns results."""
    import torch
    from vlbert_tpu_torch.utils.config import load_config

    data_dir, rows = write_refcoco_fixture(root)
    overrides = {**e2e_overrides(root, data_dir, vocab_dir),
                 "DATASET.TRAIN_ANNOTATION_FILE": "ann.jsonl",
                 "DATASET.VAL_ANNOTATION_FILE": "ann.jsonl",
                 # 4 epochs of 2 steps, validated after the last
                 "TRAIN.END_EPOCH": 4, "VAL_FREQUENT": 4, "LOG_FREQUENT": 2,
                 # base LR 8 x 2.5e-5 = 2e-4 (AdamW, triangle to 0 at
                 # the last step)
                 "TRAIN.LR": 2.5e-5}
    path = write_train_yaml(CFG, os.path.join(root, "refcoco_train.yaml"),
                            overrides)
    cfg = load_config("refcoco", path)
    run = e2e_train_run("refcoco", path, record_writes=True)
    hist = run["history"]
    accum = cfg.TRAIN.GRAD_ACCUMULATE_STEPS
    micro = cfg.TRAIN.BATCH_IMAGES
    n_val = -(-len(rows) // cfg.VAL.BATCH_IMAGES)
    res = {k: run[k] for k in ("rc", "wall_s", "steps", "val", "total",
                               "peak_gib", "saves")}
    res.update(
        overrides={k: v for k, v in overrides.items()
                   if not k.startswith(("DATASET.", "NETWORK.BERT"))},
        loss=hist["loss"], ref_acc=[v["RefAcc"] for v in hist["val"]],
        step_ms=hist["step_ms"], accum=accum, micro=micro, n_val=n_val,
        want_step=e2e_launches("refcoco", accum),
        want_val=e2e_launches("refcoco", 0, n_val),
        samples=len(hist["loss"]) * accum * micro)
    res["checks"] = {
        "rc": run["rc"] == 0,
        "steps": len(run["steps"]) == len(rows) // (accum * micro)
        * cfg.TRAIN.END_EPOCH and all(c == res["want_step"]
                                      for c in run["steps"]),
        "val": len(run["val"]) == cfg.TRAIN.END_EPOCH // cfg.VAL_FREQUENT
        and all(c == res["want_val"] for c in run["val"]),
        "loss falls": _falls(hist["loss"], 2),
        "RefAcc": len(res["ref_acc"]) == len(run["val"])
        and all(0.0 <= v <= 1.0 for v in res["ref_acc"])}
    del run, hist
    torch.cuda.empty_cache()
    return res


# Phase 14: pretraining from pixels. 32 captioned JPEGs, 8 caption rows
# and 8 corpus rows a step (no accumulation), 2 epochs = 8 optimizer
# steps; the fp32 check takes one step of the precomputed-feature config
# on 32 + 32 rows
PRETRAIN_CFGS = {"e2e": os.path.join(REPO, "cfgs", "pretrain",
                                     "base_e2e_16x16G_fp16.yaml"),
                 "prec": os.path.join(REPO, "cfgs", "pretrain",
                                      "base_prec_4x16G_fp32.yaml")}
PRETRAIN_IMAGES = 32
# (width, height) of the caption images, landscape and portrait in turn,
# each resized by the configs' 600 / 1000 scales
CC_SIZES = ((640, 480), (480, 640), (800, 600), (600, 800), (1000, 562),
            (562, 1000), (1280, 720), (720, 1280))
# the extents of CC_SIZES after the 600 / 1000 scales (short side 600,
# long side at most 1000): one caption batch's images, K1's
# pretrain_B8_O108 case
PRETRAIN_CANVASES = tuple(
    (round(w * r), round(h * r)) for w, h in CC_SIZES
    for r in [min(600 / min(w, h), 1000 / max(w, h))])
CC_CLASSES = 1601                 # the detector's classes, VLBERT's MVRC's


def write_cc_fixture(root, n=PRETRAIN_IMAGES, feat_dim=2048,
                     corpus_lines=400):
    """A synthetic Conceptual Captions split in the dataset's on-disk form
    under ``root`` (the real data are not in the repo), twice: ``cc/``
    from pixels (JPEGs of CC_SIZES) and ``cc_prec/`` with ``feat_dim``
    features a box instead. Each has ``train_frcnn.json`` (one
    {image, frcnn, caption} row an image) and one frcnn json an image:
    10-100 boxes, CC_CLASSES-way softmax rows and the features as base64
    float32, the image's size. Captions are 5-20 words of FIXTURE_WORDS;
    the text corpus ``corpus.doc`` has ``corpus_lines`` lines of 3-30.
    Returns (pixels dir, precomputed dir, corpus path)."""
    import base64

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 14)
    words = FIXTURE_WORDS[:-1]

    def b64(a):
        return base64.b64encode(np.asarray(a, np.float32).tobytes()).decode()

    dirs = []
    for name, prec in (("cc", False), ("cc_prec", True)):
        d = os.path.join(root, name)
        os.makedirs(os.path.join(d, "frcnn"), exist_ok=True)
        os.makedirs(os.path.join(d, "img"), exist_ok=True)
        rows = []
        for i in range(n):
            w, h = CC_SIZES[i % len(CC_SIZES)]
            if not prec:
                Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                             dtype=np.uint8)).save(
                    os.path.join(d, "img", f"{i}.jpg"), quality=90)
            nb = int(rng.integers(10, 101))
            x1, y1 = rng.uniform(0, w * 0.8, nb), rng.uniform(0, h * 0.8, nb)
            boxes = np.stack([x1, y1,
                              np.minimum(x1 + rng.uniform(16, w / 2, nb),
                                         w - 1),
                              np.minimum(y1 + rng.uniform(16, h / 2, nb),
                                         h - 1)], 1)
            logits = rng.normal(0, 3, (nb, CC_CLASSES))
            scores = np.exp(logits - logits.max(1, keepdims=True))
            frcnn = {"image_w": w, "image_h": h, "num_boxes": nb,
                     "boxes": b64(boxes),
                     "classes": b64(scores / scores.sum(1, keepdims=True))}
            if prec:
                frcnn["features"] = b64(np.abs(rng.normal(
                    0, 1, (nb, feat_dim))))
            with open(os.path.join(d, "frcnn", f"{i}.json"), "w") as f:
                json.dump(frcnn, f)
            rows.append({"image": f"img/{i}.jpg", "frcnn": f"frcnn/{i}.json",
                         "caption": " ".join(rng.choice(
                             words, int(rng.integers(5, 21))))})
        with open(os.path.join(d, "train_frcnn.json"), "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
        dirs.append(d)
    corpus = os.path.join(root, "corpus.doc")
    with open(corpus, "w") as f:
        f.write("\n".join(" ".join(rng.choice(words, int(rng.integers(3, 31))))
                          for _ in range(corpus_lines)) + "\n")
    return dirs[0], dirs[1], corpus


def pretrain_overrides(root, data_dir, corpus, vocab_dir):
    """What phase 14 changes in both shipped pretraining configs: phase
    13's (its data and vocabulary, no warm-start files, visual LN scales
    1.0, no warm-up, each epoch's checkpoint written between epochs) on
    the list-valued DATASET's two entries."""
    return {"DATASET.0.DATASET_PATH": data_dir, "DATASET.0.ROOT_PATH": root,
            "DATASET.1.TRAIN_ANNOTATION_FILE": corpus,
            **{k: v for k, v in e2e_overrides(root, "", vocab_dir).items()
               if not k.startswith("DATASET.")}}


def pretrain_phase(root, vocab_dir):
    """Phase 14: ``python -m vlbert_tpu_torch.engine.train --task
    pretrain`` from the shipped base_e2e config at full width on the
    synthetic captions and corpus: exact launches per step, no
    validation, a falling loss with its three parts logged and the
    MLM / MVRC accuracies, the epochs' checkpoints in the reference
    layout (mirrored to -best.model), AUTO_RESUME finding the last; a
    profiler window; then one fp32 step from pixels of the same config on
    its loader's first batch, and one of the shipped base_prec config,
    each with the kernels and with the plain versions. Returns results."""
    import torch
    from vlbert_tpu_torch.data.build import make_multitask_dataloader
    from vlbert_tpu_torch.training.loop import to_device
    from vlbert_tpu_torch.utils.config import load_config

    cc_dir, prec_dir, corpus = write_cc_fixture(root)
    overrides = {**pretrain_overrides(root, cc_dir, corpus, vocab_dir),
                 "TRAIN.END_EPOCH": 2, "LOG_FREQUENT": 4,
                 # base LR (8 + 8) x 6.25e-6 = 1e-4 (AdamW, triangle to 0
                 # at the last step)
                 "TRAIN.LR": 6.25e-6}
    path = write_train_yaml(PRETRAIN_CFGS["e2e"],
                            os.path.join(root, "pretrain_e2e.yaml"),
                            overrides)
    cfg = load_config("pretrain", path)
    run = e2e_train_run("pretrain", path)
    hist, model = run["history"], run["model"]
    micro = cfg.TRAIN.BATCH_IMAGES
    out = os.path.join(cfg.OUTPUT_PATH, "pretrain_train")
    prefix = cfg.MODEL_PREFIX
    res = {k: run[k] for k in ("rc", "wall_s", "steps", "val", "total",
                               "peak_gib")}
    res.update(
        overrides={k: v for k, v in overrides.items()
                   if not k.startswith(("DATASET.", "NETWORK.BERT"))},
        loss=hist["loss"], train=hist["train"], step_ms=hist["step_ms"],
        micro=micro, n_params=sum(p.numel() for p in model.parameters()),
        files=sorted(os.listdir(out)),
        want_step=e2e_launches("pretrain", 1),
        samples=len(hist["loss"]) * sum(micro))
    last = torch.load(os.path.join(out, f"{prefix}-0001.model"),
                      map_location="cpu", weights_only=True)
    sd = last["state_dict"]
    decoder = "vlbert.mlm_head.predictions.decoder.weight"
    parts = ("MLMLossWVC", "MLMLossAUX", "MVRCLoss", "MLMAcc", "MLMAccAUX",
             "MVRCAcc")
    res["checks"] = {
        "rc": run["rc"] == 0,
        "steps": len(run["steps"]) == PRETRAIN_IMAGES // micro[0]
        * cfg.TRAIN.END_EPOCH and all(c == res["want_step"]
                                      for c in run["steps"]),
        "no validation": run["val"] == [] and hist["val"] == [],
        "loss falls": _falls(hist["loss"], 2),
        "losses and accuracies logged": len(hist["train"])
        == cfg.TRAIN.END_EPOCH and all(
            math.isfinite(ep.get(k, math.nan))
            for ep in hist["train"] for k in parts),
        "files": {f"{prefix}-0000.model", f"{prefix}-0001.model",
                  f"{prefix}-best.model"} <= set(res["files"]),
        "reference layout": set(last) >= {"state_dict", "optimizer",
                                          "step", "extra"}
        and last["step"] == len(hist["loss"]) and decoder in sd
        and sd[decoder].untyped_storage().data_ptr()
        == sd["vlbert.word_embeddings.weight"].untyped_storage().data_ptr()
        and set(sd) - {decoder} == set(dict(model.state_dict()))
        - {decoder}}
    del last, sd
    batch = run["batch"]
    res["profile"] = profile_steps(model, cfg, "pretrain", n=2, batch=batch)
    del model, run, hist, batch
    torch.cuda.empty_cache()
    again = e2e_train_run("pretrain", path)
    h2 = again["history"]
    res["resume"] = {"begin_epoch": h2["begin_epoch"],
                     "count": h2["resumed_count"], "steps": len(h2["loss"]),
                     "wall_s": again["wall_s"]}
    res["checks"]["auto resume"] = (again["rc"], h2["begin_epoch"],
                                    h2["resumed_count"], h2["loss"]) == (
        0, cfg.TRAIN.END_EPOCH, len(res["loss"]), [])
    del again, h2
    torch.cuda.empty_cache()
    heads = {"mlm_head": "vlbert.mlm_head.", "mvrc_head": "vlbert.mvrc_head."}
    # fp32 from pixels: one step of the e2e config on the first batch of
    # its loader, the kernels (K1, K1b among them) vs the plain versions
    cfg.TPU.COMPUTE_DTYPE = "float32"
    loader = make_multitask_dataloader(cfg, "pretrain")
    try:
        batch = to_device(next(iter(loader)), "cuda")
    finally:
        loader.shutdown()
    res["fp32_e2e"] = step_agreement(
        cfg, "cuda", "pretrain", plain_e2e_training,
        e2e_launches("pretrain", 1), {**E2E_LEAF_GROUPS, **heads},
        IMAGE_LEAF_RTOL, batch)
    res["fp32_e2e_rows"] = (int(batch[0].shape[0]), int(batch[8].shape[0]))
    res["fp32_e2e_image"] = tuple(batch[0].shape)
    del batch
    torch.cuda.empty_cache()
    # fp32: one step of the precomputed-feature config, kernels vs plain
    path = write_train_yaml(
        PRETRAIN_CFGS["prec"], os.path.join(root, "pretrain_prec.yaml"),
        {**pretrain_overrides(root, prec_dir, corpus, vocab_dir),
         "TRAIN.END_EPOCH": 1})
    cfg = load_config("pretrain", path)
    loader = make_multitask_dataloader(cfg, "pretrain")
    try:
        batch = to_device(next(iter(loader)), "cuda")
    finally:
        loader.shutdown()
    res["fp32_rows"] = (int(batch[3].shape[0]), int(batch[8].shape[0]))
    res["fp32"] = step_agreement(
        cfg, "cuda", "pretrain", plain_training,
        {**e2e_launches("pretrain", 1), "K1": 0, "K1b": 0},
        {**heads, "encoder": "vlbert.encoder."}, batch=batch)
    del batch
    torch.cuda.empty_cache()
    return res


# Phase 15: VL-BERT-large (24 layers, 1024 wide, 16 heads) through the
# same entry points, from the shipped large configs
LARGE_CFGS = {"vcr": os.path.join(REPO, "cfgs", "vcr",
                                  "large_q2a_4x16G_fp16.yaml"),
              "vcr_b16": os.path.join(REPO, "cfgs", "vcr",
                                      "large_q2a_v5e_bf16.yaml"),
              "vqa": os.path.join(REPO, "cfgs", "vqa", "large_4x16G_fp32.yaml"),
              "refcoco": os.path.join(REPO, "cfgs", "refcoco",
                                      "large_gt_boxes_4x16G.yaml")}
LARGE_LAYERS = 24
# REMAT on against off on one fixed batch: each gradient leaf within this
# much of the leaf's largest |element| (every kernel on the path is
# deterministic, so the two are expected bit for bit)
REMAT_LEAF_RTOL = 1e-5


def remat_launches(launches, layers, micro_steps):
    """The launches of a step with each encoder layer checkpointed: the
    recompute inside backward() runs K3 and the layer's 2 K5 sites again
    (a layer's forward launches nothing else that the path counts)."""
    return dict(launches, K3=launches["K3"] + layers * micro_steps,
                K5_fwd=launches["K5_fwd"] + 2 * layers * micro_steps)


def large_vcr_yaml(root, data_dir, vocab_dir, src):
    """``src`` (a shipped large VCR config) with phase 13's overrides on
    phase 13's fixture: 8 steps over 2 epochs, validated once after the
    last, the checkpoint writes recorded, not made."""
    overrides = {**e2e_overrides(root, data_dir, vocab_dir),
                 "DATASET.TRAIN_ANNOTATION_FILE": "train.jsonl",
                 "DATASET.VAL_ANNOTATION_FILE": "val.jsonl",
                 "TRAIN.END_EPOCH": 2, "VAL_FREQUENT": 2, "LOG_FREQUENT": 4,
                 "TRAIN.LR": 6.25e-4}
    name = os.path.basename(src).replace(".yaml", "_smoke.yaml")
    return write_train_yaml(src, os.path.join(root, name), overrides), \
        overrides


def remat_agreement(cfg, task, batch, n_timed=2):
    """One optimizer step of the config's model on ``batch`` from seed-SEED
    weights with TPU.REMAT off and on (cuDNN and torch held to their
    deterministic algorithms): loss, every gradient leaf (copied to the
    host, so that the first model's do not count in the second's peak),
    launches, the device memory held before the step (weights) and the
    step's peak; then ``n_timed`` more steps each, timed by CUDA events,
    and the device busy time of one more (profiler). Returns results."""
    import gc

    import torch
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import (Optimizer,
                                                 apply_trainable_mask)

    accum = max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    res, grads = {}, {}
    for remat in (False, True):
        model = build_module(cfg, task, dtype=torch.bfloat16, device="cuda",
                             remat=remat)
        init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
        apply_trainable_mask(model, cfg)
        opt = Optimizer(cfg, model, 4)
        kept, opt_step = {}, opt.step

        def step_and_keep(g, opt=opt, kept=kept, opt_step=opt_step):
            if not kept:
                kept.update((n, x.detach().cpu())
                            for n, x in zip(opt.names, g))
            return opt_step(g)

        opt.step = step_and_keep
        step = make_train_step(model, opt, task, cfg, accum)
        saved_modes = (torch.backends.cudnn.deterministic,
                       torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() / 2 ** 30
            _zero_counts()
            loss, _ = step(batch, SEED + 5)
            torch.cuda.synchronize()
            launches = _launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            torch.backends.cudnn.deterministic = saved_modes[0]
            torch.use_deterministic_algorithms(saved_modes[1],
                                               warn_only=saved_modes[2])
        ms = []
        for i in range(n_timed):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            step(batch, SEED + 6 + i)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        busy = sum(device_us_by_name(lambda: step(batch, SEED), 1)
                   .values()) / 1e3
        res[remat] = {"loss": float(loss), "launches": launches,
                      "resident_gib": resident, "peak_gib": peak,
                      "step_ms": ms, "busy_ms": busy}
        grads[remat] = kept
        # opt and its step wrapper refer to each other: drop every name of
        # the cycle and collect it, or the first model's weights and
        # momentum stay on the card through the second's step
        del model, opt, opt_step, step, step_and_keep
        gc.collect()
        torch.cuda.empty_cache()
    off, on = grads[False], grads[True]
    if off.keys() != on.keys() or not off:
        raise AssertionError("REMAT: the two steps updated different "
                             "parameters")
    gap = {k: _maxerr(off[k], on[k]) / max(off[k].abs().max().item(),
                                            1e-30) for k in off}
    worst = max(gap, key=gap.get)
    res["worst_leaf"], res["worst_gap"] = worst, gap[worst]
    res["bit_identical_leaves"] = sum(torch.equal(off[k], on[k])
                                      for k in off)
    res["n_leaves"] = len(off)
    return res


def vcr_large_phase(root, vocab_dir):
    """Phase 15a-c: ``python -m vlbert_tpu_torch.engine.train --task vcr``
    from the shipped large Q2A config (bf16 under TRAIN.FP16, SGD, 4
    micro-steps of 4 images x 4 choices) on phase 13's fixture and
    overrides: exact launches per step and per validation run, a falling
    loss; a profiler window on a fixed batch; that batch's step with
    TPU.REMAT off and on (15b); then the peak memory of one step of the
    shipped v5e config's batch of 16 images (64 encoder rows) with REMAT
    off and on (15c). Returns results."""
    import gc

    import torch
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import (Optimizer,
                                                 apply_trainable_mask)
    from vlbert_tpu_torch.utils.config import load_config

    L = LARGE_LAYERS
    t0 = time.perf_counter()
    data_dir, rows = write_vcr_fixture(root, n_train=VCR_TRAIN_QUESTIONS)
    path, overrides = large_vcr_yaml(root, data_dir, vocab_dir,
                                     LARGE_CFGS["vcr"])
    cfg = load_config("vcr", path)
    run = e2e_train_run("vcr", path, record_writes=True)
    hist, model = run["history"], run["model"]
    accum = cfg.TRAIN.GRAD_ACCUMULATE_STEPS
    micro = cfg.TRAIN.BATCH_IMAGES
    n_val = -(-len(rows) // cfg.VAL.BATCH_IMAGES)
    res = {k: run[k] for k in ("rc", "wall_s", "steps", "val", "total",
                               "peak_gib", "saves")}
    res.update(
        data_dir=data_dir,
        overrides={k: v for k, v in overrides.items()
                   if not k.startswith(("DATASET.", "NETWORK.BERT"))},
        loss=hist["loss"], val_acc=[v["Acc"] for v in hist["val"]],
        step_ms=hist["step_ms"], accum=accum, micro=micro, n_val=n_val,
        n_params=sum(p.numel() for p in model.parameters()),
        want_step=e2e_launches("vcr", accum, layers=L),
        want_val=e2e_launches("vcr", 0, n_val, layers=L),
        samples=len(hist["loss"]) * accum * micro)
    res["checks"] = {
        "rc": run["rc"] == 0,
        "steps": len(run["steps"]) == VCR_TRAIN_QUESTIONS // (accum * micro)
        * cfg.TRAIN.END_EPOCH and all(c == res["want_step"]
                                      for c in run["steps"]),
        "val": len(run["val"]) == 1 and run["val"][0] == res["want_val"],
        "loss falls": _falls(hist["loss"], 2),
        "writes recorded": [e for e, _ in run["saves"]] == [0, 1]}
    batch = run["batch"]
    seconds = {"train": time.perf_counter() - t0}
    t0 = time.perf_counter()
    # a window of one step: two steps a window took 38.9 s of the run on
    # the card (device_by_name takes a window again, up to three times,
    # when a kernel's count in it is not a multiple of the steps)
    res["profile"] = profile_steps(model, cfg, "vcr", n=1, batch=batch)
    del model, run, hist
    torch.cuda.empty_cache()
    seconds["profile"] = time.perf_counter() - t0

    # 15b: REMAT off and on, one step on the fixed batch
    t0 = time.perf_counter()
    r = remat_agreement(cfg, "vcr", batch)
    seconds["remat"] = time.perf_counter() - t0
    res["remat"] = r
    want_on = remat_launches(res["want_step"], L, accum)
    res["remat_want"] = want_on
    res["checks"].update({
        "remat loss equal": r[True]["loss"] == r[False]["loss"],
        "remat leaves": r["worst_gap"] <= REMAT_LEAF_RTOL,
        "remat launches": r[False]["launches"] == res["want_step"]
        and r[True]["launches"] == want_on})
    del batch
    torch.cuda.empty_cache()

    # 15c: one step of the shipped v5e config's batch of 16, REMAT off, on
    # (its one batch read in this process: no worker pool to start)
    t0 = time.perf_counter()
    path16, _ = large_vcr_yaml(root, data_dir, vocab_dir,
                               LARGE_CFGS["vcr_b16"])
    cfg16 = load_config("vcr", path16)
    cfg16.TPU.PROCESS_WORKERS = False
    batch = first_train_batch(cfg16, "vcr", "cuda")
    model = build_module(cfg16, "vcr", dtype=torch.bfloat16, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    apply_trainable_mask(model, cfg16)
    b16 = {"images": int(batch[0].shape[0]),
           "canvas": tuple(batch[0].shape[1:3]),
           "rows": int(batch[5].shape[0] * batch[5].shape[1])}
    for remat in (False, True):
        model.vlbert.encoder.remat = remat
        opt = Optimizer(cfg16, model, 4)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        _zero_counts()
        try:
            t1 = time.perf_counter()
            make_train_step(model, opt, "vcr", cfg16, 1)(batch, SEED)
            torch.cuda.synchronize()
            b16[remat] = {"resident_gib": resident,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30, "s": time.perf_counter() - t1,
                          "launches": _launch_counts()}
        except torch.cuda.OutOfMemoryError as e:
            b16[remat] = {"oom": str(e).splitlines()[0]}
        for p in model.parameters():
            p.grad = None
        del opt
    res["b16"] = b16
    want16 = e2e_launches("vcr", 1, layers=L)
    # REMAT must lower the peak where the encoder's activations set it
    res["checks"]["b16"] = "peak_gib" in b16[True] and \
        b16[True]["launches"] == remat_launches(want16, L, 1) and (
            "oom" in b16[False] or b16[False]["launches"] == want16
            and b16[True]["peak_gib"] < b16[False]["peak_gib"])
    del model, batch
    torch.cuda.empty_cache()
    res["seconds"] = dict(seconds, b16=time.perf_counter() - t0)
    return res


def vqa_large_fp32_phase(root):
    """Phase 15d: one fp32 optimizer step of the shipped
    cfgs/vqa/large_4x16G_fp32.yaml (precomputed features, 4 micro-steps of
    16, L = 128) on phase 7's synthetic set, with the kernels and with the
    plain versions (step_agreement, phase 8's bar). Returns results."""
    from vlbert_tpu_torch.utils.config import load_config

    data_dir, vocab_dir, answer_file = write_vqa_fixture(
        root, n_train=64, n_val=32, seed=SEED)
    cfg = apply_overrides(load_config("vqa", LARGE_CFGS["vqa"]), {
        "NETWORK.PARTIAL_PRETRAIN": "", "NETWORK.BERT_MODEL_NAME": vocab_dir,
        "DATASET.DATASET_PATH": data_dir, "DATASET.ROOT_PATH": data_dir,
        "DATASET.TRAIN_ANNOTATION_FILE": "train.jsonl",
        "DATASET.VAL_ANNOTATION_FILE": "val.jsonl",
        "DATASET.ANSWER_VOCAB_FILE": answer_file,
        "OUTPUT_PATH": os.path.join(root, "out"), "RNG_SEED": SEED,
        "TRAIN.WARMUP": False})
    accum = cfg.TRAIN.GRAD_ACCUMULATE_STEPS
    res = step_agreement(
        cfg, "cuda", "vqa",
        want_launches=train_launches(1, 0, LARGE_LAYERS, accum),
        groups={"encoder": "vlbert.encoder.", "classifier": "final_mlp."})
    res.update(micro=cfg.TRAIN.BATCH_IMAGES, accum=accum,
               L=cfg.TPU.MAX_TEXT_LEN + cfg.TPU.MAX_BOXES + 1)
    return res


def refcoco_large_serve_phase():
    """Phase 15e: RefCOCOServer on cfgs/refcoco/large_gt_boxes_4x16G.yaml
    at full width (bf16, seed-0 weights, visual LN scales 1.0 as phase 4)
    on phase 4's 8 queries: K1 once and K2 24 times each, latency p50 /
    p90. Returns results."""
    import torch
    from vlbert_tpu_torch.data.transforms import build_transforms
    from vlbert_tpu_torch.engine.serve import RefCOCOServer
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.utils.config import load_config

    cfg = load_config("refcoco", LARGE_CFGS["refcoco"])
    cfg.NETWORK.VLBERT.visual_scale_text_init = 1.0
    cfg.NETWORK.VLBERT.visual_scale_object_init = 1.0
    model = build_module(cfg, "refcoco", dtype=torch.bfloat16, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    srv = RefCOCOServer(model, HashTokenizer(), build_transforms(cfg, "test"),
                        max_text=24, max_boxes=16)
    queries = make_queries()
    srv.query(*queries[0])                                   # warm-up
    torch.cuda.synchronize()
    launches = serve_checked(srv, queries, LARGE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    lat = srv.measure_latency(queries * 3, warmup=3)
    res = {"n_params": sum(p.numel() for p in model.parameters()),
           "launches": launches, "lat": lat,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del srv, model
    torch.cuda.empty_cache()
    return res


# VCR-large's attention: 4 questions x 4 choices, L = 64 + 108 + 1, 16
# heads of 64; K5 at its hidden [16, 173, 1024]
LARGE_ATTN = (16, 173, 16)


def large_kernel_parity(dev):
    """K2, K3, K4 at 16 heads (B=16 L=173, VCR-large's shape; 7 padded
    keys, one all-masked batch row) and K5 at [16, 173, 1024], fp32 and
    bf16, against their plain versions with phase 3's and 6's
    tolerances, K3 and K5 in explicit-bits and Philox mode; K3's and K4's
    keep masks at 16 heads (B=16 L=128) read back bit for bit; then each
    timed by kernel name (profiler) beside its library call (SDPA, its
    backward, F.dropout), and its plain version by CUDA events over 5
    calls. Returns (errs, {dtype: {kernel: (kernel (ms, call ms), plain
    call ms, library (ms, kernels))}})."""
    import torch
    import torch.nn.functional as F
    from vlbert_tpu_torch.ops.attention import (
        attention_bits, fused_attention, fused_attention_dropout,
        plain_attention, plain_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import (hw_dropout, keep_mask,
                                              plain_dropout)

    B, L, H = LARGE_ATTN
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    errs, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        qkv, (q, k, v), bias = _train_qkv(g, dev, dtype, B=B, L=L, H=H)
        fixed = bias.detach()
        e2 = _maxerr(fused_attention(q, k, v, fixed),
                     plain_attention(q, k, v, fixed))
        if not e2 <= K2_ATOL[dn]:
            raise AssertionError(f"K2 H={H} {dn}: max abs err {e2}")
        errs[f"K2/{dn}"] = e2
        gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        bits = torch.randint(0, 65536, (B, H, L, L), generator=g, device=dev,
                             dtype=torch.int32)
        x = torch.randn(B, L, H * 64, generator=g, device=dev).to(dtype) \
            .requires_grad_()
        gx = torch.randn(x.shape, generator=g, device=dev).to(dtype)
        bits5 = torch.randint(0, 65536, x.shape, generator=g, device=dev,
                              dtype=torch.int32)
        for mode, kw, kw5 in (("bits", dict(bits=bits), dict(bits=bits5)),
                              ("philox", dict(seed=SEED + 12),
                               dict(seed=SEED + 11))):
            a = fused_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
            ga = torch.autograd.grad(a, (qkv, bias), gy)
            b = plain_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
            gb = torch.autograd.grad(b, (qkv, bias), gy)
            e3 = _maxerr(a, b)
            e4 = max(_rel_err(s, t) for s, t in zip(ga, gb))
            a5 = hw_dropout(x, DROP_RATE, **kw5)
            (d5,) = torch.autograd.grad(a5, x, gx)
            b5 = plain_dropout(x, DROP_RATE, **kw5)
            (p5,) = torch.autograd.grad(b5, x, gx)
            e5 = max(_maxerr(a5, b5), _maxerr(d5, p5))
            if not (e3 <= K3_ATOL[dn] and e4 <= BWD_RTOL[dn]
                    and e5 <= K5_ATOL):
                raise AssertionError(
                    f"H={H} {dn}/{mode}: K3 err {e3}, K4 rel err {e4}, K5 "
                    f"err {e5}")
            errs.update({f"K3/{dn}/{mode}": e3, f"K4/{dn}/{mode}": e4,
                         f"K5/{dn}/{mode}": e5})
        for seed in (SEED + 31, SEED + 32):
            fwd, bwd = _attention_masks(dev, seed, dtype, H=H)
            want = keep_mask(attention_bits(16, H, 128, seed, dev),
                             DROP_RATE, False)
            if not (torch.equal(fwd, want) and torch.equal(bwd, want)):
                raise AssertionError(f"K3/K4 H={H} {dn} seed {seed}: keep "
                                     f"bits differ from the plain Philox's")

        # times: K2 (no grad), K3 (no grad), K4 as the backward of one
        # forward on separate leaves, K5; each beside plain and library
        sdpa = _sdpa_args(q.detach(), k.detach(), v.detach(), fixed)
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        outs = (fused_attention_dropout(*leaves, fixed, DROP_RATE, seed=SEED),
                plain_attention_dropout(*leaves, fixed, DROP_RATE, seed=SEED))
        lib_leaves = [t.transpose(1, 2).detach().contiguous()
                      .requires_grad_() for t in leaves]
        lib_out = F.scaled_dot_product_attention(
            *lib_leaves, attn_mask=sdpa[3], dropout_p=DROP_RATE)
        gl = gy.transpose(1, 2).contiguous()
        xd = x.detach()
        with torch.no_grad():
            t = {"K2": (cuda_ms(lambda: fused_attention(q, k, v, fixed)),
                        event_ms(lambda: plain_attention(q, k, v, fixed)),
                        library_ms(lambda: F.scaled_dot_product_attention(
                            *sdpa[:3], attn_mask=sdpa[3]))),
                 "K3": (cuda_ms(lambda: fused_attention_dropout(
                            q, k, v, fixed, DROP_RATE, seed=SEED)),
                        event_ms(lambda: plain_attention_dropout(
                            q, k, v, fixed, DROP_RATE, seed=SEED)),
                        library_ms(lambda: F.scaled_dot_product_attention(
                            *sdpa[:3], attn_mask=sdpa[3],
                            dropout_p=DROP_RATE))),
                 "K5": (cuda_ms(lambda: hw_dropout(xd, DROP_RATE,
                                                   seed=SEED)),
                        event_ms(lambda: plain_dropout(xd, DROP_RATE,
                                                       seed=SEED)),
                        library_ms(lambda: F.dropout(xd, DROP_RATE,
                                                     training=True)))}
        t["K4"] = (cuda_ms(lambda: torch.autograd.grad(
                       outs[0], leaves, gy, retain_graph=True)),
                   event_ms(lambda: torch.autograd.grad(
                       outs[1], leaves, gy, retain_graph=True)),
                   library_ms(lambda: torch.autograd.grad(
                       lib_out, lib_leaves, gl, retain_graph=True)))
        times[dn] = t
        del outs, lib_out
    return errs, times


# Phase 16: data parallelism (TPU.PARTITION_MODE dp) through ``python -m
# vlbert_tpu_torch.engine.train --dist``, each rank a child process with
# torchrun's environment. The card's machine has one card: NCCL runs at
# one rank (NCCL refuses two ranks on one device), two ranks share the
# card over gloo, which all-reduces and broadcasts CUDA tensors through
# the host.
DIST_TIMEOUT = 300        # seconds a group of rank processes may take
DIST_TRAIN = 128          # phase 16's VQA training questions
DIST_VAL = 32
DIST_VAL_BATCH = 16


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def become_subreaper():
    """Descendants of the rank processes that outlive them (loader
    workers, a forkserver) are reparented to this process, so that
    ``stop_child_processes`` finds and reaps them (Linux's
    PR_SET_CHILD_SUBREAPER)."""
    import ctypes

    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)


def torchrun_env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def run_ranks(jobs, root, name, timeout=DIST_TIMEOUT):
    """One child process per job (``rank_job``; a job's "env" holds
    torchrun's variables, none for a run without a process group), all
    started together; returns each job's result. Kills the group and
    raises on a failure or when it outlives ``timeout``."""
    procs = []
    for i, job in enumerate(jobs):
        path = os.path.join(root, f"{name}_{i}.json")
        job["out"] = os.path.join(root, f"{name}_{i}.result.json")
        with open(path, "w") as f:
            json.dump(job, f)
        log = open(os.path.join(root, f"{name}_{i}.log"), "w")
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        env.update(CUBLAS_WORKSPACE_CONFIG=":4096:8", **job.get("env", {}))
        procs.append((subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
             f"sys.exit(chip_smoke.rank_job({path!r}))"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline, hung = time.monotonic() + timeout, False
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        hung = True
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [i for i, (p, _) in enumerate(procs) if p.returncode != 0]
    if hung or bad:
        tails = []
        for i in bad or range(len(procs)):
            with open(os.path.join(root, f"{name}_{i}.log")) as f:
                tails.append(f"--- {name} process {i}:\n{f.read()[-3000:]}")
        raise AssertionError(f"phase 16 {name}: "
                             + ("the group outlived "
                                f"{timeout} s" if hung else
                                f"processes {bad} failed") + "\n"
                             + "\n".join(tails))
    out = []
    for job in jobs:
        with open(job["out"]) as f:
            out.append(json.load(f))
    return out


def rank_job(job_path):
    """A process of phase 16: ``train`` runs ``python -m
    vlbert_tpu_torch.engine.train``'s main with the job's argv, ``step``
    16c's fp32 step; the result goes to the job's "out" as json. Stops
    its own children before it exits. cuDNN and torch are held to their
    deterministic algorithms unless the job says "deterministic": false
    (16e runs with the entry point's own settings)."""
    import torch

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if job.get("deterministic", True):
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = {"train": rank_train, "step": rank_step,
               "tp_step": rank_tp_step}[job["kind"]](job)
        with open(job["out"], "w") as f:
            json.dump(out, f)
    finally:
        stop_child_processes()
    return 0


def full_params(model):
    """{name: the parameter whole, fp32, on the CPU}; FSDP2's sharded
    parameters gathered over their data group (collective, c10d:
    ``fsdp.plain``); a tensor-parallel rank's split parameters are its
    parts."""
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib

    return {n: fsdp_lib.plain(p).detach().float().cpu()
            for n, p in model.named_parameters()}


def params_digest(model, keep=None):
    """sha256 of every parameter's fp32 bytes (of those whose name
    ``keep`` keeps), in order."""
    import hashlib

    h = hashlib.sha256()
    for n, p in full_params(model).items():
        if keep is None or keep(n):
            h.update(p.numpy().tobytes())
    return h.hexdigest()


def rank_train(job):
    """``python -m vlbert_tpu_torch.engine.train`` (its main) with
    ``job["argv"]``: the losses, the launches of each step and validation
    run, the final parameters' digest, the checkpoint writes asked for
    (made unless ``record_writes``), the gradient all-reduce's time a step
    (host clock between two device syncs), each validation run's summed
    (sum, count) pairs and, under ``profile``, a profiler window of 2
    steps on the first batch. Under tensor parallelism also each step's
    model-group all-reduces (their summed ms, the same clock, and their
    number), the heads K3 launched on, and the digest of the replicated
    parameters (the rank's split ones are its parts). Under
    ``"fault": "head_offset_0"`` every split attention layer draws its
    masks at head offset 0 (16e's planted fault: rank 1 draws rank 0's
    heads' masks)."""
    import torch
    import vlbert_tpu_torch.engine.train as t_train
    import vlbert_tpu_torch.training.loop as loop
    from vlbert_tpu_torch.models.bert import BertSelfAttention
    from vlbert_tpu_torch.ops import attention as tattn
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.parallel import tp as tp_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt

    kept, ar_ms, saves, val_sums = {}, [], [], []
    tp_calls, tp_steps, heads = [], [], set()
    saved = (t_train.train_net, ckpt.save_checkpoint,
             dist_lib.all_reduce_mean_, dist_lib.all_reduce_accumulator,
             tp_lib._all_reduce, tattn._attention_dropout_launch,
             tp_lib.shard_module)

    def shard(model, mesh):
        out = saved[6](model, mesh)
        if job.get("fault") == "head_offset_0":
            for m in model.modules():
                if isinstance(m, BertSelfAttention):
                    m.head_offset = 0
        return out

    def synced_ms(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def timed_all_reduce(tensors, **kw):
        out, ms = synced_ms(saved[2], tensors, **kw)
        ar_ms.append(ms)
        return out

    def timed_tp(t, group):
        out, ms = synced_ms(saved[4], t, group)
        if tp_calls and tp_calls[0] == "in step":
            tp_calls.append(ms)
        return out

    def k3(q, *a):
        heads.add((q.shape[2], *a[-1]))
        return saved[5](q, *a)

    def summed(acc, device, **kw):
        out = saved[3](acc, device, **kw)
        val_sums.append({k: (acc.sums[k], acc.nums[k]) for k in acc.sums})
        return out

    def save(prefix, epoch, *a, **kw):
        saves.append(epoch)
        if job.get("record_writes"):
            return f"{prefix}-{epoch:04d}.model"
        return saved[1](prefix, epoch, *a, **kw)

    def keep(args, config, task):
        model, history = saved[0](args, config, task)
        part = dist_lib.partition_of(model)
        if isinstance(part, tp_lib.TensorParallel):
            kept["replicated_digest"] = params_digest(
                model, lambda n: part.split_dim(n) is None)
        kept.update(history=history, digest=params_digest(model),
                    all_reduce_ms=list(ar_ms), val_sums=list(val_sums),
                    tp_steps=list(tp_steps), k3_heads=sorted(heads),
                    step_launches=list(rec["steps"]),
                    val_launches=list(rec["val"]), total=_launch_counts(),
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if job.get("params_out"):
            torch.save(full_params(model), job["params_out"])
        if job.get("profile") and history["loss"]:
            prof = profile_steps(model, config, task, n=2,
                                 batch=rec["batch"], counts=True)
            kept["profile"], kept["kernels_per_step"] = prof[:3], prof[3]
        return model, history

    def steps_of(make):
        """Each train step's model-group all-reduces, summed."""
        def made(*a, **kw):
            step = make(*a, **kw)

            def run(*b, **k):
                tp_calls[:] = ["in step"]
                try:
                    return step(*b, **k)
                finally:
                    tp_steps.append((sum(tp_calls[1:]), len(tp_calls) - 1))
                    tp_calls.clear()
            return run
        return made

    _zero_counts()
    t0 = time.perf_counter()
    with launches_per_call() as rec:
        loop.make_train_step = steps_of(loop.make_train_step)
        t_train.train_net, ckpt.save_checkpoint = keep, save
        dist_lib.all_reduce_mean_ = timed_all_reduce
        dist_lib.all_reduce_accumulator = summed
        tp_lib._all_reduce, tattn._attention_dropout_launch = timed_tp, k3
        tp_lib.shard_module = shard
        try:
            rc = t_train.main(job["argv"])
        finally:
            (t_train.train_net, ckpt.save_checkpoint,
             dist_lib.all_reduce_mean_, dist_lib.all_reduce_accumulator,
             tp_lib._all_reduce, tattn._attention_dropout_launch,
             tp_lib.shard_module) = saved
    h = kept.pop("history")
    return {"rank": int(os.environ.get("RANK", 0)), "rc": rc,
            "wall_s": time.perf_counter() - t0, "loss": h["loss"],
            "step_ms": h["step_ms"], "val": h["val"],
            "begin_epoch": h["begin_epoch"],
            "resumed_count": h["resumed_count"],
            "state_elements": h["state_elements"], "saves": saves, **kept}


def dist_step_model(cfg, dev):
    """The fp32 model of ``cfg`` from seed-0 weights, dropout off (the
    ranks' dropout seeds fold in their rank: their masks are not one
    process's)."""
    import torch
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.optim import apply_trainable_mask

    model = build_module(cfg, "pretrain", dtype=torch.float32, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    apply_trainable_mask(model, cfg)
    model.image_feature_extractor.obj_downsample[0].rate = 0.0
    return model


def masked_counts(batch):
    """What the pretraining losses divide by: the caption and corpus
    tokens with an MLM label, the regions with an MVRC label."""
    return {"mlm": int((batch[5] != -1).sum()),
            "mlm_aux": int((batch[9] != -1).sum()),
            "mvrc": int(((batch[7].sum(-1) - 1).abs() < 0.1).sum())}


def rank_step(job):
    """16c, one rank: the first batch of its shard of the pretraining
    loader (rank 1's first caption row unmasked, so that the ranks' MLM
    counts differ), one fp32 optimizer step from seed-0 weights under a
    gloo group on cuda:0. Saves the batch (and on rank 0 the updated
    weights) for the one-process step."""
    import torch
    from vlbert_tpu_torch.data.build import make_multitask_dataloader
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.training.loop import make_train_step, to_device
    from vlbert_tpu_torch.training.optim import Optimizer
    from vlbert_tpu_torch.utils.config import load_config

    cfg = load_config("pretrain", job["yaml"])
    with dist_lib.process_group("gloo", "cuda:0") as dev:
        rank, world = dist_lib.rank_world()
        loader = make_multitask_dataloader(cfg, "pretrain")
        try:
            batch = to_device(next(iter(loader)), dev)
        finally:
            loader.shutdown()
        if rank == 1:
            batch[5][0] = -1
        torch.save([None if x is None else x.cpu() for x in batch],
                   job["batch"])
        model = dist_step_model(cfg, dev)
        opt = Optimizer(cfg, model, 4, world)
        step = make_train_step(model, opt, "pretrain", cfg,
                               max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1))
        _zero_counts()
        loss, dm = step(batch, SEED + 5)
        torch.cuda.synchronize()
        out = {"rank": rank, "loss": float(loss),
               "grad_norm": float(dm["grad_total_norm"][0]),
               "launches": _launch_counts(), "counts": masked_counts(batch),
               "rows": [int(batch[3].shape[0]), int(batch[8].shape[0])],
               "digest": params_digest(model)}
        if rank == 0:
            torch.save({n: p.detach().cpu() for n, p
                        in model.named_parameters()}, job["params"])
    return out


def vqa_step_model(cfg, dev):
    """The fp32 VQA model of ``cfg`` from seed-0 weights, its frozen
    parameters marked."""
    import torch
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.optim import apply_trainable_mask

    model = build_module(cfg, "vqa", dtype=torch.float32, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    apply_trainable_mask(model, cfg)
    return model


def rank_tp_step(job):
    """16e's and 16f's fp32 step, one rank of a [d, m] mesh on cuda:0 over
    gloo (tp, or fsdp on the mesh): the first batch of its replica's
    loader, one AdamW step from seed-0 weights. 16e: dropout on at d = 1
    (the ranks draw one process's masks); 16f: "dropout_off" (its
    replicas' seeds fold in their data index), obj_downsample's fixed
    Dropout(0.1) too. The model-index-0 rank of data index i saves its
    batch to ``job["batch"].format(i=i)``; rank 0 the updated parameters,
    gathered whole."""
    import torch
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
    from vlbert_tpu_torch.parallel import tp as tp_lib
    from vlbert_tpu_torch.training.loop import make_train_step, to_device
    from vlbert_tpu_torch.training.optim import Optimizer
    from vlbert_tpu_torch.utils.config import load_config

    cfg = load_config("vqa", job["yaml"])
    with dist_lib.process_group("gloo", "cuda:0") as dev:
        rank, world = dist_lib.rank_world()
        dist_lib.check_partition(cfg, world)
        loader = make_dataloader(cfg, "vqa")
        try:
            batch = to_device(next(iter(loader)), dev)
        finally:
            loader.shutdown()
        model = vqa_step_model(cfg, dev)
        if job.get("dropout_off"):
            model.image_feature_extractor.obj_downsample[0].rate = 0.0
        mesh = tp_lib.make_mesh(cfg, dev)
        if dist_lib.partition_mode(cfg) == "fsdp":
            fsdp_lib.shard_module(model, dev, mesh)
        else:
            tp_lib.shard_module(model, mesh)
        opt = Optimizer(cfg, model, 4, world)
        lr = opt.lr()
        step = make_train_step(model, opt, "vqa", cfg, 1)
        _zero_counts()
        loss, dm = step(batch, SEED + 5)
        torch.cuda.synchronize()
        full = model.partition.full_state(opt.names, opt.params)
        out = {"rank": rank, "loss": float(loss),
               "grad_norm": float(dm["grad_total_norm"][0]),
               "launches": _launch_counts(), "rows": int(batch[1].shape[0]),
               "lr": lr}
        if mesh.model_index == 0:
            torch.save([None if x is None else x.cpu() for x in batch],
                       job["batch"].format(i=mesh.data_index))
        if rank == 0:
            torch.save(dict(zip(opt.names, full)), job["params"])
    return out


def interleave(shards, accum):
    """The global batch of the ranks' ``shards`` of one tensor, in the
    JAX package's layout: micro-step i is the ranks' micro-steps i side by
    side."""
    import torch

    parts = [s.chunk(accum) for s in shards]
    return torch.cat([p[i] for i in range(accum) for p in parts])


def dist_train_yaml(root, data_dir, vocab_dir, answer_file, name, epochs,
                    extra=None):
    """cfgs/vqa/base_v5e_bf16.yaml on phase 16's set with phase 7's
    overrides and ``extra``, ``epochs`` epochs, validation batches of 16,
    the output under ``root/name``."""
    overrides = {
        "NETWORK.PARTIAL_PRETRAIN": "", "NETWORK.BERT_MODEL_NAME": vocab_dir,
        "DATASET.DATASET_PATH": data_dir, "DATASET.ROOT_PATH": data_dir,
        "DATASET.TRAIN_ANNOTATION_FILE": "train.jsonl",
        "DATASET.VAL_ANNOTATION_FILE": "val.jsonl",
        "DATASET.ANSWER_VOCAB_FILE": answer_file,
        "OUTPUT_PATH": os.path.join(root, name), "RNG_SEED": SEED,
        "TRAIN.END_EPOCH": epochs, "LOG_FREQUENT": 4,
        "TRAIN.WARMUP": False, "TRAIN.LR": 6.25e-6,
        "TRAIN.AUTO_RESUME": True, "VAL.BATCH_IMAGES": DIST_VAL_BATCH,
        **(extra or {})}
    path = write_train_yaml(VQA_CFG, os.path.join(root, f"{name}.yaml"),
                            overrides)
    return path, overrides


def dist_phase(root, root14, vocab_dir):
    """Phase 16. (a) NCCL at one rank: phase 7's run, 8 steps of 16 on a
    set of DIST_TRAIN questions, through ``--dist`` and without it, the
    two processes side by side: the same losses and final parameters bit
    for bit, phase 7's launches a step. (b) gloo at two ranks on cuda:0,
    16 a rank: 8 steps over 2 epochs, the loss falls, both ranks' final
    parameters bit for bit, phase 7's launches on each, rank 0 alone
    writes, the validation metric the same on both and equal to one
    process's over the whole split from the same checkpoint; AUTO_RESUME
    to epoch 2 on both. (c) gloo at two ranks, one fp32 step of
    cfgs/pretrain/base_prec_4x16G_fp32.yaml (MLM + MVRC, masked
    normalisers) on phase 14's precomputed-feature fixture, dropout off,
    the ranks' masked counts unequal, against one process's step on the
    concatenated batch at phase 8's bar. (d) beside (a), the same run
    under TPU.PARTITION_MODE fsdp (FSDP2 at one NCCL rank): equal to (a)'s
    dp run bit for bit, or within FSDP_RTOL, with dp's launches; its
    gathered -0000.model laid out as (b)'s dp file; its AUTO_RESUME beside
    (b)'s. (e) TPU.PARTITION_MODE tp at MESH_SHAPE [1, 2] given on the
    command line, two gloo ranks on cuda:0 of 8 rows each: (a)'s run with
    each layer's heads and FFN split over the ranks (rank 1's K3/K4 at
    head offset 6), cuDNN and torch at the entry point's own settings
    (no deterministic algorithms), its losses beside (a)'s, the same run
    with a planted fault (every rank's masks at head offset 0) beyond
    them, its gathered file laid out as (b)'s, its AUTO_RESUME; then an
    fp32 step of the two ranks against one process's at phase 8's bar.
    (f) TPU.PARTITION_MODE fsdp at MESH_SHAPE [2, 2] given on the command
    line, four gloo ranks on cuda:0 of 4 rows each: (e)'s split layers
    sharded by FSDP2 over the two data groups, its losses equal on each
    replica's ranks, the replicated parameters alike on all four, its
    gathered file laid out as (b)'s, its AUTO_RESUME on all four; then an
    fp32 step of the four ranks, dropout off, against one process on the
    two replicas' batches at phase 8's bar. (a), (d), (b), (e) and its
    fault run, and (f) run as one group of processes, and (b)'s, (d)'s,
    (e)'s and (f)'s resumes beside (c)'s ranks and (e)'s and (f)'s fp32
    steps. Returns results."""
    import torch
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.engine.val import make_validation_fn
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.parallel import dist as dist_lib
    from vlbert_tpu_torch.training import checkpoint as ckpt
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import Optimizer
    from vlbert_tpu_torch.utils.config import load_config

    become_subreaper()
    res, seconds = {}, {}
    data_dir, vocab16, answer_file = write_vqa_fixture(
        os.path.join(root, "data"), n_train=DIST_TRAIN, n_val=DIST_VAL,
        seed=SEED)
    fixture = (data_dir, vocab16, answer_file)
    base = ["--task", "vqa", "--cfg"]

    # one group: (a) NCCL at world 1 beside the same run without a
    # process group; (d) the same run with PARTITION_MODE fsdp (FSDP2),
    # its checkpoint written; (b) gloo, two ranks on cuda:0, 2 epochs;
    # (e) tensor parallelism, two gloo ranks on cuda:0
    t0 = time.perf_counter()
    plain_yaml, overrides = dist_train_yaml(root, *fixture, "a_plain", 1)
    nccl_yaml, _ = dist_train_yaml(root, *fixture, "a_nccl", 1)
    fsdp_yaml, _ = dist_train_yaml(root, *fixture, "d_fsdp", 1,
                                   {"TPU.PARTITION_MODE": "fsdp"})
    fsdp_argv = base + [fsdp_yaml, "--dist", "--dist-backend", "nccl"]
    params_out = {k: os.path.join(root, f"{k}_params.pt") for k in "ad"}
    b_yaml, _ = dist_train_yaml(root, *fixture, "b", 2)
    argv = base + [b_yaml, "--dist", "--dist-backend", "gloo", "--device",
                   "cuda:0"]
    # (e) tensor parallelism, [1, 2] on cuda:0 over gloo, 8 a rank: 16a's
    # global batch, batches and LR; the mesh from the command line
    e_yaml, _ = dist_train_yaml(root, *fixture, "e_tp", 1,
                                {"TRAIN.BATCH_IMAGES": 16 // TP_M})
    e_argv = base + [e_yaml, "--dist", "--dist-backend", "gloo", "--device",
                     "cuda:0", *TP_OPTS]
    # (e)'s planted fault: the same run with every rank's masks drawn at
    # head offset 0, which its loss check must see
    f_yaml, _ = dist_train_yaml(root, *fixture, "e_fault", 1,
                                {"TRAIN.BATCH_IMAGES": 16 // TP_M})
    f_argv = base + [f_yaml, "--dist", "--dist-backend", "gloo", "--device",
                     "cuda:0", *TP_OPTS]
    # (f) fsdp on [2, 2], four gloo ranks on cuda:0, 4 a rank: 16a's
    # global batch, batches and LR; the mesh from the command line
    ft_yaml, _ = dist_train_yaml(root, *fixture, "f_fsdp_tp", 1,
                                 {"TRAIN.BATCH_IMAGES": 16 // FT_N})
    ft_argv = base + [ft_yaml, "--dist", "--dist-backend", "gloo",
                      "--device", "cuda:0", *FT_OPTS]
    port, e_port, f_port, ft_port = (free_port() for _ in range(4))
    out = run_ranks(
        [{"kind": "train", "argv": base + [plain_yaml],
          "record_writes": True},
         {"kind": "train", "argv": base + [nccl_yaml, "--dist",
                                           "--dist-backend", "nccl"],
          "record_writes": True, "profile": True,
          "params_out": params_out["a"],
          "env": torchrun_env(0, 1, free_port())},
         {"kind": "train", "argv": fsdp_argv, "profile": True,
          "params_out": params_out["d"],
          "env": torchrun_env(0, 1, free_port())}]
        + [{"kind": "train", "argv": argv, "profile": True,
            "env": torchrun_env(r, 2, port)} for r in range(2)]
        + [{"kind": "train", "argv": e_argv, "profile": True,
            "deterministic": False, "env": torchrun_env(r, TP_M, e_port)}
           for r in range(TP_M)]
        + [{"kind": "train", "argv": f_argv, "record_writes": True,
            "deterministic": False, "fault": "head_offset_0",
            "env": torchrun_env(r, TP_M, f_port)} for r in range(TP_M)]
        + [{"kind": "train", "argv": ft_argv, "profile": True,
            "deterministic": False, "env": torchrun_env(r, FT_N, ft_port)}
           for r in range(FT_N)],
        root, "a_d_b_e_f")
    res["a"], res["d"], res["b"] = out[:2], out[2], out[3:5]
    res["e"] = out[5:5 + TP_M]
    res["e_fault"] = out[5 + TP_M:5 + 2 * TP_M]
    res["f"] = out[5 + 2 * TP_M:]
    seconds["a_d_b_e_f"] = time.perf_counter() - t0
    res["d_gap"] = fsdp_gap(res["a"][1], res["d"], params_out)
    out_b = os.path.join(root, "b", "vqa_train")
    res["b_files"] = sorted(os.listdir(out_b))
    cfg = load_config("vqa", b_yaml)
    b_prefix = cfg.MODEL_PREFIX
    prefix = os.path.join(out_b, b_prefix)
    # one process over the whole validation split from the last checkpoint
    model = build_module(cfg, "vqa", dtype=torch.bfloat16, device="cuda")
    ckpt.load_checkpoint(f"{prefix}-0001.model", model)
    loader = make_dataloader(cfg, "vqa", "val")
    acc_of = []
    saved_acc = dist_lib.all_reduce_accumulator
    dist_lib.all_reduce_accumulator = lambda acc, device, **kw: (
        acc_of.append(acc) or saved_acc(acc, device, **kw))
    try:
        res["b_val_one"] = make_validation_fn(model, cfg, "vqa",
                                              "cuda")(loader)
    finally:
        dist_lib.all_reduce_accumulator = saved_acc
        loader.shutdown()
    res["b_val_one_sums"] = {k: (acc_of[0].sums[k], acc_of[0].nums[k])
                             for k in acc_of[0].sums}
    del model
    torch.cuda.empty_cache()
    # the AUTO_RESUME of (b)'s two ranks, beside it (d)'s under fsdp (its
    # own file, scattered) and (c)'s two ranks: one fp32 pretraining step
    # each, against one process's after the group
    t0 = time.perf_counter()
    prec_dir = os.path.join(root14, "cc_prec")
    corpus = os.path.join(root14, "corpus.doc")
    c_over = {**pretrain_overrides(root14, prec_dir, corpus, vocab_dir),
              "TRAIN.END_EPOCH": 1, "TRAIN.BATCH_IMAGES": [8, 8],
              "TPU.PROCESS_WORKERS": False,
              "NETWORK.VLBERT.hidden_dropout_prob": 0.0,
              "NETWORK.VLBERT.attention_probs_dropout_prob": 0.0}
    c_yaml = write_train_yaml(PRETRAIN_CFGS["prec"],
                              os.path.join(root, "c.yaml"), c_over)
    port, c_port, e_port, e32_port, ft_port, f32_port = (
        free_port() for _ in range(6))
    jobs = [{"kind": "step", "yaml": c_yaml,
             "batch": os.path.join(root, f"c_batch{r}.pt"),
             "params": os.path.join(root, "c_params0.pt"),
             "env": torchrun_env(r, 2, c_port)} for r in range(2)]
    e32_yaml, _ = dist_train_yaml(root, *fixture, "e_fp32", 1,
                                  {"TRAIN.BATCH_IMAGES": 16 // TP_M,
                                   "TPU.PROCESS_WORKERS": False,
                                   **TP_KNOBS})
    e32_jobs = [{"kind": "tp_step", "yaml": e32_yaml,
                 "batch": os.path.join(root, "e32_batch.pt"),
                 "params": os.path.join(root, "e32_params.pt"),
                 "deterministic": False,
                 "env": torchrun_env(r, TP_M, e32_port)}
                for r in range(TP_M)]
    f32_yaml, _ = dist_train_yaml(root, *fixture, "f_fp32", 1, {
        "TRAIN.BATCH_IMAGES": 16 // FT_N, "TPU.PROCESS_WORKERS": False,
        "NETWORK.VLBERT.hidden_dropout_prob": 0.0,
        "NETWORK.VLBERT.attention_probs_dropout_prob": 0.0,
        "NETWORK.CLASSIFIER_DROPOUT": 0.0, **FT_KNOBS})
    f32_jobs = [{"kind": "tp_step", "yaml": f32_yaml, "dropout_off": True,
                 "batch": os.path.join(root, "f32_batch{i}.pt"),
                 "params": os.path.join(root, "f32_params.pt"),
                 "deterministic": False,
                 "env": torchrun_env(r, FT_N, f32_port)}
                for r in range(FT_N)]
    out = run_ranks(
        [{"kind": "train", "argv": argv, "record_writes": True,
          "env": torchrun_env(r, 2, port)} for r in range(2)]
        + [{"kind": "train", "argv": fsdp_argv, "record_writes": True,
            "env": torchrun_env(0, 1, free_port())}] + jobs
        + [{"kind": "train", "argv": e_argv, "record_writes": True,
            "deterministic": False, "env": torchrun_env(r, TP_M, e_port)}
           for r in range(TP_M)]
        + e32_jobs
        + [{"kind": "train", "argv": ft_argv, "record_writes": True,
            "deterministic": False, "env": torchrun_env(r, FT_N, ft_port)}
           for r in range(FT_N)]
        + f32_jobs, root, "b_d_e_f_resume_c_e32_f32")
    res["b_resume"], res["d_resume"], res["c"] = out[:2], out[2], out[3:5]
    res["e_resume"] = out[5:5 + TP_M]
    res["e32"] = out[5 + TP_M:5 + 2 * TP_M]
    res["f_resume"] = out[5 + 2 * TP_M:5 + 2 * TP_M + FT_N]
    res["f32"] = out[5 + 2 * TP_M + FT_N:]
    seconds["b_d_e_f_resume_c_e32_f32"] = time.perf_counter() - t0
    out_e = os.path.join(root, "e_tp", "vqa_train")
    res["e_files"] = sorted(os.listdir(out_e))
    out_f = os.path.join(root, "f_fsdp_tp", "vqa_train")
    res["f_files"] = sorted(os.listdir(out_f))
    out_d = os.path.join(root, "d_fsdp", "vqa_train")
    res["d_files"] = sorted(os.listdir(out_d))
    res["d_file"] = same_layout(f"{prefix}-0001.model",
                                os.path.join(out_d, f"{b_prefix}-0000.model"))
    res["e_file"] = same_layout(f"{prefix}-0001.model",
                                os.path.join(out_e, f"{b_prefix}-0000.model"))
    res["f_file"] = same_layout(f"{prefix}-0001.model",
                                os.path.join(out_f, f"{b_prefix}-0000.model"))

    # (c)'s one process on the concatenated batch
    t0 = time.perf_counter()
    cfg = load_config("pretrain", c_yaml)
    accum = max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    shards = [torch.load(j["batch"]) for j in jobs]
    batch = tuple(None if xs[0] is None
                  else interleave(xs, accum).to("cuda")
                  for xs in zip(*shards))
    cfg.TRAIN.BATCH_IMAGES = [2 * b for b in cfg.TRAIN.BATCH_IMAGES]
    model = dist_step_model(cfg, "cuda")
    opt = Optimizer(cfg, model, 4, 1)
    lr = opt.lr()
    _zero_counts()
    loss, dm = make_train_step(model, opt, "pretrain", cfg, accum)(
        batch, SEED + 5)
    torch.cuda.synchronize()
    ranks_sd = torch.load(jobs[0]["params"])
    dparam = max((p.detach().cpu() - ranks_sd[n]).abs().max().item()
                 for n, p in model.named_parameters())
    r0 = res["c"][0]
    one = {"loss": float(loss), "grad_norm": float(dm["grad_total_norm"][0]),
           "launches": _launch_counts(), "lr": lr,
           "counts": masked_counts(batch)}
    one["checks"] = {
        "loss": (abs(r0["loss"] - one["loss"]) / abs(one["loss"]),
                 STEP_RTOL["loss"]),
        "grad_norm": (abs(r0["grad_norm"] - one["grad_norm"])
                      / one["grad_norm"], STEP_RTOL["grad_norm"]),
        "param_per_lr": (dparam / lr, STEP_RTOL["param_per_lr"])}
    res["c_one"] = one
    del model, opt, ranks_sd, batch, shards
    torch.cuda.empty_cache()
    seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["e32_one"] = tp_fp32_one_process(e32_yaml, e32_jobs[0], res["e32"])
    seconds["e32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["f32_one"] = tp_fp32_one_process(f32_yaml, f32_jobs[0], res["f32"],
                                         FT_D, FT_M)
    seconds["f32"] = time.perf_counter() - t0
    res["seconds"] = seconds
    res["overrides"] = {k: v for k, v in overrides.items()
                        if not k.startswith(("DATASET.", "NETWORK.BERT"))}
    res["c_overrides"] = {k: v for k, v in c_over.items()
                          if not k.startswith(("DATASET.", "NETWORK.BERT"))}

    # the checks
    a_plain, a_nccl = res["a"]
    b0, b1 = res["b"]
    steps_a = DIST_TRAIN // 16
    step_want = train_launches(1, 0)
    val_want = train_launches(0, -(-DIST_VAL // DIST_VAL_BATCH))
    val_b = train_launches(0, -(-DIST_VAL // 2 // DIST_VAL_BATCH))
    res["checks"] = {
        "a: bit for bit": a_plain["loss"] == a_nccl["loss"]
        and a_plain["digest"] == a_nccl["digest"]
        and len(a_nccl["loss"]) == steps_a
        and all(map(math.isfinite, a_nccl["loss"])),
        "a: launches": all(r["step_launches"] == [step_want] * steps_a
                           and r["val_launches"] == [val_want]
                           for r in res["a"]),
        "b: loss falls": _falls(b0["loss"], 2) and len(b0["loss"]) == 8,
        "b: ranks bit for bit": b0["loss"] == b1["loss"]
        and b0["digest"] == b1["digest"],
        "b: launches": all(r["step_launches"] == [step_want] * 8
                           and r["val_launches"] == [val_b] * 2
                           for r in res["b"]),
        "b: rank 0 alone writes": b0["saves"] == [0, 1] and b1["saves"] == []
        and {f"{b_prefix}-0000.model", f"{b_prefix}-0001.model",
             f"{b_prefix}-best.model", "train_rank0.log",
             "train_rank1.log"} == set(res["b_files"]),
        # every question counted once over the ranks, the same metric
        # and sums on both ranks and in one process
        "b: validation": b0["val"] == b1["val"] and len(b0["val"]) == 2
        and b0["val_sums"] == b1["val_sums"]
        and set(b0["val"][-1]) == set(res["b_val_one"])
        and all(abs(b0["val"][-1][k] - v) <= 1e-6
                and b0["val_sums"][-1][k][1] == DIST_VAL
                and res["b_val_one_sums"][k][1] == DIST_VAL
                and abs(b0["val_sums"][-1][k][0]
                        - res["b_val_one_sums"][k][0]) <= 1e-5
                for k, v in res["b_val_one"].items()),
        "b: auto resume": all((r["begin_epoch"], r["resumed_count"],
                               r["loss"], r["saves"]) == (2, 8, [], [])
                              for r in res["b_resume"]),
        "d: fsdp equals dp": res["d_gap"]["max_rel"] <= FSDP_RTOL
        and len(res["d"]["loss"]) == steps_a,
        "d: launches": res["d"]["step_launches"] == [step_want] * steps_a
        and res["d"]["val_launches"] == [val_want],
        "d: one rank holds it all": res["d"]["state_elements"][0]
        == res["d"]["state_elements"][1] > 0,
        "d: the gathered file is dp's": res["d_file"]["same"]
        and res["d_files"] == sorted([f"{b_prefix}-0000.model",
                                      f"{b_prefix}-best.model",
                                      "train_rank0.log"]),
        "d: auto resume": (res["d_resume"]["begin_epoch"],
                           res["d_resume"]["resumed_count"],
                           res["d_resume"]["loss"], res["d_resume"]["saves"])
        == (1, steps_a, [], [])
        and res["d_resume"]["digest"] == res["d"]["digest"],
        "c: counts differ": res["c"][0]["counts"] != res["c"][1]["counts"],
        "c: ranks bit for bit": res["c"][0]["digest"]
        == res["c"][1]["digest"]
        and res["c"][0]["loss"] == res["c"][1]["loss"],
        "c: one process": all(v[0] <= v[1] for v in one["checks"].values()),
        **tp_checks(res, b_prefix, step_want, steps_a),
        **fsdp_tp_checks(res, b_prefix, step_want, steps_a)}
    return res


# 16e: tensor parallelism at [1, TP_M] on cuda:0, the mesh given on the
# command line
TP_M = 2
TP_KNOBS = {"TPU.PARTITION_MODE": "tp", "TPU.MESH_SHAPE": [1, TP_M],
            "TPU.MESH_AXES": ["data", "model"]}
TP_OPTS = ("TPU.PARTITION_MODE", "tp", "TPU.MESH_SHAPE", f"[1,{TP_M}]",
           "TPU.MESH_AXES", "[data,model]")
# 16e's bf16 losses against 16a's, relative, step by step: the same rows,
# LR and dropout masks, but each row-parallel product rounded to bf16 on
# each rank before the fp32 sum, where one process rounds the whole
# product once, through 12 layers and 8 AdamW steps. Set from the card's
# readings (NVIDIA H100 80GB HBM3): the sound runs' largest gap 7.869e-5,
# the same with and without deterministic algorithms; the planted fault
# (rank 1 drawing heads 0..5's masks) 1.870e-4. A mask fault moves a
# loss near 2300 by little: the fp32 step and the head-slice check carry
# the weight, and this bound sits between the two readings
TP_BF16_LOSS_RTOL = 1.2e-4


def tp_fp32_one_process(yaml_path, job, ranks, d=1, m=TP_M):
    """16e's (and 16f's) fp32 step in one process: 16a's config in fp32 on
    the d replicas' batches concatenated (BATCH_IMAGES x d·m, world 1),
    the same seed-0 weights and step seed (16f: dropout off); (rel err,
    rtol) of the loss, the grad norm and the largest parameter gap over
    the LR against the ranks' gathered parameters, phase 8's bar."""
    import torch
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import Optimizer
    from vlbert_tpu_torch.utils.config import load_config

    cfg = load_config("vqa", yaml_path)
    cfg.TRAIN.BATCH_IMAGES *= d * m
    cfg.TPU.PARTITION_MODE, cfg.TPU.MESH_SHAPE = "dp", []
    shards = [torch.load(job["batch"].format(i=i)) for i in range(d)]
    batch = tuple(None if xs[0] is None else torch.cat(xs).to("cuda")
                  for xs in zip(*shards))
    model = vqa_step_model(cfg, "cuda")
    if job.get("dropout_off"):
        model.image_feature_extractor.obj_downsample[0].rate = 0.0
    opt = Optimizer(cfg, model, 4, 1)
    lr = opt.lr()
    _zero_counts()
    loss, dm = make_train_step(model, opt, "vqa", cfg, 1)(batch, SEED + 5)
    torch.cuda.synchronize()
    ranks_sd = torch.load(job["params"])
    dparam = max((p.detach().cpu() - ranks_sd[n]).abs().max().item()
                 for n, p in zip(opt.names, opt.params))
    r0 = ranks[0]
    one = {"loss": float(loss), "grad_norm": float(dm["grad_total_norm"][0]),
           "launches": _launch_counts(), "lr": lr,
           "rows": int(batch[1].shape[0])}
    one["checks"] = {
        "loss": (abs(r0["loss"] - one["loss"]) / abs(one["loss"]),
                 STEP_RTOL["loss"]),
        "grad_norm": (abs(r0["grad_norm"] - one["grad_norm"])
                      / one["grad_norm"], STEP_RTOL["grad_norm"]),
        "param_per_lr": (dparam / lr, STEP_RTOL["param_per_lr"])}
    del model, opt, ranks_sd, batch
    torch.cuda.empty_cache()
    return one


def loss_gap(run, ref):
    """The largest relative gap of ``run``'s losses to ``ref``'s, step by
    step."""
    return max(abs(x - y) / abs(y) for x, y in zip(run["loss"], ref["loss"]))


def tp_checks(res, b_prefix, step_want, steps_a):
    """16e's checks: 8 bf16 steps on both ranks, losses equal on the two
    and beside 16a's within TP_BF16_LOSS_RTOL, the planted fault's
    beyond it, the replicated parameters bit for bit alike, 16a's
    launches a step (K3 and K4 on 6 heads, rank
    1's at head offset 6), one validation run of 32-row batches, rank 0's
    file laid out as 16b's, AUTO_RESUME on both ranks, the fp32 step at
    phase 8's bar."""
    a, e = res["a"][1], res["e"]
    val_e = train_launches(0, -(-DIST_VAL // (DIST_VAL_BATCH * TP_M)))
    half = 12 // TP_M
    return {
        "e: tp trains": all(len(r["loss"]) == steps_a
                            and all(map(math.isfinite, r["loss"]))
                            for r in e)
        and e[0]["loss"] == e[1]["loss"]
        and loss_gap(e[0], a) <= TP_BF16_LOSS_RTOL,
        "e: the loss check sees the planted fault":
        len(res["e_fault"][0]["loss"]) == steps_a
        and loss_gap(res["e_fault"][0], a) > TP_BF16_LOSS_RTOL,
        "e: replicated parameters alike": e[0]["replicated_digest"]
        == e[1]["replicated_digest"],
        "e: launches": all(r["step_launches"] == [step_want] * steps_a
                           and r["val_launches"] == [val_e] for r in e),
        "e: heads": [r["k3_heads"] for r in e]
        == [[[half, j * half, 12]] for j in range(TP_M)],
        "e: the gathered file is dp's": res["e_file"]["same"]
        and res["e_files"] == sorted([f"{b_prefix}-0000.model",
                                      f"{b_prefix}-best.model",
                                      "train_rank0.log", "train_rank1.log"])
        and [r["saves"] for r in e] == [[0]] * TP_M,
        "e: auto resume": all(
            (r["begin_epoch"], r["resumed_count"], r["loss"], r["saves"],
             r["digest"]) == (1, steps_a, [], [], t["digest"])
            for r, t in zip(res["e_resume"], e)),
        "e: fp32 step": all(v[0] <= v[1]
                            for v in res["e32_one"]["checks"].values())
        and all(r["lr"] == res["e32_one"]["lr"] for r in res["e32"])
        and all(r["launches"]["K3"] == r["launches"]["K4"] == 12
                for r in res["e32"])}


# 16f: fsdp on [FT_D, FT_M] on cuda:0, the mesh given on the command
# line: each layer split over the model axis as in 16e, then FSDP2 over
# the data axis
FT_D, FT_M = 2, 2
FT_N = FT_D * FT_M
FT_KNOBS = {"TPU.PARTITION_MODE": "fsdp", "TPU.MESH_SHAPE": [FT_D, FT_M],
            "TPU.MESH_AXES": ["data", "model"]}
FT_OPTS = ("TPU.PARTITION_MODE", "fsdp", "TPU.MESH_SHAPE",
           f"[{FT_D},{FT_M}]", "TPU.MESH_AXES", "[data,model]")


def fsdp_tp_checks(res, b_prefix, step_want, steps_a):
    """16f's checks: 8 bf16 steps on the four ranks, finite, the losses
    equal on each replica's two ranks; the replicated parameters bit for
    bit alike on all four; 16a's launches a step (K3 and K4 on 6 heads,
    model index 1's at head offset 6); one validation run a replica;
    every rank enters the write, rank 0's file laid out as 16b's;
    AUTO_RESUME on all four with the parts as written; a rank holds less
    than 16e's rank; the fp32 step at phase 8's bar."""
    f = res["f"]
    val_f = train_launches(0, -(-DIST_VAL // FT_D // (DIST_VAL_BATCH
                                                        * FT_M)))
    half = 12 // FT_M
    logs = [f"train_rank{r}.log" for r in range(FT_N)]
    return {
        "f: fsdp on [2, 2] trains": all(
            len(r["loss"]) == steps_a and all(map(math.isfinite, r["loss"]))
            for r in f)
        and all(f[i * FT_M]["loss"] == f[i * FT_M + j]["loss"]
                for i in range(FT_D) for j in range(FT_M)),
        "f: replicated parameters alike":
        len({r["replicated_digest"] for r in f}) == 1,
        "f: launches": all(r["step_launches"] == [step_want] * steps_a
                           and r["val_launches"] == [val_f] for r in f),
        "f: heads": [r["k3_heads"] for r in f]
        == [[[half, (r % FT_M) * half, 12]] for r in range(FT_N)],
        "f: the gathered file is dp's": res["f_file"]["same"]
        and res["f_files"] == sorted([f"{b_prefix}-0000.model",
                                      f"{b_prefix}-best.model", *logs])
        and [r["saves"] for r in f] == [[0]] * FT_N,
        "f: auto resume": all(
            (r["begin_epoch"], r["resumed_count"], r["loss"], r["saves"],
             r["digest"]) == (1, steps_a, [], [], t["digest"])
            for r, t in zip(res["f_resume"], f)),
        "f: a rank holds less than a tp rank": all(
            r["state_elements"][0] < res["e"][0]["state_elements"][0]
            and r["state_elements"][1] == res["e"][0]["state_elements"][1]
            for r in f),
        "f: fp32 step": all(v[0] <= v[1]
                            for v in res["f32_one"]["checks"].values())
        and all(r["lr"] == res["f32_one"]["lr"] for r in res["f32"])}


# 16d: fsdp against dp at one rank, where they are not bit for bit
FSDP_RTOL = 1e-6


def fsdp_gap(dp, fsdp, params_out):
    """16d against 16a's NCCL run: equal losses and parameter digests, or
    the largest relative gap (a loss's; a parameter's over its tensor's
    largest element, read from the saved parameters)."""
    import torch

    if dp["loss"] == fsdp["loss"] and dp["digest"] == fsdp["digest"]:
        return {"bit_for_bit": True, "max_rel": 0.0}
    loss = max(abs(a - b) / max(abs(a), 1e-30)
               for a, b in zip(dp["loss"], fsdp["loss"]))
    a, d = (torch.load(params_out[k]) for k in "ad")
    worst = max(((a[n] - d[n]).abs().max().item()
                 / max(a[n].abs().max().item(), 1e-30), n) for n in a)
    return {"bit_for_bit": False, "loss_rel": loss, "param_rel": worst[0],
            "worst_param": worst[1], "max_rel": max(loss, worst[0])}


def same_layout(want_path, got_path):
    """Two checkpoint files' state_dict and moments: the same keys in the
    same order, shapes and dtypes (read memory-mapped)."""
    import torch

    def layout(path):
        p = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
        return {part: [(k, tuple(v.shape), str(v.dtype))
                       for k, v in tree.items()]
                for part, tree in (("state_dict", p["state_dict"]),
                                   ("mu", p["optimizer"]["mu"]),
                                   ("nu", p["optimizer"]["nu"]))}

    want, got = layout(want_path), layout(got_path)
    return {"same": want == got,
            "n": {k: len(v) for k, v in got.items()},
            "diff": [k for k in want if want[k] != got[k]]}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def print_dist_phase(r, card):
    """Phase 16's lines. Step p50 (CUDA events, steps 3..), the profiler
    window's device busy ms a step and the gradient all-reduce's median ms
    a step (host clock between two device syncs) and its share of the step
    p50, per rank: informative (gloo stages through the host; NCCL at one
    rank copies)."""
    def timing(x):
        wall, busy, _ = x["profile"] or (float("nan"),) * 3
        p50, ar = step_p50(x["step_ms"]), _median(x["all_reduce_ms"])
        reduce = (f"gradient all-reduce {ar:.2f} ms a step ({ar / p50:.3f}"
                  f" of the step p50)" if x["all_reduce_ms"] else
                  "no gradient all-reduce (FSDP2 reduce-scatters in the "
                  "backward)")
        return (f"step p50 {p50:.2f} ms, profiled window wall {wall:.2f} / "
                f"device busy {busy:.2f} ms a step, {reduce}, "
                f"peak {x['peak_gib']:.2f} GiB, {x['wall_s']:.1f} s of main")

    plain, nccl = r["a"]
    print(f"[16a dp NCCL world 1] {VQA_CFG} with overrides "
          f"{json.dumps(r['overrides'])} on {DIST_TRAIN} synthetic "
          f"questions: python -m vlbert_tpu_torch.engine.train --dist "
          f"--dist-backend nccl (RANK 0, WORLD_SIZE 1) beside the same run "
          f"without --dist, side by side on the card: {len(nccl['loss'])} "
          f"steps of 16, losses {[round(x, 4) for x in nccl['loss']]} equal "
          f"bit for bit, final parameters' sha256 equal "
          f"({nccl['digest'][:16]}); launches per step "
          f"{nccl['step_launches'][0]} and per validation run "
          f"{nccl['val_launches'][0]} on both; with --dist: {timing(nccl)}; without: step p50 "
          f"{step_p50(plain['step_ms']):.2f} ms ({card})", flush=True)
    b0, b1 = r["b"]
    print(f"[16b dp gloo world 2] the same config, 2 epochs, python -m "
          f"vlbert_tpu_torch.engine.train --dist --dist-backend gloo "
          f"--device cuda:0 on 2 ranks sharing the card, 16 a rank: "
          f"{len(b0['loss'])} steps, loss "
          f"{[round(x, 4) for x in b0['loss']]} on both, final parameters "
          f"equal bit for bit ({b0['digest'][:16]}); launches per step "
          f"{b0['step_launches'][0]} on each rank, per validation run "
          f"{b0['val_launches'][0]}; checkpoint writes asked for rank 0 "
          f"{b0['saves']}, rank 1 {b1['saves']}; files {r['b_files']}; "
          f"val SoftAcc by epoch rank 0 "
          f"{[round(v['SoftAcc'], 6) for v in b0['val']]}, rank 1 "
          f"{[round(v['SoftAcc'], 6) for v in b1['val']]}, one process over "
          f"the {DIST_VAL} questions from -0001.model "
          f"{round(r['b_val_one']['SoftAcc'], 6)} ((sum, count) "
          f"{b0['val_sums'][-1]['SoftAcc']} on the ranks, "
          f"{r['b_val_one_sums']['SoftAcc']} in one process); AUTO_RESUME: "
          f"begin_epoch "
          f"{[x['begin_epoch'] for x in r['b_resume']]}, optimizer count "
          f"{[x['resumed_count'] for x in r['b_resume']]}, "
          f"{[len(x['loss']) for x in r['b_resume']]} steps; rank 0: "
          f"{timing(b0)}; rank 1: {timing(b1)}; phase 16 seconds "
          f"{ {k: round(v, 1) for k, v in r['seconds'].items()} } ({card})",
          flush=True)
    d, ka = r["d"], nccl["kernels_per_step"]
    kd = d["kernels_per_step"]
    changed = {k[:56]: kd.get(k, 0) - ka.get(k, 0)
               for k in sorted(set(ka) | set(kd))
               if kd.get(k, 0) != ka.get(k, 0)}
    held, total = d["state_elements"]
    print(f"[16d resident] TPU.PARTITION_MODE fsdp at 1 NCCL rank: the "
          f"rank holds {held} of the {total} elements of the trained "
          f"parameters and their AdamW moments, {held * 4 / 2 ** 20:.1f} "
          f"MiB in fp32 (dp's rank {nccl['state_elements'][0]}); at N "
          f"ranks each holds its dim-0 chunk, ~1/N ({card})", flush=True)
    gap = r["d_gap"]
    same = ("losses and final parameters' sha256 equal bit for bit"
            if gap["bit_for_bit"] else
            f"not bit for bit: largest relative gap {gap['max_rel']:.3e} "
            f"(loss {gap['loss_rel']:.3e}, parameter {gap['param_rel']:.3e}"
            f" in {gap['worst_param']}) under {FSDP_RTOL}")
    print(f"[16d fsdp NCCL world 1] phase 16a's config with "
          f"TPU.PARTITION_MODE fsdp, python -m vlbert_tpu_torch.engine.train"
          f" --dist --dist-backend nccl (FSDP2: each BertLayer and the root "
          f"a unit), beside 16a's dp run: {len(d['loss'])} steps, losses "
          f"{[round(x, 4) for x in d['loss']]}, {same} "
          f"({d['digest'][:16]}); launches per step {d['step_launches'][0]} "
          f"and per validation run {d['val_launches'][0]}, as dp's; device "
          f"kernels a step (profiler) {sum(kd.values()):.0f} against dp's "
          f"{sum(ka.values()):.0f}, FSDP2's copies and collectives in place "
          f"of dp's all-reduce: {changed}; {timing(d)}; files "
          f"{r['d_files']}, -0000.model against 16b's dp -0001.model: "
          f"same keys, shapes and dtypes {r['d_file']['same']} "
          f"({r['d_file']['n']}); AUTO_RESUME under fsdp: begin_epoch "
          f"{r['d_resume']['begin_epoch']}, optimizer count "
          f"{r['d_resume']['resumed_count']}, "
          f"{len(r['d_resume']['loss'])} steps, parameters as written "
          f"{r['d_resume']['digest'] == d['digest']} ({card})", flush=True)
    print_tp_phase(r, card)
    print_fsdp_tp_phase(r, card)
    c0, c1 = r["c"]
    one = r["c_one"]
    print(f"[16c dp gloo world 2, fp32 step] {PRETRAIN_CFGS['prec']} with "
          f"overrides {json.dumps(r['c_overrides'])} on phase 14's "
          f"precomputed-feature fixture: each rank's first batch "
          f"({c0['rows'][0]} caption + {c0['rows'][1]} corpus rows; masked "
          f"counts rank 0 {c0['counts']}, rank 1 {c1['counts']}), one AdamW "
          f"step from seed-0 weights on 2 ranks vs one process on the "
          f"concatenated batch ({one['counts']}): loss {c0['loss']:.6f} vs "
          f"{one['loss']:.6f}, grad norm {c0['grad_norm']:.6f} vs "
          f"{one['grad_norm']:.6f}, (rel err, rtol) {one['checks']} at lr "
          f"{one['lr']:.3e}; both ranks' parameters equal bit for bit; "
          f"launches a rank {c0['launches']}, one process "
          f"{one['launches']} ({card})", flush=True)


def print_tp_phase(r, card):
    """16e's lines: per rank the step p50, the profiled device busy ms a
    step, the model-group all-reduces a step (their summed ms on the host
    clock between two device syncs, their number, their share of the step
    p50), the replicated gradients' all-reduce (the same clock), the heads
    K3 launched on, the launches, the losses beside 16a's and the planted
    fault's; the file, the resume and the fp32 step."""
    a, e = r["a"][1], r["e"]

    def timing(x):
        wall, busy, _ = x["profile"] or (float("nan"),) * 3
        p50 = step_p50(x["step_ms"])
        ms = _median([t for t, _ in x["tp_steps"][2:]])
        calls = sorted({n for _, n in x["tp_steps"]})
        ar = _median(x["all_reduce_ms"])
        return (f"step p50 {p50:.2f} ms, profiled window wall {wall:.2f} / "
                f"device busy {busy:.2f} ms a step, model-group all-reduces "
                f"{ms:.2f} ms a step ({calls} calls a step; {ms / p50:.3f} "
                f"of the step p50), the replicated gradients' all-reduce "
                f"over the world {ar:.2f} ms a step ({ar / p50:.3f}), K3 "
                f"heads (local, offset, of) "
                f"{x['k3_heads']}, peak {x['peak_gib']:.2f} GiB, "
                f"{x['wall_s']:.1f} s of main")

    print(f"[16e tp gloo world 2] 16a's config with TRAIN.BATCH_IMAGES "
          f"{16 // TP_M} and, on the command line, "
          f"{' '.join(TP_OPTS)}: python -m vlbert_tpu_torch.engine.train "
          f"--dist --dist-backend gloo --device cuda:0 on {TP_M} ranks "
          f"sharing the card, each holding 12 / {TP_M} heads and 3072 / "
          f"{TP_M} FFN columns of every layer, the replica's batch 16 (16a's "
          f"rows): {len(e[0]['loss'])} steps, losses "
          f"{[round(x, 4) for x in e[0]['loss']]} equal on the ranks, 16a's "
          f"{[round(x, 4) for x in a['loss']]}, largest relative gap "
          f"{loss_gap(e[0], a):.3e} (rtol {TP_BF16_LOSS_RTOL}; the planted "
          f"fault, every rank's masks at head offset 0: "
          f"{loss_gap(r['e_fault'][0], a):.3e}, losses "
          f"{[round(x, 4) for x in r['e_fault'][0]['loss']]}); cuDNN and "
          f"torch at the entry point's settings; replicated "
          f"parameters bit for bit alike on the ranks "
          f"{e[0]['replicated_digest'] == e[1]['replicated_digest']}; "
          f"launches per step {e[0]['step_launches'][0]} and per validation "
          f"run {e[0]['val_launches'][0]} on each rank; val SoftAcc "
          f"{[round(v['SoftAcc'], 6) for v in e[0]['val']]} (16a's "
          f"{[round(v['SoftAcc'], 6) for v in a['val']]}); "
          + "; ".join(f"rank {i}: {timing(x)}" for i, x in enumerate(e))
          + f" ({card})", flush=True)
    held, total = e[0]["state_elements"]
    one, e32 = r["e32_one"], r["e32"][0]
    print(f"[16e tp file, resume, fp32 step] rank 0 holds {held} of the "
          f"{total} elements of the trained parameters and their AdamW "
          f"moments; checkpoint writes entered rank 0 {e[0]['saves']}, rank "
          f"1 {e[1]['saves']}; files {r['e_files']}, -0000.model against "
          f"16b's dp -0001.model: same keys, shapes and dtypes "
          f"{r['e_file']['same']} ({r['e_file']['n']}); AUTO_RESUME: "
          f"begin_epoch {[x['begin_epoch'] for x in r['e_resume']]}, "
          f"optimizer count {[x['resumed_count'] for x in r['e_resume']]}, "
          f"{[len(x['loss']) for x in r['e_resume']]} steps, each rank's "
          f"parts as written "
          f"{[x['digest'] == y['digest'] for x, y in zip(r['e_resume'], e)]};"
          f" fp32 step (one AdamW step from seed-0 weights, dropout on, on "
          f"{e32['rows']} rows) of the {TP_M} ranks vs one process on 16a's "
          f"config: loss {e32['loss']:.6f} vs {one['loss']:.6f}, grad norm "
          f"{e32['grad_norm']:.6f} vs {one['grad_norm']:.6f}, (rel err, "
          f"rtol) {one['checks']} at lr {one['lr']:.3e}; launches a rank "
          f"{e32['launches']}, one process {one['launches']} ({card})",
          flush=True)


def print_fsdp_tp_phase(r, card):
    """16f's lines: per rank the step p50, the profiled device busy ms a
    step and the idle share, the model-group all-reduces a step (the
    layers' and the norm's; their summed ms on the host clock between two
    device syncs, their number) and the replicated gradients' chunks'
    all-reduce over the model group, with their share of the step p50
    (FSDP2's gathers and reduce-scatters run inside the forward and
    backward and are not timed apart), the heads K3 launched on, the
    resident elements beside 16e's; the losses, the file, the resume and
    the fp32 step."""
    f = r["f"]

    def timing(x):
        wall, busy, _ = x["profile"] or (float("nan"),) * 3
        p50 = step_p50(x["step_ms"])
        ms = _median([t for t, _ in x["tp_steps"][2:]])
        calls = sorted({n for _, n in x["tp_steps"]})
        ar = _median(x["all_reduce_ms"])
        return (f"step p50 {p50:.2f} ms, profiled window wall {wall:.2f} / "
                f"device busy {busy:.2f} ms a step (idle "
                f"{1 - busy / p50:.3f} of the p50), model-group "
                f"all-reduces {ms:.2f} ms a step ({calls} calls a step), "
                f"the replicated gradients' chunks' all-reduce over the "
                f"model group {ar:.2f} ms a step, together "
                f"{(ms + ar) / p50:.3f} of the step p50; K3 heads (local, "
                f"offset, of) {x['k3_heads']}, holds "
                f"{x['state_elements'][0]} elements, peak "
                f"{x['peak_gib']:.2f} GiB, {x['wall_s']:.1f} s of main")

    held_e, total = r["e"][0]["state_elements"]
    print(f"[16f fsdp on [{FT_D}, {FT_M}] gloo world {FT_N}] 16a's config "
          f"with TRAIN.BATCH_IMAGES {16 // FT_N} and, on the command line, "
          f"{' '.join(FT_OPTS)}: python -m vlbert_tpu_torch.engine.train "
          f"--dist --dist-backend gloo --device cuda:0 on {FT_N} ranks "
          f"sharing the card: each layer split over a model group of "
          f"{FT_M} (12 / {FT_M} heads, 3072 / {FT_M} FFN columns), then "
          f"FSDP2 over a data group of {FT_D}; {FT_D} replicas of "
          f"{16 // FT_D} rows (16a's 16): {len(f[0]['loss'])} steps, losses "
          f"{[round(x, 4) for x in f[0]['loss']]} (equal on each replica's "
          f"{FT_M} ranks: "
          f"{all(f[i * FT_M]['loss'] == f[i * FT_M + j]['loss'] for i in range(FT_D) for j in range(FT_M))}; "
          f"16a's {[round(x, 4) for x in r['a'][1]['loss']]}, other dropout "
          f"masks: the seeds fold in the data index); replicated parameters "
          f"bit for bit alike on the {FT_N} ranks "
          f"{len({x['replicated_digest'] for x in f}) == 1}; launches per "
          f"step {f[0]['step_launches'][0]} and per validation run "
          f"{f[0]['val_launches'][0]} on each rank; val SoftAcc "
          f"{[round(v['SoftAcc'], 6) for v in f[0]['val']]}; resident "
          f"elements of the trained parameters and their AdamW moments a "
          f"rank {[x['state_elements'][0] for x in f]} of {total} (16e's "
          f"tp rank {held_e}); "
          + "; ".join(f"rank {i}: {timing(x)}" for i, x in enumerate(f))
          + f" ({card})", flush=True)
    one, f32 = r["f32_one"], r["f32"][0]
    print(f"[16f file, resume, fp32 step] checkpoint writes entered "
          f"{[x['saves'] for x in f]}; files {r['f_files']}, -0000.model "
          f"against 16b's dp -0001.model: same keys, shapes and dtypes "
          f"{r['f_file']['same']} ({r['f_file']['n']}); AUTO_RESUME: "
          f"begin_epoch {[x['begin_epoch'] for x in r['f_resume']]}, "
          f"optimizer count {[x['resumed_count'] for x in r['f_resume']]}, "
          f"{[len(x['loss']) for x in r['f_resume']]} steps, each rank's "
          f"parts as written "
          f"{[x['digest'] == y['digest'] for x, y in zip(r['f_resume'], f)]}"
          f"; fp32 step (one AdamW step from seed-0 weights, dropout off, "
          f"{f32['rows']} rows a replica) of the {FT_N} ranks vs one process "
          f"on the {one['rows']} rows: loss {f32['loss']:.6f} vs "
          f"{one['loss']:.6f}, grad norm {f32['grad_norm']:.6f} vs "
          f"{one['grad_norm']:.6f}, (rel err, rtol) {one['checks']} at lr "
          f"{one['lr']:.3e}; launches a rank {f32['launches']}, one process "
          f"{one['launches']} ({card})", flush=True)


# Phases 17 and 18: int8 weight-only serving at base width; the
# attention-map dump from pixels and ResNet-18 from pixels

VIS_CFG = os.path.join(REPO, "cfgs", "pretrain",
                       "vis_attention_maps_coco.yaml")
# (width, height) of the synthetic COCO val images, landscape and
# portrait, each resized by the vis config's 600 / 1000 scales
COCO_SIZES = ((640, 480), (480, 640), (640, 427), (500, 375), (427, 640),
              (640, 512), (612, 612), (375, 500))


def resident_built(build):
    """(what ``build()`` returns, the bytes ``torch.cuda.memory_allocated``
    gained over it): what the card holds for it once built."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = build()
    gc.collect()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def int8_gap(ref, got):
    """One query's logits with fp32 and with int8 weights (live slots):
    max |delta|, the reference's std, whether the argmax agrees, the
    reference's top-2 margin and whether a flip is within the 2 delta
    bound (a tie closer than that flips under any perturbation of the
    measured size)."""
    import numpy as np

    delta = float(np.abs(got - ref).max())
    top2 = np.sort(ref)[-2:] if ref.size > 1 else np.zeros(2)
    margin = float(top2[1] - top2[0])
    same = int(got.argmax()) == int(ref.argmax())
    return {"delta": delta, "std": float(ref.std()), "same": same,
            "margin": margin, "ok": same or margin <= 2 * delta}


def dequant_split(srv, batch):
    """Device ms of one query of ``srv`` (an int8 server) and of its
    dequant alone: every quantized layer's ``op_weight`` in the compute
    dtype, the ops a query runs for it, timed apart by kernel name."""
    import torch
    from vlbert_tpu_torch.ops.quant import quantizable_layers

    layers = [m for _, m in quantizable_layers(srv.model) if m.quantized]
    dtype = layers[0].compute_dtype
    query = time_calls(lambda: srv.infer(batch), iters=5, warmup=2)
    with torch.inference_mode():
        deq = time_calls(lambda: [m.op_weight(dtype) for m in layers],
                         iters=5, warmup=2)
    return {"query_ms": query["route_ms"], "dequant_ms": deq["route_ms"],
            "share": deq["route_ms"] / query["route_ms"],
            "dequant_kernels": deq["by_kernel"], "layers": len(layers)}


def latency_in_turns(servers, queries):
    """p50 / p90 of each server of ``servers`` ({name: server}) over
    ``queries`` three times, measured in turns a, b, b, a; each name's
    two runs pooled."""
    import numpy as np

    names = list(servers)
    runs = {k: [] for k in names}
    for k in names + names[::-1]:
        lat = servers[k].measure_latency(queries * 3, warmup=3)
        runs[k].append(lat)
    return {k: {"p50_ms": float(np.median([r["p50_ms"] for r in v])),
                "p90_ms": float(np.median([r["p90_ms"] for r in v])),
                "p50_runs": [r["p50_ms"] for r in v], "n": sum(
                    r["n"] for r in v)} for k, v in runs.items()}


def kernels_vs_plain(srv, batch, n_live):
    """fp32 logits of one batch with the kernels and with their plain
    versions: launches, max abs error, argmax of both, finite."""
    import numpy as np

    _zero_counts()
    a = srv.infer(batch)["label_logits"][0][:n_live]
    launches = _launch_counts()
    with plain_versions():
        b = srv.infer(batch)["label_logits"][0][:n_live]
    return {"launches": launches, "err": float(np.abs(a - b).max()),
            "argmax": (int(a.argmax()), int(b.argmax())),
            "finite": bool(np.isfinite(a).all())}


def refcoco_int8_phase(cfg, model, queries):
    """Phase 17a and 17c (RefCOCO+): ``model``'s weights (phase 4's, bf16)
    behind RefCOCOServer with fp32 and with int8 weights: resident bytes,
    launches, the box and logits of each query, latency in turns, one
    query's device time with its dequant apart; then fp32 compute on int8
    weights, kernels vs plain versions. Returns results."""
    import torch
    from vlbert_tpu_torch.data.transforms import build_transforms
    from vlbert_tpu_torch.engine.serve import RefCOCOServer
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.ops.quant import quantized_bytes

    sd = model.state_dict()
    tf = build_transforms(cfg, "test")

    def server(dtype, quantize):
        m = build_module(cfg, "refcoco", dtype=dtype, device="cuda")
        m.load_state_dict(sd)
        return RefCOCOServer(m, HashTokenizer(), tf, max_text=24,
                             max_boxes=16, quantize=quantize)

    srv, fp32_resident = resident_built(lambda: server(torch.bfloat16,
                                                       None))
    srv8, int8_resident = resident_built(lambda: server(torch.bfloat16,
                                                        "int8"))
    res = {"bytes": quantized_bytes(srv8.model),
           "resident": {"fp32": fp32_resident, "int8": int8_resident}}
    srv8.query(*queries[0])                                  # warm-up
    torch.cuda.synchronize()
    res["launches"] = serve_checked(srv8, queries)
    res["queries"] = []
    for q in queries:
        b = srv.preprocess(*q)
        n = len(q[1])
        # the caller's candidates, after the whole-image box
        ref = srv.infer(b)["label_logits"][0][1:1 + n]
        got = srv8.infer(b)["label_logits"][0][1:1 + n]
        res["queries"].append(int8_gap(ref, got))
    res["lat"] = latency_in_turns({"bf16": srv, "int8": srv8}, queries)
    batch = srv8.preprocess(*queries[3])
    res["profile"] = dequant_split(srv8, batch)
    res["profile_bf16_query_ms"] = time_calls(
        lambda: srv.infer(batch), iters=5, warmup=2)["route_ms"]
    del srv, srv8
    srv32 = server(torch.float32, "int8")
    res["fp32"] = kernels_vs_plain(srv32, batch, int(batch[2][0].sum()))
    del srv32
    torch.cuda.empty_cache()
    return res


def vqa_int8_phase(cfg, best):
    """Phase 17b and 17c (VQA): ``best`` (phase 9's checkpoint) behind
    VQAServer with fp32 and with int8 weights on phase 10's questions:
    resident bytes, launches a query, answers and logits, latency in
    turns, one query's dequant share; then fp32 compute on int8 weights,
    kernels vs plain versions. Returns results."""
    import torch
    from vlbert_tpu_torch.data.tokenization import BertTokenizer
    from vlbert_tpu_torch.engine.serve import VQAServer
    from vlbert_tpu_torch.engine.test import _load_params
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.ops.quant import quantized_bytes

    tok = BertTokenizer.from_pretrained(cfg.NETWORK.BERT_MODEL_NAME)
    with open(cfg.DATASET.ANSWER_VOCAB_FILE) as f:
        answers = [line.strip() for line in f if line.strip()]

    def server(dtype, quantize):
        m = build_module(cfg, "vqa", dtype=dtype, device="cuda")
        _load_params(m, best)
        return VQAServer(m, tok, answers, feat_dim=cfg.DATASET.get(
            "PRECOMPUTED_FEAT_DIM", 2048), quantize=quantize)

    srv, fp32_resident = resident_built(lambda: server(torch.bfloat16,
                                                       None))
    srv8, int8_resident = resident_built(lambda: server(torch.bfloat16,
                                                        "int8"))
    res = {"bytes": quantized_bytes(srv8.model),
           "resident": {"fp32": fp32_resident, "int8": int8_resident}}
    queries = vqa_queries(feat_dim=srv.feat_dim)
    srv8.query(*queries[0])                                  # warm-up
    torch.cuda.synchronize()
    res["per_query"], res["queries"] = [], []
    for q in queries:
        _zero_counts()
        srv8.query(*q)
        res["per_query"].append(_launch_counts())
        b = srv.preprocess(*q)
        res["queries"].append(int8_gap(srv.infer(b)["label_logits"][0],
                                       srv8.infer(b)["label_logits"][0]))
    res["lat"] = latency_in_turns({"bf16": srv, "int8": srv8}, queries)
    batch = srv8.preprocess(*queries[3])
    res["profile"] = dequant_split(srv8, batch)
    del srv, srv8
    srv32 = server(torch.float32, "int8")
    res["fp32"] = kernels_vs_plain(srv32, srv32.preprocess(*queries[3]),
                                   len(answers))
    del srv32
    torch.cuda.empty_cache()
    return res


def int8_accuracy_phase():
    """Phase 17d: tools/int8_accuracy_torch.py's base-scale numbers for
    the VQA and RefCOCO+ heads, on the card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "int8_accuracy_torch",
        os.path.join(REPO, "tools", "int8_accuracy_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return {task: tool.measure(task, B=8, seed=SEED, device="cuda")
            for task in ("vqa", "refcoco")}


def write_coco_fixture(root, n=8):
    """A synthetic COCO captions val split in the dataset's on-disk form
    under ``root`` (the real data are not in the repo): ``val2017/`` with
    ``n`` JPEGs of COCO_SIZES, ``annotations/captions_val2017.json`` (two
    captions of FIXTURE_WORDS an image) and ``instances_val2017.json``
    (5-40 xywh boxes an image over 80 unsorted category ids). Returns the
    data dir."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 18)
    d = os.path.join(root, "coco")
    os.makedirs(os.path.join(d, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(d, "val2017"), exist_ok=True)
    cat_ids = [int(c) for c in rng.permutation(np.arange(1, 91))[:80]]
    images, caps, inst = [], [], []
    for i in range(n):
        w, h = COCO_SIZES[i % len(COCO_SIZES)]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(os.path.join(d, "val2017", f"{i + 1}.jpg"), quality=90)
        images.append({"id": i + 1, "width": w, "height": h,
                       "file_name": f"{i + 1}.jpg"})
        for _ in range(2):
            caps.append({"image_id": i + 1, "caption": " ".join(rng.choice(
                FIXTURE_WORDS[:-1], int(rng.integers(5, 16))))})
        for _ in range(int(rng.integers(5, 41))):
            x, y = rng.uniform(0, w * 0.8), rng.uniform(0, h * 0.8)
            inst.append({"image_id": i + 1,
                         "category_id": cat_ids[int(rng.integers(80))],
                         "bbox": [x, y, rng.uniform(8, w - x),
                                  rng.uniform(8, h - y)]})
    with open(os.path.join(d, "annotations", "captions_val2017.json"),
              "w") as f:
        json.dump({"images": images, "annotations": caps}, f)
    with open(os.path.join(d, "annotations", "instances_val2017.json"),
              "w") as f:
        json.dump({"categories": [{"id": c} for c in sorted(cat_ids)],
                   "images": images, "annotations": inst}, f)
    return d


def vis_phase(root, vocab_dir):
    """Phase 18a: ``python -m vlbert_tpu_torch.engine.vis`` (its main) on
    the shipped vis yaml at full width over a synthetic COCO val split,
    with its loader's workers; again with the plain ROIAlign; a warm
    attention_vis of one image. Returns results."""
    import numpy as np
    import torch
    import vlbert_tpu_torch.engine.vis as vis
    from vlbert_tpu_torch.data.build import make_dataloader
    from vlbert_tpu_torch.data.tokenization import BertTokenizer
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import to_device
    from vlbert_tpu_torch.utils.config import load_config

    data = write_coco_fixture(root)
    overrides = {"DATASET.DATASET_PATH": data, "DATASET.ROOT_PATH": root,
                 "NETWORK.BERT_MODEL_NAME": vocab_dir,
                 "NETWORK.PARTIAL_PRETRAIN": "",
                 "NETWORK.VLBERT.visual_scale_text_init": 1.0,
                 "NETWORK.VLBERT.visual_scale_object_init": 1.0}
    path = write_train_yaml(VIS_CFG, os.path.join(root, "vis.yaml"),
                            overrides)
    res = {"overrides": {k: v for k, v in overrides.items()
                         if not k.startswith("DATASET.")}}
    dirs = [os.path.join(root, "dump"), os.path.join(root, "dump_plain")]
    _zero_counts()
    t0 = time.perf_counter()
    res["n"] = vis.main(["--cfg", path, "--result-path", dirs[0]])
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = _launch_counts()
    with plain_versions():
        n_plain = vis.main(["--cfg", path, "--result-path", dirs[1]])
    res["shapes"], res["row_err"], res["plain_err"] = set(), 0.0, 0.0
    res["names_equal"] = n_plain == res["n"]
    for i in range(res["n"]):
        a, b = (np.load(os.path.join(d, f"{i}_attention_probs.npy"))
                for d in dirs)
        res["shapes"].add(a.shape)
        res["row_err"] = max(res["row_err"],
                             float(np.abs(a.sum(-1) - 1).max()))
        res["plain_err"] = max(res["plain_err"],
                               float(np.abs(a - b).max()))
        names = []
        for d in dirs:
            with open(os.path.join(d, f"{i}_tokens.json")) as f:
                names.append(json.load(f))
        res["names_equal"] &= names[0] == names[1] \
            and len(names[0]) == a.shape[-1]
    res["shapes"] = sorted(res["shapes"])
    # a warm forward of one image, outside main
    cfg = load_config("pretrain", path)
    tok = BertTokenizer.from_pretrained(vocab_dir)
    model = build_module(cfg, "pretrain", dtype=torch.float32,
                         device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(0))
    loader = make_dataloader(cfg, "pretrain", "val", tok, num_replicas=1,
                             rank=0)
    try:
        batch = to_device(next(iter(loader))[:4], "cuda")
    finally:
        loader.shutdown()
    res["image"] = list(batch[0].shape)
    with torch.inference_mode():
        t = time_calls(lambda: model.attention_vis(*batch), iters=5,
                       warmup=2)
    res["warm_ms"], res["warm_busy_ms"] = t["call_ms"], t["route_ms"]
    res["n_params"] = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    return res


def refcoco_r18_phase(queries):
    """Phase 18b: one RefCOCO+ query at IMAGE_NUM_LAYERS 18 (BasicBlock,
    C4 256 wide) behind RefCOCOServer, fp32 kernels vs plain versions;
    and a bf16 query's launches. Returns results."""
    import torch
    from vlbert_tpu_torch.data.transforms import build_transforms
    from vlbert_tpu_torch.engine.serve import RefCOCOServer
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.utils.config import load_config

    cfg = load_config("refcoco", CFG)
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False
    cfg.NETWORK.IMAGE_NUM_LAYERS = 18
    cfg.NETWORK.VLBERT.visual_scale_text_init = 1.0
    cfg.NETWORK.VLBERT.visual_scale_object_init = 1.0
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_module(cfg, "refcoco", dtype=dtype, device="cuda")
        init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
        srv = RefCOCOServer(model, HashTokenizer(),
                            build_transforms(cfg, "test"), max_text=24,
                            max_boxes=16)
        batch = srv.preprocess(*queries[3])
        srv.infer(batch)                                     # warm-up
        if dtype == torch.float32:
            res["n_params"] = sum(p.numel() for p in model.parameters())
            res["c4"] = model.image_feature_extractor.backbone.layer3[-1] \
                .conv2.out_channels
            res["fp32"] = kernels_vs_plain(srv, batch,
                                           int(batch[2][0].sum()))
        else:
            res["bf16_launches"] = serve_checked(srv, queries[:2])
        del srv, model
    torch.cuda.empty_cache()
    return res


def int8_and_vis_phases(cfg, model, queries, cfg9, best, root, vocab13,
                        card):
    """Phases 17 and 18, their checks and lines: int8 serving from phase
    4's ``model`` (on ``cfg``, its ``queries``) and from phase 9's ``best``
    checkpoint (on ``cfg9``), int8_accuracy_torch's numbers, the attention
    dump and ResNet-18 from pixels; files under ``root``, the 30522-word
    vocabulary at ``vocab13``. Returns the results whose launches the
    kernels' record carries."""
    per_query = {"K1": 0, "K1b": 0, "K2": 12, "K3": 0, "K4": 0,
                 "K5_fwd": 0, "K5_bwd": 0}
    # --- 17: int8 weight-only serving at base width ---
    r17a = refcoco_int8_phase(cfg, model, queries)
    r17b = vqa_int8_phase(cfg9, best)
    fp32_one = dict(per_query, K1=1, K2=12)
    checks17 = {
        "refcoco launches": r17a["launches"]
        == {"roi_align": 8, "fused_attention": 96},
        "refcoco boxes": all(g["ok"] for g in r17a["queries"]),
        "vqa launches": all(c == per_query for c in r17b["per_query"]),
        "vqa answers": all(g["ok"] for g in r17b["queries"]),
        "refcoco fp32": r17a["fp32"]["launches"] == fp32_one
        and r17a["fp32"]["finite"] and r17a["fp32"]["err"] <= E2E_ATOL
        and r17a["fp32"]["argmax"][0] == r17a["fp32"]["argmax"][1],
        "vqa fp32": r17b["fp32"]["launches"] == per_query
        and r17b["fp32"]["finite"] and r17b["fp32"]["err"] <= E2E_ATOL
        and r17b["fp32"]["argmax"][0] == r17b["fp32"]["argmax"][1]}
    if not all(checks17.values()):
        raise AssertionError(f"int8 serving: {checks17}; {r17a}; {r17b}")
    for tag, r, what in (("17a serve RefCOCO+ int8", r17a, "box"),
                         ("17b serve VQA int8", r17b, "answer")):
        gaps, b, lat = r["queries"], r["bytes"], r["lat"]
        prof = r["profile"]
        top = sorted(prof["dequant_kernels"].items(),
                     key=lambda kv: -kv[1])[:4]
        print(f"[{tag}] phase {'4' if tag.startswith('17a') else '9'}"
              f"'s weights, bf16 compute, {len(gaps)} queries: the "
              f"same {what} as the fp32-weight server on "
              f"{sum(g['same'] for g in gaps)} of {len(gaps)} (a flip "
              f"only within 2 delta of a top-2 margin: "
              f"{[round(g['margin'], 5) for g in gaps if not g['same']]}"
              f"); max |delta logit| / logit std per query "
              f"{[round(g['delta'] / max(g['std'], 1e-12), 4) for g in gaps]}"
              f" (max |delta| {max(g['delta'] for g in gaps):.3e}); "
              f"launches {r['launches'] if 'launches' in r else r['per_query'][0]}"
              f" (each query's the fp32-weight server's); weight bytes "
              f"(quantized_bytes) int8 {b['quantized_bytes'] / 2**20:.1f}"
              f" MiB vs fp32 {b['fp32_bytes'] / 2**20:.1f} MiB "
              f"({b['quantized_bytes'] / b['fp32_bytes']:.3f}x); resident "
              f"(torch.cuda.memory_allocated) int8 "
              f"{r['resident']['int8'] / 2**20:.1f} MiB vs fp32 "
              f"{r['resident']['fp32'] / 2**20:.1f} MiB; latency in turns "
              f"(bf16, int8, int8, bf16) p50 / p90 ms: fp32 weights "
              f"{lat['bf16']['p50_ms']:.2f} / {lat['bf16']['p90_ms']:.2f}"
              f" {[round(x, 2) for x in lat['bf16']['p50_runs']]}, int8 "
              f"{lat['int8']['p50_ms']:.2f} / {lat['int8']['p90_ms']:.2f}"
              f" {[round(x, 2) for x in lat['int8']['p50_runs']]} (n="
              f"{lat['int8']['n']} each); one query's device busy "
              f"{prof['query_ms']:.3f} ms"
              + (f" (fp32 weights {r['profile_bf16_query_ms']:.3f})"
                 if "profile_bf16_query_ms" in r else "")
              + f", of it the dequant of {prof['layers']} weights "
              f"{prof['dequant_ms']:.3f} ms ({prof['share']:.3f}) by "
              f"kernel {[(k[:56], round(v, 4)) for k, v in top]} "
              f"({card})", flush=True)
    print(f"[17c int8 fp32] fp32 compute on int8 weights, kernels vs "
          f"plain versions on one query: RefCOCO+ launches "
          f"{r17a['fp32']['launches']}, max abs logit err "
          f"{r17a['fp32']['err']:.3e}, argmax {r17a['fp32']['argmax']}; "
          f"VQA launches {r17b['fp32']['launches']}, max abs logit err "
          f"{r17b['fp32']['err']:.3e}, argmax {r17b['fp32']['argmax']} "
          f"(atol {E2E_ATOL}) ({card})", flush=True)
    r17d = int8_accuracy_phase()
    if any(r["argmax_flips_beyond_margin"] for r in r17d.values()):
        raise AssertionError(f"int8 accuracy: a flip beyond the 2 delta "
                             f"bound: {r17d}")
    print(f"[17d int8 accuracy] tools/int8_accuracy_torch.py, base "
          f"scale (768 x 12 x 30522), fp32 compute, seed {SEED}, B=8: "
          + "; ".join(
              f"{t} max |delta| {r['max_abs_logit_delta']:.3e}, mean "
              f"{r['mean_abs_logit_delta']:.3e}, logit std "
              f"{r['logit_std']:.3e}, smallest top-2 margin "
              f"{r['min_top2_margin']:.3e}, argmax flips "
              f"{r['argmax_flips']} ({r['argmax_flips_beyond_margin']} "
              f"beyond 2 delta), bytes {r['quantized_bytes']} vs "
              f"{r['fp32_bytes']}" for t, r in r17d.items())
          + f" ({card})", flush=True)

    # --- 18: the attention-map dump and ResNet-18 from pixels ---
    root18 = os.path.join(root, "p18")
    os.makedirs(root18)
    r18a = vis_phase(root18, vocab13)
    none18 = dict.fromkeys(("K1b", "K2", "K3", "K4", "K5_fwd",
                            "K5_bwd"), 0)
    L18 = r18a["shapes"][0][-1] if r18a["shapes"] else 0
    checks18a = {"dumps": r18a["n"] == 8,
                 "shapes": r18a["shapes"] == [(12, 12, L18, L18)],
                 "rows": r18a["row_err"] <= 1e-5,
                 "launches": r18a["launches"] == dict(none18, K1=8),
                 "plain": r18a["plain_err"] <= 1e-4,
                 "names": r18a["names_equal"]}
    if not all(checks18a.values()):
        raise AssertionError(f"attention dump: {checks18a}; {r18a}")
    print(f"[18a vis] python -m vlbert_tpu_torch.engine.vis --cfg "
          f"{os.path.relpath(VIS_CFG, REPO)} (its main) with overrides "
          f"{json.dumps(r18a['overrides'])}, at full width (ResNet-101 "
          f"C4, dilated conv5, VL-BERT 768 x 12 x 12, "
          f"{r18a['n_params'] / 1e6:.1f}M params, fp32) over a "
          f"synthetic COCO val split of 8 JPEGs: {r18a['n']} dumps of "
          f"{r18a['shapes']}, every row's sum within "
          f"{r18a['row_err']:.2e} of 1, launches {r18a['launches']} (K1 "
          f"once a batch of 1, K2 never: the probs route), the dumps "
          f"with the plain ROIAlign within {r18a['plain_err']:.2e} (atol "
          f"1e-4), sidecars equal; main {r18a['wall_s']:.2f} s "
          f"({r18a['wall_s'] * 1e3 / r18a['n']:.1f} ms an image with "
          f"setup and loader); warm attention_vis of one image "
          f"{r18a['image']} {r18a['warm_ms']:.2f} ms (device busy "
          f"{r18a['warm_busy_ms']:.2f} ms) ({card})", flush=True)
    r18b = refcoco_r18_phase(queries)
    f18 = r18b["fp32"]
    if not (f18["launches"] == fp32_one and f18["finite"]
            and f18["err"] <= E2E_ATOL
            and f18["argmax"][0] == f18["argmax"][1]
            and r18b["c4"] == 256):
        raise AssertionError(f"ResNet-18 RefCOCO+: {r18b}")
    print(f"[18b serve RefCOCO+ ResNet-18] {os.path.relpath(CFG, REPO)}"
          f" at IMAGE_NUM_LAYERS 18 (BasicBlock, C4 {r18b['c4']} wide, "
          f"{r18b['n_params'] / 1e6:.1f}M params), seed-0 weights: fp32 "
          f"kernels (launches {f18['launches']}) vs plain versions on "
          f"one query: max abs logit err {f18['err']:.3e} (atol "
          f"{E2E_ATOL}), argmax {f18['argmax']}; bf16 launches on 2 "
          f"queries {r18b['bf16_launches']} ({card})", flush=True)
    return r17a, r17b, r18a, r18b


# Phase 19: float16 training (TRAIN.FP16 with TPU.FP16_PARITY_MODE, the
# static loss scale), the fp16 routes of K1-K5 and K1b
# 19a: the parity cases of each kernel's fp16 route
K1_FP16_CASES = ("serve", "vcr_B4_O108", "pretrain_B8_O108")
K2_FP16_CASES = ((1, 1), (1, 41), (1, 64), (1, 65), (16, 128), (16, 173))
K34_FP16_CASES = ((4, 41), (16, 128), (16, 173))
# fp16's largest finite value: a padded slot's g in 19a's K1b cases, which
# must not reach dF (1e6, phase 13's, overflows fp16)
FP16_MAX = 65504.0
# the fixed batch of 19b's per-stage maxima and step comparison: each
# ResNet stage and the conv5 head by module, and the encoder's output
STAGES = {"stem": "image_feature_extractor.backbone.maxpool",
          "stage2": "image_feature_extractor.backbone.layer1",
          "stage3": "image_feature_extractor.backbone.layer2",
          "stage4": "image_feature_extractor.backbone.layer3",
          "conv5_head": "image_feature_extractor.roi_head_feature_extractor",
          "encoder": "vlbert.encoder"}
FP16_LOSS_SCALE = 128.0
# fp16's smallest normal value: below it an element keeps fewer bits
FP16_MIN_NORMAL = 2.0 ** -14


def _fp16_qkv(g, dev, B, L, H):
    """q, k, v [B, L, H, 64] fp16 views of one fused projection and a
    [B,1,1,L] fp32 bias with the last 5 keys masked (k2_parity's inputs
    at H heads)."""
    import torch

    qkv = torch.randn(B, L, 3 * H * 64, generator=g, device=dev).half()
    q, k, v = qkv.view(B, L, 3, H, 64).unbind(2)
    m = torch.ones(B, L, device=dev)
    m[:, -5:] = 0
    return q, k, v, ((1.0 - m) * -10000.0)[:, None, None, :].contiguous()


def fp16_kernel_parity(dev):
    """19a: each kernel's fp16 route against its plain version run in fp16
    on the same card. K1 on K1_FP16_CASES (fp16 map, fp16 and fp32 out,
    the cases' sampling ratios); K1b at VCR's and pretraining's shapes
    (fp16 g and dF, the padded slots' g at FP16_MAX), each repeated bit for
    bit; K2 at K2_FP16_CASES and K3 / K4 (explicit bits and Philox) at
    K34_FP16_CASES, at 12 and 16 heads, their keep masks read back bit for
    bit (B=16 L=128), a K4 repeat bit for bit; K5 over K5_CASES, both
    modes, exact, and its Philox mask. Then the times of each fp16 route
    beside its bf16 route and one fp16 library call, at the VCR-large
    step's shapes. Returns (errs, times)."""
    import torch
    from vlbert_tpu_torch.ops import roi_align as troi
    from vlbert_tpu_torch.ops.attention import (
        attention_bits, fused_attention, fused_attention_dropout,
        plain_attention, plain_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import (flat_index_bits, hw_dropout,
                                              keep_mask, plain_dropout)

    f16 = torch.float16
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    errs = {}
    cases = {c[0]: c for c in k1_cases(dev)}
    for name in K1_FP16_CASES:
        _, feat, boxes, mask, ratios = cases[name]
        f = feat.to(f16)
        for out_dtype in (torch.float32, f16):
            for sr in ratios:
                kw = dict(sampling_ratio=sr, out_dtype=out_dtype)
                a = troi.roi_align(f, boxes, mask, **kw)
                b = troi.roi_align_plain(f, boxes, mask, **kw)
                diff = (a.float() - b.float()).abs()
                rtol = K1_FP16_RTOL if out_dtype == f16 else 0.0
                excess = (diff - (rtol * b.float().abs() + K1_ATOL)).max()
                key = f"K1/{name}/float16->{str(out_dtype)[6:]}/sr{sr}"
                if not (a.dtype == out_dtype and excess.item() <= 0
                        and torch.all(a[~mask] == 0)):
                    raise AssertionError(f"{key}: max abs err "
                                         f"{diff.max().item()}, excess "
                                         f"{excess.item()}")
                errs[key] = diff.max().item()
    for case in ("vcr", "pretrain"):
        feat, boxes, mask, _ = k1b_inputs(dev, case)
        B, H, W, C = feat.shape
        gf = torch.randn(B, boxes.shape[1], 14, 14, C, generator=g,
                         device=dev)
        gf[~mask] = FP16_MAX
        gh = gf.to(f16)
        args = (gh, boxes, mask, feat.shape, f16, 14, 14, 1.0 / 16, 1)
        a = troi._roi_align_bwd_cuda(*args)
        again = troi._roi_align_bwd_cuda(*args)
        b = troi.roi_align_bwd_plain(feat.to(f16), boxes, mask, gh,
                                     sampling_ratio=1)
        scale = max(1.0, b.float().abs().max().item())
        diff = (a.float() - b.float()).abs()
        excess = (diff - (K1B_RTOL * scale
                          + K1_FP16_RTOL * b.float().abs())).max().item()
        if not (a.dtype == f16 and excess <= 0 and torch.equal(a, again)
                and torch.isfinite(a).all()):
            raise AssertionError(f"K1b fp16 {case}: max abs err "
                                 f"{diff.max().item()} (largest |dF| "
                                 f"{scale}), excess {excess}, repeat "
                                 f"{bool(torch.equal(a, again))}")
        errs[f"K1b/{case}/float16"] = diff.max().item() / scale
    for H in (12, 16):
        for B, L in K2_FP16_CASES:
            q, k, v, bias = _fp16_qkv(g, dev, B, L, H)
            err = _maxerr(fused_attention(q, k, v, bias),
                          plain_attention(q, k, v, bias))
            if not err <= K2_ATOL["float16"]:
                raise AssertionError(f"K2 fp16 B={B} L={L} H={H}: max abs "
                                     f"err {err}")
            errs[f"K2/B{B}_L{L}_H{H}/float16"] = err
        for B, L in K34_FP16_CASES:
            qkv, (q, k, v), bias = _train_qkv(g, dev, f16, B=B, L=L, H=H)
            gy = torch.randn(q.shape, generator=g, device=dev).to(f16)
            bits = torch.randint(0, 65536, (B, H, L, L), generator=g,
                                 device=dev, dtype=torch.int32)
            for mode, kw in (("bits", dict(bits=bits)),
                             ("philox", dict(seed=SEED + 12))):
                a = fused_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
                ga = torch.autograd.grad(a, (qkv, bias), gy)
                b = plain_attention_dropout(q, k, v, bias, DROP_RATE, **kw)
                gb = torch.autograd.grad(b, (qkv, bias), gy)
                e3 = _maxerr(a, b)
                e4 = max(_rel_err(x, y) for x, y in zip(ga, gb))
                key = f"B{B}_L{L}_H{H}/float16/{mode}"
                if not (e3 <= K3_ATOL["float16"]
                        and e4 <= BWD_RTOL["float16"]):
                    raise AssertionError(f"K3/K4 {key}: out err {e3}, grad "
                                         f"rel err {e4}")
                errs[f"K3/{key}"], errs[f"K4/{key}"] = e3, e4
            if L == 173:
                a = fused_attention_dropout(q, k, v, bias, DROP_RATE,
                                            seed=SEED + 13)
                g1, g2 = (torch.autograd.grad(a, (qkv, bias), gy,
                                              retain_graph=True)
                          for _ in range(2))
                if not all(map(torch.equal, g1, g2)):
                    raise AssertionError(f"K4 fp16 H={H}: a repeat gave "
                                         f"other gradients")
        for seed in (SEED + 31, SEED + 32):
            fwd, bwd = _attention_masks(dev, seed, f16, H=H)
            want = keep_mask(attention_bits(16, H, 128, seed, dev),
                             DROP_RATE, False)
            if not (torch.equal(fwd, want) and torch.equal(bwd, want)):
                raise AssertionError(f"K3/K4 fp16 H={H} seed {seed}: keep "
                                     f"bits differ from the plain Philox's")
    for shape, skip in K5_CASES:
        n = math.prod(shape)

        def view(t):
            return t.to(f16)[skip:].view(shape)

        x = view(torch.randn(n + skip, generator=g, device=dev)) \
            .requires_grad_()
        gy = view(torch.randn(n + skip, generator=g, device=dev))
        bits = torch.randint(0, 65536, (n + skip,), generator=g, device=dev,
                             dtype=torch.int32)[skip:].view(shape)
        for mode, kw in (("bits", dict(bits=bits)),
                         ("philox", dict(seed=SEED + 11))):
            a = hw_dropout(x, DROP_RATE, **kw)
            (da,) = torch.autograd.grad(a, x, gy)
            b = plain_dropout(x, DROP_RATE, **kw)
            (db,) = torch.autograd.grad(b, x, gy)
            err = max(_maxerr(a, b), _maxerr(da, db))
            key = f"K5/{'x'.join(map(str, shape))}+{skip}/float16/{mode}"
            if not err <= K5_ATOL:
                raise AssertionError(f"{key}: max abs err {err}")
            errs[key] = err
    B, L, H = LARGE_ATTN
    ones = torch.ones(B, L, H * 64, device=dev, dtype=f16)
    keep = hw_dropout(ones, DROP_RATE, seed=SEED + 21) != 0
    if not torch.equal(keep, keep_mask(flat_index_bits(ones.shape,
                                                       SEED + 21, dev),
                                       DROP_RATE, False)):
        raise AssertionError("K5 fp16: the kernel's mask is not the plain "
                             "Philox mask")
    return errs, fp16_times(dev)


def fp16_times(dev):
    """Each fp16 route beside its bf16 route in this run and one fp16
    library call, at the VCR-large step's shapes: K2, K3, K4 at B=16
    L=173 H=16, K5 at [16, 173, 1024], K1 and K1b at VCR's training shape
    (the vcr_B4_O108 case, 16-bit map, output and g); the plain version in
    fp16. Returns {kernel: {"float16": (ms, call ms), "bfloat16": (ms,
    call ms), "plain_ms": ms, "library": (ms, kernel names)}}."""
    import torch
    import torch.nn.functional as F
    from vlbert_tpu_torch.ops import roi_align as troi
    from vlbert_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_dropout,
                                                plain_attention,
                                                plain_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import hw_dropout, plain_dropout

    B, L, H = LARGE_ATTN
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    out = {k: {} for k in ("K1", "K1b", "K2", "K3", "K4", "K5")}
    for dtype in (torch.bfloat16, torch.float16):
        dn = str(dtype)[6:]
        _, (q, k, v), bias = _train_qkv(g, dev, dtype, B=B, L=L, H=H)
        q, k, v, bias = (t.detach() for t in (q, k, v, bias))
        leaves = [t.contiguous().requires_grad_() for t in (q, k, v)]
        gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        o = fused_attention_dropout(*leaves, bias, DROP_RATE, seed=SEED)
        x = torch.randn(B, L, H * 64, generator=g, device=dev).to(dtype)
        feat, boxes, mask, gb = k1b_inputs(dev, "vcr")
        feat, gb = feat.to(dtype), gb.to(dtype)
        k1b = (gb, boxes, mask, feat.shape, dtype, 14, 14, 1.0 / 16, 1)
        with torch.no_grad():
            out["K2"][dn] = cuda_ms(lambda: fused_attention(q, k, v, bias))
            out["K3"][dn] = cuda_ms(lambda: fused_attention_dropout(
                q, k, v, bias, DROP_RATE, seed=SEED))
            out["K5"][dn] = cuda_ms(lambda: hw_dropout(x, DROP_RATE,
                                                       seed=SEED))
            t1 = time_calls(lambda: troi.roi_align(
                feat, boxes, mask, sampling_ratio=1, out_dtype=dtype),
                K1_KERNEL)
            t1b = time_calls(lambda: troi._roi_align_bwd_cuda(*k1b),
                             K1B_KERNEL)
        out["K1"][dn] = (t1["ms"], t1["call_ms"])
        out["K1b"][dn] = (t1b["ms"], t1b["call_ms"])
        out["K4"][dn] = cuda_ms(lambda: torch.autograd.grad(
            o, leaves, gy, retain_graph=True))
    # plain versions in fp16 (the last loop's tensors), CUDA events
    po = plain_attention_dropout(*leaves, bias, DROP_RATE, seed=SEED)
    with torch.no_grad():
        out["K2"]["plain_ms"] = event_ms(lambda: plain_attention(q, k, v,
                                                                 bias))
        out["K3"]["plain_ms"] = event_ms(lambda: plain_attention_dropout(
            q, k, v, bias, DROP_RATE, seed=SEED))
        out["K5"]["plain_ms"] = event_ms(lambda: plain_dropout(
            x, DROP_RATE, seed=SEED))
        out["K1"]["plain_ms"] = event_ms(lambda: troi.roi_align_plain(
            feat, boxes, mask, sampling_ratio=1, out_dtype=torch.float16))
        out["K1b"]["plain_ms"] = event_ms(lambda: troi.roi_align_bwd_plain(
            feat, boxes, mask, gb, sampling_ratio=1))
    out["K4"]["plain_ms"] = event_ms(lambda: torch.autograd.grad(
        po, leaves, gy, retain_graph=True))
    # the fp16 library calls
    sdpa = _sdpa_args(q, k, v, bias)
    with torch.no_grad():
        out["K2"]["library"] = library_ms(
            lambda: F.scaled_dot_product_attention(*sdpa[:3],
                                                   attn_mask=sdpa[3]))
        out["K3"]["library"] = library_ms(
            lambda: F.scaled_dot_product_attention(
                *sdpa[:3], attn_mask=sdpa[3], dropout_p=DROP_RATE))
        out["K5"]["library"] = library_ms(lambda: F.dropout(
            x, DROP_RATE, training=True))
    lib_leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
    lo = F.scaled_dot_product_attention(*lib_leaves, attn_mask=sdpa[3],
                                        dropout_p=DROP_RATE)
    gl = gy.transpose(1, 2).contiguous()
    out["K4"]["library"] = library_ms(lambda: torch.autograd.grad(
        lo, lib_leaves, gl, retain_graph=True))
    Bm, Hm, Wm, C = feat.shape
    grid, _ = k1_grid(boxes, Hm, Wm)
    kw = dict(mode="bilinear", padding_mode="border", align_corners=True)
    fn = feat.permute(0, 3, 1, 2).detach().requires_grad_()
    gs = F.grid_sample(fn, grid.to(torch.float16), **kw)
    with torch.no_grad():
        out["K1"]["library"] = library_ms(lambda: F.grid_sample(
            fn, grid.to(torch.float16), **kw))
    gg = gb.permute(0, 4, 1, 2, 3).reshape(gs.shape)
    out["K1b"]["library"] = library_ms(lambda: torch.autograd.grad(
        gs, fn, gg, retain_graph=True))
    return out


def _stage_maxima(model, batch):
    """The largest |activation| of each STAGES module in one eval-mode
    forward of ``model`` on ``batch`` (its labels left out), as floats
    (inf where a value overflowed)."""
    import torch

    found, hooks = {}, []
    mods = dict(model.named_modules())

    def tensors(out):
        if torch.is_tensor(out):
            return [out]
        return [t for o in out for t in tensors(o)] \
            if isinstance(out, (tuple, list)) else []

    for name, path in STAGES.items():
        def hook(_m, _i, out, name=name):
            found[name] = torch.stack([t.detach().float().abs().max()
                                       for t in tensors(out)]).max()
        hooks.append(mods[path].register_forward_hook(hook))
    try:
        with torch.no_grad():
            model.eval()(*batch[:-1])
    finally:
        for h in hooks:
            h.remove()
    return {k: float(v) for k, v in found.items()}


def calibrate_frozen_bn(model, batch):
    """Each frozen BN's running_mean and running_var set from its input's
    per-channel mean and variance in one fp32 forward of ``batch``, in
    forward order, so that each BN sees the inputs of the BNs before it
    already calibrated: the state a pretrained ResNet's frozen BN is in."""
    import torch
    from vlbert_tpu_torch.models.resnet import FrozenBatchNorm

    def pre(m, args):
        x = args[0].float()
        m.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        m.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            model.eval()(*batch[:-1])
    finally:
        for h in hooks:
            h.remove()
    return len(hooks)


def save_resnet_warm_start(model, path):
    """The image feature extractor's backbone and conv5 head as a raw
    torchvision-layout ResNet file (``layer4.*`` the head), the form
    NETWORK.IMAGE_PRETRAINED reads."""
    import torch

    fe = model.image_feature_extractor
    sd = {k: v.detach().cpu() for k, v in fe.backbone.state_dict().items()}
    sd.update({f"layer4.{k}": v.detach().cpu() for k, v in
               fe.roi_head_feature_extractor.state_dict().items()})
    torch.save(sd, path)
    return path


@contextlib.contextmanager
def fp16_step_records():
    """Records what 19b's run hands the kernels and the optimizer: the
    dtypes each kernel wrapper's launch takes; the largest |dq|, |dk|, |dv|
    (K4) and |dF| (K1b) of the first optimizer step, their non-finite
    elements and the share of their elements below fp16's smallest normal
    (subnormal: fewer than 11 bits kept); each step's grad norm and
    whether every unscaled gradient is finite. Yields the record."""
    import torch
    from vlbert_tpu_torch.ops import attention as tattn
    from vlbert_tpu_torch.ops import dropout as tdrop
    from vlbert_tpu_torch.ops import roi_align as troi
    from vlbert_tpu_torch.training.optim import Optimizer

    rec = {"dtypes": {}, "grads": {"dq": [], "dk": [], "dv": [], "dF": []},
           "norms": [], "finite": [], "first": True}

    def note(name, *dtypes):
        rec["dtypes"].setdefault(name, set()).add(
            "->".join(str(d)[6:] for d in dtypes))

    def first_step(**ts):
        if rec["first"]:
            for k, t in ts.items():
                a = t.detach().float().abs()
                rec["grads"][k].append(torch.stack(
                    [a.max(), (~torch.isfinite(a)).sum().float(),
                     ((a > 0) & (a < FP16_MIN_NORMAL)).sum().float(),
                     torch.tensor(float(a.numel()), device=a.device)]))

    saved = (troi._roi_align_cuda, troi._roi_align_bwd_cuda,
             tattn._attention_launch, tattn._attention_dropout_launch,
             tattn._attention_dropout_bwd_launch, tdrop._dropout_launch,
             Optimizer.step)

    def k1(features, *a):
        note("K1", features.dtype, a[-1])
        return saved[0](features, *a)

    def k1b(g, boxes, mask, shape, dtype, *a):
        note("K1b", g.dtype, dtype)
        df = saved[1](g, boxes, mask, shape, dtype, *a)
        first_step(dF=df)
        return df

    def k2(q, *a):
        note("K2", q.dtype)
        return saved[2](q, *a)

    def k3(q, *a):
        note("K3", q.dtype)
        return saved[3](q, *a)

    def k4(q, k, v, bias, g, *a):
        note("K4", q.dtype, g.dtype)
        dq, dk, dv, dbias = saved[4](q, k, v, bias, g, *a)
        first_step(dq=dq, dk=dk, dv=dv)
        return dq, dk, dv, dbias

    def k5(x, *a):
        note("K5", x.dtype)
        return saved[5](x, *a)

    def opt_step(self, grads):
        rec["finite"].append(bool(torch.stack(
            [torch.isfinite(t).all() for t in grads]).all()))
        norm = saved[6](self, grads)
        rec["norms"].append(float(norm))
        rec["first"] = False
        return norm

    (troi._roi_align_cuda, troi._roi_align_bwd_cuda, tattn._attention_launch,
     tattn._attention_dropout_launch, tattn._attention_dropout_bwd_launch,
     tdrop._dropout_launch, Optimizer.step) = (k1, k1b, k2, k3, k4, k5,
                                               opt_step)
    try:
        yield rec
    finally:
        (troi._roi_align_cuda, troi._roi_align_bwd_cuda,
         tattn._attention_launch, tattn._attention_dropout_launch,
         tattn._attention_dropout_bwd_launch, tdrop._dropout_launch,
         Optimizer.step) = saved
        for k, v in rec["grads"].items():
            if v:
                s = torch.stack(v)
                rec["grads"][k] = (s[:, 0].max().item(),
                                   int(s[:, 1].sum().item()),
                                   (s[:, 2].sum() / s[:, 3].sum()).item())


def _kept_step(model, cfg, batch, seed, plain=None):
    """One optimizer step of ``model`` on ``batch`` (the config's
    accumulation and loss scale): (loss, {name: the unscaled fp32 gradient
    the optimizer took}, launches)."""
    import torch
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import Optimizer

    opt = Optimizer(cfg, model, 4)
    kept, opt_step = {}, opt.step

    def step_and_keep(grads):
        kept.update((n, g.detach().clone()) for n, g in zip(opt.names,
                                                            grads))
        return opt_step(grads)

    opt.step = step_and_keep
    accum = max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    _zero_counts()
    with plain() if plain else contextlib.nullcontext():
        loss, _ = make_train_step(model, opt, "vcr", cfg, accum)(batch, seed)
        torch.cuda.synchronize()
    return float(loss), kept, _launch_counts()


def scale_bit_for_bit(cfg, dev):
    """One fp32 optimizer step of ``cfg``'s model (the kernels' fp32
    routes, cuDNN and torch held to deterministic algorithms) with the
    loss scale FP16_LOSS_SCALE and with none, from the same weights, seed
    and batch: the losses and every updated parameter must be equal bit
    for bit (a power-of-two scale is exact in fp32). Returns (equal
    parameters, of how many, the two losses)."""
    import torch
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.loop import make_train_step
    from vlbert_tpu_torch.training.optim import (Optimizer,
                                                 apply_trainable_mask)

    task = "vqa"
    one = cfg.clone()
    one.TPU.PROCESS_WORKERS = False
    batch = first_train_batch(one, task, dev)
    scaled = cfg.clone()
    scaled.TRAIN.FP16 = True
    scaled.TPU.FP16_PARITY_MODE = True
    scaled.TRAIN.FP16_LOSS_SCALE = FP16_LOSS_SCALE
    accum = max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    params, losses = [], []
    saved_modes = (torch.backends.cudnn.deterministic,
                   torch.are_deterministic_algorithms_enabled(),
                   torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for c in (cfg, scaled):
            model = build_module(c, task, dtype=torch.float32, device=dev)
            init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
            apply_trainable_mask(model, c)
            loss, _ = make_train_step(model, Optimizer(c, model, 4), task, c,
                                      accum)(batch, SEED + 5)
            losses.append(float(loss))
            params.append(dict(model.named_parameters()))
    finally:
        torch.backends.cudnn.deterministic = saved_modes[0]
        torch.use_deterministic_algorithms(saved_modes[1],
                                           warn_only=saved_modes[2])
    equal = sum(torch.equal(p, params[1][k]) for k, p in params[0].items())
    return equal, len(params[0]), losses


def vcr_large_fp16_phase(root, vocab_dir, data_dir=None, cfg7=None):
    """19b: ``python -m vlbert_tpu_torch.engine.train --task vcr`` from the
    shipped large Q2A config with phase 15's overrides and
    TPU.FP16_PARITY_MODE, TRAIN.FP16_LOSS_SCALE FP16_LOSS_SCALE (the
    config's 'dynamic' is shown to raise first, before a model is built):
    float16 compute, 4 SGD steps of 4 micro-steps and one validation run
    on phase 15's fixture (``data_dir``; written under ``root`` when None).
    The seed-0 weights' per-stage maxima in fp16 beside bf16 on the first
    batch; where a stage overflows fp16, each frozen BN is calibrated from
    one fp32 forward of that batch and the run starts from those weights
    through NETWORK.IMAGE_PRETRAINED. Exact launches, every one on an fp16
    route; grad norms and finite unscaled gradients each step; the first
    step's largest K4 and K1b outputs; step p50 and peak. Then the first
    step's batch in fp16 (kernels) against fp32 (plain versions) from the
    same weights and seed, and an fp32 step with the scale against one
    without (``cfg7``, phase 7's VQA config; made under ``root`` when
    None), bit for bit. Returns results."""
    import gc

    import torch
    import vlbert_tpu_torch.engine.train as t_train
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training.optim import apply_trainable_mask
    from vlbert_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    seconds = {}
    if data_dir is None:
        data_dir, _ = write_vcr_fixture(root, n_train=VCR_TRAIN_QUESTIONS)
    rows = sum(1 for _ in open(os.path.join(data_dir, "val.jsonl")))
    base = {**e2e_overrides(root, data_dir, vocab_dir),
            "DATASET.TRAIN_ANNOTATION_FILE": "train.jsonl",
            "DATASET.VAL_ANNOTATION_FILE": "val.jsonl",
            "OUTPUT_PATH": os.path.join(root, "out19"),
            "TRAIN.END_EPOCH": 1, "VAL_FREQUENT": 1, "LOG_FREQUENT": 4,
            "TRAIN.LR": 6.25e-4, "TPU.FP16_PARITY_MODE": True}
    src = LARGE_CFGS["vcr"]
    # the shipped 'dynamic' scale raises before anything is built
    dyn = write_train_yaml(src, os.path.join(root, "fp16_dynamic.yaml"),
                           base)
    built = []
    saved_build = t_train.build_module
    t_train.build_module = lambda *a, **kw: built.append(1)
    try:
        t_train.main(["--task", "vcr", "--cfg", dyn])
        dynamic = "no error"
    except ValueError as e:
        dynamic = str(e)
    finally:
        t_train.build_module = saved_build
    overrides = dict(base, **{"TRAIN.FP16_LOSS_SCALE": FP16_LOSS_SCALE})
    path = write_train_yaml(src, os.path.join(root, "fp16.yaml"), overrides)
    cfg = load_config("vcr", path)
    dtype, scale = t_train.compute_policy(cfg)
    one = cfg.clone()
    one.TPU.PROCESS_WORKERS = False
    batch = first_train_batch(one, "vcr", "cuda")

    # the seed-0 weights' maxima, fp16 beside bf16; the BN calibration
    def seed0(dt):
        m = build_module(cfg, "vcr", dtype=dt, device="cuda")
        init_weights(m, torch.Generator(device="cuda").manual_seed(SEED))
        return m

    maxima, models = {}, {}
    for dt in (torch.bfloat16, torch.float16):
        models[dt] = seed0(dt)
        maxima[str(dt)[6:]] = _stage_maxima(models[dt], batch)
    overflow = sorted(k for k, v in maxima["float16"].items()
                      if not math.isfinite(v))
    calibrated, n_bn = None, 0
    if overflow:
        ref = seed0(torch.float32)
        n_bn = calibrate_frozen_bn(ref, batch)
        bn = {k: v for k, v in ref.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
        for m in models.values():
            m.load_state_dict(bn, strict=False)
        calibrated = {str(dt)[6:]: _stage_maxima(m, batch)
                      for dt, m in models.items()}
        warm = save_resnet_warm_start(ref, os.path.join(root,
                                                        "resnet_bn.model"))
        overrides["NETWORK.IMAGE_PRETRAINED"] = warm
        path = write_train_yaml(src, path, overrides)
        cfg = load_config("vcr", path)
        del ref
    del models
    gc.collect()
    torch.cuda.empty_cache()
    _zero_counts()
    seconds["setup"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with fp16_step_records() as recs:
        run = e2e_train_run("vcr", path, record_writes=True)
    seconds["train"] = time.perf_counter() - t0
    hist, model = run["history"], run["model"]
    accum = cfg.TRAIN.GRAD_ACCUMULATE_STEPS
    micro = cfg.TRAIN.BATCH_IMAGES
    n_val = -(-rows // cfg.VAL.BATCH_IMAGES)
    want_step = e2e_launches("vcr", accum, layers=LARGE_LAYERS)
    want_val = e2e_launches("vcr", 0, n_val, layers=LARGE_LAYERS)
    kinds = {k: sorted(v) for k, v in recs["dtypes"].items()}
    want_kinds = {"K1": ["float16->float16"], "K1b": ["float16->float16"],
                  "K2": ["float16"], "K3": ["float16"],
                  "K4": ["float16->float16"], "K5": ["float16"]}
    res = {"dynamic": dynamic, "dynamic_built": len(built),
           "policy": (str(dtype)[6:], scale), "maxima": maxima,
           "overflow": overflow, "calibrated": calibrated,
           "n_bn": n_bn,
           "overrides": {k: v for k, v in overrides.items()
                         if not k.startswith(("DATASET.", "NETWORK.BERT",
                                              "OUTPUT"))},
           "loss": hist["loss"], "val_acc": [v["Acc"] for v in hist["val"]],
           "norms": recs["norms"], "finite": recs["finite"],
           "first_step_grads": recs["grads"], "dtypes": kinds,
           "steps": run["steps"], "val": run["val"], "total": run["total"],
           "want_step": want_step, "want_val": want_val, "accum": accum,
           "micro": micro, "step_ms": hist["step_ms"],
           "peak_gib": run["peak_gib"], "wall_s": run["wall_s"]}
    res["checks"] = {
        "dynamic raises before a build": "FP16_LOSS_SCALE" in dynamic
        and not built,
        "policy": res["policy"] == ("float16", FP16_LOSS_SCALE),
        "rc": run["rc"] == 0,
        "steps": len(run["steps"]) == VCR_TRAIN_QUESTIONS // (accum * micro)
        and all(c == want_step for c in run["steps"]),
        "val": len(run["val"]) == 1 and run["val"][0] == want_val,
        "fp16 routes": kinds == want_kinds,
        "finite loss": all(map(math.isfinite, hist["loss"])),
        "finite gradients": len(recs["finite"]) == len(hist["loss"])
        and all(recs["finite"])}
    batch = run["batch"]
    del run, hist
    torch.cuda.empty_cache()

    # the first step's batch, fp16 with the kernels against fp32 with the
    # plain versions, from the run's initial weights and one seed
    t0 = time.perf_counter()
    init = build_module(cfg, "vcr", dtype=torch.float32, device="cuda")
    init_weights(init, torch.Generator(device="cuda").manual_seed(SEED))
    t_train.apply_warm_starts(init, cfg)
    state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init, model
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = cfg.clone()
    cfg32.TRAIN.FP16 = False
    cfg_bf16 = cfg.clone()
    cfg_bf16.TPU.FP16_PARITY_MODE = False
    steps = {}
    for dt, c, plain in ((torch.float16, cfg, None),
                         (torch.bfloat16, cfg_bf16, None),
                         (torch.float32, cfg32, plain_e2e_training)):
        m = build_module(c, "vcr", dtype=dt, device="cuda")
        m.load_state_dict(state)
        apply_trainable_mask(m, c)
        steps[str(dt)[6:]] = _kept_step(m, c, batch, SEED + 5, plain)
        del m
        gc.collect()
        torch.cuda.empty_cache()
    (l16, g16, c16), (l32, g32, c32) = steps["float16"], steps["float32"]
    lb, gb, _ = steps["bfloat16"]

    def rel_l2(g):
        out = {}
        for name, prefix in E2E_LEAF_GROUPS.items():
            keys = [k for k in g32 if k.startswith(prefix)]
            num = sum(float((g[k] - g32[k]).double().pow(2).sum())
                      for k in keys)
            den = sum(float(g32[k].double().pow(2).sum()) for k in keys)
            out[name] = (num / max(den, 1e-300)) ** 0.5
        return out

    res["vs_fp32"] = {"loss": (l16, l32), "loss_rel": abs(l16 - l32)
                      / abs(l32), "grad_rel_l2": rel_l2(g16),
                      "bf16_loss_rel": abs(lb - l32) / abs(l32),
                      "bf16_grad_rel_l2": rel_l2(gb),
                      "launches": (c16, c32)}
    res["checks"]["vs fp32 launches"] = c16 == want_step \
        and not any(c32.values())
    res["checks"]["vs fp32 finite"] = math.isfinite(l16) and all(
        bool(torch.isfinite(g).all()) for g in g16.values())
    seconds["vs_fp32"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if cfg7 is None:
        cfg7, _ = vqa_train_config(os.path.join(root, "vqa7"))
    equal, n_params, losses = scale_bit_for_bit(cfg7, "cuda")
    res["scale_fp32"] = {"equal": equal, "params": n_params,
                         "loss": losses}
    res["checks"]["fp32 scale bit for bit"] = equal == n_params \
        and losses[0] == losses[1]
    seconds["scale_fp32"] = time.perf_counter() - t0
    res["seconds"] = seconds
    return res


def _ms(t):
    """'ms (call ms)' of a (device ms, call ms) pair."""
    return f"{t[0]:.4f} ({t[1]:.4f})"


def print_fp16_parity(errs, times, card):
    """19a's line."""
    by_kernel = {}
    for key, err in errs.items():
        k = key.split("/")[0]
        by_kernel[k] = max(by_kernel.get(k, 0.0), err)
    print(f"[19a parity fp16] each kernel's fp16 route against its plain "
          f"version in fp16, max err by kernel {by_kernel} over {len(errs)} "
          f"cases: K1 on {list(K1_FP16_CASES)} to fp16 (one fp16 step "
          f"{K1_FP16_RTOL} |b| + {K1_ATOL}) and fp32 out (atol {K1_ATOL}); "
          f"K1b at VCR's and pretraining's shapes (rel to max(1, |dF|) "
          f"{K1B_RTOL} + one fp16 step), repeated bit for bit, the padded "
          f"slots' g at {FP16_MAX} unread; K2 (B, L) {list(K2_FP16_CASES)}, "
          f"K3 / K4 {list(K34_FP16_CASES)} at H = 12 and 16, bits and "
          f"Philox (atol {K2_ATOL['float16']}, {K3_ATOL['float16']}, rtol "
          f"{BWD_RTOL['float16']}: no looser than bf16's), keep masks bit "
          f"for bit at both H, a K4 repeat bit for bit; K5 over "
          f"{len(K5_CASES)} shapes and views, exact. Device ms (call ms) at "
          f"VCR-large's shapes, fp16 / bf16 / plain fp16 (CUDA events) / "
          f"library fp16: "
          + "; ".join(f"{k} {_ms(t['float16'])} / {_ms(t['bfloat16'])} / "
                      f"{t['plain_ms']:.4f} / {t['library'][0]:.4f} "
                      f"{t['library'][1][:3]}" for k, t in times.items())
          + f" ({card})", flush=True)


def print_fp16_train(r, r15, card, seconds):
    """19b's lines."""
    p50 = step_p50(r["step_ms"])
    fs = r["first_step_grads"]
    print(f"[19b train VCR-large fp16] python -m vlbert_tpu_torch.engine."
          f"train --task vcr from {LARGE_CFGS['vcr']} with phase 15's "
          f"overrides and {json.dumps(r['overrides'])}: the shipped "
          f"FP16_LOSS_SCALE 'dynamic' raises before a model is built "
          f"({r['dynamic'][:90]}...; builds {r['dynamic_built']}); "
          f"compute_policy {r['policy']}; seed-0 per-stage max |activation| "
          f"on the first batch (eval): {r['maxima']}; overflow in fp16 "
          f"{r['overflow']}"
          + (f"; each of {r['n_bn']} frozen BNs calibrated from one fp32 "
             f"forward of that batch, stage by stage, and the run started "
             f"from those weights through NETWORK.IMAGE_PRETRAINED: "
             f"{r['calibrated']}" if r["overflow"] else "")
          + f" ({card})", flush=True)
    print(f"[19b train VCR-large fp16] {len(r['loss'])} SGD steps of "
          f"{r['accum']} micro-steps x {r['micro']} images x 4 choices, "
          f"loss {[round(x, 4) for x in r['loss']]}, grad norm (unscaled) "
          f"{[round(x, 4) for x in r['norms']]}, every unscaled gradient "
          f"finite {r['finite']}; val Acc {r['val_acc']}; launches per step "
          f"{r['want_step']} and per validation run {r['want_val']} on every "
          f"one, total {r['total']}; kernel dtypes {r['dtypes']}; first "
          f"step's largest |output| (non-finite elements, share below "
          f"fp16's smallest normal) of K4 dq "
          f"{fs['dq']}, dk {fs['dk']}, dv {fs['dv']}, K1b dF {fs['dF']} "
          f"(gradients x {FP16_LOSS_SCALE}); step p50 {p50:.2f} ms against "
          f"phase 15a's bf16 {step_p50(r15['step_ms']):.2f}; peak device "
          f"memory {r['peak_gib']:.2f} GiB against {r15['peak_gib']:.2f}; "
          f"{r['wall_s']:.2f} s of main ({card})", flush=True)
    v = r["vs_fp32"]
    sf = r["scale_fp32"]
    print(f"[19b step fp16 vs fp32] the first step's batch from the run's "
          f"initial weights and seed, fp16 with the kernels and the loss "
          f"scale against fp32 with the plain versions: loss "
          f"{v['loss'][0]:.6f} vs {v['loss'][1]:.6f} (rel {v['loss_rel']:.3e}"
          f"), relative L2 gradient difference by leaf group "
          f"{ {k: f'{x:.3e}' for k, x in v['grad_rel_l2'].items()} }; the "
          f"same step in bf16 (kernels, no scale) against fp32: loss rel "
          f"{v['bf16_loss_rel']:.3e}, by leaf group "
          f"{ {k: f'{x:.3e}' for k, x in v['bf16_grad_rel_l2'].items()} }; "
          f"launches {v['launches'][0]}, plain {v['launches'][1]}; an fp32 "
          f"VQA step (phase 7's config) with the loss scale "
          f"{FP16_LOSS_SCALE} against none: {sf['equal']} of {sf['params']} "
          f"parameters bit-identical, loss {sf['loss']}; phase 19 seconds "
          f"{ {k: round(x, 1) for k, x in {**seconds, **r['seconds']}.items()} } "
          f"({card})", flush=True)


# kernel record name -> its launch counter and 19a's key
FP16_KEYS = {"roi_align_fwd": "K1", "roi_align_bwd": "K1b",
             "attention_fwd": "K2", "attention_dropout_fwd": "K3",
             "attention_dropout_bwd": "K4", "dropout": "K5"}


def add_fp16_records(kernels, errs, times, r19):
    """Each kernel record's fp16 route: its parity error, ms beside the
    bf16 route's in the same run, plain, bound (the bf16 bound: the same
    bytes, the same tensor-core rate) and library time at VCR-large's
    shapes, and its launches in 19b's run."""
    import torch

    dev = torch.device("cuda", 0)
    B, L, H = LARGE_ATTN
    n5 = B * L * H * 64
    feat, boxes, mask, g = k1b_inputs(dev, "vcr")
    live = int(mask.sum())
    Bm, Hm, Wm, C = feat.shape
    bounds = {
        "K1": roofline(feat.numel() * 2 + mask.numel() * 17
                       + mask.numel() * 196 * C * 2,
                       2 * 4 * live * 196 * C, "float32"),
        "K1b": k1b_bound(feat, mask, g),
        "K2": attention_bound(B, L, H, 64, "float16"),
        "K3": attention_bound(B, L, H, 64, "float16"),
        "K4": attention_bound(B, L, H, 64, "float16", backward=True),
        "K5": roofline(2 * n5 * 2, n5, "float16")}
    shapes = {"K1": f"map [{Bm},{Hm},{Wm},{C}] fp16, {live} of "
                    f"{mask.numel()} slots live, out fp16",
              "K1b": f"g [{Bm},108,14,14,{C}] fp16 ({live} live), dF fp16",
              "K5": f"[{B},{L},{H * 64}] fp16"}
    total = r19["total"]
    counts = {"K1": total["K1"], "K1b": total["K1b"], "K2": total["K2"],
              "K3": total["K3"], "K4": total["K4"],
              "K5": (total["K5_fwd"], total["K5_bwd"])}
    per = dict(r19["want_step"], K2=r19["want_val"]["K2"],
               K5=(r19["want_step"]["K5_fwd"], r19["want_step"]["K5_bwd"]))
    for record in kernels:
        k = FP16_KEYS[record["name"]]
        t = times[k]
        bound = bounds[k]
        record["fp16"] = {
            "route": "cuda", "source": record["source"],
            "shape": shapes.get(k, f"B={B} L={L} H={H} D=64 fp16"),
            "launches": counts[k],
            "launches_per_step_or_val_run": per[k],
            "max_abs_err": max(v for key, v in errs.items()
                               if key.split("/")[0] == k),
            "ms": t["float16"][0], "call_ms": t["float16"][1],
            "bf16_ms": t["bfloat16"][0], "plain_ms": t["plain_ms"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": t["library"][0],
            "library_kernels": t["library"][1]}


# ------------------------------------------------ 20: JAX-native checkpoints

def jax_paths(model):
    """{state_dict name: (the JAX package's flat path, layout transform)}
    of ``model`` by the port converter's name rules, the VQA 'mlm'
    classifier on the JAX VQA module's paths; the tied decoder (the word
    embeddings under a second name) has none."""
    from vlbert_tpu_torch.models.task_modules import Classifier
    from vlbert_tpu_torch.models.vlbert import TIED_DECODER
    from vlbert_tpu_torch.training import convert as cvt

    head = getattr(model, "final_mlp", None)
    renames = cvt._MLM_HEAD if isinstance(head, Classifier) \
        and head.kind == "mlm" else ()
    out = {}
    for name in model.state_dict():
        if TIED_DECODER in name:
            continue
        mapped = cvt.map_reference_name(cvt.normalize_torch_name(name))
        if mapped is None:
            raise KeyError(f"{name} has no JAX path")
        path, transform = mapped
        for old, new in renames:
            if path.startswith(old):
                path = new + path[len(old):]
        out[name] = (path, transform)
    return out


def to_jax_layout(t, transform):
    """A port tensor in the JAX package's layout (the converter's)."""
    t = t.detach().cpu()
    if transform == "linear":
        return t.t().contiguous()
    if transform == "conv":
        return t.permute(2, 3, 1, 0).contiguous()
    if transform == "squeeze0":
        return t[0].contiguous()
    return t.contiguous()


def jax_tree(flat):
    """Flat {dot.path: leaf} -> the nested tree, query / key / value
    fused into qkv ([in, 3 out] kernels) as TPU.FUSED_QKV builds it."""
    import re

    import torch

    parts, tree = {}, {}
    for path, leaf in flat.items():
        m = re.match(r"^(.*attention\.self\.)(query|key|value)\.(kernel|bias)$",
                     path)
        if m and isinstance(leaf, torch.Tensor):
            parts.setdefault((m.group(1), m.group(3)), {})[m.group(2)] = leaf
            continue
        node = tree
        *up, last = path.split(".")
        for k in up:
            node = node.setdefault(k, {})
        node[last] = leaf
    for (prefix, kind), qkv in parts.items():
        node = tree
        for k in (prefix + "qkv").split("."):
            node = node.setdefault(k, {})
        node[kind] = torch.cat([qkv["query"], qkv["key"], qkv["value"]],
                               dim=1 if kind == "kernel" else 0)
    return tree


def jax_checkpoint(payload, model, cfg, masked=False, params_only=False):
    """A port checkpoint's payload as the JAX package's save of the same
    state: ``{"params": {"params": tree}, "opt_state": the optax chain of
    vlbert_tpu/training/optim.py (clip, AdamW's {count, mu, nu}, masked
    weight decay, LR_MULT, the schedule's count, [the plateau scale], the
    trainable mask), "step", "extra"}``. ``masked``: TPU.MASKED_OPT_STATE's
    layout (the moments under ``inner_state``, a frozen leaf's an empty
    map); ``params_only``: an empty optimizer state."""
    import torch

    paths = jax_paths(model)
    sd = payload["state_dict"]
    params = jax_tree({paths[n][0]: to_jax_layout(t, paths[n][1])
                       for n, t in sd.items() if n in paths})
    out = {"params": {"params": params}, "opt_state": {},
           "step": int(payload["step"]), "extra": payload["extra"]}
    if params_only:
        return out
    opt = payload["optimizer"]

    def moments(saved):
        flat = {}
        for n, (path, transform) in paths.items():
            if n in saved:
                flat[path] = to_jax_layout(saved[n].float(), transform)
            else:                        # a frozen leaf (or a buffer)
                flat[path] = {} if masked else to_jax_layout(
                    torch.zeros(sd[n].shape), transform)
        return jax_tree(flat)

    step = torch.tensor(out["step"], dtype=torch.int32)
    adam = {"count": step, "mu": moments(opt["mu"]),
            "nu": moments(opt["nu"])}
    t = cfg.TRAIN
    chain = [{}] if t.CLIP_GRAD_NORM and t.CLIP_GRAD_NORM > 0 else []  # clip
    chain.append({"inner_state": adam} if masked else adam)
    if t.WD:
        chain.append({"inner_state": {}})             # masked weight decay
    chain += [{}, {"count": step}]                    # LR_MULT, schedule
    if t.LR_SCHEDULE == "plateau":
        chain.append({"plateau_scale": torch.tensor(
            float(opt["plateau_scale"]), dtype=torch.float32)})
    chain.append({})                                  # trainable mask
    out["opt_state"] = {str(i): s for i, s in enumerate(chain)}
    return out


def pretrain_jax_checkpoint(file_sd):
    """Phase 9's reference-layout pretrain weights (``module.`` prefix,
    the classifier's transform under the MLM head) in the JAX pretraining
    model's layout: the encoder and embeddings under ``vlbert.bert.``, the
    heads at ``vlbert.<head>``, qkv fused."""
    from vlbert_tpu_torch.training import convert as cvt

    flat = {}
    for name, t in file_sd.items():
        mapped = cvt.map_reference_name(cvt.normalize_torch_name(name))
        if mapped is None:               # no leaf of the JAX model
            continue
        path, transform = mapped
        if path.startswith("vlbert.") and not path.startswith(
                ("vlbert.mlm_head", "vlbert.mvrc_head",
                 "vlbert.relationship_head")):
            path = "vlbert.bert." + path[len("vlbert."):]
        flat[path] = to_jax_layout(t, transform)
    return {"params": {"params": jax_tree(flat)}, "opt_state": {},
            "step": 0, "extra": {}}


def jax_resume_phase(root, cfg9, r9, r11v, device="cuda"):
    """Phase 20a-c on phase 9's files (``cfg9``, ``r9``) and phase 11's
    answers (``r11v``). The JAX-layout files are written in memory where
    /dev/shm has room (the earlier phases already write tens of GiB of
    checkpoints to disk), and removed. Returns results."""
    shm = "/dev/shm"
    ram = os.path.isdir(shm) and shutil.disk_usage(shm).free > 8 * 2 ** 30
    where = tempfile.mkdtemp(prefix="jax20_", dir=shm if ram else root)
    try:
        res = _jax_resume_body(root, where, cfg9, r9, r11v, device)
    finally:
        shutil.rmtree(where, ignore_errors=True)
    res["files_in"] = "/dev/shm" if ram else "the run's directory"
    return res


def _jax_resume_body(root, where, cfg9, r9, r11v, device):
    import types

    import torch
    import vlbert_tpu_torch.engine.train as t_train
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.training import jax_format
    from vlbert_tpu_torch.training.convert import checkpoint_format

    res = {}
    prefix = cfg9.MODEL_PREFIX
    src = os.path.join(cfg9.OUTPUT_PATH, "vqa_train", f"{prefix}-0002.model")
    t0 = time.perf_counter()
    payload = torch.load(src, map_location="cpu", weights_only=True)
    res["torch_read_s"] = time.perf_counter() - t0
    res["torch_mb"] = os.path.getsize(src) / 2 ** 20
    meta = build_module(cfg9, "vqa", dtype=torch.float32, device="meta")
    files = {}
    for kind in ("torch", "dense", "masked"):
        out = os.path.join(where, f"out20_{kind}", "vqa_train")
        os.makedirs(out)
        files[kind] = os.path.join(out, f"{prefix}-0002.model")
    os.symlink(src, files["torch"])
    for kind in ("dense", "masked"):
        t0 = time.perf_counter()
        jax_format.dump(jax_checkpoint(payload, meta, cfg9,
                                       masked=kind == "masked"), files[kind])
        res[f"{kind}_write_s"] = time.perf_counter() - t0
        res[f"{kind}_mb"] = os.path.getsize(files[kind]) / 2 ** 20
    t0 = time.perf_counter()
    jax_format.load(files["dense"])
    res["native_read_s"] = time.perf_counter() - t0
    res["formats"] = {k: checkpoint_format(v) for k, v in files.items()}
    del payload

    # 20a: AUTO_RESUME of one more epoch from each file
    held, runs = {}, {}
    saved = t_train.resume

    def resume(model_prefix, model, optimizer, config):
        begin, extra = saved(model_prefix, model, optimizer, config)
        state = ([t.detach().clone() for t in model.state_dict().values()]
                 + [m.clone() for m in optimizer.mu + (optimizer.nu or [])],
                 optimizer.count, optimizer.plateau_scale, extra)
        if not held:
            held["state"] = state
        else:
            ref = held["state"]
            held["equal"] = held.get("equal", True) and (
                len(ref[0]) == len(state[0])
                and all(torch.equal(a, b) for a, b in zip(ref[0], state[0]))
                and ref[1:] == state[1:])
        return begin, extra

    n_val = -(-32 // cfg9.VAL.BATCH_IMAGES)
    t_train.resume = resume
    try:
        for kind in ("torch", "dense", "masked"):
            cfg = cfg9.clone()
            cfg.OUTPUT_PATH = os.path.join(where, f"out20_{kind}")
            cfg.TRAIN.END_EPOCH, cfg.TRAIN.AUTO_RESUME = 4, True
            args = types.SimpleNamespace(model_dir=cfg.OUTPUT_PATH,
                                         device=device)
            t0 = time.perf_counter()
            with checkpoint_writes_recorded():
                _zero_counts()
                _, h = t_train.train_net(args, cfg, "vqa")
                launches = _launch_counts()
            runs[kind] = {"loss": h["loss"], "begin": h["begin_epoch"],
                          "count": h["resumed_count"], "launches": launches,
                          "s": time.perf_counter() - t0}
            torch.cuda.empty_cache()
    finally:
        t_train.resume = saved
    res["runs"] = runs
    res["state_equal"] = held.get("equal", False)
    res["count"], res["plateau_scale"] = held["state"][1:3]
    res["extra"] = held["state"][3]
    res["n_state"] = len(held["state"][0])
    held.clear()
    want = train_launches(4, n_val)
    res["checks_a"] = {
        "formats": res["formats"] == {"torch": "torch", "dense": "native",
                                      "masked": "native"},
        "resumed": all((r["begin"], r["count"]) == (3, 12)
                       for r in runs.values()),
        "state": res["state_equal"],
        "losses": runs["dense"]["loss"] == runs["torch"]["loss"]
        == runs["masked"]["loss"] and len(runs["torch"]["loss"]) == 4,
        "finite": all(map(math.isfinite, runs["torch"]["loss"])),
        "launches": all(r["launches"] == want for r in runs.values())}

    # 20b: test_net_vqa from a JAX-layout -best.model
    best = torch.load(r9["best"], map_location="cpu", weights_only=True)
    native_best = os.path.join(where, "native-best.model")
    jax_format.dump(jax_checkpoint(best, meta, cfg9, params_only=True),
                    native_best)
    del best
    r20b = vqa_test_phase(cfg9, native_best, root)
    res["b"] = {k: r20b[k] for k in ("launches", "wall_s", "n", "loop_s")}
    res["checks_b"] = {"answers": r20b["ok"]
                       and r20b["rows"] == r11v["rows"],
                       "launches": r20b["launches"] == r11v["launches"]}

    # 20c: PARTIAL_PRETRAIN from the pretraining model's JAX layout
    ref_file = cfg9.NETWORK.PARTIAL_PRETRAIN
    file_sd = torch.load(ref_file, map_location="cpu",
                         weights_only=True)["state_dict"]
    native_pre = os.path.join(where, "pretrain-native.model")
    jax_format.dump(pretrain_jax_checkpoint(file_sd), native_pre)
    del file_sd
    loaded, states = {}, {}
    for kind, path in (("reference", ref_file), ("native", native_pre)):
        cfg = cfg9.clone()
        cfg.NETWORK.PARTIAL_PRETRAIN = path
        model = build_module(cfg, "vqa", device=device)
        init_weights(model, torch.Generator(device=device).manual_seed(
            SEED + 20))
        t0 = time.perf_counter()
        loaded[kind] = sorted(t_train.apply_partial_pretrain(model, cfg)[0])
        res[f"c_{kind}_s"] = time.perf_counter() - t0
        states[kind] = model.state_dict()
        del model
    res["c_loaded"] = len(loaded["native"])
    res["c_native_mb"] = os.path.getsize(native_pre) / 2 ** 20
    res["checks_c"] = {
        "names": loaded["native"] == loaded["reference"]
        and len(loaded["native"]) > 0,
        "values": all(torch.equal(states["native"][k],
                                  states["reference"][k])
                      for k in states["reference"])}
    del states
    torch.cuda.empty_cache()
    return res


def host_natives_phase(root, t_start):
    """Phase 20d: the native tokenizer's and the COCO mask codec's
    libraries, built by g++ on this machine in this run (at or after
    ``t_start``, a time.time()) and loaded; the tokenizer's ids against
    the Python path on phase 12's VCR texts and phase 7's questions, and
    each path's tokens/s."""
    import numpy as np
    from vlbert_tpu_torch.data import coco_mask, native_build
    from vlbert_tpu_torch.data.tokenization import BertTokenizer

    res = {"libs": {}}
    for name in ("wordpiece", "maskapi"):
        lib = native_build.load_native_lib(name)
        res["libs"][name] = {
            "loaded": lib is not None and lib._name
            == str(native_build.library_path(name)),
            "built_here": name in native_build.BUILT
            or os.path.getmtime(native_build.library_path(name)) >= t_start,
            "build_s": native_build.BUILT.get(name)}
    texts = []
    with open(os.path.join(root, "vqa", "train.jsonl")) as f:
        texts += [json.loads(line)["question"] for line in f if line.strip()]
    for split in ("val", "test"):
        with open(os.path.join(root, "vcr", f"{split}.jsonl")) as f:
            for line in f:
                if not line.strip():
                    continue
                r = json.loads(line)
                for words in ([r["question"]] + r["answer_choices"]
                              + r["rationale_choices"]):
                    texts.append(" ".join(w for w in words
                                          if isinstance(w, str)))
    texts += ["Where's the café?", "the man's HAT, (left)!"]
    tok = BertTokenizer.from_pretrained(os.path.join(root, "bert"))
    py = BertTokenizer.from_pretrained(os.path.join(root, "bert"),
                                       native=False)
    native_ids = [tok._native.tokenize_ids(t) for t in texts]
    res["ids_equal"] = all(
        (ids is None and not t.isascii())
        or ids == py.convert_tokens_to_ids(py.tokenize(t))
        for t, ids in zip(texts, native_ids))
    res["tokens_equal"] = all(tok.tokenize(t) == py._py_tokenize(t)
                              for t in texts)
    res["n_texts"] = len(texts)
    n_tokens = sum(len(py._py_tokenize(t)) for t in texts)
    for name, fn in (("native", tok._native.tokenize_ids),
                     ("python", py._py_tokenize)):
        reps = 0
        t0 = time.perf_counter()
        while reps < 3 or time.perf_counter() - t0 < 0.5:
            for t in texts:
                fn(t)
            reps += 1
        res[f"{name}_tokens_per_s"] = reps * n_tokens \
            / (time.perf_counter() - t0)
    rng = np.random.default_rng(SEED + 20)
    masks = [(rng.uniform(size=(48, 64)) > 0.6).astype(np.uint8)
             for _ in range(4)]
    native_rle = [coco_mask.encode(m) for m in masks]
    res["mask_native"] = coco_mask._load_lib() is not False and all(
        np.array_equal(coco_mask.decode(c, 48, 64), m)
        for c, m in zip(native_rle, masks))
    saved = coco_mask._LIB
    coco_mask._LIB = False
    try:
        res["mask_numpy_equal"] = all(
            np.array_equal(coco_mask.encode(m), c)
            for m, c in zip(masks, native_rle))
    finally:
        coco_mask._LIB = saved
    res["checks"] = {
        "libs": all(v["loaded"] and v["built_here"]
                    for v in res["libs"].values()),
        "ids": res["ids_equal"] and res["tokens_equal"],
        "masks": res["mask_native"] and res["mask_numpy_equal"]}
    return res


def print_jax_phase(r, rd, card):
    runs = r["runs"]
    print(f"[20a JAX resume] phase 9's epoch-2 state ({r['torch_mb']:.1f} "
          f"MiB torch file, read in {r['torch_read_s']:.2f} s) written in "
          f"the JAX package's layout by training/jax_format.py (to "
          f"{r['files_in']}): dense "
          f"moments {r['dense_mb']:.1f} MiB in {r['dense_write_s']:.2f} s, "
          f"masked {r['masked_mb']:.1f} MiB in {r['masked_write_s']:.2f} s; "
          f"the native file read (jax_format.load) in "
          f"{r['native_read_s']:.2f} s; formats {r['formats']}; "
          f"train_net AUTO_RESUME to END_EPOCH 4 from each: begin epoch, "
          f"count {[(v['begin'], v['count']) for v in runs.values()]}, "
          f"after the resume {r['n_state']} weight and moment tensors, "
          f"count {r['count']}, plateau scale {r['plateau_scale']} and "
          f"extra {r['extra']} the same bit for bit: {r['state_equal']}; "
          f"epoch 3's losses torch {runs['torch']['loss']}, dense "
          f"{runs['dense']['loss']}, masked {runs['masked']['loss']}; "
          f"launches {runs['dense']['launches']} each; seconds "
          f"{ {k: round(v['s'], 2) for k, v in runs.items()} }; checks "
          f"{r['checks_a']} ({card})", flush=True)
    print(f"[20b JAX test] test_net_vqa from a JAX-layout -best.model: "
          f"phase 11's answers {r['checks_b']['answers']}, launches "
          f"{r['b']['launches']} (phase 11's: {r['checks_b']['launches']}), "
          f"{r['b']['wall_s']:.2f} s end to end, inference loop "
          f"{r['b']['n'] / r['b']['loop_s']:.1f} samples/s ({card})",
          flush=True)
    print(f"[20c JAX pretrain] PARTIAL_PRETRAIN from phase 9's pretrain "
          f"weights in the JAX pretraining model's layout (vlbert.bert "
          f"nesting, fused qkv, {r['c_native_mb']:.1f} MiB) with the "
          f"shipped prefix changes: {r['c_loaded']} tensors, names and "
          f"values as from the reference-layout file: {r['checks_c']}; "
          f"{r['c_native_s']:.2f} s (reference file "
          f"{r['c_reference_s']:.2f} s) ({card})", flush=True)
    print(f"[20d host natives] libraries built by g++ here and loaded "
          f"{rd['libs']}; native tokenizer ids equal to the Python path's "
          f"on {rd['n_texts']} texts (phase 7's questions, phase 12's VCR "
          f"texts, two non-ASCII ones on the Python path): "
          f"{rd['checks']['ids']}; tokens/s native "
          f"{rd['native_tokens_per_s']:.0f}, Python "
          f"{rd['python_tokens_per_s']:.0f} "
          f"({rd['native_tokens_per_s'] / rd['python_tokens_per_s']:.1f}x)"
          f"; COCO RLE native round trip and numpy path equal: "
          f"{rd['checks']['masks']} ({card})", flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vlbert_tpu_torch.data.transforms import build_transforms
    from vlbert_tpu_torch.engine.serve import RefCOCOServer
    from vlbert_tpu_torch.kernels import build
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.ops.attention import fused_attention
    from vlbert_tpu_torch.ops.roi_align import roi_align
    from vlbert_tpu_torch.utils.config import load_config

    t_run, t_wall = time.perf_counter(), time.time()
    laps, lap_t = {}, [t_run]

    def lap(name):
        """The seconds since the previous lap, kept for [total] under
        ``name``: where a run's time goes."""
        now = time.perf_counter()
        laps[name] = round(now - lap_t[0], 1)
        lap_t[0] = now

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit " \
           f"{smi.split(',')[-1].strip()}"
    print(f"[1 device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)",
          flush=True)

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    print(f"[2 build] {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}",
          flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1_errs, k1_t = k1_parity(dev)
    k1_fp32_err = max(v for k, v in k1_errs.items() if "->float32" in k)
    k1_bf16_err = max(v for k, v in k1_errs.items() if "->bfloat16" in k)
    print(f"[3 parity K1 roi_align] {len(k1_errs)} cases "
          f"(case/map->out/sampling ratio) {sorted(k1_errs)}: max abs err "
          f"fp32 out {k1_fp32_err:.3e} (atol {K1_ATOL}), bf16 out "
          f"{k1_bf16_err:.3e} (within {K1_BF16_RTOL} |plain| + {K1_ATOL}), "
          f"padded slots 0; bf16 body4 [1,38,63,1024], 16 slots, sampling "
          f"1, warm, device ms by kernel (route, call ms, kernels a call): "
          + "; ".join(f"{k} {t['ms']:.4f} ({t['route_ms']:.4f}, "
                      f"{t['call_ms']:.4f}, {t['kernels_per_call']:g})"
                      for k, t in k1_t.items() if k != "plain")
          + f"; old route by kernel {k1_t['old_route']['by_kernel']}; plain "
          f"{k1_t['plain'][0]:.4f} ({k1_t['plain'][1]:.4f}) ({card})",
          flush=True)
    k2_errs, k2_ms = k2_parity(dev)
    print(f"[3 parity K2 attention] max abs err {k2_errs} (atol "
          f"{K2_ATOL}); on the tensor cores (fp32 by a three-product TF32 "
          f"split), H=12 D=64, device ms (call ms): " +
          ", ".join(f"{key} kernel {a[0]:.4f} ({a[1]:.4f}), plain "
                    f"{b[0]:.4f} ({b[1]:.4f})"
                    for key, (a, b) in k2_ms.items())
          + f" ({card})",
          flush=True)

    lap("1-3")
    # --- serve: full width, bf16 ---
    cfg = load_config("refcoco", CFG)
    cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED = False
    # a trained checkpoint has non-zero visual LN scales; the config's 0.0
    # init would make random-weight logits blind to the image
    cfg.NETWORK.VLBERT.visual_scale_text_init = 1.0
    cfg.NETWORK.VLBERT.visual_scale_object_init = 1.0
    model = build_module(cfg, "refcoco", dtype=torch.bfloat16, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    srv = RefCOCOServer(model, HashTokenizer(), build_transforms(cfg, "test"),
                        max_text=24, max_boxes=16)
    queries = make_queries()
    srv.query(*queries[0])                                   # warm-up
    torch.cuda.synchronize()

    launches = serve_checked(srv, queries)
    if launches != {"roi_align": 8, "fused_attention": 96}:
        raise AssertionError(f"main-path launches {launches}, expected 8 "
                             f"and 96")
    torch.cuda.reset_peak_memory_stats()
    lat = srv.measure_latency(queries * 3, warmup=3)
    print(f"[4 serve] RefCOCO+ base, ResNet-101 + VL-BERT 768x12x12, "
          f"{n_params / 1e6:.1f}M params, bf16, 8 distinct queries ok "
          f"(launches {launches}); latency p50 {lat['p50_ms']:.2f} ms, "
          f"p90 {lat['p90_ms']:.2f} ms over n={lat['n']}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({card})", flush=True)

    lap("4")
    # --- end-to-end agreement, fp32: kernels vs plain versions ---
    model32 = build_module(cfg, "refcoco", dtype=torch.float32, device=dev)
    model32.load_state_dict(model.state_dict())
    srv32 = RefCOCOServer(model32, HashTokenizer(),
                          build_transforms(cfg, "test"), max_text=24,
                          max_boxes=16)
    batch = srv32.preprocess(*queries[3])
    _zero_counts()
    with_kernels = srv32.infer(batch)["label_logits"][0]
    launches5 = _launch_counts()
    with plain_versions():
        plain = srv32.infer(batch)["label_logits"][0]
    n_live = int(batch[2].sum())
    e2e_err = float(np.abs(with_kernels - plain).max())
    top2 = np.sort(plain[:n_live])[-2:]
    fp32_query = dict.fromkeys(launches5, 0) | {"K1": 1, "K2": 12}
    if not (np.isfinite(with_kernels).all() and e2e_err <= E2E_ATOL
            and with_kernels.argmax() == plain.argmax()
            and launches5 == fp32_query):
        raise AssertionError(f"fp32 end to end: max abs err {e2e_err} "
                             f"(atol {E2E_ATOL}), argmax "
                             f"{with_kernels.argmax()} vs {plain.argmax()}, "
                             f"launches {launches5} (want {fp32_query})")
    print(f"[5 e2e fp32] kernels (launches {launches5}) vs plain versions "
          f"on one query with "
          f"{n_live} live boxes: max abs logit err {e2e_err:.3e} (atol "
          f"{E2E_ATOL}), argmax {int(plain.argmax())} on both, top-2 margin "
          f"{top2[1] - top2[0]:.3e}, logit spread "
          f"{plain[:n_live].std():.3e}", flush=True)

    lap("5")
    # --- 6: training kernels at the VQA training shapes ---
    k5_errs, k5_mask, k5_ms = k5_parity(dev)
    print(f"[6 parity K5 dropout] max abs err {max(k5_errs.values())} over "
          f"{len(k5_errs)} cases ((shape, elements skipped before the "
          f"view) {list(K5_CASES)}; fp32, bf16; bits and Philox; forward "
          f"and backward; atol {K5_ATOL}); Philox keep masks equal the "
          f"plain Philox's bit for bit, backward replays them, keep fraction "
          f"{k5_mask['keep_fraction']:.6f} (1 - rate {1 - DROP_RATE}, sigma "
          f"{k5_mask['sigma']:.1e}), two seeds differ; bf16 [16,128,768] "
          f"device ms (call ms): kernel {k5_ms[0][0]:.4f} "
          f"({k5_ms[0][1]:.4f}), plain {k5_ms[1][0]:.4f} ({k5_ms[1][1]:.4f}) "
          f"({card})", flush=True)
    (k34_errs, k3_mask, k3_ms, k4_ms, k4_split, k34_f32,
     k34_173) = k34_parity(dev)
    print(f"[6 parity K3/K4 attention dropout] H=12 D=64, q/k/v views of "
          f"one fused projection, 7 padded keys, one all-masked batch row, "
          f"B=16 L=128 and B=4 L=41, 173; on the tensor cores, bf16 and fp32 "
          f"(three-product TF32 split): K3 max abs err {k34_errs['K3']} (atol "
          f"{K3_ATOL}); K4 (dq, dk, dv, dbias) rel err {k34_errs['K4']} "
          f"(rtol {BWD_RTOL}); a K4 repeat is bit-identical in fp32 and "
          f"bf16; K2 "
          f"backward rel err {k34_errs['K2_bwd']}; K3 and K4 keep masks "
          f"read back in fp32 and bf16 equal the plain Philox's bit for bit "
          f"for two seeds, keep fraction {k3_mask['keep_fraction']:.6f} "
          f"(sigma {k3_mask['sigma']:.1e}); B=16 L=128 bf16 device ms (call "
          f"ms): K3 {k3_ms[0][0]:.4f} ({k3_ms[0][1]:.4f}) vs plain "
          f"{k3_ms[1][0]:.4f} ({k3_ms[1][1]:.4f}); K4 {k4_ms[0][0]:.4f} "
          f"({k4_ms[0][1]:.4f}) vs plain autograd {k4_ms[1][0]:.4f} "
          f"({k4_ms[1][1]:.4f}); K4 by kernel "
          f"{ {k[:48]: round(v, 5) for k, v in k4_split.items()} }; B=16 "
          f"L=173 bf16: K3 {k34_173['k3'][0][0]:.4f} "
          f"({k34_173['k3'][0][1]:.4f}) vs plain {k34_173['k3'][1][0]:.4f}; "
          f"K4 {k34_173['k4'][0][0]:.4f} ({k34_173['k4'][0][1]:.4f}) vs "
          f"plain autograd {k34_173['k4'][1][0]:.4f} ({card})", flush=True)

    slices = k34_head_slices(dev)
    print(f"[6 head slices K3/K4] tensor parallelism's launches: K3's "
          f"output and K4's dq, dk, dv of heads j*H/m .. (j+1)*H/m - 1 "
          f"launched alone with (head_offset, heads_total) equal the same "
          f"heads of the launch over all H bit for bit, Philox (the "
          f"layer's masks at the slice's offset) and explicit bits (the "
          f"slice's), (H, m) {list(HEAD_SLICES)}, B=16 L=128; slices "
          f"checked by dtype {slices}; the default launches' masks are "
          f"phase 6's above ({card})", flush=True)

    lib = library_yardsticks(dev)
    k1_lib = k1_library(dev)
    philox4_instr, _ = philox_sass_instructions()
    int_rate, n_sm, sm_mhz = int_issue_per_s()
    print(f"[6 yardsticks] library calls, bf16, device ms (kernels): " +
          "; ".join(f"{k} {v[0]:.4f} ({', '.join(n[:48] for n in v[1])})"
                    for k, v in lib.items()) +
          f"; Philox4x32-10: {philox4_instr} SASS instructions per "
          f"evaluation of all four words (K3, K4, K5), integer issue "
          f"{int_rate / 1e12:.2f} T/s ({n_sm} SMs x "
          f"{INT_LANES_PER_SM} lanes x {sm_mhz:.0f} MHz); K1 as one "
          f"F.grid_sample over the bin centres ({k1_lib[2]}, serve shape, "
          f"mask multiply left out) {k1_lib[0]:.4f} ms "
          f"({', '.join(n[:48] for n in k1_lib[1])}), fp32 max abs err "
          f"{k1_lib[3]:.2e} against the plain ROIAlign on the {k1_lib[4]} "
          f"live boxes inside the map; fp32 routes, kernel (plain; SDPA "
          f"fp32) ms: K2 (attention_f32_mma.cu) "
          + ", ".join(f"B{B}_L{L} {k2_ms[f'B{B}_L{L}_fp32'][0][0]:.4f} "
                      f"({k2_ms[f'B{B}_L{L}_fp32'][1][0]:.4f}; "
                      f"{lib[key][0]:.4f})"
                      for (B, L), key in zip(K2_TIMED, (
                          "K2_L41_fp32", "K2_L128_fp32", "K2_L173_fp32",
                          "K2_B16_L173_fp32")))
          + f"; K3 (attention_f32_mma.cu) B16_L128 "
          f"{k34_f32['k3'][0][0]:.4f} ({k34_f32['k3'][1][0]:.4f}; "
          f"{lib['K3_fp32'][0]:.4f}), B16_L173 "
          f"{k34_f32['k3_L173'][0][0]:.4f} "
          f"({k34_f32['k3_L173'][1][0]:.4f}; {lib['K3_fp32_L173'][0]:.4f}); "
          f"K4 (attention_f32_mma.cu) B16_L128 "
          f"{k34_f32['k4'][0][0]:.4f} ({k34_f32['k4'][1][0]:.4f}; "
          f"{lib['K4_fp32'][0]:.4f}), B16_L173 "
          f"{k34_f32['k4_L173'][0][0]:.4f} "
          f"({k34_f32['k4_L173'][1][0]:.4f}; {lib['K4_fp32_L173'][0]:.4f}), "
          f"by kernel at B16_L128 "
          f"{ {k[:48]: round(v, 5) for k, v in k34_f32['k4_split'].items()} } "
          f"({card})",
          flush=True)

    lap("6")
    # --- 7: VQA fine-tuning at full width; 8: fp32 step agreement ---
    root = tempfile.mkdtemp(prefix="vqa_fixture_")
    try:
        cfg7, overrides = vqa_train_config(root)
        print(f"[7 train] {VQA_CFG} with overrides "
              f"{json.dumps(overrides)}", flush=True)
        with checkpoint_writes_recorded() as saves7:
            model7, hist, launches7 = train_phase(cfg7)
        if [e for e, _ in saves7] != list(range(8)):
            raise AssertionError(f"train_net asked for checkpoints (epoch, "
                                 f"best) {saves7}, expected every epoch")
        steps = len(hist["loss"])
        p50 = step_p50(hist["step_ms"])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall_ms, busy_ms, top = profile_steps(model7, cfg7)
        print(f"[7 train] {steps} steps of batch 16, loss "
              f"{hist['loss'][0]:.2f} -> {hist['loss'][-1]:.2f} (first 4 "
              f"{sum(hist['loss'][:4]) / 4:.2f}, last 4 "
              f"{sum(hist['loss'][-4:]) / 4:.2f}); val SoftAcc "
              f"{[round(v['SoftAcc'], 4) for v in hist['val']]}; launches "
              f"{launches7} = per step K3 12, K4 12, K5 27 fwd / 26 "
              f"bwd, K2 12 per val batch; step p50 {p50:.2f} ms (CUDA "
              f"events, steps 3..{steps}), {16e3 / p50:.1f} samples/s; peak "
              f"device memory {peak:.2f} GiB; profiled window: wall "
              f"{wall_ms:.2f} ms/step unprofiled, device busy "
              f"{busy_ms:.2f} ms/step, idle share "
              f"{1 - busy_ms / wall_ms:.3f}; top device time ms/step "
              f"{[(k, round(v, 3)) for k, v in top]} ({card})", flush=True)
        del model7
        torch.cuda.empty_cache()
        # the same run with the writes the shipped config asks for: every
        # epoch, by the background writer; what they cost the steps
        cfg7w = cfg7.clone()
        cfg7w.OUTPUT_PATH = os.path.join(root, "out7w")
        _, hist_w, _ = train_phase(cfg7w)
        out7w = os.path.join(cfg7w.OUTPUT_PATH, "vqa_train")
        files7w = sorted(f for f in os.listdir(out7w) if f.endswith(".model"))
        shutil.rmtree(cfg7w.OUTPUT_PATH)
        if len(files7w) != 9:
            raise AssertionError(f"train_net wrote {files7w}, expected 8 "
                                 f"epochs and -best")
        p50_w = step_p50(hist_w["step_ms"])
        print(f"[7 train] the same run with the shipped config's checkpoint "
              f"writes (CHECKPOINT_FREQUENT 1, TPU.ASYNC_CHECKPOINT: a "
              f"background writer; {len(files7w)} files of base width): step "
              f"p50 {p50_w:.2f} ms against {p50:.2f} ms without writes "
              f"({p50_w / p50:.3f}x) and {wall_ms:.2f} ms in the tight loop; "
              f"median step ms by epoch with writes "
              f"{epoch_medians(hist_w['step_ms'])}, without "
              f"{epoch_medians(hist['step_ms'])}; loss {hist_w['loss'][0]:.2f}"
              f" -> {hist_w['loss'][-1]:.2f} ({card})", flush=True)
        agree = step_agreement(cfg7, dev)
        print(f"[8 step fp32] kernels vs plain versions, one step from the "
              f"same weights and seed: loss {agree['loss'][0]:.6f} vs "
              f"{agree['loss'][1]:.6f}, grad norm {agree['grad_norm'][0]:.6f} "
              f"vs {agree['grad_norm'][1]:.6f}, (rel err, rtol) "
              f"{agree['checks']}, worst of {agree['n_leaves']} gradient "
              f"leaves {agree['worst_leaf']}; launches kernels "
              f"{agree['launches'][0]}, plain {agree['launches'][1]}; max "
              f"abs param diff {agree['max_param_diff']:.3e} at lr "
              f"{agree['lr']:.3e}; a repeat of the kernel step is "
              f"bit-identical; the kernel step's attention device ms by "
              f"kernel "
              f"{ms_by_name(agree['attention_ms'])} "
              f"({card})", flush=True)

        lap("7-8")
        # --- 9: train -> checkpoint -> resume; 10: VQA server; 11: test ---
        cfg9, r9 = resume_phase(root, overrides)
        h1, h2 = r9["run1"], r9["run2"]
        n_val = -(-32 // cfg9.VAL.BATCH_IMAGES)
        prefix = cfg9.MODEL_PREFIX
        checks9 = {
            "warm start": r9["warm_start_ok"],
            "run 1": (h1["begin_epoch"], h1["resumed_count"],
                      len(h1["loss"])) == (0, 0, 8),
            "run 1 launches": r9["run1_launches"]
            == train_launches(8, 2 * n_val),
            "run 2": (h2["begin_epoch"], h2["resumed_count"],
                      len(h2["loss"])) == (2, 8, 4),
            "run 2 launches": r9["run2_launches"] == train_launches(4, n_val),
            "files": {f"{prefix}-{e:04d}.model" for e in range(3)}
            | {f"{prefix}-best.model"} <= set(r9["files"]),
            "finite": all(map(math.isfinite, h1["loss"] + h2["loss"]))}
        ms9 = [round(x, 2) for x in h1["step_ms"]]
        if not all(checks9.values()):
            raise AssertionError(f"train/checkpoint/resume: {checks9}; "
                                 f"{r9}")
        print(f"[9 resume] {VQA_CFG} with phase 7's overrides and "
              f"{json.dumps(r9['overrides'])}; PARTIAL_PRETRAIN a "
              f"reference-layout file ({r9['pretrain_mb']:.1f} MiB, module. "
              f"prefix, {PRETRAIN_HEAD}* for final_mlp.0.*, no answer head) "
              f"through the shipped prefix changes: {r9['from_file']} tensors "
              f"from the file, every one but final_mlp.2.* and each "
              f"unchanged, {r9['partial_pretrain_s']:.2f} s; run 1 epochs "
              f"0-1, {len(h1['loss'])} steps, loss {h1['loss'][0]:.2f} -> "
              f"{h1['loss'][-1]:.2f}, launches {r9['run1_launches']}, step "
              f"ms (CUDA events) of epoch 0 {ms9[:4]} and of epoch 1, while "
              f"epoch 0's checkpoint is written in the background, "
              f"{ms9[4:]}; run 2 "
              f"AUTO_RESUME to END_EPOCH 3: begin_epoch "
              f"{h2['begin_epoch']}, optimizer count {h2['resumed_count']} "
              f"restored, {len(h2['loss'])} steps, loss "
              f"{[round(x, 2) for x in h2['loss']]}, launches "
              f"{r9['run2_launches']}, {r9['run2_s']:.2f} s; files "
              f"{r9['files']}; base-width checkpoint {r9['file_mb']:.1f} MiB "
              f"(weights + AdamW moments): save {r9['save_s']:.2f} s "
              f"synchronous, {r9['save_blocking_s']:.2f} s blocking with the "
              f"writer ({r9['save_async_total_s']:.2f} s to written), load "
              f"{r9['load_s']:.2f} s to the card ({card})", flush=True)

        r10 = vqa_serve_phase(cfg9, r9["best"])
        per_query = {"K1": 0, "K1b": 0, "K2": 12, "K3": 0, "K4": 0,
                     "K5_fwd": 0, "K5_bwd": 0}
        if not (all(c == per_query for c in r10["per_query"])
                and r10["fp32_launches"] == per_query
                and r10["fp32_finite"] and r10["fp32_err"] <= E2E_ATOL
                and r10["fp32_argmax"][0] == r10["fp32_argmax"][1]):
            raise AssertionError(f"VQA server: {r10}")
        vqa_lat = r10["lat"]
        print(f"[10 serve VQA] {r9['best']} in VQAServer, bucket 64 text + "
              f"108 boxes (L = {r10['L']}), bf16, 8 distinct questions "
              f"answered {r10['answers']}; launches per query "
              f"{per_query} on each; latency p50 {vqa_lat['p50_ms']:.2f} ms, "
              f"p90 {vqa_lat['p90_ms']:.2f} ms over n={vqa_lat['n']}; fp32 "
              f"kernels (K2 {r10['fp32_launches']['K2']} launches) vs plain "
              f"versions on one query: max abs logit err "
              f"{r10['fp32_err']:.3e} (atol {E2E_ATOL}), argmax "
              f"{r10['fp32_argmax'][0]} on both ({card})", flush=True)

        r11v = vqa_test_phase(cfg9, r9["best"], root)
        want_v = dict(per_query, K2=12 * r11v["batches"])
        if not (r11v["ok"] and r11v["launches"] == want_v):
            raise AssertionError(f"test_net_vqa: launches "
                                 f"{r11v['launches']} (want {want_v}), "
                                 f"rows ok {r11v['ok']}")
        r11r = refcoco_test_phase(root, cfg9.NETWORK.BERT_MODEL_NAME)
        want_r = dict(per_query, K1=16 // r11r["batch"],
                      K2=12 * 16 // r11r["batch"])
        fp32_batch = dict(per_query, K1=1, K2=12)
        if not (r11r["rc"] == 0 and r11r["loaded_all"]
                and r11r["launches"] == want_r and r11r["n_rows"] == 16
                and r11r["fp32_launches"] == fp32_batch
                and r11r["finite"] and r11r["fp32_boxes_equal"]
                and r11r["fp32_logit_err"] <= E2E_ATOL):
            raise AssertionError(f"test_net_refcoco: {r11r} (launches want "
                                 f"{want_r})")
        print(f"[11 test drivers] test_net_vqa from {r9['best']}: "
              f"{len(r11v['rows'])} answers rows, batch "
              f"{cfg9.TEST.BATCH_IMAGES}, launches {r11v['launches']}, "
              f"{r11v['wall_s']:.2f} s end to end, inference loop "
              f"{r11v['n'] / r11v['loop_s']:.1f} samples/s "
              f"({r11v['n']} in {r11v['loop_s']:.3f} s); python -m "
              f"vlbert_tpu_torch.engine.test --task refcoco --split val from "
              f"{CFG} on 16 synthetic expressions, a reference-layout .model "
              f"(module. + vlbert._module.) by --ckpt, every tensor loaded: "
              f"{r11r['n_rows']} pred-box rows, IoU@0.5 accuracy "
              f"{r11r['acc']:.4f} (random weights), batch {r11r['batch']}, "
              f"{r11r['slots']} box slots, L = {r11r['L']}, launches "
              f"{r11r['launches']}, {r11r['wall_s']:.2f} s end to end, "
              f"inference loop {r11r['n'] / r11r['loop_s']:.1f} samples/s "
              f"({r11r['n']} in {r11r['loop_s']:.3f} s); fp32 kernels "
              f"(launches {r11r['fp32_launches']}) vs "
              f"plain versions on one batch: identical predicted boxes, max "
              f"abs logit err {r11r['fp32_logit_err']:.3e} (atol {E2E_ATOL}) "
              f"({card})",
              flush=True)

        lap("9-11")
        # --- 12: VCR inference at full width ---
        r12 = vcr_phase(root, cfg9.NETWORK.BERT_MODEL_NAME)
        none = dict.fromkeys(("K1b", "K3", "K4", "K5_fwd", "K5_bwd"), 0)
        n_b = r12["n"] // r12["batch"]
        want12 = {"Q2A_val": dict(none, K1=n_b, K2=12 * n_b),
                  "Q2A_test": dict(none, K1=n_b, K2=12 * n_b),
                  "QA2R_test": dict(none, K1=4 * n_b, K2=48 * n_b),
                  "vcr_val": dict(none, K1=2 * n_b, K2=24 * n_b),
                  "Q2AR_val": dict(none, K1=n_b, K2=24 * n_b)}
        runs12 = r12["runs"]
        checks12 = {
            "launches": {k: v["launches"] for k, v in runs12.items()}
            == want12,
            "loaded_all": r12["loaded_all"],
            "csv": all(runs12[k]["rc"] == 0 and runs12[k]["rows"] == r12["n"]
                       and runs12[k]["ids_ok"] and runs12[k]["probs_ok"]
                       and runs12[k]["head_ok"]
                       and runs12[k]["columns"] == (16 if k == "QA2R_test"
                                                    else 4)
                       for k in ("Q2A_val", "Q2A_test", "QA2R_test")),
            "merged": r12["merged"]["ok"],
            "vcr_val": all(0 <= x <= 1 for x in r12["vcr_val"])
            and r12["vcr_val"][2] <= min(r12["vcr_val"][:2]),
            "q2ar": set(r12["q2ar"]) >= {"Acc", "RationaleAcc", "JointAcc"}
            and r12["q2ar"]["JointAcc"] <= min(r12["q2ar"]["Acc"],
                                               r12["q2ar"]["RationaleAcc"]),
            "fp32": r12["fp32"]["finite"] and r12["fp32"]["argmax_equal"]
            and r12["fp32"]["launches"] == dict(none, K1=1, K2=12)
            and r12["fp32"]["err"] <= E2E_ATOL
            and r12["fp32"]["shape"] == (r12["batch"], 4)}
        if not all(checks12.values()):
            raise AssertionError(f"VCR: {checks12}; {r12} (launches want "
                                 f"{want12})")
        loops12 = {k: runs12[k] for k in ("Q2A_val", "QA2R_test")}
        print(f"[12 VCR] {VCR_CFGS['Q2A']} and its QA2R twin at full width "
              f"(ResNet-101 C4, dilated conv5, 14x14 ROIAlign and instance "
              f"masks, VL-BERT 768 x 12 x 12, {r12['n_params'] / 1e6:.1f}M "
              f"params), bf16, on a synthetic split of {r12['n']} questions "
              f"over 8 JPEGs (4 landscape, 4 portrait; 3-107 boxes and "
              f"polygon segms each), 4 answers and 4 rationales a question, "
              f"from a reference-layout .model of seed-0 weights "
              f"({r12['ckpt_mb']:.1f} MiB, every tensor loaded); batch "
              f"{r12['batch']} x 4 choices = 16 sequences, {r12['slots']} "
              f"box slots, L = {r12['L']}; python -m vlbert_tpu_torch.engine."
              f"test --task vcr: Q2A val and test {runs12['Q2A_val']['rows']} "
              f"rows x {runs12['Q2A_val']['columns']} answer_k columns, QA2R "
              f"test answer-conditioned {runs12['QA2R_test']['columns']} "
              f"columns, merge_vcr_results {r12['merged']['rows']} rows x "
              f"{r12['merged']['columns']}; vcr_val Q->A / QA->R / Q->AR "
              f"{[round(x, 4) for x in r12['vcr_val']]}; Q2AR "
              f"make_validation_fn "
              f"{ {k: round(v, 4) for k, v in r12['q2ar'].items()} } "
              f"(random weights); launches "
              f"{ {k: (v['launches']['K1'], v['launches']['K2']) for k, v in runs12.items()} } "
              f"(K1, K2; no K3-K5), wall s "
              f"{ {k: round(v['wall_s'], 2) for k, v in runs12.items()} }; "
              f"warm inference loop "
              + "; ".join(f"{k} {v['samples_per_s']:.1f} samples/s ({r12['n']}"
                          f" in {v['loop_s']:.3f} s, device busy "
                          f"{v['busy_s']:.3f} s, idle share {v['idle']:.3f})"
                          for k, v in loops12.items())
              + f"; fp32 kernels (K1 1, K2 12 launches) vs plain versions on "
              f"one Q2A batch: max abs "
              f"logit err {r12['fp32']['err']:.3e} (atol {E2E_ATOL}), the same "
              f"argmax for each question (smallest top-2 margin "
              f"{r12['fp32']['min_margin']:.3e}) ({card})", flush=True)

        lap("12")
        # --- 13: training from pixels: K1b, then VCR and RefCOCO+ ---
        k1b_errs = k1b_parity(dev)
        k1b_t = k1b_times(dev)
        k1b_lib = k1b_library(dev)
        k1b_lib_rc = k1b_library(dev, "refcoco")
        k1b_lib_pt = k1b_library(dev, "pretrain")
        k1b_lib_all = k1b_library(dev, "vcr_all_live")
        worst_k1b = max(k1b_errs, key=k1b_errs.get)
        print(f"[13 parity K1b roi_align backward] {len(k1b_errs)} cases "
              f"(case/g->dF/sampling ratio, the K1 cases; padded slots' g "
              f"1e6) against roi_align_bwd_plain: largest error "
              f"{k1b_errs[worst_k1b]:.3e} of the case's largest |dF| "
              f"({worst_k1b}; fp32 within {K1B_RTOL}, bf16 within one bf16 "
              f"step more), every repeat bit-identical; bf16 g "
              f"[4,108,14,14,1024] and dF at VCR's training shape "
              f"[4,38,75,1024], RefCOCO+'s [4,38,63,1024] and "
              f"pretraining's (g [8,108,...], dF [8,63,63,1024]) (live "
              f"{list(K1B_REFCOCO_LIVE)}), sampling 1, device ms by kernel "
              f"(call ms): "
              + "; ".join(f"{k} {t['ms']:.4f} ({t['call_ms']:.4f}), "
                          f"{t['live']} live slots, bound "
                          f"{t['bound'][0]:.4f} ({t['bound'][1]})"
                          for k, t in k1b_t.items() if k in K1B_TIMED)
              + f"; plain {k1b_t['plain'][0]:.4f} ({k1b_t['plain'][1]:.4f}); "
              f"library: the backward of F.grid_sample over the bin centres "
              f"({k1b_lib[2]}) {k1b_lib[0]:.4f} ms "
              f"({', '.join(n[:48] for n in k1b_lib[1])}), fp32 max abs err "
              f"{k1b_lib[3]:.2e} against the plain dF on the boxes inside "
              f"the map; with all 432 slots live {k1b_lib_all[0]:.4f} ms "
              f"({k1b_lib_all[2]}); at RefCOCO+'s {k1b_lib_rc[0]:.4f} ms; at "
              f"pretraining's {k1b_lib_pt[0]:.4f} ms ({k1b_lib_pt[2]}), "
              f"plain there {k1b_t['plain_pretrain'][0]:.4f} ms ({card})",
              flush=True)
        root13 = os.path.join(root, "p13")
        os.makedirs(root13)
        vocab13 = cfg9.NETWORK.BERT_MODEL_NAME
        r13 = vcr_train_phase(root13, vocab13)
        if not all(r13["checks"].values()):
            raise AssertionError(f"VCR training: {r13['checks']}; {r13}")
        p50_13 = step_p50(r13["step_ms"])
        wall13, busy13, top13 = r13["profile"]
        agree13 = r13["fp32"]
        step_samples = r13["accum"] * r13["micro"]
        print(f"[13 train VCR] python -m vlbert_tpu_torch.engine.train "
              f"--task vcr from {VCR_CFGS['Q2A']} at full width (ResNet-101 "
              f"C4, dilated conv5, VL-BERT 768 x 12 x 12, "
              f"{r13['n_params'] / 1e6:.1f}M params, bf16, SGD) with "
              f"overrides {json.dumps(r13['overrides'])}, on "
              f"{VCR_TRAIN_QUESTIONS} synthetic questions over phase 12's 8 "
              f"JPEGs: {len(r13['loss'])} optimizer steps of "
              f"{r13['accum']} micro-steps x {r13['micro']} images x 4 "
              f"choices, loss {[round(x, 4) for x in r13['loss']]}; val Acc "
              f"{r13['val_acc']} (random weights); launches per step "
              f"{r13['want_step']} and per validation run "
              f"{r13['want_val']}, on every one, total {r13['total']}; files "
              f"{r13['files']}; AUTO_RESUME: begin_epoch "
              f"{r13['resume']['begin_epoch']}, optimizer count "
              f"{r13['resume']['count']}, {r13['resume']['steps']} steps; "
              f"step p50 {p50_13:.2f} ms (CUDA events, steps "
              f"3..{len(r13['loss'])}), {step_samples * 1e3 / p50_13:.1f} "
              f"samples/s; {r13['samples']} samples in {r13['wall_s']:.2f} "
              f"s of main (setup, loader, validation and checkpoint writes "
              f"included); peak device memory {r13['peak_gib']:.2f} GiB; "
              f"profiled window (fixed batch): wall {wall13:.2f} ms/step "
              f"unprofiled, device busy {busy13:.2f} ms/step, idle share "
              f"{1 - busy13 / wall13:.3f}; top device time ms/step "
              f"{[(k, round(v, 3)) for k, v in top13]} ({card})", flush=True)
        print(f"[13 step fp32 VCR] kernels vs plain versions (plain Philox, "
              f"plain ROIAlign and its autograd dF), one optimizer step of "
              f"{r13['accum']} micro-steps from the same weights and seed: "
              f"loss {agree13['loss'][0]:.6f} vs {agree13['loss'][1]:.6f}, "
              f"grad norm {agree13['grad_norm'][0]:.6f} vs "
              f"{agree13['grad_norm'][1]:.6f}, (rel err, rtol) "
              f"{agree13['checks']}, worst of {agree13['n_leaves']} leaves "
              f"{agree13['worst_leaf']}, worst by group "
              f"{ {k: f'{v:.2e}' for k, v in agree13['by_group'].items()} }; "
              f"launches kernels {agree13['launches'][0]}, plain "
              f"{agree13['launches'][1]}; a repeat of the kernel step is "
              f"bit-identical; the kernel step's attention device ms by "
              f"kernel "
              f"{ms_by_name(agree13['attention_ms'])} "
              f"({card})", flush=True)
        r13r = refcoco_train_phase(root13, vocab13)
        if not all(r13r["checks"].values()):
            raise AssertionError(f"RefCOCO+ training: {r13r['checks']}; "
                                 f"{r13r}")
        p50_13r = step_p50(r13r["step_ms"])
        print(f"[13 train RefCOCO+] python -m vlbert_tpu_torch.engine.train "
              f"--task refcoco from {CFG} at full width (bf16, AdamW, "
              f"triangle) with overrides {json.dumps(r13r['overrides'])}, "
              f"on phase 11's 16 expressions: {len(r13r['loss'])} optimizer "
              f"steps of {r13r['accum']} x {r13r['micro']} images, loss "
              f"{[round(x, 4) for x in r13r['loss']]}; val RefAcc "
              f"{r13r['ref_acc']} (random weights); launches per step "
              f"{r13r['want_step']} and per validation run "
              f"{r13r['want_val']}, on every one; checkpoint writes recorded "
              f"{r13r['saves']}; step p50 {p50_13r:.2f} ms (steps "
              f"3..{len(r13r['loss'])}), peak device memory "
              f"{r13r['peak_gib']:.2f} GiB, {r13r['wall_s']:.2f} s of main "
              f"({card})", flush=True)
        lap("13")
        root14 = os.path.join(root, "p14")
        os.makedirs(root14)
        r14 = pretrain_phase(root14, vocab13)
        if not all(r14["checks"].values()):
            raise AssertionError(f"pretraining: {r14['checks']}; {r14}")
        p50_14 = step_p50(r14["step_ms"])
        wall14, busy14, top14 = r14["profile"]
        agree14 = r14["fp32"]
        print(f"[14 train pretrain] python -m vlbert_tpu_torch.engine.train "
              f"--task pretrain from {PRETRAIN_CFGS['e2e']} at full width "
              f"(ResNet-101 C4, dilated conv5, VL-BERT 768 x 12 x 12, MLM "
              f"over 30522 words, MVRC over {CC_CLASSES} classes, "
              f"{r14['n_params'] / 1e6:.1f}M params, bf16, AdamW) with "
              f"overrides {json.dumps(r14['overrides'])}, on "
              f"{PRETRAIN_IMAGES} synthetic captioned JPEGs and a text "
              f"corpus: {len(r14['loss'])} optimizer steps of "
              f"{r14['micro'][0]} caption + {r14['micro'][1]} corpus rows "
              f"(L = 64 + 108 + 1), loss "
              f"{[round(x, 4) for x in r14['loss']]}; per epoch "
              f"{[{k: round(v, 4) for k, v in sorted(e.items())} for e in r14['train']]}; "
              f"launches per step {r14['want_step']} on every one, total "
              f"{r14['total']}; no validation; files {r14['files']} "
              f"(reference layout, the tied decoder stored once); "
              f"AUTO_RESUME: begin_epoch {r14['resume']['begin_epoch']}, "
              f"optimizer count {r14['resume']['count']}, "
              f"{r14['resume']['steps']} steps; step p50 {p50_14:.2f} ms "
              f"(CUDA events, steps 3..{len(r14['loss'])}), "
              f"{r14['micro'][0] * 1e3 / p50_14:.1f} images/s; "
              f"{r14['samples']} rows in {r14['wall_s']:.2f} s of main "
              f"(setup, loader and checkpoint writes included); peak device "
              f"memory {r14['peak_gib']:.2f} GiB; profiled window (fixed "
              f"batch): wall {wall14:.2f} ms/step unprofiled, device busy "
              f"{busy14:.2f} ms/step, idle share {1 - busy14 / wall14:.3f}; "
              f"top device time ms/step "
              f"{[(k, round(v, 3)) for k, v in top14]} ({card})", flush=True)
        e2e14 = r14["fp32_e2e"]
        print(f"[14 step fp32 pretrain from pixels] {PRETRAIN_CFGS['e2e']} "
              f"in fp32 on its loader's first batch (image "
              f"{list(r14['fp32_e2e_image'])}, {r14['fp32_e2e_rows'][0]} "
              f"caption + {r14['fp32_e2e_rows'][1]} corpus rows): kernels "
              f"vs plain versions (plain ROIAlign under autograd, plain "
              f"Philox), one optimizer step from the same weights and seed: "
              f"loss {e2e14['loss'][0]:.6f} vs {e2e14['loss'][1]:.6f}, grad "
              f"norm {e2e14['grad_norm'][0]:.6f} vs "
              f"{e2e14['grad_norm'][1]:.6f}, (rel err, rtol) "
              f"{e2e14['checks']}, worst of {e2e14['n_leaves']} leaves "
              f"{e2e14['worst_leaf']}, the parameter moved furthest apart "
              f"{e2e14['furthest_param']}, worst by group "
              f"{ {k: f'{v:.2e}' for k, v in e2e14['by_group'].items()} }; "
              f"launches kernels {e2e14['launches'][0]}, plain "
              f"{e2e14['launches'][1]}; a repeat of the kernel step is "
              f"bit-identical; attention device ms by kernel "
              f"{ms_by_name(e2e14['attention_ms'])} ({card})", flush=True)
        print(f"[14 step fp32 pretrain] {PRETRAIN_CFGS['prec']} "
              f"(precomputed features, {r14['fp32_rows'][0]} caption + "
              f"{r14['fp32_rows'][1]} corpus rows): kernels vs plain "
              f"versions (plain Philox), one optimizer step from the same "
              f"weights and seed: loss {agree14['loss'][0]:.6f} vs "
              f"{agree14['loss'][1]:.6f}, grad norm "
              f"{agree14['grad_norm'][0]:.6f} vs {agree14['grad_norm'][1]:.6f}, "
              f"(rel err, rtol) {agree14['checks']}, worst of "
              f"{agree14['n_leaves']} leaves {agree14['worst_leaf']}, worst "
              f"by group "
              f"{ {k: f'{v:.2e}' for k, v in agree14['by_group'].items()} }; "
              f"launches kernels {agree14['launches'][0]}, plain "
              f"{agree14['launches'][1]}; a repeat of the kernel step is "
              f"bit-identical; attention device ms by kernel "
              f"{ms_by_name(agree14['attention_ms'])} ({card})", flush=True)
        lap("14")
        # --- 15: VL-BERT-large (24 layers x 1024 x 16 heads) ---
        lk_errs, lk_t = large_kernel_parity(dev)
        B15, L15, H15 = LARGE_ATTN
        print(f"[15 parity H=16] K2, K3 (bits, Philox), K4 at B={B15} "
              f"L={L15} H={H15} D=64 (7 padded keys, one all-masked batch "
              f"row) and K5 at [{B15},{L15},{H15 * 64}], fp32 and bf16, "
              f"against their plain versions: "
              f"{ {k: f'{v:.2e}' for k, v in lk_errs.items()} } (K2/K3 atol "
              f"{K2_ATOL}, K4 rtol {BWD_RTOL}, K5 exact); K3/K4 keep masks "
              f"at 16 heads (B=16 L=128) read back bit for bit in both "
              f"dtypes; ms kernel by name (call ms) / plain (CUDA events, "
              f"a call) / library by name (SDPA, its backward, F.dropout): "
              + "; ".join(f"{name} {dn} {t[0][0]:.4f} ({t[0][1]:.4f}) / "
                          f"{t[1]:.4f} / {t[2][0]:.4f}"
                          for dn, ts in lk_t.items()
                          for name, t in sorted(ts.items()))
              + f" ({card})", flush=True)
        root15 = os.path.join(root, "p15")
        os.makedirs(root15)
        r15 = vcr_large_phase(root15, vocab13)
        if not all(r15["checks"].values()):
            raise AssertionError(f"VCR-large: {r15['checks']}; {r15}")
        p50_15 = step_p50(r15["step_ms"])
        wall15, busy15, top15 = r15["profile"]
        print(f"[15a train VCR-large] python -m vlbert_tpu_torch.engine.train "
              f"--task vcr from {LARGE_CFGS['vcr']} at full width "
              f"(ResNet-101 C4, dilated conv5, VL-BERT 1024 x 24 x 16, "
              f"{r15['n_params'] / 1e6:.1f}M params, TRAIN.FP16 -> bf16, SGD) "
              f"with overrides {json.dumps(r15['overrides'])}, on phase 13's "
              f"{VCR_TRAIN_QUESTIONS} synthetic questions: "
              f"{len(r15['loss'])} optimizer steps of {r15['accum']} "
              f"micro-steps x {r15['micro']} images x 4 choices, loss "
              f"{[round(x, 4) for x in r15['loss']]}; val Acc "
              f"{r15['val_acc']} (random weights); launches per step "
              f"{r15['want_step']} and per validation run "
              f"{r15['want_val']}, on every one, total {r15['total']}; "
              f"checkpoint writes recorded {r15['saves']}; step p50 "
              f"{p50_15:.2f} ms (CUDA events, steps 3..{len(r15['loss'])}), "
              f"{r15['accum'] * r15['micro'] * 1e3 / p50_15:.1f} samples/s; "
              f"{r15['wall_s']:.2f} s of main; peak device memory "
              f"{r15['peak_gib']:.2f} GiB; profiled window (fixed batch): "
              f"wall {wall15:.2f} ms/step unprofiled, device busy "
              f"{busy15:.2f} ms/step, idle share {1 - busy15 / wall15:.3f}; "
              f"top device time ms/step "
              f"{[(k, round(v, 3)) for k, v in top15]} ({card})", flush=True)
        rm = r15["remat"]
        print(f"[15b REMAT VCR-large] one optimizer step on 15a's first "
              f"batch from the same seed-0 weights and seed, TPU.REMAT off "
              f"vs on (each encoder layer checkpointed, its dropout seeds "
              f"replayed in the recompute): loss {rm[False]['loss']:.6f} "
              f"vs {rm[True]['loss']:.6f}; {rm['bit_identical_leaves']} of "
              f"{rm['n_leaves']} gradient leaves bit-identical, worst "
              f"{rm['worst_leaf']} {rm['worst_gap']:.3e} of its largest "
              f"|element| (tolerance {REMAT_LEAF_RTOL}); launches off "
              f"{rm[False]['launches']}, on {rm[True]['launches']} (want "
              f"{r15['remat_want']}); peak device memory "
              f"{rm[False]['peak_gib']:.2f} -> {rm[True]['peak_gib']:.2f} "
              f"GiB ({rm[False]['resident_gib']:.2f} and "
              f"{rm[True]['resident_gib']:.2f} held before the step); step ms (CUDA events, the 2 steps after it) off "
              f"{[round(x, 2) for x in rm[False]['step_ms']]}, on "
              f"{[round(x, 2) for x in rm[True]['step_ms']]}; device busy "
              f"ms of a step (profiler) off {rm[False]['busy_ms']:.2f}, on "
              f"{rm[True]['busy_ms']:.2f}; phase 15a-c seconds "
              f"{ {k: round(v, 1) for k, v in r15['seconds'].items()} } "
              f"({card})", flush=True)
        b16 = r15["b16"]
        print(f"[15c B=16 VCR-large] {LARGE_CFGS['vcr_b16']} with 15a's "
              f"overrides: one optimizer step of its shipped batch, "
              f"{b16['images']} images x 4 choices = {b16['rows']} encoder "
              f"rows, canvas {list(b16['canvas'])}, bf16, SGD: TPU.REMAT "
              f"off {b16[False]}, on {b16[True]} ({card})", flush=True)
        r15d = vqa_large_fp32_phase(root15)
        print(f"[15d step fp32 VQA-large] {LARGE_CFGS['vqa']} (precomputed "
              f"features, {r15d['accum']} micro-steps of {r15d['micro']}, "
              f"L = {r15d['L']}) on phase 7's synthetic set: kernels vs "
              f"plain versions (plain Philox), one optimizer step from the "
              f"same weights and seed: loss {r15d['loss'][0]:.6f} vs "
              f"{r15d['loss'][1]:.6f}, grad norm "
              f"{r15d['grad_norm'][0]:.6f} vs {r15d['grad_norm'][1]:.6f}, "
              f"(rel err, rtol) {r15d['checks']}, worst of "
              f"{r15d['n_leaves']} leaves {r15d['worst_leaf']}, worst by "
              f"group "
              f"{ {k: f'{v:.2e}' for k, v in r15d['by_group'].items()} }; "
              f"launches kernels {r15d['launches'][0]}, plain "
              f"{r15d['launches'][1]}; a repeat of the kernel step is "
              f"bit-identical; attention device ms by kernel "
              f"{ms_by_name(r15d['attention_ms'])} ({card})", flush=True)
        r15e = refcoco_large_serve_phase()
        lat15 = r15e["lat"]
        print(f"[15e serve RefCOCO+-large] {LARGE_CFGS['refcoco']} in "
              f"RefCOCOServer, ResNet-101 + VL-BERT 1024 x 24 x 16, "
              f"{r15e['n_params'] / 1e6:.1f}M params, bf16, phase 4's 8 "
              f"queries ok (launches {r15e['launches']}: K1 1, K2 24 a "
              f"query); latency p50 {lat15['p50_ms']:.2f} ms, p90 "
              f"{lat15['p90_ms']:.2f} ms over n={lat15['n']}; peak device "
              f"memory {r15e['peak_gib']:.2f} GiB ({card})", flush=True)
        lap("15")
        # --- 16: data parallelism over torch.distributed ---
        root16 = os.path.join(root, "p16")
        os.makedirs(root16)
        r16 = dist_phase(root16, root14, vocab13)
        # the lines first: a failed check's readings stay in the output
        print_dist_phase(r16, card)
        if not all(r16["checks"].values()):
            raise AssertionError(f"data parallelism: {r16['checks']}; "
                                 f"{ {k: r16[k] for k in ('b_val_one', 'c_one', 'e32_one', 'f32_one', 'seconds')} }")

        lap("16")
        # --- 17-18: int8 serving, the attention dump, ResNet-18 ---
        r17a, r17b, r18a, r18b = int8_and_vis_phases(
            cfg, model, queries, cfg9, r9["best"], root, vocab13, card)

        lap("17-18")
        # --- 19: float16 training ---
        del model
        torch.cuda.empty_cache()
        t19 = time.perf_counter()
        f16_errs, f16_t = fp16_kernel_parity(dev)
        print_fp16_parity(f16_errs, f16_t, card)
        s19a = time.perf_counter() - t19
        r19 = vcr_large_fp16_phase(root15, vocab13, r15["data_dir"], cfg7)
        if not all(r19["checks"].values()):
            shown = ("dynamic", "dtypes", "finite", "steps", "val", "maxima")
            raise AssertionError(f"float16 training: {r19['checks']}; "
                                 f"{ {k: r19[k] for k in shown} }")
        print_fp16_train(r19, r15, card,
                         {"19a": s19a, "19": time.perf_counter() - t19})
        lap("19")
        # --- 20: the JAX package's checkpoints; the last host modules ---
        r20 = jax_resume_phase(root, cfg9, r9, r11v)
        r20d = host_natives_phase(root, t_wall)
        print_jax_phase(r20, r20d, card)
        failed20 = {k: v for part in ("checks_a", "checks_b", "checks_c")
                    for k, v in r20[part].items() if not v}
        failed20.update({k: v for k, v in r20d["checks"].items() if not v})
        if failed20:
            raise AssertionError(f"JAX checkpoints / host modules: "
                                 f"{failed20}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def philox_floor_ms(evaluations, instructions):
        return evaluations * instructions / int_rate * 1e3

    B, L, H, D = 16, 128, 12, 64
    n_drop = 16 * 128 * 768            # K5's timed [16,128,768] tensor
    k1_bf16 = k1_bound(1, 38, 63, 1024, 16, 2, 2)
    k1_fp32 = k1_bound(1, 38, 63, 1024, 16, 2, 4)
    k1_note = (f"one F.grid_sample (bilinear, border, align_corners) over "
               f"the 14x14 bin centres, {k1_lib[2]}, the mask multiply left "
               f"out; fp32 max abs err {k1_lib[3]:.2e} against the plain "
               f"ROIAlign on the {k1_lib[4]} live boxes inside the map")
    k1_main, k1_f32, k1_old = (k1_t[k] for k in ("bf16_out", "fp32_out",
                                                  "old_route"))

    def k2_fp32(B_, L_, lib_key):
        """The fp32 K2 at one timed shape, beside SDPA fp32."""
        kern, plain = k2_ms[f"B{B_}_L{L_}_fp32"]
        return {"ms": kern[0], "plain_ms": plain[0],
                **dict(zip(("bound_ms", "bound_by"),
                           attention_bound(B_, L_, H, D, "float32"))),
                "library_ms": lib[lib_key][0],
                "library_kernels": lib[lib_key][1], "call_ms": kern[1],
                "plain_call_ms": plain[1]}

    def k34_at_173(key, lib_key, philox_key, backward=False):
        """bf16 K3 or K4 at VCR's training shape, B=16 L=173, beside SDPA
        (with its backward for K4)."""
        kern, plain = k34_173[key]
        return {"ms": kern[0], "plain_ms": plain[0],
                **dict(zip(("bound_ms", "bound_by"),
                           attention_bound(16, 173, H, D, "bfloat16",
                                           backward=backward))),
                "philox_floor_ms": philox_floor_ms(
                    PHILOX_PER_CALL[philox_key](16, H, 173), philox4_instr),
                "library_ms": lib[lib_key][0],
                "library_kernels": lib[lib_key][1], "call_ms": kern[1],
                "plain_call_ms": plain[1]}

    # launches of the fp32 K2 and K4 on the fp32 paths: one query or
    # model pass (phases 5, 10-12), one optimizer step (phases 8, 13)
    k2_fp32_launches = {
        "phase5_refcoco_query": launches5["K2"],
        "phase10_vqa_query": r10["fp32_launches"]["K2"],
        "phase11_refcoco_test_batch": r11r["fp32_launches"]["K2"],
        "phase12_vcr_q2a_batch": r12["fp32"]["launches"]["K2"]}
    k4_fp32_launches = {"phase8_vqa_step": agree["launches"][0]["K4"],
                        "phase13_vcr_step": agree13["launches"][0]["K4"],
                        "phase14_pretrain_step":
                            agree14["launches"][0]["K4"],
                        "phase14_pretrain_e2e_step":
                            e2e14["launches"][0]["K4"]}
    kernels = [
        {"name": "roi_align_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/roi_align.cu",
         "replaces": "vlbert_tpu/ops/roi_align.py:125",
         "launches": launches["roi_align"],
         "max_abs_err": k1_fp32_err, "bf16_out_max_abs_err": k1_bf16_err,
         "out_dtype": "bfloat16", "ms": k1_main["ms"],
         "plain_ms": k1_t["plain"][0], "bound_ms": k1_bf16[0],
         "bound_by": k1_bf16[1], "library_ms": k1_lib[0],
         "library_kernels": k1_lib[1], "library_note": k1_note,
         "call_ms": k1_main["call_ms"],
         "kernels_per_call": k1_main["kernels_per_call"],
         "plain_call_ms": k1_t["plain"][1],
         "fp32_out": {"ms": k1_f32["ms"], "call_ms": k1_f32["call_ms"],
                      "kernels_per_call": k1_f32["kernels_per_call"],
                      "bound_ms": k1_fp32[0], "bound_by": k1_fp32[1]},
         "replaced_route": {
             "ms": k1_old["route_ms"], "call_ms": k1_old["call_ms"],
             "kernels_per_call": k1_old["kernels_per_call"],
             "by_kernel": k1_old["by_kernel"],
             "note": "the three ops the main path ran before this K1 "
                     "stored the compute dtype (bool mask to uint8, fp32-out "
                     "K1, cast to bf16), timed in this run with this K1"},
         "launches_vcr": {k: v["launches"]["K1"]
                          for k, v in r12["runs"].items()},
         "launches_train": {"vcr": r13["total"]["K1"],
                            "refcoco": r13r["total"]["K1"],
                            "pretrain": r14["total"]["K1"]}},
        {"name": "roi_align_bwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/roi_align_bwd.cu",
         "replaces": "vlbert_tpu/ops/roi_align.py:186",
         "launches": r13["total"]["K1b"],
         "launches_refcoco": r13r["total"]["K1b"],
         "launches_pretrain": r14["total"]["K1b"],
         "max_abs_err": max(k1b_errs.values()),
         "err_is_relative_to": "max(1, max |plain dF|) of each case",
         "ms": k1b_t["vcr"]["ms"], "plain_ms": k1b_t["plain"][0],
         "bound_ms": k1b_t["vcr"]["bound"][0],
         "bound_by": k1b_t["vcr"]["bound"][1], "library_ms": k1b_lib[0],
         "library_kernels": k1b_lib[1],
         "library_note": f"the backward of one F.grid_sample (bilinear, "
                         f"border, align_corners) over the 14x14 bin "
                         f"centres, {k1b_lib[2]}; fp32 max abs err "
                         f"{k1b_lib[3]:.2e} against the plain dF on the "
                         f"boxes inside the map",
         "call_ms": k1b_t["vcr"]["call_ms"],
         "plain_call_ms": k1b_t["plain"][1],
         "shape": "g [4,108,14,14,1024] bf16 (live slots "
                  f"{k1b_t['vcr']['live']}), dF [4,38,75,1024] bf16",
         "all_live": {"ms": k1b_t["vcr_all_live"]["ms"],
                      "bound_ms": k1b_t["vcr_all_live"]["bound"][0],
                      "bound_by": k1b_t["vcr_all_live"]["bound"][1],
                      "library_ms": k1b_lib_all[0],
                      "library_kernels": k1b_lib_all[1]},
         "refcoco": {"shape": "g [4,108,14,14,1024] bf16 (live slots "
                              f"{k1b_t['refcoco']['live']}), dF "
                              "[4,38,63,1024] bf16",
                     "ms": k1b_t["refcoco"]["ms"],
                     "call_ms": k1b_t["refcoco"]["call_ms"],
                     "bound_ms": k1b_t["refcoco"]["bound"][0],
                     "bound_by": k1b_t["refcoco"]["bound"][1],
                     "library_ms": k1b_lib_rc[0],
                     "library_kernels": k1b_lib_rc[1]},
         "pretrain": {"shape": "g [8,108,14,14,1024] bf16 (live slots "
                               f"{k1b_t['pretrain']['live']}), dF "
                               "[8,63,63,1024] bf16",
                      "ms": k1b_t["pretrain"]["ms"],
                      "call_ms": k1b_t["pretrain"]["call_ms"],
                      "bound_ms": k1b_t["pretrain"]["bound"][0],
                      "bound_by": k1b_t["pretrain"]["bound"][1],
                      "plain_ms": k1b_t["plain_pretrain"][0],
                      "library_ms": k1b_lib_pt[0],
                      "library_kernels": k1b_lib_pt[1]}},
        {"name": "attention_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention_dropout_mma.cu",
         "fp32_source": "vlbert_tpu_torch/csrc/attention_f32_mma.cu",
         "replaces": "vlbert_tpu/ops/attention.py:127",
         "launches": launches["fused_attention"],
         "max_abs_err": max(k2_errs.values()), "ms": k2_ms["B1_L41"][0][0],
         "plain_ms": k2_ms["B1_L41"][1][0],
         **dict(zip(("bound_ms", "bound_by"),
                    attention_bound(1, 41, H, D, "bfloat16"))),
         "library_ms": lib["K2_L41"][0], "library_kernels": lib["K2_L41"][1],
         "call_ms": k2_ms["B1_L41"][0][1],
         "plain_call_ms": k2_ms["B1_L41"][1][1],
         "at_B16_L128": {
             "ms": k2_ms["B16_L128"][0][0],
             "plain_ms": k2_ms["B16_L128"][1][0],
             **dict(zip(("bound_ms", "bound_by"),
                        attention_bound(B, L, H, D, "bfloat16"))),
             "library_ms": lib["K2_L128"][0],
             "library_kernels": lib["K2_L128"][1],
             "call_ms": k2_ms["B16_L128"][0][1],
             "plain_call_ms": k2_ms["B16_L128"][1][1]},
         "at_B1_L173": {
             "ms": k2_ms["B1_L173"][0][0],
             "plain_ms": k2_ms["B1_L173"][1][0],
             **dict(zip(("bound_ms", "bound_by"),
                        attention_bound(1, 173, H, D, "bfloat16"))),
             "library_ms": lib["K2_L173"][0],
             "library_kernels": lib["K2_L173"][1],
             "launches_per_vqa_query": [c["K2"]
                                        for c in r10["per_query"]]},
         "at_B16_L173": {
             "ms": k2_ms["B16_L173"][0][0],
             "plain_ms": k2_ms["B16_L173"][1][0],
             **dict(zip(("bound_ms", "bound_by"),
                        attention_bound(16, 173, H, D, "bfloat16"))),
             "library_ms": lib["K2_B16_L173"][0],
             "library_kernels": lib["K2_B16_L173"][1],
             "call_ms": k2_ms["B16_L173"][0][1],
             "launches_vcr": {k: v["launches"]["K2"]
                              for k, v in r12["runs"].items()}},
         "fp32_launches": k2_fp32_launches,
         "fp32_at_B1_L41": k2_fp32(1, 41, "K2_L41_fp32"),
         "fp32_at_B16_L128": k2_fp32(16, 128, "K2_L128_fp32"),
         "fp32_at_B1_L173": k2_fp32(1, 173, "K2_L173_fp32"),
         "fp32_at_B16_L173": k2_fp32(16, 173, "K2_B16_L173_fp32")},
        {"name": "dropout", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/dropout.cu",
         "replaces": "vlbert_tpu/ops/dropout.py:83",
         "launches": launches7["K5_fwd"],
         "launches_e2e": {"vcr": r13["total"]["K5_fwd"],
                          "refcoco": r13r["total"]["K5_fwd"],
                          "pretrain": r14["total"]["K5_fwd"]},
         "bwd_launches": launches7["K5_bwd"],
         "bwd_launches_e2e": {"vcr": r13["total"]["K5_bwd"],
                              "refcoco": r13r["total"]["K5_bwd"],
                              "pretrain": r14["total"]["K5_bwd"]},
         "max_abs_err": max(k5_errs.values()), "ms": k5_ms[0][0],
         "plain_ms": k5_ms[1][0],
         **dict(zip(("bound_ms", "bound_by"),
                    roofline(2 * n_drop * 2, n_drop, "bfloat16"))),
         "philox_floor_ms": philox_floor_ms(PHILOX_PER_CALL["K5"](n_drop),
                                            philox4_instr),
         "library_ms": lib["K5"][0], "library_kernels": lib["K5"][1],
         "call_ms": k5_ms[0][1], "plain_call_ms": k5_ms[1][1]},
        {"name": "attention_dropout_fwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention_dropout_mma.cu",
         "fp32_source": "vlbert_tpu_torch/csrc/attention_f32_mma.cu",
         "replaces": "vlbert_tpu/ops/attention.py:300",
         "launches": launches7["K3"],
         "launches_e2e": {"vcr": r13["total"]["K3"],
                          "refcoco": r13r["total"]["K3"],
                          "pretrain": r14["total"]["K3"]},
         "max_abs_err": max(k34_errs["K3"].values()), "ms": k3_ms[0][0],
         "plain_ms": k3_ms[1][0],
         **dict(zip(("bound_ms", "bound_by"),
                    attention_bound(B, L, H, D, "bfloat16"))),
         "philox_floor_ms": philox_floor_ms(
             PHILOX_PER_CALL["K3"](B, H, L), philox4_instr),
         "library_ms": lib["K3"][0], "library_kernels": lib["K3"][1],
         "call_ms": k3_ms[0][1], "plain_call_ms": k3_ms[1][1],
         "at_B16_L173": k34_at_173("k3", "K3_L173", "K3"),
         "fp32_at_B16_L128": {
             "source": "vlbert_tpu_torch/csrc/attention_f32_mma.cu",
             "launches": {"phase8_vqa_step": agree["launches"][0]["K3"],
                          "phase13_vcr_step":
                              agree13["launches"][0]["K3"],
                          "phase14_pretrain_step":
                              agree14["launches"][0]["K3"]},
             "ms": k34_f32["k3"][0][0], "plain_ms": k34_f32["k3"][1][0],
             **dict(zip(("bound_ms", "bound_by"),
                        attention_bound(B, L, H, D, "float32"))),
             "philox_floor_ms": philox_floor_ms(
                 PHILOX_PER_CALL["K3_fp32"](B, H, L), philox4_instr),
             "library_ms": lib["K3_fp32"][0],
             "library_kernels": lib["K3_fp32"][1],
             "call_ms": k34_f32["k3"][0][1],
             "plain_call_ms": k34_f32["k3"][1][1]},
         "fp32_at_B16_L173": {
             "source": "vlbert_tpu_torch/csrc/attention_f32_mma.cu",
             "ms": k34_f32["k3_L173"][0][0],
             "plain_ms": k34_f32["k3_L173"][1][0],
             **dict(zip(("bound_ms", "bound_by"),
                        attention_bound(16, 173, H, D, "float32"))),
             "philox_floor_ms": philox_floor_ms(
                 PHILOX_PER_CALL["K3_fp32"](16, H, 173), philox4_instr),
             "library_ms": lib["K3_fp32_L173"][0],
             "library_kernels": lib["K3_fp32_L173"][1],
             "call_ms": k34_f32["k3_L173"][0][1]}},
        {"name": "attention_dropout_bwd", "route": "cuda",
         "source": "vlbert_tpu_torch/csrc/attention_dropout_mma.cu",
         "fp32_source": "vlbert_tpu_torch/csrc/attention_f32_mma.cu",
         "replaces": "vlbert_tpu/ops/attention.py:326",
         "launches": launches7["K4"],
         "launches_e2e": {"vcr": r13["total"]["K4"],
                          "refcoco": r13r["total"]["K4"],
                          "pretrain": r14["total"]["K4"]},
         "max_abs_err": max(k34_errs["K4"].values()),
         "err_is_relative_to": "max(1, max |plain|)", "ms": k4_ms[0][0],
         "plain_ms": k4_ms[1][0],
         **dict(zip(("bound_ms", "bound_by"),
                    attention_bound(B, L, H, D, "bfloat16", backward=True))),
         "philox_floor_ms": philox_floor_ms(
             PHILOX_PER_CALL["K4"](B, H, L), philox4_instr),
         "library_ms": lib["K4"][0], "library_kernels": lib["K4"][1],
         "per_kernel_ms": k4_split, "call_ms": k4_ms[0][1],
         "plain_call_ms": k4_ms[1][1],
         "at_B16_L173": {**k34_at_173("k4", "K4_L173", "K4", backward=True),
                         "per_kernel_ms": k34_173["k4_split"]},
         "fp32_launches": k4_fp32_launches,
         "fp32_at_B16_L128": {
             "source": "vlbert_tpu_torch/csrc/attention_f32_mma.cu",
             "ms": k34_f32["k4"][0][0], "plain_ms": k34_f32["k4"][1][0],
             **dict(zip(("bound_ms", "bound_by"),
                        attention_bound(B, L, H, D, "float32",
                                        backward=True))),
             "library_ms": lib["K4_fp32"][0],
             "library_kernels": lib["K4_fp32"][1],
             "per_kernel_ms": k34_f32["k4_split"],
             "call_ms": k34_f32["k4"][0][1],
             "plain_call_ms": k34_f32["k4"][1][1]},
         "fp32_at_B16_L173": {
             "source": "vlbert_tpu_torch/csrc/attention_f32_mma.cu",
             "ms": k34_f32["k4_L173"][0][0],
             "plain_ms": k34_f32["k4_L173"][1][0],
             **dict(zip(("bound_ms", "bound_by"),
                        attention_bound(16, 173, H, D, "float32",
                                        backward=True))),
             "library_ms": lib["K4_fp32_L173"][0],
             "library_kernels": lib["K4_fp32_L173"][1]}},
    ]

    def at_h16(name, backward=False, philox=None):
        """One kernel at VCR-large's 16 heads (phase 15's parity shapes),
        bf16 and fp32: ms, call ms, plain, bound, library."""
        out = {}
        for dn, ts in lk_t.items():
            (ms, call_ms), plain_ms, (lib_ms, lib_kernels) = ts[name]
            if name == "K5":
                n = B15 * L15 * H15 * 64
                es = 2 if dn == "bfloat16" else 4
                bound = roofline(2 * n * es, n, dn)
                shape = f"[{B15},{L15},{H15 * 64}]"
            else:
                bound = attention_bound(B15, L15, H15, D, dn,
                                        backward=backward)
                shape = f"B={B15} L={L15} H={H15} D={D}"
            out[dn] = {"shape": shape, "ms": ms, "call_ms": call_ms,
                       "plain_ms": plain_ms,
                       "plain_ms_by": "CUDA events, 5 calls",
                       "bound_ms": bound[0],
                       "bound_by": bound[1], "library_ms": lib_ms,
                       "library_kernels": lib_kernels}
            # K4's fp32 route has no Philox count of its own
            key = {("K3", "float32"): "K3_fp32",
                   ("K4", "float32"): None}.get((philox, dn), philox)
            if key:
                evals = PHILOX_PER_CALL[key]
                out[dn]["philox_floor_ms"] = philox_floor_ms(
                    evals(B15 * L15 * H15 * 64) if name == "K5"
                    else evals(B15, H15, L15), philox4_instr)
        return out

    # launches on phase 15's paths: VCR-large's 8 training steps and its
    # validation run (15a), the REMAT step (15b), the fp32 VQA-large step
    # (15d), the 8 RefCOCO+-large queries (15e)
    tot15, on15 = r15["total"], r15["remat"][True]["launches"]
    large = {
        "roi_align_fwd": ({"vcr_large_train": tot15["K1"],
                           "refcoco_large_serve":
                               r15e["launches"]["roi_align"]}, None),
        "roi_align_bwd": ({"vcr_large_train": tot15["K1b"]}, None),
        "attention_fwd": ({"vcr_large_val": tot15["K2"],
                           "refcoco_large_serve":
                               r15e["launches"]["fused_attention"]},
                          at_h16("K2")),
        "dropout": ({"vcr_large_train": (tot15["K5_fwd"], tot15["K5_bwd"]),
                     "vcr_large_remat_step": (on15["K5_fwd"],
                                              on15["K5_bwd"]),
                     "vqa_large_fp32_step": (
                         r15d["launches"][0]["K5_fwd"],
                         r15d["launches"][0]["K5_bwd"])},
                    at_h16("K5", philox="K5")),
        "attention_dropout_fwd": ({"vcr_large_train": tot15["K3"],
                                   "vcr_large_remat_step": on15["K3"],
                                   "vqa_large_fp32_step":
                                       r15d["launches"][0]["K3"]},
                                  at_h16("K3", philox="K3")),
        "attention_dropout_bwd": ({"vcr_large_train": tot15["K4"],
                                   "vcr_large_remat_step": on15["K4"],
                                   "vqa_large_fp32_step":
                                       r15d["launches"][0]["K4"]},
                                  at_h16("K4", backward=True,
                                         philox="K4"))}
    for record in kernels:
        counts, times = large[record["name"]]
        record["launches_large"] = counts
        if times:
            record["at_H16"] = times
    # launches on phase 16's paths, each run's total: 16a's run under a
    # process group of one NCCL rank, 16b's two gloo ranks, 16d's FSDP2,
    # 16e's two tensor-parallel ranks, 16f's four fsdp ranks on [2, 2]
    dist_runs = {"16a_nccl_world1": r16["a"][1]["total"],
                 "16b_gloo_rank0": r16["b"][0]["total"],
                 "16b_gloo_rank1": r16["b"][1]["total"],
                 "16d_fsdp_nccl_world1": r16["d"]["total"],
                 **{f"16e_tp_gloo_rank{i}": x["total"]
                    for i, x in enumerate(r16["e"])},
                 **{f"16f_fsdp_tp_gloo_rank{i}": x["total"]
                    for i, x in enumerate(r16["f"])}}
    count_of = {"roi_align_fwd": "K1", "roi_align_bwd": "K1b",
                "attention_fwd": "K2", "dropout": "K5_fwd",
                "attention_dropout_fwd": "K3", "attention_dropout_bwd": "K4"}
    for record in kernels:
        record["launches_dist"] = {k: v[count_of[record["name"]]]
                                   for k, v in dist_runs.items()}
    # launches on phases 17-18's paths: the int8 servers' 8 queries each
    # (17a RefCOCO+, 17b VQA), their fp32 query on int8 weights (17c), the
    # attention dump's 8 images (18a), ResNet-18's fp32 query (18b)
    int8_vis = {
        "roi_align_fwd": {
            "17a_refcoco_int8_serve": r17a["launches"]["roi_align"],
            "17c_refcoco_int8_fp32_query": r17a["fp32"]["launches"]["K1"],
            "18a_attention_dump": r18a["launches"]["K1"],
            "18b_refcoco_r18_fp32_query": r18b["fp32"]["launches"]["K1"],
            "18b_refcoco_r18_bf16_queries":
                r18b["bf16_launches"]["roi_align"]},
        "attention_fwd": {
            "17a_refcoco_int8_serve": r17a["launches"]["fused_attention"],
            "17b_vqa_int8_serve": sum(c["K2"] for c in r17b["per_query"]),
            "17c_refcoco_int8_fp32_query": r17a["fp32"]["launches"]["K2"],
            "17c_vqa_int8_fp32_query": r17b["fp32"]["launches"]["K2"],
            "18a_attention_dump": r18a["launches"]["K2"],
            "18b_refcoco_r18_fp32_query": r18b["fp32"]["launches"]["K2"],
            "18b_refcoco_r18_bf16_queries":
                r18b["bf16_launches"]["fused_attention"]}}
    for record in kernels:
        if record["name"] in int8_vis:
            record["launches_int8_vis"] = int8_vis[record["name"]]
    add_fp16_records(kernels, f16_errs, f16_t, r19)
    lap("20")
    print(f"[total] phases 1-20 in {time.perf_counter() - t_run:.1f} s, "
          f"the kernels' build included; seconds by phase {laps} ({card})",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def descendants(pid):
    """Pids of every live process below ``pid``, from /proc."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:                 # ended while we looked
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z":            # zombies have already ended
            children.setdefault(int(fields[1]), []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        for c in children.get(todo.pop(), ()):
            found.append(c)
            todo.append(c)
    return found


def stop_child_processes():
    """Stop every process this run started that still runs. The loader's
    worker pools are shut down where they are used, but the forkserver
    that forked their workers and multiprocessing's resource tracker stay
    up until the interpreter exits; stop both and wait for them, then kill
    and reap any other descendant. Returns the pids that had to be
    killed."""
    import multiprocessing.forkserver as forkserver
    import multiprocessing.resource_tracker as resource_tracker
    import signal

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    left = descendants(os.getpid())
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    for pid in left:
        with contextlib.suppress(ChildProcessError):   # not our child
            os.waitpid(pid, 0)
    return left


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        killed = stop_child_processes()
        if killed:
            print(f"chip_smoke: killed leftover processes {killed}",
                  file=sys.stderr)
    sys.exit(rc)
