#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA H100 and check it.

  python3 chip_smoke.py                  # every phase, as below
  python3 chip_smoke.py --kernels-only   # phases 1-3: build and hold the kernels

Phases; any failure exits non-zero, and nothing falls back to the CPU or to
a kernel's plain version:
  1. device  the card's name and power limit (nvidia-smi), torch and CUDA
  2. build   compile every CUDA source of src/repro_torch/kernels/csrc (nvcc,
             sm_90a, one process per source, all at once); ptxas registers
             and spills of K1's served bf16 instances (hd 256, 128 and 64)
  3. kernels each kernel against its plain version on the card, on the same
             inputs; medians of CUDA-event times:
             flash_attention: the serving shapes in bf16 (3e-2), each with
             its share of the bound and its ratio to SDPA: gemma3-4b's global
             and local layers, recurrentgemma-9b's local layer, qwen3-8b's
             layer (H 32 over KV 8, hd 128; granite-3-8b's is the same shape,
             timed once), gemma3-12b's global and local layers (H 16 over
             KV 8, hd 256, window 1024), dbrx-132b's layer (H 48 over KV 8,
             hd 128) and mixtral-8x7b's (H 32 over KV 8, hd 128, window
             4096), seamless-m4t-medium's (MHA 16, hd 64) enc layer
             (unmasked, 1536 x 1536), global layer and xattn sub-layer
             (unmasked, 2048 queries over 1536 keys), llama-3.2-vision-90b's
             (H 64 over KV 8, hd 128) global and cross layers (unmasked, 2048
             over 1601 keys), and K1's time per prefill of each arch (the
             MoE archs and llama at their serving cuts); a bf16 sweep over
             every head dim, S of 1, 80, 200, 328, 1536, 1601, 2048, 2049
             and 3000, GQA 1, 2, 6, 8 and 16, Sq != Sk both ways (unmasked
             with Sq > Sk at seamless's xattn and llama's cross shapes) and
             causal, windowed and non-causal masks (3e-2);
             and the f32 sweep of tests/test_kernels.py (2e-5); with the
             optional lse: o bit-equal with and without it, lse against the
             plain logsumexp (1e-5 f32, 1e-2 bf16), the time with and
             without it at gemma global;
             flash_attention_bwd: the same 25-case sweep in bf16 and f32 and
             the training shapes at B 2 (K1's serving shapes above:
             recurrentgemma-9b's local layer is where the dK/dV kernel
             splits the 16 query heads), against
             the plain backward (relative to
             max(1, max |ref|): f32 1e-4, bf16 2e-2 against the bf16 inputs
             upcast to f32); 20 calls bit-equal at gemma global, at
             recurrentgemma local, at qwen3-8b's shape, at dbrx-132b's, at
             llama-3.2-vision-90b's cross shape and at the sweep's GQA 6
             case (bf16, its heads split); its time
             beside
             the bound, the plain
             backward and SDPA's backward (its backend recorded, as for the
             forward's SDPA yardstick); each bf16 backward kernel's ptxas
             registers and spills at every head dim;
             ssd: the f32 sweep of tests/test_kernels.py (2e-3), the
             served widths (p 64, n 128, chunk 256) at b 1, h 4 and s of
             1, 100, 300 and 2049 (a chunk shorter than a 64-row tile,
             ragged last chunks, a one-row tail) and the mamba2-780m
             serving shape (both 2e-3 x max(1, max |ref|)); its bound at
             f32 accuracy (3xTF32 on the tensor cores) beside the f32 rate
             without tensor cores; y and S_final bit-equal with and without
             the output the backward keeps;
             ssd_bwd: against the plain backward on the ssd sweep and served
             widths (ragged last chunks, s below a 64-row tile, a one-row
             tail), each with dS_final None and given, and at the
             mamba2-780m training shape (b 2, s 2048, h 48, chunk 256), all
             2e-4 x max(1, max |ref|) per gradient; 20 calls bit-equal
             there; its time (CUDA events and profiler device time by
             kernel) beside its bound (P B and P^T C once per (b, chunk);
             the first design's count, per head, beside it) and the plain
             backward; the bytes a call adds to the peak of device memory;
             each kernel's ptxas registers and spills (the served instance,
             p 64 and n 128, must not spill);
             rglru_scan: the f32 sweep of tests/test_kernels.py (1e-5);
             ragged B 2 shapes (S 1, 63, 64, 65, 2049 x C 7, 130, 4095), B 1
             at the serving width, a chain of 256 chunks (B 1, S 16384) with
             a in (0.99, 1) and the recurrentgemma-9b serving shape on three
             inputs (all 1e-5 x max(1, max |ref|)); 20 back-to-back calls
             bit-equal; its device time per call (profiler, memset
             included) beside torch.add of a and b, which moves the same
             bytes;
             rglru_scan_bwd: against the plain backward on the forward's
             sweep, the ragged shapes, a chain of 256 chunks (B 1, S 16384)
             with a in (0.99, 1) and the recurrentgemma-9b training shape
             (B 2, S 2048, C 4096) with both distributions (1e-5 x max(1,
             max |ref|) per gradient); 20 calls bit-equal there; its time
             (CUDA events and profiler device time) beside its bytes bound
             (20 B an element) and the plain backward; its ptxas registers
             and spills
  4. serve   each arch at full width, random weights from a seed: batch 4,
             a 2048-token prompt, 32 greedy decode steps; launch counts of
             every kernel (reset just before the measured run), finite
             logits, decode against a full forward; a torch.profiler window
             over prefill and over decode steps:
             gemma3-4b (the prompt is past the 1024 window, so the window
             masks and the local ring cache are live): 34 flash_attention
             launches per prefill; mamba2-780m (8 chunks of 256 per
             sequence): 48 ssd launches per prefill; recurrentgemma-9b
             (window 2048: the decode checks at 2049 and 2080 tokens run
             the window mask and wrap the ring): 26 rglru_scan and 12
             flash_attention launches per prefill; qwen3-8b, granite-3-8b
             and gemma3-12b (window 1024, ring live): 36, 40 and 48
             flash_attention launches per prefill; mixtral-8x7b at 20 layers
             and dbrx-132b at 8 (MOE_SERVE_CUTS; the reference's capacity
             factor 1.25): 20 and 8 per prefill, the share of prefill
             assignments each MoE layer drops and the residual stream's max
             |h| printed, the bf16 decode check printed with where decode,
             the prefill and the full forward routed differently (per row:
             choices and drops at the checked and earlier decode tokens,
             prompt assignments), the rows routed the same everywhere held
             to the dense archs' rule, and decode gated on a drop-free f32
             replay (F32_REPLAY); seamless-m4t-medium at full size (36 per
             prefill: 12 enc, 12 causal, 12 xattn) and llama-3.2-vision-90b
             at 30 layers (CROSS_SERVE_CUTS; 24 causal, 6 cross), with bf16
             stub memory and every gate at GATE, and a liveness check: other
             memory must move the logits by more than DECODE_RTOL x max
             |logit|; none in decode; no backward launch. The timed run is
             the bare path (it fails if moe.route or model.apply_layer is
             wrapped); a MoE arch's routings come from a second, untimed run
             fed the same tokens, its decode time printed beside the bare
             one
  5. grad    a full-width two-layer gemma3-4b (one local, one global layer,
             B 1, S 2048) in f32: the gradient from K1's forward and backward
             against a Richardson-extrapolated central difference of the
             loss along random directions over every leaf and over the
             attention leaves (1e-2 relative); the same for a full-width
             two-layer mamba2-780m (8 chunks a sequence) through K2's
             forward and backward, over every leaf and over the mixer
             leaves that reach the loss through K2 (A_log, dt_bias, in_B,
             in_C, in_dt, in_x, conv_*); and for a full-width two-layer
             recurrentgemma-9b (two RG-LRU layers) through K3's forward and
             backward, over every leaf and over the gate leaves that reach
             the loss only through K3 (w_a, b_a, w_i, b_i, lam), the gate
             leaves once more with lam filled to -7, so that a lies in
             (0.993, 1) and the carry between chunks is live; and for a
             full-width two-layer qwen3-8b (two global layers: K1 at hd 128
             over GQA 4) over every leaf and over the attention leaves; and
             for a full-width two-layer mixtral-8x7b over every leaf and over
             its MoE leaves (router, wi, wg, wo), each evaluation routed
             with the unperturbed forward's expert ids and slots (the
             branch autograd differentiates; MOE_FD_STEP); and for a
             seamless-m4t-medium of one encoder and one decoder layer and a
             llama-3.2-vision-90b of (global, cross) at full width, gates at
             GATE and std-1 stub memory, over every leaf and over the
             encoder, xattn and gate leaves or the cross layer's
  6. train   gemma3-4b at full width and depth, B 2 x S 2048 from the
             port's data, remat full, 6 AdamW steps: finite losses and
             gnorms, per step exactly the K1 forwards (34 + 30 recomputed)
             and backwards (34) remat full implies, no other kernel; then
             ssd and rglru_scan under autograd on the card each run their
             forward and backward kernels once; then mamba2-780m the same
             way (48 + 48 recomputed K2 forwards and 48 K2 backwards a
             step, no other kernel); then recurrentgemma-9b at full width
             and 14 layers ((RG-LRU, RG-LRU, local) x 4 + 2 RG-LRU; its
             38 layers' state does not fit one card): 18 K3 forwards (10 +
             8 recomputed), 10 K3 backwards, 8 K1 forwards (4 + 4) and 4 K1
             backwards a step, no other kernel; then qwen3-8b at 16 layers
             (32 K1 forwards, 16 backwards a step), granite-3-8b at 18 (36,
             18) and gemma3-12b at 12, two repeats of (5 local + 1 global)
             (24, 12), each at full width (DENSE_TRAIN_CUTS); then
             mixtral-8x7b at 2 layers (4 K1 forwards, 2 backwards a step)
             and dbrx-132b at 1 (2, 1), each at full width
             (MOE_TRAIN_CUTS), with the MoE aux loss of each step; then
             seamless-m4t-medium at full size (72 K1 forwards, 36 backwards
             a step) and llama-3.2-vision-90b as a (global, cross) cut
             (CROSS_TRAIN_CUTS; 4, 2), gates at GATE, the data's stub memory
             in every batch; for each,
             step time, tokens/s, peak memory and a profiler window of one
             step
  7. capture every measured path traced on fake cuda tensors into a Chakra
             graph (repro_torch.core.capture_step), in a process of its own
             started before phase 4 and run beside phases 4-6 (lowest
             priority, one thread, CUDA initialised with one allocation of
             its own): each arch's prefill as phase 4 cuts it and the
             training steps of gemma3-4b, mamba2-780m and the 14-layer
             recurrentgemma-9b as phase 6 runs them. Gates: (i) no capture
             changes CUDA's allocated or reserved bytes or makes an
             allocation, and none moves a launch counter; (ii) each graph's
             nodes of each kernel equal the launches that the path's
             measured run counted; (iii) FlopCounterMode around one more,
             untimed, real gemma3-4b prefill (phase 4) and train step (phase
             6) counts the captured FLOPs exactly; each graph's roofline
             (its FLOPs at the data sheet's bf16 dense peak, its per-op bytes
             at HBM3's rate, the larger) is not above the measured time.
             Then what one card cannot run: dbrx-132b's training step at all
             40 layers and llama-3.2-vision-90b's prefill at all 100, each
             held exactly to the line through two shallow captures (1 and 2
             layers; 5 and 10). Then rank 0's program under a mesh
             (core.capture_sharded_step over the rank's local shards, a
             fake process group): phase 8's bf16 gemma3-4b prefill (6
             layers) on (2, 4), whose K1 nodes times its 8 ranks equal the
             launches phase 8 counted, and the forward step of gemma3-4b and qwen3-8b at full
             depth on the production mesh (16, 16) and of qwen3-8b on
             (2, 16, 16): one K1 node a layer, no allocation and no launch,
             the FLOPs a rank and each collective's count and bytes printed;
             and qwen3-8b's FSDP train step on (16, 16) at full width and
             1, 2 and 4 layers (MESH_TRAIN_CAPTURE): the K1 forward and
             backward nodes a layer that phase 8's sharded train step
             launched a rank and a layer, its FLOPs a rank and every
             collective's count and bytes exactly linear in depth; and
             qwen3-8b's decode step at full depth on (16, 16)
             (MESH_DECODE_CAPTURES) at decode_32k (B 128, cache 32,768) and
             long_500k (B 1, cache 524,288, seq_shard_cache), the latter
             also at half the length: no kernel node, the FLOPs, bytes and
             collectives printed, and under seq_shard_cache every
             collective's count and bytes the same at both lengths (no
             collective moves the cache); and the forward step of
             mixtral-8x7b and dbrx-132b on (16, 16) at full width, B 16,
             at 1, 2 and 4 layers (MESH_MOE_CAPTURE): one K1 node a
             layer, the FLOPs and every collective's count and bytes
             exactly linear in depth, each collective kind a layer printed
             beside qwen3-8b's dense layer's; and their train step on
             (16, 16) at full width, B 16 x 2048, at 1, 2 and 4 layers
             (MESH_MOE_TRAIN_CAPTURE: mixtral-8x7b ff over the model axis,
             dbrx-132b one expert a model rank): the K1 nodes a layer that
             phase 8's MoE train step launched a rank and a layer, exactly
             linear in depth, each collective kind a layer printed beside
             qwen3-8b's dense train layer's; and recurrentgemma-9b's 5-layer
             bf16 prefill of phase 8 on (2, 4) (kernel nodes times its 8
             ranks = the launches counted: 32 K3, 8 K1), its forward step
             at full depth (38 layers) on (16, 16), B 16 (26 K3 nodes, each
             on rank 0's 256 channels, and 12 K1 nodes: one a layer of each
             kind), and its decode step on (16, 16) at B 128, cache 32,768
             (MESH_RG_DECODE_CAPTURE: no kernel node)
  8. mesh    the serving path sharded over a DeviceMesh under the default
             ParallelConfig's rules (tp, fsdp, sequence parallel), every
             rank simulated on the card by LocalTensorMode
             (parallel.mesh.simulated_ranks), so K1 launches once a layer
             for each rank on its local heads: gemma3-4b at full width as
             one superblock (6 layers) on (2, 4) (B 4 x 2048, 2 q heads over
             1 kv head a rank, 48 launches) in bf16 and in f32, and qwen3-8b
             at full width and 1 layer on (8, 16) (128 ranks, B 8, 2 q
             heads a rank over its 8 kv heads whole on every rank; 128
             launches) in bf16, and at 2 layers in f32 on (2, 16) (32 ranks,
             the same heads a rank; 64 launches); each
             sharded prefill's logits and layer 0's k cache against the
             unsharded prefill of the same weights on the card, bf16 within
             DECODE_RTOL and f32 within 1e-3 of the largest value, the
             whole logits the same on every rank (and on 8 ranks the bf16
             cache within one bf16 ulp, CACHE_RTOL, in f32); then decode
             under the mesh from that prefill's cache (2 steps), fed the
             unsharded run's greedy tokens, each step's
             logits against the unsharded decode from the unsharded cache
             by the same rule (the f32 runs keep their caches in f32), and
             no kernel launched in decode; and gemma3-4b's 6 layers in f32
             on (2, 4) under seq_shard_cache (B 1 x 2048, cache 8192: the
             cache and the rings split by length over data, decode as
             flash-decoding over them); and the MoE archs at full width and
             2 layers in bf16, B 4 x 2048, 2 decode steps, routed in 2
             dispatch groups (one a data rank) as their unsharded twins
             are: dbrx-132b on (2, 4) (expert parallel, 16 launches) and
             mixtral-8x7b on (2, 16) (ff over the model axis, 64
             launches), a free sharded prefill's routing flips printed,
             the checked run's routing pinned to the twin's expert ids
             (full-width gates lie within 1e-6 of a tie); and
             recurrentgemma-9b at full width and 5 layers, one superblock
             (RG-LRU, RG-LRU, local) and the (RG-LRU, RG-LRU) remainder, on
             (2, 4) in bf16 and in f32 (B 4 x 2048, 4 decode steps, layer
             0's h and conv history held too): K3 on each rank's 1024
             local channels over the whole sequence, 32 launches a prefill,
             K1 on 4 q heads over the one kv head, 8; the seconds of each
             run and step. Then the train step under a mesh (MESH_TRAIN):
             gemma3-4b at full width as one superblock (6 layers) in f32 on
             (2, 4), B 4 x S 512, 2 steps of the default ParallelConfig
             (remat dots), each against an unsharded train step from the
             same params and moments: loss and gnorm within 1e-5, every
             gathered gradient leaf within 1e-3 of the leaf's max, the
             sharded update within 1e-6 of the port's unsharded
             adamw_update of the gathered state, K1's forward and backward
             launches 8 x the unsharded step's (96 and 48); then
             mixtral-8x7b at full width and 1 layer in f32 on (2, 4)
             (MESH_MOE_TRAIN: expert parallel, 2 dispatch groups), B 4 x S
             512, 2 steps by the same rules, the router leaves among them by
             name, the sharded routing pinned to the unsharded step's and
             the choices a free step would have flipped printed, K1's
             launches 8 x the unsharded step's (16 and 8)
Prints the kernels JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet (dense): bf16 and TF32 tensor cores, f32 without tensor
# cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

ARCH, BATCH, PROMPT, STEPS, SEED = "gemma3-4b", 4, 2048, 32, 0
SSM_ARCH = "mamba2-780m"
RG_ARCH = "recurrentgemma-9b"
# the other dense archs, on K1 alone: qwen3-8b and granite-3-8b (32 q heads
# over 8 kv heads, hd 128, every layer global) and gemma3-12b (16 over 8, hd
# 256, 5 local with window 1024 : 1 global)
QWEN, GRANITE, G12 = "qwen3-8b", "granite-3-8b", "gemma3-12b"
DENSE_ARCHS = (QWEN, GRANITE, G12)
# the MoE archs: mixtral-8x7b (8 experts top-2; 32 q heads over 8 kv heads,
# hd 128, every layer local with window 4096) and dbrx-132b (16 experts
# top-4; 48 q heads over 8 kv heads, hd 128, every layer global). The
# expert products are einsums (bmm over the experts); K1 is their kernel
MIXTRAL, DBRX = "mixtral-8x7b", "dbrx-132b"
MOE_ARCHS = (MIXTRAL, DBRX)
# the cross-attention archs: seamless-m4t-medium (an encoder-decoder: 12
# bidirectional enc layers over 1536 stub frames, then 12 causal decoder
# layers, each with a gated xattn sub-layer over the encoder's output; MHA 16
# at hd 64) and llama-3.2-vision-90b (a vlm: (global x 4, cross) x 20, the
# cross layers over 1601 stub patch embeddings; 64 q heads over 8 kv heads at
# hd 128). K1 runs their cross, xattn and enc attention unmasked
SEAMLESS, LLAMA = "seamless-m4t-medium", "llama-3.2-vision-90b"
CROSS_ARCHS = (SEAMLESS, LLAMA)
# every cross gate (llama's cross layers, seamless's xattn sub-layers) is set
# to GATE in every check of these archs: at the init's zero a cross layer adds
# exactly nothing, seamless's logits do not depend on its encoder, and a wrong
# cross path passes every check
GATE = 0.5
# decode vs full forward, relative to the largest logit: bf16 rounds every
# layer's output (2^-9 relative) and decode rounds its scores to bf16 where
# the kernel keeps f32; over 34 layers that stays within a few percent. A
# wrong cache slot or mask changes attention outputs wholesale.
DECODE_RTOL = 0.1
# mamba2-780m's 48 random-weight layers amplify rounding: on the card, bf16
# decode is 28% of the largest logit from a full forward after 32 steps, and
# an f32 copy of the weights with the bf16 conv history the JAX package
# keeps is still 10.7% off, while with an f32 history the two agree to
# 4.5e-5 (PERF.md, the mamba2-780m findings). So the rule above cannot tell
# rounding from a defect there. mamba2-780m is held instead on that f32
# replay with an f32 conv history, fed the served run's tokens, where decode
# and the chunked kernel differ only in summation order: 1e-3 of the largest
# logit, while a wrong state, conv history or chunk hand-off moves the
# outputs wholesale. The served bf16 errors and the f32 ones with the bf16
# history are printed, not gated. An arch held on the bf16 rule prints the
# same two replays before it fails that rule, so a failure shows whether
# rounding or a defect moved it. The replays keep every decode cache (the
# conv histories and the attention k/v) in the dtype they are given.
#
# The MoE archs are held on the same f32 replay, for another reason too:
# their prefill routes 8,192 tokens into C = 2,560 slots an expert (the
# reference's capacity factor 1.25) and drops the assignments past it,
# while decode routes 4 tokens into 8 slots and never drops, so at cf 1.25
# the forward and decode compute different functions by design; and even
# where nothing drops, rounding flips expert choices, which moves a logit
# by an expert's output. Their replay runs a cut of the served config
# (MOE_REPLAY_CUTS) at capacity factor E/k, where C >= the tokens routed, so
# that nothing drops in the forward either: decode and the forward then
# compute one function, and the replay compares it with itself. The served
# bf16 check prints, for each checked row, where decode (with the prefill
# that filled its cache) and the forward routed differently; a row that
# they routed the same at every token computes one function in both, and
# is held to DECODE_RTOL like a dense arch.
F32_REPLAY = {SSM_ARCH, MIXTRAL, DBRX}
F32_DECODE_RTOL = 1e-3
# llama-3.2-vision-90b's decode is held twice: by the bf16 rule and on the f32
# replay of one superblock (REPLAY_CUTS) at F32_DECODE_RTOL. Other stub memory
# moves its served logits by only 2.2% of the largest logit (its 30-layer
# cut on an NVIDIA H100 80GB HBM3 at 700 W, random weights from SEED: 24
# causal layers dominate the residual stream, and a cross layer averages
# over 1601 keys), so the bf16 rule alone, at
# DECODE_RTOL, could not see a cross path that decode got wrong. The liveness
# check asks the memory to move the logits by more than the tolerance of the
# tightest rule that holds the arch's decode: DECODE_RTOL on the served run
# for seamless-m4t-medium, F32_DECODE_RTOL on the served run and on the
# replay for llama
CROSS_F32_REPLAY = {LLAMA}


# GQA 6 (dbrx-132b's 48 q heads over 8 kv heads), ragged S, where the
# backward splits the 6 heads of a kv tile in 3 (bwd_head_splits)
GQA6_CASE = (128, 2, 6, 3000, 3000, True, 0)
# the forward's bf16 sweep (hd, BKV, G, Sq, Sk, causal, window): every head
# dim (swizzle 32, 64 and 128 B; 1, 2 and 4 boxes a row), S ragged against
# both the 64-key and the 128-row tiles, GQA 1, 2, 6 and 16, Sq != Sk both ways,
# and causal, windowed and non-causal masks; the last two are the first
# non-causal cases with Sq > Sk: seamless-m4t-medium's xattn (hd 64, MHA, Sq
# 2048 over Sk 1536) and llama-3.2-vision-90b's cross layer (hd 128, GQA 8,
# Sk 1601, ragged against the 64-key tile)
FLASH_CASES = []
for _hd in (16, 32, 64, 128, 256):
    FLASH_CASES += [(_hd, 2, 1, 80, 80, False, 0), (_hd, 2, 2, 200, 200, True, 0),
                    (_hd, 1, 16, 2049, 2049, True, 1000)]
FLASH_CASES += [(256, 2, 2, 200, 328, False, 0), (128, 2, 2, 328, 200, True, 150),
                (64, 2, 2, 80, 200, True, 0), (32, 2, 2, 200, 200, False, 64),
                (256, 1, 16, 2049, 2049, False, 0),
                # one row and one key; one row over many keys
                (16, 1, 1, 1, 1, True, 0), (256, 2, 2, 1, 3000, False, 0), GQA6_CASE,
                (64, 2, 1, 2048, 1536, False, 0), (128, 1, 8, 2048, 1601, False, 0)]

# K1's backward against the plain backward, relative to max(1, max |ref|) per
# tensor: f32 against the plain backward in f32 (summation order; the
# kernel's f32 products are scalar FMAs); bf16 against the plain backward on
# the same bf16 inputs upcast to f32, so the tolerance covers the bf16
# rounding of o, P and dS before their products (2^-9 relative each). The
# bf16 bound was 5e-2 until the first card run measured at most 5.4e-3 over
# the sweep and the training shapes; it is 2e-2 since.
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the training shapes: gemma3-4b at B 2 (global and window 1024) and
# recurrentgemma-9b's local layer (16 q heads over one kv head, window 2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 6
# recurrentgemma-9b trains at full width and reduced depth: 8.524 B
# parameters at 12 bytes each (bf16 params and gradients, f32 mu and nu) are
# ~102 GB; (RG-LRU, RG-LRU, local) x 4 + the (RG-LRU, RG-LRU) remainder hold
# 3.81 B, ~38 GB of state, close to gemma3-4b's 38.87 GB
RG_TRAIN_CUT = {"name": f"{RG_ARCH}-14layer", "num_layers": 14, "sb_repeat": 4}
# every training phase's optimizer and parallel settings (the capture phase
# traces the same step)
TRAIN_OPT = {"lr": 1e-4, "warmup_steps": 2, "total_steps": 100}
TRAIN_PAR = {"remat": "full", "microbatches": 1}
# the dense archs train at full width and reduced depth too: at 12 bytes a
# parameter the full archs need 90.8, 98.1 and 141.2 GB. Each cut keeps the
# layer pattern and the embedding at about recurrentgemma-9b's 3.81 B: 3.709,
# 3.788 and 3.696 B parameters
DENSE_TRAIN_CUTS = {
    QWEN: {"name": f"{QWEN}-16layer", "num_layers": 16, "sb_repeat": 16},
    GRANITE: {"name": f"{GRANITE}-18layer", "num_layers": 18, "sb_repeat": 18},
    G12: {"name": f"{G12}-12layer", "num_layers": 12, "sb_repeat": 2},
}
# the MoE archs serve at full width and reduced depth: their bf16 weights
# are 93.4 and 263.2 GB at full depth. 20 mixtral layers hold 29.29 B
# parameters (58.6 GB), 8 dbrx layers 27.31 B (54.6 GB), with room for the
# cache and a prefill's expert transients ((E, C, F) bf16 of 0.59 and 0.88
# GB at C 2,560)
MOE_SERVE_CUTS = {
    MIXTRAL: {"name": f"{MIXTRAL}-20layer", "num_layers": 20, "sb_repeat": 20},
    DBRX: {"name": f"{DBRX}-8layer", "num_layers": 8, "sb_repeat": 8},
}
# and train at 2 and 1 layers: 3.165 B (38.0 GB of state at 12 bytes a
# parameter) and 4.492 B (53.9 GB; dbrx's untied 100,352-token embedding
# and unembedding alone are 1.233 B)
MOE_TRAIN_CUTS = {
    MIXTRAL: {"name": f"{MIXTRAL}-2layer", "num_layers": 2, "sb_repeat": 2},
    DBRX: {"name": f"{DBRX}-1layer", "num_layers": 1, "sb_repeat": 1},
}
# the f32 replay's depth (F32_REPLAY): 4 mixtral layers are 24.3 GB of f32
# weights, 2 dbrx layers 31.0 GB, beside ~15 and ~23 GB of (E, C, F) f32
# transients at capacity factor E/k (C = 8,200 for 8,196 tokens)
MOE_REPLAY_CUTS = {
    MIXTRAL: {"name": f"{MIXTRAL}-4layer", "num_layers": 4, "sb_repeat": 4},
    DBRX: {"name": f"{DBRX}-2layer", "num_layers": 2, "sb_repeat": 2},
}
# llama-3.2-vision-90b serves at full width and 30 of its 100 layers: 87.67 B
# parameters (175 GB of bf16) at full depth; (global x 4, cross) x 6 hold
# 27.77 B (55.5 GB) and keep the pattern. seamless-m4t-medium (0.665 B)
# serves and trains at full size
CROSS_SERVE_CUTS = {LLAMA: {"name": f"{LLAMA}-30layer", "num_layers": 30, "sb_repeat": 6}}
# llama trains as a two-layer (global, cross) cut, which changes the pattern
# (one global layer before the cross layer, where the arch has four): one
# full superblock is 6.38 B, 76.6 GB of state at 12 bytes a parameter, with no
# room for activations; the cut holds 3.81 B (about 46 GB of state), the size
# of the other training cuts. Its gradient check runs the same two layers
CROSS_TRAIN_CUTS = {LLAMA: {"name": f"{LLAMA}-2layer", "num_layers": 2,
                            "superblock": ("global", "cross"), "sb_repeat": 1}}
SERVE_CUTS = {**MOE_SERVE_CUTS, **CROSS_SERVE_CUTS}
# an f32 replay of llama's 30-layer cut would need 111 GB: one superblock
REPLAY_CUTS = {**MOE_REPLAY_CUTS,
               LLAMA: {"name": f"{LLAMA}-5layer", "num_layers": 5, "sb_repeat": 1}}


def serve_config(get_config, arch):
    """`arch`'s config as the serve phase runs it (cut as SERVE_CUTS says)."""
    return get_config(arch).replace(**SERVE_CUTS.get(arch, {}))


def replay_config(arch, cfg):
    """The config of `arch`'s f32 replay: the served config, or its
    REPLAY_CUTS cut, a MoE arch's at capacity factor E/k (nothing drops)."""
    if arch not in REPLAY_CUTS:
        return cfg
    cfg = cfg.replace(**REPLAY_CUTS[arch])
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def set_gates(torch, model, value=GATE):
    """Set every cross gate of `model` (0 where it has none) to `value`;
    returns how many."""
    gates = [p for name, p in model.named_parameters() if name.endswith(".gate")]
    with torch.no_grad():
        for p in gates:
            p.fill_(value)
    return len(gates)


def stub_memory(torch, cfg, seed, batch=None):
    """The stub frontend's memory (batch, or BATCH, by memory length, D):
    standard normals in bf16 from `seed`, as launch/serve.py draws them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = cfg.context_tokens if cfg.family == "vlm" else cfg.encoder_len
    return torch.randn(batch or BATCH, n, cfg.d_model, generator=g,
                       device="cuda").to(torch.bfloat16)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps=10, warmup=2):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_ms(torch, fn, calls=20):
    """Milliseconds a call over `calls` calls launched back to back between
    one pair of CUDA events: the host enqueues faster than the card runs
    them, so this is device time, gaps between calls included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def attention_pairs(Sq, Sk, causal, window):
    """(q, k) pairs the mask keeps: the work this call's data needs."""
    n = 0
    for i in range(Sq):
        hi = min(Sk, i + 1) if causal else Sk
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def attention_bound_ms(q, k, causal, window):
    BH, Sq, hd = q.shape
    flops = 4 * BH * attention_pairs(Sq, k.shape[1], causal, window) * hd
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()   # q, k, v in; o out
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# K1's shapes in phase 3: (label, arch, layer kind), each (heads, kv heads,
# head dim, window, causal, Sq, Sk) timed once under the label of the first
# arch that has it
K1_SHAPES = (("global", ARCH, "global"), ("local", ARCH, "local"),
             (f"{RG_ARCH} local", RG_ARCH, "local"), (f"{QWEN} global", QWEN, "global"),
             (f"{G12} global", G12, "global"), (f"{G12} local", G12, "local"),
             (f"{DBRX} global", DBRX, "global"), (f"{MIXTRAL} local", MIXTRAL, "local"),
             (f"{SEAMLESS} enc", SEAMLESS, "enc"), (f"{SEAMLESS} global", SEAMLESS, "global"),
             (f"{SEAMLESS} xattn", SEAMLESS, "xattn"), (f"{LLAMA} global", LLAMA, "global"),
             (f"{LLAMA} cross", LLAMA, "cross"))
# the archs whose serving and training run K1, each timed per prefill and per
# train step from K1_SHAPES
SERVED_ON_K1 = (ARCH, RG_ARCH) + DENSE_ARCHS + MOE_ARCHS + CROSS_ARCHS
# the kinds of K1 launch: causal self-attention (global, local), a cross
# layer over the memory, the xattn sub-layer of an enc-dec model's global
# layers over the encoder's output, and the encoder's enc layers
K1_KINDS = ("global", "local", "cross", "xattn", "enc")


def kind_layers(cfg, kind):
    """(layers of `kind` in one forward of `cfg`, those of them that remat
    recomputes): a decoder layer kind counts its layers, the superblock's
    rematted; xattn counts an enc-dec model's global layers, rematted with
    the superblock; enc the encoder's layers, each rematted."""
    if kind == "enc":
        return cfg.encoder_layers, cfg.encoder_layers
    if kind == "xattn":
        if not cfg.encoder_layers:
            return 0, 0
        kind = "global"
    return cfg.layer_kinds.count(kind), cfg.superblock.count(kind) * cfg.sb_repeat


def k1_layers(cfg):
    """The kind of each of K1's launches in one forward of `cfg`."""
    return [kind for kind in K1_KINDS for _ in range(kind_layers(cfg, kind)[0])]


def k1_shape(cfg, kind, seq=PROMPT):
    """(heads, kv heads, head dim, window, causal, Sq, Sk) of K1 in a layer
    of `kind` over `seq` tokens (the training sequence is as long as the
    prompt): a cross or xattn layer's keys are the memory, an enc layer's
    queries too."""
    mem = cfg.context_tokens or cfg.encoder_len
    return (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.local_window if kind == "local" else 0, kind in ("global", "local"),
            mem if kind == "enc" else seq, mem if kind in ("cross", "xattn", "enc") else seq)


def k1_shapes(get_config):
    """[(label, config, shape)] of K1_SHAPES."""
    out = []
    for label, arch, kind in K1_SHAPES:
        cfg = get_config(arch)
        out.append((label, cfg, k1_shape(cfg, kind)))
    return out


def k1_shape_archs(get_config, shape):
    """The archs of SERVED_ON_K1 with a K1 launch of this shape."""
    archs = [(a, get_config(a)) for a in SERVED_ON_K1]
    return [a for a, c in archs if any(k1_shape(c, kind) == shape for kind in set(k1_layers(c)))]


def per_model(get_config, per, archs, cuts=None):
    """{arch: {launches, ms, plain_ms, library_ms, bound_ms}}: K1's per-launch
    times in `per` (by K1_SHAPES label) summed over K1's launches in one
    forward of each arch's config (cut as `cuts` says)."""
    label_of = {}
    for label, _, shape in k1_shapes(get_config):
        label_of.setdefault(shape, label)
    out = {}
    for arch in archs:
        cfg = get_config(arch).replace(**(cuts or {}).get(arch, {}))
        labels = [label_of[k1_shape(cfg, kind)] for kind in k1_layers(cfg)]
        out[cfg.name] = {"launches": len(labels), **{
            key: sum(per[x][key] for x in labels)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def ptxas_usage(text):
    """{entry function: its ptxas register and spill lines} from `-Xptxas=-v`."""
    usage, entry = {}, None
    for ln in text.splitlines():
        if "Compiling entry function '" in ln:
            entry = ln.split("'")[1]
        elif entry and ("registers" in ln or "spill" in ln):
            usage.setdefault(entry, []).append(ln.split("info    : ")[-1].strip())
    return {name: "; ".join(lines) for name, lines in usage.items()}


# the served instances of K1: the bf16 kernel at head dims 256 (gemma3,
# recurrentgemma-9b), 128 (qwen3-8b, granite-3-8b, the MoE archs,
# llama-3.2-vision-90b) and 64 (seamless-m4t-medium); and the bf16 kernels of
# its backward, an instance per head dim
K1_SERVED_KERNEL, K1_SERVED_HDS = "flash_fwd_bf16_kernel", (256, 128, 64)
K1_BWD_ENTRIES = ("flash_bwd_dkdv_bf16_kernel", "flash_bwd_dq_bf16_kernel")


def phase_build():
    """Build every source; returns {"hd <hd>": ptxas lines} of K1's served
    instances, {"<kernel> hd <hd>": ptxas lines} of its backward's bf16 instances,
    {kernel: ptxas lines} of K2's backward at mamba2-780m's widths and
    {kernel: ptxas lines} of K3's backward."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    try:
        info = build.build_all()
    except RuntimeError as e:
        fail(str(e))
    served, bwd, ssd_bwd, rglru_bwd = {}, {}, {}, {}
    for name, item in info.items():
        usage = ptxas_usage(item["log"])
        log(f"[build] {name}: {item['seconds']:.1f}s nvcc -> {item['path'].name}; "
            + "; ".join(sorted(set(usage.values()))))
        # compiler warnings, and ptxas's notes of serialised wgmmas or an
        # ignored setmaxnreg ("Potential Performance Loss")
        for ln in item["log"].splitlines():
            if "warning" in ln.lower() or "Performance Loss" in ln:
                log(f"[build] {name}: {ln.strip()}")
        if name in ("ssd", "ssd_bwd"):    # each of K2's kernels and its backward's, by name
            fn = "ssd_fwd" if name == "ssd" else name   # the C function the namespace is named by
            for entry, lines in sorted(usage.items()):
                short = entry.split("_cu_")[-1].split(fn, 1)[-1].lstrip("0123456789")[:48]
                log(f"[build] {name} {short}: {lines}")
                if name == "ssd_bwd" and ("ILi" not in short or "ILi64ELi128E" in short):
                    ssd_bwd[short] = lines      # the instance mamba2-780m runs (p 64, n 128)
                    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines)
                    if "ILi64ELi128E" in short and spills and (int(spills.group(1))
                                                             or int(spills.group(2))):
                        fail(f"ssd_bwd's served instance spills: {short}: {lines}")
        if name in ("rglru", "rglru_bwd"):   # K3's kernels: 64 steps of two inputs in registers
            for entry, lines in sorted(usage.items()):
                log(f"[build] {name} {entry}: {lines}")
                if name == "rglru_bwd":
                    rglru_bwd[entry] = lines
        for entry, lines in usage.items():
            for hd in K1_SERVED_HDS:
                if f"{K1_SERVED_KERNEL}ILi{hd}E" in entry:
                    served[f"hd {hd}"] = lines
                    log(f"[build] flash_attention bf16 hd {hd} ({entry}): {lines}")
            for kernel in K1_BWD_ENTRIES:
                hd = entry.split(kernel + "ILi")[-1].split("E")[0] if kernel in entry else ""
                if hd.isdigit():
                    bwd[f"{kernel} hd {hd}"] = lines
    for key in sorted(bwd, key=lambda x: (x.split(" hd ")[0], int(x.split(" hd ")[1]))):
        log(f"[build] flash_attention_bwd {key}: {bwd[key]}")
    log(f"[build] all sources in {time.perf_counter() - t0:.1f}s")
    return served, bwd, ssd_bwd, rglru_bwd


def phase_kernels(torch, ptxas_served):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(BKV, G, S, hd, dtype, Sk=None):
        mk = lambda n, s: torch.randn(n, s, hd, generator=g, device="cuda").to(dtype)  # noqa: E731
        Sk = S if Sk is None else Sk
        return mk(BKV * G, S), mk(BKV, Sk), mk(BKV, Sk)

    def check(q, k, v, causal, window, tol, what):
        o = flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention_oracle(q.float(), k.float(), v.float(),
                                          causal=causal, window=window)
        err = (o.float() - want).abs().max().item()
        if not math.isfinite(err) or err > tol:
            fail(f"flash_attention {what}: max abs err {err:.3g} > {tol}")
        return err

    # f32 (and bf16) sweep of tests/test_kernels.py: ragged S, non-causal, GQA
    sweep_err = {"float32": 0.0, "bfloat16": 0.0}
    for S, causal, window in [(64, True, 0), (96, True, 0), (64, True, 16),
                              (128, False, 0), (80, True, 24)]:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            err = check(*inputs(4, 2, S, 32, dtype), causal, window, tol,
                        f"S{S} causal={causal} window={window} {dtype}")
            key = str(dtype).split(".")[-1]
            sweep_err[key] = max(sweep_err[key], err)
    for kv in (1, 2, 4):
        err = check(*inputs(2 * kv, 4 // kv, 64, 16, torch.float32), True, 0,
                    2e-5, f"GQA kv={kv}")
        sweep_err["float32"] = max(sweep_err["float32"], err)
    log(f"[kernels] flash_attention sweep: f32 max err {sweep_err['float32']:.3g} "
        f"(tol 2e-5), bf16 {sweep_err['bfloat16']:.3g} (tol 3e-2)")

    # bf16 across what the TMA / wgmma design can get wrong
    wide_err = 0.0
    for hd, BKV, G, Sq, Sk, causal, window in FLASH_CASES:
        err = check(*inputs(BKV, G, Sq, hd, torch.bfloat16, Sk), causal, window, 3e-2,
                    f"bf16 hd{hd} kv{BKV} G{G} Sq{Sq} Sk{Sk} causal={causal} window={window}")
        wide_err = max(wide_err, err)
    log(f"[kernels] flash_attention bf16 sweep, {len(FLASH_CASES)} cases (every head dim, "
        f"ragged S, GQA 1/2/6/16, Sq != Sk, three masks): max err {wide_err:.3g} (tol 3e-2)")

    # the serving shapes, B 4, bf16 (K1_SHAPES): gemma3-4b's (H 8, KV 4, hd
    # 256) global layer (causal) and local one (causal, window 1024),
    # recurrentgemma-9b's local layer (H 16 over one kv head, window 2048),
    # qwen3-8b's layer (H 32 over KV 8, hd 128; granite-3-8b's is the same
    # shape, timed once), gemma3-12b's (H 16 over KV 8, hd 256) global and
    # local (window 1024) layers, the MoE archs' layers, seamless-m4t-medium's
    # (MHA 16, hd 64) enc (unmasked, 1536 frames), global and xattn (2048
    # queries, unmasked over 1536 keys) and llama-3.2-vision-90b's (H 64 over
    # KV 8, hd 128) global and cross (unmasked over 1601 keys) layers
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    per = {}
    for label, c, (H, KV, hd, window, causal, Sq, Sk) in k1_shapes(get_config):
        q, k, v = inputs(BATCH * KV, H // KV, Sq, hd, torch.bfloat16, Sk)
        err = check(q, k, v, causal, window, 3e-2, f"serving shape {label}")
        ms = cuda_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=causal,
                                                        window=window))
        plain_ms = cuda_ms(torch, lambda: ref.flash_attention_oracle(
            q, k, v, causal=causal, window=window), reps=5)
        # yardstick only: one PyTorch call computing the same function
        q4 = q.view(BATCH, H, Sq, hd)
        k4 = k.view(BATCH, KV, Sk, hd)
        v4 = v.view(BATCH, KV, Sk, hd)
        # a window as long as the prompt masks no more than causality does
        mask = None
        if 0 < window < Sq:
            pos = torch.arange(Sq, device="cuda")
            d = pos[:, None] - pos[None, :]
            mask = (d >= 0) & (d < window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
        backend = sdpa_backend(torch, q4, k4, v4, mask, causal and mask is None)
        lib_err = (lib().reshape(q.shape).float()
                   - flash_attention_fwd(q, k, v, causal=causal, window=window).float()
                   ).abs().max().item()
        library_ms = cuda_ms(torch, lib)
        bound_ms, bound_by = attention_bound_ms(q, k, causal, window)
        per[label] = {"window": window, "heads": H, "kv_heads": KV, "head_dim": hd,
                      "causal": causal, "sq": Sq, "sk": Sk,
                      "archs": k1_shape_archs(get_config, (H, KV, hd, window, causal, Sq, Sk)),
                      "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_share": bound_ms / ms, "vs_library": ms / library_ms,
                      "library_vs_kernel_max_abs_diff": lib_err, "sdpa_backend": backend}
        log(f"[kernels] flash_attention {label} (H {H} over KV {KV}, hd {hd}, "
            f"{'causal' if causal else 'unmasked'}, window {window}, Sq {Sq}, Sk {Sk}; the "
            f"shape of {', '.join(per[label]['archs'])}): err {err:.3g}, "
            f"{ms:.4f} ms (plain {plain_ms:.3f}, SDPA {library_ms:.4f} by {backend}, "
            f"bound {bound_ms:.4f} by {bound_by}); {bound_ms / ms:.1%} of the bound, "
            f"{ms / library_ms:.2f}x SDPA's time")
    n_local = sum(kind == "local" for kind in cfg.layer_kinds)
    n_global = sum(kind == "global" for kind in cfg.layer_kinds)
    per_prefill = {key: n_global * per["global"][key] + n_local * per["local"][key]
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_arch = per_model(get_config, per, SERVED_ON_K1, SERVE_CUTS)
    for arch, t in by_arch.items():
        log(f"[kernels] flash_attention per {arch} prefill ({t['launches']} launches): "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f}, plain {t['plain_ms']:.3f}, SDPA "
            f"{t['library_ms']:.4f}")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:72",
        "launches": None,                     # filled in from the serve phase
        "max_abs_err": max(per[x]["max_abs_err"] for x in per),
        "max_err": max(per[x]["max_abs_err"] for x in per),
        **per_prefill, "bound_by": "+".join(sorted({per[x]["bound_by"] for x in per})),
        "times_are": f"per {ARCH} prefill: {n_global} global + {n_local} local "
                     "launches; each shape per launch under per_launch, each arch's "
                     "prefill under per_prefill_by_arch",
        "f32_sweep_max_abs_err": sweep_err["float32"],
        "bf16_sweep_max_abs_err": max(sweep_err["bfloat16"], wide_err),
        "ptxas_bf16_hd256": ptxas_served.get("hd 256"),
        "ptxas_bf16_hd128": ptxas_served.get("hd 128"),
        "ptxas_bf16_hd64": ptxas_served.get("hd 64"),
        "per_launch": per, "per_prefill_by_arch": by_arch,
    }


def attention_bwd_bound_ms(q, k, causal, window):
    """Least time of one backward: the five products of a kept pair (S, dP,
    dV, dK, dQ: 10 hd FLOP a pair per q head, 2.5x the forward's) at the
    bf16 or f32 peak, against q, k, v, o, dO and lse read once and dQ, dK,
    dV written once."""
    BH, Sq, hd = q.shape
    flops = 10 * BH * attention_pairs(Sq, k.shape[1], causal, window) * hd
    nbytes = (6 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * BH * Sq
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def sdpa_backend(torch, q4, k4, v4, mask, is_causal):
    """The SDPA backend PyTorch picks for this call (torch._fused_sdp_choice),
    or why it could not be read."""
    from torch.nn.attention import SDPBackend
    try:
        choice = torch._fused_sdp_choice(q4, k4, v4, attn_mask=mask, dropout_p=0.0,
                                         is_causal=is_causal, enable_gqa=True)
        return SDPBackend(choice).name
    except Exception as e:                        # noqa: BLE001 - reported, not relied on
        return f"not read ({type(e).__name__}: {e})"[:120]


def phase_kernels_flash_lse(torch):
    """K1's forward with the optional lse: o bit-equal with and without it,
    lse against the plain logsumexp of the masked scores (1e-5 f32, 1e-2
    bf16, absolute), and the time with and without it at gemma global."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.configs.registry import get_config

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tol = {"float32": 1e-5, "bfloat16": 1e-2}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(hd, BKV, G, Sq, Sk, c, w, "bfloat16") for hd, BKV, G, Sq, Sk, c, w in FLASH_CASES]
    cases += [(32, 4, 2, S, S, c, w, "float32") for S, c, w in
              [(64, True, 0), (96, True, 0), (64, True, 16), (128, False, 0), (80, True, 24)]]
    cases += [(hd, BKV, G, Sq, Sk, c, w, "float32") for hd, BKV, G, Sq, Sk, c, w in
              FLASH_CASES if Sq * Sk * BKV * G <= 2 ** 24]
    for hd, BKV, G, Sq, Sk, causal, window, dt in cases:
        dtype = getattr(torch, dt)
        mk = lambda n, s: torch.randn(n, s, hd, generator=g, device="cuda").to(dtype)  # noqa: E731
        q, k, v = mk(BKV * G, Sq), mk(BKV, Sk), mk(BKV, Sk)
        o = flash_attention_fwd(q, k, v, causal=causal, window=window)
        o2, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      return_lse=True)
        torch.cuda.synchronize()
        what = f"{dt} hd{hd} kv{BKV} G{G} Sq{Sq} Sk{Sk} causal={causal} window={window}"
        if not torch.equal(o, o2):
            fail(f"flash_attention lse {what}: o differs with and without lse")
        _, want = ref.flash_attention_oracle(q.float(), k.float(), v.float(), causal=causal,
                                             window=window, return_lse=True)
        err = (lse - want).abs().max().item()
        if not math.isfinite(err) or err > tol[dt]:
            fail(f"flash_attention lse {what}: max abs err {err:.3g} > {tol[dt]}")
        worst[dt] = max(worst[dt], err)
    log(f"[kernels] flash_attention lse, {len(cases)} cases: o bit-equal with and without "
        f"lse; lse max abs err f32 {worst['float32']:.3g} (tol 1e-5), bf16 "
        f"{worst['bfloat16']:.3g} (tol 1e-2)")
    cfg = get_config(ARCH)
    G = cfg.num_heads // cfg.num_kv_heads
    mk = lambda n: torch.randn(n, PROMPT, cfg.head_dim, generator=g,  # noqa: E731
                               device="cuda").to(torch.bfloat16)
    q, k, v = mk(BATCH * cfg.num_heads), mk(BATCH * cfg.num_kv_heads), mk(BATCH * cfg.num_kv_heads)
    times = {}
    for label in ("without lse", "with lse", "with lse ", "without lse "):   # in turns
        with_lse = label.startswith("with ")
        times.setdefault(label.strip(), []).append(cuda_ms(
            torch, lambda: flash_attention_fwd(q, k, v, causal=True, return_lse=with_lse)))
    ms = {k_: statistics.mean(v_) for k_, v_ in times.items()}
    log(f"[kernels] flash_attention gemma global (B {BATCH}, S {PROMPT}), in turns: "
        f"{ms['without lse']:.4f} ms without lse, {ms['with lse']:.4f} ms with lse "
        f"({ms['with lse'] / ms['without lse'] - 1:+.1%})")
    return {"cases": len(cases), "lse_max_abs_err": worst, "o_bit_equal": True,
            "gemma_global_ms": ms}


def phase_kernels_flash_bwd(torch, ptxas_bwd):
    """K1's backward against the plain backward over the forward's sweep
    (both dtypes) and the training shapes; 20 calls bit-equal; times."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (bwd_head_splits, flash_attention_bwd,
                                                     flash_attention_fwd)

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def inputs(hd, BKV, G, Sq, Sk, dtype):
        mk = lambda n, s: torch.randn(n, s, hd, generator=g, device="cuda").to(dtype)  # noqa: E731
        return mk(BKV * G, Sq), mk(BKV, Sk), mk(BKV, Sk), mk(BKV * G, Sq)

    def check(q, k, v, do, causal, window, what):
        """Errors of dq, dk, dv relative to max(1, max |ref|)."""
        dt = str(q.dtype).split(".")[-1]
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        torch.cuda.synchronize()
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        of, lsef = ref.flash_attention_oracle(qf, kf, vf, causal=causal, window=window,
                                              return_lse=True)
        want = ref.flash_attention_bwd_oracle(qf, kf, vf, of, lsef, dof, causal=causal,
                                              window=window)
        errs = []
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            if x.shape != y.shape or x.dtype != q.dtype:
                fail(f"flash_attention_bwd {what}: {name} is {tuple(x.shape)} {x.dtype}")
            rel = (x.float() - y).abs().max().item() / max(1.0, y.abs().max().item())
            if not math.isfinite(rel) or rel > BWD_RTOL[dt]:
                fail(f"flash_attention_bwd {what}: {name} err {rel:.3g} x max(1, max |ref|) "
                     f"> {BWD_RTOL[dt]}")
            errs.append(rel)
        return max(errs)

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for hd, BKV, G, Sq, Sk, causal, window in FLASH_CASES:
        for dt in ("bfloat16", "float32"):
            err = check(*inputs(hd, BKV, G, Sq, Sk, getattr(torch, dt)), causal, window,
                        f"{dt} hd{hd} kv{BKV} G{G} Sq{Sq} Sk{Sk} causal={causal} "
                        f"window={window}")
            worst[dt] = max(worst[dt], err)
    log(f"[kernels] flash_attention_bwd sweep, {len(FLASH_CASES)} cases x (bf16, f32): max "
        f"err x max(1, max |ref|) bf16 {worst['bfloat16']:.3g} (tol "
        f"{BWD_RTOL['bfloat16']}), f32 {worst['float32']:.3g} (tol {BWD_RTOL['float32']})")
    # the GQA 6 case in bf16: its 6 heads a kv tile split over blocks whose
    # f32 partials a second kernel sums in split order, so 20 calls give the
    # same bits
    hd, BKV, G, Sq, Sk, causal, window = GQA6_CASE
    splits = bwd_head_splits(BKV, G, Sk)
    if splits == 1:
        fail("flash_attention_bwd GQA 6 case: bwd_head_splits gives 1, no split to check")
    q, k, v, do = inputs(hd, BKV, G, Sq, Sk, torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    outs = [flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
            for _ in range(20)]
    torch.cuda.synchronize()
    if not all(all(torch.equal(a, b) for a, b in zip(x, outs[0])) for x in outs):
        fail("flash_attention_bwd: 20 back-to-back calls at the GQA 6 case differ")
    del q, k, v, do, o, lse, outs
    log(f"[kernels] flash_attention_bwd GQA 6 case (hd {hd}, KV {BKV}, G {G}, S {Sq}, bf16; "
        f"{splits} blocks share a kv tile's heads): 20 back-to-back calls bit-equal")

    cfg = get_config(ARCH)
    per = {}
    for label, c, key in k1_shapes(get_config):
        H, KV, hd, window, causal, Sq, Sk = key
        shape = (hd, TRAIN_BATCH * KV, H // KV, Sq, Sk)
        errs = {dt: check(*inputs(*shape, getattr(torch, dt)), causal, window,
                          f"training shape {label} {dt}") for dt in ("bfloat16", "float32")}
        for dt, e in errs.items():
            worst[dt] = max(worst[dt], e)
        q, k, v, do = inputs(*shape, torch.bfloat16)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
        run = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal,  # noqa: E731
                                          window=window)
        entry = {"window": window, "heads": H, "kv_heads": KV, "head_dim": hd,
                 "causal": causal, "sq": Sq, "sk": Sk, "archs": k1_shape_archs(get_config, key),
                 "batch": TRAIN_BATCH, "max_rel_err": errs}
        if label in ("global", f"{RG_ARCH} local", f"{QWEN} global", f"{DBRX} global",
                     f"{LLAMA} cross"):
            # no atomics, and the G split's partials are summed in a fixed
            # order (recurrentgemma; dbrx, where the split is a divisor of
            # 6; llama's cross layer, unmasked over 1601 keys, ragged against
            # the 64-key tile): every call gives the same bits
            outs = [run() for _ in range(20)]
            torch.cuda.synchronize()
            if not all(all(torch.equal(a, b) for a, b in zip(x, outs[0])) for x in outs):
                fail(f"flash_attention_bwd: 20 back-to-back calls at {label} differ")
            del outs
            log(f"[kernels] flash_attention_bwd {label}: 20 back-to-back calls bit-equal")
        ms = cuda_ms(torch, run)
        plain_ms = cuda_ms(torch, lambda: ref.flash_attention_bwd_oracle(
            q, k, v, o, lse, do, causal=causal, window=window), reps=5)
        # yardstick only: the backward of one PyTorch SDPA call on the same inputs
        q4, k4, v4 = (x.view(TRAIN_BATCH, -1, x.shape[1], hd).detach().requires_grad_()
                      for x in (q, k, v))
        do4 = do.view(q4.shape)
        mask = None
        if 0 < window < Sq:
            pos = torch.arange(Sq, device="cuda")
            d = pos[:, None] - pos[None, :]
            mask = (d >= 0) & (d < window)
        out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              is_causal=causal and mask is None, enable_gqa=True)
        library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do4, retain_graph=True))
        backend = sdpa_backend(torch, q4, k4, v4, mask, causal and mask is None)
        del out4, q4, k4, v4
        bound_ms, bound_by = attention_bwd_bound_ms(q, k, causal, window)
        entry.update({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "sdpa_backend": backend, "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_share": bound_ms / ms, "vs_library": ms / library_ms})
        per[label] = entry
        log(f"[kernels] flash_attention_bwd {label} (B {TRAIN_BATCH}, H {H} over KV {KV}, hd "
            f"{hd}, {'causal' if causal else 'unmasked'}, window {window}, Sq {Sq}, Sk {Sk}; "
            f"the shape of {', '.join(entry['archs'])}): err bf16 {errs['bfloat16']:.3g}, f32 "
            f"{errs['float32']:.3g}; "
            f"{ms:.4f} ms (plain {plain_ms:.3f}, SDPA backward {library_ms:.4f} by "
            f"{backend}, bound {bound_ms:.4f} by {bound_by}); {bound_ms / ms:.1%} of the "
            f"bound, {ms / library_ms:.2f}x SDPA's time")
        del q, k, v, do, o, lse
    n_local = sum(kind == "local" for kind in cfg.layer_kinds)
    n_global = sum(kind == "global" for kind in cfg.layer_kinds)
    per_step = {key: n_global * per["global"][key] + n_local * per["local"][key]
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_arch = per_model(get_config, per, SERVED_ON_K1,
                        {RG_ARCH: RG_TRAIN_CUT, **DENSE_TRAIN_CUTS, **MOE_TRAIN_CUTS,
                         **CROSS_TRAIN_CUTS})
    for name, t in by_arch.items():
        log(f"[kernels] flash_attention_bwd per {name} train step ({t['launches']} launches): "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f}, plain {t['plain_ms']:.3f}, SDPA "
            f"backward {t['library_ms']:.4f}")
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:72",
        "replaces_note": "the gradient of K1's function, which the JAX package "
                         "takes through XLA (no custom_vjp)",
        "launches": None,                     # filled in from the train phase
        "max_abs_err": max(worst.values()),
        "max_err_is": "relative to max(1, max |ref|) per tensor",
        **per_step, "bound_by": "+".join(sorted({per[x]["bound_by"] for x in per})),
        "times_are": f"per {ARCH} train step (B {TRAIN_BATCH}, S {TRAIN_SEQ}): "
                     f"{n_global} global + {n_local} local launches; each shape per "
                     "launch under per_launch, each trained config's step under "
                     "per_step_by_config",
        "sweep_max_rel_err": worst, "ptxas_bf16": ptxas_bwd,
        "per_launch": per, "per_step_by_config": by_arch,
    }


def ssd_bound_ms(x, B, chunk):
    """Least time of one SSD call at f32 accuracy: its operations three times
    over (3xTF32) at the TF32 tensor-core rate against the bytes of its
    inputs and outputs, each moved once. Returns (ms, bound by, ms of the
    operations at the f32 rate without tensor cores against the bytes)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    nc = -(-s // Q)
    # causal half of C B^T once per (b, chunk); per (b, h, chunk) the causal
    # half of scores . x, C . S_prev and the state update
    flops = b * nc * Q * Q * n + b * h * nc * (Q * Q * p + 4 * Q * n * p)
    nbytes = 4 * (2 * x.numel() + b * s * h + 2 * B.numel() + h + b * h * n * p)
    t_ops, t_bytes = 3 * flops / PEAK_FLOPS["tf32"], nbytes / PEAK_BYTES
    simt_ms = max(flops / PEAK_FLOPS["float32"], t_bytes) * 1e3
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            simt_ms)


def ssd_inputs(torch, g, b, s, h, p, n):
    """x, dt, A, B, C on the card from generator g, scaled as in the f32 sweep
    of tests/test_kernels.py."""
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    return (rn(b, s, h, p), torch.nn.functional.softplus(rn(b, s, h)),
            -torch.exp(rn(h) * 0.3), rn(b, s, n) * 0.5, rn(b, s, n) * 0.5)


def phase_kernels_ssd(torch):
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import ssd_fwd
    from repro_torch.configs.registry import get_config
    F = torch.nn.functional

    def check(args, chunk, what, scaled=True):
        """2e-3 x max(1, max |ref|), or 2e-3 absolute where not `scaled`."""
        y, sf = ssd_fwd(*args, chunk=chunk)
        torch.cuda.synchronize()
        yr, sfr = ref.ssd_oracle(*args)
        errs = []
        for got, want, name in ((y, yr, "y"), (sf, sfr, "S_final")):
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item()) if scaled else 1.0
            if not math.isfinite(err) or err > 2e-3 * scale:
                fail(f"ssd {what} {name}: max abs err {err:.3g} > 2e-3 x {scale:.4g}")
            errs.append(err)
        return max(errs), max(yr.abs().max().item(), sfr.abs().max().item())

    # the f32 sweep of tests/test_kernels.py:80-92, its inputs as it builds them
    sweep_err = 0.0
    for s, chunk in [(80, 32), (64, 64), (96, 16)]:
        rng = np.random.RandomState(4)
        b, h, p, n = 2, 3, 16, 8
        x = torch.tensor(rng.randn(b, s, h, p), dtype=torch.float32)
        dt = F.softplus(torch.tensor(rng.randn(b, s, h), dtype=torch.float32))
        A = -torch.exp(torch.tensor(rng.randn(h), dtype=torch.float32) * 0.3)
        B = torch.tensor(rng.randn(b, s, n), dtype=torch.float32) * 0.5
        C = torch.tensor(rng.randn(b, s, n), dtype=torch.float32) * 0.5
        args = [t.cuda() for t in (x, dt, A, B, C)]
        err, _ = check(args, chunk, f"sweep s{s} chunk{chunk}", scaled=False)
        sweep_err = max(sweep_err, err)
    log(f"[kernels] ssd sweep: f32 max err {sweep_err:.3g} (tol 2e-3)")

    # the served widths, inputs scaled as in that test: s 1 is one chunk
    # shorter than a 64-row tile, 100 a ragged single chunk, 300 and 2049
    # ragged last chunks (2049: one row)
    cfg = get_config(SSM_ARCH)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    widths_err = 0.0
    for s in (1, 100, 300, 2049):
        err, top = check(ssd_inputs(torch, g, 1, s, 4, p, n), cfg.ssm_chunk,
                         f"served widths b1 s{s} h4")
        widths_err = max(widths_err, err)
        log(f"[kernels] ssd served widths (b 1, s {s}, h 4, p {p}, n {n}, chunk "
            f"{cfg.ssm_chunk}): err {err:.3g} (max |ref| {top:.4g})")

    # the mamba2-780m serving shape
    b, s = BATCH, PROMPT
    g = torch.Generator(device="cuda").manual_seed(SEED)
    args = ssd_inputs(torch, g, b, s, h, p, n)
    err, scale = check(args, cfg.ssm_chunk, "serving shape")
    # the optional saved output (training) leaves y and S_final as they are
    plain_out = ssd_fwd(*args, chunk=cfg.ssm_chunk)
    saved_out = ssd_fwd(*args, chunk=cfg.ssm_chunk, return_saved=True)
    if not all(torch.equal(a, b) for a, b in zip(plain_out, saved_out[:2])):
        fail("ssd serving shape: y or S_final differ with and without the saved output")
    del plain_out, saved_out
    log("[kernels] ssd serving shape: y and S_final bit-equal with and without the saved "
        "output")
    ms = cuda_ms(torch, lambda: ssd_fwd(*args, chunk=cfg.ssm_chunk))
    # the sequential plain version takes ~2048 steps of small kernels: 3 reps
    plain_ms = cuda_ms(torch, lambda: ref.ssd_oracle(*args), reps=3, warmup=1)
    bound_ms, bound_by, simt_ms = ssd_bound_ms(args[0], args[3], cfg.ssm_chunk)
    log(f"[kernels] ssd serving shape (b {b}, s {s}, h {h}, p {p}, n {n}, chunk "
        f"{cfg.ssm_chunk}): err {err:.3g} (max |ref| {scale:.4g}), {ms:.4f} ms "
        f"(plain {plain_ms:.3f}, bound {bound_ms:.4f} by {bound_by} at 3xTF32, "
        f"{simt_ms:.4f} at the f32 rate without tensor cores); "
        f"{bound_ms / ms:.1%} of the bound")
    n_layers = sum(kind == "ssd" for kind in cfg.layer_kinds)
    per_launch = {"max_abs_err": err, "max_abs_ref": scale, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "bound_ms_simt_f32": simt_ms, "bound_share": bound_ms / ms}
    return {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:66",
        "launches": None,                     # filled in from the serve phase
        "max_abs_err": err,
        "ms": n_layers * ms, "plain_ms": n_layers * plain_ms,
        "bound_ms": n_layers * bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the SSD scan",
        "bound_ms_simt_f32": n_layers * simt_ms,
        "times_are": f"per prefill: {n_layers} launches at the serving shape",
        "f32_sweep_max_abs_err": sweep_err,
        "served_widths_max_abs_err": widths_err,
        "per_launch": per_launch,
    }


def ssd_bwd_bound_ms(x, B, chunk, per_head_pb=False):
    """Least time of one SSD backward at f32 accuracy: per (b, h, chunk) of
    q valid rows the causal halves of dy x^T and M^T dy (2 q^2 p FLOP) and
    four q x n x p products (8 q n p); per (b, chunk) the causal halves of
    (sum_h P) B and (sum_h P)^T C (2 q^2 n): B and C are the same for every
    head, so dC = sum_h P_h B + ... = (sum_h P_h) B + ..., and the least work
    sums P over the heads before it meets B and C. `per_head_pb` counts those
    two per (b, h, chunk), as the first design of the kernel multiplied them
    (the bound stated for it). Three times over (3xTF32) at the TF32
    tensor-core rate, against the bytes of its inputs (x, dt, A, B, C, dy,
    and the forward's states, cum and C B^T; training passes no dS_final)
    and outputs (dx, ddt, dA, dB, dC), each moved once.
    Returns (ms, bound by, ms of the operations at the f32 rate without
    tensor cores against the bytes)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    nc = -(-s // Q)
    Qp = -(-Q // 64) * 64
    rows = [min(Q, s - c * Q) for c in range(nc)]
    pb = b * (h if per_head_pb else 1) * sum(2 * q * q * n for q in rows)
    flops = b * h * sum(2 * q * q * p + 8 * q * n * p for q in rows) + pb
    nbytes = 4 * (3 * x.numel() + 2 * b * s * h + 2 * h + 2 * 2 * B.numel()
                  + b * h * nc * (n * p + Q) + b * nc * Qp * Qp)
    t_ops, t_bytes = 3 * flops / PEAK_FLOPS["tf32"], nbytes / PEAK_BYTES
    simt_ms = max(flops / PEAK_FLOPS["float32"], t_bytes) * 1e3
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            simt_ms)


# K2's backward against the plain backward, relative to max(1, max |ref|)
# per gradient tensor. The card's worst error over the sweep and the
# training shape is 6.55e-5 (dA, NVIDIA H100 80GB HBM3, 700 W); the same
# products in plain TF32 miss this bound on every case of the CPU emulation
# in tests/test_torch_ssd_bwd.py, which asserts both sides
SSD_BWD_RTOL = 2e-4


def phase_kernels_ssd_bwd(torch, ptxas):
    """K2's backward against the plain backward (ref.ssd_bwd_oracle) on the
    forward's sweep and served widths, with dS_final None and given, and at
    the mamba2-780m training shape; 20 calls bit-equal there; times."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import ssd_bwd, ssd_fwd
    F = torch.nn.functional

    def check(args, dy, dsf, chunk, what):
        """Errors of dx, ddt, dA, dB, dC relative to max(1, max |ref|)."""
        _, _, *saved = ssd_fwd(*args, chunk=chunk, return_saved=True)
        got = ssd_bwd(*args, dy, dsf, *saved, chunk=chunk)
        torch.cuda.synchronize()
        want = ref.ssd_bwd_oracle(*args, dy, dsf, chunk=chunk)
        errs = {}
        for name, x, y in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
            if x.shape != y.shape or x.dtype != torch.float32:
                fail(f"ssd_bwd {what}: {name} is {tuple(x.shape)} {x.dtype}")
            rel = (x - y).abs().max().item() / max(1.0, y.abs().max().item())
            if not math.isfinite(rel) or rel > SSD_BWD_RTOL:
                fail(f"ssd_bwd {what}: {name} err {rel:.3g} x max(1, max |ref|) "
                     f"> {SSD_BWD_RTOL}")
            errs[name] = rel
        return errs

    def worst_of(errs, into):
        for k, v in errs.items():
            into[k] = max(into.get(k, 0.0), v)

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    worst, cases = {}, 0
    # the forward's f32 sweep (tests/test_kernels.py:80-92, its inputs as it
    # builds them) and the served widths at b 1, h 4: s 1 (a chunk shorter
    # than a 64-row tile), 100 (a ragged single chunk), 300 and 2049 (ragged
    # last chunks; 2049 a one-row tail); each with dS_final None and given
    cfg = get_config(SSM_ARCH)
    h, p, n, chunk = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    shapes = []
    for s_, ch in [(80, 32), (64, 64), (96, 16)]:
        rng = np.random.RandomState(4)
        b_, h_, p_, n_ = 2, 3, 16, 8
        x = torch.tensor(rng.randn(b_, s_, h_, p_), dtype=torch.float32)
        dt = F.softplus(torch.tensor(rng.randn(b_, s_, h_), dtype=torch.float32))
        A = -torch.exp(torch.tensor(rng.randn(h_), dtype=torch.float32) * 0.3)
        B = torch.tensor(rng.randn(b_, s_, n_), dtype=torch.float32) * 0.5
        C = torch.tensor(rng.randn(b_, s_, n_), dtype=torch.float32) * 0.5
        shapes.append(([t.cuda() for t in (x, dt, A, B, C)], ch, f"sweep s{s_} chunk{ch}"))
    for s_ in (1, 100, 300, 2049):
        shapes.append((list(ssd_inputs(torch, g, 1, s_, 4, p, n)), chunk,
                       f"served widths b1 s{s_} h4"))
    for args, ch, what in shapes:
        b_, s_, h_, p_ = args[0].shape
        dy = rn(b_, s_, h_, p_)
        for dsf in (None, rn(b_, h_, args[3].shape[-1], p_)):
            label = f"{what}, dS_final {'given' if dsf is not None else 'None'}"
            worst_of(check(args, dy, dsf, ch, label), worst)
            cases += 1
    log(f"[kernels] ssd_bwd sweep and served widths, {cases} cases: max err x max(1, max "
        f"|ref|) " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (tol {SSD_BWD_RTOL})")

    # the mamba2-780m training shape: b 2, s 2048, h 48, p 64, n 128, chunk 256
    args = list(ssd_inputs(torch, g, TRAIN_BATCH, TRAIN_SEQ, h, p, n))
    dy = rn(TRAIN_BATCH, TRAIN_SEQ, h, p)
    train_errs = check(args, dy, None, chunk, "training shape")
    worst_of(train_errs, worst)
    _, _, *saved = ssd_fwd(*args, chunk=chunk, return_saved=True)
    run = lambda: ssd_bwd(*args, dy, None, *saved, chunk=chunk)  # noqa: E731
    # no atomics, and every sum in a fixed order: every call gives the same bits
    outs = [run() for _ in range(20)]
    torch.cuda.synchronize()
    if not all(all(torch.equal(a, b) for a, b in zip(o, outs[0])) for o in outs):
        fail("ssd_bwd: 20 back-to-back calls at the training shape differ")
    del outs
    log("[kernels] ssd_bwd training shape: 20 back-to-back calls bit-equal")
    ms = cuda_ms(torch, run)
    device_us = device_us_by_kernel(torch, run)
    device_ms = sum(device_us.values()) / 1e3 or None
    # the bytes one call adds to the peak of device memory: outputs and scratch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated() - base
    del out
    plain_ms = cuda_ms(torch, lambda: ref.ssd_bwd_oracle(*args, dy, None, chunk=chunk),
                       reps=3, warmup=1)
    bound_ms, bound_by, simt_ms = ssd_bwd_bound_ms(args[0], args[3], chunk)
    per_head_ms, _, _ = ssd_bwd_bound_ms(args[0], args[3], chunk, per_head_pb=True)
    device = (f"device {device_ms:.4f} ms (" + "; ".join(
        f"{_short(k)} {us:.1f} us" for k, us in device_us.items()) + ")"
        if device_ms else "device time not measured (the profiler saw no kernels)")
    log(f"[kernels] ssd_bwd training shape (b {TRAIN_BATCH}, s {TRAIN_SEQ}, h {h}, p {p}, n "
        f"{n}, chunk {chunk}): err " + ", ".join(f"{k} {v:.3g}" for k, v in train_errs.items())
        + f"; {ms:.4f} ms by CUDA events ({bound_ms / ms:.1%} of the bound, {per_head_ms / ms:.1%} "
        f"of the first design's); {device}; plain {plain_ms:.3f}; bound {bound_ms:.4f} by "
        f"{bound_by} at 3xTF32 (P B and P^T C once per (b, chunk); {per_head_ms:.4f} with them "
        f"per head, the first design's count), {simt_ms:.4f} at the f32 rate without tensor "
        f"cores; {peak_bytes} bytes of peak a call (outputs and scratch)")
    del args, dy, saved
    n_layers = sum(kind == "ssd" for kind in cfg.layer_kinds)
    return {
        "name": "ssd_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
        "replaces": "src/repro/kernels/ssd.py:66",
        "replaces_note": "the gradient of K2's function, which the JAX package "
                         "takes through XLA (no custom_vjp)",
        "launches": None,                     # filled in from the train phase
        "max_abs_err": max(worst.values()),
        "max_err_is": "relative to max(1, max |ref|) per gradient tensor",
        "ms": n_layers * ms, "plain_ms": n_layers * plain_ms,
        "bound_ms": n_layers * bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the SSD scan or its gradient",
        "bound_ms_simt_f32": n_layers * simt_ms,
        "bound_ms_per_head_pb": n_layers * per_head_ms,
        "times_are": f"per {SSM_ARCH} train step: {n_layers} launches at the training "
                     f"shape (b {TRAIN_BATCH}, s {TRAIN_SEQ})",
        "sweep_cases": cases, "max_rel_err_by_tensor": worst,
        "ptxas": ptxas,
        "per_launch": {"ms": ms, "device_ms": device_ms, "device_us_by_kernel": device_us,
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_ms_simt_f32": simt_ms, "bound_share": bound_ms / ms,
                       "bound_ms_per_head_pb": per_head_ms,
                       "bound_share_per_head_pb": per_head_ms / ms,
                       "peak_bytes": peak_bytes, "max_rel_err": train_errs},
    }


def rglru_bound_ms(a, flops=2, arrays=3):
    """Least time of one scan: `flops` per element at the f32 rate without
    tensor cores against the bytes of `arrays` f32 arrays of a's shape, each
    read or written once: the forward's 2 FLOP and a, b in, h out by
    default; the backward's 3 (g = x + dh, x = a g, da = g h) and a, h, dh
    in, da, db out, 20 bytes an element."""
    n = a.numel()
    t_ops, t_bytes = flops * n / PEAK_FLOPS["float32"], arrays * 4 * n / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def device_us_by_kernel(torch, fn, calls=5):
    """{CUDA kernel or memset name: device microseconds per call} of fn over
    `calls` calls (torch.profiler); empty where the profiler saw no device
    work."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        out[e.key[:120]] = us / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def rglru_inputs(torch, g, shape, near_one=False):
    """a, b on the card from generator g: the sweep's distribution
    (a = 0.4 + 0.5 sigmoid(N), b = 0.1 N), or a in (0.99, 1), where h
    carries across hundreds of steps and so across many time chunks."""
    rn = lambda: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    a = 1.0 - 0.01 * torch.sigmoid(rn()) if near_one else 0.4 + 0.5 * torch.sigmoid(rn())
    return a, 0.1 * rn()


def phase_kernels_rglru(torch):
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru as krg
    from repro_torch.kernels.rglru import rglru_scan_fwd
    from repro_torch.models import rglru
    from repro_torch.models.layers import ParamTree

    lib = krg._library()

    def check(a, b, what, scaled):
        """1e-5 x max(1, max |ref|), or 1e-5 absolute where not `scaled`."""
        if lib.rglru_scratch_floats(*a.shape) != krg.scratch_floats(*a.shape):
            fail(f"rglru_scan {what}: the kernel's scratch, "
                 f"{lib.rglru_scratch_floats(*a.shape)} floats, is not "
                 f"kernels/rglru.py's {krg.scratch_floats(*a.shape)}")
        h = rglru_scan_fwd(a, b)
        torch.cuda.synchronize()
        want = ref.rglru_scan_oracle(a, b)
        err = (h - want).abs().max().item()
        top = want.abs().max().item()
        tol = 1e-5 * (max(1.0, top) if scaled else 1.0)
        if not math.isfinite(err) or err > tol:
            fail(f"rglru_scan {what}: max abs err {err:.3g} > {tol:.3g}")
        return err, top

    # the f32 sweep of tests/test_kernels.py:57-67, its inputs as it builds them
    sweep_err = 0.0
    for S, C in [(100, 48), (64, 64), (33, 7)]:
        rng = np.random.RandomState(2)
        a = 0.4 + 0.5 * torch.sigmoid(torch.tensor(rng.randn(2, S, C),
                                                   dtype=torch.float32))
        b = torch.tensor(rng.randn(2, S, C), dtype=torch.float32) * 0.1
        err, _ = check(a.cuda(), b.cuda(), f"sweep S{S} C{C}", scaled=False)
        sweep_err = max(sweep_err, err)
    log(f"[kernels] rglru_scan sweep: f32 max err {sweep_err:.3g} (tol 1e-5)")

    # ragged shapes against the 64-step chunk and the 128-channel tile: one
    # step, one short of a chunk, one chunk, one past it, one past 32 chunks;
    # 7 channels, one past a tile, one short of 32 tiles. Then B 1 at the
    # serving width, and a chain of 256 chunks with a in (0.99, 1). Each from
    # its own generator, so the serving-shape inputs stay those of earlier PRs.
    cfg = get_config(RG_ARCH)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ragged_err = 0.0
    for S in (1, 63, 64, 65, 2049):
        for C in (7, 130, 4095):
            err, top = check(*rglru_inputs(torch, g, (2, S, C)), f"ragged B2 S{S} C{C}",
                             scaled=True)
            ragged_err = max(ragged_err, err / max(1.0, top))
    log(f"[kernels] rglru_scan ragged (B 2, S 1/63/64/65/2049, C 7/130/4095): max err "
        f"{ragged_err:.3g} x max(1, max |ref|) (tol 1e-5)")
    extra = {}
    for what, shape, near_one in (("B 1", (1, PROMPT, cfg.d_rnn), False),
                                  ("long chain, a in (0.99, 1)", (1, 16384, cfg.d_rnn),
                                   True)):
        err, top = check(*rglru_inputs(torch, g, shape, near_one), f"{what} {shape}",
                         scaled=True)
        extra[what] = {"shape": shape, "max_abs_err": err, "max_abs_ref": top}
        log(f"[kernels] rglru_scan {what} {shape}: err {err:.3g} (max |ref| {top:.4g})")

    # the recurrentgemma-9b serving shape (B 4, S 2048, C = rnn width 4096):
    # the sweep's distribution; the gates that the port's rglru_gates makes
    # of u ~ N(0, 1) with its own seeded layer init (lam from rglru_a); and
    # a in (0.99, 1)
    shape = (BATCH, PROMPT, cfg.d_rnn)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    layer = ParamTree(rglru.rglru_specs(cfg), g, "cuda")
    inputs = {
        "sweep distribution": rglru_inputs(torch, g, shape),
        "rglru_gates(u ~ N(0,1))": rglru.rglru_gates(
            torch.randn(*shape, generator=g, device="cuda"), layer),
        "a in (0.99, 1)": rglru_inputs(torch, g, shape, near_one=True),
    }
    del layer
    checks = {}
    for what, (a, b) in inputs.items():
        err, top = check(a, b, f"serving shape, {what}", scaled=True)
        checks[what] = {"max_abs_err": err, "max_abs_ref": top,
                        "a_min": a.min().item(), "a_max": a.max().item()}
        log(f"[kernels] rglru_scan serving shape {shape}, {what}: err {err:.3g} "
            f"(max |ref| {top:.4g}; a in [{checks[what]['a_min']:.4g}, "
            f"{checks[what]['a_max']:.4g}])")
    a, b = inputs["sweep distribution"]
    # the carries come from one fixed formula: every call gives the same bits
    hs = [rglru_scan_fwd(a, b) for _ in range(20)]
    torch.cuda.synchronize()
    if not all(torch.equal(h, hs[0]) for h in hs):
        fail("rglru_scan: 20 back-to-back calls at the serving shape differ")
    del hs
    log("[kernels] rglru_scan serving shape: 20 back-to-back calls bit-equal")
    ms = cuda_ms(torch, lambda: rglru_scan_fwd(a, b))
    device_us = device_us_by_kernel(torch, lambda: rglru_scan_fwd(a, b))
    device_ms = sum(device_us.values()) / 1e3 or None
    # the sequential plain version takes 2048 steps of small kernels: 3 reps
    plain_ms = cuda_ms(torch, lambda: ref.rglru_scan_oracle(a, b), reps=3, warmup=1)
    # yardstick of bytes only: the same 12 bytes an element, another function
    out = torch.empty_like(a)
    copy_ms = cuda_ms(torch, lambda: torch.add(a, b, out=out))
    copy_device_ms = sum(device_us_by_kernel(torch, lambda: torch.add(a, b, out=out))
                         .values()) / 1e3 or None
    bound_ms, bound_by = rglru_bound_ms(a)
    del inputs, a, b, out
    device = (f"device {device_ms:.4f} ms a call ({bound_ms / device_ms:.1%} of the bound: "
              + "; ".join(f"{_short(k)} {us:.1f} us" for k, us in device_us.items()) + ")"
              if device_ms else "device time not measured (the profiler saw no kernels)")
    copy_device = f"{copy_device_ms:.4f}" if copy_device_ms else "not measured"
    log(f"[kernels] rglru_scan serving shape: {ms:.4f} ms by CUDA events ({bound_ms / ms:.1%} "
        f"of the bound); {device}; plain {plain_ms:.3f}; torch.add of a and b (copy_ms) "
        f"{copy_ms:.4f}, device {copy_device}; bound {bound_ms:.4f} by {bound_by}")
    n_layers = sum(kind == "rglru" for kind in cfg.layer_kinds)
    err = max(c["max_abs_err"] for c in checks.values())
    return {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru.cu",
        "replaces": "src/repro/kernels/rglru.py:41",
        "launches": None,                     # filled in from the serve phase
        "max_abs_err": err,
        "ms": n_layers * ms, "plain_ms": n_layers * plain_ms,
        "bound_ms": n_layers * bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single eager PyTorch call computes a first-order "
                        "linear recurrence",
        "copy_ms": n_layers * copy_ms,
        "copy_note": "torch.add(a, b, out=h): the same bytes, another function",
        "times_are": f"per prefill: {n_layers} launches at the serving shape",
        "f32_sweep_max_abs_err": sweep_err,
        "ragged_max_rel_err": ragged_err,
        "per_launch": {"ms": ms, "device_ms": device_ms, "device_us_by_kernel": device_us,
                       "plain_ms": plain_ms, "copy_ms": copy_ms,
                       "copy_device_ms": copy_device_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "checks": checks, **extra},
    }


# K3's backward against the plain backward, relative to max(1, max |ref|) per
# gradient: the forward's bound. Within a 64-step chunk the kernel repeats the
# plain backward's roundings; each chunk boundary adds a few ulps of |g|
RGLRU_BWD_RTOL = 1e-5


def phase_kernels_rglru_bwd(torch, ptxas):
    """K3's backward against the plain backward (ref.rglru_scan_bwd_oracle) on
    the forward's sweep, the ragged shapes, a chain of 256 chunks with a in
    (0.99, 1) and the recurrentgemma-9b training shape; 20 calls bit-equal
    there; times."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru as krg
    from repro_torch.kernels.rglru import rglru_scan_bwd, rglru_scan_fwd

    lib = krg._bwd_library()
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def check(a, b, what):
        """Errors of da and db relative to max(1, max |ref|); h is K3's
        forward of a and b, dh ~ N(0, 1)."""
        if lib.rglru_bwd_scratch_floats(*a.shape) != krg.bwd_scratch_floats(*a.shape):
            fail(f"rglru_scan_bwd {what}: the kernel's scratch, "
                 f"{lib.rglru_bwd_scratch_floats(*a.shape)} floats, is not "
                 f"kernels/rglru.py's {krg.bwd_scratch_floats(*a.shape)}")
        h = rglru_scan_fwd(a, b)
        dh = torch.randn(a.shape, generator=g, device="cuda")
        got = rglru_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
        want = ref.rglru_scan_bwd_oracle(a, h, dh)
        errs = {}
        for name, x, y in zip(("da", "db"), got, want):
            if x.shape != y.shape or x.dtype != torch.float32:
                fail(f"rglru_scan_bwd {what}: {name} is {tuple(x.shape)} {x.dtype}")
            rel = (x - y).abs().max().item() / max(1.0, y.abs().max().item())
            if not math.isfinite(rel) or rel > RGLRU_BWD_RTOL:
                fail(f"rglru_scan_bwd {what}: {name} err {rel:.3g} x max(1, max |ref|) "
                     f"> {RGLRU_BWD_RTOL}")
            errs[name] = rel
        errs["max_abs_ref"] = max(y.abs().max().item() for y in want)
        return errs

    worst = {"da": 0.0, "db": 0.0}

    def keep(errs):
        for k in worst:
            worst[k] = max(worst[k], errs[k])
        return errs

    # the forward's f32 sweep (tests/test_kernels.py:57-67, its inputs as it
    # builds them), then the ragged shapes against the 64-step chunk (now the
    # first the reverse chain takes) and the 128-channel tile
    for S, C in [(100, 48), (64, 64), (33, 7)]:
        rng = np.random.RandomState(2)
        a = 0.4 + 0.5 * torch.sigmoid(torch.tensor(rng.randn(2, S, C), dtype=torch.float32))
        b = torch.tensor(rng.randn(2, S, C), dtype=torch.float32) * 0.1
        keep(check(a.cuda(), b.cuda(), f"sweep S{S} C{C}"))
    cases = 3
    for S in (1, 63, 64, 65, 2049):
        for C in (7, 130, 4095):
            keep(check(*rglru_inputs(torch, g, (2, S, C)), f"ragged B2 S{S} C{C}"))
            cases += 1
    log(f"[kernels] rglru_scan_bwd sweep and ragged (B 2, S 1/63/64/65/2049, C 7/130/4095), "
        f"{cases} cases: max err x max(1, max |ref|) da {worst['da']:.3g}, db "
        f"{worst['db']:.3g} (tol {RGLRU_BWD_RTOL})")
    cfg = get_config(RG_ARCH)
    checks = {}
    for what, shape, near_one in (
            ("long chain, a in (0.99, 1)", (1, 16384, cfg.d_rnn), True),
            ("training shape, sweep distribution", (TRAIN_BATCH, TRAIN_SEQ, cfg.d_rnn), False),
            ("training shape, a in (0.99, 1)", (TRAIN_BATCH, TRAIN_SEQ, cfg.d_rnn), True)):
        checks[what] = keep(check(*rglru_inputs(torch, g, shape, near_one), f"{what} {shape}"))
        log(f"[kernels] rglru_scan_bwd {what} {shape}: err da {checks[what]['da']:.3g}, db "
            f"{checks[what]['db']:.3g} (max |ref| {checks[what]['max_abs_ref']:.4g})")

    # the training shape: 20 calls bit-equal (one fixed carry formula), times
    a, b = rglru_inputs(torch, g, (TRAIN_BATCH, TRAIN_SEQ, cfg.d_rnn))
    h = rglru_scan_fwd(a, b)
    dh = torch.randn(a.shape, generator=g, device="cuda")
    run = lambda: rglru_scan_bwd(a, h, dh)  # noqa: E731
    outs = [run() for _ in range(20)]
    torch.cuda.synchronize()
    if not all(all(torch.equal(x, y) for x, y in zip(o, outs[0])) for o in outs):
        fail("rglru_scan_bwd: 20 back-to-back calls at the training shape differ")
    del outs
    log("[kernels] rglru_scan_bwd training shape: 20 back-to-back calls bit-equal")
    ms = cuda_ms(torch, run)
    device_us = device_us_by_kernel(torch, run)
    device_ms = sum(device_us.values()) / 1e3 or None
    # the sequential plain backward takes 2048 steps of small kernels: 3 reps
    plain_ms = cuda_ms(torch, lambda: ref.rglru_scan_bwd_oracle(a, h, dh), reps=3, warmup=1)
    bound_ms, bound_by = rglru_bound_ms(a, flops=3, arrays=5)
    del a, b, h, dh
    device = (f"device {device_ms:.4f} ms a call ({bound_ms / device_ms:.1%} of the bound: "
              + "; ".join(f"{_short(k)} {us:.1f} us" for k, us in device_us.items()) + ")"
              if device_ms else "device time not measured (the profiler saw no kernels)")
    log(f"[kernels] rglru_scan_bwd training shape (B {TRAIN_BATCH}, S {TRAIN_SEQ}, C "
        f"{cfg.d_rnn}): {ms:.4f} ms by CUDA events ({bound_ms / ms:.1%} of the bound); "
        f"{device}; plain {plain_ms:.3f}; bound {bound_ms:.4f} by {bound_by}; ptxas {ptxas}")
    n_layers = sum(kind == "rglru" for kind in cfg.replace(**RG_TRAIN_CUT).layer_kinds)
    return {
        "name": "rglru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_bwd.cu",
        "replaces": "src/repro/kernels/rglru.py:41",
        "replaces_note": "the gradient of K3's function, which the JAX package "
                         "takes through XLA (no custom_vjp)",
        "launches": None,                     # filled in from the train phase
        "max_abs_err": max(worst.values()),
        "max_err_is": "relative to max(1, max |ref|) per gradient tensor",
        "ms": n_layers * ms, "plain_ms": n_layers * plain_ms,
        "bound_ms": n_layers * bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the reverse recurrence",
        "times_are": f"per {RG_TRAIN_CUT['name']} train step: {n_layers} launches at the "
                     f"training shape (B {TRAIN_BATCH}, S {TRAIN_SEQ})",
        "sweep_and_ragged_cases": cases, "max_rel_err_by_tensor": worst,
        "ptxas": ptxas,
        "per_launch": {"ms": ms, "device_ms": device_ms, "device_us_by_kernel": device_us,
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_share": bound_ms / ms, "checks": checks},
    }


def _launch_counters():
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.rglru import rglru_scan_bwd, rglru_scan_fwd
    from repro_torch.kernels.ssd import ssd_bwd, ssd_fwd
    return {"flash_attention": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
            "ssd": ssd_fwd, "ssd_bwd": ssd_bwd, "rglru_scan": rglru_scan_fwd,
            "rglru_scan_bwd": rglru_scan_bwd}


@contextlib.contextmanager
def recorded_layers(resid=True):
    """While active, record every routing the MoE layers compute
    (``moe.route``'s result: top-k ids, kept assignments, ...) and, with
    `resid`, as a device scalar, the max |h| of the residual stream after
    each layer of a full-sequence forward (``model.apply_layer``). Yields
    (routings, max |h| list)."""
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    routes, tops = [], []
    route, apply_layer = moe.route, model_mod.apply_layer

    def route_rec(*a):
        routes.append(route(*a))
        return routes[-1]

    def layer_rec(*a, **kw):
        out = apply_layer(*a, **kw)
        tops.append(out[0].detach().abs().amax())
        return out

    moe.route = route_rec
    if resid:
        model_mod.apply_layer = layer_rec
    try:
        yield routes, tops
    finally:
        moe.route, model_mod.apply_layer = route, apply_layer


def bare_path(what):
    """Fail unless ``moe.route`` and ``model.apply_layer`` are the port's own
    functions: no recording or pinning wrapper is in place."""
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    for mod, name in ((moe, "route"), (model_mod, "apply_layer")):
        fn = getattr(mod, name)
        if fn.__module__ != mod.__name__ or fn.__name__ != name:
            fail(f"{what}: {mod.__name__}.{name} is {fn.__module__}.{fn.__qualname__}, a "
                 "wrapper, during a timed run")


def phase_serve(torch, arch, per_prefill, count_flops=False):
    """Serve `arch` (cut as SERVE_CUTS says); `per_prefill` names each
    kernel's launches in one prefill (every other kernel must not launch).
    The timed run is the bare path; the MoE routings that the decode check
    reads come from a second, untimed run of the same prefill and decode,
    fed the same tokens. A cross-attention arch takes bf16 stub memory and
    has every gate set to GATE. With `count_flops`, one more prefill under
    FlopCounterMode (untimed). Returns the prefill's launches and ms (and
    FLOPs)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Model
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step, sample_token)

    counters = _launch_counters()
    want = {name: per_prefill.get(name, 0) for name in counters}
    cfg = serve_config(get_config, arch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()         # left by earlier phases
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=SEED)
    n_gates = set_gates(torch, model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f}B params (config says "
        f"{cfg.param_count() / 1e9:.3f}B), seeded init {time.perf_counter() - t0:.1f}s"
        + (f"; every gate ({n_gates}) set to {GATE}" if n_gates else ""))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    memory = stub_memory(torch, cfg, SEED + 2) if model.memory_len() else None
    if memory is not None:
        log(f"[serve] {cfg.name}: bf16 stub memory {tuple(memory.shape)} (std 1, seed "
            f"{SEED + 2})")
    cache_len = PROMPT + STEPS
    prefill = make_prefill_step(model, cache_len)
    decode = make_decode_step(model)

    def run(feed=None, record=False):
        """prefill + STEPS decode steps, greedy or fed the tokens `feed`;
        returns timings, launches after the prefill, finiteness, the tokens,
        the decode logits, and with `record` the MoE routings of the prefill
        and of each decode step and the prefill's residual stream (each call
        inside recorded_layers). Without `record` it is the bare path,
        checked before and after."""
        rec = recorded_layers if record else (lambda resid: contextlib.nullcontext(([], [])))
        if not record:
            bare_path(f"{arch} serving")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rec(resid=record) as (pre_routes, resid):
            logits, cache = prefill(prompt, memory)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        finite = torch.isfinite(logits).all()
        tok = sample_token(logits) if feed is None else feed[0]
        toks, dec_logits, dec_routes = [tok], [], []
        t0 = time.perf_counter()
        for j in range(STEPS):
            with rec(resid=False) as (routes, _):
                logits, cache = decode(tok, cache)
            dec_routes.append(routes)
            finite &= torch.isfinite(logits).all()
            dec_logits.append(logits)
            tok = sample_token(logits) if feed is None else feed[j + 1]
            toks.append(tok)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        if not record:
            bare_path(f"{arch} serving")
        return (t_prefill, t_decode, launches, bool(finite), toks, dec_logits,
                (pre_routes, dec_routes), resid)

    with torch.inference_mode():
        # warm-up (libraries, allocator), with the prefill's routings and
        # residual stream recorded
        *_, (routes, _), resid = run(record=True)
        log_moe_prefill(torch, cfg, routes, resid)
        del routes, resid
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():                # the main path's run starts here
            fn.launches = 0
        t_prefill, t_decode, launches, finite, toks, dec_logits, _, _ = run()
        total_launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()

        for name in counters:
            if launches[name] != want[name] or total_launches[name] != want[name]:
                fail(f"{arch}: {name} launches: {launches[name]} in prefill, "
                     f"{total_launches[name]} in all; want {want[name]} in "
                     "prefill and none in decode")
        if not finite:
            fail(f"{arch}: non-finite logits in prefill or decode")
        served_routes = ()
        if cfg.num_experts:
            # the routings of the timed run, from the same prefill and decode
            # fed its tokens; timed too, to show what the recording costs
            _, t_rec, _, _, _, rec_logits, served_routes, _ = run(feed=toks, record=True)
            same = all(torch.equal(a, b) for a, b in zip(rec_logits, dec_logits))
            log(f"[serve] {arch} decode, in one process: bare {t_decode * 1e3 / STEPS:.3f} "
                f"ms/step (timed run), with every routing recorded {t_rec * 1e3 / STEPS:.3f} "
                f"ms/step (untimed run); its logits "
                + ("bit-equal to the timed run's" if same else "differ from the timed run's"))
        # decode logits at positions 2048 and 2048+STEPS-1 against a full
        # forward over all tokens up to them (last-position logits of
        # prefill); for MoE, with where the two routed differently
        seq = torch.cat([prompt] + toks, dim=1)
        checks = decode_vs_forward(model, seq, dec_logits, memory, *served_routes)
        flops = count_flops_of(torch, lambda: prefill(prompt, memory)) if count_flops else None
        if memory is not None:
            a, _ = prefill(prompt, memory)
            check_memory_moves_logits(torch, arch, a, prefill(prompt, stub_memory(
                torch, cfg, SEED + 3))[0], F32_DECODE_RTOL if arch in CROSS_F32_REPLAY
                else DECODE_RTOL)
    bf16_ok = all(err <= DECODE_RTOL * scale for err, scale, *_ in checks.values())
    gated = arch not in F32_REPLAY
    log(f"[serve] {arch} bf16 decode vs full forward"
        + ("" if gated else " (not gated, see F32_REPLAY)") + ": " + _fmt_checks(checks))
    same = same_routing_rows(checks)
    for pos, b, err, scale in same:
        if not err <= DECODE_RTOL * scale:
            fail(f"{arch}: bf16 decode at position {pos}, row {b}, routed as the full "
                 f"forward routes it at every token: max abs err {err:.4g} > {DECODE_RTOL} "
                 f"x max |logit| {scale:.4g}")
    if same:
        log(f"[serve] {arch} bf16 decode, the {len(same)} of {BATCH * len(checks)} checked "
            f"rows routed as the forward routes them at every token: max abs err "
            f"{max(e / s for _, _, e, s in same):.4g} x max |logit| (within {DECODE_RTOL}: "
            "held)")
    tok_s = BATCH * STEPS / t_decode
    log(f"[serve] {arch} prefill {BATCH}x{PROMPT}: {t_prefill * 1e3:.2f} ms "
        f"({BATCH * PROMPT / t_prefill:.0f} tok/s); decode {STEPS} steps: "
        f"{t_decode * 1e3 / STEPS:.3f} ms/step ({tok_s:.1f} tok/s); "
        f"launches in prefill {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes, of which {before} allocated before "
        "the model was made)")
    log(f"[serve] {arch} sample output ids: {torch.cat(toks, 1)[0, :16].tolist()}")
    with torch.inference_mode():
        profile_serving(torch, prefill, decode, sample_token, prompt, min(8, STEPS),
                        arch, memory)
    held = [(checks, DECODE_RTOL, "bf16 ")] if gated else []
    if not (gated and bf16_ok) or arch in CROSS_F32_REPLAY:
        del model, prefill, decode             # room for an f32 copy of the weights
        torch.cuda.empty_cache()
        rcfg = replay_config(arch, cfg)
        what = "" if rcfg is cfg else f" ({rcfg.name}" + (
            f", capacity factor {rcfg.capacity_factor:g}: nothing drops)"
            if rcfg.num_experts else ")")
        replay_gated = not gated or arch in CROSS_F32_REPLAY
        with torch.inference_mode():
            replay = f32_replay(torch, rcfg, seq, toks, torch.bfloat16, memory)
            log(f"[serve] {arch} f32 weights{what}, bf16 caches: decode vs full forward "
                "(not gated): " + _fmt_checks(replay))
            replay = f32_replay(torch, rcfg, seq, toks, torch.float32, memory,
                                liveness=arch in CROSS_F32_REPLAY)
        log(f"[serve] {arch} f32 weights{what}, f32 caches: decode vs full forward"
            + ("" if replay_gated else " (not gated)") + ": " + _fmt_checks(replay))
        if replay_gated:
            held.append((replay, F32_DECODE_RTOL, "f32 weights, f32 caches: "))
    for checks, rtol, label in held:
        for pos, (err, scale, *_) in checks.items():
            if not err <= rtol * scale:
                fail(f"{arch}: {label}decode at position {pos} vs full forward: max "
                     f"abs err {err:.4g} > {rtol} x max |logit| {scale:.4g}")
    return {"launches": launches, "prefill_ms": t_prefill * 1e3, "flops": flops}


def check_memory_moves_logits(torch, what, a, b, rtol):
    """Liveness of the cross path: the prefill's last logits `b` with the
    memory replaced by other noise (seed SEED + 3) must differ from the
    served ones `a` by more than `rtol` x max |logit|, the tolerance of the
    tightest rule that holds the decode (CROSS_F32_REPLAY); with a gate at
    zero they do not differ at all, and a wrong cross path passes every
    other check."""
    diff, scale = (a - b).abs().max().item(), a.abs().max().item()
    log(f"[serve] {what} liveness: the prefill's logits with other stub memory (seed "
        f"{SEED + 3}) differ by max abs {diff:.4g}, {diff / scale:.4g} x max |logit| "
        f"{scale:.4g} (must exceed {rtol})")
    if not diff > rtol * scale:
        fail(f"{what}: the logits do not depend on the memory: max abs diff {diff:.4g} <= "
             f"{rtol} x max |logit| {scale:.4g}")


def log_moe_prefill(torch, cfg, routes, resid):
    """Print the share of assignments each MoE layer of a prefill dropped
    (min, median, max over the layers) and the residual stream's max |h|
    (over the layers, and its largest layer), from recorded_layers."""
    if not resid:
        return
    tops = [x.item() for x in resid]
    line = (f"[serve] {cfg.name} prefill: residual stream max |h| {max(tops):.4g} "
            f"(after layer {tops.index(max(tops))}; after the first {tops[0]:.4g})")
    if routes:
        drops = [1.0 - r.keep.float().mean().item() for r in routes]
        line += (f"; assignments dropped per layer at capacity factor "
                 f"{cfg.capacity_factor:g}: min {min(drops):.2%}, median "
                 f"{statistics.median(drops):.2%}, max {max(drops):.2%} over "
                 f"{len(drops)} layers")
    log(line)


def _not_chosen(a, b):
    """Per row, the choices of a (rows, ..., K) that b (same shape) does not
    make at the same token."""
    miss = (a[..., :, None] != b[..., None, :]).all(-1)
    return miss.reshape(miss.shape[0], -1).sum(-1)


ROUTING_KEYS = ("flips", "dropped", "earlier", "prompt_kept", "prompt_chosen")


def _routing_diffs(dec, full, pre, n, row_err):
    """Where decode and a full forward over n tokens routed differently,
    summed over the MoE layers, per row: the expert choices of decode at
    the checked token (the last, decode step n - 1 - PROMPT) that the
    forward did not make there; the forward's assignments at that token
    that it dropped (decode never drops); the choices and drops that differ
    at the decode tokens before it; and, against the served prefill's
    routings `pre`, the prompt assignments that the two kept differently or
    chose differently (the decode cache holds the prefill's k/v, the
    forward recomputes them). `dec` holds each decode step's routings up to
    the checked token's."""
    B, K = dec[0][0].top_i.shape[1], dec[0][0].top_i.shape[2]
    rows = {key: full[0].top_i.new_zeros(B) for key in ROUTING_KEYS}
    for layer, (f, p) in enumerate(zip(full, pre)):
        f_i, f_keep = f.top_i.reshape(B, n, K), f.keep.reshape(B, n, K)
        p_i, p_keep = p.top_i.reshape(B, PROMPT, K), p.keep.reshape(B, PROMPT, K)
        for j, step in enumerate(dec):
            at = PROMPT + j
            diff = (_not_chosen(step[layer].top_i.reshape(B, 1, K), f_i[:, at:at + 1]),
                    (~f_keep[:, at]).sum(-1))
            if at == n - 1:
                rows["flips"] += diff[0]
                rows["dropped"] += diff[1]
            else:
                rows["earlier"] += diff[0] + diff[1]
        rows["prompt_kept"] += (p_keep != f_keep[:, :PROMPT]).reshape(B, -1).sum(-1)
        rows["prompt_chosen"] += _not_chosen(p_i, f_i[:, :PROMPT])
    info = {key: v.tolist() for key, v in rows.items()}
    info.update(row_err=row_err.tolist(), layers=len(full), k=K)
    return info


def same_routing_rows(checks):
    """[(position, row, err, max |logit|)] of the checked rows that decode
    and the forward routed the same at every token (no key of
    _routing_diffs counts anything for the row)."""
    return [(pos, b, r["row_err"][b], scale) for pos, (_, scale, *info) in checks.items()
            for r in info for b in range(len(r["row_err"]))
            if not any(r[key][b] for key in ROUTING_KEYS)]


def decode_vs_forward(model, seq, dec_logits, memory=None, pre_routes=None, dec_routes=None):
    """{position: (max abs err, max |logit|[, routing info])} of the decode
    logits at positions PROMPT and PROMPT+STEPS-1 against a full forward of
    `model` over seq up to them (with the served `memory`); with the MoE
    routings of the prefill and of each decode step, also _routing_diffs'
    counts and each row's max abs err."""
    checks = {}
    for step in (0, STEPS - 1):
        n = PROMPT + step + 1
        with recorded_layers(resid=False) as (full_routes, _):
            full, _ = model.prefill(seq[:, :n], n, memory=memory)
        err = (dec_logits[step] - full).abs().amax(-1)
        checks[n - 1] = (err.max().item(), full.abs().max().item())
        if dec_routes and dec_routes[step]:
            checks[n - 1] += (_routing_diffs(dec_routes[:step + 1], full_routes, pre_routes,
                                             n, err),)
    return checks


def f32_replay(torch, cfg, seq, toks, cache_dtype, memory=None, liveness=False):
    """decode_vs_forward on an f32 copy of the weights of `cfg` (the served
    config, or replay_config's cut of it, gates at GATE), fed the served
    run's tokens and memory, with every decode cache (the SSD and RG-LRU
    conv histories, the attention k/v) kept in `cache_dtype`, and each
    decode step's routing recorded; with `liveness`, the replay's prefill
    logits must move with the memory by more than F32_DECODE_RTOL."""
    from repro_torch.models import Model, attention, rglru, ssm
    slots = ((ssm, "CACHE_CONV_DTYPE"), (rglru, "CACHE_CONV_DTYPE"),
             (attention, "CACHE_DTYPE"))
    saved = [getattr(mod, name) for mod, name in slots]
    for mod, name in slots:
        setattr(mod, name, cache_dtype)
    try:
        model = Model(cfg, device="cuda", seed=SEED).float()
        set_gates(torch, model)
        with recorded_layers(resid=False) as (pre_routes, _):
            logits, cache = model.prefill(seq[:, :PROMPT], PROMPT + STEPS, memory=memory)
        if liveness:
            check_memory_moves_logits(torch, f"{cfg.name} f32", logits, model.prefill(
                seq[:, :PROMPT], PROMPT, memory=stub_memory(torch, cfg, SEED + 3))[0],
                F32_DECODE_RTOL)
        replay, routes = [], []
        for tok in toks[:-1]:
            with recorded_layers(resid=False) as (r, _):
                logits, cache = model.decode_step(tok, cache)
            replay.append(logits)
            routes.append(r)
        return decode_vs_forward(model, seq, replay, memory, pre_routes, routes)
    finally:
        for (mod, name), value in zip(slots, saved):
            setattr(mod, name, value)


def _fmt_routing(r):
    """_routing_diffs' counts, summed and by row."""
    B, n = len(r["row_err"]), r["layers"] * r["k"]
    tot = {key: sum(r[key]) for key in ROUTING_KEYS}
    rows = "; ".join(f"row {b}: err {r['row_err'][b]:.4g}, {r['flips'][b]} flipped, "
                     f"{r['dropped'][b]} dropped, earlier decode tokens {r['earlier'][b]}, "
                     f"prompt {r['prompt_kept'][b]} kept and {r['prompt_chosen'][b]} chosen "
                     "differently" for b in range(B))
    return (f"; over {r['layers']} MoE layers: {tot['flips']} of {B * n} expert choices of "
            f"decode not the forward's, the forward dropped {tot['dropped']} of its "
            f"{B * n} assignments at this token; {tot['earlier']} choices or drops differ "
            f"at the decode tokens before it; of the {B * PROMPT * n} prompt assignments "
            f"{tot['prompt_kept']} kept and {tot['prompt_chosen']} chosen differently by "
            f"the served prefill and the forward [{rows}]")


def _fmt_checks(checks):
    return ", ".join(f"pos {p}: max abs err {c[0]:.4g} (max |logit| {c[1]:.4g}"
                     + (_fmt_routing(c[2]) if len(c) > 2 else "") + ")"
                     for p, c in checks.items())


# buckets whose every kernel the profile lines list by name
NAMED_BUCKETS = ("ssd", "ssd_bwd", "rglru", "rglru_bwd")


def _bucket(name):
    if "flash_fwd_" in name:
        return "flash_attention"
    if "flash_bwd_" in name:
        return "flash_attention_bwd"
    if "ssd_bwd_" in name:
        return "ssd_bwd"
    if "ssd_" in name:
        return "ssd"
    if "rglru_bwd_" in name:
        return "rglru_bwd"
    if "rglru_" in name:
        return "rglru"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    return "other"


def _short(kernel_name):
    """A kernel's name without its namespaces' noise, cut to 100 characters."""
    return kernel_name.replace("void ", "").replace("at::native::", "")[:100]


def profile_window(torch, fn):
    """torch.profiler over fn(): (fn's result, wall seconds, {bucket: device
    us}, device operations, {bucket: [(us, count, kernel)]} of the "other"
    bucket's five largest and every kernel of NAMED_BUCKETS)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    buckets, by_name, n_ops = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        bucket = _bucket(e.key)
        buckets[bucket] = buckets.get(bucket, 0.0) + us
        by_name.setdefault(bucket, []).append((us, e.count, e.key))
        n_ops += e.count
    named = {k: sorted(v, reverse=True)[:None if k in NAMED_BUCKETS else 5]
             for k, v in by_name.items() if k in NAMED_BUCKETS or k == "other"}
    return out, wall, buckets, n_ops, named


def log_window(arch, what, wall, b, n, named):
    """Print one profiler window: kernel time by bucket, busy and idle share,
    and the named kernels. Returns {bucket: ms} (empty if not measured)."""
    busy = sum(b.values()) / 1e3
    if not busy:
        log(f"[profile] {arch} {what}: device time not measured (the profiler "
            "saw no kernels)")
        return {}
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / 1e3 / busy:.1%})"
                      for k, v in sorted(b.items(), key=lambda kv: -kv[1]))
    log(f"[profile] {arch} {what}: wall {wall * 1e3:.3f} ms, kernels {busy:.3f} ms "
        f"(busy {busy / (wall * 1e3):.1%}, idle {1 - busy / (wall * 1e3):.1%}), "
        f"{n} device operations; {parts}")
    for bucket, kernels in sorted(named.items()):
        log(f"[profile] {arch} {what}, "
            + ("largest in other: " if bucket == "other" else f"{bucket} kernels: ")
            + "; ".join(f"{_short(key)} x{count} {us / 1e3:.3f} ms"
                        for us, count, key in kernels))
    return {k: v / 1e3 for k, v in b.items()}


def profile_serving(torch, prefill, decode, sample_token, prompt, steps, arch, memory=None):
    """Where the device time goes: torch.profiler over one prefill (with the
    served `memory`) and over `steps` decode steps; kernel time by bucket,
    the five largest kernels of the "other" bucket and every kernel of the
    buckets in NAMED_BUCKETS by name, and kernel time over the window's wall
    time (the device's busy share; the rest is idle)."""

    def decode_steps(cache, tok):
        for _ in range(steps):
            logits, cache = decode(tok, cache)
            tok = sample_token(logits)
        return cache

    (logits, cache), *prefill_window = profile_window(torch, lambda: prefill(prompt, memory))
    _, *decode_window = profile_window(torch, lambda: decode_steps(cache, sample_token(logits)))
    for what, window in (("prefill", prefill_window), (f"decode x{steps}", decode_window)):
        log_window(arch, what, *window)


# the model-level gradient check: |FD - <g, v>| <= FD_RTOL |<g, v>|. Along a
# random direction of ~850 M weights <g, v> is ~1e-5, so a step of FD_STEP of
# the norm of the weights it moves changes a loss of 12.5 by ~1e-5: ten f32
# ulps of it. The loss of the difference is therefore Model.loss's formula
# reduced in f64 from the model's f32 logits (_loss64), and the central
# difference is extrapolated from steps eps and eps / 2 (Richardson:
# (4 D(eps/2) - D(eps)) / 3, error O(eps^4)). A direction whose <g, v> is
# smaller still takes a longer step (TRAINED's fd_steps), so that the loss
# moves well above the rounding of the f32 forward.
FD_RTOL, FD_STEP = 1e-2, 1e-3
# A MoE arch's loss is piecewise smooth: each token's top-k experts (and so
# the kept assignments) are constant between the weights where two gates
# tie. Autograd differentiates the branch the forward took, with the expert
# ids and slots as constants, so the finite difference is taken on that
# branch: every evaluation routes with the unperturbed forward's ids and
# slots and recomputes the gates and weights from its own weights
# (pinned_routing). Left free, the routing flips: the full-width two-layer
# mixtral-8x7b at B 1 x S 2048 has gates within 8.3e-7 of a tie, and every
# step from 1e-3 down to 1e-8 of the leaves' norm re-routed 6 to 7,526
# tokens between the unperturbed forward and an evaluation on an H100, so
# that the central difference measured a jump of the loss, not its slope
# (PERF.md, the MoE findings). The step along the MoE arch's directions is
# shorter than FD_STEP: at FD_STEP the router moves by more than its own
# norm
MOE_FD_STEP = 1e-5


def _loss64(torch, model, batch):
    """Model.loss's total (CE + 1e-4 z-loss + 0.01 aux) reduced in f64 from
    the model's f32 logits and its f32 MoE aux loss (0 without experts)."""
    logits, aux = model.apply(batch["tokens"], memory=batch.get("memory"), return_aux=True)
    logits = logits.double()
    labels = batch["labels"]
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).double()
    n = mask.sum().clamp_min(1.0)
    return ((nll * mask).sum() / n + 1e-4 * (lse.square() * mask).sum() / n
            + 0.01 * aux.double()).item()


def _dot64(a, b):
    """sum(a * b) over two tensors of one shape, in f64, a slice of 2^24
    elements at a time: a whole-leaf f64 copy of llama-3.2-vision-90b's
    1.05 B-parameter embedding is 8.4 GB."""
    n = 1 << 24
    return sum((x.double() * y.double()).sum()
               for x, y in zip(a.reshape(-1).split(n), b.reshape(-1).split(n)))


def _unit_direction(torch, params, names, g):
    """A random direction over the leaves `names`: each leaf's draw scaled
    to norm 1, the whole to norm 1 (so that small leaves weigh as much as
    the embedding)."""
    v = {}
    for k in names:
        x = torch.randn(params[k].shape, generator=g, device="cuda", dtype=torch.float32)
        v[k] = x / x.norm()
    return {k: x / len(v) ** 0.5 for k, x in v.items()}


def _rglru_gate_leaf(k):
    return ".mixer." in k and any(k.endswith(f".{leaf}")
                                  for leaf in ("w_a", "b_a", "w_i", "b_i", "lam"))


# each trained arch: by layer kind (K1_KINDS for K1's), the kernels (forward,
# backward) a layer of that kind launches once each; the training config's
# cut, if any; for an arch with a gradient check its two-layer cut
# (superblock, repeats, and any other change), the leaves whose gradient
# reaches the loss only through those kernels, if any a refill (label, the
# leaves to fill, the value) after which those leaves are checked again, and
# if any a longer FD step by direction. granite-3-8b and gemma3-12b repeat K1
# shapes that qwen3-8b's and gemma3-4b's checks cover (hd 128 over GQA 4; hd
# 256, windowed and global), so they have none
_K1 = ("flash_attention", "flash_attention_bwd")
TRAINED = {
    ARCH: {"kernels": {"local": _K1, "global": _K1},
           "superblock": ("local", "global"), "sb_repeat": 1,
           "leaves": ("attention leaves", lambda k: ".attn." in k)},
    SSM_ARCH: {"kernels": {"ssd": ("ssd", "ssd_bwd")},
               "superblock": ("ssd",), "sb_repeat": 2,
               "leaves": ("mixer leaves", lambda k: ".mixer." in k and any(
                   f".{leaf}" in k for leaf in ("A_log", "dt_bias", "in_B", "in_C", "in_dt",
                                                "in_x", "conv_")))},
    RG_ARCH: {"kernels": {"rglru": ("rglru_scan", "rglru_scan_bwd"), "local": _K1},
              "train_cut": RG_TRAIN_CUT,
              "superblock": ("rglru",), "sb_repeat": 2,
              "leaves": ("gate leaves", _rglru_gate_leaf),
              # softplus(-7) = 9.1e-4, so a = exp(-8 r softplus(lam)) > 0.9927:
              # g carries across the 32 chunks of a sequence
              "refill": ("gate leaves, lam = -7", lambda k: k.endswith(".lam"), -7.0),
              # with the reference's decay (a < 1.5e-4) only w_i and b_i of the
              # gate leaves move the loss: <g, v> was 5.5e-6 on the card, where
              # steps eps and eps / 2 of FD_STEP fell 0.8% either side of it
              # (rounding, not curvature); the loss is near linear along it
              "fd_steps": {"gate leaves": 16 * FD_STEP, "gate leaves, lam = -7": 4 * FD_STEP}},
    QWEN: {"kernels": {"global": _K1}, "train_cut": DENSE_TRAIN_CUTS[QWEN],
           "superblock": ("global",), "sb_repeat": 2,
           "leaves": ("attention leaves", lambda k: ".attn." in k)},
    GRANITE: {"kernels": {"global": _K1}, "train_cut": DENSE_TRAIN_CUTS[GRANITE]},
    G12: {"kernels": {"local": _K1, "global": _K1}, "train_cut": DENSE_TRAIN_CUTS[G12]},
    # the MoE leaves reach the loss through the einsums, not a kernel; they
    # are the layer this arch adds, so they are its second direction. The
    # loss is piecewise smooth in the weights (the routing is piecewise
    # constant), and its differences are taken on the unperturbed forward's
    # routing (pinned_routing)
    MIXTRAL: {"kernels": {"local": _K1}, "train_cut": MOE_TRAIN_CUTS[MIXTRAL],
              "superblock": ("local",), "sb_repeat": 2,
              "leaves": ("MoE leaves", lambda k: ".moe." in k),
              "fd_steps": {"every leaf": MOE_FD_STEP, "MoE leaves": MOE_FD_STEP}},
    DBRX: {"kernels": {"global": _K1}, "train_cut": MOE_TRAIN_CUTS[DBRX]},
    # the cross-attention archs' second direction is the layer they add: the
    # encoder, the xattn sub-layers and their gates (seamless: one encoder and
    # one decoder layer); the cross layer with its gate (llama: its training
    # cut, global then cross)
    SEAMLESS: {"kernels": {"global": _K1, "xattn": _K1, "enc": _K1},
               "superblock": ("global",), "sb_repeat": 1, "grad_cut": {"encoder_layers": 1},
               "leaves": ("encoder, xattn and gate leaves",
                          lambda k: k.startswith("encoder.") or ".xattn." in k)},
    LLAMA: {"kernels": {"global": _K1, "cross": _K1}, "train_cut": CROSS_TRAIN_CUTS[LLAMA],
            "superblock": ("global", "cross"), "sb_repeat": 1,
            "leaves": ("cross layer and gate leaves", lambda k: k.startswith("layers.1.attn."))},
}


def _launches_per_step(cfg, arch, counters, remat):
    """{kernel: launches} of one forward and backward of `cfg`: each layer
    kind's forward and backward kernels (TRAINED[arch]["kernels"]) once per
    layer of the kind (kind_layers: an xattn sub-layer and an encoder layer
    count as layers), and with `remat` (full) the forward again for each
    layer of the kind that remat recomputes; 0 for the rest."""
    want = {name: 0 for name in counters}
    for kind, (fwd, bwd) in TRAINED[arch]["kernels"].items():
        n_layers, n_rematted = kind_layers(cfg, kind)
        want[fwd] += n_layers + (n_rematted if remat else 0)
        want[bwd] += n_layers
    return want


def phase_grad_check(torch, arch):
    """Full-width, two-layer `arch` (gemma3-4b: one local, one global layer;
    qwen3-8b: two global layers; mamba2-780m and recurrentgemma-9b: two
    layers of their recurrent block;
    B 1, S 2048, so gemma's window is live, mamba2 runs 8 chunks and the
    RG-LRU scan 32) in f32: the gradient from the arch's kernel's forward and
    backward against a central finite difference of the loss along random
    directions, over every leaf and over the leaves whose gradient reaches
    the loss only through that kernel (TRAINED; mixtral-8x7b: its MoE
    leaves); where TRAINED names a refill, those leaves again after it. The
    forwards of the difference run the forward kernel without autograd, and
    route every MoE layer with the unperturbed forward's expert ids and
    slots (pinned_routing, MOE_FD_STEP), each evaluation logging how many
    tokens it would have routed otherwise."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Model
    from repro_torch.train.data import DataConfig, make_batch

    counters = _launch_counters()
    spec = TRAINED[arch]
    cfg = get_config(arch).replace(
        name=f"{arch}-2layer", num_layers=len(spec["superblock"]) * spec["sb_repeat"],
        superblock=spec["superblock"], sb_repeat=spec["sb_repeat"], remainder=(),
        **spec.get("grad_cut", {}))
    model = Model(cfg, device="cuda", seed=SEED, trainable=True).float()
    n_gates = set_gates(torch, model)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=1), 0, device="cuda")
    if model.memory_len():
        # the served stub memory (std 1): at the data's 0.02 the keys of a
        # cross layer are so small that its attention is near uniform
        batch["memory"] = stub_memory(torch, cfg, SEED + 2, batch=1)
        log(f"[grad] {cfg.name}: every gate ({n_gates}) set to {GATE}; bf16 stub memory "
            f"{tuple(batch['memory'].shape)} (std 1)")
    params = dict(model.named_parameters())
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    kernel_label, kernel_leaf = spec["leaves"]
    rounds = [("", [("every leaf", sorted(params)),
                    (kernel_label, sorted(k for k in params if kernel_leaf(k)))])]
    if "refill" in spec:
        label, leaf, value = spec["refill"]
        rounds.append((leaf, [(label, sorted(k for k in params if kernel_leaf(k)))]))
    want = _launches_per_step(cfg, arch, counters, remat=False)
    out = {}
    for refill, directions in rounds:
        if refill:
            with torch.no_grad():
                for k in params:
                    if refill(k):
                        params[k].fill_(value)
        for fn in counters.values():
            fn.launches = 0
        with recorded_layers() as (routes0, _):
            loss, _ = model.loss(batch)
        loss.backward()
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        if got != want:
            fail(f"gradient check {arch}: launches {got}, want {want}")
        grads = {}
        for k, p in params.items():             # taken from the model, not copied
            grads[k], p.grad = p.grad.detach(), None
        orig = {k: p.detach().clone() for k, p in params.items()}
        L0 = loss.item()
        for label, names in directions:
            v = _unit_direction(torch, params, names, g)
            gv = sum(_dot64(grads[k], v[k]) for k in names).item()
            step = spec.get("fd_steps", {}).get(label, FD_STEP)
            eps = step * sum(_dot64(orig[k], orig[k]) for k in names).sqrt().item()

            flips = []

            def central(e):
                side = {}
                with torch.no_grad():
                    for sign in (1, -1):
                        for k in names:
                            params[k].copy_(orig[k]).add_(v[k], alpha=sign * e)
                        with pinned_routing(routes0) as natural:
                            side[sign] = _loss64(torch, model, batch)
                        if len(natural) != len(routes0):
                            fail(f"gradient check {arch} over {label}: {len(natural)} MoE "
                                 f"routings pinned, want {len(routes0)}")
                        flips.append(sum(int((r.top_i != r0.top_i).any(-1).sum())
                                         for r, r0 in zip(natural, routes0)))
                    for k in names:
                        params[k].copy_(orig[k])
                return (side[1] - side[-1]) / (2 * e)

            d1, d2 = central(eps), central(eps / 2)
            fd = (4 * d2 - d1) / 3
            rel = abs(fd - gv) / abs(gv)
            out[label] = {"leaves": len(names), "step": step, "eps": eps, "fd": fd, "fd_eps": d1,
                          "fd_eps_half": d2, "grad_dot_v": gv, "rel_err": rel, "loss": L0}
            pinned = ""
            if routes0:
                out[label]["tokens_rerouted_if_free"] = flips
                pinned = (f"; routing pinned to the unperturbed forward's in {len(routes0)} "
                          f"MoE layers, where a free routing would have moved {max(flips)} "
                          "tokens at most")
            log(f"[grad] {cfg.name} f32 (B 1, S {TRAIN_SEQ}), direction over {label} "
                f"({len(names)}): <g, v> {gv:.6g}, FD {fd:.6g} (central {d1:.6g} at eps "
                f"{eps:.4g} = {step:g} of the leaves' norm, {d2:.6g} at eps / 2; loss "
                f"{L0:.6f}); rel err {rel:.3g} "
                f"(tol {FD_RTOL}){pinned}")
            if not (math.isfinite(rel) and rel <= FD_RTOL):
                fail(f"gradient check {arch} over {label}: FD {fd:.6g} vs <g, v> {gv:.6g}, "
                     f"rel err {rel:.3g} > {FD_RTOL}")
        del grads, orig, v, loss
    del model, params
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def pinned_routing(routes0, local=None):
    """While active, the i-th ``moe.route`` call routes with routes0[i]'s
    expert ids, kept assignments and slots, and computes the gates and the
    renormalised top-k weights of those ids from its own router and input:
    the loss on the branch routes0 was taken on. Under a mesh each rank
    routes its own groups: `local` cuts a whole (G, ...) table to them.
    Yields the routings the calls would have chosen left free."""
    from repro_torch.models import moe
    route, natural = moe.route, []

    def pinned(router, xt, cfg, cap):
        r = route(router, xt, cfg, cap)
        r0 = routes0[len(natural)]
        if local is not None:
            # the tables it pins (the gates of a recorded training step
            # carry its autograd graph, which a simulated rank's cut refuses)
            r0 = r0._replace(top_i=local(r0.top_i), keep=local(r0.keep), slot=local(r0.slot))
        natural.append(r)
        top_w = r.gates.gather(-1, r0.top_i)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        return r._replace(top_w=top_w, top_i=r0.top_i, keep=r0.keep, slot=r0.slot)

    moe.route = pinned
    try:
        yield natural
    finally:
        moe.route = route


def phase_autograd_on_card(torch):
    """Under autograd on the card ops.ssd and ops.rglru_scan each run their
    forward and backward kernels (one launch each; the gradients against the
    plain backward at SSD_BWD_RTOL and RGLRU_BWD_RTOL x max(1, max |ref|))."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rglru import rglru_scan_bwd, rglru_scan_fwd
    from repro_torch.kernels.ssd import ssd_bwd, ssd_fwd

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    ssd_args = [t.requires_grad_() for t in ssd_inputs(torch, g, 1, 100, 2, 16, 8)]
    # a in (0.99, 1) over 4 chunks and a ragged one, 130 channels
    rg_args = [t.requires_grad_() for t in rglru_inputs(torch, g, (2, 300, 130), True)]
    for name, (fwd, bwd), args, call, plain, rtol in (
            ("ssd", (ssd_fwd, ssd_bwd), ssd_args, lambda *x: ops.ssd(*x, chunk=32)[0],
             lambda *x: ref.ssd_bwd_oracle(*x, chunk=32), SSD_BWD_RTOL),
            ("rglru_scan", (rglru_scan_fwd, rglru_scan_bwd), rg_args, ops.rglru_scan,
             lambda a, b, dh: ref.rglru_scan_bwd_oracle(a, ref.rglru_scan_oracle(a, b), dh),
             RGLRU_BWD_RTOL)):
        before = (fwd.launches, bwd.launches)
        y = call(*args)
        dy = torch.randn(y.shape, generator=g, device="cuda")
        got = torch.autograd.grad(y, args, dy)
        torch.cuda.synchronize()
        launches = (fwd.launches - before[0], bwd.launches - before[1])
        if launches != (1, 1):
            fail(f"ops.{name} under autograd on the card: {launches} (forward, backward) "
                 "launches, want (1, 1)")
        want = plain(*(t.detach() for t in args), dy)
        err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                  for a, b in zip(got, want))
        if not err <= rtol:
            fail(f"ops.{name} under autograd on the card: gradient err {err:.3g} > {rtol}")
        log(f"[train] {name} under autograd on the card runs its forward and backward "
            f"kernels (one launch each); gradient err {err:.3g} x max(1, max |ref|) "
            f"(tol {rtol})")


def phase_train(torch, card, arch, count_flops=False):
    """Train `arch` at full width, the serve phase's config at full depth or
    cut as TRAINED[arch]["train_cut"] says: TRAIN_STEPS steps of B
    TRAIN_BATCH x S TRAIN_SEQ from the port's data, remat full, one
    microbatch. Gates: finite losses and gnorms; per step the launches remat
    full implies of each layer kind's forward and backward kernels,
    TRAINED[arch]["kernels"] (a forward per layer of the kind, again for each
    layer of the kind in the rematted superblocks, and a backward per layer
    of the kind); no other kernel. With `count_flops`, one more step under
    FlopCounterMode (untimed). Returns the run's numbers and launches."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Model
    from repro_torch.train.data import DataConfig, DataIterator
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_config(arch).replace(**TRAINED[arch].get("train_cut", {}))
    counters = _launch_counters()
    want = _launches_per_step(cfg, arch, counters, remat=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=SEED, trainable=True)
    n_gates = set_gates(torch, model)
    step_fn = make_train_step(model, OptConfig(**TRAIN_OPT), ParallelConfig(**TRAIN_PAR))
    state = init_train_state(model)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    log(f"[train] {cfg.name}: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params, "
        f"state (bf16 params, f32 mu and nu) {state_bytes / 1e9:.2f} GB, made in "
        f"{time.perf_counter() - t0:.1f}s"
        + (f"; every gate ({n_gates}) set to {GATE}, the data's stub memory "
           f"({model.memory_len()} x {cfg.d_model}, bf16 x 0.02) in every batch"
           if n_gates else ""))
    it = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, memory_len=model.memory_len(),
                                 d_model=cfg.d_model), device="cuda")
    for fn in counters.values():                   # the main path's run starts here
        fn.launches = 0
    losses, gnorms, auxes, times = [], [], [], []
    for i in range(TRAIN_STEPS):
        before = {name: fn.launches for name, fn in counters.items()}
        batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
        auxes.append(float(metrics["aux"]))
        per_step = {name: fn.launches - before[name] for name, fn in counters.items()}
        if per_step != want:
            fail(f"train {arch} step {i}: launches {per_step}, want {want}")
        log(f"[train] step {i}: loss {losses[-1]:.6f}, gnorm {gnorms[-1]:.6g}, "
            + (f"aux {auxes[-1]:.6f}, " if cfg.num_experts else "")
            + f"lr {metrics['lr']:.3g}, {times[-1] * 1e3:.2f} ms")
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms + auxes):
        fail(f"train {arch}: non-finite loss, gnorm or aux: {losses}, {gnorms}, {auxes}")
    step_ms = statistics.median(times[1:]) * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    log(f"[train] {cfg.name} B {TRAIN_BATCH} x S {TRAIN_SEQ}, remat full, {TRAIN_STEPS} "
        f"steps: losses {[round(x, 6) for x in losses]}"
        + (f", aux {[round(x, 6) for x in auxes]}" if cfg.num_experts else "")
        + "; median step (steps 2-"
        f"{TRAIN_STEPS}) {step_ms:.2f} ms, {tok_s:.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB ({peak} bytes); launches {launches} ({want} a step); {card}")
    flops = count_flops_of(torch, lambda: step_fn(state, next(it))) if count_flops else None
    _, *window = profile_window(torch, lambda: step_fn(state, next(it)))
    buckets = log_window(cfg.name, "train step", *window)
    del model, state, step_fn, it, batch, metrics
    torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.num_layers, "losses": losses, "gnorms": gnorms,
            **({"aux": auxes} if cfg.num_experts else {}),
            "step_ms": step_ms, "tokens_per_s": tok_s, "flops": flops,
            "peak_bytes": peak, "state_bytes": state_bytes, "launches": launches,
            "launches_per_step": want,
            "step_times_ms": [t * 1e3 for t in times], "profile_ms": buckets}


# ---------------------------------------------------------------------------
# mesh (phase 8)
# ---------------------------------------------------------------------------

# the serving path under a mesh: every rank of the mesh simulated in this
# process on the one card (parallel.mesh.simulated_ranks, LocalTensorMode),
# so each K1 call launches once for each rank. Each run: the sharded
# prefill's logits against the unsharded prefill of the same weights, within
# rule x max |logit|: bf16 rounds differently where the ranks sum partial
# products (PERF.md's bf16 rule, DECODE_RTOL), f32 only in summation order
# (1e-3); then `steps` decode steps under the mesh from the prefill's cache,
# fed the unsharded run's greedy tokens, each step's logits against the
# unsharded decode's from the unsharded cache by the same rule. gemma3-4b on
# (2, 4) at full width as one superblock (5 local + 1 global layers): 2 q
# heads and 1 kv head a rank; qwen3-8b at full width and 1 layer on (8, 16),
# the production mesh's model axis: 2 q heads a rank and its 8 kv heads whole
# on every rank (the GQA trap), 8 sequences so that each data rank takes one,
# as on the production mesh (16, 16), where it ran until the RG-LRU runs came
# in (128 ranks take half its ~120 s); its f32 check runs on (2, 16) at 2
# layers, the same split of the heads: on (16, 16) each of the 16 data ranks
# would gather the f32 weights whole over its embed dim (FSDP), 16 x 4.1 GB,
# more than the card holds beside the rest. The last run is long_500k's setting (seq_shard_cache): one
# sequence, its cache of 8192 and the local layers' rings of 1024 split by
# length over the data axis, decode as flash-decoding over them. LocalTensorMode
# runs each operator once a rank, one rank after another (~0.7 s a layer and
# a decode step on 8 ranks, ~17 s a layer on 256): the bf16 gemma3-4b run
# was cut from 34 layers and qwen3-8b's 256 ranks from 2 when decode came in,
# and the dense runs from 4 decode steps to 2 (and the mesh train run from 3
# steps to 2) when the RG-LRU runs came in, to keep chip_smoke.py within its
# time.
# The MoE archs at full width and 2 layers, B 4 x 2048 in bf16, decoding 2
# steps: dbrx-132b on (2, 4), expert parallelism (4 of its 16 experts a model
# rank), and mixtral-8x7b on (2, 16), whose 8 experts do not divide 16, so
# that ff goes over the model axis; each routes in 2 dispatch groups (one a
# data rank), and its unsharded twin in the same 2 (Ctx.moe_groups). Gates
# at full width lie within 1e-6 of a tie (PERF.md, the MoE findings), so
# the sharded run's summation order flips choices: it is held to the
# unsharded run with its routing pinned to the unsharded run's expert ids
# (pinned_routing, each rank its own groups); the choices a free sharded
# prefill flips, and those the pinned run would have made free, are counted
# and printed. Bytes: dbrx-132b's 2 layers are 7.75 B parameters (15.5 GB
# of bf16: 6.5 GB a layer, 2.5 GB of embedding and unembedding), sharded in
# place after the unsharded run; each rank gathers its experts' FSDP shards
# one weight at a time (8 x 0.53 GB) and the expert outputs of its group
# (8 x 0.25 GB). recurrentgemma-9b at full width and 5 layers, one superblock
# (RG-LRU, RG-LRU, local) and the (RG-LRU, RG-LRU) remainder, on (2, 4): each
# rank scans its 1024 of the 4096 RG-LRU channels over the whole sequence
# (K3 launches 4 layers x 8 ranks = 32 times a prefill) and its local layer
# runs 4 q heads over the one kv head; 0.98 B parameters in the 5 layers and
# 1.05 B of embedding: about 4 GB in bf16 and 8 GB in f32
class MeshRun(NamedTuple):
    arch: str
    layers: int | None          # None: all
    shape: tuple
    batch: int
    seq: int
    dtype: str
    rtol: float
    steps: int                  # decode steps after the prefill
    cache: int = 0              # the cache's length; 0: seq + steps
    seq_shard_cache: bool = False


MESH_RUNS = (
    MeshRun(ARCH, 6, (2, 4), BATCH, PROMPT, "bfloat16", DECODE_RTOL, 2),
    MeshRun(ARCH, 6, (2, 4), BATCH, PROMPT, "float32", 1e-3, 2),
    MeshRun(QWEN, 1, (8, 16), 8, PROMPT, "bfloat16", DECODE_RTOL, 2),
    MeshRun(QWEN, 2, (2, 16), BATCH, PROMPT, "float32", 1e-3, 2),
    MeshRun(ARCH, 6, (2, 4), 1, PROMPT, "float32", 1e-3, 2, cache=8192, seq_shard_cache=True),
    MeshRun(DBRX, 2, (2, 4), BATCH, PROMPT, "bfloat16", DECODE_RTOL, 2),
    MeshRun(MIXTRAL, 2, (2, 16), BATCH, PROMPT, "bfloat16", DECODE_RTOL, 2),
    MeshRun(RG_ARCH, 5, (2, 4), BATCH, PROMPT, "bfloat16", DECODE_RTOL, 4),
    MeshRun(RG_ARCH, 5, (2, 4), BATCH, PROMPT, "float32", 1e-3, 4),
)
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# the decode cache is bf16 whatever the params (attention.CACHE_DTYPE, and
# rglru.CACHE_CONV_DTYPE for the RG-LRU conv history): an f32 k a summation
# order apart rounds to one bf16 ulp apart, 2^-7 of the largest. Layer 0's
# cache is checked up to CACHE_CHECK_RANKS ranks: whole on each of qwen3-8b's
# 256 simulated ranks its k would take 17 GB
CACHE_RTOL, CACHE_CHECK_RANKS = 2.0 ** -7, 8


def layer0_cache(cache):
    """The tensors of layer 0's decode cache that phase 8 holds: an attention
    layer's k, a recurrent layer's h and conv history."""
    c = cache["layers"][0]
    return {"k": c["attn"]["k"]} if "attn" in c else dict(c["mixer"])


def mesh_config(get_config, arch, layers):
    cfg = get_config(arch)
    if layers is None:
        return cfg
    nsb = len(cfg.superblock)
    return cfg.replace(name=f"{arch}-{layers}layer", num_layers=layers,
                       sb_repeat=layers // nsb, remainder=cfg.remainder[:layers % nsb])


def rank_groups(mesh, groups):
    """A function that cuts a whole (G, ...) routing table to each simulated
    rank's dispatch groups: G / dp of them at the rank's index along the
    data-parallel mesh dims (pod, data) in mesh order, as the groups follow
    the batch rows over those dims (moe._to_groups)."""
    from repro_torch.parallel.mesh import coordinate, rank_map
    dims = [i for i, n in enumerate(mesh.mesh_dim_names) if n in ("pod", "data")]
    n = groups // math.prod(mesh.size(i) for i in dims)

    def index(r):
        c, i = coordinate(mesh, r), 0
        for d in dims:
            i = i * mesh.size(d) + c[d]
        return i

    return lambda t: rank_map(lambda r: t[index(r) * n:(index(r) + 1) * n])


def routing_flips(torch, mode, mesh, natural, routes0, local):
    """[[tokens whose chosen experts differ, tokens whose order of them
    differs], ...] for each MoE call of a sharded run (`natural`: its
    routings, or a pinned run's choices left free) against the unsharded
    run's, summed over the data-parallel ranks (the model ranks of a data
    rank route alike)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial() if n in ("pod", "data") else Replicate() for n in mesh.mesh_dim_names]
    out = []
    for r, r0 in zip(natural, routes0):
        a, b = r.top_i, local(r0.top_i)
        counts = torch.stack([(a.sort(-1).values != b.sort(-1).values).any(-1).sum(),
                              (a != b).any(-1).sum()])
        whole = DTensor.from_local(counts, mesh, pl, run_check=False).full_tensor()
        with mode.disable():
            out.append(whole.reconcile().tolist())
    return out


def phase_mesh(torch, card, runs=MESH_RUNS):
    """`runs` (MESH_RUNS): each config's prefill sharded over its mesh under the
    rules of the default ParallelConfig (tp, fsdp, sequence parallel; and
    seq_shard_cache where the run says), every rank simulated on the card,
    against the unsharded prefill of the same seeded weights and tokens;
    then decode under the mesh from the sharded prefill's cache, each step
    against the unsharded decode from the unsharded cache, both fed the
    unsharded run's greedy tokens. An MoE arch's unsharded run routes in
    the mesh's dispatch groups; a free sharded prefill prints the choices
    its summation order flips, and the checked sharded run's routing is
    pinned to the unsharded run's expert ids.
    Launch counts are reset just before the
    sharded prefill and read just after: K1 launches ranks x layers times
    and no other kernel runs; reset again just before the decode steps and
    read just after: no kernel launches in decode. Returns {path: launches,
    ms and the decode's readings}."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Ctx, Model, attention, rglru
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, simulated_ranks
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step
    from repro_torch.train.train_step import moe_groups

    import torch.distributed._local_tensor as local_tensor
    log(f"[mesh] torch {torch.__version__}: LocalTensorMode "
        f"{'present' if hasattr(local_tensor, 'LocalTensorMode') else 'MISSING'}")
    counters = _launch_counters()

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    out, t_decode_all = {}, 0.0
    cache_dtype, conv_dtype = attention.CACHE_DTYPE, rglru.CACHE_CONV_DTYPE
    for run in runs:
        arch, layers, shape, batch, seq, dtype, rtol, steps, cache_len, seq_shard = run
        t_run = time.perf_counter()
        # an f32 run holds the mesh to f32 summation order alone, so its
        # decode cache is f32 too: in bf16 two sums some ulps apart can round
        # a cached value one bf16 ulp apart (as f32_replay's caches)
        attention.CACHE_DTYPE = torch.float32 if dtype == "float32" else cache_dtype
        rglru.CACHE_CONV_DTYPE = torch.float32 if dtype == "float32" else conv_dtype
        cache_len = cache_len or seq + steps
        par = ParallelConfig(seq_shard_cache=seq_shard)
        cfg = mesh_config(get_config, arch, layers)
        world = math.prod(shape)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda", seed=SEED)
        if dtype != "bfloat16":
            # the bf16 model keeps the params that its specs make f32 (the
            # MoE router) in f32
            model = model.to(getattr(torch, dtype))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device="cuda")
        # the unsharded twin routes in the mesh's dispatch groups; an MoE
        # arch's routings are recorded, to pin the sharded run's to
        groups = moe_groups(par, dict(zip(MESH_AXES[len(shape)], shape)))
        ref_ctx = Ctx(moe_groups=groups)
        moe_run = bool(cfg.num_experts)
        with (recorded_layers(resid=False) if moe_run
              else contextlib.nullcontext(([], []))) as (routes0, _):
            ref, ref_cache = make_prefill_step(model, cache_len, ref_ctx)(tokens)
            ref_c0 = ({n: t.clone() for n, t in layer0_cache(ref_cache).items()}
                      if world <= CACHE_CHECK_RANKS else None)
            # the unsharded decode, greedy: its tokens feed both runs
            decode = make_decode_step(model, ref_ctx)
            feed, ref_steps = [ref.argmax(dim=-1, keepdim=True)], []
            for _ in range(steps):
                logits, ref_cache = decode(feed[-1], ref_cache)
                ref_steps.append(logits)
                feed.append(logits.argmax(dim=-1, keepdim=True))
        del ref_cache, decode
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        with simulated_ranks(world) as mode:
            t0 = time.perf_counter()
            mesh = make_mesh(shape, MESH_AXES[len(shape)])
            sharding.shard_model(model, mesh, par)
            inputs = sharding.shard_inputs({"tokens": tokens},
                                           sharding.batch_specs(model, "prefill", batch, seq),
                                           mesh, par)
            prefill = make_prefill_step(model, cache_len, parallel=par, mesh=mesh)
            local = rank_groups(mesh, groups)
            pin = (pinned_routing(routes0, local) if moe_run
                   else contextlib.nullcontext([]))
            torch.cuda.synchronize()
            t_shard = time.perf_counter() - t0
            free = None
            if moe_run:
                # a free (unpinned) sharded prefill first: the choices its
                # summation order flips against the unsharded run's, and how
                # far its logits then lie (printed, not held)
                with recorded_layers(resid=False) as (free_routes, _):
                    logits, _ = prefill(inputs["tokens"])
                whole = logits.full_tensor()
                free = [routing_flips(torch, mode, mesh, free_routes, routes0, local)]
                with mode.disable():
                    free.append((whole.reconcile().float() - ref.float()).abs().max().item())
                del logits, whole, free_routes
            with pin as natural:
                reset()
                t0 = time.perf_counter()
                logits, cache = prefill(inputs["tokens"])
                torch.cuda.synchronize()
                t_prefill = time.perf_counter() - t0
                prefill_launches = launches()
                got = logits.full_tensor()
                got_c0 = ({n: t.full_tensor() for n, t in layer0_cache(cache).items()}
                          if ref_c0 is not None else None)
                del logits, inputs, prefill
                decode = make_decode_step(model, parallel=par, mesh=mesh)
                tok_specs = sharding.batch_specs(model, "decode", batch, 1)
                dec, t_steps = [], []
                reset()
                for i in range(steps):
                    tok = sharding.shard_inputs({"token": feed[i]}, tok_specs, mesh,
                                                par)["token"]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, cache = decode(tok, cache)
                    torch.cuda.synchronize()
                    t_steps.append(time.perf_counter() - t0)
                    whole = logits.full_tensor()
                    with mode.disable():
                        # every rank holds the same whole logits: reconcile checks it
                        dec.append(whole.reconcile())
                    del logits, whole
                decode_launches = launches()
            flips = (routing_flips(torch, mode, mesh, natural, routes0, local) if moe_run
                     else [])
            placed = {n: str(t.placements) for n, t in layer0_cache(cache).items()}
            del cache, decode, natural, routes0
        got = got.reconcile()
        err = (got.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        c0 = {}                 # layer 0's cache: {name: (dtype, error, max)}
        for n, r in (ref_c0 or {}).items():
            g = got_c0[n].reconcile()
            c0[n] = (str(r.dtype)[6:], (g.float() - r.float()).abs().max().item(),
                     r.float().abs().max().item())
        finite = bool(torch.isfinite(got).all())
        path = (f"serve {cfg.name} {dtype} mesh {shape}"
                + (" seq_shard_cache" if seq_shard else ""))
        # K1 once a rank an attention layer, K3 once a rank a RG-LRU layer
        want = {name: 0 for name in counters}
        want["flash_attention"] = world * len(k1_layers(cfg))
        want["rglru_scan"] = world * kind_layers(cfg, "rglru")[0]
        if moe_run:
            n_pre = cfg.num_layers
            log(f"[mesh] {path}: {groups} dispatch groups. A free sharded prefill chose "
                f"other experts (another order of them) than the unsharded run for these "
                f"tokens of {batch * seq} a layer: {free[0]}; max |logit - unsharded| "
                f"{free[1]:.3e} (printed, not held). The checked run is pinned to the "
                f"unsharded run's expert ids; left free at each call it would have chosen "
                f"otherwise for these tokens: prefill {flips[:n_pre]}, of {batch} a decode "
                f"step {flips[n_pre:]}")
        c_rtol = max(rtol, CACHE_RTOL)
        log(f"[mesh] {path}: {world} ranks, B {batch} x S {seq}, cache {cache_len}: unsharded "
            f"prefill and {steps} decode steps {t_ref:.1f} s (init included), sharding "
            f"{t_shard:.1f} s, sharded prefill {t_prefill * 1e3:.1f} ms; launches "
            f"{prefill_launches}; max |logit - unsharded| {err:.3e} of max |logit| {top:.3e} "
            f"({err / top:.2e}, rule {rtol:g}); "
            + "".join(f"layer 0's {d} {n} cache {e:.3e} of {t:.3e} (rule {c_rtol:g}); "
                      for n, (d, e, t) in c0.items())
            + f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} "
            f"GB; {card}")
        if want["rglru_scan"]:
            log(f"[mesh] {path}: K3 launched {prefill_launches['rglru_scan']} times in the "
                f"sharded prefill, counted by its wrapper ({kind_layers(cfg, 'rglru')[0]} "
                f"RG-LRU layers x {world} ranks, each on its rank's local channels)")
        if prefill_launches != want:
            fail(f"{path}: launches {prefill_launches}, want {want}")
        off = {n: v for n, v in c0.items() if v[1] > c_rtol * v[2]}
        if not finite or tuple(got.shape) != tuple(ref.shape) or err > rtol * top or off:
            fail(f"{path}: finite {finite}, shape {tuple(got.shape)} (want "
                 f"{tuple(ref.shape)}), logits {err:.3e} > {rtol:g} x {top:.3e} or layer 0's "
                 f"cache (dtype, error, max) {off} beyond {c_rtol:g}")
        steps_out = []
        for i, (g, r, s) in enumerate(zip(dec, ref_steps, t_steps)):
            d_err = (g.float() - r.float()).abs().max().item()
            d_top = r.float().abs().max().item()
            ok = bool(torch.isfinite(g).all()) and tuple(g.shape) == tuple(r.shape) \
                and d_err <= rtol * d_top
            log(f"[mesh] {path} decode step {i} (position {seq + i}): max |logit - unsharded "
                f"decode| {d_err:.3e} of max |logit| {d_top:.3e} ({d_err / d_top:.2e}, rule "
                f"{rtol:g}); {s * 1e3:.1f} ms on {world} simulated ranks")
            if not ok:
                fail(f"{path} decode step {i}: shape {tuple(g.shape)} (want {tuple(r.shape)}), "
                     f"logits {d_err:.3e} > {rtol:g} x {d_top:.3e} or not finite")
            steps_out.append({"err": d_err, "max_logit": d_top, "ms": s * 1e3})
        t_decode_all += sum(t_steps)
        t_run = time.perf_counter() - t_run
        log(f"[mesh] {path}: decode under the mesh, {steps} steps in {sum(t_steps):.1f} s; "
            f"launches {decode_launches}; layer 0's cache placed {placed}; the run took "
            f"{t_run:.1f} s in all")
        if any(decode_launches.values()):
            fail(f"{path}: decode launched {decode_launches}, want none")
        out[path] = {"launches": prefill_launches, "prefill_ms": t_prefill * 1e3, "ranks": world,
                     "layers": cfg.num_layers, "err": err, "max_logit": top,
                     "config": cfg.name, "mesh": list(shape), "dtype": dtype,
                     "seq_shard_cache": seq_shard, "moe_groups": groups,
                     "routing_flips": flips, "free_prefill": free,
                     "cache": c0, "seconds": t_run,
                     "decode": {"launches": decode_launches, "steps": steps_out,
                                "placed": placed}}
        del model, ref, ref_c0, got, got_c0, dec, ref_steps, feed
    attention.CACHE_DTYPE, rglru.CACHE_CONV_DTYPE = cache_dtype, conv_dtype
    log(f"[mesh] decode under the mesh: {t_decode_all:.1f} s of steps over "
        f"{len(runs)} runs")
    torch.cuda.empty_cache()
    return out


# the train step under a mesh: (arch, layers, mesh, batch, seq, steps).
# gemma3-4b at full width as one superblock (5 local + 1 global layers) in
# f32 on (2, 4), every rank simulated (2 q heads and 1 kv head a rank), B 4 x
# S 512: 1.24 B parameters, whose f32 params and moments (15 GB) are held
# once sharded and once unsharded, with the gradients of both. MESH_TRAIN_RTOL:
# the loss and gnorm against the unsharded step's, relative; each gradient
# leaf gathered against the unsharded one, of that leaf's max (f32 summation
# order, as the sharded prefill's f32 rule); the sharded update against the port's
# unsharded adamw_update fed the gathered gradients and moments and the
# sharded step's global norm, of each leaf's max (the same f32 math: the
# norms' summation orders, a few ulps apart, would move it through the
# clip), and that norm against the one of the gathered gradients, relative,
# by the gnorm rule
MESH_TRAIN = (ARCH, 6, (2, 4), 4, 512, 2)
MESH_TRAIN_RTOL = {"loss": 1e-5, "gnorm": 1e-5, "grad": 1e-3, "update": 1e-6}
# the MoE train step under a mesh, by the same rules: mixtral-8x7b at full
# width and 1 layer in f32 on (2, 4), expert parallel (2 of its 8 experts a
# model rank, 2 dispatch groups, one a data rank), B 4 x S 512, 2 steps.
# One layer is 1.713 B parameters (27.4 GB of f32 params, gradients and
# moments), held once sharded and once unsharded; 8 ranks' gathered expert
# weights add ~11 GB. The sharded routing is pinned to the unsharded step's
# (full-width gates lie within 1e-6 of a tie), remat dots recomputing each
# layer's routing in the backward as the unsharded step does
MESH_MOE_TRAIN = (MIXTRAL, 1, (2, 4), 4, 512, 2)


def phase_mesh_train(torch, card, run=MESH_TRAIN):
    """`run` (MESH_TRAIN, MESH_MOE_TRAIN): `steps` steps of the train step of the default
    ParallelConfig (tp, fsdp, sequence parallel, remat dots) under a mesh,
    every rank simulated on the card, each against an unsharded train step
    on the card from the same state: both models are made from one seed
    (their leaves' sums checked equal), and before each later step the
    unsharded params and moments are set to the gathered sharded ones (a
    whole step compared element by element after an update is ill-posed:
    AdamW moves each element by about lr * sign(g), so a gradient near 0
    moves it either way). For each step: loss and gnorm, every gradient leaf
    gathered, and the sharded AdamW update (params and both moments) against
    the port's unsharded adamw_update of the gathered params, gradients and
    moments, given the sharded step's global norm, which is held against the
    norm of the gathered gradients; K1's forward and backward launches (counts reset just before
    each step and read just after) 8 x the unsharded step's, and no other
    kernel. An MoE arch's unsharded step routes in the mesh's dispatch
    groups, its routings are recorded, and the sharded step is pinned to
    them (`pinned_routing`; the choices it would have made left free are
    printed); its router leaves are checked by name among the gradient
    leaves. Returns {path: launches of the first sharded step, seconds,
    checks}."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Ctx, Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import coordinate, make_mesh, rank_map, simulated_ranks
    from repro_torch.train import optimizer as optim
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptConfig, OptState
    from torch.distributed.tensor import DTensor

    arch, layers, shape, batch, seq, steps = run
    cfg = mesh_config(get_config, arch, layers)
    moe_run = bool(cfg.num_experts)
    world, tol = math.prod(shape), MESH_TRAIN_RTOL
    counters = _launch_counters()
    opt, par = OptConfig(**TRAIN_OPT), ParallelConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device="cuda")
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    data = {"tokens": tokens, "labels": labels}
    adamw = ts.adamw_update
    memory = {}

    def held(what):
        """The bytes allocated on the card now, kept under `what`."""
        memory[what] = torch.cuda.memory_allocated() / 1e9
        log(f"[mesh] train {cfg.name}: {memory[what]:.2f} GB allocated {what}")

    def timed_step(step, state, inputs, loss_of):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, inputs)
        torch.cuda.synchronize()
        return state, {"loss": loss_of(met["loss"]), "gnorm": float(met["gnorm"]),
                       "s": time.perf_counter() - t0,
                       "launches": {name: fn.launches for name, fn in counters.items()}}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                1e-30)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = [Model(cfg, device="cuda", seed=SEED, trainable=True).float() for _ in range(2)]
    sums = [[float(p.detach().sum(dtype=torch.float64)) for p in m.parameters()]
            for m in models]
    if sums[0] != sums[1]:
        fail(f"train {cfg.name} mesh {shape}: two models of seed {SEED} have other weights")
    n_params = sum(p.numel() for p in models[0].parameters())
    state_u = ts.init_train_state(models[0])
    # the unsharded step routes in the mesh's dispatch groups (its Ctx's)
    groups = ts.moe_groups(par, dict(zip(MESH_AXES[len(shape)], shape)))
    make_ctx = ts.make_ctx
    ts.make_ctx = lambda parallel, mesh=None: Ctx(remat=parallel.remat, moe_groups=groups)
    try:
        step_u = ts.make_train_step(models[0], opt, par)
    finally:
        ts.make_ctx = make_ctx
    model = models[1]
    del models
    ref, got, checks, grads_u, flips = [], [], [], {}, []

    def keep_grads(cfg_, params, grads, state, ndims=None):
        grads_u.clear()
        grads_u.update((k, g.detach().to("cpu")) for k, g in grads.items())
        return adamw(cfg_, params, grads, state, ndims)

    with simulated_ranks(world) as mode:
        mesh = make_mesh(shape, MESH_AXES[len(shape)])
        sharding.shard_model(model, mesh, par)
        inputs = sharding.shard_inputs(data, sharding.batch_specs(model, "train", batch, seq),
                                       mesh, par)
        state = ts.init_train_state(model)
        step = ts.make_train_step(model, opt, par, mesh)
        t_setup = time.perf_counter() - t0
        held("with the unsharded and the sharded state")

        def whole(t, out=None):
            """t's whole value in one plain tensor (`out` if given; plain
            tensors stay plain under mode.disable()): each
            rank's shard copied into its place, and every rank's shard
            checked equal to what its place then holds (the ranks that
            replicate a dim hold the same values). full_tensor() would give
            every rank a whole copy (8 x 2.7 GB for the embedding)."""
            shards = t.to_local()._local_tensors
            with mode.disable():
                if out is None:
                    out = torch.empty(t.shape, dtype=t.dtype, device="cuda")

                def place(r):
                    return sharding.shard_region(out, mesh, t.placements, coordinate(mesh, r))

                for r, local in shards.items():
                    place(r).copy_(local)
                if not all(torch.equal(place(r), local) for r, local in shards.items()):
                    fail(f"train {cfg.name} mesh {shape}: ranks that replicate a shard of "
                         f"a {tuple(t.shape)} leaf disagree")
                return out

        def shards(t, like):
            """A plain whole tensor cut as `like` is placed, rank by rank."""
            return DTensor.from_local(
                rank_map(lambda r: sharding.local_shard(t, mesh, like.placements,
                                                        coordinate(mesh, r))),
                mesh, like.placements, run_check=False, shape=like.shape, stride=like.stride())

        @torch.no_grad()
        def set_unsharded(params, st):
            """The unsharded params and moments set to the gathered sharded
            ones (the buffers of the update's check below, too)."""
            for k, p in params.items():
                whole(p, state_u.params[k].data)
                whole(st.mu[k], state_u.opt.mu[k])
                whole(st.nu[k], state_u.opt.nu[k])

        @torch.no_grad()
        def check_update(cfg_, params, grads, st, ndims=None):
            errs = {"grad": 0.0, "router": 0.0, "routers": 0, "update": 0.0, "placed": True}
            if not checks:
                held("after the first sharded backward")
            g = {}
            for k, p in params.items():
                errs["placed"] &= all(t.placements == p.placements
                                      for t in (grads[k], st.mu[k], st.nu[k]))
                g[k] = whole(grads[k])
                with mode.disable():
                    e = rel(g[k], grads_u[k].cuda())
                errs["grad"] = max(errs["grad"], e)
                if k.endswith(".moe.router"):
                    errs["router"] = max(errs["router"], e)
                    errs["routers"] += 1
            set_unsharded(params, st)
            out = adamw(cfg_, params, grads, st, ndims)
            norm = float(out[2]["gnorm"])
            # the clip scales every gradient by 1 / gnorm, and the sharded
            # and the unsharded norm sum the squares in other orders, some
            # ulps apart. The reference takes the sharded step's norm, so
            # that the update is compared alone, and the norms beside it
            with mode.disable():
                errs["norm"] = abs(norm / float(optim.global_norm(g)) - 1)
                global_norm = optim.global_norm
                optim.global_norm = lambda tree: torch.tensor(norm, dtype=torch.float32,
                                                              device="cuda")
                try:
                    want_p, want_st, _ = adamw(cfg_, state_u.params, g,
                                               OptState(st.step, state_u.opt.mu,
                                                        state_u.opt.nu), ndims)
                finally:
                    optim.global_norm = global_norm
            del g
            for k, p in params.items():
                for t, want in ((p, want_p[k]), (out[1].mu[k], want_st.mu[k]),
                                (out[1].nu[k], want_st.nu[k])):
                    d = float((t - shards(want, t)).abs().max().full_tensor())
                    with mode.disable():
                        top = float(want.abs().max())
                    errs["update"] = max(errs["update"], d / max(top, 1e-30))
            checks.append(errs)
            return out

        local = rank_groups(mesh, groups)
        t0 = time.perf_counter()
        for i in range(steps):
            if i:
                set_unsharded(state.params, state.opt)
            ts.adamw_update = keep_grads
            try:
                with mode.disable(), (recorded_layers(resid=False) if moe_run
                                      else contextlib.nullcontext(([], []))) as (routes0, _):
                    state_u, r = timed_step(step_u, state_u, data, float)
                ref.append(r)
                ts.adamw_update = check_update
                with (pinned_routing(routes0, local) if moe_run
                      else contextlib.nullcontext([])) as natural:
                    state, r = timed_step(step, state, inputs, lambda x: float(x.full_tensor()))
                got.append(r)
                if moe_run:
                    if len(natural) != len(routes0):
                        fail(f"train {cfg.name} mesh {shape} step {i + 1}: {len(natural)} "
                             f"MoE calls, the unsharded step made {len(routes0)}")
                    flips.append(routing_flips(torch, mode, mesh, natural, routes0, local))
                del routes0, natural
            finally:
                ts.adamw_update = adamw
        del state, step, inputs
    t_steps = time.perf_counter() - t0
    del state_u, step_u, model
    peak = torch.cuda.max_memory_allocated() / 1e9
    path = f"train {cfg.name} float32 mesh {shape}"
    for i, (r, s, c) in enumerate(zip(ref, got, checks)):
        want = {name: world * n for name, n in r["launches"].items()}
        log(f"[mesh] {path}, step {i + 1}: loss {s['loss']:.7f} (unsharded {r['loss']:.7f}), "
            f"gnorm {s['gnorm']:.7f} (unsharded {r['gnorm']:.7f}); max gradient leaf error "
            f"{c['grad']:.2e} (rule {tol['grad']:g}); update against the unsharded "
            f"adamw_update of the gathered state and the sharded norm {c['update']:.2e} (rule "
            f"{tol['update']:g}); the norms {c['norm']:.2e} apart (rule {tol['gnorm']:g}); "
            f"launches {s['launches']} (unsharded {r['launches']}); {s['s']:.2f} s (unsharded "
            f"{r['s'] * 1e3:.1f} ms)"
            + (f"; routers {c['router']:.2e} (rule {tol['grad']:g}); {groups} dispatch groups, "
               f"routed as the unsharded step (pinned); left free, the MoE calls (forward, "
               f"then remat's recompute) would have chosen other experts (another order of "
               f"them) for these tokens of {batch * seq}: {flips[i]}" if moe_run else ""))
        if s["launches"] != want or not s["launches"]["flash_attention_bwd"]:
            fail(f"{path} step {i + 1}: launches {s['launches']}, want {want}")
        bad = [k for k in ("loss", "gnorm")
               if not math.isfinite(s[k]) or abs(s[k] - r[k]) > tol[k] * abs(r[k])]
        bad += [k for k, rule in (("grad", "grad"), ("router", "grad"), ("update", "update"),
                                  ("norm", "gnorm")) if not c[k] <= tol[rule]]
        if bad or not c["placed"] or c["routers"] != (cfg.num_layers if moe_run else 0):
            fail(f"{path} step {i + 1}: {bad} off (placed {c['placed']}): {s}, unsharded {r}, "
                 f"{c}")
    log(f"[mesh] {path}: {world} ranks, {n_params / 1e9:.3f}B params, B {batch} x S {seq}, "
        f"{steps} steps: setup {t_setup:.1f} s (two models, sharding), steps and checks "
        f"{t_steps:.1f} s; peak {peak:.1f} GB; {card}")
    torch.cuda.empty_cache()
    return {path: {"launches": got[0]["launches"], "step_s": [s["s"] for s in got],
                   "unsharded_ms": [r["s"] * 1e3 for r in ref], "ranks": world,
                   "layers": cfg.num_layers, "config": cfg.name, "mesh": list(shape),
                   "loss": [s["loss"] for s in got], "gnorm": [s["gnorm"] for s in got],
                   "checks": checks, "memory_gb": memory, "peak_gb": peak,
                   "moe_groups": groups if moe_run else 0, "routing_flips": flips}}


# ---------------------------------------------------------------------------
# capture (phase 7)
# ---------------------------------------------------------------------------

# the launch counter each kernel operator's node stands for
KERNEL_OPS = {"flash_attention_fwd": "flash_attention",
              "flash_attention_fwd_lse": "flash_attention",
              "flash_attention_bwd": "flash_attention_bwd", "ssd_fwd": "ssd",
              "ssd_fwd_saved": "ssd", "ssd_bwd": "ssd_bwd", "rglru_scan_fwd": "rglru_scan",
              "rglru_scan_bwd": "rglru_scan_bwd"}
# the measured paths the capture phase traces: each arch's prefill as the
# serve phase cuts it, and the training steps that carry K1, K2 and K3 with
# their backwards
SERVED_ARCHS = (ARCH, SSM_ARCH, RG_ARCH) + DENSE_ARCHS + MOE_ARCHS + CROSS_ARCHS
CAPTURED_TRAIN = (ARCH, SSM_ARCH, RG_ARCH)
# what one card cannot run, captured at full depth and held to two shallow
# captures, depth by depth: dbrx-132b's training step at 40 layers (132 B
# parameters, ~1.6 TB of state) and llama-3.2-vision-90b's prefill at 100,
# in whole superblocks of 5
CAPTURE_DEEP = ((DBRX, "train", (1, 2, 40)), (LLAMA, "prefill", (5, 10, 100)))
# rank 0's program under a mesh (parallel.mesh.fake_process_group, the trace
# over the rank's local shards): (arch, layers or None for all, step, mesh,
# batch) at PROMPT tokens a sequence: the measured bf16 gemma3-4b mesh path of
# phase 8, and the forward step at full depth on the production meshes
# (launch/mesh.py), 256 and 512 ranks, one sequence a (pod, data) rank
MESH_CAPTURES = ((ARCH, MESH_RUNS[0].layers, "prefill", (2, 4), BATCH),
                 (ARCH, None, "forward", (16, 16), 16), (QWEN, None, "forward", (16, 16), 16),
                 (QWEN, None, "forward", (2, 16, 16), 32),
                 (RG_ARCH, 5, "prefill", (2, 4), BATCH), (RG_ARCH, None, "forward", (16, 16), 16))
# rank 0's program of recurrentgemma-9b's decode step at full width and depth
# on (16, 16): (mesh, batch, cache length), the decode_32k cell. No kernel
# node: decode launches none, as phase 8's sharded decode
MESH_RG_DECODE_CAPTURE = ((16, 16), 128, 32_768)
# rank 0's program of the decode step on the production mesh (16, 16),
# qwen3-8b at full width and depth: (mesh, batch, cache length,
# seq_shard_cache), the decode_32k cell (B 128, cache 32,768) and the
# long_500k cell (B 1, cache 524,288, its length split over the data axis),
# the latter also at half the length: under seq_shard_cache no collective
# moves the cache, so every collective's count and bytes are the same at both
# lengths. No kernel node: decode launches none
MESH_DECODE_CAPTURES = (((16, 16), 128, 32_768, False), ((16, 16), 1, 524_288, True),
                        ((16, 16), 1, 262_144, True))
# rank 0's program of the FSDP train step on the production mesh (16, 16),
# qwen3-8b at full width, one sequence of TRAIN_SEQ a data rank, at these
# depths: its FLOPs and every collective's count and bytes held exactly
# linear in depth (the first two fix the line, the third is on it)
MESH_TRAIN_CAPTURE = (QWEN, (16, 16), 16, (1, 2, 4))
# rank 0's program of the MoE archs' forward step on the production mesh
# (16, 16) at full width, one sequence of PROMPT a data rank (16 dispatch
# groups): dbrx-132b's 16 experts one a model rank (expert parallelism),
# mixtral-8x7b's 8 with ff over the model axis. At these depths its FLOPs and
# every collective's count and bytes are held exactly linear in depth; each
# collective kind's count and bytes a layer are printed beside those of
# qwen3-8b's dense layer, captured at the first two depths
MESH_MOE_CAPTURE = ((MIXTRAL, DBRX), QWEN, (16, 16), 16, (1, 2, 4))
# rank 0's program of the MoE archs' train step on (16, 16) at full width, one
# sequence of TRAIN_SEQ a data rank (16 dispatch groups), remat dots:
# mixtral-8x7b with ff over the model axis, dbrx-132b one expert a model rank
# (expert parallelism). Held as MESH_TRAIN_CAPTURE is (check_train_capture),
# its K1 nodes a layer against phase 8's MoE train step
MESH_MOE_TRAIN_CAPTURE = ((MIXTRAL, DBRX), (16, 16), 16, (1, 2, 4))


def count_flops_of(torch, fn):
    """FLOPs that FlopCounterMode counts over one real call of fn (the
    kernels by their operators' formulas)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    return fc.get_total_flops()


def capture_path(torch, cfg, what):
    """Capture one prefill of `cfg` (BATCH x PROMPT, cache PROMPT + STEPS) or
    one training step (TRAIN_BATCH x TRAIN_SEQ, TRAIN_OPT, TRAIN_PAR) as the
    serve and train phases run them, or rank 0 of a step under a mesh
    (capture_mesh), on fake cuda tensors. Returns the capture's summary and
    seconds, its kernel nodes by launch counter, the parameters, and CUDA's
    allocated and reserved bytes, allocations made and launch counts before
    and after it."""
    counters = _launch_counters()

    def device_state():
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
                torch.cuda.memory_stats()["allocation.all.allocated"],
                {name: fn.launches for name, fn in counters.items()})

    before = device_state()
    t0 = time.perf_counter()
    if "@" in what:
        cap, n_params = capture_mesh(torch, cfg, what)
    else:
        cap, n_params = capture_one(torch, cfg, what)
    seconds = time.perf_counter() - t0
    nodes = {name: 0 for name in counters}
    for op, n in cap.summary["kernel_nodes"].items():
        nodes[KERNEL_OPS[op]] += n
    summary = {k: cap.summary[k] for k in ("parsed_flops", "parsed_hbm_bytes", "n_nodes",
                                           "kernel_nodes", "comm", "comm_bytes")}
    return {"config": cfg.name, "what": what, "seconds": seconds, **summary,
            "fx_nodes": cap.meta["fx_nodes"], "t_trace_s": cap.meta["t_trace_s"],
            "kernel_launch_nodes": nodes, "params": n_params,
            "world": cap.meta.get("world_size", 1),
            "device_before": before, "device_after": device_state()}


def capture_one(torch, cfg, what):
    """(capture, parameters) of one prefill or training step on one card."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import capture_step, fake_mode
    from repro_torch.models import Model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.serve_step import make_prefill_step
    from repro_torch.train.train_step import init_train_state, make_train_step

    batch, seq = (TRAIN_BATCH, TRAIN_SEQ) if what == "train" else (BATCH, PROMPT)
    with fake_mode():
        model = Model(cfg, trainable=what == "train", abstract=True)
        tokens = torch.empty(batch, seq, dtype=torch.long, device="cuda")
        memory = (torch.empty(batch, model.memory_len(), cfg.d_model, dtype=torch.bfloat16,
                              device="cuda") if model.memory_len() else None)
        if what == "train":
            step = make_train_step(model, OptConfig(**TRAIN_OPT), ParallelConfig(**TRAIN_PAR))
            data = {"tokens": tokens, "labels": tokens,
                    **({"memory": memory} if memory is not None else {})}
            cap = capture_step(step, (init_train_state(model), data), {"config": cfg.name})
        else:
            cap = capture_step(make_prefill_step(model, PROMPT + STEPS), (tokens, memory),
                               {"config": cfg.name})
        n_params = sum(p.numel() for p in model.parameters())
    return cap, n_params


def capture_mesh(torch, cfg, what):
    """(capture, parameters) of rank 0's program of a step under a mesh:
    `what` is "<prefill, forward, train or decode>@<mesh, as 2x16x16>:B<batch>"
    (mesh_what), a decode step's also ":L<cache length>" and ":seq" under
    seq_shard_cache; a fake process group of the mesh's ranks, the production
    mesh where the shape is one; the model sharded under the default
    ParallelConfig's rules, the batch split as batch_specs say, and the trace
    taken over rank 0's shards (core.capture_sharded_step). A train step
    (FSDP over the data axis, remat dots) takes TRAIN_SEQ tokens a sequence,
    TRAIN_OPT and its moments sharded as the params; a decode step one token
    against an empty sharded cache (Model.init_cache under the mesh) at its
    last position; the others PROMPT tokens."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import capture_sharded_step, fake_mode
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import fake_process_group, make_mesh
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.serve_step import (make_decode_step, make_forward_step,
                                              make_prefill_step)
    from repro_torch.train.train_step import init_train_state, make_train_step

    step, rest = what.split("@")
    shape, batch, *decode = rest.split(":")
    shape, batch = tuple(int(n) for n in shape.split("x")), int(batch[1:])
    par = ParallelConfig(seq_shard_cache="seq" in decode)
    with fake_process_group(math.prod(shape)):
        if shape in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(shape) == 3)
        else:
            mesh = make_mesh(shape, MESH_AXES[len(shape)])
        with fake_mode():
            model = Model(cfg, trainable=step == "train", abstract=True)
            sharding.shard_model(model, mesh, par)
            if step == "train":
                tokens = torch.empty(batch, TRAIN_SEQ, dtype=torch.long, device="cuda")
                inputs = sharding.shard_inputs(
                    {"tokens": tokens, "labels": tokens},
                    sharding.batch_specs(model, "train", batch, TRAIN_SEQ), mesh, par)
                fn = make_train_step(model, OptConfig(**TRAIN_OPT), par, mesh)
                args = [init_train_state(model), inputs]
            elif step == "decode":
                cache_len = int(decode[0][1:])
                token = sharding.shard_inputs(
                    {"token": torch.empty(batch, 1, dtype=torch.long, device="cuda")},
                    sharding.batch_specs(model, "decode", batch, 1), mesh, par)["token"]
                cache = model.init_cache(batch, cache_len, mesh=mesh, parallel=par)
                cache["pos"] = cache_len - 1
                fn = make_decode_step(model, parallel=par, mesh=mesh)
                args = [token, cache]
            else:
                tokens = torch.empty(batch, PROMPT, dtype=torch.long, device="cuda")
                inputs = sharding.shard_inputs(
                    {"tokens": tokens}, sharding.batch_specs(model, "prefill", batch, PROMPT),
                    mesh, par)
                fn = (make_prefill_step(model, PROMPT, parallel=par, mesh=mesh)
                      if step == "prefill" else make_forward_step(model, parallel=par, mesh=mesh))
                args = [inputs["tokens"]]
            cap = capture_sharded_step(fn, model, args, {"config": cfg.name})
            n_params = sum(p.numel() for p in model.parameters())
    return cap, n_params


def mesh_what(step, mesh, batch, cache_len=0, seq_shard_cache=False):
    """The `what` of a capture under a mesh (capture_mesh)."""
    return (f"{step}@{'x'.join(map(str, mesh))}:B{batch}" + (f":L{cache_len}" if cache_len else "")
            + (":seq" if seq_shard_cache else ""))


def capture_main(torch):
    """The capture phase's process: every capture, one JSON line each. It
    runs beside the other phases, at the lowest priority and on one thread,
    with CUDA initialised (one allocation of its own), so that an
    allocation or a launch by a capture would show in its counts."""
    from repro_torch.configs.registry import get_config
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)     # PR_SET_PDEATHSIG: die with the parent
    os.nice(19)
    torch.set_num_threads(1)
    from repro_torch.core import fake_mode
    live = torch.zeros(1, device="cuda")           # noqa: F841 (the allocator is live)
    # FakeTensorMode readies CUDA for a fake backward with one real 4-byte
    # tensor per device name, once a process (init_gpu_context in
    # torch/_subclasses/fake_tensor.py): here, before the first capture
    with fake_mode():
        torch.empty(1, device="cuda") + torch.empty(1, device="cuda:0")
    for cfg, what in capture_jobs(get_config):
        print(json.dumps(capture_path(torch, cfg, what)), flush=True)
    return 0


def capture_jobs(get_config):
    """[(config, "prefill" or "train")] of the capture phase, in order: the
    measured paths, then CAPTURE_DEEP's depths."""
    jobs = [(serve_config(get_config, arch), "prefill") for arch in SERVED_ARCHS]
    jobs += [(get_config(arch).replace(**TRAINED[arch].get("train_cut", {})), "train")
             for arch in CAPTURED_TRAIN]
    for arch, what, depths in CAPTURE_DEEP:
        cfg = get_config(arch)
        nsb = len(cfg.superblock)
        jobs += [(cfg.replace(name=f"{arch}-{L}layer", num_layers=L, sb_repeat=L // nsb), what)
                 for L in depths]
    jobs += [(mesh_config(get_config, arch, layers), mesh_what(step, mesh, batch))
             for arch, layers, step, mesh, batch in MESH_CAPTURES]
    jobs += [(get_config(QWEN), mesh_what("decode", *c)) for c in MESH_DECODE_CAPTURES]
    jobs.append((get_config(RG_ARCH), mesh_what("decode", *MESH_RG_DECODE_CAPTURE)))
    arch, mesh, batch, depths = MESH_TRAIN_CAPTURE
    jobs += [(mesh_config(get_config, arch, L), mesh_what("train", mesh, batch))
             for L in depths]
    archs, mesh, batch, depths = MESH_MOE_TRAIN_CAPTURE
    jobs += [(mesh_config(get_config, arch, L), mesh_what("train", mesh, batch))
             for arch in archs for L in depths]
    archs, dense, mesh, batch, depths = MESH_MOE_CAPTURE
    jobs += [(mesh_config(get_config, arch, L), mesh_what("forward", mesh, batch))
             for arch in archs for L in depths]
    jobs += [(mesh_config(get_config, dense, L), mesh_what("forward", mesh, batch))
             for L in depths[:2]]
    return jobs


CAPTURE_OUT = os.path.join(ROOT, "build", "capture-process")   # .jsonl and .log


def start_captures():
    """Start the capture phase's process (capture_main), its output and
    errors into CAPTURE_OUT; it dies with this process."""
    os.makedirs(os.path.dirname(CAPTURE_OUT), exist_ok=True)
    with open(CAPTURE_OUT + ".jsonl", "w") as out, open(CAPTURE_OUT + ".log", "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--capture-process"], stdout=out, stderr=err)
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc


def roofline_ms(flops, nbytes):
    """The graph's least time on the card, from the data sheet: its FLOPs at
    the bf16 dense peak and its bytes at HBM3's rate (per op, unfused); the
    larger of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def launches_a_layer(run):
    """{kernel: launches a rank and a layer} of one of phase 8's sharded
    train runs (its first step)."""
    per_layer = {}
    for name, n in run["launches"].items():
        per_layer[name], rest = divmod(n, run["ranks"] * run["layers"])
        if rest:
            fail(f"{name}: phase 8's sharded train step of {run['config']} launched {n}, not a "
                 f"whole number a rank and a layer")
    return per_layer


def check_train_capture(by_key, mesh_train):
    """Gate (v) of phase_capture: rank 0's program of the FSDP train step
    (MESH_TRAIN_CAPTURE) and of the MoE archs' train step
    (MESH_MOE_TRAIN_CAPTURE) has, a layer, the K1 forward and backward nodes
    that phase 8's sharded dense (MoE) train step launched a rank and a
    layer, and its FLOPs and every collective's count and bytes are exactly
    linear in depth; each MoE arch's collective kinds a layer are printed
    beside the dense train layer's. Fails if a capture or a run is missing.
    `by_key`: the captures by (config, what)."""
    runs = {bool(r["moe_groups"]): r for r in mesh_train.values()}
    if set(runs) != {False, True}:
        fail(f"phase 8 ran no dense or no MoE train step under a mesh: {list(mesh_train)}")
    jobs = [(MESH_TRAIN_CAPTURE[0],) + MESH_TRAIN_CAPTURE[1:] + (runs[False],)]
    jobs += [(arch,) + MESH_MOE_TRAIN_CAPTURE[1:] + (runs[True],)
             for arch in MESH_MOE_TRAIN_CAPTURE[0]]
    dense_layer = None
    for arch, shape, batch, depths, run in jobs:
        per_layer = launches_a_layer(run)
        what = mesh_what("train", shape, batch)
        caps_t = [by_key.get((f"{arch}-{L}layer", what)) for L in depths]
        if any(c is None for c in caps_t):
            fail(f"capture {arch} train on mesh {shape}: missing at depths {depths} "
                 f"({[c is not None for c in caps_t]})")
        for c, L in zip(caps_t, depths):
            comm = {k: f"{v['count']} ({v['bytes'] / 1e6:.3f} MB)"
                    for k, v in sorted(c["comm"].items())}
            log(f"[capture] rank 0 of {arch} train at {L} layers on mesh {shape} ({c['world']} "
                f"ranks, B {batch} x S {TRAIN_SEQ}, FSDP, remat dots): {c['parsed_flops']:.6e} "
                f"FLOPs a rank, COMM_COLL {comm}, {c['comm_bytes'] / 1e6:.3f} MB in all; kernel "
                f"nodes {c['kernel_nodes']}; {c['seconds']:.1f} s")
            want = {name: L * n for name, n in per_layer.items()}
            if c["world"] != math.prod(shape) or c["kernel_launch_nodes"] != want:
                fail(f"capture {arch} train at {L} layers mesh {shape}: world {c['world']}, "
                     f"kernel nodes {c['kernel_launch_nodes']}, want {want} (phase 8's "
                     f"launches a rank and a layer of {run['config']})")
        k, n_lines = linear_in_depth(caps_t, depths, f"{arch} train on mesh {shape}")
        d1, d2, dn = depths
        layer = per_layer_comm(*caps_t[:2])
        dense_layer = dense_layer or layer
        log(f"[capture] rank 0 of {arch} train on mesh {shape}: FLOPs and every collective's "
            f"count and bytes at {dn} layers = x({d1}) + {k} x (x({d2}) - x({d1})), exactly "
            f"({n_lines} lines); K1 nodes a layer {per_layer} = phase 8's launches a rank and "
            f"a layer ({run['config']}); a layer: {layer}"
            + ("" if layer is dense_layer else f", against {jobs[0][0]}'s dense train layer "
                                               f"{dense_layer}"))


def linear_in_depth(caps, depths, what):
    """Fail unless the FLOPs and every collective kind's count and bytes of
    the captures at three depths lie exactly on the line through the first
    two. Returns (the third depth's step in units of the first two's gap,
    the number of lines held)."""
    (d1, c1), (d2, c2), (dn, cn) = zip(depths, caps)
    k = (dn - d1) // (d2 - d1)
    lines = {"FLOPs": [c["parsed_flops"] for c in (c1, c2, cn)]}
    for kind in sorted(set(c1["comm"]) | set(c2["comm"]) | set(cn["comm"])):
        for n in ("count", "bytes"):
            lines[f"{kind} {n}"] = [c["comm"].get(kind, {}).get(n, 0) for c in (c1, c2, cn)]
    off = {name: v for name, v in lines.items() if v[2] != v[0] + k * (v[1] - v[0])}
    if off:
        fail(f"capture {what}: not linear in depth {depths}: {off}")
    return k, len(lines)


def per_layer_comm(c1, c2):
    """{collective kind: "count (MB)"} of one layer: the capture at one more
    layer less the other."""
    kinds = sorted(set(c1["comm"]) | set(c2["comm"]))
    out = {}
    for kind in kinds:
        n, b = (c2["comm"].get(kind, {}).get(x, 0) - c1["comm"].get(kind, {}).get(x, 0)
                for x in ("count", "bytes"))
        if n or b:
            out[kind] = f"{n} ({b / 1e6:.3f} MB)"
    return out


def check_moe_captures(by_key):
    """Gate (vii) of phase_capture: rank 0's program of the MoE archs'
    forward step on (16, 16) (MESH_MOE_CAPTURE) has one K1 node a layer, and
    its FLOPs and every collective's count and bytes are exactly linear in
    depth; each collective kind a layer is printed beside those of qwen3-8b's
    dense layer."""
    archs, dense, shape, batch, depths = MESH_MOE_CAPTURE
    what = mesh_what("forward", shape, batch)
    d1, d2, dn = depths
    dense_layer = per_layer_comm(*(by_key[(f"{dense}-{L}layer", what)] for L in depths[:2]))
    for arch in archs:
        caps = [by_key[(f"{arch}-{L}layer", what)] for L in depths]
        for c, L in zip(caps, depths):
            comm = {k: f"{v['count']} ({v['bytes'] / 1e6:.3f} MB)"
                    for k, v in sorted(c["comm"].items())}
            log(f"[capture] rank 0 of {arch} forward at {L} layers on mesh {shape} "
                f"({c['world']} ranks, B {batch} x S {PROMPT}): {c['parsed_flops']:.6e} FLOPs "
                f"a rank, COMM_COLL {comm}, {c['comm_bytes'] / 1e6:.3f} MB in all; kernel "
                f"nodes {c['kernel_nodes']}; {c['seconds']:.1f} s")
            want = {name: L if name == "flash_attention" else 0
                    for name in c["kernel_launch_nodes"]}
            if c["world"] != math.prod(shape) or c["kernel_launch_nodes"] != want:
                fail(f"capture {arch} forward at {L} layers mesh {shape}: world {c['world']}, "
                     f"kernel nodes {c['kernel_launch_nodes']}, want {want}")
        k, n_lines = linear_in_depth(caps, depths, f"{arch} forward on mesh {shape}")
        log(f"[capture] rank 0 of {arch} forward on mesh {shape}: FLOPs and every "
            f"collective's count and bytes at {dn} layers = x({d1}) + {k} x (x({d2}) - "
            f"x({d1})), exactly ({n_lines} lines); a layer: {per_layer_comm(*caps[:2])}, "
            f"against {dense}'s dense layer {dense_layer}")


def phase_capture(torch, card, proc, measured, real_flops, mesh_measured, mesh_train):
    """Read the capture process (start_captures) and hold its captures:
    (i) none changed CUDA's allocated or reserved bytes or made an
    allocation, and none moved a launch counter;
    (ii) each measured path's kernel nodes equal the launches its measured
    run counted (`measured`: {(config, what): (launches, ms)}); (iii) the
    FLOPs FlopCounterMode counted around a real prefill and train step
    (`real_flops`: {(config, what): FLOPs}) equal the captured
    parsed_flops; the graph's roofline is not above the measured time; the
    full-depth captures are linear in depth against the two shallow ones;
    (iv) rank 0's program under a mesh has one K1 node an attention layer
    and one K3 node a RG-LRU layer, and on the mesh phase's measured
    gemma3-4b and recurrentgemma-9b paths, its kernel nodes times the ranks
    equal the launches the simulated run counted (`mesh_measured`,
    phase_mesh's; check_mesh_captures); its FLOPs, collectives and their
    bytes are printed; (v) rank 0's program
    of qwen3-8b's FSDP train step on (16, 16) (MESH_TRAIN_CAPTURE), and of
    the MoE archs' (MESH_MOE_TRAIN_CAPTURE), has, a layer, the K1 forward
    and backward nodes that phase 8's sharded dense (MoE) train step
    launched a rank and a layer (`mesh_train`, phase_mesh_train's), and its
    FLOPs and each collective's count and bytes are exactly linear in
    depth; (vi) rank 0's program of qwen3-8b's decode step on (16, 16)
    (MESH_DECODE_CAPTURES) has no kernel node, and under seq_shard_cache
    its collectives are the same at both cache lengths; (vii) rank 0's
    program of the MoE archs' forward step on (16, 16) (MESH_MOE_CAPTURE)
    has one K1 node a layer and is exactly linear in depth; (viii) rank 0's
    program of recurrentgemma-9b's decode step on (16, 16) has no kernel
    node (check_rg_decode_capture). Returns the captures."""
    if proc.wait(timeout=900) != 0:
        with open(CAPTURE_OUT + ".log") as f:
            fail(f"capture process exited {proc.returncode}:\n{f.read()[-4000:]}")
    with open(CAPTURE_OUT + ".jsonl") as f:
        caps = [json.loads(x) for x in f if x.startswith("{")]
    log(f"[capture] {len(caps)} captures on fake cuda, in a process of their own beside "
        f"the other phases: {sum(c['seconds'] for c in caps):.1f} s in all; {card}")
    by_key = {}
    for c in caps:
        by_key[(c["config"], c["what"])] = c
        *mem_b, launches_b = c["device_before"]
        *mem_a, launches_a = c["device_after"]
        if mem_a != mem_b or launches_a != launches_b or any(launches_a.values()):
            fail(f"capture {c['config']} {c['what']}: device (allocated, reserved, "
                 f"allocations) {mem_b} -> {mem_a}, launches {launches_b} -> {launches_a}")
        log(f"[capture] {c['config']} {c['what']}: {c['seconds']:.1f} s (trace "
            f"{c['t_trace_s']:.1f} s), {c['fx_nodes']} FX nodes, {c['n_nodes']} graph nodes, "
            f"kernel nodes {c['kernel_nodes']}, {c['parsed_flops']:.6e} FLOPs, "
            f"{c['parsed_hbm_bytes']:.6e} bytes, {c['params'] / 1e9:.3f}B params; device "
            f"(allocated, reserved, allocations) {mem_b} before and after")
    for (config, what), (launches, ms) in measured.items():
        c = by_key[(config, what)]
        if c["kernel_launch_nodes"] != launches:
            fail(f"capture {config} {what}: kernel nodes {c['kernel_launch_nodes']}, the "
                 f"measured run launched {launches}")
        bound, t_ops, t_bytes = roofline_ms(c["parsed_flops"], c["parsed_hbm_bytes"])
        log(f"[capture] {config} {what}: kernel nodes = measured launches "
            f"{ {k: v for k, v in launches.items() if v} }; roofline (data sheet: "
            f"{PEAK_FLOPS['bfloat16'] / 1e12:g} TFLOP/s bf16 dense, {PEAK_BYTES / 1e12:g} "
            f"TB/s) {bound:.2f} ms (FLOPs {t_ops:.2f} ms, bytes {t_bytes:.2f} ms), measured "
            f"{ms:.2f} ms ({bound / ms:.1%})")
        if bound > ms:
            fail(f"capture {config} {what}: roofline {bound:.2f} ms above the measured "
                 f"{ms:.2f} ms")
    for (config, what), flops in real_flops.items():
        captured = by_key[(config, what)]["parsed_flops"]
        if flops != captured:
            fail(f"capture {config} {what}: FlopCounterMode counted {flops} FLOPs in a real "
                 f"run on the card, the capture {captured}")
        log(f"[capture] {config} {what}: FlopCounterMode around a real run on the card "
            f"{flops} FLOPs = captured parsed_flops")
    for arch, what, (d1, d2, full) in CAPTURE_DEEP:
        c1, c2, cf = (by_key[(f"{arch}-{L}layer", what)] for L in (d1, d2, full))
        step = (full - d1) // (d2 - d1)
        want = c1["parsed_flops"] + step * (c2["parsed_flops"] - c1["parsed_flops"])
        if cf["parsed_flops"] != want:
            fail(f"capture {arch} {what} at {full} layers: {cf['parsed_flops']} FLOPs, the "
                 f"{d1}- and {d2}-layer captures give {want}")
        log(f"[capture] {arch} {what} at {full} layers ({cf['params'] / 1e9:.2f}B params"
            + (f", {12 * cf['params'] / 1e12:.2f} TB of state at 12 bytes a parameter"
               if what == "train" else "")
            + f"): {cf['seconds']:.1f} s, {cf['n_nodes']} graph nodes, {cf['parsed_flops']:.6e} "
            f"FLOPs = flops({d1}) + {step} x (flops({d2}) - flops({d1})), exactly")
    from repro_torch.configs.registry import get_config
    runs = {(r["config"], tuple(r["mesh"])): r for r in mesh_measured.values()
            if r["dtype"] == "bfloat16"}
    check_mesh_captures(by_key, runs)
    check_train_capture(by_key, mesh_train)
    check_decode_captures(by_key)
    check_moe_captures(by_key)
    check_rg_decode_capture(by_key, runs)
    return caps


def check_mesh_captures(by_key, runs, captures=MESH_CAPTURES):
    """Gate (iv) of phase_capture: rank 0's program of each of `captures`
    (MESH_CAPTURES) has one K1 node an attention layer and one K3 node a
    RG-LRU layer, and on a path that phase 8 measured (`runs`: its bf16
    runs by (config, mesh)) its kernel nodes times the ranks equal the
    launches the simulated run counted; the FLOPs a rank and the
    collectives are printed."""
    from repro_torch.configs.registry import get_config
    for arch, layers, step, shape, batch in captures:
        cfg = mesh_config(get_config, arch, layers)
        c = by_key[(cfg.name, mesh_what(step, shape, batch))]
        arch = cfg.name
        comm = {k: f"{v['count']} ({v['bytes'] / 1e6:.1f} MB)" for k, v in c["comm"].items()}
        log(f"[capture] rank 0 of {arch} {step} on mesh {shape} ({c['world']} ranks, B "
            f"{batch} x S {PROMPT}): {c['parsed_flops']:.6e} FLOPs a rank, COMM_COLL "
            f"{comm}, {c['comm_bytes'] / 1e6:.1f} MB in all; kernel nodes {c['kernel_nodes']}")
        want = {name: 0 for name in c["kernel_launch_nodes"]}
        want["flash_attention"] = len(k1_layers(cfg))
        want["rglru_scan"] = kind_layers(cfg, "rglru")[0]
        if c["world"] != math.prod(shape) or c["kernel_launch_nodes"] != want:
            fail(f"capture {arch} {step} mesh {shape}: world {c['world']}, kernel nodes "
                 f"{c['kernel_launch_nodes']}, want {want}")
        run = runs.get((arch, shape))
        if run and step == "prefill" and batch == BATCH:
            nodes = {k: n * c["world"] for k, n in c["kernel_launch_nodes"].items()}
            if nodes != run["launches"]:
                fail(f"capture {arch} {step} mesh {shape}: {c['kernel_launch_nodes']} kernel "
                     f"nodes x {c['world']} ranks, the simulated run launched "
                     f"{run['launches']}")
            log(f"[capture] rank 0 of {arch} {step} on mesh {shape}: kernel nodes x ranks = "
                f"the simulated run's launches "
                f"({ {k: n for k, n in run['launches'].items() if n} })")


def check_rg_decode_capture(by_key, runs):
    """Gate (viii) of phase_capture: rank 0's program of recurrentgemma-9b's
    decode step on (16, 16) (MESH_RG_DECODE_CAPTURE) has no kernel node, as
    phase 8's sharded decode of its 5-layer cut launched none (`runs`: the
    bf16 runs by (config, mesh))."""
    run = next((r for (config, _), r in runs.items() if config.startswith(RG_ARCH)), None)
    if run is None:
        fail(f"phase 8 ran no bf16 {RG_ARCH} prefill under a mesh: {list(runs)}")
    shape, batch, cache_len = MESH_RG_DECODE_CAPTURE
    d = by_key[(RG_ARCH, mesh_what("decode", shape, batch, cache_len))]
    comm = {k: f"{v['count']} ({v['bytes'] / 1e6:.3f} MB)" for k, v in sorted(d["comm"].items())}
    log(f"[capture] rank 0 of {RG_ARCH} decode on mesh {shape} ({d['world']} ranks, B {batch}, "
        f"cache {cache_len}): {d['parsed_flops']:.6e} FLOPs a rank, {d['parsed_hbm_bytes']:.6e} "
        f"bytes, COMM_COLL {comm}; kernel nodes {d['kernel_nodes']}; {d['seconds']:.1f} s")
    if d["world"] != math.prod(shape) or any(d["kernel_launch_nodes"].values()) \
            or any(run["decode"]["launches"].values()):
        fail(f"capture {RG_ARCH} decode on {shape}: kernel nodes {d['kernel_launch_nodes']}, "
             f"phase 8's sharded decode launched {run['decode']['launches']}: want none")


def check_decode_captures(by_key):
    """Gate (vi) of phase_capture: rank 0's program of qwen3-8b's decode step
    on (16, 16) (MESH_DECODE_CAPTURES) has no kernel node, and under
    seq_shard_cache every collective's count and bytes are the same at both
    cache lengths (no collective moves the cache)."""
    seq = []
    for shape, batch, cache_len, seq_shard in MESH_DECODE_CAPTURES:
        c = by_key[(QWEN, mesh_what("decode", shape, batch, cache_len, seq_shard))]
        comm = {k: f"{v['count']} ({v['bytes'] / 1e6:.6f} MB)" for k, v in sorted(c["comm"].items())}
        log(f"[capture] rank 0 of {QWEN} decode on mesh {shape} ({c['world']} ranks, B {batch}, "
            f"cache {cache_len}{', seq_shard_cache' if seq_shard else ''}): "
            f"{c['parsed_flops']:.6e} FLOPs a rank, {c['parsed_hbm_bytes']:.6e} bytes, COMM_COLL "
            f"{comm}, {c['comm_bytes'] / 1e6:.6f} MB in all; kernel nodes {c['kernel_nodes']}; "
            f"{c['seconds']:.1f} s")
        if c["world"] != math.prod(shape) or any(c["kernel_launch_nodes"].values()):
            fail(f"capture {QWEN} decode mesh {shape} cache {cache_len}: world {c['world']}, "
                 f"kernel nodes {c['kernel_launch_nodes']}, want none")
        if seq_shard:
            seq.append((cache_len, c["comm"]))
    (l1, c1), (l2, c2) = seq
    if c1 != c2:
        fail(f"capture {QWEN} decode under seq_shard_cache: collectives at cache {l1} {c1}, "
             f"at {l2} {c2}")
    log(f"[capture] rank 0 of {QWEN} decode under seq_shard_cache: every collective's count "
        f"and bytes the same at cache {l2} and {l1}: no collective moves the cache")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels phase (prints no result line)")
    ap.add_argument("--capture-process", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no GPU found (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's package is missing ({SRC}/repro_torch): "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    if args.capture_process:
        return capture_main(torch)
    seconds = {}

    def timed(label, fn, *fn_args, **fn_kw):
        """fn(*fn_args, **fn_kw), its wall seconds kept under `label`."""
        t0 = time.perf_counter()
        out = fn(*fn_args, **fn_kw)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return out

    card = timed("device", phase_device, torch)
    ptxas_served, ptxas_bwd, ptxas_ssd_bwd, ptxas_rglru_bwd = timed("build", phase_build)
    flash = timed("kernels flash_attention", phase_kernels, torch, ptxas_served)
    flash["lse"] = timed("kernels flash_attention lse", phase_kernels_flash_lse, torch)
    flash_bwd = timed("kernels flash_attention_bwd", phase_kernels_flash_bwd, torch, ptxas_bwd)
    ssd = timed("kernels ssd", phase_kernels_ssd, torch)
    ssd_bwd = timed("kernels ssd_bwd", phase_kernels_ssd_bwd, torch, ptxas_ssd_bwd)
    scan = timed("kernels rglru_scan", phase_kernels_rglru, torch)
    scan_bwd = timed("kernels rglru_scan_bwd", phase_kernels_rglru_bwd, torch, ptxas_rglru_bwd)
    kernels = [flash, flash_bwd, ssd, ssd_bwd, scan, scan_bwd]
    if args.kernels_only:
        log(f"[time] seconds by phase: {seconds}; total {time.perf_counter() - t_start:.1f} s")
        log(json.dumps({"kernels": kernels}))
        log(card)
        return 0
    from repro_torch.configs.registry import get_config
    captures = start_captures()

    def count(arch, kind):
        return kind_layers(get_config(arch), kind)[0]

    def k1_count(arch):
        """K1's launches in one prefill of `arch` as the serve phase cuts it."""
        return len(k1_layers(serve_config(get_config, arch)))

    by_arch = {ARCH: timed(f"serve {ARCH}", phase_serve, torch, ARCH, {
        "flash_attention": k1_count(ARCH)}, count_flops=True)}
    torch.cuda.empty_cache()
    by_arch[SSM_ARCH] = timed(f"serve {SSM_ARCH}", phase_serve, torch, SSM_ARCH,
                              {"ssd": count(SSM_ARCH, "ssd")})
    torch.cuda.empty_cache()
    by_arch[RG_ARCH] = timed(f"serve {RG_ARCH}", phase_serve, torch, RG_ARCH, {
        "rglru_scan": count(RG_ARCH, "rglru"),
        "flash_attention": k1_count(RG_ARCH)})
    torch.cuda.empty_cache()
    grad = timed(f"grad {ARCH}", phase_grad_check, torch, ARCH)
    train = timed(f"train {ARCH}", phase_train, torch, card, ARCH, count_flops=True)
    ssm_grad = timed(f"grad {SSM_ARCH}", phase_grad_check, torch, SSM_ARCH)
    timed("autograd on the card", phase_autograd_on_card, torch)
    ssm_train = timed(f"train {SSM_ARCH}", phase_train, torch, card, SSM_ARCH)
    rg_grad = timed(f"grad {RG_ARCH}", phase_grad_check, torch, RG_ARCH)
    rg_train = timed(f"train {RG_ARCH}", phase_train, torch, card, RG_ARCH)
    # the other dense archs on K1 alone: 36, 40 and 48 launches a prefill
    for arch in DENSE_ARCHS:
        by_arch[arch] = timed(f"serve {arch}", phase_serve, torch, arch, {
            "flash_attention": k1_count(arch)})
        torch.cuda.empty_cache()
    qwen_grad = timed(f"grad {QWEN}", phase_grad_check, torch, QWEN)
    dense_train = {arch: timed(f"train {arch}", phase_train, torch, card, arch)
                   for arch in DENSE_ARCHS}
    # the MoE archs at their serving cuts: 20 and 8 K1 launches a prefill
    for arch in MOE_ARCHS:
        by_arch[arch] = timed(f"serve {arch}", phase_serve, torch, arch, {
            "flash_attention": k1_count(arch)})
        torch.cuda.empty_cache()
    moe_grad = timed(f"grad {MIXTRAL}", phase_grad_check, torch, MIXTRAL)
    moe_train = {arch: timed(f"train {arch}", phase_train, torch, card, arch)
                 for arch in MOE_ARCHS}
    # the cross-attention archs, every gate at GATE: seamless at full size (36
    # K1 a prefill: 12 enc, 12 causal, 12 xattn) and llama at 30 layers (24
    # causal, 6 cross); none in decode
    for arch in CROSS_ARCHS:
        by_arch[arch] = timed(f"serve {arch}", phase_serve, torch, arch, {
            "flash_attention": k1_count(arch)})
        torch.cuda.empty_cache()
    cross_grad = {arch: timed(f"grad {arch}", phase_grad_check, torch, arch)
                  for arch in CROSS_ARCHS}
    cross_train = {arch: timed(f"train {arch}", phase_train, torch, card, arch)
                   for arch in CROSS_ARCHS}
    # the serving path and the train step under a mesh: every rank simulated
    # on the card
    mesh_runs = timed("mesh", phase_mesh, torch, card)
    mesh_train = timed("mesh train", phase_mesh_train, torch, card)
    mesh_train.update(timed("mesh train moe", phase_mesh_train, torch, card, MESH_MOE_TRAIN))
    # the capture of every measured path against its run
    measured = {(serve_config(get_config, a).name, "prefill"): (n["launches"], n["prefill_ms"])
                for a, n in by_arch.items()}
    for t in (train, ssm_train, rg_train):
        measured[(t["config"], "train")] = (t["launches_per_step"], t["step_ms"])
    real_flops = {(serve_config(get_config, ARCH).name, "prefill"): by_arch[ARCH]["flops"],
                  (train["config"], "train"): train["flops"]}
    timed("capture", phase_capture, torch, card, captures, measured, real_flops, mesh_runs,
          mesh_train)
    flash["launches_by_path"] = {f"serve {a}": n["launches"]["flash_attention"]
                                 for a, n in by_arch.items() if n["launches"]["flash_attention"]}
    trained_on_k1 = {ARCH: train, RG_ARCH: rg_train, **dense_train, **moe_train, **cross_train}
    for a, t in trained_on_k1.items():
        flash["launches_by_path"][f"train {a}"] = t["launches"]["flash_attention"]
    for path, r in {**mesh_runs, **mesh_train}.items():
        flash["launches_by_path"][path] = r["launches"]["flash_attention"]
    flash["launches"] = sum(flash["launches_by_path"].values())
    flash_bwd["launches_by_path"] = {f"train {a}": t["launches"]["flash_attention_bwd"]
                                     for a, t in trained_on_k1.items()}
    for path, r in mesh_train.items():
        flash_bwd["launches_by_path"][path] = r["launches"]["flash_attention_bwd"]
    flash_bwd["launches"] = sum(flash_bwd["launches_by_path"].values())
    flash_bwd["grad_check"] = grad
    flash_bwd[f"grad_check {QWEN}"] = qwen_grad
    flash_bwd[f"grad_check {MIXTRAL}"] = moe_grad
    for arch, g in cross_grad.items():
        flash_bwd[f"grad_check {arch}"] = g
    flash_bwd["train"] = {k: v for k, v in train.items() if k != "launches"}
    flash_bwd["train_by_arch"] = {a: {k: v for k, v in t.items() if k != "launches"}
                                  for a, t in {**dense_train, **moe_train,
                                               **cross_train}.items()}
    ssd["launches_by_path"] = {f"serve {SSM_ARCH}": by_arch[SSM_ARCH]["launches"]["ssd"],
                               f"train {SSM_ARCH}": ssm_train["launches"]["ssd"]}
    ssd["launches"] = sum(ssd["launches_by_path"].values())
    ssd_bwd["launches"] = ssm_train["launches"]["ssd_bwd"]
    ssd_bwd["launches_by_path"] = {f"train {SSM_ARCH}": ssd_bwd["launches"]}
    ssd_bwd["grad_check"] = ssm_grad
    ssd_bwd["train"] = {k: v for k, v in ssm_train.items() if k != "launches"}
    scan["launches_by_path"] = {f"serve {RG_ARCH}": by_arch[RG_ARCH]["launches"]["rglru_scan"],
                                f"train {RG_ARCH}": rg_train["launches"]["rglru_scan"]}
    for path, r in mesh_runs.items():
        if r["launches"]["rglru_scan"]:
            scan["launches_by_path"][path] = r["launches"]["rglru_scan"]
    scan["launches"] = sum(scan["launches_by_path"].values())
    scan_bwd["launches"] = rg_train["launches"]["rglru_scan_bwd"]
    scan_bwd["launches_by_path"] = {f"train {RG_ARCH}": scan_bwd["launches"]}
    scan_bwd["grad_check"] = rg_grad
    scan_bwd["train"] = {k: v for k, v in rg_train.items() if k != "launches"}
    log(f"[time] seconds by phase: {seconds}; total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
