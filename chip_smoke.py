#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's paths on the card and checks them: dense-LM
continuous-batching serving, MoE serving, the zamba2 hybrid's prefill and
decode, training of every family, prefill and decode of the xLSTM, whisper
and VLM families, the paper's RL rollouts, the multi-rank paths (the
int8 ring all-reduce, data-parallel and ZeRO-2 training, MoE dispatch
groups, the resharded restore), tensor-parallel serving and tensor-parallel
training over the "model" axis, FSDP and expert parallelism over the
"data" axis, and tensor parallelism of the hybrid and whisper. Every phase
exits non-zero on failure; nothing is caught and carried on.

  1. requires a CUDA device; prints the card's name and power limit;
  2. builds the four kernels from `src/repro_torch/kernels/csrc/`;
  3. holds each kernel against its plain PyTorch version on the card, and
     times kernel, plain version and, where one exists, the library call
     (a yardstick only, never used by the port):
     a/b. flash and decode attention at llama3-8b shapes (Hq=32, D=128),
        at zamba2's (Hq=Hkv=32, D=80; timed at its prefill and decode
        shapes) and at stablelm-12b's (Hq=32, Hkv=8, D=160);
        `F.scaled_dot_product_attention` is the yardstick. Each case
        prints the kernel `route` chose (flash: the bf16 tensor-core kernel
        or the CUDA-core one; decode: the split-S kernel or the first
        version); a sweep over T = 16-2048 at each of the three widths
        prints flash's device time, the CUDA-core kernel's on the same
        inputs, SDPA's and the bound; each timed decode prints the device
        and event times of the kernel, of the first version on the same
        inputs and of SDPA;
     c. the int8-cache decode at phase 5's shapes and at qwen1.5-32b's
        padded heads, timed the same way (no PyTorch call reads int8);
     d. the grouped expert matmul at phi3.5-moe's decode (C=4) and prefill
        (C=160) capacities in both directions, and at arctic's width, then
        a capacity sweep (C = 4-160) that prints the kernel `route` chose
        (the bf16 tensor-core kernel or a CUDA-core one), its time, the
        bound and `torch.bmm`'s time, the yardstick;
     e. the SSD scan at zamba2's shapes (H=80, P=N=64, chunk 256), fp32 and
        bf16, and at fp32 against the sequential recurrence too, each case
        naming the kernel `route` chose (fp32: the chunk-parallel
        tensor-core path; bf16: the first version); a sweep over T =
        256-4096 at B=4 prints the tensor-core path's device time beside the
        first version's on the same inputs and the bound, and both kernels'
        relative L2 distance to an fp64 run; no single PyTorch call
        computes it;
     f. flash and decode attention at phase 9's shapes: whisper-tiny's
        non-causal encoder (B=8 T=1536 H=6 D=64), its cross-attention
        (Tq=64, Tk=1536) and decoder, internvl2-76b's prefill (Hq=64 Hkv=8
        D=128); decode over whisper's self cache and its full 1536-row
        cross cache (D=64) and over internvl2's replicated cache (Hq=64
        Hc=16 D=128), each held to its plain version and timed beside the
        plain version, SDPA and the bound;
  4. llama3-8b at its published width and depth with random bf16 weights
     from a seeded generator: a ServeEngine with 8 slots of 2048 tokens
     serves 16 requests (prompts of 16-1024 tokens, 32 new tokens each); the
     kernels' launch counts are read around this run. Then the prefill
     logits of one request and the logits of one decode step are held
     against the same model run with the plain kernels and in fp32;
  5. the same width with an int8 KV cache at 2 layers, gated the same way;
  6. phi3.5-moe at its published width and 16 of its 32 layers, served as
     in phase 4 (moe_gmm launched 3 times per layer in every prefill and
     decode step, every one through the tensor-core kernel, which the
     per-kernel launch counts show; so must every flash launch of phases
     4-7 be, and every decode launch through the split-S kernel); on its
     first 4
     layers the kernel path's logits are held to the plain bf16 path's, and
     so is the share of routing choices on which the two agree;
  7. zamba2-2.7b at its published width and depth through the model
     interface: prefill of 4 prompts of 1024 tokens, then 32 decode steps
     on the rolling cache; the prefill timed three times (median), every
     ssd_scan launch through the tensor-core path (`ssd_path_gate`), the
     SSD kernels' device ms per prefill from a profiled prefill; launch
     counts, profile, and logits gated on the prefill and on one decode
     step. Each profiled decode window of phases 4, 6 and 7 prints the
     decode kernels' device ms per step;
  8. training: a. at llama3-8b's (Hq=32 Hkv=8 D=128, also with a window of
     256), zamba2's (D=80) and stablelm-12b's (D=160) shapes, bf16 causal,
     T=1024: the lse of both flash kernels held to the plain version's
     (LSE_TOL), and flash_attention_vjp's dq/dk/dv (the kernel forward, the
     plain backward) no further from autograd through `ref.attention_ref`
     in fp32 than NOISE_FACTOR times the plain bf16 path's; the forward's
     device time with and without the lse write, the backward's time,
     SDPA's backward's and the bound; b. llama3-8b at its published width
     and 4 of its 32 layers, bf16, AdamW through `make_train_step`: 6 steps
     of 4 x 1024 TokenPipeline tokens in 2 microbatches, each step's wall
     time, the median of steps 2-6, tokens/s, MFU and peak memory, a
     profiled step; gated on finite losses and grad norms, on every flash
     launch going through the tensor-core kernel with the lse (the forward
     and the remat recompute of each layer and microbatch, counted exactly)
     and no other kernel launching, then on the gradients (embeddings, one
     block's wq/wo/w2, the final norm) at B=1: no further from the fp32
     model's than NOISE_FACTOR times the plain bf16 path's; c. the `demo`
     preset of examples/train_torch.py trained 12 steps with checkpoints,
     then crashed at step 9 and restarted by a fresh Trainer: the final
     states equal leaf for leaf; d. moe_gmm's backward products, dx = dy
     w^T and dw = x^T dy, against their plain versions at phi3.5-moe's
     width in both directions at C = 4, 160 and 320 (the training
     microbatch's capacity), naming the kernel `route` chose; at C=320 the
     time of each, the plain version's, torch.bmm's and the bound; then the
     gradients of GroupedMatmul (phi's C=320, bf16) and SSDScan (zamba2's
     B=2 T=1024, the model's fp32 views) against autograd through the plain
     versions in fp64, the kernel path no further than NOISE_FACTOR times
     the plain path's, and the SSD backward's time and bound; e. phi3.5-moe at its
     published width and 2 of its 32 layers, trained as in b: gated on
     finite losses and grad norms, on exact launch counts (flash with the
     lse and moe_gmm's three products in the forward and the remat of each
     layer and microbatch, dx and dw once each), every moe_gmm, dx and dw
     launch through the tensor-core kernel, then on the gradients at B=1
     against the plain bf16 path, with the kernel path replaying the plain
     path's routing (`routed_as`); f. zamba2-2.7b at its published width
     and depth, trained as in b: every ssd_scan launch (forward and remat
     of each mamba2 layer and microbatch) through the tensor-core path and
     every flash launch through `flash_wgmma` with the lse, then the
     gradients of the embeddings, one mamba2 block's w_zx, w_out, conv_w,
     dt_bias and A_log, the shared block's wq and the final norm at B=1
     against the fp32 model, as in b; g. whisper-tiny at its published
     width and depth, trained as in b on 4 x 448 tokens (its decoder's
     context) with 4 x 1536 bf16 stub frames from the seed: every flash
     launch with the lse through `flash_wgmma`, 2 x (encoder layers + 2 x
     decoder layers) a microbatch and step (self- and cross-attention,
     forward and remat), then the gradients of the embeddings, an encoder
     layer's wq and w2, a decoder layer's wq, cross wk and wo and w2, and
     the final norm at B=1 against the fp32 model; MFU counts the encoder's
     weights and the cross k/v projections over the frames, the rest over
     the tokens; h. xlstm-350m at its published width and depth, trained
     on 32 x 64 tokens: no kernel launched, and its bf16 gradients'
     distance to the fp32 model's printed; i. internvl2-76b at its
     published width and 2 of its 80 layers, trained as in b on 4 x 1024
     positions whose first 256 are bf16 patch embeddings from the seed,
     gated as in b;
  9. the families with no earlier path, through the model interface with
     bf16 random weights from the seed: a. whisper-tiny at its published
     width and depth (4 encoder and 4 decoder layers, d_model 384, 6 heads
     of 64): the encoder over 8 stub inputs of 1536 frames (timed), the
     prefill of 8 prompts of 64 tokens, 32 decode steps on a cache of 128
     rows; exactly 12 flash launches a prefill (4 encoder non-causal, 4
     decoder causal, 4 cross non-causal with Tq=64, Tk=1536), all
     `flash_wgmma`, and 8 decode launches a step (4 self, 4 cross), all
     `decode_split`; the logits gate (logits_gate) on the prefill and on one
     decode step; a profiled decode window; b. xlstm-350m at its published
     width and depth (24 layers, d_model 1024, mLSTM heads of 512): the
     prefill of 4 prompts of 1024 tokens (median of three), 32 decode
     steps, no kernel launched (the reference's xLSTM is jnp), finite
     logits and the bf16 run's distance to fp32 printed, one sLSTM and one
     mLSTM block timed (the sequential sLSTM's host cost) and the decode
     step profiled, and in fp32 over 256 tokens each block's parallel form
     held to its decode step replayed over the same input
     (XLSTM_BLOCK_L2), the whole model's two forms printed; c.
     internvl2-76b at its published width and 24 of its 80 layers: the prefill of 4 prompts of 1024 positions whose first
     256 are patch embeddings, 32 decode steps on the replicated (16-head)
     cache; exactly 24 flash launches a prefill, all `flash_wgmma`, and 24
     decode launches a step, all `decode_split`; the logits gate on the
     first 4 layers, as phase 6;
 10. the RL rollout unit: `rollout_task` of 1000 steps for each of the 14
     environments on the card (the artifact's shape, Humanoid's 376
     columns, finite rewards, interactions/s), the same weights and initial
     state run on the CPU (observations within RL_L2 over the first
     RL_COMPARE_STEPS steps, the distance over all 1000 printed, the CPU's
     interactions/s), no kernel launched; then `run_benchmark_local` with 4
     tasks of 1000 steps for Cartpole and Humanoid through a pool of
     threads (`ThreadPoolCluster`);
 11. the multi-rank paths, their ranks started on the cards present, one
     set a world size that runs every multi-rank phase's jobs in turn
     (`repro_torch.distributed.Ranks`; NCCL with a card a rank, else gloo,
     the payload through host memory; one line names W, the backend, each
     rank's device and the card): a. the int8 ring all-reduce
     (`compressed_psum_mean`) on 4 ranks over the gradient tree of one
     llama3-8b layer at full width (218 M fp32 entries a rank): within 5%
     of the exact mean, the 20-step error-feedback drift bound, the norms
     and wq against the same ring on the CPU (RING_CPU_TOL), its median time
     beside `dist.all_reduce`'s on the same tensors and its bytes a hop
     beside a bf16 ring's; b. llama3-8b at its published width and 2 of its
     32 layers trained on 2 ranks, 2 AdamW steps of 4 x 1024 tokens in 2
     microbatches, plain data parallelism and ZeRO-2 (the accumulator and
     AdamW's moments sharded by the reference dry-run's ZeRO specs), each
     held to the single process's steps on the global batch, run first in
     this process: losses and grad norms (DP_METRIC_TOL), the params'
     distance over the update (DP_UPDATE_TOL), ZeRO-2 to plain DP alike,
     the flash launches of each rank exact, all `flash_wgmma` with the lse;
     each rank's median step, tokens/s, peak memory and accumulator bytes;
     c. phi3.5-moe at its published width and 1 of its 32 layers, one step
     on 2 ranks with one dispatch group each, its experts split over the
     ranks (EP: 8 a rank, the slots through the all-to-all), against one
     process with 2 groups: every (token, k) routing choice alike, the loss
     and the aux loss (its means over the ranks) within DP_METRIC_TOL,
     `gmm_wgmma`'s forward, dx and dw launches exact per rank; d. b's
     ZeRO-2 state saved
     from the 2 ranks (rank 0 writes), restored into this process and, with
     the DP axes moved off the layer axis, into 2 ranks: every block
     bit-identical to the saving ranks' (`digest`);
 12. the dry-run (`repro_torch.launch.dryrun`) held to the card: a. for 8b's
     train step (llama3-8b x 4 layers, 4 x 1024 tokens in 2 microbatches),
     8e's (phi3.5-moe x 2 layers, the same batch), one llama3-8b decode step
     at full size on a cache of 8 slots x 2048 rows and phase 7's zamba2
     prefill (4 x 1024), the account of the step on the meta device and the
     same step's on the card under the same `roofline.CostModel`: FLOPs,
     HBM bytes, kernel ops by name and the live bytes' high-water mark
     equal, the kernel ops equal to the wrappers' launch counts, the
     allocator's peak (`max_memory_allocated`) within ACCOUNT_PEAK_RATIO of
     the account's, and the step's measured time no shorter than the
     roofline's largest term; b. 11b's ZeRO-2 step on an abstract (2, 1)
     mesh: its accumulator bytes a rank equal to 11b's ranks', its peak
     beside theirs within ACCOUNT_PEAK_RATIO; c. the production sweep of
     llama3-8b, phi3.5-moe and zamba2 on the (1, 1) and (4, 1) meshes (the
     dry-run's CLI, in low-priority processes started after the build that
     run beside phases 3-11), one line a cell: status, peak_per_device_gb,
     fits_80gb, the dominant term, roofline_fraction; d. (run after phase
     15) the account of 15b's step on rank 0 of an abstract (2, 2) mesh on
     meta (computed beside phases 3-11) against rank 0's account of 15b's
     last step on the card, its host-staged collectives counted as the card's:
     FLOPs, bytes, collectives, kernel ops, the high-water mark and the
     accumulator equal, the allocator's peak within ACCOUNT_PEAK_RATIO. The
     kernels' bounds everywhere come from the kernel ops' cost formulas
     (`kernels/costs.py`) and `roofline.py`'s peaks;
 13. tensor-parallel serving over the "model" axis of a (1, n) mesh, the
     ranks spawned on the cards present as in 11 (one card: gloo, every
     collective's payload through host memory; n cards: NCCL), each rank
     holding its blocks of the weights (drawn whole from the seed, a layer
     at a time, the rest freed) and its heads of the cache: a. llama3-8b at
     published width and depth on 4 ranks, a ServeEngine of 8 slots x 2048
     serving phase 4's first 8 requests, 16 new tokens each; b. phi3.5-moe
     at published width, 8 of 32 layers, expert-TP on 2 ranks (d_ff 3200 a
     rank), 8 requests through the engine; c. qwen1.5-32b at published
     width, 16 of 64 layers, on 4 ranks (12 padded heads a rank, the QKV
     bias, the int8 cache) through the model interface: one prefill of 4 x
     512, 8 decode steps. Each first runs the whole model in this process
     (the same seed), then the ranks: every rank's blocks' digests equal
     this process's blocks of the whole draw, its param bytes the sum of
     its blocks; its launches exact, every flash launch on `flash_wgmma`,
     every decode launch on `decode_split`, every moe_gmm launch on
     `gmm_wgmma` at d_ff / n; the greedy outputs (and MoE routing) identical
     across ranks, 13a's beside phase 4's; the gate's prefill and decode
     step logits (rank 0's kernel path) held to this process's plain path
     in bf16 and fp32 by `logits_gate` (13b on the first 4 layers, as phase
     6, with the routing agreement); prefill and decode times, each rank's
     all-reduce and all-gather ms a step and device idle share from a
     profiled window, each rank's peak memory beside the single process's;
     d. flash, decode and moe_gmm at the ranks' shapes (and a kv-head
     selection of a replicated k/v) against their plain versions, the
     route named and gated, timed beside the library call and the bound;
 14. tensor-parallel training over the "model" axis, ranks as in 13, each
     holding its blocks of the weights and of the AdamW state: a. llama3-8b
     at published width, 4 of 32 layers, on (1, 4); b. phi3.5-moe at
     published width, 2 of 32 layers, expert-TP on (1, 2); c. llama3-8b x 2
     on (2, 2), ZeRO-2 over the data axis; each 2 steps of phase 8b's
     batch shape (4 x 1024 TokenPipeline tokens, 2 microbatches) at DP_LR, first
     in this process, then on the ranks from the same seed (phi's ranks
     replaying its routing): losses and grad norms within DP_METRIC_TOL,
     each rank's blocks within
     DP_UPDATE_TOL of their update from the single process's, the leaves no
     rank splits bit-identical on every rank, the launches exact (forward
     and remat) and every flash launch on `flash_wgmma` with the lse, every
     moe_gmm, dx and dw launch on `gmm_wgmma`; each rank's step time and
     peak memory beside the single process's, and a profiled step's TP
     spans (a, b: all-reduce, all-gather, reduce-scatter, count and ms);
     d. flash with the lse at a TP 4 rank's training heads and moe_gmm's dx
     and dw at a TP 2 rank's d_ff, against their plain versions, timed
     beside SDPA or torch.bmm and the bound;
 15. FSDP and expert parallelism over the "data" axis, on four ranks of a
     (2, 2) mesh, ranks as in 13, each holding the reference's blocks (its
     "model" block, and over "data" the FSDP leaves' d_model and the
     experts): a. phi3.5-moe at published width, 2 of 32 layers, EP (8
     experts a rank, the all-to-all), expert-TP and ZeRO-2; b. qwen1.5-32b
     at published width, 2 of 64 layers, FSDP (every projection and the
     embeddings gathered before use), TP and ZeRO-2; each trained and gated
     as 14 (2 steps of 4 x 1024 in 2 microbatches, the single process with
     the data ranks' 2 dispatch groups, phi's ranks replaying its routing),
     and the all-gathers, reduce-scatters and all-to-alls of a step
     (`data_parallel.calls`, by span name) equal to the count worked out
     from the code (dp_spans); b's last step under the dry-run's account
     (12d); c.
     decode on (2, 2): phi3.5-moe x 2 (FSDP and EP, as the reference serves
     it) and qwen1.5-32b x 2 (FSDP, the int8 cache), 4 prompts of 512
     tokens, two a data rank, then 8 decode steps: each rank's blocks'
     digests and bytes, its launches exact, the collectives of a decode
     step the code's, the ranks of a data coordinate alike, and the data ranks'
     prefill and decode-step logits put together held by 13's logits gate
     to one process's plain path on the same dispatch groups; d. moe_gmm
     at an EP x TP rank's shapes (E=8, C=320, d_ff 3200: forward, dx and dw)
     and flash with the lse at qwen's TP 2 training heads, against their
     plain versions, timed beside torch.bmm or SDPA and the bound. Prints
     each rank's step time and peak memory beside the single process's;
 16. tensor parallelism of the hybrid, whisper and the xLSTM over the
     "model" axis, on four ranks of a (1, 4) mesh, ranks as in 13 (each
     rank's mamba2 blocks on 20 of zamba2's 80 SSM heads, w_zx's product
     gathered, the gated norm's statistic summed; whisper's 6 heads gathered
     by column; the xLSTM's blocks on 1 of its 4 heads, w_up's product and
     the sLSTM's h gathered, the mLSTM norm's statistic summed): a.
     zamba2-2.7b at published width, 12 of 54 layers (two super-blocks, the
     shared block twice), phase 7's prefill of 4 x 1024 and 8 decode steps
     through the model interface; b. zamba2-2.7b x 6 (one super-block)
     trained as 14 (2 steps of 4 x 1024 in 2 microbatches); c. whisper-tiny
     at published width and depth, 9a's prefill (8 x 64 tokens over 8 x 1536
     frames) and 8 decode steps, and 8g's training (4 x 448 tokens and 4 x
     1536 frames, 2 steps); e. xlstm-350m at published width and 8 of its
     24 layers (one super-block), 4 prompts of 256 tokens and 8 decode
     steps, and 8h's training in fp32 (32 x 64 tokens in 2 microbatches, 2
     steps). At 24 layers the random-weight model is chaotic: the plain bf16
     path's logits sit 1.00 rel L2 from fp32's, so logits_gate would hold
     nothing, and in fp32 two single runs whose sums differ in order only
     start from first gradients 0.36-0.49 rel L2 apart (grad norm ~1e4),
     so no gate can hold a rank there; at 8 layers in bf16 they sit 0.97
     of their update apart. Serving gates: each rank's blocks' digests and bytes, its launches exact and on `flash_wgmma`,
     `decode_split` and the SSD scan's tensor-core path (the xLSTM none),
     outputs and gate logits identical across ranks, the gate's logits held
     by `logits_gate` to this process's plain path in bf16 and fp32, each
     rank's SSM state after the prefill, and its mLSTM C (last super-block)
     and sLSTM c after the first decode step, held the same way to this
     process's on its heads (`state_gate`). Training gates: 14's, except
     that the blocks' distance over the update is held at NOISE_FACTOR times
     the config's rounding floor where that exceeds DP_UPDATE_TOL (the
     single trained again on the plain kernels, or for the xLSTM, which
     launches none, with its mLSTM heads in reverse order, a symmetry of
     the model: zamba2's two steps move 0.091 of their update on the order
     of sums alone, llama3-8b x 4's 0.025); 16e's second grad norm at
     XLSTM_STEP2_NORM_TOL, and each 16e rank's blocks of the first step's
     gradient, by leaf kind, within GRAD_KIND_TOL (relative L2; the
     heads-reversed run's under half of it). The TP collectives of every
     prefill,
     decode step and train step equal the code's count (tp_spans); d. the
     SSD scan at a rank's 20 heads (B=4 T=1024 fp32), flash without and
     with the lse at the shared block's 8 heads (B=4 T=1024 D=80) and
     decode on a rank's cache (B=4, 8 heads, 1032 rows), against their
     plain versions, timed beside SDPA where it computes the same and the
     bound;
 17. Adafactor and checkpoints on four ranks of a (2, 2) mesh, in phase
     15's job on the ranks (run after 16): a. 15a's phi3.5-moe x 2 (EP over
     "data", expert-TP) and b. 15b's qwen1.5-32b x 2 (FSDP, TP), each with
     Adafactor, ZeRO-2 accumulators and a ZeRO-1 state (the rank's blocks
     of every factored statistic, their means summed over the ranks that
     cut them), trained and gated as 15 trains and gates (15's
     collectives a step; twice each config's rounding floor, measured by
     tools/update_floor.py, is under the 0.1 of the update that the ranks'
     blocks are held to); c. a's final state
     saved by the Checkpointer from the 4 ranks and restored into one
     process and into the ranks, every rank's blocks bit-identical
     (digests) to both restores, the seconds of each printed; d. the
     dry-run's (2, 2) account of a's rank 0 on meta against one more step
     of that rank on the card, routed by its own router: FLOPs, bytes,
     kernel ops and collectives (Adafactor's sums among them) equal, the
     high-water mark as 12d holds it;
 18. prints the kernel table as one JSON line (moe_gmm's with its dx and dw
     at C=320, ssd_scan's with its plain backward, flash's, decode's,
     moe_gmm's and ssd_scan's with their rows at phase 9's, 13's, 14's,
     15's and 16's shapes; the launches of every phase's main path, 16e's
     xLSTM adding none, since its blocks run no kernel) and, last, the
     device line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import subprocess
import sys
import contextlib
import time
import types
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BF16_TOL = 2e-2      # tests/test_kernels.py::_tol
F32_TOL = 2e-5
INT8_TOL = 1e-4      # tests/test_kernels.py int8 decode
# the SSD scan at fp32: sums of up to 256 products and exps of summed decays
# in another order than the plain version's matmuls
SSD_F32_TOL = 1e-4
SSD_SEQ_TOL = 2e-4   # against the sequential recurrence, tests/test_kernels.py
# the model's logits: the kernel path may be at most this many times further
# from the fp32 model than the plain bf16 path is (see logits_gate)
NOISE_FACTOR = 2.0
# The MoE model's logits sit far from fp32 on both bf16 paths (a near-tie
# router choice that bf16 flips sends a token to another random expert), so
# that gate cannot fail there; the kernel path is held to the plain bf16
# path instead, on the sequences that both routed alike (see logits_gate).
# On the H100 the two paths' prefill logits were 1.85e-2 to 2.04e-2 apart in
# relative L2, agreeing on 98.0-98.6% of the routing choices, while flash ran
# on the CUDA cores in fp32; 4.40e-2 and 95.68% (seed 0) with a tensor-core
# flash kernel that rounded the probabilities to bf16 before P.V, and
# 2.275e-2 and 97.93% with the one that carries them as two bf16 halves
# and decode split over S.
MOE_PLAIN_L2 = 5e-2
MOE_ROUTING_AGREEMENT = 0.95
# xlstm-350m's two forms in fp32 (phase 9b): each block's parallel output
# over 256 tokens against its decode step replayed over the same input,
# relative L2. tests/test_torch_xlstm.py::
# test_each_block_s_two_forms_agree holds each block of the SMOKE config
# to this bound on the CPU (and the SMOKE model's last logits, in
# test_decode_replay_equals_the_chunked_prefill). The whole model's last
# logits are printed, not gated: with random weights at full width each
# layer amplifies a perturbation of its input (JAX's own bf16 run sits
# 0.38 from its fp32 run at 8 of the 24 layers, and its two fp32 forms
# 1.2e-4 apart, while one block's stay 1e-6 apart: tools/xlstm_depth_drift.py
# on the CPU), so fp32 rounding reaches the logits at ~1e-2 after 24
# layers on either package.
XLSTM_BLOCK_L2 = 1e-5
# 16e's second grad norm, a rank's against the single process's (fp32):
# AdamW's first step moves every entry by about lr x sign(g), those whose
# gradient is at rounding level by a sign that the order of sums decides, so
# the second gradients differ where the first's did not: the heads-reversed
# single run's sat 4.5e-2 from the single run's at 8 layers (NVIDIA H100
# 80GB HBM3, 700 W, tools/hybrid_tp_phase.py). The first step's loss and
# grad norm and the second's loss keep DP_METRIC_TOL.
XLSTM_STEP2_NORM_TOL = 0.1
# 16e's first gradient, each leaf kind of a rank's blocks against the single
# process's (relative L2, fp32). A fault in how a leaf's gradient is summed
# over the ranks (a missing or doubled all-reduce, a head's share dropped)
# moves its kind by 0.25 or more; at 8 layers the order of sums alone moved
# the heads-reversed run's kinds by up to 5.0e-4 and the ranks' by up to
# 2.2e-3, each kind by 1.9-12x its floor (NVIDIA H100 80GB HBM3, 700 W,
# tools/hybrid_tp_phase.py): the ranks reorder the sums of every product,
# the heads' reversal only those over d_in. The gate holds where the floor
# run sits under half of it.
GRAD_KIND_TOL = 1e-2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
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
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time per call: the card sleeps (torch.cuda._sleep, ~5 ms)
    while the host queues `iters` calls, so the events time the kernels
    back to back and not the host's pace, which cuda_ms reads when a call
    is shorter than its launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def gate(name: str, got, want, tol: float) -> float:
    import torch
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    # the largest error as a share of what the tolerance allows there
    share = ((got.float() - want.float()).abs() / (tol + tol * want.float().abs())).max()
    say(f"  {'ok  ' if ok else 'FAIL'} {name}: max_abs_err {err:.3e} (atol=rtol={tol:g}; "
        f"worst element at {share.item():.2f} of its bound)")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ----------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------------

def _rnd(gen, dev):
    import torch

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
    return rnd


def bound_ms(cost, peak=None):
    """(ms, "operations" or "bytes"): the least time the card takes for a
    kernel op's (FLOPs, bytes), from its cost formula
    (`kernels/costs.py`), at `peak` (default bf16) and the HBM rate
    (`roofline.bound`)."""
    from repro_torch import roofline
    seconds, by = roofline.bound(*cost, peak or roofline.PEAK_FLOPS)
    return seconds * 1e3, by


def decode_times(q, kc, vc, valid, scales=(None, None), nbytes=None):
    """Device time (device_ms) and event time (cuda_ms) of the decode kernel
    `route` picks, of the first version (`path="simt"`) on the same inputs
    and, for a bf16 or fp32 cache, of SDPA with the valid_len mask (no
    PyTorch call reads an int8 cache). Prints them, with the kernel's
    GB/s over the bound's bytes; returns the device times by name and the
    kernel's event time as "kernel_event"."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import costs, ops

    B, Hq, D = q.shape
    Hc, S = kc.shape[1], kc.shape[2]
    calls = {"kernel": lambda: ops.decode_attention(q, kc, vc, valid, *scales),
             "simt": lambda: dk.decode_attention(q, kc, vc, valid, *scales, path="simt")}
    if kc.dtype != torch.int8:
        mask = (torch.arange(S, device=q.device)[None, :] < valid[:, None])[:, None, None, :]
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=Hq != Hc)
    dev = {n: device_ms(fn, 50) for n, fn in calls.items()}
    event = {n: cuda_ms(fn, 50) for n, fn in calls.items()}
    if nbytes is None:
        _, nbytes = costs.decode_cost(B, Hq, Hc, S, D, rows=int(valid.sum()))
    say(f"    {dk.route_for(kc, vc)}: kernel {dev['kernel']:.4f} ms "
        f"({nbytes / dev['kernel'] / 1e6:.1f} GB/s), "
        + ", ".join(f"{n} {t:.4f} ms" for n, t in dev.items() if n != "kernel")
        + "; event time: " + ", ".join(f"{n} {t:.4f} ms" for n, t in event.items()))
    return dict(dev, kernel_event=event["kernel"], sdpa=dev.get("sdpa"))


SPLIT_SWEEP_ROWS = (64, 128, 256, 512, 1024)


def split_sweep(q, kc, vc, valid, scales=(None, None), nbytes=None):
    """The split kernel's device time at each split length of
    SPLIT_SWEEP_ROWS (decode_attention.plan picks one from shapes alone;
    its pick is marked)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import costs

    B, Hq, D = q.shape
    Hc, S = kc.shape[1], kc.shape[2]
    if nbytes is None:
        _, nbytes = costs.decode_cost(B, Hq, Hc, S, D, rows=int(valid.sum()))
    planned, _ = dk.plan(B, Hc, S, D, dk._sm_count(q.device))
    cells = []
    for rows in SPLIT_SWEEP_ROWS:
        ms = device_ms(lambda: dk.decode_attention(q, kc, vc, valid, *scales,
                                                   split_rows=rows), 50)
        cells.append(f"{rows}{'*' if rows == planned else ''} {ms:.4f} ms "
                     f"({nbytes / ms / 1e6:.0f} GB/s)")
    say("    split length sweep, rows (* plan's): " + ", ".join(cells))


FLASH_SWEEP_T = (16, 64, 128, 512, 1024, 2048)


def flash_precision(q, k, v) -> dict:
    """Relative L2 distance of the tensor-core kernel's output and of the
    CUDA-core kernel's (P in fp32) to the plain version run in fp32 on the
    same bf16 inputs, by kernel; both round only the output to bf16 unless
    a kernel rounds P too (tests/test_torch_cuda.py::
    test_flash_tensor_core_kernel_keeps_p_in_fp32_precision holds the first
    within 1.05x of the second)."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    return {p: rel_l2(fk.flash_attention(q, k, v, path=p), want) for p in ("wgmma", "simt")}


def flash_sweep(rnd, B, Hq, Hkv, D, label, timed_T=1024):
    """bf16 causal flash attention over FLASH_SWEEP_T: at each T the kernel
    `route` chose, checked against the plain version, its time, the
    CUDA-core kernel's on the same inputs (`path="simt"`), SDPA's and the
    bound. Times are device times (device_ms); the event times beside them
    (cuda_ms) read the host's pace where a call is shorter than its launch,
    up to T=1024 on a slow host. Returns the row at `timed_T`, with the
    plain version's time."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import costs, ops, ref

    gqa = {"enable_gqa": True} if Hq != Hkv else {}
    say(f"  sweep, bf16 causal B={B} Hq={Hq} Hkv={Hkv} D={D} ({label}):")
    row = None
    for T in FLASH_SWEEP_T:
        q = rnd(B, T, Hq, D).transpose(1, 2)
        k = rnd(B, T, Hkv, D).transpose(1, 2)
        v = rnd(B, T, Hkv, D).transpose(1, 2)
        path = fk.route_for(q, k, v)
        err = gate(f"flash bf16 B={B} T={T} D={D} ({path})", ops.flash_attention(q, k, v),
                   ref.flash_attention_ref(q, k, v), BF16_TOL)
        calls = {"kernel": (lambda: ops.flash_attention(q, k, v), 20),
                 "simt": (lambda: fk.flash_attention(q, k, v, path="simt"), 10),
                 "sdpa": (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 **gqa), 20)}
        dev = {n: device_ms(fn, n_it) for n, (fn, n_it) in calls.items()}
        event = {n: cuda_ms(fn, n_it) for n, (fn, n_it) in calls.items()}
        flops, nbytes = costs.flash_cost(B, Hq, Hkv, T, T, D)
        bound, _ = bound_ms((flops, nbytes))
        say(f"    T={T}: {path}, kernel {dev['kernel']:.4f} ms "
            f"({flops / dev['kernel'] / 1e9:.1f} TFLOP/s), simt {dev['simt']:.4f} ms, sdpa "
            f"{dev['sdpa']:.4f} ms, bound {bound:.4f} ms; event time: "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in event.items()))
        if T == timed_T:
            plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 3)
            dist = flash_precision(q, k, v)
            say(f"    T={T}: plain {plain:.4f} ms; relative L2 distance to fp32: wgmma "
                f"{dist['wgmma']:.4e}, simt {dist['simt']:.4e} (ratio "
                f"{dist['wgmma'] / dist['simt']:.4f})")
            row = dict(max_abs_err=err, ms=dev["kernel"], plain_ms=plain, bound_ms=bound,
                       bound_by="operations", library_ms=dev["sdpa"], simt_ms=dev["simt"],
                       event_ms=event["kernel"], path=path,
                       shape=f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16 causal")
        del q, k, v
    return row


def kernel_phase(gen, dev):
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import costs, ops, ref

    rnd = _rnd(gen, dev)
    table = {}

    say("phase 3a: prefill flash attention, B=1 Hq=32 Hkv=8 D=128, (B,T,H,D) read in place")
    cases = [(T, True, None) for T in (1, 17, 512, 1024, 2048)] + [(2048, True, 512)]
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for T, causal, window in cases:
            q = rnd(1, T, 32, 128, dtype=dtype).transpose(1, 2)
            k = rnd(1, T, 8, 128, dtype=dtype).transpose(1, 2)
            v = rnd(1, T, 8, 128, dtype=dtype).transpose(1, 2)
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            gate(f"flash {str(dtype)[6:]} T={T} window={window} ({fk.route_for(q, k, v)})",
                 out, want, tol)
    # the timed case: the longest prompt the main path draws
    table["flash_attention"] = flash_sweep(rnd, 1, 32, 8, 128, "llama3-8b")

    say("phase 3b: decode attention on the replicated cache, B=8 Hq=32 Hc=16 S=2048 D=128")
    B, Hq, Hc, S, D = 8, 32, 16, 2048, 128
    valid = torch.randint(1, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    valid[0], valid[-1] = 1, S
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        q = rnd(B, Hq, D, dtype=dtype)
        # the (B,S,Hc,D) layer view of a model cache, read as (B,Hc,S,D)
        kc = rnd(B, S, Hc, D, dtype=dtype).transpose(1, 2)
        vc = rnd(B, S, Hc, D, dtype=dtype).transpose(1, 2)
        out = ops.decode_attention(q, kc, vc, valid)
        err = gate(f"decode {str(dtype)[6:]} valid_len={valid.tolist()} "
                   f"({dk.route_for(kc, vc)})", out,
                   ref.decode_attention_ref(q, kc, vc, valid), tol)
        if dtype == torch.bfloat16:
            rows = int(valid.sum())
            times = decode_times(q, kc, vc, valid)
            split_sweep(q, kc, vc, valid)
            plain = cuda_ms(lambda: ref.decode_attention_ref(q, kc, vc, valid), 5)
            bound, _ = bound_ms(costs.decode_cost(B, Hq, Hc, S, D, rows=rows))
            say(f"  time bf16: plain {plain:.4f} ms, bound {bound:.4f} ms")
            table["decode_attention"] = dict(
                max_abs_err=err, ms=times["kernel"], plain_ms=plain, bound_ms=bound,
                bound_by="bytes", library_ms=times["sdpa"], simt_ms=times["simt"],
                event_ms=times["kernel_event"], path=dk.route_for(kc, vc),
                shape=f"B=8 Hq=32 Hc=16 S=2048 D=128 bf16, {rows} valid rows")

    for B, Hq, Hc, label in ((4, 32, 16, "phase 5's grouped cache"),
                             (8, 48, 48, "qwen1.5-32b's padded heads")):
        say(f"phase 3c: int8 decode at {label}, B={B} Hq={Hq} Hc={Hc} S={S} D={D}")
        valid = torch.randint(1, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        valid[0], valid[-1] = 1, S
        kf = rnd(B, S, Hc, D, dtype=torch.float32)
        vf = rnd(B, S, Hc, D, dtype=torch.float32)
        ks = kf.abs().amax(-1, keepdim=True) / 127.0
        vs = vf.abs().amax(-1, keepdim=True) / 127.0
        k8 = torch.round(kf / ks).to(torch.int8).transpose(1, 2)
        v8 = torch.round(vf / vs).to(torch.int8).transpose(1, 2)
        ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
        for dtype, tol in ((torch.float32, INT8_TOL), (torch.bfloat16, BF16_TOL)):
            q = rnd(B, Hq, D, dtype=dtype)
            out = ops.decode_attention(q, k8, v8, valid, ks, vs)
            gate(f"decode int8 cache, q {str(dtype)[6:]} valid_len={valid.tolist()} "
                 f"({dk.route_for(k8, v8)})", out,
                 ref.decode_attention_ref(q, k8, v8, valid, ks, vs), tol)
            if dtype == torch.bfloat16:   # the serving path's
                cost = costs.decode_cost(B, Hq, Hc, S, D, rows=int(valid.sum()),
                                       cache_itemsize=1, scales=True)
                decode_times(q, k8, v8, valid, (ks, vs), nbytes=cost[1])
                split_sweep(q, k8, v8, valid, (ks, vs), nbytes=cost[1])
                say(f"  bound int8: {bound_ms(cost)[0]:.4f} ms ({cost[1] / 1e6:.2f} MB)")
    return table


def head_dim_phase(gen, dev):
    """Flash and decode at zamba2's head dim 80 (Hq = Hkv = 32) and
    stablelm-12b's 160 (Hq = 32, Hkv = 8, cache replicated to 16); flash is
    swept over T at both (at zamba2's batch of 4 for D=80), decode timed at
    zamba2's decode shape and at D=160. Returns the times."""
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import costs, ops, ref

    rnd = _rnd(gen, dev)
    times = {}
    say("phase 3a': flash attention at D=80 (zamba2, Hq=Hkv=32) and D=160 "
        "(stablelm-12b, Hq=32 Hkv=8)")
    for D, Hq, Hkv, cases in ((80, 32, 32, ((1, 17), (4, 1024))),
                              (160, 32, 8, ((1, 77), (1, 1024)))):
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            for B, T in cases:
                q = rnd(B, T, Hq, D, dtype=dtype).transpose(1, 2)
                k = rnd(B, T, Hkv, D, dtype=dtype).transpose(1, 2)
                v = rnd(B, T, Hkv, D, dtype=dtype).transpose(1, 2)
                gate(f"flash D={D} {str(dtype)[6:]} B={B} T={T} ({fk.route_for(q, k, v)})",
                     ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v), tol)
    # zamba2's prefill is 4 prompts of 1024 tokens
    times["flash_d80"] = flash_sweep(rnd, 4, 32, 32, 80, "zamba2-2.7b")
    times["flash_d160"] = flash_sweep(rnd, 1, 32, 8, 160, "stablelm-12b")

    say("phase 3b': decode attention at D=80 (zamba2's rolling cache, B=4 Hq=Hc=32 "
        "S=1056) and D=160 (B=8 Hq=32 Hc=16 S=2048)")
    for D, B, Hq, Hc, S in ((80, 4, 32, 32, 1056), (160, 8, 32, 16, 2048)):
        valid = torch.randint(1, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        valid[0], valid[-1] = 1, S
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            q = rnd(B, Hq, D, dtype=dtype)
            kc = rnd(B, S, Hc, D, dtype=dtype).transpose(1, 2)
            vc = rnd(B, S, Hc, D, dtype=dtype).transpose(1, 2)
            gate(f"decode D={D} {str(dtype)[6:]} valid_len={valid.tolist()} "
                 f"({dk.route_for(kc, vc)})",
                 ops.decode_attention(q, kc, vc, valid),
                 ref.decode_attention_ref(q, kc, vc, valid), tol)
            if dtype == torch.bfloat16:
                # zamba2 mid-way through phase 7's decode: 1024 + 16 valid
                # rows each; D=160 at phase 3b's lengths
                vl = torch.full((B,), 1040, device=dev, dtype=torch.int32) if D == 80 else valid
                say(f"  time D={D} decode B={B} valid_len={vl.tolist()} bf16:")
                t = decode_times(q, kc, vc, vl)
                split_sweep(q, kc, vc, vl)
                t["plain_ms"] = cuda_ms(lambda: ref.decode_attention_ref(q, kc, vc, vl), 5)
                t["bound_ms"], _ = bound_ms(costs.decode_cost(B, Hq, Hc, S, D, rows=int(vl.sum())))
                say(f"    plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
                times[f"decode_d{D}"] = t
    return times


# the attention shapes of phase 9's paths: (label, B, Tq, Tk, Hq, Hkv, D,
# causal, launches a prefill)
NEW_FLASH_SHAPES = (
    ("whisper-tiny encoder", 8, 1536, 1536, 6, 6, 64, False, 4),
    ("whisper-tiny cross", 8, 64, 1536, 6, 6, 64, False, 4),
    ("whisper-tiny decoder", 8, 64, 64, 6, 6, 64, True, 4),
    ("internvl2-76b prefill", 4, 1024, 1024, 64, 8, 128, True, 24),
)
# (label, B, Hq, Hc, S, D, valid rows of each sequence, launches a step)
NEW_DECODE_SHAPES = (
    ("whisper-tiny self cache", 8, 6, 6, 128, 64, 80, 4),
    ("whisper-tiny cross cache", 8, 6, 6, 1536, 64, 1536, 4),
    ("internvl2-76b replicated cache", 4, 64, 16, 1056, 128, 1040, 24),
)


def new_shape_phase(gen, dev) -> dict:
    """Flash and decode attention at the shapes of phase 9's paths
    (non-causal prefill, cross-attention with Tq != Tk, decode over a fixed
    1536-row encoder cache, internvl2's GQA 64/8 and replicated 16-head
    cache), each checked against its plain version in bf16 and timed:
    kernel device ms, plain ms, SDPA's device ms and the bound. Returns
    {"flash_attention": rows, "decode_attention": rows}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import costs, ops, ref

    rnd = _rnd(gen, dev)
    rows = {"flash_attention": [], "decode_attention": []}
    say("phase 3f: flash and decode attention at phase 9's shapes, bf16, (B,T,H,D) read "
        "in place")
    for label, B, Tq, Tk, Hq, Hkv, D, causal, n in NEW_FLASH_SHAPES:
        q = rnd(B, Tq, Hq, D).transpose(1, 2)
        k = rnd(B, Tk, Hkv, D).transpose(1, 2)
        v = rnd(B, Tk, Hkv, D).transpose(1, 2)
        path = fk.route_for(q, k, v)
        shape = (f"B={B} Tq={Tq} Tk={Tk} Hq={Hq} Hkv={Hkv} D={D} bf16 "
                 f"{'causal' if causal else 'non-causal'}")
        err = gate(f"flash {label}, {shape} ({path})", ops.flash_attention(q, k, v, causal=causal),
                   ref.flash_attention_ref(q, k, v, causal=causal), BF16_TOL)
        gqa = {"enable_gqa": True} if Hq != Hkv else {}
        ms = device_ms(lambda: ops.flash_attention(q, k, v, causal=causal), 20)
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                **gqa), 20)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), 3)
        bound, by = bound_ms(costs.flash_cost(B, Hq, Hkv, Tq, Tk, D, causal=causal))
        say(f"    {path}: kernel {ms:.4f} ms, sdpa {sdpa:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({by})")
        rows["flash_attention"].append(dict(
            path_of=label, shape=shape, kernel=path, launches_per_prefill=n, max_abs_err=err,
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=sdpa))
        del q, k, v
    for label, B, Hq, Hc, S, D, n_valid, n in NEW_DECODE_SHAPES:
        q = rnd(B, Hq, D)
        # the (B,S,Hc,D) layer view of a model cache, read as (B,Hc,S,D)
        kc = rnd(B, S, Hc, D).transpose(1, 2)
        vc = rnd(B, S, Hc, D).transpose(1, 2)
        valid = torch.full((B,), n_valid, device=dev, dtype=torch.int32)
        path = dk.route_for(kc, vc)
        shape = f"B={B} Hq={Hq} Hc={Hc} S={S} D={D} bf16, {n_valid} valid rows each"
        err = gate(f"decode {label}, {shape} ({path})", ops.decode_attention(q, kc, vc, valid),
                   ref.decode_attention_ref(q, kc, vc, valid), BF16_TOL)
        t = decode_times(q, kc, vc, valid)
        plain = cuda_ms(lambda: ref.decode_attention_ref(q, kc, vc, valid), 5)
        bound, _ = bound_ms(costs.decode_cost(B, Hq, Hc, S, D, rows=B * n_valid))
        say(f"    plain {plain:.4f} ms, bound {bound:.4f} ms")
        rows["decode_attention"].append(dict(
            path_of=label, shape=shape, kernel=path, launches_per_step=n, max_abs_err=err,
            ms=t["kernel"], plain_ms=plain, bound_ms=bound, bound_by="bytes",
            library_ms=t["sdpa"], simt_ms=t["simt"]))
        del q, kc, vc
    return rows


def gmm_phase(gen, dev):
    """The grouped expert matmul against its plain version at phi3.5-moe's
    decode (C=4) and prefill (C=160) capacities, both directions, and at
    arctic's width; weights scaled as the model draws them (std d**-0.5).
    Then a capacity sweep: the kernel `route` chose at each C, its time,
    torch.bmm's and the bound."""
    import torch
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.kernels import costs, ops, ref

    rnd = _rnd(gen, dev)
    rows = {}
    say("phase 3d: grouped expert matmul, phi3.5-moe E=16 d=4096 f=6400; arctic E=8 "
        "d=7168 f=4864")
    cases = [("phi", 16, C, din, dout, C == 4 and din == 4096 or C == 160 and din == 4096)
             for C in (4, 160) for din, dout in ((4096, 6400), (6400, 4096))]
    cases.append(("arctic", 8, 4, 7168, 4864, False))
    for label, E, C, din, dout, timed in cases:
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            x = rnd(E, C, din, dtype=dtype)
            w = rnd(E, din, dout, dtype=dtype, scale=din ** -0.5)
            out = ops.moe_gmm(x, w)
            path = gk.route_for(x, w, out)
            err = gate(f"moe_gmm {label} {str(dtype)[6:]} E={E} C={C} {din}->{dout} ({path})",
                       out, ref.moe_gmm_ref(x, w), tol)
            if timed and dtype == torch.bfloat16:
                ms = cuda_ms(lambda: ops.moe_gmm(x, w), 20)
                plain = cuda_ms(lambda: ref.moe_gmm_ref(x, w), 3)
                lib = cuda_ms(lambda: torch.bmm(x, w), 20)
                flops, nbytes = costs.gmm_cost(E, C, din, dout)
                bound, by = bound_ms((flops, nbytes))
                say(f"  time C={C} bf16 ({path}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                    f"torch.bmm {lib:.4f} ms, bound {bound:.4f} ms by {by} "
                    f"({nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.1f} TFLOP/s)")
                rows[C] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                               bound_by=by, library_ms=lib, path=path,
                               shape=f"E={E} C={C} d={din} f={dout} bf16")
            del x, w, out
    say("  capacity sweep, bf16 E=16 4096->6400 (a T-token prefill has C = "
        "ceil4(0.15625 T), 4-160 on the path):")
    w = rnd(16, 4096, 6400, scale=4096 ** -0.5)
    for C in (4, 8, 16, 20, 32, 48, 64, 96, 128, 160):
        x = rnd(16, C, 4096)
        out = ops.moe_gmm(x, w)
        path = gk.route_for(x, w, out)
        gate(f"moe_gmm bf16 C={C} ({path})", out, ref.moe_gmm_ref(x, w), BF16_TOL)
        ms = cuda_ms(lambda: ops.moe_gmm(x, w), 10)
        lib = cuda_ms(lambda: torch.bmm(x, w), 10)
        bound, by = bound_ms(costs.gmm_cost(16, C, 4096, 6400))
        say(f"    C={C}: {path}, kernel {ms:.4f} ms, torch.bmm {lib:.4f} ms, "
            f"bound {bound:.4f} ms by {by}")
    del x, w, out
    return rows


# tests/test_torch_cuda.py::test_moe_gmm_kernel_matches_plain_on_cuda's
# bf16 tolerance, which the backward products' card tests share
GMM_BF16_TOL = 5e-2


def gmm_bwd_phase(gen, dev, E=16, caps=(4, 160, 320), dims=((4096, 6400), (6400, 4096))):
    """8d: moe_gmm's two backward products, dx = dy w^T and dw = x^T dy,
    against their plain versions at phi3.5-moe's width in both directions,
    at the decode (C=4), prefill (C=160) and training (C=320) capacities;
    at C=320 the time of each, its bound, torch.bmm's on the same operands
    and the plain version's. Returns {"dx": row, "dw": row} at C=320
    4096->6400."""
    import torch
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.kernels import costs, ops, ref

    rnd = _rnd(gen, dev)
    rows = {}
    for C in caps:
        for din, dout in dims:
            x = rnd(E, C, din)
            w = rnd(E, din, dout, scale=din ** -0.5)
            dy = rnd(E, C, dout)
            for kind, fn, plain_fn, lib_fn, args in (
                    ("dx", ops.moe_gmm_dx, ref.moe_gmm_dx_ref,
                     lambda a, b: torch.bmm(a, b.transpose(1, 2)), (dy, w)),
                    ("dw", ops.moe_gmm_dw, ref.moe_gmm_dw_ref,
                     lambda a, b: torch.bmm(a.transpose(1, 2), b), (x, dy))):
                out = fn(*args)
                path = gk.route_for(*args, out, kind)
                err = gate(f"moe_gmm {kind} bf16 E={E} C={C} {din}->{dout} ({path})", out,
                           plain_fn(*args), GMM_BF16_TOL)
                if (C, din, dout) != (caps[-1], *dims[0]):
                    continue
                ms = cuda_ms(lambda: fn(*args), 20)
                plain = cuda_ms(lambda: plain_fn(*args), 3)
                lib = cuda_ms(lambda: lib_fn(*args), 20)
                flops, nbytes = costs.gmm_cost(E, C, din, dout)
                bound, by = bound_ms((flops, nbytes))
                say(f"  time {kind} C={C} bf16 ({path}): kernel {ms:.4f} ms, plain {plain:.4f} "
                    f"ms, torch.bmm {lib:.4f} ms, bound {bound:.4f} ms by {by} "
                    f"({nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.1f} TFLOP/s)")
                rows[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                                  bound_by=by, library_ms=lib, path=path,
                                  shape=f"E={E} C={C} d={din} f={dout} bf16")
            del x, w, dy, out
    return rows


def ssd_bwd_bound(B, H, T, P, N, Q):
    """(bound ms, bound_by, flops, bytes) of the SSD scan's backward from its
    inputs (fp32): x, dt, A, B, C and dy read once, their gradients written
    once; the forward's products recomputed and each product's two backward
    products (3x the forward's operations, `costs.ssd_cost`), at the TF32
    tensor-core rate."""
    from repro_torch import roofline
    from repro_torch.kernels import costs
    flops = 3 * costs.ssd_cost(B, H, T, P, 1, N, Q, 4)[0]
    nbytes = 4 * 2 * (2 * B * H * T * P + B * H * T + 2 * B * T * N + H)
    return (*bound_ms((flops, nbytes), roofline.PEAK_TF32_FLOPS), flops, nbytes)


def grad_gate(label, kern, plain, exact, names) -> dict:
    """Each gradient of the kernel path no further (relative L2) from the
    fp64 run than NOISE_FACTOR times the plain path's. Returns name ->
    (kernel, plain) distances."""
    import torch
    errs = {}
    for name, gk, gp, ge in zip(names, kern, plain, exact):
        e_k, e_p = rel_l2(gk, ge), rel_l2(gp, ge)
        ok = bool(torch.isfinite(gk.float()).all()) and e_k <= NOISE_FACTOR * e_p
        say(f"  {'ok  ' if ok else 'FAIL'} {label} d{name}: rel L2 err vs fp64: kernel path "
            f"{e_k:.3e}, plain path {e_p:.3e} (gate: kernel <= {NOISE_FACTOR:g} x plain)")
        if not ok:
            fail(f"{label} d{name}: the kernel path is further from fp64 than the plain path "
                 "explains")
        errs[name] = (e_k, e_p)
    return errs


def function_grad_phase(gen, dev, gmm_shape=(16, 320, 4096, 6400),
                        ssd_shape=(2, 1024, 80, 64, 64, 1, 256)):
    """8d: the gradients of the two autograd Functions on the card against
    autograd through their plain versions in fp64, gated as grad_gate says:
    GroupedMatmul at phi3.5-moe's training capacity (bf16; the plain path
    sums in fp32 and rounds to bf16 as the kernels do), SSDScan at
    zamba2-2.7b's training microbatch (B=2 T=1024, the model's fp32 views);
    the SSD backward's time and its bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.moe import GroupedMatmul

    rnd = _rnd(gen, dev)
    E, C, din, dout = gmm_shape
    x, w, dy = rnd(E, C, din), rnd(E, din, dout, scale=din ** -0.5), rnd(E, C, dout)

    def gmm_grads():
        a, b = x.detach().requires_grad_(), w.detach().requires_grad_()
        GroupedMatmul.apply(a, b).backward(dy)
        return a.grad, b.grad
    kern = gmm_grads()
    with plain_kernels():
        plain = gmm_grads()
    x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
    torch.einsum("ecd,edf->ecf", x64, w64).backward(dy.double())
    say(f"  GroupedMatmul E={E} C={C} {din}->{dout} bf16:")
    errs = {"gmm": grad_gate("GroupedMatmul", kern, plain, (x64.grad, w64.grad), ("x", "w"))}
    del x, w, dy, kern, plain, x64, w64

    B, T, H, P, N, G, Q = ssd_shape
    args = _ssd_inputs(rnd, B, T, H, P, G, N, torch.float32)
    dy = torch.randn(args[0].shape, generator=gen, device=dev)

    def ssd_grads():
        live = [t.detach().requires_grad_() for t in args]
        y, _ = M2.SSDScan.apply(*live, Q)
        y.backward(dy)
        return [t.grad for t in live]
    kern = ssd_grads()
    with plain_kernels():
        plain = ssd_grads()
    # the plain version sums in fp64 when handed fp64 (the same function as
    # the model's chunked scan, which casts to fp32)
    live64 = [t.double().requires_grad_() for t in args]
    ref.ssd_scan_ref(*live64, chunk=Q)[0].backward(dy.double())
    say(f"  SSDScan B={B} T={T} H={H} P={P} N={N} chunk {Q} fp32 (the model's views):")
    errs["ssd"] = grad_gate("SSDScan", kern, plain, [t.grad for t in live64],
                            ("x", "dt", "A", "B", "C"))
    del kern, plain, live64
    live = [t.detach().requires_grad_() for t in args]
    y, _ = M2.SSDScan.apply(*live, Q)
    ms = cuda_ms(lambda: torch.autograd.grad(y, live, dy, retain_graph=True), 5)
    bound, by, flops, nbytes = ssd_bwd_bound(B, H, T, P, N, Q)
    say(f"  SSD backward (the model's chunked scan in plain PyTorch, fp32 products): "
        f"{ms:.4f} ms, bound {bound:.4f} ms by {by} ({flops / 1e9:.1f} GFLOP at the TF32 rate, "
        f"{nbytes / 1e6:.1f} MB)")
    return dict(grad_errs=errs, ssd_bwd_ms=ms, ssd_bwd_bound_ms=bound, ssd_bwd_bound_by=by,
                ssd_bwd_shape=f"B={B} H={H} T={T} P={P} N={N} chunk {Q} fp32")


def _ssd_inputs(rnd, B, T, H, P, G, N, dtype):
    """Inputs as the model lays them out, (B,T,H,P) etc., handed over as the
    kernel's (B,H,T,P) views; the distributions of tests/test_kernels.py."""
    import torch
    x = rnd(B, T, H, P, dtype=dtype, scale=0.5).transpose(1, 2)
    dt = torch.nn.functional.softplus(rnd(B, T, H, dtype=torch.float32)).transpose(1, 2)
    A = -torch.exp(rnd(H, dtype=torch.float32, scale=0.3))
    Bm = rnd(B, T, G, N, dtype=dtype, scale=0.5).transpose(1, 2)
    Cm = rnd(B, T, G, N, dtype=dtype, scale=0.5).transpose(1, 2)
    return x, dt, A, Bm, Cm


def ssd_bound(B, H, T, P, N, Q, el, peak=None):
    """(bound ms, bound_by, flops, bytes) of the chunked scan at one group
    (`costs.ssd_cost`), at the tensor cores' rate for the inputs' type (TF32
    for fp32) unless `peak` names another."""
    from repro_torch import roofline
    from repro_torch.kernels import costs
    flops, nbytes = costs.ssd_cost(B, H, T, P, 1, N, Q, el)
    peak = peak or (roofline.PEAK_TF32_FLOPS if el == 4 else roofline.PEAK_FLOPS)
    return (*bound_ms((flops, nbytes), peak), flops, nbytes)


def ssd_precision(args, Q) -> dict:
    """Relative L2 distance of y and of the final state to an fp64 run of
    the plain version on the same inputs, by kernel: the tensor-core path
    ("mma", 3xTF32 products) and the first version ("simt", fp32 FMAs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as sk
    exact_y, exact_s = ref.ssd_scan_ref(*(t.double() for t in args), chunk=Q)
    dist = {}
    for path in ("mma", "simt"):
        y, s = sk.ssd_scan(*args, chunk=Q, path=path)
        dist[path] = (rel_l2(y, exact_y), rel_l2(s, exact_s))
    return dist


def ssd_phase(gen, dev):
    """The SSD scan against its plain version at zamba2's shapes, and at fp32
    against the sequential recurrence; then a T sweep at B=4 fp32 of the
    kernel route names against the first version, with both kernels'
    distance to fp64."""
    import torch
    from repro_torch import roofline
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssm_scan as sk

    rnd = _rnd(gen, dev)
    H, P, N, G, Q = 80, 64, 64, 1, 256
    errs = {}
    say(f"phase 3e: SSD scan, zamba2 H={H} P={P} N={N} G={G} chunk {Q}")
    for B in (1, 4):
        for T in (256, 1024, 2048):
            for dtype, tol in ((torch.float32, SSD_F32_TOL), (torch.bfloat16, BF16_TOL)):
                args = _ssd_inputs(rnd, B, T, H, P, G, N, dtype)
                path = sk.route_for(args[0], args[3], args[4], chunk=Q)
                name = f"ssd_scan {str(dtype)[6:]} B={B} T={T} ({path})"
                y, s = ops.ssd_scan(*args, chunk=Q)
                want_y, want_s = ref.ssd_scan_ref(*args, chunk=Q)
                errs[B, T, dtype] = gate(f"{name} y", y, want_y, tol)
                gate(f"{name} state", s, want_s, tol)
                if T == 256 and dtype == torch.float32:
                    x, dt, A, Bm, Cm = args
                    seq = ref.ssd_chunk_ref(x.transpose(1, 2), dt.transpose(1, 2), A,
                                            Bm.transpose(1, 2), Cm.transpose(1, 2))
                    gate(f"{name} vs the sequential recurrence",
                         y.transpose(1, 2), seq, SSD_SEQ_TOL)
                del args, y, s

    B = 4
    say(f"  sweep at B={B} fp32: device ms of the kernel route names and of the first "
        f"version (simt) on the same inputs, the bound; relative L2 distance to fp64")
    row = {}
    for T in (256, 1024, 2048, 4096):
        args = _ssd_inputs(rnd, B, T, H, P, G, N, torch.float32)
        path = sk.route_for(args[0], args[3], args[4], chunk=Q)
        ms = device_ms(lambda: ops.ssd_scan(*args, chunk=Q), 20)
        simt = device_ms(lambda: sk.ssd_scan(*args, chunk=Q, path="simt"), 5)
        bound, by, flops, nbytes = ssd_bound(B, H, T, P, N, Q, 4)
        cores, _, _, _ = ssd_bound(B, H, T, P, N, Q, 4, roofline.PEAK_F32_FLOPS)
        dist = ssd_precision(args, Q)
        say(f"    T={T}: {path} {ms:.4f} ms, simt {simt:.4f} ms ({simt / ms:.2f}x), bound "
            f"{bound:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
            f"{cores:.4f} ms at the fp32 CUDA-core rate); distance to fp64 y "
            f"{dist['mma'][0]:.6e} / {dist['simt'][0]:.6e}, state {dist['mma'][1]:.6e} / "
            f"{dist['simt'][1]:.6e} (mma / simt)")
        if T == 1024:   # zamba2-2.7b's prefill: the kernels line's row
            event = cuda_ms(lambda: ops.ssd_scan(*args, chunk=Q), 10)
            plain = cuda_ms(lambda: ref.ssd_scan_ref(*args, chunk=Q), 3)
            row = dict(max_abs_err=errs[B, T, torch.float32], ms=ms, plain_ms=plain,
                       bound_ms=bound, bound_by=by, library_ms=None, path=path,
                       simt_ms=simt, event_ms=event, dist_fp64={k: list(v) for k, v in
                                                                dist.items()},
                       shape=f"B={B} H={H} T={T} P={P} N={N} chunk {Q} fp32")
            say(f"    T={T}: event time {event:.4f} ms, plain {plain:.4f} ms")
        del args
    return row


# ----------------------------------------------------------------------------
# phases 4-7: the serving paths
# ----------------------------------------------------------------------------

def spread(seconds) -> str:
    """Median and the highest percentile with at least ten samples beyond
    it (the maximum when there are fewer than twenty), in ms."""
    import numpy as np
    ms = np.asarray(seconds) * 1e3
    n = len(ms)
    tail = (f"p{100 * (1 - 10 / n):.0f} {np.percentile(ms, 100 * (1 - 10 / n)):.2f}"
            if n >= 20 else f"max {ms.max():.2f}")
    return f"median {np.median(ms):.2f} ms, {tail} ms (n={n})"


def timed_model(model, timings):
    """The same model with prefill and decode_step timed to completion."""
    import dataclasses
    import torch

    def clock(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timings[name].append(time.perf_counter() - t0)
            return out
        return run
    return dataclasses.replace(model, prefill=clock("prefill", model.prefill),
                               decode_step=clock("decode", model.decode_step))


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def logits_gate(name, kern, plain, exact, vocab, alike=None) -> int:
    """kern and plain: the bf16 model with the kernels and with their plain
    versions; exact: the plain path in fp32 on the same weights. The kernel
    path must be finite and no further from fp32 than NOISE_FACTOR times the
    plain bf16 path's own distance: both round to bf16 at the same places
    and differ only in the order of the kernels' sums. Only the first
    `vocab` logits count: the padded ones are -1e9 on every path.

    An MoE model passes `alike`, (B,) bool: the sequences whose every
    routing choice the two bf16 paths made alike (routing_keys). A near-tie
    router logit may flip under the kernels' order of sums, and a flipped
    choice changes that sequence's output outright; on the others the
    kernel path must lie within MOE_PLAIN_L2 of the plain path. Returns the
    number of sequences so compared."""
    import torch
    kern, plain, exact = (t[..., :vocab] for t in (kern, plain, exact))
    e_kern, e_plain, e_kp = rel_l2(kern, exact), rel_l2(plain, exact), rel_l2(kern, plain)
    agree = (kern.float().argmax(-1) == plain.float().argmax(-1)).float().mean().item()
    agree32 = (kern.float().argmax(-1) == exact.float().argmax(-1)).float().mean().item()
    say(f"  {name}: rel L2 err vs fp32: kernel path {e_kern:.3e}, plain path "
        f"{e_plain:.3e}; kernel vs plain {e_kp:.3e}, max abs {max_err(kern, plain):.3e}; "
        f"greedy-token agreement with plain {agree * 100:.1f}%, with fp32 "
        f"{agree32 * 100:.1f}%")
    if not bool(torch.isfinite(kern.float()).all()):
        fail(f"{name}: the kernel path's logits are not finite")
    if alike is None:
        say(f"    gate: kernel <= {NOISE_FACTOR:g} x plain in distance to fp32")
        if not e_kern <= NOISE_FACTOR * e_plain:
            fail(f"{name}: the kernel path is further from fp32 than bf16 rounding explains")
        return len(kern)
    n = int(alike.sum())
    e_alike = rel_l2(kern[alike], plain[alike]) if n else float("nan")
    say(f"    gate: on the {n} of {len(alike)} sequences routed alike, kernel vs plain "
        f"{e_alike:.3e} <= {MOE_PLAIN_L2:g}")
    if n and not e_alike <= MOE_PLAIN_L2:
        fail(f"{name}: the kernel path is further from the plain bf16 path than "
             f"the order of the kernels' sums explains")
    return n


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree.clone()


KERNEL_MODULES = ("flash_attention", "decode_attention", "moe_gmm", "ssm_scan")
# moe_gmm's two backward products, counted apart by its wrapper
GMM_BACKWARD = ("dx", "dw")


def kernel_counts():
    """name -> the launch counter of each kernel wrapper, and of moe_gmm's
    backward products (moe_gmm_dx, moe_gmm_dw)."""
    import importlib
    from repro_torch.kernels import moe_gmm as gk
    counts = {n: importlib.import_module(f"repro_torch.kernels.{n}").launches
              for n in KERNEL_MODULES}
    counts.update({f"moe_gmm_{k}": getattr(gk, f"{k}_launches") for k in GMM_BACKWARD})
    return counts


def reset_counts():
    import importlib
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.kernels import ssm_scan as sk
    for n in KERNEL_MODULES:
        importlib.import_module(f"repro_torch.kernels.{n}").launches = 0
    fk.lse_launches = 0
    for k in GMM_BACKWARD:
        setattr(gk, f"{k}_launches", 0)
    for counts in (fk.launches_by_path, gk.launches_by_path, dk.launches_by_path,
                   sk.launches_by_path, gk.dx_launches_by_path, gk.dw_launches_by_path):
        for path in counts:
            counts[path] = 0


def flash_path_gate(label, n_flash) -> dict:
    """The path's flash_attention launches by kernel: all `n_flash` through
    the tensor-core kernel (the model's bf16 (B,T,H,D) views are what TMA
    reads). Returns the counts by kernel."""
    from repro_torch.kernels import flash_attention as fk
    got = dict(fk.launches_by_path)
    want = {"wgmma": n_flash, "simt": 0}
    say(f"  flash_attention launches by kernel: {got}")
    if got != want:
        fail(f"{label}: flash_attention did not go through the tensor-core kernel on every "
             f"call: {got}, want {want}")
    return got


def decode_path_gate(label, n_decode) -> dict:
    """The path's decode_attention launches by kernel: all `n_decode`
    through the split-S kernel (the model's cache views are what TMA
    reads). Returns the counts by kernel."""
    from repro_torch.kernels import decode_attention as dk
    got = dict(dk.launches_by_path)
    want = {"split": n_decode, "simt": 0}
    say(f"  decode_attention launches by kernel: {got}")
    if got != want:
        fail(f"{label}: decode_attention did not go through the split kernel on every "
             f"call: {got}, want {want}")
    return got


def ssd_path_gate(label, n_ssd) -> dict:
    """The path's ssd_scan launches by kernel: all `n_ssd` through the
    tensor-core path (the model hands over fp32 (B,T,H,P) views that TMA
    reads, at P = N = 64 and chunk 256). Returns the counts by kernel."""
    from repro_torch.kernels import ssm_scan as sk
    got = dict(sk.launches_by_path)
    want = {"mma": n_ssd, "simt": 0}
    say(f"  ssd_scan launches by kernel: {got}")
    if got != want:
        fail(f"{label}: ssd_scan did not go through the tensor-core path on every call: "
             f"{got}, want {want}")
    return got


def gmm_path_gate(cfg, prompt_lens, steps, batch_slots) -> dict:
    """The MoE path's moe_gmm launches by kernel: each prefill of T tokens
    and each decode step of `batch_slots` tokens launches 3 per layer at the
    capacity moe.capacity gives, every one through the tensor-core kernel
    (each bf16 shape of the path is one TMA can read). Returns the counts
    by kernel."""
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.models.moe import capacity
    got = dict(gk.launches_by_path)
    caps = [capacity(cfg, int(n)) for n in prompt_lens]
    calls = len(caps) + steps
    want = {"wgmma": 3 * cfg.n_layers * calls, "rows": 0, "tiled": 0}
    say(f"  moe_gmm launches by kernel: {got}, over {len(caps)} prefills at capacities "
        f"{min(caps)}-{max(caps)} and {steps} decode steps at capacity "
        f"{capacity(cfg, batch_slots)}")
    if got != want:
        fail(f"moe_gmm did not go through the tensor-core kernel on every call: {got}, "
             f"want {want}")
    return got


@contextlib.contextmanager
def plain_kernels():
    """The model on the kernels' plain PyTorch versions for the duration:
    every model module's `ops` is swapped for a namespace of the plain
    ones."""
    from repro_torch.kernels import ref
    from repro_torch.models import dense, flash_vjp, hybrid, layers, mamba2, moe, whisper
    plain_ops = types.SimpleNamespace(flash_attention=ref.flash_attention_ref,
                                      decode_attention=ref.decode_attention_ref,
                                      moe_gmm=ref.moe_gmm_ref, moe_gmm_dx=ref.moe_gmm_dx_ref,
                                      moe_gmm_dw=ref.moe_gmm_dw_ref, ssd_scan=ref.ssd_scan_ref)
    with contextlib.ExitStack() as stack:
        for module in (layers, dense, moe, mamba2, hybrid, flash_vjp, whisper):
            stack.enter_context(mock.patch.object(module, "ops", plain_ops))
        yield


@contextlib.contextmanager
def record_routing(choices):
    """Append each MoE dispatch's routing keys to `choices` for the duration:
    per token its k choices, each the expert that took it or -1 where the
    expert was full, (N, k) sorted."""
    import torch
    from repro_torch.models import moe
    dispatch = moe._dispatch_one_group

    def recorded(x, logits, top_k, cap):
        out = dispatch(x, logits, top_k, cap)
        slots, inv, _, gates = out
        top_e = torch.topk(gates, top_k, dim=-1).indices
        kept = inv.reshape(top_e.shape) < slots.shape[0]
        choices.append(torch.where(kept, top_e, -1).sort(-1).values)
        return out
    with mock.patch.object(moe, "_dispatch_one_group", recorded):
        yield


@contextlib.contextmanager
def routed_as(choices, replay: bool):
    """Record each MoE dispatch's top-k experts (N, k) into `choices` for
    the duration, or, with `replay`, hand them back in the same order in
    place of the dispatch's own top k (moe._dispatch_one_group's `top_e`):
    the kernel path then routes as the recorded path did, with its own gate
    values. Every recorded choice must be replayed."""
    import torch
    from repro_torch.models import moe
    dispatch = moe._dispatch_one_group
    given = iter(list(choices))

    def routed(x, logits, top_k, cap):
        if replay:
            return dispatch(x, logits, top_k, cap, top_e=next(given))
        out = dispatch(x, logits, top_k, cap)
        choices.append(torch.topk(out[3], top_k, dim=-1).indices)
        return out
    with mock.patch.object(moe, "_dispatch_one_group", routed):
        yield
    if replay and next(given, None) is not None:
        fail("the replayed run made fewer MoE dispatches than the recorded one")


def routing_agreement(kern, plain) -> float:
    """Share of (token, k) routing choices the two paths made alike."""
    same = sum(int((a == b).sum()) for a, b in zip(kern, plain))
    return same / max(1, sum(a.numel() for a in kern))


def routed_alike(kern, plain, n_seq):
    """(n_seq,) bool: the sequences whose last token the two paths routed
    alike in every layer; each entry is one layer's (n_seq * T, k) keys."""
    import torch
    same = torch.ones(n_seq, dtype=torch.bool, device=kern[0].device)
    for a, b in zip(kern, plain):
        last = (t.reshape(n_seq, -1, t.shape[-1])[:, -1] for t in (a, b))
        same &= torch.eq(*last).all(-1)
    return same


def check_against_plain(model, params, prompts, cfg, dev):
    """Prefill logits of one request, and the logits of one decode step over
    a batch prefilled from `prompts`: kernel path vs plain path vs the plain
    path in fp32. For an MoE model, also the share of routing choices on
    which the kernel and plain paths agree, and the logits are compared on
    the sequences they routed alike, which must be at least half."""
    import torch
    from repro_torch.models import dense
    cfg32 = cfg.replace(param_dtype="float32")
    moe = cfg.family == "moe"
    routes = {"kern": [], "plain": [], "exact": []}
    compared, total = 0, 0

    def gate3(name, n_seq, kern_fn, plain_fn, exact_fn):
        nonlocal compared, total
        calls = {k: [] for k in routes}
        with record_routing(calls["kern"]):
            kern, _ = kern_fn()
        with plain_kernels():
            with record_routing(calls["plain"]):
                plain, _ = plain_fn()
            with record_routing(calls["exact"]):
                exact, _ = exact_fn()
        for k in routes:
            routes[k] += calls[k]
        alike = routed_alike(calls["kern"], calls["plain"], n_seq) if moe else None
        compared += logits_gate(name, kern, plain, exact, cfg.vocab_size, alike)
        total += n_seq

    with torch.inference_mode():
        params32 = _to_f32(params)
        tok = torch.tensor([prompts[0]], dtype=torch.int32, device=dev)
        gate3(f"prefill logits (T={len(prompts[0])})", 1,
              lambda: dense.lm_prefill(params, {"tokens": tok}, cfg),
              lambda: dense.lm_prefill(params, {"tokens": tok}, cfg),
              lambda: dense.lm_prefill(params32, {"tokens": tok}, cfg32))

        B, S = len(prompts), 2048
        cache = model.init_cache(B, S)
        first = []
        for i, p in enumerate(prompts):
            lg, pc = model.prefill(params, {"tokens": torch.tensor(
                [p], dtype=torch.int32, device=dev)})
            for name in cache:
                cache[name][:, i, :len(p)] = pc[name][:, 0]
            first.append(int(lg[0, -1].argmax()))
        plain_cache = {k: v.clone() for k, v in cache.items()}
        exact_cache = _to_f32(cache)
        batch = {"tokens": torch.tensor(first, dtype=torch.int32, device=dev)[:, None],
                 "positions": torch.tensor([len(p) for p in prompts],
                                           dtype=torch.int32, device=dev)}
        gate3(f"decode-step logits (B={B})", B,
              lambda: dense.lm_decode_step(params, cache, batch, cfg),
              lambda: dense.lm_decode_step(params, plain_cache, batch, cfg),
              lambda: dense.lm_decode_step(params32, exact_cache, batch, cfg32))
        if moe:
            same = routing_agreement(routes["kern"], routes["plain"])
            say(f"  routing, prefill and decode step, every layer: of "
                f"{sum(a.numel() for a in routes['kern'])} (token, k) choices the kernel path "
                f"made {same * 100:.2f}% as the plain path (gate: >= "
                f"{MOE_ROUTING_AGREEMENT * 100:g}%) and "
                f"{routing_agreement(routes['kern'], routes['exact']) * 100:.2f}% as the fp32 "
                f"model; the plain path "
                f"{routing_agreement(routes['plain'], routes['exact']) * 100:.2f}% as the fp32 "
                f"model; logits compared on {compared} of {total} sequences (gate: at least "
                f"half)")
            if not same >= MOE_ROUTING_AGREEMENT or not 2 * compared >= total:
                fail("the kernel path routed tokens unlike the plain path beyond what "
                     "near-tie router logits explain")
        del cache, plain_cache, exact_cache, params32


def profile_window(engine, prompts, steps=4):
    """Profile `steps` decode ticks with every slot busy: device busy share
    of the window and the largest device and host costs."""
    from repro_torch.serve.engine import Request
    for i, p in enumerate(prompts[:engine.B]):
        engine.add_request(Request(id=10_000 + i, prompt=p, max_new_tokens=steps + 3))
    engine.tick()   # prefill every slot, then one decode step
    engine.tick()
    profile_steps(engine.tick, steps)
    engine.run_until_drained()


# the decode attention kernels' names (csrc/decode_attention.cu), which
# profile_steps reports unless it is given others
DECODE_KERNELS = ("decode_split", "decode_merge", "decode_kernel")


def profile_totals(prof) -> dict:
    """name -> [count, device us, self host us] of a finished profile, from
    its raw events: what `key_averages()` sums (the same names left out, an
    op that is the one child of an op of its name counted once), without
    the event tree it builds, which takes 40 s on the CPU for 10^5 host
    events (one xLSTM train step issues about that many). An event on the
    card counts its duration as device time; a host event its duration less
    that of the events nested in it on its thread."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import _filter_name
    totals, threads = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or e.is_hidden_event():
            continue
        t = totals.setdefault(name, [0, 0.0, 0.0])
        t[0] += 1
        if e.device_type() == DeviceType.CPU:
            threads.setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns(), name))
        else:
            t[1] += e.duration_ns() / 1e3
    for spans in threads.values():
        spans.sort(key=lambda sp: (sp[0], -sp[1]))
        # [end, name, duration, nested duration, children, children of its name]
        stack = []
        for start, end, name in spans + [(float("inf"), 0, None)]:
            while stack and stack[-1][0] <= start:
                top = stack.pop()
                totals[top[1]][2] += (top[2] - top[3]) / 1e3
                if top[4] == top[5] == 1:   # its one child is the same op
                    totals[top[1]][0] -= 1
            if name is None:
                break
            if stack:
                stack[-1][3] += end - start
                stack[-1][4] += 1
                stack[-1][5] += stack[-1][1] == name
            stack.append([end, name, end - start, 0, 0, 0])
    return totals


def profile_steps(step, steps, what="decode", kernels=DECODE_KERNELS, label="decode attention"):
    """Profile `steps` calls of `step()` (one `what` step each): device busy
    share of the window, the largest device and host costs, and the device
    time of `kernels` (named `label`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    totals = profile_totals(prof)
    # kernels (and copies) are the events that run on the card; the host
    # ops that launch them carry the same time again, so they are left out
    device = {k: t for k, t in totals.items() if t[1] > 0}
    busy = sum(t[1] for t in device.values()) / 1e6
    say(f"  profiled {steps} {what} steps: {window / steps * 1e3:.2f} ms per step (profiler on), "
        f"device busy {busy / window * 100:.1f}% (idle {100 - busy / window * 100:.1f}%), "
        f"{sum(t[0] for t in device.values()) / steps:.0f} device kernels per step")
    for k, (n, dev_us, _) in sorted(device.items(), key=lambda kt: kt[1][1], reverse=True)[:6]:
        say(f"    device {dev_us / steps / 1e3:8.3f} ms/step  x{n // steps:<4d} {k[:70]}")
    named = {n: [(k, t) for k, t in device.items() if n in k] for n in kernels}
    say(f"    {label}: device "
        f"{sum(t[1] for ks in named.values() for _, t in ks) / steps / 1e3:.3f} ms/step: "
        + (", ".join(f"{n} x{sum(t[0] for _, t in ks) // steps} "
                     f"{sum(t[1] for _, t in ks) / steps / 1e3:.3f} ms"
                     for n, ks in named.items() if ks) or "no kernel"))
    for k, (n, _, host_us) in sorted(totals.items(), key=lambda kt: kt[1][2], reverse=True)[:6]:
        say(f"    host   {host_us / steps / 1e3:8.3f} ms/step  x{n // steps:<4d} {k[:70]}")
    return {"busy": busy / window, "step_ms": window / steps * 1e3,
            "device_ms": {k: t[1] / steps / 1e3 for k, t in device.items()}}


# the SSD scan's kernels (csrc/ssm_scan.cu), which ssd_prefill_ms reports
SSD_KERNELS = ("ssd_chunk_tc", "ssd_state_tc", "ssd_out_tc", "ssd_kernel")


def prefill_times(prefill, n=3):
    """Seconds of `n` calls of prefill(), each run to completion."""
    import torch
    seconds = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        del out
    return seconds


def ssd_prefill_ms(prefill) -> dict:
    """Device ms of the SSD scan's kernels over one profiled prefill(), by
    kernel, and their launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = prefill()
        torch.cuda.synchronize()
    del out
    got = {}
    for key, (count, dev_us, _) in profile_totals(prof).items():
        for name in SSD_KERNELS:
            if name in key and dev_us:
                ms, n = got.get(name, (0.0, 0))
                got[name] = (ms + dev_us / 1e3, n + count)
    return got


def serve_phase(cfg, seed, n_requests, batch_slots, max_len, new_tokens,
                prompt_range, dev, label, gate_layers=None):
    """Serve `n_requests` through a ServeEngine on `cfg` and check the
    launch counts, then gate the logits against the plain path and fp32, on
    the first `gate_layers` layers when given (an fp32 copy of the whole
    model would not fit)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_params(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    say(f"  {label}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} (cache {cfg.cache_kv_heads}), d_ff {cfg.d_ff}"
        f"{f', {cfg.moe.n_experts} experts top-{cfg.moe.top_k}' if cfg.moe else ''}, "
        f"vocab {cfg.vocab_size}, kv cache {cfg.kv_cache_dtype}: {n_params / 1e9:.3f} B "
        f"params, init {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    timings = {"prefill": [], "decode": []}
    engine = ServeEngine(timed_model(model, timings), params, batch_slots=batch_slots,
                         max_len=max_len, device=dev)
    cache_gb = sum(t.numel() * t.element_size() for t in engine.cache.values()) / 1e9
    reqs = [Request(id=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]

    reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        engine.add_request(r)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()

    if len(done) != n_requests or not all(r.done for r in reqs):
        fail(f"{label}: {len(done)} of {n_requests} requests completed")
    for r in reqs:
        if len(r.output) != new_tokens or not all(0 <= t < cfg.vocab_size for t in r.output):
            fail(f"{label}: request {r.id} output {r.output} is not {new_tokens} in-vocab tokens")
    s = engine.stats
    pre_s, dec_s = sum(timings["prefill"]), sum(timings["decode"])
    steps = len(timings["decode"])
    say(f"  served {s['completed']} requests ({int(lens.sum())} prompt tokens, "
        f"{s['decoded_tokens']} decoded tokens) in {wall:.2f} s wall; cache {cache_gb:.2f} GB")
    say(f"  prefill: {s['prefills']} prefills, {pre_s:.3f} s, "
        f"{int(lens.sum()) / pre_s:.0f} tokens/s; {spread(timings['prefill'])} per prefill")
    say(f"  decode: {steps} steps of {batch_slots} slots, {dec_s:.3f} s, "
        f"{s['decoded_tokens'] / dec_s:.0f} tokens/s; {spread(timings['decode'])} per step")
    n_gmm = 3 * cfg.n_layers if cfg.family == "moe" else 0
    want = {"flash_attention": cfg.n_layers * s["prefills"],
            "decode_attention": cfg.n_layers * steps,
            "moe_gmm": n_gmm * (s["prefills"] + steps), "ssm_scan": 0,
            "moe_gmm_dx": 0, "moe_gmm_dw": 0}
    say(f"  kernel launches on this path: {launches} (per prefill {cfg.n_layers} flash"
        f"{f' and {n_gmm} moe_gmm' if n_gmm else ''}, per decode step {cfg.n_layers} "
        f"decode{f' and {n_gmm} moe_gmm' if n_gmm else ''})")
    if launches != want:
        fail(f"{label}: the path did not go through the kernels as often as its layers "
             f"ask: {launches}, want {want}")
    launches["flash_attention_by_path"] = flash_path_gate(label, launches["flash_attention"])
    launches["decode_attention_by_path"] = decode_path_gate(label,
                                                            launches["decode_attention"])
    if n_gmm:
        launches["moe_gmm_by_path"] = gmm_path_gate(cfg, lens, steps, batch_slots)
    say(f"  peak device memory while serving {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    launches["outputs"] = [r.output for r in reqs]
    profile_window(engine, prompts)
    del engine
    torch.cuda.empty_cache()
    if gate_layers:
        say(f"  logits gate on the first {gate_layers} of {cfg.n_layers} layers")
        cfg = cfg.replace(n_layers=gate_layers)
        params = dict(params, layers=params["layers"][:gate_layers])
        model = build_model(cfg, device=dev)
    check_against_plain(model, params, prompts[:batch_slots], cfg, dev)
    return launches


def hybrid_phase(cfg, seed, batch, prompt_len, new_tokens, dev):
    """zamba2 through the model interface (the engine's cache scatter knows
    only caches whose axis 1 is the slot): prefill `batch` prompts of
    `prompt_len` tokens, copy the result into a cache of prompt_len +
    new_tokens rows, decode `new_tokens` greedy steps; launch counts, times,
    a profiled window, and the logits gate on the prefill and on one step."""
    import numpy as np
    import torch
    from repro_torch.models import build_model

    B, T = batch, prompt_len
    nb = cfg.n_layers // cfg.hybrid.attn_every
    s = cfg.ssm
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_params(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    say(f"  {cfg.name}: {cfg.n_layers} mamba2 layers (d_model {cfg.d_model}, "
        f"{s.expand * cfg.d_model // s.head_dim} SSM heads of {s.head_dim}, d_state "
        f"{s.d_state}, chunk {s.chunk_size}), shared attention after every "
        f"{cfg.hybrid.attn_every} ({nb} applications, {cfg.n_heads}/{cfg.n_kv_heads} heads "
        f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}), vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)), dtype=torch.int32,
                          device=dev)

    with torch.inference_mode():
        # two prefills timed, one profiled, then the counted one, timed too
        prefill_s = prefill_times(lambda: model.prefill(params, {"tokens": tokens}), 2)
        ssd = ssd_prefill_ms(lambda: model.prefill(params, {"tokens": tokens}))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pc = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        at_prefill = kernel_counts()
        at_prefill_ssd = ssd_path_gate(cfg.name, at_prefill["ssm_scan"])
        cache = model.init_cache(B, T + new_tokens)
        cache["k"][:, :, :T], cache["v"][:, :, :T] = pc["k"], pc["v"]
        cache["conv"].copy_(pc["conv"])
        cache["ssm"].copy_(pc["ssm"])
        del pc
        base = {k: v.clone() for k, v in cache.items()}
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        first = {"tokens": tok, "positions": torch.full((B,), T, dtype=torch.int32,
                                                        device=dev)}
        out, step_s = [tok], []
        for i in range(new_tokens):
            pos = torch.full((B,), T + i, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache, {"tokens": tok, "positions": pos})
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            out.append(tok)
        launches = kernel_counts()
        toks = torch.cat(out, dim=1)
        if not bool(torch.isfinite(logits.float()).all()) or \
                not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{cfg.name}: non-finite prefill logits or out-of-vocab tokens")
        t_prefill = float(np.median(prefill_s))
        say(f"  prefill: {B} x {T} tokens, median of {len(prefill_s)} {t_prefill:.4f} s "
            f"({', '.join(f'{t:.4f}' for t in prefill_s)}), {B * T / t_prefill:.0f} tokens/s")
        say(f"  SSD kernels in a profiled prefill: device "
            f"{sum(ms for ms, _ in ssd.values()):.3f} ms: "
            + ", ".join(f"{n} x{c} {ms:.3f} ms" for n, (ms, c) in ssd.items()))
        say(f"  decode: {new_tokens} steps of {B} sequences, {sum(step_s):.3f} s, "
            f"{B * new_tokens / sum(step_s):.0f} tokens/s; {spread(step_s)} per step")
        want_prefill = {"flash_attention": nb, "decode_attention": 0, "moe_gmm": 0,
                        "ssm_scan": cfg.n_layers, "moe_gmm_dx": 0, "moe_gmm_dw": 0}
        want = dict(want_prefill, decode_attention=nb * new_tokens)
        say(f"  kernel launches: prefill {at_prefill}, prefill and decode {launches} (per "
            f"prefill {cfg.n_layers} ssd_scan and {nb} flash, per decode step {nb} decode)")
        if at_prefill != want_prefill or launches != want:
            fail(f"{cfg.name}: the path did not go through the kernels as its layers ask: "
                 f"{launches}, want {want}")
        launches["flash_attention_by_path"] = flash_path_gate(cfg.name,
                                                              launches["flash_attention"])
        launches["decode_attention_by_path"] = decode_path_gate(cfg.name,
                                                                launches["decode_attention"])
        launches["ssm_scan_by_path"] = at_prefill_ssd
        launches["prefill_s"] = prefill_s
        launches["ssd_prefill_ms"] = sum(ms for ms, _ in ssd.values())
        say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

        state = {"tok": tok, "pos": T + new_tokens}

        def step():   # further steps roll over the cache's first slots
            pos = torch.full((B,), state["pos"], dtype=torch.int32, device=dev)
            lg, _ = model.decode_step(params, cache, {"tokens": state["tok"], "positions": pos})
            state["tok"] = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            state["pos"] += 1
        profile_steps(step, 4)
        del cache

        cfg32 = cfg.replace(param_dtype="float32")
        params32 = _to_f32(params)
        with plain_kernels():
            plain, _ = model.prefill(params, {"tokens": tokens})
            exact, _ = build_model(cfg32, device=dev).prefill(params32, {"tokens": tokens})
        logits_gate(f"prefill logits (B={B}, T={T})", logits, plain, exact, cfg.vocab_size)
        del plain, exact
        kern, _ = model.decode_step(params, {k: v.clone() for k, v in base.items()}, first)
        with plain_kernels():
            plain, _ = model.decode_step(params, {k: v.clone() for k, v in base.items()},
                                         first)
            exact, _ = build_model(cfg32, device=dev).decode_step(params32, _to_f32(base),
                                                                  first)
        logits_gate(f"decode-step logits (B={B}, pos {T})", kern, plain, exact,
                    cfg.vocab_size)
    return launches


# ----------------------------------------------------------------------------
# phase 8: training
# ----------------------------------------------------------------------------

# each row's fp32 log-sum-exp: sums of up to T exps in another order than
# the plain version's, exp2 with log2(e) folded into the tensor-core
# kernel's scale, and m ln 2 + ln l there
LSE_TOL = 1e-4


def flash_bwd_bound(B, Hq, Hkv, T, D):
    """(bound ms, flops) of the causal flash backward at the bf16 tensor-core
    rate: five products over the unmasked pairs (S and dP recomputed, dQ,
    dK, dV: 2.5x the forward's, `costs.flash_cost`); q, k, v, out, dout and
    lse read once, dq, dk, dv written once."""
    from repro_torch.kernels import costs
    flops = 5 * costs.flash_cost(B, Hq, Hkv, T, T, D)[0] // 2
    nbytes = 2 * B * D * T * (3 * Hq + 2 * Hkv) + 4 * B * Hq * T + 2 * B * D * T * (Hq + 2 * Hkv)
    return bound_ms((flops, nbytes))[0], flops


def vjp_grads(q, k, v, do, window):
    """(dq, dk, dv) of flash_attention_vjp on (B,T,H,D) q, k, v."""
    from repro_torch.models.flash_vjp import flash_attention_vjp
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    flash_attention_vjp(q, k, v, causal=True, window=window).backward(do)
    return q.grad, k.grad, v.grad


def train_kernel_phase(gen, dev):
    """8a: the lse of both flash kernels against the plain version's, and the
    flash backward (kernel forward, plain backward) against autograd through
    `ref.attention_ref` in fp32, gated as logits_gate gates logits; times at
    llama's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops, ref
    from repro_torch.models.flash_vjp import flash_bwd

    rnd = _rnd(gen, dev)
    T = 1024
    row = None
    for label, B, Hq, Hkv, D, window in (("llama3-8b", 1, 32, 8, 128, None),
                                         ("llama3-8b, window 256", 1, 32, 8, 128, 256),
                                         ("zamba2-2.7b", 1, 32, 32, 80, None),
                                         ("stablelm-12b", 1, 32, 8, 160, None)):
        say(f"  {label}: B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16 causal")
        q, k, v, do = rnd(B, T, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D), rnd(B, T, Hq, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        want_out, want_lse = ref.flash_attention_ref(qt, kt, vt, window=window, return_lse=True)
        for path in ("wgmma", "simt"):
            out, lse = fk.flash_attention(qt, kt, vt, window=window, path=path,
                                          return_lse=True)
            gate(f"lse ({path})", lse, want_lse, LSE_TOL)
            gate(f"out beside the lse ({path})", out, want_out, BF16_TOL)
        kern = vjp_grads(q, k, v, do, window)
        with plain_kernels():
            plain = vjp_grads(q, k, v, do, window)
        qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
        ref.attention_ref(qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
                          window=window).transpose(1, 2).backward(do.float())
        for name, gk, gp, ge in zip(("dq", "dk", "dv"), kern, plain, (qf.grad, kf.grad, vf.grad)):
            e_k, e_p = rel_l2(gk, ge), rel_l2(gp, ge)
            ok = bool(torch.isfinite(gk.float()).all()) and e_k <= NOISE_FACTOR * e_p
            say(f"  {'ok  ' if ok else 'FAIL'} {name}: rel L2 err vs fp32: kernel path "
                f"{e_k:.3e}, plain path {e_p:.3e} (gate: kernel <= {NOISE_FACTOR:g} x plain)")
            if not ok:
                fail(f"flash backward {label} {name}: the kernel path is further from fp32 than "
                     "bf16 rounding explains")
        if row is None:   # times at llama's shape
            nolse = device_ms(lambda: ops.flash_attention(qt, kt, vt), 20)
            with_lse = device_ms(lambda: ops.flash_attention(qt, kt, vt, return_lse=True), 20)
            out, lse = ops.flash_attention(qt, kt, vt, return_lse=True)
            o = out.transpose(1, 2)
            bwd = cuda_ms(lambda: flash_bwd(q, k, v, o, lse, do, True, None, 512, 512), 5)
            # kv repeated to Hq heads outside the timed call: SDPA's backward
            # then runs without GQA, its fastest form
            qs, ks, vs = (t.detach().repeat_interleave(Hq // t.shape[1], dim=1)
                          .requires_grad_() for t in (qt, kt, vt))
            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), do.transpose(1, 2), retain_graph=True), 5)
            bound, _ = flash_bwd_bound(B, Hq, Hkv, T, D)
            say(f"  forward: {nolse:.4f} ms without the lse, {with_lse:.4f} ms with it "
                f"(device time); backward (plain PyTorch, fp32 products): {bwd:.4f} ms, SDPA's "
                f"backward (kv repeated to {Hq} heads) {sdpa_bwd:.4f} ms, bound {bound:.4f} ms "
                "(bf16 operations)")
            row = dict(nolse_ms=nolse, lse_ms=with_lse, bwd_ms=bwd, bwd_sdpa_ms=sdpa_bwd,
                       bwd_bound_ms=bound, bwd_shape=f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16")
            del out, lse, o, qs, ks, vs, sdpa_out
        del q, k, v, do, qt, kt, vt, want_out, want_lse, kern, plain, qf, kf, vf
    return row


# substrings of the names of cuBLAS's matmul kernels on Hopper
MATMUL_KERNELS = ("gemm", "nvjet", "cutlass", "xmma")

# llama3-8b's parameters that the gradient gate compares (one block's, at
# depth 1 of 4)
GRAD_GATE_LEAVES = (("embed", "tok"), ("embed", "out"), ("layers", 1, "attn", "wq"),
                    ("layers", 1, "attn", "wo"), ("layers", 1, "mlp", "w2"), ("final_norm",))
# phi3.5-moe's (at depth 1 of 2): attention, two expert weights, the router
MOE_GRAD_GATE_LEAVES = (("embed", "tok"), ("embed", "out"), ("layers", 1, "attn", "wq"),
                        ("layers", 1, "attn", "wo"), ("layers", 1, "moe", "w1"),
                        ("layers", 1, "moe", "w2"), ("layers", 1, "moe", "router"),
                        ("final_norm",))
# zamba2-2.7b's: one mamba2 block's (super-block 4 of 9, block 2 of 6), the
# shared block's query projection (summed over its 9 applications)
HYBRID_GRAD_GATE_LEAVES = (("embed", "tok"), ("mamba", 4, 2, "w_zx"), ("mamba", 4, 2, "w_out"),
                           ("mamba", 4, 2, "conv_w"), ("mamba", 4, 2, "dt_bias"),
                           ("mamba", 4, 2, "A_log"), ("shared_attn", "attn", "wq"),
                           ("final_norm",))
# whisper-tiny's (4 encoder and 4 decoder layers): the embeddings, an
# encoder layer's attention and FFN, a decoder layer's self-attention,
# cross-attention (its k over the encoder's output, its output projection)
# and FFN, the final norm
WHISPER_GRAD_GATE_LEAVES = (("embed", "tok"), ("embed", "out"),
                            ("enc_layers", 1, "attn", "wq"), ("enc_layers", 1, "mlp", "w2"),
                            ("dec_layers", 1, "attn", "wq"), ("dec_layers", 1, "cross", "wk"),
                            ("dec_layers", 1, "cross", "wo"), ("dec_layers", 1, "mlp", "w2"),
                            ("final_norm",))
# xlstm-350m's (3 super-blocks of 7 mLSTM and 1 sLSTM): the tied embedding,
# one mLSTM block's up and down projections, one sLSTM block's input and
# recurrent gate weights, the final norm; its distance to fp32 is printed
# (the path has no kernel, so the kernel path is the plain one)
XLSTM_GRAD_LEAVES = (("embed", "tok"), ("mlstm", 1, 3, "w_up"), ("mlstm", 1, 3, "w_down"),
                     ("slstm", 1, "w_gates"), ("slstm", 1, "r_gates"), ("final_norm",))
# the kernels a family's training launches, by kind of the profiled step's
# device time (the rest: cuBLAS matmuls, and elementwise passes and copies)
TRAIN_KERNEL_KINDS = {"dense": {"flash_wgmma": ("flash_wgmma",)},
                      "vlm": {"flash_wgmma": ("flash_wgmma",)},
                      "audio": {"flash_wgmma": ("flash_wgmma",)},
                      "ssm": {},
                      "moe": {"flash_wgmma": ("flash_wgmma",), "gmm_wgmma": ("gmm_wgmma",)},
                      "hybrid": {"flash_wgmma": ("flash_wgmma",),
                                 "ssd_scan": ("ssd_chunk_tc", "ssd_state_tc", "ssd_out_tc")}}


def train_launches(cfg, n_micro, steps) -> dict:
    """The kernel launches `steps` training steps in `n_micro` microbatches
    ask for: each layer's kernels in the forward and again in its remat
    recompute, per microbatch (flash with the lse: one an attention layer,
    whisper's encoder layer one, its decoder layer two, self and cross;
    moe_gmm 3 a MoE layer; ssd_scan 1 a mamba2 layer; the xLSTM none), and
    moe_gmm's dx and dw once each per expert product in the backward."""
    k = n_micro * steps
    want = {n: 0 for n in kernel_counts()}
    if cfg.family == "hybrid":
        nb = cfg.n_layers // cfg.hybrid.attn_every
        want.update(flash_attention=2 * nb * k, ssm_scan=2 * cfg.n_layers * k)
    elif cfg.family == "audio":
        want["flash_attention"] = 2 * (cfg.encdec.n_enc_layers + 2 * cfg.n_layers) * k
    elif cfg.family != "ssm":
        want["flash_attention"] = 2 * cfg.n_layers * k
    if cfg.family == "moe":
        n_gmm = 3 * cfg.n_layers * k
        want.update(moe_gmm=2 * n_gmm, moe_gmm_dx=n_gmm, moe_gmm_dw=n_gmm)
    return want


def gmm_train_path_gate(label, want) -> dict:
    """Training's moe_gmm launches by kernel, forward and backward: every
    one through the tensor-core kernel (phi's bf16 expert tensors and the
    contiguous gradients GroupedMatmul hands over are what TMA reads)."""
    from repro_torch.kernels import moe_gmm as gk
    got = {"fwd": dict(gk.launches_by_path), "dx": dict(gk.dx_launches_by_path),
           "dw": dict(gk.dw_launches_by_path)}
    exp = {kind: {"wgmma": want[key], "rows": 0, "tiled": 0}
           for kind, key in (("fwd", "moe_gmm"), ("dx", "moe_gmm_dx"), ("dw", "moe_gmm_dw"))}
    say(f"  moe_gmm launches by kernel: {got}")
    if got != exp:
        fail(f"{label}: moe_gmm's products did not all go through the tensor-core kernel: "
             f"{got}, want {exp}")
    return got


def active_matmul_params(cfg, params) -> int:
    """Parameters one token's matmuls use, each as often as the token meets
    it: all but the input embedding (a gather; tied, as xLSTM's, it is the
    unembedding too and counts); of a MoE layer's experts only top_k of
    n_experts; the hybrid's shared attention block once per application
    (n_layers / attn_every). 6 x this x tokens leaves out what is not a
    weight product: attention's scores and P.V, and the SSD scan's chunked
    products. Whisper's encoder runs over frames, not tokens: see
    train_matmul_flops."""
    from repro_torch.tree import leaves
    n = sum(t.numel() for t in leaves(params))
    if "out" in params["embed"]:
        n -= params["embed"]["tok"].numel()
    if cfg.family == "moe":
        m = cfg.moe
        experts = sum(lp["moe"][w].numel() for lp in params["layers"] for w in ("w1", "w2", "w3"))
        n -= experts * (m.n_experts - m.top_k) // m.n_experts
    if cfg.family == "hybrid":
        n += (len(params["mamba"]) - 1) * sum(t.numel() for t in leaves(params["shared_attn"]))
    return n


def train_matmul_flops(cfg, params, batch, seq, frames=0) -> float:
    """A training step's weight-product FLOPs: 6 x each weight x the rows it
    meets. One token of batch x seq meets active_matmul_params; whisper's
    encoder weights and its cross-attention's k and v projections meet the
    batch x `frames` encoder frames instead, the rest of its decoder the
    tokens."""
    from repro_torch.tree import leaves
    if cfg.family != "audio":
        return 6.0 * active_matmul_params(cfg, params) * batch * seq
    on_frames = sum(t.numel() for t in leaves(params["enc_layers"])) \
        + sum(lp["cross"][w].numel() for lp in params["dec_layers"] for w in ("wk", "wv"))
    on_tokens = active_matmul_params(cfg, params) - on_frames
    return 6.0 * (on_frames * batch * frames + on_tokens * batch * seq)


def train_phase(cfg, seed, batch, seq, n_micro, steps, dev, gate_leaves=GRAD_GATE_LEAVES,
                frontend=None):
    """8b, 8e-8i: `steps` AdamW steps of `cfg` through make_train_step, with
    TokenPipeline batches of `batch` x `seq` in `n_micro` microbatches
    (and, given `frontend` = (name, rows), bf16 frontend embeddings of
    batch x rows x d_model drawn from a generator seeded per step: whisper's
    enc_embeds, the VLM's patch_embeds): step times, tokens/s, MFU, peak
    memory, a profiled step, the launch gates; then the gradient gate at
    B=1, one microbatch: against the fp32 model (dense, hybrid, whisper,
    VLM), or against the plain bf16 path under the same routing (MoE); the
    xLSTM, which launches no kernel, prints its bf16 gradients' distance to
    the fp32 model's."""
    import numpy as np
    import torch
    from repro_torch import roofline
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer, warmup_cosine
    from repro_torch.train.steps import make_init_state, make_train_step
    from repro_torch.tree import get, leaves, tree_map

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    opt = make_optimizer("adamw")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    state = make_init_state(model, opt)(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    n_matmul = active_matmul_params(cfg, state["params"])
    state_gb = sum(t.numel() * t.element_size() for t in leaves(state)) / 1e9
    say(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B params "
        f"({n_matmul / 1e9:.3f} B in {'active ' if cfg.family == 'moe' else ''}matmuls), params "
        f"and AdamW state {state_gb:.2f} GB, init {time.perf_counter() - t0:.1f} s")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=seed))

    def device_batch(step, rows=None):
        out = {k: torch.from_numpy(np.ascontiguousarray(v[:rows])).to(dev)
               for k, v in pipe.batch_at(step).items()}
        if frontend:
            name, n = frontend
            fgen = torch.Generator(device=dev).manual_seed(seed * 1000 + step)
            out[name] = torch.randn((rows or batch, n, cfg.d_model), generator=fgen,
                                    device=dev).to(torch.bfloat16)
        return out

    # the Trainer's default schedule (TrainerConfig: base lr 3e-4, 10 warmup
    # steps) over a 100-step run
    step_fn = make_train_step(model, opt, warmup_cosine(3e-4, 10, 100),
                              n_microbatches=n_micro)
    reset_counts()
    walls, metrics = [], []
    for s in range(steps):
        b = device_batch(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = kernel_counts()
    n_lse = fk.lse_launches
    tokens = batch * seq
    t_step = float(np.median(walls[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    for s, (w, m) in enumerate(zip(walls, metrics)):
        say(f"  step {s + 1}: {w * 1e3:.1f} ms, loss {m['loss']:.4f}, grad norm "
            f"{m['grad_norm']:.4f}, lr {m['lr']:.3e}")
    frames = frontend[1] if cfg.family == "audio" else 0
    flops = train_matmul_flops(cfg, state["params"], batch, seq, frames)
    mfu = flops / t_step / roofline.PEAK_FLOPS
    # the reference's analytic useful FLOPs of the same step (6 N D plus
    # attention), whose share of the peak the dry-run's records carry
    mf = roofline.model_flops(cfg, ShapeConfig("train", "train", seq, batch))
    how = (f"6 x {n_matmul / 1e9:.3f} B x tokens" if not frames else
           f"6 x (encoder weights x {batch} x {frames} frames + decoder weights x tokens)")
    say(f"  {steps} steps of {batch} x {seq} tokens"
        + (f" ({frontend[0]} {batch} x {frontend[1]})" if frontend else "")
        + f" in {n_micro} microbatches: median of steps "
        f"2-{steps} {t_step * 1e3:.2f} ms, {tokens / t_step:.0f} tokens/s, MFU {mfu * 100:.2f}% "
        f"({how} = {flops / 1e12:.2f} TFLOP / step time / {roofline.PEAK_FLOPS / 1e12:.0f} "
        f"TFLOP/s); model_flops share of peak {mf / t_step / roofline.PEAK_FLOPS * 100:.2f}% "
        f"({mf / 1e12:.2f} TFLOP); peak device memory {peak:.2f} GB")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        fail(f"{cfg.name}: a loss or grad norm is not finite")
    want = train_launches(cfg, n_micro, steps)
    n_flash = want["flash_attention"]
    say(f"  kernel launches on this path: {launches}, {n_lse} flash launches wrote the lse "
        + ("(per step and microbatch, each layer's kernels twice: forward and remat"
           f"{'; moe_gmm dx and dw once an expert product' if cfg.family == 'moe' else ''})"
           if TRAIN_KERNEL_KINDS[cfg.family] else "(none: the path has no kernel)"))
    if launches != want or n_lse != n_flash:
        fail(f"{cfg.name}: training did not go through the kernels as its layers ask: "
             f"{launches}, {n_lse} with lse; want {want}, all flash with lse")
    launches["flash_attention_by_path"] = flash_path_gate(cfg.name, n_flash)
    if cfg.family == "moe":
        launches["moe_gmm_by_path"] = gmm_train_path_gate(cfg.name, want)
    if cfg.family == "hybrid":
        launches["ssm_scan_by_path"] = ssd_path_gate(cfg.name, want["ssm_scan"])
    named = TRAIN_KERNEL_KINDS[cfg.family]
    prof = profile_steps(lambda: step_fn(state, device_batch(steps)), 1, what="train",
                         kernels=[n for ns in named.values() for n in ns],
                         label="the path's kernels" if named else "kernels of the port")
    kinds = {"matmul": 0.0, **{k: 0.0 for k in named}, "other": 0.0}
    for key, ms in prof["device_ms"].items():
        kind = next((k for k, ns in named.items() if any(n in key for n in ns)),
                    "matmul" if any(n in key for n in MATMUL_KERNELS) else "other")
        kinds[kind] += ms
    say("    device ms in the profiled step by kind: " + ", ".join(
        f"{k} {ms:.2f}" for k, ms in kinds.items()) + " (other: elementwise, reductions, "
        "copies, embedding)")
    run = dict(launches, step_ms=t_step * 1e3, tokens_per_s=tokens / t_step, mfu=mfu,
               flops=flops, peak_gb=peak, busy=prof["busy"], device_ms_by_kind=kinds,
               walls=walls, losses=[m["loss"] for m in metrics])
    params = state["params"]
    del state, step_fn, m
    torch.cuda.empty_cache()

    b1 = device_batch(steps + 1, rows=1)

    def grads(params, model):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = model.loss(live, b1)
        return torch.autograd.grad(loss, [get(live, path) for path in gate_leaves])

    if cfg.family == "moe":
        # bf16 rounding flips near-tie router choices, and a flip sends a
        # token to another expert outright: the kernel path replays the
        # plain path's choices and is held to it, not to fp32
        choices = []
        with plain_kernels(), routed_as(choices, replay=False):
            plain = grads(params, model)
        with routed_as(choices, replay=True):
            kern = grads(params, model)
        say(f"  gradient gate at B=1 T={seq}, one microbatch: the kernel path replays the "
            f"plain bf16 path's routing ({len(choices)} dispatches, forward and remat) and is "
            f"held to it:")
        for path, gk, gp in zip(gate_leaves, kern, plain):
            e = rel_l2(gk, gp)
            ok = bool(torch.isfinite(gk.float()).all()) and e <= MOE_PLAIN_L2
            name = "/".join(str(p) for p in path)
            say(f"  {'ok  ' if ok else 'FAIL'} d {name}: rel L2 kernel vs plain path {e:.3e} "
                f"(gate: <= {MOE_PLAIN_L2:g})")
            if not ok:
                fail(f"{cfg.name}: the gradient of {name} on the kernel path is further from "
                     "the plain bf16 path than the order of the kernels' sums explains")
        run["grad_gate"] = {"/".join(map(str, p)): rel_l2(a, b)
                            for p, a, b in zip(gate_leaves, kern, plain)}
        del kern, plain, params
        return run

    kern = grads(params, model)
    if not named:
        # no kernel on the path: the kernel path is the plain one
        params32 = tree_map(lambda t: t.float(), params)
        del params
        exact = grads(params32, build_model(cfg.replace(param_dtype="float32"), device=dev))
        run["grad_vs_fp32"] = {"/".join(map(str, p)): rel_l2(g, e)
                               for p, g, e in zip(gate_leaves, kern, exact)}
        say(f"  gradients at B=1 T={seq}, one microbatch, bf16 against the fp32 model (printed; "
            f"no kernel on this path): " + ", ".join(
                f"d {n} {e:.3e}" for n, e in run["grad_vs_fp32"].items()))
        if not all(bool(torch.isfinite(g.float()).all()) for g in kern):
            fail(f"{cfg.name}: a gradient is not finite")
        del kern, exact, params32
        return run
    with plain_kernels():
        plain = grads(params, model)
        params32 = tree_map(lambda t: t.float(), params)
        del params
        exact = grads(params32, build_model(cfg.replace(param_dtype="float32"), device=dev))
    say(f"  gradient gate at B=1 T={seq}, one microbatch, against the fp32 model:")
    gate_errs = {}
    for path, gk, gp, ge in zip(gate_leaves, kern, plain, exact):
        e_k, e_p = rel_l2(gk, ge), rel_l2(gp, ge)
        ok = bool(torch.isfinite(gk.float()).all()) and e_k <= NOISE_FACTOR * e_p
        name = "/".join(str(p) for p in path)
        gate_errs[name] = (e_k, e_p)
        say(f"  {'ok  ' if ok else 'FAIL'} d {name}: rel L2 err vs fp32: kernel path {e_k:.3e}, "
            f"plain path {e_p:.3e} (gate: kernel <= {NOISE_FACTOR:g} x plain)")
        if not ok:
            fail(f"{cfg.name}: the gradient of {name} on the kernel path is further from fp32 "
                 "than bf16 rounding explains")
    run["grad_gate"] = gate_errs
    del kern, plain, exact, params32
    return run


def restart_phase(seed, dev):
    """8c: the `demo` preset of examples/train_torch.py trained 12 steps
    straight, and again with a crash at step 9 and a restart from the
    checkpoint by a fresh Trainer: every leaf of the two final states equal."""
    import tempfile
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten

    sys.path.insert(0, str(ROOT / "examples"))
    import train_torch
    cfg, p = train_torch.make_cfg("demo"), train_torch.PRESETS["demo"]

    class InjectedFailure(Exception):
        pass

    def trainer(directory, fail_at=None):
        def failure_hook(step):
            if step == fail_at:
                raise InjectedFailure(f"injected failure at step {step}")
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq"],
                                        global_batch=p["batch"], seed=seed))
        return Trainer(build_model(cfg, device=dev), make_optimizer("adamw"), pipe,
                       Checkpointer(directory),
                       TrainerConfig(num_steps=12, ckpt_every=4, log_every=4, n_microbatches=2),
                       failure_hook=failure_hook)

    with tempfile.TemporaryDirectory() as tmp:
        t_ref = trainer(f"{tmp}/ref")
        final_ref = t_ref.run(t_ref.init_or_restore(seed=seed))
        t1 = trainer(f"{tmp}/ft", fail_at=9)
        try:
            t1.run(t1.init_or_restore(seed=seed))
            fail("8c: the injected failure did not stop the run")
        except InjectedFailure:
            pass
        t1.ckpt.wait()
        t2 = trainer(f"{tmp}/ft")
        state = t2.init_or_restore(seed=seed)
        resumed_at = int(state["step"])
        final = t2.run(state)
        ref, got = flatten(final_ref), flatten(final)
        differ = [path for (path, a), (_, b) in zip(ref, got) if not torch.equal(a, b)]
        say(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers, head dim "
            f"{cfg.resolved_head_dim}, seq {p['seq']}, batch {p['batch']}: 12 steps straight, "
            f"loss {t_ref.history[0]['loss']:.4f} -> {t_ref.history[-1]['loss']:.4f}; crashed at "
            f"step 9, resumed from step {resumed_at}; {len(ref) - len(differ)} of {len(ref)} "
            f"leaves equal")
        if [a for a, _ in ref] != [a for a, _ in got] or differ or resumed_at != 8:
            fail(f"8c: the restarted run is not bit-identical to the straight one: {differ[:8]}")
    return {"leaves": len(ref)}


# ----------------------------------------------------------------------------
# phase 9: the xLSTM, whisper and VLM families
# ----------------------------------------------------------------------------

def fill_cache(cache, pc, T):
    """Copy a prefill's cache into a decode cache: the leaves of the same
    shape whole (whisper's cross k/v), the others into their first T rows
    along axis 2 (self k/v, (L, B, S, H, D))."""
    for name, big in cache.items():
        if big.shape == pc[name].shape:
            big.copy_(pc[name])
        else:
            big[:, :, :T] = pc[name]


def frontend_phase(cfg, seed, B, T, cache_len, new_tokens, dev, *, frontend, n_flash,
                   n_decode, gate_layers=None):
    """whisper-tiny (frontend ("enc_embeds", ENC_LEN): stub frame
    embeddings) or internvl2 (("patch_embeds", n_patches): stub patch
    embeddings, the first positions) through the model interface: prefill B
    prompts of T tokens with bf16 frontend embeddings drawn from the seed,
    copy the cache into one of cache_len rows, decode `new_tokens` greedy
    steps; launch counts (exactly n_flash flash launches a prefill, all
    `flash_wgmma`, and n_decode decode launches a step, all `decode_split`),
    times, a profiled decode window, and the logits gate on the prefill and
    on one decode step, on the first `gate_layers` layers when given (an
    fp32 copy of the whole model would not fit)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import whisper as W
    from repro_torch.models.dense import param_dtype

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_params(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    enc = f", {cfg.encdec.n_enc_layers} encoder layers" if cfg.encdec else ""
    say(f"  {cfg.name}: {cfg.n_layers} layers{enc}, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim} (cache "
        f"{cfg.cache_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")
    name, rows = frontend
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)), dtype=torch.int32,
                                    device=dev),
             name: torch.randn((B, rows, cfg.d_model), generator=gen, device=dev)
             .to(param_dtype(cfg))}
    label = cfg.name
    out = {}
    with torch.inference_mode():
        if name == "enc_embeds":
            enc_s = prefill_times(lambda: W.encode(params, batch[name], cfg), 3)
            say(f"  encode: {B} x {rows} frames, median of 3 {np.median(enc_s):.4f} s "
                f"({', '.join(f'{t:.4f}' for t in enc_s)})")
            out["encode_s"] = enc_s
        prefill_s = prefill_times(lambda: model.prefill(params, batch), 2)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pc = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        at_prefill = kernel_counts()
        want_prefill = {"flash_attention": n_flash, "decode_attention": 0, "moe_gmm": 0,
                        "ssm_scan": 0, "moe_gmm_dx": 0, "moe_gmm_dw": 0}
        if at_prefill != want_prefill:
            fail(f"{label}: the prefill did not go through the kernels as its layers ask: "
                 f"{at_prefill}, want {want_prefill}")
        cache = model.init_cache(B, cache_len)
        fill_cache(cache, pc, T)
        del pc
        base = {k: v.clone() for k, v in cache.items()}
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        first = {"tokens": tok, "positions": torch.full((B,), T, dtype=torch.int32, device=dev)}
        toks, step_s = [tok], []
        for i in range(new_tokens):
            pos = torch.full((B,), T + i, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache, {"tokens": tok, "positions": pos})
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            toks.append(tok)
        launches = kernel_counts()
        toks = torch.cat(toks, dim=1)
        if not bool(torch.isfinite(logits.float()).all()) or \
                not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{label}: non-finite prefill logits or out-of-vocab tokens")
        t_prefill = float(np.median(prefill_s))
        say(f"  prefill: {B} x {T} tokens ({name} {B} x {rows}), median of {len(prefill_s)} "
            f"{t_prefill:.4f} s ({', '.join(f'{t:.4f}' for t in prefill_s)}), "
            f"{B * T / t_prefill:.0f} tokens/s")
        say(f"  decode: {new_tokens} steps of {B} sequences on a cache of {cache_len} rows, "
            f"{sum(step_s):.3f} s, {B * new_tokens / sum(step_s):.0f} tokens/s; "
            f"{spread(step_s)} per step")
        want = dict(want_prefill, decode_attention=n_decode * new_tokens)
        say(f"  kernel launches: prefill {at_prefill}, prefill and decode {launches} (per "
            f"prefill {n_flash} flash, per decode step {n_decode} decode)")
        if launches != want:
            fail(f"{label}: the path did not go through the kernels as its layers ask: "
                 f"{launches}, want {want}")
        launches["flash_attention_by_path"] = flash_path_gate(label, n_flash)
        launches["decode_attention_by_path"] = decode_path_gate(label, launches["decode_attention"])
        launches.update(out, prefill_s=prefill_s, step_s=step_s)
        say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

        state = {"tok": tok, "pos": T + new_tokens}

        def step():
            pos = torch.full((B,), state["pos"], dtype=torch.int32, device=dev)
            lg, _ = model.decode_step(params, cache, {"tokens": state["tok"], "positions": pos})
            state["tok"] = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            state["pos"] += 1
        launches["profile"] = profile_steps(step, 4)
        del cache

        if gate_layers:
            say(f"  logits gate on the first {gate_layers} of {cfg.n_layers} layers")
            cfg = cfg.replace(n_layers=gate_layers)
            params = dict(params, layers=params["layers"][:gate_layers])
            base = {k: v[:gate_layers].clone() for k, v in base.items()}
            model = build_model(cfg, device=dev)
            torch.cuda.empty_cache()
            logits, _ = model.prefill(params, batch)
        cfg32 = cfg.replace(param_dtype="float32")
        params32 = _to_f32(params)
        model32 = build_model(cfg32, device=dev)
        with plain_kernels():
            plain, _ = model.prefill(params, batch)
            exact, _ = model32.prefill(params32, batch)
        logits_gate(f"prefill logits (B={B}, T={T})", logits, plain, exact, cfg.vocab_size)
        del plain, exact
        kern, _ = model.decode_step(params, {k: v.clone() for k, v in base.items()}, first)
        with plain_kernels():
            plain, _ = model.decode_step(params, {k: v.clone() for k, v in base.items()}, first)
            exact, _ = model32.decode_step(params32, _to_f32(base), first)
        logits_gate(f"decode-step logits (B={B}, pos {T})", kern, plain, exact, cfg.vocab_size)
    return launches


def xlstm_block_replay(params, tokens, cfg) -> dict:
    """Each block of the xLSTM stack fed the chunked forward's hidden state
    over `tokens`: the relative L2 distance of its parallel output (the
    chunked mLSTM, the sLSTM scan) from its decode step replayed over the
    same input from the empty state, by block."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm as X

    empty = X.init_cache(cfg, tokens.shape[0], device=tokens.device)
    x = L.embed(params["embed"], tokens)
    dist = {}

    def replay(step, block, state):
        ys = []
        for t in range(x.shape[1]):
            y, state = step(block, x[:, t:t + 1], state, cfg)
            ys.append(y)
        return torch.cat(ys, dim=1)
    for a, (blocks, sp) in enumerate(zip(params["mlstm"], params["slstm"])):
        for j, mp in enumerate(blocks):
            y = X.mlstm_fwd(mp, x, cfg)
            state = tuple(empty[k][a, j] for k in ("m_C", "m_n", "m_m"))
            dist[f"m{a}.{j}"] = rel_l2(replay(X.mlstm_decode, mp, state), y)
            x = y
        y = X.slstm_fwd(sp, x, cfg)
        state = tuple(empty[k][a] for k in ("s_c", "s_n", "s_m", "s_h"))
        dist[f"s{a}"] = rel_l2(replay(X.slstm_decode, sp, state), y)
        x = y
    return dist


def xlstm_phase(cfg, seed, B, T, new_tokens, replay_T, dev):
    """xlstm-350m through the model interface. No kernel of the port runs
    here (the reference's xLSTM is jnp, with no Pallas mLSTM), so the path
    is plain PyTorch on the card and the gate is that no kernel launched.
    Prefill B prompts of T tokens (timed, the median of three; one sLSTM
    and one mLSTM block timed alone, for the host's cost of the sequential
    sLSTM), decode
    `new_tokens` greedy steps from the prefill's cache, which is empty as
    the reference's is; the bf16 prefill's distance to the fp32 model;
    then, in fp32 over replay_T tokens, each block's parallel form against
    its decode step replayed over the same input (XLSTM_BLOCK_L2), and the
    whole model's chunked prefill against decode replayed from an empty
    cache (printed)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import xlstm as X

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_params(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    d_in, H, Dh = X._mlstm_dims(cfg)
    nb = X._nb(cfg)
    say(f"  {cfg.name}: {cfg.n_layers} layers ({nb} super-blocks of "
        f"{cfg.xlstm.slstm_every - 1} mLSTM and 1 sLSTM), d_model {cfg.d_model}, mLSTM "
        f"{H} heads of {Dh} (d_in {d_in}), sLSTM {cfg.n_heads} heads of "
        f"{cfg.d_model // cfg.n_heads}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B "
        f"params, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)), dtype=torch.int32,
                          device=dev)
    out = {}
    with torch.inference_mode():
        reset_counts()
        prefill_s = prefill_times(lambda: model.prefill(params, {"tokens": tokens}), 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(logits.float()).all()):
            fail(f"{cfg.name}: non-finite prefill logits")
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        step_s = []
        for _ in range(new_tokens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache, {"tokens": tok})
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = kernel_counts()
        if any(launches.values()):
            fail(f"{cfg.name}: a kernel launched on a path that has none: {launches}")
        if not bool(torch.isfinite(lg.float()).all()):
            fail(f"{cfg.name}: non-finite decode logits")
        t_prefill = float(np.median(prefill_s))
        say(f"  prefill: {B} x {T} tokens, median of {len(prefill_s)} {t_prefill:.4f} s "
            f"({', '.join(f'{t:.4f}' for t in prefill_s)}), {B * T / t_prefill:.0f} tokens/s")
        say(f"  decode: {new_tokens} steps of {B} sequences, {sum(step_s):.3f} s, "
            f"{B * new_tokens / sum(step_s):.0f} tokens/s; {spread(step_s)} per step")
        say(f"  kernel launches of the port: {launches} (none: the path has no kernel)")

        x = torch.randn((B, T, cfg.d_model), generator=gen, device=dev).to(logits.dtype)
        blocks = {"sLSTM": lambda: X.slstm_fwd(params["slstm"][0], x, cfg),
                  "mLSTM": lambda: X.mlstm_fwd(params["mlstm"][0][0], x, cfg)}
        out["block_s"] = {n: prefill_times(fn, 3) for n, fn in blocks.items()}
        say(f"  one block's forward over {B} x {T}, median of 3: " + ", ".join(
            f"{n} {np.median(t):.4f} s" for n, t in out["block_s"].items())
            + f" ({nb} sLSTM and {cfg.n_layers - nb} mLSTM blocks a prefill; the sLSTM scans "
            f"its {T} steps one by one)")
        del x
        state = {"tok": tok, "cache": cache}

        def step():
            lg, _ = model.decode_step(params, state["cache"], {"tokens": state["tok"]})
            state["tok"] = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        out["profile"] = profile_steps(step, 4, kernels=(), label="kernels of the port")
        del cache, state
        say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

        cfg32 = cfg.replace(param_dtype="float32")
        params32 = _to_f32(params)
        model32 = build_model(cfg32, device=dev)
        exact, _ = model32.prefill(params32, {"tokens": tokens})
        V = cfg.vocab_size

        def rate(same):
            return same.float().mean().item() * 100
        out["bf16_vs_fp32"] = rel_l2(logits[..., :V], exact[..., :V])
        say(f"  prefill logits (B={B}, T={T}): bf16 rel L2 to fp32 {out['bf16_vs_fp32']:.3e}, "
            f"greedy-token agreement "
            f"{rate(logits[..., :V].float().argmax(-1) == exact[..., :V].argmax(-1)):.1f}%")
        del exact
        Br = 2
        toks = tokens[:Br, :replay_T]
        blocks = xlstm_block_replay(params32, toks, cfg32)
        out["block_replay_l2"] = max(blocks.values())
        say(f"  fp32, each block's parallel form vs its decode replayed over {Br} x "
            f"{replay_T} tokens (the block's input in the chunked forward): rel L2 "
            + ", ".join(f"{n} {e:.2e}" for n, e in blocks.items())
            + f"; max {out['block_replay_l2']:.3e} (gate <= {XLSTM_BLOCK_L2:g})")
        if not out["block_replay_l2"] <= XLSTM_BLOCK_L2:
            fail(f"{cfg.name}: a block's chunked and recurrent forms disagree beyond fp32 "
                 f"rounding")
        par, _ = model32.prefill(params32, {"tokens": toks})
        rcache = model32.init_cache(Br)
        for t in range(replay_T):
            dec, rcache = model32.decode_step(params32, rcache, {"tokens": toks[:, t:t + 1]})
        out["replay_l2"] = rel_l2(dec[:, 0, :V], par[:, -1, :V])
        say(f"  fp32, the whole model's chunked prefill vs decode replayed over the same "
            f"tokens: last logits rel L2 {out['replay_l2']:.3e}, max abs "
            f"{max_err(dec[:, 0, :V], par[:, -1, :V]):.3e}, greedy-token agreement "
            f"{rate(dec[:, 0, :V].argmax(-1) == par[:, -1, :V].argmax(-1)):.1f}% "
            f"(printed, not gated: see XLSTM_BLOCK_L2)")
    launches.update(out, prefill_s=prefill_s, step_s=step_s)
    return launches


# ----------------------------------------------------------------------------
# phase 10: RL rollouts
# ----------------------------------------------------------------------------

# the card's rollout against the CPU's from the same weights and initial
# state: observations over the first RL_COMPARE_STEPS steps, relative L2
# (each step's rounding differs a few ulps, and 64 steps of the classic
# controls' and the surrogates' maps carry it no further; over 1000 steps it
# is printed, not gated)
RL_COMPARE_STEPS = 64
RL_L2 = 1e-4


class ThreadPoolCluster:
    """SyndeoCluster's `submit(fn, *args, group=, **kwargs)` and
    `wait_all(tasks, timeout)` over a pool of threads, for
    `rl/rollout.py::run_benchmark_local` (this script imports nothing of the
    JAX package, whose `repro.core` holds the real cluster)."""

    def __init__(self, workers: int):
        from concurrent.futures import ThreadPoolExecutor
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def submit(self, fn, *args, group="default", **kwargs):
        return self.pool.submit(fn, *args, **kwargs)

    def wait_all(self, tasks, timeout: float):
        return [t.result(timeout=timeout) for t in tasks]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True)


def rl_phase(seed, dev, n_steps=1000, workers=4, bench_envs=("Cartpole", "Humanoid")):
    """The paper's RL rollout unit on the card: `rollout_task` of n_steps
    for each of the 14 environments (obs shape, finite rewards,
    interactions/s); the same weights and initial state run on the CPU
    (`rollout.core`), the card's observations within RL_L2 of the CPU's over
    the first RL_COMPARE_STEPS steps (over all n_steps printed), the CPU's
    interactions/s beside the card's; no kernel of the port launched; then
    `run_benchmark_local` with `workers` tasks of n_steps for `bench_envs`
    through a thread pool."""
    import numpy as np
    import torch
    from repro_torch.rl import envs as E
    from repro_torch.rl import rollout as R

    R.rollout_task("Humanoid", 8, seed, device=dev)   # the card's first matmuls, untimed
    reset_counts()
    out = {}
    for i, (name, spec) in enumerate(E.ENV_SPECS.items()):
        task = R.rollout_task(name, n_steps, seed + i, device=dev)
        obs = task["obs"]
        if obs.shape != (n_steps, spec.obs_dim) or not np.isfinite(obs).all() \
                or not np.isfinite(task["reward_sum"]):
            fail(f"{name}: the rollout's artifact is {obs.shape}, want ({n_steps}, "
                 f"{spec.obs_dim}), or not finite (reward sum {task['reward_sum']})")
        fn, _ = R.make_rollout_fn(name, n_steps, device=dev)
        params, state0 = fn.init(seed + i)
        cpu_fn, _ = R.make_rollout_fn(name, n_steps, device="cpu")
        t0 = time.perf_counter()
        cpu_obs, _ = cpu_fn.core({k: v.cpu() for k, v in params.items()}, state0.cpu())
        cpu_s = time.perf_counter() - t0
        head = rel_l2(torch.from_numpy(obs[:RL_COMPARE_STEPS]), cpu_obs[:RL_COMPARE_STEPS])
        whole = rel_l2(torch.from_numpy(obs), cpu_obs)
        row = dict(obs_shape=list(obs.shape), reward_sum=task["reward_sum"],
                   wall_s=task["wall_s"], per_s=n_steps / task["wall_s"],
                   cpu_per_s=n_steps / cpu_s, l2_head=head, l2_all=whole)
        out[name] = row
        say(f"  {'ok  ' if head <= RL_L2 else 'FAIL'} {name}: obs {tuple(obs.shape)}, reward sum "
            f"{task['reward_sum']:.4f}, {row['per_s']:.0f} interactions/s on the card "
            f"({task['wall_s']:.3f} s), {row['cpu_per_s']:.0f} on the CPU; card vs CPU obs rel "
            f"L2 {head:.2e} over {RL_COMPARE_STEPS} steps (gate <= {RL_L2:g}), {whole:.2e} over "
            f"{n_steps}")
        if not head <= RL_L2:
            fail(f"{name}: the card's rollout is further from the CPU's than rounding explains")
    launches = kernel_counts()
    say(f"  kernel launches of the port: {launches} (none: the rollout has no kernel)")
    if any(launches.values()):
        fail(f"RL rollouts: a kernel launched on a path that has none: {launches}")
    bench = {}
    with ThreadPoolCluster(workers) as pool:
        for name in bench_envs:
            tput, stats = R.run_benchmark_local(pool, name, workers, n_steps, device=dev)
            bench[name] = dict(stats, per_s=tput)
            say(f"  run_benchmark_local {name}: {workers} tasks x {n_steps} steps on {workers} "
                f"threads, {tput:.0f} interactions/s ({stats['wall_s']:.3f} s wall)")
            if stats["n_tasks"] != workers or not tput > 0:
                fail(f"run_benchmark_local {name}: {stats}")
    return dict(launches, envs=out, bench=bench)


# ----------------------------------------------------------------------------
# phase 11: across ranks
# ----------------------------------------------------------------------------

# 11a: the ring on the card against the same call on the CPU: the same IEEE
# fp32 operations (amax, a correctly rounded division, round half to even,
# products and sums of two terms), so the two should agree bit for bit;
# tests/test_torch_distributed.py holds the CPU ring to JAX's within 1e-6
RING_CPU_TOL = 1e-6
# 11b/11c: the data-parallel step against the single-process step on the
# global batch, bf16. A rank's bf16 gradient of its rows, summed over the
# ranks in fp32, and the single process's one bf16 gradient of all rows
# round apart (2^-9 of an entry), and from the second step on the params do
# too, so losses, aux losses and grad norms are held within 1e-2 relative
# (a wrong mean over the ranks is off by 100%), and the params' update
# within a tenth of its size: ||p_ranks - p_single|| <= DP_UPDATE_TOL *
# ||p_single - p_0||. Where an update moves an entry by ~5 bf16 ulps, one
# entry in a hundred a step rounds the other way, which gives about 0.02
# (PERF.md, phase 11)
DP_METRIC_TOL = 1e-2
DP_UPDATE_TOL = 0.1
# the learning rate of 11b and 11c: the Trainer's base rate, held constant
# (warmup_cosine is 0 at step 0, where an update would compare nothing)
DP_LR = 3e-4
# Adafactor's learning rate (17a, 17b): its step is relative (lr x the
# leaf's RMS x an update clipped to RMS 1), so at DP_LR a bf16 entry would
# move by about a tenth of an ulp and most would not move at all; at 3e-2
# an entry moves 4-8 ulps, as AdamW's first step at DP_LR moves one ~5
AF_LR = 3e-2
RING_WORLD, DP_WORLD = 4, 2


# the ranks of the multi-rank phases (11, 13-17): one set a world size,
# started at first use and kept to the end (distributed.Ranks), so a spawn's
# start-up (imports, the card's context, the group, the pinned buffers) is
# paid once a world size, not once a phase. Their allocators use expandable
# segments: the ranks share the card, and return what a job frees
_RANKS = {}


def on_ranks(fn, world, dev, *args):
    """fn(rank, world, device, *args) on the script's `world` ranks: each
    rank's result, by rank."""
    from repro_torch import distributed as D
    if world not in _RANKS:
        with mock.patch.dict(os.environ,
                             {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}):
            _RANKS[world] = D.Ranks(world, device=dev.type, timeout=900)
        atexit.register(_RANKS[world].close)
    return _RANKS[world].run(fn, *args)


def train_lr(cfg) -> float:
    """The constant learning rate of a training run of `cfg`: AF_LR for
    Adafactor, DP_LR for AdamW."""
    return AF_LR if cfg.optimizer == "adafactor" else DP_LR


def _rank_setup():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # the router's fp32 matmuls in fp32


def layer_grads(seed, rank, dev):
    """A gradient tree of one llama3-8b layer at full width: fp32 normal
    draws from a generator seeded per rank, in the layer's shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import dense
    from repro_torch.tree import tree_map
    shapes = dense.init_block(torch.Generator(), get_config("llama3-8b"), torch.bfloat16, "meta")
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + rank)
    return tree_map(lambda t: torch.randn(t.shape, generator=gen, device=dev), shapes)


def ring_rank(rank, world, dev, seed, reps=3, drift_steps=20):
    """11a on one rank: compressed_psum_mean over the gradient tree of one
    llama3-8b layer: its distance to the exact mean, its median time and
    that of dist.all_reduce on the same tensors in the same group, the bytes
    it sends, the CPU's run on the norms and wq, and the error-feedback
    drift over `drift_steps` calls on wk."""
    import numpy as np
    import torch
    from repro_torch import distributed as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import compressed_psum_mean, make_compressed_grad_reduce
    from repro_torch.tree import get, leaves, tree_map
    _rank_setup()
    mesh = make_mesh((world,), ("data",), device=dev)
    group = mesh.group("data")
    reduce_tree = make_compressed_grad_reduce(mesh, "data")
    grads = layer_grads(seed, rank, dev)
    zeros = tree_map(torch.zeros_like, grads)
    exact = tree_map(lambda g: D.all_reduce_(g.clone(), group=group) / world, grads)
    mean, err = reduce_tree(grads, zeros)
    rel = max(((m - e).abs().max() / e.abs().max()).item()
              for m, e in zip(leaves(mean), leaves(exact)))

    def median_ms(fn):
        out = []
        for _ in range(reps):
            D.all_reduce_(torch.zeros(1, device=dev), group=group)   # start together
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return float(np.median(out)) * 1e3

    ring_ms = median_ms(lambda: reduce_tree(grads, zeros))
    allreduce_ms = median_ms(lambda: [D.all_reduce_(g.clone(), group=group)
                                      for g in leaves(grads)])
    cpu = {}
    # NCCL takes no CPU tensor: the CPU's ring goes over gloo
    cpu_group = group if torch.distributed.get_backend(group) == "gloo" else \
        torch.distributed.new_group(backend="gloo")
    for path in (("ln1",), ("ln2",), ("attn", "wq")):
        g = get(grads, path).cpu()
        cm, ce = compressed_psum_mean(g, torch.zeros_like(g), cpu_group)
        m, e = get(mean, path).cpu(), get(err, path).cpu()
        cpu["/".join(path)] = (max_err(m, cm), max_err(e, ce),
                               bool(torch.equal(m, cm) and torch.equal(e, ce)))
    g = grads["attn"]["wk"]
    e, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(drift_steps):
        m, e = compressed_psum_mean(g, e, group)
        acc += m
    ex = exact["attn"]["wk"]
    n_entries, n_leaves = sum(t.numel() for t in leaves(grads)), len(leaves(grads))
    # what a rank sends: n-1 reduce-scatter hops of (scale, codes) and n-1
    # all-gather hops of (scale, id, codes) per leaf; a bf16 ring sends the
    # same chunks in 2 bytes an entry
    chunk = n_entries // world
    return dict(rel=rel, ring_ms=ring_ms, allreduce_ms=allreduce_ms, cpu=cpu,
                drift=(acc / drift_steps - ex).abs().max().item(),
                drift_bound=0.02 * ex.abs().max().item() + 0.02, entries=n_entries,
                hop_bytes=chunk + 8 * n_leaves, bf16_hop_bytes=2 * chunk,
                sent_bytes=2 * (world - 1) * chunk + (world - 1) * 12 * n_leaves,
                transport=D.transport(dev, group))


def dp_cfgs():
    """11b's llama3-8b x 2 of 32 layers and 11c's phi3.5-moe x 1 of 32, at
    their published widths."""
    from repro_torch.configs import get_config
    return (get_config("llama3-8b").replace(n_layers=2),
            get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=1))


def dp_batch(cfg, seed, step, dev, rows, seq):
    """Step `step`'s global batch of rows x seq TokenPipeline tokens, and
    for whisper rows x ENC_LEN bf16 stub frames drawn from a generator on
    the card seeded by (seed, step), as phase 8g draws them: every process
    draws the same."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.whisper import ENC_LEN
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=rows,
                                    seed=seed))
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in pipe.batch_at(step).items()}
    if cfg.family == "audio":
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + step)
        out["enc_embeds"] = torch.randn((rows, ENC_LEN, cfg.d_model), generator=gen,
                                        device=dev).to(torch.bfloat16)
    return out


def reverse_mlstm_heads(params, cfg):
    """The xLSTM's whole params with each mLSTM block's heads in reverse
    order, in place: a symmetry of the model (q, k, v, the gates' columns,
    z's channels, norm_w and w_down's rows permuted alike), so each block
    computes the same function with its sums over d_in (w_down's product,
    the norm's statistic) and their gradients in another order, the sums a
    "model" rank cuts. Its own inverse."""
    import torch
    H, d_in = cfg.n_heads, int(cfg.xlstm.mlstm_expand * cfg.d_model)

    def rev(t, dim, groups=1):   # t's dim laid out (groups, H, width): reverse H
        return t.unflatten(dim, (groups, H, -1)).flip(dim + 1).flatten(dim, dim + 2)
    with torch.no_grad():
        for blocks in params["mlstm"]:
            for p in blocks:
                for k in ("w_q", "w_k", "w_v"):
                    p[k].copy_(rev(p[k], 1))
                p["w_if"].copy_(rev(p["w_if"], 1, 2))
                p["b_if"].copy_(rev(p["b_if"], 0, 2))
                p["w_up"][:, d_in:].copy_(rev(p["w_up"][:, d_in:], 1))
                p["norm_w"].copy_(rev(p["norm_w"], 0))
                p["w_down"].copy_(rev(p["w_down"], 0))
    return params


def first_grads(model, params, batch, n_micro):
    """The first step's gradient, before its clipping: the mean over the
    microbatches of `batch` (as the train step cuts them on one data rank)
    of the loss's gradient, fp32, on `model`'s mesh (a rank's blocks)."""
    import torch
    from repro_torch.tree import leaves, tree_map, unflatten_like
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    acc = None
    for i in range(n_micro):
        mb = {k: v.reshape(n_micro, -1, *v.shape[1:])[i] for k, v in batch.items()}
        loss, _ = model.loss(live, mb)
        g = [t.float() for t in torch.autograd.grad(loss, leaves(live))]
        acc = g if acc is None else [a.add_(t) for a, t in zip(acc, g)]
    return unflatten_like(params, [a.div_(n_micro) for a in acc])


def single_grads(cfg, seed, dev, n_micro, rows, seq, reverse_heads, path) -> dict:
    """The single process's first gradient (first_grads) of `cfg` drawn
    from `seed` on dp_run's first batch, saved to `path` for the ranks;
    and again on the plain kernels, with `reverse_heads` on its mLSTM heads
    in reverse order (turned back after): kind -> that floor run's relative
    L2 distance to the first (kind_dists)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    model = build_model(cfg, device=dev)
    batch = dp_batch(cfg, seed, 0, dev, rows, seq)

    def draw():
        return model.init_params(torch.Generator(device=dev).manual_seed(seed))
    mine = first_grads(model, draw(), batch, n_micro)
    torch.save(tree_map(lambda t: t.cpu(), mine), path)
    with plain_kernels():
        params = draw()
        other = first_grads(model, reverse_mlstm_heads(params, cfg) if reverse_heads
                            else params, batch, n_micro)
    if reverse_heads:
        reverse_mlstm_heads(other, cfg)
    return {k: (d / u) ** 0.5 for k, (d, u) in kind_dists(other, mine).items()}


def leaf_kind(path) -> str:
    """A leaf's kind, the gradient gate's group: its stack and its name
    ("mlstm/w_up", "slstm/r_gates", "embed/tok")."""
    return "/".join(map(str, (path[0], path[-1]))) if len(path) > 1 else str(path[0])


def kind_dists(got, want, blocks=None) -> dict:
    """Kind -> [squared distance, squared norm of want] between two grads
    trees, summed over each kind's leaves (leaf_kind); `want`'s leaves cut to
    `blocks` (a rank's) where given."""
    import torch
    from repro_torch.tree import flatten, leaves
    out = {}
    for i, ((path, g), w) in enumerate(zip(flatten(got), leaves(want))):
        w = (w if blocks is None else w[blocks[i]]).to(g.device).float()
        k = out.setdefault(leaf_kind(path), [0.0, 0.0])
        k[0] += float(torch.sum(torch.square(g.float() - w)))
        k[1] += float(torch.sum(torch.square(w)))
    return out


def dp_run(cfg, seed, dev, steps, n_micro, rows, seq, mesh=None, shard=None, n_groups=1,
           account_last=False, reverse_heads=False):
    """`steps` steps of `cfg` at `train_lr` with its optimizer (AdamW; Adafactor
    where the config names it) from weights drawn from `seed`,
    on global batches of rows x seq: (state, the per-step losses, grad norms
    and walls, and the kernels' launches counted from the first step). With
    `account_last` the last step runs under the dry-run's account
    (`launch/dryrun.py::accounted`), returned as "account" (phase 12d). With
    `reverse_heads` (the xLSTM) the mLSTM blocks run with their heads in
    reverse order and the state's params come back in the drawn order
    (reverse_mlstm_heads: the rounding floor's run of a model that launches
    no kernel, train_ranks)."""
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.kernels import ssm_scan as sk
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import make_train_step, train_state
    model = build_model(cfg, device=dev, mesh=mesh, n_groups=n_groups)
    opt = make_optimizer(cfg.optimizer)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    if reverse_heads:
        reverse_mlstm_heads(params, cfg)
    state = train_state(params, opt, shard, model.split)
    step = make_train_step(model, opt, lambda s: train_lr(cfg), n_microbatches=n_micro,
                           grad_shardings=shard, mesh=mesh)
    losses, norms, walls = [], [], []
    account, peak = None, 0
    reset_counts()
    for s in range(steps):
        b = dp_batch(cfg, seed, s, dev, rows, seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if account_last and s == steps - 1:
            peak = torch.cuda.max_memory_allocated()   # the account resets it
            (state, m), account = accounted_step(lambda: step(state, b), dev, state, b,
                                                 shard)
        else:
            state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = max(peak, torch.cuda.max_memory_allocated())
    if reverse_heads:
        reverse_mlstm_heads(state["params"], cfg)
    return state, dict(losses=losses, norms=norms, walls=walls, launches=kernel_counts(),
                       account=account, peak_bytes=peak,
                       lse=fk.lse_launches, flash_by_path=dict(fk.launches_by_path),
                       ssd_by_path=dict(sk.launches_by_path),
                       gmm_by_path={"fwd": dict(gk.launches_by_path),
                                    "dx": dict(gk.dx_launches_by_path),
                                    "dw": dict(gk.dw_launches_by_path)})


def accounted_step(fn, dev, state, batch, shard):
    """fn(), one train step on `state` and `batch`, under the dry-run's
    account (as `launch/dryrun.py::train_account` takes it, without its
    init): (fn's result, the account's numbers that 12d holds to the meta
    account)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.tree import leaves
    out, acct = dryrun.accounted(fn, dev, state, batch, params_bytes=sum(
        t.numel() * t.element_size() for t in leaves(state["params"])))
    c = acct.cost
    index = shard.local_index(state["params"], torch.distributed.get_rank())
    accum = 4 * sum(p[b].numel() for p, b in zip(leaves(state["params"]), index)
                    if b is not None)
    return out, dict(flops=c.totals.flops, bytes=c.totals.bytes,
                     collectives=c.totals.collectives, kernels=dict(c.kernels),
                     peak_bytes=c.peak_bytes, accum_bytes=accum,
                     allocator_peak_bytes=acct.allocator_peak_bytes)


def sq_dist(params, other) -> float:
    """The squared L2 distance between two params trees (other's leaves on
    any device)."""
    import torch
    from repro_torch.tree import leaves
    return sum(float(torch.sum(torch.square(a.float() - b.to(a.device).float())))
               for a, b in zip(leaves(params), leaves(other)))


def digest(t):
    """An exact fingerprint of a tensor's bits: its entries, their sum and
    a position-weighted sum, in wrapping int64, computed on its device."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    bits = t.detach().contiguous().view(ints).reshape(-1)
    s = w = 0
    for at in range(0, bits.numel(), 1 << 26):
        part = bits[at:at + (1 << 26)].to(torch.int64)
        pos = torch.arange(at, at + part.numel(), device=part.device) % 1000003 + 1
        s += int(part.sum())
        w += int((part * pos).sum())
    return [t.numel(), s % (1 << 64), w % (1 << 64)]


def block_digests(state, shardings, rank):
    """Path -> digest of `rank`'s block of each leaf of a train state,
    taken from `state`, which holds that rank's blocks or whole leaves."""
    from repro_torch.tree import flatten
    own = shardings.index(state, rank)
    out = {}
    for (path, t), b in zip(flatten(state), own):
        if b is None:
            continue
        whole = tuple(t.shape) == shardings.full_shape(path)
        out["/".join(map(str, path))] = digest(t[b] if whole else t)
    return out


def dp_shardings(cfg, mesh, stack=True):
    """(ZeRO-2 grad shardings, the train state's shardings) of `cfg` (its
    optimizer) on `mesh` under the single-pod rules, the DP axes on the
    layer axis or, without `stack`, on an inner dim."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.sharding.rules import shardings_for, state_shardings
    from repro_torch.train.steps import train_state
    meta = build_model(cfg, device="meta").init_params(torch.Generator())
    shard = shardings_for(meta, cfg, mesh, single_pod_rules(), zero1=True, zero1_stack=stack)
    return shard, state_shardings(train_state(meta, make_optimizer(cfg.optimizer)), cfg, mesh,
                                  single_pod_rules(), shard)


def dp_rank(rank, world, dev, seed, single_path, ckpt_dir, steps, n_micro, rows, seq):
    """11b-11d on one rank: plain DP and ZeRO-2 runs of llama3-8b x 2 (losses,
    norms, walls, peak memory, accumulator bytes, launches, and the params'
    squared distances to the single-process run's and to each other); the
    ZeRO state saved (digests of this rank's blocks) and restored under the
    other ZeRO choice (digests); phi3.5-moe x 1's step, its aux loss and its
    routing."""
    import torch
    from repro_torch import distributed as D
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import train_state
    from repro_torch.tree import leaves, tree_map
    _rank_setup()
    cfg, moe_cfg = dp_cfgs()
    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    single = torch.load(single_path, mmap=True)
    out, plain = {}, None
    for name in ("plain", "zero"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shard, full = dp_shardings(cfg, mesh) if name == "zero" else (None, None)
        state, run = dp_run(cfg, seed, dev, steps, n_micro, rows, seq, mesh, shard)
        run.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   acc_bytes=4 * sum(t.numel() for t in leaves(state["opt"]["m"])),
                   sq_vs_single=sq_dist(state["params"], single))
        if name == "plain":
            plain = tree_map(lambda t: t.cpu(), state["params"])
        else:
            run["sq_vs_plain"] = sq_dist(state["params"], plain)
            run["saved"] = block_digests(state, full, rank)
            t0 = time.perf_counter()
            Checkpointer(ckpt_dir).save(steps, state, blocking=True, shardings=full)
            run["save_s"] = time.perf_counter() - t0
        out[name] = run
        del state
    del plain, single
    # 11d: the saved state restored under the other ZeRO choice
    torch.cuda.empty_cache()
    shard, full = dp_shardings(cfg, mesh, stack=False)
    meta = build_model(cfg, device="meta").init_params(torch.Generator())
    like = train_state(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev), meta),
                       make_optimizer("adamw"), shard)
    t0 = time.perf_counter()
    Checkpointer(ckpt_dir).restore(like, step=steps, shardings=full)
    out["restore_s"] = time.perf_counter() - t0
    out["restored"] = block_digests(like, full, rank)
    del like
    # 11c: phi3.5-moe x 1, each rank's row of the batch in one dispatch group
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(moe_cfg, device=dev, mesh=mesh)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed + 1))
    b = dp_batch(moe_cfg, seed + 1, 0, dev, world, seq)
    with torch.no_grad():
        _, metrics = model.loss(params, {k: v[rank:rank + 1] for k, v in b.items()})
    del params
    choices = []
    with record_routing(choices):
        _, run = dp_run(moe_cfg, seed + 1, dev, 1, 1, world, seq, mesh)
    run.update(aux=float(metrics["aux"]), routing=[c.cpu().numpy() for c in choices],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["moe"] = run
    D.all_reduce_(torch.zeros(1, device=dev))   # every rank done before any frees the group
    return out


def dp_single(seed, dev, steps, n_micro, rows, seq, path):
    """The yardsticks of 11b and 11c, in this process before the ranks start:
    llama3-8b x 2's steps on the global batches (its params saved to `path`)
    and phi3.5-moe x 1's step with n_groups = DP_WORLD, its aux loss and its
    routing."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg, moe_cfg = dp_cfgs()
    torch.cuda.reset_peak_memory_stats()
    state, run = dp_run(cfg, seed, dev, steps, n_micro, rows, seq)
    run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.save(tree_map(lambda t: t.cpu(), state["params"]), path)
    p0 = build_model(cfg, device=dev).init_params(torch.Generator(device=dev).manual_seed(seed))
    run["sq_update"] = sq_dist(state["params"], p0)
    del state, p0
    torch.cuda.empty_cache()
    model = build_model(moe_cfg, device=dev, n_groups=DP_WORLD)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed + 1))
    with torch.no_grad():
        _, metrics = model.loss(params, dp_batch(moe_cfg, seed + 1, 0, dev, DP_WORLD, seq))
    del params
    choices = []
    with record_routing(choices):
        _, moe = dp_run(moe_cfg, seed + 1, dev, 1, 1, DP_WORLD, seq, n_groups=DP_WORLD)
    moe.update(aux=float(metrics["aux"]), routing=[c.cpu().numpy() for c in choices])
    torch.cuda.empty_cache()
    return run, moe


def rel_gate(label, got, want, tol):
    ok = abs(got - want) <= tol * abs(want)
    say(f"  {'ok  ' if ok else 'FAIL'} {label}: {got:.6f} against {want:.6f} "
        f"(rel {abs(got - want) / abs(want):.2e}, gate <= {tol:g})")
    if not ok:
        fail(f"{label}: the ranks' value is further from the single process's than "
             "bf16 rounding explains")


def dp_launch_gate(label, run, cfg, n_micro, steps):
    """A run's kernel launches: exactly what its layers ask for
    (train_launches), every flash launch with the lse through `flash_wgmma`,
    every moe_gmm product through `gmm_wgmma`, every ssd_scan through the
    tensor-core path."""
    want = train_launches(cfg, n_micro, steps)
    n_flash = want["flash_attention"]
    got = (run["launches"], run["lse"], run["flash_by_path"])
    ok = got == (want, n_flash, {"wgmma": n_flash, "simt": 0})
    if cfg.family == "hybrid":
        ok &= run["ssd_by_path"] == {"mma": want["ssm_scan"], "simt": 0}
    if cfg.family == "moe":
        ok &= run["gmm_by_path"] == {
            kind: {"wgmma": want[key], "rows": 0, "tiled": 0}
            for kind, key in (("fwd", "moe_gmm"), ("dx", "moe_gmm_dx"), ("dw", "moe_gmm_dw"))}
    say(f"  {'ok  ' if ok else 'FAIL'} {label}: launches {run['launches']}, {run['lse']} flash "
        f"with the lse, flash by kernel {run['flash_by_path']}"
        + (f", moe_gmm by kernel {run['gmm_by_path']}" if cfg.family == "moe" else "")
        + (f", ssd_scan by kernel {run['ssd_by_path']}" if cfg.family == "hybrid" else ""))
    if not ok:
        fail(f"{label}: the ranks did not go through the kernels as their layers ask: want "
             f"{want}, all flash with the lse on flash_wgmma, every moe_gmm on gmm_wgmma, "
             "every ssd_scan on the tensor-core path")
    return run["launches"]


def ranks_phase(seed, dev, smi, step_8b_ms=None, steps=3, n_micro=2, seq=1024):
    """Phase 11: the port's multi-rank paths on the cards present (NCCL with
    a card a rank, gloo when ranks share one; rank r on card r mod count):
    11a the int8 ring all-reduce (W=4), 11b the data-parallel and ZeRO-2
    train step of llama3-8b x 2 (W=2) against the single-process step,
    11c phi3.5-moe x 1's MoE dispatch groups, 11d the ZeRO state saved at
    W=2 and restored at W=1 and, under the other ZeRO choice, at W=2."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import distributed as D
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import train_state
    from repro_torch.tree import tree_map

    def ranks_line(world):
        say(f"  ranks: W={world}, backend {D.backend_for(world, dev)}, devices "
            f"{[str(D.rank_device(r, dev)) for r in range(world)]}, card {smi}")

    out = {}
    say("phase 11a: the int8 ring all-reduce with error feedback, the gradient tree of one "
        "llama3-8b layer at full width")
    ranks_line(RING_WORLD)
    ring = on_ranks(ring_rank, RING_WORLD, dev, seed)
    r0 = ring[0]
    say(f"  {r0['entries'] / 1e6:.1f} M fp32 entries a rank, over {r0['transport']}: ring "
        f"{r0['ring_ms']:.1f} ms (median of 3, rank 0), dist.all_reduce on the same tensors "
        f"{r0['allreduce_ms']:.1f} ms; a hop carries {r0['hop_bytes'] / 1e6:.2f} MB against "
        f"{r0['bf16_hop_bytes'] / 1e6:.2f} MB in a bf16 ring; {r0['sent_bytes'] / 1e6:.1f} MB "
        f"sent a rank in all")
    for rank, r in enumerate(ring):
        worst = max(v[0] for v in r["cpu"].values()), max(v[1] for v in r["cpu"].values())
        ok = (r["rel"] < 0.05 and r["drift"] < r["drift_bound"]
              and max(worst) <= RING_CPU_TOL)
        say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: rel err to the exact mean {r['rel']:.4f} "
            f"(< 0.05), 20-step drift on wk {r['drift']:.4f} (< {r['drift_bound']:.4f}); "
            f"against the CPU's ring on ln1, ln2, wq: mean {worst[0]:.2e}, residual "
            f"{worst[1]:.2e} (gate <= {RING_CPU_TOL:g}), bitwise "
            f"{all(v[2] for v in r['cpu'].values())}")
        if not ok:
            fail(f"11a: rank {rank}'s ring is not the reference's")
    out["11a"] = {k: r0[k] for k in ("ring_ms", "allreduce_ms", "hop_bytes", "bf16_hop_bytes",
                                     "sent_bytes", "transport")}

    cfg, moe_cfg = dp_cfgs()
    rows = DP_WORLD * n_micro
    tokens = rows * seq
    with tempfile.TemporaryDirectory() as tmp:
        say(f"phase 11b-d: the single process's steps first (llama3-8b x 2, {steps} steps of "
            f"{rows} x {seq} tokens in {n_micro} microbatches; phi3.5-moe x 1, one step of "
            f"{DP_WORLD} x {seq} in {DP_WORLD} dispatch groups)")
        single, moe_single = dp_single(seed, dev, steps, n_micro, rows, seq, f"{tmp}/single.pt")
        t_single = float(np.median(single["walls"][1:]))
        dp_launch_gate("11b single process", single, cfg, n_micro, steps)
        dp_launch_gate("11c single process", moe_single, moe_cfg, 1, 1)
        say(f"  single process: median step {t_single * 1e3:.1f} ms, {tokens / t_single:.0f} "
            f"tokens/s, peak {single['peak_gb']:.2f} GB"
            + (f" (phase 8b, x 4 layers on 4 x 1024: {step_8b_ms:.1f} ms)" if step_8b_ms else ""))
        ranks_line(DP_WORLD)
        ranks = on_ranks(dp_rank, DP_WORLD, dev, seed, f"{tmp}/single.pt", f"{tmp}/ckpt", steps,
                         n_micro, rows, seq)
        say("phase 11b: data-parallel training, llama3-8b x 2 of 32 layers at full width, bf16, "
            f"AdamW at {DP_LR:g}, plain DP and ZeRO-2 (ZeRO-1 state)")
        upd = single["sq_update"] ** 0.5
        for name in ("plain", "zero"):
            for rank, r in enumerate(ranks):
                run = r[name]
                t = float(np.median(run["walls"][1:]))
                say(f"  {name} rank {rank}: median step {t * 1e3:.1f} ms, {tokens / t:.0f} tokens/s,"
                    f" peak {run['peak_gb']:.2f} GB, fp32 accumulator {run['acc_bytes'] / 1e9:.2f}"
                    f" GB" + (f", save {run['save_s']:.1f} s" if "save_s" in run else ""))
                for s in range(steps):
                    rel_gate(f"{name} rank {rank} step {s + 1} loss", run["losses"][s],
                             single["losses"][s], DP_METRIC_TOL)
                    rel_gate(f"{name} rank {rank} step {s + 1} grad norm", run["norms"][s],
                             single["norms"][s], DP_METRIC_TOL)
                d = run["sq_vs_single"] ** 0.5 / upd
                ok = d <= DP_UPDATE_TOL
                if name == "zero":
                    d_plain = run["sq_vs_plain"] ** 0.5 / upd
                    ok &= d_plain <= DP_UPDATE_TOL
                say(f"  {'ok  ' if ok else 'FAIL'} {name} rank {rank}: params' distance to the "
                    f"single process's, over its update, {d:.3e}"
                    + (f"; ZeRO-2 to plain DP {d_plain:.3e}" if name == "zero" else "")
                    + f" (gate <= {DP_UPDATE_TOL:g}; update {upd:.3f})")
                if not ok:
                    fail(f"11b {name}: the ranks' params part from the single process's")
                dp_launch_gate(f"11b {name} rank {rank}", run, cfg, n_micro, steps)
        out["11b"] = {name: dict(step_ms=[float(np.median(r[name]["walls"][1:])) * 1e3
                                          for r in ranks],
                                 peak_gb=[r[name]["peak_gb"] for r in ranks],
                                 acc_bytes=[r[name]["acc_bytes"] for r in ranks])
                      for name in ("plain", "zero")}
        out["11b"]["single_step_ms"] = t_single * 1e3
        dp_runs = [r[name] for r in ranks for name in ("plain", "zero", "moe")]
        out.update({n: sum(run["launches"][n] for run in dp_runs) for n in kernel_counts()})
        out["flash_attention_by_path"] = {p: sum(run["flash_by_path"][p] for run in dp_runs)
                                          for p in ("wgmma", "simt")}
        out["moe_gmm_by_path"] = {kind: {p: sum(r["moe"]["gmm_by_path"][kind][p] for r in ranks)
                                         for p in ("wgmma", "rows", "tiled")}
                                  for kind in ("fwd", "dx", "dw")}

        say("phase 11c: MoE dispatch groups, phi3.5-moe x 1 of 32 layers at full width, one "
            f"step: {DP_WORLD} ranks of one group each against one process with {DP_WORLD}")
        calls = len(ranks[0]["moe"]["routing"])
        for rank, r in enumerate(ranks):
            run = r["moe"]
            same = all(np.array_equal(run["routing"][i], moe_single["routing"][i * DP_WORLD + rank])
                       for i in range(calls))
            n_choices = sum(c.size for c in run["routing"])
            say(f"  {'ok  ' if same else 'FAIL'} rank {rank}: its {calls} dispatches (forward and "
                f"remat) route its {n_choices} (token, k) choices as the single process's group "
                f"{rank} did: {same}; peak {run['peak_gb']:.2f} GB")
            if not same or len(moe_single["routing"]) != calls * DP_WORLD:
                fail("11c: a rank routed its tokens otherwise than the single process's group")
            rel_gate(f"11c rank {rank} loss", run["losses"][0], moe_single["losses"][0],
                     DP_METRIC_TOL)
            rel_gate(f"11c rank {rank} aux loss (the group's means)", run["aux"],
                     moe_single["aux"], DP_METRIC_TOL)
            dp_launch_gate(f"11c rank {rank}", run, moe_cfg, 1, 1)

        say("phase 11d: the ZeRO-2 run's state, saved from 2 ranks, restored into one process "
            "and, under the other ZeRO choice, into 2 ranks")
        mesh = Mesh((DP_WORLD, 1), ("data", "model"))
        _, saved_sh = dp_shardings(cfg, mesh)
        _, other_sh = dp_shardings(cfg, mesh, stack=False)
        t0 = time.perf_counter()
        meta = build_model(cfg, device="meta").init_params(torch.Generator())
        whole = train_state(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                                     meta), make_optimizer("adamw"))
        Checkpointer(f"{tmp}/ckpt").restore(whole, step=steps)
        load_s = time.perf_counter() - t0
        bad = []
        for label, sh, got in (("saved", saved_sh, [r["zero"]["saved"] for r in ranks]),
                               ("restored", other_sh, [r["restored"] for r in ranks])):
            for rank in range(DP_WORLD):
                want = block_digests(whole, sh, rank)
                bad += [(label, rank, k) for k in want if got[rank].get(k) != want[k]]
                bad += [(label, rank, k) for k in got[rank] if k not in want]
        n_leaves = len(block_digests(whole, saved_sh, 0))
        moved = [k for k in ranks[0]["restored"] if "layers/1/" in k and k.startswith("opt")]
        say(f"  {'ok  ' if not bad else 'FAIL'} {n_leaves} leaves: each rank's saved blocks and "
            f"its blocks restored under the other choice ({len(moved)} leaves of layer 1 now "
            f"split on an inner dim on rank 0) bit-identical to the one process's restore; "
            f"restore at W=1 {load_s:.1f} s, at W=2 {ranks[0]['restore_s']:.1f} s")
        if bad:
            fail(f"11d: restored leaves differ from the saved ones: {bad[:8]}")
        del whole
        torch.cuda.empty_cache()
    return out



# ----------------------------------------------------------------------------
# phase 12: the dry-run held to the card
# ----------------------------------------------------------------------------

# the allocator's peak over a step against the account's high-water mark:
# the allocator adds each kernel's scratch (decode's split partials, the
# SSD scan's dS), cuBLAS's workspace and its own rounding of each block
ACCOUNT_PEAK_RATIO = (0.8, 1.25)
# kernel op of the account -> the wrapper's launch counter (kernel_counts)
OP_COUNTERS = {"flash_attention": "flash_attention", "flash_attention_lse": "flash_attention",
               "decode_attention": "decode_attention", "moe_gmm": "moe_gmm",
               "moe_gmm_dx": "moe_gmm_dx", "moe_gmm_dw": "moe_gmm_dw",
               "ssd_scan": "ssm_scan"}
# the production sweep's archs on the card (the rest: the dry-run's CLI,
# PERF.md), each on the one-card and the four-card mesh, in processes of
# their own that run beside phases 3-11
SWEEP_ARCHS = ("llama3-8b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b")
SWEEP_TAG = "chip_smoke"


def step_account(kind, cfg, device, rows, seq, seed, n_micro=2, mesh=None):
    """The dry-run's account (`launch/dryrun.py`) of one step of `cfg` on
    `device`: a train step of rows x seq tokens in n_micro microbatches, a
    prefill of rows x seq, or one decode step of `rows` sequences on a
    cache of `seq` rows; random weights and batch from the seed."""
    import torch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import build_model, make_batch
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
    batch = make_batch(cfg, ShapeConfig(kind, kind, seq, rows), device=dev, generator=gen)
    if kind == "train":
        return dryrun.train_account(cfg, batch, n_micro=n_micro, device=dev, mesh=mesh,
                                    generator=gen)[0]
    if kind == "prefill":
        return dryrun.prefill_account(cfg, batch, device=dev, generator=gen)[0]
    cache = build_model(cfg, device=dev).init_cache(rows, seq)
    return dryrun.decode_account(cfg, batch, cache, device=dev, generator=gen)[0]


def account_gate(label, kind, cfg, seed, dev, smi, rows, seq):
    """12a: the meta account of one step against the same step's account on
    the card: FLOPs, bytes, kernel ops by name and the high-water mark
    equal; the kernel ops equal to the wrappers' launch counts; the
    allocator's peak within ACCOUNT_PEAK_RATIO of the account's; the
    step's measured time (median of three, outside the account) no shorter
    than the roofline's largest term. Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch import roofline
    meta = step_account(kind, cfg, "meta", rows, seq, seed)
    reset_counts()
    card = step_account(kind, cfg, dev, rows, seq, seed)
    torch.cuda.synchronize()
    launched = {n: c for n, c in kernel_counts().items() if c}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        card.again()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    m, c = meta.cost, card.cost
    by_counter = {}
    for op, n in c.kernels.items():
        by_counter[OP_COUNTERS[op]] = by_counter.get(OP_COUNTERS[op], 0) + n
    terms = roofline.roofline_terms(c.totals)
    top = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    wall = float(np.median(walls))
    ratio = card.allocator_peak_bytes / c.peak_bytes
    same = {"flops": m.totals.flops == c.totals.flops, "bytes": m.totals.bytes == c.totals.bytes,
            "kernel ops": m.kernels == c.kernels, "high-water": m.peak_bytes == c.peak_bytes,
            "launches": by_counter == launched}
    ok = all(same.values()) and ACCOUNT_PEAK_RATIO[0] <= ratio <= ACCOUNT_PEAK_RATIO[1] \
        and wall >= terms[top]
    say(f"  {'ok  ' if ok else 'FAIL'} {label} [{smi}]: meta {m.totals.flops / 1e12:.4f} TFLOP "
        f"{m.totals.bytes / 1e9:.4f} GB, card {c.totals.flops / 1e12:.4f} TFLOP "
        f"{c.totals.bytes / 1e9:.4f} GB; kernel ops {c.kernels}, launched {launched}; "
        f"high-water meta {m.peak_bytes / 1e9:.3f} GB, card {c.peak_bytes / 1e9:.3f} GB, "
        f"allocator {card.allocator_peak_bytes / 1e9:.3f} GB (ratio {ratio:.3f}, gate "
        f"{ACCOUNT_PEAK_RATIO}); step {wall * 1e3:.2f} ms against the roofline's {top} "
        f"{terms[top] * 1e3:.3f} ms (compute {terms['compute_s'] * 1e3:.3f}, memory "
        f"{terms['memory_s'] * 1e3:.3f} ms); equal: {same}")
    if not ok:
        fail(f"12a {label}: the dry-run's account and the card disagree")
    out = dict(flops=c.totals.flops, bytes=c.totals.bytes, kernels=dict(c.kernels),
               peak_bytes=c.peak_bytes, allocator_peak_bytes=card.allocator_peak_bytes,
               step_ms=wall * 1e3, **{k: terms[k] * 1e3 for k in ("compute_s", "memory_s")})
    del meta, card
    torch.cuda.empty_cache()
    return out


def start_sweep():
    """12c's production sweep on the meta device, one process an arch and
    mesh, and 12d's and 17d's meta accounts (meta_account_main), started at low
    priority so that they run beside the card's phases. Returns the
    processes."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log_dir = ROOT / "build" / "dryrun" / SWEEP_TAG
    log_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for path, run in ((DP_ACCOUNT_FILE, "15b"), (AF_ACCOUNT_FILE, "17a")):
        path.unlink(missing_ok=True)
        log = open(log_dir / f"{path.stem}.log", "w")
        procs.append((subprocess.Popen(["nice", "-n", "19", sys.executable, "-W", "ignore",
                                        str(ROOT / "chip_smoke.py"), "--meta-account",
                                        str(path), "--meta-run", run], cwd=ROOT, env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    for arch in SWEEP_ARCHS:
        for mesh in ("1x1", "4x1"):
            cmd = ["nice", "-n", "19", sys.executable, "-W", "ignore", "-m",
                   "repro_torch.launch.dryrun", "--arch", arch, "--force", "--tag", SWEEP_TAG,
                   "--mesh", mesh]
            log = open(log_dir / f"{arch}-{mesh}.log", "w")
            procs.append((subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                           stderr=subprocess.STDOUT), log))
    return procs


def stop_sweep(procs):
    for proc, log in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


def sweep_phase(procs, smi, timeout=600):
    """12c: wait for the sweep's processes, then one line a cell: status,
    peak_per_device_gb, fits_80gb, the dominant term, roofline_fraction."""
    from repro_torch.configs import SHAPES
    t0 = time.perf_counter()
    for proc, _ in procs:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    stop_sweep(procs)
    say(f"  [{smi}] the sweep's records (meta device; rank 0 of each mesh):")
    records = []
    for mesh in ("1x1", "4x1"):
        for arch in SWEEP_ARCHS:
            for shape in SHAPES:
                path = ROOT / "build" / "dryrun" / SWEEP_TAG / mesh / f"{arch}__{shape}.json"
                if not path.exists():
                    fail(f"12c: no record {path}")
                r = json.loads(path.read_text())
                records.append(r)
                if r["status"] == "ok":
                    m, t = r["memory"], r["roofline"]
                    say(f"    {mesh} {arch} x {shape}: ok, peak {m['peak_per_device_gb']:.2f} GiB, "
                        f"fits_80gb {m['fits_80gb']}, dominant {t['dominant']}, "
                        f"roofline_fraction {t['roofline_fraction']:.3f}")
                else:
                    say(f"    {mesh} {arch} x {shape}: {r['status']} "
                        f"({r.get('reason') or r.get('error')})")
                    if r["status"] == "error":
                        fail(f"12c: {arch} x {shape} on {mesh}: {r['error']}")
    return records


def dryrun_phase(seed, dev, smi, runs, procs):
    """Phase 12: the dry-run held to the card. a. 8b's, 8e's, llama3-8b's
    decode and zamba2's prefill steps, their meta account against the
    card's (account_gate); b. 11b's ZeRO-2 step on an abstract (2, 1) mesh
    against 11b's ranks; c. the production sweep (sweep_phase)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    out = {}
    say("phase 12a: the dry-run's account on meta against the same step's on the card")
    out["8b"] = account_gate("8b: llama3-8b x 4 layers, train 4 x 1024 in 2 microbatches",
                             "train", get_config("llama3-8b").replace(n_layers=4), seed, dev,
                             smi, 4, 1024)
    out["8e"] = account_gate("8e: phi3.5-moe x 2 layers, train 4 x 1024 in 2 microbatches",
                             "train", get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=2),
                             seed + 1, dev, smi, 4, 1024)
    out["4"] = account_gate("4: llama3-8b decode step, 8 slots of 2048 rows", "decode",
                            get_config("llama3-8b"), seed + 2, dev, smi, 8, 2048)
    out["7"] = account_gate("7: zamba2-2.7b prefill 4 x 1024", "prefill",
                            get_config("zamba2-2.7b"), seed + 3, dev, smi, 4, 1024)

    say("phase 12b: 11b's ZeRO-2 step, llama3-8b x 2 layers, rank 0 of an abstract (2, 1) "
        "mesh on meta, against 11b's ranks")
    cfg = dp_cfgs()[0]
    with dryrun.fake_group(DP_WORLD):
        acct = step_account("train", cfg, "meta", DP_WORLD * 2, 1024, seed, n_micro=2,
                            mesh=Mesh((DP_WORLD, 1), ("data", "model")))
    zero = runs["11"]["11b"]["zero"]
    peak = acct.cost.peak_bytes
    ratios = [p * 1e9 / peak for p in zero["peak_gb"]]
    ok = all(b == acct.accum_bytes for b in zero["acc_bytes"]) and all(
        ACCOUNT_PEAK_RATIO[0] <= r <= ACCOUNT_PEAK_RATIO[1] for r in ratios)
    say(f"  {'ok  ' if ok else 'FAIL'} [{smi}] accumulator a rank: account {acct.accum_bytes} "
        f"bytes, 11b's ranks {zero['acc_bytes']}; peak a rank: account {peak / 1e9:.3f} GB, 11b "
        f"measured {[round(p, 3) for p in zero['peak_gb']]} GB (ratios "
        f"{[round(r, 3) for r in ratios]}, gate {ACCOUNT_PEAK_RATIO}); collectives "
        f"{acct.cost.totals.collectives}")
    if not ok:
        fail("12b: the ZeRO-2 account disagrees with 11b's ranks")
    out["11b"] = dict(accum_bytes=acct.accum_bytes, peak_bytes=peak, ratios=ratios)

    say("phase 12c: the production sweep, every shape of " + ", ".join(SWEEP_ARCHS)
        + " on the one-card (1, 1) and the four-card (4, 1) mesh, on meta")
    out["sweep"] = sweep_phase(procs, smi)
    return out


# ----------------------------------------------------------------------------
# phase 13: tensor-parallel serving
# ----------------------------------------------------------------------------

# the record_function spans of the TP collectives (models/tensor_parallel.py)
# and of FSDP's and the experts' (models/data_parallel.py), which a rank's
# profiled window reads
TP_SPANS = ("tp_all_reduce", "tp_all_gather", "tp_reduce_scatter")
DP_SPANS = ("dp_all_gather", "dp_reduce_scatter", "ep_all_to_all")
# the decode-step gate's batch: the first prompts of a phase
TP_GATE_PROMPTS = 4
TP_PROFILE_STEPS = 4
# the kernels at the ranks' shapes (13d): (label, B, T, Hq, Hkv, D, the kv
# heads a rank reads of a replicated k/v or None)
TP_FLASH_SHAPES = (
    ("llama3-8b TP 4 prefill", 1, 1024, 8, 2, 128, None),
    ("qwen1.5-32b TP 4 prefill", 4, 512, 12, 12, 128, None),
    ("kv heads 2-3 of a replicated 8 (llama3-8b's k/v whole)", 1, 1024, 8, 8, 128, slice(2, 4)),
)
# (label, B, Hq, Hc, S, D, valid rows each, int8)
TP_DECODE_SHAPES = (
    ("llama3-8b TP 4, 8 slots x 2048", 8, 8, 4, 2048, 128, 1024, False),
    ("qwen1.5-32b TP 4, int8", 4, 12, 12, 520, 128, 516, True),
)
# (label, E, C, K, N): phi3.5-moe's products at a rank's d_ff
TP_GMM_SHAPES = (
    ("phi3.5-moe TP 2, w1/w3 at prefill capacity", 16, 160, 4096, 3200),
    ("phi3.5-moe TP 2, w2 (K = 3200)", 16, 160, 3200, 4096),
    ("phi3.5-moe TP 2, w1/w3 at decode capacity", 16, 4, 4096, 3200),
    ("phi3.5-moe TP 4, w1/w3", 16, 160, 4096, 1600),
    ("phi3.5-moe TP 4, w2 (K = 1600)", 16, 160, 1600, 4096),
)


def tp_kernel_phase(gen, dev, flash_shapes=TP_FLASH_SHAPES, decode_shapes=TP_DECODE_SHAPES,
                    gmm_shapes=TP_GMM_SHAPES) -> dict:
    """13d: flash, decode and moe_gmm at the shapes a rank of 13a-13c gives
    them (its heads, its cache heads, its d_ff), each against its plain
    version in bf16 (the int8 cache with a bf16 q), the route it takes
    named and gated (the tensor-core or split kernel), and timed: device
    ms, plain ms, the library call's and the bound; 16d the same at the
    shapes given (no moe_gmm row where `gmm_shapes` is empty). Returns the
    rows by kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import costs, ops, ref

    rnd = _rnd(gen, dev)
    rows = {"flash_attention": [], "decode_attention": []}
    for label, B, T, Hq, Hkv, D, heads in flash_shapes:
        q = rnd(B, T, Hq, D).transpose(1, 2)
        k, v = (rnd(B, T, Hkv, D) for _ in range(2))
        if heads is not None:
            k, v = k[:, :, heads], v[:, :, heads]
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        path = fk.route_for(q, k, v)
        shape = f"B={B} T={T} Hq={Hq} Hkv={k.shape[1]} D={D} bf16 causal"
        err = gate(f"flash {label}, {shape} ({path})", ops.flash_attention(q, k, v),
                   ref.flash_attention_ref(q, k, v), BF16_TOL)
        if path != "wgmma":
            fail(f"flash at {label} did not route to the tensor-core kernel: {path}")
        ms = device_ms(lambda: ops.flash_attention(q, k, v), 20)
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hq != k.shape[1]), 20)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 3)
        bound, by = bound_ms(costs.flash_cost(B, Hq, k.shape[1], T, T, D))
        say(f"    kernel {ms:.4f} ms, sdpa {sdpa:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bound:.4f} ms ({by})")
        rows["flash_attention"].append(dict(path_of=label, shape=shape, kernel=path,
                                            max_abs_err=err, ms=ms, plain_ms=plain,
                                            bound_ms=bound, bound_by=by, library_ms=sdpa))
        del q, k, v
    for label, B, Hq, Hc, S, D, n_valid, int8 in decode_shapes:
        q = rnd(B, Hq, D)
        valid = torch.full((B,), n_valid, device=dev, dtype=torch.int32)
        if int8:
            kf, vf = (rnd(B, S, Hc, D, dtype=torch.float32) for _ in range(2))
            ks, vs = (x.abs().amax(-1, keepdim=True) / 127.0 for x in (kf, vf))
            kc, vc = (torch.round(x / s).to(torch.int8).transpose(1, 2)
                      for x, s in ((kf, ks), (vf, vs)))
            scales = (ks.transpose(1, 2), vs.transpose(1, 2))
            del kf, vf
        else:
            kc, vc = (rnd(B, S, Hc, D).transpose(1, 2) for _ in range(2))
            scales = (None, None)
        path = dk.route_for(kc, vc)
        shape = f"B={B} Hq={Hq} Hc={Hc} S={S} D={D} {'int8' if int8 else 'bf16'}, " \
                f"{n_valid} valid rows each"
        err = gate(f"decode {label}, {shape} ({path})",
                   ops.decode_attention(q, kc, vc, valid, *scales),
                   ref.decode_attention_ref(q, kc, vc, valid, *scales), BF16_TOL)
        if path != "split":
            fail(f"decode at {label} did not route to the split kernel: {path}")
        t = decode_times(q, kc, vc, valid, scales)
        plain = cuda_ms(lambda: ref.decode_attention_ref(q, kc, vc, valid, *scales), 5)
        bound, _ = bound_ms(costs.decode_cost(B, Hq, Hc, S, D, rows=B * n_valid,
                                              cache_itemsize=1 if int8 else 2, scales=int8))
        say(f"    plain {plain:.4f} ms, bound {bound:.4f} ms")
        rows["decode_attention"].append(dict(
            path_of=label, shape=shape, kernel=path, max_abs_err=err, ms=t["kernel"],
            plain_ms=plain, bound_ms=bound, bound_by="bytes", library_ms=t["sdpa"],
            simt_ms=t["simt"]))
        del q, kc, vc
    if gmm_shapes:
        rows["moe_gmm"] = gmm_rows(rnd, dev, gmm_shapes)
    return rows


def gmm_rows(rnd, dev, shapes):
    """moe_gmm's forward at each of `shapes` ((label, E, C, K, N)) against its
    plain version in bf16, its route gated (the tensor-core kernel), timed
    beside torch.bmm, the plain version and the bound: the rows."""
    import torch
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.kernels import costs, ops, ref
    out_rows = []
    for label, E, C, K, N in shapes:
        x = rnd(E, C, K)
        w = rnd(E, K, N, scale=K ** -0.5)
        out = ops.moe_gmm(x, w)
        path = gk.route_for(x, w, out)
        shape = f"E={E} C={C} {K}->{N} bf16"
        err = gate(f"moe_gmm {label}, {shape} ({path})", out, ref.moe_gmm_ref(x, w), BF16_TOL)
        if path != "wgmma":
            fail(f"moe_gmm at {label} did not route to the tensor-core kernel: {path}")
        ms = device_ms(lambda: ops.moe_gmm(x, w), 20)
        lib = device_ms(lambda: torch.bmm(x, w), 20)
        plain = cuda_ms(lambda: ref.moe_gmm_ref(x, w), 3)
        bound, by = bound_ms(costs.gmm_cost(E, C, K, N))
        say(f"    kernel {ms:.4f} ms, torch.bmm {lib:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bound:.4f} ms ({by})")
        out_rows.append(dict(path_of=label, shape=shape, kernel=path, max_abs_err=err,
                             ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                             library_ms=lib))
        del x, w, out
    return out_rows


def tp_prompts(cfg, seed, n, lo, hi):
    """n prompts of lo..hi tokens, drawn from the seed as serve_phase draws
    them (so phase 13a's are phase 4's first)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, cfg.vocab_size, int(k)).tolist() for k in lens]


def gate_logits(prefill, decode, init_cache, prompts, rows, tokens, dev, batched):
    """The logits the phase's gate compares, as fp32 on the host: the
    prefill's of the first prompt (with `batched`, of all of them, of one
    length, in one call) and one decode step with `tokens` (one a prompt)
    over the prompts' caches of `rows` rows."""
    import torch
    B = len(prompts)
    cache = init_cache(B, rows)
    if batched:
        lp, pc = prefill({"tokens": torch.tensor(prompts, dtype=torch.int32, device=dev)})
        for name in cache:
            cache[name][:, :, :pc[name].shape[2]] = pc[name]
    else:
        for i, p in enumerate(prompts):
            lg, pc = prefill({"tokens": torch.tensor([p], dtype=torch.int32, device=dev)})
            lp = lg if i == 0 else lp
            for name in cache:
                cache[name][:, i, :len(p)] = pc[name][:, 0]
    step = {"tokens": torch.tensor(tokens, dtype=torch.int32, device=dev)[:, None],
            "positions": torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                                      device=dev)}
    ld, _ = decode(cache, step)
    return lp.float().cpu(), ld.float().cpu()


def tp_blocks(cfg, n):
    """Rank r's block of every leaf of cfg's params on a (1, n) mesh under
    the serving specs: the shardings, and the whole params on meta."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.sharding.rules import shardings_for
    meta = build_model(cfg, device="meta").init_params(torch.Generator())
    return shardings_for(meta, cfg, Mesh((1, n), ("data", "model")), single_pod_rules()), meta


def tp_references(cfg, seed, n, prompts, rows, tokens, dev, batched, gate_layers):
    """Phase 13's single-process side, run in this process before the ranks
    start: the whole model drawn from `seed` (phase 4's draw for llama3-8b),
    the digest of each rank's block of every leaf, and on the first
    `gate_layers` layers the gate's logits (gate_logits) on the plain path
    in bf16 and in fp32, each with its MoE routing; and the bf16 path's
    peak memory, the single process's."""
    import torch
    from repro_torch.models import build_model, dense
    from repro_torch.tree import flatten

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    sh, _ = tp_blocks(cfg, n)
    digests = [{"/".join(map(str, p)): digest(t[b]) for (p, t), b in
                zip(flatten(params), sh.index(params, r))} for r in range(n)]
    gcfg = cfg.replace(n_layers=gate_layers)
    params = dict(params, layers=params["layers"][:gate_layers])
    out = {"digests": digests, "routing": {"plain": [], "exact": []}}

    def run(p, c):
        return gate_logits(lambda b: dense.lm_prefill(p, b, c),
                           lambda cache, b: dense.lm_decode_step(p, cache, b, c),
                           lambda B, S: dense.init_cache(c, B, S, device=dev),
                           prompts, rows, tokens, dev, batched)
    with torch.inference_mode(), plain_kernels():
        with record_routing(out["routing"]["plain"]):
            out["plain"] = run(params, gcfg)
        out["single_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        params = _to_f32(params)
        with record_routing(out["routing"]["exact"]):
            out["exact"] = run(params, gcfg.replace(param_dtype="float32"))
        del params
    out["routing"] = {k: [t.cpu() for t in v] for k, v in out["routing"].items()}
    torch.cuda.empty_cache()
    return out


def tp_profile(step, steps) -> dict:
    """Profile `steps` calls of step() on this rank: the step's ms (profiler
    on), the device's busy share (kernels and copies) and, of it, the
    copies' ms a step, and the ms and count a step of the TP, FSDP and EP
    collectives' spans (host clock, which holds the host-staged copies and
    the wait for the work queued before them) and the ms of NCCL's kernels
    on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    spans = {n: 0.0 for n in TP_SPANS + DP_SPANS}
    counts = {n: 0 for n in TP_SPANS + DP_SPANS}
    busy = nccl = copies = 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() in spans:
                spans[e.name()] += e.duration_ns() / 1e6
                counts[e.name()] += 1
        elif not e.is_hidden_event():
            busy += e.duration_ns() / 1e9
            nccl += e.duration_ns() / 1e6 if "nccl" in e.name().lower() else 0.0
            copies += e.duration_ns() / 1e6 if "memcpy" in e.name().lower() else 0.0
    return {"step_ms": window / steps * 1e3, "busy": busy / window,
            **{f"{n}_ms": v / steps for n, v in spans.items()},
            **{f"{n}_count": v / steps for n, v in counts.items()}, "nccl_ms": nccl / steps,
            "copy_ms": copies / steps}


def tp_rank(rank, world, dev, job):
    """13a-13c on one rank of a (1, world) mesh: the model built
    tensor-parallel from the seed (init_params keeps the rank's blocks), the
    digests of its blocks, its param bytes and the sum of its blocks' bytes
    from the specs; then the serving run (13a, 13b: a ServeEngine over
    `job["requests"]`; 13c: one batched prefill and `job["steps"]` decode
    steps through the model interface) with its kernel launches by kernel,
    times, a profiled window and its MoE routing's digest; and the gate's
    logits on the kernel path (13c: the serving run's own)."""
    import numpy as np
    import torch
    from repro_torch import distributed as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tree import flatten
    _rank_setup()
    cfg, dev = job["cfg"], torch.device(dev)
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(job["seed"]))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "transport": D.transport(dev, model.tp.group)}
    sh, meta = tp_blocks(cfg, world)
    out["digests"] = {"/".join(map(str, p)): digest(t) for p, t in flatten(params)}
    out["param_bytes"] = sum(t.numel() * t.element_size() for _, t in flatten(params))
    out["block_bytes"] = sum(t[b].numel() * t.element_size() for (_, t), b in
                             zip(flatten(meta), sh.index(meta, rank)))
    out["plan"] = {k: str(v) for k, v in vars(model.tp).items() if k != "group"}
    if cfg.family == "moe":
        out["expert_cols"] = int(params["layers"][0]["moe"]["w1"].shape[-1])
    timings = {"prefill": [], "decode": []}
    routes = []
    with torch.inference_mode(), record_routing(routes):
        reset_counts()
        t0 = time.perf_counter()
        if "requests" in job:
            engine = ServeEngine(timed_model(model, timings), params,
                                 batch_slots=job["slots"], max_len=job["max_len"], device=dev)
            reqs = [Request(id=i, prompt=p, max_new_tokens=job["new_tokens"])
                    for i, p in enumerate(job["requests"])]
            for r in reqs:
                engine.add_request(r)
            engine.tick()
            engine.tick()
            k0 = len(timings["decode"])
            out["profile"] = tp_profile(engine.tick, TP_PROFILE_STEPS)
            k1 = len(timings["decode"])
            engine.run_until_drained()
            out["outputs"] = [r.output for r in reqs]
            out["prefills"], out["steps"] = engine.stats["prefills"], engine.stats["ticks"]
        else:
            tm = timed_model(model, timings)
            prompts = torch.tensor(job["prompts"], dtype=torch.int32, device=dev)
            B, T = prompts.shape
            lp, pc = tm.prefill(params, {"tokens": prompts})
            cache = model.init_cache(B, T + len(job["tokens"]))
            for name in cache:
                cache[name][:, :, :T] = pc[name]
            del pc
            logits = []

            def step():
                i = len(logits)
                batch = {"tokens": torch.tensor(job["tokens"][i], dtype=torch.int32,
                                                device=dev)[:, None],
                         "positions": torch.full((B,), T + i, dtype=torch.int32, device=dev)}
                logits.append(tm.decode_step(params, cache, batch)[0])
            step()
            step()
            k0 = len(timings["decode"])
            out["profile"] = tp_profile(step, TP_PROFILE_STEPS)
            k1 = len(timings["decode"])
            while len(logits) < len(job["tokens"]):
                step()
            out["outputs"] = torch.stack([lg[:, -1].argmax(-1) for lg in logits], 1).tolist()
            out["gate"] = (lp.float().cpu().numpy(), logits[0].float().cpu().numpy())
            out["prefills"], out["steps"] = 1, len(logits)
            del cache, logits
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
    out["launches"] = kernel_counts()
    out["by_path"] = {"flash_attention": dict(fk.launches_by_path),
                      "decode_attention": dict(dk.launches_by_path),
                      "moe_gmm": dict(gk.launches_by_path)}
    out["timings"] = {"prefill": timings["prefill"],
                      "decode": timings["decode"][:k0] + timings["decode"][k1:]}
    out["routing_digest"] = [digest(t) for t in routes]
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if "gate" not in out:
        gl = job["gate_layers"]
        gcfg = cfg.replace(n_layers=gl)
        gmodel = build_model(gcfg, device=dev, mesh=mesh)
        gparams = dict(params, layers=params["layers"][:gl])
        routes = []
        with torch.inference_mode(), record_routing(routes):
            prompts = job["requests"][:TP_GATE_PROMPTS]
            out["gate"] = tuple(t.numpy() for t in gate_logits(
                lambda b: gmodel.prefill(gparams, b),
                lambda cache, b: gmodel.decode_step(gparams, cache, b),
                gmodel.init_cache, prompts, job["max_len"], job["gate_tokens"], dev, False))
        out["gate_routing"] = [t.cpu().numpy() for t in routes]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def tp_launch_gate(label, r, cfg):
    """One rank's serving run: exactly a flash launch a layer a prefill, a
    decode launch a layer a step and, for an MoE model, 3 moe_gmm launches
    a layer a prefill and a step, every one on the tensor-core or split
    kernel; no other kernel."""
    L, pre, steps = cfg.n_layers, r["prefills"], r["steps"]
    n_gmm = 3 * L * (pre + steps) if cfg.family == "moe" else 0
    want = {"flash_attention": L * pre, "decode_attention": L * steps, "moe_gmm": n_gmm,
            "ssm_scan": 0, "moe_gmm_dx": 0, "moe_gmm_dw": 0}
    paths = {"flash_attention": {"wgmma": L * pre, "simt": 0},
             "decode_attention": {"split": L * steps, "simt": 0},
             "moe_gmm": {"wgmma": n_gmm, "rows": 0, "tiled": 0}}
    ok = r["launches"] == want and r["by_path"] == paths
    say(f"  {'ok  ' if ok else 'FAIL'} {label}: launches {r['launches']}, by kernel "
        f"{r['by_path']} ({pre} prefills, {steps} decode steps of {L} layers)")
    if not ok:
        fail(f"{label}: the rank did not launch the kernels as its layers ask: want {want}, "
             f"all on {paths}")


def tp_phase(label, cfg, seed, n, dev, smi, *, requests=None, prompts=None, slots=8,
             max_len=2048, new_tokens=16, steps=8, gate_layers=None, phase4=None):
    """13a-13c: `cfg` served on n ranks of a (1, n) mesh (on_ranks:
    NCCL with a card a rank, else gloo through host memory), held to this
    process's whole model from the same seed. With `requests` (prompts of
    any length) a ServeEngine of `slots` x `max_len` on every rank serves
    them, `new_tokens` each; with `prompts` (one length) one batched prefill
    and `steps` decode steps through the model interface. Gates: each rank's
    blocks' digests equal this process's blocks of the whole draw; its param
    bytes equal the sum of its blocks; its launches exact and all on the
    tensor-core or split kernel; the outputs (and MoE routing) identical
    across ranks; the logits of the gate's prefill and decode step no
    further from the fp32 plain path than logits_gate allows (on the first
    `gate_layers` layers). Prints the times, the collectives' ms a step, the
    device's idle share and each rank's memory."""
    import numpy as np
    import torch
    from repro_torch import distributed as D
    gate_layers = gate_layers or cfg.n_layers
    rng = np.random.default_rng(seed + 1)
    batched = prompts is not None
    say(f"  [{smi}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.eff_q_heads}/{cfg.eff_kv_heads} (cache {cfg.cache_kv_heads}, "
        f"{cfg.kv_cache_dtype}), d_ff {cfg.d_ff}"
        f"{f', {cfg.moe.n_experts} experts top-{cfg.moe.top_k}' if cfg.moe else ''}, "
        f"on {n} ranks: backend {D.backend_for(n, dev)}, devices "
        f"{[str(D.rank_device(r, dev)) for r in range(n)]}")
    if batched:
        tokens = rng.integers(0, cfg.vocab_size, (steps, len(prompts))).tolist()
        gate_prompts, rows, gate_tokens = prompts, len(prompts[0]) + steps, tokens[0]
        job = {"cfg": cfg, "seed": seed, "prompts": prompts, "tokens": tokens}
    else:
        gate_prompts = requests[:TP_GATE_PROMPTS]
        rows, gate_tokens = max_len, rng.integers(0, cfg.vocab_size, len(gate_prompts)).tolist()
        job = {"cfg": cfg, "seed": seed, "requests": requests, "slots": slots,
               "max_len": max_len, "new_tokens": new_tokens, "gate_layers": gate_layers,
               "gate_tokens": gate_tokens}
    t0 = time.perf_counter()
    refs = tp_references(cfg, seed, n, gate_prompts, rows, gate_tokens, dev, batched,
                         gate_layers)
    say(f"  single process: whole model and the references on {gate_layers} layers in "
        f"{time.perf_counter() - t0:.1f} s; bf16 plain path's peak {refs['single_peak_gb']:.2f} GB")
    t0 = time.perf_counter()
    ranks = on_ranks(tp_rank, n, dev, job)
    inits = ", ".join(f"{r['init_s']:.1f}" for r in ranks)
    say(f"  {n} ranks over {ranks[0]['transport']}: {time.perf_counter() - t0:.1f} s wall, "
        f"init {inits} s")
    for rank, r in enumerate(ranks):
        same = r["digests"] == refs["digests"][rank]
        ok = same and r["param_bytes"] == r["block_bytes"]
        say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: {len(r['digests'])} leaves, their blocks' "
            f"digests equal this process's blocks of the whole draw: {same}; param bytes "
            f"{r['param_bytes']} = sum of its blocks {r['block_bytes']}; peak "
            f"{r['peak_gb']:.2f} GB ({r['serve_peak_gb']:.2f} GB serving), single process "
            f"{refs['single_peak_gb']:.2f} GB")
        if not ok:
            fail(f"{label}: rank {rank}'s weights are not its blocks of the seed's draw")
        tp_launch_gate(f"{label} rank {rank}", r, cfg)
        if cfg.family == "moe" and r["expert_cols"] != cfg.d_ff // n:
            fail(f"{label}: rank {rank} holds {r['expert_cols']} expert columns, not "
                 f"{cfg.d_ff // n}")
    r0 = ranks[0]
    say(f"  plan of rank 0: {r0['plan']}")
    if not all(r["outputs"] == r0["outputs"] for r in ranks):
        fail(f"{label}: the ranks' greedy outputs differ")
    if not all(r["routing_digest"] == r0["routing_digest"] for r in ranks):
        fail(f"{label}: the ranks routed tokens differently")
    alike_logits = all(np.array_equal(a, b) for r in ranks for a, b in zip(r["gate"], r0["gate"]))
    if not alike_logits:
        fail(f"{label}: the ranks' gate logits differ")
    routing = f" and routing ({len(r0['routing_digest'])} dispatches)" if cfg.moe else ""
    say(f"  ok   outputs ({len(r0['outputs'])} sequences), gate logits{routing} bit-identical "
        "across ranks")
    if phase4 is not None:
        got = [o[:new_tokens] for o in r0["outputs"]]
        want = [o[:new_tokens] for o in phase4[:len(got)]]
        tok = sum(a == b for x, y in zip(got, want) for a, b in zip(x, y))
        say(f"  greedy outputs against phase 4's single process (its first {len(got)} "
            f"requests, first {new_tokens} tokens): {tok} of {sum(map(len, got))} tokens "
            f"({tok / sum(map(len, got)) * 100:.1f}%), {sum(x == y for x, y in zip(got, want))} "
            f"of {len(got)} requests whole")
    pre, dec = r0["timings"]["prefill"], r0["timings"]["decode"]
    say(f"  rank 0: prefill {spread(pre)} per {'batch' if batched else 'request'}; decode "
        f"{spread(dec)} per step of {len(gate_prompts) if batched else slots} slots "
        f"(profiled steps left out); serving run {r0['wall_s']:.2f} s")
    for rank, r in enumerate(ranks):
        p = r["profile"]
        say(f"  rank {rank}, profiled {TP_PROFILE_STEPS} decode steps: {p['step_ms']:.2f} ms a "
            f"step, all-reduce {p['tp_all_reduce_ms']:.2f} ms and all-gather "
            f"{p['tp_all_gather_ms']:.2f} ms a step (host spans), NCCL kernels "
            f"{p['nccl_ms']:.3f} ms; device busy {p['busy'] * 100:.1f}% (idle "
            f"{100 - p['busy'] * 100:.1f}%), of it copies {p['copy_ms']:.2f} ms a step")
    say(f"  logits gate on the first {gate_layers} of {cfg.n_layers} layers, rank 0's kernel "
        f"path against this process's plain path in bf16 and in fp32")
    alike = None
    if cfg.family == "moe":
        kern_routes = [torch.from_numpy(a) for a in r0["gate_routing"]]
        plain = refs["routing"]["plain"]
        share = routing_agreement(kern_routes, plain)
        say(f"  routing of the gate's prefill and decode step: {share * 100:.2f}% of the (token, "
            f"k) choices alike on the kernel path and the plain path (gate >= "
            f"{MOE_ROUTING_AGREEMENT * 100:g}%)")
        if not share >= MOE_ROUTING_AGREEMENT:
            fail(f"{label}: the kernel path routed tokens unlike the plain path")
    names = ("prefill logits" + (f" (B={len(gate_prompts)})" if batched else
                                 f" (T={len(gate_prompts[0])})"),
             f"decode-step logits (B={len(gate_prompts)})")
    compared = total = 0
    for i, name in enumerate(names):
        kern = torch.from_numpy(r0["gate"][i])
        if cfg.family == "moe":   # the first prefill's dispatches, or the decode step's
            part = slice(0, gate_layers) if i == 0 else slice(-gate_layers, None)
            alike = routed_alike(kern_routes[part], plain[part], kern.shape[0])
        compared += logits_gate(name, kern, refs["plain"][i], refs["exact"][i],
                                cfg.vocab_size, alike)
        total += kern.shape[0]
    if cfg.family == "moe" and not 2 * compared >= total:
        fail(f"{label}: fewer than half the sequences were routed alike")
    counts = {n_: sum(r["launches"][n_] for r in ranks) for n_ in ranks[0]["launches"]}
    for kname in ("flash_attention", "decode_attention", "moe_gmm"):
        counts[f"{kname}_by_path"] = {p: sum(r["by_path"][kname][p] for r in ranks)
                                      for p in ranks[0]["by_path"][kname]}
    counts["profile"] = [r["profile"] for r in ranks]
    counts["peak_gb"] = [r["peak_gb"] for r in ranks]
    counts["single_peak_gb"] = refs["single_peak_gb"]
    counts["decode_ms"] = float(np.median(dec)) * 1e3
    counts["prefill_ms"] = float(np.median(pre)) * 1e3
    return counts


def tp_serving_phase(seed, dev, smi, gen, phase4_outputs=None) -> dict:
    """Phase 13: 13a llama3-8b at full width and depth on a (1, 4) mesh
    through the engine (phase 4's first 8 requests, 16 new tokens each);
    13b phi3.5-moe x 8 of 32 layers on (1, 2) through the engine; 13c
    qwen1.5-32b x 16 of 64 layers on (1, 4) through the model interface
    (int8 cache, 12 padded heads a rank, QKV bias): one prefill of 4 x 512,
    8 decode steps; 13d the kernels at the ranks' shapes. Returns the
    ranks' launches summed, by kernel, and 13d's rows."""
    from repro_torch.configs import get_config
    out = {}
    say("phase 13a: llama3-8b at published width and depth, tensor-parallel on 4 ranks, "
        "through the engine")
    cfg = get_config("llama3-8b")
    out["13a"] = tp_phase("13a", cfg, seed, 4, dev, smi,
                          requests=tp_prompts(cfg, seed, 16, 16, 1024)[:8],
                          phase4=phase4_outputs)
    # 32 layers are 41.9 B params (78 GiB of bf16); 8 are 10.7 B, 5.4 B a rank
    say("phase 13b: phi3.5-moe at published width, 8 of 32 layers, expert-TP on 2 ranks, "
        "through the engine")
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=8)
    out["13b"] = tp_phase("13b", cfg, seed + 2, 2, dev, smi,
                          requests=tp_prompts(cfg, seed + 2, 8, 16, 1024), gate_layers=4)
    # 64 layers are 32.5 B params, 65 GB of bf16 weights: with the fp32 copy
    # the single process's gate reads, 16 layers (10.3 B) fill the card
    say("phase 13c: qwen1.5-32b at published width, 16 of 64 layers, tensor-parallel on 4 "
        "ranks, through the model interface, int8 KV cache")
    cfg = get_config("qwen1.5-32b").replace(n_layers=16)
    prompts = tp_prompts(cfg, seed + 3, 4, 512, 512)
    out["13c"] = tp_phase("13c", cfg, seed + 3, 4, dev, smi, prompts=prompts, steps=8)
    say("phase 13d: the kernels at the ranks' shapes")
    out["13d"] = tp_kernel_phase(gen, dev)
    total = {}
    for part in ("13a", "13b", "13c"):
        for k, v in out[part].items():
            if isinstance(v, int):
                total[k] = total.get(k, 0) + v
            elif k.endswith("_by_path"):
                total[k] = {p: total.get(k, {}).get(p, 0) + c for p, c in v.items()}
    return dict(total, parts={k: out[k] for k in ("13a", "13b", "13c")}, kernels=out["13d"])


# ----------------------------------------------------------------------------
# phase 14: tensor-parallel training over the "model" axis
# ----------------------------------------------------------------------------

# (label, B, T, Hq, Hkv, D): flash with the lse at a TP rank's training shape
TP_TRAIN_FLASH_SHAPES = (("llama3-8b TP 4 train", 2, 1024, 8, 2, 128),)
# moe_gmm's dx and dw at phi3.5-moe's training capacity (2 x 1024 tokens a
# microbatch) and a TP 2 rank's d_ff
TP_TRAIN_GMM_DIMS = ((4096, 3200), (3200, 4096))


def tp_train_kernel_phase(gen, dev, flash_shapes=TP_TRAIN_FLASH_SHAPES, gmm_experts=16,
                          gmm_dims=TP_TRAIN_GMM_DIMS) -> dict:
    """14d: flash with the lse at a TP 4 rank's training heads (held to the
    plain version's out and lse, timed beside the plain version, SDPA and
    the bound) and moe_gmm's dx and dw at a TP 2 rank's d_ff (gmm_bwd_phase
    at C=320); 15d the same at the shapes `flash_shapes`, `gmm_experts` and
    `gmm_dims` give (16d: no moe_gmm where `gmm_dims` is None). Returns the
    rows by kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import costs, ops, ref
    rnd = _rnd(gen, dev)
    rows = {"flash_attention": []}
    for label, B, T, Hq, Hkv, D in flash_shapes:
        q, k, v = (rnd(B, T, h, D).transpose(1, 2) for h in (Hq, Hkv, Hkv))
        path = fk.route_for(q, k, v)
        want_out, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True)
        out, lse = ops.flash_attention(q, k, v, return_lse=True)
        shape = f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16 causal, with the lse"
        err = gate(f"flash {label}, {shape} ({path})", out, want_out, BF16_TOL)
        gate(f"lse {label} ({path})", lse, want_lse, LSE_TOL)
        if path != "wgmma":
            fail(f"flash at {label} did not route to the tensor-core kernel: {path}")
        ms = device_ms(lambda: ops.flash_attention(q, k, v, return_lse=True), 20)
        plain = device_ms(lambda: ref.flash_attention_ref(q, k, v, return_lse=True), 3)
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hq != Hkv), 20)
        bound, by = bound_ms(costs.flash_cost(B, Hq, Hkv, T, T, D))
        say(f"  time {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {sdpa:.4f} ms, "
            f"bound {bound:.4f} ms by {by} (device time)")
        rows["flash_attention"].append(dict(label=label, shape=shape, path=path, max_abs_err=err,
                                            ms=ms, plain_ms=plain, library_ms=sdpa,
                                            bound_ms=bound, bound_by=by))
        del q, k, v, out, lse, want_out, want_lse
    if gmm_dims is not None:
        rows["moe_gmm"] = gmm_bwd_phase(gen, dev, E=gmm_experts, caps=(320,), dims=gmm_dims)
    return rows


def tp_train_rank(rank, world, dev, job):
    """14a-14c on one rank: `job["steps"]` steps of `job["cfg"]` (its
    optimizer) on a `job["shape"]` mesh (ZeRO-2 over its data axis with
    `job["zero"]`), from the seed's weights (the rank's blocks of the whole
    draw) on the same batches as the single process (dp_run); then the
    distance of its blocks to the single process's (saved at
    `job["single"]`) and of their update, the digests of the leaves no
    rank splits, its peak memory and a profiled step's TP spans. With
    `job["ckpt"]` (17c) the state is saved there and restored (ckpt_rank);
    with `job["account_after"]` (17d) one more step, routed by its own
    router, runs under the dry-run's account; with `job["grads"]` (16e) its
    blocks of the first step's gradient are held to the single process's
    saved there (first_grads, kind_dists)."""
    import torch
    from repro_torch import distributed as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.sharding.rules import model_shardings, shardings_for
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import flatten, leaves
    _rank_setup()
    cfg, dev = job["cfg"], torch.device(dev)
    mesh = make_mesh(job["shape"], ("data", "model"), device=dev)
    meta = build_model(cfg, device="meta").init_params(torch.Generator())
    shard = shardings_for(meta, cfg, mesh, single_pod_rules(), zero1=True) if job["zero"] \
        else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the single process dispatched the data ranks' groups in turn: this
    # rank's are every n-th of its dispatches, from its data coordinate
    n_data, d = job["shape"][0], rank // job["shape"][1]
    routes = [torch.from_numpy(c).to(dev) for c in job["routing"][d::n_data]]
    reset_dp_calls()
    with routed_as(routes, replay=True):
        state, run = dp_run(cfg, job["seed"], dev, job["steps"], job["n_micro"], job["rows"],
                            job["seq"], mesh, shard, account_last=job.get("account", False))
    run["dp_calls"] = dp_calls(job["steps"])
    run["tp_calls"] = tp_calls(job["steps"])
    run["peak_gb"] = run["peak_bytes"] / 1e9
    if rank == 0:
        say(f"  [rank 0] {cfg.name} on {job['shape']}: steps "
            f"{', '.join(f'{w:.2f}' for w in run['walls'])} s, peak {run['peak_gb']:.2f} GB"
            + (" (the last step under the account)" if run["account"] else ""))
    run["transport"] = D.transport(dev)
    model = build_model(cfg, device=dev, mesh=mesh)
    # the rank's blocks' distance to the single process's, and their update
    single = torch.load(job["single"], mmap=True)
    sh = model_shardings(meta, cfg, mesh, single_pod_rules())
    p0 = model.init_params(torch.Generator(device=dev).manual_seed(job["seed"]))
    sq = upd = 0.0
    by_leaf = []
    for (path, got), want, first, blk in zip(flatten(state["params"]), leaves(single),
                                             leaves(p0), sh.index(meta,
                                                                  torch.distributed.get_rank())):
        w = want[blk].to(dev).float()
        d = float(torch.sum(torch.square(got.float() - w)))
        u = float(torch.sum(torch.square(w - first.float())))
        sq, upd = sq + d, upd + u
        by_leaf.append(("/".join(map(str, path)), d, u))
    if job.get("grads"):   # its blocks of the first gradient, by leaf kind
        b = dp_batch(cfg, job["seed"], 0, dev, job["rows"], job["seq"])
        g = first_grads(model, p0, b, job["n_micro"])
        want = torch.load(job["grads"], mmap=True)
        run["grad_kinds"] = {k: (d / u) ** 0.5 for k, (d, u) in kind_dists(
            g, want, sh.index(meta, torch.distributed.get_rank())).items()}
        del g, want
    del single, p0
    # the leaves that carry most of the distance, each with its own ratio
    run["worst"] = [(k, d, (d / u) ** 0.5 if u else float("inf"))
                    for k, d, u in sorted(by_leaf, key=lambda t: -t[1])[:3]]
    run.update(sq=sq, upd=upd, whole={"/".join(map(str, p)): digest(t) for (p, t), m in
                                      zip(flatten(state["params"]), leaves(meta))
                                      if tuple(t.shape) == tuple(m.shape)})
    run["held"] = sum(t.numel() for t in leaves(state["params"]))
    run["profile"] = None
    if job["profile"]:
        step = make_train_step(model, make_optimizer(cfg.optimizer), lambda s: train_lr(cfg),
                               n_microbatches=job["n_micro"], grad_shardings=shard, mesh=mesh)
        b = dp_batch(cfg, job["seed"], job["steps"], dev, job["rows"], job["seq"])
        D.all_reduce_(torch.zeros(1, device=dev))   # start together
        run["profile"] = tp_profile(lambda: step(state, b), 1)
    if job.get("ckpt"):
        run["ckpt"] = ckpt_rank(cfg, mesh, shard, state, job, dev)
    if job.get("account_after"):
        # 17d: one more step, routed by its own router, under the account
        step = make_train_step(model, make_optimizer(cfg.optimizer), lambda s: train_lr(cfg),
                               n_microbatches=job["n_micro"], grad_shardings=shard, mesh=mesh)
        b = dp_batch(cfg, job["seed"], job["steps"], dev, job["rows"], job["seq"])
        torch.cuda.synchronize()
        D.all_reduce_(torch.zeros(1, device=dev))   # start together
        torch.cuda.reset_peak_memory_stats()
        _, run["account"] = accounted_step(lambda: step(state, b), dev, state, b, shard)
    del state
    D.all_reduce_(torch.zeros(1, device=dev))   # every rank done before any frees the group
    return run


def ckpt_rank(cfg, mesh, shard, state, job, dev):
    """17c on one rank: the train state saved by the Checkpointer from every
    rank (rank 0 writes) into `job["ckpt"]`, then restored into a fresh
    state of this rank's blocks, both by the train state's shardings
    (dp_shardings: ZeRO-1's blocks, as `shard`'s): the digests of its
    blocks saved and restored, and the save's and the restore's seconds."""
    import torch
    from repro_torch import distributed as D
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import train_state
    _, full = dp_shardings(cfg, mesh)
    rank = torch.distributed.get_rank()
    out = {"saved": block_digests(state, full, rank)}
    D.all_reduce_(torch.zeros(1, device=dev))   # start together
    t0 = time.perf_counter()
    Checkpointer(job["ckpt"]).save(job["steps"], state, blocking=True, shardings=full)
    out["save_s"] = time.perf_counter() - t0
    model = build_model(cfg, device=dev, mesh=mesh)
    like = train_state(model.init_params(torch.Generator(device=dev).manual_seed(0)),
                       make_optimizer(cfg.optimizer), shard, model.split)
    D.all_reduce_(torch.zeros(1, device=dev))
    t0 = time.perf_counter()
    Checkpointer(job["ckpt"]).restore(like, step=job["steps"], shardings=full)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["restored"] = block_digests(like, full, rank)
    del like
    torch.cuda.empty_cache()
    return out


def reset_dp_calls():
    """Zero the FSDP, EP and TP collectives' counters."""
    from repro_torch.models import data_parallel, tensor_parallel
    for calls in (data_parallel.calls, tensor_parallel.calls):
        for name in calls:
            calls[name] = 0


def dp_calls(steps) -> dict:
    """The FSDP and EP collectives run since reset_dp_calls, a step."""
    from repro_torch.models import data_parallel
    return {name: n / steps for name, n in data_parallel.calls.items()}


def tp_calls(steps=1) -> dict:
    """The TP collectives (`tensor_parallel.calls`, by span name) run since
    reset_dp_calls, a step."""
    from repro_torch.models import tensor_parallel
    return {name: n / steps for name, n in tensor_parallel.calls.items()}


def tp_train_job_rank(rank, world, dev, jobs):
    """Each of `jobs` on this rank, in order (one job on the ranks for the runs
    of one world size): a training run, or with "serve" a serving run (True: phase
    15c's; "tp": phase 16's), each with its wall time ("job_s")."""
    import torch
    out = {}
    for name, job in jobs.items():
        body = {True: dp_serve_rank, "tp": tp_family_serve_rank}.get(job.get("serve"),
                                                                    tp_train_rank)
        t0 = time.perf_counter()
        out[name] = body(rank, world, dev, job)
        out[name]["job_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def tp_train_configs():
    """14a-14c's configs at published width, cut in depth: name -> (config,
    mesh shape, ZeRO-2, steps, a profiled step). Each takes 2 steps (14a
    and 14b took 3 before phase 16 needed the time), 14c no profile: on one
    card each of its ZeRO-2 steps moves the fp32 gradients through the
    host, 17.4 s a step (NVIDIA H100 80GB HBM3, 700 W)."""
    from repro_torch.configs import get_config
    llama, phi = get_config("llama3-8b"), get_config("phi3.5-moe-42b-a6.6b")
    return {"14a": (llama.replace(n_layers=4), (1, 4), False, 2, True),
            "14b": (phi.replace(n_layers=2), (1, 2), False, 2, True),
            "14c": (llama.replace(n_layers=2), (2, 2), True, 2, False)}


def tp_train_phase(seed, dev, smi, gen, n_micro=2, rows=4, seq=1024) -> dict:
    """Phase 14: tensor-parallel training on the cards present (ranks as in
    phase 13): 14a llama3-8b at published width, 4 of 32 layers, on (1, 4);
    14b phi3.5-moe x 2 of 32 on (1, 2); 14c llama3-8b x 2 on (2, 2) with
    ZeRO-2 over the data axis (train_ranks); 14d: the kernels at a rank's
    training shapes."""
    out = train_ranks(tp_train_configs(), seed, dev, smi, n_micro, rows, seq)
    say("phase 14d: the kernels at a rank's training shapes")
    out["kernels"] = tp_train_kernel_phase(gen, dev)
    return out


def train_ranks(configs, seed, dev, smi, n_micro, rows, seq, extra=None, span_want=None,
                account=(), tp_span_want=None, floor=(), ckpt=None, account_after=()) -> dict:
    """Each of `configs` (name -> (config, mesh shape, ZeRO-2, steps, a
    profiled step[, its own seq[, its own rows[, options]]])) trained by steps of its
    optimizer at its `train_lr` of rows x seq TokenPipeline tokens (whisper's with its stub frames, dp_batch) in
    `n_micro` microbatches (phase 8b's batch), first
    in this process, then on the ranks from the same seed (one job a
    world size, on_ranks; an MoE run's ranks replaying its routing, `routed_as`:
    bf16 rounding flips near-tie router choices, and a flip moves an
    expert's update outright; the single process dispatches the data
    ranks' groups, as many as the mesh's data axis). Gates: losses and grad
    norms within DP_METRIC_TOL, each rank's blocks within DP_UPDATE_TOL of
    their update, the leaves no rank splits bit-identical on every rank,
    the launches exact (forward and remat), all on `flash_wgmma` with the
    lse, `gmm_wgmma` and the SSD scan's tensor-core path; with `span_want`
    (name -> {span: count a step}) the FSDP and EP collectives a step
    (`data_parallel.calls`, the spans' names), with `tp_span_want` the TP
    collectives a step (`tensor_parallel.calls`). For the runs named in
    `floor` the single process trains a second time on the kernels' plain
    versions (plain_kernels), with the option "reverse_heads" also with its
    mLSTM heads in reverse order (dp_run's `reverse_heads`: the xLSTM
    launches no kernel): the distance between its two runs over the update
    is the rounding floor of the config (a change of the order of sums
    alone), and the ranks' blocks are gated at NOISE_FACTOR times it where
    that exceeds DP_UPDATE_TOL; the two runs' losses and grad norms are
    printed. The option "norm_tol" gives a run's grad norms a tolerance a
    step in place of DP_METRIC_TOL; with "grad_blocks" each rank's blocks
    of the first step's gradient (first_grads) are held, by leaf kind, to
    the single process's within GRAD_KIND_TOL (relative L2), where the
    floor run's sit under 1 / NOISE_FACTOR of it. Prints each rank's step time and peak memory beside the single
    process's and a profiled step's spans.
    `extra` (name -> job) runs in the same job (phase 15c's serving);
    the runs named in `account` also measure the dry-run's account of their
    last step on the card (phase 12d), those in `account_after` of one more
    step that routes by its own router (17d); `ckpt` (name -> directory)
    saves and restores a run's final state on its ranks (17c, ckpt_rank).
    Returns the ranks' launches summed, each run's times, memory, accounts
    and checkpoint results, and the extra jobs' results."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import distributed as D
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    runs = {name: (cfg, shape, zero, seed + i, steps, prof, *rest, *(seq, rows, {})[len(rest):])
            for i, (name, (cfg, shape, zero, steps, prof, *rest)) in enumerate(configs.items())}
    out, by_world, singles = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (cfg, shape, zero, s, steps, prof, sq, rw, opts) in runs.items():
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            routing = []
            with routed_as(routing, replay=False):
                state, single = dp_run(cfg, s, dev, steps, n_micro, rw, sq,
                                       n_groups=shape[0] if cfg.family == "moe" else 1)
            single["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            path = f"{tmp}/{name}.pt"
            torch.save(tree_map(lambda t: t.cpu(), state["params"]), path)
            del state
            dp_launch_gate(f"{name} single process", single, cfg, n_micro, steps)
            rev = opts.get("reverse_heads", False)
            if name in floor:   # an MoE run routes as the kernel run did
                with plain_kernels(), routed_as(routing, replay=True):
                    other, orun = dp_run(cfg, s, dev, steps, n_micro, rw, sq,
                                         n_groups=shape[0] if cfg.family == "moe" else 1,
                                         reverse_heads=rev)
                apart = [max(abs(a - b) / abs(b) for a, b in zip(pair, (single["losses"][i],
                                                                       single["norms"][i])))
                         for i, pair in enumerate(zip(orun["losses"], orun["norms"]))]
                mine = torch.load(path, mmap=True)
                p0 = build_model(cfg, device=dev).init_params(
                    torch.Generator(device=dev).manual_seed(s))
                single["floor"] = (sq_dist(other["params"], mine)
                                   / sq_dist(p0, mine)) ** 0.5
                say(f"  {name} rounding floor: the single process "
                    + ("with its mLSTM heads in reverse order" if rev else
                       "on the plain kernels") + f" against it, {single['floor']:.3e} of the "
                    "update; its losses and grad norms "
                    + ", ".join(f"{m:.3e}" for m in apart) + " apart a step")
                del other, mine, p0
            grads = None
            if opts.get("grad_blocks"):
                grads = f"{tmp}/{name}.grads.pt"
                single["grad_floor"] = single_grads(cfg, s, dev, n_micro, rw, sq, rev, grads)
                big = max(single["grad_floor"].values())
                ok = NOISE_FACTOR * big <= GRAD_KIND_TOL
                say(f"  {'ok  ' if ok else 'FAIL'} {name} first step's gradient, the floor run's "
                    f"against it (rel L2; gate: {NOISE_FACTOR:g} x the largest <= "
                    f"{GRAD_KIND_TOL:g}): " + ", ".join(
                        f"{k} {v:.2e}" for k, v in single["grad_floor"].items()))
                if not ok:
                    fail(f"{name}: the order of sums alone moves the first gradient too far "
                         "for its gate to hold the ranks")
            say(f"  {name} single process{' and its floor' if name in floor else ''}: "
                f"{time.perf_counter() - t0:.1f} s")
            singles[name] = single
            by_world.setdefault(shape[0] * shape[1], {})[name] = dict(
                cfg=cfg, shape=shape, zero=zero, seed=s, steps=steps, n_micro=n_micro,
                rows=rw, seq=sq, single=path, routing=[c.cpu().numpy() for c in routing],
                profile=prof, account=name in account, account_after=name in account_after,
                ckpt=(ckpt or {}).get(name), grads=grads)
        for name, job in (extra or {}).items():
            world = job["shape"][0] * job["shape"][1]
            by_world.setdefault(world, {})[name] = job
        torch.cuda.empty_cache()
        ranks = {}
        for world, jobs in by_world.items():
            say(f"  ranks: W={world}, backend {D.backend_for(world, dev)}, devices "
                f"{[str(D.rank_device(r, dev)) for r in range(world)]}, card {smi}")
            t0 = time.perf_counter()
            res = on_ranks(tp_train_job_rank, world, dev, jobs)
            say(f"  {world} ranks ({', '.join(jobs)}): {time.perf_counter() - t0:.1f} s wall; "
                "rank 0's jobs " + ", ".join(f"{n} {res[0][n]['job_s']:.1f} s" for n in jobs))
            for name in jobs:
                ranks[name] = [r[name] for r in res]
    for name, (cfg, shape, zero, _, steps, _, sq, rw, opts) in runs.items():
        single, rs = singles[name], ranks[name]
        tokens = rw * sq
        say(f"phase {name}: {cfg.name} x {cfg.n_layers} layers at published width on a {shape} "
            f"mesh{', ZeRO-2 over the data axis' if zero else ''}, {steps} steps of {rw} x {sq} "
            f"tokens in {n_micro} microbatches, over {rs[0]['transport']}")
        t_single = float(np.median(single["walls"][1:]))
        say(f"  single process: median step {t_single * 1e3:.1f} ms, {tokens / t_single:.0f} "
            f"tokens/s, peak {single['peak_gb']:.2f} GB [{smi}]")
        for rank, r in enumerate(rs):
            t = float(np.median(r["walls"][1:]))
            p = r["profile"]
            say(f"  rank {rank}: median step {t * 1e3:.1f} ms ({t / t_single:.2f}x the single "
                f"process), peak {r['peak_gb']:.2f} GB ({r['peak_gb'] / single['peak_gb']:.2f}x),"
                f" {r['held'] / 1e9:.3f} B params held"
                + ("" if p is None else f"; profiled step {p['step_ms']:.1f} ms: " + ", ".join(
                    f"{n} {p[n + '_count']:.0f} spans {p[n + '_ms']:.1f} ms"
                    for n in TP_SPANS + DP_SPANS if p[n + "_count"])
                    + f", NCCL kernels {p['nccl_ms']:.2f} ms, copies {p['copy_ms']:.1f} ms, "
                    f"device busy {p['busy'] * 100:.1f}% (kernels and copies summed)"))
            if "grad_floor" in single:
                worst = max(r["grad_kinds"], key=r["grad_kinds"].get)
                ok = r["grad_kinds"][worst] <= GRAD_KIND_TOL
                say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: its blocks of the first gradient "
                    f"by leaf kind from the single process's (rel L2; gate <= {GRAD_KIND_TOL:g}): "
                    + ", ".join(f"{k} {v:.2e}" for k, v in r["grad_kinds"].items()))
                if not ok:
                    fail(f"{name}: rank {rank}'s {worst} gradient parts from the single "
                         "process's")
            norm_tol = opts.get("norm_tol", (DP_METRIC_TOL,) * steps)
            for i in range(steps):
                rel_gate(f"{name} rank {rank} step {i + 1} loss", r["losses"][i],
                         single["losses"][i], DP_METRIC_TOL)
                rel_gate(f"{name} rank {rank} step {i + 1} grad norm", r["norms"][i],
                         single["norms"][i], norm_tol[i])
            d = (r["sq"] / r["upd"]) ** 0.5
            tol = max(DP_UPDATE_TOL, NOISE_FACTOR * single.get("floor", 0.0))
            ok = d <= tol
            say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: its blocks' distance to the single "
                f"process's, over their update, {d:.3e} (gate <= {tol:.4g}; update "
                f"{r['upd'] ** 0.5:.3f}); most of it in " + ", ".join(
                    f"{k} ({sq / r['sq'] * 100:.0f}%, {ratio:.3f} of its update)"
                    for k, sq, ratio in r["worst"]))
            if not ok:
                fail(f"{name}: rank {rank}'s params part from the single process's")
            dp_launch_gate(f"{name} rank {rank}", r, cfg, n_micro, steps)
            if span_want and name in span_want:
                got = r["dp_calls"]
                ok = got == span_want[name]
                say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: FSDP and EP spans a step {got}, "
                    f"from the code {span_want[name]}")
                if not ok:
                    fail(f"{name}: rank {rank}'s collectives a step are not the code's")
            if tp_span_want and name in tp_span_want:
                got = r["tp_calls"]
                ok = got == tp_span_want[name]
                say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: TP spans a step {got}, from the "
                    f"code {tp_span_want[name]}")
                if not ok:
                    fail(f"{name}: rank {rank}'s TP collectives a step are not the code's")
        same = all(r["whole"] == rs[0]["whole"] for r in rs)
        say(f"  {'ok  ' if same else 'FAIL'} the {len(rs[0]['whole'])} leaves no rank splits are "
            "bit-identical on every rank")
        if not same:
            fail(f"{name}: a replicated leaf differs across the ranks")
        out[name] = dict(single_step_ms=t_single * 1e3, single_peak_gb=single["peak_gb"],
                         floor=single.get("floor"),
                         update_ratio=[(r["sq"] / r["upd"]) ** 0.5 for r in rs],
                         step_ms=[float(np.median(r["walls"][1:])) * 1e3 for r in rs],
                         peak_gb=[r["peak_gb"] for r in rs], profile=[r["profile"] for r in rs],
                         account=rs[0]["account"], walls=[r["walls"] for r in rs],
                         tp_calls=rs[0]["tp_calls"], ckpt=[r.get("ckpt") for r in rs])
    train_runs = [r for name in runs for r in ranks[name]]
    out.update({n: sum(r["launches"][n] for r in train_runs) for n in kernel_counts()})
    out["lse"] = sum(r["lse"] for r in train_runs)
    out["flash_attention_by_path"] = {p: sum(r["flash_by_path"][p] for r in train_runs)
                                      for p in ("wgmma", "simt")}
    out["ssm_scan_by_path"] = {p: sum(r["ssd_by_path"][p] for r in train_runs)
                               for p in ("mma", "simt")}
    out["moe_gmm_by_path"] = {kind: {p: sum(r["gmm_by_path"][kind][p] for r in train_runs)
                                     for p in ("wgmma", "rows", "tiled")}
                              for kind in ("fwd", "dx", "dw")}
    out["extra"] = {name: ranks[name] for name in (extra or {})}
    return out


# ----------------------------------------------------------------------------
# phase 15: FSDP and expert parallelism over the data axis
# ----------------------------------------------------------------------------

# the mesh of phase 15: FSDP and the experts over "data", TP over "model"
DP_TP_SHAPE = (2, 2)
# 15d: moe_gmm at an EP x TP rank's training shapes, (label, E, C, K, N):
# phi3.5-moe's 16 experts over 2 data ranks, d_ff 6400 over 2 model ranks,
# each expert's slots of both data ranks' groups (2 x 160 at 1024 tokens)
DP_GMM_SHAPES = (("phi3.5-moe EP 2 x TP 2, w1/w3 at training capacity", 8, 320, 4096, 3200),
                 ("phi3.5-moe EP 2 x TP 2, w2 (K = 3200)", 8, 320, 3200, 4096))
DP_GMM_DIMS = ((4096, 3200), (3200, 4096))
# 15d: flash with the lse at qwen1.5-32b's TP 2 training heads (48 padded
# heads over 2; one row of 1024 a microbatch and data rank)
DP_FLASH_SHAPES = (("qwen1.5-32b TP 2 train", 1, 1024, 24, 24, 128),)
# 12d: the dry-run's meta account of 15b's rank, computed beside phases 3-11
DP_ACCOUNT_FILE = ROOT / "build" / "dryrun" / "chip_smoke" / "qwen-2x2-account.json"


def dp_train_configs():
    """15a's and 15b's configs at published width, cut in depth, each on
    (2, 2) with ZeRO-2, 2 steps (3 before phase 16 needed the time) and no
    profiled step (the collectives are counted, `data_parallel.calls`):
    15a phi3.5-moe x 2 of
    32 layers (EP over "data", expert-TP over "model"); 15b qwen1.5-32b x 2
    of 64 (FSDP over "data", TP over "model"): 1.05 B params in the two
    layers and 1.56 B in the untied embeddings, 42 GB at 16 bytes a param
    in the single process."""
    from repro_torch.configs import get_config
    phi, qwen = get_config("phi3.5-moe-42b-a6.6b"), get_config("qwen1.5-32b")
    return {"15a": (phi.replace(n_layers=2), DP_TP_SHAPE, True, 2, False),
            "15b": (qwen.replace(n_layers=2), DP_TP_SHAPE, True, 2, False)}


def fsdp_leaves(cfg) -> int:
    """The leaves of a layer that `cfg` cuts over "data" and gathers before
    use (models/data_parallel.py): with cfg.fsdp, the attention's four
    projections and the dense FFN's (or arctic's dense residual's) three;
    none otherwise. The experts are cut and not gathered (EP)."""
    if not cfg.fsdp:
        return 0
    return 4 + (3 if cfg.family != "moe" or cfg.moe.dense_residual_ff else 0)


def dp_spans(cfg, layers, micro=None, ep=False) -> dict:
    """The FSDP and EP collectives a step runs, from the code: a train step
    of `micro` microbatches, or (micro None) one decode step. A pass
    gathers the embeddings twice (the lookup's table, the logits'), and
    each layer's FSDP leaves once; the remat replay gathers a layer's again
    and runs its experts' all-to-all both ways again (its gathers come
    first, and the combine reads the way back's output); the backward
    reduce-scatters each gather's gradient once and runs each all-to-all's
    reverse once. The embeddings gather only with cfg.fsdp."""
    g = fsdp_leaves(cfg)
    emb = 2 if cfg.fsdp else 0
    a2a = 2 * layers if ep else 0
    if micro is None:
        return {"dp_all_gather": emb + layers * g, "dp_reduce_scatter": 0,
                "ep_all_to_all": a2a}
    return {"dp_all_gather": micro * (emb + 2 * layers * g),
            "dp_reduce_scatter": micro * (emb + layers * g), "ep_all_to_all": micro * 3 * a2a}


def dp_serve_rank(rank, world, dev, job):
    """15c on one rank of the (2, 2) mesh: the model drawn from the seed with
    FSDP and EP (init_params keeps the rank's blocks), the digests of its
    blocks and its param bytes; then its data rank's share of the prompts
    prefilled and `job["tokens"]` decode steps through the model interface,
    timed, with its kernel launches by kernel, the FSDP and EP collectives
    a decode step (`data_parallel.calls`), its routing on the prefill and
    the first step, and the logits of those two (the gate's)."""
    import torch
    from repro_torch import distributed as D
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.tree import flatten
    _rank_setup()
    cfg, dev = job["cfg"], torch.device(dev)
    mesh = make_mesh(job["shape"], ("data", "model"), device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, mesh=mesh)
    params = model.init_params(torch.Generator(device=dev).manual_seed(job["seed"]))
    out = {"transport": D.transport(dev),
           "digests": {"/".join(map(str, p)): digest(t) for p, t in flatten(params)},
           "param_bytes": sum(t.numel() * t.element_size() for _, t in flatten(params))}
    d = rank // job["shape"][1]
    B = len(job["prompts"]) // job["shape"][0]
    prompts = torch.tensor(job["prompts"][d * B:(d + 1) * B], dtype=torch.int32, device=dev)
    T, steps = prompts.shape[1], job["tokens"]
    timings = {"prefill": [], "decode": []}
    tm = timed_model(model, timings)
    routes, logits = [], []

    def step():
        i = len(logits)
        batch = {"tokens": torch.tensor(steps[i][d * B:(d + 1) * B], dtype=torch.int32,
                                        device=dev)[:, None],
                 "positions": torch.full((B,), T + i, dtype=torch.int32, device=dev)}
        logits.append(tm.decode_step(params, cache, batch)[0])
    with torch.inference_mode():
        reset_counts()
        with record_routing(routes):
            lp, pc = tm.prefill(params, {"tokens": prompts})
            cache = model.init_cache(B, T + len(steps))
            for name in cache:
                cache[name][:, :, :T] = pc[name]
            del pc
            reset_dp_calls()
            step()
        while len(logits) < len(steps):
            step()
        torch.cuda.synchronize()
    out["dp_calls"] = dp_calls(len(steps))
    out.update(gate=(lp.float().cpu().numpy(), logits[0].float().cpu().numpy()),
               outputs=torch.stack([lg[:, -1].argmax(-1) for lg in logits], 1).tolist(),
               prefills=1, steps=len(logits), launches=kernel_counts(),
               by_path={"flash_attention": dict(fk.launches_by_path),
                        "decode_attention": dict(dk.launches_by_path),
                        "moe_gmm": dict(gk.launches_by_path)},
               timings=timings,
               routing=[t.cpu().numpy() for t in routes],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del cache, logits, params
    if rank == 0:
        say(f"  [rank 0] {cfg.name} served on {job['shape']}: prefill {spread(timings['prefill'])}"
            f", decode {spread(timings['decode'])}, peak {out['peak_gb']:.2f} GB")
    D.all_reduce_(torch.zeros(1, device=dev))   # every rank done before any frees the group
    return out


def dp_serve_references(cfg, seed, prompts, tokens, dev, groups):
    """15c's single-process side, run in this process before the ranks: the
    whole model drawn from `seed`, the digests and bytes of each rank's
    block of every leaf on the (2, 2) mesh, and the gate's logits (the
    batched prefill of `prompts`, one decode step with `tokens`) on the
    plain path in bf16 and in fp32, dispatching the data ranks' `groups`,
    each with its MoE routing."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model, dense
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.sharding.rules import model_shardings
    from repro_torch.tree import flatten
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    mesh = Mesh(DP_TP_SHAPE, ("data", "model"))
    sh = model_shardings(params, cfg, mesh, single_pod_rules())
    out = {"digests": [], "bytes": [], "routing": {"plain": [], "exact": []}}
    for r in range(mesh.size):
        blocks = [(p, t[b]) for (p, t), b in zip(flatten(params), sh.index(params, r))]
        out["digests"].append({"/".join(map(str, p)): digest(t) for p, t in blocks})
        out["bytes"].append(sum(t.numel() * t.element_size() for _, t in blocks))

    def run(p, c):
        return gate_logits(lambda b: dense.lm_prefill(p, b, c, n_groups=groups),
                           lambda cache, b: dense.lm_decode_step(p, cache, b, c,
                                                                 n_groups=groups),
                           lambda B, S: dense.init_cache(c, B, S, device=dev),
                           prompts, len(prompts[0]) + 1, tokens, dev, True)
    with torch.inference_mode(), plain_kernels():
        with record_routing(out["routing"]["plain"]):
            out["plain"] = run(params, cfg)
        out["single_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        params = _to_f32(params)
        with record_routing(out["routing"]["exact"]):
            out["exact"] = run(params, cfg.replace(param_dtype="float32"))
        del params
    out["routing"] = {k: [t.cpu() for t in v] for k, v in out["routing"].items()}
    torch.cuda.empty_cache()
    return out


def dp_serve_gate(label, cfg, refs, ranks, smi):
    """15c's gates on one model's ranks: each rank's blocks' digests equal
    this process's blocks of the whole draw, its param bytes their sum; its
    launches exact and all on the tensor-core or split kernel; the FSDP and
    EP spans of a decode step the code's (dp_spans); the ranks of a data
    coordinate alike (outputs, gate logits); the data ranks' gate logits,
    put together, held to this process's plain path in bf16 and fp32 by
    logits_gate (an MoE model on the sequences routed alike, with the
    routing agreement)."""
    import numpy as np
    import torch
    tp = DP_TP_SHAPE[1]
    want_spans = dp_spans(cfg, cfg.n_layers, ep=cfg.family == "moe")
    for rank, r in enumerate(ranks):
        same = r["digests"] == refs["digests"][rank]
        ok = same and r["param_bytes"] == refs["bytes"][rank]
        say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: {len(r['digests'])} leaves, their blocks' "
            f"digests equal this process's blocks of the whole draw: {same}; param bytes "
            f"{r['param_bytes']} = sum of its blocks {refs['bytes'][rank]}; peak "
            f"{r['peak_gb']:.2f} GB, single process {refs['single_peak_gb']:.2f} GB")
        if not ok:
            fail(f"{label}: rank {rank}'s weights are not its blocks of the seed's draw")
        tp_launch_gate(f"{label} rank {rank}", r, cfg)
        got = r["dp_calls"]
        ok = got == want_spans
        say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: FSDP and EP collectives a decode step "
            f"{got}, from the code {want_spans}")
        if not ok:
            fail(f"{label}: rank {rank}'s collectives a step are not the code's")
        twin = ranks[rank - rank % tp]
        if r["outputs"] != twin["outputs"] or not all(
                np.array_equal(a, b) for a, b in zip(r["gate"], twin["gate"])):
            fail(f"{label}: the ranks of data coordinate {rank // tp} differ")
    r0 = ranks[0]
    pre, dec = r0["timings"]["prefill"], r0["timings"]["decode"]
    say(f"  ok   the ranks of each data coordinate alike; rank 0: prefill {spread(pre)} per "
        f"batch of {len(r0['outputs'])}, decode {spread(dec)} per step [{smi}]")
    heads = [ranks[d * tp] for d in range(DP_TP_SHAPE[0])]
    alike = [None, None]
    if cfg.family == "moe":
        n_data, L = DP_TP_SHAPE[0], cfg.n_layers
        plain = refs["routing"]["plain"]
        kern = [[torch.from_numpy(a) for a in r["routing"]] for r in heads]
        share = sum(routing_agreement(k, plain[d::n_data]) * sum(a.numel() for a in k)
                    for d, k in enumerate(kern)) / sum(a.numel() for k in kern for a in k)
        say(f"  routing of the gate's prefill and decode step: {share * 100:.2f}% of the (token, "
            f"k) choices alike on the kernel path and the plain path (gate >= "
            f"{MOE_ROUTING_AGREEMENT * 100:g}%)")
        if not share >= MOE_ROUTING_AGREEMENT:
            fail(f"{label}: the kernel path routed tokens unlike the plain path")
        for i, part in enumerate((slice(0, L), slice(L, 2 * L))):
            alike[i] = torch.cat([routed_alike(k[part], plain[d::n_data][part],
                                               len(heads[d]["outputs"]))
                                  for d, k in enumerate(kern)])
    compared = total = 0
    for i, name in enumerate((f"prefill logits (B={sum(len(h['outputs']) for h in heads)})",
                              "decode-step logits")):
        kern = torch.cat([torch.from_numpy(h["gate"][i]) for h in heads])
        compared += logits_gate(name, kern, refs["plain"][i], refs["exact"][i],
                                cfg.vocab_size, alike[i])
        total += kern.shape[0]
    if cfg.family == "moe" and not 2 * compared >= total:
        fail(f"{label}: fewer than half the sequences were routed alike")


def dp_account_gate(card, smi, label="12d", path=DP_ACCOUNT_FILE):
    """12d: the dry-run's meta account of 15b's rank 0 (qwen1.5-32b x 2 on an
    abstract (2, 2) mesh over the fake process group, computed beside
    phases 3-11 into DP_ACCOUNT_FILE) against the account of 15b's last step
    on the card, rank 0's (the host-staged collectives counted as the
    card's own): FLOPs, bytes, collectives (count, operand and wire bytes
    by kind), kernel ops and the high-water mark equal, the ZeRO-2
    accumulator's bytes equal, the allocator's peak within
    ACCOUNT_PEAK_RATIO of the account's. 17d the same of 17a's extra step
    against the account at `path`."""
    if not path.exists():
        fail(f"{label}: no meta account at {path}")
    meta = json.loads(path.read_text())
    coll = {k: [float(x) for x in v] for k, v in card["collectives"].items()}
    same = {"flops": meta["flops"] == card["flops"], "bytes": meta["bytes"] == card["bytes"],
            "collectives": meta["collectives"] == coll,
            "kernel ops": meta["kernels"] == card["kernels"],
            "high-water": meta["peak_bytes"] == card["peak_bytes"],
            "accumulator": meta["accum_bytes"] == card["accum_bytes"]}
    ratio = card["allocator_peak_bytes"] / card["peak_bytes"]
    ok = all(same.values()) and ACCOUNT_PEAK_RATIO[0] <= ratio <= ACCOUNT_PEAK_RATIO[1]
    say(f"  {'ok  ' if ok else 'FAIL'} [{smi}] meta {meta['flops'] / 1e12:.4f} TFLOP "
        f"{meta['bytes'] / 1e9:.4f} GB, card {card['flops'] / 1e12:.4f} TFLOP "
        f"{card['bytes'] / 1e9:.4f} GB; collectives meta {meta['collectives']}, card {coll}; "
        f"kernel ops {card['kernels']}; high-water meta {meta['peak_bytes'] / 1e9:.3f} GB, "
        f"card {card['peak_bytes'] / 1e9:.3f} GB, allocator "
        f"{card['allocator_peak_bytes'] / 1e9:.3f} GB (ratio {ratio:.3f}, gate "
        f"{ACCOUNT_PEAK_RATIO}); accumulator {card['accum_bytes']} bytes; equal: {same}")
    if not ok:
        fail(f"{label}: the dry-run's (2, 2) account and the rank on the card disagree")
    return dict(meta=meta, card=card, ratio=ratio)


def meta_account_main(path, rows=4, seq=1024, run="15b"):
    """Write the dry-run's meta account of `run`'s rank 0 to `path` (JSON):
    the train step of its config (15b: qwen1.5-32b x 2; 17a: phi3.5-moe x 2
    with Adafactor) on rank 0 of an abstract (2, 2) mesh, rows x seq tokens
    in 2 microbatches, ZeRO-2 over "data", at its learning rate
    (`train_lr`, held constant: the account of its last step)."""
    import torch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import make_batch
    cfg = {**dp_train_configs(), **adafactor_train_configs()}[run][0]
    batch = make_batch(cfg, ShapeConfig("train", "train", seq, rows), device="meta",
                       generator=torch.Generator().manual_seed(0))
    with dryrun.fake_mesh(dryrun.Mesh(DP_TP_SHAPE, ("data", "model"))) as mesh:
        acct, _ = dryrun.train_account(cfg, batch, n_micro=2, device="meta", mesh=mesh,
                                       lr_fn=lambda s: train_lr(cfg))
    c = acct.cost
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(dict(
        flops=c.totals.flops, bytes=c.totals.bytes, collectives=c.totals.collectives,
        kernels=dict(c.kernels), peak_bytes=c.peak_bytes, accum_bytes=acct.accum_bytes)))


def dp_phase(seed, dev, smi, gen, n_micro=2, rows=4, seq=1024) -> dict:
    """Phases 15 and 17, in one job on four ranks of a (2, 2) mesh on the
    cards present (ranks as in phase 13), at published width. Phase 15, FSDP
    and expert parallelism over the data axis: 15a phi3.5-moe x 2 (EP,
    expert-TP, ZeRO-2) and 15b qwen1.5-32b x 2 (FSDP, TP, ZeRO-2) trained as
    phase 14 trains (train_ranks), the all-gathers, reduce-scatters and
    all-to-alls of a step held to the code's count (dp_spans); 15c decode on
    (2, 2), phi3.5-moe x 2 (FSDP and EP, as the reference serves it) and
    qwen1.5-32b x 2 (FSDP, its int8 cache): 4 prompts of 512 tokens, each
    data rank two, then 8 decode steps (dp_serve_gate); 12d the dry-run's
    (2, 2) account of 15b's rank held to the card's (its last step); 15d the
    kernels at a rank's shapes. Phase 17, Adafactor: 17a and 17b, 15a's and
    15b's runs with Adafactor (ZeRO-2 accumulators, a ZeRO-1 state), trained
    beside them, the ranks' blocks gated at DP_UPDATE_TOL of their update
    (twice their rounding floors is less: adafactor_train_configs);
    17c 17a's final state saved by the ranks and restored into one process
    and into the ranks (ckpt_gate); 17d the dry-run's (2, 2) account of
    17a's rank 0 on meta against one more step of that rank on the card.
    Returns the ranks' launches summed, 15d's rows and the gates' numbers."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.registry import serve_config
    af = adafactor_train_configs()
    configs = {**dp_train_configs(), **af}
    span_want = {name: dp_spans(cfg, cfg.n_layers, n_micro, ep=cfg.family == "moe")
                 for name, (cfg, *_rest) in configs.items()}
    serve, refs = {}, {}
    rng = np.random.default_rng(seed + 5)
    for i, arch in enumerate(("phi3.5-moe-42b-a6.6b", "qwen1.5-32b")):
        cfg = serve_config(get_config(arch)).replace(n_layers=2)
        prompts = tp_prompts(cfg, seed + 6 + i, 4, 512, 512)
        tokens = rng.integers(0, cfg.vocab_size, (8, len(prompts))).tolist()
        name = f"15c {arch}"
        t0 = time.perf_counter()
        refs[name] = dp_serve_references(cfg, seed + 6 + i, prompts, tokens[0], dev,
                                         DP_TP_SHAPE[0] if cfg.family == "moe" else 1)
        say(f"  15c single process, {arch} x 2: whole model and the gate's references in "
            f"{time.perf_counter() - t0:.1f} s")
        serve[name] = dict(serve=True, cfg=cfg, shape=DP_TP_SHAPE, seed=seed + 6 + i,
                           prompts=prompts, tokens=tokens)
    say("phase 15a-c, 17a-b: the single processes first, then one job on 4 ranks")
    with tempfile.TemporaryDirectory() as tmp:
        out = train_ranks(configs, seed, dev, smi, n_micro, rows, seq, extra=serve,
                          span_want=span_want, account=("15b",), ckpt={"17a": f"{tmp}/17c"},
                          account_after=("17a",))
        say("phase 17c: 17a's final state saved from the 4 ranks, restored into one process "
            "and into the ranks")
        cfg, _, _, steps, _ = af["17a"]
        out["17c"] = ckpt_gate("17c", cfg, out["17a"]["ckpt"], f"{tmp}/17c", steps, dev, smi)
    for name in configs:
        out[name].pop("ckpt")
    for name, job in serve.items():
        cfg = job["cfg"]
        say(f"phase {name}: x {cfg.n_layers} layers at published width on a {DP_TP_SHAPE} mesh, "
            f"FSDP{' and EP' if cfg.family == 'moe' else ''} over the data axis, "
            f"{cfg.kv_cache_dtype} cache, 4 x 512-token prompts, 8 decode steps")
        dp_serve_gate(name, cfg, refs[name], out["extra"][name], smi)
    served = [r for name in serve for r in out["extra"][name]]
    for n in kernel_counts():
        out[n] += sum(r["launches"][n] for r in served)
    for p in ("wgmma", "simt"):
        out["flash_attention_by_path"][p] += sum(r["by_path"]["flash_attention"][p]
                                                 for r in served)
    for p in ("wgmma", "rows", "tiled"):
        out["moe_gmm_by_path"]["fwd"][p] += sum(r["by_path"]["moe_gmm"][p] for r in served)
    out["decode_attention_by_path"] = {p: sum(r["by_path"]["decode_attention"][p]
                                              for r in served) for p in ("split", "simt")}
    out["serve"] = {name: dict(decode_ms=float(np.median(rs[0]["timings"]["decode"])) * 1e3,
                               prefill_ms=float(np.median(rs[0]["timings"]["prefill"])) * 1e3,
                               peak_gb=[r["peak_gb"] for r in rs],
                               single_peak_gb=refs[name]["single_peak_gb"])
                    for name, rs in out.pop("extra").items()}
    say("phase 12d: the dry-run's (2, 2) account of 15b's rank 0, on meta, against the card")
    out["12d"] = dp_account_gate(out["15b"]["account"], smi)
    say("phase 17d: the dry-run's (2, 2) account of 17a's rank 0, on meta, against the card")
    out["17d"] = dp_account_gate(out["17a"]["account"], smi, "17d", AF_ACCOUNT_FILE)
    say("phase 15d: the kernels at a rank's shapes")
    rnd = _rnd(gen, dev)
    out["kernels"] = tp_train_kernel_phase(gen, dev, DP_FLASH_SHAPES, 8, DP_GMM_DIMS)
    out["kernels"]["moe_gmm_fwd"] = gmm_rows(rnd, dev, DP_GMM_SHAPES)
    return out


# ----------------------------------------------------------------------------
# phase 16: tensor parallelism of the hybrid, whisper and the xLSTM over "model"
# ----------------------------------------------------------------------------

# the mesh of phase 16: four ranks over "model"
HYBRID_TP_SHAPE = (1, 4)
# 16d: the SSD scan at a TP 4 rank's 20 of zamba2's 80 heads, (label, B, H,
# T, P, N, chunk), fp32 as the model hands it over
HYBRID_TP_SSD_SHAPES = (("zamba2 TP 4 prefill, 20 of 80 heads", 4, 20, 1024, 64, 64, 256),)
# flash without and with the lse, and decode, at the shared block's 8 of 32
# heads a rank (head dim 80), on 16a's prefill and its cache of 1032 rows
HYBRID_TP_FLASH_SHAPES = (("zamba2 TP 4 prefill, 8 of 32 heads", 4, 1024, 8, 8, 80, None),)
HYBRID_TP_LSE_SHAPES = (("zamba2 TP 4, 8 of 32 heads", 4, 1024, 8, 8, 80),)
HYBRID_TP_DECODE_SHAPES = (("zamba2 TP 4, 8 of 32 cache heads, 4 x 1032 rows", 4, 8, 8, 1032, 80,
                            1032, False),)


def tp_spans(cfg, n, kind, micro=1) -> dict:
    """The TP collectives (`tensor_parallel.calls`, by span) that a rank of
    n runs for the hybrid or whisper, from the code: a prefill, a decode
    step, or a train step of `micro` microbatches. Every layer's wo and FFN
    products are partial sums (all-reduced once each), the vocabulary is
    split (the embedding's all-reduce; serving gathers the logits, the loss
    takes a max and a sum), and where a rank's q or k/v columns split heads
    they are gathered (q one, k/v two a call). A mamba2 block gathers w_zx's
    product and all-reduces the gated norm's statistic and w_out's product.
    A train step runs each layer's forward, its remat replay (all of it but
    the super-block's or layer's last all-reduce) and its backward (one
    all-reduce a mamba2 block of its entered tensors, one of the statistic;
    q/k/v's and the FFN's inputs, the cross q's; each gather's
    reduce-scatter), whisper's encoder output entering once, the unembed's
    input, and the global norm's all-reduce a step. The xLSTM (n dividing
    its d_in, not its GeGLU width): an mLSTM block gathers w_up's product
    and, where n does not divide the heads, q/k/v's columns (one gather),
    and all-reduces w_down's product and, where the heads split, the norm's
    statistic; an sLSTM block gathers its heads' h (or its gate product's
    columns) and the GeGLU's w_ff1 product where that splits; the remat
    replay is all of the forward's; backward one all-reduce a block's
    entered tensors (a GeGLU's apart), the statistic's, a reduce-scatter an
    mLSTM gather."""
    if cfg.family == "ssm":
        x, d = cfg.xlstm, cfg.d_model
        d_in, dp = int(x.mlstm_expand * d), int(x.slstm_proj_factor * d)
        if d_in % n or dp % n == 0 or cfg.padded_vocab % n:
            raise ValueError(f"tp_spans counts {cfg.name}'s splits on {n} ranks only where its "
                             "d_in and vocabulary split and its GeGLU's w_ff2 rows do not")
        nb = cfg.n_layers // x.slstm_every
        nm = nb * (x.slstm_every - 1)
        heads, ff = cfg.n_heads % n == 0, 2 * dp % n == 0
        fwd_ar, fwd_ag = nm * (1 + heads), nm * (2 - heads) + nb * (1 + ff)
        if kind != "train":
            return {"tp_all_reduce": fwd_ar + 1, "tp_all_gather": fwd_ag + 1,
                    "tp_reduce_scatter": 0}
        bwd_ar = nm * (1 + heads) + nb * (1 + ff) + 1
        return {"tp_all_reduce": micro * (2 * fwd_ar + 3 + bwd_ar) + 1,
                "tp_all_gather": 2 * micro * fwd_ag,
                "tp_reduce_scatter": micro * nm * (2 - heads)}
    hq, hkv, hd = cfg.eff_q_heads, cfg.eff_kv_heads, cfg.resolved_head_dim
    if cfg.d_ff % n or cfg.padded_vocab % n or hq * hd % n:
        raise ValueError(f"tp_spans counts {cfg.name}'s splits on {n} ranks only where its "
                         "d_ff, vocabulary and q columns split")
    gq = int(hq % n != 0)
    gkv = int(hkv % n != 0 and hkv * hd % n == 0)
    self_ag = gq + 2 * gkv
    if cfg.family == "hybrid":
        L, nb = cfg.n_layers, cfg.n_layers // cfg.hybrid.attn_every
        fwd_ar, fwd_ag = 2 * L + 2 * nb, L + nb * self_ag
        bwd_ar = 2 * L + 2 * nb
        replay_ar = fwd_ar - 1 * nb
    else:
        le, ld = cfg.encdec.n_enc_layers, cfg.n_layers
        cross_ag = gq + (2 * gkv if kind != "decode" else 0)
        fwd_ar = (2 * le if kind != "decode" else 0) + 3 * ld
        fwd_ag = (le * self_ag if kind != "decode" else 0) + ld * (self_ag + cross_ag)
        bwd_ar = 2 * le + 3 * ld + 1          # + the encoder output's entry
        replay_ar = fwd_ar - le - ld
    if kind != "train":
        return {"tp_all_reduce": fwd_ar + 1, "tp_all_gather": fwd_ag + 1,
                "tp_reduce_scatter": 0}
    per_micro = fwd_ar + replay_ar + bwd_ar + 4
    return {"tp_all_reduce": micro * per_micro + 1, "tp_all_gather": 2 * micro * fwd_ag,
            "tp_reduce_scatter": micro * fwd_ag}


# the recurrent states phase 16 gates on each rank's heads: name -> (what it
# is, its heads' dim as gate_states returns it)
GATED_STATES = {"ssm": ("SSM state after the prefill", 3),
                "m_C": ("last super-block's mLSTM C after the first decode step", 2),
                "s_c": ("sLSTM c after the first decode step", 2)}


def gate_states(cfg, cache) -> dict:
    """The states of `cache` that phase 16 gates (GATED_STATES), fp32 on the
    host: the hybrid's SSM state, read from a prefill's cache, and the
    xLSTM's, read after the first decode step (its prefill returns empty
    states, as the reference's)."""
    import torch
    names = {"hybrid": ("ssm",), "ssm": ("m_C", "s_c")}.get(cfg.family, ())
    return {k: (cache[k][-1] if k == "m_C" else cache[k]).to("cpu", torch.float32, copy=True)
            for k in names}


def serve_batch(cfg, seed, B, T, dev):
    """16a's, 16c's and 16e's prompts: B x T tokens from the seed (numpy) and, for
    whisper, B x ENC_LEN bf16 stub frames from a generator on the card
    seeded with it: every process draws the same."""
    import numpy as np
    import torch
    from repro_torch.models.whisper import ENC_LEN
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)), dtype=torch.int32,
                                    device=dev)}
    if cfg.family == "audio":
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch["enc_embeds"] = torch.randn((B, ENC_LEN, cfg.d_model), generator=gen,
                                          device=dev).to(torch.bfloat16)
    return batch


def tp_family_references(cfg, seed, n, B, T, tokens, dev):
    """16a's, 16c's and 16e's single-process side, run in this process before
    the ranks start: the whole model drawn from `seed`, the digests and
    bytes of each rank's block of every leaf on (1, n), and on the plain
    path in bf16 and in fp32 the prefill's logits, the first decode step's
    (`tokens`, one a sequence) and the recurrent states it gates
    (gate_states); the bf16 plain path's peak memory, the single
    process's."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import flatten
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    sh, _ = tp_blocks(cfg, n)
    out = {"digests": [], "bytes": []}
    for r in range(n):
        blocks = [(p, t[b]) for (p, t), b in zip(flatten(params), sh.index(params, r))]
        out["digests"].append({"/".join(map(str, p)): digest(t) for p, t in blocks})
        out["bytes"].append(sum(t.numel() * t.element_size() for _, t in blocks))
    batch = serve_batch(cfg, seed, B, T, dev)
    first = {"tokens": torch.tensor(tokens, dtype=torch.int32, device=dev)[:, None],
             "positions": torch.full((B,), T, dtype=torch.int32, device=dev)}

    def run(c, p):
        model = build_model(c, device=dev)
        lp, pc = model.prefill(p, batch)
        cache = model.init_cache(B, T + 1)
        fill_cache(cache, pc, T)
        states = gate_states(c, pc) if c.family == "hybrid" else None
        del pc
        ld, _ = model.decode_step(p, cache, first)
        return lp.float().cpu(), ld.float().cpu(), states or gate_states(c, cache)
    with torch.inference_mode(), plain_kernels():
        out["plain"] = run(cfg, params)
        out["single_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        params = _to_f32(params)
        out["exact"] = run(cfg.replace(param_dtype="float32"), params)
        del params
    torch.cuda.empty_cache()
    return out


def tp_family_serve_rank(rank, world, dev, job):
    """16a, 16c and 16e's serving on one rank of a (1, world) mesh: the model
    drawn from the seed (init_params keeps the rank's blocks), its blocks'
    digests and bytes; one batched prefill and `job["steps"]` decode steps
    through the model interface, timed, its kernel launches by kernel, the
    TP collectives of the prefill and of a decode step
    (`tensor_parallel.calls`), the states gate_states reads (the rank's
    heads), the gate's logits (the prefill's, the first step's); then a
    profiled window of decode steps."""
    import torch
    from repro_torch import distributed as D
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ssm_scan as sk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.tree import flatten
    _rank_setup()
    cfg, dev = job["cfg"], torch.device(dev)
    mesh = make_mesh(job["shape"], ("data", "model"), device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, mesh=mesh)
    params = model.init_params(torch.Generator(device=dev).manual_seed(job["seed"]))
    out = {"transport": D.transport(dev),
           "digests": {"/".join(map(str, p)): digest(t) for p, t in flatten(params)},
           "param_bytes": sum(t.numel() * t.element_size() for _, t in flatten(params)),
           "plan": {k: str(v) for k, v in vars(model.tp).items() if k != "group"}}
    batch = serve_batch(cfg, job["seed"], job["B"], job["T"], dev)
    B, T = batch["tokens"].shape
    tokens, n_steps = job["tokens"], job["steps"]
    timings = {"prefill": [], "decode": []}
    tm = timed_model(model, timings)
    first, outputs = [], []

    def step():
        i = len(outputs)
        b = {"tokens": torch.tensor(tokens[i], dtype=torch.int32, device=dev)[:, None],
             "positions": torch.full((B,), T + i, dtype=torch.int32, device=dev)}
        lg = tm.decode_step(params, cache, b)[0]
        if not first:
            first.append(lg.float().cpu().numpy())
        outputs.append(lg[:, -1].argmax(-1))
    with torch.inference_mode():
        reset_counts()
        reset_dp_calls()
        lp, pc = tm.prefill(params, batch)
        out["prefill_spans"] = tp_calls()
        cache = model.init_cache(B, T + len(tokens))
        fill_cache(cache, pc, T)
        states = gate_states(cfg, pc) if cfg.family == "hybrid" else None
        del pc
        reset_dp_calls()
        step()
        out["step_spans"] = tp_calls()
        out["states"] = {k: v.numpy() for k, v in (states or gate_states(cfg, cache)).items()}
        out["gate"] = (lp.float().cpu().numpy(), first[0])
        while len(outputs) < n_steps:
            step()
        torch.cuda.synchronize()
        out.update(launches=kernel_counts(), prefills=1, steps=n_steps,
                   by_path={"flash_attention": dict(fk.launches_by_path),
                            "decode_attention": dict(dk.launches_by_path),
                            "ssm_scan": dict(sk.launches_by_path)},
                   timings={k: list(v) for k, v in timings.items()},
                   outputs=torch.stack(outputs, 1).tolist())
        out["profile"] = tp_profile(step, len(tokens) - n_steps)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del cache, outputs, params
    if rank == 0:
        say(f"  [rank 0] {cfg.name} served on {job['shape']}: prefill {spread(timings['prefill'])}"
            f", decode {spread(out['timings']['decode'])}, peak {out['peak_gb']:.2f} GB")
    D.all_reduce_(torch.zeros(1, device=dev))   # every rank done before any frees the group
    return out


def state_gate(name, kern, plain, exact) -> float:
    """A rank's recurrent state against the single process's on the same
    heads: finite, and no further from the fp32 model's than NOISE_FACTOR
    times the plain bf16 path's (the logits gate's rule). Returns the
    kernel path's distance."""
    import torch
    e_kern, e_plain = rel_l2(kern, exact), rel_l2(plain, exact)
    ok = bool(torch.isfinite(kern).all()) and e_kern <= NOISE_FACTOR * e_plain
    say(f"  {'ok  ' if ok else 'FAIL'} {name}: rel L2 err vs fp32: the rank's {e_kern:.3e}, "
        f"plain path {e_plain:.3e} (gate <= {NOISE_FACTOR:g} x); rank vs plain "
        f"{rel_l2(kern, plain):.3e}")
    if not ok:
        fail(f"{name}: the rank's state is further from fp32 than bf16 rounding explains")
    return e_kern


def tp_family_serve_gate(label, cfg, refs, ranks, smi) -> dict:
    """16a's, 16c's and 16e's gates on one model's ranks: each rank's blocks'
    digests equal this process's blocks of the whole draw, its param bytes
    their sum; its launches exact (the hybrid: a flash launch a shared-block
    application and an ssd_scan a mamba2 block a prefill, a decode launch
    an application a step; whisper: an encoder layer's flash, a decoder
    layer's two, two decode launches a decoder layer a step; the xLSTM
    none), all on
    `flash_wgmma`, `decode_split` and the SSD scan's tensor-core path; the
    TP collectives of the prefill and of a decode step the code's
    (tp_spans); outputs and gate logits bit-identical across the ranks; the
    gate's logits (rank 0) held to this process's plain path in bf16 and
    fp32 (logits_gate); the hybrid's SSM state and the xLSTM's states of
    every rank against this process's on its heads (gate_states,
    state_gate). Prints the times, each rank's spans a decode step and its
    peak beside the single process's."""
    import numpy as np
    import torch
    n = len(ranks)
    steps = ranks[0]["steps"]
    if cfg.family == "hybrid":
        nb = cfg.n_layers // cfg.hybrid.attn_every
        pre, dec, ssd = nb, nb, cfg.n_layers
    elif cfg.family == "ssm":
        pre = dec = ssd = 0
    else:
        pre, dec, ssd = cfg.encdec.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers, 0
    want = {"flash_attention": pre, "decode_attention": dec * steps, "moe_gmm": 0,
            "ssm_scan": ssd, "moe_gmm_dx": 0, "moe_gmm_dw": 0}
    paths = {"flash_attention": {"wgmma": pre, "simt": 0},
             "decode_attention": {"split": dec * steps, "simt": 0},
             "ssm_scan": {"mma": ssd, "simt": 0}}
    spans = {"prefill_spans": tp_spans(cfg, n, "prefill"),
             "step_spans": tp_spans(cfg, n, "decode")}
    for rank, r in enumerate(ranks):
        same = r["digests"] == refs["digests"][rank]
        ok = same and r["param_bytes"] == refs["bytes"][rank]
        say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: {len(r['digests'])} leaves, their blocks' "
            f"digests equal this process's blocks of the whole draw: {same}; param bytes "
            f"{r['param_bytes']} = sum of its blocks {refs['bytes'][rank]}")
        if not ok:
            fail(f"{label}: rank {rank}'s weights are not its blocks of the seed's draw")
        ok = r["launches"] == want and r["by_path"] == paths
        say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: launches {r['launches']}, by kernel "
            f"{r['by_path']} (a prefill and {steps} decode steps)")
        if not ok:
            fail(f"{label}: rank {rank} did not launch the kernels as its layers ask: want "
                 f"{want}, all on {paths}")
        got = {k: r[k] for k in spans}
        ok = got == spans
        say(f"  {'ok  ' if ok else 'FAIL'} rank {rank}: TP spans {got}, from the code {spans}")
        if not ok:
            fail(f"{label}: rank {rank}'s TP collectives are not the code's")
    r0 = ranks[0]
    if not all(r["outputs"] == r0["outputs"] and all(np.array_equal(a, b) for a, b in
                                                     zip(r["gate"], r0["gate"])) for r in ranks):
        fail(f"{label}: the ranks' outputs or gate logits differ")
    pre_t, dec_t = r0["timings"]["prefill"], r0["timings"]["decode"]
    say(f"  ok   outputs and gate logits bit-identical across ranks; rank 0: prefill "
        f"{spread(pre_t)} per batch, decode {spread(dec_t)} per step [{smi}]; plan {r0['plan']}")
    for rank, r in enumerate(ranks):
        p = r["profile"]
        say(f"  rank {rank}, profiled decode steps: {p['step_ms']:.2f} ms a step, "
            + ", ".join(f"{s} {p[s + '_count']:.0f} spans {p[s + '_ms']:.2f} ms"
                        for s in TP_SPANS if p[s + "_count"])
            + f" a step (host spans), NCCL kernels {p['nccl_ms']:.3f} ms; device busy "
            f"{p['busy'] * 100:.1f}%, copies {p['copy_ms']:.2f} ms a step; peak "
            f"{r['peak_gb']:.2f} GB, single process {refs['single_peak_gb']:.2f} GB")
    B = r0["gate"][0].shape[0]
    for i, name in enumerate((f"prefill logits (B={B})", f"decode-step logits (B={B})")):
        logits_gate(name, torch.from_numpy(r0["gate"][i]), refs["plain"][i], refs["exact"][i],
                    cfg.vocab_size)
    errs = []
    for rank, r in enumerate(ranks):
        for k, got in r["states"].items():
            what, dim = GATED_STATES[k]
            h = got.shape[dim]
            errs.append(state_gate(f"rank {rank}'s {what} (heads {rank * h}-{(rank + 1) * h - 1})",
                                   torch.from_numpy(got),
                                   refs["plain"][2][k].narrow(dim, rank * h, h),
                                   refs["exact"][2][k].narrow(dim, rank * h, h)))
    return dict(decode_ms=float(np.median(dec_t)) * 1e3, prefill_ms=float(np.median(pre_t)) * 1e3,
                peak_gb=[r["peak_gb"] for r in ranks], single_peak_gb=refs["single_peak_gb"],
                profile=[r["profile"] for r in ranks], state_err=errs,
                spans={k: r0[k] for k in spans})


def ssd_rows(gen, dev, shapes):
    """The SSD scan at each of `shapes` ((label, B, H, T, P, N, chunk)) in
    fp32 against its plain version, its route gated (the tensor-core path),
    timed beside the plain version and the bound (no PyTorch call computes
    it): the rows."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssm_scan as sk
    rnd = _rnd(gen, dev)
    rows = []
    for label, B, H, T, P, N, Q in shapes:
        args = _ssd_inputs(rnd, B, T, H, P, 1, N, torch.float32)
        path = sk.route_for(args[0], args[3], args[4], chunk=Q)
        shape = f"B={B} H={H} T={T} P={P} N={N} chunk {Q} fp32"
        y, st = ops.ssd_scan(*args, chunk=Q)
        want_y, want_s = ref.ssd_scan_ref(*args, chunk=Q)
        err = gate(f"ssd_scan {label}, {shape} ({path}) y", y, want_y, SSD_F32_TOL)
        gate(f"ssd_scan {label} ({path}) state", st, want_s, SSD_F32_TOL)
        if path != "mma":
            fail(f"ssd_scan at {label} did not route to the tensor-core path: {path}")
        ms = device_ms(lambda: ops.ssd_scan(*args, chunk=Q), 20)
        plain = cuda_ms(lambda: ref.ssd_scan_ref(*args, chunk=Q), 3)
        bound, by, flops, nbytes = ssd_bound(B, H, T, P, N, Q, 4)
        say(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({flops / 1e9:.3f} GFLOP at the TF32 rate, {nbytes / 1e6:.2f} MB); no library call")
        rows.append(dict(path_of=label, shape=shape, kernel=path, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None))
        del args, y, st, want_y, want_s
    return rows


def hybrid_tp_configs():
    """16b's, 16c's and 16e's training at published width: name -> (config,
    mesh shape, ZeRO-2, steps, a profiled step, seq[, rows[, train_ranks's
    options]]). 16b zamba2-2.7b x 6 of 54 layers (one super-block, the
    shared block once) on 8f's batch of 4 x 1024; 16c whisper-tiny at
    published width and depth on 8g's 4 x 448 tokens and 4 x 1536 stub
    frames; 16e xlstm-350m x 8 of 24 layers (one super-block) in fp32 on
    8h's 32 x 64 tokens (two single runs whose sums differ in order only
    start from first gradients 0.36-0.49 rel L2 apart at 24 layers in
    fp32, and sit 0.97 of the update apart at 8 in bf16), its floor run
    with the mLSTM heads reversed, its first gradient gated by leaf kind
    and its second grad norm at XLSTM_STEP2_NORM_TOL; 2 steps each, 16c's
    third profiled."""
    from repro_torch.configs import get_config
    return {"16b": (get_config("zamba2-2.7b").replace(n_layers=6), HYBRID_TP_SHAPE, False, 2,
                    False, 1024),
            "16c train": (get_config("whisper-tiny"), HYBRID_TP_SHAPE, False, 2, True, 448),
            "16e train": (get_config("xlstm-350m").replace(n_layers=8, param_dtype="float32"),
                          HYBRID_TP_SHAPE, False, 2, False, 64, 32,
                          dict(reverse_heads=True, grad_blocks=True,
                               norm_tol=(DP_METRIC_TOL, XLSTM_STEP2_NORM_TOL)))}


def hybrid_tp_phase(seed, dev, smi, gen, n_micro=2, rows=4) -> dict:
    """Phase 16: tensor parallelism of the hybrid, whisper and the xLSTM on
    four ranks of a (1, 4) mesh on the cards present (ranks as in phase
    13), each rank holding its blocks (the hybrid's mamba2 blocks on 20 of
    80 SSM heads, w_zx's product gathered; whisper's 6 heads gathered by
    column; the xLSTM's mLSTM and sLSTM blocks on 1 of 4 heads, w_up's
    product and the sLSTM's h gathered): 16a zamba2-2.7b x 12 of 54 layers
    (two super-blocks) serving phase 7's prefill of 4 x 1024 and 8 decode
    steps (tp_family_serve_gate, with each rank's SSM state); 16b
    zamba2-2.7b x 6 trained as phase 14 trains (train_ranks); 16c
    whisper-tiny at published width and depth, 9a's prefill (8 x 64 tokens
    over 8 x 1536 frames) and 8 decode steps, and 8g's training; 16e
    xlstm-350m at published width, 8 of 24 layers (one super-block), 4
    prompts of 256 tokens and 8 decode steps (each rank's mLSTM and sLSTM
    states after the first step), and 8h's training (32 x 64, in fp32);
    the TP collectives of every prefill,
    decode step and train step held to the code's count (tp_spans); 16d
    the kernels at a rank's shapes. The four ranks run 16a-c and 16e,
    after this process's references. Returns the ranks' launches summed and
    16d's rows."""
    import numpy as np
    from repro_torch.configs import get_config
    configs = hybrid_tp_configs()
    n = HYBRID_TP_SHAPE[1]
    tp_span_want = {name: tp_spans(cfg, n, "train", n_micro)
                    for name, (cfg, *_rest) in configs.items()}
    serve, refs = {}, {}
    rng = np.random.default_rng(seed + 5)
    for name, cfg, B, T in (("16a", get_config("zamba2-2.7b").replace(n_layers=12), 4, 1024),
                            ("16c serve", get_config("whisper-tiny"), 8, 64),
                            ("16e serve", get_config("xlstm-350m").replace(n_layers=8), 4, 256)):
        tokens = rng.integers(0, cfg.vocab_size, (8 + TP_PROFILE_STEPS, B)).tolist()
        t0 = time.perf_counter()
        refs[name] = tp_family_references(cfg, seed + 3, n, B, T, tokens[0], dev)
        say(f"  {name} single process, {cfg.name} x {cfg.n_layers}: whole model and the gate's "
            f"references in {time.perf_counter() - t0:.1f} s")
        serve[name] = dict(serve="tp", cfg=cfg, shape=HYBRID_TP_SHAPE, seed=seed + 3, B=B, T=T,
                           tokens=tokens, steps=8)
    say("phase 16a-c, 16e: the single processes first, then one job on 4 ranks")
    out = train_ranks(configs, seed, dev, smi, n_micro, rows, 1024, extra=serve,
                      tp_span_want=tp_span_want, floor=tuple(configs))
    for name, job in serve.items():
        cfg = job["cfg"]
        say(f"phase {name}: {cfg.name} x {cfg.n_layers} layers at published width on a "
            f"{HYBRID_TP_SHAPE} mesh, {job['B']} x {job['T']}-token prompts, {job['steps']} "
            "decode steps, through the model interface")
        out[name] = tp_family_serve_gate(name, cfg, refs[name], out["extra"][name], smi)
    served = [r for name in serve for r in out["extra"][name]]
    for k in kernel_counts():
        out[k] += sum(r["launches"][k] for r in served)
    out["flash_attention_by_path"]["wgmma"] += sum(r["by_path"]["flash_attention"]["wgmma"]
                                                   for r in served)
    out["ssm_scan_by_path"]["mma"] += sum(r["by_path"]["ssm_scan"]["mma"] for r in served)
    out["decode_attention_by_path"] = {p: sum(r["by_path"]["decode_attention"][p]
                                              for r in served) for p in ("split", "simt")}
    out.pop("extra")
    say("phase 16d: the kernels at a rank's shapes")
    rows_ = tp_kernel_phase(gen, dev, HYBRID_TP_FLASH_SHAPES, HYBRID_TP_DECODE_SHAPES, ())
    rows_["flash_attention_lse"] = tp_train_kernel_phase(gen, dev, HYBRID_TP_LSE_SHAPES,
                                                         gmm_dims=None)["flash_attention"]
    rows_["ssm_scan"] = ssd_rows(gen, dev, HYBRID_TP_SSD_SHAPES)
    out["kernels"] = rows_
    return out


# ----------------------------------------------------------------------------
# phase 17: Adafactor and checkpoints on a (2, 2) mesh
# ----------------------------------------------------------------------------

# 17d: the dry-run's meta account of 17a's rank 0, computed beside phases 3-11
AF_ACCOUNT_FILE = ROOT / "build" / "dryrun" / "chip_smoke" / "phi-adafactor-2x2-account.json"


def adafactor_train_configs():
    """17a's and 17b's configs: 15a's and 15b's (published width, 2 of 32
    and 2 of 64 layers, (2, 2), ZeRO-2, 2 steps, no profile) with
    Adafactor: 17a phi3.5-moe's experts over "data" and d_ff over "model";
    17b qwen1.5-32b's FSDP leaves over "data", TP over "model". Their
    rounding floors are 0.0387 and 0.0189 of the update
    (tools/update_floor.py --optimizer adafactor; the same single-process
    runs inside this script printed 0.02914 and 0.01913 in two calls, bit
    for bit, on an NVIDIA H100 80GB HBM3 at 700 W). Twice each is under
    DP_UPDATE_TOL, so phase 17 gates its ranks at DP_UPDATE_TOL and does not
    train its single processes again on the plain kernels (phase 16 does:
    zamba2's floor is 0.09)."""
    return {name.replace("15", "17"): (cfg.replace(optimizer="adafactor"), *rest)
            for name, (cfg, *rest) in dp_train_configs().items()}


def ckpt_gate(label, cfg, results, directory, step, dev, smi) -> dict:
    """17c: the checkpoint the ranks wrote of `cfg`'s state on DP_TP_SHAPE
    (ZeRO-2) restored into this process, whole: each rank's block of it,
    and each rank's own restore, bit-identical (digests) to the blocks the
    rank saved. Prints the save's and the restores' seconds."""
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import train_state
    from repro_torch.tree import tree_map
    mesh = Mesh(DP_TP_SHAPE, ("data", "model"))
    meta = build_model(cfg, device="meta").init_params(torch.Generator())
    _, full = dp_shardings(cfg, mesh)
    t0 = time.perf_counter()
    whole = train_state(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                                 meta), make_optimizer(cfg.optimizer))
    Checkpointer(directory).restore(whole, step=step)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad = []
    for rank, r in enumerate(results):
        want = block_digests(whole, full, rank)
        bad += [("one process", rank, k) for k in want if r["saved"].get(k) != want[k]]
        bad += [("ranks", rank, k) for k in r["saved"] if r["restored"].get(k) != r["saved"][k]]
        bad += [("missing", rank, k) for k in r["saved"] if k not in want]
    n_stats = sum(1 for k in results[0]["saved"] if k.startswith("opt/s/"))
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(whole))
    say(f"  {'ok  ' if not bad else 'FAIL'} [{smi}] {label}: {len(results[0]['saved'])} blocks a "
        f"rank ({n_stats} of Adafactor's statistics), saved from {len(results)} ranks in "
        f"{max(r['save_s'] for r in results):.2f} s, restored on the ranks in "
        f"{max(r['restore_s'] for r in results):.2f} s and into one process "
        f"({nbytes / 1e9:.2f} GB) in {load_s:.2f} s: every rank's blocks bit-identical to "
        "both restores")
    if bad:
        fail(f"{label}: restored blocks differ from the saved ones: {bad[:8]}")
    del whole
    torch.cuda.empty_cache()
    return dict(save_s=[r["save_s"] for r in results],
                restore_s=[r["restore_s"] for r in results], one_process_s=load_s,
                state_gb=nbytes / 1e9)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--meta-account", default=None,
                    help="write 12d's meta account to this file and exit (no card needed)")
    ap.add_argument("--meta-run", default="15b", choices=("15b", "17a"),
                    help="the run whose rank 0 --meta-account accounts")
    args = ap.parse_args()
    if args.meta_account:
        meta_account_main(args.meta_account, run=args.meta_run)
        return 0

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 reference in full fp32
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say("phase 1: device")
    say(smi)
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), running on {name}")

    say("phase 2: build")
    t0 = time.perf_counter()   # the build's wall time goes into the phase table
    for n, p in build.build().items():
        regs = [ln.split(":", 1)[1].strip() for ln in p.with_suffix(".log").read_text()
                .splitlines() if "registers" in ln]
        say(f"  {n}: {p.name}, {len(regs)} instantiations, e.g. {regs[:1]}")
    say(f"  built in {time.perf_counter() - t0:.1f} s")
    # phase 12c's sweep runs on the CPU beside phases 3-11
    procs = start_sweep()
    atexit.register(stop_sweep, procs)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    walls = {"2 build": time.perf_counter() - t0}

    def timed(phase, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        walls[phase] = time.perf_counter() - t
        say(f"  [phase {phase}: {walls[phase]:.1f} s wall]")
        return out

    table = timed("3a-c attention", kernel_phase, gen, dev)
    timed("3a'-b' head dims 80, 160", head_dim_phase, gen, dev)
    # moe_gmm at the prefill capacity its tensor-core kernel was built for
    table["moe_gmm"] = timed("3d moe_gmm", gmm_phase, gen, dev)[160]
    table["ssd_scan"] = timed("3e ssd_scan", ssd_phase, gen, dev)
    new_shapes = timed("3f phase 9's attention shapes", new_shape_phase, gen, dev)

    runs = {}
    say("phase 4: dense serving, llama3-8b at published width and depth, bf16")
    cfg = get_config("llama3-8b")
    runs["4"] = timed("4 llama3-8b", serve_phase, cfg, args.seed, n_requests=16,
                      batch_slots=8, max_len=2048, new_tokens=32, prompt_range=(16, 1024),
                      dev=dev, label="llama3-8b")

    say("phase 5: int8 KV cache path, llama3-8b width at 2 layers")
    timed("5 int8 cache", serve_phase, cfg.replace(kv_cache_dtype="int8", n_layers=2),
          args.seed + 1, n_requests=4, batch_slots=4, max_len=2048, new_tokens=8,
          prompt_range=(16, 1024), dev=dev, label="llama3-8b int8 cache, 2 layers")

    # 32 layers are 41.9 B params, 78 GiB of bf16 weights: no room on an 80 GB
    # card for the cache and activations; 16 layers are 21.1 B params
    say("phase 6: MoE serving, phi3.5-moe at published width, 16 of 32 layers, bf16")
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=16)
    runs["6"] = timed("6 phi3.5-moe", serve_phase, cfg, args.seed + 2, n_requests=16,
                      batch_slots=8, max_len=2048, new_tokens=32, prompt_range=(16, 1024),
                      dev=dev, label="phi3.5-moe, 16 layers", gate_layers=4)

    say("phase 7: hybrid prefill and decode, zamba2-2.7b at published width and depth, "
        "bf16, through the model interface")
    runs["7"] = timed("7 zamba2-2.7b", hybrid_phase, get_config("zamba2-2.7b"),
                      args.seed + 3, batch=4, prompt_len=1024, new_tokens=32, dev=dev)

    say("phase 8a: training's flash attention, bf16 T=1024: the lse of both kernels, the "
        "backward")
    table["flash_attention"].update(timed("8a lse, backward", train_kernel_phase, gen, dev))
    # 32 layers are 8.03 B params, whose bf16 params and grads, fp32 gradient
    # accumulator and AdamW moments come to 128 GB; 4 layers are 1.92 B, 31 GB
    say("phase 8b: training, llama3-8b at published width, 4 of 32 layers, bf16, AdamW")
    runs["8"] = timed("8b llama3-8b training", train_phase,
                      get_config("llama3-8b").replace(n_layers=4), args.seed + 4, batch=4,
                      seq=1024, n_micro=2, steps=6, dev=dev)
    say("phase 8c: crash and bit-exact restart, the demo preset of examples/train_torch.py")
    timed("8c restart", restart_phase, args.seed + 5, dev)
    say("phase 8d: training's backward kernels: moe_gmm's dx and dw, and the gradients of "
        "GroupedMatmul and SSDScan")
    table["moe_gmm_bwd"] = timed("8d moe_gmm dx, dw", gmm_bwd_phase, gen, dev)
    table["ssd_scan"].update(timed("8d gradients", function_grad_phase, gen, dev))
    # 32 layers are 41.9 B params; 2 are 2.88 B, whose bf16 params and grads,
    # fp32 gradient accumulator and AdamW moments come to 46 GB (3: 67 GB)
    say("phase 8e: MoE training, phi3.5-moe at published width, 2 of 32 layers, bf16, AdamW")
    runs["8e"] = timed("8e phi3.5-moe training", train_phase,
                       get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=2), args.seed + 6,
                       batch=4, seq=1024, n_micro=2, steps=6, dev=dev,
                       gate_leaves=MOE_GRAD_GATE_LEAVES)
    say("phase 8f: hybrid training, zamba2-2.7b at published width and depth, bf16, AdamW")
    runs["8f"] = timed("8f zamba2-2.7b training", train_phase, get_config("zamba2-2.7b"),
                       args.seed + 7, batch=4, seq=1024, n_micro=2, steps=6, dev=dev,
                       gate_leaves=HYBRID_GRAD_GATE_LEAVES)
    # the decoder's published context is 448 tokens; the encoder reads
    # ENC_LEN = 1536 stub frames a sequence
    say("phase 8g: audio training, whisper-tiny at published width and depth, bf16, AdamW")
    runs["8g"] = timed("8g whisper-tiny training", train_phase, get_config("whisper-tiny"),
                       args.seed + 11, batch=4, seq=448, n_micro=2, steps=6, dev=dev,
                       gate_leaves=WHISPER_GRAD_GATE_LEAVES, frontend=("enc_embeds", 1536))
    # the sLSTM scans its steps one by one, in the forward, again in the remat
    # and in the backward, ~100 launches a step in all: at 8 x 256 tokens a
    # train step took 4.6 s (NVIDIA H100 80GB HBM3, 700 W), so the length is
    # cut to 64 (the step's time follows the length, not the batch)
    say("phase 8h: xLSTM training, xlstm-350m at published width and depth, bf16, AdamW "
        "(no kernel)")
    runs["8h"] = timed("8h xlstm-350m training", train_phase, get_config("xlstm-350m"),
                       args.seed + 12, batch=32, seq=64, n_micro=2, steps=6, dev=dev,
                       gate_leaves=XLSTM_GRAD_LEAVES)
    # 80 layers are 68.4 B params; 16 bytes a param (bf16 params and grads,
    # the fp32 accumulator, AdamW's moments) allow 2: 3.81 B params, 61 GB,
    # 2.1 B of them the untied embeddings
    say("phase 8i: VLM training, internvl2-76b at published width, 2 of 80 layers, bf16, "
        "AdamW, 256 patch embeddings a sequence")
    cfg = get_config("internvl2-76b").replace(n_layers=2)
    runs["8i"] = timed("8i internvl2-76b training", train_phase, cfg, args.seed + 13, batch=4,
                       seq=1024, n_micro=2, steps=6, dev=dev, gate_leaves=GRAD_GATE_LEAVES,
                       frontend=("patch_embeds", cfg.vlm.n_patches))
    # whisper-tiny's published depth: 4 encoder and 4 decoder layers; the
    # cross cache holds ENC_LEN = 1536 encoder rows
    say("phase 9a: whisper-tiny at published width and depth, bf16, through the model "
        "interface")
    cfg = get_config("whisper-tiny")
    n_dec, n_enc = cfg.n_layers, cfg.encdec.n_enc_layers
    runs["9a"] = timed("9a whisper-tiny", frontend_phase, cfg, args.seed + 8, B=8, T=64,
                       cache_len=128, new_tokens=32, dev=dev, frontend=("enc_embeds", 1536),
                       n_flash=n_enc + 2 * n_dec, n_decode=2 * n_dec)
    say("phase 9b: xlstm-350m at published width and depth, bf16, through the model "
        "interface (no kernel: the reference's xLSTM is jnp)")
    runs["9b"] = timed("9b xlstm-350m", xlstm_phase, get_config("xlstm-350m"), args.seed + 9,
                       B=4, T=1024, new_tokens=32, replay_T=256, dev=dev)
    # 80 layers are 68.4 B params, 137 GB of bf16 weights; 24 layers are
    # 24 x 1.711 GB + 4.20 GB of embeddings, 45 GB, which leaves room for
    # the fp32 copy of 4 layers that the logits gate reads
    say("phase 9c: internvl2-76b at published width, 24 of 80 layers, bf16, 256 patch "
        "embeddings a prompt, through the model interface")
    cfg = get_config("internvl2-76b").replace(n_layers=24)
    runs["9c"] = timed("9c internvl2-76b", frontend_phase, cfg, args.seed + 10, B=4, T=1024,
                       cache_len=1024 + 32, new_tokens=32, dev=dev,
                       frontend=("patch_embeds", cfg.vlm.n_patches), n_flash=cfg.n_layers,
                       n_decode=cfg.n_layers, gate_layers=4)
    say("phase 10: RL rollouts, the 14 environments of the paper's benchmark, 1000 steps each, "
        "on the card and on the CPU")
    runs["10"] = timed("10 RL rollouts", rl_phase, args.seed + 14, dev)
    say("phase 11: the multi-rank paths, ranks on the cards present")
    # 11b takes 2 steps: phase 15's time comes out of it
    runs["11"] = timed("11 ranks", ranks_phase, args.seed + 15, dev, smi, runs["8"]["step_ms"],
                       steps=2)
    say("phase 12: the dry-run held to the card")
    timed("12 dry-run", dryrun_phase, args.seed + 16, dev, smi, runs, procs)
    say('phase 13: tensor-parallel serving over the "model" axis, ranks on the cards present')
    runs["13"] = timed("13 TP serving", tp_serving_phase, args.seed, dev, smi, gen,
                       runs["4"]["outputs"])
    tp_rows = runs["13"].pop("kernels")
    say('phase 14: tensor-parallel training over the "model" axis, ranks on the cards present')
    runs["14"] = timed("14 TP training", tp_train_phase, args.seed + 17, dev, smi, gen)
    tp_train_rows = runs["14"].pop("kernels")
    say('phase 16: tensor parallelism of the hybrid, whisper and the xLSTM over the "model" '
        'axis, ranks on the cards present')
    runs["16"] = timed("16 TP hybrid, whisper, xLSTM", hybrid_tp_phase, args.seed + 19, dev, smi,
                       gen)
    hy_rows = runs["16"].pop("kernels")
    # 15 and 17 train the same configs on the same mesh, with AdamW and with
    # Adafactor: one job on the ranks runs both (17a's seed is 15a's + 2)
    say('phases 15 and 17: FSDP and EP over the "data" axis, then Adafactor and checkpoints, '
        'on a (2, 2) mesh, ranks on the cards present')
    runs["15"] = timed("15, 17 FSDP and EP; Adafactor, checkpoints", dp_phase, args.seed + 18,
                       dev, smi, gen)
    dp_rows = runs["15"].pop("kernels")
    say("phase 18: the kernel table and the device")
    say("phase wall times: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; total {sum(walls.values()):.1f} s")

    src = "src/repro_torch/kernels/csrc"
    kernels = []
    for kname, module, replaces in (
            ("flash_attention", "flash_attention", "src/repro/kernels/flash_attention.py:30"),
            ("decode_attention", "decode_attention",
             "src/repro/kernels/decode_attention.py:25"),
            ("moe_gmm", "moe_gmm", "src/repro/kernels/moe_gmm.py:22"),
            ("ssd_scan", "ssm_scan", "src/repro/kernels/ssm_scan.py:24")):
        row = table[kname]
        kernels.append({"name": kname, "route": "cuda", "source": f"{src}/{module}.cu",
                        "replaces": replaces,
                        "launches": sum(r[module] for r in runs.values()),
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": row["shape"]})
    # which kernel the timed shape took, and the paths' launches by kernel
    flash = table["flash_attention"]
    kernels[0].update(kernel=flash["path"], simt_ms=flash["simt_ms"],
                      event_ms=flash["event_ms"], lse=True,
                      lse_launches=sum(runs[k]["flash_attention"]
                                       for k in ("8", "8e", "8f", "8g", "8i", "11", "14"))
                      + runs["15"]["lse"] + runs["16"]["lse"],
                      **{k: flash[k] for k in ("nolse_ms", "lse_ms", "bwd_ms", "bwd_sdpa_ms",
                                               "bwd_bound_ms", "bwd_shape")},
                      launches_by_kernel={p: sum(r["flash_attention_by_path"][p]
                                                 for r in runs.values()
                                                 if "flash_attention_by_path" in r)
                                          for p in ("wgmma", "simt")},
                      phase9_shapes=new_shapes["flash_attention"],
                      tp_shapes=tp_rows["flash_attention"],
                      tp_train_shapes=tp_train_rows["flash_attention"],
                      dp_train_shapes=dp_rows["flash_attention"],
                      tp_hybrid_shapes=hy_rows["flash_attention"] + hy_rows["flash_attention_lse"])
    dec = table["decode_attention"]
    kernels[1].update(kernel=dec["path"], simt_ms=dec["simt_ms"], event_ms=dec["event_ms"],
                      launches_by_kernel={p: sum(r["decode_attention_by_path"][p]
                                                 for r in runs.values()
                                                 if "decode_attention_by_path" in r)
                                          for p in ("split", "simt")},
                      phase9_shapes=new_shapes["decode_attention"],
                      tp_shapes=tp_rows["decode_attention"],
                      tp_hybrid_shapes=hy_rows["decode_attention"])
    train_gmm = {kind: {p: sum(runs[k]["moe_gmm_by_path"][kind][p]
                               for k in ("8e", "11", "14", "15"))
                        for p in by_path}
                 for kind, by_path in runs["8e"]["moe_gmm_by_path"].items()}
    kernels[2].update(kernel=table["moe_gmm"]["path"],
                      launches_by_kernel={p: runs["6"]["moe_gmm_by_path"][p] + train_gmm["fwd"][p]
                                          + runs["13"]["moe_gmm_by_path"][p]
                                          for p in train_gmm["fwd"]},
                      tp_shapes=tp_rows["moe_gmm"], ep_shapes=dp_rows["moe_gmm_fwd"])
    for kind in GMM_BACKWARD:   # the backward products, at phi's training capacity
        row = table["moe_gmm_bwd"][kind]
        kernels[2][kind] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "max_abs_err",
                                                "path", "shape")}
        kernels[2][kind].update(launches=sum(runs[k][f"moe_gmm_{kind}"]
                                             for k in ("8e", "11", "14", "15")),
                                launches_by_kernel=train_gmm[kind],
                                tp_train_shape=tp_train_rows["moe_gmm"][kind],
                                ep_train_shape=dp_rows["moe_gmm"][kind])
    ssd = table["ssd_scan"]
    kernels[3].update(kernel=ssd["path"], simt_ms=ssd["simt_ms"], event_ms=ssd["event_ms"],
                      dist_fp64=ssd["dist_fp64"],
                      launches_by_kernel={p: runs["7"]["ssm_scan_by_path"][p]
                                          + runs["8f"]["ssm_scan_by_path"][p]
                                          + runs["16"]["ssm_scan_by_path"][p]
                                          for p in runs["7"]["ssm_scan_by_path"]},
                      tp_hybrid_shapes=hy_rows["ssm_scan"],
                      prefill_ms=runs["7"]["ssd_prefill_ms"],
                      **{k: ssd[k] for k in ("ssd_bwd_ms", "ssd_bwd_bound_ms",
                                             "ssd_bwd_bound_by", "ssd_bwd_shape")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
