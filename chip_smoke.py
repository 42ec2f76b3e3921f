#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's paths on the card and checks them: dense-LM
continuous-batching serving, MoE serving, the zamba2 hybrid's prefill and
decode, training of every family, prefill and decode of the xLSTM, whisper
and VLM families, and the paper's RL rollouts. Every phase exits non-zero
on failure; nothing is caught and carried on.

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
 11. prints the kernel table as one JSON line (moe_gmm's with its dx and dw
     at C=320, ssd_scan's with its plain backward, flash's and decode's
     with their rows at phase 9's shapes) and, last, the device line
     `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import contextlib
import time
import types
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores,
# fp32 outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

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


def flash_bound(B, Hq, Hkv, T, D):
    """(bound ms, flops) of causal attention over T tokens in bf16."""
    flops = 4 * B * Hq * D * (T * (T + 1) // 2)
    nbytes = 2 * B * D * T * (2 * Hq + 2 * Hkv)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3, flops


def decode_bound(B, Hq, Hc, D, rows):
    """(bound ms, bytes) of one bf16 query per sequence over `rows` valid
    cache rows in all."""
    nbytes = 2 * (2 * rows * Hc * D + 2 * B * Hq * D) + 4 * B
    flops = 4 * Hq * D * rows
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS) * 1e3, nbytes


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
    from repro_torch.kernels import ops

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
        _, nbytes = decode_bound(B, Hq, Hc, D, int(valid.sum()))
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

    B, Hq, D = q.shape
    Hc, S = kc.shape[1], kc.shape[2]
    if nbytes is None:
        _, nbytes = decode_bound(B, Hq, Hc, D, int(valid.sum()))
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
    from repro_torch.kernels import ops, ref

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
        bound, flops = flash_bound(B, Hq, Hkv, T, D)
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
    from repro_torch.kernels import ops, ref

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
            bound, _ = decode_bound(B, Hq, Hc, D, rows)
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
                rows = int(valid.sum())
                nbytes = 2 * rows * Hc * (D + 4) + 2 * 2 * B * Hq * D + 4 * B
                decode_times(q, k8, v8, valid, (ks, vs), nbytes=nbytes)
                split_sweep(q, k8, v8, valid, (ks, vs), nbytes=nbytes)
                say(f"  bound int8: {nbytes / PEAK_HBM_BYTES * 1e3:.4f} ms ({nbytes / 1e6:.2f} MB)")
    return table


def head_dim_phase(gen, dev):
    """Flash and decode at zamba2's head dim 80 (Hq = Hkv = 32) and
    stablelm-12b's 160 (Hq = 32, Hkv = 8, cache replicated to 16); flash is
    swept over T at both (at zamba2's batch of 4 for D=80), decode timed at
    zamba2's decode shape and at D=160. Returns the times."""
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops, ref

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
                t["bound_ms"], _ = decode_bound(B, Hq, Hc, D, int(vl.sum()))
                say(f"    plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
                times[f"decode_d{D}"] = t
    return times


def attention_bound(B, Hq, Hkv, Tq, Tk, D, causal):
    """(bound ms, bound_by) of bf16 flash attention: q, k, v read once, the
    output written once; the products (causal: those on or below the
    diagonal, Tq == Tk) at the bf16 tensor-core rate."""
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    t_ops = 4 * B * Hq * D * pairs / PEAK_BF16_FLOPS
    t_bytes = 2 * B * D * (2 * Hq * Tq + 2 * Hkv * Tk) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


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
    from repro_torch.kernels import ops, ref

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
        bound, by = attention_bound(B, Hq, Hkv, Tq, Tk, D, causal)
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
        bound, _ = decode_bound(B, Hq, Hc, D, B * n_valid)
        say(f"    plain {plain:.4f} ms, bound {bound:.4f} ms")
        rows["decode_attention"].append(dict(
            path_of=label, shape=shape, kernel=path, launches_per_step=n, max_abs_err=err,
            ms=t["kernel"], plain_ms=plain, bound_ms=bound, bound_by="bytes",
            library_ms=t["sdpa"], simt_ms=t["simt"]))
        del q, kc, vc
    return rows


def gmm_bound(E, C, din, dout):
    """(bound ms, bound_by, flops, bytes) of a bf16 grouped matmul: x, w read
    once, out written once; the products at the bf16 tensor-core rate."""
    flops = 2 * E * C * din * dout
    nbytes = 2 * (E * C * din + E * din * dout + E * C * dout)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            flops, nbytes)


def gmm_phase(gen, dev):
    """The grouped expert matmul against its plain version at phi3.5-moe's
    decode (C=4) and prefill (C=160) capacities, both directions, and at
    arctic's width; weights scaled as the model draws them (std d**-0.5).
    Then a capacity sweep: the kernel `route` chose at each C, its time,
    torch.bmm's and the bound."""
    import torch
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.kernels import ops, ref

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
                bound, by, flops, nbytes = gmm_bound(E, C, din, dout)
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
        bound, by, _, _ = gmm_bound(16, C, 4096, 6400)
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
    from repro_torch.kernels import ops, ref

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
                bound, by, flops, nbytes = gmm_bound(E, C, din, dout)
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
    products (3x ssd_bound's operations), at the TF32 tensor-core rate."""
    _, _, flops, _ = ssd_bound(B, H, T, P, N, Q, 4)
    flops *= 3
    nbytes = 4 * 2 * (2 * B * H * T * P + B * H * T + 2 * B * T * N + H)
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            flops, nbytes)


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
    """(bound ms, bound_by, flops, bytes) of the chunked scan: x, dt, B, C
    read once, y and the state written once; the causal half of each
    chunk's products, and the state terms; at the tensor cores' rate for
    the inputs' type (TF32 for fp32) unless `peak` names another."""
    nc = T // Q
    pairs = Q * (Q + 1) // 2
    flops = B * H * nc * (2 * pairs * (N + P) + 4 * Q * N * P)
    nbytes = el * (2 * B * H * T * P + 2 * B * T * N) + 4 * (B * H * T + B * H * P * N + H)
    peak = peak or (PEAK_TF32_FLOPS if el == 4 else PEAK_BF16_FLOPS)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            flops, nbytes)


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
        cores, _, _, _ = ssd_bound(B, H, T, P, N, Q, 4, PEAK_F32_FLOPS)
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
    dK, dV); q, k, v, out, dout and lse read once, dq, dk, dv written once."""
    flops = 10 * B * Hq * D * (T * (T + 1) // 2)
    nbytes = 2 * B * D * T * (3 * Hq + 2 * Hkv) + 4 * B * Hq * T + 2 * B * D * T * (Hq + 2 * Hkv)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3, flops


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
    mfu = flops / t_step / PEAK_BF16_FLOPS
    how = (f"6 x {n_matmul / 1e9:.3f} B x tokens" if not frames else
           f"6 x (encoder weights x {batch} x {frames} frames + decoder weights x tokens)")
    say(f"  {steps} steps of {batch} x {seq} tokens"
        + (f" ({frontend[0]} {batch} x {frontend[1]})" if frontend else "")
        + f" in {n_micro} microbatches: median of steps "
        f"2-{steps} {t_step * 1e3:.2f} ms, {tokens / t_step:.0f} tokens/s, MFU {mfu * 100:.2f}% "
        f"({how} = {flops / 1e12:.2f} TFLOP / step time / {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s); peak device memory {peak:.2f} GB")
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
    args = ap.parse_args()

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
    say("phase 11: the kernel table and the device")
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
                                       for k in ("8", "8e", "8f", "8g", "8i")),
                      **{k: flash[k] for k in ("nolse_ms", "lse_ms", "bwd_ms", "bwd_sdpa_ms",
                                               "bwd_bound_ms", "bwd_shape")},
                      launches_by_kernel={p: sum(r["flash_attention_by_path"][p]
                                                 for r in runs.values()
                                                 if "flash_attention_by_path" in r)
                                          for p in ("wgmma", "simt")},
                      phase9_shapes=new_shapes["flash_attention"])
    dec = table["decode_attention"]
    kernels[1].update(kernel=dec["path"], simt_ms=dec["simt_ms"], event_ms=dec["event_ms"],
                      launches_by_kernel={p: sum(r["decode_attention_by_path"][p]
                                                 for r in runs.values()
                                                 if "decode_attention_by_path" in r)
                                          for p in ("split", "simt")},
                      phase9_shapes=new_shapes["decode_attention"])
    train_gmm = runs["8e"]["moe_gmm_by_path"]
    kernels[2].update(kernel=table["moe_gmm"]["path"],
                      launches_by_kernel={p: runs["6"]["moe_gmm_by_path"][p] + train_gmm["fwd"][p]
                                          for p in train_gmm["fwd"]})
    for kind in GMM_BACKWARD:   # the backward products, at phi's training capacity
        row = table["moe_gmm_bwd"][kind]
        kernels[2][kind] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "max_abs_err",
                                                "path", "shape")}
        kernels[2][kind].update(launches=runs["8e"][f"moe_gmm_{kind}"],
                                launches_by_kernel=train_gmm[kind])
    ssd = table["ssd_scan"]
    kernels[3].update(kernel=ssd["path"], simt_ms=ssd["simt_ms"], event_ms=ssd["event_ms"],
                      dist_fp64=ssd["dist_fp64"],
                      launches_by_kernel={p: runs["7"]["ssm_scan_by_path"][p]
                                          + runs["8f"]["ssm_scan_by_path"][p]
                                          for p in runs["7"]["ssm_scan_by_path"]},
                      prefill_ms=runs["7"]["ssd_prefill_ms"],
                      **{k: ssd[k] for k in ("ssd_bwd_ms", "ssd_bwd_bound_ms",
                                             "ssd_bwd_bound_by", "ssd_bwd_shape")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
