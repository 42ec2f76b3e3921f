#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's three paths on the card and checks them: dense-LM
continuous-batching serving, MoE serving, and the zamba2 hybrid's prefill
and decode. Every phase exits non-zero on failure; nothing is caught and
carried on.

  1. requires a CUDA device; prints the card's name and power limit;
  2. builds the four kernels from `src/repro_torch/kernels/csrc/`;
  3. holds each kernel against its plain PyTorch version on the card, and
     times kernel, plain version and, where one exists, the library call
     (a yardstick only, never used by the port):
     a/b. flash and decode attention at llama3-8b shapes (Hq=32, D=128),
        at zamba2's (Hq=Hkv=32, D=80; timed at its prefill and decode
        shapes) and at stablelm-12b's (Hq=32, Hkv=8, D=160);
        `F.scaled_dot_product_attention` is the yardstick;
     c. the int8-cache decode at phase 5's shapes and at qwen1.5-32b's
        padded heads;
     d. the grouped expert matmul at phi3.5-moe's decode (C=4) and prefill
        (C=160) capacities in both directions, and at arctic's width;
        `torch.bmm` is the yardstick;
     e. the SSD scan at zamba2's shapes (H=80, P=N=64, chunk 256), fp32 and
        bf16, and at fp32 against the sequential recurrence too; no single
        PyTorch call computes it;
  4. llama3-8b at its published width and depth with random bf16 weights
     from a seeded generator: a ServeEngine with 8 slots of 2048 tokens
     serves 16 requests (prompts of 16-1024 tokens, 32 new tokens each); the
     kernels' launch counts are read around this run. Then the prefill
     logits of one request and the logits of one decode step are held
     against the same model run with the plain kernels and in fp32;
  5. the same width with an int8 KV cache at 2 layers, gated the same way;
  6. phi3.5-moe at its published width and 16 of its 32 layers, served as
     in phase 4 (moe_gmm launched 3 times per layer in every prefill and
     decode step); on its first 4 layers the kernel path's logits are held
     to the plain bf16 path's, and so is the share of routing choices on
     which the two agree;
  7. zamba2-2.7b at its published width and depth through the model
     interface: prefill of 4 prompts of 1024 tokens, then 32 decode steps
     on the rolling cache; launch counts, profile, and logits gated on the
     prefill and on one decode step;
  8. prints the kernel table as one JSON line and, last, the device line
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
# On the H100 the two paths' prefill logits are 1.85e-2 to 2.04e-2 apart in
# relative L2, and they agree on 98.6% of the routing choices.
MOE_PLAIN_L2 = 5e-2
MOE_ROUTING_AGREEMENT = 0.95


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


def kernel_phase(gen, dev):
    import torch
    import torch.nn.functional as F
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
            err = gate(f"flash {str(dtype)[6:]} T={T} window={window}", out, want, tol)
            if dtype == torch.bfloat16 and T == 1024 and window is None:
                # the timed case: the longest prompt the main path draws
                ms = cuda_ms(lambda: ops.flash_attention(q, k, v), 20)
                plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 5)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 20)
                bound, flops = flash_bound(1, 32, 8, T, 128)
                say(f"  time T={T} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                    f"sdpa {lib:.4f} ms, bound {bound:.4f} ms "
                    f"({flops / ms / 1e9:.1f} TFLOP/s)")
                table["flash_attention"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by="operations", library_ms=lib,
                    shape=f"B=1 T={T} Hq=32 Hkv=8 D=128 bf16 causal")

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
        err = gate(f"decode {str(dtype)[6:]} valid_len={valid.tolist()}", out,
                   ref.decode_attention_ref(q, kc, vc, valid), tol)
        if dtype == torch.bfloat16:
            mask = (torch.arange(S, device=dev)[None, :] < valid[:, None])[:, None, None, :]
            ms = cuda_ms(lambda: ops.decode_attention(q, kc, vc, valid), 50)
            plain = cuda_ms(lambda: ref.decode_attention_ref(q, kc, vc, valid), 5)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), 50)
            rows = int(valid.sum())
            bound, nbytes = decode_bound(B, Hq, Hc, D, rows)
            say(f"  time bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                f"bound {bound:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s)")
            table["decode_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="bytes", library_ms=lib,
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
            gate(f"decode int8 cache, q {str(dtype)[6:]} valid_len={valid.tolist()}", out,
                 ref.decode_attention_ref(q, k8, v8, valid, ks, vs), tol)
            if dtype == torch.float32:
                ms = cuda_ms(lambda: ops.decode_attention(q, k8, v8, valid, ks, vs), 50)
                rows = int(valid.sum())
                nbytes = 2 * rows * Hc * (D + 4) + 2 * 4 * B * Hq * D + 4 * B
                say(f"  time int8: kernel {ms:.4f} ms, bound "
                    f"{nbytes / PEAK_HBM_BYTES * 1e3:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s)")
    return table


def head_dim_phase(gen, dev):
    """Flash and decode at zamba2's head dim 80 (Hq = Hkv = 32) and
    stablelm-12b's 160 (Hq = 32, Hkv = 8, cache replicated to 16); the D=80
    cases are timed at zamba2's prefill and decode shapes. Returns the times."""
    import torch
    import torch.nn.functional as F
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
                gate(f"flash D={D} {str(dtype)[6:]} B={B} T={T}",
                     ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v), tol)
                if D == 80 and B == 4 and dtype == torch.bfloat16:
                    ms = cuda_ms(lambda: ops.flash_attention(q, k, v), 10)
                    plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 3)
                    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True), 10)
                    bound, flops = flash_bound(B, Hq, Hkv, T, D)
                    say(f"  time zamba2 prefill B={B} T={T} D=80 bf16: kernel {ms:.4f} ms, "
                        f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms "
                        f"({flops / ms / 1e9:.1f} TFLOP/s)")
                    times["flash_d80"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                              bound_ms=bound)

    say("phase 3b': decode attention at D=80 (zamba2's rolling cache, B=4 Hq=Hc=32 "
        "S=1056) and D=160 (B=8 Hq=32 Hc=16 S=2048)")
    for D, B, Hq, Hc, S in ((80, 4, 32, 32, 1056), (160, 8, 32, 16, 2048)):
        valid = torch.randint(1, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        valid[0], valid[-1] = 1, S
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            q = rnd(B, Hq, D, dtype=dtype)
            kc = rnd(B, S, Hc, D, dtype=dtype).transpose(1, 2)
            vc = rnd(B, S, Hc, D, dtype=dtype).transpose(1, 2)
            gate(f"decode D={D} {str(dtype)[6:]} valid_len={valid.tolist()}",
                 ops.decode_attention(q, kc, vc, valid),
                 ref.decode_attention_ref(q, kc, vc, valid), tol)
            if D == 80 and dtype == torch.bfloat16:
                # mid-way through phase 7's decode: 1024 + 16 valid rows each
                vl = torch.full((B,), 1040, device=dev, dtype=torch.int32)
                mask = (torch.arange(S, device=dev)[None, :] < vl[:, None])[:, None, None, :]
                ms = cuda_ms(lambda: ops.decode_attention(q, kc, vc, vl), 50)
                plain = cuda_ms(lambda: ref.decode_attention_ref(q, kc, vc, vl), 5)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kc, vc, attn_mask=mask), 50)
                bound, nbytes = decode_bound(B, Hq, Hc, D, int(vl.sum()))
                say(f"  time zamba2 decode B={B} valid 1040 D=80 bf16: kernel {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms "
                    f"({nbytes / ms / 1e6:.1f} GB/s)")
                times["decode_d80"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                           bound_ms=bound)
    return times


def gmm_phase(gen, dev):
    """The grouped expert matmul against its plain version at phi3.5-moe's
    decode (C=4) and prefill (C=160) capacities, both directions, and at
    arctic's width; weights scaled as the model draws them (std d**-0.5)."""
    import torch
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
            err = gate(f"moe_gmm {label} {str(dtype)[6:]} E={E} C={C} {din}->{dout}",
                       ops.moe_gmm(x, w), ref.moe_gmm_ref(x, w), tol)
            if timed and dtype == torch.bfloat16:
                ms = cuda_ms(lambda: ops.moe_gmm(x, w), 20 if C == 4 else 5)
                plain = cuda_ms(lambda: ref.moe_gmm_ref(x, w), 3)
                lib = cuda_ms(lambda: torch.bmm(x, w), 20)
                flops = 2 * E * C * din * dout
                nbytes = 2 * (E * C * din + E * din * dout + E * C * dout)
                bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
                by = "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES \
                    else "bytes"
                say(f"  time C={C} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                    f"torch.bmm {lib:.4f} ms, bound {bound:.4f} ms by {by} "
                    f"({nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.1f} TFLOP/s)")
                rows[C] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                               bound_by=by, library_ms=lib,
                               shape=f"E={E} C={C} d={din} f={dout} bf16")
            del x, w
    say("  capacity sweep, bf16 E=16 4096->6400 (a T-token prefill has C = "
        "ceil4(0.15625 T), 4-160 on the path):")
    w = rnd(16, 4096, 6400, scale=4096 ** -0.5)
    for C in (8, 16, 20, 32, 48, 64, 96, 128, 160):
        x = rnd(16, C, 4096)
        gate(f"moe_gmm bf16 C={C}", ops.moe_gmm(x, w), ref.moe_gmm_ref(x, w), BF16_TOL)
        ms = cuda_ms(lambda: ops.moe_gmm(x, w), 5)
        lib = cuda_ms(lambda: torch.bmm(x, w), 5)
        say(f"    C={C}: kernel {ms:.4f} ms, torch.bmm {lib:.4f} ms")
    del x, w
    return rows


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


def ssd_phase(gen, dev):
    """The SSD scan against its plain version at zamba2's shapes, and at fp32
    against the sequential recurrence."""
    import torch
    from repro_torch.kernels import ops, ref

    rnd = _rnd(gen, dev)
    H, P, N, G, Q = 80, 64, 64, 1, 256
    row = {}
    say(f"phase 3e: SSD scan, zamba2 H={H} P={P} N={N} G={G} chunk {Q}")
    for B in (1, 4):
        for T in (256, 1024, 2048):
            for dtype, tol in ((torch.float32, SSD_F32_TOL), (torch.bfloat16, BF16_TOL)):
                args = _ssd_inputs(rnd, B, T, H, P, G, N, dtype)
                y, s = ops.ssd_scan(*args, chunk=Q)
                want_y, want_s = ref.ssd_scan_ref(*args, chunk=Q)
                err = gate(f"ssd_scan {str(dtype)[6:]} B={B} T={T} y", y, want_y, tol)
                gate(f"ssd_scan {str(dtype)[6:]} B={B} T={T} state", s, want_s, tol)
                if T == 256 and dtype == torch.float32:
                    x, dt, A, Bm, Cm = args
                    seq = ref.ssd_chunk_ref(x.transpose(1, 2), dt.transpose(1, 2), A,
                                            Bm.transpose(1, 2), Cm.transpose(1, 2))
                    gate(f"ssd_scan fp32 B={B} T={T} vs the sequential recurrence",
                         y.transpose(1, 2), seq, SSD_SEQ_TOL)
                if B == 4 and T == 1024:
                    el = 4 if dtype == torch.float32 else 2
                    ms = cuda_ms(lambda: ops.ssd_scan(*args, chunk=Q), 10)
                    plain = cuda_ms(lambda: ref.ssd_scan_ref(*args, chunk=Q), 3)
                    bound, by, flops, nbytes = ssd_bound(B, H, T, P, N, Q, el)
                    say(f"  time B={B} T={T} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain "
                        f"{plain:.4f} ms, bound {bound:.4f} ms by {by} ({flops / 1e9:.2f} "
                        f"GFLOP, {nbytes / 1e6:.1f} MB; {flops / ms / 1e9:.2f} TFLOP/s)")
                    if el == 4:
                        cores, _, _, _ = ssd_bound(B, H, T, P, N, Q, el, PEAK_F32_FLOPS)
                        say(f"  (bound at the fp32 CUDA-core rate, {PEAK_F32_FLOPS / 1e12:g} "
                            f"TFLOP/s, instead of TF32's: {cores:.4f} ms)")
                    if dtype == torch.float32:   # what the model passes
                        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=None,
                                   shape=f"B={B} H={H} T={T} P={P} N={N} chunk {Q} fp32")
                del args, y, s
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


def kernel_counts():
    """name -> the launch counter of each kernel wrapper."""
    import importlib
    return {n: importlib.import_module(f"repro_torch.kernels.{n}").launches
            for n in KERNEL_MODULES}


def reset_counts():
    import importlib
    for n in KERNEL_MODULES:
        importlib.import_module(f"repro_torch.kernels.{n}").launches = 0


@contextlib.contextmanager
def plain_kernels():
    """The model on the kernels' plain PyTorch versions for the duration:
    every model module's `ops` is swapped for a namespace of the plain
    ones."""
    from repro_torch.kernels import ref
    from repro_torch.models import dense, hybrid, layers, mamba2, moe
    plain_ops = types.SimpleNamespace(flash_attention=ref.flash_attention_ref,
                                      decode_attention=ref.decode_attention_ref,
                                      moe_gmm=ref.moe_gmm_ref, ssd_scan=ref.ssd_scan_ref)
    with contextlib.ExitStack() as stack:
        for module in (layers, dense, moe, mamba2, hybrid):
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


def profile_steps(step, steps):
    """Profile `steps` calls of `step()` (one decode step each): device busy
    share of the window and the largest device and host costs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # kernels (and copies) are the events that run on the card; the host
    # ops that launch them carry the same time again, so they are left out
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    say(f"  profiled {steps} decode steps: {window / steps * 1e3:.2f} ms per step (profiler on), "
        f"device busy {busy / window * 100:.1f}% (idle {100 - busy / window * 100:.1f}%), "
        f"{sum(e.count for e in kernels) / steps:.0f} device kernels per step")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        say(f"    device {dev_us(e) / steps / 1e3:8.3f} ms/step  x{e.count // steps:<4d} {e.key[:70]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]:
        say(f"    host   {e.self_cpu_time_total / steps / 1e3:8.3f} ms/step  "
            f"x{e.count // steps:<4d} {e.key[:70]}")


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
            "moe_gmm": n_gmm * (s["prefills"] + steps), "ssm_scan": 0}
    say(f"  kernel launches on this path: {launches} (per prefill {cfg.n_layers} flash"
        f"{f' and {n_gmm} moe_gmm' if n_gmm else ''}, per decode step {cfg.n_layers} "
        f"decode{f' and {n_gmm} moe_gmm' if n_gmm else ''})")
    if launches != want:
        fail(f"{label}: the path did not go through the kernels as often as its layers "
             f"ask: {launches}, want {want}")
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
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pc = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        at_prefill = kernel_counts()
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
        say(f"  prefill: {B} x {T} tokens in {t_prefill:.3f} s, {B * T / t_prefill:.0f} "
            f"tokens/s")
        say(f"  decode: {new_tokens} steps of {B} sequences, {sum(step_s):.3f} s, "
            f"{B * new_tokens / sum(step_s):.0f} tokens/s; {spread(step_s)} per step")
        want_prefill = {"flash_attention": nb, "decode_attention": 0, "moe_gmm": 0,
                        "ssm_scan": cfg.n_layers}
        want = dict(want_prefill, decode_attention=nb * new_tokens)
        say(f"  kernel launches: prefill {at_prefill}, prefill and decode {launches} (per "
            f"prefill {cfg.n_layers} ssd_scan and {nb} flash, per decode step {nb} decode)")
        if at_prefill != want_prefill or launches != want:
            fail(f"{cfg.name}: the path did not go through the kernels as its layers ask: "
                 f"{launches}, want {want}")
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
    gmm_rows = timed("3d moe_gmm", gmm_phase, gen, dev)
    table["moe_gmm"] = gmm_rows[4]
    table["ssd_scan"] = timed("3e ssd_scan", ssd_phase, gen, dev)

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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
