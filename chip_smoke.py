#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main path, dense-LM continuous-batching serving, on the
card and checks it. Every phase exits non-zero on failure; nothing is caught
and carried on.

  1. requires a CUDA device; prints the card's name and power limit;
  2. builds both attention kernels from `src/repro_torch/kernels/csrc/`;
  3. holds each kernel against its plain PyTorch version on the card at
     llama3-8b shapes (Hq=32, D=128), and for the int8 cache at phase 5's
     shapes and at qwen1.5-32b's padded heads; times kernel, plain version
     and the library call
     `F.scaled_dot_product_attention` (a yardstick only, never used by the
     port);
  4. llama3-8b at its published width and depth with random bf16 weights
     from a seeded generator: a ServeEngine with 8 slots of 2048 tokens
     serves 16 requests (prompts of 16-1024 tokens, 32 new tokens each); the
     kernels' launch counts are read around this run. Then the prefill
     logits of one request and the logits of one decode step are held
     against the same model run with the plain attention;
  5. the same width with an int8 KV cache at 2 layers, gated the same way;
  6. prints the kernel table as one JSON line and, last, the device line
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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16_TOL = 2e-2      # tests/test_kernels.py::_tol
F32_TOL = 2e-5
INT8_TOL = 1e-4      # tests/test_kernels.py int8 decode
# the model's logits: the kernel path may be at most this many times further
# from the fp32 model than the plain bf16 path is (see logits_gate)
NOISE_FACTOR = 2.0


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
    say(f"  {'ok  ' if ok else 'FAIL'} {name}: max_abs_err {err:.3e} (atol=rtol={tol:g})")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ----------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------------

def kernel_phase(gen, dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

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
                pairs = T * (T + 1) // 2
                flops = 4 * 32 * 128 * pairs
                nbytes = 2 * 128 * T * (32 + 8 + 8 + 32)
                bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
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
            nbytes = 2 * (2 * rows * Hc * D + 2 * B * Hq * D) + 4 * B
            flops = 4 * Hq * D * rows
            bound = max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
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


# ----------------------------------------------------------------------------
# phases 4-5: the serving path
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


def logits_gate(name, kern, plain, exact):
    """kern and plain: the bf16 model with the kernels and with the plain
    attention; exact: the plain path in fp32 on the same weights. The kernel
    path must be finite and no further from fp32 than NOISE_FACTOR times the
    plain bf16 path's own distance: both round to bf16 at the same places
    and differ only in the order of the attention sums."""
    import torch
    e_kern, e_plain = rel_l2(kern, exact), rel_l2(plain, exact)
    agree = (kern.float().argmax(-1) == plain.float().argmax(-1)).float().mean().item()
    agree32 = (kern.float().argmax(-1) == exact.float().argmax(-1)).float().mean().item()
    say(f"  {name}: rel L2 err vs fp32: kernel path {e_kern:.3e}, plain path "
        f"{e_plain:.3e} (gate: kernel <= {NOISE_FACTOR:g} x plain); kernel vs plain "
        f"{rel_l2(kern, plain):.3e}, max abs {max_err(kern, plain):.3e}; greedy-token "
        f"agreement with plain {agree * 100:.1f}%, with fp32 {agree32 * 100:.1f}%")
    if not bool(torch.isfinite(kern.float()).all()) or not e_kern <= NOISE_FACTOR * e_plain:
        fail(f"{name}: the kernel path is further from fp32 than bf16 rounding explains")


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree.clone()


@contextlib.contextmanager
def plain_attention():
    """The model's attention on the plain PyTorch versions for the duration:
    the model modules' `ops` is swapped for a namespace of the plain ones."""
    from repro_torch.kernels import ref
    from repro_torch.models import dense, layers
    plain_ops = types.SimpleNamespace(flash_attention=ref.flash_attention_ref,
                                      decode_attention=ref.decode_attention_ref)
    with mock.patch.object(layers, "ops", plain_ops), \
            mock.patch.object(dense, "ops", plain_ops):
        yield


def check_against_plain(model, params, prompts, cfg, dev):
    """Prefill logits of one request, and the logits of one decode step over
    a batch prefilled from `prompts`: kernel path vs plain path vs the plain
    path in fp32."""
    import torch
    from repro_torch.models import dense
    cfg32 = cfg.replace(param_dtype="float32")
    with torch.inference_mode():
        params32 = _to_f32(params)
        tok = torch.tensor([prompts[0]], dtype=torch.int32, device=dev)
        kern, _ = dense.lm_prefill(params, {"tokens": tok}, cfg)
        with plain_attention():
            plain, _ = dense.lm_prefill(params, {"tokens": tok}, cfg)
            exact, _ = dense.lm_prefill(params32, {"tokens": tok}, cfg32)
        logits_gate(f"prefill logits (T={len(prompts[0])})", kern, plain, exact)

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
        kern, _ = dense.lm_decode_step(params, cache, batch, cfg)
        with plain_attention():
            plain, _ = dense.lm_decode_step(params, plain_cache, batch, cfg)
            exact, _ = dense.lm_decode_step(params32, exact_cache, batch, cfg32)
        logits_gate(f"decode-step logits (B={B})", kern, plain, exact)
        del cache, plain_cache, exact_cache, params32


def profile_window(engine, prompts, steps=4):
    """Profile `steps` decode ticks with every slot busy: device busy share
    of the window and the largest device and host costs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request
    for i, p in enumerate(prompts[:engine.B]):
        engine.add_request(Request(id=10_000 + i, prompt=p, max_new_tokens=steps + 3))
    engine.tick()   # prefill every slot, then one decode step
    engine.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.tick()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    engine.run_until_drained()
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
                prompt_range, dev, label):
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
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
        f"{cfg.n_heads}/{cfg.n_kv_heads} (cache {cfg.cache_kv_heads}), d_ff {cfg.d_ff}, "
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

    fk.launches = dk.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.add_request(r)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fk.launches, "decode_attention": dk.launches}

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
    say(f"  kernel launches on this path: {launches} (per prefill {cfg.n_layers} flash, "
        f"per decode step {cfg.n_layers} decode)")
    if launches["flash_attention"] != cfg.n_layers * s["prefills"] or \
            launches["decode_attention"] != cfg.n_layers * steps:
        fail(f"{label}: the path did not go through the kernels once per layer: {launches}")
    say(f"  peak device memory while serving {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    profile_window(engine, prompts)
    del engine
    torch.cuda.empty_cache()
    check_against_plain(model, params, prompts[:batch_slots], cfg, dev)
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
    t0 = time.perf_counter()
    for n, p in build.build().items():
        regs = [ln.split(":", 1)[1].strip() for ln in p.with_suffix(".log").read_text()
                .splitlines() if "registers" in ln]
        say(f"  {n}: {p.name}, {len(regs)} instantiations, e.g. {regs[:1]}")
    say(f"  built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    table = kernel_phase(gen, dev)

    say("phase 4: main path, llama3-8b at published width and depth, bf16")
    cfg = get_config("llama3-8b")
    launches = serve_phase(cfg, args.seed, n_requests=16, batch_slots=8,
                           max_len=2048, new_tokens=32, prompt_range=(16, 1024),
                           dev=dev, label="llama3-8b")
    torch.cuda.empty_cache()

    say("phase 5: int8 KV cache path, llama3-8b width at 2 layers")
    serve_phase(cfg.replace(kv_cache_dtype="int8", n_layers=2), args.seed + 1,
                n_requests=4, batch_slots=4, max_len=2048, new_tokens=8,
                prompt_range=(16, 1024), dev=dev, label="llama3-8b int8 cache, 2 layers")

    src = "src/repro_torch/kernels/csrc"
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:30",
                "decode_attention": "src/repro/kernels/decode_attention.py:25"}
    kernels = []
    for kname in ("flash_attention", "decode_attention"):
        row = table[kname]
        kernels.append({"name": kname, "route": "cuda", "source": f"{src}/{kname}.cu",
                        "replaces": replaces[kname], "launches": launches[kname],
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
