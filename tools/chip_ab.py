#!/usr/bin/env python3
"""Phases 3a-3e, 4, 6, 7 and 8b of chip_smoke.py for several trees of this
repository, one after the other on one card, so that their times compare.

    python3 tools/chip_ab.py TREE [TREE ...]     # e.g. parent change change parent

Each TREE is the root of a checkout (an unpacked `git archive`, say). Each
runs in a process of its own, with its own `chip_smoke.py`, its own kernel
sources and its own build directory: the kernels are built (phase 2), then
the attention kernels are checked and timed at llama3-8b's, zamba2's and
stablelm-12b's widths (phases 3a-3c and 3a'-3b'), the grouped expert matmul
too (phase 3d), the SSD scan (phase 3e), llama3-8b is served at its
published width and depth
(phase 4), phi3.5-moe at its published width and 16 layers (phase 6), and
zamba2-2.7b prefills and decodes at its published width and depth (phase
7), and llama3-8b at its published width and 4 layers trains 6 steps
(phase 8b), with the arguments `chip_smoke.py` gives them.

Six measurements are this script's own, the same for every tree: decode
attention's device and event times at phases 3b's, 3b''s and 3c's shapes
through the tree's `ops.decode_attention`, beside SDPA's and the bound
(`decode_ab`); the host time a call of its `ops.decode_attention` and
`ops.flash_attention` at host-paced shapes (`call_ab`); flash attention's
distance to an fp32 run, by kernel, at llama3-8b's, zamba2-2.7b's and
stablelm-12b's prefill shapes
(`flash_precision_ab`); the SSD scan's device time and distance to an
fp64 run (this script's own plain version) through the tree's
`ops.ssd_scan` at zamba2-2.7b's prefill widths (`ssd_ab`); zamba2-2.7b's
4 x 1024 prefill timed three times, with the SSD kernels' device ms in a
profiled prefill (`prefill_ab`); and the profiled decode windows of phases
4, 6 and 7, which print the decode kernels' device ms per step whatever the
tree's own `chip_smoke.py` prints (this script's
`chip_smoke.profile_steps` replaces the tree's). Needs a CUDA device;
exits non-zero if any tree fails.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

OWN_ROOT = Path(__file__).resolve().parents[1]
OWN_SMOKE = OWN_ROOT / "chip_smoke.py"
OWN_REF = OWN_ROOT / "src" / "repro_torch" / "kernels" / "ref.py"   # imports torch only
# the kernels' cost formulas (plain Python) and the card's peaks (torch only):
# the bounds printed for every tree
OWN_COSTS = OWN_ROOT / "src" / "repro_torch" / "kernels" / "costs.py"
OWN_ROOFLINE = OWN_ROOT / "src" / "repro_torch" / "roofline.py"


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module        # a dataclass looks its module up there
    spec.loader.exec_module(module)   # puts the tree's src first on sys.path
    return module


def decode_ab(own, gen, dev):
    """Decode attention through the tree's ops.decode_attention at llama3-8b's
    replicated cache (B=8 Hq=32 Hc=16 S=2048 D=128, phase 3b's lengths),
    zamba2-2.7b's rolling cache (B=4 Hq=Hc=32 S=1056 D=80, 1040 rows each)
    and phase 5's int8 cache (B=4 Hq=32 Hc=16, bf16 q): device time
    (device_ms), event time (cuda_ms), SDPA's device time for bf16 and the
    bound, all from this script's tree's chip_smoke.py helpers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    costs, roofline = _load(OWN_COSTS, "own_costs"), _load(OWN_ROOFLINE, "own_roofline")

    rnd = own._rnd(gen, dev)
    for label, B, Hq, Hc, S, D, int8 in (("llama3-8b", 8, 32, 16, 2048, 128, False),
                                         ("zamba2-2.7b", 4, 32, 32, 1056, 80, False),
                                         ("int8 cache", 4, 32, 16, 2048, 128, True)):
        if label == "zamba2-2.7b":
            valid = torch.full((B,), 1040, device=dev, dtype=torch.int32)
        else:
            valid = torch.randint(1, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
            valid[0], valid[-1] = 1, S
        q = rnd(B, Hq, D)
        kf, vf = (rnd(B, S, Hc, D, dtype=torch.float32 if int8 else torch.bfloat16)
                  for _ in range(2))
        rows = int(valid.sum())
        if int8:
            ks, vs = (x.abs().amax(-1, keepdim=True) / 127.0 for x in (kf, vf))
            kc, vc = (torch.round(x / s).to(torch.int8).transpose(1, 2)
                      for x, s in ((kf, ks), (vf, vs)))
            scales = (ks.transpose(1, 2), vs.transpose(1, 2))
            cost = costs.decode_cost(B, Hq, Hc, S, D, rows=rows, cache_itemsize=1, scales=True)
        else:
            kc, vc, scales = kf.transpose(1, 2), vf.transpose(1, 2), (None, None)
            cost = costs.decode_cost(B, Hq, Hc, S, D, rows=rows)
        bound, nbytes = roofline.bound(*cost)[0] * 1e3, cost[1]
        own.gate(f"decode_ab {label}", ops.decode_attention(q, kc, vc, valid, *scales),
                 ref.decode_attention_ref(q, kc, vc, valid, *scales), own.BF16_TOL)
        calls = {"kernel": lambda: ops.decode_attention(q, kc, vc, valid, *scales)}
        if not int8:
            mask = (torch.arange(S, device=dev)[None, :] < valid[:, None])[:, None, None, :]
            calls["sdpa"] = lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=Hq != Hc)
        times = {n: (own.device_ms(fn, 50), own.cuda_ms(fn, 50)) for n, fn in calls.items()}
        print(f"  decode_ab {label} B={B} Hq={Hq} Hc={Hc} S={S} D={D} "
              f"{'int8' if int8 else 'bf16'} cache, {rows} rows: "
              + ", ".join(f"{n} device {d:.4f} ms event {e:.4f} ms" for n, (d, e) in times.items())
              + f"; bound {bound:.4f} ms, kernel {nbytes / times['kernel'][0] / 1e6:.1f} GB/s",
              flush=True)
        del q, kf, vf, kc, vc


def flash_precision_ab(own, dev):
    """chip_smoke.flash_precision through the tree's flash kernels on the
    inputs of tests/test_torch_cuda.py::
    test_flash_tensor_core_kernel_keeps_p_in_fp32_precision."""
    import torch
    for B, Hq, Hkv, T, D in ((1, 32, 8, 1024, 128), (4, 32, 32, 1024, 80),
                             (1, 32, 8, 1024, 160)):
        g = torch.Generator(device=dev).manual_seed(T + D)
        q, k, v = (torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
                   .transpose(1, 2) for H in (Hq, Hkv, Hkv))
        dist = own.flash_precision(q, k, v)
        print(f"  flash_precision_ab B={B} Hq={Hq} Hkv={Hkv} T={T} D={D}: relative L2 "
              f"distance to fp32, wgmma {dist['wgmma']:.6e}, simt {dist['simt']:.6e}, "
              f"ratio {dist['wgmma'] / dist['simt']:.4f}", flush=True)


def ssd_ab(own, dev):
    """The SSD scan through the tree's ops.ssd_scan at zamba2-2.7b's prefill
    widths (B=4 H=80 P=N=64 G=1 chunk 256, fp32 (B,T,H,P) views) for T in
    {1024, 2048}: device time (device_ms), the bound, and the relative L2
    distance of y and of the final state to an fp64 run of this script's
    tree's plain version (the same for every tree)."""
    import torch
    from repro_torch.kernels import ops
    own_ref = _load(OWN_REF, "own_ref")
    costs, roofline = _load(OWN_COSTS, "own_costs"), _load(OWN_ROOFLINE, "own_roofline")
    H, P, N, Q = 80, 64, 64, 256
    for B, T in ((4, 1024), (4, 2048)):
        g = torch.Generator(device=dev).manual_seed(T)
        x = (torch.randn((B, T, H, P), generator=g, device=dev) * 0.5).transpose(1, 2)
        dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g, device=dev))
        A = -torch.exp(torch.randn(H, generator=g, device=dev) * 0.3)
        Bm, Cm = ((torch.randn((B, T, 1, N), generator=g, device=dev) * 0.5).transpose(1, 2)
                  for _ in range(2))
        args = (x, dt.transpose(1, 2), A, Bm, Cm)
        exact_y, exact_s = own_ref.ssd_scan_ref(*(t.double() for t in args), chunk=Q)
        y, s = ops.ssd_scan(*args, chunk=Q)
        ms = own.device_ms(lambda: ops.ssd_scan(*args, chunk=Q), 20)
        seconds, by = roofline.bound(*costs.ssd_cost(B, H, T, P, 1, N, Q, 4),
                                     roofline.PEAK_TF32_FLOPS)
        bound = seconds * 1e3
        print(f"  ssd_ab B={B} H={H} T={T} P={P} N={N} fp32: device {ms:.4f} ms, bound "
              f"{bound:.4f} ms by {by}; distance to fp64 y {own.rel_l2(y, exact_y):.6e} "
              f"state {own.rel_l2(s, exact_s):.6e}", flush=True)
        del x, dt, Bm, Cm, args, exact_y, exact_s, y, s


def prefill_ab(own, seed, dev):
    """zamba2-2.7b at its published width and depth (the tree's model):
    the 4 x 1024 prefill of phase 7 timed three times, and the SSD kernels'
    device ms in one profiled prefill, with this script's helpers."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("zamba2-2.7b")
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed + 3))
    tokens = torch.tensor(np.random.default_rng(seed + 3).integers(0, cfg.vocab_size, (4, 1024)),
                          dtype=torch.int32, device=dev)
    def run():
        return model.prefill(params, {"tokens": tokens})
    with torch.inference_mode():
        run()
        seconds = own.prefill_times(run, 3)
        ssd = own.ssd_prefill_ms(run)
    print(f"  prefill_ab zamba2-2.7b 4 x 1024: median {np.median(seconds):.4f} s ("
          + ", ".join(f"{t:.4f}" for t in seconds) + "); SSD kernels "
          f"{sum(ms for ms, _ in ssd.values()):.3f} ms a prefill: "
          + ", ".join(f"{n} x{c} {ms:.3f} ms" for n, (ms, c) in ssd.items()), flush=True)
    del model, params


def call_ab(dev, calls=2000, reps=5):
    """Host time a call of the tree's ops.decode_attention and
    ops.flash_attention at shapes so small that the host paces them (B=1,
    one head group, 64 rows; the device takes a few microseconds a call):
    `calls` calls queued back to back, the wall over the count, median of
    `reps`. The entry point's own cost, whatever route it takes to the
    kernel (the custom op or the wrapper)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 8, 128), generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn((1, 64, 2, 128), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    valid = torch.full((1,), 64, dtype=torch.int32, device=dev)
    fq = torch.randn((1, 64, 8, 128), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    for name, fn in (("decode_attention", lambda: ops.decode_attention(q, kc, kc, valid)),
                     ("flash_attention", lambda: ops.flash_attention(fq, kc, kc))):
        walls = []
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / calls * 1e6)
        print(f"  call_ab {name}: {np.median(walls):.2f} us a call (host-paced; "
              + ", ".join(f"{w:.2f}" for w in walls) + ")", flush=True)


def run_tree(root: Path, seed: int) -> int:
    """Phases 2, 3a-3e, 4, 6, 7 and 8b of the chip_smoke.py at `root`,
    decode_ab, flash_precision_ab, ssd_ab and prefill_ab, in this process."""
    own = _load(OWN_SMOKE, "chip_smoke_ab")
    smoke = _load(root / "chip_smoke.py", "chip_smoke")
    smoke.profile_steps = own.profile_steps
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"== tree {root}: {smi}", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for phase in (smoke.kernel_phase, smoke.head_dim_phase, smoke.gmm_phase, smoke.ssd_phase):
        phase(gen, dev)
        torch.cuda.empty_cache()
    decode_ab(own, gen, dev)
    call_ab(dev)
    flash_precision_ab(own, dev)
    ssd_ab(own, dev)
    torch.cuda.empty_cache()
    prefill_ab(own, seed, dev)
    torch.cuda.empty_cache()
    smoke.serve_phase(get_config("llama3-8b"), seed, n_requests=16, batch_slots=8,
                      max_len=2048, new_tokens=32, prompt_range=(16, 1024), dev=dev,
                      label="llama3-8b")
    torch.cuda.empty_cache()
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=16)
    smoke.serve_phase(cfg, seed + 2, n_requests=16, batch_slots=8, max_len=2048,
                      new_tokens=32, prompt_range=(16, 1024), dev=dev,
                      label="phi3.5-moe, 16 layers", gate_layers=4)
    torch.cuda.empty_cache()
    smoke.hybrid_phase(get_config("zamba2-2.7b"), seed + 3, batch=4, prompt_len=1024,
                       new_tokens=32, dev=dev)
    torch.cuda.empty_cache()
    smoke.train_phase(get_config("llama3-8b").replace(n_layers=4), seed + 4, batch=4,
                      seq=1024, n_micro=2, steps=6, dev=dev)
    print(f"== tree {root}: done", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_tree(args.trees[0].resolve(), args.seed)
    rc = 0
    for tree in args.trees:
        out = subprocess.run([sys.executable, __file__, "--one", "--seed", str(args.seed),
                              str(tree)])
        if out.returncode:
            print(f"chip_ab: tree {tree} failed (exit {out.returncode})", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
