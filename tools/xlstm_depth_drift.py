#!/usr/bin/env python3
"""How far rounding carries through the xLSTM stack at xlstm-350m's width,
in both packages, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/xlstm_depth_drift.py [--layers 8] [--tokens 256]

Builds xlstm-350m at its published width (d_model 1024, mLSTM heads of 512)
and `--layers` of its 24 layers, JAX-initialised weights handed to the port
by `repro_torch.bridge`, and one prompt of `--tokens` tokens from a seed.
Prints, as relative L2 distances over the real vocabulary of the last
position's logits:
  * the port's fp32 prefill against JAX's;
  * each package's chunked prefill against its own decode step replayed
    over the prompt from the empty state (fp32): two forms of one function;
  * the port's fp32 prefill with the mLSTM chunk cut to 64 against 256;
  * each package's bf16 prefill against JAX's fp32 one;
and, per block (one sLSTM, one mLSTM, random input), the parallel form
against its decode step replayed over the same input. A block alone keeps
rounding at ~1e-6; the stack multiplies it layer by layer, in the reference
as in the port. chip_smoke.py's phase 9b gates the two forms per block for
this reason (XLSTM_BLOCK_L2). Imports both packages, as the tests do; it is
not part of the port.
"""
from __future__ import annotations

import argparse
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import xlstm as X

ARCH = "xlstm-350m"


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def last(logits, V):
    return np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits,
                      np.float32)[0, -1, :V]


def models(dtype, n_layers):
    jcfg = jax_get_config(ARCH).replace(param_dtype=dtype, n_layers=n_layers)
    cfg = get_config(ARCH).replace(param_dtype=dtype, n_layers=n_layers)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, cfg, build_model(cfg, device="cpu"), bridge.params_from_jax(jp)


def block_forms(params, cfg, T):
    """The first sLSTM and mLSTM blocks over a random (1, T, d) input: the
    parallel form against the decode step replayed over the same input."""
    x = torch.randn(1, T, cfg.d_model, generator=torch.Generator().manual_seed(1))
    empty = X.init_cache(cfg, 1, device="cpu")
    out = {}
    for name, fwd, step, block, state in (
            ("sLSTM", X.slstm_fwd, X.slstm_decode, params["slstm"][0],
             tuple(empty[k][0] for k in ("s_c", "s_n", "s_m", "s_h"))),
            ("mLSTM", X.mlstm_fwd, X.mlstm_decode, params["mlstm"][0][0],
             tuple(empty[k][0, 0] for k in ("m_C", "m_n", "m_m")))):
        ys = []
        for t in range(T):
            y, state = step(block, x[:, t:t + 1], state, cfg)
            ys.append(y)
        out[name] = rel(torch.cat(ys, 1), fwd(block, x, cfg))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=256)
    args = ap.parse_args()
    T = args.tokens
    toks = np.random.default_rng(0).integers(0, 50304, (1, T)).astype(np.int32)
    got = {}
    with torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            jm, jp, cfg, m, p = models(dtype, args.layers)
            V = cfg.vocab_size
            jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
            lp, _ = m.prefill(p, {"tokens": torch.from_numpy(toks)})
            got[dtype] = (last(jl, V), last(lp, V))
            if dtype == "bfloat16":
                continue
            print(f"xlstm-350m width, {args.layers} layers, {T} tokens, fp32 (relative L2 "
                  f"of the last logits):")
            print(f"  port prefill vs JAX prefill            {rel(got[dtype][1], got[dtype][0]):.3e}")
            cache = m.init_cache(1)
            for t in range(T):
                ld, cache = m.decode_step(p, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
            jstep = jax.jit(jm.decode_step)
            jc = jm.init_cache(1)
            for t in range(T):
                jd, jc = jstep(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                        "positions": jnp.zeros((1,), jnp.int32)})
            print(f"  port prefill vs port decode replayed   {rel(last(ld, V), got[dtype][1]):.3e}")
            print(f"  JAX prefill vs JAX decode replayed     {rel(last(jd, V), got[dtype][0]):.3e}")
            with mock.patch.object(X, "mlstm_fwd", functools.partial(X.mlstm_fwd, chunk=64)):
                l64, _ = m.prefill(p, {"tokens": torch.from_numpy(toks)})
            print(f"  port prefill, mLSTM chunk 64 vs 256    {rel(last(l64, V), got[dtype][1]):.3e}")
            for name, e in block_forms(p, cfg, T).items():
                print(f"  one {name} block, parallel vs replayed {e:.3e}")
    print(f"bf16 prefill vs JAX's fp32 prefill: JAX {rel(got['bfloat16'][0], got['float32'][0]):.3e}, "
          f"port {rel(got['bfloat16'][1], got['float32'][0]):.3e}")


if __name__ == "__main__":
    main()
