"""Dry-run: the memory and FLOP account of every (architecture x input
shape) cell on one H100 or a mesh of them, without a card.

The counterpart of the JAX package's `launch/dryrun.py`, which lowers each
cell's step against abstract inputs on a production TPU mesh and reads the
compiled module's memory and cost analyses. The port has no compiler to
ask, so it runs rank 0's step on the meta device (shapes and dtypes, no
data) under `roofline.CostModel`: every op's FLOPs, HBM bytes and
collectives, each kernel op's cost formula, and the high-water mark of the
live tensors. The same step on the card under the same account gives the
same numbers (chip_smoke.py, phase 12).

A cell's step is the port's own: the train step of `train/steps.py` with the
reference's microbatch rule, the ZeRO-1 optimizer state and the ZeRO-2
gradient accumulator from the reference dry-run's ZeRO specs
(`sharding/rules.py`); `model.prefill`; or one `model.decode_step` on the
cell's cache (`models/registry.py::cache_specs`). The meshes are abstract,
each given a device mesh over PyTorch's testing `fake` process group,
whose collectives move no data: the data-parallel (4, 1) and (2, 4, 1) of
`launch/mesh.py::make_production_mesh`, the tensor-parallel (1, 4), and
(2, 4), one node of eight cards. On each, rank 0 holds the reference's
block of every leaf (`sharding/rules.py::model_shardings`): its "model"
block (`models/tensor_parallel.py`) and, where the specs put the data axes
on a dim, its block over them (FSDP and the experts,
`models/data_parallel.py`), gathered a layer at a time and reached by
the all-to-all. Each rank runs its share of the global batch (all of it
where the batch does not split) and MoE layers dispatch in one group a
rank, `dp_degree(mesh)` groups in all, as the reference's. Train cells run
rank 0's train step: its blocks of the params, the ZeRO-1 optimizer state
and the ZeRO-2 accumulator (over the data axes, where the mesh has one),
the forward's collectives, their replay under remat, the backward's and
the vocab-parallel loss's, and the optimizer's: arctic-480b's Adafactor
updates its ZeRO-1 blocks, and each of its statistics' means over a dim
that a data or "model" cut splits, and each unit's RMS and scale, sum over
the ranks of that cut (all-reduces, counted as every collective is).
Serving cells on a mesh with a data axis shard
the weights over it where the reference's `_serve_cfg` does
(`registry.serve_config`), and the record says `"serve_weights": "fsdp"`;
otherwise "tensor-parallel" on a "model" axis, "whole" without. The
hybrid's, the xLSTM's and whisper's cells on a "model" axis count their
TP's collectives too: a mamba2 block's gather of w_zx's product, the gated
norm's statistic, an mLSTM block's gather of w_up's product and its norm's
statistic, an sLSTM block's gather of its heads' h, whisper's column
gathers of heads that do not divide the axis; an xLSTM rank's cache holds
its heads of every state.

Records are JSON under build/dryrun/<tag>/<mesh>/<arch>__<shape>.json, with
the status `ok`, `skipped` (by `configs.shapes.applicable`) or `error` (the
exception's text). `memory.fits_80gb`
reads whether rank 0's high-water mark stays under the card's 80 GiB;
`memory.opt_gb` is rank 0's optimizer state (AdamW's ZeRO-1 moments,
Adafactor's ZeRO-1 statistics).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]    # 4x1 and 2x4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --one-card [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --tp [--force]     # 1x4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 2x4 [--force]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, active_param_count, param_count
from repro_torch.configs.shapes import ShapeConfig, applicable
from repro_torch.launch.mesh import (Mesh, dp_degree, make_mesh, make_production_mesh,
                                     tp_degree)
from repro_torch.models.registry import (build_model, cache_specs, input_specs, serve_config,
                                         shape_window)
from repro_torch.optim.optimizers import make_optimizer, warmup_cosine
from repro_torch.sharding.axes import rules_for
from repro_torch.sharding.rules import shardings_for
from repro_torch.train.steps import make_train_step, train_state
from repro_torch.tree import leaves

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
GIB = 2**30

# per-arch microbatch counts for train_4k (the reference's, memory-driven)
MICROBATCH = {
    "internvl2-76b": 16,
    "arctic-480b": 8,
    "qwen1.5-32b": 8,
    "stablelm-12b": 8,
    "granite-8b": 8,
    "llama3-8b": 8,
    "phi3.5-moe-42b-a6.6b": 8,
    "zamba2-2.7b": 4,
    "whisper-tiny": 2,
    "xlstm-350m": 2,
}

MESHES = {"1x1": Mesh((1, 1), ("data", "model")),
          "4x1": make_production_mesh(),
          "2x4x1": make_production_mesh(multi_pod=True),
          "1x4": Mesh((1, 4), ("data", "model")),
          "2x4": Mesh((2, 4), ("data", "model"))}


def mesh_name(mesh: Mesh) -> str:
    return "x".join(map(str, mesh.shape))


def rank_rows(global_batch: int, n: int) -> int:
    """Rows of the global batch that one of n data-parallel ranks runs: its
    share, or all of them where they do not split (the reference's
    divisibility guard replicates such a batch)."""
    return global_batch // n if global_batch % n == 0 else global_batch


@contextlib.contextmanager
def fake_group(world_size: int):
    """A process group of `world_size` ranks, this process rank 0, whose
    collectives move no data (PyTorch's testing "fake" backend): the train
    step's collectives reach the account as ops, with their shapes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(mesh: Mesh):
    """`mesh` with a device mesh over a fake process group of its size, so
    every axis and pair of axes has its group (`launch/mesh.py::group_over`)."""
    with fake_group(mesh.size):
        yield make_mesh(mesh.shape, mesh.axis_names, device="cpu")


@dataclasses.dataclass
class Account:
    """One step's account: the CostModel and the bytes it was called with
    (`argument`), the bytes of what it returned that it was not called with
    (`output`), the train state's parts (params, optimizer state, the
    ZeRO-2 accumulator of this rank), and on the card the allocator's peak
    over the step (`torch.cuda.max_memory_allocated`). `again()` runs the
    same step once more, outside the account (to time it)."""
    cost: roofline.CostModel
    argument_bytes: int
    output_bytes: int
    params_bytes: int
    opt_bytes: int = 0
    accum_bytes: int = 0
    allocator_peak_bytes: Optional[int] = None
    again: Any = None

    def memory(self) -> Dict[str, Any]:
        peak = self.cost.peak_bytes
        return {"argument_gb": self.argument_bytes / GIB, "output_gb": self.output_bytes / GIB,
                "params_gb": self.params_bytes / GIB, "opt_gb": self.opt_bytes / GIB,
                "accum_gb": self.accum_bytes / GIB, "peak_bytes": peak,
                "peak_per_device_gb": peak / GIB, "fits_80gb": bool(peak < roofline.HBM_BYTES)}


def _nbytes(tree) -> int:
    seen, n = set(), 0
    for t in leaves(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def accounted(fn, device, *held, **parts):
    """Run fn() under a CostModel of `device` that holds `held`; returns
    (its result, the Account)."""
    cuda = torch.device(device).type == "cuda"
    with roofline.CostModel(device) as cm:
        argument = cm.hold(*held)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = fn()
    held_ids = {id(t.untyped_storage()) for t in leaves(held)}
    fresh = [t for t in leaves(out) if isinstance(t, torch.Tensor)
             and id(t.untyped_storage()) not in held_ids]
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return out, Account(cm, argument, _nbytes(fresh), allocator_peak_bytes=peak, again=fn,
                        **parts)


def _generator(device) -> torch.Generator:
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(0)


def train_account(cfg: ModelConfig, batch: Dict[str, torch.Tensor], *, n_micro: int,
                  device, mesh: Optional[Mesh] = None,
                  generator: Optional[torch.Generator] = None, lr_fn=None):
    """The account of one train step of `cfg` on `batch` (the global batch)
    in `n_micro` microbatches, with the config's optimizer, on `device`.
    Without `mesh`: the single-process step. With `mesh` (and an initialised
    process group of its size): rank 0's step, with ZeRO-2 where the mesh
    has a data axis (the accumulator and the optimizer state sharded by the
    ZeRO specs of the mesh's rules, `rules_for`) and rank 0's blocks under
    a "model" axis. `lr_fn` replaces the reference dry-run's schedule
    (warmup_cosine(3e-4, 2000, 100000)). Returns (Account, the step's
    metrics)."""
    opt = make_optimizer(cfg.optimizer)
    model = build_model(cfg, device=device, mesh=mesh)
    params = model.init_params(generator or _generator(device))
    g_sh = None   # ZeRO over the data axes; a (1, n) TP mesh has none
    if mesh is not None and (tp_degree(mesh) == 1 or dp_degree(mesh) > 1):
        whole = build_model(cfg, device="meta").init_params(torch.Generator())
        g_sh = shardings_for(whole, cfg, mesh, rules_for(mesh), zero1=True)
    state = train_state(params, opt, g_sh, model.split)
    step = make_train_step(model, opt, lr_fn or warmup_cosine(3e-4, 2000, 100000),
                           n_microbatches=n_micro, grad_shardings=g_sh, mesh=mesh)
    accum = 4 * sum(p.numel() for p in leaves(params)) if g_sh is None else \
        4 * sum(p[b].numel() for p, b in zip(leaves(params), g_sh.local_index(params, 0))
                if b is not None)
    (_, metrics), acct = accounted(lambda: step(state, batch), device, state, batch,
                              params_bytes=_nbytes(state["params"]),
                              opt_bytes=_nbytes(state["opt"]), accum_bytes=accum)
    return acct, metrics


def prefill_account(cfg: ModelConfig, batch: Dict[str, torch.Tensor], *, device,
                    window: Optional[int] = None, generator: Optional[torch.Generator] = None,
                    mesh: Optional[Mesh] = None):
    """The account of `model.prefill` of `batch` on `device`, whole weights
    or, under a tensor-parallel `mesh` (and an initialised process group of
    its size), this rank's blocks. Returns (Account, (logits, cache))."""
    model = build_model(cfg, device=device, window=window, mesh=mesh)
    params = model.init_params(generator or _generator(device))
    def prefill():
        with torch.no_grad():
            return model.prefill(params, batch)
    return accounted(prefill, device, params, batch, params_bytes=_nbytes(params))[::-1]


def decode_account(cfg: ModelConfig, batch: Dict[str, torch.Tensor], cache, *, device,
                   generator: Optional[torch.Generator] = None, mesh: Optional[Mesh] = None):
    """The account of one `model.decode_step` of `batch` on `cache` (updated
    in place) on `device`, whole weights or, under a tensor-parallel `mesh`,
    this rank's blocks and a cache of its heads. Returns (Account, logits)."""
    model = build_model(cfg, device=device, mesh=mesh)
    params = model.init_params(generator or _generator(device))
    def decode():
        with torch.no_grad():
            return model.decode_step(params, cache, batch)[0]
    return accounted(decode, device, params, cache, batch, params_bytes=_nbytes(params))[::-1]


def _rank_batch(specs: Dict[str, torch.Tensor], rows: int) -> Dict[str, torch.Tensor]:
    return {k: torch.empty((rows, *v.shape[1:]), dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def account_cell(arch: str, shape_name: str, mesh: Mesh,
                 overrides: Optional[Dict[str, Any]] = None):
    """Rank 0's account of one cell on `mesh`, on the meta device (the
    counterpart of the reference's `lower_cell`). `overrides`: "smoke"
    (the SMOKE config), "config" (ModelConfig fields) and "shape"
    (ShapeConfig fields), the tests' cut of a cell. Returns (Account, meta)."""
    overrides = overrides or {}
    cfg = get_config(arch, smoke=overrides.get("smoke", False)).replace(
        **overrides.get("config", {}))
    shape = dataclasses.replace(SHAPES[shape_name], **overrides.get("shape", {}))
    n, tp = dp_degree(mesh), tp_degree(mesh)
    if n * tp != mesh.size:
        raise ValueError(f"mesh {mesh.shape} has axes other than the data and model axes")
    window = shape_window(cfg, shape)
    specs = input_specs(cfg, shape)
    meta: Dict[str, Any] = {"mesh": mesh_name(mesh), "n_devices": mesh.size, "dp": n}
    if shape.kind == "train":
        mb = MICROBATCH.get(arch, 4)
        # each microbatch must still cover every DP shard (>=1 seq/shard)
        mb = max(1, min(mb, shape.global_batch // n))
        meta["microbatches"] = mb
        with fake_mesh(mesh) as m:
            acct, _ = train_account(cfg, specs, n_micro=mb, device="meta", mesh=m)
        return acct, meta
    rows = rank_rows(shape.global_batch, n)
    cfg = serve_config(cfg) if n > 1 else cfg
    meta.update(rank_rows=rows, tp=tp, serve_weights="fsdp" if n > 1 and cfg.fsdp
                else "tensor-parallel" if tp > 1 else "whole")
    batch = _rank_batch(specs, rows)
    if mesh.size == 1:
        if shape.kind == "prefill":
            acct, _ = prefill_account(cfg, batch, device="meta", window=window)
        else:
            cache = cache_specs(cfg, shape, window=window, batch=rows)
            acct, _ = decode_account(cfg, batch, cache, device="meta")
        return acct, meta
    with fake_mesh(mesh) as m:
        if shape.kind == "prefill":
            acct, _ = prefill_account(cfg, batch, device="meta", window=window, mesh=m)
        else:
            cache = build_model(cfg, device="meta", window=window, mesh=m).init_cache(
                rows, shape.seq_len)
            acct, _ = decode_account(cfg, batch, cache, device="meta", mesh=m)
    return acct, meta


def analyze(acct: Account, cfg: ModelConfig, shape: ShapeConfig,
            n_devices: int) -> Dict[str, Any]:
    """The reference's record, field for field where the field has a
    meaning here."""
    cost = acct.cost.totals
    terms = roofline.roofline_terms(cost)
    mf = roofline.model_flops(cfg, shape)
    flops_global = cost.flops * n_devices
    return {
        "memory": acct.memory(),
        "roofline": {
            **terms,
            "dominant": roofline.dominant_term(terms),
            "roofline_fraction": roofline.roofline_fraction(terms),
            "model_flops_global": mf,
            "flops_global": flops_global,
            "useful_ratio": mf / flops_global if flops_global else 0.0,
            "transcendentals": cost.transcendentals,
            "collectives": cost.collectives,
        },
        "kernels": dict(acct.cost.kernels),
    }


def run_cell(arch: str, shape_name: str, mesh: Mesh, force: bool = False,
             overrides: Optional[Dict[str, Any]] = None, tag: str = "baseline",
             out_dir: Path = OUT_DIR) -> Dict[str, Any]:
    name = mesh_name(mesh)
    cell_dir = out_dir / tag / name
    cell_dir.mkdir(parents=True, exist_ok=True)
    out_file = cell_dir / f"{arch}__{shape_name}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())

    cfg = get_config(arch, smoke=(overrides or {}).get("smoke", False)).replace(
        **(overrides or {}).get("config", {}))
    shape = dataclasses.replace(SHAPES[shape_name], **(overrides or {}).get("shape", {}))
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": name, "tag": tag,
        "params": param_count(cfg), "active_params": active_param_count(cfg),
    }
    reason = None
    if not applicable(cfg.family, cfg.sub_quadratic, shape_name):
        reason = f"long_500k requires sub-quadratic attention; {arch} is full-attention"
    if reason:
        record["status"] = "skipped"
        record["reason"] = reason
        out_file.write_text(json.dumps(record, indent=1))
        print(f"SKIP {arch} x {shape_name}: {record['reason']}")
        return record
    try:
        t0 = time.time()
        acct, meta = account_cell(arch, shape_name, mesh, overrides)
        record.update(meta)
        record.update(analyze(acct, cfg, shape, n_devices=mesh.size))
        record["status"] = "ok"
        record["account_s"] = time.time() - t0
        r, m = record["roofline"], record["memory"]
        print(f"OK   {arch} x {shape_name} [{name}] "
              f"mem={m['peak_per_device_gb']:.2f}GiB fits_80gb={m['fits_80gb']} "
              f"terms(c/m/x)={r['compute_s']:.3e}/{r['memory_s']:.3e}/"
              f"{r['collective_s']:.3e}s dom={r['dominant']} "
              f"frac={r['roofline_fraction']:.3f} ({record['account_s']:.1f}s)")
    except Exception as e:   # a failed cell is recorded, and the sweep goes on
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()
        print(f"FAIL {arch} x {shape_name} [{name}]: {record['error']}")
    out_file.write_text(json.dumps(record, indent=1))
    return record


def main():
    ap = argparse.ArgumentParser(description="the memory and FLOP account of every cell")
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="two nodes of four: 2x4x1")
    ap.add_argument("--both-meshes", action="store_true", help="4x1 and 2x4x1")
    ap.add_argument("--one-card", action="store_true", help="1x1 too")
    ap.add_argument("--tp", action="store_true", help="the tensor-parallel 1x4 mesh")
    ap.add_argument("--mesh", action="append", choices=list(MESHES),
                    help="these meshes only (repeatable)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args()
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["1x1"] if args.one_card else []
    if args.both_meshes:
        meshes += ["4x1", "2x4x1"]
    elif args.multi_pod:
        meshes.append("2x4x1")
    elif not (args.one_card or args.tp):
        meshes += ["4x1", "2x4"]
    if args.tp:
        meshes.append("1x4")
    if args.mesh:
        meshes = list(args.mesh)
    n_ok = n_fail = 0
    for m in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, MESHES[m], force=args.force, tag=args.tag)
                if rec["status"] == "error":
                    n_fail += 1
                else:
                    n_ok += 1
    print(f"\ndone: {n_ok} ok/skip, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
