"""Training example of the PyTorch/CUDA port: data pipeline -> train loop ->
async checkpoints -> restart-safe, dispatched as a Syndeo job (the twin of
examples/train_llm.py, with the same presets).

    PYTHONPATH=src python examples/train_torch.py                     # on the card
    PYTHONPATH=src python examples/train_torch.py --device cpu        # plain PyTorch path
    PYTHONPATH=src python examples/train_torch.py --preset 100m --steps 300 --no-cluster

demo: a ~1M-param llama-family model, 40 steps.
100m: a ~100M-param model, a few hundred steps.
Through the cluster the job asks for one GPU ({"gpu": 1.0}) where the JAX
example asks for a TPU slice; --no-cluster runs it inline.
"""
import argparse
import os
import tempfile
import threading
import time

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves

PRESETS = {
    "demo": dict(d_model=128, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=512,
                 vocab=2048, seq=128, batch=8, steps=40),
    "100m": dict(d_model=640, n_layers=12, n_heads=10, n_kv_heads=5,
                 d_ff=2560, vocab=32000, seq=512, batch=8, steps=300),
}


def make_cfg(preset) -> ModelConfig:
    p = PRESETS[preset]
    return ModelConfig(
        name=f"llm-{preset}", family="dense", n_layers=p["n_layers"],
        d_model=p["d_model"], n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
        d_ff=p["d_ff"], vocab_size=p["vocab"])


def train_job(preset: str, steps: int, ckpt_dir: str, seed: int = 0, device: str = "cuda"):
    """The unit the Syndeo scheduler dispatches to a GPU."""
    p = PRESETS[preset]
    cfg = make_cfg(preset)
    model = build_model(cfg, device=device)
    opt = make_optimizer("adamw")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=p["seq"], global_batch=p["batch"],
                                    seed=seed))
    tcfg = TrainerConfig(num_steps=steps or p["steps"], ckpt_every=20,
                         log_every=5, n_microbatches=2)
    trainer = Trainer(model, opt, pipe, Checkpointer(ckpt_dir), tcfg)
    if threading.current_thread() is threading.main_thread():
        trainer.install_signal_handler()   # a cluster worker's thread cannot take signals
    t0 = time.time()
    state = trainer.run(trainer.init_or_restore(seed=seed))
    return {"params": sum(t.numel() for t in leaves(state["params"])),
            "history": trainer.history, "wall_s": time.time() - t0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="demo", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; cuda without a card raises")
    ap.add_argument("--no-cluster", action="store_true",
                    help="run the job inline instead of via Syndeo")
    args = ap.parse_args()

    if args.no_cluster:
        out = train_job(args.preset, args.steps, args.ckpt_dir, device=args.device)
    else:
        from repro.core import SyndeoCluster   # the orchestration runtime; no JAX
        with SyndeoCluster() as c:
            c.add_worker(resources={"cpu": 1.0, "gpu": 1.0})
            job = c.submit(train_job, args.preset, args.steps, args.ckpt_dir,
                           device=args.device, resources={"gpu": 1.0}, group="train",
                           max_retries=2)   # restarts resume from checkpoint
            out = c.get(job, timeout=36000)

    print(f"model: {out['params']:,} params; wall {out['wall_s']:.1f}s")
    for rec in out["history"]:
        print(f"  step {rec['step']:4d} loss {rec['loss']:.4f} "
              f"lr {rec['lr']:.2e} gnorm {rec['grad_norm']:.2f}")
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
