"""Rank bodies for tests/test_torch_backends.py: each runs on every rank that
`repro_torch.distributed.spawn` starts (gloo on the CPU) and returns plain
values, gathered by rank."""
from __future__ import annotations

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.trainer import Preempted, Trainer, TrainerConfig


def flag_one_rank(rank, world, dev, directory, flag_rank, flag_at, steps):
    """The Trainer on a (world, 1) mesh (llama3-8b SMOKE, fp32, ZeRO-2),
    where rank `flag_rank` alone requests preemption during step `flag_at`:
    the step this rank stopped at (None: it ran to the end) and the latest
    checkpoint it sees."""
    cfg = get_config("llama3-8b", smoke=True).replace(param_dtype="float32")
    mesh = make_mesh((world, 1), ("data", "model"), device=dev)

    def hook(step):
        if rank == flag_rank and step == flag_at:
            trainer.request_preemption()

    trainer = Trainer(build_model(cfg, device=dev, mesh=mesh), make_optimizer("adamw"),
                      TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                               global_batch=4, seed=1)),
                      Checkpointer(directory),
                      TrainerConfig(num_steps=steps, ckpt_every=100, log_every=1,
                                    n_microbatches=2), failure_hook=hook)
    try:
        trainer.run(trainer.init_or_restore(0))
        stopped = None
    except Preempted as e:
        stopped = e.step
    trainer.ckpt.wait()
    return {"stopped": stopped, "latest": trainer.ckpt.latest_step(),
            "steps_run": [h["step"] for h in trainer.history]}
