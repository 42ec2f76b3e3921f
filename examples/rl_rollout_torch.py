"""The paper's experiment on the PyTorch/CUDA port: RL rollout actors
(tensor environments and MLP policies stepped on the card) collected through
the Syndeo scheduler, with throughput reported for the worker count (the
twin of examples/rl_rollout.py's local part).

    PYTHONPATH=src python examples/rl_rollout_torch.py [--env Cartpole]     # on the card
    PYTHONPATH=src python examples/rl_rollout_torch.py --device cpu         # plain PyTorch

The paper-scale sweep of examples/rl_rollout.py (Tables I/II under virtual
time) is left out: benchmarks/paper_tables.py imports the JAX package's
`repro.rl.envs`, and so JAX. The cluster is the JAX package's threaded
`repro.core.SyndeoCluster`, which has no JAX in it, imported when the
example runs; the port itself imports nothing of the JAX package.
"""
import argparse

from repro_torch.rl.rollout import run_benchmark_local


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="Cartpole")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; cuda without a card raises")
    args = ap.parse_args()

    from repro.core import SyndeoCluster   # the orchestration runtime; no JAX
    # real rollouts on the threaded local backend; the scheduler and object
    # store path is the one a multi-node run takes
    with SyndeoCluster() as c:
        for _ in range(args.workers):
            c.add_worker()
        tput, stats = run_benchmark_local(c, args.env, args.workers, args.steps,
                                          device=args.device)
        print(f"[local] {args.env} on {args.device}: {tput:,.0f} interactions/s over "
              f"{stats['n_tasks']} actors ({stats['wall_s']:.2f}s wall)")
        print(f"[local] object-store transfers: {c.store.stats}")


if __name__ == "__main__":
    main()
