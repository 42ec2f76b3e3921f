"""Serving example of the PyTorch/CUDA port: the continuous-batching engine
on a small LM (the twin of examples/serve.py).

    PYTHONPATH=src python examples/serve_torch.py                # on the card
    PYTHONPATH=src python examples/serve_torch.py --device cpu   # plain PyTorch path
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; cuda without a card raises")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init_params(gen)
    engine = ServeEngine(model, params, batch_slots=4, max_len=64,
                         device=args.device)

    prompts = [[1, 5, 9], [2, 4], [7, 7, 7, 7], [3], [8, 1, 2], [9, 9]]
    reqs = [Request(id=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    t0 = time.time()
    for r in reqs:
        engine.add_request(r)
    engine.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    for r in reqs:
        print(f"req {r.id}: prompt={r.prompt} -> {r.output}")
    s = engine.stats
    print(f"\n{s['completed']} requests, {s['decoded_tokens']} tokens in "
          f"{dt:.2f}s on {model.device.type} ({s['decoded_tokens'] / dt:.1f} tok/s, "
          f"{s['ticks']} engine ticks, {s['prefills']} prefills)")
    assert all(r.done for r in reqs)


if __name__ == "__main__":
    main()
