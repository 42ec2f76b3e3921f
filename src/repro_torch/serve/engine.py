"""Continuous-batching serving engine, PyTorch.

The port of the JAX package's `serve/engine.py::ServeEngine`, with the same
semantics and the surface the router duck-types (`add_request`, `tick`,
`pop_completed`, `run_until_drained`, `free_slots`, `queue_len`,
`outstanding_tokens`, `stats`):
  * B decode slots over one static KV cache;
  * new requests are prefilled one at a time, unpadded; the first output
    token is the argmax of the prefill logits, and the request's cache is
    copied into a free slot (zeros past the prompt);
  * every tick decodes all B slots in one batched step, free ones included,
    and advances every slot's position;
  * a request finishes at its token budget, at its EOS token, or when its
    slot's position reaches max_len - 1.
The serving path runs under `torch.inference_mode()`. Slot positions and
the tokens of a tick stay on the device; the host reads both once per tick.

`StubEngine` is the port of the JAX engine's model-free reference engine:
ServeEngine's admission semantics and surface, each request's output a pure
function of its prompt (`stub_output`), no model, device or tensor. The
router, the simulator's cost model and hosts without a card drive it.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.registry import Model


@dataclass
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: int = -1          # -1: never
    output: List[int] = field(default_factory=list)
    done: bool = False


class _Slots:
    """The admission surface both engines share: B slots, a queue, the
    requests completed since the last pop, and what the router reads of
    them."""

    def __init__(self, batch_slots: int, max_len: int):
        self.B = batch_slots
        self.max_len = max_len
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.queue: "collections.deque[Request]" = collections.deque()
        self._completed: List[Request] = []
        self.stats = {"ticks": 0, "prefills": 0, "decoded_tokens": 0,
                      "completed": 0}

    def add_request(self, req: Request):
        self.queue.append(req)

    @property
    def free_slots(self) -> int:
        """Decode slots with no active request, net of queued requests that
        will claim one at the next tick."""
        empty = sum(1 for r in self.slot_req if r is None)
        return max(0, empty - len(self.queue))

    @property
    def queue_len(self) -> int:
        return len(self.queue)

    @property
    def outstanding_tokens(self) -> int:
        """Tokens still owed to admitted requests: queued requests' full
        budgets plus active slots' remaining budgets."""
        owed = sum(r.max_new_tokens for r in self.queue)
        owed += sum(r.max_new_tokens - len(r.output)
                    for r in self.slot_req if r is not None)
        return owed

    def pop_completed(self) -> List[Request]:
        """Requests finished since the last pop (the router's per-tick
        harvest)."""
        out, self._completed = self._completed, []
        return out

    def run_until_drained(self, max_ticks: int = 10000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.tick()
        return self.pop_completed()


class ServeEngine(_Slots):
    def __init__(self, model: Model, params, batch_slots: int, max_len: int,
                 *, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is built for {model.device}, engine asked "
                             f"for {self.device}")
        super().__init__(batch_slots, max_len)
        self.model = model
        self.params = params
        with torch.inference_mode():
            self.cache = model.init_cache(batch_slots, max_len)
            self.positions = torch.zeros(batch_slots, dtype=torch.int32,
                                         device=self.device)
            self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                      device=self.device)

    @torch.inference_mode()
    def _fill_free_slots(self):
        for slot in range(self.B):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = torch.tensor([req.prompt], dtype=torch.int32,
                                  device=self.device)
            logits, pcache = self.model.prefill(self.params, {"tokens": prompt})
            next_tok = int(torch.argmax(logits[0, -1]))
            req.output.append(next_tok)
            self._scatter_cache(pcache, slot, len(req.prompt))
            self.positions[slot] = len(req.prompt)
            self.tokens[slot, 0] = next_tok
            self.slot_req[slot] = req
            self.stats["prefills"] += 1

    def _scatter_cache(self, pcache, slot: int, plen: int):
        """Copy a one-sequence prefill cache into batch slot `slot`; the rows
        past the prompt are zeroed, as the JAX engine pads them."""
        for name, big in self.cache.items():
            big[:, slot, :plen] = pcache[name][:, 0].to(big.dtype)
            big[:, slot, plen:] = 0

    # -- the decode tick -----------------------------------------------------------

    @torch.inference_mode()
    def tick(self) -> int:
        """One engine iteration; returns the number of active slots decoded."""
        self._fill_free_slots()
        active = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not active:
            return 0
        batch = {"tokens": self.tokens, "positions": self.positions}
        logits, self.cache = self.model.decode_step(self.params, self.cache, batch)
        next_tokens = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        self.positions = self.positions + 1
        self.tokens = next_tokens[:, None]
        # one device-to-host read per tick for the slot bookkeeping
        host_tokens, host_pos = torch.stack([next_tokens, self.positions]).tolist()
        self.stats["ticks"] += 1
        for s in active:
            req = self.slot_req[s]
            tok = host_tokens[s]
            req.output.append(tok)
            self.stats["decoded_tokens"] += 1
            limit = len(req.output) >= req.max_new_tokens
            if tok == req.eos_id or limit or host_pos[s] >= self.max_len - 1:
                req.done = True
                self.slot_req[s] = None
                self._completed.append(req)
                self.stats["completed"] += 1
        return len(active)


class StubEngine(_Slots):
    """Model-free engine with ServeEngine's admission semantics (B slots, a
    queue, completion at each tick) and duck-typed surface, for the router,
    the simulator's cost model and hosts without a card.

    Deterministic: a request's output is a pure function of its prompt
    (`stub_output`), so routing a stream over K replicas gives every request
    the tokens one local engine gives it. Each tick decodes one token a
    busy slot, as the batched decode step does. `max_len` is kept for the
    surface; no token limit reads it."""

    def __init__(self, batch_slots: int, max_len: int = 1 << 30):
        super().__init__(batch_slots, max_len)

    @staticmethod
    def stub_output(prompt: List[int], n: int) -> List[int]:
        """The deterministic "model": token i is a rolling digest of the
        prompt, the same on every replica."""
        acc = 1469598103
        for t in prompt:
            acc = (acc * 16777619 + int(t)) & 0x7FFFFFFF
        out = []
        for _ in range(n):
            acc = (acc * 16777619 + 13) & 0x7FFFFFFF
            out.append(acc % 50_000)
        return out

    def _fill_free_slots(self):
        for slot in range(self.B):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            # the prefill emits the first token, as ServeEngine's does
            req.output.append(self.stub_output(req.prompt, len(req.output) + 1)[-1])
            self.slot_req[slot] = req
            self.stats["prefills"] += 1

    def tick(self) -> int:
        """One engine iteration; returns the number of active slots decoded."""
        self._fill_free_slots()
        active = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not active:
            return 0
        self.stats["ticks"] += 1
        for s in active:
            req = self.slot_req[s]
            tok = self.stub_output(req.prompt, len(req.output) + 1)[-1]
            req.output.append(tok)
            self.stats["decoded_tokens"] += 1
            if tok == req.eos_id or len(req.output) >= req.max_new_tokens:
                req.done = True
                self.slot_req[s] = None
                self._completed.append(req)
                self.stats["completed"] += 1
        return len(active)
