"""Cost formulas of the kernels: the FLOPs and the HBM bytes (each input
read once, each output written once) of one call, from its shapes alone.
The single source of the kernels' bounds: `ops.COSTS` gives them to the
dry-run's account (`roofline.CostModel`) for each kernel op, and
chip_smoke.py prints the bounds they give (`roofline.bound`). Plain Python,
no torch: tools/chip_ab.py loads this file beside another checkout's
package."""
from __future__ import annotations

from typing import Optional, Tuple


def attention_pairs(Tq: int, Tk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs that attention with query row i at key position i
    covers: key k of query i counts where k <= i (causal) and k > i - window
    (window), 0 <= k < Tk."""
    if not causal and window is None:
        return Tq * Tk
    if window is None and Tq <= Tk:
        return Tq * (Tq + 1) // 2
    return sum(max(0, (min(i, Tk - 1) if causal else Tk - 1)
                   - (max(0, i - window + 1) if window else 0) + 1) for i in range(Tq))


def flash_cost(B: int, Hq: int, Hkv: int, Tq: int, Tk: int, D: int, *, causal: bool = True,
               window: Optional[int] = None, itemsize: int = 2,
               lse: bool = False) -> Tuple[int, int]:
    """(FLOPs, bytes) of flash attention: two products of 2 D FLOPs a
    (query, key) pair and head; q, k, v and the output once, and the fp32
    lse when written."""
    flops = 4 * B * Hq * D * attention_pairs(Tq, Tk, causal, window)
    nbytes = itemsize * B * D * (2 * Hq * Tq + 2 * Hkv * Tk) + (4 * B * Hq * Tq if lse else 0)
    return flops, nbytes


def decode_cost(B: int, Hq: int, Hc: int, S: int, D: int, *, rows: Optional[int] = None,
                q_itemsize: int = 2, cache_itemsize: int = 2,
                scales: bool = False) -> Tuple[int, int]:
    """(FLOPs, bytes) of one query token a sequence over `rows` valid cache
    rows in all (default every row, B S: what a call can need when its
    valid lengths are not read, as the dry-run's account cannot): k and v
    of those rows (with their fp32 scales for an int8 cache), q, the output
    and valid_len once."""
    rows = B * S if rows is None else rows
    flops = 4 * Hq * D * rows
    nbytes = (2 * rows * Hc * (D * cache_itemsize + (4 if scales else 0))
              + 2 * B * Hq * D * q_itemsize + 4 * B)
    return flops, nbytes


def gmm_cost(E: int, M: int, K: int, N: int, itemsize: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of out (E, M, N) = A (E, M, K) @ B (E, K, N), each of
    moe_gmm's three products: A, B and out once."""
    return 2 * E * M * K * N, itemsize * E * (M * K + K * N + M * N)


def ssd_cost(B: int, H: int, T: int, P: int, G: int, N: int, Q: int,
             itemsize: int = 4) -> Tuple[int, int]:
    """(FLOPs, bytes) of the chunked SSD scan: per chunk of Q steps the
    causal half of C B^T and of its product with x, and the state's two
    products; x, B, C and y in the inputs' type, dt, A and the final state
    in fp32, each once."""
    pairs = Q * (Q + 1) // 2
    flops = B * H * (T // Q) * (2 * pairs * (N + P) + 4 * Q * N * P)
    nbytes = (itemsize * (2 * B * H * T * P + 2 * B * G * T * N)
              + 4 * (B * H * T + B * H * P * N + H))
    return flops, nbytes
