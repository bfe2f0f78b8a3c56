"""The yardstick's common part: the H100's published peaks, and the
arithmetic that does not depend on an architecture.  What does (leaf
shapes, a step's or a prefill's work) is in ``bench/arch/<architecture>.py``.

``flash_work`` is a frozen copy of ``chip_smoke.flash_work``'s arithmetic.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, Sequence, Tuple

from bench import arch

#: NVIDIA H100 SXM data sheet, dense bf16 tensor-core rate at 700 W
PEAK_BF16_FLOPS = 989.4e12
#: NVIDIA H100 SXM data sheet, HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def causal_pairs(sq: int, skv: int) -> int:
    """Visible (row, column) pairs of a causal mask aligned bottom-right:
    row r sees columns up to r + skv - sq."""
    if sq <= skv:
        return sq * (skv - sq) + sq * (sq + 1) // 2
    return skv * (skv + 1) // 2


def least_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_work(q_shape: Sequence[int], kv_shape: Sequence[int], causal: bool,
               itemsize: int) -> Tuple[int, int]:
    """(bytes, operations) one attention call needs: q, k and v read once,
    o written once; two products of 2 operations per visible (row,
    column) pair and head dim, counted with this call's causal mask."""
    b, hq, sq, d = q_shape
    hkv, skv = kv_shape[1], kv_shape[2]
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * itemsize
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    return nbytes, 4 * b * hq * pairs * d


def least_decode_steps(outputs: Iterable[int], batch: int) -> int:
    """The fewest decode steps any admission order allows: every token
    takes a slot for one step, and a request's tokens take one step
    each."""
    outputs = list(outputs)
    return max(math.ceil(sum(outputs) / batch), max(outputs))


def batch_generate_least_s(cfg: Mapping,
                           requests: Sequence[Tuple[int, int]],
                           batch: int) -> float:
    """The least time of one continuous-batching call over ``requests``
    [(prompt length, output length), ...]: each insert's prefill of the
    prompt but its last token, then the decode.

    A decode step reads the bf16 weights once and each live position's
    cache; the fewest steps are :func:`least_decode_steps`.  The sum of
    the steps' bounds is at least the larger of the summed operations and
    the summed bytes over the chip's rates, which is what is counted."""
    a = arch.load(cfg)
    per_pos = a.cache_bytes_per_position(cfg)
    total = 0.0
    flops = nbytes = 0
    for prompt, out in requests:
        length = prompt - 1
        if length > 0:
            total += least_s(a.prefill_flops(cfg, length),
                             a.step_weight_bytes(cfg) + length * per_pos)
        # token t of the request attends to prompt + t positions
        for t in range(out):
            flops += a.decode_flops(cfg, prompt + t)
        nbytes += per_pos * (out * prompt + out * (out - 1) // 2)
    steps = least_decode_steps((out for _, out in requests), batch)
    nbytes += steps * a.step_weight_bytes(cfg)
    return total + least_s(flops, nbytes)
