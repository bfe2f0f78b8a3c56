"""The work counts (``bench/work.py`` and ``bench/arch/dense_gqa.py``)
against values worked out by hand, and the decode mix's lengths and order,
which are fixed."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import work  # noqa: E402
from bench.arch import dense_gqa  # noqa: E402

SMOLLM = json.loads((ROOT / "bench/configs/smollm-360m.json").read_text())
YI = json.loads((ROOT / "bench/configs/yi-9b.json").read_text())
DECODE = json.loads((ROOT / "bench/mixes/batch-decode.json").read_text())
BASE = [[64, 74], [116, 57], [258, 39], [570, 34], [211, 185], [43, 211],
        [173, 240], [35, 110], [383, 44], [142, 65], [695, 97], [78, 50],
        [467, 85], [53, 162], [314, 125], [95, 143]]


def quantiles(lo, hi, n):
    return [round(lo * (hi / lo) ** ((i + 0.5) / n)) for i in range(n)]


def test_matmul_weights():
    # 32 x (960 x 25 x 64 + 960 x 960 + 3 x 960 x 2560) + 960 x 49152
    assert dense_gqa.matmul_weights(SMOLLM) == 361_758_720
    # 48 x (4096 x 40 x 128 + 4096 x 4096 + 3 x 4096 x 11008) + 4096 x 64000
    assert dense_gqa.matmul_weights(YI) == 8_566_865_920


def test_causal_pairs():
    assert work.causal_pairs(3, 3) == 6
    assert work.causal_pairs(3, 5) == 3 + 4 + 5
    assert work.causal_pairs(2048, 2048) == 2_098_176


def test_train_step_flops():
    # 6 N T + 3 x 4 x B x H x S(S+1)/2 x d x L: 41.75 and 47.93 TFLOP
    assert dense_gqa.train_step_flops(SMOLLM, 8, 2048) == (
        6 * 361_758_720 * 16384 + 3 * 4 * 8 * 15 * 2_098_176 * 64 * 32)
    assert dense_gqa.train_step_flops(SMOLLM, 8, 2048) == pytest.approx(
        41.75e12, rel=1e-3)
    assert dense_gqa.train_step_flops(SMOLLM, 4, 4096) == pytest.approx(
        47.93e12, rel=1e-3)


def test_prefill_flops_and_flash_work():
    # layers on every token, the head on the last, the causal attention
    assert dense_gqa.prefill_flops(YI, 1000) == (
        2 * 48 * 173_015_040 * 1000 + 2 * 262_144_000
        + 4 * 32 * 500_500 * 128 * 48)
    nbytes, ops = work.flash_work((1, 32, 2048, 128), (1, 4, 2048, 128),
                                  True, 2)
    assert nbytes == (2 * 32 * 2048 * 128 + 2 * 4 * 2048 * 128) * 2
    assert ops == 4 * 32 * 2_098_176 * 128
    assert dense_gqa.prefill_flash_bound_s(YI, 2048) == pytest.approx(
        48 * ops / 989.4e12)


def test_decode_least_time():
    reqs = DECODE["requests"]
    assert sum(n for _, n in reqs) == 32 * 1721 == 55_072
    # 55,072 tokens over 256 slots take 216 steps, the longest output 240
    assert work.least_decode_steps((n for _, n in reqs), 256) == 240
    assert work.least_decode_steps((n for _, n in BASE), 8) == 240
    # 240 steps of 17.13 GB of bf16 weights at 3.35 TB/s, then the cache
    # (55,072 tokens over 400 positions on average, 98,304 B each: about
    # 0.65 s) and the 512 inserts (each reads the weights: about 2.6 s)
    step = 2 * 8_566_865_920 / 3.35e12
    assert dense_gqa.step_weight_bytes(YI) == 2 * 8_566_865_920
    least = work.batch_generate_least_s(YI, reqs, 256)
    assert 240 * step + 512 * step < least < 240 * step + 512 * step + 1.0
    assert dense_gqa.cache_bytes_per_position(YI) == 48 * 2 * 4 * 128 * 2
    # one token over 1000 positions: the weights twice, the attention
    assert dense_gqa.decode_flops(YI, 1000) == (
        2 * 8_566_865_920 + 4 * 32 * 128 * 48 * 1000)


def test_decode_mix_is_fixed():
    reqs = DECODE["requests"]
    assert sorted(p for p, _ in BASE) == quantiles(32, 768, 16)
    assert sorted(n for _, n in BASE) == quantiles(32, 256, 16)
    assert sorted(reqs) == sorted(BASE * 32)
    # the frozen order, not a draw at run time
    assert reqs[:4] == [[53, 162], [258, 39], [570, 34], [78, 50]]
    assert reqs[-2:] == [[43, 211], [173, 240]]
    assert all(p + n <= DECODE["max_len"] for p, n in reqs)
    assert len(reqs) == 2 * DECODE["batch"]
