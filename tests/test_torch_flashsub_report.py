"""The port's flash substitution and report — twin of
``tests/test_flashsub_report.py``, held to the reference in-process (both
modules import no JAX): ``attn_shape_for`` and ``flash_terms`` equal the
reference's for every configuration of the registry (the terms are
analytic and do not depend on the card), ``roofline_table`` and
``summarize`` give the same text from both packages on the same records,
and ``substitute`` adds the terms under the H100's constants."""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json
import os

import pytest

from repro.launch import flashsub as ref_flashsub
from repro.launch import report as ref_report
from repro.models.registry import ARCHS as REF_ARCHS
from repro.models.registry import get as ref_get
from repro_torch.launch import roofline
from repro_torch.launch.flashsub import (
    AttnShape, attn_shape_for, flash_terms, substitute,
)
from repro_torch.launch.report import load_records, roofline_table, summarize
from repro_torch.launch.roofline import Roofline
from repro_torch.models.registry import ARCHS, get

CALLS = [("train", 4096, 256), ("prefill", 32768, 32), ("decode", 32768, 128)]


def test_flash_terms_scaling():
    a = AttnShape(layers=2, batch_global=8, heads=4, head_dim=64, seq=1024)
    f1, b1 = flash_terms(a, chips=1)
    f256, b256 = flash_terms(a, chips=256)
    assert f1 / f256 == 256 and b1 / b256 == 256
    a2 = AttnShape(layers=2, batch_global=8, heads=4, head_dim=64, seq=2048)
    f2, b2 = flash_terms(a2, 1)
    assert abs(f2 / f1 - 4.0) < 1e-6
    assert abs(b2 / b1 - 2.0) < 1e-6


def test_attn_shape_per_family():
    assert attn_shape_for(get("falcon-mamba-7b"), "train", 4096, 256) is None
    assert attn_shape_for(get("zamba2-2.7b"), "train", 4096, 256).layers == 9
    d = attn_shape_for(get("deepseek-v2-lite-16b"), "train", 4096, 256)
    assert d.head_dim == 128 + 64
    assert attn_shape_for(get("yi-9b"), "prefill", 32768, 32).passes_flops \
        == 1.0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_attn_shape_and_terms_equal_the_references(arch):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for mode, seq, gbatch in CALLS:
        mine = attn_shape_for(get(arch), mode, seq, gbatch)
        theirs = ref_flashsub.attn_shape_for(ref_get(arch), mode, seq, gbatch)
        if theirs is None:
            assert mine is None
            continue
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        for chips in (1, 256, 512):
            assert flash_terms(mine, chips) == ref_flashsub.flash_terms(
                theirs, chips)


def test_substitute_adds_terms_under_the_h100_constants():
    stub = Roofline(flops=1e12, bytes_accessed=1e11, collective_bytes=1e9,
                    collectives={}, model_flops=1e15, chips=256)
    a = AttnShape(layers=4, batch_global=32, heads=8, head_dim=128, seq=4096)
    out = substitute(stub, a)
    f, b = flash_terms(a, 256)
    assert out.flops == stub.flops + f
    assert out.bytes_accessed == stub.bytes_accessed + b
    assert out.collective_bytes == stub.collective_bytes
    assert out.t_compute == out.flops / 989.4e12
    assert out.t_memory == out.bytes_accessed / 3.35e12
    assert out.t_collective == out.collective_bytes / 50e9
    assert substitute(stub, None) is stub
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW,
            roofline.COLLECTIVE_BW) == (989.4e12, 3.35e12, 50e9)


def _records(tmp_path):
    rec = {"arch": "a", "shape": "train_4k", "mesh": "pod16x16",
           "status": "ok", "tag": "t",
           "memory": {"argument_bytes_per_device": 1e9,
                      "output_bytes_per_device": 1e9,
                      "temp_bytes_per_device": 2e9,
                      "alias_bytes_per_device": 0},
           "roofline": {"t_compute_s": 1.0, "t_memory_s": 2.0,
                        "t_collective_s": 0.5, "bottleneck": "memory",
                        "useful_flops_fraction": 0.5,
                        "roofline_fraction": 0.25}}
    coll = dict(rec, arch="c", roofline=dict(
        rec["roofline"], t_collective_s=3.0, bottleneck="collective",
        roofline_fraction=0.125))
    skip = {"arch": "b", "shape": "long_500k", "mesh": "pod16x16",
            "status": "skipped", "reason": "full-attention", "tag": "t"}
    err = {"arch": "d", "shape": "decode_32k", "mesh": "pod2x16x16",
           "status": "error", "error": "boom", "tag": "t"}
    other = dict(rec, arch="e", tag="u")
    for i, r in enumerate((rec, coll, skip, err, other)):
        with open(os.path.join(tmp_path, f"r{i}.json"), "w") as f:
            json.dump(r, f)


def test_report_roundtrip(tmp_path):
    _records(tmp_path)
    recs = load_records(str(tmp_path), tag="t")
    assert len(recs) == 4
    table = roofline_table(recs)
    assert "memory" in table and "SKIP" in table
    s = summarize(recs)
    assert "2 ok" in s and "1 documented skips" in s and "ERRORS" in s


@pytest.mark.parametrize("tag", ["t", None])
def test_report_text_equals_the_references(tmp_path, tag):
    _records(tmp_path)
    mine = load_records(str(tmp_path), tag=tag)
    theirs = ref_report.load_records(str(tmp_path), tag=tag)
    assert mine == theirs
    assert summarize(mine) == ref_report.summarize(theirs)
    for mesh in ("pod16x16", "pod2x16x16"):
        assert roofline_table(mine, mesh) == ref_report.roofline_table(
            theirs, mesh)
