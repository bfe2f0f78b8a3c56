"""The port's dry-run machinery — twin of ``tests/test_dryrun_cells.py``
and ``tests/test_hlo_cost.py``, on the CPU (``meta`` tensors).

* The six reference cells at full width on a 4 x 2 logical mesh, through
  ``dryrun.run_cell`` (``op_cost`` on ``meta``, the logical memory, the
  modelled collectives, the H100 roofline).
* The record follows the program that was counted: the layout's moments
  are the cell's AdamW state, and the model-axis all-reduces the cell's
  remat.
* ``op_cost`` against analytic truth (loops, nesting, a plain product,
  transcendentals, a product's bytes, windowed writes) and against
  ``torch.utils.flop_counter.FlopCounterMode`` on a training step.
* Parity with the reference on reduced configurations: one subprocess
  (8 devices, 32-bit) compiles the same six cells, cut to a few tokens,
  on a 1 x 1 and a 4 x 2 mesh (and the state-space prefills on 1 x 1)
  and reads ``hlo_cost``, the compiled
  argument bytes and the collectives.  Bars: FLOPs within 5 % for the
  dense, MoE and vision cells; argument bytes a device exactly; collective
  bytes zero in both on 1 x 1, and on 4 x 2 nonzero in the port wherever
  the reference's HLO has them.  The SSM and hybrid cells are held to the
  port's own analytic count of its sequential scan, and their ratio to the
  reference is printed (ROADMAP's differences).  The chunked attention's
  per-chunk remat (``attn_chunk_remat``) is counted in the same
  subprocess, with and without the knob, against the same bar.
"""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ref as kref
from repro_torch.launch import cells, dryrun
from repro_torch.launch.cells import applicable, default_call
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.op_cost import OpCounter, count_cost
from repro_torch.models import registry
from repro_torch.models.config import reduced
from repro_torch.optim import AdamWConfig

SIX = [
    ("smollm-360m", "train_4k"),
    ("smollm-360m", "decode_32k"),
    ("deepseek-v2-lite-16b", "train_4k"),
    ("falcon-mamba-7b", "long_500k"),
    ("zamba2-2.7b", "decode_32k"),
    ("paligemma-3b", "prefill_32k"),
]
#: the parity cells: the six, and the state-space prefills, where the two
#: scans' algorithms differ (associative against sequential)
PARITY = SIX + [("falcon-mamba-7b", "prefill_32k"),
                ("zamba2-2.7b", "prefill_32k")]
#: the cells held to the reference's FLOPs within FLOP_REL
DENSE_MOE = {"smollm-360m", "deepseek-v2-lite-16b", "paligemma-3b"}
FLOP_REL = 0.05
#: the reduced cells' (mode, seq, global batch)
SMALL = {"train_4k": ("train", 64, 8), "prefill_32k": ("prefill", 64, 8),
         "decode_32k": ("decode", 64, 8), "long_500k": ("decode", 128, 4)}
MESHES = {"1x1": (1, 1), "4x2": (4, 2)}
#: the chunked attention's per-chunk remat, counted on 1 x 1 with and
#: without the knob: the reduced ``train_4k`` (64 tokens) in chunks of 16,
#: since at 64 tokens the cell's own call is the plain attention
KNOB_ARCHS = ["smollm-360m", "deepseek-v2-lite-16b"]
CHUNKED = {"attn_impl": "chunked", "attn_chunk": 16}

N = 256
DOT = 2 * N ** 3


def _meta(*shape):
    return torch.empty(shape, device="meta")


# -- the six cells at full width ------------------------------------------------


@pytest.mark.parametrize("arch,shape", SIX)
def test_cell_counts_at_full_width_small_mesh(arch, shape):
    rec = dryrun.run_cell(arch, shape, False,
                          mesh=make_mesh((4, 2), ("data", "model")))
    ro = rec["roofline"]
    assert rec["status"] == "ok" and rec["collectives"] == "modeled"
    assert ro["flops_per_device"] > 0 and ro["bytes_per_device"] > 0
    assert ro["bottleneck"] in ("compute", "memory", "collective")
    assert 0 <= ro["roofline_fraction"] <= 1.5
    assert ro["chips"] == 8
    mem = rec["memory"]
    assert mem["argument_bytes_per_device"] > 0
    assert mem["temp_bytes_per_device"] > 0
    print("OK", arch, shape, ro["bottleneck"],
          f"{ro['roofline_fraction']:.4f}", f"{rec['count_s']:.1f} s")


def test_long_500k_skips_full_attention():
    ok, why = applicable(registry.get("yi-9b"), "long_500k")
    assert not ok and "full-attention" in why
    ok, _ = applicable(registry.get("falcon-mamba-7b"), "long_500k")
    assert ok
    ok, _ = applicable(registry.get("zamba2-2.7b"), "long_500k")
    assert ok
    rec = dryrun.run_cell("yi-9b", "long_500k", True)
    assert rec["status"] == "skipped" and rec["mesh"] == "pod2x16x16"


def test_make_production_mesh_shapes():
    m1 = make_production_mesh(multi_pod=False)
    assert m1.axis_sizes == (16, 16) and m1.axis_names == ("data", "model")
    m2 = make_production_mesh(multi_pod=True)
    assert m2.axis_sizes == (2, 16, 16)
    assert m2.axis_names == ("pod", "data", "model")
    assert make_mesh((4, 2), ("data", "model"),
                     [torch.device("cpu")] * 8).size == 8
    with pytest.raises(ValueError, match="need 8 devices, have 2"):
        make_mesh((4, 2), ("data", "model"), [torch.device("cpu")] * 2)


@pytest.mark.parametrize("knob", ["attn_q_sharding", "moe_buffer_sharding"])
def test_sharding_knob_override_raises_value_error(knob, capsys):
    with pytest.raises(ValueError, match=knob):
        default_call("train", 4096, {knob: "seq_model"})
    with pytest.raises(SystemExit, match="1 cell"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--call-override", json.dumps({knob: "ep"})])
    assert f"ERROR ValueError(\"call override '{knob}'" in capsys.readouterr().out


def test_default_call_is_the_references_on_the_plain_paths():
    c = default_call("train", 4096)
    assert (c.attn_impl, c.attn_chunk, c.remat, c.ssm_impl) == (
        "chunked", 512, True, "plain")
    c = default_call("prefill", 2048)
    assert (c.attn_impl, c.remat, c.moe_no_drop) == ("plain", False, False)
    assert default_call("decode", 32768).moe_no_drop


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_layout_moments_are_the_counted_steps(moment_dtype):
    mesh = make_mesh((4, 2), ("data", "model"))
    cell = cells.make_cell("smollm-360m", "train_4k", mesh, train_overrides={
        "adamw": AdamWConfig(moment_dtype=moment_dtype)})
    opt, _ = cells.cell_layout(cell, mesh)["arguments"][1]
    counted = cell.args[1]
    for k in ("mu", "nu"):
        laid, run = _leaves(opt[k]), list(counted[k].values())
        assert {x.dtype for x in laid} == {x.dtype for x in run} == {
            getattr(torch, moment_dtype)}
        assert (sum(x.numel() * x.element_size() for x in laid)
                == sum(x.numel() * x.element_size() for x in run))


def test_model_axis_collectives_follow_the_cells_remat(monkeypatch):
    monkeypatch.setattr(cells, "get", _reduced_get)
    monkeypatch.setattr(dryrun, "get", _reduced_get)
    monkeypatch.setitem(cells.SHAPES, "train_4k", SMALL["train_4k"])
    mesh = make_mesh((4, 2), ("data", "model"))
    n = {remat: dryrun.run_cell("smollm-360m", "train_4k", False,
                                {"remat": remat}, mesh=mesh)
         ["roofline"]["collective_counts"]["all-reduce"]
         for remat in (True, False)}
    layers = _reduced_get("smollm-360m").n_layers
    assert n[True] - n[False] == 2 * layers          # ×3 passes against ×2


# -- op_cost against analytic truth ----------------------------------------------


def _one(x):
    return torch.tanh(x @ x)


def test_loops_count_every_trip():
    """The twin of test_xla_cost_analysis_undercounts_scans: a Python loop
    dispatches every iteration, so 7 steps count 7 × one step."""
    def looped(x):
        for _ in range(7):
            x = _one(x)
        return x

    one = count_cost(_one, _meta(N, N))
    seven = count_cost(looped, _meta(N, N))
    assert one.flops == pytest.approx(DOT + N * N)
    assert seven.flops == pytest.approx(7 * one.flops)
    assert seven.bytes == pytest.approx(7 * one.bytes)


def test_nested_loops():
    def nested(x):
        c = x
        for _ in range(3):
            for _ in range(5):
                c = c @ x
            c = torch.tanh(c)
        return c

    c = count_cost(nested, _meta(N, N))
    assert c.flops == pytest.approx(15 * DOT, rel=0.05)


def test_plain_dot_exact():
    c = count_cost(lambda a, b: a @ b, _meta(N, N), _meta(N, N))
    assert c.flops == pytest.approx(DOT, rel=0.01)


def test_transcendentals_counted():
    c = count_cost(torch.exp, _meta(N, N))
    assert c.transcendentals == pytest.approx(N * N, rel=0.01)


def test_bytes_kernel_boundary_reasonable():
    """Traffic of a bare matmul ≈ operands + result (not 10×)."""
    c = count_cost(lambda a, b: a @ b, _meta(N, N), _meta(N, N))
    expect = 3 * N * N * 4
    assert expect * 0.5 < c.bytes < expect * 4


@pytest.mark.parametrize("write", ["copy_into_view", "index_copy_",
                                   "index_put_"])
def test_windowed_writes_count_windows_not_buffers(write):
    """The twin of test_dus_in_place_counts_windows_not_buffers: 64
    single-row writes into a (64, 512) buffer count the rows, not 64
    times the buffer."""
    def f(buf):
        row = torch.ones((1, 512), device=buf.device)
        for i in range(64):
            idx = torch.full((1,), i, dtype=torch.long, device=buf.device)
            if write == "copy_into_view":
                buf[i:i + 1].copy_(row)
            elif write == "index_copy_":
                buf.index_copy_(0, idx, row)
            else:
                buf.index_put_((idx,), row)
        return buf

    c = count_cost(f, _meta(64, 512))
    buffer_traffic = 64 * 64 * 512 * 4 * 2
    assert c.bytes < buffer_traffic / 4


def test_views_cost_nothing():
    def views(x):
        return x.view(N * N).reshape(N, N).t().transpose(0, 1)[:, :7].expand(
            2, N, 7)

    c = count_cost(views, _meta(N, N))
    assert (c.flops, c.bytes, c.peak_bytes) == (0, 0, 0)


def test_peak_live_bytes():
    """Three (N, N) f32 outputs are alive at once in the loop: the new
    product, its tanh, and the loop's carried value."""
    def looped(x):
        for _ in range(4):
            x = _one(x)
        return x

    assert count_cost(looped, _meta(N, N)).peak_bytes == 3 * N * N * 4


def test_products_equal_flop_counter_mode():
    """The products' FLOPs of a reduced train step (forward, remat
    recompute, backward) equal ``FlopCounterMode``'s."""
    fn, args, _ = _reduced_cell("smollm-360m", "train_4k", (1, 1))
    counter = OpCounter()
    with counter:
        fn(*args)
    fn, args, _ = _reduced_cell("smollm-360m", "train_4k", (1, 1))
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert counter.product_flops == fc.get_total_flops()
    assert counter.flops > counter.product_flops


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_scan_count_is_the_sequential_scans(arch):
    """The port's scan is sequential: a mul and an add a state element a
    step, and the (D, N) · (N,) readout, 4·B·S·D·N FLOPs in all."""
    cfg = reduced(registry.get(arch))
    s = cfg.ssm
    b, d, n = 2, cfg.d_inner, s.d_state
    c = count_cost(kref.ssm_scan, _meta(b, s.chunk, d, n),
                   _meta(b, s.chunk, d, n), _meta(b, s.chunk, n))
    assert c.flops == 4 * b * s.chunk * d * n
    assert c.transcendentals == 0


# -- parity with the reference (reduced cells) ----------------------------------

_REFERENCE_CODE = '''
import json
import numpy as np, jax
from jax.sharding import Mesh
from repro.launch import cells
from repro.launch.hlo_cost import analyze_hlo_text
from repro.models import registry
from repro.models.config import reduced
cells.SHAPES.update({small!r})
cells.get = lambda a: reduced(registry.get(a))
devs = np.array(jax.devices())
out = {{}}
for mname, shape in {meshes!r}.items():
    n = shape[0] * shape[1]
    mesh = Mesh(devs[:n].reshape(shape), ("data", "model"))
    for arch, cell in ({cells!r} if n == 1 else {six!r}):
        fn, args, meta = cells.build_cell(arch, cell, mesh)
        comp = fn.lower(*args).compile()
        c = analyze_hlo_text(comp.as_text())
        out["/".join((arch, cell, mname))] = {{
            "flops": c.flops, "collective_bytes": c.collective_bytes,
            "args": comp.memory_analysis().argument_size_in_bytes}}
mesh = Mesh(devs[:1].reshape(1, 1), ("data", "model"))
for arch in {knob_archs!r}:
    for knob in (False, True):
        fn, args, meta = cells.build_cell(
            arch, "train_4k", mesh, dict({chunked!r}, attn_chunk_remat=knob))
        comp = fn.lower(*args).compile()
        out["/".join((arch, "chunk_remat", str(knob)))] = {{
            "flops": analyze_hlo_text(comp.as_text()).flops}}
print("REF" + json.dumps(out))
'''


def _reduced_get(arch):
    return reduced(registry.get(arch))


def _reduced_cell(arch, shape, mesh_shape):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cells, "get", _reduced_get)
        mp.setitem(cells.SHAPES, shape, SMALL[shape])
        return cells.build_cell(arch, shape,
                                make_mesh(mesh_shape, ("data", "model")))


@pytest.fixture(scope="module")
def parity(subproc):
    out = subproc(_REFERENCE_CODE.format(small=SMALL, meshes=MESHES,
                                         cells=PARITY, six=SIX,
                                         knob_archs=KNOB_ARCHS,
                                         chunked=CHUNKED),
                  devices=8, x64=False, timeout=900)
    ref = json.loads(out[out.index("REF") + 3:].splitlines()[0])
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cells, "get", _reduced_get)
        mp.setattr(dryrun, "get", _reduced_get)
        for shape, small in SMALL.items():
            mp.setitem(cells.SHAPES, shape, small)
        for mname, mshape in MESHES.items():
            for arch, cell in (PARITY if mname == "1x1" else SIX):
                port["/".join((arch, cell, mname))] = dryrun.run_cell(
                    arch, cell, False,
                    mesh=make_mesh(mshape, ("data", "model")))
        for arch in KNOB_ARCHS:
            for knob in (False, True):
                port["/".join((arch, "chunk_remat", str(knob)))] = (
                    dryrun.run_cell(arch, "train_4k", False,
                                    dict(CHUNKED, attn_chunk_remat=knob),
                                    mesh=make_mesh((1, 1),
                                                   ("data", "model"))))
    return ref, port


@pytest.mark.parametrize("arch,shape", PARITY)
def test_parity_with_the_reference(parity, arch, shape):
    ref, port = parity
    one = "/".join((arch, shape, "1x1"))
    r, p = ref[one], port[one]
    flops = p["roofline"]["flops_per_device"]
    ratio = flops / r["flops"]
    print(f"{arch} {shape}: port/reference FLOPs {ratio:.4f} "
          f"({flops:.5g} / {r['flops']:.5g})")
    if arch in DENSE_MOE:
        assert ratio == pytest.approx(1.0, abs=FLOP_REL)
    assert p["memory"]["argument_bytes_per_device"] == r["args"]
    assert p["roofline"]["collective_bytes_per_device"] == 0
    assert r["collective_bytes"] == 0
    four = "/".join((arch, shape, "4x2"))
    if four not in ref:
        return                  # the state-space prefills: 1 x 1 only
    r, p = ref[four], port[four]
    assert p["memory"]["argument_bytes_per_device"] == r["args"]
    if r["collective_bytes"] > 0:
        assert p["roofline"]["collective_bytes_per_device"] > 0
        assert sum(p["roofline"]["collective_counts"].values()) > 0


@pytest.mark.parametrize("arch", KNOB_ARCHS)
def test_chunk_remat_parity_with_the_reference(parity, arch):
    """``attn_chunk_remat`` counts the chunks' recompute: the port's FLOPs
    with the knob within FLOP_REL of the reference's ``hlo_cost`` with the
    same override, above the port's own count without it, and the
    counted peak of live bytes below it."""
    ref, port = parity
    rec = {knob: port["/".join((arch, "chunk_remat", str(knob)))]
           for knob in (False, True)}
    flops = {k: r["roofline"]["flops_per_device"] for k, r in rec.items()}
    for knob in (False, True):
        want = ref["/".join((arch, "chunk_remat", str(knob)))]["flops"]
        print(f"{arch} chunked, knob {knob}: port/reference FLOPs "
              f"{flops[knob] / want:.4f} ({flops[knob]:.5g} / {want:.5g})")
        assert flops[knob] / want == pytest.approx(1.0, abs=FLOP_REL)
    assert flops[True] > flops[False]
    temp = {k: r["memory"]["temp_bytes_per_device"] for k, r in rec.items()}
    assert temp[True] < temp[False], temp
