"""The port's walkthroughs (``examples/torch_*.py``) on the CPU, against
the reference's (``examples/*.py``).

Each twin's ``main(["--device", "cpu", ...])`` runs here (the model
validation twin's ``main([])``: it touches no device and takes no
``--device``).  One subprocess
(8 devices, x64, as the reference's offload examples set them) runs the
reference's ``offload_model_validation``, ``quickstart`` and
``job_graph`` once and returns their output.  Bars:

* ``torch_offload_model_validation``: every line equal (pure analytics).
* ``torch_quickstart``: every line equal but the ``wall_s:`` line of
  ``handle.explain()``'s measured half, a wall time of this run; the
  collective counts come from the port's launch trace where the
  reference reads its HLO text, and are equal.
* ``torch_job_graph``: every line equal (verification, forwards, d2h
  bytes, the OFLP104 findings and their cycle counts, the autofix, the
  OFL001 rejection).
* ``torch_serve_batch`` and ``torch_train_lm`` draw their weights from a
  ``torch.Generator``, so their sampled ids and losses are the port's
  own: they are held to their printed facts (three families served,
  the tree staging's bytes, the failure and the resume, a falling loss).
"""

import ast
import importlib.util
import json
import os
import re

import pytest

from conftest import REPO

EXAMPLES = os.path.join(REPO, "examples")
TWINS = ["offload_model_validation", "quickstart", "job_graph",
         "serve_batch", "train_lm"]
#: the twins that touch a device, and so take ``--device``
DEVICE_TWINS = ["quickstart", "job_graph", "serve_batch", "train_lm"]
#: the reference's walkthroughs held line for line (or nearly)
PARITY = ["offload_model_validation", "quickstart", "job_graph"]

_REFERENCE_CODE = '''
import contextlib, importlib.util, io, json, os
out = {{}}
for name in {names!r}:
    spec = importlib.util.spec_from_file_location(
        name, os.path.join({examples!r}, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    out[name] = buf.getvalue()
print("REF" + json.dumps(out))
'''


def _twin(name):
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, capsys, *args):
    device = ["--device", "cpu"] if name in DEVICE_TWINS else []
    _twin(name).main([*device, *args])
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def reference(subproc):
    out = subproc(_REFERENCE_CODE.format(names=PARITY, examples=EXAMPLES),
                  devices=8, x64=True, timeout=600)
    return json.loads(out[out.index("REF") + 3:].splitlines()[0])


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_only_the_port(name):
    """A twin imports ``repro_torch`` and never JAX or the reference."""
    with open(os.path.join(EXAMPLES, f"torch_{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    assert any(m.startswith("repro_torch") for m in mods)
    for m in mods:
        assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), m


@pytest.mark.parametrize("name", DEVICE_TWINS)
def test_twin_defaults_to_the_card(name, monkeypatch):
    """Without ``--device`` a twin runs on the card and raises without
    one (the callee's ``resolve_device``), never quietly on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        _twin(name).main([])


def test_model_validation_equals_the_reference(reference, capsys):
    got = _run("offload_model_validation", capsys).splitlines()
    want = reference["offload_model_validation"].splitlines()
    assert len(want) == 29
    assert got == want


def test_quickstart_equals_the_reference(reference, capsys):
    got = _run("quickstart", capsys).splitlines()
    want = reference["quickstart"].splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.strip().startswith("wall_s:"):
            assert g.strip().startswith("wall_s:")   # this run's wall time
            continue
        assert g == w
    assert sum("allclose=True" in ln for ln in got) == 5
    assert not any("allclose=False" in ln for ln in got)
    assert "  baseline : allclose=True  chain=14 collective-permutes, " \
           "0 all-reduce" in got
    assert "  multicast: allclose=True  chain=0 collective-permutes, " \
           "1 all-reduce" in got


def test_job_graph_equals_the_reference(reference, capsys):
    got = _run("job_graph", capsys).splitlines()
    assert got == reference["job_graph"].splitlines()
    assert "  codes=('OFL001',)" in got
    assert "  autofixed graph bit-identical: True" in got
    assert sum(ln.startswith("  OFLP104:") for ln in got) == 2


def test_serve_batch_serves_three_families(capsys):
    out = _run("serve_batch", capsys).splitlines()
    heads = [ln for ln in out if not ln.startswith("  ")]
    assert [h.split()[0] for h in heads] == [
        "smollm-360m", "deepseek-v2-lite-16b", "zamba2-2.7b"]
    assert "cache=KV" in heads[0]
    assert "cache=compressed-KV (MLA)" in heads[1]
    assert "cache=SSM state" in heads[2]
    assert all("96 tokens in" in h for h in heads)
    placed = [ln for ln in out if "weight placement" in ln]
    assert len(placed) == 3 and all("(staging=tree)" in p for p in placed)
    for p in placed:
        # one upload, 7 device copies over the 8-cluster window (0.1 MB
        # printed: 7 roundings of 0.05 MB apart at most)
        h2d, d2d = (float(x) for x in re.findall(r"([0-9.]+) MB", p))
        assert d2d == pytest.approx(7 * h2d, abs=0.4)
    samples = [ln for ln in out if ln.startswith("  sample: ")]
    assert len(samples) == 3
    for s in samples:
        ids = json.loads(s.split(": ", 1)[1])
        assert len(ids) == 12 and all(0 <= i < 512 for i in ids)


def test_train_lm_fails_resumes_and_learns(capsys):
    out = _run("train_lm", capsys, "--steps", "40", "--fail-at", "30")
    lines = out.splitlines()
    assert lines[0].startswith("arch=smollm-360m-reduced params=3.4M "
                               "mesh=(4, 2) ('data', 'model')")
    assert ("--- simulated node failure at step 30; elastic restart on 4 "
            "devices ---") in lines
    assert "--- resumed from step 20 on mesh (4,) ---" in lines
    last = lines[-1]
    first, final = (float(x) for x in
                    last.split("first loss ")[1].split(" (")[0].split(" -> final "))
    assert final < first, last
    assert "over 40 steps" in last
