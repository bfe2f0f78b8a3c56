"""The port's train CLI end to end on the CPU — twin of
``tests/test_launch_cli.py``'s train test, and a resume across packages.

* ``python -m repro_torch.launch.train --device cpu --reduced`` runs 6
  steps with a checkpoint every 3, then resumes to 8: the reference
  test's three strings.
* The reference's CLI writes a checkpoint at step 6 and resumes from it
  to step 8 (one subprocess, 2 devices, 32-bit, both runs through its
  ``main``); the port's CLI resumes from a copy of the same checkpoint.
  Its step-6 and step-7 losses agree with the reference's own resume to
  rel 1e-4, the bar of ``tests/test_substrate.py:71`` (bf16 compute in
  two packages).  The losses compared are the steps' own float32
  values, taken by wrapping each CLI's ``build_train_step``: the CLIs
  print them to 4 decimals only.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import SRC

ARGS = ("--arch", "smollm-360m", "--reduced", "--batch", "2", "--seq", "32",
        "--mesh", "2x1")
LOSS_REL = 1e-4

_REFERENCE_CODE = '''
import json, shutil, sys
from repro.launch import train
args = {args!r}
sys.argv = ["train", *args, "--steps", "6", "--ckpt", {ref!r},
            "--ckpt-every", "3"]
train.main()
shutil.copytree({ref!r}, {port!r})
losses, build = {{}}, train.build_train_step
def recording(*a, **k):
    step, *rest = build(*a, **k)
    def run(params, opt, batch, i):
        out = step(params, opt, batch, i)
        losses[int(i)] = float(out[2]["loss"])
        return out
    return (run, *rest)
train.build_train_step = recording
sys.argv = ["train", *args, "--steps", "8", "--ckpt", {ref!r}, "--resume",
            "--log-every", "1"]
train.main()
print("LOSSES" + json.dumps(losses))
'''


def _run_port(*args: str, timeout: int = 600) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"      # as tests/torch_threads.py sets it here
    proc = subprocess.run(
        [sys.executable, "-u", "-m", "repro_torch.launch.train",
         "--device", "cpu", *args],
        capture_output=True, text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _printed_steps(out: str) -> list:
    return sorted(int(i) for i in
                  re.findall(r"\[train\] step +(\d+) loss=[0-9.]+", out))


def test_train_cli_runs_and_resumes(tmp_path):
    out = _run_port(*ARGS, "--steps", "6", "--ckpt", str(tmp_path),
                    "--ckpt-every", "3")
    assert "done: 6 steps" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000006"]
    out = _run_port(*ARGS, "--steps", "8", "--ckpt", str(tmp_path),
                    "--resume")
    assert "resumed step 6" in out
    assert "done: 2 steps" in out


def test_resume_from_the_references_checkpoint(tmp_path, subproc,
                                              monkeypatch, capsys):
    from repro_torch.launch import train
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    out = subproc(_REFERENCE_CODE.format(args=ARGS, ref=ref, port=port),
                  devices=2, x64=False, timeout=900)
    assert "done: 6 steps" in out and "resumed step 6" in out
    want = {int(i): v for i, v in json.loads(
        out[out.index("LOSSES") + 6:].splitlines()[0]).items()}
    got, build = {}, train.build_train_step

    def recording(*a, **k):
        step, *rest = build(*a, **k)

        def run(model, opt, batch, i):
            out = step(model, opt, batch, i)
            got[int(i)] = float(out[2]["loss"])
            return out
        return (run, *rest)

    monkeypatch.setattr(train, "build_train_step", recording)
    train.main(["--device", "cpu", *ARGS, "--steps", "8", "--ckpt", port,
                "--resume", "--log-every", "1"])
    got_out = capsys.readouterr().out
    assert "resumed step 6 (data index 6)" in got_out
    assert "done: 2 steps" in got_out
    assert _printed_steps(got_out) == sorted(got) == sorted(want) == [6, 7]
    with capsys.disabled():
        for i in (6, 7):
            print(f"step {i}: port {got[i]!r}, reference {want[i]!r}, "
                  f"rel {abs(got[i] - want[i]) / abs(want[i]):.3e} "
                  f"(bar {LOSS_REL})")
    for i in (6, 7):
        assert got[i] == pytest.approx(want[i], rel=LOSS_REL)


def test_train_cli_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main([*ARGS, "--steps", "1"])
