"""End-to-end training driver — twin of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --batch 8 --seq 2048 --mesh 1x1 --ckpt /tmp/run1

Runs on the card (``--device cuda``, the default, which raises without
one); ``--device cpu`` trains on the CPU (``--reduced`` for a smoke-sized
sibling of the same family).  The weights are drawn from ``--seed`` on the
host, so they are not the reference CLI's (``jax.random.key``); a run of
one package continues from the other's checkpoint, whose format both
share.

``--mesh DxM`` is a logical ``("data", "model")`` mesh: one card holds
every array, and the mesh sets the specs the checkpoint records (the
batch must divide over its data ways, as it must over the reference's
devices).  Every step goes through the paper's offload model as in the
reference: the host programs a completion unit with the step's expected
arrivals, the step's ``arrivals`` metric arrives, the unit clears, and a
straggler watchdog observes the step's latency.  ``--resume`` continues
from the newest checkpoint (the same data indices); the schedule is the
reference's, ``total_steps = --steps``, so a resume with more steps than
the first run had changes the learning rate of the steps it runs, as the
reference's does.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import convert
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.core.completion import CompletionUnit
from repro_torch.core.offload import resolve_device
from repro_torch.data import DataConfig, SyntheticStream, input_specs
from repro_torch.ft.straggler import StepWatchdog
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get, init_params, reduced
from repro_torch.optim import adamw_init
from repro_torch.train import TrainConfig, build_train_step


def _state(model, opt, cfg):
    """The checkpoint's state in the reference's stacked layout."""
    return {"params": convert.model_params_to_numpy(model, cfg),
            "opt": convert.adamw_state_to_numpy(opt, cfg)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized sibling of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 4x2")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "the train step", "train")
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    d, m = (int(x) for x in args.mesh.split("x"))
    mesh = make_mesh((d, m), ("data", "model"))
    if args.batch % d:
        raise ValueError(f"batch {args.batch} does not divide over the "
                         f"mesh's {d} data ways")

    stream = SyntheticStream(
        DataConfig(vocab_size=cfg.vocab_size, batch_size=args.batch,
                   seq_len=args.seq, seed=args.seed), cfg)
    tcfg = TrainConfig(base_lr=args.lr, warmup_steps=max(1, args.steps // 20),
                       total_steps=args.steps, microbatches=args.microbatches)
    step_fn, pspecs, ospecs, _ = build_train_step(
        cfg, tcfg, input_specs(cfg, mode="train", batch=args.batch,
                               seq=args.seq),
        mesh=mesh, device=device)
    specs = {"params": pspecs, "opt": ospecs}

    start = 0
    if args.resume and args.ckpt and latest_step(args.ckpt) is not None:
        start, data_index, state = restore(args.ckpt, mesh, specs,
                                           device=device)
        model = init_params(cfg, device="meta").to_empty(device=device)
        model.load_state_dict(convert.model_params_from_numpy(
            state["params"], cfg))
        opt = convert.adamw_state_from_numpy(state["opt"], cfg)
        del state
        print(f"[train] resumed step {start} (data index {data_index})")
    else:
        model = init_params(cfg, generator=torch.Generator().manual_seed(
            args.seed), device="cpu").to(device)
        opt = adamw_init(model, tcfg.adamw)

    unit = CompletionUnit(n_units=4)
    watchdog = StepWatchdog()
    t_start = time.time()
    for i in range(start, args.steps):
        batch = stream.batch(i)
        unit.program(1, i)                      # offload register (fig. 6)
        t0 = time.monotonic()
        model, opt, metrics = step_fn(model, opt, batch, i)
        arrivals = int(metrics["arrivals"])    # the completion arrival
        unit.arrive(i, arrivals)
        assert unit.clear() == i
        watchdog.observe(time.monotonic() - t0)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"[train] step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"deadline={watchdog.deadline():.2f}s")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save(args.ckpt, i + 1, _state(model, opt, cfg), specs,
                 data_index=i + 1)
    dt = time.time() - t_start
    steps_run = args.steps - start
    print(f"[train] done: {steps_run} steps in {dt:.1f}s "
          f"({steps_run / max(dt, 1e-9):.2f} steps/s)")
    if args.ckpt:
        save(args.ckpt, args.steps, _state(model, opt, cfg), specs,
             data_index=args.steps)


if __name__ == "__main__":
    main()
