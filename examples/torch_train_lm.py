"""End-to-end training on the PyTorch port: a few-hundred-step run of the
(reduced) SmolLM config on a logical 4×2 mesh, with checkpointing, a
simulated mid-run failure, and an elastic resume onto a 4-way data mesh —
the twin of ``examples/train_lm.py``, at the same sizes.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 30 \\
        --fail-at 25

One device holds every array: the mesh is logical (``dist.LogicalMesh``)
and sets the specs the checkpoint records, and the elastic restore
re-derives them for 4 data ways on the same device.  The weights come
from a ``torch.Generator``, so the losses are not the reference's.  (For
the full-size architectures use ``repro_torch.launch.train`` with
``--arch``.)
"""

import argparse
import shutil
import tempfile

import torch

from repro_torch import convert
from repro_torch import models as M
from repro_torch.checkpoint import save
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.ft.elastic import elastic_restore
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import adamw_init
from repro_torch.train import TrainConfig, build_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = M.reduced(M.get("smollm-360m"), n_layers=4, d_model=256,
                    n_heads=8, n_kv_heads=4, head_dim=32, d_ff=512,
                    vocab_size=4096)
    mesh = make_mesh((4, 2), ("data", "model"))
    print(f"arch={cfg.name} params={M.count_params(cfg)/1e6:.1f}M "
          f"mesh={mesh.axis_sizes} {mesh.axis_names}")

    stream = SyntheticStream(
        DataConfig(vocab_size=cfg.vocab_size, batch_size=8, seq_len=64,
                   seed=0), cfg)
    bs = stream.batch(0)
    tcfg = TrainConfig(base_lr=1e-3, warmup_steps=20, total_steps=args.steps,
                       microbatches=2)
    step_fn, pspecs, ospecs, _ = build_train_step(cfg, tcfg, bs, mesh=mesh,
                                                  device=args.device)
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu").to(args.device)
    opt = adamw_init(model, tcfg.adamw)

    ckdir = tempfile.mkdtemp(prefix="trainlm_")
    first_loss = None
    failed_once = False
    i = 0
    try:
        while i < args.steps:
            model, opt, m = step_fn(model, opt, stream.batch(i), i)
            if first_loss is None:
                first_loss = float(m["loss"])
            if i % 25 == 0:
                print(f"step {i:4d} loss={float(m['loss']):.4f} "
                      f"gnorm={float(m['grad_norm']):.2f}")
            if (i + 1) % 20 == 0:
                save(ckdir, i + 1,
                     {"params": convert.model_params_to_numpy(model, cfg),
                      "opt": convert.adamw_state_to_numpy(opt, cfg)},
                     {"params": pspecs, "opt": ospecs}, data_index=i + 1)
            i += 1
            if i == args.fail_at and not failed_once:
                failed_once = True
                print(f"--- simulated node failure at step {i}; "
                      f"elastic restart on 4 devices ---")
                st, di, state, mesh = elastic_restore(
                    ckdir, range(4), convert.reference_shapes(cfg),
                    device=args.device)
                step_fn, pspecs, ospecs, _ = build_train_step(
                    cfg, tcfg, bs, mesh=mesh, device=args.device)
                model.load_state_dict(
                    convert.model_params_from_numpy(state["params"], cfg))
                opt = convert.adamw_state_from_numpy(state["opt"], cfg)
                i = di
                print(f"--- resumed from step {di} on mesh "
                      f"{mesh.axis_sizes} ---")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    final = float(m["loss"])
    print(f"\nfirst loss {first_loss:.3f} -> final {final:.3f} "
          f"(dropped {first_loss - final:.3f} nats over {args.steps} steps)")


if __name__ == "__main__":
    main()
