"""Multi-pod dry-run: count every (architecture × input-shape) cell on the
production meshes, show what a device holds, and extract roofline terms —
twin of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun

The dry-run runs on the ``meta`` device by design, not as a fallback from
the card: the reference's dry-run never allocates either (it lowers and
compiles, ``cells.py``), and a ``meta`` tensor has a shape, a dtype and
strides but no storage, so every cell runs at its global shapes with no
card and no memory.  The meshes are logical (``launch.mesh``): no
placeholder devices.

The twin of lower + compile: each cell's program runs once on ``meta``
under :mod:`repro_torch.launch.op_cost`, which costs every aten op
(``count_s`` is the time this takes; there is no ``lower_s`` or
``compile_s``).  Per device:

* FLOPs and bytes are the global count ÷ chips: the ideal partition.  One
  card has no SPMD partitioner to ask, so where XLA replicates work (an
  axis that does not divide, a replicated small op) the reference's
  numbers are higher.
* ``argument_bytes_per_device`` and ``output_bytes_per_device`` are Σ leaf
  bytes ÷ the sizes of the mesh axes the leaf's spec names
  (``param_specs``, ``batch_specs``, ``cache_specs``): exactly what a
  sharded argument holds.  ``alias_bytes_per_device`` is the arguments
  the program updates in place (the reference's donated buffers).
* ``temp_bytes_per_device`` is op_cost's tracked peak of live op outputs
  ÷ chips.
* Collectives are modelled from the specs, not parsed from a partitioned
  program, and the record says so (``"collectives": "modeled"``):
  - train: one data-axis gradient all-reduce a parameter tensor (a leaf
    of the reference's stacked tree), of
    2(d−1)/d × the f32 gradient bytes a device holds (d = the data ways,
    ``pod`` × ``data``);
  - a model axis of m > 1 ways: two all-reduces a layer of the (B/d, S,
    d_model) activation in the compute dtype, 2(m−1)/m of its bytes each,
    ×1 for a forward and ×3 for a train step with remat (forward,
    recompute, backward; ×2 without remat).
  Left out: the MoE dispatch's all-to-all, all-gathers of parameters,
  score all-reduces where heads do not divide the model axis, the
  embedding's and the head's reductions, the hybrid's shared block
  (counted as one layer of its period's), the loss and metric scalars,
  and any overlap of collectives with compute.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import convert
from repro_torch.dist.sharding import dp_axes
from repro_torch.launch.cells import (
    SHAPES, Cell, applicable, cell_layout, make_cell,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import COLLECTIVE_KINDS, Cost, OpCounter
from repro_torch.launch.roofline import analyze
from repro_torch.models.registry import ARCHS, get


def ways(spec, mesh) -> int:
    """How many ways a spec splits an array over ``mesh``: the product of
    the sizes of the mesh axes it names."""
    return math.prod(mesh.shape.get(a, 1)
                     for entry in spec if entry
                     for a in (entry if isinstance(entry, (tuple, list))
                               else (entry,)))


def _flat(tree, specs) -> List[Tuple[object, tuple]]:
    """(leaf, spec) pairs of a tree and its specs (a spec may stand for a
    whole subtree: ``()`` replicates it)."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flat(v, specs[k] if isinstance(specs, dict) else specs)
        return out
    return [(tree, specs)]


def per_device_bytes(pairs, mesh) -> float:
    """Σ leaf bytes ÷ the ways its spec splits it, over (tree, specs)
    pairs."""
    return float(sum(leaf.numel() * leaf.element_size() / ways(spec, mesh)
                     for tree, specs in pairs
                     for leaf, spec in _flat(tree, specs)))


def modeled_collectives(meta, cfg, mesh, layout, remat: bool
                        ) -> Tuple[float, Dict[str, float]]:
    """(bytes a device sends, counts by kind) of the modelled collectives
    (the module docstring)."""
    d = 1
    for a in dp_axes(mesh):
        d *= mesh.shape[a]
    m = mesh.shape.get("model", 1)
    nbytes, count = 0.0, 0
    if meta.mode == "train" and d > 1:
        params, pspecs = layout["arguments"][0]
        grads = _flat(params, pspecs)
        nbytes += 2 * (d - 1) / d * sum(
            leaf.numel() * 4 / ways(spec, mesh) for leaf, spec in grads)
        count += sum(1 for _ in grads)
    if m > 1:
        rows = meta.global_batch // d if meta.global_batch % d == 0 \
            else meta.global_batch
        seq = 1 if meta.mode == "decode" else meta.seq
        act = rows * seq * cfg.d_model * getattr(
            torch, cfg.compute_dtype).itemsize
        passes = 1 if meta.mode != "train" else (3 if remat else 2)
        n = 2 * cfg.n_layers * passes
        nbytes += n * 2 * (m - 1) / m * act
        count += n
    counts = {k: 0.0 for k in COLLECTIVE_KINDS}
    counts["all-reduce"] = float(count)
    return nbytes, counts


def count_cell(cell: Cell) -> Tuple[Cost, float]:
    """(the global :class:`Cost` of one run of the cell's program on
    ``meta``, the seconds it took)."""
    t0 = time.time()
    counter = OpCounter()
    with counter:
        cell.fn(*cell.args)
    return counter.cost(), time.time() - t0


def run_cell(arch: str, shape: str, multi_pod: bool,
             call_overrides: Optional[Dict] = None,
             train_overrides: Optional[Dict] = None,
             mesh=None, counted: Optional[Tuple[Cell, Cost, float]] = None
             ) -> Dict:
    """One cell's record (``mesh`` replaces the production mesh, for
    tests; the record keeps the production mesh's name).  ``counted`` is
    (the :class:`Cell`, :func:`count_cell`'s result) when already taken:
    the count does not depend on the mesh (the mesh only sets the specs),
    so one count serves both production meshes."""
    cfg = get(arch)
    convert.require_stacked(cfg)
    ok, why = applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: Dict = {"arch": arch, "shape": shape, "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=why)
        print(f"[dryrun] {arch} × {shape} × {mesh_name}: SKIPPED ({why})")
        return rec
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    if counted is None:
        cell = make_cell(arch, shape, mesh, call_overrides, train_overrides)
        counted = (cell, *count_cell(cell))
    cell, total, t_count = counted
    meta = dataclasses.replace(cell.meta, chips=mesh.size)

    layout = cell_layout(cell, mesh)
    cost = total.per_device(meta.chips)
    cost.collective_bytes, cost.collective_counts = modeled_collectives(
        meta, cfg, mesh, layout, cell.call.remat)
    memory = {
        "argument_bytes_per_device": per_device_bytes(layout["arguments"],
                                                      mesh),
        "output_bytes_per_device": per_device_bytes(layout["outputs"], mesh),
        "temp_bytes_per_device": cost.peak_bytes,
        "alias_bytes_per_device": per_device_bytes(layout["aliased"], mesh),
    }
    print(f"[dryrun] {arch} × {shape} × {mesh_name}")
    print(f"  memory (logical, per device): {memory}")
    print(f"  op_cost: flops={total.flops:.3e} bytes={total.bytes:.3e} "
          f"(global, {t_count:.1f} s on meta)")
    roof = analyze(cost, meta.model_flops, meta.chips)
    print(f"  roofline: t_comp={roof.t_compute:.3e}s t_mem={roof.t_memory:.3e}s "
          f"t_coll={roof.t_collective:.3e}s bottleneck={roof.bottleneck} "
          f"frac={roof.roofline_fraction:.3f}")

    rec.update(
        status="ok",
        count_s=round(t_count, 2),
        memory=memory,
        tokens=meta.tokens,
        params_total=meta.params_total,
        params_active=meta.params_active,
        roofline=roof.to_dict(),
        collectives="modeled",
        top_traffic=cost.top_traffic,
    )
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), action="append")
    ap.add_argument("--shape", choices=sorted(SHAPES), action="append")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true", help="all archs × shapes")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--call-override", default=None,
                    help="JSON dict of CallConfig overrides (hillclimbing)")
    ap.add_argument("--train-override", default=None,
                    help="JSON dict of TrainConfig overrides (hillclimbing)")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.all or not args.arch else args.arch
    shapes = sorted(SHAPES) if args.all or not args.shape else args.shape
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    co = json.loads(args.call_override) if args.call_override else None
    to = json.loads(args.train_override) if args.train_override else None

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            counted = None
            for mp in meshes:
                try:
                    if counted is None and applicable(get(arch), shape)[0]:
                        cell = make_cell(
                            arch, shape, make_production_mesh(multi_pod=mp),
                            co, to)
                        counted = (cell, *count_cell(cell))
                    rec = run_cell(arch, shape, mp, co, to, counted=counted)
                except Exception as e:                      # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "pod2x16x16" if mp else "pod16x16",
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    n_fail += 1
                    print(f"[dryrun] {arch} × {shape}: ERROR {e!r}")
                rec["tag"] = args.tag
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{args.tag}.json"
                    with open(os.path.join(args.out, name), "w") as f:
                        json.dump(rec, f, indent=1)
    if n_fail:
        raise SystemExit(f"{n_fail} cell(s) failed")


if __name__ == "__main__":
    main()
