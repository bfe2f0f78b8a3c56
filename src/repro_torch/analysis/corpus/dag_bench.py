"""The dependent-graph benchmark's graphs: a K=8 chain, a diamond and a
serial wide -> narrow -> wide chain over axpy(2048) (the port's copy of
the reference's ``benchmarks/dag_bench.py:bench_graphs``).

Builders only: they construct nodes without touching a device.
"""

import numpy as np

from repro_torch.core import jobs
from repro_torch.core.scoreboard import GraphNode, Ref

CHAIN_K = 8


def _chain_nodes(job, ops, K: int = CHAIN_K):
    nodes = [GraphNode(job, ops, name="n0")]
    for k in range(1, K):
        nodes.append(GraphNode(job, {"x": ops["x"], "y": Ref(f"n{k-1}")},
                               name=f"n{k}"))
    return nodes


def _diamond_nodes(job, ops):
    return [
        GraphNode(job, ops, name="src"),
        GraphNode(job, {"x": ops["x"], "y": Ref("src")}, name="l",
                  clusters=[0, 1, 2, 3]),
        GraphNode(job, {"x": ops["x"], "y": Ref("src")}, name="r",
                  clusters=[4, 5, 6, 7]),
        GraphNode(job, {"x": Ref("l"), "y": Ref("r")}, name="join"),
    ]


def _serial_nodes(job, ops):
    # serial wide -> narrow -> wide: both edges pay a d2d forward on
    # the critical path.  Kept as checked-in OFLP104 debt on purpose —
    # LINT_baseline.json carries its two findings, so the lint gate
    # stays green here but fails on *new* regressions.
    return [
        GraphNode(job, ops, name="wide"),
        GraphNode(job, {"x": ops["x"], "y": Ref("wide")}, name="narrow",
                  clusters=[0, 1, 2, 3]),
        GraphNode(job, {"x": ops["x"], "y": Ref("narrow")}, name="tail"),
    ]


def bench_graphs() -> dict:
    """name -> GraphNode list.  Operand dtype is irrelevant to linting,
    so plain numpy."""
    job = jobs.make_axpy(2048)
    ops, _ = job.make_instance(0)
    ops = {k: np.asarray(v) for k, v in ops.items()}
    return {"dag/chain": _chain_nodes(job, ops),
            "dag/diamond": _diamond_nodes(job, ops),
            "dag/serial": _serial_nodes(job, ops)}
