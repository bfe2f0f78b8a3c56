"""Dependent job graphs: a K=8 self-scaling chain, a diamond whose arms run
on disjoint cluster windows, and a serial reshard chain (the port's copy
of the reference's ``examples/job_graph.py`` builders).

Builders only: they construct nodes without touching a device.
"""

import numpy as np

from repro_torch.core import jobs
from repro_torch.core.scoreboard import GraphNode, Ref

CHAIN_K = 8
N = 2048


def _ops(seed: int):
    job = jobs.make_axpy(N)
    ops, _ = job.make_instance(seed)
    return job, {k: np.asarray(v, dtype=np.float64) for k, v in ops.items()}


def build_chain(K: int = CHAIN_K):
    """y ← 2.5·x + y repeated K times, each link reading the previous
    node's result through a d2d-forwarded ``Ref``."""
    job, ops = _ops(0)
    nodes = [GraphNode(job, ops, name="n0")]
    for k in range(1, K):
        nodes.append(GraphNode(job, {"x": ops["x"], "y": Ref(f"n{k-1}")},
                               name=f"n{k}"))
    return nodes


def build_diamond():
    """src fans out to two half-window arms that rejoin."""
    job, ops = _ops(1)
    return [
        GraphNode(job, ops, name="src"),
        GraphNode(job, {"x": ops["x"], "y": Ref("src")}, name="l",
                  clusters=[0, 1, 2, 3]),
        GraphNode(job, {"x": ops["x"], "y": Ref("src")}, name="r",
                  clusters=[4, 5, 6, 7]),
        GraphNode(job, {"x": Ref("l"), "y": Ref("r")}, name="join"),
    ]


def build_reshard():
    """A serial wide -> narrow -> wide chain: both edges pay a d2d
    reshard forward on the critical path.  Deliberate — it is the perf
    linter's worked example, so the file-level allow below keeps its
    ``OFLP104`` findings out of the gate while ``python -m
    repro_torch.lint`` still reports them."""
    # repro: allow(OFLP104) -- intentional reshard, the linter's example
    job, ops = _ops(3)
    return [
        GraphNode(job, ops, name="wide"),
        GraphNode(job, {"x": ops["x"], "y": Ref("wide")}, name="narrow",
                  clusters=[0, 1, 2, 3]),
        GraphNode(job, {"x": ops["x"], "y": Ref("narrow")}, name="tail"),
    ]


def build_graphs():
    """name -> GraphNode list."""
    return {"chain": build_chain(), "diamond": build_diamond(),
            "reshard": build_reshard()}
