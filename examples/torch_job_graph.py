"""Dependent job graphs on the PyTorch port, statically verified before
dispatch — the twin of ``examples/job_graph.py``'s ``main()``.

Takes the two canonical graph shapes (a K=8 self-scaling chain and a
diamond whose arms run on disjoint cluster windows) from the port's
corpus (``repro_torch.analysis.corpus.job_graph``), runs them through
``verify_graph`` — zero diagnostics — then submits them on 8 logical
clusters and shows the scoreboarded out-of-order dispatch path: 0
intermediate d2h bytes, one device-to-device forward per edge.  Then the
perf linter's reshard chain and its autofix, and finally a seeded defect
(a dependency cycle) rejected by the submit gate *before* any staging,
with a stable ``OFL001`` diagnostic.

    PYTHONPATH=src python examples/torch_job_graph.py             # the card
    PYTHONPATH=src python examples/torch_job_graph.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.analysis import perflint
from repro_torch.analysis.corpus.job_graph import (
    CHAIN_K, N, build_chain, build_diamond, build_graphs, build_reshard,
)
from repro_torch.api import GraphNode, Ref, Session, VerificationError, verify_graph
from repro_torch.core import jobs

CLUSTERS = 8


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    print("=== 1. static verification: both graphs come back clean ===")
    for name, nodes in build_graphs().items():
        diags = verify_graph(nodes, default_width=8)
        print(f"  {name}: {len(nodes)} nodes -> {len(diags)} diagnostics")
        assert not diags

    print("\n=== 2. the chain: forwarded results, 0 intermediate d2h ===")
    sess = Session(device=args.device, num_clusters=CLUSTERS)
    nodes = build_chain()
    out = sess.submit_graph(nodes).wait()
    final = out[f"n{CHAIN_K - 1}"]
    print(f"  forwards={sess.stats.forwards} (one per edge), "
          f"intermediate d2h bytes="
          f"{sess.stats.d2h_bytes - final.nbytes}")

    seq = np.asarray(nodes[0].operands["y"], dtype=np.float64)
    x = np.asarray(nodes[0].operands["x"], dtype=np.float64)
    for _ in range(CHAIN_K):
        seq = 2.5 * x + seq
    print(f"  allclose vs sequential numpy: "
          f"{np.allclose(np.asarray(final), seq)}")

    print("\n=== 3. the diamond: both arms in flight concurrently ===")
    gh = sess.submit_graph(build_diamond())
    gh.wait()
    print(f"  max_inflight={gh.max_inflight} (>= 2: arms overlapped)")

    print("\n=== 4. perf lint: the reshard chain leaves cycles on "
          "the table ===")
    nodes = build_reshard()
    findings = perflint.lint_graph(nodes, default_width=8)
    for f in findings:
        print(f"  {f}")
    fixed = perflint.apply(findings, nodes=nodes).nodes
    out_a = sess.submit_graph(nodes).wait()
    out_b = sess.submit_graph(fixed).wait()
    same = all(np.array_equal(np.asarray(out_a[k]), np.asarray(out_b[k]))
               for k in out_a)
    print(f"  autofixed graph bit-identical: {same}")

    print("\n=== 5. a seeded defect is rejected before any staging ===")
    job = jobs.make_axpy(N)
    ops, _ = job.make_instance(2)
    bad = [GraphNode(job, {"x": ops["x"], "y": Ref("b")}, name="a"),
           GraphNode(job, {"x": ops["x"], "y": Ref("a")}, name="b")]
    try:
        sess.submit_graph(bad)
    except VerificationError as e:
        print(f"  codes={e.codes}")
        for d in e.diagnostics:
            print(f"  {d}")
    sess.close()


if __name__ == "__main__":
    main()
