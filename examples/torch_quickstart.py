"""Quickstart on the PyTorch port: the paper's offload runtime in two
minutes — the twin of ``examples/quickstart.py``, with the same sections.

Drives the paper's AXPY kernel (the hand-written CUDA kernel on the card)
through the session API (typed policies, one submit path, ``policy=AUTO``
model-driven mode selection) on 8 logical clusters, compares both offload
implementations' collective structure (from the runtime's launch trace,
where the reference reads its HLO text), and asks the analytical model
for the optimal offload width.

    PYTHONPATH=src python examples/torch_quickstart.py             # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.api import (
    AUTO, InfoDist, OffloadPolicy, Residency, Session,
)
from repro_torch.core import jobs, model, simulator
from repro_torch.core.multicast import CLUSTER_OFFSET_BITS, MulticastRequest
from repro_torch.core.offload import count_collectives

CLUSTERS = 8


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    job = jobs.make_axpy(4096)
    # 8 logical clusters on one device; default policy=AUTO
    sess = Session(device=args.device, num_clusters=CLUSTERS)

    print("=== 1. one submit path, both implementations (8 clusters) ===")
    for label, pol in (("baseline ", OffloadPolicy(
                            info_dist=InfoDist.P2P_CHAIN,
                            completion="central_counter")),
                       ("multicast", AUTO)):
        operands, expected = job.make_instance(0)
        got = sess.submit(job, operands, n=8, policy=pol).wait()
        colls = count_collectives(sess.runtime(pol).launch_trace(job, 8))
        print(f"  {label}: allclose={np.allclose(got, expected)}  "
              f"chain={colls['collective-permute']} collective-permutes, "
              f"{colls['all-reduce']} all-reduce")

    print("\n=== 2. AUTO: fused + pipelined + resident, planner-picked ===")
    instances, exps = jobs.make_instances(job, 16, seed0=2)
    handle = sess.submit(job, instances, n=8)     # policy=AUTO
    results = handle.wait()
    ok = all(np.allclose(r, e) for r, e in zip(results, exps))
    d = handle.decision
    print(f"  16 jobs -> fuse={d.fuse}, window={d.window}, "
          f"staging={d.staging.value}; allclose={ok}")
    print("  predicted vs measured (handle.explain()):")
    for line in str(handle.explain()).splitlines():
        print(f"    {line}")
    sess.stage(job, instances[0], n=8)            # prime residency
    got = sess.submit(job, Residency.RESIDENT, n=8).wait()
    print(f"  resident redispatch: allclose={np.allclose(got, exps[0])}")

    print("\n=== 3. cluster selection via the paper's address-mask (fig. 5) ===")
    req = MulticastRequest(addr=1 << CLUSTER_OFFSET_BITS,
                           mask=0b110 << CLUSTER_OFFSET_BITS)
    devs, ids = sess.runtime().select_clusters(request=req)
    operands, expected = job.make_instance(1)
    got = sess.submit(job, operands, request=req).wait()
    print(f"  mask 0b110 over cluster bits -> clusters {ids}; "
          f"allclose={np.allclose(got, expected)}")

    print("\n=== 4. the simulator: what this offload costs on Occamy ===")
    for n in (1, 4, 8, 32):
        base = simulator.simulate(job.spec, n, 'baseline').total
        ext = simulator.simulate(job.spec, n, 'multicast').total
        print(f"  n={n:2d}: baseline={base:7.0f} cyc  multicast={ext:7.0f} cyc "
              f"  speedup={base/ext:.2f}x")

    print("\n=== 5. the analytical model: how wide should we offload? ===")
    for N in (64, 1024, 65536):
        n_opt, t = model.optimal_clusters(lambda: jobs.axpy_spec(N))
        print(f"  AXPY N={N:6d}: optimal n={n_opt:2d} "
              f"(predicted {t:.0f} cycles; eq.5 t̂=400+N/4+2.47N/8n)")
    sess.close()


if __name__ == "__main__":
    main()
