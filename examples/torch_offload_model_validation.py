"""Analytical-model walkthrough on the PyTorch port: reproduce the paper's
eqs. 5/6 and fig. 12 validation, then use the model the way the paper
intends — to make offload decisions, including the session API's
``policy=AUTO`` mode selection.  The twin of
``examples/offload_model_validation.py``: the same sections and lines.

    PYTHONPATH=src python examples/torch_offload_model_validation.py

Pure analytics over ``repro_torch.core.model`` and ``simulator``: it
touches no device, so unlike the other walkthroughs it takes no
``--device``.
"""

import argparse

from repro_torch.api import AUTO, estimate
from repro_torch.core import jobs, model, simulator


def main(argv=None) -> None:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)

    print("=== eq. 5 (paper, verbatim) vs our structural model ===")
    print(f"{'N':>6} {'n':>3} {'eq.5':>10} {'structural':>10} {'simulated':>10}")
    for N in (256, 1024, 4096):
        for n in (1, 8, 32):
            eq5 = model.axpy_closed_form(n, N)
            ours = model.predict_total(jobs.axpy_spec(N), n)
            sim = simulator.simulate(jobs.axpy_spec(N), n, "multicast").total
            print(f"{N:6d} {n:3d} {eq5:10.1f} {ours:10.1f} {sim:10.1f}")

    print("\n=== fig. 12: model error across kernels (paper: <15 %) ===")
    cases = {
        "axpy": (jobs.axpy_spec, [(64,), (256,), (1024,)]),
        "atax": (jobs.atax_spec, [(32, 32), (128, 128)]),
        "matmul": (lambda s: jobs.matmul_spec(s, s, s), [(16,), (64,)]),
        "covariance": (lambda s: jobs.covariance_spec(s, 2 * s), [(32,)]),
        "montecarlo": (jobs.montecarlo_spec, [(16384,)]),
        "bfs": (jobs.bfs_spec, [(256,)]),
    }
    for name, (mk, sizes) in cases.items():
        v1 = model.max_rel_error(model.validate(mk, sizes, (1, 2, 4, 8, 16, 32)))
        v2 = model.max_rel_error(model.validate(
            mk, sizes, (1, 2, 4, 8, 16, 32), predictor=model.predict_total_v2))
        print(f"  {name:12s} eq.4 model: {v1*100:5.2f}%   "
              f"+port-bound (ours): {v2*100:5.2f}%")

    print("\n=== the offload decision (paper §1: 'if' and 'how') ===")
    for name, mk in (("axpy-256", lambda: jobs.axpy_spec(256)),
                     ("axpy-65536", lambda: jobs.axpy_spec(65536)),
                     ("atax-64", lambda: jobs.atax_spec(64, 64))):
        n, t = model.optimal_clusters(mk)
        host = 3.0 * model.predict_total(mk(), 1)   # pretend host is 3x slower
        go, n2, t2 = model.should_offload(mk(), host)
        print(f"  {name:12s}: offload to n={n:2d} (predicted {t:8.0f} cyc); "
              f"vs host {host:8.0f} cyc -> offload={go}")

    print("\n=== Session.estimate: the model as an API contract (AUTO) ===")
    for name, mkjob in (("axpy-16k", lambda: jobs.make_axpy(16384)),
                        ("matmul-256", lambda: jobs.make_matmul(256, 256, 256)),
                        ("covariance-64", lambda: jobs.make_covariance(64, 128))):
        est = estimate(mkjob(), n=8, batch=16, policy=AUTO)
        d = est.decision
        sim = simulator.simulate(mkjob().spec, 8, "multicast").total
        err = simulator.model_error(est.job_cycles, sim)
        print(f"  {name:14s}: fuse={d.fuse} window={d.window} "
              f"staging={d.staging.value:7s}  predicted {est.job_cycles:9.0f} "
              f"cyc (sim {sim:9.0f}, err {err * 100:4.1f}%)")


if __name__ == "__main__":
    main()
