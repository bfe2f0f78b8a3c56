"""The profiled call's grouped expert products: their least time from the
shapes (``bench/arch``'s ``call_experts_least_s``: the prefill's and each
decode step's routed rows, ``top_k`` experts' bf16 weights) over the
device time of the grouped GEMM kernels ``torch._grouped_mm`` launches,
found by name in the trace."""

#: parts of the grouped GEMM kernels' names
GROUPED = ("grouped", "GroupProblemShape")


def read(rec):
    prof = rec.get("profile") or {}
    kernel = sum(s for name, s in prof.get("kernel_s", {}).items()
                 if any(g.lower() in name.lower() for g in GROUPED))
    if rec.get("driver") != "generate" or kernel <= 0:
        return None
    return 100.0 * prof["experts_bound_s"] / kernel
