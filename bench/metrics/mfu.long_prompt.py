"""The least time of the window's ``generate`` cycles (``bench/arch``'s
``call_least_s``: each prefill's model FLOPs at the bf16 peak, each decode
step's least bytes at the HBM rate) over the window's time."""


def read(rec):
    if rec.get("driver") != "generate":
        return None
    return 100.0 * rec["least_s"] / rec["window_s"]
