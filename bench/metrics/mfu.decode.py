"""The least time of the window's generation calls (``bench.work``: each
insert's prefill and the fewest decode steps, each reading the bf16
weights once and every live position's cache) over the window's time."""


def read(rec):
    if rec.get("driver") != "batch_generate":
        return None
    return 100.0 * rec["least_s"] / rec["window_s"]
