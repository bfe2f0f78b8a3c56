"""The profiled call's inserts: their flash calls' least time from the
shapes (``bench.arch``'s ``prefill_flash_bound_s``, each prompt but its
last token, not the bucket it is padded to) over the flash kernels'
device time."""


def read(rec):
    prof = rec.get("profile") or {}
    kernel = sum(s for name, s in prof.get("kernel_s", {}).items()
                 if "flash" in name)
    if rec.get("driver") != "batch_generate" or kernel <= 0:
        return None
    return 100.0 * prof["flash_bound_s"] / kernel
