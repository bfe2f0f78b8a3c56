"""What several metric readers share."""


def idle_share(rec, driver):
    """1 - busy / window of the profiled slice, in cells of ``driver``."""
    prof = rec.get("profile")
    if rec.get("driver") != driver or not prof or prof["busy_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
