"""Model FLOPs of the window's training steps (the architecture's
``train_step_flops``: 6 N T and the causal attention, no recompute) over
the window, as a share of the H100's bf16 peak."""

from bench import work


def read(rec):
    if rec.get("driver") != "train":
        return None
    return (100.0 * rec["model_flops"] / rec["window_s"]
            / work.PEAK_BF16_FLOPS)
