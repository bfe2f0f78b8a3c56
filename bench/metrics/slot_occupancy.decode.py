"""Tokens the engine emitted over the slots its decode steps offered:
``tokens_emitted / (xla_dispatches * batch)`` from ``ServeEngine.stats``
over the window."""


def read(rec):
    stats = rec.get("stats")
    if rec.get("driver") != "batch_generate" or not stats:
        return None
    steps = stats["xla_dispatches"]
    return stats["tokens_emitted"] / (steps * rec["batch"]) if steps else None
