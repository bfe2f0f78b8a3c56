"""The share of the window's ``generate_many`` calls the host spent in
the engine's own Python outside its device calls (the arrivals, the
queue, the choice of slots, the loop's checks): the call's host time less
its inserts, its ragged steps' launches, its retire loops and its drain,
over the call's, from ``ServeEngine.stats`` over the window.  The parts
taken away hold whatever wait for the device their calls meet, so this
share holds none of it."""

PARTS = ("insert_host_ns", "step_host_ns", "retire_host_ns", "drain_host_ns")


def read(rec):
    stats = rec.get("stats")
    if rec.get("driver") != "batch_generate" or not stats \
            or not stats.get("call_host_ns") \
            or any(k not in stats for k in PARTS):
        return None
    call = stats["call_host_ns"]
    return (call - sum(stats[k] for k in PARTS)) / call
