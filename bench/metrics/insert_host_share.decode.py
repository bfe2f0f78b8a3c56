"""The share of the window's ``generate_many`` calls the host spent in
the inserts: ``insert_host_ns / call_host_ns`` from ``ServeEngine.stats``
over the window.  It includes the inserts' waits for the device (a
prompt's upload from pageable memory waits for the stream), so it is host
time held by the inserts, not the inserts' own Python alone."""


def read(rec):
    stats = rec.get("stats")
    if rec.get("driver") != "batch_generate" or not stats \
            or not stats.get("call_host_ns"):
        return None
    return stats["insert_host_ns"] / stats["call_host_ns"]
