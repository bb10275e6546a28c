"""Images trained over the whole window: every step the window enqueued,
the clock stopped once the device finished the last (host clock)."""


def read(record):
    w = record["window"]
    return len(w["calls"]) * w["images_per_call"] / (w["t1"] - w["t0"])
