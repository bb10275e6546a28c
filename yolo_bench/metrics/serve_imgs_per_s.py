"""Images whose detections came back to the host, over the whole window:
every call of the window, on the host's clock."""


def read(record):
    w = record["window"]
    return len(w["calls"]) * w["images_per_call"] / (w["t1"] - w["t0"])
