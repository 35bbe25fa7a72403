"""Images trained on per second over the whole window: each update
consumes two batches, as the reference's trainer does; the window is
closed by a synchronize."""


def read(r):
    if r.get("kind") != "train" or not r.get("window_s"):
        return None
    return 2 * r["batch"] * r["updates"] / r["window_s"]
