"""Mean rows per engine call in the window, from the program's
``ServerMetrics`` batch counters (``make_batchers(engine, metrics=...)``)."""


def read(r):
    if r.get("kind") != "serve" or not r.get("batch_dispatches"):
        return None
    return r["batch_rows"] / r["batch_dispatches"]
