"""serve.batch_fill: how full the batcher's flushes ran over the window,
in %: the rows that carried a request over all rows flushed, from
BatchServer.stats (flushes x batch - padded_rows, over flushes x batch)."""


def read(run):
    d = run.server_delta
    if d is None or d["flushes"] <= 0:
        return None
    rows = d["flushes"] * run.batch
    return 100.0 * (rows - d["padded_rows"]) / rows
