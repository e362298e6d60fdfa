"""serve.gather_ms: the mean, over the flushes within the traced stretch,
of the batcher's wait for batch-mates once a flush's first request is
picked up (the program's ``serve.gather`` spans), in ms."""
from portbench import spans


def read(run):
    v = spans.mean([r.end_ns - r.start_ns
                    for r in spans.records(run, "serve.gather")])
    return None if v is None else v / 1e6
