"""serve.queue_wait_ms: the mean, over the requests enqueued and answered
within the traced stretch, of the time from ``BatchServer``'s enqueue to
its worker's pick-up (the program's ``serve.request`` records), in ms."""
from portbench import spans


def read(run):
    v = spans.mean([r.attrs["picked"] - r.start_ns
                    for r in spans.records(run, "serve.request")])
    return None if v is None else v / 1e6
