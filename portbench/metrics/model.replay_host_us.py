"""model.replay_host_us: the mean, over the calls within the traced
stretch, of the compiled callable's host time per call (the program's
``model.replay`` spans: the lock, the capture lookup, the input copy's and
the replay's enqueue, the output's clone), in us."""
from portbench import spans


def read(run):
    v = spans.mean([r.end_ns - r.start_ns
                    for r in spans.records(run, "model.replay")])
    return None if v is None else v / 1e3
