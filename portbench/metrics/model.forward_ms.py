"""model.forward_ms: the mean, over every call of the window, of the
compiled callable's device span (CUDA events before and after the call)."""


def read(run):
    if not run.forward_ms:
        return None
    return sum(run.forward_ms) / len(run.forward_ms)
