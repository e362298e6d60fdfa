"""served_rps: requests answered within the window, over the window."""


def read(run):
    return None if run.completed is None else run.completed / run.seconds
