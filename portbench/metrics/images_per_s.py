"""images_per_s: images whose logits reached the host within the window,
over the window."""


def read(run):
    return None if run.images is None else run.images / run.seconds
