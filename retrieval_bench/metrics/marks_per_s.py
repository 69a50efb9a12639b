"""Crime-scene marks ranked over the whole window, over the window's whole
time (the window runs whole batches: it ends when the batch that crosses
``--seconds`` finishes)."""


def read(run):
    return run.marks / run.window_s
