"""Set-up: from the process's start to the window's: imports, the device,
the dataset, the weights, the pipeline, the standing gallery's extraction
where the cell has one, the kernel's build where the checkout lacks it,
and the warm batches."""


def read(run):
    return run.setup_s
