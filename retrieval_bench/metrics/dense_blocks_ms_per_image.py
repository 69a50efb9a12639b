"""The device time of the backbone's dense blocks per image extracted: the
program's ``<stage>.net.denseblock<i>`` spans (``extract-query.net.denseblock1``,
``extract-gallery.net.denseblock2``), which on a card hold each block's
device seconds between CUDA events. ``None`` where the stage seconds hold no
such span (another backbone, or a program without device spans) or nothing
was extracted."""


def read(run):
    blocks = [v for k, v in run.stage_delta.items() if ".net.denseblock" in k]
    if not blocks or not run.images_extracted:
        return None
    return 1e3 * sum(blocks) / run.images_extracted
