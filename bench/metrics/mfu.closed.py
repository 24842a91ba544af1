"""The window's reference FLOPs over its seconds x cards x 495 TFLOP/s, in %
(``Run.window_mfu``)."""


def read(run):
    return run.window_mfu()
