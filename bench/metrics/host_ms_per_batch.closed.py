"""Host milliseconds in the window's busy polls per dispatched batch
(``Run.host_ms_per_batch``)."""


def read(run):
    return run.host_ms_per_batch()
