"""Share of the traced slice in which no operation ran on the device, in %
(``Run.idle_share``)."""


def read(run):
    return run.idle_share()
