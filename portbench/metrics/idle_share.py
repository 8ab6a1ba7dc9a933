"""Share of the traced slice in which no operation ran on the device, in %
(``idle_share.chat``, ``.docqa``, ``.train``)."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
