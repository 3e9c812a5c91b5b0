"""The device's idle share over the traced slice: 1 - the union of its
kernel, copy and set intervals over the slice's length, in %."""

from portbench.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
