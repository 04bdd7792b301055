"""idle_share (device trace): the share of the traced window in
which no operation ran on the card, averaged over the ranks. Percent."""

from benchmark.trace import idle_share


def read(run):
    return idle_share(run.trace)
