"""Share of the traced window in which no operation ran on the card: one
minus the union of the device's activity intervals over the window,
averaged over the cards of the run."""


def read(record):
    ranks = record["ranks"]
    return 100.0 * sum(1.0 - r["trace"]["busy_s"] / r["trace"]["window_s"]
                       for r in ranks) / len(ranks)
