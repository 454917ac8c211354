"""Host time a round that is not spent waiting for the card: the traced
window less the host's time inside calls that wait for the device, over
the rounds of one card. In the traced run it includes the profiler's own
cost per op."""


def read(record):
    ranks = record["ranks"]
    rounds = record["rounds"] / record["world"]
    host = sum(r["trace"]["window_s"] - r["trace"]["blocked_s"] for r in ranks) / len(ranks)
    return 1e3 * host / rounds
