"""Blocking waits for the card a round: the synchronisations and blocking
copies the host made in the window (the round's loop test is one), over
one card's rounds, averaged over the cards. ``None`` without spans."""

from benchmarks import spans


def read(record):
    if spans.buckets(record, "pt.round") is None:
        return None
    return spans.per_round(record, [sum(b["waits"][0] for b in r["trace"]["spans"].values())
                                    for r in record["ranks"]])
