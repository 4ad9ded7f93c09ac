"""Padded query slots over all query slots of the window's steps (%),
counted from the host batches' masks: the bucket padding of ragged query
clips, which the backbone computes and the vote throws away."""


def read(run):
    slots = run.counters.get("query_slots")
    if not slots:
        return None
    return 100.0 * (slots - run.counters["query_real"]) / slots
