"""knn_ms_per_event: milliseconds of each k-NN of the window's densify
events (the proximity rule's neighbours: sdpgs_torch.train.loop.knn,
ops/knn), a synchronised bracket around the call inside the event's
(host clock); their mean."""


def read(run):
    ms = run.brackets.get("knn") or []
    return sum(ms) / len(ms) if ms else None
