"""depth_net_replays_per_iter: CUDA-graph replays of the depth net, forward
and backward (the program's ``depth_net.replay`` spans,
models/depth_estimator.MonoDepth), a training iteration over the profiled
chunk: 0 where the net ran eagerly throughout; None where the program has
no graphed net, or the chunk no ``depth_net.forward`` span."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.traced_units:
        return None
    try:
        from sdpgs_torch.models.depth_estimator import REPLAY_SPAN
        from sdpgs_torch.utils.profiling import spans
    except ImportError:     # a program without spans or without the graphed net
        return None
    recs = spans()
    if not any(s.name == "depth_net.forward" for s in recs):
        return None
    return sum(s.n for s in recs if s.name == REPLAY_SPAN) / run.traced_units
