"""Milliseconds a step of the port's span ``train.forward`` (the loss
function of each micro-batch) on the card's stream, between the span's
CUDA events: summed over a step's micro-batches, the mean over the
traced slice's steps (the newest ``trace.units`` ``train.step`` spans of
``uc2_torch.utils.profiling.records()``; a step without the span adds
0). Marks on the host's clock (no card) or a program without the spans:
no reading."""


def read(trace, span="train.forward"):
    try:
        from uc2_torch.utils.profiling import records
    except ImportError:
        return None
    recs = records()
    steps = [r for r in recs if r.name == "train.step"]
    if not trace.units or len(steps) < trace.units:
        return None
    steps = steps[-trace.units:]
    if not all(r.on_device for r in steps):
        return None
    ids = {r.id for r in steps}
    return sum(r.stream_ms() for r in recs
               if r.root in ids and r.name == span) / len(steps)
