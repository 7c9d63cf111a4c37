"""The share of the traced call's scored slots that hold no pair: 1 -
``pairs`` (captions x images) / ``slots`` (captions x tiles x batch size),
the counts of the newest ``score.call`` span of
``uc2_torch.utils.profiling.records()``, in percent. A program without
the span: no reading."""


def read(trace):
    try:
        from uc2_torch.utils.profiling import records
    except ImportError:
        return None
    call = next((r for r in reversed(records()) if r.name == "score.call"),
                None)
    if call is None or not call.counts.get("slots"):
        return None
    return 100.0 * (1.0 - call.counts["pairs"] / call.counts["slots"])
