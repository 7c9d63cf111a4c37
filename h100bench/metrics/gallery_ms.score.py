"""Host milliseconds of the gallery load in the traced call: the port's
spans ``score.gallery`` (the gallery's and the captions' rows) and
``score.upload`` (each bucket's padded tiles put on the card) under the
newest ``score.call`` of ``uc2_torch.utils.profiling.records()``. A
program without the spans: no reading."""

LOAD = ("score.gallery", "score.upload")


def read(trace):
    try:
        from uc2_torch.utils.profiling import records
    except ImportError:
        return None
    recs = records()
    call = next((r for r in reversed(recs) if r.name == "score.call"), None)
    if call is None:
        return None
    return sum(r.host_ms for r in recs
               if r.root == call.id and r.name in LOAD)
