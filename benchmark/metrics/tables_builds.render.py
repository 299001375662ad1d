"""Table builds a render in the traced slice: the program's flat, empty
``rayz.tables_built`` spans (one after each ``rayz.tables`` in which the
render built its scene's tables, none where the per-scene memo handed back
the tables an earlier render built), over the slice's requests. 0.0 where
the slice holds ``rayz.tables`` spans and no build; None where it holds
no ``rayz.tables``, or where the program has no table memo and so records
no such span (it builds on every render)."""

from benchmark import spans


def _has_memo() -> bool:
    from rayz_tpu_torch.ops import tables
    return hasattr(tables, "TABLE_MEMO")


def read(run):
    sl = run.slice
    if not spans.intervals(sl, "rayz.tables") or not _has_memo():
        return None
    built = [e for e in sl.host if e.get("cat") == "user_annotation"
             and e["name"] == "rayz.tables_built"
             and sl.t0 <= e["ts"] <= sl.t1]
    return len(built) / sl.requests
