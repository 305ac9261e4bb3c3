"""The share of the SAM heads' calls that replayed a CUDA graph, in %: the
count of ``sam_heads.graph`` markers (one per replay) over the count of
``sam_heads`` spans in the spans-only unit. Nothing where no replay was
marked, as in a program without the graph."""

from portbench.lib.spans import program_spans


def read(ctx):
    s = program_spans(ctx)
    if s is None:
        return None
    t = s["totals"]
    replays = t.get("sam_heads.graph", {"count": 0})["count"]
    calls = t.get("sam_heads", {"count": 0})["count"]
    if replays == 0 or calls == 0:
        return None
    return 100.0 * replays / calls
