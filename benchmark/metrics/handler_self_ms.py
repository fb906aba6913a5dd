"""handler_self_ms: the self time of the program's `http.request` spans of
/recommend over the traced window: each request's span less the part its
`serve.recommend` child covers (the body's parse, the JSON and the write
remain), mean per request, in ms."""
from benchmark.program_spans import records
from benchmark.tracing import merged


def read(obs):
    recs = records(obs, "http.request", "serve.recommend")
    kids = {}
    for r in recs:
        if r.name == "serve.recommend":
            kids.setdefault(r.parent, []).append(r)
    selves = []
    for r in recs:
        if r.name == "http.request" and r.meta.get("route") == "/recommend":
            inner = [("", max(k.t0, r.t0), min(k.t1, r.t1) - max(k.t0, r.t0))
                     for k in kids.get(r.id, ())]
            selves.append((r.t1 - r.t0) - sum(b - a for a, b in merged(inner) if b > a))
    return sum(selves) / len(selves) * 1e3 if selves else None
