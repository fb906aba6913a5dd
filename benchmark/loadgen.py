"""The open-loop HTTP client, a process of its own so that its threads do
not share the server's interpreter lock. Standard library only.

    python benchmark/loadgen.py --port P

Reads one JSON object from standard input: {"schedule": [[offset_s,
history, k], ...]}, then waits for a line "go". It sends each POST
/recommend at its due time (the moment of "go" plus its offset) from a pool
of WORKERS threads, whatever came back before, and writes one JSON object
to standard output: per request [due, sent, done, status] on the
monotonic clock (shared with the server's process) and each reply's body.
A request with no reply within TIMEOUT_S has status 0 and done = null."""
from __future__ import annotations

import argparse
import http.client
import json
import queue
import sys
import threading
import time

WORKERS = 256  # more than the requests in flight at any offered rate below the knee
TIMEOUT_S = 30.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args()
    sched = json.loads(sys.stdin.readline())["schedule"]
    bodies = [json.dumps({"item_ids": h, "k": k}).encode() for _, h, k in sched]
    rows = [None] * len(sched)
    replies = [None] * len(sched)
    todo: "queue.Queue" = queue.Queue()

    def worker():
        while True:
            job = todo.get()
            if job is None:
                return
            i, due = job
            sent = time.perf_counter()
            status, done, body = 0, None, None
            conn = http.client.HTTPConnection("127.0.0.1", args.port, timeout=TIMEOUT_S)
            try:
                conn.request("POST", "/recommend", bodies[i], {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                done, status = time.perf_counter(), resp.status
            except (OSError, http.client.HTTPException):
                pass
            finally:
                conn.close()
                rows[i] = [due, sent, done, status]
                replies[i] = None if body is None else body.decode("utf-8", "replace")
                todo.task_done()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(WORKERS)]
    for t in threads:
        t.start()
    print("ready", file=sys.stderr, flush=True)
    if sys.stdin.readline().strip() != "go":
        return 2
    t0 = time.perf_counter() + 0.01
    for i, (offset, _, _) in enumerate(sched):
        due = t0 + offset
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        todo.put((i, due))
    todo.join()  # every reply stamped before the idle threads wake to end
    for _ in threads:
        todo.put(None)
    for t in threads:
        t.join()
    json.dump({"t0": t0, "rows": rows, "replies": replies}, sys.stdout)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
