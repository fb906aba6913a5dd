"""Transport-agnostic serving endpoints.

Counterpart of `plotpointe_tpu/serving/endpoints.py::ServingState`:
GET /healthz, POST /startup, POST /recommend {item_ids, k} -> {indices,
scores[, request_id]}, POST /feedback. Every endpoint is a function from a
parsed payload to an (http_status, body) pair; the stdlib HTTP transport
(httpd.py) and the FastAPI app (app.py) delegate here. With telemetry, each
served request is logged and its reply carries the `request_id` that
/feedback refers to; rejected requests and feedback go to the rejects sink.
/recommend runs in span `serve.recommend` (`utils/tracing.py`) under the
transport's request id, or a new one.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

from plotpointe_tpu_torch.serving.batching import MicroBatcher
from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig
from plotpointe_tpu_torch.utils import tracing

Reply = Tuple[int, Dict[str, Any]]

MSG_NOT_LOADED = "runtime unavailable: load embeddings via POST /startup or ITEM_EMBEDDINGS_URI"
MSG_NO_ITEMS = "item_ids required"


class ServingState:
    """The live runtime, optional telemetry (serving/telemetry.py) and
    optional micro-batcher of one server.

    micro_batch=True coalesces concurrent /recommend calls into one batched
    scoring call (serving/batching.py)."""

    def __init__(self, runtime: Optional[RecommenderRuntime] = None, telemetry=None,
                 micro_batch: bool = False, micro_batch_max: int = 64,
                 micro_batch_wait_ms: float = 3.0, micro_batch_in_flight: int = 4):
        self.runtime = runtime
        self.telemetry = telemetry
        self.micro_batch = micro_batch
        self.micro_batch_max = micro_batch_max
        self.micro_batch_wait_ms = micro_batch_wait_ms
        self.micro_batch_in_flight = micro_batch_in_flight
        self.batcher: Optional[MicroBatcher] = None
        if runtime is not None:
            self._refresh_batcher()

    def _refresh_batcher(self) -> None:
        if self.batcher is not None:
            self.batcher.close()
            self.batcher = None
        if self.micro_batch and self.runtime is not None:
            self.batcher = MicroBatcher(self.runtime, max_batch=self.micro_batch_max,
                                        max_wait_ms=self.micro_batch_wait_ms,
                                        max_in_flight=self.micro_batch_in_flight)

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()
            self.batcher = None

    def healthz(self) -> Reply:
        return 200, {"status": "ok"}

    def startup(self, payload: Dict[str, Any]) -> Reply:
        uri = payload.get("item_embeddings_uri")
        if not uri:
            return 400, {"detail": "missing field: 'item_embeddings_uri'"}
        cfg = ServingConfig(
            item_embeddings_uri=uri,
            item_index_map_uri=payload.get("item_index_map_uri"),
            topk=int(payload.get("topk", 20)),
            project_id=payload.get("project_id"),
            use_device=bool(payload.get("use_device", True)),
        )
        rt = RecommenderRuntime(cfg)
        try:
            rt.startup()
        except FileNotFoundError as e:
            return 400, {"detail": str(e)}
        self.runtime = rt
        self._refresh_batcher()
        return 200, {"status": "ok"}

    def recommend(self, payload: Dict[str, Any]) -> Reply:
        with tracing.span("serve.recommend", rid=tracing.request_id()):
            return self._recommend(payload)

    def _recommend(self, payload: Dict[str, Any]) -> Reply:
        if self.runtime is None:
            return 503, {"detail": MSG_NOT_LOADED}
        raw_ids = payload.get("item_ids")
        if not raw_ids:
            return 400, {"detail": MSG_NO_ITEMS}
        t0 = time.perf_counter()
        try:
            ids = [int(x) for x in raw_ids]
            if self.batcher is not None:
                # validate per request BEFORE coalescing so one bad request
                # can't fail a whole batch
                self.runtime.validate_history(ids)
                k = int(payload.get("k") or self.runtime.cfg.topk)
                idx, scores = self.batcher.submit(ids, k)
            else:
                idx, scores = self.runtime.top_k_for_user_items(ids, k=payload.get("k"))
        except (IndexError, ValueError) as e:
            if self.telemetry is not None:
                self.telemetry.log_reject("recommend", payload, f"bad item_ids: {e}")
            return 400, {"detail": f"bad item_ids: {e}"}
        except TimeoutError as e:
            # batcher dispatch timed out (device wedged or overloaded): the
            # client should retry, and the handler must answer JSON, not die
            return 503, {"detail": f"scoring timed out: {e}"}
        except Exception as e:  # noqa: BLE001 - JSON 500 beats a dead socket
            if self.telemetry is not None:
                self.telemetry.log_reject("recommend", payload, f"{type(e).__name__}: {e}"[:200])
            return 500, {"detail": f"internal error: {type(e).__name__}: {e}"}
        body: Dict[str, Any] = {"indices": idx.tolist(), "scores": [float(x) for x in scores.tolist()]}
        if self.telemetry is not None:
            # from before validation: the batcher's wait counts, as in the JAX package
            latency_ms = (time.perf_counter() - t0) * 1000.0
            body["request_id"] = self.telemetry.log_request(
                body["indices"], body["scores"], latency_ms, user_key=payload.get("user_key"))
        return 200, body

    def feedback(self, payload: Dict[str, Any]) -> Reply:
        if self.telemetry is None:
            return 503, {"detail": "telemetry not enabled"}
        try:
            self.telemetry.log_feedback(
                request_id=payload["request_id"],
                item_id=int(payload["item_id"]),
                event_type=str(payload.get("event_type", "click")),
                value=float(payload.get("value", 1.0)),
                user_key=payload.get("user_key"),
            )
        except (KeyError, TypeError, ValueError) as e:
            self.telemetry.log_reject("feedback", payload, f"{type(e).__name__}: {e}")
            return 400, {"detail": f"bad feedback payload: {e}"}
        return 200, {"status": "ok"}

    def startup_from_env(self) -> bool:
        """Load the runtime from ITEM_EMBEDDINGS_URI, ITEM_INDEX_MAP_URI, TOPK
        and PROJECT_ID (or GOOGLE_CLOUD_PROJECT) if the first is set. Returns
        True when a runtime was loaded."""
        uri = os.getenv("ITEM_EMBEDDINGS_URI")
        if not uri:
            return False
        code, _ = self.startup({
            "item_embeddings_uri": uri,
            "item_index_map_uri": os.getenv("ITEM_INDEX_MAP_URI"),
            "topk": int(os.getenv("TOPK", "20")),
            "project_id": os.getenv("PROJECT_ID", os.getenv("GOOGLE_CLOUD_PROJECT")),
        })
        return code == 200
