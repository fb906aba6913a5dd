"""FastAPI transport over the shared serving endpoints.

Counterpart of `plotpointe_tpu/serving/app.py`: GET /healthz, POST /startup,
POST /recommend and POST /feedback. All request handling lives in
`serving/endpoints.ServingState`; this module only adapts it to FastAPI
(pydantic request models, HTTPException on non-200). fastapi and pydantic
are imported inside `create_app`, so the package carries no serving
dependency; without them, serve with the stdlib transport (serving/httpd.py).
"""
from __future__ import annotations

from typing import List, Optional

from plotpointe_tpu_torch.serving.endpoints import ServingState

SERVING_EXTRA = ("the FastAPI app needs fastapi, pydantic and uvicorn: install the package's "
                 "`serving` extra, or serve with --stdlib")


def create_app(telemetry=None):
    try:
        from fastapi import FastAPI, HTTPException
        from pydantic import BaseModel
    except ImportError as e:
        raise ImportError(SERVING_EXTRA) from e

    state = ServingState(telemetry=telemetry)
    app = FastAPI(title="plotpointe-tpu-torch recommender")

    class StartupBody(BaseModel):
        item_embeddings_uri: str
        item_index_map_uri: Optional[str] = None
        topk: int = 20
        project_id: Optional[str] = None
        use_device: bool = True

    class RecommendBody(BaseModel):
        item_ids: List[int]
        k: Optional[int] = None
        user_key: Optional[str] = None

    class FeedbackBody(BaseModel):
        request_id: str
        item_id: int
        event_type: str = "click"
        value: float = 1.0
        user_key: Optional[str] = None

    def unwrap(reply):
        code, body = reply
        if code != 200:
            raise HTTPException(status_code=code, detail=body.get("detail", "error"))
        return body

    @app.on_event("startup")
    def _bootstrap():
        state.startup_from_env()

    @app.get("/healthz")
    def healthz():
        return unwrap(state.healthz())

    @app.post("/startup")
    def startup(body: StartupBody):
        return unwrap(state.startup(body.dict()))

    @app.post("/recommend")
    def recommend(body: RecommendBody):
        return unwrap(state.recommend(body.dict()))

    @app.post("/feedback")
    def feedback(body: FeedbackBody):
        return unwrap(state.feedback(body.dict()))

    return app
