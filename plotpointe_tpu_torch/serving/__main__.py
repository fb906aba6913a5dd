"""`python -m plotpointe_tpu_torch.serving` — the stdlib server configured by
environment variables (a container's command), as `python -m
plotpointe_tpu.serving` is:

  ITEM_EMBEDDINGS_URI  npy to load at start (local, file:// or gs://); unset:
                       start empty and wait for POST /startup
  ITEM_INDEX_MAP_URI   optional item index map (json)
  TOPK                 default k (20)
  SERVING_USE_DEVICE   unset or "1": score on the GPU (the top-K kernels);
                       "0": the numpy path on the host
  TELEMETRY_DIR        log requests and feedback there (a durable queue
                       found under it is reused)
  HOST, PORT           listen address (0.0.0.0:8080)
"""
import os

from plotpointe_tpu_torch.serving.httpd import serve
from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig


def main():
    rt = None
    uri = os.environ.get("ITEM_EMBEDDINGS_URI")
    if uri:
        rt = RecommenderRuntime(
            ServingConfig(
                item_embeddings_uri=uri,
                item_index_map_uri=os.environ.get("ITEM_INDEX_MAP_URI"),
                topk=int(os.environ.get("TOPK", "20")),
                use_device=os.environ.get("SERVING_USE_DEVICE", "1") == "1",
            )
        )
        rt.startup()
    telemetry = None
    tel_dir = os.environ.get("TELEMETRY_DIR")
    if tel_dir:
        from plotpointe_tpu_torch.serving.telemetry import ServingTelemetry

        telemetry = ServingTelemetry(root=tel_dir)
    host = os.environ.get("HOST", "0.0.0.0")
    port = int(os.environ.get("PORT", "8080"))
    print(f"serving on {host}:{port} loaded={rt is not None} telemetry={telemetry is not None}", flush=True)
    serve(host, port, runtime=rt, telemetry=telemetry, block=True)


if __name__ == "__main__":
    main()
