#!/usr/bin/env bash
# Bootstrap of one H100 GPU VM for plotpointe_tpu_torch: Python deps, the
# artifact tree, and the device smoke test (`cli smoke`, which builds the
# smoke kernel with nvcc and runs the five capability checks). One VM runs
# the whole pipeline; see deploy_torch/README.md for the resource mapping.
#
#   python -m plotpointe_tpu_torch.cli provision render | grep -A1 gpu_vm   # the create line
#   gcloud compute ssh plotpointe-h100 --zone=$ZONE \
#     --command="$(cat deploy_torch/bootstrap_gpu_vm.sh)"
#
# The VM image must carry the NVIDIA driver and the CUDA toolkit (nvcc): the
# kernels are compiled from plotpointe_tpu_torch/csrc at first use.
set -euo pipefail

REPO_URL=${REPO_URL:-}
WORKDIR=${WORKDIR:-$HOME/plotpointe_tpu}
ARTIFACTS=${ARTIFACTS:-$HOME/artifacts}
CUDA_HOME=${CUDA_HOME:-/usr/local/cuda}

log() { echo "[bootstrap] $*"; }

log "checking the card and the CUDA toolkit"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"$CUDA_HOME/bin/nvcc" --version | tail -n 1

log "installing runtime deps"
pip install --quiet torch --index-url https://download.pytorch.org/whl/cu128
pip install --quiet numpy pandas pyarrow pyyaml pillow

if [ -n "$REPO_URL" ] && [ ! -d "$WORKDIR" ]; then
  log "cloning $REPO_URL"
  git clone "$REPO_URL" "$WORKDIR"
fi
cd "$WORKDIR"
export PYTHONPATH="$WORKDIR"
export PATH="$CUDA_HOME/bin:$PATH"

# the local artifact store's tree (gs:// prefixes work wherever a prefix does)
mkdir -p "$ARTIFACTS"/{staging,embeddings,graphs,models,exports,telemetry}

log "device smoke test (kernel build + five capability checks)"
python -m plotpointe_tpu_torch.cli smoke

log "done — run the pipeline with:"
echo "  python -m plotpointe_tpu_torch.cli pipeline --workdir $ARTIFACTS --parallel"
echo "  python -m plotpointe_tpu_torch.cli serve --stdlib --port 8080"
