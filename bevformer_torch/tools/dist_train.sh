#!/usr/bin/env bash
# Data-parallel training over NPROC processes of this host, one rank each: the
# torchrun counterpart of the JAX package's tools/dist_train.sh (and of the
# reference's torch.distributed.launch wrapper). Each rank joins the process
# group in bevformer_torch/runtime/distributed.py::maybe_initialize (NCCL on
# cuda:LOCAL_RANK; gloo with --device cpu, or --dist-backend gloo --device
# cuda:0 for several ranks on one card), steps its own samples and DDP
# averages the gradients; with --dp D --sp S (D x S = NPROC) the S ranks of
# each sample split its BEV queries in the encoder.
#
#   NPROC=8 [PORT=29500] [PYTHON=python3] bash bevformer_torch/tools/dist_train.sh CONFIG --data-root DATA [args...]
set -euo pipefail
CONFIG=$1
shift
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec "${PYTHON:-python3}" -m torch.distributed.run --nproc-per-node "${NPROC:-1}" \
  --master-addr localhost --master-port "${PORT:-29500}" \
  -m bevformer_torch.tools.train "$CONFIG" "$@"
