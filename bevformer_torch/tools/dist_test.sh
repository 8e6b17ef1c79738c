#!/usr/bin/env bash
# Evaluation over NPROC processes of this host, one rank each: the
# torchrun counterpart of the JAX package's tools/dist_test.sh (and of the
# reference's torch.distributed.launch wrapper). Each rank joins the process
# group in bevformer_torch/runtime/distributed.py::maybe_initialize (NCCL on
# cuda:LOCAL_RANK; gloo with --device cpu, or --dist-backend gloo --device
# cuda:0 for several ranks on one card), runs a contiguous segment of the
# val split, and rank 0 scores the gathered results.
#
#   NPROC=8 [PORT=29500] [PYTHON=python3] bash bevformer_torch/tools/dist_test.sh CONFIG --data-root DATA [args...]
set -euo pipefail
CONFIG=$1
shift
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec "${PYTHON:-python3}" -m torch.distributed.run --nproc-per-node "${NPROC:-1}" \
  --master-addr localhost --master-port "${PORT:-29500}" \
  -m bevformer_torch.tools.test "$CONFIG" "$@"
