#!/usr/bin/env bash
# Inference with the PyTorch port over every card of this host
# (counterpart of tools/dist_test.sh): one process drives all local cards,
# each batch sharded over them (parallel/infer.py), as the JAX package's
# test tool does over its mesh.
#   tools/dist_test_torch.sh CONFIG [tools/test_torch.py args...]
set -e
CONFIG=$1
shift
python3 "$(dirname "$0")/test_torch.py" "$CONFIG" "$@"
