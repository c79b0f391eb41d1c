#!/usr/bin/env bash
# Data-parallel training with the PyTorch port: one process a card
# (counterpart of tools/dist_train.sh; the reference's
# torch.distributed.launch).
#
# One host, every visible card (NPROC sets another count):
#   tools/dist_train_torch.sh CONFIG [tools/train_torch.py args...]
# Several hosts: run on every host, each starting one process a local
# card; NUM_PROCESSES counts the hosts and PROCESS_ID is this host's
# index, as tools/dist_train.sh takes them, and COORDINATOR_ADDRESS is
# host 0's host:port:
#   COORDINATOR_ADDRESS=host0:29500 NUM_PROCESSES=2 PROCESS_ID=$i \
#   tools/dist_train_torch.sh CONFIG [args...]
# Each process gets the env contract tools/train_torch.py reads
# (ORP_COORDINATOR_ADDRESS, ORP_NUM_PROCESSES, ORP_PROCESS_ID,
# ORP_LOCAL_RANK: its card) and one OpenMP thread unless OMP_NUM_THREADS
# is set.  When one process fails the others are stopped.
set -e
CONFIG=$1
shift
NPROC=${NPROC:-$(python3 -c 'import torch; print(torch.cuda.device_count())')}
HOSTS=${NUM_PROCESSES:-1}
HOST=${PROCESS_ID:-0}
ADDR=${COORDINATOR_ADDRESS:-localhost:$(python3 -c \
  'import socket; s = socket.socket(); s.bind(("localhost", 0)); print(s.getsockname()[1])')}
if [ "$NPROC" -lt 1 ]; then
  echo "dist_train_torch.sh: no card visible (set NPROC)" >&2
  exit 2
fi
pids=()
trap 'kill "${pids[@]}" 2>/dev/null || true' EXIT
for ((i = 0; i < NPROC; i++)); do
  ORP_COORDINATOR_ADDRESS=$ADDR ORP_NUM_PROCESSES=$((HOSTS * NPROC)) \
    ORP_PROCESS_ID=$((HOST * NPROC + i)) ORP_LOCAL_RANK=$i \
    OMP_NUM_THREADS=${OMP_NUM_THREADS:-1} \
    python3 "$(dirname "$0")/train_torch.py" "$CONFIG" "$@" &
  pids+=($!)
done
for ((i = 0; i < NPROC; i++)); do
  wait -n || exit $?
done
