#!/usr/bin/env bash
# Slurm launcher for inference with the PyTorch port: one task a card
# (counterpart of tools/slurm_test.sh, which runs one JAX process a host).
# Slurm's task variables map onto the env contract, as
# tools/slurm_train_torch.sh maps them:
#   SLURM_NTASKS  -> ORP_NUM_PROCESSES
#   SLURM_PROCID  -> ORP_PROCESS_ID
#   SLURM_LOCALID -> ORP_LOCAL_RANK (the task's card on its node, which is
#                    also its only visible card: CUDA_VISIBLE_DEVICES)
#   first node    -> ORP_COORDINATOR_ADDRESS (port 29500 unless COORD_PORT)
# tools/test_torch.py reads none of the ORP_* variables (nor does the JAX
# package's tools/test.py), so each task scores the whole test split on
# its own card; give the tasks their own outputs in PY_ARGS, where the
# literal {rank} becomes the task's SLURM_PROCID
# (PY_ARGS="--format_task1 out/task1_{rank}").
#
# Usage:
#   tools/slurm_test_torch.sh PARTITION JOB_NAME CONFIG CHECKPOINT [GPUS]
# GPUS (default 8) tasks in all, GPUS_PER_NODE (default 8) a node.
set -x

PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
GPUS=${5:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
COORD_PORT=${COORD_PORT:-29500}
SRUN_ARGS=${SRUN_ARGS:-""}
PY_ARGS=${PY_ARGS:-""}

srun -p "${PARTITION}" \
    --job-name="${JOB_NAME}" \
    --gres=gpu:"${GPUS_PER_NODE}" \
    --ntasks="${GPUS}" \
    --ntasks-per-node="${GPUS_PER_NODE}" \
    --cpus-per-task="${CPUS_PER_TASK}" \
    --kill-on-bad-exit=1 \
    ${SRUN_ARGS} \
    bash -c '
      head_node=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
      export ORP_COORDINATOR_ADDRESS=${head_node}:'"${COORD_PORT}"'
      export ORP_NUM_PROCESSES=${SLURM_NTASKS}
      export ORP_PROCESS_ID=${SLURM_PROCID}
      export ORP_LOCAL_RANK=${SLURM_LOCALID}
      export CUDA_VISIBLE_DEVICES=${SLURM_LOCALID}
      export OMP_NUM_THREADS=${OMP_NUM_THREADS:-1}
      py_args='"'""${PY_ARGS}""'"'
      exec python3 -u '"$(dirname "$0")"'/test_torch.py '"${CONFIG}"' \
          --checkpoint '"${CHECKPOINT}"' ${py_args//\{rank\}/${SLURM_PROCID}}
    '
