#!/usr/bin/env bash
# SLURM-managed launch of the PyTorch port (vlbert_tpu_torch): one srun
# task per GPU, as the reference's scripts/dist_run_slurm.sh starts one per
# card (scripts/run_slurm.sh starts the JAX package's one per host).
#
# `--dist` reads srun's environment when torchrun's is absent
# (vlbert_tpu_torch/parallel/dist.py::slurm_env): RANK from SLURM_PROCID,
# WORLD_SIZE from SLURM_NTASKS, LOCAL_RANK (the card) from SLURM_LOCALID,
# MASTER_ADDR the first host of SLURM_STEP_NODELIST, MASTER_PORT from the
# environment or 10000 + SLURM_JOB_ID mod 20000. Set
# TPU.PARTITION_MODE: fsdp in the cfg (or a copy of it) to shard the
# parameters and optimizer moments over the ranks; dp replicates them.
# Tensor parallelism takes its mesh as overrides in PY_ARGS, e.g.
# PY_ARGS="TPU.PARTITION_MODE tp TPU.MESH_SHAPE [2,8] TPU.MESH_AXES
# [data,model]" for 2 nodes of 8 cards (the model axis within a node).
#
# Usage:
#   ./scripts/run_slurm_torch.sh <partition> <job_name> <task> <cfg> <model_dir> [nodes] [gpus_per_node]
# e.g.
#   ./scripts/run_slurm_torch.sh gpu vlbert-vqa vqa \
#       cfgs/vqa/base_4x16G_fp32.yaml ./ckpts 2 8
#
# Env knobs: CPUS_PER_TASK (default 8: the loader's workers), SRUN_ARGS,
# PY_ARGS (e.g. "--do-test").
set -e

PARTITION=$1
JOB_NAME=$2
TASK=$3
CONFIG=$4
WORK_DIR=$5
NODES=${6:-1}
GPUS_PER_NODE=${7:-8}
CPUS_PER_TASK=${CPUS_PER_TASK:-8}
SRUN_ARGS=${SRUN_ARGS:-""}
PY_ARGS=${PY_ARGS:-""}

# --kill-on-bad-exit: any task dying kills the job (a rank left waiting in
# a collective would hang); recovery is a restart with TRAIN.AUTO_RESUME
srun -p "${PARTITION}" \
    --job-name="${JOB_NAME}" \
    --nodes="${NODES}" \
    --ntasks=$((NODES * GPUS_PER_NODE)) \
    --ntasks-per-node="${GPUS_PER_NODE}" \
    --gres=gpu:"${GPUS_PER_NODE}" \
    --cpus-per-task="${CPUS_PER_TASK}" \
    --kill-on-bad-exit=1 \
    ${SRUN_ARGS} \
    python -u -m vlbert_tpu_torch.engine.train \
    --task "${TASK}" \
    --cfg "${CONFIG}" \
    --model-dir "${WORK_DIR}" \
    --dist ${PY_ARGS}
