#!/usr/bin/env bash
# Local job-array VB-EM: file-based map-reduce over utterance shards.
#
# Reference parity: `utils/parallel/` in the reference recipes — its only
# scale-out mechanism (SURVEY.md §2.10): split the utterance list into N
# shards, run one statistics-accumulation job per shard (SGE array or
# local background jobs), then reduce the statistics files into a single
# natural-parameter update per epoch.  This is the local-backend analog
# for beer_tpu: `beer hmm accumulate --shard j/N` jobs in parallel, then
# one `beer hmm update`.  Exact full-batch VB-EM — identical math to
# `beer hmm train` — for corpora spread over processes/hosts that do NOT
# share a device mesh.  Stage-gated per epoch: rerunning resumes from the
# latest epochNNNN.mdl like `beer hmm train`.
#
# Devices: this script never starts more than one JAX process per GPU.
# A JAX process reserves most of a card's memory when it starts, so a
# second process on the same card fails.  Local fan-out jobs therefore
# run with --device cpu, unless there are no more jobs than cards: then
# job j runs alone on card j-1 (CUDA_VISIBLE_DEVICES).  SGE tasks run on
# the CPU.  On a GPU host the recommended route is the in-process
# data-parallel `beer hmm train`, which drives every card of the host
# from one process.  BEER_DEVICE=cpu keeps every job on the CPU.
#
# Usage: parallel_vbem.sh <init.mdl> <feats> <workdir> <njobs> <epochs> [lrate]
#
# Backends (BEER_PARALLEL env, default local):
#   local — N background processes on this host (default)
#   sge   — one qsub array job per epoch (`qsub -sync y -t 1-N`), the
#           reference's cluster mechanism; SGE_OPTS passes queue/resource
#           flags (e.g. SGE_OPTS="-q all.q -l mem_free=2G").  The shared
#           filesystem carries shards exactly as in the local mode.

set -euo pipefail

model=$1 feats=$2 work=$3 njobs=$4 epochs=$5 lrate=${6:-1.0}
BEER_DEVICE=${BEER_DEVICE:-auto}
BEER_PARALLEL=${BEER_PARALLEL:-local}
SGE_OPTS=${SGE_OPTS:-}
beer() { python -m beer_tpu.cli "$@"; }
mkdir -p "$work"

ncards=0
if [ "$BEER_DEVICE" != cpu ] && [ "$BEER_PARALLEL" = local ] \
        && command -v nvidia-smi > /dev/null; then
    ncards=$(nvidia-smi -L 2> /dev/null | grep -c '^GPU' || true)
fi
job_device=cpu
if [ "$ncards" -gt 0 ] && [ "$njobs" -le "$ncards" ]; then
    job_device=gpu
fi

if [ "$BEER_PARALLEL" = sge ] && ! command -v qsub > /dev/null; then
    echo "parallel_vbem.sh: BEER_PARALLEL=sge but qsub not found" >&2
    exit 1
fi

run_shards() { # <epoch>: fan out njobs accumulate jobs, wait for all
    local epoch=$1
    if [ "$BEER_PARALLEL" = sge ]; then
        local script="$work/accumulate.$epoch.sh"
        {
            echo '#!/usr/bin/env bash'
            echo 'set -euo pipefail'
            printf 'cd %q\n' "$(pwd)"
            printf 'python -m beer_tpu.cli hmm accumulate %q %q ' \
                "$current" "$feats"
            printf '%q/epoch%s.$SGE_TASK_ID.acc ' "$work" "$epoch"
            printf -- '--shard "$SGE_TASK_ID/%s" --device cpu\n' \
                "$njobs"
        } > "$script"
        chmod +x "$script"
        # -sync y blocks until every task exits; nonzero task exit fails
        # the qsub call and (set -e) this epoch.
        qsub -sync y -t "1-$njobs" -cwd -j y \
            -o "$work/accumulate.$epoch.\$TASK_ID.log" \
            $SGE_OPTS "$script"
    else
        local pids=() j
        for j in $(seq 1 "$njobs"); do
            if [ "$job_device" = gpu ]; then
                CUDA_VISIBLE_DEVICES=$((j - 1)) beer hmm accumulate \
                    "$current" "$feats" "$work/epoch$epoch.$j.acc" \
                    --shard "$j/$njobs" --device gpu \
                    > "$work/accumulate.$epoch.$j.log" 2>&1 &
            else
                beer hmm accumulate "$current" "$feats" \
                    "$work/epoch$epoch.$j.acc" --shard "$j/$njobs" \
                    --device cpu \
                    > "$work/accumulate.$epoch.$j.log" 2>&1 &
            fi
            pids+=($!)
        done
        for pid in "${pids[@]}"; do wait "$pid"; done
    fi
}

# Convert .npz feature archives to .bar ONCE before forking the job
# array so N accumulate jobs never race on first-use conversion (the
# conversion itself is atomic too — write_archive publishes via rename).
case $feats in
    *.npz) [ -f "$feats.bar" ] || python - "$feats" <<'EOF'
import sys
from beer_tpu import io as bio
bio.convert_npz(sys.argv[1], sys.argv[1] + ".bar")
EOF
esac

current=$model
start=0
latest=$(ls "$work"/epoch????.mdl 2>/dev/null | sort | tail -1 || true)
if [ -n "$latest" ]; then
    current=$latest
    start=$((10#$(basename "$latest" .mdl | tr -dc 0-9)))
    echo "resuming from $latest (epoch $start)"
fi

for epoch in $(seq $((start + 1)) "$epochs"); do
    # Drop leftovers from a crashed run (possibly with a different njobs)
    # so the reduce never sums stale shards into the update.
    rm -f "$work"/epoch"$epoch".*.acc
    run_shards "$epoch"
    next=$(printf '%s/epoch%04d.mdl' "$work" "$epoch")
    beer hmm update "$current" "$next" \
        "$work"/epoch"$epoch".*.acc --lrate "$lrate" --device "$BEER_DEVICE"
    rm -f "$work"/epoch"$epoch".*.acc
    current=$next
done
cp "$current" "$work/final.mdl"
echo "wrote $work/final.mdl"
