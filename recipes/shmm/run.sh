#!/usr/bin/env bash
# Multilingual subspace-HMM (H-SHMM) recipe with held-out evaluation.
#
# Reference parity: recipes/hshmm/run.sh — the reference's flagship
# recipe: low-resource acoustic unit discovery where the target
# language's phone-loop parameters are constrained to a phonetic
# subspace learned jointly with resourced languages (SHMM Interspeech'19,
# H-SHMM ICASSP'21).  Stage-gated and restartable like the reference.
#
# Setup: A, B resourced (60 train utts each), C target (4 train utts);
# every language has a 40-utterance HELD-OUT eval set from the
# adversarial generator (allophones, gamma durations, per-utterance
# speaker factors + noise — local/make_multilingual_data.py).  All
# scores below are on C's eval set, which no stage ever trains on:
#
#   H-SHMM > plain phone loop (baseline)   AND   H-SHMM > k-means
#
# is the claim stage 9 checks (the starved 4-utterance baseline itself
# trails the k-means frame floor — that is the low-resource premise the
# subspace transfer exists to fix).  Measured on from-scratch runs of
# this script (seed 0): CPU f32 — k-means 35.8, baseline 34.5, H-SHMM
# 41.0 NMI (boundary-F 50.8 -> 59.0).  Subspace sharing with the
# resourced languages recovers what 4 utterances cannot.
#
# Seed sensitivity (./sweep.sh 3, fresh corpus draw per seed, CPU f32,
# round-4 scanned stage 7): H-SHMM 37.9 NMI mean (range 34.6-41.3) vs
# baseline 32.8 (30.2-34.5) vs k-means 32.4 (29.2-35.8); BOTH BEATS
# margins held for every seed — the transfer claim is not a lucky draw.
#
# Scores print from score.py; the recipe regenerates everything from
# scratch (exp/ and exp_sweep/ are gitignored).
#
# Usage: ./run.sh [workdir]   (defaults to exp/)
#   SEED=n ./run.sh workdir   regenerates the synthetic corpus with a
#   different draw (allophone maps, durations, speaker factors, noise);
#   ./sweep.sh runs seeds 0..2 and asserts the BEATS margin for each.

set -euo pipefail
cd "$(dirname "$0")"

work=${1:-exp}
seed=${SEED:-0}
stage_mark() { echo "=== stage $1: $2"; }
# run from a bare checkout: make beer_tpu importable without pip install
export PYTHONPATH="$(cd ../.. && pwd)${PYTHONPATH:+:$PYTHONPATH}"
beer() { python -m beer_tpu.cli "$@" ${BEER_DEVICE:+--device "$BEER_DEVICE"}; }

mkdir -p "$work"

if [ ! -f "$work/wav_C.scp" ]; then
  stage_mark 0 "adversarial multilingual synthetic data (+ eval splits)"
  # HARD=1: real-corpus degradations (reverb, babble 0-15 dB SNR, DC
  # offset, clipping, heavy-tailed lengths) — ./sweep.sh --hard
  python local/make_multilingual_data.py "$work" --seed "$seed" \
    ${HARD:+--hard}
fi

for set_name in A B C A_eval B_eval C_eval; do
  if [ ! -f "$work/feats_$set_name.npz" ]; then
    stage_mark 1 "features ($set_name)"
    beer dataset create "$work/wav_$set_name.scp" \
        "$work/manifest_$set_name.json"
    beer features extract conf/features.yml "$work/manifest_$set_name.json" \
        "$work/feats_$set_name.npz"
  fi
done

for lang in A B C; do
  if [ ! -f "$work/init_$lang.mdl" ]; then
    stage_mark 2 "phone-loop initialization ($lang)"
    beer hmm mkphoneloop conf/hmm.yml "$work/feats_$lang.npz" \
        "$work/init_$lang.mdl"
  fi
done

if [ ! -f "$work/score_kmeans_C.txt" ]; then
  stage_mark 3 "k-means frame baseline (train on C, score on C eval)"
  python local/kmeans_baseline.py "$work/feats_C.npz" \
      "$work/feats_C_eval.npz" "$work/trans_kmeans_C.txt" --clusters 15
  python local/score.py "$work/ref_C_eval.ali" "$work/trans_kmeans_C.txt" \
      | tee "$work/score_kmeans_C.txt"
fi

if [ ! -f "$work/baseline_C/final.mdl" ]; then
  stage_mark 4 "baseline: plain phone loop on target C train set"
  beer hmm train "$work/init_C.mdl" "$work/feats_C.npz" \
      "$work/baseline_C" --epochs 30
fi

if [ ! -f "$work/score_baseline_C.txt" ]; then
  stage_mark 5 "baseline decoding + scoring on C eval"
  beer hmm decode "$work/baseline_C/final.mdl" "$work/feats_C_eval.npz" \
      "$work/trans_baseline_C.txt" --per-frame
  python local/score.py "$work/ref_C_eval.ali" "$work/trans_baseline_C.txt" \
      | tee "$work/score_baseline_C.txt"
fi

for lang in A B; do
  if [ ! -f "$work/train_$lang/final.mdl" ]; then
    stage_mark 6 "resourced-language phone loops ($lang)"
    beer hmm train "$work/init_$lang.mdl" "$work/feats_$lang.npz" \
        "$work/train_$lang" --epochs 20
  fi
done

if [ ! -f "$work/shmm/final.mdl" ]; then
  stage_mark 7 "H-SHMM subspace alternation (target C + A + B)"
  beer shmm train "$work/baseline_C/final.mdl" "$work/feats_C.npz" \
      "$work/shmm" \
      --extra-lang "A:$work/train_A/final.mdl:$work/feats_A.npz" \
      --extra-lang "B:$work/train_B/final.mdl:$work/feats_B.npz" \
      --embed-dim 8 --lang-dim 2 --learn-transitions \
      --outer-iters 6 --inner-iters 600 --loop-epochs 3
fi

if [ ! -f "$work/score_shmm_C.txt" ]; then
  stage_mark 8 "H-SHMM decoding + scoring on C eval"
  beer hmm decode "$work/shmm/final.mdl" "$work/feats_C_eval.npz" \
      "$work/trans_shmm_C.txt" --per-frame
  python local/score.py "$work/ref_C_eval.ali" "$work/trans_shmm_C.txt" \
      | tee "$work/score_shmm_C.txt"
fi

stage_mark 9 "comparison (target language C, held-out eval)"
get_nmi() { grep -o 'NMI: *[0-9.]*' "$1" | grep -o '[0-9.]*$'; }
km_nmi=$(get_nmi "$work/score_kmeans_C.txt")
base_nmi=$(get_nmi "$work/score_baseline_C.txt")
shmm_nmi=$(get_nmi "$work/score_shmm_C.txt")
echo "k-means NMI: $km_nmi    baseline NMI: $base_nmi    H-SHMM NMI: $shmm_nmi"
python - "$km_nmi" "$base_nmi" "$shmm_nmi" << 'EOF'
import sys
km, base, shmm = map(float, sys.argv[1:4])
print(f"H-SHMM {'BEATS' if shmm > base else 'does NOT beat'} the baseline "
      f"({shmm:.1f} vs {base:.1f})")
print(f"H-SHMM {'BEATS' if shmm > km else 'does NOT beat'} the k-means "
      f"floor ({shmm:.1f} vs {km:.1f})")
print(f"(starved baseline vs k-means floor: {base:.1f} vs {km:.1f} — "
      f"the low-resource gap the subspace closes)")
EOF
