#!/usr/bin/env bash
# Seed sensitivity of the H-SHMM transfer claim:
# rerun the full recipe on freshly drawn corpora (SEED=0..N-1) and
# assert the two BEATS margins hold for EVERY seed, then print
# mean +/- range per system.  Model-init keys are fixed inside the
# tools; the sweep varies the data draw (allophone maps, gamma
# durations, per-utterance speaker factors, noise) — the axis the
# claim actually generalizes over.
#
# Usage: ./sweep.sh [--hard] [n_seeds] [workroot]
#   (defaults: 3 exp_sweep; --hard adds real-corpus degradations —
#    reverb IR, babble at 0-15 dB SNR, DC offset, clipping, heavy-
#    tailed utterance lengths — and uses exp_sweep_hard as workroot)

set -euo pipefail
cd "$(dirname "$0")"

hard=""
if [ "${1:-}" = "--hard" ]; then
  hard=1
  shift
fi
n=${1:-3}
root=${2:-exp_sweep${hard:+_hard}}
declare -a km base shmm

for ((s = 0; s < n; s++)); do
  echo "=== sweep seed $s${hard:+ (hard)}"
  HARD=$hard SEED=$s ./run.sh "$root/seed$s"
  get_nmi() { grep -o 'NMI: *[0-9.]*' "$1" | grep -o '[0-9.]*$'; }
  km[$s]=$(get_nmi "$root/seed$s/score_kmeans_C.txt")
  base[$s]=$(get_nmi "$root/seed$s/score_baseline_C.txt")
  shmm[$s]=$(get_nmi "$root/seed$s/score_shmm_C.txt")
done

python - "$n" "${km[@]}" "${base[@]}" "${shmm[@]}" << 'EOF'
import sys

n = int(sys.argv[1])
vals = list(map(float, sys.argv[2:]))
km, base, shmm = vals[:n], vals[n:2 * n], vals[2 * n:]


def stat(v):
    m = sum(v) / len(v)
    return f"{m:.1f} (range {min(v):.1f}-{max(v):.1f})"


print(f"seeds: {n}")
print(f"k-means  NMI: {stat(km)}")
print(f"baseline NMI: {stat(base)}")
print(f"H-SHMM   NMI: {stat(shmm)}")
ok = True
for s in range(n):
    beats_base = shmm[s] > base[s]
    beats_km = shmm[s] > km[s]
    print(f"seed {s}: H-SHMM {shmm[s]:.1f} vs baseline {base[s]:.1f} "
          f"[{'BEATS' if beats_base else 'FAILS'}], "
          f"k-means {km[s]:.1f} [{'BEATS' if beats_km else 'FAILS'}]")
    ok = ok and beats_base and beats_km
print("SWEEP: " + ("ALL SEEDS PASS" if ok else "MARGIN FLIPPED — investigate"))
sys.exit(0 if ok else 1)
EOF
