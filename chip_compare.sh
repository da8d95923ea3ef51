#!/usr/bin/env bash
# Run an earlier commit's chip_smoke.py and this tree's in turns on one
# card (change, parent, change, parent), so their times share a machine.
#
#   rm -rf build/parent && mkdir -p build/parent
#   git archive <parent-commit> | tar -x -C build/parent
#   bash chip_compare.sh [out_dir [chip_smoke arguments]]
#   bash chip_compare.sh build/compare --phases 1,8   # both must know it
#
# Each run's full output goes to <out_dir>/ab_<i>_<which>.txt (default
# out_dir: build/compare); the summary line per run is its exit code and
# the end of its output.  Arguments after out_dir go to every run.
set -u
out=$(realpath -m "${1:-build/compare}")
shift $(( $# > 0 ? 1 : 0 ))
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for which in change parent change parent; do
  i=$((i + 1))
  if [ "$which" = parent ]; then dir=build/parent; else dir=.; fi
  (cd "$dir" && timeout 600 python3 chip_smoke.py "$@") \
    > "$out/ab_${i}_${which}.txt" 2>&1
  echo "run $i $which rc=$?"
  tail -n 2 "$out/ab_${i}_${which}.txt"
done
