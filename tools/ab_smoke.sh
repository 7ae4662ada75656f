#!/bin/sh
# chip_smoke.py of two trees in turns on one card: parent with --profile,
# change with --profile, change, parent. Each tree is an unpacked
# `git archive` in a directory that .gitignore lists, for example
#   mkdir -p build/parent build/change
#   git archive <parent commit> | tar -x -C build/parent
#   git add -A && git archive "$(git write-tree)" | tar -x -C build/change
#   sh tools/ab_smoke.sh build/parent build/change [log directory]
# Each run's output goes to <log directory>/ab_<label>.log (default
# build/ab_logs); its exit code and last line are printed. Exits 1 if any run
# failed.
set -u
root=$(pwd)
logs="$root/${3:-build/ab_logs}"
mkdir -p "$logs"
status=0
run() {  # label, tree, arguments of chip_smoke.py
    (cd "$root/$2" && python3 chip_smoke.py $3 > "$logs/ab_$1.log" 2>&1)
    rc=$?
    [ "$rc" -eq 0 ] || status=1
    echo "== $1 rc=$rc"
    tail -n 1 "$logs/ab_$1.log" | cut -c1-300
}
run parent1 "$1" --profile
run change1 "$2" --profile
run change2 "$2" ""
run parent2 "$1" ""
exit $status
