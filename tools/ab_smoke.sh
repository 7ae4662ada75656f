#!/bin/sh
# chip_smoke.py of two trees in turns on one card: parent with --profile,
# change with --profile, then plain runs in the order change, parent,
# parent, change, change, parent, ... until there are [pairs] runs of each
# (default 2: parent, change, change, parent). Each tree is an unpacked
# `git archive` in a directory that .gitignore lists, for example
#   mkdir -p build/parent build/change
#   git archive <parent commit> | tar -x -C build/parent
#   git add -A && git archive "$(git write-tree)" | tar -x -C build/change
#   sh tools/ab_smoke.sh build/parent build/change [log directory] [pairs]
# Each run's output goes to <log directory>/ab_<label>.log (default
# build/ab_logs); its exit code and last line are printed. Exits 1 if any run
# failed.
set -u
root=$(pwd)
logs="$root/${3:-build/ab_logs}"
pairs=${4:-2}
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
i=2
while [ "$i" -le "$pairs" ]; do
    if [ $((i % 2)) -eq 0 ]; then
        run change$i "$2" ""
        run parent$i "$1" ""
    else
        run parent$i "$1" ""
        run change$i "$2" ""
    fi
    i=$((i + 1))
done
exit $status
