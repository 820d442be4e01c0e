#!/usr/bin/env bash
# Bench two trees on one card in one call: parent, this tree, this tree,
# parent (python -m raft_tpu_torch.bench, the full protocol unless extra
# arguments are given), so drift across the call shows as the spread
# between a tree's two runs.
#
#   bash tools/bench_ab.sh chip_tree/parent [bench arguments]
#
# The parent is a `git archive` of another commit unpacked under
# chip_tree/ (git-ignored). Output: chiprun_out/bench_ab.jsonl, one JSON
# line per bench line, each tagged with its tree and run.
set -euo pipefail
parent="$1"; shift
out=chiprun_out/bench_ab.jsonl
mkdir -p chiprun_out
: > "$out"
for run in parent:1 tree:1 tree:2 parent:2; do
  tree="${run%%:*}"; n="${run##*:}"
  dir=.
  [ "$tree" = parent ] && dir="$parent"
  (cd "$dir" && python -m raft_tpu_torch.bench "$@") | while read -r line; do
    python3 -c 'import json, sys; d = json.loads(sys.argv[1]); d["tree"] = sys.argv[2]; d["run"] = int(sys.argv[3]); print(json.dumps(d))' \
      "$line" "$tree" "$n" | tee -a "$out"
  done
done
