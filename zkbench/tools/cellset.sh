#!/bin/bash
# Measure one cell on the card, from the root of a checkout:
#   zkbench/tools/cellset.sh <cell> <out_dir> <base_seed> <seconds> <runs_a_set> <traced> <more> [<compile>]
# A compile run (seed base+99, 1 s) unless <compile> is 0, then two sets of
# <runs_a_set> untraced runs on the same seeds (base+1 ...), the sets
# interleaved run by run (s1_1 s2_1 s1_2 s2_2 ...) as a check interleaves
# its two sides, then <traced> traced runs (base+51 ...), then <more>
# untraced 5 s runs on more seeds (base+71 ...), for the count of seeds that
# came out correct.  One summary line a run on stdout; each run's output in
# <out_dir>.
cell=$1; out=$2; base=$3; secs=$4; per=$5; traced=$6; more=$7; compile=${8:-1}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
  local name=$1; shift
  local t; t=$(date +%s%N)
  timeout 600 python3 zkbench/run.py --workload "$cell" "$@" > "$out/$name.out" 2> "$out/$name.err"
  local rc=$?
  echo "$name rc=$rc wall_s=$(( ($(date +%s%N) - t) / 1000000000 )) $(tail -1 "$out/$name.out" | python3 -c '
import sys, json
try:
    l = json.loads(sys.stdin.read())
except ValueError:
    sys.exit()
d = l["device"]
print(json.dumps({"correct": l["correct"], "attempted": l["attempted"], "failed": l["failed"],
                  "m": {k: v["value"] for k, v in l["metrics"].items()},
                  "peak": d["memory_peak_bytes"], "busy": d.get("busy_s"), "win": d.get("window_s"),
                  "checks": {k: v["value"] for k, v in l["checks"].items()}}))')"
  grep -o "host: .*" "$out/$name.err" | head -1
}
[ "$compile" = 1 ] && run compile --seed $((base + 99)) --seconds 1 --trace 0
for i in $(seq 1 "$per"); do
  for set in 1 2; do run "s${set}_$i" --seed $((base + i)) --seconds "$secs" --trace 0; done
done
for i in $(seq 1 "$traced"); do run "t_$i" --seed $((base + 50 + i)) --seconds "$secs" --trace 1; done
for i in $(seq 1 "$more"); do run "m_$i" --seed $((base + 70 + i)) --seconds 5 --trace 0; done
